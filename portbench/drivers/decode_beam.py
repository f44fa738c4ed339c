"""Bulk captioning as the program's CaptioningService serves it: a closed
loop with one client, each request a batch of images whose features
already sit on the card, decoded by the service's bf16 speaker with beam
search, the ids copied back to the host.  A request runs what the
service's `_run_bucket` runs once its features are on the card:
`encode_features`, then `decoding.beam_search` on the b-major context,
then the ids to the host.

Set-up draws a pool of `pool_requests` requests' features (bf16; half of
their variance, `image_share`, shared by an image's regions, so that the
attention's average over 196 regions still tells images apart and the
captions depend on the image) and the weights on the card from the seed, builds the service and serves
`warm_requests` requests; the window serves requests from the pool, in an
order drawn from the seed, until its seconds are up, each timed from
dispatch to its ids on the host.  Afterwards `check_requests` of the
window's requests, drawn from the seed, are read by the plain reference
(float32, the weights rounded to bf16 as the service holds them).  The
numbers compared, in nats:

    token_gap      it teacher-forces each served caption and reads how far
                   a served token lies below the reference's beam_size-th
                   best (0 where it is among the top beam_size, where every
                   token a beam search serves is); the widest such gap
    seq_shortfall  it runs its own beam search over each image and reads
                   how far the served caption's log-probability falls
                   short of that of the reference's best caption (0 where
                   it does not); the mean over the images.  A greedy
                   decode, the worse beam returned or wrong beam scores
                   serve tokens that token_gap passes, and fall short here
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench.core import data
from portbench.reference import common, speaker

KIND = "decode"


class State:
    pass


def _weights(cell, seed, device):
    mod = speaker.model(cell.config["caption_model"])
    return mod, common.make_weights(mod.leaves(cell.config), seed, device)


def pool_shape(cell):
    tr, cfg = cell.traffic, cell.config
    N = tr["images_per_request"]
    return (tr["pool_requests"] * N, tr["att_len"], cfg["att_feat_size"])


def service(cell, p0, device):
    from cooperativeimagecaptioning_tpu_torch.config import Options
    from cooperativeimagecaptioning_tpu_torch.serving import CaptioningService
    cfg, tr = cell.config, cell.traffic
    keys = ("rnn_size", "input_encoding_size", "att_hid_size",
            "fc_feat_size", "att_feat_size")
    opt = Options(caption_model=cfg["caption_model"],
                  vocab_size=cfg["vocab_size"],
                  **{k: cfg[k] for k in keys})
    opt.seq_length = cfg["seq_length"]
    vocab = {str(i): f"w{i}" for i in range(1, cfg["vocab_size"] + 1)}
    return CaptioningService(
        opt, {"speaker": common.nest(p0)}, vocab, beam_size=tr["beam_size"],
        buckets=(tr["images_per_request"],), compute_dtype=tr["dtype"],
        max_att_len=tr["att_len"], device=device)


def setup(cell, seed, device):
    tr = cell.traffic
    st = State()
    st.cell, st.seed, st.device = cell, seed, device
    st.model, p0 = _weights(cell, seed, device)
    st.svc = service(cell, p0, device)
    del p0
    st.pool = data.draw(pool_shape(cell), seed, "grid", device,
                        getattr(torch, tr["dtype"]), tr["image_share"])
    N = tr["images_per_request"]
    st.mask = torch.ones((N, tr["att_len"]), dtype=torch.float32,
                         device=device)
    # every seed serves the same requests' sizes, in its own order
    st.order = np.random.RandomState(
        common.mix(seed, "order") % 2 ** 32).permutation(tr["pool_requests"])
    st.served = 0
    st.log = []
    for _ in range(tr["warm_requests"]):
        request(st)
    st.log = []
    return st


def request(st):
    """One request, as the service's program runs it on features on the
    card: (pool slice, ids [N, L] on the host, ms to the ids, host ms of
    the beam_search call)."""
    from cooperativeimagecaptioning_tpu_torch.ops import decoding
    tr = st.cell.traffic
    N = tr["images_per_request"]
    sl = int(st.order[st.served % len(st.order)])
    st.served += 1
    feats = st.pool[sl * N:(sl + 1) * N]
    spk = st.svc.speaker
    t0 = time.perf_counter()
    with torch.inference_mode():
        ctx = spk.encode_features(None, feats, st.mask)
        t1 = time.perf_counter()
        out = decoding.beam_search(spk, ctx, st.svc.opt.seq_length,
                                   st.svc.beam_size,
                                   decoding_constraint=0)
        t2 = time.perf_counter()
        ids = out.seq.cpu().numpy()
    t3 = time.perf_counter()
    st.log.append((sl, ids, 1e3 * (t3 - t0), 1e3 * (t2 - t1)))
    return ids


def _sync(st):
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)


def window(st, seconds):
    _sync(st)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        request(st)
    st.elapsed = time.perf_counter() - t0
    st.window_log = st.log
    st.log = []
    return st


def trace_stretch(st):
    for _ in range(st.cell.traffic["trace_requests"]):
        request(st)
    return st.cell.traffic["trace_requests"]


def _ok(st, ids):
    cfg, tr = st.cell.config, st.cell.traffic
    return (ids.shape == (tr["images_per_request"], cfg["seq_length"])
            and ids.min() >= 0 and ids.max() <= cfg["vocab_size"])


def attempted(st):
    return len(st.window_log), sum(not _ok(st, r[1]) for r in st.window_log)


def end_to_end(st):
    n = len(st.window_log)
    lat = [r[2] for r in st.window_log]
    return {"decode_captions_per_s":
            n * st.cell.traffic["images_per_request"] / st.elapsed,
            "decode_request_p95_ms": float(np.percentile(lat, 95))}


def request_flops(st):
    cfg, tr, mod = st.cell.config, st.cell.traffic, st.model
    N, K, m = tr["images_per_request"], tr["att_len"], tr["beam_size"]
    return (N * mod.flops_encode(cfg, K) + N * m * mod.flops_prefix(cfg)
            + cfg["seq_length"] * N * m * mod.flops_step(cfg, K))


def window_info(st):
    n = len(st.window_log)
    return {"seconds": st.elapsed, "units": n, "flops": n * request_flops(st),
            "precision": st.cell.traffic["dtype"]}


def kernel_shapes(st):
    cfg, tr = st.cell.config, st.cell.traffic
    R = tr["images_per_request"] * tr["beam_size"]
    H, dtype = cfg["rnn_size"], tr["dtype"]
    shapes = {"cell": {"rows": R, "input": cfg["input_encoding_size"],
                       "hidden": H, "att": st.model.USES_ATT, "dtype": dtype},
              "beam_head": {"rows": R, "hidden": H,
                            "vocab": cfg["vocab_size"] + 1,
                            "kk": tr["beam_size"], "dtype": dtype}}
    if st.model.USES_ATT:
        shapes["attention"] = {"rows": R, "images": tr["images_per_request"],
                               "slots": tr["att_len"], "hidden": H,
                               "att_hid": cfg["att_hid_size"], "dtype": dtype}
    return shapes


def counters(st):
    L = st.cell.config["seq_length"]
    return {"enqueue_ms_per_step":
            float(np.median([r[3] for r in st.window_log])) / L}


def release(st):
    del st.svc, st.pool
    gc.collect()
    if st.device.type == "cuda":
        torch.cuda.empty_cache()


def sample(st):
    """The requests the reference reads: `check_requests` of the window's,
    of different pool slices, drawn from the seed."""
    tr = st.cell.traffic
    rng = np.random.RandomState(common.mix(st.seed, "check") % 2 ** 32)
    picked, slices = [], set()
    for i in rng.permutation(len(st.window_log)):
        sl = st.window_log[i][0]
        if sl not in slices:
            picked.append(st.window_log[i])
            slices.add(sl)
        if len(picked) == tr["check_requests"]:
            break
    return picked


def reference_weights(st):
    """The weights as the bf16 service holds them, in float32."""
    _, p0 = _weights(st.cell, st.seed, st.device)
    dt = getattr(torch, st.cell.traffic["dtype"])
    return common.nest({k: v.to(dt).float() for k, v in p0.items()})


def read(st, picked, control=None, p=None):
    """{'program': the numbers of the served captions, 'control': those of
    the reference put in the program's place with `control` rounding its
    products' inputs (None without), 'tokens_read'} over the picked
    requests, in blocks of images."""
    cfg, tr = st.cell.config, st.cell.traffic
    N, blk, m = tr["images_per_request"], tr["check_block"], tr["beam_size"]
    L = cfg["seq_length"]
    p = p or reference_weights(st)
    dt = getattr(torch, tr["dtype"])
    sides = ["program"] + (["control"] if control is not None else [])
    gap = dict.fromkeys(sides, 0.0)
    short = dict.fromkeys(sides, 0.0)
    n, images = 0, 0
    for sl, ids, _, _ in picked:
        for i in range(0, N, blk):
            idx = torch.arange(sl * N + i, sl * N + min(N, i + blk),
                               device=st.device)
            feats = {"att": data.rows(idx, pool_shape(st.cell), st.seed,
                                      "grid", st.device, dt,
                                      tr["image_share"]).float(),
                     "att_mask": torch.ones((len(idx), tr["att_len"]),
                                            device=st.device)}
            tokens = torch.as_tensor(ids[i:i + blk], device=st.device)
            with common.matmul_precision(False), torch.no_grad():
                g, cg, k = speaker.served_gaps(st.model, p, cfg, feats,
                                               tokens, m, control)
                caps = {"program": tokens}
                if control is not None:
                    caps["control"] = speaker.beam_search(
                        st.model, p, cfg, feats, m, L, q=control)
                best = speaker.seq_logprobs(
                    st.model, p, cfg, feats,
                    speaker.beam_search(st.model, p, cfg, feats, m, L))
                for side, cap in caps.items():
                    got = speaker.seq_logprobs(st.model, p, cfg, feats, cap)
                    short[side] += float((best - got).clamp_min(0).sum())
            gap["program"], n = max(gap["program"], g), n + k
            if cg is not None:
                gap["control"] = max(gap["control"], cg)
            images += len(idx)
    out = {side: {"token_gap": gap[side],
                  "seq_shortfall": short[side] / max(images, 1)}
           for side in sides}
    return {"program": out["program"], "control": out.get("control"),
            "tokens_read": n}


def check(st):
    return read(st, sample(st))["program"]
