"""Phase-2 MLE training in fused chunks, as users of --fused_steps run it:
the program's Trainer over a dataset whose features sit on the card
(every image of the split, drawn from the seed and handed to the Trainer
through the dataset's device cache), `Trainer.train_chunk` the timed call.

Set-up builds the one Trainer, puts the benchmark's weights into it, sets
it at the traffic's `epoch` (as a run resumed there: that epoch's learning
rate and scheduled-sampling probability), runs its first `check_steps`
iterations through `train_chunk` (one a call), keeping each step's loss,
Adam's first moment after the first step and the weights after the last,
and warms up with whole chunks for `warm_seconds`; the window runs chunks
of `fused_steps` until its seconds are up.  Afterwards the plain reference
follows the same first steps from the same weights, inputs, dropout masks
and scheduled-sampling draws, and the numbers compared are:

    loss_gap    the widest relative gap of a step's loss
    grad_gap    the first gradient's norm, the worst leaf's gap against
                the larger of that leaf's reference norm and the median
                leaf's
    change_gap  the weights' change over the steps, measured so, leaving
                out leaves whose reference gradient is under a thousandth
                of the median leaf's (they move by round-off alone)

A sampled word whose two best perturbed scores lie within rounding of each
other (a near-tie, speaker.NEAR_TIE) may fall either way on the program's
side; where the reference meets some, the numbers are those against the
reference that takes one of them the other way, if the program comes
closer to it.
"""

from __future__ import annotations

import gc
import statistics
import sys
import time

import torch

from portbench.core import data
from portbench.reference import common, speaker

KIND = "train"
GRAD_FLOOR = 1e-3  # of the median leaf's gradient norm: moved by round-off
MAX_TIES = 3       # near-ties taken the other way, one at a time


def program_seed(seed):
    return int(seed) % 2 ** 31


class State:
    pass


def options(cell, seed):
    from cooperativeimagecaptioning_tpu_torch.config import Options
    cfg, tr = cell.config, cell.traffic
    keys = ("rnn_size", "input_encoding_size", "att_hid_size",
            "fc_feat_size", "att_feat_size", "drop_prob_lm", "learning_rate",
            "grad_clip", "optim_alpha", "optim_beta", "optim_epsilon",
            "weight_decay")
    opt = dict({k: cfg[k] for k in keys}, **cfg["options"], **tr["options"])
    if "max_att_len" in cfg:
        opt["max_att_len"] = cfg["max_att_len"]
    return Options(seed=program_seed(seed), losses_log_every=10 ** 9,
                   save_checkpoint_every=10 ** 9,
                   checkpoint_path=str(cell.run_dir), **opt)


def feature_cache(cell, seed, device, uses_att):
    """The device cache the Trainer takes from its dataset: every image's
    fc (and att, with its mask) features, drawn from the seed."""
    cfg = cell.config
    N = cfg["train_images"]
    cache = {"fc": data.draw((N, cfg["fc_feat_size"]), seed, "fc", device)}
    if uses_att:
        K = cfg["max_att_len"]
        cache["att"] = data.draw((N, K, cfg["att_feat_size"]), seed, "att",
                                 device)
        cache["att_mask"] = torch.ones((N, K), dtype=torch.float32,
                                       device=device)
        # the Trainer's signature of an att block built with no transforms,
        # stored in float32
        cache["_att_sig"] = (0, 0, 0, "f32")
    return cache


def _leaves(tree):
    from cooperativeimagecaptioning_tpu_torch.utils.tree import leaves
    return dict(leaves(tree))


def setup(cell, seed, device):
    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    cfg, tr = cell.config, cell.traffic
    st = State()
    st.cell, st.seed, st.device = cell, seed, device
    st.model = speaker.model(cfg["caption_model"])
    ds = data.ResidentDataset(cfg["train_images"], cfg["vocab_size"],
                              cfg["seq_length"], cfg["captions_per_image"],
                              seed)
    ds._device_feat_cache = feature_cache(cell, seed, device,
                                          st.model.USES_ATT)
    st.dataset = ds
    trainer = Trainer(options(cell, seed), dataset=ds, device=device,
                      verbose=False)
    if trainer._feat_cache is not ds._device_feat_cache:
        raise RuntimeError("the Trainer built a feature cache of its own")
    # a run resumed at the traffic's epoch (Trainer: infos["epoch"])
    trainer.epoch = trainer.epoch_start = int(tr["epoch"])
    trainer._update_schedules()
    st.trainer = trainer
    # the benchmark's weights into the program's speaker
    p0 = common.make_weights(st.model.leaves(cfg), seed, device)
    live = _leaves(trainer.params["speaker"])
    if set(live) != set(p0) or any(live[k].shape != p0[k].shape for k in p0):
        raise RuntimeError("the program's speaker has other leaves than the "
                           "reference's: " + str(sorted(set(live) ^ set(p0))))
    with torch.no_grad():
        for k, v in p0.items():
            live[k].copy_(v)
    # the first steps, one a chunk, with the batches the loader made
    batches = []
    get_batch = trainer.loader.get_batch

    def recording(split, batch_size=None):
        out = get_batch(split, batch_size)
        batches.append({"ix": [i["ix"] for i in out["infos"]],
                        "labels": out["labels"].copy(),
                        "masks": out["masks"].copy()})
        return out

    trainer.loader.get_batch = recording
    losses, mu1 = [], None
    try:
        for j in range(tr["check_steps"]):
            loss_dict, _, _, _ = trainer.train_chunk(1)
            losses.append(loss_dict["loss"])
            if j == 0:
                paths = trainer.optim.paths["speaker"]
                mu1 = {k: m.detach().to("cpu", copy=True) for k, m in
                       zip(paths, trainer.optim.states["speaker"]["mu"])}
    finally:
        del trainer.loader.get_batch
    b1 = cfg["optim_alpha"]
    st.program = {
        "loss": [float(x) for x in losses],
        "grad1": {k: v / (1 - b1) for k, v in mu1.items()},
        "change": {k: live[k].detach().cpu() - p0[k].cpu() for k in p0}}
    st.batches = batches
    # warm up under load, so that the window starts on a busy card
    K = int(tr["options"]["fused_steps"])
    t0 = time.perf_counter()
    while True:
        trainer.train_chunk(K)
        if time.perf_counter() - t0 >= tr["warm_seconds"]:
            break
    _sync(st)
    return st


def _chunks(st, n):
    K = int(st.cell.traffic["options"]["fused_steps"])
    steps = 0
    for _ in range(n):
        steps += st.trainer.train_chunk(K)[3]
    return steps


def _sync(st):
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)


def window(st, seconds):
    """Chunks until `seconds` have passed; the window closes when the card
    has finished the last."""
    K = int(st.cell.traffic["options"]["fused_steps"])
    skipped = st.trainer.optim.skipped_steps()
    _sync(st)
    t0 = time.perf_counter()
    steps, marks = 0, []
    while time.perf_counter() - t0 < seconds:
        steps += st.trainer.train_chunk(K)[3]
        marks.append((time.perf_counter() - t0, steps))
    _sync(st)
    st.elapsed = time.perf_counter() - t0
    st.steps = steps
    # each half's rate, a look at a window whose speed changes inside it
    mid = next((m for m in marks if m[0] >= st.elapsed / 2), marks[-1])
    rows = rows_per_step(st)
    print(f"window halves: {mid[1] * rows / mid[0]!r} then "
          f"{(steps - mid[1]) * rows / (st.elapsed - mid[0])!r} captions/s",
          file=sys.stderr)
    st.failed = st.trainer.optim.skipped_steps() - skipped
    return st


def trace_stretch(st):
    return _chunks(st, st.cell.traffic["trace_chunks"])


def rows_per_step(st):
    tr = st.cell.traffic["options"]
    return tr["batch_size"] * tr["seq_per_img"]


def step_flops(st):
    """3x the forward's product FLOPs of one step (the recompute of the
    checkpointed steps is not counted)."""
    cfg, mod = st.cell.config, st.model
    K = cfg.get("max_att_len", 0)
    T = cfg["seq_length"] + 1
    per_row = mod.flops_prefix(cfg) + T * mod.flops_step(cfg, K)
    images = st.cell.traffic["options"]["batch_size"]
    return 3 * (images * mod.flops_encode(cfg, K) + rows_per_step(st) * per_row)


def end_to_end(st):
    return {"train_captions_per_s": st.steps * rows_per_step(st) / st.elapsed}


def window_info(st):
    return {"seconds": st.elapsed, "units": st.steps,
            "flops": st.steps * step_flops(st),
            "precision": st.cell.config["precision"]["train"]}


def kernel_shapes(st):
    cfg, tr = st.cell.config, st.cell.traffic["options"]
    dtype = cfg["precision"]["train"]
    B = rows_per_step(st)
    shapes = {"cell": {"rows": B, "input": cfg["input_encoding_size"],
                       "hidden": cfg["rnn_size"], "att": st.model.USES_ATT,
                       "dtype": dtype}}
    if st.model.USES_ATT:
        shapes["attention"] = {"rows": B, "slots": cfg["max_att_len"],
                               "hidden": cfg["rnn_size"],
                               "att_hid": cfg["att_hid_size"], "dtype": dtype}
    return shapes


def counters(st):
    return {}


def attempted(st):
    return st.steps, st.failed


def release(st):
    """Free the program's state before the reference runs."""
    st.dataset._device_feat_cache = None
    st.trainer.close()
    del st.trainer, st.dataset
    gc.collect()
    if st.device.type == "cuda":
        torch.cuda.empty_cache()


def reference_steps(st):
    """The first steps' inputs as the reference takes them: the recorded
    batches' features drawn again from the seed."""
    cfg, dev = st.cell.config, st.device
    N = cfg["train_images"]
    out = []
    for b in st.batches:
        idx = torch.tensor(b["ix"], dtype=torch.long, device=dev)
        rep = int(st.cell.traffic["options"]["seq_per_img"])
        idx = idx.repeat_interleave(rep)
        feats = {"fc": data.rows(idx, (N, cfg["fc_feat_size"]), st.seed, "fc",
                                 dev)}
        if st.model.USES_ATT:
            K = cfg["max_att_len"]
            feats["att"] = data.rows(idx, (N, K, cfg["att_feat_size"]),
                                     st.seed, "att", dev)
            feats["att_mask"] = torch.ones((len(idx), K), device=dev)
        out.append({"feats": feats,
                    "labels": torch.as_tensor(b["labels"], device=dev).long(),
                    "masks": torch.as_tensor(b["masks"], device=dev).float()})
    return out


def reference(st, tf32=False, steps=None, dtype=torch.float32, flips=None):
    cfg = st.cell.config
    p0 = common.make_weights(st.model.leaves(cfg), st.seed, st.device)
    return speaker.train_steps(st.model, cfg, p0,
                               steps or reference_steps(st),
                               program_seed(st.seed), tf32=tf32, dtype=dtype,
                               epoch=int(st.cell.traffic["epoch"]),
                               flips=flips)


def _norms(tree):
    """Each leaf's norm, summed in float64: a float32 sum over millions of
    elements rounds by more than the gaps compared."""
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def leaf_gap(prog, ref, skip=()):
    """The worst leaf's |norm(prog) - norm(ref)| over the larger of that
    leaf's reference norm and the median leaf's."""
    pn, rn = _norms(prog), _norms(ref)
    med = statistics.median(rn.values())
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30)
               for k in rn if k not in skip)


def compare(prog, ref):
    """The numbers compared, of one side (`prog`) against the reference."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    g = _norms(ref["grad1"])
    med = statistics.median(g.values())
    quiet = {k for k, v in g.items() if v < GRAD_FLOOR * med}
    return {"loss_gap": loss,
            "grad_gap": leaf_gap(prog["grad1"], ref["grad1"]),
            "change_gap": leaf_gap(prog["change"], ref["change"], quiet)}


def _worst(numbers, limits):
    return max(v / limits[k] for k, v in numbers.items())


def judged(st, prog, ref):
    """compare(prog, ref), or against a reference that takes one of ref's
    near-ties the other way where prog comes closer to that one."""
    best = compare(prog, ref)
    for tie in ref["ties"][:MAX_TIES]:
        alt = compare(prog, reference(st, flips={tie[:3]: tie[3]}))
        if _worst(alt, st.cell.limits) < _worst(best, st.cell.limits):
            best = alt
    print(f"near-ties of the reference's sampled words: {len(ref['ties'])}",
          file=sys.stderr)
    return best


def check(st):
    return judged(st, st.program, reference(st))
