"""Serving: a bucketed captioning service over a trained run dir, on one
CUDA device (counterpart of the JAX package's serving.py).

Requests are padded up to a fixed set of batch buckets and a fixed attention
length, as in the JAX service, so every decode runs at one of a few static
shapes.  Decode is greedy, or beam search (the final-eval protocol is beam
2, ref eval.py:33), in bf16 by default.  Each decode step runs the
attention kernel and the greedy or beam head kernel (ops/kernels/) on the
card; on device="cpu" the same code takes their plain versions.  The
attention context is b-major by default, int8 with `att_quant="int8"` or
K-major with `att_kmajor=1`, each with its own attention kernel.

Usage:
    svc = CaptioningService.from_run_dir("runs/gumbel_x", beam_size=2)
    svc.warmup()
    sentences = svc.caption(fc_feats, att_feats, att_masks)

    python -m cooperativeimagecaptioning_tpu_torch.serving --run_dir D
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from cooperativeimagecaptioning_tpu_torch import config as config_mod
from cooperativeimagecaptioning_tpu_torch import models as model_zoo
from cooperativeimagecaptioning_tpu_torch.ops import decoding
from cooperativeimagecaptioning_tpu_torch.training import checkpoint as ckpt_mod
from cooperativeimagecaptioning_tpu_torch.training import joint
from cooperativeimagecaptioning_tpu_torch.utils.text import decode_sequence
from cooperativeimagecaptioning_tpu_torch.utils.tree import to_torch

DEFAULT_BUCKETS = (1, 8, 64, 512, 4096)
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class CaptioningService:
    """Decode over fixed batch buckets on one device."""

    def __init__(self, opt, params, vocab, beam_size: int = 0,
                 buckets=DEFAULT_BUCKETS, compute_dtype="bfloat16",
                 max_att_len: int = 0, att_quant: str = "",
                 att_kmajor: int = None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CaptioningService: device 'cuda' asked for but no CUDA "
                "device is available (pass device='cpu' to run the plain "
                "versions on the host)")
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {list(_DTYPES)}")
        # decode layout of the attention context (JAX serving.py:44-51,
        # 110-116): int8 wins over K-major; att_kmajor=None keeps the opt's
        self.att_quant = att_quant or getattr(opt, "att_quant", "")
        if att_kmajor is not None:
            opt = copy.copy(opt)  # the caller's opt stays as it was
            opt.att_kmajor = int(att_kmajor)
        self.opt = opt
        self.vocab = vocab
        self.beam_size = int(beam_size or 0)
        self.buckets = tuple(sorted(buckets))
        self.max_att_len = max_att_len or getattr(opt, "max_att_len", 0) or 36
        self._warned_trunc = False
        self._warned_zero_mask = False
        self._dtype = _DTYPES[compute_dtype]
        speaker_cls = model_zoo.setup(opt, opt.caption_model, "caption_model")
        # the JAX service casts the f32 leaves (serving.py:59-64); a speaker
        # tree has no other floating leaves
        self.speaker = speaker_cls(to_torch(joint.speaker_view(params, opt),
                                            self.device, self._dtype))

    # -- constructors ---------------------------------------------------------
    @classmethod
    def from_run_dir(cls, run_dir, run_id: str = "", model_name: str = None,
                     **kw):
        """Load opt + vocab from infos_<id>.pkl and params from the best (or
        given) model artifact, restored into a template of the run's opt
        through the lenient merge (JAX serving.py:84-98): a leaf the
        checkpoint lacks is reported and keeps the template's value."""
        infos = config_mod.load_infos(
            os.path.join(run_dir, f"infos_{run_id}.pkl"))
        # the infos opt carries the training machine's checkpoint_path; the
        # artifacts live in run_dir here (a copy: the infos stay as loaded)
        opt = copy.copy(infos["opt"])
        opt.checkpoint_path = run_dir
        if model_name is None:
            for cand in ("model-best.pth", "alternatingModel.pth",
                         "model.pth"):
                if os.path.isfile(os.path.join(run_dir, cand)):
                    model_name = cand
                    break
            else:
                raise FileNotFoundError(f"no model artifact in {run_dir}")
        params = ckpt_mod.load_params_into(
            joint.init_params(0, opt), os.path.join(run_dir, model_name))
        return cls(opt, params, infos["vocab"], **kw)

    # -- decode ---------------------------------------------------------------
    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def warmup(self):
        """Run every bucket once (builds the kernels, warms allocator and
        caches) before serving."""
        for b in self.buckets:
            self._run_bucket(np.zeros((b, self.max_att_len,
                                       self.opt.att_feat_size), np.float32),
                             np.ones((b, self.max_att_len), np.float32))

    def _to_device(self, x):
        """Cast on the host before the copy: bf16 features move half the
        bytes (the JAX service's _host_cast)."""
        t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
        return t.to(self._dtype).to(self.device)

    def _run_bucket(self, att, att_masks):
        opt, spk, m = self.opt, self.speaker, self.beam_size
        constraint = getattr(opt, "decoding_constraint", 0)
        with torch.inference_mode():
            am = torch.from_numpy(np.ascontiguousarray(
                att_masks, dtype=np.float32)).to(self.device)
            # att2in2 never reads the fc features: they stay on the host
            ctx = spk.encode_features(None, self._to_device(att), am)
            if self.att_quant == "int8":
                ctx = spk.quantize_ctx(ctx)
            elif getattr(opt, "att_kmajor", 0):
                ctx = spk.kmajor_ctx(ctx)
            if m > 1:
                out = decoding.beam_search(spk, ctx, opt.seq_length, m,
                                           decoding_constraint=constraint)
            else:
                out = decoding.sample(spk, ctx, opt.seq_length, mode="greedy",
                                      decoding_constraint=constraint)
            return out.seq.cpu().numpy()

    # -- public ---------------------------------------------------------------
    def caption_ids(self, fc_feats, att_feats=None, att_masks=None):
        """[n, ...] features -> [n, seq_length] int32 decoded ids
        (0-padded)."""
        n = int(np.asarray(fc_feats).shape[0])
        if n == 0:
            return np.zeros((0, self.opt.seq_length), np.int32)
        if att_feats is None:
            raise ValueError("the att2in2 speaker needs att_feats")
        if np.asarray(att_feats).shape[1] > self.max_att_len and \
                not self._warned_trunc:
            self._warned_trunc = True
            print(f"warning: truncating attention features "
                  f"{np.asarray(att_feats).shape[1]} -> {self.max_att_len} "
                  f"regions; construct the service with max_att_len= to keep "
                  f"them all")
        b = self._bucket_for(n)

        def pad0(x, to):
            x = np.asarray(x)
            if x.shape[0] == to:
                return x
            return np.concatenate(
                [x, np.zeros((to - x.shape[0],) + x.shape[1:], x.dtype)])

        outs = []
        for start in range(0, n, b):
            chunk = slice(start, min(start + b, n))
            # re-bucket the remainder chunk instead of padding it to b
            cb = self._bucket_for(min(b, n - start))
            a = np.asarray(att_feats)[chunk]
            K = self.max_att_len
            if a.shape[1] < K:
                a = np.pad(a, ((0, 0), (0, K - a.shape[1]), (0, 0)))
            else:
                a = a[:, :K]
            att = pad0(a, cb)
            m = np.asarray(att_masks)[chunk] if att_masks is not None \
                else np.ones(np.asarray(att_feats)[chunk].shape[:2],
                             np.float32)
            if m.shape[1] < K:
                m = np.pad(m, ((0, 0), (0, K - m.shape[1])))
            else:
                m = m[:, :K]
            # a real row with no valid region left (all beyond K after
            # truncation, or a degenerate input) would make the masked
            # softmax emit NaN: give it its first key back, on a copy
            zero_rows = m.sum(axis=1) == 0
            if zero_rows.any():
                if not self._warned_zero_mask:
                    self._warned_zero_mask = True
                    print("warning: attention mask rows with no valid "
                          "region after truncation; forcing the first "
                          "key valid for those rows")
                m = m.copy()
                m[zero_rows, 0] = 1.0
            # filler rows need one valid key too; pad0 copied when filler
            # rows exist, so this write never reaches the caller's array
            rows = chunk.stop - chunk.start
            m = pad0(m, cb)
            if rows < cb:
                m[rows:, 0] = 1.0
            seq = self._run_bucket(att, m)
            outs.append(seq[:rows])
        return np.concatenate(outs, axis=0)

    def caption(self, fc_feats, att_feats=None, att_masks=None):
        """[n, ...] features -> list of n caption strings."""
        return decode_sequence(self.vocab,
                               self.caption_ids(fc_feats, att_feats,
                                                att_masks))


# ---------------------------------------------------------------------------
# HTTP tier: a dependency-free JSON/npz endpoint over CaptioningService.
# ---------------------------------------------------------------------------

def make_http_server(service, host="127.0.0.1", port=8000):
    """ThreadingHTTPServer over a CaptioningService.

    POST /caption with either
      * Content-Type application/x-npz -- an np.savez payload with arrays
        `fc` [n, fc_dim] and optional `att` [n, K, att_dim] / `att_masks`
        [n, K], or
      * JSON {"fc": [[...]], "att": [[[...]]], "att_masks": [[...]]}
    -> {"captions": [...], "ids": [[...]]}.  GET /healthz -> readiness and
    bucket config.  Decode calls are serialized with a lock: one device
    serves one batch at a time."""
    import io
    import json
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet by default
            pass

        def do_GET(self):
            if self.path != "/healthz":
                return self._send(404, {"error": "not found"})
            self._send(200, {"status": "ok",
                             "buckets": list(service.buckets),
                             "beam_size": service.beam_size,
                             "max_att_len": service.max_att_len,
                             "device": str(service.device)})

        def do_POST(self):
            if self.path != "/caption":
                return self._send(404, {"error": "not found"})
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n)
            ctype = self.headers.get("Content-Type", "application/json")
            try:
                if "npz" in ctype:
                    z = np.load(io.BytesIO(raw), allow_pickle=False)
                    fc = z["fc"]
                    att = z["att"] if "att" in z.files else None
                    am = z["att_masks"] if "att_masks" in z.files else None
                else:
                    req = json.loads(raw.decode())
                    fc = np.asarray(req["fc"], np.float32)
                    att = np.asarray(req["att"], np.float32) \
                        if req.get("att") is not None else None
                    am = np.asarray(req["att_masks"], np.float32) \
                        if req.get("att_masks") is not None else None
                with lock:
                    ids = service.caption_ids(fc, att, am)
                caps = decode_sequence(service.vocab, ids)
            except Exception as e:  # the server keeps running; report it
                return self._send(400, {"error": f"{type(e).__name__}: {e}"})
            self._send(200, {"captions": caps, "ids": ids.tolist()})

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    """python -m cooperativeimagecaptioning_tpu_torch.serving --run_dir D"""
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run_dir", required=True)
    p.add_argument("--run_id", default="")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--beam_size", type=int, default=0)
    p.add_argument("--buckets", type=int, nargs="+",
                   default=list(DEFAULT_BUCKETS))
    p.add_argument("--max_att_len", type=int, default=0)
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=sorted(_DTYPES))
    p.add_argument("--att_quant", default="", choices=["", "int8"],
                   help="int8: quantize the attention context (half the "
                        "bytes of bfloat16 per decode step)")
    p.add_argument("--att_kmajor", type=int, default=None, choices=[0, 1],
                   help="override the run's K-major decode layout")
    p.add_argument("--device", default="cuda")
    p.add_argument("--warmup", action="store_true",
                   help="run every bucket once before accepting requests")
    a = p.parse_args(argv)
    svc = CaptioningService.from_run_dir(
        a.run_dir, run_id=a.run_id, beam_size=a.beam_size,
        buckets=tuple(a.buckets), compute_dtype=a.compute_dtype,
        max_att_len=a.max_att_len, att_quant=a.att_quant,
        att_kmajor=a.att_kmajor, device=a.device)
    if a.warmup:
        print("warming up buckets...", flush=True)
        svc.warmup()
    srv = make_http_server(svc, a.host, a.port)
    print(f"serving {a.run_dir} on http://{a.host}:{a.port} "
          f"(buckets {svc.buckets}, beam {svc.beam_size}, {svc.device})",
          flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
