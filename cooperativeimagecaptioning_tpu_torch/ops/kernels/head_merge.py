"""Merge of the vocab-sharded heads: a model group's gathered per-shard
records -> the global top-m, their global ids and the global logsumexp.

Counterpart of the merge lines of the JAX package's
ops/pallas/beam_head.py::beam_head_sharded (:131-142), which
`greedy_head_sharded` (logit_head.py:202-213) reuses at m = 1.  `head_merge`
launches the kernel in csrc/head_merge.cu for CUDA tensors and takes
`head_merge_reference` for CPU tensors.

A shard's candidates travel as one record a row, so that the model group
gathers one buffer a call (`records`): W float32 words,

  [vals m | local ids m | lse]   W = 2m + 1 (the "beam" and "greedy" modes;
                                 kernel C writes it, cic_beam_head_records),
  [val | local id]               W = 2 (the "argmax" mode, m = 1),

the ids as int32 bits (a view of the buffer, never a float value).  One
all_gather along dim 0 gives `records` [n, R, W], shard-major; v_local is
the columns of one shard (V / n).  Modes and outputs:

  "beam"    vals [R, m] float32, global idx [R, m] int32 (local id + shard *
            v_local), lse [R] = mx + log(sum(exp(lse - mx)));
  "greedy"  (m = 1) it [R] int32, lp [R] float32 = vals[:, 0] - lse of the
            beam mode, the same f32 subtraction (logit_head.py:213);
  "argmax"  (m = 1) global ids [R] int64 (the categorical draw over the
            slices, `parallel/vocab.argmax`).

Order as lax.top_k's over the gathered candidates: the larger value first,
on an exact tie the lower global id (a NaN first, as torch.sort puts it).
Forward only.
"""

from __future__ import annotations

import torch

from cooperativeimagecaptioning_tpu_torch.ops.kernels import _build, _dispatch

MODES = {"beam": 0, "greedy": 1, "argmax": 2}


def record_width(m: int, mode: str) -> int:
    """Words of one record: 2m + 1, or 2 in the argmax mode."""
    return 2 if mode == "argmax" else 2 * m + 1


def records(vals, idx, lse=None):
    """vals [R, m], local ids [R, m] and, but in the argmax mode, lse [R] ->
    the [R, W] float32 records, the ids as int32 bits."""
    parts = [vals.float(), idx.to(torch.int32).view(torch.float32)]
    if lse is not None:
        parts.append(lse.float()[:, None])
    return torch.cat(parts, dim=1)


def head_merge_reference(recs, v_local: int, m: int, mode: str = "beam"):
    """Plain PyTorch version: a stable descending sort of the candidates
    ordered by global id first, so that exact ties go to the lower id."""
    n, R, _ = recs.shape
    shard = torch.arange(n, device=recs.device)[:, None, None]
    gid = recs[..., m:2 * m].view(torch.int32).long() + shard * v_local
    gid = gid.permute(1, 0, 2).reshape(R, n * m)
    vals = recs[..., :m].permute(1, 0, 2).reshape(R, n * m)
    order = torch.argsort(gid, dim=1, stable=True)
    v = torch.gather(vals, 1, order)
    top_v, sel = torch.sort(v, dim=1, descending=True, stable=True)
    top_v = top_v[:, :m]
    top_i = torch.gather(torch.gather(gid, 1, order), 1, sel[:, :m])
    if mode == "argmax":
        return top_i[:, 0]
    lse = recs[..., 2 * m]
    mx = lse.max(dim=0).values
    lse_tot = mx + torch.log(torch.exp(lse - mx[None]).sum(dim=0))
    if mode == "greedy":
        return top_i[:, 0].to(torch.int32), top_v[:, 0] - lse_tot
    return top_v, top_i.to(torch.int32), lse_tot


def _check(recs, v_local: int, m: int, mode: str):
    if mode not in MODES:
        raise ValueError(f"head_merge: no mode {mode!r} (one of "
                         f"{sorted(MODES)})")
    if mode != "beam" and m != 1:
        raise ValueError(f"head_merge: the {mode} mode takes m = 1, got {m}")
    if not 1 <= m <= v_local:
        raise ValueError(f"head_merge takes 1 <= m <= v_local = {v_local}, "
                         f"got {m}")
    if recs.dim() != 3 or recs.shape[2] != record_width(m, mode):
        raise ValueError(f"head_merge: records {tuple(recs.shape)} are not "
                         f"[n, R, {record_width(m, mode)}] (m={m}, {mode})")


def _launch(entry: str, recs, v_local: int, m: int, mode: str):
    """`entry` (the merge or its floor) on CUDA records -> the mode's
    outputs."""
    _dispatch.check_cuda_inputs("head_merge", {"records": recs},
                                torch.float32)
    n, R, _ = recs.shape
    dev = recs.device
    if mode == "beam":
        outs = (torch.empty((R, m), dtype=torch.float32, device=dev),
                torch.empty((R, m), dtype=torch.int32, device=dev),
                torch.empty((R,), dtype=torch.float32, device=dev))
    elif mode == "greedy":
        outs = (torch.empty((R,), dtype=torch.int32, device=dev),
                torch.empty((R,), dtype=torch.float32, device=dev))
    else:
        outs = (torch.empty((R,), dtype=torch.int64, device=dev),)
    ptrs = [_build.ptr(o) for o in outs] + [None] * (3 - len(outs))
    lib = _build.library()
    code = getattr(lib, entry)(_build.ptr(recs), *ptrs, R, n, m, v_local,
                               MODES[mode], _build.stream(dev))
    _build.check(lib, code, "head_merge")
    return outs if len(outs) > 1 else outs[0]


def head_merge(recs, v_local: int, m: int, mode: str = "beam"):
    """records [n, R, W] -> the mode's outputs (module docstring)."""
    _check(recs, v_local, m, mode)
    if not _dispatch.use_kernel(recs):
        return head_merge_reference(recs, v_local, m, mode)
    out = _launch("cic_head_merge", recs, v_local, m, mode)
    _dispatch.count("head_merge")
    return out


def head_merge_floor(recs, v_local: int, m: int, mode: str = "beam"):
    """An empty kernel launched as `head_merge` launches the merge (the same
    checks, outputs and grid; not counted): the floor its time is held
    against.  CUDA records only."""
    _check(recs, v_local, m, mode)
    return _launch("cic_head_merge_floor", recs, v_local, m, mode)
