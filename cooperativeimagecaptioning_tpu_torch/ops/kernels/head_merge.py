"""Merge of the vocab-sharded heads: a model group's gathered per-shard
candidates -> the global top-m, their global ids and the global logsumexp.

Counterpart of the merge lines of the JAX package's
ops/pallas/beam_head.py::beam_head_sharded (:131-142), which
`greedy_head_sharded` reuses at m = 1.  `head_merge` launches the kernel in
csrc/head_merge.cu for CUDA tensors and takes `head_merge_reference` for
CPU tensors.  Inputs, as the model group's all_gathers leave them:

  vals [R, n*m] float32 and idx [R, n*m] int32, shard-major (column j holds
      shard j // m's candidate j % m; ids local to the shard);
  lse  [n, R] float32, each shard's logsumexp;
  v_local, the columns of one shard (V / n).

Outputs: vals [R, m], global idx [R, m] int32 (local id + shard * v_local)
and lse [R] = mx + log(sum(exp(lse - mx))).  Order as lax.top_k's over the
gathered candidates: the larger value first, on an exact tie the lower
global id (a shard's ids all lie below the next shard's, and a shard lists
its tied candidates by id).  Forward only.
"""

from __future__ import annotations

import torch

from cooperativeimagecaptioning_tpu_torch.ops.kernels import _build, _dispatch


def head_merge_reference(vals, idx, lse, v_local: int, m: int):
    """Plain PyTorch version: a stable descending sort of the candidates
    ordered by global id first, so that exact ties go to the lower id."""
    shard = torch.arange(idx.shape[1], device=idx.device) // m
    gid = idx.long() + shard[None] * v_local
    order = torch.argsort(gid, dim=1, stable=True)
    v = torch.gather(vals, 1, order)
    top_v, sel = torch.sort(v, dim=1, descending=True, stable=True)
    top_i = torch.gather(torch.gather(gid, 1, order), 1, sel[:, :m])
    mx = lse.max(dim=0).values
    lse_tot = mx + torch.log(torch.exp(lse - mx[None]).sum(dim=0))
    return top_v[:, :m], top_i.to(torch.int32), lse_tot


def head_merge(vals, idx, lse, v_local: int, m: int):
    """vals [R, n*m], idx [R, n*m], lse [n, R] -> (vals [R, m], idx [R, m],
    lse [R])."""
    n, R = lse.shape
    if tuple(vals.shape) != (R, n * m) or tuple(idx.shape) != (R, n * m):
        raise ValueError(f"head_merge: vals {tuple(vals.shape)}, idx "
                         f"{tuple(idx.shape)} do not fit lse "
                         f"{tuple(lse.shape)} and m={m}")
    if not 1 <= m <= v_local:
        raise ValueError(f"head_merge takes 1 <= m <= v_local = {v_local}, "
                         f"got {m}")
    if not _dispatch.use_kernel(vals):
        return head_merge_reference(vals, idx, lse, v_local, m)
    _dispatch.check_cuda_inputs("head_merge", {"vals": vals, "lse": lse},
                                torch.float32)
    _dispatch.check_cuda_inputs("head_merge", {"idx": idx}, torch.int32)
    if idx.device != vals.device:
        raise ValueError(f"head_merge: idx is on {idx.device}, vals on "
                         f"{vals.device}")
    dev = vals.device
    out_vals = torch.empty((R, m), dtype=torch.float32, device=dev)
    out_idx = torch.empty((R, m), dtype=torch.int32, device=dev)
    out_lse = torch.empty((R,), dtype=torch.float32, device=dev)
    lib = _build.library()
    code = lib.cic_head_merge(
        _build.ptr(vals), _build.ptr(idx), _build.ptr(lse),
        _build.ptr(out_vals), _build.ptr(out_idx), _build.ptr(out_lse),
        R, n, m, v_local, _build.stream(dev))
    _build.check(lib, code, "head_merge")
    _dispatch.count("head_merge")
    return out_vals, out_idx, out_lse
