"""Fused greedy logit head: h @ W + b -> (argmax, logprob of the argmax).

Counterpart of the JAX package's ops/pallas/logit_head.py.  `greedy_head`
launches the kernel in csrc/logit_head.cu for CUDA tensors -- one kernel in
place of the two Pallas variants -- and takes `greedy_head_reference` for
CPU tensors.  The [B, V] logits are never written by the kernel.  Ties go to
the lower id (the first maximum, as jnp.argmax and torch.argmax).  The
logits are float32 (f32 accumulation from bf16 or f32 inputs); the outputs
are it int32 [B] and lp float32 [B].  Forward only.

The kernel is two passes: partials per (row tile, vocab split), then a merge
of the splits.  The first pass has two forms, chosen by `head_pass` from the
inputs' type, shape and alignment alone: bfloat16 with H a multiple of 64
(at most 640) and V a multiple of 8 takes the tensor-core pass
(csrc/vocab_head_mma.cuh: wgmma fed by cp.async); float32, and any other
bfloat16 input, takes the FMA pass (csrc/vocab_head.cuh).  Neither gives way
to the other or to the plain version when a launch fails: that raises.

On a registered vocab mesh whose rank holds a slice of the logit layer,
`greedy_head` takes `greedy_head_sharded` (JAX logit_head.py:202-238): the
m = 1 case of the sharded beam head, so the per-shard kernel is C at kk=1
and the merge `head_merge`; it returns idx[:, 0] and vals[:, 0] - lse.  It
is forward-only as the local head (the JAX package's zero-gradient
custom_vjp).
"""

from __future__ import annotations

import functools

import torch

from cooperativeimagecaptioning_tpu_torch.ops.kernels import _build, _dispatch
from cooperativeimagecaptioning_tpu_torch.parallel import vocab

CHUNK = 512      # columns one block sweeps at a time (kChunk)
ROW_TILE = 16    # rows per block of the greedy kernel (kGreedyRows)
# the tensor-core pass (csrc/vocab_head_mma.cuh)
MMA_ROW_TILE = 128   # rows per block (kMmaRows)
MMA_COL_TILE = 128   # columns per tile (kMmaCols)
MMA_DEPTH = 64       # H must be a multiple (kMmaDepth)
MMA_MAX_DEPTH = 640  # largest H whose rows fit in shared memory (kMmaMaxDepth)


def logits_f32(h, w, b):
    f = torch.float32
    return h.to(f) @ w.to(f) + b.to(f)


def greedy_head_reference(h, w, b):
    """Plain PyTorch version: argmax (first max) and max - logsumexp."""
    logits = logits_f32(h, w, b)
    it = torch.argmax(logits, dim=-1).to(torch.int32)
    m = logits.max(dim=-1).values
    lse = m + torch.log(torch.exp(logits - m[:, None]).sum(dim=-1))
    return it, m - lse


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def vocab_split(rows: int, row_tile: int, V: int, device) -> tuple:
    """(splits, split_cols) for the heads' first pass: enough vocab splits
    that (row tiles x splits) gives about two blocks per SM, each split a
    whole number of CHUNK-column sweeps and none of them empty."""
    row_tiles = -(-rows // row_tile)
    chunks = -(-V // CHUNK)
    want = -(-2 * _sm_count(device.index or 0) // row_tiles)
    splits = max(1, min(chunks, want))
    split_cols = -(-chunks // splits) * CHUNK
    return -(-V // split_cols), split_cols


def head_pass(dtype, H: int, V: int, aligned: bool = True) -> str:
    """Which first pass a head's CUDA launch takes: "mma" (tensor cores) for
    bfloat16 with H % 64 == 0, H <= 640, V % 8 == 0 and 16-byte aligned
    tensors (its 16-byte copies need both), "fma" for everything else."""
    if (dtype == torch.bfloat16 and aligned and MMA_DEPTH <= H <= MMA_MAX_DEPTH
            and H % MMA_DEPTH == 0 and V % 8 == 0):
        return "mma"
    return "fma"


def mma_split(rows: int, V: int, sm_count: int) -> tuple:
    """(splits, split_cols) for the tensor-core pass, one block an SM: as
    many vocab splits as keep (row tiles x splits) within `sm_count` blocks
    (one wave), each a whole number of MMA_COL_TILE-column tiles and none
    empty."""
    row_tiles = -(-rows // MMA_ROW_TILE)
    col_tiles = -(-V // MMA_COL_TILE)
    want = max(1, min(col_tiles, sm_count // row_tiles))
    split_cols = -(-col_tiles // want) * MMA_COL_TILE
    return -(-V // split_cols), split_cols


def plan_first_pass(rows: int, fma_row_tile: int, h, w, b) -> tuple:
    """(pass, splits, split_cols) of a head's launch on these CUDA tensors."""
    H, V = w.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (h, w, b))
    which = head_pass(h.dtype, H, V, aligned)
    if which == "mma":
        return (which, *mma_split(rows, V, _sm_count(h.device.index or 0)))
    return (which, *vocab_split(rows, fma_row_tile, V, h.device))


def partials_scratch(rows: int, splits: int, slots: int, device) -> tuple:
    """One allocation for the first pass's partials; returns (the tensor,
    which the caller keeps alive until the launch is enqueued, and the
    addresses of part_val f32 [rows, splits, slots], part_id int32 [rows,
    splits, slots], part_m f32 [rows, splits], part_s f32 [rows, splits])."""
    n = rows * splits
    buf = torch.empty(n * (2 * slots + 2), dtype=torch.float32, device=device)
    base = buf.data_ptr()
    offsets = (0, n * slots, 2 * n * slots, 2 * n * slots + n)
    return buf, tuple(base + 4 * o for o in offsets)


def check_head_inputs(name, h, w, b):
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} kernel takes float32 or bfloat16, "
                        f"got {h.dtype}")
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[0] \
            or tuple(b.shape) != (w.shape[1],):
        raise ValueError(f"{name}: shapes h {tuple(h.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)} do not fit")
    if h.shape[0] < 1:
        raise ValueError(f"{name}: no rows")
    _dispatch.check_cuda_inputs(name, {"h": h, "w": w, "b": b}, h.dtype)


def greedy_head_sharded(h, w, b, mesh):
    """The greedy head over the model group's vocabulary slices -> (global
    argmax int32 [B], its log-prob float32 [B])."""
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import beam_head
    _dispatch.forward_only("greedy_head", h, w, b)
    vals, idx, lse = beam_head.beam_head_sharded(h, w, b, 1, mesh)
    return idx[:, 0], vals[:, 0] - lse


def greedy_head(h, w, b):
    """h [B, H], w [H, V], b [V] -> (it int32 [B], lp float32 [B]); on a
    vocab mesh, where w is this rank's slice, the global result."""
    mesh = vocab.logit_mesh(w)
    if mesh is not None:
        return greedy_head_sharded(h, w, b, mesh)
    _dispatch.forward_only("greedy_head", h, w, b)
    if not _dispatch.use_kernel(h):
        return greedy_head_reference(h, w, b)
    check_head_inputs("greedy_head", h, w, b)
    R, H = h.shape
    V = w.shape[1]
    which, splits, split_cols = plan_first_pass(R, ROW_TILE, h, w, b)
    dev = h.device
    scratch, parts = partials_scratch(R, splits, 1, dev)
    it = torch.empty((R,), dtype=torch.int32, device=dev)
    lp = torch.empty((R,), dtype=torch.float32, device=dev)
    lib = _build.library()
    code = lib.cic_greedy_head(
        _build.ptr(h), _build.ptr(w), _build.ptr(b), *parts,
        _build.ptr(it), _build.ptr(lp), R, H, V, splits, split_cols,
        int(h.dtype == torch.bfloat16), int(which == "mma"),
        _build.stream(dev))
    _build.check(lib, code, "greedy_head")
    _dispatch.count("greedy_head", which)
    return it, lp
