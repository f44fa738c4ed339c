"""Fused greedy logit head: h @ W + b -> (argmax, logprob of the argmax).

Counterpart of the JAX package's ops/pallas/logit_head.py.  `greedy_head`
launches the kernel in csrc/logit_head.cu for CUDA tensors -- one kernel in
place of the two Pallas variants -- and takes `greedy_head_reference` for
CPU tensors.  The [B, V] logits are never written by the kernel.  Ties go to
the lower id (the first maximum, as jnp.argmax and torch.argmax).  The
logits are float32 (f32 accumulation from bf16 or f32 inputs); the outputs
are it int32 [B] and lp float32 [B].  Forward only.

The kernel is two passes: partials per (row tile, vocab split), then a merge
of the splits.  The first pass has three forms, chosen by `head_pass` from
the inputs' type, shape and alignment alone: bfloat16 with H a multiple of
64 (at most 640) and V a multiple of 8 takes the TMA pass
(csrc/vocab_head_tma.cuh: wgmma fed by a TMA ring, the epilogue of a tile
beside the next tile's products); float32 with H a multiple of 64 and V a
multiple of 4 takes the split-TF32 pass (csrc/vocab_head_tf32.cuh: three TF32
mma.sync products of each operand's two TF32 parts); every other input,
and any whose tensors do not start on 16 bytes, takes the FMA pass
(csrc/vocab_head.cuh).  None gives way to another or to the plain version
when a launch fails: that raises.

On a registered vocab mesh whose rank holds a slice of the logit layer,
`greedy_head` takes `greedy_head_sharded` (JAX logit_head.py:202-238): the
m = 1 case of the sharded beam head, so the per-shard kernel is C at kk=1,
one all_gather of its records, and `head_merge` in its greedy mode, which
gives idx[:, 0] and vals[:, 0] - lse itself.  It is forward-only as the
local head (the JAX package's zero-gradient custom_vjp).
"""

from __future__ import annotations

import functools

import torch

from cooperativeimagecaptioning_tpu_torch.ops.kernels import _build, _dispatch
from cooperativeimagecaptioning_tpu_torch.parallel import vocab

CHUNK = 512      # columns one block sweeps at a time (kChunk)
ROW_TILE = 16    # rows per block of the greedy kernel (kGreedyRows)
# the tensor-core passes (csrc/vocab_head_tma.cuh, csrc/vocab_head_tf32.cuh)
MMA_ROW_TILE = 128   # rows per block (kTmaRows, kTf32Rows)
# the bf16 TMA pass (csrc/vocab_head_tma.cuh)
TMA_COL_TILE = 64    # columns per tile: one accumulator set (kTmaCols)
TMA_SPLIT_UNIT = 128  # its vocab splits come in units of two tiles
TMA_DEPTH = 64       # H must be a multiple: the k of an h box (kTmaBoxK)
TMA_MAX_DEPTH = 640  # largest H whose rows fit beside a ring (kTmaMaxDepth)
# the split-TF32 pass (csrc/vocab_head_tf32.cuh)
TF32_COL_TILE = 72   # columns per tile, nine n8 tiles (kTf32Cols)
TF32_DEPTH = 64      # H must be a multiple (kTf32Depth)
# the entry points' first_pass argument (cic::kPassFma, kPassTf32, kPassTma)
PASS_CODES = {"fma": 0, "tf32x3": 2, "tma": 3}


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
    """Which first pass a head's CUDA launch takes: "tma" (wgmma fed by a
    TMA ring) for bfloat16 with H % 64 == 0, H <= 640 and V % 8 == 0;
    "tf32x3" (split TF32 on mma.sync) for float32 with H % 64 == 0 and V %
    4 == 0; each only with 16-byte aligned tensors (TMA and the 16-byte
    copies need both); "fma" for everything else."""
    if (dtype == torch.bfloat16 and aligned and TMA_DEPTH <= H <= TMA_MAX_DEPTH
            and H % TMA_DEPTH == 0 and V % 8 == 0):
        return "tma"
    if (dtype == torch.float32 and aligned and H >= TF32_DEPTH
            and H % TF32_DEPTH == 0 and V % 4 == 0):
        return "tf32x3"
    return "fma"


def mma_split(rows: int, V: int, sm_count: int,
              col_tile: int = TMA_SPLIT_UNIT) -> tuple:
    """(splits, split_cols) for a tensor-core pass (128-row blocks; splits
    in units of `col_tile` columns: TMA_SPLIT_UNIT for the TMA pass,
    TF32_COL_TILE for the split-TF32 pass), one block an SM: as many vocab
    splits as keep (row tiles x splits) within `sm_count` blocks (one
    wave), each a whole number of units and none empty.  The passes
    compute whole tiles, so only the vocab's last tile is ragged; at V=9488
    the split-TF32 pass's 132 tiles give R=128 one tile a block on 132 SMs,
    R=256 two."""
    row_tiles = -(-rows // MMA_ROW_TILE)
    col_tiles = -(-V // col_tile)
    want = max(1, min(col_tiles, sm_count // row_tiles))
    split_cols = -(-col_tiles // want) * col_tile
    return -(-V // split_cols), split_cols


def plan_first_pass(rows: int, fma_row_tile: int, h, w, b) -> tuple:
    """(pass, splits, split_cols) of a head's launch on these CUDA tensors."""
    H, V = w.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (h, w, b))
    which = head_pass(h.dtype, H, V, aligned)
    if which == "fma":
        return (which, *vocab_split(rows, fma_row_tile, V, h.device))
    # the bf16 pass's splits come in units of 128 columns (two of its
    # tiles): units of 64 would fill more SMs at R=512 but read h more often
    col_tile = TMA_SPLIT_UNIT if which == "tma" else TF32_COL_TILE
    return (which, *mma_split(rows, V, _sm_count(h.device.index or 0),
                              col_tile))


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
    return beam_head.beam_head_sharded(h, w, b, 1, mesh, "greedy")


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
        int(h.dtype == torch.bfloat16), PASS_CODES[which],
        _build.stream(dev))
    _build.check(lib, code, "greedy_head")
    _dispatch.count("greedy_head", which)
    return it, lp
