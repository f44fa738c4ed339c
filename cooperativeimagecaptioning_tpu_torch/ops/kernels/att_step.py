"""Fused additive attention for the Att2in2 step, in three context layouts.

Counterpart of the JAX package's ops/pallas/att_step.py.  Each `fused_*`
wrapper launches its hand-written kernel of csrc/att_step.cu for CUDA
tensors and takes its plain version (`attention_reference*`) for CPU
tensors:

    fused_attention         b-major context  att_emb [B,K,H], p_att [B,K,A]
    fused_attention_q       int8 context from `quantize_features`
                            (per-(b,k) symmetric scales), dequantized inside
                            the kernel
    fused_attention_kmajor  K-major context  att_emb_t [K,B,H], p_att_t
                            [K,B,A]; masks stay [B,K]; decode only

    att_h  = h @ W_h2att + b                         [B, A]
    scores = tanh(p_att + att_h[:, None]) @ w_alpha + b_alpha   [B, K]
    w      = softmax(scores); masked: w * mask, renormalized (ref
             AttModel.py:480-483 -- not -inf masking; no mask, no
             renormalization)
    out    = sum_k w_k * att_emb_k                   [B, H]

All versions compute in float32 and return h's dtype, as the Pallas kernels
did (f32 accumulation, bf16 or f32 in and out).

Each of the three calls is two launches inside one wrapper call (one
count of the kernel).  A hand-written pre-pass computes att_h + bias as
float32 [B, A] into a scratch tensor on the tensor cores (bf16 on
`mma.sync`, from PRE_MANY_ROWS rows through a ring of stages; float32 as
split TF32; shapes that are not 16-byte aligned on FMAs: `pre_pass`).
The stream kernel, launched as the pre-pass's programmatic dependent where
`stream_plan` says so, starts copying the context while the pre-pass runs
and waits for it only before it copies att_h.  A block's producer warp
fills a ring of shared-memory stages with asynchronous bulk copies
(`cp.async.bulk`, a full and an empty mbarrier a stage), its eight
consumer warps compute the scores, the softmax and the weighted sum; the
rows of a block are blockIdx, blockIdx + grid, ...; the int8 context
travels the same way at one byte an element and is dequantized in
registers (bf16 calls in packed half precision).  `stream_plan` chooses
the grid (up to four blocks an SM), slots per stage, stages and whether
the stream is a dependent launch, and with them shared memory;
`stream_copies` lists the copies the kernel makes under a plan, for the
CPU tests.  K may be anything up to MAX_K (256: the repo's own 14 x 14
feature grid is 196 slots).  Shapes or pointers that are not 16-byte
aligned take the same kernel at vector width 1 (`vector_width`);
`_dispatch.att_width_launches` says which width ran, and
`_dispatch.att_pre_launches` which pre-pass.

Under autograd `fused_attention` and `fused_attention_q` go through
`Attention`, a torch.autograd.Function standing in for the JAX custom_vjps
(att_step.py:247-286): its forward is the kernel (or the plain version on
the CPU), its backward recomputes the call's plain version
(`attention_reference` or `attention_reference_q`) and differentiates
that, as JAX `_bwd` / `_bwd_q` do.  There is no backward kernel, as there
was none on the TPU.  `masks` gets no gradient, and of the quantized call
only h and the weights do.  `fused_attention_kmajor` has no gradient (JAX
att_step.py:383-387) and refuses inputs that require one.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from cooperativeimagecaptioning_tpu_torch.ops.kernels import _build, _dispatch

MAX_K = 256  # attention slots a call may have (kMaxK)
# the stream kernel's constants (csrc/att_step.cu)
THREADS = 256        # kThreads: consumer threads of a block
BLOCK_THREADS = 288  # kBlockThreads: and one producer warp
MAX_STAGES = 8       # kMaxStages
MAX_SLOTS = 16       # kMaxSlots: slots a chunk, two a consumer warp at most
MAX_COLS = 16        # kMaxCols: columns a thread of the width-1 path may own
BAR_BYTES = 128      # kBarBytes: the ring stages' full and empty mbarriers
MAX_SMEM = 232448    # kMaxSmem: 227 KiB of shared memory a block may ask for
PRE_SMEM = 116736    # kPreSmem: the most a pre-pass block takes
PRE_MANY_ROWS = 2048  # kPreManyRows: bf16 rows of the ring pre-pass
SM_SMEM = 233472     # the shared memory of an SM (228 KiB)
BLOCK_RESERVED = 1024  # that the runtime keeps a resident block
SM_BLOCKS = 4        # kStreamBlocks: most stream blocks an SM, bf16
SM_BLOCKS_F32 = 3    # kStreamBlocksF32: and f32
MAX_SPLIT = 8        # kMaxSplit: thread groups sharing a column group (A, E)


def vector_width(H, A, itemsize, aligned=True):
    """Context elements (of `itemsize` bytes) a copy and a shared-memory
    load of the stream kernel take at once: 16 bytes' worth where H and A
    are multiples of that, H has at most one such column group a thread
    (and, int8, at most two pairs of columns: H <= 1024) and the tensors are
    16-byte aligned, else 1."""
    vec = 16 // itemsize
    if aligned and H % vec == 0 and A % vec == 0 and H // vec <= THREADS \
            and (itemsize > 1 or H <= 4 * THREADS):
        return vec
    return 1


def col_split(H, vec):
    """Thread groups of the weighted sum of A and E at vector width that
    share one column group (col_split of csrc/att_step.cu)."""
    groups = H // vec
    return 1 if groups >= THREADS else min(THREADS // groups, MAX_SPLIT)


class StreamPlan(NamedTuple):
    """How the stream kernel runs one call; see `stream_plan`."""
    vec: int          # vector width in elements (16 bytes' worth, or 1)
    kmajor: bool
    rows: int         # most batch rows a block walks
    slots: int        # attention slots a chunk (a ring stage) holds
    stages: int       # ring stages
    stage_bytes: int
    smem_bytes: int   # the block's dynamic shared memory
    grid: int         # blocks; block i takes rows i, i + grid, ...
    dependent: bool   # launched as the pre-pass's programmatic dependent


@functools.lru_cache(maxsize=256)
def stream_plan(B, K, H, A, itemsize, kmajor, vec=None, sms=132, hsize=None):
    """The launch parameters of the stream kernel for a [B, K, H] / [B, K, A]
    context of `itemsize`-byte elements (K-major: [K, B, *]) on a card of
    `sms` SMs, for a call whose h has `hsize`-byte elements (default: the
    context's, bf16 for int8).  `vec` defaults to `vector_width` of aligned
    tensors.

    As many blocks an SM as B has rows an SM, at most SM_BLOCKS for bf16
    calls (56 registers a thread) and SM_BLOCKS_F32 for f32 (72): grid =
    min(B, blocks an SM x sms), a block's rows interleaved.  A stage holds
    8 slots (one a consumer warp) of the wider of H and A, 16 for the
    one-byte int8 context (the same bytes as bf16); the ring has 8 stages,
    fewer (down to 3), then fewer slots, then fewer stages where that
    outgrows the block's share of the SM's shared memory -- and, where the
    launch is dependent (the vector path), what a pre-pass block (PRE_SMEM)
    leaves beside it, so that a block of the stream starts on every SM
    while the pre-pass runs.  The K-major layout takes the same plan: a
    chunk is then `slots` runs of one row's slot instead of one run."""
    if vec is None:
        vec = vector_width(H, A, itemsize)
    wide = max(H, A)
    a4 = -(-A // 4) * 4
    k4 = -(-K // 4) * 4
    if hsize is None:
        hsize = itemsize if itemsize > 1 else 2
    per_sm = min(SM_BLOCKS if hsize == 2 else SM_BLOCKS_F32, -(-B // sms))
    red = (col_split(H, vec) - 1) * H if vec > 1 and itemsize > 1 else 0
    side = 3 if itemsize == 1 else 1  # mask, and int8's two scale rows
    grid = min(B, per_sm * sms)
    # the vector path's stream is the pre-pass's programmatic dependent at
    # every shape: faster at each timed one, B=4096 included (PERF.md,
    # row A); the width-1 path waits for the pre-pass before its first copy
    dependent = vec > 1
    limit = min(MAX_SMEM, SM_SMEM // per_sm - BLOCK_RESERVED)
    if dependent:
        limit = min(limit, SM_SMEM - PRE_SMEM - 2 * BLOCK_RESERVED)

    def stage(slots):
        return -(-slots * wide * itemsize // 16) * 16

    def smem(slots, stages):
        # floats: the row slots (att_h, mask, int8's scale rows), w_alpha, the
        # scores of two rows, each consumer warp's weights of a chunk, A's
        # and E's partial sums of the weighted sum
        return BAR_BYTES + stages * stage(slots) + 4 * (
            stages * (a4 + side * k4) + a4 + 2 * k4 + 8 * MAX_SLOTS + red)

    slots = min(K, 8 * max(1, 2 // itemsize))
    stages = MAX_STAGES
    while stages > 3 and smem(slots, stages) > limit:
        stages -= 1
    while slots > 1 and smem(slots, stages) > limit:
        slots = (slots + 1) // 2
    while stages > 2 and smem(slots, stages) > limit:
        stages -= 1
    return StreamPlan(vec, bool(kmajor), -(-B // grid), slots, stages,
                      stage(slots), smem(slots, stages), grid, dependent)


def stream_copies(plan, B, K, H, A, itemsize):
    """Every copy from the context into shared memory that the stream kernel
    makes under `plan`, as a dict of equally long int64 arrays: `tensor` (0:
    p_att, 1: att_emb), `row`, `k0` and `nk` (the slots covered), `src_byte`
    and `nbytes` (the contiguous run in the tensor), `block`, `chunk` (its
    place in the block's sequence), `stage` and `dst_byte` (inside the
    stage).  In the b-major layout a chunk is one run, in the K-major layout
    one run a slot.  Row b is block b % grid's (b // grid)-th row."""
    grid, slots, stages = plan.grid, plan.slots, plan.stages
    cpt = -(-K // slots)
    b = np.arange(B, dtype=np.int64)
    out = {k: [] for k in ("tensor", "row", "k0", "nk", "src_byte", "nbytes",
                           "block", "chunk", "stage", "dst_byte")}
    for tensor, width in ((0, A), (1, H)):
        for q in range(cpt):
            k0 = q * slots
            nk = min(slots, K - k0)
            chunk = (b // grid) * 2 * cpt + tensor * cpt + q
            runs = [(0, nk)] if not plan.kmajor else \
                [(j, 1) for j in range(nk)]
            for j, n in runs:
                slot = (k0 + j) * B + b if plan.kmajor else b * K + k0 + j
                cols = {"tensor": tensor, "row": b, "k0": k0 + j, "nk": n,
                        "src_byte": slot * width * itemsize,
                        "nbytes": n * width * itemsize, "block": b % grid,
                        "chunk": chunk, "stage": chunk % stages,
                        "dst_byte": j * width * itemsize}
                for key, v in cols.items():
                    out[key].append(np.broadcast_to(
                        np.asarray(v, np.int64), b.shape))
    return {k: np.concatenate(v) for k, v in out.items()}


def attention_reference(h, att_emb, p_att, w_h2att, b_h2att, w_alpha, b_alpha,
                        masks):
    """Plain PyTorch version (the CPU path, the kernel's oracle and the
    backward's recompute).  Computes in float32, or in float64 for float64
    inputs (the gradient checks)."""
    f = torch.promote_types(h.dtype, torch.float32)
    att_h = h.to(f) @ w_h2att.to(f) + b_h2att.to(f)
    dot = torch.tanh(p_att.to(f) + att_h[:, None, :])
    scores = (dot @ w_alpha.to(f)).squeeze(-1) + b_alpha.to(f)
    w = torch.softmax(scores, dim=-1)
    if masks is not None:
        w = w * masks.to(f)
        w = w / w.sum(dim=1, keepdim=True)
    out = torch.einsum("bk,bkh->bh", w, att_emb.to(f))
    return out.to(h.dtype)


def _quantize(x):
    """One float32 temporary of x's shape: the division, the rounding and
    the clip run in place on it.  The 127 is a tensor on x's device: PyTorch
    divides a CUDA tensor by a Python number as a product with its rounded
    reciprocal, which moves some scales by an ulp and with them a few int8
    values; a tensor divisor is a true division, the same on every device."""
    q = x.to(torch.float32, copy=True)
    scale = torch.clamp(torch.linalg.vector_norm(q, float("inf"), dim=-1),
                        min=1e-12) / q.new_full((), 127.0)
    q.div_(scale[..., None]).round_().clamp_(-127, 127)
    return q.to(torch.int8), scale


def quantize_features(att_emb, p_att):
    """Per-(b,k) symmetric int8 quantization of the attention context (JAX
    att_step.py:56-68), run once per decode on the context's device.

    Returns (emb_q int8 [B,K,H], emb_scale f32 [B,K],
             p_q int8 [B,K,A], p_scale f32 [B,K]).  The relative error of an
    element is at most 1/254 of its row's largest magnitude."""
    eq, se = _quantize(att_emb)
    pq, sp = _quantize(p_att)
    return eq, se, pq, sp


def dequantize_features(emb_q, emb_scale, p_q, p_scale):
    emb = emb_q.float() * emb_scale[..., None]
    p_att = p_q.float() * p_scale[..., None]
    return emb, p_att


def attention_reference_q(h, emb_q, emb_scale, p_q, p_scale, w_h2att, b_h2att,
                          w_alpha, b_alpha, masks):
    """Plain version of the int8 kernel: dequantize, then the reference."""
    emb, p_att = dequantize_features(emb_q, emb_scale, p_q, p_scale)
    return attention_reference(h, emb, p_att, w_h2att, b_h2att, w_alpha,
                               b_alpha, masks)


def attention_reference_kmajor(h, att_emb_t, p_att_t, w_h2att, b_h2att,
                               w_alpha, b_alpha, masks):
    """Plain version on the transposed layout (masks stay [B, K])."""
    return attention_reference(h, att_emb_t.movedim(0, 1),
                               p_att_t.movedim(0, 1), w_h2att, b_h2att,
                               w_alpha, b_alpha, masks)


class Attention(torch.autograd.Function):
    """A fused attention call with a gradient.  `forward_impl` computes the
    forward (the kernel, or the plain version); the backward always
    differentiates `reference`, the call's plain version, with respect to
    its arguments before the masks, except those at the positions in
    `const` (the int8 context and its scales)."""

    @staticmethod
    def forward(ctx, forward_impl, reference, const, *args):
        ctx.save_for_backward(*args)
        ctx.reference, ctx.const = reference, const
        return forward_impl(*args)

    @staticmethod
    def backward(ctx, g):
        *xs, masks = ctx.saved_tensors
        needs = [n and i not in ctx.const
                 for i, n in enumerate(ctx.needs_input_grad[3:-1])]
        return (None, None, None, *_dispatch.reference_vjp(
            ctx.reference, xs, (masks,), needs, (g,)), None)


def fused_attention(h, att_emb, p_att, w_h2att, b_h2att, w_alpha, b_alpha,
                    masks):
    """h [B,H], att_emb [B,K,H], p_att [B,K,A], w_h2att [H,A], b_h2att [A],
    w_alpha [A,1], b_alpha [1], masks [B,K] float32 or None -> [B,H] in
    h's dtype."""
    impl = attention_kernel if _dispatch.use_kernel(h) else \
        attention_reference
    args = (h, att_emb, p_att, w_h2att, b_h2att, w_alpha, b_alpha)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return Attention.apply(impl, attention_reference, (), *args, masks)
    return impl(*args, masks)


def fused_attention_q(h, emb_q, emb_scale, p_q, p_scale, w_h2att, b_h2att,
                      w_alpha, b_alpha, masks):
    """Attention over an int8 context from `quantize_features`: h [B,H],
    emb_q int8 [B,K,H], emb_scale f32 [B,K], p_q int8 [B,K,A], p_scale f32
    [B,K], then the weights and masks as `fused_attention` -> [B,H] in h's
    dtype.  Gradients reach h and the weights only."""
    impl = attention_q_kernel if _dispatch.use_kernel(h) else \
        attention_reference_q
    live = (h, w_h2att, b_h2att, w_alpha, b_alpha)
    if torch.is_grad_enabled() and any(t.requires_grad for t in live):
        return Attention.apply(impl, attention_reference_q, (1, 2, 3, 4), h,
                               emb_q, emb_scale, p_q, p_scale, w_h2att,
                               b_h2att, w_alpha, b_alpha, masks)
    return impl(h, emb_q, emb_scale, p_q, p_scale, w_h2att, b_h2att, w_alpha,
                b_alpha, masks)


def fused_attention_kmajor(h, att_emb_t, p_att_t, w_h2att, b_h2att, w_alpha,
                           b_alpha, masks):
    """Attention over a K-major context: h [B,H], att_emb_t [K,B,H],
    p_att_t [K,B,A], masks [B,K] (b-major) or None -> [B,H].  Decode only:
    no gradient."""
    _dispatch.forward_only("fused_attention_kmajor", h, att_emb_t, p_att_t,
                           w_h2att, b_h2att, w_alpha, b_alpha)
    impl = attention_kmajor_kernel if _dispatch.use_kernel(h) else \
        attention_reference_kmajor
    return impl(h, att_emb_t, p_att_t, w_h2att, b_h2att, w_alpha, b_alpha,
                masks)


def _check_weights(name, h, K, w_h2att, b_h2att, w_alpha, b_alpha, masks):
    """Checks shared by the three kernels; returns (B, H, A)."""
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} kernel takes float32 or bfloat16, "
                        f"got {h.dtype}")
    B, H = h.shape
    A = w_h2att.shape[1]
    if not 1 <= K <= MAX_K:
        raise ValueError(f"{name} kernel takes 1..{MAX_K} attention slots, "
                         f"got K={K}")
    if tuple(w_h2att.shape) != (H, A) or b_h2att.numel() != A \
            or w_alpha.numel() != A or b_alpha.numel() != 1:
        raise ValueError(f"{name} kernel: parameter shapes do not match "
                         f"h {tuple(h.shape)}, w_h2att "
                         f"{tuple(w_h2att.shape)}")
    _dispatch.check_cuda_inputs(
        name, {"h": h, "w_h2att": w_h2att, "b_h2att": b_h2att,
               "w_alpha": w_alpha, "b_alpha": b_alpha}, h.dtype)
    if masks is not None:
        if tuple(masks.shape) != (B, K):
            raise ValueError(f"masks {tuple(masks.shape)}, expected {(B, K)}")
        _dispatch.check_cuda_inputs(name, {"masks": masks}, torch.float32)
        if masks.device != h.device:
            raise ValueError(f"{name}: masks on another device than h")
    return B, H, A


@functools.lru_cache(maxsize=None)
def _sm_count(device_index):
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _aligned(*tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def att_h_kernel(h, w_h2att, b_h2att):
    """Launch the pre-pass of csrc/att_step.cu alone on CUDA tensors:
    h @ w_h2att + b_h2att as float32 [B, A]."""
    name = "att_h"
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} kernel takes float32 or bfloat16, "
                        f"got {h.dtype}")
    B, H = h.shape
    A = w_h2att.shape[1]
    if tuple(w_h2att.shape) != (H, A) or b_h2att.numel() != A:
        raise ValueError(f"{name} kernel: w_h2att {tuple(w_h2att.shape)}, "
                         f"b_h2att {tuple(b_h2att.shape)} do not match h "
                         f"{tuple(h.shape)}")
    _dispatch.check_cuda_inputs(name, {"h": h, "w_h2att": w_h2att,
                                       "b_h2att": b_h2att}, h.dtype)
    att_h = torch.empty(B, A, dtype=torch.float32, device=h.device)
    vec = vector_width(H, A, h.element_size(), _aligned(h, w_h2att))
    lib = _build.library()
    code = lib.cic_att_h(_build.ptr(h), _build.ptr(w_h2att),
                         _build.ptr(b_h2att), _build.ptr(att_h), B, H, A,
                         int(h.dtype == torch.bfloat16), int(vec > 1),
                         _build.stream(h.device))
    _build.check(lib, code, name)
    return att_h


LAYOUTS = {"attention": 0, "attention_kmajor": 1, "attention_q": 2}


def resident_blocks(plan, K, H, A, dtype, layout="attention"):
    """Blocks of the stream kernel that one SM of the current card holds at
    once under `plan` for a call of `layout` (a kernel name of LAYOUTS; asks
    the CUDA runtime; builds the kernels)."""
    lib = _build.library()
    n = lib.cic_attention_blocks_per_sm(
        int(dtype == torch.bfloat16), LAYOUTS[layout], int(plan.vec > 1),
        plan.slots, plan.stages, K, H, A)
    _build.check(lib, max(0, -n), "attention_blocks_per_sm")
    return n


def pre_pass(dtype, vec, B):
    """The att_h pre-pass a call of B rows takes (csrc/att_step.cu
    launch_att_h): "tf32x3" (float32, split TF32 on mma.sync), "mma"
    (bfloat16 on mma.sync, the whole depth at once) below PRE_MANY_ROWS
    rows, "ring" (bfloat16, 64 x 128 tiles through a ring of stages) from
    there or, where the tensors are not 16-byte aligned (`vec` 1), "fma"."""
    if vec <= 1:
        return "fma"
    if dtype != torch.bfloat16:
        return "tf32x3"
    return "ring" if B >= PRE_MANY_ROWS else "mma"


def _launch_stream(name, entry, h, ctx, weights, masks, K, kmajor):
    """Launch the pre-pass and the stream kernel through C entry `entry`:
    `ctx` holds the context tensors in the entry's order (emb, p_att; or
    emb_q, emb_scale, p_q, p_scale); the two 3-dimensional ones decide the
    element size and, with h, W_h2att and the output, the vector width (no
    autograd)."""
    B, H = h.shape
    A = weights[0].shape[1]
    wide = [t for t in ctx if t.dim() == 3]
    itemsize = wide[0].element_size()
    out = torch.empty_like(h)
    att_h = torch.empty(B, A, dtype=torch.float32, device=h.device)
    vec = vector_width(H, A, itemsize,
                       _aligned(h, *wide, weights[0], out))
    plan = stream_plan(B, K, H, A, itemsize, kmajor, vec,
                       _sm_count(h.device.index or 0), h.element_size())
    lib = _build.library()
    code = getattr(lib, entry)(
        _build.ptr(h), *(_build.ptr(t) for t in ctx),
        *(_build.ptr(w) for w in weights), _build.ptr(masks),
        _build.ptr(att_h), _build.ptr(out), B, K, H, A,
        int(h.dtype == torch.bfloat16), int(vec > 1), plan.grid, plan.slots,
        plan.stages, int(plan.dependent), _build.stream(h.device))
    _build.check(lib, code, name)
    _dispatch.count(name, "vec" if vec > 1 else "scalar",
                    pre=pre_pass(h.dtype, vec, B))
    return out


def _launch_dense(name, entry, kmajor, h, emb, p_att, weights, masks):
    """Launch the b-major or the K-major kernels (no autograd)."""
    if emb.dim() != 3:
        raise ValueError(f"{name} kernel: context {tuple(emb.shape)} is not "
                         f"3-dimensional")
    K = emb.shape[0 if kmajor else 1]
    B, H, A = _check_weights(name, h, K, *weights, masks)
    want = [(K, B, n) if kmajor else (B, K, n) for n in (H, A)]
    if [tuple(emb.shape), tuple(p_att.shape)] != want:
        raise ValueError(f"{name} kernel: context {tuple(emb.shape)}, "
                         f"{tuple(p_att.shape)}, expected {want[0]}, "
                         f"{want[1]}")
    _dispatch.check_cuda_inputs(name, {"h": h, "att_emb": emb,
                                       "p_att": p_att}, h.dtype)
    return _launch_stream(name, entry, h, (emb, p_att), weights, masks, K,
                          kmajor)


def attention_kernel(h, att_emb, p_att, w_h2att, b_h2att, w_alpha, b_alpha,
                     masks):
    """Launch the b-major kernels of csrc/att_step.cu (pre-pass, stream) on
    CUDA tensors (no autograd)."""
    return _launch_dense("attention", "cic_attention", False, h, att_emb,
                         p_att, (w_h2att, b_h2att, w_alpha, b_alpha), masks)


def attention_kmajor_kernel(h, att_emb_t, p_att_t, w_h2att, b_h2att, w_alpha,
                            b_alpha, masks):
    """Launch the K-major kernels of csrc/att_step.cu (pre-pass, stream) on
    CUDA tensors."""
    return _launch_dense("attention_kmajor", "cic_attention_kmajor", True, h,
                         att_emb_t, p_att_t,
                         (w_h2att, b_h2att, w_alpha, b_alpha), masks)


def attention_q_kernel(h, emb_q, emb_scale, p_q, p_scale, w_h2att, b_h2att,
                       w_alpha, b_alpha, masks):
    """Launch the int8 kernels of csrc/att_step.cu (pre-pass, stream over
    the int8 context) on CUDA tensors (no autograd)."""
    name = "attention_q"
    if emb_q.dim() != 3:
        raise ValueError(f"emb_q {tuple(emb_q.shape)} is not [B, K, H]")
    K = emb_q.shape[1]
    B, H, A = _check_weights(name, h, K, w_h2att, b_h2att, w_alpha, b_alpha,
                             masks)
    if tuple(emb_q.shape) != (B, K, H) or tuple(p_q.shape) != (B, K, A) \
            or tuple(emb_scale.shape) != (B, K) \
            or tuple(p_scale.shape) != (B, K):
        raise ValueError(f"{name} kernel: context {tuple(emb_q.shape)}, "
                         f"{tuple(p_q.shape)}, scales "
                         f"{tuple(emb_scale.shape)}, {tuple(p_scale.shape)} "
                         f"does not match h {tuple(h.shape)}, w_h2att "
                         f"{(H, A)}")
    _dispatch.check_cuda_inputs(name, {"emb_q": emb_q, "p_q": p_q},
                                torch.int8)
    _dispatch.check_cuda_inputs(name, {"emb_scale": emb_scale,
                                       "p_scale": p_scale}, torch.float32)
    if emb_q.device != h.device or emb_scale.device != h.device:
        raise ValueError(f"{name}: the context is on another device than h")
    return _launch_stream(name, "cic_attention_q", h,
                          (emb_q, emb_scale, p_q, p_scale),
                          (w_h2att, b_h2att, w_alpha, b_alpha), masks, K,
                          False)
