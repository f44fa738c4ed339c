"""Maxout-LSTM cell of the Att2in2 / FC speakers (ref AttModel.py:514-527,
FCModel.py:26-42).

Counterpart of the JAX package's ops/pallas/cell_step.py.

    sums = (xt @ Wi + bi) + (h @ Wh + bh)
    i, f, o = sigmoid(sums[:3H]);  g = max(sums[3H:4H] (+ a2c[:H]),
                                           sums[4H:5H] (+ a2c[H:]))
    c' = f*c + i*g ;  h' = o*tanh(c')

`fused_cell` is the cell the model calls.  CUDA tensors launch a
hand-written kernel of csrc/ on every call: the split-TF32 kernel
(cell_step.cu) for f32, the wgmma kernel (cell_wgmma.cu) for bf16, the FMA
kernel (cell_step.cu) for the shapes neither takes (`cell_pass`).  CPU
tensors take `cell_reference`, which is what the JAX package computes
everywhere but on a TPU (its switch, CIC_FUSED_CELL, gated the Pallas
kernel on a TPU measurement; the port has no switch) and equals
`cell_plain` at f32.  The kernel has no backward, as
the Pallas kernel had none: `Cell`, a torch.autograd.Function standing in
for the JAX custom_vjp, recomputes `cell_reference` in its backward
(cell_step.py:142-144).
"""

from __future__ import annotations

import torch

from cooperativeimagecaptioning_tpu_torch.ops.kernels import _build, _dispatch


def cell_reference(xt, h, c, att_res, wi, bi, wh, bh, wc, bc):
    """att_res/wc/bc may be None (FC cell).  Computes in the inputs' dtype,
    like the JAX reference."""
    H = h.shape[-1]
    # grouping matches i2h(xt) + h2h(h), as in the JAX reference
    sums = (xt @ wi + bi) + (h @ wh + bh)
    sig = torch.sigmoid(sums[:, :3 * H])
    in_gate, forget_gate, out_gate = (sig[:, :H], sig[:, H:2 * H],
                                      sig[:, 2 * H:3 * H])
    it = sums[:, 3 * H:5 * H]
    if att_res is not None:
        it = it + att_res @ wc + bc
    g = torch.maximum(it[:, :H], it[:, H:2 * H])
    c_new = forget_gate * c + in_gate * g
    h_new = out_gate * torch.tanh(c_new)
    return h_new, c_new


def cell_plain(xt, h, c, att_res, wi, bi, wh, bh, wc, bc):
    """The kernel's plain version: `cell_reference` in float32 (float64 for
    float64 inputs), h' and c' in h's dtype -- the Pallas kernel's contract
    (f32 accumulation, outputs in h's dtype, cell_step.py:68-69)."""
    f = torch.promote_types(h.dtype, torch.float32)
    args = [None if x is None else x.to(f)
            for x in (xt, h, c, att_res, wi, bi, wh, bh, wc, bc)]
    h_new, c_new = cell_reference(*args)
    return h_new.to(h.dtype), c_new.to(h.dtype)


class Cell(torch.autograd.Function):
    """fused_cell with a gradient.  `forward_impl` computes the forward (the
    kernel, or in the tests its plain version); the backward differentiates
    `cell_reference`."""

    @staticmethod
    def forward(ctx, forward_impl, *args):
        ctx.save_for_backward(*args)
        return forward_impl(*args)

    @staticmethod
    def backward(ctx, g_h, g_c):
        return (None, *_dispatch.reference_vjp(
            cell_reference, ctx.saved_tensors, (), ctx.needs_input_grad[1:],
            (g_h, g_c)))


def fused_cell(xt, h, c, att_res, wi, bi, wh, bh, wc, bc):
    """xt [B,D], h/c [B,H], att_res [B,H] or None, wi [D,5H], bi [5H],
    wh [H,5H], bh [5H], wc [H,2H] or None, bc [2H] or None -> (h', c')."""
    args = (xt, h, c, att_res, wi, bi, wh, bh, wc, bc)
    if not _dispatch.use_kernel(h):
        return cell_reference(*args)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in args):
        return Cell.apply(cell_kernel, *args)
    return cell_kernel(*args)


# the C entry's first_pass codes (csrc/cell_step.cuh: kCellFma, kCellTf32,
# kCellWgmma)
PASS_CODES = {"fma": 0, "tf32x3": 2, "wgmma": 3}
# B from which a block of the split-TF32 kernel owns 16 hidden columns j
# (`tf32x3_cols`)
TF32_WIDE_ROWS = 512
# the wgmma kernel's tile (csrc/cell_wgmma.cu): j a block, and rows a block
# while one wave of the card's SMs holds the grid, else twice as many
WGMMA_COLS = 32
WGMMA_ROWS = 64
SMS = 132  # the H100's streaming multiprocessors


def cell_pass(dtype, D: int, H: int, aligned: bool = True) -> str:
    """Which kernel of csrc/ a launch takes.  With D and H multiples of 8
    and 16-byte aligned tensors (the 16-byte rows and tiles of the
    tensor-core kernels, and TMA's row strides, need all three): "tf32x3"
    (split TF32 on mma.sync, cell_step.cu) for float32, "wgmma" (wgmma fed
    by TMA, cell_wgmma.cu) for bfloat16, whatever B (rows past B arrive as
    zeros); "fma" (true f32 FMAs) for every other shape."""
    if aligned and D % 8 == 0 and H % 8 == 0:
        if dtype == torch.float32:
            return "tf32x3"
        if dtype == torch.bfloat16:
            return "wgmma"
    return "fma"


def tf32x3_cols(B: int) -> int:
    """Hidden columns j a block of the split-TF32 kernel owns: 8 below
    TF32_WIDE_ROWS rows (the training shape B=128 then fills the card with
    256 blocks), else 16 (the rows are read half as often from L2)."""
    return 8 if B < TF32_WIDE_ROWS else 16


def wgmma_tile(B: int, H: int) -> tuple:
    """(rows, hidden columns j) a block of the wgmma kernel owns: 64 rows
    while the grid of 64 x 32 tiles fits one wave of the card's SMs (B <=
    512 at H = 512: more, smaller blocks read from L2 in parallel), else
    128 rows, which read the weights half as often (PERF.md, PR 19)."""
    blocks = -(-B // WGMMA_ROWS) * -(-H // WGMMA_COLS)
    rows = WGMMA_ROWS if blocks <= SMS else 2 * WGMMA_ROWS
    return rows, WGMMA_COLS


def cell_kernel(xt, h, c, att_res, wi, bi, wh, bh, wc, bc):
    """Launch csrc/cell_step.cu on CUDA tensors (no autograd)."""
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"cell kernel takes float32 or bfloat16, got "
                        f"{h.dtype}")
    args = (xt, h, c, att_res, wi, bi, wh, bh, wc, bc)
    use_att = att_res is not None
    if use_att != (wc is not None) or use_att != (bc is not None):
        raise ValueError("cell: att_res, wc and bc are given together or "
                         "not at all")
    B, H = h.shape
    D = xt.shape[-1]
    shapes = {"xt": (xt, (B, D)), "c": (c, (B, H)),
              "wi": (wi, (D, 5 * H)), "bi": (bi, (5 * H,)),
              "wh": (wh, (H, 5 * H)), "bh": (bh, (5 * H,))}
    if use_att:
        shapes.update({"att_res": (att_res, (B, H)), "wc": (wc, (H, 2 * H)),
                       "bc": (bc, (2 * H,))})
    for key, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"cell: {key} is {tuple(t.shape)}, expected "
                             f"{want} for h {tuple(h.shape)}")
    _dispatch.check_cuda_inputs(
        "cell", {"h": h, **{k: t for k, (t, _) in shapes.items()}}, h.dtype)
    h_new = torch.empty_like(h)
    c_new = torch.empty_like(h)
    tensors = [t for t in args if t is not None] + [h_new, c_new]
    which = cell_pass(h.dtype, D, H,
                      all(t.data_ptr() % 16 == 0 for t in tensors))
    rows, cols = (wgmma_tile(B, H) if which == "wgmma"
                  else (0, tf32x3_cols(B)))
    lib = _build.library()
    code = lib.cic_cell(
        *(_build.ptr(t) for t in args), _build.ptr(h_new), _build.ptr(c_new),
        B, D, H, int(h.dtype == torch.bfloat16), PASS_CODES[which], cols,
        rows, _build.stream(h.device))
    _build.check(lib, code, "cell")
    _dispatch.count("cell", which)
    return h_new, c_new
