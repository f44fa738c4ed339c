"""Kernel F's split-TF32 pass (csrc/cell_step.cu, cell_tf32x3_kernel),
held on the CPU by an emulation of its arithmetic and its decomposition.

The CUDA kernel cannot run here, but what decides its result can be
replayed: the split of each f32 operand into two TF32 parts (hi = x rounded
to TF32 to nearest, ties away from zero; lo = x - hi, exact in f32, rounded
the same way), the three products of each of a warp's k8 steps of a
stage in the kernel's order (lo_a hi_w, then hi_a lo_w, onto the warp's
f32 accumulator of the small products; hi_a hi_w from zero over the
warp's k8 steps of the stage, then added to its main accumulator; the
8-term sum inside a product in float64), the small accumulator added to
the main one after the last stage, the four depth slices summed in slice
order, then the biases (bi + bh, + bc on gates 3 and 4) and the gate
epilogue, in f32.  The three products (xt Wi, h Wh, att Wc on gates 3 and
4) run as one sequence of 128-deep stages (kTf32Depth), each zero-padded;
each of a block's kTf32Slices = 4 warps takes 32 k of a stage, four k8
steps.

At reference width (D = H = 512; B = 128, the training step, and 130, a
partial row tile), with attention (Att2in2) and without (FC), the
emulation is held to the JAX package's `cell_reference` on the same
numpy-seeded f32 inputs within 1e-5 (f32 summation-order noise over 1536
terms is ~1e-6; one TF32 product alone is off by ~1e-3, which the test
also shows).

Also here: the block's ownership of rows, j and gates (the warps'
accumulators, the staged weight columns, the shared-memory sums the
epilogue reads), the grid's block counts and the routing table
(`cell_pass`).
"""

import numpy as np
import pytest
import torch

from cooperativeimagecaptioning_tpu_torch.ops.kernels import cell_step

TOL = 1e-5
SMS = 132
# csrc/cell_step.cu: kTf32Rows, kTf32Depth, kTf32Slices, kGates, and the
# k8 steps a warp
ROWS, DEPTH, SLICES, GATES = 32, 128, 4, 5
K8 = DEPTH // (8 * SLICES)


@pytest.fixture(scope="module")
def jref():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from cooperativeimagecaptioning_tpu.ops.pallas import cell_step as jc

    def run(args):
        out = jc.cell_reference(*[None if a is None else jnp.asarray(a)
                                  for a in args])
        return [np.asarray(o) for o in out]
    return run


def tf32_rna(x):
    """cvt.rna.tf32.f32: x rounded to 10 explicit mantissa bits, to
    nearest, ties away from zero, as an f32 whose low 13 bits are zero."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    sign = bits & np.uint32(0x80000000)
    mag = (bits & np.uint32(0x7FFFFFFF)) + np.uint32(0x1000)
    return (sign | (mag & np.uint32(0xFFFFE000))).view(np.float32)


def split_tf32(x):
    hi = tf32_rna(x)
    return hi, tf32_rna((x - hi).astype(np.float32))


def stages(xt, h, att, wi, wh, wc):
    """The kernel's step sequence: (rows [B, DEPTH], weights [DEPTH, 5H])
    of each stage of xt Wi, h Wh, then att Wc on gates 3 and 4 (zero
    columns for gates 0-2, which the kernel skips: adding exact zeros
    changes no sum)."""
    H = h.shape[1]
    prods = [(xt, wi), (h, wh)]
    if att is not None:
        w = np.zeros((H, 5 * H), np.float32)
        w[:, 3 * H:] = wc
        prods.append((att, w))
    for x, w in prods:
        K = x.shape[1]
        pad = -K % DEPTH
        x = np.pad(x, ((0, 0), (0, pad)))
        w = np.pad(w, ((0, pad), (0, 0)))
        for k0 in range(0, K + pad, DEPTH):
            yield x[:, k0:k0 + DEPTH], w[k0:k0 + DEPTH]


def sigmoid(x):
    return (np.float32(1) / (np.float32(1) + np.exp(-x))).astype(np.float32)


def cell_tf32x3(xt, h, c, att, wi, bi, wh, bh, wc, bc, split=True):
    """The kernel's h', c' (split=False: one TF32 product, hi_a hi_w)."""
    f32, f64 = np.float32, np.float64
    B, H = h.shape
    acc = np.zeros((SLICES, B, 5 * H), f32)
    small = np.zeros_like(acc)
    for a_st, w_st in stages(xt, h, att, wi, wh, wc):
        # warp w's depth slice of the stage: K8 k8 steps
        a = a_st.reshape(B, SLICES, K8, 8).transpose(1, 2, 0, 3)
        w = w_st.reshape(SLICES, K8, 8, 5 * H)
        big = None
        for k8 in range(K8):
            a_hi, a_lo = split_tf32(a[:, k8])
            w_hi, w_lo = split_tf32(w[:, k8])
            if split:
                small = (small + np.matmul(a_lo.astype(f64), w_hi)).astype(f32)
                small = (small + np.matmul(a_hi.astype(f64), w_lo)).astype(f32)
            p = np.matmul(a_hi.astype(f64), w_hi.astype(f64))
            big = p.astype(f32) if big is None else (big + p).astype(f32)
        acc = (acc + big).astype(f32)
    total = (acc + small).astype(f32)
    v = np.zeros((B, 5 * H), f32)
    for sl in range(SLICES):
        v = (v + total[sl]).astype(f32)
    bias = (bi + bh).astype(f32)
    if bc is not None:
        bias[3 * H:] = (bias[3 * H:] + bc).astype(f32)
    x = (bias + v).astype(f32)
    i, f, o = (sigmoid(x[:, g * H:(g + 1) * H]) for g in range(3))
    g = np.maximum(x[:, 3 * H:4 * H], x[:, 4 * H:])
    c_new = (f * c + i * g).astype(f32)
    return (o * np.tanh(c_new)).astype(f32), c_new


def cell_case(B, D, H, with_att, seed=0):
    """chip_smoke.cell_args' scales, from a numpy seed."""
    rng = np.random.RandomState(seed)

    def r(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)
    return [r(B, D), r(B, H, scale=0.5), r(B, H),
            r(B, H) if with_att else None,
            r(D, 5 * H, scale=D ** -0.5), r(5 * H, scale=0.1),
            r(H, 5 * H, scale=H ** -0.5), r(5 * H, scale=0.1),
            r(H, 2 * H, scale=H ** -0.5) if with_att else None,
            r(2 * H, scale=0.1) if with_att else None]


@pytest.mark.parametrize("with_att", [True, False])
@pytest.mark.parametrize("B", [128, 130])
def test_emulated_pass_matches_jax_cell_reference(jref, B, with_att):
    args = cell_case(B, 512, 512, with_att, seed=B)
    want = jref(args)
    got = cell_tf32x3(*args)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, 512) and np.isfinite(g).all()
        err = np.abs(g.astype(np.float64) - w).max()
        assert err <= TOL, err


def test_one_tf32_product_is_not_enough(jref):
    """The split is what holds the pass to 1e-5: hi_a hi_w alone misses."""
    args = cell_case(128, 512, 512, True, seed=7)
    want = jref(args)
    got = cell_tf32x3(*args, split=False)
    assert max(np.abs(g - w).max() for g, w in zip(got, want)) >= 1e-4


# --- the decomposition ----------------------------------------------------

def grid(B, H):
    """launch_tf32x3's grid: (blocks along j, blocks along the rows)."""
    cols = cell_step.tf32x3_cols(B)
    return -(-H // cols), -(-B // ROWS)


def blocks(B, H):
    gx, gy = grid(B, H)
    return cell_step.tf32x3_cols(B), [(bx, by) for by in range(gy)
                                      for bx in range(gx)]


@pytest.mark.parametrize("B,H", [(128, 512), (130, 512), (512, 512),
                                 (4096, 64), (33, 40), (600, 24)])
def test_every_row_and_column_is_owned_once(B, H):
    """The epilogue: thread tid of block (bx, by) finishes (row, j) pairs
    o = tid, tid + threads, ... of its 32 rows x cols j; every (row < B,
    j < H) once, each with all five gates of its block."""
    cols, launched = blocks(B, H)
    threads = 32 * SLICES * cols // 8
    owned = np.zeros((B, H), int)
    for bx, by in launched:
        for tid in range(threads):
            for o in range(tid, ROWS * cols, threads):
                row, j = by * ROWS + o // cols, bx * cols + o % cols
                if row < B and j < H:
                    owned[row, j] += 1
    assert (owned == 1).all()


@pytest.mark.parametrize("cols", [8, 16])
def test_warp_tiles_partition_the_block(cols):
    """Each depth slice's warps hold every (row, gate, j) of the block in
    exactly one accumulator register: warp (slice, wj), lane l, acc[g][mt]
    [e] is row 16 mt + l / 4 + 8 (e / 2), gate g, j 8 wj + 2 (l % 4) +
    e % 2.  The weight stage holds gate g's j at column g * cols + j of a
    row; the sums meet in shared memory where the epilogue reads them."""
    wjs = cols // 8
    red_pitch = GATES * 8
    for sl in range(SLICES):
        seen = {}
        for wj in range(wjs):
            for lane in range(32):
                for g in range(GATES):
                    for mt in range(2):
                        for e in range(4):
                            row = 16 * mt + lane // 4 + 8 * (e // 2)
                            j = 8 * wj + 2 * (lane % 4) + e % 2
                            key = (row, g, j)
                            assert key not in seen
                            seen[key] = (wj, lane, g, mt, e)
                            # the weight fragment: k = lane % 4 (+4), the
                            # stage column of gate g's j
                            assert g * cols + 8 * wj + lane // 4 < \
                                GATES * cols
                            # written at (writer) and read at (epilogue)
                            r, jj = row, j
                            write = (((wj * SLICES + sl) * ROWS + r)
                                     * red_pitch + g * 8 + j % 8)
                            read = (((jj // 8) * SLICES * ROWS + r)
                                    * red_pitch + sl * ROWS * red_pitch
                                    + g * 8 + jj % 8)
                            assert write == read
        assert len(seen) == ROWS * GATES * cols


def test_staged_weight_columns_cover_each_gate_once():
    """A block stages, for gate g, the columns g H + j0 .. j0 + cols of each
    Wi / Wh row (gates 3 and 4 of Wc at (g - 3) H + j0 ..): over a row of
    blocks every column of the five gates once."""
    for B, H in ((128, 512), (512, 512), (4096, 40)):
        cols, launched = blocks(B, H)
        for g0, n in ((0, 5), (3, 2)):
            hit = np.zeros(n * H, int)
            for bx, by in launched:
                if by:
                    continue
                for g in range(g0, GATES):
                    for c in range(cols):
                        if bx * cols + c < H:
                            hit[(g - g0) * H + bx * cols + c] += 1
            assert (hit == 1).all()


@pytest.mark.parametrize("B,want", [(128, (64, 4)), (512, (32, 16)),
                                    (4096, (32, 128))])
def test_grid_fills_the_card(B, want):
    """At B=128 (the training step) the grid is at least one wave of the
    card's 132 SMs; the larger buckets take 16 j a block."""
    got = grid(B, 512)
    assert got == want
    assert got[0] * got[1] >= SMS
    assert cell_step.tf32x3_cols(B) == (
        8 if B < cell_step.TF32_WIDE_ROWS else 16)


@pytest.mark.parametrize("dtype,D,H,aligned,want", [
    (torch.float32, 512, 512, True, "tf32x3"),
    (torch.float32, 24, 40, True, "tf32x3"),
    (torch.bfloat16, 512, 512, True, "wgmma"),
    (torch.float32, 512, 512, False, "fma"),
    (torch.bfloat16, 512, 512, False, "fma"),
    (torch.float32, 500, 512, True, "fma"),
    (torch.float32, 512, 500, True, "fma"),
    (torch.bfloat16, 20, 44, True, "fma"),
    (torch.float64, 512, 512, True, "fma"),
])
def test_cell_pass_routes(dtype, D, H, aligned, want):
    assert cell_step.cell_pass(dtype, D, H, aligned) == want
    assert cell_step.PASS_CODES[want] in (0, 2, 3)
