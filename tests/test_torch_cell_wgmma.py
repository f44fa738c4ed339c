"""Kernel F's bf16 pass (csrc/cell_wgmma.cu, cell_wgmma_kernel), held on the
CPU by an emulation of its arithmetic and its decomposition.

The CUDA kernel cannot run here, but what decides its result can be
replayed: bf16 operands (exact in f32), the three products (xt Wi, h Wh,
then att Wc on gates 3 and 4) as one sequence of 64-deep ring stages, each
zero-padded; in each stage four 16-deep wgmma slices a gate into that
gate's f32 stage partial (from zero; the 16-term sum inside a slice in
float64), the partial then added to the gate's f32 total; then the biases
(bi + bh, + bc on gates 3 and 4, in f32), the gate epilogue in f32, and h',
c' rounded to bf16.

At small width (D = H = 64; B = 64 and 130, a partial row tile), with
attention (Att2in2) and without (FC), the emulation is held before its
output cast to the JAX package's `cell_reference` in f32 on the same
bf16-exact inputs (relative 1e-5: summation order only), and after it to
the JAX package's Pallas kernel `_cell_pallas` in interpret mode on the
bf16 inputs (1e-2 absolute: both round an f32 result to bf16).

Also here: the tile plan (every (row, j, gate) owned by exactly one
accumulator register of one thread), the ring's fit in a block's shared
memory (constants read from the C sources), the routing (`cell_pass`,
`wgmma_tile`, the pass codes against the C source's), and on a card the
kernel against `cell_plain`.
"""

import re

import numpy as np
import pytest
import torch

from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
    _build, _dispatch, cell_step)

GATES = 5
DEPTH = 64     # kWgmmaDepth: k a ring stage
SLICE = 16     # k of one wgmma
ROWS_WG = 64   # rows a consumer warpgroup
BLOCK_SMEM = 232448
REL = 1e-5
BF16_TOL = 1e-2


@pytest.fixture(scope="module")
def jax_cell():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from cooperativeimagecaptioning_tpu.ops.pallas import cell_step as jc

    def as_jax(args, dtype):
        return [None if a is None else jnp.asarray(a, dtype) for a in args]

    def reference(args):
        out = jc.cell_reference(*as_jax(args, jnp.float32))
        return [np.asarray(o, np.float64) for o in out]

    def pallas(args):
        out = jc._cell_pallas(*as_jax(args, jnp.bfloat16),
                              use_att=args[3] is not None, interpret=True)
        return [np.asarray(o.astype(jnp.float32), np.float64) for o in out]
    return reference, pallas


def bf16(x):
    """x rounded to bf16 (to nearest even), as f32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def cell_case(B, D, H, with_att, seed=0):
    """chip_smoke.cell_args' scales, from a numpy seed, rounded to bf16."""
    rng = np.random.RandomState(seed)

    def r(*shape, scale=1.0):
        return bf16(rng.randn(*shape) * scale)
    return [r(B, D), r(B, H, scale=0.5), r(B, H),
            r(B, H) if with_att else None,
            r(D, 5 * H, scale=D ** -0.5), r(5 * H, scale=0.1),
            r(H, 5 * H, scale=H ** -0.5), r(5 * H, scale=0.1),
            r(H, 2 * H, scale=H ** -0.5) if with_att else None,
            r(2 * H, scale=0.1) if with_att else None]


def stages(xt, h, att, wi, wh, wc):
    """The ring's steps: (first gate, rows [B, DEPTH], weights [DEPTH, n H])
    of xt Wi, h Wh, then att Wc (gates 3 and 4), zero-padded to whole
    steps as TMA's out-of-bounds fill pads them."""
    prods = [(0, xt, wi), (0, h, wh)]
    if att is not None:
        prods.append((3, att, wc))
    for g0, x, w in prods:
        pad = -x.shape[1] % DEPTH
        x = np.pad(x, ((0, 0), (0, pad)))
        w = np.pad(w, ((0, pad), (0, 0)))
        for k0 in range(0, x.shape[1], DEPTH):
            yield g0, x[:, k0:k0 + DEPTH], w[k0:k0 + DEPTH]


def sigmoid(x):
    return (np.float32(1) / (np.float32(1) + np.exp(-x))).astype(np.float32)


def cell_wgmma(xt, h, c, att, wi, bi, wh, bh, wc, bc):
    """The kernel's h', c' in f32, before the cast to bf16."""
    f32, f64 = np.float32, np.float64
    B, H = h.shape
    acc = np.zeros((GATES, B, H), f32)
    for g0, a_st, w_st in stages(xt, h, att, wi, wh, wc):
        part = np.zeros((GATES, B, H), f32)
        for kk in range(0, DEPTH, SLICE):
            a = a_st[:, kk:kk + SLICE].astype(f64)
            for g in range(g0, GATES):
                w = w_st[kk:kk + SLICE, (g - g0) * H:(g - g0 + 1) * H]
                part[g] = (part[g] + a @ w.astype(f64)).astype(f32)
        acc[g0:] = (acc[g0:] + part[g0:]).astype(f32)
    bias = (bi + bh).astype(f32).reshape(GATES, H)
    if bc is not None:
        bias[3:] = (bias[3:] + bc.reshape(2, H)).astype(f32)
    x = (acc + bias[:, None, :]).astype(f32)
    i, f, o = sigmoid(x[0]), sigmoid(x[1]), sigmoid(x[2])
    c_new = (f * c + i * np.maximum(x[3], x[4])).astype(f32)
    return (o * np.tanh(c_new)).astype(f32), c_new


@pytest.mark.parametrize("with_att", [True, False])
@pytest.mark.parametrize("B", [64, 130])
def test_emulated_pass_matches_jax(jax_cell, B, with_att):
    reference, pallas = jax_cell
    args = cell_case(B, 64, 64, with_att, seed=B + with_att)
    got = cell_wgmma(*args)
    for g, w in zip(got, reference(args)):
        assert g.shape == w.shape == (B, 64) and np.isfinite(g).all()
        assert np.abs(g - w).max() <= REL * np.abs(w).max()
    for g, w in zip(got, pallas(args)):
        err = np.abs(bf16(g).astype(np.float64) - w).max()
        assert err <= BF16_TOL, err


def test_attention_product_feeds_gates_3_and_4_only(jax_cell):
    """The attention steps touch two of the five accumulator sets: with a
    zero Wc and bc the Att2in2 pass is the FC pass."""
    args = cell_case(64, 64, 64, True, seed=3)
    args[8] = np.zeros_like(args[8])
    args[9] = np.zeros_like(args[9])
    fc = cell_wgmma(*args[:3], None, *args[4:8], None, None)
    for g, w in zip(cell_wgmma(*args), fc):
        np.testing.assert_array_equal(g, w)


# --- the tile plan --------------------------------------------------------

def tile_plan(B, H):
    """(row, j) of every accumulator register of every consumer thread of
    the grid, for one gate (every gate's set has the same layout): block
    (bx, by), warpgroup wg, warp w, lane l, register 4 i + 2 hf + e holds
    row by R + 64 wg + 16 w + l / 4 + 8 hf, column j = bx J + 8 i +
    2 (l % 4) + e."""
    R, J = cell_step.wgmma_tile(B, H)
    gx, gy = -(-H // J), -(-B // R)
    bx, by, wg, w, lane, i, hf, e = np.meshgrid(
        np.arange(gx), np.arange(gy), np.arange(R // ROWS_WG), np.arange(4),
        np.arange(32), np.arange(J // 8), np.arange(2), np.arange(2),
        indexing="ij", sparse=True)
    rows = by * R + ROWS_WG * wg + 16 * w + lane // 4 + 8 * hf
    js = bx * J + 8 * i + 2 * (lane % 4) + e
    rows, js = np.broadcast_arrays(rows, js)
    return rows.ravel(), js.ravel()


@pytest.mark.parametrize("B", [128, 130, 512, 1024, 4096])
def test_every_row_column_and_gate_is_owned_once(B):
    H = 512
    rows, js = tile_plan(B, H)
    keep = (rows < B) & (js < H)
    owned = np.bincount(rows[keep] * H + js[keep], minlength=B * H)
    # one register a (row, j) in each of the five gates' sets
    assert owned.shape == (B * H,) and (owned == 1).all()
    # the registers past B or H are the tile's ragged edge only
    R, J = cell_step.wgmma_tile(B, H)
    assert rows.size == -(-B // R) * R * -(-H // J) * J


@pytest.mark.parametrize("B,H,want", [
    (1, 512, (64, 32)), (130, 512, (64, 32)), (512, 512, (64, 32)),
    (513, 512, (128, 32)), (1024, 512, (128, 32)), (4096, 512, (128, 32)),
    (1024, 256, (64, 32)), (1025, 256, (128, 32))])
def test_tile_takes_64_rows_while_one_wave_holds_the_grid(B, H, want):
    """64-row blocks while ceil(B / 64) x ceil(H / 32) <= 132, the card's
    SMs; 128 rows from there."""
    assert cell_step.wgmma_tile(B, H) == want


# --- the C sources --------------------------------------------------------

def constants(*names):
    """constexpr ints of the given C sources, evaluated in order."""
    out = {}
    for name in names:
        for key, expr in re.findall(r"constexpr int (\w+) =\s*([^;]+);",
                                    (_build.CSRC / name).read_text()):
            expr = re.sub(r"cic::", "", expr)
            try:
                out[key] = eval(expr, {}, dict(out))  # noqa: S307 (own source)
            except (NameError, SyntaxError):
                pass
    return out


def test_ring_fits_the_shared_memory_of_a_block():
    """Both tiles: the ring (the rows' tile and five gates' tiles a stage,
    at most kWgmmaMaxStages stages), 1024 bytes to align the ring and two
    mbarriers a stage fit the 227 KB a block may ask for, with at least
    three stages; every tile starts on its swizzle pattern's boundary (the
    rows' 128-byte swizzle: 1024-byte atoms; a gate's 64-byte swizzle, 32 j
    of 2 bytes: 512-byte atoms); two consumer warpgroups' registers and the
    producer's, after setmaxnreg, fit an SM's 65536."""
    k = constants("cell_step.cuh", "cell_wgmma.cu")
    assert (k["kCellGates"], k["kWgmmaDepth"], k["kWgmmaRowsWg"],
            k["kWgmmaCols"], k["kBlockSmem"]) == (
        GATES, DEPTH, ROWS_WG, cell_step.WGMMA_COLS, BLOCK_SMEM)
    assert k["kWgmmaRowsWg"] == cell_step.WGMMA_ROWS
    cols = k["kWgmmaCols"]
    for rows in {cell_step.wgmma_tile(B, 512)[0] for B in (1, 4096)}:
        a_bytes = rows * DEPTH * 2
        w_bytes = DEPTH * cols * 2
        stage = a_bytes + GATES * w_bytes
        n = min(k["kWgmmaMaxStages"], (BLOCK_SMEM - 1024) // (stage + 16))
        assert n >= 3
        assert 1024 + n * stage + 16 * n <= BLOCK_SMEM
        assert a_bytes % 1024 == 0 and stage % 1024 == 0
        assert cols * 2 == 64 and w_bytes % 512 == 0
    assert 2 * 128 * k["kConsumerRegs"] + 128 * k["kProducerRegs"] <= 65536
    assert k["kConsumerRegs"] % 8 == k["kProducerRegs"] % 8 == 0


def test_pass_codes_match_the_c_source():
    k = constants("cell_step.cuh")
    assert cell_step.PASS_CODES == {
        "fma": k["kCellFma"], "tf32x3": k["kCellTf32"],
        "wgmma": k["kCellWgmma"]}


@pytest.mark.parametrize("dtype,D,H,aligned,want", [
    (torch.bfloat16, 512, 512, True, "wgmma"),
    (torch.bfloat16, 24, 40, True, "wgmma"),
    (torch.bfloat16, 512, 512, False, "fma"),
    (torch.bfloat16, 500, 512, True, "fma"),
    (torch.bfloat16, 512, 500, True, "fma"),
    (torch.float32, 512, 512, True, "tf32x3"),
    (torch.float32, 512, 512, False, "fma"),
])
def test_cell_pass_routes_bf16_to_wgmma(dtype, D, H, aligned, want):
    assert cell_step.cell_pass(dtype, D, H, aligned) == want
    assert f"cell_{want}" in _dispatch.CELL_PASSES


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    _dispatch.reset_launches()
    yield torch.device("cuda")
    _dispatch.reset_launches()


@pytest.mark.cuda
@pytest.mark.parametrize("with_att", [True, False])
@pytest.mark.parametrize("B", [1, 130, 512, 4096])
def test_wgmma_kernel_matches_plain(cuda, B, with_att):
    """bf16 at D = H = 512 against cell_plain (cell_reference in f32 on the
    same inputs, h' and c' rounded to bf16): within 3e-2, chip_smoke's bf16
    tolerance (1-2 bf16 ulps at |x| < 4); every launch on cell_wgmma."""
    args = [None if x is None else torch.from_numpy(x).to(cuda, torch.bfloat16)
            for x in cell_case(B, 512, 512, with_att, seed=B)]
    h_new, c_new = cell_step.fused_cell(*args)
    torch.cuda.synchronize()
    assert _dispatch.cell_pass_launches() == {
        k: int(k == "cell_wgmma") for k in _dispatch.CELL_PASSES}
    for got, want in zip((h_new, c_new), cell_step.cell_plain(*args)):
        assert got.dtype == torch.bfloat16 and got.shape == (B, 512)
        assert (got.float() - want.float()).abs().max().item() <= 3e-2
