"""The vocabulary heads' split-TF32 first pass (csrc/vocab_head_tf32.cuh),
held on the CPU by an emulation of its arithmetic and its decomposition.

The CUDA kernel cannot run here, but what decides its result can be
replayed: the split of each f32 operand into two TF32 parts (hi = x rounded
to TF32 to nearest, ties away from zero; lo = x - hi, which is exact in
f32, rounded the same way), the three TF32 products of each k8 step in the
kernel's order (lo_h hi_w, then hi_h lo_w, onto an f32 accumulator of the
small products; hi_h hi_w from zero, added to the main one; the 8-term sum
inside a product in float64), the small accumulator added to the main one
after the last k step, then the bias, in f32; which block owns which rows
and which vocab split (`mma_split` at 72-column tiles), which lane of a
warp's m16n8 accumulators owns which (row, column), the per-lane streaming
log-sum-exp and top-KK list carried over a split's tiles, the merge of a
quad's four lanes and the merge of the splits (one warp a row) -- in
the order of `cic::before` (larger logit first, the lower id on an exact
tie).

Two parts do not make x again: hi has 11 significant bits and so has lo,
while x - hi can have 13, so |x - (hi + lo)| is up to half a TF32 ulp of
lo, 2^-22 |x|.  With the dropped lo_h lo_w term that is the ~2^-22 of each
product the pass gives up against f32.

At reference width (H = 512, V + 1 = 9488; greedy R = 128, beam kk = 2 at
R = 256, kk = 32 in two rounds, the vocab slices of a model axis of 2)
with ties planted as `chip_smoke.plant_ties` plants them, the emulation is
held to `greedy_head_reference` / `beam_head_reference` and to the JAX
references: ids equal, except where the reference logits of the two ids
are within 1e-5 of each other (a near-tie the split product's rounding may
flip; planted ties are exact and must match), values and log-sum-exp within
1e-5.

Also here: the pass's grid (`mma_split` at 72-column tiles), its coverage
of the vocab and its fill of the card's 132 SMs.  The routing table
(`head_pass`) and the per-pass counts are in tests/test_torch_heads_tma.py.
"""

import functools

import numpy as np
import pytest
import torch

import chip_smoke
from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
    beam_head, logit_head)

TOL = dict(atol=1e-5, rtol=1e-5)
NEAR_TIE = 1e-5
ROWS, COLS = logit_head.MMA_ROW_TILE, logit_head.TF32_COL_TILE
NEG = np.float32(-np.inf)
NO_ID = np.iinfo(np.int32).max
SMS = 132
H_REF, V_REF = 512, 9488


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from cooperativeimagecaptioning_tpu.ops.pallas import beam_head as jb
    from cooperativeimagecaptioning_tpu.ops.pallas import logit_head as jl
    return dict(jnp=jnp, beam=jb, logit=jl)


# --- the arithmetic -------------------------------------------------------

def tf32_rna(x):
    """cvt.rna.tf32.f32: x rounded to 10 explicit mantissa bits, to
    nearest, ties away from zero (on the magnitude), as an f32 whose low 13
    bits are zero."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    sign = bits & np.uint32(0x80000000)
    mag = (bits & np.uint32(0x7FFFFFFF)) + np.uint32(0x1000)
    return (sign | (mag & np.uint32(0xFFFFE000))).view(np.float32)


def split_tf32(x):
    hi = tf32_rna(x)
    lo = tf32_rna((x - hi).astype(np.float32))
    return hi, lo


def logits_tf32x3(h, w, b):
    """The pass's logits: per k8 step the two small TF32 products onto the
    f32 accumulator of the small products, and the big one, from zero,
    added to the main one; after the last step the small accumulator onto
    the main one, then the bias."""
    h_hi, h_lo = split_tf32(h)
    w_hi, w_lo = split_tf32(w)
    f32, f64 = np.float32, np.float64

    def product(a, bb, s):
        return a[:, s].astype(f64) @ bb[s].astype(f64)
    acc = np.zeros((h.shape[0], w.shape[1]), f32)
    small = np.zeros_like(acc)
    for k in range(0, h.shape[1], 8):
        s = slice(k, k + 8)
        small = (small + product(h_lo, w_hi, s)).astype(f32)
        small = (small + product(h_hi, w_lo, s)).astype(f32)
        acc = (acc + product(h_hi, w_hi, s).astype(f32)).astype(f32)
    return ((acc + small).astype(f32) + b.astype(f32)).astype(f32)


def special_values():
    """Seeded f32 values and the split's edge cases: exact TF32 values, the
    halfway points between two (ties away from zero), the largest residues,
    both signs, tiny and large magnitudes."""
    rng = np.random.RandomState(0)
    x = np.concatenate([
        rng.randn(4096).astype(np.float32),
        (rng.randn(1024) * 1e-30).astype(np.float32),
        (rng.randn(1024) * 1e30).astype(np.float32),
        np.float32([1.0, -1.0, 0.0, 2.0 ** -20, 1 + 2.0 ** -11,
                    -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11, 1 + 2.0 ** -12,
                    1 + 2.0 ** -12 + 2.0 ** -23, 2 - 2.0 ** -23,
                    1 + 2.0 ** -10 - 2.0 ** -23])])
    return x.astype(np.float32)


def test_rna_split_of_each_operand():
    x = special_values()
    hi, lo = split_tf32(x)
    for part in (hi, lo):  # at most 11 significant bits: the low 13 zero
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    x64, hi64, lo64 = (a.astype(np.float64) for a in (x, hi, lo))
    # x - hi is exact in f32, and hi is the nearest TF32 value to x
    np.testing.assert_array_equal(
        (x - hi).astype(np.float64), x64 - hi64)
    assert (np.abs(x64 - hi64) <= 2.0 ** -11 * np.abs(x64)).all()
    assert (np.abs(lo64) <= 2.0 ** -11 * np.abs(x64)).all()
    # hi + lo is x to half a TF32 ulp of lo: 2^-22 |x|
    err = np.abs(x64 - (hi64 + lo64))
    assert (err <= 2.0 ** -11 * np.abs(lo64)).all()
    assert (err <= 2.0 ** -22 * np.abs(x64)).all()
    # ties go away from zero; TF32 values split into themselves and zero
    np.testing.assert_array_equal(
        tf32_rna(np.float32([1 + 2.0 ** -11, -(1 + 2.0 ** -11),
                             1 + 3 * 2.0 ** -11])),
        np.float32([1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1 + 2.0 ** -9]))
    exact = np.float32([1.0, -3.5, 2.0 ** -20, 1 + 2.0 ** -10])
    np.testing.assert_array_equal(split_tf32(exact)[0], exact)
    assert not split_tf32(exact)[1].any()


def test_split_products_stay_within_f32_summation_noise():
    """At reference width the three products give the f32 logits to ~1e-6
    (the dropped lo lo term and lo's rounding, ~2^-22 of each product),
    where one TF32 product is off by ~1e-3."""
    rng = np.random.RandomState(1)
    h = (rng.randn(16, H_REF) * 0.5).astype(np.float32)
    w = (rng.randn(H_REF, 600) * 0.1).astype(np.float32)
    b = (rng.randn(600) * 0.1).astype(np.float32)
    exact = h.astype(np.float64) @ w.astype(np.float64) + b
    err3 = np.abs(logits_tf32x3(h, w, b) - exact).max()
    err1 = np.abs(tf32_rna(h).astype(np.float64) @ tf32_rna(w) + b
                  - exact).max()
    assert err3 <= 4e-6 and err1 >= 1e-4, (err3, err1)


# --- the decomposition ----------------------------------------------------

def owner(row_in_tile, col_in_tile):
    """(warp, lane, half, accumulator register) that holds an element of a
    block's [128 x 72] tile: warp w's m16n8 accumulators of n8 tile j give
    lane l rows 16 w + l // 4 (+ 8) and columns 8 j + 2 (l % 4) + {0, 1}."""
    warp, r = divmod(row_in_tile, 16)
    half, g = divmod(r, 8)
    j, c = divmod(col_in_tile, 8)
    q, e = divmod(c, 2)
    return warp, 4 * g + q, half, 4 * j + 2 * half + e


def test_accumulator_ownership_partitions_the_tile():
    seen = set()
    for r in range(ROWS):
        quads = set()
        for c in range(COLS):
            warp, lane, half, reg = owner(r, c)
            assert (warp, lane, reg) not in seen
            seen.add((warp, lane, reg))
            assert 0 <= warp < 8 and 0 <= lane < 32 and 0 <= reg < COLS // 2
            assert (reg // 2) % 2 == half
            quads.add((warp, lane // 4))
        assert len(quads) == 1  # a row lives in one quad: no warp merge
    assert len(seen) == ROWS * COLS


def lse_merge(m, s, m2, s2):
    """cic::lse_merge over arrays of rows."""
    mx = np.maximum(m, m2)
    with np.errstate(invalid="ignore"):
        out = (s * np.exp(m - mx) + s2 * np.exp(m2 - mx)).astype(np.float32)
    empty = mx == NEG
    return np.where(empty, m, mx), np.where(empty, s, out)


def top_list(vals, ids, kk):
    """The first kk entries of each row's (vals, ids) in cic::before order,
    padded with (-inf, INT_MAX): what topk_push keeps, and what the
    pop-the-winner and topk_insert merges of sorted lists give."""
    R = vals.shape[0]
    pad = max(0, kk - vals.shape[1])
    vals = np.concatenate([vals, np.full((R, pad), NEG, np.float32)], 1)
    ids = np.concatenate([ids, np.full((R, pad), NO_ID, np.int64)], 1)
    order = np.lexsort((ids, -vals.astype(np.float64)), axis=-1)[:, :kk]
    v = np.take_along_axis(vals, order, 1)
    i = np.take_along_axis(ids, order, 1)
    return v, np.where(v == NEG, NO_ID, i)


def lane_columns(q, c_begin, c_end):
    """Quad lane q's columns of a split, tile by tile, those past the
    split's end masked."""
    tiles = []
    for n0 in range(c_begin, c_end, COLS):
        cols = [n0 + 8 * j + 2 * q + e for j in range(COLS // 8)
                for e in range(2)]
        tiles.append([c for c in cols if c < c_end])
    return tiles


def emulate_first_pass(logits, rows, kk_slots, c_begin, c_end, thr):
    """The (row, split) partials of `rows` as one block forms them: each
    quad lane folds its columns of every tile (one rescale of the
    log-sum-exp a tile; candidates after the row's threshold `thr` enter its
    list), then the quad's merge (log-sum-exp over xor 1, then xor 2)."""
    lanes = []
    for q in range(4):
        m = np.full(len(rows), NEG, np.float32)
        s = np.zeros(len(rows), np.float32)
        cand_v, cand_i = [], []
        for cols in lane_columns(q, c_begin, c_end):
            if not cols:
                continue
            x = logits[np.ix_(rows, cols)]
            mn = np.maximum(m, x.max(1))
            s = (s * np.exp(m - mn) + np.exp(x - mn[:, None]).sum(
                1, dtype=np.float32)).astype(np.float32)
            m = mn
            c = np.broadcast_to(np.asarray(cols, np.int64), x.shape)
            if thr is not None:  # only candidates after the threshold
                tv, ti = thr
                after = (tv[:, None] > x) | ((tv[:, None] == x)
                                             & (ti[:, None] < c))
                x = np.where(after, x, NEG)
            cand_v.append(x)
            cand_i.append(c)
        if cand_v:
            v, i = top_list(np.concatenate(cand_v, 1),
                            np.concatenate(cand_i, 1), kk_slots)
        else:
            v, i = top_list(np.zeros((len(rows), 0), np.float32),
                            np.zeros((len(rows), 0), np.int64), kk_slots)
        lanes.append((v, i, m, s))
    m01 = lse_merge(lanes[0][2], lanes[0][3], lanes[1][2], lanes[1][3])
    m23 = lse_merge(lanes[2][2], lanes[2][3], lanes[3][2], lanes[3][3])
    M, S = lse_merge(*m01, *m23)
    v, i = top_list(np.concatenate([ln[0] for ln in lanes], 1),
                    np.concatenate([ln[1] for ln in lanes], 1), kk_slots)
    return v, i, M, S


def emulate_head(logits, kk, sm_count=SMS):
    """Both passes on the pass's logits: the first over (row tile, split)
    with the grid `mma_split` gives, then the merge kernels' pass over the
    splits; a kk above the longest list in rounds of `beam_head.ROUND_KK`.
    Returns (vals [R,kk], ids [R,kk], lse [R])."""
    R, V = logits.shape
    slots = next((s for s in beam_head.SLOTS if s >= kk), beam_head.ROUND_KK)
    splits, split_cols = logit_head.mma_split(R, V, sm_count, COLS)
    vals = np.empty((R, kk), np.float32)
    ids = np.empty((R, kk), np.int64)
    lse = np.empty((R,), np.float32)
    for r0 in range(0, R, ROWS):
        rows = np.arange(r0, min(R, r0 + ROWS))
        thr = None
        for off in range(0, kk, slots):
            fv = np.full((len(rows), 0), NEG, np.float32)
            fi = np.full((len(rows), 0), NO_ID, np.int64)
            M = np.full(len(rows), NEG, np.float32)
            S = np.zeros(len(rows), np.float32)
            for sp in range(splits):
                pv, pi, pm, ps = emulate_first_pass(
                    logits, rows, slots, sp * split_cols,
                    min(V, (sp + 1) * split_cols), thr)
                M, S = lse_merge(M, S, pm, ps)
                fv, fi = top_list(np.concatenate([fv, pv], 1),
                                  np.concatenate([fi, pi], 1), slots)
            n = min(slots, kk - off)
            vals[rows, off:off + n] = fv[:, :n]
            ids[rows, off:off + n] = fi[:, :n]
            if off == 0:
                lse[rows] = M + np.log(S)
            thr = (fv[:, -1], fi[:, -1])
    return vals, ids, lse


@functools.lru_cache(maxsize=None)
def reference_case(R, V, kind, seed):
    """Seeded inputs at reference width (H = 512, a logit layer of 9488
    columns) with `chip_smoke`'s planted ties ("ties": [2, 3, 4, 130, 5000,
    9487] then [5, 4000]; "group": 24 tied ids across a round's seam) or
    none ("random"); V < 9488 keeps the first V columns, the slice of a
    model axis' rank 0, and the planted ids in it.  Returns (h, w, b, the
    planted ids in the order the top lists must start with, the pass's
    emulated logits)."""
    rng = np.random.RandomState(seed)
    h = (rng.randn(R, H_REF) * 0.5).astype(np.float32)
    w = (rng.randn(H_REF, V_REF) * 0.1).astype(np.float32)
    b = (rng.randn(V_REF) * 0.1).astype(np.float32)
    planted = []
    if kind == "ties":
        planted = chip_smoke.plant_ties(w, b)
    elif kind == "group":
        planted = chip_smoke.plant_tie_group(w, b)
    w, b = np.ascontiguousarray(w[:, :V]), b[:V].copy()
    planted = [c for c in planted if c < V]
    return h, w, b, planted, logits_tf32x3(h, w, b)


def assert_ids_agree(ids, want_ids, ref_logits):
    """ids equal, except at near-ties of the reference logits."""
    differ = ids != want_ids
    if differ.any():
        rows = np.nonzero(differ)[0]
        gap = np.abs(ref_logits[rows, ids[differ]]
                     - ref_logits[rows, want_ids[differ]])
        assert gap.max() <= NEAR_TIE, (differ.sum(), gap.max())


def against_references(jx, case, kk):
    h, w, b, planted, logits = case
    vals, ids, lse = emulate_head(logits, kk)
    n = min(kk, len(planted))
    if n:  # planted ties are exact: lower id first, in every row
        assert (ids[:, :n] == np.asarray(planted[:n])[None]).all()
    ref_logits = (h.astype(np.float64) @ w + b).astype(np.float32)
    jnp = jx["jnp"]
    wv, wi, wl = beam_head.beam_head_reference(
        *map(torch.from_numpy, (h, w, b)), kk)
    jv, ji, jl = jx["beam"].beam_head_reference(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), kk)
    for rv, ri, rl in ((wv, wi, wl), (jv, ji, jl)):
        ri = np.asarray(ri).astype(np.int64)
        assert_ids_agree(ids, ri, ref_logits)
        if n:
            np.testing.assert_array_equal(ids[:, :n], ri[:, :n])
        np.testing.assert_allclose(np.asarray(rv), vals, **TOL)
        np.testing.assert_allclose(np.asarray(rl), lse, **TOL)
    return vals, ids, lse


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_emulated_greedy_head_matches_the_references(jx, kind):
    """Greedy R = 128 (the SCST and joint baseline's rows), full vocab."""
    case = reference_case(128, V_REF, kind, 13)
    h, w, b, planted, logits = case
    vals, ids, lse = emulate_head(logits, 1)
    if planted:
        assert (ids[:, 0] == planted[0]).all()
    ref_logits = (h.astype(np.float64) @ w + b).astype(np.float32)
    it, lp = logit_head.greedy_head_reference(
        *map(torch.from_numpy, (h, w, b)))
    jnp = jx["jnp"]
    j_it, j_lp = jx["logit"].greedy_head_reference(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b))
    for w_it, w_lp in ((it.numpy(), lp.numpy()),
                       (np.asarray(j_it), np.asarray(j_lp))):
        assert_ids_agree(ids[:, 0], w_it.astype(np.int64), ref_logits)
        np.testing.assert_allclose(w_lp, vals[:, 0] - lse, **TOL)


@pytest.mark.parametrize("R,V,kk,kind", [
    (256, V_REF, 2, "ties"),          # the evaluation's beam-2 decode
    (256, V_REF, 2, "random"),
    (128, V_REF, 32, "group"),        # two rounds, 24 ties across the seam
    (256, V_REF // 2, 2, "ties"),     # G: a model axis of 2, beam 2
    (128, V_REF // 2, 1, "random"),   # H: its greedy decode
])
def test_emulated_beam_head_matches_the_references(jx, R, V, kk, kind):
    against_references(jx, reference_case(R, V, kind, R + kk), kk)


def test_emulated_ragged_tiles_and_rows():
    """A ragged second row tile, splits of three tiles, and a last split
    whose last tile is ragged and ends inside an n8 tile (V a multiple of
    4, not 8): with kk = V, in rounds, every column comes out exactly once
    and the lists equal the plain head's."""
    rng = np.random.RandomState(7)
    R, H, V = 131, 64, 300
    assert logit_head.mma_split(R, V, 4, COLS) == (2, 216)
    h = rng.randn(R, H).astype(np.float32)
    w = (rng.randn(H, V) * 0.2).astype(np.float32)
    b = (rng.randn(V) * 0.2).astype(np.float32)
    vals, ids, lse = emulate_head(logits_tf32x3(h, w, b), V, sm_count=4)
    np.testing.assert_array_equal(np.sort(ids, 1),
                                  np.broadcast_to(np.arange(V), (R, V)))
    wv, wi, wl = beam_head.beam_head_reference(
        *map(torch.from_numpy, (h, w, b)), V)
    ref_logits = (h.astype(np.float64) @ w + b).astype(np.float32)
    assert_ids_agree(ids, wi.numpy().astype(np.int64), ref_logits)
    np.testing.assert_allclose(wv.numpy(), vals, **TOL)
    np.testing.assert_allclose(wl.numpy(), lse, **TOL)


# --- the grid -------------------------------------------------------------

@pytest.mark.parametrize("V", [4, 8, 1300, 4744, 9488])
@pytest.mark.parametrize("rows", [1, 13, 128, 256, 512, 1024, 4096, 8192,
                                  20000])
def test_split_tf32_grid_covers_the_vocab(rows, V):
    splits, cols = logit_head.mma_split(rows, V, SMS, COLS)
    assert cols % COLS == 0 and splits >= 1
    # no split is empty and together they cover [0, V)
    assert (splits - 1) * cols < V <= splits * cols
    # one wave of blocks, unless the row tiles alone are more
    row_tiles = -(-rows // ROWS)
    assert row_tiles * splits <= max(SMS, row_tiles)


@pytest.mark.parametrize("rows,V,blocks,tiles", [
    (128, V_REF, 132, 1), (256, V_REF, 132, 2),
    (128, V_REF // 2, 66, 1), (256, V_REF // 2, 132, 1)])
def test_split_tf32_grid_fills_the_card_at_the_paths_row_counts(
        rows, V, blocks, tiles):
    """The path's small row counts are one or two row tiles: the vocab
    splits carry the grid.  At V=9488 (132 tiles of 72 columns) R=128 puts
    one tile on each of the 132 SMs and R=256 two; a model axis' slice of
    4744 columns (66 tiles) at R=256 one tile on each, and at R=128 one tile
    on 66 SMs -- whole tiles fill no more, and each block's time is still
    one tile's."""
    splits, cols = logit_head.mma_split(rows, V, SMS, COLS)
    assert -(-rows // ROWS) * splits == blocks
    assert cols == tiles * COLS
    # no SM takes more tiles than the whole tiles of the grid need
    units = -(-rows // ROWS) * -(-V // COLS)
    assert tiles == max(1, -(-units // SMS))
