"""The vocabulary heads' tensor-core first pass (csrc/vocab_head_mma.cuh),
held on the CPU by an emulation of its decomposition.

The CUDA kernel cannot run here, but everything that decides its result
beside the product itself can be replayed: which block owns which rows and
which vocab split, which lane of a warpgroup's m64n128 accumulator owns which
(row, column), the per-lane streaming log-sum-exp and top-KK list carried
over a split's column tiles, the merge of a quad's four lanes by
pop-the-winner rounds, and the merge of the splits -- all in the order of
`cic::before` (larger logit first, the lower id on an exact tie).  The
emulation must equal `greedy_head_reference` / `beam_head_reference` and the
JAX references on seeded inputs with exact ties planted at every level of
that merge: ids bit-equal, values within 1e-5 (f32 on both sides).

Also here: the split function of the new tiles, the routing function
(`head_pass`, the bf16, the f32 and the FMA passes), and the per-pass
launch counts.
"""

import numpy as np
import pytest
import torch

from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
    _dispatch, beam_head, logit_head)

TOL = dict(atol=1e-5, rtol=1e-5)
ROWS, COLS = logit_head.MMA_ROW_TILE, logit_head.MMA_COL_TILE
NEG = np.float32(-np.inf)
NO_ID = np.iinfo(np.int32).max


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from cooperativeimagecaptioning_tpu.ops.pallas import beam_head as jb
    from cooperativeimagecaptioning_tpu.ops.pallas import logit_head as jl
    return dict(jnp=jnp, beam=jb, logit=jl)


def before(v, i, v2, i2):
    return v > v2 or (v == v2 and i < i2)


def owner(row_in_tile, col_in_tile):
    """(warpgroup, warp, lane, half, accumulator register) that holds an
    element of a block's [128 x 128] tile: a warpgroup's m64n128 f32
    accumulator gives lane l of warp w rows 16 w + l // 4 (+ 8) and columns
    8 j + 2 (l % 4) + {0, 1}."""
    wg, r = divmod(row_in_tile, 64)
    warp, r = divmod(r, 16)
    half, r = divmod(r, 8)
    j, c = divmod(col_in_tile, 8)
    q, e = divmod(c, 2)
    return wg, warp, 4 * r + q, half, 4 * j + 2 * half + e


def push(vals, ids, x, i):
    """topk_push: x takes the first slot it leads, the rest move down."""
    for j in range(len(vals)):
        if before(x, i, vals[j], ids[j]):
            vals[j], x = x, vals[j]
            ids[j], i = i, ids[j]


def lse_merge(m, s, m2, s2):
    mx = max(m, m2)
    if mx == NEG:
        return m, s
    return mx, np.float32(s * np.exp(np.float32(m - mx))
                          + s2 * np.exp(np.float32(m2 - mx)))


def emulate_first_pass(logits, row, kk_slots, c_begin, c_end, thr=None):
    """The (row, split) partial as the kernel forms it: four lanes of one
    quad, each over its own columns of every 128-column tile of
    [c_begin, c_end), then the quad's merge.  `thr` (value, id): a later
    round's threshold; only candidates after it enter the lists."""
    tv, ti = thr if thr is not None else (np.float32(np.inf), -1)
    V = logits.shape[1]
    lanes = []
    for q in range(4):
        vals, ids = [NEG] * kk_slots, [NO_ID] * kk_slots
        m, s = NEG, np.float32(0.0)
        for n0 in range(c_begin, c_end, COLS):
            cols = [n0 + 8 * j + 2 * q + e for j in range(COLS // 8)
                    for e in range(2)]
            cols = [c for c in cols if c < V]
            if not cols:
                continue
            x = logits[row, cols]
            mn = max(m, x.max())  # one rescale a tile
            s = np.float32(s * np.exp(np.float32(m - mn))
                           + np.exp(x - mn).sum(dtype=np.float32))
            m = mn
            for c, xc in zip(cols, x):
                if before(xc, c, vals[-1], ids[-1]) and before(tv, ti, xc, c):
                    push(vals, ids, xc, c)
        lanes.append((vals, ids, m, s))
    # log-sum-exp: lanes exchange over xor 1, then xor 2
    m01, s01 = lse_merge(lanes[0][2], lanes[0][3], lanes[1][2], lanes[1][3])
    m23, s23 = lse_merge(lanes[2][2], lanes[2][3], lanes[3][2], lanes[3][3])
    M, S = lse_merge(m01, s01, m23, s23)
    # lists: kk_slots rounds; the best head of the four wins and is popped
    out_v, out_i = [], []
    for _ in range(kk_slots):
        best = 0
        for q in range(1, 4):
            if before(lanes[q][0][0], lanes[q][1][0],
                      lanes[best][0][0], lanes[best][1][0]):
                best = q
        out_v.append(lanes[best][0][0])
        out_i.append(lanes[best][1][0])
        lanes[best][0].pop(0)
        lanes[best][0].append(NEG)
        lanes[best][1].pop(0)
        lanes[best][1].append(NO_ID)
    return out_v, out_i, M, S


def emulate_head(h, w, b, kk, sm_count):
    """Both passes: the first over (row tile, split) with the grid
    `mma_split` gives, then the merge kernels' pass over the splits; a kk
    above the longest list in rounds of `beam_head.ROUND_KK`, each round's
    first pass admitting only candidates after the row's last one so far.
    Returns (vals [R,kk], ids [R,kk], lse [R])."""
    logits = (h.astype(np.float32) @ w.astype(np.float32)
              + b.astype(np.float32)).astype(np.float32)
    R, V = logits.shape
    slots = next((s for s in beam_head.SLOTS if s >= kk), beam_head.ROUND_KK)
    splits, split_cols = logit_head.mma_split(R, V, sm_count)
    vals = np.empty((R, kk), np.float32)
    ids = np.empty((R, kk), np.int32)
    lse = np.empty((R,), np.float32)
    for row_tile in range(-(-R // ROWS)):
        for row in range(row_tile * ROWS, min(R, (row_tile + 1) * ROWS)):
            thr = None
            for off in range(0, kk, slots):
                fv, fi = [NEG] * slots, [NO_ID] * slots
                M, S = NEG, np.float32(0.0)
                for sp in range(splits):
                    pv, pi, pm, ps = emulate_first_pass(
                        logits, row, slots, sp * split_cols,
                        min(V, (sp + 1) * split_cols), thr)
                    M, S = lse_merge(M, S, pm, ps)
                    for x, i in zip(pv, pi):
                        if before(x, i, fv[-1], fi[-1]):
                            push(fv, fi, x, i)
                n = min(slots, kk - off)
                vals[row, off:off + n], ids[row, off:off + n] = fv[:n], fi[:n]
                if off == 0:
                    lse[row] = M + np.log(S)
                thr = (fv[-1], fi[-1])
    return vals, ids, lse


def tied_case(R, V, split_cols, seed):
    """Seeded inputs with exact ties (zero columns of W, equal biases) placed
    where the kernel's merge has its seams.  Returns (h, w, b, ids in the
    order every row's top list must start with)."""
    rng = np.random.RandomState(seed)
    h = rng.randn(R, 32).astype(np.float32)
    w = (rng.randn(32, V) * 0.3).astype(np.float32)
    b = (rng.randn(V) * 0.3).astype(np.float32)
    top = [2, 3,              # one thread's two adjacent columns
           4,                 # another lane of the same quad
           COLS + 2,          # the same lane, the block's next column tile
           split_cols + 6,    # another split
           V - 1]             # the last column of the ragged tile
    second = [5, COLS + 3, split_cols + 7]
    top = sorted({c for c in top if c < V})
    second = sorted({c for c in second if c < V} - set(top))
    w[:, top + second] = 0.0
    b[top] = 50.0
    b[second] = 40.0
    return h, w, b, top + second


# (rows, V, SMs): one split of two tiles; four splits of up to three tiles
# and a ragged last tile; a second, ragged row tile; a single ragged tile
SHAPES = [(13, 136, 1), (37, 1304, 4), (131, 1304, 132), (5, 8, 132),
          (9, 264, 2)]


def test_accumulator_ownership_partitions_the_tile():
    """Every element of a [128 x 128] tile has exactly one owner, a quad's
    four lanes share their rows, and a thread's registers 4j+{0,1} / {2,3}
    are its two rows."""
    seen = set()
    for r in range(ROWS):
        quads = set()
        for c in range(COLS):
            wg, warp, lane, half, reg = owner(r, c)
            assert (wg, warp, lane, reg) not in seen
            seen.add((wg, warp, lane, reg))
            assert 0 <= lane < 32 and 0 <= reg < 64
            assert (reg // 2) % 2 == half
            quads.add((wg, warp, lane // 4))
        assert len(quads) == 1
    assert len(seen) == ROWS * COLS


@pytest.mark.parametrize("kk", [*range(1, 17), 17, 20, 32, 33, 48])
def test_emulated_beam_head_matches_the_references(jx, kk):
    """kk = 1..16 over ragged R and V, ties planted at every seam; kk above
    16 in rounds of 16 (beam widths of 16 and more)."""
    R, V, sms = SHAPES[kk % 3]
    _, split_cols = logit_head.mma_split(R, V, sms)
    h, w, b, planted = tied_case(R, V, split_cols, seed=kk)
    vals, ids, lse = emulate_head(h, w, b, kk, sms)
    n = min(kk, len(planted))
    assert (ids[:, :n] == np.asarray(planted[:n])[None]).all()
    want = beam_head.beam_head_reference(
        *map(torch.from_numpy, (h, w, b)), kk)
    jnp = jx["jnp"]
    jwant = jx["beam"].beam_head_reference(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), kk)
    for wv, wi, wl in (want, jwant):
        np.testing.assert_array_equal(np.asarray(wi), ids)
        np.testing.assert_allclose(np.asarray(wv), vals, **TOL)
        np.testing.assert_allclose(np.asarray(wl), lse, **TOL)


@pytest.mark.parametrize("R,V,sms", SHAPES)
def test_emulated_greedy_head_matches_the_references(jx, R, V, sms):
    _, split_cols = logit_head.mma_split(R, V, sms)
    h, w, b, planted = tied_case(R, V, split_cols, seed=R)
    vals, ids, lse = emulate_head(h, w, b, 1, sms)
    assert (ids[:, 0] == planted[0]).all()
    it, lp = logit_head.greedy_head_reference(
        *map(torch.from_numpy, (h, w, b)))
    jnp = jx["jnp"]
    j_it, j_lp = jx["logit"].greedy_head_reference(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b))
    for w_it, w_lp in ((it.numpy(), lp.numpy()),
                       (np.asarray(j_it), np.asarray(j_lp))):
        np.testing.assert_array_equal(w_it, ids[:, 0])
        np.testing.assert_allclose(w_lp, vals[:, 0] - lse, **TOL)


@pytest.mark.parametrize("R,V,sms", [(5, 8, 132), (13, 136, 1),
                                     (7, 40, 132)])
def test_emulated_beam_head_with_kk_of_the_whole_vocab(R, V, sms):
    """kk = min(V, 64): the lists (and, past 16, the rounds) hold every
    column of a small vocab, the sentinels never surface."""
    kk = min(V, 64)
    _, split_cols = logit_head.mma_split(R, V, sms)
    h, w, b, _ = tied_case(R, V, split_cols, seed=V)
    vals, ids, lse = emulate_head(h, w, b, kk, sms)
    wv, wi, wl = beam_head.beam_head_reference(
        *map(torch.from_numpy, (h, w, b)), kk)
    np.testing.assert_array_equal(wi.numpy(), ids)
    np.testing.assert_allclose(wv.numpy(), vals, **TOL)
    np.testing.assert_allclose(wl.numpy(), lse, **TOL)
    assert ids.max() < V


@pytest.mark.parametrize("kk", [17, 24, 40])
def test_emulated_rounds_split_a_tie_group(kk):
    """A group of 24 exactly tied columns spans the seam of two rounds: the
    first round takes its 16 lowest ids, the next round the rest, after the
    round's threshold in (value, id) order."""
    R, V, sms = 9, 264, 2
    rng = np.random.RandomState(kk)
    h = rng.randn(R, 32).astype(np.float32)
    w = (rng.randn(32, V) * 0.3).astype(np.float32)
    b = (rng.randn(V) * 0.3).astype(np.float32)
    tied = sorted(rng.choice(V, 24, replace=False).tolist())
    w[:, tied] = 0.0
    b[tied] = 50.0
    vals, ids, lse = emulate_head(h, w, b, kk, sms)
    n = min(kk, 24)
    assert (ids[:, :n] == np.asarray(tied[:n])[None]).all()
    wv, wi, wl = beam_head.beam_head_reference(
        *map(torch.from_numpy, (h, w, b)), kk)
    np.testing.assert_array_equal(wi.numpy(), ids)
    np.testing.assert_allclose(wv.numpy(), vals, **TOL)
    np.testing.assert_allclose(wl.numpy(), lse, **TOL)


@pytest.mark.parametrize("V", [8, 136, 1304, 9488])
@pytest.mark.parametrize("rows", [1, 13, 256, 512, 1024, 4096, 8192])
def test_mma_split_covers_the_vocab(rows, V):
    sms = 132
    splits, cols = logit_head.mma_split(rows, V, sms)
    assert cols % COLS == 0 and splits >= 1
    # no split is empty and together they cover [0, V)
    assert (splits - 1) * cols < V <= splits * cols
    # one wave of blocks, unless the row tiles alone are more
    row_tiles = -(-rows // ROWS)
    assert row_tiles * splits <= max(sms, row_tiles)
    # and not needlessly few: with one tile less a split, the splits would
    # no longer fit the wave
    per_split = cols // COLS
    if per_split > 1:
        tiles = -(-V // COLS)
        assert row_tiles * -(-tiles // (per_split - 1)) > sms


@pytest.mark.parametrize("dtype,H,V,aligned,want", [
    (torch.bfloat16, 512, 9488, True, "mma"),
    (torch.bfloat16, 64, 8, True, "mma"),
    (torch.bfloat16, 640, 1304, True, "mma"),
    (torch.bfloat16, 512, 9488, False, "fma"),   # storage not on 16 bytes
    (torch.bfloat16, 512, 9487, True, "fma"),    # V % 8
    (torch.bfloat16, 512, 1300, True, "fma"),
    (torch.bfloat16, 96, 9488, True, "fma"),     # H % 64
    (torch.bfloat16, 32, 9488, True, "fma"),
    (torch.bfloat16, 704, 9488, True, "fma"),    # rows exceed shared memory
    (torch.float32, 512, 9488, True, "tf32x3"),  # f32: the split-TF32 pass
    (torch.float32, 64, 8, True, "tf32x3"),
    (torch.float32, 64, 4, True, "tf32x3"),
    (torch.float32, 704, 4744, True, "tf32x3"),  # no depth limit: h streams
    (torch.float32, 512, 9488, False, "fma"),    # storage not on 16 bytes
    (torch.float32, 512, 9486, True, "fma"),     # V % 4
    (torch.float32, 512, 1302, True, "fma"),
    (torch.float32, 96, 9488, True, "fma"),      # H % 64
    (torch.float32, 32, 9488, True, "fma"),
    (torch.float16, 512, 9488, True, "fma"),
])
def test_head_pass_routes_by_type_shape_and_alignment(dtype, H, V, aligned,
                                                      want):
    assert logit_head.head_pass(dtype, H, V, aligned) == want


def test_pass_counts_follow_the_head_counts():
    _dispatch.reset_launches()
    try:
        _dispatch.count("greedy_head", "mma")
        _dispatch.count("greedy_head", "tf32x3")
        _dispatch.count("beam_head", "fma")
        _dispatch.count("beam_head", "mma")
        _dispatch.count("beam_head", "tf32x3")
        _dispatch.count("beam_head", "tf32x3")
        _dispatch.count("attention")
        assert _dispatch.launches() == {
            **{k: 0 for k in _dispatch.KERNELS}, "greedy_head": 2,
            "beam_head": 4, "attention": 1}
        assert _dispatch.head_pass_launches() == {
            "greedy_head_mma": 1, "greedy_head_tf32x3": 1,
            "greedy_head_fma": 0, "beam_head_mma": 1,
            "beam_head_tf32x3": 2, "beam_head_fma": 1}
    finally:
        _dispatch.reset_launches()
    assert not any(_dispatch.head_pass_launches().values())
    assert not any(_dispatch.launches().values())
