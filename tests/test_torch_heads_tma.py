"""The vocabulary heads' bf16 first pass (csrc/vocab_head_tma.cuh,
vocab_partials_tma), held on the CPU by an emulation of its arithmetic, its
schedule and its decomposition.

The CUDA kernel cannot run here, but what decides its result can be
replayed: bf16 operands (exact in f32); for each 64-column tile the k16
slices in ascending k into one f32 accumulator set, from zero (the 16-term
sum inside a slice in float64), zero-filled past H and past V as TMA fills
them; the two accumulator sets taken in turn by the tiles, each tile folded
once its products are complete, in the order the kernel's schedule folds
them (tile t - 1 after the first steps of tile t are issued); the fold as
`fold_tma` does it (fold_tile's arithmetic: the bias in f32, columns >= V
masked, one rescale of the streaming log-sum-exp a tile; its pushes: only
logits before the best last entry of the quad's lists, for a list of one
or two only each lane's best one or two of a tile -- the same partials as
fold_tile's pushes in column order, which a test here checks); the quad
merge of write_quad_partials and the merge of the splits.
The emulation is held to the JAX package's Pallas kernels in interpret mode
(`greedy_head_pallas`, `beam_head_pallas`) on the same bf16-exact inputs
with exact ties planted at every seam of that merge: ids bit-equal, values
and logsumexps within 1e-5 (f32 on both sides: summation order only).

Also here: every (row, column) owned exactly once by the grid, the tile plan
and the accumulator layout; a model of the ring's full and empty barriers
(parity waits, TMA completion, wgmma groups completing late) in which no
stage is overwritten before every consumer has released it; the fit of the
resident rows, the ring and the barriers in a block's shared memory
(constants read from the C source); the split function of the tensor-core
passes, the routing (`head_pass`: the TMA, the split-TF32 and the FMA
passes) and the per-pass launch counts; and, on a card, both heads against
their plain versions.
"""

import random
import re

import numpy as np
import pytest
import torch

from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
    _build, _dispatch, beam_head, logit_head)

TOL = dict(atol=1e-5, rtol=1e-5)
ROWS = logit_head.MMA_ROW_TILE   # rows a block (kTmaRows)
COLS = logit_head.TMA_COL_TILE   # columns a tile (kTmaCols)
UNIT = logit_head.TMA_SPLIT_UNIT  # the splits' unit of columns
DEPTH = logit_head.TMA_DEPTH     # k of an h box: H is a multiple
SLICE = 16                       # k of one wgmma
BLOCK_SMEM = 232448
NEG = np.float32(-np.inf)
NO_ID = np.iinfo(np.int32).max


def constants():
    """The constexpr ints of csrc/vocab_head_tma.cuh."""
    out = {}
    src = (_build.CSRC / "vocab_head_tma.cuh").read_text()
    for key, expr in re.findall(r"constexpr int (kTma\w+) =\s*([^;]+);", src):
        out[key] = eval(expr, {}, dict(out))  # noqa: S307 (own source)
    return out


K = constants()
AHEAD = K["kTmaAhead"]


def plan(H, kk):
    """(k a ring stage, accumulator sets) of a launch at depth H with a list
    of kk, as the launcher picks them: two sets for lists of up to 4 where
    the ring holds 2 AHEAD stages beside the rows and a tile AHEAD steps,
    one set where it holds AHEAD + 2, else stages of half the depth
    (down to 128), then one set."""
    ks, sets = K["kTmaDepth"], 2 if kk <= 4 else 1
    while True:
        steps = -(-H // ks)
        rows = steps * (ks // 64) * K["kTmaHBoxBytes"]
        stages = min(K["kTmaMaxStages"],
                     (K["kTmaBlockSmem"] - 1024 - rows) // (ks * 128 + 16))
        if (steps >= AHEAD and stages >= 2 * AHEAD) if sets == 2 \
                else stages >= AHEAD + 2:
            return ks, sets, steps, stages
        if ks > 128:
            ks //= 2
        elif sets == 2:
            sets = 1
        else:
            raise AssertionError(f"no schedule fits H={H}")


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from cooperativeimagecaptioning_tpu.ops.pallas import beam_head as jb
    from cooperativeimagecaptioning_tpu.ops.pallas import logit_head as jl
    return dict(jnp=jnp, beam=jb, logit=jl)


# --- the schedule ------------------------------------------------------------

def schedule(tiles, ksteps, sets, ahead=AHEAD):
    """A consumer warpgroup's events, in the kernel's order: ("issue", t,
    kb, set) a ring step's products into accumulator set `set`, ("wait",
    n) a wgmma_wait<n>, ("release", n) the stages of every step but the
    newest n released, ("fold", t, set) the epilogue of tile t.  Two sets:
    tile t's first AHEAD steps issued, a wait, then tile t - 1 folded;
    one set: each tile folded after a wait for all its products."""
    ev = []
    for t in range(tiles):
        st = t % 2 if sets == 2 else 0
        first = ahead if sets == 2 else 1
        for kb in range(min(first, ksteps)):
            ev.append(("issue", t, kb, st))
        ev += [("wait", ahead), ("release", ahead)]
        if sets == 2 and t > 0:
            ev.append(("fold", t - 1, 1 - st))
        for kb in range(first, ksteps):
            ev += [("issue", t, kb, st), ("wait", ahead), ("release", ahead)]
        if sets == 1:
            ev += [("wait", 0), ("release", 0), ("fold", t, st)]
    if sets == 2:
        ev += [("wait", 0), ("fold", tiles - 1, (tiles - 1) % 2)]
    return ev


def run_schedule(tiles, ksteps, sets, ahead=AHEAD, on_issue=None,
                 on_fold=None):
    """Replay `schedule` with wgmma groups that complete only when a wait
    makes them: a fold must find its set holding its tile, every step of it
    issued and complete; a tile's first step must find its set folded."""
    pending = []             # issued, incomplete: (t, kb, set)
    holds = {0: None, 1: None}   # set -> [tile, steps complete, folded]
    for ev in schedule(tiles, ksteps, sets, ahead):
        if ev[0] == "issue":
            _, t, kb, st = ev
            if kb == 0:
                assert holds[st] is None or holds[st][2], \
                    f"tile {t} overwrites set {st} before its fold"
                holds[st] = [t, 0, False]
            assert holds[st][0] == t
            pending.append((t, kb, st))
            if on_issue:
                on_issue(t, kb, st)
        elif ev[0] == "wait":
            while len(pending) > ev[1]:
                t, kb, st = pending.pop(0)
                holds[st][1] += 1
        elif ev[0] == "fold":
            _, t, st = ev
            assert holds[st][0] == t and holds[st][1] == ksteps \
                and not holds[st][2], f"fold of tile {t} from set {st}"
            holds[st][2] = True
            if on_fold:
                on_fold(t, st)
    assert all(v is None or v[2] for v in holds.values())


@pytest.mark.parametrize("sets", [1, 2])
@pytest.mark.parametrize("ksteps", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("tiles", [1, 2, 3, 6, 7])
def test_schedule_folds_every_tile_once_its_products_are_complete(
        tiles, ksteps, sets):
    if sets == 2 and ksteps < AHEAD:
        pytest.skip("the launcher takes one set there")
    folded = []
    run_schedule(tiles, ksteps, sets,
                 on_fold=lambda t, st: folded.append(t))
    assert folded == list(range(tiles))


def test_schedule_overlaps_a_fold_with_the_next_tiles_products():
    """At H = 512 (two ring steps a tile) each fold but the last, with two
    sets, has AHEAD steps of the next tile issued and not waited for."""
    ks, sets, steps, _ = plan(512, 2)
    assert (ks, sets, steps) == (256, 2, 2)
    inflight = []
    seen = {"issued": 0}

    def issue(t, kb, st):
        seen["issued"] += 1

    def fold(t, st):
        inflight.append(seen["issued"] - (t + 1) * steps)
    run_schedule(5, steps, sets, on_issue=issue, on_fold=fold)
    assert inflight[:-1] == [AHEAD] * 4 and inflight[-1] == 0


@pytest.mark.parametrize("H", range(64, 641, 64))
def test_every_routed_depth_has_a_schedule(H):
    """256-deep stages and two sets (lists of up to 4) at the served H =
    512 and below; 128-deep ones above; one set for lists of 8 and 16."""
    for kk in (1, 2, 4, 8, 16):
        ks, sets, steps, stages = plan(H, kk)
        assert ks == (256 if H <= 512 else 128)
        assert sets == (2 if kk <= 4 else 1)
        assert stages >= (2 * AHEAD if sets == 2 else AHEAD + 2)


# --- the ring ----------------------------------------------------------------

def ring_model(stages, tiles, ksteps, sets, seed, ahead=AHEAD):
    """The ring's barriers under a random interleaving of the producer's
    thread, TMA's completions and two consumer warpgroups that follow
    `schedule`, their wgmma groups completing at random but in order.
    full[s]: one arrival (the producer's expect_tx) and the copies' bytes;
    empty[s]: four arrivals a warpgroup; a wait on parity p passes once the
    barrier's phase count is odd-even different from p
    (mbarrier.try_wait.parity).  Asserts that a stage is refilled only after
    both warpgroups' products of its previous step completed, and that
    every product reads the step it was issued for; raises on a deadlock.
    Returns the number of rounds run."""
    rng = random.Random(seed)
    total = tiles * ksteps
    full = [0] * stages    # completed phases
    empty = [0] * stages
    empty_arrivals = [0] * stages
    holds = [None] * stages    # the step whose data the stage holds
    landing = []               # (stage, step): copies in flight
    prod = {"g": 0}
    cons = [dict(ev=iter(schedule(tiles, ksteps, sets, ahead)), cur=None,
                 pending=[], issued=0, released=0, done=set(), over=False)
            for _ in range(2)]

    def producer():
        g = prod["g"]
        if g >= total:
            return False
        s, n = g % stages, g // stages
        if g >= stages and not (empty[s] & 1) != ((n - 1) & 1):
            return False
        if g >= stages:
            for c in cons:
                assert g - stages in c["done"], \
                    f"stage {s} refilled with step {g} before step " \
                    f"{g - stages} was complete"
        holds[s] = None
        landing.append((s, g))
        prod["g"] += 1
        return True

    def tma():
        if not landing:
            return False
        s, g = landing.pop(rng.randrange(len(landing))
                           if rng.random() < 0.3 else 0)
        holds[s] = g
        full[s] += 1
        return True

    def complete(c):
        done = c["pending"].pop(0)
        assert holds[done % stages] == done, "a stage changed under its " \
            "products"
        c["done"].add(done)

    def consumer(c):
        if c["pending"] and rng.random() < 0.4:   # a group completes early
            complete(c)
            return True
        if c["cur"] is None:
            c["cur"] = next(c["ev"], None)
            if c["cur"] is None:
                c["over"] = True
                return False
        kind, arg = c["cur"][0], c["cur"][1]
        if kind == "issue":
            g = c["issued"]
            s, n = g % stages, g // stages
            if not (full[s] & 1) != (n & 1):
                return False
            assert holds[s] == g
            c["pending"].append(g)
            c["issued"] += 1
        elif kind == "wait":
            while len(c["pending"]) > arg:
                complete(c)
        elif kind == "release":
            for _ in range(c["released"], c["issued"] - arg):
                r = c["released"] % stages
                empty_arrivals[r] += 4
                if empty_arrivals[r] == 8:
                    empty_arrivals[r] = 0
                    empty[r] += 1
                c["released"] += 1
        c["cur"] = None
        return True

    rounds = 0
    actors = [producer, tma, lambda: consumer(cons[0]),
              lambda: consumer(cons[1])]
    while not all(c["over"] for c in cons):
        progressed = False
        for actor in rng.sample(actors, len(actors)):
            progressed |= actor()
        rounds += 1
        if not progressed and not all(c["over"] for c in cons):
            raise RuntimeError("the ring deadlocked")
    assert all(c["issued"] == total and not c["pending"] for c in cons)
    return rounds


@pytest.mark.parametrize("H,kk", [(64, 1), (320, 2), (512, 1), (512, 8),
                                  (576, 2), (640, 16)])
def test_ring_never_overwrites_a_stage_in_use(H, kk):
    """The launcher's schedules at depths and lists it takes, under random
    interleavings."""
    _, sets, steps, stages = plan(H, kk)
    for seed in range(6):
        assert ring_model(stages, 3, steps, sets, seed) > 0


def test_two_sets_need_twice_ahead_stages():
    """Before its wait a warpgroup holds AHEAD unreleased steps of each
    set: a ring one stage short of 2 AHEAD deadlocks (the launcher then
    takes shallower stages or one set)."""
    for ahead in (1, 2, 3):
        with pytest.raises(RuntimeError, match="deadlocked"):
            ring_model(2 * ahead - 1, 3, 4, 2, 0, ahead=ahead)
        assert ring_model(2 * ahead, 3, 4, 2, 0, ahead=ahead) > 0


# --- the emulation -----------------------------------------------------------

def before(v, i, v2, i2):
    return (v > v2) | ((v == v2) & (i < i2))


def push(tv, ti, x, i, ok):
    """topk_push on every row where `ok`: x takes the first slot it leads,
    each displaced entry moves one slot down."""
    tv, ti = tv.copy(), ti.copy()
    x, i = x.copy(), i.copy()
    for j in range(tv.shape[1]):
        lead = ok & before(x, i, tv[:, j], ti[:, j])
        vj, ij = tv[:, j].copy(), ti[:, j].copy()
        tv[:, j] = np.where(lead, x, vj)
        ti[:, j] = np.where(lead, i, ij)
        x = np.where(lead, vj, x)
        i = np.where(lead, ij, i)
    return tv, ti


def tile_products(h, w, c0, kb, ks, acc):
    """One ks-deep ring step's wgmma slices of the tile at column c0 into
    `acc` (f32 [R, 64]; None: from zero); W's columns past V and k past H
    (h's too) arrive as TMA's zeros."""
    H, V = w.shape
    cols = c0 + np.arange(COLS)
    inside = cols < V
    k = kb * ks + np.arange(ks)
    kin = k < H
    wt = np.zeros((ks, COLS), np.float32)
    wt[np.ix_(kin, inside)] = w[np.ix_(k[kin], cols[inside])]
    hk = np.zeros((h.shape[0], ks), np.float32)
    hk[:, kin] = h[:, k[kin]]
    for q in range(ks // SLICE):
        sl = slice(q * SLICE, (q + 1) * SLICE)
        part = (hk[:, sl].astype(np.float64) @ wt[sl].astype(np.float64)
                ).astype(np.float32)
        acc = part if acc is None else (acc + part).astype(np.float32)
    return acc


def lse_merge(m, s, m2, s2):
    """cic::lse_merge for every row (f32): both empty stay as they are."""
    mx = np.maximum(m, m2)
    empty = mx == NEG
    safe = np.where(empty, 0, mx)
    out = s * np.exp(np.where(empty, 0, m - safe)) \
        + s2 * np.exp(np.where(empty, 0, m2 - safe))
    return np.where(empty, m, mx), np.where(empty, s, out).astype(np.float32)


class Lane:
    """The state one lane of a quad carries for its rows over a split."""

    def __init__(self, R, kk, thr):
        self.tv = np.full((R, kk), NEG, np.float32)
        self.ti = np.full((R, kk), NO_ID, np.int64)
        self.m = np.full(R, NEG, np.float32)
        self.s = np.zeros(R, np.float32)
        self.thr = thr

    def fold(self, acc, b, c0, q, V, quad=None):
        """fold_tile for lane q of the quad: its columns 8 j + 2 q + {0, 1}
        of the tile at c0.  quad=None: fold_tile's pushes, every logit in
        column order; else fold_tma's, with `quad` the best last entry of
        the quad's lists before the tile (value, id): only logits before
        it, and for a list of one or two only the lane's best one or two
        of the tile."""
        R = acc.shape[0]
        cols = np.array([c0 + 8 * j + 2 * q + e for j in range(COLS // 8)
                         for e in range(2)])
        x = np.full((R, len(cols)), NEG, np.float32)
        ok = cols < V
        x[:, ok] = (acc[:, cols[ok] - c0] + b[cols[ok]]).astype(np.float32)
        tmax = x.max(axis=1)
        live = tmax > NEG
        mn = np.where(live, np.maximum(self.m, tmax), self.m)
        sums = np.zeros((R, 4), np.float32)
        with np.errstate(invalid="ignore"):   # rows with no column left
            for j in range(COLS // 8):
                e = np.exp(x[:, 2 * j] - mn) + np.exp(x[:, 2 * j + 1] - mn)
                sums[:, j & 3] = np.where(live, sums[:, j & 3] + e, 0)
            rescale = np.exp(np.where(live, self.m - mn, 0))
        tot = (sums[:, 0] + sums[:, 1]) + (sums[:, 2] + sums[:, 3])
        self.s = np.where(live, self.s * rescale + tot, self.s).astype(
            np.float32)
        self.m = mn
        kk = self.tv.shape[1]
        order = range(len(cols))
        if quad is not None and kk <= 2 and self.thr is None:
            # the lane's best one or two of the tile, best first
            rank = np.lexsort((np.broadcast_to(cols, x.shape),
                               -x.astype(np.float64)), axis=1)
            order = [rank[:, r] for r in range(kk)]
        for c in order:
            xc = np.take_along_axis(x, np.asarray(c).reshape(-1, 1)
                                    * np.ones((R, 1), np.int64), 1)[:, 0]
            xi = cols[c] * np.ones(R, np.int64)
            ok = (xi < V) & before(xc, xi, self.tv[:, -1], self.ti[:, -1])
            if quad is not None:
                ok &= before(xc, xi, quad[0], quad[1])
            if self.thr is not None:
                ok &= before(self.thr[0], self.thr[1], xc, xi)
            self.tv, self.ti = push(self.tv, self.ti, xc, xi, ok)


def quad_last(lanes):
    """The best of the quad's lists' last entries, a row each."""
    v, i = lanes[0].tv[:, -1], lanes[0].ti[:, -1]
    for ln in lanes[1:]:
        lead = before(ln.tv[:, -1], ln.ti[:, -1], v, i)
        v, i = np.where(lead, ln.tv[:, -1], v), np.where(lead, ln.ti[:, -1], i)
    return v, i


def split_partial(h, w, b, c_begin, c_end, kk, thr, kernel_pushes=False):
    """The (row, split) partials of one split for all rows: the schedule's
    issues into two accumulator sets and its folds, four lanes a quad, then
    the quad's merge (log-sum-exp over xor 1 then xor 2; the lists by kk
    rounds of pop-the-winner).  kernel_pushes: fold_tma's pushes, else
    fold_tile's."""
    R, (H, V) = h.shape[0], w.shape
    tiles = -(-(c_end - c_begin) // COLS)
    ks, sets, ksteps, _ = plan(H, kk)
    lanes = [Lane(R, kk, thr) for _ in range(4)]
    acc = {0: None, 1: None}

    def issue(t, kb, st):
        acc[st] = tile_products(h, w, c_begin + t * COLS, kb, ks,
                                None if kb == 0 else acc[st])

    def fold(t, st):
        quad = quad_last(lanes) if kernel_pushes else None
        for q, lane in enumerate(lanes):
            lane.fold(acc[st], b, c_begin + t * COLS, q, V, quad)
    run_schedule(tiles, ksteps, sets, on_issue=issue, on_fold=fold)
    m01, s01 = lse_merge(lanes[0].m, lanes[0].s, lanes[1].m, lanes[1].s)
    m23, s23 = lse_merge(lanes[2].m, lanes[2].s, lanes[3].m, lanes[3].s)
    M, S = lse_merge(m01, s01, m23, s23)
    rows = np.arange(R)
    pos = np.zeros((4, R), np.int64)   # each lane's head in its list
    out_v = np.empty((R, kk), np.float32)
    out_i = np.empty((R, kk), np.int64)
    for j in range(kk):
        hv = np.stack([np.where(pos[q] < kk, ln.tv[rows, np.minimum(
            pos[q], kk - 1)], NEG) for q, ln in enumerate(lanes)])
        hi = np.stack([np.where(pos[q] < kk, ln.ti[rows, np.minimum(
            pos[q], kk - 1)], NO_ID) for q, ln in enumerate(lanes)])
        best = np.zeros(R, np.int64)
        for q in range(1, 4):
            best = np.where(before(hv[q], hi[q], hv[best, rows],
                                   hi[best, rows]), q, best)
        out_v[:, j], out_i[:, j] = hv[best, rows], hi[best, rows]
        pos[best, rows] += 1
    return out_v, out_i, M, S


def emulate_head(h, w, b, kk, sms):
    """Both passes: the first over the grid `mma_split` gives (splits in
    128-column units), then the merge over the splits (float64 sum); a kk
    above the longest list in rounds of `beam_head.ROUND_KK`, each round's
    first pass admitting only candidates after the row's last one so far.
    Returns (vals [R,kk], ids [R,kk], lse [R])."""
    R, V = h.shape[0], w.shape[1]
    slots = next((s for s in beam_head.SLOTS if s >= kk), beam_head.ROUND_KK)
    splits, split_cols = logit_head.mma_split(R, V, sms, UNIT)
    vals = np.empty((R, kk), np.float32)
    ids = np.empty((R, kk), np.int64)
    lse = None
    thr = None
    for off in range(0, kk, slots):
        cand_v, cand_i, ms, ss = [], [], [], []
        for sp in range(splits):
            pv, pi, pm, ps = split_partial(
                h, w, b, sp * split_cols, min(V, (sp + 1) * split_cols),
                slots, thr, kernel_pushes=True)
            cand_v.append(pv)
            cand_i.append(pi)
            ms.append(pm)
            ss.append(ps)
        cv, ci = np.concatenate(cand_v, 1), np.concatenate(cand_i, 1)
        order = np.lexsort((ci, -cv.astype(np.float64)), axis=1)
        cv = np.take_along_axis(cv, order, 1)[:, :slots]
        ci = np.take_along_axis(ci, order, 1)[:, :slots]
        n = min(slots, kk - off)
        vals[:, off:off + n], ids[:, off:off + n] = cv[:, :n], ci[:, :n]
        if off == 0:
            m = np.stack(ms, 1).astype(np.float64)
            s = np.stack(ss, 1).astype(np.float64)
            mx = m.max(1)
            lse = (mx + np.log((s * np.exp(m - mx[:, None])).sum(1))
                   ).astype(np.float32)
        thr = (cv[:, -1], ci[:, -1])
    return vals, ids, lse


def tied_case(R, H, V, split_cols, seed):
    """Seeded bf16-exact inputs with exact ties (zero columns of W, equal
    biases) at the merge's seams.  Returns (h, w, b, the ids every row's
    top list starts with, in order)."""
    rng = np.random.RandomState(seed)

    def bf16(x):
        return torch.from_numpy(x.astype(np.float32)).bfloat16().float() \
            .numpy()
    h = bf16(rng.randn(R, H))
    w = bf16(rng.randn(H, V) * 0.3)
    b = bf16(rng.randn(V) * 0.3)
    top = [2, 3,               # one thread's two adjacent columns
           4,                  # another lane of the same quad
           COLS + 2,           # the same lane, the other accumulator set
           2 * COLS + 2,       # the same set, two tiles on
           split_cols + 6,     # another split
           V - 1]              # the last column of the ragged tile
    second = [5, COLS + 3, split_cols + 7]
    top = sorted({c for c in top if c < V})
    second = sorted({c for c in second if c < V} - set(top))
    w[:, top + second] = 0.0
    b[top] = 50.0
    b[second] = 40.0
    return h, w, b, top + second


# rows, V (a ragged last tile and split), SMs: 3 splits of 2 units, 4, 4
# and 3 tiles (both accumulator sets last); H = 64 is one ring step a tile
# (the early fold), H = 320 five (the regular one)
R_, V_, SMS = 37, 648, 4


@pytest.mark.parametrize("kk", [1, 2, 3, 16])
def test_emulated_beam_head_matches_jax(jx, kk):
    _, split_cols = logit_head.mma_split(R_, V_, SMS, UNIT)
    h, w, b, planted = tied_case(R_, 64, V_, split_cols, seed=kk)
    vals, ids, lse = emulate_head(h, w, b, kk, SMS)
    n = min(kk, len(planted))
    assert (ids[:, :n] == np.asarray(planted[:n])[None]).all()
    jnp = jx["jnp"]
    jv, ji, jl = jx["beam"].beam_head_pallas(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), kk, interpret=True)
    np.testing.assert_array_equal(np.asarray(ji), ids)
    np.testing.assert_allclose(np.asarray(jv), vals, **TOL)
    np.testing.assert_allclose(np.asarray(jl), lse, **TOL)


def test_emulated_greedy_head_matches_jax(jx):
    _, split_cols = logit_head.mma_split(R_, V_, SMS, UNIT)
    h, w, b, planted = tied_case(R_, 64, V_, split_cols, seed=5)
    vals, ids, lse = emulate_head(h, w, b, 1, SMS)
    assert (ids[:, 0] == planted[0]).all()
    jnp = jx["jnp"]
    j_it, j_lp = jx["logit"].greedy_head_pallas(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), interpret=True)
    np.testing.assert_array_equal(np.asarray(j_it), ids[:, 0])
    np.testing.assert_allclose(np.asarray(j_lp), vals[:, 0] - lse, **TOL)


@pytest.mark.parametrize("kk", [1, 2, 16])
def test_emulated_deeper_rows_match_the_plain_head(kk):
    """H = 320: five ring steps a tile, so each fold runs with the next
    tile's first AHEAD steps in flight."""
    _, split_cols = logit_head.mma_split(R_, V_, SMS, UNIT)
    h, w, b, planted = tied_case(R_, 320, V_, split_cols, seed=320 + kk)
    vals, ids, lse = emulate_head(h, w, b, kk, SMS)
    assert (ids[:, :min(kk, len(planted))]
            == np.asarray(planted[:kk])[None]).all()
    wv, wi, wl = beam_head.beam_head_reference(
        *map(torch.from_numpy, (h, w, b)), kk)
    np.testing.assert_array_equal(wi.numpy(), ids)
    np.testing.assert_allclose(wv.numpy(), vals, **TOL)
    np.testing.assert_allclose(wl.numpy(), lse, **TOL)


@pytest.mark.parametrize("kk", [1, 2, 4, 16])
def test_kernel_pushes_give_fold_tiles_partials(kk):
    """fold_tma pushes fewer logits than fold_tile, in another order: only
    those before the best last entry of the quad's lists, and for a list of
    one or two only each lane's best one or two of a tile.  Each lane's
    list may differ; every (row, split) partial after the quad's merge is
    the same, ties planted at every seam included, and so is a later
    round's (a threshold a row)."""
    H = 64
    _, split_cols = logit_head.mma_split(R_, V_, SMS, UNIT)
    h, w, b, _ = tied_case(R_, H, V_, split_cols, seed=40 + kk)
    rng = np.random.RandomState(kk)
    thr = None if kk < 16 else (np.full(R_, np.float32(50.0)),
                                rng.randint(0, V_, R_).astype(np.int64))
    for sp in range(-(-V_ // split_cols)):
        bounds = (sp * split_cols, min(V_, (sp + 1) * split_cols))
        want = split_partial(h, w, b, *bounds, kk, thr)
        got = split_partial(h, w, b, *bounds, kk, thr, kernel_pushes=True)
        for g, wnt in zip(got, want):
            np.testing.assert_array_equal(g, wnt)


@pytest.mark.parametrize("kk", [17, 32])
def test_emulated_rounds_split_a_tie_group(kk):
    """A group of 24 exactly tied columns spans the seam of two rounds of
    16: the first round takes its 16 lowest ids, the next the rest, after
    the round's threshold in (value, id) order."""
    H = 64
    rng = np.random.RandomState(kk)
    _, split_cols = logit_head.mma_split(R_, V_, SMS, UNIT)
    h, w, b, _ = tied_case(R_, H, V_, split_cols, seed=kk)
    tied = sorted(rng.choice(V_, 24, replace=False).tolist())
    w[:, tied] = 0.0
    b[tied] = 60.0
    vals, ids, lse = emulate_head(h, w, b, kk, SMS)
    n = min(kk, 24)
    assert (ids[:, :n] == np.asarray(tied[:n])[None]).all()
    wv, wi, wl = beam_head.beam_head_reference(
        *map(torch.from_numpy, (h, w, b)), kk)
    np.testing.assert_array_equal(wi.numpy(), ids)
    np.testing.assert_allclose(wv.numpy(), vals, **TOL)
    np.testing.assert_allclose(wl.numpy(), lse, **TOL)


# --- the decomposition -------------------------------------------------------

def owner(row_in_tile, col_in_tile):
    """(warpgroup, warp, lane, register) holding an element of a block's
    [128 x 64] tile in either accumulator set: an m64n64 f32 accumulator
    gives lane l of warp w rows 16 w + l // 4 (+ 8) and columns 8 j + 2 (l
    % 4) + {0, 1}, in register 4 j + 2 (half) + e."""
    wg, r = divmod(row_in_tile, 64)
    warp, r = divmod(r, 16)
    half, r = divmod(r, 8)
    j, c = divmod(col_in_tile, 8)
    q, e = divmod(c, 2)
    return wg, warp, 4 * r + q, 4 * j + 2 * half + e


def test_accumulator_layout_partitions_a_tile():
    seen = set()
    for r in range(ROWS):
        for c in range(COLS):
            wg, warp, lane, reg = owner(r, c)
            assert 0 <= lane < 32 and 0 <= reg < COLS // 2
            assert (wg, warp, lane, reg) not in seen
            seen.add((wg, warp, lane, reg))
    assert len(seen) == ROWS * COLS


@pytest.mark.parametrize("R", [128, 300, 512, 1024, 4096, 8192])
def test_every_row_and_column_is_owned_once(R):
    """At V+1 = 9488 on 132 SMs: the row tiles' rows (a thread's rows 16 w
    + l // 4 + 8 half of its block's) cover [0, R) once, the splits' tiles'
    columns (8 j + 2 (l % 4) + e of each tile, masked at V) cover [0, V)
    once; a thread's (row, column) pairs them through its lane, l = 4 (row
    part) + (column part), so every (row, column) has one owner."""
    V = 9488
    splits, split_cols = logit_head.mma_split(R, V, 132, UNIT)
    assert split_cols % COLS == 0
    rows = np.zeros(R, np.int64)
    for r0 in range(0, R, ROWS):
        for warp in range(8):
            for l4 in range(8):
                for half in range(2):
                    r = r0 + 16 * warp + l4 + 8 * half
                    if r < R:
                        rows[r] += 1
    assert (rows == 1).all()
    j, q, e = np.meshgrid(np.arange(COLS // 8), np.arange(4), np.arange(2),
                          indexing="ij")
    in_tile = (8 * j + 2 * q + e).ravel()
    assert sorted(in_tile) == list(range(COLS))
    cols = np.zeros(V, np.int64)
    for sp in range(splits):
        c_begin, c_end = sp * split_cols, min(V, (sp + 1) * split_cols)
        assert c_begin < c_end
        tiles = -(-(c_end - c_begin) // COLS)
        c = (c_begin + COLS * np.arange(tiles)[:, None] + in_tile).ravel()
        np.add.at(cols, c[c < c_end], 1)
    assert (cols == 1).all()
    # one wave: the grid keeps (row tiles x splits) within the SMs
    assert -(-R // ROWS) * splits <= max(132, -(-R // ROWS))


def test_rows_ring_and_barriers_fit_the_shared_memory_of_a_block():
    """At every H the routing admits (64 to 640) and for every list: the
    resident h boxes ([128 rows x 64 k], 16 KB, as many as the stages'
    depth covers), the ring of the schedule the launcher picks ([ks k x 64
    columns] a stage, at most kTmaMaxStages), 1024 bytes to align the boxes
    and two mbarriers a stage fit the 227 KB a block may ask for; every box
    and stage starts on its 1024-byte swizzle atom (a 64-column row is 128
    bytes); two consumer warpgroups and the producer's, after setmaxnreg,
    fit an SM's 65536 registers."""
    k = K
    assert (k["kTmaRows"], k["kTmaCols"], k["kTmaBoxK"],
            k["kTmaMaxDepth"]) == (ROWS, COLS, DEPTH,
                                   logit_head.TMA_MAX_DEPTH)
    assert k["kTmaBlockSmem"] == BLOCK_SMEM
    box = ROWS * DEPTH * 2
    assert k["kTmaHBoxBytes"] == box and box % 1024 == 0 and COLS * 2 == 128
    for H in range(DEPTH, logit_head.TMA_MAX_DEPTH + 1, DEPTH):
        for kk in (1, 2, 4, 8, 16):
            ks, sets, steps, stages = plan(H, kk)
            stage = ks * COLS * 2
            assert stage % 1024 == 0 and steps * ks >= H
            rows = steps * (ks // DEPTH) * box
            assert 1024 + rows + stages * (stage + 16) <= BLOCK_SMEM
    assert k["kTmaThreads"] == 3 * 128
    assert 2 * 128 * k["kTmaConsumerRegs"] \
        + 128 * k["kTmaProducerRegs"] <= 65536
    assert k["kTmaConsumerRegs"] % 8 == k["kTmaProducerRegs"] % 8 == 0


def test_serialized_wgmma_reads_ptxas_c7515_lines():
    # chip_smoke.py's build phase fails on a TMA pass that ptxas serialized
    log = """
ptxas info    : Compiling entry function '_Z18vocab_partials_tmaILi2ELb0EEvv' for 'sm_90a'
ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are serialized due to non wgmma instructions defining accumulator registers of a wgmma between start and end of the pipeline stage in the function '_Z18vocab_partials_tmaILi2ELb0EEvv'
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are serialized
"""
    assert _build.serialized_wgmma(log) == [
        "_Z18vocab_partials_tmaILi2ELb0EEvv", "?"]
    assert _build.serialized_wgmma(
        "ptxas info    : Used 168 registers, used 1 barriers") == []


def test_pass_codes_match_the_c_source():
    src = (_build.CSRC / "vocab_head.cuh").read_text()
    codes = dict(re.findall(r"constexpr int (kPass\w+) = (\d+);", src))
    assert logit_head.PASS_CODES == {
        "fma": int(codes["kPassFma"]), "tf32x3": int(codes["kPassTf32"]),
        "tma": int(codes["kPassTma"])}


@pytest.mark.parametrize("V", [8, 136, 1304, 9488])
@pytest.mark.parametrize("rows", [1, 13, 256, 512, 1024, 4096, 8192])
def test_mma_split_covers_the_vocab(rows, V):
    sms = 132
    splits, cols = logit_head.mma_split(rows, V, sms)
    assert cols % UNIT == 0 and splits >= 1
    # no split is empty and together they cover [0, V)
    assert (splits - 1) * cols < V <= splits * cols
    # one wave of blocks, unless the row tiles alone are more
    row_tiles = -(-rows // ROWS)
    assert row_tiles * splits <= max(sms, row_tiles)
    # and not needlessly few: with one tile less a split, the splits would
    # no longer fit the wave
    per_split = cols // UNIT
    if per_split > 1:
        tiles = -(-V // UNIT)
        assert row_tiles * -(-tiles // (per_split - 1)) > sms


@pytest.mark.parametrize("dtype,H,V,aligned,want", [
    (torch.bfloat16, 512, 9488, True, "tma"),
    (torch.bfloat16, 64, 8, True, "tma"),
    (torch.bfloat16, 640, 1304, True, "tma"),
    (torch.bfloat16, 640, 4744, True, "tma"),    # the vocab slice of two
    (torch.bfloat16, 512, 9488, False, "fma"),   # storage not on 16 bytes
    (torch.bfloat16, 512, 9487, True, "fma"),    # V % 8
    (torch.bfloat16, 512, 1300, True, "fma"),
    (torch.bfloat16, 96, 9488, True, "fma"),     # H % 64
    (torch.bfloat16, 32, 9488, True, "fma"),
    (torch.bfloat16, 704, 9488, True, "fma"),    # past kTmaMaxDepth
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
    assert f"greedy_head_{want}" in _dispatch.HEAD_PASSES
    assert f"beam_head_{want}" in _dispatch.HEAD_PASSES


def test_pass_counts_follow_the_head_counts():
    _dispatch.reset_launches()
    try:
        _dispatch.count("greedy_head", "tma")
        _dispatch.count("greedy_head", "tf32x3")
        _dispatch.count("beam_head", "fma")
        _dispatch.count("beam_head", "tma")
        _dispatch.count("beam_head", "tf32x3")
        _dispatch.count("beam_head", "tf32x3")
        _dispatch.count("attention")
        assert _dispatch.launches() == {
            **{k: 0 for k in _dispatch.KERNELS}, "greedy_head": 2,
            "beam_head": 4, "attention": 1}
        assert _dispatch.head_pass_launches() == {
            "greedy_head_tma": 1, "greedy_head_tf32x3": 1,
            "greedy_head_fma": 0, "beam_head_tma": 1,
            "beam_head_tf32x3": 2, "beam_head_fma": 1}
    finally:
        _dispatch.reset_launches()
    assert not any(_dispatch.head_pass_launches().values())
    assert not any(_dispatch.launches().values())


# --- on the card -------------------------------------------------------------

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
@pytest.mark.parametrize("kk", [1, 2, 16, 32])
@pytest.mark.parametrize("R", [1, 300, 512, 4096])
def test_tma_heads_match_plain(cuda, R, kk):
    """bf16 at H = 512, V+1 = 9488 with planted ties against the plain
    versions: ids equal but at near-ties (plain f32 logits within 1e-4),
    values and logsumexps within 1e-4 (f32 on both sides from the same
    bf16 inputs); every launch on the TMA pass."""
    V = 9488
    split_cols = logit_head.mma_split(R, V, 132, UNIT)[1]
    h, w, b, planted = tied_case(R, 512, V, split_cols, seed=R)
    h, w, b = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (h, w, b))
    planted = torch.tensor(planted, device=cuda)
    logits = logit_head.logits_f32(h, w, b)
    if kk == 1:
        it, lp = logit_head.greedy_head(h, w, b)
        it_p, lp_p = logit_head.greedy_head_reference(h, w, b)
        assert (it == int(planted[0])).all()
        assert (lp - lp_p).abs().max().item() <= 1e-4
    vals, idx, lse = beam_head.beam_head(h, w, b, kk)
    torch.cuda.synchronize()
    vals_p, idx_p, lse_p = beam_head.beam_head_reference(h, w, b, kk)
    n = min(kk, len(planted))
    assert (idx[:, :n] == planted[:n].int()[None]).all()
    diff = idx != idx_p
    if diff.any():
        gap = (torch.gather(logits, 1, idx.long())
               - torch.gather(logits, 1, idx_p.long())).abs()[diff]
        assert gap.max().item() <= 1e-4
    assert (vals - vals_p).abs().max().item() <= 1e-4
    assert (lse - lse_p).abs().max().item() <= 1e-4
    passes = _dispatch.head_pass_launches()
    assert {k: v for k, v in passes.items() if v} == {
        **({"greedy_head_tma": 1} if kk == 1 else {}), "beam_head_tma": 1}
