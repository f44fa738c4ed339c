"""The stream design of the attention kernels (b-major A, K-major E, int8 D)
of csrc/att_step.cu, as far as the CPU can hold it:

* `att_step.stream_plan` / `stream_copies`: under every plan each (row, slot,
  element) of p_att and att_emb is copied into shared memory exactly once,
  from where the layout puts it, in 16-byte aligned multiples of 16 bytes on
  the vector path, into a stage it fits, inside the shared memory a block may
  have -- and, where the stream is the pre-pass's programmatic dependent,
  beside a pre-pass block on the SM -- by a grid whose blocks walk rows
  blockIdx, blockIdx + grid, ...;
* a model of the ring's full and empty mbarriers (the producer warp, eight
  consumer warps, bulk copies that land at random times, the pre-pass that
  completes at a random time), run under random schedules with the kernel's
  own phase parities: no stage and no row slot is refilled before every
  consumer warp has released it, a consumer reads a stage only once it holds
  its chunk, and att_h is copied only after the wait for the pre-pass;
* a replay in PyTorch of the kernels' order of operations (the att_h pre-pass
  in float32; the chunks of a block's rows through the ring, each stage
  refilled once released; a score as 32 lane sums, each of its even and odd
  elements, folded by the warp's butterfly, without b_alpha (which moves
  every score of a row alike); the softmax's maximum and
  normalizer in every warp, lanes strided over K; a chunk's weights, mask and
  att_emb's scale folded in; the weighted sum slot by slot, in order --
  for A and E at vector width in thread groups of slots, whose sums go into
  the first group's at the row's end) against the port's plain version and the JAX package's
  reference and Pallas kernel (interpret mode) on numpy-seeded inputs; for
  the int8 context the same replay at one byte an element, the p_att chunks
  dequantized by their slots' scales and the att_emb scales folded into the
  weights; and the bf16 calls' packed half-precision arithmetic over the int8
  context, emulated by rounding through torch.float16 where the kernel rounds
  to f16 (its tanh.approx.f16x2 as tanh rounded to f16).

Tolerance 1e-5 (atol = rtol) where everything is float32 on both sides and
only the order of the sums differs.  The f16 emulation is held to 2e-3: its
scores carry f16 roundings (unit roundoff 2^-11) of each of A terms, which
move a weight by ~1e-3 relative at these widths; the kernel's own bf16 calls
are held to 3e-2 on the card.  On a CUDA card only (marked `cuda`, skipped
elsewhere): the pre-pass and the three kernels against their plain versions
at aligned and unaligned widths, f32 within 1e-4 and bf16 within 3e-2 as in
tests/test_torch_kernels.py, and the width each launch took."""

import random
import re

import numpy as np
import pytest
import torch

from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
    _build, _dispatch, att_step)

TOL = dict(atol=1e-5, rtol=1e-5)
TOL_F16 = dict(atol=2e-3, rtol=2e-3)
PLAN_B = (1, 7, 128, 256, 512, 640, 1024, 4096, 4099)
PLAN_K = (1, 36, 64, 196, 256)
WIDTH = 512
SMS = 132


def covered(copies, tensor, B, K, kmajor, width, itemsize):
    """How often the copies of `tensor` cover each (row, slot), after checking
    that every run starts where the layout puts its first slot and holds whole
    slots."""
    sel = copies["tensor"] == tensor
    row, k0, nk = (copies[k][sel] for k in ("row", "k0", "nk"))
    slot = k0 * B + row if kmajor else row * K + k0
    np.testing.assert_array_equal(copies["src_byte"][sel],
                                  slot * width * itemsize)
    np.testing.assert_array_equal(copies["nbytes"][sel],
                                  nk * width * itemsize)
    # a run of several slots is contiguous only in the b-major layout
    assert not kmajor or (nk == 1).all()
    count = np.zeros(B * K, np.int64)
    for i in range(int(nk.max())):
        more = nk > i
        np.add.at(count, row[more] * K + k0[more] + i, 1)
    return count


def fits_beside_a_pre_pass(plan, B, itemsize):
    """The plan's blocks of an SM fit its shared memory, and where the
    launch is dependent one of them fits beside a pre-pass block
    (PRE_SMEM)."""
    most = att_step.SM_BLOCKS if itemsize <= 2 else att_step.SM_BLOCKS_F32
    per_sm = min(most, -(-B // SMS))
    block = plan.smem_bytes + att_step.BLOCK_RESERVED
    return per_sm * block <= att_step.SM_SMEM and (
        not plan.dependent or block + att_step.PRE_SMEM
        + att_step.BLOCK_RESERVED <= att_step.SM_SMEM)


@pytest.mark.parametrize("kmajor", [False, True], ids=["bmajor", "kmajor"])
@pytest.mark.parametrize("itemsize", [4, 2, 1], ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("K", PLAN_K)
@pytest.mark.parametrize("B", PLAN_B)
def test_stream_plan_copies_the_context_once(B, K, itemsize, kmajor):
    H = A = WIDTH
    plan = att_step.stream_plan(B, K, H, A, itemsize, kmajor)
    assert plan.vec == 16 // itemsize and plan.kmajor == kmajor
    # every block has a row; block i walks rows i, i + grid, ...
    assert 1 <= plan.grid <= min(B, att_step.SM_BLOCKS * SMS)
    assert plan.rows == -(-B // plan.grid)
    assert 1 <= plan.slots <= min(K, att_step.MAX_SLOTS)
    assert 2 <= plan.stages <= att_step.MAX_STAGES
    assert plan.smem_bytes <= att_step.MAX_SMEM == 227 * 1024
    assert fits_beside_a_pre_pass(plan, B, itemsize)
    assert plan.dependent
    copies = att_step.stream_copies(plan, B, K, H, A, itemsize)
    for tensor, width in ((0, A), (1, H)):
        count = covered(copies, tensor, B, K, kmajor, width, itemsize)
        assert (count == 1).all()
    # the vector path: 16-byte aligned multiples of 16 bytes, both ends
    for key in ("src_byte", "nbytes", "dst_byte"):
        assert (copies[key] % 16 == 0).all(), key
    assert (copies["dst_byte"] + copies["nbytes"] <= plan.stage_bytes).all()
    np.testing.assert_array_equal(copies["block"], copies["row"] % plan.grid)
    np.testing.assert_array_equal(copies["stage"],
                                  copies["chunk"] % plan.stages)
    # a row's p_att chunks come before its att_emb chunks, rows in order
    cpt = -(-K // plan.slots)
    local = copies["row"] // plan.grid
    np.testing.assert_array_equal(copies["chunk"] // (2 * cpt), local)
    np.testing.assert_array_equal(
        (copies["chunk"] % (2 * cpt)) // cpt, copies["tensor"])


@pytest.mark.parametrize("B,K,H,A,itemsize", [
    (13, 6, 97, 83, 4), (13, 6, 97, 83, 2), (9, 64, 100, 72, 2),
    (5, 3, 4000, 64, 4), (300, 36, 4096, 2048, 2)])
def test_stream_plan_of_unaligned_shapes_takes_width_one(B, K, H, A, itemsize):
    """Widths that are no multiple of 16 bytes, or wider than one column
    group a thread, take the same kernel at vector width 1: the same plan
    rules, element-wise copies, and no dependent launch (the producer warp
    waits for the pre-pass before its first copy)."""
    assert att_step.vector_width(H, A, itemsize) == 1
    plan = att_step.stream_plan(B, K, H, A, itemsize, False)
    assert plan.vec == 1 and plan.smem_bytes <= att_step.MAX_SMEM
    assert not plan.dependent and fits_beside_a_pre_pass(plan, B, itemsize)
    assert H <= att_step.MAX_COLS * att_step.THREADS
    copies = att_step.stream_copies(plan, B, K, H, A, itemsize)
    for tensor, width in ((0, A), (1, H)):
        assert (covered(copies, tensor, B, K, False, width, itemsize)
                == 1).all()
    assert (copies["dst_byte"] + copies["nbytes"] <= plan.stage_bytes).all()


@pytest.mark.parametrize("H,A,itemsize,aligned,want", [
    (512, 512, 2, True, 8), (512, 512, 4, True, 4), (512, 512, 2, False, 1),
    (96, 80, 2, True, 8), (96, 80, 4, True, 4), (100, 72, 2, True, 1),
    (100, 72, 4, True, 4), (97, 80, 4, True, 1), (96, 83, 2, True, 1),
    (2048, 512, 2, True, 8), (2056, 512, 2, True, 1),
    (1024, 512, 4, True, 4), (1028, 512, 4, True, 1),
    (512, 512, 1, True, 16), (1024, 512, 1, True, 16),
    (2048, 512, 1, True, 1), (520, 512, 1, True, 1)])
def test_vector_width(H, A, itemsize, aligned, want):
    assert att_step.vector_width(H, A, itemsize, aligned) == want


@pytest.mark.parametrize("B,itemsize,rows,per_sm_at_least", [
    (128, 4, 1, 1), (256, 4, 1, 2), (640, 4, 2, 3), (512, 2, 1, 4),
    (1024, 2, 2, 4), (4096, 2, 8, 4)])
def test_stream_plan_fills_the_card(B, itemsize, rows, per_sm_at_least):
    """At the shapes the paths run (K=36, H=A=512, 132 SMs) the grid is as
    many blocks an SM as B has rows an SM, up to four for bf16 and three for
    f32, each block walking `rows` rows; the blocks of an SM fit beside
    each other (and one beside a pre-pass block where the launch is
    dependent) with tens of KiB in flight."""
    plan = att_step.stream_plan(B, 36, WIDTH, WIDTH, itemsize, False)
    assert plan.rows == rows and plan.slots == 8
    assert plan.grid == min(B, 132 * per_sm_at_least)
    per_sm = 1
    if plan.grid > 132:
        # an SM has 228 KiB for its blocks, each with 1 KiB reserved
        per_sm = 228 * 1024 // (plan.smem_bytes + 1024)
        assert per_sm >= per_sm_at_least
    assert fits_beside_a_pre_pass(plan, B, itemsize)
    # bytes in flight an SM: stages chunks a block
    assert per_sm * plan.stages * plan.stage_bytes >= 32 * 1024


@pytest.mark.parametrize("py,name", [
    (att_step.MAX_K, "kMaxK"), (att_step.THREADS, "kThreads"),
    (att_step.BLOCK_THREADS, "kBlockThreads"),
    (att_step.MAX_STAGES, "kMaxStages"), (att_step.MAX_SLOTS, "kMaxSlots"),
    (att_step.MAX_COLS, "kMaxCols"), (att_step.MAX_SMEM, "kMaxSmem"),
    (att_step.BAR_BYTES, "kBarBytes"), (att_step.PRE_SMEM, "kPreSmem"),
    (att_step.PRE_MANY_ROWS, "kPreManyRows"),
    (att_step.SM_BLOCKS, "kStreamBlocks"),
    (att_step.SM_BLOCKS_F32, "kStreamBlocksF32"),
    (att_step.MAX_SPLIT, "kMaxSplit")])
def test_stream_constants_match_the_c_source(py, name):
    consts = {}
    for key, expr in re.findall(r"constexpr int (\w+) = ([^;]+);",
                                (_build.CSRC / "att_step.cu").read_text()):
        consts[key] = eval(expr, {}, dict(consts))  # noqa: S307 (own source)
    assert consts[name] == py


@pytest.mark.parametrize("typ", ["float", "__nv_bfloat16"])
def test_pre_pass_tiles_keep_to_pre_smem(typ):
    """Every tensor-core pre-pass tile launch_att_h of csrc/att_step.cu
    picks -- f32: the split-depth kernel's, the whole depth of 512 at once;
    bf16: att_h_mma_kernel's, the same depth in four groups, and the ring
    kernel's -- keeps a block within PRE_SMEM, which the stream's plan
    leaves beside a block of its own where the launch is dependent."""
    src = (_build.CSRC / "att_step.cu").read_text()
    body = src[src.index("int launch_att_h(const void* h"):]
    body = body[:body.index("\n}\n")]
    smems = []
    if typ == "float":
        (mt, nt), = re.findall(r"launch_att_h_splitk<(\d+), (\d+)>", body)
        rows, cols = 16 * int(mt), 8 * int(nt)
        smems.append(4 * (rows * (512 + 4) + 512 * (cols + 8)))
        assert 4 * 8 * rows * cols <= smems[-1]  # the partial tiles fit
    else:
        (wm, wn, nt), = re.findall(r"launch_att_h_mma<(\d), (\d), (\d)>",
                                   body)
        rows, cols = 16 * int(wm), 8 * int(nt) * int(wn)
        smems.append(2 * (rows * (512 + 8) + 512 * (cols + 8)))
        (wm, wn, mt, nt, stages), = re.findall(
            r"launch_att_h_ring<(\d), (\d), (\d), (\d), (\d+)>", body)
        rows, cols = 16 * int(wm) * int(mt), 8 * int(wn) * int(nt)
        smems.append(int(stages) * 2 * (rows * (64 + 8) + 64 * (cols + 8)))
    assert smems and max(smems) <= att_step.PRE_SMEM, smems


@pytest.mark.parametrize("dtype,vec,B,want", [
    (torch.float32, 4, 128, "tf32x3"), (torch.float32, 4, 4096, "tf32x3"),
    (torch.float32, 1, 128, "fma"), (torch.bfloat16, 8, 512, "mma"),
    (torch.bfloat16, 8, 2047, "mma"), (torch.bfloat16, 8, 2048, "ring"),
    (torch.bfloat16, 8, 4096, "ring"), (torch.bfloat16, 1, 4096, "fma")])
def test_pre_pass_routes_by_type_width_and_rows(dtype, vec, B, want):
    """pre_pass names the kernel launch_att_h of csrc/att_step.cu takes:
    split TF32 for aligned f32, mma.sync below PRE_MANY_ROWS rows of aligned
    bf16 and the ring from there, FMAs at vector width 1."""
    assert att_step.pre_pass(dtype, vec, B) == want
    body = (_build.CSRC / "att_step.cu").read_text()
    body = body[body.index("int launch_att_h(const void* h"):]
    body = body[:body.index("\n}\n")]
    assert "B >= kPreManyRows" in body


def test_pre_pass_counts_reset_with_the_others():
    """A launch counts its pre-pass beside its kernel and width, in the
    same counts that reset_launches sets to 0."""
    _dispatch.reset_launches()
    _dispatch.count("attention", "vec", pre="ring")
    _dispatch.count("attention_q", "vec", pre="tf32x3")
    assert _dispatch.att_pre_launches() == {
        "att_h_tf32x3": 1, "att_h_mma": 0, "att_h_ring": 1, "att_h_fma": 0}
    assert sum(_dispatch.att_pre_launches().values()) == sum(
        _dispatch.launches()[k] for k in ("attention", "attention_q",
                                           "attention_kmajor"))
    _dispatch.reset_launches()
    assert not any(_dispatch.att_pre_launches().values())


# ---------------------------------------------------------------------------
# a model of the ring's barriers
# ---------------------------------------------------------------------------

class MBarrier:
    """An mbarrier: `count` arrivals and the announced bytes complete a
    phase; try_wait(parity) is true once the phase of that parity has
    completed (at first, the phase before phase 0 has)."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def _complete(self):
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count

    def arrive(self, expect_tx=0):
        assert self.pending > 0
        self.tx += expect_tx
        self.pending -= 1
        self._complete()

    def complete_tx(self, nbytes):
        self.tx -= nbytes
        assert self.tx >= 0
        self._complete()

    def try_wait(self, parity):
        return (self.phase & 1) != parity


def ring_model(nrows, K, slots, stages, seed, warps=8):
    """The stream kernel's producer warp and consumer warps (csrc/
    att_step.cu attention_kernel) over one block of `nrows` rows, stepped in
    a random order; copies land and the pre-pass completes at random
    steps.  Asserts the ring's invariants; returns the number of steps."""
    rng = random.Random(seed)
    cpt = -(-K // slots)
    cpr = 2 * cpt
    total = nrows * cpr
    full = [MBarrier(32) for _ in range(stages)]
    empty = [MBarrier(warps) for _ in range(stages)]
    stage_holds = [None] * stages      # the chunk whose copy has landed
    row_ah = [None] * stages           # the row whose att_h has landed
    row_side = [None] * stages         # the row whose side values are in
    released = [set() for _ in range(total)]  # warps done with a chunk
    pre_done = [False]
    in_flight = []  # (kind, stage, value, barrier, bytes)

    def producer():
        first = min(stages, total)

        def fill(c, with_ah):
            r, q = divmod(c, cpr)
            s = c % stages
            if c >= stages:  # the chunk the stage held is released by all
                assert released[c - stages] == set(range(warps)), c
            if q == 0:
                # the row slot's last row is done with everywhere
                if r >= stages:
                    last = (r - stages + 1) * cpr - 1
                    assert released[last] == set(range(warps)), (r, last)
                row_side[r % stages] = r
            nbytes = 100 + (50 if q == 0 else 0)
            full[s].arrive(expect_tx=nbytes)       # lane 0
            in_flight.append(("chunk", s, c, full[s], 100))
            if q == 0 and with_ah:
                assert pre_done[0]
                in_flight.append(("ah", r % stages, r, full[s], 50))
            for _ in range(31):                    # lanes 1-31
                full[s].arrive()

        for c in range(first):
            fill(c, False)
            yield
        while not pre_done[0]:                     # griddepcontrol.wait
            yield
        for r in range(0, (first - 1) // cpr + 1):
            in_flight.append(("ah", r % stages, r, full[(r * cpr) % stages],
                              50))
        for c in range(first, total):
            while not empty[c % stages].try_wait((c // stages - 1) & 1):
                yield
            fill(c, True)
            yield

    def consumer(w):
        cs, phase = 0, 0
        for c in range(total):
            r, q = divmod(c, cpr)
            while not full[cs].try_wait(phase):
                yield
            assert stage_holds[cs] == c, (w, c, stage_holds[cs])
            assert row_side[r % stages] == r
            if q < cpt:  # scores read the row's att_h
                assert row_ah[r % stages] == r and pre_done[0]
            released[c].add(w)
            empty[cs].arrive()
            cs += 1
            if cs == stages:
                cs, phase = 0, phase ^ 1
            yield

    actors = [producer()] + [consumer(w) for w in range(warps)]
    live = list(actors)
    steps = 0
    while live or in_flight:
        steps += 1
        assert steps < 200000, "the ring deadlocked"
        if not pre_done[0] and rng.random() < 0.02:
            pre_done[0] = True
        if in_flight and rng.random() < 0.3:
            kind, s, value, bar, nbytes = in_flight.pop(
                rng.randrange(len(in_flight)))
            if kind == "chunk":
                stage_holds[s] = value
            else:
                row_ah[s] = value
            bar.complete_tx(nbytes)
            continue
        if not live:
            continue
        actor = rng.choice(live)
        try:
            next(actor)
        except StopIteration:
            live.remove(actor)
    assert all(len(r) == warps for r in released)
    return steps


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("nrows,K,slots,stages", [
    (3, 36, 8, 8), (2, 36, 8, 4), (3, 1, 1, 8), (2, 196, 16, 6),
    (4, 9, 8, 2), (1, 36, 16, 3)])
def test_ring_barriers_keep_the_stages_and_att_h_in_order(nrows, K, slots,
                                                          stages, seed):
    assert ring_model(nrows, K, slots, stages, seed) > 0


# ---------------------------------------------------------------------------
# the kernels' order of operations, replayed
# ---------------------------------------------------------------------------

def butterfly(lanes):
    """The warp's xor-shuffle sum of 32 lane values [..., 32]."""
    v = lanes
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., torch.arange(32) ^ off]
    return v[..., 0]


def lane_strided(x):
    """[..., K] as [..., 32 lanes] sums, lane l holding k = l, l + 32, ..."""
    K = x.shape[-1]
    x = torch.nn.functional.pad(x, (0, -K % 32))
    return x.reshape(*x.shape[:-1], -1, 32).sum(dim=-2)


def f16(x):
    """Rounded to float16 and back to float32."""
    return x.half().float()


def packed_scores(st, ah, wa, ps):
    """The f16x2 scores of int8 slots st [nk, A] (the integers, as floats):
    a lane's 16 columns (a, a + 512, ...) in two groups of 8, the even and
    odd ones of a group summed in f16 and then into the lane's f32 sum."""
    nk, A = st.shape
    arg = f16(st * f16(ps)[:, None] + f16(ah)[None])
    terms = f16(torch.tanh(arg))
    w16 = f16(wa)
    per = terms.reshape(nk, -1, 32, 2, 4, 2)   # [slot, iter, lane, group,
    wper = w16.reshape(-1, 32, 2, 4, 2)        #  step, even/odd]
    s = torch.zeros(nk, 32)
    for it in range(per.shape[1]):
        for grp in range(2):
            part = torch.zeros(nk, 32, 2)
            for step in range(4):
                part = f16(per[:, it, :, grp, step] * wper[it, :, grp, step]
                           + part)
            s = s + (part[..., 0] + part[..., 1])
    return butterfly(s)


def replay(h, emb, p_att, wh, bh, wa, ba, masks, plan, scales=None,
           packed=False):
    """The pre-pass and the stream kernel of csrc/att_step.cu in PyTorch, for
    float32 inputs in the plan's layout, or an int8 context with its
    `scales` (emb_scale, p_scale) -- `packed`: a bf16 call's f16x2
    arithmetic.  The context is read only through `stream_copies` (byte
    offsets into the flat tensors) and a ring of `plan.stages` stages, a
    stage refilled once its chunk is consumed."""
    kmajor, vec = plan.kmajor, plan.vec
    K, B = (emb.shape[0], emb.shape[1]) if kmajor else \
        (emb.shape[1], emb.shape[0])
    H, A = emb.shape[2], p_att.shape[2]
    flat = {0: p_att.reshape(-1), 1: emb.reshape(-1)}
    width = {0: A, 1: H}
    item = emb.element_size()
    copies = att_step.stream_copies(plan, B, K, H, A, item)
    att_h = h @ wh + bh                      # the pre-pass: float32 [B, A]
    was = wa.reshape(-1)  # b_alpha moves every score alike: the softmax and
    # the kernel leave it out
    out = torch.empty(B, H)
    cpt = -(-K // plan.slots)
    # A and E at vector width: thread groups of slots share a column group;
    # the int8 context and width 1: one group
    split = att_step.col_split(H, vec) if vec > 1 and scales is None else 1
    for block in range(plan.grid):
        mine = np.flatnonzero(copies["block"] == block)
        by_chunk = {}
        for i in mine:
            by_chunk.setdefault(int(copies["chunk"][i]), []).append(i)
        total = len(by_chunk)
        ring = torch.full((plan.stages, plan.stage_bytes // item),
                          float("nan"))

        def fill(c):
            for i in by_chunk.get(c, ()):
                src, n, dst = (int(copies[k][i]) // item
                               for k in ("src_byte", "nbytes", "dst_byte"))
                ring[int(copies["stage"][i]), dst:dst + n] = \
                    flat[int(copies["tensor"][i])][src:src + n].float()

        for c in range(plan.stages):
            fill(c)
        for c in range(total):
            i0 = by_chunk[c][0]
            tensor, b = int(copies["tensor"][i0]), int(copies["row"][i0])
            k0 = min(int(copies["k0"][i]) for i in by_chunk[c])
            nk = sum(int(copies["nk"][i]) for i in by_chunk[c])
            q = c % (2 * cpt)
            st = ring[c % plan.stages, :nk * width[tensor]].reshape(
                nk, width[tensor]).clone()
            assert not torch.isnan(st).any()
            fill(c + plan.stages)  # released: the stage takes its next chunk
            if tensor == 0:
                if q == 0:
                    sc = torch.zeros(K)
                if packed:
                    sc[k0:k0 + nk] = packed_scores(
                        st, att_h[b], was, scales[1][b, k0:k0 + nk])
                    continue
                if scales is not None:  # dequantized in registers
                    st = st * scales[1][b, k0:k0 + nk, None]
                # a lane sums its column groups a, a + 32 vec, ..., even and
                # odd elements apart; the warp folds the 32 lane sums
                terms = torch.tanh(st + att_h[b]) * was
                pad = -A % (32 * vec)
                terms = torch.nn.functional.pad(terms, (0, pad)).reshape(
                    nk, -1, 32, vec)
                lanes = terms[..., 0::2].sum(dim=(1, 3)) + \
                    terms[..., 1::2].sum(dim=(1, 3))
                sc[k0:k0 + nk] = butterfly(lanes)
                continue
            if q == cpt:  # every warp: the row's maximum and normalizer
                mx = sc.max()
                e = torch.exp(sc - mx)
                tot = butterfly(lane_strided(
                    e * masks[b] if masks is not None else e))
                inv = 1.0 / tot
                acc = torch.zeros(split, H)
            w = torch.exp(sc[k0:k0 + nk] - mx) * inv
            if masks is not None:
                w = w * masks[b, k0:k0 + nk]
            if scales is not None:  # att_emb's scales in the weights
                w = w * scales[0][b, k0:k0 + nk]
            if packed:  # pairs in f16, into f32 every 8 slots
                for j0 in range(0, nk, 8):
                    part = torch.zeros(H)
                    for j in range(j0, min(nk, j0 + 8)):
                        part = f16(f16(w[j]) * st[j] + part)
                    acc[0] = acc[0] + part
            else:  # slot j of the chunk: thread group j % split, in order
                for j in range(nk):
                    acc[j % split] = acc[j % split] + w[j] * st[j]
            if q == 2 * cpt - 1:  # the groups' sums into group 0's
                total_row = acc[0].clone()
                for g in range(1, split):
                    total_row += acc[g]
                out[b] = total_row
    return out


def case(B, K, H, A, mask, seed=0):
    rng = np.random.RandomState(seed)
    f = np.float32
    a = dict(h=rng.randn(B, H).astype(f) * 0.5,
             emb=np.maximum(rng.randn(B, K, H), 0).astype(f),
             p_att=rng.randn(B, K, A).astype(f),
             wh=(rng.randn(H, A) / np.sqrt(H)).astype(f),
             bh=(rng.randn(A) * 0.1).astype(f),
             wa=(rng.randn(A, 1) / np.sqrt(A)).astype(f),
             ba=(rng.randn(1) * 0.1).astype(f))
    m = None
    if mask:
        m = np.ones((B, K), f)
        m[::3, K // 2:] = 0.0
        m[1, 1:] = 0.0
    a["masks"] = m
    return a


ORDER = ("h", "emb", "p_att", "wh", "bh", "wa", "ba", "masks")
# B, K, H, A, grid (None: the plan's), stages (None: the plan's)
REPLAY_SHAPES = [(13, 6, 96, 80, None, None), (10, 36, 64, 128, 3, 4),
                 (5, 64, 32, 32, 2, 2), (7, 1, 96, 80, 4, 3),
                 (6, 9, 100, 72, None, 5), (4, 5, 97, 83, 3, None)]
# the packed path: H and A multiples of 16 and of a lane's 16 columns x 32
PACKED_SHAPES = [(6, 36, 512, 512, 4, None), (5, 20, 1024, 512, None, 3),
                 (3, 1, 512, 1024, 2, 2)]


def run_replay(a, kmajor, grid, stages, quant=False, packed=False):
    """The replay of one case; `quant`: on the int8 context of
    `quantize_features` (b-major), whose plain version is
    `attention_reference_q`; `packed`: in a bf16 call's arithmetic."""
    t = [None if a[k] is None else torch.from_numpy(a[k]) for k in ORDER]
    B, K, H = a["emb"].shape
    A = a["p_att"].shape[2]
    plan = att_step.stream_plan(B, K, H, A, 1 if quant else 4, kmajor)
    if grid:
        plan = plan._replace(grid=grid, rows=-(-B // grid))
    if stages:
        plan = plan._replace(stages=stages)
    if quant:
        eq, se, pq, sp = att_step.quantize_features(t[1], t[2])
        return replay(t[0], eq, pq, *t[3:], plan, scales=(se, sp),
                      packed=packed)
    if kmajor:
        t[1] = t[1].movedim(0, 1).contiguous()
        t[2] = t[2].movedim(0, 1).contiguous()
    return replay(*t, plan)


@pytest.mark.parametrize("kmajor", [False, True], ids=["bmajor", "kmajor"])
@pytest.mark.parametrize("mask", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("B,K,H,A,grid,stages", REPLAY_SHAPES)
def test_stream_replay_matches_the_plain_version(B, K, H, A, grid, stages,
                                                 mask, kmajor):
    a = case(B, K, H, A, mask and K > 1)
    got = run_replay(a, kmajor, grid, stages)
    want = att_step.attention_reference(
        *(None if a[k] is None else torch.from_numpy(a[k]) for k in ORDER))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def plain_q(a):
    t = [None if a[k] is None else torch.from_numpy(a[k]) for k in ORDER]
    q = att_step.quantize_features(t[1], t[2])
    return att_step.attention_reference_q(t[0], *q, *t[3:])


@pytest.mark.parametrize("mask", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("B,K,H,A,grid,stages", REPLAY_SHAPES)
def test_stream_replay_q_matches_the_plain_version(B, K, H, A, grid, stages,
                                                   mask):
    """The int8 context through the same stream: 16 values a copy and a
    load where H and A are multiples of 16, one otherwise."""
    a = case(B, K, H, A, mask and K > 1)
    got = run_replay(a, False, grid, stages, quant=True)
    np.testing.assert_allclose(got.numpy(), plain_q(a).numpy(), **TOL)


@pytest.mark.parametrize("mask", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("B,K,H,A,grid,stages", PACKED_SHAPES)
def test_stream_replay_packed_matches_the_plain_version(B, K, H, A, grid,
                                                        stages, mask):
    """A bf16 call over the int8 context, in f16x2 (emulated): within
    TOL_F16 of the f32 plain version on the same quantized context, and
    apart from the f32 replay by the f16 roundings only."""
    a = case(B, K, H, A, mask and K > 1, seed=2)
    got = run_replay(a, False, grid, stages, quant=True, packed=True)
    want = plain_q(a)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL_F16)
    assert (got - want).abs().max().item() > 0  # the roundings are there


@pytest.mark.parametrize("B,itemsize,rows,per_sm_at_least", [
    (512, 1, 1, 4), (1024, 1, 2, 4), (4096, 1, 8, 4), (128, 1, 1, 1)])
def test_stream_plan_of_the_int8_context(B, itemsize, rows, per_sm_at_least):
    """The int8 context takes 16 slots a stage (the bytes of 8 bf16 slots,
    two a consumer warp) and the dense kernels' grid."""
    plan = att_step.stream_plan(B, 36, WIDTH, WIDTH, itemsize, False)
    assert plan.vec == 16 and plan.slots == 16 and plan.rows == rows
    assert plan.stage_bytes == 16 * WIDTH
    assert plan.grid == att_step.stream_plan(B, 36, WIDTH, WIDTH, 2,
                                             False).grid
    if plan.grid > 132:
        assert 228 * 1024 // (plan.smem_bytes + 1024) >= per_sm_at_least


@pytest.fixture(scope="module")
def jatt():
    """The JAX package's attention module (skips where JAX is missing)."""
    pytest.importorskip("jax")
    from cooperativeimagecaptioning_tpu.ops.pallas import att_step as ja
    return ja


@pytest.mark.parametrize("kmajor", [False, True], ids=["bmajor", "kmajor"])
@pytest.mark.parametrize("mask", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("B,K,H,A,grid,stages", REPLAY_SHAPES[:3])
def test_stream_replay_matches_jax(jatt, B, K, H, A, grid, stages, mask,
                                   kmajor):
    """Against the JAX package's reference and its Pallas kernel in interpret
    mode, as its own tests run the kernel on the CPU."""
    import jax.numpy as jnp
    a = case(B, K, H, A, mask, seed=1)
    got = run_replay(a, kmajor, grid, stages).numpy()
    jargs = [None if a[k] is None else jnp.asarray(a[k]) for k in ORDER]
    np.testing.assert_allclose(
        np.asarray(jatt.attention_reference(*jargs)), got, **TOL)
    np.testing.assert_allclose(
        np.asarray(jatt._attention_pallas(*jargs, use_mask=mask,
                                          interpret=True)), got, **TOL)


@pytest.mark.parametrize("mask", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("packed", [False, True], ids=["f32", "f16x2"])
def test_stream_replay_q_matches_jax(jatt, packed, mask):
    """The int8 replay (f32, and the bf16 calls' f16x2) against the JAX
    package's int8 Pallas kernel in interpret mode on the same quantized
    context: TOL, or TOL_F16 for the f16 emulation."""
    import jax.numpy as jnp
    B, K, H, A, grid, stages = PACKED_SHAPES[0]
    a = case(B, K, H, A, mask, seed=3)
    got = run_replay(a, False, grid, stages, quant=True,
                     packed=packed).numpy()
    t = [torch.from_numpy(a[k]) for k in ("emb", "p_att")]
    q = [jnp.asarray(x.numpy()) for x in att_step.quantize_features(*t)]
    w = [jnp.asarray(a[k]) for k in ("wh", "bh", "wa", "ba")]
    m = None if a["masks"] is None else jnp.asarray(a["masks"])
    want = np.asarray(jatt._attention_pallas_q(
        jnp.asarray(a["h"]), *q, *w, m, use_mask=mask, interpret=True))
    np.testing.assert_allclose(want, got, **(TOL_F16 if packed else TOL))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,H,A", [
    (13, 6, 96, 80), (4099, 36, 512, 512), (37, 5, 100, 72),
    (33, 7, 97, 83), (140, 36, 1024, 256), (3, 3, 4000, 64), (9, 64, 96, 80)])
def test_dense_kernels_on_the_card(cuda, dtype, B, K, H, A):
    """The pre-pass against h @ W + b, kernels A and E against the plain
    version, masked and unmasked, and the vector width each launch took."""
    a = case(B, K, H, A, True)
    t = [torch.from_numpy(a[k]).to(cuda) for k in ORDER]
    t = [x.to(dtype) for x in t[:7]] + [t[7]]
    h, emb, p_att, wh, bh = t[:5]
    got = att_step.att_h_kernel(h, wh, bh)
    want = h.float() @ wh.float() + bh.float()
    assert (got - want).abs().max().item() <= \
        (1e-5 if dtype == torch.float32 else 3e-2)
    emb_t = emb.movedim(0, 1).contiguous()
    p_t = p_att.movedim(0, 1).contiguous()
    width = "vec" if att_step.vector_width(H, A, h.element_size()) > 1 \
        else "scalar"
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for masks in (t[7], None):
        _dispatch.reset_launches()
        out_a = att_step.fused_attention(h, emb, p_att, *t[3:7], masks)
        out_e = att_step.fused_attention_kmajor(h, emb_t, p_t, *t[3:7], masks)
        torch.cuda.synchronize()
        widths = _dispatch.att_width_launches()
        assert {k for k, v in widths.items() if v} == {
            f"attention_{width}", f"attention_kmajor_{width}"}
        ref = att_step.attention_reference(h, emb, p_att, *t[3:7], masks)
        for out in (out_a, out_e):
            assert out.dtype == dtype
            assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1, 36, 196])
@pytest.mark.parametrize("B", [1, 7, 128, 512, 4099])
def test_attention_kernels_on_the_card(cuda, B, K, dtype):
    """A, D and E against their plain versions at the paths' width, masked
    and unmasked, at ragged B, B = 1 and K up to the 14 x 14 grid: f32
    within 1e-4, bf16 within 3e-2; each launch at the vector width."""
    a = case(B, K, WIDTH, WIDTH, K > 1)
    t = [torch.from_numpy(a[k]).to(cuda) if a[k] is not None else None
         for k in ORDER]
    t = [x.to(dtype) for x in t[:7]] + [t[7]]
    h, emb, p_att, w = t[0], t[1], t[2], t[3:7]
    q = att_step.quantize_features(emb, p_att)
    emb_t = emb.movedim(0, 1).contiguous()
    p_t = p_att.movedim(0, 1).contiguous()
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for masks in (t[7], None):
        _dispatch.reset_launches()
        outs = {
            "attention": (att_step.fused_attention(h, emb, p_att, *w, masks),
                          att_step.attention_reference(h, emb, p_att, *w,
                                                       masks)),
            "attention_q": (att_step.fused_attention_q(h, *q, *w, masks),
                            att_step.attention_reference_q(h, *q, *w, masks)),
            "attention_kmajor": (
                att_step.fused_attention_kmajor(h, emb_t, p_t, *w, masks),
                att_step.attention_reference(h, emb, p_att, *w, masks))}
        torch.cuda.synchronize()
        widths = _dispatch.att_width_launches()
        pre = f"att_h_{att_step.pre_pass(dtype, 16 // h.element_size(), B)}"
        assert _dispatch.att_pre_launches()[pre] == 3
        for name, (got, want) in outs.items():
            assert widths[f"{name}_vec"] == 1, (name, widths)
            assert got.dtype == dtype and got.shape == (B, WIDTH)
            err = (got.float() - want.float()).abs().max().item()
            assert err <= tol, (name, B, K, masks is not None, err)
