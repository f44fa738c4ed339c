"""The stream design of the attention kernels (b-major A, K-major E, int8 D)
of csrc/att_step.cu, as far as the CPU can hold it:

* `att_step.stream_plan` / `stream_copies`: under every plan each (row, slot,
  element) of p_att and att_emb is copied into shared memory exactly once,
  from where the layout puts it, in 16-byte aligned multiples of 16 bytes on
  the vector path, into a stage it fits, inside the shared memory a block may
  have, by a grid that covers B;
* a replay in PyTorch of the kernels' order of operations (the att_h pre-pass
  in float32; the chunks of a block's rows through the ring, each stage
  refilled `stages - 1` chunks ahead as the kernel refills it; a score as 32
  lane sums folded by the warp's butterfly; the weighted sum as one partial a
  thread group, reduced at the row's end) against the port's plain version
  and the JAX package's reference and Pallas kernel (interpret mode) on
  numpy-seeded inputs; for the int8 context the same replay at one byte an
  element, the p_att chunks dequantized by their slots' scales and the
  att_emb scales folded into the weights.

Tolerance 1e-5 (atol = rtol): everything is float32 on both sides; only the
order of the sums differs.  On a CUDA card only (marked `cuda`, skipped
elsewhere): the pre-pass and both kernels against their plain versions at
aligned and unaligned widths, f32 within 1e-4 and bf16 within 3e-2 as in
tests/test_torch_kernels.py, and the width each launch took."""

import re

import numpy as np
import pytest
import torch

from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
    _build, _dispatch, att_step)

TOL = dict(atol=1e-5, rtol=1e-5)
PLAN_B = (1, 7, 128, 256, 512, 640, 1024, 4096, 4099)
PLAN_K = (1, 36, 64, 196, 256)
WIDTH = 512


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


@pytest.mark.parametrize("kmajor", [False, True], ids=["bmajor", "kmajor"])
@pytest.mark.parametrize("itemsize", [4, 2, 1], ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("K", PLAN_K)
@pytest.mark.parametrize("B", PLAN_B)
def test_stream_plan_copies_the_context_once(B, K, itemsize, kmajor):
    H = A = WIDTH
    plan = att_step.stream_plan(B, K, H, A, itemsize, kmajor)
    assert plan.vec == 16 // itemsize and plan.kmajor == kmajor
    assert plan.rows >= 1 and plan.grid * plan.rows >= B \
        and (plan.grid - 1) * plan.rows < B
    assert 1 <= plan.slots <= K and 2 <= plan.stages <= att_step.MAX_STAGES
    assert plan.smem_bytes <= att_step.MAX_SMEM == 227 * 1024
    copies = att_step.stream_copies(plan, B, K, H, A, itemsize)
    for tensor, width in ((0, A), (1, H)):
        count = covered(copies, tensor, B, K, kmajor, width, itemsize)
        assert (count == 1).all()
    # the vector path: 16-byte aligned multiples of 16 bytes, both ends
    for key in ("src_byte", "nbytes", "dst_byte"):
        assert (copies[key] % 16 == 0).all(), key
    assert (copies["dst_byte"] + copies["nbytes"] <= plan.stage_bytes).all()
    np.testing.assert_array_equal(copies["block"], copies["row"] // plan.rows)
    np.testing.assert_array_equal(copies["stage"],
                                  copies["chunk"] % plan.stages)
    # a row's p_att chunks come before its att_emb chunks, rows in order
    cpt = -(-K // plan.slots)
    local = copies["row"] % plan.rows
    np.testing.assert_array_equal(copies["chunk"] // (2 * cpt), local)
    np.testing.assert_array_equal(
        (copies["chunk"] % (2 * cpt)) // cpt, copies["tensor"])


@pytest.mark.parametrize("B,K,H,A,itemsize", [
    (13, 6, 97, 83, 4), (13, 6, 97, 83, 2), (9, 64, 100, 72, 2),
    (5, 3, 4000, 64, 4), (300, 36, 4096, 2048, 2)])
def test_stream_plan_of_unaligned_shapes_takes_width_one(B, K, H, A, itemsize):
    """Widths that are no multiple of 16 bytes, or wider than one column
    group a thread, take the same kernel at vector width 1: the same plan
    rules, element-wise copies."""
    assert att_step.vector_width(H, A, itemsize) == 1
    plan = att_step.stream_plan(B, K, H, A, itemsize, False)
    assert plan.vec == 1 and plan.smem_bytes <= att_step.MAX_SMEM
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
    (1024, 512, 4, True, 4), (1028, 512, 4, True, 1)])
def test_vector_width(H, A, itemsize, aligned, want):
    assert att_step.vector_width(H, A, itemsize, aligned) == want


@pytest.mark.parametrize("B,itemsize,rows,per_sm_at_least", [
    (128, 4, 1, 1), (256, 4, 1, 3), (640, 4, 1, 3), (512, 2, 1, 4),
    (1024, 2, 1, 4), (4096, 2, 4, 4)])
def test_stream_plan_fills_the_card(B, itemsize, rows, per_sm_at_least):
    """At the shapes the paths run (K=36, H=A=512, 132 SMs) a block takes
    one row up to B=1024, so the grid is B blocks; several blocks fit an SM
    beside each other wherever the grid has more blocks than SMs."""
    plan = att_step.stream_plan(B, 36, WIDTH, WIDTH, itemsize, False)
    assert plan.rows == rows and plan.slots == 8
    assert plan.grid >= min(B, 132)
    per_sm = 1
    if plan.grid > 132:
        # an SM has 228 KiB for its blocks, each with 1 KiB reserved
        per_sm = 228 * 1024 // (plan.smem_bytes + 1024)
        assert per_sm >= per_sm_at_least
    # bytes in flight an SM: stages - 1 chunks a block
    assert per_sm * (plan.stages - 1) * plan.stage_bytes >= 32 * 1024


@pytest.mark.parametrize("py,name", [
    (att_step.MAX_K, "kMaxK"), (att_step.THREADS, "kThreads"),
    (att_step.MAX_STAGES, "kMaxStages"), (att_step.MAX_SPLIT, "kMaxSplit"),
    (att_step.MAX_COLS, "kMaxCols"), (att_step.MAX_SMEM, "kMaxSmem")])
def test_stream_constants_match_the_c_source(py, name):
    consts = {}
    for key, expr in re.findall(r"constexpr int (\w+) = ([^;]+);",
                                (_build.CSRC / "att_step.cu").read_text()):
        consts[key] = eval(expr, {}, dict(consts))  # noqa: S307 (own source)
    assert consts[name] == py


# ---------------------------------------------------------------------------
# the kernels' order of operations, replayed
# ---------------------------------------------------------------------------

def butterfly(lanes):
    """The warp's xor-shuffle sum of 32 lane values [..., 32]."""
    v = lanes
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., torch.arange(32) ^ off]
    return v[..., 0]


def replay(h, emb, p_att, wh, bh, wa, ba, masks, plan, scales=None):
    """The pre-pass and the stream kernel of csrc/att_step.cu in PyTorch, for
    float32 inputs in the plan's layout, or an int8 context with its
    `scales` (emb_scale, p_scale).  The context is read only through
    `stream_copies` (byte offsets into the flat tensors) and a ring of
    `plan.stages` stages that is refilled in the kernel's order."""
    kmajor, vec = plan.kmajor, plan.vec
    K, B = (emb.shape[0], emb.shape[1]) if kmajor else \
        (emb.shape[1], emb.shape[0])
    H, A = emb.shape[2], p_att.shape[2]
    flat = {0: p_att.reshape(-1), 1: emb.reshape(-1)}
    width = {0: A, 1: H}
    item = emb.element_size()
    copies = att_step.stream_copies(plan, B, K, H, A, item)
    att_h = h @ wh + bh                      # the pre-pass: float32 [B, A]
    was, b_alpha = wa.reshape(-1), ba.reshape(())
    split = att_step.col_split(H, vec)
    groups = H // vec
    out = torch.empty(B, H)
    cpt = -(-K // plan.slots)
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

        for c in range(plan.stages - 1):
            fill(c)
        for c in range(total):
            fill(c + plan.stages - 1)
            i0 = by_chunk[c][0]
            tensor, b = int(copies["tensor"][i0]), int(copies["row"][i0])
            k0 = min(int(copies["k0"][i]) for i in by_chunk[c])
            nk = sum(int(copies["nk"][i]) for i in by_chunk[c])
            q = c % (2 * cpt)
            st = ring[c % plan.stages, :nk * width[tensor]].reshape(
                nk, width[tensor])
            assert not torch.isnan(st).any()
            if tensor == 0:
                if q == 0:
                    sc = torch.zeros(K)
                if scales is not None:  # dequantized in registers
                    st = st * scales[1][b, k0:k0 + nk, None]
                # a lane sums its column groups a, a + 32 vec, ...; the warp
                # folds the 32 lane sums
                terms = torch.tanh(st + att_h[b]) * was
                pad = -A % (32 * vec)
                terms = torch.nn.functional.pad(terms, (0, pad)).reshape(
                    nk, -1, 32, vec)
                sc[k0:k0 + nk] = butterfly(terms.sum(dim=(1, 3))) + b_alpha
                continue
            if q == cpt:
                w = torch.softmax(sc, dim=0)
                if masks is not None:
                    w = w * masks[b]
                    w = w / w.sum()
                if scales is not None:  # att_emb's scales in the weights
                    w = w * scales[0][b]
                acc = torch.zeros(split, H)
            for j in range(nk):  # slot j of the chunk: group j % split
                acc[j % split] += w[k0 + j] * st[j]
            if q == 2 * cpt - 1:
                total_row = acc[0].clone()
                for g in range(1, split):
                    total_row += acc[g]
                out[b] = total_row
        assert groups * vec == H
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
# B, K, H, A, rows a block (None: the plan's), stages (None: the plan's)
REPLAY_SHAPES = [(13, 6, 96, 80, None, None), (10, 36, 64, 128, 3, 4),
                 (5, 64, 32, 32, 2, 2), (7, 1, 96, 80, 4, 3),
                 (6, 9, 100, 72, None, 5), (4, 5, 97, 83, 3, None)]


def run_replay(a, kmajor, rows, stages, quant=False):
    """The replay of one case; `quant`: on the int8 context of
    `quantize_features` (b-major), whose plain version is
    `attention_reference_q`."""
    t = [None if a[k] is None else torch.from_numpy(a[k]) for k in ORDER]
    B, K, H = a["emb"].shape
    A = a["p_att"].shape[2]
    plan = att_step.stream_plan(B, K, H, A, 1 if quant else 4, kmajor)
    if rows:
        plan = plan._replace(rows=rows, grid=-(-B // rows))
    if stages:
        plan = plan._replace(stages=stages)
    if quant:
        eq, se, pq, sp = att_step.quantize_features(t[1], t[2])
        return replay(t[0], eq, pq, *t[3:], plan, scales=(se, sp))
    if kmajor:
        t[1] = t[1].movedim(0, 1).contiguous()
        t[2] = t[2].movedim(0, 1).contiguous()
    return replay(*t, plan)


@pytest.mark.parametrize("kmajor", [False, True], ids=["bmajor", "kmajor"])
@pytest.mark.parametrize("mask", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("B,K,H,A,rows,stages", REPLAY_SHAPES)
def test_stream_replay_matches_the_plain_version(B, K, H, A, rows, stages,
                                                 mask, kmajor):
    a = case(B, K, H, A, mask and K > 1)
    got = run_replay(a, kmajor, rows, stages)
    want = att_step.attention_reference(
        *(None if a[k] is None else torch.from_numpy(a[k]) for k in ORDER))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("mask", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("B,K,H,A,rows,stages", REPLAY_SHAPES)
def test_stream_replay_q_matches_the_plain_version(B, K, H, A, rows, stages,
                                                   mask):
    """The int8 context through the same stream: 16 values a copy and a
    load where H and A are multiples of 16, one otherwise."""
    a = case(B, K, H, A, mask and K > 1)
    got = run_replay(a, False, rows, stages, quant=True)
    t = [None if a[k] is None else torch.from_numpy(a[k]) for k in ORDER]
    q = att_step.quantize_features(t[1], t[2])
    want = att_step.attention_reference_q(t[0], *q, *t[3:])
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("B,rows,per_sm_at_least", [
    (512, 1, 4), (1024, 1, 4), (4096, 4, 4), (128, 1, 1)])
def test_stream_plan_of_the_int8_context(B, rows, per_sm_at_least):
    """The int8 context takes 16 slots a stage (the bytes of 8 bf16 slots)
    and the dense kernels' rows and grid."""
    plan = att_step.stream_plan(B, 36, WIDTH, WIDTH, 1, False)
    assert plan.vec == 16 and plan.slots == 16 and plan.rows == rows
    assert plan.stage_bytes == 16 * WIDTH
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
@pytest.mark.parametrize("B,K,H,A,rows,stages", REPLAY_SHAPES[:3])
def test_stream_replay_matches_jax(jatt, B, K, H, A, rows, stages, mask,
                                   kmajor):
    """Against the JAX package's reference and its Pallas kernel in interpret
    mode, as its own tests run the kernel on the CPU."""
    import jax.numpy as jnp
    a = case(B, K, H, A, mask, seed=1)
    got = run_replay(a, kmajor, rows, stages).numpy()
    jargs = [None if a[k] is None else jnp.asarray(a[k]) for k in ORDER]
    np.testing.assert_allclose(
        np.asarray(jatt.attention_reference(*jargs)), got, **TOL)
    np.testing.assert_allclose(
        np.asarray(jatt._attention_pallas(*jargs, use_mask=mask,
                                          interpret=True)), got, **TOL)


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
