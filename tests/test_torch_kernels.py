"""The port's kernel modules: each plain PyTorch version against its JAX
counterpart (the Pallas kernel in interpret mode, and the JAX reference) on
the CPU in float32, the CPU dispatch policy, the ctypes binding table
against the C sources, and -- on a CUDA card only -- each hand-written
kernel against its plain version.

Tolerances: float outputs atol = rtol = 1e-5 (both sides f32; JAX at
"highest" matmul precision), ids exactly equal.  On the card: f32 outputs
within 1e-4 (summation order only), bf16 attention (all three layouts)
within 3e-2 (1-2 bf16 ulps; both sides round the f32 result to bf16),
planted ties exactly."""

import re

import numpy as np
import pytest
import torch

from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
    _build, _dispatch, att_step, beam_head, cell_step, head_merge,
    logit_head)
from cooperativeimagecaptioning_tpu_torch.utils import build_dirs

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernel modules (skips where JAX is missing, as on
    a machine with a card)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from cooperativeimagecaptioning_tpu.ops.pallas import att_step as ja
    from cooperativeimagecaptioning_tpu.ops.pallas import beam_head as jb
    from cooperativeimagecaptioning_tpu.ops.pallas import cell_step as jc
    from cooperativeimagecaptioning_tpu.ops.pallas import logit_head as jl
    return dict(jax=jax, jnp=jnp, att=ja, beam=jb, cell=jc, logit=jl)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _fresh_counts():
    _dispatch.reset_launches()
    yield
    _dispatch.reset_launches()


def att_case(B=16, K=6, H=32, A=16, mask="partial", seed=0):
    rng = np.random.RandomState(seed)
    f = np.float32
    arrs = dict(h=rng.randn(B, H).astype(f) * 0.5,
                emb=np.maximum(rng.randn(B, K, H), 0).astype(f),
                p_att=rng.randn(B, K, A).astype(f),
                wh=(rng.randn(H, A) / np.sqrt(H)).astype(f),
                bh=(rng.randn(A) * 0.1).astype(f),
                wa=(rng.randn(A, 1) / np.sqrt(A)).astype(f),
                ba=(rng.randn(1) * 0.1).astype(f))
    m = None
    if mask != "none":
        m = np.ones((B, K), f)
        if mask == "partial":
            m[::3, K // 2:] = 0.0
            m[1, 1:] = 0.0
    arrs["masks"] = m
    return arrs


ATT_ORDER = ("h", "emb", "p_att", "wh", "bh", "wa", "ba", "masks")


def as_torch(arrs, device="cpu", dtype=None):
    out = []
    for k in ATT_ORDER:
        v = arrs[k]
        if v is None:
            out.append(None)
            continue
        t = torch.from_numpy(np.array(v)).to(device)
        if dtype is not None and k != "masks" and t.is_floating_point():
            t = t.to(dtype)
        out.append(t)
    return out


@pytest.mark.parametrize("mask", ["none", "ones", "partial"])
def test_attention_reference_matches_jax(jx, mask):
    a = att_case(mask=mask)
    jnp = jx["jnp"]
    jargs = [None if a[k] is None else jnp.asarray(a[k]) for k in ATT_ORDER]
    want_ref = jx["att"].attention_reference(*jargs)
    want_kernel = jx["att"]._attention_pallas(
        *jargs, use_mask=a["masks"] is not None, interpret=True)
    got = att_step.attention_reference(*as_torch(a))
    np.testing.assert_allclose(np.asarray(want_ref), got.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(want_kernel), got.numpy(), **TOL)


def test_attention_mask_is_multiply_then_renormalize():
    """Softmax over the full row, times the mask, renormalized: for a row
    with one valid slot the output is exactly that slot's features."""
    a = att_case(mask="partial")
    out = att_step.attention_reference(*as_torch(a)).numpy()
    np.testing.assert_allclose(out[1], a["emb"][1, 0], **TOL)


def head_case(B=16, H=32, V=150, seed=0, ties=False):
    rng = np.random.RandomState(seed)
    h = rng.randn(B, H).astype(np.float32)
    w = (rng.randn(H, V) * 0.3).astype(np.float32)
    b = (rng.randn(V) * 0.3).astype(np.float32)
    planted = []
    if ties:
        # zero columns with equal biases tie exactly in any summation order;
        # expected order: [3, 70, 149, 5, 90]
        planted = [3, 70, V - 1, 5, 90]
        w[:, planted] = 0.0
        b[planted[:3]] = 50.0
        b[planted[3:]] = 40.0
    return h, w, b, planted


@pytest.mark.parametrize("ties", [False, True])
def test_greedy_head_reference_matches_jax(jx, ties):
    h, w, b, planted = head_case(ties=ties)
    jnp = jx["jnp"]
    jh, jw, jb = jnp.asarray(h), jnp.asarray(w), jnp.asarray(b)
    it, lp = logit_head.greedy_head_reference(*map(torch.from_numpy,
                                                   (h, w, b)))
    assert it.dtype == torch.int32 and lp.dtype == torch.float32
    for j_it, j_lp in (
            jx["logit"].greedy_head_reference(jh, jw, jb),
            jx["logit"].greedy_head_pallas(jh, jw, jb, block_b=8,
                                           block_v=128, interpret=True),
            jx["logit"].greedy_head_pallas_resident(jh, jw, jb, block_b=8,
                                                    interpret=True)):
        np.testing.assert_array_equal(np.asarray(j_it), it.numpy())
        np.testing.assert_allclose(np.asarray(j_lp), lp.numpy(), **TOL)
    if ties:
        assert (it.numpy() == planted[0]).all()


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6])
def test_beam_head_reference_matches_jax(jx, m):
    h, w, b, planted = head_case(seed=m, ties=(m % 2 == 0))
    jnp = jx["jnp"]
    jv, ji, jl = jx["beam"].beam_head_pallas(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), m, block_b=8,
        interpret=True)
    rv, ri, rl = jx["beam"].beam_head_reference(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b), m)
    vals, idx, lse = beam_head.beam_head_reference(
        *map(torch.from_numpy, (h, w, b)), m)
    assert idx.dtype == torch.int32
    for want_v, want_i, want_l in ((jv, ji, jl), (rv, ri, rl)):
        np.testing.assert_array_equal(np.asarray(want_i), idx.numpy())
        np.testing.assert_allclose(np.asarray(want_v), vals.numpy(), **TOL)
        np.testing.assert_allclose(np.asarray(want_l), lse.numpy(), **TOL)
    if planted:
        n = min(m, len(planted))
        assert (idx.numpy()[:, :n] == np.asarray(planted[:n])[None]).all()


@pytest.mark.parametrize("with_att", [True, False])
def test_cell_reference_matches_jax(jx, with_att):
    rng = np.random.RandomState(3)
    B, D, H = 8, 24, 32
    f = np.float32
    xt, h, c = (rng.randn(B, D).astype(f), rng.randn(B, H).astype(f),
                rng.randn(B, H).astype(f))
    wi, bi = (rng.randn(D, 5 * H) * 0.2).astype(f), rng.randn(5 * H).astype(f)
    wh, bh = (rng.randn(H, 5 * H) * 0.2).astype(f), rng.randn(5 * H).astype(f)
    ar = rng.randn(B, H).astype(f) if with_att else None
    wc = (rng.randn(H, 2 * H) * 0.2).astype(f) if with_att else None
    bc = rng.randn(2 * H).astype(f) if with_att else None
    args = (xt, h, c, ar, wi, bi, wh, bh, wc, bc)
    jnp = jx["jnp"]
    jargs = [None if x is None else jnp.asarray(x) for x in args]
    targs = [None if x is None else torch.from_numpy(x) for x in args]
    th, tc = cell_step.cell_reference(*targs)
    for jh, jc in (jx["cell"].cell_reference(*jargs),
                   jx["cell"]._cell_pallas(*jargs, use_att=with_att,
                                           interpret=True)):
        np.testing.assert_allclose(np.asarray(jh), th.numpy(), **TOL)
        np.testing.assert_allclose(np.asarray(jc), tc.numpy(), **TOL)


def test_cpu_tensors_take_the_plain_versions():
    a = as_torch(att_case())
    np.testing.assert_array_equal(att_step.fused_attention(*a).numpy(),
                                  att_step.attention_reference(*a).numpy())
    h, w, b, _ = head_case(ties=True)
    h, w, b = map(torch.from_numpy, (h, w, b))
    for got, want in zip(logit_head.greedy_head(h, w, b),
                         logit_head.greedy_head_reference(h, w, b)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    for got, want in zip(beam_head.beam_head(h, w, b, 3),
                         beam_head.beam_head_reference(h, w, b, 3)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    # no kernel ran: the counts move only where a kernel launches
    assert _dispatch.launches() == {k: 0 for k in _dispatch.KERNELS}


def test_wrappers_refuse_what_the_kernels_do_not_take():
    # the attention has a gradient now (att_step.Attention); the heads are
    # decode-only and still refuse a grad-requiring input
    a = as_torch(att_case())
    a[0] = a[0].clone().requires_grad_(True)
    assert att_step.fused_attention(*a).requires_grad
    h, w, b, _ = head_case(ties=True)
    h, w, b = map(torch.from_numpy, (h, w, b))
    # a beam head of more than 16 candidates is taken (the JAX head takes
    # any m) and is the plain top-k; only kk outside 1..V is refused
    got = beam_head.beam_head(h, w, b, 17)
    want = beam_head.top_k(logit_head.logits_f32(h, w, b), 17)
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    for kk in (0, w.shape[1] + 1):
        with pytest.raises(ValueError, match="kk"):
            beam_head.beam_head(h, w, b, kk)
    with pytest.raises(RuntimeError, match="forward-only"):
        logit_head.greedy_head(h, w.clone().requires_grad_(True), b)
    with pytest.raises(ValueError, match="device"):
        _dispatch.use_kernel(torch.empty(1, device="meta"))


@pytest.mark.parametrize("head", ["greedy_head", "beam_head"])
@pytest.mark.parametrize("which", [0, 1, 2])
def test_heads_stay_forward_only(head, which):
    """_dispatch.forward_only still guards the two vocabulary heads: any of
    h, w, b requiring grad is refused."""
    h, w, b, _ = head_case()
    args = [torch.from_numpy(x) for x in (h, w, b)]
    args[which] = args[which].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        if head == "greedy_head":
            logit_head.greedy_head(*args)
        else:
            beam_head.beam_head(*args, 2)


def _c_params(name):
    """Parameter count of a CIC_EXPORT entry point in csrc/."""
    for src in _build.CSRC.glob("*.cu"):
        m = re.search(r"CIC_EXPORT\s+int\s+" + name + r"\s*\(([^)]*)\)",
                      src.read_text())
        if m:
            return len([p for p in m.group(1).split(",") if p.strip()])
    raise AssertionError(f"{name} not exported by any csrc/*.cu")


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_ctypes_table_matches_the_c_sources(name):
    """A wrong argtypes list would pass garbage (or cut pointers) without
    any error: the table must match each C declaration's arity."""
    assert len(_build.SIGNATURES[name]) == _c_params(name)


@pytest.mark.parametrize("py,src,name", [
    (att_step.MAX_K, "att_step.cu", "kMaxK"),
    (logit_head.CHUNK, "vocab_head.cuh", "kChunk"),
    (logit_head.ROW_TILE, "logit_head.cu", "kGreedyRows"),
    (beam_head.ROW_TILE, "beam_head.cu", "kBeamRows"),
    (beam_head.ROUND_KK, "beam_head.cu", "kRoundKK"),
    (logit_head.MMA_ROW_TILE, "vocab_head_tma.cuh", "kTmaRows"),
    (logit_head.TMA_COL_TILE, "vocab_head_tma.cuh", "kTmaCols"),
    (logit_head.TMA_DEPTH, "vocab_head_tma.cuh", "kTmaBoxK"),
    (logit_head.TMA_MAX_DEPTH, "vocab_head_tma.cuh", "kTmaMaxDepth"),
    (logit_head.MMA_ROW_TILE, "vocab_head_tf32.cuh", "kTf32Rows"),
    (logit_head.TF32_COL_TILE, "vocab_head_tf32.cuh", "kTf32Cols"),
    (logit_head.TF32_DEPTH, "vocab_head_tf32.cuh", "kTf32Depth"),
    (logit_head.PASS_CODES["fma"], "vocab_head.cuh", "kPassFma"),
    (logit_head.PASS_CODES["tma"], "vocab_head.cuh", "kPassTma"),
    (logit_head.PASS_CODES["tf32x3"], "vocab_head.cuh", "kPassTf32")])
def test_python_constants_match_the_c_sources(py, src, name):
    """The wrappers size grids and scratch from these; they must be the
    kernels' own values."""
    consts = {}
    for key, expr in re.findall(r"constexpr int (\w+) = ([^;]+);",
                                (_build.CSRC / src).read_text()):
        try:   # a template's constants name its parameters
            consts[key] = eval(expr, {}, dict(consts))  # noqa: S307
        except (NameError, SyntaxError):
            pass
    assert consts[name] == py


def test_build_hash_tracks_the_sources(tmp_path, monkeypatch):
    assert {p.name for p in _build.sources()} >= {
        "att_step.cu", "logit_head.cu", "beam_head.cu", "cell_step.cu",
        "common.cuh", "vocab_head.cuh", "vocab_head_tma.cuh",
        "logit_head_tma.cu", "beam_head_tma.cu", "vocab_head_tf32.cuh",
        "logit_head_tf32.cu", "beam_head_tf32.cu"}
    before = _build.source_hash()
    fake = tmp_path / "csrc"
    fake.mkdir()
    for p in _build.sources():
        (fake / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", fake)
    assert _build.source_hash() == before
    (fake / "att_step.cu").write_text(
        (fake / "att_step.cu").read_text() + "\n// edited\n")
    assert _build.source_hash() != before


def test_tf32_pass_fits_the_shared_memory_of_a_block():
    """The split-TF32 pass's ring (each stage a [128 x 32] block of h, rows
    padded to 36 floats, and a [32 x 72] block of W) stays within the 227
    KB a block may ask for, whatever H (h streams); its row strides put a
    fragment load's 32 lanes on 32 distinct banks."""
    src = (_build.CSRC / "vocab_head_tf32.cuh").read_text()
    consts = {}
    for key, expr in re.findall(r"constexpr int (kTf32\w+) =\s*([^;]+);",
                                src):
        consts[key] = eval(expr, {}, dict(consts))  # noqa: S307 (own source)
    rows, depth, cols = (consts[k] for k in ("kTf32Rows", "kTf32Depth",
                                             "kTf32Cols"))
    hs, ws = consts["kTf32HStride"], consts["kTf32WStride"]
    assert consts["kTf32StageFloats"] == rows * hs + depth * ws
    assert hs >= depth and ws >= cols
    assert 4 * consts["kTf32Stages"] * consts["kTf32StageFloats"] <= 232448
    assert rows == 16 * consts["kTf32Threads"] // 32
    assert consts["kTf32Stages"] >= 2
    # A fragment: lane (g, t) reads h row g, k t; B: W row k t, column g
    assert len({(g * hs + t) % 32 for g in range(8) for t in range(4)}) == 32
    assert len({(t * ws + g) % 32 for g in range(8) for t in range(4)}) == 32


@pytest.mark.parametrize("head,src,kind", [
    ("greedy", "logit_head_tma.cu", "tma"),
    ("beam", "beam_head_tma.cu", "tma"),
    ("greedy", "logit_head_tf32.cu", "tf32"),
    ("beam", "beam_head_tf32.cu", "tf32")])
def test_mma_pass_is_defined_where_it_is_declared(head, src, kind):
    """vocab_head.cuh declares each tensor-core pass's two host functions;
    a source of its own defines each (so that nvcc compiles them in
    parallel) and the head's entry point calls it."""
    name = f"{head}_partials_{kind}"
    assert re.search(r"int " + name + r"\(", (_build.CSRC / "vocab_head.cuh")
                     .read_text())
    assert re.search(r"int cic::" + name + r"\(",
                     (_build.CSRC / src).read_text())
    entry = (_build.CSRC / src.replace(f"_{kind}", "")).read_text()
    assert f"cic::{name}(" in entry


@pytest.mark.parametrize("src", ["beam_head_tma.cu", "beam_head_tf32.cu"])
def test_beam_mma_pass_compiles_every_slot_count(src):
    src = (_build.CSRC / src).read_text()
    assert tuple(int(k) for k in re.findall(r"CIC_SLOTS\((\d+)\);", src)) \
        == beam_head.SLOTS
    # and the later rounds of the longest list
    assert "<16, true>" in src


def test_kernel_resources_reads_the_ptxas_log():
    log = """
ptxas info    : Compiling entry function '_ZN3fooILi16EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN3fooILi16EEEvPKf
    240 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 254 registers, used 1 barriers, 240 bytes cumulative
ptxas info    : Compiling entry function 'bar' for 'sm_90a'
ptxas info    : Function properties for bar
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 0 barriers
"""
    assert _build.kernel_resources(log) == {
        "_ZN3fooILi16EEEvPKf": {"registers": 254, "stack_bytes": 240,
                                "spill_bytes": 12},
        "bar": {"registers": 48, "stack_bytes": 0, "spill_bytes": 0}}
    assert _build.kernel_resources("nothing compiled") == {}


def test_build_hash_tracks_the_compiler():
    assert (_build.source_hash("Cuda compilation tools, release 12.4")
            != _build.source_hash("Cuda compilation tools, release 12.8"))


def test_build_refuses_outside_a_checkout(tmp_path, monkeypatch):
    """An installed copy of the package has no checkout to build into: it
    builds under the per-user cache directory, never beside or above
    site-packages."""
    pkg = tmp_path / "lib" / "site-packages" / build_dirs.PACKAGE.name
    pkg.mkdir(parents=True)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert build_dirs.checkout(pkg) is None
    root = build_dirs.build_root(pkg)
    assert root == tmp_path / "cache" / pkg.name / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", root / "kernels")

    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert not [p for p in (tmp_path / "lib").rglob("*") if "build" in
                p.name]


def test_vocab_split_covers_the_vocab(monkeypatch):
    monkeypatch.setattr(logit_head, "_sm_count", lambda index: 132)
    for rows, tile in ((1, 16), (512, 16), (4096, 16), (1024, 8), (3, 8)):
        for V in (1, 511, 512, 9488):
            splits, cols = logit_head.vocab_split(rows, tile, V,
                                                  torch.device("cpu"))
            assert cols % logit_head.CHUNK == 0
            assert (splits - 1) * cols < V <= splits * cols


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", ["none", "partial"])
@pytest.mark.parametrize("B,K", [(13, 6), (64, 36), (9, 64), (8, 1),
                                 (7, 196), (3, 256)])
def test_attention_kernel_matches_plain(cuda, dtype, mask, B, K):
    a = as_torch(att_case(B=B, K=K, H=96, A=80, mask=mask if K > 1
                          else "none"), cuda, dtype)
    got = att_step.fused_attention(*a)
    torch.cuda.synchronize()
    want = att_step.attention_reference(*a)
    assert got.dtype == dtype and _dispatch.launches()["attention"] == 1
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    assert (got.float() - want.float()).abs().max().item() <= tol
    with pytest.raises(ValueError, match="attention slots"):
        big = as_torch(att_case(B=2, K=att_step.MAX_K + 1, mask="none"),
                       cuda, dtype)
        att_step.fused_attention(*big)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", ["none", "partial"])
@pytest.mark.parametrize("B,K,H,A", [(13, 6, 96, 80), (64, 36, 512, 512),
                                     (9, 64, 96, 80), (8, 1, 96, 80),
                                     (5, 196, 512, 512)])
def test_attention_kmajor_kernel_matches_plain(cuda, dtype, mask, B, K, H, A):
    """Kernel E against its plain version (and so against kernel A's: the
    same arithmetic on another layout)."""
    h, emb, p_att, *rest = as_torch(
        att_case(B=B, K=K, H=H, A=A, mask=mask if K > 1 else "none"), cuda,
        dtype)
    args = (h, emb.movedim(0, 1).contiguous(),
            p_att.movedim(0, 1).contiguous(), *rest)
    got = att_step.fused_attention_kmajor(*args)
    torch.cuda.synchronize()
    want = att_step.attention_reference_kmajor(*args)
    assert got.dtype == dtype
    assert _dispatch.launches()["attention_kmajor"] == 1
    assert _dispatch.launches()["attention"] == 0
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    assert (got.float() - want.float()).abs().max().item() <= tol
    with pytest.raises(ValueError):  # a b-major context is refused
        att_step.fused_attention_kmajor(h, emb, p_att, *rest)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", ["none", "partial"])
@pytest.mark.parametrize("B,K,H,A", [(13, 6, 96, 80), (64, 36, 512, 512),
                                     (9, 64, 32, 1024), (8, 1, 96, 80),
                                     (6, 196, 512, 512), (4, 100, 40, 40)])
def test_attention_q_kernel_matches_plain(cuda, dtype, mask, B, K, H, A):
    """Kernel D against its plain version on the same int8 context, and
    `quantize_features` on the card against the same function on the CPU
    (int8 values equal, scales to 1e-6 relative)."""
    a = att_case(B=B, K=K, H=H, A=A, mask=mask if K > 1 else "none")
    h, emb, p_att, *rest = as_torch(a, cuda, dtype)
    q = att_step.quantize_features(emb, p_att)
    q_cpu = att_step.quantize_features(emb.cpu(), p_att.cpu())
    for on_card, on_cpu in zip(q, q_cpu):
        if on_card.dtype == torch.int8:
            assert (on_card.cpu() == on_cpu).all()
        else:
            assert ((on_card.cpu() - on_cpu).abs() <= 1e-6 * on_cpu).all()
    got = att_step.fused_attention_q(h, *q, *rest)
    torch.cuda.synchronize()
    want = att_step.attention_reference_q(h, *q, *rest)
    assert got.dtype == dtype
    assert _dispatch.launches()["attention_q"] == 1
    assert _dispatch.launches()["attention"] == 0
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,A", [(24, 16), (40, 40), (16, 40)])
def test_attention_q_kernel_refuses_unaligned_rows(cuda, dtype, H, A):
    """Widths that are no multiple of 16 (the int8 stream's 16-byte vector)
    are no longer refused: the int8 kernel takes them at vector width 1 and
    matches its plain version."""
    h, emb, p_att, *rest = as_torch(att_case(B=8, K=6, H=H, A=A), cuda,
                                    dtype)
    q = att_step.quantize_features(emb, p_att)
    got = att_step.fused_attention_q(h, *q, *rest)
    torch.cuda.synchronize()
    want = att_step.attention_reference_q(h, *q, *rest)
    assert _dispatch.att_width_launches()["attention_q_scalar"] == 1
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    assert (got.float() - want.float()).abs().max().item() <= tol


def expected_pass(dtype, H, V):
    """The first pass a head launch on aligned tensors must take, spelled
    out independently of logit_head.head_pass."""
    if dtype == torch.bfloat16:
        return "tma" if H % 64 == 0 and 64 <= H <= 640 and V % 8 == 0 \
            else "fma"
    return "tf32x3" if H % 64 == 0 and V % 4 == 0 else "fma"


def assert_pass(head, which):
    want = {k: 0 for k in _dispatch.HEAD_PASSES}
    want[f"{head}_{which}"] = 1
    assert _dispatch.head_pass_launches() == want
    assert _dispatch.launches()[head] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,V", [(16, 150), (37, 1300), (37, 1304),
                                 (512, 9488), (4096, 9488)])
def test_greedy_head_kernel_matches_plain(cuda, dtype, B, V):
    """(16, 150) stays on the FMA pass in either type (V is no multiple of
    4), (37, 1300) in bf16 (no multiple of 8); every other case takes a
    tensor-core pass: TMA in bf16, split TF32 in f32."""
    h, w, b, planted = head_case(B=B, H=64, V=V, ties=True)
    h, w, b = (torch.from_numpy(x).to(cuda, dtype) for x in (h, w, b))
    it, lp = logit_head.greedy_head(h, w, b)
    torch.cuda.synchronize()
    it_p, lp_p = logit_head.greedy_head_reference(h, w, b)
    assert_pass("greedy_head", expected_pass(dtype, 64, V))
    assert (it == planted[0]).all() and (it == it_p).all()
    assert (lp - lp_p).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kk", [1, 2, 3, 5, 6, 9, 16, 17, 32, 64])
@pytest.mark.parametrize("B,H,V", [(40, 64, 1300), (37, 64, 1304),
                                   (300, 512, 9488), (70, 640, 264),
                                   (129, 128, 96)])
def test_beam_head_kernel_matches_plain(cuda, dtype, kk, B, H, V):
    h, w, b, planted = head_case(B=B, H=H, V=V, seed=kk, ties=True)
    h, w, b = (torch.from_numpy(x).to(cuda, dtype) for x in (h, w, b))
    vals, idx, lse = beam_head.beam_head(h, w, b, kk)
    torch.cuda.synchronize()
    vals_p, idx_p, lse_p = beam_head.beam_head_reference(h, w, b, kk)
    assert_pass("beam_head", expected_pass(dtype, H, V))
    n = min(kk, len(planted))
    assert (idx[:, :n] == torch.tensor(planted[:n], device=cuda,
                                       dtype=torch.int32)).all()
    logits = logit_head.logits_f32(h, w, b)
    differ = idx != idx_p
    if differ.any():  # only near-ties of the plain f32 logits may swap
        gap = (torch.gather(logits, 1, idx.long())
               - torch.gather(logits, 1, idx_p.long())).abs()
        assert gap[differ].max().item() <= 1e-4
    assert (vals - vals_p).abs().max().item() <= 1e-4
    assert (lse - lse_p).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kk", [17, 24, 40])
def test_beam_head_kernel_rounds_split_a_tie_group(cuda, dtype, kk):
    """kk above 16 runs in rounds of 16: a group of 24 exactly tied columns
    across the seam of two rounds comes out in id order, as the plain
    stable sort gives it."""
    h, w, b, _ = head_case(B=300, H=512, V=1304, seed=kk)
    tied = np.sort(np.random.RandomState(kk).choice(1304, 24,
                                                    replace=False))
    w[:, tied] = 0.0
    b[tied] = 50.0
    h, w, b = (torch.from_numpy(x).to(cuda, dtype) for x in (h, w, b))
    vals, idx, lse = beam_head.beam_head(h, w, b, kk)
    torch.cuda.synchronize()
    vals_p, idx_p, lse_p = beam_head.beam_head_reference(h, w, b, kk)
    n = min(kk, 24)
    assert (idx[:, :n].cpu().numpy() == tied[:n][None]).all()
    assert (idx == idx_p).all()
    assert (vals - vals_p).abs().max().item() <= 1e-4
    assert (lse - lse_p).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_head_kernels_take_the_fma_pass_for_unaligned_bf16(cuda):
    """A bf16 W whose storage does not start on a 16-byte boundary cannot
    feed the tensor-core pass's 16-byte copies: the FMA pass takes it."""
    h, w, b, planted = head_case(B=37, H=64, V=1304, ties=True)
    h, b = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (h, b))
    store = torch.empty(64 * 1304 + 1, device=cuda, dtype=torch.bfloat16)
    w_off = store[1:].view(64, 1304)
    w_off.copy_(torch.from_numpy(w))
    assert w_off.data_ptr() % 16 != 0 and w_off.is_contiguous()
    it, _ = logit_head.greedy_head(h, w_off, b)
    assert_pass("greedy_head", "fma")
    assert (it == planted[0]).all()


@pytest.mark.cuda
def test_head_kernels_take_the_fma_pass_for_unaligned_f32(cuda):
    """An f32 W whose storage does not start on a 16-byte boundary cannot
    feed the split-TF32 pass's 16-byte copies, nor can a V that is no
    multiple of 4: the FMA pass takes both."""
    h, w, b, planted = head_case(B=37, H=64, V=1304, ties=True)
    h, b = (torch.from_numpy(x).to(cuda) for x in (h, b))
    store = torch.empty(64 * 1304 + 1, device=cuda)
    w_off = store[1:].view(64, 1304)
    w_off.copy_(torch.from_numpy(w))
    assert w_off.data_ptr() % 16 != 0 and w_off.is_contiguous()
    it, _ = logit_head.greedy_head(h, w_off, b)
    assert_pass("greedy_head", "fma")
    assert (it == planted[0]).all()
    _dispatch.reset_launches()
    h, w, b, planted = head_case(B=37, H=64, V=1302, ties=True)
    h, w, b = (torch.from_numpy(x).to(cuda) for x in (h, w, b))
    vals, idx, lse = beam_head.beam_head(h, w, b, 3)
    assert_pass("beam_head", "fma")
    assert (idx[:, :3] == torch.tensor(planted[:3], device=cuda,
                                       dtype=torch.int32)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("R,V,kk", [(128, 9488, 1), (256, 9488, 2),
                                    (512, 9488, 1), (1024, 9488, 2),
                                    (256, 4744, 2), (128, 4744, 1)])
def test_f32_heads_take_the_split_tf32_pass_at_the_paths_shapes(cuda, R, V,
                                                                 kk):
    """The f32 paths' shapes (greedy baselines and services, the
    evaluation's beam 2, the vocab slices of a model axis of 2) at H=512
    take the split-TF32 pass and match the plain head: values and
    log-sum-exp within 1e-4, ids equal but at near-ties within 1e-4,
    planted ties exact."""
    h, w, b, planted = head_case(B=R, H=512, V=V, seed=R + kk, ties=True)
    h, w, b = (torch.from_numpy(x).to(cuda) for x in (h, w, b))
    h, w = h * 0.5, w / 3  # logits of the decoders' scale
    if kk == 1:
        it, lp = logit_head.greedy_head(h, w, b)
        torch.cuda.synchronize()
        assert_pass("greedy_head", "tf32x3")
        it_p, lp_p = logit_head.greedy_head_reference(h, w, b)
        vals, idx, vals_p, idx_p = lp[:, None], it[:, None], \
            lp_p[:, None], it_p[:, None]
        lse = lse_p = torch.zeros(1, device=cuda)
    else:
        vals, idx, lse = beam_head.beam_head(h, w, b, kk)
        torch.cuda.synchronize()
        assert_pass("beam_head", "tf32x3")
        vals_p, idx_p, lse_p = beam_head.beam_head_reference(h, w, b, kk)
    assert (idx[:, 0] == planted[0]).all()
    logits = logit_head.logits_f32(h, w, b)
    differ = idx != idx_p
    if differ.any():
        gap = (torch.gather(logits, 1, idx.long())
               - torch.gather(logits, 1, idx_p.long())).abs()
        assert gap[differ].max().item() <= 1e-4
    assert (vals - vals_p).abs().max().item() <= 1e-4
    assert (lse - lse_p).abs().max().item() <= 1e-4


def cell_case(B, D=512, H=512, with_att=True, seed=0):
    rng = np.random.RandomState(seed)
    f = np.float32

    def r(*shape, scale):
        return (rng.randn(*shape) * scale).astype(f)
    return [r(B, D, scale=1.0), r(B, H, scale=0.5), r(B, H, scale=1.0),
            r(B, H, scale=1.0) if with_att else None,
            r(D, 5 * H, scale=D ** -0.5), r(5 * H, scale=0.1),
            r(H, 5 * H, scale=H ** -0.5), r(5 * H, scale=0.1),
            r(H, 2 * H, scale=H ** -0.5) if with_att else None,
            r(2 * H, scale=0.1) if with_att else None]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_att", [True, False])
@pytest.mark.parametrize("B,D,H", [(13, 24, 40), (128, 512, 512),
                                   (512, 512, 512), (1, 512, 512),
                                   (17, 512, 512), (130, 512, 512),
                                   (2100, 512, 512), (33, 72, 104),
                                   (9, 20, 44)])
def test_cell_kernel_matches_plain(cuda, dtype, with_att, B, D, H):
    """Kernel F against its plain version (cell_reference in f32 on the same
    inputs, h' and c' in the inputs' type): f32 within 1e-4, bf16 within
    3e-2 (1-2 bf16 ulps at |x| < 4; both sides round the f32 result).  The
    shapes cut the row tiles (B = 1, 17, 130; 2100 takes the 128-row tiles
    of the bf16 kernel, 512 and 2100 the 16-column tiles of the split-TF32
    kernel) and the j tiles (H = 40, 104); aligned f32 takes the split-TF32
    kernel, aligned bf16 the wgmma kernel; D, H = 20, 44 are no
    multiple of 8 and take the FMA kernel in both types."""
    args = [None if x is None else torch.from_numpy(x).to(cuda, dtype)
            for x in cell_case(B, D, H, with_att)]
    h_new, c_new = cell_step.fused_cell(*args)
    torch.cuda.synchronize()
    assert _dispatch.launches()["cell"] == 1
    fits = D % 8 == 0 and H % 8 == 0
    want = ("cell_fma" if not fits else "cell_tf32x3"
            if dtype == torch.float32 else "cell_wgmma")
    assert _dispatch.cell_pass_launches() == {
        k: int(k == want) for k in _dispatch.CELL_PASSES}
    h_p, c_p = cell_step.cell_plain(*args)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for got, want in ((h_new, h_p), (c_new, c_p)):
        assert got.dtype == dtype and got.shape == (B, H)
        assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("switch", [None, "0", "1"])
def test_cell_kernel_switch_off_launches_nothing(cuda, monkeypatch, switch):
    """The JAX package's CIC_FUSED_CELL switch is not read: on CUDA tensors
    the cell launches its kernel whatever the variable holds."""
    if switch is None:
        monkeypatch.delenv("CIC_FUSED_CELL", raising=False)
    else:
        monkeypatch.setenv("CIC_FUSED_CELL", switch)
    args = [None if x is None else torch.from_numpy(x).to(cuda)
            for x in cell_case(16)]
    cell_step.fused_cell(*args)
    torch.cuda.synchronize()
    assert _dispatch.launches()["cell"] == 1
    assert _dispatch.cell_pass_launches()["cell_tf32x3"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["attention", "attention_q", "cell"])
def test_kernel_functions_gradient_on_the_card(cuda, which):
    """Kernel forward + recomputed plain backward, against plain autograd on
    the card, f32."""
    if which == "attention":
        raw = as_torch(att_case(B=64, K=36, H=96, A=80), cuda)
        args = [x if x is None or i == 7 else x.requires_grad_(True)
                for i, x in enumerate(raw)]
        live = args[:7]
        out = (att_step.fused_attention(*args),)
        ref = (att_step.attention_reference(*args),)
    elif which == "attention_q":
        h, emb, p_att, *rest = as_torch(att_case(B=64, K=36, H=96, A=80),
                                        cuda)
        q = att_step.quantize_features(emb, p_att)
        live = [h.requires_grad_(True)] + [x.requires_grad_(True)
                                           for x in rest[:4]]
        out = (att_step.fused_attention_q(live[0], *q, *live[1:], rest[4]),)
        ref = (att_step.attention_reference_q(live[0], *q, *live[1:],
                                              rest[4]),)
    else:
        args = [None if x is None else torch.from_numpy(x).to(cuda)
                .requires_grad_(True) for x in cell_case(64, 96, 80)]
        live = [x for x in args if x is not None]
        out = cell_step.fused_cell(*args)
        ref = cell_step.cell_reference(*args)
    assert _dispatch.launches()[which] == 1
    g = torch.autograd.grad(sum(o.square().sum() for o in out), live)
    want = torch.autograd.grad(sum(o.square().sum() for o in ref), live)
    for a, b in zip(g, want):
        assert (a - b).abs().max().item() <= 1e-4 * max(1.0, b.abs().max()
                                                        .item())


def merge_records(n, m, v, seed, mode="beam"):
    """The gathered records of n vocabulary slices of v columns with exact
    ties across every seam: (records [n, R, W], the logits)."""
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(7, n * v, generator=g)
    for s in range(1, n):
        logits[:, [s * v - 1, s * v]] = 5.0
    parts = [logits[:, s * v:(s + 1) * v] for s in range(n)]
    if mode == "argmax":
        recs = [head_merge.records(*(t[:, None] for t in p.max(dim=1)))
                for p in parts]
    else:
        recs = [head_merge.records(*beam_head.top_k(p, m),
                                   torch.logsumexp(p, dim=1)) for p in parts]
    return torch.stack(recs), logits


def check_merge_kernel(cuda, recs, logits, v, m, mode):
    """The merge kernel on the card against its plain version in `mode`:
    ids equal (and equal to the whole rows' top-m or arg-max), vals and
    lse within 1e-6, the greedy lp bit-equal to the beam mode's vals[:, 0]
    - lse on the card."""
    got = head_merge.head_merge(recs.to(cuda), v, m, mode)
    torch.cuda.synchronize()
    assert _dispatch.launches()["head_merge"] == 1
    want = head_merge.head_merge_reference(recs, v, m, mode)
    if mode == "argmax":
        assert torch.equal(got.cpu(), want)
        assert torch.equal(want, torch.argmax(logits, dim=1))
        return
    ids = {"beam": 1, "greedy": 0}[mode]
    assert torch.equal(got[ids].cpu(), want[ids])
    whole = beam_head.top_k(logits, m)[1]
    assert torch.equal(want[ids].long().reshape(whole.shape), whole)
    for a, b in zip(got, want):
        if a.dtype == torch.float32:
            assert (a.cpu() - b).abs().max().item() <= 1e-6
    if mode == "greedy":
        vals, _, lse = head_merge.head_merge(recs.to(cuda), v, 1)
        assert torch.equal(got[1], vals[:, 0] - lse)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("m", [1, 2, 17, 32])
def test_head_merge_kernel_matches_plain(cuda, n, m):
    """head_merge on the card against its plain version: the gathered
    records of n vocabulary slices of 40 columns with exact ties across
    every seam (beam mode)."""
    recs, logits = merge_records(n, m, 40, seed=n * 100 + m)
    check_merge_kernel(cuda, recs, logits, 40, m, "beam")


@pytest.mark.cuda
@pytest.mark.parametrize("mode, n, m", [("beam", 2, 1), ("greedy", 2, 1),
                                        ("argmax", 2, 1), ("beam", 4, 17),
                                        ("greedy", 40, 1),
                                        ("argmax", 40, 1)])
def test_head_merge_kernel_modes_match_plain(cuda, mode, n, m):
    """Every mode of the merge kernel on the card, on rows of a few
    candidates (several rows a warp) and of more than 32 (a block a row,
    the candidates staged in shared memory)."""
    recs, logits = merge_records(n, m, 40, seed=7 * n + m, mode=mode)
    check_merge_kernel(cuda, recs, logits, 40, m, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kk", [1, 2, 17])
def test_beam_head_records_hold_its_outputs(cuda, dtype, kk):
    """Kernel C's records (cic_beam_head_records: [vals kk | ids kk | lse]
    a row, what the sharded heads gather) hold the bits of its three
    outputs, on every first pass and across rounds (kk=17)."""
    g = torch.Generator().manual_seed(kk)
    h = (torch.randn(40, 64, generator=g) * 0.5).to(cuda, dtype)
    w = (torch.randn(64, 600, generator=g) * 0.1).to(cuda, dtype)
    b = (torch.randn(600, generator=g) * 0.1).to(cuda, dtype)
    rec = beam_head.local_beam_head(h, w, b, kk, as_records=True)
    vals, idx, lse = beam_head.local_beam_head(h, w, b, kk)
    torch.cuda.synchronize()
    assert _dispatch.launches()["beam_head"] == 2
    assert torch.equal(rec, head_merge.records(vals, idx, lse))
