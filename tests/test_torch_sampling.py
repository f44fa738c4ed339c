"""Port parity: the relaxations and the seven sampling modes of the PyTorch
port against the JAX package on the CPU, float32, given the JAX package's
noise.

A torch generator cannot reproduce JAX's random numbers, but the draws
themselves can be shared: `jax_sample_noise` computes, along the key splits
of the JAX `decoding.sample` (decoding.py:230-232, 254, 279, 321;
relaxations.py:55, 90), the uniform and Gumbel arrays that JAX draws, and
the port replays them (ops/draws.Replay).  Tolerances: ids bit-equal,
logprobs atol = rtol = 1e-5, the relaxed one-hots (`soft`) and the
relaxations' forward atol 1e-6, their VJPs atol = rtol = 1e-5.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cooperativeimagecaptioning_tpu.models import att_model as jatt  # noqa: E402
from cooperativeimagecaptioning_tpu.ops import decoding as jdec  # noqa: E402
from cooperativeimagecaptioning_tpu.ops import relaxations as jrel  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.models import att_model as tatt  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.ops import decoding as tdec  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.ops import draws  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.ops import relaxations as trel  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.utils.tree import (  # noqa: E402
    leaves, to_torch, trainable)
from test_torch_att_model import TOL, features, jax_params, tiny_opt  # noqa: E402

MODES = ("greedy", "gumbel_noise_max", "sample", "gumbel_st",
         "multinomial_st", "gumbel_soft", "multinomial_soft")
SOFT_TOL = dict(atol=1e-6, rtol=0)
VJP_TOL = dict(atol=1e-5, rtol=1e-5)
J = jax.random


def jax_select_noise(key, mode, B, C):
    """The arrays one JAX selection draws from `key`, in order."""
    if mode == "greedy":
        return []
    if mode in ("gumbel_noise_max", "gumbel_st"):
        return [J.uniform(key, (B, C))]
    if mode in ("sample", "multinomial_st"):
        return [J.gumbel(key, (B, C))]
    k_noise, k_mask = J.split(key)
    first = J.uniform(k_noise, (B, C)) if mode == "gumbel_soft" else \
        J.gumbel(k_noise, (B, C))
    return [first, J.uniform(k_mask, (B,))]


def jax_sample_noise(key, mode, B, C, L, D=0, H=0, drop=0.0):
    """Every array the JAX `decoding.sample` of an attention speaker draws
    from `key` (selection noise, dropout keep masks as uniforms), in the
    order the port's `sample` asks for them."""
    out = []

    def masks(r_emb, r_step):
        if drop <= 0.0:
            return []
        return [J.uniform(r_emb, (B, D)), J.uniform(r_step, (B, H))]

    key, _ = J.split(key)  # the prefix steps' key: none for att2in2
    key, r_emb, r_step = J.split(key, 3)
    out += masks(r_emb, r_step)
    for _ in range(1, L):
        key, r_sel, r_emb, r_step = J.split(key, 4)
        out += jax_select_noise(r_sel, mode, B, C) + masks(r_emb, r_step)
    key, r_sel = J.split(key)
    out += jax_select_noise(r_sel, mode, B, C)
    return [np.asarray(x) for x in out]


def logprobs_np(B=6, C=9, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, C).astype(np.float32) * 2.0
    return np.asarray(jax.nn.log_softmax(jnp.asarray(x), axis=-1))


# ---------------------------------------------------------------------------
# the relaxations
# ---------------------------------------------------------------------------

RELAXATIONS = {
    "gumbel_st": lambda T: (T,),
    "multinomial_st": lambda T: (T,),
    "gumbel_soft": lambda T: (T, 0.5),
    "multinomial_soft": lambda T: (T, 0.5),
}


def test_sample_gumbel_matches_jax():
    key = J.PRNGKey(3)
    want = jrel.sample_gumbel(key, (5, 7))
    got = trel.sample_gumbel(draws.Replay([J.uniform(key, (5, 7))]), (5, 7),
                             "cpu")
    np.testing.assert_allclose(np.asarray(want), got.numpy(), **SOFT_TOL)


@pytest.mark.parametrize("temperature", [1.0, 0.5, 10.0])
@pytest.mark.parametrize("name", sorted(RELAXATIONS))
def test_relaxation_matches_jax(name, temperature):
    """Forward (relaxed vector and ids) and the VJP of a random cotangent,
    the port fed the noise the JAX function draws."""
    lp = logprobs_np(seed=int(temperature * 10))
    key = J.PRNGKey(7)
    args = RELAXATIONS[name](temperature)
    jfn = getattr(jrel, name)
    want, vjp = jax.vjp(lambda x: jfn(key, x, *args)[0], jnp.asarray(lp))
    want_ind = jfn(key, jnp.asarray(lp), *args)[1]
    B, C = lp.shape
    noise = jax_select_noise(key, name, B, C)  # a relaxation is a mode
    x = torch.tensor(lp, requires_grad=True)
    src = draws.Replay([np.asarray(a) for a in noise])
    got, ind = getattr(trel, name)(src, x, *args)
    assert src.done()
    np.testing.assert_array_equal(np.asarray(want_ind), ind.numpy())
    np.testing.assert_allclose(np.asarray(want), got.detach().numpy(),
                               **SOFT_TOL)
    ct = np.random.RandomState(1).randn(B, C).astype(np.float32)
    (jgrad,) = vjp(jnp.asarray(ct))
    (tgrad,) = torch.autograd.grad(got, x, torch.from_numpy(ct))
    np.testing.assert_allclose(np.asarray(jgrad), tgrad.numpy(), **VJP_TOL)
    if name.endswith("_soft"):  # the row mask picked some rows, not all
        hard = np.isclose(np.asarray(want).max(axis=1), 1.0)
        assert 0 < hard.sum() < B or temperature == 1.0


# ---------------------------------------------------------------------------
# sample, all seven modes
# ---------------------------------------------------------------------------

def contexts(opt, B=6, K=6, seed=0):
    p = jax_params(opt, seed=seed)
    att, masks = features(opt, B=B, K=K, seed=seed)
    jp = jax.tree.map(jnp.asarray, p)
    tp = tatt.AttModel(to_torch(p, "cpu"))
    jctx = jatt.encode_features(jp, None, jnp.asarray(att),
                                jnp.asarray(masks))
    tctx = tp.encode_features(None, torch.from_numpy(att),
                              torch.from_numpy(masks))
    return jp, tp, jctx, tctx


SAMPLE_KW = dict(temperature=0.8, gumbel_temp=2.0, multinomial_temp=1.5,
                 prob_gumbel_softmax=0.5, prob_multinomial_soft=0.5)


def sample_both(opt, mode, constraint=0, drop=0.0, seed=0):
    jp, tp, jctx, tctx = contexts(opt, seed=seed)
    key = J.PRNGKey(11 + seed)
    train = drop > 0
    jout = jdec.sample(jatt, jp, jctx, opt.seq_length, key, mode=mode,
                       decoding_constraint=constraint, train=train,
                       drop_prob=drop, **SAMPLE_KW)
    B, C = 6, opt.vocab_size + 1
    noise = jax_sample_noise(key, mode, B, C, opt.seq_length,
                             D=opt.input_encoding_size, H=opt.rnn_size,
                             drop=drop)
    src = draws.Replay(noise)
    tout = tdec.sample(tp, tctx, opt.seq_length, src, mode=mode,
                       decoding_constraint=constraint, train=train,
                       drop_prob=drop, **SAMPLE_KW)
    assert src.done(), f"{src.pos} of {len(noise)} draws used"
    return jout, tout


def assert_same_sample(jout, tout, mode):
    assert tout.seq.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jout.seq), tout.seq.numpy())
    np.testing.assert_allclose(np.asarray(jout.logprobs),
                               tout.logprobs.numpy(), **TOL)
    if mode in tdec.ONE_HOT_MODES:
        assert tout.soft.shape == tuple(jout.soft.shape)
        np.testing.assert_allclose(np.asarray(jout.soft), tout.soft.numpy(),
                                   **SOFT_TOL)
    else:
        assert tout.soft is None and jout.soft is None


@pytest.mark.parametrize("constraint", [0, 1])
@pytest.mark.parametrize("mode", MODES)
def test_sample_matches_jax(mode, constraint):
    opt = tiny_opt()
    jout, tout = sample_both(opt, mode, constraint)
    assert_same_sample(jout, tout, mode)
    seq = tout.seq.numpy()
    assert len(np.unique(seq)) > 3
    if constraint:
        live = (seq[:, 1:] > 0) & (seq[:, :-1] > 0)
        assert not np.any((seq[:, 1:] == seq[:, :-1]) & live)


@pytest.mark.parametrize("mode", MODES)
def test_sample_with_dropout_matches_jax(mode):
    """train=True, drop_prob 0.5: the embedding and output keep masks of
    every step come from the replayed uniforms too."""
    opt = tiny_opt()
    jout, tout = sample_both(opt, mode, drop=0.5, seed=1)
    assert_same_sample(jout, tout, mode)


def test_finished_rows_emit_the_eos_one_hot():
    opt = tiny_opt()
    p = jax_params(opt, seed=2)
    p["logit"]["b"] = p["logit"]["b"] + np.eye(1, opt.vocab_size + 1,
                                                dtype=np.float32)[0] * 6.0
    # (the end token, id 0, made likely)
    spk = tatt.AttModel(to_torch(p, "cpu"))
    att, masks = features(opt, B=16, seed=2)
    ctx = spk.encode_features(None, torch.from_numpy(att),
                              torch.from_numpy(masks))
    out = tdec.sample(spk, ctx, opt.seq_length,
                      torch.Generator().manual_seed(0), mode="gumbel_st",
                      gumbel_temp=2.0)
    seq, soft = out.seq.numpy(), out.soft.numpy()
    finished = seq == 0
    assert finished.any() and (~finished).any()
    eos = np.zeros(soft.shape[-1], np.float32)
    eos[0] = 1.0
    np.testing.assert_array_equal(soft[finished], np.broadcast_to(
        eos, soft[finished].shape))
    # the last column (V+1 = BOS) is never emitted
    assert not soft[..., -1].any()


@pytest.mark.parametrize("remat", [0, 1])
@pytest.mark.parametrize("mode", MODES[2:])
def test_sample_gradients_match_jax(mode, remat):
    """Gradients of sum(logprobs) + <soft, w> with respect to every speaker
    leaf, dropout 0.5, through the checkpointed steps or not: the port fed
    JAX's noise against jax.grad of the JAX sample.  Tolerance: per leaf
    1e-4 of its largest entry, plus 1e-6 -- the two frameworks sum the B x L
    terms of a leaf in other orders, and multinomial_soft's unnormalized
    exp(lp / T) rows make those terms large and cancelling (one i2h entry
    in 3840 sits 1.8e-4 off relative to itself, 4e-6 absolute)."""
    opt = tiny_opt()
    p = jax_params(opt, seed=4)
    att, masks = features(opt, seed=4)
    key = J.PRNGKey(31)
    C = opt.vocab_size + 1
    w = np.linspace(-1, 1, C + 1).astype(np.float32)

    def jloss(params):
        ctx = jatt.encode_features(params, None, jnp.asarray(att),
                                   jnp.asarray(masks))
        out = jdec.sample(jatt, params, ctx, opt.seq_length, key, mode=mode,
                          train=True, drop_prob=0.5, remat=bool(remat),
                          **SAMPLE_KW)
        loss = jnp.sum(out.logprobs)
        if out.soft is not None:
            loss = loss + jnp.sum(out.soft * w)
        return loss

    jval, jgrad = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, p))
    tree = trainable(to_torch(p, "cpu"))
    spk = tatt.AttModel(tree)
    ctx = spk.encode_features(None, torch.from_numpy(att),
                              torch.from_numpy(masks))
    noise = jax_sample_noise(key, mode, 6, C, opt.seq_length,
                             D=opt.input_encoding_size, H=opt.rnn_size,
                             drop=0.5)
    out = tdec.sample(spk, ctx, opt.seq_length, draws.Replay(noise),
                      mode=mode, train=True, drop_prob=0.5,
                      remat=bool(remat), **SAMPLE_KW)
    loss = out.logprobs.sum()
    if out.soft is not None:
        loss = loss + (out.soft * torch.from_numpy(w)).sum()
    np.testing.assert_allclose(float(jval), loss.item(), rtol=1e-5)
    named = leaves(tree)
    grads = torch.autograd.grad(loss, [x for _, x in named],
                                allow_unused=True)
    want = {".".join(str(k.key) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_leaves_with_path(jgrad)}
    assert sorted(want) == [k for k, _ in named]
    for (k, x), g in zip(named, grads):
        got = np.zeros(x.shape, np.float32) if g is None else g.numpy()
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got, want[k], rtol=0,
                                   atol=1e-4 * scale + 1e-6, err_msg=k)


def _sample_grads(tree, opt, ctx_np, mode, remat, gen_seed):
    spk = tatt.AttModel(tree)
    att, masks = ctx_np
    ctx = spk.encode_features(None, torch.from_numpy(att),
                              torch.from_numpy(masks))
    out = tdec.sample(spk, ctx, opt.seq_length,
                      torch.Generator().manual_seed(gen_seed), mode=mode,
                      train=True, drop_prob=0.5, remat=remat, **SAMPLE_KW)
    loss = out.logprobs.sum()
    if out.soft is not None:
        w = torch.linspace(-1, 1, out.soft.shape[-1])
        loss = loss + (out.soft * w).sum()
    named = leaves(tree)
    grads = torch.autograd.grad(loss, [x for _, x in named],
                                allow_unused=True)
    return out, {k: g for (k, _), g in zip(named, grads)}


@pytest.mark.parametrize("mode", MODES[1:])
def test_checkpointed_sample_equals_the_plain_loop(mode):
    """remat=True (each step after the first under torch.utils.checkpoint,
    its draws made before it) and the plain loop: the same ids, logprobs,
    relaxed vectors and gradients under one generator seed, dropout 0.5."""
    opt = tiny_opt()
    p = jax_params(opt, seed=3)
    ctx_np = features(opt, seed=3)
    runs = [_sample_grads(trainable(to_torch(p, "cpu")), opt, ctx_np, mode,
                          remat, 5) for remat in (True, False)]
    (o_ck, g_ck), (o_pl, g_pl) = runs
    assert torch.equal(o_ck.seq, o_pl.seq)
    torch.testing.assert_close(o_ck.logprobs, o_pl.logprobs, rtol=0, atol=0)
    for k, g in g_pl.items():
        if g is None:
            assert g_ck[k] is None, k
        else:
            torch.testing.assert_close(g_ck[k], g, rtol=1e-5, atol=1e-7,
                                       msg=k)


def test_a_mode_that_draws_needs_noise_in_order():
    """A replay that runs short or offers another shape is refused."""
    opt = tiny_opt()
    _, tp, _, tctx = contexts(opt)
    with pytest.raises(IndexError, match="ran out"):
        tdec.sample(tp, tctx, opt.seq_length, draws.Replay([]),
                    mode="sample")
    with pytest.raises(ValueError, match="shape"):
        tdec.sample(tp, tctx, opt.seq_length,
                    draws.Replay([np.zeros((2, 2), np.float32)]),
                    mode="sample")


def test_draws_from_a_generator_are_reproducible_and_recorded():
    a = draws.Draws(torch.Generator().manual_seed(4))
    b = draws.Record(draws.Draws(torch.Generator().manual_seed(4)))
    x = (a.uniform((3, 4), "cpu"), a.gumbel((5,), "cpu"))
    y = (b.uniform((3, 4), "cpu"), b.gumbel((5,), "cpu"))
    assert all(torch.equal(u, v) for u, v in zip(x, y))
    assert len(b.taken) == 2
    assert (x[0] >= 0).all() and (x[0] < 1).all()
    replay = draws.Replay(b.taken)
    assert torch.equal(replay.uniform((3, 4), "cpu"), x[0])
    assert torch.equal(replay.gumbel((5,), "cpu"), x[1])
    # a Gumbel-max over the log-probs is a categorical draw
    lp = torch.log(torch.tensor([0.1, 0.6, 0.3]))
    g = draws.Draws(torch.Generator().manual_seed(0))
    ids = torch.argmax(lp + g.gumbel((20000, 3), "cpu"), dim=-1)
    share = torch.bincount(ids, minlength=3).float() / 20000
    assert torch.allclose(share, torch.tensor([0.1, 0.6, 0.3]), atol=0.02)
