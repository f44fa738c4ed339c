"""Port parity: the VSE listener (models/vse.py) of the PyTorch port
against the JAX package's, on the CPU at small width in float32.

Both sides get the JAX init_params carried over as numpy and the same
inputs, made with numpy from a seed: the image and text encoders over
{gru, lstm} x {last, mean, max} on integer ids and on soft rows, with
use_abs and no_imgnorm; contrastive_loss over max_violation {0, 1, the
blended 0.3} x whole_batch x only_one_retrieval; the forward and its
gradients.  Tolerances: embeddings and losses atol = rtol = 1e-5,
gradients within 1e-4 of each leaf's largest entry."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cooperativeimagecaptioning_tpu.config import Options  # noqa: E402
from cooperativeimagecaptioning_tpu.models import layers as jlayers  # noqa: E402
from cooperativeimagecaptioning_tpu.models import vse as jvse  # noqa: E402
from cooperativeimagecaptioning_tpu_torch import models as tmodels  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.models import layers as tlayers  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.models import vse as tvse  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.utils.tree import (  # noqa: E402
    leaves, to_torch, trainable)

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_REL = 1e-4
V = 30


def vse_opt(**kw):
    base = dict(vocab_size=V, input_encoding_size=12, vse_embed_size=16,
                fc_feat_size=20, vse_rnn_type="gru", vse_pool_type="last",
                vse_margin=0.2, vse_max_violation=1, vse_use_abs=0,
                vse_no_imgnorm=0)
    base.update(kw)
    return Options(**base)


def jax_params(opt, seed=0):
    return jax.tree.map(np.asarray, jvse.init_params(
        jax.random.PRNGKey(seed), opt))


def inputs(opt, B=5, T=7, seed=0, soft=False):
    """fc [B, F], captions ([B, T] ids or [B, T, V+2] soft rows) and masks
    [B, T] of lengths 2..T (one row of full length)."""
    rng = np.random.RandomState(seed)
    fc = rng.randn(B, opt.fc_feat_size).astype(np.float32)
    lens = rng.randint(2, T + 1, B)
    lens[0] = T
    masks = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    if soft:
        x = rng.randn(B, T, V + 2).astype(np.float32) * 2
        seqs = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    else:
        seqs = rng.randint(0, V + 2, (B, T)).astype(np.int32)
    return fc, seqs.astype(np.float32) if soft else seqs, masks


def port(p, opt):
    return tvse.VSEModel(to_torch(p, "cpu"), opt)


def test_l2norm_matches_jax():
    x = np.random.RandomState(1).randn(6, 9).astype(np.float32)
    x[2] = 0.0  # the eps keeps a zero row finite
    np.testing.assert_allclose(np.asarray(jlayers.l2norm(jnp.asarray(x))),
                               tlayers.l2norm(torch.from_numpy(x)).numpy(),
                               **TOL)


def test_init_params_has_the_jax_tree():
    for rnn in ("gru", "lstm"):
        opt = vse_opt(vse_rnn_type=rnn)
        want = jax.tree_util.tree_leaves_with_path(jax_params(opt))
        want = {".".join(k.key for k in path): x.shape for path, x in want}
        got = {k: tuple(x.shape)
               for k, x in leaves(tvse.init_params(0, opt))}
        assert got == want
    assert tmodels.setup(opt, "fc", "vse_model") is tvse.VSEModel


@pytest.mark.parametrize("no_imgnorm,use_abs", [(0, 0), (1, 0), (0, 1),
                                                (1, 1)])
def test_encode_image_matches_jax(no_imgnorm, use_abs):
    opt = vse_opt(vse_no_imgnorm=no_imgnorm, vse_use_abs=use_abs)
    p = jax_params(opt)
    fc, _, _ = inputs(opt)
    want = jvse.encode_image(jax.tree.map(jnp.asarray, p), opt,
                             jnp.asarray(fc))
    got = port(p, opt).encode_image(torch.from_numpy(fc))
    np.testing.assert_allclose(np.asarray(want), got.detach().numpy(), **TOL)


@pytest.mark.parametrize("soft", [False, True], ids=["ids", "soft"])
@pytest.mark.parametrize("pool", ["last", "mean", "max"])
@pytest.mark.parametrize("rnn", ["gru", "lstm"])
def test_encode_text_matches_jax(rnn, pool, soft):
    opt = vse_opt(vse_rnn_type=rnn, vse_pool_type=pool,
                  vse_use_abs=int(pool == "max"))
    p = jax_params(opt, seed=3)
    _, seqs, masks = inputs(opt, seed=4, soft=soft)
    want = jvse.encode_text(jax.tree.map(jnp.asarray, p), opt,
                            jnp.asarray(seqs), jnp.asarray(masks))
    got = port(p, opt).encode_text(torch.from_numpy(seqs),
                                   torch.from_numpy(masks))
    assert got.shape == (5, opt.vse_embed_size)
    np.testing.assert_allclose(np.asarray(want), got.detach().numpy(), **TOL)


def embeddings(seed, B=6, E=8, ties=False):
    rng = np.random.RandomState(seed)
    im = rng.randn(B, E).astype(np.float32)
    s = rng.randn(B, E).astype(np.float32)
    if ties:  # two identical captions: equal scores, equal hinge maxima
        s[3] = s[1]
    im /= np.linalg.norm(im, axis=1, keepdims=True)
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    return im, s


@pytest.mark.parametrize("only_one", ["off", "image", "caption"])
@pytest.mark.parametrize("whole_batch", [False, True])
@pytest.mark.parametrize("max_violation", [0, 1, "blend"])
def test_contrastive_loss_matches_jax(max_violation, whole_batch, only_one):
    """The loss and its VJP (random cotangent); "blend" passes the weight
    0.3 as an array, as the trainer's traced hinge weight."""
    im, s = embeddings(seed=2, ties=True)
    jmv = jnp.float32(0.3) if max_violation == "blend" else max_violation
    tmv = torch.tensor(0.3) if max_violation == "blend" else max_violation

    def jfn(a, b):
        return jvse.contrastive_loss(a, b, 0.2, jmv, whole_batch, only_one)

    want, vjp = jax.vjp(jfn, jnp.asarray(im), jnp.asarray(s))
    ti = torch.tensor(im, requires_grad=True)
    ts = torch.tensor(s, requires_grad=True)
    got = tvse.contrastive_loss(ti, ts, 0.2, tmv, whole_batch, only_one)
    np.testing.assert_allclose(np.asarray(want), got.detach().numpy(), **TOL)
    ct = np.asarray(np.random.RandomState(3).randn(*np.shape(want)),
                    np.float32)
    jg = vjp(jnp.asarray(ct))
    tg = torch.autograd.grad(got, (ti, ts), torch.from_numpy(ct))
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), **TOL)


def assert_grads_close(jtree, ttree):
    """Each leaf within GRAD_REL of its largest entry."""
    want = {".".join(k.key for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_leaves_with_path(jtree)}
    got = dict(leaves(ttree))
    assert set(want) == set(got)
    for k, w in want.items():
        g = got[k].detach().numpy()
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(w - g).max() <= GRAD_REL * scale, k


@pytest.mark.parametrize("soft", [False, True], ids=["ids", "soft"])
@pytest.mark.parametrize("rnn", ["gru", "lstm"])
def test_forward_and_gradients_match_jax(rnn, soft):
    """forward (the mean-hinge blend at w=0.5) and the gradients of every
    listener leaf, and of the soft input rows."""
    opt = vse_opt(vse_rnn_type=rnn, vse_max_violation=0)
    p = jax_params(opt, seed=5)
    fc, seqs, masks = inputs(opt, B=6, seed=6, soft=soft)
    jp = jax.tree.map(jnp.asarray, p)

    def jloss(params, x):
        return jvse.forward(params, opt, jnp.asarray(fc), None, x,
                            jnp.asarray(masks), max_violation_w=jnp.float32(
                                0.5))

    args = (0, 1) if soft else (0,)
    want = jloss(jp, jnp.asarray(seqs))
    jgrads = jax.grad(jloss, argnums=args)(jp, jnp.asarray(seqs))
    tree = trainable(to_torch(p, "cpu"))
    x = torch.tensor(seqs, requires_grad=soft)
    got = tvse.VSEModel(tree, opt)(torch.from_numpy(fc), None, x,
                                   torch.from_numpy(masks),
                                   max_violation_w=torch.tensor(0.5))
    np.testing.assert_allclose(float(want), got.item(), **TOL)
    named = leaves(tree)
    wrt = [t for _, t in named] + ([x] if soft else [])
    g = torch.autograd.grad(got, wrt)
    assert_grads_close(jgrads[0], {k: gi for (k, _), gi in zip(named, g)})
    if soft:
        w, t = np.asarray(jgrads[1]), g[-1].numpy()
        assert np.abs(w - t).max() <= GRAD_REL * np.abs(w).max()
