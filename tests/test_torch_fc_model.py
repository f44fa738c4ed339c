"""Port parity: the FC speaker (models/fc_model.py) of the PyTorch port
against the JAX package's, on the CPU at small width in float32.

Both sides get the JAX init_params carried over as numpy and the same
fc features, made with numpy from a seed.  Teacher-forced loss and its
gradients (with dropout, on the JAX package's noise: the dropped h is the
recurrent state), greedy and beam ids bit-equal, and the seven sampling
modes fed the noise the JAX `decoding.sample` draws for the FC speaker
(the image step first, then one output mask a step: no embedding
dropout).  The FC service (fc features only) against the JAX service.
Tolerances: ids bit-equal; log-probs and losses atol = rtol = 1e-5;
gradients rtol 1e-4, atol 1e-6."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cooperativeimagecaptioning_tpu import serving as jserving  # noqa: E402
from cooperativeimagecaptioning_tpu.models import att_model as jatt  # noqa: E402
from cooperativeimagecaptioning_tpu.models import fc_model as jfc  # noqa: E402
from cooperativeimagecaptioning_tpu.ops import decoding as jdec  # noqa: E402
from cooperativeimagecaptioning_tpu_torch import models as tmodels  # noqa: E402
from cooperativeimagecaptioning_tpu_torch import serving as tserving  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.models import att_model as tatt  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.models import fc_model as tfc  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.ops import decoding as tdec  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.ops import draws  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.utils.tree import (  # noqa: E402
    leaves, to_torch, trainable)
from test_torch_att_model import TOL, tiny_opt  # noqa: E402
from test_torch_sampling import (  # noqa: E402
    MODES, SAMPLE_KW, SOFT_TOL, assert_same_sample, jax_select_noise)
from test_torch_training import GRAD_TOL, assert_tree_close  # noqa: E402

J = jax.random
B = 6


def fc_opt(**kw):
    return tiny_opt(caption_model="fc", **kw)


def jax_params(opt, seed=0):
    """JAX-initialized FC params as numpy; the logit and embedding weights
    scaled up so that random weights move between words."""
    p = jax.tree.map(np.asarray, jfc.init_params(J.PRNGKey(seed), opt))
    p["logit"]["w"] = p["logit"]["w"] * 6.0
    p["embed"] = p["embed"] * 10.0
    return p


def fc_feats(opt, seed=0, n=B):
    return np.random.RandomState(seed).randn(n, opt.fc_feat_size).astype(
        np.float32) * 2.0


def both(opt, seed=0):
    p = jax_params(opt, seed)
    fc = fc_feats(opt, seed)
    jp = jax.tree.map(jnp.asarray, p)
    tp = tfc.FCModel(to_torch(p, "cpu"))
    return (jp, jfc.encode_features(jp, jnp.asarray(fc), None, None),
            tp, tp.encode_features(torch.from_numpy(fc), None, None))


def test_init_params_and_class_constants_match_jax():
    opt = fc_opt()
    want = {".".join(k.key for k in path): x.shape
            for path, x in jax.tree_util.tree_leaves_with_path(
                jax_params(opt))}
    assert {k: tuple(x.shape) for k, x in
            leaves(tfc.init_params(0, opt))} == want
    assert tmodels.setup(opt, "fc", "caption_model") is tfc.FCModel
    for jm, tm in ((jfc, tfc.FCModel), (jatt, tatt.AttModel)):
        assert tm.TEACHER_FORCING_DROPS_PREFIX_OUTPUT == \
            jm.TEACHER_FORCING_DROPS_PREFIX_OUTPUT


@pytest.mark.parametrize("fused", ["0", "1"])
def test_step_matches_jax(monkeypatch, fused):
    """The image step then one token step; CIC_FUSED_CELL=1 takes the cell
    kernel's plain version without attention on the CPU."""
    monkeypatch.setenv("CIC_FUSED_CELL", fused)
    opt = fc_opt()
    jp, jctx, tp, tctx = both(opt)
    js = jfc.init_state(jp, B)
    (pe_j,), (pe_t,) = (jfc.prefix_embeddings(jp, jctx),
                        tp.prefix_embeddings(tctx))
    js, _ = jfc.step(jp, jctx, js, pe_j)
    ts, _ = tp.step(tctx, tp.init_state(B), pe_t)
    ids = np.arange(B, dtype=np.int32) + 3
    js, jout = jfc.step(jp, jctx, js, jfc.embed_token(jp, jnp.asarray(ids)))
    ts, tout = tp.step(tctx, ts, tp.embed_token(torch.from_numpy(ids)))
    np.testing.assert_allclose(np.asarray(jout), tout.detach().numpy(),
                               **TOL)
    np.testing.assert_allclose(np.asarray(js[1]), ts[1].detach().numpy(),
                               **TOL)


def jax_tf_noise(key, B, H, T, drop):
    """The dropout uniforms of the JAX teacher-forced loss of the FC
    speaker (decoding.py:101-139): the image step's, then one a step."""
    if drop <= 0:
        return []
    key, _ = J.split(key)
    key, r_step = J.split(key)
    out = [J.uniform(r_step, (B, H))]
    for _ in range(T):
        key, _, _, _, r_step = J.split(key, 5)
        out.append(J.uniform(r_step, (B, H)))
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("drop", [0.0, 0.5])
def test_teacher_forced_loss_and_gradients_match_jax(drop):
    opt = fc_opt()
    p = jax_params(opt, seed=2)
    fc = fc_feats(opt, seed=2)
    rng = np.random.RandomState(3)
    T = opt.seq_length + 1
    labels = np.zeros((B, T + 1), np.int64)
    labels[:, 1:] = rng.randint(1, opt.vocab_size + 1, (B, T))
    masks = np.ones((B, T + 1), np.float32)
    masks[2, 5:] = 0.0
    key = J.PRNGKey(4)

    def jloss(params):
        ctx = jfc.encode_features(params, jnp.asarray(fc), None, None)
        return jdec.teacher_forced_loss(
            jfc, params, ctx, jnp.asarray(labels[:, :-1]),
            jnp.asarray(labels[:, 1:]), jnp.asarray(masks[:, 1:]), key,
            train=drop > 0, drop_prob=drop)

    want, jgrads = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, p))
    tree = trainable(to_torch(p, "cpu"))
    tp = tfc.FCModel(tree)
    src = draws.Replay(jax_tf_noise(key, B, opt.rnn_size, T, drop))
    got = tdec.teacher_forced_loss(
        tp, tp.encode_features(torch.from_numpy(fc), None, None),
        torch.from_numpy(labels[:, :-1]), torch.from_numpy(labels[:, 1:]),
        torch.from_numpy(masks[:, 1:]), src, train=drop > 0, drop_prob=drop)
    assert src.done()
    np.testing.assert_allclose(float(want), got.item(), **TOL)
    named = leaves(tree)
    g = torch.autograd.grad(got, [x for _, x in named])
    assert_tree_close(jgrads, {k: gi for (k, _), gi in zip(named, g)},
                      **GRAD_TOL)


@pytest.mark.parametrize("constraint", [0, 1])
@pytest.mark.parametrize("beam", [1, 2, 3])
def test_greedy_and_beam_match_jax(beam, constraint):
    opt = fc_opt()
    jp, jctx, tp, tctx = both(opt, seed=5)
    if beam == 1:
        want = jdec.sample(jfc, jp, jctx, opt.seq_length, J.PRNGKey(0),
                           mode="greedy", decoding_constraint=constraint)
        with torch.no_grad():
            got = tdec.sample(tp, tctx, opt.seq_length, mode="greedy",
                              decoding_constraint=constraint)
    else:
        want = jdec.beam_search(jfc, jp, jctx, opt.seq_length, beam,
                                decoding_constraint=constraint)
        with torch.no_grad():
            got = tdec.beam_search(tp, tctx, opt.seq_length, beam,
                                   decoding_constraint=constraint)
    np.testing.assert_array_equal(np.asarray(want.seq), got.seq.numpy())
    np.testing.assert_allclose(np.asarray(want.logprobs),
                               got.logprobs.numpy(), **TOL)
    assert len({tuple(r) for r in got.seq.numpy()}) > 1


def jax_fc_sample_noise(key, mode, B, C, L, H=0, drop=0.0):
    """Every array the JAX `decoding.sample` of the FC speaker draws from
    `key` (decoding.py:230-232, 254, 279, 321), in the order the port asks
    for them: the image step's output mask, then per step the selection
    noise and the output mask (no embedding mask)."""
    def mask(r_step):
        return [J.uniform(r_step, (B, H))] if drop > 0 else []

    key, _ = J.split(key)
    key, r_step = J.split(key)  # the image step
    out = mask(r_step)
    key, _, r_step = J.split(key, 3)
    out += mask(r_step)
    for _ in range(1, L):
        key, r_sel, _, r_step = J.split(key, 4)
        out += jax_select_noise(r_sel, mode, B, C) + mask(r_step)
    key, r_sel = J.split(key)
    out += jax_select_noise(r_sel, mode, B, C)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("drop", [0.0, 0.5])
@pytest.mark.parametrize("mode", MODES)
def test_sample_matches_jax(mode, drop):
    opt = fc_opt()
    jp, jctx, tp, tctx = both(opt, seed=7)
    key = J.PRNGKey(8)
    train = drop > 0
    want = jdec.sample(jfc, jp, jctx, opt.seq_length, key, mode=mode,
                       train=train, drop_prob=drop, **SAMPLE_KW)
    src = draws.Replay(jax_fc_sample_noise(
        key, mode, B, opt.vocab_size + 1, opt.seq_length, H=opt.rnn_size,
        drop=drop))
    with torch.no_grad():
        got = tdec.sample(tp, tctx, opt.seq_length, src, mode=mode,
                          train=train, drop_prob=drop, **SAMPLE_KW)
    assert src.done(), f"{src.pos} of {len(src.arrays)} draws used"
    assert_same_sample(want, got, mode)
    assert len(np.unique(got.seq.numpy())) > 3


def test_soft_rows_match_jax():
    """The relaxed one-hots of the soft-input mode, the listener's input."""
    opt = fc_opt()
    jp, jctx, tp, tctx = both(opt, seed=9)
    key = J.PRNGKey(10)
    want = jdec.sample(jfc, jp, jctx, opt.seq_length, key,
                       mode="gumbel_soft", **SAMPLE_KW)
    src = draws.Replay(jax_fc_sample_noise(
        key, "gumbel_soft", B, opt.vocab_size + 1, opt.seq_length))
    got = tdec.sample(tp, tctx, opt.seq_length, src, mode="gumbel_soft",
                      **SAMPLE_KW)
    assert got.soft.shape == (B, opt.seq_length, opt.vocab_size + 2)
    np.testing.assert_allclose(np.asarray(want.soft),
                               got.soft.detach().numpy(), **SOFT_TOL)


@pytest.mark.parametrize("beam", [0, 2])
def test_fc_service_matches_jax(beam):
    """The service of an FC speaker takes fc features alone, padded to its
    buckets (the remainder re-bucketed)."""
    opt = fc_opt()
    p = {"speaker": jax_params(opt, seed=11)}
    vocab = {str(i): f"w{i}" for i in range(1, opt.vocab_size + 1)}
    fc = fc_feats(opt, seed=12, n=11)
    kw = dict(beam_size=beam, buckets=(4, 8), compute_dtype="float32")
    want = jserving.CaptioningService(
        opt, jax.tree.map(jnp.asarray, p), vocab, **kw).caption_ids(fc)
    svc = tserving.CaptioningService(opt, to_torch(p, "cpu"), vocab,
                                     device="cpu", **kw)
    svc.warmup()
    got = svc.caption_ids(fc)
    np.testing.assert_array_equal(np.asarray(want), got)
    assert got.shape == (11, opt.seq_length)
    assert len(svc.caption(fc[:3])) == 3
