"""Port parity: phase-2 MLE training of the Att2in2 speaker, PyTorch port
against the JAX package, on the CPU at tiny width (rnn 16, vocab 25, L=8)
in float32.

Both sides get the same params (the JAX init_params, or the port Trainer's
params, carried over as numpy) and the same batches (numpy, from the shared
SyntheticDataset and DataLoader).  Random streams cannot match across
frameworks, so parity runs at drop_prob_lm = 0 and ss_prob = 0; dropout and
scheduled sampling are checked for their statistics and for determinism
under a fixed generator.

Tolerances: losses rtol 1e-5 (both sides f32, JAX at "highest" matmul
precision), gradients rtol 1e-4 / atol 1e-6 (summation order over B and T),
the optimizer state atol 1e-7 (f32 elementwise math), and params after n
Trainer steps atol 2*lr*n: at step 1 Adam's update is lr*sign(g), and a
gradient near 0 may take opposite signs in the two frameworks.
"""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cooperativeimagecaptioning_tpu.models import att_model as jatt  # noqa: E402
from cooperativeimagecaptioning_tpu.ops import decoding as jdec  # noqa: E402
from cooperativeimagecaptioning_tpu.ops import losses as jlosses  # noqa: E402
from cooperativeimagecaptioning_tpu.training import joint as jjoint  # noqa: E402
from cooperativeimagecaptioning_tpu.training import loop as jloop  # noqa: E402
from cooperativeimagecaptioning_tpu.training import optim as joptim  # noqa: E402
from cooperativeimagecaptioning_tpu_torch import train as ttrain  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.config import Options  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.data import (  # noqa: E402
    DataLoader, SyntheticDataset)
from cooperativeimagecaptioning_tpu_torch.models import att_model as tatt  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.models import layers as tlayers  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.ops import decoding as tdec  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.ops import losses as tlosses  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.ops.kernels import (  # noqa: E402
    _dispatch, att_step, cell_step)
from cooperativeimagecaptioning_tpu_torch.training import joint as tjoint  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import loop as tloop  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import optim as toptim  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.utils.tree import (  # noqa: E402
    ParamTree, leaves, to_numpy, to_torch, trainable)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def tiny_opt(**kw):
    base = dict(
        caption_model="att2in2", vse_model="None", phase=2, batch_size=4,
        seq_per_img=1, rnn_size=16, input_encoding_size=12, att_hid_size=8,
        fc_feat_size=20, att_feat_size=20, drop_prob_lm=0.0,
        learning_rate=1e-3, grad_clip=0.1,
        checkpoint_path=os.path.join(tempfile.gettempdir(), "cic_tt"),
        save_checkpoint_every=10_000, losses_log_every=1, language_eval=0,
        max_epochs=-1, cached_tokens="corpus", vocab_size=25, seq_length=8,
        prefetch_batches=0)
    base.update(kw)
    return Options(**base)


def tiny_dataset(opt):
    return SyntheticDataset(num_images=16, vocab_size=25, seq_length=8,
                            fc_feat_size=opt.fc_feat_size,
                            att_feat_size=opt.att_feat_size, max_K=6)


def numpy_batch(opt, seed=0):
    """One training batch (numpy) from the shared loader; images have 3 to
    6 regions, so the attention masks are partial."""
    loader = DataLoader(opt, dataset=tiny_dataset(opt))
    for _ in range(seed + 1):
        data = loader.get_batch("train")
    return data


def jax_params(opt, seed=0):
    return jax.tree.map(np.asarray, jjoint.init_params(
        jax.random.PRNGKey(seed), opt))


def port_tree(tree_np):
    return trainable(to_torch(tree_np, "cpu"))


def jax_batch(data, masked=True):
    b = {"fc_feats": jnp.asarray(data["fc_feats"]),
         "att_feats": jnp.asarray(data["att_feats"]),
         "att_masks": jnp.asarray(data["att_masks"]) if masked else None,
         "labels": jnp.asarray(data["labels"]),
         "masks": jnp.asarray(data["masks"])}
    return b


def port_batch(data, masked=True):
    b = {"fc_feats": torch.from_numpy(data["fc_feats"]),
         "att_feats": torch.from_numpy(data["att_feats"]),
         "att_masks": torch.from_numpy(data["att_masks"]) if masked
         else None,
         "labels": torch.from_numpy(data["labels"]).long(),
         "masks": torch.from_numpy(data["masks"])}
    return b


def assert_tree_close(jtree, ttree, **tol):
    jl = jax.tree_util.tree_leaves_with_path(jtree)
    tl = dict(leaves(ttree))
    assert len(jl) == len(tl)
    for path, want in jl:
        key = ".".join(str(k.key) for k in path)
        got = tl[key]
        got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
        np.testing.assert_allclose(np.asarray(want), got, err_msg=key, **tol)


# ---------------------------------------------------------------------------
# teacher forcing and the losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["logprobs", "loss"])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("use_bn", [0, 1])
def test_teacher_forcing_matches_jax(fn, masked, use_bn):
    """Loss and every speaker leaf's gradient, train=True (BN on batch
    statistics, although the tree has running ones), drop_prob_lm = 0."""
    opt = tiny_opt(use_bn=use_bn)
    data = numpy_batch(opt)
    p = jax_params(opt)["speaker"]
    jb, tb = jax_batch(data, masked), port_batch(data, masked)
    rng = jax.random.PRNGKey(0)
    L = jb["labels"]

    def jloss(params):
        ctx = jatt.encode_features(params, None, jb["att_feats"],
                                   jb["att_masks"], rng, True, 0.0)
        if fn == "loss":
            return jdec.teacher_forced_loss(jatt, params, ctx, L[:, :-1],
                                            L[:, 1:], jb["masks"][:, 1:],
                                            rng, True, 0.0, 0.0)
        lps = jdec.teacher_forced_logprobs(jatt, params, ctx, L[:, :-1], rng,
                                           True, 0.0, 0.0)
        return jlosses.language_model_criterion(lps, L[:, 1:],
                                                jb["masks"][:, 1:])

    jval, jgrad = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, p))

    tp = port_tree(p)
    spk = tatt.AttModel(tp)
    gen = torch.Generator().manual_seed(0)
    ctx = spk.encode_features(None, tb["att_feats"], tb["att_masks"], True,
                              0.0, gen)
    T = tb["labels"]
    if fn == "loss":
        loss = tdec.teacher_forced_loss(spk, ctx, T[:, :-1], T[:, 1:],
                                        tb["masks"][:, 1:], gen, True)
    else:
        lps = tdec.teacher_forced_logprobs(spk, ctx, T[:, :-1], gen, True)
        assert lps.shape == (4, 9, 26)
        loss = tlosses.language_model_criterion(lps, T[:, 1:],
                                                tb["masks"][:, 1:])
    named = leaves(tp)
    grads = torch.autograd.grad(loss, [x for _, x in named],
                                allow_unused=True)
    np.testing.assert_allclose(float(jval), loss.item(), **LOSS_TOL)
    tgrad = {k: torch.zeros_like(x) if g is None else g
             for (k, x), g in zip(named, grads)}
    assert_tree_close(jgrad, tgrad, **GRAD_TOL)


@pytest.mark.parametrize("remat", [0, 1])
def test_loss_fn_matches_jax(remat):
    """joint.loss_fn, phase 2, turn 'optimizer': value, aux and grads
    against the JAX make_raw_fns(opt, 'optimizer')."""
    opt = tiny_opt(remat=remat, use_bn=1)
    data = numpy_batch(opt, seed=1)
    p = jax_params(opt)
    _, jvg = jjoint.make_raw_fns(opt, "optimizer")
    (jloss, jaux), jgrads = jvg(
        jax.tree.map(jnp.asarray, p), jax_batch(data),
        jax.random.PRNGKey(0), jjoint.Hyper.from_opt(opt),
        jnp.zeros((4,), jnp.float32))
    fn = tjoint.value_and_grad(opt, "optimizer")
    tp = {"speaker": port_tree(p["speaker"])}
    (loss, aux), grads = fn(tp, port_batch(data), torch.Generator(),
                            tjoint.Hyper.from_opt(opt))
    assert set(aux) == {"loss_cap", "cap_xe"} and set(jaux) == set(aux)
    np.testing.assert_allclose(float(jloss), loss.item(), **LOSS_TOL)
    np.testing.assert_allclose(float(jaux["cap_xe"]), aux["cap_xe"].item(),
                               **LOSS_TOL)
    assert_tree_close(jgrads, grads, **GRAD_TOL)


# a listener at tiny width, trained on its turn
TINY_LISTENER = {"vse_model": "fc", "vse_embed_size": 16,
                 "vse_loss_weight": 1}


@pytest.mark.parametrize("turn,kw,match", [
    ("listener", TINY_LISTENER, "listener"),
    ("optimizer", {**TINY_LISTENER, "retrieval_reward": "reinforce",
                   "retrieval_reward_weight": 0.5},
     "REINFORCE.*ROADMAP.*joint training"),
    ("optimizer", {"cider_optimization": 1, "on_device_cider": 1},
     "ROADMAP.*device rewards"),
    ("optimizer", {"cider_optimization": 1, "soft_cider": 1},
     "ROADMAP.*device rewards"),
    ("listener", {**TINY_LISTENER, "is_alternating": 1,
                  "retrieval_reward": "reinforce"},
     "listener turn.*ROADMAP.*joint training"),
])
def test_loss_fn_raises_on_unported_branches(turn, kw, match):
    """The listener turn, REINFORCE DISC and the device reward tiers
    raised here until they were ported (their ids keep the messages they
    matched); they now run, and loss_fn (with the batch's refs for a
    device tier) and stage A equal JAX's (tests/test_torch_listener_
    training.py, tests/test_torch_device_rewards.py)."""
    opt = tiny_opt(**kw)
    if "device rewards" in match:
        from test_torch_device_rewards import assert_tier_step_matches_jax
        assert_tier_step_matches_jax(opt, turn, seed=1)
        return
    from test_torch_listener_training import assert_turn_matches_jax
    assert_turn_matches_jax(opt, turn, seed=1)


def test_language_model_criterion_matches_jax():
    rng = np.random.RandomState(0)
    lp = np.log(rng.dirichlet(np.ones(7), size=(3, 5))).astype(np.float32)
    tg = rng.randint(0, 7, (3, 6))
    mk = (rng.rand(3, 6) > 0.3).astype(np.float32)
    want = jlosses.language_model_criterion(jnp.asarray(lp), jnp.asarray(tg),
                                            jnp.asarray(mk))
    got = tlosses.language_model_criterion(torch.from_numpy(lp),
                                           torch.from_numpy(tg),
                                           torch.from_numpy(mk))
    np.testing.assert_allclose(float(want), got.item(), **LOSS_TOL)


# ---------------------------------------------------------------------------
# dropout, scheduled sampling, and the checkpointed steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_rate_and_scale(rate):
    x = torch.ones(400_000)
    y = tlayers.dropout(x, rate, torch.Generator().manual_seed(3))
    kept = y != 0
    # 400k Bernoulli draws: the kept share is within 4.5 sigma of 1 - rate
    sigma = np.sqrt(rate * (1 - rate) / x.numel())
    assert abs(kept.float().mean().item() - (1 - rate)) < 4.5 * sigma
    assert torch.all(y[kept] == 1.0 / (1 - rate))
    # the dtype is kept; rate 0 is the identity
    xb = torch.ones(8, dtype=torch.bfloat16)
    assert tlayers.dropout(xb, rate, torch.Generator()).dtype == torch.bfloat16
    assert tlayers.dropout(x, 0.0, None) is x


def test_dropout_is_deterministic_under_a_generator():
    x = torch.randn(64, 32)
    a = tlayers.dropout(x, 0.5, torch.Generator().manual_seed(7))
    b = tlayers.dropout(x, 0.5, torch.Generator().manual_seed(7))
    c = tlayers.dropout(x, 0.5, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_step_drops_only_the_output():
    """Att2in2: the recurrent state keeps the clean next_h (JAX
    att_model.py:213-216); only the output is dropped."""
    opt = tiny_opt()
    spk = tatt.AttModel(to_torch(jax_params(opt)["speaker"], "cpu"))
    data = numpy_batch(opt)
    tb = port_batch(data)
    ctx = spk.encode_features(None, tb["att_feats"], tb["att_masks"])
    xt = spk.embed_token(tb["labels"][:, 1])
    state = spk.init_state(4)
    (h0, c0), out0 = spk.step(ctx, state, xt)
    (h1, c1), out1 = spk.step(ctx, state, xt, 0.5,
                              torch.Generator().manual_seed(0))
    assert torch.equal(h0, h1) and torch.equal(c0, c1)
    assert torch.equal(out0, h0)
    kept = out1 != 0
    assert 0 < kept.sum() < kept.numel()
    torch.testing.assert_close(out1[kept], h0[kept] / 0.5)


def test_scheduled_sampling_replaces_from_step_one():
    """With ss_prob p a row takes a draw from the previous log-probs with
    probability p (here all mass on id 7), never at step 0."""
    opt = tiny_opt()
    spk = tatt.AttModel(to_torch(jax_params(opt)["speaker"], "cpu"))
    B = 20_000
    it = torch.full((B,), 3, dtype=torch.long)
    lp = torch.full((B, 26), -1e9)
    lp[:, 7] = 0.0
    gen = torch.Generator().manual_seed(0)
    it0, _ = tdec._draws(spk, 0, it, lp, gen, 0.0, 0.3, True)
    assert torch.equal(it0, it)
    it1, masks = tdec._draws(spk, 1, it, lp, gen, 0.0, 0.3, True)
    assert masks == (None, None)
    assert set(it1.unique().tolist()) == {3, 7}
    share = (it1 == 7).float().mean().item()
    assert abs(share - 0.3) < 4.5 * np.sqrt(0.3 * 0.7 / B)


@pytest.mark.parametrize("ss_prob", [0.0, 0.5])
def test_checkpointed_loss_equals_the_plain_loop(ss_prob):
    """drop_prob_lm 0.5 under one generator seed: teacher_forced_loss (each
    step checkpointed, so backward recomputes it) and the un-checkpointed
    teacher_forced_logprobs + criterion give the same loss and gradients --
    the recompute must see the same dropout masks and sampled ids."""
    opt = tiny_opt(use_bn=1)
    data = numpy_batch(opt)
    tb = port_batch(data)
    p = jax_params(opt)["speaker"]
    T = tb["labels"]
    out = []
    for remat in (True, False):
        tp = port_tree(p)
        spk = tatt.AttModel(tp)
        gen = torch.Generator().manual_seed(11)
        ctx = spk.encode_features(None, tb["att_feats"], tb["att_masks"],
                                  True, 0.5, gen)
        if remat:
            loss = tdec.teacher_forced_loss(spk, ctx, T[:, :-1], T[:, 1:],
                                            tb["masks"][:, 1:], gen, True,
                                            0.5, ss_prob)
        else:
            lps = tdec.teacher_forced_logprobs(spk, ctx, T[:, :-1], gen,
                                               True, 0.5, ss_prob)
            loss = tlosses.language_model_criterion(lps, T[:, 1:],
                                                    tb["masks"][:, 1:])
        named = leaves(tp)
        grads = torch.autograd.grad(loss, [x for _, x in named],
                                    allow_unused=True)
        out.append((loss.item(), {k: g for (k, _), g in zip(named, grads)}))
    (l_ck, g_ck), (l_pl, g_pl) = out
    np.testing.assert_allclose(l_ck, l_pl, rtol=1e-6)
    for k, g in g_pl.items():
        if g is None:
            assert g_ck[k] is None, k
        else:
            torch.testing.assert_close(g_ck[k], g, rtol=1e-5, atol=1e-7,
                                       msg=k)
    # and the masks really are random: another seed gives another loss
    tp = port_tree(p)
    spk = tatt.AttModel(tp)
    gen = torch.Generator().manual_seed(12)
    ctx = spk.encode_features(None, tb["att_feats"], tb["att_masks"], True,
                              0.5, gen)
    other = tdec.teacher_forced_loss(spk, ctx, T[:, :-1], T[:, 1:],
                                     tb["masks"][:, 1:], gen, True, 0.5,
                                     ss_prob)
    assert abs(other.item() - l_ck) > 1e-4


# ---------------------------------------------------------------------------
# the autograd Functions of the kernels
# ---------------------------------------------------------------------------

def _f64(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.randn(*shape) * scale).requires_grad_(True)


@pytest.mark.parametrize("masked", [True, False])
def test_attention_function_gradcheck(masked):
    """The Function's own backward (recompute of attention_reference), with
    the plain forward injected, against finite differences in f64."""
    rng = np.random.RandomState(0)
    B, K, H, A = 3, 4, 5, 6
    args = (_f64(rng, B, H), _f64(rng, B, K, H), _f64(rng, B, K, A),
            _f64(rng, H, A, scale=0.5), _f64(rng, A), _f64(rng, A, 1),
            _f64(rng, 1))
    masks = None
    if masked:
        masks = torch.ones(B, K, dtype=torch.float64)
        masks[0, 2:] = 0.0

    def f(*a):
        return att_step.Attention.apply(att_step.attention_reference,
                                        att_step.attention_reference, (), *a,
                                        masks)

    assert torch.autograd.gradcheck(f, args)


@pytest.mark.parametrize("with_att", [True, False])
def test_cell_function_gradcheck(with_att):
    rng = np.random.RandomState(1)
    B, D, H = 3, 4, 5
    args = [_f64(rng, B, D), _f64(rng, B, H), _f64(rng, B, H),
            _f64(rng, B, H) if with_att else None,
            _f64(rng, D, 5 * H, scale=0.5), _f64(rng, 5 * H),
            _f64(rng, H, 5 * H, scale=0.5), _f64(rng, 5 * H),
            _f64(rng, H, 2 * H, scale=0.5) if with_att else None,
            _f64(rng, 2 * H) if with_att else None]

    def f(*a):
        full = list(a)
        if not with_att:
            full = full[:3] + [None] + full[3:7] + [None, None]
        return cell_step.Cell.apply(cell_step.cell_plain, *full)

    assert torch.autograd.gradcheck(f, [a for a in args if a is not None])


def _cell_args(with_att, requires_grad=False, seed=3):
    rng = np.random.RandomState(seed)
    B, D, H = 6, 12, 16
    f = np.float32

    def t(*shape):
        return torch.from_numpy((rng.randn(*shape) * 0.3).astype(f)
                                ).requires_grad_(requires_grad)
    return [t(B, D), t(B, H), t(B, H), t(B, H) if with_att else None,
            t(D, 5 * H), t(5 * H), t(H, 5 * H), t(5 * H),
            t(H, 2 * H) if with_att else None,
            t(2 * H) if with_att else None]


@pytest.mark.parametrize("switch", [None, "1", "0"])
@pytest.mark.parametrize("with_att", [True, False])
def test_cell_cpu_dispatch_equals_cell_reference(monkeypatch, switch,
                                                 with_att):
    """On CPU tensors fused_cell is cell_reference with the switch set or
    unset (the kernel's plain version is cell_reference in f32), launches
    nothing, and carries the same gradients."""
    if switch is None:
        monkeypatch.delenv("CIC_FUSED_CELL", raising=False)
    else:
        monkeypatch.setenv("CIC_FUSED_CELL", switch)
    assert _dispatch.fused_cell_enabled() == (switch == "1")
    _dispatch.reset_launches()
    args = _cell_args(with_att, requires_grad=True)
    got = cell_step.fused_cell(*args)
    want = cell_step.cell_reference(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    live = [a for a in args if a is not None]
    g_got = torch.autograd.grad(sum(x.sum() for x in got), live)
    g_want = torch.autograd.grad(sum(x.sum() for x in want), live)
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    assert _dispatch.launches()["cell"] == 0


def test_attention_takes_gradients_on_cpu():
    """The attention now has a gradient: a grad-requiring input goes
    through the Function and gets the plain version's gradient."""
    rng = np.random.RandomState(0)
    f = np.float32
    B, K, H, A = 4, 5, 8, 6
    a = [torch.from_numpy(x).requires_grad_(True) for x in (
        rng.randn(B, H).astype(f), rng.randn(B, K, H).astype(f),
        rng.randn(B, K, A).astype(f), rng.randn(H, A).astype(f),
        rng.randn(A).astype(f), rng.randn(A, 1).astype(f),
        rng.randn(1).astype(f))]
    masks = torch.ones(B, K)
    masks[1, 3:] = 0.0
    out = att_step.fused_attention(*a, masks)
    assert out.grad_fn is not None and "Attention" in type(out.grad_fn).__name__
    g = torch.autograd.grad(out.square().sum(), a)
    want = torch.autograd.grad(
        att_step.attention_reference(*a, masks).square().sum(), a)
    for x, y in zip(g, want):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the optimizer and the BN running statistics
# ---------------------------------------------------------------------------

def _adam_state(jstate):
    """mu, nu of the optax ScaleByAdamState inside an injected chain."""
    for s in jstate.inner_state:
        if hasattr(s, "mu"):
            return s
    raise AssertionError("no Adam state")


def test_guarded_update_matches_jax_and_skips_non_finite():
    opt = tiny_opt(weight_decay=1e-3, grad_clip=0.05)
    p = jax_params(opt)
    rng = np.random.RandomState(0)
    gtrees = [jax.tree.map(lambda x: (rng.randn(*x.shape) * 0.1).astype(
        np.float32), p) for _ in range(2)]
    jm = joptim.OptimizerManager(opt, jax.tree.map(jnp.asarray, p))
    jm.set_lr(2e-3)
    tp = {"speaker": port_tree(p["speaker"])}
    tm = toptim.OptimizerManager(opt, tp)
    tm.set_lr(2e-3)
    jp = jax.tree.map(jnp.asarray, p)
    for g in gtrees:  # two steps: bias correction at count 1 and 2
        jp = jm.step(jp, jax.tree.map(jnp.asarray, g), "optimizer")
        tm.step(tp, to_torch(g, "cpu"), "optimizer")
        assert_tree_close(jp, tp, atol=1e-7, rtol=0)
        js = _adam_state(jm.states["speaker"])
        st = tm.states["speaker"]
        names = [k for k, _ in leaves(tp["speaker"])]
        assert_tree_close(js.mu, dict(zip(names, st["mu"])), atol=1e-7,
                          rtol=0)
        assert_tree_close(js.nu, dict(zip(names, st["nu"])), atol=1e-7,
                          rtol=0)
        assert int(st["count"]) == int(js.count)
    # a NaN anywhere in the gradients: nothing moves, the skip is counted
    before = to_numpy(tp)
    moments = [m.clone() for m in tm.states["speaker"]["mu"]]
    bad = jax.tree.map(np.copy, gtrees[0])
    bad["speaker"]["core"]["a2c"]["b"][3] = np.nan
    tm.step(tp, to_torch(bad, "cpu"), "optimizer")
    assert not bool(tm.last_step_ok)
    assert tm.skipped_steps() == 1
    assert int(tm.states["speaker"]["count"]) == 2
    for (k, want), (_, got) in zip(leaves(before), leaves(to_numpy(tp))):
        np.testing.assert_array_equal(want, got, err_msg=k)
    for a, b in zip(moments, tm.states["speaker"]["mu"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("phase,turn,alt,want", [
    (2, "optimizer", 0, ("speaker",)), (1, "optimizer", 0, ("listener",)),
    (3, "speaker", 1, ("speaker", "listener"))])
def test_agents_and_turns_match_jax(phase, turn, alt, want):
    opt = tiny_opt(phase=phase, is_alternating=alt,
                   alternating_turn=["speaker", "listener"])
    assert toptim.agents_to_update(opt, turn) == want
    assert toptim.agents_to_update(opt, turn) == \
        joptim.agents_to_update(opt, turn)
    assert toptim.effective_turns(opt) == joptim.effective_turns(opt)


@pytest.mark.parametrize("masked", [True, False])
def test_bn_running_update_matches_jax(masked):
    opt = tiny_opt(use_bn=1)
    p = jax_params(opt)["speaker"]
    rng = np.random.RandomState(4)
    p["att_bn"]["mean"] = rng.randn(20).astype(np.float32)
    p["att_bn"]["var"] = rng.rand(20).astype(np.float32) + 0.5
    data = numpy_batch(opt)
    am = data["att_masks"] if masked else None
    want = jatt.bn_running_update(jax.tree.map(jnp.asarray, p),
                                  jnp.asarray(data["att_feats"]),
                                  None if am is None else jnp.asarray(am))
    got = tatt.bn_running_update(
        to_torch(p, "cpu"), torch.from_numpy(data["att_feats"]),
        None if am is None else torch.from_numpy(am))
    for k in ("mean", "var", "scale", "bias"):
        np.testing.assert_allclose(np.asarray(want["att_bn"][k]),
                                   got["att_bn"][k].numpy(), rtol=1e-6,
                                   atol=1e-7)
    assert got["logit"]["w"] is not None


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_bn", [0, 1])
def test_trainer_three_steps_match_jax(use_bn):
    """Three port train_iterations against the same three steps through JAX
    make_raw_fns + OptimizerManager (+ bn_running_update), on the same
    batches and from the same params."""
    lr = 5e-3
    opt = tiny_opt(use_bn=use_bn, learning_rate=lr)
    tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                       verbose=False)
    jp = jax.tree.map(jnp.asarray, to_numpy(tr.params))
    jm = joptim.OptimizerManager(opt, jp)
    _, jvg = jjoint.make_raw_fns(opt, "optimizer")
    hp = jjoint.Hyper.from_opt(opt)
    for n in range(1, 4):
        loss_dict, turn, data = tr.train_iteration()
        assert turn == "optimizer"
        jb = jax_batch(data)
        (jloss, _), jg = jvg(jp, jb, jax.random.PRNGKey(n), hp,
                             jnp.zeros((4,), jnp.float32))
        jp = jm.step(jp, jg, "optimizer")
        if use_bn:
            jp = {"speaker": jatt.bn_running_update(
                jp["speaker"], jb["att_feats"], jb["att_masks"])}
        np.testing.assert_allclose(float(jloss), loss_dict["loss"].item(),
                                   rtol=1e-5 if n == 1 else 1e-4)
        assert_tree_close(jp, tr.params, atol=2 * lr * n, rtol=0)
    assert tr.iteration == 3 and set(tr.loss_history) == {1, 2, 3}
    assert tr.optim.skipped_steps() == 0


def test_trainer_learns_and_is_deterministic():
    opt = tiny_opt(drop_prob_lm=0.5, learning_rate=1e-2, use_bn=1)
    runs = []
    for _ in range(2):
        tr = tloop.Trainer(opt.replace(), dataset=tiny_dataset(opt),
                           device="cpu", verbose=False)
        data = tr.loader.get_batch("train")
        runs.append([tr.train_iteration(data)[0]["loss_cap"].item()
                     for _ in range(15)])
    assert runs[0] == runs[1]
    assert np.mean(runs[0][-3:]) < runs[0][0]


@pytest.mark.parametrize("kw,match", [
    ({"fused_steps": 2}, "fused_steps"),
    ({"device_feature_cache": 1}, "device_feature_cache"),
    ({**TINY_LISTENER, "retrieval_reward": "reinforce",
      "retrieval_reward_weight": 0.5}, "REINFORCE DISC"),
    ({**TINY_LISTENER, "is_alternating": 1, "retrieval_reward": "reinforce",
      "alternating_turn": ["speaker", "listener"]},
     "effective turns.*listener turn"),
    ({"cider_optimization": 1, "on_device_cider": 1}, "device rewards"),
    ({"mesh_data_axis": 2, "cider_optimization": 1},
     "mesh.*multi-device, the rest"),
    ({"vse_model": "fc", "fused_steps": 2}, "fused_steps"),
    ({"cider_optimization": 1, "soft_cider": 1}, "device rewards"),
])
def test_trainer_raises_on_unported_options(kw, match):
    """What the Trainer does not train yet raises, naming its ROADMAP item:
    here a mesh run of SCST.  REINFORCE DISC and real alternation, fused
    steps, the device feature cache and the device reward tiers raised
    here until they were ported (their ids keep the messages they
    matched); they now train: two iterations equal to the JAX steps turn
    by turn (a fused_steps run without the cache on JAX's per-step path,
    with JAX's gate reason), and with the cache equal to the streamed
    Trainer's."""
    opt = tiny_opt(**kw)
    if "mesh" in match:
        with pytest.raises(NotImplementedError, match=match):
            tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                          verbose=False)
        return
    if kw.get("device_feature_cache"):
        from test_torch_fused_steps import assert_cache_trains_as_streamed
        assert_cache_trains_as_streamed(opt, 2)
        return
    from test_torch_listener_training import assert_trainer_matches_jax
    from cooperativeimagecaptioning_tpu.rewards import self_critical as jsc
    for m in (jsc, tloop.self_critical):
        m.reset_scorer()
        m.init_scorer("corpus")
    try:
        tr, _, _, turns = assert_trainer_matches_jax(opt, 2)
    finally:
        for m in (jsc, tloop.self_critical):
            m.reset_scorer()
    assert turns == (["speaker", "listener"] if opt.is_alternating
                     else ["optimizer"] * 2)
    if "fused_steps" in kw:
        jtr = jloop.Trainer(opt.replace(), dataset=tiny_dataset(opt),
                             verbose=False)
        assert tr._fused_gate() == jtr._fused_gate() != None  # noqa: E711
        jtr.close()


def test_train_stops_at_max_iterations_and_checkpoints(tmp_path):
    """train() stops at max_iterations, and checkpoint_operations writes the
    run dir (tests/test_torch_resume.py holds it to the JAX package's)."""
    opt = tiny_opt(checkpoint_path=str(tmp_path), id="t")
    tr = tloop.train(opt, dataset=tiny_dataset(opt), max_iterations=2,
                     device="cpu", verbose=False)
    assert tr.iteration == 2
    val_loss, _ = tr.checkpoint_operations()
    assert np.isfinite(val_loss["loss_cap"])
    for name in ("model.pth", "model-2.pth", "optimizer.pth", "infos_t.pkl",
                 "histories_t.pkl"):
        assert (tmp_path / name).is_file(), name


def test_train_main_parses_device(monkeypatch):
    seen = {}
    monkeypatch.setattr(ttrain, "train", lambda opt, device: seen.update(
        opt=opt, device=device))
    ttrain.main(["--device", "cpu", "--phase", "2", "--rnn_size", "24"])
    assert seen["device"] == "cpu" and seen["opt"].rnn_size == 24
    ttrain.main(["--phase", "2"])
    assert seen["device"] == "cuda"


def test_train_main_passes_resume_and_scst_flags(monkeypatch):
    """--start_from and --cider_optimization reach the Trainer's opt."""
    seen = {}
    monkeypatch.setattr(ttrain, "train", lambda opt, device: seen.update(
        opt=opt, device=device))
    ttrain.main(["--device", "cpu", "--phase", "3", "--start_from", "runs/a",
                 "--cider_optimization", "1", "--caption_loss_weight", "0"])
    opt = seen["opt"]
    assert (opt.start_from, opt.cider_optimization, opt.caption_loss_weight,
            opt.phase) == ("runs/a", 1, 0, 3)
    assert tloop.unported(opt) is None


def test_training_imports_no_jax():
    """The card's machine has no JAX: the trainer and its entry point run a
    step with none of it imported."""
    code = (
        "import sys\n"
        "import cooperativeimagecaptioning_tpu_torch.training.loop as L\n"
        "import cooperativeimagecaptioning_tpu_torch.train\n"
        "from cooperativeimagecaptioning_tpu_torch.config import Options\n"
        "from cooperativeimagecaptioning_tpu_torch.data import "
        "SyntheticDataset\n"
        "opt = Options(caption_model='att2in2', phase=2, batch_size=2, "
        "rnn_size=8, input_encoding_size=8, att_hid_size=4, "
        "fc_feat_size=6, att_feat_size=6, prefetch_batches=0)\n"
        "ds = SyntheticDataset(num_images=8, vocab_size=9, seq_length=5, "
        "fc_feat_size=6, att_feat_size=6, max_K=3)\n"
        "tr = L.Trainer(opt, dataset=ds, device='cpu', verbose=False)\n"
        "loss = tr.train_iteration()[0]['loss']\n"
        "assert loss.item() > 0\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ---------------------------------------------------------------------------
# the joint tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("phase", [2, 3])
def test_speaker_view_freezes_the_shared_embedding_in_phase_2(phase):
    """JAX joint.py:103-104: stop_gradient on the listener's embedding in
    phase 2; in phase 3 it trains through the speaker."""
    opt = tiny_opt(phase=phase, share_embed=1)
    emb = torch.nn.Parameter(torch.randn(5, 3))
    params = {"speaker": {"w": torch.nn.Parameter(torch.randn(3))},
              "listener": {"txt_enc": {"embed": emb}}}
    sp = tjoint.speaker_view(params, opt)
    loss = (sp["embed"] @ sp["w"]).square().sum()
    loss.backward()
    if phase == 2:
        assert emb.grad is None or not emb.grad.any()
    else:
        assert emb.grad is not None and emb.grad.abs().sum() > 0
    assert params["speaker"]["w"].grad.abs().sum() > 0


def test_param_tree_shares_trainable_leaves():
    tree = trainable({"a": {"w": torch.ones(2, 2)}, "b": torch.zeros(3)})
    mod = ParamTree(tree)
    assert mod.a.w is tree["a"]["w"] and mod.b is tree["b"]
    assert all(q.requires_grad for q in mod.parameters())
    frozen = ParamTree({"w": torch.ones(2)})
    assert not frozen.w.requires_grad
