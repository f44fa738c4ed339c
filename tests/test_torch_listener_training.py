"""Port parity: training with the listener -- phase-1 listener pretraining
and phase-3 joint training with the relaxed DISC loss -- of the PyTorch
port against the JAX package, on the CPU at tiny width (rnn 16, vocab 25,
L=8, vse_embed 16) in float32.

`joint.loss_fn`: the phase-1 GT contrastive term, and each of the four
relaxed DISC modes (gumbel, multinomial, gumbel_softmax, multinomial_soft)
with and without the CIDEr-D term (which reuses DISC's sample in the
gumbel and multinomial modes), under share_embed or not, on the speaker
turn and the non-alternating turn; the port's streams replay the noise the
JAX package draws along its named keys (joint.py:123-127): DISC's sampled
ids and stage A's ids equal, losses within 1e-5 relative, every gradient
leaf of both agents within 1e-4 of the leaf's largest entry (1e-6 at
least).  The Trainer:
phase-1 steps against the JAX update, the two bootstrap orders of the
cascade on JAX-written stage-1 and stage-2 run dirs (params and both
agents' Adam state equal), one effective turn, `_current_scores`, the
vse-best save, run dirs written by either package resumed by the other.
And the flag sets chip_smoke.py writes, equal to the scripts'."""

import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cooperativeimagecaptioning_tpu import data as jdata  # noqa: E402
from cooperativeimagecaptioning_tpu.models import att_model as jatt  # noqa: E402
from cooperativeimagecaptioning_tpu.ops import decoding as jdec  # noqa: E402
from cooperativeimagecaptioning_tpu.rewards import ngram_device as jnd  # noqa: E402
from cooperativeimagecaptioning_tpu.rewards import self_critical as jsc  # noqa: E402
from cooperativeimagecaptioning_tpu.training import joint as jjoint  # noqa: E402
from cooperativeimagecaptioning_tpu.training import loop as jloop  # noqa: E402
from cooperativeimagecaptioning_tpu.training import optim as joptim  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.models import att_model as tatt  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.ops import decoding as tdec  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.ops import draws  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.rewards import self_critical as tsc  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import checkpoint as tckpt  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import joint as tjoint  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import loop as tloop  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import optim as toptim  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.utils.tree import (  # noqa: E402
    detached, leaves, to_numpy)
from test_torch_resume import (  # noqa: E402
    DS, _pure_python_metrics, adam_of, assert_adam_equal, jax_opt, run_opt)
from test_torch_sampling import jax_sample_noise  # noqa: E402
from test_torch_training import (  # noqa: E402
    GRAD_TOL, LOSS_TOL, assert_tree_close, jax_batch, numpy_batch, port_batch,
    port_tree, tiny_dataset, tiny_opt)

assert _pure_python_metrics  # the autouse fixture, imported to apply here
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_REL = 1e-4
MODES = ("gumbel", "multinomial", "gumbel_softmax", "multinomial_soft")
LISTENER = dict(vse_model="fc", vse_embed_size=16)


@pytest.fixture(autouse=True)
def _fresh_scorers():
    """Both packages keep one process-wide CIDEr-D scorer."""
    for m in (jsc, tsc):
        m.reset_scorer()
        m.init_scorer("corpus")
    yield
    for m in (jsc, tsc):
        m.reset_scorer()


def phase1_opt(**kw):
    base = dict(LISTENER, caption_model="fc", phase=1, vse_loss_weight=1,
                caption_loss_weight=0, learning_rate=5e-3)
    base.update(kw)
    return tiny_opt(**base)


def disc_opt(mode, cider=0.99, share=0, alternating=1, **kw):
    """run_joint.py's flag set for `mode` at tiny width (weights raised so
    that each term moves the gradients)."""
    base = dict(LISTENER, phase=3, retrieval_reward=mode,
                retrieval_reward_weight=0.5, cider_optimization=cider,
                caption_loss_weight=0, vse_loss_weight=1, share_embed=share,
                is_alternating=alternating,
                alternating_turn=["speaker", "listener"] if alternating
                else None, prob_gumbel_softmax=0.5, prob_multinomial_soft=0.5,
                gumbel_temp=2.0, multinomial_temp=1.5)
    base.update(kw)
    return tiny_opt(**base)


def joint_params(opt, seed=0):
    """A joint numpy tree from the JAX init_params; the speaker's logit and
    embedding weights scaled up so that samples move between words."""
    p = jax.tree.map(np.asarray, jjoint.init_params(
        jax.random.PRNGKey(seed), opt))
    p["speaker"]["logit"]["w"] = p["speaker"]["logit"]["w"] * 12.0
    emb = p["listener"]["txt_enc"] if opt.share_embed else p["speaker"]
    emb["embed"] = emb["embed"] * 10.0
    return p


def port_params(p):
    return {agent: port_tree(tree) for agent, tree in p.items()}


def replay_streams(key, opt, B, turn):
    """The port's named streams replaying what the JAX package draws from
    `key` (dropout off): DISC's sample in its mode (REINFORCE's: a
    multinomial sample), the CIDEr sample where it is not DISC's, the
    listener turn's sample."""
    r = jjoint._rngs(key)
    out = {name: draws.Replay([]) for name in tjoint.STREAMS}
    C, L = opt.vocab_size + 1, opt.seq_length
    if turn == "listener":
        out["listener"] = draws.Replay(jax_sample_noise(
            r["listener"], "sample", B, C, L))
    if tjoint._disc_active(opt, turn):
        out["disc"] = draws.Replay(jax_sample_noise(
            r["disc"], tjoint._MODE_MAP.get(opt.retrieval_reward, "sample"),
            B, C, L))
    if opt.cider_optimization > 0 and \
            not tjoint._cider_reuses_disc(opt, turn):
        out["cider"] = draws.Replay(jax_sample_noise(r["cider"], "sample",
                                                     B, C, L))
    return out


def assert_grads_close(jtree, ttree):
    """Every leaf of both agents within GRAD_REL of its largest entry, with
    GRAD_TOL's atol as the floor: a leaf whose true gradient is zero (the
    attention's alpha_net.b, which the softmax does not feel) holds only
    rounding noise in both packages."""
    want = {".".join(str(k.key) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_leaves_with_path(jtree)}
    got = {k: v.detach().numpy() for k, v in leaves(ttree)}
    assert set(want) == set(got)
    for k, w in want.items():
        bound = max(GRAD_REL * np.abs(w).max(), GRAD_TOL["atol"])
        assert np.abs(w - got[k]).max() <= bound, k


def both_steps(opt, turn, seed=0):
    """(JAX (loss, aux), grads), (port (loss, aux), grads, sampled) of one
    loss_fn on one batch and one reward vector."""
    data = numpy_batch(opt, seed=seed)
    p = joint_params(opt, seed=seed)
    key = jax.random.PRNGKey(30 + seed)
    B = data["labels"].shape[0]
    reward = np.random.RandomState(seed).randn(B).astype(np.float32)
    _, jvg = jjoint.make_raw_fns(opt, turn)
    jout = jvg(jax.tree.map(jnp.asarray, p), jax_batch(data), key,
               jjoint.Hyper.from_opt(opt), jnp.asarray(reward))
    sampled = {}
    tout = tjoint.value_and_grad(opt, turn)(
        port_params(p), port_batch(data), replay_streams(key, opt, B, turn),
        tjoint.Hyper.from_opt(opt), torch.from_numpy(reward), sampled)
    return (p, data, key), jout, tout, sampled


def assert_step_close(jout, tout):
    (jloss, jaux), jgrads = jout
    (loss, aux), grads = tout
    assert set(aux) == set(jaux)
    np.testing.assert_allclose(float(jloss), loss.item(), **LOSS_TOL)
    for k in aux:
        np.testing.assert_allclose(float(jaux[k]), aux[k].item(),
                                   **LOSS_TOL)
    assert_grads_close(jgrads, grads)


# the aux terms of the total loss and their weights' options
WEIGHTS = {"loss_cap": "caption_loss_weight", "loss_vse": "vse_loss_weight",
           "retrieval_sc_loss": "retrieval_reward_weight",
           "loss_cider": "cider_optimization"}


def surrogate_scale(opt, p, data, key, turn):
    """sum_i (|r_i| + |b_i|) |sum_t logp_it m_it| / sum(m): the surrogate
    `self_critical_loss` taken over the magnitudes of its inputs, the
    sample's retrieval loss r and the baseline b, before their difference
    cancels.  The packages' r and b differ by f32 rounding (the GRU's and
    the products' summation order), and the coefficient r - b is a small
    difference of two such values, so LOSS_TOL's rtol holds the surrogate
    relative to this scale, the standard bound of a difference."""
    tp, tb = detached(port_params(p)), port_batch(data)
    B = data["labels"].shape[0]
    hp = tjoint.Hyper.from_opt(opt)
    V, L = opt.vocab_size, opt.seq_length
    with torch.no_grad():
        spk, r, ctx = tjoint._speaker({"speaker": tatt.AttModel}, tp, opt,
                                      tb, replay_streams(key, opt, B, turn),
                                      False, 0.0)
        out = tdec.sample(spk, ctx, L, r["disc"], mode="sample")
        seqs, masks = tjoint._sampled_captions(out.seq, V)
        fc = tb["fc_feats"]
        ret = tjoint._listener_loss(tp, opt, hp, fc, seqs, masks,
                                    whole_batch=True)
        kind = opt.reinforce_baseline_type
        if kind == "greedy":
            gseq = tdec.sample(spk, ctx, L, None, mode="greedy").seq
            base = tjoint._listener_loss(
                tp, opt, hp, fc, *tjoint._sampled_captions(gseq, V),
                whole_batch=True)
        elif kind == "gt":
            base = tjoint._listener_loss(tp, opt, hp, fc, tb["labels"],
                                         tb["masks"], whole_batch=True)
        else:
            base = torch.zeros_like(ret)
        m = masks[:, 1:]
        return float(((ret.abs() + base.abs())
                      * (out.logprobs * m).sum(dim=1).abs()).sum() / m.sum())


def assert_losses_close(opt, jloss, jaux, loss, aux, rtol, scale=None):
    """The total and each aux entry of the port (tensors) against JAX's
    within `rtol`; with `scale` (`surrogate_scale`), REINFORCE's surrogate
    relative to it, and the total relative to the sum of its weighted
    terms' sizes."""
    assert set(jaux) <= set(aux)
    total = 0.0
    for k in jaux:
        want, got = float(jaux[k]), float(aux[k])
        size = scale if k == "retrieval_sc_loss" and scale is not None \
            else abs(want)
        if k in WEIGHTS:
            total += getattr(opt, WEIGHTS[k]) * size
        assert abs(got - want) <= rtol * size, (k, got, want, size)
    size = abs(float(jloss)) if scale is None else total
    assert abs(float(loss) - float(jloss)) <= rtol * size


def assert_reinforce_close(opt, jout, tout, scale):
    """assert_step_close with the surrogate, and the total it enters, held
    to LOSS_TOL's rtol of their scale (`surrogate_scale`; the other terms
    at their magnitudes)."""
    (jloss, jaux), jgrads = jout
    (loss, aux), grads = tout
    assert set(aux) == set(jaux)
    assert_losses_close(opt, jloss, jaux, loss, aux, LOSS_TOL["rtol"], scale)
    assert_grads_close(jgrads, grads)


def reinforce_active(opt, turn):
    return tjoint._disc_active(opt, turn) and \
        opt.retrieval_reward == "reinforce"


def reinforce_steps(opt, turn, seed):
    """both_steps, and the surrogate's scale on the same inputs."""
    (p, data, key), jout, tout, sampled = both_steps(opt, turn, seed=seed)
    scale = surrogate_scale(opt, p, data, key, turn)
    assert_reinforce_close(opt, jout, tout, scale)
    return jout, tout, sampled


def assert_turn_matches_jax(opt, turn, seed=0):
    """loss_fn of `turn` (REINFORCE by its scale) and, where the turn runs
    it, stage A's ids against JAX's on replayed noise."""
    (p, data, key), jout, tout, _ = both_steps(opt, turn, seed=seed)
    if reinforce_active(opt, turn):
        assert_reinforce_close(opt, jout, tout,
                               surrogate_scale(opt, p, data, key, turn))
    else:
        assert_step_close(jout, tout)
    if not tjoint.needs_reward(opt, turn):
        return tout
    jsample, _ = jjoint.make_raw_fns(opt, turn)
    want = jsample(jax.tree.map(jnp.asarray, p), jax_batch(data), key,
                   jjoint.Hyper.from_opt(opt))
    got = tjoint.sampler(opt, turn)(
        port_params(p), port_batch(data),
        replay_streams(key, opt, data["labels"].shape[0], turn),
        tjoint.Hyper.from_opt(opt))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    return tout


def assert_trainer_matches_jax(opt, steps, key0=100):
    """`steps` Trainer iterations against the JAX make_raw_fns(opt, turn)
    and OptimizerManager.step, turn by turn, on the same batches and start;
    the port's streams replay what JAX draws from key(key0 + iteration):
    stage A's ids equal JAX's, the losses within LOSS_TOL at the first
    step and 1e-4 after (the params have moved apart; REINFORCE's surrogate
    by `assert_losses_close`), the params within 2 lr steps, the Adam
    counts equal.  Returns (port Trainer, JAX optimizer,
    JAX params, the turns taken)."""
    tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                       verbose=False)
    jp = jax.tree.map(jnp.asarray, to_numpy(tr.params))
    jm = joptim.OptimizerManager(opt, jp)
    B = opt.batch_size * opt.seq_per_img
    tr.iteration_streams = lambda: replay_streams(
        jax.random.PRNGKey(key0 + tr.iteration), opt, B, tr.turn)
    lr = opt.learning_rate
    turns = []
    for n in range(steps):
        key = jax.random.PRNGKey(key0 + tr.iteration)
        hp = jjoint.Hyper(*(jnp.float32(float(v)) for v in tr._hyper()))
        jm.set_lr(tr.optim.lr)
        before = to_numpy(tr.params)
        loss_dict, turn, data = tr.train_iteration()
        turns.append(turn)
        jsample, jvg = jjoint.make_raw_fns(opt, turn)
        jb = jax_batch(data)
        if jjoint.needs_device_refs(opt) and jjoint._cider_active(opt, turn):
            # a device reward tier's refs, as the JAX Trainer pads them
            jb["refs"], jb["ref_mask"] = jnd.pad_gts(data["gts"])
        reward = jnp.zeros((B,), jnp.float32)
        if jjoint.needs_reward(opt, turn):
            gen, greedy = (np.asarray(x) for x in jsample(jp, jb, key, hp))
            np.testing.assert_array_equal(gen,
                                          tr.last_reward_seqs[0].numpy())
            scores, _ = jsc.get_self_critical_reward(data["gts"], gen, greedy)
            reward = jnp.asarray(scores, jnp.float32)
        (jloss, jaux), jg = jvg(jp, jb, key, hp, reward)
        jp = jm.step(jp, jg, turn)
        scale = surrogate_scale(opt, before, data, key, turn) \
            if reinforce_active(opt, turn) else None
        assert_losses_close(opt, jloss, jaux, loss_dict["loss"], loss_dict,
                            LOSS_TOL["rtol"] if n == 0 else 1e-4, scale)
        assert_tree_close(jp, tr.params, atol=2 * lr * (n + 1), rtol=0)
        for agent, st in tr.optim.states.items():
            assert int(st["count"]) == int(adam_of(jm.states[agent]).count)
    return tr, jm, jp, turns


# ---------------------------------------------------------------------------
# joint.loss_fn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_violation", [0, 1])
def test_phase1_loss_matches_jax(max_violation):
    """The GT contrastive term alone: the listener's gradients, zeros for
    the FC speaker."""
    opt = phase1_opt(vse_max_violation=max_violation)
    _, jout, tout, _ = both_steps(opt, "optimizer")
    assert_step_close(jout, tout)
    assert set(tout[0][1]) == {"loss_vse", "vse_contrastive"}
    assert all(g.abs().sum() == 0 for _, g in leaves(tout[1]["speaker"]))
    assert all(g.abs().sum() > 0 for _, g in leaves(tout[1]["listener"]))


@pytest.mark.parametrize("share", [0, 1], ids=["own_embed", "share_embed"])
@pytest.mark.parametrize("cider", [0.0, 0.99], ids=["disc", "disc_cider"])
@pytest.mark.parametrize("mode", MODES)
def test_disc_loss_matches_jax(mode, cider, share):
    """The relaxed DISC branch: the relaxed one-hots with a one-hot BOS row
    through the listener, the gradient reaching both agents; with the CIDEr
    term, DISC's sample reused in the gumbel and multinomial modes.  The
    speaker turn (alternating; the GT term zeroed) with cider, the
    non-alternating `_speaker` turn (the GT term kept) without."""
    alternating = int(cider > 0)
    turn = "speaker" if alternating else "optimizer"
    opt = disc_opt(mode, cider=cider, share=share, alternating=alternating)
    (p, data, key), jout, tout, sampled = both_steps(opt, turn,
                                                     seed=MODES.index(mode))
    assert_step_close(jout, tout)
    aux = tout[0][1]
    assert "retrieval_loss" in aux and ("loss_vse" in aux) != alternating
    assert ("loss_cider" in aux) == (cider > 0)
    # DISC's ids are the JAX package's sample of r['disc'] in the DISC mode
    jp = jax.tree.map(jnp.asarray, p)
    sp = jjoint.speaker_view(jp, opt)
    jb = jax_batch(data)
    r = jjoint._rngs(key)
    ctx = jatt.encode_features(sp, None, jb["att_feats"], jb["att_masks"],
                               r["xe"], True, 0.0)
    want = jdec.sample(jatt, sp, ctx, opt.seq_length, r["disc"],
                       mode=tjoint._MODE_MAP[mode], temperature=1.0,
                       **{k: v for k, v in jjoint._sample_kwargs(
                           opt, jjoint.Hyper.from_opt(opt), True).items()
                          if k != "remat"})
    np.testing.assert_array_equal(np.asarray(want.seq),
                                  sampled["disc_seq"].numpy())
    if cider > 0:
        reuse = mode in ("gumbel", "multinomial")
        assert torch.equal(sampled["seq"], sampled["disc_seq"]) == reuse
    grads = tout[1]
    for agent in ("speaker", "listener"):
        assert any(g.abs().sum() > 0 for _, g in leaves(grads[agent]))


@pytest.mark.parametrize("mode", MODES)
def test_sample_for_reward_draws_the_disc_stream(mode):
    """Stage A: in the gumbel and multinomial modes the CIDEr sample is
    DISC's (the 'disc' stream in the DISC mode; the 'cider' stream is not
    touched), else a multinomial sample of the 'cider' stream; JAX's ids
    either way, and stage B's."""
    opt = disc_opt(mode)
    data = numpy_batch(opt, seed=2)
    p = joint_params(opt, seed=2)
    key = jax.random.PRNGKey(7)
    hp = jjoint.Hyper.from_opt(opt)
    jsample, _ = jjoint.make_raw_fns(opt, "speaker")
    jgen, jgreedy = (np.asarray(x) for x in jsample(
        jax.tree.map(jnp.asarray, p), jax_batch(data), key, hp))
    B = data["labels"].shape[0]
    tp, tb = port_params(p), port_batch(data)
    streams = replay_streams(key, opt, B, "speaker")
    gen, greedy = tjoint.sampler(opt, "speaker")(
        tp, tb, streams, tjoint.Hyper.from_opt(opt))
    np.testing.assert_array_equal(jgen, gen.numpy())
    np.testing.assert_array_equal(jgreedy, greedy.numpy())
    used = "disc" if mode in ("gumbel", "multinomial") else "cider"
    assert streams[used].done() and streams[used].pos > 0
    sampled = {}
    tjoint.value_and_grad(opt, "speaker")(
        tp, tb, replay_streams(key, opt, B, "speaker"),
        tjoint.Hyper.from_opt(opt), torch.zeros(B), sampled)
    assert torch.equal(sampled["seq"], gen)


def test_disc_stage_b_redraws_stage_a_with_dropout():
    """Dropout 0.5 and the checkpointed steps, on the port's own streams:
    stage B's DISC sample (reused by CIDEr) is stage A's."""
    opt = disc_opt("gumbel", drop_prob_lm=0.5, remat=1)
    data = numpy_batch(opt)
    tp, tb = port_params(joint_params(opt)), port_batch(data)
    hp = tjoint.Hyper.from_opt(opt)
    gen, _ = tjoint.sampler(opt, "speaker")(tp, tb, tjoint.streams(5, "cpu"),
                                            hp)
    sampled = {}
    (loss, _), _ = tjoint.value_and_grad(opt, "speaker")(
        tp, tb, tjoint.streams(5, "cpu"), hp, torch.ones(4), sampled)
    assert torch.equal(gen, sampled["seq"]) and np.isfinite(loss.item())


def test_init_params_with_a_listener():
    """The joint tree of both packages: the same paths and shapes; under
    share_embed the table lives only under the listener."""
    for share in (0, 1):
        opt = disc_opt("gumbel", share=share)
        want = {".".join(str(k.key) for k in path): x.shape
                for path, x in jax.tree_util.tree_leaves_with_path(
                    jjoint.init_params(jax.random.PRNGKey(0), opt))}
        got = {k: tuple(x.shape) for k, x in leaves(tjoint.init_params(
            0, opt))}
        assert got == want
        assert ("speaker.embed" in got) != share


def test_prepend_bos_matches_jax():
    seq = np.random.RandomState(0).randint(0, 9, (3, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jjoint._prepend_bos_ids(jnp.asarray(seq), 10)),
        tjoint._prepend_bos_ids(torch.from_numpy(seq), 10).numpy())
    soft = np.random.RandomState(1).rand(3, 5, 12).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jjoint._prepend_bos_one_hot(jnp.asarray(soft), 10)),
        tjoint._prepend_bos_one_hot(torch.from_numpy(soft), 10).numpy())


@pytest.mark.parametrize("turn,kw,match", [
    ("listener", {}, "listener turn.*ROADMAP.*joint training"),
    ("speaker", {"retrieval_reward": "reinforce"},
     "REINFORCE.*ROADMAP.*joint training"),
    ("optimizer", {"cider_optimization": 1, "on_device_cider": 1},
     "ROADMAP.*device rewards"),
])
def test_loss_fn_refuses_what_is_not_ported(turn, kw, match):
    """The listener turn, REINFORCE and the device reward tiers raised
    here until they were ported (their ids keep the messages they
    matched); they now run, and loss_fn (with the batch's refs for a
    device tier) and stage A equal JAX's."""
    opt = disc_opt("gumbel", **kw)
    if "device rewards" in match:
        from test_torch_device_rewards import assert_tier_step_matches_jax
        assert_tier_step_matches_jax(opt, turn, seed=3)
        return
    assert_turn_matches_jax(opt, turn, seed=3)


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

def test_turns_and_agents_match_jax():
    cases = [phase1_opt(), tiny_opt(phase=2)]
    for mode in MODES + ("reinforce",):
        cases += [disc_opt(mode), disc_opt(mode, alternating=0),
                  disc_opt(mode, alternating_turn=["listener"])]
    for opt in cases:
        assert toptim.effective_turns(opt) == joptim.effective_turns(opt)
        for turn in ("speaker", "listener", "optimizer"):
            assert toptim.agents_to_update(opt, turn) == \
                joptim.agents_to_update(opt, turn)


def test_phase1_trainer_steps_match_jax():
    """Three phase-1 iterations against the same steps through the JAX
    make_raw_fns + OptimizerManager: only the listener moves."""
    lr = 5e-3
    opt = phase1_opt(learning_rate=lr)
    tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                       verbose=False)
    start = to_numpy(tr.params)
    jp = jax.tree.map(jnp.asarray, start)
    jm = joptim.OptimizerManager(opt, jp)
    _, jvg = jjoint.make_raw_fns(opt, "optimizer")
    hp = jjoint.Hyper.from_opt(opt)
    for n in range(1, 4):
        loss_dict, turn, data = tr.train_iteration()
        assert turn == "optimizer"
        # the FC speaker reads no attention features
        jb = {k: jnp.asarray(data[k]) for k in ("fc_feats", "labels",
                                                "masks")}
        jb.update(att_feats=None, att_masks=None)
        (jloss, _), jg = jvg(jp, jb, jax.random.PRNGKey(n), hp,
                             jnp.zeros((4,), jnp.float32))
        jp = jm.step(jp, jg, "optimizer")
        np.testing.assert_allclose(float(jloss), loss_dict["loss"].item(),
                                   rtol=1e-5 if n == 1 else 1e-4)
        assert_tree_close(jp, tr.params, atol=2 * lr * n, rtol=0)
    now = to_numpy(tr.params)
    for k, v in leaves(start):
        assert np.array_equal(v, dict(leaves(now))[k]) == \
            k.startswith("speaker"), k


def test_joint_trainer_takes_one_effective_turn(tmp_path):
    """run_joint.py -o gumbel: is_alternating with one effective turn,
    'speaker', which updates both agents; the loss dict carries DISC and
    CIDEr-D; stage B's ids equal stage A's."""
    opt = disc_opt("gumbel", learning_rate=1e-2, drop_prob_lm=0.5,
                   checkpoint_path=str(tmp_path))
    tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                       verbose=False)
    assert tr.turns == ["speaker"]
    before = to_numpy(tr.params)
    for _ in range(2):
        loss_dict, turn, _ = tr.train_iteration()
        assert turn == "speaker"
        a, b = tr.last_reward_seqs
        assert torch.equal(a, b)
        assert {"loss", "retrieval_loss", "loss_cider", "avg_reward",
                "cider_greedy"} <= set(loss_dict)
        assert all(np.isfinite(float(v)) for v in loss_dict.values())
    after = dict(leaves(to_numpy(tr.params)))
    for agent in ("speaker", "listener"):
        assert any(not np.array_equal(v, after[k])
                   for k, v in leaves(before) if k.startswith(agent)), agent
    assert tr.optim.skipped_steps() == 0


def test_softmax_cooling_refreshes_every_iteration():
    opt = disc_opt("gumbel_softmax", softmax_cooling_decay_factor=0.5)
    tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                       verbose=False)
    tr.train_iteration()
    tr.epoch += 3  # as if three epochs passed without a wrap
    tr.train_iteration()
    pg, _ = tr._pg, tr._pm
    from cooperativeimagecaptioning_tpu.training import schedules
    assert pg == schedules.soft_sampling_probs(opt, 3, 0)[0] != 0.5


def test_current_scores_match_jax():
    cases = [
        (phase1_opt(), {}, {"loss_vse": 1.0, "val": {"rsum": 1.5},
                            "test": {"rsum": 1.2}}),
        (phase1_opt(language_eval=1), {"val": {"CIDEr": 0.3}},
         {"val": {"rsum": 2.0}}),
        (disc_opt("gumbel", language_eval=1), {"CIDEr": 0.7},
         {"rsum": 0.25, "loss_cider": -0.1}),
        (disc_opt("gumbel", language_eval=0), {}, {"rsum": 0.5,
                                                   "loss_cap": 2.0}),
    ]
    for opt, lang, val in cases:
        holder = types.SimpleNamespace(opt=opt)
        assert tloop.Trainer._current_scores(holder, lang, val) == \
            jloop.Trainer._current_scores(holder, lang, val)


def test_phase1_checkpoint_ranks_both_splits_and_saves_vse_best(tmp_path):
    """The stage-1 run dir: rank metrics for val and test, model_vse-best
    written when rsum improves (and not when it does not), optimizer.pth
    holding the listener."""
    opt = phase1_opt(checkpoint_path=str(tmp_path), id="fc", rank_eval=1,
                     val_images_use=-1)
    tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                       verbose=False)
    tr.train_iteration()
    val_loss, _ = tr.checkpoint_operations()
    assert set(val_loss["val"]) >= {"rsum", "i2t_r1", "t2i_r1"}
    assert "rsum" in val_loss["test"]
    assert tr.best_val_score_vse == val_loss["val"]["rsum"] * 100
    best = tmp_path / "model_vse-best.pth"
    first = tckpt.load_params(str(best))
    st = tckpt.read_optimizer_file(str(tmp_path / "optimizer.pth"))
    listener = tr.optim.state_dict()["listener"]
    mapped = tckpt.adam_state_from_file(st, tr.optim.paths["listener"],
                                        [m.shape for m in listener["mu"]])
    assert mapped is not None and int(mapped["count"]) == 1
    tr.best_val_score_vse = float("inf")
    tr.train_iteration()
    tr.checkpoint_operations()
    for (k, a), (_, b) in zip(leaves(first), leaves(tckpt.load_params(
            str(best)))):
        assert torch.equal(a, b), k
    assert not torch.equal(first["listener"]["img_enc"]["fc"]["w"],
                           tckpt.load_params(str(tmp_path / "model.pth"))
                           ["listener"]["img_enc"]["fc"]["w"])


# -- the bootstrap cascade on JAX-written stage dirs --------------------------

@pytest.fixture(scope="module")
def stage_dirs(tmp_path_factory):
    """A JAX phase-2 run dir (the stage-2 speaker, its optax
    optimizer.pth) and a JAX phase-1 run dir (the stage-1 listener,
    optimizer.pth holding the listener's Adam state)."""
    root = tmp_path_factory.mktemp("stages")
    out = {}
    for name, kw in (("att", dict(phase=2)),
                     ("fc_con", dict(LISTENER, caption_model="fc", phase=1,
                                     vse_loss_weight=1,
                                     caption_loss_weight=0))):
        opt = jax_opt(run_opt(root / name, id=name, **kw))
        tr = jloop.Trainer(opt, dataset=jdata.SyntheticDataset(**DS),
                           verbose=False)
        for _ in range(2):
            tr.train_iteration()
        tr.checkpoint_operations()
        out[name] = (str(root / name), tr)
    return out


def cascade_opt(path, stage_dirs, alternating, **kw):
    att, fc = stage_dirs["att"][0], stage_dirs["fc_con"][0]
    return run_opt(path, id="j", **dict(dict(
        LISTENER, phase=3, retrieval_reward="gumbel",
        retrieval_reward_weight=0.5, cider_optimization=0,
        caption_loss_weight=0, is_alternating=alternating,
        alternating_turn=["speaker", "listener"] if alternating else None,
        start_from=str(path),
        speaker_stage_2_model_path=os.path.join(att, "model.pth"),
        speaker_stage_2_optimizer_path=os.path.join(att, "optimizer.pth"),
        initialize_retrieval=os.path.join(fc, "model_vse-best.pth")), **kw))


def both_trainers(opt):
    jtr = jloop.Trainer(jax_opt(opt), dataset=jdata.SyntheticDataset(**DS),
                        verbose=False)
    tr = tloop.Trainer(opt.replace(), dataset=tiny_dataset(opt),
                       device="cpu", verbose=False)
    return jtr, tr


@pytest.mark.parametrize("alternating", [1, 0])
def test_bootstrap_seeds_the_speaker_and_the_listener(tmp_path, stage_dirs,
                                                      alternating):
    """A fresh joint dir: the stage-2 speaker and the stage-1 listener
    (initialize_retrieval), with both agents' Adam state from the files
    beside them, in both packages."""
    os.makedirs(tmp_path / "j")
    jtr, tr = both_trainers(cascade_opt(tmp_path / "j", stage_dirs,
                                        alternating))
    assert_tree_close(jtr.params, tr.params, rtol=0, atol=0)
    jatt_tr, jfc_tr = stage_dirs["att"][1], stage_dirs["fc_con"][1]
    assert_tree_close(jatt_tr.params["speaker"], tr.params["speaker"],
                      rtol=0, atol=0)
    for agent in ("speaker", "listener"):
        assert_adam_equal(jtr.optim.states[agent], tr.optim.states[agent],
                          tr.optim.paths[agent])
    assert int(tr.optim.states["listener"]["count"]) == \
        int(adam_of(jfc_tr.optim.states["listener"]).count) > 0


def test_bootstrap_orders_differ_on_a_resume(tmp_path, stage_dirs):
    """start_from holding a trained joint model: alternating, its lenient
    merge comes last and keeps the trained listener; not alternating,
    model.pth comes first and the initialize_retrieval listener overlays
    it.  Both packages agree on each."""
    stage_listener = tckpt.load_params(os.path.join(
        stage_dirs["fc_con"][0], "model_vse-best.pth"))["listener"]
    for alternating in (1, 0):
        run = tmp_path / f"run{alternating}"
        os.makedirs(run)
        trained = jax.tree.map(np.asarray, jjoint.init_params(
            jax.random.PRNGKey(40), cascade_opt(run, stage_dirs,
                                                alternating)))
        name = "alternatingModel.pth" if alternating else "model.pth"
        tckpt.save_params(trained, str(run / name))
        jtr, tr = both_trainers(cascade_opt(run, stage_dirs, alternating))
        assert_tree_close(jtr.params, tr.params, rtol=0, atol=0)
        want = trained["listener"] if alternating else stage_listener
        assert_tree_close(want, tr.params["listener"], rtol=0, atol=0)
        assert_tree_close(trained["speaker"], tr.params["speaker"], rtol=0,
                          atol=0)


def test_bootstrap_honours_continue_from_existing_models(tmp_path,
                                                         stage_dirs):
    opt = cascade_opt(tmp_path, stage_dirs, 1,
                      continue_from_existing_models=False)
    tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                       verbose=False)
    fresh = tjoint.init_params(opt.seed, opt)
    for (k, a), (_, b) in zip(leaves(fresh), leaves(tr.params)):
        assert torch.equal(a, b.detach()), k


def test_share_embed_skips_the_adam_seeding(tmp_path, stage_dirs):
    opt = cascade_opt(tmp_path, stage_dirs, 1, share_embed=1)
    tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                       verbose=False)
    assert "embed" not in tr.params["speaker"]
    assert all(int(st["count"]) == 0 for st in tr.optim.states.values())


# -- run dirs across the packages ---------------------------------------------

def test_a_jax_phase1_run_resumes_in_the_port(stage_dirs, tmp_path):
    path, jtr = stage_dirs["fc_con"]
    opt = run_opt(tmp_path, id="fc_con", start_from=path, **dict(
        LISTENER, caption_model="fc", phase=1, vse_loss_weight=1,
        caption_loss_weight=0))
    tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                       verbose=False)
    assert_tree_close(jtr.params, tr.params, rtol=0, atol=0)
    assert_adam_equal(jtr.optim.states["listener"],
                      tr.optim.states["listener"], tr.optim.paths["listener"])
    assert (tr.iteration, tr.best_val_score_vse) == (
        jtr.iteration, jtr.best_val_score_vse)


def test_a_port_joint_run_resumes_in_jax(tmp_path, stage_dirs):
    """A port-written alternating run dir (alternatingModel.pth and the
    per-agent optimizer files) loads its params into the JAX Trainer."""
    run = tmp_path / "port"
    opt = cascade_opt(run, stage_dirs, 1, start_from=None)
    tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                       verbose=False)
    tr.train_iteration()
    tr.checkpoint_operations()
    written = set(os.listdir(run))
    assert {"alternatingModel.pth", "alternatingModel-1.pth",
            "speaker_optimizer.pth", "listener_optimizer.pth",
            "model_vse-best.pth", "model-best.pth"} <= written
    again = cascade_opt(run, stage_dirs, 1, start_from=str(run))
    jtr = jloop.Trainer(jax_opt(again), dataset=jdata.SyntheticDataset(**DS),
                        verbose=False)
    assert_tree_close(jtr.params, tr.params, rtol=0, atol=0)
    assert jtr.iteration == tr.iteration == 1


# ---------------------------------------------------------------------------
# the flag sets chip_smoke.py writes
# ---------------------------------------------------------------------------

def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_flag_sets_equal_the_scripts(monkeypatch, tmp_path):
    """chip_smoke.py trains with the port's drivers' flag sets (it imports
    them); those equal the JAX package's scripts."""
    from cooperativeimagecaptioning_tpu_torch.scripts import (
        run_fc_con as port_fc_con, run_joint as port_joint)
    smoke = _module("chip_smoke_flags", os.path.join(REPO, "chip_smoke.py"))
    fc_con = _module("run_fc_con_flags",
                     os.path.join(REPO, "scripts", "run_fc_con.py"))
    run_joint = _module("run_joint_flags",
                        os.path.join(REPO, "scripts", "run_joint.py"))
    assert smoke.PHASE1_FLAGS is port_fc_con.STAGE_FLAGS
    assert smoke.JOINT_BASE is port_joint.JOINT_BASE
    assert smoke.PHASE1_FLAGS == fc_con.STAGE_FLAGS
    for mode in MODES + ("gumbel_speaker", "multinomial_speaker",
                         "reinforce", "reinforce_listener",
                         "reinforce_speaker"):
        for vse in (0, 1):
            assert smoke.joint_flags(mode, vse=vse) == \
                port_joint.joint_flags(optimization=mode, vse=vse)[1] == \
                run_joint.joint_flags(optimization=mode, vse=vse)[1], \
                (mode, vse)
    # the script's Options beside build_run's overrides
    seen = {}
    from cooperativeimagecaptioning_tpu.evaluation import harvest
    monkeypatch.setattr(jloop, "train", lambda opt: seen.update(opt=opt))
    monkeypatch.setattr(harvest, "create_dicts_and_json_after_training",
                        lambda opt: None)
    monkeypatch.setattr(sys, "path", list(sys.path))
    run_joint.main(["-o", "gumbel", "--root-dir", str(tmp_path)])
    opt = seen["opt"]
    for k, v in {**smoke.JOINT_BASE, **smoke.joint_flags("gumbel")}.items():
        assert getattr(opt, k) == v, k
