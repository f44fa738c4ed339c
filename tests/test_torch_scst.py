"""Port parity: self-critical CIDEr-D training of the Att2in2 speaker, the
PyTorch port against the JAX package on the CPU at tiny width (rnn 16,
vocab 25, L=8) in float32.

The host reward (`rewards/self_critical.py`) on the same id arrays within
1e-12; `self_critical_loss` / `masks_from_seq`; the two stages of an SCST
iteration -- stage A (`sample_for_reward`) fed the noise the JAX package
draws along its named streams (joint.py:123-127) gives JAX's ids, and stage
B (`loss_fn`) on JAX's sampled sequence and reward gives JAX's loss and
gradients within `LOSS_TOL` / `GRAD_TOL` of test_torch_training.py; and, in
the port alone, that stage B re-draws exactly stage A's trajectory from the
same streams, with dropout and the checkpointed steps.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cooperativeimagecaptioning_tpu.ops import losses as jlosses  # noqa: E402
from cooperativeimagecaptioning_tpu.rewards import self_critical as jsc  # noqa: E402
from cooperativeimagecaptioning_tpu.training import joint as jjoint  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.models import att_model as tatt  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.ops import draws  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.ops import losses as tlosses  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.rewards import self_critical as tsc  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import joint as tjoint  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import loop as tloop  # noqa: E402
from test_torch_sampling import jax_sample_noise  # noqa: E402
from test_torch_training import (  # noqa: E402
    GRAD_TOL, LOSS_TOL, assert_tree_close, jax_batch, jax_params,
    numpy_batch, port_batch, port_tree, tiny_dataset, tiny_opt)

MODULES = {"speaker": tatt.AttModel}


@pytest.fixture(autouse=True)
def _fresh_scorers():
    """Both packages keep one process-wide CIDEr-D scorer."""
    for m in (jsc, tsc):
        m.reset_scorer()
        m.init_scorer("corpus")
    yield
    for m in (jsc, tsc):
        m.reset_scorer()


def scst_opt(**kw):
    base = dict(cider_optimization=1, caption_loss_weight=0, phase=3)
    base.update(kw)
    return tiny_opt(**base)


# ---------------------------------------------------------------------------
# the host reward and the losses
# ---------------------------------------------------------------------------

def _ids(rng, B, L, V):
    seq = rng.randint(1, V + 1, size=(B, L))
    for i in range(B):  # an end token somewhere in most rows
        end = rng.randint(1, L + 2)
        seq[i, end:] = 0
    return seq.astype(np.int32)


@pytest.mark.parametrize("gen_scores", [False, True])
@pytest.mark.parametrize("seq_per_img", [1, 3])
def test_self_critical_reward_matches_jax(seq_per_img, gen_scores):
    rng = np.random.RandomState(seq_per_img)
    images, L, V = 5, 9, 12
    B = images * seq_per_img
    gts = [_ids(rng, rng.randint(2, 6), L, V) for _ in range(images)]
    gen, greedy = _ids(rng, B, L, V), _ids(rng, B, L, V)
    gen[0] = gts[0][0]  # one exact hit
    want = jsc.get_self_critical_reward(gts, gen, greedy, gen_scores)
    got = tsc.get_self_critical_reward(gts, gen, greedy, gen_scores)
    assert len(got) == len(want) == (3 if gen_scores else 2)
    for w, g in zip(want, got):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0,
                                   atol=1e-12)
    assert np.asarray(got[-2]).max() > 0  # not all zero


def test_array_to_str_stops_after_the_first_zero():
    for arr in ([3, 4, 0, 5], [7, 8], [0, 1]):
        assert tsc.array_to_str(np.array(arr)) == jsc.array_to_str(arr)
    assert tsc.array_to_str([3, 4, 0, 5]) == "3 4 0"


def test_self_critical_loss_and_masks_match_jax():
    rng = np.random.RandomState(0)
    seq = _ids(rng, 6, 7, 10)
    lp = -rng.rand(6, 7).astype(np.float32)
    reward = rng.randn(6).astype(np.float32)
    jm = jlosses.masks_from_seq(jnp.asarray(seq))
    tm = tlosses.masks_from_seq(torch.from_numpy(seq))
    assert tm.dtype == torch.float32 and tm.shape == (6, 8)
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    want = jlosses.self_critical_loss(jnp.asarray(lp), jnp.asarray(reward),
                                      jm)
    got = tlosses.self_critical_loss(torch.from_numpy(lp),
                                     torch.from_numpy(reward), tm)
    np.testing.assert_allclose(float(want), got.item(), **LOSS_TOL)


# ---------------------------------------------------------------------------
# the two stages against the JAX package
# ---------------------------------------------------------------------------

def replay_streams(key, opt, B):
    """The port's named streams replaying the noise the JAX package draws
    from `key` (dropout off: only the CIDEr sample draws)."""
    r = jjoint._rngs(key)
    out = {name: draws.Replay([]) for name in tjoint.STREAMS}
    out["cider"] = draws.Replay(jax_sample_noise(
        r["cider"], "sample", B, opt.vocab_size + 1, opt.seq_length))
    return out


CASES = [dict(caption_loss_weight=0, remat=1, decoding_constraint=0),
         dict(caption_loss_weight=1, remat=0, decoding_constraint=0),
         dict(caption_loss_weight=0, remat=0, decoding_constraint=1),
         dict(caption_loss_weight=1, remat=1, decoding_constraint=1,
              use_gen_cider_scores=1)]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_scst_stages_match_jax(case):
    """Stage A with JAX's noise gives JAX's sampled and greedy ids and
    reward; stage B on them gives JAX's loss, aux and every gradient."""
    opt = scst_opt(**CASES[case])
    data = numpy_batch(opt, seed=case)
    p = jax_params(opt, seed=case)
    key = jax.random.PRNGKey(20 + case)
    hp = jjoint.Hyper.from_opt(opt)
    jp = jax.tree.map(jnp.asarray, p)
    jb = jax_batch(data)
    jsample, jvg = jjoint.make_raw_fns(opt, "optimizer")
    jgen, jgreedy = (np.asarray(x) for x in jsample(jp, jb, key, hp))
    reward_fn = (lambda *a: jsc.get_self_critical_reward(
        *a, return_gen_scores=True)[0]) if opt.use_gen_cider_scores else (
        lambda *a: jsc.get_self_critical_reward(*a)[0])
    jreward = np.asarray(reward_fn(data["gts"], jgen, jgreedy), np.float32)
    (jloss, jaux), jgrads = jvg(jp, jb, key, hp, jnp.asarray(jreward))

    B = data["labels"].shape[0]
    tp = {"speaker": port_tree(p["speaker"])}
    tb = port_batch(data)
    thp = tjoint.Hyper.from_opt(opt)
    gen, greedy = tjoint.sampler(opt, "optimizer")(
        tp, tb, replay_streams(key, opt, B), thp)
    np.testing.assert_array_equal(jgen, gen.numpy())
    np.testing.assert_array_equal(jgreedy, greedy.numpy())
    assert len(np.unique(jgen)) > 3
    if opt.use_gen_cider_scores:
        reward = tsc.get_self_critical_reward(data["gts"], gen.numpy(),
                                              greedy.numpy(), True)[0]
    else:
        reward = tsc.get_self_critical_reward(data["gts"], gen.numpy(),
                                              greedy.numpy())[0]
    np.testing.assert_allclose(reward, jreward, rtol=0, atol=1e-6)

    sampled = {}
    (loss, aux), grads = tjoint.value_and_grad(opt, "optimizer")(
        tp, tb, replay_streams(key, opt, B), thp,
        torch.from_numpy(jreward), sampled)
    np.testing.assert_array_equal(jgen, sampled["seq"].numpy())
    assert set(aux) == set(jaux) and "loss_cider" in aux
    np.testing.assert_allclose(float(jloss), loss.item(), **LOSS_TOL)
    for k in aux:
        np.testing.assert_allclose(float(jaux[k]), aux[k].item(), **LOSS_TOL)
    assert_tree_close(jgrads, grads, **GRAD_TOL)


# ---------------------------------------------------------------------------
# stage B re-draws stage A's trajectory (the port alone)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat,constraint", [(1, 0), (0, 0), (1, 1)])
def test_stage_b_redraws_stage_a(remat, constraint):
    """Dropout 0.5 everywhere (the embedded features, every step's input
    and output): stage A and stage B, each from `joint.streams` of one
    seed, sample the same ids; another seed samples others."""
    opt = scst_opt(drop_prob_lm=0.5, remat=remat,
                   decoding_constraint=constraint)
    data = numpy_batch(opt)
    p = jax_params(opt)
    tp = {"speaker": port_tree(p["speaker"])}
    tb = port_batch(data)
    hp = tjoint.Hyper.from_opt(opt)
    gen, _ = tjoint.sampler(opt, "optimizer")(
        tp, tb, tjoint.streams(5, "cpu"), hp)
    sampled = {}
    (loss, aux), grads = tjoint.value_and_grad(opt, "optimizer")(
        tp, tb, tjoint.streams(5, "cpu"), hp, torch.ones(4), sampled)
    assert torch.equal(gen, sampled["seq"])
    other, _ = tjoint.sampler(opt, "optimizer")(
        tp, tb, tjoint.streams(6, "cpu"), hp)
    assert not torch.equal(gen, other)
    assert np.isfinite(loss.item())
    assert any(g.abs().sum() > 0 for g in grads["speaker"]["core"]
               ["i2h"].values())


def test_streams_are_independent_and_reproducible():
    a, b = tjoint.streams(3, "cpu"), tjoint.streams(3, "cpu")
    x = {k: v.uniform((4,), "cpu") for k, v in a.items()}
    for k, v in b.items():
        assert torch.equal(x[k], v.uniform((4,), "cpu"))
    assert len({tuple(v.tolist()) for v in x.values()}) == len(x)


@pytest.mark.parametrize("gen_scores", [0, 1])
def test_trainer_scst_iterations(gen_scores):
    """Three Trainer iterations of SCST (dropout 0.5, the checkpointed
    steps): the loss dict carries loss_cider, avg_reward and cider_greedy,
    stage B's ids equal stage A's every iteration, and the params move."""
    opt = scst_opt(drop_prob_lm=0.5, use_gen_cider_scores=gen_scores,
                   learning_rate=1e-2)
    tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                       verbose=False)
    before = tr.params["speaker"]["logit"]["w"].detach().clone()
    for _ in range(3):
        loss_dict, turn, _ = tr.train_iteration()
        a, b = tr.last_reward_seqs
        assert torch.equal(a, b)
        assert set(loss_dict) == {"loss", "loss_cider", "avg_reward",
                                  "cider_greedy"}
        assert all(np.isfinite(float(v)) for v in loss_dict.values())
        assert isinstance(loss_dict["avg_reward"], float)
    assert not torch.equal(before, tr.params["speaker"]["logit"]["w"])
    assert tr.optim.skipped_steps() == 0


def test_streams_of_an_iteration_follow_its_number():
    """The iteration's seed comes from opt.seed and the iteration number,
    so a resumed trainer draws what the uninterrupted one would have."""
    opt = scst_opt()
    tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                       verbose=False)
    first = tr.iteration_streams()["cider"].uniform((3,), "cpu")
    assert torch.equal(first, tr.iteration_streams()["cider"].uniform(
        (3,), "cpu"))
    tr.iteration += 1
    assert not torch.equal(first, tr.iteration_streams()["cider"].uniform(
        (3,), "cpu"))
