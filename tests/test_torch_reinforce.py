"""Port parity: REINFORCE DISC (run_joint.py -o reinforce and its
ablations) of the PyTorch port against the JAX package, on the CPU at tiny
width (rnn 16, vocab 25, L=8, vse_embed 16) in float32.

`joint.loss_fn` with retrieval_reward 'reinforce': a multinomial sample
from the 'disc' stream, the listener's per-sample retrieval loss of it, a
greedy, GT or no baseline, and the surrogate `self_critical_loss` with the
coefficient held constant; with and without the CIDEr-D term (which reuses
DISC's sample), under share_embed or not.  The port's streams replay the
noise the JAX package draws along its named keys (joint.py:123-127): the
sampled ids equal, losses within 1e-5 relative, every gradient leaf of both
agents within 1e-4 of the leaf's largest entry.  On the speaker turn the
listener's gradient is zero, as JAX gives.  Stage A draws the 'disc' stream
in mode 'sample' and stage B re-draws its ids.  The evaluator's eval loss
of a reinforce run against the JAX Evaluator's."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cooperativeimagecaptioning_tpu.training import joint as jjoint  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import joint as tjoint  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.utils.tree import leaves  # noqa: E402
from test_torch_evaluation import (  # noqa: E402
    _pure_python_metrics, assert_reinforce_eval_matches_jax)
from test_torch_listener_training import (  # noqa: E402
    _fresh_scorers, disc_opt, joint_params, jax_batch, numpy_batch,
    port_batch, port_params, reinforce_steps, replay_streams)

assert _pure_python_metrics and _fresh_scorers  # autouse fixtures
BASELINES = ("greedy", "gt", "no")



def reinforce_opt(baseline, cider=0.99, share=0, alternating=1, **kw):
    """run_joint.py -o reinforce -v 1 at tiny width."""
    return disc_opt("reinforce", cider=cider, share=share,
                    alternating=alternating,
                    reinforce_baseline_type=baseline, **kw)


@pytest.mark.parametrize("share", [0, 1], ids=["own_embed", "share_embed"])
@pytest.mark.parametrize("cider", [0.0, 0.99], ids=["disc", "disc_cider"])
@pytest.mark.parametrize("baseline", BASELINES)
def test_reinforce_loss_matches_jax(baseline, cider, share):
    """The REINFORCE branch against JAX joint.loss_fn: loss, every aux
    entry and every gradient leaf.  The speaker turn (alternating; the GT
    term zeroed) with cider, the non-alternating `reinforce_speaker` turn
    (the GT term kept) without; DISC's ids are JAX's sample of r['disc']
    in mode 'sample', and the CIDEr term takes the same ids."""
    alternating = int(cider > 0)
    turn = "speaker" if alternating else "optimizer"
    opt = reinforce_opt(baseline, cider=cider, share=share,
                        alternating=alternating)
    seed = BASELINES.index(baseline) + 2 * share
    _, tout, sampled = reinforce_steps(opt, turn, seed)
    aux = tout[0][1]
    assert {"retrieval_sc_loss", "retrieval_loss",
            "retrieval_loss_greedy"} <= set(aux)
    assert ("loss_vse" in aux) != alternating
    assert ("loss_cider" in aux) == (cider > 0)
    assert (aux["retrieval_loss_greedy"].item() == 0.0) == (baseline == "no")
    # the sampled rows differ, so the coefficient is not one constant
    assert len({tuple(r) for r in sampled["disc_seq"].tolist()}) > 1
    if cider > 0:
        assert torch.equal(sampled["seq"], sampled["disc_seq"])
    grads = tout[1]
    assert any(g.abs().sum() > 0 for _, g in leaves(grads["speaker"]))


@pytest.mark.parametrize("baseline", BASELINES)
def test_reinforce_speaker_turn_gives_the_listener_no_gradient(baseline):
    """The coefficient is a constant: on the speaker turn no gradient
    reaches the listener (zeros, as JAX's value_and_grad gives), under
    share_embed the shared table's only through the speaker's log-probs."""
    opt = reinforce_opt(baseline, cider=0.0)
    jout, tout, _ = reinforce_steps(opt, "speaker", 4)
    for k, g in leaves(tout[1]["listener"]):
        assert g.abs().sum() == 0, k
    for path, g in jax.tree_util.tree_leaves_with_path(jout[1]["listener"]):
        assert not np.asarray(g).any(), path


@pytest.mark.parametrize("share", [0, 1], ids=["own_embed", "share_embed"])
def test_sample_for_reward_draws_the_disc_stream_in_mode_sample(share):
    """Stage A of a reinforce run: the CIDEr sample is DISC's, a
    multinomial sample of the 'disc' stream (the 'cider' stream is not
    touched); JAX's ids, and stage B's."""
    opt = reinforce_opt("greedy", share=share)
    data = numpy_batch(opt, seed=3)
    p = joint_params(opt, seed=3)
    key = jax.random.PRNGKey(11)
    jsample, _ = jjoint.make_raw_fns(opt, "speaker")
    jgen, jgreedy = (np.asarray(x) for x in jsample(
        jax.tree.map(jnp.asarray, p), jax_batch(data), key,
        jjoint.Hyper.from_opt(opt)))
    B = data["labels"].shape[0]
    tp, tb = port_params(p), port_batch(data)
    hp = tjoint.Hyper.from_opt(opt)
    streams = replay_streams(key, opt, B, "speaker")
    gen, greedy = tjoint.sampler(opt, "speaker")(tp, tb, streams, hp)
    np.testing.assert_array_equal(jgen, gen.numpy())
    np.testing.assert_array_equal(jgreedy, greedy.numpy())
    assert streams["disc"].done() and streams["cider"].pos == 0
    sampled = {}
    tjoint.value_and_grad(opt, "speaker")(
        tp, tb, replay_streams(key, opt, B, "speaker"), hp, torch.zeros(B),
        sampled)
    assert torch.equal(sampled["seq"], gen)
    assert torch.equal(sampled["disc_seq"], gen)


def test_reinforce_stage_b_redraws_stage_a_with_dropout():
    """Dropout 0.5 and the checkpointed steps, on the port's own streams,
    with the greedy baseline's decode drawing its dropout masks from the
    'greedy' stream: stage B's sample is stage A's."""
    opt = reinforce_opt("greedy", drop_prob_lm=0.5, remat=1)
    tp, tb = port_params(joint_params(opt)), port_batch(numpy_batch(opt))
    hp = tjoint.Hyper.from_opt(opt)
    gen, _ = tjoint.sampler(opt, "speaker")(tp, tb, tjoint.streams(9, "cpu"),
                                            hp)
    sampled = {}
    (loss, aux), grads = tjoint.value_and_grad(opt, "speaker")(
        tp, tb, tjoint.streams(9, "cpu"), hp, torch.ones(4), sampled)
    assert torch.equal(gen, sampled["seq"]) and np.isfinite(loss.item())
    assert all(torch.isfinite(g).all() for _, g in leaves(grads))


@pytest.mark.parametrize("baseline", BASELINES)
def test_eval_reinforce_loss_matches_jax(monkeypatch, baseline):
    """The evaluator's eval loss of a reinforce run, each baseline, against
    the JAX Evaluator's."""
    assert_reinforce_eval_matches_jax(monkeypatch, baseline)
