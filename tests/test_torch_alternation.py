"""Port parity: real speaker / listener alternation (run_joint.py -o
reinforce and its ablations), the grad-isolation audit and the profiler
window, PyTorch port against the JAX package on the CPU at tiny width (rnn
16, vocab 25, L=8, vse_embed 16) in float32.

The listener turn's loss and gradients (the listener trained on captions
the frozen speaker samples from the 'listener' stream; every speaker
gradient zero); four Trainer iterations of `-o reinforce -v 1` against the
JAX make_raw_fns(opt, turn) and OptimizerManager.step turn by turn, the
port's streams replaying JAX's noise (ids bit-equal, losses, params within
2 lr steps, per-agent Adam counts; each turn's Adam leaves the other
agent's state untouched, also when the non-finite guard rejects it); the
turns and agents of the `reinforce_listener` and `reinforce_speaker`
ablations; a run resumed at an odd iteration against an uninterrupted one;
the port-written alternating run dir read by the JAX Trainer; the audit
against the JAX audit's report, error and warning; and the profiler
window."""

import json
import os
import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cooperativeimagecaptioning_tpu import data as jdata  # noqa: E402
from cooperativeimagecaptioning_tpu.training import audit as jaudit  # noqa: E402
from cooperativeimagecaptioning_tpu.training import loop as jloop  # noqa: E402
from cooperativeimagecaptioning_tpu.training import optim as joptim  # noqa: E402
from cooperativeimagecaptioning_tpu_torch import eval as teval_entry  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import audit as taudit  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import loop as tloop  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import optim as toptim  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.utils import profiling  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.utils.tree import (  # noqa: E402
    leaves, to_numpy)
from test_torch_listener_training import (  # noqa: E402
    LISTENER, _fresh_scorers, assert_step_close, assert_trainer_matches_jax,
    both_steps, disc_opt)
from test_torch_resume import (  # noqa: E402
    DS, _pure_python_metrics, jax_opt, run_opt)
from test_torch_training import assert_tree_close, tiny_dataset  # noqa: E402

assert _pure_python_metrics and _fresh_scorers  # autouse fixtures
SPEAKER_LISTENER = ["speaker", "listener"]


def reinforce_opt(**kw):
    """run_joint.py -o reinforce -v 1 (the gt baseline unless `kw` names
    another) at tiny width."""
    return disc_opt("reinforce", **dict(dict(reinforce_baseline_type="gt"),
                                        **kw))


def ablation_opt(which, **kw):
    """run_joint.py's `reinforce_listener` / `reinforce_speaker` overrides
    (run_joint.py:60-69) at tiny width."""
    over = {"reinforce_listener": dict(
                alternating_turn=["listener"], reinforce_baseline_type="gt",
                vse_loss_weight=1, cider_optimization=0,
                caption_loss_weight=0),
            "reinforce_speaker": dict(alternating=0, phase=3)}[which]
    over.update(kw)
    return disc_opt("reinforce", **over)


# ---------------------------------------------------------------------------
# the listener turn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_violation", [0, 1])
@pytest.mark.parametrize("share", [0, 1], ids=["own_embed", "share_embed"])
def test_listener_turn_matches_jax(share, max_violation):
    """JAX joint.py:205-219: the 'listener' stream's multinomial sample of
    the speaker, BOS in front, through the listener's summed contrastive
    loss times vse_loss_weight; only listener leaves get a gradient."""
    opt = reinforce_opt(share=share, vse_max_violation=max_violation)
    _, jout, tout, sampled = both_steps(opt, "listener", seed=share)
    assert_step_close(jout, tout)
    (loss, aux), grads = tout
    assert set(aux) == {"loss_vse", "vse_contrastive"}
    assert loss.item() == pytest.approx(opt.vse_loss_weight
                                        * aux["loss_vse"].item())
    assert len({tuple(r) for r in sampled["listener_seq"].tolist()}) > 1
    assert all(g.abs().sum() == 0 for _, g in leaves(grads["speaker"]))
    assert all(g.abs().sum() > 0 for _, g in leaves(grads["listener"]))


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("baseline", ["gt", "greedy", "no"])
def test_alternating_trainer_steps_match_jax(baseline):
    """Four iterations of -o reinforce -v 1: speaker, listener, speaker,
    listener, each against the JAX step of its turn; each agent's Adam
    count is the number of its turns."""
    opt = reinforce_opt(learning_rate=2e-3, reinforce_baseline_type=baseline)
    tr, jm, jp, turns = assert_trainer_matches_jax(opt, 4)
    assert turns == SPEAKER_LISTENER * 2
    assert [int(tr.optim.states[a]["count"]) for a in SPEAKER_LISTENER] == \
        [2, 2]
    assert tr.optim.skipped_steps() == 0


@pytest.mark.parametrize("which,turns,agents", [
    ("reinforce_listener", ["listener"], ("listener",)),
    ("reinforce_speaker", ["optimizer"], ("speaker",))])
def test_ablation_turns_and_agents(which, turns, agents):
    """The ablations' turns and updated agents equal the JAX package's, and
    two Trainer iterations (under the audit) move only those agents."""
    opt = ablation_opt(which, audit_grad_isolation=1, learning_rate=1e-2)
    jopt = jax_opt(opt)
    assert toptim.effective_turns(opt) == joptim.effective_turns(jopt)
    tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                       verbose=False)
    assert tr.turns == turns or (turns == ["optimizer"] and
                                 not opt.is_alternating)
    before = dict(leaves(to_numpy(tr.params)))
    for _ in range(2):
        _, turn, _ = tr.train_iteration()
        assert turn == turns[0]
        assert toptim.agents_to_update(opt, turn) == \
            joptim.agents_to_update(jopt, turn) == agents
    after = dict(leaves(to_numpy(tr.params)))
    for agent in ("speaker", "listener"):
        moved = any(not np.array_equal(v, after[k])
                    for k, v in before.items() if k.startswith(agent + "."))
        assert moved == (agent in agents), agent


@pytest.mark.parametrize("which", ["reinforce_listener", "reinforce_speaker"])
def test_ablation_trainer_steps_match_jax(which):
    """Two iterations of each ablation against the JAX steps."""
    opt = ablation_opt(which, learning_rate=2e-3)
    assert_trainer_matches_jax(opt, 2)


def test_a_turn_leaves_the_other_agents_adam_state_alone():
    """OptimizerManager.step on a one-agent turn (JAX optim.py:79-88): the
    other agent's moments and count stay as they were, bit for bit; and a
    non-finite gradient rejects the turn's step whole, its agent's params,
    moments and count kept, the skipped count raised."""
    opt = reinforce_opt(learning_rate=1e-2)
    tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                       verbose=False)
    for turn in SPEAKER_LISTENER * 2:
        other = "listener" if turn == "speaker" else "speaker"
        kept = to_numpy(tr.optim.states[other])
        assert tr.train_iteration()[1] == turn
        now = to_numpy(tr.optim.states[other])
        assert int(now["count"]) == int(kept["count"])
        for key in ("mu", "nu"):
            for a, b in zip(kept[key], now[key]):
                assert np.array_equal(a, b)
    # a NaN in one speaker gradient: the speaker turn is rejected whole
    zero = {a: _zeros_like(tr.params[a]) for a in tr.params}
    zero["speaker"]["logit"]["b"][0] = float("nan")
    state = to_numpy(tr.optim.states)
    params = to_numpy(tr.params)
    tr.optim.step(tr.params, zero, "speaker")
    assert not bool(tr.optim.last_step_ok) and tr.optim.skipped_steps() == 1
    assert_tree_close(jax.tree.map(jnp.asarray, params), tr.params, rtol=0,
                      atol=0)
    after = to_numpy(tr.optim.states)
    for agent in SPEAKER_LISTENER:
        assert int(after[agent]["count"]) == int(state[agent]["count"])
        for key in ("mu", "nu"):
            for a, b in zip(state[agent][key], after[agent][key]):
                assert np.array_equal(a, b)


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree.detach())


def test_resume_at_an_odd_iteration_equals_an_uninterrupted_run(tmp_path):
    """checkpoint_operations after 3 iterations (a speaker turn last), then
    a new Trainer from the run dir: its next turn is the listener's, and
    its fourth iteration gives the uninterrupted run's params and Adam
    state exactly."""
    kw = dict(learning_rate=1e-2, checkpoint_path=str(tmp_path),
              start_from=str(tmp_path), id="alt", language_eval=0,
              rank_eval=0)
    opt = reinforce_opt(**kw)
    tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                       verbose=False)
    for _ in range(3):
        tr.train_iteration()
    tr.checkpoint_operations()
    assert tr.turn == "listener"
    tr.train_iteration()
    again = tloop.Trainer(reinforce_opt(**kw),
                          dataset=tiny_dataset(opt), device="cpu",
                          verbose=False)
    assert again.iteration == 3 and again.turn == "listener"
    assert again.train_iteration()[1] == "listener"
    for (k, a), (_, b) in zip(leaves(tr.params), leaves(again.params)):
        assert torch.equal(a, b), k
    for agent in SPEAKER_LISTENER:
        a, b = tr.optim.states[agent], again.optim.states[agent]
        assert int(a["count"]) == int(b["count"])
        for key in ("mu", "nu"):
            assert all(torch.equal(x, y) for x, y in zip(a[key], b[key]))


def test_a_port_alternating_run_dir_resumes_in_jax(tmp_path):
    """The port's alternating reinforce run dir (alternatingModel*.pth,
    {speaker,listener}_optimizer.pth) loads its params and its iteration
    into the JAX Trainer, whose next turn is the listener's too, and both
    agents into the port's eval.eval."""
    opt = run_opt(tmp_path, id="alt", start_from=str(tmp_path), **dict(
        LISTENER, phase=3, retrieval_reward="reinforce",
        reinforce_baseline_type="greedy", retrieval_reward_weight=0.5,
        cider_optimization=0.5, vse_loss_weight=1, caption_loss_weight=0,
        is_alternating=1, alternating_turn=SPEAKER_LISTENER,
        cached_tokens="corpus"))
    tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                       verbose=False)
    for _ in range(3):
        tr.train_iteration()
    tr.checkpoint_operations()
    assert {"alternatingModel.pth", "alternatingModel-3.pth",
            "speaker_optimizer.pth", "listener_optimizer.pth"} <= \
        set(os.listdir(tmp_path))
    jtr = jloop.Trainer(jax_opt(opt), dataset=jdata.SyntheticDataset(**DS),
                        verbose=False)
    assert_tree_close(jtr.params, tr.params, rtol=0, atol=0)
    assert jtr.iteration == tr.iteration == 3
    assert jtr.turns[jtr.iteration % len(jtr.turns)] == tr.turn == "listener"
    # and the port's eval.eval loads both agents of it
    got = teval_entry.eval(None, str(tmp_path / "alternatingModel.pth"),
                           str(tmp_path / "infos_alt.pkl"), split="test",
                           dataset=tiny_dataset(opt), device="cpu")
    assert np.isfinite(got["loss"]["retrieval_sc_loss"])
    assert np.isfinite(got["loss"]["loss_vse"])


# ---------------------------------------------------------------------------
# the audit
# ---------------------------------------------------------------------------

def _audit_trees():
    """A joint numpy tree and a copy of it (both agents, two leaves each)."""
    rng = np.random.RandomState(0)
    tree = {"speaker": {"a": rng.randn(3).astype(np.float32),
                        "b": rng.randn(2, 2).astype(np.float32)},
            "listener": {"c": rng.randn(4).astype(np.float32),
                         "d": rng.randn(2).astype(np.float32)}}
    return tree, jax.tree.map(np.copy, tree)


def _both_audits(prev, new, expected):
    """The JAX audit and the port's on the same trees: (outcome, warned)
    of each, the outcome the report or the error's message."""
    out = []
    for side in ("jax", "port"):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            try:
                if side == "jax":
                    got = jaudit.audit_update(
                        jax.tree.map(jnp.asarray, prev),
                        jax.tree.map(jnp.asarray, new), expected)
                else:
                    got = taudit.audit_update(
                        taudit.snapshot(jax.tree.map(torch.from_numpy,
                                                     prev)),
                        jax.tree.map(torch.from_numpy, new), expected)
            except (jaudit.UpdateError, taudit.UpdateError) as e:
                got = ("UpdateError", str(e))
        out.append((got, [str(w.message) for w in seen]))
    return out


@pytest.mark.parametrize("case", ["honest", "frozen_moved", "not_moved",
                                  "inconsistent"])
def test_audit_matches_jax(case):
    """An honest speaker step passes; a moved listener leaf raises
    UpdateError; an agent that should have moved and did not raises; an
    agent with some leaves moved warns -- each as the JAX audit does."""
    prev, new = _audit_trees()
    expected = ("speaker",)
    if case in ("honest", "frozen_moved"):
        new["speaker"]["a"] += 1.0
        new["speaker"]["b"] -= 0.5
    if case == "frozen_moved":
        new["listener"]["d"][1] += 1e-3
    if case == "inconsistent":
        new["speaker"]["b"][0, 0] += 1.0
    jax_out, port_out = _both_audits(prev, new, expected)
    assert jax_out == port_out
    got, warned = port_out
    if case == "honest":
        assert got == {"speaker": {"updated": True, "consistent": True},
                       "listener": {"updated": False, "consistent": True}}
    elif case in ("frozen_moved", "not_moved"):
        assert got[0] == "UpdateError"
    else:
        assert got["speaker"] == {"updated": True, "consistent": False}
        assert len(warned) == 1 and "inconsistent" in warned[0]


def test_the_trainer_audit_raises_when_a_frozen_agent_moves(monkeypatch):
    """With audit_grad_isolation the Trainer audits each accepted step: a
    step that also moves the listener on a speaker turn raises UpdateError
    (it propagates: no fallback)."""
    opt = reinforce_opt(audit_grad_isolation=1, learning_rate=1e-2)
    tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                       verbose=False)
    step = tr.optim.step

    def leaky(params, grads, turn):
        out = step(params, grads, turn)
        with torch.no_grad():
            params["listener"]["img_enc"]["fc"]["b"][0] += 1.0
        return out

    monkeypatch.setattr(tr.optim, "step", leaky)
    with pytest.raises(taudit.UpdateError, match="listener update status"):
        tr.train_iteration()


def test_the_trainer_copies_nothing_without_the_audit(monkeypatch):
    opt = reinforce_opt()
    tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                       verbose=False)

    def refuse(params):
        raise AssertionError("snapshot taken with the audit off")

    monkeypatch.setattr(taudit, "snapshot", refuse)
    tr.train_iteration()


# ---------------------------------------------------------------------------
# the profiler window
# ---------------------------------------------------------------------------

def _traced_iterations(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(int(e["name"].split()[-1]) for e in events
                  if e.get("name", "").startswith("train_iteration "))


@pytest.mark.parametrize("start,steps,stop", [(1, 2, 4), (3, 5, 4)],
                         ids=["inside", "cut_by_the_end"])
def test_profiler_window_traces_its_iterations(tmp_path, start, steps, stop):
    """Trainer.train with profile_dir: a trace of the iterations
    [profile_start, profile_start + profile_steps) and no other, written at
    the window's end or, cut short, at the loop's."""
    opt = reinforce_opt(profile_dir=str(tmp_path / "prof"),
                        profile_start=start, profile_steps=steps)
    tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                       verbose=False)
    tr.train(max_iterations=stop)
    assert os.listdir(tmp_path / "prof") == [os.path.basename(tr.last_trace)]
    assert _traced_iterations(tr.last_trace) == \
        list(range(start, min(start + steps, stop)))


def test_profiling_helpers():
    """start_server starts the on-demand capture endpoint (a daemon thread)
    and its handle stops it; the step timer and sync work on CPU
    tensors."""
    server = profiling.start_server(0)
    assert server.port > 0 and server.thread.is_alive()
    server.stop()
    assert not server.thread.is_alive()
    timer = profiling.StepTimer(window=2)
    for _ in range(3):
        with timer:
            profiling.sync({"x": torch.ones(2)})
    assert len(timer.times) == 2 and timer.mean >= 0 and timer.p50 >= 0
    with profiling.annotate("region"):
        torch.ones(1)
