"""Phase 1 and phase 3 on a (data, model) mesh, on the CPU over gloo (ranks
in tests/torch_mesh_ranks.py), against the single-device port and the JAX
package's single-device run on the same numpy-seeded params and replayed
draws (each rank draws the global batch's noise and keeps its rows and its
vocabulary columns):

* one loss_fn step of each configuration -- SCST with the host reward (a
  given reward vector), with `on_device_cider` and with `soft_cider`;
  phase 1; joint `-o gumbel`, `gumbel_softmax`, `multinomial`,
  `multinomial_soft` and `reinforce` (speaker and listener turns); att_bn
  -- its loss, aux entries, every gradient leaf (slices gathered) and the
  sampled ids;
* two Trainer iterations of what an iteration adds to its loss -- the host
  reward over gathered ids (SCST, `-o gumbel`), the device reward, phase
  1, real turns (REINFORCE's speaker then listener), att_bn's running
  statistics, the feature cache -- on JAX's replayed draws: the losses by
  step and the params after them;
* the Evaluator: the listener's ranks, the CIDEr-D eval loss with the
  host reward, `sample_max` 0 and 2, against the single-device Evaluator.

Worlds (one each, every configuration in turn): (2, 1) and (1, 2) at
vocabulary 25 (the logit layer splits on the model axis), (1, 2) also at
24 (the embeddings split: `gumbel_softmax`, phase 1, `reinforce`, and the
ranks), and (2, 2) at 25.

Tolerances: losses and aux rtol 2e-5 (the JAX mesh test's); REINFORCE's
surrogate relative to `surrogate_scale` and the device reward's terms
relative to `reward_scales` (their terms cancel); gradients within 1e-4 of
the leaf's largest entry (soft CIDEr's: of the agent's largest entry), 1e-6
at least; params after n Trainer steps atol 2 * lr * n; Trainer losses
after the first step against JAX 1e-4 (the params have moved apart, as
tests/test_torch_listener_training.py holds them); ids equal; ranks equal
(tiny random embeddings: no two products tie within the packages'
rounding).
"""

import copy
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cooperativeimagecaptioning_tpu.models import att_model as jatt  # noqa: E402
from cooperativeimagecaptioning_tpu.rewards import ngram_device as jnd  # noqa: E402
from cooperativeimagecaptioning_tpu.rewards import self_critical as jsc  # noqa: E402
from cooperativeimagecaptioning_tpu.training import joint as jjoint  # noqa: E402
from cooperativeimagecaptioning_tpu.training import optim as joptim  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.data import DataLoader  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.evaluation.eval_split import (  # noqa: E402
    Evaluator)
from cooperativeimagecaptioning_tpu_torch.parallel import launch  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.rewards import ngram_device as tnd  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.rewards import self_critical as tsc  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import joint as tjoint  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import loop as tloop  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.utils.tree import (  # noqa: E402
    leaves, to_numpy, to_torch)
from test_torch_alternation import reinforce_opt  # noqa: E402
from test_torch_device_rewards import (  # noqa: E402
    assert_agent_grads_close, reward_scales, scst_opt)
from test_torch_listener_training import (  # noqa: E402
    assert_grads_close, assert_losses_close, disc_opt,
    joint_params, phase1_opt, port_params, reinforce_active, replay_streams,
    surrogate_scale)
from test_torch_training import tiny_opt  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402

LOSS_RTOL = 2e-5
LATER_RTOL = 1e-4
STEPS = 2


def configs(V):
    """name -> the options of each configuration at vocabulary V."""
    v = dict(vocab_size=V)
    return {
        "scst_host": tiny_opt(cider_optimization=1, caption_loss_weight=0,
                              phase=3, **v),
        "scst_device": scst_opt(**v),
        "soft_cider": disc_opt("gumbel", soft_cider=1, **v),
        "phase1": phase1_opt(**v),
        "gumbel": disc_opt("gumbel", **v),
        "gumbel_softmax": disc_opt("gumbel_softmax", **v),
        "multinomial": disc_opt("multinomial", **v),
        "multinomial_soft": disc_opt("multinomial_soft", **v),
        "reinforce": reinforce_opt(**v),
        "use_bn": tiny_opt(use_bn=1, caption_model="att2in2", **v),
    }


# the configurations each world runs, by vocabulary
WORLDS = {
    (2, 1): {25: sorted(configs(25))},
    (1, 2): {25: sorted(configs(25)),
             24: ["gumbel_softmax", "phase1", "reinforce"]},
    (2, 2): {25: sorted(configs(25))},
}


def fresh_scorers():
    for m in (jsc, tsc):
        m.reset_scorer()
        m.init_scorer("corpus")


def loader_batch(opt, seed=0):
    loader = DataLoader(opt, dataset=ranks.tiny_dataset(opt))
    for _ in range(seed + 1):
        data = loader.get_batch("train")
    return data


def jax_batch(data):
    """The batch as JAX arrays; an FC speaker's has no att features."""
    return {k: None if data.get(k) is None else jnp.asarray(data[k])
            for k in ("fc_feats", "att_feats", "att_masks", "labels",
                      "masks")}


def turn_of(opt):
    return "speaker" if opt.is_alternating else "optimizer"


# ---------------------------------------------------------------------------
# one loss_fn step: JAX, the single-device port, the mesh
# ---------------------------------------------------------------------------

def loss_case(opt, turn, seed=0):
    """JAX's and the single-device port's step of `opt` on one batch (with
    its refs where a device tier reads them, a random reward where the
    host tier would give one), and the payload of the mesh's."""
    fresh_scorers()
    data = loader_batch(opt, seed)
    p = joint_params(opt, seed) if opt.vse_model != "None" else \
        jax.tree.map(np.asarray, jjoint.init_params(jax.random.PRNGKey(seed),
                                                    opt))
    key = jax.random.PRNGKey(50 + seed)
    B = data["labels"].shape[0]
    jb = jax_batch(data)
    tb = {k: None if v is None else torch.from_numpy(v).long()
          if k == "labels" else torch.from_numpy(v)
          for k, v in ((k, data.get(k)) for k in jb)}
    refs = tjoint.needs_device_refs(opt)
    if refs:
        jb["refs"], jb["ref_mask"] = jnd.pad_gts(data["gts"])
        tb["refs"], tb["ref_mask"] = tnd.pad_gts(data["gts"])
    reward = None
    if tjoint.needs_reward(opt, turn):
        reward = np.random.RandomState(seed).randn(B).astype(np.float32)
    _, jvg = jjoint.make_raw_fns(opt, turn)
    jout = jvg(jax.tree.map(jnp.asarray, p), jb, key,
               jjoint.Hyper.from_opt(opt),
               jnp.asarray(reward if reward is not None else
                           np.zeros((B,), np.float32)))
    sampled = {}
    tout = tjoint.value_and_grad(opt, turn)(
        port_params(p), tb, replay_streams(key, opt, B, turn),
        tjoint.Hyper.from_opt(opt),
        None if reward is None else torch.from_numpy(reward), sampled)
    scale = None
    if reinforce_active(opt, turn):
        scale = ("reinforce", surrogate_scale(opt, p, data, key, turn))
    elif opt.on_device_cider and tjoint._cider_active(opt, turn):
        scale = ("device", reward_scales(opt, turn, p, tb, replay_streams(
            key, opt, B, turn)))
    batch = {k: (None if v is None else v.numpy()) for k, v in tb.items()}
    noise = {k: r.arrays for k, r in replay_streams(key, opt, B,
                                                    turn).items()}
    payload = {"opt": opt, "turn": turn, "params": p, "batch": batch,
               "noise": noise, "reward": reward}
    return {"jax": jout, "port": tout, "sampled": sampled, "scale": scale,
            "payload": payload}


_LOSS_CASES = {}


def loss_cases(shape):
    """{(V, name, turn): loss_case} of a world, each made once per
    module."""
    out = {}
    for key in loss_keys(shape):
        if key not in _LOSS_CASES:
            V, name, turn = key
            _LOSS_CASES[key] = loss_case(configs(V)[name], turn,
                                         int(turn == "listener"))
        out[key] = _LOSS_CASES[key]
    return out


def assert_mesh_step_close(opt, want_loss, want_aux, want_grads, got, scale,
                           soft):
    """The mesh's summed loss and aux against (want_loss, want_aux) --
    REINFORCE's surrogate and the device reward's terms relative to their
    scales --, and its gathered gradients against want_grads."""
    if scale is not None and scale[0] == "reinforce":
        assert_losses_close(opt, want_loss, want_aux, got["loss"],
                            got["aux"], LOSS_RTOL, scale[1])
    else:
        sizes = {}
        if scale is not None:
            sizes = {"loss_cider": scale[1][0], "avg_reward": scale[1][1]}
        assert set(got["aux"]) == set(want_aux)
        total = 0.0
        for k, w in want_aux.items():
            size = sizes.get(k, abs(float(w)))
            total += size
            assert abs(got["aux"][k] - float(w)) <= LOSS_RTOL * size, \
                (k, got["aux"][k], float(w))
        size = total if sizes else abs(float(want_loss))
        assert abs(got["loss"] - float(want_loss)) <= LOSS_RTOL * max(
            size, abs(float(want_loss)))
    ttree = to_torch(got["grads"], "cpu")
    if soft:
        assert_agent_grads_close(want_grads, ttree)
    else:
        assert_grads_close(want_grads, ttree)


# ---------------------------------------------------------------------------
# Trainer iterations: JAX, the single-device port, the mesh
# ---------------------------------------------------------------------------

def reference(opt, steps=STEPS, key0=100):
    """`steps` iterations of the single-device port Trainer (over
    tiny_dataset(opt), its streams replaying what JAX draws from
    key(key0 + iteration)) and of the JAX steps on the same batches from
    the same params, turn by turn (as
    test_torch_listener_training.assert_trainer_matches_jax, with att_bn's
    running statistics updated on both sides) -> the losses of both, the
    params after, the noise of each iteration, and REINFORCE's scales."""
    fresh_scorers()
    tr = tloop.Trainer(copy.deepcopy(opt), dataset=ranks.tiny_dataset(opt),
                       device="cpu", verbose=False)
    opt = tr.opt
    jp = jax.tree.map(jnp.asarray, to_numpy(tr.params))
    jm = joptim.OptimizerManager(opt, jp)
    B = opt.batch_size * opt.seq_per_img
    tr.iteration_streams = lambda: replay_streams(
        jax.random.PRNGKey(key0 + tr.iteration), opt, B, tr.turn)
    out = {"jax": [], "port": [], "noise": {}, "scale": [], "turns": []}
    for _ in range(steps):
        it = tr.iteration
        key = jax.random.PRNGKey(key0 + it)
        turn = tr.turn
        out["noise"][it] = {k: r.arrays for k, r in replay_streams(
            key, opt, B, turn).items()}
        hp = jjoint.Hyper(*(jnp.float32(float(v)) for v in tr._hyper()))
        jm.set_lr(tr.optim.lr)
        before = to_numpy(tr.params)
        loss_dict, turn, data = tr.train_iteration()
        out["turns"].append(turn)
        jsample, jvg = jjoint.make_raw_fns(opt, turn)
        jb = jax_batch(data)
        if jjoint.needs_device_refs(opt) and jjoint._cider_active(opt, turn):
            jb["refs"], jb["ref_mask"] = jnd.pad_gts(data["gts"])
        reward = jnp.zeros((B,), jnp.float32)
        if jjoint.needs_reward(opt, turn):
            gen, greedy = (np.asarray(x) for x in jsample(jp, jb, key, hp))
            scores, _ = jsc.get_self_critical_reward(data["gts"], gen, greedy)
            reward = jnp.asarray(scores, jnp.float32)
        (jloss, jaux), jg = jvg(jp, jb, key, hp, reward)
        jp = jm.step(jp, jg, turn)
        if opt.use_bn:
            jp = dict(jp, speaker=jatt.bn_running_update(
                jp["speaker"], jb["att_feats"], jb["att_masks"]))
        out["jax"].append((float(jloss), {k: float(v)
                                          for k, v in jaux.items()}))
        out["port"].append({k: float(v) for k, v in loss_dict.items()})
        out["scale"].append(surrogate_scale(opt, before, data, key, turn)
                            if reinforce_active(opt, turn) else None)
    out.update(jax_params=to_numpy(jp), port_params=to_numpy(tr.params),
               lr=opt.learning_rate, opt=opt)
    tr.close()
    return out


# the Trainer configurations: what an iteration adds to its loss -- the host
# reward over gathered ids, the device reward, the listener, turns, att_bn's
# running statistics, the feature cache (the loss steps cover the others)
TRAINER_NAMES = ("cache", "gumbel", "phase1", "reinforce", "scst_device",
                 "scst_host", "use_bn")


def trainer_names(shape):
    """The Trainer configurations of a world, by vocabulary."""
    return {25: list(TRAINER_NAMES)}


def trainer_opt(V, name):
    if name == "cache":
        # phase 3 SCST from the device feature cache
        return tiny_opt(cider_optimization=1, caption_loss_weight=0,
                        phase=3, vocab_size=V, device_feature_cache=1)
    return configs(V)[name]


_REFERENCES = {}


def reference_of(V, name):
    """The reference run of a configuration, once per module (the cache's:
    the same options streamed, as the cache trains as streamed)."""
    if (V, name) not in _REFERENCES:
        opt = trainer_opt(V, name)
        if name == "cache":
            opt = copy.deepcopy(opt)
            opt.device_feature_cache = 0
        _REFERENCES[(V, name)] = reference(opt)
    return _REFERENCES[(V, name)]


def assert_trainer_close(ref, got):
    """The mesh Trainer's losses by step against the single-device port's
    (LOSS_RTOL) and JAX's (LOSS_RTOL at the first step, LATER_RTOL after;
    REINFORCE's surrogate by its scale), its turns, and its params after
    the steps within 2 lr steps of both."""
    opt = ref["opt"]
    assert got["turns"] == ref["turns"]
    for n, (mine, port, (jloss, jaux), scale) in enumerate(zip(
            got["losses"], ref["port"], ref["jax"], ref["scale"])):
        assert set(port) <= set(mine)
        for k, v in port.items():
            s = scale if k in ("retrieval_sc_loss", "loss") and scale \
                else abs(v)
            if k == "loss" and scale:
                s = max(abs(v), scale * opt.retrieval_reward_weight)
            assert abs(mine[k] - v) <= LOSS_RTOL * max(s, 1e-30), (n, k)
        assert_losses_close(opt, jloss, jaux, mine["loss"], mine,
                            LOSS_RTOL if n == 0 else LATER_RTOL, scale)
    bound = 2 * ref["lr"] * len(got["losses"])
    for want in (ref["port_params"], ref["jax_params"]):
        w, g = dict(leaves(want)), dict(leaves(got["params"]))
        assert set(w) == set(g)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=bound,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# the Evaluator
# ---------------------------------------------------------------------------

def eval_cases(shape):
    """{key: (opt, whole params, eval kwargs)}: the listener's ranks of a
    phase-1 run (GT captions, and the generated captions' ranks with the GT
    ranks beside them), the CIDEr-D eval loss of an SCST run with the host
    reward, sample_max 0 and 2 of a joint run; at vocabulary 25, and the
    ranks at 24 on a model axis."""
    out = {}
    vocabs = (25, 24) if shape[1] > 1 else (25,)
    for V in vocabs:
        opt = phase1_opt(vocab_size=V, rank_eval=1)
        p = jax.tree.map(np.asarray, jjoint.init_params(
            jax.random.PRNGKey(7), opt))
        out[(V, "ranks")] = (opt, p, {"split": "val", "num_images": -1,
                                      "beam_size": 1})
    opt = configs(25)["scst_host"]
    p = jax.tree.map(np.asarray, jjoint.init_params(jax.random.PRNGKey(8),
                                                    opt))
    out[(25, "cider")] = (opt, p, {"split": "val", "num_images": -1,
                                   "beam_size": 1})
    opt = configs(25)["gumbel"]
    p = joint_params(opt, 9)
    for sm in (0, 2):
        out[(25, f"sample_max{sm}")] = (opt, p, {
            "split": "val", "num_images": -1, "beam_size": 1,
            "sample_max": sm, "temperature": 0.8})
    return out


def evaluate_single(opt, params, ek):
    fresh_scorers()
    loader = DataLoader(opt, dataset=ranks.tiny_dataset(opt))
    ev = Evaluator(opt, device="cpu")
    losses, preds, _ = ev.eval_split(to_torch(params, "cpu"), loader,
                                     dict(ek))
    return losses, {p["image_id"]: p["caption"] for p in preds}


def assert_values_close(want, got, where=""):
    """Nested dicts of numbers (losses, rank metrics) within LOSS_RTOL."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k, v in want.items():
            assert_values_close(v, got[k], f"{where}.{k}")
    elif np.asarray(want).dtype.kind not in "biuf":
        assert got == want, where
    else:
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=where)


def assert_eval_equal(want, got):
    """Captions equal, every loss and rank metric within LOSS_RTOL."""
    assert got[1] == want[1]
    assert_values_close(want[0], got[0])


# ---------------------------------------------------------------------------
# the worlds
# ---------------------------------------------------------------------------

SHAPES = [(2, 1), (1, 2), (2, 2)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each shape's references and its world's results; the (2, 1) world
    also trains REINFORCE's two turns through `Trainer.train` under the
    audit and the profiler window."""
    out = {}
    traces = str(tmp_path_factory.mktemp("mesh_traces"))
    for shape in SHAPES:
        lc = loss_cases(shape)
        tc = {}
        for V, names in trainer_names(shape).items():
            for name in names:
                ref = reference_of(V, name)
                tc[(V, name)] = (trainer_opt(V, name), ref["noise"], STEPS)
        ec = eval_cases(shape)
        window = (configs(25)["reinforce"], traces) if shape == (2, 1) \
            else None
        got = launch.spawn(ranks.phase3_world_rank, (
            shape, {k: c["payload"] for k, c in lc.items()}, tc, ec,
            window), shape[0] * shape[1], "cpu", timeout=900)
        out[shape] = {"loss": lc, "eval": ec, "ranks": got}
    return out


def loss_keys(shape):
    keys = []
    for V, names in WORLDS[shape].items():
        for name in names:
            keys.append((V, name, turn_of(configs(V)[name])))
            if name == "reinforce":
                keys.append((V, name, "listener"))
    return keys


@pytest.mark.parametrize("shape,key", [(s, k) for s in SHAPES
                                       for k in loss_keys(s)])
def test_loss_step_on_a_mesh_matches_single_device_and_jax(worlds, shape,
                                                           key):
    case = worlds[shape]["loss"][key]
    opt = case["payload"]["opt"]
    soft = bool(opt.soft_cider)
    (jloss, jaux), jgrads = case["jax"]
    (tloss, taux), tgrads = case["port"]
    port_aux = {k: float(v) for k, v in taux.items()}
    for r in worlds[shape]["ranks"]:
        got = r["loss"][key]
        assert_mesh_step_close(opt, jloss, jaux, jgrads, got, case["scale"],
                               soft)
        assert_mesh_step_close(opt, float(tloss), port_aux,
                               to_numpy(tgrads), got, case["scale"], soft)
        assert set(got["sampled"]) == set(case["sampled"])
        for k, v in case["sampled"].items():
            np.testing.assert_array_equal(got["sampled"][k], v.numpy())


def trainer_keys(shape):
    return [(V, name) for V, names in trainer_names(shape).items()
            for name in names]


@pytest.mark.parametrize("shape,key", [(s, k) for s in SHAPES
                                       for k in trainer_keys(s)])
def test_trainer_on_a_mesh_matches_single_device_and_jax(worlds, shape,
                                                         key):
    ref = reference_of(*key)
    for r in worlds[shape]["ranks"]:
        assert_trainer_close(ref, r["trainer"][key])


def eval_keys(shape):
    return [(V, "ranks") for V in ((25, 24) if shape[1] > 1 else (25,))] + \
        [(25, "cider"), (25, "sample_max0"), (25, "sample_max2")]


@pytest.mark.parametrize("shape,key", [(s, k) for s in SHAPES
                                       for k in eval_keys(s)])
def test_evaluator_on_a_mesh_equals_single_device(worlds, shape, key):
    """The single-device Evaluator of these options is held to JAX's by
    tests/test_torch_retrieval.py (ranks), test_torch_scst.py (the CIDEr-D
    eval loss) and test_torch_evaluation.py (sample_max 0 and 2)."""
    opt, params, ek = worlds[shape]["eval"][key]
    want = evaluate_single(opt, params, ek)
    if key[1] == "ranks":
        assert "rsum" in want[0]["val"] and "rsum" in want[0]["test"]
    if key[1] == "cider":
        assert abs(want[0]["loss_cider"]) > 0
    for r in worlds[shape]["ranks"]:
        assert_eval_equal(want, r["eval"][key])


def test_audit_and_profiler_window_on_a_mesh(worlds):
    """Two REINFORCE turns (speaker, listener) through `Trainer.train` on
    (2, 1) under the grad-isolation audit (each rank checks its own params,
    the flags maxed over the world: no UpdateError) and a profiler window
    over both iterations: each rank writes its own trace, and each agent
    stepped once."""
    paths = set()
    for r in worlds[(2, 1)]["ranks"]:
        counts, trace = r["window"]
        assert counts == {"speaker": 1, "listener": 1}
        assert trace is not None and os.path.isfile(trace)
        paths.add(trace)
    assert len(paths) == 2
