"""The port's Trainer and Evaluator on a (data, model) mesh, on the CPU, over
gloo (ranks in tests/torch_mesh_ranks.py), against single-device runs
(cf. tests/test_trainer_mesh.py of the JAX package):

* a (2, 1) Trainer's three iterations at drop_prob_lm 0.5 against the
  single-device Trainer: the same losses (each rank draws the global
  batch's noise and keeps its rows) and params;
* a (1, 2) Evaluator's greedy and beam-2 ids equal to single-device, with
  the logit layer (vocabulary 25) or the embedding (vocabulary 24) split;
* a mesh run dir (rank 0 writes the gathered state) resumed single-device,
  and single-device run dirs of both packages resumed on a mesh;
* `eval.eval` on a mesh run dir starts the ranks itself;
* the configurations a mesh refused until they were ported (SCST, joint
  training with the listener, phase 1, att_bn; the sampled decodes) now
  equal the single-device port and JAX (tests/test_torch_mesh_phase3.py
  has the rest of the matrix);
* what a mesh refused until it was ported (fused chunks, more than one
  host): a (2, 1) mesh over two hosts in fused chunks equals the
  single-device run (tests/test_torch_mesh_fused.py and
  test_torch_mesh_hosts.py have the rest).

Tolerances: losses rtol 2e-5 (the JAX mesh test's); params after n steps
atol 2 * lr * n (Adam's first update is lr * sign(g): a gradient near 0
may take opposite signs under another summation order), as
tests/test_torch_training.py; resumed state exactly equal.
"""

import os
import pickle

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cooperativeimagecaptioning_tpu.config import Options as JOptions  # noqa: E402
from cooperativeimagecaptioning_tpu.training import checkpoint as jckpt  # noqa: E402
from cooperativeimagecaptioning_tpu.training import joint as jjoint  # noqa: E402
from cooperativeimagecaptioning_tpu.training import optim as joptim  # noqa: E402
from cooperativeimagecaptioning_tpu_torch import config as tconfig  # noqa: E402
from cooperativeimagecaptioning_tpu_torch import data as tdata  # noqa: E402
from cooperativeimagecaptioning_tpu_torch import eval as teval_entry  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.evaluation.eval_split import (  # noqa: E402
    Evaluator)
from cooperativeimagecaptioning_tpu_torch.parallel import launch  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import (  # noqa: E402
    checkpoint as tckpt)
from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.utils.tree import leaves  # noqa: E402

import test_torch_mesh_phase3 as phase3  # noqa: E402
import test_torch_training as ttraining  # noqa: E402
import torch_mesh_ranks as ranks  # noqa: E402

LOSS_RTOL = 2e-5
STEPS = 3


def single_run_dir(d, V):
    """A single-device port run dir of two iterations."""
    opt = ranks.tiny_opt(vocab_size=V, checkpoint_path=str(d), id="t")
    tr = Trainer(opt, dataset=ranks.tiny_dataset(opt), device="cpu",
                 verbose=False)
    tr.train_iteration()
    tr.train_iteration()
    tr.checkpoint_operations()
    return str(d)


def jax_run_dir(d, V=25):
    """A run dir the JAX package wrote: params, an optax optimizer.pth
    after one update, infos pickled with its Options."""
    os.makedirs(d, exist_ok=True)
    opt = JOptions(**vars(ranks.tiny_opt(vocab_size=V, checkpoint_path=str(d),
                                         id="t")))
    params = jax.tree.map(np.asarray, jjoint.init_params(
        jax.random.PRNGKey(4), opt))
    jckpt.save_params(params, os.path.join(d, "model.pth"))
    jm = joptim.OptimizerManager(opt, jax.tree.map(jnp.asarray, params))
    jm.step(jax.tree.map(jnp.asarray, params), jax.tree.map(
        lambda x: jnp.full(x.shape, 1e-3, jnp.float32), params), "optimizer")
    jckpt.CheckpointManager(opt).save_optimizers(jm)
    with open(os.path.join(d, "infos_t.pkl"), "wb") as f:
        pickle.dump({"opt": opt, "iter": 1, "epoch": 0,
                     "vocab": {str(i): f"w{i}" for i in range(1, V + 1)}},
                    f)
    return str(d), params


def evaluate_single(run_dir):
    opt = tconfig.load_infos(os.path.join(run_dir, "infos_t.pkl"))["opt"]
    loader = tdata.DataLoader(opt, dataset=ranks.tiny_dataset(opt))
    params = tckpt.load_params(os.path.join(run_dir, "model.pth"))
    ev = Evaluator(opt, device="cpu")
    out = {}
    for beam in (1, 2):
        losses, preds, _ = ev.eval_split(
            params, loader, {"split": "val", "beam_size": beam,
                             "language_eval": 0, "num_images": -1})
        out[beam] = ({p["image_id"]: p["caption"] for p in preds},
                     losses["loss_cap"])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The single-device runs, then the two-rank world's mesh runs."""
    root = tmp_path_factory.mktemp("mesh_runs")
    single_dirs = {V: single_run_dir(root / f"single{V}", V)
                   for V in (25, 24)}
    jdir, jparams = jax_run_dir(root / "jax")
    opt = ranks.tiny_opt(checkpoint_path=str(root / "single"))
    tr = Trainer(opt, dataset=ranks.tiny_dataset(opt), device="cpu",
                 verbose=False)
    losses = [float(tr.train_iteration()[0]["loss"]) for _ in range(STEPS)]
    tr.checkpoint_operations()
    single = dict(ranks.trainer_state(tr), losses=losses, lr=opt.current_lr)
    dirs = dict(single_dirs, jax=jdir)
    mesh_dir = str(root / "mesh")
    got = launch.spawn(ranks.mesh_runs_rank, (mesh_dir, dirs), 2, "cpu")
    return dict(single=single, single_dirs=single_dirs, jax=(jdir, jparams),
                mesh_dir=mesh_dir, single_dir=str(root / "single"),
                ranks=got, evaluated={V: evaluate_single(d)
                                      for V, d in single_dirs.items()})


def test_trainer_2x1_matches_single_device(runs):
    want = runs["single"]
    bound = 2 * want["lr"] * STEPS
    for r in runs["ranks"]:
        got = r["train"]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
        assert got["iteration"] == STEPS
        for (k, a), (_, b) in zip(leaves(got["params"]),
                                  leaves(want["params"])):
            np.testing.assert_allclose(a, b, rtol=0, atol=bound, err_msg=k)


def test_trainer_registers_and_clears_the_vocab_mesh(runs):
    for r in runs["ranks"]:
        assert not r["train"]["vocab_registered"]  # a model axis of 1
        for V in (25, 24):
            assert r["resumed"][V]["vocab_registered"]
            assert r["resumed"][V]["vocab_cleared"]


@pytest.mark.parametrize("V", [25, 24])
def test_evaluator_1x2_ids_equal_single_device(runs, V):
    want = runs["evaluated"][V]
    for r in runs["ranks"]:
        for beam in (1, 2):
            caps, loss = r["eval"][V][beam]
            assert caps == want[beam][0]
            np.testing.assert_allclose(loss, want[beam][1], rtol=LOSS_RTOL)
    distinct = {c for c in want[2][0].values()}
    assert len(distinct) > 1


def test_a_mesh_run_dir_is_a_single_device_file_set(runs):
    assert sorted(os.listdir(runs["mesh_dir"])) == \
        sorted(os.listdir(runs["single_dir"]))


def test_a_mesh_run_dir_resumes_single_device(runs, tmp_path):
    """Rank 0 wrote the gathered params and Adam state: a single-device
    Trainer resumes them exactly, with the iteration count."""
    mesh = runs["ranks"][0]["train"]
    opt = ranks.tiny_opt(start_from=runs["mesh_dir"],
                         checkpoint_path=str(tmp_path))
    tr = Trainer(opt, dataset=ranks.tiny_dataset(opt), device="cpu",
                 verbose=False)
    got = ranks.trainer_state(tr)
    assert got["iteration"] == STEPS
    for (k, a), (_, b) in zip(leaves(got["params"]), leaves(mesh["params"])):
        np.testing.assert_array_equal(a, b, err_msg=k)
    for agent, st in mesh["states"].items():
        mine = got["states"][agent]
        assert int(mine["count"]) == int(st["count"]) == STEPS
        for key in ("mu", "nu"):
            for a, b in zip(mine[key], st[key]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("V", [25, 24])
def test_a_single_device_run_dir_resumes_on_a_mesh(runs, V):
    """A (1, 2) Trainer resumes a single-device port run dir: each rank's
    slices gathered are the file's params and Adam state."""
    d = runs["single_dirs"][V]
    params = tckpt.load_params(os.path.join(d, "model.pth"))
    with open(os.path.join(d, "optimizer.pth"), "rb") as f:
        states = pickle.load(f)
    for r in runs["ranks"]:
        got = r["resumed"][V]
        assert got["iteration"] == 2
        for (k, a), (_, b) in zip(leaves(got["params"]), leaves(params)):
            np.testing.assert_array_equal(a, b.numpy(), err_msg=k)
        sp = got["states"]["speaker"]
        assert int(sp["count"]) == int(states["count"])
        for key in ("mu", "nu"):
            for a, b in zip(sp[key], states[key]):
                np.testing.assert_array_equal(a, b)


def test_a_jax_run_dir_resumes_on_a_mesh(runs):
    """The JAX package's run dir (optax optimizer.pth) on a (1, 2) mesh."""
    _, want = runs["jax"]
    for r in runs["ranks"]:
        got = r["resumed"]["jax"]
        assert got["iteration"] == 1
        for (k, a), (_, b) in zip(leaves(got["params"]), leaves(want)):
            np.testing.assert_array_equal(a, b, err_msg=k)
        assert int(got["states"]["speaker"]["count"]) == 1
        assert any(np.abs(m).max() > 0
                   for m in got["states"]["speaker"]["mu"])


def test_eval_entry_on_a_mesh_run_dir_starts_its_ranks(runs):
    """eval.eval of a mesh run dir (its options name a (2, 1) mesh) spawns
    the ranks and returns rank 0's result: the single-device captions."""
    d = runs["mesh_dir"]
    infos = os.path.join(d, "infos_.pkl")
    ds = ranks.tiny_dataset(ranks.tiny_opt())
    assert tconfig.load_infos(infos)["opt"].mesh_data_axis == 2
    got = teval_entry.eval(None, os.path.join(d, "model-best.pth"), infos,
                           split="test", dataset=ds, device="cpu")
    opt = tconfig.load_infos(infos)["opt"]
    opt.mesh_data_axis = 0
    want = teval_entry.eval(opt, os.path.join(d, "model-best.pth"), infos,
                            split="test", dataset=ds, device="cpu")
    assert got["split_predictions"] == want["split_predictions"]
    np.testing.assert_allclose(got["loss"]["loss_cap"],
                               want["loss"]["loss_cap"], rtol=LOSS_RTOL)


# the configurations a mesh refused until they were ported (the cases below
# pinned the refusal; their names and ids are kept)
CONFIG_KW = [
    dict(cider_optimization=1, caption_loss_weight=0, phase=3),  # SCST
    dict(vse_model="fc", vse_embed_size=16, is_alternating=1,   # joint
         alternating_turn=["speaker", "listener"], phase=3,
         retrieval_reward="gumbel", retrieval_reward_weight=0.5),
    dict(caption_model="fc", vse_model="fc", vse_embed_size=16, phase=1,
         vse_loss_weight=1, caption_loss_weight=0),               # phase 1
    dict(use_bn=1),
]
AXES = [(2, 1), (1, 2)]
SAMPLE_MAX = [0, 2]


def sampled_eval_case(sample_max):
    """A speaker's eval_split with a sampled decode, its params whole."""
    opt = ttraining.tiny_opt()
    params = jax.tree.map(np.asarray, jjoint.init_params(
        jax.random.PRNGKey(3), opt))
    return (opt, params, {"split": "val", "beam_size": 1, "num_images": -1,
                          "sample_max": sample_max, "temperature": 0.8})


@pytest.fixture(scope="module")
def configured():
    """The references of each configuration (the single-device port and
    JAX, tests/test_torch_mesh_phase3.py's `reference`), and one world per
    axes running their Trainers and the sampled decodes."""
    refs = [phase3.reference(ttraining.tiny_opt(**kw)) for kw in CONFIG_KW]
    evals = {sm: sampled_eval_case(sm) for sm in SAMPLE_MAX}
    worlds = {}
    for axes in AXES:
        cases = {i: (ttraining.tiny_opt(**kw), refs[i]["noise"],
                     phase3.STEPS) for i, kw in enumerate(CONFIG_KW)}
        worlds[axes] = launch.spawn(ranks.phase3_world_rank,
                                    (axes, {}, cases, evals), 2, "cpu")
    return refs, evals, worlds


@pytest.mark.parametrize("kw", CONFIG_KW)
@pytest.mark.parametrize("axes", AXES)
def test_what_a_mesh_does_not_run_names_its_roadmap_item(configured, kw,
                                                         axes):
    """SCST with the host reward, joint training with the listener, phase
    1 and att_bn, refused on a mesh until they were ported: two mesh
    Trainer iterations on JAX's replayed draws equal the single-device
    port's and JAX's (losses rtol 2e-5 at the first step, 1e-4 after
    against JAX; params within 2 lr steps)."""
    refs, _, worlds = configured
    i = CONFIG_KW.index(kw)
    for r in worlds[axes]:
        phase3.assert_trainer_close(refs[i], r["trainer"][i])


def test_what_a_mesh_still_refuses_names_its_roadmap_item(tmp_path):
    """Fused chunks on a mesh and a mesh over more than one host raised,
    naming "multi-device, the rest", until they were ported (the id kept):
    a (2, 1) mesh over two hosts (torchrun's environment, a directory each)
    trains phase 2 in fused chunks of 4 with the feature cache, and SCST
    with the host reward under fused_steps 4 per step, with the JAX
    package's gate reason; both equal the single-device per-step run of
    the same options (losses rtol 2e-5, params within 2 lr steps)."""
    from cooperativeimagecaptioning_tpu.training import loop as jloop
    opts = {"mle": (ranks.tiny_opt(fused_steps=4, device_feature_cache=1,
                                   max_att_len=6), 4),
            "scst": (ranks.tiny_opt(fused_steps=4, cider_optimization=1,
                                    caption_loss_weight=0, phase=3), 2)}
    cases = {k: (opt.replace(checkpoint_path=str(tmp_path / k)), n, None,
                 False, False) for k, (opt, n) in opts.items()}
    got, _ = ranks.run_hosts(tmp_path, "fused_world_rank", ((2, 1), cases))
    for key, (opt, n) in opts.items():
        ranks.self_critical_reset()
        single = Trainer(opt.replace(fused_steps=1,
                                     checkpoint_path=str(tmp_path / "one")),
                         dataset=ranks.tiny_dataset(opt), device="cpu",
                         verbose=False)
        single.train(max_iterations=n)
        want = {k: float(v) for k, v in single.loss_history.items()}
        params = dict(leaves(ranks.trainer_state(single)["params"]))
        jtr = jloop.Trainer(JOptions(**vars(opt)),
                            dataset=ranks.tiny_dataset(opt), verbose=False)
        gate = jtr._fused_gate()
        jtr.close()
        for r in got:
            run = r[key]
            assert run["gate"] == gate and run["fused"] == (gate is None)
            assert run["losses"].keys() == want.keys()
            for it, v in want.items():
                np.testing.assert_allclose(run["losses"][it], v,
                                           rtol=LOSS_RTOL)
            for k, v in leaves(run["params"]):
                np.testing.assert_allclose(v, params[k], rtol=0,
                                           atol=2 * opt.learning_rate * n,
                                           err_msg=k)
    assert got[0]["mle"]["gate"] is None
    assert got[0]["scst"]["gate"].startswith("host-side reward")


def test_a_mesh_run_outside_its_ranks_says_how_to_start_them():
    opt = ranks.tiny_opt(mesh_data_axis=2)
    with pytest.raises(RuntimeError, match="start the ranks"):
        Trainer(opt, dataset=ranks.tiny_dataset(opt), device="cpu",
                verbose=False)


@pytest.mark.parametrize("sample_max", SAMPLE_MAX)
def test_sampled_decodes_on_a_mesh_name_their_roadmap_item(configured,
                                                           sample_max):
    """The evaluator's sampled decodes (sample_max 0 and 2), refused on a
    mesh until they were ported: on (2, 1) (each rank the rows of the
    global draws) and (1, 2) (the draw over the vocabulary slices) the
    captions and losses equal the single-device Evaluator's, which
    tests/test_torch_evaluation.py holds to JAX's."""
    _, evals, worlds = configured
    want = phase3.evaluate_single(*evals[sample_max])
    assert len(set(want[1].values())) > 1
    for axes in AXES:
        for r in worlds[axes]:
            phase3.assert_eval_equal(want, r["eval"][sample_max])
