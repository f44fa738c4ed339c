"""A run dir the JAX package wrote with checkpoint_backend 'orbax' holds its
model trees as `.orbax` directories (JAX checkpoint.py:152-158).  The port
reads them without orbax (training/orbax_tier.py): its Trainer resumes such
a run dir (params and Adam state bit-equal, the next step's loss within
LOSS_TOL of the JAX package's), `eval.eval` evaluates it and the service
serves it as they do its `.pth` twin, and the port's own orbax backend
trains, writes the JAX package's names and resumes bit for bit."""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("orbax.checkpoint")

from cooperativeimagecaptioning_tpu.training import checkpoint as jckpt  # noqa: E402
from cooperativeimagecaptioning_tpu.training import loop as jloop  # noqa: E402
from cooperativeimagecaptioning_tpu_torch import eval as teval  # noqa: E402
from cooperativeimagecaptioning_tpu_torch import serving  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import checkpoint as tck  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import loop as tloop  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.utils.tree import leaves  # noqa: E402
from test_torch_training import (  # noqa: E402
    LOSS_TOL, assert_tree_close, tiny_dataset, tiny_opt)


@pytest.fixture(scope="module")
def orbax_run_dir(tmp_path_factory):
    """Two JAX iterations and checkpoint_operations under the orbax
    backend (tests/test_orbax_checkpoint.py:15's run); then, beside it,
    the JAX package's next step on the next batch, and a `.pth` twin of
    the run dir (the same params through the JAX package's save_params)."""
    root = tmp_path_factory.mktemp("orbax_run")
    ckpt = str(root / "ckpt")
    os.makedirs(ckpt)
    opt = tiny_opt(phase=2, caption_loss_weight=1, vse_loss_weight=0,
                   checkpoint_path=ckpt, start_from=ckpt, load_best_score=0,
                   checkpoint_backend="orbax", id="ob", language_eval=0)
    tr = jloop.Trainer(opt, dataset=tiny_dataset(opt), verbose=False)
    for _ in range(2):
        tr.train_iteration()
    cwd = os.getcwd()
    os.chdir(root)
    try:
        tr.checkpoint_operations()
    finally:
        os.chdir(cwd)
    tr.ckpt.sync()
    names = os.listdir(ckpt)
    assert "model.orbax" in names and "model.pth" not in names
    twin = str(root / "twin")
    os.makedirs(twin)
    jckpt.save_params(tr.params, os.path.join(twin, "model-best.pth"))
    os.link(os.path.join(ckpt, "infos_ob.pkl"),
            os.path.join(twin, "infos_ob.pkl"))
    saved = {"params": jax.tree.map(np.asarray, tr.params),
             "adam": next(s for s in tr.optim.states["speaker"].inner_state
                          if hasattr(s, "mu")),
             "iteration": tr.iteration}
    data = tr.loader.get_batch("train")
    loss = float(tr.train_iteration(data)[0]["loss"])
    tr.close()
    return {"dir": ckpt, "twin": twin, "saved": saved, "next_data": data,
            "next_loss": loss}


def test_the_trainer_resumes_it(orbax_run_dir):
    run = orbax_run_dir
    opt = tiny_opt(phase=2, start_from=run["dir"], id="ob",
                   checkpoint_path=run["dir"] + "_port")
    tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                       verbose=False)
    assert_tree_close(run["saved"]["params"], tr.params, rtol=0, atol=0)
    adam, mine = run["saved"]["adam"], tr.optim.states["speaker"]
    assert int(mine["count"]) == int(adam.count) == 2
    for key in ("mu", "nu"):
        want = dict(leaves(jax.tree.map(np.asarray, getattr(adam, key))))
        for path, got in zip(tr.optim.paths["speaker"], mine[key]):
            np.testing.assert_array_equal(want[path], got.numpy(),
                                          err_msg=f"{key} {path}")
    assert tr.iteration == run["saved"]["iteration"]
    loss = tr.train_iteration(run["next_data"])[0]["loss"].item()
    np.testing.assert_allclose(run["next_loss"], loss, **LOSS_TOL)


def test_the_backend_trains(tmp_path):
    """The port's orbax backend: the JAX package's names (no `.pth` model
    file), and a resume bit-equal in params, Adam state and iteration whose
    next iteration draws what the uninterrupted run draws."""
    d = str(tmp_path / "run")
    kw = dict(checkpoint_path=d, checkpoint_backend="orbax", id="ob",
              drop_prob_lm=0.5)
    opt = tiny_opt(**kw)
    tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                       verbose=False)
    for _ in range(2):
        tr.train_iteration()
    tr.checkpoint_operations()
    tr.ckpt.sync()
    names = set(os.listdir(d))
    assert {"model.orbax", "model-2.orbax", "model-best.orbax",
            "optimizer.pth", "infos_ob.pkl", "infos_ob-2.pkl",
            "histories_ob.pkl"} <= names
    assert not any(n.endswith("model.pth") or n.startswith(".")
                   for n in names)
    again = tloop.Trainer(tiny_opt(start_from=d, **kw),
                          dataset=tiny_dataset(opt), device="cpu",
                          verbose=False)
    assert again.iteration == tr.iteration == 2
    for (k, a), (_, b) in zip(leaves(tr.params), leaves(again.params)):
        assert torch.equal(a, b), k
    for key in ("mu", "nu"):
        for a, b in zip(tr.optim.states["speaker"][key],
                        again.optim.states["speaker"][key]):
            assert torch.equal(a, b)
    assert int(again.optim.states["speaker"]["count"]) == 2
    data = tr.loader.get_batch("train")
    a = tr.train_iteration(data)[0]["loss"].item()
    b = again.train_iteration(data)[0]["loss"].item()
    assert a == b


def test_eval_evaluates_it(orbax_run_dir):
    """eval.eval of the orbax run dir: the `.pth` twin's captions and
    loss."""
    out = {}
    for key in ("dir", "twin"):
        d = orbax_run_dir[key]
        out[key] = teval.eval(None, os.path.join(d, "model-best.pth"),
                              os.path.join(d, "infos_ob.pkl"), split="test",
                              dataset=tiny_dataset(tiny_opt()), device="cpu")
    assert out["dir"]["split_predictions"] == \
        out["twin"]["split_predictions"]
    assert out["dir"]["loss"] == out["twin"]["loss"]


def test_the_service_serves_it(orbax_run_dir):
    svc = {key: serving.CaptioningService.from_run_dir(
        orbax_run_dir[key], run_id="ob", device="cpu", beam_size=2,
        buckets=(4,), compute_dtype="float32", max_att_len=6)
        for key in ("dir", "twin")}
    rng = np.random.RandomState(0)
    fc = rng.randn(3, 20).astype(np.float32)
    att = rng.randn(3, 6, 20).astype(np.float32)
    want = svc["twin"].caption_ids(fc, att)
    assert np.array_equal(svc["dir"].caption_ids(fc, att), want)


def test_a_missing_pth_without_an_orbax_sibling_still_reads_as_missing(
        tmp_path):
    """Only an `.orbax` sibling stands in for a missing `.pth`."""
    with pytest.raises(FileNotFoundError):
        tck.load_params(str(tmp_path / "model.pth"))
    tck.CheckpointManager(tiny_opt(checkpoint_path=str(tmp_path),
                                   checkpoint_backend="orbax")).writer.save(
        {"speaker": {"w": np.ones(3, np.float32)}},
        str(tmp_path / "model.orbax"))
    got = tck.load_params(str(tmp_path / "model.pth"))
    assert torch.equal(got["speaker"]["w"], torch.ones(3))
    with pytest.raises(FileNotFoundError):
        tck.load_params(str(tmp_path / "other.pth"))
    with pytest.raises(FileNotFoundError):
        tck.load_params_into(got, str(tmp_path / "other.pth"))
