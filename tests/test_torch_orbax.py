"""A run dir the JAX package wrote with checkpoint_backend 'orbax' holds its
model trees as `.orbax` directories (JAX checkpoint.py:152-158), which the
port cannot read without orbax, and orbax imports JAX.  The port refuses
such a run dir with NotImplementedError -- training from it, evaluating it
and serving it -- instead of training from the initial weights at the
resumed iteration, and refuses the backend in its own options."""

import os

import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("orbax.checkpoint")

from cooperativeimagecaptioning_tpu.training import loop as jloop  # noqa: E402
from cooperativeimagecaptioning_tpu_torch import eval as teval  # noqa: E402
from cooperativeimagecaptioning_tpu_torch import serving  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import checkpoint as tck  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import loop as tloop  # noqa: E402
from test_torch_training import tiny_dataset, tiny_opt  # noqa: E402

WHY = "orbax checkpoint tier is not ported: orbax imports JAX"


@pytest.fixture(scope="module")
def orbax_run_dir(tmp_path_factory):
    """Two JAX iterations and checkpoint_operations under the orbax
    backend (tests/test_orbax_checkpoint.py:15's run)."""
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
    tr.close()
    names = os.listdir(ckpt)
    assert "model.orbax" in names and "model.pth" not in names
    return ckpt


def test_the_trainer_refuses_to_resume_it(orbax_run_dir):
    opt = tiny_opt(phase=2, start_from=orbax_run_dir, id="ob",
                   checkpoint_path=orbax_run_dir + "_port")
    with pytest.raises(NotImplementedError, match=WHY):
        tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                      verbose=False)


def test_the_trainer_refuses_the_backend():
    opt = tiny_opt(checkpoint_backend="orbax")
    with pytest.raises(NotImplementedError, match="checkpoint_backend.*"
                       + WHY):
        tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                      verbose=False)


def test_eval_refuses_it(orbax_run_dir):
    with pytest.raises(NotImplementedError, match=WHY):
        teval.eval(None, os.path.join(orbax_run_dir, "model-best.pth"),
                   os.path.join(orbax_run_dir, "infos_ob.pkl"),
                   split="test", dataset=tiny_dataset(tiny_opt()),
                   device="cpu")


def test_the_service_refuses_it(orbax_run_dir):
    with pytest.raises(NotImplementedError, match=WHY):
        serving.CaptioningService.from_run_dir(orbax_run_dir, run_id="ob",
                                               device="cpu")


def test_a_missing_pth_without_an_orbax_sibling_still_reads_as_missing(
        tmp_path):
    """Only an `.orbax` sibling turns a missing file into the refusal."""
    tck.refuse_orbax(str(tmp_path / "model.pth"))
    (tmp_path / "model.orbax").mkdir()
    with pytest.raises(NotImplementedError, match=WHY):
        tck.refuse_orbax(str(tmp_path / "model.pth"))
    with pytest.raises(FileNotFoundError):
        tck.load_params(str(tmp_path / "other.pth"))
