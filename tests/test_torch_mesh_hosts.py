"""A mesh over more than one host, on the CPU: two ranks started with
torchrun's environment as two hosts (`LOCAL_WORLD_SIZE=1` each, a working
directory each, a relative `checkpoint_path`), against the one-host (2, 1)
run (ranks in tests/torch_mesh_ranks.py).

* three phase-2 iterations equal the one-host run's (losses rtol 2e-5, the
  mesh tests' tolerance) and global rank 0 alone writes the run dir: it
  exists only under host 0's directory;
* a Trainer resuming it on both hosts starts from what rank 0 read (the
  state and the counters exactly), and `eval.eval` of it on both hosts
  gives the captions and loss of the single process's `eval.eval`;
* the backend is the whole world's: the ranks exchange their cards
  through the rendezvous store (gloo on the CPU); on given card
  identities NCCL only where no two ranks share a card.
"""

import os

import numpy as np
import pytest

from cooperativeimagecaptioning_tpu_torch import eval as teval_entry
from cooperativeimagecaptioning_tpu_torch.parallel import launch, mesh
from cooperativeimagecaptioning_tpu_torch.utils.tree import leaves

import torch_mesh_ranks as ranks

STEPS = 3
LOSS_RTOL = 2e-5


@pytest.fixture(scope="module")
def hosts(tmp_path_factory):
    """The two-host run and the one-host (2, 1) run of the same options."""
    tmp = tmp_path_factory.mktemp("hosts")
    opt = ranks.tiny_opt(mesh_data_axis=2)
    got, dirs = ranks.run_hosts(tmp, "two_hosts_rank", (opt, STEPS))
    one = launch.spawn(ranks.train_mesh, (
        {"checkpoint_path": str(tmp / "one_host"), "id": "t"}, (2, 1), STEPS,
        False), 2, "cpu")
    return {"got": got, "dirs": dirs, "one": one, "opt": opt}


def test_two_hosts_equal_the_one_host_run(hosts):
    for r, got in enumerate(hosts["got"]):
        assert got["backend"] == "gloo"
        assert got["cwd"] == hosts["dirs"][r]
        np.testing.assert_allclose(got["losses"], hosts["one"][r]["losses"],
                                   rtol=LOSS_RTOL)
        want = dict(leaves(hosts["one"][r]["params"]))
        for k, v in leaves(got["trained"]["params"]):
            np.testing.assert_allclose(v, want[k], rtol=0,
                                       atol=2 * 1e-3 * STEPS, err_msg=k)


def test_only_host_0_holds_the_run_dir(hosts):
    d0, d1 = hosts["dirs"]
    assert os.path.isfile(os.path.join(d0, "run", "model.pth"))
    assert os.path.isfile(os.path.join(d0, "run", "infos_t.pkl"))
    assert os.path.isdir(os.path.join(d0, "run_resumed"))
    assert os.listdir(d1) == []


def test_a_resume_on_two_hosts_starts_from_rank_0s_files(hosts):
    for got in hosts["got"]:
        resumed, trained = got["resumed"], got["trained"]
        assert resumed["iteration"] == trained["iteration"] == STEPS
        for k, v in leaves(trained["params"]):
            np.testing.assert_array_equal(dict(leaves(resumed["params"]))[k],
                                          v, err_msg=k)
        for agent, st in trained["states"].items():
            got_st = resumed["states"][agent]
            np.testing.assert_array_equal(got_st["count"], st["count"])
            for key in ("mu", "nu"):
                for x, y in zip(got_st[key], st[key]):
                    np.testing.assert_array_equal(x, y)
        assert np.isfinite(got["resumed_loss"])
    assert hosts["got"][0]["resumed_loss"] == hosts["got"][1]["resumed_loss"]


def test_eval_of_the_run_dir_on_two_hosts_equals_one_process(hosts):
    """`eval.eval` of host 0's run dir in this process (the mesh options
    cleared) against the two hosts' (rank 0 read it for both)."""
    d0 = hosts["dirs"][0]
    infos = os.path.join(d0, "run", "infos_t.pkl")
    from cooperativeimagecaptioning_tpu_torch import config
    opt = config.load_infos(infos)["opt"]
    opt.mesh_data_axis, opt.mesh_model_axis = 0, 1
    want = teval_entry.eval(opt, os.path.join(d0, "run", "model.pth"), infos,
                            split="val", dataset=ranks.tiny_dataset(opt),
                            device="cpu")
    caps = {p["image_id"]: p["caption"] for p in want["split_predictions"]}
    for got in hosts["got"]:
        assert got["eval"][0] == caps
        np.testing.assert_allclose(got["eval"][1], want["loss"]["loss_cap"],
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("device,cards,want", [
    ("cuda", ["GPU-a", "GPU-b"], "nccl"),
    ("cuda", ["GPU-a", "GPU-a"], "gloo"),            # two hosts, one card
    ("cuda", ["GPU-a", "GPU-b", "GPU-a", "GPU-c"], "gloo"),
    ("cuda", ["GPU-a", "GPU-b", "GPU-c", "GPU-d"], "nccl"),
    ("cuda", ["GPU-a", None], "gloo"),
    ("cpu", [None, None], "gloo"),
])
def test_the_backend_is_the_whole_worlds(device, cards, want):
    assert mesh.world_backend(device, cards) == want
