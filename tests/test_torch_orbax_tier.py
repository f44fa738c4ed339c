"""The orbax tier without JAX (training/orbax_tier.py), held to tensorstore,
orbax and the JAX package on the CPU: the OCDBT reader against
tensorstore's reads of stores tensorstore writes; orbax saves of the JAX
package (OCDBT and plain files, dicts and sequences, sharded leaves) read
exactly; directories the port writes restored exactly by the JAX package
through both of its paths; atomic, asynchronous saves; optimizer files in
optax's layout both ways; the profiling endpoint.  The run dirs of the
orbax backend (resume, eval, serving) are in tests/test_torch_orbax.py."""

import json
import os
import pickle
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
ocp = pytest.importorskip("orbax.checkpoint")
ts = pytest.importorskip("tensorstore")
import jax.numpy as jnp  # noqa: E402

from cooperativeimagecaptioning_tpu import config as jconfig  # noqa: E402
from cooperativeimagecaptioning_tpu.parallel import mesh as jmesh  # noqa: E402
from cooperativeimagecaptioning_tpu.training import checkpoint as jckpt  # noqa: E402
from cooperativeimagecaptioning_tpu.training import optim as joptim  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.native import zstd  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.parallel import launch  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import checkpoint as tckpt  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import joint as tjoint  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import loop as tloop  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import orbax_tier  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.utils import profiling  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.utils.tree import (  # noqa: E402
    leaves, to_numpy, to_torch)
from test_torch_training import tiny_dataset, tiny_opt  # noqa: E402
import torch_mesh_ranks as ranks  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "jax_orbax_run")


def flat(tree):
    """{path joined by '.': numpy leaf} of a tree of either package."""
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def assert_trees_equal(want, got):
    a, b = flat(want), flat(got)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# OCDBT against tensorstore
# ---------------------------------------------------------------------------

STORES = {
    # (config, commits, keys a commit, value sizes)
    "inline": ({}, 1, 12, (3, 40)),
    "data_files": ({"max_inline_value_bytes": 16}, 1, 12, (3, 3000)),
    "tall": ({"max_inline_value_bytes": 16, "max_decoded_node_bytes": 200},
             3, 40, (1, 30)),
    "versions": ({"max_inline_value_bytes": 8}, 40, 3, (0, 20)),
    "raw": ({"compression": None}, 2, 10, (5, 2000)),
    "numbered": ({"manifest_kind": "numbered"}, 3, 5, (1, 100)),
}


@pytest.mark.parametrize("case", sorted(STORES))
def test_the_ocdbt_reader_agrees_with_tensorstore(tmp_path, case):
    config, commits, per_commit, (lo, hi) = STORES[case]
    root = str(tmp_path / "db")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                          "config": config}).result()
    rng = np.random.RandomState(len(case))
    for c in range(commits):
        with ts.Transaction() as txn:
            for i in range(per_commit):
                key = f"k{(c * 7 + i) % (3 * per_commit):03d}/{i}"
                kv.with_transaction(txn).write(
                    key, rng.bytes(rng.randint(lo, hi + 1))).result()
    want = {k.decode(): kv.read(k).result().value
            for k in kv.list().result()}
    db = orbax_tier.Ocdbt(root)
    assert db.items() == want
    gens = db.generations()
    assert gens == list(range(1, len(gens) + 1))
    assert len(gens) >= commits
    if case == "tall":
        assert db.versions[-1]["height"] > 0
    if case == "versions":
        assert db.version_nodes  # older versions live in version tree nodes
    if case == "data_files":
        assert len(os.listdir(os.path.join(root, "d"))) >= 1


def test_the_ocdbt_reader_checks_magic_length_and_checksum(tmp_path):
    root = str(tmp_path / "db")
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{root}/"}).result()
    kv.write("a", b"x" * 10).result()
    good = open(os.path.join(root, "manifest.ocdbt"), "rb").read()
    for mutate, match in ((lambda b: b"\x0c\xdb\x20\xde" + b[4:], "magic"),
                          (lambda b: b + b"\x00", "length"),
                          (lambda b: b[:20] + bytes([b[20] ^ 1]) + b[21:],
                           "checksum")):
        with open(os.path.join(root, "manifest.ocdbt"), "wb") as f:
            f.write(mutate(good))
        with pytest.raises(orbax_tier.FormatError, match=match):
            orbax_tier.Ocdbt(root)


def test_zstd_without_a_content_size_decompresses_to_the_given_size():
    zstandard = pytest.importorskip("zstandard")
    data = np.arange(1000, dtype=np.float32).tobytes()
    frame = zstandard.ZstdCompressor(write_content_size=False).compress(data)
    assert zstd.decompress(frame, len(data)) == data
    assert zstd.decompress(frame) == data  # grows until it fits
    with pytest.raises(ValueError, match="zstd"):
        zstd.decompress(frame, len(data) - 4)


# ---------------------------------------------------------------------------
# orbax saves of the JAX package, read by the port
# ---------------------------------------------------------------------------

def mixed_tree():
    rng = np.random.RandomState(3)
    mesh = jmesh.make_mesh(1, 4)
    split = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(
        None, "model"))
    return {"speaker": {
        "logit": {"w": jax.device_put(rng.randn(6, 8).astype(np.float32),
                                      split),
                  "b": jnp.asarray(rng.randn(8).astype(np.float32))},
        "count": jnp.asarray(3, jnp.int32),
        "half": jnp.asarray(rng.randn(5), jnp.bfloat16),
        "layers": [jnp.asarray(rng.randn(2, 3).astype(np.float32)),
                   {"w": jnp.arange(4, dtype=jnp.int32)}]}}


@pytest.mark.parametrize("use_ocdbt", [True, False])
def test_an_orbax_save_reads_exactly(tmp_path, use_ocdbt):
    tree = mixed_tree()
    path = str(tmp_path / "t.orbax")
    ck = ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=use_ocdbt))
    ck.save(path, tree)
    got = orbax_tier.read(path)
    assert isinstance(got["speaker"]["layers"], list)
    if use_ocdbt:
        keys = orbax_tier.ocdbt_items(path)
        assert {"speaker.logit.w/0.0", "speaker.logit.w/0.3"} <= set(keys)
    want = jax.tree.map(np.asarray, tree)
    want["speaker"]["half"] = want["speaker"]["half"].astype(np.float32)
    assert_trees_equal(want, got)


def test_the_committed_jax_fixture_reads_as_its_npz():
    """tests/data/jax_orbax_run (tests/data/make_jax_orbax_fixture.py):
    orbax restores it to its .npz, and so does the port."""
    path = os.path.join(FIXTURE, "model-best.orbax")
    expected = np.load(os.path.join(FIXTURE, "expected.npz"))
    want = {k: expected[k] for k in expected.files}
    restored = flat(ocp.StandardCheckpointer().restore(path))
    mine = dict(leaves(orbax_tier.read(path)))
    for got in (restored, mine):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    chunks = [k for k in orbax_tier.ocdbt_items(path)
              if k.startswith("speaker.logit.w/") and ".zarray" not in k]
    assert len(chunks) == 2  # saved sharded: the whole chunk grid is read


# ---------------------------------------------------------------------------
# directories the port writes, restored by the JAX package
# ---------------------------------------------------------------------------

def joint_params(seed):
    """Speaker and listener params (the port's init, the JAX package's
    tree) as JAX arrays."""
    opt = tiny_opt(vse_model="fc", vse_embed_size=16)
    return opt, jax.tree.map(jnp.asarray, to_numpy(
        tjoint.init_params(seed, opt, "cpu")))


@pytest.mark.parametrize("target", ["abstract", "none"])
def test_the_jax_package_restores_a_port_written_directory(tmp_path, target):
    """Through `_try_restore_tree` (an abstract target with the live
    shardings) and through `load_params_into` (no target, the lenient
    merge), bit-equal."""
    opt, saved = joint_params(0)
    opt.checkpoint_path = str(tmp_path)
    opt.checkpoint_backend = "orbax"
    mgr = tckpt.CheckpointManager(opt)
    mgr.save_best(to_numpy(jax.tree.map(np.asarray, saved)))
    mgr.sync()
    assert os.listdir(tmp_path) == ["model-best.orbax"]
    pth = str(tmp_path / "model-best.pth")
    _, fresh = joint_params(1)
    if target == "abstract":
        jmgr = jckpt.CheckpointManager(jconfig.Options(**vars(opt)))
        got = jmgr._try_restore_tree(fresh, pth)
    else:
        got = jckpt.load_params_into(fresh, pth)
    assert_trees_equal(saved, got)


def test_load_params_into_orbax_lenient_merge(tmp_path, capsys):
    """A speaker-only `.orbax` tree merges into speaker and listener params
    (JAX test_load_params_into_orbax_lenient_merge)."""
    opt, saved = joint_params(0)
    path = str(tmp_path / "model.pth")
    ck = ocp.StandardCheckpointer()
    ck.save(jckpt.CheckpointManager._orbax_path(path),
            {"speaker": saved["speaker"]})
    ck.wait_until_finished()
    _, fresh = joint_params(1)
    cur = to_torch(jax.tree.map(np.asarray, fresh), "cpu")
    merged = tckpt.load_params_into(cur, path)
    assert "not in loaded checkpoint" in capsys.readouterr().out
    assert_trees_equal(saved["speaker"], to_numpy(merged["speaker"]))
    assert_trees_equal(jax.tree.map(np.asarray, fresh["listener"]),
                       to_numpy(merged["listener"]))


def test_a_failed_save_leaves_the_previous_directory(tmp_path, monkeypatch):
    """A write that fails midway leaves no directory behind and the previous
    one intact; its error is raised at the next sync(), once."""
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.ones(4, np.int32)}}
    path = str(tmp_path / "model.orbax")
    w = orbax_tier.AsyncWriter()
    w.save(tree, path)
    w.sync()
    assert w.write_ms is not None
    real = orbax_tier._write_file

    def failing(p, data):
        if os.path.basename(p) == "_METADATA":  # after the arrays
            raise OSError("disk full")
        real(p, data)

    monkeypatch.setattr(orbax_tier, "_write_file", failing)
    w.save({"a": np.zeros((2, 3), np.float32),
            "b": {"c": np.zeros(4, np.int32)}}, path)
    with pytest.raises(OSError, match="disk full"):
        w.sync()
    w.sync()  # raised once
    assert os.listdir(tmp_path) == ["model.orbax"]
    assert_trees_equal(tree, orbax_tier.read(path))
    # and a failure raises at the next save too
    w.save(tree, str(tmp_path / "other.orbax"))
    with pytest.raises(OSError, match="disk full"):
        w.save(tree, str(tmp_path / "third.orbax"))
    monkeypatch.setattr(orbax_tier, "_write_file", real)
    w.save(tree, path)  # replaces the previous directory whole
    w.sync()
    assert sorted(os.listdir(tmp_path)) == ["model.orbax"]


def test_a_save_snapshots_the_tree_before_it_returns(tmp_path):
    """The snapshot is taken on the caller's thread: a later in-place
    update of the params (an Adam step) does not reach the file."""
    opt = tiny_opt(checkpoint_path=str(tmp_path), checkpoint_backend="orbax")
    mgr = tckpt.CheckpointManager(opt)
    params = {"speaker": {"w": torch.ones(1000, 100)}}
    mgr.save_model(params, 1)
    params["speaker"]["w"].add_(1.0)
    mgr.sync()
    for name in ("model.orbax", "model-1.orbax"):
        got = orbax_tier.read(str(tmp_path / name))
        assert np.all(got["speaker"]["w"] == 1.0)


def test_a_two_rank_run_writes_on_rank_zero_and_resumes(tmp_path):
    """One tiny save and restore on a (2, 1) mesh: rank 0 writes the
    `.orbax` directories, a (2, 1) Trainer resumes them through rank 0."""
    run = str(tmp_path / "run")
    out = launch.spawn(ranks.orbax_mesh_rank, (run,), 2, "cpu")
    assert sorted(n for n in os.listdir(run) if "model" in n) == [
        "model-1.orbax", "model-best.orbax", "model.orbax",
        "model_vse-best.orbax"]
    for r in out:
        saved, resumed = r
        assert resumed["iteration"] == saved["iteration"] == 1
        for (k, a), (_, b) in zip(leaves(saved["params"]),
                                  leaves(resumed["params"])):
            np.testing.assert_array_equal(a, b, err_msg=k)
        for key in ("mu", "nu"):
            for a, b in zip(saved["states"]["speaker"][key],
                            resumed["states"]["speaker"][key]):
                np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# optimizer files in optax's layout
# ---------------------------------------------------------------------------

def adam_of(state):
    return next(s for s in state.inner_state if hasattr(s, "mu"))


@pytest.mark.parametrize("weight_decay", [0, 1e-3])
def test_optimizer_files_load_in_both_packages(tmp_path, weight_decay):
    """A port-written optimizer.pth restores in the JAX package
    (`restored` True, every moment equal), and a JAX-written one in the
    port, both bit for bit."""
    opt = tiny_opt(checkpoint_path=str(tmp_path / "port"),
                   weight_decay=weight_decay)
    tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                       verbose=False)
    for _ in range(2):
        tr.train_iteration()
    tr.ckpt.save_optimizers(tr.optim)
    jopt = jconfig.Options(**vars(opt))
    jopt.start_from = str(tmp_path / "port")
    params = jax.tree.map(jnp.asarray, to_numpy(tr.params))
    jm = joptim.OptimizerManager(jopt, params)
    assert jckpt.CheckpointManager(jopt).load_optimizers(jm)
    mine = tr.optim.states["speaker"]
    adam = adam_of(jm.states["speaker"])
    assert int(adam.count) == int(mine["count"]) == 2
    assert int(jm.states["speaker"].count) == 2
    np.testing.assert_allclose(
        float(jm.states["speaker"].hyperparams["learning_rate"]),
        tr.optim.lr, rtol=1e-7)
    for key in ("mu", "nu"):
        want = flat(getattr(adam, key))
        assert list(want) == tr.optim.paths["speaker"]
        for (k, a), b in zip(want.items(), mine[key]):
            np.testing.assert_array_equal(a, b.numpy(), err_msg=k)
    # the JAX package's seeding path takes it too
    jm2 = joptim.OptimizerManager(jopt, params)
    assert jckpt.CheckpointManager(jopt).load_agent_optimizer(
        jm2, "speaker", str(tmp_path / "port" / "optimizer.pth"))
    # and the other way: the JAX package writes, the port reads
    jopt.checkpoint_path = str(tmp_path / "jax")
    jckpt.CheckpointManager(jopt).save_optimizers(jm)
    again = tloop.Trainer(tiny_opt(checkpoint_path=str(tmp_path / "p2"),
                                   weight_decay=weight_decay), dataset=
                          tiny_dataset(opt), device="cpu", verbose=False)
    assert again.ckpt.load_agent_optimizer(
        again.optim, "speaker", str(tmp_path / "jax" / "optimizer.pth"))
    for key in ("mu", "nu"):
        for a, b in zip(mine[key], again.optim.states["speaker"][key]):
            assert torch.equal(a, b)


def test_the_ports_older_plain_layout_still_loads(tmp_path):
    """Run dirs of earlier port versions hold {'count', 'mu', 'nu',
    'paths'}."""
    opt = tiny_opt(checkpoint_path=str(tmp_path / "a"))
    tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                       verbose=False)
    tr.train_iteration()
    st = to_numpy(tr.optim.state_dict()["speaker"])
    st["paths"] = list(tr.optim.paths["speaker"])
    path = str(tmp_path / "optimizer.pth")
    with open(path, "wb") as f:
        pickle.dump(st, f)
    fresh = tloop.Trainer(tiny_opt(checkpoint_path=str(tmp_path / "b")),
                          dataset=tiny_dataset(opt), device="cpu",
                          verbose=False)
    assert fresh.ckpt.load_agent_optimizer(fresh.optim, "speaker", path)
    assert int(fresh.optim.states["speaker"]["count"]) == 1
    for key in ("mu", "nu"):
        for a, b in zip(tr.optim.states["speaker"][key],
                        fresh.optim.states["speaker"][key]):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the profiling endpoint
# ---------------------------------------------------------------------------

def test_start_server_captures_another_threads_range(tmp_path):
    server = profiling.start_server(0)
    stop = threading.Event()

    def work():
        a = torch.randn(32, 32)
        while not stop.is_set():
            with profiling.annotate("worker_range"):
                a = a @ a
                a = a / a.norm()
            time.sleep(0.001)

    worker = threading.Thread(target=work)
    worker.start()
    url = f"http://127.0.0.1:{server.port}/capture"
    try:
        with urllib.request.urlopen(
                f"{url}?duration_ms=150&log_dir={tmp_path}",
                timeout=60) as r:
            got = json.load(r)
        with pytest.raises(urllib.error.HTTPError, match="400"):
            urllib.request.urlopen(f"{url}?log_dir={tmp_path}", timeout=60)
    finally:
        stop.set()
        worker.join(timeout=60)
        server.stop()
    assert not worker.is_alive() and not server.thread.is_alive()
    assert got["all_threads"] and os.path.dirname(got["path"]) == \
        str(tmp_path)
    names = {e.get("name") for e in json.load(open(got["path"]))[
        "traceEvents"]}
    assert "worker_range" in names


def test_the_bootstrap_cascade_reads_orbax_stage_dirs(tmp_path):
    """A phase-3 run seeded from an orbax-backend stage-2 run dir (the
    stage driver's seeding copies its `.orbax` directory) takes its
    speaker."""
    from cooperativeimagecaptioning_tpu_torch.scripts import run_joint
    stage2 = str(tmp_path / "log_att")
    opt = tiny_opt(checkpoint_path=stage2, checkpoint_backend="orbax",
                   id="att")
    tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                       verbose=False)
    tr.train_iteration()
    tr.checkpoint_operations()
    tr.close()
    model = os.path.join(stage2, "model-best.pth")
    joint_dir = str(tmp_path / "joint")
    run_joint.seed_checkpoint_dir(joint_dir, model, "j")
    assert "model-best.orbax" in os.listdir(joint_dir)
    seeded = tloop.Trainer(tiny_opt(checkpoint_path=joint_dir, phase=3,
                                    cider_optimization=1,
                                    caption_loss_weight=0,
                                    speaker_stage_2_model_path=os.path.join(
                                        joint_dir, "model-best.pth")),
                           dataset=tiny_dataset(opt), device="cpu",
                           verbose=False)
    for (k, a), (_, b) in zip(leaves(tr.params), leaves(seeded.params)):
        assert torch.equal(a, b), k
