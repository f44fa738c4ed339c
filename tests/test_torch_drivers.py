"""The port's drivers against the JAX package's, on the CPU: the stage
drivers' flag sets, run-dir naming and Options (scripts/run_fc_con.py,
run_att.py, run_joint.py), the stage-2 seeding of a joint run dir, results
harvesting on a JAX-written and a port-written run dir (the test
re-evaluation through each package's eval), and reproduce_coco: its layout
report and the whole chain at tiny dims with --device cpu.

Tolerances: harvest's test numbers (language metrics, losses, rank
percentages) as the evaluation tests hold eval.eval: metrics within 1e-6,
losses rtol 1e-5; everything else equal."""

import argparse
import copy
import json
import os
import pickle
import shutil
import sys

import numpy as np
import pytest

from cooperativeimagecaptioning_tpu_torch import config as tconfig
from cooperativeimagecaptioning_tpu_torch.data import SyntheticDataset
from cooperativeimagecaptioning_tpu_torch.evaluation import harvest as tharvest
from cooperativeimagecaptioning_tpu_torch.native import bindings as tbindings
from cooperativeimagecaptioning_tpu_torch.scripts import (
    reproduce_coco as trepro, run_att as trun_att, run_fc_con as trun_fc_con,
    run_joint as trun_joint)
from cooperativeimagecaptioning_tpu_torch.training import checkpoint as tckpt
from cooperativeimagecaptioning_tpu_torch.training import loop as tloop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# intra-op threads of the chain's ResNet-101 forwards (as in
# test_torch_preprocess.py: the tier-1 run's workers share the host's cores)
THREADS = 2
MODES = ("gumbel", "gumbel_softmax", "multinomial", "multinomial_soft",
         "reinforce", "reinforce_listener", "reinforce_speaker",
         "gumbel_speaker", "multinomial_speaker")


@pytest.fixture(scope="module")
def jx():
    """The JAX package's drivers, harvest and reproduce_coco (skips where
    JAX is missing)."""
    pytest.importorskip("jax")
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from scripts import reproduce_coco, run_att, run_fc_con, run_joint
    from cooperativeimagecaptioning_tpu import config
    from cooperativeimagecaptioning_tpu.evaluation import harvest
    from cooperativeimagecaptioning_tpu.native import bindings
    from cooperativeimagecaptioning_tpu.training import loop
    return dict(run_fc_con=run_fc_con, run_att=run_att, run_joint=run_joint,
                reproduce_coco=reproduce_coco, config=config,
                harvest=harvest, bindings=bindings, loop=loop)


# ---------------------------------------------------------------------------
# flag sets
# ---------------------------------------------------------------------------

def run_args(**kw):
    base = dict(optimization="gumbel", discriminative=0.01, temperature=8.0,
                lr=5e-3, decay=0.75, every=15, batch=128, vse=0.0,
                caption=0.0, reinforce_baseline="gt", shared_embedding=0,
                prob=0.25, softmax_cooling=0.0, annealing=0.93,
                annealing_every=500, max_epochs=350)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("vse", [0, 1])
@pytest.mark.parametrize("mode", MODES)
def test_build_run_equals_the_jax_scripts(jx, mode, vse):
    for kw in ({}, dict(discriminative=0.5, softmax_cooling=0.5, prob=0.3,
                        caption=0.1, reinforce_baseline="greedy",
                        shared_embedding=1, annealing_every=0)):
        a = run_args(optimization=mode, vse=vse, **kw)
        assert trun_joint.build_run(copy.copy(a)) == \
            jx["run_joint"].build_run(copy.copy(a))
    assert trun_joint.joint_flags(optimization=mode, vse=vse) == \
        jx["run_joint"].joint_flags(optimization=mode, vse=vse)


def test_build_run_refuses_an_unknown_mode():
    with pytest.raises(SystemExit, match="Unknown optimization"):
        trun_joint.build_run(run_args(optimization="nope"))


def test_stage_flags_equal_the_jax_scripts(jx):
    assert trun_fc_con.STAGE_FLAGS == jx["run_fc_con"].STAGE_FLAGS
    assert trun_att.STAGE_FLAGS == jx["run_att"].STAGE_FLAGS


def _capture(monkeypatch, loop_mod, harvest_mod=None):
    seen = {}

    def train(opt, device=None):
        seen["opt"], seen["device"] = opt, device
    monkeypatch.setattr(loop_mod, "train", train)
    if harvest_mod is not None:
        monkeypatch.setattr(
            harvest_mod, "create_dicts_and_json_after_training",
            lambda opt, device=None: seen.update(harvested=opt,
                                                 harvest_device=device))
    return seen


DRIVER_ARGV = {
    "run_fc_con": ["-b", "16", "--max-epochs", "3", "--set", "rnn_size=64"],
    "run_att": ["-b", "16", "-E", "1", "--listener-stage-1-model",
                "s1/model-best.pth", "--set", "learning_rate=0.001"],
    "run_joint": ["-o", "reinforce", "-D", "0.2", "-v", "1", "-b", "16",
                  "--speaker-stage-2-model", "s2/model-best.pth",
                  "--listener-stage-1-model", "s1/model-best.pth",
                  "--set", "cached_tokens=coco-train-idxs"],
}


@pytest.mark.parametrize("driver", sorted(DRIVER_ARGV))
def test_driver_options_equal_the_jax_scripts(jx, tmp_path, monkeypatch,
                                              driver):
    """Each driver's main builds the JAX script's Options (relative paths
    from equal working directories) and hands the port's train its
    --device; run_joint then harvests the run on that device."""
    opts = {}
    for side in ("jax", "port"):
        wd = tmp_path / side
        (wd / "s2").mkdir(parents=True)
        (wd / "s2" / "model-best.pth").write_bytes(b"speaker")
        monkeypatch.chdir(wd)
        if side == "jax":
            seen = _capture(monkeypatch, jx["loop"], jx["harvest"])
            getattr(jx[driver], "main")(DRIVER_ARGV[driver])
        else:
            from cooperativeimagecaptioning_tpu_torch.evaluation import \
                harvest
            seen = _capture(monkeypatch, tloop, harvest)
            getattr({"run_fc_con": trun_fc_con, "run_att": trun_att,
                     "run_joint": trun_joint}[driver], "main")(
                DRIVER_ARGV[driver] + ["--device", "cpu"])
            assert seen["device"] == "cpu"
            if driver == "run_joint":
                assert seen["harvested"] is seen["opt"]
                assert seen["harvest_device"] == "cpu"
        opts[side] = seen["opt"]
    assert type(opts["port"]) is tconfig.Options
    assert vars(opts["port"]) == vars(opts["jax"])
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))


def _stage2_dir(root, with_infos=True):
    d = root / "log_att"
    d.mkdir(parents=True)
    (d / "model-best.pth").write_bytes(b"best speaker")
    (d / "model.pth").write_bytes(b"last speaker")
    (d / "optimizer.pth").write_bytes(b"adam")
    if with_infos:
        (d / "infos_att.pkl").write_bytes(b"infos")
    return d


def _files(d):
    return {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("with_infos", [True, False])
def test_seed_checkpoint_dir_equals_the_jax_scripts(jx, tmp_path, with_infos):
    src = _stage2_dir(tmp_path / "src", with_infos)
    model = str(src / "model-best.pth")
    out = {}
    for side, mod in (("jax", jx["run_joint"]), ("port", trun_joint)):
        ckpt = tmp_path / side / "G0.01"
        mod.seed_checkpoint_dir(str(ckpt), model, "att_d0.01")
        (ckpt / "model-best.pth").write_bytes(b"trained on")  # never clobbered
        mod.seed_checkpoint_dir(str(ckpt), model, "att_d0.01")
        mod.seed_checkpoint_dir(str(tmp_path / side / "empty"), "", "x")
        out[side] = (_files(ckpt), os.listdir(tmp_path / side / "empty"))
    assert out["port"] == out["jax"]
    files = out["port"][0]
    assert "alternatingModel.pth" not in files
    assert files["speaker_optimizer.pth"] == b"adam"
    assert ("infos_att_d0.01.pkl" in files) is with_infos


# ---------------------------------------------------------------------------
# harvest
# ---------------------------------------------------------------------------

DS = dict(num_images=24, vocab_size=20, seq_length=6, fc_feat_size=12,
          att_feat_size=12, max_K=5)


def harvest_opt(cfg, ckpt, run_id):
    return cfg.Options(
        caption_model="att2in2", vse_model="fc", batch_size=6, seq_per_img=1,
        rnn_size=12, input_encoding_size=10, att_hid_size=8,
        vse_embed_size=12, fc_feat_size=12, att_feat_size=12,
        drop_prob_lm=0.0, learning_rate=1e-3, grad_clip=0.1,
        checkpoint_path=str(ckpt), id=run_id, save_checkpoint_every=2,
        losses_log_every=2, language_eval=1, rank_eval=1, max_epochs=-1,
        max_att_len=5, phase=2, caption_loss_weight=1, vse_loss_weight=0.1,
        val_images_use=-1, load_best_score=0)


@pytest.fixture(scope="module")
def port_run_dir(tmp_path_factory):
    """A run dir the port's Trainer wrote: checkpoints at iterations 2, 4
    and 6 (val language metrics and ranks in its histories)."""
    root = tmp_path_factory.mktemp("port_run")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        opt = harvest_opt(tconfig, root / "run", "prun")
        os.makedirs(opt.checkpoint_path)
        tr = tloop.Trainer(opt, dataset=SyntheticDataset(**DS), device="cpu",
                           verbose=False)
        for _ in range(6):
            tr.train_iteration()
            if tr.iteration % opt.save_checkpoint_every == 0:
                tr.checkpoint_operations()
    finally:
        os.chdir(cwd)
    return str(root / "run"), "prun"


@pytest.fixture(scope="module")
def jax_run_dir(tmp_path_factory, jx):
    """A run dir the JAX package wrote (its save_params, its Options in the
    infos): per-iteration models of three different seeds, and a history
    whose criteria pick iterations 4, 4 and 2."""
    import jax
    from cooperativeimagecaptioning_tpu.training import joint
    from cooperativeimagecaptioning_tpu.training.checkpoint import save_params
    run = tmp_path_factory.mktemp("jax_run") / "run"
    run.mkdir()
    opt = harvest_opt(jx["config"], run, "jrun")
    opt.vocab_size, opt.seq_length = DS["vocab_size"], DS["seq_length"]
    hist = {"val_result_history": {}}
    for seed, (it, cider, bleu, r10) in enumerate(
            ((2, 0.5, 0.3, 40.0), (4, 0.9, 0.4, 20.0), (6, 0.7, 0.2, 30.0))):
        params = joint.init_params(jax.random.PRNGKey(seed), opt)
        save_params(params, str(run / f"model-{it}.pth"))
        hist["val_result_history"][it] = {
            "lang_stats": {"CIDEr": cider, "Bleu_4": bleu},
            "loss": {"t2i_r10": r10}, "predictions": []}
    save_params(params, str(run / "model.pth"))
    with open(run / "histories_jrun.pkl", "wb") as f:
        pickle.dump(hist, f)
    vocab = {str(i): f"w{i}" for i in range(1, DS["vocab_size"] + 1)}
    with open(run / "infos_jrun.pkl", "wb") as f:
        pickle.dump({"opt": opt, "vocab": vocab}, f)
    return str(run), "jrun"


def _assert_test_numbers_close(got, want):
    assert set(got) == set(want)
    for crit in want:
        for part in ("lang_stats", "loss"):
            g, w = got[crit][part], want[crit][part]
            assert set(g) == set(w), (crit, part)
            for k, v in w.items():
                if part == "lang_stats" or k.startswith(("t2i", "i2t")):
                    assert abs(g[k] - v) <= 1e-6, (crit, k)
                else:
                    np.testing.assert_allclose(g[k], v, rtol=1e-5, atol=0,
                                               err_msg=f"{crit} {k}")


@pytest.mark.parametrize("written_by", ["jax", "port"])
def test_harvest_equals_the_jax_packages(jx, tmp_path, monkeypatch,
                                         written_by, request):
    """Best selection, pruning, val/test dicts and the json report of each
    package's harvest over copies of one run dir, with the test
    re-evaluation through each package's eval on the same dataset."""
    src, run_id = request.getfixturevalue(f"{written_by}_run_dir")
    # both packages score on their pure-Python tier (the C++ tiers are held
    # equal in test_torch_native.py)
    monkeypatch.setattr(jx["bindings"], "available", lambda: False)
    monkeypatch.setattr(tbindings, "available", lambda: False)
    monkeypatch.chdir(tmp_path)
    out = {}
    for side, cfg, mod in (("jax", jx["config"], jx["harvest"]),
                           ("port", tconfig, tharvest)):
        run = str(tmp_path / side / "run")
        shutil.copytree(src, run)
        opt = harvest_opt(cfg, run, run_id)
        kw = {"device": "cpu"} if side == "port" else {}
        ds = SyntheticDataset(**DS)
        if side == "jax":
            from cooperativeimagecaptioning_tpu.data import sources
            ds = sources.SyntheticDataset(**DS)
        path = mod.create_dicts_and_json_after_training(
            opt, dataset=ds, json_dir=str(tmp_path / side / "json"), **kw)
        with open(path) as f:
            report = json.load(f)
        dicts = {}
        for name in ("val_dict.pkl", "test_dict.pkl"):
            with open(os.path.join(run, name), "rb") as f:
                dicts[name] = pickle.load(f)
        out[side] = (report, dicts, sorted(os.listdir(run)),
                     os.path.basename(path))
    (jrep, jdicts, jfiles, jname), (trep, tdicts, tfiles, tname) = \
        out["jax"], out["port"]
    assert tname == jname == "run.json"
    assert tfiles == jfiles
    kept = {int(f[f.find("-") + 1:-4]) for f in tfiles
            if tharvest._is_iter_model(f)}
    assert kept == set(tdicts["val_dict.pkl"]["test_models"].values())
    assert tdicts["val_dict.pkl"] == jdicts["val_dict.pkl"]
    assert set(tdicts["test_dict.pkl"]) == set(jdicts["test_dict.pkl"]) == \
        set(trep["test"]) and trep["test"]
    for crit, res in tdicts["test_dict.pkl"].items():
        want = jdicts["test_dict.pkl"][crit]
        assert [(p["image_id"], p["caption"])
                for p in res["split_predictions"]] == \
            [(p["image_id"], p["caption"])
             for p in want["split_predictions"]], crit
    _assert_test_numbers_close(trep["test"], jrep["test"])
    for k in ("best_iteration_by", "val"):
        assert trep[k] == jrep[k], k
    assert trep["full_path"].endswith(os.path.join("port", "run"))
    assert trep["opt"] == {k: v if k != "checkpoint_path" else
                           v.replace(os.sep + "jax" + os.sep,
                                     os.sep + "port" + os.sep)
                           for k, v in jrep["opt"].items()}


def test_train_cli_harvests_after_phase_3(jx, tmp_path, monkeypatch):
    """The port's `train.main --phase 3` trains a tiny run on the CPU and
    then harvests it (the val / test dicts and the json report), as the
    repository's train.py does: the root CLI, handed a copy of the same run
    dir taken before the harvest (its training replaced by that run),
    writes the same json."""
    import train as root_train
    from cooperativeimagecaptioning_tpu import config as jconfig
    from cooperativeimagecaptioning_tpu.data import loader as jloader
    from cooperativeimagecaptioning_tpu.data import sources as jsources
    from cooperativeimagecaptioning_tpu_torch import train as ttrain
    from cooperativeimagecaptioning_tpu_torch.data import loader as tloader
    monkeypatch.setattr(tloader, "FileDataset",
                        lambda opt: SyntheticDataset(**DS))
    monkeypatch.setattr(jloader, "FileDataset",
                        lambda opt: jsources.SyntheticDataset(**DS))
    monkeypatch.setattr(jx["bindings"], "available", lambda: False)
    monkeypatch.setattr(tbindings, "available", lambda: False)
    monkeypatch.chdir(tmp_path)

    def flags(run):
        return ["--caption_model", "att2in2", "--vse_model", "fc",
                "--batch_size", "6", "--seq_per_img", "1", "--rnn_size", "12",
                "--input_encoding_size", "10", "--att_hid_size", "8",
                "--vse_embed_size", "12", "--fc_feat_size", "12",
                "--att_feat_size", "12", "--drop_prob_lm", "0",
                "--learning_rate", "1e-3", "--grad_clip", "0.1",
                "--checkpoint_path", str(run), "--id", "crun",
                "--save_checkpoint_every", "2", "--losses_log_every", "2",
                "--language_eval", "1", "--rank_eval", "1", "--max_epochs",
                "3", "--max_att_len", "5", "--phase", "3",
                "--caption_loss_weight", "1", "--vse_loss_weight", "0.1",
                "--val_images_use", "-1", "--load_best_score", "0"]

    port_run, jax_run = tmp_path / "port" / "run", tmp_path / "jax" / "run"
    harvest = tharvest.create_dicts_and_json_after_training
    seen = {}

    def copy_then_harvest(opt, **kw):
        shutil.copytree(opt.checkpoint_path, jax_run)
        seen.update(opt=opt, kw=kw)
        return harvest(opt, **kw)
    monkeypatch.setattr(tharvest, "create_dicts_and_json_after_training",
                        copy_then_harvest)
    trainer = ttrain.main(["--device", "cpu"] + flags(port_run))
    assert trainer.iteration >= 6 and seen["kw"] == {"device": "cpu"}
    assert (port_run / "val_dict.pkl").is_file()

    def trained(opt):
        """What the JAX Trainer sets on opt (loop.py's Trainer.__init__);
        the run itself is the copy."""
        opt.use_att = jconfig.if_use_att(opt)
        data = jloader.DataLoader(opt)
        opt.vocab_size, opt.seq_length = data.vocab_size, data.seq_length
    monkeypatch.setattr(root_train, "train", trained)
    monkeypatch.setattr(sys, "argv", ["train.py"] + flags(jax_run))
    root_train.main()
    reports = {}
    for side, run in (("port", port_run), ("jax", jax_run)):
        with open(run.parent / "json_dir" / "run.json") as f:
            reports[side] = json.load(f)
    trep, jrep = reports["port"], reports["jax"]
    assert sorted(os.listdir(port_run)) == sorted(os.listdir(jax_run))
    assert trep["test"] and set(trep["test"]) == set(jrep["test"])
    _assert_test_numbers_close(trep["test"], jrep["test"])
    for k in ("best_iteration_by", "val"):
        assert trep[k] == jrep[k], k
    assert trep["full_path"] == str(port_run)
    assert trep["opt"] == {k: v if k != "checkpoint_path" else str(port_run)
                           for k, v in jrep["opt"].items()}


def test_harvest_cli_over_run_dirs_of_both_packages(jx, tmp_path,
                                                    port_run_dir,
                                                    jax_run_dir):
    """`python -m ...evaluation.harvest --dir <parent>` over a JAX-written
    and a port-written run dir (no test re-evaluation): the same json and
    pruning as the JAX package's CLI, and the dict cache on a second call."""
    parents = {}
    for side in ("port", "jax"):
        for name, (src, _) in (("jax", jax_run_dir), ("port", port_run_dir)):
            shutil.copytree(src, tmp_path / side / name)
        parents[side] = str(tmp_path / side)
    got = tharvest.main(["--dir", parents["port"], "--json_dir",
                         parents["port"] + "_json", "--device", "cpu"])
    want = jx["harvest"].main(["--dir", parents["jax"], "--json_dir",
                               parents["jax"] + "_json"])
    assert sorted(os.path.basename(k) for k in got) == \
        sorted(os.path.basename(k) for k in want) == ["jax", "port"]
    for name in ("jax", "port"):
        reports = []
        for side in ("port", "jax"):
            with open(os.path.join(parents[side] + "_json",
                                   f"{name}.json")) as f:
                reports.append(json.load(f))
        t, j = reports
        assert t["best_iteration_by"] == j["best_iteration_by"]
        assert t["val"] == j["val"] and t["test"] == j["test"] == {}
        assert sorted(os.listdir(os.path.join(parents["port"], name))) == \
            sorted(os.listdir(os.path.join(parents["jax"], name)))
    again = tharvest.harvest_runs(parents["port"], min_models_in_dir=3,
                                  json_dir=parents["port"] + "_json",
                                  device="cpu")
    assert all(v is None for v in again.values())


def test_opt_from_infos_reads_either_package(jx, port_run_dir, jax_run_dir):
    for run, _ in (port_run_dir, jax_run_dir):
        opt = tharvest._opt_from_infos(run)
        assert type(opt) is tconfig.Options and opt.rnn_size == 12


def test_pruning_deletes_an_orbax_directory(tmp_path):
    (tmp_path / "model-2.orbax").mkdir()
    (tmp_path / "model-2.orbax" / "x").write_bytes(b"x")
    (tmp_path / "model-4.pth").write_bytes(b"x")
    (tmp_path / "model-best.pth").write_bytes(b"x")
    tharvest.remove_unnecessary_models({"test_models": {"cider": 4}},
                                       str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["model-4.pth", "model-best.pth"]


# ---------------------------------------------------------------------------
# reproduce_coco
# ---------------------------------------------------------------------------

def _mk_labels(data, vocab=6, n_images=4, max_label=None, seq=5):
    import h5py
    os.makedirs(data, exist_ok=True)
    talk = {"ix_to_word": {str(i + 1): f"w{i}" for i in range(vocab)},
            "images": [{"id": i, "split": "train"} for i in range(n_images)]}
    with open(os.path.join(data, "cocotalk.json"), "w") as f:
        json.dump(talk, f)
    labels = np.random.RandomState(0).randint(
        1, (max_label or vocab) + 1, (n_images, seq), dtype="int64")
    labels[0, 0] = max_label or vocab
    with h5py.File(os.path.join(data, "cocotalk_label.h5"), "w") as f:
        f.create_dataset("labels", data=labels)
        f.create_dataset("label_start_ix", data=np.arange(1, n_images + 1))
        f.create_dataset("label_end_ix", data=np.arange(1, n_images + 1))
        f.create_dataset("label_length",
                         data=np.full((n_images,), seq, dtype="int64"))


def _age(path, by=100):
    old = os.path.getmtime(path) - by
    os.utime(path, (old, old))


def _layout(case, wd):
    """Build one prepro layout state in `wd`; returns the raw json path
    check_layout is given ('' for none)."""
    data = os.path.join(wd, "data")
    raw = ""
    if case == "empty":
        return raw
    if case == "corrupt":
        os.makedirs(data)
        for name in ("cocotalk.json", "cocotalk_label.h5"):
            with open(os.path.join(data, name), "w") as f:
                f.write("not this")
        return raw
    _mk_labels(data, vocab=6, max_label=11 if case == "mismatch" else None)
    if case == "json_only":
        os.remove(os.path.join(data, "cocotalk_label.h5"))
    if case == "stale_labels":
        raw = os.path.join(wd, "dataset_coco.json")
        with open(raw, "w") as f:
            json.dump({"images": []}, f)
        for name in ("cocotalk.json", "cocotalk_label.h5"):
            _age(os.path.join(data, name))
    if case in ("stale_ngrams", "partial_feats", "complete", "downloaded"):
        idxs = os.path.join(data, "coco-train-idxs.p")
        with open(idxs, "wb") as f:
            f.write(b"x")
        if case == "stale_ngrams":
            _age(idxs)
    if case in ("partial_feats", "complete", "downloaded"):
        att = "cocobu_att" if case == "downloaded" else "cocotalk_att"
        for d in ("cocotalk_fc", att):
            os.makedirs(os.path.join(data, d))
        n = 1 if case == "partial_feats" else 4
        for i in range(n):
            np.save(os.path.join(data, "cocotalk_fc", f"{i}.npy"), np.zeros(3))
            np.savez(os.path.join(data, att, f"{i}.npz"), feat=np.zeros(3))
        # an in-flight temporary of the atomic writes is not counted
        np.save(os.path.join(data, "cocotalk_fc", ".9.tmp.npy"), np.zeros(3))
    return raw


LAYOUT_CASES = ("empty", "corrupt", "json_only", "mismatch", "stale_labels",
                "stale_ngrams", "partial_feats", "complete", "downloaded")


@pytest.mark.parametrize("case", LAYOUT_CASES)
def test_check_layout_equals_the_jax_scripts(jx, tmp_path, case):
    pytest.importorskip("h5py")
    raw = _layout(case, str(tmp_path))
    got = trepro.check_layout(str(tmp_path), raw)
    want = jx["reproduce_coco"].check_layout(str(tmp_path), raw)
    assert got == want
    state = {"empty": "missing", "corrupt": "mismatch", "json_only":
             "partial", "mismatch": "mismatch", "stale_labels": "stale"}
    if case in state:
        assert got["labels"]["state"] == state[case]
    if case in ("complete", "downloaded"):
        assert {v["state"] for v in got.values()} == {"ok"}
    if case == "partial_feats":
        assert got["feats"]["state"] == "partial" and got["feats"]["n_fc"] == 1


def test_an_inconsistent_layout_aborts(tmp_path):
    pytest.importorskip("h5py")
    _layout("mismatch", str(tmp_path))
    with pytest.raises(SystemExit, match="mismatch"):
        trepro.main(["--workdir", str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="Missing inputs"):
        trepro.main(["--workdir", str(tmp_path / "none"), "--device", "cpu"])


def test_synthetic_raw_equals_the_jax_scripts(jx, tmp_path):
    pytest.importorskip("PIL")
    got = trepro.fabricate_synthetic_raw(str(tmp_path / "port"), 5, size=20)
    want = jx["reproduce_coco"].fabricate_synthetic_raw(
        str(tmp_path / "jax"), 5, size=20)
    with open(got[0]) as f, open(want[0]) as g:
        assert json.load(f) == json.load(g)
    sub = os.path.join("images", "train2014")
    names = sorted(os.listdir(tmp_path / "jax" / sub))
    assert sorted(os.listdir(tmp_path / "port" / sub)) == names
    for n in names:
        assert (tmp_path / "port" / sub / n).read_bytes() == \
            (tmp_path / "jax" / sub / n).read_bytes()


def test_reproduce_coco_runs_the_ports_chain(tmp_path, capsys, monkeypatch,
                                             request):
    """raw json + images -> labels, n-grams, ResNet-101 features -> stages
    1, 2 and 3 -> harvest, all of the port on the CPU; a second call skips
    every finished stage (stage 3 resumes its run dir)."""
    import torch
    pytest.importorskip("h5py")
    pytest.importorskip("PIL")
    monkeypatch.chdir(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(THREADS, threads))
    request.addfinalizer(lambda: torch.set_num_threads(threads))
    wd = str(tmp_path / "repro")
    argv = ["--synthetic", "16", "--workdir", wd, "--device", "cpu",
            "--set", "losses_log_every=2"]
    trepro.main(argv)
    first = capsys.readouterr().out
    data = os.path.join(wd, "data")
    for name in ("cocotalk.json", "cocotalk_label.h5", "coco-train-idxs.p"):
        assert os.path.isfile(os.path.join(data, name)), name
    assert sorted(os.listdir(os.path.join(data, "cocotalk_fc"))) == \
        sorted(f"{i}.npy" for i in range(16))
    att = np.load(os.path.join(data, "cocotalk_att", "3.npz"))["feat"]
    assert att.shape == (14, 14, 2048) and np.isfinite(att).all()
    for stage in ("log_fc_con", "log_att"):
        assert os.path.isfile(os.path.join(wd, stage, "model-best.pth"))
    (run,) = [d for d in os.listdir(os.path.join(wd, "gumbel"))
              if d != "json_dir"]
    names = os.listdir(os.path.join(wd, "gumbel", run))
    assert "alternatingModel.pth" in names and "val_dict.pkl" in names
    with open(os.path.join(wd, "gumbel", run, "test_dict.pkl"), "rb") as f:
        test_dict = pickle.load(f)
    assert test_dict and all("CIDEr" in r["lang_stats"]
                             for r in test_dict.values())
    assert os.listdir(os.path.join(wd, "gumbel", "json_dir")) == \
        [run + ".json"]
    for step in ("[prepro] labels", "[prepro] ngrams", "[prepro] feats",
                 "[stage 1]", "[stage 2]", "[stage 3]"):
        assert step in first, step

    fc_dir = os.path.join(data, "cocotalk_fc")
    mtimes = {f: os.path.getmtime(os.path.join(fc_dir, f))
              for f in os.listdir(fc_dir)}
    trepro.main(argv)
    second = capsys.readouterr().out
    # --synthetic writes its raw json anew, which makes the labels and the
    # n-grams derived from it stale (rebuilt, as in the JAX script); the
    # features and the first two stages are done
    for step in ("[prepro] feats", "[stage 1]", "[stage 2]"):
        assert step not in second, step
    assert {f: os.path.getmtime(os.path.join(fc_dir, f))
            for f in os.listdir(fc_dir)} == mtimes
    assert "[stage 3]" in second and "all stages complete" in second
    assert tckpt.load_params(os.path.join(wd, "gumbel", run,
                                          "alternatingModel.pth"))
