"""The port's experiment drivers (scripts/showcase_full_scale,
fixed_listener_rank, mode_grid, mode_grid_report, time_eval_protocol)
against the JAX package's root scripts: the same helpers and flag sets,
the same Options for every stage, the fixed-listener rank grid over one
run-dir chain the JAX package trained, the same report text; and each of
the port's drivers end to end at tiny dims on the CPU."""

import copy
import json
import os
import shutil
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from cooperativeimagecaptioning_tpu_torch.scripts import (  # noqa: E402
    fixed_listener_rank as tflr, mode_grid as tgrid,
    mode_grid_report as treport, showcase_full_scale as tshow,
    time_eval_protocol as ttep)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM_SET = ["--set", "rnn_size=24", "--set", "input_encoding_size=16",
           "--set", "att_hid_size=12", "--set", "vse_embed_size=16",
           "--set", "fc_feat_size=20", "--set", "att_feat_size=20",
           "--set", "max_att_len=5", "--set", "drop_prob_lm=0.1"]
TINY = ["--images", "24", "--batch", "4", "--vocab", "40", "--seq", "8"]
GRID = TINY + ["--listener-iters", "3", "--mle-iters", "4",
               "--joint-iters", "4", "--eval-every", "2",
               "--val-images-use", "4"] + DIM_SET
CONDITIONS = "frozen-greedy,current-greedy,current-gt,current-sample"
# the rank and language keys a greedy or gt point must carry as JAX's does
RANK_KEYS = ("_r1", "_r5", "_r10", "medr", "meanr", "_ar")


@pytest.fixture(scope="module")
def jx():
    """The JAX package's root scripts."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from scripts import (fixed_listener_rank, mode_grid, mode_grid_report,
                         run_joint, showcase_full_scale, time_eval_protocol)
    return dict(flr=fixed_listener_rank, grid=mode_grid,
                report=mode_grid_report, run_joint=run_joint,
                show=showcase_full_scale, tep=time_eval_protocol)


@pytest.fixture
def keep_cwd():
    """The drivers chdir into their workdir: come back after."""
    cwd = os.getcwd()
    yield
    os.chdir(cwd)


@pytest.fixture(scope="module")
def jax_chain(jx, tmp_path_factory):
    """One run-dir chain the JAX package trained at tiny dims (its
    mode_grid, -o gumbel: stage-1 listener, stage-2 speaker, the joint dir
    with its alternatingModel-<it>.pth), with that package's
    fixed_listener_rank points over it."""
    wd = str(tmp_path_factory.mktemp("jax_chain") / "wd")
    cwd = os.getcwd()
    try:
        res = jx["grid"].main(GRID + ["--workdir", wd, "--modes", "gumbel",
                                      "--conditions", CONDITIONS])
    finally:
        os.chdir(cwd)
    return wd, res


def _normalise(value, root):
    """Options values with the run's workdir taken out of its paths."""
    if isinstance(value, str):
        return value.replace(root, "<wd>")
    if isinstance(value, (list, tuple)):
        return type(value)(_normalise(v, root) for v in value)
    return value


def _normalised(recorded, root):
    """(tag, Options as a dict | argv) with the workdir taken out of paths
    and the port's `--device cpu` out of argv."""
    out = []
    for tag, o in recorded:
        if isinstance(o, list):
            argv = [_normalise(a, root) for a in o]
            if "--device" in argv:
                i = argv.index("--device")
                del argv[i:i + 2]
            out.append((tag, argv))
        else:
            out.append((tag, {k: _normalise(v, root)
                              for k, v in vars(o).items()}))
    return out


# ---------------------------------------------------------------------------
# helpers and flag sets
# ---------------------------------------------------------------------------

def test_protocol_dims_and_modes_equal_the_jax_scripts(jx):
    assert tshow.FULL_DIMS == jx["show"].FULL_DIMS
    assert (tshow.VOCAB, tshow.SEQ_LEN) == (jx["show"].VOCAB,
                                            jx["show"].SEQ_LEN)
    for sets in ([], DIM_SET[1::2], ["rnn_size=8", "beam_size=3",
                                     "language_eval=0"]):
        assert tshow.protocol_dims(sets) == jx["show"].protocol_dims(sets)
    assert tgrid.MODES == jx["grid"].MODES
    from cooperativeimagecaptioning_tpu_torch.scripts import run_joint
    for mode, kw in tgrid.MODES.items():
        assert run_joint.joint_flags(batch=4, max_epochs=-1, **kw) == \
            jx["run_joint"].joint_flags(batch=4, max_epochs=-1, **kw), mode


def test_dataset_and_df_pickle_equal_the_jax_scripts(jx, tmp_path,
                                                     monkeypatch):
    dims, _ = tshow.protocol_dims(DIM_SET[1::2])
    got = tshow.build_dataset(24, 40, 8, dims)
    want = jx["show"].build_dataset(24, 40, 8, dims)
    np.testing.assert_array_equal(got._fc, want._fc)
    assert len(got._att) == len(want._att)
    for a, b in zip(got._att, want._att):
        np.testing.assert_array_equal(a, b)
    for k in ("label", "label_start_ix", "label_end_ix", "_K"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert got.info == want.info and got.ix_to_word == want.ix_to_word
    pickles = []
    for side, ds, mod in (("port", got, tshow), ("jax", want, jx["show"])):
        os.makedirs(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        assert mod.write_df_pickle(ds) == "synthtalk"
        with open(os.path.join("data", "synthtalk.p"), "rb") as f:
            pickles.append(f.read())
    assert pickles[0] == pickles[1]


class _Stop(Exception):
    pass


def _record_trainers(monkeypatch, loop_mod, recorded, tag):
    class Recorder:
        def __init__(self, opt, *a, **kw):
            recorded.append((tag, copy.deepcopy(opt)))
            raise _Stop
    monkeypatch.setattr(loop_mod, "Trainer", Recorder)


def _record_stages(monkeypatch, show, grid, harvest, flr, recorded):
    """Replace the stages of showcase / mode_grid by recorders of their
    Options (no training)."""
    def run_stage(tag, opt, ds, iters, deviations=None, **kw):
        recorded.append((f"{tag}@{iters}", copy.deepcopy(opt)))
        out = {"trajectory": [], "iters": iters}
        if deviations is not None:
            out["deviations"] = deviations
        return out

    def baseline(opt, ds, workdir, *a):
        recorded.append(("baseline", copy.deepcopy(opt)))
        return {"rsum": 1.0}
    for mod in (show, grid):
        monkeypatch.setattr(mod, "run_stage", run_stage)
        monkeypatch.setattr(mod, "joint_baseline_eval", baseline)
    monkeypatch.setattr(harvest, "create_dicts_and_json_after_training",
                        lambda opt, **kw: None)

    def flr_main(argv, dataset=None):
        recorded.append(("fixed_listener_rank", argv))
        return {"points": []}
    monkeypatch.setattr(flr, "main", flr_main)


@pytest.mark.parametrize("script", ["showcase_full_scale", "mode_grid",
                                    "fixed_listener_rank",
                                    "time_eval_protocol"])
def test_every_stage_options_equal_the_jax_scripts(jx, tmp_path, monkeypatch,
                                                   keep_cwd, script):
    """The Options each driver builds for each stage (and the arguments
    mode_grid hands fixed_listener_rank) equal the JAX script's, paths
    taken relative to the workdir."""
    from cooperativeimagecaptioning_tpu.evaluation import harvest as jharvest
    from cooperativeimagecaptioning_tpu.training import loop as jloop
    from cooperativeimagecaptioning_tpu_torch.evaluation import (
        harvest as tharvest)
    from cooperativeimagecaptioning_tpu_torch.training import loop as tloop
    out = {}
    for side in ("jax", "port"):
        wd = str(tmp_path / side)
        recorded = []
        if side == "jax":
            mods = (jx["show"], jx["grid"], jharvest, jx["flr"], jloop)
            mains = {"showcase_full_scale": jx["show"].main,
                     "mode_grid": jx["grid"].main,
                     "fixed_listener_rank": jx["flr"].main,
                     "time_eval_protocol": jx["tep"].main}
            extra = []
        else:
            mods = (tshow, tgrid, tharvest, tflr, tloop)
            mains = {"showcase_full_scale": tshow.main,
                     "mode_grid": tgrid.main,
                     "fixed_listener_rank": tflr.main,
                     "time_eval_protocol": ttep.main}
            extra = ["--device", "cpu"]
        main = mains[script]
        argv = GRID + ["--workdir", wd]
        if script == "fixed_listener_rank":
            # a joint dir holding only its infos: the Options are built
            # before anything is loaded
            jd = os.path.join(wd, "joint_gumbel")
            os.makedirs(jd)
            open(os.path.join(jd, "infos_att_d0.3.pkl"), "wb").close()
            argv = TINY + DIM_SET + ["--workdir", wd, "--joint-dir",
                                     "joint_gumbel", "--val-images-use", "4"]
        elif script == "time_eval_protocol":
            argv = TINY + DIM_SET + ["--workdir", wd, "--val-images", "6"]
        _record_trainers(monkeypatch, mods[4], recorded, script)
        if script in ("showcase_full_scale", "mode_grid"):
            _record_stages(monkeypatch, *mods[:4], recorded)
            argv = argv + ["--modes", "gumbel,reinforce"] \
                if script == "mode_grid" else argv
        try:
            main(argv + extra)
        except _Stop:
            pass
        monkeypatch.undo()
        out[side] = _normalised(recorded, wd)
    assert len(out["port"]) >= (1 if "time" in script or "rank" in script
                                else 4)
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# the rank grid, the report
# ---------------------------------------------------------------------------

def test_fixed_listener_rank_equals_the_jax_scripts(jax_chain, tmp_path,
                                                    keep_cwd):
    """The port's grid over a copy of the JAX-trained chain: greedy and gt
    points equal JAX's (rsum, recalls, ranks, CIDEr, BLEU-4 within 1e-6);
    sample points at the same iterations with the same keys (the draws of
    the two packages differ)."""
    src, res = jax_chain
    want = res["modes"]["gumbel"]["rank_points"]
    wd = str(tmp_path / "wd")
    shutil.copytree(src, wd)
    got = tflr.main(TINY + DIM_SET + [
        "--workdir", wd, "--joint-dir", "joint_gumbel", "--optimization",
        "gumbel", "--discriminative", "0.3", "--val-images-use", "4",
        "--conditions", CONDITIONS, "--device", "cpu"])["points"]
    assert [(p["iteration"], p["condition"]) for p in got] == \
        [(p["iteration"], p["condition"]) for p in want]
    assert {p["iteration"] for p in got} == {"seed", 6, 8}
    for g, w in zip(got, want):
        assert set(g) == set(w), (g, w)
        if w["condition"].endswith("sample"):
            continue
        keys = ["rsum", "CIDEr", "Bleu_4"] + [
            k for k in w if any(t in k for t in RANK_KEYS)]
        for k in keys:
            if w[k] is None:
                assert g[k] is None, k
            else:
                assert abs(g[k] - w[k]) <= 1e-6, (w["iteration"],
                                                  w["condition"], k)
    with open(os.path.join(wd, "fixed_listener_rank_joint_gumbel.json")) as f:
        assert json.load(f)["points"] == got


@pytest.mark.parametrize("markdown", [False, True])
def test_mode_grid_report_prints_the_jax_scripts_text(jx, jax_chain, capsys,
                                                      markdown):
    path = os.path.join(jax_chain[0], "mode_grid.json")
    argv = [path] + (["--markdown"] if markdown else [])
    rows = jx["report"].main(argv)
    want = capsys.readouterr().out
    assert treport.main(argv) == rows
    assert capsys.readouterr().out == want
    assert "gumbel" in want


# ---------------------------------------------------------------------------
# end to end, the port alone
# ---------------------------------------------------------------------------

def test_mode_grid_end_to_end_and_extend(tmp_path, keep_cwd):
    """Twice: a second run adding a mode EXTENDS mode_grid.json (reusing
    the pretrain stages and the seeded baseline) instead of clobbering
    completed modes."""
    common = GRID + ["--workdir", str(tmp_path / "wd"), "--device", "cpu",
                     "--conditions", "current-sample"]
    r1 = tgrid.main(common + ["--modes", "gumbel"])
    assert r1["modes"]["gumbel"]["rank_points"]
    assert r1["pretrain"]["stage1_listener"]["deviations"] == {}
    r2 = tgrid.main(common + ["--modes", "reinforce"])
    assert set(r2["modes"]) == {"gumbel", "reinforce"}
    assert r2["baseline"] == r1["baseline"]  # reused, not recomputed
    assert r2["modes"]["gumbel"]["rank_points"]  # prior mode intact
    assert r2["modes"]["reinforce"]["flags"]["retrieval_reward"] == \
        "reinforce"
    for mode in ("gumbel", "reinforce"):
        for pt in r2["modes"][mode]["train"]["trajectory"]:
            assert np.isfinite(pt["loss"]) and pt["rsum"] is not None


def test_showcase_end_to_end(tmp_path, keep_cwd):
    """The three stages + the D=0.3 variant + harvest, then the rank grid
    over the same workdir (the assertions of the JAX package's
    test_showcase_full_scale_tiny_end_to_end)."""
    wd = str(tmp_path / "wd")
    res = tshow.main(GRID + ["--workdir", wd, "--device", "cpu"])
    for st in ("stage1_listener", "stage2_mle", "stage3_joint",
               "stage3_joint_d03"):
        assert res[st]["trajectory"], st
        for pt in res[st]["trajectory"]:
            assert np.isfinite(pt["loss"])
    assert res["joint_baseline"]["rsum"] is not None
    assert res["joint_baseline"]["iteration"] == 4  # stage-2's final iter
    assert res["stage3_joint"]["trajectory"][-1]["iteration"] == 8
    assert res["stage3_joint_d03"]["trajectory"][-1]["iteration"] == 8
    assert res["stage1_listener"]["trajectory"][-1]["iteration"] == 3
    assert res["stage1_listener"]["trajectory"][-1]["rsum"] is not None
    assert res["stage1_listener"]["deviations"] == {}
    assert res["stage1_listener"]["notes"]["vse_hinge_warmup_iters"] >= 1
    with open(os.path.join(wd, "showcase_full_scale.json")) as f:
        out = json.load(f)
    assert out["dims"]["vocab"] == 40
    assert any(f.startswith("alternatingModel") for f in out["harvest"])

    fr = tflr.main(TINY + DIM_SET + [
        "--workdir", wd, "--joint-dir", "joint_g03", "--val-images-use", "4",
        "--conditions", "frozen-greedy,current-sample", "--device", "cpu"])
    assert {p["condition"] for p in fr["points"]} == {
        "frozen-greedy", "current-sample"}
    assert fr["points"][0]["iteration"] == "seed"
    assert all(p["rsum"] is not None for p in fr["points"])


def test_time_eval_protocol_end_to_end(tmp_path, keep_cwd):
    """Both passes, the re-split val layout and the weights label; then the
    quality-canary mode over a saved checkpoint (the assertions of the JAX
    package's test_time_eval_protocol_tiny)."""
    from cooperativeimagecaptioning_tpu_torch.config import Options
    from cooperativeimagecaptioning_tpu_torch.training import checkpoint, joint
    wd = str(tmp_path / "wd")
    argv = ["--images", "40", "--val-images", "12", "--batch", "4",
            "--vocab", "40", "--seq", "8", "--workdir", wd,
            "--device", "cpu"] + DIM_SET
    res = ttep.main(argv)
    assert res["protocol"]["val_images"] == 12
    assert res["protocol"]["beam"] == 2
    assert res["n_predictions"] == 12
    assert res["eval_first_pass_s"] > 0 and res["eval_steady_s"] > 0
    assert res["rsum"] is not None
    assert res["platform"] == "cpu"
    assert "random/untrained" in res["weights"]
    with open(os.path.join(wd, "eval_protocol_timing.json")) as f:
        out = json.load(f)
    # the keys the JAX script writes
    assert set(out) == {"protocol", "weights", "platform", "setup_s",
                        "eval_first_pass_s", "eval_steady_s",
                        "phases_steady", "n_predictions", "CIDEr", "rsum"}
    ck = os.path.join(wd, "ckpt", "model.pth")
    assert not os.path.isfile(ck)  # the timer itself never writes one
    o = Options(caption_model="att2in2", vse_model="fc", rnn_size=24,
                input_encoding_size=16, att_hid_size=12, vse_embed_size=16,
                fc_feat_size=20, att_feat_size=20, max_att_len=5)
    o.vocab_size, o.seq_length = 40, 8
    checkpoint.save_params(joint.init_params(5, o), ck)
    res2 = ttep.main(argv + ["--load-checkpoint", ck])
    assert res2["weights"].endswith("model.pth")
    assert res2["rsum"] is not None


# ---------------------------------------------------------------------------
# the GT rank pass over the device feature cache
# ---------------------------------------------------------------------------

def test_gt_ranks_read_the_feature_cache(keep_cwd, tmp_path):
    """With device_feature_cache the loader hands the evaluator no features;
    the GT-caption rank pass gathers them from the cache (JAX
    eval_split.py:347-349), as the decode paths do, and ranks as without
    the cache."""
    from cooperativeimagecaptioning_tpu_torch.config import Options
    from cooperativeimagecaptioning_tpu_torch.data import SyntheticDataset
    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    os.chdir(tmp_path)
    ranks = []
    for cache in (0, 1):
        opt = Options(caption_model="fc", vse_model="fc", phase=1,
                      vse_loss_weight=1, caption_loss_weight=0, rank_eval=1,
                      language_eval=0, batch_size=4, rnn_size=16,
                      input_encoding_size=12, vse_embed_size=16,
                      fc_feat_size=20, att_feat_size=20, max_att_len=5,
                      val_images_use=-1, device_feature_cache=cache,
                      checkpoint_path=str(tmp_path / f"c{cache}"))
        tr = Trainer(opt, dataset=SyntheticDataset(
            num_images=20, vocab_size=25, seq_length=8, fc_feat_size=20,
            att_feat_size=20, max_K=5), verbose=False, device="cpu")
        ek = {"split": "val", "num_images": -1}
        ranks.append(tr.evaluator().evalrank(tr.params, tr.loader, ek))
        tr.close()
    assert ranks[0] == ranks[1]
    assert "rsum" in ranks[1]
