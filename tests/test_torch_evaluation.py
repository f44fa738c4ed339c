"""Port parity of the evaluation path: the port's `Evaluator.eval_split` and
`eval.eval` (on the CPU, float32, i.e. the plain versions of the kernels)
against the JAX package's, on a speaker-only tree over `SyntheticDataset`,
greedy and beam 2, with the plain, the int8 and the K-major context.

The same captions per image id; `loss_cap` rtol 1e-5; every language metric
within 1e-6 (both sides score with their pure-Python tokenizer and METEOR:
the JAX package's C++ tier is switched off for the comparison).  The
branches the port does not have yet raise NotImplementedError naming their
ROADMAP item.  The sampling modes and the CIDEr-D term of the eval loss
are held to the JAX package given its noise (its fixed key 123)."""

import importlib.util
import os
import pickle

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from cooperativeimagecaptioning_tpu import config as jconfig  # noqa: E402
from cooperativeimagecaptioning_tpu import data as jdata  # noqa: E402
from cooperativeimagecaptioning_tpu.evaluation import eval_split as jeval  # noqa: E402
from cooperativeimagecaptioning_tpu.models import vse as jvse  # noqa: E402
from cooperativeimagecaptioning_tpu.native import bindings  # noqa: E402
from cooperativeimagecaptioning_tpu.rewards import self_critical as jsc  # noqa: E402
from cooperativeimagecaptioning_tpu.training import joint as jjoint  # noqa: E402
from cooperativeimagecaptioning_tpu.training import checkpoint as jckpt  # noqa: E402
from cooperativeimagecaptioning_tpu_torch import config as tconfig  # noqa: E402
from cooperativeimagecaptioning_tpu_torch import data as tdata  # noqa: E402
from cooperativeimagecaptioning_tpu_torch import eval as teval_entry  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.evaluation import eval_split as teval  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.evaluation import language_eval as tlang  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.native import bindings as tbindings  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.ops import draws  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.rewards import self_critical as tsc  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import joint as tjoint  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import checkpoint as tckpt  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.utils.tree import to_torch  # noqa: E402
from test_torch_att_model import jax_params  # noqa: E402
from test_torch_sampling import jax_sample_noise  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 6
LAYOUTS = {"plain": {}, "int8": {"att_quant": "int8"},
           "kmajor": {"att_kmajor": 1}}
DS = dict(num_images=20, vocab_size=25, seq_length=8, fc_feat_size=20,
          att_feat_size=20, max_K=K)


@pytest.fixture(autouse=True)
def _pure_python_metrics(monkeypatch, tmp_path):
    """Both sides score with the pure-Python tokenizer, METEOR and SPICE
    (each package's tier against its counterpart; the C++ tiers are held
    equal in test_torch_native.py), and write their eval_results/ under a
    scratch directory."""
    monkeypatch.setattr(bindings, "available", lambda: False)
    monkeypatch.setattr(tbindings, "available", lambda: False)
    monkeypatch.chdir(tmp_path)


def opt_kwargs(**kw):
    base = dict(caption_model="att2in2", vse_model="None", batch_size=4,
                seq_per_img=1, rnn_size=16, input_encoding_size=12,
                att_hid_size=8, fc_feat_size=20, att_feat_size=20,
                drop_prob_lm=0.0, language_eval=1, rank_eval=1,
                val_images_use=-1, beam_size=1, id="evt", use_att=True,
                caption_loss_weight=1, max_att_len=K, phase=2)
    base.update(kw)
    return base


def build(**kw):
    """((jax opt, loader, params), (port opt, loader, params)) of one numpy
    param tree over equal synthetic datasets."""
    sides = []
    tree = None
    for cfg, data, on_torch in ((jconfig, jdata, False),
                                (tconfig, tdata, True)):
        opt = cfg.Options(**opt_kwargs(**kw))
        loader = data.DataLoader(opt, dataset=data.SyntheticDataset(**DS))
        opt.vocab_size = loader.vocab_size
        opt.seq_length = loader.seq_length
        if tree is None:
            tree = {"speaker": jax_params(opt, seed=5)}
        params = to_torch(tree, "cpu") if on_torch else \
            jax.tree.map(jax.numpy.asarray, tree)
        sides.append((opt, loader, params))
    return sides


def assert_same_result(want, got):
    jlosses, jpreds, jlang = want
    tlosses, tpreds, tlang_ = got
    assert [(p["image_id"], p["caption"]) for p in tpreds] == \
        [(p["image_id"], p["caption"]) for p in jpreds]
    assert set(tlosses) == set(jlosses)
    for k, v in jlosses.items():
        if isinstance(v, dict):  # rank results: empty without a listener
            assert tlosses[k] == v
        else:
            np.testing.assert_allclose(tlosses[k], v, rtol=1e-5, atol=0)
    assert set(tlang_) == set(jlang)
    for k, v in jlang.items():
        assert abs(tlang_[k] - v) <= 1e-6, k


@pytest.mark.parametrize("beam", [1, 2])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_eval_split_matches_jax(layout, beam):
    (jopt, jloader, jparams), (topt, tloader, tparams) = build(
        **LAYOUTS[layout])
    ek = {"split": "val", "num_images": -1, "beam_size": beam}
    want = jeval.Evaluator(jopt).eval_split(jparams, jloader, ek)
    ev = teval.Evaluator(topt, device="cpu")
    got = ev.eval_split(tparams, tloader, ek)
    assert_same_result(want, got)
    losses, preds, lang = got
    val = [tloader.ds.info["images"][ix]["id"]
           for ix in tloader.split_ix["val"]]
    assert sorted(p["image_id"] for p in preds) == sorted(val)
    assert np.isfinite(losses["loss_cap"]) and "CIDEr" in lang
    assert len({p["caption"] for p in preds}) > 1
    assert set(ev.last_timings) == {"loop_dispatch_s", "decode_drain_s",
                                    "lang_eval_s", "rank_eval_s"}
    assert os.path.isfile(os.path.join("eval_results", "evt_val.json"))


@pytest.mark.parametrize("sample_max,temperature", [(0, 1.0), (0, 0.7),
                                                    (2, 1.0)])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_eval_sampling_modes_match_jax(layout, sample_max, temperature):
    """sample_max 0 (multinomial at `temperature`) and 2 (Gumbel-noise
    max): the port's decode fed the noise the JAX evaluator draws from its
    fixed key 123 on every batch, through each layout's attention."""
    (jopt, jloader, jparams), (topt, tloader, tparams) = build(
        language_eval=0, rank_eval=0, **LAYOUTS[layout])
    ek = {"split": "val", "num_images": -1, "sample_max": sample_max,
          "temperature": temperature}
    want = jeval.Evaluator(jopt).eval_split(jparams, jloader, ek)
    mode = "sample" if sample_max == 0 else "gumbel_noise_max"
    noise = jax_sample_noise(jax.random.PRNGKey(teval.EVAL_SEED), mode,
                             topt.batch_size, topt.vocab_size + 1,
                             topt.seq_length)
    ev = teval.Evaluator(topt, device="cpu")
    ev.decode_draws = lambda: draws.Replay(noise)
    got = ev.eval_split(tparams, tloader, ek)
    assert_same_result(want, got)
    assert len({p["caption"] for p in got[1]}) > 1
    # and by default the draws come from a generator seeded with 123 on
    # each batch: the same again, run after run
    a = teval.Evaluator(topt, device="cpu").eval_split(tparams, tloader, ek)
    b = teval.Evaluator(topt, device="cpu").eval_split(tparams, tloader, ek)
    assert a[1] == b[1]


def test_eval_cider_loss_matches_jax(monkeypatch):
    """cider_optimization in the eval loss: stage A and the host reward,
    then the CIDEr term on the same trajectory; the port's streams replay
    what the JAX evaluator draws from key 123 (joint.py:123-127)."""
    (jopt, jloader, jparams), (topt, tloader, tparams) = build(
        language_eval=0, rank_eval=0, cider_optimization=1)
    for m in (jsc, tsc):
        m.reset_scorer()
        m.init_scorer("corpus")
    ek = {"split": "val", "num_images": -1}
    want = jeval.Evaluator(jopt).eval_split(jparams, jloader, ek)
    B = tloader.batch_size * tloader.seq_per_img
    r = jjoint._rngs(jax.random.PRNGKey(teval.EVAL_SEED))
    noise = jax_sample_noise(r["cider"], "sample", B, topt.vocab_size + 1,
                             topt.seq_length)

    def replayed(seed, device):
        assert seed == teval.EVAL_SEED
        out = {name: draws.Replay([]) for name in tjoint.STREAMS}
        out["cider"] = draws.Replay(noise)
        return out

    monkeypatch.setattr(tjoint, "streams", replayed)
    got = teval.Evaluator(topt, device="cpu").eval_split(tparams, tloader,
                                                         ek)
    for m in (jsc, tsc):
        m.reset_scorer()
    assert "loss_cider" in got[0] and got[0]["loss_cider"] != 0.0
    assert_same_result(want, got)


def with_listener(sides, seed=6):
    """Both sides of `build` with a JAX-initialised listener added."""
    (jopt, jloader, jparams), (topt, tloader, tparams) = sides
    listener = jax.tree.map(np.asarray, jvse.init_params(
        jax.random.PRNGKey(seed), jopt))
    listener["img_enc"]["fc"]["w"] = listener["img_enc"]["fc"]["w"] * 4.0
    jparams = dict(jparams, listener=jax.tree.map(jax.numpy.asarray,
                                                  listener))
    tparams = dict(tparams, listener=to_torch(listener, "cpu"))
    return (jopt, jloader, jparams), (topt, tloader, tparams)


REINFORCE_EVAL = dict(vse_model="fc", vse_embed_size=8,
                      retrieval_reward="reinforce",
                      retrieval_reward_weight=0.5)


def reinforce_eval_streams(opt, B):
    """The port's streams of the evaluator replaying what the JAX evaluator
    draws from its fixed key 123: the 'disc' sample (no dropout in eval, and
    greedy draws nothing)."""
    r = jjoint._rngs(jax.random.PRNGKey(teval.EVAL_SEED))
    noise = jax_sample_noise(r["disc"], "sample", B, opt.vocab_size + 1,
                             opt.seq_length)

    def replayed(seed, device):
        assert seed == teval.EVAL_SEED
        out = {name: draws.Replay([]) for name in tjoint.STREAMS}
        out["disc"] = draws.Replay(noise)
        return out
    return replayed


def assert_reinforce_eval_matches_jax(monkeypatch, baseline):
    """The eval loss of a reinforce run (JAX eval_split.py:104-115): the
    REINFORCE branch in eval mode, its greedy baseline without autograd;
    the loss sums of every val batch against the JAX Evaluator's."""
    (jopt, jloader, jparams), (topt, tloader, tparams) = with_listener(build(
        language_eval=0, rank_eval=0, reinforce_baseline_type=baseline,
        **REINFORCE_EVAL))
    ek = {"split": "val", "num_images": -1}
    want = jeval.Evaluator(jopt).eval_split(jparams, jloader, ek)
    monkeypatch.setattr(tjoint, "streams", reinforce_eval_streams(
        topt, tloader.batch_size * tloader.seq_per_img))
    got = teval.Evaluator(topt, device="cpu").eval_split(tparams, tloader,
                                                         ek)
    assert {"retrieval_sc_loss", "retrieval_loss",
            "retrieval_loss_greedy"} <= set(got[0])
    assert got[0]["retrieval_loss"] != 0.0
    assert_same_result(want, got)


@pytest.mark.parametrize("in_flight", [1, 2, 100])
def test_in_flight_bound_changes_nothing(monkeypatch, in_flight):
    """Draining early (at most `MAX_IN_FLIGHT` undrained batches) gives the
    predictions of draining everything after the loop, in the same order."""
    ek = {"split": "test", "num_images": -1}
    # a fresh loader for each run: which caption of an image the loss sees is
    # a draw from the loader's own generator
    _, (topt, tloader, tparams) = build(language_eval=0, rank_eval=0)
    monkeypatch.setattr(teval, "MAX_IN_FLIGHT", 10 ** 6)
    want = teval.Evaluator(topt, device="cpu").eval_split(tparams, tloader,
                                                          ek)
    _, (topt, tloader, tparams) = build(language_eval=0, rank_eval=0)
    monkeypatch.setattr(teval, "MAX_IN_FLIGHT", in_flight)
    ev = teval.Evaluator(topt, device="cpu")
    got = ev.eval_split(tparams, tloader, ek)
    assert got[1] == want[1] and got[0] == want[0]
    assert len(got[1]) == len(tloader.split_ix["test"])
    batches = -(-len(got[1]) // tloader.batch_size)
    assert ev.drained_in_loop == max(0, batches - in_flight)


def test_num_images_cuts_the_split():
    (jopt, jloader, jparams), (topt, tloader, tparams) = build(
        language_eval=0, rank_eval=0, batch_size=3)
    ek = {"split": "val", "num_images": 2}
    want = jeval.Evaluator(jopt).eval_split(jparams, jloader, ek)
    got = teval.Evaluator(topt, device="cpu").eval_split(tparams, tloader,
                                                         ek)
    assert len(got[1]) == 2
    assert_same_result(want, got)


def test_bf16_decode_runs():
    _, (topt, tloader, tparams) = build(language_eval=0, rank_eval=0,
                                        compute_dtype="bfloat16")
    losses, preds, _ = teval.Evaluator(topt, device="cpu").eval_split(
        tparams, tloader, {"split": "val", "beam_size": 2})
    assert len(preds) == len(tloader.split_ix["val"])
    assert np.isfinite(losses["loss_cap"])


def _root_eval():
    spec = importlib.util.spec_from_file_location(
        "root_eval", os.path.join(REPO, "eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_eval_entry_matches_jax(tmp_path, layout):
    """A run dir written by the JAX package, through both `eval.eval`: the
    final-eval protocol (beam 2, the test split)."""
    (jopt, jloader, jparams), _ = build(**LAYOUTS[layout])
    model = str(tmp_path / "model-best.pth")
    infos = str(tmp_path / "infos_evt.pkl")
    jckpt.save_params(jparams, model)
    with open(infos, "wb") as f:
        pickle.dump({"opt": jopt, "vocab": jloader.get_vocab()}, f)
    want = _root_eval().eval(None, model, infos, split="test",
                             dataset=jdata.SyntheticDataset(**DS))
    got = teval_entry.eval(None, model, infos, split="test",
                           dataset=tdata.SyntheticDataset(**DS),
                           device="cpu")
    assert_same_result(
        (want["loss"], want["split_predictions"], want["lang_stats"]),
        (got["loss"], got["split_predictions"], got["lang_stats"]))
    assert got["loss"].get("gt_ranks") == {} == want["loss"].get("gt_ranks")
    assert len(got["split_predictions"]) == len(jloader.split_ix["test"])


def test_evalrank_without_a_listener_is_empty():
    _, (topt, tloader, tparams) = build()
    ev = teval.Evaluator(topt, device="cpu")
    assert ev.evalrank(tparams, tloader, {"split": "val"}) == {}


# the eval loss of the device reward tiers (each raised here until the tiers
# were ported)
DEVICE_TIER_LOSS = {
    "device_reward_loss": dict(cider_optimization=1, on_device_cider=1),
    "soft_cider_loss": dict(cider_optimization=1, soft_cider=1),
}
# an evaluation a mesh refused until it was ported (phase-2 speakers ran)
UNPORTED_ON_A_MESH = dict(cider_optimization=1)


def assert_mesh_cider_eval_matches_jax():
    """The CIDEr-D eval loss (stage A and the host reward over the data
    group's gathered ids, then the CIDEr term) on a (2, 1) mesh, each rank
    replaying its rows of what the JAX evaluator draws from key 123:
    captions, losses and the language stats equal the JAX Evaluator's."""
    from cooperativeimagecaptioning_tpu_torch.parallel import launch
    from cooperativeimagecaptioning_tpu_torch.utils.tree import to_numpy
    import torch_mesh_ranks as ranks
    (jopt, jloader, jparams), (topt, tloader, tparams) = build(
        language_eval=0, rank_eval=0, **UNPORTED_ON_A_MESH)
    for m in (jsc, tsc):
        m.reset_scorer()
        m.init_scorer("corpus")
    ek = {"split": "val", "num_images": -1}
    want = jeval.Evaluator(jopt).eval_split(jparams, jloader, ek)
    for m in (jsc, tsc):
        m.reset_scorer()
    B = tloader.batch_size * tloader.seq_per_img
    r = jjoint._rngs(jax.random.PRNGKey(teval.EVAL_SEED))
    noise = jax_sample_noise(r["cider"], "sample", B, topt.vocab_size + 1,
                             topt.seq_length)
    got = launch.spawn(ranks.eval_replayed_rank, (
        (2, 1), topt, to_numpy(tparams), ek, {"cider": noise},
        tdata.SyntheticDataset(**DS)), 2, "cpu")
    assert "loss_cider" in want[0] and want[0]["loss_cider"] != 0.0
    for g in got:
        assert_same_result(want, g)


@pytest.mark.parametrize("what,match", [
    ("feat_cache", "joint training"),
    ("mesh", "multi-device"), ("reinforce_loss", "joint training"),
    ("device_reward_loss", "device rewards"), ("coco_spice", "spice"),
    ("soft_cider_loss", "device rewards"), ("spice", "spice")])
def test_unported_branches_name_their_roadmap_item(tmp_path, monkeypatch,
                                                   what, match):
    """What the evaluator does not run yet raises, naming its ROADMAP item.
    The eval loss of a reinforce run, the device feature cache, the eval
    loss of the device reward tiers, the CIDEr-D eval loss on a mesh and
    SPICE (CocoEvalCap and language_eval with include_spice) raised here
    until they were ported (their ids keep the items they matched); they
    now run and equal the JAX package's."""
    if what == "reinforce_loss":
        assert_reinforce_eval_matches_jax(monkeypatch, "greedy")
        return
    if what == "feat_cache":
        assert_cached_eval_matches_jax()
        return
    if what in DEVICE_TIER_LOSS:
        assert_tier_eval_matches_jax(monkeypatch, DEVICE_TIER_LOSS[what])
        return
    if what == "mesh":
        assert_mesh_cider_eval_matches_jax()
        return
    assert_spice_eval_matches_jax(what, tmp_path)


def assert_spice_eval_matches_jax(what, tmp_path):
    """include_spice=True: CocoEvalCap's corpus and per-image scores
    ('coco_spice'), or language_eval over each loader's ground truth
    ('spice'), equal the JAX package's."""
    from cooperativeimagecaptioning_tpu.evaluation import coco_eval as jcoco
    from cooperativeimagecaptioning_tpu.evaluation import (
        language_eval as jlang)
    from cooperativeimagecaptioning_tpu_torch.evaluation import (
        coco_eval as tcoco)
    (_, jloader, _), (_, tloader, _) = build(language_eval=0, rank_eval=0)
    words = [w for _, w in sorted(tloader.ix_to_word.items(),
                                  key=lambda kv: int(kv[0]))]
    rng = np.random.RandomState(3)
    ids = [tloader.ds.info["images"][ix]["id"]
           for ix in tloader.split_ix["val"]]
    preds = [{"image_id": i, "caption": " ".join(
        rng.choice(words + ["a", "on", "in"], rng.randint(2, 7)))}
        for i in ids]
    if what == "coco_spice":
        out = []
        for mod, loader in ((jlang, jloader), (tlang, tloader)):
            coco = mod.annotations_from_loader(loader)
            cmod = jcoco if mod is jlang else tcoco
            ev = cmod.CocoEvalCap(coco, coco.load_res(preds),
                                  include_spice=True)
            out.append((ev.evaluate(), ev.img_to_eval))
        (want, want_img), (got, got_img) = out
        assert "SPICE" in got and set(got) == set(want)
        assert got_img == want_img
    else:
        want = jlang.language_eval("coco", [dict(p) for p in preds], "x",
                                   "val", loader=jloader,
                                   out_dir=str(tmp_path / "jax"),
                                   include_spice=True)
        got = tlang.language_eval("coco", [dict(p) for p in preds], "x",
                                  "val", loader=tloader,
                                  out_dir=str(tmp_path / "port"),
                                  include_spice=True)
        assert {"SPICE", "SPICE_Object", "SPICE_Relation"} <= set(got)
        assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k


def feature_cache(loader, K=K):
    """{'fc', 'att', 'att_mask'} numpy arrays of every image, att with the
    loader's transforms and padded to K slots (the Trainer's device feature
    cache, built by hand)."""
    ds = loader.ds
    n = ds.num_images()
    att = np.zeros((n, K, DS["att_feat_size"]), np.float32)
    mask = np.zeros((n, K), np.float32)
    for i in range(n):
        a = loader.get_transformed_att(i)
        att[i, :len(a)] = a
        mask[i, :len(a)] = 1.0
    fc = np.stack([ds.get_fc(i) for i in range(n)]).astype(np.float32)
    return {"fc": fc, "att": att, "att_mask": mask}


def assert_cached_eval_matches_jax():
    """Evaluator.eval_split with a feature cache (the features gathered by
    image index, the loss's rows repeated per caption) against the JAX
    Evaluator with the same cache; the captions also equal the streamed
    evaluation's."""
    (jopt, jloader, jparams), (topt, tloader, tparams) = build(
        language_eval=1, rank_eval=0, seq_per_img=2)
    cache = feature_cache(tloader)
    ek = {"split": "val", "num_images": -1, "beam_size": 2}
    want = jeval.Evaluator(jopt, feat_cache={
        k: jax.numpy.asarray(v) for k, v in cache.items()}).eval_split(
        jparams, jloader, ek)
    tloader.set_feature_free("val")
    got = teval.Evaluator(topt, device="cpu", feat_cache={
        k: torch.from_numpy(v) for k, v in cache.items()}).eval_split(
        tparams, tloader, ek)
    assert_same_result(want, got)
    tloader.set_feature_free("val", False)
    streamed = teval.Evaluator(topt, device="cpu").eval_split(
        tparams, tloader, ek)
    assert got[1] == streamed[1]


def assert_tier_eval_matches_jax(monkeypatch, kw):
    """The eval loss of an on_device_cider or soft_cider run against the
    JAX Evaluator's: the eval batches carry no refs, so the CIDEr term
    takes a zero reward where no host stage runs (JAX
    eval_split.py:211-214); soft_cider without a listener keeps the host
    reward, on the noise of key 123 replayed."""
    (jopt, jloader, jparams), (topt, tloader, tparams) = build(
        language_eval=0, rank_eval=0, **kw)
    for m in (jsc, tsc):
        m.reset_scorer()
        m.init_scorer("corpus")
    ek = {"split": "val", "num_images": -1}
    want = jeval.Evaluator(jopt).eval_split(jparams, jloader, ek)
    B = tloader.batch_size * tloader.seq_per_img
    r = jjoint._rngs(jax.random.PRNGKey(teval.EVAL_SEED))
    noise = jax_sample_noise(r["cider"], "sample", B, topt.vocab_size + 1,
                             topt.seq_length)

    def replayed(seed, device, gens=None):
        out = {name: draws.Replay([]) for name in tjoint.STREAMS}
        out["cider"] = draws.Replay(noise)
        return out

    monkeypatch.setattr(tjoint, "streams", replayed)
    got = teval.Evaluator(topt, device="cpu").eval_split(tparams, tloader,
                                                         ek)
    for m in (jsc, tsc):
        m.reset_scorer()
    assert "loss_cider" in got[0]
    assert (got[0]["loss_cider"] == 0.0) == \
        (not tjoint.needs_reward(topt, "optimizer"))
    assert_same_result(want, got)


def test_cuda_evaluator_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present here")
    _, (topt, _, _) = build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teval.Evaluator(topt)  # device defaults to cuda


def test_load_params_into_merges_leniently(tmp_path, capsys):
    """Shared leaves are copied onto the target's leaves, a missing leaf
    keeps its value, an extra leaf is reported, another shape is copied
    flat -- as the JAX package's load_params_into does."""
    path = str(tmp_path / "m.pth")
    saved = {"speaker": {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
                         "b": np.ones(4, np.float32),
                         "extra": np.zeros(1, np.float32)}}
    with open(path, "wb") as f:
        pickle.dump(saved, f)
    cur = {"speaker": {"a": np.zeros((2, 3), np.float32),
                       "b": np.zeros(6, np.float32),
                       "c": np.full(2, 7.0, np.float32)}}
    want = jckpt.load_params_into(
        jax.tree.map(jax.numpy.asarray, cur), path)
    got = tckpt.load_params_into(to_torch(cur, "cpu"), path)
    out = capsys.readouterr().out
    assert "speaker.c not in loaded checkpoint" in out
    assert "speaker.extra in checkpoint not in model" in out
    assert "size mismatch" in out
    for k in ("a", "b", "c"):
        np.testing.assert_array_equal(np.asarray(want["speaker"][k]),
                                      got["speaker"][k].numpy())
    with pytest.raises(KeyError):
        tckpt.load_params_into(to_torch(cur, "cpu"), path, strict=True)
