"""Port parity: retrieval evaluation -- the rank core, the protocol's
metrics, caption retrieval and the listener half of the evaluator -- of the
PyTorch port against the JAX package, on the CPU in float32.

The numpy core (`target_ranks`, `top_retrieved`, `recall_stats`) is the
port's own copy: it must give the JAX package's ranks exactly, on score
matrices with planted ties (equal scores rank toward the larger column).
The port's `scores_ranks_hits` (torch, chunked) against the JAX one on
embeddings whose products are exact in float32 (dyadic entries: every tie
is a true tie in both) and on random ones: ranks and hits exactly equal,
and so every metric of `rank_metrics` (with `fold5`), `i2t`, `t2i`,
`gen2gt`, `gt2gen`, `split_halves` and `evalrankcap`.  The evaluator's
`encode_data` (GT and generated captions) gives the JAX embeddings within
1e-5, and `evalrank`, `eval_split` and `eval.eval(listener="gt")` the JAX
package's rank metrics, captions and losses."""

import os
import pickle

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cooperativeimagecaptioning_tpu import data as jdata  # noqa: E402
from cooperativeimagecaptioning_tpu.evaluation import caption_retrieval as jcap  # noqa: E402
from cooperativeimagecaptioning_tpu.evaluation import eval_split as jeval  # noqa: E402
from cooperativeimagecaptioning_tpu.evaluation import retrieval as jret  # noqa: E402
from cooperativeimagecaptioning_tpu.rewards import self_critical as jsc  # noqa: E402
from cooperativeimagecaptioning_tpu.training import checkpoint as jckpt  # noqa: E402
from cooperativeimagecaptioning_tpu.training import joint as jjoint  # noqa: E402
from cooperativeimagecaptioning_tpu_torch import data as tdata  # noqa: E402
from cooperativeimagecaptioning_tpu_torch import eval as teval_entry  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.evaluation import caption_retrieval as tcap  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.evaluation import eval_split as teval  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.evaluation import retrieval as tret  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.utils.tree import to_torch  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.ops import draws  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.rewards import self_critical as tsc  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import joint as tjoint  # noqa: E402
from test_torch_att_model import jax_params  # noqa: E402
from test_torch_evaluation import (  # noqa: E402
    DS, _pure_python_metrics, _root_eval, assert_same_result, opt_kwargs)
from test_torch_sampling import jax_sample_noise  # noqa: E402

assert _pure_python_metrics  # the autouse fixture, imported to apply here
EMB_TOL = dict(atol=1e-5, rtol=1e-5)


def tied_scores(Q=9, M=13, seed=0):
    """Scores on a grid of a few values: many exact ties in every row."""
    rng = np.random.RandomState(seed)
    return rng.randint(-3, 4, (Q, M)).astype(np.float32) / 4


def dyadic(n, E=8, seed=0, dup=()):
    """Embeddings of multiples of 1/4 in [-1, 1]: their products sum
    exactly in float32, so a tie is a tie in both packages.  `dup` copies
    row a onto row b for each (a, b)."""
    x = np.random.RandomState(seed).randint(-4, 5, (n, E)).astype(
        np.float32) / 4
    for a, b in dup:
        x[b] = x[a]
    return x


def normal(n, E=8, seed=0):
    x = np.random.RandomState(seed).randn(n, E).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


# ---------------------------------------------------------------------------
# the rank core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_numpy_core_matches_jax_on_planted_ties(seed):
    s = tied_scores(seed=seed)
    targets = np.random.RandomState(seed + 10).randint(0, 13, (9, 3))
    np.testing.assert_array_equal(jret.target_ranks(s, targets),
                                  tret.target_ranks(s, targets))
    for k in (1, 4, 20):
        np.testing.assert_array_equal(jret.top_retrieved(s, k),
                                      tret.top_retrieved(s, k))
    ranks = tret.target_ranks(s, targets)[:, 0]
    assert tret.recall_stats(ranks) == jret.recall_stats(ranks)


def test_the_tie_rule_ranks_the_larger_column_first():
    s = np.array([[1.0, 2.0, 2.0, 0.5, 2.0]], np.float32)
    np.testing.assert_array_equal(tret.target_ranks(s, [[1, 2, 4, 3]]),
                                  [[2, 1, 0, 4]])
    np.testing.assert_array_equal(tret.top_retrieved(s, 4), [[4, 2, 1, 0]])


@pytest.mark.parametrize("chunk", [4, 512])
@pytest.mark.parametrize("embed", ["dyadic", "normal"])
def test_scores_ranks_hits_matches_jax(embed, chunk):
    """Ranks [Q, T] and top-k hits, torch against the JAX device core,
    chunked (chunk 4 splits the queries) or not."""
    make = dyadic if embed == "dyadic" else normal
    q = make(11, seed=1) if embed == "normal" else make(
        11, seed=1, dup=((0, 5), (2, 7)))
    pool = make(17, seed=2) if embed == "normal" else make(
        17, seed=2, dup=((1, 9), (1, 12), (4, 16)))
    targets = np.random.RandomState(3).randint(0, 17, (11, 5))
    for topk in (1, 4):
        want = jret.scores_ranks_hits(q, pool, targets, topk, chunk=chunk)
        got = tret.scores_ranks_hits(torch.from_numpy(q), pool, targets,
                                     topk, chunk=chunk)
        for a, b in zip(want, got):
            assert b.dtype == np.int64
            np.testing.assert_array_equal(a, b)
    # and the numpy core on the float32 score matrix
    s = q @ pool.T
    np.testing.assert_array_equal(got[0], tret.target_ranks(s, targets))
    np.testing.assert_array_equal(got[1], tret.top_retrieved(s, 4))


def test_scores_ranks_hits_keeps_the_matmul_setting():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        tret.scores_ranks_hits(normal(3), normal(4, seed=1), [[0], [1], [2]],
                               1)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)


def assert_metrics_equal(want, got):
    assert set(want) == set(got)
    for k, v in want.items():
        if isinstance(v, dict):
            assert got[k] == v, k
        else:
            assert float(got[k]) == float(v), k


@pytest.mark.parametrize("gen", [False, True], ids=["gt", "generated"])
def test_rank_metrics_match_jax(gen):
    cpi = 1 if gen else 5
    n = 12
    img = np.repeat(dyadic(n, seed=4, dup=((0, 3),)), cpi, axis=0)
    cap = dyadic(n * cpi, seed=5, dup=((1, 8), (2, 9)))
    infos = [{"id": 100 + i, "file_path": f"im{i}.jpg"} for i in range(n)]
    want = jret.rank_metrics(img, cap, infos, use_gen_sent=gen,
                             caps_per_image=cpi)
    got = tret.rank_metrics(torch.from_numpy(img), torch.from_numpy(cap),
                            infos, use_gen_sent=gen, caps_per_image=cpi)
    assert_metrics_equal(want, got)
    assert got["images_ranking" if gen else "gt_images_ranking"]


def test_rank_metrics_fold5_match_jax():
    """Five folds of 1000 images, two captions an image."""
    cpi = 2
    img = np.repeat(normal(5000, seed=6), cpi, axis=0)
    cap = normal(5000 * cpi, seed=7)
    want = jret.rank_metrics(img, cap, fold5=True, caps_per_image=cpi)
    got = tret.rank_metrics(torch.from_numpy(img), torch.from_numpy(cap),
                            fold5=True, caps_per_image=cpi)
    assert_metrics_equal(want, got)


# ---------------------------------------------------------------------------
# caption retrieval
# ---------------------------------------------------------------------------

def test_gen2gt_and_gt2gen_match_jax():
    cpi, n = 5, 10
    gen = dyadic(n, seed=8, dup=((0, 4),))
    gt = dyadic(n * cpi, seed=9, dup=((3, 20), (3, 31)))
    for fn in ("gen2gt", "gt2gen"):
        want_stats, want_ranks = getattr(jcap, fn)(gen, gt, cpi,
                                                   return_ranks=True)
        got_stats, got_ranks = getattr(tcap, fn)(torch.from_numpy(gen),
                                                 torch.from_numpy(gt), cpi,
                                                 return_ranks=True)
        assert got_stats == want_stats
        for a, b in zip(want_ranks, got_ranks):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shared", [False, True])
def test_split_halves_matches_jax(shared):
    rng = np.random.RandomState(10)
    seqs = rng.randint(1, 20, (6, 9))
    lens = np.array([3, 9, 5, 4, 7, 6])
    masks = (np.arange(9)[None, :] < lens[:, None]).astype(np.float32)
    other = np.array([2, 8, 6]) if shared else None
    shared_lens = np.concatenate([lens, other]) if shared else None
    want = jcap.split_halves(seqs, masks, lens, shared_lens)
    got = tcap.split_halves(seqs, masks, lens, shared_lens)
    for (ws, wm), (gs, gm) in zip(want, got):
        np.testing.assert_array_equal(ws, gs)
        np.testing.assert_array_equal(wm, gm)


# ---------------------------------------------------------------------------
# the listener half of the evaluator
# ---------------------------------------------------------------------------

def listener_tree(opt, seed=3):
    """A joint numpy tree (the JAX init_params): the speaker of
    test_torch_att_model's `jax_params` (weights scaled so that random
    decodes differ from image to image) or the JAX FC speaker, and the JAX
    listener."""
    p = jax.tree.map(np.asarray, jjoint.init_params(
        jax.random.PRNGKey(seed), opt))
    if opt.caption_model == "att2in2":
        p["speaker"] = jax_params(opt, seed=5)
    return p


def build_joint(**kw):
    """((jax opt, loader, params), (port opt, loader, params)) of one joint
    tree over equal synthetic datasets."""
    from cooperativeimagecaptioning_tpu import config as jconfig
    from cooperativeimagecaptioning_tpu_torch import config as tconfig
    base = opt_kwargs(vse_model="fc", vse_embed_size=16, language_eval=0,
                      rank_eval=1, batch_size=3, **kw)
    sides, tree = [], None
    for cfg, data, on_torch in ((jconfig, jdata, False),
                                (tconfig, tdata, True)):
        opt = cfg.Options(**base)
        loader = data.DataLoader(opt, dataset=data.SyntheticDataset(**DS))
        opt.vocab_size, opt.seq_length = loader.vocab_size, loader.seq_length
        if tree is None:
            tree = listener_tree(opt)
        sides.append((opt, loader, to_torch(tree, "cpu") if on_torch else
                      jax.tree.map(jnp.asarray, tree)))
    return sides


@pytest.mark.parametrize("gen", [False, True], ids=["gt", "generated"])
def test_encode_data_matches_jax(gen):
    (jopt, jloader, jp), (topt, tloader, tp) = build_joint()
    want = jeval.Evaluator(jopt).encode_data(jp, jloader, {"split": "val"},
                                             use_gen_sent=gen)
    got = teval.Evaluator(topt, device="cpu").encode_data(
        tp, tloader, {"split": "val"}, use_gen_sent=gen)
    assert got[2] == want[2]
    n = len(tloader.split_ix["val"])
    assert got[0].shape[0] == n * (1 if gen else DS.get(
        "caps_per_image", 5))
    for a, b in zip(want[:2], got[:2]):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), **EMB_TOL)
    assert tloader.seq_per_img == topt.seq_per_img  # restored


@pytest.mark.parametrize("gen", [False, True], ids=["gt", "generated"])
def test_evalrank_matches_jax(gen):
    (jopt, jloader, jp), (topt, tloader, tp) = build_joint()
    ek = {"split": "test", "num_images": 5}
    want = jeval.Evaluator(jopt).evalrank(jp, jloader, ek, gen)
    got = teval.Evaluator(topt, device="cpu").evalrank(tp, tloader, ek, gen)
    assert_metrics_equal(want, got)
    assert got["t2i_r10"] == 100.0  # five images: every rank is < 10


@pytest.mark.parametrize("case", ["phase1", "disc", "disc_cider"])
def test_eval_split_with_a_listener_matches_jax(monkeypatch, case):
    """Phase 1 ranks both val and test on the GT captions; phase 3 ranks
    the generated captions with the GT ranks beside them; the eval loss
    carries the listener's contrastive and DISC terms, and the CIDEr-D
    term on DISC's sample (the host reward of `_reward_for` reusing it),
    the port's streams replaying what the JAX evaluator draws from key
    123."""
    phase = 1 if case == "phase1" else 3
    kw = dict(phase=phase, vse_loss_weight=1, caption_loss_weight=0)
    if phase == 1:
        kw.update(caption_model="fc", use_att=False)
    else:
        kw.update(retrieval_reward="gumbel", retrieval_reward_weight=0.5,
                  cider_optimization=float(case == "disc_cider"))
    (jopt, jloader, jp), (topt, tloader, tp) = build_joint(**kw)
    for m in (jsc, tsc):
        m.reset_scorer()
        m.init_scorer("corpus")
    gen = phase == 3
    want = jeval.Evaluator(jopt).eval_split(jp, jloader, {"split": "val"},
                                            use_gen_sent=gen)
    r = jjoint._rngs(jax.random.PRNGKey(teval.EVAL_SEED))
    noise = jax_sample_noise(r["disc"], "gumbel_st",
                             tloader.batch_size * tloader.seq_per_img,
                             topt.vocab_size + 1, topt.seq_length)

    def replayed(seed, device):
        out = {name: draws.Replay([]) for name in tjoint.STREAMS}
        out["disc"] = draws.Replay(noise)
        return out

    monkeypatch.setattr(tjoint, "streams", replayed)
    got = teval.Evaluator(topt, device="cpu").eval_split(
        tp, tloader, {"split": "val"}, use_gen_sent=gen)
    for m in (jsc, tsc):
        m.reset_scorer()
    if phase == 1:
        assert set(got[0]["val"]) == set(want[0]["val"]) and "test" in got[0]
    else:
        assert "gt_ranks" in got[0] and "retrieval_loss" in got[0]
        assert ("loss_cider" in got[0]) == (case == "disc_cider")
    assert_same_result(want, got)


def test_evalrankcap_matches_jax():
    (jopt, jloader, jp), (topt, tloader, tp) = build_joint()
    ek = {"split": "val"}
    for divide in (0, 1):
        want = jcap.evalrankcap(jeval.Evaluator(jopt), jp, jloader, ek,
                                divide)
        got = tcap.evalrankcap(teval.Evaluator(topt, device="cpu"), tp,
                               tloader, ek, divide)
        assert got == want


@pytest.mark.parametrize("has_listener", [True, False])
def test_eval_entry_with_a_gt_listener_matches_jax(tmp_path, capsys,
                                                    has_listener):
    """eval.eval(listener="gt") swaps in the initialize_retrieval listener
    (or warns and keeps the trained one when that file has none)."""
    (jopt, jloader, jp), _ = build_joint(beam_size=2)
    tree = jax.tree.map(np.asarray, jp)
    gt_tree = listener_tree(jopt, seed=11)
    gt_path = str(tmp_path / "listener.pth")
    jckpt.save_params(gt_tree if has_listener else
                      {"speaker": gt_tree["speaker"]}, gt_path)
    jopt.initialize_retrieval = gt_path
    model = str(tmp_path / "model-best.pth")
    infos = str(tmp_path / "infos_evt.pkl")
    jckpt.save_params(tree, model)
    with open(infos, "wb") as f:
        pickle.dump({"opt": jopt, "vocab": jloader.get_vocab()}, f)
    want = _root_eval().eval(None, model, infos, split="test",
                             listener="gt",
                             dataset=jdata.SyntheticDataset(**DS))
    got = teval_entry.eval(None, model, infos, split="test", listener="gt",
                           dataset=tdata.SyntheticDataset(**DS),
                           device="cpu")
    out = capsys.readouterr().out
    assert ("gt listener is loaded" in out) == has_listener
    assert ("has no 'listener' subtree" in out) != has_listener
    assert_same_result(
        (want["loss"], want["split_predictions"], want["lang_stats"]),
        (got["loss"], got["split_predictions"], got["lang_stats"]))
    assert "gt_ranks" in got["loss"] and "t2i_r1" in got["loss"]
    # the swapped-in listener ranks otherwise than the trained one
    trained = teval_entry.eval(None, model, infos, split="test",
                               dataset=tdata.SyntheticDataset(**DS),
                               device="cpu")
    assert (trained["loss"]["images_ranking"] !=
            got["loss"]["images_ranking"]) == has_listener
    assert os.path.isfile(gt_path)
