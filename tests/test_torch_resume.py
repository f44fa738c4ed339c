"""Run dirs: the port resumes what the JAX package writes and what it
writes itself, writes the artifacts the JAX package writes, and evaluates
and serves the speaker of a joint run -- on the CPU, float32, tiny width
(rnn 16, vocab 25, L=8).

A JAX-written phase-2 run dir (model.pth, an optax `optimizer.pth`, infos
pickled with the JAX package's Options, histories) resumes in the port with
params and every Adam leaf equal exactly and the counters and loader
positions resumed; the next step's loss at dropout 0 equals the JAX
package's next step within LOSS_TOL.  Reading the optax file imports
neither optax nor JAX (tests/test_torch_hostcopies.py runs it in a process
without them)."""

import os
import pickle

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from cooperativeimagecaptioning_tpu import config as jconfig  # noqa: E402
from cooperativeimagecaptioning_tpu import data as jdata  # noqa: E402
from cooperativeimagecaptioning_tpu import serving as jserving  # noqa: E402
from cooperativeimagecaptioning_tpu.native import bindings  # noqa: E402
from cooperativeimagecaptioning_tpu.training import checkpoint as jckpt  # noqa: E402
from cooperativeimagecaptioning_tpu.training import joint as jjoint  # noqa: E402
from cooperativeimagecaptioning_tpu.training import loop as jloop  # noqa: E402
from cooperativeimagecaptioning_tpu_torch import eval as teval_entry  # noqa: E402
from cooperativeimagecaptioning_tpu_torch import serving as tserving  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.data import SyntheticDataset  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.native import bindings as tbindings  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import checkpoint as tckpt  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import joint as tjoint  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import loop as tloop  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.utils.tree import (  # noqa: E402
    leaves, to_numpy)
from test_torch_training import (  # noqa: E402
    LOSS_TOL, assert_tree_close, tiny_dataset, tiny_opt)

DS = dict(num_images=16, vocab_size=25, seq_length=8, fc_feat_size=20,
          att_feat_size=20, max_K=6)
STEPS = 1  # the next batch does not wrap the train split


@pytest.fixture(autouse=True)
def _pure_python_metrics(monkeypatch, tmp_path):
    """Both packages score on their pure-Python tier (the C++ tiers are held
    equal in test_torch_native.py)."""
    monkeypatch.setattr(bindings, "available", lambda: False)
    monkeypatch.setattr(tbindings, "available", lambda: False)
    monkeypatch.chdir(tmp_path)


def run_opt(path, **kw):
    base = dict(checkpoint_path=str(path), id="rd", language_eval=0,
                val_images_use=-1, save_checkpoint_every=10 ** 6,
                learning_rate=5e-3, weight_decay=1e-3)
    base.update(kw)
    return tiny_opt(**base)


def jax_opt(opt):
    return jconfig.Options(**vars(opt))


def jax_run(path, steps=STEPS, **kw):
    """A JAX Trainer after `steps` phase-2 steps and checkpoint_operations:
    (trainer, its run dir)."""
    opt = jax_opt(run_opt(path, **kw))
    tr = jloop.Trainer(opt, dataset=jdata.SyntheticDataset(**DS),
                       verbose=False)
    for _ in range(steps):
        tr.train_iteration()
    tr.checkpoint_operations()
    return tr


def adam_of(jstate):
    for s in jstate.inner_state:
        if hasattr(s, "mu"):
            return s
    raise AssertionError("no Adam state")


def assert_adam_equal(jstate, port_state, paths):
    adam = adam_of(jstate)
    assert int(port_state["count"]) == int(adam.count)
    for key, moments in (("mu", adam.mu), ("nu", adam.nu)):
        want = {".".join(str(k.key) for k in p): np.asarray(v)
                for p, v in jax.tree_util.tree_leaves_with_path(moments)}
        assert sorted(want) == list(paths)
        for path, got in zip(paths, port_state[key]):
            np.testing.assert_array_equal(want[path], got.numpy(),
                                          err_msg=f"{key} {path}")


def port_resume(path, **kw):
    opt = run_opt(str(path) + "_port", start_from=str(path), **kw)
    return tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                         verbose=False)


def test_a_jax_phase2_run_resumes_in_the_port(tmp_path):
    jtr = jax_run(tmp_path / "jax")
    tr = port_resume(tmp_path / "jax")
    # params and every Adam leaf exactly
    assert_tree_close(jtr.params, tr.params, rtol=0, atol=0)
    assert_adam_equal(jtr.optim.states["speaker"],
                      tr.optim.states["speaker"], tr.optim.paths["speaker"])
    # the counters and the loader's place
    assert (tr.iteration, tr.epoch) == (jtr.iteration, jtr.epoch) == (STEPS,
                                                                      0)
    assert tr.loader.iterators == jtr.loader.iterators
    assert tr.loader.split_ix == jtr.loader.split_ix
    assert tr.best_val_score == jtr.best_val_score
    assert set(tr.loss_history) == set(jtr.loss_history)
    # the next step: the same images come next (which of an image's
    # captions a batch holds is the loader's own draw, not resumed in
    # either package); on one batch, the same loss (dropout 0)
    jnext = jtr.loader.get_batch("train")
    data = tr.loader.get_batch("train")
    assert [i["ix"] for i in jnext["infos"]] == \
        [i["ix"] for i in data["infos"]]
    jd, _, _ = jtr.train_iteration(data)
    td, _, _ = tr.train_iteration(data)
    np.testing.assert_allclose(float(jd["loss"]), td["loss"].item(),
                               **LOSS_TOL)
    assert_tree_close(jtr.params, tr.params, atol=2 * 5e-3, rtol=0)


def test_a_port_run_round_trips(tmp_path):
    opt = run_opt(tmp_path / "a", drop_prob_lm=0.5)
    tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                       verbose=False)
    for _ in range(3):
        tr.train_iteration()
    tr.checkpoint_operations()
    again = port_resume(tmp_path / "a", drop_prob_lm=0.5)
    for (k, a), (_, b) in zip(leaves(tr.params), leaves(again.params)):
        assert torch.equal(a, b), k
    for key in ("mu", "nu"):
        for a, b in zip(tr.optim.states["speaker"][key],
                        again.optim.states["speaker"][key]):
            assert torch.equal(a, b)
    assert int(again.optim.states["speaker"]["count"]) == 3
    assert (again.iteration, again.epoch) == (3, tr.epoch)
    assert again.loader.iterators == tr.loader.iterators
    assert again.loss_history == tr.loss_history
    # on one batch, the next iteration draws (dropout) what the
    # uninterrupted run draws
    data = tr.loader.get_batch("train")
    a = tr.train_iteration(data)[0]["loss"].item()
    b = again.train_iteration(data)[0]["loss"].item()
    assert a == b


def test_checkpoint_operations_writes_the_jax_artifacts(tmp_path):
    jax_run(tmp_path / "jax")
    opt = run_opt(tmp_path / "port")
    tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                       verbose=False)
    for _ in range(STEPS):
        tr.train_iteration()
    tr.checkpoint_operations()
    want = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == want
    assert "optimizer.pth" in want and "model-best.pth" in want
    infos = tckpt.load_pkl(str(tmp_path / "port" / "infos_rd.pkl"))
    jinfos = tckpt.load_pkl(str(tmp_path / "jax" / "infos_rd.pkl"))
    assert set(infos) == set(jinfos)
    hist = tckpt.load_pkl(str(tmp_path / "port" / "histories_rd.pkl"))
    assert set(hist) == set(tckpt.load_pkl(
        str(tmp_path / "jax" / "histories_rd.pkl")))
    assert set(hist["val_result_history"][STEPS]["loss"]) == {
        "loss", "loss_cap", "cap_xe"}


def test_scst_resumes_from_a_jax_phase2_run(tmp_path):
    """The path of a user after MLE: self-critical training from the JAX
    phase-2 run dir, then a checkpoint, then that dir resumed again."""
    jtr = jax_run(tmp_path / "jax")
    tr = port_resume(tmp_path / "jax", cider_optimization=1,
                     caption_loss_weight=0, phase=3, drop_prob_lm=0.5)
    assert_tree_close(jtr.params, tr.params, rtol=0, atol=0)
    assert_adam_equal(jtr.optim.states["speaker"],
                      tr.optim.states["speaker"], tr.optim.paths["speaker"])
    for _ in range(2):
        loss_dict, _, _ = tr.train_iteration()
        a, b = tr.last_reward_seqs
        assert torch.equal(a, b)
    assert np.isfinite(loss_dict["loss_cider"].item())
    val_loss, _ = tr.checkpoint_operations()
    assert "loss_cider" in val_loss and np.isfinite(val_loss["loss_cider"])
    again = port_resume(tmp_path / "jax_port", cider_optimization=1,
                        caption_loss_weight=0, phase=3)
    assert again.iteration == STEPS + 2
    assert int(again.optim.states["speaker"]["count"]) == STEPS + 2


def test_stage2_seeding_takes_the_jax_speaker_and_adam_state(tmp_path):
    """Without start_from, speaker_stage_2_model_path / _optimizer_path seed
    the params and the Adam state (counters start at 0)."""
    jtr = jax_run(tmp_path / "jax")
    opt = run_opt(tmp_path / "seeded", cider_optimization=1,
                  caption_loss_weight=0, phase=3,
                  speaker_stage_2_model_path=str(tmp_path / "jax" /
                                                 "model.pth"),
                  speaker_stage_2_optimizer_path=str(tmp_path / "jax" /
                                                     "optimizer.pth"))
    tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                       verbose=False)
    assert_tree_close(jtr.params, tr.params, rtol=0, atol=0)
    assert_adam_equal(jtr.optim.states["speaker"],
                      tr.optim.states["speaker"], tr.optim.paths["speaker"])
    assert tr.iteration == 0


def test_start_with_checkpoint_evaluates_first(tmp_path):
    opt = run_opt(tmp_path / "s", start_with_checkpoint=1)
    tr = tloop.train(opt, dataset=tiny_dataset(opt), max_iterations=2,
                     device="cpu", verbose=False)
    assert sorted(tr.val_result_history) == [1]
    assert (tmp_path / "s" / "model-1.pth").is_file()
    assert not (tmp_path / "s" / "model-2.pth").exists()


def test_optimizer_files_load_without_optax(tmp_path):
    """The optax state maps onto the port's layout through stand-ins; any
    global other than numpy's and optax's is refused; a file of another
    structure leaves the fresh state."""
    jtr = jax_run(tmp_path / "jax")
    st = tckpt.read_optimizer_file(str(tmp_path / "jax" / "optimizer.pth"))
    assert type(st).__module__ == tckpt.__name__
    paths = [k for k, _ in leaves(to_numpy(jtr.params["speaker"]))]
    shapes = [np.shape(x) for _, x in leaves(to_numpy(
        jtr.params["speaker"]))]
    mapped = tckpt.adam_state_from_file(st, paths, shapes)
    assert int(mapped["count"]) == STEPS and len(mapped["mu"]) == len(paths)
    assert tckpt.adam_state_from_file(st, paths[1:], shapes[1:]) is None

    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))

    bad = tmp_path / "bad.pth"
    with open(bad, "wb") as f:
        pickle.dump({"count": 1, "x": Evil()}, f)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        tckpt.read_optimizer_file(str(bad))
    opt = run_opt(tmp_path / "p")
    tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                       verbose=False)
    mgr = tckpt.CheckpointManager(opt)
    assert not mgr.load_agent_optimizer(tr.optim, "speaker", str(bad))
    jax_run(tmp_path / "small", steps=1, rnn_size=8)
    assert not mgr.load_agent_optimizer(
        tr.optim, "speaker", str(tmp_path / "small" / "optimizer.pth"))
    assert int(tr.optim.states["speaker"]["count"]) == 0


# ---------------------------------------------------------------------------
# the speaker of a joint run (a listener beside it)
# ---------------------------------------------------------------------------

JOINT = dict(vse_model="fc", vse_embed_size=16, rank_eval=0,
             language_eval=1, beam_size=2, seq_per_img=1, batch_size=4)


@pytest.fixture(params=[0, 1], ids=["own_embed", "share_embed"])
def joint_run(request, tmp_path):
    """A joint run dir written by the JAX package: {'speaker', 'listener'}
    params (under share_embed the table only under the listener), infos
    with its Options."""
    share = request.param
    kw = dict(JOINT, share_embed=share)
    opt = jax_opt(run_opt(tmp_path, **kw))
    loader = jdata.DataLoader(opt, dataset=jdata.SyntheticDataset(**DS))
    opt.vocab_size, opt.seq_length = loader.vocab_size, loader.seq_length
    params = jax.tree.map(np.asarray, jjoint.init_params(
        jax.random.PRNGKey(9), opt))
    sp = params["speaker"]
    sp["logit"]["w"] = sp["logit"]["w"] * 12.0
    if share:
        assert "embed" not in sp
        params["listener"]["txt_enc"]["embed"] = \
            params["listener"]["txt_enc"]["embed"] * 10.0
    else:
        sp["embed"] = sp["embed"] * 10.0
    model = str(tmp_path / "model-best.pth")
    infos = str(tmp_path / "infos_rd.pkl")
    jckpt.save_params(params, model)
    with open(infos, "wb") as f:
        pickle.dump({"opt": opt, "vocab": loader.get_vocab()}, f)
    return share, model, infos


def _root_eval():
    import importlib.util
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "root_eval", os.path.join(repo, "eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_eval_of_a_joint_run_matches_jax(joint_run, capsys):
    share, model, infos = joint_run
    want = _root_eval().eval(None, model, infos, split="test",
                             dataset=jdata.SyntheticDataset(**DS))
    got = teval_entry.eval(None, model, infos, split="test",
                           dataset=SyntheticDataset(**DS), device="cpu")
    out = capsys.readouterr().out
    # the joint tree holds the listener now: every leaf of the file loads
    assert "key listener" not in out
    assert set(got["loss"]) == set(want["loss"])
    caps = [(p["image_id"], p["caption"]) for p in got["split_predictions"]]
    assert caps == [(p["image_id"], p["caption"])
                    for p in want["split_predictions"]]
    assert len({c for _, c in caps}) > 1
    np.testing.assert_allclose(got["loss"]["loss_cap"],
                               want["loss"]["loss_cap"], rtol=1e-5)
    for k, v in want["lang_stats"].items():
        assert abs(got["lang_stats"][k] - v) <= 1e-6, k


def test_serving_a_joint_run_matches_jax(joint_run):
    share, model, infos = joint_run
    run_dir = os.path.dirname(model)
    kw = dict(run_id="rd", beam_size=2, buckets=(16,),
              compute_dtype="float32", max_att_len=6)
    # the images of the dataset the run was made with
    ds = SyntheticDataset(**DS)
    n = DS["num_images"]
    fc = np.stack([ds.get_fc(i) for i in range(n)]).astype(np.float32)
    atts = [np.asarray(ds.get_att(i), np.float32) for i in range(n)]
    att = np.zeros((n, 6, 20), np.float32)
    masks = np.zeros((n, 6), np.float32)
    for i, a in enumerate(atts):
        att[i, :len(a)], masks[i, :len(a)] = a, 1.0
    want = jserving.CaptioningService.from_run_dir(run_dir, **kw).caption_ids(
        fc, att, masks)
    svc = tserving.CaptioningService.from_run_dir(run_dir, device="cpu", **kw)
    got = svc.caption_ids(fc, att, masks)
    np.testing.assert_array_equal(np.asarray(want), got)
    assert len({tuple(row) for row in got}) > 1
    # the speaker's embedding is the listener's table under share_embed
    emb = tckpt.load_params(model)
    src = emb["listener"]["txt_enc"]["embed"] if share else \
        emb["speaker"]["embed"]
    assert torch.equal(svc.speaker.params.embed, src)


def test_a_joint_run_still_needs_the_listener_to_train_or_rank(joint_run,
                                                               tmp_path):
    """The listener is ported: a joint run dir ranks through eval.eval
    (rank_eval=1) as the JAX package ranks it, and seeds a joint Trainer
    (its speaker and its listener) that trains."""
    share, model, infos = joint_run
    opt = tckpt.load_pkl(infos)["opt"]
    assert "listener" in tjoint.init_params(0, opt)
    want = _root_eval().eval(jax_opt(opt).replace(rank_eval=1), model, infos,
                             split="test",
                             dataset=jdata.SyntheticDataset(**DS))
    got = teval_entry.eval(opt.replace(rank_eval=1), model, infos,
                           split="test", dataset=SyntheticDataset(**DS),
                           device="cpu")
    assert [(p["image_id"], p["caption"]) for p in got[
        "split_predictions"]] == [(p["image_id"], p["caption"])
                                  for p in want["split_predictions"]]
    assert set(got["loss"]) == set(want["loss"]) >= {"t2i_r1", "gt_ranks"}
    for k, v in want["loss"].items():
        if isinstance(v, dict):
            assert got["loss"][k] == v, k
        else:
            np.testing.assert_allclose(got["loss"][k], v, rtol=1e-5)

    run = opt.replace(
        phase=3, is_alternating=1, alternating_turn=["speaker", "listener"],
        retrieval_reward="gumbel", retrieval_reward_weight=0.5,
        cider_optimization=0.5, caption_loss_weight=0, cached_tokens="corpus",
        checkpoint_path=str(tmp_path / "joint"), start_from=None,
        speaker_stage_2_model_path=model, initialize_retrieval=model)
    tr = tloop.Trainer(run, dataset=SyntheticDataset(**DS), device="cpu",
                       verbose=False)
    saved = tckpt.load_params(model)
    for (k, a), (_, b) in zip(leaves(saved), leaves(tr.params)):
        assert torch.equal(a, b.detach()), k
    loss_dict, turn, _ = tr.train_iteration()
    assert turn == "speaker"
    assert all(np.isfinite(float(v)) for v in loss_dict.values())
    assert {"retrieval_loss", "loss_cider"} <= set(loss_dict)
