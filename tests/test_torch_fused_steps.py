"""The port's device feature cache and fused K-step chunks
(`Trainer.train_chunk`, training/fused.py), against the port's per-step
path and the JAX package, on the CPU at tiny width.

The contract is JAX's (tests/test_fused_steps.py): a fused run equals the
per-step run -- the same random streams, the same schedule values per
iteration, the same guarded updates, histories, skipped-step count and
termination (checkpoint boundaries, max_iterations, max_epochs) -- only
the unit of dispatch changes.  On the CPU a chunk runs its staged rows
eagerly, step by step, through the body the card captures as a CUDA graph,
so the staging, the row layout, the tensor-valued hyperparameters and the
accounting are what these tests hold.  Tolerances: losses rtol 1e-6 and
params rtol 1e-6 / atol 1e-7 (JAX's test_fused_steps.py:28); the cache's
batches exactly equal the streamed ones in f32, within bf16 rounding in
bf16.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cooperativeimagecaptioning_tpu.training import loop as jloop  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.data import DataLoader  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import fused  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training import loop as tloop  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.utils.tree import (  # noqa: E402
    leaves, to_numpy)
from test_torch_listener_training import LISTENER  # noqa: E402
from test_torch_training import (  # noqa: E402
    LOSS_TOL, assert_tree_close, tiny_dataset, tiny_opt)

COMMON = dict(device_feature_cache=1, max_att_len=6, losses_log_every=1,
              save_checkpoint_every=10_000)
MLE = dict(phase=2, caption_loss_weight=1, vse_loss_weight=0,
           drop_prob_lm=0.5)


def trainer(opt):
    return tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                         verbose=False)


def run(opt, max_iterations):
    tr = trainer(opt)
    tr.train(max_iterations=max_iterations)
    return tr


def assert_params_close(a, b, rtol=1e-6, atol=1e-7):
    la, lb = leaves(a), leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


def floats(h):
    return {k: float(v) for k, v in h.items()}


def assert_runs_equal(per_step, chunked):
    """Losses rtol 1e-6, params, the lr / ss histories, the counters and
    the skipped steps of two runs."""
    a, b = floats(per_step.loss_history), floats(chunked.loss_history)
    assert a.keys() == b.keys() and len(a) > 0
    for it in a:
        np.testing.assert_allclose(b[it], a[it], rtol=1e-6,
                                   err_msg=f"iter {it}")
    assert floats(chunked.lr_history) == floats(per_step.lr_history)
    assert floats(chunked.ss_prob_history) == floats(per_step.ss_prob_history)
    assert (chunked.iteration, chunked.epoch, chunked.gumbel_temp) == \
        (per_step.iteration, per_step.epoch, per_step.gumbel_temp)
    assert chunked.optim.skipped_steps() == per_step.optim.skipped_steps()
    for agent, st in per_step.optim.states.items():
        assert int(chunked.optim.states[agent]["count"]) == int(st["count"])
    assert_params_close(per_step.params, chunked.params)


def both(kw, max_iterations, k=3, start=0):
    """The per-step run and the run in chunks of k of the same options,
    from iteration `start`."""
    runs = []
    for steps in (1, k):
        tr = trainer(tiny_opt(fused_steps=steps, **kw))
        tr.iteration = start
        tr.train(max_iterations=start + max_iterations)
        runs.append(tr)
    a, b = runs
    assert a._fused_gate() == "off" and b._fused_gate() is None
    assert not a._fused and b._fused  # the chunks ran
    return a, b


def test_fused_mle_matches_per_step():
    """Phase-2 MLE with dropout 0.5: six iterations as two chunks of
    three."""
    a, b = both({**COMMON, **MLE}, 6)
    assert a.iteration == b.iteration == 6
    assert_runs_equal(a, b)


DEVICE_TIERS = {
    "scst_on_device": dict(phase=3, cider_optimization=1,
                           caption_loss_weight=0, on_device_cider=1,
                           drop_prob_lm=0.5, remat=1),
    "joint_gumbel_on_device": dict(
        LISTENER, phase=3, is_alternating=1,
        alternating_turn=["speaker", "listener"], retrieval_reward="gumbel",
        retrieval_reward_weight=0.1, cider_optimization=0.5,
        caption_loss_weight=1, vse_loss_weight=0.1, on_device_cider=1),
    "joint_gumbel_softmax_soft": dict(
        LISTENER, phase=3, is_alternating=1, alternating_turn=["speaker"],
        retrieval_reward="gumbel_softmax", retrieval_reward_weight=0.1,
        cider_optimization=0.5, caption_loss_weight=0, vse_loss_weight=0.1,
        soft_cider=1, prob_gumbel_softmax=0.5),
}


@pytest.mark.parametrize("case", sorted(DEVICE_TIERS))
def test_fused_device_reward_runs_match_per_step(case):
    """The device reward tiers inside the chunk: the staged refs, the
    greedy baseline and the reward (or the soft CIDEr) every step."""
    a, b = both({**COMMON, **DEVICE_TIERS[case]}, 6)
    assert_runs_equal(a, b)


def test_hyperparameters_change_inside_a_chunk():
    """The gumbel temperature anneals every two iterations and the lr
    decays every epoch (the tiny train split wraps every two or three
    iterations): chunks of four carry both, staged per step, and equal the
    per-step run.  The reference anneals by exp(-factor * (iteration -
    177000)) (train.py:399-414), so the runs start at iteration 177000."""
    kw = dict(COMMON, **DEVICE_TIERS["joint_gumbel_on_device"],
              gumbel_temperature_annealing_factor=0.1,
              num_iteration_for_annealing=2, learning_rate_decay_start=0,
              learning_rate_decay_every=1, learning_rate_decay_rate=0.5)
    a, b = both(kw, 8, k=4, start=177_000)
    assert len(set(floats(a.lr_history).values())) > 2
    assert a.gumbel_temp < a.opt.gumbel_temp * 0.5
    assert_runs_equal(a, b)


def test_fused_schedules_track_epoch_wraps():
    """Ten iterations in chunks of four across several wraps: lr decay and
    scheduled sampling keyed on each step's epoch; scheduled sampling
    switches on at the first wrap, where a chunk ends (a captured
    iteration either draws its noise or not)."""
    kw = dict(COMMON, **MLE, learning_rate_decay_start=0,
              learning_rate_decay_every=1, learning_rate_decay_rate=0.5,
              scheduled_sampling_start=0, scheduled_sampling_increase_every=1,
              scheduled_sampling_increase_prob=0.05)
    a, b = both(kw, 10, k=4)
    assert a.epoch >= 2 and len(set(floats(a.lr_history).values())) > 1
    assert {(False,), (True,)} <= {(k[1],) for k in b._fused}
    assert_runs_equal(a, b)


def test_fused_respects_checkpoint_boundaries(tmp_path):
    """fused_steps=16 > save_checkpoint_every=4: checkpoints at 4 and 8,
    as the per-step path writes them."""
    opt = tiny_opt(**{**COMMON, **MLE, "fused_steps": 16,
                      "save_checkpoint_every": 4,
                      "checkpoint_path": str(tmp_path / "ck")})
    tr = run(opt, 8)
    assert tr.iteration == 8
    assert set(tr.val_result_history) == {4, 8}
    assert os.path.exists(os.path.join(opt.checkpoint_path, "model.pth"))


def test_fused_stops_at_max_epochs():
    """max_epochs reached mid-chunk: staging stops right after the wrapping
    batch, so both paths end at the same iteration."""
    kw = dict(COMMON, **MLE, max_epochs=1)
    ends = {}
    for k in (1, 16):
        tr = run(tiny_opt(fused_steps=k, **kw), None)
        ends[k] = (tr.iteration, tr.epoch)
    assert ends[16] == ends[1] and ends[1][1] == 1


def test_fused_skipped_step_accounting():
    """A non-finite att feature makes the steps whose batch holds its image
    non-finite: the guard skips them on both paths alike, and the counts
    and params agree."""
    out = []
    for k in (1, 3):
        tr = trainer(tiny_opt(fused_steps=k, **COMMON, **MLE))
        first = tr.loader.split_ix["train"][0]
        tr._feat_cache["att"][first, 0, 0] = float("nan")
        tr.train(max_iterations=6)
        out.append(tr)
    assert out[0].optim.skipped_steps() > 0
    assert_runs_equal(*out)
    assert bool(out[1].optim.last_step_ok) == bool(out[0].optim.last_step_ok)


def test_fused_mle_matches_jax_fused():
    """The port's chunks of three against the JAX package's fused scan
    (dropout off: no noise), from the same params and batches: losses
    within LOSS_TOL, params within 2 lr steps."""
    kw = dict(COMMON, phase=2, caption_loss_weight=1, vse_loss_weight=0,
              fused_steps=3)
    opt = tiny_opt(**kw)
    tr = trainer(opt)
    jtr = jloop.Trainer(opt.replace(), dataset=tiny_dataset(opt),
                        verbose=False)
    jtr.params = jax.tree.map(jnp.asarray, to_numpy(tr.params))
    jtr.optim.states = {a: jtr.optim.txs[a].init(jtr.params[a])
                        for a in jtr.optim.states}
    tr.train(max_iterations=6)
    jtr.train(max_iterations=6)
    assert jtr._chunk_fns and tr._fused
    want, got = floats(jtr.loss_history), floats(tr.loss_history)
    assert want.keys() == got.keys()
    for it in want:
        np.testing.assert_allclose(got[it], want[it], rtol=1e-4,
                                   err_msg=f"iter {it}")
    np.testing.assert_allclose(got[1], want[1], **LOSS_TOL)
    assert_tree_close(jtr.params, tr.params, atol=2 * opt.learning_rate * 6,
                      rtol=0)


# every reason the gate gives, with the options that give it
GATES = {
    "off": dict(fused_steps=1),
    "alternation": dict(LISTENER, phase=3, is_alternating=1,
                        alternating_turn=["speaker", "listener"],
                        retrieval_reward="reinforce",
                        retrieval_reward_weight=0.1),
    "host reward": dict(phase=3, cider_optimization=1,
                        caption_loss_weight=0),
    "bn": dict(use_bn=1),
    "audit": dict(audit_grad_isolation=1),
    "profiler": dict(profile_dir="prof"),
    "no cache": dict(device_feature_cache=0),
    "open": dict(phase=3, cider_optimization=1, caption_loss_weight=0,
                 on_device_cider=1),
}


@pytest.mark.parametrize("case", sorted(GATES))
def test_gate_reasons_equal_jax(case, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    kw = dict(COMMON, fused_steps=4)
    kw.update(GATES[case])
    opt = tiny_opt(**kw)
    tr = trainer(opt)
    jtr = jloop.Trainer(opt.replace(), dataset=tiny_dataset(opt),
                        verbose=False)
    assert tr._fused_gate() == jtr._fused_gate()
    assert (tr._fused_gate() is None) == (case == "open")
    jtr.close()


@pytest.mark.parametrize("case", ["host reward", "no cache"])
def test_a_gated_run_trains_per_step(case, capsys):
    """A gated configuration trains one step at a time and says why, once."""
    kw = dict(COMMON, fused_steps=4)
    kw.update(GATES[case])
    opt = tiny_opt(**kw)
    tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cpu")
    tr.train(max_iterations=2)
    assert tr.iteration == 2 and not tr._fused
    out = capsys.readouterr().out
    assert out.count("falling back to per-step execution") == 1


# ---------------------------------------------------------------------------
# the device feature cache
# ---------------------------------------------------------------------------

def assert_cache_trains_as_streamed(opt, steps):
    """`steps` iterations of a Trainer with the feature cache against one
    that streams the features, on the same batches: losses within
    LOSS_TOL (the cache pads every image to the dataset's largest slot
    count, the loader a batch to its own: the attention's softmax runs
    over masked slots more), params within 2 lr steps."""
    cached = trainer(opt.replace(device_feature_cache=1))
    streamed = trainer(opt.replace(device_feature_cache=0))
    assert cached._feat_cache is not None and streamed._feat_cache is None
    for n in range(steps):
        la, _, da = cached.train_iteration()
        lb, _, db = streamed.train_iteration()
        assert [i["ix"] for i in da["infos"]] == \
            [i["ix"] for i in db["infos"]]
        np.testing.assert_allclose(float(la["loss"]), float(lb["loss"]),
                                   **LOSS_TOL)
    assert_params_close(cached.params, streamed.params, rtol=0,
                        atol=2 * opt.learning_rate * steps)


@pytest.mark.parametrize("max_att_len", [0, 6, 4])
def test_cache_trains_as_streamed(max_att_len):
    """K from the largest image (0), pinned (6), and outgrown by images
    with more slots (4: the cache pads to the largest, as the loader's
    batches grow)."""
    assert_cache_trains_as_streamed(
        tiny_opt(max_att_len=max_att_len, phase=2), 3)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cached_batches_equal_streamed_ones(dtype):
    """A batch gathered from the cache against the streamed batch of the
    same images: fc exactly, att exactly in f32 (within bf16 rounding in
    bf16) on the streamed slots, the cache's extra slots zero and
    masked."""
    opt = tiny_opt(**{**COMMON, "feature_cache_dtype": dtype,
                      "max_att_len": 0})
    tr = trainer(opt)
    data = DataLoader(opt, dataset=tiny_dataset(opt)).get_batch("train")
    got = tr._prepare_batch(data)
    K = data["att_feats"].shape[1]
    assert got["att_feats"].dtype == torch.float32
    np.testing.assert_array_equal(got["fc_feats"].numpy(), data["fc_feats"])
    att = got["att_feats"].numpy()
    mask = data["att_masks"] if data["att_masks"] is not None else \
        np.ones(att.shape[:2], np.float32)
    np.testing.assert_array_equal(got["att_masks"].numpy()[:, :K], mask)
    assert not got["att_masks"][:, K:].any() and not att[:, K:].any()
    if dtype == "f32":
        np.testing.assert_array_equal(att[:, :K], data["att_feats"])
    else:
        want = data["att_feats"]
        assert np.all(np.abs(att[:, :K] - want) <= 2.0 ** -8 * np.abs(want))
        assert not np.array_equal(att[:, :K], want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_feature_cache_equals_jax(dtype):
    opt = tiny_opt(**COMMON, feature_cache_dtype=dtype)
    tr = trainer(opt)
    jtr = jloop.Trainer(opt.replace(), dataset=tiny_dataset(opt),
                        verbose=False)
    for key in ("fc", "att", "att_mask"):
        want = np.asarray(jtr._feat_cache[key]).astype(np.float32)
        got = tr._feat_cache[key].to(torch.float32).numpy()
        np.testing.assert_array_equal(got, want, err_msg=key)
    assert tr._feat_cache["att"].dtype == (torch.bfloat16 if dtype == "bf16"
                                           else torch.float32)
    assert tr.feature_cache_bytes == sum(
        v.numel() * v.element_size() for k, v in tr._feat_cache.items()
        if not k.startswith("_"))
    jtr.close()


def test_a_later_stage_reuses_the_cache_and_rebuilds_att_on_change():
    """The cache rides the dataset: a second Trainer with the same att
    transforms reuses it; another storage dtype rebuilds the att block and
    keeps fc."""
    opt = tiny_opt(**COMMON)
    ds = tiny_dataset(opt)
    a = tloop.Trainer(opt, dataset=ds, device="cpu", verbose=False)
    b = tloop.Trainer(opt.replace(), dataset=ds, device="cpu", verbose=False)
    assert b._feat_cache is a._feat_cache
    c = tloop.Trainer(opt.replace(feature_cache_dtype="bf16"), dataset=ds,
                      device="cpu", verbose=False)
    assert c._feat_cache["fc"] is a._feat_cache["fc"]
    assert c._feat_cache["att"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the rest
# ---------------------------------------------------------------------------

def test_row_layout_packs_and_unpacks():
    layout = fused.RowLayout([("idx", (4,)), ("labels", (4, 3)),
                              ("lr", (1,)), ("hp", (10,))])
    vals = {"idx": np.arange(4), "labels": np.arange(12).reshape(4, 3) + 9000,
            "lr": [5e-4], "hp": np.linspace(0, 1, 10)}
    row = torch.from_numpy(layout.pack(vals))
    assert layout.width == 4 + 12 + 1 + 10
    got = layout.unpack(row)
    for k, v in vals.items():
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(v, np.float32).reshape(
                                          got[k].shape))
    with pytest.raises(ValueError, match="labels"):
        layout.pack({**vals, "labels": np.zeros((3, 3))})


@pytest.mark.parametrize("kw", [dict(fused_steps=3),
                                dict(device_feature_cache=1)])
def test_a_mesh_refuses_fused_chunks_and_the_cache(kw):
    """Fused chunks and the device feature cache raised on a mesh until
    they were ported (the ids kept): on a (2, 1) mesh every rank holds the
    cache whole and gathers its own rows, and a chunk of three
    (fused_steps=3 with the cache) or three single iterations (the cache)
    equal the streamed single-device run (losses rtol 2e-5, params within
    2 lr steps: the mesh tests' tolerances)."""
    import torch_mesh_ranks as ranks
    from cooperativeimagecaptioning_tpu_torch.parallel import launch
    steps = 3
    if "fused_steps" in kw:
        opt = ranks.tiny_opt(device_feature_cache=1, max_att_len=6, **kw)
        got = launch.spawn(ranks.fused_world_rank, (
            (2, 1), {"f": (opt, steps, None, False, False)}), 2, "cpu")
        for r in got:
            assert r["f"]["fused"] and r["f"]["gate"] is None
        got = [dict(r["f"], losses=[r["f"]["losses"][i]
                                    for i in range(1, steps + 1)])
               for r in got]
    else:
        got = launch.spawn(ranks.train_mesh, (kw, (2, 1), steps, False), 2,
                           "cpu")
    opt = ranks.tiny_opt()
    tr = tloop.Trainer(opt, dataset=ranks.tiny_dataset(opt), device="cpu",
                       verbose=False)
    losses = [float(tr.train_iteration()[0]["loss"]) for _ in range(steps)]
    want = dict(leaves(ranks.trainer_state(tr)["params"]))
    bound = 2 * opt.learning_rate * steps
    for r in got:
        np.testing.assert_allclose(r["losses"], losses, rtol=2e-5)
        for k, v in leaves(r["params"]):
            np.testing.assert_allclose(v, want[k], rtol=0, atol=bound,
                                       err_msg=k)


@pytest.mark.cuda
def test_a_captured_chunk_equals_per_step_on_the_card():
    """On the card: the chunk replays one captured iteration, and equals
    the per-step run (SCST with the device reward, dropout 0.5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(COMMON, **DEVICE_TIERS["scst_on_device"])
    out = []
    for k in (1, 3):
        opt = tiny_opt(fused_steps=k, **kw)
        tr = tloop.Trainer(opt, dataset=tiny_dataset(opt), device="cuda",
                           verbose=False)
        tr.train(max_iterations=6)
        out.append(tr)
    steps = list(out[1]._fused.values())
    # off a mesh the iteration has no collective: one segment
    assert steps and steps[0].plan is not None and \
        steps[0].segments == 1 and steps[0].replays == 4
    a, b = floats(out[0].loss_history), floats(out[1].loss_history)
    for it in a:
        np.testing.assert_allclose(b[it], a[it], rtol=1e-6)
