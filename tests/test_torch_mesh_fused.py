"""Fused chunks on a (data, model) mesh (`Trainer.train_chunk` on each
rank; training/fused.py), on the CPU over gloo (ranks in
tests/torch_mesh_ranks.py), against the port's per-step mesh run and the
JAX package's fused chunk on the same mesh.

* `fused_steps=3` with the feature cache on (2, 1) phase 2 and on (2, 1)
  and (1, 2) `-o gumbel` with `on_device_cider`, dropout 0.5, against the
  per-step mesh run of the same options (each rank draws the global noise
  and keeps its rows): losses rtol 1e-6, params rtol 1e-6 / atol 1e-7
  (JAX's tests/test_fused_steps.py:28 rule); the histories at the
  per-step cadence, a chunk cut at the checkpoint, the same checkpoints;
* a non-finite feature in one rank's rows: the world's flag skips the
  step on every rank, and the skipped steps equal the per-step run's;
* each configuration with dropout off, the port's streams replaying what
  JAX's fused chunk draws (`jax.random.split` of its carried key, step by
  step), against JAX's `Trainer.train_chunk` on the same mesh of the
  conftest's CPU devices: losses rtol 2e-5, params within 2 lr steps (the
  mesh tests' tolerances);
* under `collectives.Recording`, the collectives of a fused step (the body
  the card captures in segments) are those of a per-step iteration, op
  for op, and the same on every rank;
* the pieces: a rank's rows of a stacked chunk, and a plan's refusal of
  broadcasts and barriers.

On the card (marked cuda) the chunks are replays of captured segments:
the same runs at tiny width against per-step, with the segment and
collective counts.
"""

import copy

import numpy as np
import pytest
import torch

from cooperativeimagecaptioning_tpu_torch.parallel import launch
from cooperativeimagecaptioning_tpu_torch.utils.tree import leaves

import torch_mesh_ranks as ranks

LISTENER = dict(vse_model="fc", vse_embed_size=16)
COMMON = dict(device_feature_cache=1, max_att_len=6, save_checkpoint_every=4)
MLE = dict(phase=2, caption_loss_weight=1, vse_loss_weight=0,
           drop_prob_lm=0.5, losses_log_every=2)
GUMBEL = dict(LISTENER, phase=3, is_alternating=1,
              alternating_turn=["speaker", "listener"],
              retrieval_reward="gumbel", retrieval_reward_weight=0.1,
              cider_optimization=0.5, caption_loss_weight=1,
              vse_loss_weight=0.1, on_device_cider=1, drop_prob_lm=0.5,
              losses_log_every=1)
K = 3
# per-step against fused: iterations (a chunk of 3, one cut at the
# checkpoint at 4, then the rest)
STEPS = {"mle": 6, "gumbel": 5, "nan": 3}
JAX_STEPS = 3
LOSS_RTOL = 2e-5
# the configurations of each world, by name
WORLDS = {(2, 1): ("mle", "gumbel", "nan"), (1, 2): ("gumbel",)}


def config(name, fused_steps, **kw):
    base = MLE if name in ("mle", "nan") else GUMBEL
    return ranks.tiny_opt(**{**COMMON, **base, "fused_steps": fused_steps,
                             **kw})


def pair_cases(shape):
    """{(name, fused_steps): (opt, steps, noise, nan_image, record)}: each
    configuration per step and fused."""
    out = {}
    for name in WORLDS[shape]:
        for k in (1, K):
            out[(name, k)] = (config(name, k), STEPS[name], None,
                              name == "nan", name != "nan")
    return out


# ---------------------------------------------------------------------------
# the JAX package's fused chunk on the same mesh, and its draws
# ---------------------------------------------------------------------------

def jax_case(name, shape, tmp):
    """JAX's `Trainer.train_chunk` of JAX_STEPS steps on a `shape` mesh
    from the port's initial params (dropout off), and the port's case
    replaying its draws: {stream seed of the port's iteration: {stream:
    arrays}} from the step keys JAX's chunk splits off its carried key."""
    jax = pytest.importorskip("jax")
    from cooperativeimagecaptioning_tpu.training import loop as jloop
    from cooperativeimagecaptioning_tpu_torch.training import loop as tloop
    from cooperativeimagecaptioning_tpu_torch.utils.tree import to_numpy
    from test_torch_listener_training import replay_streams
    opt = config(name, K, drop_prob_lm=0.0, save_checkpoint_every=10_000,
                 checkpoint_path=str(tmp / f"jax_{name}_{shape[1]}"))
    tr = tloop.Trainer(copy.deepcopy(opt), dataset=ranks.tiny_dataset(opt),
                       device="cpu", verbose=False)
    params, seed = to_numpy(tr.params), tr._seed
    turn = tr.turn
    tr.close()
    jopt = opt.replace(mesh_data_axis=shape[0], mesh_model_axis=shape[1])
    jtr = jloop.Trainer(jopt, dataset=ranks.tiny_dataset(opt), verbose=False)
    jtr.params = jax.device_put(params, jtr._param_shardings)
    jtr.optim.states = {a: jtr.optim.txs[a].init(jtr.params[a])
                        for a in jtr.optim.states}
    B = opt.batch_size * opt.seq_per_img
    noise, rng = {}, jtr._rng
    for it in range(JAX_STEPS):
        rng, key = jax.random.split(rng)
        noise[seed * 1_000_003 + it] = {
            k: r.arrays for k, r in replay_streams(key, opt, B,
                                                   turn).items()}
    jtr.train(max_iterations=JAX_STEPS)
    assert jtr._chunk_fns
    want = {"losses": {k: float(v) for k, v in jtr.loss_history.items()},
            "params": to_numpy(jax.tree.map(np.asarray, jtr.params)),
            "lr": opt.learning_rate}
    jtr.close()
    return want, (opt, JAX_STEPS, noise, False, False)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each mesh's per-step and fused runs, and its fused runs on JAX's
    draws beside JAX's chunks; one two-rank world runs both meshes."""
    tmp = tmp_path_factory.mktemp("mesh_fused")
    cases, jax_want = {}, {}
    for shape, names in WORLDS.items():
        for key, (opt, *rest) in pair_cases(shape).items():
            cases[(shape, *key)] = (opt.replace(
                checkpoint_path=str(tmp / f"{key[0]}_{key[1]}_{shape[1]}"),
                mesh_data_axis=shape[0], mesh_model_axis=shape[1]), *rest)
        for name in names:
            if name != "nan":
                jax_want[(shape, name)], (opt, *rest) = jax_case(name, shape,
                                                                 tmp)
                cases[(shape, "jax", name)] = (opt.replace(
                    mesh_data_axis=shape[0], mesh_model_axis=shape[1]),
                    *rest)
    got = launch.spawn(ranks.fused_world_rank, (None, cases), 2, "cpu",
                       timeout=900)
    return {shape: {"ranks": [{key[1:]: v for key, v in r.items()
                               if key[0] == shape} for r in got],
                    "jax": {name: w for (s, name), w in jax_want.items()
                            if s == shape}}
            for shape in WORLDS}


def world_keys(pairs=True):
    return [(shape, name) for shape, names in WORLDS.items()
            for name in names if pairs or name != "nan"]


def assert_runs_equal(a, b):
    """Losses rtol 1e-6 at the same history keys, lr / ss histories,
    counters, checkpoints, skipped steps and params (rtol 1e-6 / atol
    1e-7) of a per-step run `a` and a fused run `b`."""
    assert a["losses"].keys() == b["losses"].keys() and a["losses"]
    for it, v in a["losses"].items():
        np.testing.assert_allclose(b["losses"][it], v, rtol=1e-6,
                                   err_msg=f"iter {it}")
    assert b["lrs"] == a["lrs"] and b["ss"] == a["ss"]
    for k in ("iteration", "epoch", "checkpoints", "skipped", "last_ok"):
        assert b[k] == a[k], k
    want = dict(leaves(a["params"]))
    for k, v in leaves(b["params"]):
        np.testing.assert_allclose(v, want[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("shape,name", world_keys())
def test_fused_chunks_on_a_mesh_equal_the_per_step_mesh_run(worlds, shape,
                                                           name):
    for r in worlds[shape]["ranks"]:
        a, b = r[(name, 1)], r[(name, K)]
        assert a["gate"] == "off" and b["gate"] is None
        assert not a["fused"] and b["fused"]
        assert_runs_equal(a, b)
        if name == "nan":
            continue
        # the histories' cadence, and a chunk cut at the checkpoint
        every = MLE["losses_log_every"] if name == "mle" else 1
        assert sorted(b["losses"]) == list(range(every, STEPS[name] + 1,
                                                 every))
        assert b["checkpoints"] == [4] and b["iteration"] == STEPS[name]
    # every rank holds the same global losses
    ranks_out = worlds[shape]["ranks"]
    assert all(r[(name, K)]["losses"] == ranks_out[0][(name, K)]["losses"]
               for r in ranks_out)


def test_the_worlds_flag_skips_a_step_on_every_rank(worlds):
    """The NaN lies in the first train image, in one rank's rows: both
    ranks skip the same steps, fused as per step."""
    for r in worlds[(2, 1)]["ranks"]:
        a, b = r[("nan", 1)], r[("nan", K)]
        assert a["skipped"] > 0 and b["skipped"] == a["skipped"]
        assert b["last_ok"] == a["last_ok"]


@pytest.mark.parametrize("shape,name", world_keys(pairs=False))
def test_fused_chunks_on_a_mesh_match_jax_fused_chunks(worlds, shape, name):
    want = worlds[shape]["jax"][name]
    bound = 2 * want["lr"] * JAX_STEPS
    for r in worlds[shape]["ranks"]:
        got = r[("jax", name)]
        assert got["fused"] and got["gate"] is None
        assert got["losses"].keys() == want["losses"].keys()
        for it, v in want["losses"].items():
            np.testing.assert_allclose(got["losses"][it], v, rtol=LOSS_RTOL,
                                       err_msg=f"iter {it}")
        w = dict(leaves(want["params"]))
        g = dict(leaves(got["params"]))
        assert set(w) == set(g)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=bound,
                                       err_msg=k)


@pytest.mark.parametrize("shape,name", world_keys(pairs=False))
def test_a_fused_step_runs_the_per_step_collectives(worlds, shape, name):
    """The recorded sequence of a fused step (op, group ranks, shape,
    dtype, reduce op or dim) equals a per-step iteration's, on every rank:
    the order the card's segments keep."""
    got = [r[(name, K)]["recorded"] for r in worlds[shape]["ranks"]]
    want = worlds[shape]["ranks"][0][(name, 1)]["recorded"]
    assert want and {op[0] for op in want} <= {"all_reduce", "all_gather"}
    assert all(seq == want for seq in got)
    # the gradients' all-reduce, the world's flag and the global sums
    # close every step on a data axis
    if shape[0] > 1:
        assert [op[0] for op in want[-3:]] == ["all_reduce"] * 3
        assert want[-2][3:] == ("torch.int32", "min")


# ---------------------------------------------------------------------------
# on the card: replays of the captured segments
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_fused_mesh_chunks_replay_segments_on_the_card(shape, tmp_path):
    """Two ranks sharing the card over gloo: -o gumbel with on_device_cider
    in chunks of 3 against per step (losses rtol 1e-6, params 1e-6 /
    1e-7); the chunks replay segments captured between the collectives,
    one segment more than the collectives, with the launches a per-step
    iteration makes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _build
    _build.library()  # built once, before the ranks load it
    steps = 5
    cases = {("gumbel", k): (config("gumbel", k, checkpoint_path=str(
        tmp_path / f"gumbel{k}"), save_checkpoint_every=10_000), steps,
        None, False, False) for k in (1, K)}
    got = launch.spawn(ranks.fused_world_rank, (shape, cases, "cuda"), 2,
                       "cuda", timeout=900)
    for r in got:
        a, b = r[("gumbel", 1)], r[("gumbel", K)]
        assert_runs_equal(a, b)
        seg, col = b["segments"], b["collectives"]
        assert len(seg) == 1 and seg[0] == col[0] + 1 and col[0] > 0
        # one eager warm-up step, then replays
        assert b["replays"] == steps - 1
        per_step = {k: v // steps for k, v in a["launches"].items()}
        assert all(v % steps == 0 for v in a["launches"].values())
        assert b["per_replay"] == per_step and per_step["attention"] > 0


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

def test_a_rank_keeps_its_rows_of_the_stacked_chunk():
    """`shard_batch_stacked` over a chunk's unstacked rows: the per-row
    fields (cache indices, labels, masks) keep the rank's rows of each
    step, the refs and the per-step values (lr [1], Hyper [10]) stay whole;
    `restack` packs them back into rows of the rank's layout."""
    from cooperativeimagecaptioning_tpu_torch.parallel import mesh as M
    from cooperativeimagecaptioning_tpu_torch.training import fused
    layout = fused.RowLayout([("idx", (4,)), ("labels", (4, 3)),
                              ("masks", (4, 3)), ("lr", (1,)), ("hp", (10,)),
                              ("refs", (2, 5, 3)), ("ref_mask", (2, 5))])
    K = 3
    rows = torch.arange(K * layout.width, dtype=torch.float32).view(
        K, layout.width)
    whole = layout.unstack(rows)
    for r in (0, 1):
        m = M.Mesh(2, 1, r, torch.device("cpu"), "gloo", None, None, None)
        mine = M.shard_batch_stacked(whole, m)
        for k in ("idx", "labels", "masks"):
            assert torch.equal(mine[k], whole[k][:, 2 * r:2 * r + 2]), k
        for k in ("lr", "hp", "refs", "ref_mask"):
            assert torch.equal(mine[k], whole[k]), k
        local, lay = fused.restack(mine)
        assert local.shape == (K, lay.width) and lay.width < layout.width
        for k, v in lay.unstack(local).items():
            assert torch.equal(v, mine[k]), k


def test_a_plan_refuses_broadcasts_and_barriers():
    """Under a plan only all_reduce and all_gather may run: a broadcast or
    a barrier raises before it reaches the backend."""
    from cooperativeimagecaptioning_tpu_torch.parallel import collectives
    rec = collectives.Recording()
    with collectives.planned(rec):
        for call in (lambda: collectives.barrier(None),
                     lambda: collectives.broadcast_object(1, None),
                     lambda: collectives.broadcast_(torch.zeros(1), None)):
            with pytest.raises(RuntimeError, match="under a collective plan"):
                call()
        with pytest.raises(RuntimeError, match="active already"):
            with collectives.planned(collectives.Recording()):
                pass
    assert rec.ops == [] and collectives._plan is None
