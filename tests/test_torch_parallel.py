"""The port's (data, model) mesh on the CPU: its sharding rules against the
JAX package's, the two autograd Functions of a vocab-split layer, and the
distributed training step on the meshes (2, 1), (1, 2) and (2, 2) against
the JAX package's single-device loss and the single-process port.

The ranks are processes over gloo (parallel.launch.spawn, rank functions in
tests/torch_mesh_ranks.py, which imports no JAX); one spawn runs several
cases.  Vocabulary 25 puts V+1 = 26 on a model axis of 2 (the logit layer
splits by columns), vocabulary 24 puts V+2 = 26 there (the embedding splits
by rows), as tests/test_parallel.py picks its vocabulary.  Dropout is on
(0.5): the ranks replay the noise the JAX package draws for the global
batch, each keeping its rows (draws.RowShard).

Tolerances: the loss rtol 2e-5 (the JAX mesh test's,
tests/test_parallel.py); gradients against the single-process port rtol
1e-4 / atol 1e-6 (another summation order over rows and over the
vocabulary's slices); the params after one Adam step atol 1e-6 wherever
the single-process gradient's sign is not rounding noise (|g| > 1e-6, or
exactly 0: an embedding row the batch does not use): a first Adam step
moves an entry by lr * sign(g).
"""

import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax import random as J  # noqa: E402

from cooperativeimagecaptioning_tpu import models as jzoo  # noqa: E402
from cooperativeimagecaptioning_tpu import parallel as jpar  # noqa: E402
from cooperativeimagecaptioning_tpu.config import Options as JOptions  # noqa: E402
from cooperativeimagecaptioning_tpu.training import joint as jjoint  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.data import DataLoader  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.parallel import (  # noqa: E402
    launch, mesh as tmesh)
from cooperativeimagecaptioning_tpu_torch.training import joint as tjoint  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.training.optim import (  # noqa: E402
    OptimizerManager)
from cooperativeimagecaptioning_tpu_torch.utils.tree import (  # noqa: E402
    leaves, to_torch, trainable)

import torch_mesh_ranks as ranks  # noqa: E402

LOSS_RTOL = 2e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
VOCABS = (25, 24)
# (mesh shape, vocabulary): the two-rank world's cases, then the four's
CASES2 = (((2, 1), 25), ((1, 2), 25), ((1, 2), 24))
CASES4 = (((2, 2), 25), ((2, 2), 24))


def spec_dim(spec):
    """The dim a JAX PartitionSpec puts on 'model', or None."""
    return next((d for d, name in enumerate(spec) if name == "model"), None)


def joint_tree(V):
    """A joint tree (speaker and listener) of the JAX package, as numpy."""
    opt = JOptions(**vars(ranks.tiny_opt(vocab_size=V, vse_model="fc",
                                         vse_embed_size=16)))
    return jax.tree.map(np.asarray, jjoint.init_params(J.PRNGKey(0), opt))


@pytest.mark.parametrize("shape", [(4, 2), (8, 1), (2, 4)])
@pytest.mark.parametrize("V", VOCABS)
def test_param_specs_match_jax_param_shardings(V, shape):
    tree = joint_tree(V)
    want = {".".join(str(k.key) for k in path): spec_dim(s.spec)
            for path, s in jax.tree_util.tree_leaves_with_path(
                jpar.param_shardings(tree, jpar.make_mesh(*shape),
                                     vocab_sharded=shape[1] > 1))}
    got = tmesh.param_specs(to_torch(tree, "cpu"),
                            types.SimpleNamespace(n_model=shape[1]))
    assert got == want
    if shape == (4, 2):  # one of the two vocabulary matrices splits
        split = {k for k, v in got.items() if v is not None}
        assert split == ({"speaker.logit.w", "speaker.logit.b"} if V == 25
                         else {"speaker.embed", "listener.txt_enc.embed"})


def test_shard_batch_matches_jax():
    """Each data index keeps the rows its JAX shard holds; leaves whose
    leading dim does not divide the axis and the df_table stay whole."""
    rng = np.random.RandomState(0)
    batch = {"labels": rng.randint(0, 9, (8, 5)).astype(np.int32),
             "att_feats": rng.randn(8, 3, 2).astype(np.float32),
             "refs": rng.randint(0, 9, (6, 2, 5)).astype(np.int32),
             "df_table": {"keys": np.arange(8, dtype=np.int32)}}
    mesh = jpar.make_mesh(4, 2)
    jb = jpar.shard_batch(jax.tree.map(jnp.asarray, batch), mesh)
    tb = to_torch(batch, "cpu")
    for d in range(4):
        got = tmesh.shard_batch(tb, types.SimpleNamespace(n_data=4,
                                                          data_index=d))
        dev = mesh.devices[d, 0]
        for path, x in jax.tree_util.tree_leaves_with_path(jb):
            key = [p.key for p in path]
            want = next(s.data for s in x.addressable_shards
                        if s.device == dev)
            node = got
            for k in key:
                node = node[k]
            np.testing.assert_array_equal(node.numpy(), np.asarray(want))
    xs = rng.randn(3, 8, 2).astype(np.float32)
    jx = jpar.shard_batch_stacked(jnp.asarray(xs), mesh)
    got = tmesh.shard_batch_stacked(
        {"x": torch.from_numpy(xs)},
        types.SimpleNamespace(n_data=4, data_index=1))["x"]
    want = next(s.data for s in jx.addressable_shards
                if s.device == mesh.devices[1, 0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def functions():
    return launch.spawn(ranks.functions_rank, (), 2, "cpu")


def test_copy_to_group_sums_the_gradient(functions):
    c = np.array([1.0, 2.0, 3.0])
    for r in functions:
        np.testing.assert_allclose(r["copy_grad"], c * 1 + c * 2)


def test_reduce_from_group_passes_the_gradient_once(functions):
    """Forward: the group's sum; backward: the gradient unchanged (not M
    times it, as torch.distributed.nn.functional.all_reduce gives)."""
    c = np.array([1.0, 2.0, 3.0])
    d = np.array([1.0, -1.0, 0.5])
    for rank, r in enumerate(functions):
        np.testing.assert_allclose(r["reduce_value"],
                                   1 * c * 1 + 2 * c * 2)
        np.testing.assert_allclose(r["reduce_grad"], c * (rank + 1) * d)


def test_replicate_shard_gather_round_trip(functions):
    a, b = functions
    for (k, x), (_, y) in zip(leaves(a["replicated"]),
                              leaves(b["replicated"])):
        np.testing.assert_array_equal(x, y, err_msg=k)
    w = a["replicated"]["speaker"]["logit"]["w"]
    np.testing.assert_array_equal(a["local_logit_w"], w[:, :13])
    np.testing.assert_array_equal(b["local_logit_w"], w[:, 13:])
    assert a["contiguous"] and b["contiguous"]
    for r in (a, b):
        for (k, x), (_, y) in zip(leaves(r["gathered"]),
                                  leaves(a["replicated"])):
            np.testing.assert_array_equal(x, y, err_msg=k)


def jax_xe_noise(key, B, K, H, D, T):
    """The uniforms of the JAX package's caption loss with dropout, in the
    port's order: the attention embedding's mask (encode_features, from the
    'xe' key), then each teacher-forced step's embedding and output masks
    (decoding.py:109-139)."""
    xe = jjoint._rngs(key)["xe"]
    out = [J.uniform(xe, (B, K, H))]
    k, _ = J.split(xe)
    for _ in range(T):
        k, _, _, r_emb, r_step = J.split(k, 5)
        out += [J.uniform(r_emb, (B, D)), J.uniform(r_step, (B, H))]
    return [np.asarray(x) for x in out]


@pytest.fixture(scope="module")
def single():
    """Per vocabulary: the params, a batch, JAX's noise and single-device
    loss, and the single-process port's gradients and params after one
    Adam step on that noise."""
    out = {}
    for V in VOCABS:
        topt = ranks.tiny_opt(vocab_size=V)
        jopt = JOptions(**vars(topt))
        params = {"speaker": jax.tree.map(np.asarray, jzoo.att_model
                                          .init_params(J.PRNGKey(V), jopt))}
        data = DataLoader(topt, dataset=ranks.tiny_dataset(topt)).get_batch(
            "train")
        B, K = data["att_feats"].shape[:2]
        key = J.PRNGKey(11)
        noise = jax_xe_noise(key, B, K, topt.rnn_size,
                             topt.input_encoding_size,
                             data["labels"].shape[1] - 1)
        jb = {k: jnp.asarray(data[k]) for k in
              ("fc_feats", "att_feats", "att_masks", "labels", "masks")}
        jloss, _ = jjoint.loss_fn(
            {"speaker": jzoo.setup(jopt, "att2in2", "caption_model")},
            jax.tree.map(jnp.asarray, params), jopt, jb, key,
            jjoint.Hyper.from_opt(jopt), "optimizer", jnp.zeros(B),
            train=True)
        tp = trainable(to_torch(params, "cpu"))
        hp = tjoint.Hyper.from_opt(topt)
        (loss, _), grads = tjoint.value_and_grad(topt, "optimizer")(
            tp, ranks.port_batch(data), ranks.replay_streams(noise), hp)
        OptimizerManager(topt, tp).step(tp, grads, "optimizer")
        out[V] = dict(params=params, data=data, noise=noise,
                      jax_loss=float(jloss), loss=float(loss),
                      grads={k: g.numpy() for k, g in leaves(grads)},
                      stepped={k: p.detach().numpy() for k, p in leaves(tp)})
    return out


@pytest.fixture(scope="module")
def mesh_steps(single):
    def cases(which):
        return {(shape, V): (shape, {"vocab_size": V}, single[V]["params"],
                             single[V]["data"], single[V]["noise"])
                for shape, V in which}
    out = {}
    for world, which in ((2, CASES2), (4, CASES4)):
        got = launch.spawn(ranks.step_rank, (cases(which),), world, "cpu")
        for key in got[0]:
            for r in got[1:]:  # every rank holds the same global results
                assert r[key]["loss"] == got[0][key]["loss"]
                assert r[key]["step_loss"] == got[0][key]["step_loss"]
            out[key] = got[0][key]
    return out


@pytest.mark.parametrize("case", CASES2 + CASES4)
def test_distributed_loss_matches_jax_single_device(single, mesh_steps,
                                                    case):
    got, ref = mesh_steps[case], single[case[1]]
    np.testing.assert_allclose(ref["loss"], ref["jax_loss"], rtol=LOSS_RTOL)
    for loss in (got["loss"], got["step_loss"], got["loss_cap"]):
        np.testing.assert_allclose(loss, ref["jax_loss"], rtol=LOSS_RTOL)
    if case[0][1] == 2:  # the matrix of this vocabulary splits on the axis
        assert got["sharded"] == (["speaker.logit.b", "speaker.logit.w"]
                                  if case[1] == 25 else ["speaker.embed"])


@pytest.mark.parametrize("case", CASES2 + CASES4)
def test_distributed_gradients_match_single_process(single, mesh_steps,
                                                    case):
    """Every gradient leaf, the slices' gathered, after the data group's
    sum."""
    want = single[case[1]]["grads"]
    got = dict(leaves(mesh_steps[case]["grads"]))
    assert set(got) == set(want)
    for k, g in want.items():
        np.testing.assert_allclose(got[k], g, err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("case", CASES2 + CASES4)
def test_distributed_adam_step_matches_single_process(single, mesh_steps,
                                                      case):
    """One guarded Adam update of make_distributed_train_step: taken on
    every rank (the flag over the world), the params those of the
    single-process step."""
    got = mesh_steps[case]
    assert got["ok"] and got["count"] == 1
    ref = single[case[1]]
    params = dict(leaves(got["params"]))
    moved = 0
    for k, want in ref["stepped"].items():
        g = ref["grads"][k]
        sure = (np.abs(g) > 1e-6) | (g == 0)
        np.testing.assert_allclose(params[k][sure], want[sure], rtol=0,
                                   atol=1e-6, err_msg=k)
        moved += int(sure.sum())
    assert moved > 0.9 * sum(x.size for x in ref["stepped"].values())


def test_a_rank_that_fails_fails_the_run():
    """The launcher kills the other rank (waiting in a collective) and
    re-raises the first error with its traceback."""
    with pytest.raises(RuntimeError,
                       match="(?s)rank 1 of 2 failed.*ValueError: planted"):
        launch.spawn(ranks.fail_on_rank_one, (), 2, "cpu", timeout=120)


def test_spawn_runs_on_the_card_unless_asked_for_the_cpu():
    """Like every entry point of the port, spawn's ranks default to the
    card: without one it raises, naming it, and starts no rank on the CPU
    in its place."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.spawn(ranks.fail_on_rank_one, (), 2)
