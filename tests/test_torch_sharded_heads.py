"""The vocab-sharded heads of the port (kernel C on each rank's slice of
the logit layer writing one record a row, the model group's one all_gather
of the records, `head_merge`) against the JAX package's
`beam_head_sharded` / `greedy_head_sharded`, and the merge's plain version
in its three modes -- beam, greedy, argmax -- against the JAX merge lines
(ops/pallas/beam_head.py:131-142, logit_head.py:213) and torch.argmax.

JAX runs on the conftest's 8 CPU devices with make_mesh(4, 2) and the
Pallas kernel in interpret mode; the port on two ranks over gloo (a (1, 2)
mesh, tests/torch_mesh_ranks.py), where the kernels' plain versions run,
each call under `collectives.Recording`: one all_gather a call.  Exact
ties are planted across the shard seam: they go to the lower global id;
-inf candidates come last.  Tolerances: ids equal; vals and lse atol 1e-5
(f32 on both sides, JAX at "highest" matmul precision).  The greedy mode's
lp is the beam mode's vals[:, 0] - lse bit for bit; against JAX it is equal
at n = 1 and within 1e-5 beyond (XLA's CPU exp and log differ from
PyTorch's in the last bit on a few rows).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cooperativeimagecaptioning_tpu.ops.pallas import beam_head as jbeam  # noqa: E402
from cooperativeimagecaptioning_tpu.ops.pallas import logit_head as jlogit  # noqa: E402
from cooperativeimagecaptioning_tpu.parallel import make_mesh  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.ops.kernels import (  # noqa: E402
    _dispatch, beam_head, head_merge)
from cooperativeimagecaptioning_tpu_torch.parallel import launch  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402

MS = (1, 2, 5, 17)
MERGE_MS = (1, 2, 5, 17, 32)
V1 = 40          # logit width: two slices of 20, each holding a top-17
TIES = (2, 19, 20, 21, 39)  # 19 | 20 is the shard seam
TOL = dict(atol=1e-5, rtol=0)


def head_inputs(seed=3, B=8, H=32):
    rng = np.random.RandomState(seed)
    h = rng.randn(B, H).astype(np.float32)
    w = (rng.randn(H, V1) * 0.2).astype(np.float32)
    b = (rng.randn(V1) * 0.2).astype(np.float32)
    w[:, list(TIES)] = 0.0
    b[list(TIES)] = 5.0  # above every other logit: the top of each row
    return h, w, b


@pytest.fixture(scope="module")
def port_heads():
    h, w, b = head_inputs()
    got = launch.spawn(ranks.heads_rank, (h, w, b, MS), 2, "cpu")
    return (h, w, b), got


@pytest.fixture(scope="module")
def jax_heads():
    h, w, b = (jnp.asarray(x) for x in head_inputs())
    mesh = make_mesh(n_data=4, n_model=2)
    beam = {m: jbeam.beam_head_sharded(h, w, b, m, mesh, interpret=True)
            for m in MS}
    greedy = jlogit.greedy_head_sharded(h, w, b, mesh, interpret=True)
    return beam, greedy


@pytest.mark.parametrize("m", MS)
def test_beam_head_sharded_matches_jax(port_heads, jax_heads, m):
    _, got = port_heads
    want_v, want_i, want_lse = (np.asarray(x) for x in jax_heads[0][m])
    for rank in got:  # both ranks of the model group hold the result
        vals, idx, lse = rank["beam"][m]
        np.testing.assert_array_equal(idx, want_i)
        np.testing.assert_allclose(vals, want_v, **TOL)
        np.testing.assert_allclose(lse, want_lse, **TOL)
    n = min(m, len(TIES))
    assert (got[0]["beam"][m][1][:, :n] == np.array(TIES[:n])).all()


def test_greedy_head_sharded_matches_jax(port_heads, jax_heads):
    _, got = port_heads
    want_it, want_lp = (np.asarray(x) for x in jax_heads[1])
    for rank in got:
        it, lp = rank["greedy"]
        np.testing.assert_array_equal(it, want_it)
        np.testing.assert_allclose(lp, want_lp, **TOL)
    assert (got[0]["greedy"][0] == TIES[0]).all()


@pytest.mark.parametrize("call", [*MS, "greedy", "argmax"])
def test_one_all_gather_a_sharded_head_call(port_heads, call):
    """Each G call (beam_head at m), each H call (greedy_head) and each
    categorical draw over the slices (vocab.argmax) runs exactly one
    collective: an all_gather of the [R, W] records along dim 0."""
    (h, w, b), got = port_heads
    R = h.shape[0]
    width = {"greedy": 3, "argmax": 2}.get(call) or 2 * call + 1
    for rank in got:
        assert rank["ops"][call] == [("all_gather", (0, 1), (R, width),
                                      "torch.float32", 0)]
    if call == "argmax":
        want = np.argmax(h @ w + b, axis=1)
        for rank in got:
            np.testing.assert_array_equal(rank["argmax"], want)


def test_the_dispatchers_route_to_the_sharded_path_with_a_mesh(port_heads):
    """With a vocab mesh registered, a slice of the logit layer takes
    beam_head_sharded (the greedy head at m = 1); the whole layer and an
    unregistered mesh keep the local path (test_pallas_interpret.py's
    dispatcher test)."""
    _, got = port_heads
    for rank in got:
        assert rank["calls"]["registered"] == list(MS) + [1]
        assert rank["calls"]["whole"] == rank["calls"]["registered"]
        assert rank["calls"]["cleared"] == rank["calls"]["registered"]


def gathered_records(n, m, seed, v=40, mode="beam"):
    """The model group's gathered records of a [R, n * v] logit matrix with
    exact ties across every seam and -inf entries in the last shard:
    (records [n, R, W], v, the logits)."""
    rng = np.random.RandomState(seed)
    R = 6
    logits = rng.randn(R, n * v).astype(np.float32)
    for s in range(1, n):
        logits[:, [s * v - 1, s * v]] = 4.0  # a tie across the seam
    logits[:, [0, n * v - 1]] = 4.0
    logits[:, n * v - 1 - v // 2:n * v - 1] = -np.inf
    x = torch.from_numpy(logits)
    recs = []
    for s in range(n):
        part = x[:, s * v:(s + 1) * v]
        if mode == "argmax":
            val, i = part.max(dim=1)
            recs.append(head_merge.records(val[:, None], i[:, None]))
        else:
            top_v, top_i = beam_head.top_k(part, m)
            recs.append(head_merge.records(top_v, top_i,
                                           torch.logsumexp(part, dim=1)))
    return torch.stack(recs), v, logits


def jax_merge(recs, v, m):
    """The JAX merge lines (beam_head.py:131-142) on the same candidates:
    (vals, global idx, lse)."""
    n = recs.shape[0]
    r = recs.numpy()
    jv = jnp.asarray(np.concatenate(list(r[..., :m]), axis=1))
    ji = jnp.asarray(np.concatenate(list(r[..., m:2 * m].view(np.int32)),
                                    axis=1))
    jl = jnp.asarray(r[..., 2 * m])
    ji = ji + jnp.repeat(jnp.arange(n, dtype=jnp.int32) * v, m)[None]
    mx = jnp.max(jl, axis=0)
    lse = mx + jnp.log(jnp.sum(jnp.exp(jl - mx[None, :]), axis=0))
    tv, sel = jax.lax.top_k(jv, m)
    return tv, jnp.take_along_axis(ji, sel, axis=1), lse


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("m", MERGE_MS)
def test_merge_plain_version_matches_the_jax_merge_lines(n, m):
    """head_merge_reference (and the CPU dispatch of head_merge) in the
    beam mode against beam_head.py:131-142: the shard offsets, lax.top_k
    over the gathered candidates, the logsumexp over the shards."""
    recs, v, logits = gathered_records(n, m, seed=n * 100 + m)
    want_v, want_i, want_lse = (np.asarray(x) for x in jax_merge(recs, v, m))
    for fn in (head_merge.head_merge_reference, head_merge.head_merge):
        got_v, got_i, got_lse = fn(recs, v, m)
        assert got_i.dtype == torch.int32
        np.testing.assert_array_equal(got_i.numpy(), want_i)
        np.testing.assert_allclose(got_v.numpy(), want_v, **TOL)
        np.testing.assert_allclose(got_lse.numpy(), want_lse, **TOL)
    # and the top-m of the whole rows, ties to the lower global id
    full = jax.lax.top_k(jnp.asarray(logits), m)[1]
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(full))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_merge_greedy_mode_matches_jax_greedy_head_sharded(n):
    """The greedy mode against the JAX greedy head's merge
    (logit_head.py:213: idx[:, 0], vals[:, 0] - lse on the merged
    candidates): ids equal; lp bit-equal to the beam mode's vals[:, 0] -
    lse, to JAX's at n = 1, within TOL beyond."""
    recs, v, logits = gathered_records(n, 1, seed=n)
    jv, ji, jl = jax_merge(recs, v, 1)
    want_it, want_lp = np.asarray(ji[:, 0]), np.asarray(jv[:, 0] - jl)
    vals, _, lse = head_merge.head_merge(recs, v, 1)
    for fn in (head_merge.head_merge_reference, head_merge.head_merge):
        it, lp = fn(recs, v, 1, "greedy")
        assert it.dtype == torch.int32 and lp.dtype == torch.float32
        np.testing.assert_array_equal(it.numpy(), want_it)
        np.testing.assert_array_equal(it.numpy(), logits.argmax(axis=1))
        assert torch.equal(lp, vals[:, 0] - lse)
        if n == 1:
            np.testing.assert_array_equal(lp.numpy(), want_lp)
        np.testing.assert_allclose(lp.numpy(), want_lp, **TOL)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_merge_argmax_mode_matches_torch_argmax(n):
    """The argmax mode on [val | local id] records against torch.argmax of
    the whole rows (the first maximum: ties across the seam to the lower
    global id), int64."""
    recs, v, logits = gathered_records(n, 1, seed=10 + n, mode="argmax")
    want = torch.argmax(torch.from_numpy(logits), dim=1)
    for fn in (head_merge.head_merge_reference, head_merge.head_merge):
        got = fn(recs, v, 1, "argmax")
        assert got.dtype == torch.int64
        assert torch.equal(got, want)


def test_records_hold_the_ids_as_int32_bits():
    """A record is [vals m | ids m | lse] with the ids' int32 bits (not
    their float values), and the CPU path of kernel C writes the records
    of its plain version."""
    rng = np.random.RandomState(5)
    h, w, b = (torch.from_numpy(rng.randn(*s).astype(np.float32))
               for s in ((4, 8), (8, 30), (30,)))
    vals, idx, lse = beam_head.beam_head_reference(h, w, b, 3)
    rec = beam_head.local_beam_head(h, w, b, 3, as_records=True)
    assert rec.shape == (4, 7) and rec.dtype == torch.float32
    assert torch.equal(rec[:, :3], vals) and torch.equal(rec[:, 6], lse)
    assert torch.equal(rec[:, 3:6].view(torch.int32), idx)
    assert torch.equal(rec, head_merge.records(vals, idx, lse))


@pytest.mark.parametrize("mode", sorted(head_merge.MODES))
def test_merge_on_the_cpu_launches_nothing(mode):
    _dispatch.reset_launches()
    recs, v, _ = gathered_records(2, 1, seed=0, mode=mode)
    head_merge.head_merge(recs, v, 1, mode)
    assert _dispatch.launches()["head_merge"] == 0


@pytest.mark.parametrize("bad", ["shape", "m", "mode", "greedy_m"])
def test_merge_refuses_what_it_does_not_take(bad):
    recs, v, _ = gathered_records(2, 2, seed=0)
    with pytest.raises(ValueError, match="head_merge"):
        if bad == "shape":
            head_merge.head_merge(recs[:, :, :3], v, 2)
        elif bad == "m":
            head_merge.head_merge(recs, 1, 2)
        elif bad == "mode":
            head_merge.head_merge(recs, v, 2, "top")
        else:
            head_merge.head_merge(recs, v, 2, "greedy")
