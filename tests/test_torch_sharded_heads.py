"""The vocab-sharded heads of the port (kernel C on each rank's slice of
the logit layer, the model group's all_gathers, `head_merge`) against the
JAX package's `beam_head_sharded` / `greedy_head_sharded`, and the merge's
plain version against the JAX merge lines (ops/pallas/beam_head.py:131-142).

JAX runs on the conftest's 8 CPU devices with make_mesh(4, 2) and the
Pallas kernel in interpret mode; the port on two ranks over gloo (a (1, 2)
mesh, tests/torch_mesh_ranks.py), where the kernels' plain versions run.
Exact ties are planted across the shard seam: they go to the lower global
id.  Tolerances: ids equal; vals and lse atol 1e-5 (f32 on both sides, JAX
at "highest" matmul precision).
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
    _dispatch, head_merge)
from cooperativeimagecaptioning_tpu_torch.parallel import launch  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402

MS = (1, 2, 5, 17)
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


def gathered_candidates(n, m, seed, v=20):
    """The model group's gathered candidates of a [R, n * v] logit matrix
    with ties across every seam: (vals [R, n*m], local idx [R, n*m], lse
    [n, R], v, the logits)."""
    rng = np.random.RandomState(seed)
    R = 6
    logits = rng.randn(R, n * v).astype(np.float32)
    for s in range(1, n):
        logits[:, [s * v - 1, s * v]] = 4.0  # a tie across the seam
    logits[:, [0, n * v - 1]] = 4.0
    x = torch.from_numpy(logits)
    vals, idx, lse = [], [], []
    for s in range(n):
        part = x[:, s * v:(s + 1) * v]
        top_v, top_i = torch.sort(part, dim=1, descending=True, stable=True)
        vals.append(top_v[:, :m])
        idx.append(top_i[:, :m].to(torch.int32))
        lse.append(torch.logsumexp(part, dim=1))
    return (torch.cat(vals, 1), torch.cat(idx, 1), torch.stack(lse), v,
            logits)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("m", MS)
def test_merge_plain_version_matches_the_jax_merge_lines(n, m):
    """head_merge_reference (and the CPU dispatch of head_merge) against
    beam_head.py:131-142: the shard offsets, lax.top_k over the gathered
    candidates, the logsumexp over the shards."""
    vals, idx, lse, v, logits = gathered_candidates(n, m, seed=n * 100 + m)
    jv, ji, jl = jnp.asarray(vals.numpy()), jnp.asarray(idx.numpy()), \
        jnp.asarray(lse.numpy())
    ji = ji + jnp.repeat(jnp.arange(n, dtype=jnp.int32) * v, m)[None]
    mx = jnp.max(jl, axis=0)
    want_lse = mx + jnp.log(jnp.sum(jnp.exp(jl - mx[None, :]), axis=0))
    want_v, sel = jax.lax.top_k(jv, m)
    want_i = jnp.take_along_axis(ji, sel, axis=1)
    for fn in (head_merge.head_merge_reference, head_merge.head_merge):
        got_v, got_i, got_lse = fn(vals, idx, lse, v, m)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), **TOL)
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                                   **TOL)
    # and the top-m of the whole rows, ties to the lower global id
    full = jax.lax.top_k(jnp.asarray(logits), m)[1]
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(full))


def test_merge_on_the_cpu_launches_nothing():
    _dispatch.reset_launches()
    vals, idx, lse, v, _ = gathered_candidates(2, 2, seed=0)
    head_merge.head_merge(vals, idx, lse, v, 2)
    assert _dispatch.launches()["head_merge"] == 0


@pytest.mark.parametrize("bad", ["shape", "m"])
def test_merge_refuses_what_it_does_not_take(bad):
    vals, idx, lse, v, _ = gathered_candidates(2, 2, seed=0)
    with pytest.raises(ValueError, match="head_merge"):
        if bad == "shape":
            head_merge.head_merge(vals[:, :3], idx[:, :3], lse, v, 2)
        else:
            head_merge.head_merge(vals, idx, lse, 1, 2)
