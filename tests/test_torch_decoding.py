"""Port parity: greedy decode and beam search of the PyTorch port against
the JAX package on the CPU, same params and features, float32.  Ids must be
exactly equal; logprobs within atol = rtol = 1e-5."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cooperativeimagecaptioning_tpu.models import att_model as jatt  # noqa: E402
from cooperativeimagecaptioning_tpu.ops import decoding as jdec  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.ops import decoding as tdec  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.ops.kernels import beam_head  # noqa: E402
from test_torch_att_model import (  # noqa: E402
    TOL, both, features, jax_params, tiny_opt)


def contexts(opt, seed=0, B=7, K=6):
    p = jax_params(opt, seed=seed)
    att, masks = features(opt, B=B, K=K, seed=seed)
    jp, tp = both(p)
    jctx = jatt.encode_features(jp, None, jnp.asarray(att), jnp.asarray(masks))
    tctx = tp.encode_features(None, torch.from_numpy(att),
                              torch.from_numpy(masks))
    return jp, tp, jctx, tctx


@pytest.mark.parametrize("constraint", [0, 1])
@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_matches_jax(constraint, seed):
    opt = tiny_opt()
    jp, tp, jctx, tctx = contexts(opt, seed=seed)
    jout = jdec.sample(jatt, jp, jctx, opt.seq_length, jax.random.PRNGKey(0),
                       mode="greedy", decoding_constraint=constraint)
    tout = tdec.sample(tp, tctx, opt.seq_length, mode="greedy",
                       decoding_constraint=constraint)
    assert tout.seq.dtype == torch.int32
    assert tout.seq.shape == (7, opt.seq_length)
    np.testing.assert_array_equal(np.asarray(jout.seq), tout.seq.numpy())
    np.testing.assert_allclose(np.asarray(jout.logprobs),
                               tout.logprobs.numpy(), **TOL)
    # the words actually vary (the test is not of a constant decode)
    assert len(np.unique(tout.seq.numpy())) > 3


@pytest.mark.parametrize("constraint", [0, 1])
@pytest.mark.parametrize("beam", [2, 3, 5])
def test_beam_matches_jax(beam, constraint):
    opt = tiny_opt()
    jp, tp, jctx, tctx = contexts(opt, seed=beam)
    jout = jdec.beam_search(jatt, jp, jctx, opt.seq_length, beam,
                            decoding_constraint=constraint)
    tout = tdec.beam_search(tp, tctx, opt.seq_length, beam,
                            decoding_constraint=constraint)
    assert tout.seq.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jout.seq), tout.seq.numpy())
    np.testing.assert_allclose(np.asarray(jout.logprobs),
                               tout.logprobs.numpy(), **TOL)


def test_constraint_forbids_immediate_repeats():
    opt = tiny_opt()
    _, tp, _, tctx = contexts(opt)
    seq = tdec.sample(tp, tctx, opt.seq_length,
                      decoding_constraint=1).seq.numpy()
    live = (seq[:, 1:] > 0) & (seq[:, :-1] > 0)
    assert not np.any((seq[:, 1:] == seq[:, :-1]) & live)


def test_unknown_sampling_mode_raises():
    """All seven modes of the JAX package are ported
    (tests/test_torch_sampling.py); any other name is refused, as there."""
    opt = tiny_opt()
    _, tp, _, tctx = contexts(opt)
    with pytest.raises(ValueError, match="unknown sampling mode"):
        tdec.sample(tp, tctx, opt.seq_length, mode="beam")


def test_beam_expansion_is_repeat_interleave():
    """jnp.repeat(x, m, axis=0) repeats each row in place."""
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    got = tdec._expand_for_beams({"a": torch.from_numpy(x), "n": None}, 2)
    np.testing.assert_array_equal(got["a"].numpy(),
                                  np.asarray(jnp.repeat(jnp.asarray(x), 2, 0)))
    assert got["n"] is None


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_top_k_tie_order_matches_lax(k):
    """Planted exact ties: the lower index comes first, as in lax.top_k."""
    rng = np.random.RandomState(k)
    x = rng.randint(0, 4, size=(6, 9)).astype(np.float32)  # many ties
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    tv, ti = beam_head.top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
