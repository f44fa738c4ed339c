"""Port parity of the two decode-only attention layouts, int8 and K-major:
the port's plain versions (what a CPU tensor takes) against the JAX
package's Pallas kernels in interpret mode and its references, the
quantizer, the gradient of the quantized call, `AttModel.step` on each
context, and greedy and beam ids through `decoding`.  CPU, float32, small
width; inputs from a numpy seed.

Tolerances: outputs atol 1e-5 (both sides f32; JAX at "highest" matmul
precision), int8 values and ids exactly equal, scales rtol 1e-6, gradients
rtol 1e-4 (atol 1e-5)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cooperativeimagecaptioning_tpu.models import att_model as jatt  # noqa: E402
from cooperativeimagecaptioning_tpu.ops import decoding as jdec  # noqa: E402
from cooperativeimagecaptioning_tpu.ops.pallas import att_step as jstep  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.ops import decoding as tdec  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.ops.kernels import (  # noqa: E402
    _dispatch, att_step)
from test_torch_att_model import TOL, both, features, jax_params, tiny_opt  # noqa: E402
from test_torch_kernels import ATT_ORDER, as_torch, att_case  # noqa: E402

ATOL = dict(atol=1e-5, rtol=0)
LAYOUTS = ("plain", "int8", "kmajor")


def _jax_args(a):
    return [None if a[k] is None else jnp.asarray(a[k]) for k in ATT_ORDER]


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_features_matches_jax(seed):
    a = att_case(seed=seed)
    # a zero row exercises the 1e-12 floor of the scale
    a["emb"][2, 1] = 0.0
    want = jstep.quantize_features(jnp.asarray(a["emb"]),
                                   jnp.asarray(a["p_att"]))
    got = att_step.quantize_features(torch.from_numpy(a["emb"]),
                                     torch.from_numpy(a["p_att"]))
    assert [t.dtype for t in got] == [torch.int8, torch.float32,
                                      torch.int8, torch.float32]
    for w, g, is_q in zip(want, got, (True, False, True, False)):
        if is_q:
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
        else:
            np.testing.assert_allclose(np.asarray(w), g.numpy(), rtol=1e-6,
                                       atol=0)
    back = att_step.dequantize_features(*got)
    jback = jstep.dequantize_features(*want)
    for w, g in zip(jback, back):
        np.testing.assert_allclose(np.asarray(w), g.numpy(), rtol=1e-6,
                                   atol=0)
    # the stated error bound: 1/254 of the row's largest magnitude
    err = np.abs(back[0].numpy() - a["emb"])
    assert (err <= np.abs(a["emb"]).max(-1, keepdims=True) / 254 + 1e-7).all()


@pytest.mark.parametrize("mask", ["none", "partial"])
def test_attention_q_matches_jax_kernel(mask):
    a = att_case(mask=mask)
    h, emb, p_att, *weights, masks = _jax_args(a)
    q = jstep.quantize_features(emb, p_att)
    want_kernel = jstep._attention_pallas_q(
        h, *q, *weights, masks, use_mask=masks is not None, interpret=True)
    want_ref = jstep.attention_reference_q(h, *q, *weights, masks)
    th, temb, tp, *tweights, tmasks = as_torch(a)
    tq = att_step.quantize_features(temb, tp)
    got = att_step.fused_attention_q(th, *tq, *tweights, tmasks)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(want_kernel), got.numpy(), **ATOL)
    np.testing.assert_allclose(np.asarray(want_ref), got.numpy(), **ATOL)
    np.testing.assert_array_equal(
        got.numpy(),
        att_step.attention_reference_q(th, *tq, *tweights, tmasks).numpy())
    assert _dispatch.launches()["attention_q"] == 0


@pytest.mark.parametrize("mask", ["none", "partial"])
def test_attention_kmajor_matches_jax_kernel(mask):
    a = att_case(mask=mask)
    h, emb, p_att, *weights, masks = _jax_args(a)
    emb_t, p_t = jnp.moveaxis(emb, 0, 1), jnp.moveaxis(p_att, 0, 1)
    want_kernel = jstep._attention_pallas_kmajor(
        h, emb_t, p_t, *weights, masks, use_mask=masks is not None,
        block_b=8, interpret=True)
    want_ref = jstep.attention_reference_kmajor(h, emb_t, p_t, *weights,
                                                masks)
    th, temb, tp, *tweights, tmasks = as_torch(a)
    targs = (th, temb.movedim(0, 1).contiguous(),
             tp.movedim(0, 1).contiguous(), *tweights, tmasks)
    got = att_step.fused_attention_kmajor(*targs)
    np.testing.assert_allclose(np.asarray(want_kernel), got.numpy(), **ATOL)
    np.testing.assert_allclose(np.asarray(want_ref), got.numpy(), **ATOL)
    # the same arithmetic as the b-major plain version, other layout (the
    # strided sums may round differently)
    np.testing.assert_allclose(
        got.numpy(), att_step.attention_reference(*as_torch(a)).numpy(),
        atol=1e-6, rtol=0)
    assert _dispatch.launches()["attention_kmajor"] == 0


@pytest.mark.parametrize("mask", ["none", "partial"])
def test_attention_q_gradients_match_jax(mask):
    """The custom_vjp of the quantized call: gradients to h and the four
    weights through the dequantized reference."""
    a = att_case(mask=mask)
    h, emb, p_att, wh, bh, wa, ba, masks = _jax_args(a)
    q = jstep.quantize_features(emb, p_att)

    def jloss(h, wh, bh, wa, ba):
        return jnp.sum(jnp.square(
            jstep.fused_attention_q(h, *q, wh, bh, wa, ba, masks)))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(h, wh, bh, wa, ba)
    th, temb, tp, twh, tbh, twa, tba, tmasks = as_torch(a)
    tq = att_step.quantize_features(temb, tp)
    live = [t.requires_grad_(True) for t in (th, twh, tbh, twa, tba)]
    out = att_step.fused_attention_q(live[0], *tq, *live[1:], tmasks)
    assert isinstance(out.grad_fn, att_step.Attention._backward_cls)
    got = torch.autograd.grad(out.square().sum(), live)
    # b_alpha shifts every score alike, so its exact gradient is 0 and both
    # sides hold rounding noise there: atol covers it
    for w, g in zip(want, got):
        np.testing.assert_allclose(np.asarray(w), g.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_attention_kmajor_is_decode_only():
    th, temb, tp, *tweights, tmasks = as_torch(att_case())
    with pytest.raises(RuntimeError, match="forward-only"):
        att_step.fused_attention_kmajor(
            th.requires_grad_(True), temb.movedim(0, 1).contiguous(),
            tp.movedim(0, 1).contiguous(), *tweights, tmasks)


def _contexts(opt, layout, seed=0, B=7, K=6):
    p = jax_params(opt, seed=seed)
    att, masks = features(opt, B=B, K=K, seed=seed)
    jp, tp = both(p)
    jctx = jatt.encode_features(jp, None, jnp.asarray(att), jnp.asarray(masks))
    tctx = tp.encode_features(None, torch.from_numpy(att),
                              torch.from_numpy(masks))
    if layout == "int8":
        jctx, tctx = jatt.quantize_ctx(jctx), tp.quantize_ctx(tctx)
    elif layout == "kmajor":
        jctx, tctx = jatt.kmajor_ctx(jctx), tp.kmajor_ctx(tctx)
    return jp, tp, jctx, tctx


@pytest.mark.parametrize("layout", LAYOUTS)
def test_step_matches_jax_on_each_context(layout):
    opt = tiny_opt()
    jp, tp, jctx, tctx = _contexts(opt, layout)
    assert set(jctx) == set(tctx)
    for k in jctx:
        assert tuple(jctx[k].shape) == tuple(tctx[k].shape), k
    rng = np.random.RandomState(3)
    B = 7
    h = rng.randn(B, opt.rnn_size).astype(np.float32)
    c = rng.randn(B, opt.rnn_size).astype(np.float32)
    xt = rng.randn(B, opt.input_encoding_size).astype(np.float32)
    (jh, jc), jout = jatt.step(jp, jctx, (jnp.asarray(h), jnp.asarray(c)),
                               jnp.asarray(xt))
    with torch.no_grad():
        (th, tc), tout = tp.step(tctx, (torch.from_numpy(h),
                                        torch.from_numpy(c)),
                                 torch.from_numpy(xt))
    for w, g in ((jh, th), (jc, tc), (jout, tout)):
        np.testing.assert_allclose(np.asarray(w), g.numpy(), **TOL)


@pytest.mark.parametrize("layout", ["int8", "kmajor"])
@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_ids_match_jax_on_each_context(layout, seed):
    opt = tiny_opt()
    jp, tp, jctx, tctx = _contexts(opt, layout, seed=seed)
    jout = jdec.sample(jatt, jp, jctx, opt.seq_length, jax.random.PRNGKey(0),
                       mode="greedy")
    with torch.no_grad():
        tout = tdec.sample(tp, tctx, opt.seq_length, mode="greedy")
    np.testing.assert_array_equal(np.asarray(jout.seq), tout.seq.numpy())
    np.testing.assert_allclose(np.asarray(jout.logprobs),
                               tout.logprobs.numpy(), **TOL)
    assert len(np.unique(tout.seq.numpy())) > 3


@pytest.mark.parametrize("layout", ["int8", "kmajor"])
@pytest.mark.parametrize("beam", [2, 3])
def test_beam_ids_match_jax_on_each_context(layout, beam):
    opt = tiny_opt()
    jp, tp, jctx, tctx = _contexts(opt, layout, seed=beam)
    jout = jdec.beam_search(jatt, jp, jctx, opt.seq_length, beam)
    with torch.no_grad():
        tout = tdec.beam_search(tp, tctx, opt.seq_length, beam)
    np.testing.assert_array_equal(np.asarray(jout.seq), tout.seq.numpy())
    np.testing.assert_allclose(np.asarray(jout.logprobs),
                               tout.logprobs.numpy(), **TOL)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_beam_expansion_axes(layout):
    """Entries ending in `_t` repeat along axis 1, every other entry (the
    mask and the int8 scales included) along axis 0; results contiguous."""
    opt = tiny_opt()
    _, _, jctx, tctx = _contexts(opt, layout, B=4)
    got = tdec._expand_for_beams(tctx, 2)
    assert set(got) == set(jctx)
    for k, v in tctx.items():
        want = jnp.repeat(jnp.asarray(v.numpy()), 2,
                          axis=1 if k.endswith("_t") else 0)
        np.testing.assert_array_equal(np.asarray(want), got[k].numpy())
        assert got[k].is_contiguous()
    assert tdec._batch_size(tctx) == 4 and tdec._batch_size(got) == 8
