"""Shapes the JAX package takes without a limit, held in the port against it
on the CPU in float32, at small width (H = A <= 32, vocab 120):

* attention over K = 100 and 196 slots (the repo's own 14 x 14 feature
  grid), b-major, int8 and K-major, masked and unmasked: the port's plain
  versions and a replay of the stream kernel's order of operations
  (tests/test_torch_att_stream.py) against the JAX references and Pallas
  kernels (interpret mode), atol = rtol = 1e-5;
* beam search with 20 beams (the beam head's kk = 20, or 21 with
  decoding_constraint, above the kernel's 16-long lists): ids bit-equal to
  the JAX package's, log-probs within 1e-5;
* a CPU CaptioningService with max_att_len=196 over a JAX-written run dir:
  ids equal to the JAX service's;
* a run dir whose checkpoint lacks leaves (the att_bn running statistics of
  an older run): both services fill them from their templates and give the
  same captions.
"""

import os
import pickle

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cooperativeimagecaptioning_tpu import serving as jserving  # noqa: E402
from cooperativeimagecaptioning_tpu.models import att_model as jatt  # noqa: E402
from cooperativeimagecaptioning_tpu.ops import decoding as jdec  # noqa: E402
from cooperativeimagecaptioning_tpu.ops.pallas import att_step as jstep  # noqa: E402
from cooperativeimagecaptioning_tpu.training import checkpoint as jckpt  # noqa: E402
from cooperativeimagecaptioning_tpu_torch import serving as tserving  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.ops import decoding as tdec  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.ops.kernels import (  # noqa: E402
    _dispatch, att_step)
from test_torch_att_model import TOL, both, jax_params, tiny_opt  # noqa: E402
from test_torch_att_stream import ORDER, case, run_replay  # noqa: E402

LAYOUTS = ("bmajor", "int8", "kmajor")


def _port_and_jax(a, layout):
    """(port plain version, JAX reference, JAX Pallas kernel in interpret
    mode) of one case in one context layout."""
    t = [None if a[k] is None else torch.from_numpy(a[k]) for k in ORDER]
    j = [None if a[k] is None else jnp.asarray(a[k]) for k in ORDER]
    use_mask = a["masks"] is not None
    if layout == "int8":
        q = att_step.quantize_features(t[1], t[2])
        jq = jstep.quantize_features(j[1], j[2])
        return (att_step.fused_attention_q(t[0], *q, *t[3:]),
                jstep.attention_reference_q(j[0], *jq, *j[3:]),
                jstep._attention_pallas_q(j[0], *jq, *j[3:7], j[7],
                                          use_mask=use_mask, interpret=True))
    if layout == "kmajor":
        tt = [t[0], t[1].movedim(0, 1).contiguous(),
              t[2].movedim(0, 1).contiguous(), *t[3:]]
        jt = [j[0], jnp.swapaxes(j[1], 0, 1), jnp.swapaxes(j[2], 0, 1),
              *j[3:]]
        return (att_step.fused_attention_kmajor(*tt),
                jstep.attention_reference(*j),
                jstep._attention_pallas_kmajor(*jt[:7], jt[7],
                                               use_mask=use_mask,
                                               interpret=True))
    return (att_step.fused_attention(*t), jstep.attention_reference(*j),
            jstep._attention_pallas(*j[:7], j[7], use_mask=use_mask,
                                    interpret=True))


@pytest.mark.parametrize("mask", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("K", [100, 196])
def test_attention_over_many_slots_matches_jax(K, layout, mask):
    a = case(5, K, 32, 32, mask, seed=K)
    got, want_ref, want_kernel = _port_and_jax(a, layout)
    np.testing.assert_allclose(np.asarray(want_ref), got.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(want_kernel), got.numpy(), **TOL)
    assert _dispatch.launches() == {k: 0 for k in _dispatch.KERNELS}


@pytest.mark.parametrize("mask", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("K", [100, 196])
def test_stream_replay_over_many_slots_matches_jax(K, layout, mask):
    """The kernels' order of operations at K above the old 64-slot limit:
    the softmax's K in strides of 32 lanes, the mask and the int8 scales
    from the side rows."""
    a = case(4, K, 32, 32, mask, seed=K + 1)
    got = run_replay(a, layout == "kmajor", None, None,
                     quant=layout == "int8")
    _, want_ref, want_kernel = _port_and_jax(a, layout)
    np.testing.assert_allclose(np.asarray(want_ref), got.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(want_kernel), got.numpy(), **TOL)


def test_the_slot_limit_covers_the_feature_grid():
    """MAX_K (the CUDA launch's limit) holds the repo's own 196-slot
    features with room, and a stream plan at MAX_K fits a block."""
    assert att_step.MAX_K >= 196
    for itemsize in (4, 2, 1):
        plan = att_step.stream_plan(512, att_step.MAX_K, 512, 512, itemsize,
                                    False)
        assert plan.smem_bytes <= att_step.MAX_SMEM


@pytest.mark.parametrize("constraint", [0, 1])
def test_beam_search_of_twenty_beams_matches_jax(constraint):
    """beam_size 20: the beam head's kk is 20 (21 with the constraint), past
    the 16-long lists of one kernel round; the JAX head takes any m."""
    opt = tiny_opt()
    p = jax_params(opt, seed=20)
    rng = np.random.RandomState(20)
    att = rng.randn(3, 6, opt.att_feat_size).astype(np.float32)
    masks = np.ones((3, 6), np.float32)
    masks[1, 3:] = 0.0
    jp, tp = both(p)
    jctx = jatt.encode_features(jp, None, jnp.asarray(att), jnp.asarray(masks))
    tctx = tp.encode_features(None, torch.from_numpy(att),
                              torch.from_numpy(masks))
    jout = jdec.beam_search(jatt, jp, jctx, opt.seq_length, 20,
                            decoding_constraint=constraint)
    tout = tdec.beam_search(tp, tctx, opt.seq_length, 20,
                            decoding_constraint=constraint)
    np.testing.assert_array_equal(np.asarray(jout.seq), tout.seq.numpy())
    np.testing.assert_allclose(np.asarray(jout.logprobs),
                               tout.logprobs.numpy(), **TOL)


def _write_run_dir(d, opt, params, drop=()):
    """A JAX-written run dir; `drop`: (subtree, leaf) pairs of the speaker
    left out of its checkpoint."""
    params = {k: dict(v) if isinstance(v, dict) else v
              for k, v in params.items()}
    for sub, leaf in drop:
        params[sub] = dict(params[sub])
        del params[sub][leaf]
    jckpt.save_params({"speaker": params}, str(d / "model-best.pth"))
    vocab = {str(i): f"w{i}" for i in range(1, opt.vocab_size + 1)}
    with open(d / "infos_.pkl", "wb") as f:
        pickle.dump({"opt": opt, "vocab": vocab}, f)
    return str(d)


def _request(opt, n, k, seed):
    rng = np.random.RandomState(seed)
    fc = rng.randn(n, opt.fc_feat_size).astype(np.float32)
    att = rng.randn(n, k, opt.att_feat_size).astype(np.float32)
    masks = np.ones((n, k), np.float32)
    masks[::3, k // 2:] = 0.0
    return fc, att, masks


@pytest.mark.parametrize("beam", [0, 2])
def test_service_of_196_slots_matches_jax(tmp_path, beam):
    opt = tiny_opt(checkpoint_path=str(tmp_path))
    d = _write_run_dir(tmp_path, opt, jax_params(opt, seed=196))
    kw = dict(beam_size=beam, buckets=(1, 8), compute_dtype="float32",
              max_att_len=196)
    jsvc = jserving.CaptioningService.from_run_dir(d, **kw)
    tsvc = tserving.CaptioningService.from_run_dir(d, device="cpu", **kw)
    assert tsvc.max_att_len == 196
    fc, att, masks = _request(opt, 5, 196, seed=beam)
    got = tsvc.caption_ids(fc, att, masks)
    np.testing.assert_array_equal(got, np.asarray(jsvc.caption_ids(fc, att,
                                                                   masks)))
    assert len(np.unique(got)) > 2  # not a constant decode


@pytest.mark.parametrize("beam", [0, 2])
def test_checkpoint_missing_leaves_loads_in_both_services(tmp_path, beam,
                                                          capsys):
    """An older run's checkpoint without the att_bn running statistics: both
    services restore into a template of the run's opt, report the missing
    leaves and fill them (mean 0, var 1 in both packages), and caption
    alike; the opt's checkpoint_path points at the run dir, on a copy."""
    opt = tiny_opt(use_bn=1, checkpoint_path="/elsewhere/train_machine")
    d = _write_run_dir(tmp_path, opt, jax_params(opt, seed=7),
                       drop=(("att_bn", "mean"), ("att_bn", "var")))
    kw = dict(beam_size=beam, buckets=(8,), compute_dtype="float32",
              max_att_len=6)
    tsvc = tserving.CaptioningService.from_run_dir(d, device="cpu", **kw)
    said = capsys.readouterr().out
    assert "att_bn.mean not in loaded checkpoint" in said
    assert "att_bn.var not in loaded checkpoint" in said
    assert tsvc.opt.checkpoint_path == d
    with open(os.path.join(d, "infos_.pkl"), "rb") as f:
        assert pickle.load(f)["opt"].checkpoint_path != d
    np.testing.assert_array_equal(
        tsvc.speaker.params.att_bn.var.numpy(), np.ones(opt.att_feat_size))
    jsvc = jserving.CaptioningService.from_run_dir(d, **kw)
    fc, att, masks = _request(opt, 7, 6, seed=beam + 10)
    assert tsvc.caption(fc, att, masks) == jsvc.caption(fc, att, masks)
