"""Reference-checkpoint interop of the port (utils/torch_interop.py)
against the JAX package's: a reference-layout state_dict (the JAX package's
export of JAX-initialized params) converts to the same tree, the port's
export equals the JAX package's, the round trip through a .pth holds, and
the converted params decode the same ids in the port as in JAX (f32)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cooperativeimagecaptioning_tpu import config as jconfig  # noqa: E402
from cooperativeimagecaptioning_tpu.models import att_model as jatt  # noqa: E402
from cooperativeimagecaptioning_tpu.models import fc_model as jfc  # noqa: E402
from cooperativeimagecaptioning_tpu.ops import decoding as jdec  # noqa: E402
from cooperativeimagecaptioning_tpu.training import joint as jjoint  # noqa: E402
from cooperativeimagecaptioning_tpu.utils import torch_interop as jinterop  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.models import att_model as tatt  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.models import fc_model as tfc  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.ops import decoding as tdec  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.utils import torch_interop as tinterop  # noqa: E402
from cooperativeimagecaptioning_tpu_torch.utils.tree import leaves, to_numpy  # noqa: E402

DIMS = dict(vocab_size=40, seq_length=8, rnn_size=24, input_encoding_size=16,
            att_hid_size=12, fc_feat_size=20, att_feat_size=20,
            vse_embed_size=16)
CASES = {
    "att2in2": dict(caption_model="att2in2", vse_model="None"),
    "att2in2_use_bn": dict(caption_model="att2in2", vse_model="None",
                           use_bn=1),
    "fc": dict(caption_model="fc", vse_model="None"),
    "joint": dict(caption_model="att2in2", vse_model="fc"),
    "joint_share_embed": dict(caption_model="att2in2", vse_model="fc",
                              share_embed=1),
    "fc_joint": dict(caption_model="fc", vse_model="fc"),
}


def jax_tree(case, seed=3):
    """JAX-initialized params of `case` as a numpy tree in the layout
    export_state_dict takes: under share_embed the speaker view (the shared
    table injected, as the reference's aliased parameter appears in its
    state_dict).  The logit and embedding weights are scaled up and the
    BatchNorm statistics drawn, so that decodes move between words and
    every leaf is distinct."""
    opt = jconfig.Options(**DIMS, **CASES[case])
    p = jax.tree.map(np.asarray, jjoint.init_params(
        jax.random.PRNGKey(seed), opt))
    sp = p["speaker"]
    if opt.share_embed:
        sp["embed"] = p["listener"]["txt_enc"]["embed"]
    sp["logit"]["w"] = sp["logit"]["w"] * 12.0
    sp["embed"] = sp["embed"] * 10.0
    if "att_bn" in sp:
        rng = np.random.RandomState(seed)
        F = sp["att_bn"]["scale"].shape[0]
        sp["att_bn"]["mean"] = rng.randn(F).astype(np.float32) * 0.1
        sp["att_bn"]["var"] = rng.rand(F).astype(np.float32) + 0.5
    return opt, p


def assert_trees_equal(got, want):
    """Same paths, shapes, dtypes and values (bit-equal)."""
    g = dict(leaves(to_numpy(got)))
    w = dict(leaves(jax.tree.map(np.asarray, want)))
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def assert_state_dicts_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert isinstance(got[k], torch.Tensor) and got[k].device.type == \
            "cpu", k
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def _without_shared(p, opt):
    if opt.share_embed:
        p = dict(p, speaker={k: v for k, v in p["speaker"].items()
                             if k != "embed"})
    return p


@pytest.mark.parametrize("case", sorted(CASES))
def test_convert_equals_the_jax_packages(case):
    opt, p = jax_tree(case)
    sd = jinterop.export_state_dict(p, opt.caption_model)
    kw = dict(caption_model=opt.caption_model,
              share_embed=bool(opt.share_embed))
    got = tinterop.convert_state_dict(sd, **kw)
    want = jinterop.convert_state_dict(sd, **kw)
    assert all(t.device.type == "cpu" for _, t in leaves(got))
    assert_trees_equal(got, want)
    assert_trees_equal(got, _without_shared(p, opt))  # the original tree
    # a bare caption-model state_dict (no caption_generator. prefix)
    bare = tinterop.export_state_dict({"speaker": p["speaker"]},
                                      opt.caption_model)
    assert_trees_equal(tinterop.convert_state_dict(bare, **kw),
                       jinterop.convert_state_dict(bare, **kw))


@pytest.mark.parametrize("wrapped", [None, True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_export_equals_the_jax_packages(case, wrapped):
    """The port's export of the port's tensors equals the JAX package's of
    the same numpy tree: keys in order, shapes, dtypes and values."""
    opt, p = jax_tree(case)
    tp = jax.tree.map(lambda x: torch.from_numpy(x.copy()), p)
    got = tinterop.export_state_dict(tp, opt.caption_model, wrapped=wrapped)
    want = jinterop.export_state_dict(p, opt.caption_model, wrapped=wrapped)
    assert_state_dicts_equal(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_round_trip_through_a_pth(case, tmp_path):
    opt, p = jax_tree(case)
    tree = _without_shared(p, opt)
    tp = jax.tree.map(lambda x: torch.from_numpy(x.copy()), p)
    path = str(tmp_path / "model.pth")
    tinterop.save_torch_checkpoint(tp, path, caption_model=opt.caption_model)
    kw = dict(caption_model=opt.caption_model,
              share_embed=bool(opt.share_embed))
    back = tinterop.load_torch_checkpoint(path, **kw)
    assert_trees_equal(back, tree)
    # the JAX package reads the port's file as the port does
    assert_trees_equal(back, jinterop.load_torch_checkpoint(path, **kw))
    # and in memory, export -> convert is the identity
    assert_trees_equal(tinterop.convert_state_dict(
        tinterop.export_state_dict(tp, opt.caption_model), **kw), tree)


@pytest.mark.parametrize("decode", ["greedy", "beam2"])
@pytest.mark.parametrize("case", ["att2in2", "att2in2_use_bn", "fc"])
def test_converted_params_decode_as_jax(case, decode):
    opt, p = jax_tree(case, seed=5)
    sd = jinterop.export_state_dict(p, opt.caption_model)
    jp = jax.tree.map(jnp.asarray, jinterop.convert_state_dict(
        sd, opt.caption_model)["speaker"])
    tree = tinterop.convert_state_dict(sd, opt.caption_model)["speaker"]
    rng = np.random.RandomState(6)
    B, K = 12, 5
    fc = rng.randn(B, opt.fc_feat_size).astype(np.float32) * 2.0
    att = rng.randn(B, K, opt.att_feat_size).astype(np.float32) * 4.0
    if opt.caption_model == "fc":
        jmod, tp = jfc, tfc.FCModel(tree)
        jctx = jfc.encode_features(jp, jnp.asarray(fc), None, None)
        tctx = tp.encode_features(torch.from_numpy(fc), None, None)
    else:
        jmod, tp = jatt, tatt.AttModel(tree)
        jctx = jatt.encode_features(jp, None, jnp.asarray(att), None)
        tctx = tp.encode_features(None, torch.from_numpy(att), None)
    if decode == "greedy":
        jout = jdec.sample(jmod, jp, jctx, opt.seq_length,
                           jax.random.PRNGKey(0), mode="greedy")
        tout = tdec.sample(tp, tctx, opt.seq_length, mode="greedy")
    else:
        jout = jdec.beam_search(jmod, jp, jctx, opt.seq_length, 2)
        tout = tdec.beam_search(tp, tctx, opt.seq_length, 2)
    ids = tout.seq.numpy()
    np.testing.assert_array_equal(ids, np.asarray(jout.seq))
    np.testing.assert_allclose(tout.logprobs.numpy(),
                               np.asarray(jout.logprobs), atol=1e-5,
                               rtol=1e-5)
    assert len(np.unique(ids)) > 3  # the decode moves between words
