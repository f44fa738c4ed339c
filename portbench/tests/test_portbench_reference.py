"""The plain reference at tiny widths on the CPU: its weights fill the
program's speaker leaf for leaf, its beam search serves the program's
ids, the served tokens of a beam search read 0, and the inputs drawn again
by row equal the whole draw."""

from __future__ import annotations

import ast

import pytest
import torch

from portbench.core import data
from portbench.reference import common, speaker

from .conftest import ROOT, TINY_CONFIG


def _cfg(model):
    import json
    name = {"att2in2": "att2in2-coco", "fc": "fc-coco"}[model]
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                     .read_text())
    return dict(cfg, **TINY_CONFIG)


def _program_speaker(model, cfg, p0):
    from cooperativeimagecaptioning_tpu_torch import models
    from cooperativeimagecaptioning_tpu_torch.config import Options
    opt = Options(caption_model=model, vocab_size=cfg["vocab_size"],
                  rnn_size=cfg["rnn_size"],
                  input_encoding_size=cfg["input_encoding_size"],
                  att_hid_size=cfg["att_hid_size"],
                  fc_feat_size=cfg["fc_feat_size"],
                  att_feat_size=cfg["att_feat_size"])
    cls = models.setup(opt, model, "caption_model")
    return opt, cls(common.nest(p0))


@pytest.mark.parametrize("model", ["att2in2", "fc"])
def test_weights_fill_the_programs_leaves(model):
    from cooperativeimagecaptioning_tpu_torch.config import Options
    from cooperativeimagecaptioning_tpu_torch.models import setup
    from cooperativeimagecaptioning_tpu_torch.utils.tree import leaves
    cfg = _cfg(model)
    opt = Options(caption_model=model, vocab_size=cfg["vocab_size"],
                  **{k: cfg[k] for k in ("rnn_size", "input_encoding_size",
                                         "att_hid_size", "fc_feat_size",
                                         "att_feat_size")})
    tree = setup(opt, model, "caption_model").init_params(0, opt)
    prog = {k: tuple(v.shape) for k, v in leaves(tree)}
    mod = speaker.model(model)
    ref = {k: tuple(s) for k, s, _ in mod.leaves(cfg)}
    assert prog == ref
    a = common.make_weights(mod.leaves(cfg), 7, "cpu")
    b = common.make_weights(mod.leaves(cfg), 7, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("model", ["att2in2", "fc"])
def test_beam_search_serves_the_programs_ids(model):
    from cooperativeimagecaptioning_tpu_torch.ops import decoding
    cfg = _cfg(model)
    mod = speaker.model(model)
    p0 = common.make_weights(mod.leaves(cfg), 3, "cpu")
    N, K = 5, 6
    g = torch.Generator().manual_seed(0)
    feats = {"att": torch.randn(N, K, cfg["att_feat_size"], generator=g),
             "att_mask": torch.ones(N, K),
             "fc": torch.randn(N, cfg["fc_feat_size"], generator=g)}
    opt, spk = _program_speaker(model, cfg, p0)
    with torch.no_grad():
        ctx = spk.encode_features(feats["fc"], feats["att"],
                                  feats["att_mask"])
        prog = decoding.beam_search(spk, ctx, cfg["seq_length"], 2).seq
        ref = speaker.beam_search(mod, common.nest(p0), cfg, feats, 2,
                                  cfg["seq_length"])
        assert torch.equal(prog.long(), ref)
        gap, _, n = speaker.served_gaps(mod, common.nest(p0), cfg, feats,
                                        ref, 2)
    assert gap == 0.0 and n >= N


def test_a_token_outside_the_top_m_reads_its_gap():
    cfg = _cfg("att2in2")
    mod = speaker.model("att2in2")
    p = common.nest(common.make_weights(mod.leaves(cfg), 4, "cpu"))
    feats = {"att": torch.rand(3, 5, cfg["att_feat_size"]),
             "att_mask": torch.ones(3, 5)}
    with torch.no_grad():
        ids = speaker.beam_search(mod, p, cfg, feats, 2, cfg["seq_length"])
        worst = ids.clone()
        # the token the reference ranks last at the first position
        ctx = mod.encode(p, feats)
        h = torch.zeros(3, cfg["rnn_size"])
        h, _ = mod.step(p, ctx, h, torch.zeros_like(h),
                        mod.embed(p, torch.full((3,), cfg["vocab_size"] + 1)))
        lp = torch.log_softmax(h @ p["logit"]["w"] + p["logit"]["b"], -1)
        worst[:, 0] = lp.argmin(-1)
        gap, _, _ = speaker.served_gaps(mod, p, cfg, feats, worst, 2)
    want = float((lp.topk(2).values[:, 1] - lp.min(-1).values).max())
    assert gap == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("share", [0.0, 0.5])
def test_rows_drawn_again_equal_the_whole_draw(share):
    shape = (data.CHUNK_ROWS + 37, 3, 2)
    whole = data.draw(shape, 11, "t", "cpu", share=share)
    idx = torch.tensor([0, 5, data.CHUNK_ROWS - 1, data.CHUNK_ROWS,
                        shape[0] - 1])
    assert torch.equal(data.rows(idx, shape, 11, "t", "cpu", share=share),
                       whole[idx])
    assert (whole >= 0).all()


def test_an_images_regions_share_a_part_of_their_features():
    """Regions of one image correlate by the shared part; across images
    they do not."""
    x = data.draw((400, 8, 64), 5, "t", "cpu", share=0.5)
    x = x - x.mean(dim=(0, 1))
    same = (x[:, 0] * x[:, 1]).sum(-1).mean()
    other = (x[:-1, 0] * x[1:, 1]).sum(-1).mean()
    assert same > 10 * abs(other)


def test_the_reference_imports_nothing_of_the_program_or_jax():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top in ("__future__", "contextlib", "hashlib",
                               "importlib", "torch", "portbench"), (path, n)
                assert not n.startswith("portbench.") or \
                    n.startswith("portbench.reference"), (path, n)
