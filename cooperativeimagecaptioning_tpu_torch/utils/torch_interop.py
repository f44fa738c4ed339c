"""Torch checkpoint interop: convert reference .pth state_dicts to the port's
param trees, so models trained with the PyTorch reference load directly, and
export the port's trees back to the reference's layout (the port's own copy
of the JAX package's utils/torch_interop.py; the leaves are tensors on a
given device, the CPU by default, as in training/checkpoint.load_params).

Key mapping (reference module tree -> our pytree):
  caption_generator.embed(.0).weight        -> speaker.embed            [V+2, D]
  caption_generator.img_embed.*             -> speaker.img_embed        (fc)
  caption_generator.att_embed.<i>.*         -> speaker.att_embed        (att)
  caption_generator.ctx2att.*               -> speaker.ctx2att
  caption_generator.core.{i2h,h2h,a2c}.*    -> speaker.core.*
  caption_generator.core.attention.*        -> speaker.core.attention.*
  caption_generator.logit.*                 -> speaker.logit
  vse.img_enc.fc.*                          -> listener.img_enc.fc
  vse.txt_enc.embed.weight                  -> listener.txt_enc.embed
  vse.txt_enc.rnn.{weight,bias}_{ih,hh}_l0  -> listener.txt_enc.rnn     (transposed)
Linear weights transpose [out, in] -> [in, out].
"""

from __future__ import annotations

import numpy as np
import torch

from cooperativeimagecaptioning_tpu_torch.utils.tree import to_torch


def _np(t):
    try:
        return t.detach().cpu().numpy()
    except AttributeError:
        return np.asarray(t)


def _linear(sd, prefix):
    return {"w": _np(sd[prefix + ".weight"]).T.copy(),
            "b": _np(sd[prefix + ".bias"]).copy()}


def convert_state_dict(sd, caption_model="att2in2", has_listener=True,
                       share_embed=False, device="cpu"):
    """Reference AlternatingJointModel state_dict -> {'speaker','listener'}
    tree of tensors on `device`.

    Also accepts bare caption-model state_dicts (keys without the
    caption_generator. prefix)."""
    if not any(k.startswith("caption_generator.") for k in sd):
        sd = {("caption_generator." + k): v for k, v in sd.items()}

    cg = "caption_generator."
    speaker = {}
    if caption_model == "fc":
        speaker["img_embed"] = _linear(sd, cg + "img_embed")
        speaker["core"] = {"i2h": _linear(sd, cg + "core.i2h"),
                           "h2h": _linear(sd, cg + "core.h2h")}
        embed_key = cg + "embed.weight"
    else:
        # att_embed is a Sequential whose Linear index depends on use_bn
        lin_idx = next(i for i in range(3)
                       if f"{cg}att_embed.{i}.weight" in sd and
                       _np(sd[f"{cg}att_embed.{i}.weight"]).ndim == 2)
        speaker["att_embed"] = _linear(sd, f"{cg}att_embed.{lin_idx}")
        bn_w = sd.get(f"{cg}att_embed.0.weight")
        if bn_w is not None and _np(bn_w).ndim == 1:
            # use_bn=1: BatchNorm1d precedes the Linear (AttModel.py:82-85);
            # carry its affine + running stats (frozen-stat BN at decode)
            speaker["att_bn"] = {
                "scale": _np(bn_w).copy(),
                "bias": _np(sd[f"{cg}att_embed.0.bias"]).copy(),
                "mean": _np(sd[f"{cg}att_embed.0.running_mean"]).copy(),
                "var": _np(sd[f"{cg}att_embed.0.running_var"]).copy(),
            }
        speaker["ctx2att"] = _linear(sd, cg + "ctx2att")
        speaker["core"] = {
            "i2h": _linear(sd, cg + "core.i2h"),
            "h2h": _linear(sd, cg + "core.h2h"),
            "a2c": _linear(sd, cg + "core.a2c"),
            "attention": {
                "h2att": _linear(sd, cg + "core.attention.h2att"),
                "alpha_net": _linear(sd, cg + "core.attention.alpha_net"),
            },
        }
        embed_key = cg + "embed.0.weight"
    speaker["logit"] = _linear(sd, cg + "logit")
    if not share_embed:
        speaker["embed"] = _np(sd[embed_key]).copy()

    params = {"speaker": speaker}
    if has_listener and any(k.startswith("vse.") for k in sd):
        rnn = "vse.txt_enc.rnn."
        params["listener"] = {
            "img_enc": {"fc": _linear(sd, "vse.img_enc.fc")},
            "txt_enc": {
                "embed": _np(sd["vse.txt_enc.embed.weight"]).copy(),
                "rnn": {
                    "w_ih": _np(sd[rnn + "weight_ih_l0"]).T.copy(),
                    "w_hh": _np(sd[rnn + "weight_hh_l0"]).T.copy(),
                    "b_ih": _np(sd[rnn + "bias_ih_l0"]).copy(),
                    "b_hh": _np(sd[rnn + "bias_hh_l0"]).copy(),
                },
            },
        }
    return to_torch(params, device)


def load_torch_checkpoint(path, caption_model="att2in2", share_embed=False,
                          device="cpu"):
    """Load a reference .pth (a state_dict of tensors) into a tree on
    `device`."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return convert_state_dict(sd, caption_model=caption_model,
                              share_embed=share_embed, device=device)


def _torch_linear(tree):
    return {"weight": torch.from_numpy(_np(tree["w"]).T.copy()),
            "bias": torch.from_numpy(_np(tree["b"]).copy())}


def export_state_dict(params, caption_model="att2in2", wrapped=None):
    """The port's {'speaker'[, 'listener']} tree (tensors on any device, or
    numpy arrays) -> a reference-shaped torch state_dict on the CPU (the
    inverse of convert_state_dict), so models trained here load into the
    PyTorch reference via load_state_dict (with att_bn, the use_bn=1
    layout).

    Keys follow AlternatingJointModel naming (caption_generator./vse.
    prefixes) when `wrapped` — default: wrapped iff a listener is present;
    wrapped=False emits bare FCModel/AttModel keys for loading into a
    standalone reference speaker."""
    sd = {}

    def put(prefix, tree):
        for k, v in _torch_linear(tree).items():
            sd[f"{prefix}.{k}"] = v

    sp = params.get("speaker", params)
    if wrapped is None:
        wrapped = params.get("listener") is not None
    cg = "caption_generator." if wrapped else ""
    if caption_model == "fc":
        put(cg + "img_embed", sp["img_embed"])
        put(cg + "core.i2h", sp["core"]["i2h"])
        put(cg + "core.h2h", sp["core"]["h2h"])
        sd[cg + "embed.weight"] = torch.from_numpy(
            _np(sp["embed"]).copy())
    else:
        if "att_bn" in sp:
            bn = sp["att_bn"]
            sd[cg + "att_embed.0.weight"] = torch.from_numpy(
                _np(bn["scale"]).copy())
            sd[cg + "att_embed.0.bias"] = torch.from_numpy(
                _np(bn["bias"]).copy())
            sd[cg + "att_embed.0.running_mean"] = torch.from_numpy(
                _np(bn.get("mean", np.zeros_like(_np(bn["scale"])))).copy())
            sd[cg + "att_embed.0.running_var"] = torch.from_numpy(
                _np(bn.get("var", np.ones_like(_np(bn["scale"])))).copy())
            sd[cg + "att_embed.0.num_batches_tracked"] = torch.tensor(0)
            put(cg + "att_embed.1", sp["att_embed"])
        else:
            put(cg + "att_embed.0", sp["att_embed"])
        put(cg + "ctx2att", sp["ctx2att"])
        for name in ("i2h", "h2h", "a2c"):
            put(cg + f"core.{name}", sp["core"][name])
        put(cg + "core.attention.h2att", sp["core"]["attention"]["h2att"])
        put(cg + "core.attention.alpha_net",
            sp["core"]["attention"]["alpha_net"])
        sd[cg + "embed.0.weight"] = torch.from_numpy(
            _np(sp["embed"]).copy())
    put(cg + "logit", sp["logit"])

    li = params.get("listener")
    if li is not None:
        put("vse.img_enc.fc", li["img_enc"]["fc"])
        sd["vse.txt_enc.embed.weight"] = torch.from_numpy(
            _np(li["txt_enc"]["embed"]).copy())
        rnn = li["txt_enc"]["rnn"]
        sd["vse.txt_enc.rnn.weight_ih_l0"] = torch.from_numpy(
            _np(rnn["w_ih"]).T.copy())
        sd["vse.txt_enc.rnn.weight_hh_l0"] = torch.from_numpy(
            _np(rnn["w_hh"]).T.copy())
        sd["vse.txt_enc.rnn.bias_ih_l0"] = torch.from_numpy(
            _np(rnn["b_ih"]).copy())
        sd["vse.txt_enc.rnn.bias_hh_l0"] = torch.from_numpy(
            _np(rnn["b_hh"]).copy())
    return sd


def save_torch_checkpoint(params, path, caption_model="att2in2"):
    """Write a reference-loadable .pth for the port's params."""
    torch.save(export_state_dict(params, caption_model=caption_model), path)
