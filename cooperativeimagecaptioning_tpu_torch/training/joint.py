"""Joint model: the speaker side of the joint param tree and the phase-2
MLE loss (counterpart of the JAX package's training/joint.py; ref
models/AlternatingJointModel.py).

The joint tree is {'speaker': ..., 'listener': ...}.  With share_embed the
word embedding is stored only under the listener and injected into the
speaker's view (ref AlternatingJointModel.py:83-88).  Ported: `Hyper`,
`speaker_view`, a speaker-only `init_params`, and `loss_fn` for the
caption (MLE) loss of the 'optimizer' and 'speaker' turns, with
`value_and_grad` in place of the JAX `make_raw_fns`.  The listener turn,
the VSE contrastive loss, DISC and CIDEr raise NotImplementedError until
their slices (ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from cooperativeimagecaptioning_tpu_torch import models as model_zoo
from cooperativeimagecaptioning_tpu_torch.ops import decoding, losses
from cooperativeimagecaptioning_tpu_torch.utils.tree import from_leaves, leaves

_LISTENER = "ROADMAP.md queue 1: the listener and retrieval"
_JOINT = "ROADMAP.md queue 1: joint training"


class Hyper(NamedTuple):
    """Per-iteration hyperparameters (JAX joint.py:40-68), as Python floats
    or 0-d tensors (the schedules of train.py:416-435)."""
    ss_prob: Any
    gumbel_temp: Any
    multinomial_temp: Any
    prob_gumbel_softmax: Any
    prob_multinomial_soft: Any
    caption_loss_weight: Any
    vse_loss_weight: Any
    retrieval_reward_weight: Any
    cider_weight: Any
    vse_max_w: Any

    @classmethod
    def from_opt(cls, opt):
        return cls(
            ss_prob=float(getattr(opt, "ss_prob", 0.0)),
            gumbel_temp=float(opt.gumbel_temp),
            multinomial_temp=float(opt.multinomial_temp),
            prob_gumbel_softmax=float(opt.prob_gumbel_softmax),
            prob_multinomial_soft=float(opt.prob_multinomial_soft),
            caption_loss_weight=float(opt.caption_loss_weight),
            vse_loss_weight=float(opt.vse_loss_weight),
            retrieval_reward_weight=float(opt.retrieval_reward_weight),
            cider_weight=float(opt.cider_optimization),
            vse_max_w=float(opt.vse_max_violation),
        )


def has_listener(opt) -> bool:
    return opt.vse_model != "None"


def init_params(seed: int, opt, device="cpu"):
    """A joint tree holding only the speaker, from a numpy seed."""
    if has_listener(opt):
        raise NotImplementedError(
            f"vse_model {opt.vse_model!r}: the listener is not ported yet "
            f"({_LISTENER})")
    speaker_cls = model_zoo.setup(opt, opt.caption_model, "caption_model")
    return {"speaker": speaker_cls.init_params(seed, opt, device)}


def speaker_view(params, opt):
    """Speaker params with the shared embedding injected (JAX
    joint.py:96-106).  In phase 2 the shared embedding is frozen (ref
    AlternatingJointModel.py:86-88): the view holds it detached, so no
    gradient reaches the listener's table."""
    sp = params["speaker"]
    if getattr(opt, "share_embed", 0) and "listener" in params:
        sp = dict(sp)
        emb = params["listener"]["txt_enc"]["embed"]
        if opt.phase == 2:
            emb = emb.detach()
        sp["embed"] = emb
    return sp


def check_ported(opt, turn):
    """Raise NotImplementedError, naming its ROADMAP item, for a loss branch
    that this port does not have yet."""
    if turn == "listener":
        raise NotImplementedError(
            f"the listener turn is not ported yet ({_LISTENER})")
    if has_listener(opt):
        raise NotImplementedError(
            f"vse_model {opt.vse_model!r}: the VSE contrastive loss and DISC "
            f"need the listener, which is not ported yet ({_LISTENER})")
    if opt.cider_optimization > 0:
        raise NotImplementedError(
            f"cider_optimization: the CIDEr-D self-critical loss is not "
            f"ported yet ({_JOINT}; ROADMAP.md queue 1: device rewards)")
    if turn not in ("optimizer", "speaker"):
        raise ValueError(f"unknown turn {turn!r}")


def loss_fn(modules, params, opt, batch, gen, hp, turn, reward=None,
            train=True):
    """Total loss and aux dict (JAX joint.py:181-235) for the turns
    'optimizer' and 'speaker' with the caption loss only.

    modules: {'speaker': the speaker class}; params: the joint tree;
    batch: tensors on the device ('att_feats', 'att_masks', 'labels' [B,
    L+2], 'masks' [B, L+2]); gen: the torch.Generator the dropout and
    scheduled-sampling draws come from.  Returns (loss, {'loss_cap',
    'cap_xe'})."""
    del reward  # the CIDEr branch is not ported (check_ported)
    check_ported(opt, turn)
    spk = modules["speaker"](speaker_view(params, opt))
    drop = opt.drop_prob_lm if train else 0.0
    labels = batch["labels"]
    masks = batch["masks"]
    ctx = spk.encode_features(batch.get("fc_feats"), batch.get("att_feats"),
                              batch.get("att_masks"), train, drop, gen)
    loss = torch.zeros((), dtype=torch.float32, device=labels.device)
    aux = {}
    if opt.caption_loss_weight > 0:
        if getattr(opt, "remat", 0):
            # fused CE + per-step recompute: no [B, T, V+1] residual
            loss_cap = decoding.teacher_forced_loss(
                spk, ctx, labels[:, :-1], labels[:, 1:], masks[:, 1:], gen,
                train, drop, hp.ss_prob)
        else:
            lps = decoding.teacher_forced_logprobs(
                spk, ctx, labels[:, :-1], gen, train, drop, hp.ss_prob)
            loss_cap = losses.language_model_criterion(
                lps, labels[:, 1:], masks[:, 1:])
        loss = loss + hp.caption_loss_weight * loss_cap
        aux["loss_cap"] = loss_cap
        aux["cap_xe"] = loss_cap
    return loss, aux


def value_and_grad(opt, turn):
    """fn(params, batch, gen, hp) -> ((loss, aux), grads), standing in for
    the JAX `make_raw_fns(opt, turn)[1]` (joint.py:350-365).  grads has the
    structure of params, one gradient per leaf that requires grad (zeros
    where the loss does not reach a leaf, as JAX gives); aux values are
    detached."""
    modules = {"speaker": model_zoo.setup(opt, opt.caption_model,
                                          "caption_model")}

    def fn(params, batch, gen, hp):
        loss, aux = loss_fn(modules, params, opt, batch, gen, hp, turn)
        named = [(k, x) for k, x in leaves(params) if x.requires_grad]
        got = torch.autograd.grad(loss, [x for _, x in named],
                                  allow_unused=True)
        grads = from_leaves((path, torch.zeros_like(x) if g is None else g)
                            for (path, x), g in zip(named, got))
        return ((loss.detach(), {k: v.detach() for k, v in aux.items()}),
                grads)

    return fn
