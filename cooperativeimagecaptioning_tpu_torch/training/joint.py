"""Joint model: the cooperative loss of a speaker and a listener
(counterpart of the JAX package's training/joint.py; ref
models/AlternatingJointModel.py).

The joint tree is {'speaker': ..., 'listener': ...}.  With share_embed the
word embedding is stored only under the listener and injected into the
speaker's view (ref AlternatingJointModel.py:83-88), so one update keeps
the two identical.

    loss = caption_loss_weight * XE
         + vse_loss_weight * contrastive(GT captions)
         + retrieval_reward_weight * DISC
         + cider_optimization * CIDEr-RL

Ported: `Hyper`, `init_params` (the speaker, and the listener when the run
has one), `speaker_view`, `speaker_template` (the speaker of any run), the
named random streams, and every turn of the JAX loss.  On the 'optimizer'
and 'speaker' turns: the caption (MLE) loss,
the listener's contrastive loss on the GT captions (zeroed on the speaker
turn), the DISC loss -- REINFORCE over the listener's per-sample retrieval
loss of a multinomial sample with a greedy, GT or no baseline, or the
straight-through / partial-sampling relaxation (the relaxed one-hots of
`decoding.sample`, a one-hot BOS row in front, through the listener; the
gradient reaches both agents) -- and the self-critical CIDEr-D loss with
the host reward, which reuses DISC's sample in the 'reinforce', 'gumbel'
and 'multinomial' modes, or with the device tiers: on_device_cider scores
the sample and a greedy decode with the hashed n-gram CIDEr-D inside the
step (rewards/ngram_device.py), and soft_cider (with a relaxed DISC mode)
takes the differentiable soft CIDEr of DISC's relaxed rows
(rewards/cider_diff.py); both read the batch's padded refs ('refs',
'ref_mask', and 'df_table' for a cached df).  On the 'listener' turn: the listener's
contrastive loss on captions sampled from the frozen speaker.  The CIDEr
reward runs in two stages as in the JAX package:
  stage A `sample_for_reward`: sampled and greedy captions, no gradient;
  host: the CIDEr-D reward (rewards/self_critical.py);
  stage B `loss_fn`: re-draws the same sampled trajectory (the same
  streams, reseeded) under autograd and takes the reward as a constant.
With a device tier the step needs no host stage (`needs_reward`).
`value_and_grad` and `sampler` stand in for the JAX `make_raw_fns`.

On a mesh (`rows`: the data group, whose ranks hold shares of the batch's
rows; the vocabulary through parallel/vocab.py) every term is this rank's
share of the global batch's: the normalisers are global sums, the
listener's contrastive matrix spans the data group, att_bn takes the
global batch's statistics, the device reward scores the group's gathered
ids (`_device_reward`) and soft CIDEr the rank's rows against the global
refs; `host_reward` is the host stage over the gathered ids.  The
ranks' losses, aux entries and gradients add up to the single-device run's.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from cooperativeimagecaptioning_tpu_torch import models as model_zoo
from cooperativeimagecaptioning_tpu_torch.models import vse
from cooperativeimagecaptioning_tpu_torch.ops import decoding, draws, losses
from cooperativeimagecaptioning_tpu_torch.parallel import collectives, vocab
from cooperativeimagecaptioning_tpu_torch.rewards import (
    cider_diff, ngram_device, self_critical)
from cooperativeimagecaptioning_tpu_torch.utils.tree import (
    detached, from_leaves, leaves)

# the named streams of one iteration (JAX joint.py:123-127)
STREAMS = ("xe", "disc", "cider", "greedy", "listener")
# retrieval_reward -> the sampling mode of the relaxed DISC branch
ONE_HOT_MODES = ("gumbel", "multinomial", "gumbel_softmax",
                 "multinomial_soft")
_MODE_MAP = {"gumbel": "gumbel_st", "multinomial": "multinomial_st",
             "gumbel_softmax": "gumbel_soft",
             "multinomial_soft": "multinomial_soft"}


class Hyper(NamedTuple):
    """Per-iteration hyperparameters (JAX joint.py:40-68), as Python floats
    or 0-d tensors (the schedules of train.py:416-435): a fused chunk
    stages them as tensors that its CUDA graph reads."""
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
    """The joint tree from numpy seeds: the speaker from `seed` (as
    `speaker_template`) and, when the run has a listener, the listener
    from `seed + 1`; under share_embed the table lives only under the
    listener (JAX joint.py:78-93)."""
    params = speaker_template(opt, device, seed)
    if has_listener(opt):
        shared = params.get("listener", {}).get("txt_enc", {}).get("embed")
        params["listener"] = vse.init_params(seed + 1, opt, device)
        if shared is not None:
            params["listener"]["txt_enc"]["embed"] = shared
    return params


def speaker_template(opt, device="cpu", seed: int = 0):
    """The tree a run's speaker loads into, built from the speaker class
    alone: {'speaker': ...}; under share_embed with a listener the table
    sits at listener/txt_enc/embed instead (JAX joint.py:83-88), where
    `speaker_view` takes it from.  The file's other listener leaves are
    reported by the lenient merge, not loaded."""
    speaker_cls = model_zoo.setup(opt, opt.caption_model, "caption_model")
    params = {"speaker": speaker_cls.init_params(seed, opt, device)}
    if has_listener(opt) and getattr(opt, "share_embed", 0):
        params["listener"] = {
            "txt_enc": {"embed": params["speaker"].pop("embed")}}
    return params


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


def streams(seed: int, device, gens=None):
    """One draw source per named stream, each on its own torch.Generator on
    `device`, all from one seed: the port's counterpart of splitting one
    PRNG key.  Stage B calls it again with the same seed to re-draw stage
    A's trajectory.  `gens` ({name: generator}, as `generators` makes)
    reseeds those generators instead of making new ones: a CUDA graph
    that registered them draws the same noise as fresh ones."""
    out = {}
    for i, name in enumerate(STREAMS):
        gen = torch.Generator(device=device) if gens is None else gens[name]
        gen.manual_seed(seed * len(STREAMS) + i)
        out[name] = draws.Draws(gen)
    return out


def generators(device):
    """{name: torch.Generator on `device`} for `streams(..., gens=)`."""
    return {name: torch.Generator(device=device) for name in STREAMS}


def _streams(rng):
    """Named streams from `rng`: a dict of draw sources as it is, else one
    source (a torch.Generator, a draw source or None) for every name."""
    if isinstance(rng, dict):
        return rng
    src = draws.source(rng)
    return {name: src for name in STREAMS}


def _sample_kwargs(opt, hp, train):
    """JAX joint.py:130-139."""
    return dict(
        gumbel_temp=hp.gumbel_temp,
        multinomial_temp=hp.multinomial_temp,
        prob_gumbel_softmax=hp.prob_gumbel_softmax,
        prob_multinomial_soft=hp.prob_multinomial_soft,
        decoding_constraint=opt.decoding_constraint,
        train=train, drop_prob=opt.drop_prob_lm if train else 0.0,
        remat=bool(getattr(opt, "remat", 0)) and train)


def _prepend_bos_ids(seq, vocab_size):
    """cat(BOS column, seq) (JAX joint.py:109-113; ref :238-240)."""
    bos = torch.full((seq.shape[0], 1), vocab_size + 1, dtype=seq.dtype,
                     device=seq.device)
    return torch.cat([bos, seq], dim=1)


def _prepend_bos_one_hot(soft_seq, vocab_size):
    """A one-hot BOS row in front of relaxed sequences [B, L, V+2] (JAX
    joint.py:116-120; ref :358-370)."""
    B, _, C = soft_seq.shape
    bos = vocab.one_hot_row(vocab_size + 1, soft_seq)  # a rank's columns
    return torch.cat([bos.expand(B, 1, C), soft_seq], dim=1)


def _disc_active(opt, turn) -> bool:
    return (opt.retrieval_reward_weight > 0 and has_listener(opt)
            and turn != "listener")


def _cider_reuses_disc(opt, turn) -> bool:
    """Whether the CIDEr branch takes DISC's sample (JAX joint.py:142-148;
    ref :490-495: the soft modes, or an inactive DISC, sample anew)."""
    return _disc_active(opt, turn) and \
        opt.retrieval_reward in ("reinforce", "gumbel", "multinomial")


def _cider_active(opt, turn) -> bool:
    return opt.cider_optimization > 0 and turn != "listener"


def uses_soft_cider(opt, turn) -> bool:
    """Whether the CIDEr term is the soft CIDEr of DISC's relaxed rows
    (JAX joint.py:374-376)."""
    return bool(getattr(opt, "soft_cider", 0) and _disc_active(opt, turn)
                and opt.retrieval_reward in ONE_HOT_MODES)


def needs_device_refs(opt) -> bool:
    """Whether a batch carries the padded refs of a device tier (JAX
    joint.py:379-381)."""
    return bool(getattr(opt, "on_device_cider", 0) or
                getattr(opt, "soft_cider", 0))


def needs_reward(opt, turn) -> bool:
    """Whether the host reward stage runs: the CIDEr term is active and no
    device tier scores it (JAX joint.py:384-388)."""
    return (_cider_active(opt, turn)
            and not getattr(opt, "on_device_cider", 0)
            and not uses_soft_cider(opt, turn))


def check_ported(opt, turn):
    """Raise NotImplementedError, naming its ROADMAP item, for a loss branch
    that this port does not have yet."""
    if _disc_active(opt, turn) and opt.retrieval_reward != "reinforce" and \
            opt.retrieval_reward not in _MODE_MAP:
        raise ValueError(f"unknown retrieval_reward {opt.retrieval_reward!r}")
    if turn not in ("optimizer", "speaker", "listener"):
        raise ValueError(f"unknown turn {turn!r}")


def _speaker(modules, params, opt, batch, rng, train, drop, rows=None):
    """(speaker module, the iteration's streams, the encoded context)."""
    spk = modules["speaker"](speaker_view(params, opt))
    r = _streams(rng)
    ctx = spk.encode_features(batch.get("fc_feats"), batch.get("att_feats"),
                              batch.get("att_masks"), train, drop, r["xe"],
                              rows=rows)
    return spk, r, ctx


def sample_for_reward(modules, params, opt, batch, rng, hp, turn,
                      train=True, rows=None):
    """Stage A (JAX joint.py:155-178): the (sampled, greedy) ids the CIDEr
    reward scores, without autograd, on a detached view of the params.  It
    draws from the streams exactly as loss_fn's CIDEr branch does -- from
    the 'disc' stream in the DISC mode when that branch reuses DISC's
    sample -- so that stage B, given the same streams, samples the same
    ids.  `rows`: a mesh run's data group (this rank's rows)."""
    check_ported(opt, turn)
    kw = _sample_kwargs(opt, hp, train)
    with torch.no_grad():
        spk, r, ctx = _speaker(modules, detached(params), opt, batch, rng,
                               train, kw["drop_prob"], rows)
        if _cider_reuses_disc(opt, turn):
            out = decoding.sample(
                spk, ctx, opt.seq_length, r["disc"],
                mode=_MODE_MAP.get(opt.retrieval_reward, "sample"),
                temperature=1.0, **kw)
        else:
            out = decoding.sample(spk, ctx, opt.seq_length, r["cider"],
                                  mode="sample", temperature=1.0, **kw)
        greedy = decoding.sample(spk, ctx, opt.seq_length, r["greedy"],
                                 mode="greedy", **kw)
    return out.seq, greedy.seq


def host_reward(opt, gts, gen, greedy, rows=None):
    """The host stage between stage A and stage B (JAX loop.py:444-458):
    the ids to the host and their CIDEr-D.  Returns (reward [B] float32
    numpy -- cider(sample) - cider(greedy), or the sample's own score under
    use_gen_cider_scores --, the mean of cider(sample) - cider(greedy),
    cider(greedy) averaged).  On a mesh rank (`rows`; JAX loop.py:441-460,
    `_shard_reward`) the data group's sampled and greedy ids are gathered
    (every rank holds the global batch's refs `gts`): the means are the
    global batch's, and the reward this rank's rows of it."""
    b = gen.shape[0]
    gen = collectives.all_gather(gen, rows).cpu().numpy()
    greedy = collectives.all_gather(greedy, rows).cpu().numpy()
    if opt.use_gen_cider_scores:
        reward, scores, cider_greedy = \
            self_critical.get_self_critical_reward(gts, gen, greedy,
                                                   return_gen_scores=True)
    else:
        scores, cider_greedy = self_critical.get_self_critical_reward(
            gts, gen, greedy)
        reward = scores
    reward = collectives.part_of(np.asarray(reward, np.float32), rows, b)
    return reward, float(np.mean(scores)), float(cider_greedy)


def _listener_loss(params, opt, hp, fc, seqs, masks, whole_batch=False,
                   rows=None):
    """The listener's contrastive loss of (fc, seqs), with the hinge weight
    as a tensor (the JAX package passes it traced: the blended form); per
    sample [B] with `whole_batch`, else summed.  `rows`: a mesh run's data
    group (the global batch's matrix, this rank's share)."""
    listener = vse.VSEModel(params["listener"], opt)
    return listener(fc, None, seqs, masks, whole_batch=whole_batch,
                    only_one_retrieval=opt.only_one_retrieval,
                    max_violation_w=_scalar(hp.vse_max_w, fc.device),
                    rows=rows)


def _scalar(x, device):
    """x as a 0-d float32 tensor on `device`: a staged tensor as it is, a
    Python number by a fill (no host-to-device copy, so a CUDA graph can
    capture it)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=device)


def _sampled_captions(seq, vocab_size):
    """(ids with a BOS column in front, their masks): a sampled sequence
    as the listener reads it (JAX joint.py:210-212, 255-256)."""
    return _prepend_bos_ids(seq.long(), vocab_size), \
        losses.masks_from_seq(seq)


def _listener_turn(modules, params, opt, batch, rng, hp, train, sampled,
                   rows=None):
    """The listener turn (JAX joint.py:205-219; ref :528-555): captions
    sampled from the frozen speaker on the 'listener' stream train the
    listener's contrastive loss; the sample runs without autograd on a
    detached view (JAX stop-gradients the ids), so the speaker's gradient
    is zero."""
    kw = _sample_kwargs(opt, hp, train)
    with torch.no_grad():
        spk, r, ctx = _speaker(modules, detached(params), opt, batch, rng,
                               train, kw["drop_prob"], rows)
        out = decoding.sample(spk, ctx, opt.seq_length, r["listener"],
                              mode="sample", temperature=1.0, **kw)
    sampled["listener_seq"] = out.seq
    seqs, masks = _sampled_captions(out.seq, opt.vocab_size)
    loss_vse = _listener_loss(params, opt, hp, batch.get("fc_feats"), seqs,
                              masks, rows=rows)
    return hp.vse_loss_weight * loss_vse, {"loss_vse": loss_vse,
                                           "vse_contrastive": loss_vse}


def _reinforce_disc(modules, spk, ctx, r, params, opt, hp, batch, kw,
                    rows=None):
    """REINFORCE DISC (JAX joint.py:252-289; ref :226-332): a multinomial
    sample from the 'disc' stream, the listener's per-sample retrieval loss
    of it, less a baseline -- the retrieval loss of a greedy decode (on the
    'greedy' stream, without autograd on a detached view: the heads have no
    backward, and JAX stop-gradients it), of the GT captions, or none --
    as the constant coefficient of the sample's log-probs.  Returns (the
    sample, its masks, the surrogate loss, the aux entries)."""
    V = opt.vocab_size
    fc = batch.get("fc_feats")
    out = decoding.sample(spk, ctx, opt.seq_length, r["disc"], mode="sample",
                          temperature=1.0, **kw)
    seqs, out_masks = _sampled_captions(out.seq, V)
    with torch.no_grad():
        # values only: the coefficient is a constant, so neither agent
        # takes a gradient from these forwards
        retrieval_loss = _listener_loss(params, opt, hp, fc, seqs, out_masks,
                                        whole_batch=True, rows=rows)
        kind = opt.reinforce_baseline_type
        if kind == "greedy":
            gspk = modules["speaker"](detached(speaker_view(params, opt)))
            gout = decoding.sample(gspk, detached(ctx), opt.seq_length,
                                   r["greedy"], mode="greedy", **kw)
            baseline = _listener_loss(params, opt, hp, fc,
                                      *_sampled_captions(gout.seq, V),
                                      whole_batch=True, rows=rows)
        elif kind == "gt":
            baseline = _listener_loss(params, opt, hp, fc, batch["labels"],
                                      batch["masks"], whole_batch=True,
                                      rows=rows)
        else:
            baseline = torch.zeros_like(retrieval_loss)
        coeff = retrieval_loss - baseline
    sc_loss = losses.self_critical_loss(out.logprobs, coeff, out_masks, rows)
    aux = {"retrieval_sc_loss": sc_loss,
           "retrieval_loss": retrieval_loss.sum(),
           "retrieval_loss_greedy": baseline.sum()}
    return out, out_masks, sc_loss, aux


def _device_reward(modules, params, opt, batch, ctx, r, kw, seq, aux,
                   rows=None):
    """The on-device CIDEr-D reward of the sampled ids `seq` (JAX
    joint.py:318-338): a greedy decode from the 'greedy' stream, without
    autograd on detached views (the heads refuse inputs that need one; JAX
    stop-gradients it), both scored by the hashed n-gram tier against the
    batch's padded refs.  Returns the reward (cider(sample) -
    cider(greedy), or the sample's own score under use_gen_cider_scores)
    and adds avg_reward and cider_greedy to `aux`, as device scalars.  On
    a mesh (`rows`; the refs the global batch's) the data group's ids are
    gathered and scored as one batch, and the rank keeps its rows of the
    reward and its shares of the two means."""
    with torch.no_grad():
        gspk = modules["speaker"](detached(speaker_view(params, opt)))
        greedy = decoding.sample(gspk, detached(ctx), opt.seq_length,
                                 r["greedy"], mode="greedy", **kw).seq
        b = seq.shape[0]
        scores, cider_gen, _ = ngram_device.ciderd_rewards_device(
            collectives.all_gather(seq.detach(), rows),
            collectives.all_gather(greedy, rows), batch["refs"],
            batch["ref_mask"], seq_per_img=opt.seq_per_img,
            df_table=batch.get("df_table"))
        scores = collectives.part_of(scores, rows, b)
        cider_gen = collectives.part_of(cider_gen, rows, b)
        n = b * (rows.size if rows is not None else 1)
    # the global means, as shares the data group's sum restores
    aux["avg_reward"] = scores.sum() / n
    aux["cider_greedy"] = (cider_gen - scores).sum() / n
    return cider_gen if opt.use_gen_cider_scores else scores


def loss_fn(modules, params, opt, batch, rng, hp, turn, reward=None,
            train=True, sampled=None, rows=None):
    """Stage B: total loss and aux dict (JAX joint.py:181-345) for the turns
    'optimizer', 'speaker' and 'listener'.

    modules: {'speaker': the speaker class}; params: the joint tree;
    batch: tensors on the device ('fc_feats', 'att_feats', 'att_masks',
    'labels' [B, L+2], 'masks' [B, L+2]); rng: the named streams
    (`streams`), or one torch.Generator / draw source for all of them;
    reward: [B], the CIDEr coefficient from the host (cider(sample) -
    cider(greedy), or the raw scores under use_gen_cider_scores); with
    on_device_cider and 'refs' in the batch the step computes it itself,
    and with soft_cider the soft CIDEr replaces it (batch keys 'refs' [n_img,
    R, L], 'ref_mask' [n_img, R], optionally 'df_table').
    `sampled`, a dict when given, receives the CIDEr branch's sampled ids
    under 'seq', DISC's under 'disc_seq' and the listener turn's under
    'listener_seq'.  `rows`, the data group of a mesh run whose ranks hold
    shares of the batch's rows (`reward` then this rank's rows of it, and
    'refs' / 'ref_mask' the global batch's), makes every term this rank's
    share of the global batch's loss (see the module's docstring).
    Returns (loss, aux) with aux keys of the JAX package's."""
    check_ported(opt, turn)
    if sampled is None:
        sampled = {}
    if turn == "listener":
        return _listener_turn(modules, params, opt, batch, rng, hp, train,
                              sampled, rows)
    kw = _sample_kwargs(opt, hp, train)
    drop = kw["drop_prob"]
    spk, r, ctx = _speaker(modules, params, opt, batch, rng, train, drop,
                           rows)
    V = opt.vocab_size
    fc = batch.get("fc_feats")
    labels = batch["labels"]
    masks = batch["masks"]
    loss = torch.zeros((), dtype=torch.float32, device=labels.device)
    aux = {}

    # ---- MLE (ref :196-207) ----
    if opt.caption_loss_weight > 0:
        if getattr(opt, "remat", 0):
            # fused CE + per-step recompute: no [B, T, V+1] residual
            loss_cap = decoding.teacher_forced_loss(
                spk, ctx, labels[:, :-1], labels[:, 1:], masks[:, 1:],
                r["xe"], train, drop, hp.ss_prob, rows=rows)
        else:
            lps = decoding.teacher_forced_logprobs(
                spk, ctx, labels[:, :-1], r["xe"], train, drop, hp.ss_prob)
            loss_cap = losses.language_model_criterion(
                lps, labels[:, 1:], masks[:, 1:], rows=rows)
        loss = loss + hp.caption_loss_weight * loss_cap
        aux["loss_cap"] = loss_cap
        aux["cap_xe"] = loss_cap

    # ---- GT contrastive (ref :209-224), zeroed on the speaker turn ----
    if opt.vse_loss_weight > 0 and has_listener(opt) and turn != "speaker":
        loss_vse = _listener_loss(params, opt, hp, fc, labels, masks,
                                  rows=rows)
        loss = loss + hp.vse_loss_weight * loss_vse
        aux["loss_vse"] = loss_vse
        aux["vse_contrastive"] = loss_vse

    gen = None  # (seq, logprobs, masks) of the sample the CIDEr loss takes
    soft = None  # the relaxed rows of the DISC sample (soft CIDEr)
    # ---- DISC, REINFORCE (ref :226-332) ----
    if _disc_active(opt, turn) and opt.retrieval_reward == "reinforce":
        out, out_masks, sc_loss, disc_aux = _reinforce_disc(
            modules, spk, ctx, r, params, opt, hp, batch, kw, rows)
        loss = loss + hp.retrieval_reward_weight * sc_loss
        aux.update(disc_aux)
        sampled["disc_seq"] = out.seq
        gen = (out.seq, out.logprobs, out_masks)
    # ---- DISC, straight-through / partial sampling (ref :343-376) ----
    elif _disc_active(opt, turn):
        out = decoding.sample(spk, ctx, opt.seq_length, r["disc"],
                              mode=_MODE_MAP[opt.retrieval_reward],
                              temperature=1.0, **kw)
        out_masks = losses.masks_from_seq(out.seq)
        retrieval_loss = _listener_loss(
            params, opt, hp, fc, _prepend_bos_one_hot(out.soft, V),
            out_masks, rows=rows)
        loss = loss + hp.retrieval_reward_weight * retrieval_loss
        aux["retrieval_loss"] = retrieval_loss
        sampled["disc_seq"] = out.seq
        gen = (out.seq, out.logprobs, out_masks)
        soft = out.soft

    # ---- CIDEr-D self-critical (ref :489-503) ----
    if _cider_active(opt, turn):
        if uses_soft_cider(opt, turn) and "refs" in batch:
            # the differentiable soft CIDEr of DISC's relaxed rows, in
            # place of the REINFORCE term (JAX joint.py:306-317)
            loss_cider = cider_diff.soft_cider_loss(
                soft, batch["refs"], batch["ref_mask"], rows)
            loss = loss + hp.cider_weight * loss_cider
            aux["loss_cider"] = loss_cider
            return loss, aux
        # the sampled trajectory of stage A, the reward a constant
        if not _cider_reuses_disc(opt, turn):
            out = decoding.sample(spk, ctx, opt.seq_length, r["cider"],
                                  mode="sample", temperature=1.0, **kw)
            gen = (out.seq, out.logprobs, losses.masks_from_seq(out.seq))
        seq, logprobs, gen_masks = gen
        sampled["seq"] = seq
        if getattr(opt, "on_device_cider", 0) and "refs" in batch:
            reward = _device_reward(modules, params, opt, batch, ctx, r,
                                    kw, seq, aux, rows)
        if reward is None:
            reward = torch.zeros(seq.shape[0], dtype=torch.float32,
                                 device=seq.device)
        loss_cider = losses.self_critical_loss(logprobs, -reward.detach(),
                                               gen_masks, rows)
        loss = loss + hp.cider_weight * loss_cider
        aux["loss_cider"] = loss_cider
    return loss, aux


def value_and_grad(opt, turn, rows=None):
    """fn(params, batch, rng, hp, reward=None, sampled=None) -> ((loss,
    aux), grads), standing in for the JAX `make_raw_fns(opt, turn)[1]`
    (joint.py:350-365).  grads has the structure of params, one gradient
    per leaf that requires grad (zeros where the loss does not reach a
    leaf, as JAX gives); aux values are detached.  `rows`: as loss_fn's
    (a mesh run's data group)."""
    modules = {"speaker": model_zoo.setup(opt, opt.caption_model,
                                          "caption_model")}

    def fn(params, batch, rng, hp, reward=None, sampled=None):
        loss, aux = loss_fn(modules, params, opt, batch, rng, hp, turn,
                            reward, sampled=sampled, rows=rows)
        named = [(k, x) for k, x in leaves(params) if x.requires_grad]
        got = torch.autograd.grad(loss, [x for _, x in named],
                                  allow_unused=True)
        grads = from_leaves((path, torch.zeros_like(x) if g is None else g)
                            for (path, x), g in zip(named, got))
        return ((loss.detach(), {k: v.detach() for k, v in aux.items()}),
                grads)

    return fn


def sampler(opt, turn, rows=None):
    """fn(params, batch, rng, hp) -> (sampled ids, greedy ids), stage A,
    standing in for the JAX `make_raw_fns(opt, turn)[0]`.  `rows`: as
    value_and_grad's."""
    modules = {"speaker": model_zoo.setup(opt, opt.caption_model,
                                          "caption_model")}

    def fn(params, batch, rng, hp):
        return sample_for_reward(modules, params, opt, batch, rng, hp, turn,
                                 rows=rows)

    return fn
