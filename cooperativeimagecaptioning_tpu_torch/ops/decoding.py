"""Greedy decode and beam search over a speaker module (counterpart of the
JAX package's ops/decoding.py; ref AttModel.py:150-452).

Plain functions of a speaker module (models.setup) and tensors; the JAX
functions' (module, params) pair is one nn.Module here.  Like the JAX package, every loop runs a fixed
`seq_length` steps with an `unfinished` mask and no early break, so the
emitted sequences are zero-padded to full length and every shape is static
(ready for a CUDA graph later).  Token ids: 0 is EOS/pad, V+1 = nclass is
BOS; the embedding has V+2 rows and the logit layer V+1 outputs.

Teacher forcing (`teacher_forced_logprobs`, and `teacher_forced_loss`,
its fused masked-NLL form with per-step rematerialization), `sample` in
all seven modes (greedy, gumbel_noise_max, sample and the four
relaxations of ops/relaxations.py), and `beam_search` (backpointer
formulation).  Random draws come from explicit sources (ops/draws.py).

On a vocab mesh (parallel/vocab.py) the logits are a rank's slice: teacher
forcing takes the vocab-parallel log-softmax and pick, greedy decoding and
beam search the vocab-sharded heads, and the loss is normalised over the
data group (`rows`); the other sampling modes, the decoding constraint of
greedy decoding and scheduled sampling raise NotImplementedError there.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from cooperativeimagecaptioning_tpu_torch.models import layers
from cooperativeimagecaptioning_tpu_torch.ops import draws, relaxations
from cooperativeimagecaptioning_tpu_torch.ops.kernels import beam_head
from cooperativeimagecaptioning_tpu_torch.ops.kernels import logit_head
from cooperativeimagecaptioning_tpu_torch.parallel import collectives, vocab
from cooperativeimagecaptioning_tpu_torch.parallel.mesh import REST

NEG_INF = -1e38


class SampleOutput(NamedTuple):
    seq: Any          # [B, L] int32 -- word ids, 0-padded after EOS
    logprobs: Any     # [B, L] float -- per-step logprob of the chosen word
    soft: Any = None  # [B, L, V+2] relaxed one-hot / soft vectors (one-hot
                      # modes only)


# ---------------------------------------------------------------------------
# Teacher-forced forward
# ---------------------------------------------------------------------------

def _draws(speaker, j, it, prev_lp, gen, drop_prob, ss_prob, use_ss):
    """One step's random draws, made before the step runs: the scheduled-
    sampling replacement of the input ids (JAX decoding.py:77-80, from step
    1 on: with probability ss_prob a row takes a categorical draw from the
    previous step's log-probs) and the dropout keep masks of the embedding
    and the output.  Drawing them here, outside the step, lets a
    checkpointed step be recomputed with the same masks: checkpoint
    restores only the global RNG state, not an explicit generator.  `gen`
    is a torch.Generator or a draw source (ops/draws.py)."""
    B = it.shape[0]
    if use_ss and j >= 1:
        if vocab.logit_mesh(prev_lp) is not None:
            raise NotImplementedError(
                f"scheduled sampling on a vocab-sharded speaker: a "
                f"categorical draw over the model group's slices ({REST})")
        device = it.device
        src = draws.source(gen)
        replace = src.uniform((B,), device) < ss_prob
        # jax.random.categorical: a Gumbel-max over the log-probs
        sampled = torch.argmax(prev_lp.detach() + src.gumbel(
            prev_lp.shape, device), dim=-1)
        it = torch.where(replace, sampled.to(it.dtype), it)
    return it, _step_masks(speaker, B, drop_prob, gen)


def _step_masks(speaker, B, drop_prob, gen):
    """One step's dropout keep masks (embedding, output), drawn in that
    order; a speaker without dropout on its embedding (EMBED_DROPOUT false:
    the FC speaker) draws the output's only."""
    if drop_prob <= 0.0:
        return None, None
    w = speaker.params.logit.w  # [H, V+1]
    emb = layers.keep_mask((B, speaker.params.embed.shape[1]), drop_prob,
                           gen, w.device) if speaker.EMBED_DROPOUT else None
    return emb, layers.keep_mask((B, w.shape[0]), drop_prob, gen, w.device)


def _tf_step(speaker, ctx, h, c, it, emb_mask, out_mask, drop_prob):
    """Embed the input ids, run one step, log-softmax of the logits."""
    xt = speaker.embed_token(it, drop_prob, mask=emb_mask)
    (h, c), out = speaker.step(ctx, (h, c), xt, drop_prob, mask=out_mask)
    lp = vocab.log_softmax(speaker.logits(out))
    return h, c, lp


def _tf_setup(speaker, ctx, B, gen, train, drop_prob, ss_prob):
    """(initial state, effective drop_prob, use_ss) of a teacher-forced
    loop (JAX decoding.py:57-66)."""
    drop = drop_prob if train else 0.0
    use_ss = train and (torch.is_tensor(ss_prob) or ss_prob > 0.0)
    h, c = speaker.init_state(B)
    for pe in speaker.prefix_embeddings(ctx):
        (h, c), _ = speaker.step(ctx, (h, c), pe, drop, gen)
    return (h, c), drop, use_ss


def teacher_forced_logprobs(speaker, ctx, inputs, gen=None, train=False,
                            drop_prob=0.0, ss_prob=0.0):
    """Log-probs of each next-token prediction (JAX decoding.py:42-84).

    inputs: [B, T] token ids -- the reference feeds labels[:, :-1] (column 0
    is the zero pad that acts as the training-time start token).  Returns
    [B, T, V+1] log-probs aligned with targets labels[:, 1:].  In
    training, dropout (drop_prob) and scheduled sampling (ss_prob) draw from
    `gen`, a torch.Generator on the speaker's device."""
    B, T = inputs.shape
    (h, c), drop, use_ss = _tf_setup(speaker, ctx, B, gen, train,
                                     drop_prob, ss_prob)
    lps, lp = [], None
    for j in range(T):
        it, (em, om) = _draws(speaker, j, inputs[:, j], lp, gen, drop,
                              ss_prob, use_ss)
        h, c, lp = _tf_step(speaker, ctx, h, c, it, em, om, drop)
        lps.append(lp)
    return torch.stack(lps, dim=1)


def teacher_forced_loss(speaker, ctx, inputs, targets, masks, gen=None,
                        train=False, drop_prob=0.0, ss_prob=0.0, rows=None):
    """Fused masked-NLL teacher forcing (JAX decoding.py:87-139, the
    --remat 1 path): the math of teacher_forced_logprobs +
    language_model_criterion, with each step's cross-entropy reduced inside
    the loop, so the [B, T, V+1] log-probs are never kept.  Each step runs
    under torch.utils.checkpoint (non-reentrant) in place of
    jax.checkpoint(body): backward recomputes the step's logits instead of
    storing them.  The step's random draws are made outside the checkpoint
    and passed in, so the recompute sees the same masks.

    `rows`, the data group of a mesh run whose ranks hold shares of the
    batch's rows, makes the denominator the global batch's mask sum (JAX
    losses.py:20): the ranks' losses then add up to the global loss, and
    their gradients too.  Under autograd every rank recomputes the
    checkpointed steps in the same order, so the collectives of the
    vocab-parallel log-softmax meet."""
    B, T = inputs.shape
    targets = targets[:, :T]
    masks = masks[:, :T]
    (h, c), drop, use_ss = _tf_setup(speaker, ctx, B, gen, train,
                                     drop_prob, ss_prob)

    def body(h, c, it, tgt, msk, em, om):
        h, c, lp = _tf_step(speaker, ctx, h, c, it, em, om, drop)
        picked = vocab.pick(lp, tgt)
        # lp leaves the step only for the next step's sampling draw
        return h, c, (picked * msk).sum(), (lp if use_ss else None)

    num = den = 0.0
    lp = None
    for j in range(T):
        it, (em, om) = _draws(speaker, j, inputs[:, j], lp, gen, drop,
                              ss_prob, use_ss)
        msk = masks[:, j].float()
        h, c, picked, lp = checkpoint(body, h, c, it, targets[:, j], msk,
                                      em, om, use_reentrant=False,
                                      preserve_rng_state=False)
        num = num + picked
        den = den + msk.sum()
    if rows is not None:
        den = collectives.all_reduce(den, rows)
    return -num / den


def _batch_size(ctx):
    """Rows of a context in any of its layouts: the K-major one carries the
    batch on axis 1; the FC speaker's holds the fc features only (JAX
    decoding.py:219-224)."""
    if "att_feats_t" in ctx:
        return ctx["att_feats_t"].shape[1]
    for key in ("att_feats", "att_feats_q", "fc_feats"):
        if ctx.get(key) is not None:
            return ctx[key].shape[0]
    raise ValueError(f"a context without features: {sorted(ctx)}")


_div = relaxations._div  # x / t with t as a tensor of x's dtype


def _one_hot_row(n, hot, like):
    """[n] zeros of `like`'s dtype and device with a 1 at `hot`, written by
    kernels alone (item assignment of a Python number copies it from the
    host, which a CUDA graph capture refuses)."""
    idx = torch.full((1,), hot, dtype=torch.long, device=like.device)
    return like.new_zeros((n,)).index_fill_(0, idx, 1.0)


ONE_HOT_MODES = ("gumbel_st", "multinomial_st", "gumbel_soft",
                 "multinomial_soft")
SOFT_INPUT_MODES = ("gumbel_soft", "multinomial_soft")
# the draws of one token selection, in the JAX package's key order
# (decoding.py:158-198, relaxations.py:55, 90): Gumbel or uniform noise
# over [B, V+1], then the [B] row mask of the partial-sampling modes
_SELECT_NOISE = {
    "greedy": (), "gumbel_noise_max": ("uniform",), "sample": ("gumbel",),
    "gumbel_st": ("uniform",), "multinomial_st": ("gumbel",),
    "gumbel_soft": ("uniform", "rows"),
    "multinomial_soft": ("gumbel", "rows"),
}


def _make_selector(mode, temperature, gumbel_temp, multinomial_temp,
                   prob_gumbel_softmax, prob_multinomial_soft):
    """Token selector (JAX decoding.py:146-198): (rng, logprobs) -> (ids,
    their logprob, the relaxed one-hot or None).

      greedy           sample_max == 1
      gumbel_noise_max sample_max == 2 (ref FCModel.py:284-289)
      sample           a multinomial draw at `temperature` (a Gumbel-max)
      gumbel_st        retrieval_reward == 'gumbel'
      multinomial_st   retrieval_reward == 'multinomial'
      gumbel_soft      retrieval_reward == 'gumbel_softmax'
      multinomial_soft retrieval_reward == 'multinomial_soft'
    """
    def gather(lp, it):
        return torch.gather(lp, 1, it[:, None])[:, 0]

    def relaxed(fn, *args):
        def select(rng, lp):
            y, it = fn(rng, lp, *args)
            return it, gather(lp, it), y
        return select

    if mode == "greedy":
        def select(rng, lp):
            return lp.argmax(dim=-1), lp.max(dim=-1).values, None
    elif mode == "gumbel_noise_max":
        def select(rng, lp):
            # ref FCModel.py:285-289: -log(-log(U + eps) + eps), eps = 1e-9
            u = rng.uniform(lp.shape, lp.device)
            noise = -torch.log(-torch.log(u + 1e-9) + 1e-9)
            perturbed = _div(lp + noise, temperature)
            return (perturbed.argmax(dim=-1), perturbed.max(dim=-1).values,
                    None)
    elif mode == "sample":
        def select(rng, lp):
            it = torch.argmax(_div(lp, temperature)
                              + rng.gumbel(lp.shape, lp.device), dim=-1)
            return it, gather(lp, it), None
    elif mode == "gumbel_st":
        select = relaxed(relaxations.gumbel_st, gumbel_temp)
    elif mode == "multinomial_st":
        select = relaxed(relaxations.multinomial_st, multinomial_temp)
    elif mode == "gumbel_soft":
        select = relaxed(relaxations.gumbel_soft, gumbel_temp,
                         prob_gumbel_softmax)
    elif mode == "multinomial_soft":
        select = relaxed(relaxations.multinomial_soft, multinomial_temp,
                         prob_multinomial_soft)
    else:
        raise ValueError(f"unknown sampling mode: {mode}")
    return select


def _select_noise(rng, mode, shape, device):
    """The noise of one selection, drawn ahead of it."""
    return [rng.uniform(shape[:1], device) if kind == "rows"
            else getattr(rng, kind)(shape, device)
            for kind in _SELECT_NOISE[mode]]


def sample(speaker, ctx, seq_length, rng=None, mode="greedy",
           temperature=1.0, gumbel_temp=10.0, multinomial_temp=1.0,
           prob_gumbel_softmax=0.25, prob_multinomial_soft=0.25,
           decoding_constraint=0, train=False, drop_prob=0.0, remat=False):
    """Autoregressive sampling over a fixed `seq_length` steps (ref
    AttModel.py:291-452; JAX decoding.py:201-328).

    Step order as in the reference: select a token from the previous
    step's logprobs, record it (masked by `unfinished`), embed the raw
    token (the hard modes) or the raw relaxed vector (the two soft modes,
    AttModel.py:395-399), run the core.  `soft` [B, L, V+2] (the one-hot
    modes only) holds the relaxed emissions, finished rows replaced by the
    EOS one-hot (AttModel.py:416-433).  With decoding_constraint the step
    adds -1e38 at the previous word before the log-softmax.  Greedy without
    it takes the fused greedy head (argmax and its logprob, no [B, V]
    log-softmax); that head has no backward, so run it without autograd.

    Every draw -- selection noise, the row masks, the dropout masks of
    `train` -- comes from `rng`, a draw source (ops/draws.py) or a
    torch.Generator, in the JAX package's key order.  A step's draws are
    made before it, so with `remat` (under autograd) each step after the
    first runs under torch.utils.checkpoint and its recompute sees the same
    noise and masks."""
    if mode not in _SELECT_NOISE:
        raise ValueError(f"unknown sampling mode: {mode}")
    one_hot = mode in ONE_HOT_MODES
    select = _make_selector(mode, temperature, gumbel_temp, multinomial_temp,
                            prob_gumbel_softmax, prob_multinomial_soft)
    rng = draws.source(rng)
    drop = drop_prob if train else 0.0
    B = _batch_size(ctx)
    w, b = speaker.params.logit.w, speaker.params.logit.b
    nclass = vocab.nclass(w)  # V+1, also where w is a vocab slice
    bos = nclass              # BOS id = vocab_size + 1
    device = w.device
    use_fused = mode == "greedy" and not decoding_constraint
    if vocab.logit_mesh(w) is not None and not use_fused:
        raise NotImplementedError(
            f"sample(mode={mode!r}, decoding_constraint="
            f"{decoding_constraint}) on a vocab-sharded speaker: only greedy "
            f"decoding through the sharded head is ported ({REST})")
    shape = (B, nclass)

    state = speaker.init_state(B)
    for pe in speaker.prefix_embeddings(ctx):
        state, _ = speaker.step(ctx, state, pe, drop, rng)

    def head(out, prev_it=None):
        if use_fused:
            return logit_head.greedy_head(out, w, b)
        logits = speaker.logits(out)
        if prev_it is not None:
            penalty = torch.zeros_like(logits).scatter_(
                1, prev_it.long()[:, None], NEG_INF)
            logits = logits + penalty
        return torch.log_softmax(logits, dim=-1)

    def emit(t, lp, unfinished, noise):
        """Select, then the unfinished-mask bookkeeping of
        AttModel.py:401-434."""
        if use_fused:
            (it, sample_lp), y = lp, None
        else:
            it, sample_lp, y = select(draws.Replay(noise), lp)
        unfinished = (it > 0) if t == 1 else unfinished & (it > 0)
        it_masked = it * unfinished.to(it.dtype)
        oh = None
        if one_hot:
            oh = torch.cat([y, y.new_zeros((B, 1))], dim=1)  # [B, V+2]
            eos = _one_hot_row(oh.shape[1], 0, oh)
            oh = torch.where(unfinished[:, None], oh, eos)
        return it, it_masked, sample_lp, y, unfinished, oh

    def body(t, state, lp, unfinished, noise, em, om):
        it, it_masked, sample_lp, y, unfinished, oh = emit(
            t, lp, unfinished, noise)
        if mode in SOFT_INPUT_MODES:
            xt = speaker.embed_soft(torch.cat([y, y.new_zeros((B, 1))], 1),
                                    drop, mask=em)
        else:
            xt = speaker.embed_token(it, drop, mask=em)
        state, out = speaker.step(ctx, state, xt, drop, mask=om)
        lp = head(out, it_masked if decoding_constraint else None)
        return state, lp, unfinished, it_masked, sample_lp, oh

    # t = 0: the BOS step
    em, om = _step_masks(speaker, B, drop, rng)
    xt = speaker.embed_token(
        torch.full((B,), bos, dtype=torch.int32, device=device), drop,
        mask=em)
    state, out = speaker.step(ctx, state, xt, drop, mask=om)
    lp = head(out)

    use_ckpt = remat and torch.is_grad_enabled()
    unfinished = None
    seqs, lps, ohs = [], [], []
    for t in range(1, seq_length):
        noise = _select_noise(rng, mode, shape, device)
        em, om = _step_masks(speaker, B, drop, rng)
        if use_ckpt:
            state, lp, unfinished, it_masked, sample_lp, oh = checkpoint(
                body, t, state, lp, unfinished, noise, em, om,
                use_reentrant=False, preserve_rng_state=False)
        else:
            state, lp, unfinished, it_masked, sample_lp, oh = body(
                t, state, lp, unfinished, noise, em, om)
        seqs.append(it_masked)
        lps.append(sample_lp)
        ohs.append(oh)
    # the last selection uses no further core step
    noise = _select_noise(rng, mode, shape, device)
    _, it_masked, sample_lp, _, _, oh = emit(seq_length, lp, unfinished,
                                             noise)
    seqs.append(it_masked)
    lps.append(sample_lp)
    ohs.append(oh)
    seq = torch.stack(seqs, dim=1).to(torch.int32)
    soft = torch.stack(ohs, dim=1) if one_hot else None
    return SampleOutput(seq, torch.stack(lps, dim=1), soft)


def _expand_for_beams(ctx, m):
    """[B, ...] -> [B*m, ...]: each row repeated m times in place
    (jnp.repeat, i.e. repeat_interleave -- not Tensor.repeat).  The
    transposed entries of a K-major context (keys ending in `_t`) carry the
    batch on axis 1; every other entry, the mask and the int8 scales
    included, on axis 0 (JAX decoding.py:373-383).  The expansion runs
    eagerly, once, and its results are contiguous."""
    return {k: None if v is None else v.repeat_interleave(
                m, dim=1 if k.endswith("_t") else 0).contiguous()
            for k, v in ctx.items()}


def beam_search(speaker, ctx, seq_length, beam_size, decoding_constraint=0):
    """Vectorized beam search (ref AttModel.py:150-289; JAX
    decoding.py:346-510), in the backpointer formulation: each step stores
    (q source beam, c word, r logprob) rows and one reverse backtrack
    rebuilds the best sequence.

    Reference semantics kept: only beam 0 is live at the first merge; a beam
    that emits EOS is recorded as done and keeps decoding; every beam is
    recorded at the last step; ties take the lower candidate index
    (lax.top_k order).  With decoding_constraint the head fetches kk = m+1
    candidates per beam so the top m survive masking the previous word.
    Returns SampleOutput(seq [B, L], logprobs [B, L])."""
    B = _batch_size(ctx)
    m = beam_size
    L = seq_length
    w, b = speaker.params.logit.w, speaker.params.logit.b
    bos = vocab.nclass(w)
    device = w.device
    f32 = torch.float32
    ectx = _expand_for_beams(ctx, m)
    state = speaker.init_state(B * m)
    for pe in speaker.prefix_embeddings(ectx):
        state, _ = speaker.step(ectx, state, pe)

    kk = m + 1 if decoding_constraint else m

    def head(out):
        vals, idx, lse = beam_head.beam_head(out, w, b, kk)
        return ((vals - lse[:, None]).reshape(B, m, kk),
                idx.long().reshape(B, m, kk))

    xt = speaker.embed_token(
        torch.full((B * m,), bos, dtype=torch.int32, device=device))
    state, out = speaker.step(ectx, state, xt)
    lp = head(out)

    beam_sum = torch.full((B, m), NEG_INF, dtype=f32, device=device)
    beam_sum[:, 0] = 0.0
    best_p = torch.full((B,), NEG_INF, dtype=f32, device=device)
    best_t = torch.zeros((B,), dtype=torch.long, device=device)
    best_j = torch.zeros((B,), dtype=torch.long, device=device)
    prev_c = torch.zeros((B, m), dtype=torch.long, device=device)

    def merge(t, lp, beam_sum, prev_c, best_p, best_t, best_j):
        top_lp, top_i = lp
        if decoding_constraint and t > 1:
            # forbid repeating the word each beam emitted at the last merge
            # (ref AttModel.py:203-206), then keep the top m of kk = m+1
            forbid = top_i == prev_c[:, :, None]
            top_lp = torch.where(forbid, torch.full_like(top_lp, NEG_INF),
                                 top_lp)
        if decoding_constraint:
            top_lp, sel = beam_head.top_k(top_lp, m)
            top_i = torch.gather(top_i, 2, sel)
        cand = beam_sum[:, :, None] + top_lp                 # [B, m, m]
        p, flat = beam_head.top_k(cand.reshape(B, m * m), m)
        q = flat // m
        c = torch.gather(top_i.reshape(B, m * m), 1, flat)
        r = torch.gather(top_lp.reshape(B, m * m), 1, flat)
        # done-beam record: argmax is the first max (candidate-rank order)
        is_done = (c == 0) | (t == L)
        done_p = torch.where(is_done, p, torch.full_like(p, NEG_INF))
        cand_j = torch.argmax(done_p, dim=1)
        cand_p = torch.gather(done_p, 1, cand_j[:, None])[:, 0]
        improved = cand_p > best_p
        best_p = torch.where(improved, cand_p, best_p)
        best_t = torch.where(improved, torch.full_like(best_t, t), best_t)
        best_j = torch.where(improved, cand_j, best_j)
        return q, c, r, p, best_p, best_t, best_j

    qs, cs, rs = [], [], []
    for t in range(1, L + 1):
        q, c, r, beam_sum, best_p, best_t, best_j = merge(
            t, lp, beam_sum, prev_c, best_p, best_t, best_j)
        qs.append(q)
        cs.append(c)
        rs.append(r)
        if t == L:
            break  # the final merge needs no core step after it
        prev_c = c
        # gather the recurrent state by source beam
        state = tuple(
            torch.gather(x.reshape(B, m, -1), 1,
                         q[:, :, None].expand(B, m, x.shape[-1])
                         ).reshape(B * m, -1)
            for x in state)
        xt = speaker.embed_token(c.reshape(B * m))
        state, out = speaker.step(ectx, state, xt)
        lp = head(out)

    # reverse backtrack from (best_t, best_j) along the q pointers;
    # positions past best_t stay 0
    j = torch.zeros((B,), dtype=torch.long, device=device)
    words, logps = [], []
    for t in range(L, 0, -1):
        q_t, c_t, r_t = qs[t - 1], cs[t - 1], rs[t - 1]
        j = torch.where(best_t == t, best_j, j)
        active = t <= best_t
        jj = j[:, None]
        words.append(torch.where(active, torch.gather(c_t, 1, jj)[:, 0],
                                 torch.zeros_like(j)))
        logps.append(torch.where(active, torch.gather(r_t, 1, jj)[:, 0],
                                 torch.zeros((B,), dtype=r_t.dtype,
                                             device=device)))
        j = torch.where(active, torch.gather(q_t, 1, jj)[:, 0], j)
    seq = torch.stack(words[::-1], dim=1).to(torch.int32)
    return SampleOutput(seq, torch.stack(logps[::-1], dim=1))
