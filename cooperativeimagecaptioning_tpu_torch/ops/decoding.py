"""Greedy decode and beam search over a speaker module (counterpart of the
JAX package's ops/decoding.py; ref AttModel.py:150-452).

Plain functions of a speaker module (models.setup) and tensors; the JAX
functions' (module, params) pair is one nn.Module here.  Like the JAX package, every loop runs a fixed
`seq_length` steps with an `unfinished` mask and no early break, so the
emitted sequences are zero-padded to full length and every shape is static
(ready for a CUDA graph later).  Token ids: 0 is EOS/pad, V+1 = nclass is
BOS; the embedding has V+2 rows and the logit layer V+1 outputs.

Ported: teacher forcing (`teacher_forced_logprobs`, and
`teacher_forced_loss`, its fused masked-NLL form with per-step
rematerialization), `sample(mode="greedy")` with and without
decoding_constraint, and `beam_search` (backpointer formulation).  The six
other sampling modes follow in a later slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from cooperativeimagecaptioning_tpu_torch.models import layers

from cooperativeimagecaptioning_tpu_torch.ops.kernels import beam_head
from cooperativeimagecaptioning_tpu_torch.ops.kernels import logit_head

NEG_INF = -1e38


class SampleOutput(NamedTuple):
    seq: Any          # [B, L] int32 -- word ids, 0-padded after EOS
    logprobs: Any     # [B, L] float -- per-step logprob of the chosen word


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
    restores only the global RNG state, not an explicit generator."""
    B = it.shape[0]
    if use_ss and j >= 1:
        device = it.device
        replace = torch.rand((B,), generator=gen, device=device) < ss_prob
        sampled = torch.multinomial(prev_lp.detach().exp(), 1,
                                    generator=gen)[:, 0]
        it = torch.where(replace, sampled.to(it.dtype), it)
    masks = (None, None)
    if drop_prob > 0.0:
        w = speaker.params.logit.w  # [H, V+1]
        masks = (layers.keep_mask((B, speaker.params.embed.shape[1]),
                                  drop_prob, gen, w.device),
                 layers.keep_mask((B, w.shape[0]), drop_prob, gen, w.device))
    return it, masks


def _tf_step(speaker, ctx, h, c, it, emb_mask, out_mask, drop_prob):
    """Embed the input ids, run one step, log-softmax of the logits."""
    xt = speaker.embed_token(it, drop_prob, mask=emb_mask)
    (h, c), out = speaker.step(ctx, (h, c), xt, drop_prob, mask=out_mask)
    lp = torch.log_softmax(speaker.logits(out), dim=-1)
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
                        train=False, drop_prob=0.0, ss_prob=0.0):
    """Fused masked-NLL teacher forcing (JAX decoding.py:87-139, the
    --remat 1 path): the math of teacher_forced_logprobs +
    language_model_criterion, with each step's cross-entropy reduced inside
    the loop, so the [B, T, V+1] log-probs are never kept.  Each step runs
    under torch.utils.checkpoint (non-reentrant) in place of
    jax.checkpoint(body): backward recomputes the step's logits instead of
    storing them.  The step's random draws are made outside the checkpoint
    and passed in, so the recompute sees the same masks."""
    B, T = inputs.shape
    targets = targets[:, :T]
    masks = masks[:, :T]
    (h, c), drop, use_ss = _tf_setup(speaker, ctx, B, gen, train,
                                     drop_prob, ss_prob)

    def body(h, c, it, tgt, msk, em, om):
        h, c, lp = _tf_step(speaker, ctx, h, c, it, em, om, drop)
        picked = torch.gather(lp, 1, tgt[:, None].long())[:, 0]
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
    return -num / den


def _batch_size(ctx):
    """Rows of a context in any of its layouts: the K-major one carries the
    batch on axis 1 (JAX decoding.py:219-224)."""
    if "att_feats_t" in ctx:
        return ctx["att_feats_t"].shape[1]
    return ctx.get("att_feats", ctx.get("att_feats_q")).shape[0]


def sample(speaker, ctx, seq_length, mode="greedy", decoding_constraint=0):
    """Greedy decode (ref AttModel.py:323-444; JAX decoding.py:201-328).

    Without decoding_constraint each step's logits go through the fused
    greedy head (argmax and its logprob, no [B, V] log-softmax).  With it,
    the step takes log_softmax over the full logits after adding -1e38 at
    the previous word (decoding.py:238, 294-299)."""
    if mode != "greedy":
        raise NotImplementedError(
            f"sampling mode {mode!r} is not ported yet (ROADMAP.md queue 1: "
            f"relaxations and the six other sampling modes)")
    B = _batch_size(ctx)
    w, b = speaker.params.logit.w, speaker.params.logit.b
    bos = w.shape[1]  # BOS id = vocab_size + 1 = nclass
    device = w.device
    use_fused = not decoding_constraint

    state = speaker.init_state(B)
    for pe in speaker.prefix_embeddings(ctx):
        state, _ = speaker.step(ctx, state, pe)

    def head(out, prev_it=None):
        if use_fused:
            return logit_head.greedy_head(out, w, b)
        logits = speaker.logits(out)
        if prev_it is not None:
            penalty = torch.zeros_like(logits)
            penalty[torch.arange(B, device=device), prev_it.long()] = NEG_INF
            logits = logits + penalty
        return torch.log_softmax(logits, dim=-1)

    def select(lp):
        if use_fused:
            return lp
        return lp.argmax(dim=-1).to(torch.int32), lp.max(dim=-1).values

    xt = speaker.embed_token(
        torch.full((B,), bos, dtype=torch.int32, device=device))
    state, out = speaker.step(ctx, state, xt)
    lp = head(out)

    seqs, lps = [], []
    unfinished = torch.ones((B,), dtype=torch.bool, device=device)
    for t in range(1, seq_length + 1):
        it, sample_lp = select(lp)
        unfinished = (it > 0) if t == 1 else unfinished & (it > 0)
        it_masked = it * unfinished.to(it.dtype)
        seqs.append(it_masked)
        lps.append(sample_lp)
        if t == seq_length:
            break  # the last selection uses no further core step
        # embed the raw (unmasked) token, as the reference does
        xt = speaker.embed_token(it)
        state, out = speaker.step(ctx, state, xt)
        lp = head(out, it_masked if decoding_constraint else None)
    seq = torch.stack(seqs, dim=1).to(torch.int32)
    return SampleOutput(seq, torch.stack(lps, dim=1))


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
    bos = w.shape[1]
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
