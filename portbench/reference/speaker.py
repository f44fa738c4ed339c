"""The loops of the reference speakers: teacher-forced MLE training with
Adam, a plain beam search, and the teacher-forced reading of served
tokens that decides a decode's `correct`.  Plain PyTorch over a model
module of this directory (att2in2.py, fc.py); float32 with TF32 off
unless a caller asks for the control's lower precision."""

from __future__ import annotations

import importlib

import torch

from portbench.reference import common

NEG_INF = -1e38


def model(caption_model: str):
    """The reference module of a configuration's `caption_model`."""
    return importlib.import_module(f"portbench.reference.{caption_model}")


def _logprobs(p, out, q):
    return torch.log_softmax(q(out) @ q(p["logit"]["w"]) + p["logit"]["b"],
                             dim=-1)


NEAR_TIE = 1e-4  # nats: far above the float32 gap of program and reference


def _sampled(it, prev_lp, gen, ss_prob, j, flips, ties):
    """Step j's input ids under scheduled sampling (see mle_loss)."""
    B, dev = it.shape[0], it.device
    replace = torch.rand((B,), generator=gen, device=dev) < ss_prob
    scores = prev_lp + common.gumbel(gen, prev_lp.shape, dev)
    top = torch.topk(scores, 2, dim=-1)
    drawn = scores.argmax(dim=-1)
    near = replace & (top.values[:, 0] - top.values[:, 1] < NEAR_TIE)
    for b in near.nonzero()[:, 0].tolist():
        if ties is not None:
            ties.append((j, b, int(top.indices[b, 1])))
    for (t, b), word in (flips or {}).items():
        if t == j:
            drawn[b] = word
    return torch.where(replace, drawn.to(it.dtype), it)


def mle_loss(mod, p, cfg, feats, labels, masks, gen=None, rate=0.0,
             q=None, rows=None, ss_prob=0.0, flips=None, ties=None):
    """Masked NLL of teacher forcing (misc/utils.py LanguageModelCriterion):
    labels [B, L + 2] with the zero start token in column 0, the inputs
    labels[:, :-1], the targets labels[:, 1:] under masks[:, 1:].  In
    training the draws come from `gen` in the program's order: the
    encoder's dropout mask, then at each word step from the second on,
    with ss_prob > 0, scheduled sampling's (AttModel.py _forward: a row
    takes, with probability ss_prob, a word drawn from the previous step's
    distribution in place of its label; a uniform a row, then Gumbel noise
    over the vocabulary, the draw its Gumbel-max), then the step's
    embedding mask (Att2in2) and output mask (the FC speaker: its image
    step's output mask first).  A sampled word whose two best perturbed
    scores lie within NEAR_TIE is a near-tie, which rounding may break
    either way: each is appended to `ties` as (step, row, runner-up), and
    `flips` {(step, row): word} takes the given word there instead.
    `rows` keeps those rows of the batch only (a fault's reading)."""
    q = q or (lambda x: x)
    B, dev = labels.shape[0], labels.device
    H, D = cfg["rnn_size"], cfg["input_encoding_size"]
    ctx = mod.encode(p, feats, gen, rate, q)
    h = torch.zeros((B, H), dtype=p["embed"].dtype, device=dev)
    c = torch.zeros_like(h)
    for x in mod.prefix(p, ctx, q):
        h, c = mod.step(p, ctx, h, c, x, q)
        if rate > 0.0 and mod.STATE_DROPOUT:
            h = common.dropout(h, common.keep_mask(gen, (B, H), rate, dev),
                               rate)
    inputs, targets, tmask = labels[:, :-1], labels[:, 1:], masks[:, 1:]
    num, lp = 0.0, None
    for j in range(inputs.shape[1]):
        it = inputs[:, j]
        if ss_prob > 0.0 and j >= 1:
            it = _sampled(it, lp.detach(), gen, ss_prob, j, flips, ties)
        em = common.keep_mask(gen, (B, D), rate, dev) \
            if rate > 0.0 and mod.EMBED_DROPOUT else None
        om = common.keep_mask(gen, (B, H), rate, dev) if rate > 0.0 else None
        xt = mod.embed(p, it)
        if em is not None:
            xt = common.dropout(xt, em, rate)
        h, c = mod.step(p, ctx, h, c, xt, q)
        out = common.dropout(h, om, rate) if om is not None else h
        if mod.STATE_DROPOUT:
            h = out
        lp = _logprobs(p, out, q)
        picked = lp.gather(1, targets[:, j:j + 1])[:, 0] * tmask[:, j]
        num = num + (picked if rows is None else picked[rows]).sum()
    den = tmask.sum() if rows is None else tmask[rows].sum()
    return -num / den


def train_steps(mod, cfg, p0, steps, program_seed, tf32=False,
                dtype=torch.float32, epoch=0, flips=None):
    """Follow the program's first steps from the weights p0 ({path:
    tensor}), taken in `epoch`, whose learning rate and scheduled-sampling
    probability they use: each step's loss, the first step's clamped
    gradient (what Adam's first moment holds after one step, over 1 -
    beta1), the change of every leaf after the last step, and the sampled
    words' near-ties ('ties': (step, word step, row, runner-up)).  steps:
    [{'feats', 'labels', 'masks'}] of iterations 0, 1, ...; the draws come
    from the iteration's 'xe' stream as the program seeds it, and `flips`
    {(step, word step, row): word} takes the runner-up of near-ties.
    `dtype` float64 makes the reference a witness of float32's rounding."""
    p = {k: v.detach().to(dtype, copy=True).requires_grad_(True)
         for k, v in p0.items()}
    state, losses, grad1, ties = {}, [], {}, []
    rate = cfg["drop_prob_lm"]
    lr, ss_prob = common.schedule(dict(cfg, **cfg["options"]), epoch)
    for j, st in enumerate(steps):
        dev = st["labels"].device
        gen = common.stream(common.step_seed(program_seed, j), "xe", dev)
        found = []
        with common.matmul_precision(tf32):
            feats = {k: v.to(dtype) if v.is_floating_point() else v
                     for k, v in st["feats"].items()}
            loss = mle_loss(mod, common.nest(p), cfg, feats,
                            st["labels"], st["masks"].to(dtype), gen, rate,
                            rows=st.get("rows"), ss_prob=ss_prob,
                            flips={k[1:]: w for k, w in (flips or {}).items()
                                   if k[0] == j},
                            ties=found)
            got = torch.autograd.grad(loss, list(p.values()),
                                      allow_unused=True)
        ties += [(j,) + t for t in found]
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(p.items(), got)}
        losses.append(float(loss.detach()))
        if j == 0:
            grad1 = {k: torch.clamp(g, -cfg["grad_clip"], cfg["grad_clip"])
                     for k, g in grads.items()}
        if not st.get("frozen"):
            common.adam(p, grads, state, lr,
                        cfg["grad_clip"], cfg["optim_alpha"],
                        cfg["optim_beta"], cfg["optim_epsilon"], j + 1)
    change = {k: (p[k].detach() - p0[k].to(dtype)) for k in p0}
    return {"loss": losses, "grad1": grad1, "change": change, "ties": ties}


def beam_search(mod, p, cfg, feats, m, L, q=None):
    """Beam search as the published code runs it (AttModel.beam_search):
    m beams an image, only beam 0 live at the first merge, each beam's top
    m words, the top m of the m x m candidates, a beam that emits EOS
    recorded as done and decoding on, every beam recorded at the last
    step, ties to the lower candidate; the best recorded sequence is
    returned [N, L] int64, zero after its EOS.  `q` rounds each product's
    inputs (the lower-precision control)."""
    q = q or (lambda x: x)
    V, H = cfg["vocab_size"], cfg["rnn_size"]
    ctx = mod.encode(p, feats, q=q)
    N = next(v for v in ctx.values() if v is not None).shape[0]
    dev = p["embed"].device
    ctx = mod.select_rows(ctx, torch.arange(N, device=dev)
                          .repeat_interleave(m))
    h = torch.zeros((N * m, H), dtype=torch.float32, device=dev)
    c = torch.zeros_like(h)
    for x in mod.prefix(p, ctx, q):
        h, c = mod.step(p, ctx, h, c, x, q)
    ids = torch.full((N * m,), V + 1, dtype=torch.long, device=dev)

    def advance(h, c, ids):
        h, c = mod.step(p, ctx, h, c, mod.embed(p, ids), q)
        return h, c, _logprobs(p, h, q).view(N, m, -1)

    def top(x, k):
        v, i = torch.sort(x, dim=-1, descending=True, stable=True)
        return v[..., :k], i[..., :k]

    h, c, lp = advance(h, c, ids)
    beam_sum = torch.full((N, m), NEG_INF, device=dev)
    beam_sum[:, 0] = 0.0
    best_p = torch.full((N,), NEG_INF, device=dev)
    best_t = torch.zeros((N,), dtype=torch.long, device=dev)
    best_j = torch.zeros((N,), dtype=torch.long, device=dev)
    qs, cs = [], []
    for t in range(1, L + 1):
        top_lp, top_i = top(lp, m)
        pv, flat = top((beam_sum[:, :, None] + top_lp).reshape(N, m * m), m)
        qb = flat // m
        word = top_i.reshape(N, m * m).gather(1, flat)
        done = torch.where((word == 0) | (t == L), pv,
                           torch.full_like(pv, NEG_INF))
        cj = torch.argmax(done, dim=1)
        cp = done.gather(1, cj[:, None])[:, 0]
        better = cp > best_p
        best_p = torch.where(better, cp, best_p)
        best_t = torch.where(better, torch.full_like(best_t, t), best_t)
        best_j = torch.where(better, cj, best_j)
        qs.append(qb)
        cs.append(word)
        beam_sum = pv
        if t == L:
            break
        src = (torch.arange(N, device=dev)[:, None] * m + qb).reshape(-1)
        h, c, lp = advance(h[src], c[src], word.reshape(-1))
    j = torch.zeros((N,), dtype=torch.long, device=dev)
    words = []
    for t in range(L, 0, -1):
        j = torch.where(best_t == t, best_j, j)
        active = t <= best_t
        words.append(torch.where(active, cs[t - 1].gather(1, j[:, None])[:, 0],
                                 torch.zeros_like(j)))
        j = torch.where(active, qs[t - 1].gather(1, j[:, None])[:, 0], j)
    return torch.stack(words[::-1], dim=1)


def served_gaps(mod, p, cfg, feats, tokens, m, control=None):
    """Teacher-force the served tokens [N, L] through the reference and
    read, at each position up to and including the first EOS, how far the
    served token's log-prob lies below the reference's m-th best (0 where
    it is among the top m, as every token a beam-m search serves is
    there).  With `control` (a rounding of products' inputs) the control
    runs along the same tokens on its own state, and at each position the
    tokens it ranks top m are read the same way.  Returns (widest served
    gap, widest control gap or None, tokens read)."""
    ident = lambda x: x  # noqa: E731
    H = cfg["rnn_size"]
    N, L = tokens.shape
    dev = tokens.device
    sides = [ident] + ([control] if control is not None else [])
    runs = []
    for q in sides:
        ctx = mod.encode(p, feats, q=q)
        h = torch.zeros((N, H), dtype=torch.float32, device=dev)
        c = torch.zeros_like(h)
        for x in mod.prefix(p, ctx, q):
            h, c = mod.step(p, ctx, h, c, x, q)
        runs.append([ctx, h, c])
    ids = torch.full((N,), cfg["vocab_size"] + 1, dtype=torch.long,
                     device=dev)
    live = torch.ones((N,), dtype=torch.bool, device=dev)
    worst = [torch.zeros((), device=dev) for _ in sides]
    n_read = torch.zeros((), dtype=torch.long, device=dev)
    for t in range(L):
        lps = []
        for run, q in zip(runs, sides):
            ctx, h, c = run
            h, c = mod.step(p, ctx, h, c, mod.embed(p, ids), q)
            run[1], run[2] = h, c
            lps.append(_logprobs(p, h, q))
        lp = lps[0]
        floor = torch.topk(lp, m, dim=-1).values[:, m - 1]
        tok = tokens[:, t].long()
        gap = (floor - lp.gather(1, tok[:, None])[:, 0]).clamp_min(0)
        worst[0] = torch.maximum(worst[0], (gap * live).max())
        if control is not None:
            picks = torch.topk(lps[1], m, dim=-1).indices
            cgap = (floor[:, None] - lp.gather(1, picks)).clamp_min(0)
            worst[1] = torch.maximum(worst[1],
                                     (cgap.max(dim=1).values * live).max())
        n_read += live.sum()
        live = live & (tok != 0)
        ids = tok
    return (float(worst[0]),
            float(worst[1]) if control is not None else None, int(n_read))


def seq_logprobs(mod, p, cfg, feats, tokens):
    """Teacher-force captions [N, L] through the reference: each caption's
    log-probability, the sum over its words up to and including its first
    EOS (all L where it has none), float32 [N]."""
    H = cfg["rnn_size"]
    N, L = tokens.shape
    dev = tokens.device
    ctx = mod.encode(p, feats)
    h = torch.zeros((N, H), dtype=torch.float32, device=dev)
    c = torch.zeros_like(h)
    for x in mod.prefix(p, ctx):
        h, c = mod.step(p, ctx, h, c, x)
    ids = torch.full((N,), cfg["vocab_size"] + 1, dtype=torch.long,
                     device=dev)
    live = torch.ones((N,), dtype=torch.bool, device=dev)
    total = torch.zeros((N,), dtype=torch.float32, device=dev)
    for t in range(L):
        h, c = mod.step(p, ctx, h, c, mod.embed(p, ids))
        tok = tokens[:, t].long()
        lp = _logprobs(p, h, lambda x: x).gather(1, tok[:, None])[:, 0]
        total = total + torch.where(live, lp, torch.zeros_like(lp))
        live = live & (tok != 0)
        ids = tok
    return total
