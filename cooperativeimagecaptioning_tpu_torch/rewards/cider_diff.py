"""Differentiable soft CIDEr over word *distributions* (counterpart of the
JAX package's rewards/cider_diff.py; ref cider/pyciderevalcap/cider_diff,
imported by AlternatingJointModel.py:53 and flag-gated by --soft_cider).

For a hypothesis distribution res [T, C] and a reference, per n:
  expected gram frequency  E[g] = (1/(T-n)) * sum_t exp( (1/(n+1)) *
                                   sum_m log res[t+m, w_m] )   (a window at
                                   the tail keeps only the m terms it has,
                                   as the reference's shifted products,
                                   cider_scorer.py:168-183)
  score_n = sum_distinct_g min(E[g], tf_g / sum tf) * idf_g   (:185-199)
  score   = mean over the n that have grams, summed over refs, / n_refs,
            x 10 (:202-213)
No length penalty.  Reference grams are token windows hashed as in
ngram_device, distinct-gram sums use its 1/tf position weight, and the
corpus df its dense containment.  Differentiable in `res`: autograd gives
the gradient the JAX package takes with jax.grad.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cooperativeimagecaptioning_tpu_torch.rewards.ngram_device import (
    NS, _gram_hashes, containment_df)


def soft_cider_scores(res, refs, ref_mask, ref_len_log=None, eps=1e-20):
    """res: [B, T, C] word distributions; refs: [B, R, Lr] token ids (0 =
    EOS); ref_mask: [B, R].  Returns [B] scores, differentiable in `res`.
    Document frequency: corpus mode over the B ref sets
    (cider_scorer.py:99-105)."""
    B, T, C = res.shape
    _, R, Lr = refs.shape
    dev = res.device
    ref_mask = ref_mask.to(torch.float32)
    logres = torch.log(res + eps)                # [B, T, C]
    if ref_len_log is None:
        ref_len_log = torch.full((), float(B), device=dev).log()
    # logres_t[b, c, t]: one gather per gram offset picks [B, R*Lr, T]
    logres_t = logres.transpose(1, 2)

    total = torch.zeros((B, R), device=dev)
    n_count = torch.zeros((B, R), device=dev)
    for n in NS:
        gr, vr = _gram_hashes(refs, n)           # [B, R, Lr]
        vr = vr * ref_mask[..., None]
        # tf within each ref (per position)
        tf = ((gr[..., :, None] == gr[..., None, :]).to(torch.float32)
              * vr[..., None, :]).sum(dim=-1)    # [B, R, Lr]
        tf_total = vr.sum(dim=-1)                # [B, R]
        df = containment_df(gr, gr.reshape(B, R * Lr),
                            vr.reshape(B, R * Lr))
        idf = ref_len_log - torch.log(df.clamp_min(1.0))

        # expected frequency of each ref position's gram in the hypothesis:
        # sum_m logres[t+m, w_m] with tail truncation, exp(/n), mean over t
        acc = None
        for m in range(n):
            w_m = torch.roll(refs, -m, dims=-1) if m else refs
            idx = w_m.to(torch.int64).clamp(0, C - 1).reshape(B, R * Lr)
            lp = torch.gather(logres_t, 1, idx[..., None].expand(
                B, R * Lr, T)).reshape(B, R, Lr, T)
            if m == 0:
                acc = lp
            else:
                # res_freq[:, :-m] += mult[:, m:]  (cider_scorer.py:180-183)
                acc = acc + F.pad(lp[..., m:], (0, m))
        efreq = torch.exp(acc / n).sum(dim=-1) / (T - (n - 1))  # [B, R, Lr]

        ref_freq = tf / tf_total[..., None].clamp_min(1e-9)
        inter = torch.minimum(efreq, ref_freq) * idf
        # distinct grams once: weight each position by valid / tf
        w = vr * torch.where(tf > 0, 1.0 / tf.clamp_min(1e-9),
                             torch.zeros_like(tf))
        score_n = (inter * w).sum(dim=-1)        # [B, R]
        has_grams = (tf_total > 0).to(torch.float32)
        total = total + score_n * has_grams
        n_count = n_count + has_grams

    per_ref = torch.where(n_count > 0, total / n_count.clamp_min(1.0),
                          torch.zeros_like(total))
    n_refs = ref_mask.sum(dim=1).clamp_min(1.0)
    return (per_ref * ref_mask).sum(dim=1) / n_refs * 10.0


def soft_cider_loss(soft_seq, refs, ref_mask):
    """-mean soft CIDEr of the relaxed caption distributions.  soft_seq:
    [B, L, V+2] relaxed one-hot / soft rows from the sampler; the trailing
    BOS column is dropped to match the logit vocabulary."""
    return -soft_cider_scores(soft_seq[..., :-1], refs, ref_mask).mean()
