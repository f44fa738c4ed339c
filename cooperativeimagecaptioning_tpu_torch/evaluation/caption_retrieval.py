"""Caption<->caption retrieval experiments (ref: eval_utils.py:723-1286).

gen2gt: each generated caption queries the 5N GT caption pool; its rank is the
best rank among its own image's GT captions (ref :953-998).
gt2gen: each GT caption queries the N generated captions; rank of its image's
generated caption (ref :1001-1041).
evalrankcap: drives both, optionally on first/second caption halves
(ref :723-830 + encode_data_halves :1043-1286) -- the half length is the
batch-level min(floor(mean_len/2), shortest-1) rule of the reference.

The port's counterpart of the JAX package's evaluation/caption_retrieval.py,
over the port's evaluator and rank core (evaluation/retrieval.py).
"""

from __future__ import annotations

import numpy as np
import torch

from cooperativeimagecaptioning_tpu_torch.evaluation.retrieval import (
    recall_stats, scores_ranks_hits)
from cooperativeimagecaptioning_tpu_torch.ops import losses


def gen2gt(cap_embs_generated, cap_embs_gt, caps_per_image=5,
           return_ranks=False):
    """Generated caption -> GT caption pool: each of the N generated captions
    queries all cpi*N GT captions; its rank is the best rank among its own
    image's cpi GT captions (ref: eval_utils.py:953-998).  Ranks come from the
    vectorized counting core in `retrieval` — no per-query loops."""
    cpi = caps_per_image
    gen, gt = cap_embs_generated, cap_embs_gt
    n_img = gen.shape[0]
    own = np.arange(n_img)[:, None] * cpi + np.arange(cpi)[None, :]
    rt, hits = scores_ranks_hits(gen, gt, own, 1)        # device rank core
    ranks = rt.min(axis=1).astype(np.float64)
    top1 = hits[:, 0].astype(np.float64)
    stats = recall_stats(ranks)
    if return_ranks:
        return stats, (ranks, top1)
    return stats


def gt2gen(cap_embs_generated, cap_embs_gt, caps_per_image=5,
           return_ranks=False):
    """GT caption -> generated caption pool: each of the cpi*N GT captions
    queries the N generated captions; its rank is that of its own image's
    generated caption (ref: eval_utils.py:1001-1041)."""
    cpi = caps_per_image
    gen, gt = cap_embs_generated, cap_embs_gt
    n_img = gen.shape[0]
    queries = gt[: cpi * n_img]
    correct = np.repeat(np.arange(n_img), cpi)[:, None]
    rt, hits = scores_ranks_hits(queries, gen, correct, 1)
    ranks = rt[:, 0].astype(np.float64)
    top1 = hits[:, 0].astype(np.float64)
    stats = recall_stats(ranks)
    if return_ranks:
        return stats, (ranks, top1)
    return stats


def split_halves(seqs, masks, batch_lens, shared_lens=None):
    """Reference half-split rule (eval_utils.py:1122-1146): half =
    min(floor(mean_len / 2), shortest - 1) computed over the batch — over
    shared_lens when given (the reference computes ONE half over the GT and
    generated groups together, eval_utils.py:1128-1148, so both groups are
    cut at the same point); returns
    ((first_seqs, first_masks), (second_seqs, second_masks))."""
    lens = np.asarray(batch_lens)
    hl = np.asarray(shared_lens) if shared_lens is not None else lens
    half = int(min(np.floor(hl.mean() / 2), hl.min() - 1))
    half = max(half, 1)
    first_s = seqs[:, :half]
    first_m = masks[:, :half]
    L = seqs.shape[1]
    second_s = np.zeros_like(seqs[:, : L - half])
    second_m = np.zeros_like(masks[:, : L - half])
    for i in range(seqs.shape[0]):
        n = int(lens[i])
        second_s[i, : n - half] = seqs[i, half:n]
        second_m[i, : n - half] = masks[i, half:n]
    return (first_s, first_m), (second_s, second_m)


def evalrankcap(evaluator, params, loader, eval_kwargs=None,
                divide_caption=0):
    """ref: eval_utils.py:723-830."""
    if "listener" not in params:
        return {}
    ek = dict(eval_kwargs or {})
    split = ek.get("split", "val")
    num_images = ek.get("num_images", ek.get("val_images_use", -1))
    cpi = getattr(loader.ds, "gt_caps_per_image", 5)
    opt = evaluator.opt
    V = opt.vocab_size

    # GT captions: cpi per image
    saved_spi = loader.seq_per_img
    loader.seq_per_img = cpi
    loader.reset_iterator(split)
    decode = evaluator._decode_fn(1)
    gt_parts, gen_parts = [], []
    n = 0
    while True:
        data = loader.get_batch(split)
        n += loader.batch_size
        labels = np.asarray(data["labels"])
        masks = np.asarray(data["masks"])
        fc, att, am = evaluator._dedup(data, loader)
        seq, _ = decode(params, fc, att, am)
        seq_masks = losses.masks_from_seq(seq).cpu().numpy()
        seq = seq.cpu().numpy()
        bos = np.full((seq.shape[0], 1), V + 1, seq.dtype)
        gen_seqs = np.hstack([bos, seq])

        if divide_caption:
            gt_lens = masks.sum(1) - 2    # (ref :1154)
            gen_lens = seq_masks.sum(1) - 1
            both = np.concatenate([gt_lens, gen_lens])
            (gt1, gt1m), (gt2, gt2m) = split_halves(labels, masks, gt_lens,
                                                    shared_lens=both)
            (gn1, gn1m), (gn2, gn2m) = split_halves(gen_seqs, seq_masks,
                                                    gen_lens,
                                                    shared_lens=both)
            gt_parts.append(((gt1, gt1m), (gt2, gt2m)))
            gen_parts.append(((gn1, gn1m), (gn2, gn2m)))
        else:
            gt_parts.append((labels, masks))
            gen_parts.append((gen_seqs, seq_masks))

        ix1 = data["bounds"]["it_max"]
        if num_images != -1:
            ix1 = min(ix1, num_images)
        if data["bounds"]["wrapped"] or (0 <= num_images <= n):
            break
    loader.seq_per_img = saved_spi
    n_img = ix1  # final batch may overshoot/wrap — pools trim to this
                 # (ref encode_data_cap slices to ix1, eval_utils.py:945-946)

    def embed(parts):
        embs = []
        for seqs, masks in parts:
            m = evaluator._put(np.maximum(masks, _min_mask(masks)))
            embs.append(evaluator.encode_fn(
                params, evaluator._put(np.zeros((seqs.shape[0],
                                                 opt.fc_feat_size))),
                evaluator._put(seqs, torch.int64), m)[1].cpu().numpy())
        return np.vstack(embs)

    def _min_mask(masks):
        # guard all-zero mask rows (degenerate splits)
        mm = np.zeros_like(masks)
        mm[:, 0] = 1.0
        return mm

    if not divide_caption:
        gt_embs = embed(gt_parts)[: n_img * cpi]
        gen_embs = embed(gen_parts)[:n_img]
        assert gen_embs.shape[0] == n_img, (gen_embs.shape, n_img)
        m2gt = gen2gt(gen_embs, gt_embs, cpi)
        gt2m = gt2gen(gen_embs, gt_embs, cpi)
        return {"gen2gt_r1": m2gt[0], "gen2gt_r5": m2gt[1],
                "gen2gt_r10": m2gt[2], "gen2gt_medr": m2gt[3],
                "gen2gt_meanr": m2gt[4],
                "gt2gen_r1": gt2m[0], "gt2gen_r5": gt2m[1],
                "gt2gen_r10": gt2m[2], "gt2gen_medr": gt2m[3],
                "gt2gen_meanr": gt2m[4]}

    out = {}
    for hi, half in enumerate(("first", "second")):
        gt_embs = embed([p[hi] for p in gt_parts])[: n_img * cpi]
        gen_embs = embed([p[hi] for p in gen_parts])[:n_img]
        m2gt = gen2gt(gen_embs, gt_embs, cpi)
        gt2m = gt2gen(gen_embs, gt_embs, cpi)
        out[half] = {"gen2gt": m2gt, "gt2gen": gt2m}
    return out
