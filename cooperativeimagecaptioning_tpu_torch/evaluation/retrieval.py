"""Retrieval ranking suite (counterpart of the JAX package's
evaluation/retrieval.py; ref eval_utils.py:283-720).

Every rank is computed in closed form from the score matrix: under the
protocol's order (descending score, equal scores ordered by descending
column index -- what a reversed stable ascending argsort gives), the rank
of a target column is

    rank = #{cols strictly above the target} + #{tied cols with larger index}

The numpy core (`target_ranks`, `top_retrieved`, `recall_stats`) is the
port's own copy of the JAX module's.  `scores_ranks_hits` keeps the
embeddings where they are (the card, for the evaluator's): it multiplies
query chunks of at most 512 rows by the pool in float32 with TF32 off (the
JAX package asks for Precision.HIGHEST; a rounded product would move ties)
and counts the ranks and top-k hits with torch, so only the small rank
arrays reach the host.

  i2t          -- image query -> rank of the best of its GT captions
  t2i          -- caption query -> rank of its image, with per-query
                  distractor records for visualization
  rank_metrics -- R@1/5/10, median / mean rank, rsum, optional 5-fold COCO
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


# ---------------------------------------------------------------------------
# the rank core (shared with caption_retrieval)
# ---------------------------------------------------------------------------

def target_ranks(scores, targets):
    """Rank of designated target columns in each row of a score matrix.

    scores  [Q, M] float — similarity of query q to every pool item.
    targets [Q, T] int   — per query, the pool columns that count as correct.
    Returns [Q, T] int64 ranks (0 = retrieved first) under descending-score
    order with ties broken toward the larger column index.

    Chunked over queries so the [chunk, T, M] comparison block stays bounded
    (~16M elements) regardless of pool size.
    """
    scores = np.asarray(scores)
    targets = np.asarray(targets, np.int64)
    Q, M = scores.shape
    T = targets.shape[1]
    out = np.empty((Q, T), np.int64)
    cols = np.arange(M)
    chunk = max(1, (1 << 24) // max(1, M * T))
    for lo in range(0, Q, chunk):
        hi = min(Q, lo + chunk)
        s = scores[lo:hi]
        tgt = targets[lo:hi]
        tval = np.take_along_axis(s, tgt, axis=1)[:, :, None]   # [C, T, 1]
        above = (s[:, None, :] > tval).sum(axis=-1)
        tied_after = ((s[:, None, :] == tval) &
                      (cols[None, None, :] > tgt[:, :, None])).sum(axis=-1)
        out[lo:hi] = above + tied_after
    return out


def top_retrieved(scores, k):
    """Per-row top-k pool columns in retrieval order (descending score, ties
    toward the larger column index): k passes of vectorized masked argmax —
    exact tie handling with no sort (k is 1 or 4 in this protocol).

    Each pass takes the row max, then the largest column attaining it via a
    reversed BOOL argmax — argmax over booleans short-circuits at the first
    True, so this is nearly free even on huge rows (a float reversed-view
    argmax or a broadcast np.where is 50-500x slower here)."""
    s = np.array(scores, copy=True)
    Q, M = s.shape
    k = min(k, M)
    out = np.empty((Q, k), np.int64)
    rows = np.arange(Q)
    low = np.finfo(s.dtype).min if np.issubdtype(s.dtype, np.floating) \
        else np.iinfo(s.dtype).min
    for j in range(k):
        mx = s.max(axis=1)
        eq = s == mx[:, None]
        pick = (M - 1) - np.argmax(eq[:, ::-1], axis=1)
        out[:, j] = pick
        s[rows, pick] = low
    return out


@contextlib.contextmanager
def _full_f32_matmul():
    """float32 products without TF32 (the JAX package's
    Precision.HIGHEST), restoring the caller's setting after."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _rank_chunk(qc, tc, pool_t, topk):
    """Ranks [C, T] of the target columns `tc` and the top-k hits [C, topk]
    of one query chunk `qc` [C, E] against `pool_t` [E, M] (JAX
    retrieval.py:100-129)."""
    s = qc @ pool_t
    M = s.shape[1]
    cols = torch.arange(M, device=s.device)
    tval = torch.gather(s, 1, tc)[:, :, None]                # [C, T, 1]
    above = (s[:, None, :] > tval).sum(dim=-1)
    tied = ((s[:, None, :] == tval) &
            (cols[None, None, :] > tc[:, :, None])).sum(dim=-1)
    low = torch.finfo(s.dtype).min
    hits = []
    for _ in range(topk):
        mx = s.amax(dim=1, keepdim=True)
        # the largest column attaining the row max
        pick = torch.where(s == mx, cols, -1).amax(dim=1)
        hits.append(pick)
        s = torch.where(cols[None, :] == pick[:, None], low, s)
    return above + tied, torch.stack(hits, dim=1)


def scores_ranks_hits(queries, pool, targets, topk, chunk=512):
    """(scores = queries @ pool.T, the target ranks, the top-k hits) on the
    queries' device, chunked over queries (JAX retrieval.py:133-161).

    queries [Q, E] and pool [M, E] (tensors, or numpy arrays on the CPU),
    targets [Q, T] int.  Returns numpy int64 ranks [Q, T] and hits
    [Q, min(topk, M)], as target_ranks / top_retrieved give on the float32
    score matrix."""
    queries = torch.as_tensor(queries, dtype=torch.float32)
    pool = torch.as_tensor(pool, dtype=torch.float32).to(queries.device)
    targets = torch.as_tensor(np.asarray(targets, np.int64),
                              device=queries.device)
    topk = int(min(topk, pool.shape[0]))
    pool_t = pool.T.contiguous()
    ranks, hits = [], []
    with torch.no_grad(), _full_f32_matmul():
        for lo in range(0, queries.shape[0], chunk):
            r, h = _rank_chunk(queries[lo:lo + chunk],
                               targets[lo:lo + chunk], pool_t, topk)
            ranks.append(r)
            hits.append(h)
    return (torch.cat(ranks).cpu().numpy().astype(np.int64),
            torch.cat(hits).cpu().numpy().astype(np.int64))


def recall_stats(ranks):
    """(R@1, R@5, R@10, median-rank, mean-rank) — ranks are 0-based, the
    reported median/mean are 1-based like the reference's."""
    ranks = np.asarray(ranks)
    r1 = 100.0 * np.mean(ranks < 1)
    r5 = 100.0 * np.mean(ranks < 5)
    r10 = 100.0 * np.mean(ranks < 10)
    medr = np.floor(np.median(ranks)) + 1
    meanr = ranks.mean() + 1
    return r1, r5, r10, medr, meanr


# ---------------------------------------------------------------------------
# protocol entry points (ref eval_utils.py:415-720)
# ---------------------------------------------------------------------------

def i2t(images, captions, npts=None, return_ranks=False, caps_per_image=5):
    """Image -> caption annotation ranking (ref :545-595).

    images [cpi*N, E] (row-replicated per caption), captions [cpi*N, E].
    A query image's rank is the best rank among its cpi GT captions over the
    full caption pool.  The reference hardcodes 5 captions/image;
    caps_per_image generalizes."""
    cpi = caps_per_image
    n_img = npts if npts is not None else images.shape[0] // cpi
    queries = images[::cpi][:n_img]
    own = np.arange(n_img)[:, None] * cpi + np.arange(cpi)[None, :]
    rt, hits = scores_ranks_hits(queries, captions, own, 1)
    ranks = rt.min(axis=1).astype(np.float64)
    top1 = hits[:, 0].astype(np.float64)
    stats = recall_stats(ranks)
    if return_ranks:
        return stats, (ranks, top1)
    return stats


def t2i(images, captions, images_data=None, npts=None, return_ranks=False,
        use_gen_sent=False, caps_per_image=None):
    """Caption -> image search (ref :598-720).

    caps_per_image: 5 for GT ranking, 1 for generated captions.  Alongside the
    rank stats, builds the per-query distractor records (correct image + the
    top-4 retrieved images' metadata) the reference keeps for visualization."""
    cpi = caps_per_image or (1 if use_gen_sent else 5)
    n_img = npts if npts is not None else images.shape[0] // cpi
    gallery = images[::cpi]                             # full image pool
    queries = captions[: cpi * n_img]
    correct = np.repeat(np.arange(n_img), cpi)[:, None]
    rt, hits = scores_ranks_hits(queries, gallery, correct, 4)
    ranks = rt[:, 0]
    top1 = hits[:, 0].astype(np.float64)

    meta = images_data or [{} for _ in range(n_img)]
    images_ranking = {}
    for q in range(queries.shape[0]):
        img_ix = q // cpi
        m = meta[img_ix] if img_ix < len(meta) else {}
        rec = {"image_id": m.get("id"),
               "rank_correct_im": int(ranks[q]),
               "file_path": m.get("file_path", "")}
        for j in range(hits.shape[1]):
            dm = meta[int(hits[q, j])] if int(hits[q, j]) < len(meta) else {}
            rec[f"im_id_rank_{j}"] = dm.get("id")
            rec[f"im_url_rank_{j}"] = dm.get("file_path", "")
        if use_gen_sent:
            images_ranking[img_ix] = rec
        else:
            images_ranking.setdefault(img_ix, {})[f"caption{q % cpi}"] = rec

    stats = recall_stats(ranks.astype(np.float64))
    if return_ranks:
        return stats, (ranks.astype(np.float64), top1), images_ranking
    return stats


def rank_metrics(img_embs, cap_embs, images_data=None, use_gen_sent=False,
                 fold5=False, caps_per_image=None):
    """evalrank metric dict (ref :415-542)."""
    cpi = caps_per_image or (1 if use_gen_sent else 5)
    if not use_gen_sent:
        if not fold5:
            r, _ = i2t(img_embs, cap_embs, return_ranks=True,
                       caps_per_image=cpi)
            ri, _, images_ranking = t2i(img_embs, cap_embs, images_data,
                                        return_ranks=True,
                                        caps_per_image=cpi)
            ar = (r[0] + r[1] + r[2]) / 3
            ari = (ri[0] + ri[1] + ri[2]) / 3
            rsum = sum(r[:3]) + sum(ri[:3])
        else:
            results = []
            # 5 folds of 1000 images = 1000*cpi caption rows each (the
            # reference's hardcoded 5000 assumes cpi=5, eval_utils.py:437)
            fold_rows = 1000 * cpi
            for i in range(5):
                sl = slice(i * fold_rows, (i + 1) * fold_rows)
                r = i2t(img_embs[sl], cap_embs[sl], caps_per_image=cpi)
                ri = t2i(img_embs[sl], cap_embs[sl], caps_per_image=cpi)
                ar = (r[0] + r[1] + r[2]) / 3
                ari = (ri[0] + ri[1] + ri[2]) / 3
                rsum = sum(r[:3]) + sum(ri[:3])
                results += [list(r) + list(ri) + [ar, ari, rsum]]
            mean = np.array(results).mean(axis=0)
            r, ri = tuple(mean[:5]), tuple(mean[5:10])
            ar, ari, rsum = mean[10], mean[11], mean[12]
            images_ranking = {}
        return {"rsum": rsum, "i2t_ar": ar, "t2i_ar": ari,
                "i2t_r1": r[0], "i2t_r5": r[1], "i2t_r10": r[2],
                "i2t_medr": r[3], "i2t_meanr": r[4],
                "t2i_r1": ri[0], "t2i_r5": ri[1], "t2i_r10": ri[2],
                "t2i_medr": ri[3], "t2i_meanr": ri[4],
                "gt_images_ranking": images_ranking}
    # generated captions: t2i only (ref :494-540)
    ri, _, images_ranking = t2i(img_embs, cap_embs, images_data,
                                return_ranks=True, use_gen_sent=True)
    ari = (ri[0] + ri[1] + ri[2]) / 3
    rsum = sum(ri[:3])
    return {"rsum": rsum, "t2i_ar": ari,
            "t2i_r1": ri[0], "t2i_r5": ri[1], "t2i_r10": ri[2],
            "t2i_medr": ri[3], "t2i_meanr": ri[4],
            "images_ranking": images_ranking}
