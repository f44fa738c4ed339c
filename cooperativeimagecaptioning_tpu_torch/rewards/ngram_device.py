"""CIDEr-D self-critical rewards on the device through hashed n-grams
(counterpart of the JAX package's rewards/ngram_device.py).

The device tier of the reward: the host tier (self_critical.py) turns ids
into strings and scores them with the dict-based scorer; this tier does the
same arithmetic with tensor ops on the batch's device, so a training step
never waits on the host for its reward:

  * token sequences follow array_to_str: tokens up to and INCLUDING the
    first 0 (misc/rewards.py:26-32);
  * n-grams (n = 1..4) are polynomial rolling hashes mod 2^32, held in
    int64 and masked to 32 bits after every multiply-add, so that they
    equal the JAX package's uint32 hashes bit for bit (collisions ~1e-5 a
    batch at COCO scale: the host tier stays the correctness oracle);
  * 'corpus' document frequency counts the 2B-times-expanded ref list
    (each image's refs appear 2*seq_per_img times, ref_len = log(2B);
    misc/rewards.py:53-55, ciderD_scorer.py:204-216); a `DfTable` (the
    cached df of a pickle) replaces it with sorted-table lookups;
  * "length" is the BIGRAM count (eff_len - 1), as ciderD_scorer.py:143-145;
  * clipped similarity min(h, r) * r per distinct gram, Gaussian length
    penalty sigma = 6, mean over n, / n_refs, x 10.

Shapes: gen / greedy [B, L]; refs [n_img, R, L] padded with ref_mask
[n_img, R].  Padded refs (mask 0) add nothing to the similarity sum, to
n_refs or to the df, so refs may be padded to the dataset's largest ref
count and every batch has one shape.  Plain PyTorch ops, as the JAX tier
is plain jnp; nothing here leaves the device, so a CUDA graph captures it.
"""

from __future__ import annotations

import pickle
from typing import NamedTuple

import numpy as np
import torch

HASH_P = 1_000_003
MASK32 = 0xFFFFFFFF
NS = (1, 2, 3, 4)
SIGMA = 6.0


class DfTable(NamedTuple):
    """Document frequency as per-n sorted hash tables (the reference's
    cached-df mode, ciderD_scorer.py:62-75): df lookups are binary
    searches over sorted keys on the device, so the reward is linear in
    the batch size instead of corpus mode's dense containment."""
    keys: tuple          # per n in NS: [T_n] int64 sorted 32-bit hashes
    dfs: tuple           # per n in NS: [T_n] float32 document frequencies
    ref_len_log: torch.Tensor  # 0-d float32 log(ref_len)

    def to(self, device):
        return DfTable(tuple(k.to(device) for k in self.keys),
                       tuple(d.to(device) for d in self.dfs),
                       self.ref_len_log.to(device))


def hash_ngram(tokens) -> int:
    """Host mirror of _gram_hashes' rolling hash."""
    h = 0
    for t in tokens:
        h = (h * HASH_P + int(t) + 1) % (2 ** 32)
    return h


def build_df_table(document_frequency, ref_len, device="cpu") -> DfTable:
    """{ngram tuple: df} and the ref_len count -> a DfTable on `device`.

    Takes reference-style pickles whose tokens are decimal strings
    (array_to_str) or int tuples.  Colliding grams merge to the larger df
    (overestimating a df only shrinks that gram's idf weight)."""
    per_n = {n: {} for n in NS}
    for ngram, df in document_frequency.items():
        n = len(ngram)
        if n not in per_n or df <= 0:
            continue
        h = hash_ngram(ngram)
        d = per_n[n]
        d[h] = max(d.get(h, 0.0), float(df))
    keys, dfs = [], []
    for n in NS:
        items = sorted(per_n[n].items()) or [(0, 0.0)]  # sentinel (df 0)
        keys.append(torch.from_numpy(np.fromiter(
            (k for k, _ in items), np.int64, len(items))).to(device))
        dfs.append(torch.from_numpy(np.fromiter(
            (v for _, v in items), np.float32, len(items))).to(device))
    ref_len_log = torch.from_numpy(
        np.asarray(np.log(float(ref_len)), np.float32)).to(device)
    return DfTable(tuple(keys), tuple(dfs), ref_len_log)


def load_df_table(path: str, device="cpu") -> DfTable:
    """A reference-format df pickle ({'ref_len', 'document_frequency'},
    ciderD_scorer.py:70-74) as a DfTable on `device`."""
    with open(path, "rb") as f:
        pkl = pickle.load(f)
    return build_df_table(pkl["document_frequency"], pkl["ref_len"], device)


def _df_lookup(keys, dfs, q):
    """The df of each query hash by binary search; 0 for unseen grams (the
    reference's defaultdict(float))."""
    qf = q.reshape(-1)
    idx = torch.searchsorted(keys, qf).clamp_(0, keys.shape[0] - 1)
    return torch.where(keys[idx] == qf, dfs[idx],
                       torch.zeros_like(dfs[idx])).reshape(q.shape)


def pad_gts_np(gts_list, max_refs=None, seq_length=None):
    """Host helper: a list of [n_i, L_i] ref arrays -> numpy (refs [n_img,
    R, L] int32, ref_mask [n_img, R] float32), R = max_refs or the largest
    n_i; a list longer than R keeps its first R refs."""
    n_img = len(gts_list)
    R = max_refs or max(len(g) for g in gts_list)
    L = seq_length or max(int(np.asarray(g).shape[1]) for g in gts_list)
    refs = np.zeros((n_img, R, L), np.int32)
    mask = np.zeros((n_img, R), np.float32)
    for i, g in enumerate(gts_list):
        g = np.asarray(g)[:R]
        refs[i, :len(g), :g.shape[1]] = g
        mask[i, :len(g)] = 1.0
    return refs, mask


def pad_gts(gts_list, max_refs=None, seq_length=None, device="cpu"):
    """pad_gts_np as tensors on `device` (one copy each)."""
    refs, mask = pad_gts_np(gts_list, max_refs=max_refs,
                            seq_length=seq_length)
    return (torch.from_numpy(refs).to(device),
            torch.from_numpy(mask).to(device))


def containment_df(q_hash, flat_gr, flat_vr, expand=1.0):
    """Dense corpus document frequency: df[q] = expand * the number of
    images whose ref set holds gram q.  flat_gr / flat_vr: each image's
    flattened gram hashes [n_img, M] and their validity.  The compare
    tensor [Q, n_img, M] is held as bools (a quarter of f32's bytes)."""
    n_img, M = flat_gr.shape
    eq = (q_hash.reshape(-1)[:, None, None] == flat_gr[None]) & \
        (flat_vr[None] > 0)
    contains = eq.any(dim=-1).to(torch.float32)          # [Q, n_img]
    return (contains.sum(dim=-1) * expand).reshape(q_hash.shape)


def _eff_len(seq):
    """Length including the terminal 0 (or the full length if none)."""
    L = seq.shape[-1]
    is0 = (seq == 0)
    first_zero = torch.argmax(is0.to(torch.int32), dim=-1)  # first max
    return torch.where(is0.any(dim=-1), first_zero + 1,
                       torch.full_like(first_zero, L))


def _gram_hashes(seq, n):
    """[..., L] tokens -> ([..., L] int64 hashes, [..., L] float32 validity)
    of the n-grams starting at each position."""
    L = seq.shape[-1]
    t = seq.to(torch.int64)
    h = torch.zeros_like(t)
    for k in range(n):
        tk = torch.roll(t, -k, dims=-1) if k else t
        h = (h * HASH_P + tk + 1) & MASK32
    eff = _eff_len(seq)[..., None]
    pos = torch.arange(L, device=seq.device)
    valid = (pos + n) <= eff
    return h, valid.to(torch.float32)


def _over_tf(x, tf):
    """x / tf where tf > 0, else 0: summed over a sequence's positions it
    counts each distinct gram once."""
    return torch.where(tf > 0, x / tf.clamp_min(1e-9), torch.zeros_like(tf))


def ciderd_rewards_device(gen, greedy, refs, ref_mask, seq_per_img=1,
                          sigma=SIGMA, df_table: DfTable | None = None):
    """(scores [B] = cider(gen) - cider(greedy), cider_gen [B], the mean
    cider(greedy) as a 0-d tensor), on the device of `gen`.

    df_table=None (corpus mode) takes the df from the expanded batch refs
    through the dense containment (the reference's corpus mode, O(B^2));
    with a DfTable (its cached-df mode) the df comes from binary searches,
    linear in B."""
    B, L = gen.shape
    n_img, R, Lr = refs.shape
    dev = gen.device
    seqs = torch.cat([gen, greedy], dim=0).to(torch.int64)    # [2B, L]
    B2 = 2 * B
    img_of = (torch.arange(B2, device=dev) % B) // seq_per_img
    ref_mask = ref_mask.to(torch.float32)
    my_rmask = ref_mask[img_of]                               # [2B, R]
    n_refs = ref_mask.sum(dim=1)[img_of]                      # [2B]

    # each image's ref set appears 2B / n_img times in the expanded list
    expand = B2 / n_img
    if df_table is not None:
        ref_len_log = df_table.ref_len_log
    else:
        ref_len_log = torch.full((), float(B2), device=dev).log()

    len_h = (_eff_len(seqs) - 1).clamp_min(0).to(torch.float32)  # bigrams
    len_r = (_eff_len(refs) - 1).clamp_min(0).to(torch.float32)[img_of]
    delta = len_h[:, None] - len_r                            # [2B, R]
    two_var = torch.full((), 2 * sigma ** 2, device=dev)
    len_pen = torch.exp(-(delta ** 2) / two_var) * my_rmask

    sim_sum = torch.zeros((B2, R), device=dev)
    for n in NS:
        gh, vh = _gram_hashes(seqs, n)            # [2B, L]
        gr, vr = _gram_hashes(refs, n)            # [n_img, R, Lr]
        vr = vr * ref_mask[..., None]
        gr_mine = gr[img_of]                      # [2B, R, Lr]
        vr_mine = vr[img_of]

        # hyp term frequency [2B, L]
        tf_h = ((gh[:, :, None] == gh[:, None, :]).to(torch.float32)
                * vh[:, None, :]).sum(dim=-1)
        # count of hyp gram i in ref r [2B, L, R]
        cnt_r = ((gh[:, :, None, None] == gr_mine[:, None, :, :])
                 .to(torch.float32) * vr_mine[:, None, :, :]).sum(dim=-1)
        # ref term frequency within each ref [n_img, R, Lr]
        tf_r = ((gr[..., :, None] == gr[..., None, :]).to(torch.float32)
                * vr[..., None, :]).sum(dim=-1)

        if df_table is not None:
            kn, dn = df_table.keys[n - 1], df_table.dfs[n - 1]
            df_h = _df_lookup(kn, dn, gh)
            df_r = _df_lookup(kn, dn, gr)
        else:
            flat_gr = gr.reshape(n_img, R * Lr)
            flat_vr = vr.reshape(n_img, R * Lr)
            df_h = containment_df(gh, flat_gr, flat_vr, expand)
            df_r = containment_df(gr, flat_gr, flat_vr, expand)

        idf_h = ref_len_log - torch.log(df_h.clamp_min(1.0))
        idf_r = ref_len_log - torch.log(df_r.clamp_min(1.0))
        w_h = tf_h * idf_h                          # [2B, L]
        w_r_pos = tf_r * idf_r                      # [n_img, R, Lr]

        # norms over DISTINCT grams: sum_i valid * w^2 / tf
        norm_h = torch.sqrt((vh * _over_tf(w_h ** 2, tf_h)).sum(dim=1))
        norm_r = torch.sqrt((vr * _over_tf(w_r_pos ** 2, tf_r))
                            .sum(dim=2))[img_of]    # [2B, R]

        # the weight of each hyp gram in each ref: cnt_r * idf(gram)
        w_r_of_h = cnt_r * idf_h[:, :, None]        # [2B, L, R]
        clipped = torch.minimum(w_h[:, :, None], w_r_of_h) * w_r_of_h
        weight = vh * _over_tf(torch.ones_like(tf_h), tf_h)
        val = (clipped * weight[:, :, None]).sum(dim=1)   # [2B, R]
        denom = norm_h[:, None] * norm_r
        val = torch.where(denom > 0, val / denom.clamp_min(1e-20),
                          torch.zeros_like(val))
        sim_sum = sim_sum + val * len_pen

    # mean over n, sum over refs, / n_refs, x 10 (ciderD_scorer.py:186-196)
    per_seq = sim_sum.sum(dim=1) / len(NS) / n_refs.clamp_min(1.0) * 10.0
    cider_gen, cider_greedy = per_seq[:B], per_seq[B:]
    return cider_gen - cider_greedy, cider_gen, cider_greedy.mean()
