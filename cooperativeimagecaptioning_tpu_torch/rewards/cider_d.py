"""CIDEr-D scorer (ref: cider/pyciderevalcap/ciderD/{ciderD,ciderD_scorer}.py).

n-gram (1..4) tf-idf cosine similarity with term clipping and a Gaussian length
penalty (sigma = 6).  This is the *training reward* scorer for self-critical
REINFORCE (ref: misc/rewards.py:17) and must reproduce the reference math
exactly — including its quirks:

  * "length" is the count of *bigrams* (ciderD_scorer.py:143-145: `if n == 1`),
    i.e. word-length minus one;
  * clipped similarity term is min(hyp, ref) * ref (ciderD_scorer.py:168);
  * df is floored at 1 inside the log (ciderD_scorer.py:136);
  * df modes: "corpus" computes document frequency from the current refs with
    ref_len = log(#images); anything else loads a cached table with its own
    ref_len (ciderD_scorer.py:62-75).

Unlike the reference's dict-of-tuples accumulation, this implementation is
id-based and vectorized: tokens are interned to integer ids, n-gram ids are
built hierarchically ((n-1)-gram id, token id) -> compact id via np.unique
(which also bounds the pairing products, so no hashing and no collisions),
term frequencies and document frequencies are bincounts over id arrays, and
the clipped cosine is an intersect1d over each (hyp, ref) pair's sorted gram
ids.  float64 throughout — parity with the reference scorer holds to ~1e-12.

The port's own copy of the JAX package's rewards/cider_d.py: host code on
numpy, no torch.
"""

from __future__ import annotations

import pickle

import numpy as np

SIGMA = 6.0


def precook(s: str, n: int = 4):
    """Count n-grams 1..n of a whitespace-tokenized sentence
    (ref: ciderD_scorer.py:13-30).  Kept for API compatibility."""
    words = s.split()
    counts = {}
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            g = tuple(words[i:i + k])
            counts[g] = counts.get(g, 0) + 1
    return counts


class _GramIndex:
    """Interned n-gram ids for a batch of sentences.

    For each level n in 1..n_max, every sentence gets an array of compact
    gram ids (one per starting position); `rep[n]` maps a compact id back to
    a representative (sentence, position) so cached-df dict lookups can
    reconstruct the token tuple.
    """

    def __init__(self, sentences, n_max):
        self.sentences = sentences
        self.n_max = n_max
        vocab = {}
        tok = []
        for s in sentences:
            ids = np.empty(len(s), np.int64)
            for i, w in enumerate(s):
                ids[i] = vocab.setdefault(w, len(vocab))
            tok.append(ids)
        n_tokens = max(1, len(vocab))

        self.grams = []     # [n-1][sent] -> int64 array of compact gram ids
        self.n_unique = []  # [n-1] -> number of distinct grams at level n
        self.rep = []       # [n-1] -> (sent_idx, pos) arrays per compact id
        prev = None
        for n in range(1, n_max + 1):
            if n == 1:
                raw = tok
            else:
                raw = []
                for p, t in zip(prev, tok):
                    m = len(t) - n + 1
                    if m <= 0:
                        raw.append(np.empty(0, np.int64))
                    else:
                        # ((n-1)-gram id at pos) paired with token at pos+n-1;
                        # prev ids are compact (< n_unique[-1] <= total
                        # positions) so the product cannot overflow int64
                        raw.append(p[:m] * n_tokens + t[n - 1:])
            flat = np.concatenate(raw) if raw else np.empty(0, np.int64)
            uniq, first_idx, inv = np.unique(flat, return_index=True,
                                             return_inverse=True)
            offs = np.cumsum([0] + [len(a) for a in raw])
            compact = [inv[offs[i]:offs[i + 1]] for i in range(len(raw))]
            sent_of = np.searchsorted(offs, first_idx, side="right") - 1
            pos_of = first_idx - offs[sent_of] if len(first_idx) else first_idx
            self.grams.append(compact)
            self.n_unique.append(len(uniq))
            self.rep.append((sent_of, pos_of))
            prev = compact

    def tuple_of(self, n, gram_id):
        """Token tuple of compact gram id (for cached-df dict lookups)."""
        s, p = self.rep[n - 1]
        si, pi = int(s[gram_id]), int(p[gram_id])
        return tuple(self.sentences[si][pi:pi + n])

    def sentence_counts(self, n, sent_idx):
        """(sorted unique gram ids, tf) for one sentence at level n."""
        return np.unique(self.grams[n - 1][sent_idx], return_counts=True)


class CiderD:
    """Corpus-level CIDEr-D (ref: ciderD.py:17-55 + ciderD_scorer.py:51-220),
    vectorized over interned n-gram ids."""

    def __init__(self, n: int = 4, sigma: float = 6.0, df: str = "corpus",
                 df_path: str | None = None):
        self.n = n
        self.sigma = sigma
        self.df_mode = df
        self.ref_len = None
        self.document_frequency = None
        if df != "corpus":
            path = df_path or f"data/{df}.p"
            with open(path, "rb") as f:
                pkl = pickle.load(f)
            self.ref_len = float(np.log(float(pkl["ref_len"])))
            self.document_frequency = pkl["document_frequency"]

    # -- similarity kernel ----------------------------------------------------
    def _pair_val(self, wh, wr, hi, ri):
        """Clipped term sum over common grams (ciderD_scorer.py:166-168)."""
        _, ih, ir = np.intersect1d(hi, ri, assume_unique=True,
                                   return_indices=True)
        return float(np.sum(np.minimum(wh[ih], wr[ir]) * wr[ir]))

    def _apply_penalty(self, val, len_h, len_r):
        delta = float(len_h - len_r)
        return val * np.e ** (-(delta ** 2) / (2 * self.sigma ** 2))

    # vectorized hooks (the Cider subclass overrides both): same fp ops in
    # the same per-pair order as the scalar _pair_val/_apply_penalty spec
    def _terms_vec(self, wh, wr):
        return np.minimum(wh, wr) * wr

    def _penalty_vec(self, vals, delta):
        return vals * np.e ** (-(delta ** 2) / (2 * self.sigma ** 2))

    # -- public -------------------------------------------------------------
    def compute_score(self, gts: dict, res: list):
        """gts: {image_id: [ref strings]}; res: [{'image_id', 'caption': [hyp]}].

        Returns (mean_score, per-item scores ndarray) like ciderD.py:31-55.

        Fully vectorized per level (one np.unique over the flat
        (sentence, gram) keys, bincount tf/df/norms, searchsorted hyp-gram
        membership for every (hyp, ref) pair at once): the per-sentence /
        per-pair numpy loops of the earlier tier were ~7.5M tiny calls at the
        5000-image protocol (~6 s/eval; this path is ~0.4 s).  The per-pair
        fp accumulation order matches the scalar spec exactly (sorted common
        gram ids, refs in slice order), so reference parity is unchanged."""
        tests, ref_slices, all_sents = [], [], []
        for item in res:
            hyp = item["caption"]
            refs = gts[item["image_id"]]
            assert isinstance(hyp, list) and len(hyp) == 1
            assert isinstance(refs, list) and len(refs) > 0
            tests.append(len(all_sents))
            all_sents.append(hyp[0].split())
            start = len(all_sents)
            for r in refs:
                all_sents.append(r.split())
            ref_slices.append(range(start, len(all_sents)))

        idx = _GramIndex(all_sents, self.n)
        n_items = len(res)
        S = len(all_sents)
        tests_arr = np.asarray(tests, np.int64)

        # pair structure: one row per (item, ref) in the spec's loop order
        pair_item = np.concatenate(
            [np.full(len(sl), i, np.int64)
             for i, sl in enumerate(ref_slices)])
        pair_ref = np.concatenate(
            [np.asarray(list(sl), np.int64) for sl in ref_slices])
        n_pairs = len(pair_item)
        n_refs = np.asarray([len(sl) for sl in ref_slices], np.float64)
        # sentence roles: item of each hyp sentence / pair of each ref
        item_of_sent = np.full(S, -1, np.int64)
        item_of_sent[tests_arr] = np.arange(n_items)
        pair_of_sent = np.full(S, -1, np.int64)
        pair_of_sent[pair_ref] = np.arange(n_pairs)

        if self.df_mode == "corpus":
            ref_len = float(np.log(float(n_items)))
        else:
            ref_len = self.ref_len

        # "length" = bigram count (ciderD_scorer.py:143-145) — the number of
        # level-2 gram positions per sentence
        length = (np.fromiter((len(g) for g in idx.grams[1]), np.int64, S)
                  if self.n >= 2 else np.zeros(S, np.int64))
        level_scores = np.zeros((n_items, self.n))
        for n0 in range(self.n):
            grams = idx.grams[n0]
            G = max(1, idx.n_unique[n0])
            lens = np.fromiter((len(g) for g in grams), np.int64, S)
            flat = np.concatenate(grams) if len(grams) else \
                np.empty(0, np.int64)
            sent_of = np.repeat(np.arange(S), lens)
            # per-sentence unique grams + tf in ONE pass: keys sort by
            # (sentence, gram id) so each sentence's rows come out in the
            # same sorted-gram order as a per-sentence np.unique
            ukey, tf = np.unique(sent_of * G + flat, return_counts=True)
            u_sent = ukey // G
            u_gid = ukey % G

            # document frequency over compact gram ids
            if self.df_mode == "corpus":
                # distinct (image, gram) pairs over REF sentences
                rmask = pair_of_sent[u_sent] >= 0
                dkey = np.unique(
                    pair_item[pair_of_sent[u_sent[rmask]]] * G
                    + u_gid[rmask])
                df = np.bincount(dkey % G, minlength=G).astype(np.float64)
            else:
                table = self.document_frequency
                df = np.zeros(G)
                for g in range(idx.n_unique[n0]):
                    df[g] = table.get(idx.tuple_of(n0 + 1, g), 0.0)

            idf = ref_len - np.log(np.maximum(1.0, df))
            w = tf.astype(np.float64) * idf[u_gid]
            norm = np.sqrt(np.bincount(u_sent, weights=w * w, minlength=S))

            # hyp-side lookup: sorted (item, gram) keys (u is sorted by
            # (sent, gram) and hyp items are increasing in sentence order)
            hmask = item_of_sent[u_sent] >= 0
            hkey = item_of_sent[u_sent[hmask]] * G + u_gid[hmask]
            hvals = w[hmask]
            # ref side: every gram of every ref row, in sorted-gram order
            rmask = pair_of_sent[u_sent] >= 0
            rpair = pair_of_sent[u_sent[rmask]]
            rkey = pair_item[rpair] * G + u_gid[rmask]
            rw = w[rmask]
            if len(hkey):
                pos = np.searchsorted(hkey, rkey)
                pos_c = np.minimum(pos, len(hkey) - 1)
                found = hkey[pos_c] == rkey
                wh = hvals[pos_c]
                terms = np.where(found, self._terms_vec(wh, rw), 0.0)
            else:
                terms = np.zeros(len(rw))
            # per-pair clipped-cosine numerator: bincount accumulates in
            # element order = sorted common gram ids (= intersect1d order)
            vals = np.bincount(rpair, weights=terms, minlength=n_pairs)
            nt = norm[tests_arr[pair_item]]
            nr = norm[pair_ref]
            nz = (nt != 0) & (nr != 0)
            vals = np.where(nz, vals / np.where(nz, nt * nr, 1.0), vals)
            delta = (length[tests_arr[pair_item]]
                     - length[pair_ref]).astype(np.float64)
            vals = self._penalty_vec(vals, delta)
            # sum over an item's refs in pair (slice) order
            level_scores[:, n0] = np.bincount(pair_item, weights=vals,
                                              minlength=n_items)
        scores = np.mean(level_scores, axis=1) / n_refs * 10.0
        return float(np.mean(scores)), scores


class Cider(CiderD):
    """Plain CIDEr (no clipping; ref: cider/pyciderevalcap/cider/cider_scorer.py).

    Differs from CIDEr-D only in the similarity term (hyp * ref) and the
    absence of the Gaussian length penalty — the vendored `cider` package's
    sim applies neither."""

    def _pair_val(self, wh, wr, hi, ri):
        _, ih, ir = np.intersect1d(hi, ri, assume_unique=True,
                                   return_indices=True)
        return float(np.sum(wh[ih] * wr[ir]))

    def _apply_penalty(self, val, len_h, len_r):
        return val

    def _terms_vec(self, wh, wr):
        return wh * wr

    def _penalty_vec(self, vals, delta):
        return vals
