"""METEOR scorer (replaces meteor-1.5.jar, ref:
coco-caption/pycocoevalcap/meteor/meteor.py which drives the jar over a stdio
protocol with `-l en -norm`, i.e. the English 'rank'-task tuning).

Implements the METEOR 1.5 scoring model (Denkowski & Lavie 2014):
  * stage-wise word alignment — exact match first, then Porter-stem match —
    resolving ties toward fewer chunks like the jar's beam aligner;
  * content/function word distinction: matched and total words are weighted
    delta for content words and (1-delta) for function words;
        P     = sum_i w_i*(d*m_i(h_c) + (1-d)*m_i(h_f)) / (d*|h_c|+(1-d)*|h_f|)
        R     = likewise over the reference
        Fmean = P*R / (alpha*P + (1-alpha)*R)
        Pen   = gamma * (chunks/m)^beta
        score = (1 - Pen) * Fmean
    with the 1.5 English parameters alpha=.85 beta=.2 gamma=.6 delta=.75 and
    stage weights exact=1.0, stem=0.6;
  * multi-reference: the best-scoring reference's statistics represent the
    segment (jar semantics);
  * the corpus score is the micro-average — the formula applied to SUMMED
    segment statistics — exactly how the jar's final EVAL line aggregates,
    not the mean of sentence scores.

All four METEOR 1.5 stages are implemented: exact (1.0), stem (0.6),
synonym (0.8), paraphrase (0.6).  The synonym and paraphrase stages need
data files the jar shipped — WordNet synsets and paraphrase-en.gz — which
are missing blobs even upstream (.MISSING_LARGE_BLOBS:3-4), so they activate
only when the user provides data via `MeteorResources` (a paraphrase table
in the paraphrase-en.gz line format, synonym groups, and optionally the
jar's resources/function.words file in place of the built-in approximation).
Without resources the scorer runs exact+stem with the approximated
function-word list and its numbers are NOT comparable to jar-computed
literature METEOR (a one-time runtime notice says so,
evaluation/language_eval.py).

The port's own copy of the JAX package's metrics/meteor.py.  The C++
implementation (native/cic_native.cpp) is used once it is built; both tiers
agree bit-for-bit on the shared test corpus, including with resources
(serialized to the native tier via cic_meteor_configure).
"""

from __future__ import annotations

import gzip
import os

import numpy as np

from cooperativeimagecaptioning_tpu_torch.metrics.porter import stem

ALPHA, BETA, GAMMA, DELTA = 0.85, 0.2, 0.6, 0.75
W_EXACT, W_STEM, W_SYN, W_PAR = 1.0, 0.6, 0.8, 0.6
MAX_PHRASE = 6  # longest phrase considered by the paraphrase stage

# Approximation of METEOR's corpus-derived English function.words (words with
# relative frequency > 1e-3): determiners, prepositions, conjunctions,
# pronouns, auxiliaries, and high-frequency adverbs/particles.
FUNCTION_WORDS = frozenset("""
a an the this that these those some any each every no all both either neither
i you he she it we they me him her us them my your his its our their mine
yours hers ours theirs myself yourself himself herself itself ourselves
themselves who whom whose which what
is am are was were be been being do does did done doing have has had having
will would shall should can could may might must ought need dare used
and or but nor so yet for if then than as because while although though
since unless until when where why how whether that
of in on at by with from to into onto upon about above below under over
between among through during before after against across behind beyond
around near off out up down within without along toward towards
not n't never also just only even still too very quite rather there here
's 'd 'll 'm 're 've
. , ; : ! ? ' " ` `` '' -- ( ) [ ]
""".split())


class MeteorResources:
    """Optional METEOR 1.5 data (the jar's resources; missing blobs upstream).

    function_words — iterable of words replacing the built-in approximation
        (the jar's resources/function.words, one word per line).
    synonym_groups — list of word groups (synsets): two words match in the
        synonym stage (weight 0.8) iff they share a group.  The jar used
        WordNet; any synset source can be materialized into groups here.
    paraphrases — list of (src_words, dst_words) tuples; the paraphrase
        stage (weight 0.6) matches an untaken hyp span equal to one side
        against an untaken ref span equal to the other, either direction.
    """

    def __init__(self, function_words=None, synonym_groups=None,
                 paraphrases=None):
        self.function_words = (frozenset(function_words)
                               if function_words else None)
        self.synonym_groups = [frozenset(g) for g in (synonym_groups or [])
                               if len(g) > 1]
        # word -> sorted group ids (sorted for deterministic candidate order)
        self.syn_ids = {}
        for gid, group in enumerate(self.synonym_groups):
            for w in group:
                self.syn_ids.setdefault(w, []).append(gid)
        # phrase tuple -> list of phrase tuples (both directions)
        self.par_map = {}
        for src, dst in (paraphrases or []):
            src, dst = tuple(src), tuple(dst)
            if src and dst and src != dst:
                self.par_map.setdefault(src, []).append(dst)
                self.par_map.setdefault(dst, []).append(src)
        self.max_phrase = min(
            MAX_PHRASE, max((len(k) for k in self.par_map), default=1))

    @classmethod
    def load(cls, function_words_path=None, synonyms_path=None,
             paraphrase_path=None):
        """Build resources from data files.

        function.words: one word per line ('#' comments skipped).
        synonyms: one group per line, whitespace-separated words.
        paraphrase table: the paraphrase-en.gz line convention —
        `phrase ||| paraphrase [||| prob...]` — or two tab-separated
        phrases per line; .gz transparently decompressed.
        """
        fw = syn = par = None
        if function_words_path:
            fw = [w for w in _read_lines(function_words_path)
                  if w and not w.startswith("#")]
        if synonyms_path:
            syn = [line.split() for line in _read_lines(synonyms_path)
                   if len(line.split()) > 1]
        if paraphrase_path:
            par = []
            for line in _read_lines(paraphrase_path):
                if "|||" in line:
                    parts = [p.strip() for p in line.split("|||")]
                else:
                    parts = [p.strip() for p in line.split("\t")]
                if len(parts) >= 2 and parts[0] and parts[1]:
                    par.append((parts[0].split(), parts[1].split()))
        return cls(fw, syn, par)

    def serialize(self) -> str:
        """Wire format for the native tier's cic_meteor_configure:
        FW '\\x03' SYNGROUPS '\\x03' PARAPHRASES; groups/entries separated by
        '\\x01', paraphrase sides by '\\x02'; empty FW keeps the default."""
        fw = " ".join(sorted(self.function_words)) \
            if self.function_words else ""
        syn = "\x01".join(" ".join(sorted(g)) for g in self.synonym_groups)
        par = "\x01".join(
            " ".join(src) + "\x02" + " ".join(d)
            for src, ds in sorted(self.par_map.items()) for d in ds)
        return fw + "\x03" + syn + "\x03" + par


def _read_lines(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt", encoding="utf-8", errors="replace") as f:
        return [line.rstrip("\n") for line in f]


def _align(hyp_words, ref_words, res=None):
    """Greedy stage-wise alignment (exact -> stem -> synonym -> paraphrase,
    the jar's matcher order).  Returns matches [(hi, ri, weight)]; every
    pair is one matched hyp/ref word, so len(matches) is the match count for
    the fragmentation penalty in all stages uniformly."""
    hyp_taken = [False] * len(hyp_words)
    ref_taken = [False] * len(ref_words)
    matches = []

    def run_stage(keys_fn, weight):
        # prefer monotonic pairs (reduces chunks), like the beam aligner's
        # tie-breaking toward contiguity.  keys_fn maps a word to its match
        # keys (one for exact/stem; the word's synset ids for the syn stage).
        ref_keys = {}
        for ri, w in enumerate(ref_words):
            if not ref_taken[ri]:
                for k in keys_fn(w):
                    ref_keys.setdefault(k, []).append(ri)
        last_ri = -1
        for hi, w in enumerate(hyp_words):
            if hyp_taken[hi]:
                continue
            cands = sorted({ri for k in keys_fn(w)
                            for ri in ref_keys.get(k, [])
                            if not ref_taken[ri]})
            if not cands:
                continue
            after = [ri for ri in cands if ri > last_ri]
            ri = after[0] if after else cands[0]
            hyp_taken[hi] = True
            ref_taken[ri] = True
            matches.append((hi, ri, weight))
            last_ri = ri

    run_stage(lambda w: (w,), W_EXACT)
    run_stage(lambda w: (stem(w),), W_STEM)
    if res is not None and res.syn_ids:
        run_stage(lambda w: tuple(res.syn_ids.get(w, ())), W_SYN)
    if res is not None and res.par_map:
        _run_paraphrase_stage(hyp_words, ref_words, hyp_taken, ref_taken,
                              matches, res)
    return matches


def _run_paraphrase_stage(hyp_words, ref_words, hyp_taken, ref_taken,
                          matches, res):
    """Phrase-level matching: scan hyp left-to-right, longest untaken span
    first; a table entry maps it to candidate ref phrases, matched at the
    leftmost fully-untaken ref occurrence (preferring one past the last
    match, like the word stages).  Both spans are consumed; word pairs are
    emitted positionally over the min-length prefix — so an isolated phrase
    match is one contiguous run for the chunk count, and the longer side's
    tail words count only in the denominators (documented approximation of
    the jar's phrase-block alignment)."""
    last_ri = -1

    def span_free(taken, start, n):
        return all(not taken[i] for i in range(start, start + n))

    def find_ref(phrase):
        n = len(phrase)
        hits = [rs for rs in range(len(ref_words) - n + 1)
                if span_free(ref_taken, rs, n)
                and tuple(ref_words[rs:rs + n]) == phrase]
        after = [rs for rs in hits if rs > last_ri]
        return (after or hits or [None])[0]

    hi = 0
    while hi < len(hyp_words):
        if hyp_taken[hi]:
            hi += 1
            continue
        matched = False
        for n in range(min(res.max_phrase, len(hyp_words) - hi), 0, -1):
            if not span_free(hyp_taken, hi, n):
                continue
            src = tuple(hyp_words[hi:hi + n])
            for dst in res.par_map.get(src, ()):
                rs = find_ref(dst)
                if rs is None:
                    continue
                for i in range(n):
                    hyp_taken[hi + i] = True
                for i in range(len(dst)):
                    ref_taken[rs + i] = True
                for i in range(min(n, len(dst))):
                    matches.append((hi + i, rs + i, W_PAR))
                last_ri = rs + len(dst) - 1
                hi += n - 1
                matched = True
                break
            if matched:
                break
        hi += 1


def _count_chunks(matches):
    """Number of maximal runs of contiguous, order-preserving matches."""
    if not matches:
        return 0
    ms = sorted((hi, ri) for hi, ri, _ in matches)
    chunks = 1
    for (h0, r0), (h1, r1) in zip(ms, ms[1:]):
        if not (h1 == h0 + 1 and r1 == r0 + 1):
            chunks += 1
    return chunks


def _score_from_stats(st):
    """METEOR 1.5 formula over a stats vector
    [wp_num, p_den, wr_num, r_den, chunks, matches]."""
    wp_num, p_den, wr_num, r_den, chunks, m = st
    if m <= 0 or p_den <= 0 or r_den <= 0:
        return 0.0
    p = wp_num / p_den
    r = wr_num / r_den
    if p == 0 or r == 0:
        return 0.0
    fmean = p * r / (ALPHA * p + (1 - ALPHA) * r)
    pen = GAMMA * (chunks / m) ** BETA
    return (1 - pen) * fmean


def _content_weight(w, res=None):
    fw = res.function_words if res is not None and res.function_words \
        else FUNCTION_WORDS
    return (1 - DELTA) if w in fw else DELTA


def _pair_stats(hyp_words, ref_words, res=None):
    matches = _align(hyp_words, ref_words, res)
    m = len(matches)
    cw = lambda w: _content_weight(w, res)
    p_den = sum(cw(w) for w in hyp_words)
    r_den = sum(cw(w) for w in ref_words)
    wp_num = sum(wt * cw(hyp_words[hi]) for hi, _, wt in matches)
    wr_num = sum(wt * cw(ref_words[ri]) for _, ri, wt in matches)
    return [wp_num, p_den, wr_num, r_den, float(_count_chunks(matches)),
            float(m)]


def sentence_stats(hyp: str, refs: list, res=None):
    """(score, stats) for the best-scoring reference (jar segment semantics)."""
    hyp_words = hyp.split()
    best_score, best_stats = 0.0, None
    for ref in refs:
        ref_words = ref.split()
        if not hyp_words or not ref_words:
            continue
        st = _pair_stats(hyp_words, ref_words, res)
        sc = _score_from_stats(st)
        if sc >= best_score or best_stats is None:
            best_score, best_stats = sc, st
    if best_stats is None:
        # degenerate segment (empty hypothesis and/or references): zero
        # matches, but the length denominators still count toward the corpus
        # micro-average — the jar's EVAL aggregation includes them too
        cw = lambda w: _content_weight(w, res)
        ref_words = next((r.split() for r in refs if r.split()), [])
        best_stats = [0.0, sum(cw(w) for w in hyp_words), 0.0,
                      sum(cw(w) for w in ref_words), 0.0, 0.0]
    return best_score, best_stats


def sentence_meteor(hyp: str, refs: list, res=None) -> float:
    return sentence_stats(hyp, refs, res)[0]


_default_res = []   # lazily-resolved [MeteorResources | None]
_warned_lite = []


def default_resources():
    """Process-default resources from the CIC_METEOR_DATA directory (set it
    to a dir holding the jar's data files: function.words, synonyms.txt,
    paraphrase-en.gz — any subset; the `--meteor_data_dir` flag exports it).
    None when unset."""
    if not _default_res:
        d = os.environ.get("CIC_METEOR_DATA", "")
        if d and os.path.isdir(d):
            paths = {k: os.path.join(d, n) for k, n in
                     [("function_words_path", "function.words"),
                      ("synonyms_path", "synonyms.txt"),
                      ("paraphrase_path", "paraphrase-en.gz")]}
            paths = {k: p for k, p in paths.items() if os.path.isfile(p)}
            _default_res.append(
                MeteorResources.load(**paths) if paths else None)
        else:
            _default_res.append(None)
    return _default_res[0]


def compute_meteor(gts: dict, res: dict, resources: MeteorResources = None):
    """Returns (corpus_score, per-segment scores).  The corpus score is the
    micro-average over summed stats, matching the jar's final EVAL line.
    `resources` activates the synonym/paraphrase stages and a provided
    function-word list in BOTH tiers (native via cic_meteor_configure)."""
    if resources is None:
        resources = default_resources()
    if not _warned_lite and (
            resources is None or not (resources.syn_ids and
                                      resources.par_map)):
        _warned_lite.append(True)
        print("note: METEOR running without the jar's synonym/paraphrase "
              "data (missing blobs upstream; provide them via "
              "CIC_METEOR_DATA / --meteor_data_dir) — scores are NOT "
              "comparable to jar-computed literature METEOR")
    from cooperativeimagecaptioning_tpu_torch.native import bindings
    if bindings.available():
        return bindings.meteor(gts, res, resources)
    ids = sorted(gts.keys(), key=lambda x: str(x))
    scores, total = [], np.zeros(6)
    for i in ids:
        sc, st = sentence_stats(res[i][0], gts[i], resources)
        scores.append(sc)
        total += np.asarray(st)
    return float(_score_from_stats(total)), np.array(scores)
