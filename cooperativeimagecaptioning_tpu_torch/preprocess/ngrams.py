"""n-gram document-frequency preprocessing for cached-df CIDEr-D
(the port's copy of the JAX package's preprocess/ngrams.py; ref
preprocess/prepro_ngrams.py).

Builds `<out>-words.p` and `<out>-idxs.p` pickles with
{'document_frequency': {ngram tuple: df}, 'ref_len': #images} over the chosen
split, appending '<eos>' (id 0) to every caption like the reference (:86-90)."""

from __future__ import annotations

import json
import pickle
from collections import defaultdict


def _precook(s: str, n: int = 4):
    words = s.split()
    counts = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i:i + k])] += 1
    return counts


def compute_doc_freq(crefs):
    """ref: prepro_ngrams.py:67-79."""
    df = defaultdict(float)
    for refs in crefs:
        for ngram in set(ng for ref in refs for ng in ref):
            df[ngram] += 1
    return df


def build_dict(imgs, wtoi, split: str = "train"):
    """ref: prepro_ngrams.py:81-107."""
    wtoi = dict(wtoi)
    wtoi["<eos>"] = 0
    refs_words, refs_idxs = [], []
    count_imgs = 0
    for img in imgs:
        if (split == img["split"]) or \
                (split == "train" and img["split"] == "restval") or \
                (split == "all"):
            ref_words, ref_idxs = [], []
            for sent in img["sentences"]:
                toks = [t if t in wtoi else "UNK"
                        for t in sent["tokens"] + ["<eos>"]]
                ref_words.append(" ".join(toks))
                ref_idxs.append(" ".join(str(wtoi[t]) for t in toks))
            refs_words.append(ref_words)
            refs_idxs.append(ref_idxs)
            count_imgs += 1
    ngram_words = compute_doc_freq([[_precook(r) for r in refs]
                                    for refs in refs_words])
    ngram_idxs = compute_doc_freq([[_precook(r) for r in refs]
                                   for refs in refs_idxs])
    return ngram_words, ngram_idxs, count_imgs


def prepro_ngrams(input_json, dict_json, output_pkl, split: str = "train"):
    """ref: prepro_ngrams.py:109-122."""
    with open(input_json) as f:
        imgs = json.load(f)["images"]
    with open(dict_json) as f:
        itow = json.load(f)["ix_to_word"]
    wtoi = {w: i for i, w in itow.items()}
    ngram_words, ngram_idxs, ref_len = build_dict(imgs, wtoi, split)
    with open(output_pkl + "-words.p", "wb") as f:
        pickle.dump({"document_frequency": ngram_words, "ref_len": ref_len}, f,
                    protocol=pickle.HIGHEST_PROTOCOL)
    with open(output_pkl + "-idxs.p", "wb") as f:
        pickle.dump({"document_frequency": ngram_idxs, "ref_len": ref_len}, f,
                    protocol=pickle.HIGHEST_PROTOCOL)
    return ref_len


def main(argv=None):
    """Standalone CLI (ref: prepro_ngrams.py:126-142)."""
    import argparse
    import json as _json
    ap = argparse.ArgumentParser()
    ap.add_argument("--input_json", required=True,
                    help="dataset json (Karpathy split format)")
    ap.add_argument("--dict_json", default="data/cocotalk.json",
                    help="output of prepro_labels (ix_to_word)")
    ap.add_argument("--output_pkl", default="data/coco-all",
                    help="stem; writes <stem>-words.p and <stem>-idxs.p")
    ap.add_argument("--split", default="train", help="test, val, train, all")
    args = ap.parse_args(argv)
    print("parsed input parameters:")
    print(_json.dumps(vars(args), indent=2))
    return prepro_ngrams(args.input_json, args.dict_json, args.output_pkl,
                         args.split)


if __name__ == "__main__":
    main()
