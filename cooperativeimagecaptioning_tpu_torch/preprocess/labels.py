"""Vocab + label preprocessing (the port's copy of the JAX package's
preprocess/labels.py; ref: preprocess/prepro_labels.py).

dataset json (karpathy format: images[].sentences[].tokens) ->
  cocotalk.json  : {'ix_to_word': 1-indexed vocab, 'images': [{split, id, ...}]}
  cocotalk_label.h5 : labels [M, max_length] uint32, label_start_ix/end_ix
                      (1-indexed inclusive), label_length

Semantics preserved exactly: words with count > threshold (default 5) enter the
vocab, everything else maps to 'UNK' (inserted only when needed); captions clip
at max_length 16; pointers are Lua-style 1-indexed.
"""

from __future__ import annotations

import json

import numpy as np


def build_vocab(imgs, count_thr: int = 5, verbose: bool = False):
    """ref: prepro_labels.py:43-93."""
    counts = {}
    for img in imgs:
        for sent in img["sentences"]:
            for w in sent["tokens"]:
                counts[w] = counts.get(w, 0) + 1
    vocab = [w for w, n in counts.items() if n > count_thr]
    bad_count = sum(n for w, n in counts.items() if n <= count_thr)
    if verbose:
        total = sum(counts.values())
        print(f"vocab {len(vocab)} words; UNK tokens "
              f"{bad_count}/{total}")
    if bad_count > 0:
        vocab.append("UNK")
    for img in imgs:
        img["final_captions"] = [
            [w if counts.get(w, 0) > count_thr else "UNK" for w in s["tokens"]]
            for s in img["sentences"]]
    return vocab


def encode_captions(imgs, wtoi, max_length: int = 16):
    """ref: prepro_labels.py:95-137."""
    N = len(imgs)
    M = sum(len(img["final_captions"]) for img in imgs)
    label_arrays = []
    label_start_ix = np.zeros(N, dtype="uint32")
    label_end_ix = np.zeros(N, dtype="uint32")
    label_length = np.zeros(M, dtype="uint32")
    caption_counter = 0
    counter = 1
    for i, img in enumerate(imgs):
        n = len(img["final_captions"])
        assert n > 0, "error: some image has no captions"
        Li = np.zeros((n, max_length), dtype="uint32")
        for j, s in enumerate(img["final_captions"]):
            label_length[caption_counter] = min(max_length, len(s))
            caption_counter += 1
            for k, w in enumerate(s):
                if k < max_length:
                    Li[j, k] = wtoi[w]
        label_arrays.append(Li)
        label_start_ix[i] = counter
        label_end_ix[i] = counter + n - 1
        counter += n
    L = np.concatenate(label_arrays, axis=0)
    assert L.shape[0] == M
    assert np.all(label_length > 0), "error: some caption had no words?"
    return L, label_start_ix, label_end_ix, label_length


def prepro_labels(input_json, output_json, output_h5, max_length: int = 16,
                  word_count_threshold: int = 5, seed: int = 123,
                  dataset: str = "coco"):
    """Full pipeline (ref: prepro_labels.py:140-185)."""
    import h5py
    with open(input_json) as f:
        data = json.load(f)
    imgs = data["images"]
    np.random.seed(seed)  # determinism pin (ref :144)
    vocab = build_vocab(imgs, word_count_threshold, verbose=True)
    itow = {i + 1: w for i, w in enumerate(vocab)}  # 1-indexed
    wtoi = {w: i + 1 for i, w in enumerate(vocab)}
    L, start_ix, end_ix, lengths = encode_captions(imgs, wtoi, max_length)

    with h5py.File(output_h5, "w") as f:
        f.create_dataset("labels", dtype="uint32", data=L)
        f.create_dataset("label_start_ix", dtype="uint32", data=start_ix)
        f.create_dataset("label_end_ix", dtype="uint32", data=end_ix)
        f.create_dataset("label_length", dtype="uint32", data=lengths)

    out = {"ix_to_word": {str(k): v for k, v in itow.items()}, "images": []}
    for img in imgs:
        jimg = {"split": img.get("split", "train")}
        if dataset in ("flickr8k", "flickr30k"):
            # ref prepro_labels.py:171-175: flickr path = split/filename
            jimg["id"] = img.get("imgid")
            jimg["file_path"] = "/".join(
                [img.get("split", ""), img["filename"]]).lstrip("/")
        else:
            jimg["id"] = img.get("cocoid", img.get("imgid"))
            if "filename" in img:
                jimg["file_path"] = "/".join(
                    [img.get("filepath", ""), img["filename"]]).lstrip("/")
        out["images"].append(jimg)
    with open(output_json, "w") as f:
        json.dump(out, f)
    return out


def main(argv=None):
    """Standalone CLI (ref: prepro_labels.py:190-215); --output_h5 is the
    stem, '_label.h5' is appended like the reference."""
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--input_json", required=True,
                    help="input json file to process into hdf5")
    ap.add_argument("--output_json", default="data.json")
    ap.add_argument("--output_h5", default="data",
                    help="output h5 stem ('_label.h5' appended)")
    ap.add_argument("--max_length", default=16, type=int)
    ap.add_argument("--word_count_threshold", default=5, type=int)
    ap.add_argument("--dataset", default="coco", type=str)
    args = ap.parse_args(argv)
    print("parsed input parameters:")
    print(json.dumps(vars(args), indent=2))
    return prepro_labels(args.input_json, args.output_json,
                         args.output_h5 + "_label.h5", args.max_length,
                         args.word_count_threshold, dataset=args.dataset)


if __name__ == "__main__":
    main()
