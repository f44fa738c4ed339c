"""Feature stores and dataset descriptors (the port's own copy of the JAX
package's data/sources.py: host code on numpy, no torch).

The reference reads per-image features from npy/npz directories or an LMDB
(`HybridLoader`, ref: dataloader.py:18-53) plus a cocotalk info json and a label h5
(ref: dataloader.py:86-113).  `SyntheticDataset` provides the same surface from
deterministic random data for tests and benchmarks.
"""

from __future__ import annotations

import io
import json
import os

import numpy as np


class DirFeatureSource:
    """npy/npz directory feature store (ref: dataloader.py:24-53).

    Reads go through the C++ parser (native/cic_io.cpp) when built — ctypes
    releases the GIL for the whole read+inflate, so the thread prefetcher
    parallelizes — with np.load for anything it can't parse, and while the
    library is not built."""

    def __init__(self, db_path: str, ext: str):
        from cooperativeimagecaptioning_tpu_torch.native import bindings
        self.db_path = db_path
        self.ext = ext
        self._native = bindings if bindings.available() else None

    def get(self, key: str):
        path = os.path.join(self.db_path, key + self.ext)
        if self._native is not None:
            out = (self._native.read_npy(path) if self.ext == ".npy"
                   else self._native.read_npz_feat(path))
            if out is not None:
                return out
        if self.ext == ".npy":
            return np.load(path)
        return np.load(path)["feat"]


class LmdbFeatureSource:
    """LMDB feature store; requires the optional lmdb package."""

    def __init__(self, db_path: str, ext: str):
        import lmdb  # gated: not part of the baked environment
        self.ext = ext
        self.env = lmdb.open(db_path, subdir=os.path.isdir(db_path),
                             readonly=True, lock=False, readahead=False,
                             meminit=False)

    def get(self, key: str):
        with self.env.begin(write=False) as txn:
            byteflow = txn.get(key.encode())
        if byteflow is None:
            raise KeyError(f"feature key {key!r} not found in the LMDB")
        buf = io.BytesIO(byteflow)
        if self.ext == ".npy":
            return np.load(buf)
        return np.load(buf)["feat"]


def open_feature_source(db_path: str, ext: str):
    if db_path.endswith(".lmdb"):
        return LmdbFeatureSource(db_path, ext)
    return DirFeatureSource(db_path, ext)


class FileDataset:
    """cocotalk json + label h5 + feature dirs (the reference's on-disk layout)."""

    def __init__(self, opt):
        with open(opt.input_json) as f:
            self.info = json.load(f)
        self.ix_to_word = self.info.get("ix_to_word", {})
        self.vocab_size = len(self.ix_to_word)
        if opt.input_label_h5 != "none":
            import h5py
            h5 = h5py.File(opt.input_label_h5, "r")
            self.label = h5["labels"][:]
            self.seq_length = self.label.shape[1]
            self.label_start_ix = h5["label_start_ix"][:]
            self.label_end_ix = h5["label_end_ix"][:]
            h5.close()
        else:
            self.label = None
            self.seq_length = 1
        self.fc_source = open_feature_source(opt.input_fc_dir, ".npy")
        self.att_source = open_feature_source(opt.input_att_dir, ".npz")
        self.dataset_name = getattr(opt, "dataset", "coco")
        # GT captions per image used by retrieval ranking (ref eval_utils.py:295)
        self.gt_caps_per_image = 5 if self.dataset_name in (
            "coco", "flickr8k", "flickr30k") else 1

    def num_images(self):
        return len(self.info["images"])

    def image_key(self, ix):
        img = self.info["images"][ix]
        if self.dataset_name in ("flickr8k", "flickr30k"):
            return img["file_path"].split("/")[1].split(".")[0]
        return str(img["id"])

    def get_fc(self, ix):
        return self.fc_source.get(self.image_key(ix))

    def get_att(self, ix):
        att = self.att_source.get(self.image_key(ix))
        return att.reshape(-1, att.shape[-1])

    def get_refs(self, ix):
        """All GT caption rows for image ix (for reward computation)."""
        return self.label[self.label_start_ix[ix] - 1: self.label_end_ix[ix]]


class SyntheticDataset:
    """Deterministic synthetic dataset with the FileDataset surface.

    Used by tests, the benchmark, and the multichip dry run — no disk IO."""

    def __init__(self, num_images=64, vocab_size=50, seq_length=16,
                 fc_feat_size=2048, att_feat_size=2048, max_K=36,
                 caps_per_image=5, splits=(0.6, 0.2, 0.2), seed=0,
                 variable_K=True, derived=False):
        rng = np.random.RandomState(seed)
        self.vocab_size = vocab_size
        self.seq_length = seq_length
        self.ix_to_word = {str(i): f"w{i}" for i in range(1, vocab_size + 1)}
        self.dataset_name = "synthetic"
        self.gt_caps_per_image = caps_per_image
        self._fc = rng.randn(num_images, fc_feat_size).astype(np.float32)
        self._K = (rng.randint(max(2, max_K // 2), max_K + 1, num_images)
                   if variable_K else np.full(num_images, max_K))
        self._att = [rng.randn(k, att_feat_size).astype(np.float32)
                     for k in self._K]
        # labels: caps_per_image rows per image, contiguous, 1-indexed pointers
        n_caps = num_images * caps_per_image
        self.label = np.zeros((n_caps, seq_length), np.int64)
        if derived:
            self._derive_labels(rng, caps_per_image)
        else:
            for i in range(n_caps):
                n = rng.randint(3, seq_length + 1)
                self.label[i, :n] = rng.randint(1, vocab_size + 1, n)
        self.label_start_ix = np.arange(num_images) * caps_per_image + 1
        self.label_end_ix = self.label_start_ix + caps_per_image - 1
        n_train = int(num_images * splits[0])
        n_val = int(num_images * splits[1])
        self.info = {"images": []}
        for ix in range(num_images):
            split = ("train" if ix < n_train else
                     "val" if ix < n_train + n_val else "test")
            self.info["images"].append(
                {"id": ix, "split": split, "file_path": f"synthetic/{ix}.jpg"})

    def _derive_labels(self, rng, caps_per_image):
        """Feature-conditioned captions: a fixed random teacher maps each
        image's mean attention feature (what the attention models can see)
        through a tanh bottleneck to per-position vocab logits; the image's
        caption variants sample from the teacher's per-position top-3.

        Gives the full-scale convergence showcase a LEARNABLE mapping (unlike
        uniform random captions, which only admit memorization) plus
        intra-image n-gram overlap so CIDEr rewards are meaningful at large
        vocab sizes."""
        hid, L, V = 32, self.seq_length, self.vocab_size
        if self._fc.shape[1] == self._att[0].shape[1]:
            # fc = mean-pooled att (what cocotalk_fc is in the real prepro) so
            # BOTH feature views carry the caption signal — the fc-based
            # listener would otherwise face unlearnable retrieval
            self._fc = np.stack([a.mean(0) for a in self._att])
        # scale: mean-pooling divides feature variance by K, so the teacher
        # bottleneck re-standardizes (x sqrt(K̄)) — otherwise the positional
        # term drowns the image signal, captions barely differ across images,
        # and retrieval/CIDEr on the derived data are unlearnable (measured:
        # chance-level rsum at full scale)
        k_mean = float(np.mean([a.shape[0] for a in self._att]))
        w1 = (rng.randn(self._att[0].shape[1], hid) *
              np.sqrt(k_mean / self._att[0].shape[1])).astype(np.float32)
        pos = (0.25 * rng.randn(L, hid)).astype(np.float32)
        w2 = (rng.randn(hid, V) / np.sqrt(hid)).astype(np.float32)
        top_p = np.array([0.7, 0.2, 0.1])
        for ix in range(len(self._att)):
            z = np.tanh(self._att[ix].mean(0) @ w1)          # [hid]
            logits = np.tanh(z[None, :] + pos) @ w2          # [L, V]
            top3 = np.argsort(logits, axis=1)[:, -3:][:, ::-1]  # [L, 3]
            for j in range(caps_per_image):
                n = rng.randint(max(3, L - 4), L + 1)
                picks = top3[np.arange(n),
                             rng.choice(3, size=n, p=top_p)]
                self.label[ix * caps_per_image + j, :n] = picks + 1

    def num_images(self):
        return len(self.info["images"])

    def get_fc(self, ix):
        return self._fc[ix]

    def get_att(self, ix):
        return self._att[ix]

    def get_refs(self, ix):
        return self.label[self.label_start_ix[ix] - 1: self.label_end_ix[ix]]
