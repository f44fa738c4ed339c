"""The benchmark's inputs, made from the seed: image features drawn on the
card in chunks of rows (each chunk from its own generator, so any row can
be drawn again by itself for the reference), and a captioning dataset with
the program's dataset surface whose features never exist on the host."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import common

CHUNK_ROWS = 4096  # images a generator call fills


def _fill(buf, seed, tag, chunk, share=0.0):
    """Rows of one chunk: ReLU of a standard normal (post-ReLU features).
    With `share` > 0, that part of the normal's variance is a vector each
    row [K, F] shares across its K regions, as an image's regions
    correlate."""
    g = common.generator(seed, f"{tag}:{chunk}", buf.device)
    buf.normal_(generator=g)
    if share > 0.0:
        base = torch.empty((buf.shape[0], 1) + tuple(buf.shape[2:]),
                           dtype=buf.dtype, device=buf.device)
        base.normal_(generator=g)
        buf.mul_((1.0 - share) ** 0.5).add_(base, alpha=share ** 0.5)
    buf.relu_()


def draw(shape, seed, tag, device, dtype=torch.float32, share=0.0):
    """A [N, ...] feature tensor on `device`, drawn chunk by chunk."""
    buf = torch.empty(shape, dtype=dtype, device=device)
    for c, i in enumerate(range(0, shape[0], CHUNK_ROWS)):
        _fill(buf[i:i + CHUNK_ROWS], seed, tag, c, share)
    return buf


def rows(idx, shape, seed, tag, device, dtype=torch.float32, share=0.0):
    """Rows `idx` (int64 tensor) of the tensor `draw(shape, ...)` makes,
    drawn again chunk by chunk without the rest."""
    out = torch.empty((len(idx),) + tuple(shape[1:]), dtype=dtype,
                      device=device)
    chunks = torch.div(idx, CHUNK_ROWS, rounding_mode="floor")
    for c in torch.unique(chunks).tolist():
        i = c * CHUNK_ROWS
        tmp = torch.empty((min(CHUNK_ROWS, shape[0] - i),) + tuple(shape[1:]),
                          dtype=dtype, device=device)
        _fill(tmp, seed, tag, c, share)
        sel = (chunks == c).nonzero()[:, 0]
        out[sel] = tmp[idx[sel] - i]
        del tmp
    return out


class ResidentDataset:
    """A training split with the program's dataset surface (ix_to_word,
    label, label_start_ix / label_end_ix, info['images'], get_refs): random
    captions of 3 to seq_length words, captions_per_image of them an image,
    every image in the train split.  Its features live only on the card,
    in `_device_feat_cache`, where the program's Trainer takes the cache
    of a dataset it is given."""

    def __init__(self, num_images, vocab_size, seq_length,
                 captions_per_image, seed):
        rng = np.random.RandomState(common.mix(seed, "captions") % 2 ** 32)
        self.vocab_size = vocab_size
        self.seq_length = seq_length
        self.ix_to_word = {str(i): f"w{i}" for i in range(1, vocab_size + 1)}
        self.dataset_name = "portbench"
        self.gt_caps_per_image = captions_per_image
        n = num_images * captions_per_image
        lens = rng.randint(3, seq_length + 1, n)
        words = rng.randint(1, vocab_size + 1, (n, seq_length))
        self.label = np.where(np.arange(seq_length)[None, :] < lens[:, None],
                              words, 0).astype(np.int64)
        self.label_start_ix = np.arange(num_images) * captions_per_image + 1
        self.label_end_ix = self.label_start_ix + captions_per_image - 1
        self.info = {"images": [{"id": ix, "split": "train"}
                                for ix in range(num_images)]}
        self._device_feat_cache = None

    def num_images(self):
        return len(self.info["images"])

    def get_fc(self, ix):
        raise RuntimeError("features live on the card only")

    get_att = get_fc

    def get_refs(self, ix):
        return self.label[self.label_start_ix[ix] - 1: self.label_end_ix[ix]]
