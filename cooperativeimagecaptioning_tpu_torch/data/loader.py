"""Batch loader with the reference's exact get_batch semantics
(ref: dataloader.py:56-245) plus the project's extensions.  The port's own
copy of the JAX package's data/loader.py: host code on numpy, no torch.

Faithful behaviors:
  * 3 independent split iterators with wrap/shuffle-on-epoch (BlobFetcher,
    ref: dataloader.py:340-355) and resumable iterators/split_ix state;
  * caption subsampling per image: contiguous block or with-replacement when an
    image has fewer than seq_per_img captions (ref: dataloader.py:152-169);
  * label padding: zeros at column 0 and the tail (+2 masks, dataloader.py:194-237);
  * fc replicated seq_per_img times; att padded to batch max K with att_masks;
  * att_masks collapses to None when every K is equal (ref: dataloader.py:228-229);
  * data['gts'] carries raw reference rows for reward computation; data['bounds']
    carries the wrapped-epoch signal.

Extensions (off by default):
  * opt.max_att_len > 0 pads K to a static length (always emitting att_masks) so
    every training step has one shape;
  * a daemon-thread prefetcher hides feature IO behind device compute
    (the reference uses a child-process pool, dataloader.py:314-369).
"""

from __future__ import annotations

import queue
import random
import threading

import numpy as np

from cooperativeimagecaptioning_tpu_torch.data.sources import FileDataset


class _Prefetcher:
    """Background thread that stays `depth` items ahead of the consumer.

    Fetch errors are forwarded to the consumer (re-raised from get()) instead
    of silently killing the worker, and close() JOINS the thread so callers
    can rely on no in-flight fetch touching shared state afterwards."""

    def __init__(self, fetch_fn, depth: int):
        self.fetch_fn = fetch_fn
        self.q = queue.Queue(maxsize=max(1, depth))
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while not self.stop.is_set():
            try:
                item = (True, self.fetch_fn())
            except BaseException as e:  # surface to the consumer, then stop
                item = (False, e)
            while not self.stop.is_set():
                try:
                    self.q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if not item[0]:
                return

    def get(self):
        ok, item = self.q.get()
        if not ok:
            raise item
        return item

    def close(self):
        self.stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        # join so no in-flight fetch_fn mutates loader state after close()
        # (e.g. reset_iterator racing _next_index); the worker exits within
        # one 0.1s put-timeout once the current fetch returns
        self.thread.join()


class DataLoader:
    """Reference-compatible loader (same public surface as dataloader.py:56-245)."""

    def __init__(self, opt, dataset=None, prefetch: bool = False):
        self.opt = opt
        self.batch_size = opt.batch_size
        self.seq_per_img = opt.seq_per_img
        self.use_att = getattr(opt, "use_att", True)
        self.use_fc = getattr(opt, "use_fc", True)
        self.max_att_len = getattr(opt, "max_att_len", 0)
        self.ds = dataset if dataset is not None else FileDataset(opt)
        self.dataset = self.ds.dataset_name
        self.vocab_size = self.ds.vocab_size
        self.seq_length = self.ds.seq_length
        self.ix_to_word = self.ds.ix_to_word
        self.num_images = self.ds.num_images()

        self.split_ix = {"train": [], "val": [], "test": []}
        for ix in range(self.num_images):
            img = self.ds.info["images"][ix]
            if "split" not in img:
                for s in self.split_ix:
                    self.split_ix[s].append(ix)
            elif img["split"] in self.split_ix:
                self.split_ix[img["split"]].append(ix)
            elif opt.train_only == 0:  # restval
                self.split_ix["train"].append(ix)
        self.iterators = {"train": 0, "val": 0, "test": 0}
        self._consumed_it = None   # set per consumed batch (resume_state)
        self._consumed_six = None  # {split: order copy} as of consumption
        # split_ix order versioning: bumped on every train wrap-shuffle so
        # the fetch path can snapshot each order exactly once (a copy per
        # epoch, not per batch) while keeping (iterator, order) pairs
        # consistent for resume
        self._six_version = {"train": 0, "val": 0, "test": 0}
        self._six_cache = {}       # split -> (version, order copy)
        self._rng = random.Random(getattr(opt, "seed", 123))
        self._prefetchers = {}
        self._prefetch_enabled = prefetch
        self._prefetch_depth = getattr(opt, "prefetch_batches", 2)
        # splits whose batches skip feature loading (the Trainer's
        # device-resident feature cache gathers them on device by infos[ix];
        # labels/masks/gts/infos keep full fidelity)
        self.feature_free_splits = set()

    def set_feature_free(self, split, on=True):
        self._drop_prefetcher(split)  # queued batches carry features
        (self.feature_free_splits.add if on
         else self.feature_free_splits.discard)(split)

    # -- reference API -------------------------------------------------------
    def get_vocab(self):
        return self.ix_to_word

    def get_vocab_size(self):
        return self.vocab_size

    def get_seq_length(self):
        return self.seq_length

    def reset_iterator(self, split):
        # stop (and JOIN) the split's prefetch worker BEFORE zeroing the
        # iterator — the old order let an in-flight _fetch_batch re-advance
        # the counter after the reset, silently skipping the split's head
        self._drop_prefetcher(split)
        self.iterators[split] = 0
        if self._consumed_it is not None:
            self._consumed_it[split] = 0
        if self._consumed_six is not None:
            # position 0 is relative to the CURRENT live order — a stale
            # pre-shuffle order copy would desynchronize (iterator, order)
            self._consumed_six[split] = list(self.split_ix[split])

    # -- iteration -----------------------------------------------------------
    def _next_index(self, split):
        """ref: dataloader.py:340-355 — advance, wrapping + shuffling train."""
        ixs = self.split_ix[split]
        ri = self.iterators[split]
        ix = ixs[ri]
        ri_next = ri + 1
        wrapped = False
        if ri_next >= len(ixs):
            ri_next = 0
            if split == "train":
                self._rng.shuffle(ixs)
                self._six_version[split] += 1
            wrapped = True
        self.iterators[split] = ri_next
        return ix, wrapped

    def _get_captions(self, ix, spi):
        """ref: dataloader.py:152-169.  spi is passed explicitly (not read
        from self) so an eval-time seq_per_img switch can never corrupt a
        train batch a prefetch worker has in flight."""
        ds = self.ds
        ix1 = ds.label_start_ix[ix] - 1
        ix2 = ds.label_end_ix[ix] - 1
        ncap = ix2 - ix1 + 1
        assert ncap > 0, "an image does not have any label"
        if ncap < spi:
            seq = np.zeros([spi, self.seq_length], dtype="int64")
            for q in range(spi):
                ixl = self._rng.randint(ix1, ix2)
                seq[q, :] = ds.label[ixl, :self.seq_length]
        else:
            ixl = self._rng.randint(ix1, ix2 - spi + 1)
            seq = ds.label[ixl: ixl + spi, :self.seq_length]
        return seq

    def _fetch_one(self, split, spi):
        ix, wrapped = self._next_index(split)
        if split in self.feature_free_splits:
            seq = self._get_captions(ix, spi) \
                if self.ds.label is not None else None
            return (np.zeros((1,), np.float32), np.zeros((1, 1), np.float32),
                    seq, ix, wrapped)
        fc = self.ds.get_fc(ix) if self.use_fc else np.zeros((1,), np.float32)
        att = self.get_transformed_att(ix) if self.use_att \
            else np.zeros((1, 1), np.float32)
        seq = self._get_captions(ix, spi) \
            if self.ds.label is not None else None
        return fc, att, seq, ix, wrapped

    def get_transformed_att(self, ix):
        """Per-image att features with ALL opt-gated transforms applied —
        the single source both the streaming path and the device feature cache
        must use, or --norm_att_feat/--use_box would silently train on
        differently scaled features than eval."""
        att = self.ds.get_att(ix)
        if getattr(self.opt, "norm_att_feat", 0):
            # L2-normalize region features (ref: dataloader.py:263-264)
            att = att / np.linalg.norm(att, 2, 1, keepdims=True)
        if getattr(self.opt, "use_box", 0) and hasattr(self.ds, "get_box"):
            # append normalized box geometry (ref: dataloader.py:265-275)
            box = self.ds.get_box(ix)
            img = self.ds.info["images"][ix]
            h, w = img["height"], img["width"]
            x1, y1, x2, y2 = np.hsplit(box, 4)
            box_feat = np.hstack(
                (x1 / w, y1 / h, x2 / w, y2 / h,
                 (x2 - x1) * (y2 - y1) / (w * h)))
            if getattr(self.opt, "norm_box_feat", 0):
                box_feat = box_feat / np.linalg.norm(
                    box_feat, 2, 1, keepdims=True)
            att = np.hstack([att, box_feat])
            att = np.stack(sorted(att, key=lambda x: x[-1], reverse=True))
        return att

    def _assemble(self, items, split, spi):
        """ref: dataloader.py:171-245.  spi passed explicitly — see
        _get_captions."""
        batch_size = len(items)
        L = self.seq_length
        fc_batch, att_batch, label_batch, gts, infos = [], [], [], [], []
        wrapped = False
        for fc, att, seq, ix, w in items:
            wrapped = wrapped or w
            fc_batch.append(fc)
            att_batch.append(att)
            tmp_label = np.zeros([spi, L + 2], dtype="int64")
            if seq is not None:
                tmp_label[:, 1: L + 1] = seq
            label_batch.append(tmp_label)
            gts.append(self.ds.get_refs(ix) if self.ds.label is not None else [])
            img = self.ds.info["images"][ix]
            infos.append({"ix": ix, "id": img["id"],
                          "file_path": img.get("file_path", "")})

        data = {}
        data["fc_feats"] = np.stack(
            sum([[f] * spi for f in fc_batch], [])).astype(np.float32)
        max_len = max(a.shape[0] for a in att_batch)
        if self.max_att_len > 0:
            max_len = max(max_len, self.max_att_len)
        D = att_batch[0].shape[1]
        att = np.zeros([batch_size * spi, max_len, D], np.float32)
        att_masks = np.zeros([batch_size * spi, max_len], np.float32)
        for i, a in enumerate(att_batch):
            att[i * spi:(i + 1) * spi, :a.shape[0]] = a
            att_masks[i * spi:(i + 1) * spi, :a.shape[0]] = 1
        data["att_feats"] = att
        # collapse to None when uniform (ref :228-229) unless statically padded
        if self.max_att_len == 0 and att_masks.sum() == att_masks.size:
            data["att_masks"] = None
        else:
            data["att_masks"] = att_masks

        data["labels"] = np.vstack(label_batch).astype(np.int32)
        nonzeros = (data["labels"] != 0).sum(1) + 2
        mask_batch = np.zeros([data["labels"].shape[0], L + 2], np.float32)
        for i, n in enumerate(nonzeros):
            mask_batch[i, :n] = 1
        data["masks"] = mask_batch
        data["gts"] = gts
        data["bounds"] = {"it_pos_now": self.iterators[split],
                          "it_max": len(self.split_ix[split]),
                          "wrapped": wrapped}
        data["infos"] = infos
        return data

    def _fetch_batch(self, split, batch_size, spi=None):
        if spi is None:
            spi = self.seq_per_img
        data = self._assemble(
            [self._fetch_one(split, spi) for _ in range(batch_size)],
            split, spi)
        # snapshot the post-batch (iterator, order) pair WITH the batch:
        # with the prefetcher running, the live iterators are up to depth+1
        # batches ahead of what the trainer consumed — checkpointing the
        # live state would make resume skip data, and a fetched-not-consumed
        # wrap shuffle would leave the recorded position meaningful only in
        # an order the checkpoint doesn't carry.  The order copy is cached
        # per shuffle version (one list copy per epoch, in this same fetch
        # thread, so it can never tear against the shuffle).
        ver = self._six_version[split]
        cache = self._six_cache.get(split)
        if cache is None or cache[0] != ver:
            cache = (ver, list(self.split_ix[split]))
            self._six_cache[split] = cache
        return data, (split, self.iterators[split], cache[1])

    def _drop_prefetcher(self, split):
        pf = self._prefetchers.pop(split, None)
        if pf is not None:
            pf.close()

    def get_batch(self, split, batch_size=None):
        batch_size = batch_size or self.batch_size
        if not self._prefetch_enabled:
            data, snap = self._fetch_batch(split, batch_size)
            self._record_consumed(snap)
            return data
        pf = self._prefetchers.get(split)
        if pf is not None and (pf.batch_size != batch_size
                               or pf.seq_per_img != self.seq_per_img):
            # a different batch_size or seq_per_img (eval's rank pass
            # switches it) invalidates the prefetched batches
            self._drop_prefetcher(split)
            pf = None
        if pf is None:
            # bind spi into the fetch closure: an eval-time seq_per_img
            # switch must never leak into this split's in-flight fetches
            spi = self.seq_per_img
            pf = _Prefetcher(
                lambda s=split, b=batch_size, p=spi:
                self._fetch_batch(s, b, p),
                self._prefetch_depth)
            pf.batch_size = batch_size
            pf.seq_per_img = spi
            self._prefetchers[split] = pf
        data, snap = pf.get()
        self._record_consumed(snap)
        return data

    def _record_consumed(self, snap):
        # merge PER SPLIT: a val batch consumed during a checkpoint eval
        # must not clobber the train entries with live (fetch-ahead) state
        split, pos, six = snap
        if self._consumed_it is None:
            self._consumed_it = dict(self.iterators)
        if self._consumed_six is None:
            self._consumed_six = {}
        self._consumed_it[split] = pos
        self._consumed_six[split] = six

    def resume_state(self):
        """(iterators, split_ix) as of the last CONSUMED batch per split —
        what a checkpoint must record for exact resume (the live attributes
        run ahead while the prefetcher is active).  Splits never consumed
        in this process fall back to the live state, which is exact for them
        (no prefetcher has touched their iterator or order)."""
        if self._consumed_it is None:
            return self.iterators, self.split_ix
        six = dict(self.split_ix)
        six.update(self._consumed_six or {})
        return self._consumed_it, six

    def close(self):
        for split in list(self._prefetchers):
            self._drop_prefetcher(split)
