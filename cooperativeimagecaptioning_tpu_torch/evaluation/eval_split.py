"""Split evaluation: loss accumulation + caption generation + metric hooks
(counterpart of the JAX package's evaluation/eval_split.py; ref
eval_utils.py:89-280 eval_split, :283-412 encode_data, :415-542 evalrank).

The `Evaluator` takes the joint param tree (tensors on its device) and a
`DataLoader`, and runs on one device: the card unless the caller passes
`device="cpu"`.  Each batch runs the loss of training in eval mode (f32:
the caption loss, and with a listener its contrastive and DISC terms) and
one decode (greedy or beam; `compute_dtype`, `att_quant` and `att_kmajor`
as in the service), of the Att2in2 or the FC speaker.  The loop does not
synchronise per batch: the loss sums stay on the device and the decoded ids
are converted after the loop, but at most `MAX_IN_FLIGHT` batches are kept
undrained, so the host never runs further ahead of the device than that.

Ported: greedy, beam search, and `sample_max` 0 (multinomial at
`temperature`) and 2 (Gumbel-noise max), whose draws come from a generator
seeded with 123 on each batch, as the JAX package's fixed key; the CIDEr-D
term of the eval loss under `cider_optimization` (stage A and the host
reward, then the loss on the same trajectory); the REINFORCE DISC term of a
reinforce run (its sample from the streams of EVAL_SEED, its baseline's
greedy decode without autograd); the language metrics; and
the listener's half: `encode_fn`, `encode_data` (GT captions, or generated
ones with BOS prepended on the device) and `evalrank` (the rank metrics of
evaluation/retrieval.py on embeddings that stay on the device), ranked
each checkpoint on both val and test in phase 1, with the GT ranks beside
the generated-caption ranks when there is no ann_file.

On a mesh (`mesh=`, one rank of a (data, model) process grid; JAX
eval_split.py:30-60) the params are the rank's slices, each batch's rows
are split over the data group where they divide it (the last partial batch
stays whole on every rank), decoding on a model axis goes through the
vocab-sharded heads (the sampled decodes, `sample_max` 0 and 2, over the
model group's slices on the rank's rows of the global batch's draws), and
the decoded ids and the loss sums are gathered over the data group in
image order before the language metrics, which rank 0 computes (and
writes) and broadcasts.  The eval loss on a mesh is the training loss's
(training/joint.py): the listener's contrastive matrix over the data
group, and the CIDEr-D term's host reward over the group's gathered stage
A ids.  The listener's embeddings of a split (`encode_data`) are gathered
over the data group, so every rank ranks the whole split.  With a device
feature cache (`feat_cache`, the Trainer's: every image's features on the
device, on a mesh on every rank) the batches' features are gathered there
by their image indices.  The eval loss of an on_device_cider or soft_cider
run is what the JAX Evaluator computes: its eval batches carry no refs, so
the CIDEr term takes a zero reward (JAX eval_split.py:211-214).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cooperativeimagecaptioning_tpu_torch import models as model_zoo
from cooperativeimagecaptioning_tpu_torch.evaluation import (
    language_eval, retrieval)
from cooperativeimagecaptioning_tpu_torch.models import vse
from cooperativeimagecaptioning_tpu_torch.ops import decoding, draws, losses
from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
from cooperativeimagecaptioning_tpu_torch.parallel import collectives
from cooperativeimagecaptioning_tpu_torch.parallel import mesh as mesh_mod
from cooperativeimagecaptioning_tpu_torch.parallel.train_step import (
    row_streams)
from cooperativeimagecaptioning_tpu_torch.rewards import self_critical
from cooperativeimagecaptioning_tpu_torch.training import joint
from cooperativeimagecaptioning_tpu_torch.utils.text import decode_sequence
from cooperativeimagecaptioning_tpu_torch.utils.tree import detached, to_torch

# the fixed seed of the evaluation's random draws (JAX: PRNGKey(123))
EVAL_SEED = 123
# batches whose decoded ids may wait on the device before the loop stops to
# fetch the oldest: enough to keep the card fed, few enough to bound the queue
MAX_IN_FLIGHT = 4


class Evaluator:
    """Evaluation programs for one opt configuration on one device, or on
    one rank of a mesh (`mesh`, whose device it takes)."""

    def __init__(self, opt, mesh=None, feat_cache=None, device="cuda"):
        self.feat_cache = feat_cache
        self.mesh = mesh
        if mesh is not None:
            device = mesh.device
            _dispatch.set_vocab_mesh(mesh, opt.vocab_size)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Evaluator: device 'cuda' asked for but no CUDA device is "
                "available (pass device='cpu' to run the plain versions on "
                "the host)")
        self.opt = opt
        self.speaker = model_zoo.setup(opt, opt.caption_model,
                                       "caption_model")
        self.last_timings = {}
        # batches of the last eval_split fetched inside its loop, because
        # MAX_IN_FLIGHT newer ones were queued behind them
        self.drained_in_loop = 0

    # -- device programs -----------------------------------------------------
    def decode_draws(self):
        """The draw source of one decode call: a generator seeded with
        EVAL_SEED on the evaluator's device, anew for every batch."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(EVAL_SEED)
        return draws.Draws(gen)

    def _decode_source(self, rows):
        """`decode_draws`, as this rank's rows of its draws where a batch's
        rows are split over the data group (`rows`)."""
        src = self.decode_draws()
        if rows is None:
            return src
        return draws.RowShard(src, self.mesh.n_data, self.mesh.data_index)

    def _streams(self, rows):
        """The named streams of EVAL_SEED (the eval loss's draws), as this
        rank's rows where the batch's rows are split."""
        streams = joint.streams(EVAL_SEED, self.device)
        return streams if rows is None else row_streams(streams, self.mesh)

    def _split_rows(self, arrays, n_rows):
        """(arrays, rows): this rank's share of a batch's rows and the data
        group they are split over, or the arrays whole and None (no mesh, a
        data axis of 1, or rows that do not divide it)."""
        mesh = self.mesh
        if mesh is None or mesh.n_data == 1 or n_rows % mesh.n_data:
            return arrays, None
        return mesh_mod.shard_batch(arrays, mesh), mesh.data

    def _fetch(self, seq, rows):
        """Decoded ids to the host, in image order across the data group."""
        return collectives.all_gather(seq, rows).cpu().numpy()

    def _decode_fn(self, beam_size, sample_max=1, temperature=1.0):
        """Decode program for the eval protocol: fn(params, fc, att,
        att_masks, rows=None) -> (seq, logprobs) (`rows`: the data group the
        rows are split over, for the sampled modes' draws).  sample_max semantics follow the
        reference (FCModel.py:262-301): 1 = greedy, 2 = Gumbel-noise max, 0 =
        multinomial at `temperature`; beam_size > 1 overrides.  The speaker
        module is rebuilt from `params` on each call (no copy in f32; one
        cast of the tree in bf16), so an evaluator follows a tree that
        training updates in place."""
        mode = {1: "greedy", 2: "gumbel_noise_max"}.get(int(sample_max),
                                                         "sample")
        opt = self.opt
        dtype = torch.bfloat16 if getattr(opt, "compute_dtype", "") == \
            "bfloat16" else None

        def run(params, fc, att, att_masks, rows=None):
            with torch.inference_mode():
                spk = self.speaker(to_torch(joint.speaker_view(params, opt),
                                            self.device, dtype))
                if dtype is not None:  # serving precision (--compute_dtype)
                    fc = fc.to(dtype)
                    att = None if att is None else att.to(dtype)
                ctx = spk.encode_features(fc, att, att_masks)
                # the layouts of an attention context (the FC speaker's
                # context holds the fc features only)
                if "att_feats" in ctx:
                    if getattr(opt, "att_quant", "") == "int8":
                        ctx = spk.quantize_ctx(ctx)
                    elif getattr(opt, "att_kmajor", 0):
                        ctx = spk.kmajor_ctx(ctx)
                if beam_size > 1:
                    out = decoding.beam_search(
                        spk, ctx, opt.seq_length, beam_size,
                        decoding_constraint=opt.decoding_constraint)
                else:
                    out = decoding.sample(
                        spk, ctx, opt.seq_length,
                        None if mode == "greedy" else
                        self._decode_source(rows),
                        mode=mode, temperature=temperature,
                        decoding_constraint=opt.decoding_constraint)
                return out.seq, out.logprobs
        return run

    def loss_fn(self, params, batch, reward=None, rows=None):
        """The training loss of one batch in eval mode (no dropout, no
        scheduled sampling), in f32: (loss, aux), scalars on the device.
        Under cider_optimization the CIDEr term samples from the streams of
        EVAL_SEED, as `_reward_for` does.  `rows`: the data group the
        batch's rows are split over (this rank's share of the loss)."""
        opt = self.opt
        with torch.no_grad():
            return joint.loss_fn({"speaker": self.speaker}, params, opt,
                                 batch, self._streams(rows),
                                 joint.Hyper.from_opt(opt), "optimizer",
                                 reward, train=False, rows=rows)

    def _reward_for(self, params, batch, data, rows=None):
        """The host CIDEr-D reward of the eval loss (JAX
        eval_split.py:296-321): stage A from the streams of EVAL_SEED, then
        the self-critical reward of the batch's ground truth; where the rows
        are split (`rows`), this rank's rows of the global batch's."""
        opt = self.opt
        gen, greedy = joint.sample_for_reward(
            {"speaker": self.speaker}, params, opt, batch, self._streams(rows),
            joint.Hyper.from_opt(opt), "optimizer", train=False, rows=rows)
        reward, _, _ = joint.host_reward(opt, data["gts"], gen, greedy, rows)
        return torch.from_numpy(reward).to(self.device)

    def encode_fn(self, params, fc, seqs, masks):
        """The listener's (image, caption) embeddings of one batch (JAX
        eval_split.py:117-126)."""
        with torch.inference_mode():
            listener = vse.VSEModel(params["listener"], self.opt)
            return listener.encode_image(fc), listener.encode_text(seqs,
                                                                   masks)

    # -- helpers -------------------------------------------------------------
    def _put(self, x, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device,
                                                            dtype)

    def _cached_feats(self, data, per_image):
        """(fc, att, att_masks) gathered from the device feature cache by
        the batch's image indices, att cast back to float32; None without a
        cache.  per_image=False repeats each image's row to the caption
        rows of the labels (JAX eval_split.py:129-150)."""
        if self.feat_cache is None or not data.get("infos"):
            return None
        idx = np.asarray([i["ix"] for i in data["infos"]], np.int64)
        if not per_image and data.get("labels") is not None:
            rep = data["labels"].shape[0] // max(1, len(idx))
            if rep > 1:
                idx = np.repeat(idx, rep)
        rows = self._put(idx, torch.int64)
        cache = self.feat_cache
        fc = cache["fc"].index_select(0, rows)
        att = am = None
        if self.opt.use_att and "att" in cache:
            att = cache["att"].index_select(0, rows).to(torch.float32)
            am = cache["att_mask"].index_select(0, rows)
        return fc, att, am

    def _batch_arrays(self, data):
        """Host batch dict -> tensors on the device (labels int64, the rest
        float32), one feature row per caption row."""
        batch = {"labels": self._put(data["labels"], torch.int64),
                 "masks": self._put(data["masks"]),
                 "att_feats": None, "att_masks": None}
        cached = self._cached_feats(data, per_image=False)
        if cached is not None:
            batch["fc_feats"], batch["att_feats"], batch["att_masks"] = cached
            return batch
        batch["fc_feats"] = self._put(data["fc_feats"])
        if data.get("att_feats") is not None and self.opt.use_att:
            batch["att_feats"] = self._put(data["att_feats"])
            if data.get("att_masks") is not None:
                batch["att_masks"] = self._put(data["att_masks"])
        return batch

    def _dedup(self, data, loader):
        """One feature row per image (ref: eval_utils.py:163-176)."""
        cached = self._cached_feats(data, per_image=True)
        if cached is not None:
            return cached
        idx = np.arange(loader.batch_size) * loader.seq_per_img
        use_att = self.opt.use_att
        fc = self._put(data["fc_feats"][idx])
        att = self._put(data["att_feats"][idx]) \
            if data.get("att_feats") is not None and use_att else None
        am = self._put(data["att_masks"][idx]) \
            if data.get("att_masks") is not None and use_att else None
        return fc, att, am

    # -- main entry (ref: eval_utils.py:89-280) -------------------------------
    def eval_split(self, params, loader, eval_kwargs=None, ann_file=None,
                   use_gen_sent=False):
        opt = self.opt
        ek = dict(eval_kwargs or {})
        num_images = ek.get("num_images", ek.get("val_images_use",
                                                 opt.val_images_use))
        split = ek.get("split", "val")
        lang_eval = ek.get("language_eval", opt.language_eval)
        rank_eval = ek.get("rank_eval", opt.rank_eval)
        beam_size = int(ek.get("beam_size", opt.beam_size))
        sample_max = ek.get("sample_max", 1)
        temperature = ek.get("temperature", 1.0)
        verbose = ek.get("verbose", False)

        np.random.seed(123)  # determinism pin (ref: eval_utils.py:105)
        # a view without gradients: the heads refuse inputs that need them
        params = detached(to_torch(params, self.device))
        if joint.needs_reward(opt, "optimizer"):
            self_critical.init_scorer(opt.cached_tokens)
        _t = {"start": time.time()}
        loader.reset_iterator(split)
        n = 0
        # loss sums of whole batches, and (on a mesh) of this rank's shares
        losses_acc, shares_acc = {}, {}
        loss_evals = 1e-8
        predictions = []
        # [seq, infos, keep, rows]: seq stays on the device until it is
        # drained (gathered over `rows` on a mesh)
        pending = []
        drained = 0  # pending[:drained] hold host arrays already
        decode = self._decode_fn(beam_size, sample_max, temperature)
        while True:
            data = loader.get_batch(split)
            n += loader.batch_size
            if data.get("labels") is not None:
                batch, rows = self._split_rows(self._batch_arrays(data),
                                               data["labels"].shape[0])
                reward = None
                if joint.needs_reward(opt, "optimizer"):
                    reward = self._reward_for(params, batch, data, rows)
                loss, aux = self.loss_fn(params, batch, reward, rows)
                # accumulate device scalars: converting per batch would
                # synchronise host and device every batch; one transfer per
                # key at the end
                acc = losses_acc if rows is None else shares_acc
                for k, v in aux.items():
                    acc[k] = acc.get(k, 0.0) + v
                acc["loss"] = acc.get("loss", 0.0) + loss
                loss_evals += 1

            (fc, att, am), rows = self._split_rows(
                self._dedup(data, loader), loader.batch_size)
            seq, _ = decode(params, fc, att, am, rows)
            ix1 = data["bounds"]["it_max"]
            if num_images != -1:
                ix1 = min(ix1, num_images)
            keep = len(data["infos"]) - max(0, n - ix1)
            pending.append([seq, data["infos"], keep, rows])
            # bound the work in flight: waiting for the oldest undrained
            # batch leaves the newer ones queued on the device
            while len(pending) - drained > MAX_IN_FLIGHT:
                oldest = pending[drained]
                oldest[0] = self._fetch(oldest[0], oldest[3])
                drained += 1
            if data["bounds"]["wrapped"]:
                break
            if 0 <= num_images <= n:
                break
        _t["loop_dispatch"] = time.time()
        self.drained_in_loop = drained
        for seq, infos, keep, rows in pending:
            if torch.is_tensor(seq):
                seq = self._fetch(seq, rows)
            sents = decode_sequence(loader.get_vocab(), seq)
            for k, sent in enumerate(sents[:keep]):
                predictions.append({"image_id": infos[k]["id"],
                                    "caption": sent})
                if verbose:
                    print(f"image {infos[k]['id']}: {sent}")

        _t["decode_drain"] = time.time()
        if shares_acc:
            keys = sorted(shares_acc)
            total = collectives.all_reduce(
                torch.stack([torch.as_tensor(shares_acc[k]) for k in keys]),
                self.mesh.data)
            for k, v in zip(keys, total):
                losses_acc[k] = losses_acc.get(k, 0.0) + v
        lang_stats = {}
        phase = getattr(opt, "phase", 0)
        writer = self.mesh is None or self.mesh.rank == 0
        if lang_eval == 1 and writer:
            if phase == 1:
                # phase-1 twist: language metrics for both val and test each
                # checkpoint (ref: eval_utils.py:230-236)
                lang_stats = {
                    s: language_eval.language_eval(
                        opt.dataset, predictions, opt.id, s,
                        ann_file=ann_file, loader=loader)
                    for s in ("val", "test")}
            else:
                lang_stats = language_eval.language_eval(
                    opt.dataset, predictions, opt.id, split,
                    ann_file=ann_file, loader=loader)

        if self.mesh is not None:
            # rank 0 computed them (and wrote eval_results/)
            lang_stats = collectives.broadcast_object(lang_stats,
                                                      self.mesh.world)
        _t["lang"] = time.time()
        out_losses = {k: float(v) / loss_evals for k, v in losses_acc.items()}
        if rank_eval:
            if not use_gen_sent and phase == 1:
                # rank both splits each checkpoint (ref: eval_utils.py:259-267)
                ranks = {}
                for s in ("val", "test"):
                    ek_s = dict(ek)
                    ek_s["split"] = s
                    ranks[s] = self.evalrank(params, loader, ek_s,
                                             use_gen_sent)
            else:
                ranks = self.evalrank(params, loader, ek, use_gen_sent)
            out_losses.update(ranks)
            if use_gen_sent and not ann_file:
                out_losses["gt_ranks"] = self.evalrank(params, loader, ek,
                                                       use_gen_sent=False)
        _t["rank"] = time.time()
        # where an evaluation's time goes: the batch loop (host enqueue, and
        # waiting where max_in_flight binds), the drain (the device finishing,
        # transfer, host detokenize), language metrics (host), rank passes
        self.last_timings = {
            "loop_dispatch_s": round(_t["loop_dispatch"] - _t["start"], 3),
            "decode_drain_s": round(_t["decode_drain"] - _t["loop_dispatch"], 3),
            "lang_eval_s": round(_t["lang"] - _t["decode_drain"], 3),
            "rank_eval_s": round(_t["rank"] - _t["lang"], 3),
        }
        return out_losses, predictions, lang_stats

    # -- retrieval (ref: eval_utils.py:283-542) --------------------------------
    def encode_data(self, params, loader, eval_kwargs=None,
                    use_gen_sent=False):
        """(image embeddings, caption embeddings, the images' infos) of a
        split (JAX eval_split.py:324-380): the GT captions, gt_caps_per_image
        rows an image, or one caption an image generated greedily (or, with
        `gen_sample_max`, sampled) with BOS prepended on the device.  The
        embeddings stay on the device.  On a mesh each rank encodes its
        share of a batch's rows and the data group's embeddings are
        gathered in row order."""
        opt = self.opt
        ek = dict(eval_kwargs or {})
        num_images = ek.get("num_images", ek.get("val_images_use",
                                                 opt.val_images_use))
        split = ek.get("split", "val")
        params = detached(to_torch(params, self.device))
        saved_spi = loader.seq_per_img
        gt_cpi = getattr(loader.ds, "gt_caps_per_image", 5)
        loader.seq_per_img = 1 if use_gen_sent else gt_cpi
        loader.reset_iterator(split)
        img_embs, cap_embs, images_data = [], [], []
        n = 0
        # the reference pins the generated captions to greedy
        # (eval_utils.py:347); gen_sample_max ranks sampled ones instead
        decode = self._decode_fn(1, int(ek.get("gen_sample_max", 1)))
        V = opt.vocab_size
        try:
            while True:
                data = loader.get_batch(split)
                n += loader.batch_size
                if not use_gen_sent:
                    # with a device feature cache the loader hands out no
                    # features (JAX eval_split.py:347-349)
                    cached = self._cached_feats(data, per_image=False)
                    fc = cached[0] if cached is not None else \
                        self._put(data["fc_feats"])
                    (fc, labels, masks), rows = self._split_rows(
                        (fc, self._put(data["labels"], torch.int64),
                         self._put(data["masks"])),
                        data["labels"].shape[0])
                    img_emb, cap_emb = self.encode_fn(params, fc, labels,
                                                      masks)
                else:
                    (fc, att, am), rows = self._split_rows(
                        self._dedup(data, loader), loader.batch_size)
                    seq, _ = decode(params, fc, att, am, rows)
                    img_emb, cap_emb = self.encode_fn(
                        params, fc, joint._prepend_bos_ids(seq.long(), V),
                        losses.masks_from_seq(seq))
                img_emb = collectives.all_gather(img_emb, rows)
                cap_emb = collectives.all_gather(cap_emb, rows)
                ix1 = data["bounds"]["it_max"]
                if num_images != -1:
                    ix1 = min(ix1, num_images)
                if n > ix1:
                    keep = (ix1 - n) * loader.seq_per_img
                    img_emb, cap_emb = img_emb[:keep], cap_emb[:keep]
                    images_data += data["infos"][: ix1 - n]
                else:
                    images_data += data["infos"]
                img_embs.append(img_emb)
                cap_embs.append(cap_emb)
                if data["bounds"]["wrapped"]:
                    break
                if 0 <= num_images <= n:
                    break
        finally:
            loader.seq_per_img = saved_spi
        return torch.cat(img_embs), torch.cat(cap_embs), images_data

    def evalrank(self, params, loader, eval_kwargs=None, use_gen_sent=False):
        """The rank metrics of a split (JAX eval_split.py:382-392; {} for a
        tree without a listener)."""
        if "listener" not in params:
            return {}
        img, cap, images_data = self.encode_data(params, loader, eval_kwargs,
                                                 use_gen_sent)
        cpi = 1 if use_gen_sent else getattr(loader.ds, "gt_caps_per_image",
                                             5)
        return retrieval.rank_metrics(
            img, cap, images_data, use_gen_sent=use_gen_sent,
            fold5=(eval_kwargs or {}).get("fold5", 0), caps_per_image=cpi)
