"""The training loop (counterpart of the JAX package's training/loop.py;
ref train.py).

One iteration = the turn (alternating: `turns[iteration % len(turns)]`, so
a resumed run keeps its parity) -> schedules -> batch (host numpy ->
device tensors) -> [stage A sampling + host CIDEr-D reward] -> loss and
gradients (the turn's `joint.value_and_grad`) -> guarded per-agent Adam
[-> the grad-isolation audit] -> the BN running statistics -> loss
history; `checkpoint_operations` evaluates and writes the run dir (model,
optimizer, infos and histories; JAX loop.py:721-815), from which
`start_from` resumes.  Ported: phase-1 listener pretraining
(run_fc_con.py), phase-2 MLE (run_att.sh), self-critical CIDEr-D
fine-tuning with the host reward, and phase-3 joint training: the relaxed
DISC loss (run_joint.py -o gumbel / multinomial / gumbel_softmax /
multinomial_soft, alternating with its one effective turn, and the
non-alternating `_speaker` ablations) and REINFORCE DISC with its greedy,
GT or no baseline (-o reinforce: real speaker / listener alternation, each
turn stepping its own agent; the `reinforce_listener` and
`reinforce_speaker` ablations), seeded by the JAX package's bootstrap
cascade (a stage-2 speaker, an `initialize_retrieval` listener, a
`start_from` dir) or resumed.  With --audit_grad_isolation 1 each
accepted step is checked to have moved only the turn's agents
(training/audit.py); --profile_dir traces the iterations [profile_start,
profile_start + profile_steps) with torch.profiler (utils/profiling.py).
The device is explicit (`device=`); every random draw of an iteration
comes from the named streams of `joint.streams`, seeded from `opt.seed`
and the iteration, so stage B re-draws stage A's trajectory.

Every phase also runs on a (data, model) process grid (`mesh_data_axis`,
`mesh_model_axis`; one process per mesh position, started by the port's
train entry point or torchrun, on one host or on several): each rank puts
its rows of the global batch on its device (from the device feature cache,
which every rank holds whole, as the JAX package replicates it) and keeps
its slices of the vocabulary matrices, and each turn steps through its
`parallel.train_step.make_distributed_train_step`; stage A samples the
rank's rows and the host reward scores the data group's gathered ids
(`joint.host_reward`); att_bn's running statistics are the global
batch's, the same on every rank; the audit and the profiler window run on
every rank.  Global rank 0 alone reads and writes the run dir: a resume
(`start_from`, the bootstrap cascade's seeds) is read there and sent to
every rank, since a rank on another host may not see its files, and the
run dir it writes holds the slices gathered, so it is the file set of a
single-device run and either resumes the other.

The device tiers of the CIDEr-D reward (on_device_cider: the hashed n-gram
CIDEr-D inside the step; soft_cider: the differentiable soft CIDEr) need
no host stage: each batch carries its refs padded to the dataset's largest
ref count, so every batch has one shape, and a cached df (cached_tokens
other than 'corpus') is loaded once as a device `DfTable`.  With
device_feature_cache every image's fc / att features sit on the device
(`_build_feature_cache`, f32 or bf16) and batches are gathered there by
their image indices.  With fused_steps K > 1 (and the cache) up to K
iterations are staged on the host and run as one chunk (`train_chunk`): on
the card one iteration captured as CUDA graphs and replayed per step
(training/fused.py); on a mesh every rank stages the same global rows in
one copy and keeps its own, and the captured iteration is the mesh step
in segments between its collectives.  `_fused_gate` names what keeps a
configuration on the per-step path, as the JAX package's gate does.
"""

from __future__ import annotations

import contextlib
import copy
import os
import time

import numpy as np
import torch

from cooperativeimagecaptioning_tpu_torch import config as config_mod
from cooperativeimagecaptioning_tpu_torch.data import DataLoader
from cooperativeimagecaptioning_tpu_torch.models import att_model
from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
from cooperativeimagecaptioning_tpu_torch.parallel import collectives
from cooperativeimagecaptioning_tpu_torch.parallel import mesh as mesh_mod
from cooperativeimagecaptioning_tpu_torch.parallel.train_step import (
    data_rows, make_distributed_train_step, row_streams)
from cooperativeimagecaptioning_tpu_torch.rewards import (
    ngram_device, self_critical)
from cooperativeimagecaptioning_tpu_torch.training import audit
from cooperativeimagecaptioning_tpu_torch.training import checkpoint as ck
from cooperativeimagecaptioning_tpu_torch.training import (
    fused, joint, schedules)
from cooperativeimagecaptioning_tpu_torch.training.optim import (
    OptimizerManager, agents_to_update, effective_turns)
from cooperativeimagecaptioning_tpu_torch.utils import profiling
from cooperativeimagecaptioning_tpu_torch.utils.tree import trainable

def _on(tensor, device):
    """Whether `tensor` lies on `device` ('cuda' means the current card)."""
    want = torch.device(device)
    if want.type == "cuda" and want.index is None:
        want = torch.device("cuda", torch.cuda.current_device())
    return tensor.device == want


def cache_bytes(cache):
    """Bytes of the tensors of a feature cache."""
    return sum(v.numel() * v.element_size() for k, v in cache.items()
               if not k.startswith("_"))


class _Overflow(Exception):
    """An image has more att slots than max_att_len (the cache then pads
    to the largest image)."""


class Trainer:
    """Training on one device: phase 1 (the listener), phase 2 (MLE), and
    phase 3 (self-critical CIDEr-D with the host or a device reward, the
    relaxed and the REINFORCE DISC loss, alternating turns), step by step
    or in fused chunks; each also step by step as one rank of a mesh
    (`self.mesh`)."""

    def __init__(self, opt, dataset=None, rng_seed=None, verbose=True,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: device 'cuda' asked for but no CUDA "
                               "device is available")
        opt.use_att = config_mod.if_use_att(opt)
        self.opt = opt
        self.verbose = verbose
        self.loader = DataLoader(opt, dataset=dataset,
                                 prefetch=getattr(opt, "prefetch_batches", 0)
                                 > 0 and dataset is None)
        opt.vocab_size = self.loader.vocab_size
        opt.seq_length = self.loader.seq_length

        # the device mesh (JAX loop.py:96-119): this process is one rank of
        # it, on the rank's device
        self.mesh = None
        shape = mesh_mod.mesh_shape(opt, self.device.type)
        if shape is not None:
            eff_batch = opt.batch_size * opt.seq_per_img
            if eff_batch % shape[0]:
                raise ValueError(
                    f"batch_size*seq_per_img ({eff_batch}) must divide the "
                    f"data axis ({shape[0]})")
            self.mesh = mesh_mod.make_mesh(*shape, device=self.device.type)
            self.device = self.mesh.device

        # global rank 0 alone reads the files of a resume and of the
        # bootstrap cascade, and writes the run dir; every rank gets what
        # it read (a rank on another host may not see them)
        world = None if self.mesh is None else self.mesh.world
        reader = world is None or world.rank == 0
        self.ckpt = ck.CheckpointManager(opt, writer=reader)
        infos = mesh_mod.on_rank0(world, self.ckpt.load_infos)
        histories = mesh_mod.on_rank0(world, self.ckpt.load_histories)

        seed = rng_seed if rng_seed is not None else getattr(opt, "seed", 123)
        params, resumed = joint.init_params(seed, opt, self.device), False
        if reader:
            params, resumed = self._bootstrap(params)
        if self.mesh is not None:
            # replicated from rank 0; each rank keeps its slices below
            resumed = collectives.broadcast_object(resumed, world)
            mesh_mod.replicate(params, self.mesh)
            self.param_specs = mesh_mod.param_specs(params, self.mesh)
        self.params = {agent: trainable(tree)
                       for agent, tree in params.items()}

        self.optim = OptimizerManager(opt, self.params, world)
        loaded = reader and self._load_optimizers(resumed)
        if self.mesh is not None:
            if collectives.broadcast_object(loaded, world):
                mesh_mod.replicate_states(self.optim.states, self.mesh)
            # Adam states load at whole shapes (either package's files),
            # then each rank keeps its slices
            self.optim.states = mesh_mod.shard_states(
                self.optim.states, self.optim.paths, self.mesh,
                self.param_specs)
            self.params = {agent: trainable(tree) for agent, tree in
                           mesh_mod.shard_params(params, self.mesh,
                                                 self.param_specs).items()}
            _dispatch.set_vocab_mesh(self.mesh, opt.vocab_size)
        self.turns = effective_turns(opt)

        # resume counters (ref train.py:360-375)
        self.iteration = infos.get("iter", 0)
        self.epoch = infos.get("epoch", 0)
        self.epoch_start = self.epoch
        self.loader.iterators = infos.get("iterators", self.loader.iterators)
        self.loader.split_ix = infos.get("split_ix", self.loader.split_ix)
        self.gumbel_temp = infos.get("gumbel_temp", opt.gumbel_temp)
        self.best_val_score = infos.get("best_val_score", None) \
            if opt.load_best_score else None
        self.best_val_score_vse = infos.get("best_val_score_vse", None) \
            if opt.load_best_score else None
        self.infos = infos
        self.histories = histories
        self.val_result_history = histories.get("val_result_history", {})
        self.loss_history = histories.get("loss_history", {})
        self.lr_history = histories.get("lr_history", {})
        self.ss_prob_history = histories.get("ss_prob_history", {})

        # an iteration's streams are seeded from this and its number
        self._seed = seed + 1
        # one loss and one stage-A program per turn (on a mesh the turn's
        # distributed step, and stage A on the rank's rows)
        names = self.turns if opt.is_alternating else ["optimizer"]
        rows = None if self.mesh is None else data_rows(self.mesh)
        self._grad_fns = {t: joint.value_and_grad(opt, t) for t in names}
        self._sample_fns = {t: joint.sampler(opt, t, rows) for t in names}
        self._mesh_steps = {} if self.mesh is None else {
            t: make_distributed_train_step(opt, t, self.mesh) for t in names}
        self._evaluator = None
        # the path of the last profiler trace `train` wrote
        self.last_trace = None
        # stage A's and stage B's sampled ids of the last reward iteration
        self.last_reward_seqs = None
        # the last iteration's sampled ids by branch ('seq', 'disc_seq',
        # 'listener_seq'; on a mesh this rank's rows)
        self.last_sampled = {}
        if opt.cider_optimization > 0:
            self_critical.init_scorer(opt.cached_tokens)
        # the cached-df tier of the device reward: df lookups linear in B
        # (ref non-corpus mode, ciderD_scorer.py:62-75; JAX loop.py:166-180)
        self._df_table = None
        if joint.needs_device_refs(opt) and opt.cached_tokens != "corpus":
            self._df_table = ngram_device.load_df_table(
                f"data/{opt.cached_tokens}.p", self.device)
        # every batch's refs padded to the dataset's largest ref count, so
        # that every batch has one shape (one graph serves them all)
        ds = self.loader.ds
        self._max_refs = int(np.max(np.asarray(ds.label_end_ix)
                                    - np.asarray(ds.label_start_ix) + 1)) \
            if getattr(ds, "label", None) is not None else 0
        self._feat_cache = None
        # seconds this Trainer spent building the cache (0 when it reuses
        # the dataset's)
        self.feature_cache_seconds = 0.0
        if getattr(opt, "device_feature_cache", 0):
            self._feat_cache = self._shared_feature_cache()
            self.loader.set_feature_free("train")
        # (turn, use_ss) -> fused.FusedStep; the one-time gate notice
        self._fused = {}
        self._fused_notice = None
        self._update_schedules()

    # -- the device feature cache (JAX loop.py:217-310) -------------------------
    def _shared_feature_cache(self):
        """The dataset's device cache when an earlier Trainer of this
        process built one on this device with the same att transforms (it
        rides the dataset object, so multi-stage protocols copy the
        features once), else a new one; a phase-1 cache without att is
        extended with it."""
        ds = self.loader.ds
        cache = getattr(ds, "_device_feat_cache", None)
        here = cache is not None and _on(cache["fc"], self.device)
        if cache is not None and (not here or (
                self.opt.use_att and "att" in cache
                and cache.get("_att_sig") != self._att_cache_sig())):
            # another device, or att cached under other transforms or
            # another storage dtype: keep nothing of another device, and
            # drop another stage's att block
            cache = None if not here else {
                k: v for k, v in cache.items()
                if k not in ("att", "att_mask", "_att_sig")}
        if cache is None or (self.opt.use_att and "att" not in cache):
            cache = self._build_feature_cache(base=cache)
            try:
                ds._device_feat_cache = cache
            except AttributeError:
                pass
        return cache

    def _put_chunked(self, rows, shape, dtype, chunk_bytes=64 << 20):
        """A [N, ...] tensor of `dtype` on the device, filled from `rows(i,
        j)` (numpy float32 rows i..j) in chunks of about `chunk_bytes`: one
        preallocated buffer, so the peak is N plus one chunk, on the host
        and on the device; a bf16 buffer rounds each chunk on the device."""
        buf = torch.empty(shape, dtype=dtype, device=self.device)
        row_bytes = max(1, int(np.prod(shape[1:])) * 4)
        step = max(1, chunk_bytes // row_bytes)
        for i in range(0, shape[0], step):
            j = min(shape[0], i + step)
            buf[i:j].copy_(torch.from_numpy(
                np.ascontiguousarray(rows(i, j), np.float32)))
        return buf

    def _att_cache_sig(self):
        """What the att block's content depends on: the opt-gated
        transforms applied when it was built, and the storage dtype."""
        o = self.opt
        return (int(getattr(o, "norm_att_feat", 0)),
                int(getattr(o, "use_box", 0)),
                int(getattr(o, "norm_box_feat", 0)),
                getattr(o, "feature_cache_dtype", "f32"))

    def _build_feature_cache(self, base=None):
        """{'fc' [N, F] f32, 'att' [N, K, D] (f32, or bf16 with
        feature_cache_dtype 'bf16'), 'att_mask' [N, K] f32} for every image
        of the dataset; K is max_att_len, or the largest image's slots
        (also where an image outgrows max_att_len, as the streaming
        loader's batches grow)."""
        ds, loader = self.loader.ds, self.loader
        N = ds.num_images()
        t0 = time.perf_counter()
        if base is not None and "fc" in base:
            cache = {k: v for k, v in base.items() if k != "_att_sig"}
        else:
            fc = np.stack([np.asarray(ds.get_fc(ix), np.float32)
                           for ix in range(N)])
            cache = {"fc": self._put_chunked(lambda i, j: fc[i:j], fc.shape,
                                             torch.float32)}
        if self.opt.use_att and "att" not in cache:
            store = torch.bfloat16 if self.opt.feature_cache_dtype == \
                "bf16" else torch.float32
            atts = None
            K = loader.max_att_len
            first = np.asarray(loader.get_transformed_att(0), np.float32)
            D = first.shape[1]
            if not K:
                atts = [np.asarray(loader.get_transformed_att(ix), np.float32)
                        for ix in range(N)]
                K = max(a.shape[0] for a in atts)
            lens = np.zeros((N,), np.int64)

            def rows(i, j):
                out = np.zeros((j - i, K, D), np.float32)
                for r in range(i, j):
                    a = atts[r] if atts is not None else np.asarray(
                        loader.get_transformed_att(r), np.float32)
                    if a.shape[0] > K:
                        raise _Overflow()
                    out[r - i, :a.shape[0]] = a
                    lens[r] = a.shape[0]
                return out

            try:
                att = self._put_chunked(rows, (N, K, D), store)
            except _Overflow:
                # an image outgrows max_att_len: K = the largest image
                atts = [np.asarray(loader.get_transformed_att(ix), np.float32)
                        for ix in range(N)]
                K = max(K, max(a.shape[0] for a in atts))
                att = self._put_chunked(rows, (N, K, D), store)
            cache["att"] = att
            mask = (np.arange(K)[None, :] < lens[:, None]).astype(np.float32)
            cache["att_mask"] = torch.from_numpy(mask).to(self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.feature_cache_seconds = time.perf_counter() - t0
        if "att" in cache:
            cache["_att_sig"] = self._att_cache_sig()
        if self.verbose:
            print(f"device feature cache resident: {N} images, "
                  f"{cache_bytes(cache) / 2 ** 30:.2f} GB")
        return cache

    @property
    def feature_cache_bytes(self):
        """Bytes the device feature cache holds (0 without one)."""
        return cache_bytes(self._feat_cache or {})

    def _load_optimizers(self, resumed):
        """Load the Adam states of a resume or of the cross-stage seeds;
        whether any loaded."""
        opt = self.opt
        if resumed:
            # the Adam moments and counts beside the params (ref
            # optimizer.py:149-188)
            return self.ckpt.load_optimizers(self.optim)
        if getattr(opt, "share_embed", 0):
            return False
        # cross-stage seeding: the stage-2 speaker's Adam state and the
        # stage-1 listener's (its optimizer.pth beside initialize_retrieval);
        # both skipped under share_embed (ref optimizer.py:49-96; JAX
        # loop.py:126-141)
        loaded = False
        p2 = getattr(opt, "speaker_stage_2_optimizer_path", "") or ""
        if p2:
            loaded |= self.ckpt.load_agent_optimizer(self.optim, "speaker", p2)
        ir = getattr(opt, "initialize_retrieval", "") or ""
        p1 = os.path.join(os.path.dirname(ir), "optimizer.pth")
        if ir and "listener" in self.params and os.path.isfile(p1):
            loaded |= self.ckpt.load_agent_optimizer(self.optim, "listener",
                                                     p1)
        return loaded

    def _bootstrap(self, params):
        """(params, resumed) after the JAX package's bootstrap cascade (JAX
        loop.py:42-88; ref AlternatingJointModel.py:131-177).  Alternating:
        the stage-2 speaker, then the `initialize_retrieval` listener, then
        a lenient merge of start_from's model, so a fresh seeded dir keeps
        the seeds and a mid-joint resume keeps the trained listener; with
        continue_from_existing_models off nothing loads.  Not alternating:
        start_from's model first (or, without it, the stage-2 speaker),
        then the listener overlay."""
        opt = self.opt
        stage2 = getattr(opt, "speaker_stage_2_model_path", "") or ""

        def overlay_listener(params):
            ir = getattr(opt, "initialize_retrieval", "") or ""
            if ir and ck.model_exists(ir):
                loaded = ck.load_params(ir, self.device)
                if "listener" in loaded:
                    params = dict(params, listener=loaded["listener"])
            return params

        resumed = False
        if opt.is_alternating:
            if getattr(opt, "continue_from_existing_models", True):
                if stage2 and ck.model_exists(stage2):
                    params = ck.load_params_into(params, stage2)
                params = overlay_listener(params)
                params, resumed = self.ckpt.try_load_model(params)
        else:
            params, resumed = self.ckpt.try_load_model(params)
            if not resumed and stage2 and ck.model_exists(stage2):
                params = ck.load_params_into(params, stage2)
            params = overlay_listener(params)
        return params, resumed

    @property
    def turn(self):
        """The turn of the next iteration (JAX loop.py:413-416)."""
        if not self.opt.is_alternating:
            return "optimizer"
        return self.turns[self.iteration % len(self.turns)]

    # -- schedules -----------------------------------------------------------
    def _update_schedules(self):
        opt, epoch = self.opt, self.epoch
        opt.current_lr = schedules.current_lr(opt, epoch)
        opt.ss_prob = schedules.scheduled_sampling_prob(opt, epoch)
        self._retrieval_w = schedules.retrieval_reward_weight(opt, epoch)
        self._pg, self._pm = schedules.soft_sampling_probs(
            opt, epoch, self.epoch_start)
        self.optim.set_lr(opt.current_lr)

    def _hyper(self):
        return joint.Hyper.from_opt(self.opt)._replace(
            gumbel_temp=float(self.gumbel_temp),
            retrieval_reward_weight=float(self._retrieval_w),
            prob_gumbel_softmax=float(self._pg),
            prob_multinomial_soft=float(self._pm),
            vse_max_w=schedules.vse_max_violation_w(self.opt,
                                                    self.iteration))

    def _cache_rows(self, infos):
        """The feature cache's row of each caption row of a batch: its
        image's index, repeated seq_per_img times (the loader's layout)."""
        return np.repeat(np.asarray([i["ix"] for i in infos], np.int64),
                         self.loader.seq_per_img)

    def _my_rows(self, x):
        """This rank's rows of a global batch's host array (all of them off
        a mesh or on a data axis of 1)."""
        mesh = self.mesh
        if mesh is None or mesh.n_data == 1:
            return x
        b = x.shape[0] // mesh.n_data
        return x[mesh.data_index * b:(mesh.data_index + 1) * b]

    def _gather_cached(self, rows):
        """(fc, att, att_masks) of the cache's `rows` (a tensor on the
        device), att cast back to float32."""
        cache = self._feat_cache
        fc = cache["fc"].index_select(0, rows)
        att = am = None
        if self.opt.use_att and "att" in cache:
            att = cache["att"].index_select(0, rows).to(torch.float32)
            am = cache["att_mask"].index_select(0, rows)
        return fc, att, am

    def _padded_refs(self, gts):
        """(refs [n_img, R, L] int32, ref_mask [n_img, R]) numpy, padded to
        the dataset's largest ref count."""
        return ngram_device.pad_gts_np(gts, max_refs=self._max_refs or None,
                                       seq_length=self.loader.seq_length)

    def _prepare_batch(self, data):
        """Host batch dict -> tensors on the device (labels int64, the rest
        float32): the features from the device cache when there is one,
        and the padded refs of a device reward tier (JAX loop.py:351-378).
        On a mesh the rank's rows of the per-row arrays (and of the cache's
        rows), the refs whole (`mesh.shard_batch`'s rule)."""
        def put(x, dtype, rows=True):
            x = self._my_rows(x) if rows else x
            return torch.from_numpy(np.ascontiguousarray(x)).to(
                self.device, dtype)

        f32 = torch.float32
        batch = {"labels": put(data["labels"], torch.int64),
                 "masks": put(data["masks"], f32),
                 "att_feats": None, "att_masks": None}
        if self._feat_cache is not None and data.get("infos"):
            batch["fc_feats"], batch["att_feats"], batch["att_masks"] = \
                self._gather_cached(put(self._cache_rows(data["infos"]),
                                        torch.int64))
        else:
            batch["fc_feats"] = put(data["fc_feats"], f32)
            if self.opt.use_att and data.get("att_feats") is not None:
                batch["att_feats"] = put(data["att_feats"], f32)
                if data.get("att_masks") is not None:
                    batch["att_masks"] = put(data["att_masks"], f32)
        if joint.needs_device_refs(self.opt) and \
                self.opt.cider_optimization > 0 and data.get("gts"):
            refs, ref_mask = self._padded_refs(data["gts"])
            batch["refs"] = put(refs, torch.int64, rows=False)
            batch["ref_mask"] = put(ref_mask, f32, rows=False)
            if self._df_table is not None:
                batch["df_table"] = self._df_table
        return batch

    def iteration_streams(self):
        """The named streams of the current iteration (joint.streams):
        stage A and stage B each take a fresh set from the same seed (on a
        mesh the global batch's draws, of which a rank keeps its rows)."""
        return joint.streams(self._seed * 1_000_003 + self.iteration,
                             self.device)

    def reward(self, batch, data, hp, turn):
        """Stage A and the host reward: (reward [B] on the device, the
        loss-dict entries avg_reward and cider_greedy, stage A's sampled
        ids) -- JAX loop.py:440-460.  On a mesh stage A samples the rank's
        rows and the reward is its rows of the global batch's."""
        streams = self.iteration_streams()
        rows = None
        if self.mesh is not None:
            streams, rows = row_streams(streams, self.mesh), \
                data_rows(self.mesh)
        gen, greedy = self._sample_fns[turn](self.params, batch, streams, hp)
        reward, avg, cider_greedy = joint.host_reward(
            self.opt, data["gts"], gen, greedy, rows)
        return (torch.from_numpy(reward).to(self.device),
                {"avg_reward": avg, "cider_greedy": cider_greedy}, gen)

    # -- one iteration ---------------------------------------------------------
    def train_iteration(self, data=None):
        opt = self.opt
        turn = self.turn
        if schedules.should_anneal(opt, self.iteration):
            self.gumbel_temp = schedules.anneal_gumbel_temp(
                self.gumbel_temp, opt, self.iteration)
        if opt.softmax_cooling_decay_factor > 0:
            # the partial-sampling probabilities, every iteration (JAX
            # loop.py:422-424)
            self._pg, self._pm = schedules.soft_sampling_probs(
                opt, self.epoch, self.epoch_start)
        if data is None:
            data = self.loader.get_batch("train")
        batch = self._prepare_batch(data)
        hp = self._hyper()
        reward, aux_host, seq_a = None, {}, None
        if joint.needs_reward(opt, turn):
            reward, aux_host, seq_a = self.reward(batch, data, hp, turn)
        # the params before the step, for the audit only (Adam updates in
        # place; nothing is copied when the audit is off)
        audit_on = bool(getattr(opt, "audit_grad_isolation", 0))
        prev = audit.snapshot(self.params) if audit_on else None
        sampled = {}
        if self.mesh is not None:
            # the rank's rows, the gradients summed, the guarded update
            loss, aux = self._mesh_steps[turn](
                self.params, self.optim, batch, self.iteration_streams(), hp,
                reward, sampled)
        else:
            (loss, aux), grads = self._grad_fns[turn](
                self.params, batch, self.iteration_streams(), hp, reward,
                sampled)
            # the non-finite guard runs on the device inside the update
            self.optim.step(self.params, grads, turn)
        self.last_sampled = sampled
        if seq_a is not None:
            self.last_reward_seqs = (seq_a, sampled["seq"])
        # a step the guard rejected leaves every agent unchanged: auditing
        # it would raise a false UpdateError (JAX loop.py:468-479)
        if audit_on and bool(self.optim.last_step_ok):
            audit.audit_update(prev, self.params,
                               tuple(a for a in agents_to_update(opt, turn)
                                     if a in self.params),
                               None if self.mesh is None else self.mesh.world)

        # BN running statistics (torch train-mode BatchNorm1d semantics),
        # once per iteration (JAX loop.py:481-501); on a mesh the global
        # batch's, the same update on every rank
        sp = self.params["speaker"]
        if getattr(opt, "use_bn", 0) and batch["att_feats"] is not None \
                and "att_bn" in sp:
            with torch.no_grad():
                new = att_model.bn_running_update(
                    sp, batch["att_feats"], batch["att_masks"],
                    rows=None if self.mesh is None else data_rows(self.mesh))
                for k in ("mean", "var"):
                    if k in sp["att_bn"]:
                        sp["att_bn"][k].copy_(new["att_bn"][k])

        loss_dict = dict(aux)  # device scalars; converted lazily by loggers
        loss_dict.update(aux_host)
        loss_dict["loss"] = loss
        self.iteration += 1
        if self.iteration % opt.losses_log_every == 0:
            self.loss_history[self.iteration] = loss
            self.lr_history[self.iteration] = opt.current_lr
            self.ss_prob_history[self.iteration] = opt.ss_prob
        if data["bounds"]["wrapped"]:
            self.epoch += 1
            self._update_schedules()
        return loss_dict, turn, data

    # -- fused chunks (JAX loop.py:518-720) ------------------------------------
    def _fused_gate(self):
        """Why a fused chunk cannot run (None = it can), JAX loop.py:525-552:
        each reason is a per-step host interaction a captured iteration
        cannot hold -- the host CIDEr reward, a turn flip per iteration,
        the BN running statistics, the audit, the profiler window -- or a
        missing feature cache."""
        opt = self.opt
        if int(getattr(opt, "fused_steps", 1) or 1) <= 1:
            return "off"
        if opt.is_alternating and len(self.turns) != 1:
            return "reinforce turn alternation changes the step graph " \
                   "per iteration"
        turn = self.turns[0] if opt.is_alternating else "optimizer"
        if joint.needs_reward(opt, turn):
            return "host-side reward stage (use --on_device_cider 1)"
        if getattr(opt, "use_bn", 0):
            return "BN running-stat tracking updates per step on host"
        if getattr(opt, "audit_grad_isolation", 0):
            return "grad-isolation audit host-syncs per step"
        if getattr(opt, "profile_dir", ""):
            return "profiler window needs per-step boundaries"
        if self._feat_cache is None:
            return "requires --device_feature_cache 1 (per-step feature " \
                   "streaming would dominate the fused step)"
        if opt.use_att and "att" not in self._feat_cache:
            return "att features missing from the device cache"
        return None

    def _hyper_row(self, epoch, g_temp, iteration):
        """One step's Hyper values as host floats (field order of
        joint.Hyper), a function of (epoch, g_temp, iteration) alone, as
        _update_schedules and train_iteration compute them (JAX
        loop.py:554-566)."""
        opt = self.opt
        pg, pm = schedules.soft_sampling_probs(opt, epoch, self.epoch_start)
        return (schedules.scheduled_sampling_prob(opt, epoch), g_temp,
                opt.multinomial_temp, pg, pm, opt.caption_loss_weight,
                opt.vse_loss_weight,
                schedules.retrieval_reward_weight(opt, epoch),
                opt.cider_optimization,
                schedules.vse_max_violation_w(opt, iteration))

    def _stage_chunk(self, max_steps):
        """Fetch up to max_steps train batches and every step's schedule
        values on the host (JAX loop.py:568-621), packed one row per step
        (fused.RowLayout).  Stops right after a wrap that reaches
        max_epochs, and before a step whose scheduled sampling switches on
        or off (a captured iteration draws its noise or not)."""
        opt, loader = self.opt, self.loader
        turn = self.turns[0] if opt.is_alternating else "optimizer"
        want_refs = joint.needs_device_refs(opt) and \
            joint._cider_active(opt, turn)
        steps, lrs, ss = [], [], []
        epoch, g_temp, wraps = self.epoch, self.gumbel_temp, 0
        last_data, use_ss = None, None
        for j in range(max_steps):
            it_j = self.iteration + j
            # train_iteration's order: the anneal on the iteration's
            # number, the schedules of the current epoch
            g_next = schedules.anneal_gumbel_temp(g_temp, opt, it_j) \
                if schedules.should_anneal(opt, it_j) else g_temp
            hp = self._hyper_row(epoch, g_next, it_j)
            if use_ss is None:
                use_ss = hp[0] > 0.0
            elif (hp[0] > 0.0) != use_ss:
                break
            g_temp = g_next
            data = loader.get_batch("train")
            last_data = data
            step = {"idx": self._cache_rows(data["infos"]),
                    "labels": data["labels"], "masks": data["masks"],
                    "lr": [schedules.current_lr(opt, epoch)], "hp": hp,
                    "seed": self._seed * 1_000_003 + it_j}
            if want_refs and data.get("gts"):
                step["refs"], step["ref_mask"] = self._padded_refs(
                    data["gts"])
            steps.append(step)
            lrs.append(step["lr"][0])
            ss.append(hp[0])
            if data["bounds"]["wrapped"]:
                epoch += 1
                wraps += 1
                if epoch >= opt.max_epochs != -1:
                    break
        first = steps[0]
        layout = fused.RowLayout(
            [(k, np.shape(first[k])) for k in
             ("idx", "labels", "masks", "lr", "hp", "refs", "ref_mask")
             if k in first])
        rows = np.stack([layout.pack(st) for st in steps])
        return {"n_steps": len(steps), "turn": turn, "wraps": wraps,
                "g_temp": g_temp, "last_data": last_data, "lrs": lrs,
                "ss": ss, "use_ss": use_ss, "layout": layout, "rows": rows,
                "seeds": [st["seed"] for st in steps]}

    def _fused_step(self, turn, use_ss, layout):
        """The captured iteration of (turn, use_ss), made at first use."""
        key = (turn, use_ss)
        step = self._fused.get(key)
        if step is None or step.layout.width != layout.width:
            step = fused.FusedStep(self, turn, use_ss, layout)
            self._fused[key] = step
        return step

    def train_chunk(self, max_steps):
        """Up to max_steps iterations as one fused chunk (JAX
        loop.py:677-720), with the per-step path's semantics: the same
        streams, schedule values, guarded updates (on a mesh the world's
        non-finite flag) and histories cadence.  The staged rows reach the
        device in one copy.  Returns (the last
        step's loss dict, turn, last data, steps run)."""
        opt = self.opt
        st = self._stage_chunk(max_steps)
        K, turn = st["n_steps"], st["turn"]
        rows = torch.from_numpy(st["rows"]).to(self.device)
        layout = st["layout"]
        if self.mesh is not None:
            # every rank staged the same global rows; each keeps its own
            # (the refs and the per-step values whole)
            rows, layout = fused.restack(mesh_mod.shard_batch_stacked(
                layout.unstack(rows), self.mesh))
        runner = self._fused_step(turn, st["use_ss"], layout)
        losses, auxs, oks = runner.run(rows, st["seeds"])
        self.optim.last_step_ok = oks[-1]
        for j in range(K):
            it_j = self.iteration + j + 1
            if it_j % opt.losses_log_every == 0:
                self.loss_history[it_j] = losses[j]
                self.lr_history[it_j] = st["lrs"][j]
                self.ss_prob_history[it_j] = st["ss"][j]
        self.iteration += K
        self.epoch += st["wraps"]
        self.gumbel_temp = st["g_temp"]
        self._update_schedules()
        loss_dict = {k: v[-1] for k, v in auxs.items()}
        loss_dict["loss"] = losses[-1]
        return loss_dict, turn, st["last_data"], K

    def _chunk_size(self, max_iterations):
        """The next chunk's steps: fused_steps, cut at the next checkpoint
        and at max_iterations; 1 before a forced first checkpoint (JAX
        loop.py:817-850)."""
        opt = self.opt
        chunk = min(int(opt.fused_steps), opt.save_checkpoint_every -
                    (self.iteration % opt.save_checkpoint_every))
        if max_iterations is not None:
            chunk = min(chunk, max_iterations - self.iteration)
        if opt.start_with_checkpoint:
            chunk = 1
        return max(1, chunk)

    # -- checkpoint ops (ref train.py:438-470) --------------------------------
    def evaluator(self):
        """The evaluator of checkpoint_operations; it gathers val and test
        features from the device cache too (it covers every image)."""
        if self._evaluator is None:
            from cooperativeimagecaptioning_tpu_torch.evaluation.eval_split \
                import Evaluator
            self._evaluator = Evaluator(self.opt, mesh=self.mesh,
                                        feat_cache=self._feat_cache,
                                        device=self.device)
            if self._feat_cache is not None:
                for split in ("val", "test"):
                    self.loader.set_feature_free(split)
        return self._evaluator

    def saved_state(self):
        """(params, optimizer) as a single-device run holds them: on a mesh
        the ranks' slices gathered over the model group (a collective: every
        rank calls it)."""
        if self.mesh is None:
            return self.params, self.optim
        params = mesh_mod.gather_params(self.params, self.mesh,
                                        self.param_specs)
        optim = copy.copy(self.optim)
        optim.states = mesh_mod.gather_states(
            self.optim.states, self.optim.paths, self.mesh, self.param_specs)
        return params, optim

    def checkpoint_operations(self):
        """Evaluate on val, then write the run dir: model (latest and this
        iteration's), optimizer, infos, histories, and the -best files when
        the score improved (JAX loop.py:721-790).  On a mesh every rank
        evaluates its share and gathers the slices, and global rank 0
        writes."""
        opt = self.opt
        eval_kwargs = {"split": "val", "dataset": opt.input_json}
        eval_kwargs.update(vars(opt))
        val_loss, predictions, lang_stats = self.evaluator().eval_split(
            self.params, self.loader, eval_kwargs,
            use_gen_sent=opt.rank_on_gen_captions)
        self.val_result_history[self.iteration] = {
            "loss": val_loss, "lang_stats": lang_stats,
            "predictions": predictions}
        skipped = self.optim.skipped_steps()
        if skipped:
            print(f"warning: non-finite guard skipped {skipped} update steps")
        self.val_result_history[self.iteration]["skipped_steps"] = skipped

        current_score, current_score_vse = self._current_scores(
            lang_stats, val_loss)
        best_flag = self.best_val_score is None or \
            current_score > self.best_val_score
        if best_flag:
            self.best_val_score = current_score
        best_flag_vse = self.best_val_score_vse is None or \
            current_score_vse > self.best_val_score_vse
        if best_flag_vse:
            self.best_val_score_vse = current_score_vse

        params, optim = self.saved_state()
        writer = self.mesh is None or self.mesh.rank == 0
        if writer:
            self.ckpt.save_model(params, self.iteration)
            self.ckpt.save_optimizers(optim)
        infos = self.infos
        res_it, res_six = self.loader.resume_state()
        infos.update({"iter": self.iteration, "epoch": self.epoch,
                      "iterators": res_it, "split_ix": res_six,
                      "best_val_score": self.best_val_score,
                      "best_val_score_vse": self.best_val_score_vse,
                      "opt": self.opt, "vocab": self.loader.get_vocab(),
                      "gumbel_temp": self.gumbel_temp})
        # device scalars accumulated by train_iteration -> host floats once
        self.loss_history = {k: float(v) for k, v in self.loss_history.items()}
        histories = self.histories
        histories.update({"val_result_history": self.val_result_history,
                          "loss_history": self.loss_history,
                          "lr_history": self.lr_history,
                          "ss_prob_history": self.ss_prob_history})
        if writer:
            self.ckpt.save_infos(infos, self.iteration)
            self.ckpt.save_histories(histories)
            if best_flag:
                self.ckpt.save_best(params)
                self.ckpt.save_best_infos(infos)
            if best_flag_vse:
                self.ckpt.save_best(params, vse=True)
                self.ckpt.save_best_infos(infos, vse=True)
        if self.mesh is not None:
            # no rank reads the run dir before rank 0 has written it
            collectives.barrier(self.mesh.world)
        return val_loss, lang_stats

    def _current_scores(self, lang_stats, val_loss):
        """ref train.py:262-282."""
        opt = self.opt
        if opt.language_eval == 1:
            if opt.phase == 1:
                current = lang_stats.get("val", {}).get("CIDEr", 0)
            else:
                current = lang_stats.get("CIDEr", 0)
        else:
            current = 0 if opt.phase == 1 else -val_loss.get("loss_cap", 0.0)
        crit = opt.vse_eval_criterion
        if crit in val_loss:
            vse_score = val_loss[crit] * 100
        elif isinstance(val_loss.get("val"), dict):
            vse_score = val_loss["val"].get(crit, 0) * 100  # phase-1 nesting
        else:
            vse_score = 0
        return current, vse_score

    def close(self):
        """Stop the loader's prefetch thread, deregister the vocab mesh
        this Trainer installed (JAX loop.py:380-394): left registered, it
        would route later single-device heads to the sharded path; and wait
        for the run dir's pending `.orbax` write."""
        closer = getattr(self.loader, "close", None)
        if closer is not None:
            closer()
        vm = _dispatch.vocab_mesh()
        if self.mesh is not None and vm is not None and vm[0] is self.mesh:
            _dispatch.set_vocab_mesh(None)
        # the pending `.orbax` write commits (its error is raised here)
        self.ckpt.sync()

    # -- full loop (ref: train.py:473-562) --------------------------------------
    def train(self, max_iterations=None):
        """Iterations until max_iterations or max_epochs, checkpointing
        every save_checkpoint_every; with fused_steps > 1 and nothing in
        the way (`_fused_gate`) in chunks that never cross a checkpoint,
        max_iterations or max_epochs.  With profile_dir, the iterations
        [profile_start, profile_start + profile_steps) run inside a
        torch.profiler trace, each under a 'train_iteration N' range; the
        trace opens and closes at iteration boundaries (JAX
        loop.py:817-850), and closes where the loop ends early.  The path
        of the last trace written: `self.last_trace`."""
        opt = self.opt
        profile_dir = getattr(opt, "profile_dir", "")
        window, stop_at = None, None
        gate = self._fused_gate()
        if gate not in (None, "off") and self.verbose and \
                self._fused_notice != gate:
            print(f"fused_steps={opt.fused_steps} requested but falling back "
                  f"to per-step execution: {gate}")
            self._fused_notice = gate
        try:
            while True:
                if profile_dir and window is None and \
                        self.iteration == opt.profile_start:
                    window = profiling.Trace(profile_dir).start()
                    stop_at = self.iteration + opt.profile_steps
                start = time.time()
                region = contextlib.nullcontext() if window is None else \
                    profiling.annotate(f"train_iteration {self.iteration}")
                with region:
                    if gate is None:
                        loss_dict, turn, _, n_steps = self.train_chunk(
                            self._chunk_size(max_iterations))
                    else:
                        loss_dict, turn, _ = self.train_iteration()
                        n_steps = 1
                if window is not None and self.iteration >= stop_at:
                    self.last_trace = window.stop()
                    window = None
                if self.verbose:
                    # one host sync per chunk, from its last step
                    dur = time.time() - start
                    msg = " ".join(f"{k} = {round(float(v), 2)}"
                                   for k, v in sorted(loss_dict.items()))
                    span = f"iter {self.iteration}" if n_steps == 1 else \
                        f"iter {self.iteration - n_steps + 1}-" \
                        f"{self.iteration}"
                    print(f"{span} (epoch {self.epoch}) [{turn}] {msg} "
                          f"time/batch = {dur / n_steps:.2f}s")
                if self.iteration % opt.save_checkpoint_every == 0 or \
                        opt.start_with_checkpoint:
                    self.checkpoint_operations()
                    opt.start_with_checkpoint = 0
                if max_iterations is not None and \
                        self.iteration >= max_iterations:
                    break
                if self.epoch >= opt.max_epochs != -1:
                    if self.verbose:
                        print("Finished training")
                    break
        finally:
            if window is not None:
                self.last_trace = window.stop()
        self.close()
        return self.params


def train(opt, dataset=None, max_iterations=None, device="cuda",
          verbose=True):
    """Top-level entry (JAX loop.py:874-878; ref train.py:473)."""
    trainer = Trainer(opt, dataset=dataset, device=device, verbose=verbose)
    trainer.train(max_iterations=max_iterations)
    return trainer
