"""Training driver, the phase-2 subset (counterpart of the JAX package's
training/loop.py; ref train.py).

One iteration = schedules -> batch (host numpy -> device tensors) -> loss
and gradients (`joint.value_and_grad`) -> guarded per-agent Adam -> the BN
running statistics -> loss history.  Ported: phase-2 MLE training of the
speaker (`phase=2`, `vse_model="None"`, non-alternating), the speaker's own
stage (run_att.sh).  The device is explicit (`device=`), and every random
draw of training (dropout, scheduled sampling) comes from one
torch.Generator on that device, seeded from `opt.seed`.

Not ported yet, each raising NotImplementedError that names its ROADMAP.md
queue-1 item: the device mesh, fused multi-step chunks (`fused_steps > 1`),
the device feature cache, alternating turns and the rewards, resuming
(`start_from`), and `checkpoint_operations` (eval, checkpoints and
histories on disk).  A run in this slice therefore keeps
`save_checkpoint_every` above its iteration count.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cooperativeimagecaptioning_tpu_torch import config as config_mod
from cooperativeimagecaptioning_tpu_torch.data import DataLoader
from cooperativeimagecaptioning_tpu_torch.models import att_model
from cooperativeimagecaptioning_tpu_torch.training import joint, schedules
from cooperativeimagecaptioning_tpu_torch.training.optim import (
    OptimizerManager, effective_turns)
from cooperativeimagecaptioning_tpu_torch.utils.tree import trainable

_JOINT = "ROADMAP.md queue 1: joint training"


def unported(opt):
    """Why this port cannot train `opt` yet (None = it can)."""
    if int(getattr(opt, "mesh_data_axis", 0) or 0) > 1 or \
            int(getattr(opt, "mesh_model_axis", 1) or 1) > 1:
        return "a device mesh (ROADMAP.md queue 1: multi-device)"
    if int(getattr(opt, "fused_steps", 1) or 1) > 1:
        return f"fused_steps > 1 (a CUDA graph of K steps; {_JOINT})"
    if getattr(opt, "device_feature_cache", 0):
        return f"device_feature_cache ({_JOINT})"
    if opt.is_alternating:
        return f"alternating turns ({_JOINT})"
    if opt.cider_optimization > 0 or (opt.retrieval_reward_weight > 0 and
                                      joint.has_listener(opt)):
        return f"rewards (CIDEr-D, DISC; {_JOINT})"
    if joint.has_listener(opt):
        return (f"vse_model {opt.vse_model!r} (ROADMAP.md queue 1: the "
                f"listener and retrieval)")
    if getattr(opt, "start_from", None) or \
            getattr(opt, "speaker_stage_2_model_path", ""):
        return f"resuming or seeding from a checkpoint ({_JOINT})"
    if getattr(opt, "start_with_checkpoint", 0):
        return f"checkpoint_operations ({_JOINT})"
    if getattr(opt, "audit_grad_isolation", 0) or \
            getattr(opt, "profile_dir", ""):
        return f"audit_grad_isolation / profile_dir ({_JOINT})"
    return None


class Trainer:
    """Phase-2 MLE training of the speaker on one device."""

    def __init__(self, opt, dataset=None, rng_seed=None, verbose=True,
                 device="cuda"):
        why = unported(opt)
        if why:
            raise NotImplementedError(f"Trainer: not ported yet: {why}")
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

        seed = rng_seed if rng_seed is not None else getattr(opt, "seed", 123)
        params = joint.init_params(seed, opt, self.device)
        self.params = {agent: trainable(tree)
                       for agent, tree in params.items()}
        self.optim = OptimizerManager(opt, self.params)
        self.turns = effective_turns(opt)

        self.iteration = 0
        self.epoch = 0
        self.epoch_start = 0
        self.gumbel_temp = opt.gumbel_temp
        self.loss_history = {}
        self.lr_history = {}
        self.ss_prob_history = {}
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed + 1)
        self._grad_fn = joint.value_and_grad(opt, "optimizer")
        self._update_schedules()

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

    def _prepare_batch(self, data):
        """Host batch dict -> tensors on the device (labels int64, the rest
        float32)."""
        def put(x, dtype):
            return torch.from_numpy(np.ascontiguousarray(x)).to(
                self.device, dtype)

        f32 = torch.float32
        batch = {"fc_feats": put(data["fc_feats"], f32),
                 "labels": put(data["labels"], torch.int64),
                 "masks": put(data["masks"], f32),
                 "att_feats": None, "att_masks": None}
        if self.opt.use_att and data.get("att_feats") is not None:
            batch["att_feats"] = put(data["att_feats"], f32)
            if data.get("att_masks") is not None:
                batch["att_masks"] = put(data["att_masks"], f32)
        return batch

    # -- one iteration ---------------------------------------------------------
    def train_iteration(self, data=None):
        opt = self.opt
        turn = "optimizer"
        if schedules.should_anneal(opt, self.iteration):
            self.gumbel_temp = schedules.anneal_gumbel_temp(
                self.gumbel_temp, opt, self.iteration)
        if data is None:
            data = self.loader.get_batch("train")
        batch = self._prepare_batch(data)
        (loss, aux), grads = self._grad_fn(self.params, batch, self.gen,
                                           self._hyper())
        # the non-finite guard runs on the device inside the update
        self.optim.step(self.params, grads, turn)

        # BN running statistics (torch train-mode BatchNorm1d semantics),
        # once per iteration (JAX loop.py:481-501)
        sp = self.params["speaker"]
        if getattr(opt, "use_bn", 0) and batch["att_feats"] is not None \
                and "att_bn" in sp:
            with torch.no_grad():
                new = att_model.bn_running_update(
                    sp, batch["att_feats"], batch["att_masks"])
                for k in ("mean", "var"):
                    if k in sp["att_bn"]:
                        sp["att_bn"][k].copy_(new["att_bn"][k])

        loss_dict = dict(aux)  # device scalars; converted lazily by loggers
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

    def checkpoint_operations(self):
        raise NotImplementedError(
            f"checkpoint_operations (eval_split, checkpoints and histories "
            f"on disk) is not ported yet ({_JOINT}; ROADMAP.md queue 1: "
            f"eval_split): keep save_checkpoint_every above the iterations "
            f"of a run")

    def close(self):
        closer = getattr(self.loader, "close", None)
        if closer is not None:
            closer()

    # -- full loop (ref: train.py:473-562) --------------------------------------
    def train(self, max_iterations=None):
        opt = self.opt
        while True:
            start = time.time()
            loss_dict, turn, _ = self.train_iteration()
            if self.verbose:
                dur = time.time() - start
                msg = " ".join(f"{k} = {round(float(v), 2)}"
                               for k, v in sorted(loss_dict.items()))
                print(f"iter {self.iteration} (epoch {self.epoch}) [{turn}] "
                      f"{msg} time/batch = {dur:.2f}s")
            if self.iteration % opt.save_checkpoint_every == 0:
                self.checkpoint_operations()
            if max_iterations is not None and \
                    self.iteration >= max_iterations:
                break
            if self.epoch >= opt.max_epochs != -1:
                if self.verbose:
                    print("Finished training")
                break
        self.close()
        return self.params


def train(opt, dataset=None, max_iterations=None, device="cuda",
          verbose=True):
    """Top-level entry (JAX loop.py:874-878; ref train.py:473)."""
    trainer = Trainer(opt, dataset=dataset, device=device, verbose=verbose)
    trainer.train(max_iterations=max_iterations)
    return trainer
