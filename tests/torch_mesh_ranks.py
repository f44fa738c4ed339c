"""Rank functions of the port's mesh tests (tests/test_torch_parallel.py,
test_torch_sharded_heads.py, test_torch_trainer_mesh.py,
test_torch_hostcopies.py).

`parallel.launch.spawn` runs them in new processes, each one rank of a
process group over gloo on the CPU.  Such a process imports this module
and nothing of JAX: the tests compute the JAX side in their own process
and pass numpy arrays in; the ranks return numpy arrays and numbers.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from cooperativeimagecaptioning_tpu_torch.config import Options
from cooperativeimagecaptioning_tpu_torch.data import SyntheticDataset
from cooperativeimagecaptioning_tpu_torch.ops import draws
from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
    _dispatch, beam_head, logit_head)
from cooperativeimagecaptioning_tpu_torch.parallel import (
    collectives, make_mesh)
from cooperativeimagecaptioning_tpu_torch.parallel import mesh as M
from cooperativeimagecaptioning_tpu_torch.parallel.train_step import (
    make_distributed_train_step, row_streams)
from cooperativeimagecaptioning_tpu_torch.training import joint
from cooperativeimagecaptioning_tpu_torch.training.optim import (
    OptimizerManager)
from cooperativeimagecaptioning_tpu_torch.utils.tree import (
    leaves, to_numpy, to_torch, trainable)


def tiny_opt(**kw):
    """The phase-2 options of the mesh tests: rnn 32, as the JAX mesh tests'
    small widths."""
    base = dict(
        caption_model="att2in2", vse_model="None", phase=2, batch_size=4,
        seq_per_img=1, rnn_size=32, input_encoding_size=12, att_hid_size=8,
        fc_feat_size=20, att_feat_size=20, drop_prob_lm=0.5,
        learning_rate=1e-3, grad_clip=0.1, save_checkpoint_every=10_000,
        losses_log_every=1, language_eval=0, max_epochs=-1,
        cached_tokens="corpus", vocab_size=25, seq_length=8,
        prefetch_batches=0)
    base.update(kw)
    return Options(**base)


def tiny_dataset(opt):
    return SyntheticDataset(num_images=24, vocab_size=opt.vocab_size,
                            seq_length=8, fc_feat_size=opt.fc_feat_size,
                            att_feat_size=opt.att_feat_size, max_K=6)


def port_batch(data):
    return {"fc_feats": torch.from_numpy(data["fc_feats"]),
            "att_feats": torch.from_numpy(data["att_feats"]),
            "att_masks": torch.from_numpy(data["att_masks"]),
            "labels": torch.from_numpy(data["labels"]).long(),
            "masks": torch.from_numpy(data["masks"])}


def replay_streams(noise):
    """The named streams with the 'xe' stream replaying `noise`."""
    out = {name: draws.Replay([]) for name in joint.STREAMS}
    out["xe"] = draws.Replay(noise)
    return out


# ---------------------------------------------------------------------------
# test_torch_parallel.py
# ---------------------------------------------------------------------------

def functions_rank():
    """The two autograd Functions on a model group of 2, and the params'
    replicate / shard / gather round trip."""
    mesh = make_mesh(1, 2, "cpu")
    r = mesh.model_index
    x = torch.full((3,), float(r + 1), requires_grad=True)
    c = torch.tensor([1.0, 2.0, 3.0]) * (r + 1)
    (collectives.copy_to_group(x, mesh.model) * c).sum().backward()
    copy_grad = x.grad.numpy().copy()
    x.grad = None
    z = collectives.reduce_from_group(x * c, mesh.model)
    d = torch.tensor([1.0, -1.0, 0.5])
    (z * d).sum().backward()
    out = {"copy_grad": copy_grad, "reduce_value": z.detach().numpy(),
           "reduce_grad": x.grad.numpy().copy()}
    opt = tiny_opt(vocab_size=25)
    params = joint.init_params(mesh.rank, opt)  # differs between ranks
    M.replicate(params, mesh)
    specs = M.param_specs(params, mesh)
    local = M.shard_params(params, mesh, specs)
    out["local_logit_w"] = local["speaker"]["logit"]["w"].numpy()
    out["contiguous"] = all(x.is_contiguous() for _, x in leaves(local))
    out["gathered"] = to_numpy(M.gather_params(local, mesh, specs))
    out["replicated"] = to_numpy(params)
    return out


def step_rank(cases):
    """For each case (mesh shape, options, whole params, numpy batch, the
    'xe' noise): the distributed loss, its gradients (summed over the data
    group, the slices gathered) and the params after one step of
    `make_distributed_train_step` from the same params."""
    out = {}
    for key, (shape, opt_kw, params_np, data, noise) in cases.items():
        opt = tiny_opt(**opt_kw)
        hp = joint.Hyper.from_opt(opt)
        batch = port_batch(data)
        mesh = make_mesh(*shape, "cpu")
        _dispatch.set_vocab_mesh(mesh, opt.vocab_size)
        full = to_torch(params_np, "cpu")
        specs = M.param_specs(full, mesh)
        local = trainable(M.shard_params(full, mesh, specs))
        rows = mesh.data if mesh.n_data > 1 else None
        fn = joint.value_and_grad(opt, "optimizer", rows=rows)
        (loss, _), grads = fn(local, M.shard_batch(batch, mesh),
                              row_streams(replay_streams(noise), mesh), hp)
        grads = collectives.all_reduce_tree(grads, mesh.data)
        if rows is not None:
            loss = collectives.all_reduce(loss, rows)
        local2 = trainable(M.shard_params(full, mesh, specs))
        optim = OptimizerManager(opt, local2, mesh.world)
        step = make_distributed_train_step(opt, "optimizer", mesh)
        loss2, aux2 = step(local2, optim, batch, replay_streams(noise), hp)
        out[key] = {
            "loss": float(loss), "step_loss": float(loss2),
            "loss_cap": float(aux2["loss_cap"]),
            "grads": to_numpy(M.gather_params(grads, mesh, specs)),
            "params": to_numpy(M.gather_params(local2, mesh, specs)),
            "count": int(optim.states["speaker"]["count"]),
            "ok": bool(optim.last_step_ok),
            "sharded": sorted(k for k, v in specs.items() if v is not None)}
        _dispatch.set_vocab_mesh(None)
    return out


def fail_on_rank_one():
    """Rank 1 raises; rank 0 waits for it in a barrier."""
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise ValueError("planted")
    dist.barrier()
    return dist.get_rank()


# ---------------------------------------------------------------------------
# test_torch_sharded_heads.py
# ---------------------------------------------------------------------------

def heads_rank(h, w, b, ms):
    """The sharded heads of a (1, 2) mesh on this rank's slice of (w, b),
    through the dispatchers; and which path the dispatchers take with and
    without the mesh registered."""
    mesh = make_mesh(1, 2, "cpu")
    V1 = w.shape[1]
    vl = V1 // 2
    j = mesh.model_index
    h, w, b = (torch.from_numpy(x) for x in (h, w, b))
    wl = w[:, j * vl:(j + 1) * vl].contiguous()
    bl = b[j * vl:(j + 1) * vl].contiguous()
    calls = []
    real = beam_head.beam_head_sharded

    def spy(*args):
        calls.append(args[3])
        return real(*args)

    beam_head.beam_head_sharded = spy
    out = {"beam": {}, "calls": {}}
    try:
        _dispatch.set_vocab_mesh(mesh, V1 - 1)
        for m in ms:
            vals, idx, lse = beam_head.beam_head(h, wl, bl, m)
            out["beam"][m] = (vals.numpy(), idx.numpy(), lse.numpy())
        it, lp = logit_head.greedy_head(h, wl, bl)
        out["greedy"] = (it.numpy(), lp.numpy())
        out["calls"]["registered"] = list(calls)
        # a replicated (whole) logit layer keeps the local path
        beam_head.beam_head(h, w, b, 2)
        logit_head.greedy_head(h, w, b)
        out["calls"]["whole"] = list(calls)
        _dispatch.set_vocab_mesh(None)
        beam_head.beam_head(h, wl, bl, 2)
        logit_head.greedy_head(h, wl, bl)
        out["calls"]["cleared"] = list(calls)
    finally:
        beam_head.beam_head_sharded = real
        _dispatch.set_vocab_mesh(None)
    return out


# ---------------------------------------------------------------------------
# test_torch_trainer_mesh.py
# ---------------------------------------------------------------------------

def trainer_state(tr):
    params, optim = tr.saved_state()
    return {"params": to_numpy(params), "states": to_numpy(optim.states),
            "iteration": tr.iteration}


def train_mesh(opt_kw, shape, n, write):
    """A mesh Trainer over the tiny dataset: `n` iterations (losses), then
    checkpoint_operations when `write`; its state, the slices gathered."""
    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    opt = tiny_opt(mesh_data_axis=shape[0], mesh_model_axis=shape[1],
                   **opt_kw)
    tr = Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                 verbose=False)
    assert tr.mesh is not None and tr.mesh.shape == {"data": shape[0],
                                                     "model": shape[1]}
    losses = [float(tr.train_iteration()[0]["loss"]) for _ in range(n)]
    if write:
        tr.checkpoint_operations()
    out = dict(trainer_state(tr), losses=losses,
               vocab_registered=_dispatch.vocab_mesh() is not None)
    tr.close()
    out["vocab_cleared"] = _dispatch.vocab_mesh() is None
    return out


def evaluate_mesh(run_dir, shape, vocab_size):
    """Evaluator.eval_split of a run dir's speaker on a mesh, greedy and beam
    2 -> {beam: (captions by image id, loss_cap)}."""
    from cooperativeimagecaptioning_tpu_torch import config, data
    from cooperativeimagecaptioning_tpu_torch.evaluation.eval_split import (
        Evaluator)
    from cooperativeimagecaptioning_tpu_torch.training import checkpoint
    mesh = make_mesh(*shape, "cpu")
    opt = config.load_infos(os.path.join(run_dir, "infos_t.pkl"))["opt"]
    loader = data.DataLoader(opt, dataset=tiny_dataset(opt))
    params = checkpoint.load_params(os.path.join(run_dir, "model.pth"))
    params = M.shard_params(params, mesh, M.param_specs(params, mesh))
    ev = Evaluator(opt, mesh=mesh, device="cpu")
    out = {}
    for beam in (1, 2):
        losses, preds, _ = ev.eval_split(
            params, loader, {"split": "val", "beam_size": beam,
                             "language_eval": 0, "num_images": -1})
        out[beam] = ({p["image_id"]: p["caption"] for p in preds},
                     losses["loss_cap"])
    _dispatch.set_vocab_mesh(None)
    return out


def mesh_runs_rank(mesh_dir, dirs):
    """The two-rank world of test_torch_trainer_mesh.py: a (2, 1) Trainer of
    three iterations at drop_prob_lm 0.5 writing `mesh_dir`; then for each
    single-device run dir in `dirs` ({vocabulary: dir}, and 'jax': a run
    dir of the JAX package at vocabulary 25) a (1, 2) Trainer resuming it,
    and for the port's a (1, 2) Evaluator on it."""
    out = {"train": train_mesh({"checkpoint_path": mesh_dir}, (2, 1), 3,
                               True), "resumed": {}, "eval": {}}
    for key, d in dirs.items():
        V = 25 if key == "jax" else key
        out["resumed"][key] = train_mesh(
            {"checkpoint_path": d + "_resumed", "start_from": d,
             "vocab_size": V, "id": "t"}, (1, 2), 0, False)
        if key != "jax":
            out["eval"][key] = evaluate_mesh(d, (1, 2), V)
    return out


# ---------------------------------------------------------------------------
# test_torch_hostcopies.py
# ---------------------------------------------------------------------------

def clean_rank(code, run_dir):
    """Run `code` (with `d` the run dir) in this rank, then report the
    modules of JAX or of the JAX package that the rank holds."""
    exec(code, {"d": run_dir, "os": os, "np": np})
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib",
                                         "cooperativeimagecaptioning_tpu"))
