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
        loss2, aux2 = step(local2, optim, M.shard_batch(batch, mesh),
                           replay_streams(noise), hp)
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
    through the dispatchers, each call's collectives as
    `collectives.Recording` notes them (and those of `vocab.argmax` over
    the slices of h @ w + b); and which path the dispatchers take with and
    without the mesh registered."""
    from cooperativeimagecaptioning_tpu_torch.parallel import vocab
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

    def recorded(fn, *args):
        with collectives.planned(collectives.Recording()) as rec:
            got = fn(*args)
        return got, rec.ops

    beam_head.beam_head_sharded = spy
    out = {"beam": {}, "calls": {}, "ops": {}}
    try:
        _dispatch.set_vocab_mesh(mesh, V1 - 1)
        for m in ms:
            (vals, idx, lse), out["ops"][m] = recorded(beam_head.beam_head,
                                                       h, wl, bl, m)
            out["beam"][m] = (vals.numpy(), idx.numpy(), lse.numpy())
        (it, lp), out["ops"]["greedy"] = recorded(logit_head.greedy_head,
                                                  h, wl, bl)
        out["greedy"] = (it.numpy(), lp.numpy())
        ids, out["ops"]["argmax"] = recorded(vocab.argmax, h @ wl + bl)
        out["argmax"] = ids.numpy()
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


def orbax_mesh_rank(run_dir):
    """test_torch_orbax_tier.py: a (2, 1) Trainer under checkpoint_backend
    'orbax' (one iteration, checkpoint_operations: rank 0 writes), then a
    (2, 1) Trainer resuming the run dir -> (saved state, resumed state)."""
    kw = {"checkpoint_path": run_dir, "checkpoint_backend": "orbax"}
    saved = train_mesh(kw, (2, 1), 1, True)
    resumed = train_mesh(dict(kw, start_from=run_dir), (2, 1), 0, False)
    return saved, resumed


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



# ---------------------------------------------------------------------------
# test_torch_mesh_vocab.py
# ---------------------------------------------------------------------------

def to_batch(arrays):
    """A numpy batch dict -> tensors (labels int64; None kept)."""
    out = {}
    for k, v in arrays.items():
        if v is None:
            out[k] = None
        else:
            x = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = x.long() if k == "labels" else x
    return out


def replays(noise):
    """{stream: Replay of its arrays} from {stream: [arrays]}; streams not
    given replay nothing."""
    out = {name: draws.Replay([]) for name in joint.STREAMS}
    out.update({k: draws.Replay(v) for k, v in noise.items()})
    return out


def cols(x, mesh):
    """This rank's model slice of the last dim of a whole numpy array."""
    n = x.shape[-1] // mesh.n_model
    j = mesh.model_index
    return torch.from_numpy(np.ascontiguousarray(x[..., j * n:(j + 1) * n]))


def my_rows(x, mesh):
    """This rank's data share of the leading dim."""
    b = x.shape[0] // mesh.n_data
    return x[mesh.data_index * b:(mesh.data_index + 1) * b]


def soft_share(x, mesh):
    """This rank's share of whole relaxed rows [.., V+2] on a logit split:
    its slice of the V+1 logit columns, the last rank's with the BOS
    column."""
    n = (x.shape[-1] - 1) // mesh.n_model
    j = mesh.model_index
    end = (j + 1) * n + (1 if j == mesh.n_model - 1 else 0)
    return torch.from_numpy(np.ascontiguousarray(x[..., j * n:end]))


def whole_cols(x, mesh):
    """The model group's slices of x's last dim, concatenated (numpy)."""
    return collectives.all_gather(x.detach().contiguous(), mesh.model,
                                  -1).numpy()


def whole_soft(soft, mesh):
    """Whole relaxed rows from the model group's shares (the last rank's
    holds one column more): each padded to one width, gathered, unpadded."""
    last = mesh.model_index == mesh.n_model - 1
    pad = soft if last else torch.cat(
        [soft, soft.new_zeros(soft.shape[:-1] + (1,))], -1)
    w = pad.shape[-1]
    parts = collectives.all_gather(pad.detach().contiguous(), mesh.model, -1)
    chunks = [parts[..., j * w:(j + 1) * w] for j in range(mesh.n_model)]
    return torch.cat([c[..., :-1] for c in chunks[:-1]] + [chunks[-1]],
                     -1).numpy()


def whole_rows(x, mesh):
    """The data group's shares of x's leading dim, concatenated."""
    x = x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    return collectives.all_gather(x.contiguous(), mesh.data, 0) \
        if mesh.n_data > 1 else x


def vocab_world_rank(shape, jobs, cases):
    """One world of tests/test_torch_mesh_vocab.py on a mesh of `shape`:
    `_vocab_units` of each job {key: (V, units)}, and `_sample_cases`."""
    mesh = make_mesh(*shape, "cpu")
    return ({k: _vocab_units(mesh, V, u) for k, (V, u) in jobs.items()},
            _sample_cases(mesh, cases))


def _vocab_units(mesh, V, units):
    """The building blocks of a mesh of `shape` on inputs given whole
    (tests/test_torch_mesh_vocab.py): the autograd all_gather and the id
    gather over the data group; over the model group's slices of a
    vocabulary of V words: `vocab.argmax`, `softmax` (and its gradient),
    `one_hot`, `add_at`, the four relaxations (forward, ids, gradient of
    <y, c>), `soft_embed` with either operand split, the BOS row and
    column; the contrastive loss of the data group (both branches and a
    blended weight, values and gradients); soft CIDEr of the rank's rows
    and vocabulary share.  Returns every result whole."""
    from cooperativeimagecaptioning_tpu_torch.models import vse
    from cooperativeimagecaptioning_tpu_torch.ops import relaxations
    from cooperativeimagecaptioning_tpu_torch.parallel import vocab
    from cooperativeimagecaptioning_tpu_torch.rewards import cider_diff
    _dispatch.set_vocab_mesh(mesh, V)
    split = mesh.n_model > 1 and (V + 1) % mesh.n_model == 0
    out = {}
    u = units.get("gather")
    if u is not None:
        x = my_rows(torch.from_numpy(u["x"]), mesh).clone().requires_grad_()
        y = collectives.gather_from_group(x, mesh.data)
        (y * torch.from_numpy(u["c"][mesh.data_index])).sum().backward()
        ids = collectives.all_gather(my_rows(torch.from_numpy(u["ids"]),
                                             mesh), mesh.data)
        out["gather"] = (y.detach().numpy(), whole_rows(x.grad, mesh).numpy(),
                         ids.numpy(), str(ids.dtype))
    u = units.get("argmax")
    if u is not None:
        out["argmax"] = vocab.argmax(cols(u, mesh)).numpy()
    u = units.get("softmax")
    if u is not None:
        x = cols(u["x"], mesh).requires_grad_()
        y = vocab.softmax(x)
        (y * cols(u["c"], mesh)).sum().backward()
        ids = torch.from_numpy(u["ids"])
        out["softmax"] = (whole_cols(y, mesh), whole_cols(x.grad, mesh),
                          whole_cols(vocab.one_hot(ids, x), mesh),
                          whole_cols(vocab.add_at(x.detach(), ids, -1e38),
                                     mesh))
    u = units.get("relax")
    if u is not None:
        got = {}
        for name, (lp, noise, args, c) in u.items():
            x = cols(lp, mesh).requires_grad_()
            src = draws.Replay([cols(noise[0], mesh)] + list(noise[1:]))
            y, ind = getattr(relaxations, name)(src, x, *args)
            (y * cols(c, mesh)).sum().backward()
            got[name] = (whole_cols(y, mesh), ind.numpy(),
                         whole_cols(x.grad, mesh), src.done())
        out["relax"] = got
    u = units.get("soft_embed")
    if u is not None:
        soft = torch.from_numpy(u["soft"])
        table = torch.from_numpy(u["table"])
        if split:
            soft = soft_share(u["soft"], mesh)
        elif mesh.n_model > 1:
            table = M.shard_params({"embed": table}, mesh, {
                "embed": 0})["embed"]
        soft = soft.clone().requires_grad_()
        table = table.clone().requires_grad_()
        y = vocab.soft_embed(soft, table)
        (y * torch.from_numpy(u["c"])).sum().backward()
        out["soft_embed"] = {
            "y": y.detach().numpy(),
            "soft_grad": whole_soft(soft.grad, mesh) if split
            else soft.grad.numpy(),
            "table_grad": table.grad.numpy() if split or mesh.n_model == 1
            else collectives.all_gather(table.grad, mesh.model, 0).numpy(),
            "bos_row": (whole_soft(vocab.one_hot_row(V + 1, soft.detach())[
                None], mesh) if split
                else vocab.one_hot_row(V + 1, soft.detach())[None].numpy()),
            "dropped": (whole_cols(vocab.drop_bos_column(soft.detach()),
                                   mesh) if split else
                        vocab.drop_bos_column(soft.detach()).numpy())}
    u = units.get("contrastive")
    if u is not None:
        got = {}
        for key, mv in u["weights"].items():
            im = my_rows(torch.from_numpy(u["im"]), mesh).clone() \
                .requires_grad_()
            s = my_rows(torch.from_numpy(u["s"]), mesh).clone() \
                .requires_grad_()
            w = mv if isinstance(mv, (int, float)) else torch.tensor(mv[0])
            per = vse.contrastive_loss(im, s, 0.2, w, True, rows=mesh.data)
            loss = vse.contrastive_loss(im, s, 0.2, w, rows=mesh.data)
            loss.backward()
            got[key] = (float(collectives.all_reduce(loss.detach(),
                                                     mesh.data)),
                        whole_rows(per, mesh).numpy(),
                        whole_rows(im.grad, mesh).numpy(),
                        whole_rows(s.grad, mesh).numpy())
        out["contrastive"] = got
    u = units.get("soft_cider")
    if u is not None:
        soft = u["soft"]
        rows = mesh.data if mesh.n_data > 1 else None
        soft = my_rows(soft, mesh)
        soft = (soft_share(soft, mesh) if split else
                torch.from_numpy(np.ascontiguousarray(soft))).requires_grad_()
        loss = cider_diff.soft_cider_loss(
            soft, torch.from_numpy(u["refs"]), torch.from_numpy(u["mask"]),
            rows)
        total = loss.detach() if rows is None else \
            collectives.all_reduce(loss.detach(), rows)
        loss.backward()
        g = soft.grad
        g = torch.from_numpy(whole_soft(g, mesh)) if split else g
        out["soft_cider"] = (float(total), whole_rows(g, mesh).numpy())
    _dispatch.set_vocab_mesh(None)
    return out


def _sample_cases(mesh, cases):
    """`decoding.sample` on a mesh whose model axis splits the
    speaker's vocabulary (the logit layer at V=25, the embedding at V=24):
    each case {V, params (a whole speaker tree), att, masks, noise (the
    whole batch's draws), L, kw, grad_w} -> ids, log-probs and soft rows
    gathered whole; with grad_w the value of sum(logprobs) + <soft,
    grad_w> and every leaf's gradient (slices gathered).  A 'tf' case runs
    teacher forcing with scheduled sampling instead: its log-probs, whole.
    Draws are this rank's rows and columns of the global ones."""
    from cooperativeimagecaptioning_tpu_torch.models import att_model
    from cooperativeimagecaptioning_tpu_torch.ops import decoding
    from cooperativeimagecaptioning_tpu_torch.parallel import vocab
    out = {}
    for key, case in cases.items():
        _dispatch.set_vocab_mesh(mesh, case["V"])
        full = {"speaker": to_torch(case["params"], "cpu")}
        specs = M.param_specs(full, mesh)
        tree = M.shard_params(full, mesh, specs)
        if case.get("grad_w") is not None:
            tree = trainable(tree)
        spk = att_model.AttModel(tree["speaker"])
        att = my_rows(torch.from_numpy(case["att"]), mesh)
        masks = my_rows(torch.from_numpy(case["masks"]), mesh)
        rec = draws.Replay(case["noise"])
        src = rec if mesh.n_data == 1 else draws.RowShard(
            rec, mesh.n_data, mesh.data_index)
        ctx = spk.encode_features(None, att, masks)
        kw = dict(case["kw"])
        if "tf" in case:
            with torch.no_grad():
                lp = decoding.teacher_forced_logprobs(
                    spk, ctx, my_rows(torch.from_numpy(case["tf"]), mesh),
                    src, **kw)
            lp = torch.from_numpy(whole_cols(lp, mesh)) \
                if vocab.logit_mesh(lp) is not None else lp
            out[key] = {"lp": whole_rows(lp, mesh).numpy(),
                        "used_all": rec.done()}
            continue
        grad_w = case.get("grad_w")
        with torch.set_grad_enabled(grad_w is not None):
            o = decoding.sample(spk, ctx, case["L"], src, **kw)
        soft = o.soft
        res = {"used_all": rec.done()}
        if grad_w is not None:
            loss = o.logprobs.sum()
            if soft is not None:
                w = soft_share(grad_w, mesh) if vocab.soft_slice(soft) \
                    is not None else torch.from_numpy(grad_w)
                part = (soft * w).sum()
                loss = loss + (collectives.reduce_from_group(part, mesh.model)
                               if vocab.soft_slice(soft) is not None
                               else part)
            named = leaves(tree)
            grads = torch.autograd.grad(loss, [x for _, x in named],
                                        allow_unused=True)
            grads = from_leaves_zeros(named, grads)
            grads = collectives.all_reduce_tree(grads, mesh.data)
            res["value"] = float(collectives.all_reduce(
                loss.detach(), mesh.data)) if mesh.n_data > 1 \
                else float(loss)
            res["grads"] = to_numpy(M.gather_params(grads, mesh, specs))
        if soft is not None:
            soft = torch.from_numpy(whole_soft(soft, mesh)) \
                if vocab.soft_slice(soft) is not None else soft.detach()
            soft = whole_rows(soft, mesh).numpy()
        res.update(seq=whole_rows(o.seq, mesh).numpy(),
                   lp=whole_rows(o.logprobs, mesh).numpy(), soft=soft)
        out[key] = res
    _dispatch.set_vocab_mesh(None)
    return out


def from_leaves_zeros(named, grads):
    """A gradient tree from (path, leaf) pairs and their gradients, zeros
    where a leaf took none."""
    from cooperativeimagecaptioning_tpu_torch.utils.tree import from_leaves
    return from_leaves((k, torch.zeros_like(x) if g is None else g)
                       for (k, x), g in zip(named, grads))


# ---------------------------------------------------------------------------
# test_torch_mesh_phase3.py (and test_torch_trainer_mesh.py's configurations)
# ---------------------------------------------------------------------------

def mesh_loss_cases(mesh, cases):
    """joint.value_and_grad of each case {key: {opt, turn, params (whole
    numpy tree), batch (whole numpy dict), noise ({stream: the global
    draws}), reward (whole, or None)}} on this rank's mesh: the loss and
    aux summed over the data group, the gradients summed over it and the
    slices gathered, the sampled ids gathered."""
    from cooperativeimagecaptioning_tpu_torch.parallel.train_step import (
        data_rows, global_sums)
    from cooperativeimagecaptioning_tpu_torch.rewards import self_critical
    out = {}
    for key, case in cases.items():
        opt = case["opt"]
        self_critical.reset_scorer()
        self_critical.init_scorer("corpus")
        _dispatch.set_vocab_mesh(mesh, opt.vocab_size)
        full = to_torch(case["params"], "cpu")
        specs = M.param_specs(full, mesh)
        local = trainable(M.shard_params(full, mesh, specs))
        batch = M.shard_batch(to_batch(case["batch"]), mesh)
        reward = case.get("reward")
        if reward is not None:
            reward = torch.from_numpy(my_rows(reward, mesh))
        sampled = {}
        fn = joint.value_and_grad(opt, case["turn"], rows=data_rows(mesh))
        (loss, aux), grads = fn(local, batch, row_streams(
            replays(case["noise"]), mesh), joint.Hyper.from_opt(opt), reward,
            sampled)
        grads = collectives.all_reduce_tree(grads, mesh.data)
        loss, aux = global_sums(loss, aux, mesh)
        out[key] = {"loss": float(loss),
                    "aux": {k: float(v) for k, v in aux.items()},
                    "grads": to_numpy(M.gather_params(grads, mesh, specs)),
                    "sampled": {k: whole_rows(v, mesh).numpy()
                                for k, v in sampled.items()}}
        _dispatch.set_vocab_mesh(None)
    return out


def mesh_trainer_cases(shape, cases):
    """Each case {key: (opt, {iteration: {stream: the global draws}},
    steps)}: a mesh Trainer of `shape` over tiny_dataset(opt), its
    iterations drawing the given noise -> the loss dict of each step, the
    turns, and the state (slices gathered) after them."""
    import copy
    from cooperativeimagecaptioning_tpu_torch.rewards import self_critical
    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    out = {}
    for key, (opt, noise, steps) in cases.items():
        self_critical.reset_scorer()
        opt = copy.deepcopy(opt)
        opt.mesh_data_axis, opt.mesh_model_axis = shape
        tr = Trainer(opt, dataset=tiny_dataset(opt), device="cpu",
                     verbose=False)
        tr.iteration_streams = lambda: replays(noise[tr.iteration])
        losses, turns = [], []
        for _ in range(steps):
            loss_dict, turn, _ = tr.train_iteration()
            losses.append({k: float(v) for k, v in loss_dict.items()})
            turns.append(turn)
        out[key] = dict(trainer_state(tr), losses=losses, turns=turns)
        tr.close()
    return out


def mesh_evaluations(mesh, cases):
    """Evaluator.eval_split of each case {key: (opt, params (whole),
    eval_kwargs)} on this rank's mesh over tiny_dataset(opt) -> (losses,
    captions by image id)."""
    from cooperativeimagecaptioning_tpu_torch import data
    from cooperativeimagecaptioning_tpu_torch.evaluation.eval_split import (
        Evaluator)
    from cooperativeimagecaptioning_tpu_torch.rewards import self_critical
    out = {}
    for key, (opt, params, ek) in cases.items():
        self_critical.reset_scorer()
        loader = data.DataLoader(opt, dataset=tiny_dataset(opt))
        full = to_torch(params, "cpu")
        local = M.shard_params(full, mesh, M.param_specs(full, mesh))
        ev = Evaluator(opt, mesh=mesh, device="cpu")
        losses, preds, _ = ev.eval_split(local, loader, dict(ek))
        out[key] = (losses, {p["image_id"]: p["caption"] for p in preds})
        _dispatch.set_vocab_mesh(None)
    return out


def mesh_audited_window(shape, opt, trace_dir):
    """`Trainer.train` of `opt` on a mesh of `shape` for two iterations
    under the grad-isolation audit, the profiler window over both: (the
    turns' agents' Adam counts, the trace this rank wrote, or None)."""
    import copy
    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    opt = copy.deepcopy(opt)
    opt.mesh_data_axis, opt.mesh_model_axis = shape
    opt.audit_grad_isolation = 1
    opt.profile_dir = os.path.join(trace_dir, f"rank{dist_rank()}")
    opt.profile_start, opt.profile_steps = 0, 2
    tr = Trainer(opt, dataset=tiny_dataset(opt), device="cpu", verbose=False)
    tr.train(max_iterations=2)
    counts = {a: int(st["count"]) for a, st in tr.optim.states.items()}
    return counts, tr.last_trace


def dist_rank():
    import torch.distributed as dist
    return dist.get_rank()


def phase3_world_rank(shape, loss_cases, trainer_cases, eval_cases,
                      window=None):
    """One world of tests/test_torch_mesh_phase3.py (or of
    test_torch_trainer_mesh.py's configurations) on a mesh of `shape`;
    `window`: (opt, trace dir) of `mesh_audited_window`."""
    mesh = make_mesh(*shape, "cpu")
    out = {"loss": mesh_loss_cases(mesh, loss_cases),
           "eval": mesh_evaluations(mesh, eval_cases),
           "trainer": mesh_trainer_cases(shape, trainer_cases)}
    if window is not None:
        out["window"] = mesh_audited_window(shape, *window)
    return out


# ---------------------------------------------------------------------------
# test_torch_evaluation.py
# ---------------------------------------------------------------------------

def eval_replayed_rank(shape, opt, params, ek, noise, dataset):
    """Evaluator.eval_split on a mesh of `shape` whose EVAL_SEED streams
    replay `noise` ({stream: the global batch's draws}, each rank keeping
    its rows) -> (losses, predictions, language stats)."""
    from cooperativeimagecaptioning_tpu_torch import data
    from cooperativeimagecaptioning_tpu_torch.evaluation.eval_split import (
        Evaluator)
    from cooperativeimagecaptioning_tpu_torch.rewards import self_critical
    mesh = make_mesh(*shape, "cpu")
    joint.streams = lambda seed, device, gens=None: replays(noise)
    self_critical.reset_scorer()
    loader = data.DataLoader(opt, dataset=dataset)
    full = to_torch(params, "cpu")
    local = M.shard_params(full, mesh, M.param_specs(full, mesh))
    out = Evaluator(opt, mesh=mesh, device="cpu").eval_split(local, loader,
                                                             dict(ek))
    _dispatch.set_vocab_mesh(None)
    return out


# ---------------------------------------------------------------------------
# test_torch_mesh_fused.py (and the fused / host-reward cases of
# test_torch_fused_steps.py and test_torch_training.py)
# ---------------------------------------------------------------------------

def self_critical_reset():
    """The port's process-wide CIDEr-D scorer, fresh."""
    from cooperativeimagecaptioning_tpu_torch.rewards import self_critical
    self_critical.reset_scorer()


def fused_run(opt, steps, noise=None, nan_image=False, record=False,
              device="cpu"):
    """A mesh Trainer of `opt` (its mesh axes set) through `Trainer.train`
    for `steps` iterations: fused chunks where `opt.fused_steps` > 1 and
    the gate lets them, else per step.  `noise`: {stream seed: {stream:
    the global draws}} replayed in place of the iterations' streams;
    `nan_image`: a NaN planted in the feature cache's first train image
    (its steps are skipped); `record`: one more iteration (a chunk of one
    where fused) under `collectives.Recording`.  Returns the histories,
    counters, gathered state, the recorded collectives, the launches of
    the run and, fused, the captured steps' segments, collectives, replays
    and launches a replay."""
    import copy
    from cooperativeimagecaptioning_tpu_torch.rewards import self_critical
    from cooperativeimagecaptioning_tpu_torch.training import loop
    opt = copy.deepcopy(opt)
    self_critical.reset_scorer()
    real = joint.streams
    if noise is not None:
        joint.streams = lambda seed, device, gens=None: replays(noise[seed])
    try:
        tr = loop.Trainer(opt, dataset=tiny_dataset(opt), device=device,
                          verbose=False)
        if nan_image:
            first = tr.loader.split_ix["train"][0]
            tr._feat_cache["att"][first, 0, 0] = float("nan")
        _dispatch.reset_launches()
        tr.train(max_iterations=steps)
        steps_run = list(tr._fused.values())
        out = dict(trainer_state(tr), gate=tr._fused_gate(),
                   launches=_dispatch.launches(),
                   segments=[f.segments for f in steps_run],
                   collectives=[f.collectives for f in steps_run],
                   replays=sum(f.replays for f in steps_run),
                   per_replay=steps_run[0].launches if steps_run else None,
                   fused=bool(tr._fused), epoch=tr.epoch,
                   losses={k: float(v) for k, v in tr.loss_history.items()},
                   lrs=dict(tr.lr_history), ss=dict(tr.ss_prob_history),
                   skipped=tr.optim.skipped_steps(),
                   checkpoints=sorted(tr.val_result_history),
                   last_ok=bool(tr.optim.last_step_ok))
        if record:
            # train() closed the Trainer, clearing its vocab mesh
            _dispatch.set_vocab_mesh(tr.mesh, opt.vocab_size)
            rec = collectives.Recording()
            with collectives.planned(rec):
                if tr._fused:
                    tr.train_chunk(1)
                else:
                    tr.train_iteration()
            out["recorded"] = rec.ops
        tr.close()
    finally:
        joint.streams = real
    return out


def fused_world_rank(shape, cases, device="cpu"):
    """One world of tests/test_torch_mesh_fused.py: `fused_run` of each case
    {key: (opt, steps, noise, nan_image, record)} on a mesh of `shape`
    (None: the mesh its options name)."""
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for key, (opt, steps, noise, nan_image, record) in cases.items():
        if shape is not None:
            opt = opt.replace(mesh_data_axis=shape[0],
                              mesh_model_axis=shape[1])
        out[key] = fused_run(opt, steps, noise, nan_image, record, device)
    return out


# ---------------------------------------------------------------------------
# test_torch_mesh_hosts.py: ranks as hosts, started with torchrun's
# environment
# ---------------------------------------------------------------------------

def host_process(env, cwd, fn_name, args, results):
    """A process that stands for one host of a torchrun world: torchrun's
    environment `env`, its own working directory `cwd`; it joins the world
    through `launch.run` and puts (rank, ok, result or traceback) on
    `results`."""
    import traceback
    os.environ.update(env)
    os.chdir(cwd)
    torch.set_num_threads(1)
    try:
        from cooperativeimagecaptioning_tpu_torch.parallel import launch
        out = launch.run(globals()[fn_name], args, 0, "cpu")
        results.put((int(env["RANK"]), True, out))
    except BaseException:  # reported to the test, which raises it
        results.put((int(env["RANK"]), False, traceback.format_exc()))


def run_hosts(tmp, fn_name, args, n=2, timeout=300.0):
    """fn(*args) in `n` processes standing for n hosts of one torchrun
    world (each its own directory under `tmp`) -> (results by rank, the
    host directories)."""
    import multiprocessing as mp
    import queue
    from cooperativeimagecaptioning_tpu_torch.parallel import launch
    port = launch.free_init_method().rsplit(":", 1)[1]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    dirs, procs = [], []
    for r in range(n):
        d = os.path.join(str(tmp), f"host{r}")
        os.makedirs(d, exist_ok=True)
        dirs.append(d)
        env = {"RANK": str(r), "WORLD_SIZE": str(n), "LOCAL_RANK": "0",
               "LOCAL_WORLD_SIZE": "1", "GROUP_RANK": str(r),
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port}
        procs.append(ctx.Process(target=host_process,
                                 args=(env, d, fn_name, args, results)))
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < n:
            try:
                rank, ok, out = results.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"hosts still running after {timeout} s")
            if not ok:
                raise RuntimeError(f"host rank {rank} failed:\n{out}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    return [got[r] for r in range(n)], dirs


def two_hosts_rank(opt, steps):
    """A rank on its own host: `steps` (2, 1) iterations of `opt` writing
    the relative run dir 'run', then a Trainer resuming it for one more
    iteration and `eval.eval` of it (global rank 0 reads the run dir and
    sends it)."""
    import torch.distributed as dist
    from cooperativeimagecaptioning_tpu_torch import eval as eval_entry
    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    out = {"backend": dist.get_backend(), "cwd": os.getcwd()}
    tr = Trainer(opt.replace(checkpoint_path="run", id="t"),
                 dataset=tiny_dataset(opt), device="cpu", verbose=False)
    out["gate"] = tr._fused_gate()
    tr.train(max_iterations=steps)
    out["losses"] = [float(tr.loss_history[i]) for i in range(1, steps + 1)]
    tr.checkpoint_operations()
    out["trained"] = trainer_state(tr)
    tr.close()
    tr = Trainer(opt.replace(checkpoint_path="run_resumed", start_from="run",
                             id="t"),
                 dataset=tiny_dataset(opt), device="cpu", verbose=False)
    out["resumed"] = trainer_state(tr)
    out["resumed_loss"] = float(tr.train_iteration()[0]["loss"])
    tr.close()
    got = eval_entry.eval(None, os.path.join("run", "model.pth"),
                          os.path.join("run", "infos_t.pkl"), split="val",
                          dataset=tiny_dataset(opt), device="cpu")
    out["eval"] = ({p["image_id"]: p["caption"]
                    for p in got["split_predictions"]},
                   got["loss"]["loss_cap"])
    _dispatch.set_vocab_mesh(None)
    return out
