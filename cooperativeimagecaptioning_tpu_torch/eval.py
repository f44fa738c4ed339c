"""Standalone evaluation entry point of the port (mirrors the repository's
eval.py; ref: eval.py).

eval(opt, model_name, infos_name, ann_file, listener, split, iteration):
rebuild the joint model at a specific checkpoint, optionally swap in a
ground-truth listener (listener="gt": the `initialize_retrieval` listener),
and run eval_split under the final-eval protocol (beam 2) with
generated-caption ranking, on the card unless `device="cpu"`.  A run dir
written by either package loads (config.load_infos).

A run whose options name a mesh (`mesh_data_axis`, `mesh_model_axis`: a
mesh run dir) is evaluated on that process grid: called outside a rank,
`eval` starts the ranks itself (or joins torchrun's) and returns rank 0's
result; each rank loads the whole checkpoint and keeps its slices."""

from __future__ import annotations

import numpy as np
import torch.distributed as dist

from cooperativeimagecaptioning_tpu_torch import config
from cooperativeimagecaptioning_tpu_torch.data import DataLoader
from cooperativeimagecaptioning_tpu_torch.evaluation.eval_split import Evaluator
from cooperativeimagecaptioning_tpu_torch.parallel import launch
from cooperativeimagecaptioning_tpu_torch.parallel import mesh as mesh_mod
from cooperativeimagecaptioning_tpu_torch.training import checkpoint as ck
from cooperativeimagecaptioning_tpu_torch.training import joint


def eval(opt, model_name, infos_name, ann_file=None, listener=None,
         split="test", iteration=None, dataset=None, device="cuda"):
    """ref: eval.py:20-91."""
    infos = config.load_infos(infos_name)
    if not hasattr(opt, "att_hid_size") or opt is None:
        opt = infos["opt"]
    shape = mesh_mod.mesh_shape(opt, device)
    if shape is not None and not dist.is_initialized():
        return launch.run(eval, (opt, model_name, infos_name, ann_file,
                                 listener, split, iteration, dataset, device),
                          shape[0] * shape[1], device)
    opt.split = split
    opt.beam_size = 2          # final-eval protocol (ref: eval.py:33)
    np.random.seed(123)        # determinism pin (ref: eval.py:34)

    saved = infos.get("opt")
    if saved is not None:
        if not getattr(opt, "input_fc_dir", ""):
            opt.input_fc_dir = saved.input_fc_dir
            opt.input_att_dir = saved.input_att_dir
            opt.input_label_h5 = saved.input_label_h5
        if not getattr(opt, "input_json", ""):
            opt.input_json = saved.input_json
        if not opt.batch_size:
            opt.batch_size = saved.batch_size
        if not opt.id:
            opt.id = saved.id
    opt.cider_optimization = 0  # (ref: eval.py:68)

    loader = DataLoader(opt, dataset=dataset)
    opt.vocab_size = loader.vocab_size
    opt.seq_length = loader.seq_length

    mesh = None if shape is None else mesh_mod.make_mesh(*shape, device)
    if mesh is not None:
        device = mesh.device
    ev = Evaluator(opt, mesh=mesh, device=device)
    params = joint.init_params(getattr(opt, "seed", 123), opt, device)
    params = ck.load_params_into(params, model_name)
    if listener == "gt" and getattr(opt, "initialize_retrieval", None):
        gt = ck.load_params(opt.initialize_retrieval, device)
        if "listener" in gt:
            params["listener"] = gt["listener"]
            print("gt listener is loaded for evaluation")
        else:
            print(f"warning: {opt.initialize_retrieval} has no 'listener' "
                  "subtree; evaluating with the TRAINED listener")

    if mesh is not None:
        mesh_mod.replicate(params, mesh)
        params = mesh_mod.shard_params(params, mesh,
                                       mesh_mod.param_specs(params, mesh))
    eval_kwargs = dict(vars(opt))
    eval_kwargs["split"] = split
    loss, split_predictions, lang_stats = ev.eval_split(
        params, loader, eval_kwargs, ann_file=ann_file, use_gen_sent=True)
    return {"loss": loss, "split_predictions": split_predictions,
            "lang_stats": lang_stats}


if __name__ == "__main__":
    raise SystemExit("use eval.eval(...) programmatically, as the reference does")
