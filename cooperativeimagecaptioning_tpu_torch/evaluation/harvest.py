"""Post-training results harvesting (the port's counterpart of the JAX
package's evaluation/harvest.py; ref: plots_general_curve.py).

Scans a run directory's histories for the best checkpoint per selection criterion
(val CIDEr / BLEU-4 / t2i-R@10, ref :289-332), prunes all non-best per-iteration
model files (ref remove_unnecessary_models :18-41), re-evaluates the selected
checkpoints on the test split (ref eval_test :387-456), and writes:
  <run>/val_dict.pkl, <run>/test_dict.pkl, <json_dir>/<run>.json

Also a standalone multi-run CLI (the reference file doubles as one:
read_models_to_plot :61-83, model_doesnt_need_update caching :85-94,
main :493-535):

  python -m cooperativeimagecaptioning_tpu_torch.evaluation.harvest --dir runs/gumbel

harvests every run directory under --dir (or a single run dir), with
val_dict.pkl caching unless --force_new_dict 1.

The test re-evaluation runs the port's `eval.eval` on the card unless
`device="cpu"` (`--device`).  Infos and histories pickles of either package
are read through `config.load_infos` (a JAX-written infos pickles that
package's Options).  Pruning deletes a pruned iteration's `.orbax` directory
as the JAX package does; nothing here reads one.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import traceback

import numpy as np

from cooperativeimagecaptioning_tpu_torch import config

CRITERIA = ("cider", "bleu4", "t2i_r10")


def _histories_path(run_dir, run_id):
    p = os.path.join(run_dir, f"histories_{run_id}.pkl")
    if os.path.isfile(p):
        return p
    cands = [f for f in os.listdir(run_dir) if f.startswith("histories_")
             and f.endswith(".pkl")]
    if not cands:
        raise FileNotFoundError(
            f"no histories_*.pkl in {run_dir} — the run never reached a "
            f"checkpoint (save_checkpoint_every iterations)")
    assert len(cands) == 1, f"ambiguous histories files in {run_dir}: {cands}"
    return os.path.join(run_dir, cands[0])


def create_model_metrics(run_dir, run_id=""):
    """Best iteration per criterion from the val history (ref :289-332)."""
    history = config.load_infos(_histories_path(run_dir, run_id))
    metrics = {"iteration": [], "cider_score": [], "bleu4": [], "t2i_r10": []}
    seen = {"cider_score": False, "bleu4": False, "t2i_r10": False}
    for it in sorted(history["val_result_history"].keys()):
        rec = history["val_result_history"][it]
        lang = rec.get("lang_stats") or {}
        loss = rec.get("loss") or {}
        metrics["iteration"].append(it)
        metrics["cider_score"].append(lang.get("CIDEr", 0.0))
        metrics["bleu4"].append(lang.get("Bleu_4", 0.0))
        metrics["t2i_r10"].append(loss.get("t2i_r10", 0.0))
        seen["cider_score"] |= "CIDEr" in lang
        seen["bleu4"] |= "Bleu_4" in lang
        seen["t2i_r10"] |= "t2i_r10" in (loss if isinstance(loss, dict)
                                         else {})
    # A criterion whose metric NEVER appeared (language_eval/rank_eval off)
    # must not select a "best" checkpoint — argmax over all-default zeros
    # would pick iteration[0] and remove_unnecessary_models would then
    # delete the genuinely best checkpoints (the reference KeyErrors here,
    # plots_general_curve.py:304-307; we skip the criterion and keep going).
    crit_key = {"cider": "cider_score", "bleu4": "bleu4",
                "t2i_r10": "t2i_r10"}
    best = {crit: int(np.argmax(metrics[key]))
            for crit, key in crit_key.items() if seen[key]}
    for crit, key in crit_key.items():
        if not seen[key]:
            print(f"harvest: no {key} values in the val history — skipping "
                  f"the '{crit}' selection criterion")
    metrics["best_iteration_by"] = best
    metrics["test_models"] = {
        crit: metrics["iteration"][idx] for crit, idx in best.items()}
    return metrics


def remove_unnecessary_models(metrics, run_dir):
    """Delete per-iteration model files not selected by any criterion
    (ref :18-41)."""
    keep = set(metrics["test_models"].values())
    if not keep:
        # no criterion had data (fresh run with eval disabled): deleting
        # "everything but the best" would delete everything
        print("harvest: no selection criteria available — keeping all "
              "per-iteration checkpoints")
        return {}
    for fname in os.listdir(run_dir):
        if not _is_iter_model(fname):
            continue
        it = fname[fname.find("-") + 1: fname.find(".")]
        try:
            if int(it) not in keep:
                path = os.path.join(run_dir, fname)
                if os.path.isdir(path):  # orbax artifacts are directories
                    import shutil
                    shutil.rmtree(path)
                else:
                    os.remove(path)
        except ValueError:
            continue
    return metrics["test_models"]


def eval_test(opt, metrics, run_dir, run_id="", listener=None, split="test",
              ann_file=None, only_recall=0, dataset=None, device="cuda"):
    """Re-evaluate selected checkpoints on a split (ref :387-456)."""
    from cooperativeimagecaptioning_tpu_torch import eval as eval_mod
    test_dict = {}
    iter_done = {}
    kind = "alternatingModel" if getattr(opt, "is_alternating", 0) else "model"
    for crit, iteration in metrics["test_models"].items():
        if only_recall and crit in ("cider", "bleu4"):
            continue
        if iteration in iter_done:
            test_dict[crit] = test_dict[iter_done[iteration]]
            continue
        model_name = os.path.join(run_dir, f"{kind}-{iteration}.pth")
        infos_name = os.path.join(run_dir, f"infos_{run_id}.pkl")
        test_dict[crit] = eval_mod.eval(opt, model_name, infos_name, ann_file,
                                        listener, split, str(iteration),
                                        dataset=dataset, device=device)
        iter_done[iteration] = crit
    return test_dict


def create_json(run_dir, run_id, val_metrics, test_dict, opt=None,
                json_dir=None):
    """Consolidated per-run metrics json keyed by selection criterion
    (ref create_json :96-287)."""
    if json_dir is None:
        json_dir = os.path.join(os.path.dirname(os.path.abspath(run_dir)),
                                "json_dir")
    os.makedirs(json_dir, exist_ok=True)
    out = {"full_path": os.path.abspath(run_dir),
           "best_iteration_by": val_metrics["test_models"], "val": {}, "test": {}}
    for crit, idx in val_metrics["best_iteration_by"].items():
        out["val"][crit] = {
            "iteration": val_metrics["iteration"][idx],
            "cider": val_metrics["cider_score"][idx],
            "bleu4": val_metrics["bleu4"][idx],
            "t2i_r10": val_metrics["t2i_r10"][idx]}
    for crit, result in (test_dict or {}).items():
        out["test"][crit] = {
            "lang_stats": result.get("lang_stats"),
            "loss": {k: v for k, v in result.get("loss", {}).items()
                     if isinstance(v, (int, float))}}
    if opt is not None:
        out["opt"] = {k: v for k, v in vars(opt).items()
                      if isinstance(v, (int, float, str, bool, list,
                                        type(None)))}
    name = os.path.basename(os.path.normpath(run_dir))
    path = os.path.join(json_dir, f"{name}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(f"json file was created for {name}")
    return path


def create_dicts_and_json_after_training(opt, dataset=None, ann_file=None,
                                         run_test_eval=True, json_dir=None,
                                         device="cuda"):
    """ref :459-475 — val/test dict pkls + json report after a joint run."""
    run_dir = opt.checkpoint_path if not isinstance(opt, str) else opt
    run_id = getattr(opt, "id", "") if not isinstance(opt, str) else ""
    try:
        metrics = create_model_metrics(run_dir, run_id)
    except FileNotFoundError as e:
        print(f"results harvesting skipped: {e}")
        return None
    remove_unnecessary_models(metrics, run_dir)
    with open(os.path.join(run_dir, "val_dict.pkl"), "wb") as f:
        pickle.dump(metrics, f)
    test_dict = {}
    if run_test_eval and not isinstance(opt, str):
        try:
            test_dict = eval_test(opt, metrics, run_dir, run_id,
                                  ann_file=ann_file, dataset=dataset,
                                  device=device)
        except (FileNotFoundError, OSError) as e:
            # missing checkpoints/data: harvesting must not kill a finished
            # run, but anything else is a real eval bug — re-raise it
            print(f"test re-evaluation skipped: {e}")
            traceback.print_exc()
    with open(os.path.join(run_dir, "test_dict.pkl"), "wb") as f:
        pickle.dump(test_dict, f)
    return create_json(run_dir, run_id, metrics, test_dict,
                       opt if not isinstance(opt, str) else None,
                       json_dir=json_dir)


# ---------------------------------------------------------------------------
# Standalone multi-run CLI (ref: plots_general_curve.py as a tool)
# ---------------------------------------------------------------------------

def _is_run_dir(path):
    try:
        return any(f.startswith("histories_") and f.endswith(".pkl")
                   for f in os.listdir(path))
    except NotADirectoryError:
        return False


def _is_iter_model(fname):
    """Per-iteration model artifact: <kind>-<iter>.pth or the orbax-backend
    <kind>-<iter>.orbax directory."""
    return ((fname.startswith("alternatingModel-") or
             (fname.startswith("model-") and len(fname) > 6 and
              fname[6].isdigit())) and
            (fname.endswith(".pth") or fname.endswith(".orbax")))


def _count_iter_models(run_dir):
    return sum(1 for f in os.listdir(run_dir) if _is_iter_model(f))


def run_needs_update(run_dir, force_new_dict=False, min_models_in_dir=5):
    """val_dict.pkl caching (ref model_doesnt_need_update :85-94): a run whose
    dict exists and whose per-iteration checkpoint count hasn't grown past
    min_models_in_dir is up to date."""
    if force_new_dict:
        return True
    if "val_dict.pkl" not in os.listdir(run_dir):
        return True
    return _count_iter_models(run_dir) > min_models_in_dir


def discover_runs(parent, blacklist=(), skip_substrings=()):
    """Run directories under `parent` (ref read_models_to_plot :61-83; the
    reference's hard-coded 'BS50'/'E50' skips become --skip substrings)."""
    if _is_run_dir(parent):
        return [parent]
    runs = []
    for d in sorted(os.listdir(parent)):
        p = os.path.join(parent, d)
        if not os.path.isdir(p) or d in blacklist:
            continue
        if any(s in d for s in skip_substrings):
            continue
        if _is_run_dir(p):
            runs.append(p)
    return runs


def _opt_from_infos(run_dir):
    """Recover the run's Options from its infos pickle so standalone test
    re-eval can run (the reference reads opt back the same way)."""
    cands = [f for f in os.listdir(run_dir)
             if f.startswith("infos_") and f.endswith(".pkl")
             and "best" not in f and not f.startswith("infos_vse")]
    if not cands:
        return None
    # the plain infos_<id>.pkl is the shortest (per-iter files add "-<iter>")
    f = min(cands, key=len)
    return config.load_infos(os.path.join(run_dir, f)).get("opt")


def harvest_runs(parent, force_new_dict=False, min_models_in_dir=5,
                 blacklist=(), skip_substrings=(), test_eval=False,
                 json_dir=None, dataset=None, device="cuda"):
    """Harvest every run under `parent` (ref main :493-535).  Returns
    {run_dir: json_path_or_None (skipped/cached)}."""
    results = {}
    for run_dir in discover_runs(parent, blacklist, skip_substrings):
        name = os.path.basename(os.path.normpath(run_dir))
        if not run_needs_update(run_dir, force_new_dict, min_models_in_dir):
            print(f"[{name}] up to date (val_dict.pkl cached)")
            results[run_dir] = None
            continue
        print(f"Start working on [{name}]")
        target = run_dir
        if test_eval:
            opt = _opt_from_infos(run_dir)
            if opt is not None:
                opt.checkpoint_path = run_dir
                target = opt
        results[run_dir] = create_dicts_and_json_after_training(
            target, dataset=dataset, run_test_eval=test_eval,
            json_dir=json_dir, device=device)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Standalone results harvesting over one or many run dirs "
                    "(ref: plots_general_curve.py main)")
    ap.add_argument("--dir", required=True,
                    help="a run dir, or a parent dir of run dirs")
    ap.add_argument("--force_new_dict", type=int, default=0,
                    help="rebuild val_dict.pkl even if cached")
    ap.add_argument("--min_models_in_dir", type=int, default=5,
                    help="cache threshold: more per-iter checkpoints than "
                         "this forces a refresh")
    ap.add_argument("--test_eval", type=int, default=0,
                    help="re-evaluate selected checkpoints on the test split "
                         "(needs the run's dataset on disk)")
    ap.add_argument("--json_dir", type=str, default=None)
    ap.add_argument("--blacklist", nargs="*", default=[])
    ap.add_argument("--skip", nargs="*", default=[],
                    help="skip run dirs containing any of these substrings")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the test re-evaluation (cuda, or "
                         "cpu)")
    args = ap.parse_args(argv)
    results = harvest_runs(
        args.dir, force_new_dict=bool(args.force_new_dict),
        min_models_in_dir=args.min_models_in_dir,
        blacklist=tuple(args.blacklist), skip_substrings=tuple(args.skip),
        test_eval=bool(args.test_eval), json_dir=args.json_dir,
        device=args.device)
    done = sum(1 for v in results.values() if v)
    print(f"harvested {done}/{len(results)} runs")
    return results


if __name__ == "__main__":
    main()
