"""language_eval: predictions -> corpus language metrics + eval_results artifacts
(ref: eval_utils.py:19-86).

Filters predictions to annotated image ids, writes eval_results/<id>_<split>.json
and the _nofilt variant, returns the overall metric dict.  The port's own copy
of the JAX package's evaluation/language_eval.py."""

from __future__ import annotations

import json
import os

from cooperativeimagecaptioning_tpu_torch.evaluation.coco_eval import (
    CocoAnnotations, CocoEvalCap)


def annotations_from_loader(loader):
    """Build an in-memory annotation set from a loader's GT labels — used when no
    captions_val2014.json-style annFile is available (synthetic / unit tests)."""
    anns, images = [], []
    aid = 0
    for split in ("val", "test"):
        for ix in loader.split_ix[split]:
            img_id = loader.ds.info["images"][ix]["id"]
            images.append({"id": img_id})
            for row in loader.ds.get_refs(ix):
                sent = " ".join(loader.ix_to_word[str(int(t))]
                                for t in row if int(t) > 0)
                anns.append({"image_id": img_id, "caption": sent, "id": aid})
                aid += 1
    return CocoAnnotations(dataset={"annotations": anns, "images": images})


def language_eval(dataset, preds, model_id, split, ann_file=None,
                  loader=None, out_dir="eval_results", include_spice=False):
    """ref: eval_utils.py:19-86."""
    if ann_file and os.path.isfile(ann_file):
        coco = CocoAnnotations(ann_file)
    elif loader is not None:
        coco = annotations_from_loader(loader)
    else:
        raise ValueError("need ann_file or loader for language_eval")

    os.makedirs(out_dir, exist_ok=True)
    cache_path = os.path.join(out_dir, f"{model_id}_{split}.json")

    valids = set(coco.get_img_ids())
    preds_filt = [p for p in preds if p["image_id"] in valids]
    print(f"using {len(preds_filt)}/{len(preds)} predictions")
    with open(cache_path, "w") as f:
        json.dump(preds_filt, f)

    coco_res = coco.load_res(preds_filt)
    coco_eval = CocoEvalCap(coco, coco_res, include_spice=include_spice)
    coco_eval.params["image_id"] = coco_res.get_img_ids()
    coco_eval.evaluate()

    out = dict(coco_eval.eval)
    if include_spice:
        # per-category SPICE means (ref: eval_utils.py:66-70)
        import numpy as np
        vals = list(coco_eval.img_to_eval.values())
        for k in vals[0]["SPICE"]:
            if k == "All":
                continue
            arr = np.array([v["SPICE"][k]["f"] for v in vals])
            out["SPICE_" + k] = float(arr[arr == arr].mean())

    img_to_eval = coco_eval.img_to_eval
    for p in preds_filt:
        if p["image_id"] in img_to_eval:
            img_to_eval[p["image_id"]]["caption"] = p["caption"]
    for p in preds:
        if p["image_id"] in img_to_eval:
            p["eval"] = img_to_eval[p["image_id"]]
    with open(os.path.join(out_dir, f"{model_id}_{split}_nofilt.json"),
              "w") as f:
        json.dump(preds, f, default=str)
    with open(cache_path, "w") as f:
        json.dump({"overall": out, "imgToEval": img_to_eval}, f, default=str)
    return out
