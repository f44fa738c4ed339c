"""COCO caption evaluation (ref: coco-caption/pycocoevalcap/eval.py and the
minimal slice of pycocotools/coco.py the eval path uses).

CocoAnnotations: loads a captions_*.json annotation file (or an in-memory dict)
and serves image ids + per-image GT captions.
CocoEvalCap.evaluate(): PTB-tokenize GT + results, run BLEU(4) / METEOR / ROUGE-L /
CIDEr, fill `eval` (corpus) and `imgToEval` (per-image) like the reference.

The port's own copy of the JAX package's evaluation/coco_eval.py, over the
port's scorers (each on its C++ tier once native/ is built)."""

from __future__ import annotations

import json

from cooperativeimagecaptioning_tpu_torch.metrics import bleu, rouge, meteor, tokenizer
from cooperativeimagecaptioning_tpu_torch.rewards.cider_d import CiderD


class CocoAnnotations:
    """Annotation container (ref: pycocotools/coco.py — the caption slice)."""

    def __init__(self, annotation_file=None, dataset=None):
        if dataset is None:
            with open(annotation_file) as f:
                dataset = json.load(f)
        self.dataset = dataset
        self.img_to_anns = {}
        for ann in dataset.get("annotations", []):
            self.img_to_anns.setdefault(ann["image_id"], []).append(ann)
        self.imgs = {img["id"]: img for img in dataset.get("images", [])}

    def get_img_ids(self):
        return list(self.imgs.keys())

    # camelCase aliases for reference-API compatibility
    getImgIds = get_img_ids

    def load_res(self, res):
        """Results (path or list of {'image_id','caption'}) -> CocoAnnotations."""
        if isinstance(res, str):
            with open(res) as f:
                res = json.load(f)
        anns = [{"image_id": p["image_id"], "caption": p["caption"], "id": i}
                for i, p in enumerate(res)]
        images = [{"id": p["image_id"]} for p in res]
        return CocoAnnotations(dataset={"annotations": anns, "images": images})

    loadRes = load_res


class CocoEvalCap:
    """ref: coco-caption/pycocoevalcap/eval.py:14-81."""

    def __init__(self, coco: CocoAnnotations, coco_res: CocoAnnotations,
                 include_spice: bool = False):
        self.coco = coco
        self.coco_res = coco_res
        self.include_spice = include_spice
        self.params = {"image_id": coco_res.get_img_ids()}
        self.eval = {}
        self.img_to_eval = {}
        self.imgToEval = self.img_to_eval  # reference-API alias

    def evaluate(self):
        img_ids = self.params["image_id"]
        gts, res = {}, {}
        for iid in img_ids:
            gts[iid] = [{"caption": a["caption"]}
                        for a in self.coco.img_to_anns[iid]]
            res[iid] = [{"caption": a["caption"]}
                        for a in self.coco_res.img_to_anns[iid]]
        gts = tokenizer.tokenize(gts)
        res = tokenizer.tokenize(res)

        b_corpus, b_per = bleu.compute_bleu(gts, res)
        ids = sorted(res.keys(), key=lambda x: str(x))
        for k in range(4):
            self._set(f"Bleu_{k + 1}", b_corpus[k], b_per[k], ids)
        m_mean, m_per = meteor.compute_meteor(gts, res)
        self._set("METEOR", m_mean, m_per, ids)
        r_mean, r_per = rouge.compute_rouge(gts, res)
        self._set("ROUGE_L", r_mean, r_per, ids)
        cider = CiderD(df="corpus")
        c_mean, c_per = cider.compute_score(
            gts, [{"image_id": i, "caption": res[i]} for i in ids])
        self._set("CIDEr", c_mean, c_per, ids)
        if self.include_spice:
            from cooperativeimagecaptioning_tpu_torch.metrics import spice
            s_mean, s_per = spice.compute_spice(gts, res)
            self._set("SPICE", s_mean, s_per, ids)
        return self.eval

    def _set(self, name, corpus_score, per_image, ids):
        self.eval[name] = float(corpus_score)
        for iid, s in zip(ids, per_image):
            self.img_to_eval.setdefault(iid, {"image_id": iid})[name] = \
                s if isinstance(s, dict) else float(s)
