"""Turnkey COCO reproduction on the port: one entry point chaining the whole
protocol (counterpart of the JAX package's scripts/reproduce_coco.py; ref:
README.md:27-102's manual recipe + bash_scripts/run_*.sh).

    python -m cooperativeimagecaptioning_tpu_torch.scripts.reproduce_coco \\
        --raw-json dataset_coco.json --images-root /path/to/coco \\
        --workdir runs/coco

Steps (each skipped when its artifacts already exist in --workdir):
  0. layout check — reports exactly which inputs are missing and where the
     reference documents downloading them (README.md:41-56);
  1. labels  — data/cocotalk.json + data/cocotalk_label.h5
               (python -m ...preprocess.labels);
  2. ngrams  — data/coco-train-{words,idxs}.p document frequencies
               (python -m ...preprocess.ngrams);
  3. feats   — data/cocotalk_fc/ + data/cocotalk_att/ from raw images
               (python -m ...preprocess.feats; skipped when the download
               layout provides the dirs; pass --model-weights for the
               pretrained ResNet-101, else features are random-init);
  4. stage 1 — listener (VSE) pretrain         (scripts/run_fc_con.py);
  5. stage 2 — speaker MLE pretrain            (scripts/run_att.py);
  6. stage 3 — joint cooperative optimization  (scripts/run_joint.py, which
               also harvests per-criterion bests + the results json).
Every module named is the port's (cooperativeimagecaptioning_tpu_torch.*).
The feature extraction and the three stages run on the card unless
--device cpu.

--synthetic N fabricates a tiny Karpathy-format raw layout (N images with
derived captions + random PNGs) and dry-runs the ENTIRE chain through the
same real CLIs at reduced dims; swap in the real COCO inputs and the
identical code path reproduces the paper protocol:

    python -m cooperativeimagecaptioning_tpu_torch.scripts.reproduce_coco \\
        --synthetic 24 --device cpu --workdir /tmp/rc
"""

from __future__ import annotations

import argparse
import json
import os
import sys


DOWNLOAD_HINTS = """\
Missing inputs. The reference documents the downloads (README.md:41-56):
  dataset_coco.json  — Karpathy split json (--raw-json)
  images             — raw COCO images (--images-root), OR the
  feature dirs       — pre-extracted cocotalk_fc/ + cocobu_att/ tars from
                       the DiscCaptioning drive folder; place them as
                       <workdir>/data/cocotalk_fc and .../cocotalk_att
"""


def check_layout(workdir, raw_json=""):
    """Structured prepro-layout report for partial-download / partial-run
    states.  Returns {artifact: {"state", "action", ...}} with states:

      ok        — artifact complete and consistent
      missing   — not there; `action` says what input builds it
      partial   — one of a pair / a subset of files present; rebuild resumes
      stale     — older than the raw json it derives from; rebuild
      mismatch  — internally inconsistent (labels outside the vocab);
                  must be deleted and rebuilt, never silently reused

    main() consults this instead of ad-hoc isfile() checks, so every skip /
    rebuild / abort decision is testable."""
    data = os.path.join(workdir, "data")
    talk_json = os.path.join(data, "cocotalk.json")
    label_h5 = os.path.join(data, "cocotalk_label.h5")
    idxs_p = os.path.join(data, "coco-train-idxs.p")
    fc_dir = os.path.join(data, "cocotalk_fc")
    att_dir = os.path.join(data, "cocobu_att")
    if not os.path.isdir(att_dir):
        att_dir = os.path.join(data, "cocotalk_att")
    report = {}

    def entry(state, action, **extra):
        return {"state": state, "action": action, **extra}

    # -- labels pair (cocotalk.json + cocotalk_label.h5) ---------------------
    have_json, have_h5 = os.path.isfile(talk_json), os.path.isfile(label_h5)
    n_images = vocab_size = None
    if not have_json and not have_h5:
        report["labels"] = entry(
            "missing", "build from --raw-json (dataset_coco.json) via "
            "preprocess.labels, or download data/cocotalk.{json,_label.h5}")
    elif have_json != have_h5:
        missing = label_h5 if have_json else talk_json
        report["labels"] = entry(
            "partial", f"{os.path.basename(missing)} absent — rebuilding the "
            "pair from --raw-json (both are written together)")
    else:
        state, action = "ok", ""
        if raw_json and os.path.isfile(raw_json) and \
                os.path.getmtime(talk_json) < os.path.getmtime(raw_json):
            state = "stale"
            action = ("cocotalk.json is older than the raw json it derives "
                      "from — rebuilding the labels pair")
        else:
            try:
                import h5py
                with open(talk_json) as f:
                    talk = json.load(f)
                vocab_size = len(talk["ix_to_word"])
                n_images = len(talk["images"])
                with h5py.File(label_h5, "r") as f:
                    max_label = int(f["labels"][...].max())
                # valid token ids are 1..vocab (0 = pad); a larger id means
                # the h5 was built against a DIFFERENT vocab (mixed state)
                if max_label > vocab_size:
                    state = "mismatch"
                    action = (f"label id {max_label} exceeds the json vocab "
                              f"({vocab_size} words): cocotalk.json and "
                              "cocotalk_label.h5 come from different builds "
                              "— delete both and rebuild from --raw-json")
            except Exception as e:  # unreadable artifact = rebuild-worthy
                state = "mismatch"
                action = f"unreadable labels pair ({e}) — delete and rebuild"
        report["labels"] = entry(state, action, vocab_size=vocab_size,
                                 n_images=n_images)

    # -- ngram document frequencies ------------------------------------------
    if not os.path.isfile(idxs_p):
        report["ngrams"] = entry(
            "missing", "build from --raw-json via preprocess.ngrams, or "
            "download data/coco-train-idxs.p")
    elif report["labels"]["state"] == "ok" and \
            os.path.getmtime(idxs_p) < os.path.getmtime(talk_json):
        report["ngrams"] = entry(
            "stale", "coco-train-idxs.p predates cocotalk.json (ngrams are "
            "indexed by its vocab) — rebuilding")
    else:
        report["ngrams"] = entry("ok", "")

    # -- feature dirs ----------------------------------------------------------
    have_fc, have_att = os.path.isdir(fc_dir), os.path.isdir(att_dir)
    if not (have_fc and have_att):
        report["feats"] = entry(
            "missing", "extract from --images-root via preprocess.feats, or "
            "download cocotalk_fc/ + cocobu_att/")
    else:
        # dotfiles are in-flight atomic-write temps (preprocess/feats._write)
        n_fc = sum(1 for f in os.listdir(fc_dir)
                   if f.endswith(".npy") and not f.startswith("."))
        n_att = sum(1 for f in os.listdir(att_dir)
                    if f.endswith((".npz", ".npy")) and not f.startswith("."))
        if n_images is not None and (n_fc < n_images or n_att < n_images):
            report["feats"] = entry(
                "partial", f"{n_fc}/{n_images} fc and {n_att}/{n_images} att "
                "features present — re-running extraction (existing files "
                "are kept and skipped)", n_fc=n_fc, n_att=n_att)
        else:
            report["feats"] = entry("ok", "", n_fc=n_fc, n_att=n_att)
    return report


def _report_lines(report):
    return "\n".join(f"  {k:7s} {v['state']:8s} {v['action']}".rstrip()
                     for k, v in report.items())


def fabricate_synthetic_raw(workdir, n_images=24, size=48, vocab=40,
                            caps_per_image=5, seed=0):
    """Tiny Karpathy-format dataset json + random PNG images: the raw-input
    layout the real COCO download provides, so the chain below is identical."""
    import numpy as np
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(workdir, "images", "train2014")
    os.makedirs(img_dir, exist_ok=True)
    words = [f"w{i}" for i in range(vocab)]
    images = []
    for i in range(n_images):
        fname = f"COCO_train2014_{i:012d}.png"
        arr = rng.randint(0, 255, (size, size, 3), dtype="uint8")
        _write_png(os.path.join(img_dir, fname), arr)
        # feature-correlated captions: brightness picks the word register
        base = int(arr.mean()) % (vocab - 8)
        sents = []
        for j in range(caps_per_image):
            toks = [words[(base + rng.randint(0, 6)) % vocab]
                    for _ in range(rng.randint(4, 9))]
            sents.append({"tokens": toks, "raw": " ".join(toks)})
        split = "train" if i < n_images * 0.7 else \
            "val" if i < n_images * 0.85 else "test"
        images.append({"cocoid": i, "id": i, "split": split,
                       "filepath": "train2014", "filename": fname,
                       "sentences": sents})
    raw = os.path.join(workdir, "dataset_coco.json")
    with open(raw, "w") as f:
        json.dump({"images": images, "dataset": "coco"}, f)
    return raw, os.path.join(workdir, "images")


def _write_png(path, arr):
    from PIL import Image
    Image.fromarray(arr).save(path)


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--raw-json", default="",
                   help="Karpathy dataset_coco.json")
    p.add_argument("--images-root", default="",
                   help="root of raw image folders (train2014/ val2014/)")
    p.add_argument("--workdir", default="runs/coco")
    p.add_argument("--model-weights", default="",
                   help="converted ResNet-101 weights pickle for feats")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--listener-epochs", type=int, default=30)
    p.add_argument("--mle-epochs", type=int, default=200)
    p.add_argument("--joint-epochs", type=int, default=350,
                   help="TOTAL epoch budget for the joint stage — the epoch "
                        "counter carries over from the stage-2 seed "
                        "(reference copy_model.sh semantics), so this must "
                        "exceed --mle-epochs")
    p.add_argument("--optimization", default="gumbel",
                   help="joint mode (run_joint.py -o)")
    p.add_argument("--discriminative", type=float, default=0.01)
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="fabricate an N-image synthetic raw layout and "
                        "dry-run the whole chain at reduced dims")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="extra Options override forwarded to every stage")
    p.add_argument("--device", default="cuda",
                   help="torch device of the feature extraction and the "
                        "three stages (cuda, or cpu)")
    args = p.parse_args(argv)

    workdir = os.path.abspath(args.workdir)
    os.makedirs(os.path.join(workdir, "data"), exist_ok=True)

    if args.synthetic:
        args.raw_json, args.images_root = fabricate_synthetic_raw(
            workdir, n_images=args.synthetic)
        args.batch = min(args.batch, 4)
        args.listener_epochs = min(args.listener_epochs, 2)
        args.mle_epochs = min(args.mle_epochs, 2)
        args.joint_epochs = args.mle_epochs + 3
        tiny = ["rnn_size=32", "input_encoding_size=24", "att_hid_size=16",
                "vse_embed_size=24", "save_checkpoint_every=4",
                "val_images_use=4", "max_att_len=4", "beam_size=1"]
        args.set = tiny + args.set

    data = os.path.join(workdir, "data")
    talk_json = os.path.join(data, "cocotalk.json")
    label_h5 = os.path.join(data, "cocotalk_label.h5")
    fc_dir = os.path.join(data, "cocotalk_fc")
    att_dir = os.path.join(data, "cocotalk_att")
    if os.path.isdir(os.path.join(data, "cocobu_att")):
        att_dir = os.path.join(data, "cocobu_att")   # downloaded layout

    # 0. layout check (structured; every skip/rebuild decision below reads it)
    report = check_layout(workdir, args.raw_json)
    print("[layout]\n" + _report_lines(report), flush=True)
    if report["labels"]["state"] == "mismatch":
        sys.exit("inconsistent prepro layout:\n" + _report_lines(report))
    if not args.raw_json and not (report["labels"]["state"] == "ok"
                                  and report["feats"]["state"] == "ok"):
        sys.exit(DOWNLOAD_HINTS + "\ncurrent layout:\n" + _report_lines(report))

    # 1. labels
    if report["labels"]["state"] != "ok":
        if not args.raw_json:
            sys.exit(f"missing {label_h5} and no --raw-json to build it "
                     f"from (dataset_coco.json)\n" + DOWNLOAD_HINTS)
        from cooperativeimagecaptioning_tpu_torch.preprocess import labels
        print("[prepro] labels ->", talk_json, flush=True)
        labels.main(["--input_json", args.raw_json,
                     "--output_json", talk_json,
                     "--output_h5", label_h5[: -len("_label.h5")]])
        report = check_layout(workdir, args.raw_json)  # refresh downstream
    # 2. ngram document frequencies
    idxs_p = os.path.join(data, "coco-train-idxs.p")
    if report["ngrams"]["state"] != "ok":
        if not args.raw_json:
            sys.exit(f"missing {idxs_p} and no --raw-json to build it "
                     f"from (dataset_coco.json)\n" + DOWNLOAD_HINTS)
        from cooperativeimagecaptioning_tpu_torch.preprocess import ngrams
        print("[prepro] ngrams ->", idxs_p, flush=True)
        ngrams.main(["--input_json", args.raw_json,
                     "--dict_json", talk_json,
                     "--output_pkl", os.path.join(data, "coco-train"),
                     "--split", "train"])
    # 3. features (partial dirs resume: extraction skips existing files)
    if report["feats"]["state"] != "ok":
        if not args.images_root:
            sys.exit(DOWNLOAD_HINTS)
        from cooperativeimagecaptioning_tpu_torch.preprocess import feats
        print("[prepro] feats ->", fc_dir, att_dir, flush=True)
        fargv = ["--input_json", args.raw_json,
                 "--output_dir", os.path.join(data, "cocotalk"),
                 "--images_root", args.images_root,
                 "--batch_size", "4", "--device", args.device]
        if args.model_weights:
            fargv += ["--model_weights", args.model_weights]
        feats.main(fargv)

    # the stage drivers resolve cached_tokens / eval_results relative to cwd
    # (reference convention); run them from the workdir
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        data_flags = ["--input-json", talk_json,
                      "--input-label-h5", label_h5,
                      "--input-fc-dir", fc_dir,
                      "--input-att-dir", att_dir,
                      "--root-dir", workdir, "--device", args.device]
        setf = [x for kv in args.set for x in ("--set", kv)]

        from cooperativeimagecaptioning_tpu_torch.scripts import (
            run_att, run_fc_con, run_joint)
        s1 = os.path.join(workdir, "log_fc_con")
        if not os.path.isfile(os.path.join(s1, "model-best.pth")):
            print("[stage 1] listener pretrain", flush=True)
            run_fc_con.main(["-b", str(args.batch),
                             "--max-epochs", str(args.listener_epochs),
                             *data_flags, *setf])
        s2 = os.path.join(workdir, "log_att")
        if not os.path.isfile(os.path.join(s2, "model-best.pth")):
            print("[stage 2] speaker MLE pretrain", flush=True)
            run_att.main(["-b", str(args.batch),
                          "--max-epochs", str(args.mle_epochs),
                          *data_flags, *setf])
        print("[stage 3] joint cooperative optimization", flush=True)
        run_joint.main(["-o", args.optimization,
                        "-D", str(args.discriminative),
                        "-b", str(args.batch),
                        "--max-epochs", str(args.joint_epochs),
                        "--speaker-stage-2-model",
                        os.path.join(s2, "model-best.pth"),
                        "--listener-stage-1-model",
                        os.path.join(s1, "model-best.pth"),
                        *data_flags, *setf,
                        "--set", "cached_tokens=coco-train-idxs"])
    finally:
        os.chdir(cwd)
    print("reproduce_coco: all stages complete; harvested results under",
          os.path.join(workdir, args.optimization), flush=True)


if __name__ == "__main__":
    main()
