"""Feature-extraction pipeline (counterpart of the JAX package's
preprocess/feats.py; ref: preprocess/prepro_feats.py).

raw images -> per-image {id}.npy (fc 2048) + {id}.npz (att 14x14x2048), the
reference's artifacts, in the layout both packages read ([14, 14, 2048]
float32 under the npz key `feat`).  Images are resized on the host to a
fixed resolution, batched, and pushed through one normalize -> ResNet ->
pool forward on the device.  Pass resize_to=None to run each image at its
native resolution, one at a time, as the reference does.

Device: the entry points run on the card ("cuda") unless the caller passes
device="cpu"; without a card they raise, they never fall back to the CPU.
Precision: float32, with cuDNN's TF32 switched off around the forward only
(`resnet.f32_convolutions`), so the card's features agree with the CPU's
to f32 rounding.  The last batch may be smaller than the others: it runs at
its own shape (cuDNN picks its algorithm again), nothing is padded.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from cooperativeimagecaptioning_tpu_torch.preprocess import resnet


def _to_rgb_float(img):
    """grayscale fix + [0,1] scaling (ref: prepro_feats.py:80-84)."""
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=2)
    return img.astype(np.float32) / 255.0


def _device(device):
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("feature extraction: device 'cuda' asked for but "
                           "no CUDA device is available (pass device='cpu' "
                           "to extract on the host)")
    return dev


def make_extractor(model, att_size=14, device="cuda"):
    """float images [B, H, W, 3] in [0, 1] (numpy) -> (fc [B, 2048], att
    [B, att_size, att_size, 2048]) as numpy float32, computed on `device`.
    Moves `model` there, in eval mode."""
    dev = _device(device)
    model = model.to(dev).eval()
    mean = torch.as_tensor(resnet.IMAGENET_MEAN, device=dev)
    std = torch.as_tensor(resnet.IMAGENET_STD, device=dev)

    def run(batch):
        x = torch.from_numpy(np.ascontiguousarray(batch, np.float32)).to(dev)
        with torch.no_grad(), resnet.f32_convolutions():
            fc, att = resnet.features(model, (x - mean) / std, att_size)
        return fc.cpu().numpy(), att.cpu().numpy()
    return run


def extract_to_dirs(model, images, ids, output_dir, att_size=14,
                    batch_size=8, resize_to=448, skip_existing=True,
                    device="cuda", timings=None):
    """images: list of uint8 HWC arrays (or callables returning them); ids:
    matching artifact keys.  Writes <output_dir>_fc/<id>.npy and
    <output_dir>_att/<id>.npz (ref: prepro_feats.py:88-101).

    skip_existing resumes a partially-extracted layout (123k COCO images take
    hours -- a crash must not restart from zero): images whose fc AND att
    artifacts both exist are not recomputed.  `timings`, a dict, receives
    the seconds spent loading and resizing on the host ("load"), in the
    forward ("forward", synchronized) and writing ("write"), and the number
    of images computed ("images")."""
    dir_fc = output_dir + "_fc"
    dir_att = output_dir + "_att"
    os.makedirs(dir_fc, exist_ok=True)
    os.makedirs(dir_att, exist_ok=True)
    todo = list(range(len(images)))
    if skip_existing:
        todo = [k for k in todo if not (
            os.path.isfile(os.path.join(dir_fc, f"{ids[k]}.npy"))
            and os.path.isfile(os.path.join(dir_att, f"{ids[k]}.npz")))]
        if len(todo) < len(images):
            print(f"feats: resuming — {len(images) - len(todo)}/"
                  f"{len(images)} already extracted", flush=True)
    run = make_extractor(model, att_size, device)
    np.random.seed(123)  # determinism pin (ref: prepro_feats.py:64)
    spent = {"load": 0.0, "forward": 0.0, "write": 0.0, "images": len(todo)}

    def load(i):
        img = images[i]() if callable(images[i]) else images[i]
        img = _to_rgb_float(np.asarray(img))
        if resize_to is not None and img.shape[:2] != (resize_to, resize_to):
            img = _resize_bilinear(img, resize_to)
        return img

    def forward(batch):
        t = time.perf_counter()
        out = run(batch)  # .cpu() synchronizes
        spent["forward"] += time.perf_counter() - t
        return out

    i = 0
    while i < len(todo):
        idx = todo[i:i + batch_size]
        t = time.perf_counter()
        batch = [load(k) for k in idx]
        spent["load"] += time.perf_counter() - t
        if resize_to is None:
            for k, img in zip(idx, batch):
                fc, att = forward(img[None])
                t = time.perf_counter()
                _write(dir_fc, dir_att, ids[k], fc[0], att[0])
                spent["write"] += time.perf_counter() - t
        else:
            fc, att = forward(np.stack(batch))
            t = time.perf_counter()
            for off, k in enumerate(idx):
                _write(dir_fc, dir_att, ids[k], fc[off], att[off])
            spent["write"] += time.perf_counter() - t
        i += len(idx)
    if timings is not None:
        timings.update(spent)
    return dir_fc, dir_att


def _write(dir_fc, dir_att, key, fc, att):
    """Atomic artifact writes (tmp + rename): skip_existing's resume treats
    an existing file as complete, so a crash / supervisor SIGKILL mid-write
    must never leave a truncated .npy/.npz behind — it would be skipped
    forever and crash training at np.load time."""
    fc_tmp = os.path.join(dir_fc, f".{key}.tmp.npy")
    np.save(fc_tmp, np.asarray(fc, np.float32))
    os.replace(fc_tmp, os.path.join(dir_fc, f"{key}.npy"))
    att_tmp = os.path.join(dir_att, f".{key}.tmp.npz")
    with open(att_tmp, "wb") as f:
        np.savez_compressed(f, feat=np.asarray(att, np.float32))
    os.replace(att_tmp, os.path.join(dir_att, f"{key}.npz"))


def _lin_weights(n_in, n_out):
    """[n_out, n_in] anti-aliased linear resampling weights — the same
    triangle kernel (scaled by the ratio when downsampling, half-pixel
    centers, edge renormalization) as the JAX package's resize."""
    scale = n_in / n_out
    kscale = max(scale, 1.0)  # widen the kernel when downsampling (AA)
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    dist = (src[:, None] - np.arange(n_in, dtype=np.float64)[None, :]) / kscale
    w = np.maximum(0.0, 1.0 - np.abs(dist))
    return (w / w.sum(axis=1, keepdims=True)).astype(np.float32)


def _resize_bilinear(img, size):
    """Host-side bilinear resize to a square (enables fixed-shape batching),
    in numpy: one image per raw resolution never reaches the device."""
    img = np.asarray(img, np.float32)
    H, W, _ = img.shape
    wy = _lin_weights(H, size)
    wx = _lin_weights(W, size)
    return np.einsum("oh,hwc,pw->opc", wy, img, wx, optimize=True)


def load_model(model_weights=None, arch="resnet101"):
    """The extractor's ResNet: a pickled torchvision state_dict when given
    (`--model_weights`), else random weights from seed 0 (as the JAX
    package's PRNGKey(0))."""
    if model_weights:
        import pickle
        with open(model_weights, "rb") as f:
            state_dict = pickle.load(f)
        return resnet.load_weights(resnet.ResNet(resnet._blocks_of(arch)),
                                   state_dict)
    return resnet.init_model(torch.Generator().manual_seed(0), arch)


def prepro_feats(input_json, images_root, output_dir, model_weights=None,
                 arch="resnet101", att_size=14, dataset="coco",
                 batch_size=8, resize_to=448, device="cuda"):
    """CLI-equivalent pipeline (ref: prepro_feats.py:53-105)."""
    _device(device)
    with open(input_json) as f:
        imgs = json.load(f)["images"]
    model = load_model(model_weights, arch)

    def loader(img):
        def _load():
            try:
                from imageio import imread
            except ImportError:
                from PIL import Image
                imread = lambda p: np.asarray(Image.open(p))
            if dataset in ("flickr8k", "flickr30k"):
                path = os.path.join(images_root, img["filename"])
            else:
                path = os.path.join(images_root, img.get("filepath", ""),
                                    img["filename"])
            return imread(path)
        return _load

    ids = [img["filename"].split(".")[0]
           if dataset in ("flickr8k", "flickr30k") else img["cocoid"]
           for img in imgs]
    return extract_to_dirs(model, [loader(im) for im in imgs], ids,
                           output_dir, att_size, batch_size, resize_to,
                           device=device)


def main(argv=None):
    """Standalone CLI (ref: prepro_feats.py:108-129), plus --device."""
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--input_json", required=True,
                    help="dataset json (Karpathy split format)")
    ap.add_argument("--output_dir", default="data",
                    help="writes <dir>_fc/ and <dir>_att/")
    ap.add_argument("--images_root", default="",
                    help="root of raw image folders")
    ap.add_argument("--att_size", default=14, type=int, help="14x14 or 7x7")
    ap.add_argument("--model", default="resnet101", type=str,
                    help="resnet101, resnet152")
    ap.add_argument("--model_weights", default=None, type=str,
                    help="pickled torchvision state_dict")
    ap.add_argument("--dataset", default="coco", type=str)
    ap.add_argument("--batch_size", default=8, type=int)
    ap.add_argument("--device", default="cuda",
                    help="torch device to extract on (cuda, or cpu)")
    args = ap.parse_args(argv)
    print("parsed input parameters:")
    print(json.dumps(vars(args), indent=2))
    return prepro_feats(args.input_json, args.images_root, args.output_dir,
                        model_weights=args.model_weights, arch=args.model,
                        att_size=args.att_size, dataset=args.dataset,
                        batch_size=args.batch_size, device=args.device)


if __name__ == "__main__":
    main()
