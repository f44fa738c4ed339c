"""Param checkpoints in the JAX package's format (training/checkpoint.py:
43-50): a pickled nested dict of numpy arrays.  A `model-best.pth` written
by either package loads in both.  The orbax tier is not ported.

Unpickling runs code from the file: load only checkpoints this project
wrote.
"""

from __future__ import annotations

import pickle

import torch

from cooperativeimagecaptioning_tpu_torch.utils.tree import to_numpy, to_torch


def save_params(params, path):
    """Write a tree of tensors (or numpy arrays) as pickled numpy."""
    with open(path, "wb") as f:
        pickle.dump(to_numpy(params), f)


def load_params(path, device="cpu"):
    """Read a pickled numpy tree into tensors on `device`."""
    with open(path, "rb") as f:
        return to_torch(pickle.load(f), device)


def load_params_into(params, path, strict=False):
    """Lenient merge like ref misc/utils.py:89-107 (JAX checkpoint.py:63-105):
    copy the leaves the checkpoint shares with `params` (onto each leaf's
    device and dtype), report the others, keep the rest.  A leaf of another
    shape is copied flat, as far as it reaches."""
    with open(path, "rb") as f:
        loaded = pickle.load(f)

    def merge(cur, new, prefix=""):
        if isinstance(cur, dict):
            out = {}
            for k, v in cur.items():
                if isinstance(new, dict) and k in new:
                    out[k] = merge(v, new[k], prefix + k + ".")
                else:
                    if strict:
                        raise KeyError(
                            f"missing key {prefix + k} in checkpoint")
                    print(f"key {prefix + k} not in loaded checkpoint")
                    out[k] = v
            for k in (new or {}):
                if k not in cur:
                    print(f"key {prefix + k} in checkpoint not in model")
            return out
        new = to_torch(new, cur.device).to(cur.dtype)
        if new.shape != cur.shape:
            print(f"key {prefix[:-1]} size mismatch {tuple(new.shape)} vs "
                  f"{tuple(cur.shape)}; flatten-copy")
            flat = cur.detach().clone().reshape(-1)
            n = min(flat.numel(), new.numel())
            flat[:n] = new.reshape(-1)[:n]
            new = flat.reshape(cur.shape)
        return new

    with torch.no_grad():
        return merge(params, loaded)
