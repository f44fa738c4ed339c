"""Loss functions (counterpart of the JAX package's ops/losses.py; ref
misc/utils.py:45-58).  Ported: the masked NLL of teacher forcing.  The two
REINFORCE helpers come with joint training (ROADMAP.md queue 1)."""

from __future__ import annotations

import torch


def language_model_criterion(logprobs, targets, masks):
    """Masked NLL (JAX losses.py:9-19).

    logprobs: [B, T, C]; targets/masks: [B, >=T] -- truncated to T like the
    reference (whose time loop may stop early)."""
    T = logprobs.shape[1]
    targets = targets[:, :T]
    masks = masks[:, :T]
    picked = torch.gather(logprobs, 2, targets[..., None].long())[..., 0]
    return -(picked * masks).sum() / masks.sum()
