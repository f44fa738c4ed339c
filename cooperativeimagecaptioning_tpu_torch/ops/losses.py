"""Loss functions (counterpart of the JAX package's ops/losses.py; ref
misc/utils.py:45-58 and the reward losses of
models/AlternatingJointModel.py): the masked NLL of teacher forcing, the
REINFORCE surrogate of self-critical training and the masks of a sampled
sequence."""

from __future__ import annotations

import torch

from cooperativeimagecaptioning_tpu_torch.parallel import collectives, vocab


def language_model_criterion(logprobs, targets, masks, rows=None):
    """Masked NLL (JAX losses.py:9-19).

    logprobs: [B, T, C] (on a vocab mesh this rank's slice of C); targets /
    masks: [B, >=T] -- truncated to T like the reference (whose time loop may
    stop early).  `rows`, the data group of a mesh run whose ranks hold
    shares of the rows, normalises by the global batch's mask sum, so the
    ranks' losses add up to the global one."""
    T = logprobs.shape[1]
    targets = targets[:, :T]
    masks = masks[:, :T]
    picked = vocab.pick(logprobs, targets)
    den = collectives.all_reduce(masks.sum(), rows)
    return -(picked * masks).sum() / den


def self_critical_loss(sample_logprobs, reward, gen_masks, rows=None):
    """REINFORCE surrogate, -E[r * logp] masked and mean-normalized (JAX
    losses.py:23-35; ref AlternatingJointModel.py:421-427):
    sum(logp * coeff * mask[:, 1:]) / sum(mask[:, 1:]), where the caller
    passes coeff = -reward, detached.  sample_logprobs [B, L], reward [B],
    gen_masks [B, L+1] (column 0 dropped like the reference's masks[:, 1:]).
    `rows`: as language_model_criterion's (the global batch's mask sum)."""
    m = gen_masks[:, 1:]
    den = collectives.all_reduce(m.sum(), rows)
    return (sample_logprobs * reward[:, None] * m).sum() / den


def masks_from_seq(seq):
    """Masks of a sampled sequence (JAX losses.py:38-45; ref
    AlternatingJointModel.py:232-235): [B, L] ids -> [B, L+1] float32,
    cat(ones[B, 2], (seq > 0)[:, :-1]) -- the two leading ones cover BOS and
    the first word."""
    lead = torch.ones((seq.shape[0], 2), dtype=torch.float32,
                      device=seq.device)
    return torch.cat([lead, (seq > 0).to(torch.float32)[:, :-1]], dim=1)
