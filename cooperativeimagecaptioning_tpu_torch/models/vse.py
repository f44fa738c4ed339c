"""VSE listener: visual-semantic embedding retrieval model (counterpart of
the JAX package's models/vse.py; ref models/VSEFCModel.py).

  encode_image:     Linear(fc_feat, vse_embed) -> l2norm (+abs)
  encode_text:      Embedding(V+2, D) -> GRU / LSTM -> {last, mean, max}
                    pool -> l2norm (+abs)
  contrastive_loss: bidirectional hinge ranking with hard negatives

The text encoder takes integer ids [B, T] or one-hot / soft rows
[B, T, V+2] multiplied into the embedding table: the differentiable bridge
from the speaker's relaxed samples (ref VSEFCModel.py:102-106).

The recurrence is written as explicit steps on tensors, as the JAX
package's lax.scan is, over the full length with masked pooling ('last'
gathers position len-1), in the JAX tree layout: `w_ih` [D, G*E] applied as
`x @ w_ih`, gates in torch's order (GRU: r, z, n; LSTM: i, f, g, o).  No
torch.nn.GRU: its fused path gives no handle on masked pooling or on soft
inputs.  The products are plain torch.matmul: the JAX package computes them
outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cooperativeimagecaptioning_tpu_torch.models import layers
from cooperativeimagecaptioning_tpu_torch.utils.tree import ParamTree, to_torch


def _rnn_init(rng, in_dim, hid, ngates):
    """torch.nn.RNNBase's default init: U(-1/sqrt(H), 1/sqrt(H))."""
    bound = 1.0 / np.sqrt(hid)
    return {"w_ih": layers.uniform_init(rng, (in_dim, ngates * hid), bound),
            "w_hh": layers.uniform_init(rng, (hid, ngates * hid), bound),
            "b_ih": layers.uniform_init(rng, (ngates * hid,), bound),
            "b_hh": layers.uniform_init(rng, (ngates * hid,), bound)}


def init_params(seed: int, opt, device="cpu"):
    """Random float32 listener params in the JAX tree layout, from a numpy
    seed (JAX vse.py:38-58: Xavier image encoder, U(-0.1, 0.1) table)."""
    rng = np.random.RandomState(seed)
    V = opt.vocab_size
    D = opt.input_encoding_size
    E = opt.vse_embed_size
    r = np.sqrt(6.0) / np.sqrt(opt.fc_feat_size + E)
    ngates = {"gru": 3, "lstm": 4}[opt.vse_rnn_type.lower()]
    params = {
        "img_enc": {"fc": {
            "w": layers.uniform_init(rng, (opt.fc_feat_size, E), r),
            "b": np.zeros((E,), np.float32)}},
        "txt_enc": {"embed": layers.uniform_init(rng, (V + 2, D), 0.1),
                    "rnn": _rnn_init(rng, D, E, ngates)},
    }
    return to_torch(params, device)


def gru_step(p, h, x):
    """torch GRUCell math, gate order (r, z, n)."""
    H = h.shape[-1]
    gi = x @ p.w_ih + p.b_ih
    gh = h @ p.w_hh + p.b_hh
    r = torch.sigmoid(gi[:, :H] + gh[:, :H])
    z = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
    n = torch.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
    return (1.0 - z) * n + z * h


def lstm_step(p, state, x):
    """torch LSTMCell math, gate order (i, f, g, o)."""
    h, c = state
    H = h.shape[-1]
    g = x @ p.w_ih + p.b_ih + h @ p.w_hh + p.b_hh
    i = torch.sigmoid(g[:, :H])
    f = torch.sigmoid(g[:, H:2 * H])
    gg = torch.tanh(g[:, 2 * H:3 * H])
    o = torch.sigmoid(g[:, 3 * H:])
    c = f * c + i * gg
    return o * torch.tanh(c), c


def contrastive_loss(im, s, margin, max_violation, whole_batch=False,
                     only_one_retrieval="off"):
    """Bidirectional hinge ranking loss with hard negatives (JAX
    vse.py:134-175; ref VSEFCModel.py:149-207).

    im, s: [B, E], l2-normalized.  A Python number `max_violation` is the
    static flag (max over the negatives if true, else the mean); a tensor is
    the blended weight w * max + (1 - w) * mean (the mean-hinge warm-up).
    Returns a scalar, or per-sample costs [B] with whole_batch."""
    scores = im @ s.T
    diag = torch.diagonal(scores)[:, None]
    cost_s = torch.clamp(margin + scores - diag, min=0.0)    # caption side
    cost_im = torch.clamp(margin + scores - diag.T, min=0.0)  # image side
    eye = torch.eye(scores.shape[0], dtype=torch.bool, device=scores.device)
    zero = scores.new_zeros(())
    cost_s = torch.where(eye, zero, cost_s)
    cost_im = torch.where(eye, zero, cost_im)
    if isinstance(max_violation, (bool, int, float)):
        if max_violation:
            cost_s = cost_s.amax(dim=1)
            cost_im = cost_im.amax(dim=0)
        else:
            cost_s = cost_s.mean(dim=1)
            cost_im = cost_im.mean(dim=0)
    else:
        w = torch.as_tensor(max_violation, dtype=cost_s.dtype,
                            device=cost_s.device)
        cost_s = w * cost_s.amax(dim=1) + (1.0 - w) * cost_s.mean(dim=1)
        cost_im = w * cost_im.amax(dim=0) + (1.0 - w) * cost_im.mean(dim=0)
    fn = (lambda x: x) if whole_batch else torch.sum
    if only_one_retrieval == "image":
        return fn(cost_im)
    if only_one_retrieval == "caption":
        return fn(cost_s)
    return fn(cost_s) + fn(cost_im)


class VSEModel(nn.Module):
    """The VSE listener over a param tree from `init_params` (or a JAX
    checkpoint) and the run's opt (the vse_* options)."""

    init_params = staticmethod(init_params)

    def __init__(self, params: dict, opt):
        super().__init__()
        self.params = ParamTree(params)
        self.opt = opt

    def encode_image(self, fc_feats):
        """JAX vse.py:86-93."""
        feats = layers.linear(self.params.img_enc.fc, fc_feats)
        if not self.opt.vse_no_imgnorm:
            feats = layers.l2norm(feats)
        if self.opt.vse_use_abs:
            feats = torch.abs(feats)
        return feats

    def encode_text(self, seqs, masks):
        """seqs: [B, T] int ids or [B, T, V+2] soft rows; masks [B, T] ->
        [B, E] (JAX vse.py:96-131)."""
        opt = self.opt
        table = self.params.txt_enc.embed
        if seqs.dim() > 2:
            emb = seqs @ table
        else:
            emb = layers.embedding_lookup(table, seqs)
        B, T = emb.shape[0], emb.shape[1]
        p = self.params.txt_enc.rnn
        h = emb.new_zeros((B, opt.vse_embed_size))
        outs = []
        if opt.vse_rnn_type.lower() == "gru":
            for t in range(T):
                h = gru_step(p, h, emb[:, t])
                outs.append(h)
        else:
            c = torch.zeros_like(h)
            for t in range(T):
                h, c = lstm_step(p, (h, c), emb[:, t])
                outs.append(h)
        outs = torch.stack(outs, dim=1)  # [B, T, E]

        lens = (masks > 0).to(torch.int64).sum(dim=1)
        pool = getattr(opt, "vse_pool_type", "last")
        fmask = masks.to(outs.dtype)
        if pool == "mean":
            out = (outs * fmask[:, :T, None]).sum(dim=1) / \
                fmask.sum(dim=1, keepdim=True)
        elif pool == "max":
            out = (outs * fmask[:, :T, None] +
                   (fmask[:, :T, None] == 0) * -1e10).amax(dim=1)
        else:  # 'last': the output at position len-1
            idx = torch.clamp(lens - 1, 0, T - 1)
            out = torch.gather(outs, 1, idx[:, None, None].expand(
                B, 1, outs.shape[-1]))[:, 0]
        out = layers.l2norm(out)
        if opt.vse_use_abs:
            out = torch.abs(out)
        return out

    def forward(self, fc_feats, att_feats, seqs, masks, whole_batch=False,
                only_one_retrieval="off", max_violation_w=None):
        """The contrastive loss of images and captions (JAX vse.py:178-188;
        att_feats unused).  max_violation_w: the hinge weight as a tensor
        (blended), or None for the static opt.vse_max_violation."""
        del att_feats
        img_emb = self.encode_image(fc_feats)
        cap_emb = self.encode_text(seqs, masks)
        opt = self.opt
        mv = opt.vse_max_violation if max_violation_w is None \
            else max_violation_w
        return contrastive_loss(img_emb, cap_emb, opt.vse_margin, mv,
                                whole_batch, only_one_retrieval)
