"""The Att2in2 speaker in plain PyTorch (published models/AttModel.py,
`--caption_model att2in2`): the attention features embedded once per
image, additive attention from the previous hidden state, the attention
vector entering the maxout cell's input transform only (a2c).

    att_embed: Linear(att_feat, H) -> ReLU -> Dropout;  ctx2att: Linear(H, A)
    embed:     Embedding(V + 2, D) -> ReLU -> Dropout
    attention: w = softmax(alpha(tanh(p_att + h2att(h)))), times the mask
               and renormalised; att_res = sum_k w_k emb_k
    logit:     Linear(H, V + 1); dropout on the output, not on the state
"""

from __future__ import annotations

import torch

from portbench.reference import common

EMBED_DROPOUT = True   # the embedded token is dropped out
STATE_DROPOUT = False  # dropout on the output only; the state keeps h
USES_ATT = True


def leaves(cfg):
    """[(path, shape, U(-scale, scale))]: nn.Linear's default bound
    1/sqrt(in) for every linear layer, U(-0.1, 0.1) for the embedding
    (AttModel.init_weights)."""
    V, D = cfg["vocab_size"], cfg["input_encoding_size"]
    H, A, F = cfg["rnn_size"], cfg["att_hid_size"], cfg["att_feat_size"]

    def lin(path, n_in, n_out):
        s = n_in ** -0.5
        return [(f"{path}.w", (n_in, n_out), s), (f"{path}.b", (n_out,), s)]

    return ([("embed", (V + 2, D), 0.1)] + lin("att_embed", F, H)
            + lin("ctx2att", H, A) + lin("core.a2c", H, 2 * H)
            + lin("core.i2h", D, 5 * H) + lin("core.h2h", H, 5 * H)
            + lin("core.attention.h2att", H, A)
            + lin("core.attention.alpha_net", A, 1) + lin("logit", H, V + 1))


def encode(p, feats, gen=None, rate=0.0, q=None):
    """{'emb' [B, K, H], 'p_att' [B, K, A], 'mask' [B, K]} of feats
    {'att': [B, K, F], 'att_mask': [B, K]}; in training the embedded
    features are dropped out with a mask drawn from `gen`."""
    q = q or (lambda x: x)
    att = feats["att"]
    emb = torch.relu(q(att) @ q(p["att_embed"]["w"]) + p["att_embed"]["b"])
    if rate > 0.0:
        emb = common.dropout(emb, common.keep_mask(gen, emb.shape, rate,
                                                   emb.device), rate)
    p_att = q(emb) @ q(p["ctx2att"]["w"]) + p["ctx2att"]["b"]
    return {"emb": emb, "p_att": p_att, "mask": feats["att_mask"]}


def prefix(p, ctx, q=None):
    """No input before the first token."""
    return []


def embed(p, ids):
    return torch.relu(p["embed"][ids])


def attention(p, h, ctx, q=None):
    q = q or (lambda x: x)
    a = p["core"]["attention"]
    att_h = q(h) @ q(a["h2att"]["w"]) + a["h2att"]["b"]
    dot = torch.tanh(ctx["p_att"] + att_h[:, None, :])
    scores = (q(dot) @ q(a["alpha_net"]["w"]))[..., 0] + a["alpha_net"]["b"]
    w = torch.softmax(scores, dim=1)
    if ctx["mask"] is not None:
        w = w * ctx["mask"]
        w = w / w.sum(dim=1, keepdim=True)
    return torch.einsum("bk,bkh->bh", w, ctx["emb"])


def step(p, ctx, h, c, xt, q=None):
    """One step from (h, c) and the embedded input: (h', c')."""
    att_res = attention(p, h, ctx, q)
    return common.maxout_cell(p["core"], xt, h, c, att_res, q)


def select_rows(ctx, rows):
    return {k: None if v is None else v[rows] for k, v in ctx.items()}


def flops_encode(cfg, K):
    """Product FLOPs (2 m n k) of embedding one image's K regions."""
    H, A, F = cfg["rnn_size"], cfg["att_hid_size"], cfg["att_feat_size"]
    return 2 * K * F * H + 2 * K * H * A


def flops_step(cfg, K):
    """Product FLOPs of one step of one row: att_h, the scores, the
    weighted sum, the cell's three products and the logits."""
    V, D = cfg["vocab_size"], cfg["input_encoding_size"]
    H, A = cfg["rnn_size"], cfg["att_hid_size"]
    attention_ = 2 * H * A + 2 * K * A + 2 * K * H
    cell = 2 * (D * 5 * H + H * 5 * H + H * 2 * H)
    return attention_ + cell + 2 * H * (V + 1)


def flops_prefix(cfg):
    return 0
