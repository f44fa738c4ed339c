"""The FC speaker in plain PyTorch (published models/FCModel.py, the
show-tell maxout LSTM): the image's fc feature, embedded by img_embed, is
the input of one step before the first token, whose output teacher
forcing discards; tokens are embedded by a plain lookup; dropout acts on
the new hidden state, which then is both the output and the state.
Initialisation (FCModel.init_weights): U(-0.1, 0.1) for the embedding and
the logit weight, a zero logit bias, nn.Linear's default elsewhere."""

from __future__ import annotations

from portbench.reference import common

EMBED_DROPOUT = False
STATE_DROPOUT = True
USES_ATT = False


def leaves(cfg):
    V, D = cfg["vocab_size"], cfg["input_encoding_size"]
    H, F = cfg["rnn_size"], cfg["fc_feat_size"]

    def lin(path, n_in, n_out):
        s = n_in ** -0.5
        return [(f"{path}.w", (n_in, n_out), s), (f"{path}.b", (n_out,), s)]

    return (lin("img_embed", F, D) + lin("core.i2h", D, 5 * H)
            + lin("core.h2h", H, 5 * H) + [("embed", (V + 2, D), 0.1),
                                           ("logit.w", (H, V + 1), 0.1),
                                           ("logit.b", (V + 1,), 0.0)])


def encode(p, feats, gen=None, rate=0.0, q=None):
    return {"fc": feats["fc"]}


def prefix(p, ctx, q=None):
    q = q or (lambda x: x)
    return [q(ctx["fc"]) @ q(p["img_embed"]["w"]) + p["img_embed"]["b"]]


def embed(p, ids):
    return p["embed"][ids]


def step(p, ctx, h, c, xt, q=None):
    return common.maxout_cell(p["core"], xt, h, c, None, q)


def select_rows(ctx, rows):
    return {k: v[rows] for k, v in ctx.items()}


def flops_encode(cfg, K):
    return 0


def flops_prefix(cfg):
    """img_embed and one cell step, a row."""
    D, H, F = cfg["input_encoding_size"], cfg["rnn_size"], cfg["fc_feat_size"]
    return 2 * F * D + 2 * (D * 5 * H + H * 5 * H)


def flops_step(cfg, K):
    V, D, H = cfg["vocab_size"], cfg["input_encoding_size"], cfg["rnn_size"]
    return 2 * (D * 5 * H + H * 5 * H) + 2 * H * (V + 1)
