"""Att2in2 speaker (counterpart of the JAX package's models/att_model.py;
ref models/AttModel.py, `--caption_model att2in2`).

  embed:     Embedding(V+2, D) -> ReLU
  att_embed: [BatchNorm?] Linear(att_feat, H) -> ReLU
  ctx2att:   Linear(H, A), once per sequence ("p_att_feats")
  core:      maxout LSTM; the attention vector enters only the cell-input
             path through a2c (AttModel.py:521-525)
  logit:     Linear(H, V+1)

`init_params` makes the JAX package's param tree; `AttModel` is the speaker
as an nn.Module holding that tree (a ParamTree under `.params`, so a JAX
tree loads by copy and `.to(device, dtype)` moves and casts it).  Its
methods are the JAX module's functions without the params argument.

`step` runs the attention through the fused kernel's wrapper (a Hopper
kernel on CUDA tensors, its plain version on CPU tensors) and the cell
through `fused_cell` (the Hopper cell kernel on CUDA tensors, the plain
cell on CPU tensors); both carry gradients.  The context
of `encode_features` is b-major; `quantize_ctx` (int8) and `kmajor_ctx`
(K-major) turn it into one of the two decode-only layouts, and `step` picks
the attention kernel by the context's keys.  Dropout (training) draws from
an explicit source (a torch.Generator or a draw source, ops/draws.py), or
takes masks drawn beforehand (the decoding loops draw them outside their
checkpointed steps).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cooperativeimagecaptioning_tpu_torch.models import layers
from cooperativeimagecaptioning_tpu_torch.ops.kernels import att_step, cell_step
from cooperativeimagecaptioning_tpu_torch.parallel import collectives, vocab
from cooperativeimagecaptioning_tpu_torch.utils.tree import ParamTree, to_torch


def init_params(seed: int, opt, device="cpu"):
    """Random float32 params in the JAX tree layout, from a numpy seed."""
    rng = np.random.RandomState(seed)
    V = opt.vocab_size
    D = opt.input_encoding_size
    H = opt.rnn_size
    A = opt.att_hid_size
    params = {
        "embed": layers.uniform_init(rng, (V + 2, D), 0.1),
        "att_embed": layers.linear_init(rng, opt.att_feat_size, H),
        "ctx2att": layers.linear_init(rng, H, A),
        "core": {
            "a2c": layers.linear_init(rng, H, 2 * H),
            "i2h": layers.linear_init(rng, D, 5 * H),
            "h2h": layers.linear_init(rng, H, 5 * H),
            "attention": layers.attention_init(rng, H, A),
        },
        "logit": layers.linear_init(rng, H, V + 1),
    }
    if getattr(opt, "use_bn", 0):
        F = opt.att_feat_size
        params["att_bn"] = {"scale": np.ones(F, np.float32),
                            "bias": np.zeros(F, np.float32),
                            "mean": np.zeros(F, np.float32),
                            "var": np.ones(F, np.float32)}
    return to_torch(params, device)


class AttModel(nn.Module):
    """The Att2in2 speaker over a param tree from `init_params` (or a JAX
    checkpoint).  Calling it runs one decode `step`."""

    init_params = staticmethod(init_params)
    # no pre-BOS step whose output teacher forcing would discard
    TEACHER_FORCING_DROPS_PREFIX_OUTPUT = False
    # dropout of the embedded token (ref AttModel.py:74-76)
    EMBED_DROPOUT = True

    def __init__(self, params: dict):
        super().__init__()
        self.params = ParamTree(params)

    def init_state(self, batch_size: int):
        w = self.params.core.h2h.w
        z = torch.zeros((batch_size, w.shape[0]), dtype=w.dtype,
                        device=w.device)
        return (z, z.clone())

    def encode_features(self, fc_feats, att_feats, att_masks, train=False,
                        drop_prob=0.0, gen=None, rows=None):
        """Embed the attention features once per sequence (ref
        AttModel.py:108-114).  With `att_bn`, BatchNorm1d runs first: on its
        running statistics when the tree has them and `train` is false, else
        on batch statistics over the real (masked) positions, else over all
        positions (JAX att_model.py:74).  `rows`, the data group of a mesh
        run whose ranks hold shares of the batch's rows, makes them the
        global batch's statistics (`batch_stats`).  In training, dropout on
        the embedded features."""
        del fc_feats  # att2in2 never reads the fc features
        p = self.params
        x = att_feats
        if hasattr(p, "att_bn"):
            bn = p.att_bn
            if hasattr(bn, "mean") and not train:
                mean, var = bn.mean, bn.var
            else:
                mean, var, _ = batch_stats(x, att_masks, rows, 1.0)
            x = (x - mean) / torch.sqrt(var + 1e-5)
            x = x * bn.scale + bn.bias
            # the mask promotes bf16 statistics to f32; the context stays in
            # the params' dtype, the one dtype the attention kernel takes
            x = x.to(p.att_embed.w.dtype)
        emb = torch.relu(layers.linear(p.att_embed, x))
        if train and drop_prob > 0.0:
            emb = layers.dropout(emb, drop_prob, gen)
        p_att = layers.linear(p.ctx2att, emb)
        return {"att_feats": emb, "p_att_feats": p_att, "att_masks": att_masks}

    @staticmethod
    def kmajor_ctx(ctx):
        """Decode-time K-major context layout (--att_kmajor; JAX
        att_model.py:100-111): one transpose per sequence stores the context
        [K, B, *].  Composes like quantize_ctx; decode only -- training
        keeps the b-major layout.  The masks stay b-major [B, K], so beam
        expansion repeats them along axis 0 like a b-major entry."""
        return {"att_feats_t": ctx["att_feats"].movedim(1, 0).contiguous(),
                "p_att_t": ctx["p_att_feats"].movedim(1, 0).contiguous(),
                "att_masks": ctx["att_masks"]}

    @staticmethod
    def quantize_ctx(ctx):
        """int8-quantize the per-sequence attention context for decode
        (--att_quant int8; JAX att_model.py:142-155).  att_feats and
        p_att_feats are constant across the decode steps; per-(b,k)-row int8
        halves their footprint in device memory against bf16.  Training
        keeps the full-precision context."""
        eq, se, pq, sp = att_step.quantize_features(
            ctx["att_feats"], ctx["p_att_feats"])
        return {"att_feats_q": eq, "att_scale": se,
                "p_att_q": pq, "p_att_scale": sp,
                "att_masks": ctx["att_masks"]}

    def prefix_embeddings(self, ctx):
        """No pre-BOS inputs for the attention model."""
        del ctx
        return []

    def embed_token(self, ids, drop_prob=0.0, gen=None, mask=None):
        """Embedding -> ReLU -> Dropout (ref AttModel.py:74-76).  Dropout
        runs when drop_prob > 0, with `mask` or a draw from `gen`."""
        x = torch.relu(layers.embedding_lookup(self.params.embed, ids))
        if drop_prob > 0.0:
            x = layers.dropout(x, drop_prob, gen, mask)
        return x

    def embed_soft(self, soft_vec, drop_prob=0.0, gen=None, mask=None):
        """Soft-vector embedding (ref AttModel.py:395-397; JAX
        att_model.py:172-178): soft_vec [B, V+2] times the raw table, then
        ReLU and dropout, as embed_token.  On a vocab mesh either operand
        may be a rank's share (`vocab.soft_embed`)."""
        x = torch.relu(vocab.soft_embed(soft_vec, self.params.embed))
        if drop_prob > 0.0:
            x = layers.dropout(x, drop_prob, gen, mask)
        return x

    def step(self, ctx, state, xt, drop_prob=0.0, gen=None, mask=None):
        """One Att2in2 step (ref AttModel.py:510-531): attention from the
        previous hidden state, then the maxout-LSTM core.  Returns
        ((next_h, next_c), output).  Dropout (drop_prob > 0) applies to the
        output only: the recurrent state keeps the clean next_h (JAX
        att_model.py:213-216)."""
        h_prev, c_prev = state
        core = self.params.core
        ap = core.attention
        weights = (ap.h2att.w, ap.h2att.b, ap.alpha_net.w, ap.alpha_net.b,
                   ctx["att_masks"])
        if "att_feats_t" in ctx:
            att_res = att_step.fused_attention_kmajor(
                h_prev, ctx["att_feats_t"], ctx["p_att_t"], *weights)
        elif "att_feats_q" in ctx:
            att_res = att_step.fused_attention_q(
                h_prev, ctx["att_feats_q"], ctx["att_scale"], ctx["p_att_q"],
                ctx["p_att_scale"], *weights)
        else:
            att_res = att_step.fused_attention(
                h_prev, ctx["att_feats"], ctx["p_att_feats"], *weights)
        next_h, next_c = cell_step.fused_cell(
            xt, h_prev, c_prev, att_res, core.i2h.w, core.i2h.b, core.h2h.w,
            core.h2h.b, core.a2c.w, core.a2c.b)
        out = next_h
        if drop_prob > 0.0:
            out = layers.dropout(out, drop_prob, gen, mask)
        return (next_h, next_c), out

    forward = step

    def logits(self, out):
        """out @ W + b; on a vocab mesh this rank's slice of the logits,
        with out's gradient summed over the model group."""
        p = self.params.logit
        return layers.linear(p, vocab.into_shard(out, p.w))


def batch_stats(x, att_masks, rows=None, min_count=1.0, keepdim=True):
    """(mean, biased variance, count) of the att features x [B, K, F] over
    the real (masked) positions, or over all positions without masks, the
    count clamped at `min_count` where masks weigh it.  With `rows` (a mesh
    run's data group; each rank holds a share of the batch's rows) they are
    the global batch's, in JAX's two passes: the global mean (sums and
    count all-reduced), then the global sum of squared deviations from it.
    Statistics of the inputs: no gradient flows through the collectives."""
    dims = (0, 1)
    # a mask weighs in f32, as the masks do
    w = att_masks[..., None] if att_masks is not None else torch.ones(
        x.shape[:2] + (1,), dtype=torch.float32, device=x.device)
    n = collectives.all_reduce(w.sum(), rows)
    if att_masks is not None:
        n = torch.clamp(n, min=min_count)
    mean = collectives.all_reduce((x * w).sum(dim=dims, keepdim=keepdim),
                                  rows) / n
    var = collectives.all_reduce((torch.square(x - mean) * w).sum(
        dim=dims, keepdim=keepdim), rows) / n
    return mean, var, n


def bn_running_update(params, att_feats, att_masks, momentum=0.1,
                      rows=None):
    """EMA-update the att BN running statistics from one batch (JAX
    att_model.py:114-139; torch BatchNorm1d train-mode semantics: momentum
    0.1, unbiased variance; with masks the count is clamped at 2).  Takes and
    returns a speaker tree (dict); leaves other than the statistics are
    passed through.  `rows`: the data group of a mesh run, whose ranks hold
    shares of the batch's rows (the global batch's statistics, the same
    update on every rank).  Call it without autograd."""
    bn = params.get("att_bn")
    if bn is None or "mean" not in bn:
        return params
    mean, var, n = batch_stats(att_feats, att_masks, rows, 2.0,
                               keepdim=False)
    var_unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
    bn = dict(bn)
    bn["mean"] = (1 - momentum) * bn["mean"] + momentum * mean
    bn["var"] = (1 - momentum) * bn["var"] + momentum * var_unbiased
    out = dict(params)
    out["att_bn"] = bn
    return out
