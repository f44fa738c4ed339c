"""FC speaker: the show-tell maxout-LSTM captioner (counterpart of the JAX
package's models/fc_model.py; ref models/FCModel.py, `--caption_model fc`).

Token conventions as the Att2in2 speaker's: 0 = EOS/pad, 1..V = words,
V+1 = BOS; the embedding has V+2 rows, the logit layer V+1 outputs.  The
image's fc feature enters as one step before BOS, through `img_embed`
(ref FCModel.py:97-99): `prefix_embeddings` hands it to the decoding loops,
which treat both speakers alike.

`FCModel` holds the JAX package's param tree (a ParamTree) and has the
Att2in2 speaker's methods.  Its cell is `cell_step.fused_cell` without
attention (`att_res=None`): the Hopper cell kernel on CUDA tensors.
Unlike the Att2in2 speaker, a token is embedded by a plain lookup (no ReLU,
no dropout), and dropout applies to next_h *before* it enters the recurrent
state (FCModel.py:39-42), so the dropped activation propagates.  Dropout
draws its mask from an explicit source or takes a mask drawn beforehand
(`EMBED_DROPOUT` tells the decoding loops that only the output mask is
drawn).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cooperativeimagecaptioning_tpu_torch.models import layers
from cooperativeimagecaptioning_tpu_torch.ops.kernels import cell_step
from cooperativeimagecaptioning_tpu_torch.parallel import vocab
from cooperativeimagecaptioning_tpu_torch.utils.tree import ParamTree, to_torch


def init_params(seed: int, opt, device="cpu"):
    """Random float32 params in the JAX tree layout, from a numpy seed
    (JAX fc_model.py:19-36: U(-0.1, 0.1) embedding and logit weight, zero
    logit bias)."""
    rng = np.random.RandomState(seed)
    V = opt.vocab_size
    D = opt.input_encoding_size
    H = opt.rnn_size
    params = {
        "img_embed": layers.linear_init(rng, opt.fc_feat_size, D),
        "core": {"i2h": layers.linear_init(rng, D, 5 * H),
                 "h2h": layers.linear_init(rng, H, 5 * H)},
        "embed": layers.uniform_init(rng, (V + 2, D), 0.1),
        "logit": {"w": layers.uniform_init(rng, (H, V + 1), 0.1),
                  "b": np.zeros((V + 1,), np.float32)},
    }
    return to_torch(params, device)


class FCModel(nn.Module):
    """The FC speaker over a param tree.  Calling it runs one `step`."""

    init_params = staticmethod(init_params)
    # teacher forcing discards the image step's output (ref
    # FCModel.py:125-127 drops outputs[0])
    TEACHER_FORCING_DROPS_PREFIX_OUTPUT = True
    # dropout of the embedded token: none (FCModel.py:61, 119)
    EMBED_DROPOUT = False

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
        """The FC speaker reads the fc features only."""
        del att_feats, att_masks, train, drop_prob, gen, rows
        return {"fc_feats": fc_feats}

    def prefix_embeddings(self, ctx):
        """The embedded image, consumed before the BOS step."""
        return [layers.linear(self.params.img_embed, ctx["fc_feats"])]

    def embed_token(self, ids, drop_prob=0.0, gen=None, mask=None):
        """A plain lookup: no ReLU, no dropout."""
        del drop_prob, gen, mask
        return layers.embedding_lookup(self.params.embed, ids)

    def embed_soft(self, soft_vec, drop_prob=0.0, gen=None, mask=None):
        """Soft / one-hot rows [B, V+2] times the table (either a rank's
        share on a vocab mesh: `vocab.soft_embed`)."""
        del drop_prob, gen, mask
        return vocab.soft_embed(soft_vec, self.params.embed)

    def step(self, ctx, state, xt, drop_prob=0.0, gen=None, mask=None):
        """One maxout-LSTM step (ref FCModel.py:24-43).  Returns ((next_h,
        next_c), output); with drop_prob > 0 the dropped next_h is both the
        output and the recurrent state."""
        del ctx
        h_prev, c_prev = state
        core = self.params.core
        next_h, next_c = cell_step.fused_cell(
            xt, h_prev, c_prev, None, core.i2h.w, core.i2h.b, core.h2h.w,
            core.h2h.b, None, None)
        if drop_prob > 0.0:
            next_h = layers.dropout(next_h, drop_prob, gen, mask)
        return (next_h, next_c), next_h

    forward = step

    def logits(self, out):
        return layers.linear(self.params.logit, out)
