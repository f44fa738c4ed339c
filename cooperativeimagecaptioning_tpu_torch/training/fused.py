"""The device side of a fused K-step chunk (counterpart of the JAX
package's Trainer._chunk_fn, training/loop.py:623-675): one whole training
iteration -- the feature-cache gather, the forward with its device reward,
the backward, the step's learning rate and the guarded Adam update --
captured once as a `torch.cuda.CUDAGraph` and replayed once per staged step.
JAX scans K steps inside one compiled program; here the host replays one
captured iteration K times, which removes the per-step Python enqueue of
~800 kernels (the step's host time) but keeps one replay call per step.

A chunk's inputs reach the device in one copy: every step's row (the
batch's cache indices, labels and masks, the learning rate, the `Hyper`
values, the padded refs) packed as float32 (`RowLayout`; ids and counts
are exact in float32 below 2^24), stacked [K, W].  Before each replay one
device-to-device copy puts step j's row into the static row buffer the
graph reads, and the iteration's named random streams are reseeded on the
host: their generators are registered with the graph
(`CUDAGraph.register_generator_state`), so a replay draws exactly the
noise that fresh generators of that seed draw in a per-step iteration.

What the graph holds fixed, and how: shapes (B, L, the cache's K slots and
the refs' R are static; a short chunk replays fewer times); params, Adam
moments and counts, the skipped-step counter, the feature cache and the df
table are static buffers updated in place (`optim.guarded_update` copies,
never rebinds); the step's Python numbers (lr, Hyper) are read from the row;
the kernels launch on the current stream, which is the capture stream, and
their library is built by the eager warm-up iteration that precedes the
capture.  The Python launch counters count at capture: `launches` holds
the count of one replay.  A capture that fails raises; there is no eager
fallback on the card.  On the CPU (the tests) the same rows, buffers and
body run eagerly, step by step.
"""

from __future__ import annotations

import numpy as np
import torch

from cooperativeimagecaptioning_tpu_torch.ops import draws
from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
from cooperativeimagecaptioning_tpu_torch.training import joint
from cooperativeimagecaptioning_tpu_torch.training.optim import (
    agents_to_update, guarded_update)

N_HYPER = len(joint.Hyper._fields)


class RowLayout:
    """Named fields of one step's row: [(name, shape)] packed in order into
    a float32 vector of `width` entries."""

    def __init__(self, fields):
        self.fields = list(fields)
        self.slices = {}
        pos = 0
        for name, shape in self.fields:
            n = int(np.prod(shape))
            self.slices[name] = (pos, pos + n, tuple(shape))
            pos += n
        self.width = pos

    def pack(self, values):
        """{name: array} -> float32 [width]."""
        row = np.empty((self.width,), np.float32)
        for name, (a, b, shape) in self.slices.items():
            v = np.asarray(values[name], np.float32)
            if v.shape != shape:
                raise ValueError(f"row field {name}: shape {v.shape}, "
                                 f"expected {shape}")
            row[a:b] = v.reshape(-1)
        return row

    def unpack(self, row):
        """float32 [width] tensor -> {name: view of `shape`}."""
        return {name: row[a:b].view(shape)
                for name, (a, b, shape) in self.slices.items()}


class FusedStep:
    """One captured iteration of `turn` (a CUDA graph on the card, eager
    steps on the CPU) over the trainer's live params, Adam state and
    feature cache.  `use_ss`: whether the steps draw scheduled-sampling
    noise (a per-step iteration draws it only while ss_prob > 0, so the
    graph is captured for one or the other)."""

    def __init__(self, trainer, turn, use_ss, layout):
        self.tr = trainer
        self.turn = turn
        self.use_ss = use_ss
        self.layout = layout
        self.device = trainer.device
        opt = trainer.opt
        self.agents = tuple(a for a in agents_to_update(opt, turn)
                            if a in trainer.params)
        self.gens = joint.generators(self.device)
        self.streams = {name: draws.Draws(g) for name, g in
                        self.gens.items()}
        self.row = torch.zeros((layout.width,), dtype=torch.float32,
                               device=self.device)
        self.graph = None
        self.out = None
        # the kernel launches of one replay (counted at capture)
        self.launches = None
        self.replays = 0

    def _body(self):
        """One iteration from the static row: (loss, aux, ok)."""
        tr, opt = self.tr, self.tr.opt
        x = self.layout.unpack(self.row)
        batch = {"labels": x["labels"].to(torch.int64), "masks": x["masks"]}
        batch["fc_feats"], batch["att_feats"], batch["att_masks"] = \
            tr._gather_cached(x["idx"].to(torch.int64))
        if "refs" in x:
            batch["refs"] = x["refs"].to(torch.int64)
            batch["ref_mask"] = x["ref_mask"]
            if tr._df_table is not None:
                batch["df_table"] = tr._df_table
        hp = joint.Hyper(*x["hp"].unbind(0))
        if not self.use_ss:
            hp = hp._replace(ss_prob=0.0)
        (loss, aux), grads = tr._grad_fns[self.turn](
            tr.params, batch, self.streams, hp, None)
        ok = guarded_update(opt, tr.params, grads, tr.optim.states,
                            self.agents, x["lr"])
        tr.optim._skipped += (~ok).to(torch.int32)
        return loss, aux, ok

    def _capture(self):
        """Warm up with one eager iteration on a side stream (it builds the
        kernels' library and is a real step), then capture the next."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            out = self._body()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        for gen in self.gens.values():
            graph.register_generator_state(gen)
        before = _dispatch.launches()
        with torch.cuda.graph(graph):
            self.out = self._body()
        after = _dispatch.launches()
        self.launches = {k: after[k] - before[k] for k in after}
        self.graph = graph
        return out

    def run(self, rows_dev, seeds):
        """Run the staged steps: rows_dev [K, W] on the device, seeds [K]
        the iterations' stream seeds.  Returns per-step (losses [K], {aux
        key: [K]}, oks [K]) on the device."""
        outs = []
        for j, seed in enumerate(seeds):
            self.row.copy_(rows_dev[j])
            joint.streams(seed, self.device, self.gens)
            if self.device.type != "cuda":
                out = self._body()
            elif self.graph is None:
                out = self._capture()
            else:
                self.graph.replay()
                self.replays += 1
                loss, aux, ok = self.out
                out = (loss.clone(), {k: v.clone() for k, v in aux.items()},
                       ok.clone())
            outs.append(out)
        losses = torch.stack([o[0] for o in outs])
        auxs = {k: torch.stack([o[1][k] for o in outs]) for k in outs[0][1]}
        oks = torch.stack([o[2] for o in outs])
        return losses, auxs, oks
