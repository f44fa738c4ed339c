"""The device side of a fused K-step chunk (counterpart of the JAX
package's Trainer._chunk_fn, training/loop.py:623-675): one whole training
iteration -- the feature-cache gather, the forward with its device reward,
the backward, the step's learning rate and the guarded Adam update --
captured once and replayed once per staged step.  JAX scans K steps inside
one compiled program; here the host replays one captured iteration K
times, which removes the per-step Python enqueue of ~800 kernels (the
step's host time) but keeps one replay call per step.

The capture is a `collectives.SegmentPlan`: CUDA graphs that end at each
collective of the iteration, the collectives run eagerly between two
segments on static buffers.  Off a mesh the iteration has no collective
and is one graph.  On a (data, model) mesh the body is the per-step mesh
path's own step (parallel/train_step.py), so each replay runs the same
collectives in the same order on every rank: the loss normalisers, the
contrastive matrix's and the device reward's gathers, the vocabulary
slices' merges (and their backward's all-reduces, which autograd's device
thread runs), the gradients' all-reduce, the world's non-finite flag and
the global sums.  Under gloo a collective goes through the host between
two segments, which no capture could hold.

A chunk's inputs reach the device in one copy: every step's row (the
batch's cache indices, labels and masks, the learning rate, the `Hyper`
values, the padded refs) packed as float32 (`RowLayout`; ids and counts
are exact in float32 below 2^24), stacked [K, W]; a mesh rank keeps its
rows of it (`mesh.shard_batch_stacked`, `restack`).  Before each replay
one device-to-device copy puts step j's row into the static row buffer the
graphs read, and the iteration's named random streams are reseeded on the
host: their generators are registered with every segment
(`CUDAGraph.register_generator_state`), so a replay draws exactly the
noise that fresh generators of that seed draw in a per-step iteration.

What the graphs hold fixed, and how: shapes (B, L, the cache's K slots and
the refs' R are static; a short chunk replays fewer times); params, Adam
moments and counts, the skipped-step counter, the feature cache and the df
table are static buffers updated in place (`optim.guarded_update` copies,
never rebinds); the step's Python numbers (lr, Hyper) are read from the row;
the kernels launch on the current stream, which is the capture stream, and
their library is built by the eager warm-up iteration that precedes the
capture.  The Python launch counters count at capture: `launches` holds
the count of one replay, summed over its segments.  A capture that fails
raises; there is no eager fallback on the card.  On the CPU (the tests)
the same rows, buffers and body run eagerly, step by step.
"""

from __future__ import annotations

import numpy as np
import torch

from cooperativeimagecaptioning_tpu_torch.ops import draws
from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
from cooperativeimagecaptioning_tpu_torch.parallel import collectives
from cooperativeimagecaptioning_tpu_torch.training import joint
from cooperativeimagecaptioning_tpu_torch.utils.tree import trainable

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

    def unstack(self, rows):
        """float32 [K, width] tensor -> {name: [K, *shape]}."""
        return {name: rows[:, a:b].reshape((rows.shape[0],) + shape)
                for name, (a, b, shape) in self.slices.items()}


def restack(fields):
    """{name: [K, *shape]} tensors -> (float32 [K, width] rows, their
    RowLayout), the fields in the given order."""
    K = next(iter(fields.values())).shape[0]
    layout = RowLayout([(k, tuple(v.shape[1:])) for k, v in fields.items()])
    rows = torch.cat([v.reshape(K, -1).to(torch.float32)
                      for v in fields.values()], dim=1)
    return rows, layout


class FusedStep:
    """One captured iteration of `turn` (CUDA graphs on the card, eager
    steps on the CPU) over the trainer's live params, Adam state and
    feature cache.  `use_ss`: whether the steps draw scheduled-sampling
    noise (a per-step iteration draws it only while ss_prob > 0, so the
    iteration is captured for one or the other).  `layout`: the row of one
    step as this process reads it (on a mesh: the rank's rows)."""

    def __init__(self, trainer, turn, use_ss, layout):
        self.tr = trainer
        self.turn = turn
        self.use_ss = use_ss
        self.layout = layout
        self.device = trainer.device
        self.gens = joint.generators(self.device)
        self.streams = {name: draws.Draws(g) for name, g in
                        self.gens.items()}
        self.row = torch.zeros((layout.width,), dtype=torch.float32,
                               device=self.device)
        # the step's own leaves over the trainer's params' storage: autograd
        # binds a leaf to one node that accumulates its gradient, on the
        # stream where that node was made, and a Parameter the trainer used
        # before may keep such a node of another stream alive, which a
        # captured backward cannot wait on; these are first used on the
        # capture stream (the warm-up's), and Adam updates their storage in
        # place, so the trainer's params move with them
        self.params = {agent: trainable(tree)
                       for agent, tree in trainer.params.items()}
        self.plan = None
        self.out = None
        # the kernel launches of one replay (counted at capture, summed over
        # its segments), its segments and the collectives between them
        self.launches = None
        self.segments = None
        self.collectives = None
        self.replays = 0

    def _body(self):
        """One iteration from the static row: (loss, aux, ok).  The step is
        the per-step path's: on a mesh the distributed step (the rank's
        rows, the gradients summed over the data group, the world's
        non-finite flag, the global sums), else the loss and the guarded
        update."""
        tr = self.tr
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
        lr = x["lr"][0]
        if tr.mesh is not None:
            loss, aux = tr._mesh_steps[self.turn](
                self.params, tr.optim, batch, self.streams, hp, lr=lr)
        else:
            (loss, aux), grads = tr._grad_fns[self.turn](
                self.params, batch, self.streams, hp, None)
            tr.optim.step(self.params, grads, self.turn, lr)
        return loss, aux, tr.optim.last_step_ok

    def _capture(self):
        """Warm up with one eager iteration on a side stream (it builds the
        kernels' library and is a real step), then capture the next as
        segments between its collectives (one segment off a mesh)."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            out = self._body()
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        plan = collectives.SegmentPlan(self.device, side,
                                       self.gens.values())
        before = _dispatch.launches()
        with torch.cuda.stream(side), collectives.planned(plan):
            self.out = self._body()
        after = _dispatch.launches()
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.launches = {k: after[k] - before[k] for k in after}
        self.segments, self.collectives = plan.segments, len(plan.ops)
        self.plan = plan
        return out

    def run(self, rows_dev, seeds):
        """Run the staged steps: rows_dev [K, W] on the device, seeds [K]
        the iterations' stream seeds.  Returns per-step (losses [K], {aux
        key: [K]}, oks [K]) on the device."""
        outs = []
        for j, seed in enumerate(seeds):
            self.row.copy_(rows_dev[j])
            self.streams = joint.streams(seed, self.device, self.gens)
            if self.device.type != "cuda":
                out = self._body()
            elif self.plan is None:
                out = self._capture()
            else:
                self.plan.replay()
                self.replays += 1
                loss, aux, ok = self.out
                out = (loss.clone(), {k: v.clone() for k, v in aux.items()},
                       ok.clone())
            outs.append(out)
        losses = torch.stack([o[0] for o in outs])
        auxs = {k: torch.stack([o[1][k] for o in outs]) for k in outs[0][1]}
        oks = torch.stack([o[2] for o in outs])
        return losses, auxs, oks
