#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one Hopper GPU (H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device   -- a CUDA device of capability 9.0; prints the card's name and
                 power limit (nvidia-smi).
  2. build    -- builds the C++ host library (native/, g++; it must
                 build) and the hand-written kernels from the package's csrc/
                 with nvcc (timed) and prints the registers, stack and
                 spills ptxas reports for the heads' two tensor-core passes
                 (bf16 wgmma, f32 split TF32), the attention's pre-pass and
                 stream kernels and the cell's three kernels (no spill
                 allowed).
  3. kernels  -- each kernel against its plain PyTorch version on the card,
                 at the shapes the paths give it, in float32 and bfloat16:
                 attention (masked and unmasked; the b-major, the int8 and
                 the K-major kernels at the training step's B=128, the
                 service's B=512, 4096 and beam-expanded R=1024 and at the
                 evaluation's R=256 and 640 rows, all at K=36, and at K=196,
                 the repo's own 14 x 14 feature grid, at B=128 and 512; the
                 b-major and the K-major kernel timed at bf16 B=512, 1024,
                 4096 and f32 B=128, 256, 640 and bf16 B=512 K=196, the int8
                 kernel beside them at bf16 B=512, 4096, B=512 K=196 and f32
                 B=128; their att_h pre-pass alone against h @ W + b and
                 timed; every such launch must take the 16-byte vector width;
                 the int8 kernel at H=A=40 must take width 1),
                 the quantizer on the card against the same function on the
                 CPU, greedy head and beam head (random rows and rows with
                 exact ties planted at every seam of the tensor-core pass's
                 merge, which must resolve to the lower id: greedy at B=512,
                 4096 and 300 rows; beam kk = 2, 3, 6, 16 at R=1024 and kk = 2
                 at the evaluation's R=256, at 300 and at 8192 rows, and kk =
                 17, 32, 64 at R=1024, in rounds of 16, with a group of 24
                 tied ids across the rounds' seam; greedy also at the f32
                 paths' R=128; every bf16 launch must take the wgmma pass,
                 every f32 launch the split-TF32 pass, and an f32 W that
                 does not start on 16 bytes the FMA pass).
                 Each check prints its maximum error beside its tolerance;
                 each kernel is timed beside its plain version.  The fused
                 maxout-LSTM cell (kernel F) against its plain version with
                 and without attention, f32 at B=128, 256, 640 and f32 /
                 bf16 at B=512, 4096 and 130 (a partial row tile), and at
                 D=H=500 (no multiple of 8); every aligned f32 launch must
                 take the split-TF32 kernel, every aligned bf16 launch the
                 tensor-core kernel, D=H=500 the FMA kernel; timed beside
                 cell_reference (f32 also beside the split product's floor
                 and the three products alone through torch.matmul), and
                 the f32 kernel must beat cell_reference at B = 128-640;
                 the attention's autograd Function (kernel forward,
                 recomputed backward; the b-major and the int8 call) against
                 plain autograd, f32 at B=128.  Every timed shape gets its own
                 bound: the larger of its bytes over the card's memory rate
                 and its operations over the card's peak rate.  The heads are
                 timed at B=512 and 4096 (greedy) and R=1024 and 8192 (beam,
                 kk=2) in bf16, and in f32 at the f32 paths' shapes (greedy
                 R=128 and 512, beam kk=2 at R=256 and 1024, and the vocab
                 slices of a model axis of 2: R=256 kk=2 and R=128 kk=1),
                 each beside torch.matmul of h @ w alone, a yardstick the
                 port never calls (f32 with TF32 off), and in f32 beside the
                 split product's floor (three TF32 products at 495
                 TFLOP/s).
  4. slice    -- writes a full-width run dir (Att2in2, vocab 9487, 512-wide,
                 K=36, L=16, random weights from a numpy seed), serves it
                 through CaptioningService.from_run_dir + warmup +
                 make_http_server (greedy and beam 2, bf16), checks the
                 answers and that every request went through the kernels
                 (launch counts; every head launch of a bf16 service on the
                 wgmma pass, of an f32 service on the split-TF32 pass),
                 compares the CUDA services with CPU
                 services (plain versions) in float32 and in bfloat16, and
                 times captions/s.  Then the same for the two other decode
                 layouts of the attention context, att_quant="int8" and
                 att_kmajor=1 (every step through their own attention
                 kernel, none through the b-major one), their ids against the
                 b-major and the CPU services in float32, captions/s of the
                 three layouts side by side, and the device memory of a
                 bucket-4096 request in bf16 and int8.  Then services through
                 from_run_dir(max_att_len=196) fed 196-slot features (greedy
                 and beam 2, bf16 and f32; every step through the attention
                 kernel; f32 ids against the CPU service's), and a run dir
                 whose checkpoint lacks a leaf, which from_run_dir must
                 report and fill.  Every step runs the cell kernel (the
                 tensor-core kernel for bf16, split TF32 for f32).
  5. training -- phase-2 MLE training at full width through
                 training.loop.train / Trainer over the shared
                 SyntheticDataset (f32, B=128, drop_prob_lm 0.5): the
                 attention and cell launch counts of
                 three steps (2*T each per step: forward, and the
                 checkpointed recompute in backward); the first step at
                 B=16 on the card against the same step on the CPU port
                 (loss and every gradient leaf); the loss falling over 20
                 steps on one batch; it/s;
                 Trainer.checkpoint_operations, which evaluates and writes
                 the trained speaker's run dir (model, optimizer, infos,
                 histories); and that run dir served once (greedy, bucket
                 512).
  6. evaluation -- the trained speaker's run dir through eval.eval (the
                 final-eval protocol: beam 2, language metrics, the test
                 split of a SyntheticDataset) and Evaluator.eval_split on the
                 card, once each with the b-major, the int8 and the K-major
                 context: one prediction per image, finite loss and metrics,
                 the launch counts the batch count and L give, the batches
                 drained inside the loop (twelve batches a split, four in
                 flight), the evaluator's timings and images/s.  Then the
                 first batches on the card against the CPU port, beam 2:
                 the captions and loss_cap of phase 4's random-weight
                 speaker with each layout, and of the trained speaker.
  7. scst     -- self-critical CIDEr-D training at full width (f32, B=128,
                 drop_prob_lm 0.5; scripts/run_joint.py's flag set at -D 0,
                 phase 3, not alternating), resumed from phase 5's run dir
                 by Trainer(start_from=...): params, every Adam leaf and the
                 counters equal the files; five iterations, each with finite
                 loss_cider, avg_reward and cider_greedy and stage B's
                 sampled ids equal to stage A's, the launch counts of A, B
                 and F per iteration asserted; the time split of an
                 iteration (stage A, host reward, stage B forward +
                 backward, Adam) and it/s; the first step at B=16 on the
                 card against the CPU port fed the same noise (equal rows,
                 loss_cider, gradients); Evaluator.eval_split with
                 sample_max 0 and 2 under each of the three layouts;
                 checkpoint_operations on the SCST trainer (the eval loss
                 with its CIDEr-D term), then from_run_dir over that dir
                 serving one bucket-512 greedy request; and a joint run dir
                 (phase 4's speaker with its embedding at
                 listener/txt_enc/embed, share_embed=1) through eval.eval
                 and from_run_dir, with the captions and ids of phase 4's
                 speaker-only dir.
  8. listener -- the VSE listener at the config's defaults (vse_embed 1024,
                 GRU, 'last' pooling, margin 0.2, max violation), f32,
                 B=128: (a) phase 1 (scripts/run_fc_con.py's flag set, FC
                 speaker) through loop.train and Trainer.train: no kernel
                 launched, only listener leaves move, the B=16 step against
                 the CPU port, loss_vse falling over 20 steps on one batch,
                 it/s, checkpoint_operations ranking val and test and
                 writing the stage-1 run dir; (b) run_joint.py -o gumbel
                 seeded from phase 5's speaker and (a)'s listener (params
                 and both Adam states equal the files), five iterations:
                 finite
                 losses, stage B's ids equal stage A's, both agents move,
                 the launches of A, B and F an iteration, the time split
                 and it/s; (c) the B=16 step of each relaxed mode on the
                 card against the CPU port replaying its draws; (d)
                 checkpoint_operations (generated-caption and GT ranks,
                 the alternating artifacts), eval.eval with the trained and
                 the ground-truth listener, the rank arrays of every
                 split against the CPU port's, the rank pass at the
                 protocol's size; (e) the
                 FC speaker served from (a)'s run dir, greedy and beam 2,
                 f32 and bf16, every step through B or C and F, f32 ids
                 against the CPU service.
  9. mesh     -- the (data, model) process grid, its ranks sharing the one
                 card over gloo (one process each, started by the port's
                 launcher after the build, so that no two run nvcc):
                 head_merge against its plain version (the gathered
                 candidates of a logit layer split in two, ties across the
                 shard seam, m = 1, 2, 17, 32) and timed; a two-rank world:
                 (1, 2) -- the sharded heads against the plain heads on the
                 whole layer (ties across the seam), Evaluator.eval_split of
                 phase 4's and phase 5's speakers, f32, beam 2 and greedy,
                 against the single-process evaluator on the card (>= 99%
                 of the captions, loss_cap), C and head_merge L times a
                 decode on every rank and B never; (2, 1) -- phase-2 MLE at
                 B=128, three steps against the
                 single-process Trainer (loss rtol 2e-5, params), it/s,
                 checkpoint_operations writing a mesh run dir, eval.eval on
                 it; a four-rank world, (2, 2): one training step and one
                 evaluation batch; phase 1 and phase 3 on the mesh
                 (`check_mesh_joint`): the single-process Trainer on the
                 card before the two-rank world, and in that world after
                 its phase-2 training -- (2, 1): three iterations
                 each of SCST with the device reward, run_joint.py -o
                 gumbel and -o reinforce -v 1 (turns speaker, listener,
                 speaker; audited), every iteration's sampled rows (all in
                 the first, >= 99%) and loss (rtol 2e-5) against the
                 single process's, A, B and F per rank and iteration equal
                 to its counts; (1, 2): two iterations of -o gumbel over
                 the split vocabulary with its Evaluator first (beam 1, the generated and the GT
                 captions' ranks: captions, eval loss, rsum), A and F equal,
                 C in place of every B launch, head_merge also merging each
                 categorical draw over the slices (>= 2L an iteration);
                 it/s, traced kernel ms and idle share of an iteration per
                 rank beside the single process's; and a world of one rank
                 over NCCL (one all_gather, one all_reduce through the
                 port's helpers).  Its it/s and images/s are of ranks
                 sharing one card, not a scaling figure.
 10. reinforce -- joint REINFORCE at full width (f32, B=128), seeded as
                 8(b) from phase 5's speaker and 8(a)'s listener, under
                 audit_grad_isolation: (a) run_joint.py -o reinforce -v 1
                 (the gt baseline) with real speaker / listener
                 alternation, six iterations, every iteration's launches of
                 A, B and F
                 against its turn's (a speaker turn as an SCST iteration, a
                 listener turn one sampled decode), stage B's ids equal
                 stage A's, the stage split and it/s of each turn, with and
                 without the audit; (b) the greedy and the no baseline (the
                 greedy one adds a greedy decode to a speaker turn); (c) the
                 reinforce_listener and reinforce_speaker ablations through
                 loop.train, only the expected agent moved; (d) the B=16
                 speaker step of each baseline and a listener turn on the
                 card against the CPU port on recorded draws (all rows
                 equal, losses to 1e-4, gradients by phase 5's rule, the
                 frozen agent's gradient zero); (e) checkpoint_operations at
                 an odd iteration, a Trainer resumed from it (params and
                 Adam states equal, its next turn the listener's), eval.eval
                 on the run dir (beam 2, through C); (f) a profiler window
                 of two iterations through Trainer.train, whose trace must
                 name the attention and the greedy head's kernels.
 11. device rewards -- the device tiers of the CIDEr-D reward, the feature
                 cache and fused chunks at full width (f32, B=128): (a) stage
                 A's ids of phase 7's configuration scored by the hashed
                 n-gram tier on the card and by the host tier, with the
                 corpus df and with the cached df of a pickle the port's
                 preprocess/ngrams.py builds from the dataset (rtol 2e-4,
                 atol 2e-5), the reward's device ms and peak memory; (b) SCST
                 with on_device_cider and (c) run_joint.py -o gumbel with
                 soft_cider: five iterations, no host reward stage, the
                 launches of A,
                 B and F an iteration, the stage split, it/s and the device
                 idle share beside the host-reward SCST's in this run and
                 phases 7's and 8's; (d) the B=16 step of each on the card
                 against the CPU port replaying its draws; (e) phase-2 MLE
                 and joint -o gumbel with on_device_cider in fused chunks
                 of 8 with device_feature_cache (an eager warm-up step, then
                 a CUDA graph captured and replayed; a chunk ends where
                 scheduled sampling switches on, and the other setting is
                 captured too) against 8 single steps from one seed: losses (rtol 1e-6), params (rtol 1e-6, atol
                 1e-7), skipped steps, launches a replay, it/s of each in
                 turns, the cache's bytes and build seconds.
 12. reproduction -- the reproduction chain's device parts: (a) ResNet-101
                 (preprocess/resnet.py) at full depth and width, 448 x 448,
                 att 14, f32 with TF32 off, random weights from the seed:
                 two host-resized images (640 x 480 and a grayscale one) on
                 the card against the port on the CPU (1e-4 of the largest
                 value), the forward timed on device-resident input (16 x
                 448, 10 iterations; bench.py's ResNet measurement) beside
                 its operations bound, with NCHW weights and with TF32
                 allowed beside it, peak device memory; (b) extract_to_dirs
                 on 64 raw images of mixed sizes into
                 build/chip_smoke_feats_{fc,att} (host load and resize,
                 device forward, host write), a second call computing
                 nothing, DirFeatureSource reading every file back as
                 [14, 14, 2048], and phase 4's speaker served over them
                 through from_run_dir(max_att_len=196), greedy and beam 2,
                 f32 ids against the CPU service; (c) evaluation/harvest.py
                 over a copy of phase 8's joint run dir: the val / test
                 dicts and the json, only the best checkpoints left, the
                 test re-evaluation through eval.eval on the card (A and
                 C).  The labels, the n-grams and the three stage scripts
                 end to end (scripts/reproduce_coco.py) need h5py and PIL,
                 which this script does not require of the card's host:
                 they run in the CPU tests; the stage scripts' flag sets
                 train phases 8 and 10 here.
 13. paper drivers -- the paper's experiment drivers at full width (f32,
                 B=128), depth cut and each cut printed:
                 (a) scripts/mode_grid.py over 1024 derived images (4
                 listener, 4 MLE and 4 joint iterations, an evaluation every
                 2 on 128 val images) with -o gumbel and -o reinforce and the
                 fixed-listener rank grid (frozen-greedy, current-greedy,
                 current-sample, current-gt): finite rsum, CIDEr and val_loss
                 at every trajectory point, then mode_grid_report; the
                 frozen-greedy point of the last checkpoint at 16 val images
                 on the card against the CPU port (>= 99% of caption rows,
                 rsum to a relative 1e-6); (b) scripts/time_eval_protocol.py
                 at 256 val images, beam 2: both passes' timings, the JAX
                 script's keys, every value finite; (c) -o gumbel's speaker
                 and listener through utils/torch_interop.py (export, .pth,
                 load, convert): the tree bit-equal, a B=128 greedy decode
                 with the converted params 100% of id rows equal; (d) the
                 C++ host tier (native/) built on the card's host, and
                 language_eval with SPICE on (a)'s and (b)'s predictions
                 and on each image's first reference against its other four
                 equal from the C++ and the pure-Python tier (1e-9), each
                 tier's host seconds.  A, B, C and F must each be launched.
 14. orbax tier -- the checkpoint tier of the JAX package without orbax,
                 at reference width (f32, B=128): (a) phase-2 training
                 under checkpoint_backend 'orbax' for 2 iterations, then
                 checkpoint_operations: model.orbax, model-<it>.orbax,
                 model-best.orbax and no model .pth; a save's caller-
                 blocking ms beside its writer's ms; a Trainer resuming the
                 dir bit-equal in params, Adam state and iteration, its
                 next loss the uninterrupted run's; the .pth twin, a run
                 from the same seed under the pth backend; (b) eval.eval of
                 the dir at beam 2: the twin's captions and loss; (c)
                 from_run_dir of it: the twin's greedy ids (A, B, F L
                 each); (d) tests/data/jax_orbax_run, a .orbax run dir the
                 JAX package wrote (OCDBT, zstd through libzstd): every
                 leaf equal to its .npz; (e) utils/profiling.start_server:
                 a capture during greedy decodes of (c)'s service holds
                 A's, B's and F's kernels.
Every f32 head and cell launch of a path (services, evaluation, SCST,
joint, reinforce, device rewards and fused chunks, mesh slices, harvest,
the paper's drivers, the orbax tier) must take the split-TF32 pass, and every bf16 one the
tensor-core pass, by the per-pass launch counts.
Two lines before the last name the card and describe the kernels (one JSON
object, with each kernel's launches by path, "mesh" the launches of every
rank of the mesh runs, "joint_reinforce" those of phase 10,
"device_rewards" those of phase 11, "extracted_features" and "harvest"
those of phase 12, "paper_drivers" those of phase 13, "orbax_tier" those
of phase 14); the last line is
{"ok": true, "device": {...}}.

Builds the CUDA kernels and the C++ host library from the checkout.
Imports no JAX.  Writes only under build/ in the checkout.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pickle
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

from cooperativeimagecaptioning_tpu_torch.scripts import run_fc_con, run_joint

REPO = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(REPO, "build", "chip_smoke_run")
TRAIN_RUN_DIR = os.path.join(REPO, "build", "chip_smoke_train_run")
SCST_RUN_DIR = os.path.join(REPO, "build", "chip_smoke_scst_run")
JOINT_RUN_DIR = os.path.join(REPO, "build", "chip_smoke_joint_run")
SEED = 1234
VOCAB = 9487
L = 16
K = 36
FEAT = 2048
WIDTH = 512

ATT_SRC = "cooperativeimagecaptioning_tpu_torch/csrc/att_step.cu"
GREEDY_SRC = "cooperativeimagecaptioning_tpu_torch/csrc/logit_head.cu"
BEAM_SRC = "cooperativeimagecaptioning_tpu_torch/csrc/beam_head.cu"
CELL_SRC = "cooperativeimagecaptioning_tpu_torch/csrc/cell_step.cu"
MERGE_SRC = "cooperativeimagecaptioning_tpu_torch/csrc/head_merge.cu"
REPLACES = {
    "attention": "cooperativeimagecaptioning_tpu/ops/pallas/att_step.py:130",
    "attention_q":
        "cooperativeimagecaptioning_tpu/ops/pallas/att_step.py:192",
    "attention_kmajor":
        "cooperativeimagecaptioning_tpu/ops/pallas/att_step.py:348",
    "greedy_head":
        "cooperativeimagecaptioning_tpu/ops/pallas/logit_head.py:138",
    "beam_head": "cooperativeimagecaptioning_tpu/ops/pallas/beam_head.py:58",
    "cell": "cooperativeimagecaptioning_tpu/ops/pallas/cell_step.py:75",
    # the merge of beam_head_sharded (:111; its lines :131-142), which
    # greedy_head_sharded (logit_head.py:202) takes at m = 1
    "head_merge": "cooperativeimagecaptioning_tpu/ops/pallas/beam_head.py:111"
                  " (G), cooperativeimagecaptioning_tpu/ops/pallas/"
                  "logit_head.py:202 (H)",
}
SOURCES = {"attention": ATT_SRC, "attention_q": ATT_SRC,
           "attention_kmajor": ATT_SRC, "greedy_head": GREEDY_SRC,
           "beam_head": BEAM_SRC, "cell": CELL_SRC, "head_merge": MERGE_SRC}
# the attention kernel each decode layout of the context must go through
LAYOUTS = {"b-major": ({}, "attention"),
           "int8": ({"att_quant": "int8"}, "attention_q"),
           "k-major": ({"att_kmajor": 1}, "attention_kmajor")}
# slots of the repo's own feature grid (preprocess/feats.py: 14 x 14)
K_GRID = 196
# (type, rows, slots) at which kernels A and E are timed, and D beside them
ATT_TIMED = (("bfloat16", 512, K), ("bfloat16", 1024, K),
             ("bfloat16", 4096, K), ("float32", 128, K), ("float32", 256, K),
             ("float32", 640, K), ("bfloat16", 512, K_GRID))
ATT_Q_TIMED = (("bfloat16", 512, K), ("bfloat16", 4096, K),
               ("float32", 128, K), ("bfloat16", 512, K_GRID))
TRAIN_B = 128        # scripts/bench_train.py's batch
TRAIN_IMAGES = 256   # synthetic images (153 in the train split)
LEARN_STEPS = 20
EVAL_IMAGES = 3840   # synthetic images of the evaluation: 1536 in each of the
EVAL_B = 128         # val and test splits (0.2 / 0.4 / 0.4), 12 batches of 128
EVAL_R = 2 * EVAL_B  # rows of the evaluation's beam-2 decode
EVAL_ROWS = 5 * EVAL_B  # rows of its loss: five captions an image
EVAL_CPU_BATCHES = 2
SCST_ITERS = 5       # self-critical iterations a cell-kernel setting
SCST_CPU_B = 16      # rows of the card-vs-CPU self-critical step
DEVICE = "cuda"
FC_RUN_DIR = os.path.join(REPO, "build", "chip_smoke_fc_con_run")
DISC_RUN_DIR = os.path.join(REPO, "build", "chip_smoke_disc_run")
LISTENER_ITERS = 5   # joint iterations a cell-kernel setting
# phase-1 iterations of the main path: after 34 the listener maps the
# captions close together, and 7 of 51 val i2t rank queries sat within
# 1e-6 of a tie on an H100, which leaves the card-vs-CPU rank check nothing
# to decide there; after 300, 1 to 3 of them did
PHASE1_ITERS = 300
LISTENER_CPU_B = 16  # rows of the card-vs-CPU phase-1 and joint steps
DISC_MODES = ("gumbel", "multinomial", "gumbel_softmax", "multinomial_soft")

# The stage drivers' flag sets, imported from the port's drivers: run_fc_con's
# STAGE_FLAGS (phase 1), and run_joint's Options (JOINT_BASE) with
# build_run's overrides at run_joint's defaults (`joint_flags`).
# tests/test_torch_listener_training.py holds them equal to the JAX
# package's scripts.
PHASE1_FLAGS = run_fc_con.STAGE_FLAGS
JOINT_BASE = run_joint.JOINT_BASE


def joint_flags(optimization, vse=0):
    """run_joint -o <optimization> -v <vse> at its other defaults: -D
    0.01 (cider weight 1 - 0.01), temperature 1, lr 5e-4 decaying 0.8 every
    15 epochs, B=128, probability 0.25, the gt baseline."""
    return run_joint.joint_flags(optimization=optimization, vse=vse)[1]

# The card's published peaks (NVIDIA's H100 SXM data sheet, dense): device
# memory rate, and operations per second by input type (bf16 on the tensor
# cores, f32 outside them).  A kernel's bound is the larger of its bytes over
# the first and its operations over the second.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
# TF32 on the tensor cores: the floor of the f32 heads' split product, three
# TF32 products of 2*R*H*V operations each
TF32_OPS_PER_S = 495e12

# Tolerances (kernel vs plain version on the same inputs, max abs error):
#  attention out: f32 differs only by summation order -> 1e-4; bf16 output
#    is rounded to bf16 on both sides, so 1-2 bf16 ulps at |x| < 4 -> 3e-2.
#  head logprob / logit / logsumexp outputs are f32 on both sides, from the
#    same inputs with f32 accumulation: summation order only -> 1e-4.
#  head ids: equal, except where the plain logits of the two ids are within
#    1e-4 (a near-tie that summation order may flip); planted exact ties
#    must be equal.
#  cell h', c': the same rule as the attention (f32: summation order only;
#    bf16: both sides round the f32 result) -> 1e-4 / 3e-2.
#  gradients (kernel forward + recomputed plain backward vs plain autograd,
#    f32): relative to the largest gradient entry, 1e-4.
#  the int8 and K-major attention kernels: the attention's rule, each
#    against its own plain version on the same (quantized, transposed) inputs.
#  quantize_features on the card vs the CPU: int8 values equal, scales to a
#    relative 1e-6 (the same IEEE division and rounding on both).
#  the attention's pre-pass (att_h = h @ W + b as f32) against the same
#    product in f32 through torch: summation order only -> 1e-5 (f32); bf16
#    inputs are exact in f32 and the sums are f32 on both sides, held to the
#    bf16 tolerance of the call -> 3e-2 (observed ~3e-6).
TOL = {("attention", "float32"): 1e-4, ("attention", "bfloat16"): 3e-2,
       ("att_h", "float32"): 1e-5, ("att_h", "bfloat16"): 3e-2,
       ("cell", "float32"): 1e-4, ("cell", "bfloat16"): 3e-2,
       "head": 1e-4, "grad": 1e-4}
# CUDA vs CPU port, the first training step at B=16 (f32, no TF32, dropout
# off so both draw nothing): loss to a relative 1e-4; every gradient leaf
# elementwise within atol + rtol * |cpu| -- the two devices sum in other
# orders over B and the 17 steps.
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_RTOL = 1e-3
STEP_GRAD_ATOL = 1e-5
# Rows of ids equal between the CUDA service and the CPU service (the plain
# versions) on one 64-image request.  In f32 only near-tie flips under
# another summation order may differ.  In bf16 both sides round at the same
# points, but a 1-ulp difference in a rounded activation can flip a later
# word, and the rest of the row with it: an H100 gave 98.4% (greedy) and
# 92.2% (beam 2) on this request.  The K-major service does the b-major
# service's arithmetic on another layout, and the int8 service on the card
# the int8 CPU service's: both are held to the f32 rule.
AGREE_F32 = 0.99
AGREE_BF16 = 0.85
# loss_cap of the evaluation on the card vs the CPU port, same batches, f32
EVAL_LOSS_RTOL = 1e-4


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


@contextlib.contextmanager
def cpu_cell_plain():
    """CPU tensors through F's plain version, `cell_plain` (f32 inside, h'
    and c' rounded to the inputs' type once, as every kernel of csrc/
    cell_step.cu rounds them), in place of the port's CPU cell,
    `cell_reference` (which rounds every op in bf16): a CPU service built
    and run inside the block is the plain versions of the kernels a CUDA
    service runs, rounding where the card does.  At f32 the two are
    bit-equal."""
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import cell_step
    fused = cell_step.fused_cell

    def fused_cell(*args):
        if args[1].device.type == "cpu":
            return cell_step.cell_plain(*args)
        return fused(*args)
    cell_step.fused_cell = fused_cell
    try:
        yield
    finally:
        cell_step.fused_cell = fused


def launch_counts():
    """The launch counts since the last reset that a path reports: each
    kernel's (`launch_counts()`) and the cell's by kernel
    (`_dispatch.cell_pass_launches()`: cell_tf32x3, cell_mma, cell_fma)."""
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    return {**_dispatch.launches(), **_dispatch.cell_pass_launches()}


def counted():
    """The keys of `launch_counts`."""
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    return _dispatch.KERNELS + _dispatch.CELL_PASSES


def with_cell_pass(want, first_pass):
    """`want` (launches by kernel, missing ones 0) with the cell's by
    kernel: every cell launch on `first_pass` ("tf32x3" on an f32 path,
    "mma" on a bf16 one)."""
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    out = {k: want.get(k, 0) for k in _dispatch.KERNELS}
    for p in _dispatch.CELL_PASSES:
        out[p] = out["cell"] if p == f"cell_{first_pass}" else 0
    return out


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    require(torch.cuda.is_available(), "no CUDA device is available")
    cap = torch.cuda.get_device_capability(0)
    require(cap == (9, 0), f"needs a Hopper card (capability 9.0), got {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip()
    print(f"card: {smi}", flush=True)
    return smi


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def phase_build():
    from cooperativeimagecaptioning_tpu_torch.native import bindings
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _build
    # the C++ host library (tokenizer, METEOR, SPICE-lite, npy/npz reader):
    # every language metric of the run takes its tier, none the pure-Python
    # one in its place
    t0 = time.perf_counter()
    require(bindings.available(), "the C++ host tier did not build on the "
            f"card's host:\n{bindings.build_log()}")
    print(f"build: the C++ host library (native/, g++ -lz) ready in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    info = _build.build()
    _build.library()
    how = "compiled" if info["compiled"] else "up to date"
    print(f"build: {how} from {os.path.relpath(str(_build.CSRC), REPO)}/ "
          f"for sm_90a in {info['seconds']:.1f} s -> "
          f"{os.path.relpath(info['path'], REPO)}", flush=True)
    # what ptxas gave the two tensor-core passes: KK is the top-list
    # length, THR a later round's instantiation
    for name, res in sorted(info["resources"].items()):
        for kind in ("mma", "tf32"):
            kernel = f"vocab_partials_{kind}"
            if kernel in name:
                args = name.split(kernel + "ILi")[1]
                kk = args.split("E")[0]
                thr = ", THR" if args.split("E")[1].startswith("Lb1") else ""
                src = ("logit_head" if f"logit_head_{kind}" in name
                       else "beam_head") + f"_{kind}"
                print(f"  {src} {kernel}<KK={kk}{thr}>: "
                      f"{res['registers']} registers, {res['stack_bytes']} "
                      f"bytes of stack, {res['spill_bytes']} bytes spilled",
                      flush=True)
                require(res["spill_bytes"] == 0, f"{name} spills registers")
    # the attention's pre-pass and stream kernels (template arguments as
    # mangled: type, vector width, columns a thread, layout) and the cell's
    # three kernels (tf32x3: warps along j; mma: warps along the rows; fma:
    # type, asynchronous fill)
    for name, res in sorted(info["resources"].items()):
        for src, kernel in (("att_step", "att_h_mma_kernel"),
                            ("att_step", "att_h_fma_kernel"),
                            ("att_step", "attention_kernel"),
                            ("cell_step", "cell_tf32x3_kernel"),
                            ("cell_step", "cell_mma_kernel"),
                            ("cell_step", "cell_fma_kernel")):
            if kernel in name:
                args = name.split(kernel)[1].split("EEv")[0]
                print(f"  {src} {kernel}<{args}>: {res['registers']} "
                      f"registers, {res['stack_bytes']} bytes of stack, "
                      f"{res['spill_bytes']} bytes spilled", flush=True)
                require(res["spill_bytes"] == 0, f"{name} spills registers")
        if "head_merge_kernel" in name:
            print(f"  head_merge head_merge_kernel: {res['registers']} "
                  f"registers, {res['stack_bytes']} bytes of stack, "
                  f"{res['spill_bytes']} bytes spilled", flush=True)
            require(res["spill_bytes"] == 0, f"{name} spills registers")


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def cuda_ms(fn, iters):
    """Device time of one fn() in ms: CUDA events around `iters` calls that
    were enqueued while the card was still busy with earlier work (a few
    milliseconds of matrix products), so that the host's time to enqueue a
    call -- tens of microseconds for a wrapper that allocates and launches
    twice -- is not counted where the call's kernels take less than that."""
    import torch
    for _ in range(3):
        fn()
    busy = torch.ones(4096, 4096, device="cuda", dtype=torch.bfloat16)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    for _ in range(24):
        busy @ busy
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_pair(kernel_fn, plain_fn, iters=20):
    """(kernel ms, plain ms), measured in turns: plain, kernel, kernel,
    plain."""
    p1 = cuda_ms(plain_fn, iters)
    k1 = cuda_ms(kernel_fn, iters)
    k2 = cuda_ms(kernel_fn, iters)
    p2 = cuda_ms(plain_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound_ms(tensors, ops, dtype_name):
    """(bound in ms, "bytes" or "operations"): the least time the card could
    take for a call that reads each input and writes each output in `tensors`
    once and does `ops` operations on inputs of `dtype_name`."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors
                 if t is not None)
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = ops / PEAK_OPS_PER_S[dtype_name]
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def attention_ops(B, H, A, k=K):
    """att_h (2*H*A a row), scores (add, tanh, multiply-add: 4*A a slot) and
    the weighted sum (2*H a slot)."""
    return 2 * B * H * A + B * k * (4 * A + 2 * H)


def report(name, what, err, tol):
    ok = err <= tol
    print(f"  {name:12s} {what:40s} max_abs_err {err:.3e}  tol {tol:.0e}  "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    require(ok, f"{name} {what}: max abs error {err} above {tol}")


def ids_agree(name, what, ids_k, ids_p, logits, tol):
    """Kernel ids must equal the plain ids, except at near-ties of the plain
    f32 logits (|logit[id_k] - logit[id_p]| <= tol)."""
    import torch
    diff = ids_k.long() != ids_p.long()
    n = int(diff.sum())
    if n:
        lk = torch.gather(logits, 1, ids_k.long().reshape(logits.shape[0], -1))
        lp = torch.gather(logits, 1, ids_p.long().reshape(logits.shape[0], -1))
        gap = (lk - lp).abs().reshape(diff.shape)[diff].max().item()
        require(gap <= tol, f"{name} {what}: {n} ids differ, not near-ties "
                f"(logit gap {gap})")
    print(f"  {name:12s} {what:40s} ids differing {n} (near-ties only)",
          flush=True)


def plant_ties(w, b):
    """Zero W's columns at the tie ids and give them equal biases: their
    logits are exact ties in any summation order.  The ids sit at the seams
    of the tensor-core pass's merge, for every grid this script gives it
    (vocab splits of 256 to 4864 columns): 2 and 3 are one thread's two
    adjacent accumulator columns, 4 another lane of the same quad, 130 the
    same lane in the block's next 128-column tile, 5000 another vocab split,
    and V the last column of the ragged last tile.  Expected order of the
    top 8 for every row: [2, 3, 4, 130, 5000, V, 5, 4000]."""
    V1 = w.shape[1]
    top = [2, 3, 4, 130, 5000, V1 - 1]
    nxt = [5, 4000]
    for c in top + nxt:
        w[:, c] = 0
    b[top] = 10.0
    b[nxt] = 9.0
    return top + nxt


def plant_tie_group(w, b):
    """Zero 24 of W's columns and give them one bias: a group of exact ties
    longer than a round of the beam head (16), holding the seams of
    `plant_ties` (2, 3, 4, 130, 5000, V) and ids on both sides of the round
    seam.  Expected order of the top 24 for every row: the ids sorted."""
    V1 = w.shape[1]
    group = sorted({2, 3, 4, 130, 5000, V1 - 1, 17, 18, 300, 301, 1024,
                    2047, 2048, 3000, 4095, 4096, 6000, 7000, 7001, 8191,
                    8192, 9000, 9100, 9200})
    for c in group:
        w[:, c] = 0
    b[group] = 10.0
    return group


# beam widths above the longest list of a round (kk 17 to 64: rounds of 16)
BEAM_LONG_KK = (17, 32, 64)


def head_passes_moved(before):
    """The per-pass head launch counts that moved since `before`."""
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    after = _dispatch.head_pass_launches()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def att_widths_moved(before):
    """The per-width launch counts of the dense attentions that moved since
    `before`."""
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    after = _dispatch.att_width_launches()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def require_head_pass(what, first_pass, passes=None):
    """Every head launch counted in `passes` (per-pass counts; by default
    those of the heads and of the cell since the last reset) took
    `first_pass`: "tf32x3" for a path's f32 heads and cell, "mma" for its
    bf16 heads and cell (every such launch is at an aligned full-width
    shape)."""
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    if passes is None:
        passes = {**_dispatch.head_pass_launches(),
                  **_dispatch.cell_pass_launches()}
    other = {k: v for k, v in passes.items()
             if v and not k.endswith(f"_{first_pass}")}
    require(not other, f"{what}: every head and cell launch must take the "
            f"{first_pass} pass, counted {passes}")


def require_vector_width(what, launches):
    """Every launch of the three attention kernels since the last reset took
    the 16-byte vector width (`launches`: launch_counts())."""
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    widths = _dispatch.att_width_launches()
    for k in ("attention", "attention_kmajor", "attention_q"):
        require(widths[f"{k}_vec"] == launches[k]
                and widths[f"{k}_scalar"] == 0,
                f"{what}: every {k} launch at H=A={WIDTH} must take the "
                f"vector width, counted {widths} of {launches[k]} launches")


def check_heads(rn, dt, errs):
    """Kernels B and C against their plain versions in type `dt`, random rows
    and rows with planted exact ties, at every row count a path gives them
    and a few it does not: greedy at the f32 paths' R=128, the buckets 512
    and 4096 and at 300 rows (no multiple of the 64-row warpgroup tile);
    beam at the service's R=1024 (kk 2, 3, 6 and the longest list, 16), the
    evaluation's R=256, 300 rows, and the 8192 rows of a beam-2 bucket of
    4096.  Each launch must take the first pass its type asks for: the
    wgmma pass in bf16, the split-TF32 pass in f32 (the per-pass launch
    counts); in f32 one greedy and one beam launch on a W that does not
    start on 16 bytes must take the FMA pass.  Returns (w, b) for the
    timings."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
        _dispatch, beam_head, logit_head)
    dn = str(dt).split(".")[-1]
    first_pass = "mma" if dt == torch.bfloat16 else "tf32x3"
    H, V1, R = WIDTH, VOCAB + 1, 1024

    def launch(head, fn, which=first_pass):
        before = _dispatch.head_pass_launches()
        out = fn()
        torch.cuda.synchronize()
        moved = head_passes_moved(before)
        require(moved == {f"{head}_{which}": 1},
                f"{head} {dn}: expected one launch on the {which} pass, "
                f"counted {moved}")
        return out

    w = rn(H, V1, scale=0.1).to(dt)
    b = rn(V1, scale=0.1).to(dt)
    wt, bt = w.clone(), b.clone()
    planted = plant_ties(wt, bt)
    wg, bg = w.clone(), b.clone()
    group = plant_tie_group(wg, bg)
    for kk in BEAM_LONG_KK:
        # beam widths above 16 (rounds), random rows and the tie group
        for ww, bb, what in ((w, b, "random"), (wg, bg, "tie group")):
            hb = rn(R, H, scale=0.5).to(dt)
            logits_b = logit_head.logits_f32(hb, ww, bb)
            vals, idx, lse = launch(
                "beam_head", lambda: beam_head.beam_head(hb, ww, bb, kk))
            vals_p, idx_p, lse_p = beam_head.beam_head_reference(
                hb, ww, bb, kk)
            require(vals.shape == idx.shape == (R, kk),
                    "beam head output shapes")
            err = max((vals - vals_p).abs().max().item(),
                      (lse - lse_p).abs().max().item())
            errs["beam_head"] = max(errs["beam_head"], err)
            report("beam_head", f"{dn} {what} R={R} kk={kk} vals/lse", err,
                   TOL["head"])
            if what == "tie group":
                n = min(kk, len(group))
                want = torch.tensor(group[:n], dtype=torch.int32,
                                    device=idx.device)
                require(bool((idx[:, :n] == want[None]).all()),
                        f"beam head kk={kk}: the tie group across the "
                        f"rounds' seam not in lower-id order")
            ids_agree("beam_head", f"{dn} {what} R={R} kk={kk} ids", idx,
                      idx_p, logits_b, TOL["head"])
            del hb, logits_b
    del wg, bg
    if dt == torch.float32:
        # the FMA pass keeps every f32 shape the split-TF32 pass does not
        # take: here a W whose storage starts 4 bytes past 16
        store = torch.empty(H * V1 + 1, device=w.device)
        w_off = store[1:].view(H, V1)
        w_off.copy_(wt)
        h = rn(300, H, scale=0.5)
        it, lp = launch("greedy_head",
                        lambda: logit_head.greedy_head(h, w_off, bt), "fma")
        it_p, lp_p = logit_head.greedy_head_reference(h, wt, bt)
        vals, idx, lse = launch(
            "beam_head", lambda: beam_head.beam_head(h, w_off, bt, 2), "fma")
        vals_p, idx_p, lse_p = beam_head.beam_head_reference(h, wt, bt, 2)
        err = max((lp - lp_p).abs().max().item(),
                  (vals - vals_p).abs().max().item(),
                  (lse - lse_p).abs().max().item())
        errs["greedy_head"] = max(errs["greedy_head"], err)
        errs["beam_head"] = max(errs["beam_head"], err)
        report("heads", "f32 FMA pass (W off 16 bytes) B=300", err,
               TOL["head"])
        want = torch.tensor(planted[:2], dtype=torch.int32, device=idx.device)
        require(bool((it == planted[0]).all())
                and bool((idx == want[None]).all()),
                "the FMA pass: planted ties not in lower-id order")
        del store, w_off, h
    for ww, bb, what in ((w, b, "random"), (wt, bt, "planted ties")):
        for rows in (128, 512, 4096, 300):
            h = rn(rows, H, scale=0.5).to(dt)
            logits = logit_head.logits_f32(h, ww, bb)
            it, lp = launch("greedy_head",
                            lambda: logit_head.greedy_head(h, ww, bb))
            it_p, lp_p = logit_head.greedy_head_reference(h, ww, bb)
            require(it.dtype == torch.int32 and lp.dtype == torch.float32
                    and it.shape == lp.shape == (rows,),
                    "greedy head output types/shapes")
            err = (lp - lp_p).abs().max().item()
            errs["greedy_head"] = max(errs["greedy_head"], err)
            report("greedy_head", f"{dn} {what} B={rows} lp", err,
                   TOL["head"])
            if what == "planted ties":
                require(bool((it == planted[0]).all()),
                        "greedy head: planted tie not resolved to the lower "
                        "id")
                require(bool((it == it_p).all()), "greedy head ids (ties)")
            ids_agree("greedy_head", f"{dn} {what} B={rows} ids", it, it_p,
                      logits, TOL["head"])
        for rows, kk in ((R, 2), (R, 3), (R, 6), (R, 16), (EVAL_R, 2),
                         (300, 2), (8192, 2)):
            hb = rn(rows, H, scale=0.5).to(dt)
            logits_b = logit_head.logits_f32(hb, ww, bb)
            vals, idx, lse = launch(
                "beam_head", lambda: beam_head.beam_head(hb, ww, bb, kk))
            vals_p, idx_p, lse_p = beam_head.beam_head_reference(
                hb, ww, bb, kk)
            require(vals.shape == idx.shape == (rows, kk)
                    and lse.shape == (rows,), "beam head output shapes")
            err = max((vals - vals_p).abs().max().item(),
                      (lse - lse_p).abs().max().item())
            errs["beam_head"] = max(errs["beam_head"], err)
            report("beam_head", f"{dn} {what} R={rows} kk={kk} vals/lse",
                   err, TOL["head"])
            if what == "planted ties":
                n = min(kk, len(planted))
                want = torch.tensor(planted[:n], dtype=torch.int32,
                                    device=idx.device)
                require(bool((idx[:, :n] == want[None]).all()),
                        f"beam head kk={kk}: planted ties not in "
                        f"lower-id order")
                require(bool((idx[:, :n] == idx_p[:, :n]).all()),
                        f"beam head kk={kk} ids (ties)")
            ids_agree("beam_head", f"{dn} {what} R={rows} kk={kk} ids",
                      idx, idx_p, logits_b, TOL["head"])
            del hb, logits_b, vals_p, idx_p, lse_p
    return w, b


# (kernel, rows, kk, shards: 0 for the whole logit layer, 2 for a model
# axis' slice) at which the f32 heads are timed: the SCST / joint greedy
# baseline, the f32 service's bucket 512, the evaluation's beam-2 decode,
# the f32 beam service's R=1024, and the per-rank slices of G and H
HEAD_F32_TIMED = (("greedy_head", 128, 1, 0), ("greedy_head", 512, 1, 0),
                  ("beam_head", 256, 2, 0), ("beam_head", 1024, 2, 0),
                  ("beam_head", 256, 2, 2), ("beam_head", 128, 1, 2))
HEAD_BF16_TIMED = (("greedy_head", 512, 1, 0), ("greedy_head", 4096, 1, 0),
                   ("beam_head", 1024, 2, 0), ("beam_head", 8192, 2, 0),
                   ("beam_head", 1024, 32, 0))


def time_heads(rn, w, b):
    """Times of B and C, each beside its plain version, its bound, and `h @
    w` alone through torch.matmul: a yardstick for the product inside the
    kernel, which the port never calls for the heads; and the wrapper call
    on the host's clock, back to back on an idle card (`call_ms`: what a
    decode loop pays where enqueueing takes longer than the kernels).  In
    bf16 HEAD_BF16_TIMED: B at the buckets 512 and 4096, C at kk=2 at
    R=1024 and at the 8192 rows of a beam-2 bucket of 4096, kk=32 (two
    rounds) at R=1024.  In f32 (TF32 off for `h @ w`) HEAD_F32_TIMED, with
    the split product's floor (three TF32 products at 495 TFLOP/s) beside
    the bound.  Returns {(kernel, rows, kk, shards): {"ms", "plain_ms",
    "bound_ms", "bound_by", "matmul_ms", "call_ms"[, "split_floor_ms"]}}."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
        beam_head, logit_head)
    f32 = w.dtype == torch.float32
    H, V1 = w.shape
    out = {}
    for name, rows, kk, shards in HEAD_F32_TIMED if f32 else HEAD_BF16_TIMED:
        V = V1 // shards if shards else V1
        ws, bs = w[:, :V].contiguous(), b[:V].contiguous()
        h = rn(rows, H, scale=0.5).to(w.dtype)
        iters = 20 if rows <= 1024 else 10
        if name == "greedy_head":
            def kernel():
                return logit_head.greedy_head(h, ws, bs)

            def plain():
                return logit_head.greedy_head_reference(h, ws, bs)
            outs = (torch.empty(rows, dtype=torch.int32),
                    torch.empty(rows, dtype=torch.float32))
        else:
            def kernel():
                return beam_head.beam_head(h, ws, bs, kk)

            def plain():
                return beam_head.beam_head_reference(h, ws, bs, kk)
            outs = (torch.empty(rows, kk), torch.empty(rows, kk).int(),
                    torch.empty(rows))
        pair = timed_pair(kernel, plain, iters)
        ops = 2 * rows * H * V
        bound = bound_ms((h, ws, bs) + outs, ops, str(w.dtype).split(".")[-1])
        mm = cuda_ms(lambda: h @ ws, iters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            kernel()
        torch.cuda.synchronize()
        call = (time.perf_counter() - t0) * 1e3 / iters
        t = {"ms": pair[0], "plain_ms": pair[1], "bound_ms": bound[0],
             "bound_by": bound[1], "matmul_ms": mm, "call_ms": call}
        floor = ""
        if f32:
            t["split_floor_ms"] = 3 * ops / TF32_OPS_PER_S * 1e3
            floor = f"  split floor {t['split_floor_ms']:.4f} ms"
        out[name, rows, kk, shards] = t
        print(f"  time {name:12s} {'f32' if f32 else 'bf16'} rows={rows:<5d} "
              f"kk={kk:<2d} V={V:<5d} kernel {pair[0]:.4f} ms  plain "
              f"{pair[1]:.4f} ms  bound {bound[0]:.4f} ms ({bound[1]}; "
              f"{pair[0] / bound[0]:.1f}x){floor}  h @ w alone {mm:.4f} ms  "
              f"wrapper on the host's clock {call:.4f} ms", flush=True)
        del h, ws, bs
    return out


def phase_kernels():
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
        _dispatch, att_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(SEED)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    B, R, H, A = 512, 1024, WIDTH, WIDTH
    errs = {k: 0.0 for k in _dispatch.KERNELS}
    # times / bounds: one shape a kernel, the `kernels` line's; shapes: every
    # timed shape of a kernel, each with its own bound
    times, bounds, shapes = {}, {}, {k: [] for k in _dispatch.KERNELS}
    print("kernels vs plain versions (serving shapes: B=512, K=36, "
          "H=A=512, V+1=9488, R=1024 beam rows)", flush=True)
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).split(".")[-1]
        h = rn(B, H, scale=0.5).to(dt)
        emb = rn(B, K, H).relu().to(dt)
        p_att = rn(B, K, A).to(dt)
        wh = rn(H, A, scale=H ** -0.5).to(dt)
        bh = rn(A, scale=0.05).to(dt)
        wa = rn(A, 1, scale=A ** -0.5).to(dt)
        ba = rn(1, scale=0.05).to(dt)
        mask = torch.ones(B, K, device=dev)
        mask[::3, 20:] = 0.0   # a third of the rows partly masked
        mask[1::7, 1:] = 0.0   # some with a single valid slot
        for mk, what in ((mask, "masked"), (None, "unmasked")):
            out = att_step.fused_attention(h, emb, p_att, wh, bh, wa, ba, mk)
            torch.cuda.synchronize()
            ref = att_step.attention_reference(h, emb, p_att, wh, bh, wa, ba,
                                               mk)
            require(out.dtype == dt and out.shape == (B, H),
                    "attention output type/shape")
            err = (out.float() - ref.float()).abs().max().item()
            errs["attention"] = max(errs["attention"], err)
            report("attention", f"{dn} {what}", err,
                   TOL[("attention", dn)])

        w, b = check_heads(rn, dt, errs)

        for (name, rows, kk, shards), t in time_heads(rn, w, b).items():
            label = f"{'bf16' if dt == torch.bfloat16 else 'f32'} rows={rows}"
            if kk > 2 or (shards and name == "beam_head"):
                label += f" kk={kk}"
            if shards:
                label += f" V/{shards}"
            shapes[name].append({"shape": label, **t})
            # the kernels line's own numbers: the bf16 serving shapes
            if dt == torch.bfloat16 and (name, rows, kk) in (
                    ("greedy_head", B, 1), ("beam_head", R, 2)):
                times[name] = (t["ms"], t["plain_ms"])
                bounds[name] = (t["bound_ms"], t["bound_by"])
        del w, b
    errs["cell"], times["cell"], bounds["cell"] = check_cell(rn, shapes)
    errs["attention"] = max(errs["attention"],
                            check_attention_grad(rn))
    check_attention_variants(rn, errs, times, bounds, shapes)
    torch.cuda.synchronize()
    return errs, times, bounds, shapes


def timed_shape(shape, pair, bound):
    """One entry of a kernel's list of timed shapes."""
    return {"shape": shape, "ms": pair[0], "plain_ms": pair[1],
            "bound_ms": bound[0], "bound_by": bound[1]}


def cell_args(rn, B, dt, with_att, width=WIDTH):
    H = D = width
    args = [rn(B, D), rn(B, H, scale=0.5), rn(B, H),
            rn(B, H) if with_att else None,
            rn(D, 5 * H, scale=D ** -0.5), rn(5 * H, scale=0.1),
            rn(H, 5 * H, scale=H ** -0.5), rn(5 * H, scale=0.1),
            rn(H, 2 * H, scale=H ** -0.5) if with_att else None,
            rn(2 * H, scale=0.1) if with_att else None]
    return [None if x is None else x.to(dt) for x in args]


def cell_ops(B, width=WIDTH):
    """Operations of one cell call: the three products [B,D]x[D,5H],
    [B,H]x[H,5H] and [B,H]x[H,2H] at D = H = width."""
    return 2 * B * width * (5 + 5 + 2) * width


# F's shapes: f32 at the training step's B=128, the evaluation's beam-2
# R=256 and five-caption loss rows 640, f32 serving buckets 512 and 4096 and
# a partial row tile (130); bf16 at the serving buckets and 130; D = H =
# CELL_ODD (no multiple of 8) takes the FMA kernel in both types
CELL_SHAPES = {"float32": (TRAIN_B, 256, 512, 640, 4096, 130),
               "bfloat16": (512, 4096, 130)}
CELL_ODD = 500
# the f32 kernel must beat cell_reference up to this B (the larger f32
# buckets are measured and reported)
CELL_F32_FASTER_TO = 640


def check_cell(rn, shapes):
    """Kernel F against cell_plain (cell_reference in f32 on the same
    inputs), with attention (Att2in2) and without (FC), at CELL_SHAPES and
    at D = H = CELL_ODD; every aligned f32 launch must take the split-TF32
    kernel, every aligned bf16 launch the tensor-core kernel, D = H =
    CELL_ODD the FMA kernel.  Each full-width with-attention case but
    B=130 is timed beside cell_reference on the same inputs and gets its
    own bound (appended to shapes["cell"]), in f32 also the split product's
    floor (three TF32 products at 495 TFLOP/s) and the three products
    alone through torch.matmul (TF32 off); the f32 kernel must be faster
    than cell_reference up to B = CELL_F32_FASTER_TO.  Returns (max error,
    (kernel ms, plain ms) at the training shape, its bound)."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
        _dispatch, cell_step)
    print(f"cell (kernel F) vs its plain version (D=H={WIDTH}, and "
          f"{CELL_ODD})", flush=True)
    worst, timed, bound, extra = 0.0, {}, {}, {}
    cases = [(dn, B, WIDTH) for dn, bs in CELL_SHAPES.items() for B in bs]
    cases += [(dn, 130, CELL_ODD) for dn in CELL_SHAPES]
    for dn, B, width in cases:
        dt = getattr(torch, dn)
        which = ("cell_fma" if width % 8 else
                 "cell_tf32x3" if dn == "float32" else "cell_mma")
        for with_att in (True, False):
            args = cell_args(rn, B, dt, with_att, width)
            before = _dispatch.cell_pass_launches()
            h_new, c_new = cell_step.fused_cell(*args)
            torch.cuda.synchronize()
            after = _dispatch.cell_pass_launches()
            moved = {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}
            require(moved == {which: 1}, f"cell {dn} B={B} D=H={width}: "
                    f"expected one launch of {which}, counted {moved}")
            h_p, c_p = cell_step.cell_plain(*args)
            require(h_new.dtype == dt and c_new.shape == (B, width),
                    "cell output type/shape")
            err = max((h_new.float() - h_p.float()).abs().max().item(),
                      (c_new.float() - c_p.float()).abs().max().item())
            worst = max(worst, err)
            what = (f"{dn} B={B}{'' if width == WIDTH else f' D=H={width}'}"
                    f" {'att2in2' if with_att else 'fc'} ({which})")
            report("cell", what, err, TOL[("cell", dn)])
            if with_att and B != 130 and width == WIDTH:
                timed[(B, dn)] = timed_pair(
                    lambda: cell_step.fused_cell(*args),
                    lambda: cell_step.cell_reference(*args))
                bound[(B, dn)] = bound_ms(args + [h_new, c_new],
                                          cell_ops(B), dn)
                if dn == "float32":
                    xt, h, _, att, wi, _, wh, _, wc, _ = args
                    extra[(B, dn)] = {
                        "split_floor_ms": 3 * cell_ops(B) / TF32_OPS_PER_S
                        * 1e3,
                        "matmul_ms": cuda_ms(
                            lambda: (xt @ wi, h @ wh, att @ wc), 20)}
    for (B, dn), (k_ms, p_ms) in timed.items():
        bd = bound[(B, dn)]
        more = extra.get((B, dn), {})
        print(f"  time cell B={B:<5d} {dn:9s} kernel {k_ms:.4f} ms  "
              f"cell_reference {p_ms:.4f} ms  bound {bd[0]:.4f} ms ({bd[1]}; "
              f"{k_ms / bd[0]:.1f}x)"
              + (f"  split floor {more['split_floor_ms']:.4f} ms  products "
                 f"alone {more['matmul_ms']:.4f} ms" if more else ""),
              flush=True)
        shapes["cell"].append({**timed_shape(f"{dn} B={B}", (k_ms, p_ms),
                                             bd), **more})
        if dn == "float32" and B <= CELL_F32_FASTER_TO:
            require(k_ms < p_ms, f"cell f32 B={B}: the kernel ({k_ms:.4f} "
                    f"ms) is not faster than cell_reference ({p_ms:.4f} ms)")
    at = (TRAIN_B, "float32")
    return worst, timed[at], bound[at]


def check_attention_grad(rn):
    """The attention's autograd Function on the card (kernel forward,
    attention_reference recomputed in backward) against plain autograd of
    attention_reference, f32, at the training shape.  Returns the largest
    gradient error relative to the largest gradient entry."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import att_step
    B, H, A = TRAIN_B, WIDTH, WIDTH
    args = [rn(B, H, scale=0.5), rn(B, K, H).relu(), rn(B, K, A),
            rn(H, A, scale=H ** -0.5), rn(A, scale=0.05),
            rn(A, 1, scale=A ** -0.5), rn(1, scale=0.05)]
    args = [x.requires_grad_(True) for x in args]
    mask = torch.ones(B, K, device=args[0].device)
    mask[::3, 20:] = 0.0
    out = att_step.fused_attention(*args, mask)
    require(out.grad_fn is not None, "attention: no autograd Function")
    got = torch.autograd.grad(out.square().sum(), args)
    want = torch.autograd.grad(
        att_step.attention_reference(*args, mask).square().sum(), args)
    err = max((g - w).abs().max().item() / max(1.0, w.abs().max().item())
              for g, w in zip(got, want))
    report("attention", "f32 B=128 gradient (relative)", err, TOL["grad"])
    return err


def check_attention_variants(rn, errs, times, bounds, shapes):
    """The three attention kernels (A, the int8 kernel D, the K-major kernel
    E) against their plain versions, masked and unmasked, f32 and bf16, at
    every row count a path gives them: the training step's B=128, the
    service's B=512, its beam-expanded R=1024 and B=4096, and the
    evaluation's R=256 (batch 128, beam 2) and 640 (its loss: five captions
    an image; only A runs there), all at K=36; and at K=196 (the repo's own
    14 x 14 feature grid) at B=128 and 512.  Every launch must take the
    vector width.  Their att_h pre-pass alone against h @ W + b in f32
    through torch, and timed.  Then D at widths that are no multiple of 16
    (vector width 1), the quantizer on the card against the same function
    on the CPU, and the gradient of the quantized call.  A and E are timed
    at ATT_TIMED and D beside them at ATT_Q_TIMED, in one call a shape, each
    beside its plain version and its bound (appended to `shapes`; no L2
    flush between calls: a decode re-reads the same context every step, and
    at bf16 B=512 its 37.7 MB nearly fit the 50 MB L2).  Fills errs for the
    three kernels, times (B=512, K=36, bf16) and bounds for D and E."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
        _dispatch, att_step)
    H = A = WIDTH
    dev = torch.device("cuda")
    print("attention by context layout vs the plain versions (H=A=512, "
          f"K={K} and {K_GRID}): b-major (A), int8 (D), K-major (E)",
          flush=True)
    timed = {}
    errs["att_h"] = 0.0
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).split(".")[-1]
        wh = rn(H, A, scale=H ** -0.5).to(dt)
        bh = rn(A, scale=0.05).to(dt)
        wa = rn(A, 1, scale=A ** -0.5).to(dt)
        ba = rn(1, scale=0.05).to(dt)
        weights = (wh, bh, wa, ba)
        for B, k in ((TRAIN_B, K), (EVAL_R, K), (512, K), (EVAL_ROWS, K),
                     (1024, K), (4096, K), (TRAIN_B, K_GRID), (512, K_GRID)):
            h = rn(B, H, scale=0.5).to(dt)
            emb = rn(B, k, H).relu().to(dt)
            p_att = rn(B, k, A).to(dt)
            mask = torch.ones(B, k, device=dev)
            mask[::3, 20:] = 0.0
            mask[1::7, 1:] = 0.0
            q = att_step.quantize_features(emb, p_att)
            at = f"B={B}" if k == K else f"B={B} K={k}"
            if B == 512 and k == K:
                q_cpu = att_step.quantize_features(emb.cpu(), p_att.cpu())
                for name, on_card, on_cpu in zip(
                        ("emb_q", "emb_scale", "p_q", "p_scale"), q, q_cpu):
                    if on_card.dtype == torch.int8:
                        n = int((on_card.cpu() != on_cpu).sum())
                        print(f"  quantize     {dn} {name}: {n} int8 values "
                              f"differ from the CPU's (need 0)", flush=True)
                        require(n == 0, f"quantize_features {name}: {n} "
                                f"values differ between card and CPU")
                    else:
                        rel = ((on_card.cpu() - on_cpu).abs()
                               / on_cpu).max().item()
                        report("quantize", f"{dn} {name} (relative)", rel,
                               1e-6)
            emb_t = emb.movedim(0, 1).contiguous()
            p_t = p_att.movedim(0, 1).contiguous()
            calls = {
                "attention": (att_step.fused_attention,
                              att_step.attention_reference, (emb, p_att)),
                "attention_q": (att_step.fused_attention_q,
                                att_step.attention_reference_q, q),
                "attention_kmajor": (att_step.fused_attention_kmajor,
                                     att_step.attention_reference_kmajor,
                                     (emb_t, p_t))}
            if k == K:  # the pre-pass of the three alone
                got = att_step.att_h_kernel(h, wh, bh)
                torch.cuda.synchronize()
                err = (got - (h.float() @ wh.float() + bh.float())).abs() \
                    .max().item()
                errs["att_h"] = max(errs["att_h"], err)
                report("att_h", f"{dn} B={B} pre-pass vs h @ W + b", err,
                       TOL[("att_h", dn)])
            for name, (kernel, plain, ctx) in calls.items():
                for mk, what in ((mask, "masked"), (None, "unmasked")):
                    widths = _dispatch.att_width_launches()
                    out = kernel(h, *ctx, *weights, mk)
                    torch.cuda.synchronize()
                    require(att_widths_moved(widths) == {f"{name}_vec": 1},
                            f"{name} {dn} {at}: expected one launch at the "
                            f"vector width, counted "
                            f"{att_widths_moved(widths)}")
                    ref = plain(h, *ctx, *weights, mk)
                    require(out.dtype == dt and out.shape == (B, H),
                            f"{name} output type/shape")
                    err = (out.float() - ref.float()).abs().max().item()
                    errs[name] = max(errs[name], err)
                    report(name, f"{dn} {at} {what}", err,
                           TOL[("attention", dn)])
            if (dn, B, k) in ATT_TIMED or (dn, B, k) in ATT_Q_TIMED:
                short = "bf16" if dt == torch.bfloat16 else dn
                iters = 20 if B <= 1024 else 10
                for name, (kernel, plain, ctx) in calls.items():
                    if (dn, B, k) not in (ATT_Q_TIMED if name == "attention_q"
                                          else ATT_TIMED):
                        continue
                    timed[(name, B, k)] = timed_pair(
                        lambda: kernel(h, *ctx, *weights, mask),
                        lambda: plain(h, *ctx, *weights, mask), iters=iters)
                    out = torch.empty_like(h)
                    bound = bound_ms((h, *ctx, *weights, mask, out),
                                     attention_ops(B, H, A, k), dn)
                    k_ms, p_ms = timed[(name, B, k)]
                    print(f"  time {name:16s} {short} {at:11s} kernel "
                          f"{k_ms:.4f} ms  plain {p_ms:.4f} ms  bound "
                          f"{bound[0]:.4f} ms ({bound[1]}; "
                          f"{k_ms / bound[0]:.1f}x)", flush=True)
                    shapes[name].append(timed_shape(
                        f"{short} {at}", timed[(name, B, k)], bound))
                    if (dn, B, k) == ("bfloat16", 512, K):
                        times[name], bounds[name] = timed[(name, B, k)], bound
                if (dn, B, k) in ATT_TIMED:
                    pre = cuda_ms(lambda: att_step.att_h_kernel(h, wh, bh),
                                  iters)
                    mm = cuda_ms(lambda: torch.addmm(bh, h, wh), iters)
                    plans = {}
                    for name, item in (("attention", h.element_size()),
                                       ("attention_q", 1)):
                        plan = att_step.stream_plan(B, k, H, A, item, False)
                        plans[name] = (
                            f"{plan.rows} rows a block, {plan.slots} slots x "
                            f"{plan.stages} stages, {plan.smem_bytes} bytes "
                            f"of shared memory, grid {plan.grid}, "
                            f"{att_step.resident_blocks(plan, k, H, A, dt, name)}"
                            f" blocks an SM")
                    print(f"  time att_h pre-pass   {short} {at:11s} kernel "
                          f"{pre:.4f} ms (torch.addmm of the same product, a "
                          f"yardstick the port never calls here: {mm:.4f} "
                          f"ms); stream plan: {plans['attention']}; int8: "
                          f"{plans['attention_q']}", flush=True)
                    for name in ("attention", "attention_kmajor"):
                        shapes[name][-1].update(att_h_ms=pre,
                                                att_h_addmm_ms=mm)
            del h, emb, p_att, q, emb_t, p_t, calls

        # D at widths that are no multiple of 16: vector width 1
        B, k, Hn = 64, K, 40
        h = rn(B, Hn, scale=0.5).to(dt)
        q = att_step.quantize_features(rn(B, k, Hn).relu().to(dt),
                                       rn(B, k, Hn).to(dt))
        small = (rn(Hn, Hn, scale=Hn ** -0.5).to(dt), rn(Hn, scale=0.05).to(dt),
                 rn(Hn, 1, scale=Hn ** -0.5).to(dt), rn(1, scale=0.05).to(dt))
        mask = torch.ones(B, k, device=dev)
        mask[::3, 20:] = 0.0
        widths = _dispatch.att_width_launches()
        out = att_step.fused_attention_q(h, *q, *small, mask)
        torch.cuda.synchronize()
        require(att_widths_moved(widths) == {"attention_q_scalar": 1},
                f"attention_q {dn} H=A={Hn}: expected one launch at width 1, "
                f"counted {att_widths_moved(widths)}")
        err = (out.float() - att_step.attention_reference_q(
            h, *q, *small, mask).float()).abs().max().item()
        errs["attention_q"] = max(errs["attention_q"], err)
        report("attention_q", f"{dn} B={B} H=A={Hn} (width 1) masked", err,
               TOL[("attention", dn)])

    # the quantized call's gradient: kernel forward, the dequantized
    # reference recomputed in backward, against plain autograd (f32)
    B = TRAIN_B
    live = [rn(B, H, scale=0.5), rn(H, A, scale=H ** -0.5),
            rn(A, scale=0.05), rn(A, 1, scale=A ** -0.5), rn(1, scale=0.05)]
    live = [x.requires_grad_(True) for x in live]
    q = att_step.quantize_features(rn(B, K, H).relu(), rn(B, K, A))
    mask = torch.ones(B, K, device=dev)
    mask[::3, 20:] = 0.0
    out = att_step.fused_attention_q(live[0], *q, *live[1:], mask)
    require(out.grad_fn is not None, "attention_q: no autograd Function")
    got = torch.autograd.grad(out.square().sum(), live)
    want = torch.autograd.grad(att_step.attention_reference_q(
        live[0], *q, *live[1:], mask).square().sum(), live)
    err = max((g - w).abs().max().item() / max(1.0, w.abs().max().item())
              for g, w in zip(got, want))
    report("attention_q", "f32 B=128 gradient (relative)", err, TOL["grad"])
    errs["attention_q"] = max(errs["attention_q"], err)


# ---------------------------------------------------------------------------
# 4. the slice: serving at full width
# ---------------------------------------------------------------------------

def write_run_dir(run_dir=RUN_DIR):
    """A full-width Att2in2 run dir holding random weights from SEED (the
    trained speakers' run dirs are written by the port's Trainer)."""
    from cooperativeimagecaptioning_tpu_torch.config import Options
    from cooperativeimagecaptioning_tpu_torch.training import checkpoint, joint
    opt = Options(caption_model="att2in2", vse_model="None", phase=2,
                  vocab_size=VOCAB, rnn_size=WIDTH,
                  input_encoding_size=WIDTH, att_hid_size=WIDTH,
                  fc_feat_size=FEAT, att_feat_size=FEAT, seq_length=L,
                  max_att_len=K, batch_size=EVAL_B, language_eval=1,
                  id="smoke", checkpoint_path=run_dir)
    os.makedirs(run_dir, exist_ok=True)
    vocab = {str(i): f"w{i}" for i in range(1, VOCAB + 1)}
    with open(os.path.join(run_dir, "infos_.pkl"), "wb") as f:
        pickle.dump({"opt": opt, "vocab": vocab}, f)
    checkpoint.save_params(joint.init_params(SEED, opt),
                           os.path.join(run_dir, "model-best.pth"))
    return opt


def features(n, seed, k=K):
    rng = np.random.default_rng(seed)
    fc = rng.standard_normal((n, FEAT), dtype=np.float32)
    att = np.maximum(rng.standard_normal((n, k, FEAT), dtype=np.float32), 0)
    masks = np.ones((n, k), np.float32)
    masks[::4, k - k // 6:] = 0.0  # images with fewer regions
    return fc, att, masks


def post_npz(base, fc, att, masks):
    buf = io.BytesIO()
    np.savez(buf, fc=fc, att=att, att_masks=masks)
    req = urllib.request.Request(
        base + "/caption", data=buf.getvalue(),
        headers={"Content-Type": "application/x-npz"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def serve_requests(svc, label, kernel, att_kernel="attention",
                   sizes=(1, 5, 64, 300)):
    """POST npz requests of 1, 5, 64 and 300 images to a bf16 service; check
    the answers, that each bucket call launched `att_kernel` and `kernel`
    seq_length times and no other kernel, and that every head launch took
    the tensor-core pass.  Returns the ids of the 64-image request."""
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.serving import make_http_server
    srv = make_http_server(svc, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    ids64 = None
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            hz = json.loads(r.read())
        require(hz["status"] == "ok" and hz["beam_size"] == svc.beam_size,
                f"/healthz answered {hz}")
        for n in sizes:
            fc, att, masks = features(n, seed=n)
            before = launch_counts()
            passes = _dispatch.head_pass_launches()
            out = post_npz(base, fc, att, masks)
            after = launch_counts()
            passes = head_passes_moved(passes)
            ids = np.asarray(out["ids"])
            require(ids.shape == (n, L), f"{label} n={n}: ids {ids.shape}")
            require(ids.min() >= 0 and ids.max() <= VOCAB,
                    f"{label} n={n}: ids out of range")
            caps = out["captions"]
            require(len(caps) == n and all(isinstance(c, str) for c in caps),
                    f"{label} n={n}: captions")
            for row, cap in zip(ids, caps):
                nz = np.flatnonzero(row == 0)
                length = int(nz[0]) if nz.size else L
                require(len(cap.split()) == length,
                        f"{label} n={n}: caption does not decode its ids")
            calls = 1  # every n here fits one bucket
            for k in _dispatch.KERNELS:
                want = L * calls if k in (att_kernel, kernel, "cell") else 0
                got = after[k] - before[k]
                require(got == want, f"{label} n={n}: {k} launched {got} "
                        f"times, expected {want}")
            require(passes == {f"{kernel}_mma": L * calls},
                    f"{label} n={n}: the bf16 head launches must all take "
                    f"the tensor-core pass, counted {passes}")
            print(f"  {label}: n={n:3d} -> bucket {svc._bucket_for(n)}, "
                  f"{len(caps)} captions, e.g. {caps[0][:60]!r}", flush=True)
            if n == 64:
                ids64 = ids
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=60)
    return ids64


def captions_per_s(svc, n, reps=3):
    fc, att, masks = features(n, seed=10_000 + n)
    svc.caption_ids(fc[:1], att[:1], masks[:1])
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        ids = svc.caption_ids(fc, att, masks)
        ts.append(time.perf_counter() - t0)
        require(ids.shape == (n, L), "throughput run ids shape")
    return n / float(np.median(ts))


def phase_slice(smi):
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.serving import CaptioningService
    opt = write_run_dir()
    print(f"slice: run dir {os.path.relpath(RUN_DIR, REPO)} (att2in2, vocab "
          f"{VOCAB}, width {WIDTH}, K={K}, L={opt.seq_length}, seed {SEED})",
          flush=True)
    t0 = time.perf_counter()
    greedy = CaptioningService.from_run_dir(RUN_DIR,
                                            compute_dtype="bfloat16")
    greedy.warmup()
    beam = CaptioningService.from_run_dir(RUN_DIR, beam_size=2,
                                          compute_dtype="bfloat16")
    beam.warmup()
    torch.cuda.synchronize()
    print(f"  services loaded and warmed (buckets {greedy.buckets}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # the main path: counts from 0 to the end of the served requests
    _dispatch.reset_launches()
    ids_greedy = serve_requests(greedy, "greedy bf16", "greedy_head")
    ids_beam = serve_requests(beam, "beam-2 bf16", "beam_head")
    main_launches = launch_counts()
    for k in ("attention", "greedy_head", "beam_head"):
        require(main_launches[k] > 0, f"{k} was never launched on the "
                f"main path")
    require_vector_width("serving", main_launches)
    require_head_pass("serving", "mma")
    print(f"  main-path launches: {main_launches}; heads by first pass: "
          f"{_dispatch.head_pass_launches()}; attention by width: "
          f"{_dispatch.att_width_launches()}", flush=True)

    # the CUDA services against CPU services (the plain versions, F's
    # included: `cpu_cell_plain`) on the same 64-image request, at the same
    # bucket
    fc, att, masks = features(64, seed=64)
    for m, ids_served in ((0, ids_greedy), (2, ids_beam)):
        mode = "beam-2" if m else "greedy"
        with cpu_cell_plain():
            cpu = {dn: CaptioningService.from_run_dir(
                RUN_DIR, beam_size=m, compute_dtype=dn, buckets=(64,),
                device="cpu").caption_ids(fc, att, masks)
                for dn in ("float32", "bfloat16")}
        gpu32 = CaptioningService.from_run_dir(
            RUN_DIR, beam_size=m, compute_dtype="float32", buckets=(64,))
        passes = _dispatch.head_pass_launches()
        ids32 = gpu32.caption_ids(fc, att, masks)
        passes = head_passes_moved(passes)
        head = "beam_head" if m else "greedy_head"
        require(passes == {f"{head}_tf32x3": L},
                f"f32 {mode} service: the head launches must all take the "
                f"split-TF32 pass, counted {passes}")
        for what, ids_a, ids_b, floor in (
                ("f32 cuda vs f32 cpu", ids32, cpu["float32"], AGREE_F32),
                ("bf16 cuda vs bf16 cpu", ids_served, cpu["bfloat16"],
                 AGREE_BF16),
                ("bf16 cuda vs f32 cpu", ids_served, cpu["float32"], None)):
            rate = float((ids_a == ids_b).all(axis=1).mean())
            need = f"need >= {floor * 100:.0f}%" if floor else "reported"
            print(f"  {what}, {mode}: {rate * 100:.1f}% of 64 rows equal "
                  f"({need})", flush=True)
            require(floor is None or rate >= floor,
                    f"{what}, {mode}: {rate} of rows equal, below {floor}")
        del gpu32

    rates = {"greedy bucket 512": captions_per_s(greedy, 512),
             "greedy bucket 4096": captions_per_s(greedy, 4096),
             "beam-2 bucket 512": captions_per_s(beam, 512)}
    print(f"throughput ({smi}; bf16, host features to ids, serial "
          f"requests): " + "; ".join(f"{k}: {v:.1f} captions/s"
                                     for k, v in rates.items()), flush=True)
    layout_launches = phase_layouts(smi, {0: greedy, 2: beam},
                                    {0: ids_greedy, 2: ids_beam}, rates)
    grid_launches = phase_grid_features()
    check_missing_leaf()
    return {k: main_launches[k] + layout_launches[k] + grid_launches[k]
            for k in main_launches}


def phase_grid_features():
    """Services of the same run dir through from_run_dir(max_att_len=196),
    fed 196-slot features (the repo's own 14 x 14 grid): greedy and beam 2,
    bf16 and f32, every step through the attention kernel and the head, and
    the f32 ids against the CPU service's.  Returns the launch counts."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.serving import CaptioningService
    n = 64
    fc, att, masks = features(n, seed=196, k=K_GRID)
    print(f"196-slot features: from_run_dir(max_att_len={K_GRID}), {n} "
          f"images", flush=True)
    total = {k: 0 for k in counted()}
    for m in (0, 2):
        mode = "beam-2" if m else "greedy"
        head = "beam_head" if m else "greedy_head"
        ids = {}
        for dn in ("bfloat16", "float32"):
            svc = CaptioningService.from_run_dir(
                RUN_DIR, beam_size=m, compute_dtype=dn, buckets=(n,),
                max_att_len=K_GRID)
            _dispatch.reset_launches()
            ids[dn] = svc.caption_ids(fc, att, masks)
            torch.cuda.synchronize()
            got = launch_counts()
            require_vector_width(f"{K_GRID}-slot {dn} {mode}", got)
            require_head_pass(f"{K_GRID}-slot {dn} {mode}",
                              "tf32x3" if dn == "float32" else "mma")
            for k in _dispatch.KERNELS:
                want = L if k in ("attention", head, "cell") else 0
                require(got[k] == want, f"{K_GRID}-slot {dn} {mode}: {k} "
                        f"launched {got[k]} times, expected {want}")
            for k in total:
                total[k] += got[k]
            require(ids[dn].shape == (n, L), f"{K_GRID}-slot ids shape")
            del svc
        cpu = CaptioningService.from_run_dir(
            RUN_DIR, beam_size=m, compute_dtype="float32", buckets=(n,),
            max_att_len=K_GRID, device="cpu").caption_ids(fc, att, masks)
        for what, a, b, floor in (
                ("f32 cuda vs f32 cpu", ids["float32"], cpu, AGREE_F32),
                ("bf16 cuda vs f32 cpu", ids["bfloat16"], cpu, None)):
            rate = float((a == b).all(axis=1).mean())
            need = f"need >= {floor * 100:.0f}%" if floor else "reported"
            print(f"  {K_GRID} slots, {what}, {mode}: {rate * 100:.1f}% of "
                  f"{n} rows equal ({need})", flush=True)
            require(floor is None or rate >= floor,
                    f"{K_GRID} slots, {what}, {mode}: {rate} of rows equal")
    return total


def check_missing_leaf():
    """A run dir whose checkpoint lacks one leaf (the logit layer's bias):
    from_run_dir fills it from the template of the run's opt
    (joint.init_params(0, opt)), reports it, and serves the same ids as a
    service built on the checkpoint's tree with that leaf filled in."""
    import copy
    from cooperativeimagecaptioning_tpu_torch.config import load_infos
    from cooperativeimagecaptioning_tpu_torch.serving import CaptioningService
    from cooperativeimagecaptioning_tpu_torch.training import checkpoint, joint
    run_dir = os.path.join(REPO, "build", "chip_smoke_leaf_run")
    os.makedirs(run_dir, exist_ok=True)
    opt = load_infos(os.path.join(RUN_DIR, "infos_.pkl"))["opt"]
    full = checkpoint.load_params(os.path.join(RUN_DIR, "model-best.pth"))
    cut = copy.deepcopy(full)
    del cut["speaker"]["logit"]["b"]
    checkpoint.save_params(cut, os.path.join(run_dir, "model-best.pth"))
    with open(os.path.join(RUN_DIR, "infos_.pkl"), "rb") as f, \
            open(os.path.join(run_dir, "infos_.pkl"), "wb") as g:
        g.write(f.read())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        svc = CaptioningService.from_run_dir(run_dir, buckets=(64,),
                                             compute_dtype="float32")
    require("logit.b not in loaded checkpoint" in out.getvalue(),
            f"missing leaf not reported: {out.getvalue()}")
    full["speaker"]["logit"]["b"] = joint.init_params(
        0, opt)["speaker"]["logit"]["b"]
    vocab = load_infos(os.path.join(RUN_DIR, "infos_.pkl"))["vocab"]
    want_svc = CaptioningService(opt, full, vocab, buckets=(64,),
                                 compute_dtype="float32")
    fc, att, masks = features(64, seed=65)
    a = svc.caption_ids(fc, att, masks)
    b = want_svc.caption_ids(fc, att, masks)
    require(a.shape == (64, L) and (a == b).all(),
            "the filled leaf: ids differ from the tree filled by hand")
    print("  a checkpoint without logit.b: reported, filled from the "
          "template, 64 of 64 rows equal to the tree filled by hand",
          flush=True)


def decode_memory(svc, n=4096):
    """Device memory of one greedy decode of `n` images on `svc`'s speaker:
    (bytes of the resident attention context, peak bytes allocated during
    the decode beyond what was allocated before the request).  The context
    is made as the service makes it, the features freed before the decode."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops import decoding
    _, att, masks = features(n, seed=7)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    with torch.inference_mode():
        ctx = svc.speaker.encode_features(
            None, svc._to_device(att),
            torch.from_numpy(masks).to(svc.device))
        if svc.att_quant == "int8":
            ctx = svc.speaker.quantize_ctx(ctx)
        elif getattr(svc.opt, "att_kmajor", 0):
            ctx = svc.speaker.kmajor_ctx(ctx)
        ctx_bytes = sum(t.numel() * t.element_size() for t in ctx.values())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        decoding.sample(svc.speaker, ctx, svc.opt.seq_length, mode="greedy")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
    return ctx_bytes, peak


def request_memory(svc, n=4096):
    """torch.cuda.max_memory_allocated over one request of `n` images."""
    import torch
    fc, att, masks = features(n, seed=7)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    svc.caption_ids(fc, att, masks)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def phase_layouts(smi, plain, plain_ids, plain_rates):
    """The two other decode layouts of the attention context through the
    service: att_quant="int8" (kernel D) and att_kmajor=1 (kernel E), greedy
    and beam 2, bf16, from_run_dir + warmup + the HTTP server.  `plain`,
    `plain_ids` and `plain_rates` are the b-major services of the same run
    dir, the ids they served for the 64-image request and their captions/s.
    Returns the launch counts of the served requests."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.serving import CaptioningService
    print("decode layouts of the attention context: int8 (att_quant), "
          "K-major (att_kmajor=1)", flush=True)
    svcs = {}
    t0 = time.perf_counter()
    for name in ("int8", "k-major"):
        kw, _ = LAYOUTS[name]
        for m in (0, 2):
            svcs[name, m] = CaptioningService.from_run_dir(
                RUN_DIR, beam_size=m, compute_dtype="bfloat16", **kw)
            svcs[name, m].warmup()
    torch.cuda.synchronize()
    print(f"  four services loaded and warmed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    _dispatch.reset_launches()
    served = {}
    for (name, m), svc in svcs.items():
        mode = "beam-2" if m else "greedy"
        served[name, m] = serve_requests(
            svc, f"{name} {mode} bf16", "beam_head" if m else "greedy_head",
            att_kernel=LAYOUTS[name][1])
    launches = launch_counts()
    require(launches["attention"] == 0 and launches["attention_q"] > 0
            and launches["attention_kmajor"] > 0,
            f"decode layouts: launches {launches}")
    require_vector_width("decode layouts", launches)
    require_head_pass("decode layouts", "mma")
    print(f"  launches of the int8 and K-major requests: {launches}",
          flush=True)

    # ids, one 64-image request at one bucket: f32 K-major on the card vs
    # f32 b-major on the card; f32 int8 on the card vs the f32 int8 CPU
    # service; how often int8 ids equal the unquantized ids (reported)
    fc, att, masks = features(64, seed=64)
    for m in (0, 2):
        mode = "beam-2" if m else "greedy"

        def ids(device="cuda", **kw):
            return CaptioningService.from_run_dir(
                RUN_DIR, beam_size=m, compute_dtype="float32", buckets=(64,),
                device=device, **kw).caption_ids(fc, att, masks)
        passes = _dispatch.head_pass_launches()
        base = ids()
        q_gpu = ids(att_quant="int8")
        passes = head_passes_moved(passes)
        head = "beam_head" if m else "greedy_head"
        require(passes == {f"{head}_tf32x3": 2 * L},
                f"f32 {mode} services: the head launches must all take the "
                f"split-TF32 pass, counted {passes}")
        for what, a, b, floor in (
                ("f32 K-major cuda vs f32 b-major cuda", ids(att_kmajor=1),
                 base, AGREE_F32),
                ("f32 int8 cuda vs f32 int8 cpu", q_gpu,
                 ids("cpu", att_quant="int8"), AGREE_F32),
                ("f32 int8 cuda vs f32 unquantized cuda", q_gpu, base, None),
                ("bf16 int8 cuda vs bf16 unquantized cuda",
                 served["int8", m], plain_ids[m], None),
                ("bf16 K-major cuda vs bf16 b-major cuda",
                 served["k-major", m], plain_ids[m], None)):
            rate = float((a == b).all(axis=1).mean())
            need = f"need >= {floor * 100:.0f}%" if floor else "reported"
            print(f"  {what}, {mode}: {rate * 100:.1f}% of 64 rows equal "
                  f"({need})", flush=True)
            require(floor is None or rate >= floor,
                    f"{what}, {mode}: {rate} of rows equal, below {floor}")

    rows = {"b-major": plain_rates}
    for name in ("int8", "k-major"):
        rows[name] = {
            "greedy bucket 512": captions_per_s(svcs[name, 0], 512),
            "greedy bucket 4096": captions_per_s(svcs[name, 0], 4096),
            "beam-2 bucket 512": captions_per_s(svcs[name, 2], 512)}
    for name, r in rows.items():
        print(f"throughput by layout ({smi}; bf16, host features to ids, "
              f"serial requests) {name}: "
              + "; ".join(f"{k}: {v:.1f} captions/s" for k, v in r.items()),
              flush=True)

    for name, svc in (("bf16 b-major", plain[0]), ("int8", svcs["int8", 0]),
                      ("bf16 k-major", svcs["k-major", 0])):
        ctx_bytes, decode_peak = decode_memory(svc)
        print(f"memory ({smi}; greedy, 4096 images) {name}: context "
              f"{ctx_bytes / 2 ** 20:.1f} MiB resident; peak during the "
              f"decode {decode_peak / 2 ** 20:.1f} MiB above the service; "
              f"max_memory_allocated over the whole request "
              f"{request_memory(svc) / 2 ** 20:.1f} MiB", flush=True)
    return launches


# ---------------------------------------------------------------------------
# 5. training: phase-2 MLE at full width
# ---------------------------------------------------------------------------

def train_opt(batch_size, drop_prob_lm=0.5):
    """Phase-2 MLE options at reference width (scripts/bench_train.py's
    configuration, f32; use_bn off as the options default it)."""
    from cooperativeimagecaptioning_tpu_torch.config import Options
    return Options(caption_model="att2in2", vse_model="None", phase=2,
                   caption_loss_weight=1, batch_size=batch_size,
                   seq_per_img=1, rnn_size=WIDTH, input_encoding_size=WIDTH,
                   att_hid_size=WIDTH, fc_feat_size=FEAT, att_feat_size=FEAT,
                   max_att_len=K, drop_prob_lm=drop_prob_lm,
                   save_checkpoint_every=10 ** 9, losses_log_every=1,
                   prefetch_batches=0, seed=SEED,
                   checkpoint_path=TRAIN_RUN_DIR)


def train_dataset():
    """The shared SyntheticDataset at the reference's shapes: vocab 9487,
    L=16, up to 36 regions of 2048-d features."""
    from cooperativeimagecaptioning_tpu_torch.data import SyntheticDataset
    return SyntheticDataset(num_images=TRAIN_IMAGES, vocab_size=VOCAB,
                            seq_length=L, fc_feat_size=FEAT,
                            att_feat_size=FEAT, max_K=K, seed=SEED)


def iterations_per_s(trainer, data, n=10):
    """Training iterations per second on one fixed host batch (its copy to
    the card included), after one warm-up iteration."""
    import torch
    trainer.train_iteration(data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        trainer.train_iteration(data)
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def grads_against(grads_g, grads_c):
    """(worst ratio to phase 5's rule atol + rtol * |cpu| -- above 1 is
    outside it somewhere in the leaf --, its leaf, the largest absolute
    difference) over every gradient leaf of the card's tree against the
    CPU's."""
    from cooperativeimagecaptioning_tpu_torch.utils.tree import leaves
    worst, worst_key, max_abs = 0.0, "", 0.0
    cpu = dict(leaves(grads_c))
    for key, g in leaves(grads_g):
        g, c = g.cpu(), cpu[key]
        ratio = ((g - c).abs() / (STEP_GRAD_ATOL + STEP_GRAD_RTOL * c.abs())
                 ).max().item()
        max_abs = max(max_abs, (g - c).abs().max().item())
        if ratio > worst:
            worst, worst_key = ratio, key
    return worst, worst_key, max_abs


def cpu_copy(params):
    from cooperativeimagecaptioning_tpu_torch.utils.tree import (
        to_numpy, to_torch, trainable)
    return {agent: trainable(to_torch(to_numpy(tree), "cpu"))
            for agent, tree in params.items()}


def compare_first_step(ds):
    """The first step at B=16 on the card against the same step on the CPU
    port: same params, same batch, dropout off (the two devices' generators
    draw different masks)."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.training import joint
    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    from cooperativeimagecaptioning_tpu_torch.utils.tree import leaves
    opt = train_opt(16, drop_prob_lm=0.0)
    tr = Trainer(opt, dataset=ds, device=DEVICE, verbose=False)
    data = tr.loader.get_batch("train")
    batch = tr._prepare_batch(data)
    fn = joint.value_and_grad(opt, "optimizer")
    hp = joint.Hyper.from_opt(opt)
    (loss_g, _), grads_g = fn(tr.params, batch, tr.iteration_streams(), hp)
    cpu_params = cpu_copy(tr.params)
    cpu_batch = {k: None if v is None else v.cpu() for k, v in batch.items()}
    (loss_c, _), grads_c = fn(cpu_params, cpu_batch, torch.Generator(), hp)
    rel = abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())
    print(f"  B=16 first step, cuda vs cpu port: loss {loss_g.item():.6f} "
          f"vs {loss_c.item():.6f} (relative {rel:.2e}, tol "
          f"{STEP_LOSS_RTOL:.0e})", flush=True)
    require(rel <= STEP_LOSS_RTOL, f"first-step loss: relative {rel}")
    worst, worst_key, max_abs = grads_against(grads_g, grads_c)
    print(f"  B=16 first step gradients, {len(leaves(grads_c))} leaves: "
          f"max abs difference {max_abs:.3e}; worst leaf {worst_key} at "
          f"{worst:.3f} of its tolerance (rtol {STEP_GRAD_RTOL:.0e}, atol "
          f"{STEP_GRAD_ATOL:.0e})", flush=True)
    require(worst <= 1.0, f"first-step gradient {worst_key}: {worst} of "
            f"its tolerance")
    del tr
    return rel, max_abs


def phase_train(smi):
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.serving import CaptioningService
    from cooperativeimagecaptioning_tpu_torch.training import loop
    require(not torch.backends.cuda.matmul.allow_tf32,
            "TF32 matmuls are on: the f32 checks need them off")
    ds = train_dataset()
    print(f"training: phase-2 MLE, att2in2 vocab {VOCAB}, width {WIDTH}, "
          f"K={K}, L={L}, B={TRAIN_B}, f32, drop_prob_lm 0.5, "
          f"{TRAIN_IMAGES} synthetic images", flush=True)
    out = {}
    # the main path: three steps through the user's entry point
    steps = 3
    _dispatch.reset_launches()
    t0 = time.perf_counter()
    trainer = loop.train(train_opt(TRAIN_B), dataset=ds,
                         max_iterations=steps, device=DEVICE,
                         verbose=False)
    torch.cuda.synchronize()
    launches = launch_counts()
    T = L + 1  # labels[:, :-1] of the [B, L+2] labels
    print(f"  train(max_iterations={steps}) in "
          f"{time.perf_counter() - t0:.1f} s; launches {launches}",
          flush=True)
    for k in _dispatch.KERNELS:
        want = steps * 2 * T if k in ("attention", "cell") else 0
        require(launches[k] == want, f"training: {k} launched "
                f"{launches[k]} times in {steps} steps, expected {want} "
                f"(forward + checkpointed recompute, T={T})")
    require_vector_width("training", launches)
    require_head_pass("training", "tf32x3")
    losses = [float(v) for v in trainer.loss_history.values()]
    require(len(losses) == steps and all(np.isfinite(losses)),
            f"training losses {losses}")
    require(trainer.optim.skipped_steps() == 0, "non-finite steps")

    out["step_rel"], out["step_abs"] = compare_first_step(ds)

    data = trainer.loader.get_batch("train")
    curve = [trainer.train_iteration(data)[0]["loss_cap"].item()
             for _ in range(LEARN_STEPS)]
    print(f"  {LEARN_STEPS} steps on one batch: loss_cap "
          f"{curve[0]:.4f} -> {curve[-1]:.4f}", flush=True)
    require(all(np.isfinite(curve)) and curve[-1] < curve[0]
            and np.mean(curve[-5:]) < np.mean(curve[:5]),
            f"loss_cap did not fall: {curve}")
    out["loss_first"], out["loss_last"] = curve[0], curve[-1]

    rates = [iterations_per_s(trainer, data) for _ in range(2)]
    out["its"] = float(np.mean(rates))
    print(f"  throughput ({smi}; B={TRAIN_B}, f32, one fixed host batch): "
          f"{out['its']:.2f} it/s ({rates[0]:.2f}, {rates[1]:.2f})",
          flush=True)

    # the trained speaker's run dir, written by the port: evaluate on val,
    # then model, optimizer, infos and histories
    t0 = time.perf_counter()
    val_loss, _ = trainer.checkpoint_operations()
    written = sorted(os.listdir(TRAIN_RUN_DIR))
    for name in ("model.pth", f"model-{trainer.iteration}.pth",
                 "model-best.pth", "optimizer.pth", "infos_.pkl",
                 "histories_.pkl"):
        require(name in written, f"checkpoint_operations wrote {written}")
    require(np.isfinite(val_loss["loss_cap"]), f"val loss {val_loss}")
    print(f"  checkpoint_operations after {trainer.iteration} iterations in "
          f"{time.perf_counter() - t0:.1f} s: val loss_cap "
          f"{val_loss['loss_cap']:.4f}; wrote {written}", flush=True)
    out["iteration"], out["epoch"] = trainer.iteration, trainer.epoch

    # serve the trained speaker: greedy, bucket 512
    svc = CaptioningService.from_run_dir(TRAIN_RUN_DIR,
                                         compute_dtype="bfloat16",
                                         buckets=(512,), device=DEVICE)
    fc, att, masks = features(512, seed=512)
    svc.caption_ids(fc[:1], att[:1], masks[:1])
    _dispatch.reset_launches()
    ids = svc.caption_ids(fc, att, masks)
    torch.cuda.synchronize()
    served = launch_counts()
    require(_dispatch.head_pass_launches()["greedy_head_mma"] == L,
            "serving the trained speaker in bf16: the greedy head must "
            "take the tensor-core pass")
    require_head_pass("serving the trained speaker", "mma")
    require(ids.shape == (512, L) and ids.min() >= 0 and ids.max() <= VOCAB,
            f"trained speaker ids {ids.shape}")
    for k in _dispatch.KERNELS:
        want = L if k in ("attention", "greedy_head", "cell") else 0
        require(served[k] == want, f"serving the trained speaker: {k} "
                f"launched {served[k]} times, expected {want}")
    print(f"  trained speaker served: 512 images -> ids {ids.shape}, "
          f"{len(np.unique(ids))} distinct ids; launches {served}",
          flush=True)
    return launches, out


# ---------------------------------------------------------------------------
# 6. evaluation: the trained speaker under the final-eval protocol
# ---------------------------------------------------------------------------

def eval_dataset():
    """A SyntheticDataset at the reference's shapes: twelve batches of
    EVAL_B images in the val and in the test split, three times what the
    evaluator keeps in flight."""
    from cooperativeimagecaptioning_tpu_torch.data import SyntheticDataset
    return SyntheticDataset(num_images=EVAL_IMAGES, vocab_size=VOCAB,
                            seq_length=L, fc_feat_size=FEAT,
                            att_feat_size=FEAT, max_K=K,
                            splits=(0.2, 0.4, 0.4), seed=SEED + 1)


def eval_against_cpu(ds, run_dir, who, layouts, min_distinct):
    """The first EVAL_CPU_BATCHES val batches through Evaluator.eval_split
    (f32, beam 2) on the card and on the CPU port, `run_dir`'s speaker, once
    for each context layout in `layouts`: the captions of at least AGREE_F32
    of the images equal (the vocabulary maps id i to "w<i>", so equal
    captions are equal ids up to the end token), at least `min_distinct`
    different captions among them, and loss_cap within EVAL_LOSS_RTOL."""
    from cooperativeimagecaptioning_tpu_torch import config, data
    from cooperativeimagecaptioning_tpu_torch.evaluation.eval_split import (
        Evaluator)
    from cooperativeimagecaptioning_tpu_torch.training import checkpoint
    model = os.path.join(run_dir, "model-best.pth")
    n = EVAL_CPU_BATCHES * EVAL_B
    ek = {"split": "val", "beam_size": 2, "language_eval": 0,
          "num_images": n}
    for name in layouts:
        got = {}
        for device in (DEVICE, "cpu"):
            opt = config.load_infos(os.path.join(run_dir, "infos_.pkl"))["opt"]
            for k, v in LAYOUTS[name][0].items():
                setattr(opt, k, v)
            loader = data.DataLoader(opt, dataset=ds)
            params = checkpoint.load_params(model, device)
            losses, preds, _ = Evaluator(opt, device=device).eval_split(
                params, loader, ek)
            got[device] = (losses["loss_cap"],
                           {p["image_id"]: p["caption"] for p in preds})
        (a, caps), (b, caps_cpu) = got[DEVICE], got["cpu"]
        require(len(caps) == n and sorted(caps) == sorted(caps_cpu),
                f"evaluation {who} {name}: images of the card and the CPU")
        rate = float(np.mean([caps[i] == caps_cpu[i] for i in caps]))
        distinct = len(set(caps.values()))
        rel = abs(a - b) / abs(b)
        print(f"  {who}, {name}, {n} val images, card vs cpu port: captions "
              f"of {rate * 100:.1f}% of the images equal (need >= "
              f"{AGREE_F32 * 100:.0f}%), {distinct} distinct captions (need "
              f">= {min_distinct}); loss_cap {a:.6f} vs {b:.6f} (relative "
              f"{rel:.2e}, tol {EVAL_LOSS_RTOL:.0e})", flush=True)
        require(rate >= AGREE_F32, f"evaluation {who} {name}: captions of "
                f"{rate} of the images equal the CPU port's")
        require(distinct >= min_distinct, f"evaluation {who} {name}: "
                f"{distinct} distinct captions")
        require(rel <= EVAL_LOSS_RTOL,
                f"evaluation {who} {name}: loss_cap relative {rel}")


def phase_eval(smi):
    """TRAIN_RUN_DIR (phase 5's trained speaker) through eval.eval and
    Evaluator.eval_split, f32, beam 2, with each context layout."""
    import torch
    from cooperativeimagecaptioning_tpu_torch import config, data
    from cooperativeimagecaptioning_tpu_torch import eval as eval_entry
    from cooperativeimagecaptioning_tpu_torch.evaluation.eval_split import (
        MAX_IN_FLIGHT, Evaluator)
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.training import checkpoint
    model = os.path.join(TRAIN_RUN_DIR, "model-best.pth")
    infos = os.path.join(TRAIN_RUN_DIR, "infos_.pkl")
    t0 = time.perf_counter()
    ds = eval_dataset()
    n_test = sum(1 for im in ds.info["images"] if im["split"] == "test")
    batches = -(-n_test // EVAL_B)
    print(f"evaluation: {os.path.relpath(TRAIN_RUN_DIR, REPO)} (phase 5's "
          f"speaker), f32, beam 2, language_eval=1; {EVAL_IMAGES} synthetic "
          f"images made in {time.perf_counter() - t0:.1f} s, {n_test} in the "
          f"test split, batch {EVAL_B} ({batches} batches, 5 captions an "
          f"image in the loss)", flush=True)
    os.chdir(TRAIN_RUN_DIR)  # eval_results/ is written under the run dir
    T = L + 1
    total = {k: 0 for k in counted()}
    losses = {}
    for name, (kw, att_kernel) in LAYOUTS.items():
        # the user's entry point: eval.eval on the run dir
        opt = config.load_infos(infos)["opt"]
        opt.language_eval = 1  # the run trained without language metrics
        for k, v in kw.items():
            setattr(opt, k, v)
        _dispatch.reset_launches()
        t0 = time.perf_counter()
        out = eval_entry.eval(opt, model, infos, split="test", dataset=ds,
                              device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        preds, stats = out["split_predictions"], out["lang_stats"]
        want_ids = sorted(im["id"] for im in ds.info["images"]
                          if im["split"] == "test")
        require(sorted(p["image_id"] for p in preds) == want_ids,
                f"evaluation {name}: not one prediction per test image")
        require(all(isinstance(p["caption"], str) for p in preds),
                f"evaluation {name}: captions")
        require(np.isfinite(out["loss"]["loss_cap"]),
                f"evaluation {name}: loss_cap {out['loss']['loss_cap']}")
        for metric in ("CIDEr", "Bleu_1", "Bleu_4", "ROUGE_L", "METEOR"):
            require(metric in stats and np.isfinite(stats[metric]),
                    f"evaluation {name}: {metric} {stats.get(metric)}")
        # the loss runs the b-major attention T times a batch (no recompute
        # in eval mode), the decode its layout's attention and the beam head
        # L times a batch
        want = {k: 0 for k in counted()}
        want["attention"] = batches * T
        want[att_kernel] += batches * L
        want["beam_head"] = batches * L
        want["cell"] = batches * (T + L)
        want = with_cell_pass(want, "tf32x3")
        require(launches == want, f"evaluation {name}: launches {launches}, "
                f"expected {want}")
        require_vector_width(f"evaluation {name}", launches)
        require_head_pass(f"evaluation {name}", "tf32x3")
        require(_dispatch.head_pass_launches()["beam_head_tf32x3"]
                == want["beam_head"],
                f"evaluation {name}: the f32 beam head must take the "
                f"split-TF32 pass")
        for k, v in launches.items():
            total[k] += v
        losses[name] = out["loss"]["loss_cap"]
        print(f"  eval.eval {name}: {len(preds)} predictions, loss_cap "
              f"{out['loss']['loss_cap']:.4f}, CIDEr {stats['CIDEr']:.4f}, "
              f"Bleu_4 {stats['Bleu_4']:.4f}, ROUGE_L {stats['ROUGE_L']:.4f}, "
              f"METEOR {stats['METEOR']:.4f}; {wall:.2f} s in all; launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)

        # the evaluator itself, for its timings: the val split
        loader = data.DataLoader(opt, dataset=ds)
        params = checkpoint.load_params(model, DEVICE)
        ev = Evaluator(opt, device=DEVICE)
        ek = {"split": "val", "beam_size": 2, "language_eval": 0,
              "num_images": -1}
        ev.eval_split(params, loader, ek)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, val_preds, _ = ev.eval_split(params, loader, ek)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        require(len(val_preds) == batches * EVAL_B
                and ev.drained_in_loop == batches - MAX_IN_FLIGHT > 0,
                f"evaluation {name}: {len(val_preds)} val images, "
                f"{ev.drained_in_loop} batches drained inside the loop")
        print(f"  Evaluator.eval_split {name} ({smi}; f32, beam 2, loss and "
              f"decode, no language metrics): {len(val_preds)} images in "
              f"{wall:.3f} s = {len(val_preds) / wall:.1f} images/s; "
              f"{ev.drained_in_loop} of {batches} batches drained inside "
              f"the loop (at most {MAX_IN_FLIGHT} in flight); last_timings "
              f"{ev.last_timings}", flush=True)
        del ev, params, loader
    spread = max(losses.values()) - min(losses.values())
    require(spread <= 1e-6 * abs(losses["b-major"]),
            f"the loss must not depend on the decode layout: {losses}")

    # the decode's ids and the loss against the CPU port: the random-weight
    # speaker of phase 4 (its captions differ from image to image) with each
    # layout, and the trained speaker evaluated above
    eval_against_cpu(ds, RUN_DIR, "random-weight speaker", LAYOUTS,
                     min_distinct=EVAL_CPU_BATCHES * EVAL_B // 16)
    eval_against_cpu(ds, TRAIN_RUN_DIR, "trained speaker", ("b-major",),
                     min_distinct=1)
    os.chdir(REPO)
    return total


# ---------------------------------------------------------------------------
# 7. self-critical CIDEr-D training, resumed from phase 5's run dir
# ---------------------------------------------------------------------------

def scst_opt(batch_size, drop_prob_lm=0.5):
    """scripts/run_joint.py's flag set at -D 0 with phase=3 and
    is_alternating=0 (cider weight 1, no discriminative loss, no caption
    loss, lr 5e-4 decaying 0.8 every 15 epochs), vse_model None, resumed
    from phase 5's run dir."""
    return train_opt(batch_size, drop_prob_lm).replace(
        phase=3, cider_optimization=1, caption_loss_weight=0,
        retrieval_reward_weight=0, learning_rate=5e-4,
        learning_rate_decay_rate=0.8, learning_rate_decay_every=15,
        start_from=TRAIN_RUN_DIR, checkpoint_path=SCST_RUN_DIR)


def scst_per_iteration():
    """Launches of one self-critical iteration (L steps, remat on, no
    decoding constraint): stage A samples (L attention and cell steps) and
    decodes the greedy baseline (L steps, each through the greedy head);
    stage B samples again under autograd (L steps) and its backward
    recomputes the L - 1 checkpointed steps."""
    steps = L + L + L + (L - 1)
    return with_cell_pass({"attention": steps, "greedy_head": L,
                           "cell": steps}, "tf32x3")


def adam_file(path, optim, agent):
    """The Adam state of `agent` in an optimizer file the port wrote
    (optax's layout), mapped onto `optim`'s leaf paths: {'count', 'mu',
    'nu', 'paths'}; None if it holds another structure."""
    from cooperativeimagecaptioning_tpu_torch.training import checkpoint
    paths = optim.paths[agent]
    st = checkpoint.adam_state_from_file(
        checkpoint.read_optimizer_file(path), paths,
        [tuple(m.shape) for m in optim.states[agent]["mu"]])
    return None if st is None else dict(st, paths=paths)


def check_resumed(trainer, phase5):
    """Trainer(start_from=TRAIN_RUN_DIR): params and every Adam leaf equal
    the files, iteration and epoch resume."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.training import checkpoint
    from cooperativeimagecaptioning_tpu_torch.utils.tree import leaves
    saved = checkpoint.load_params(os.path.join(TRAIN_RUN_DIR, "model.pth"))
    got = leaves(trainer.params)
    require([k for k, _ in got] == [k for k, _ in leaves(saved)],
            "resumed params: another tree")
    for (k, a), (_, b) in zip(got, leaves(saved)):
        require(torch.equal(a.detach().cpu(), b), f"resumed param {k}")
    st = adam_file(os.path.join(TRAIN_RUN_DIR, "optimizer.pth"),
                   trainer.optim, "speaker")
    require(st is not None, "phase 5's optimizer.pth: another structure")
    cur = trainer.optim.states["speaker"]
    require(int(cur["count"]) == int(st["count"]) > 0, "resumed Adam count")
    for key in ("mu", "nu"):
        for path, a, b in zip(st["paths"], cur[key], st[key]):
            require(np.array_equal(a.cpu().numpy(), b),
                    f"resumed Adam {key} {path}")
    require((trainer.iteration, trainer.epoch) ==
            (phase5["iteration"], phase5["epoch"]),
            f"resumed counters {trainer.iteration}, {trainer.epoch}")
    print(f"  Trainer(start_from=phase 5's run dir): {len(got)} params and "
          f"2 x {len(cur['mu'])} Adam moments equal the files, Adam count "
          f"{int(cur['count'])}, iteration {trainer.iteration}, epoch "
          f"{trainer.epoch}", flush=True)


def scst_stages(trainer, data, turn=None):
    """The stages of one self-critical iteration of `turn` (the trainer's
    next one by default) on one host batch, {name: fn} in order: stage A
    (the sampled and the greedy decode), the host reward (ids to the host,
    CIDEr-D of 2B captions, the reward to the card), stage B (forward +
    backward), Adam; a turn without the reward (the listener's) has stage B
    and Adam only."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.training import joint
    turn = trainer.turn if turn is None else turn
    batch = trainer._prepare_batch(data)
    hp = trainer._hyper()
    out = {"reward": None}

    def stage_a():
        out["ids"] = trainer._sample_fns[turn](
            trainer.params, batch, trainer.iteration_streams(), hp)

    def reward():
        reward, _, _ = joint.host_reward(trainer.opt, data["gts"],
                                         *out["ids"])
        out["reward"] = torch.from_numpy(reward).to(trainer.device)

    def stage_b():
        _, out["grads"] = trainer._grad_fns[turn](
            trainer.params, batch, trainer.iteration_streams(), hp,
            out["reward"])

    def adam():
        trainer.optim.step(trainer.params, out["grads"], turn)

    if not joint.needs_reward(trainer.opt, turn):
        return {"stage_b": stage_b, "adam": adam}
    return {"stage_a": stage_a, "reward": reward, "stage_b": stage_b,
            "adam": adam}


def scst_split(trainer, data, n=SCST_ITERS, turn=None):
    """Median ms of each stage of `scst_stages`, each ended by a
    synchronize, over n iterations of `turn` on one host batch."""
    import torch
    t = {}
    for _ in range(n):
        for stage, fn in scst_stages(trainer, data, turn).items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            t.setdefault(stage, []).append((time.perf_counter() - t0) * 1e3)
    return {k: float(np.median(v)) for k, v in t.items()}


def scst_against_cpu(ds):
    """The first self-critical step at B=SCST_CPU_B, dropout off, on the
    card and on the CPU port fed the same noise (the card's draws,
    recorded and replayed): the share of rows whose sampled ids are equal
    (>= AGREE_F32); on the equal rows loss_cider to STEP_LOSS_RTOL and
    every gradient leaf by phase 5's rule."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops import draws
    from cooperativeimagecaptioning_tpu_torch.training import joint
    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    opt = scst_opt(SCST_CPU_B, drop_prob_lm=0.0)
    tr = Trainer(opt, dataset=ds, device=DEVICE, verbose=False)
    data = tr.loader.get_batch("train")
    batch = tr._prepare_batch(data)
    hp = tr._hyper()
    rec = {k: draws.Record(v) for k, v in tr.iteration_streams().items()}
    gen, greedy = tr._sample_fns[tr.turn](tr.params, batch, rec, hp)
    scores, _, _ = joint.host_reward(opt, data["gts"], gen, greedy)
    taken = {k: [x.cpu() for x in r.taken] for k, r in rec.items()}
    cpu_params = cpu_copy(tr.params)
    cpu_batch = {k: None if v is None else v.cpu() for k, v in batch.items()}
    fn = joint.value_and_grad(opt, "optimizer")

    def step(params, b, rows, device):
        replay = {k: draws.Replay([x[rows] for x in v])
                  for k, v in taken.items()}
        sampled = {}
        reward = torch.from_numpy(scores[rows.numpy()])
        (loss, aux), grads = fn(params, b, replay, hp, reward.to(device),
                                sampled)
        return aux["loss_cider"].item(), grads, sampled["seq"].cpu()

    def rows_of(b, rows):
        return {k: None if v is None else v[rows] for k, v in b.items()}

    every = torch.arange(SCST_CPU_B)
    _, _, seq_g = step(tr.params, batch, every, DEVICE)
    _, _, seq_c = step(cpu_params, cpu_batch, every, "cpu")
    equal = (seq_g == seq_c).all(dim=1)
    share = float(equal.float().mean())
    require(torch.equal(seq_g, gen.cpu()),
            "B=16 step: stage B's ids on the card differ from stage A's")
    rows = torch.nonzero(equal)[:, 0]
    loss_g, grads_g, _ = step(tr.params, rows_of(batch, rows.to(DEVICE)),
                              rows, DEVICE)
    loss_c, grads_c, _ = step(cpu_params, rows_of(cpu_batch, rows), rows,
                              "cpu")
    rel = abs(loss_g - loss_c) / abs(loss_c)
    worst, worst_key, _ = grads_against(grads_g, grads_c)
    print(f"  B={SCST_CPU_B} first SCST step, card vs cpu port on the same "
          f"noise: sampled ids of {share * 100:.1f}% of the rows equal (need "
          f">= {AGREE_F32 * 100:.0f}%); on those {len(rows)} rows loss_cider "
          f"{loss_g:.6f} vs {loss_c:.6f} (relative {rel:.2e}, tol "
          f"{STEP_LOSS_RTOL:.0e}); worst gradient leaf {worst_key} at "
          f"{worst:.3f} of its tolerance", flush=True)
    require(share >= AGREE_F32, f"B=16 SCST step: {share} of rows equal")
    require(rel <= STEP_LOSS_RTOL, f"B=16 SCST step: loss_cider relative "
            f"{rel}")
    require(worst <= 1.0, f"B=16 SCST step: gradient {worst_key} at "
            f"{worst} of its tolerance")
    return share, rel


def scst_eval_sampling(trainer, ds):
    """Evaluator.eval_split with sample_max 0 and 2 under each layout, the
    SCST speaker's params: one caption per val image, the loss's T b-major
    attention steps and the decode's L steps of the layout's kernel a
    batch, no head kernel (the sampled decodes take a plain log-softmax)."""
    import torch
    from cooperativeimagecaptioning_tpu_torch import data
    from cooperativeimagecaptioning_tpu_torch.evaluation.eval_split import (
        Evaluator)
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    total = {k: 0 for k in counted()}
    T = L + 1
    for sample_max in (0, 2):
        for name, (kw, att_kernel) in LAYOUTS.items():
            # the eval loss of a caption-loss run: the CIDEr term would add
            # the reward's decodes to the counts
            opt = trainer.opt.replace(cider_optimization=0,
                                      caption_loss_weight=1, **kw)
            loader = data.DataLoader(opt, dataset=ds)
            n_val = len(loader.split_ix["val"])
            batches = -(-n_val // loader.batch_size)
            _dispatch.reset_launches()
            losses, preds, _ = Evaluator(opt, device=DEVICE).eval_split(
                trainer.params, loader,
                {"split": "val", "sample_max": sample_max, "beam_size": 1,
                 "language_eval": 0, "num_images": -1})
            torch.cuda.synchronize()
            launches = launch_counts()
            want = {k: 0 for k in counted()}
            want["attention"] = batches * T
            want[att_kernel] += batches * L
            want["cell"] = batches * (T + L)
            want = with_cell_pass(want, "tf32x3")
            require(launches == want, f"eval sample_max={sample_max} {name}: "
                    f"launches {launches}, expected {want}")
            require_vector_width(f"eval sample_max={sample_max} {name}",
                                 launches)
            require_head_pass(f"eval sample_max={sample_max} {name}",
                              "tf32x3")
            ids = sorted(p["image_id"] for p in preds)
            require(len(ids) == n_val == len(set(ids)),
                    f"eval sample_max={sample_max} {name}: {len(ids)} "
                    f"captions for {n_val} images")
            require(np.isfinite(losses["loss_cap"]),
                    f"eval sample_max={sample_max} {name}: {losses}")
            for k, v in launches.items():
                total[k] += v
            print(f"  eval_split sample_max={sample_max} {name}: {n_val} "
                  f"captions ({len({p['caption'] for p in preds})} "
                  f"distinct), loss_cap {losses['loss_cap']:.4f}; launches "
                  f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    return total


def serve_run_dir(run_dir, fc, att, masks):
    """Greedy ids of one bucket-512 bf16 request through from_run_dir, and
    the launches of that request."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.serving import CaptioningService
    svc = CaptioningService.from_run_dir(run_dir, compute_dtype="bfloat16",
                                         buckets=(512,), device=DEVICE)
    svc.caption_ids(fc[:1], att[:1], masks[:1])
    _dispatch.reset_launches()
    ids = svc.caption_ids(fc, att, masks)
    torch.cuda.synchronize()
    return ids, launch_counts()


def scst_run_dirs(trainer, ds):
    """checkpoint_operations on the SCST trainer (the eval loss with its
    CIDEr-D term), that run dir served; then a joint run dir of phase 4's
    speaker (its embedding at listener/txt_enc/embed under share_embed=1)
    through eval.eval and from_run_dir, against phase 4's speaker-only
    dir."""
    import torch
    from cooperativeimagecaptioning_tpu_torch import eval as eval_entry
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.training import checkpoint
    t0 = time.perf_counter()
    val_loss, _ = trainer.checkpoint_operations()
    torch.cuda.synchronize()
    written = sorted(os.listdir(SCST_RUN_DIR))
    for name in ("model.pth", f"model-{trainer.iteration}.pth",
                 "model-best.pth", "optimizer.pth", "infos_.pkl",
                 "histories_.pkl"):
        require(name in written, f"SCST checkpoint_operations: {written}")
    require(np.isfinite(val_loss["loss_cider"]), f"SCST val loss {val_loss}")
    print(f"  checkpoint_operations of the SCST run in "
          f"{time.perf_counter() - t0:.1f} s: val loss_cider "
          f"{val_loss['loss_cider']:.4f} (stage A + host reward + the "
          f"CIDEr-D term); wrote {written}", flush=True)

    fc, att, masks = features(512, seed=513)
    ids, served = serve_run_dir(SCST_RUN_DIR, fc, att, masks)
    want = with_cell_pass({"attention": L, "greedy_head": L, "cell": L},
                          "mma")
    require(served == want, f"serving the SCST run: launches {served}")
    require(ids.shape == (512, L) and ids.min() >= 0 and ids.max() <= VOCAB,
            f"SCST ids {ids.shape}")

    print(f"  from_run_dir(SCST run dir), bucket 512 bf16 greedy: ids "
          f"{ids.shape}, launches "
          f"{ {k: v for k, v in served.items() if v} }", flush=True)

    # a joint run dir: phase 4's random-weight speaker (its captions differ
    # from image to image), its table under the listener (share_embed=1)
    sp = checkpoint.load_params(os.path.join(RUN_DIR, "model-best.pth"))[
        "speaker"]
    tree = {"speaker": {k: v for k, v in sp.items() if k != "embed"},
            "listener": {"txt_enc": {"embed": sp["embed"]}}}
    os.makedirs(JOINT_RUN_DIR, exist_ok=True)
    checkpoint.save_params(tree, os.path.join(JOINT_RUN_DIR,
                                              "model-best.pth"))
    infos = checkpoint.load_pkl(os.path.join(RUN_DIR, "infos_.pkl"))
    opt = infos["opt"].replace(vse_model="fc", share_embed=1, rank_eval=0,
                               checkpoint_path=JOINT_RUN_DIR)
    with open(os.path.join(JOINT_RUN_DIR, "infos_.pkl"), "wb") as f:
        pickle.dump({"opt": opt, "vocab": infos["vocab"]}, f)
    ids, _ = serve_run_dir(RUN_DIR, fc, att, masks)
    joint_ids, joint_served = serve_run_dir(JOINT_RUN_DIR, fc, att, masks)
    require(np.array_equal(joint_ids, ids) and joint_served == served,
            "the joint run dir serves other ids than the speaker-only dir")
    preds = {}
    os.chdir(JOINT_RUN_DIR)  # eval_results/ is written under the run dir
    for d in (RUN_DIR, JOINT_RUN_DIR):
        out = eval_entry.eval(None, os.path.join(d, "model-best.pth"),
                              os.path.join(d, "infos_.pkl"), split="test",
                              dataset=ds, device=DEVICE)
        preds[d] = [(p["image_id"], p["caption"])
                    for p in out["split_predictions"]]
    os.chdir(REPO)
    distinct = len({c for _, c in preds[RUN_DIR]})
    require(preds[JOINT_RUN_DIR] == preds[RUN_DIR] and distinct > 1,
            f"eval.eval of the joint run dir: other captions, or "
            f"{distinct} distinct")
    print(f"  a joint run dir (phase 4's speaker, its embedding at "
          f"listener/txt_enc/embed, share_embed=1): from_run_dir serves the "
          f"ids of the speaker-only dir ({len({tuple(r) for r in ids})} "
          f"distinct rows of 512) and eval.eval gives its "
          f"{len(preds[RUN_DIR])} test captions ({distinct} distinct)",
          flush=True)
    return served


def phase_scst(smi, phase5):
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    ds = train_dataset()
    print(f"self-critical training: att2in2 vocab {VOCAB}, width {WIDTH}, "
          f"K={K}, L={L}, B={TRAIN_B}, f32, drop_prob_lm 0.5, "
          f"cider_optimization 1, caption_loss_weight 0, host reward "
          f"(CIDEr-D of {2 * TRAIN_B} captions an iteration), from "
          f"{os.path.relpath(TRAIN_RUN_DIR, REPO)}", flush=True)
    out = {}
    trainer = Trainer(scst_opt(TRAIN_B), dataset=ds, device=DEVICE,
                      verbose=False)
    check_resumed(trainer, phase5)

    # the main path: SCST_ITERS iterations; the counts run from 0 before
    # the first
    _dispatch.reset_launches()
    t0 = time.perf_counter()
    for _ in range(SCST_ITERS):
        loss_dict, _, _ = trainer.train_iteration()
        a, b = trainer.last_reward_seqs
        require(torch.equal(a, b), "stage B's sampled ids differ "
                "from stage A's")
        vals = {k: float(loss_dict[k]) for k in (
            "loss_cider", "avg_reward", "cider_greedy")}
        require(all(np.isfinite(v) for v in vals.values()),
                f"SCST iteration: {vals}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = launch_counts()
    per = scst_per_iteration()
    want = {k: SCST_ITERS * per.get(k, 0) for k in got}
    require(got == want, f"SCST: launches {got}, expected {want} ({per} an "
            f"iteration)")
    print(f"  {SCST_ITERS} SCST iterations: {wall:.2f} s; last loss_cider "
          f"{vals['loss_cider']:.4f}, avg_reward {vals['avg_reward']:.4f}, "
          f"cider_greedy {vals['cider_greedy']:.4f}; stage B's ids equal "
          f"stage A's every iteration; launches {got}", flush=True)
    launches = launch_counts()
    require_vector_width("SCST", launches)
    require_head_pass("SCST", "tf32x3")
    require(_dispatch.head_pass_launches()["greedy_head_tf32x3"] ==
            launches["greedy_head"], "SCST: the f32 greedy head must take "
            "the split-TF32 pass")

    # where an iteration's time goes, and it/s
    data = trainer.loader.get_batch("train")
    out["split_ms"] = scst_split(trainer, data)
    out["its"] = iterations_per_s(trainer, data, n=SCST_ITERS)
    print(f"  SCST iteration ({smi}; B={TRAIN_B}, f32, one fixed host "
          f"batch, medians of {SCST_ITERS}): stage A "
          f"{out['split_ms']['stage_a']:.2f} ms, host reward "
          f"{out['split_ms']['reward']:.2f} ms, stage B forward + backward "
          f"{out['split_ms']['stage_b']:.2f} ms, Adam "
          f"{out['split_ms']['adam']:.2f} ms; {out['its']:.2f} it/s",
          flush=True)

    out["cpu_share"], out["cpu_rel"] = scst_against_cpu(ds)
    scst_eval_sampling(trainer, ds)
    scst_run_dirs(trainer, ds)
    return launches, out


# ---------------------------------------------------------------------------
# 8. the listener: phase 1, joint DISC training, retrieval, the FC speaker
# ---------------------------------------------------------------------------

def listener_opt(flags, batch_size, **kw):
    """Options of a flag set (PHASE1_FLAGS, or JOINT_BASE with
    joint_flags(mode)) at reference width, f32; the listener at the
    config's defaults (vse_embed_size 1024, GRU, 'last' pooling, margin
    0.2, max violation)."""
    from cooperativeimagecaptioning_tpu_torch.config import Options
    base = dict(flags, batch_size=batch_size, rnn_size=WIDTH,
                input_encoding_size=WIDTH, att_hid_size=WIDTH,
                fc_feat_size=FEAT, att_feat_size=FEAT, max_att_len=K,
                save_checkpoint_every=10 ** 9, losses_log_every=1,
                prefetch_batches=0, seed=SEED, max_epochs=-1)
    base.update(kw)
    return Options(**base)


def phase1_opt(batch_size):
    return listener_opt(PHASE1_FLAGS, batch_size, checkpoint_path=FC_RUN_DIR)


def disc_opt(mode, batch_size, **kw):
    """run_joint.py -o <mode>, seeded as that script seeds it: phase 5's
    stage-2 speaker with its Adam state, (a)'s listener."""
    base = dict(
        checkpoint_path=DISC_RUN_DIR, start_from=DISC_RUN_DIR,
        speaker_stage_2_model_path=os.path.join(TRAIN_RUN_DIR, "model.pth"),
        speaker_stage_2_optimizer_path=os.path.join(TRAIN_RUN_DIR,
                                                    "optimizer.pth"),
        initialize_retrieval=os.path.join(FC_RUN_DIR, "model_vse-best.pth"))
    base.update(kw)
    return listener_opt({**JOINT_BASE, **joint_flags(mode)}, batch_size,
                        **base)


def listener_phase1(ds, add, out):
    """(a) Phase 1 through loop.train: the listener alone moves, loss_vse
    falls on one batch, the B=16 step on the card against the CPU port,
    it/s, and checkpoint_operations writing the stage-1 run dir."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.training import joint, loop
    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    from cooperativeimagecaptioning_tpu_torch.utils.tree import leaves
    opt = phase1_opt(TRAIN_B)
    steps = 3
    _dispatch.reset_launches()
    t0 = time.perf_counter()
    tr = loop.train(opt, dataset=ds, max_iterations=steps, device=DEVICE,
                    verbose=False)
    torch.cuda.synchronize()
    got = launch_counts()
    add(got)
    # the loss holds the listener alone: no kernel, the speaker untouched
    # (the Trainer's initial tree, made again from the seed once the loader
    # has set the vocabulary)
    require(not any(got.values()), f"phase 1 launched {got}")
    fresh = dict(leaves(joint.init_params(SEED, opt)))
    for key, x in leaves(tr.params):
        same = torch.equal(x.detach().cpu(), fresh[key])
        require(same == key.startswith("speaker."),
                f"phase 1: {key} {'did not move' if same else 'moved'}")
    losses = [float(v) for v in tr.loss_history.values()]
    require(len(losses) == steps and all(np.isfinite(losses)),
            f"phase-1 losses {losses}")
    print(f"  loop.train(phase 1, max_iterations={steps}) in "
          f"{time.perf_counter() - t0:.1f} s: loss_vse {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; only the listener's "
          f"{sum(k.startswith('listener.') for k in fresh)} leaves moved",
          flush=True)

    # the B=16 step on the card against the CPU port (no draws: the
    # listener has no dropout and the speaker is not in the loss)
    small = Trainer(phase1_opt(LISTENER_CPU_B), dataset=ds, device=DEVICE,
                    verbose=False)
    data = small.loader.get_batch("train")
    batch = small._prepare_batch(data)
    fn = joint.value_and_grad(small.opt, small.turn)
    hp = small._hyper()
    (loss_g, _), grads_g = fn(small.params, batch, None, hp)
    cpu_batch = {k: None if v is None else v.cpu() for k, v in batch.items()}
    (loss_c, _), grads_c = fn(cpu_copy(small.params), cpu_batch, None, hp)
    rel = abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())
    worst, worst_key, max_abs = grads_against(grads_g["listener"],
                                              grads_c["listener"])
    print(f"  B={LISTENER_CPU_B} phase-1 step, card vs cpu port: loss_vse "
          f"{loss_g.item():.6f} vs {loss_c.item():.6f} (relative {rel:.2e}, "
          f"tol {STEP_LOSS_RTOL:.0e}); listener gradients max abs "
          f"difference {max_abs:.3e}, worst leaf {worst_key} at {worst:.3f} "
          f"of its tolerance", flush=True)
    require(rel <= STEP_LOSS_RTOL, f"phase-1 B=16 loss: relative {rel}")
    require(worst <= 1.0, f"phase-1 B=16 gradient {worst_key}: {worst}")
    del small

    data = tr.loader.get_batch("train")
    curve = [tr.train_iteration(data)[0]["loss_vse"].item()
             for _ in range(LEARN_STEPS)]
    print(f"  {LEARN_STEPS} phase-1 steps on one batch: loss_vse "
          f"{curve[0]:.4f} -> {curve[-1]:.4f}", flush=True)
    require(all(np.isfinite(curve)) and curve[-1] < curve[0]
            and np.mean(curve[-5:]) < np.mean(curve[:5]),
            f"loss_vse did not fall: {curve}")
    out["p1_its"] = iterations_per_s(tr, data)
    print(f"  phase-1 throughput (B={TRAIN_B}, f32, one fixed host batch): "
          f"{out['p1_its']:.2f} it/s", flush=True)

    # on to PHASE1_ITERS iterations through Trainer.train, as a user goes on
    _dispatch.reset_launches()
    t0 = time.perf_counter()
    tr.train(max_iterations=PHASE1_ITERS)
    torch.cuda.synchronize()
    got = launch_counts()
    add(got)
    require(not any(got.values()), f"phase 1 launched {got}")
    last = float(tr.loss_history[tr.iteration])
    require(np.isfinite(last), f"phase-1 loss {last}")
    print(f"  Trainer.train(max_iterations={PHASE1_ITERS}) in "
          f"{time.perf_counter() - t0:.1f} s: loss_vse {last:.4f} at "
          f"iteration {tr.iteration}", flush=True)

    # the FC decode of the eval through F
    _dispatch.reset_launches()
    t0 = time.perf_counter()
    val_loss, _ = tr.checkpoint_operations()
    torch.cuda.synchronize()
    got = launch_counts()
    add(got)
    out["p1_ckpt_s"] = time.perf_counter() - t0
    out["p1_rank_s"] = tr.evaluator().last_timings["rank_eval_s"]
    require(got["greedy_head"] > 0 and got["cell"] > 0,
            f"phase-1 eval decode: launches {got}")
    for split in ("val", "test"):
        ranks = val_loss.get(split, {})
        require(all(np.isfinite(ranks.get(k, np.nan)) for k in
                    ("rsum", "i2t_r1", "t2i_r1", "i2t_medr", "t2i_medr")),
                f"phase-1 ranks on {split}: {ranks}")
    written = sorted(os.listdir(FC_RUN_DIR))
    for name in ("model.pth", "model-best.pth", "model_vse-best.pth",
                 "optimizer.pth", "infos_fc_con.pkl",
                 "histories_fc_con.pkl"):
        require(name in written, f"phase-1 checkpoint_operations: {written}")
    st = adam_file(os.path.join(FC_RUN_DIR, "optimizer.pth"), tr.optim,
                   "listener")
    require(st is not None and int(st["count"]) == tr.iteration,
            "phase-1 optimizer.pth does not hold the listener")
    print(f"  phase-1 checkpoint_operations in {out['p1_ckpt_s']:.1f} s "
          f"(rank pass {out['p1_rank_s']:.3f} s): val rsum "
          f"{val_loss['val']['rsum']:.1f}, test rsum "
          f"{val_loss['test']['rsum']:.1f}; wrote {written}; launches "
          f"{ {k: v for k, v in got.items() if v} }", flush=True)
    return tr


def check_joint_seeded(tr):
    """The joint trainer's params and both agents' Adam moments equal the
    stage files: phase 5's speaker and (a)'s listener."""
    from cooperativeimagecaptioning_tpu_torch.training import checkpoint
    from cooperativeimagecaptioning_tpu_torch.utils.tree import leaves
    import torch
    files = {
        "speaker": (os.path.join(TRAIN_RUN_DIR, "model.pth"),
                    os.path.join(TRAIN_RUN_DIR, "optimizer.pth")),
        "listener": (os.path.join(FC_RUN_DIR, "model_vse-best.pth"),
                     os.path.join(FC_RUN_DIR, "optimizer.pth"))}
    for agent, (model, optim) in files.items():
        saved = checkpoint.load_params(model)[agent]
        got = leaves(tr.params[agent])
        require([k for k, _ in got] == [k for k, _ in leaves(saved)],
                f"joint {agent}: another tree")
        for (k, a), (_, b) in zip(got, leaves(saved)):
            require(torch.equal(a.detach().cpu(), b), f"joint {agent} {k}")
        st = adam_file(optim, tr.optim, agent)
        require(st is not None, f"{optim}: another structure")
        cur = tr.optim.states[agent]
        require(int(cur["count"]) == int(st["count"]) > 0,
                f"joint {agent} Adam count")
        for key in ("mu", "nu"):
            for path, a, b in zip(st["paths"], cur[key], st[key]):
                require(np.array_equal(a.cpu().numpy(), b),
                        f"joint {agent} Adam {key} {path}")
    n = {a: len(tr.optim.paths[a]) for a in files}
    print(f"  joint Trainer seeded: speaker and {n['speaker']} x 2 Adam "
          f"moments from phase 5's run dir, listener and {n['listener']} x 2 "
          f"from (a)'s", flush=True)


def listener_joint(ds, add, out, smi):
    """(b) run_joint.py -o gumbel: five iterations, the launches of A, B
    and F an iteration, the time split and it/s."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    tr = Trainer(disc_opt("gumbel", TRAIN_B), dataset=ds, device=DEVICE,
                 verbose=False)
    require(tr.turns == ["speaker"] and tr.turn == "speaker",
            f"joint turns {tr.turns}")
    check_joint_seeded(tr)
    probes = {"speaker": ("logit", "b"), "listener": ("img_enc", "fc", "b")}

    def probe(agent):
        x = tr.params[agent]
        for k in probes[agent]:
            x = x[k]
        return x.detach().clone()

    keys = ("loss", "retrieval_loss", "loss_cider", "avg_reward",
            "cider_greedy")
    _dispatch.reset_launches()
    t0 = time.perf_counter()
    for _ in range(LISTENER_ITERS):
        old = {a: probe(a) for a in probes}
        loss_dict, turn, _ = tr.train_iteration()
        a, b = tr.last_reward_seqs
        require(turn == "speaker" and torch.equal(a, b),
                "joint: stage B's sampled ids differ from stage A's")
        vals = {k: float(loss_dict[k]) for k in keys}
        require(all(np.isfinite(v) for v in vals.values()),
                f"joint iteration: {vals}")
        for agent in probes:
            require(not torch.equal(old[agent], probe(agent)),
                    f"joint: the {agent}'s leaves did not move")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = launch_counts()
    # a joint iteration launches what an SCST iteration does: stage A's
    # gumbel_st decode and the greedy baseline, stage B's gumbel_st decode
    # and its recompute; the listener runs no kernel
    per = scst_per_iteration()
    want = {k: LISTENER_ITERS * per.get(k, 0) for k in got}
    require(got == want, f"joint: launches {got}, expected {want} ({per} an "
            f"iteration)")
    print(f"  {LISTENER_ITERS} joint iterations (-o gumbel): {wall:.2f} s; "
          f"last " + ", ".join(f"{k} {v:.4f}" for k, v in vals.items())
          + f"; stage B's ids equal stage A's, both agents moved every "
          f"iteration; launches {got}", flush=True)
    launches = launch_counts()
    add(launches)
    require_vector_width("joint", launches)
    require_head_pass("joint", "tf32x3")
    require(_dispatch.head_pass_launches()["greedy_head_tf32x3"] ==
            launches["greedy_head"], "joint: the f32 greedy head must take "
            "the split-TF32 pass")

    data = tr.loader.get_batch("train")
    out["joint_split_ms"] = scst_split(tr, data, n=LISTENER_ITERS)
    out["joint_its"] = iterations_per_s(tr, data, n=LISTENER_ITERS)
    sp = out["joint_split_ms"]
    print(f"  joint iteration ({smi}; B={TRAIN_B}, f32, one fixed host "
          f"batch, medians of {LISTENER_ITERS}): stage A "
          f"{sp['stage_a']:.2f} ms, host reward {sp['reward']:.2f} ms, stage "
          f"B forward + backward {sp['stage_b']:.2f} ms, Adam "
          f"{sp['adam']:.2f} ms; {out['joint_its']:.2f} it/s", flush=True)
    return tr


def disc_against_cpu(ds):
    """(c) The first joint step at B=16, dropout off, in each relaxed mode:
    stage B on the card with its draws recorded, then on the CPU port
    replaying them: DISC's and the CIDEr sample's rows all equal,
    retrieval_loss and loss_cider to 1e-4 relative, every gradient leaf of
    both agents by phase 5's rule."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops import draws
    from cooperativeimagecaptioning_tpu_torch.training import joint
    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    out = {}
    for mode in DISC_MODES:
        tr = Trainer(disc_opt(mode, LISTENER_CPU_B, drop_prob_lm=0.0,
                              start_from=None),
                     dataset=ds, device=DEVICE, verbose=False)
        data = tr.loader.get_batch("train")
        batch = tr._prepare_batch(data)
        hp = tr._hyper()
        gen, greedy = tr._sample_fns[tr.turn](tr.params, batch,
                                              tr.iteration_streams(), hp)
        reward, _, _ = joint.host_reward(tr.opt, data["gts"], gen, greedy)
        reward = torch.from_numpy(reward)
        rec = {k: draws.Record(v) for k, v in tr.iteration_streams().items()}
        seen_g, seen_c = {}, {}
        (_, aux_g), grads_g = tr._grad_fns[tr.turn](
            tr.params, batch, rec, hp, reward.to(DEVICE), seen_g)
        require(torch.equal(seen_g["seq"], gen),
                f"{mode}: stage B's ids on the card differ from stage A's")
        replay = {k: draws.Replay([x.cpu() for x in r.taken])
                  for k, r in rec.items()}
        cpu_batch = {k: None if v is None else v.cpu()
                     for k, v in batch.items()}
        (_, aux_c), grads_c = tr._grad_fns[tr.turn](
            cpu_copy(tr.params), cpu_batch, replay, hp, reward, seen_c)
        shares = {k: float((seen_g[k].cpu() == seen_c[k]).all(dim=1).float()
                           .mean()) for k in ("disc_seq", "seq")}
        rels = {k: abs(aux_g[k].item() - aux_c[k].item()) /
                abs(aux_c[k].item()) for k in ("retrieval_loss", "loss_cider")}
        worst, worst_key, max_abs = grads_against(grads_g, grads_c)
        print(f"  B={LISTENER_CPU_B} {mode} step, card vs cpu port on the "
              f"card's noise: rows equal {shares}; relative "
              + ", ".join(f"{k} {v:.2e}" for k, v in rels.items())
              + f"; gradients of both agents max abs difference "
              f"{max_abs:.3e}, worst leaf {worst_key} at {worst:.3f} of its "
              f"tolerance", flush=True)
        require(all(v == 1.0 for v in shares.values()),
                f"{mode}: rows equal {shares}")
        require(all(v <= 1e-4 for v in rels.values()), f"{mode}: {rels}")
        require(worst <= 1.0, f"{mode}: gradient {worst_key} at {worst}")
        out[mode] = {"rel": rels, "worst": worst}
        del tr
    return out


def near_tie_queries(scores, targets, topk, tol=1e-6):
    """Queries (rows of the CPU's f32 scores) whose ranks or top-k hits a
    rounding difference may move: (a target score within `tol` of another
    column's, two of the top topk + 1 scores within `tol`), as two [Q]
    bool arrays."""
    import torch
    s = scores
    tgt = torch.as_tensor(np.asarray(targets, np.int64))
    tval = torch.gather(s, 1, tgt)                       # [Q, T]
    close = (s[:, None, :] - tval[:, :, None]).abs() <= tol
    close.scatter_(2, tgt[:, :, None], False)
    top = torch.topk(s, min(topk + 1, s.shape[1]), dim=1).values
    gaps = (top[:, :-1] - top[:, 1:]) <= tol
    return close.any(dim=2).any(dim=1).numpy(), gaps.any(dim=1).numpy()


def ranks_against_cpu(tr):
    """(d) The joint listener's embeddings of every split (GT and generated
    captions) through scores_ranks_hits on the card and on the CPU: equal
    ranks and hits except on near-tie queries, which are at most 1% of
    them.  All three splits: the held-out captions of random synthetic
    words lie close together (about 3% of a held-out split's i2t queries
    hold a tie within 1e-6), so one split alone leaves the 1% gate a few
    queries of room."""
    from cooperativeimagecaptioning_tpu_torch.evaluation import retrieval
    from cooperativeimagecaptioning_tpu_torch.utils.tree import detached
    ev = tr.evaluator()
    cpi = tr.loader.ds.gt_caps_per_image
    queries = differ = near_n = 0
    for split, gen in [(s, g) for s in ("train", "val", "test")
                       for g in (False, True)]:
        img, cap, _ = ev.encode_data(detached(tr.params), tr.loader,
                                     {"split": split, "num_images": -1},
                                     use_gen_sent=gen)
        c = 1 if gen else cpi
        n = img.shape[0] // c
        cases = [("t2i", cap[:c * n], img[::c][:n],
                  np.repeat(np.arange(n), c)[:, None], 4)]
        if not gen:
            cases.append(("i2t", img[::c][:n], cap,
                          np.arange(n)[:, None] * c + np.arange(c)[None, :],
                          1))
        for name, q, pool, tgt, topk in cases:
            got = retrieval.scores_ranks_hits(q, pool, tgt, topk)
            qc, pc = q.cpu(), pool.cpu()
            want = retrieval.scores_ranks_hits(qc, pc, tgt, topk)
            with retrieval._full_f32_matmul():
                target_tie, hit_tie = near_tie_queries(qc @ pc.T, tgt, topk)
            near = target_tie | hit_tie
            bad = (got[0] != want[0]).any(axis=1) | \
                (got[1] != want[1]).any(axis=1)
            require(not (bad & ~near).any(),
                    f"ranks {name}: {int((bad & ~near).sum())} queries "
                    f"differ between the card and the CPU off near-ties")
            queries += len(bad)
            differ += int(bad.sum())
            near_n += int(near.sum())
            print(f"  ranks {name} ({split}, "
                  f"{'generated' if gen else 'GT'} captions, "
                  f"{len(bad)} queries x {pool.shape[0]}): card vs cpu "
                  f"port, {int(bad.sum())} differ; near ties within 1e-6: "
                  f"{int(target_tie.sum())} at a target, "
                  f"{int(hit_tie.sum())} among the top {topk + 1}",
                  flush=True)
    print(f"  ranks card vs cpu port, all splits: {differ} of {queries} "
          f"queries differ, {near_n} near ties", flush=True)
    require(near_n <= 0.01 * queries,
            f"{near_n} near-tie queries of {queries}")
    return {"queries": queries, "differ": differ, "near_ties": near_n}


def protocol_rank_seconds():
    """rank_metrics at the COCO protocol's size on the card: 5000 images x
    5 GT captions of random unit embeddings, E=1024 (i2t and t2i); median
    seconds of 3 after a warm-up."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.evaluation import retrieval
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    n, c, e = 5000, 5, 1024
    img = torch.randn((n, e), generator=gen, device=DEVICE)
    cap = torch.randn((n * c, e), generator=gen, device=DEVICE)
    img = (img / img.norm(dim=1, keepdim=True)).repeat_interleave(c, 0)
    cap = cap / cap.norm(dim=1, keepdim=True)
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = retrieval.rank_metrics(img, cap, caps_per_image=c)
        times.append(time.perf_counter() - t0)
    require(np.isfinite(m["rsum"]), f"protocol ranks {m['rsum']}")
    return float(np.median(times[1:]))


def listener_eval(tr, ds, add, out):
    """(d) checkpoint_operations of the joint trainer, eval.eval with the
    trained and the ground-truth listener, the rank arrays against the CPU
    port, and the rank pass at the protocol's size."""
    import torch
    from cooperativeimagecaptioning_tpu_torch import eval as eval_entry
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    _dispatch.reset_launches()
    t0 = time.perf_counter()
    val_loss, _ = tr.checkpoint_operations()
    torch.cuda.synchronize()
    got = launch_counts()
    add(got)
    out["joint_ckpt_s"] = time.perf_counter() - t0
    out["joint_rank_s"] = tr.evaluator().last_timings["rank_eval_s"]
    written = sorted(os.listdir(DISC_RUN_DIR))
    for name in ("alternatingModel.pth",
                 f"alternatingModel-{tr.iteration}.pth", "model-best.pth",
                 "model_vse-best.pth", "speaker_optimizer.pth",
                 "listener_optimizer.pth", "infos_.pkl", "histories_.pkl"):
        require(name in written, f"joint checkpoint_operations: {written}")
    gt = val_loss.get("gt_ranks", {})
    require(np.isfinite(val_loss.get("t2i_r1", np.nan)) and
            np.isfinite(gt.get("i2t_r1", np.nan)) and
            np.isfinite(val_loss["retrieval_loss"]),
            f"joint val: {sorted(val_loss)}")
    print(f"  joint checkpoint_operations in {out['joint_ckpt_s']:.1f} s "
          f"(rank pass {out['joint_rank_s']:.3f} s): generated-caption t2i "
          f"r1 {val_loss['t2i_r1']:.2f} rsum {val_loss['rsum']:.2f}, GT "
          f"rsum {gt['rsum']:.2f}, retrieval_loss "
          f"{val_loss['retrieval_loss']:.4f}; wrote {written}; launches "
          f"{ {k: v for k, v in got.items() if v} }", flush=True)

    results = {}
    os.chdir(DISC_RUN_DIR)  # eval_results/ is written under the run dir
    try:
        for listener in (None, "gt"):
            buf = io.StringIO()
            _dispatch.reset_launches()
            with contextlib.redirect_stdout(buf):
                res = eval_entry.eval(
                    None, os.path.join(DISC_RUN_DIR, "alternatingModel.pth"),
                    os.path.join(DISC_RUN_DIR, "infos_.pkl"),
                    listener=listener, split="test", dataset=ds,
                    device=DEVICE)
            torch.cuda.synchronize()
            got = launch_counts()
            add(got)
            loss = res["loss"]
            require(got["beam_head"] > 0 and got["attention"] > 0,
                    f"eval.eval launches {got}")
            require_head_pass(f"eval.eval(listener={listener})", "tf32x3")
            require(np.isfinite(loss.get("t2i_r1", np.nan)) and
                    np.isfinite(loss.get("gt_ranks", {}).get("rsum",
                                                             np.nan)),
                    f"eval.eval(listener={listener}): {sorted(loss)}")
            if listener == "gt":
                require("gt listener is loaded" in buf.getvalue(),
                        "eval.eval(listener='gt') did not swap the listener")
            results[listener] = loss
            print(f"  eval.eval(listener={listener!r}), beam 2, test: "
                  f"{len(res['split_predictions'])} captions, t2i r1 "
                  f"{loss['t2i_r1']:.2f}, rsum {loss['rsum']:.2f}, GT rsum "
                  f"{loss['gt_ranks']['rsum']:.2f}; launches "
                  f"{ {k: v for k, v in got.items() if v} }", flush=True)
    finally:
        os.chdir(REPO)
    out["ranks_cpu"] = ranks_against_cpu(tr)
    out["protocol_rank_s"] = protocol_rank_seconds()
    print(f"  rank_metrics at the protocol's size (5000 images x 5 "
          f"captions, E=1024, i2t + t2i on the card): "
          f"{out['protocol_rank_s']:.3f} s", flush=True)


def fc_served(add, out):
    """(e) from_run_dir on the stage-1 run dir: the FC speaker served,
    greedy and beam 2, bucket 512, f32 and bf16, every step through B or C
    and every cell step through F; the f32 ids
    against the CPU service's."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.serving import CaptioningService
    fc, _, _ = features(512, seed=808)
    for dt, pass_ in (("float32", "tf32x3"), ("bfloat16", "mma")):
        for beam in (0, 2):
            head = "beam_head" if beam else "greedy_head"
            kw = dict(run_id="fc_con", beam_size=beam, buckets=(512,),
                      compute_dtype=dt)
            svc = CaptioningService.from_run_dir(FC_RUN_DIR,
                                                 device=DEVICE, **kw)
            svc.caption_ids(fc[:1])
            _dispatch.reset_launches()
            ids = svc.caption_ids(fc)
            torch.cuda.synchronize()
            got = launch_counts()
            passes = _dispatch.head_pass_launches()
            add(got)
            # the image step, BOS, L-1
            want = with_cell_pass({head: L, "cell": L + 1}, pass_)
            require(got == want, f"FC {dt} beam {beam}: launches {got}, "
                    f"expected {want}")
            require(passes[f"{head}_{pass_}"] == L,
                    f"FC {dt} beam {beam}: head passes {passes}")
            require_head_pass(f"FC {dt} beam {beam}", pass_)
            require(ids.shape == (512, L) and ids.min() >= 0 and
                    ids.max() <= VOCAB, f"FC ids {ids.shape}")
            how = "beam 2" if beam else "greedy"
            line = (f"  FC speaker served ({dt}, {how}, bucket 512): "
                    f"{len({tuple(r) for r in ids})} distinct rows; "
                    f"launches { {k: v for k, v in got.items() if v} }")
            if dt == "float32":
                cpu = CaptioningService.from_run_dir(FC_RUN_DIR,
                                                     device="cpu", **kw)
                rate = float((cpu.caption_ids(fc) == ids).all(axis=1).mean())
                out[f"fc_agree_beam{beam}"] = rate
                line += f"; {rate * 100:.1f}% of rows equal the CPU service's"
                require(rate >= AGREE_F32, f"FC f32 beam {beam}: {rate}")
            print(line, flush=True)


def phase_listener(smi):
    """Phase 8: (a) phase 1, (b) joint -o gumbel, (c) the four relaxed
    modes against the CPU port, (d) evaluation and ranks, (e) the FC
    speaker served.  Returns the launches of the main path's segments
    (each counted from 0 before it to just after it) and the numbers."""
    import shutil
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    for d in (FC_RUN_DIR, DISC_RUN_DIR):
        shutil.rmtree(d, ignore_errors=True)
    ds = train_dataset()
    print(f"listener: phase 1 (FC speaker, VSE listener: vse_embed 1024, "
          f"GRU, 'last' pooling, margin 0.2, max violation), then "
          f"run_joint.py -o gumbel (att2in2 + listener, DISC 0.01, CIDEr-D "
          f"0.99), vocab {VOCAB}, width {WIDTH}, K={K}, L={L}, B={TRAIN_B}, "
          f"f32", flush=True)
    launches = {k: 0 for k in counted()}

    def add(got):
        for k in launches:
            launches[k] += got[k]

    out = {}
    listener_phase1(ds, add, out)
    tr = listener_joint(ds, add, out, smi)
    out["cpu"] = disc_against_cpu(ds)
    listener_eval(tr, ds, add, out)
    fc_served(add, out)
    return launches, out


# ---------------------------------------------------------------------------
# 9. mesh: the (data, model) process grid, its ranks sharing the card
# ---------------------------------------------------------------------------

MESH_RUN_DIR = os.path.join(REPO, "build", "chip_smoke_mesh_run")
MESH_EVAL_IMAGES = 640  # 256 images in the val and in the test split
MESH_TRAIN_STEPS = 3    # (2, 1) steps held against the single-process Trainer
MESH_TIMED_STEPS = 5
MESH_MERGE_M = (1, 2, 17, 32)
# the (2, 1) and (2, 2) training losses against the single-process Trainer:
# the JAX mesh test's tolerance (tests/test_parallel.py).  The params after
# MESH_TRAIN_STEPS steps: every entry within 2 lr steps (Adam's first update
# is lr * sign(g), and a gradient that is rounding noise -- the attention's
# alpha_net.b, whose true gradient is 0 -- may change sign when the batch's
# rows are summed in two halves), and all but MESH_PARAMS_OUTSIDE of the
# entries within phase 5's gradient rule (STEP_GRAD_ATOL + STEP_GRAD_RTOL *
# |p|); an H100 gave 7 of 14452497 entries outside it.
MESH_LOSS_RTOL = 2e-5
MESH_PARAMS_OUTSIDE = 1e-5
# module globals a rank takes from the parent (a spawned rank imports this
# file anew; a CPU rehearsal changes them)
MESH_CFG = ("DEVICE", "VOCAB", "WIDTH", "FEAT", "K", "L", "SEED", "TRAIN_B",
            "TRAIN_IMAGES", "EVAL_B", "MESH_EVAL_IMAGES", "MESH_RUN_DIR",
            "MESH_TRAIN_STEPS", "MESH_TIMED_STEPS", "TRAIN_RUN_DIR",
            "RUN_DIR", "FC_RUN_DIR", "SCST_RUN_DIR", "MESH_JOINT_DIR",
            "MESH_JOINT_STEPS", "MESH_SPLIT_STEPS", "MESH_JOINT_TIMED",
            "FUSED_K", "MESH_FUSED_SPLIT_K", "MESH_FUSED_DIR", "HOSTS_DIR")
# phase 3 on the mesh: the (2, 1) runs of each configuration against the
# single-process Trainer, MESH_JOINT_STEPS iterations each, and -o gumbel on
# (1, 2), MESH_SPLIT_STEPS; every iteration holds its loss to MESH_LOSS_RTOL
# and its sampled rows to at least MESH_AGREE_ROWS (a near tie may flip
# where the ranks sum a gradient in two halves), the first one, from the
# same params on the same draws, to all of them
MESH_JOINT_DIR = os.path.join(REPO, "build", "chip_smoke_mesh_joint_run")
MESH_JOINT_STEPS = 3
MESH_SPLIT_STEPS = 2
MESH_JOINT_TIMED = 2
MESH_AGREE_ROWS = 0.99


def mesh_cfg():
    return {k: globals()[k] for k in MESH_CFG}


def mesh_eval_dataset():
    """Two batches of EVAL_B images in the val and in the test split."""
    from cooperativeimagecaptioning_tpu_torch.data import SyntheticDataset
    return SyntheticDataset(num_images=MESH_EVAL_IMAGES, vocab_size=VOCAB,
                            seq_length=L, fc_feat_size=FEAT,
                            att_feat_size=FEAT, max_K=K,
                            splits=(0.2, 0.4, 0.4), seed=SEED + 2)


def sync():
    import torch
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def mesh_evaluate(run_dir, mesh, ds, beams=(2, 1), num_images=-1):
    """Evaluator.eval_split of `run_dir`'s speaker on val (f32, no language
    metrics) on `mesh` (None: this process alone) with each beam width ->
    {beam: (captions by image id, launches, head passes, seconds)}."""
    from cooperativeimagecaptioning_tpu_torch import config, data
    from cooperativeimagecaptioning_tpu_torch.evaluation.eval_split import (
        Evaluator)
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.parallel import mesh as M
    from cooperativeimagecaptioning_tpu_torch.training import checkpoint
    opt = config.load_infos(os.path.join(run_dir, "infos_.pkl"))["opt"]
    loader = data.DataLoader(opt, dataset=ds)
    device = DEVICE if mesh is None else mesh.device
    params = checkpoint.load_params(os.path.join(run_dir, "model-best.pth"),
                                    device)
    if mesh is not None:
        params = M.shard_params(params, mesh, M.param_specs(params, mesh))
    ev = Evaluator(opt, mesh=mesh, device=device)
    out = {}
    for beam in beams:
        ek = {"split": "val", "beam_size": beam, "language_eval": 0,
              "num_images": num_images}
        sync()
        _dispatch.reset_launches()
        t0 = time.perf_counter()
        losses, preds, _ = ev.eval_split(params, loader, ek)
        sync()
        out[beam] = ({p["image_id"]: p["caption"] for p in preds},
                     launch_counts(), _dispatch.head_pass_launches(),
                     time.perf_counter() - t0, losses["loss_cap"])
    return out


def mesh_heads_check(mesh):
    """The sharded heads on this rank's slice against the plain heads on the
    whole logit layer, f32 at R=256 and H=WIDTH, with exact ties planted
    across the shard seam (the slice's last and the next slice's first
    columns, and a group around them): ids equal, vals and lse to
    TOL["head"].  Returns the largest error."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
        beam_head, logit_head)
    g = torch.Generator(device="cpu").manual_seed(SEED + 9)
    V1 = VOCAB + 1
    vl = V1 // mesh.n_model
    w = (torch.randn(WIDTH, V1, generator=g) * 0.1)
    b = (torch.randn(V1, generator=g) * 0.1)
    h = (torch.randn(256, WIDTH, generator=g) * 0.5)
    ties = [vl - 2, vl - 1, vl, vl + 1, 3, V1 - 1]
    w[:, ties] = 0.0
    b[ties] = 10.0
    want = sorted(ties)
    dev = mesh.device
    w, b, h = w.to(dev), b.to(dev), h.to(dev)
    j = mesh.model_index
    wl = w[:, j * vl:(j + 1) * vl].contiguous()
    bl = b[j * vl:(j + 1) * vl].contiguous()
    err = 0.0
    for m in (1, 2, 5, 17):
        vals, idx, lse = beam_head.beam_head(h, wl, bl, m)
        vp, ip, lp = beam_head.beam_head_reference(h, w, b, m)
        require(torch.equal(idx.long(), ip.long()),
                f"mesh rank {mesh.rank}: sharded beam head m={m} ids")
        n = min(m, len(want))
        require(bool((idx[:, :n].long().cpu() == torch.tensor(want[:n])
                      ).all()), f"sharded beam head m={m}: ties across the "
                f"seam not in lower-id order")
        err = max(err, (vals - vp).abs().max().item(),
                  (lse - lp).abs().max().item())
    it, lpr = logit_head.greedy_head(h, wl, bl)
    it_p, lp_p = logit_head.greedy_head_reference(h, w, b)
    require(bool((it == it_p).all()) and bool((it == want[0]).all()),
            f"mesh rank {mesh.rank}: sharded greedy head ids")
    err = max(err, (lpr - lp_p).abs().max().item())
    require(err <= TOL["head"], f"sharded heads: max abs error {err}")
    return err


def mesh_train(n_data, n_model, steps, timed, ds, write):
    """A mesh Trainer (this rank) over phase-2 MLE at B=TRAIN_B, f32 ->
    (losses, gathered params as numpy, launches of the
    steps, it/s over `timed` more steps on one batch, the trainer)."""
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    from cooperativeimagecaptioning_tpu_torch.utils.tree import to_numpy
    opt = train_opt(TRAIN_B)
    opt.mesh_data_axis, opt.mesh_model_axis = n_data, n_model
    opt.checkpoint_path = MESH_RUN_DIR
    tr = Trainer(opt, dataset=ds, device=DEVICE, verbose=False)
    sync()
    _dispatch.reset_launches()
    losses = [float(tr.train_iteration()[0]["loss"])
              for _ in range(steps)]
    sync()
    launches = launch_counts()
    params = to_numpy(tr.saved_state()[0])
    its = None
    if timed:
        data = tr.loader.get_batch("train")
        tr.train_iteration(data)
        sync()
        t0 = time.perf_counter()
        for _ in range(timed):
            tr.train_iteration(data)
        sync()
        its = timed / (time.perf_counter() - t0)
    if write:
        tr.checkpoint_operations()
    return losses, params, launches, its, tr


def mesh_joint_opts():
    """Phase 3 on the mesh, f32 at B=TRAIN_B: SCST with the device reward
    (resumed from phase 5's run dir), run_joint.py -o gumbel (seeded from
    phase 5's speaker and 8(a)'s listener, with their Adam states) and -o
    reinforce -v 1 (seeded likewise, audited; turns speaker, listener)."""
    return {"scst_device": scst_opt(TRAIN_B).replace(
                on_device_cider=1, checkpoint_path=MESH_JOINT_DIR),
            "gumbel": disc_opt("gumbel", TRAIN_B, start_from="",
                               checkpoint_path=MESH_JOINT_DIR),
            "reinforce": reinforce_opt(TRAIN_B, "gt", start_from="",
                                       checkpoint_path=MESH_JOINT_DIR)}


def sampled_rows(tr):
    """The last iteration's sampled ids by branch, the data group's rows
    gathered on a mesh (numpy)."""
    from cooperativeimagecaptioning_tpu_torch.parallel import collectives
    out = {}
    for k, v in tr.last_sampled.items():
        if tr.mesh is not None and tr.mesh.n_data > 1:
            v = collectives.all_gather(v, tr.mesh.data)
        out[k] = v.cpu().numpy()
    return out


def mesh_joint_eval(tr):
    """The joint Trainer's Evaluator on val before any step: beam 1, the
    ranks of the generated captions and of the GT captions (JOINT_BASE's
    rank_on_gen_captions) -> (losses and rank metrics, captions by image
    id, launches, seconds)."""
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    ek = {"split": "val", "num_images": -1, "beam_size": 1,
          "language_eval": 0, "rank_eval": 1}
    sync()
    _dispatch.reset_launches()
    t0 = time.perf_counter()
    losses, preds, _ = tr.evaluator().eval_split(tr.params, tr.loader, ek,
                                                 use_gen_sent=True)
    sync()
    return (losses, {p["image_id"]: p["caption"] for p in preds},
            launch_counts(), time.perf_counter() - t0)


def mesh_joint_run(opt, n_data, n_model, ds, steps, timed, evaluate=False):
    """A Trainer of `opt`, one rank of an (n_data,
    n_model) mesh (or the single process: (0, 1)): [the Evaluator first,]
    then each of `steps` iterations' (loss, turn, sampled rows, launches),
    and it/s over `timed` more iterations on one batch, with the traced
    kernel ms of one more and its idle share (`iteration_profile`, on the
    card), and the run's seconds."""
    import copy
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    t_run = time.perf_counter()
    opt = copy.deepcopy(opt)
    opt.mesh_data_axis, opt.mesh_model_axis = n_data, n_model
    out = {"steps": []}
    tr = Trainer(opt, dataset=ds, device=DEVICE, verbose=False)
    if evaluate:
        out["eval"] = mesh_joint_eval(tr)
    for _ in range(steps):
        sync()
        _dispatch.reset_launches()
        loss_dict, turn, _ = tr.train_iteration()
        sync()
        out["steps"].append((float(loss_dict["loss"]), turn,
                             sampled_rows(tr), launch_counts()))
    if timed:
        data = tr.loader.get_batch("train")
        if DEVICE == "cuda":
            out["its"], out["kernel_ms"], out["idle"] = \
                iteration_profile(tr, data, n=timed)
        else:
            tr.train_iteration(data)
            t0 = time.perf_counter()
            for _ in range(timed):
                tr.train_iteration(data)
            out["its"] = timed / (time.perf_counter() - t0)
    tr.close()
    out["s"] = time.perf_counter() - t_run
    return out


def mesh_joint_runs():
    """This rank's phase 3 on the mesh: each configuration on (2, 1), then
    -o gumbel on (1, 2); -o gumbel evaluates (the listener's ranks) before
    its steps on both, as the single process does (the evaluation's
    batches draw their caption picks from the Trainer's loader's
    generator: a run that skipped it would train on other captions)."""
    ds = train_dataset()
    out = {name: mesh_joint_run(opt, 2, 1, ds, MESH_JOINT_STEPS,
                                MESH_JOINT_TIMED, evaluate=name == "gumbel")
           for name, opt in mesh_joint_opts().items()}
    out["gumbel_1x2"] = mesh_joint_run(mesh_joint_opts()["gumbel"], 1, 2, ds,
                                       MESH_SPLIT_STEPS, MESH_JOINT_TIMED,
                                       evaluate=True)
    return out


def rows_agree(got, want):
    """The share of equal rows over the sampled branches of an
    iteration."""
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    same = [np.all(got[k] == want[k], axis=1) for k in want]
    return float(np.mean(np.concatenate(same))) if same else 1.0


def compare_joint(what, got, want, smi):
    """A mesh run's iterations against the single process's: the turns,
    the sampled rows (all of them in the first iteration, >=
    MESH_AGREE_ROWS in every one) and the loss (MESH_LOSS_RTOL in every
    one); returns the worst row agreement."""
    worst = 1.0
    for s, ((loss, turn, ids, _), (wloss, wturn, wids, _)) in enumerate(
            zip(got["steps"], want["steps"])):
        require(turn == wturn, f"{what} step {s}: turn {turn} vs {wturn}")
        rate = rows_agree(ids, wids)
        worst = min(worst, rate)
        rel = abs(loss - wloss) / max(abs(wloss), 1e-30)
        print(f"  {what} step {s} [{turn}]: loss {loss:.7g} vs single "
              f"{wloss:.7g} (relative {rel:.2e}); sampled rows equal "
              f"{rate * 100:.2f}%", flush=True)
        require(rate >= (1.0 if s == 0 else MESH_AGREE_ROWS),
                f"{what} step {s}: {rate} of the sampled rows")
        require(rel <= MESH_LOSS_RTOL, f"{what} step {s}: loss relative "
                f"{rel}")
    idle = f"; idle share {got['idle']:.3f} vs {want['idle']:.3f}, " \
        f"kernels {got['kernel_ms']:.2f} vs {want['kernel_ms']:.2f} ms an " \
        f"iteration" if "idle" in got else ""
    print(f"  {what}: {got['its']:.2f} it/s per rank vs {want['its']:.2f} "
          f"single process (B={TRAIN_B}, ranks sharing one card over gloo, "
          f"{smi}: not a scaling figure){idle}; the run {got['s']:.1f} s vs "
          f"{want['s']:.1f} s", flush=True)
    return worst


def mesh_joint_singles(ds):
    """The single-process references of phase 3 on the mesh, on the card:
    ({configuration: its run}, seconds)."""
    t0 = time.perf_counter()
    single = {name: mesh_joint_run(opt, 0, 1, ds, MESH_JOINT_STEPS,
                                   MESH_JOINT_TIMED, evaluate=name == "gumbel")
              for name, opt in mesh_joint_opts().items()}
    return single, time.perf_counter() - t0


def check_mesh_joint(smi, single, t_single, got):
    """Phase 9, phase 3 on the mesh: each rank's runs of the two-rank world
    (`got`, from `mesh_joint_runs`) against the single process's (`single`);
    per rank and iteration, A, B and F on (2, 1) equal the single process's
    counts, and on (1, 2) A and F equal them, C replaces B launch for
    launch and head_merge adds the categorical draws over the slices (at
    least 2L an iteration: stage A's and stage B's selections).  Returns
    the launches of the mesh runs (every rank's, summed) and the
    numbers."""
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    t_world = max(sum(run["s"] for run in ranks_out.values())
                  for ranks_out in got)
    total = {k: 0 for k in counted()}
    out = {"single_s": t_single, "world_s": t_world, "its": {}}
    for r, ranks_out in enumerate(got):
        for name, run in ranks_out.items():
            ref = single[name.replace("_1x2", "")]
            axes = "(1, 2)" if name.endswith("_1x2") else "(2, 1)"
            what = f"{axes} rank {r} {name.replace('_1x2', '')}"
            out["worst_rows"] = min(out.get("worst_rows", 1.0),
                                    compare_joint(what, run, ref, smi))
            out["its"][f"{name} rank {r}"] = (
                run["its"], ref["its"], run.get("idle"), ref.get("idle"))
            for s, (step, wstep) in enumerate(zip(run["steps"],
                                                  ref["steps"])):
                la, wl = step[3], wstep[3]
                for k in total:
                    total[k] += la[k]
                if axes == "(2, 1)":
                    require(la == wl, f"{what} step {s}: launches {la} vs "
                            f"the single process's {wl}")
                    continue
                cat = la["head_merge"] - la["beam_head"]
                print(f"  {what} step {s}: C {la['beam_head']} (the single "
                      f"process's B {wl['greedy_head']}), head_merge "
                      f"{la['head_merge']} of which {cat} categorical draws "
                      f"over the slices; A {la['attention']}, F "
                      f"{la['cell']}", flush=True)
                require(la["attention"] == wl["attention"]
                        and la["cell"] == wl["cell"] and la["greedy_head"]
                        == 0 and la["beam_head"] == wl["greedy_head"]
                        and cat >= 2 * L, f"{what} step {s}: launches {la}"
                        f" vs the single process's {wl}")
            if "eval" in run:
                losses, caps, la, secs = run["eval"]
                wlosses, wcaps, wl, wsecs = ref["eval"]
                rate = ids_rate(caps, wcaps)
                for k in total:
                    total[k] += la[k]
                print(f"  {what} Evaluator (val, beam 1, the generated and "
                      f"GT captions' ranks): captions {rate * 100:.1f}% "
                      f"equal; rsum {losses['rsum']:.4f} vs "
                      f"{wlosses['rsum']:.4f}, GT rsum "
                      f"{losses['gt_ranks']['rsum']:.4f} vs "
                      f"{wlosses['gt_ranks']['rsum']:.4f}; {secs:.2f} s vs "
                      f"{wsecs:.2f} s; launches "
                      f"{ {k: v for k, v in la.items() if v} }", flush=True)
                require(rate >= AGREE_F32, f"{what} eval captions {rate}")
                for k in ("loss", "rsum"):
                    rel = abs(losses[k] - wlosses[k]) / max(abs(wlosses[k]),
                                                            1e-30)
                    require(rel <= EVAL_LOSS_RTOL, f"{what} eval {k} "
                            f"relative {rel}")
                require(abs(losses["gt_ranks"]["rsum"]
                            - wlosses["gt_ranks"]["rsum"]) <= 1e-6 * max(
                    1.0, abs(wlosses["gt_ranks"]["rsum"])),
                    f"{what} eval GT rsum")
                if axes == "(2, 1)":
                    require(la == wl, f"{what} eval launches {la} vs {wl}")
                else:
                    require(la["greedy_head"] == 0 and la["beam_head"] > 0
                            and la["head_merge"] >= la["beam_head"]
                            and la["attention"] == wl["attention"],
                            f"{what} eval launches {la} vs {wl}")
    print(f"  phase 3 on the mesh: single-process references "
          f"{t_single:.1f} s, the two-rank world's runs {t_world:.1f} s",
          flush=True)
    return total, out


# fused chunks on the mesh: phase 2 and -o gumbel with on_device_cider on
# (2, 1) in chunks of FUSED_K, -o gumbel on (1, 2) in a chunk of
# MESH_FUSED_SPLIT_K, each against as many per-step mesh iterations from one
# seed (losses FUSED_LOSS_RTOL, params FUSED_PARAM_RTOL / FUSED_PARAM_ATOL:
# the same captured arithmetic); each replays segments captured between the
# iteration's collectives
MESH_FUSED_DIR = os.path.join(REPO, "build", "chip_smoke_mesh_fused_run")
MESH_FUSED_SPLIT_K = 4
# two ranks as two hosts (torchrun's environment, a directory each)
HOSTS_DIR = os.path.join(REPO, "build", "chip_smoke_hosts")


def mesh_fused_opts():
    """(name, options maker, mesh axes, chunk) of each fused mesh run."""
    def mle():
        return train_opt(TRAIN_B)

    def gumbel():
        return disc_opt("gumbel", TRAIN_B, on_device_cider=1, start_from="")
    return [("phase-2 MLE", mle, (2, 1), FUSED_K),
            ("-o gumbel, on_device_cider", gumbel, (2, 1), FUSED_K),
            ("-o gumbel, on_device_cider", gumbel, (1, 2),
             MESH_FUSED_SPLIT_K)]


def train_on(tr, n):
    """`tr.train` for n more iterations, its vocab mesh registered (a
    finished `train` closes the Trainer, which clears it)."""
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    if tr.mesh is not None:
        _dispatch.set_vocab_mesh(tr.mesh, tr.opt.vocab_size)
    tr.train(max_iterations=tr.iteration + n)
    sync()


def kernel_ms_per_step(tr, n):
    """Traced kernel ms a step over n more iterations (`train_on`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_on(tr, n)
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3 / n


def mesh_fused_pair(make_opt, axes, k):
    """This rank's fused chunk of k against k per-step iterations on a mesh
    of `axes`, from one seed with the feature cache: the losses, the
    params' worst ratio to the fused tolerance, the skipped steps, the
    launches of a per-step iteration and of a replay, the captured steps'
    segments, collectives and replays, then it/s of k / 2 more steps each
    in turns (per step, fused, fused, per step), each one's traced kernel
    ms a step over two more and idle share, and the peak MiB of the
    rank."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    from cooperativeimagecaptioning_tpu_torch.utils.tree import leaves
    t0 = time.perf_counter()
    ds = train_dataset()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    trs = {}
    for s in (1, k):
        trs[s] = Trainer(make_opt().replace(
            fused_steps=s, device_feature_cache=1,
            mesh_data_axis=axes[0], mesh_model_axis=axes[1],
            checkpoint_path=os.path.join(MESH_FUSED_DIR, f"f{s}")),
            dataset=ds, device=DEVICE, verbose=False)
    out = {"gates": (trs[1]._fused_gate(), trs[k]._fused_gate()),
           "launches": {}, "first_s": {}}
    for s, tr in trs.items():
        _dispatch.reset_launches()
        t1 = time.perf_counter()
        train_on(tr, k)
        out["first_s"][s] = time.perf_counter() - t1
        out["launches"][s] = launch_counts()
    a, b = trs[1], trs[k]
    runners = list(b._fused.values())
    out.update(
        losses=({i: float(v) for i, v in a.loss_history.items()},
                {i: float(v) for i, v in b.loss_history.items()}),
        skipped=(a.optim.skipped_steps(), b.optim.skipped_steps()),
        captures=len(runners), replays=sum(r.replays for r in runners),
        captured=all(r.plan is not None for r in runners),
        per_replay=runners[0].launches if runners else None,
        segments=[r.segments for r in runners],
        collectives=[r.collectives for r in runners])
    worst, worst_key, max_abs = 0.0, "", 0.0
    pb = dict(leaves(b.params))
    for key, x in leaves(a.params):
        d = (pb[key] - x).abs()
        r = (d / (FUSED_PARAM_ATOL + FUSED_PARAM_RTOL * x.abs())).max().item()
        max_abs = max(max_abs, d.max().item())
        if r > worst:
            worst, worst_key = r, key
    out.update(param_worst=worst, param_worst_key=worst_key,
               param_max_abs=max_abs)
    rates, n = {1: [], k: []}, max(2, k // 2)
    for s in (1, k, k, 1):
        t1 = time.perf_counter()
        train_on(trs[s], n)
        rates[s].append(n / (time.perf_counter() - t1))
    out["rates"] = rates
    out["its"] = {s: float(np.mean(r)) for s, r in rates.items()}
    if DEVICE == "cuda":
        out["kernel_ms"] = {s: kernel_ms_per_step(tr, 2)
                            for s, tr in trs.items()}
        out["idle"] = {s: 1.0 - out["kernel_ms"][s] * out["its"][s] / 1e3
                       for s in trs}
        out["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    for tr in trs.values():
        tr.close()
    out["s"] = time.perf_counter() - t0
    return out


def mesh_fused_runs():
    """This rank's fused chunks on the mesh (`mesh_fused_opts`)."""
    return [mesh_fused_pair(make, axes, k)
            for _, make, axes, k in mesh_fused_opts()]


def check_mesh_fused(smi, got):
    """Phase 9 (a) and (b): each rank's fused chunks against its per-step
    mesh iterations (`got`: per rank, `mesh_fused_runs`): the gate open,
    losses and params within the fused tolerances, the skipped steps
    equal, one eager warm-up step plus the replays make the chunk, the
    iteration captured in segments (one more than its collectives), and a
    replay's launches equal to a per-step iteration's.  Returns the
    launches (every rank's, summed) and the numbers."""
    total = {k: 0 for k in counted()}
    out = []
    for r, runs in enumerate(got):
        for (name, _, axes, k), run in zip(mesh_fused_opts(), runs):
            what = f"{axes} rank {r} {name}, chunk of {k}"
            la, lb = run["losses"]
            require(run["gates"] == ("off", None), f"{what}: gates "
                    f"{run['gates']}")
            require(la.keys() == lb.keys() and len(la) >= k,
                    f"{what}: histories {sorted(la)} vs {sorted(lb)}")
            rel = max(abs(lb[i] - la[i]) / abs(la[i]) for i in la)
            per_step = {key: v // k for key, v in run["launches"][1].items()}
            per_replay = dict(run["per_replay"] or {})
            seg, col = run["segments"], run["collectives"]
            print(f"  {what}: losses within {rel:.2e} relative of the "
                  f"per-step mesh run (tol {FUSED_LOSS_RTOL:.0e}); params "
                  f"max abs difference {run['param_max_abs']:.3e}, worst "
                  f"leaf {run['param_worst_key']} at "
                  f"{run['param_worst']:.3f} of rtol {FUSED_PARAM_RTOL:.0e} "
                  f"/ atol {FUSED_PARAM_ATOL:.0e}; skipped {run['skipped']};"
                  f" {run['captures']} capture(s) + {run['replays']} "
                  f"replays; segments a replay {seg}, collectives {col}; "
                  f"launches a replay "
                  f"{ {key: v for key, v in per_replay.items() if v} }",
                  flush=True)
            require(rel <= FUSED_LOSS_RTOL, f"{what}: losses at {rel}")
            require(run["param_worst"] <= 1.0, f"{what}: param "
                    f"{run['param_worst_key']} at {run['param_worst']}")
            require(run["skipped"][0] == run["skipped"][1],
                    f"{what}: skipped {run['skipped']}")
            require(run["captured"] and run["captures"] + run["replays"]
                    == k, f"{what}: {run['captures']} captures and "
                    f"{run['replays']} replays in {k} steps")
            require(all(c and s == c + 1 for s, c in zip(seg, col)),
                    f"{what}: segments {seg}, collectives {col}")
            require(all(v % k == 0 for v in run["launches"][1].values()),
                    f"{what}: per-step launches {run['launches'][1]}")
            want = {key: per_step[key] for key in per_replay}
            require(per_replay == want and per_replay.get("attention", 0) > 0
                    and per_replay.get("cell", 0) > 0,
                    f"{what}: launches a replay {per_replay} vs a per-step "
                    f"iteration's {want}")
            if axes == (2, 1):
                require(per_replay.get("greedy_head", 0) > 0 or
                        name.startswith("phase-2"), f"{what}: B never "
                        f"launched")
            else:
                require(per_replay.get("beam_head", 0) > 0 and
                        per_replay.get("head_merge", 0) > 0 and
                        per_replay.get("greedy_head", 0) == 0,
                        f"{what}: C and head_merge a replay {per_replay}")
            for key in total:
                total[key] += run["launches"][1][key] + \
                    run["launches"][k][key]
            rates = run["rates"]
            idle = f"; idle share {run['idle'][1]:.3f} per step, " \
                f"{run['idle'][k]:.3f} fused (traced kernels " \
                f"{run['kernel_ms'][1]:.2f} / {run['kernel_ms'][k]:.2f} ms " \
                f"a step); peak {run['peak_mib']:.0f} MiB" \
                if "idle" in run else ""
            print(f"  {what}: per step {run['its'][1]:.2f} it/s, fused "
                  f"{run['its'][k]:.2f} it/s a rank (in turns: "
                  + ", ".join(f"{x:.2f}" for x in rates[1] + rates[k])
                  + f"; B={TRAIN_B}, two ranks sharing one card over gloo, "
                  f"{smi}){idle}; first chunk {run['first_s'][k]:.1f} s "
                  f"(warm-up, capture, replays) vs {run['first_s'][1]:.1f} "
                  f"s per step; the pair {run['s']:.1f} s", flush=True)
            out.append({"what": what, "loss_rel": rel,
                        "segments": seg, "collectives": col,
                        "its": run["its"], "idle": run.get("idle"),
                        "kernel_ms": run.get("kernel_ms"),
                        "peak_mib": run.get("peak_mib"), "s": run["s"]})
    return total, out


def host_process(env, cwd, cfg, results):
    """One host of a torchrun world on this machine: torchrun's
    environment `env`, the working directory `cwd`; joins the world through
    `launch.run` and puts (rank, ok, result or traceback) on `results`."""
    import traceback
    os.environ.update(env)
    os.chdir(cwd)
    try:
        from cooperativeimagecaptioning_tpu_torch.parallel import launch
        out = launch.run(host_rank, (cfg,), 0, cfg["DEVICE"])
        results.put((int(env["RANK"]), True, out))
    except BaseException:  # reported to the parent, which raises it
        results.put((int(env["RANK"]), False, traceback.format_exc()))


def host_rank(cfg):
    """A rank on its own host: MESH_TRAIN_STEPS (2, 1) phase-2 iterations
    writing the relative run dir 'run' (global rank 0 writes it), a
    Trainer resuming it for one iteration, and `eval.eval` of it (rank 0
    reads it for both)."""
    globals().update(cfg)
    import torch
    import torch.distributed as dist
    from cooperativeimagecaptioning_tpu_torch import eval as eval_entry
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    opt = train_opt(TRAIN_B).replace(mesh_data_axis=2, mesh_model_axis=1,
                                     checkpoint_path="run", id="h")
    out = {"backend": dist.get_backend(), "cwd": os.getcwd()}
    tr = Trainer(opt, dataset=train_dataset(), device=DEVICE, verbose=False)
    out["losses"] = [float(tr.train_iteration()[0]["loss"])
                     for _ in range(MESH_TRAIN_STEPS)]
    tr.checkpoint_operations()
    tr.close()
    tr = Trainer(opt.replace(checkpoint_path="run_resumed", start_from="run"),
                 dataset=train_dataset(), device=DEVICE, verbose=False)
    out["resumed_at"] = tr.iteration
    out["resumed_loss"] = float(tr.train_iteration()[0]["loss"])
    tr.close()
    got = eval_entry.eval(None, os.path.join("run", "model.pth"),
                          os.path.join("run", "infos_h.pkl"), split="val",
                          dataset=train_dataset(), device=DEVICE)
    _dispatch.set_vocab_mesh(None)
    out["eval"] = (len(got["split_predictions"]), got["loss"]["loss_cap"])
    return out


def mesh_two_hosts(losses1):
    """Phase 9 (c): two ranks started as two hosts of a torchrun world (a
    directory each under HOSTS_DIR, LOCAL_WORLD_SIZE=1, one card): the
    world's backend is gloo (the ranks share the card), the losses equal
    the one-host (2, 1) run's `losses1` (MESH_LOSS_RTOL), the run dir
    exists only under host 0's directory, and a resume and `eval.eval` of
    it run on both.  Returns its seconds."""
    import multiprocessing as mp
    import queue
    import shutil
    from cooperativeimagecaptioning_tpu_torch.parallel import launch
    t0 = time.perf_counter()
    shutil.rmtree(HOSTS_DIR, ignore_errors=True)
    port = launch.free_init_method().rsplit(":", 1)[1]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs, dirs = [], []
    for r in range(2):
        d = os.path.join(HOSTS_DIR, f"host{r}")
        os.makedirs(d)
        dirs.append(d)
        env = {"RANK": str(r), "WORLD_SIZE": "2", "LOCAL_RANK": "0",
               "LOCAL_WORLD_SIZE": "1", "GROUP_RANK": str(r),
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port,
               "PYTHONPATH": REPO}
        procs.append(ctx.Process(target=host_process,
                                 args=(env, d, mesh_cfg(), results)))
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < 2:
            try:
                rank, ok, payload = results.get(timeout=600)
            except queue.Empty:
                raise SmokeFailure("two hosts: no result after 600 s")
            require(ok, f"two hosts: rank {rank} failed:\n{payload}")
            got[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    for r in range(2):
        g = got[r]
        rel = max(abs(a - b) / abs(b) for a, b in zip(g["losses"], losses1))
        print(f"  two hosts, rank {r} in {os.path.relpath(g['cwd'], REPO)}: "
              f"backend {g['backend']}; losses {g['losses']} vs the one-host "
              f"(2, 1) run's (relative {rel:.2e}); resumed at iteration "
              f"{g['resumed_at']}, loss {g['resumed_loss']:.6g}; eval.eval "
              f"of host 0's run dir: {g['eval'][0]} captions, loss_cap "
              f"{g['eval'][1]:.6g}", flush=True)
        require(g["backend"] == "gloo", f"two hosts: backend {g['backend']}"
                f" on one card")
        require(rel <= MESH_LOSS_RTOL, f"two hosts rank {r}: losses {rel}")
        require(g["resumed_at"] == MESH_TRAIN_STEPS
                and np.isfinite(g["resumed_loss"]) and g["eval"][0] > 0
                and np.isfinite(g["eval"][1]), f"two hosts rank {r}: {g}")
    require(got[0]["eval"] == got[1]["eval"] and got[0]["resumed_loss"] ==
            got[1]["resumed_loss"], "two hosts: the ranks disagree")
    require(os.path.isfile(os.path.join(dirs[0], "run", "model.pth"))
            and os.listdir(dirs[1]) == [],
            f"two hosts: host 1's directory holds {os.listdir(dirs[1])}")
    secs = time.perf_counter() - t0
    print(f"  two hosts: the run dir only under host 0's directory; "
          f"{secs:.1f} s", flush=True)
    return secs


def mesh_pair_rank(cfg):
    """Rank of the two-rank world: (1, 2) evaluation, then (2, 1) training
    and its run dir, eval.eval on that mesh run dir, then phase 3 on the
    mesh (`mesh_joint_runs`)."""
    globals().update(cfg)
    import torch
    from cooperativeimagecaptioning_tpu_torch import config
    from cooperativeimagecaptioning_tpu_torch import eval as eval_entry
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.parallel import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    mesh = make_mesh(1, 2, DEVICE)
    _dispatch.set_vocab_mesh(mesh, VOCAB)
    out["heads_err"] = mesh_heads_check(mesh)
    ds = mesh_eval_dataset()
    # a first, untimed batch takes this rank's one-time costs (the gloo
    # groups' first collectives, cuBLAS's first f32 products)
    mesh_evaluate(RUN_DIR, mesh, ds, beams=(2,), num_images=EVAL_B)
    out["eval"] = {d: mesh_evaluate(d, mesh, ds)
                   for d in (RUN_DIR, TRAIN_RUN_DIR)}
    _dispatch.set_vocab_mesh(None)
    losses, params, launches, its, tr = mesh_train(
        2, 1, MESH_TRAIN_STEPS, MESH_TIMED_STEPS, train_dataset(), True)
    tr.close()
    out["train"] = (losses, params if tr.mesh.rank == 0 else None, launches,
                    its)
    opt = config.load_infos(os.path.join(MESH_RUN_DIR, "infos_.pkl"))["opt"]
    got = eval_entry.eval(opt, os.path.join(MESH_RUN_DIR, "model-best.pth"),
                          os.path.join(MESH_RUN_DIR, "infos_.pkl"),
                          split="test", dataset=ds, device=DEVICE)
    out["eval_entry"] = {p["image_id"]: p["caption"]
                         for p in got["split_predictions"]}
    out["joint"] = mesh_joint_runs()
    t0 = time.perf_counter()
    out["fused"] = mesh_fused_runs()
    out["fused_s"] = time.perf_counter() - t0
    return out


def mesh_quad_rank(cfg):
    """Rank of the four-rank world, a (2, 2) mesh: one training step, and
    one evaluation batch of RUN_DIR's speaker."""
    globals().update(cfg)
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    torch.backends.cuda.matmul.allow_tf32 = False
    losses, _, launches, _, tr = mesh_train(2, 2, 1, 0, train_dataset(),
                                            False)
    ev = mesh_evaluate(RUN_DIR, tr.mesh, mesh_eval_dataset(), beams=(2,),
                       num_images=EVAL_B)
    vm = _dispatch.vocab_mesh()
    tr.close()
    require(_dispatch.vocab_mesh() is None and vm is not None,
            "Trainer.close() must clear the vocab mesh it registered")
    return {"loss": losses[0], "launches": launches, "eval": ev[2],
            "rank": tr.mesh.rank}


def mesh_nccl_world_of_one():
    """A world of one rank over NCCL on the card: one all_gather and one
    all_reduce through the port's helpers, so that the NCCL route runs."""
    import torch
    import torch.distributed as dist
    from cooperativeimagecaptioning_tpu_torch.parallel import (
        collectives, launch, make_mesh)
    from cooperativeimagecaptioning_tpu_torch.parallel import mesh as mesh_mod
    require(mesh_mod.world_backend("cuda", [mesh_mod.card_id("cuda", 0)])
            == "nccl", "a rank with a card of its own must take NCCL")
    launch.init_rank(0, 1, launch.free_init_method(), "cuda", "nccl")
    try:
        mesh = make_mesh(1, 1, "cuda")
        x = torch.arange(6, dtype=torch.float32, device="cuda")
        g = collectives.all_gather(x, mesh.world)
        r = collectives.all_reduce(x, mesh.world, "max")
        torch.cuda.synchronize()
        require(mesh.backend == "nccl" and not mesh.world.staged
                and torch.equal(g, x) and torch.equal(r, x),
                f"NCCL world of one: {mesh.backend}, {g}, {r}")
        # a segment plan over NCCL: two segments around an all_reduce
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        plan = collectives.SegmentPlan(torch.device("cuda"), side)
        with torch.cuda.stream(side), collectives.planned(plan):
            y = collectives.all_reduce(x * 2, mesh.world) + 1
        torch.cuda.current_stream().wait_stream(side)
        x.copy_(torch.arange(6, 12, dtype=torch.float32, device="cuda"))
        plan.replay()
        torch.cuda.synchronize()
        require(plan.segments == 2 and len(plan.ops) == 1
                and torch.equal(y, x * 2 + 1),
                f"NCCL segment plan: {plan.segments} segments, {y}")
    finally:
        dist.destroy_process_group()


def check_head_merge(errs, times, bounds, shapes):
    """head_merge on the card against its plain version, the model group's
    candidates of a logit layer split in two (R=256 rows, the evaluation's
    beam-2 decode), ties planted across the shard seam, at m = 1, 2, 17 and
    32; then timed at the (1, 2) evaluation's two shapes."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
        _dispatch, beam_head, head_merge)
    g = torch.Generator(device="cpu").manual_seed(SEED + 7)
    R, n, V1 = 256, 2, VOCAB + 1
    vl = V1 // n
    logits = torch.randn(R, V1, generator=g)
    group = [vl - 3, vl - 2, vl - 1, vl, vl + 1, vl + 2, 5, V1 - 1]
    logits[:, group] = 9.0  # above every random logit
    logits = logits.cuda()
    errs["head_merge"] = 0.0
    print("head_merge vs plain (n=2 shards of a 9488-wide logit layer, "
          "R=256, ties across the shard seam)", flush=True)
    for m in MESH_MERGE_M:
        vals, idx, lses = [], [], []
        for s in range(n):
            part = logits[:, s * vl:(s + 1) * vl]
            v, i = beam_head.top_k(part, m)
            vals.append(v)
            idx.append(i.to(torch.int32))
            lses.append(torch.logsumexp(part, dim=1))
        vals = torch.cat(vals, 1).contiguous()
        idx = torch.cat(idx, 1).contiguous()
        lse = torch.stack(lses).contiguous()
        before = _dispatch.launches()["head_merge"]
        got = head_merge.head_merge(vals, idx, lse, vl, m)
        torch.cuda.synchronize()
        require(_dispatch.launches()["head_merge"] == before + 1,
                "head_merge: one launch")
        want = head_merge.head_merge_reference(vals, idx, lse, vl, m)
        full_v, full_i = beam_head.top_k(logits, m)
        require(torch.equal(got[1], want[1])
                and torch.equal(got[1].long(), full_i),
                f"head_merge m={m}: ids differ from the plain merge or the "
                f"top-{m} of the whole row")
        k = min(m, len(group))
        require(bool((got[1][:, :k].cpu() == torch.tensor(sorted(group)[:k])
                      ).all()), f"head_merge m={m}: ties across the seam "
                f"not in lower-id order")
        err = max((got[0] - want[0]).abs().max().item(),
                  (got[2] - want[2]).abs().max().item(),
                  (got[0] - full_v).abs().max().item())
        errs["head_merge"] = max(errs["head_merge"], err)
        report("head_merge", f"f32 R={R} n={n} m={m} vals/lse", err,
               TOL["head"])
    for rows, m in ((2 * EVAL_B, 2), (EVAL_B, 1)):
        vals = torch.randn(rows, n * m, device="cuda")
        idx = torch.randint(0, vl, (rows, n * m), device="cuda",
                            dtype=torch.int32)
        lse = torch.randn(n, rows, device="cuda")
        outs = (torch.empty(rows, m), torch.empty(rows, m).int(),
                torch.empty(rows))
        pair = timed_pair(
            lambda: head_merge.head_merge(vals, idx, lse, vl, m),
            lambda: head_merge.head_merge_reference(vals, idx, lse, vl, m))
        bound = bound_ms((vals, idx, lse) + outs, 0, "float32")
        label = f"f32 R={rows} n={n} m={m}"
        shapes["head_merge"].append(timed_shape(label, pair, bound))
        print(f"  time head_merge   {label}: kernel {pair[0]:.4f} ms  plain "
              f"{pair[1]:.4f} ms  bound {bound[0]:.6f} ms ({bound[1]})",
              flush=True)
        if m == 2:
            times["head_merge"], bounds["head_merge"] = pair, bound
    # kernel C on one rank's slice of the logit layer at the same shapes:
    # the other kernel of the sharded heads G (kk=2) and H (kk=1)
    w = torch.randn(WIDTH, vl, generator=g).cuda() * 0.1
    b = torch.randn(vl, generator=g).cuda() * 0.1
    for rows, m in ((2 * EVAL_B, 2), (EVAL_B, 1)):
        h = torch.randn(rows, WIDTH, generator=g).cuda() * 0.5
        pair = timed_pair(lambda: beam_head.local_beam_head(h, w, b, m),
                          lambda: beam_head.beam_head_reference(h, w, b, m))
        outs = (torch.empty(rows, m), torch.empty(rows, m).int(),
                torch.empty(rows))
        bound = bound_ms((h, w, b) + outs, 2 * rows * WIDTH * vl, "float32")
        label = f"f32 slice R={rows} V/2={vl} kk={m} (sharded head " + (
            "G)" if m == 2 else "H)")
        shapes["beam_head"].append(timed_shape(label, pair, bound))
        print(f"  time beam_head    {label}: kernel {pair[0]:.4f} ms  plain "
              f"{pair[1]:.4f} ms  bound {bound[0]:.4f} ms ({bound[1]})",
              flush=True)


def ids_rate(caps, want):
    require(sorted(caps) == sorted(want), "mesh: not the same images")
    return float(np.mean([caps[i] == want[i] for i in want]))


def phase_mesh(smi, errs, times, bounds, shapes):
    """Phase 9.  Returns the launches of the mesh runs (every rank's, summed)
    and the numbers."""
    import shutil
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.parallel import launch
    from cooperativeimagecaptioning_tpu_torch.utils.tree import leaves
    t_phase = time.perf_counter()
    shutil.rmtree(MESH_RUN_DIR, ignore_errors=True)
    print(f"mesh: ranks of a (data, model) process grid sharing one card "
          f"over gloo ({smi}); att2in2 vocab {VOCAB}, width {WIDTH}, K={K}, "
          f"L={L}, f32", flush=True)
    if DEVICE == "cuda":
        check_head_merge(errs, times, bounds, shapes)

    # the single-process references on the card
    ds = mesh_eval_dataset()
    single = {d: mesh_evaluate(d, None, ds) for d in (RUN_DIR, TRAIN_RUN_DIR)}
    losses1, params1, _, _, tr1 = mesh_train(0, 1, MESH_TRAIN_STEPS, 0,
                                             train_dataset(), False)
    lr = tr1.opt.current_lr
    del tr1
    single_joint, t_single_joint = mesh_joint_singles(train_dataset())

    t0 = time.perf_counter()
    pair = launch.spawn(mesh_pair_rank, (mesh_cfg(),), 2, DEVICE)
    t_pair = time.perf_counter() - t0
    total = {k: 0 for k in counted()}
    batches = -(-sum(1 for im in ds.info["images"]
                     if im["split"] == "val") // EVAL_B)
    out = {"pair_s": t_pair}
    for r, got in enumerate(pair):
        require(got["heads_err"] <= TOL["head"], "sharded heads")
        for d, by_beam in got["eval"].items():
            for beam, (caps, launches, passes, secs, loss) in by_beam.items():
                rate = ids_rate(caps, single[d][beam][0])
                what = f"(1, 2) rank {r} {os.path.basename(d)} " + (
                    "beam 2" if beam == 2 else "greedy")
                rel = abs(loss - single[d][beam][4]) / abs(single[d][beam][4])
                print(f"  {what}: captions of {rate * 100:.1f}% of "
                      f"{len(caps)} images equal the single process's (need "
                      f">= {AGREE_F32 * 100:.0f}%); loss_cap relative "
                      f"{rel:.2e}; {len(caps) / secs:.1f} images/s (two "
                      f"ranks sharing one card, {smi}: not a scaling "
                      f"figure); "
                      f"launches { {k: v for k, v in launches.items() if v} }",
                      flush=True)
                require(rate >= AGREE_F32, f"{what}: {rate} of the captions")
                require(rel <= EVAL_LOSS_RTOL, f"{what}: loss_cap {rel}")
                want = {k: 0 for k in counted()}
                want["attention"] = want["cell"] = batches * (L + 1 + L)
                want["beam_head"] = want["head_merge"] = batches * L
                want = with_cell_pass(want, "tf32x3")
                require(launches == want, f"{what}: launches {launches}, "
                        f"expected {want} (C at kk={beam} and head_merge L "
                        f"times a decode, B never)")
                require(passes["beam_head_tf32x3"] == batches * L,
                        f"{what}: the f32 head slice takes the split-TF32 "
                        f"pass")
                for k, v in launches.items():
                    total[k] += v
        tl, tp, tlaunch, its = got["train"]
        for k, v in tlaunch.items():
            total[k] += v
        T = L + 1
        require(tlaunch["attention"] == tlaunch["cell"]
                == MESH_TRAIN_STEPS * 2 * T, f"(2, 1) rank {r}: launches "
                f"{tlaunch}")
        for s, (a, b) in enumerate(zip(tl, losses1)):
            rel = abs(a - b) / abs(b)
            require(rel <= MESH_LOSS_RTOL, f"(2, 1) rank {r} step {s}: loss "
                    f"{a} vs {b} (relative {rel})")
        print(f"  (2, 1) rank {r}: losses {tl} vs single {losses1}; "
              f"{its:.2f} it/s (B={TRAIN_B} over two ranks sharing one "
              f"card, {smi}: not a scaling figure)", flush=True)
        if tp is not None:
            got_p, want_p = dict(leaves(tp)), dict(leaves(params1))
            bound = 2 * lr * MESH_TRAIN_STEPS
            worst, worst_key, outside = 0.0, "", 0
            for key, w in want_p.items():
                d = np.abs(got_p[key] - w)
                require(d.max() <= bound, f"(2, 1) params {key}: {d.max()}")
                ratio = d / (STEP_GRAD_ATOL + STEP_GRAD_RTOL * np.abs(w))
                outside += int((ratio > 1).sum())
                if ratio.max() > worst:
                    worst, worst_key = float(ratio.max()), key
            n_el = sum(w.size for w in want_p.values())
            print(f"  (2, 1) params after {MESH_TRAIN_STEPS} steps vs single: "
                  f"{outside} of {n_el} entries outside phase 5's rule "
                  f"(worst {worst_key} at {worst:.3f}; at most "
                  f"{MESH_PARAMS_OUTSIDE:.0e} of them may be); all within "
                  f"2 lr steps = {bound:.1e}", flush=True)
            require(outside <= MESH_PARAMS_OUTSIDE * n_el,
                    f"(2, 1) params: {outside} entries outside phase 5's "
                    f"rule")
            out["params_outside"] = outside
        rate = ids_rate(got["eval_entry"], single_eval_entry(ds))
        print(f"  eval.eval on the (2, 1) mesh run dir, rank {r}: captions "
              f"of {rate * 100:.1f}% of the test images equal the single "
              f"process's", flush=True)
        require(rate >= AGREE_F32, "eval.eval on the mesh run dir")
    out["its"] = pair[0]["train"][3]

    t0 = time.perf_counter()
    quad = launch.spawn(mesh_quad_rank, (mesh_cfg(),), 4, DEVICE)
    t_quad = time.perf_counter() - t0
    for got in quad:
        rel = abs(got["loss"] - losses1[0]) / abs(losses1[0])
        caps, launches, passes, secs, _ = got["eval"]
        rate = ids_rate(caps, {i: single[RUN_DIR][2][0][i] for i in caps})
        print(f"  (2, 2) rank {got['rank']}: first-step loss relative "
              f"{rel:.2e} to single; one eval batch, captions of "
              f"{rate * 100:.1f}% equal; launches "
              f"{ {k: v for k, v in got['launches'].items() if v} } / "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        require(rel <= MESH_LOSS_RTOL, f"(2, 2) loss {rel}")
        require(rate >= AGREE_F32, f"(2, 2) eval {rate}")
        require(launches["beam_head"] == launches["head_merge"] == L
                and launches["greedy_head"] == 0,
                f"(2, 2) eval launches {launches}")
        for k in total:
            total[k] += got["launches"][k] + launches[k]

    joint, out["joint"] = check_mesh_joint(
        smi, single_joint, t_single_joint, [got["joint"] for got in pair])
    for k in total:
        total[k] += joint[k]
    fused_total, out["fused"] = check_mesh_fused(
        smi, [got["fused"] for got in pair])
    for k in total:
        total[k] += fused_total[k]
    out["fused_s"] = max(got["fused_s"] for got in pair)
    out["hosts_s"] = mesh_two_hosts(pair[0]["train"][0])

    if DEVICE == "cuda":
        mesh_nccl_world_of_one()
        print(f"  NCCL world of one: all_gather and all_reduce through the "
              f"port's helpers ok; a segment plan's replay with an NCCL "
              f"all_reduce between its two segments ok", flush=True)
    out["quad_s"] = t_quad
    print(f"  mesh phase in {time.perf_counter() - t_phase:.1f} s (two-rank "
          f"world {t_pair:.1f} s, of it the fused chunks on the mesh "
          f"{out['fused_s']:.1f} s; four-rank world {t_quad:.1f} s; two "
          f"hosts {out['hosts_s']:.1f} s)", flush=True)
    return total, out


def single_eval_entry(ds):
    """eval.eval of the mesh run dir in this process, the mesh options
    cleared."""
    from cooperativeimagecaptioning_tpu_torch import config
    from cooperativeimagecaptioning_tpu_torch import eval as eval_entry
    infos = os.path.join(MESH_RUN_DIR, "infos_.pkl")
    opt = config.load_infos(infos)["opt"]
    opt.mesh_data_axis, opt.mesh_model_axis = 0, 1
    got = eval_entry.eval(opt, os.path.join(MESH_RUN_DIR, "model-best.pth"),
                          infos, split="test", dataset=ds, device=DEVICE)
    return {p["image_id"]: p["caption"] for p in got["split_predictions"]}


# ---------------------------------------------------------------------------
# 10. joint REINFORCE: real speaker / listener alternation
# ---------------------------------------------------------------------------

REINFORCE_RUN_DIR = os.path.join(REPO, "build", "chip_smoke_reinforce_run")
PROFILE_DIR = os.path.join(REPO, "build", "chip_smoke_profile")
REINFORCE_ITERS = 6   # iterations a cell-kernel setting: 3 turns an agent
BASELINE_ITERS = 2    # the greedy and no baselines: one turn an agent
ABLATION_ITERS = 2
PROFILE_ITERS = 2
TIMED_ITERS = 4       # iterations an agent in the stage split and it/s
BASELINES = ("gt", "greedy", "no")


def reinforce_opt(batch_size, baseline="gt", which="reinforce", **kw):
    """run_joint.py -o <which> -v 1 (-o reinforce with the REINFORCE
    baseline `baseline`), seeded as 8(b) is: phase 5's stage-2 speaker with
    its Adam state, 8(a)'s listener with its; under the audit."""
    flags = {**JOINT_BASE, **joint_flags(which, vse=1)}
    if which == "reinforce":
        flags["reinforce_baseline_type"] = baseline
    base = dict(
        checkpoint_path=REINFORCE_RUN_DIR, start_from=REINFORCE_RUN_DIR,
        speaker_stage_2_model_path=os.path.join(TRAIN_RUN_DIR, "model.pth"),
        speaker_stage_2_optimizer_path=os.path.join(TRAIN_RUN_DIR,
                                                    "optimizer.pth"),
        initialize_retrieval=os.path.join(FC_RUN_DIR, "model_vse-best.pth"),
        audit_grad_isolation=1)
    base.update(kw)
    return listener_opt(flags, batch_size, **base)


def reinforce_per_turn(opt, turn):
    """Launches of one iteration of `turn`: a speaker turn launches what an
    SCST iteration does (stage A: the sample and the greedy decode; stage
    B: the sample under autograd and its L - 1 recomputed steps), and the
    greedy baseline one more greedy decode in stage B (L steps of A and of
    B); a listener turn one sampled decode without autograd (L steps of A,
    no head)."""
    if turn == "listener":
        return with_cell_pass({"attention": L, "cell": L}, "tf32x3")
    want = scst_per_iteration()
    if opt.reinforce_baseline_type == "greedy":
        for k in ("attention", "greedy_head", "cell", "cell_tf32x3"):
            want[k] += L
    return want


def reinforce_turns(tr, n, add, what):
    """n iterations of `tr`: each one's
    launches against `reinforce_per_turn`, finite losses, stage B's ids
    equal to stage A's on a reward turn, and (the audit on) only the
    turn's agents moved.  Returns {turn: its last loss dict's numbers}."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.training import joint
    last = {}
    for _ in range(n):
        _dispatch.reset_launches()
        tr.last_reward_seqs = None
        loss_dict, turn, _ = tr.train_iteration()
        torch.cuda.synchronize()
        got = launch_counts()
        add(got)
        per = reinforce_per_turn(tr.opt, turn)
        want = {k: per.get(k, 0) for k in got}
        require(got == want, f"{what}, {turn} turn: launches {got}, "
                f"expected {want}")
        require_head_pass(f"{what}, {turn} turn", "tf32x3")
        if joint.needs_reward(tr.opt, turn):
            a, b = tr.last_reward_seqs
            require(torch.equal(a, b), f"{what}: stage B's ids differ "
                    f"from stage A's")
        vals = {k: float(v) for k, v in loss_dict.items()}
        require(all(np.isfinite(v) for v in vals.values()),
                f"{what}, {turn} turn: {vals}")
        last[turn] = vals
    require(tr.optim.skipped_steps() == 0, f"{what}: skipped steps")
    return last


def reinforce_stage_split(tr, data):
    """(the stage split of each turn, medians of TIMED_ITERS, and each
    turn's it/s on one fixed host batch with the audit off, and the audit's
    cost a turn)."""
    import torch
    split = {t: scst_split(tr, data, n=TIMED_ITERS, turn=t)
             for t in tr.turns}
    its = {}
    for audit in (0, 1):
        tr.opt.audit_grad_isolation = audit
        tr.train_iteration(data)  # warm-up
        times = {}
        for _ in range(2 * TIMED_ITERS):
            turn = tr.turn
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train_iteration(data)
            torch.cuda.synchronize()
            times.setdefault(turn, []).append(time.perf_counter() - t0)
        its[audit] = {t: 1.0 / float(np.median(v)) for t, v in times.items()}
        its[audit]["alternating"] = 2 * TIMED_ITERS / sum(
            sum(v) for v in times.values())
    tr.opt.audit_grad_isolation = 1
    return split, its[0], its[1]


def reinforce_alternation(ds, add, out, smi):
    """(a) -o reinforce -v 1 with the gt baseline, then (b) the greedy and
    the no baseline: the launches of each turn, the audit, the stage split
    and it/s of each turn."""
    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    tr = Trainer(reinforce_opt(TRAIN_B), dataset=ds, device=DEVICE,
                 verbose=False)
    require(tr.turns == ["speaker", "listener"] and tr.turn == "speaker",
            f"reinforce turns {tr.turns}")
    check_joint_seeded(tr)
    t0 = time.perf_counter()
    last = reinforce_turns(tr, REINFORCE_ITERS, add, "gt baseline")
    print(f"  {REINFORCE_ITERS} iterations of -o reinforce -v 1 (gt "
          f"baseline), audited: {time.perf_counter() - t0:.2f} s; per turn "
          f"the launches "
          f"{ {t: reinforce_per_turn(tr.opt, t) for t in tr.turns} }"
          f"; last speaker turn "
          + ", ".join(f"{k} {v:.4f}" for k, v in
                      sorted(last['speaker'].items()))
          + "; last listener turn loss_vse "
          f"{last['listener']['loss_vse']:.4f}", flush=True)
    data = tr.loader.get_batch("train")
    split, its, its_audit = reinforce_stage_split(tr, data)
    out["split_ms"], out["its"], out["its_audit"] = split, its, its_audit
    for turn, sp in split.items():
        print(f"  {turn} turn ({smi}; B={TRAIN_B}, f32, one fixed host "
              f"batch, medians of {TIMED_ITERS}): "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in sp.items())
              + f"; {its[turn]:.2f} it/s ({its_audit[turn]:.2f} audited)",
              flush=True)
    print(f"  alternating speaker / listener: {its['alternating']:.2f} it/s "
          f"({its_audit['alternating']:.2f} audited)", flush=True)

    for baseline in BASELINES[1:]:
        other = Trainer(reinforce_opt(TRAIN_B, baseline), dataset=ds,
                        device=DEVICE, verbose=False)
        last = reinforce_turns(other, BASELINE_ITERS, add,
                               f"{baseline} baseline")
        sp = last["speaker"]
        print(f"  -o reinforce -v 1, {baseline} baseline: {BASELINE_ITERS} "
              f"iterations, audited; "
              f"speaker turn launches "
              f"{reinforce_per_turn(other.opt, 'speaker')}; "
              f"retrieval_loss {sp['retrieval_loss']:.4f}, "
              f"retrieval_loss_greedy {sp['retrieval_loss_greedy']:.4f}, "
              f"retrieval_sc_loss {sp['retrieval_sc_loss']:.6f}", flush=True)
        del other
    return tr


def reinforce_ablations(ds, add, out):
    """(c) The reinforce_listener and reinforce_speaker ablations through
    loop.train: each iteration's launches, and only the expected agent
    moved from the stage files."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.training import checkpoint
    from cooperativeimagecaptioning_tpu_torch.training import loop
    from cooperativeimagecaptioning_tpu_torch.utils.tree import leaves
    seeds = {"speaker": checkpoint.load_params(
                 os.path.join(TRAIN_RUN_DIR, "model.pth"))["speaker"],
             "listener": checkpoint.load_params(
                 os.path.join(FC_RUN_DIR, "model_vse-best.pth"))["listener"]}
    for which, turn, moves in (("reinforce_listener", "listener",
                                "listener"),
                               ("reinforce_speaker", "optimizer",
                                "speaker")):
        opt = reinforce_opt(TRAIN_B, which=which, start_from=None)
        _dispatch.reset_launches()
        t0 = time.perf_counter()
        tr = loop.train(opt, dataset=ds, max_iterations=ABLATION_ITERS,
                        device=DEVICE, verbose=False)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = launch_counts()
        add(got)
        per = reinforce_per_turn(opt, turn)
        want = {k: ABLATION_ITERS * per.get(k, 0) for k in got}
        require(tr.turn == turn, f"{which}: turn {tr.turn}")
        require(got == want, f"{which}: launches {got}, expected {want}")
        require_head_pass(which, "tf32x3")
        for agent, seeded in seeds.items():
            same = all(torch.equal(x.detach().cpu(), y) for (_, x), (_, y)
                       in zip(leaves(tr.params[agent]), leaves(seeded)))
            require(same != (agent == moves), f"{which}: the {agent} "
                    f"{'did not move' if same else 'moved'}")
        print(f"  loop.train({which}, max_iterations={ABLATION_ITERS}) in "
              f"{secs:.1f} s, audited: turn {turn!r}, only the {moves} "
              f"moved; launches { {k: v for k, v in got.items() if v} } "
              f"({per} an iteration)", flush=True)
        out[which] = secs
        del tr


def reinforce_against_cpu(ds):
    """(d) The first speaker step of each baseline and a listener turn at
    B=16, dropout off: stage B on the card with its draws recorded, then on
    the CPU port replaying them: the sampled rows all equal, the losses to
    1e-4 relative, every gradient leaf of both agents by phase 5's rule."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops import draws
    from cooperativeimagecaptioning_tpu_torch.training import joint
    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    from cooperativeimagecaptioning_tpu_torch.utils.tree import leaves
    out = {}
    for baseline in BASELINES:
        tr = Trainer(reinforce_opt(LISTENER_CPU_B, baseline,
                                   drop_prob_lm=0.0, start_from=None),
                     dataset=ds, device=DEVICE, verbose=False)
        data = tr.loader.get_batch("train")
        batch = tr._prepare_batch(data)
        cpu_batch = {k: None if v is None else v.cpu()
                     for k, v in batch.items()}
        hp = tr._hyper()
        turns = ("speaker", "listener") if baseline == "gt" else ("speaker",)
        for turn in turns:
            reward = None
            if joint.needs_reward(tr.opt, turn):
                gen, greedy = tr._sample_fns[turn](
                    tr.params, batch, tr.iteration_streams(), hp)
                reward, _, _ = joint.host_reward(tr.opt, data["gts"], gen,
                                                 greedy)
                reward = torch.from_numpy(reward)
            rec = {k: draws.Record(v)
                   for k, v in tr.iteration_streams().items()}
            seen_g, seen_c = {}, {}
            (_, aux_g), grads_g = tr._grad_fns[turn](
                tr.params, batch, rec, hp,
                None if reward is None else reward.to(DEVICE), seen_g)
            replay = {k: draws.Replay([x.cpu() for x in r.taken])
                      for k, r in rec.items()}
            (_, aux_c), grads_c = tr._grad_fns[turn](
                cpu_copy(tr.params), cpu_batch, replay, hp, reward, seen_c)
            if reward is not None:
                require(torch.equal(seen_g["seq"], gen),
                        f"{baseline}: stage B's ids on the card differ "
                        f"from stage A's")
            shares = {k: float((seen_g[k].cpu() == seen_c[k]).all(dim=1)
                               .float().mean()) for k in seen_g}
            rels = {k: abs(aux_g[k].item() - aux_c[k].item())
                    / abs(aux_c[k].item()) for k in aux_c
                    if aux_c[k].item() != 0.0}
            worst, worst_key, max_abs = grads_against(grads_g, grads_c)
            what = f"{turn} turn" + (f", {baseline} baseline"
                                     if turn == "speaker" else "")
            print(f"  B={LISTENER_CPU_B} {what}, card vs cpu port on the "
                  f"card's noise: rows equal {shares}; relative "
                  + ", ".join(f"{k} {v:.2e}" for k, v in sorted(rels.items()))
                  + f"; gradients of both agents max abs difference "
                  f"{max_abs:.3e}, worst leaf {worst_key} at {worst:.3f} of "
                  f"its tolerance", flush=True)
            require(shares and all(v == 1.0 for v in shares.values()),
                    f"{what}: rows equal {shares}")
            require(all(v <= 1e-4 for v in rels.values()), f"{what}: {rels}")
            require(worst <= 1.0, f"{what}: gradient {worst_key} at {worst}")
            frozen = "listener" if turn == "speaker" else "speaker"
            require(all(g.abs().sum().item() == 0 for _, g in
                        leaves(grads_g[frozen])),
                    f"{what}: a {frozen} gradient is not zero")
            out[what] = {"rel": rels, "worst": worst}
        del tr
    return out


def reinforce_resume_and_eval(tr, ds, add, out):
    """(e) checkpoint_operations at an odd iteration (the alternating
    artifacts), a new Trainer resumed from the run dir (params and both
    Adam states equal, its next turn the listener's), and eval.eval on the
    run dir (beam 2, through C)."""
    import torch
    from cooperativeimagecaptioning_tpu_torch import eval as eval_entry
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    from cooperativeimagecaptioning_tpu_torch.utils.tree import leaves
    if tr.iteration % 2 == 0:
        reinforce_turns(tr, 1, add, "odd iteration")
    _dispatch.reset_launches()
    t0 = time.perf_counter()
    val_loss, _ = tr.checkpoint_operations()
    torch.cuda.synchronize()
    got = launch_counts()
    add(got)
    out["ckpt_s"] = time.perf_counter() - t0
    written = sorted(os.listdir(REINFORCE_RUN_DIR))
    for name in ("alternatingModel.pth",
                 f"alternatingModel-{tr.iteration}.pth",
                 "speaker_optimizer.pth", "listener_optimizer.pth",
                 "infos_.pkl", "histories_.pkl"):
        require(name in written, f"reinforce checkpoint_operations: "
                f"{written}")
    require(all(np.isfinite(val_loss.get(k, np.nan)) for k in
                ("retrieval_sc_loss", "retrieval_loss",
                 "retrieval_loss_greedy", "t2i_r1")),
            f"reinforce val: {sorted(val_loss)}")
    print(f"  checkpoint_operations at iteration {tr.iteration} in "
          f"{out['ckpt_s']:.1f} s: val retrieval_sc_loss "
          f"{val_loss['retrieval_sc_loss']:.6f}, retrieval_loss "
          f"{val_loss['retrieval_loss']:.4f}, generated-caption t2i r1 "
          f"{val_loss['t2i_r1']:.2f}; wrote {written}; launches "
          f"{ {k: v for k, v in got.items() if v} }", flush=True)

    again = Trainer(reinforce_opt(TRAIN_B), dataset=ds, device=DEVICE,
                    verbose=False)
    require(again.iteration == tr.iteration and again.turn == "listener",
            f"resumed at {again.iteration}, next turn {again.turn}")
    for (k, a), (_, b) in zip(leaves(tr.params), leaves(again.params)):
        require(torch.equal(a, b), f"resumed param {k}")
    for agent in ("speaker", "listener"):
        a, b = tr.optim.states[agent], again.optim.states[agent]
        require(int(a["count"]) == int(b["count"]),
                f"resumed {agent} Adam count")
        for key in ("mu", "nu"):
            require(all(torch.equal(x, y) for x, y in zip(a[key], b[key])),
                    f"resumed {agent} Adam {key}")
    print(f"  Trainer resumed from the run dir at iteration "
          f"{again.iteration}: params and both agents' Adam states equal "
          f"(counts speaker {int(again.optim.states['speaker']['count'])}, "
          f"listener {int(again.optim.states['listener']['count'])}); its "
          f"next turn is the listener's", flush=True)

    os.chdir(REINFORCE_RUN_DIR)  # eval_results/ is written under the run dir
    try:
        buf = io.StringIO()
        _dispatch.reset_launches()
        with contextlib.redirect_stdout(buf):
            res = eval_entry.eval(
                None, os.path.join(REINFORCE_RUN_DIR, "alternatingModel.pth"),
                os.path.join(REINFORCE_RUN_DIR, "infos_.pkl"), split="test",
                dataset=ds, device=DEVICE)
        torch.cuda.synchronize()
        got = launch_counts()
    finally:
        os.chdir(REPO)
    add(got)
    loss = res["loss"]
    require(got["beam_head"] > 0 and got["attention"] > 0,
            f"eval.eval launches {got}")
    require_head_pass("eval.eval of the reinforce run", "tf32x3")
    require(all(np.isfinite(loss.get(k, np.nan)) for k in
                ("retrieval_sc_loss", "retrieval_loss", "t2i_r1")),
            f"eval.eval of the reinforce run: {sorted(loss)}")
    print(f"  eval.eval on the reinforce run dir, beam 2, test: "
          f"{len(res['split_predictions'])} captions, retrieval_sc_loss "
          f"{loss['retrieval_sc_loss']:.6f}, t2i r1 {loss['t2i_r1']:.2f}; "
          f"launches { {k: v for k, v in got.items() if v} }", flush=True)
    return again


def reinforce_profile(tr, add, out):
    """(f) A profiler window of PROFILE_ITERS iterations through
    Trainer.train: the trace file exists and names the attention and head
    kernels among its kernels."""
    import shutil
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    shutil.rmtree(PROFILE_DIR, ignore_errors=True)
    start = tr.iteration
    tr.opt.profile_dir = PROFILE_DIR
    tr.opt.profile_start, tr.opt.profile_steps = start, PROFILE_ITERS
    _dispatch.reset_launches()
    t0 = time.perf_counter()
    tr.train(max_iterations=start + PROFILE_ITERS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    add(launch_counts())
    require_head_pass("the profiler window", "tf32x3")
    path = tr.last_trace
    require(path is not None and os.path.isfile(path),
            f"profiler window: no trace under {PROFILE_DIR}")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0.0) + e.get("dur", 0)
    iters = sorted({e["name"] for e in events
                    if e.get("name", "").startswith("train_iteration ")})
    att = [n for n in kernels if "attention_kernel" in n or "att_h_" in n]
    head = [n for n in kernels if "vocab_partials" in n
            or "greedy_merge" in n]
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    print(f"  profiler window, iterations {start}-{start + PROFILE_ITERS - 1}"
          f" ({iters}) in {secs:.1f} s: {path} "
          f"({os.path.getsize(path) / 1e6:.1f} MB), {len(kernels)} kernel "
          f"names, {len(att)} of the attention, {len(head)} of the greedy "
          f"head; largest device time (us): "
          + ", ".join(f"{n[:48]} {d:.0f}" for n, d in top), flush=True)
    require(len(iters) == PROFILE_ITERS, f"profiler window: {iters}")
    require(att and head, f"profiler window: the trace names no attention "
            f"or head kernel among {sorted(kernels)[:20]}")
    out["profile_s"] = secs


def phase_reinforce(smi):
    """Phase 10: (a) -o reinforce -v 1 (gt baseline), (b) the greedy and
    no baselines, (c) the two ablations, (d) the B=16 steps against the
    CPU port, (e) the resume at an odd iteration and eval.eval, (f) the
    profiler window.  Returns the launches of the main path's segments
    (each counted from 0 before it to just after it) and the numbers."""
    import shutil
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    t_phase = time.perf_counter()
    shutil.rmtree(REINFORCE_RUN_DIR, ignore_errors=True)
    ds = train_dataset()
    print(f"joint REINFORCE: run_joint.py -o reinforce -v 1 (att2in2 + "
          f"listener, DISC 0.01 by REINFORCE, CIDEr-D 0.99 on its sample), "
          f"seeded from phase 5's speaker and 8(a)'s listener, vocab "
          f"{VOCAB}, width {WIDTH}, K={K}, L={L}, B={TRAIN_B}, f32",
          flush=True)
    launches = {k: 0 for k in counted()}

    def add(got):
        for k in launches:
            launches[k] += got[k]

    out = {}
    tr = reinforce_alternation(ds, add, out, smi)
    reinforce_ablations(ds, add, out)
    out["cpu"] = reinforce_against_cpu(ds)
    resumed = reinforce_resume_and_eval(tr, ds, add, out)
    del tr
    reinforce_profile(resumed, add, out)
    print(f"  joint REINFORCE phase in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches, out


# ---------------------------------------------------------------------------
# 11. the device rewards, the feature cache and fused chunks
# ---------------------------------------------------------------------------

DEV_RUN_DIR = os.path.join(REPO, "build", "chip_smoke_device_run")
DF_DIR = os.path.join(REPO, "build", "chip_smoke_df")
DEV_ITERS = 5        # device-reward iterations a cell-kernel setting
FUSED_K = 8          # steps of a fused chunk
# the device tier against the host tier: JAX's own tolerance
# (tests/test_ngram_device.py:45)
NGRAM_RTOL, NGRAM_ATOL = 2e-4, 2e-5
# a fused chunk against its per-step run on the card: losses, and params by
# tests/test_fused_steps.py:28's rule
FUSED_LOSS_RTOL = 1e-6
FUSED_PARAM_RTOL, FUSED_PARAM_ATOL = 1e-6, 1e-7
# soft CIDEr's B=16 step, card against CPU: the speaker's gradients reach
# ~1e12 through the straight-through rows (log(0 + 1e-20)), so every leaf is
# held to 1e-4 of its agent's largest entry (f32 summation order)
SOFT_GRAD_REL = 1e-4


def device_per_iteration(opt):
    """Launches of one iteration with a device reward tier (L steps, remat
    on): on_device_cider samples under autograd (L attention steps),
    decodes the greedy baseline (L steps through the greedy head) and its
    backward recomputes the L - 1 checkpointed steps; the soft CIDEr of a
    relaxed DISC sample has no greedy decode."""
    steps = L + (L - 1) + (L if opt.on_device_cider else 0)
    return with_cell_pass({"attention": steps, "cell": steps,
                           "greedy_head": L if opt.on_device_cider else 0},
                          "tf32x3")


def iteration_profile(trainer, data, n=SCST_ITERS):
    """(it/s, traced kernel ms of one iteration, its idle share = 1 -
    kernel ms / untraced ms) on one fixed host batch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    its = iterations_per_s(trainer, data, n=n)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_iteration(data)
        torch.cuda.synchronize()
    kernel_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA) / 1e3
    return its, kernel_ms, 1.0 - kernel_ms * its / 1e3


def write_df_pickle(ds):
    """The cached-df pickle of the synthetic dataset's train split, built by
    the port's preprocess/ngrams.py from a Karpathy-format json and its
    ix_to_word json (the ids' words are 'w<id>'); returns the -idxs.p
    path, the one cached_tokens names."""
    from cooperativeimagecaptioning_tpu_torch.preprocess import ngrams
    os.makedirs(DF_DIR, exist_ok=True)
    images = []
    for ix in range(ds.num_images()):
        sents = [{"tokens": [ds.ix_to_word[str(int(t))] for t in row if t]}
                 for row in ds.get_refs(ix)]
        images.append({"split": ds.info["images"][ix]["split"],
                       "sentences": sents})
    data = os.path.join(DF_DIR, "data.json")
    words = os.path.join(DF_DIR, "dict.json")
    with open(data, "w") as f:
        json.dump({"images": images}, f)
    with open(words, "w") as f:
        json.dump({"ix_to_word": ds.ix_to_word}, f)
    stem = os.path.join(DF_DIR, "synthetic-train")
    n = ngrams.prepro_ngrams(data, words, stem, "train")
    require(n == len([i for i in images if i["split"] == "train"]),
            f"df pickle: ref_len {n}")
    return stem + "-idxs.p"


def reward_agreement(ds, out):
    """Stage A's ids of a B=128 batch (phase 7's trainer and batch) scored
    by the device tier and by the host tier: corpus df, and the cached df
    of a pickle the port's preprocess/ngrams.py builds from the dataset;
    the device reward's time and peak memory."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.rewards import (
        cider_d, ngram_device, self_critical)
    from cooperativeimagecaptioning_tpu_torch.training import joint
    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    tr = Trainer(scst_opt(TRAIN_B), dataset=ds, device=DEVICE, verbose=False)
    data = tr.loader.get_batch("train")
    batch = tr._prepare_batch(data)
    gen, greedy = tr._sample_fns[tr.turn](tr.params, batch,
                                          tr.iteration_streams(),
                                          tr._hyper())
    refs, mask = (torch.from_numpy(x).to(DEVICE)
                  for x in tr._padded_refs(data["gts"]))
    B = gen.shape[0]

    def device(table=None):
        return ngram_device.ciderd_rewards_device(
            gen, greedy, refs, mask, seq_per_img=1, df_table=table)

    def agree(what, want_scores, want_greedy, table=None):
        scores, _, cider_greedy = device(table)
        got = scores.cpu().numpy()
        err = float(np.abs(got - want_scores).max())
        ok = np.allclose(got, want_scores, rtol=NGRAM_RTOL, atol=NGRAM_ATOL)
        ok_greedy = abs(float(cider_greedy) - want_greedy) <= \
            NGRAM_ATOL + NGRAM_RTOL * abs(want_greedy)
        print(f"  device CIDEr-D reward vs host, {what}, {2 * B} captions: "
              f"max abs difference {err:.2e} (rtol {NGRAM_RTOL:.0e}, atol "
              f"{NGRAM_ATOL:.0e}) over scores up to "
              f"{np.abs(want_scores).max():.4f}; cider_greedy "
              f"{float(cider_greedy):.6f} vs {want_greedy:.6f}", flush=True)
        require(ok and ok_greedy,
                f"device reward ({what}) against the host tier: {err}")
        return err

    path = write_df_pickle(ds)
    scorer = cider_d.CiderD(df="synthetic-train-idxs", df_path=path)
    table = ngram_device.load_df_table(path, DEVICE)
    # stage A's ids (phase 5's speaker repeats one caption, so its CIDEr-D
    # is near 0), then each image's first GT caption as the sample and the
    # next image's as the baseline (scores far from 0)
    firsts = torch.from_numpy(np.stack([g[0] for g in data["gts"]])).to(
        gen.device, gen.dtype)
    for ids, name in (((gen, greedy), "stage A's ids"),
                      ((firsts, firsts.roll(1, 0)), "GT captions")):
        gen, greedy = ids
        host, _, host_greedy = joint.host_reward(tr.opt, data["gts"], gen,
                                                 greedy)
        err = agree(f"{name}, corpus df", host, host_greedy)
        both = torch.cat([gen, greedy]).cpu().numpy()
        res = [{"image_id": i,
                "caption": [self_critical.array_to_str(both[i])]}
               for i in range(2 * B)]
        gts = {i: [self_critical.array_to_str(g) for g in data["gts"][i % B]]
               for i in range(2 * B)}
        _, s = scorer.compute_score(gts, res)
        err_c = agree(f"{name}, cached df (preprocess/ngrams.py pickle)",
                      s[:B] - s[B:], float(s[B:].mean()), table)
        out["reward_err_corpus"] = max(out.get("reward_err_corpus", 0), err)
        out["reward_err_cached"] = max(out.get("reward_err_cached", 0), err_c)
    for key, tb in (("corpus", None), ("cached", table)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        device(tb)
        torch.cuda.synchronize()
        out[f"reward_peak_mb_{key}"] = \
            (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        out[f"reward_ms_{key}"] = cuda_ms(lambda tb=tb: device(tb), 10)
    print(f"  device reward at B={B}, R={refs.shape[1]}, L={L}: corpus df "
          f"{out['reward_ms_corpus']:.3f} ms, peak "
          f"{out['reward_peak_mb_corpus']:.1f} MiB above its inputs; cached "
          f"df {out['reward_ms_cached']:.3f} ms, peak "
          f"{out['reward_peak_mb_cached']:.1f} MiB", flush=True)
    del tr
    return path


def device_tier_runs(tr, what, add, out, key):
    """DEV_ITERS iterations: finite losses, no host stage, the launches an
    iteration; then the stage split, it/s and the idle share."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.training import joint
    opt = tr.opt
    require(not joint.needs_reward(opt, tr.turn),
            f"{what}: the host reward stage still runs")
    _dispatch.reset_launches()
    for _ in range(DEV_ITERS):
        loss_dict, _, _ = tr.train_iteration()
        require(tr.last_reward_seqs is None,
                f"{what}: a host reward stage ran")
        vals = {k: float(v) for k, v in loss_dict.items()}
        require(all(np.isfinite(v) for v in vals.values()),
                f"{what}: {vals}")
    torch.cuda.synchronize()
    got = launch_counts()
    per = device_per_iteration(opt)
    want = {k: DEV_ITERS * per.get(k, 0) for k in got}
    require(got == want, f"{what}: launches {got}, expected {want} ({per} "
            f"an iteration)")
    require_head_pass(what, "tf32x3")
    print(f"  {DEV_ITERS} iterations of {what}: last " + ", ".join(
              f"{k} {v:.4f}" for k, v in sorted(vals.items()))
          + f"; launches {per} an iteration", flush=True)
    add(got)
    data = tr.loader.get_batch("train")
    split = scst_split(tr, data, n=DEV_ITERS)
    require(set(split) == {"stage_b", "adam"},
            f"{what}: stages {sorted(split)}")
    its, kernel_ms, idle = iteration_profile(tr, data, n=DEV_ITERS)
    out[key] = {"split_ms": split, "it_per_s": its,
                "kernel_ms": kernel_ms, "idle_share": idle}
    return out[key]


def host_reward_profile(ds):
    """Phase 7's host-reward SCST iteration, for its idle share beside the
    device tier's in this run."""
    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    tr = Trainer(scst_opt(TRAIN_B), dataset=ds, device=DEVICE, verbose=False)
    data = tr.loader.get_batch("train")
    split = scst_split(tr, data, n=DEV_ITERS)
    its, kernel_ms, idle = iteration_profile(tr, data, n=DEV_ITERS)
    return {"split_ms": split, "it_per_s": its, "kernel_ms": kernel_ms,
            "idle_share": idle}


def device_step_against_cpu(opt, what, soft):
    """The first step of `opt` (B=16, dropout off, the device tier inside)
    on the card with its draws recorded, then on the CPU port replaying
    them: the share of rows whose sampled ids are equal (>= AGREE_F32);
    on the equal rows the losses to STEP_LOSS_RTOL and every gradient leaf
    by phase 5's rule (soft CIDEr: SOFT_GRAD_REL of the agent's largest
    entry)."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops import draws
    from cooperativeimagecaptioning_tpu_torch.training import joint
    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    from cooperativeimagecaptioning_tpu_torch.utils.tree import leaves
    tr = Trainer(opt, dataset=train_dataset(), device=DEVICE, verbose=False)
    turn = tr.turn
    data = tr.loader.get_batch("train")
    batch = tr._prepare_batch(data)
    hp = tr._hyper()
    fn = joint.value_and_grad(opt, turn)
    rec = {k: draws.Record(v) for k, v in tr.iteration_streams().items()}
    sampled = {}
    fn(tr.params, batch, rec, hp, None, sampled)
    taken = {k: [x.cpu() for x in r.taken] for k, r in rec.items()}
    seq_key = "disc_seq" if soft else "seq"
    cpu_params = cpu_copy(tr.params)

    def on(b, device):
        return {k: (None if v is None else v if k == "df_table"
                    else v.to(device)) for k, v in b.items()}

    def step(params, b, rows):
        replay = {k: draws.Replay([x[rows] for x in v])
                  for k, v in taken.items()}
        s = {}
        (loss, aux), grads = fn(params, b, replay, hp, None, s)
        return loss.item(), {k: float(v) for k, v in aux.items()}, grads, \
            s[seq_key].cpu()

    def rows_of(b, rows):
        # seq_per_img is 1: the refs' rows are the captions' rows
        return {k: v if v is None or k == "df_table"
                else v[rows.to(v.device)] for k, v in b.items()}

    every = torch.arange(opt.batch_size)
    cpu_batch = on(batch, "cpu")
    _, _, _, seq_g = step(tr.params, batch, every)
    _, _, _, seq_c = step(cpu_params, cpu_batch, every)
    require(torch.equal(seq_g, sampled[seq_key].cpu()),
            f"{what} B=16: the replayed step differs from the recorded one")
    equal = (seq_g == seq_c).all(dim=1)
    share = float(equal.float().mean())
    rows = torch.nonzero(equal)[:, 0]
    loss_g, aux_g, grads_g, _ = step(tr.params, rows_of(batch, rows), rows)
    loss_c, aux_c, grads_c, _ = step(cpu_params, rows_of(cpu_batch, rows),
                                     rows)
    rel = max(abs(aux_g[k] - aux_c[k]) / max(abs(aux_c[k]), 1e-12)
              for k in aux_c if k.startswith("loss"))
    if soft:
        top = {}
        for key, c in leaves(grads_c):
            a = key.split(".")[0]
            top[a] = max(top.get(a, 0.0), c.abs().max().item())
        worst, worst_key = 0.0, ""
        cpu = dict(leaves(grads_c))
        for key, g in leaves(grads_g):
            r = (g.cpu() - cpu[key]).abs().max().item() / (
                SOFT_GRAD_REL * top[key.split(".")[0]])
            if r > worst:
                worst, worst_key = r, key
    else:
        worst, worst_key, _ = grads_against(grads_g, grads_c)
    print(f"  B={opt.batch_size} first step of {what}, card vs cpu port on "
          f"the same noise: sampled ids of {share * 100:.1f}% of the rows "
          f"equal (need >= {AGREE_F32 * 100:.0f}%); on those {len(rows)} "
          f"rows loss {loss_g:.6f} vs {loss_c:.6f}, the loss terms within "
          f"{rel:.2e} relative (tol {STEP_LOSS_RTOL:.0e}); worst gradient "
          f"leaf {worst_key} at {worst:.3f} of its tolerance", flush=True)
    require(share >= AGREE_F32, f"{what} B=16: {share} of rows equal")
    require(rel <= STEP_LOSS_RTOL, f"{what} B=16: loss terms at {rel}")
    require(worst <= 1.0, f"{what} B=16: gradient {worst_key} at {worst}")
    return share, rel


def fused_pair(make_opt, what, add, out, key):
    """FUSED_K single steps and one chunk of FUSED_K on the card from one
    seed (the feature cache on both): per-step losses, params, skipped
    counts; launches per replay; then it/s of FUSED_K more steps each, in
    turns (per-step, fused, fused, per-step)."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    from cooperativeimagecaptioning_tpu_torch.utils.tree import leaves
    ds = train_dataset()
    trs = {}
    for k in (1, FUSED_K):
        trs[k] = Trainer(make_opt().replace(
            fused_steps=k, device_feature_cache=1,
            checkpoint_path=os.path.join(DEV_RUN_DIR, f"fused{k}")),
            dataset=ds, device=DEVICE, verbose=False)
        require(trs[k]._fused_gate() == ("off" if k == 1 else None),
                f"{what}: gate {trs[k]._fused_gate()}")
    start = trs[1].iteration
    _dispatch.reset_launches()
    for tr in trs.values():
        t0 = time.perf_counter()
        tr.train(max_iterations=start + FUSED_K)
        torch.cuda.synchronize()
        out[f"{key}_first_s_{tr.opt.fused_steps}"] = \
            time.perf_counter() - t0
    add(launch_counts())
    # a replay's head launches are the captured ones, counted at capture
    require_head_pass(f"{what}, single steps and fused chunks", "tf32x3")
    a, b = trs[1], trs[FUSED_K]
    # one captured iteration per (turn, scheduled sampling on); a chunk
    # ends where scheduled sampling switches on, and each capture follows
    # one eager warm-up step
    runners = list(b._fused.values())
    replays = sum(r.replays for r in runners)
    require(all(r.plan is not None for r in runners) and
            replays + len(runners) == FUSED_K,
            f"{what}: {replays} replays of {len(runners)} captured "
            f"iterations in {FUSED_K} steps")
    la = {i: float(v) for i, v in a.loss_history.items()}
    lb = {i: float(v) for i, v in b.loss_history.items()}
    require(la.keys() == lb.keys() and len(la) == FUSED_K,
            f"{what}: histories {sorted(la)} vs {sorted(lb)}")
    loss_rel = max(abs(lb[i] - la[i]) / abs(la[i]) for i in la)
    worst, worst_key, max_abs = 0.0, "", 0.0
    pb = dict(leaves(b.params))
    for k_, x in leaves(a.params):
        d = (pb[k_] - x).abs()
        r = (d / (FUSED_PARAM_ATOL + FUSED_PARAM_RTOL * x.abs())).max().item()
        max_abs = max(max_abs, d.max().item())
        if r > worst:
            worst, worst_key = r, k_
    skipped = (a.optim.skipped_steps(), b.optim.skipped_steps())
    per_replay = {k_: v for k_, v in (runners[0].launches or {}).items()
                  if v}
    print(f"  {what}: {FUSED_K} single steps vs fused chunks of "
          f"{FUSED_K} ({len(runners)} captured iteration(s), each after an "
          f"eager warm-up step; {replays} replays): losses within "
          f"{loss_rel:.2e} relative (tol "
          f"{FUSED_LOSS_RTOL:.0e}); params max abs difference {max_abs:.3e},"
          f" worst leaf {worst_key} at {worst:.3f} of rtol "
          f"{FUSED_PARAM_RTOL:.0e} / atol {FUSED_PARAM_ATOL:.0e}; skipped "
          f"steps {skipped[0]} vs {skipped[1]}; launches a replay "
          f"{per_replay}", flush=True)
    require(loss_rel <= FUSED_LOSS_RTOL, f"{what}: losses at {loss_rel}")
    require(worst <= 1.0, f"{what}: param {worst_key} at {worst} of the "
            f"tolerance")
    require(skipped[0] == skipped[1], f"{what}: skipped {skipped}")
    rates = {1: [], FUSED_K: []}
    for k in (1, FUSED_K, FUSED_K, 1):
        tr = trs[k]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train(max_iterations=tr.iteration + FUSED_K)
        torch.cuda.synchronize()
        rates[k].append(FUSED_K / (time.perf_counter() - t0))
    require(all(r.launches == runners[0].launches for r in runners),
            f"{what}: launches a replay differ between captures")
    out[key] = {"loss_rel": loss_rel, "param_max_abs": max_abs,
                "param_worst": worst, "skipped": skipped,
                "per_replay": per_replay, "captures": len(runners),
                "per_step_it_per_s": float(np.mean(rates[1])),
                "fused_it_per_s": float(np.mean(rates[FUSED_K])),
                "cache_bytes": b.feature_cache_bytes,
                "cache_build_s": a.feature_cache_seconds}
    print(f"  {what}: per-step {out[key]['per_step_it_per_s']:.2f} it/s, "
          f"fused {out[key]['fused_it_per_s']:.2f} it/s (in turns: "
          + ", ".join(f"{r:.2f}" for r in rates[1] + rates[FUSED_K])
          + f"); the feature cache {b.feature_cache_bytes / 2 ** 20:.1f} "
          f"MiB resident, built in {a.feature_cache_seconds:.3f} s (the "
          f"chunked trainer reuses it)", flush=True)
    require(b._feat_cache is a._feat_cache, f"{what}: the cache was built "
            f"twice")


def phase_device_rewards(smi, scst_out, listener_out):
    """Phase 11: (a) the device reward against the host reward on stage A's
    ids (corpus and cached df), its time and memory; (b) SCST with
    on_device_cider and (c) joint -o gumbel with soft_cider, beside the
    host-reward iterations; (d) their B=16 steps against the CPU port; (e)
    fused chunks of FUSED_K with the feature cache against FUSED_K single
    steps, phase-2 MLE and joint gumbel with on_device_cider.  Returns the
    launches of the main path's segments and the numbers."""
    import shutil
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    t_phase = time.perf_counter()
    shutil.rmtree(DEV_RUN_DIR, ignore_errors=True)
    ds = train_dataset()
    print(f"device rewards, feature cache, fused chunks: att2in2 vocab "
          f"{VOCAB}, width {WIDTH}, K={K}, L={L}, B={TRAIN_B}, f32", flush=True)
    launches = {k: 0 for k in counted()}

    def add(got):
        for k in launches:
            launches[k] += got[k]

    out = {}
    reward_agreement(ds, out)

    scst_dev = scst_opt(TRAIN_B).replace(on_device_cider=1,
                                         checkpoint_path=DEV_RUN_DIR)
    tr = Trainer(scst_dev, dataset=ds, device=DEVICE, verbose=False)
    dev = device_tier_runs(tr, "SCST with on_device_cider", add, out,
                           "scst_device")
    del tr
    host = host_reward_profile(ds)
    out["scst_host"] = host
    soft_opt = disc_opt("gumbel", TRAIN_B, soft_cider=1, start_from="",
                        checkpoint_path=DEV_RUN_DIR)
    tr = Trainer(soft_opt, dataset=ds, device=DEVICE, verbose=False)
    soft = device_tier_runs(tr, "joint -o gumbel with soft_cider", add, out,
                            "joint_soft")
    del tr
    for name, r, base in (
            ("SCST, on_device_cider", dev, scst_out),
            ("SCST, host reward", host, scst_out),
            ("joint -o gumbel, soft_cider", soft, listener_out)):
        sp = r["split_ms"]
        print(f"  {name} ({smi}; B={TRAIN_B}, f32, one fixed host batch, "
              f"medians of {DEV_ITERS}): "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in sp.items())
              + f"; {r['it_per_s']:.2f} it/s; one traced iteration "
              f"{r['kernel_ms']:.2f} ms of kernels, idle share "
              f"{r['idle_share']:.3f}", flush=True)
    print(f"  beside phase 7 (host reward): {scst_out['its']:.2f} it/s, "
          f"reward stage {scst_out['split_ms']['reward']:.2f} ms; phase 8 "
          f"joint -o gumbel (host reward): {listener_out['joint_its']:.2f} "
          f"it/s, reward stage "
          f"{listener_out['joint_split_ms']['reward']:.2f} ms", flush=True)

    out["scst_cpu"] = device_step_against_cpu(
        scst_opt(SCST_CPU_B, drop_prob_lm=0.0).replace(
            on_device_cider=1, checkpoint_path=DEV_RUN_DIR),
        "SCST with on_device_cider", soft=False)
    out["soft_cpu"] = device_step_against_cpu(
        disc_opt("gumbel", LISTENER_CPU_B, soft_cider=1, start_from="",
                 drop_prob_lm=0.0, checkpoint_path=DEV_RUN_DIR),
        "joint -o gumbel with soft_cider", soft=True)

    fused_pair(lambda: train_opt(TRAIN_B), "phase-2 MLE", add, out,
               "fused_mle")
    fused_pair(lambda: disc_opt("gumbel", TRAIN_B, on_device_cider=1,
                                start_from=""),
               "joint -o gumbel with on_device_cider", add, out,
               "fused_joint")
    torch.cuda.empty_cache()
    print(f"  device rewards phase in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches, out


# ---------------------------------------------------------------------------
# 12. the reproduction chain: features from images, harvest
# ---------------------------------------------------------------------------

FEATS_BASE = os.path.join(REPO, "build", "chip_smoke_feats")
HARVEST_RUN_DIR = os.path.join(REPO, "build", "chip_smoke_harvest_run")
HARVEST_JSON_DIR = os.path.join(REPO, "build", "chip_smoke_harvest_json")
RESNET_ARCH = "resnet101"
RESNET_B = 16        # bench.py's ResNet batch
RESNET_HW = 448      # the extractor's input side
RESNET_ITERS = 10
ATT_SIDE = 14        # the 14 x 14 attention grid
EXTRACT_IMAGES = 64
# card against CPU, f32 with TF32 off: the error is held relative to the
# largest value of the CPU's output (the norms are scaled to keep the
# activations at one scale through the depth: see seeded_resnet)
RESNET_REL = 1e-4
# raw image shapes of the extraction: COCO's common 640 x 480 and 500 x 375,
# and a grayscale 2-D image (the loader's channel fix)
RAW_SHAPES = ((480, 640, 3), (375, 500, 3), (480, 640))
CALIBRATION_IMAGES = 4
# distinct caption rows of the 64 served images, greedy and beam 2: the
# floor of phase 6's evaluation (16)
EXTRACT_MIN_DISTINCT = 16


def raw_images(n, seed):
    """n uint8 images of RAW_SHAPES in turn, each a smooth field of colours
    (a random 4 x 4 grid resized up) under mild noise, so that the images
    differ in colour and layout (images of i.i.d. noise give nearly equal
    features)."""
    from cooperativeimagecaptioning_tpu_torch.preprocess import feats
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        shape = RAW_SHAPES[i % len(RAW_SHAPES)]
        field = feats._resize_bilinear(rng.rand(4, 4, 3).astype(np.float32),
                                       max(shape[:2]))[:shape[0], :shape[1]]
        img = np.clip(255 * (field + 0.1 * rng.randn(*field.shape)), 0, 255)
        out.append(img.astype(np.uint8)[..., 0] if len(shape) == 2
                   else img.astype(np.uint8))
    return out


def host_batch(imgs):
    """Raw images -> the extractor's float batch [n, 448, 448, 3]."""
    from cooperativeimagecaptioning_tpu_torch.preprocess import feats
    return np.stack([feats._resize_bilinear(feats._to_rgb_float(im),
                                            RESNET_HW) for im in imgs])


def seeded_resnet():
    """ResNet-101 on the card with random weights from SEED at one scale:
    the convolutions from init_model (He scale), each batch norm's scale
    and bias drawn from SEED, and its scale divided by the RMS of its whole
    input on CALIBRATION_IMAGES images of their own (one number a norm), so
    that every norm's output has an RMS near 1.  init_model's identity
    norms let the activations grow with depth to ~2e5, where one random
    speaker gives one caption for every image.  The running statistics stay
    the identity: statistics calibrated per channel would scale the weak
    channels up to the strong ones and amplify f32 rounding with them, so
    that the CPU alone would differ from float64 by about the card-vs-CPU
    tolerance; one number a norm leaves the rounding where it is."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.preprocess import feats, resnet
    model = resnet.init_model(torch.Generator().manual_seed(SEED),
                              RESNET_ARCH)
    rng = np.random.RandomState(SEED)
    norms = [m for m in model.modules()
             if isinstance(m, torch.nn.BatchNorm2d)]

    def calibrate(m, inp):
        m.weight.div_(inp[0].pow(2).mean().sqrt())
    with torch.no_grad():
        for m in norms:
            c = m.num_features
            m.weight.copy_(torch.from_numpy(
                rng.uniform(0.5, 1.5, c).astype(np.float32)))
            m.bias.copy_(torch.from_numpy(
                rng.uniform(-0.2, 0.2, c).astype(np.float32)))
    hooks = [m.register_forward_pre_hook(calibrate) for m in norms]
    try:
        feats.make_extractor(model, ATT_SIDE, DEVICE)(host_batch(
            raw_images(CALIBRATION_IMAGES, seed=SEED + 11)))
    finally:
        for h in hooks:
            h.remove()
    return model


def conv_flops(model, hw):
    """Multiply-adds x 2 of every convolution of one image at hw x hw (the
    forward's operations; the norms and pools add under 1%)."""
    import torch
    total = [0]

    def hook(mod, _inp, out):
        k = mod.kernel_size[0] * mod.kernel_size[1]
        total[0] += 2 * out.shape[1] * out.shape[2] * out.shape[3] * \
            mod.in_channels * k
    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.no_grad():
            model(torch.zeros(1, 3, hw, hw, device=next(
                model.parameters()).device))
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def resnet_on_card(smi, out):
    """(a) ResNet-101 at full depth and width, f32: two host-resized images
    (640 x 480, and a grayscale one) on the card against the port on the
    CPU; then the network timed on device-resident input (bench.py's
    16 x 448, 10 iterations) beside its operations bound, as the extractor
    runs it (NHWC input view, weights as loaded), and beside it with TF32
    allowed (not used: the reference for what f32 costs); peak device
    memory."""
    import copy
    import torch
    from cooperativeimagecaptioning_tpu_torch.preprocess import feats, resnet
    model = seeded_resnet()
    cpu_model = copy.deepcopy(model).cpu()
    card = feats.make_extractor(model, ATT_SIDE, DEVICE)
    host = feats.make_extractor(cpu_model, ATT_SIDE, "cpu")
    imgs = raw_images(3, seed=SEED + 12)
    batch = host_batch([imgs[0], imgs[2]])
    got, want = card(batch), host(batch)
    for name, g, w in (("fc", got[0], want[0]), ("att", got[1], want[1])):
        require(g.shape == w.shape and np.isfinite(g).all(),
                f"ResNet {name} shape {g.shape}")
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        print(f"  ResNet-101 {name} {list(g.shape)}, card vs CPU: max abs "
              f"err {err:.3e}, max |value| {scale:.3e}, median |value| "
              f"{float(np.median(np.abs(w))):.3e}, relative "
              f"{err / scale:.2e} (tol {RESNET_REL:.0e})", flush=True)
        require(err <= RESNET_REL * scale,
                f"ResNet {name}: card vs CPU error {err} above "
                f"{RESNET_REL} x {scale}")
    del cpu_model, host

    mean = torch.as_tensor(resnet.IMAGENET_MEAN, device=DEVICE)
    std = torch.as_tensor(resnet.IMAGENET_STD, device=DEVICE)
    x = torch.from_numpy(np.random.RandomState(0).rand(
        RESNET_B, RESNET_HW, RESNET_HW, 3).astype(np.float32)).to(DEVICE)

    cudnn = torch.backends.cudnn

    def forward(tf32=False):
        precision = cudnn.flags(
            enabled=cudnn.enabled, benchmark=cudnn.benchmark,
            deterministic=cudnn.deterministic, allow_tf32=True) \
            if tf32 else resnet.f32_convolutions()
        with torch.no_grad(), precision:
            return resnet.features(model, (x - mean) / std, ATT_SIDE)
    sync()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(forward, RESNET_ITERS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    ms_tf32 = cuda_ms(lambda: forward(tf32=True), RESNET_ITERS)
    flops = conv_flops(model, RESNET_HW)
    weights = [p for p in model.parameters()]
    fc, att = forward()
    bound, by = bound_ms([x, fc, att] + weights, flops * RESNET_B, "float32")
    ips = RESNET_B / (ms / 1e3)
    out.update(resnet_ms=ms, resnet_ips=ips, resnet_bound_ms=bound,
               resnet_peak_mib=peak, resnet_gflop=flops / 1e9,
               resnet_ms_tf32=ms_tf32)
    print(f"  ResNet-101 forward ({smi}; f32, TF32 off, NHWC input view, "
          f"{RESNET_B} x {RESNET_HW} x {RESNET_HW}, att {ATT_SIDE}, device-"
          f"resident input, {RESNET_ITERS} iterations): {ms:.2f} ms a batch, "
          f"{ips:.1f} images/s; bound {bound:.2f} ms by {by} "
          f"({flops / 1e9:.1f} GFLOP an image at 67 TFLOP/s f32), "
          f"{bound / ms * 100:.1f}% of it; peak device memory {peak:.0f} "
          f"MiB; TF32 allowed (not used) {ms_tf32:.2f} ms", flush=True)
    del x, fc, att
    return model


def extract_on_card(model, out):
    """(b) extract_to_dirs on EXTRACT_IMAGES raw images of mixed sizes into
    build/chip_smoke_feats_{fc,att}, the host and device split; a second
    call computes nothing; DirFeatureSource reads every file back."""
    import shutil
    from cooperativeimagecaptioning_tpu_torch.data.sources import (
        DirFeatureSource)
    from cooperativeimagecaptioning_tpu_torch.preprocess import feats
    for suffix in ("_fc", "_att"):
        shutil.rmtree(FEATS_BASE + suffix, ignore_errors=True)
    imgs = raw_images(EXTRACT_IMAGES, seed=SEED + 13)
    ids = list(range(EXTRACT_IMAGES))
    split = {}
    t0 = time.perf_counter()
    dir_fc, dir_att = feats.extract_to_dirs(
        model, imgs, ids, FEATS_BASE, att_size=ATT_SIDE, batch_size=RESNET_B,
        resize_to=RESNET_HW, device=DEVICE, timings=split)
    wall = time.perf_counter() - t0
    require(split["images"] == EXTRACT_IMAGES, f"extracted {split}")
    mtimes = {f: os.path.getmtime(os.path.join(dir_att, f))
              for f in os.listdir(dir_att)}
    again = {}
    feats.extract_to_dirs(model, imgs, ids, FEATS_BASE, att_size=ATT_SIDE,
                          batch_size=RESNET_B, resize_to=RESNET_HW,
                          device=DEVICE, timings=again)
    require(again["images"] == 0 and again["forward"] == 0.0,
            f"the second extraction recomputed {again}")
    require({f: os.path.getmtime(os.path.join(dir_att, f))
             for f in os.listdir(dir_att)} == mtimes,
            "the second extraction rewrote files")
    fcs = DirFeatureSource(dir_fc, ".npy")
    atts = DirFeatureSource(dir_att, ".npz")
    fc = np.stack([fcs.get(str(i)) for i in ids])
    att = np.stack([atts.get(str(i)) for i in ids])
    require(fc.shape == (EXTRACT_IMAGES, FEAT) and fc.dtype == np.float32
            and att.shape == (EXTRACT_IMAGES, ATT_SIDE, ATT_SIDE, FEAT)
            and att.dtype == np.float32 and np.isfinite(att).all(),
            f"features read back: fc {fc.shape}, att {att.shape}")
    out["extract"] = dict(split, wall=wall)
    print(f"  extract_to_dirs: {EXTRACT_IMAGES} images "
          f"({', '.join('x'.join(map(str, s)) for s in RAW_SHAPES)}) -> "
          f"{ATT_SIDE} x {ATT_SIDE} x {FEAT} in {wall:.2f} s: host load + "
          f"resize {split['load']:.2f} s, device forward (batches of "
          f"{RESNET_B}, synchronized) {split['forward']:.2f} s, host write "
          f"{split['write']:.2f} s; a second call computed 0 images and "
          f"rewrote nothing; DirFeatureSource read back fc "
          f"{list(fc.shape)} and att {list(att.shape)}", flush=True)
    return fc, att.reshape(EXTRACT_IMAGES, ATT_SIDE * ATT_SIDE, FEAT)


def serve_extracted(fc, att, add):
    """(b) phase 4's speaker served over the extracted features through
    from_run_dir(max_att_len=196), greedy and beam 2, f32: every step
    through the attention kernel and the head; ids against the CPU
    service's, and at least EXTRACT_MIN_DISTINCT distinct rows, so that the
    captions depend on the features the kernels read.  Phase 4's speaker is
    random and its input layers were drawn for features like phase 4's,
    N(0, 1): the extracted features are served standardized per channel
    over the images (an affine map a channel, which keeps how the images
    differ)."""
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.serving import CaptioningService
    n = fc.shape[0]
    fc = ((fc - fc.mean(0)) / (fc.std(0) + 1e-6)).astype(np.float32)
    att = ((att - att.mean((0, 1))) /
           (att.std((0, 1)) + 1e-6)).astype(np.float32)
    masks = np.ones(att.shape[:2], np.float32)
    for beam in (0, 2):
        kw = dict(beam_size=beam, compute_dtype="float32", buckets=(n,),
                  max_att_len=K_GRID)
        svc = CaptioningService.from_run_dir(RUN_DIR, device=DEVICE, **kw)
        _dispatch.reset_launches()
        ids = svc.caption_ids(fc, att, masks)
        sync()
        got = launch_counts()
        add(got)
        head = "beam_head" if beam else "greedy_head"
        require(got["attention"] == got["cell"] == got[head] == L,
                f"extracted features, beam {beam}: launches {got}")
        require_head_pass(f"extracted features, beam {beam}", "tf32x3")
        cpu = CaptioningService.from_run_dir(RUN_DIR, device="cpu", **kw)
        rate = float((cpu.caption_ids(fc, att, masks) == ids).all(
            axis=1).mean())
        distinct = len({tuple(r) for r in ids})
        print(f"  phase 4's speaker over the extracted features (f32, "
              f"{'beam 2' if beam else 'greedy'}, {K_GRID} slots): "
              f"{distinct} distinct rows of {n} (need >= "
              f"{EXTRACT_MIN_DISTINCT}); card vs CPU {rate * 100:.1f}% of "
              f"rows equal (need >= {AGREE_F32 * 100:.0f}%); launches "
              f"{ {k: v for k, v in got.items() if v} }", flush=True)
        require(distinct >= EXTRACT_MIN_DISTINCT, f"extracted features, "
                f"beam {beam}: {distinct} distinct rows of {n}")
        require(rate >= AGREE_F32, f"extracted features, beam {beam}: "
                f"{rate} of rows equal to the CPU service")
        del svc, cpu


def harvest_on_card(add, out):
    """(c) harvest of a copy of phase 8's joint run dir on the card: the
    val / test dicts and the json written, only the best per-iteration
    checkpoints left (a stale alternatingModel-1.pth is planted to be
    pruned), the test re-evaluation through the port's eval.eval (beam 2:
    A and C)."""
    import pickle as pkl
    import shutil
    import torch
    from cooperativeimagecaptioning_tpu_torch.config import load_infos
    from cooperativeimagecaptioning_tpu_torch.evaluation import harvest
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    shutil.rmtree(HARVEST_RUN_DIR, ignore_errors=True)
    shutil.rmtree(HARVEST_JSON_DIR, ignore_errors=True)
    shutil.copytree(DISC_RUN_DIR, HARVEST_RUN_DIR)
    shutil.copy(os.path.join(HARVEST_RUN_DIR, "alternatingModel.pth"),
                os.path.join(HARVEST_RUN_DIR, "alternatingModel-1.pth"))
    opt = load_infos(os.path.join(HARVEST_RUN_DIR, "infos_.pkl"))["opt"]
    opt.checkpoint_path = HARVEST_RUN_DIR
    ds = train_dataset()
    os.chdir(HARVEST_RUN_DIR)  # eval_results/ is written under the run dir
    try:
        _dispatch.reset_launches()
        t0 = time.perf_counter()
        path = harvest.create_dicts_and_json_after_training(
            opt, dataset=ds, json_dir=HARVEST_JSON_DIR, device=DEVICE)
        sync()
        seconds = time.perf_counter() - t0
        got = launch_counts()
    finally:
        os.chdir(REPO)
    add(got)
    require(got["attention"] > 0 and got["beam_head"] > 0,
            f"harvest's test re-evaluation launches {got}")
    require_head_pass("harvest's test re-evaluation", "tf32x3")
    require(path is not None and os.path.isfile(path),
            f"harvest wrote no json ({path})")
    with open(os.path.join(HARVEST_RUN_DIR, "val_dict.pkl"), "rb") as f:
        metrics = pkl.load(f)
    with open(os.path.join(HARVEST_RUN_DIR, "test_dict.pkl"), "rb") as f:
        test = pkl.load(f)
    kept = sorted(int(n[len("alternatingModel-"):-len(".pth")])
                  for n in os.listdir(HARVEST_RUN_DIR)
                  if harvest._is_iter_model(n))
    best = sorted(set(metrics["test_models"].values()))
    require(best and kept == best, f"harvest kept {kept}, best {best}")
    require(test and all(np.isfinite(r["loss"]["loss"]) and
                         np.isfinite(r["loss"]["t2i_r1"]) and
                         "CIDEr" in r["lang_stats"] for r in test.values()),
            f"harvest test dict {test}")
    with open(path) as f:
        report = json.load(f)
    require(set(report["test"]) == set(test), f"harvest json {report}")
    out["harvest_s"] = seconds
    crit = sorted(test)[0]
    print(f"  harvest of phase 8's joint run dir (a copy) in {seconds:.1f} "
          f"s: best iterations {metrics['test_models']}, kept "
          f"alternatingModel-{kept}, the planted -1 pruned; test "
          f"re-evaluation (beam 2) {crit}: CIDEr "
          f"{test[crit]['lang_stats']['CIDEr']:.4f}, loss "
          f"{test[crit]['loss']['loss']:.4f}, t2i r1 "
          f"{test[crit]['loss']['t2i_r1']:.2f}; wrote val_dict.pkl, "
          f"test_dict.pkl and {os.path.relpath(path, REPO)}; launches "
          f"{ {k: v for k, v in got.items() if v} }", flush=True)


def phase_reproduction(smi):
    """12. The reproduction chain's device parts: ResNet-101 feature
    extraction (the port's preprocess/resnet.py and feats.py), the extracted
    features served, and harvest (evaluation/harvest.py) of phase 8's joint
    run dir.  The other stages of reproduce_coco (labels, n-grams and the
    three stage scripts end to end) need h5py and PIL, which this script
    does not require of the card's host: they run in the CPU tests
    (tests/test_torch_drivers.py); the stage scripts' flag sets train
    phases 8 and 10 here (PHASE1_FLAGS, JOINT_BASE, joint_flags).  Returns
    the launch counts of (b) and (c) by path."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    t_phase = time.perf_counter()
    print(f"phase 12, the reproduction chain: {RESNET_ARCH} at "
          f"{RESNET_HW} x {RESNET_HW}, f32, random weights from seed {SEED}",
          flush=True)
    launches = {p: {k: 0 for k in counted()}
                for p in ("extracted", "harvest")}

    def adder(path):
        def add(got):
            for k in launches[path]:
                launches[path][k] += got[k]
        return add
    out = {}
    model = resnet_on_card(smi, out)
    fc, att = extract_on_card(model, out)
    del model
    torch.cuda.empty_cache()
    serve_extracted(fc, att, adder("extracted"))
    harvest_on_card(adder("harvest"), out)
    torch.cuda.empty_cache()
    print(f"  reproduction phase in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches, out


# ---------------------------------------------------------------------------
# 13. the paper's drivers
# ---------------------------------------------------------------------------

PAPER_DIR = os.path.join(REPO, "build", "chip_smoke_mode_grid")
PROTOCOL_DIR = os.path.join(REPO, "build", "chip_smoke_eval_protocol")
INTEROP_PTH = os.path.join(REPO, "build", "chip_smoke_interop.pth")
# depth cut from the paper's protocol (mode_grid.py's defaults), widths kept
PAPER_IMAGES = 1024      # the protocol: 20000 images
PAPER_LISTENER_ITERS = 4  # the protocol: 2000
PAPER_MLE_ITERS = 4      # the protocol: 20000
PAPER_JOINT_ITERS = 4    # the protocol: 6000
PAPER_EVAL_EVERY = 2     # the protocol: 500
PAPER_VAL = 128          # the protocol: 1000 val images
PAPER_MODES = ("gumbel", "reinforce")  # the two sides of the comparison
PAPER_CONDITIONS = ("frozen-greedy", "current-greedy", "current-sample",
                    "current-gt")
PAPER_CPU_VAL = 16       # val images of the card-vs-CPU frozen-greedy point
PAPER_ROWS_AGREE = 0.99
PAPER_RSUM_RTOL = 1e-6
PROTOCOL_VAL = 256       # the protocol: 5000 val images
PROTOCOL_IMAGES = PAPER_IMAGES
# --set overrides of the drivers' model dims: none on the card (the scripts'
# defaults are the reference's widths); a CPU rehearsal shrinks them here
PAPER_SET = ()
# the keys of the JAX package's eval_protocol_timing.json
PROTOCOL_KEYS = {"protocol", "weights", "platform", "setup_s",
                 "eval_first_pass_s", "eval_steady_s", "phases_steady",
                 "n_predictions", "CIDEr", "rsum"}
# language metrics of the C++ tier against the pure-Python tier: the same
# arithmetic in double precision on both sides
TIER_ATOL = 1e-9


def paper_args():
    """mode_grid's arguments for (a): full width (the script's defaults:
    vocab 9487, L=16, B=128, 512-wide, 2048-d features, K=36), depth cut."""
    return ["--images", str(PAPER_IMAGES), "--batch", str(TRAIN_B),
            "--listener-iters", str(PAPER_LISTENER_ITERS),
            "--mle-iters", str(PAPER_MLE_ITERS),
            "--joint-iters", str(PAPER_JOINT_ITERS),
            "--eval-every", str(PAPER_EVAL_EVERY),
            "--val-images-use", str(PAPER_VAL),
            "--modes", ",".join(PAPER_MODES),
            "--conditions", ",".join(PAPER_CONDITIONS),
            "--workdir", PAPER_DIR, "--device", DEVICE] + paper_dims()


def paper_dims():
    """The drivers' vocabulary, caption length and --set overrides."""
    return ["--vocab", str(VOCAB), "--seq", str(L)] + [
        x for kv in PAPER_SET for x in ("--set", kv)]


def finite(v):
    return isinstance(v, (int, float)) and bool(np.isfinite(v))


def paper_grid(out):
    """(a) mode_grid.main: the pretrain stages, -o gumbel and -o reinforce
    seeded from them, and the fixed-listener rank grid of each; then
    mode_grid_report on the JSON it wrote."""
    import shutil
    from cooperativeimagecaptioning_tpu_torch.scripts import (
        mode_grid, mode_grid_report)
    shutil.rmtree(PAPER_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        res = mode_grid.main(paper_args())
    finally:
        os.chdir(REPO)
    sync()
    out["mode_grid_s"] = time.perf_counter() - t0
    for mode in PAPER_MODES:
        traj = res["modes"][mode]["train"]["trajectory"]
        require(traj and all(finite(pt[k]) for pt in traj
                             for k in ("rsum", "CIDEr", "val_loss")),
                f"mode grid, {mode}: trajectory {traj}")
        pts = res["modes"][mode]["rank_points"]
        require({p["condition"] for p in pts} == set(PAPER_CONDITIONS)
                and all(finite(p["rsum"]) for p in pts),
                f"mode grid, {mode}: rank points {pts}")
        last = traj[-1]
        print(f"  {mode}: {len(traj)} trajectory points, last iteration "
              f"{last['iteration']}: loss {last['loss']}, val_loss "
              f"{last['val_loss']}, CIDEr {last['CIDEr']:.4f}, rsum "
              f"{last['rsum']}; {len(pts)} rank points", flush=True)
    print(f"  mode grid (pretrain {PAPER_LISTENER_ITERS} + "
          f"{PAPER_MLE_ITERS} iterations, {len(PAPER_MODES)} modes x "
          f"{PAPER_JOINT_ITERS}, the rank grid) in {out['mode_grid_s']:.1f} "
          f"s; its report:", flush=True)
    mode_grid_report.main([os.path.join(PAPER_DIR, "mode_grid.json")])
    return res


def paper_frozen_greedy(ds, device, n):
    """The frozen-greedy point of -o gumbel's last checkpoint (its speaker,
    the stage-1 listener) over the first n val images on `device`:
    (val_loss, predictions)."""
    import glob
    from cooperativeimagecaptioning_tpu_torch.config import load_infos
    from cooperativeimagecaptioning_tpu_torch.data import DataLoader
    from cooperativeimagecaptioning_tpu_torch.evaluation.eval_split import (
        Evaluator)
    from cooperativeimagecaptioning_tpu_torch.training import checkpoint as ck
    jdir = os.path.join(PAPER_DIR, "joint_gumbel")
    last = max(int(p.rsplit("-", 1)[1][:-len(".pth")]) for p in
               glob.glob(os.path.join(jdir, "alternatingModel-*.pth")))
    opt = load_infos(glob.glob(os.path.join(jdir, "infos_att_d*.pkl"))[0]
                     )["opt"].replace(device_feature_cache=0)
    params = ck.load_params(
        os.path.join(jdir, f"alternatingModel-{last}.pth"), device)
    params["listener"] = ck.load_params(os.path.join(
        PAPER_DIR, "log_fc_con", "model_vse-best.pth"), device)["listener"]
    ek = dict(vars(opt))
    ek.update(split="val", num_images=n)
    os.chdir(PAPER_DIR)  # data/synthtalk.p, eval_results/
    try:
        val_loss, preds, _ = Evaluator(opt, device=device).eval_split(
            params, DataLoader(opt, dataset=ds), ek, use_gen_sent=True)
    finally:
        os.chdir(REPO)
    return val_loss, preds, last


def paper_against_cpu(ds, out):
    """The frozen-greedy point of the last checkpoint on the card and on
    the CPU port, at PAPER_CPU_VAL val images: caption rows and rsum."""
    got, got_preds, last = paper_frozen_greedy(ds, DEVICE, PAPER_CPU_VAL)
    want, want_preds, _ = paper_frozen_greedy(ds, "cpu", PAPER_CPU_VAL)
    same = np.mean([g["caption"] == w["caption"] and
                    g["image_id"] == w["image_id"]
                    for g, w in zip(got_preds, want_preds)])
    rel = abs(got["rsum"] - want["rsum"]) / max(abs(want["rsum"]), 1e-12)
    print(f"  frozen-greedy point of alternatingModel-{last} at "
          f"{PAPER_CPU_VAL} val images, card vs CPU: {same:.2%} of caption "
          f"rows equal (>= {PAPER_ROWS_AGREE:.0%}), rsum {got['rsum']} vs "
          f"{want['rsum']} (relative {rel:.1e}, <= {PAPER_RSUM_RTOL})",
          flush=True)
    require(len(got_preds) == len(want_preds) == PAPER_CPU_VAL and
            same >= PAPER_ROWS_AGREE,
            f"frozen-greedy captions, card vs CPU: {same:.2%} equal")
    require(rel <= PAPER_RSUM_RTOL, f"frozen-greedy rsum, card "
            f"{got['rsum']} vs CPU {want['rsum']}")
    out["frozen_greedy_rows"] = float(same)


def paper_protocol(smi, out):
    """(b) time_eval_protocol.main at PROTOCOL_VAL val images, beam 2: its
    JSON holds the JAX script's keys, every value finite."""
    import shutil
    import torch
    from cooperativeimagecaptioning_tpu_torch.scripts import (
        time_eval_protocol)
    shutil.rmtree(PROTOCOL_DIR, ignore_errors=True)
    try:
        res = time_eval_protocol.main([
            "--images", str(PROTOCOL_IMAGES), "--val-images",
            str(PROTOCOL_VAL), "--beam", "2", "--batch", str(TRAIN_B),
            "--workdir", PROTOCOL_DIR, "--device", DEVICE] + paper_dims())
    finally:
        os.chdir(REPO)
    require(set(res) == PROTOCOL_KEYS, f"eval protocol keys {sorted(res)}")
    nums = [res[k] for k in ("setup_s", "eval_first_pass_s",
                             "eval_steady_s", "n_predictions", "CIDEr",
                             "rsum")]
    nums += list(res["phases_steady"].values())
    nums += [v for v in res["protocol"].values() if not isinstance(v, bool)]
    require(all(finite(v) for v in nums) and
            res["n_predictions"] == PROTOCOL_VAL and
            res["platform"] == (torch.cuda.get_device_name(0)
                                if DEVICE == "cuda" else DEVICE),
            f"eval protocol result {res}")
    out["protocol"] = res
    print(f"  eval-protocol timer, {PROTOCOL_VAL} val images, beam 2, "
          f"language metrics + generated-caption ranks ({smi}): first pass "
          f"{res['eval_first_pass_s']} s, steady {res['eval_steady_s']} s "
          f"(phases {res['phases_steady']}), setup {res['setup_s']} s",
          flush=True)


def paper_interop(out):
    """(c) -o gumbel's speaker and listener through export_state_dict ->
    save_torch_checkpoint -> load_torch_checkpoint -> convert_state_dict:
    the tree comes back bit-equal, and a B=128 greedy decode on the card
    with the converted params gives the ids of the unconverted ones."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.models.att_model import AttModel
    from cooperativeimagecaptioning_tpu_torch.ops import decoding
    from cooperativeimagecaptioning_tpu_torch.training import checkpoint as ck
    from cooperativeimagecaptioning_tpu_torch.utils import torch_interop
    from cooperativeimagecaptioning_tpu_torch.utils.tree import leaves
    params = ck.load_params(os.path.join(PAPER_DIR, "joint_gumbel",
                                         "alternatingModel.pth"), DEVICE)
    require(set(params) == {"speaker", "listener"}, f"joint tree {params}")
    sd = torch_interop.export_state_dict(params, "att2in2")
    torch_interop.save_torch_checkpoint(params, INTEROP_PTH)
    back = torch_interop.load_torch_checkpoint(INTEROP_PTH, device=DEVICE)
    again = torch_interop.convert_state_dict(sd, "att2in2", device=DEVICE)
    want = dict(leaves(params))
    for tree in (back, again):
        got = dict(leaves(tree))
        require(sorted(got) == sorted(want) and all(
            got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
            for k in want), "interop round trip: the tree changed")
    fc, att, masks = (torch.from_numpy(x).to(DEVICE)
                      for x in features(TRAIN_B, SEED + 13))
    ids = []
    for tree in (params, back):
        sp = AttModel(tree["speaker"])
        with torch.no_grad():
            ctx = sp.encode_features(fc, att, masks)
            ids.append(decoding.sample(sp, ctx, L, mode="greedy").seq.cpu())
    rows = float((ids[0] == ids[1]).all(1).float().mean())
    require(rows == 1.0, f"interop decode: {rows:.2%} of id rows equal")
    out["interop_rows"] = rows
    print(f"  interop: {len(sd)} reference keys, the round trip through "
          f"{os.path.relpath(INTEROP_PTH, REPO)} bit-equal; B={TRAIN_B} "
          f"greedy decode with the converted params: {rows:.0%} of id rows "
          f"equal", flush=True)


def paper_annotations(ds, ids, path, first=0):
    """A COCO annotation file of the references of `ids` from the `first`
    on (SyntheticDataset image ids are their indices)."""
    anns = []
    for i in ids:
        for row in ds.get_refs(i)[first:]:
            anns.append({"image_id": i, "id": len(anns), "caption": " ".join(
                ds.ix_to_word[str(int(t))] for t in row if t > 0)})
    with open(path, "w") as f:
        json.dump({"annotations": anns, "images": [{"id": i} for i in ids]},
                  f)


def paper_host_tier(ds, smi, out):
    """(d) the C++ host tier is built on the card's host, and
    language_eval(include_spice=True) gives the same scores from it as from
    the pure-Python tier, on -o gumbel's last val predictions (PAPER_VAL
    images) and on the eval-protocol timer's (PROTOCOL_VAL); both tiers'
    host seconds.  The captions of four joint iterations and of random
    weights score near 0, so the tiers are also held on each image's first
    reference as its hypothesis against its other four (the derived
    captions of an image share most of their words: every metric moves
    off 0)."""
    from cooperativeimagecaptioning_tpu_torch.config import load_infos
    from cooperativeimagecaptioning_tpu_torch.evaluation.language_eval import (
        language_eval)
    from cooperativeimagecaptioning_tpu_torch.native import bindings
    require(bindings.available(), "the C++ host tier did not build on the "
            f"card's host:\n{bindings.build_log()}")
    hist = load_infos(os.path.join(PAPER_DIR, "joint_gumbel",
                                   "histories_att_d0.3.pkl"))
    vrh = hist["val_result_history"]
    with open(os.path.join(PROTOCOL_DIR, "eval_results",
                           "evalproto_val_nofilt.json")) as f:
        protocol_preds = json.load(f)
    grid_preds = vrh[max(vrh)]["predictions"]
    ids = [p["image_id"] for p in grid_preds]
    own = [{"image_id": i, "caption": " ".join(
        ds.ix_to_word[str(int(t))] for t in ds.get_refs(i)[0] if t > 0)}
        for i in ids]
    out["tiers"] = {}
    for what, preds, first in (("mode grid", grid_preds, 0),
                               ("eval protocol", protocol_preds, 0),
                               ("a reference against the others", own, 1)):
        n = len(preds)
        preds = [{"image_id": p["image_id"], "caption": p["caption"]}
                 for p in preds]
        require(n == (PROTOCOL_VAL if what == "eval protocol" else
                      PAPER_VAL), f"{what}: {n} predictions")
        ann = os.path.join(REPO, "build", f"chip_smoke_refs_{n}_{first}.json")
        paper_annotations(ds, [p["image_id"] for p in preds], ann, first)
        scores, seconds = {}, {}
        native = bindings.available
        for tier in ("native", "python"):
            if tier == "python":
                bindings.available = lambda: False
            try:
                t0 = time.perf_counter()
                scores[tier] = language_eval(
                    "synthetic", [dict(p) for p in preds], "tiers",
                    "val", ann_file=ann,
                    out_dir=os.path.join(REPO, "build",
                                         "chip_smoke_tiers"),
                    include_spice=True)
                seconds[tier] = time.perf_counter() - t0
            finally:
                bindings.available = native
        a, b = scores["native"], scores["python"]
        require(set(a) == set(b) and "SPICE" in a and all(
            abs(a[k] - b[k]) <= TIER_ATOL for k in a),
            f"language metrics, C++ vs Python tier, {what}: {a} vs {b}")
        out["tiers"][what] = seconds
        print(f"  language metrics with SPICE, {what}, {n} val images: C++ tier "
              f"{seconds['native']:.3f} s, pure Python {seconds['python']:.3f}"
              f" s of host time ({smi}), equal within {TIER_ATOL}: "
              + ", ".join(f"{k} {a[k]:.4f}" for k in
                          ("Bleu_4", "METEOR", "ROUGE_L", "CIDEr", "SPICE")),
              flush=True)


def phase_paper_drivers(smi):
    """13. The paper's experiment drivers at full width, depth cut (each
    cut printed): (a) the mode grid, (b) the eval-protocol timer, (c)
    reference-checkpoint interop, (d) the C++ host tier.  The cell kernel
    runs beside A, B and C.  Returns the launch counts of the phase."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.scripts import (
        showcase_full_scale)
    t_phase = time.perf_counter()
    print(f"phase 13, the paper's drivers at full width (vocab {VOCAB}, "
          f"{WIDTH}-wide, {FEAT}-d features, K={K}, L={L}, B={TRAIN_B}, f32),"
          f" depth cut: {PAPER_IMAGES} images (the protocol: 20000), "
          f"{PAPER_LISTENER_ITERS} / {PAPER_MLE_ITERS} / {PAPER_JOINT_ITERS} "
          f"listener / MLE / joint iterations (2000 / 20000 / 6000), an "
          f"evaluation every {PAPER_EVAL_EVERY} (500) on {PAPER_VAL} val "
          f"images (1000), modes {', '.join(PAPER_MODES)} (of five); the "
          f"eval protocol at {PROTOCOL_VAL} val images (5000)", flush=True)
    out = {}
    _dispatch.reset_launches()
    paper_grid(out)
    sync()
    ds = showcase_full_scale.build_dataset(
        PAPER_IMAGES, VOCAB, L,
        showcase_full_scale.protocol_dims(list(PAPER_SET))[0])
    paper_against_cpu(ds, out)
    paper_protocol(smi, out)
    paper_interop(out)
    sync()
    launches = launch_counts()
    for k in ("attention", "greedy_head", "beam_head", "cell"):
        require(launches[k] > 0, f"paper drivers: {k} never launched "
                f"({launches})")
    require_head_pass("the paper's drivers", "tf32x3")
    paper_host_tier(ds, smi, out)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  launches {launches}", flush=True)
    print(f"  paper drivers phase in {out['seconds']:.1f} s", flush=True)
    return launches, out


# ---------------------------------------------------------------------------
# 14. the orbax tier: .orbax run dirs without orbax, the profiling endpoint
# ---------------------------------------------------------------------------

ORBAX_RUN_DIR = os.path.join(REPO, "build", "chip_smoke_orbax_run")
ORBAX_TWIN_DIR = os.path.join(REPO, "build", "chip_smoke_orbax_twin")
ORBAX_RESUMED_DIR = os.path.join(REPO, "build", "chip_smoke_orbax_resumed")
ORBAX_PROFILE_DIR = os.path.join(REPO, "build", "chip_smoke_orbax_profile")
JAX_ORBAX_FIXTURE = os.path.join(REPO, "tests", "data", "jax_orbax_run")
ORBAX_ITERS = 2       # phase-2 iterations before checkpoint_operations
ORBAX_SAVES = 3       # timed saves of the trained tree
ORBAX_SERVE_B = 128   # images of the served request
ORBAX_CAPTURE_MS = 400


def orbax_opt(run_dir, backend, **kw):
    """Phase-2 options at reference width (`train_opt`) under a checkpoint
    backend, checkpointing only when asked."""
    opt = train_opt(TRAIN_B)
    return opt.replace(checkpoint_backend=backend, checkpoint_path=run_dir,
                       language_eval=0, **kw)


def orbax_train(ds, run_dir, backend):
    """ORBAX_ITERS iterations through loop.train, then checkpoint_operations
    into a fresh `run_dir` -> (trainer, the launches of the iterations)."""
    import shutil
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.training import loop
    shutil.rmtree(run_dir, ignore_errors=True)
    _dispatch.reset_launches()
    tr = loop.train(orbax_opt(run_dir, backend), dataset=ds,
                    max_iterations=ORBAX_ITERS, device=DEVICE, verbose=False)
    sync()
    launches = launch_counts()
    tr.checkpoint_operations()
    tr.ckpt.sync()
    return tr, launches


def orbax_states_equal(a, b):
    """Whether two Trainers hold bit-equal params and Adam states."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.utils.tree import leaves
    if [k for k, _ in leaves(a.params)] != [k for k, _ in leaves(b.params)]:
        return False
    same = all(torch.equal(x, y) for (_, x), (_, y) in
               zip(leaves(a.params), leaves(b.params)))
    for agent, st in a.optim.states.items():
        other = b.optim.states[agent]
        same &= torch.equal(st["count"], other["count"])
        for key in ("mu", "nu"):
            same &= all(torch.equal(x, y)
                        for x, y in zip(st[key], other[key]))
    return bool(same)


def orbax_training(ds, add, out):
    """(a) phase-2 training under the orbax backend: the JAX package's
    names, a save's blocking and writing times, a bit-equal resume whose
    next iteration's loss is the uninterrupted run's."""
    from cooperativeimagecaptioning_tpu_torch.training import loop
    t0 = time.perf_counter()
    tr, launches = orbax_train(ds, ORBAX_RUN_DIR, "orbax")
    add(launches)
    T = L + 1
    for k in ("attention", "cell"):
        require(launches[k] == ORBAX_ITERS * 2 * T,
                f"orbax training: {k} launched {launches[k]} times")
    names = sorted(os.listdir(ORBAX_RUN_DIR))
    it = tr.iteration
    for name in ("model.orbax", f"model-{it}.orbax", "model-best.orbax",
                 "optimizer.pth", "infos_.pkl", "histories_.pkl"):
        require(name in names, f"orbax run dir: {name} not in {names}")
    require(not any(n.endswith(".pth") and n.startswith("model")
                    or n.startswith(".") for n in names),
            f"orbax run dir holds a .pth model or a temporary: {names}")
    print(f"  orbax backend: {ORBAX_ITERS} iterations and "
          f"checkpoint_operations in {time.perf_counter() - t0:.1f} s; "
          f"wrote {names}", flush=True)
    blocking, writing = [], []
    for _ in range(ORBAX_SAVES):
        t1 = time.perf_counter()
        tr.ckpt.save_best(tr.params)
        blocking.append((time.perf_counter() - t1) * 1e3)
        tr.ckpt.sync()
        writing.append(tr.ckpt.writer.write_ms)
    out["save_blocking_ms"], out["save_writer_ms"] = blocking, writing
    print(f"  a save of the {param_mib(tr.params):.1f} MiB tree: the "
          f"caller blocked {', '.join(f'{x:.2f}' for x in blocking)} ms, "
          f"the writer took {', '.join(f'{x:.1f}' for x in writing)} ms",
          flush=True)
    t1 = time.perf_counter()
    again = loop.Trainer(orbax_opt(ORBAX_RESUMED_DIR, "orbax",
                                   start_from=ORBAX_RUN_DIR), dataset=ds,
                         device=DEVICE, verbose=False)
    resume_s = time.perf_counter() - t1
    require(again.iteration == tr.iteration,
            f"orbax resume: iteration {again.iteration}, {tr.iteration}")
    require(orbax_states_equal(tr, again),
            "orbax resume: params or Adam state differ from the saved ones")
    print(f"  resumed in {resume_s:.2f} s: iteration {again.iteration}, "
          f"params and Adam state bit-equal", flush=True)
    out["resume_s"] = resume_s
    return tr, again


def orbax_next_step(tr, again):
    """The resumed Trainer's next iteration: the uninterrupted run's
    loss, on the same batch."""
    data = tr.loader.get_batch("train")
    a = tr.train_iteration(data)[0]["loss"].item()
    b = again.train_iteration(data)[0]["loss"].item()
    print(f"  the next iteration's loss after the resume {b!r} "
          f"(uninterrupted {a!r})", flush=True)
    require(a == b, f"orbax resume: next loss {b} vs {a}")


def param_mib(params):
    from cooperativeimagecaptioning_tpu_torch.utils.tree import leaves
    return sum(x.numel() * x.element_size()
               for _, x in leaves(params)) / 2 ** 20


def orbax_twin(ds, add, trained):
    """The `.pth` twin: a run from the same seed under the pth backend
    (bit-equal to the orbax run's state or not, printed)."""
    twin, launches = orbax_train(ds, ORBAX_TWIN_DIR, "pth")
    add(launches)
    bitwise = orbax_states_equal(trained, twin)
    print(f"  the .pth twin (same seed, pth backend): params and Adam "
          f"state bit-equal to the orbax run: {bitwise}", flush=True)


def orbax_eval(ds, add, out):
    """(b) eval.eval of the orbax run dir at beam 2: the twin's ids."""
    from cooperativeimagecaptioning_tpu_torch import eval as ev
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    got = {}
    for key, d in (("orbax", ORBAX_RUN_DIR), ("pth", ORBAX_TWIN_DIR)):
        _dispatch.reset_launches()
        t0 = time.perf_counter()
        got[key] = ev.eval(None, os.path.join(d, "model-best.pth"),
                           os.path.join(d, "infos_.pkl"), split="test",
                           dataset=ds, device=DEVICE)
        sync()
        launches = launch_counts()
        add(launches)
        print(f"  eval.eval of the {key} run dir, beam 2: "
              f"{len(got[key]['split_predictions'])} images in "
              f"{time.perf_counter() - t0:.1f} s; launches {launches}",
              flush=True)
        for k in ("attention", "beam_head", "cell"):
            require(launches[k] > 0, f"eval.eval of the {key} run dir: {k} "
                    f"never launched")
    caps = [[p["caption"] for p in got[k]["split_predictions"]]
            for k in ("orbax", "pth")]
    require(caps[0] == caps[1], "eval.eval: the orbax run dir's captions "
            "differ from its .pth twin's")
    require(got["orbax"]["loss"] == got["pth"]["loss"],
            f"eval.eval: loss {got['orbax']['loss']} of the orbax run dir, "
            f"{got['pth']['loss']} of its .pth twin")
    print(f"  eval.eval: captions and loss {got['orbax']['loss']} equal to "
          f"the .pth twin's", flush=True)
    out["eval_images"] = len(caps[0])


def orbax_serve(add, out):
    """(c) CaptioningService.from_run_dir of the orbax run dir: the twin's
    captions; returns the service for (e)."""
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.serving import CaptioningService
    fc, att, masks = features(ORBAX_SERVE_B, seed=1414)
    ids = {}
    for key, d in (("orbax", ORBAX_RUN_DIR), ("pth", ORBAX_TWIN_DIR)):
        svc = CaptioningService.from_run_dir(
            d, compute_dtype="float32", buckets=(ORBAX_SERVE_B,),
            device=DEVICE)
        svc.caption_ids(fc[:1], att[:1], masks[:1])
        _dispatch.reset_launches()
        ids[key] = svc.caption_ids(fc, att, masks)
        sync()
        launches = launch_counts()
        add(launches)
        for k in ("attention", "greedy_head", "cell"):
            require(launches[k] == L, f"serving the {key} run dir: {k} "
                    f"launched {launches[k]} times, expected {L}")
        if key == "orbax":
            served = svc
    require(np.array_equal(ids["orbax"], ids["pth"]),
            "serving: the orbax run dir's ids differ from its .pth twin's")
    print(f"  from_run_dir of the orbax run dir: {ORBAX_SERVE_B} images, "
          f"ids equal to the .pth twin's ({len(np.unique(ids['orbax']))} "
          f"distinct ids)", flush=True)
    out["served_images"] = ORBAX_SERVE_B
    return served


def orbax_jax_fixture(out):
    """(d) the run dir the JAX package wrote (tests/data/jax_orbax_run, by
    tests/data/make_jax_orbax_fixture.py): every leaf equal to its .npz."""
    from cooperativeimagecaptioning_tpu_torch.native import zstd
    from cooperativeimagecaptioning_tpu_torch.training import checkpoint
    from cooperativeimagecaptioning_tpu_torch.utils.tree import leaves
    require(zstd.available(), "libzstd not found on this host")
    t0 = time.perf_counter()
    got = dict(leaves(checkpoint.load_params(
        os.path.join(JAX_ORBAX_FIXTURE, "model-best.pth"))))
    secs = time.perf_counter() - t0
    want = np.load(os.path.join(JAX_ORBAX_FIXTURE, "expected.npz"))
    require(sorted(got) == sorted(want.files),
            f"JAX fixture: leaves {sorted(got)} vs {sorted(want.files)}")
    for k in want.files:
        require(np.array_equal(got[k].numpy(), want[k]) and
                got[k].numpy().dtype == want[k].dtype,
                f"JAX fixture: leaf {k} differs")
    print(f"  the JAX package's .orbax (OCDBT, zstd via "
          f"{zstd.library()._name}): {len(want.files)} leaves equal to its "
          f".npz, read in {secs * 1e3:.1f} ms", flush=True)
    out["fixture_leaves"] = len(want.files)


def orbax_capture(svc, add, out):
    """(e) the profiling endpoint: a capture over a greedy decode that the
    main thread runs; the trace holds A's, B's and F's kernels."""
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.utils import profiling
    import shutil
    shutil.rmtree(ORBAX_PROFILE_DIR, ignore_errors=True)
    fc, att, masks = features(ORBAX_SERVE_B, seed=1415)
    server = profiling.start_server(0)
    reply = {}

    def client():
        url = (f"http://127.0.0.1:{server.port}/capture?duration_ms="
               f"{ORBAX_CAPTURE_MS}&log_dir={ORBAX_PROFILE_DIR}")
        with urllib.request.urlopen(url, timeout=600) as r:
            reply.update(json.loads(r.read()))

    _dispatch.reset_launches()
    thread = threading.Thread(target=client)
    thread.start()
    decodes = 0
    try:
        while thread.is_alive():
            svc.caption_ids(fc, att, masks)
            sync()
            decodes += 1
    finally:
        thread.join()
        server.stop()
    add(launch_counts())
    require("path" in reply, f"profiling endpoint: {reply}")
    with open(reply["path"]) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    found = {"attention": [n for n in kernels if "attention_kernel" in n],
             "greedy_head": [n for n in kernels if "vocab_partials" in n
                             or "greedy_merge" in n],
             "cell": [n for n in kernels if "cell_" in n and "kernel" in n]}
    host = {e.get("name") for e in events if e.get("cat") in
            ("cpu_op", "user_annotation")}
    print(f"  profiling endpoint: {decodes} greedy decodes during a "
          f"{ORBAX_CAPTURE_MS} ms capture: {reply['path']} "
          f"({os.path.getsize(reply['path']) / 1e6:.1f} MB; all threads "
          f"{reply['all_threads']}); {len(kernels)} kernel names, "
          + ", ".join(f"{k} {len(v)}" for k, v in found.items())
          + f"; {len(host)} host op names", flush=True)
    for k, names in found.items():
        require(names, f"profiling endpoint: no {k} kernel in the trace "
                f"({sorted(kernels)[:20]})")
    out["capture_decodes"] = decodes


def phase_orbax(smi):
    """14. The orbax tier at reference width: (a) training under the orbax
    backend and a bit-equal resume, (b) eval.eval and (c) the service on
    that run dir against its .pth twin, (d) the JAX package's committed
    .orbax run dir, (e) a capture through the profiling endpoint.  Returns
    the launch counts of the phase."""
    import torch
    t_phase = time.perf_counter()
    print(f"phase 14, the orbax tier at full width (vocab {VOCAB}, "
          f"{WIDTH}-wide, {FEAT}-d features, K={K}, L={L}, B={TRAIN_B}, f32; "
          f"{smi})", flush=True)
    out = {}
    total = {k: 0 for k in counted()}

    def add(launches):
        for k in total:
            total[k] += launches.get(k, 0)

    ds = train_dataset()
    trained, resumed = orbax_training(ds, add, out)
    orbax_twin(ds, add, trained)
    orbax_next_step(trained, resumed)
    orbax_eval(ds, add, out)
    svc = orbax_serve(add, out)
    orbax_jax_fixture(out)
    orbax_capture(svc, add, out)
    require_head_pass("the orbax tier", "tf32x3")
    for k in ("attention", "greedy_head", "beam_head", "cell"):
        require(total[k] > 0, f"orbax tier: {k} never launched ({total})")
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  launches {total}", flush=True)
    print(f"  orbax tier phase in {out['seconds']:.1f} s", flush=True)
    return total, out


def main():
    smi = phase_device()
    sys.path.insert(0, REPO)
    import torch
    t_start = time.perf_counter()
    phase_build()
    errs, times, bounds, shapes = phase_kernels()
    print(f"elapsed after the kernel checks: "
          f"{time.perf_counter() - t_start:.0f} s", flush=True)
    serve_launches = phase_slice(smi)
    print(f"elapsed after serving: {time.perf_counter() - t_start:.0f} s",
          flush=True)
    train_launches, phase5 = phase_train(smi)
    print(f"elapsed after training: {time.perf_counter() - t_start:.0f} s",
          flush=True)
    eval_launches = phase_eval(smi)
    print(f"elapsed after evaluation: {time.perf_counter() - t_start:.0f} s",
          flush=True)
    scst_launches, scst_out = phase_scst(smi, phase5)
    print(f"elapsed after self-critical training: "
          f"{time.perf_counter() - t_start:.0f} s", flush=True)
    listener_launches, listener_out = phase_listener(smi)
    print(f"elapsed after the listener: "
          f"{time.perf_counter() - t_start:.0f} s", flush=True)
    mesh_launches, _ = phase_mesh(smi, errs, times, bounds, shapes)
    print(f"elapsed after the mesh: {time.perf_counter() - t_start:.0f} s",
          flush=True)
    reinforce_launches, _ = phase_reinforce(smi)
    print(f"elapsed after joint REINFORCE: "
          f"{time.perf_counter() - t_start:.0f} s", flush=True)
    device_launches, _ = phase_device_rewards(smi, scst_out, listener_out)
    print(f"elapsed after the device rewards and fused chunks: "
          f"{time.perf_counter() - t_start:.0f} s", flush=True)
    repro_launches, _ = phase_reproduction(smi)
    print(f"elapsed after the reproduction chain: "
          f"{time.perf_counter() - t_start:.0f} s", flush=True)
    paper_launches, _ = phase_paper_drivers(smi)
    print(f"elapsed after the paper's drivers: "
          f"{time.perf_counter() - t_start:.0f} s", flush=True)
    orbax_launches, _ = phase_orbax(smi)
    print(f"elapsed after the orbax tier: "
          f"{time.perf_counter() - t_start:.0f} s", flush=True)
    # each path's counts run from 0 just before it to just after it
    paths = {"serve": serve_launches, "train": train_launches,
             "eval": eval_launches, "scst": scst_launches,
             "listener": listener_launches, "mesh": mesh_launches,
             "joint_reinforce": reinforce_launches,
             "device_rewards": device_launches,
             "extracted_features": repro_launches["extracted"],
             "harvest": repro_launches["harvest"],
             "paper_drivers": paper_launches,
             "orbax_tier": orbax_launches}
    kernels = []
    for k in SOURCES:
        by_path = {path: counts[k] for path, counts in paths.items()}
        require(sum(by_path.values()) > 0,
                f"{k} was never launched on a main path")
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCES[k],
            "replaces": REPLACES[k], "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": errs[k],
            "ms": times[k][0], "plain_ms": times[k][1],
            "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
            # no single PyTorch call computes any of these functions
            "library_ms": None,
            # every shape the kernel was timed at, each with its own bound
            "timed_shapes": shapes[k]})
    # the cell's launches by kernel: split TF32 (f32), mma.sync (bf16), FMAs
    cell = next(e for e in kernels if e["name"] == "cell")
    cell["launches_by_pass"] = {
        p: sum(counts[p] for counts in paths.values())
        for p in ("cell_tf32x3", "cell_mma", "cell_fma")}
    require(sum(cell["launches_by_pass"].values()) == cell["launches"]
            and cell["launches_by_pass"]["cell_tf32x3"] > 0,
            f"cell launches by kernel {cell['launches_by_pass']} of "
            f"{cell['launches']}")
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
