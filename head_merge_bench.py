#!/usr/bin/env python3
"""The vocabulary-sharded heads' merge (head_merge) on one Hopper GPU, and
the sharded head calls and (1, 2) mesh runs around it, for comparing two
checkouts on one card.

    python3 head_merge_bench.py                     # this checkout
    python3 head_merge_bench.py --root build/parent # another checkout
    python3 head_merge_bench.py --turns build/parent  # both, in turns
    python3 head_merge_bench.py --parts merge,heads  # some parts only

--root DIR runs the package and the chip_smoke.py of the checkout at DIR
(its own kernels, built into DIR/build/kernels at first use), e.g. a parent
commit unpacked there with `git archive`; --turns DIR builds both
libraries at once, then runs DIR, this, this, DIR, each side in a process
of its own, and prints the sides' numbers together.  The parts:

merge  -- device ms a call (chip_smoke.cuda_ms: events around 20 calls
          queued behind busy products) at MERGE_TIMED, f32 records of n=2
          shards of the 9488-wide logit layer: the merge as the side's
          callers run it after their gathers (this package: head_merge on
          the gathered records in the mode; a package without records:
          head_merge on the [R, n*m] candidates and [n, R] logsumexps, then
          greedy_head_sharded's vals[:, 0] - lse in the greedy mode and
          vocab.argmax's slicing, casts and transposed maxima in the argmax
          mode); beside it the floor, an empty kernel launched as
          head_merge launches the merge (head_merge_floor; a side without
          it has none), and the bound (records read, outputs written once
          over 3.35 TB/s).
heads  -- a (1, 2) world of two gloo ranks sharing the card (the port's
          launcher): host ms a call of the sharded heads G (beam_head at
          R=2 x 128, kk=2) and H (greedy_head at R=128) and of a
          categorical draw over the slices (vocab.argmax at R=128), f32,
          H=512, V+1=9488 (the median of 7 loops of 20 calls, each loop
          ended by a synchronize); a call's collectives
          (collectives.Recording) and launches (_dispatch counts).
eval   -- in the same world: the (1, 2) Evaluator (random weights from
          chip_smoke.SEED, f32, the 256 val images of chip_smoke's mesh
          evaluation set), images/s of beam 2 and of greedy after a
          warm-up batch.
fused  -- in the same world: chip_smoke.mesh_fused_pair of the (1, 2) -o
          gumbel run with the device reward (a chunk of
          MESH_FUSED_SPLIT_K): segments and collectives a replay, it/s a
          rank per step and fused, in turns.
Prints one JSON object as its last line; the card's name and power limit
beside every side.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PARTS = ("merge", "heads", "eval", "fused")
# (rows, m, mode): chip_smoke.py's MERGE_TIMED, kept here so that a parent
# checkout is timed at the same shapes
MERGE_TIMED = ((256, 2, "beam"), (128, 1, "greedy"), (128, 1, "argmax"),
               (640, 5, "beam"), (256, 32, "beam"))
SHARDS = 2
HBM_BYTES_PER_S = 3.35e12
HOST_LOOPS, HOST_CALLS = 7, 20


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip()


def merge_calls(recs, vl, m, mode):
    """(the merge as the side's callers run it, its floor or None) on
    gathered records [n, R, W]."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import head_merge
    if hasattr(head_merge, "records"):
        return (lambda: head_merge.head_merge(recs, vl, m, mode),
                lambda: head_merge.head_merge_floor(recs, vl, m, mode))
    n, R, _ = recs.shape
    if mode == "argmax":
        # vocab.argmax's gathered [R, 2n] pairs (value, float id)
        got = torch.stack([recs[..., 0], recs[..., 1].view(torch.int32)
                           .float()], dim=2).permute(1, 0, 2).reshape(
                               R, 2 * n).contiguous()

        def draw():
            vals = got[:, 0::2].contiguous()
            idx = got[:, 1::2].to(torch.int32).contiguous()
            _, top, _ = head_merge.head_merge(vals, idx, vals.T.contiguous(),
                                              vl, 1)
            return top[:, 0].long()
        return draw, None
    vals = recs[..., :m].permute(1, 0, 2).reshape(R, n * m).contiguous()
    idx = recs[..., m:2 * m].view(torch.int32).permute(1, 0, 2).reshape(
        R, n * m).contiguous()
    lse = recs[..., 2 * m].contiguous()
    if mode == "greedy":
        def greedy():
            v, i, tot = head_merge.head_merge(vals, idx, lse, vl, 1)
            return i[:, 0], v[:, 0] - tot
        return greedy, None
    return lambda: head_merge.head_merge(vals, idx, lse, vl, m), None


def time_merge(cs):
    import torch
    g = torch.Generator(device="cpu").manual_seed(cs.SEED + 7)
    vl = (cs.VOCAB + 1) // SHARDS
    out = []
    for rows, m, mode in MERGE_TIMED:
        width = 2 if mode == "argmax" else 2 * m + 1
        recs = torch.randn(SHARDS, rows, width, generator=g)
        recs[..., m:2 * m].view(torch.int32).copy_(torch.randint(
            0, vl, (SHARDS, rows, m), generator=g, dtype=torch.int32))
        recs = recs.cuda()
        call, floor = merge_calls(recs, vl, m, mode)
        call()
        torch.cuda.synchronize()
        ms = [cs.cuda_ms(call, 20) for _ in range(2)]
        fl = [cs.cuda_ms(floor, 20) for _ in range(2)] if floor else []
        outs = {"beam": rows * (2 * m + 1) * 4, "greedy": rows * 8,
                "argmax": rows * 8}[mode]
        bound = (recs.numel() * 4 + outs) / HBM_BYTES_PER_S * 1e3
        r = {"rows": rows, "m": m, "mode": mode, "ms": sum(ms) / 2,
             "ms_each": ms, "floor_ms": sum(fl) / 2 if fl else None,
             "bound_ms": bound}
        out.append(r)
        fl_txt = (f"floor {r['floor_ms']:.4f} ms "
                  f"({r['ms'] / r['floor_ms']:.2f}x)" if fl else "no floor")
        print(f"  merge R={rows:<4d} n={SHARDS} m={m:<2d} {mode:6s} "
              f"{r['ms']:.4f} ms ({ms[0]:.4f}, {ms[1]:.4f})  {fl_txt}  "
              f"bound {bound:.7f} ms", flush=True)
    return out


def host_ms(cs, fn):
    """A call of fn() on the host's clock: the median of HOST_LOOPS loops of
    HOST_CALLS calls, each loop ended by a synchronize."""
    fn()
    loops = []
    for _ in range(HOST_LOOPS):
        cs.sync()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        cs.sync()
        loops.append((time.perf_counter() - t0) * 1e3 / HOST_CALLS)
    return sorted(loops)[HOST_LOOPS // 2]


def time_heads(cs, mesh):
    """Rank part `heads`: each sharded call's host ms, collectives and
    launches."""
    import torch
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import (
        _dispatch, beam_head, logit_head)
    from cooperativeimagecaptioning_tpu_torch.parallel import (
        collectives, vocab)
    g = torch.Generator(device="cpu").manual_seed(cs.SEED + 9)
    V1 = cs.VOCAB + 1
    vl = V1 // SHARDS
    j = mesh.model_index
    w = torch.randn(cs.WIDTH, V1, generator=g) * 0.1
    b = torch.randn(V1, generator=g) * 0.1
    wl = w[:, j * vl:(j + 1) * vl].contiguous().to(cs.DEVICE)
    bl = b[j * vl:(j + 1) * vl].contiguous().to(cs.DEVICE)
    h256 = (torch.randn(256, cs.WIDTH, generator=g) * 0.5).to(cs.DEVICE)
    h128 = h256[:128].contiguous()
    x = (h128 @ wl + bl).contiguous()
    calls = {"G beam_head R=256 kk=2": lambda: beam_head.beam_head(
                 h256, wl, bl, 2),
             "H greedy_head R=128": lambda: logit_head.greedy_head(
                 h128, wl, bl),
             "draw vocab.argmax R=128": lambda: vocab.argmax(x)}
    out = {}
    for name, fn in calls.items():
        fn()
        cs.sync()
        _dispatch.reset_launches()
        with collectives.planned(collectives.Recording()) as rec:
            fn()
        cs.sync()
        la = {k: v for k, v in _dispatch.launches().items() if v}
        out[name] = {"host_ms": host_ms(cs, fn), "collectives": len(rec.ops),
                     "ops": [list(op[:1]) + [list(op[2])] for op in rec.ops],
                     "launches": la}
    return out


def eval_rates(cs, ds):
    """Rank part `eval`: images/s of the (1, 2) Evaluator, beam 2 and
    greedy."""
    from cooperativeimagecaptioning_tpu_torch.training.loop import Trainer
    opt = cs.train_opt(cs.TRAIN_B)
    opt.mesh_data_axis, opt.mesh_model_axis = 1, SHARDS
    opt.checkpoint_path = os.path.join(cs.REPO, "build", "merge_bench_eval")
    tr = Trainer(opt, dataset=ds, device=cs.DEVICE, verbose=False)
    ev = tr.evaluator()
    n_val = sum(1 for im in ds.info["images"] if im["split"] == "val")
    out = {}
    for beam in (2, 1):
        base = {"split": "val", "beam_size": beam, "language_eval": 0}
        ev.eval_split(tr.params, tr.loader, dict(base, num_images=cs.EVAL_B))
        cs.sync()
        t0 = time.perf_counter()
        ev.eval_split(tr.params, tr.loader, dict(base, num_images=-1))
        cs.sync()
        out[f"beam {beam}"] = n_val / (time.perf_counter() - t0)
    tr.close()
    return out


def rank(root, parts, cfg):
    """One rank of the (1, 2) world: the parts that need it (chip_smoke's
    globals as the side's process has them, `cfg`)."""
    sys.path.insert(0, root)
    import chip_smoke as cs
    import torch
    cs.__dict__.update(cfg)
    from cooperativeimagecaptioning_tpu_torch.ops.kernels import _dispatch
    from cooperativeimagecaptioning_tpu_torch.parallel import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    mesh = make_mesh(1, SHARDS, cs.DEVICE)
    if "heads" in parts:
        _dispatch.set_vocab_mesh(mesh, cs.VOCAB)
        out["heads"] = time_heads(cs, mesh)
        _dispatch.set_vocab_mesh(None)
    if "eval" in parts:
        out["eval"] = eval_rates(cs, cs.mesh_eval_dataset())
    if "fused" in parts:
        name, make, axes, k = cs.mesh_fused_opts()[2]
        got = cs.mesh_fused_pair(make, axes, k)
        out["fused"] = {"what": f"{axes} {name}, chunk of {k}",
                        "segments": got["segments"],
                        "collectives": got["collectives"],
                        "its": got["its"], "rates": got["rates"],
                        "loss_rel": max(
                            abs(got["losses"][1][i] - got["losses"][0][i])
                            / abs(got["losses"][0][i])
                            for i in got["losses"][0]),
                        "per_replay": got["per_replay"]}
    return out


def side(root, parts):
    """This process's side: the package and chip_smoke.py at `root`."""
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("head_merge_bench: no CUDA device", file=sys.stderr)
        sys.exit(1)
    import chip_smoke as cs
    from cooperativeimagecaptioning_tpu_torch.parallel import launch
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()
    print(f"card: {smi}; package of {root}", flush=True)
    result = {"card": smi, "root": root}
    if "merge" in parts:
        result["merge"] = time_merge(cs)
    world = [p for p in parts if p != "merge"]
    if world:
        t0 = time.perf_counter()
        got = launch.spawn(rank, (root, world, cs.mesh_cfg()), SHARDS,
                           cs.DEVICE)
        result["world_s"] = time.perf_counter() - t0
        result.update(got[0])
        for name, r in got[0].get("heads", {}).items():
            print(f"  {name}: host {r['host_ms']:.4f} ms a call, "
                  f"collectives {r['collectives']} {r['ops']}, launches "
                  f"{r['launches']}", flush=True)
        for name, rate in got[0].get("eval", {}).items():
            print(f"  (1, 2) evaluation {name}: {rate:.2f} images/s a rank",
                  flush=True)
        if "fused" in got[0]:
            f = got[0]["fused"]
            print(f"  {f['what']}: segments {f['segments']}, collectives "
                  f"{f['collectives']} a replay; it/s a rank {f['its']} "
                  f"(per step: 1, fused: the chunk; in turns {f['rates']});"
                  f" losses within {f['loss_rel']:.1e} relative", flush=True)
    print(json.dumps(result))


def build(root):
    """Build the kernels of the checkout at `root` (a process of its own)."""
    return subprocess.Popen(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, '.'); from cooperativeimagecaptioning"
         "_tpu_torch.ops.kernels import _build; print(_build.build()"
         "['seconds'])"], cwd=root)


def turns(other, parts):
    """The other checkout and this one in turns: other, this, this, other;
    each side a process of its own."""
    t0 = time.perf_counter()
    procs = [build(r) for r in (other, HERE)]
    if any(p.wait() != 0 for p in procs):
        raise SystemExit("head_merge_bench: a build failed")
    print(f"both libraries built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    runs = []
    for root in (other, HERE, HERE, other):
        got = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--root", root,
             "--parts", ",".join(parts)], cwd=root, capture_output=True,
            text=True)
        sys.stdout.write(got.stdout)
        if got.returncode != 0:
            sys.stderr.write(got.stderr[-8000:])
            raise SystemExit(f"head_merge_bench: the side at {root} failed")
        runs.append(json.loads(got.stdout.strip().splitlines()[-1]))
    print(json.dumps({"turns": [("other" if r["root"] == other else "this")
                                for r in runs], "runs": runs}))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=HERE,
                   help="the checkout whose package is timed")
    p.add_argument("--turns", default="", metavar="DIR",
                   help="time DIR's checkout and this one in turns")
    p.add_argument("--parts", default=",".join(PARTS),
                   help=f"comma-separated, of {', '.join(PARTS)}")
    a = p.parse_args(argv)
    parts = [x for x in a.parts.split(",") if x]
    if set(parts) - set(PARTS):
        p.error(f"unknown parts {sorted(set(parts) - set(PARTS))}")
    if a.turns:
        turns(os.path.abspath(a.turns), parts)
    else:
        side(os.path.abspath(a.root), parts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
