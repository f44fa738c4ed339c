"""Render the mode-grid EVIDENCE table from mode_grid.json (the port's own
copy of the JAX package's scripts/mode_grid_report.py; it prints the same
table, character for character).

For each optimization mode, reports the trajectory endpoints of the four
claim axes (seed -> last checkpoint):
  sampled CIDEr        language metrics of the sampled policy
                       (current-sample / frozen-sample points; CIDEr is
                       listener-independent, so either condition carries it)
  pair rsum            current listener x sampled captions (current-sample)
  greedy rank rsum     the reference's in-training protocol metric
                       (current-greedy)
  GT rsum              current listener on ground-truth captions
                       (current-gt; the listener-drift control)

Usage: python -m cooperativeimagecaptioning_tpu_torch.scripts.mode_grid_report \\
           [mode_grid.json] [--markdown]
"""

from __future__ import annotations

import json
import os
import sys


def series(points, condition, key):
    """[(iteration, value)] for one condition, seed first."""
    out = []
    for p in points:
        if p["condition"] != condition or p.get(key) is None:
            continue
        it = p["iteration"]
        out.append((-1 if it == "seed" else int(it), p[key]))
    out.sort()
    return out


def endpoints(points, condition, key):
    s = series(points, condition, key)
    if not s:
        return None, None, None
    seed = s[0][1] if s[0][0] == -1 else None
    peak = max(v for _, v in s[1:]) if len(s) > 1 else None
    last = s[-1][1]
    return seed, last, peak


def report(path):
    with open(path) as f:
        d = json.load(f)
    rows = []
    for mode, md in d.get("modes", {}).items():
        pts = md.get("rank_points", [])
        if not pts:
            continue
        row = {"mode": mode,
               "D": md.get("flags", {}).get("retrieval_reward_weight")}
        for label, cond, key in (
                ("sampled_cider", "current-sample", "CIDEr"),
                ("pair_rsum", "current-sample", "rsum"),
                ("greedy_rank_rsum", "current-greedy", "rsum"),
                ("gt_rsum", "current-gt", "rsum"),
                ("frozen_sample_rsum", "frozen-sample", "rsum")):
            seed, last, peak = endpoints(pts, cond, key)
            row[label] = {"seed": seed, "last": last, "peak": peak}
        rows.append(row)
    return rows


def fmt(v, nd=3):
    if v is None:
        return "-"
    return f"{v:.{nd}f}" if isinstance(v, float) and abs(v) < 10 else \
        f"{v:.1f}" if isinstance(v, float) else str(v)


def main(argv=None):
    args = argv if argv is not None else sys.argv[1:]
    path = next((a for a in args if not a.startswith("-")),
                os.path.join("mode_grid", "mode_grid.json"))
    rows = report(path)
    md = "--markdown" in args
    cols = ("sampled_cider", "pair_rsum", "greedy_rank_rsum", "gt_rsum")
    if md:
        print("| mode | D | " + " | ".join(
            f"{c} seed→last (peak)" for c in cols) + " |")
        print("|---" * (len(cols) + 2) + "|")
    for r in rows:
        cells = []
        for c in cols:
            e = r[c]
            cells.append(f"{fmt(e['seed'])} → {fmt(e['last'])}"
                         f" ({fmt(e['peak'])})")
        if md:
            print(f"| {r['mode']} | {r['D']} | " + " | ".join(cells) + " |")
        else:
            print(r["mode"], f"D={r['D']}")
            for c, cell in zip(cols, cells):
                print(f"  {c:20s} {cell}")
    return rows


if __name__ == "__main__":
    main()
