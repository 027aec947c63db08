"""Merge focused eval_recognition.py runs into one study and print the table.

The recognition study (tools/eval_recognition.py) supports focused re-runs
of individual grid cells (--noises/--occs/--engines) so a long sweep can be
executed cell-by-cell and survive interrupted runs (the same reason
run_uwa_analog.py grew --resume). This tool concatenates those per-cell
output JSONs — verifying the protocol fields (model size, seeds, scene
budget) agree — and prints the combined summary table in the same format,
optionally writing the merged JSON (the committed eval_results.json).

Usage:
  python tools/merge_eval.py cell1.json cell2.json ... [--out merged.json]
"""

import argparse
import json

import numpy as np

PROTOCOL_FIELDS = ("model_points", "seeds", "n_total")


def merge(paths):
    merged = None
    for p in paths:
        with open(p) as f:
            d = json.load(f)
        if merged is None:
            merged = {k: d[k] for k in
                      ("model_points", "diameter", "seeds", "n_total")}
            merged["results"] = []
        else:
            for k in PROTOCOL_FIELDS:
                if d[k] != merged[k]:
                    raise SystemExit(
                        f"{p}: protocol mismatch {k}={d[k]} vs {merged[k]}")
        merged["results"].extend(d["results"])
    # De-duplicate (a re-run cell supersedes an earlier copy: last wins).
    seen = {}
    for r in merged["results"]:
        seen[(r["noise"], r["occ"], r["seed"], r["engine"])] = r
    merged["results"] = list(seen.values())
    return merged


def summarize(merged):
    results = merged["results"]
    noises = sorted({r["noise"] for r in results})
    occs = sorted({r["occ"] for r in results})
    engines = []
    for r in results:  # preserve first-seen order
        if r["engine"] not in engines:
            engines.append(r["engine"])
    print(f"{'noise':>6} {'occ':>5} | "
          + " | ".join(f"{e:>12}" for e in engines))
    for noise in noises:
        for occ in occs:
            row = []
            for e in engines:
                sel = [r for r in results
                       if r["engine"] == e and r["noise"] == noise
                       and r["occ"] == occ]
                if not sel:
                    row.append(f"{'—':>12}")
                    continue
                rate = sum(r["match"] for r in sel) / len(sel)
                rerr = float(np.median([r["rot_err_deg"] for r in sel]))
                row.append(f"{rate*100:5.1f}% {rerr:4.1f}d")
            print(f"{noise:>6} {occ:>5} | " + " | ".join(
                f"{c:>12}" for c in row))
    ovf = sum(r.get("overflowed", False) for r in results)
    n = len(results)
    print(f"trials: {n}  overflows: {ovf}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("cells", nargs="+")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    merged = merge(args.cells)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(merged, f)
    summarize(merged)


if __name__ == "__main__":
    main()
