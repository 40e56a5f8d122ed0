#!/usr/bin/env python
"""Plot benchmark results — the reference's scripts/plotting/plot_results.py role.

Reads results/json/*.json produced by run_all.py / sweep.py and writes PNGs:
  - spmv_comparison.png : per-mode SpMV kernel time (log) + bandwidth bars (roofline % is in
                          the JSONs/human report)
  - cg_scaling.png      : strong-scaling time + efficiency vs chip count
  - cg_problem_size.png : measured single-chip solves vs the reference's published A100 curve

Unlike the reference's plotting scripts (which hardcode showcase numbers,
SURVEY.md §2.9), these only ever plot measured JSONs.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--indir", default="results/json")
    ap.add_argument("--outdir", default="results/plots")
    args = ap.parse_args()
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("[ERROR] matplotlib not available", file=sys.stderr)
        return 1
    os.makedirs(args.outdir, exist_ok=True)
    made = []

    # --- SpMV comparison ---
    spmv = {}
    for p in sorted(set(glob.glob(f"{args.indir}/*spmv*.json"))):
        with open(p) as f:
            r = json.load(f)
        if r.get("benchmark_type") != "spmv":
            continue
        b = r["benchmark"]
        key = (b["matrix"]["rows"], b["mode"])
        spmv[key] = b["performance"]
    if spmv:
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
        modes = sorted({m for _, m in spmv})
        sizes = sorted({n for n, _ in spmv})
        width = 0.8 / max(len(modes), 1)
        # validated categorical palette, fixed slot order (dataviz references/palette.md);
        # bar charts validate on the adjacent pairlist so >3 series is fine here
        PALETTE = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4",
                   "#008300", "#4a3aa7", "#e34948"]
        for k, mode in enumerate(modes):
            xs, ts, bws = [], [], []
            for i, n in enumerate(sizes):
                if (n, mode) in spmv:
                    xs.append(i + k * width)
                    perf = spmv[(n, mode)]
                    # kernel-only time (transfer-inclusive medians measure the host
                    # link and would mislead the comparison)
                    tk = perf.get("time_kernel_ms")
                    ts.append(tk if tk is not None and tk > 0
                              else perf["time_median_ms"])
                    bws.append(perf["bandwidth_gbs"])
            c = PALETTE[k % len(PALETTE)]
            ax1.bar(xs, ts, width=width, label=mode, color=c)
            ax2.bar(xs, bws, width=width, label=mode, color=c)
        ax1.set_yscale("log")
        for ax, ylabel in ((ax1, "kernel time (ms, log)"), (ax2, "bandwidth (GB/s)")):
            ax.set_xticks(range(len(sizes)))
            ax.set_xticklabels([f"{n:,}" for n in sizes])
            ax.set_xlabel("rows")
            ax.set_ylabel(ylabel)
            ax.legend()
        fig.suptitle("SpMV by mode")
        fig.tight_layout()
        out = f"{args.outdir}/spmv_comparison.png"
        fig.savefig(out, dpi=120)
        made.append(out)

    # --- CG strong scaling ---
    scaling = {}
    for p in sorted(glob.glob(f"{args.indir}/*chip*.json")):
        with open(p) as f:
            r = json.load(f)
        if r.get("benchmark_type") != "cg":
            continue
        n = int(r["timing"].get("num_chips", 1))
        rows = r["matrix"]["rows"]
        scaling.setdefault(rows, {})[n] = r["timing"]["total_median_ms"]
    if scaling:
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
        for rows, by_n in sorted(scaling.items()):
            ns = sorted(by_n)
            ts = [by_n[n] for n in ns]
            base = ts[0] * ns[0]
            ax1.plot(ns, ts, "o-", label=f"{rows:,} unknowns")
            ax2.plot(ns, [100 * base / (t * n) for n, t in zip(ns, ts)], "o-",
                     label=f"{rows:,}")
        ax1.set_xlabel("chips"); ax1.set_ylabel("solve time (ms)")
        ax1.set_xscale("log", base=2); ax1.set_yscale("log")
        ax2.set_xlabel("chips"); ax2.set_ylabel("parallel efficiency (%)")
        ax2.axhline(90, ls="--", c="gray")
        ax2.set_xscale("log", base=2); ax2.set_ylim(0, 110)
        for ax in (ax1, ax2):
            ax.legend()
        fig.suptitle("CG strong scaling")
        fig.tight_layout()
        out = f"{args.outdir}/cg_scaling.png"
        fig.savefig(out, dpi=120)
        made.append(out)

    # --- CG problem-size scaling (single configuration per grid size) ---
    # Measured solves keyed by unknown count; overlays the reference's PUBLISHED single-A100
    # numbers (BASELINE.md: 133.9/300.1/531.4 ms at 10k/15k/20k, f64) clearly labeled as such.
    REF_A100 = {10000**2: 133.9, 15000**2: 300.1, 20000**2: 531.4}
    # categorical slots 1-2 of the validated default palette (dataviz references/palette.md)
    C_OURS, C_REF = "#2a78d6", "#eb6834"
    INK, MUTED = "#333333", "#777777"
    sizes_cg = {}
    device_kinds = set()
    for p in sorted(glob.glob(f"{args.indir}/*.json")):
        with open(p) as f:
            r = json.load(f)
        if r.get("benchmark_type") != "cg" or "bcoo" in r.get("mode", ""):
            continue
        if int(r["timing"].get("num_chips", 1)) != 1:
            continue
        rows = r["matrix"]["rows"]
        t = r["timing"]["total_median_ms"]
        device_kinds.add(r["device"]["device_kind"])
        if rows not in sizes_cg or t < sizes_cg[rows]:
            sizes_cg[rows] = t
    if len(device_kinds) > 1:
        raise SystemExit(f"CG artifacts from several devices: {sorted(device_kinds)}")
    if len(sizes_cg) >= 2:
        device_kind = device_kinds.pop()
        fig, ax = plt.subplots(figsize=(7, 4.5))
        xs = sorted(sizes_cg)
        ax.plot(xs, [sizes_cg[x] for x in xs], "-", lw=2, marker="o", ms=8,
                color=C_OURS,
                label=f"tpusparse, 1× {device_kind} (best mode per size, measured)")
        rx = sorted(REF_A100)
        ax.plot(rx, [REF_A100[x] for x in rx], "-", lw=2, marker="o", ms=8,
                color=C_REF, label="reference, 1× A100-SXM (f64, published)")
        # selective direct labels: endpoints only, in ink (text never wears series color)
        ax.annotate(f"{sizes_cg[xs[-1]]:.0f} ms", (xs[-1], sizes_cg[xs[-1]]),
                    textcoords="offset points", xytext=(6, -12), color=INK, fontsize=9)
        ax.annotate(f"{REF_A100[rx[-1]]:.0f} ms", (rx[-1], REF_A100[rx[-1]]),
                    textcoords="offset points", xytext=(6, 6), color=INK, fontsize=9)
        ax.set_xscale("log")
        ax.set_yscale("log")
        ax.set_xlabel("unknowns (grid points)")
        ax.set_ylabel("CG solve time (ms), 14 iterations")
        ax.grid(True, which="both", color="#e6e6e6", lw=0.5)
        ax.set_axisbelow(True)
        for s in ("top", "right"):
            ax.spines[s].set_visible(False)
        for s in ("left", "bottom"):
            ax.spines[s].set_color(MUTED)
        ax.tick_params(colors=MUTED)
        ax.legend(frameon=False, fontsize=9)
        ax.set_title("CG time-to-solution vs problem size (single chip/GPU)",
                     color=INK, fontsize=11)
        fig.tight_layout()
        out = f"{args.outdir}/cg_problem_size.png"
        fig.savefig(out, dpi=120)
        made.append(out)

    if made:
        print("wrote:", *made, sep="\n  ")
        return 0
    print("[WARN] no plottable JSONs found in", args.indir, file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
