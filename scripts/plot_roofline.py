#!/usr/bin/env python
"""Roofline figure — the reference's scripts/plotting/plot_roofline.py role.

Reads measured SpMV result JSONs (results/json/spmv_*.json by default) plus the ceiling
probe artifact (ceiling_probe_*.json in the same directory) and draws the classic roofline:
arithmetic intensity (x, log) vs achieved GFLOPS (y, log), under BOTH ceilings —
the nominal spec-sheet HBM slope and the MEASURED-achievable slope (bench.probes).
Only measured data is plotted (the reference's plotting hardcodes showcase numbers).

Kernel identity is carried by direct labels (one hue for all points: more than three
series in a scatter cannot clear all-pairs palette validation, so color does not carry
identity here at all)."""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--indir", default="results/json")
    ap.add_argument("--out", default="results/plots/roofline.png")
    args = ap.parse_args()
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("[ERROR] matplotlib not available", file=sys.stderr)
        return 1

    points = []  # (mode, rows, ai, gflops)
    peak_flops = None
    nominal_bw = None
    device = None
    for p in sorted(glob.glob(f"{args.indir}/spmv_*.json")):
        with open(p) as f:
            r = json.load(f)
        if r.get("benchmark_type") != "spmv":
            continue
        b = r["benchmark"]
        perf, an = b["performance"], b["analysis"]
        points.append((b["mode"], b["matrix"]["rows"], an["arithmetic_intensity"],
                       perf["gflops"]))
        device = r["device"]["device_kind"]
    probes = sorted(glob.glob(f"{args.indir}/ceiling_probe_*.json"))
    achievable_bw = None
    if probes:
        with open(probes[-1]) as f:
            pr = json.load(f)
        achievable_bw = pr["achievable_gbs"]
        nominal_bw = pr.get("nominal_gbs")
    if not points:
        print("[WARN] no spmv result JSONs found; nothing to plot", file=sys.stderr)
        return 1
    if nominal_bw is None or peak_flops is None:
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
        from tpusparse.bench.metrics import chip_peaks

        nb, pf = chip_peaks(device)  # raises for a device without published peaks
        nominal_bw = nominal_bw or nb
        peak_flops = pf

    C_POINT = "#2a78d6"  # categorical slot 1 (dataviz references/palette.md)
    INK, MUTED = "#333333", "#777777"

    fig, ax = plt.subplots(figsize=(7.2, 5.0))
    ais = [0.05, 0.1, 0.25, 0.5, 1, 2, 4, 8, 16]
    import numpy as np

    ai_grid = np.logspace(-1.5, 1.5, 64)
    # ceilings: min(bw·AI, peak_flops); identity via line style + inline label, not color
    nom = np.minimum(nominal_bw * ai_grid, peak_flops)
    ax.plot(ai_grid, nom, ls="--", lw=1.4, color=MUTED,
            label=f"published memory roofline ({nominal_bw:.0f} GB/s)")
    if achievable_bw:
        ach = np.minimum(achievable_bw * ai_grid, peak_flops)
        ax.plot(ai_grid, ach, ls="-", lw=1.6, color=INK,
                label=f"measured-achievable ceiling ({achievable_bw:.0f} GB/s probe)")

    # one point per (mode, largest size); direct labels carry identity
    best = {}
    for mode, rows, ai, gf in points:
        if mode not in best or rows > best[mode][0]:
            best[mode] = (rows, ai, gf)
    for mode, (rows, ai, gf) in sorted(best.items(), key=lambda kv: kv[1][2]):
        ax.plot([ai], [gf], "o", ms=8, color=C_POINT, mec="white", mew=1.0)
        ax.annotate(f"{mode}", (ai, gf), textcoords="offset points",
                    xytext=(8, -3), color=INK, fontsize=9)

    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlim(ai_grid[0], ai_grid[-1])
    ax.set_xticks(ais)
    ax.get_xaxis().set_major_formatter(plt.FuncFormatter(lambda v, _: f"{v:g}"))
    ax.set_xlabel("arithmetic intensity (FLOP / byte)", color=INK)
    ax.set_ylabel("achieved GFLOP/s", color=INK)
    g = max(r for r, _, _ in best.values())
    ax.set_title(f"SpMV roofline — {device} (largest measured size, "
                 f"n = {g:,} rows)", color=INK, fontsize=11)
    ax.grid(True, which="both", color="#e6e6e6", lw=0.5)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    for s in ("left", "bottom"):
        ax.spines[s].set_color(MUTED)
    ax.tick_params(colors=MUTED)
    ax.legend(frameon=False, fontsize=9, loc="lower right")
    fig.tight_layout()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    fig.savefig(args.out, dpi=150)
    print(f"[INFO] written: {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
