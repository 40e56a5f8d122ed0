#!/usr/bin/env python
"""Render a format-comparison table from ``spmv_bench --json`` artifacts.

The reference publishes a per-format/per-size SpMV table (README.md:110-116,
docs/results_spmv_a100_manual.json).  This renders the tpusparse analog from a directory of
``spmv_bench`` JSON results: one row per mode, one column per grid, each cell the kernel
time and bandwidth, and the device named from the artifacts themselves (several devices in
one directory are an error: a table compares on one card).

    python -m tpusparse.cli.spmv_bench gen:10240 --mode=stencil5,csr --json=out/spmv.json
    python scripts/format_table.py --dir out [--csv out/table.csv]
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import sys


def load_rows(results_dir):
    """{(mode, grid): record} for every spmv artifact in the directory, and the device."""
    rows, devices = {}, set()
    for path in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("benchmark_type") != "spmv":
            continue
        b = rec["benchmark"]
        rows[(b["mode"], b["matrix"]["grid_size"])] = rec
        dev = rec.get("device", {})
        smi = (dev.get("nvidia_smi") or [{}])[0]
        devices.add((dev.get("device_kind", "unknown device"), smi.get("power.limit")))
    if len(devices) > 1:
        raise SystemExit(f"artifacts from several devices: {sorted(devices, key=str)}")
    return rows, (devices.pop() if devices else None)


def render(rows):
    modes = sorted({m for m, _ in rows})
    sizes = sorted({g for _, g in rows})
    lines = ["| mode \\ grid | " + " | ".join(f"{g}²" for g in sizes) + " |",
             "|---" * (len(sizes) + 1) + "|"]
    for mode in modes:
        cells = []
        for g in sizes:
            rec = rows.get((mode, g))
            if rec is None:
                cells.append("not measured")
                continue
            p = rec["benchmark"]["performance"]
            flag = "†" if p.get("timing_flags") else ""
            cells.append(f"{p['time_kernel_ms']:.3f} ms{flag} ({p['bandwidth_gbs']:.0f} GB/s)")
        lines.append(f"| {mode} | " + " | ".join(cells) + " |")
    return lines


def write_csv(rows, path):
    """One flattened row per artifact, every column the union of their fields."""
    from tpusparse.bench.export import _flatten

    flat_rows = [_flatten(rows[k]) for k in sorted(rows, key=lambda k: (k[1], k[0]))]
    fieldnames = []
    for r in flat_rows:
        fieldnames += [k for k in r if k not in fieldnames]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames, restval="")
        w.writeheader()
        w.writerows(flat_rows)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True, help="directory of spmv_bench JSON artifacts")
    ap.add_argument("--csv", default=None, help="also write the artifacts as one CSV")
    args = ap.parse_args()
    rows, device = load_rows(args.dir)
    if not rows:
        print(f"no spmv artifacts in {args.dir}", file=sys.stderr)
        return 1
    kind, power = device
    print(f"SpMV kernel time (device-only, chained) on {kind}"
          + (f", power limit {power}" if power else "") + ":\n")
    print("\n".join(render(rows)))
    if any(r["benchmark"]["performance"].get("timing_flags") for r in rows.values()):
        print("\n† timing-validity flag set: the implied bandwidth is no roofline claim "
              "(see the artifact's performance.timing_flags).")
    if args.csv:
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
        write_csv(rows, args.csv)
        print(f"\n[csv written: {args.csv}]", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
