#!/usr/bin/env python
"""Sharded generic-vs-structured CG comparison — the committed-artifact analog of the
reference's in-solver comparison workflow (its generic ``csr_spmv_kernel`` lives INSIDE the
partitioned solver, cg_solver_mgpu_partitioned.cu:40-56, and its multi-GPU head-to-heads are
committed in external/benchmarks/amgx/BENCHMARK_RESULTS.md:25-50).

Runs sharded CG with the generic band-local gather (``mode=csr`` — the XLA-gather comparison
kernel, NOT the single-chip Pallas gather) and with the structured stencil modes on the same
mesh/grid, stepped dispatch-corrected timers, and writes one JSON per mode plus a markdown
markdown table.

    python scripts/sharded_compare.py [--grid 1024] [--devices 8] [--runs 5] \
        [--outdir results/json]

Runs on whatever backend JAX resolves; pass --cpu-mesh to force the 8-virtual-device CPU
mesh (the only multi-device environment on a 1-chip deployment).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=1024)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--outdir", default="results/json")
    ap.add_argument("--cpu-mesh", action="store_true",
                    help="force the CPU backend with --devices virtual devices")
    ap.add_argument("--modes", default="csr,stencil5,stencil5-const")
    args = ap.parse_args()

    if args.cpu_mesh:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   f" --xla_force_host_platform_device_count="
                                   f"{args.devices}")
    import jax

    if args.cpu_mesh:
        jax.config.update("jax_platforms", "cpu")

    from tpusparse.cli import cg_solver_multichip

    os.makedirs(args.outdir, exist_ok=True)
    rc = 0
    outs = []
    for mode in args.modes.split(","):
        out = os.path.join(args.outdir,
                           f"cg_sharded_compare_{args.grid}_{mode}_"
                           f"{args.devices}dev.json")
        rc |= cg_solver_multichip.main([
            f"gen:{args.grid}", f"--chips={args.devices}", f"--mode={mode}",
            "--timers", f"--runs={args.runs}", f"--warmup={args.warmup}",
            f"--json={out}",
        ])
        outs.append((mode, out))

    # render the comparison table
    import json

    print("\n| sharded CG @ {g}² on {n} devices | total (median) | SpMV | halo | "
          "allreduce | BLAS1 | iters |".format(g=args.grid, n=args.devices))
    print("|---|---|---|---|---|---|---|")
    for mode, path in outs:
        with open(path) as f:
            r = json.load(f)
        t, c = r["timing"], r["convergence"]
        clipped = t.get("dispatch_clipped_buckets", "")

        def cell(key, name):
            v = t.get(key, 0.0)
            mark = "†" if name in clipped.split(",") else ""
            return f"{v:.1f} ms{mark}"

        label = mode + (" (generic gather)" if mode == "csr" else "")
        print(f"| {label} | {t['total_median_ms']:.1f} ms | {cell('spmv_ms','spmv')} | "
              f"{cell('halo_ms','halo')} | {cell('allreduce_ms','allreduce')} | "
              f"{cell('blas1_ms','blas1')} | {c['iterations']} |")
    print("\n† bucket clipped to 0 by the dispatch-floor correction "
          "(below the launch floor)")
    return rc


if __name__ == "__main__":
    sys.exit(main())
