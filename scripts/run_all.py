#!/usr/bin/env python
"""One-command reproduce — the reference's scripts/run_all.sh (SURVEY.md §2.9) in Python.

Detects the environment, runs the SpMV benchmark across modes, single-chip CG, multi-chip
sharded CG at 1..N chips, then prints a speedup/efficiency summary table from the JSONs.

    python scripts/run_all.py [--quick] [--size=G] [--outdir=results]

--quick: g=256, 3 runs (the reference's --quick uses 512/3, scaled down for emulated-CPU use).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--size", type=int, default=0)
    ap.add_argument("--outdir", default="results")
    ap.add_argument("--modes", default="stencil5,stencil5-bf16c,stencil5-const,csr,bcoo")
    args = ap.parse_args()

    import jax

    from tpusparse.bench import sysinfo
    from tpusparse.cli import cg_solver, cg_solver_multichip, spmv_bench

    info = sysinfo.get_system_info()
    on_cpu = info["backend"] == "cpu"
    g = args.size or (256 if args.quick or on_cpu else 4096)
    runs = 3 if args.quick or on_cpu else 10
    ndev = jax.device_count()
    os.makedirs(os.path.join(args.outdir, "json"), exist_ok=True)
    jdir = os.path.join(args.outdir, "json")

    print("=" * 70)
    print(f"tpusparse run_all — {info['device_kind']} x{ndev}, grid {g}x{g} "
          f"({g * g:,} unknowns)")
    print("=" * 70)

    print("\n--- [1/3] SpMV benchmark ---")
    rc = spmv_bench.main([f"gen:{g}", f"--mode={args.modes}", f"--runs={runs}",
                          "--warmup=2", f"--json={jdir}/spmv.json"])
    if rc > 1:  # rc == 1 is a soft per-mode SKIP; don't kill the whole reproduce for it
        return rc

    print("\n--- [2/3] single-chip CG ---")
    rc = cg_solver.main([f"gen:{g}", f"--runs={runs}", "--warmup=1", "--verbose=0",
                         f"--json={jdir}/cg_single.json"])
    if rc:
        return rc

    print("\n--- [2b] baseline CG (bcoo — the independent cross-check, AmgX role) ---")
    rc = cg_solver.main([f"gen:{g}", "--mode=bcoo", f"--runs={runs}", "--warmup=1",
                         "--verbose=0", f"--json={jdir}/cg_baseline_bcoo.json"])
    if rc:
        return rc

    print("\n--- [2c] generic-baseline CG (csr — the hand Pallas gather kernel, "
          "cuSPARSE role; practical at full benchmark sizes) ---")
    rc = cg_solver.main([f"gen:{g}", "--mode=csr", f"--runs={runs}", "--warmup=1",
                         "--verbose=0", f"--json={jdir}/cg_baseline_csr.json"])
    if rc:
        return rc

    print("\n--- [3/3] sharded CG scaling ---")
    chip_counts = [n for n in (1, 2, 4, 8) if n <= ndev and g % n == 0]
    for n in chip_counts:
        rc = cg_solver_multichip.main(
            [f"gen:{g}", f"--chips={n}", f"--runs={runs}", "--warmup=1",
             f"--json={jdir}/cg_sharded_{n}chip.json"]
        )
        if rc:
            return rc

    # summary table (the reference greps its JSONs; we read ours)
    print("\n" + "=" * 70)
    print("SUMMARY")
    print("=" * 70)
    # kernel-only times for the speedup comparison (reference methodology; the
    # transfer-inclusive medians measure the host link as much as the kernel)
    def _kernel_ms(perf):
        t = perf.get("time_kernel_ms")
        return t if t is not None and t > 0 else perf["time_median_ms"]

    st = None
    st_path = f"{jdir}/spmv_stencil5.json"
    if os.path.exists(st_path):
        with open(st_path) as f:
            st = json.load(f)["benchmark"]["performance"]
        print(f"SpMV stencil5: {_kernel_ms(st):.3f} ms kernel, {st['bandwidth_gbs']:.1f} GB/s "
              f"({100 * st['roofline_fraction']:.1f}% roofline)")
    csr_path = f"{jdir}/spmv_csr.json"
    if st and os.path.exists(csr_path):
        with open(csr_path) as f:
            cs = json.load(f)["benchmark"]["performance"]
        print(f"SpMV csr:      {_kernel_ms(cs):.3f} ms kernel  → stencil5 speedup "
              f"{_kernel_ms(cs) / _kernel_ms(st):.2f}x")
    with open(f"{jdir}/cg_single.json") as f:
        ours = json.load(f)
    with open(f"{jdir}/cg_baseline_bcoo.json") as f:
        base_cg = json.load(f)
    t_ours = ours["timing"]["total_median_ms"]
    t_base = base_cg["timing"]["total_median_ms"]
    same_iters = ours["convergence"]["iterations"] == base_cg["convergence"]["iterations"]
    print(f"CG stencil5 vs bcoo baseline: {t_ours:.2f} vs {t_base:.2f} ms "
          f"({t_base / t_ours:.2f}x, iterations {'match' if same_iters else 'DIFFER'})")
    csr_cg_path = f"{jdir}/cg_baseline_csr.json"
    if os.path.exists(csr_cg_path):
        with open(csr_cg_path) as f:
            gen_cg = json.load(f)
        t_gen = gen_cg["timing"]["total_median_ms"]
        gi = gen_cg["convergence"]["iterations"] == ours["convergence"]["iterations"]
        print(f"CG stencil5 vs csr (Pallas gather) baseline: {t_ours:.2f} vs "
              f"{t_gen:.2f} ms ({t_gen / t_ours:.2f}x, "
              f"iterations {'match' if gi else 'DIFFER'})")
    base = None
    print(f"\n{'chips':>5} {'median ms':>10} {'iters':>6} {'speedup':>8} {'efficiency':>10}")
    for n in chip_counts:
        with open(f"{jdir}/cg_sharded_{n}chip.json") as f:
            r = json.load(f)
        t = r["timing"]["total_median_ms"]
        it = r["convergence"]["iterations"]
        if base is None:
            base = t
        sp = base / t
        print(f"{n:>5} {t:>10.2f} {it:>6} {sp:>7.2f}x {100 * sp / n:>9.1f}%")
    print("\nJSONs in", jdir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
