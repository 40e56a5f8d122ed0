"""SpMV benchmark CLI.

Contract parity with the reference's ``spmv_bench`` (src/main/main.cu:48-55):

    python -m tpusparse.cli.spmv_bench <matrix.mtx|gen:<g>> --mode=<m1[,m2,...]>
        [--json=<file>] [--csv=<file>] [--runs=N] [--warmup=N] [--dtype=f32|f64]

Behavioral parity: all modes validated before loading (:94-105); x = ones (:136-137);
5 warmups, 10 timed runs (:158-162, 165-167); per-mode output files suffixed ``_<mode>``
(:200-241); Sum(y)/Norm2(y) checksums at 16 decimals (:245-248).

Addition: ``gen:<grid_size>`` synthesizes the stencil operand directly (no .mtx file),
the large-grid path flagged in SURVEY.md §2.1.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(prog="spmv_bench", description=__doc__)
    p.add_argument("matrix", help=".mtx path, or gen:<grid_size> for direct synthesis")
    p.add_argument("--mode", default="stencil5",
                   help="comma-separated SpMV modes (see tpusparse.ops.available_modes)")
    p.add_argument("--json", default=None, help="JSON output base path")
    p.add_argument("--csv", default=None, help="CSV output path (append mode)")
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--dtype", default=None, choices=[None, "f32", "f64", "bf16"])
    p.add_argument("--ceiling-probe", action="store_true",
                   help="measure the achievable HBM ceiling (bench.probes) and report "
                        "roofline_fraction_achievable alongside the nominal fraction")
    p.add_argument("--ceiling-from", default=None, metavar="PROBE_JSON",
                   help="reuse a committed ceiling-probe artifact "
                        "(scripts/probe_ceiling.py output) instead of re-running the "
                        "probe suite per invocation — campaign runs probe once, "
                        "every artifact then reports the same measured denominator")
    p.add_argument("--resident-x", action="store_true",
                   help="keep x device-resident across timed runs (upload once, read y "
                        "back once) — the reference's actual timed region "
                        "(spmv_cusparse_csr.cu:234-264: cudaEvents wrap the kernel; "
                        "transfers sit outside the run loop).  Default timing includes "
                        "per-run H2D/D2H, which dominates at large grids")
    return p


def _resolve_dtype(name):
    if name is None:
        return None
    import jax

    if name == "f64":
        # without x64 mode jnp.float64 silently coerces to f32 — that would report a fake
        # f64 run.  The whole reference is double precision (SURVEY.md §4).
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    return {"f32": jnp.float32, "f64": jnp.float64, "bf16": jnp.bfloat16}[name]


def load_operand(spec: str):
    """Returns (matrix-ish, display name)."""
    from .. import formats, generate, io_mtx

    if spec.startswith("gen:"):
        g = int(spec[4:])

        # PLANES-FREE operand: the canonical generator field is constant-coefficient, so
        # the stencil operators synthesize their planes directly ON DEVICE (bit-identical
        # to the host generator; no multi-GB host build + upload per mode — 16 GB of f64
        # planes at 20000²).  Generic formats (csr/dia/bcoo) synthesize host planes lazily
        # inside stencil5_to_csr.
        return (formats.Stencil5(grid_size=g, planes=None, constant=(5.0, -1.0)),
                f"stencil5-{g}x{g}")
    coo = io_mtx.load_matrix_market(spec)
    return formats.coo_to_csr(coo), os.path.basename(spec)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..dist import enable_compilation_cache

    enable_compilation_cache()
    from .. import ops
    from ..bench import export, metrics, stats, sysinfo

    modes = [m.strip() for m in args.mode.split(",") if m.strip()]
    # validate all modes before the (possibly slow) load — reference main.cu:94-105
    for m in modes:
        if m not in ops.available_modes():
            print(f"[ERROR] unknown mode '{m}'. Available: {ops.available_modes()}",
                  file=sys.stderr)
            return 2

    mat, name = load_operand(args.matrix)
    dtype = _resolve_dtype(args.dtype)
    info = sysinfo.get_system_info()
    print(f"[INFO] device: {info['device_kind']} x{info['num_devices']} "
          f"(backend={info['backend']})")

    ceiling = None
    if args.ceiling_from:
        import json

        with open(args.ceiling_from) as f:
            probe = json.load(f)
        ceiling = probe["achievable_gbs"]
        print(f"[INFO] ceiling from {args.ceiling_from}: achievable {ceiling:.1f} GB/s")
    elif args.ceiling_probe:
        from ..bench import probes

        probe = probes.measure_achievable_bw()
        ceiling = probe["achievable_gbs"]
        print(f"[INFO] ceiling probe: read {probe['read_gbs']:.1f} / copy "
              f"{probe['copy_gbs']:.1f} / triad {probe['triad_gbs']:.1f} GB/s "
              f"→ achievable {ceiling:.1f} GB/s")

    rc = 0
    for mode in modes:
        try:
            op = ops.get_operator(mode, mat, dtype=dtype)
        except ValueError as e:
            print(f"[SKIP] mode {mode}: {e}", file=sys.stderr)
            rc = 1
            continue
        x = np.ones(op.num_cols)
        if args.resident_x:
            # one H2D before the loop, one D2H after — reference run-loop shape
            x_dev = op.as_field(np.asarray(x, dtype=np.dtype(op._run_dtype())))
            bench = stats.benchmark_with_stats(
                lambda: op.run_timed_resident(x_dev)[1],
                num_runs=args.runs, warmup=args.warmup,
            )
            y_dev, _ = op.run_timed_resident(x_dev)
            y = np.asarray(y_dev).reshape(-1)[: op.num_rows]
            # drop the resident field + result BEFORE kernel_time_ms: the chain program
            # holds the operand and two more fields of its own
            del x_dev, y_dev
        else:
            bench = stats.benchmark_with_stats(
                lambda: op.run_timed(x)[1], num_runs=args.runs, warmup=args.warmup
            )
            y, _ = op.run_timed(x)
        itemsize = np.dtype(op._run_dtype()).itemsize
        # GFLOPS/bandwidth from DEVICE-ONLY kernel time (reference methodology: cudaEvents
        # wrap the kernel, not the transfers).  The transfer-inclusive run_timed stats above
        # remain the reported time distribution.  On the CPU the median stands in.
        kernel_ms = (op.kernel_time_ms() if info["backend"] != "cpu"
                     else bench.median_ms)
        mets = metrics.calculate_spmv_metrics(
            op, kernel_ms, dtype_itemsize=itemsize,
            device_kind=info["device_kind"], mode=mode, achievable_gbs=ceiling,
        )
        result = export.spmv_result_dict(
            mode=mode, matrix_name=name, op=op, metrics=mets, stats=bench,
            sysinfo=info, sum_y=float(y.sum()), norm2_y=float(np.linalg.norm(y)),
            kernel_ms=kernel_ms,
            run_protocol="device-resident" if args.resident_x else "transfer-inclusive",
        )
        export.print_human_spmv(result)
        print()
        if args.json:
            base, ext = os.path.splitext(args.json)
            path = f"{base}_{mode}{ext or '.json'}"
            export.write_json(path, result)
            print(f"[INFO] JSON written: {path}")
        if args.csv:
            export.append_csv(args.csv, result)
        op.free()
    return rc


if __name__ == "__main__":
    sys.exit(main())
