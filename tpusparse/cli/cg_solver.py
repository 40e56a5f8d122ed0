"""CG solver CLI.

Contract parity with the reference's ``cg_solver`` (src/main/cg_solver.cu:46-53):

    python -m tpusparse.cli.cg_solver <matrix.mtx|gen:<g>> [--mode=stencil5]
        [--tol=1e-6] [--maxiter=1000] [--timers] [--json=<f>] [--csv=<f>]
        [--runs=10] [--warmup=3] [--dtype=...]

Defaults match the reference: mode=stencil5 (their "stencil5-csr"), device-native loop,
tol=1e-6, maxiter=1000, b = ones, x₀ = 0 (:124-128); 3 warmup solves then 10-run stats
(:154-173); RMS-vs-ones sanity check (:187-192); Sum(x)/Norm2(x) checksums (:211-219).
``--timers`` switches to the host-stepped loop with per-phase timing, the reference's opt-in
detailed-timer tradeoff (cg_solver.h:25).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .spmv_bench import _resolve_dtype, load_operand


def build_parser():
    p = argparse.ArgumentParser(prog="cg_solver", description=__doc__)
    p.add_argument("matrix", help=".mtx path, or gen:<grid_size>")
    p.add_argument("--mode", default="stencil5")
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--maxiter", type=int, default=1000)
    p.add_argument("--timers", action="store_true",
                   help="per-phase timing via the host-stepped loop (adds sync overhead)")
    p.add_argument("--host", action="store_true",
                   help="host-stepped loop, single run (reference --host: the "
                        "correctness/fallback path, cg_solver.cu:172-181)")
    p.add_argument("--device", action="store_true",
                   help="device-native fused loop (the default; reference --device)")
    p.add_argument("--loop", default="classic", choices=["classic", "recompute"],
                   help="iteration structure: 'classic' = the 3-pass loop, 'recompute' = "
                        "the two-pass recompute-Ap loop (operators that provide it; "
                        "stencil5-const).  The artifact records which one ran.")
    p.add_argument("--json", default=None)
    p.add_argument("--csv", default=None)
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--dtype", default=None, choices=[None, "f32", "f64", "bf16"])
    p.add_argument("--verbose", type=int, default=1)
    p.add_argument("--trace", default=None, metavar="LOGDIR",
                   help="capture an XProf/TensorBoard trace of ONE extra solve (excluded "
                        "from stats) — the reference's cudaProfilerStart/Stop run")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.host and args.device:
        # argv-only check: fail before the (possibly expensive) load + operator build
        print("[ERROR] --host and --device are mutually exclusive", file=sys.stderr)
        return 2
    from ..dist import enable_compilation_cache

    enable_compilation_cache()

    from .. import ops
    from ..bench import export, metrics, stats, sysinfo
    from ..solvers import cg

    mat, name = load_operand(args.matrix)
    dtype = _resolve_dtype(args.dtype)
    op = ops.get_operator(args.mode, mat, dtype=dtype)
    info = sysinfo.get_system_info()
    print(f"[INFO] device: {info['device_kind']} x{info['num_devices']} "
          f"(backend={info['backend']})")

    run_dtype = dtype or ops._default_dtype()
    # b = ones can be synthesized in-graph ONLY when the operator's field has no padded
    # tail (ones_b zero-pads it; in-graph ones would put 1.0 in decoupled padded rows and
    # the residual there would never decay — e.g. the lane-padded dia operator).
    padded_field = op.field_elems != op.num_cols
    host_path = args.host or args.timers
    if host_path or padded_field:
        b = op.ones_b(run_dtype)
    else:
        # device path with in-graph b synthesis: the solve only consumes shape/dtype, so
        # never keep a real ones field resident (3.2 GB at 20000² f64)
        import jax

        b = jax.ShapeDtypeStruct(op.field_shape, run_dtype)
    config = cg.CGConfig(max_iters=args.maxiter, tolerance=args.tol,
                         verbose=args.verbose, enable_detailed_timers=args.timers)

    recompute_ap = args.loop == "recompute"
    recomp_avail = (op.run_pupdate_dot_op is not None
                    and op.run_update_recompute_op is not None)
    if recompute_ap and not recomp_avail:
        print(f"[ERROR] --loop=recompute: mode '{args.mode}' provides no recompute "
              "passes (stencil5-const does)", file=sys.stderr)
        return 2
    if host_path:
        loop_kind = "host-stepped"
    elif recompute_ap:
        loop_kind = "recompute-ap"
    else:
        loop_kind = "fused-classic"

    def run_solve(keep_x: bool = False):
        t0 = time.perf_counter()
        if host_path:
            x, st = cg.cg_solve_stepped(op.run_device_dot, b, config=config)
        else:
            # unpadded field: let the solve synthesize b = ones in-graph (reclaims the
            # b/x0 buffers — matters at 20k²); padded field: pass the zero-tailed buffer
            x, st = cg.cg_solve(op, b, config=config, b_is_ones=not padded_field,
                                recompute_ap=recompute_ap)
        ms = (time.perf_counter() - t0) * 1e3
        if not keep_x:
            # benchmark_solver_with_stats keeps every run's payload until the median is
            # known — a device x in each payload would accumulate runs × field bytes.
            # The solve is deterministic: checksums come from ONE extra solve after the
            # stats, not from the timed runs.
            del x
            return ms, (None, st)
        return ms, (x, st)

    # reference: device path gets 10-run stats, host path a single run (cg_solver.cu:172-181)
    if args.host and not args.timers:
        run_solve()  # one untimed warmup so the single timed run excludes compilation
        ms, (x, cg_stats) = run_solve(keep_x=True)
        bench = stats.BenchmarkStats(
            mean_ms=ms, std_ms=0.0, median_ms=ms, min_ms=ms, max_ms=ms,
            total_runs=1, valid_runs=1, outliers_removed=0, times_ms=[ms],
            median_run_index=0,
        )
    else:
        bench, (_nox, cg_stats) = stats.benchmark_solver_with_stats(
            run_solve, num_runs=args.runs, warmup=args.warmup
        )
        # deterministic solve: one extra run supplies the checksummed solution the timed
        # payloads no longer carry (see run_solve)
        _, (x, _st) = run_solve(keep_x=True)

    if args.trace:
        from ..bench import profiling

        profiling.profiled_run(lambda: run_solve()[1][0], logdir=args.trace)
        print(f"[INFO] trace captured: {args.trace}")

    x_host = np.asarray(op.from_field(x), np.float64)
    # performance.gflops_spmv is computed from a MEASUREMENT only (the reference derives it
    # from measured spmv time, cg_metrics.cu:~120): the stepped breakdown under --timers,
    # otherwise a chained device-kernel timing of the SpMV itself.  Never an invented share.
    extra_timing = None
    if cg_stats.spmv_time_ms > 0:
        spmv_ms_total = cg_stats.spmv_time_ms
    else:
        spmv_kernel_ms = op.kernel_time_ms()
        spmv_ms_total = spmv_kernel_ms * max(cg_stats.iterations, 1)
        extra_timing = {"spmv_kernel_ms_per_apply": spmv_kernel_ms}
    gfl = metrics.cg_gflops(op.nnz, cg_stats.iterations, spmv_ms_total)
    result = export.cg_result_dict(
        solver="tpusparse-cg", mode=args.mode, matrix_name=name, op=op,
        cg_stats=cg_stats, bench_stats=bench, sysinfo=info,
        sum_x=float(x_host.sum()), norm2_x=float(np.linalg.norm(x_host)),
        gflops_spmv=gfl, extra_timing=extra_timing, loop=loop_kind,
    )
    export.print_human_cg(result)

    # Solution sanity: interior rows of the stencil sum to diag + 4·offdiag = 1, so
    # A·ones ≈ ones and the solve of b = ones gives x ≈ 1 away from the boundary — the
    # reference's RMS heuristic (cg_solver.cu:187-192).  Printed, not gated (boundary rows
    # legitimately deviate).
    if args.verbose >= 1 and args.mode.startswith("stencil5"):
        rms = float(np.sqrt(np.mean((x_host - 1.0) ** 2)))
        print(f"RMS error vs x≈1 heuristic: {rms:.6f}")
    if not cg_stats.converged:
        print("[WARN] solver did not converge", file=sys.stderr)

    if args.json:
        export.write_json(args.json, result)
        print(f"[INFO] JSON written: {args.json}")
    if args.csv:
        export.append_csv(args.csv, result)
    return 0 if cg_stats.converged else 1


if __name__ == "__main__":
    sys.exit(main())
