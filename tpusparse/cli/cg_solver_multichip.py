"""Multi-chip sharded CG solver CLI.

Role parity with the reference's ``cg_solver_mgpu_stencil`` (src/main/cg_solver_mgpu_stencil.cu):

    python -m tpusparse.cli.cg_solver_multichip gen:<g> [--chips=N] [--mode=stencil5]
        [--tol=1e-6] [--maxiter=1000] [--json=<f>] [--csv=<f>] [--runs=10] [--warmup=3]
        [--multihost]

Differences by design (SURVEY.md §2.4): no mpirun — ONE process drives all local cards through
a ``jax.sharding.Mesh`` (several hosts use --multihost → ``jax.distributed.initialize()``,
one process per host).  The reference's per-rank .mtx load / MPI_Bcast dance (:50-60) has no
analog: the operand is synthesized directly into its sharded layout.

Matches the reference protocol: hardcoded-style defaults max_iters=1000 tol=1e-6 (:77-80),
warmup 3 (:97-106), 10-run stats (:126-131), rank-0-style single-point reporting with
Sum(x)/Norm2(x) checksums (:163-172).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(prog="cg_solver_multichip", description=__doc__)
    p.add_argument("matrix",
                   help=".mtx path (5-point-stencil-extractable, like the reference's "
                        "mgpu binary) or gen:<grid_size> (operands synthesized directly "
                        "into their sharded layout)")
    p.add_argument("--chips", type=int, default=0, help="devices to use (default: all)")
    p.add_argument("--mode", default="stencil5",
                   choices=["stencil5", "stencil5-bf16c", "stencil5-const", "csr"],
                   help="SpMV inside the sharded solve.  NOTE: sharded 'csr' is the "
                        "generic band-local XLA-gather COMPARISON kernel (the role of the "
                        "reference's in-solver csr_spmv_kernel, "
                        "cg_solver_mgpu_partitioned.cu:40-56), which needs every column "
                        "within one grid row of its row")
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--maxiter", type=int, default=1000)
    p.add_argument("--json", default=None)
    p.add_argument("--csv", default=None)
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--dtype", default=None, choices=[None, "f32", "f64", "bf16"])
    p.add_argument("--mesh2d", default=None, metavar="RxC",
                   help="2-D block decomposition over an RxC device mesh — beyond the "
                        "reference's 1-D row bands (perimeter-scaled halos); the grid "
                        "must divide both extents")
    p.add_argument("--multihost", action="store_true",
                   help="call jax.distributed.initialize() first (one process per host)")
    p.add_argument("--timers", action="store_true",
                   help="per-phase timing via the host-stepped sharded loop (adds syncs)")
    p.add_argument("--trace", default=None, metavar="LOGDIR",
                   help="capture an XProf trace of ONE extra solve, excluded from stats")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..dist import enable_compilation_cache

    enable_compilation_cache()
    if args.multihost:
        from ..dist import initialize_multihost

        initialize_multihost()
    import jax

    from ..bench import export, metrics, stats, sysinfo
    from ..dist import make_band_mesh
    from ..solvers import cg_sharded

    # Operand source — the reference's flagship workflow is `mpirun cg_solver_mgpu_stencil
    # <matrix.mtx>` (src/main/cg_solver_mgpu_stencil.cu:50-60, every rank loads the file);
    # here ONE process loads it and shards the extracted operand over the mesh.
    planes = None          # values-carrying (5, g, g) host planes from a file
    matrix = None          # CSR for the generic "csr" mode from a file
    const_coeffs = None    # (diag, offdiag) when the file's coefficients are uniform
    matrix_name = None
    if args.matrix.startswith("gen:"):
        g = int(args.matrix[4:])
    else:
        from .. import formats
        from .spmv_bench import load_operand

        mat, matrix_name = load_operand(args.matrix)
        if args.mode == "csr":
            # generic mode: any g²×g² matrix with ≤ one-grid-row column reach
            matrix = mat
            g = mat.grid_size
            if g <= 0:
                import math

                g = int(math.isqrt(mat.num_rows))
            if g * g != mat.num_rows:
                print(f"[ERROR] {args.matrix}: {mat.num_rows} rows is not a g² square",
                      file=sys.stderr)
                return 2
        else:
            try:
                st = formats.csr_to_stencil5(mat)
            except ValueError as e:
                print(f"[ERROR] {args.matrix} is not 5-point-stencil-extractable ({e}); "
                      "use --mode=csr for generic banded matrices", file=sys.stderr)
                return 2
            g = st.grid_size
            const_coeffs = st.constant
            if args.mode in ("stencil5", "stencil5-bf16c"):
                planes = st.planes
            elif const_coeffs is None:  # stencil5-const needs uniform coefficients
                print(f"[ERROR] {args.matrix} has non-uniform coefficients; "
                      "stencil5-const requires a constant field (use --mode=stencil5)",
                      file=sys.stderr)
                return 2
    matrix_name = matrix_name or f"stencil5-{g}x{g}"
    mesh2d = None
    if args.mesh2d:
        if args.mode == "csr":
            print("[ERROR] the generic csr mode is 1-D row-band only (reference parity: "
                  "its comparison kernel lives in the 1-D partitioned solver)",
                  file=sys.stderr)
            return 2
        try:
            r, c = (int(v) for v in args.mesh2d.lower().split("x"))
        except ValueError:
            print(f"[ERROR] --mesh2d expects RxC (e.g. 2x4), got '{args.mesh2d}'",
                  file=sys.stderr)
            return 2
        if r * c > jax.device_count():
            print(f"[ERROR] --mesh2d={r}x{c} needs {r * c} devices, have "
                  f"{jax.device_count()}", file=sys.stderr)
            return 2
        mesh = jax.make_mesh((r, c), ("x", "y"))
        mesh2d = (r, c)
    else:
        mesh = make_band_mesh(args.chips)
    nchips = mesh.devices.size
    info = sysinfo.get_system_info()
    is_primary = jax.process_index() == 0
    if is_primary:
        print(f"[INFO] mesh: {nchips} x {info['device_kind']} "
              f"({jax.process_count()} process(es))")

    from .spmv_bench import _resolve_dtype

    from ..ops import _default_dtype

    dtype = _resolve_dtype(args.dtype) or _default_dtype()

    diag, offdiag = const_coeffs if const_coeffs is not None else (5.0, -1.0)
    op = None
    if not mesh2d:
        # build the sharded operand ONCE, outside the benchmark loop (and reuse it for the
        # export metadata below) — file-loaded operands are uncached by design
        op = cg_sharded.make_sharded_operator(
            mesh, g, mode=args.mode, planes=planes, matrix=matrix,
            diag=diag, offdiag=offdiag, dtype=dtype,
        )

    def run_solve(keep_x: bool = False):
        t0 = time.perf_counter()
        if mesh2d:
            solve2d = (cg_sharded.cg_solve_sharded_2d_stepped if args.timers
                       else cg_sharded.cg_solve_sharded_2d)
            x, st = solve2d(
                mesh, g, mode=args.mode, planes=planes, diag=diag, offdiag=offdiag,
                tolerance=args.tol, max_iters=args.maxiter, dtype=dtype,
            )
        elif args.timers:
            x, st = cg_sharded.cg_solve_sharded_stepped(
                mesh, g, tolerance=args.tol, max_iters=args.maxiter,
                dtype=dtype, operator=op,
            )
        else:
            x, st = cg_sharded.cg_solve_sharded(
                mesh, g, tolerance=args.tol, max_iters=args.maxiter,
                dtype=dtype, operator=op,
            )
        ms = (time.perf_counter() - t0) * 1e3
        if not keep_x:
            # benchmark_solver_with_stats retains every run's payload until the median
            # run is known — a sharded device x per payload accumulates runs × field
            # bytes (see cli/cg_solver.py run_solve, the measured 20480² OOM)
            del x
            return ms, (None, st)
        return ms, (x, st)

    bench, (_nox, cg_stats) = stats.benchmark_solver_with_stats(
        run_solve, num_runs=args.runs, warmup=args.warmup
    )
    # deterministic solve: one extra run supplies the checksummed solution
    _, (x, _st) = run_solve(keep_x=True)

    # MEASURED multi-process rank timing (reference MPI_Barrier → solve → MPI_Reduce
    # MAX/MIN of rank timers, cg_solver_mgpu_partitioned.cu:405, 749-800): one extra
    # barrier-aligned solve, host durations allgathered across processes.  None (and the
    # structural lockstep argument) in single-process runs.
    rank_times = None
    if jax.process_count() > 1:
        from ..dist import barrier, rank_time_stats

        barrier("tpusparse:rank_timing_start")
        t_rank = time.perf_counter()
        run_solve()
        rank_times = rank_time_stats(time.perf_counter() - t_rank)

    if args.trace:
        from ..bench import profiling

        profiling.profiled_run(lambda: run_solve()[1][0], logdir=args.trace)
        if is_primary:
            print(f"[INFO] trace captured: {args.trace}")

    if mesh2d:
        import types

        from ..generate import stencil5_nnz

        op = types.SimpleNamespace(num_rows=g * g, num_cols=g * g,
                                   nnz=stencil5_nnz(g), grid_size=g, mode=args.mode)
        if is_primary:
            print("Load imbalance:      0.00% (2-D blocks require exact divisibility; "
                  "SPMD lockstep)")
    else:
        if is_primary:
            # Load-imbalance report, printed always (reference cg_solver_mgpu_partitioned
            # .cu:758-773 MAX/MIN rank-timer reduction).  Multi-process runs print the
            # MEASURED barrier-aligned per-process skew; single-process SPMD runs ONE
            # fused program in lockstep, so the only imbalance source is the row-padding
            # remainder — report that bound instead of redundant per-shard timers.
            if rank_times is not None:
                print(f"Load imbalance:      {rank_times['load_imbalance_pct']:.2f}% "
                      f"(measured: max {rank_times['solve_time_max_ms']:.2f} / min "
                      f"{rank_times['solve_time_min_ms']:.2f} ms across "
                      f"{jax.process_count()} processes)")
            else:
                band = (g + op.row_pad) // nchips
                imbalance = 100.0 * op.row_pad / band if band else 0.0
                print(f"Load imbalance:      {imbalance:.2f}% "
                      f"(row padding {op.row_pad} of band {band}; SPMD lockstep otherwise)")
    from ..dist import gather_to_host

    # multi-process arrays are not fully addressable: the gather helper handles both cases
    # (the MPI_Gatherv analog, cg_solver_mgpu_partitioned.cu:834-851).  Timed: the
    # reference reports it as CGStatsMultiGPU time_allgather (cg_solver_mgpu.h:55-67).
    # Only a REAL device gather is timed — on padded grids (g % chips != 0) the solver
    # already gathered to host internally and timing a numpy view would report a
    # meaningless ~0 ms; the field is omitted rather than faked.
    was_device = isinstance(x, jax.Array)
    t_gather = time.perf_counter()
    x_host = np.asarray(gather_to_host(x), np.float64).ravel()[: g * g]
    allgather_ms = (time.perf_counter() - t_gather) * 1e3 if was_device else None
    # gflops_spmv only when the SpMV phase was actually measured (--timers stepped loop);
    # the fused device-native solve has no per-phase breakdown and the field is OMITTED
    # rather than fabricated from an invented share (reference computes it from measured
    # spmv time, cg_metrics.cu:~120).
    gfl = (metrics.cg_gflops(op.nnz, cg_stats.iterations, cg_stats.spmv_time_ms)
           if cg_stats.spmv_time_ms > 0 else None)
    result = export.cg_result_dict(
        # op.mode, not args.mode: a padded stencil5-const request falls back to values-
        # carrying stencil5 and the record must say what actually ran
        solver=(f"tpusparse-cg-sharded2d-{mesh2d[0]}x{mesh2d[1]}" if mesh2d
                else f"tpusparse-cg-sharded-{nchips}chip"), mode=op.mode,
        matrix_name=matrix_name, op=op, cg_stats=cg_stats, bench_stats=bench,
        sysinfo=info, sum_x=float(x_host.sum()), norm2_x=float(np.linalg.norm(x_host)),
        gflops_spmv=gfl,
        extra_timing={"num_chips": nchips,
                      **({"allgather_ms": allgather_ms}
                         if allgather_ms is not None else {}),
                      # self-describing artifact: the sharded csr mode is the band-local
                      # XLA-gather comparison kernel
                      **({"spmv_kernel": "band-local XLA gather (comparison kernel)"}
                         if op.mode == "csr" else {}),
                      # measured cross-process MAX/MIN + imbalance (reference
                      # CGStatsMultiGPU :749-800); absent in single-process runs
                      **(rank_times or {})},
    )
    if is_primary:
        export.print_human_cg(result)
        if args.json:
            export.write_json(args.json, result)
            print(f"[INFO] JSON written: {args.json}")
        if args.csv:
            export.append_csv(args.csv, result)
    return 0 if cg_stats.converged else 1


if __name__ == "__main__":
    sys.exit(main())
