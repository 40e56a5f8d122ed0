"""Benchmark of the reference's own protocol.  Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

The metric: full CG time-to-solution at 20000² (400M unknowns, 2.0B nnz, tol 1e-6,
b = ones, x0 = 0) with the f64 values-carrying ``stencil5`` operator — the reference's
largest published single-card configuration, same precision and byte model.
vs_baseline = reference_time / our_time against its published single-A100 f64 number
(531.4 ms, BASELINE.md): > 1 means faster than the reference's headline GPU.  Iteration
parity (14) is asserted, not assumed.  There is one path, through the operator registry; any
failure, or a backend without a GPU, exits non-zero.

The parent process stays off JAX and runs the measurement in one child, so exactly one
process holds the card.
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))  # cwd-independent import

REF_20K_MS = 531.4  # reference cg 20000², 1×A100-SXM f64 (BASELINE.md / README.md:55)
REF_ITERS = 14
GRID = 20000


def bench_cg_20k() -> dict:
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from tpusparse import dist, ops
    from tpusparse.bench.stats import compute_stats
    from tpusparse.bench.sysinfo import get_system_info
    from tpusparse.formats import Stencil5
    from tpusparse.solvers import cg

    if jax.default_backend() != "gpu":
        raise RuntimeError(f"the benchmark needs a GPU, JAX found {jax.default_backend()!r}")
    dist.enable_compilation_cache()
    info = get_system_info()
    op = ops.get_operator("stencil5", Stencil5(grid_size=GRID, planes=None,
                                               constant=(5.0, -1.0)), dtype=jnp.float64)
    # shape/dtype only: b = ones and x0 = 0 are synthesized inside the compiled solve
    b = jax.ShapeDtypeStruct((GRID, GRID), jnp.float64)
    times = []
    # the framework's own protocol (bench/stats.py, parity with the reference's
    # benchmark_stats.cu:39-89): 3 warmups discarded, 10 timed runs, 2σ outlier rejection
    for i in range(13):
        x, stats = cg.cg_solve(op, b, b_is_ones=True)
        del x
        if not stats.converged or stats.iterations != REF_ITERS:
            raise RuntimeError(f"expected {REF_ITERS} converged iterations, got "
                               f"{stats.iterations} (converged={stats.converged})")
        if i >= 3:
            times.append(stats.total_time_ms)
    s = compute_stats(times)
    card = (info.get("nvidia_smi") or [{}])[0]
    print(f"[bench] cg {GRID}^2 stencil5 f64: median {s.median_ms:.3f} ms, {REF_ITERS} "
          f"iterations on {info['device_kind']} ({card.get('power.limit')}); reference "
          f"A100 f64: {REF_20K_MS} ms", file=sys.stderr)
    return {
        "metric": "cg_20000sq_time_ms_stencil5_f64",
        "value": s.median_ms,
        "unit": "ms_median_vs_a100_f64_531.4",
        "vs_baseline": REF_20K_MS / s.median_ms,
        "iterations": REF_ITERS,
        "total_runs": s.total_runs,
        "valid_runs": s.valid_runs,
        "std_ms": s.std_ms,
        "device": {"platform": info["platform"], "kind": info["device_kind"],
                   "count": info["num_devices"], "power_limit": card.get("power.limit")},
    }


def main() -> int:
    if "--child" in sys.argv:
        print(json.dumps(bench_cg_20k()))
        return 0
    # the parent never imports JAX: the child alone holds the card
    proc = subprocess.run([sys.executable, "-u", os.path.abspath(__file__), "--child"],
                          capture_output=True, text=True, timeout=1800)
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode != 0:
        return proc.returncode
    print(proc.stdout.strip().splitlines()[-1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
