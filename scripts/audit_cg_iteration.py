#!/usr/bin/env python
"""Per-iteration memory traffic audit of the CG loop.

Decomposes one CG iteration at a benchmark grid into its measured phase kernel times
(paired-chain slope protocol, the same discipline as ops.DeviceOperator.kernel_time_ms)
and checks that the phases SUM to the measured fused-loop per-iteration time — the analog
of the reference's per-phase iteration breakdown (docs/PROFILING_ANALYSIS.md:21-38).

Phases of the classic 3-pass values-free loop (11 words/pt/iter):
    spmv_dot   (A·p, <p,Ap>)            1R + 1W = 2 words/pt
    update     (x += αp, r −= αAp, rr)  4R + 2W = 6 words/pt
    p_update   (p = r + βp)             2R + 1W = 3 words/pt
and of the round-5 recompute-Ap loop (8 words/pt/iter):
    pass A     (p' = r + βp, <p',Ap'>)  2R + 1W = 3 words/pt
    pass B     (x', r', <r',r'>, Ap' recomputed)  3R + 2W = 5 words/pt

Also measures both full solves (fused while_loop, b = ones) and a 0-iteration solve
(the fixed dispatch/readback overhead), so the audit closes end-to-end:
    phases_sum ≈ (solve_ms − fixed_ms) / iterations

Writes cg_iter_audit_<g>_<device>.json (``--out`` overrides), the device named as JAX
reports it.

    python scripts/audit_cg_iteration.py [--grid 20480] [--reps 3]
"""

import argparse
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpusparse import ops  # noqa: E402
from tpusparse.bench.probes import slope_seconds  # noqa: E402
from tpusparse.bench import sysinfo  # noqa: E402
from tpusparse.dist import enable_compilation_cache  # noqa: E402
from tpusparse.formats import Stencil5  # noqa: E402
from tpusparse.solvers import cg  # noqa: E402


def _sync(tree):
    return jax.block_until_ready(tree)


def chain_slope_ms(step, carry0, consts=(), k_lo=4, k_hi=16, reps=3):
    """Per-apply ms of ``carry' = step(carry, consts)`` via paired-chain differencing
    inside one jitted program (fusion fence between applies — see
    ops.DeviceOperator._chain_program).  ``consts`` are the loop-invariant device fields
    the step reads — passed as JIT ARGUMENTS, never closed over (a closed-over (g, g)
    field becomes a multi-GB inline constant in the compiled program — the
    operator-registry invariant, ops._wrap_ops)."""

    @functools.partial(jax.jit, static_argnames=("k",))
    def prog(carry, consts, k):
        for _ in range(k):
            carry = step(carry, consts)
            carry = jax.lax.optimization_barrier(carry)
        return carry

    _sync(prog(carry0, consts, k=k_lo))  # compile + warm
    _sync(prog(carry0, consts, k=k_hi))

    def best(k):
        b = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            _sync(prog(carry0, consts, k=k))
            b = min(b, time.perf_counter() - t0)
        return b

    return slope_seconds(best(k_lo), best(k_hi), k_lo, k_hi) * 1e3


def timed_solve(op, b_sds, cfg, recompute_ap, warmup=2, runs=5):
    times, iters = [], None
    for i in range(warmup + runs):
        x, stats = cg.cg_solve(op, b_sds, config=cfg, b_is_ones=True,
                               recompute_ap=recompute_ap)
        if i >= warmup:
            times.append(stats.total_time_ms)
        iters = stats.iterations
        del x
    times.sort()
    return times[len(times) // 2], iters, stats.converged


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=20480)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    enable_compilation_cache()
    g = args.grid
    info = sysinfo.get_system_info()
    print(f"[audit] device {info['device_kind']}, grid {g}", file=sys.stderr)

    st = Stencil5(grid_size=g, planes=None, constant=(5.0, -1.0))
    op = ops.get_operator("stencil5-const", st)
    dot_op = op.run_device_dot_op
    pupd_dot = op.run_pupdate_dot_op
    upd_rec = op.run_update_recompute_op
    operands = op.operands
    dt = jnp.float32
    words = lambda w: w * g * g * 4 / 1e9  # GB moved at w words/pt  # noqa: E731

    # deterministic non-trivial fields (iota-based: no 3.4 GB host uploads)
    def field(seed):
        a = jax.lax.broadcasted_iota(dt, (g, g), 0) * (1e-6 * (seed + 1))
        b = jax.lax.broadcasted_iota(dt, (g, g), 1) * (3e-7 * (seed + 2))
        return jnp.sin(a) + jnp.cos(b)

    mk = jax.jit(field, static_argnums=0)
    p0 = mk(0)
    r_const = mk(1)
    phases = {}

    # --- classic loop phases ---
    def spmv_dot_step(carry, _c):
        p, _s = carry
        # pap rides the carry (a jit OUTPUT, so never DCE'd) — folding it into the field
        # would add a full extra elementwise pass and corrupt the 2-word measurement
        return dot_op(p, operands)

    phases["spmv_dot"] = {"words_pt": 2, "ms": chain_slope_ms(
        spmv_dot_step, (p0, jnp.float32(0.0)), reps=args.reps)}
    print(f"[audit] spmv_dot: {phases['spmv_dot']['ms']:.2f} ms", file=sys.stderr)

    def update_step(carry, consts):
        x, r, rr = carry
        pc, apc = consts
        alpha = (0.5 + rr * 1e-30).astype(dt)  # scalar dependency chains the passes
        x = x + alpha * pc
        r = r - alpha * apc  # apc stands in for Ap (same traffic)
        rr = jnp.vdot(r, r)
        return x, r, rr

    phases["update"] = {"words_pt": 6, "ms": chain_slope_ms(
        update_step, (mk(2), mk(3), jnp.float32(1.0)), (p0, r_const),
        reps=args.reps)}
    print(f"[audit] update: {phases['update']['ms']:.2f} ms", file=sys.stderr)

    def pupdate_step(p, consts):
        (rc,) = consts
        return rc + jnp.float32(0.5) * p

    phases["p_update"] = {"words_pt": 3, "ms": chain_slope_ms(
        pupdate_step, p0, (r_const,), reps=args.reps)}
    print(f"[audit] p_update: {phases['p_update']['ms']:.2f} ms", file=sys.stderr)

    # --- recompute loop phases ---
    def pass_a_step(carry, consts):
        p, s = carry
        (rc,) = consts
        pnew, pap = pupd_dot((0.5 + s * 1e-30).astype(dt), rc, p, operands)
        return pnew, pap

    phases["recompute_pass_a"] = {"words_pt": 3, "ms": chain_slope_ms(
        pass_a_step, (p0, jnp.float32(1.0)), (r_const,), reps=args.reps)}
    print(f"[audit] pass A: {phases['recompute_pass_a']['ms']:.2f} ms", file=sys.stderr)

    # pass B's chain holds 5 live (g, g) fields (p0 const + x/r in + x/r out) — at
    # 20480² that is 8.4 GB; every other field must be freed first or the 16 GB chip
    # ResourceExhausts (measured in the round-5 campaign's first audit run)
    del r_const

    def pass_b_step(carry, consts):
        x, r, rr = carry
        (pc,) = consts
        return upd_rec((0.5 + rr * 1e-30).astype(dt), x, r, pc, operands)

    phases["recompute_pass_b"] = {"words_pt": 5, "ms": chain_slope_ms(
        pass_b_step, (mk(2), mk(3), jnp.float32(1.0)), (p0,), reps=args.reps)}
    print(f"[audit] pass B: {phases['recompute_pass_b']['ms']:.2f} ms", file=sys.stderr)

    for v in phases.values():
        v["gbs"] = words(v["words_pt"]) / (v["ms"] / 1e3)

    del p0
    # --- full solves (b = ones synthesized in-graph) + fixed overhead ---
    b_sds = jax.ShapeDtypeStruct((g, g), dt)
    fixed_ms, _, _ = timed_solve(op, b_sds, cg.CGConfig(max_iters=0), False,
                                 warmup=1, runs=3)
    classic_ms, it_c, conv_c = timed_solve(op, b_sds, cg.CGConfig(max_iters=100), False,
                                           runs=args.runs)
    recomp_ms, it_r, conv_r = timed_solve(op, b_sds, cg.CGConfig(max_iters=100), True,
                                          runs=args.runs)
    assert conv_c and conv_r, (conv_c, conv_r)

    classic_sum = sum(phases[k]["ms"] for k in ("spmv_dot", "update", "p_update"))
    recomp_sum = phases["recompute_pass_a"]["ms"] + phases["recompute_pass_b"]["ms"]
    out = {
        "grid": g,
        "mode": "stencil5-const",
        "dtype": "float32",
        "device": info,
        "protocol": "paired-chain slope per phase (fusion fence between applies); "
                    "median fused solves; fixed = 0-iteration solve",
        "phases": phases,
        "fixed_overhead_ms": fixed_ms,
        "classic_loop": {
            "solve_ms": classic_ms, "iterations": it_c,
            "per_iter_ms": (classic_ms - fixed_ms) / max(it_c, 1),
            "phase_sum_ms": classic_sum,
            "words_pt_per_iter": 11,
        },
        "recompute_loop": {
            "solve_ms": recomp_ms, "iterations": it_r,
            "per_iter_ms": (recomp_ms - fixed_ms) / max(it_r, 1),
            "phase_sum_ms": recomp_sum,
            "words_pt_per_iter": 8,
        },
    }
    out["classic_loop"]["closure_pct"] = 100 * classic_sum / out["classic_loop"][
        "per_iter_ms"]
    out["recompute_loop"]["closure_pct"] = 100 * recomp_sum / out["recompute_loop"][
        "per_iter_ms"]
    kind = info["device_kind"].lower().replace(" ", "_")
    path = args.out or f"cg_iter_audit_{g}_{kind}.json"
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(json.dumps({k: v for k, v in out.items() if k != "device"}, indent=2))
    print(f"[audit] written: {path}", file=sys.stderr)


if __name__ == "__main__":
    main()
