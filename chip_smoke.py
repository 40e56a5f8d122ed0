#!/usr/bin/env python3
"""Start tpusparse's main path on an NVIDIA GPU and check what comes out.

    python chip_smoke.py          # one card: phases (a)-(e) below
    python chip_smoke.py --four   # four cards: the sharded solver, and nothing else

One process holds the card(s) and the compile cache for every phase.  Phases, on one card:

  (a) ``cg_solver gen:20000 --mode=stencil5 --dtype=f64`` — the reference's largest
      single-card problem (2-D 5-point Laplacian + mass term, b = ones, x0 = 0, tol 1e-6).
      Exactly 14 iterations; the true relative residual ||b - Ax|| / ||b|| is recomputed
      with this script's own plain operator and must be below 1e-6.
  (b) ``cg_solver gen:20480 --mode=stencil5-const --dtype=f32`` with the default loop:
      converges in 14 ± 1 iterations (f32 sums are order-dependent).
  (c) every stencil mode's SpMV+dot at 20000² (f64 and f32 state; bf16c planes), as
      compiled for the card — the Triton kernel included — against a numpy f64 reference
      over three 256-row bands (first, middle, last), and its dot against XLA's.
  (d) every registered mode through ``spmv_bench gen:2048`` at the analytic checksums.
  (e) A/B: the Triton SpMV+dot kernel (``stencil5`` in f64) against XLA (``stencil5-xla``)
      inside the full 20000² f64 CG, and the classic against the recompute-Ap loop at
      20480² f32; times, loop kernel counts and compiled memory.

Each phase raises on failure, so the script exits non-zero.  The last line of standard
output is one JSON object naming the device; it is printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import re
import statistics
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
G = 20000  # the reference's largest published single-card grid
G_CONST = 20480  # the constant-coefficient f32 headline grid
REF_ITERS = 14
BAND = 256
# tolerances of the band comparison, relative to the band's largest |y|: f64 may move in the
# last ulps (FMA contraction); f32 and bf16c planes (5, -1 and 0 are exact in bf16) round x
RTOL = {"float64": 1e-12, "float32": 1e-5}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    """Each card's name and power limit, as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them."""
    from tpusparse.bench.sysinfo import query_nvidia_smi

    cards = query_nvidia_smi()
    check(cards, "nvidia-smi reported no card")
    return "; ".join(f"{c['name']}, {c['power.limit']}" for c in cards)


def bands(g: int, band: int = 0):
    """Row ranges [r0, r1) of the first, the middle and the last band: both Dirichlet edges."""
    band = band or BAND
    mid = g // 2 - band // 2
    return [(0, band), (mid, mid + band), (g - band, g)]


def band_reference(x_rows, r0: int, r1: int, g: int, diag: float = 5.0,
                   offdiag: float = -1.0) -> np.ndarray:
    """Rows [r0, r1) of y = A·x for the (g·g) Dirichlet 5-point operator, in f64 numpy.

    ``x_rows`` holds the field rows [max(r0 - 1, 0), min(r1 + 1, g)): the band and the
    neighbour row on each side that exists."""
    lo = max(r0 - 1, 0)
    x = np.asarray(x_rows, np.float64)
    check(x.shape == (min(r1 + 1, g) - lo, g), f"band rows {x.shape} for [{r0}, {r1})")
    pad = np.zeros((r1 - r0 + 2, g + 2))
    pad[1:-1, 1:-1] = x[r0 - lo: r1 - lo]
    if r0 > 0:
        pad[0, 1:-1] = x[0]
    if r1 < g:
        pad[-1, 1:-1] = x[-1]
    core = pad[1:-1, 1:-1]
    return diag * core + offdiag * (pad[:-2, 1:-1] + pad[2:, 1:-1] + pad[1:-1, :-2]
                                    + pad[1:-1, 2:])


def plain_apply(x, diag: float = 5.0, offdiag: float = -1.0):
    """A·x for the Dirichlet 5-point operator, written independently of the package."""
    import jax.numpy as jnp

    p = jnp.pad(x, 1)
    return diag * x + offdiag * (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:])


def loop_kernels(hlo_text: str) -> dict:
    """Opcode counts of the top-level instructions in the body of the first while loop of a
    compiled HLO module: each fusion or custom call is one kernel launch per iteration."""
    m = re.search(r"while\(.*?body=%?([\w.\-]+)", hlo_text)
    check(m is not None, "no while loop in the compiled solve")
    body = re.search(r"^%?" + re.escape(m.group(1)) + r" .*?\{\n(.*?)^\}", hlo_text,
                     re.M | re.S)
    check(body is not None, f"while body {m.group(1)} not found")
    counts = {}
    for line in body.group(1).splitlines():
        op = re.match(r"\s*(?:ROOT )?%?[\w.\-]+ = .*? ([a-z][\w\-]*)\(", line)
        if op and op.group(1) not in ("parameter", "get-tuple-element", "tuple", "constant",
                                      "bitcast"):
            counts[op.group(1)] = counts.get(op.group(1), 0) + 1
    return counts


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def _free():
    import tpusparse

    tpusparse.clear_caches()
    gc.collect()


def _stencil(g):
    from tpusparse.formats import Stencil5

    return Stencil5(grid_size=g, planes=None, constant=(5.0, -1.0))


def phase_a(tmp):
    import jax
    import jax.numpy as jnp

    from tpusparse import ops
    from tpusparse.cli import cg_solver
    from tpusparse.solvers import cg

    out = os.path.join(tmp, "a.json")
    rc = cg_solver.main([f"gen:{G}", "--mode=stencil5", "--dtype=f64", "--runs=3",
                         "--warmup=1", f"--json={out}"])
    r = _read_json(out)
    it, conv = r["convergence"]["iterations"], r["convergence"]["converged"]
    s, n2 = r["validation"]["solution_sum"], r["validation"]["solution_norm"]
    print(f"[a] cg_solver gen:{G} stencil5 f64: rc {rc}, iterations {it}, converged {conv}, "
          f"median {r['timing']['total_median_ms']:.3f} ms")
    print(f"[a] Sum(x) = {s:.16f}  Norm2(x) = {n2:.16f}")
    check(rc == 0 and conv and it == REF_ITERS, f"(a) expected {REF_ITERS} converged "
          f"iterations, got {it} (converged={conv}, rc={rc})")
    _free()
    # the same solve through the library, to recompute the true residual on the card
    op = ops.get_operator("stencil5", _stencil(G), dtype=jnp.float64)
    x, st = cg.cg_solve(op, jax.ShapeDtypeStruct((G, G), jnp.float64), b_is_ones=True)
    del op
    _free()
    res = float(jnp.linalg.norm(1.0 - plain_apply(x))) / G  # ||b|| = g for b = ones
    s2, n22 = float(jnp.sum(x)), float(jnp.linalg.norm(x))
    print(f"[a] true relative residual ||b - Ax||/||b|| = {res:.3e} (plain operator); "
          f"library solve: {st.iterations} iterations, Sum(x) = {s2:.16f}")
    check(res < 1e-6, f"(a) true relative residual {res:.3e} >= 1e-6")
    check(st.iterations == REF_ITERS, f"(a) library solve took {st.iterations} iterations")
    check(abs(s2 - s) <= 1e-10 * abs(s) and abs(n22 - n2) <= 1e-10 * n2,
          f"(a) library solve checksums ({s2}, {n22}) differ from the CLI's ({s}, {n2})")


def phase_b(tmp):
    from tpusparse.cli import cg_solver

    out = os.path.join(tmp, "b.json")
    rc = cg_solver.main([f"gen:{G_CONST}", "--mode=stencil5-const", "--dtype=f32",
                         "--runs=3", "--warmup=1", f"--json={out}"])
    r = _read_json(out)
    it, conv = r["convergence"]["iterations"], r["convergence"]["converged"]
    print(f"[b] cg_solver gen:{G_CONST} stencil5-const f32 (loop {r.get('loop')}): rc {rc}, "
          f"iterations {it}, converged {conv}, median "
          f"{r['timing']['total_median_ms']:.3f} ms, Sum(x) = "
          f"{r['validation']['solution_sum']:.10f}")
    check(rc == 0 and conv and abs(it - REF_ITERS) <= 1,
          f"(b) expected {REF_ITERS} ± 1 converged iterations, got {it} (converged={conv})")
    _free()


def phase_c():
    import jax
    import jax.numpy as jnp

    from tpusparse import ops

    print(f"[c] band reference: rows {bands(G)} of {G}^2; tolerance relative to the band's "
          f"largest |y|: f64 {RTOL['float64']:g}, f32 and bf16c {RTOL['float32']:g}")
    modes = [m for m in ops.available_modes() if m.startswith("stencil5")]
    for dtype in (jnp.float64, jnp.float32):
        name = jnp.dtype(dtype).name
        x = jax.random.normal(jax.random.PRNGKey(7), (G, G), dtype)
        xh = {r: np.asarray(x[max(r[0] - 1, 0):min(r[1] + 1, G)]) for r in bands(G)}
        op = ops.get_operator("stencil5-xla", _stencil(G), dtype=dtype)
        d_ref = float(op.run_device_dot(x)[1])
        del op
        for mode in modes:
            op = ops.get_operator(mode, _stencil(G), dtype=dtype)
            y, d = op.run_device_dot(x)
            check(y.shape == (G, G) and y.dtype == dtype, f"(c) {mode} {name}: y is "
                  f"{y.dtype}{y.shape}")
            err = 0.0
            for (r0, r1), rows in xh.items():
                ref = band_reference(rows, r0, r1, G)
                got = np.asarray(y[r0:r1], np.float64)
                err = max(err, float(np.max(np.abs(got - ref)) / np.max(np.abs(ref))))
            derr = abs(float(d) - d_ref) / abs(d_ref)
            print(f"[c] {mode:20s} {name}: max band error {err:.3e}, dot rel diff vs "
                  f"stencil5-xla {derr:.3e}")
            check(err < RTOL[name] and derr < RTOL[name],
                  f"(c) {mode} {name}: band error {err:.3e} or dot error {derr:.3e} >= "
                  f"{RTOL[name]:g}")
            del op, y, d
            _free()
        del x


def phase_d(tmp):
    from tpusparse import generate, ops
    from tpusparse.cli import spmv_bench

    g = 2048
    modes = ops.available_modes()
    base = os.path.join(tmp, "d.json")
    rc = spmv_bench.main([f"gen:{g}", "--mode=" + ",".join(modes), "--dtype=f64",
                          "--runs=3", "--warmup=1", f"--json={base}"])
    check(rc == 0, f"(d) spmv_bench returned {rc}")
    s_ref, n_ref = generate.stencil5_spmv_checksums(g)
    for mode in modes:
        r = _read_json(os.path.join(tmp, f"d_{mode}.json"))
        v = r["benchmark"]["validation"]
        es = abs(v["sum_y"] - s_ref) / abs(s_ref)
        en = abs(v["norm2_y"] - n_ref) / n_ref
        print(f"[d] {mode:20s} Sum(y) {v['sum_y']:.10f} Norm2(y) {v['norm2_y']:.10f} "
              f"(rel err {es:.1e}, {en:.1e}); kernel "
              f"{r['benchmark']['performance']['time_kernel_ms']:.4f} ms")
        check(es < 1e-12 and en < 1e-12, f"(d) {mode}: checksums off the analytic values")
    _free()


def _ab(label_a, solve_a, label_b, solve_b, rounds=3):
    """Alternate a, b, b, a; return the median of each and the last results."""
    times = {label_a: [], label_b: []}
    for _ in range(rounds):
        for label, solve in ((label_a, solve_a), (label_b, solve_b), (label_b, solve_b),
                             (label_a, solve_a)):
            x, st = solve()
            check(st.converged, f"(e) {label} did not converge")
            times[label].append(st.total_time_ms)
            del x
    return {k: statistics.median(v) for k, v in times.items()}, times


def phase_e(card):
    import jax
    import jax.numpy as jnp

    from tpusparse import ops
    from tpusparse.solvers import cg

    # (e1) the Triton SpMV+dot (stencil5 in f64 on the GPU) against XLA's (stencil5-xla),
    # inside the full 20000^2 f64 solve
    op = ops.get_operator("stencil5-xla", _stencil(G), dtype=jnp.float64)
    op_t = ops.get_operator("stencil5", _stencil(G), dtype=jnp.float64)
    b = jax.ShapeDtypeStruct((G, G), jnp.float64)
    for label, o in (("xla", op), ("triton", op_t)):
        compiled = cg._build_solver(o.run_device_dot_op, None, 1000, 1e-6, b,
                                    ("smoke-e", label), synth_b=True).lower(
                                        o.operands).compile()
        print(f"[e] stencil5 f64 {G}^2 CG loop kernels ({label}): "
              f"{loop_kernels(compiled.as_text())}; {compiled.memory_analysis()}")
    res = {}
    for label, o in (("xla", op), ("triton", op_t)):
        x, st = cg.cg_solve(o, b, b_is_ones=True)  # warm-up, compiles
        check(st.iterations == REF_ITERS, f"(e) {label}: {st.iterations} iterations")
        res[label] = float(jnp.sum(x))
        del x
    check(abs(res["xla"] - res["triton"]) <= 1e-10 * abs(res["xla"]),
          f"(e) triton solve Sum(x) {res['triton']} vs xla {res['xla']}")
    med, times = _ab("xla", lambda: cg.cg_solve(op, b, b_is_ones=True),
                     "triton", lambda: cg.cg_solve(op_t, b, b_is_ones=True))
    print(f"[e] A/B stencil5 f64 {G}^2 CG, {REF_ITERS} iterations, on {card}: "
          f"xla median {med['xla']:.3f} ms, triton median {med['triton']:.3f} ms "
          f"(runs: {json.dumps(times)})")
    del op, op_t
    _free()

    # (e2) classic 3-pass loop against the recompute-Ap loop, 20480^2 f32 const
    op = ops.get_operator("stencil5-const", _stencil(G_CONST), dtype=jnp.float32)
    b = jax.ShapeDtypeStruct((G_CONST, G_CONST), jnp.float32)
    for label, rec in (("classic", False), ("recompute", True)):
        key = ("smoke-e2", label)
        recomp = (op.run_pupdate_dot_op, op.run_update_recompute_op) if rec else None
        compiled = cg._build_solver(op.run_device_dot_op, None, 1000, 1e-6, b, key,
                                    synth_b=True, recomp=recomp).lower(op.operands).compile()
        print(f"[e] stencil5-const f32 {G_CONST}^2 CG loop kernels ({label}): "
              f"{loop_kernels(compiled.as_text())}; {compiled.memory_analysis()}")
        cg.cg_solve(op, b, b_is_ones=True, recompute_ap=rec)  # warm-up, compiles
    med, times = _ab(
        "classic", lambda: cg.cg_solve(op, b, b_is_ones=True, recompute_ap=False),
        "recompute", lambda: cg.cg_solve(op, b, b_is_ones=True, recompute_ap=True))
    print(f"[e] A/B stencil5-const f32 {G_CONST}^2 CG on {card}: classic median "
          f"{med['classic']:.3f} ms, recompute median {med['recompute']:.3f} ms "
          f"(runs: {json.dumps(times)})")
    _free()


def overlap_finding(mesh):
    """Does the compiled 4-card 1-D solve bracket interior work with the halo permutes?"""
    import jax.numpy as jnp

    from tpusparse.solvers import cg_sharded

    op = cg_sharded.make_sharded_operator(mesh, G, mode="stencil5", dtype=jnp.float64)
    hlo = cg_sharded._build_sharded_solver(op, 1000, 1e-6, synth_b=True).lower(
        op.operands_arg).compile().as_text()
    lines = hlo.splitlines()
    starts = [i for i, ln in enumerate(lines) if "collective-permute-start(" in ln]
    dones = [i for i, ln in enumerate(lines) if "collective-permute-done(" in ln]
    if not starts or not dones:
        print(f"[four] overlap: no async collective-permute pair in the compiled HLO "
              f"({sum('collective-permute(' in ln for ln in lines)} synchronous permutes)")
        return
    between = [ln for ln in lines[starts[0] + 1:dones[-1]] if " fusion(" in ln]
    print(f"[four] overlap: {len(starts)} collective-permute-start / {len(dones)} -done; "
          f"{len(between)} fusion(s) scheduled between the first start and the last done")


def run_four():
    import jax

    from tpusparse.cli import cg_solver_multichip
    from tpusparse.dist import make_band_mesh

    check(jax.device_count() >= 4, f"--four needs 4 devices, have {jax.device_count()}")
    print(f"[four] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    results = {}
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        for label, extra in (("1-device", ["--chips=1"]), ("4-card 1-D", ["--chips=4"]),
                             ("4-card 2x2", ["--mesh2d=2x2"])):
            out = os.path.join(tmp, f"{len(results)}.json")
            rc = cg_solver_multichip.main([f"gen:{G}", "--dtype=f64", "--runs=3",
                                           "--warmup=1", f"--json={out}", *extra])
            r = _read_json(out)
            it = r["convergence"]["iterations"]
            s, n2 = r["validation"]["solution_sum"], r["validation"]["solution_norm"]
            results[label] = (it, s, n2)
            print(f"[four] {label}: rc {rc}, iterations {it}, median "
                  f"{r['timing']['total_median_ms']:.3f} ms, Sum(x) = {s:.16f}, "
                  f"Norm2(x) = {n2:.16f}")
            check(rc == 0 and it == REF_ITERS, f"[four] {label}: {it} iterations, rc {rc}")
            _free()
    _, s1, n1 = results["1-device"]
    for label in ("4-card 1-D", "4-card 2x2"):
        _, s, n2 = results[label]
        ds, dn = abs(s - s1) / abs(s1), abs(n2 - n1) / n1
        print(f"[four] {label} vs 1-device: Sum rel {ds:.3e}, Norm2 rel {dn:.3e}")
        check(ds <= 1e-10 and dn <= 1e-10, f"[four] {label} checksums differ from 1-device")
    overlap_finding(make_band_mesh(4))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the sharded 4-card solver against a 1-device mesh, only")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: needs a GPU backend, JAX found {jax.default_backend()!r}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    jax.config.update("jax_enable_x64", True)
    from tpusparse.dist import enable_compilation_cache

    print(f"[setup] compile cache: {enable_compilation_cache()}")
    card = card_line()
    print(f"card: {card}")
    dev = jax.devices()[0]
    print(f"[setup] jax {jax.__version__}, {jax.device_count()} x {dev.device_kind}")
    t0 = time.perf_counter()
    if args.four:
        run_four()
    else:
        with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
            for name, phase in (("a", lambda: phase_a(tmp)), ("b", lambda: phase_b(tmp)),
                                ("c", phase_c), ("d", lambda: phase_d(tmp)),
                                ("e", lambda: phase_e(card))):
                t = time.perf_counter()
                phase()
                print(f"[{name}] passed in {time.perf_counter() - t:.1f} s")
    print(f"[done] {time.perf_counter() - t0:.1f} s; card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": dev.platform,
                                              "kind": dev.device_kind,
                                              "count": jax.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
