"""Measured-achievable memory bandwidth probes — the empirical roofline ceiling.

The published peak (metrics.CHIP_SPECS) is a data-sheet number; judging kernels against it
systematically under-reports them (the reference's "95% of peak" roofline claim is against its
own nsys-measured ceiling, docs/PROFILING_ANALYSIS.md:88-97).  This module measures what THIS
card + runtime actually sustains, and exporters then report ``roofline_fraction_achievable``
(vs the probe) alongside ``roofline_fraction`` (vs published).

Protocol: PAIRED-ITERATION DIFFERENCING.  Each probe is a jitted ``lax.fori_loop`` doing k
dependent passes over device-resident arrays; it is timed at k_lo and k_hi and the bandwidth
is computed from the SLOPE (t_hi − t_lo)/(k_hi − k_lo).  The subtraction cancels every fixed
cost — dispatch, the final sync, loop setup — which single-shot timing silently charges to the
kernel.

Probes (byte model per pass over an n-element f32 array):
  read   — carry-dependent reduction  s += Σ(x·s):  4n B   (pure read)
  copy   — carried scale              x ← c·x:      8n B   (read + write)
  triad  — carried axpy               a ← b + s·a: 12n B   (2 reads + write)

The carry-dependence defeats CSE/hoisting (each pass must re-read its input), and
``fori_loop`` stays a loop — XLA cannot algebraically collapse the passes.
"""

from __future__ import annotations

import time
from typing import Dict

import jax
import jax.numpy as jnp


def _timed_best(fn, args, reps: int) -> float:
    jax.block_until_ready(fn(*args))  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def _read_probe(iters: int):
    @jax.jit
    def run(x):
        def body(_, s):
            # s-dependence forces a fresh full read of x each pass (no CSE/hoist); the
            # scalar-feeding multiply fuses into the reduction (no materialized temp)
            return s + jnp.sum(x * s) * 1e-30
        return jax.lax.fori_loop(0, iters, body, jnp.ones((), x.dtype))
    return run


def _copy_probe(iters: int):
    @jax.jit
    def run(x):
        def body(_, v):
            return v * 1.0000001
        return jax.lax.fori_loop(0, iters, body, x)
    return run


def _triad_probe(iters: int):
    @jax.jit
    def run(a, b):
        def body(_, v):
            return b + 0.999 * v
        return jax.lax.fori_loop(0, iters, body, a)
    return run


def _mix7_probe(iters: int):
    """6-read:1-write mix — the values-carrying stencil kernel's exact access pattern
    (5 coefficient streams + x read + y write, 7 words/element/pass).  Exists to give the
    flagship stencil5 artifacts a ceiling measured for THEIR mix: a single-stream read
    probe can under-sell a memory system serving several concurrent streams.

    Horner-style chain: v' = a1 + c·(a2 + c·(a3 + c·(a4 + c·(a5 + c·v)))) with a carried
    scalar c that changes every pass — no subexpression is loop-invariant, so XLA cannot
    hoist the coefficient streams out of the loop, and v-dependence forces a full re-read
    of every stream each pass."""
    @jax.jit
    def run(a1, a2, a3, a4, a5):
        def body(_, carry):
            v, c = carry
            c = c * 1.0000001
            v = a1 + c * (a2 + c * (a3 + c * (a4 + c * (a5 + c * v))))
            return v, c
        v, _ = jax.lax.fori_loop(0, iters, body,
                                 (jnp.zeros_like(a1), jnp.float32(1.0)))
        return v
    return run


def _read6_probe(iters: int):
    """6 concurrent read streams, no writes — measures whether multiple in-flight streams
    sustain more aggregate read bandwidth than the single-stream read probe (memory
    controllers typically need several streams' worth of outstanding requests to saturate)."""
    @jax.jit
    def run(a1, a2, a3, a4, a5, a6):
        def body(_, s):
            return s + (jnp.sum(a1 * s) + jnp.sum(a2 * s) + jnp.sum(a3 * s)
                        + jnp.sum(a4 * s) + jnp.sum(a5 * s) + jnp.sum(a6 * s)) * 1e-30
        return jax.lax.fori_loop(0, iters, body, jnp.ones((), a1.dtype))
    return run


def slope_seconds(t_lo: float, t_hi: float, k_lo: int, k_hi: int) -> float:
    """Per-pass seconds from paired-count timings, with the noise guard EVERY user of
    the differencing protocol must share (kernel_time_ms, bench.py, the probes).

    When fixed-cost jitter exceeds the true slope, t_hi can come out
    ≤ t_lo; returning the raw clamped slope would export absurd TB/s numbers.  The
    guard falls back to the chain-average t_hi/k_hi — biased HIGH by fixed/k_hi (i.e.
    kernel-unflattering), never nonsensical."""
    slope = (t_hi - t_lo) / (k_hi - k_lo)
    fallback = t_hi / k_hi
    if slope <= 0 or slope < 0.05 * fallback:
        return fallback
    return slope


_DISPATCH_CACHE: Dict[str, tuple] = {}


def dispatch_baselines(reps: int = 40, refresh: bool = False) -> tuple:
    """Measured per-call dispatch floors for the STEPPED solvers' timer correction:

      ``block_ms``    — launch one trivial jitted program + ``jax.block_until_ready``
                        (the sync pattern of the halo/spmv/blas1 phase buckets)
      ``readback_ms`` — same launch + a ``float()`` scalar readback (the pattern of the
                        dot/allreduce buckets; includes the device→host round trip)

    A de-fused phase program measures dispatch + work; on fast collectives (a 2-row
    ppermute is microseconds) the bucket is ~100% dispatch.  Subtracting these medians
    (paired-differencing discipline, same idea as the chain-slope protocol) turns the
    buckets into estimates of the work itself.  Medians, not mins: the correction must
    model the TYPICAL per-call cost paid inside the loop.  Cached per backend."""
    key = jax.default_backend()
    if not refresh and key in _DISPATCH_CACHE:
        return _DISPATCH_CACHE[key]
    f = jax.jit(lambda s: s + 1.0)
    x = jnp.zeros(())
    float(f(x))  # compile + warm
    blocks, reads = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(x))
        blocks.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        float(f(x))
        reads.append(time.perf_counter() - t0)
    blocks.sort()
    reads.sort()
    out = (blocks[reps // 2] * 1e3, reads[reps // 2] * 1e3)
    _DISPATCH_CACHE[key] = out
    return out


def measure_probe_slope(make_probe, args, bytes_per_pass: int,
                        k_lo: int = 6, k_hi: int = 24, reps: int = 3) -> float:
    """GB/s from the paired-iteration slope of one probe."""
    t_lo = _timed_best(make_probe(k_lo), args, reps)
    t_hi = _timed_best(make_probe(k_hi), args, reps)
    return bytes_per_pass / slope_seconds(t_lo, t_hi, k_lo, k_hi) / 1e9


def measure_achievable_bw(n_elems: int = 0, k_lo: int = 6, k_hi: int = 24,
                          reps: int = 3, include_mixes: bool = True) -> Dict:
    """Run the probe suite; returns GB/s per probe plus the achievable ceiling.

    ``n_elems`` defaults to 2²⁸ f32 (1 GiB) on accelerators — well beyond any cache, so the
    probe streams device memory — and small on CPU (tests).  ``include_mixes`` adds the
    multi-stream probes (mix7 = the stencil kernel's 6R:1W pattern, read6 = 6 concurrent
    read streams); the achievable ceiling is the max over every probe run."""
    if n_elems == 0:
        n_elems = 2 ** 28 if jax.default_backend() != "cpu" else 2 ** 20
    x = jnp.ones((n_elems // 128, 128), jnp.float32)
    b = jnp.full_like(x, 0.5)
    nbytes = x.size * x.dtype.itemsize

    read_gbs = measure_probe_slope(_read_probe, (x,), nbytes, k_lo, k_hi, reps)
    copy_gbs = measure_probe_slope(_copy_probe, (x,), 2 * nbytes, k_lo, k_hi, reps)
    triad_gbs = measure_probe_slope(_triad_probe, (x, b), 3 * nbytes, k_lo, k_hi, reps)
    out = {
        "probe_elems": int(x.size),
        "probe_protocol": f"paired-iteration slope (k={k_lo}/{k_hi}, best of {reps})",
        "read_gbs": read_gbs,
        "copy_gbs": copy_gbs,
        "triad_gbs": triad_gbs,
    }
    if include_mixes:
        # the mix probes need 5-6 live streams; half-size arrays keep the suite under
        # ~3 GiB
        half_rows = max(x.shape[0] // 2, 1)
        xs = [jnp.full((half_rows, 128), 1.0 + 1e-7 * i, jnp.float32)
              for i in range(6)]
        sbytes = xs[0].size * 4
        out["mix7_gbs"] = measure_probe_slope(
            _mix7_probe, tuple(xs[:5]), 7 * sbytes, k_lo, k_hi, reps)
        out["read6_gbs"] = measure_probe_slope(
            _read6_probe, tuple(xs), 6 * sbytes, k_lo, k_hi, reps)
        del xs
    out["achievable_gbs"] = max(v for k, v in out.items() if k.endswith("_gbs"))
    return out
