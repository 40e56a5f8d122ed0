"""Single-chip Conjugate Gradient solver, device-resident.

Algorithm parity with the reference (src/solvers/cg_solver.cu:11-20 header comment and
cg_solve_device :436-706):

    r₀ = b − A·x₀ ; p₀ = r₀ ; rr₀ = (r₀, r₀) ; ‖b‖ = √rr₀   (x₀ = 0 ⇒ r₀ = b)
    loop:  Ap = A·p ; pAp = (p, Ap) ; α = rr/pAp
           x += α·p ; r −= α·Ap ; rr' = (r, r)
           converged = √rr' < tol·‖b‖  → stop (counting this iteration)
           β = rr'/rr ; p = r + β·p

The reference's device-native loop polls a 4-byte convergence flag per iteration
(cg_solver.cu:598-599) — its only host sync.  Here the whole loop is a ``jax.lax.while_loop``
under jit, so the convergence predicate never leaves the device and the host syncs exactly
once, at the end of the solve.

Iteration-count semantics match the reference exactly (:538-650): ``iterations`` counts the
converging iteration (iter++ on break, :619), so deterministic 14-iteration parity on the
stencil grids is directly comparable.

Per-iteration memory traffic floor (values-carrying stencil, one card):
    spmv+dot 7 words/pt, fused update 6, p-update 3 ⇒ 16 words/pt — vs the reference's ~7
    kernel passes.  XLA forms the fusions (SURVEY.md §2.3).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..kernels.blas1 import dot


@dataclasses.dataclass
class CGConfig:
    """Parity with reference CGConfig (include/solvers/cg_solver.h:21-26)."""

    max_iters: int = 1000
    tolerance: float = 1e-6
    verbose: int = 0
    enable_detailed_timers: bool = False


@dataclasses.dataclass
class CGStats:
    """Parity with reference CGStats (include/solvers/cg_solver.h:28-43).

    ``halo_time_ms`` / ``allreduce_time_ms`` are the multi-chip per-collective timers
    (reference CGStatsMultiGPU time_allreduce/time_allgather, cg_solver_mgpu.h:55-67),
    populated by the sharded stepped solver; zero in single-chip runs (no collectives)."""

    iterations: int = 0
    converged: bool = False
    residual_norm: float = 0.0
    relative_residual: float = 0.0
    total_time_ms: float = 0.0
    spmv_time_ms: float = 0.0
    blas1_time_ms: float = 0.0
    reduction_time_ms: float = 0.0
    halo_time_ms: float = 0.0
    allreduce_time_ms: float = 0.0
    # stepped-solver dispatch correction (bench.probes.dispatch_baselines): the per-call
    # launch/readback floors SUBTRACTED from the phase buckets above, so they estimate
    # the work (communication/compute) rather than launch overhead.  Zero in fused runs.
    dispatch_block_ms: float = 0.0
    dispatch_readback_ms: float = 0.0
    # buckets whose raw time fell BELOW the dispatch floor and were clipped to 0.0 by the
    # correction — an exported 0.0 with the bucket named here means "unresolvable beneath
    # the launch floor", not "no time spent" (round-3 review honesty patch)
    dispatch_clipped: tuple = ()


def make_cg_step(spmv_dot: Callable):
    """Build the jittable CG iteration body.

    ``spmv_dot(p) -> (Ap, pAp)`` is the operator contract — the analog of the reference's
    ``run_device`` function-pointer seam (include/spmv.h:131; SURVEY.md §1 "deliberate design
    point"): any SpMV implementation is usable inside CG unmodified.
    """

    from ..bench import profiling

    def step(state):
        # named scopes = the reference's NVTX phase ranges (CG_Iteration/SpMV/...,
        # cg_solver_mgpu_partitioned.cu:540-543); pure trace metadata, no runtime cost
        x, r, p, rr, k = state
        with profiling.scope(profiling.PHASE_SPMV):
            ap, pap = spmv_dot(p)
        alpha = (rr / pap).astype(x.dtype)
        with profiling.scope(profiling.PHASE_AXPY):
            x = x + alpha * p
            r = r - alpha * ap
            rr_new = dot(r, r)
        beta = (rr_new / rr).astype(x.dtype)
        with profiling.scope("BLAS_Update_P"):
            p = r + beta * p
        return x, r, p, rr_new, k + 1

    return step


def cg_solve(operator_or_spmv_dot, b, x0=None, *, config: Optional[CGConfig] = None,
             spmv: Optional[Callable] = None, b_is_ones: bool = False,
             recompute_ap: bool = False):
    """Device-resident CG solve.  Returns (x, CGStats).

    Args:
      operator_or_spmv_dot: either an ops.DeviceOperator (preferred — its large device
        operands enter the jitted solve as runtime ARGUMENTS, never inline constants), or a
        bare callable ``p -> (A·p, <p, A·p>)`` (convenient for tests/small problems; any
        arrays it closes over get embedded as constants in the compiled program).
      b: right-hand side as a 2-D field (any (rows, cols) factorization of n).
      x0: initial guess (default zeros, the reference CLI default cg_solver.cu:124-128).
      spmv: optional plain ``x -> A·x`` used once for r₀ when x0 ≠ 0.
      b_is_ones: declare that b is the canonical all-ones RHS (and x0 is zeros).  b and x0
        are then SYNTHESIZED inside the compiled solve instead of passed as buffers — two
        fewer (g, g) fields resident during the solve.
      recompute_ap: the two-pass iteration (run_pupdate_dot_op + run_update_recompute_op):
        Ap is recomputed by both passes and never stored — 11 → 8 words/pt/iter for the
        values-free operator by the byte model.  Off by default: on the H100 XLA's classic
        loop was faster (PERF.md).  True errors if the operator lacks the passes.
    """
    config = config or CGConfig()
    if b_is_ones and x0 is not None:
        raise ValueError("b_is_ones implies x0 = 0")
    nonzero_x0 = x0 is not None
    if hasattr(operator_or_spmv_dot, "run_device_dot_op") and \
            operator_or_spmv_dot.run_device_dot_op is not None:
        op = operator_or_spmv_dot
        spmv_dot = op.run_device_dot_op
        operands = op.operands
        # the operator carries its own plain SpMV: nonzero x0 needs no extra argument
        if nonzero_x0 and op.run_device_op is None:
            # silently treating this as x0 = 0 would converge to x0 + A⁻¹b
            raise ValueError("nonzero x0 requires the operator to provide run_device_op")
        spmv_op = op.run_device_op if nonzero_x0 else None
        pupd_dot = getattr(op, "run_pupdate_dot_op", None)
        upd_rec = getattr(op, "run_update_recompute_op", None)
        recomp = None
        if recompute_ap and pupd_dot is not None and upd_rec is not None:
            recomp = (pupd_dot, upd_rec)
        if recompute_ap and recomp is None:
            raise ValueError("recompute_ap requested but the operator lacks "
                             "run_pupdate_dot_op/run_update_recompute_op")
        # cache key holds the CALLABLE itself, not id(): function objects hash by identity
        # and the key's strong reference pins them, so a freed operator's id can never be
        # recycled into a false cache hit (the id()-keying correctness hazard)
        key_id = ("op", op.name, op.num_rows, op.run_device_dot_op, nonzero_x0,
                  recomp is not None)
    else:
        if nonzero_x0 and spmv is None:
            raise ValueError(
                "nonzero x0 with a bare spmv_dot callable requires the plain `spmv` "
                "callable for r0 = b - A x0 (or pass the DeviceOperator itself)"
            )
        spmv_dot = lambda p, _o: operator_or_spmv_dot(p)  # noqa: E731
        operands = ()
        spmv_op = (lambda x, _o: spmv(x)) if nonzero_x0 else None
        recomp = None
        if recompute_ap:
            raise ValueError("recompute_ap requires a DeviceOperator with the "
                             "recompute passes, not a bare spmv_dot callable")
        key_id = ("fn", _IdentityKey.wrap(operator_or_spmv_dot), _IdentityKey.wrap(spmv),
                  nonzero_x0)
    solve = _build_solver(spmv_dot, spmv_op, config.max_iters, float(config.tolerance), b,
                          key_id, synth_b=b_is_ones, recomp=recomp)
    t0 = time.perf_counter()
    if b_is_ones:
        x, scalars = solve(operands)
    else:
        if x0 is None:
            x0 = jnp.zeros_like(b)
        x, scalars = solve(b, x0, operands)
    # ONE device→host transfer for (rr, k, b_norm) instead of three scalar readbacks
    rr, k_f, b_norm = (float(v) for v in jax.device_get(scalars))
    k = int(k_f)
    x.block_until_ready()
    total_ms = (time.perf_counter() - t0) * 1e3
    res = rr ** 0.5
    stats = CGStats(
        iterations=k,
        converged=bool(res < config.tolerance * b_norm) if b_norm > 0 else True,
        residual_norm=res,
        relative_residual=res / b_norm if b_norm > 0 else 0.0,
        total_time_ms=total_ms,
    )
    return x, stats


class _IdentityKey:
    """Identity-keyed cache wrapper for UNHASHABLE callables (e.g. a dataclass instance
    with ``__call__``).  Holds a strong reference, so — unlike a bare id() — the id can
    never be recycled into a false cache hit.  Hashable callables are used directly."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __hash__(self):
        return id(self.obj)

    def __eq__(self, other):
        return isinstance(other, _IdentityKey) and other.obj is self.obj

    @staticmethod
    def wrap(obj):
        try:
            hash(obj)
            return obj
        except TypeError:
            return _IdentityKey(obj)


_SOLVER_CACHE = {}


def _build_solver(spmv_dot, spmv, max_iters, tolerance, example_b, key_id,
                  synth_b: bool = False, recomp=None):
    """Build the jitted solve.  ``spmv_dot(p, operands)`` / ``spmv(x, operands)`` take the
    operator's device arrays explicitly so they enter the compiled program as runtime
    arguments, never inline constants.  Call ``solve(b, x0, operands)``, or
    ``solve(operands)`` when ``synth_b`` (b = ones and x0 = 0 are created in-graph).

    ``recomp``: optional (pupd_dot, upd_rec) pass pair — the 8-words/pt recompute-Ap
    iteration (kernels/stencil5.py): pass A forms p' = r + β·p and <p', A·p'>, pass B
    forms x', r', <r', r'> recomputing A·p' from p'.  Same algebra, Ap never stored.
    The loop then carries (x, r, p_prev, rr, rr_prev, k) and computes β inside pass A."""
    key = (key_id, max_iters, tolerance, example_b.shape, str(example_b.dtype), synth_b)
    if key in _SOLVER_CACHE:
        return _SOLVER_CACHE[key]

    b_shape, b_dtype = example_b.shape, example_b.dtype

    def _recompute_step(operands):
        from ..bench import profiling

        pupd_dot, upd_rec = recomp

        def step(state):
            x, r, p_prev, rr, rr_prev, k = state
            beta = jnp.where(k == 0, jnp.zeros((), x.dtype),
                             (rr / rr_prev).astype(x.dtype))
            with profiling.scope(profiling.PHASE_SPMV):
                p, pap = pupd_dot(beta, r, p_prev, operands)
            alpha = (rr / pap).astype(x.dtype)
            with profiling.scope(profiling.PHASE_AXPY):
                x, r, rr_new = upd_rec(alpha, x, r, p, operands)
            return x, r, p, rr_new, rr, k + 1

        return step

    def _solve(b, x0, operands):
        step = make_cg_step(lambda p: spmv_dot(p, operands))
        if spmv is None:
            # x₀ = 0 fast path: r₀ = b
            r0 = b
            rr0 = dot(r0, r0)
            bb = rr0
        else:
            r0 = b - spmv(x0, operands)
            rr0 = dot(r0, r0)
            # the criterion is relative to ‖b‖, NOT ‖r0‖ (they differ when x0 ≠ 0)
            bb = dot(b, b).astype(rr0.dtype)
        b_norm = jnp.sqrt(bb)
        tol2 = (tolerance * tolerance) * bb  # converged ⇔ rr < tol²·‖b‖²

        if recomp is not None:
            def fcond(state):
                return jnp.logical_and(state[5] < max_iters, state[3] > tol2)

            fstate0 = (x0, r0, jnp.zeros_like(r0), rr0, jnp.ones_like(rr0),
                       jnp.zeros((), jnp.int32))
            x, r, p, rr, _rrp, k = jax.lax.while_loop(fcond, _recompute_step(operands),
                                                      fstate0)
            sdt = rr.dtype if rr.dtype in (jnp.float32, jnp.float64) else jnp.float32
            return x, jnp.stack([rr.astype(sdt), k.astype(sdt), b_norm.astype(sdt)])

        def cond(state):
            _, _, _, rr, k = state
            # STRICT >: a zero RHS (rr0 = 0 = tol2) must not run a 0/0 step — x = x0 is
            # already the solution with 0 iterations
            return jnp.logical_and(k < max_iters, rr > tol2)

        state0 = (x0, r0, r0, rr0, jnp.zeros((), jnp.int32))
        x, r, p, rr, k = jax.lax.while_loop(cond, step, state0)
        # pack in ≥f32: k ≤ max_iters is exact below 2^24 (bf16 would corrupt k > 256)
        sdt = rr.dtype if rr.dtype in (jnp.float32, jnp.float64) else jnp.float32
        return x, jnp.stack([rr.astype(sdt), k.astype(sdt), b_norm.astype(sdt)])

    if synth_b:
        @jax.jit
        def solve(operands):
            return _solve(jnp.ones(b_shape, b_dtype), jnp.zeros(b_shape, b_dtype), operands)
    else:
        solve = jax.jit(_solve)

    _SOLVER_CACHE[key] = solve
    return solve


def cg_solve_stepped(spmv_dot: Callable, b, x0=None, *, config: Optional[CGConfig] = None,
                     spmv: Optional[Callable] = None):
    """Host-stepped CG with per-phase wall timing — the ``--timers`` mode.

    Mirrors the reference's opt-in detailed timers (cg_solver.h:25, cg_solver.cu:543-547):
    phase-split stepping costs sync overhead, so it is a diagnostic mode, not the perf path.
    Returns (x, CGStats) with spmv/blas1/reduction breakdowns."""
    config = config or CGConfig()
    if x0 is None:
        x0 = jnp.zeros_like(b)
        r = b
    else:
        ax0 = spmv(x0) if spmv is not None else None
        if ax0 is None:
            raise ValueError("nonzero x0 requires the plain spmv callable")
        r = b - ax0
    x = x0
    p = r
    rr = float(dot(r, r))
    # criterion is relative to ‖b‖ (differs from ‖r0‖ when x0 ≠ 0)
    b_norm = float(dot(b, b)) ** 0.5
    stats = CGStats()
    t_solve = time.perf_counter()
    k = 0
    converged = rr == 0.0  # zero residual: x0 is already the solution (0 iterations)
    while k < config.max_iters and not converged:
        # Reductions are a first-class phase (reference cg_solver.h:28-43 reduction bucket):
        # the scalar readbacks (float(pap), float(rr)) are timed separately from the array
        # compute.
        t0 = time.perf_counter()
        ap, pap = spmv_dot(p)
        jax.block_until_ready(ap)
        stats.spmv_time_ms += (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        pap = float(pap)
        stats.reduction_time_ms += (time.perf_counter() - t0) * 1e3
        alpha = rr / pap
        t0 = time.perf_counter()
        x = x + alpha * p
        r = r - alpha * ap
        rr_new = dot(r, r)
        jax.block_until_ready(r)
        stats.blas1_time_ms += (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        rr_new = float(rr_new)
        stats.reduction_time_ms += (time.perf_counter() - t0) * 1e3
        k += 1
        if config.verbose >= 2:
            print(f"[CG] Iter {k:3d}: residual = {rr_new ** 0.5:e} "
                  f"(rel = {rr_new ** 0.5 / b_norm:e})")
        if rr_new ** 0.5 < config.tolerance * b_norm:
            converged = True
        else:
            beta = rr_new / rr
            t0 = time.perf_counter()
            p = r + beta * p
            jax.block_until_ready(p)
            stats.blas1_time_ms += (time.perf_counter() - t0) * 1e3
        rr = rr_new
    stats.total_time_ms = (time.perf_counter() - t_solve) * 1e3
    stats.iterations = k
    stats.converged = converged
    stats.residual_norm = rr ** 0.5
    stats.relative_residual = rr ** 0.5 / b_norm if b_norm > 0 else 0.0
    return x, stats
