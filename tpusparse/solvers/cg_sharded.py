"""Multi-chip sharded Conjugate Gradient — the framework's flagship (reference
``cg_solve_mgpu_partitioned``, src/solvers/cg_solver_mgpu_partitioned.cu:236-908).

Mapping from the reference's MPI design (SURVEY.md §2.4 / §5.8):

  reference (CUDA + MPI)                         this solver (JAX, one process, shard_map)
  ------------------------------------------     -----------------------------------------
  1 MPI rank = 1 GPU, cudaSetDevice(rank)        1-D ``jax.sharding.Mesh`` over the cards
  1-D row-band partition n/P (+remainder)        field rows sharded P("x"): band = g/P rows
  pinned-host staged MPI_Isend/Irecv halo        ``jax.lax.ppermute`` of ONE boundary row
    (cudaMemcpyAsync D2H→MPI→H2D, :173-231)        per direction, card to card (NCCL)
  cublasDdot + MPI_Allreduce(1 double)           fused local SpMV+dot + ``jax.lax.psum``
  MPI_Gatherv of the solution (:834-851)         out_spec resharding (XLA all-gather)
  per-vector halo: x₀ once, r once, p per-iter   identical schedule: p's halo per iteration

The reference's staging pipeline exists because CUDA-aware MPI wasn't assumed
(cg_solver_mgpu_partitioned.cu:160-171); here XLA's collectives move the rows between cards
directly.  The mesh follows the algorithm (row bands, or row × column blocks), since every
card reaches every other at the same rate.  Halo volume parity: one grid-row (g elements) per
neighbor per iteration — the same O(g) communication vs O(g²/P) compute that gives the
reference its 93% strong scaling.

The whole solve — halo exchanges, SpMV, reductions, convergence — is ONE jitted
``shard_map``-wrapped ``lax.while_loop``: zero host round-trips during the solve (the reference
polls a convergence flag per iteration; here even that stays on device).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..kernels.blas1 import dot
from ..kernels.stencil5 import (
    const_pupdate_dot,
    const_update_recompute,
    spmv_dot_stencil5_const_xla,
    spmv_dot_stencil5_xla,
    spmv_stencil5_const_xla,
    spmv_stencil5_xla,
)
from .cg import CGConfig, CGStats


def _band_halo_exchange(field_block, axis_name: str, axis_size: int):
    """Exchange boundary rows with row-band neighbors.

    Returns (halo_prev, halo_next), each (1, cols): the neighbor's adjacent boundary row.
    Edge shards receive zeros (``ppermute`` fills missing sources with zeros), which is
    exactly the Dirichlet boundary — no special-casing, unlike the reference's per-rank
    prev/next conditionals (exchange_halo_mpi :188-217)."""
    down = [(i, i + 1) for i in range(axis_size - 1)]  # my last row -> next shard's halo_prev
    up = [(i + 1, i) for i in range(axis_size - 1)]  # my first row -> prev shard's halo_next
    from ..bench import profiling

    with profiling.scope(profiling.PHASE_HALO):
        halo_prev = jax.lax.ppermute(field_block[-1:, :], axis_name, down)
        halo_next = jax.lax.ppermute(field_block[:1, :], axis_name, up)
    return halo_prev, halo_next


@dataclasses.dataclass
class ShardedOperator:
    """Row-band sharded operator: the sharded analog of ops.DeviceOperator.

    Modes: the three stencil flavors (row-halo XLA stencils), plus ``"csr"`` — a
    GENERIC band-local ELL-gather kernel, the analog of the textbook CSR kernel the
    reference carries inside its partitioned solver for comparison
    (cg_solver_mgpu_partitioned.cu:40-56).  Like the reference's partitioned kernels it
    requires every column within one grid-row of its row (halo reach); arbitrary banded
    matrices with bandwidth ≤ g qualify, not just stencils."""

    mesh: Mesh
    grid_size: int
    mode: str  # "stencil5" | "stencil5-bf16c" | "stencil5-const" | "csr"
    planes: Optional[jax.Array]  # (5, g, g), row-band sharded; None for const/csr modes
    diag: float
    offdiag: float
    dtype: object
    row_pad: int = 0  # zero-coefficient rows appended so bands divide evenly

    @property
    def nnz(self) -> int:
        if self.nnz_actual:
            return self.nnz_actual
        from ..generate import stencil5_nnz

        return stencil5_nnz(self.grid_size)

    @property
    def num_rows(self) -> int:
        return self.grid_size * self.grid_size

    num_cols = num_rows
    name = property(lambda self: self.mode)

    overlap: bool = True
    # "csr" mode operands: ((g+pad)·g, W) ELL columns/values, row-sharded P("x", None)
    ell_cols: Optional[jax.Array] = None
    ell_vals: Optional[jax.Array] = None
    nnz_actual: int = 0  # real nnz for file-loaded matrices (0 → stencil5 formula)

    @property
    def has_planes(self) -> bool:
        return self.mode in ("stencil5", "stencil5-bf16c")

    @property
    def operand_spec(self):
        """shard_map in_spec pytree matching ``operands_arg``."""
        if self.has_planes:
            return P(None, "x", None)
        if self.mode == "csr":
            return (P("x", None), P("x", None))
        return P()

    @property
    def operands_arg(self):
        """The device operand pytree the jitted solve takes as a runtime argument."""
        if self.has_planes:
            return self.planes
        if self.mode == "csr":
            return (self.ell_cols, self.ell_vals)
        return jnp.zeros((), self.dtype)

    def _ell_band_spmv(self, cols_l, vals_l, p_l, hp, hn):
        """Generic band-local gather SpMV: the reference's comparison CSR kernel.

        The gatherable domain is [halo_prev; local band; halo_next] flattened; global
        column c maps to local index c − (row_offset − g).  Columns outside the domain are
        masked to zero via ``jnp.where`` (they only occur for padded slots whose value is
        already zero — the pack validates the reach invariant)."""
        band_rows, g = p_l.shape
        xl = jnp.concatenate([hp, p_l, hn], axis=0).reshape(-1)
        base = jax.lax.axis_index("x") * (band_rows * g) - g
        loc = cols_l - base
        valid = jnp.logical_and(loc >= 0, loc < xl.shape[0])
        gathered = jnp.where(valid, xl[jnp.clip(loc, 0, xl.shape[0] - 1)],
                             jnp.zeros((), xl.dtype))
        y = jnp.sum(vals_l * gathered, axis=1)
        return y.reshape(band_rows, g)

    def local_spmv(self, operands_l, p_l, hp, hn):
        """Local band SpMV with the halo rows PROVIDED — pure per-shard compute, zero
        collectives.  The stepped per-collective timers use this to measure the compute
        phase separately from the halo ppermute and the dot allreduces."""
        if self.mode == "csr":
            return self._ell_band_spmv(operands_l[0], operands_l[1], p_l, hp, hn)
        if self.mode == "stencil5-const":
            return spmv_stencil5_const_xla(p_l, self.diag, self.offdiag, hp, hn)
        return spmv_stencil5_xla(operands_l, p_l, hp, hn)

    def local_spmv_dot(self, operands_l, p_l, axis_name: str, axis_size: int):
        """Local band SpMV + global <p, Ap>.  Runs inside shard_map."""
        if self.mode == "csr":
            hp, hn = _band_halo_exchange(p_l, axis_name, axis_size)
            y = self._ell_band_spmv(operands_l[0], operands_l[1], p_l, hp, hn)
            return y, jax.lax.psum(dot(p_l, y), axis_name)
        if self.overlap and axis_size > 1 and p_l.shape[0] >= 3:
            return self._spmv_dot_overlapped(operands_l, p_l, axis_name, axis_size)
        hp, hn = _band_halo_exchange(p_l, axis_name, axis_size)
        if self.mode == "stencil5-const":
            y, pap_local = spmv_dot_stencil5_const_xla(p_l, self.diag, self.offdiag, hp, hn)
        else:
            y, pap_local = spmv_dot_stencil5_xla(operands_l, p_l, hp, hn)
        return y, jax.lax.psum(pap_local, axis_name)

    def _spmv_dot_overlapped(self, planes_l, p_l, axis_name: str, axis_size: int):
        """Interior/boundary split so the halo ppermute overlaps interior compute — the
        improvement the reference aspired to but shipped without (its halo exchange is
        synchronous before the SpMV, cg_solver_mgpu_partitioned.cu:692-711; README attributes
        wins to 'kernel + volume, not overlap').

        The interior rows [1, band-1) depend only on local data, so their SpMV has no data
        dependency on the ppermute and XLA may schedule the collective-permute start before
        it and the done right before the (cheap, 2-row) boundary math.  Whether it does is
        up to XLA's scheduler: one fusion may also take in both the interior and the halo
        rows.
        """
        hp, hn = _band_halo_exchange(p_l, axis_name, axis_size)

        if self.mode == "stencil5-const":
            y_core, dot_core = spmv_dot_stencil5_const_xla(
                p_l[1:-1], self.diag, self.offdiag, p_l[0:1], p_l[-1:])
        else:
            y_core, dot_core = spmv_dot_stencil5_xla(
                planes_l[:, 1:-1], p_l[1:-1], p_l[0:1], p_l[-1:])

        # Boundary rows (2 of band): plain XLA math, consumes the halo rows.
        from ..formats import C, E, N, S, W

        def row_y(prow, xrow, xn_row, xs_row):
            g = xrow.shape[1]
            zc = jnp.zeros((1, 1), xrow.dtype)
            xw = jnp.concatenate([zc, xrow[:, :-1]], axis=1)
            xe = jnp.concatenate([xrow[:, 1:], zc], axis=1)
            if self.mode == "stencil5-const":
                gcol = jnp.arange(g).reshape(1, g)
                mw = (gcol > 0).astype(xrow.dtype)
                me = (gcol < g - 1).astype(xrow.dtype)
                return self.diag * xrow + self.offdiag * (
                    xn_row + xs_row + mw * xw + me * xe
                )
            return (prow[C] * xrow + prow[W] * xw + prow[E] * xe
                    + prow[N] * xn_row + prow[S] * xs_row)

        p_first = None if self.mode == "stencil5-const" else planes_l[:, 0:1]
        p_last = None if self.mode == "stencil5-const" else planes_l[:, -1:]
        y_first = row_y(p_first, p_l[0:1], hp, p_l[1:2])
        y_last = row_y(p_last, p_l[-1:], p_l[-2:-1], hn)
        y = jnp.concatenate([y_first, y_core, y_last], axis=0)
        # keep the f32 accumulator: downcasting to a bf16 field dtype would corrupt pAp
        pap_local = dot_core + dot(p_l[0:1], y_first) + dot(p_l[-1:], y_last)
        return y, jax.lax.psum(pap_local, axis_name)


_OPERATOR_CACHE = {}
# Sharded coefficient planes, keyed ONLY on what they depend on (mesh/grid/mode-family/
# coefficients/dtype) — NOT on solver config.  Operator/solver cache entries for different
# (overlap, tol, max_iters) configurations all share ONE device planes array, so config
# sweeps never pin duplicate multi-GB planes in HBM (round-2 advisory).
_PLANES_CACHE = {}


def clear_caches() -> None:
    """Drop every sharded-solver cache: compiled solves, operators, and the sharded planes.

    The compiled solves are cheap host objects, but operator/planes entries pin device HBM
    (a 20480² f32 planes array is 8.4 GB).  Sweeps over grid sizes MUST call this between
    points (``tpusparse.clear_caches()`` clears this and the single-chip solver cache) or
    every visited grid's operands accumulate for the process lifetime."""
    _OPERATOR_CACHE.clear()
    _PLANES_CACHE.clear()
    _SOLVER_CACHE.clear()
    _SOLVER2D_CACHE.clear()


def _sharded_planes(mesh: Mesh, g: int, coeff_dtype, diag, offdiag, pad: int, pspec):
    """Synthesize + shard the (5, g(+pad), g) coefficient planes, cached (see above)."""
    key = (mesh, g, str(coeff_dtype), diag, offdiag, pad, pspec)
    planes = _PLANES_CACHE.get(key)
    if planes is None:
        from ..generate import make_stencil5_planes_device

        planes = make_stencil5_planes_device(g, diag, offdiag, dtype=jnp.float32
                                             if coeff_dtype == jnp.bfloat16 else coeff_dtype)
        if coeff_dtype == jnp.bfloat16:
            # bf16 coefficient storage (see ops._init_stencil5): halves plane traffic;
            # bit-identical when the field is exactly representable (5/-1/0 is)
            planes = jnp.asarray(planes, jnp.bfloat16)
        if pad:
            planes = jnp.concatenate(
                [planes, jnp.zeros((5, pad, g), planes.dtype)], axis=1
            )
        planes = jax.device_put(planes, NamedSharding(mesh, pspec))
        _PLANES_CACHE[key] = planes
    return planes


def _make_sharded_ell_operator(mesh: Mesh, g: int, matrix, diag, offdiag, dtype,
                               pad: int) -> ShardedOperator:
    """Pack a matrix into the row-band-sharded ELL operand for the generic "csr" mode.

    Validates the HALO REACH invariant the kernel assumes: every nonzero's column within
    one grid-row (g) of its row — the same structural contract as the reference's
    partitioned kernels (their halo buffers are one grid-row per neighbor,
    cg_solver_mgpu_partitioned.h:10-23)."""
    import numpy as np

    from .. import formats

    if matrix is None:
        from ..generate import make_stencil5

        matrix = make_stencil5(g, diag, offdiag, dtype=np.float32)
    from ..ops import _as_csr

    csr = _as_csr(matrix)
    n = g * g
    if csr.num_rows != n or csr.num_cols != n:
        raise ValueError(
            f"sharded csr mode needs a g²×g² matrix for the (g, g) field; got "
            f"{csr.num_rows}x{csr.num_cols} with g={g}")
    ell = formats.csr_to_ell(csr)
    rows = np.arange(n, dtype=np.int64)[:, None]
    reach_bad = (np.abs(ell.col - rows) > g) & (ell.val != 0)
    if np.any(reach_bad):
        raise ValueError(
            "matrix has nonzeros beyond one grid-row of their row — the sharded generic "
            "kernel's halo reach (one grid-row per neighbor, reference parity) cannot "
            "cover it; use the single-chip csr operator")
    cols = ell.col.astype(np.int32)
    np_dtype = np.dtype(jnp.zeros((), dtype).dtype)
    vals = ell.val.astype(np_dtype)
    if pad:
        # padded rows: zero values, columns pointing at the row itself (always in-domain)
        prow = np.arange(n, n + pad * g, dtype=np.int32)[:, None]
        cols = np.concatenate([cols, np.broadcast_to(prow, (pad * g, cols.shape[1]))], 0)
        vals = np.concatenate([vals, np.zeros((pad * g, vals.shape[1]), np_dtype)], 0)
    sh = NamedSharding(mesh, P("x", None))
    return ShardedOperator(
        mesh=mesh, grid_size=g, mode="csr", planes=None, diag=diag, offdiag=offdiag,
        dtype=dtype, row_pad=pad, overlap=False,
        ell_cols=jax.device_put(jnp.asarray(cols), sh),
        ell_vals=jax.device_put(jnp.asarray(vals), sh),
        nnz_actual=csr.nnz,
    )


def make_sharded_operator(mesh: Mesh, grid_size: int, *, mode: str = "stencil5",
                          planes=None, matrix=None, diag: float = 5.0,
                          offdiag: float = -1.0, dtype=jnp.float32,
                          overlap: bool = True) -> ShardedOperator:
    """Build the sharded operand.  For ``mode="stencil5"`` the (5, g, g) coefficient planes are
    synthesized (or accepted) and laid out row-band sharded — the analog of the reference's
    "extract + rebase the local CSR band" (:302-331), except sharding happens at construction
    (the reference marks that a TODO).

    ``mode="csr"``: the generic band-local gather operator.  ``matrix`` (CSRMatrix/COOMatrix/
    Stencil5, any column reach ≤ one grid-row) supplies the values; None synthesizes the
    canonical stencil CSR — the reference's in-solver comparison kernel workflow."""
    g = grid_size
    cache_key = None
    if planes is None and matrix is None:
        # synthesized operands are deterministic: cache so repeated benchmark solves don't
        # re-synthesize + re-shard the (5, g, g) planes inside their timed region.
        # Key on the Mesh OBJECT (hashable, content-compared), never id(mesh): ids of
        # freed meshes can be recycled, silently returning operands laid out for a
        # different mesh — and content-keying also hits for equal re-built meshes.
        cache_key = (mesh, g, mode, diag, offdiag, str(dtype), overlap)
        if cache_key in _OPERATOR_CACHE:
            return _OPERATOR_CACHE[cache_key]
    naxis = mesh.devices.size
    pad = (-g) % naxis
    if mode == "csr":
        op = _make_sharded_ell_operator(mesh, g, matrix, diag, offdiag, dtype, pad)
        if cache_key is not None:
            _OPERATOR_CACHE[cache_key] = op
        return op
    if pad and mode == "stencil5-const":
        # Padded rows need zero coefficients to stay decoupled; only the values-carrying
        # operand can express that, so fall back to it (reference parity: the last rank
        # absorbs the remainder, cg_solver_mgpu_partitioned.cu:262-268 — here the padding
        # plays that role uniformly).  LOUDLY: the performance profile changes (7 vs 2
        # words/pt) and exporters must record the effective mode (op.mode), not the request.
        import sys as _sys

        print(f"[tpusparse] stencil5-const needs g % {naxis} == 0; grid {g} pads {pad} "
              f"rows → falling back to values-carrying stencil5", file=_sys.stderr)
        mode = "stencil5"
    if mode in ("stencil5", "stencil5-bf16c"):
        coeff_dtype = jnp.bfloat16 if mode == "stencil5-bf16c" else dtype
        if planes is None:
            planes = _sharded_planes(mesh, g, coeff_dtype, diag, offdiag, pad,
                                     P(None, "x", None))
        else:
            planes = jnp.asarray(planes, coeff_dtype)
            if pad:
                planes = jnp.concatenate(
                    [planes, jnp.zeros((5, pad, g), planes.dtype)], axis=1
                )
            planes = jax.device_put(
                planes, NamedSharding(mesh, P(None, "x", None))
            )
    elif mode != "stencil5-const":
        raise ValueError(
            f"sharded CG supports stencil5/stencil5-bf16c/stencil5-const/csr, got {mode}")
    op = ShardedOperator(
        mesh=mesh, grid_size=g, mode=mode, planes=planes, diag=diag, offdiag=offdiag,
        dtype=dtype, overlap=overlap, row_pad=pad,
    )
    if cache_key is not None:
        _OPERATOR_CACHE[cache_key] = op
    return op


_SOLVER_CACHE = {}


def _build_sharded_solver(op: ShardedOperator, max_iters: int, tolerance: float,
                          synth_b: bool = False, recompute: bool = False):
    # op.mesh (not id(op.mesh)): see the _OPERATOR_CACHE key comment
    key = (op.mesh, op.grid_size, op.mode, op.diag, op.offdiag, str(op.dtype),
           op.overlap, max_iters, tolerance, synth_b, recompute)
    if key in _SOLVER_CACHE:
        return _SOLVER_CACHE[key]

    mesh = op.mesh
    axis = "x"
    naxis = mesh.devices.size
    g = op.grid_size
    band = (g + op.row_pad) // naxis

    def _local_ones_b():
        """The canonical b = ones band, synthesized per shard: no (g, g) host buffer is
        ever built or resharded (the reference builds full b on every rank, :68-74).
        Padded rows (global row ≥ g) are zero — they are decoupled from the system."""
        idx = jax.lax.axis_index(axis)
        lrow = jnp.arange(band, dtype=jnp.int32)[:, None] + idx * band
        return jnp.broadcast_to((lrow < g).astype(op.dtype), (band, g))

    def local_cg(b_l, operands_l):
        """Runs per shard inside shard_map.  b_l: (band, g) local rows."""
        if synth_b:
            b_l = _local_ones_b()

        def spmv_dot(p_l):
            return op.local_spmv_dot(operands_l, p_l, axis, naxis)

        r0 = b_l  # x0 = 0
        rr0 = jax.lax.psum(dot(r0, r0), axis)
        b_norm = jnp.sqrt(rr0)
        tol2 = (tolerance * tolerance) * rr0

        def cond(state):
            _, _, _, rr, k = state
            # strict >: a zero RHS (rr0 = 0 = tol2) must not run a 0/0 step
            return jnp.logical_and(k < max_iters, rr > tol2)

        def step(state):
            x, r, p, rr, k = state
            ap, pap = spmv_dot(p)
            alpha = (rr / pap).astype(x.dtype)
            x = x + alpha * p
            r = r - alpha * ap
            rr_new = jax.lax.psum(dot(r, r), axis)
            beta = (rr_new / rr).astype(x.dtype)
            p = r + beta * p
            return x, r, p, rr_new, k + 1

        def step_recompute(state):
            """The 8-words/pt recompute-Ap iteration, sharded (kernels/stencil5.py).
            Comm volume is IDENTICAL to the classic loop — the p' boundary rows are
            computed locally (p' = r + β·p is elementwise) and exchanged as the halo,
            one row per neighbor per iteration; both passes consume the same halo rows."""
            x, r, p, rr, rr_prev, k = state
            beta = jnp.where(k == 0, jnp.zeros((), x.dtype),
                             (rr / rr_prev).astype(x.dtype))
            from ..bench import profiling

            with profiling.scope(profiling.PHASE_HALO):
                down = [(i, i + 1) for i in range(naxis - 1)]
                up = [(i + 1, i) for i in range(naxis - 1)]
                hp = jax.lax.ppermute(r[-1:, :] + beta * p[-1:, :], axis, down)
                hn = jax.lax.ppermute(r[:1, :] + beta * p[:1, :], axis, up)
            pnew, pap_local = const_pupdate_dot(beta, r, p, op.diag, op.offdiag, hp, hn)
            pap = jax.lax.psum(pap_local, axis)
            alpha = (rr / pap).astype(x.dtype)
            x, r, rr_local = const_update_recompute(alpha, x, r, pnew, op.diag,
                                                    op.offdiag, hp, hn)
            rr_new = jax.lax.psum(rr_local, axis)
            return x, r, pnew, rr_new, rr, k + 1

        if recompute:
            def rcond(state):
                return jnp.logical_and(state[5] < max_iters, state[3] > tol2)

            rstate0 = (jnp.zeros_like(b_l), r0, jnp.zeros_like(r0), rr0,
                       jnp.ones_like(rr0), jnp.zeros((), jnp.int32))
            x, r, p, rr, _rrp, k = jax.lax.while_loop(rcond, step_recompute, rstate0)
        else:
            state0 = (jnp.zeros_like(b_l), r0, r0, rr0, jnp.zeros((), jnp.int32))
            x, r, p, rr, k = jax.lax.while_loop(cond, step, state0)
        # pack the result scalars in ≥f32 (k exactness; bf16 would corrupt k > 256):
        # ONE device→host transfer in the caller (see cg.py)
        sdt = rr.dtype if rr.dtype in (jnp.float32, jnp.float64) else jnp.float32
        return x, jnp.stack([rr.astype(sdt), k.astype(sdt), b_norm.astype(sdt)])

    pspec = op.operand_spec
    if synth_b:
        sharded = jax.shard_map(
            lambda operands_l: local_cg(None, operands_l), mesh=mesh, in_specs=(pspec,),
            out_specs=(P(axis, None), P()), check_vma=False,
        )

        @jax.jit
        def solve(operands):
            return sharded(operands)
    else:
        sharded = jax.shard_map(
            local_cg, mesh=mesh, in_specs=(P(axis, None), pspec),
            out_specs=(P(axis, None), P()), check_vma=False,
        )

        @jax.jit
        def solve(b, operands):
            return sharded(b, operands)

    _SOLVER_CACHE[key] = solve
    return solve


def cg_solve_sharded(mesh: Mesh, grid_size: int, *, b=None, mode: str = "stencil5-const",
                     planes=None, matrix=None, diag: float = 5.0, offdiag: float = -1.0,
                     tolerance: float = 1e-6, max_iters: int = 1000, dtype=jnp.float32,
                     overlap: bool = True, config: Optional[CGConfig] = None,
                     operator: Optional[ShardedOperator] = None,
                     recompute_ap: bool = False):
    """Full sharded CG solve over the mesh.  Returns (x, CGStats).

    ``recompute_ap``: the 8-words/pt two-pass iteration for ``mode="stencil5-const"``
    (off by default, as in cg.cg_solve).  Comm volume is unchanged — the p' boundary rows
    are computed locally and exchanged as the per-iteration halo, exactly one row per
    neighbor like the classic loop.

    ``x`` is the (g, g) solution as a row-band-sharded ``jax.Array`` — EXCEPT when the grid
    does not divide the device count (``op.row_pad > 0``): slicing the padded tail off a
    row-sharded array is ambiguous for the partitioner, so the tail is dropped host-side and
    ``x`` is returned as a host ``numpy.ndarray`` (multi-process-safe).  Callers doing
    device-side post-processing should ``jax.device_put`` it back or pick g % n_devices == 0.

    ``operator``: a prebuilt ShardedOperator (skips construction — CLI reuse);
    ``matrix``: values source for ``mode="csr"`` (see make_sharded_operator).
    """
    if config is not None:
        tolerance, max_iters = config.tolerance, config.max_iters
    op = operator if operator is not None else make_sharded_operator(
        mesh, grid_size, mode=mode, planes=planes, matrix=matrix, diag=diag,
        offdiag=offdiag, dtype=dtype, overlap=overlap,
    )
    synth_b = b is None
    recomp = bool(recompute_ap)
    if recomp and op.mode != "stencil5-const":
        raise ValueError("recompute_ap: only mode='stencil5-const' provides the "
                         "recompute passes in the sharded solver")
    solve = _build_sharded_solver(op, max_iters, float(tolerance), synth_b=synth_b,
                                  recompute=recomp)
    operands_arg = op.operands_arg
    if synth_b:
        t0 = time.perf_counter()
        x, scalars = solve(operands_arg)
    else:
        if op.row_pad:
            b = jnp.concatenate(
                [b.astype(dtype), jnp.zeros((op.row_pad, grid_size), dtype)], axis=0
            )
        b = jax.device_put(b.astype(dtype), NamedSharding(mesh, P("x", None)))
        t0 = time.perf_counter()
        x, scalars = solve(b, operands_arg)
    rr, k_f, b_norm = (float(v) for v in jax.device_get(scalars))
    x.block_until_ready()
    total_ms = (time.perf_counter() - t0) * 1e3
    if op.row_pad:
        # Slicing a row-sharded array across shard boundaries is ambiguous for the
        # partitioner; the padded tail is dropped host-side (callers consume x on host),
        # OUTSIDE the timed region and multi-process-safe.
        from ..dist import gather_to_host

        x = gather_to_host(x, rows=grid_size)
    res = rr ** 0.5
    stats = CGStats(
        iterations=int(k_f),
        converged=bool(res < tolerance * b_norm) if b_norm > 0 else True,
        residual_norm=res,
        relative_residual=res / b_norm if b_norm > 0 else 0.0,
        total_time_ms=total_ms,
    )
    return x, stats


def _apply_dispatch_correction(stats: CGStats, n_block_calls: dict, n_read_calls: int,
                               disp_block: float, disp_read: float) -> None:
    """Subtract the measured per-call dispatch floors from the stepped phase buckets
    (floored at 0): the buckets then estimate communication/compute, not launch overhead.
    The subtracted baselines stay visible in stats.dispatch_{block,readback}_ms, and any
    bucket whose raw time fell below its floor (clipped to exactly 0.0) is NAMED in
    stats.dispatch_clipped so exports can distinguish "beneath the launch floor" from
    "no time spent" (round-3 review honesty patch)."""
    clipped = []

    def corrected(name, raw, floor):
        if raw - floor < 0.0:
            clipped.append(name)
            return 0.0
        return raw - floor

    stats.halo_time_ms = corrected(
        "halo", stats.halo_time_ms, n_block_calls["halo"] * disp_block)
    stats.spmv_time_ms = corrected(
        "spmv", stats.spmv_time_ms, n_block_calls["spmv"] * disp_block)
    stats.blas1_time_ms = corrected(
        "blas1", stats.blas1_time_ms, n_block_calls["blas1"] * disp_block)
    stats.allreduce_time_ms = corrected(
        "allreduce", stats.allreduce_time_ms, n_read_calls * disp_read)
    stats.dispatch_clipped = tuple(clipped)


def cg_solve_sharded_stepped(mesh: Mesh, grid_size: int, *, b=None,
                             mode: str = "stencil5", planes=None, matrix=None,
                             diag: float = 5.0,
                             offdiag: float = -1.0, tolerance: float = 1e-6,
                             max_iters: int = 1000, dtype=jnp.float32,
                             overlap: bool = True, verbose: int = 0,
                             operator: Optional[ShardedOperator] = None):
    """Host-stepped sharded CG with PER-COLLECTIVE wall timing — the multi-chip ``--timers``
    mode, field parity with the reference's CGStatsMultiGPU (cg_solver_mgpu.h:55-67):

      halo_time_ms      — the boundary-row ``ppermute`` pair alone (the reference's
                          MPI_Isend/Irecv staging window)
      spmv_time_ms      — local band SpMV with halos PROVIDED: pure compute, no collectives
      allreduce_time_ms — the dot products' local partial + ``psum`` + scalar readback
                          (the reference's cublasDdot + MPI_Allreduce pair); also mirrored
                          into reduction_time_ms for single-chip CGStats field parity
      blas1_time_ms     — x/r update and p update (axpy family)

    The iteration is deliberately de-fused into one jitted program per phase so each bucket
    is a real measurement; one host sync per phase per iteration makes this a diagnostic
    mode — the fused ``cg_solve_sharded`` remains the perf path (same tradeoff the reference
    documents, cg_solver_mgpu_partitioned.cu:547-559).  The reference also reduces MAX/MIN
    timers across MPI ranks for a load-imbalance % (:749-800) — under single-process SPMD
    every shard executes the same fused program in lockstep, so cross-shard imbalance is
    structurally zero with equal bands; the padded-remainder case is the only source and is
    bounded by pad/band (reported by the CLI)."""
    op = operator if operator is not None else make_sharded_operator(
        mesh, grid_size, mode=mode, planes=planes, matrix=matrix, diag=diag,
        offdiag=offdiag, dtype=dtype, overlap=overlap,
    )
    axis = "x"
    naxis = mesh.devices.size
    pspec = op.operand_spec
    operands_arg = op.operands_arg

    band_spec = P(axis, None)
    halo = jax.jit(jax.shard_map(
        lambda v: _band_halo_exchange(v, axis, naxis),
        mesh=mesh, in_specs=(band_spec,), out_specs=(band_spec, band_spec),
        check_vma=False,
    ))
    spmv_local = jax.jit(jax.shard_map(
        op.local_spmv,
        mesh=mesh, in_specs=(pspec, band_spec, band_spec, band_spec),
        out_specs=band_spec, check_vma=False,
    ))
    dot_allreduce = jax.jit(jax.shard_map(
        lambda al, bl: jax.lax.psum(dot(al, bl), axis),
        mesh=mesh, in_specs=(band_spec, band_spec), out_specs=P(),
        check_vma=False,
    ))
    upd_local = jax.jit(jax.shard_map(
        lambda alpha, xl, rl, pl_, apl: (xl + alpha * pl_, rl - alpha * apl),
        mesh=mesh,
        in_specs=(P(), band_spec, band_spec, band_spec, band_spec),
        out_specs=(band_spec, band_spec), check_vma=False,
    ))
    pupd = jax.jit(jax.shard_map(
        lambda beta, rl, pl_: rl + beta * pl_,
        mesh=mesh, in_specs=(P(), band_spec, band_spec),
        out_specs=band_spec, check_vma=False,
    ))

    if b is None:
        b = jnp.ones((grid_size, grid_size), dtype)
    if op.row_pad:
        b = jnp.concatenate([b.astype(dtype), jnp.zeros((op.row_pad, grid_size), dtype)], 0)
    b = jax.device_put(b.astype(dtype), NamedSharding(mesh, P(axis, None)))

    # Dispatch correction (round-2 review): each de-fused phase program pays a launch
    # (+readback for the dots); on fast collectives the raw bucket is ~100% dispatch.
    # Measure the floors ONCE (outside the timed solve) and subtract per call below.
    from ..bench.probes import dispatch_baselines

    disp_block, disp_read = dispatch_baselines()
    n_block_calls = {"halo": 0, "spmv": 0, "blas1": 0}
    n_read_calls = 0
    stats = CGStats(dispatch_block_ms=disp_block, dispatch_readback_ms=disp_read)
    t_solve = time.perf_counter()
    x = jnp.zeros_like(b)
    r = b
    p = r
    t0 = time.perf_counter()
    rr = float(dot_allreduce(r, r))
    stats.allreduce_time_ms += (time.perf_counter() - t0) * 1e3
    n_read_calls += 1
    b_norm = rr ** 0.5
    k = 0
    converged = False
    while k < max_iters and not converged:
        t0 = time.perf_counter()
        hp, hn = halo(p)
        jax.block_until_ready(hn)
        stats.halo_time_ms += (time.perf_counter() - t0) * 1e3
        n_block_calls["halo"] += 1
        t0 = time.perf_counter()
        ap = spmv_local(operands_arg, p, hp, hn)
        jax.block_until_ready(ap)
        stats.spmv_time_ms += (time.perf_counter() - t0) * 1e3
        n_block_calls["spmv"] += 1
        t0 = time.perf_counter()
        pap = float(dot_allreduce(p, ap))
        stats.allreduce_time_ms += (time.perf_counter() - t0) * 1e3
        n_read_calls += 1
        alpha = jnp.asarray(rr / pap, dtype)
        t0 = time.perf_counter()
        x, r = upd_local(alpha, x, r, p, ap)
        jax.block_until_ready(r)
        stats.blas1_time_ms += (time.perf_counter() - t0) * 1e3
        n_block_calls["blas1"] += 1
        t0 = time.perf_counter()
        rr_new = float(dot_allreduce(r, r))
        stats.allreduce_time_ms += (time.perf_counter() - t0) * 1e3
        n_read_calls += 1
        k += 1
        if verbose >= 2:
            print(f"[CG-SHARDED] Iter {k:3d}: rel = {rr_new ** 0.5 / b_norm:e}")
        if rr_new ** 0.5 < tolerance * b_norm:
            converged = True
        else:
            t0 = time.perf_counter()
            p = pupd(jnp.asarray(rr_new / rr, dtype), r, p)
            jax.block_until_ready(p)
            stats.blas1_time_ms += (time.perf_counter() - t0) * 1e3
            n_block_calls["blas1"] += 1
        rr = rr_new
    _apply_dispatch_correction(stats, n_block_calls, n_read_calls, disp_block, disp_read)
    # this solver's reductions ARE its allreduces — mirror for single-chip field parity
    stats.reduction_time_ms = stats.allreduce_time_ms
    stats.total_time_ms = (time.perf_counter() - t_solve) * 1e3
    stats.iterations = k
    stats.converged = converged
    stats.residual_norm = rr ** 0.5
    stats.relative_residual = rr ** 0.5 / b_norm if b_norm else 0.0
    if op.row_pad:
        from ..dist import gather_to_host

        x = gather_to_host(x, rows=grid_size)  # multi-process-safe (see cg_solve_sharded)
    return x, stats


# ---------------------------------------------------------------------------
# 2-D domain decomposition — BEYOND the reference.
#
# The reference partitions 1-D row bands only (cg_solver_mgpu_partitioned.cu:262-331);
# its halo volume per device is O(g) regardless of device count.  A (Px, Py) 2-D mesh
# exchanges one row (g/Py wide) per N/S neighbor and one column (g/Px tall) per W/E
# neighbor: perimeter-scaled O(g/Py + g/Px) — asymptotically smaller as P grows, the
# standard scaling argument for stencil codes on 2-D meshes.
#
# Layout: the (g, g) field is block-sharded P("x", "y"); the 5 coefficient planes (when
# values-carrying) P(None, "x", "y").  The local SpMV reuses the row-halo stencils unchanged:
# they read zero beyond the block's west/east edges, so the two column-edge terms are ADDED
# as rank-1 updates:
#   values:  y[:, :1] += W_plane[:, :1] · halo_w ;  y[:, -1:] += E_plane[:, -1:] · halo_e
#   const:   y[:, :1] += offdiag · halo_w        ;  y[:, -1:] += offdiag · halo_e
# Global grid edges need no casing: ppermute zero-fills edge shards (Dirichlet as data,
# same invariant as the 1-D path).  5-point stencils touch no diagonal neighbors, so no
# corner exchange exists at all.
# ---------------------------------------------------------------------------


def _halo_exchange_2d(xb, ax_r: str, nr: int, ax_c: str, nc: int):
    """4-neighbor halo exchange: (halo_prev, halo_next) rows over ``ax_r`` and
    (halo_w, halo_e) columns over ``ax_c``.  Edge shards receive zeros."""
    hp, hn = _band_halo_exchange(xb, ax_r, nr)
    from ..bench import profiling

    with profiling.scope(profiling.PHASE_HALO):
        right = [(i, i + 1) for i in range(nc - 1)]  # my last col -> right shard's halo_w
        left = [(i + 1, i) for i in range(nc - 1)]  # my first col -> left shard's halo_e
        hw = jax.lax.ppermute(xb[:, -1:], ax_c, right)
        he = jax.lax.ppermute(xb[:, :1], ax_c, left)
    return hp, hn, hw, he


_SOLVER2D_CACHE = {}


def _check_2d_mesh(mesh: Mesh, g: int, mode: str):
    """Shared 2-D validation: a 2-axis mesh whose extents divide the grid exactly
    (2-D padding is not implemented — the error says what to use instead)."""
    if len(mesh.axis_names) != 2:
        raise ValueError(f"2-D solver needs a 2-axis mesh, got axes {mesh.axis_names}")
    ax_r, ax_c = mesh.axis_names
    nr, nc = (int(mesh.shape[ax_r]), int(mesh.shape[ax_c]))
    if g % nr or g % nc:
        raise ValueError(
            f"grid {g} must divide the mesh extents ({nr}, {nc}); "
            "use cg_solve_sharded (1-D, pads remainders) otherwise")
    if mode not in ("stencil5", "stencil5-bf16c", "stencil5-const"):
        raise ValueError(f"2-D solver supports the stencil modes, got {mode}")
    return ax_r, ax_c, nr, nc


def _shard_2d_planes(mesh, mode, planes, g, diag, offdiag, dtype):
    """Sharded (5, g, g) planes for the 2-D block decomposition: from the content-keyed
    cache when synthesized, or an uncached device_put of caller-provided (file) planes."""
    ax_r, ax_c = mesh.axis_names
    if mode == "stencil5-const":
        return jnp.zeros((), dtype), P()
    coeff_dtype = jnp.bfloat16 if mode == "stencil5-bf16c" else dtype
    pspec = P(None, ax_r, ax_c)
    if planes is None:
        return _sharded_planes(mesh, g, coeff_dtype, diag, offdiag, 0, pspec), pspec
    planes = jax.device_put(jnp.asarray(planes, coeff_dtype),
                            NamedSharding(mesh, pspec))
    return planes, pspec


def cg_solve_sharded_2d(mesh: Mesh, grid_size: int, *, mode: str = "stencil5",
                        planes=None, diag: float = 5.0, offdiag: float = -1.0,
                        tolerance: float = 1e-6, max_iters: int = 1000,
                        dtype=jnp.float32, b=None, overlap: bool = True):
    """CG over a 2-D (Px, Py) device mesh — block decomposition (see section comment).

    ``mesh`` must have exactly two axes; ``grid_size`` must divide by both extents
    (2-D padding is not implemented — use the 1-D solver for remainder grids).
    ``overlap=True`` (default) splits interior/boundary like the 1-D path: the core SpMV
    covers rows [1, rows−1) with LOCAL halo rows, so it has no data dependency on any of
    the four ppermutes — XLA can run all halo traffic under the core compute; only the
    two boundary rows and the two column-edge corrections consume halos.
    ``b``: optional (g, g) right-hand side (None → b = ones synthesized in-graph, the
    canonical protocol); ``planes``: optional host (5, g, g) coefficient planes (file
    operands).  Returns (x block-sharded (g, g), CGStats).

    The compiled solve and the sharded planes are cached per (mesh, problem, config) —
    Mesh hashes by content — so repeated benchmark solves measure the solve, never
    retracing (same discipline as the 1-D _SOLVER_CACHE).  BLAS1 stays XLA-fused here
    and every dot accumulates in ≥f32 regardless of the field dtype (a bf16 ⟨p,Ap⟩ would
    corrupt α/β — blas1.dot's rule)."""
    ax_r, ax_c, nr, nc = _check_2d_mesh(mesh, grid_size, mode)
    g = grid_size
    synth_b = b is None
    planes_arg, pspec = _shard_2d_planes(mesh, mode, planes, g, diag, offdiag, dtype)
    key = (mesh, g, mode, diag, offdiag, str(dtype), float(tolerance), max_iters,
           overlap, synth_b)
    solve = _SOLVER2D_CACHE.get(key)
    if solve is None:
        solve = _build_2d_solver(mesh, g, mode, diag, offdiag, float(tolerance),
                                 max_iters, dtype, overlap, pspec, synth_b)
        _SOLVER2D_CACHE[key] = solve
    if synth_b:
        t0 = time.perf_counter()
        x, scalars = solve(planes_arg)
    else:
        b = jax.device_put(jnp.asarray(b, dtype), NamedSharding(mesh, P(ax_r, ax_c)))
        t0 = time.perf_counter()
        x, scalars = solve(b, planes_arg)
    rr, k_f, b_norm = (float(v) for v in jax.device_get(scalars))
    x.block_until_ready()
    total_ms = (time.perf_counter() - t0) * 1e3
    res = rr ** 0.5
    return x, CGStats(
        iterations=int(k_f),
        converged=bool(res < tolerance * b_norm) if b_norm > 0 else True,
        residual_norm=res,
        relative_residual=res / b_norm if b_norm > 0 else 0.0,
        total_time_ms=total_ms,
    )


def cg_solve_sharded_2d_stepped(mesh: Mesh, grid_size: int, *, mode: str = "stencil5",
                                planes=None, diag: float = 5.0, offdiag: float = -1.0,
                                tolerance: float = 1e-6, max_iters: int = 1000,
                                dtype=jnp.float32, b=None, overlap: bool = True,
                                verbose: int = 0):
    """Host-stepped 2-D CG with per-collective wall timing — the ``--timers`` mode for the
    2-D block decomposition (same bucket semantics as ``cg_solve_sharded_stepped``; the
    halo bucket here times all FOUR ppermutes — two row + two column edges).  Dispatch
    floors are measured and subtracted (``_apply_dispatch_correction``)."""
    ax_r, ax_c, nr, nc = _check_2d_mesh(mesh, grid_size, mode)
    g = grid_size
    planes_arg, pspec = _shard_2d_planes(mesh, mode, planes, g, diag, offdiag, dtype)
    block_spec = P(ax_r, ax_c)

    def _apply(planes_l, p_l, hp, hn, hw, he):
        """Collective-free local block apply: halos PROVIDED (the sync-path math)."""
        if mode == "stencil5-const":
            y = spmv_stencil5_const_xla(p_l, diag, offdiag, hp, hn)
        else:
            y = spmv_stencil5_xla(planes_l, p_l, hp, hn)
        dw, de = _col_deltas(mode, offdiag, planes_l, p_l, hw, he)
        return y.at[:, :1].add(dw).at[:, -1:].add(de)

    halo = jax.jit(jax.shard_map(
        lambda v: _halo_exchange_2d(v, ax_r, nr, ax_c, nc),
        mesh=mesh, in_specs=(block_spec,), out_specs=(block_spec,) * 4,
        check_vma=False,
    ))
    spmv_local = jax.jit(jax.shard_map(
        _apply, mesh=mesh, in_specs=(pspec,) + (block_spec,) * 5,
        out_specs=block_spec, check_vma=False,
    ))
    dot_allreduce = jax.jit(jax.shard_map(
        lambda al, bl: jax.lax.psum(dot(al, bl), (ax_r, ax_c)),
        mesh=mesh, in_specs=(block_spec, block_spec), out_specs=P(),
        check_vma=False,
    ))
    # elementwise updates: plain jit — XLA keeps the block sharding, no shard_map needed
    upd_local = jax.jit(lambda alpha, xl, rl, pl_, apl: (xl + alpha * pl_,
                                                         rl - alpha * apl))
    pupd = jax.jit(lambda beta, rl, pl_: rl + beta * pl_)

    if b is None:
        b = jnp.ones((g, g), dtype)
    b = jax.device_put(jnp.asarray(b, dtype), NamedSharding(mesh, block_spec))

    from ..bench.probes import dispatch_baselines

    disp_block, disp_read = dispatch_baselines()
    n_block_calls = {"halo": 0, "spmv": 0, "blas1": 0}
    n_read_calls = 0
    stats = CGStats(dispatch_block_ms=disp_block, dispatch_readback_ms=disp_read)
    t_solve = time.perf_counter()
    x = jnp.zeros_like(b)
    r = b
    p = r
    t0 = time.perf_counter()
    rr = float(dot_allreduce(r, r))
    stats.allreduce_time_ms += (time.perf_counter() - t0) * 1e3
    n_read_calls += 1
    b_norm = rr ** 0.5
    k = 0
    converged = False
    while k < max_iters and not converged:
        t0 = time.perf_counter()
        hp, hn, hw, he = halo(p)
        jax.block_until_ready(he)
        stats.halo_time_ms += (time.perf_counter() - t0) * 1e3
        n_block_calls["halo"] += 1
        t0 = time.perf_counter()
        ap = spmv_local(planes_arg, p, hp, hn, hw, he)
        jax.block_until_ready(ap)
        stats.spmv_time_ms += (time.perf_counter() - t0) * 1e3
        n_block_calls["spmv"] += 1
        t0 = time.perf_counter()
        pap = float(dot_allreduce(p, ap))
        stats.allreduce_time_ms += (time.perf_counter() - t0) * 1e3
        n_read_calls += 1
        alpha = jnp.asarray(rr / pap, dtype)
        t0 = time.perf_counter()
        x, r = upd_local(alpha, x, r, p, ap)
        jax.block_until_ready(r)
        stats.blas1_time_ms += (time.perf_counter() - t0) * 1e3
        n_block_calls["blas1"] += 1
        t0 = time.perf_counter()
        rr_new = float(dot_allreduce(r, r))
        stats.allreduce_time_ms += (time.perf_counter() - t0) * 1e3
        n_read_calls += 1
        k += 1
        if verbose >= 2:
            print(f"[CG-SHARDED-2D] Iter {k:3d}: rel = {rr_new ** 0.5 / b_norm:e}")
        if rr_new ** 0.5 < tolerance * b_norm:
            converged = True
        else:
            t0 = time.perf_counter()
            p = pupd(jnp.asarray(rr_new / rr, dtype), r, p)
            jax.block_until_ready(p)
            stats.blas1_time_ms += (time.perf_counter() - t0) * 1e3
            n_block_calls["blas1"] += 1
        rr = rr_new
    _apply_dispatch_correction(stats, n_block_calls, n_read_calls, disp_block, disp_read)
    stats.reduction_time_ms = stats.allreduce_time_ms
    stats.total_time_ms = (time.perf_counter() - t_solve) * 1e3
    stats.iterations = k
    stats.converged = converged
    stats.residual_norm = rr ** 0.5
    stats.relative_residual = rr ** 0.5 / b_norm if b_norm else 0.0
    return x, stats


def _col_deltas(mode, offdiag, planes_l, p_l, hw, he, rows=slice(None)):
    """The two column-edge terms a block's west/east neighbours add (see section comment)."""
    from ..formats import E, W

    if mode == "stencil5-const":
        return offdiag * hw[rows], offdiag * he[rows]
    wcol = planes_l[W, rows, :1].astype(p_l.dtype)
    ecol = planes_l[E, rows, -1:].astype(p_l.dtype)
    return wcol * hw[rows], ecol * he[rows]


def _build_2d_solver(mesh, g, mode, diag, offdiag, tolerance, max_iters, dtype, overlap,
                     pspec, synth_b):
    ax_r, ax_c = mesh.axis_names
    nr, nc = (int(mesh.shape[ax_r]), int(mesh.shape[ax_c]))
    axes_both = (ax_r, ax_c)
    from ..formats import C as _C, E as _E, N as _N, S as _S, W as _W

    def _gdot(a, bb):
        return jax.lax.psum(dot(a, bb), axes_both)

    def _edge_row_y(prow, xrow, xn_row, xs_row, wcell, ecell):
        """One boundary row via XLA, halos INSIDE the shifts (so no masks: a zero halo at
        a true grid edge IS the Dirichlet condition, same invariant as everywhere)."""
        xw = jnp.concatenate([wcell, xrow[:, :-1]], axis=1)
        xe = jnp.concatenate([xrow[:, 1:], ecell], axis=1)
        if mode == "stencil5-const":
            return diag * xrow + offdiag * (xn_row + xs_row + xw + xe)
        return (prow[_C] * xrow + prow[_W] * xw + prow[_E] * xe
                + prow[_N] * xn_row + prow[_S] * xs_row).astype(xrow.dtype)

    def local_spmv_dot_sync(planes_l, p_l):
        hp, hn, hw, he = _halo_exchange_2d(p_l, ax_r, nr, ax_c, nc)
        if mode == "stencil5-const":
            y, dot_loc = spmv_dot_stencil5_const_xla(p_l, diag, offdiag, hp, hn)
        else:
            y, dot_loc = spmv_dot_stencil5_xla(planes_l, p_l, hp, hn)
        dw, de = _col_deltas(mode, offdiag, planes_l, p_l, hw, he)
        y = y.at[:, :1].add(dw).at[:, -1:].add(de)
        pap_loc = dot_loc + dot(p_l[:, :1], dw) + dot(p_l[:, -1:], de)
        return y, jax.lax.psum(pap_loc, axes_both)

    def local_spmv_dot_overlapped(planes_l, p_l):
        hp, hn, hw, he = _halo_exchange_2d(p_l, ax_r, nr, ax_c, nc)
        # CORE (rows [1:-1]): local halo rows only — independent of all four ppermutes
        if mode == "stencil5-const":
            y_core, dot_core = spmv_dot_stencil5_const_xla(
                p_l[1:-1], diag, offdiag, p_l[0:1], p_l[-1:])
        else:
            y_core, dot_core = spmv_dot_stencil5_xla(
                planes_l[:, 1:-1], p_l[1:-1], p_l[0:1], p_l[-1:])
        dw, de = _col_deltas(mode, offdiag, planes_l, p_l, hw, he, rows=slice(1, -1))
        y_core = y_core.at[:, :1].add(dw).at[:, -1:].add(de)
        # BOUNDARY rows 0 and −1: cheap XLA math consuming the halos
        p_first = None if mode == "stencil5-const" else planes_l[:, 0:1]
        p_last = None if mode == "stencil5-const" else planes_l[:, -1:]
        y_first = _edge_row_y(p_first, p_l[0:1], hp, p_l[1:2], hw[0:1], he[0:1])
        y_last = _edge_row_y(p_last, p_l[-1:], p_l[-2:-1], hn, hw[-1:], he[-1:])
        y = jnp.concatenate([y_first, y_core, y_last], axis=0)
        pap_loc = (dot_core
                   + dot(p_l[1:-1, :1], dw) + dot(p_l[1:-1, -1:], de)
                   + dot(p_l[0:1], y_first) + dot(p_l[-1:], y_last))
        return y, jax.lax.psum(pap_loc, axes_both)

    use_overlap = overlap and (g // nr) >= 3
    local_spmv_dot = local_spmv_dot_overlapped if use_overlap else local_spmv_dot_sync

    def local_cg(b_l, planes_l):
        if synth_b:
            b_l = jnp.ones((g // nr, g // nc), dtype)
        r0 = b_l  # x0 = 0
        rr0 = _gdot(r0, r0)
        b_norm = jnp.sqrt(rr0)
        tol2 = (tolerance * tolerance) * rr0

        def cond(state):
            _, _, _, rr, k = state
            return jnp.logical_and(k < max_iters, rr > tol2)

        def step(state):
            x, r, p, rr, k = state
            ap, pap = local_spmv_dot(planes_l, p)
            alpha = (rr / pap).astype(x.dtype)
            x = x + alpha * p
            r = r - alpha * ap
            rr_new = _gdot(r, r)
            beta = (rr_new / rr).astype(x.dtype)
            p = r + beta * p
            return x, r, p, rr_new, k + 1

        state0 = (jnp.zeros_like(b_l), r0, r0, rr0, jnp.zeros((), jnp.int32))
        x, r, p, rr, k = jax.lax.while_loop(cond, step, state0)
        sdt = rr.dtype if rr.dtype in (jnp.float32, jnp.float64) else jnp.float32
        return x, jnp.stack([rr.astype(sdt), k.astype(sdt), b_norm.astype(sdt)])

    if synth_b:
        sharded = jax.shard_map(
            lambda planes_l: local_cg(None, planes_l), mesh=mesh, in_specs=(pspec,),
            out_specs=(P(ax_r, ax_c), P()), check_vma=False,
        )
    else:
        sharded = jax.shard_map(
            local_cg, mesh=mesh, in_specs=(P(ax_r, ax_c), pspec),
            out_specs=(P(ax_r, ax_c), P()), check_vma=False,
        )
    return jax.jit(sharded)
