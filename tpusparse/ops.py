"""SpMV operator registry.

Parity with the reference's function-pointer vtable ``SpmvOperator {name, init, run_timed,
run_device, free}`` (include/spmv.h:125-134) and registry ``get_operator(mode)``
(src/spmv/spmv.cu:11-23).  Every mode runs as XLA's own fusions, except the f64 values-
carrying stencil's CG pass on the GPU, which is a Triton kernel.  Mode names:

  - ``"csr"`` / ``"cusparse-csr"`` — generic baseline (the reference's cuSPARSE-CSR role):
                           padded-ELL rows and an XLA gather of x, correct for any sparsity.
  - ``"csr-xla"`` / ``"ell"`` — the same ELL gather operator.
  - ``"dia"`` / ``"dia-xla"`` — diagonal-offset operator: y = Σ_d data[d]·shift(x).
  - ``"stencil5"`` / ``"stencil5-csr"`` — the structure-exploiting values-carrying stencil
                           (reference "stencil5-csr"): five coefficient planes, no index
                           traffic.  In f64 on the GPU its SpMV+dot is the Triton kernel
                           (kernels/stencil5_triton.py); otherwise the XLA form.
  - ``"stencil5-xla"``   — the same operator, always the XLA form: the kernel's oracle.
  - ``"stencil5-bf16c"`` — stencil5 with bf16 coefficient storage (bit-identical for exactly
                           representable fields, halves plane traffic).
  - ``"stencil5-const"`` / ``"stencil5-const-xla"`` — values-free constant-coefficient
                           operator (extension flagged in SURVEY.md §6), with the
                           recompute-Ap CG passes.
  - ``"bcoo"``           — jax.experimental.sparse BCOO matvec: the independent
                           industry-reference cross-check (the AmgX role, SURVEY.md §2.7).

Operator contract: ``init(matrix-ish) -> DeviceOperator`` with
  - ``run_device(x_field) -> y_field``         (reference run_device, zero host transfer)
  - ``run_device_dot(x) -> (y, <x,y>)``        (fused SpMV+dot for CG)
  - ``run_timed(x) -> (y, ms)``                (reference run_timed: includes one H2D/D2H)
  - ``free()``                                 (drop device references)
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import formats
from .formats import CSRMatrix, Stencil5
from .kernels import stencil5 as _st5
from .kernels.blas1 import dot


def _default_dtype():
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


@dataclasses.dataclass
class DeviceOperator:
    name: str
    num_rows: int
    num_cols: int
    nnz: int
    field_shape: tuple  # (rows, cols) 2-D view of the vector space (may include padding)
    run_device: Callable  # x_field -> y_field
    run_device_dot: Callable  # x_field -> (y_field, <x, A x>)
    grid_size: int = 0
    _buffers: Any = None
    # Explicit-operand forms: the CG solver jits over these so large device arrays enter the
    # compiled program as runtime ARGUMENTS, never as inline constants (a multi-GB inline
    # constant breaks compilation at 10k+ grids).  ``operands`` is any pytree of device
    # arrays; ``run_device_dot_op(x, operands) -> (y, <x,Ax>)``.
    operands: Any = ()
    run_device_op: Optional[Callable] = None
    run_device_dot_op: Optional[Callable] = None
    # optional recompute-Ap CG passes (kernels/stencil5.py): Ap never touches HBM —
    #   run_pupdate_dot_op(beta, r, p, operands) -> (p', <p', A·p'>)          (3 words/pt)
    #   run_update_recompute_op(alpha, x, r, p, operands) -> (x', r', <r',r'>) (5 words/pt)
    run_pupdate_dot_op: Optional[Callable] = None
    run_update_recompute_op: Optional[Callable] = None

    @property
    def field_elems(self) -> int:
        return self.field_shape[0] * self.field_shape[1]

    def as_field(self, x_flat):
        """Reshape a length-num_cols vector into the operator's 2-D field, zero-padding the
        tail when the field is larger than the vector space."""
        x = jnp.asarray(x_flat).reshape(-1)
        if x.shape[0] > self.field_elems:
            # .at[].set silently clips out-of-range updates — that would drop the tail of x
            raise ValueError(
                f"vector of length {x.shape[0]} does not fit the operator field "
                f"{self.field_shape} ({self.field_elems} elements)"
            )
        if self.field_elems != x.shape[0]:
            x = jnp.zeros((self.field_elems,), x.dtype).at[: x.shape[0]].set(x)
        return x.reshape(self.field_shape)

    def from_field(self, x_field):
        """Flatten a field back to the length-num_rows vector (drops padding)."""
        return jnp.asarray(x_field).reshape(-1)[: self.num_rows]

    def ones_b(self, dtype):
        """The canonical b = ones right-hand side, zero in any padded tail.  Built in the
        target dtype on the host — an f64 staging upload would double the H2D bytes and the
        transient device footprint."""
        return self.as_field(np.ones(self.num_cols, dtype=np.dtype(dtype)))

    def run_timed(self, x_flat_host: np.ndarray):
        """Reference run_timed semantics (spmv_cusparse_csr.cu:234-264): includes the H2D of x
        and D2H of y in the timed region — here wall clock around a fully synchronized call."""
        t0 = time.perf_counter()
        # cast on HOST before the H2D: uploading np.ones's f64 then casting on device
        # doubles both the transfer and the transient device footprint
        x_host = np.asarray(x_flat_host, dtype=np.dtype(self._run_dtype()))
        y = self.run_device(self.as_field(x_host))
        y_host = np.asarray(y).reshape(-1)[: self.num_rows]
        ms = (time.perf_counter() - t0) * 1e3
        return y_host, ms

    def run_timed_resident(self, x_field_dev):
        """Device-resident timed run — the reference's ACTUAL timed region
        (spmv_cusparse_csr.cu:234-264: x is uploaded ONCE before the run loop and y read
        back once after it; the per-run cudaEvent window wraps the kernel alone).
        ``run_timed`` above is the stricter transfer-inclusive wall protocol."""
        t0 = time.perf_counter()
        y = jax.block_until_ready(self.run_device(x_field_dev))
        return y, (time.perf_counter() - t0) * 1e3

    def kernel_time_ms(self, chain: int = 24, reps: int = 3) -> float:
        """Device-only kernel time — the analog of the reference's cudaEvent window around
        the kernel alone (spmv_cusparse_csr.cu:247-253): H2D/D2H and dispatch excluded.

        Protocol: PAIRED-CHAIN DIFFERENCING.  Two chained-apply runs (output feeds the next
        input) of lengths k_lo < k_hi are timed and the per-apply time is the slope
        (t_hi − t_lo)/(k_hi − k_lo).  The subtraction cancels every fixed cost: dispatch and
        the final ``block_until_ready``."""
        x = self.ones_b(self._run_dtype())
        jax.block_until_ready(self.run_device(x))  # compile + warm (untimed)
        t0 = time.perf_counter()
        jax.block_until_ready(self.run_device(x))
        probe_ms = (time.perf_counter() - t0) * 1e3
        # scale the chain to the operator's speed so slow generic paths (gather/bcoo at
        # hundreds of ms per apply) don't burn minutes: keep a rep under ~1 s.
        k_hi = max(4, min(chain, int(1000 / max(probe_ms, 1.0))))
        k_lo = max(1, k_hi // 4)
        if probe_ms > 300:
            reps = min(reps, 2)

        # Chain INSIDE one jitted program when the operator has an explicit-operand form:
        # the in-flight footprint is operand + 2 fields regardless of k, and one dispatch
        # per chain removes per-launch dispatch noise from the slope.
        prog = self._chain_program()

        def chain_run(k):
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                if prog is not None:
                    v = prog(x, self.operands, k=k)
                else:
                    v = x
                    for _ in range(k):
                        v = self.run_device(v)
                jax.block_until_ready(v)
                best = min(best, time.perf_counter() - t0)
            return best

        from .bench.probes import slope_seconds

        if prog is not None:
            # compile both chain lengths before timing
            jax.block_until_ready(prog(x, self.operands, k=k_lo))
            jax.block_until_ready(prog(x, self.operands, k=k_hi))
        t_lo = chain_run(k_lo)
        t_hi = chain_run(k_hi)
        # shared noise guard: a jitter-dominated negative slope falls back to the
        # (kernel-unflattering) chain average instead of exporting absurd numbers
        return slope_seconds(t_lo, t_hi, k_lo, k_hi) * 1e3

    def _chain_program(self):
        """Jitted k-apply chain over run_device_op — see kernel_time_ms.
        Returns None for closure-only operators (no explicit-operand form)."""
        if self.run_device_op is None:
            return None
        cached = getattr(self, "_chain_jit", None)
        if cached is None:
            rop = self.run_device_op

            @functools.partial(jax.jit, static_argnames=("k",))
            def chain_prog(x, operands, k):
                # STATIC unroll, not lax.fori_loop: a while-loop carry must alias the
                # loop parameter's buffer, so XLA may copy the body's result back into the
                # carry slot every iteration — one extra field read+write per apply.
                # Unrolled straight-line code lets buffer assignment ping-pong two field
                # buffers with no copy.
                #
                # FUSION FENCE between applies: nothing else stops XLA from fusing apply k's
                # elementwise work into apply k+1 — the chain would then under-count
                # per-apply memory traffic.  optimization_barrier forces each apply's result
                # to materialize before the next consumes it — the analog of the
                # reference's cudaEvent-around-the-kernel boundary
                # (spmv_cusparse_csr.cu:247-253).
                v = x
                for _ in range(k):
                    v = rop(v, operands)
                    v = jax.lax.optimization_barrier(v)
                return v

            object.__setattr__(self, "_chain_jit", chain_prog)
            cached = chain_prog
        return cached

    def _run_dtype(self):
        return self._buffers.get("dtype", _default_dtype()) if isinstance(
            self._buffers, dict) else _default_dtype()

    def free(self):
        """Drop ALL device references (reference op->free).  The operator is unusable after;
        re-init with get_operator.  Clearing the callables matters: the _wrap_ops closures
        hold the operands, so nulling _buffers alone would keep the device arrays alive."""
        def _freed(*_a, **_k):
            raise RuntimeError("operator was freed; re-create it with get_operator()")

        self._buffers = None
        self.operands = ()
        self.run_device = _freed
        self.run_device_dot = _freed
        self.run_device_op = _freed
        self.run_device_dot_op = _freed
        self.run_pupdate_dot_op = None
        self.run_update_recompute_op = None
        # the chain program's closure captures the pre-free run_device_op (and through
        # it the operands) — dropping it here is what actually releases that memory
        if getattr(self, "_chain_jit", None) is not None:
            object.__setattr__(self, "_chain_jit", None)


def _wrap_ops(run_device_op, run_device_dot_op, operands):
    """Build (run_device, run_device_dot) from the explicit-operand forms.

    THE invariant for every operator: device arrays enter jitted programs only as runtime
    ARGUMENTS.  A jit that closes over an operand embeds it as an inline constant in the
    compiled program, which breaks large grids (multi-GB embeddings).  This helper is the
    single place that invariant lives."""
    _apply = jax.jit(run_device_op)
    _apply_dot = jax.jit(run_device_dot_op)
    return (lambda x: _apply(x, operands)), (lambda x: _apply_dot(x, operands))


# ---------------------------------------------------------------------------
# Stencil operators
# ---------------------------------------------------------------------------


def _planes_device(st: Stencil5, dtype):
    """Device coefficient planes for a Stencil5.  ``planes=None`` with ``constant`` set
    synthesizes them DIRECTLY ON DEVICE (generate.make_stencil5_planes_device) instead of a
    multi-GB host→device upload, bit-identical to uploading the host generator's planes
    (same masks, same constants)."""
    if st.planes is None:
        if st.constant is None:
            raise ValueError("Stencil5 needs planes or constant coefficients")
        from .generate import make_stencil5_planes_device

        return make_stencil5_planes_device(st.grid_size, *st.constant, dtype=dtype)
    return jnp.asarray(st.planes, dtype)


def _use_triton(dtype, coeff_dtype) -> bool:
    """The Triton SpMV+dot kernel runs where it beat XLA inside the whole CG solve on the
    H100: f64 state and f64 planes on the GPU.  In f32 and with bf16 planes XLA's fusions
    were faster (PERF.md), and off the GPU the kernel cannot compile."""
    return (jax.default_backend() == "gpu" and jnp.dtype(dtype) == jnp.float64
            and jnp.dtype(coeff_dtype or dtype) == jnp.float64)


def _init_stencil5(st: Stencil5, dtype=None, coeff_dtype=None,
                   xla_only: bool = False) -> DeviceOperator:
    """Values-carrying stencil (kernels/stencil5.spmv_stencil5_xla).  ``coeff_dtype``
    (mode "stencil5-bf16c") stores the coefficient planes in bf16 while the vector state
    keeps ``dtype``: plane traffic halves.  For coefficient fields exactly representable in
    bf16 (the stencil's 5.0 / −1.0 / 0.0 included) the results are BIT-IDENTICAL to full
    storage; for general fields the coefficients round to an 8-bit mantissa.
    ``xla_only`` keeps the CG pass in XLA where the Triton kernel would otherwise run."""
    dtype = dtype or _default_dtype()
    g = st.grid_size
    planes = _planes_device(st, coeff_dtype or dtype)

    def run_device_op(x, operands):
        return _st5.spmv_stencil5_xla(operands[0], x)

    if not xla_only and _use_triton(dtype, coeff_dtype):
        from .kernels.stencil5_triton import spmv_dot_stencil5_triton

        def run_device_dot_op(x, operands):
            return spmv_dot_stencil5_triton(operands[0], x)
    else:
        def run_device_dot_op(x, operands):
            return _st5.spmv_dot_stencil5_xla(operands[0], x)

    run_device, run_device_dot = _wrap_ops(run_device_op, run_device_dot_op, (planes,))

    return DeviceOperator(
        name="stencil5", num_rows=g * g, num_cols=g * g, nnz=st.nnz,
        field_shape=(g, g), run_device=run_device, run_device_dot=run_device_dot,
        grid_size=g, _buffers={"planes": planes, "dtype": dtype},
        operands=(planes,), run_device_op=run_device_op,
        run_device_dot_op=run_device_dot_op,
    )


def _init_stencil5_const(st: Stencil5, dtype=None) -> DeviceOperator:
    """Values-free constant-coefficient operator, with the recompute-Ap CG passes."""
    if st.constant is None:
        raise ValueError("stencil5-const requires uniform coefficients")
    dtype = dtype or _default_dtype()
    g = st.grid_size
    diag, offdiag = st.constant

    def run_device_op(x, operands):
        return _st5.spmv_stencil5_const_xla(x, diag, offdiag)

    def run_device_dot_op(x, operands):
        return _st5.spmv_dot_stencil5_const_xla(x, diag, offdiag)

    def run_pupdate_dot_op(beta, r, p, operands):
        return _st5.const_pupdate_dot(beta, r, p, diag, offdiag)

    def run_update_recompute_op(alpha, x, r, p, operands):
        return _st5.const_update_recompute(alpha, x, r, p, diag, offdiag)

    run_device, run_device_dot = _wrap_ops(run_device_op, run_device_dot_op, ())

    return DeviceOperator(
        name="stencil5-const", num_rows=g * g, num_cols=g * g, nnz=st.nnz,
        field_shape=(g, g), run_device=run_device, run_device_dot=run_device_dot,
        grid_size=g, _buffers={"dtype": dtype},
        operands=(), run_device_op=run_device_op,
        run_device_dot_op=run_device_dot_op,
        run_pupdate_dot_op=run_pupdate_dot_op,
        run_update_recompute_op=run_update_recompute_op,
    )


# ---------------------------------------------------------------------------
# Generic paths
# ---------------------------------------------------------------------------


def _field_shape_for(n: int) -> tuple:
    """Factor n into a 2-D field shape (the CG state is 2-D everywhere).  When n has no
    128-multiple factor, the field is zero-PADDED to (ceil(n/128), 128) rather than degraded
    to (n, 1).  The as_field/ones_b machinery zero-fills the tail; operators built on this
    shape must keep the tail zero in their outputs (see _pad_to_field)."""
    for cols in (1024, 512, 256, 128):
        if n % cols == 0:
            return (n // cols, cols)
    return (-(-n // 128), 128)


def _pad_to_field(y_flat, fshape):
    """Reshape a length-n result vector into a possibly padded field, zero tail."""
    elems = fshape[0] * fshape[1]
    n = y_flat.shape[0]
    if elems != n:
        y_flat = jnp.zeros((elems,), y_flat.dtype).at[:n].set(y_flat)
    return y_flat.reshape(fshape)


def _flat_dot_op(run_device_op):
    def run_device_dot_op(x, operands):
        # y's padded tail is zero, so the full-field dot equals the length-n dot
        y = run_device_op(x, operands)
        return y, dot(x, y)

    return run_device_dot_op


def _init_ell_xla(mat, dtype=None, width: Optional[int] = None) -> DeviceOperator:
    """Generic gather SpMV: CSR/COO → padded ELL, the gather x[col] an XLA gather — correct
    for arbitrary matrices (the cuSPARSE-CSR baseline role, spmv_cusparse_csr.cu:182-285)."""
    dtype = dtype or _default_dtype()
    if isinstance(mat, Stencil5) and width is None:
        ell = formats.stencil5_to_ell(mat)  # O(n) plane pack, no CSR intermediate
        nnz = int(np.count_nonzero(ell.val))
    else:
        csr = _as_csr(mat)
        ell = formats.csr_to_ell(csr, width)
        nnz = csr.nnz
    idx_dtype = jnp.int32 if ell.num_cols < 2 ** 31 else jnp.int64
    cols_d = jnp.asarray(ell.col, idx_dtype)
    vals_d = jnp.asarray(ell.val, dtype)
    fshape = _field_shape_for(ell.num_rows)

    def run_device_op(x, operands):
        cols, vals = operands
        y = jnp.sum(vals * x.reshape(-1)[cols], axis=1)
        return _pad_to_field(y, fshape)

    run_device_dot_op = _flat_dot_op(run_device_op)
    run_device, run_device_dot = _wrap_ops(run_device_op, run_device_dot_op,
                                           (cols_d, vals_d))

    return DeviceOperator(
        name="csr", num_rows=ell.num_rows, num_cols=ell.num_cols, nnz=nnz,
        field_shape=fshape, run_device=run_device, run_device_dot=run_device_dot,
        grid_size=ell.grid_size, _buffers={"col": cols_d, "val": vals_d, "dtype": dtype},
        operands=(cols_d, vals_d), run_device_op=run_device_op,
        run_device_dot_op=run_device_dot_op,
    )


def _init_dia_xla(mat, dtype=None) -> DeviceOperator:
    """Diagonal-offset operator: y = Σ_d data[d]·shift_d(x), gather-free, for matrices with
    few distinct diagonals (every stencil and the reference's fixtures)."""
    dtype = dtype or _default_dtype()
    if isinstance(mat, Stencil5):
        dia = formats.stencil5_to_dia(mat)  # O(n) plane pack, no CSR intermediate
        nnz = mat.nnz
    else:
        csr = _as_csr(mat)
        dia = formats.csr_to_dia(csr)
        nnz = csr.nnz
    n = dia.num_rows
    data_d = jnp.asarray(dia.data, dtype)  # (ndiag, n)
    offsets = [int(o) for o in dia.offsets]
    fshape = _field_shape_for(n)

    def run_device_op(x, operands):
        (data,) = operands
        xf = x.reshape(-1)
        y = jnp.zeros((n,), dtype)
        for d, off in enumerate(offsets):
            lo = max(0, -off)
            hi = min(n, n - off)
            if hi <= lo:
                continue
            seg = data[d, lo:hi] * jax.lax.dynamic_slice_in_dim(xf, lo + off, hi - lo)
            y = y.at[lo:hi].add(seg)
        return _pad_to_field(y, fshape)

    run_device_dot_op = _flat_dot_op(run_device_op)
    run_device, run_device_dot = _wrap_ops(run_device_op, run_device_dot_op, (data_d,))

    return DeviceOperator(
        name="dia", num_rows=n, num_cols=dia.num_cols, nnz=nnz,
        field_shape=fshape, run_device=run_device, run_device_dot=run_device_dot,
        grid_size=dia.grid_size, _buffers={"data": data_d, "dtype": dtype},
        operands=(data_d,), run_device_op=run_device_op,
        run_device_dot_op=run_device_dot_op,
    )


def _init_bcoo(mat, dtype=None) -> DeviceOperator:
    """jax.experimental.sparse BCOO matvec — the independent cross-check baseline
    (the AmgX comparison role, SURVEY.md §2.7)."""
    from jax.experimental import sparse as jsparse

    dtype = dtype or _default_dtype()
    csr = _as_csr(mat)
    coo = formats.csr_to_coo(csr)
    idx_dtype = jnp.int32 if max(csr.num_rows, csr.num_cols) < 2 ** 31 else jnp.int64
    indices = jnp.stack(
        [jnp.asarray(coo.row, idx_dtype), jnp.asarray(coo.col, idx_dtype)], axis=1
    )
    bcoo = jsparse.BCOO(
        (jnp.asarray(coo.val, dtype), indices), shape=(csr.num_rows, csr.num_cols)
    )
    fshape = _field_shape_for(csr.num_rows)

    def run_device_op(x, operands):
        return _pad_to_field(operands[0] @ x.reshape(-1)[: csr.num_cols], fshape)

    run_device_dot_op = _flat_dot_op(run_device_op)
    run_device, run_device_dot = _wrap_ops(run_device_op, run_device_dot_op, (bcoo,))

    return DeviceOperator(
        name="bcoo", num_rows=csr.num_rows, num_cols=csr.num_cols, nnz=csr.nnz,
        field_shape=fshape, run_device=run_device, run_device_dot=run_device_dot,
        grid_size=csr.grid_size, _buffers={"bcoo": bcoo, "dtype": dtype},
        operands=(bcoo,), run_device_op=run_device_op,
        run_device_dot_op=run_device_dot_op,
    )


def _as_csr(mat) -> CSRMatrix:
    if isinstance(mat, CSRMatrix):
        return mat
    if isinstance(mat, formats.COOMatrix):
        return formats.coo_to_csr(mat)
    if isinstance(mat, Stencil5):
        return formats.stencil5_to_csr(mat)
    raise TypeError(f"cannot interpret {type(mat)} as a matrix")


def _as_stencil5(mat) -> Stencil5:
    if isinstance(mat, Stencil5):
        return mat
    return formats.csr_to_stencil5(_as_csr(mat))


_REGISTRY: Dict[str, Callable] = {
    "csr": lambda m, **kw: _init_ell_xla(m, **kw),
    "csr-xla": lambda m, **kw: _init_ell_xla(m, **kw),
    "ell": lambda m, **kw: _init_ell_xla(m, **kw),
    "dia": lambda m, **kw: _init_dia_xla(m, **kw),
    "dia-xla": lambda m, **kw: _init_dia_xla(m, **kw),
    "bcoo": lambda m, **kw: _init_bcoo(m, **kw),
    "stencil5": lambda m, **kw: _init_stencil5(_as_stencil5(m), **kw),
    "stencil5-xla": lambda m, **kw: _init_stencil5(_as_stencil5(m), xla_only=True, **kw),
    "stencil5-const": lambda m, **kw: _init_stencil5_const(_as_stencil5(m), **kw),
    "stencil5-const-xla": lambda m, **kw: _init_stencil5_const(_as_stencil5(m), **kw),
    "stencil5-bf16c": lambda m, **kw: _init_stencil5(
        _as_stencil5(m), coeff_dtype=jnp.bfloat16, **kw),
    # reference-compatible aliases (src/spmv/spmv.cu:12-15)
    "cusparse-csr": lambda m, **kw: _init_ell_xla(m, **kw),
    "stencil5-csr": lambda m, **kw: _init_stencil5(_as_stencil5(m), **kw),
}


def available_modes():
    return sorted(_REGISTRY)


def get_operator(mode: str, mat, dtype=None) -> DeviceOperator:
    """Build a device operator (reference get_operator + op->init in one step).  The
    operator carries the requested mode as its name, so exports say what the user asked
    for."""
    if mode not in _REGISTRY:
        raise ValueError(f"unknown SpMV mode '{mode}'; available: {available_modes()}")
    op = _REGISTRY[mode](mat, dtype=dtype)
    op.name = mode
    return op
