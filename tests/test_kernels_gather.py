"""Generic gather SpMV (the ``csr`` / ``cusparse-csr`` modes: padded ELL + an XLA gather):
correctness against dense oracles and CG integration.

The operator's claim is GENERALITY (the cuSPARSE-CSR baseline role, reference
spmv_cusparse_csr.cu:182-285): these tests feed it matrices the stencil operators cannot
represent — random values in random banded positions, variable row lengths, width-1
diagonals, columns scattered across the whole matrix — and require exact agreement with the
dense product."""

import numpy as np
import pytest

import jax.numpy as jnp

from tpusparse import formats, generate, ops


def _random_banded_csr(n, bandwidth, max_row_nnz, seed):
    """Random matrix with nonzeros scattered inside a band."""
    rng = np.random.RandomState(seed)
    rows, cols, vals = [], [], []
    for r in range(n):
        k = rng.randint(1, max_row_nnz + 1)
        lo, hi = max(0, r - bandwidth), min(n, r + bandwidth + 1)
        c = np.unique(rng.randint(lo, hi, size=k))
        rows.extend([r] * len(c))
        cols.extend(c.tolist())
        vals.extend(rng.randn(len(c)).tolist())
    coo = formats.COOMatrix(
        num_rows=n, num_cols=n,
        row=np.asarray(rows, np.int64), col=np.asarray(cols, np.int64),
        val=np.asarray(vals, np.float64),
    )
    return formats.coo_to_csr(coo)


def _apply(op, x):
    return np.asarray(op.from_field(op.run_device(op.as_field(x).astype(jnp.float64))))


@pytest.mark.parametrize("n,bw,w", [(500, 9, 4), (1500, 300, 7), (2100, 64, 3)])
def test_gather_matches_dense_random_banded(n, bw, w):
    csr = _random_banded_csr(n, bw, w, seed=n)
    op = ops.get_operator("csr", csr, dtype=jnp.float64)
    x = np.random.RandomState(1).randn(n)
    np.testing.assert_allclose(_apply(op, x), csr.to_dense() @ x, rtol=1e-12, atol=1e-12)


def test_gather_width_one_diagonal():
    n = 700
    d = np.linspace(1.0, 2.0, n)
    coo = formats.COOMatrix(num_rows=n, num_cols=n,
                            row=np.arange(n, dtype=np.int64),
                            col=np.arange(n, dtype=np.int64), val=d)
    op = ops.get_operator("csr", formats.coo_to_csr(coo), dtype=jnp.float64)
    x = np.random.RandomState(2).randn(n)
    np.testing.assert_allclose(_apply(op, x), d * x, rtol=1e-13)


def test_gather_scattered_columns():
    """Columns scattered uniformly across the whole matrix: a plain gather has no
    locality requirement."""
    n = 3000
    rng = np.random.RandomState(7)
    rows = np.repeat(np.arange(n, dtype=np.int64), 3)
    cols = rng.randint(0, n, size=3 * n).astype(np.int64)
    vals = rng.randn(3 * n)
    csr = formats.coo_to_csr(formats.COOMatrix(num_rows=n, num_cols=n, row=rows, col=cols,
                                               val=vals))
    op = ops.get_operator("csr", csr, dtype=jnp.float64)
    x = np.random.RandomState(8).randn(n)
    np.testing.assert_allclose(_apply(op, x), csr.to_dense() @ x, rtol=1e-12, atol=1e-12)


def test_gather_stencil_cross_validates_all_grids():
    for g in (8, 33, 81):
        st = generate.make_stencil5(g)
        dense = formats.stencil5_to_csr(st).to_dense()
        op = ops.get_operator("csr", st, dtype=jnp.float64)
        x = np.random.RandomState(g).randn(g * g)
        np.testing.assert_allclose(_apply(op, x), dense @ x, rtol=1e-12, atol=1e-12)


def test_gather_cg_solve_iteration_parity():
    """The gather operator inside CG matches the numpy reference algorithm exactly
    (f64) — the operator-seam property the registry promises."""
    from tests.test_cg import reference_cg
    from tpusparse.solvers import cg

    g = 16
    st = generate.make_stencil5(g)
    A = formats.stencil5_to_csr(st).to_dense()
    b = np.ones(g * g)
    x_ref, iters_ref, _ = reference_cg(A, b)
    op = ops.get_operator("csr", st, dtype=jnp.float64)
    x, stats = cg.cg_solve(op, op.as_field(b).astype(jnp.float64))
    assert stats.iterations == iters_ref
    np.testing.assert_allclose(np.asarray(op.from_field(x)), x_ref, rtol=1e-8, atol=1e-10)


def test_gather_rectangular_padding_rows_stay_zero():
    """Field slots past num_rows (the padded tail of a 300-row vector in a (3, 128) field)
    must output exactly zero."""
    n = 300
    csr = _random_banded_csr(n, 5, 3, seed=3)
    op = ops.get_operator("csr", csr, dtype=jnp.float64)
    assert op.field_elems > n
    x = np.random.RandomState(4).randn(n)
    yf = np.asarray(op.run_device(op.as_field(x).astype(jnp.float64))).ravel()
    assert np.all(yf[n:] == 0.0)


def test_gather_matches_dense_random_banded_f32():
    n = 800
    csr = _random_banded_csr(n, 40, 5, seed=4)
    op = ops.get_operator("csr", csr, dtype=jnp.float32)
    x = np.random.RandomState(5).randn(n).astype(np.float32)
    y = np.asarray(op.from_field(op.run_device(op.as_field(x))), np.float64)
    np.testing.assert_allclose(y, csr.to_dense() @ x.astype(np.float64), rtol=1e-4,
                               atol=1e-4)


def test_gather_stencil_f32_vs_xla_oracle():
    g = 64
    st = generate.make_stencil5(g)
    op = ops.get_operator("csr", st, dtype=jnp.float32)
    op_ref = ops.get_operator("stencil5-xla", st, dtype=jnp.float32)
    x = np.random.RandomState(6).randn(g * g).astype(np.float32)
    y = np.asarray(op.from_field(op.run_device(op.as_field(x))), np.float64)
    yr = np.asarray(op_ref.from_field(op_ref.run_device(op_ref.as_field(x))), np.float64)
    np.testing.assert_allclose(y, yr, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["csr", "cusparse-csr", "csr-xla", "ell"])
def test_csr_names_share_the_gather_operator(mode):
    """Every generic-CSR name in the registry is the same ELL gather operator, fused dot
    included."""
    csr = _random_banded_csr(257, 12, 4, seed=9)
    op = ops.get_operator(mode, csr, dtype=jnp.float64)
    assert op.name == mode and set(op._buffers) >= {"col", "val"}
    x = np.random.RandomState(10).randn(257)
    y, dot = op.run_device_dot(op.as_field(x).astype(jnp.float64))
    y_ref = csr.to_dense() @ x
    np.testing.assert_allclose(np.asarray(op.from_field(y)), y_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(dot), float(x @ y_ref), rtol=1e-12)
