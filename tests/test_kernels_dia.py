"""Diagonal-offset SpMV (the ``dia`` / ``dia-xla`` modes): gather-free y = Σ_d data[d]·shift(x)
for matrices with few distinct diagonals."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpusparse import formats, generate, ops

from . import fixtures


def _dia_spmv(csr, x, mode="dia-xla"):
    op = ops.get_operator(mode, csr, dtype=jnp.float64)
    y, _ = op.run_timed(x)
    return y


@pytest.mark.parametrize(
    "make",
    [
        lambda: fixtures.identity(40),
        lambda: fixtures.tridiagonal(300),
        lambda: fixtures.banded(257, 5),
        lambda: fixtures.diagonal(np.arange(1.0, 130.0)),
        lambda: fixtures.spd_stencil_csr(13),
        lambda: fixtures.spd_stencil_csr(24),
    ],
)
def test_dia_matches_dense(make):
    csr = make()
    x = np.random.RandomState(1).randn(csr.num_cols)
    y_ref = csr.to_dense() @ x
    np.testing.assert_allclose(_dia_spmv(csr, x), y_ref, rtol=1e-12, atol=1e-12)


def test_dia_large_offsets():
    """Offsets far from the main diagonal (±300 in a 600-row matrix)."""
    n = 600
    rows = np.concatenate([np.arange(n), np.arange(n - 300)]).astype(np.int64)
    cols = np.concatenate([np.arange(n), np.arange(300, n)]).astype(np.int64)
    vals = np.concatenate([np.full(n, 2.0), np.full(n - 300, -0.5)])
    csr = formats.coo_to_csr(formats.COOMatrix(n, n, rows, cols, vals))
    x = np.random.RandomState(2).randn(n)
    np.testing.assert_allclose(_dia_spmv(csr, x), csr.to_dense() @ x, rtol=1e-12)


def test_dia_operator_through_registry():
    st = generate.make_stencil5(17)
    csr = formats.stencil5_to_csr(st)
    op = ops.get_operator("dia", csr, dtype=jnp.float64)
    x = np.random.RandomState(3).randn(op.num_cols)
    y, _ = op.run_timed(x)
    np.testing.assert_allclose(y, csr.to_dense() @ x, rtol=1e-12, atol=1e-12)
    # padded field round-trip
    xf = op.as_field(x)
    assert xf.shape == op.field_shape
    np.testing.assert_allclose(np.asarray(op.from_field(xf)), x)
    # fused dot
    yf, dot = op.run_device_dot(op.as_field(x).astype(jnp.float64))
    np.testing.assert_allclose(float(dot), float(x @ (csr.to_dense() @ x)), rtol=1e-12)


def test_dia_and_dia_xla_agree():
    csr = fixtures.banded(200, 3)
    x = np.random.RandomState(4).randn(200)
    np.testing.assert_allclose(_dia_spmv(csr, x, "dia"), _dia_spmv(csr, x, "dia-xla"),
                               rtol=1e-13)
