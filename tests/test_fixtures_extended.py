"""Fixture-library parity with the reference's remaining generators
(tests/helpers/matrix_fixtures.hpp:38-141): ill-conditioned, dense-block, unbalanced-rows,
and 9-point stencil — pointed, as the reference does, at exactly the machinery they
stress: the gather operator's arbitrary sparsity, ELL pad ratios, the DIA diagonal set, and
CG's conditioning behavior."""

import numpy as np
import pytest

import jax.numpy as jnp

from tests import fixtures
from tpusparse import formats, ops
from tpusparse.solvers import cg


def test_ill_conditioned_cg_and_analytic_solution():
    """SPD diagonal with κ = 1e8: CG must still converge (Krylov exactness gives ≤ n
    distinct-eigenvalue termination) and the solve of A x = ones has the analytic
    solution x_i = 1/d_i.  tol must respect the κ·eps ≈ 2e-8 attainable-residual floor
    of f64 at this conditioning — exactly the behavior this fixture exists to expose."""
    n = 48
    csr = fixtures.ill_conditioned(n, cond=1e8)
    d = csr.to_dense().diagonal()
    op = ops.get_operator("csr", csr, dtype=jnp.float64)
    b = op.as_field(np.ones(n)).astype(jnp.float64)
    x, st = cg.cg_solve(op, b, config=cg.CGConfig(tolerance=1e-6, max_iters=500))
    assert st.converged, st
    got = np.asarray(op.from_field(x))
    np.testing.assert_allclose(got, 1.0 / d, rtol=1e-3)


@pytest.mark.parametrize("mode", ["csr", "csr-xla", "dia", "bcoo"])
def test_ill_conditioned_spmv_exact(mode):
    """The extreme value range (1 … 1e-12) must survive every format's round trip."""
    n = 96
    csr = fixtures.ill_conditioned(n, cond=1e12)
    op = ops.get_operator(mode, csr, dtype=jnp.float64)
    x = np.random.RandomState(2).randn(n)
    y = np.asarray(op.from_field(op.run_device(op.as_field(x).astype(jnp.float64))))
    np.testing.assert_allclose(y, csr.to_dense() @ x, rtol=1e-13, atol=0)


@pytest.mark.parametrize("block,start", [(24, 100), (40, 0)])
def test_dense_block_gather_window_stress(block, start):
    """One dense block inside an identity: ELL width jumps to ``block`` while most rows
    carry 1 nnz — the worst case for the padded-ELL gather (mostly padding slots)."""
    n = 512
    csr = fixtures.dense_block(n, block, block_start=start)
    dense = csr.to_dense()
    op = ops.get_operator("csr", csr, dtype=jnp.float64)
    x = np.random.RandomState(3).randn(n)
    y = np.asarray(op.from_field(op.run_device(op.as_field(x).astype(jnp.float64))))
    np.testing.assert_allclose(y, dense @ x, rtol=1e-12, atol=1e-12)


def test_unbalanced_rows_span_overflow_machinery():
    """Periodic heavy rows with nonzeros scattered across the FULL width: the ELL width is
    set by the heavy rows and their gathers reach across the whole vector — the result
    must be exact."""
    n = 2048
    csr = fixtures.unbalanced_rows(n, heavy_every=37, heavy_nnz=40)
    dense = csr.to_dense()
    op = ops.get_operator("csr", csr, dtype=jnp.float64)
    x = np.random.RandomState(5).randn(n)
    y = np.asarray(op.from_field(op.run_device(op.as_field(x).astype(jnp.float64))))
    np.testing.assert_allclose(y, dense @ x, rtol=1e-12, atol=1e-12)
    y2, dot = op.run_device_dot(op.as_field(x).astype(jnp.float64))
    np.testing.assert_allclose(float(dot), x @ (dense @ x), rtol=1e-12)


@pytest.mark.parametrize("mode", ["csr", "dia", "bcoo"])
def test_ninepoint_stencil_generic_paths(mode):
    """9-point stencil: 9 distinct diagonals (DIA's natural case), NOT
    stencil5-extractable — the generic paths must carry it, checksum analytic."""
    g = 24
    csr = fixtures.ninepoint(g)
    op = ops.get_operator(mode, csr, dtype=jnp.float64)
    n = g * g
    y = np.asarray(op.from_field(op.run_device(op.as_field(np.ones(n)).astype(
        jnp.float64))))
    assert abs(y.sum() - fixtures.ninepoint_checksum(g)) < 1e-9
    x = np.random.RandomState(7).randn(n)
    y = np.asarray(op.from_field(op.run_device(op.as_field(x).astype(jnp.float64))))
    np.testing.assert_allclose(y, csr.to_dense() @ x, rtol=1e-12, atol=1e-12)


def test_ninepoint_rejects_stencil5_extraction():
    with pytest.raises(ValueError, match="outside the 5-point stencil"):
        formats.csr_to_stencil5(fixtures.ninepoint(8), grid_size=8)


def test_ninepoint_dia_diagonal_set():
    """The DIA conversion must find exactly the 9 stencil offsets."""
    g = 16
    dia = formats.csr_to_dia(fixtures.ninepoint(g))
    expect = sorted([-g - 1, -g, -g + 1, -1, 0, 1, g - 1, g, g + 1])
    assert sorted(int(o) for o in dia.offsets) == expect
