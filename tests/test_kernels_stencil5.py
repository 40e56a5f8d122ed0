"""STENCIL5 SpMV correctness (kernels/stencil5.py, the XLA forms).

The oracle discipline mirrors the reference (SURVEY.md §4): a dense/numpy reference is the
oracle for the stencil formulation (generic-validates-specialized, test_wrapper_basic.cpp:
159-193 does CSR-vs-STENCIL5 at 1e-12), and everything is cross-checked in f64."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpusparse import formats, generate
from tpusparse.formats import C, E, N, S, W
from tpusparse.kernels.stencil5 import (
    const_pupdate_dot,
    const_update_recompute,
    spmv_dot_stencil5_const_xla,
    spmv_dot_stencil5_xla,
    spmv_stencil5_const_xla,
    spmv_stencil5_xla,
)

from . import fixtures

GRIDS = [1, 2, 3, 5, 8, 13, 16, 31]


def _setup(g, seed=0):
    st = generate.make_stencil5(g)
    dense = fixtures.spd_stencil_csr(g).to_dense()
    x = np.random.RandomState(seed).randn(g * g)
    return st, dense, x, dense @ x


def _loop_apply(planes, x, halo_prev=None, halo_next=None):
    """Point-by-point y = A·x on a (rows, cols) band, neighbours outside it from the halo
    rows (or zero): an oracle written without shifts or concatenations."""
    rows, cols = x.shape
    hp = np.zeros(cols) if halo_prev is None else np.asarray(halo_prev).ravel()
    hn = np.zeros(cols) if halo_next is None else np.asarray(halo_next).ravel()
    y = np.zeros((rows, cols))
    for i in range(rows):
        for j in range(cols):
            north = x[i - 1, j] if i > 0 else hp[j]
            south = x[i + 1, j] if i < rows - 1 else hn[j]
            west = x[i, j - 1] if j > 0 else 0.0
            east = x[i, j + 1] if j < cols - 1 else 0.0
            y[i, j] = (planes[C, i, j] * x[i, j] + planes[N, i, j] * north
                       + planes[S, i, j] * south + planes[W, i, j] * west
                       + planes[E, i, j] * east)
    return y


@pytest.mark.parametrize("g", GRIDS)
def test_xla_matches_dense(g):
    st, dense, x, y_ref = _setup(g)
    y = spmv_stencil5_xla(jnp.asarray(st.planes), jnp.asarray(x.reshape(g, g)))
    np.testing.assert_allclose(np.asarray(y).ravel(), y_ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("g", GRIDS)
def test_xla_matches_dense_f32(g):
    """f32 state and planes within the f32 tier of the f64 oracle (the tolerance-tier
    discipline of the reference, cuda_test_utils.hpp:48-59)."""
    st, dense, x, y_ref = _setup(g)
    y = spmv_stencil5_xla(jnp.asarray(st.planes, jnp.float32),
                          jnp.asarray(x.reshape(g, g), jnp.float32))
    assert y.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(y, np.float64).ravel(), y_ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("g", GRIDS)
def test_spmv_dot_matches_dense(g):
    """The fused CG pass: (A·x, <x, A·x>)."""
    st, dense, x, y_ref = _setup(g)
    y, dot = spmv_dot_stencil5_xla(jnp.asarray(st.planes), jnp.asarray(x.reshape(g, g)))
    np.testing.assert_allclose(np.asarray(y).ravel(), y_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(dot), float(x @ y_ref), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("g", GRIDS)
def test_const_matches_values(g):
    """Constant-coefficient fast path ≡ values-carrying form (specialized vs generic)."""
    st, dense, x, y_ref = _setup(g)
    y = spmv_stencil5_const_xla(jnp.asarray(x.reshape(g, g)), 5.0, -1.0)
    np.testing.assert_allclose(np.asarray(y).ravel(), y_ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("g", GRIDS)
def test_const_spmv_dot_matches_dense(g):
    st, dense, x, y_ref = _setup(g)
    y, dot = spmv_dot_stencil5_const_xla(jnp.asarray(x.reshape(g, g)), 5.0, -1.0)
    np.testing.assert_allclose(np.asarray(y).ravel(), y_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(dot), float(x @ y_ref), rtol=1e-12, atol=1e-12)


def test_nonconstant_coefficients():
    """The values-carrying form supports arbitrary coefficient fields (parity with the
    reference which always loads values[], spmv_stencil_csr_direct.cu:105-109)."""
    g = 11
    st = generate.make_stencil5(g)
    rs = np.random.RandomState(3)
    # random coefficients, but zero where a neighbor is off-grid
    mask = st.planes != 0.0
    st.planes = np.where(mask, rs.randn(*st.planes.shape), 0.0)
    dense = formats.stencil5_to_csr(st).to_dense()
    x = rs.randn(g * g)
    y = spmv_stencil5_xla(jnp.asarray(st.planes), jnp.asarray(x.reshape(g, g)))
    np.testing.assert_allclose(np.asarray(y).ravel(), dense @ x, rtol=1e-12, atol=1e-12)


def test_halo_rows_used():
    """Sharded-band semantics: with halo rows supplied, boundary rows see neighbor data.
    Emulates the reference's partitioned halo kernel contract
    (spmv_stencil_partitioned_halo_kernel.cu:17-98)."""
    g = 12
    st = generate.make_stencil5(g)
    x = np.random.RandomState(5).randn(g, g)
    dense = fixtures.spd_stencil_csr(g).to_dense()
    y_ref = (dense @ x.ravel()).reshape(g, g)

    planes_band = jnp.asarray(st.planes[:, 4:8, :])
    xb = jnp.asarray(x[4:8])
    hp = jnp.asarray(x[3:4])
    hn = jnp.asarray(x[8:9])
    y = spmv_stencil5_xla(planes_band, xb, hp, hn)
    np.testing.assert_allclose(np.asarray(y), y_ref[4:8], rtol=1e-12, atol=1e-12)

    # const variant: row-offset agnostic — interior-band halos carry the boundary data
    yc = spmv_stencil5_const_xla(xb, 5.0, -1.0, hp, hn)
    np.testing.assert_allclose(np.asarray(yc), y_ref[4:8], rtol=1e-12, atol=1e-12)


def test_ones_checksum_oracle():
    g = 31
    st = generate.make_stencil5(g)
    y = spmv_stencil5_xla(jnp.asarray(st.planes), jnp.ones((g, g), jnp.float64))
    s, n2 = generate.stencil5_spmv_checksums(g)
    np.testing.assert_allclose(float(jnp.sum(y)), s, rtol=1e-13)
    np.testing.assert_allclose(float(jnp.linalg.norm(y.ravel())), n2, rtol=1e-13)


def test_f32_tolerance():
    """f32 operands give f32 results within relaxed tolerance of the f64 oracle."""
    g = 16
    st, dense, x, y_ref = _setup(g)
    y = spmv_stencil5_xla(jnp.asarray(st.planes, jnp.float32),
                          jnp.asarray(x.reshape(g, g), jnp.float32))
    np.testing.assert_allclose(np.asarray(y).ravel(), y_ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("const", [False, True], ids=["values", "const"])
@pytest.mark.parametrize("r0,r1", [(0, 4), (4, 8), (8, 12), (3, 11)])
def test_band_with_halos(r0, r1, const):
    """Any band of the grid with its true neighbour rows as halos (zeros at the grid edge)
    reproduces the same rows of the full product."""
    g = 12
    st = generate.make_stencil5(g)
    x = np.random.RandomState(r0 + 13 * r1).randn(g, g)
    y_ref = (fixtures.spd_stencil_csr(g).to_dense() @ x.ravel()).reshape(g, g)
    hp = jnp.asarray(x[r0 - 1:r0]) if r0 > 0 else None
    hn = jnp.asarray(x[r1:r1 + 1]) if r1 < g else jnp.zeros((1, g))
    xb = jnp.asarray(x[r0:r1])
    if const:
        y = spmv_stencil5_const_xla(xb, 5.0, -1.0, hp, hn)
    else:
        y = spmv_stencil5_xla(jnp.asarray(st.planes[:, r0:r1]), xb, hp, hn)
    np.testing.assert_allclose(np.asarray(y), y_ref[r0:r1], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize(
    "pattern", list(__import__("tests.helpers", fromlist=["Pattern"]).Pattern))
def test_input_patterns(pattern):
    """All canonical input patterns through the stencil (reference cuda_test_utils input
    pattern coverage, hpp:35-43)."""
    from .helpers import compare_vectors, make_input

    g = 16
    st, dense, _, _ = _setup(g)
    x = make_input(g * g, pattern)
    y = spmv_stencil5_xla(jnp.asarray(st.planes), jnp.asarray(x.reshape(g, g)))
    res = compare_vectors(np.asarray(y).ravel(), dense @ x, tier="standard")
    assert res.passed, res.first_failures


@pytest.mark.parametrize("shape", [(1, 7), (7, 1), (5, 9), (9, 5), (16, 3)])
def test_rectangular_fields_match_loop_oracle(shape):
    """Non-square fields (a row band of a wider grid) against the point-by-point oracle,
    with and without halo rows."""
    rows, cols = shape
    rs = np.random.RandomState(rows * 31 + cols)
    planes = rs.randn(5, rows, cols)
    x = rs.randn(rows, cols)
    hp, hn = rs.randn(1, cols), rs.randn(1, cols)
    y = spmv_stencil5_xla(jnp.asarray(planes), jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), _loop_apply(planes, x), rtol=1e-12,
                               atol=1e-12)
    y = spmv_stencil5_xla(jnp.asarray(planes), jnp.asarray(x), jnp.asarray(hp),
                          jnp.asarray(hn))
    np.testing.assert_allclose(np.asarray(y), _loop_apply(planes, x, hp, hn), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("g", [4, 13, 16, 31])
def test_bf16_planes_bit_identical(g):
    """bf16 coefficient storage (stencil5-bf16c) is exact for 5/-1/0: bit-identical to f32
    planes under an f32 field, and y keeps the field's dtype."""
    st = generate.make_stencil5(g)
    x = jnp.asarray(np.random.RandomState(g).randn(g, g), jnp.float32)
    y16 = spmv_stencil5_xla(jnp.asarray(st.planes, jnp.bfloat16), x)
    y32 = spmv_stencil5_xla(jnp.asarray(st.planes, jnp.float32), x)
    assert y16.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(y16), np.asarray(y32))


def test_const_xla_matches_dense():
    """stencil5-const-xla f64 through the registry ≡ the dense matrix."""
    from tpusparse import ops

    g = 33
    st = generate.make_stencil5(g)
    dense = formats.stencil5_to_csr(st).to_dense()
    op = ops.get_operator("stencil5-const-xla", st, dtype=jnp.float64)
    x = np.random.RandomState(0).randn(g * g)
    y = np.asarray(op.from_field(op.run_device(op.as_field(x).astype(jnp.float64))))
    np.testing.assert_allclose(y, dense @ x, rtol=1e-13, atol=1e-13)


def test_const_xla_cg_iteration_parity_f64():
    from tests.test_cg import reference_cg
    from tpusparse import ops
    from tpusparse.solvers import cg

    g = 24
    st = generate.make_stencil5(g)
    A = formats.stencil5_to_csr(st).to_dense()
    _, iters_ref, _ = reference_cg(A, np.ones(g * g))
    op = ops.get_operator("stencil5-const-xla", st, dtype=jnp.float64)
    x, stats = cg.cg_solve(op, jnp.ones((g, g), jnp.float64))
    assert stats.iterations == iters_ref


def test_const_xla_f32_matches_dense():
    from tpusparse import ops

    g = 48
    st = generate.make_stencil5(g)
    dense = formats.stencil5_to_csr(st).to_dense()
    op = ops.get_operator("stencil5-const-xla", st, dtype=jnp.float32)
    x = np.random.RandomState(1).randn(g * g).astype(np.float32)
    y = np.asarray(op.from_field(op.run_device(op.as_field(x))), np.float64)
    np.testing.assert_allclose(y, dense @ x.astype(np.float64), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["stencil5", "stencil5-xla", "stencil5-csr",
                                  "stencil5-bf16c", "stencil5-const", "stencil5-const-xla"])
def test_registry_stencil_modes_match_dense(mode):
    """Every stencil name in the registry maps to a working operator: SpMV and the fused
    dot against the dense f64 oracle."""
    from tpusparse import ops

    g = 9
    st, dense, x, y_ref = _setup(g, seed=11)
    op = ops.get_operator(mode, st, dtype=jnp.float64)
    assert op.name == mode
    y, dot = op.run_device_dot(op.as_field(x))
    np.testing.assert_allclose(np.asarray(op.from_field(y)), y_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(dot), float(x @ y_ref), rtol=1e-12)


@pytest.mark.parametrize("g", [5, 13, 16, 24])
@pytest.mark.parametrize("beta", [0.0, 0.7])
def test_const_pupdate_dot(g, beta):
    """Recompute pass A: (p', <p',A·p'>) with p' = r + β·p ≡ the separate passes."""
    st, dense, _, _ = _setup(g)
    rng = np.random.RandomState(3)
    r = rng.randn(g * g)
    p = np.zeros(g * g) if beta == 0.0 else rng.randn(g * g)
    pnew_ref = r + beta * p
    y_ref = dense @ pnew_ref
    pn, pap = const_pupdate_dot(beta, jnp.asarray(r.reshape(g, g)),
                                jnp.asarray(p.reshape(g, g)), 5.0, -1.0)
    np.testing.assert_allclose(np.asarray(pn).ravel(), pnew_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(pap), float(pnew_ref @ y_ref), rtol=1e-12)


@pytest.mark.parametrize("g", [5, 13, 16, 24])
def test_const_update_recompute(g):
    """Recompute pass B: (x', r', <r',r'>) with A·p recomputed ≡ manual x + α·p,
    r − α·(dense @ p)."""
    st, dense, _, _ = _setup(g)
    rng = np.random.RandomState(7)
    x = rng.randn(g * g)
    r = rng.randn(g * g)
    p = rng.randn(g * g)
    alpha = 0.37
    x_ref = x + alpha * p
    r_ref = r - alpha * (dense @ p)
    xn, rn, rr = const_update_recompute(
        alpha, jnp.asarray(x.reshape(g, g)), jnp.asarray(r.reshape(g, g)),
        jnp.asarray(p.reshape(g, g)), 5.0, -1.0)
    np.testing.assert_allclose(np.asarray(xn).ravel(), x_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(rn).ravel(), r_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(rr), float(r_ref @ r_ref), rtol=1e-12)


@pytest.mark.parametrize("g", [13, 16])
def test_const_operator_recompute_cg_parity(g):
    """CG through the recompute-Ap loop ≡ the classic 3-pass loop: identical iteration
    count, matching solution."""
    from tpusparse import ops
    from tpusparse.solvers import cg

    st = formats.Stencil5(grid_size=g, planes=None, constant=(5.0, -1.0))
    op = ops.get_operator("stencil5-const", st, dtype=jnp.float64)
    b = jnp.ones((g, g), jnp.float64)
    x1, s1 = cg.cg_solve(op, b, recompute_ap=False)
    x2, s2 = cg.cg_solve(op, b, recompute_ap=True)
    assert s1.converged and s2.converged
    assert s1.iterations == s2.iterations
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x2), rtol=1e-10)


def test_recompute_ap_requires_operator_passes():
    from tpusparse import ops
    from tpusparse.solvers import cg

    g = 8
    st = formats.Stencil5(grid_size=g, planes=None, constant=(5.0, -1.0))
    op = ops.get_operator("stencil5-xla", st, dtype=jnp.float64)  # no recompute passes
    b = jnp.ones((g, g), jnp.float64)
    with pytest.raises(ValueError, match="recompute_ap"):
        cg.cg_solve(op, b, recompute_ap=True)
    # the default is the classic loop, which every operator supports
    x, s = cg.cg_solve(op, b)
    assert s.converged
