"""Parity against the reference repo's committed sample matrix.

The reference ships matrix/example81x81.mtx (6561×6561, 32,481 nnz, STENCIL_GRID_SIZE 81)
written by an *older* generator — diag −4.0, neighbors −1.0, unlike the current generator's
+5.0 diag (SURVEY.md §2.1 "Sample matrix").  The reference uses it only for SpMV correctness,
never CG (the −4 matrix is not SPD the same way).  These tests replicate that role: load the
exact file the reference tests against and cross-validate every operator at the strict tier —
the key oracle pattern "the generic kernel is the reference for the specialized kernel"
(test_wrapper_basic.cpp:159-193).

Skipped when the reference checkout is not present (e.g. CI).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from tpusparse import formats, io_mtx, ops

from .helpers import Pattern, compare_vectors, make_input

REF_MTX = "/root/reference/matrix/example81x81.mtx"

pytestmark = pytest.mark.skipif(
    not os.path.exists(REF_MTX), reason="reference checkout not available"
)


@pytest.fixture(scope="module")
def sample():
    coo = io_mtx.load_matrix_market(REF_MTX)
    csr = formats.coo_to_csr(coo)
    return coo, csr


def test_sample_matrix_shape_and_header(sample):
    coo, csr = sample
    assert coo.num_rows == coo.num_cols == 6561
    assert coo.nnz == 32481
    assert coo.grid_size == 81  # parsed from the STENCIL_GRID_SIZE comment
    # legacy coefficient field: diag −4, neighbors −1 (SURVEY.md §2.1)
    dense = csr.to_dense()
    assert dense[0, 0] == -4.0
    assert dense[0, 1] == -1.0


def test_sample_matrix_operator_cross_validation(sample):
    """csr / dia / stencil5 / bcoo all agree with the dense oracle on the reference's own
    data, for every input pattern, at the strict tier (1e-12) in f64."""
    coo, csr = sample
    dense = csr.to_dense()
    n = csr.num_rows
    for pattern in (Pattern.ONES, Pattern.INCREMENTAL, Pattern.RANDOM_UNIFORM):
        x = make_input(n, pattern)
        want = dense @ x
        for mode in ("csr", "dia", "stencil5", "stencil5-xla", "bcoo"):
            op = ops.get_operator(mode, csr, dtype=jnp.float64)
            y = np.asarray(op.run_device(op.as_field(jnp.asarray(x)))).reshape(-1)[:n]
            res = compare_vectors(y, want, tier="strict")
            assert res.passed, f"{mode}/{pattern}: {res}"


def test_sample_matrix_spmv_ones_checksum(sample):
    """Analytical checksum for y = A·ones: sum(y) = sum of all matrix entries.

    For the legacy field: 6561 diag entries of −4 plus 25,920 neighbor entries of −1
    (total nnz 32,481) ⇒ sum(y) = −4·6561 − 25920 = −52,164.  The analog of the reference's
    hand-derived −60.0 oracle for its 3×3 case (test_wrapper_basic.cpp:115-121)."""
    coo, csr = sample
    op = ops.get_operator("stencil5", csr, dtype=jnp.float64)
    y = np.asarray(op.run_device(op.as_field(jnp.ones(csr.num_rows, jnp.float64))))
    assert abs(float(y.sum()) - (-52164.0)) < 1e-9


def test_sample_matrix_cross_validation_f32():
    """f32 variant at the relaxed tier."""
    coo = io_mtx.load_matrix_market(REF_MTX)
    csr = formats.coo_to_csr(coo)
    dense = csr.to_dense()
    n = csr.num_rows
    for pattern in (Pattern.ONES, Pattern.RANDOM_UNIFORM):
        x = make_input(n, pattern)
        want = dense @ x
        for mode in ("csr", "dia", "stencil5", "stencil5-bf16c"):
            op = ops.get_operator(mode, csr, dtype=jnp.float32)
            y = np.asarray(op.run_device(op.as_field(jnp.asarray(x, jnp.float32))))
            # f32 compute vs the f64 oracle: single-precision accumulation tolerance
            np.testing.assert_allclose(y.reshape(-1)[:n], want, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{mode}/{pattern}")
