"""The Triton SpMV+dot kernel (kernels/stencil5_triton.py).

On the CPU the kernel runs in Pallas interpret mode against the XLA form and the dense
oracle, with tiles that do not divide the field; its lowering to a Triton call for the CUDA
platform is checked without a card.  The compiled kernel itself runs under the ``gpu``
marker."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpusparse import generate
from tpusparse.kernels.stencil5 import spmv_dot_stencil5_xla
from tpusparse.kernels.stencil5_triton import spmv_dot_stencil5_triton

from . import fixtures


@pytest.mark.parametrize("shape", [(1, 5), (13, 13), (16, 40), (33, 17), (8, 256)])
@pytest.mark.parametrize("block", [(8, 16), (4, 32)], ids=["8x16", "4x32"])
def test_interpret_matches_xla_non_dividing_tiles(shape, block):
    rows, cols = shape
    rs = np.random.RandomState(rows + 7 * cols)
    planes = jnp.asarray(rs.randn(5, rows, cols))
    x = jnp.asarray(rs.randn(rows, cols))
    y, dot = spmv_dot_stencil5_triton(planes, x, block_rows=block[0], block_cols=block[1],
                                      interpret=True)
    y_ref, dot_ref = spmv_dot_stencil5_xla(planes, x)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref), rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(float(dot), float(dot_ref), rtol=1e-12)


@pytest.mark.parametrize("g", [7, 31])
def test_interpret_matches_dense_stencil(g):
    st = generate.make_stencil5(g)
    x = np.random.RandomState(g).randn(g * g)
    y_ref = fixtures.spd_stencil_csr(g).to_dense() @ x
    y, dot = spmv_dot_stencil5_triton(jnp.asarray(st.planes), jnp.asarray(x.reshape(g, g)),
                                      interpret=True)
    np.testing.assert_allclose(np.asarray(y).ravel(), y_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(dot), float(x @ y_ref), rtol=1e-12)


def test_interpret_f32_accumulates_in_f32():
    g = 24
    st = generate.make_stencil5(g)
    x = np.random.RandomState(3).randn(g, g).astype(np.float32)
    y, dot = spmv_dot_stencil5_triton(jnp.asarray(st.planes, jnp.float32), jnp.asarray(x),
                                      block_rows=8, block_cols=16, interpret=True)
    assert y.dtype == jnp.float32 and dot.dtype == jnp.float32
    y_ref = fixtures.spd_stencil_csr(g).to_dense() @ x.ravel().astype(np.float64)
    np.testing.assert_allclose(np.asarray(y, np.float64).ravel(), y_ref, rtol=2e-5,
                               atol=2e-5)


def test_lowers_to_a_triton_call_for_cuda():
    """The kernel names the Triton route and lowers for the CUDA platform (no card needed
    to lower; the GPU compiler itself is exercised by the gpu-marked test below)."""
    planes = jax.ShapeDtypeStruct((5, 64, 96), jnp.float64)
    x = jax.ShapeDtypeStruct((64, 96), jnp.float64)
    lowered = jax.jit(spmv_dot_stencil5_triton).trace(planes, x).lower(
        lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert "stencil5_spmv_dot" in text


def test_operator_uses_xla_off_the_gpu():
    """Off the GPU the registry's stencil5 CG pass is the XLA form (the kernel cannot
    compile there); stencil5-xla is XLA everywhere."""
    from tpusparse import ops

    assert jax.default_backend() == "cpu"
    assert not ops._use_triton(jnp.float64, None)
    g = 6
    op = ops.get_operator("stencil5", generate.make_stencil5(g), dtype=jnp.float64)
    jaxpr = str(jax.make_jaxpr(op.run_device_dot_op)(jnp.ones((g, g)), op.operands))
    assert "pallas_call" not in jaxpr


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu():
    from tpusparse import ops

    assert ops._use_triton(jnp.float64, None)
    g = 1000
    st = generate.make_stencil5(g)
    x = jax.random.normal(jax.random.PRNGKey(0), (g, g), jnp.float64)
    planes = jnp.asarray(st.planes)
    y, dot = spmv_dot_stencil5_triton(planes, x)
    y_ref, dot_ref = spmv_dot_stencil5_xla(planes, x)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(dot), float(dot_ref), rtol=1e-12)
