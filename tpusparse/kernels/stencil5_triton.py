"""Values-carrying STENCIL5 SpMV fused with <x, A·x>, as a Pallas kernel on the Triton route.

This is the reference's hand CUDA kernel role (src/spmv/spmv_stencil_csr_direct.cu:76-123)
for the CG hot pass: one HBM pass reads the five coefficient planes and x and writes y, and
the dot that CG needs next is formed from values already in registers.

  - one program per (block_rows, block_cols) tile of the (rows, cols) field;
  - neighbours come from masked loads at offsets ±1 and ±cols of the flat field, so no
    padded copy of x is made and the grid edges read as zero (the Dirichlet matrix);
  - each program writes one partial dot to a (tiles_r, tiles_c) output that XLA sums.

GPU blocks run in no order, so the partials replace a carried accumulator.  Tiles need not
divide the field: loads and stores outside it are masked.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..formats import C, E, N, S, W

BLOCK_ROWS = 8
BLOCK_COLS = 256


def _kernel(planes_ref, x_ref, y_ref, part_ref, *, rows, cols, block_rows, block_cols,
            idx_dtype):
    i = pl.program_id(0)
    j = pl.program_id(1)
    r = (i * block_rows + jnp.arange(block_rows, dtype=idx_dtype))[:, None]
    c = (j * block_cols + jnp.arange(block_cols, dtype=idx_dtype))[None, :]
    inside = (r < rows) & (c < cols)
    idx = r * cols + c
    n = rows * cols

    def load(ref, offset, mask):
        return plgpu.load(ref.at[idx + offset], mask=mask, other=0.0)

    x = load(x_ref, 0, inside)
    y = (load(planes_ref, C * n, inside) * x
         + load(planes_ref, W * n, inside) * load(x_ref, -1, inside & (c > 0))
         + load(planes_ref, E * n, inside) * load(x_ref, 1, inside & (c < cols - 1))
         + load(planes_ref, N * n, inside) * load(x_ref, -cols, inside & (r > 0))
         + load(planes_ref, S * n, inside) * load(x_ref, cols, inside & (r < rows - 1)))
    y = y.astype(y_ref.dtype)
    plgpu.store(y_ref.at[idx], y, mask=inside)
    part_ref[i, j] = jnp.sum(jnp.where(inside, x * y, 0.0)).astype(part_ref.dtype)


@functools.partial(jax.jit, static_argnames=("block_rows", "block_cols", "interpret"))
def spmv_dot_stencil5_triton(planes, x, *, block_rows: int = BLOCK_ROWS,
                             block_cols: int = BLOCK_COLS, interpret: bool = False):
    """(A·x, <x, A·x>) for (5, rows, cols) planes and a (rows, cols) field.

    Semantics of ``stencil5.spmv_dot_stencil5_xla`` without halo rows (one card).  The dot
    accumulates in at least f32 (``blas1.dot``'s rule)."""
    rows, cols = x.shape
    assert planes.shape == (5, rows, cols), (planes.shape, x.shape)
    acc = jnp.promote_types(x.dtype, jnp.float32)
    # flat offsets reach 5·rows·cols into the planes: int64 once that passes int32
    idx_dtype = jnp.int64 if 5 * rows * cols >= 2 ** 31 else jnp.int32
    grid = (pl.cdiv(rows, block_rows), pl.cdiv(cols, block_cols))
    kernel = functools.partial(_kernel, rows=rows, cols=cols, block_rows=block_rows,
                               block_cols=block_cols, idx_dtype=idx_dtype)
    y, part = pl.pallas_call(
        kernel,
        grid=grid,
        out_shape=[jax.ShapeDtypeStruct((rows * cols,), x.dtype),
                   jax.ShapeDtypeStruct(grid, acc)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="stencil5_spmv_dot",
    )(planes.reshape(-1), x.reshape(-1))
    return y.reshape(rows, cols), jnp.sum(part)
