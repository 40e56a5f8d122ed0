"""5-point stencil operand generation.

Parity with the reference's generator (src/io/io.cu:322-399 ``write_matrix_market_stencil5`` and
src/matrix/generate_matrix.cu): a g×g grid produces an SPD matrix with diagonal +5.0
(Laplacian + mass term, io.cu:375) and up to four -1.0 neighbors, written 1-based in Matrix
Market "coordinate real general" format with a ``% STENCIL_GRID_SIZE g`` comment.

Addition (SURVEY.md §2.1): the operand can be synthesized directly as device arrays — five
(g, g) coefficient planes — without ever materializing a .mtx file.  At
g=20k the reference must write ~2·10⁹ ASCII lines (~60 GB); here the same operand is a 16 GB
(f64) / 8 GB (f32) on-device values tensor, or 0 bytes in constant-coefficient mode.
"""

from __future__ import annotations

import functools

import numpy as np

from .formats import C, E, N, S, Stencil5, W

DEFAULT_DIAG = 5.0
DEFAULT_OFFDIAG = -1.0


def stencil5_nnz(grid_size: int) -> int:
    """Exact nnz of the 5-point stencil matrix (reference precount io.cu:327-340)."""
    g = grid_size
    return 5 * g * g - 4 * g


def make_stencil5(
    grid_size: int,
    diag: float = DEFAULT_DIAG,
    offdiag: float = DEFAULT_OFFDIAG,
    dtype=np.float64,
) -> Stencil5:
    """Build the host-side Stencil5 operand: coefficient planes with Dirichlet-zero
    coefficients where a neighbor falls off the grid."""
    g = int(grid_size)
    if g < 1:
        raise ValueError("grid_size must be >= 1")
    planes = np.zeros((5, g, g), dtype=dtype)
    planes[C] = diag
    planes[N, 1:, :] = offdiag  # row 0 has no north neighbor
    planes[S, :-1, :] = offdiag  # last row has no south neighbor
    planes[W, :, 1:] = offdiag  # col 0 has no west neighbor
    planes[E, :, :-1] = offdiag  # last col has no east neighbor
    return Stencil5(grid_size=g, planes=planes, constant=(float(diag), float(offdiag)))


def make_stencil5_planes_device(grid_size: int, diag=DEFAULT_DIAG, offdiag=DEFAULT_OFFDIAG,
                                dtype=None):
    """Synthesize the (5, g, g) coefficient planes directly as a jnp array on device —
    the large-grid path that bypasses host memory and .mtx entirely.

    The synthesis runs as one jitted program: executed eagerly, the five (g, g) outer
    products would materialize individually BEFORE the stack copies them — a 2× transient
    (32 GB for 20000² f64 planes).  Under jit XLA fuses mask/outer/stack into a single
    kernel whose peak footprint is the output alone."""
    import jax.numpy as jnp

    g = int(grid_size)
    dtype = jnp.dtype(dtype or jnp.float32)
    return _synth_planes_jit(g, jnp.dtype(dtype).name,
                             jnp.asarray(diag, dtype), jnp.asarray(offdiag, dtype))


@functools.lru_cache(maxsize=1)
def _synth_planes_fn():
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnums=(0, 1))
    def _synth(g, dtype_name, diag, offdiag):
        dtype = jnp.dtype(dtype_name)
        ii = jnp.arange(g)
        row_mask = lambda lo, hi: ((ii >= lo) & (ii < hi)).astype(dtype)  # noqa: E731
        ones = jnp.ones((g,), dtype)
        n_plane = offdiag * jnp.outer(row_mask(1, g), ones)
        s_plane = offdiag * jnp.outer(row_mask(0, g - 1), ones)
        w_plane = offdiag * jnp.outer(ones, row_mask(1, g))
        e_plane = offdiag * jnp.outer(ones, row_mask(0, g - 1))
        c_plane = diag * jnp.outer(ones, ones)
        return jnp.stack([n_plane, w_plane, c_plane, e_plane, s_plane])

    return _synth


def _synth_planes_jit(g, dtype_name, diag, offdiag):
    return _synth_planes_fn()(g, dtype_name, diag, offdiag)


def write_matrix_market_stencil5(path: str, grid_size: int, diag: float = DEFAULT_DIAG,
                                 offdiag: float = DEFAULT_OFFDIAG, chunk_rows: int = 512) -> int:
    """Write the stencil matrix as .mtx with the reference's header format (io.cu:349-351)
    and 1-based entries.  Returns nnz written.  Uses the native C++ writer when available.

    Entry-ORDER caveat: the native writer emits per grid point in the reference's C, N, S,
    W, E order (io.cu:373-391); the numpy fallback groups entries by record type per
    grid-row chunk.  The parsed matrix is identical (readers sort rows), but the two paths
    are NOT line-for-line diffable against each other.
    """
    from . import native

    if native.available():
        return native.write_stencil5_mtx(path, grid_size, diag, offdiag)
    return _write_stencil5_python(path, grid_size, diag, offdiag, chunk_rows)


def _write_stencil5_python(path, grid_size, diag, offdiag, chunk_rows=512) -> int:
    g = int(grid_size)
    nnz = stencil5_nnz(g)
    n = g * g
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"% STENCIL_GRID_SIZE {g}\n")
        f.write(f"{n} {n} {nnz}\n")
        jj = np.arange(g, dtype=np.int64)
        for i0 in range(0, g, chunk_rows):
            i1 = min(i0 + chunk_rows, g)
            lines = []
            for i in range(i0, i1):
                base = i * g + jj + 1  # 1-based row index
                recs = [(base, base, np.full(g, diag))]
                if i > 0:
                    recs.append((base, base - g, np.full(g, offdiag)))
                if i < g - 1:
                    recs.append((base, base + g, np.full(g, offdiag)))
                recs.append((base[1:], base[1:] - 1, np.full(g - 1, offdiag)))
                recs.append((base[:-1], base[:-1] + 1, np.full(g - 1, offdiag)))
                for r, c, v in recs:
                    for rr, cc, vv in zip(r, c, v):
                        lines.append(f"{rr} {cc} {vv:.17g}\n")
            f.write("".join(lines))
    return nnz


def ones_field(grid_size: int, dtype=None):
    """The reference's canonical input vector x = ones (main.cu:136-137) viewed as a (g,g)
    field."""
    import jax.numpy as jnp

    dtype = dtype or jnp.float32
    return jnp.ones((grid_size, grid_size), dtype)


def stencil5_spmv_checksums(grid_size: int, diag=DEFAULT_DIAG, offdiag=DEFAULT_OFFDIAG):
    """Analytical checksums for y = A·ones — the oracle pattern of the reference tests
    (tests/test_wrapper_basic.cpp:115-121 derives these by hand for the -4/-1 matrix).

    For x = ones: y[i,j] = diag + offdiag * (#neighbors of (i,j)).
    Returns (sum_y, norm2_y) exactly, in float64.
    """
    g = grid_size
    # neighbor counts: 4 interior, 3 edge, 2 corner (degenerate small grids handled explicitly)
    if g == 1:
        vals = {0: 1}
    elif g == 2:
        vals = {2: 4}
    else:
        vals = {2: 4, 3: 4 * (g - 2), 4: (g - 2) ** 2}
    sum_y = 0.0
    norm2 = 0.0
    for nb, count in vals.items():
        yv = diag + offdiag * nb
        sum_y += count * yv
        norm2 += count * yv * yv
    return sum_y, float(np.sqrt(norm2))
