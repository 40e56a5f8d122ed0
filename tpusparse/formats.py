"""Sparse matrix containers for the SpMV/CG framework.

Role parity with the reference (see SURVEY.md §2.1):
  - ``COOMatrix``      ≙ ``MatrixData``  (reference include/io.h:53-59)
  - ``CSRMatrix``      ≙ ``CSRMatrix``   (reference include/spmv_csr.h:28-35,
                         built by ``build_csr_struct`` src/spmv/spmv_cusparse_csr.cu:62-170)
  - ``ELLMatrix``      ≙ ``ELLPACKMatrix`` (reference include/spmv_ellpack.h:28-36 — vestigial
                         there, first-class here: the generic gather operator runs on it)
  - ``DIAMatrix``      — addition: diagonal-offset storage.  "Shift x by a constant offset and
                         FMA" needs no index traffic, so any matrix whose nonzeros live on few
                         distinct diagonals (all the reference's fixtures, and every stencil)
                         gets a gather-free operator through DIA.
  - ``Stencil5``       — the structure-exploiting showcase format (reference
                         src/spmv/spmv_stencil_csr_direct.cu): for a g×g 5-point stencil grid the
                         column indices are pure arithmetic (row±1, row±g), so only *values* are
                         stored.  The natural array layout is five (g, g) coefficient
                         planes [N, W, C, E, S] over the 2-D grid, and the vector x is viewed as a
                         (g, g) field: SpMV becomes five shifted elementwise FMAs — no index
                         traffic at all (the same 48 B/row byte model as the reference's kernel,
                         docs/PROFILING_ANALYSIS.md "Arithmetic Intensity").

Host-side containers hold numpy arrays (int64 indices from day one — the reference's ``int nnz``
overflows past ~21.5k grids, SURVEY.md §7 "hard parts"); device-side operands are jnp arrays
produced by the ``to_device``-style helpers in ops.py / generate.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# Stencil coefficient plane order (matches the reference's sorted-CSR invariant
# [N, W, C, E, S] for interior rows, spmv_stencil_csr_direct.cu:105-109).
N, W, C, E, S = 0, 1, 2, 3, 4
STENCIL_PLANE_NAMES = ("N", "W", "C", "E", "S")


@dataclasses.dataclass
class COOMatrix:
    """Coordinate-format host matrix (reference ``MatrixData``, include/io.h:53-59)."""

    num_rows: int
    num_cols: int
    row: np.ndarray  # int64 (nnz,)
    col: np.ndarray  # int64 (nnz,)
    val: np.ndarray  # float64 (nnz,)
    grid_size: int = 0  # >0 iff the matrix came from a STENCIL_GRID_SIZE header

    @property
    def nnz(self) -> int:
        return int(self.val.shape[0])

    def validate(self) -> None:
        if not (self.row.shape == self.col.shape == self.val.shape):
            raise ValueError("COO arrays must have identical shapes")
        if self.nnz and (self.row.min() < 0 or self.row.max() >= self.num_rows):
            raise ValueError("COO row index out of range")
        if self.nnz and (self.col.min() < 0 or self.col.max() >= self.num_cols):
            raise ValueError("COO col index out of range")


@dataclasses.dataclass
class CSRMatrix:
    """CSR host matrix with rows sorted by column index.

    The row-sort invariant matters: the reference's STENCIL5 kernel relies on interior rows
    being stored exactly as [N, W, C, E, S] (spmv_cusparse_csr.cu:139-157 sorts each row;
    spmv_stencil_csr_direct.cu:105-109 consumes that order), and our CSR→Stencil5 extraction
    relies on it the same way.
    """

    num_rows: int
    num_cols: int
    row_ptr: np.ndarray  # int64 (num_rows+1,)
    col_idx: np.ndarray  # int64 (nnz,)
    val: np.ndarray  # float64 (nnz,)
    grid_size: int = 0

    @property
    def nnz(self) -> int:
        return int(self.val.shape[0])

    @property
    def max_row_nnz(self) -> int:
        if self.num_rows == 0:
            return 0
        return int(np.max(np.diff(self.row_ptr)))

    def to_dense(self) -> np.ndarray:
        """Dense materialization — the correctness oracle for small matrices."""
        dense = np.zeros((self.num_rows, self.num_cols), dtype=self.val.dtype)
        for i in range(self.num_rows):
            lo, hi = self.row_ptr[i], self.row_ptr[i + 1]
            # np.add.at handles (pathological) duplicate columns additively, matching SpMV.
            np.add.at(dense[i], self.col_idx[lo:hi], self.val[lo:hi])
        return dense


@dataclasses.dataclass
class ELLMatrix:
    """ELLPACK: rows padded to uniform width (reference include/spmv_ellpack.h:28-36).

    Padding entries carry ``col = padded row's own index`` (any in-range index) and ``val = 0`` so
    a gather-based SpMV needs no masking.  This is the generic-matrix operator: the gather
    ``x[col]`` is done by XLA.
    """

    num_rows: int
    num_cols: int
    width: int
    col: np.ndarray  # int64 (num_rows, width)
    val: np.ndarray  # float64 (num_rows, width)
    grid_size: int = 0

    @property
    def nnz_padded(self) -> int:
        return int(self.col.size)


@dataclasses.dataclass
class DIAMatrix:
    """Diagonal-offset storage: ``A[i, i + offsets[d]] = data[d, i]``.

    ``data[d, i]`` is the value the *row* i contributes via diagonal d (zero where the diagonal
    exits the matrix).  SpMV is ``y[i] = Σ_d data[d, i] · x[i + off_d]`` — a shift + FMA per
    diagonal, the gather-free generic formulation for any matrix with few distinct
    diagonals.
    """

    num_rows: int
    num_cols: int
    offsets: np.ndarray  # int64 (ndiag,), sorted
    data: np.ndarray  # float64 (ndiag, num_rows)
    grid_size: int = 0

    @property
    def ndiag(self) -> int:
        return int(self.offsets.shape[0])


@dataclasses.dataclass
class Stencil5:
    """Values-only 5-point stencil operand over a g×g grid.

    ``planes`` has shape (5, g, g) ordered [N, W, C, E, S]; plane p at grid point (i, j) is the
    coefficient multiplying x at (i-1,j) / (i,j-1) / (i,j) / (i,j+1) / (i+1,j) respectively.
    Off-grid neighbors have coefficient 0 (Dirichlet boundary), mirroring the reference where
    boundary rows simply have fewer CSR entries (io.cu:375-391).

    This is the values-carrying parity format (48 B/row in f64).  ``constant`` optionally records
    (diag, offdiag) when every interior point shares coefficients — enabling the values-free fast
    path (16 B/row) flagged in SURVEY.md §6.
    """

    grid_size: int
    planes: np.ndarray  # float64 (5, g, g)
    constant: Optional[tuple] = None  # (diag, offdiag) if uniform

    @property
    def num_rows(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def nnz(self) -> int:
        g = self.grid_size
        # diag everywhere + 4 neighbors minus the ones clipped at each of 4 edges
        return 5 * g * g - 4 * g


# ---------------------------------------------------------------------------
# Converters
# ---------------------------------------------------------------------------


def coo_to_csr(coo: COOMatrix) -> CSRMatrix:
    """COO → CSR with per-row column sort (reference build_csr_struct,
    spmv_cusparse_csr.cu:62-170: count per row, prefix sum, scatter, insertion-sort each row).

    Vectorized equivalent: a single stable lexsort by (row, col).  Uses the native C++
    builder (csrc/mtxio.cpp) when available.
    """
    coo.validate()
    from . import native

    if native.available() and coo.nnz:
        row_ptr, col_idx, val = native.coo_to_csr_sorted(
            coo.num_rows, coo.row, coo.col, coo.val
        )
        return CSRMatrix(
            num_rows=coo.num_rows, num_cols=coo.num_cols, row_ptr=row_ptr,
            col_idx=col_idx, val=val, grid_size=coo.grid_size,
        )
    order = np.lexsort((coo.col, coo.row))
    row = coo.row[order]
    col = coo.col[order]
    val = coo.val[order]
    counts = np.bincount(row, minlength=coo.num_rows).astype(np.int64)
    row_ptr = np.zeros(coo.num_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return CSRMatrix(
        num_rows=coo.num_rows,
        num_cols=coo.num_cols,
        row_ptr=row_ptr,
        col_idx=col.astype(np.int64),
        val=val.astype(np.float64),
        grid_size=coo.grid_size,
    )


def csr_to_coo(csr: CSRMatrix) -> COOMatrix:
    row = np.repeat(np.arange(csr.num_rows, dtype=np.int64), np.diff(csr.row_ptr))
    return COOMatrix(
        num_rows=csr.num_rows,
        num_cols=csr.num_cols,
        row=row,
        col=csr.col_idx.copy(),
        val=csr.val.copy(),
        grid_size=csr.grid_size,
    )


def csr_to_ell(csr: CSRMatrix, width: Optional[int] = None) -> ELLMatrix:
    """CSR → ELLPACK (the conversion the reference declares but never implements,
    include/spmv_ellpack.h:50-51 / include/io.h:124-125)."""
    w = csr.max_row_nnz if width is None else width
    if w < csr.max_row_nnz:
        raise ValueError(f"width {w} < max row nnz {csr.max_row_nnz}")
    row_lens = np.diff(csr.row_ptr)
    col = np.repeat(
        np.arange(csr.num_rows, dtype=np.int64).reshape(-1, 1), max(w, 1), axis=1
    )[:, :w]
    val = np.zeros((csr.num_rows, w), dtype=csr.val.dtype)
    # scatter: position within row
    if csr.nnz:
        rows = np.repeat(np.arange(csr.num_rows, dtype=np.int64), row_lens)
        pos = np.arange(csr.nnz, dtype=np.int64) - np.repeat(csr.row_ptr[:-1], row_lens)
        col[rows, pos] = csr.col_idx
        val[rows, pos] = csr.val
        # Pad slots repeat the row's LAST REAL column (val stays 0) instead of col=row:
        # a short row's padded slot then reads an x entry its neighbours read too, so the
        # gather keeps its locality.  (Empty rows keep col=row — any in-range index is
        # valid with val=0.)
        if w > 1:
            nz = row_lens > 0
            last = np.where(
                nz,
                col[np.arange(csr.num_rows), np.maximum(row_lens - 1, 0)],
                np.arange(csr.num_rows, dtype=np.int64),
            )
            pad_mask = np.arange(w)[None, :] >= row_lens[:, None]
            col = np.where(pad_mask, last[:, None], col)
    return ELLMatrix(
        num_rows=csr.num_rows,
        num_cols=csr.num_cols,
        width=w,
        col=col,
        val=val,
        grid_size=csr.grid_size,
    )


def csr_to_dia(csr: CSRMatrix, max_diags: int = 4096) -> DIAMatrix:
    """CSR → DIA.  Raises if the matrix has more than ``max_diags`` distinct diagonals
    (then it is genuinely unstructured and belongs on the ELL/gather path)."""
    rows = np.repeat(np.arange(csr.num_rows, dtype=np.int64), np.diff(csr.row_ptr))
    offs = csr.col_idx - rows
    offsets = np.unique(offs)
    if offsets.shape[0] > max_diags:
        raise ValueError(
            f"matrix has {offsets.shape[0]} distinct diagonals (> {max_diags}); use ELL"
        )
    data = np.zeros((offsets.shape[0], csr.num_rows), dtype=csr.val.dtype)
    dmap = {int(o): d for d, o in enumerate(offsets)}
    dsel = np.array([dmap[int(o)] for o in offs], dtype=np.int64)
    np.add.at(data, (dsel, rows), csr.val)
    return DIAMatrix(
        num_rows=csr.num_rows,
        num_cols=csr.num_cols,
        offsets=offsets.astype(np.int64),
        data=data,
        grid_size=csr.grid_size,
    )


def stencil5_to_dia(st: Stencil5) -> DIAMatrix:
    """Stencil5 → DIA directly from the coefficient planes: O(n) array reshapes instead of
    the O(nnz) CSR materialization + scatter of ``stencil5_to_csr`` → ``csr_to_dia`` (at
    20480² that path builds a 2.1B-entry CSR on the host just to throw it away).

    The five stencil diagonals sit at offsets [−g, −1, 0, +1, +g] and
    ``data[d, i] = A[i, i + offsets[d]]`` is exactly plane [N, W, C, E, S] at point i —
    the Dirichlet-zero plane masks ARE the out-of-band zeros of the DIA layout."""
    g = st.grid_size
    if g < 2:
        # g == 1: offsets ±1 and ±g collide — degenerate; go through CSR
        return csr_to_dia(stencil5_to_csr(st))
    n = g * g
    if st.planes is not None:
        planes = np.asarray(st.planes)
        data = np.stack([planes[p].reshape(n) for p in (N, W, C, E, S)])
    else:
        if st.constant is None:
            raise ValueError("Stencil5 needs planes or constant coefficients")
        diag, offdiag = st.constant
        # planes-free constant operand: write the (5, n) diagonal rows directly — no
        # (5, g, g) f64 intermediate (33.6 GB of host traffic at 20480² on this host).
        # f32 is exact for caller-supplied constants that are f32-representable (the
        # benchmark's 5/−1 are); the operator packs cast to the op dtype regardless.
        data = np.full((5, n), offdiag, dtype=np.float32)
        data[2] = diag  # row order is N, W, C, E, S — C is offset 0 at index 2
        data[0, :g] = 0.0        # first grid row: no north neighbor
        data[4, n - g:] = 0.0    # last grid row: no south neighbor
        data[1, 0::g] = 0.0      # j == 0: no west neighbor
        data[3, g - 1::g] = 0.0  # j == g−1: no east neighbor
    return DIAMatrix(
        num_rows=n, num_cols=n,
        offsets=np.array([-g, -1, 0, 1, g], dtype=np.int64),
        data=data, grid_size=g,
    )


def stencil5_to_ell(st: Stencil5) -> ELLMatrix:
    """Stencil5 → ELLPACK directly from the planes: O(n) vectorized scatter instead of the
    O(nnz) ``stencil5_to_csr`` → ``coo_to_csr`` (sort!) → ``csr_to_ell`` chain, whose CSR
    materialization alone exceeded an hour at 15360² on a 1-core host.

    Bit-equal to the CSR path (asserted in tests): the stencil's candidate columns
    [i−g, i−1, i, i+1, i+g] are already sorted, zero coefficients are dropped exactly as
    ``stencil5_to_csr`` drops them, and pad slots repeat the row's last real column (the
    window-friendly policy of ``csr_to_ell``; empty rows keep col=row)."""
    g = st.grid_size
    n = g * g
    if st.planes is None:
        if st.constant is None:
            raise ValueError("Stencil5 needs planes or constant coefficients")
        diag, offdiag = st.constant
        if g >= 3 and diag != 0.0 and offdiag != 0.0:
            # constant-coefficient planes-free operand (the gen:<g> CLI path): the ELL
            # layout is fully analytic — write it directly at O(output) memory traffic.
            # The general path below first MATERIALIZES the (5, g, g) planes and then
            # runs five (n,)-sized mask/cumsum/scatter passes; measured on the 1-core
            # host at 15360²: 274 s planes + >25 min of passes, vs ~2 min here.
            return _stencil5_const_to_ell(g, float(diag), float(offdiag))
        from .generate import make_stencil5

        st = make_stencil5(g, *st.constant, dtype=np.float32)
    i, j = np.meshgrid(np.arange(g, dtype=np.int64), np.arange(g, dtype=np.int64),
                       indexing="ij")
    row_of = i * g + j
    # candidate (col, val, valid) per plane, in globally sorted column order N < W < C < E < S
    cand_col = np.empty((5, g, g), np.int64)
    valid = np.empty((5, g, g), bool)
    vals = np.asarray(st.planes)
    for p, (di, dj) in ((N, (-1, 0)), (W, (0, -1)), (C, (0, 0)), (E, (0, 1)), (S, (1, 0))):
        ii, jj = i + di, j + dj
        ok = (ii >= 0) & (ii < g) & (jj >= 0) & (jj < g)
        cand_col[p] = np.where(ok, ii * g + jj, 0)
        valid[p] = ok & (vals[p] != 0.0)
    cc = cand_col.reshape(5, n).T          # (n, 5) sorted candidate columns
    vv = vals.reshape(5, n).T
    mm = valid.reshape(5, n).T
    lens = mm.sum(axis=1)
    w = int(lens.max()) if n else 0
    pos = np.cumsum(mm, axis=1) - 1        # slot index of each valid candidate
    rsel = np.broadcast_to(np.arange(n, dtype=np.int64)[:, None], (n, 5))[mm]
    col = np.repeat(np.arange(n, dtype=np.int64).reshape(-1, 1), max(w, 1), axis=1)[:, :w]
    val = np.zeros((n, w), dtype=vv.dtype)
    col[rsel, pos[mm]] = cc[mm]
    val[rsel, pos[mm]] = vv[mm]
    if w > 1:
        nz = lens > 0
        last = np.where(nz, col[np.arange(n), np.maximum(lens - 1, 0)],
                        np.arange(n, dtype=np.int64))
        pad_mask = np.arange(w)[None, :] >= lens[:, None]
        col = np.where(pad_mask, last[:, None], col)
    return ELLMatrix(num_rows=n, num_cols=n, width=w, col=col, val=val, grid_size=g)


def _stencil5_const_to_ell(g: int, diag: float, offdiag: float) -> ELLMatrix:
    """Analytic ELL of the constant-coefficient 5-point stencil (g ≥ 3, both coefficients
    nonzero — callers fall back to the general path otherwise).

    Interior rows have the fixed layout col = r + (−g, −1, 0, +1, +g), val =
    (o, o, d, o, o) in the globally-sorted N, W, C, E, S plane order — written for ALL
    rows in one arithmetic pass; only the 4g − 4 boundary rows (clipped neighbors) are
    then rewritten through the same mask/cumsum/pad machinery the general path applies
    everywhere.  Bit-equal to the general path (asserted in tests), including the
    pad-with-last-real-column policy of ``csr_to_ell``."""
    n = g * g
    r = np.arange(n, dtype=np.int64)
    col = np.empty((n, 5), np.int64)
    col[:, 0] = r - g
    col[:, 1] = r - 1
    col[:, 2] = r
    col[:, 3] = r + 1
    col[:, 4] = r + g
    val = np.empty((n, 5), np.float32)
    val[:, 0] = offdiag
    val[:, 1] = offdiag
    val[:, 2] = diag
    val[:, 3] = offdiag
    val[:, 4] = offdiag
    edge = np.concatenate([
        np.arange(g, dtype=np.int64),                    # i = 0 (incl. both corners)
        np.arange(n - g, n, dtype=np.int64),             # i = g−1 (incl. both corners)
        np.arange(g, n - g, g, dtype=np.int64),          # j = 0, 0 < i < g−1
        np.arange(2 * g - 1, n - g, g, dtype=np.int64),  # j = g−1, 0 < i < g−1
    ])
    ei, ej = edge // g, edge % g
    cand = np.stack([edge - g, edge - 1, edge, edge + 1, edge + g], axis=1)
    ok = np.stack([ei > 0, ej > 0, np.ones_like(edge, bool), ej < g - 1, ei < g - 1],
                  axis=1)
    vals5 = np.array([offdiag, offdiag, diag, offdiag, offdiag], np.float32)
    m = edge.shape[0]
    lens = ok.sum(axis=1)
    pos = np.cumsum(ok, axis=1) - 1
    ecol = np.zeros((m, 5), np.int64)
    evalv = np.zeros((m, 5), np.float32)
    rr = np.broadcast_to(np.arange(m)[:, None], (m, 5))[ok]
    ecol[rr, pos[ok]] = cand[ok]
    evalv[rr, pos[ok]] = np.broadcast_to(vals5, (m, 5))[ok]
    last = ecol[np.arange(m), lens - 1]  # lens ≥ 3 for g ≥ 2: always a real column
    pad_mask = np.arange(5)[None, :] >= lens[:, None]
    ecol = np.where(pad_mask, last[:, None], ecol)
    col[edge] = ecol
    val[edge] = evalv
    return ELLMatrix(num_rows=n, num_cols=n, width=5, col=col, val=val, grid_size=g)


def csr_to_stencil5(csr: CSRMatrix, grid_size: Optional[int] = None) -> Stencil5:
    """Extract the 5 coefficient planes from a CSR matrix known to be a 5-point stencil on a
    g×g grid.  Validates the structure (raises on any nonzero outside the stencil pattern).

    Mirrors what the reference's STENCIL5 init does implicitly: it trusts the sorted-CSR
    [N, W, C, E, S] layout (spmv_stencil_csr_direct.cu:194-225); we verify instead of trusting.
    """
    g = grid_size or csr.grid_size
    if g <= 0:
        g = int(round(np.sqrt(csr.num_rows)))
    if g * g != csr.num_rows or csr.num_rows != csr.num_cols:
        raise ValueError(f"matrix ({csr.num_rows}x{csr.num_cols}) is not a g^2 square, g={g}")
    rows = np.repeat(np.arange(csr.num_rows, dtype=np.int64), np.diff(csr.row_ptr))
    offs = csr.col_idx - rows
    # duplicate (row, col) entries: SpMV semantics would ADD them, but the fancy-index
    # plane assignment below keeps only the last — reject instead of silently diverging
    # (coo_to_csr sorts per row, so duplicates are adjacent)
    dup = (np.diff(csr.col_idx) == 0) & (rows[1:] == rows[:-1])
    if np.any(dup):
        raise ValueError("matrix has duplicate (row, col) entries — accumulate them first")
    planes = np.zeros((5, g, g), dtype=csr.val.dtype)
    i = rows // g
    j = rows % g
    plane_of = {-g: N, -1: W, 0: C, 1: E, g: S}
    for off, p in plane_of.items():
        sel = offs == off
        planes[p, i[sel], j[sel]] = csr.val[sel]
    # W/E entries with off ±1 that cross a grid-row boundary would be wrap artifacts
    bad = ~np.isin(offs, list(plane_of))
    if np.any(bad):
        raise ValueError("matrix has nonzeros outside the 5-point stencil pattern")
    wrap_w = (offs == -1) & (j == 0)
    wrap_e = (offs == 1) & (j == g - 1)
    if np.any(wrap_w) or np.any(wrap_e):
        raise ValueError("W/E nonzero wraps across a grid row — not a 5-point stencil")
    cvals = None
    interior = planes[:, 1:-1, 1:-1]
    if g > 2 and interior.size:
        d0 = interior[C].flat[0]
        o0 = interior[N].flat[0]
        if (
            np.all(interior[C] == d0)
            and all(np.all(interior[p] == o0) for p in (N, W, E, S))
        ):
            cvals = (float(d0), float(o0))
    return Stencil5(grid_size=g, planes=planes, constant=cvals)


def stencil5_to_csr(st: Stencil5) -> CSRMatrix:
    """Expand a Stencil5 operand back to sorted CSR (for cross-validation and export).

    A planes-free constant-coefficient operand (planes=None, constant set — the
    no-host-materialization form the CLIs build for ``gen:`` specs) synthesizes its host
    planes here, lazily: only the generic formats (CSR/ELL/DIA/BCOO) ever need them."""
    if st.planes is None:
        if st.constant is None:
            raise ValueError("Stencil5 needs planes or constant coefficients")
        from .generate import make_stencil5

        st = make_stencil5(st.grid_size, *st.constant, dtype=np.float32)
    g = st.grid_size
    n = g * g
    i, j = np.meshgrid(np.arange(g, dtype=np.int64), np.arange(g, dtype=np.int64), indexing="ij")
    row = (i * g + j).ravel()
    entries = []
    for p, (di, dj) in ((N, (-1, 0)), (W, (0, -1)), (C, (0, 0)), (E, (0, 1)), (S, (1, 0))):
        ii, jj = i + di, j + dj
        ok = (ii >= 0) & (ii < g) & (jj >= 0) & (jj < g)
        v = st.planes[p]
        sel = ok.ravel() & (v.ravel() != 0.0)
        entries.append((row[sel], (ii * g + jj).ravel()[sel], v.ravel()[sel]))
    rows = np.concatenate([e[0] for e in entries])
    cols = np.concatenate([e[1] for e in entries])
    vals = np.concatenate([e[2] for e in entries])
    return coo_to_csr(
        COOMatrix(num_rows=n, num_cols=n, row=rows, col=cols, val=vals, grid_size=g)
    )
