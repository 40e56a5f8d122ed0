"""Performance metrics: GFLOPS, byte models, HBM roofline fraction, bound classification.

Parity with the reference's metrics calculator (src/spmv/spmv_metrics.cu):
  - GFLOPS = 2·nnz / t                         (:63-65)
  - format-specific byte models                (:76-95 — CSR: 8B val + 4B col + row_ptr + x + y)
  - arithmetic intensity + memory/balanced/compute-bound classification (:147-167)

Absolute GB/s is reported *and* normalized to the card's memory roofline — the reference's
RTX-4060 roofline analysis (docs/PROFILING_ANALYSIS.md:88-97, "STENCIL5 at 95% of peak")
generalizes across cards only as a fraction of peak.  A device kind without a row in the peak
table gets no roofline fraction: no default is guessed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# Published peaks per device kind (JAX's ``device_kind``): (memory GB/s, f32 GFLOP/s outside
# the tensor cores).  Source: NVIDIA H100 Tensor Core GPU data sheet — SXM5: 3,350 GB/s HBM3,
# 67 TFLOP/s FP32; PCIe: 2,000 GB/s HBM2e, 51 TFLOP/s FP32.  Rates assume the full power limit.
CHIP_SPECS = {
    "NVIDIA H100 80GB HBM3": (3350.0, 67_000.0),
    "NVIDIA H100 PCIe": (2000.0, 51_000.0),
}


def chip_peaks(device_kind: str):
    """(memory GB/s, f32 GFLOP/s) of a device kind.  Raises for a kind not in the table: a
    roofline share against a guessed peak is worse than none."""
    try:
        return CHIP_SPECS[device_kind]
    except KeyError:
        raise ValueError(f"no published peaks for device kind {device_kind!r}; "
                         f"known: {sorted(CHIP_SPECS)}") from None


def spmv_flops(nnz: int) -> int:
    return 2 * nnz  # one multiply + one add per stored nonzero (spmv_metrics.cu:63-65)


def bytes_csr(nnz: int, rows: int, itemsize: int, idxsize: int = 4) -> int:
    """Reference CSR byte model (spmv_metrics.cu:76-95): values + col indices + row_ptr +
    x read + y write."""
    return nnz * itemsize + nnz * idxsize + (rows + 1) * idxsize + 2 * rows * itemsize


def bytes_ell(rows: int, width: int, itemsize: int, idxsize: int = 4) -> int:
    return rows * width * (itemsize + idxsize) + 2 * rows * itemsize


def bytes_stencil5(rows: int, itemsize: int) -> int:
    """Values-carrying stencil: 5 coefficients + x + y per row, no index traffic —
    the reference's 48 B/row (f64) model (docs/PROFILING_ANALYSIS.md byte table)."""
    return 7 * rows * itemsize


def bytes_stencil5_const(rows: int, itemsize: int) -> int:
    """Constant-coefficient fast path: x + y only (16 B/row f64, SURVEY.md §6)."""
    return 2 * rows * itemsize


def bytes_dia(rows: int, ndiag: int, itemsize: int) -> int:
    return (ndiag + 2) * rows * itemsize


def _bytes_ell_op(op, itemsize):
    """Actual ELL traffic: every padded slot's value and column index + x read + y write."""
    buf = op._buffers or {}
    val = buf.get("val")
    if val is None:
        return bytes_csr(op.nnz, op.num_rows, itemsize)
    col = buf.get("col")
    idx_bytes = int(col.size) * col.dtype.itemsize if col is not None else int(val.size) * 4
    return int(val.size) * itemsize + idx_bytes + 2 * op.num_rows * itemsize


def _bytes_dia_op(op, itemsize):
    """Actual DIA traffic: the full (ndiag, rows) data array the operator streams —
    includes stored zeros where diagonals exit the matrix — plus x, y."""
    data = (op._buffers or {}).get("data")
    if data is not None:
        return (int(data.size) + 2 * op.field_elems) * itemsize
    return (op.nnz + 2 * op.num_rows) * itemsize


BYTE_MODELS = {
    "csr": lambda op, itemsize: _bytes_ell_op(op, itemsize),
    "csr-xla": lambda op, itemsize: _bytes_ell_op(op, itemsize),
    "cusparse-csr": lambda op, itemsize: _bytes_ell_op(op, itemsize),
    "ell": lambda op, itemsize: _bytes_ell_op(op, itemsize),
    "bcoo": lambda op, itemsize: op.nnz * (itemsize + 8) + 2 * op.num_rows * itemsize,
    "dia": _bytes_dia_op,
    "dia-xla": _bytes_dia_op,
    "stencil5": lambda op, itemsize: bytes_stencil5(op.num_rows, itemsize),
    "stencil5-xla": lambda op, itemsize: bytes_stencil5(op.num_rows, itemsize),
    "stencil5-csr": lambda op, itemsize: bytes_stencil5(op.num_rows, itemsize),
    # bf16 coefficient storage: 5 planes at 2 B + x,y at the state itemsize
    "stencil5-bf16c": lambda op, itemsize: op.num_rows * (5 * 2 + 2 * itemsize),
    "stencil5-const": lambda op, itemsize: bytes_stencil5_const(op.num_rows, itemsize),
    "stencil5-const-xla": lambda op, itemsize: bytes_stencil5_const(op.num_rows, itemsize),
}


@dataclasses.dataclass
class SpmvMetrics:
    """Parity with reference SpmvMetrics (include/spmv.h / spmv_metrics.cu)."""

    time_ms: float
    gflops: float
    bandwidth_gbs: float
    arithmetic_intensity: float
    roofline_fraction: Optional[float]  # achieved BW / published peak; None: no peak known
    bound: str  # "memory-bound" | "balanced" | "compute-bound" | "unknown" (no peak known)
    bytes_moved: int
    nnz: int
    rows: int
    dtype: str
    # vs the MEASURED streaming ceiling (bench.probes) — the denominator the reference's
    # "95% of peak" roofline claim actually uses (its peak is nsys-measured, not nominal).
    # None when no probe was run.
    achievable_gbs: Optional[float] = None
    roofline_fraction_achievable: Optional[float] = None
    # Timing-validity flags: non-empty means the bandwidth/GFLOPS above must NOT be read as
    # a roofline claim — the implied bandwidth exceeds the published peak or the measured
    # ceiling (a working set held in cache across chained applies, or a timing error).
    timing_flags: tuple = ()


def calculate_spmv_metrics(op, time_ms: float, *, dtype_itemsize: int,
                           device_kind: str, mode: Optional[str] = None,
                           achievable_gbs: Optional[float] = None) -> SpmvMetrics:
    mode = mode or op.name
    model = BYTE_MODELS.get(mode, BYTE_MODELS["csr"])
    nbytes = model(op, dtype_itemsize)
    t = time_ms / 1e3
    flops = spmv_flops(op.nnz)
    gflops = flops / t / 1e9 if t > 0 else 0.0
    bw = nbytes / t / 1e9 if t > 0 else 0.0
    ai = flops / nbytes if nbytes else 0.0
    peaks = CHIP_SPECS.get(device_kind)
    flags = []
    if peaks is not None and bw > peaks[0]:
        flags.append(
            f"implied_bw_exceeds_nominal_peak: {bw:.0f} > {peaks[0]:.0f} GB/s — cache "
            "residency across chained applies or a timing error; not a roofline claim")
    elif achievable_gbs and bw > achievable_gbs:
        flags.append(
            f"implied_bw_exceeds_measured_ceiling: {bw:.0f} > {achievable_gbs:.0f} GB/s")
    if peaks is None:
        bound = "unknown"
    else:
        ridge = peaks[1] / peaks[0]  # FLOPs per byte at the roofline ridge point
        if ai < 0.5 * ridge:
            bound = "memory-bound"
        elif ai > 2.0 * ridge:
            bound = "compute-bound"
        else:
            bound = "balanced"
    return SpmvMetrics(
        time_ms=time_ms,
        gflops=gflops,
        bandwidth_gbs=bw,
        arithmetic_intensity=ai,
        roofline_fraction=bw / peaks[0] if peaks is not None else None,
        bound=bound,
        bytes_moved=nbytes,
        nnz=op.nnz,
        rows=op.num_rows,
        dtype={4: "float32", 8: "float64", 2: "bfloat16"}.get(dtype_itemsize, "?"),
        achievable_gbs=achievable_gbs,
        roofline_fraction_achievable=(bw / achievable_gbs if achievable_gbs else None),
        timing_flags=tuple(flags),
    )


def cg_gflops(nnz: int, iterations: int, spmv_time_ms: float) -> float:
    """Reference performance{gflops_spmv} (cg_metrics.cu:~120): 2·nnz·iters / spmv time."""
    if spmv_time_ms <= 0:
        return 0.0
    return 2.0 * nnz * iterations / (spmv_time_ms / 1e3) / 1e9
