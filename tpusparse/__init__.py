"""tpusparse — a sparse linear-algebra benchmark framework in JAX, run on NVIDIA GPUs.

Built with the capabilities of the CUDA/MPI reference ``1fni/cuda-spmv-benchmark`` (see
SURVEY.md): stencil matrix generation and Matrix Market I/O, SpMV operators (generic CSR/ELL/DIA
baselines and the structure-exploiting STENCIL5 formulation), a device-resident Conjugate
Gradient solver, multi-card sharded CG over a ``jax.sharding.Mesh`` with halo exchange between
cards, and a statistical benchmarking/metrics/export harness.
"""

__version__ = "0.1.0"

from . import formats, generate, io_mtx  # noqa: F401


def clear_caches() -> None:
    """Drop every solver/operand cache (single-card + sharded): compiled solves and the
    cached device operands they pin.  Benchmark sweeps over grid sizes MUST call this
    between points — each visited grid otherwise leaves its multi-GB coefficient planes
    resident in device memory for the process lifetime (20000² f64 planes are 16 GB)."""
    from .solvers import cg, cg_sharded

    cg._SOLVER_CACHE.clear()
    cg_sharded.clear_caches()
