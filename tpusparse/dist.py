"""Mesh construction and multi-host runtime helpers.

Parity with the reference's launch model (SURVEY.md §2.4): the reference binds 1 MPI rank to
1 GPU via ``mpirun -np N`` + ``cudaSetDevice(rank)`` (cg_solver_mgpu_partitioned.cu:259).  Here
one process drives all local cards through one mesh; several hosts join one runtime with
``jax.distributed.initialize()``.  The mesh follows the algorithm (row bands, or row × column
blocks): the cards of a host reach each other all to all at one rate.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
from jax.sharding import Mesh


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Join the multi-host runtime.  Without a cluster manager that JAX detects, pass
    ``coordinator`` (e.g. ``localhost:<port>``), ``num_processes`` and ``process_id``."""
    kwargs = {}
    if coordinator:
        kwargs["coordinator_address"] = coordinator
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def make_band_mesh(num_devices: int = 0, devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the row-band axis "x" — the only parallelism axis this problem needs
    (SURVEY.md §2.4: 1-D domain decomposition is the reference's single strategy).

    Device order: ``jax.devices()`` lists a host's devices together, so contiguous row bands
    stay on one host and at most one neighbour exchange per host pair crosses hosts."""
    devs = list(devices) if devices is not None else list(jax.devices())
    if num_devices:
        devs = devs[:num_devices]
    return jax.make_mesh((len(devs),), ("x",), devices=devs)


def describe_mesh(mesh: Mesh) -> dict:
    """Topology provenance for exports (the nvidia-smi-topo analog)."""
    devs = mesh.devices.ravel().tolist()
    return {
        "axes": dict(zip(mesh.axis_names, mesh.devices.shape)),
        "num_devices": len(devs),
        "num_processes": jax.process_count(),
        "device_kinds": sorted({getattr(d, "device_kind", str(d)) for d in devs}),
        "process_of_device": [getattr(d, "process_index", 0) for d in devs],
    }


def is_multihost() -> bool:
    return jax.process_count() > 1


def local_band_rows(grid_size: int, num_devices: int, device_index: int) -> tuple:
    """Row range [lo, hi) of a device's band — the reference's partition math
    (cg_solver_mgpu_partitioned.cu:262-268: n/P each, last rank absorbs the remainder).
    With the current equal-band sharding constraint this is exact division; kept general for
    the padded-grid path."""
    base = grid_size // num_devices
    rem = grid_size - base * num_devices
    lo = device_index * base + min(device_index, rem)
    hi = lo + base + (1 if device_index < rem else 0)
    return lo, hi


def gather_to_host(x, rows: int = 0):
    """Fetch a (possibly row-sharded, possibly non-fully-addressable) array to host numpy.

    Single-process arrays go through ``jax.device_get``; multi-process (pod) arrays are not
    fully addressable and need ``process_allgather`` (the MPI_Gatherv analog,
    cg_solver_mgpu_partitioned.cu:834-851 — except every host gets the result).
    ``rows`` > 0 drops a padded row tail."""
    import jax

    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        out = multihost_utils.process_allgather(x, tiled=True)
    else:
        out = jax.device_get(x)
    return out[:rows] if rows else out


def barrier(name: str = "tpusparse:barrier") -> None:
    """Cross-process barrier — the reference's MPI_Barrier-before-timing
    (cg_solver_mgpu_partitioned.cu:405).  No-op in single-process runs."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(name)


def rank_time_stats(duration_s: float) -> Optional[dict]:
    """MEASURED multi-process timing discipline (SURVEY §7; reference
    cg_solver_mgpu_partitioned.cu:749-800): allgather each process's host-measured solve
    wall time, reduce MAX (the bottleneck rank) and MIN, and report the load-imbalance %
    — (max − min)/max, the reference's formula (:758-773).

    Call with a duration measured after :func:`barrier` so the start edge is aligned
    (the reference's MPI_Barrier-then-start protocol).  Returns None in single-process
    runs: under single-process SPMD every shard executes one fused program in lockstep,
    so per-process skew does not exist — the structural argument applies there and a
    fabricated 0-measurement would be noise.  In multi-process (1 process per host) runs
    skew is real and this MEASURES it."""
    if jax.process_count() <= 1:
        return None
    import numpy as np
    from jax.experimental import multihost_utils

    per = np.asarray(
        multihost_utils.process_allgather(np.asarray([duration_s], np.float64))
    ).ravel() * 1e3
    mx, mn = float(per.max()), float(per.min())
    return {
        "solve_time_max_ms": mx,
        "solve_time_min_ms": mn,
        "load_imbalance_pct": 100.0 * (mx - mn) / mx if mx > 0 else 0.0,
        "per_process_ms": [round(float(v), 3) for v in per],
    }


def env_flag(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    return default if v is None else v not in ("0", "false", "False", "")


# The default cache directory: fixed, inside the checkout (and git-ignored).  The path is part
# of the cache's key, so a directory that moved between runs would never hit.
DEFAULT_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                 ".jax_cache")


def compilation_cache_dir() -> str:
    """Where the persistent compilation cache lives: ``JAX_COMPILATION_CACHE_DIR`` when set
    (JAX reads it itself), otherwise ``DEFAULT_CACHE_DIR``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compilation_cache() -> str:
    """Enable JAX's persistent compilation cache, so a second process or run reuses the
    compiled solves.  Sets no directory when ``JAX_COMPILATION_CACHE_DIR`` is set.  Returns
    the directory in use."""
    import jax

    cache_dir = compilation_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir
