"""Cache lifecycle: solver/operand caches must not accumulate device memory.

Round-2 review finding: the sharded solver/operator caches stored the multi-GB coefficient
planes under every distinct config key with no eviction, so a sweep over grids (exactly what
scripts/sweep.py runs) pinned every visited grid's operands in HBM for the process lifetime.
Fixed by (a) a content-keyed planes cache shared across solver configs and (b) the
``tpusparse.clear_caches()`` API called between sweep points.
"""

import gc

import jax
import jax.numpy as jnp

import tpusparse

from tpusparse.solvers import cg, cg_sharded


def _mesh(n):
    return jax.make_mesh((n,), ("x",), devices=jax.devices()[:n])


def _live_bytes():
    gc.collect()
    return sum(int(a.size) * a.dtype.itemsize for a in jax.live_arrays())


def test_config_sweep_shares_one_planes_array():
    """Different solver configs (overlap / tol / max_iters) over the same operand must
    share ONE device planes array (the round-2 advisory: config sweeps pinned duplicate
    planes under every key)."""
    tpusparse.clear_caches()
    m = _mesh(4)
    g = 32
    for overlap in (True, False):
        for tol in (1e-5, 1e-6):
            x, st = cg_sharded.cg_solve_sharded(
                m, g, mode="stencil5", tolerance=tol, dtype=jnp.float64, overlap=overlap
            )
            assert st.converged
    assert len(cg_sharded._PLANES_CACHE) == 1, list(cg_sharded._PLANES_CACHE)
    plane_ids = {id(op.planes) for op in cg_sharded._OPERATOR_CACHE.values()}
    assert len(cg_sharded._OPERATOR_CACHE) == 2  # one per overlap flavor
    assert len(plane_ids) == 1, "operators must share the cached planes array"
    # 2-D solver shares the same planes cache (content-keyed, mesh-distinct entries only)
    mesh2 = jax.make_mesh((2, 2), ("x", "y"), devices=jax.devices()[:4])
    cg_sharded.cg_solve_sharded_2d(mesh2, g, mode="stencil5", dtype=jnp.float64)
    assert len(cg_sharded._PLANES_CACHE) == 2


def test_clear_caches_empties_every_cache():
    m = _mesh(2)
    cg_sharded.cg_solve_sharded(m, 16, mode="stencil5", dtype=jnp.float64)
    from tpusparse import generate, ops

    op = ops.get_operator("stencil5", generate.make_stencil5(16), dtype=jnp.float64)
    cg.cg_solve(op, jnp.ones((16, 16), jnp.float64))
    assert cg._SOLVER_CACHE and cg_sharded._SOLVER_CACHE
    tpusparse.clear_caches()
    for cache in (cg._SOLVER_CACHE, cg_sharded._SOLVER_CACHE,
                  cg_sharded._OPERATOR_CACHE, cg_sharded._PLANES_CACHE,
                  cg_sharded._SOLVER2D_CACHE):
        assert not cache


def test_multi_grid_sweep_with_clear_does_not_accumulate():
    """The sweep shape: solve at growing grids, clear_caches() between points.  Resident
    device bytes after the LAST point's clear must be back at the first point's level —
    no per-grid operand accumulation (the sweep-shaped regression the review asked for)."""
    tpusparse.clear_caches()
    m = _mesh(4)
    levels = []
    for g in (16, 32, 48, 64):
        x, st = cg_sharded.cg_solve_sharded(m, g, mode="stencil5", dtype=jnp.float64)
        assert st.converged
        del x, st
        tpusparse.clear_caches()
        levels.append(_live_bytes())
    # slack for backend-internal singletons that appear on first use (not per-grid)
    assert levels[-1] <= levels[0] + 256 * 1024, levels
