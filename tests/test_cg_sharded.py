"""Sharded CG over the virtual 8-device mesh.

This is distributed coverage the reference never had (SURVEY.md §4 "Distributed testing:
none") — its multi-GPU correctness was validated only operationally via checksums.  Here:
iteration-count and checksum parity across 1/2/4/8 shards is an actual test, the property the
reference README claims ("deterministic convergence ... on ALL GPU counts", README.md:62)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpusparse import formats, generate
from tpusparse.solvers import cg, cg_sharded

from .test_cg import reference_cg




def _mesh(n):
    if jax.device_count() < n:
        pytest.skip(f"needs {n} devices, have {jax.device_count()}")
    return jax.make_mesh((n,), ("x",), devices=jax.devices()[:n])


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", ["stencil5", "stencil5-const"])
def test_sharded_iteration_parity(ndev, mode):
    g = 16
    st = generate.make_stencil5(g)
    A = formats.stencil5_to_csr(st).to_dense()
    b = np.ones(g * g)
    x_ref, iters_ref, _ = reference_cg(A, b)

    x, stats = cg_sharded.cg_solve_sharded(
        _mesh(ndev), g, mode=mode, dtype=jnp.float64
    )
    assert stats.converged
    assert stats.iterations == iters_ref
    np.testing.assert_allclose(np.asarray(x).ravel(), x_ref, rtol=1e-8, atol=1e-10)


def test_sharded_recompute_matches_classic():
    """Sharded recompute-Ap loop (opt-in for stencil5-const) ≡ the classic loop:
    identical iteration count and solution, identical per-iteration halo volume."""
    g = 16
    mesh = _mesh(8)
    x1, s1 = cg_sharded.cg_solve_sharded(mesh, g, mode="stencil5-const",
                                         dtype=jnp.float64, recompute_ap=False)
    x2, s2 = cg_sharded.cg_solve_sharded(mesh, g, mode="stencil5-const",
                                         dtype=jnp.float64, recompute_ap=True)
    assert s1.converged and s2.converged
    assert s1.iterations == s2.iterations
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x2), rtol=1e-10)


def test_sharded_checksums_match_across_shard_counts():
    """Sum(x)/Norm2(x) identical across shard counts within FP-reassociation tolerance
    (the reference documents ~0.15% variation for AmgX; ours is f64 + identical reduction
    order per shard, so the tolerance is much tighter)."""
    g = 24
    sums, norms, iters = [], [], []
    for ndev in (1, 2, 4, 8):
        x, stats = cg_sharded.cg_solve_sharded(_mesh(ndev), g, dtype=jnp.float64)
        xr = np.asarray(x, np.float64)
        sums.append(xr.sum())
        norms.append(np.linalg.norm(xr))
        iters.append(stats.iterations)
    assert len(set(iters)) == 1, f"iteration count varies across shard counts: {iters}"
    np.testing.assert_allclose(sums, sums[0], rtol=1e-12)
    np.testing.assert_allclose(norms, norms[0], rtol=1e-12)


def test_sharded_matches_single_chip_solver():
    g = 32
    st = generate.make_stencil5(g)
    from tpusparse import ops

    op = ops.get_operator("stencil5", st, dtype=jnp.float64)
    b = op.as_field(np.ones(g * g)).astype(jnp.float64)
    x1, s1 = cg.cg_solve(op.run_device_dot, b)
    x8, s8 = cg_sharded.cg_solve_sharded(_mesh(8), g, mode="stencil5", dtype=jnp.float64)
    assert s1.iterations == s8.iterations
    np.testing.assert_allclose(np.asarray(x8), np.asarray(x1), rtol=1e-10, atol=1e-12)


def test_sharded_indivisible_grid_padded():
    """Grids not divisible by the mesh size get zero-coefficient pad rows (the analog of the
    reference's last-rank-absorbs-remainder partitioning)."""
    g = 30  # 30 % 8 != 0
    st = generate.make_stencil5(g)
    A = formats.stencil5_to_csr(st).to_dense()
    b = np.ones(g * g)
    from .test_cg import reference_cg

    x_ref, iters_ref, _ = reference_cg(A, b)
    for mode in ("stencil5", "stencil5-const"):
        x, stats = cg_sharded.cg_solve_sharded(_mesh(8), g, mode=mode, dtype=jnp.float64)
        assert x.shape == (g, g)
        assert stats.iterations == iters_ref
        np.testing.assert_allclose(np.asarray(x).ravel(), x_ref, rtol=1e-8, atol=1e-10)


def test_sharded_spmv_halo_correctness():
    """One sharded SpMV against the dense oracle — isolates the ppermute halo plumbing."""
    g = 16
    mesh = _mesh(4)
    st = generate.make_stencil5(g)
    dense = formats.stencil5_to_csr(st).to_dense()
    x = np.random.RandomState(7).randn(g, g)
    y_ref = (dense @ x.ravel()).reshape(g, g)

    op = cg_sharded.make_sharded_operator(mesh, g, mode="stencil5", dtype=jnp.float64)
    from jax.sharding import NamedSharding, PartitionSpec as P

    xd = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("x", None)))

    def local(planes_l, x_l):
        y, pap = op.local_spmv_dot(planes_l, x_l, "x", 4)
        return y, pap

    y, pap = jax.jit(
        jax.shard_map(
            local, mesh=mesh, in_specs=(P(None, "x", None), P("x", None)),
            out_specs=(P("x", None), P()), check_vma=False,
        )
    )(op.planes, xd)
    np.testing.assert_allclose(np.asarray(y), y_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(pap), float(x.ravel() @ y_ref.ravel()), rtol=1e-12)


@pytest.mark.parametrize("mode", ["stencil5", "stencil5-const"])
def test_overlap_matches_synchronous(mode):
    """Interior/boundary-split (overlapped halo) SpMV ≡ the synchronous formulation —
    the correctness property the reference's abandoned overlap branches lost
    (PROBLEM_SIZE_SCALING_RESULTS 'numerical drift')."""
    g = 24
    x1, s1 = cg_sharded.cg_solve_sharded(
        _mesh(4), g, mode=mode, dtype=jnp.float64, overlap=False
    )
    x2, s2 = cg_sharded.cg_solve_sharded(
        _mesh(4), g, mode=mode, dtype=jnp.float64, overlap=True
    )
    assert s1.iterations == s2.iterations
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x1), rtol=1e-12, atol=1e-14)


def test_overlap_spmv_against_dense():
    g = 20
    mesh = _mesh(4)
    st = generate.make_stencil5(g)
    dense = formats.stencil5_to_csr(st).to_dense()
    x = np.random.RandomState(3).randn(g, g)
    y_ref = (dense @ x.ravel()).reshape(g, g)
    op = cg_sharded.make_sharded_operator(mesh, g, mode="stencil5", dtype=jnp.float64,
                                          overlap=True)
    from jax.sharding import NamedSharding, PartitionSpec as P

    xd = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("x", None)))
    y, pap = jax.jit(
        jax.shard_map(
            lambda pl_, xl: op.local_spmv_dot(pl_, xl, "x", 4),
            mesh=mesh, in_specs=(P(None, "x", None), P("x", None)),
            out_specs=(P("x", None), P()), check_vma=False,
        )
    )(op.planes, xd)
    np.testing.assert_allclose(np.asarray(y), y_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(pap), float(x.ravel() @ y_ref.ravel()), rtol=1e-12)


def test_sharded_stepped_matches_fused():
    g = 24
    x1, s1 = cg_sharded.cg_solve_sharded(_mesh(4), g, mode="stencil5", dtype=jnp.float64)
    x2, s2 = cg_sharded.cg_solve_sharded_stepped(
        _mesh(4), g, mode="stencil5", dtype=jnp.float64
    )
    assert s1.iterations == s2.iterations
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x1), rtol=1e-12)
    assert s2.spmv_time_ms > 0 and s2.blas1_time_ms > 0
    # per-collective timers (CGStatsMultiGPU parity): the halo ppermute and the dot
    # psum+readback are measured as their own phases, and reductions mirrors allreduce
    assert s2.halo_time_ms > 0
    assert s2.allreduce_time_ms > 0
    assert s2.reduction_time_ms == s2.allreduce_time_ms


def test_sharded_stepped_exports_per_collective_fields():
    from tpusparse.bench import export, sysinfo

    g = 16
    x, st = cg_sharded.cg_solve_sharded_stepped(_mesh(4), g, mode="stencil5",
                                                dtype=jnp.float64)
    op = cg_sharded.make_sharded_operator(_mesh(4), g, mode="stencil5",
                                          dtype=jnp.float64)
    result = export.cg_result_dict(
        solver="test-sharded", mode="stencil5", matrix_name="t", op=op, cg_stats=st,
        bench_stats=None, sysinfo=sysinfo.get_system_info(), sum_x=0.0, norm2_x=0.0,
    )
    t = result["timing"]
    assert t["halo_ms"] > 0 and t["allreduce_ms"] > 0
    assert t["reductions_ms"] == t["allreduce_ms"]
    # measured-only discipline: no gflops_spmv unless a measured breakdown was passed
    assert "gflops_spmv" not in result["performance"]


def test_sharded_bf16_coefficients_match_f32():
    """Sharded stencil5-bf16c ≡ sharded stencil5 (f32) bitwise: the synthesized coefficients
    are exactly representable in bf16."""
    g = 24
    m = _mesh(4)
    x32, s32 = cg_sharded.cg_solve_sharded(m, g, mode="stencil5", dtype=jnp.float32)
    x16, s16 = cg_sharded.cg_solve_sharded(m, g, mode="stencil5-bf16c",
                                           dtype=jnp.float32)
    assert s32.iterations == s16.iterations
    assert np.array_equal(np.asarray(x32), np.asarray(x16))


class Test2DDecomposition:
    """2-D block decomposition — beyond the reference (its partitioning is 1-D only,
    cg_solver_mgpu_partitioned.cu:262-331).  Parity gates: identical iteration counts
    and 1e-12 solutions vs the single-device solve, across mesh shapes including the
    degenerate (P,1)/(1,P) cases and both values/const kernels."""

    @staticmethod
    def _single(g):
        from tpusparse import generate, ops
        from tpusparse.solvers import cg

        op = ops.get_operator("stencil5", generate.make_stencil5(g), dtype=jnp.float64)
        return cg.cg_solve(op, jnp.ones((g, g), jnp.float64))

    @pytest.mark.parametrize("shape", [(2, 4), (4, 2), (8, 1), (1, 8), (2, 2)])
    def test_2d_parity_values(self, shape):
        import jax

        if jax.device_count() < shape[0] * shape[1]:
            pytest.skip("needs more devices")
        g = 24
        x1, s1 = self._single(g)
        mesh = jax.make_mesh(shape, ("x", "y"))
        x2, s2 = cg_sharded.cg_solve_sharded_2d(mesh, g, mode="stencil5",
                                                dtype=jnp.float64)
        assert s2.iterations == s1.iterations
        np.testing.assert_allclose(np.asarray(x2), np.asarray(x1), rtol=1e-12,
                                   atol=1e-12)

    def test_2d_parity_const(self):
        import jax

        if jax.device_count() < 8:
            pytest.skip("needs 8 devices")
        g = 24
        x1, s1 = self._single(g)
        mesh = jax.make_mesh((2, 4), ("x", "y"))
        x2, s2 = cg_sharded.cg_solve_sharded_2d(mesh, g, mode="stencil5-const",
                                                dtype=jnp.float64)
        assert s2.iterations == s1.iterations
        np.testing.assert_allclose(np.asarray(x2), np.asarray(x1), rtol=1e-12,
                                   atol=1e-12)

    def test_2d_rejects_non_divisible_grid(self):
        import jax

        if jax.device_count() < 8:
            pytest.skip("needs 8 devices")
        mesh = jax.make_mesh((2, 4), ("x", "y"))
        with pytest.raises(ValueError, match="divide"):
            cg_sharded.cg_solve_sharded_2d(mesh, 30, dtype=jnp.float64)

    def test_2d_rejects_1d_mesh(self):
        import jax

        if jax.device_count() < 8:
            pytest.skip("needs 8 devices")
        mesh = jax.make_mesh((8,), ("x",))
        with pytest.raises(ValueError, match="2-axis"):
            cg_sharded.cg_solve_sharded_2d(mesh, 24, dtype=jnp.float64)


    def test_2d_overlap_matches_sync(self):
        """2-D interior/boundary-split (overlapped) SpMV ≡ the synchronous formulation —
        the same drift-free-by-construction property the 1-D overlap path proves."""
        import jax

        if jax.device_count() < 8:
            pytest.skip("needs 8 devices")
        g = 24
        mesh = jax.make_mesh((2, 4), ("x", "y"))
        x1, s1 = cg_sharded.cg_solve_sharded_2d(mesh, g, mode="stencil5",
                                                dtype=jnp.float64, overlap=False)
        x2, s2 = cg_sharded.cg_solve_sharded_2d(mesh, g, mode="stencil5",
                                                dtype=jnp.float64, overlap=True)
        assert s1.iterations == s2.iterations
        np.testing.assert_allclose(np.asarray(x2), np.asarray(x1), rtol=1e-12,
                                   atol=1e-14)

    def test_2d_bf16c_matches_f32(self):
        """2-D stencil5-bf16c ≡ 2-D stencil5 f32 bitwise (exactly representable
        coefficients), mirroring the 1-D bf16c invariant."""
        import jax

        if jax.device_count() < 8:
            pytest.skip("needs 8 devices")
        g = 24
        mesh = jax.make_mesh((2, 4), ("x", "y"))
        x32, s32 = cg_sharded.cg_solve_sharded_2d(mesh, g, mode="stencil5",
                                                  dtype=jnp.float32)
        x16, s16 = cg_sharded.cg_solve_sharded_2d(mesh, g, mode="stencil5-bf16c",
                                                  dtype=jnp.float32)
        assert s32.iterations == s16.iterations
        assert np.array_equal(np.asarray(x32), np.asarray(x16))
