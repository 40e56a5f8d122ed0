"""Single-chip CG solver: convergence, iteration-count parity, checksums.

The iteration-count oracle is a straight numpy float64 transcription of the reference's
algorithm (cg_solver.cu:11-20 / :538-650) — our solver must match its iteration count EXACTLY
in f64, the property behind the reference's "deterministic 14 iterations" headline."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpusparse import formats, generate, ops
from tpusparse.solvers import cg


def reference_cg(A, b, tol=1e-6, max_iters=1000):
    """Numpy transcription of the reference device CG (cg_solver.cu:538-650)."""
    x = np.zeros_like(b)
    r = b - A @ x
    p = r.copy()
    rr = float(r @ r)
    b_norm = rr ** 0.5
    it = 0
    for k in range(max_iters):
        ap = A @ p
        alpha = rr / float(p @ ap)
        x += alpha * p
        r -= alpha * ap
        rr_new = float(r @ r)
        it = k + 1
        if rr_new ** 0.5 < tol * b_norm:
            break
        p = r + (rr_new / rr) * p
        rr = rr_new
    return x, it, rr_new ** 0.5 / b_norm





@pytest.mark.parametrize("g", [8, 16, 33])
@pytest.mark.parametrize("mode", ["stencil5", "stencil5-const", "dia", "csr", "bcoo"])
def test_cg_iteration_parity_f64(g, mode):
    st = generate.make_stencil5(g)
    A = formats.stencil5_to_csr(st).to_dense()
    b = np.ones(g * g)
    x_ref, iters_ref, rel_ref = reference_cg(A, b)

    op = ops.get_operator(mode, st, dtype=jnp.float64)
    bf = op.as_field(b).astype(jnp.float64)
    x, stats = cg.cg_solve(op.run_device_dot, bf)
    assert stats.converged
    assert stats.iterations == iters_ref, (stats.iterations, iters_ref)
    x_flat = np.asarray(op.from_field(x))
    np.testing.assert_allclose(x_flat, x_ref, rtol=1e-8, atol=1e-10)
    # true residual check, not just the recurrence residual
    res = np.linalg.norm(b - A @ x_flat) / np.linalg.norm(b)
    assert res < 1e-6


def test_cg_checksums_match_reference_algorithm():
    """Sum(x)/Norm2(x) checksum discipline (reference cg_solver.cu main :211-219)."""
    g = 24
    st = generate.make_stencil5(g)
    A = formats.stencil5_to_csr(st).to_dense()
    b = np.ones(g * g)
    x_ref, _, _ = reference_cg(A, b)
    op = ops.get_operator("stencil5", st, dtype=jnp.float64)
    x, _ = cg.cg_solve(op.run_device_dot, op.as_field(b).astype(jnp.float64))
    x = np.asarray(x).ravel()
    np.testing.assert_allclose(x.sum(), x_ref.sum(), rtol=1e-10)
    np.testing.assert_allclose(np.linalg.norm(x), np.linalg.norm(x_ref), rtol=1e-10)


def test_cg_stepped_matches_fused():
    g = 16
    st = generate.make_stencil5(g)
    op = ops.get_operator("stencil5", st, dtype=jnp.float64)
    b = op.as_field(np.ones(g * g)).astype(jnp.float64)
    x1, s1 = cg.cg_solve(op.run_device_dot, b)
    x2, s2 = cg.cg_solve_stepped(op.run_device_dot, b)
    assert s1.iterations == s2.iterations
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x2), rtol=1e-12)
    assert s2.spmv_time_ms > 0 and s2.blas1_time_ms > 0


def test_cg_nonzero_x0():
    g = 12
    st = generate.make_stencil5(g)
    A = formats.stencil5_to_csr(st).to_dense()
    op = ops.get_operator("stencil5", st, dtype=jnp.float64)
    b = op.as_field(np.ones(g * g)).astype(jnp.float64)
    x0 = op.as_field(np.random.RandomState(0).randn(g * g)).astype(jnp.float64)
    x, stats = cg.cg_solve(op.run_device_dot, b, x0, spmv=op.run_device)
    assert stats.converged
    res = np.linalg.norm(np.ones(g * g) - A @ np.asarray(x).ravel())
    assert res / np.sqrt(g * g) < 1e-5


def test_cg_max_iters_cap():
    g = 10
    st = generate.make_stencil5(g)
    op = ops.get_operator("stencil5", st, dtype=jnp.float64)
    b = op.as_field(np.ones(g * g)).astype(jnp.float64)
    x, stats = cg.cg_solve(op.run_device_dot, b, config=cg.CGConfig(max_iters=3))
    assert stats.iterations == 3
    assert not stats.converged


def test_cg_f32_converges_with_relaxed_tol():
    """f32: convergence at 1e-4 documented, iteration drift allowed
    (SURVEY.md §7 hard parts: 'expect iteration count to drift at 1e-6 — document')."""
    g = 32
    st = generate.make_stencil5(g)
    op = ops.get_operator("stencil5", st, dtype=jnp.float32)
    b = op.as_field(np.ones(g * g)).astype(jnp.float32)
    x, stats = cg.cg_solve(
        op.run_device_dot, b, config=cg.CGConfig(tolerance=1e-4)
    )
    assert stats.converged
    A = formats.stencil5_to_csr(st).to_dense()
    res = np.linalg.norm(np.ones(g * g) - A @ np.asarray(x, np.float64).ravel())
    assert res / g < 1e-3


def test_cg_nonzero_x0_operator_path():
    """Passing the operator itself with a nonzero x0 must use r0 = b - A x0 automatically
    (regression: the operator path used to silently take the x0 = 0 fast path)."""
    g = 12
    st = generate.make_stencil5(g)
    A = formats.stencil5_to_csr(st).to_dense()
    op = ops.get_operator("stencil5", st, dtype=jnp.float64)
    b = op.as_field(np.ones(g * g)).astype(jnp.float64)
    x0 = op.as_field(np.random.RandomState(1).randn(g * g)).astype(jnp.float64)
    x, stats = cg.cg_solve(op, b, x0)
    assert stats.converged
    res = np.linalg.norm(np.ones(g * g) - A @ np.asarray(x).ravel())
    assert res / g < 1e-5


def test_cg_bare_callable_nonzero_x0_requires_spmv():
    g = 8
    st = generate.make_stencil5(g)
    op = ops.get_operator("stencil5", st, dtype=jnp.float64)
    b = op.as_field(np.ones(g * g)).astype(jnp.float64)
    with pytest.raises(ValueError, match="nonzero x0"):
        cg.cg_solve(op.run_device_dot, b, b)


def test_cg_bf16_coefficients_bitwise_match():
    """stencil5-bf16c: bf16 coefficient storage is bit-identical to f32 storage when the
    coefficient field is exactly representable (5.0 / -1.0 / 0.0 is)."""
    import jax.numpy as jnp

    from tpusparse import generate, ops

    st = generate.make_stencil5(24)
    b = jnp.ones((24, 24), jnp.float32)
    op32 = ops.get_operator("stencil5", st, dtype=jnp.float32)
    op16 = ops.get_operator("stencil5-bf16c", st, dtype=jnp.float32)
    x32, s32 = cg.cg_solve(op32, b)
    x16, s16 = cg.cg_solve(op16, b)
    assert s32.iterations == s16.iterations
    assert bool(jnp.all(x32 == x16))


def test_cg_zero_rhs_returns_x0_no_nan():
    """b = 0 ⇒ x = x0 immediately (0 iterations), never a 0/0 NaN step."""
    import numpy as np

    st = generate.make_stencil5(12)
    op = ops.get_operator("stencil5", st, dtype=jnp.float64)
    b = jnp.zeros((12, 12), jnp.float64)
    x, stats = cg.cg_solve(op, b)
    assert stats.iterations == 0
    assert stats.converged
    assert np.isfinite(np.asarray(x)).all()
    assert float(jnp.abs(x).max()) == 0.0


def test_cg_nonzero_x0_convergence_relative_to_b():
    """The criterion is ‖r‖ < tol·‖b‖, not tol·‖r0‖: a huge x0 makes ‖r0‖ ≫ ‖b‖, and a
    solver using ‖r0‖ would stop early with a garbage solution labeled converged."""
    import numpy as np

    g = 12
    st = generate.make_stencil5(g)
    op = ops.get_operator("stencil5", st, dtype=jnp.float64)
    b = jnp.ones((g, g), jnp.float64)
    x0 = 1e5 * jnp.asarray(np.random.RandomState(0).randn(g, g))
    x, stats = cg.cg_solve(op, b, x0, config=cg.CGConfig(tolerance=1e-8, max_iters=500))
    assert stats.converged
    dense = formats.stencil5_to_csr(st).to_dense()
    true_rel = np.linalg.norm(np.asarray(b).ravel() - dense @ np.asarray(x).ravel()) \
        / np.linalg.norm(np.asarray(b))
    assert true_rel < 1e-6, true_rel


@pytest.mark.parametrize("mode", ["stencil5", "stencil5-csr", "stencil5-bf16c",
                                  "stencil5-const", "stencil5-const-xla"])
def test_cg_stencil_modes_match_xla_oracle(mode):
    """Every stencil mode solves like the plain-XLA oracle (stencil5-xla): identical
    iteration count, matching solution (bf16c planes are exact for 5/-1/0)."""
    g = 16
    st = generate.make_stencil5(g)
    b = jnp.ones((g, g), jnp.float64)
    x_ref, s_ref = cg.cg_solve(ops.get_operator("stencil5-xla", st, dtype=jnp.float64), b)
    x, s = cg.cg_solve(ops.get_operator(mode, st, dtype=jnp.float64), b)
    assert s.converged and s.iterations == s_ref.iterations
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_ref), rtol=1e-12, atol=1e-12)


def test_solver_cache_no_stale_hit_after_free():
    """The solver cache must key on the operator's callables by IDENTITY with a strong
    reference (never a bare id()): freeing an operator and building a new one at a
    possibly-recycled address must produce a fresh cache entry, not a stale hit."""
    import gc

    g = 16
    st = generate.make_stencil5(g)
    b = jnp.ones((g, g), jnp.float64 if jnp.zeros(()).dtype == jnp.float64 else jnp.float32)

    op1 = ops.get_operator("stencil5-xla", st, dtype=b.dtype)
    x1, s1 = cg.cg_solve(op1, b)
    n_entries = len(cg._SOLVER_CACHE)
    op1.free()
    del op1
    gc.collect()

    op2 = ops.get_operator("stencil5-xla", st, dtype=b.dtype)
    x2, s2 = cg.cg_solve(op2, b)
    # a fresh operator's callables are new objects → a NEW cache entry must exist
    # (an id()-keyed cache could silently alias the freed operator's entry here)
    assert len(cg._SOLVER_CACHE) == n_entries + 1
    assert s2.iterations == s1.iterations
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x1), rtol=1e-12, atol=1e-12)


def test_sharded_operator_cache_mesh_content_keyed():
    """Sharded operator/solver caches key on the Mesh OBJECT (content-hashed), not id(mesh):
    two equal meshes hit the same entry; the entry never aliases a different mesh."""
    import jax

    from tpusparse.solvers import cg_sharded

    if jax.device_count() < 2:
        pytest.skip(f"needs 2 devices, have {jax.device_count()}")
    mesh_a = jax.make_mesh((2,), ("x",))
    mesh_b = jax.make_mesh((2,), ("x",))  # equal content, distinct object
    op_a = cg_sharded.make_sharded_operator(mesh_a, 16, mode="stencil5")
    op_b = cg_sharded.make_sharded_operator(mesh_b, 16, mode="stencil5")
    assert op_a is op_b  # content-equal meshes share the cached operand


def test_cg_accepts_unhashable_callable():
    """The bare-callable API must accept UNHASHABLE callables (e.g. an eq=True dataclass
    with __call__): the cache wraps them in an identity key instead of hashing them."""
    import dataclasses

    g = 12
    st = generate.make_stencil5(g)
    op = ops.get_operator("stencil5-xla", st)
    dt = op.ones_b(jnp.float32).dtype if jnp.zeros(()).dtype != jnp.float64 else jnp.float64

    @dataclasses.dataclass(eq=True)
    class SpmvDot:
        scale: float

        def __call__(self, p):
            y, pap = op.run_device_dot(p)
            return y, pap

    fn = SpmvDot(1.0)
    with pytest.raises(TypeError):
        hash(fn)  # precondition: genuinely unhashable
    b = op.ones_b(dt)
    x, stats = cg.cg_solve(fn, b)
    assert stats.converged
