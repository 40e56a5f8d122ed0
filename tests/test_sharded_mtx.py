"""Sharded CG over ARBITRARY (file-loaded, values-carrying) operands — the reference's
flagship workflow `mpirun cg_solver_mgpu_stencil <matrix.mtx>` (src/main/
cg_solver_mgpu_stencil.cu:50-60) end-to-end, plus the generic band-local "csr" sharded
operator (the comparison CSR kernel the reference carries inside its partitioned solver,
cg_solver_mgpu_partitioned.cu:40-56)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpusparse.solvers import cg, cg_sharded



REF_MTX = "/root/reference/matrix/example81x81.mtx"


def _mesh(n):
    return jax.make_mesh((n,), ("x",), devices=jax.devices()[:n])


def _single_chip_oracle(mat, tol=1e-6, max_iters=400):
    from tpusparse import ops

    op = ops.get_operator("stencil5", mat, dtype=jnp.float64)
    g = op.grid_size
    return cg.cg_solve(op, jnp.ones((g, g), jnp.float64),
                       config=cg.CGConfig(tolerance=tol, max_iters=max_iters))


class TestShardedFileOperands:
    @pytest.mark.skipif(not os.path.exists(REF_MTX),
                        reason="reference checkout not available")
    def test_reference_sample_sharded_parity(self):
        """The reference's own 81×81 sample (legacy −4 diag: negative-definite, CG's
        iterates are identical to the sign-flipped SPD system) solved 8-way sharded,
        parity-gated against the single-chip solve."""
        from tpusparse import formats, io_mtx

        csr = formats.coo_to_csr(io_mtx.load_matrix_market(REF_MTX))
        st = formats.csr_to_stencil5(csr)
        x8, s8 = cg_sharded.cg_solve_sharded(
            _mesh(8), st.grid_size, mode="stencil5", planes=st.planes,
            dtype=jnp.float64, max_iters=400)
        x1, s1 = _single_chip_oracle(st)
        assert s8.converged and s1.converged
        assert s8.iterations == s1.iterations
        np.testing.assert_allclose(np.asarray(x8, np.float64).sum(),
                                   np.asarray(x1, np.float64).sum(), rtol=1e-10)

    def test_generated_mtx_through_multichip_cli(self, tmp_path):
        """The file contract: `cg_solver_multichip path.mtx --chips=8` on a generated
        matrix, CPU mesh, JSON export checked for parity vs the single-chip solve."""
        from tpusparse import generate
        from tpusparse.cli import cg_solver_multichip

        g = 48
        mtx = tmp_path / f"g{g}.mtx"
        generate.write_matrix_market_stencil5(str(mtx), g)
        out = tmp_path / "out.json"
        rc = cg_solver_multichip.main(
            [str(mtx), "--chips=8", "--runs=3", "--warmup=1", f"--json={out}"])
        assert rc == 0
        rec = json.loads(out.read_text())
        assert rec["convergence"]["converged"]
        assert rec["matrix"]["grid_size"] == g
        assert rec["matrix"]["name"] == f"g{g}.mtx"
        from tpusparse.generate import make_stencil5

        x1, s1 = _single_chip_oracle(make_stencil5(g))
        assert rec["convergence"]["iterations"] == s1.iterations
        np.testing.assert_allclose(rec["validation"]["solution_sum"],
                                   float(np.asarray(x1, np.float64).sum()), rtol=1e-10)

    @pytest.mark.skipif(not os.path.exists(REF_MTX),
                        reason="reference checkout not available")
    def test_reference_sample_through_multichip_cli(self, tmp_path):
        out = tmp_path / "ref81.json"
        from tpusparse.cli import cg_solver_multichip

        rc = cg_solver_multichip.main(
            [REF_MTX, "--chips=8", "--runs=3", "--warmup=1", "--maxiter=400",
             f"--json={out}"])
        assert rc == 0
        rec = json.loads(out.read_text())
        assert rec["convergence"]["converged"]
        assert rec["matrix"]["grid_size"] == 81
        assert rec["matrix"]["nnz"] == 32481

    @pytest.mark.slow
    def test_generated_1k_mtx_sharded_parity(self, tmp_path):
        """The file contract at the 1k scale: a generated 1000×1000-grid .mtx (1M
        unknowns, ~5M nnz) solved 8-way sharded from the FILE, parity vs 1-device."""
        from tpusparse import formats, generate, io_mtx

        g = 1000
        mtx = tmp_path / "g1000.mtx"
        generate.write_matrix_market_stencil5(str(mtx), g)
        st = formats.csr_to_stencil5(
            formats.coo_to_csr(io_mtx.load_matrix_market(str(mtx))))
        assert st.grid_size == g
        x8, s8 = cg_sharded.cg_solve_sharded(_mesh(8), g, mode="stencil5",
                                             planes=st.planes, dtype=jnp.float64)
        x1, s1 = cg_sharded.cg_solve_sharded(_mesh(1), g, mode="stencil5",
                                             planes=st.planes, dtype=jnp.float64)
        assert s8.converged and s8.iterations == s1.iterations
        np.testing.assert_allclose(np.asarray(x8, np.float64).sum(),
                                   np.asarray(x1, np.float64).sum(), rtol=1e-10)

    def test_non_stencil_mtx_clean_error(self, tmp_path, capsys):
        """A non-stencil matrix through a stencil mode must fail with the actionable
        message (use --mode=csr), not a traceback."""
        from tpusparse import io_mtx
        from tpusparse.cli import cg_solver_multichip
        from tpusparse.formats import COOMatrix

        n = 16
        rng = np.random.RandomState(0)
        rows = np.arange(n, dtype=np.int64)
        coo = COOMatrix(n, n, rows, rows[::-1].copy(), rng.rand(n) + 1)
        mtx = tmp_path / "perm.mtx"
        io_mtx.write_matrix_market(str(mtx), coo)
        rc = cg_solver_multichip.main([str(mtx), "--runs=1", "--warmup=0"])
        assert rc == 2
        assert "--mode=csr" in capsys.readouterr().err


class TestShardedGenericCsr:
    @pytest.mark.parametrize("ndev", [1, 2, 8])
    def test_csr_mode_parity_with_stencil(self, ndev):
        g = 32
        xc, sc = cg_sharded.cg_solve_sharded(_mesh(ndev), g, mode="csr",
                                             dtype=jnp.float64)
        xs, ss = cg_sharded.cg_solve_sharded(_mesh(ndev), g, mode="stencil5",
                                             dtype=jnp.float64)
        assert sc.converged and sc.iterations == ss.iterations
        np.testing.assert_allclose(np.asarray(xc, np.float64),
                                   np.asarray(xs, np.float64), rtol=1e-10)

    def test_csr_mode_padded_grid(self):
        x, st = cg_sharded.cg_solve_sharded(_mesh(8), 30, mode="csr", dtype=jnp.float64)
        assert st.converged and np.asarray(x).shape == (30, 30)
        x1, s1 = cg_sharded.cg_solve_sharded(_mesh(1), 30, mode="csr", dtype=jnp.float64)
        assert st.iterations == s1.iterations

    def test_csr_mode_generic_banded_spmv(self):
        """The operator is GENERIC: a random banded g²×g² matrix (reach ≤ g, but no
        stencil structure) SpMV'd through the sharded kernel vs the dense oracle."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        from tests import fixtures

        g = 16
        csr = fixtures.banded(g * g, bandwidth=g - 2, seed=5)
        mesh = _mesh(4)
        op = cg_sharded.make_sharded_operator(mesh, g, mode="csr", matrix=csr,
                                              dtype=jnp.float64)
        rng = np.random.RandomState(7)
        xv = rng.rand(g, g)
        xd = jax.device_put(jnp.asarray(xv), NamedSharding(mesh, P("x", None)))

        def local(ops_l, x_l):
            hp, hn = cg_sharded._band_halo_exchange(x_l, "x", 4)
            return op._ell_band_spmv(ops_l[0], ops_l[1], x_l, hp, hn)

        y = jax.jit(jax.shard_map(
            local, mesh=mesh, in_specs=(op.operand_spec, P("x", None)),
            out_specs=P("x", None), check_vma=False))(op.operands_arg, xd)
        expect = csr.to_dense() @ xv.ravel()
        np.testing.assert_allclose(np.asarray(y).ravel(), expect, rtol=1e-12)
        assert op.nnz == csr.nnz  # real nnz, not the stencil formula

    def test_csr_mode_rejects_reach_violation(self):
        from tests import fixtures

        g = 8
        csr = fixtures.random_sparse(g * g, density=0.2, seed=9)  # columns anywhere
        with pytest.raises(ValueError, match="halo reach|grid-row"):
            cg_sharded.make_sharded_operator(_mesh(4), g, mode="csr", matrix=csr,
                                             dtype=jnp.float64)

    def test_csr_mode_through_cli(self, tmp_path):
        from tpusparse.cli import cg_solver_multichip

        out = tmp_path / "csr.json"
        rc = cg_solver_multichip.main(
            ["gen:32", "--chips=8", "--mode=csr", "--runs=3", "--warmup=1",
             f"--json={out}"])
        assert rc == 0
        rec = json.loads(out.read_text())
        assert rec["mode"] == "csr" and rec["convergence"]["converged"]
