"""CLI smoke tests (the reference's CI smoke layer: help text, arg validation, error paths,
then real runs — ci.yml:175-204, but here the operators actually execute, on the CPU)."""

import json

from tpusparse.cli import cg_solver, generate_matrix, spmv_bench


def test_generate_matrix_roundtrip(tmp_path):
    p = str(tmp_path / "g.mtx")
    assert generate_matrix.main(["7", p]) == 0
    head = open(p).readline()
    assert head.startswith("%%MatrixMarket")


def test_generate_matrix_rejects_bad_dim(tmp_path):
    assert generate_matrix.main(["0", str(tmp_path / "x.mtx")]) == 2


def test_spmv_bench_unknown_mode_fails_before_load(tmp_path):
    # validation happens before the (nonexistent) file is touched — reference main.cu:94-105
    assert spmv_bench.main(["/nonexistent.mtx", "--mode=notamode"]) == 2


def test_spmv_bench_end_to_end(tmp_path, capsys):
    mtx = str(tmp_path / "g.mtx")
    generate_matrix.main(["9", mtx])
    jout = str(tmp_path / "r.json")
    csv = str(tmp_path / "r.csv")
    rc = spmv_bench.main([mtx, "--mode=stencil5,csr", "--runs=3", "--warmup=1",
                          f"--json={jout}", f"--csv={csv}"])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("=== Output Checksum ===") == 2
    # both modes agree on the checksum lines
    sums = [line for line in out.splitlines() if line.startswith("Sum(y)")]
    assert len(set(sums)) == 1
    for mode in ("stencil5", "csr"):
        with open(str(tmp_path / f"r_{mode}.json")) as f:
            r = json.load(f)
        assert r["benchmark"]["mode"] == mode
    assert len(open(csv).read().strip().splitlines()) == 3


def test_spmv_bench_resident_x(tmp_path, capsys):
    """--resident-x (device-resident run loop, the reference's actual timed-region shape)
    must produce the same checksums as the transfer-inclusive default and label the
    artifact's run_protocol accordingly."""
    jout = str(tmp_path / "r.json")
    rc = spmv_bench.main(["gen:12", "--mode=stencil5", "--runs=3", "--warmup=1",
                          "--resident-x", f"--json={jout}"])
    assert rc == 0
    out = capsys.readouterr().out
    rc2 = spmv_bench.main(["gen:12", "--mode=stencil5", "--runs=3", "--warmup=1"])
    assert rc2 == 0
    out2 = capsys.readouterr().out
    sums = [line for line in (out + out2).splitlines() if line.startswith("Sum(y)")]
    assert len(sums) == 2 and len(set(sums)) == 1
    with open(str(tmp_path / "r_stencil5.json")) as f:
        r = json.load(f)
    assert r["benchmark"]["run_protocol"] == "device-resident"


def test_spmv_bench_gen_spec(capsys):
    rc = spmv_bench.main(["gen:12", "--mode=stencil5-const", "--runs=3", "--warmup=0"])
    assert rc == 0
    assert "stencil5-12x12" in capsys.readouterr().out


def test_cg_solver_end_to_end(tmp_path, capsys):
    jout = str(tmp_path / "cg.json")
    rc = cg_solver.main(["gen:16", "--runs=3", "--warmup=1", f"--json={jout}",
                         "--verbose=0"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Converged:  YES" in out
    with open(jout) as f:
        r = json.load(f)
    assert r["convergence"]["converged"] is True
    assert r["convergence"]["iterations"] > 0
    assert r["validation"]["solution_norm"] > 0


def test_cg_solver_timers_mode(capsys):
    rc = cg_solver.main(["gen:12", "--timers", "--runs=3", "--warmup=0", "--verbose=0"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "SpMV:" in out  # per-phase breakdown printed


def test_cg_solver_nonconvergence_exit_code(capsys):
    rc = cg_solver.main(["gen:16", "--maxiter=2", "--runs=3", "--warmup=0", "--verbose=0"])
    assert rc == 1


def test_cg_solver_host_single_run(capsys):
    """--host: the reference's host-interface fallback — single timed run after one warmup
    (cg_solver.cu:172-181)."""
    rc = cg_solver.main(["gen:12", "--host", "--verbose=0"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Converged:  YES" in out


def test_cg_solver_host_device_conflict(capsys):
    assert cg_solver.main(["gen:12", "--host", "--device", "--verbose=0"]) == 2


def test_cg_solver_stencil5_xla_mode(capsys):
    """The XLA oracle mode solves end-to-end with the same iteration count as Pallas."""
    rc = cg_solver.main(["gen:16", "--mode=stencil5-xla", "--runs=3", "--warmup=1",
                         "--verbose=0"])
    assert rc == 0
    out_xla = capsys.readouterr().out
    rc = cg_solver.main(["gen:16", "--mode=stencil5", "--runs=3", "--warmup=1",
                         "--verbose=0"])
    assert rc == 0
    out_pl = capsys.readouterr().out
    it = [line for line in out_xla.splitlines() if line.startswith("Iterations")]
    assert it and it == [line for line in out_pl.splitlines()
                         if line.startswith("Iterations")]


def test_cg_solver_multichip_virtual_mesh(capsys):
    """Multichip CLI over the 8-virtual-device mesh: convergence, load-imbalance report
    (reference prints MAX/MIN rank timers + imbalance %, cg_solver_mgpu_partitioned.cu:
    758-773), and checksum output."""
    from tpusparse.cli import cg_solver_multichip

    rc = cg_solver_multichip.main(["gen:24", "--chips=4", "--runs=3", "--warmup=1"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Converged:  YES" in out
    assert "Load imbalance:" in out
    assert "Sum(x)" in out


def test_cg_solver_padded_field_mode_converges():
    """dia's lane-padded field: b must be the zero-tailed buffer (in-graph ones would put
    1.0 in decoupled padded rows and never converge)."""
    rc = cg_solver.main(["gen:12", "--mode=dia", "--runs=3", "--warmup=1", "--verbose=0"])
    assert rc == 0
