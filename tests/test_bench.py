"""Benchmark harness: stats engine protocol, metrics models, exporters."""

import json

import pytest

from tpusparse import generate, ops
from tpusparse.bench import export, metrics, stats, sysinfo


class TestStats:
    def test_outlier_removal_two_sigma(self):
        times = [10.0] * 9 + [100.0]  # the 100 is way past 2σ
        s = stats.compute_stats(times)
        assert s.outliers_removed == 1
        assert s.valid_runs == 9
        assert s.median_ms == 10.0
        assert s.max_ms == 10.0

    def test_median_run_index_points_into_original_list(self):
        times = [5.0, 3.0, 9.0, 4.0, 100.0]
        s = stats.compute_stats(times)
        # 100 is dropped; median of {5,3,9,4} = 4.5 → closest is 4.0 or 5.0
        assert s.times_ms[s.median_run_index] in (4.0, 5.0)

    def test_min_runs_enforced(self):
        with pytest.raises(ValueError):
            stats.compute_stats([1.0, 2.0])

    def test_degenerate_all_identical(self):
        s = stats.compute_stats([7.0] * 10)
        assert s.outliers_removed == 0
        assert s.std_ms == 0.0

    def test_benchmark_with_stats_runs_warmup(self):
        calls = []
        def run():
            calls.append(1)
            return 1.0
        s = stats.benchmark_with_stats(run, num_runs=10, warmup=5)
        assert len(calls) == 15
        assert s.total_runs == 10

    def test_solver_stats_median_payload(self):
        seq = iter([(9.0, "a"), (1.0, "b"), (5.0, "c"), (4.0, "d"), (6.0, "e")])
        s, payload = stats.benchmark_solver_with_stats(
            lambda: next(seq), num_runs=5, warmup=0
        )
        assert payload == "c"  # 5.0 is the median of {9,1,5,4,6}


class TestMetrics:
    def test_stencil5_byte_model(self):
        # 7 words/point: 5 coefficients + x + y (48 B/row in f64, the reference's model)
        assert metrics.bytes_stencil5(100, 8) == 5600
        assert metrics.bytes_stencil5_const(100, 8) == 1600

    def test_csr_byte_model_matches_reference_shape(self):
        # nnz*(8+4) + (rows+1)*4 + 2*rows*8 for f64 (spmv_metrics.cu:76-95)
        assert metrics.bytes_csr(10, 4, itemsize=8) == 10 * 12 + 5 * 4 + 2 * 4 * 8

    def test_roofline_fraction_and_bound(self):
        st = generate.make_stencil5(8)
        op = ops.get_operator("stencil5", st)
        m = metrics.calculate_spmv_metrics(
            op, 1.0, dtype_itemsize=4, device_kind="NVIDIA H100 80GB HBM3", mode="stencil5"
        )
        assert 0 < m.roofline_fraction < 1e-3  # 1 ms for a tiny matrix ⇒ tiny fraction
        assert m.bound == "memory-bound"
        assert m.gflops == pytest.approx(2 * op.nnz / 1e6)  # 1 ms ⇒ 2·nnz·1e3 FLOP/s

    def test_chip_peaks_known_kinds(self):
        # NVIDIA H100 data sheet: SXM5 3,350 GB/s and 67 TFLOP/s f32; PCIe 2,000 GB/s
        assert metrics.chip_peaks("NVIDIA H100 80GB HBM3") == (3350.0, 67_000.0)
        assert metrics.chip_peaks("NVIDIA H100 PCIe")[0] == 2000.0

    @pytest.mark.parametrize("kind", ["AMD Instinct MI300X", "cpu", "NVIDIA A100-SXM4-80GB",
                                      "NVIDIA H100"])
    def test_chip_peaks_unknown_kind_raises(self, kind):
        with pytest.raises(ValueError, match="no published peaks"):
            metrics.chip_peaks(kind)

    def test_unknown_kind_gets_no_roofline_share(self):
        st = generate.make_stencil5(8)
        op = ops.get_operator("stencil5", st)
        m = metrics.calculate_spmv_metrics(op, 1.0, dtype_itemsize=8, device_kind="cpu",
                                           mode="stencil5")
        assert m.roofline_fraction is None and m.bound == "unknown"
        assert m.bandwidth_gbs > 0

    def test_cg_gflops(self):
        assert metrics.cg_gflops(1000, 10, 2.0) == pytest.approx(2 * 1000 * 10 / 2e-3 / 1e9)


class TestExport:
    def _result(self):
        st = generate.make_stencil5(8)
        op = ops.get_operator("stencil5", st)
        bench = stats.compute_stats([1.0, 1.1, 0.9, 1.05])
        m = metrics.calculate_spmv_metrics(
            op, bench.median_ms, dtype_itemsize=8, device_kind="cpu", mode="stencil5"
        )
        info = sysinfo.get_system_info()
        return export.spmv_result_dict(
            mode="stencil5", matrix_name="t", op=op, metrics=m, stats=bench,
            sysinfo=info, sum_y=1.0, norm2_y=2.0,
        )

    def test_json_roundtrip(self, tmp_path):
        p = str(tmp_path / "r.json")
        export.write_json(p, self._result())
        with open(p) as f:
            r = json.load(f)
        assert r["benchmark"]["validation"]["sum_y"] == 1.0
        assert r["benchmark"]["matrix"]["grid_size"] == 8
        assert "device_kind" in r["device"]

    def test_csv_append_header_once(self, tmp_path):
        p = str(tmp_path / "r.csv")
        export.append_csv(p, self._result())
        export.append_csv(p, self._result())
        lines = open(p).read().strip().splitlines()
        assert len(lines) == 3  # one header + two rows
        assert lines[0].startswith("timestamp")

    def test_csv_append_evolved_schema(self, tmp_path):
        """The load-bearing sweep behavior (export.append_csv drop-new/blank-missing):
        appending a row whose schema EVOLVED — new fields added, some old ones gone —
        must keep every row aligned to the FILE's header: new fields dropped, missing
        ones blank, never a silent column shift mid-file."""
        import csv as _csv

        p = str(tmp_path / "r.csv")
        export.append_csv(p, self._result())
        evolved = self._result()
        evolved["benchmark"]["performance"]["new_metric_xyz"] = 42.0  # new field
        del evolved["benchmark"]["validation"]["norm2_y"]  # removed field
        export.append_csv(p, evolved)
        with open(p, newline="") as f:
            rows = list(_csv.reader(f))
        header, r1, r2 = rows
        assert len(r1) == len(header) and len(r2) == len(header)
        assert "benchmark.performance.new_metric_xyz" not in header  # dropped, not mixed
        col = header.index("benchmark.validation.norm2_y")
        assert r1[col] == "2.0" and r2[col] == ""  # blank, not shifted
        # every shared column must land in the same place in both rows
        mode_col = header.index("benchmark.mode")
        assert r1[mode_col] == r2[mode_col] == "stencil5"

    def test_human_print_sections(self, capsys):
        export.print_human_spmv(self._result())
        out = capsys.readouterr().out
        assert "=== SpMV Performance Metrics ===" in out
        assert "=== Output Checksum ===" in out
        assert "Sum(y)" in out


def test_sysinfo_fields():
    info = sysinfo.get_system_info()
    for key in ("device_kind", "jax_version", "num_devices", "peak_hbm_gbs", "backend"):
        assert key in info
    import jax

    expected = 8 if jax.default_backend() == "cpu" else jax.device_count()
    assert info["num_devices"] == expected  # 8-virtual CPU mesh; real count on hardware


class TestKernelTimeProtocol:
    """Pin the paired-chain differencing protocol (ops.DeviceOperator.kernel_time_ms):
    every headline bandwidth number is derived from it, so its semantics — the slope of two
    chain lengths recovers the true per-apply time, fixed costs cancel, adaptive chain
    shortening never nonsensical — are regression-gated here with a deterministic fake
    operator (sleep-based run_device)."""

    @staticmethod
    def _fake_op(apply_seconds):
        import time

        import jax.numpy as jnp

        from tpusparse.ops import DeviceOperator

        def run_device(x):
            time.sleep(apply_seconds)
            return x

        return DeviceOperator(
            name="fake", num_rows=64, num_cols=64, nnz=64, field_shape=(8, 8),
            run_device=run_device, run_device_dot=lambda x: (x, jnp.vdot(x, x)),
            _buffers={"dtype": jnp.float32},
        )

    def test_chain_slope_recovers_per_apply_time(self):
        per_apply_ms = 10.0
        op = self._fake_op(per_apply_ms / 1e3)
        measured = op.kernel_time_ms(chain=5, reps=2)
        # the (k_hi − k_lo)-chain slope must recover the per-apply cost (generous upper
        # bound for scheduler noise; the lower bound is hard — sleep cannot run short)
        assert measured >= 0.9 * per_apply_ms, measured
        assert measured <= 3.0 * per_apply_ms, measured

    def test_fixed_overhead_cancels_in_slope(self):
        """A constant per-CHAIN cost (dispatch and the final sync) must NOT be charged to
        the per-apply time — the differencing
        protocol's defining property.  Naive chain-averaging fails this: an 8-chain of
        5 ms applies with a 60 ms fixed cost averages 12.5 ms/apply."""
        import time

        import jax.numpy as jnp

        from tpusparse.ops import DeviceOperator

        per_apply_ms, fixed_ms = 20.0, 240.0
        state = {"x0": None}

        def run_device(v):
            # kernel_time_ms feeds the SAME initial array into every chain head and our
            # output (a fresh object) into subsequent links — so argument identity marks
            # the chain head, where the emulated per-chain fixed cost fires once.
            if state["x0"] is None:
                state["x0"] = v
            if v is state["x0"]:
                time.sleep(fixed_ms / 1e3)
            time.sleep(per_apply_ms / 1e3)
            return v + 0  # fresh object each link

        op = DeviceOperator(
            name="fake", num_rows=64, num_cols=64, nnz=64, field_shape=(8, 8),
            run_device=run_device, run_device_dot=lambda x: (x, jnp.vdot(x, x)),
            _buffers={"dtype": jnp.float32},
        )
        measured = op.kernel_time_ms(chain=8, reps=1)
        # both chains pay the fixed cost exactly once → it cancels in the slope.
        # Naive 8-chain averaging would report ≥ per_apply + fixed/8 = 2.5× — the 2×
        # bound rejects that while leaving headroom for scheduler noise under load.
        assert measured <= 2.0 * per_apply_ms, measured
        assert measured >= 0.9 * per_apply_ms, measured

    def test_adaptive_chain_shortening_stays_sane(self):
        # A slow operator (120 ms/apply) forces the adaptive shortening path
        # (chain scaled to keep a rep under ~1 s) — the result must still be the
        # per-apply time, never a nonsensical total or zero.
        per_apply_ms = 120.0
        op = self._fake_op(per_apply_ms / 1e3)
        measured = op.kernel_time_ms(chain=20, reps=3)
        assert measured >= 0.9 * per_apply_ms, measured
        assert measured <= 2.0 * per_apply_ms, measured

    def test_real_operator_positive_and_finite(self):
        import math

        st = generate.make_stencil5(16)
        op = ops.get_operator("stencil5-xla", st)
        t = op.kernel_time_ms(chain=4, reps=2)
        assert math.isfinite(t) and t > 0.0


class TestCeilingProbe:
    def test_probe_returns_positive_bandwidths(self):
        from tpusparse.bench import probes

        r = probes.measure_achievable_bw(n_elems=2 ** 16, k_lo=2, k_hi=6, reps=2)
        for k in ("read_gbs", "copy_gbs", "triad_gbs", "mix7_gbs", "read6_gbs",
                  "achievable_gbs"):
            assert r[k] > 0.0, (k, r)
        assert r["achievable_gbs"] == max(
            v for k, v in r.items() if k.endswith("_gbs") and k != "achievable_gbs")

    def test_achievable_fraction_in_metrics_and_export(self):
        st = generate.make_stencil5(16)
        op = ops.get_operator("stencil5-xla", st)
        m = metrics.calculate_spmv_metrics(
            op, 1.0, dtype_itemsize=4, device_kind="cpu", mode="stencil5",
            achievable_gbs=100.0,
        )
        assert m.roofline_fraction_achievable == pytest.approx(m.bandwidth_gbs / 100.0)
        s = stats.compute_stats([1.0, 1.0, 1.0])
        d = export.spmv_result_dict(
            mode="stencil5", matrix_name="t", op=op, metrics=m, stats=s,
            sysinfo={"device_kind": "cpu"}, sum_y=0.0, norm2_y=0.0,
        )
        p = d["benchmark"]["performance"]
        assert p["achievable_gbs"] == 100.0
        assert p["roofline_fraction_achievable"] == m.roofline_fraction_achievable

    def test_no_probe_no_field(self):
        st = generate.make_stencil5(16)
        op = ops.get_operator("stencil5-xla", st)
        m = metrics.calculate_spmv_metrics(
            op, 1.0, dtype_itemsize=4, device_kind="cpu", mode="stencil5",
        )
        s = stats.compute_stats([1.0, 1.0, 1.0])
        d = export.spmv_result_dict(
            mode="stencil5", matrix_name="t", op=op, metrics=m, stats=s,
            sysinfo={"device_kind": "cpu"}, sum_y=0.0, norm2_y=0.0,
        )
        assert "roofline_fraction_achievable" not in d["benchmark"]["performance"]


def test_slope_noise_guard_falls_back_to_chain_average():
    """slope_seconds: jitter-dominated (t_hi <= t_lo) must fall back to the chain
    average, never return a near-zero slope that exports absurd bandwidths."""
    from tpusparse.bench.probes import slope_seconds

    assert slope_seconds(0.5, 0.4, 2, 8) == pytest.approx(0.4 / 8)   # negative slope
    assert slope_seconds(0.5, 0.5001, 2, 8) == pytest.approx(0.5001 / 8)  # ~zero slope
    assert slope_seconds(0.2, 0.8, 2, 8) == pytest.approx(0.1)       # healthy slope


def test_chain_program_matches_sequential_applies():
    """kernel_time_ms's jitted fori_loop chain (the footprint-bounded protocol that
    replaced host-loop chaining: ~10 enqueued launches × 1.68 GB outputs OOM'd 20480²)
    must compute exactly the k-fold apply, and free() must drop it."""
    import numpy as np

    from tpusparse import formats, ops

    st = formats.Stencil5(grid_size=12, planes=None, constant=(5.0, -1.0))
    for mode in ("stencil5", "csr", "dia"):
        op = ops.get_operator(mode, st)
        x = op.ones_b(op._run_dtype())
        prog = op._chain_program()
        assert prog is not None
        got = prog(x, op.operands, k=3)
        ref = x
        for _ in range(3):
            ref = op.run_device(ref)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-6)
        assert op.kernel_time_ms(chain=4, reps=1) > 0
        op.free()
        assert getattr(op, "_chain_jit", None) is None


def test_timing_validity_flags():
    """An implied bandwidth above the published peak or the measured ceiling is flagged as
    no roofline claim, and the export carries the flags."""
    import types

    from tpusparse import formats, ops
    from tpusparse.bench import export, metrics
    from tpusparse.bench.stats import compute_stats

    h100 = "NVIDIA H100 80GB HBM3"
    st = formats.Stencil5(grid_size=16, planes=None, constant=(5.0, -1.0))
    op = ops.get_operator("stencil5", st)
    # 16*16*7*4 B in a nanosecond: far above any memory peak (cache residency or error)
    m2 = metrics.calculate_spmv_metrics(
        op, 1e-6, dtype_itemsize=4, device_kind=h100, mode="stencil5")
    assert any("exceeds_nominal_peak" in f for f in m2.timing_flags)
    op_big = types.SimpleNamespace(name="stencil5", num_rows=8192 * 8192,
                                   nnz=5 * 8192 * 8192)
    # healthy time on a big working set -> no flags
    m3 = metrics.calculate_spmv_metrics(
        op_big, 100.0, dtype_itemsize=4, device_kind=h100, mode="stencil5")
    assert m3.timing_flags == ()
    # above a measured ceiling but below the published peak
    m4 = metrics.calculate_spmv_metrics(
        op_big, 2.0, dtype_itemsize=4, device_kind=h100, mode="stencil5",
        achievable_gbs=500.0)
    assert any("exceeds_measured_ceiling" in f for f in m4.timing_flags)
    # flags survive into the JSON dict
    res = export.spmv_result_dict(
        mode="stencil5", matrix_name="t", op=op, metrics=m2,
        stats=compute_stats([1.0, 1.0, 1.0]), sysinfo={"device_kind": h100},
        sum_y=0.0, norm2_y=0.0)
    assert res["benchmark"]["performance"]["timing_flags"]
    res_ok = export.spmv_result_dict(
        mode="stencil5", matrix_name="t", op=op, metrics=m3,
        stats=compute_stats([1.0, 1.0, 1.0]), sysinfo={"device_kind": h100},
        sum_y=0.0, norm2_y=0.0)
    assert "timing_flags" not in res_ok["benchmark"]["performance"]


def test_dispatch_correction_marks_clipped_buckets():
    """A bucket whose raw time is below the measured dispatch floor exports as 0.0 AND is
    named in dispatch_clipped — distinguishable from a genuinely-zero bucket."""
    from tpusparse.solvers.cg import CGStats
    from tpusparse.solvers.cg_sharded import _apply_dispatch_correction

    st = CGStats(halo_time_ms=0.5, spmv_time_ms=50.0, blas1_time_ms=10.0,
                 allreduce_time_ms=1.0)
    n_block = {"halo": 10, "spmv": 10, "blas1": 10}
    _apply_dispatch_correction(st, n_block, n_read_calls=10,
                               disp_block=0.2, disp_read=0.05)
    assert st.halo_time_ms == 0.0 and "halo" in st.dispatch_clipped
    assert st.spmv_time_ms == pytest.approx(48.0)
    assert "spmv" not in st.dispatch_clipped and "blas1" not in st.dispatch_clipped
    assert st.allreduce_time_ms == pytest.approx(0.5)
    # the clipped marker reaches the export
    from tpusparse.bench import export

    class _Op:
        num_rows = num_cols = 4
        nnz = 4
        grid_size = 2

    st.dispatch_block_ms = 0.2
    st.dispatch_readback_ms = 0.05
    res = export.cg_result_dict(
        solver="s", mode="m", matrix_name="t", op=_Op(), cg_stats=st,
        bench_stats=None, sysinfo={}, sum_x=0.0, norm2_x=0.0)
    assert res["timing"]["dispatch_clipped_buckets"] == "halo"
