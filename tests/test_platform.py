"""Platform plumbing: compile cache location, card provenance from nvidia-smi, dot precision,
dtype defaults, and chip_smoke.py's host-side helpers and refusal to run without a GPU."""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpusparse import dist, formats, generate, ops
from tpusparse.bench import sysinfo
from tpusparse.kernels.blas1 import dot
from tpusparse.solvers import cg

from . import fixtures

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def restore_cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_var_honoured(monkeypatch, tmp_path, restore_cache_config):
    jax.config.update("jax_compilation_cache_dir", "/unset-marker")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert dist.enable_compilation_cache() == str(tmp_path / "cc")
    # JAX reads the variable itself: the program sets no other directory
    assert jax.config.jax_compilation_cache_dir == "/unset-marker"


def test_compile_cache_fixed_default(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert dist.DEFAULT_CACHE_DIR == os.path.join(ROOT, ".jax_cache")
    assert dist.enable_compilation_cache() == dist.DEFAULT_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == dist.DEFAULT_CACHE_DIR
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


_SMI = ("NVIDIA H100 80GB HBM3, 700.00 W, 71.35 W, 345 MHz, 1980 MHz, 2619 MHz, 31\n"
        "NVIDIA H100 80GB HBM3, 400.00 W, 68.10 W, 345 MHz, 1980 MHz, 2619 MHz, 29\n")


def test_nvidia_smi_parsing():
    cards = sysinfo.parse_nvidia_smi(_SMI + "garbled line\n")
    assert len(cards) == 2
    assert cards[0]["name"] == "NVIDIA H100 80GB HBM3"
    assert cards[0]["power.limit"] == "700.00 W" and cards[1]["power.limit"] == "400.00 W"
    assert cards[1]["temperature.gpu"] == "29"
    assert set(cards[0]) == set(sysinfo.NVIDIA_SMI_FIELDS)


def test_nvidia_smi_query_with_faked_command(tmp_path):
    fake = tmp_path / "nvidia-smi"
    fake.write_text("#!/bin/sh\n"
                    "case \"$1\" in --query-gpu=name,power.limit,*) ;; *) exit 3;; esac\n"
                    f"printf '{_SMI.splitlines()[0]}\\n'\n")
    fake.chmod(0o755)
    cards = sysinfo.query_nvidia_smi(str(fake))
    assert cards == sysinfo.parse_nvidia_smi(_SMI.splitlines()[0])
    assert sysinfo.query_nvidia_smi(str(tmp_path / "missing")) is None


def test_sysinfo_on_cpu_reports_no_peak():
    info = sysinfo.get_system_info()
    assert info["platform"] == "cpu"
    assert info["peak_hbm_gbs"] is None and "nvidia_smi" not in info


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.float64])
def test_dot_is_a_reduction_not_a_dot_general(dtype):
    """blas1.dot never lowers to dot_general (TF32 on the GPU); bf16 accumulates in f32."""
    a = jnp.ones((4, 8), dtype)
    jaxpr = jax.make_jaxpr(dot)(a, a)
    assert "dot_general" not in str(jaxpr)
    assert "reduce_sum" in str(jaxpr)
    assert dot(a, a).dtype == jnp.promote_types(dtype, jnp.float32)


@pytest.mark.parametrize("mode", ["stencil5", "stencil5-const", "csr", "dia", "bcoo"])
def test_cg_solve_lowers_without_dot_general(mode):
    """No contraction in the lowered f32 CG solve of any operator may run at default
    precision (TF32 on the GPU): every dot is a reduction.  bcoo's matvec lowers to a
    dot_general without contracting dimensions — an elementwise product, never TF32."""
    g = 8
    op = ops.get_operator(mode, generate.make_stencil5(g), dtype=jnp.float32)
    b = jax.ShapeDtypeStruct(op.field_shape, jnp.float32)
    solve = cg._build_solver(op.run_device_dot_op, None, 100, 1e-6, b, ("precision", mode),
                             synth_b=True)
    text = solve.lower(op.operands).as_text()
    dots = [ln for ln in text.splitlines() if "stablehlo.dot" in ln]
    assert all("contracting_dims = [] x []" in ln or "precision = [HIGHEST, HIGHEST]" in ln
               for ln in dots), dots
    assert bool(dots) == (mode == "bcoo")


def test_default_dtype_follows_x64():
    assert jax.config.jax_enable_x64
    assert ops._default_dtype() == jnp.float64
    op = ops.get_operator("stencil5", generate.make_stencil5(4))
    assert op._run_dtype() == jnp.float64


def test_chip_smoke_refuses_a_cpu_backend():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode != 0
    assert "needs a GPU backend" in proc.stderr
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())


@pytest.mark.parametrize("band", [0, 1, 2], ids=["first", "middle", "last"])
def test_chip_smoke_band_reference(band):
    cs = _load_chip_smoke()
    g, width = 40, 8
    x = np.random.RandomState(band).randn(g, g)
    y = (fixtures.spd_stencil_csr(g).to_dense() @ x.ravel()).reshape(g, g)
    r0, r1 = cs.bands(g, width)[band]
    assert r1 - r0 == width
    ref = cs.band_reference(x[max(r0 - 1, 0):min(r1 + 1, g)], r0, r1, g)
    np.testing.assert_allclose(ref, y[r0:r1], rtol=1e-13, atol=1e-13)


def test_chip_smoke_bands_cover_both_edges():
    cs = _load_chip_smoke()
    (a0, _), (m0, m1), (_, z1) = cs.bands(20000)
    assert a0 == 0 and z1 == 20000 and m1 - m0 == cs.BAND and m0 < 10000 < m1


def test_chip_smoke_plain_operator_and_loop_kernels():
    """The script's own reference operator agrees with the registry's, and its HLO reader
    finds the kernels of a compiled CG loop."""
    cs = _load_chip_smoke()
    g = 12
    st = generate.make_stencil5(g)
    x = jnp.asarray(np.random.RandomState(0).randn(g, g))
    y = ops.get_operator("stencil5-xla", st, dtype=jnp.float64).run_device(x)
    np.testing.assert_allclose(np.asarray(cs.plain_apply(x)), np.asarray(y), rtol=1e-13,
                               atol=1e-13)
    op = ops.get_operator("stencil5", formats.Stencil5(g, None, (5.0, -1.0)),
                          dtype=jnp.float64)
    b = jax.ShapeDtypeStruct((g, g), jnp.float64)
    text = cg._build_solver(op.run_device_dot_op, None, 100, 1e-6, b, ("loop-kernels",),
                            synth_b=True).lower(op.operands).compile().as_text()
    counts = cs.loop_kernels(text)
    assert counts and all(v > 0 for v in counts.values())
    assert json.loads(json.dumps(counts)) == counts
