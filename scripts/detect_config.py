#!/usr/bin/env python
"""Environment / problem-size detection — the reference's scripts/setup/detect_gpu_config.sh
analog (max matrix size from VRAM x safety factor).

Prints the device inventory and the largest stencil grid whose CG solve fits one device,
per mode and dtype.  The bytes per grid point are not assumed: each solve is compiled at a
small grid on the device at hand and its ``memory_analysis()`` (arguments + outputs +
temporaries) is divided by the grid's points; the solve's footprint is linear in them.

    python scripts/detect_config.py [--probe-grid 1024] [--safety 0.9]
"""

from __future__ import annotations

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

CASES = (("stencil5", "f64"), ("stencil5", "f32"), ("stencil5-bf16c", "f32"),
         ("stencil5-const", "f32"), ("stencil5-const", "f64"))


def solve_bytes_per_point(mode: str, dtype, g: int) -> float:
    """Device bytes per grid point of the compiled CG solve (b = ones synthesized)."""
    import jax

    from tpusparse import ops
    from tpusparse.formats import Stencil5
    from tpusparse.solvers import cg

    op = ops.get_operator(mode, Stencil5(grid_size=g, planes=None, constant=(5.0, -1.0)),
                          dtype=dtype)
    b = jax.ShapeDtypeStruct((g, g), dtype)
    solve = cg._build_solver(op.run_device_dot_op, None, 1000, 1e-6, b, ("detect", mode),
                             synth_b=True)
    m = solve.lower(op.operands).compile().memory_analysis()
    total = m.argument_size_in_bytes + m.output_size_in_bytes + m.temp_size_in_bytes
    return total / (g * g)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--probe-grid", type=int, default=1024)
    ap.add_argument("--safety", type=float, default=0.9)
    args = ap.parse_args()
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from tpusparse import native
    from tpusparse.bench import sysinfo

    info = sysinfo.get_system_info()
    print(f"device:      {info['device_kind']} x{info['num_devices']} "
          f"({info['num_processes']} process(es))")
    for card in info.get("nvidia_smi") or []:
        print(f"card:        {card['name']}, power limit {card['power.limit']}")
    print(f"jax:         {info['jax_version']} (backend={info['backend']})")
    limit = info.get("device_bytes_limit")
    print(f"device mem:  {limit / 1e9:.1f} GB usable per device" if limit else
          "device mem:  not reported by this backend")
    for mode, dt in CASES:
        bpp = solve_bytes_per_point(mode, {"f32": jnp.float32, "f64": jnp.float64}[dt],
                                    args.probe_grid)
        line = f"CG {mode:15s} {dt}: {bpp:5.1f} B/pt (memory_analysis at {args.probe_grid}²)"
        if limit:
            g = math.isqrt(int(limit * args.safety / bpp))
            line += f" -> max grid {g:,}² on one device"
        print(line)
    print(f"native io:   {'built' if native.available() else 'numpy fallback'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
