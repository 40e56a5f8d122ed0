"""Device/system provenance for benchmark exports.

Parity with the reference's gpu_detection.cu: cudaGetDeviceProperties + driver/runtime versions
(:76-108), /proc/cpuinfo CPU model (:9-33), sysconf RAM (:35-39), and the nvidia-smi popen fields
(:41-74): the card's name, power limit and draw, clocks and temperature.  A card below its
maximum power limit runs slower under load, so every number is recorded beside them.
"""

from __future__ import annotations

import os
import platform
import subprocess
from typing import Any, Dict, List, Optional

NVIDIA_SMI_FIELDS = ("name", "power.limit", "power.draw", "clocks.sm", "clocks.max.sm",
                     "clocks.mem", "temperature.gpu")


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown"


def _ram_gb() -> float:
    try:
        page = os.sysconf("SC_PAGE_SIZE")
        pages = os.sysconf("SC_PHYS_PAGES")
        return page * pages / 1e9
    except (ValueError, OSError):
        return 0.0


def parse_nvidia_smi(text: str) -> List[Dict[str, str]]:
    """One dict per card from ``nvidia-smi --query-gpu=<NVIDIA_SMI_FIELDS>
    --format=csv,noheader`` output (values keep their units, e.g. "700.00 W")."""
    cards = []
    for line in text.strip().splitlines():
        values = [v.strip() for v in line.split(",")]
        if len(values) == len(NVIDIA_SMI_FIELDS):
            cards.append(dict(zip(NVIDIA_SMI_FIELDS, values)))
    return cards


def query_nvidia_smi(command: str = "nvidia-smi") -> Optional[List[Dict[str, str]]]:
    """The cards' state as nvidia-smi reports it, or None where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            [command, f"--query-gpu={','.join(NVIDIA_SMI_FIELDS)}",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return parse_nvidia_smi(out)


def get_system_info() -> Dict[str, Any]:
    import jax

    dev = jax.devices()[0]
    info: Dict[str, Any] = {
        "device_kind": getattr(dev, "device_kind", str(dev)),
        "platform": dev.platform,
        "num_devices": jax.device_count(),
        "num_local_devices": jax.local_device_count(),
        "num_processes": jax.process_count(),
        "jax_version": jax.__version__,
        "backend": jax.default_backend(),
        "x64_enabled": bool(jax.config.jax_enable_x64),
        "cpu_model": _cpu_model(),
        "ram_gb": round(_ram_gb(), 1),
        "hostname": platform.node(),
        "python": platform.python_version(),
    }
    try:
        import jaxlib

        info["jaxlib_version"] = jaxlib.__version__
    except Exception:
        pass
    if dev.platform == "gpu":
        info["nvidia_smi"] = query_nvidia_smi()
    stats = dev.memory_stats()
    if stats:
        info["device_bytes_limit"] = stats.get("bytes_limit")
    from .metrics import CHIP_SPECS

    peak_bw, peak_flops = CHIP_SPECS.get(info["device_kind"], (None, None))
    info["peak_hbm_gbs"] = peak_bw
    info["peak_f32_gflops"] = peak_flops
    return info
