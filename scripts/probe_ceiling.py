#!/usr/bin/env python
"""Measure and record this card's achievable memory bandwidth ceiling (bench.probes).

Writes results/ceiling_probe_<kind>.json — the probe artifact that ``spmv_bench
--ceiling-from`` reads for ``roofline_fraction_achievable``."""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tpusparse.bench import probes, sysinfo  # noqa: E402
from tpusparse.bench.metrics import chip_peaks  # noqa: E402
from tpusparse.dist import enable_compilation_cache  # noqa: E402


def main():
    enable_compilation_cache()
    info = sysinfo.get_system_info()
    r = probes.measure_achievable_bw()
    nominal = chip_peaks(info["device_kind"])[0]
    r.update(
        device=info,
        nominal_gbs=nominal,
        achievable_fraction_of_nominal=r["achievable_gbs"] / nominal,
    )
    kind = info["device_kind"].lower().replace(" ", "_")
    out = os.path.join("results", f"ceiling_probe_{kind}.json")
    with open(out, "w") as f:
        json.dump(r, f, indent=2)
        f.write("\n")
    print(json.dumps({k: v for k, v in r.items() if k != "device"}, indent=2))
    print(f"[INFO] written: {out}")


if __name__ == "__main__":
    main()
