"""Readings of the numbers that decide ``correct``, seed by seed, for setting
their limits: the program as the cell runs it, its control, and a planted
fault, at the cell's own size, in one process.

    python3 perfbench/control.py --workload <cell> --mode <mode> --seconds <s> --seeds 1 2 3

Modes: ``program`` (the timed path as a run drives it), ``fp8_reference``
(the control: the reference in the program's place, in float8 as
``reference/segnet.py``'s ``fp8`` rounds it), ``half_batch`` (each step on
the first half of its crops, the mean over them). Each seed's set-up, a
window of ``--seconds`` and the comparison are a run's own; one JSON line
per seed, with the numbers, the leaf that sets each worst-leaf number,
every leaf's readings and every batch norm layer's. The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("program", "fp8_reference", "half_batch")


def readings(bench, workload: str, mode: str, seeds, seconds: float, device, mix_changes=None):
    """Yield (seed, window, numbers, leaves, batch norm layers) of each seed."""
    import torch

    from perfbench.reference.segnet import fp8

    cell = bench.workload(workload)
    config, mix = bench.config(cell["config"]), bench.mix(cell["traffic"])
    mix.update(mix_changes or {})
    driver = importlib.import_module(f"perfbench.drivers.{mix['driver']}")
    for seed in seeds:
        c = driver.Cell(config, mix, seed, device, half_batch=mode == "half_batch")
        w = c.window(seconds)
        c.release()
        if mode == "fp8_reference":
            c.program = c.reference_steps(fp8)
        yield seed, w, c.numbers(), c.leaves(), c.bn_layers()
        del c
        if device.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", choices=MODES, default="program")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from perfbench.lib import manifest

    if not torch.cuda.is_available():
        print("perfbench: no CUDA device", file=sys.stderr)
        return 2
    bench = manifest.load(ROOT)
    device = torch.device("cuda", 0)
    for seed, w, numbers, leaves, layers in readings(bench, args.workload, args.mode,
                                                      args.seeds, args.seconds, device):
        worst = {key: max(leaves, key=lambda leaf: leaves[leaf][key])
                 for key in ("grad_gap", "change_gap", "grad_diff")}
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "calls": w["calls"], "numbers": numbers, "worst_leaf": worst,
                          "leaves": leaves, "bn_layers": layers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
