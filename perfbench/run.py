"""The benchmark of annonet_tpu_torch: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the CUDA devices the cell
asks for. A run builds (or loads from the checkout's build directory) the
port's kernels, makes the weights and inputs from ``--seed`` on the card,
warms up the cell's own shapes, measures for ``--seconds`` (``--trace 1``:
a traced window of the mix's ``trace_seconds`` at most), then judges what
the timed calls produced against the plain reference in
``perfbench/reference`` and prints one JSON line, the last of its standard
output: the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics and a breakdown (``--trace 1``), the device, and the numbers
compared beside their limits (also the last lines of standard error).

It exits non-zero, with no result, without enough CUDA devices, or when a
module of JAX or of the JAX package (``annonet_tpu``) is loaded once the
window has closed.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".perfbench_cache")


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(bench, name: str, seed: int, seconds: float, trace: bool, device,
             t0: float = None) -> dict:
    """One run of cell ``name`` on ``device``: the result's object (without
    ``device``) and the driver's window record."""
    import torch

    from perfbench.lib.trace import traced
    from perfbench.reference import compare

    t0 = _T0 if t0 is None else t0
    cell = bench.workload(name)
    config, mix, limits = bench.config(cell["config"]), bench.mix(cell["traffic"]), bench.limits(name)
    driver = importlib.import_module(f"perfbench.drivers.{mix['driver']}")
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.empty(1, device=device)  # the allocator exists before its peak is reset
        torch.cuda.reset_peak_memory_stats(device)
    started = time.perf_counter()
    c = driver.Cell(config, mix, seed % 2**63, device)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    parts = dict(start=started - t0, **c.setup_parts)
    box: dict = {}
    if trace:
        with traced(device, box):
            w = c.window(min(seconds, mix["trace_seconds"]))
    else:
        w = c.window(seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    metrics = {}
    if not trace:
        e2e = dict(c.end_to_end(w), setup_s=setup_s)
        for m in bench.end_to_end(name):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        run = types.SimpleNamespace(config=config, mix=mix, window=w, trace=box["trace"])
        for m in bench.per_layer(name):
            value = bench.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    c.release()
    checks = compare.held(c.numbers(), limits)
    correct = compare.passed(checks)
    result = {"correct": correct, "attempted": w["calls"], "failed": 0 if correct else 1,
              "metrics": metrics, "memory_peak_bytes": peak, "setup_parts": parts}
    if trace:
        t = box["trace"]
        result["busy_s"], result["window_s"] = t.busy_s, t.window_s
        result["breakdown"] = {"device_ops": t.device_ops(), "idle_gaps": t.idle_gaps()}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = _parse(argv)
    # two fixed host cores for the process and every thread it starts (the
    # CUDA driver's, autograd's), set before torch starts any: the training
    # cell's runs spread by 1.3-1.8% unpinned and by 0.3-0.5% pinned
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cores[2:4] if len(cores) >= 4 else cores)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE, sub)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from perfbench.lib import guard, manifest

    torch.set_num_threads(len(os.sched_getaffinity(0)))

    bench = manifest.load(ROOT)
    chips = bench.workload(args.workload)["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    r = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), device)
    loaded = guard.forbidden_modules()
    if loaded:
        print(f"perfbench: JAX or the JAX package was loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
           "memory_peak_bytes": r.pop("memory_peak_bytes"), "power_limit": _power_limit()}
    if args.trace:
        dev["busy_s"], dev["window_s"] = r.pop("busy_s"), r.pop("window_s")
    checks = r.pop("checks")
    for name, seconds in r.pop("setup_parts").items():
        print(f"setup {name} {seconds:.3f} s", file=sys.stderr)
    out = {**{k: r[k] for k in ("correct", "attempted", "failed", "metrics")}, "device": dev}
    if "breakdown" in r:
        out["breakdown"] = r["breakdown"]
    out["checks"] = checks
    for key, c in checks.items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
