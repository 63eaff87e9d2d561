"""Time ``annonet_train``'s steady-state step in several checkouts of the
repo, one after another on the same device: the A/B of a change against
its parent, as ``chip_smoke.py``'s phase 12b times one checkout.

Each checkout runs ``python -m annonet_tpu_torch.cli.train`` in a
subprocess of its own (its directory first on ``PYTHONPATH``) with
phase 12b's flags: the flagship at ``--level-count 3``, batch 128 on 192²
crops, the deterministic crop stream, augmentation, no validation, on one
synthetic dataset (four 1024² detection images) written once for all
runs. ``ANNONET_TPU_STEP_TIMING=1`` makes the trainer print a
``[step i]`` line after each step; this script stamps each line with its
own clock as it arrives, and the ms per step is the time between the
lines of steps 16 and ``--steps`` (both follow a loss readback, as in
12b) over the steps between them.

    python -m annonet_tpu_torch.tools.train_step_ab --checkouts _parent . . _parent

Give the order parent, change, change, parent so that a drift of the
card over the runs shows as a difference between the two runs of one
checkout. Prints one line a run and then the card's name and power limit
(``nvidia-smi``); ``-- ARGS`` appends flags to every run.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

FLAGS = ["--level-count", "3", "-b", "128", "--deterministic-data", "-l", "-u", "-n", "2",
         "--multiplicative-brightness-change-probability", "0.5", "-o"]
FIRST = 15  # the loss readback before the timed steps (0-based step index)


def time_run(checkout: str, data: str, work: str, steps: int, extra) -> dict:
    """One annonet_train run of ``checkout``: {checkout, ms_per_step, steps,
    wall_s}; exits with the run's last lines if it fails."""
    env = dict(os.environ)
    root = str(pathlib.Path(checkout).resolve())
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env["ANNONET_TPU_STEP_TIMING"] = "1"
    env["PYTHONUNBUFFERED"] = "1"
    argv = [sys.executable, "-m", "annonet_tpu_torch.cli.train", data, *FLAGS,
            "--max-total-steps", str(steps), "--save-interval", "1000",
            "--output", os.path.join(work, "ab.dnn"),
            "--sync-file", os.path.join(work, "ab.dat"), *extra]
    for name in ("ab.dnn", "ab.dat"):
        path = os.path.join(work, name)
        if os.path.exists(path):
            os.remove(path)
    stamps, tail = {}, []
    t = time.monotonic()
    proc = subprocess.Popen(argv, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    for line in proc.stdout:
        if line.startswith("[step "):
            stamps[int(line[6:line.index("]")])] = time.monotonic()
        tail = (tail + [line.rstrip()])[-20:]
    rc = proc.wait()
    last = steps - 1
    if rc != 0 or FIRST not in stamps or last not in stamps:
        raise SystemExit(f"{checkout}: exit code {rc}, {len(stamps)} step lines:\n"
                         + "\n".join(tail))
    ms = (stamps[last] - stamps[FIRST]) * 1e3 / (last - FIRST)
    return {"checkout": checkout, "ms_per_step": ms, "steps": f"{FIRST + 2}-{last + 1}",
            "wall_s": time.monotonic() - t}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkouts", nargs="+", required=True,
                        help="repo directories, timed in this order")
    parser.add_argument("--steps", type=int, default=40)
    parser.add_argument("extra", nargs="*", help="flags added to every run (after --)")
    args = parser.parse_args(argv)
    if args.steps <= FIRST + 1:
        parser.error(f"--steps must exceed {FIRST + 1}")
    from annonet_tpu_torch.data.synthetic import write_detection_dataset

    with tempfile.TemporaryDirectory(prefix=".train_step_ab_", dir=os.getcwd()) as work:
        data = os.path.join(work, "data")
        write_detection_dataset(pathlib.Path(data), n_images=4, size=1024, seed=2)
        for checkout in args.checkouts:
            print(json.dumps(time_run(checkout, data, work, args.steps, args.extra)),
                  flush=True)
    smi = shutil.which("nvidia-smi")
    print(subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
          if smi else "nvidia-smi: not available")
    return 0


if __name__ == "__main__":
    sys.exit(main())
