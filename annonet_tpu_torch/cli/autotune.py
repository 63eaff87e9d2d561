"""annonet_autotune on the port: find the largest trainable minibatch,
then train (the counterpart of ``annonet_tpu/cli/autotune.py``, the Python
port of the reference's find_max_mini-batch_size.cmd).

Exponential growth then binary search over -b, where each probe is a
3-step ``annonet_train`` run (``--max-total-steps 3``) in a subprocess:
a nonzero exit code (a CUDA out-of-memory error ends annonet_train with 1
in its setup or 2 in its loop; any other crash too) shrinks the window.
After the search the real run is launched with the size found, and
relaunched with one less on each failure (the .cmd's
:DECREASE_MINIBATCH_SIZE loop). Every other argument passes through to
annonet_train; ``--start N`` (default 100) is the first size probed.

``--coordinator`` is refused, as in the JAX package (probes are
single-host by nature), and so is ``--mesh`` until annonet_train trains
data-parallel (ROADMAP.md queue 1 item 6): every probe would be refused
and the search would end in "no minibatch size works".
"""

from __future__ import annotations

import subprocess
import sys

_TRAIN = "annonet_tpu_torch.cli.train"


def probe(minibatch_size: int, passthrough_args) -> bool:
    """One 3-step trial run; True iff it exits cleanly (the :TEST block of
    find_max_mini-batch_size.cmd)."""
    cmd = [sys.executable, "-m", _TRAIN, "--max-total-steps", "3",
           "-b", str(minibatch_size), *passthrough_args]
    result = subprocess.run(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    return result.returncode == 0


def find_max_minibatch_size(passthrough_args, start: int = 100,
                            max_size: int = 100000) -> int:
    """Exponential-then-binary search for the largest passing -b."""
    size = start
    largest_pass = 0
    smallest_fail = None
    # grow while passing
    while size <= max_size:
        print(f"probing minibatch size {size}...", flush=True)
        if probe(size, passthrough_args):
            largest_pass = size
            size *= 2
        else:
            smallest_fail = size
            break
    if largest_pass == 0:
        # shrink below the start until something passes
        size = start // 2
        while size >= 1:
            print(f"probing minibatch size {size}...", flush=True)
            if probe(size, passthrough_args):
                largest_pass = size
                break
            smallest_fail = size
            size //= 2
        if largest_pass == 0:
            raise RuntimeError("no minibatch size works, not even 1")
    if smallest_fail is None:
        return largest_pass
    # binary search in (largest_pass, smallest_fail)
    lo, hi = largest_pass, smallest_fail
    while hi - lo > 1:
        mid = (lo + hi) // 2
        print(f"probing minibatch size {mid}...", flush=True)
        if probe(mid, passthrough_args):
            lo = mid
        else:
            hi = mid
    return lo


def _given(argv, flag: str) -> bool:
    return any(a == flag or a.startswith(flag + "=") for a in argv)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    wants_help = "--help" in argv or "-h" in argv
    if not argv or wants_help:
        # every other flag passes through to annonet_train, so --help and -h
        # are answered here: forwarded, every probe would print help, exit 0
        # and "pass"
        print("usage: annonet_autotune [--start N] <annonet_train args...>")
        print()
        print("Finds the largest trainable minibatch size (-b) by binary")
        print("search on 3-step probe runs, then launches the real training")
        print("run with it, decrementing by 1 on later failures. All other")
        print("arguments pass through to annonet_train (--help below):")
        print()
        from annonet_tpu_torch.cli.train import build_parser

        build_parser().print_help()
        return 0 if wants_help else 1
    if _given(argv, "--coordinator"):
        # a probe subprocess would wait forever for peer processes that
        # never run probes (each host's autotuner only launches its own)
        print(
            "annonet_autotune cannot drive multi-host training "
            "(--coordinator): probes are single-host by nature. Autotune "
            "WITHOUT --coordinator on one host, then pass the found -b "
            "to your multi-host annonet_train launch.",
            file=sys.stderr,
        )
        return 2
    if _given(argv, "--mesh"):
        print(
            "annonet_autotune: --mesh is not ported to annonet_tpu_torch yet: "
            "annonet_train refuses it until data-parallel training is ported "
            "(ROADMAP.md queue 1 item 6), so every probe would fail",
            file=sys.stderr,
        )
        return 2
    start = 100
    if "--start" in argv:
        i = argv.index("--start")
        start = int(argv[i + 1])
        del argv[i : i + 2]

    best = find_max_minibatch_size(argv, start=start)
    print(f"max working minibatch size: {best}")

    # the actual run, decrementing on later failures (:ACTUAL_RUN)
    while best >= 1:
        print(f"launching the real run with -b {best}", flush=True)
        result = subprocess.run([sys.executable, "-m", _TRAIN, "-b", str(best), *argv])
        if result.returncode == 0:
            return 0
        best -= 1
        print(f"run failed; retrying with -b {best}", flush=True)
    return 1


if __name__ == "__main__":
    sys.exit(main())
