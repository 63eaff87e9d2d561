"""Sweep and bisect Q1, the int8 3x3 stride-1 conv + requant, against an
exact reference on the device.

The port's counterpart of the JAX package's ``scripts/repro_mosaic_s1.py``,
which hunts a hardware-vs-interpreter divergence of the TPU kernel:

    python -m annonet_tpu_torch.tools.repro_qconv_s1 --stage sweep [--signed]
    python -m annonet_tpu_torch.tools.repro_qconv_s1 --stage bisect [--signed] [--cfg n h w c]

It runs on the CUDA device (``ANNONET_TPU_TORCH_DEVICE=cpu`` runs it on the
CPU, where every wrapper takes its plain version, so it can only report 0).

* ``sweep`` runs Q1 (``ops/qconv.py::qconv3x3_requant``) on the script's
  shapes, read as NHWC ``(n, h, w, c)`` with ``cout = c``, against its exact
  plain version (float64 sums, the FMA requant): the function the script's
  ``xla_ref`` computes. Inputs come from numpy's ``default_rng(0)`` as the
  script's ``make_inputs`` makes them (activations in [0, 127], or
  [-127, 127] with ``--signed``). The script's ``rows`` and ``flatten`` are
  the TPU kernel's block knobs and have no counterpart here, so its
  configurations are deduplicated without them. On the CPU only those with
  ``n * h <= 128`` run, as the script does off the TPU. Exits 1 when any
  configuration mismatches.
* ``bisect`` runs Q1's accumulator mode (``qconv3x3_acc``: the int32 sums
  before the requant) against the exact int32 conv, then the whole of Q1
  against its plain version, and prints ``VERDICT: accumulator``,
  ``epilogue`` or ``none``. Exits 1 unless the verdict is ``none``.

Mismatches are counted on the device and read back as scalars; on a
mismatch the first 16 bad ``(flat_nh, w)`` positions are printed.

The script's ``composed`` and ``prefix`` stages compare arms of the
``ANNONET_TPU_MOSAIC_*`` switches, TPU-only knobs that the port does not
have: the tool refuses them with exit code 2.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from annonet_tpu_torch.cli.common import resolve_device
from annonet_tpu_torch.ops import qconv

# scripts/repro_mosaic_s1.py's sweep configurations (n, h, wb, c) without
# their rows and flatten, duplicates dropped, in the script's order
CONFIGS: Tuple[Tuple[int, int, int, int], ...] = (
    (1, 8, 128, 128),
    (1, 64, 128, 128),
    (2, 64, 128, 128),
    (1, 872, 128, 128),
    (25, 872, 128, 128),
    (4, 109, 128, 128),
    (1, 436, 128, 256),
    (1, 436, 64, 128),
    (1, 218, 32, 128),
    (1, 218, 32, 256),
    (1, 109, 16, 256),
    (4, 64, 16, 128),
    (4, 64, 8, 128),
    (1, 436, 54, 128),
    (1, 218, 27, 128),
)
#: the script's bisect default
BISECT_DEFAULT = (1, 64, 128, 128)
#: off the card only configurations with n * h at most this run
CPU_MAX_NH = 128
UNPORTED_STAGES = ("composed", "prefix")


def make_inputs(rng, n, h, w, c, cout=None, signed=False):
    """Q1's arguments as numpy arrays, drawn as the script draws them."""
    cout = cout or c
    # post-requant activations are [0, 127]; signed covers the stem case
    lo = -127 if signed else 0
    x = rng.integers(lo, 128, size=(n, h, w, c), dtype=np.int64).astype(np.int8)
    wq = rng.integers(-127, 128, size=(3, 3, c, cout), dtype=np.int64).astype(np.int8)
    scale = (rng.uniform(0.5, 2.0, size=cout) * 1e-3).astype(np.float32)
    offset = rng.uniform(0.0, 1.0, size=cout).astype(np.float32) + 0.5
    return x, wq, scale, offset


def configs_for(device: torch.device) -> List[Tuple[int, int, int, int]]:
    if device.type == "cuda":
        return list(CONFIGS)
    return [cfg for cfg in CONFIGS if cfg[0] * cfg[1] <= CPU_MAX_NH]


def _tensors(device, *arrays):
    return [torch.from_numpy(a).to(device) for a in arrays]


def _mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    return int((got != want).sum().item())


def _first_bad(got: torch.Tensor, want: torch.Tensor, out: Callable) -> None:
    """Print the first 16 (flat_nh, w) positions where any channel differs."""
    n, h, w = got.shape[:3]
    bad = (got != want).any(dim=-1).reshape(n * h, w).nonzero()[:16].cpu().numpy()
    out(f"  first bad (flat_nh, w): {bad[:, 0].tolist()} {bad[:, 1].tolist()}")


def _tag(cfg) -> str:
    n, h, w, c = cfg
    return f"n{n} h{h} w{w} c{c}"


def run_sweep(device: torch.device, signed: bool = False,
              configs: Optional[Sequence] = None, out: Callable = print):
    """Q1 against its exact plain version on each configuration; returns the
    failures as (tag, mismatches, cfg)."""
    rng = np.random.default_rng(0)
    failures = []
    for cfg in configs_for(device) if configs is None else configs:
        x, wq, scale, offset = _tensors(device, *make_inputs(rng, *cfg, signed=signed))
        got = qconv.qconv3x3_requant(x, wq, scale, offset)
        want = qconv.qconv3x3_requant_plain(x, wq, scale, offset)
        mism = _mismatches(got, want)
        out(f"  {_tag(cfg)}: mismatches = {mism}")
        if mism:
            _first_bad(got, want, out)
            failures.append((_tag(cfg), mism, tuple(cfg)))
        del x, wq, got, want
    return failures


def bisect(device: torch.device, cfg, signed: bool = False, out: Callable = print) -> str:
    """Localise a divergence of Q1 on one configuration: "accumulator" when
    the int32 sums differ from the exact conv, else "epilogue" when the
    requantized output differs, else "none"."""
    rng = np.random.default_rng(0)
    x, wq, scale, offset = _tensors(device, *make_inputs(rng, *cfg, signed=signed))
    acc = qconv.qconv3x3_acc(x, wq)
    acc_ref = qconv.qconv3x3_acc_plain(x, wq)
    mism = _mismatches(acc, acc_ref)
    out(f"  accumulator mismatches = {mism}")
    if mism:
        _first_bad(acc, acc_ref, out)
        return "accumulator"
    del acc, acc_ref
    got = qconv.qconv3x3_requant(x, wq, scale, offset)
    want = qconv.qconv3x3_requant_plain(x, wq, scale, offset)
    mism = _mismatches(got, want)
    out(f"  full-kernel mismatches = {mism}")
    return "epilogue" if mism else "none"


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m annonet_tpu_torch.tools.repro_qconv_s1",
        description="Sweep and bisect the int8 3x3 stride-1 conv (Q1) against "
        "an exact reference on the device.",
    )
    ap.add_argument("--stage", default="sweep",
                    choices=["sweep", "bisect", *UNPORTED_STAGES])
    ap.add_argument("--signed", action="store_true",
                    help="activations in [-127, 127] (the stem) instead of [0, 127]")
    ap.add_argument("--cfg", type=int, nargs=4, default=None,
                    metavar=("N", "H", "W", "C"), help="bisect: the shape (cout = C)")
    args = ap.parse_args(argv)
    if args.stage in UNPORTED_STAGES:
        print(f"--stage {args.stage} is not ported: it compares arms of the "
              "ANNONET_TPU_MOSAIC_* switches, TPU-only knobs that "
              "annonet_tpu_torch does not have", file=sys.stderr)
        return 2
    try:
        device = resolve_device()
    except (RuntimeError, ValueError) as exc:
        print(exc, file=sys.stderr)
        return 2
    print(f"device = {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""),
          flush=True)
    out = lambda line: print(line, flush=True)  # noqa: E731
    if args.stage == "sweep":
        failures = run_sweep(device, args.signed, out=out)
        print("FAILURES:", failures, flush=True)
        return 1 if failures else 0
    cfg = tuple(args.cfg) if args.cfg else BISECT_DEFAULT
    verdict = bisect(device, cfg, args.signed, out=out)
    print("VERDICT:", verdict, flush=True)
    return 0 if verdict == "none" else 1


if __name__ == "__main__":
    sys.exit(main())
