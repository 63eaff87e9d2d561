"""Time the f32 conv kernels K1-K3 (``csrc/conv.cu``), K3's f32 requant
mode, f32 G1 (``csrc/gemm_conv.cu``), an f32 ``infer_arrays`` call and an
f32 ``use_pallas_conv`` one in several checkouts of the repo,
one after another on the same device: the A/B of a change to those
kernels against its parent, at the shapes of ``chip_smoke.py``'s phase 3.
A change to one kernel reads the others as its controls.

Each checkout runs in a subprocess of its own (its directory first on
``PYTHONPATH``), which builds that checkout's kernels and times, with CUDA
events (mean of 5 launches after a warm-up), every conv of the
flagship net (``SegNetConfig(class_count=3, level_count=3,
base_width=16)``, random weights from seed 0; the layers of this repo's
``chip_smoke.conv_calls``) in f32 on the tile batch the inferer plans for
a 4096x4096 image (25 tiles of 872x872), then K3's f32 requant mode
(``up2x2_requant`` with the f32 weights, as an f32 artifact's int8 net
runs it) on each up layer's shape with random int8 inputs and scales,
then f32 G1 at the folded net's 7 stride-1 layers (``FoldedSegNet``'s
weights, on random inputs of each layer's folded shape, with the table
that checkout's own ``g1_block_table`` builds), then the host wall of 5
f32 ``infer_arrays`` calls on a random 4096x4096 image after a warm-up,
and of 5 such calls of ``TiledInferer(use_pallas_conv=True)``.
Only the public wrappers of ``annonet_tpu_torch.ops.conv`` and
``ops.gemm_conv``, ``FoldedSegNet`` and ``TiledInferer`` are used, so any
checkout whose folded net builds its G1 tables runs.

    python -m annonet_tpu_torch.tools.conv_f32_ab --checkouts _ab/parent . . _ab/parent

Give the order parent, change, change, parent so that a drift of the card
over the runs shows as a difference between the two runs of one checkout.
Prints one JSON line a run (per-layer ms, the K1, K2, K3, K3-requant and
G1 sums, the walls)
and then the card's name and power limit (``nvidia-smi``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys

REPS = 5
# the child: argv[1] is the JSON list of (kernel, layer, x shape, x2
# channels, weight key), argv[2] the reps
CHILD = r"""
import json, sys, time
import numpy as np, torch
from annonet_tpu_torch.infer.core import TiledInferer
from annonet_tpu_torch.models.folded_runtime import FoldedSegNet, folding_supported
from annonet_tpu_torch.models.segnet import (SegNetConfig, init_runtime_params,
                                             runtime_params_from_numpy)
from annonet_tpu_torch.ops import conv, gemm_conv

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
calls, reps = json.loads(sys.argv[1]), int(sys.argv[2])
device = torch.device("cuda", 0)
config = SegNetConfig(class_count=3, level_count=3, base_width=16, compute_dtype="float32")
params_np = init_runtime_params(config, 0)
params = runtime_params_from_numpy(params_np, config, device)
gen = torch.Generator(device=device)
gen.manual_seed(0)
layers, sums = {}, {}


def timed(name, layer, fn):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    layers[layer] = start.elapsed_time(end) / reps
    sums[name] = sums.get(name, 0.0) + layers[layer]


for kernel, layer, shape, c2, key in calls:
    w, b = params[key + "/w"], params[key + "/b"]
    x = torch.rand(shape, generator=gen, device=device)
    extra = {"x2": torch.rand(shape[:3] + [c2], generator=gen, device=device)} if c2 else {}
    fn = getattr(conv, kernel)
    timed(kernel, layer, lambda: fn(x, w, b, **extra))
    del x, extra
    if kernel != "up2x2_bias_relu":
        continue
    cin, cout = w.shape[2], w.shape[3]
    x = torch.randint(0, 128, shape, generator=gen, device=device, dtype=torch.int8)
    s_in = torch.rand(cin, generator=gen, device=device) * 0.02 + 0.01
    scale = torch.rand(cout, generator=gen, device=device) * 20.0 + 10.0
    offset = torch.rand(cout, generator=gen, device=device) * 30.0 - 9.0
    timed("up2x2_requant", layer + " requant",
          lambda: conv.up2x2_requant(x, s_in, w, scale, offset))
    del x
# f32 G1 at the folded net's stride-1 layers: x [n, h, w / fold, fold * cin]
side = calls[0][2][1]
net = FoldedSegNet(params_np, config, folding_supported(config, side), device=device)
shapes = {layer: (shape, c2) for _kernel, layer, shape, c2, _key in calls}
for kind, name, f in net.entries:
    if not kind.startswith("s1p:"):
        continue
    (n, h, w, c1), c2 = shapes[name]
    mats = [net.param(name, k) for k in ("wc", "wl", "wr")]
    b = net.param(name, "b")
    table = gemm_conv.g1_block_table(*mats)
    x = torch.rand((n, h, w // f, f * (c1 + c2)), generator=gen, device=device)
    timed("conv3x3_gemm_aligned", name + " G1",
          lambda: gemm_conv.conv3x3_gemm_aligned(x, *mats, b, f, c1 + c2, table))
    del x
del net
torch.cuda.empty_cache()
image = np.random.default_rng(0).integers(0, 256, (4096, 4096, 3), dtype=np.uint8)
gains = np.zeros(3, np.float32)
levels = np.asarray([0.0, 0.5, 0.0], np.float32)
walls = {}
for label, pallas in (("default", False), ("use_pallas_conv", True)):
    inferer = TiledInferer(params_np, config, device=device, use_pallas_conv=pallas)
    inferer.infer_arrays(image, gains, levels)
    walls[label] = []
    for _ in range(reps):
        t = time.monotonic()
        inferer.infer_arrays(image, gains, levels)
        walls[label].append((time.monotonic() - t) * 1e3)
    del inferer
print(json.dumps({"layers_ms": layers, "k1_ms": sums["conv3x3_bias_relu"],
                  "k2_ms": sums["conv3x3_s2_bias_relu"], "k3_ms": sums["up2x2_bias_relu"],
                  "k3_requant_ms": sums["up2x2_requant"], "g1_ms": sums["conv3x3_gemm_aligned"],
                  "f32_infer_arrays_ms": sum(walls["default"]) / reps,
                  "walls_ms": walls["default"],
                  "f32_pallas_infer_arrays_ms": sum(walls["use_pallas_conv"]) / reps,
                  "pallas_walls_ms": walls["use_pallas_conv"]}))
"""


def conv_calls() -> list:
    """``chip_smoke.conv_calls`` of this repo: the flagship's convs on the
    inferer's tile batch of a 4096x4096 image."""
    root = pathlib.Path(__file__).resolve().parents[2]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    config = chip_smoke.flagship_config()
    plan = chip_smoke.canvas_plan(config)
    return chip_smoke.conv_calls(config, plan.tile_count, plan.tile_height)


def time_checkout(checkout: str, calls: list) -> dict:
    env = dict(os.environ)
    root = str(pathlib.Path(checkout).resolve())
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", CHILD, json.dumps(calls), str(REPS)],
                          cwd=root, env=env, capture_output=True, text=True, timeout=1200)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise SystemExit(f"{checkout}: exit code {proc.returncode}\n{proc.stdout[-3000:]}"
                         f"\n{proc.stderr[-3000:]}")
    return {"checkout": checkout, **json.loads(lines[-1])}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkouts", nargs="+", required=True,
                        help="repo directories, timed in this order")
    args = parser.parse_args(argv)
    calls = conv_calls()
    for checkout in args.checkouts:
        print(json.dumps(time_checkout(checkout, calls)), flush=True)
    smi = shutil.which("nvidia-smi")
    print(subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
          if smi else "nvidia-smi: not available")
    return 0


if __name__ == "__main__":
    sys.exit(main())
