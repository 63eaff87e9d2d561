#!/usr/bin/env python3
"""Smoke run of annonet_tpu_torch on one NVIDIA GPU: the port's main path.

    python3 chip_smoke.py

Phases (any failure raises, and the exit code is then nonzero):

  1. device   needs CUDA; prints the card's name and power limit
  2. build    compiles the hand-written kernels (csrc/*.cu) with nvcc, one
              compiler process per source, in parallel; then reads the
              library's SASS (cuobjdump): the bf16 K1/K2 kernels
              (igemm_kernel), both modes of bf16 K3 (upgemm_kernel) and
              bf16 G1 (gemm_conv_bf16) must hold tensor-core instructions
              (HMMA or HGMMA), every Q1 kernel of both modes, every Q2
              kernel (q1_igemm_kernel<stride, ...>) and Q3's
              (qup_igemm_kernel) int8 ones (IMMA); no kernel of the
              library may hold __dp4a, and no bf16 instantiation of the
              f32 direct convolutions (conv3x3, up2x2) may exist; prints
              those kernels' registers, stack, local and static shared
              memory
  3. kernels  every kernel against its plain PyTorch version at the main
              path's shapes, with its bound (the larger of its bytes at the
              HBM rate and its operations at the tensor-core peak) and,
              where one PyTorch call computes the same function, that
              call's time (cuDNN F.conv2d / conv_transpose2d with bias):
              each conv layer of the flagship net
              (SegNetConfig(class_count=3, level_count=3, base_width=16),
              widths 16/32/64/128) on the tile batch that the inferer
              plans for a 4096x4096 image (25 tiles of 872x872), in bf16,
              plus the f32 kernels on one tile; the blend epilogue on the 4096x4096 canvas with
              K=3, with and without detection and under the reference
              blend semantics, and on two stress lists (random tiles that
              form no grid; 200 small tiles at nearly one position, more
              than K4 lists at a time). Then the int8 kernels on the same
              batch, with weights from quantize_net and calibration from
              one flagship forward, each layer fed the int8 net's own
              activations: Q1 and its accumulator mode (the int32 sums,
              bit-identical) on the 8 stride-1 layers, Q2 on the 3
              stride-2 ones, K3's requant mode and Q3 (with its weights
              packed once, as the int8 net passes them) on the 3 up layers;
              and the bf16 blend on the canvas (detection, the argmax
              fold, the normalised argmax) and on the two stress lists.
              Then G1 on the 7 stride-1 layers that the folded net
              (use_pallas_conv) runs at folds above 1, on the folded net's own activations of the 25-tile
              batch in bf16 and of one tile in f32, beside the three
              cuBLAS GEMMs of the same shapes; G1's bound counts the
              products over its table of nonzero weight blocks (the
              dense GEMM's beside it). Times come from CUDA events.
  4. accuracy the tiled inferer on the card against the same inferer on
              the CPU (plain versions) on a small image
  5. main     writes a random-weight flagship artifact (init_runtime_params,
              seed 0) and a synthetic anno dataset (4096x4096 and
              2300x1500 images with palette masks), runs annonet_infer
              in-process with -d 1:0.5 (seeds and blob veto; the threaded
              pipeline with its defaults), checks the result PNGs and the
              confusion matrices, and that every kernel was launched
              during that run
  6. int8     annonet_infer --quantize int8 -d 1:0.5 --calibration-images 2
              --save-calibration, then again with --calibration, so both
              images run int8:
              Q1, Q2, K3's requant mode and K4 launched in that run, no
              plan fell back to the float net, the label maps agree with
              the float run's
  6s. serve   annonet_serve in-process (cli/serve.py behind an HTTP server
              on a thread), driven through the port's client: the float
              server (--warmup 4096x4096 -d 1:0.5 --max-batch 4) on phase
              5's artifact: the 4096x4096 image over the raw path (request
              latency p50/p99) and as a PNG, labels equal to phase 5's; the
              stages of a raw and of a PNG request as the server timed them
              (read, decode, batch wait, device section, veto, resize,
              encode and send); 32 512x512 crops from 8 client threads
              (fewer device batches than requests, each response equal to
              its own infer_arrays), images/s against a server without
              batching; /stats and /metrics; /reload to a seed-1 artifact
              (the fast swap, labels equal to a fresh inferer's); K1-K4
              launched by the HTTP requests after the warm-up. The int8
              server on phase 6's calibration file: labels equal to phase
              6's, Q1, Q2, K3-requant and K4 launched by its request,
              /calibration equal to the file. --plan-autotune on the
              2300x1500 image: the candidates' Mpx/s (CUDA events), labels
              equal to a twin pinned to the chosen plan, and the default
              plan timed in turns against JAX's count-cliff bump (3 tiles
              on an axis made 4). The kernel line's serve_launches are the
              counts of the requests
  6b. pipeline annonet_infer -d 1:0.5 on four images (phase 5's two and
              two more of the same sizes from seed 1), pipelined (the
              defaults: 2 groups in flight, os.cpu_count() reader and
              writer threads), sequential (depth 1, one reader, one
              writer) and depth 2 with one reader and one writer, in
              turns: byte-equal result PNGs, equal confusion matrices,
              K1-K4 launched in each run, the walls, whole-run Mpx/s and
              main-thread CPU times; then --profile on the two 2300x1500
              images: the torch.profiler trace parses and holds K1/K2's,
              K3's and K4's kernels, and the device's busy share over the
              traced window
  7. breakdown where the 4096x4096 image's time goes: infer_arrays's
              steady-state wall (the headline Mpx/s), its first call and
              its plan constants apart, the device stages of one call,
              and the host stages of the CLI loop; then the int8
              infer_arrays's steady state and device stages
  8. quantize_up one forward of the int8 net with int8 up layers (Q3) on
              the 25-tile batch
  9. pallas_conv TiledInferer(use_pallas_conv=True) on the 4096x4096 image
              with detection: G1 launched 7 times (and K1 once, K2 and K3
              three times each, K4 once) in one call, labels agreeing with
              the default float path's, and both paths' infer_arrays walls
              and device stages in turns
  9m. mesh    TiledInferer(mesh=...) on a virtual 2-shard mesh of the card
              (parallel.mesh.ensure_virtual_devices) against the same
              inferer unsharded, on the 4096x4096 image with detection, on
              the float, int8 (phase 6's calibration file) and
              use_pallas_conv paths: labels and seeds bit for bit, each
              layer kernel launched once per shard and K4 once per call,
              both inferers' infer_arrays walls in turns (one card gains
              nothing from the split: recorded, not claimed); then one raw
              request to annonet_serve --mesh 2 (ANNONET_TPU_VIRTUAL_MESH=1)
              equal to the unmeshed server's response. The kernel line's
              mesh_launches are those calls' counts
  9c. coordinator two annonet_infer processes on the card (--coordinator
              on a free local port, --num-processes 2, each with a
              timeout): float, the result PNGs equal to phase 5's
              single-process run's and rank 0 alone printing the cluster
              totals and matrices; then --quantize int8
              --calibration-images 1 --save-calibration, the result PNGs
              byte-equal to a single-process run on each rank's shard and
              the merged calibration the element-wise max of the two
              shards' own
 10. repro_qconv_s1 the diagnostic tool's sweep (unsigned and signed) and
              bisect at all its configurations: Q1 and its accumulator mode
              against the exact conv, no mismatch, the accumulator launched
 11. train_step one train_step_decisions step of the flagship from one
              init_state (seed 0), 4 crops of 192² from a synthetic
              dataset of four 1024x1024 images, the augmentation drawn
              once on the CPU and fed to both sides, in f32 and in bf16:
              on the card and on the CPU the pool gathers bit-identical
              crops; in f32 the losses and every updated tensor agree
              within 5e-3 (of the tensor's largest update); in bf16 the
              losses within 1e-2 relative and each updated tensor within
              5e-2 (or within the distance of the CPU's bf16 step from its
              f32 step, where bf16 is coarser)
 12. train     annonet_train in-process at the flagship's width and depth
              (--level-count 3: 192² crops), -b 128, 40 steps, the device
              image pool, -l -u -n 2 -o, brightness p 0.5, --deterministic-
              data, float validation on two 1024x1024 images every 20
              steps: exit 0, finite losses, the artifact loads into
              TiledInferer, K1-K4 launched by the validation; then resumed
              from its sync file for 10 steps with --validation-quantize
              int8: it starts at step 40, and Q1, Q2, K3-requant and K4
              are launched
 12b. train_timing annonet_train's own loop, without validation: a run
              of 40 steps with ANNONET_TPU_STEP_TIMING=1 gives ms per step
              and crops/s (its wall clock between two loss readbacks), the
              main thread's CPU time and peak device memory; a --profile
              run of 15 steps gives its trace's kernel time of the last 5
              split by stage (the trainer's ranges: gather, augment,
              weighting, conv forward, BN, loss, backward convs and the
              rest of the backward, SGD) and the device's busy share
 13. detection tools/measure_detection.run_benchmark on seed 0
              (PARITY_TARGETS.json's recipe, f32): it stops at its min LR
              and its pixel accuracy clears the pinned floor; its region
              recalls are printed against the pinned floors with those
              they fall under, and not held (the recipe's seed-to-seed
              spread straddles them, JAX's own too)
 13a. autotune annonet_autotune --start 1024 on the flagship at 192² crops
              (phase 12's dataset; --max-total-steps 3 passed through, so
              the probes and the real run take 3 steps), a process of its
              own under a timeout: each probe's size, outcome and wall, the
              largest batch and the real run's exit code; the search must
              bracket its boundary
 14. accuracy_floors tools/measure_accuracy on the card: the JAX end-to-
              end test's recipe (40 f32 steps of a level-1 width-8 net on
              16² crops of a 4-image 48x48 set, TF32 off), saved, loaded
              and tiled by the float and the int8 inferer: pixel accuracy,
              mIoU and int8 pixel accuracy held against PARITY_TARGETS.json's
              pinned floors

The last three lines are the kernel table as JSON, the card's name and
power limit, and {"ok": true, "device": {...}}. Scratch files go to a
directory under the checkout, removed at the end. Nothing of jax or of the
JAX package may be imported: the script checks sys.modules at the end.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
IMAGE_SIZES = (("a_2300x1500", 1500, 2300), ("b_4096x4096", 4096, 4096))
# the 4096x4096 canvas: the inferer plans it to 5x5 tiles of 872x872
# (default tile max 1024); the kernel phases run that plan's tile batch
CANVAS = 4096
# bf16 kernels round once after the bias; the plain versions round the conv
# sum to bf16 before the f32 bias (as the JAX net does), so the two may land
# a bf16 rounding step or two apart: hold them to 2**-6 (two bf16 steps) of
# the layer's largest output. f32 kernels only reorder f32 sums.
BF16_TOL = 2.0**-6
F32_TOL = 1e-4
SMALL_LABEL_AGREEMENT = 0.995
# int8 against float label maps of the random-weight flagship net: the JAX
# package's own int8 path agrees with its float path on 98.2-98.6% of the
# pixels of such images (CPU, 300x200 and 700x600; a random net's logits
# are near ties everywhere), and the port's int8 labels agree with the JAX
# package's int8 labels on 99.5% of them (tests/test_torch_quant.py)
INT8_LABEL_AGREEMENT = 0.97
# int8 up layers (Q3) against the bf16 ones: int8 weights in three more layers
QUANTIZE_UP_AGREEMENT = 0.95
# the folded net (G1 sums each layer in another order and rounds once, after
# the bias) against the unfolded one, on the 4096x4096 image
PALLAS_CONV_AGREEMENT = 0.995
# one NVIDIA H100 SXM: dense tensor-core peaks and the HBM rate (NVIDIA's
# data sheet), and the f32 rate outside the tensor cores
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12

_REPO = os.path.dirname(os.path.abspath(__file__))
_TPU_KERNELS = {
    "conv3x3_bias_relu": "annonet_tpu/ops/int8_conv_mosaic.py:359",
    "conv3x3_s2_bias_relu": "annonet_tpu/ops/int8_conv_mosaic.py:426",
    "up2x2_bias_relu": "annonet_tpu/ops/int8_conv_mosaic.py:485",
    "blend_argmax": "annonet_tpu/ops/pallas_blend.py:94",
    "qconv3x3_requant": "annonet_tpu/ops/int8_conv_mosaic.py:673",
    "qconv3x3_s2_requant": "annonet_tpu/ops/int8_conv_mosaic.py:222",
    "qup2x2_requant": "annonet_tpu/ops/int8_conv_mosaic.py:294",
    "conv3x3_gemm_aligned": "annonet_tpu/ops/pallas_conv.py:137",
}
# Q1's accumulator mode: the raw int32 sums of the TPU diagnostic script's
# bisect, launched by the port's counterpart of that script
_ACC_REPLACES = "scripts/repro_mosaic_s1.py:136"
_ACC_PATH = "annonet_tpu_torch/tools/repro_qconv_s1.py"
_SOURCES = {
    # bf16 (the kernel line's times); f32 stays in csrc/conv.cu
    "conv3x3_bias_relu": "annonet_tpu_torch/csrc/conv_igemm.cu",
    "conv3x3_s2_bias_relu": "annonet_tpu_torch/csrc/conv_igemm.cu",
    "up2x2_bias_relu": "annonet_tpu_torch/csrc/up_igemm.cu",
    "blend_argmax": "annonet_tpu_torch/csrc/blend.cu",
    "qconv3x3_requant": "annonet_tpu_torch/csrc/qconv_igemm.cu",
    "qconv3x3_s2_requant": "annonet_tpu_torch/csrc/qconv_igemm.cu",
    "qup2x2_requant": "annonet_tpu_torch/csrc/qup_igemm.cu",
    "conv3x3_gemm_aligned": "annonet_tpu_torch/csrc/gemm_conv.cu",
}


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def sass_functions(cuobjdump: str, library: str, what: str) -> dict:
    """{kernel name: its lines} of ``cuobjdump --dump-<what>`` on the
    library, one entry per compiled function."""
    text = subprocess.run([cuobjdump, f"--dump-{what}", library], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    functions: dict = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Function\s*:?\s*(\S+?):?\s*$", line)
        if m:
            name = m.group(1)
            functions[name] = []
        elif name is not None:
            functions[name].append(line)
    return functions


def short_name(mangled: str) -> str:
    """``igemm_kernel<1, 16>`` for the mangled name of a K1/K2 kernel,
    ``upgemm_kernel<true>`` for a bf16 K3 one, ``q1_igemm_kernel<2, 16,
    true, false>`` for a Q1 or Q2 one (stride, cout block, two-row-tap
    steps, accumulator mode), the plain name of G1's and of Q3's kernel,
    else the name as given."""
    m = re.search(r"\d+(igemm_kernel|conv3x3_f32_kernel)ILi(\d+)ELi(\d+)E", mangled)
    if m and "q1_igemm" not in mangled:
        return f"{m.group(1)}<{m.group(2)}, {m.group(3)}>"
    m = re.search(r"q1_igemm_kernelILi(\d+)ELi(\d+)ELb([01])ELb([01])E", mangled)
    if m:
        flags = ", ".join("true" if b == "1" else "false" for b in m.groups()[2:])
        return f"q1_igemm_kernel<{m.group(1)}, {m.group(2)}, {flags}>"
    for plain in ("qup_igemm_kernel", "gemm_conv_bf16"):
        if re.search(rf"\d+{plain}E", mangled):
            return plain
    m = re.search(r"\d+upgemm_kernelILb([01])E", mangled)
    return f"upgemm_kernel<{'true' if m.group(1) == '1' else 'false'}>" if m else mangled


def check_tensor_cores(library: str) -> None:
    """The bf16 K1/K2 kernels (conv_igemm.cu's igemm_kernel<stride,
    cout block>, all that annonet_conv3x3_bias_relu launches for bf16),
    bf16 K3's (up_igemm.cu's upgemm_kernel<requant>, all that
    annonet_up2x2_bias_relu and annonet_up2x2_requant launch for bf16) and
    bf16 G1's (gemm_conv.cu's gemm_conv_bf16) hold HMMA or HGMMA
    instructions; Q1's and Q2's (qconv_igemm.cu's q1_igemm_kernel<stride,
    cout block, pair, accumulator>, all that annonet_q1_igemm and
    annonet_qconv3x3_s2_requant launch) and Q3's (qup_igemm.cu's
    qup_igemm_kernel, all that annonet_qup2x2_requant launches) hold IMMA;
    no kernel of the library holds __dp4a (IDP.4A); the f32 direct
    convolutions have no bf16 instantiation.
    Prints each of those kernels' tensor-core and __dp4a instruction counts
    and resource usage (registers, stack, local memory: a spill shows as
    local memory)."""
    from annonet_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = sass_functions(cuobjdump, library, "sass")
    count = lambda name, pattern: sum(  # noqa: E731
        len(re.findall(pattern, line)) for line in sass.get(name, ()))
    hmma, imma, dp4a = r"\b(HMMA|HGMMA)\.", r"\bIMMA\.", r"\bIDP\.4A\b"
    igemm = {k for k in sass if short_name(k).startswith("igemm_kernel<")}
    if len(igemm) != 8:  # 2 strides x 4 cout blocks
        raise AssertionError(f"found {len(igemm)} bf16 K1/K2 kernels in the SASS: {sorted(igemm)}")
    upgemm = {k for k in sass if "upgemm_kernel" in k}
    if len(upgemm) != 2:  # the float and the requant mode
        raise AssertionError(f"found {len(upgemm)} bf16 K3 kernels in the SASS: {sorted(upgemm)}")
    g1 = {k for k in sass if short_name(k) == "gemm_conv_bf16"}
    if len(g1) != 1:
        raise AssertionError(f"found {len(g1)} bf16 G1 kernels in the SASS: {sorted(g1)}")
    q1 = {k for k in sass if "q1_igemm_kernel" in k}
    q2 = {k for k in q1 if short_name(k).startswith("q1_igemm_kernel<2, ")}
    # stride 1: 4 cout blocks x pair or not x requant or accumulator;
    # stride 2 (Q2): 3 cout blocks (16, 32, 64) x pair or not, requant only
    if len(q1) != 22 or len(q2) != 6:
        raise AssertionError(f"found {len(q1)} Q1/Q2 kernels, {len(q2)} of stride 2, in "
                             f"the SASS: {sorted(short_name(k) for k in q1)}")
    q3 = {k for k in sass if short_name(k) == "qup_igemm_kernel"}
    if len(q3) != 1:
        raise AssertionError(f"found {len(q3)} Q3 kernels in the SASS: {sorted(q3)}")
    stale = [k for k in sass if ("conv3x3" in k or "up2x2_kernel" in k) and "bfloat16" in k]
    if stale:
        raise AssertionError(f"a bf16 direct convolution is still compiled: {stale}")
    dp4a_kernels = {short_name(k) for k in sass if count(k, dp4a)}
    if dp4a_kernels:
        raise AssertionError(f"__dp4a in the library: {sorted(dp4a_kernels)}")
    usage = sass_functions(cuobjdump, library, "resource-usage")
    for name in sorted(k for k in usage if short_name(k) != k):
        n_hmma, n_imma, n_dp4a = count(name, hmma), count(name, imma), count(name, dp4a)
        res = " ".join(line.strip() for line in usage[name] if "REG:" in line)
        print(f"  {short_name(name):36s} HMMA/HGMMA {n_hmma:4d} IMMA {n_imma:4d} "
              f"IDP.4A {n_dp4a:4d}; {res}", flush=True)
        if (name in igemm or name in upgemm or name in g1) and n_hmma == 0:
            raise AssertionError(f"{short_name(name)} holds no HMMA or HGMMA instruction")
        if (name in q1 or name in q3) and (n_imma == 0 or n_dp4a):
            raise AssertionError(f"{short_name(name)}: {n_imma} IMMA, {n_dp4a} IDP.4A")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timed_pair(kernel, plain, reps: int):
    """(kernel ms, plain ms), measured in turns: plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(ops: float, kind: str, moved: int):
    """(ms, "bytes" or "operations"): the least time the card could take
    for ``ops`` operations at the peak rate of ``kind`` and ``moved`` bytes
    (each input read once, each output written once) at the HBM rate."""
    t_ops = ops / PEAK_OPS[kind] * 1e3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bf16_step(value: float) -> float:
    """The spacing of bf16 values at ``value`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(value)) - 7)


def tally(results: dict, name: str, err, k_ms, p_ms, lib_ms, bnd) -> None:
    """Add one layer's (or variant's) numbers to ``results[name]``: the
    largest error, summed times (library None where no call computes the
    function) and the summed bound, split by what binds each layer."""
    r = results.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                  "library_ms": 0.0, "bound_ms": 0.0,
                                  "by": {"bytes": 0.0, "operations": 0.0}})
    r["max_abs_err"] = max(r["max_abs_err"], float(err))
    r["ms"] += k_ms
    r["plain_ms"] += p_ms
    r["library_ms"] = None if lib_ms is None or r["library_ms"] is None \
        else r["library_ms"] + lib_ms
    r["bound_ms"] += bnd[0]
    r["by"][bnd[1]] += bnd[0]


def numbers(r: dict) -> dict:
    """A tally as the kernel line's keys: bound_by is what binds the
    layers that make up most of the bound."""
    return {"max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": max(r["by"], key=r["by"].get),
            "library_ms": r["library_ms"]}


def flagship_config():
    from annonet_tpu_torch.models.segnet import SegNetConfig

    return SegNetConfig(class_count=3, level_count=3, base_width=16)


def canvas_plan(config):
    """The inferer's plan of the 4096x4096 canvas (25 tiles of 872x872)."""
    from annonet_tpu_torch.infer.core import default_tiling, plan_image

    return plan_image(CANVAS, CANVAS, config, default_tiling(config))


def conv_calls(config, n: int, side: int):
    """(kernel, layer, x shape, x2 channels, weight key) of every conv the
    runtime net runs on an [n, side, side, C] tile batch, in forward order."""
    from annonet_tpu_torch.models.segnet import conv_layers

    calls = []
    for block, conv, (_kh, _kw, cin, cout) in conv_layers(config):
        key = f"{block}/{conv}"
        if block == "stem":
            calls.append(("conv3x3_bias_relu", key, (n, side, side, cin), 0, key))
            continue
        i = int(block[3:])
        if block.startswith("enc"):
            s = side >> (i - 1 if conv == "conv0" else i)
            kernel = "conv3x3_s2_bias_relu" if conv == "conv0" else "conv3x3_bias_relu"
            calls.append((kernel, key, (n, s, s, cin), 0, key))
        elif conv == "up":
            s = side >> i
            calls.append(("up2x2_bias_relu", key, (n, s, s, cin), 0, key))
        else:  # decoder conv: concat([up, skip]) as the kernel's two inputs
            s = side >> (i - 1)
            calls.append(("conv3x3_bias_relu", key, (n, s, s, cout), cin - cout, key))
    return calls


def library_conv(kernel: str, x, w, b, x2=None):
    """One cuDNN call computing the layer's function (without the ReLU) on
    the same inputs, laid out channels-last: F.conv2d with bias (on the
    concat [x, x2]; for stride 2 on the input padded (0, 1) beforehand),
    or F.conv_transpose2d with bias and the flipped kernel."""
    import torch.nn.functional as F

    cl = torch.channels_last
    if x2 is not None:
        x = torch.cat([x, x2], dim=-1)
    xn = x.permute(0, 3, 1, 2)
    bb = b.to(x.dtype)
    if kernel == "up2x2_bias_relu":
        wt = torch.flip(w, dims=(0, 1)).permute(2, 3, 0, 1).contiguous(memory_format=cl)
        return lambda: F.conv_transpose2d(xn, wt, bb, stride=2)
    wn = w.permute(3, 2, 0, 1).contiguous(memory_format=cl)
    if kernel == "conv3x3_s2_bias_relu":
        xp = F.pad(xn, (0, 1, 0, 1)).contiguous(memory_format=cl)
        return lambda: F.conv2d(xp, wn, bb, stride=2)
    return lambda: F.conv2d(xn, wn, bb, padding=1)


def conv_bound(kernel: str, x, w, b, out, x2=None, kind: str = "bf16"):
    """The bound of one conv layer: 2 * MACs (9 taps of every input
    channel per output pixel and channel; 4 outputs per input pixel for
    the up layer) and the bytes of its inputs and output."""
    taps = w.shape[0] * w.shape[1]
    cin = w.shape[2]
    pixels = (x.shape[0] * x.shape[1] * x.shape[2] if kernel.startswith("up")
              or kernel.startswith("qup") else out.shape[0] * out.shape[1] * out.shape[2])
    return bound(2.0 * pixels * taps * cin * w.shape[3], kind, nbytes(x, x2, w, b, out))


def check_convs(params, config, device, n: int, side: int, dtype, tol: float,
                reps: int, generator):
    """Each conv kernel against its plain version on the layer's shapes,
    timed beside its plain version and cuDNN's call; returns {kernel:
    tally} (see ``tally``)."""
    from annonet_tpu_torch.ops import conv as ops

    plain = {
        "conv3x3_bias_relu": ops.conv3x3_bias_relu_plain,
        "conv3x3_s2_bias_relu": ops.conv3x3_s2_bias_relu_plain,
        "up2x2_bias_relu": ops.up2x2_bias_relu_plain,
    }
    results: dict = {}
    for kernel, layer, shape, c2, key in conv_calls(config, n, side):
        w = params[key + "/w"].to(dtype)
        b = params[key + "/b"]
        lo = -0.5 if layer == "stem/conv0" else 0.0  # normalised input vs ReLU output
        x = (torch.rand(shape, generator=generator, device=device) + lo).to(dtype)
        extra = {}
        if c2:
            extra["x2"] = torch.rand(
                shape[:3] + (c2,), generator=generator, device=device
            ).to(dtype)
        fn = getattr(ops, kernel)
        got = fn(x, w, b, **extra)
        want = plain[kernel](x, w, b, **extra)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(
                f"{kernel} {layer}: kernel gives {tuple(got.shape)} {got.dtype}, "
                f"plain {tuple(want.shape)} {want.dtype}"
            )
        err = (got.float() - want.float()).abs().max().item()
        scale = max(1.0, want.float().abs().max().item())
        ok = err <= tol * scale
        bnd = conv_bound(kernel, x, w, b, got, extra.get("x2"))
        k_ms = p_ms = lib_ms = float("nan")
        if reps:
            k_ms, p_ms = timed_pair(
                lambda: fn(x, w, b, **extra), lambda: plain[kernel](x, w, b, **extra),
                reps,
            )
            lib_ms = cuda_ms(library_conv(kernel, x, w, b, extra.get("x2")), reps)
        print(
            f"  {kernel:22s} {layer:12s} x{list(shape)}"
            + (f"+{c2}" if c2 else "")
            + f" -> {list(got.shape)} {str(dtype)[6:]}: max|err| {err:.3e}"
            f" (limit {tol * scale:.3e}) kernel {k_ms:.3f} ms plain {p_ms:.3f} ms"
            f" cuDNN {lib_ms:.3f} ms bound {bnd[0]:.3f} ms ({bnd[1]})",
            flush=True,
        )
        if not ok:
            raise AssertionError(f"{kernel} {layer}: max|err| {err} > {tol * scale}")
        tally(results, kernel, err, k_ms, p_ms, lib_ms, bnd)
        del x, extra, got, want
    return results


def blend_inputs(config, device, generator):
    """The 4096x4096 canvas's plan constants and random [T, th, tw, K] logits."""
    from annonet_tpu_torch.infer.tiling import inverse_weight_sum, ramp_weights

    plan = canvas_plan(config)
    th, tw = plan.tile_height, plan.tile_width
    k = config.class_count
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    logits = torch.randn(
        (plan.tile_count, th, tw, k), generator=generator, device=device
    )
    return plan, dict(
        logits=logits,
        tile_yx=to(np.asarray(plan.tile_yx, np.int32)),
        ramp=to(ramp_weights(th, tw, plan.overlap_y, plan.overlap_x)),
        inv_wsum=to(inverse_weight_sum(plan)),
        gains=to(np.asarray([0.0, 0.1, -0.05], np.float32)),
        det_levels=to(np.asarray([0.0, 0.5, 0.2], np.float32)),
    )


def blend_bound(args, labels, seeds, extra=()):
    """K4's bound: its inputs and outputs once, against a multiply and
    an add per logit and per canvas pixel and class three more operations
    (normalise, gain, compare) at the f32 rate."""
    logits = args[0]
    pixels = labels.numel() * logits.shape[-1]
    ops = 2.0 * logits.numel() + 3.0 * pixels
    return bound(ops, "f32", nbytes(*args, *extra, labels, seeds))


def blend_stress_inputs(kind: str, device, generator):
    """Blend inputs of K=3 whose tiles form no grid: 23 random tiles of
    37x53 over a 90x150 canvas ("non-grid"), or 200 tiles of 6x9 at nearly
    one position, more than K4 lists at a time over one pixel patch
    ("overflow"). Returns (args, wsum factors)."""
    n, th, tw, hp, wp = (23, 37, 53, 90, 150) if kind == "non-grid" else (200, 6, 9, 24, 140)
    lo, span = ((0, 0), (hp - th + 1, wp - tw + 1)) if kind == "non-grid" else ((3, 60), (3, 4))
    yx = torch.stack([torch.randint(lo[i], lo[i] + span[i], (n,), generator=generator,
                                    device=device) for i in range(2)], 1).to(torch.int32)
    unit = lambda *shape: torch.rand(shape, generator=generator, device=device)  # noqa: E731
    args = (torch.randn((n, th, tw, 3), generator=generator, device=device), yx.contiguous(),
            unit(th, tw), unit(hp, wp) + 0.5, unit(3) * 0.4 - 0.2, unit(3))
    return args, (unit(hp) + 0.5, unit(wp) + 0.5)


def check_blend_stress(device, blend_dtype, modes, generator) -> None:
    """K4 against its plain version on the two stress lists of
    ``blend_stress_inputs``, in each of ``modes`` ((name, detection,
    reference_blend, fold)): labels and seeds bit-identical."""
    from annonet_tpu_torch.ops.blend import blend_argmax, blend_argmax_plain

    for kind in ("non-grid", "overflow"):
        args, factors = blend_stress_inputs(kind, device, generator)
        same = []
        for mode, detection, reference, fold in modes:
            kw = dict(with_detection=detection, reference_blend=reference,
                      blend_dtype=blend_dtype, wsum_factors=factors if fold else None)
            labels, seeds = blend_argmax(*args, **kw)
            want_labels, want_seeds = blend_argmax_plain(*args, **kw)
            torch.cuda.synchronize()
            same.append(torch.equal(labels, want_labels)
                        and (not detection or torch.equal(seeds, want_seeds)))
            if not same[-1]:
                raise AssertionError(f"blend_argmax {str(blend_dtype)[6:]} {mode} on the "
                                     f"{kind} tile list differs from its plain version")
        print(f"  blend_argmax {str(blend_dtype)[6:]} on the {kind} list ({args[1].shape[0]} "
              f"tiles of {args[2].shape[0]}x{args[2].shape[1]} on {args[3].shape[0]}x"
              f"{args[3].shape[1]}): bit-identical to plain in "
              f"{', '.join(m[0] for m in modes)}: {all(same)}", flush=True)


def check_blend(config, device, reps: int, generator):
    """K4 against its plain version on the 4096x4096 canvas, then on the
    two stress lists: labels and seeds bit-identical. Returns the tally of
    the canvas's detection variant (the one the main path runs)."""
    from annonet_tpu_torch.ops.blend import blend_argmax, blend_argmax_plain

    plan, a = blend_inputs(config, device, generator)
    print(f"  blend plan: {plan.tile_count} tiles of {plan.tile_height}x"
          f"{plan.tile_width}, canvas {plan.padded_height}x{plan.padded_width},"
          f" overlap {plan.overlap_y}", flush=True)
    timing: dict = {}
    for detection, reference in ((True, False), (False, False), (True, True)):
        kw = dict(with_detection=detection, reference_blend=reference)
        args = (a["logits"], a["tile_yx"], a["ramp"], a["inv_wsum"], a["gains"],
                a["det_levels"])
        labels, seeds = blend_argmax(*args, **kw)
        want_labels, want_seeds = blend_argmax_plain(*args, **kw)
        torch.cuda.synchronize()
        same = torch.equal(labels, want_labels) and (
            (seeds is None and want_seeds is None)
            or (seeds is not None and want_seeds is not None
                and torch.equal(seeds, want_seeds))
        )
        err = (labels.int() - want_labels.int()).abs().max().item()
        k_ms = p_ms = float("nan")
        if reps:
            k_ms, p_ms = timed_pair(
                lambda: blend_argmax(*args, **kw),
                lambda: blend_argmax_plain(*args, **kw), reps,
            )
        counts = torch.bincount(labels.flatten().long(), minlength=3).tolist()
        n_seeds = None if seeds is None else int(seeds.sum().item())
        print(f"  blend_argmax detection={detection} reference_blend={reference}: "
              f"labels {list(labels.shape)} {labels.dtype} class counts {counts}, "
              f"seeds {n_seeds}; bit-identical to plain: {same}; kernel "
              f"{k_ms:.3f} ms plain {p_ms:.3f} ms", flush=True)
        if not same:
            raise AssertionError(
                f"blend_argmax (detection={detection}, reference_blend="
                f"{reference}) differs from its plain version"
            )
        if detection and not reference:
            tally(timing, "blend_argmax", err, k_ms, p_ms, None,
                  blend_bound(args, labels, seeds))
    check_blend_stress(device, torch.float32, (("detection", True, False, False),
                                               ("no detection", False, False, False),
                                               ("reference_blend", True, True, False)),
                       generator)
    return timing["blend_argmax"]


def int8_setup(params_np, config, device, generator, n: int, side: int):
    """Calibration from one flagship forward (4 tiles of a random image),
    the int8 net (bf16 up layers) and its quantize_up twin, and each int8
    layer's inputs on an [n, side, side] tile batch from one forward of the
    int8 net: {layer: (x,) or (x, skip)}."""
    from annonet_tpu_torch.models.quantized import (
        QuantizedSegNet, collect_calibration, quantize_input, quantize_net,
    )
    from annonet_tpu_torch.models.segnet import RuntimeSegNet

    tiles = torch.randint(0, 256, (n, side, side, config.in_channels),
                          generator=generator, device=device, dtype=torch.uint8)
    calibration = collect_calibration(
        RuntimeSegNet(params_np, config, device=device), tiles[:4])
    qp = quantize_net(params_np, config, calibration)
    qp_up = quantize_net(params_np, config, calibration, quantize_up=True)
    net = QuantizedSegNet(qp, config, device=device)
    x_q = quantize_input(tiles)
    outs = {}
    with torch.inference_mode():
        net(x_q, tap=lambda name, a: outs.__setitem__(name, a))
    inputs = {"stem/conv0": (x_q,), "stem/conv1": (outs["stem/conv0"],)}
    prev, skips = "stem/conv1", ["stem/conv1"]
    for i in range(1, config.level_count + 1):
        inputs[f"enc{i}/conv0"] = (outs[prev],)
        inputs[f"enc{i}/conv1"] = (outs[f"enc{i}/conv0"],)
        prev = f"enc{i}/conv1"
        if i < config.level_count:
            skips.append(prev)
    for i in range(config.level_count, 0, -1):
        inputs[f"dec{i}/up"] = (outs[prev],)
        inputs[f"dec{i}/conv0"] = (outs[f"dec{i}/up"], outs[skips.pop()])
        prev = f"dec{i}/conv0"
    return calibration, qp, qp_up, x_q, inputs


def check_int8_kernels(config, device, qp, qp_up, inputs, reps: int):
    """Q1, its accumulator mode, Q2, Q3 (bit-identical) and K3's requant
    mode (within one requant step) against their plain versions on each
    layer's real inputs (the accumulator's bound counts its int32 output);
    returns {kernel: tally} (no PyTorch call computes an int8 conv with a
    requant, so no library time) and the share of K3-requant outputs that
    differ from the plain version's."""
    from annonet_tpu_torch.models.segnet import conv_layers
    from annonet_tpu_torch.ops import conv, qconv

    to = lambda e: {k: torch.from_numpy(v).to(device).contiguous()  # noqa: E731
                    for k, v in e.items()}
    results: dict = {}
    differing = [0, 0]
    for block, name, _shape in conv_layers(config):
        layer = f"{block}/{name}"
        xs = inputs[layer]
        if name == "up":
            e, eu = to(qp[layer]), to(qp_up[layer])
            w = e["w"].to(torch.bfloat16)
            packed_up = qconv.pack_q3_weights(eu["w_q"])  # once, as the int8 net packs it
            cases = [
                ("up2x2_requant",
                 lambda: conv.up2x2_requant(xs[0], e["s_in"], w, e["scale"], e["offset"]),
                 lambda: conv.up2x2_requant_plain(xs[0], e["s_in"], w, e["scale"], e["offset"]),
                 w, (e["s_in"], e["scale"], e["offset"]), "bf16"),
                ("qup2x2_requant",
                 lambda: qconv.qup2x2_requant(xs[0], eu["w_q"], eu["scale"], eu["offset"],
                                              packed=packed_up),
                 lambda: qconv.qup2x2_requant_plain(xs[0], eu["w_q"], eu["scale"], eu["offset"]),
                 eu["w_q"], (eu["scale"], eu["offset"]), "int8"),
            ]
        else:
            e = to(qp[layer])
            args = (e["w_q"], e["scale"], e["offset"])
            extra = {"x2": xs[1]} if len(xs) > 1 else {}
            kernel = "qconv3x3_s2_requant" if (block.startswith("enc") and name == "conv0") \
                else "qconv3x3_requant"
            fn, plain = getattr(qconv, kernel), getattr(qconv, kernel + "_plain")
            # Q1 and Q2 get their packed weights as the int8 net passes them
            packed = {"packed": qconv.pack_q1_weights(e["w_q"])}
            cases = [(kernel, lambda: fn(xs[0], *args, **extra, **packed),
                      lambda: plain(xs[0], *args, **extra), e["w_q"],
                      (e["scale"], e["offset"]), "int8")]
            if kernel == "qconv3x3_requant":  # and its accumulator mode
                cases.append(("qconv3x3_acc",
                              lambda: qconv.qconv3x3_acc(xs[0], e["w_q"], **extra, **packed),
                              lambda: qconv.qconv3x3_acc_plain(xs[0], e["w_q"], **extra),
                              e["w_q"], (), "int8"))
        for kernel, run, run_plain, w_k, vectors, kind in cases:
            got, want = run(), run_plain()
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"{kernel} {layer}: {tuple(got.shape)} {got.dtype} vs "
                                     f"{tuple(want.shape)} {want.dtype}")
            d = (got.int() - want.int()).abs()
            err = d.max().item()
            share = (d > 0).float().mean().item()
            k_ms = p_ms = float("nan")
            if reps:
                k_ms, p_ms = timed_pair(run, run_plain, reps)
            bnd = conv_bound(kernel, xs[0], w_k, None, got, xs[1] if len(xs) > 1 else None,
                             kind)
            bnd = (bnd[0] + nbytes(*vectors) / HBM_BYTES_PER_S * 1e3, bnd[1])
            print(f"  {kernel:20s} {layer:12s} x{list(xs[0].shape)}"
                  + (f"+{xs[1].shape[-1]}" if len(xs) > 1 else "")
                  + f" -> {list(got.shape)}: max|err| {err} (share differing {share:.2e})"
                  f" kernel {k_ms:.3f} ms plain {p_ms:.3f} ms bound {bnd[0]:.3f} ms"
                  f" ({bnd[1]})", flush=True)
            limit = 1 if kernel == "up2x2_requant" else 0
            if err > limit:
                raise AssertionError(f"{kernel} {layer}: max|err| {err} > {limit}")
            if kernel == "up2x2_requant":
                differing[0] += int((d > 0).sum().item())
                differing[1] += d.numel()
            tally(results, kernel, err, k_ms, p_ms, None, bnd)
            del got, want, d
    share = differing[0] / max(1, differing[1])
    print(f"  up2x2_requant: {differing[0]} of {differing[1]} outputs ({share:.3e}) one "
          f"requant step from the plain version", flush=True)
    return results, share


def check_blend_bf16(config, device, reps: int, generator):
    """K4 in bf16 on the 4096x4096 canvas against its plain version: with
    detection (normalised), without detection with the argmax fold and
    normalised; then on the two stress lists; labels and seeds
    bit-identical. Returns {variant: tally} of the canvas."""
    from annonet_tpu_torch.infer.tiling import weight_sum_factors
    from annonet_tpu_torch.ops.blend import blend_argmax, blend_argmax_plain

    plan, a = blend_inputs(config, device, generator)
    factors = tuple(torch.from_numpy(f).to(device) for f in weight_sum_factors(plan))
    args = (a["logits"], a["tile_yx"], a["ramp"], a["inv_wsum"], a["gains"], a["det_levels"])
    timings = {}
    for variant, detection, fold in (("detection", True, False), ("fold", False, True),
                                     ("normalised", False, False)):
        kw = dict(with_detection=detection, reference_blend=False,
                  blend_dtype=torch.bfloat16, wsum_factors=factors if fold else None)
        labels, seeds = blend_argmax(*args, **kw)
        want_labels, want_seeds = blend_argmax_plain(*args, **kw)
        torch.cuda.synchronize()
        same = torch.equal(labels, want_labels) and (
            not detection or torch.equal(seeds, want_seeds))
        err = (labels.int() - want_labels.int()).abs().max().item()
        k_ms = p_ms = float("nan")
        if reps:
            k_ms, p_ms = timed_pair(lambda: blend_argmax(*args, **kw),
                                    lambda: blend_argmax_plain(*args, **kw), reps)
        tally(timings, variant, err, k_ms, p_ms, None,
              blend_bound(args, labels, seeds, factors if fold else ()))
        counts = torch.bincount(labels.flatten().long(), minlength=3).tolist()
        print(f"  blend_argmax bf16 {variant}: class counts {counts}, seeds "
              f"{None if seeds is None else int(seeds.sum().item())}; bit-identical to "
              f"plain: {same}; kernel {k_ms:.3f} ms plain {p_ms:.3f} ms", flush=True)
        if not same:
            raise AssertionError(f"bf16 blend_argmax ({variant}) differs from its plain version")
    check_blend_stress(device, torch.bfloat16, (("detection", True, False, False),
                                                ("fold", False, False, True),
                                                ("normalised", False, False, False)),
                       generator)
    return timings


def g1_calls(net, tiles):
    """[(layer, G1's arguments)] of one forward of the folded net: its
    calls of conv3x3_gemm_aligned, recorded as the net makes them."""
    from annonet_tpu_torch.models import folded_runtime

    calls = []
    launch = folded_runtime.conv3x3_gemm_aligned
    folded_runtime.conv3x3_gemm_aligned = lambda *args: calls.append(args) or launch(*args)
    try:
        with torch.inference_mode():
            net(tiles)
    finally:
        folded_runtime.conv3x3_gemm_aligned = launch
    names = [name for kind, name, _f in net.entries if kind.startswith("s1p:")]
    if len(names) != len(calls):
        raise AssertionError(f"the folded net made {len(calls)} G1 calls for {names}")
    return list(zip(names, calls))


def check_g1(params_np, config, device, n: int, side: int, reps: int, generator):
    """G1 against its plain version on each layer's own input from one
    forward of the folded net (use_pallas_conv) on an [n, side, side]
    batch: bf16 within one bf16 step at the layer's largest output (both
    sum in f32 and round once), f32 within F32_TOL of the scale. Timed
    beside its plain version, cuDNN's F.conv2d with bias on the NHWC view
    with the unfolded weight (the same function), and the three cuBLAS
    GEMMs of G1's dense shapes. The bf16 bound counts the products over
    the layer's table of nonzero weight blocks (what these weights need;
    the f32 kernel is dense). Returns {"conv3x3_gemm_aligned": tally}."""
    from annonet_tpu_torch.models.folded_runtime import FoldedSegNet, folding_supported
    from annonet_tpu_torch.ops import gemm_conv

    fold0 = folding_supported(config, side)
    net = FoldedSegNet(params_np, config, fold0, device=device)
    tiles = torch.randint(0, 256, (n, side, side, config.in_channels),
                          generator=generator, device=device, dtype=torch.uint8)
    bf16 = net.dtype == torch.bfloat16
    results: dict = {}
    for name, args in g1_calls(net, tiles):
        xf, wc, wl, wr, b, f, cin, table = args
        run = lambda: gemm_conv.conv3x3_gemm_aligned(*args)  # noqa: E731
        run_plain = lambda: gemm_conv.conv3x3_gemm_aligned_plain(*args)  # noqa: E731
        got, want = run(), run_plain()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"G1 {name}: {tuple(got.shape)} {got.dtype} vs "
                                 f"{tuple(want.shape)} {want.dtype}")
        err = (got.float() - want.float()).abs().max().item()
        top = want.float().abs().max().item()
        limit = bf16_step(top) if bf16 else F32_TOL * max(1.0, top)
        k1, nc = xf.shape[3], wc.shape[1]
        rows = xf.numel() // k1
        gemm_ops = 2.0 * rows * nc * 9 * k1
        table_ops = 2.0 * rows * gemm_conv.table_macs(table, k1, nc)
        bnd = bound(table_ops if bf16 else gemm_ops, "bf16" if bf16 else "f32",
                    nbytes(xf, wc, wl, wr, b, table, got))
        k_ms = p_ms = lib_ms = gemm_ms = float("nan")
        if reps:
            k_ms, p_ms = timed_pair(run, run_plain, reps)
            nb, h, wb, _ = xf.shape
            c = cin // 2 if name.startswith("dec") else cin
            parts = [xf[..., i * f * c : (i + 1) * f * c].reshape(nb, h, wb * f, c)
                     for i in range(cin // c)]  # the decoder's [up, skip], unfolded
            block, conv = name.split("/")
            w = params_np[block][conv]["w"]
            w = torch.from_numpy(np.ascontiguousarray(w)).to(device, xf.dtype)
            lib_ms = cuda_ms(library_conv("conv3x3_bias_relu", parts[0], w, b,
                                          parts[1] if len(parts) > 1 else None), reps)
            del parts
            a = torch.randn((rows, 3 * k1), generator=generator, device=device).to(xf.dtype)
            gemm_ms = cuda_ms(lambda: [torch.matmul(a, m) for m in (wc, wl, wr)], reps)
            del a
        print(f"  conv3x3_gemm_aligned {name:12s} x{list(xf.shape)} fold {f} cin {cin} -> "
              f"{list(got.shape)} {str(xf.dtype)[6:]}: max|err| {err:.3e} (limit {limit:.3e}) "
              f"G1 {k_ms:.3f} ms plain {p_ms:.3f} ms cuDNN conv {lib_ms:.3f} ms cuBLAS 3 GEMMs "
              f"{gemm_ms:.3f} ms; dense GEMM {gemm_ops / 1e12:.4f} TFLOP, over the table "
              f"{table_ops / 1e12:.4f} (conv's {gemm_ops / f / 1e12:.4f}), bound "
              f"{bnd[0]:.3f} ms ({bnd[1]})", flush=True)
        if not err <= limit:
            raise AssertionError(f"G1 {name}: max|err| {err} > {limit}")
        tally(results, "conv3x3_gemm_aligned", err, k_ms, p_ms, lib_ms, bnd)
        del got, want
    return results


def check_small_image(params_np, config, device):
    """Tiled inference on the card against the same inferer on the CPU
    (plain versions): f32 logits of one tile within 1e-3, and bf16 label
    maps agreeing on >= 99.5% of pixels."""
    from annonet_tpu_torch.infer.core import TiledInferer
    from annonet_tpu_torch.infer.tiling import TilingParameters
    from annonet_tpu_torch.models.segnet import required_input_dimension

    rng = np.random.default_rng(SEED)
    image = rng.integers(0, 256, (300, 420, 3), dtype=np.uint8)
    ov = required_input_dimension(config)
    tiling = TilingParameters(256, 256, ov, ov)

    f32 = dataclasses.replace(config, compute_dtype="float32")
    tile = torch.from_numpy(image[None, :256, :256].copy())
    logits = [
        TiledInferer(params_np, f32, tiling, device=d).net(tile.to(d)).cpu()
        for d in (device, "cpu")
    ]
    err = (logits[0] - logits[1]).abs().max().item()
    print(f"  f32 net, one 256x256 tile, card vs CPU: max|logit err| {err:.3e}",
          flush=True)
    if not err <= 1e-3:
        raise AssertionError(f"f32 net logits differ by {err} > 1e-3")

    labels = [
        TiledInferer(params_np, config, tiling, device=d).infer_arrays(
            image, [0.0, 0.1, 0.0], [0.0, 0.5, 0.2]
        )
        for d in (device, "cpu")
    ]
    agree = float((labels[0][0] == labels[1][0]).mean())
    seeds_agree = float((labels[0][1] == labels[1][1]).mean())
    print(f"  bf16 tiled inference 300x420, card vs CPU: labels agree on "
          f"{agree:.5f}, seeds on {seeds_agree:.5f}", flush=True)
    if agree < SMALL_LABEL_AGREEMENT or seeds_agree < SMALL_LABEL_AGREEMENT:
        raise AssertionError(
            f"card and CPU label maps agree on {agree} / seeds on {seeds_agree}"
            f" < {SMALL_LABEL_AGREEMENT}"
        )


def write_dataset(root: str, sizes, anno_classes, seed: int) -> None:
    """Images of three-class rectangles with mild noise, and masks that
    label every fourth band of 64 rows (the rest is ignore, as in a sparse
    annotation)."""
    from PIL import Image

    from annonet_tpu_torch.data import RGBA_IGNORE

    rng = np.random.default_rng(seed)
    colours = np.array([[40, 120, 40], [200, 200, 40], [220, 30, 30]], np.int16)
    palette = np.array([c.rgba_label for c in anno_classes], np.uint8)
    for name, h, w in sizes:
        labels = np.zeros((h, w), np.uint8)
        for _ in range(max(4, h * w // 200_000)):
            y, x = rng.integers(0, h - 64), rng.integers(0, w - 64)
            rh, rw = rng.integers(16, 256, size=2)
            labels[y : y + rh, x : x + rw] = rng.integers(1, 3)
        noise = rng.integers(-12, 13, size=(h, w, 3), dtype=np.int16)
        image = np.clip(colours[labels] + noise, 0, 255).astype(np.uint8)
        mask = palette[labels]
        ignore = (np.arange(h) // 64) % 4 != 0
        mask[ignore] = RGBA_IGNORE
        path = os.path.join(root, name + ".png")
        Image.fromarray(image).save(path, compress_level=1)
        Image.fromarray(mask, mode="RGBA").save(path + "_mask.png", compress_level=1)


def run_cli(argv, cli=None) -> int:
    """annonet_infer's (or ``cli``'s) main(argv) in this process, then this
    thread's priority back where it was: the CLIs lower their own
    (set_low_priority, os.nice(10)), and the phases after them are timed at
    the priority of those before."""
    if cli is None:
        from annonet_tpu_torch.cli import infer as cli

    before = os.getpriority(os.PRIO_PROCESS, 0)
    try:
        return cli.main(argv)
    finally:
        try:
            os.setpriority(os.PRIO_PROCESS, 0, before)
        except PermissionError:
            print(f"  (no permission to restore nice {before}: the later phases run at "
                  f"nice {os.getpriority(os.PRIO_PROCESS, 0)})", file=sys.stderr, flush=True)


def run_main_path(work: str, config, seed: int, sizes, device_note: str):
    """Artifact + dataset + annonet_infer -d 1:0.5 in-process; returns
    (launch counts during the CLI run, per-image report, printed output)."""
    from annonet_tpu_torch import serialization
    from annonet_tpu_torch.data import anno_classes_to_json, default_anno_classes
    from annonet_tpu_torch.models.segnet import init_runtime_params

    anno_classes = default_anno_classes()
    model = os.path.join(work, "annonet.dnn")
    serialization.save_model(
        model, init_runtime_params(config, seed), config,
        anno_classes_to_json(anno_classes), 1.0,
    )
    data = os.path.join(work, "data")
    os.makedirs(data)
    t = time.monotonic()
    write_dataset(data, sizes, anno_classes, seed)
    print(f"  dataset written in {time.monotonic() - t:.1f} s", flush=True)

    wrappers = float_wrappers()
    report = os.path.join(work, "report.json")
    argv = [data, "--model", model, "-d", "1:0.5", "--report-json", report]
    out = io.StringIO()
    for fn in wrappers.values():
        fn.launches = 0
    t = time.monotonic()
    with contextlib.redirect_stdout(out):
        rc = run_cli(argv)
    wall = time.monotonic() - t
    launches = {name: fn.launches for name, fn in wrappers.items()}
    text = out.getvalue()
    print("  | " + text.replace("\r", "\n").strip().replace("\n", "\n  | "))
    print(f"  annonet_infer on {device_note}: exit code {rc}, {wall:.2f} s wall,"
          f" launches {launches}", flush=True)
    if rc != 0:
        raise AssertionError(f"annonet_infer exited with {rc}")
    for needle in ("Confusion matrix per pixel:", "Confusion matrix per region"):
        if needle not in text:
            raise AssertionError(f"annonet_infer printed no {needle!r}")

    from PIL import Image

    colours = {tuple(c.rgba_label) for c in anno_classes}
    for name, h, w in sizes:
        with Image.open(os.path.join(data, name + ".png_result.png")) as im:
            rgba = np.asarray(im.convert("RGBA"))
        if rgba.shape != (h, w, 4):
            raise AssertionError(f"{name}_result.png is {rgba.shape}, not {(h, w, 4)}")
        found = {tuple(c) for c in np.unique(rgba.reshape(-1, 4), axis=0).tolist()}
        if not found <= colours:
            raise AssertionError(f"{name}_result.png has colours {found - colours}")
    with open(report, encoding="utf-8") as f:
        per_image = json.load(f)["per_image"]
    missing = [name for name, count in launches.items() if count <= 0]
    if missing:
        raise AssertionError(f"the main path launched no {missing}")
    return launches, per_image, text


def read_results(data: str, sizes):
    """{image name: RGBA result PNG as an array}: the label maps of a run."""
    from PIL import Image

    out = {}
    for name, _h, _w in sizes:
        with Image.open(os.path.join(data, name + ".png_result.png")) as im:
            out[name] = np.asarray(im.convert("RGBA"))
    return out


def run_int8_path(work: str, sizes, float_results):
    """annonet_infer --quantize int8 -d 1:0.5 --save-calibration, then with
    --calibration so that both images run int8. Returns (launch counts of
    the calibrated run, its per-image report, the calibration path)."""
    from annonet_tpu_torch.ops import qconv

    data, model = os.path.join(work, "data"), os.path.join(work, "annonet.dnn")
    calib = os.path.join(work, "calibration.npz")
    report = os.path.join(work, "report_int8.json")
    common = [data, "--model", model, "--quantize", "int8", "-d", "1:0.5"]

    def run(argv):
        out, err = io.StringIO(), io.StringIO()
        t = time.monotonic()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = run_cli(argv)
        text = out.getvalue()
        print("  | " + text.replace("\r", "\n").strip().replace("\n", "\n  | "))
        print(f"  exit code {rc}, {time.monotonic() - t:.2f} s wall", flush=True)
        if rc != 0:
            raise AssertionError(f"annonet_infer {' '.join(argv[1:])} exited with {rc}")
        if "does not fold" in err.getvalue():
            raise AssertionError("an int8 plan fell back to the float net: " + err.getvalue())
        return text

    # calibrated on both images, so neither is clipped beyond its range
    print("  calibrating run (--calibration-images 2 --save-calibration):", flush=True)
    if "Saved int8 calibration" not in run(common + ["--calibration-images", "2",
                                                    "--save-calibration", calib]):
        raise AssertionError("the calibrating run saved no calibration")
    wrappers = {**int8_wrappers(), "qup2x2_requant": qconv.qup2x2_requant}
    print("  calibrated run (--calibration): both images int8", flush=True)
    for fn in wrappers.values():
        fn.launches = 0
    run(common + ["--calibration", calib, "--report-json", report])
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(f"  launches in the calibrated run: {launches}", flush=True)
    images = len(sizes)
    # every image through the whole int8 stack: 8 Q1, 3 Q2, 3 up layers
    for name, per_image in (("qconv3x3_requant", 8), ("qconv3x3_s2_requant", 3),
                            ("up2x2_requant", 3), ("blend_argmax", 1)):
        if launches[name] < per_image * images:
            raise AssertionError(f"the int8 path launched {name} {launches[name]} times, "
                                 f"fewer than {per_image} per image")
    int8_results = read_results(data, sizes)
    for name, _h, _w in sizes:
        agree = float((int8_results[name] == float_results[name]).all(-1).mean())
        print(f"  {name}: int8 and float label maps agree on {agree:.5f} of pixels",
              flush=True)
        if agree < INT8_LABEL_AGREEMENT:
            raise AssertionError(f"int8 and float labels agree on {agree} < "
                                 f"{INT8_LABEL_AGREEMENT}")
    with open(report, encoding="utf-8") as f:
        per_image = json.load(f)["per_image"]
    return launches, per_image, calib


def float_wrappers():
    """{name: wrapper} of the float CLI path's kernels, K1-K4."""
    from annonet_tpu_torch.ops import blend, conv

    return {
        "conv3x3_bias_relu": conv.conv3x3_bias_relu,
        "conv3x3_s2_bias_relu": conv.conv3x3_s2_bias_relu,
        "up2x2_bias_relu": conv.up2x2_bias_relu,
        "blend_argmax": blend.blend_argmax,
    }


def int8_wrappers():
    """{name: wrapper} of the int8 path's kernels: Q1, Q2, K3-requant, K4."""
    from annonet_tpu_torch.ops import blend, conv, qconv

    return {
        "qconv3x3_requant": qconv.qconv3x3_requant,
        "qconv3x3_s2_requant": qconv.qconv3x3_s2_requant,
        "up2x2_requant": conv.up2x2_requant,
        "blend_argmax": blend.blend_argmax,
    }


def busy_share(events) -> tuple:
    """(device busy ms, traced window ms) of a Chrome trace's complete
    events: the union of the kernels', copies' and memsets' intervals, over
    the span of all complete events."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in spans
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for a, b in device:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    window = (max(float(e["ts"]) + float(e["dur"]) for e in spans)
              - min(float(e["ts"]) for e in spans))
    return busy / 1e3, window / 1e3


def pipeline_phase(work: str, sizes, seed: int) -> None:
    """annonet_infer -d 1:0.5 on four images (phase 5's two, and two more
    of the same sizes that write_dataset makes from another seed): with the
    defaults (2 groups in flight, os.cpu_count() reader and writer
    threads), sequential (--pipeline-depth 1, one reader, one writer) and
    depth 2 with one reader and one writer, in turns pipelined, sequential,
    depth 2, pipelined. Each run launches K1-K4 and gives byte-equal result
    PNGs and equal confusion matrices; prints each run's wall (run_cli,
    model load to the last PNG written), its whole-run Mpx/s and the main
    thread's CPU time (the loop's veto and confusion matrices run there:
    a wall well above it is time the main thread waited for the GIL or a
    core). Then one --profile run on the two 2300x1500 images:
    the trace parses and holds K1/K2's, K3's and K4's kernels; prints the
    device's busy share over the traced window."""
    from annonet_tpu_torch.data import default_anno_classes
    from annonet_tpu_torch.utils import TRACE_FILE

    data = os.path.join(work, "pipeline")
    os.makedirs(data)
    for name, _h, _w in sizes:
        for suffix in ("", "_mask.png"):
            shutil.copy(os.path.join(work, "data", name + ".png" + suffix), data)
    more = tuple((f"{chr(ord('c') + i)}_{w}x{h}", h, w) for i, (_n, h, w) in enumerate(sizes))
    write_dataset(data, more, default_anno_classes(), seed + 1)
    images = tuple(sizes) + more
    mpx = sum(h * w for _n, h, w in images) / 1e6
    model = os.path.join(work, "annonet.dnn")
    wrappers = float_wrappers()

    def run(directory, extra):
        out = io.StringIO()
        for fn in wrappers.values():
            fn.launches = 0
        t, cpu = time.monotonic(), time.thread_time()
        with contextlib.redirect_stdout(out):
            rc = run_cli([directory, "--model", model, "-d", "1:0.5", *extra])
        wall, cpu = time.monotonic() - t, time.thread_time() - cpu
        launches = {name: fn.launches for name, fn in wrappers.items()}
        text = out.getvalue()
        if rc != 0:
            raise AssertionError(f"annonet_infer {' '.join(extra)} exited with {rc}:\n{text}")
        missing = [name for name, count in launches.items() if count <= 0]
        if missing:
            raise AssertionError(f"annonet_infer {' '.join(extra)} launched no {missing}")
        return text, wall, cpu, launches

    one_thread = ["--full-image-reader-thread-count", "1", "--result-image-writer-thread-count", "1"]
    sequential = ["--pipeline-depth", "1", *one_thread]
    walls = {"pipelined": [], "sequential": [], "depth 2": []}
    reference = None
    for label, extra in (("pipelined", []), ("sequential", sequential), ("depth 2", one_thread),
                         ("pipelined", [])):
        text, wall, cpu, launches = run(data, extra)
        loop = float(re.search(r"processed in ([0-9.]+) seconds", text).group(1))
        pngs = {}
        for name, _h, _w in images:
            with open(os.path.join(data, name + ".png_result.png"), "rb") as f:
                pngs[name] = f.read()
        confusion = text[text.index("Confusion matrix per pixel:"):]
        if reference is None:
            reference = (pngs, confusion)
        elif (pngs, confusion) != reference:
            raise AssertionError(f"the {label} run's result PNGs or confusion matrices "
                                 "differ from the first run's")
        walls[label].append(wall)
        print(f"  {label:10s} {len(images)} images, {mpx:.2f} Mpx: {wall:.3f} s wall "
              f"({mpx / wall:.3f} Mpx/s whole run; loop {loop:.3f} s to the last readback; "
              f"main thread CPU {cpu:.3f} s); launches {launches}", flush=True)
    rates = {label: mpx / (sum(w) / len(w)) for label, w in walls.items()}
    print(f"  result PNGs byte-equal and confusion matrices equal in all four runs; "
          f"whole run pipelined {rates['pipelined']:.3f} Mpx/s (mean of 2) vs sequential "
          f"{rates['sequential']:.3f}: {rates['pipelined'] / rates['sequential']:.3f}x; "
          f"depth 2 with one reader and one writer {rates['depth 2']:.3f}", flush=True)

    small = os.path.join(work, "profiled")
    os.makedirs(small)
    for name, h, w in images:
        if (h, w) != (4096, 4096):
            for suffix in ("", "_mask.png"):
                shutil.copy(os.path.join(data, name + ".png" + suffix), small)
    trace_dir = os.path.join(work, "trace")
    _text, wall, _cpu, launches = run(small, ["--profile", trace_dir])
    path = os.path.join(trace_dir, TRACE_FILE)
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted({str(e.get("name")) for e in events if e.get("cat") == "kernel"})
    wanted = {"igemm_kernel<": "K1/K2", "upgemm_kernel": "K3", "blend_argmax_kernel": "K4"}
    absent = [label for key, label in wanted.items()
              if not any(key in k and "q1_igemm" not in k for k in kernels)]
    busy, window = busy_share(events)
    print(f"  --profile on the two 2300x1500 images: {wall:.3f} s wall, launches {launches}; "
          f"trace {os.path.getsize(path) / 1e6:.1f} MB, {len(events)} events, "
          f"{len(kernels)} kernel names; device busy {busy:.3f} ms of the {window:.3f} ms "
          f"traced window ({busy / window:.2%})", flush=True)
    if absent:
        raise AssertionError(f"the --profile trace holds no kernel of {absent}: {kernels[:20]}")


def time_infer_arrays(inferer, image, gains, levels, reps: int):
    """(steady-state walls of ``reps`` infer_arrays calls after a warm-up,
    device stage ms of one call from CUDA events around its steps)."""
    inferer.infer_arrays(image, gains, levels)
    walls = []
    for _ in range(reps):
        t = time.monotonic()
        inferer.infer_arrays(image, gains, levels)
        walls.append(time.monotonic() - t)
    h, w = image.shape[:2]
    plan = inferer.plan(h, w)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    with torch.inference_mode():
        ev[0].record()
        # as TiledInferer._infer: gains and levels to the card first
        gains_t, levels_t = (torch.from_numpy(v).to(inferer.device) for v in (gains, levels))
        qnet = inferer._int8_net(image[None], plan)
        tiles = inferer._tile_batch(image[None], plan, quantized=qnet is not None)
        ev[1].record()
        logits = inferer._forward(tiles, plan, quantized=qnet is not None)
        ev[2].record()
        del tiles
        labels, seeds = inferer._blend(logits, plan, gains_t, levels_t, True,
                                       quantized=qnet is not None)
        ev[3].record()
        labels[:, :h, :w].cpu().numpy().astype(np.int32)
        seeds[:, :h, :w].cpu().numpy()
        ev[4].record()
    ev[4].synchronize()
    return walls, [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]


def breakdown_int8(params_np, config, device, data: str, name: str, calib: str,
                   reps: int = 5):
    """The int8 infer_arrays at steady state on the 4096x4096 image, with
    the CLI's saved calibration, and its device stages."""
    from annonet_tpu_torch import serialization
    from annonet_tpu_torch.infer.core import TiledInferer

    image = read_image(data, name)
    h, w = image.shape[:2]
    inferer = TiledInferer(
        params_np, config, device=device, quantize="int8",
        calibration=serialization.load_calibration(calib, config, params_np),
    )
    gains = np.zeros(config.class_count, np.float32)
    levels = np.asarray([0.0, 0.5, 0.0], np.float32)
    walls, device_ms = time_infer_arrays(inferer, image, gains, levels, reps)
    if inferer.float_fallbacks or not inferer._quantized:
        raise AssertionError("the int8 breakdown did not run the int8 net")
    wall = sum(walls) / reps
    plan = inferer.plan(h, w)
    print(f"  {name} int8: plan {plan.tile_count} tiles of {plan.tile_height}x"
          f"{plan.tile_width}; infer_arrays steady state {wall * 1e3:.3f} ms host wall, "
          f"mean of {reps} calls after a warm-up ({h * w / 1e6 / wall:.2f} Mpx/s; calls "
          + ", ".join(f"{x * 1e3:.3f}" for x in walls) + " ms)", flush=True)
    print("  device stages of one int8 call (CUDA events):", flush=True)
    for stage, ms in zip(("gains + upload + pad + quantize + tile gather",
                          "int8 net forward (Q1, Q2, K3-requant + head)",
                          "blend epilogue (K4, bf16)", "crop + labels and seeds to host"),
                         device_ms):
        print(f"    {stage:46s} {ms:9.3f} ms", flush=True)
    return inferer, image, plan


def quantize_up_forward(params_np, config, device, inferer, image, plan):
    """One forward of the 25-tile batch through the int8 net with int8 up
    layers (Q3), against the default int8 net on the same tiles."""
    from annonet_tpu_torch.models.quantized import QuantizedSegNet, quantize_net
    from annonet_tpu_torch.ops import qconv

    calibration = inferer.export_calibration()
    net_up = QuantizedSegNet(quantize_net(params_np, config, calibration, quantize_up=True),
                             config, device=device)
    with torch.inference_mode():
        qnet = inferer._int8_net(image[None], plan)
        tiles = inferer._tile_batch(image[None], plan, quantized=True)
        qconv.qup2x2_requant.launches = 0
        logits = net_up(tiles)
        torch.cuda.synchronize()
        launches = qconv.qup2x2_requant.launches
        reference = qnet(tiles)
        agree = (logits.argmax(-1) == reference.argmax(-1)).float().mean().item()
    finite = bool(torch.isfinite(logits).all().item())
    print(f"  quantize_up forward of {list(tiles.shape)} int8 tiles: logits "
          f"{list(logits.shape)} {logits.dtype}, finite {finite}; qup2x2_requant "
          f"launches {launches}; argmax agrees with the bf16-up int8 net on {agree:.5f}",
          flush=True)
    want_shape = (plan.tile_count, plan.tile_height, plan.tile_width, config.class_count)
    if not finite or tuple(logits.shape) != want_shape or launches < config.level_count:
        raise AssertionError("the quantize_up forward failed")
    if agree < QUANTIZE_UP_AGREEMENT:
        raise AssertionError(f"quantize_up labels agree on {agree} < {QUANTIZE_UP_AGREEMENT}")
    return launches


def pallas_conv_path(params_np, config, device, data: str, name: str, reps: int = 5):
    """TiledInferer(use_pallas_conv=True) on the image ``name`` with
    detection: launch counts of one call (G1 at every s1p layer of the
    folded spec, none on the default path), labels against the default
    float path's, then both paths' infer_arrays walls and device stages.
    Returns the launch counts of the use_pallas_conv call."""
    from annonet_tpu_torch.infer.core import TiledInferer
    from annonet_tpu_torch.models.folded_runtime import folded_spec, folding_supported
    from annonet_tpu_torch.ops import blend, conv, gemm_conv

    image = read_image(data, name)
    h, w = image.shape[:2]
    default = TiledInferer(params_np, config, device=device)
    pallas = TiledInferer(params_np, config, device=device, use_pallas_conv=True)
    plan = pallas.plan(h, w)
    fold0 = folding_supported(config, plan.tile_width)
    spec = folded_spec(config, fold0)[1] if fold0 else ()
    gains = np.zeros(config.class_count, np.float32)
    levels = np.asarray([0.0, 0.5, 0.0], np.float32)
    wrappers = {
        "conv3x3_gemm_aligned": gemm_conv.conv3x3_gemm_aligned,
        "conv3x3_bias_relu": conv.conv3x3_bias_relu,
        "conv3x3_s2_bias_relu": conv.conv3x3_s2_bias_relu,
        "up2x2_bias_relu": conv.up2x2_bias_relu,
        "blend_argmax": blend.blend_argmax,
    }
    counts = {}
    for label, inferer in (("default", default), ("use_pallas_conv", pallas)):
        for fn in wrappers.values():
            fn.launches = 0
        labels, seeds = inferer.infer_arrays(image, gains, levels)
        counts[label] = {k: fn.launches for k, fn in wrappers.items()}
        counts[label + " labels"] = (labels, seeds)
    want = {
        "conv3x3_gemm_aligned": sum(k.startswith("s1p:") for k in spec),
        "conv3x3_bias_relu": sum(k == "s1_plain" for k in spec),
        "conv3x3_s2_bias_relu": config.level_count,
        "up2x2_bias_relu": config.level_count,
        "blend_argmax": 1,
    }
    print(f"  plan {plan.tile_count} tiles of {plan.tile_height}x{plan.tile_width}, base fold "
          f"{fold0}; launches in one call: use_pallas_conv {counts['use_pallas_conv']} "
          f"(expected {want}), default {counts['default']}", flush=True)
    if counts["use_pallas_conv"] != want or want["conv3x3_gemm_aligned"] != 7:
        raise AssertionError("the use_pallas_conv call did not launch G1 at its 7 layers")
    if counts["default"]["conv3x3_gemm_aligned"] != 0:
        raise AssertionError("the default float path launched G1")
    (l_d, s_d), (l_p, s_p) = counts["default labels"], counts["use_pallas_conv labels"]
    agree, seeds_agree = float((l_p == l_d).mean()), float((s_p == s_d).mean())
    print(f"  {name}: use_pallas_conv labels agree with the default float path's on "
          f"{agree:.5f} of pixels, seeds on {seeds_agree:.5f}", flush=True)
    if agree < PALLAS_CONV_AGREEMENT:
        raise AssertionError(f"use_pallas_conv labels agree on {agree} < {PALLAS_CONV_AGREEMENT}")
    stages = ("gains + upload + pad + tile gather", "net forward", "blend epilogue (K4)",
              "crop + labels and seeds to host")
    # in turns, so that the two paths share the machine's state
    for label, inferer in (("use_pallas_conv", pallas), ("default", default),
                           ("use_pallas_conv", pallas)):
        walls, device_ms = time_infer_arrays(inferer, image, gains, levels, reps)
        wall = sum(walls) / reps
        print(f"  {label:16s} infer_arrays {wall * 1e3:.3f} ms host wall, mean of {reps} "
              f"calls after a warm-up ({h * w / 1e6 / wall:.2f} Mpx/s; calls "
              + ", ".join(f"{x * 1e3:.3f}" for x in walls) + " ms); device stages (CUDA "
              "events): " + ", ".join(f"{st} {ms:.3f} ms" for st, ms in zip(stages, device_ms)),
              flush=True)
    return counts["use_pallas_conv"]


def repro_qconv_phase(device) -> int:
    """The diagnostic tool (annonet_tpu_torch/tools/repro_qconv_s1.py) on
    the card: its sweep of Q1, unsigned and signed, and its bisect (Q1's
    accumulator mode against the exact int32 conv, then Q1) at every one
    of its configurations; any mismatch fails. Returns the accumulator's
    launches in this run."""
    from annonet_tpu_torch.ops import qconv
    from annonet_tpu_torch.tools import repro_qconv_s1 as tool

    out = lambda line: print(line, flush=True)  # noqa: E731
    qconv.qconv3x3_acc.launches = 0
    for signed in (False, True):
        print(f"  sweep{' --signed' if signed else ''}:", flush=True)
        failures = tool.run_sweep(device, signed, out=out)
        torch.cuda.empty_cache()
        if failures:
            raise AssertionError(f"repro_qconv_s1 sweep (signed={signed}) failed: {failures}")
    for cfg in tool.CONFIGS:
        print(f"  bisect --cfg {' '.join(map(str, cfg))}:", flush=True)
        verdict = tool.bisect(device, cfg, out=out)
        torch.cuda.empty_cache()
        print(f"  VERDICT: {verdict}", flush=True)
        if verdict != "none":
            raise AssertionError(f"repro_qconv_s1 bisect {cfg}: {verdict}")
    launches = qconv.qconv3x3_acc.launches
    print(f"  qconv3x3_acc launches in this phase: {launches}", flush=True)
    if launches != len(tool.CONFIGS):
        raise AssertionError(f"the bisect launched the accumulator {launches} times, "
                             f"not once per configuration ({len(tool.CONFIGS)})")
    return launches


def breakdown(params_np, config, device, data: str, name: str, reps: int = 5):
    """Where one image's time goes. The headline is ``infer_arrays`` itself:
    the host wall of ``reps`` calls after a warm-up, each ending in the copy
    of its labels and seeds to the host. Beside it: the first call on a new
    inferer with the allocator's cache emptied, the build of a plan's
    constants alone, the device stages of one call (CUDA events around the
    steps of ``TiledInferer._infer``), and the host stages of the CLI loop
    around it (host clock)."""
    from annonet_tpu_torch.data import default_anno_classes
    from annonet_tpu_torch.data.codec import index_label_image_to_rgba_label_image
    from annonet_tpu_torch.data.dataset import ImageFilenames
    from annonet_tpu_torch.data.sample import read_sample, save_png_rgba
    from annonet_tpu_torch.infer.core import TiledInferer, detection_veto
    from annonet_tpu_torch.infer.evaluation import (
        new_confusion_matrix, update_confusion_matrix_per_pixel,
        update_confusion_matrix_per_region,
    )

    classes = default_anno_classes()
    path = os.path.join(data, name + ".png")
    host = {}
    t = time.monotonic()
    sample = read_sample(ImageFilenames(path, path + "_mask.png"), classes, False, 1.0)
    host["read_sample (decode image + mask)"] = time.monotonic() - t
    image = sample.input_image
    h, w = image.shape[:2]
    inferer = TiledInferer(params_np, config, device=device)
    plan = inferer.plan(h, w)
    gains = np.zeros(config.class_count, np.float32)
    levels = np.asarray([0.0, 0.5, 0.0], np.float32)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t = time.monotonic()
    labels_np, seeds_np = inferer.infer_arrays(image, gains, levels)
    cold = time.monotonic() - t
    inferer._plan_constants.clear()
    torch.cuda.synchronize()
    t = time.monotonic()
    inferer._constants(plan)
    torch.cuda.synchronize()
    constants = time.monotonic() - t
    walls = []
    for _ in range(reps):
        t = time.monotonic()
        inferer.infer_arrays(image, gains, levels)
        walls.append(time.monotonic() - t)
    wall = sum(walls) / reps

    stages = ("gains + upload + pad + tile gather", "net forward (K1-K3 + head)",
              "blend epilogue (K4)", "crop + labels and seeds to host")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
    with torch.inference_mode():
        ev[0].record()
        gains_t, levels_t = (torch.from_numpy(v).to(device) for v in (gains, levels))
        tiles = inferer._tile_batch(image[None], plan)
        ev[1].record()
        logits = inferer._forward(tiles, plan)
        ev[2].record()
        del tiles
        labels, seeds = inferer._blend(logits, plan, gains_t, levels_t, True)
        ev[3].record()
        labels[:, :h, :w].cpu().numpy().astype(np.int32)
        seeds[:, :h, :w].cpu().numpy()
        ev[4].record()
    ev[4].synchronize()
    device_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(len(stages))]
    del logits, labels, seeds

    t = time.monotonic()
    result = detection_veto(labels_np, seeds_np)
    host["detection_veto (blob labelling)"] = time.monotonic() - t
    t = time.monotonic()
    cm = new_confusion_matrix(len(classes))
    update_confusion_matrix_per_pixel(cm, sample.labeled_points_by_class, result)
    host["confusion per pixel"] = time.monotonic() - t
    t = time.monotonic()
    update_confusion_matrix_per_region(
        cm, sample.labeled_points_by_class, sample.label_image, result
    )
    host["confusion per region"] = time.monotonic() - t
    t = time.monotonic()
    save_png_rgba(os.path.join(data, "breakdown_result.png"),
                  index_label_image_to_rgba_label_image(result, classes))
    host["result PNG (encode + write)"] = time.monotonic() - t
    print(f"  {name}: plan {plan.tile_count} tiles of {plan.tile_height}x"
          f"{plan.tile_width}; infer_arrays steady state {wall * 1e3:.3f} ms "
          f"host wall, mean of {reps} calls after a warm-up "
          f"({h * w / 1e6 / wall:.2f} Mpx/s; calls "
          + ", ".join(f"{s * 1e3:.3f}" for s in walls) + " ms)", flush=True)
    print(f"  first call on a new inferer, allocator cache emptied: "
          f"{cold * 1e3:.3f} ms; the plan's constants alone: "
          f"{constants * 1e3:.3f} ms", flush=True)
    print("  device stages of one call (CUDA events):", flush=True)
    for stage, ms in zip(stages, device_ms):
        print(f"    {stage:36s} {ms:9.3f} ms", flush=True)
    print("  host stages of the CLI loop (one run):", flush=True)
    for stage, s in host.items():
        print(f"    {stage:34s} {s * 1e3:9.1f} ms", flush=True)



# --------------------------------------------------------------------------
# Serving: annonet_serve in-process, driven through the port's client
# --------------------------------------------------------------------------

# 512x512 crops of the 4096x4096 image, sent by SERVE_CLIENTS threads that
# each send SERVE_ROUNDS requests, to a server with --max-batch SERVE_BATCH
# and to one without batching
SERVE_CROP = 512
SERVE_BATCH = 4
SERVE_CLIENTS = 8
SERVE_ROUNDS = 4
# 4096x4096 requests timed one at a time (after the warm-up)
SERVE_LARGE_REQUESTS = 6
# calls timed per turn when the default plan is held against JAX's
# count-cliff bump (the autotune's own 3 calls take ~8 ms on the card)
BUMP_ITERS = 20


def start_server(argv):
    """(service, server, client): annonet_serve's service, warmed at its
    --warmup sizes, behind an HTTP server on an ephemeral port on a thread
    of this process, and the port's client of it."""
    import threading

    from annonet_tpu_torch.cli import serve
    from annonet_tpu_torch.client import ServeClient

    args = serve.build_parser().parse_args(["--port", "0", *argv])
    service = serve._ModelService(args)
    serve._warmup(service, args.warmup)
    server, _ = serve.make_server(args, service)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    host, port = server.server_address[:2]
    return service, server, ServeClient(host, port, timeout=600)


def stop_server(server) -> None:
    server.shutdown()
    server.server_close()


def percentile(values, p: float) -> float:
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(p * len(ordered)))]


def serve_load(client, crops):
    """SERVE_CLIENTS threads, each sending SERVE_ROUNDS crops in turn:
    ({(thread, round): (crop index, labels)}, wall seconds)."""
    import threading

    results, errors = {}, []

    def worker(k):
        try:
            for r in range(SERVE_ROUNDS):
                i = (k + r) % len(crops)
                results[(k, r)] = (i, client.infer(crops[i]))
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(SERVE_CLIENTS)]
    t = time.monotonic()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.monotonic() - t
    if errors:
        raise errors[0]
    if any(th.is_alive() for th in threads):
        raise AssertionError("a serving client thread did not finish in 600 s")
    return results, wall


def serve_phase(work: str, sizes, float_labels, int8_labels, calib: str, smi: str):
    """annonet_serve on the card, in this process, through the port's
    client (cli/serve.py, client.py): the float server (--warmup 4096x4096
    -d 1:0.5 --max-batch 4) on phase 5's artifact, the 4096x4096 image over
    the raw path and as a PNG (labels equal to phase 5's annonet_infer; the
    stages of each kind of request, as the server timed them), concurrent
    512x512 crops (fewer device batches than requests, each response equal
    to its own unbatched infer_arrays, images/s against a server without
    batching), /stats
    and /metrics, and /reload to a seed-1 artifact (the fast swap; labels
    equal to a fresh inferer's); K1-K4 launched by the HTTP requests after
    the warm-up. Then the int8 server on phase 6's calibration file
    (labels equal to phase 6's, Q1, Q2, K3-requant and K4 launched by its
    request, /calibration's bytes equal to the file), and --plan-autotune
    on the 2300x1500 image (the candidates' Mpx/s, labels equal to a twin
    pinned to the chosen plan, the default plan timed against JAX's
    count-cliff bump). Returns the launch counts of the float and the int8
    server's requests."""
    from PIL import Image

    from annonet_tpu_torch import serialization
    from annonet_tpu_torch.data import default_anno_classes
    from annonet_tpu_torch.infer.core import (
        _CANVAS_BUCKET, TiledInferer, _lane_align, annonet_infer, detection_veto,
    )
    from annonet_tpu_torch.infer.tiling import plan_for_counts
    from annonet_tpu_torch.models.segnet import init_runtime_params

    data = os.path.join(work, "data")
    root = os.path.join(work, "serve")
    os.makedirs(root)
    model = os.path.join(root, "annonet.dnn")
    shutil.copy(os.path.join(work, "annonet.dnn"), model)
    palette = np.array([c.rgba_label for c in default_anno_classes()], np.uint8)
    (big, big_h, big_w), (small_name, small_h, small_w) = sizes[-1], sizes[0]
    with open(os.path.join(data, big + ".png"), "rb") as f:
        big_png = f.read()
    with Image.open(io.BytesIO(big_png)) as im:
        image = np.asarray(im.convert("RGB"))
    spots = [((SERVE_CROP * i) % (big_h - SERVE_CROP + 1),
              (SERVE_CROP * 3 * i) % (big_w - SERVE_CROP + 1)) for i in range(8)]
    crops = [np.ascontiguousarray(image[y : y + SERVE_CROP, x : x + SERVE_CROP])
             for y, x in spots]
    levels = [0.0, 0.5, 0.0]

    def held(labels, expected, what):
        same = float((palette[labels] == expected).all(-1).mean())
        if same != 1.0:
            raise AssertionError(f"{what}: equal to the reference on {same:.6f} of pixels")

    def stage_line(stages):
        return ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items())

    # ---- the float server. The launch counts start once it is warm and
    # the references are made, and are read right after its last request:
    # they are the HTTP requests' own (and /reload's)
    wrappers = float_wrappers()
    t = time.monotonic()
    service, server, client = start_server(
        ["--model", model, "--warmup", f"{big_h}x{big_w}", "-d", "1:0.5", "--max-batch",
         str(SERVE_BATCH)])
    try:
        print(f"  float server up, warmed at {big_h}x{big_w}, in {time.monotonic() - t:.1f} s",
              flush=True)
        state = service.state
        expected = [detection_veto(*state.inferer.infer_arrays(c, None, levels)) for c in crops]
        for fn in wrappers.values():
            fn.launches = 0
        calls = service.batches_dispatched
        walls = []
        for _ in range(SERVE_LARGE_REQUESTS):
            t = time.monotonic()
            labels = client.infer(image)
            walls.append(time.monotonic() - t)
        raw_stages = service.last_request_stages
        held(labels, float_labels[big], f"{big} over the raw path")
        with Image.open(io.BytesIO(client.infer_png(big_png))) as im:
            if not np.array_equal(np.asarray(im.convert("RGBA")), float_labels[big]):
                raise AssertionError(f"{big} as a PNG: the result PNG differs from phase 5's")
        png_stages = service.last_request_stages
        stats = client.stats()
        print(f"  {big}, {SERVE_LARGE_REQUESTS} requests over the raw path (format=labels): "
              f"client wall p50 {percentile(walls, 0.5) * 1e3:.3f} ms, p99 "
              f"{percentile(walls, 0.99) * 1e3:.3f} ms; the server's own latency (downscale, "
              f"device, veto, resize) p50 {stats['latency_ms']['p50']} ms, p99 "
              f"{stats['latency_ms']['p99']} ms; labels and the PNG equal to phase 5's ({smi})",
              flush=True)
        print(f"  the last raw {big} request's stages, timed by the server ({smi}): "
              + stage_line(raw_stages), flush=True)
        print(f"  the PNG {big} request's stages, timed by the server ({smi}): "
              + stage_line(png_stages), flush=True)

        batches = service.batches_dispatched
        results, wall = serve_load(client, crops)
        dispatched = service.batches_dispatched - batches
        for i, labels in results.values():
            if not np.array_equal(labels, expected[i]):
                raise AssertionError(f"crop {i}: a batched response differs from infer_arrays")
        requests = len(results)
        if not dispatched < requests:
            raise AssertionError(f"{requests} concurrent requests took {dispatched} device "
                                 "batches: none was grouped")
        batched_rate = requests / wall

        metrics = client._request("GET", "/metrics")[0].decode()
        values = {line.split()[0]: float(line.split()[1])
                  for line in metrics.splitlines() if line and not line.startswith("#")}
        if values["annonet_requests_served_total"] != client.stats()["requests_served"]:
            raise AssertionError("/metrics and /stats disagree on the requests served")
        print(f"  /stats: {json.dumps(client.stats())}", flush=True)
        print(f"  /metrics: {len(values)} samples, compiled_programs "
              f"{values['annonet_compiled_programs']:.0f}", flush=True)

        params = init_runtime_params(service.config, SEED + 1)
        serialization.save_model(model, params, service.config, state.anno_classes_json, 1.0)
        t = time.monotonic()
        info = client.reload()
        print(f"  /reload to a seed-{SEED + 1} artifact in {time.monotonic() - t:.3f} s: "
              f"{json.dumps(info)}", flush=True)
        if not info["fast_swap"] or service.inferer is not state.inferer:
            raise AssertionError("the same-config reload did not take the fast swap")
        reloaded = client.infer(image)
        float_launches = {name: fn.launches for name, fn in wrappers.items()}
        device_calls = service.batches_dispatched - calls
    finally:
        stop_server(server)
    print(f"  float server launches over its {device_calls} device calls (the HTTP requests "
          f"after the warm-up): {float_launches}", flush=True)
    missing = [name for name, count in float_launches.items() if count <= 0]
    if missing:
        raise AssertionError(f"the float server's requests launched no {missing}")
    fresh = TiledInferer(params, service.config, device=service.device)
    if not np.array_equal(reloaded, annonet_infer(fresh, image, None, levels)):
        raise AssertionError("after /reload the server's labels differ from a fresh "
                             "inferer's on the new weights")
    del fresh, service, state
    torch.cuda.empty_cache()

    # the same crops on phase 5's artifact without batching
    unbatched = start_server(["--model", os.path.join(work, "annonet.dnn"), "-d", "1:0.5",
                              "--warmup", f"{SERVE_CROP}x{SERVE_CROP}"])
    try:
        unbatched_results, unbatched_wall = serve_load(unbatched[2], crops)
    finally:
        stop_server(unbatched[1])
    for i, labels in unbatched_results.values():
        if not np.array_equal(labels, expected[i]):
            raise AssertionError(f"crop {i}: an unbatched response differs from infer_arrays")
    print(f"  {requests} {SERVE_CROP}x{SERVE_CROP} requests from {SERVE_CLIENTS} client "
          f"threads: --max-batch {SERVE_BATCH} {batched_rate:.2f} images/s in {dispatched} "
          f"device batches; --max-batch 1 {requests / unbatched_wall:.2f} images/s; every "
          f"response equal to its own infer_arrays ({smi})", flush=True)
    del unbatched
    torch.cuda.empty_cache()

    # ---- the int8 server on phase 6's calibration file, counted as above
    wrappers = int8_wrappers()
    service, server, client = start_server(
        ["--model", os.path.join(work, "annonet.dnn"), "--quantize", "int8", "--calibration",
         calib, "-d", "1:0.5", "--warmup", f"{big_h}x{big_w}"])
    try:
        for fn in wrappers.values():
            fn.launches = 0
        held(client.infer(image), int8_labels[big], f"int8 {big}")
        int8_launches = {name: fn.launches for name, fn in wrappers.items()}
        with open(calib, "rb") as f:
            if client.calibration() != f.read():
                raise AssertionError("/calibration's bytes differ from the --calibration file")
        if service.inferer.float_fallbacks:
            raise AssertionError("an int8 plan fell back to the float net")
    finally:
        stop_server(server)
    print(f"  int8 server: labels equal to phase 6's, /calibration equal to the file; "
          f"launches of its one request {int8_launches}", flush=True)
    missing = [name for name, count in int8_launches.items() if count <= 0]
    if missing:
        raise AssertionError(f"the int8 server's request launched no {missing}")
    del service
    torch.cuda.empty_cache()

    # ---- --plan-autotune on the 2300x1500 image
    with Image.open(os.path.join(data, small_name + ".png")) as im:
        small = np.asarray(im.convert("RGB"))
    service, server, client = start_server(
        ["--model", os.path.join(work, "annonet.dnn"), "--plan-autotune", "-d", "1:0.5",
         "--warmup", f"{small_h}x{small_w}"])
    try:
        labels = client.infer(small)
        (key, report), = service.inferer.autotune_reports.items()
        chosen = report[0][0]
        default = TiledInferer(service.params, service.config, device=service.device)
        twin = TiledInferer(service.params, service.config, device=service.device)
        twin._plan_override = chosen
        if not np.array_equal(labels, annonet_infer(twin, small, None, levels)):
            raise AssertionError("--plan-autotune's labels differ from a twin pinned to the "
                                 "chosen plan")
        plan0 = default.plan(small_h, small_w)
        print(f"  --plan-autotune on {small_name} (canvas {key[0]}x{key[1]}; the default plan "
              f"{plan0.tile_height}x{plan0.tile_width}x{plan0.tile_count}): chose "
              f"{chosen.tile_height}x{chosen.tile_width}x{chosen.tile_count}; candidates "
              + ", ".join(f"{p.tile_height}x{p.tile_width}x{p.tile_count} "
                          f"({len({y for y, _ in p.tile_yx})}x{len({x for _, x in p.tile_yx})}"
                          f" tiles) {r:.1f} Mpx/s" for p, r in report)
              + f" (CUDA events, {os.environ.get('ANNONET_TPU_AUTOTUNE_ITERS', '3')} calls "
              f"each); labels equal to the pinned twin's ({smi})", flush=True)
        # JAX's folded inferer bumps an axis of 3 tiles to 4 (its count-cliff
        # bump); the port keeps 3 and the autotune does not time the bumped
        # plan. Time it beside the default, in turns, by the same loop
        ny, nx = (len({y for y, _ in plan0.tile_yx}), len({x for _, x in plan0.tile_yx}))
        bumped = plan_for_counts(
            small_h, small_w, service.config, default.tiling, 4 if ny == 3 else ny,
            4 if nx == 3 else nx, canvas_bucket=_CANVAS_BUCKET,
            lane_align_tiles=_lane_align(service.config))
        if bumped is None or bumped == plan0:
            raise AssertionError(f"{small_name}: the default plan has no axis of 3 tiles")
        timed = default._time_plans(small, [plan0, bumped] * 3, iters=BUMP_ITERS)
        print(f"  the default {ny}x{nx} plan against JAX's bumped "
              f"{len({y for y, _ in bumped.tile_yx})}x{len({x for _, x in bumped.tile_yx})} "
              f"({bumped.tile_height}x{bumped.tile_width}x{bumped.tile_count}) on {small_name}, "
              f"in turns: " + ", ".join(
                  f"{'default' if p == plan0 else 'bumped'} {r:.1f} Mpx/s" for r, p in timed)
              + f" (CUDA events, {BUMP_ITERS} calls each; {smi})", flush=True)
        del default, twin
    finally:
        stop_server(server)
    del service
    torch.cuda.empty_cache()
    return float_launches, int8_launches


# --------------------------------------------------------------------------
# Training: the card against the CPU, annonet_train, the detection floors
# --------------------------------------------------------------------------

# annonet_train's crop side at --level-count 3 (required 62, x3, rounded to
# a multiple of 8) and the bench's train batch
TRAIN_BATCH = 128
TRAIN_STEPS = 40
# the --profile run's steps: the last 5 are the stage table's window
PROFILE_STEPS = 15
TRAIN_SIZES = tuple((f"t{i}_1024x1024", 1024, 1024) for i in range(4))
VALIDATION_SIZES = tuple((f"v{i}_1024x1024", 1024, 1024) for i in range(2))
# one train step on the card against the same step on the CPU, from one
# state with the same draws. In f32, the loss and every updated tensor
# within 5e-3 (of that tensor's largest update on the CPU): the forward and
# backward's math, where a wrong term moves a tensor by a large part of its
# update, and summation order alone moves a BN beta's (a sum that cancels)
# by ~1e-3: on an H100 80GB HBM3 at 700 W up to 8.7e-4 at enc1's betas, and
# 2.4e-3 between the two packages' f32 steps on the CPU at level 1, width
# 8. In bf16, the training default, the loss within 1e-2
# relative and every updated tensor within 5e-2, or, where bf16 itself is
# that coarse, no further from the CPU's bf16 step than the CPU's own bf16
# step is from its f32 step (cuDNN and the CPU sum each conv in another
# order, and the bf16 roundings that follow differ: on an H100 80GB HBM3 at
# 700 W up to 5.9e-2 at enc3's BN betas, which see 2304 pixels a channel,
# where bf16 and f32 stand 0.10-0.25 apart)
TRAIN_F32_TOL = 5e-3
TRAIN_LOSS_RTOL = 1e-2
TRAIN_UPDATE_TOL = 5e-2
# the detection benchmark's seed (the first of PARITY_TARGETS.json's runs)
DETECTION_SEED = 0
# the profiler window's stages: the trainer's record_function ranges, with
# the backward's kernels split by name into the convs' and the rest's
STAGES = ("gather", "augment", "weighting", "conv_forward", "bn", "loss",
          "backward_conv", "backward_other", "sgd", "other")
_CONV_KERNEL = re.compile(r"conv|dgrad|wgrad|xmma|cudnn|implicit|cutlass|gemm", re.I)


def train_crop_dim(config) -> int:
    from annonet_tpu_torch.models.segnet import (
        recommended_input_dimension, required_input_dimension,
    )

    return recommended_input_dimension(config, int(round(3.0 * required_input_dimension(config))))


def read_samples(data: str, sizes):
    from annonet_tpu_torch.data import default_anno_classes
    from annonet_tpu_torch.data.dataset import ImageFilenames
    from annonet_tpu_torch.data.sample import read_sample

    out = []
    for name, _h, _w in sizes:
        path = os.path.join(data, name + ".png")
        out.append(read_sample(ImageFilenames(path, path + "_mask.png"),
                               default_anno_classes(), True, 1.0))
    return out


def augmentations() -> dict:
    """The CropOptions fields of the CLI phase's augmentation flags
    (-l -u -n 2 --multiplicative-brightness-change-probability 0.5 -o)."""
    return dict(allow_flip_left_right=True, allow_flip_upside_down=True,
                multiplicative_brightness_change_probability=0.5,
                noise_level_stddev=2.0, allow_random_color_offset=True)


def check_train_step(device, data: str) -> None:
    """One train_step_decisions step of the flagship from one init_state,
    4 crops of 192² (one reaching past the image's corner), on the card and
    on the CPU with the same augmentation draws (made once, on the CPU), in
    f32 and in bf16: the pool gathers bit-identical crops on both; in f32
    the losses and every updated tensor agree within TRAIN_F32_TOL; in bf16
    the losses within TRAIN_LOSS_RTOL and every updated tensor within
    TRAIN_UPDATE_TOL of its largest update, or within the distance between
    the CPU's bf16 step and its f32 step."""
    from annonet_tpu_torch.data.crop import CropOptions
    from annonet_tpu_torch.models.segnet import tree_items, tree_to_numpy
    from annonet_tpu_torch.ops.augment import draw_augmentations
    from annonet_tpu_torch.ops.crop_gather import gather_crops
    from annonet_tpu_torch.train import DeviceImagePool, Trainer, TrainerConfig

    config = flagship_config()
    dim = train_crop_dim(config)
    samples = read_samples(data, TRAIN_SIZES[:2])
    rects = [(-40, -25), (300, 200), (1024 - dim + 60, 1024 - dim + 90), (700, 10)]
    rects = [(x, y, x + dim - 1, y + dim - 1) for x, y in rects]
    crop_samples = [samples[0], samples[1], samples[0], samples[1]]
    options = CropOptions(dim=dim, **augmentations())
    gen = torch.Generator()
    gen.manual_seed(SEED)
    draws = draw_augmentations(gen, len(rects), (dim, dim, 3), options)
    sides = (("card", device), ("cpu", torch.device("cpu")))
    crops, losses, params, before = {}, {}, {}, None
    for dtype in ("float32", "bfloat16"):
        for side, d in sides:
            trainer = Trainer(dataclasses.replace(config, compute_dtype=dtype),
                              TrainerConfig(), seed=SEED, device=d)
            before = dict(tree_items(tree_to_numpy(trainer.params)))
            pool = DeviceImagePool(2, device=d)
            slots = pool.ensure(crop_samples)
            hs, ws = pool.valid_dims(slots)
            crops[side] = [t.cpu() for t in gather_crops(
                pool.images, pool.labels, torch.from_numpy(slots),
                torch.tensor([r[1] for r in rects]), torch.tensor([r[0] for r in rects]),
                torch.from_numpy(hs), torch.from_numpy(ws), dim,
                flip_lr=draws.flip_lr, flip_ud=draws.flip_ud)]
            t = time.monotonic()
            losses[dtype, side] = trainer.train_step_decisions(pool, crop_samples, rects,
                                                               options, draws=draws)
            print(f"  one {dtype} step on {d}: loss {losses[dtype, side]:.6f}, "
                  f"{time.monotonic() - t:.2f} s wall (first call)", flush=True)
            params[dtype, side] = dict(tree_items(tree_to_numpy(trainer.params)))
    same = all(torch.equal(a, b) for a, b in zip(crops["card"], crops["cpu"]))
    print(f"  pool gather of {len(rects)} crops of {dim}² (flips, past the corner): card "
          f"and CPU bit-identical: {same}", flush=True)
    if not same:
        raise AssertionError("the card's pool gather differs from the CPU's")

    def distance(dtype, a, b):
        """{tensor: max |a - b| over the largest update of the CPU's step in
        ``dtype``}"""
        out = {}
        for key, cpu in params[dtype, "cpu"].items():
            update = max(float(np.abs(cpu - before[key]).max()), 1e-30)
            out[key] = float(np.abs(params[a][key] - params[b][key]).max()) / update
        return out

    def worst(gaps, beside=None, n=4):
        keys = sorted(gaps, key=lambda k: -gaps[k])[:n]
        return ", ".join(f"{k} {gaps[k]:.3e}" + (f" ({beside[k]:.3e})" if beside else "")
                         for k in keys)

    failed = []
    f32 = distance("float32", ("float32", "card"), ("float32", "cpu"))
    f32_loss = (abs(losses["float32", "card"] - losses["float32", "cpu"])
                / abs(losses["float32", "cpu"]))
    print(f"  f32: loss gap {f32_loss:.3e} relative, largest update gaps card - CPU "
          f"{worst(f32)} (limit {TRAIN_F32_TOL})", flush=True)
    if f32_loss > TRAIN_F32_TOL:
        failed.append("the f32 loss")
    failed += [f"f32 {k}" for k, g in f32.items() if g > TRAIN_F32_TOL]
    bf16 = distance("bfloat16", ("bfloat16", "card"), ("bfloat16", "cpu"))
    cpu_coarse = distance("bfloat16", ("bfloat16", "cpu"), ("float32", "cpu"))
    card_coarse = distance("bfloat16", ("bfloat16", "card"), ("float32", "card"))
    bf16_loss = (abs(losses["bfloat16", "card"] - losses["bfloat16", "cpu"])
                 / abs(losses["bfloat16", "cpu"]))
    print(f"  bf16: loss gap {bf16_loss:.3e} relative (limit {TRAIN_LOSS_RTOL}); largest "
          f"update gaps card - CPU (limit {TRAIN_UPDATE_TOL}, or the CPU's bf16 - f32 "
          f"distance beside it): {worst(bf16, cpu_coarse)}", flush=True)
    print(f"  bf16 - f32 distance, medians: the CPU's {np.median(list(cpu_coarse.values())):.3e}"
          f", the card's {np.median(list(card_coarse.values())):.3e}; card - CPU median "
          f"{np.median(list(bf16.values())):.3e}; the card's largest: "
          f"{worst(card_coarse, cpu_coarse)}", flush=True)
    if bf16_loss > TRAIN_LOSS_RTOL:
        failed.append("the bf16 loss")
    failed += [f"bf16 {k}" for k, g in bf16.items()
               if g > max(TRAIN_UPDATE_TOL, cpu_coarse[k])]
    if failed:
        raise AssertionError(f"the card's train step disagrees with the CPU's at {failed}")


class StepStamps(io.StringIO):
    """A stdout capture that stamps each step-timing line of annonet_train
    (ANNONET_TPU_STEP_TIMING=1: "[step i] ...", printed by the thread that
    trains, after the step) with that thread's wall and CPU clocks."""

    def __init__(self):
        super().__init__()
        self.stamps = {}  # step: (monotonic s, thread CPU s, line)

    def write(self, text):
        if text.startswith("[step "):
            self.stamps[int(text[6:text.index("]")])] = (
                time.monotonic(), time.thread_time(), text.strip())
        return super().write(text)


def run_train_cli(argv, wrappers=None, env=None):
    """annonet_train's main(argv) in-process with its stdout captured (a
    StepStamps), ``env`` set around it and the ``wrappers``' launch counts
    zeroed first; prints the run's summary lines and fails on a nonzero
    exit. Returns the capture."""
    from annonet_tpu_torch.cli import train as train_cli

    wrappers = wrappers or {}
    out = StepStamps()
    for fn in wrappers.values():
        fn.launches = 0
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    t, cpu = time.monotonic(), time.thread_time()
    try:
        with contextlib.redirect_stdout(out):
            rc = run_cli(argv, train_cli)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    wall, cpu = time.monotonic() - t, time.thread_time() - cpu
    text = out.getvalue()
    shown = [line for line in text.splitlines()
             if line.startswith(("validation", "resumed", "saving", "step"))]
    if shown:
        print("  | " + "\n  | ".join(shown))
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(f"  exit code {rc}, {wall:.2f} s wall, main thread CPU {cpu:.2f} s"
          + (f"; launches {launches}" if wrappers else ""), flush=True)
    if rc != 0:
        raise AssertionError(f"annonet_train {' '.join(argv[1:])} exited with {rc}:\n{text}")
    missing = [name for name, count in launches.items() if count <= 0]
    if missing:
        raise AssertionError(f"annonet_train's validation launched no {missing}")
    return out


def train_cli_phase(work: str, data: str, validation: str, device) -> dict:
    """annonet_train at full width in-process: 40 steps at batch 128 on
    192² crops with the pool, augmentation and float validation every 20
    steps, then once more resumed from the sync file with int8 validation.
    Returns the int8 run's launch counts."""
    from annonet_tpu_torch import serialization
    from annonet_tpu_torch.infer.core import TiledInferer

    model, sync = os.path.join(work, "trained.dnn"), os.path.join(work, "sync.dat")
    metrics = os.path.join(work, "metrics.jsonl")
    common = train_argv(data) + [
        "--save-interval", "20", "--validation-directory", validation, "--output", model,
        "--sync-file", sync, "--metrics-jsonl", metrics, "--metrics-interval", "1"]
    run_train_cli(common + ["--max-total-steps", str(TRAIN_STEPS)], float_wrappers())
    with open(metrics, encoding="utf-8") as f:
        events = [json.loads(line) for line in f]
    losses = [e["loss"] for e in events if e["event"] == "loss"]
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"annonet_train recorded {len(losses)} losses: {losses}")
    print(f"  losses: first {losses[0]:.4f}, step {TRAIN_STEPS // 2} "
          f"{losses[TRAIN_STEPS // 2 - 1]:.4f}, last {losses[-1]:.4f}, all finite", flush=True)
    params, config, _classes, _ds = serialization.load_model(model)
    labels = TiledInferer(params, config, device=device).infer_arrays(
        read_samples(validation, VALIDATION_SIZES[:1])[0].input_image)[0]
    print(f"  the artifact loads into TiledInferer: {config}, label map "
          f"{labels.shape}, classes {np.unique(labels).tolist()}", flush=True)
    wrappers = int8_wrappers()
    out = run_train_cli(common + ["--max-total-steps", "10", "--validation-quantize", "int8"],
                        wrappers)
    if f"resumed from {sync} at step {TRAIN_STEPS}" not in out.getvalue():
        raise AssertionError("the second run did not resume at the saved step")
    return {name: fn.launches for name, fn in wrappers.items()}


def train_argv(data: str) -> list:
    """annonet_train's flags of the training phases: the flagship's depth,
    the bench's batch, the deterministic crop stream and the augmentation
    of augmentations()."""
    return [data, "--level-count", "3", "-b", str(TRAIN_BATCH), "--deterministic-data",
            "-l", "-u", "-n", "2", "--multiplicative-brightness-change-probability", "0.5",
            "-o"]


def stage_shares(events, t0: float, t1: float) -> dict:
    """Device ms per stage of the kernels of a Chrome trace launched
    between host times ``t0`` and ``t1`` (us): each goes to the innermost
    trainer range (record_function) open when it was launched, the
    backward's kernels by name to its convs or the rest."""
    ranges = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                     for e in events if e.get("cat") == "user_annotation"
                     and e.get("name") in STAGES + ("backward",)), key=lambda r: r[1] - r[0])
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    out = dict.fromkeys(STAGES, 0.0)
    for e in events:
        if e.get("cat") != "kernel":
            continue
        ts = launches.get(e.get("args", {}).get("correlation"))
        if ts is None or not t0 <= ts <= t1:
            continue
        stage = next((name for a, b, name in ranges if a <= ts <= b), "other")
        if stage == "backward":
            stage = "backward_conv" if _CONV_KERNEL.search(e["name"]) else "backward_other"
        out[stage] += float(e["dur"]) / 1e3
    return out


def train_timing(work: str, data: str, device) -> None:
    """annonet_train's own loop at batch 128, 192², flagship, with no
    validation and no save after step 0: a run of TRAIN_STEPS steps with
    ANNONET_TPU_STEP_TIMING=1 gives ms per step, crops/s and the main
    thread's CPU time per step between the loss readbacks of steps 16 and
    40 (each waits for the step 8 before it, so the device has done steps
    9-32 between them; loss_sync_interval 8), the pool's uploads and
    peak device memory; then --profile on a run of PROFILE_STEPS steps: its
    trace's kernels of the last 5 steps, split by stage."""
    from annonet_tpu_torch.cli.train import TRAIN_TRACE_FILE

    first, last = 15, TRAIN_STEPS - 1
    torch.cuda.reset_peak_memory_stats(device)
    out = run_train_cli(train_argv(data) + [
        "--max-total-steps", str(TRAIN_STEPS), "--save-interval", "1000",
        "--output", os.path.join(work, "timed.dnn"), "--sync-file",
        os.path.join(work, "timed.dat")], env={"ANNONET_TPU_STEP_TIMING": "1"})
    (t0, c0, _), (t1, c1, line) = out.stamps[first], out.stamps[last]
    steps = last - first
    ms = (t1 - t0) * 1e3 / steps
    dim = train_crop_dim(flagship_config())
    print(f"  steps {first + 2}-{last + 1} at batch {TRAIN_BATCH}, {dim}²: {ms:.3f} ms per "
          f"step (the CLI's wall clock between loss readbacks), {TRAIN_BATCH * 1e3 / ms:.1f} crops/s; main thread CPU {(c1 - c0) * 1e3 / steps:.3f} "
          f"ms per step; last step's line: {line!r}; peak device memory "
          f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB", flush=True)
    trace_dir = os.path.join(work, "profile")
    run_train_cli(train_argv(data) + [
        "--max-total-steps", str(PROFILE_STEPS), "--save-interval", "1000",
        "--profile", trace_dir, "--output", os.path.join(work, "profiled.dnn"),
        "--sync-file", os.path.join(work, "profiled.dat")])
    with open(os.path.join(trace_dir, TRAIN_TRACE_FILE), encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    starts = sorted(float(e["ts"]) for e in events
                    if e.get("cat") == "user_annotation" and e.get("name") == "gather")
    ends = sorted(float(e["ts"]) + float(e["dur"]) for e in events
                  if e.get("cat") == "user_annotation" and e.get("name") == "sgd")
    if len(starts) != PROFILE_STEPS or len(ends) != PROFILE_STEPS:
        raise AssertionError(f"the trace holds {len(starts)} gather and {len(ends)} sgd "
                             f"ranges for {PROFILE_STEPS} steps")
    window = 5
    t0, t1 = starts[-window], ends[-1]
    shares = stage_shares(events, t0, t1)
    total = sum(shares.values())
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") == "cuda_runtime" and t0 <= float(e["ts"]) <= t1
                and "correlation" in e.get("args", {})}
    busy, span = busy_share([
        e for e in events if e.get("ph") == "X" and "dur" in e
        and (e.get("args", {}).get("correlation") in launched
             if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
             else t0 <= float(e["ts"]) <= t1)])
    print(f"  profiler trace of the CLI, steps {PROFILE_STEPS - window + 1}-{PROFILE_STEPS}: "
          f"kernels {total / window:.3f} ms per step, device busy {busy:.3f} of {span:.3f} "
          f"ms ({busy / span:.2%}); by stage (ms per step, share):", flush=True)
    for stage in STAGES:
        print(f"    {stage:15s} {shares[stage] / window:9.3f} ms  "
              f"{shares[stage] / max(total, 1e-9):7.2%}", flush=True)


def detection_phase(device) -> None:
    """tools/measure_detection.run_benchmark on the card at seed 0: the run
    stops at its min LR and its pixel accuracy clears PARITY_TARGETS.json's
    pinned floor. Its region recalls are printed against the pinned floors
    with the floors they fall under; they are not held: seed 0 of the
    port's random stream falls one background region under its floor, and
    JAX's own recipe falls under a floor at about one seed in four on the
    CPU (PERF.md, section 6)."""
    from annonet_tpu_torch.tools import measure_detection

    recall_floor, pixel_floor = measure_detection.pinned_floors()
    t = time.monotonic()
    run = measure_detection.run_benchmark(DETECTION_SEED, device=device, verbose=False)
    missed = measure_detection.below_floors(run)
    print(f"  seed {DETECTION_SEED}: {run['steps']} steps, stopped at min LR "
          f"{run['stopped_at_min_lr']}, LR shrinks at steps "
          f"{[e['step'] for e in run['lr_shrinks']]}, loss {run['loss_first']:.4f} -> "
          f"{run['loss_last']:.4f}; region recall {run['region_recall']} (floors "
          f"{recall_floor}), pixel accuracy {run['pixel_accuracy']:.5f} (floor {pixel_floor}), "
          f"region precision {run['region_precision']}, region confusion {run['region_cm']}; "
          f"{time.monotonic() - t:.1f} s", flush=True)
    print(f"  seed {DETECTION_SEED} clears every pinned floor: {not missed}"
          + (f" (not met: {'; '.join(missed)})" if missed else ""), flush=True)
    if not run["stopped_at_min_lr"]:
        raise AssertionError("the detection run did not reach its min-LR stop")
    if run["pixel_accuracy"] < pixel_floor:
        raise AssertionError("the detection run's pixel accuracy falls under its floor")


def training_phases(device) -> dict:
    """The training slice's phases in one scratch directory; returns the
    int8 validation's launch counts."""
    from annonet_tpu_torch.data import default_anno_classes

    work = tempfile.mkdtemp(prefix=".chip_smoke_", dir=_REPO)
    try:
        data, validation = os.path.join(work, "train"), os.path.join(work, "validation")
        for path, sizes, seed in ((data, TRAIN_SIZES, SEED + 2),
                                  (validation, VALIDATION_SIZES, SEED + 3)):
            os.makedirs(path)
            write_dataset(path, sizes, default_anno_classes(), seed)
        print("[train_step] one train step of the flagship, card against CPU", flush=True)
        check_train_step(device, data)
        print(f"[train] annonet_train --level-count 3 -b {TRAIN_BATCH} --max-total-steps "
              f"{TRAIN_STEPS}, float validation, then resumed with int8 validation", flush=True)
        launches = train_cli_phase(work, data, validation, device)
        print(f"[train_timing] annonet_train's loop at batch {TRAIN_BATCH}: steady state, "
              "then the stages of a --profile run", flush=True)
        train_timing(work, data, device)
        print(f"[detection] tools/measure_detection.run_benchmark, seed {DETECTION_SEED}",
              flush=True)
        detection_phase(device)
        print(f"[autotune] annonet_autotune --start {AUTOTUNE_START} on the flagship at "
              f"{train_crop_dim(flagship_config())}² crops", flush=True)
        autotune_phase(work, data)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# multi-device inference (mesh, coordinator), annonet_autotune, accuracy

MESH_SHARDS = 2
MESH_REPS = 3
# each subprocess of the coordinator and autotune phases
SUBPROCESS_TIMEOUT = 600
# the autotune phase's first probe: the flagship at 192² fits some 1000-2000
# crops on an 80 GB card (phase 12b's peak memory is 6.1 GiB at batch 128),
# so the search grows once, fails once and bisects between them
AUTOTUNE_START = 1024


def read_image(data: str, name: str):
    """The RGB pixels of one of the smoke's images."""
    from annonet_tpu_torch.data import default_anno_classes
    from annonet_tpu_torch.data.dataset import ImageFilenames
    from annonet_tpu_torch.data.sample import read_sample

    path = os.path.join(data, name + ".png")
    return read_sample(ImageFilenames(path, path + "_mask.png"),
                       default_anno_classes(), False, 1.0).input_image


def mesh_phase(params_np, config, device, work: str, name: str, calib: str) -> dict:
    """TiledInferer on a virtual 2-shard mesh of the card against the same
    inferer unsharded, on the 4096x4096 image with detection, on the float,
    int8 (phase 6's calibration file) and use_pallas_conv paths: labels and
    seeds bit for bit, each path's launches in one sharded call (its layer
    kernels once per shard, K4 once), and the two inferers' infer_arrays
    walls in turns (recorded, not claimed: one card gains nothing from the
    split). Then one raw request to annonet_serve --mesh 2 against the
    unmeshed server's response. Returns {kernel: launches in the mesh
    calls}."""
    from annonet_tpu_torch import serialization
    from annonet_tpu_torch.infer.core import TiledInferer
    from annonet_tpu_torch.ops import gemm_conv
    from annonet_tpu_torch.parallel.mesh import VIRTUAL_MESH_ENV, ensure_virtual_devices

    image = read_image(os.path.join(work, "data"), name)
    h, w = image.shape[:2]
    gains = np.zeros(config.class_count, np.float32)
    levels = np.asarray([0.0, 0.5, 0.0], np.float32)
    calibration = serialization.load_calibration(calib, config, params_np)
    # path: (inferer options, wrappers counted, launches per shard, the
    # kernel line's entries it gives)
    paths = {
        "float": ({}, float_wrappers(), {"conv3x3_bias_relu": 8, "conv3x3_s2_bias_relu": 3,
                                         "up2x2_bias_relu": 3}, tuple(float_wrappers())),
        "int8": ({"quantize": "int8", "calibration": calibration}, int8_wrappers(),
                 {"qconv3x3_requant": 8, "qconv3x3_s2_requant": 3, "up2x2_requant": 3},
                 ("qconv3x3_requant", "qconv3x3_s2_requant")),
        "use_pallas_conv": ({"use_pallas_conv": True},
                            {**float_wrappers(), "conv3x3_gemm_aligned":
                             gemm_conv.conv3x3_gemm_aligned},
                            {"conv3x3_gemm_aligned": 7, "conv3x3_bias_relu": 1,
                             "conv3x3_s2_bias_relu": 3, "up2x2_bias_relu": 3},
                            ("conv3x3_gemm_aligned",)),
    }
    mesh_launches = {"qup2x2_requant": 0}
    for label, (kwargs, wrappers, per_shard, entries) in paths.items():
        one = TiledInferer(params_np, config, device=device, **kwargs)
        mesh = TiledInferer(params_np, config, mesh=ensure_virtual_devices(MESH_SHARDS, device),
                            **kwargs)
        want = one.infer_arrays(image, gains, levels)
        for fn in wrappers.values():
            fn.launches = 0
        got = mesh.infer_arrays(image, gains, levels)
        torch.cuda.synchronize(device)
        counts = {k: fn.launches for k, fn in wrappers.items()}
        expected = {k: MESH_SHARDS * v for k, v in per_shard.items()}
        expected["blend_argmax"] = 1
        same = (np.array_equal(got[0], want[0]), np.array_equal(got[1], want[1]))
        plan = mesh.plan(h, w)
        print(f"  {label}: {plan.tile_count} tiles split {MESH_SHARDS} ways; launches in one "
              f"sharded call {counts} (expected {expected}); labels equal {same[0]}, seeds "
              f"equal {same[1]}", flush=True)
        if counts != {k: expected.get(k, 0) for k in counts}:
            raise AssertionError(f"the {label} mesh call launched {counts}, not {expected}")
        if not all(same):
            raise AssertionError(f"the {label} mesh inferer's labels or seeds differ from "
                                 "the unsharded inferer's")
        if label == "int8" and (mesh.float_fallbacks or not mesh._quantized):
            raise AssertionError("the int8 mesh inferer did not run the int8 net")
        mesh_launches.update({k: counts[k] for k in entries})
        walls = {"unsharded": [], "mesh": []}
        for turn in ("unsharded", "mesh", "mesh", "unsharded"):
            inferer = one if turn == "unsharded" else mesh
            walls[turn] += time_infer_arrays(inferer, image, gains, levels, MESH_REPS)[0]
        print("  " + "; ".join(
            f"{turn} infer_arrays {np.mean(v) * 1e3:.3f} ms host wall (mean of {len(v)} calls, "
            f"{h * w / 1e6 / np.mean(v):.2f} Mpx/s)" for turn, v in walls.items()), flush=True)
        del one, mesh
        torch.cuda.empty_cache()

    # one raw request to a --mesh 2 server (virtual) and to an unmeshed one
    model = os.path.join(work, "annonet.dnn")
    responses = {}
    for label, extra in (("--mesh 2", ["--mesh", str(MESH_SHARDS)]), ("unmeshed", [])):
        os.environ[VIRTUAL_MESH_ENV] = "1"  # --mesh 2 on the one card
        try:
            service, server, client = start_server(["--model", model, "-d", "1:0.5", *extra])
        finally:
            del os.environ[VIRTUAL_MESH_ENV]
        try:
            wrappers = float_wrappers()
            for fn in wrappers.values():
                fn.launches = 0
            t = time.monotonic()
            responses[label] = client.infer(image)
            wall = time.monotonic() - t
            counts = {k: fn.launches for k, fn in wrappers.items()}
            print(f"  annonet_serve {label}: mesh {service.mesh}, one raw {h}x{w} request "
                  f"{wall * 1e3:.1f} ms, launches {counts}", flush=True)
        finally:
            stop_server(server)
    same = np.array_equal(responses["--mesh 2"], responses["unmeshed"])
    print(f"  the --mesh 2 server's labels equal the unmeshed server's: {same}", flush=True)
    if not same:
        raise AssertionError("annonet_serve --mesh 2 answered otherwise than without --mesh")
    return mesh_launches


def run_ranks(commands, env, what: str):
    """Run the commands together, each with SUBPROCESS_TIMEOUT; fail on a
    nonzero exit. Returns their outputs."""
    procs = [subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in commands]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SUBPROCESS_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise AssertionError(f"{what}: exit codes {codes}\n" + "\n=====\n".join(outs))
    return outs


def subprocess_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("ANNONET_TPU_TORCH_DEVICE", None)
    return env


def coordinator_phase(work: str, sizes, float_results) -> None:
    """Two annonet_infer processes on the one card (--coordinator on a free
    local port): float, whose result PNGs must equal phase 5's
    single-process run's byte for byte, rank 0 alone printing the cluster
    totals and matrices; then --quantize int8 --calibration-images 1
    --save-calibration, against a single-process run on each rank's shard
    (the same result PNGs; the merged calibration the element-wise max of
    the two shards' own)."""
    import socket

    from PIL import Image

    from annonet_tpu_torch import serialization

    data, model = os.path.join(work, "data"), os.path.join(work, "annonet.dnn")
    root = os.path.join(work, "coordinator")
    names = [name for name, _h, _w in sizes]

    def copy_images(dst, keep):
        os.makedirs(dst)
        for name in keep:
            for suffix in (".png", ".png_mask.png"):
                shutil.copy(os.path.join(data, name + suffix), dst)
        return dst

    def infer(directory, *extra):
        return [sys.executable, "-m", "annonet_tpu_torch.cli.infer", directory, "--model",
                model, "-d", "1:0.5", *extra]

    def ranks(directory, *extra):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        return [infer(directory, *extra, "--coordinator", f"127.0.0.1:{port}",
                      "--num-processes", "2", "--process-id", str(r)) for r in range(2)]

    def pngs(directory, keep):
        out = {}
        for name in keep:
            with open(os.path.join(directory, name + ".png_result.png"), "rb") as f:
                out[name] = f.read()
        return out

    env = subprocess_env()
    float_dir = copy_images(os.path.join(root, "float"), names)
    shard_dirs = [copy_images(os.path.join(root, f"shard{r}"), names[r::2]) for r in range(2)]
    int8_dir = copy_images(os.path.join(root, "int8"), names)
    calibs = [os.path.join(root, f"calib_shard{r}.npz") for r in range(2)]
    merged = os.path.join(root, "calib_merged.npz")
    int8 = ["--quantize", "int8", "--calibration-images", "1"]
    t = time.monotonic()
    # the float ranks beside the int8 single-process runs of each shard
    outs = run_ranks(ranks(float_dir) + [infer(d, *int8, "--save-calibration", c)
                                         for d, c in zip(shard_dirs, calibs)],
                     env, "the float ranks and the int8 shard runs")
    print(f"  float ranks and int8 shard runs: {time.monotonic() - t:.1f} s", flush=True)
    for r, out in enumerate(outs[:2]):
        tail = [ln for ln in out.replace("\r", "\n").splitlines()
                if ln.startswith(("Multi-host", "images in dataset", "Cluster", "All "))]
        print(f"  float rank {r}: " + " | ".join(tail), flush=True)
    if "Cluster totals: 2 images across 2 processes" not in outs[0] or "Cluster" in outs[1]:
        raise AssertionError("rank 0 alone must print the cluster totals")
    if "Confusion matrix per pixel" not in outs[0] or "Confusion matrix" in outs[1]:
        raise AssertionError("rank 0 alone must print the merged confusion matrices")
    with_phase5 = pngs(float_dir, names)
    for name in names:
        with Image.open(io.BytesIO(with_phase5[name])) as im:
            same = np.array_equal(np.asarray(im.convert("RGBA")), float_results[name])
        print(f"  {name}: the 2-process float result equals the single-process run's: {same}",
              flush=True)
        if not same:
            raise AssertionError(f"{name}: the 2-process result differs from one process's")
    t = time.monotonic()
    outs = run_ranks(ranks(int8_dir, *int8, "--save-calibration", merged), env,
                     "the int8 ranks")
    print(f"  int8 ranks: {time.monotonic() - t:.1f} s; rank 0: "
          + " | ".join(ln for ln in outs[0].splitlines() if "calibration" in ln), flush=True)
    if "maxima merged across 2 of 2 processes" not in outs[0] or "Saved int8" in outs[1]:
        raise AssertionError("rank 0 alone must save the calibration merged over 2 processes")
    shard_pngs = {**pngs(shard_dirs[0], names[0::2]), **pngs(shard_dirs[1], names[1::2])}
    rank_pngs = pngs(int8_dir, names)
    for name in names:
        same = shard_pngs[name] == rank_pngs[name]
        print(f"  {name}: the int8 rank's result PNG equals its shard's single-process run's "
              f"byte for byte: {same}", flush=True)
        if not same:
            raise AssertionError(f"{name}: the int8 rank's result differs")
    config = serialization.load_model(model)[1]
    s0, s1, m = (serialization.load_calibration(p, config) for p in (*calibs, merged))
    differ = sum(not np.array_equal(a, b) for a, b in zip(s0, s1))
    exact = all(np.array_equal(np.maximum(a, b), c) for a, b, c in zip(s0, s1, m))
    print(f"  merged calibration: {len(m)} layers, the shards differ at {differ}; "
          f"element-wise max of the shards' own: {exact}", flush=True)
    if not exact or not differ:
        raise AssertionError("the merged calibration is not the max of two distinct shards'")


def autotune_phase(work: str, data: str) -> None:
    """annonet_autotune (a process of its own, under a timeout; each probe
    a 3-step annonet_train process) on the flagship at 192² crops from
    AUTOTUNE_START, with --max-total-steps 3 passed through, so the real
    run is 3 steps too. Prints each probe's size, outcome and wall (from
    the times its lines arrive; a size passes when it is at most the one
    found), the largest batch and the real run's exit code."""
    import signal

    argv = [sys.executable, "-m", "annonet_tpu_torch.cli.autotune", "--start",
            str(AUTOTUNE_START), data, "--level-count", "3", "--max-total-steps", "3",
            "--save-interval", "1000", "--output", os.path.join(work, "autotuned.dnn"),
            "--sync-file", os.path.join(work, "autotuned.dat")]
    torch.cuda.empty_cache()  # leave the card to the probes
    t0 = time.monotonic()
    proc = subprocess.Popen(argv, env=subprocess_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    lines = []
    try:
        deadline = t0 + 2 * SUBPROCESS_TIMEOUT
        for line in proc.stdout:
            lines.append((time.monotonic(), line.rstrip("\n")))
            if time.monotonic() > deadline:
                raise AssertionError("annonet_autotune ran past its deadline")
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)  # the tool and its probes
            proc.wait()
    wall = time.monotonic() - t0
    text = "\n".join(line for _t, line in lines)
    m = re.search(r"max working minibatch size: (\d+)", text)
    if proc.returncode != 0 or m is None:
        raise AssertionError(f"annonet_autotune exited with {proc.returncode}:\n{text[-3000:]}")
    best = int(m.group(1))
    probes = [(i, int(re.search(r"size (\d+)", line).group(1))) for i, (_t, line)
              in enumerate(lines) if line.startswith("probing minibatch size")]
    for i, size in probes:
        probe_wall = lines[i + 1][0] - lines[i][0]
        print(f"  probe -b {size}: {'pass' if size <= best else 'fail'}, {probe_wall:.1f} s",
              flush=True)
    real = next(t for t, line in lines if line.startswith("launching the real run"))
    print(f"  largest batch at {train_crop_dim(flagship_config())}²: {best} ({len(probes)} "
          f"probes from --start {AUTOTUNE_START}); the real run -b {best}: exit code "
          f"{proc.returncode}, {lines[-1][0] - real:.1f} s; annonet_autotune {wall:.1f} s",
          flush=True)
    sizes = [s for _i, s in probes]
    if best not in sizes or best + 1 not in sizes:
        raise AssertionError(f"the search did not bracket its boundary: probes {sizes}")


def accuracy_phase(device) -> None:
    """tools/measure_accuracy.train_and_score on the card: the JAX
    end-to-end test's recipe (40 f32 steps, TF32 off), then the float and
    int8 inferers on its images, held against PARITY_TARGETS.json's pinned
    floors."""
    from annonet_tpu_torch.tools import measure_accuracy

    pixel_floor, miou_floor = measure_accuracy.pinned_floors()
    t = time.monotonic()
    with tempfile.TemporaryDirectory(dir=_REPO, prefix=".chip_smoke_") as td:
        measure_accuracy.write_separable_dataset(td)
        run = measure_accuracy.train_and_score(td, seed=0, device=device)
    print(f"  seed 0 on {device}: loss {run['losses'][0]:.4f} -> {run['losses'][-1]:.4f}; "
          f"pixel accuracy {run['pixel_accuracy']:.5f} (floor {pixel_floor}), mIoU "
          f"{run['miou']:.5f} (floor {miou_floor}), int8 pixel accuracy "
          f"{run['int8_pixel_accuracy']:.5f} (floor {pixel_floor}); "
          f"{time.monotonic() - t:.1f} s", flush=True)
    missed = measure_accuracy.below_floors(run)
    if missed:
        raise AssertionError("under the pinned floors: " + "; ".join(missed))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False; "
                         "this smoke run needs an NVIDIA GPU")
    # plain versions are the yardstick: no TF32 in their f32 convs/matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {smi}; torch {torch.__version__} CUDA {torch.version.cuda};"
          f" {torch.cuda.device_count()} device(s)", flush=True)

    from annonet_tpu_torch.models.segnet import (
        init_runtime_params, runtime_params_from_numpy,
    )
    from annonet_tpu_torch.ops import _build

    t = time.monotonic()
    path = _build.build()
    _build.lib()
    print(f"[build] {os.path.relpath(path, _REPO)} in "
          f"{time.monotonic() - t:.1f} s", flush=True)
    check_tensor_cores(path)

    config = flagship_config()
    params_np = init_runtime_params(config, SEED)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    plan = canvas_plan(config)
    n, side = plan.tile_count, plan.tile_height
    print(f"[kernels] the inferer's plan of a {CANVAS}x{CANVAS} image: {n} tiles of "
          f"{side}x{plan.tile_width}, overlap {plan.overlap_y}", flush=True)
    print(f"[kernels] f32, one {side}x{side} tile", flush=True)
    check_convs(
        runtime_params_from_numpy(params_np, config, device), config, device,
        1, side, torch.float32, F32_TOL, 0, gen,
    )
    print(f"[kernels] bf16, the {n}-tile {side}x{side} batch", flush=True)
    conv_results = check_convs(
        runtime_params_from_numpy(params_np, config, device), config, device,
        n, side, torch.bfloat16, BF16_TOL, 5, gen,
    )
    print("[kernels] blend epilogue, 4096x4096 canvas, K=3", flush=True)
    blend_result = check_blend(config, device, 5, gen)
    torch.cuda.empty_cache()
    print(f"[kernels] int8, the {n}-tile {side}x{side} batch, each layer on the int8 net's "
          "own activations", flush=True)
    _calibration, qp, qp_up, _x_q, inputs = int8_setup(params_np, config, device, gen,
                                                       n, side)
    int8_results, requant_share = check_int8_kernels(config, device, qp, qp_up, inputs, 3)
    del inputs, _x_q
    torch.cuda.empty_cache()
    print("[kernels] blend epilogue in bf16, 4096x4096 canvas, K=3", flush=True)
    blend_bf16 = check_blend_bf16(config, device, 5, gen)
    torch.cuda.empty_cache()
    print(f"[kernels] G1, f32, the folded net's 7 stride-1 layers on one {side}x{side} tile",
          flush=True)
    check_g1(params_np, dataclasses.replace(config, compute_dtype="float32"), device,
             1, side, 0, gen)
    print(f"[kernels] G1, bf16, the folded net's 7 stride-1 layers on the {n}-tile batch",
          flush=True)
    g1_results = check_g1(params_np, config, device, n, side, 3, gen)
    torch.cuda.empty_cache()

    print("[accuracy] card vs CPU on a small image", flush=True)
    check_small_image(params_np, config, device)

    print("[main] annonet_infer on a 4096x4096 and a 2300x1500 image", flush=True)
    work = tempfile.mkdtemp(prefix=".chip_smoke_", dir=_REPO)
    try:
        launches, per_image, text = run_main_path(
            work, config, SEED, IMAGE_SIZES, str(device)
        )
        float_results = read_results(os.path.join(work, "data"), IMAGE_SIZES)
        print("[int8] annonet_infer --quantize int8 on the same images", flush=True)
        int8_launches, int8_per_image, calib = run_int8_path(
            work, IMAGE_SIZES, float_results)
        int8_labels = read_results(os.path.join(work, "data"), IMAGE_SIZES)
        print("[serve] annonet_serve in-process: the float server, the int8 server, "
              "--plan-autotune", flush=True)
        t = time.monotonic()
        serve_float, serve_int8 = serve_phase(work, IMAGE_SIZES, float_results, int8_labels,
                                              calib, smi)
        print(f"  serve phase: {time.monotonic() - t:.1f} s", flush=True)
        del int8_labels
        print("[pipeline] annonet_infer pipelined and sequential on four images, then "
              "--profile", flush=True)
        pipeline_phase(work, IMAGE_SIZES, SEED)
        print("[breakdown] one 4096x4096 image, stage by stage", flush=True)
        breakdown(params_np, config, device, os.path.join(work, "data"),
                  IMAGE_SIZES[-1][0])
        inferer, image, plan = breakdown_int8(
            params_np, config, device, os.path.join(work, "data"), IMAGE_SIZES[-1][0],
            calib)
        print("[quantize_up] int8 up layers (Q3) on the 25-tile batch", flush=True)
        up_launches = quantize_up_forward(params_np, config, device, inferer, image, plan)
        del inferer, image
        torch.cuda.empty_cache()
        print("[pallas_conv] TiledInferer(use_pallas_conv=True), the 4096x4096 image",
              flush=True)
        pallas_launches = pallas_conv_path(params_np, config, device,
                                           os.path.join(work, "data"), IMAGE_SIZES[-1][0])
        torch.cuda.empty_cache()
        print(f"[mesh] TiledInferer on a virtual {MESH_SHARDS}-shard mesh of the card, the "
              "4096x4096 image: float, int8, use_pallas_conv; annonet_serve --mesh", flush=True)
        t = time.monotonic()
        mesh_launches = mesh_phase(params_np, config, device, work, IMAGE_SIZES[-1][0], calib)
        print(f"  mesh phase: {time.monotonic() - t:.1f} s", flush=True)
        print("[coordinator] two annonet_infer processes on the card (--coordinator)",
              flush=True)
        t = time.monotonic()
        coordinator_phase(work, IMAGE_SIZES, float_results)
        print(f"  coordinator phase: {time.monotonic() - t:.1f} s", flush=True)
        del float_results
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    print("[repro_qconv_s1] the diagnostic tool's sweep and bisect on the card",
          flush=True)
    acc_launches = repro_qconv_phase(device)
    torch.cuda.empty_cache()
    train_launches = training_phases(device)
    print(f"  int8 validation launches: {train_launches}", flush=True)
    print("[accuracy_floors] the end-to-end test's recipe trained and scored on the card",
          flush=True)
    accuracy_phase(device)
    for label, records in (("float", per_image), ("int8", int8_per_image)):
        for rec in records:
            mpx = rec["width"] * rec["height"] / 1e6
            print(f"  {label} {os.path.basename(rec['image'])}: {rec['milliseconds']:.3f} ms"
                  f" inference, {mpx / (rec['milliseconds'] / 1e3):.2f} Mpx/s"
                  + (" (first image: one-time costs included)"
                     if rec["first_group"] else ""), flush=True)
    m = re.search(r"processed in ([0-9.]+) seconds", text)
    if m:
        total_px = sum(h * w for _n, h, w in IMAGE_SIZES)
        print(f"  whole float run incl. reading, veto, PNG writing, confusion "
              f"matrices: {total_px / 1e6 / float(m.group(1)):.2f} Mpx/s", flush=True)
    imported = sorted({m.split(".")[0] for m in sys.modules} & {"jax", "annonet_tpu"})
    if imported:
        raise AssertionError(f"the port imported {imported}")

    results = dict(conv_results)
    results["blend_argmax"] = blend_result
    results.update(int8_results)
    results.update(g1_results)
    launches.update({k: int8_launches[k] for k in ("qconv3x3_requant", "qconv3x3_s2_requant")})
    launches["qup2x2_requant"] = up_launches
    launches["conv3x3_gemm_aligned"] = pallas_launches["conv3x3_gemm_aligned"]
    modes = {
        "up2x2_bias_relu": {"requant": {
            "launches": int8_launches["up2x2_requant"],
            "share_differing": requant_share,
            **numbers(int8_results["up2x2_requant"]),
        }},
        "blend_argmax": {f"bfloat16_{variant}": numbers(r) for variant, r in blend_bf16.items()},
        "qconv3x3_requant": {"accumulator": {
            "replaces": _ACC_REPLACES,
            "path": _ACC_PATH,
            "launches": acc_launches,
            **numbers(int8_results["qconv3x3_acc"]),
        }},
    }
    modes["blend_argmax"]["bfloat16_detection"]["launches"] = int8_launches["blend_argmax"]
    # the serve phase's own counts: the float server's K1-K4, the int8
    # server's Q1, Q2, K3-requant and K4
    modes["up2x2_bias_relu"]["requant"]["serve_launches"] = serve_int8["up2x2_requant"]
    modes["blend_argmax"]["bfloat16_detection"]["serve_launches"] = serve_int8["blend_argmax"]
    serve_launches = {**{k: serve_int8[k] for k in ("qconv3x3_requant", "qconv3x3_s2_requant")},
                      **serve_float}
    kernels = []
    for name in _TPU_KERNELS:
        entry = {
            "name": name,
            "route": "cuda",
            "source": _SOURCES[name],
            "replaces": _TPU_KERNELS[name],
            "launches": launches[name],
            "serve_launches": serve_launches.get(name, 0),
            "mesh_launches": mesh_launches[name],
            **numbers(results[name]),
        }
        if name in modes:
            entry["modes"] = modes[name]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
