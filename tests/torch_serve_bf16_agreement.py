"""How far the port's bf16 server and the JAX package's bf16 server agree
under the blob veto: a measurement script, not a test (pytest does not
collect it).

Both servers' label path (``_ModelService.infer``: the tiled forward, the
blob veto of seedless blobs, the resize) runs on the CPU on one
JAX-written artifact of tests/test_torch_serve.py's small net (level 1,
width 8, 64-px tiles) in bf16, over several weight seeds and images, with
``-d 1:0.5 -d 2:0.5`` (the veto on) and without it. For each image it
records the share of equal pixels in

  argmax   the labels before the veto (``infer_arrays``)
  seeds    the detection seeds
  served   the labels the servers send

and, of the served pixels that differ, the share whose argmax labels
agree: those differ only because one server's veto kept a blob that the
other's dropped (a seed pixel on one side and not the other). Beside them,
the JAX server's own net (the width-folded one, ``use_folded_net=True``)
against the JAX package's unfolded net, whose summation the port's plain
versions follow: ``jax_fold_argmax`` and ``jax_fold_served`` (the same
veto), and the port against the unfolded JAX net, ``unfolded_argmax`` and
``unfolded_served``. The same runs in f32 are the control.

``--round-once`` replaces the port's three plain bf16 convs by versions
that sum in f32 and round once, after the bias and ReLU (as the card's
kernels do, and as XLA executes the JAX net's conv and bias on the CPU
under jit), where the plain versions round the conv's sum to bf16 before
the bias as well (the JAX net's written semantics): it tests whether that
rounding point is the whole difference.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_serve_bf16_agreement.py [--round-once]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np


def measure(weight_seeds, image_seeds, shape, dtypes):
    from annonet_tpu import serialization as jax_serialization
    from annonet_tpu.cli import serve as jax_serve
    from annonet_tpu.infer import core as jax_core
    from annonet_tpu.infer.tiling import TilingParameters
    from annonet_tpu.models.segnet import SegNetConfig as JaxSegNetConfig
    from annonet_tpu_torch.classes import anno_classes_to_json, default_anno_classes
    from annonet_tpu_torch.cli import serve
    from annonet_tpu_torch.models.segnet import SegNetConfig
    from tests.test_torch_model import jax_runtime_tree

    os.environ["ANNONET_TPU_TORCH_DEVICE"] = "cpu"
    tiles = ["--tile-max-width", "64", "--tile-max-height", "64"]
    records = []
    with tempfile.TemporaryDirectory() as td:
        for dtype in dtypes:
            cfg = dict(class_count=3, level_count=1, base_width=8, compute_dtype=dtype)
            for wseed in weight_seeds:
                model = os.path.join(td, f"{dtype}_{wseed}.dnn")
                jax_serialization.save_model(
                    model, jax_runtime_tree(SegNetConfig(**cfg), wseed),
                    JaxSegNetConfig(**cfg), anno_classes_to_json(default_anno_classes()), 1.0)
                for detection in ([], ["-d", "1:0.5", "-d", "2:0.5"]):
                    argv = ["--model", model, *tiles, *detection]
                    ours = serve._ModelService(serve.build_parser().parse_args(argv))
                    theirs = jax_serve._ModelService(jax_serve.build_parser().parse_args(argv))
                    rf = ours.state.required_input_dimension
                    unfolded = jax_core.TiledInferer(
                        ours.state.params, JaxSegNetConfig(**cfg),
                        TilingParameters(64, 64, rf, rf), use_folded_net=False)
                    for iseed in image_seeds:
                        image = np.random.default_rng(iseed).integers(
                            0, 256, (*shape, 3), dtype=np.uint8)
                        gains, levels = ours.state.default_gains, ours.state.default_detection
                        a = ours.state.inferer.infer_arrays(image, gains, levels)
                        b = theirs.inferer.infer_arrays(image, gains, levels)
                        served = (ours.infer(image, gains, levels),
                                  np.asarray(theirs.infer(image, gains, levels)))
                        c = unfolded.infer_arrays(image, gains, levels)
                        served_unfolded = np.asarray(jax_core.detection_veto(
                            np.asarray(c[0]), None if c[1] is None else np.asarray(c[1])))
                        argmax_equal = np.asarray(a[0]) == np.asarray(b[0])
                        differ = served[0] != served[1]
                        records.append({
                            "dtype": dtype, "weights": wseed, "image": iseed,
                            "veto": bool(detection),
                            "argmax": float(argmax_equal.mean()),
                            "seeds": None if a[1] is None else
                            float((np.asarray(a[1]) == np.asarray(b[1])).mean()),
                            "served": float(1.0 - differ.mean()),
                            "differing_pixels": int(differ.sum()),
                            "veto_only": (float(argmax_equal[differ].mean())
                                          if differ.any() else None),
                            "jax_fold_argmax": float((np.asarray(b[0]) == np.asarray(c[0])).mean()),
                            "jax_fold_served": float((served[1] == served_unfolded).mean()),
                            "unfolded_argmax": float((np.asarray(a[0]) == np.asarray(c[0])).mean()),
                            "unfolded_served": float((served[0] == served_unfolded).mean()),
                        })
                        print(json.dumps(records[-1]), flush=True)
    return records


def round_once() -> None:
    """Patch the port's plain bf16 convs to round once, after the bias."""
    import torch
    import torch.nn.functional as F

    from annonet_tpu_torch.ops import conv

    def k1(x, w, bias, x2=None):
        if x2 is not None:
            x = torch.cat([x, x2], dim=-1)
        h = F.conv2d(conv._nchw(x).float(), w.float().permute(3, 2, 0, 1), padding=1)
        return conv._epilogue(h, bias, x.dtype)

    def k2(x, w, bias):
        xp = F.pad(conv._nchw(x).float(), (0, 1, 0, 1))
        return conv._epilogue(F.conv2d(xp, w.float().permute(3, 2, 0, 1), stride=2),
                              bias, x.dtype)

    def k3(x, w, bias):
        return conv._epilogue(conv._up2x2(x.float(), w.float()), bias, x.dtype)

    conv.conv3x3_bias_relu_plain = k1
    conv.conv3x3_s2_bias_relu_plain = k2
    conv.up2x2_bias_relu_plain = k3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="torch_serve_bf16_agreement")
    ap.add_argument("--weights", type=int, nargs="+", default=[3, 4, 5, 6])
    ap.add_argument("--images", type=int, nargs="+", default=list(range(6)))
    ap.add_argument("--shape", type=int, nargs=2, default=[80, 96])
    ap.add_argument("--round-once", action="store_true")
    args = ap.parse_args(argv)
    if args.round_once:
        round_once()
    records = measure(args.weights, args.images, tuple(args.shape), ("bfloat16", "float32"))
    for dtype in ("bfloat16", "float32"):
        for veto in (False, True):
            rs = [r for r in records if r["dtype"] == dtype and r["veto"] == veto]
            served = [r["served"] for r in rs]
            argmax = [r["argmax"] for r in rs]
            only = [r["veto_only"] for r in rs if r["veto_only"] is not None]
            mean = {k: np.mean([r[k] for r in rs]) for k in (
                "jax_fold_argmax", "jax_fold_served", "unfolded_argmax", "unfolded_served")}
            low = {k: min(r[k] for r in rs) for k in mean}
            print(f"{dtype} veto {veto}: {len(rs)} images; served labels equal on "
                  f"{np.mean(served):.5f} (min {min(served):.5f}); argmax labels "
                  f"{np.mean(argmax):.5f} (min {min(argmax):.5f}); of the differing served "
                  f"pixels, argmax labels agree on "
                  f"{np.mean(only) if only else float('nan'):.5f} on average; JAX folded vs its "
                  f"unfolded net: argmax {mean['jax_fold_argmax']:.5f} (min "
                  f"{low['jax_fold_argmax']:.5f}), served {mean['jax_fold_served']:.5f} (min "
                  f"{low['jax_fold_served']:.5f}); the port vs JAX's unfolded net: argmax "
                  f"{mean['unfolded_argmax']:.5f} (min {low['unfolded_argmax']:.5f}), served "
                  f"{mean['unfolded_served']:.5f} (min {low['unfolded_served']:.5f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
