"""annonet_inspect on the port: describe a model artifact as JSON.

The JAX package's ``annonet_tpu/cli/inspect.py``: the ``annonet.dnn``
artifact is self-describing (class palette, downscaling factor, model
config and BN-folded weights travel together), and this tool prints that
description without touching a device, so deployment tooling can check
what an artifact is before serving it:

    python -m annonet_tpu_torch.cli.inspect annonet.dnn
    python -m annonet_tpu_torch.cli.inspect annonet.dnn --weights-fingerprint

``--calibration calib.npz`` also reports whether a persisted int8
calibration file matches the model (config and weights fingerprint), so a
stale-calibration reload failure can be diagnosed offline. The JSON is the
JAX tool's, key for key; a model that does not load prints
``{"error": ..., "model": ...}`` and exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="annonet_inspect",
        description="Describe an annonet-tpu model artifact as JSON.",
    )
    p.add_argument("model", help="Model artifact path (annonet.dnn)")
    p.add_argument("--weights-fingerprint", action="store_true",
                   help="Also compute the weights fingerprint "
                        "(serialization.weights_fingerprint) — the value "
                        "persisted int8 calibrations are checked against")
    p.add_argument("--calibration", default=None, metavar="PATH",
                   help="Also describe a persisted int8 calibration file "
                        "and report whether it matches this model")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    import numpy as np

    from annonet_tpu_torch import serialization
    from annonet_tpu_torch.classes import parse_anno_classes
    from annonet_tpu_torch.models.segnet import (
        recommended_input_dimension,
        required_input_dimension,
    )

    try:
        params, config, classes_json, downscaling = serialization.load_model(args.model)
    except Exception as e:  # noqa: BLE001 — a one-line diagnosis, exit 1
        print(json.dumps({"error": str(e), "model": args.model}))
        return 1
    anno_classes = parse_anno_classes(classes_json)

    flat = serialization.flatten_tree(params)
    required = required_input_dimension(config)
    info = {
        "model": args.model,
        "model_config": config.to_dict(),
        "downscaling_factor": downscaling,
        "required_input_dimension": required,
        "recommended_input_dimension": recommended_input_dimension(config, required),
        "classes": [
            {"index": c.index, "name": c.classlabel,
             "color_rgba": list(map(int, c.rgba_label))}
            for c in anno_classes
        ],
        "arrays": len(flat),
        "parameters": int(sum(int(np.prod(v.shape)) for v in flat.values())),
        "bytes": int(sum(v.nbytes for v in flat.values())),
    }
    if args.weights_fingerprint or args.calibration:
        info["weights_fingerprint"] = serialization.weights_fingerprint(params)
    if args.calibration:
        try:
            serialization.load_calibration(args.calibration, config, params)
            info["calibration"] = {"path": args.calibration, "matches_model": True}
        except Exception as e:  # noqa: BLE001 — reported in the JSON
            info["calibration"] = {
                "path": args.calibration, "matches_model": False, "error": str(e),
            }
    print(json.dumps(info, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
