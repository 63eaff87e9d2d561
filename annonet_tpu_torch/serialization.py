"""The inference artifact (``annonet.dnn``), the trainer's synchronization
file and the int8 calibration file: save and load, without JAX.

The port of ``annonet_tpu/serialization.py``: the same container (a NumPy
.npz with a JSON ``__meta__`` entry and one array per leaf: ``params/
<block>/<conv>/<leaf>`` for the model; ``params/...``, ``bn_stats/...``
and ``velocity/...`` for the trainer state; ``layer/NNN`` for the
calibration), the same meta fields, the same weights fingerprint and the
same validation, so each package reads what the other writes. The files are untrusted: the
container, the meta fields and every declared array shape are checked
before any array data is decompressed.

Three things differ from the JAX loaders: a missing path raises
FileNotFoundError instead of being reported as a corrupt container, npy
headers are read with NumPy's public header readers, and a calibration
file without ``model_config`` is reported as such instead of raising
KeyError.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import tempfile
import zipfile
from typing import Any, Dict, Tuple

import numpy as np
from numpy.lib import format as npformat

from annonet_tpu_torch.models.segnet import (
    SegNetConfig,
    runtime_param_shapes,
    train_state_shapes,
)

_FORMAT = "annonet-tpu-npz-v1"
_SEP = "/"
_KIND = "runtime_net"
_TRAINER = "trainer_state"
_CALIBRATION = "int8_calibration"
_KIND_NAMES = {
    _KIND: "model file", _TRAINER: "trainer state file", _CALIBRATION: "calibration file",
}
_TREE_NAMES = ["bn_stats", "params", "velocity"]
_MAX_META_BYTES = 16 << 20  # __meta__ carries anno_classes.json; cap it
_CONFIG_FIELDS = {
    "class_count", "level_count", "width_scaler", "min_filter_count",
    "grayscale", "base_width", "compute_dtype",
}
_HEADER_READERS = {
    (1, 0): npformat.read_array_header_1_0,
    (2, 0): npformat.read_array_header_2_0,
}


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Flatten a nested dict-of-arrays tree into {path: array}."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            key = f"{prefix}{_SEP}{k}" if prefix else str(k)
            out.update(flatten_tree(v, key))
    else:
        out[prefix] = np.asarray(tree)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Any:
    """Inverse of flatten_tree."""
    root: Dict[str, Any] = {}
    for path, value in flat.items():
        parts = path.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return root


def _atomic_savez(path: str, **arrays) -> None:
    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _corrupt(path, why: str, kind: str = _KIND) -> RuntimeError:
    return RuntimeError(
        f"{_describe(path)} is not a valid annonet-tpu {_KIND_NAMES[kind]}: {why}"
    )


def _describe(path) -> str:
    """The path, or a tag for a file-like input."""
    return path if isinstance(path, (str, os.PathLike)) else "<in-memory file>"


def _rewound(path):
    """A file-like input is read twice (headers, then arrays): rewind it."""
    if hasattr(path, "seek"):
        path.seek(0)
    return path


def _scan_npz(path, kind: str = _KIND):
    """Parse the zip directory and every member's npy header (shape,
    dtype) without decompressing array data; return (meta, headers)."""
    headers: Dict[str, Tuple[tuple, np.dtype]] = {}

    def corrupt(why):
        return _corrupt(path, why, kind)

    try:
        with zipfile.ZipFile(_rewound(path)) as zf:
            names = zf.namelist()
            if "__meta__.npy" not in names:
                raise corrupt("missing __meta__ entry")
            if zf.getinfo("__meta__.npy").file_size > _MAX_META_BYTES:
                raise corrupt(f"__meta__ is larger than {_MAX_META_BYTES} bytes")
            for name in names:
                if not name.endswith(".npy"):
                    raise corrupt(f"unexpected member {name!r}")
                with zf.open(name) as f:
                    version = npformat.read_magic(f)
                    reader = _HEADER_READERS.get(version)
                    if reader is None:
                        raise corrupt(f"member {name!r} has npy version {version}")
                    shape, _fortran, dtype = reader(f)
                if dtype.hasobject:
                    raise corrupt(f"member {name!r} has object dtype")
                headers[name[: -len(".npy")]] = (tuple(shape), dtype)
            meta_bytes = zf.read("__meta__.npy")
    except (RuntimeError, FileNotFoundError):
        raise
    except Exception as e:  # zipfile/format/header errors: corrupt container
        raise corrupt(f"unreadable npz container ({e})") from e
    try:
        meta_arr = np.load(io.BytesIO(meta_bytes), allow_pickle=False)
        meta = json.loads(bytes(meta_arr).decode("utf-8"))
    except Exception as e:
        raise corrupt(f"unreadable __meta__ ({e})") from e
    if not isinstance(meta, dict):
        raise corrupt("__meta__ is not a JSON object")
    if meta.get("format") != _FORMAT or meta.get("kind") != kind:
        raise RuntimeError(
            f"{_describe(path)} is not an annonet-tpu {_KIND_NAMES[kind]}"
        )
    return meta, headers


def _validated_config(raw, path: str, kind: str = _KIND) -> SegNetConfig:
    """SegNetConfig from untrusted meta: reject unknown fields, wrong types
    and absurd ranges before any shape computation keys off them."""
    if not isinstance(raw, dict):
        raise _corrupt(path, "model_config is not an object", kind)
    unknown = set(raw) - _CONFIG_FIELDS
    missing = _CONFIG_FIELDS - set(raw)
    if unknown or missing:
        raise _corrupt(
            path,
            f"model_config fields unknown={sorted(unknown)} "
            f"missing={sorted(missing)}",
            kind,
        )

    def _int(name, lo, hi):
        v = raw[name]
        if not isinstance(v, int) or isinstance(v, bool) or not lo <= v <= hi:
            raise _corrupt(path, f"model_config.{name}={v!r} outside [{lo}, {hi}]", kind)

    _int("class_count", 1, 65535)
    _int("level_count", 0, 8)
    _int("base_width", 1, 8192)
    _int("min_filter_count", 1, 8192)
    ws = raw["width_scaler"]
    if not isinstance(ws, (int, float)) or isinstance(ws, bool) or not (
        0.0 < float(ws) <= 1024.0 and np.isfinite(ws)
    ):
        raise _corrupt(path, f"model_config.width_scaler={ws!r}", kind)
    if not isinstance(raw["grayscale"], bool):
        raise _corrupt(path, "model_config.grayscale is not a bool", kind)
    if raw["compute_dtype"] not in ("bfloat16", "float32"):
        raise _corrupt(path, f"model_config.compute_dtype={raw['compute_dtype']!r}", kind)
    return SegNetConfig.from_dict(raw)


def _check_tree_headers(path, headers, expected, kind: str = _KIND) -> None:
    """Every expected member ({name: shape}) present with the declared
    shape and a numeric dtype, nothing extra, and a bounded total size."""
    stored = {k: v for k, v in headers.items() if k != "__meta__"}
    missing = sorted(set(expected) - set(stored))
    extra = sorted(set(stored) - set(expected))
    if missing or extra:
        raise _corrupt(
            path,
            f"parameter tree mismatch vs declared architecture "
            f"(missing {missing[:4]}{'...' if len(missing) > 4 else ''}, "
            f"unexpected {extra[:4]}{'...' if len(extra) > 4 else ''})",
            kind,
        )
    total = 0
    for name, shape in expected.items():
        got_shape, got_dtype = stored[name]
        if got_shape != shape or got_dtype.kind not in "fiu":
            raise _corrupt(
                path,
                f"parameter {name!r} has shape {got_shape} dtype "
                f"{got_dtype}, architecture expects shape {shape}",
                kind,
            )
        total += int(np.prod(got_shape, dtype=np.int64)) * got_dtype.itemsize
    if total > (8 << 30):
        raise _corrupt(path, f"declared parameter tree is {total} bytes", kind)


def save_model(
    path: str,
    runtime_params: Any,
    config: SegNetConfig,
    anno_classes_json: str,
    downscaling_factor: float,
) -> None:
    """Write the self-describing inference artifact (the annonet.dnn
    analog): the numpy runtime tree in the JAX layout plus the meta."""
    meta = {
        "format": _FORMAT,
        "kind": _KIND,
        "anno_classes_json": anno_classes_json,
        "downscaling_factor": float(downscaling_factor),
        "model_config": config.to_dict(),
    }
    arrays = {
        "params" + _SEP + k: v for k, v in flatten_tree(runtime_params).items()
    }
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8
    )
    _atomic_savez(path, **arrays)


def load_model(path: str) -> Tuple[Any, SegNetConfig, str, float]:
    """Read back (runtime_params numpy tree, config, anno_classes_json,
    downscaling_factor), validating everything before decompression."""
    meta, headers = _scan_npz(path)
    config = _validated_config(meta.get("model_config"), path)
    anno_classes_json = meta.get("anno_classes_json")
    if not isinstance(anno_classes_json, str):
        raise _corrupt(path, "anno_classes_json is not a string")
    downscaling = meta.get("downscaling_factor")
    if (
        not isinstance(downscaling, (int, float))
        or isinstance(downscaling, bool)
        or not np.isfinite(downscaling)
        or not 0.0 < float(downscaling) <= 1e6
    ):
        raise _corrupt(path, f"downscaling_factor={downscaling!r}")
    _check_tree_headers(path, headers, {
        "params" + _SEP + k: v for k, v in runtime_param_shapes(config).items()
    })
    with np.load(path, allow_pickle=False) as z:
        flat = {
            k[len("params" + _SEP):]: z[k]
            for k in z.files
            if k.startswith("params" + _SEP)
        }
    return unflatten_tree(flat), config, anno_classes_json, float(downscaling)


# --------------------------------------------------------------------------
# The trainer's synchronization file (params, BN statistics, velocity)
# --------------------------------------------------------------------------


def save_trainer_state(path: str, trees: Dict[str, Any], meta: Dict[str, Any]) -> None:
    """Write the full training state: ``trees`` maps params / bn_stats /
    velocity to numpy trees; ``meta`` holds JSON scalars (learning rate,
    step count, loss window, model config, weights fingerprint). The JAX
    package's file, member for member."""
    arrays: Dict[str, np.ndarray] = {}
    for name, tree in trees.items():
        for k, v in flatten_tree(tree).items():
            arrays[name + _SEP + k] = v
    payload = {"format": _FORMAT, "kind": _TRAINER, "meta": meta,
               "tree_names": sorted(trees.keys())}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(payload).encode("utf-8"), dtype=np.uint8
    )
    _atomic_savez(path, **arrays)


def load_trainer_meta(path: str) -> Dict[str, Any]:
    """Only the meta dict of a trainer-state file (one bounded member
    read; no parameter is decompressed)."""
    payload, _headers = _scan_npz(path, _TRAINER)
    meta = payload.get("meta")
    if not isinstance(meta, dict):
        raise _corrupt(path, "meta is not an object", _TRAINER)
    return meta


def load_trainer_state(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Read back (trees, meta) written by save_trainer_state, by either
    package. Untrusted input: the container, the tree names, the meta's
    scalars and every declared shape (against the architecture the file
    declares; the trainer also requires it to equal its own) are checked
    before any array is decompressed."""
    payload, headers = _scan_npz(path, _TRAINER)

    def corrupt(why):
        return _corrupt(path, why, _TRAINER)

    meta = payload.get("meta")
    if not isinstance(meta, dict):
        raise corrupt("meta is not an object")
    if payload.get("tree_names") != _TREE_NAMES:
        raise corrupt(f"tree_names={payload.get('tree_names')!r}")
    config = _validated_config(meta.get("model_config"), path, _TRAINER)
    shapes = train_state_shapes(config)
    shapes["velocity"] = shapes["params"]
    _check_tree_headers(path, headers, {
        name + _SEP + k: v for name in _TREE_NAMES for k, v in shapes[name].items()
    }, _TRAINER)
    losses = meta.get("previous_loss_values", [])
    if not isinstance(losses, list) or len(losses) > 1_000_000 or any(
        not isinstance(v, (int, float)) or isinstance(v, bool) for v in losses
    ):
        raise corrupt("previous_loss_values is malformed")
    step = meta.get("step_count")
    if not isinstance(step, int) or isinstance(step, bool) or not 0 <= step <= 10**12:
        raise corrupt(f"step_count={step!r}")
    lr = meta.get("learning_rate")
    if not isinstance(lr, (int, float)) or isinstance(lr, bool) or not np.isfinite(lr):
        raise corrupt(f"learning_rate={lr!r}")
    with np.load(_rewound(path), allow_pickle=False) as z:
        trees: Dict[str, Any] = {}
        for name in _TREE_NAMES:
            flat = {
                k[len(name + _SEP):]: z[k] for k in z.files if k.startswith(name + _SEP)
            }
            trees[name] = unflatten_tree(flat)
    return trees, meta


# --------------------------------------------------------------------------
# int8 calibration (per-layer activation maxima)
# --------------------------------------------------------------------------


def weights_fingerprint(runtime_params: Any) -> str:
    """sha256 over the flattened parameter tree (paths, dtypes, shapes and
    raw bytes): identifies the exact trained weights, as the JAX package's
    fingerprint does, byte for byte."""
    h = hashlib.sha256()
    for key, arr in sorted(flatten_tree(runtime_params).items()):
        h.update(key.encode("utf-8"))
        a = np.ascontiguousarray(np.asarray(arr))
        h.update(str(a.dtype).encode("utf-8"))
        h.update(str(a.shape).encode("utf-8"))
        h.update(a.tobytes())
    return h.hexdigest()


def _calibration_arrays(calibration, config: SegNetConfig, runtime_params):
    if not calibration:
        raise ValueError("empty calibration (no frozen int8 net to export)")
    meta = {
        "format": _FORMAT,
        "kind": _CALIBRATION,
        "model_config": config.to_dict(),
        "layer_count": len(calibration),
    }
    if runtime_params is not None:
        meta["weights_sha256"] = weights_fingerprint(runtime_params)
    arrays = {
        f"layer{_SEP}{i:03d}": np.asarray(v, np.float32)
        for i, v in enumerate(calibration)
    }
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8
    )
    return arrays


def save_calibration(path: str, calibration, config: SegNetConfig,
                     runtime_params: Any = None) -> None:
    """Persist int8 calibration maxima (``TiledInferer.export_calibration``)
    with the model config and, when ``runtime_params`` is given, the
    weights fingerprint, which the loader verifies."""
    _atomic_savez(path, **_calibration_arrays(calibration, config, runtime_params))


def calibration_npz_bytes(calibration, config: SegNetConfig,
                          runtime_params: Any = None) -> bytes:
    """The ``save_calibration`` file as bytes (``load_calibration`` reads
    them back from a file-like object)."""
    buf = io.BytesIO()
    np.savez(buf, **_calibration_arrays(calibration, config, runtime_params))
    return buf.getvalue()


def load_calibration(path, config: SegNetConfig, runtime_params: Any = None):
    """Read back a calibration file: a list of f32 vectors. Raises if it
    was made for another model config or, when both sides carry a
    fingerprint, for other trained weights; validates the container and
    the layer vectors' declared shapes before decompressing them."""
    meta, headers = _scan_npz(path, _CALIBRATION)

    def corrupt(why):
        return _corrupt(path, why, _CALIBRATION)

    layer_count = meta.get("layer_count")
    if not isinstance(layer_count, int) or isinstance(layer_count, bool) or (
        not 1 <= layer_count <= 4096
    ):
        raise corrupt(f"layer_count={layer_count!r}")
    names = [f"layer{_SEP}{i:03d}" for i in range(layer_count)]
    if set(headers) - {"__meta__"} != set(names):
        raise corrupt(f"layer members do not match layer_count={layer_count}")
    for name in names:
        shape, dtype = headers[name]
        if len(shape) != 1 or shape[0] > (1 << 20) or dtype.kind != "f":
            raise corrupt(
                f"member {name!r} has shape {shape} dtype {dtype} "
                "(expected a small 1-D float vector)"
            )
    if "model_config" not in meta:
        raise corrupt("no model_config in __meta__")
    if meta["model_config"] != config.to_dict():
        raise RuntimeError(
            f"{_describe(path)} was calibrated for a different model config "
            f"({meta['model_config']} != {config.to_dict()})"
        )
    if runtime_params is not None and "weights_sha256" in meta:
        if meta["weights_sha256"] != weights_fingerprint(runtime_params):
            raise RuntimeError(
                f"{_describe(path)} was calibrated for different trained "
                "weights (same architecture, different model; recalibrate "
                "with --save-calibration)"
            )
    with np.load(_rewound(path), allow_pickle=False) as z:
        return [z[name] for name in names]
