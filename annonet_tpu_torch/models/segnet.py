"""SegmentationNet in PyTorch: the runtime (inference) net and the
training net.

The port of ``annonet_tpu/models/segnet.py``: the architecture config and
its dimension queries (pure Python, copied), a numpy initializer for the
BN-folded runtime tree (He init plus the BN fold, so an artifact can be
written on a machine without JAX), the conversion of that tree to device
tensors laid out as the kernels take them, and ``RuntimeSegNet``, the
counterpart of ``apply_runtime``. The training half (``init_state``,
``apply_train``, ``fold_batchnorm``) is at the end of the file.

Layout: NHWC activations, HWIO conv weights ([kh, kw, cin, cout], the JAX
layout, which is also what the hand-written kernels read), f32 biases.
The stem, encoder and decoder convs run through the fused conv + bias +
ReLU kernels of ``ops/conv.py``; the input normalisation and the 1x1 head
stay plain torch, as the JAX package computes both outside any kernel.

Topology (``L = level_count``):
    stem:   conv3x3 -> ReLU, conv3x3 -> ReLU                     (width w0)
    enc i:  conv3x3 s2 -> ReLU, conv3x3 -> ReLU                  (width wi)
    dec i:  2x2 transpose-conv s2 -> ReLU, concat skip,
            conv3x3 -> ReLU                                      (width w(i-1))
    head:   conv1x1 -> class_count logits (f32)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from annonet_tpu_torch.ops.conv import (
    conv3x3_bias_relu,
    conv3x3_s2_bias_relu,
    up2x2_bias_relu,
)

Params = Dict[str, Any]

_BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class SegNetConfig:
    """Architecture configuration (field for field the JAX package's, so
    an artifact's ``model_config`` reads into either package)."""

    class_count: int = 2
    level_count: int = 2
    width_scaler: float = 1.0
    min_filter_count: int = 1
    grayscale: bool = False
    base_width: int = 16
    compute_dtype: str = "bfloat16"

    @property
    def in_channels(self) -> int:
        return 1 if self.grayscale else 3

    def width(self, level: int) -> int:
        """Filter count at pyramid level ``level`` (0 = full resolution)."""
        base = self.base_width * (2 ** min(level, 3))
        return max(self.min_filter_count, int(round(base * self.width_scaler)))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "SegNetConfig":
        return SegNetConfig(**d)


def required_input_dimension(config: SegNetConfig) -> int:
    """Worst-case receptive field of one output pixel, in input pixels.

    Propagates the influence interval of one input pixel through the op
    sequence (a stride-2 3x3 conv pads (0, 1), so output o taps inputs
    2o..2o+2; a 2x2 stride-2 transpose conv maps u to {2u, 2u+1}),
    maximized over the 2**level_count parity classes.
    """
    L = config.level_count

    def conv3_s1(lo, hi):
        return lo - 1, hi + 1

    def conv3_s2(lo, hi):
        return -(-(lo - 2) // 2), hi // 2

    def up2(lo, hi):
        return 2 * lo, 2 * hi + 1

    best = 1
    base = 4 ** (L + 2)  # keep all intermediate indices positive
    for parity in range(2**L):
        lo = hi = base + parity
        lo, hi = conv3_s1(lo, hi)  # stem conv0
        lo, hi = conv3_s1(lo, hi)  # stem conv1
        for _ in range(L):
            lo, hi = conv3_s2(lo, hi)  # encoder downsample conv
            lo, hi = conv3_s1(lo, hi)  # encoder conv
        for _ in range(L):
            lo, hi = up2(lo, hi)  # decoder transpose conv
            lo, hi = conv3_s1(lo, hi)  # decoder conv
        best = max(best, hi - lo + 1)
    return best


def recommended_input_dimension(config: SegNetConfig, requested: int) -> int:
    """Round ``requested`` up so spatial dims divide by 2**level_count."""
    align = 2 ** config.level_count
    d = max(int(requested), align)
    return ((d + align - 1) // align) * align


# --------------------------------------------------------------------------
# The runtime parameter tree
# --------------------------------------------------------------------------


def conv_layers(config: SegNetConfig) -> Iterator[Tuple[str, str, tuple]]:
    """(block, conv, HWIO weight shape) of every conv before the head, in
    forward order. The decoder conv's input is the concat [up, skip]."""
    L = config.level_count
    w0 = config.width(0)
    yield "stem", "conv0", (3, 3, config.in_channels, w0)
    yield "stem", "conv1", (3, 3, w0, w0)
    for i in range(1, L + 1):
        cin, cout = config.width(i - 1), config.width(i)
        yield f"enc{i}", "conv0", (3, 3, cin, cout)
        yield f"enc{i}", "conv1", (3, 3, cout, cout)
    for i in range(L, 0, -1):
        cin, cout = config.width(i), config.width(i - 1)
        yield f"dec{i}", "up", (2, 2, cin, cout)
        yield f"dec{i}", "conv0", (3, 3, 2 * cout, cout)


def runtime_param_shapes(config: SegNetConfig) -> Dict[str, tuple]:
    """{"block/conv/leaf": shape} of the BN-folded runtime tree: the keys
    (under "params/") and shapes an artifact must hold."""
    shapes = {}
    for block, conv, shape in conv_layers(config):
        shapes[f"{block}/{conv}/w"] = shape
        shapes[f"{block}/{conv}/b"] = (shape[-1],)
    shapes["head/w"] = (1, 1, config.width(0), config.class_count)
    shapes["head/b"] = (config.class_count,)
    return shapes


def init_runtime_params(config: SegNetConfig, seed: int) -> Params:
    """A BN-folded runtime tree in the JAX layout, made with numpy.

    He-normal conv weights (std sqrt(2 / fan_in), as ``init_state``) and
    batch-norm statistics of a trained net (gamma, beta, running mean and
    variance drawn around their identity values), folded exactly like
    ``fold_batchnorm``: w * gamma / sqrt(var + eps), beta - mean * scale.
    The draws differ from ``jax.random``'s; the layout and the fold are
    the same, so the tree saves into an artifact either package reads.
    """
    rng = np.random.default_rng(seed)
    tree: Params = {}
    for block, conv, (kh, kw, cin, cout) in conv_layers(config):
        std = (2.0 / (kh * kw * cin)) ** 0.5
        w = rng.standard_normal((kh, kw, cin, cout)).astype(np.float32) * std
        gamma = rng.uniform(0.5, 1.5, cout).astype(np.float32)
        beta = (rng.standard_normal(cout) * 0.1).astype(np.float32)
        mean = (rng.standard_normal(cout) * 0.1).astype(np.float32)
        var = rng.uniform(0.5, 1.5, cout).astype(np.float32)
        scale = gamma / np.sqrt(var + np.float32(_BN_EPS))
        tree.setdefault(block, {})[conv] = {
            "w": (w * scale).astype(np.float32),
            "b": (beta - mean * scale).astype(np.float32),
        }
    w0, k = config.width(0), config.class_count
    tree["head"] = {
        "w": (rng.standard_normal((1, 1, w0, k)) * (2.0 / w0) ** 0.5).astype(
            np.float32
        ),
        "b": (rng.standard_normal(k) * 0.1).astype(np.float32),
    }
    return tree


def compute_dtype(config: SegNetConfig) -> torch.dtype:
    if config.compute_dtype == "bfloat16":
        return torch.bfloat16
    if config.compute_dtype == "float32":
        return torch.float32
    raise ValueError(f"unsupported compute_dtype {config.compute_dtype!r}")


def runtime_params_from_numpy(
    tree: Params, config: SegNetConfig, device
) -> Dict[str, torch.Tensor]:
    """The JAX runtime tree (numpy HWIO weights, f32 biases, head {w, b})
    -> {"block/conv/leaf": tensor} on ``device``, laid out for the kernels:
    conv weights contiguous HWIO in the compute dtype, biases f32, the
    head weight as a [C, K] matrix in the compute dtype."""
    dtype = compute_dtype(config)
    device = torch.device(device)
    out: Dict[str, torch.Tensor] = {}
    for key, shape in runtime_param_shapes(config).items():
        node = tree
        for part in key.split("/"):
            node = node[part]
        value = np.asarray(node, dtype=np.float32)
        if value.shape != shape:
            raise ValueError(f"{key} has shape {value.shape}, expected {shape}")
        t = torch.tensor(value)  # a copy: the tree's arrays may be read-only
        if key == "head/w":
            t = t.reshape(shape[2], shape[3])
        is_weight = key.endswith("/w")
        t = t.to(device=device, dtype=dtype if is_weight else torch.float32)
        out[key] = t.contiguous()
    return out


def normalize_input(x_uint8: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 [N,H,W,C] -> centered values in the compute dtype: normalised
    in f32 first, then cast (segnet.py's _normalize_input)."""
    return (x_uint8.to(torch.float32) * (1.0 / 255.0) - 0.5).to(dtype)


class RuntimeSegNet(nn.Module):
    """Inference forward on BN-folded params: [N,H,W,C] uint8 ->
    [N,H,W,K] f32 logits (the counterpart of ``apply_runtime``)."""

    def __init__(self, runtime_params: Params, config: SegNetConfig, *, device):
        super().__init__()
        self.config = config
        self.dtype = compute_dtype(config)
        for key, t in runtime_params_from_numpy(
            runtime_params, config, device
        ).items():
            self.register_buffer(key.replace("/", "_"), t)

    def weights(self, block: str, conv: str) -> Tuple[torch.Tensor, torch.Tensor]:
        return getattr(self, f"{block}_{conv}_w"), getattr(self, f"{block}_{conv}_b")

    def check_input(self, x: torch.Tensor) -> None:
        cfg = self.config
        if x.dim() != 4 or x.shape[-1] != cfg.in_channels:
            raise ValueError(
                f"expected input [N,H,W,{cfg.in_channels}] "
                f"({'grayscale' if cfg.grayscale else 'RGB'}), got {tuple(x.shape)}"
            )
        align = 2**cfg.level_count
        if x.shape[1] % align or x.shape[2] % align:
            raise ValueError(
                f"input H,W {x.shape[1]}x{x.shape[2]} must be multiples of "
                f"{align} (= 2**level_count); round sizes up with "
                f"recommended_input_dimension()"
            )
        if x.dtype != torch.uint8:
            raise ValueError(f"expected uint8 input, got {x.dtype}")

    def forward(
        self, x_uint8: torch.Tensor,
        tap: Optional[Callable[[str, torch.Tensor], None]] = None,
    ) -> torch.Tensor:
        """``tap(name, activation)``, when given, sees each conv and up
        layer's post-ReLU output ("stem/conv0", ..., "dec1/up", ...): the
        int8 calibration reads its per-channel maxima there."""
        self.check_input(x_uint8)
        L = self.config.level_count

        def out(name, x):
            if tap is not None:
                tap(name, x)
            return x

        x = normalize_input(x_uint8, self.dtype)
        x = out("stem/conv0", conv3x3_bias_relu(x, *self.weights("stem", "conv0")))
        x = out("stem/conv1", conv3x3_bias_relu(x, *self.weights("stem", "conv1")))
        skips: List[torch.Tensor] = [x]
        for i in range(1, L + 1):
            x = out(f"enc{i}/conv0",
                    conv3x3_s2_bias_relu(x, *self.weights(f"enc{i}", "conv0")))
            x = out(f"enc{i}/conv1",
                    conv3x3_bias_relu(x, *self.weights(f"enc{i}", "conv1")))
            if i < L:
                skips.append(x)
        for i in range(L, 0, -1):
            x = out(f"dec{i}/up", up2x2_bias_relu(x, *self.weights(f"dec{i}", "up")))
            # the decoder's concat([up, skip]) is the kernel's second input
            x = out(f"dec{i}/conv0", conv3x3_bias_relu(
                x, *self.weights(f"dec{i}", "conv0"), x2=skips.pop()
            ))
        # head: compute-dtype product (f32 accumulation inside), then the
        # f32 bias promotes the logits to f32 (segnet.py:459-462)
        return torch.matmul(x, self.head_w).to(torch.float32) + self.head_b


# --------------------------------------------------------------------------
# Training: the BN net's state, its forward with batch statistics, the fold
# --------------------------------------------------------------------------
#
# The training tree is the JAX package's (segnet.py:171-219), numpy f32
# leaves with the same names and shapes, so a sync file carries across:
#   params[block] = {conv: HWIO kernel, bn: {"gamma", "beta"}, ...},
#   params["head"] = {"w": [1, 1, w0, K], "b": [K]},
#   bn_stats[block] = {bn: {"mean", "var"}, ...}.
# On the device the same trees hold f32 tensors (the master parameters);
# the convs run in the compute dtype on casts of them.


def _bn_name(conv: str) -> str:
    """The BN layer after a conv: conv0 -> bn0, conv1 -> bn1, up -> bnu."""
    return "bnu" if conv == "up" else conv.replace("conv", "bn")


def train_state_shapes(config: SegNetConfig) -> Dict[str, Dict[str, tuple]]:
    """{"params": {"block/leaf path": shape}, "bn_stats": {...}}: the keys
    and shapes (all f32) of the training tree; the velocity tree has the
    params' (the JAX package's ``init_state`` layout)."""
    params: Dict[str, tuple] = {}
    stats: Dict[str, tuple] = {}
    for block, conv, shape in conv_layers(config):
        bn, c = _bn_name(conv), shape[-1]
        params[f"{block}/{conv}"] = shape
        params[f"{block}/{bn}/gamma"] = params[f"{block}/{bn}/beta"] = (c,)
        stats[f"{block}/{bn}/mean"] = stats[f"{block}/{bn}/var"] = (c,)
    params["head/w"] = (1, 1, config.width(0), config.class_count)
    params["head/b"] = (config.class_count,)
    return {"params": params, "bn_stats": stats}


def init_state(config: SegNetConfig, seed: int) -> Tuple[Params, Params]:
    """(params, bn_stats) numpy trees of a fresh training net: He-normal
    conv kernels (std sqrt(2 / fan_in), drawn in forward order from
    ``np.random.default_rng(seed)``), BN gamma 1 and beta 0, running mean
    0 and variance 1, head bias 0. The layout, names, shapes and dtypes
    are the JAX ``init_state``'s; the draws are numpy's, not jax.random's
    (carry a JAX state across with ``train_state_from_numpy``)."""
    rng = np.random.default_rng(seed)

    def he(shape):
        std = (2.0 / (shape[0] * shape[1] * shape[2])) ** 0.5
        return (rng.standard_normal(shape) * std).astype(np.float32)

    params: Params = {}
    stats: Params = {}
    for block, conv, shape in conv_layers(config):
        c = shape[-1]
        params.setdefault(block, {})[conv] = he(shape)
        params[block][_bn_name(conv)] = {
            "gamma": np.ones(c, np.float32), "beta": np.zeros(c, np.float32),
        }
        stats.setdefault(block, {})[_bn_name(conv)] = {
            "mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32),
        }
    params["head"] = {
        "w": he((1, 1, config.width(0), config.class_count)),
        "b": np.zeros(config.class_count, np.float32),
    }
    return params, stats


def tree_items(tree: Params, prefix: str = "") -> List[Tuple[str, Any]]:
    """[("block/leaf path", leaf)] in the tree's own order."""
    out: List[Tuple[str, Any]] = []
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.extend(tree_items(v, key))
        else:
            out.append((key, v))
    return out


def tree_map(fn: Callable[[Any], Any], tree: Params) -> Params:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def tree_to_numpy(tree: Params) -> Params:
    """A tree of tensors (any device) -> the same tree of numpy arrays
    (copies: later in-place updates of the tensors do not reach them)."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def train_state_from_numpy(
    params: Params, bn_stats: Params, velocity: Optional[Params], device
) -> Tuple[Params, Params, Params]:
    """Numpy (or JAX-array) trees -> f32 tensor trees on ``device``: the
    params as leaves that require grad, the BN statistics and the velocity
    (zeros when None) as plain tensors. How a JAX ``init_state`` or a sync
    file's state enters the port."""
    device = torch.device(device)

    def to(requires_grad):
        def convert(a):
            t = torch.tensor(np.asarray(a, np.float32), device=device)
            return t.requires_grad_(True) if requires_grad else t
        return convert

    p = tree_map(to(True), params)
    v = tree_map(to(False), velocity) if velocity is not None else tree_map(
        lambda t: torch.zeros_like(t, requires_grad=False), p
    )
    return p, tree_map(to(False), bn_stats), v


def _conv_train(x, w, stride: int, dtype):
    """SAME conv of NCHW ``x`` with an HWIO f32 kernel cast to ``dtype``;
    stride 2 pads (0, 1) as XLA's SAME does on even sizes."""
    wt = w.permute(3, 2, 0, 1).to(dtype)
    if stride == 2:
        return F.conv2d(F.pad(x, (0, 1, 0, 1)), wt, stride=2)
    return F.conv2d(x, wt, padding=w.shape[0] // 2)


def _conv_transpose_train(x, w, dtype):
    """The 2x2 stride-2 transpose conv: out[2i+u, 2j+v] = x[i, j] .
    w[1-u, 1-v] (lax.conv_transpose flips nothing; conv_transpose2d's
    kernel is the flipped one)."""
    wt = torch.flip(w, dims=(0, 1)).permute(2, 3, 0, 1).to(dtype)
    return F.conv_transpose2d(x, wt, stride=2)


def _bn_train(h, gamma, beta):
    """Batch norm of NCHW ``h`` over (N, H, W), as segnet.py's _bn_train:
    f32 statistics of the compute-dtype activations, var = max(E[h^2] -
    E[h]^2, 0), scale and shift rounded to the compute dtype once per
    channel, the normalisation in the compute dtype. Returns (out, mean,
    var). Not F.batch_norm: its running statistics take the unbiased
    variance."""
    h32 = h.to(torch.float32)
    mean = h32.mean(dim=(0, 2, 3))
    mean_sq = h32.square().mean(dim=(0, 2, 3))
    var = torch.clamp(mean_sq - mean.square(), min=0.0)
    inv = torch.rsqrt(var + _BN_EPS)
    scale = (inv * gamma).to(h.dtype)
    shift = (beta - mean * inv * gamma).to(h.dtype)
    return h * scale[:, None, None] + shift[:, None, None], mean, var


def _bn_update(stats: Params, mean, var, momentum: float) -> Params:
    return {
        "mean": stats["mean"] * momentum + mean.detach() * (1.0 - momentum),
        "var": stats["var"] * momentum + var.detach() * (1.0 - momentum),
    }


def _unit(x, w, gamma, beta, *, up: bool, stride: int, dtype):
    """conv (or transpose conv) -> BN with batch statistics -> ReLU."""
    with torch.profiler.record_function("conv_forward"):
        h = _conv_transpose_train(x, w, dtype) if up else _conv_train(x, w, stride, dtype)
    with torch.profiler.record_function("bn"):
        h, mean, var = _bn_train(h, gamma, beta)
        return torch.relu(h).to(dtype), mean, var


def apply_train(
    params: Params,
    bn_stats: Params,
    x_uint8: torch.Tensor,
    config: SegNetConfig,
    bn_momentum: float = 0.99,
    remat: bool = False,
) -> Tuple[torch.Tensor, Params]:
    """Training forward with batch-stat BN: [N,H,W,C] uint8 -> (logits
    [N,H,W,K] f32, new running statistics); the counterpart of the JAX
    ``apply_train``. ``params`` and ``bn_stats`` are trees of f32 tensors
    on the input's device; the convs run in the compute dtype on casts of
    the f32 kernels (through autograd: cuDNN on the card, not the
    inference kernels K1-K3, which have no backward). ``remat``
    recomputes each conv + BN + ReLU unit in the backward pass
    (torch.utils.checkpoint, as jax.checkpoint per unit)."""
    _check_train_input(x_uint8, config)
    dtype = compute_dtype(config)
    L = config.level_count
    new_stats: Params = {k: dict(v) for k, v in bn_stats.items()}

    def run_unit(x, p, name, stride):
        up = name == "bnu"
        w = p["up" if up else name.replace("bn", "conv")]
        fn = functools.partial(_unit, up=up, stride=stride, dtype=dtype)
        if remat:
            return checkpoint(fn, x, w, p[name]["gamma"], p[name]["beta"],
                              use_reentrant=False)
        return fn(x, w, p[name]["gamma"], p[name]["beta"])

    def block(x, p, s, names, strides):
        for name, stride in zip(names, strides):
            x, mean, var = run_unit(x, p, name, stride)
            s[name] = _bn_update(s[name], mean, var, bn_momentum)
        return x

    # NHWC uint8 -> NCHW view (channels_last in memory): cuDNN's NHWC convs
    x = normalize_input(x_uint8, dtype).permute(0, 3, 1, 2)
    x = block(x, params["stem"], new_stats["stem"], ["bn0", "bn1"], [1, 1])
    skips = [x]
    for i in range(1, L + 1):
        x = block(x, params[f"enc{i}"], new_stats[f"enc{i}"], ["bn0", "bn1"], [2, 1])
        if i < L:
            skips.append(x)
    for i in range(L, 0, -1):
        p, s = params[f"dec{i}"], new_stats[f"dec{i}"]
        x = block(x, p, s, ["bnu"], [2])
        x = torch.cat([x, skips[i - 1]], dim=1)
        x = block(x, p, s, ["bn0"], [1])
    with torch.profiler.record_function("conv_forward"):
        # compute-dtype head, then the f32 bias promotes the logits to f32
        logits = _conv_train(x, params["head"]["w"], 1, dtype) + params["head"]["b"][:, None, None]
    return logits.to(torch.float32).permute(0, 2, 3, 1), new_stats


def _check_train_input(x: torch.Tensor, config: SegNetConfig) -> None:
    if x.dim() != 4 or x.shape[-1] != config.in_channels:
        raise ValueError(
            f"expected input [N,H,W,{config.in_channels}] "
            f"({'grayscale' if config.grayscale else 'RGB'}), got {tuple(x.shape)}"
        )
    align = 2**config.level_count
    if x.shape[1] % align or x.shape[2] % align:
        raise ValueError(
            f"input H,W {x.shape[1]}x{x.shape[2]} must be multiples of "
            f"{align} (= 2**level_count); round sizes up with "
            f"recommended_input_dimension()"
        )


def fold_batchnorm(params: Params, bn_stats: Params, config: SegNetConfig) -> Params:
    """Fold the running BN statistics into the conv kernels and biases:
    the BN-folded runtime tree (numpy f32, the JAX layout) that
    ``RuntimeSegNet``, ``TiledInferer`` and ``serialization.save_model``
    take. conv(W * gamma / sqrt(var + eps)) + (beta - mean * scale), as the
    JAX ``fold_batchnorm``; leaves may be tensors or numpy arrays."""

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32)) if not isinstance(
            a, torch.Tensor) else a.detach().to("cpu", torch.float32)

    folded: Params = {}
    for block, conv, _shape in conv_layers(config):
        bn = params[block][_bn_name(conv)]
        st = bn_stats[block][_bn_name(conv)]
        scale = t(bn["gamma"]) / torch.sqrt(t(st["var"]) + _BN_EPS)
        folded.setdefault(block, {})[conv] = {
            "w": (t(params[block][conv]) * scale).numpy(),
            "b": (t(bn["beta"]) - t(st["mean"]) * scale).numpy(),
        }
    folded["head"] = {"w": t(params["head"]["w"]).numpy().copy(),
                      "b": t(params["head"]["b"]).numpy().copy()}
    return folded
