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

Topology (``L = level_count``), ``topology="segnet"`` (annonet's net, the
default, widths ``base_width * 2**min(level, 3)``):
    stem:   conv3x3 -> ReLU, conv3x3 -> ReLU                     (width w0)
    enc i:  conv3x3 s2 -> ReLU, conv3x3 -> ReLU                  (width wi)
    dec i:  2x2 transpose-conv s2 -> ReLU, concat skip,
            conv3x3 -> ReLU                                      (width w(i-1))
    head:   conv1x1 -> class_count logits (f32)

``topology="unet"`` (Ronneberger et al. 2015, arXiv:1505.04597, Fig. 1, with
the same padding and the batch norm of the public PyTorch U-Net,
github.com/milesial/Pytorch-UNet; widths ``base_width * 2**level``):
    stem:   conv3x3 -> ReLU, conv3x3 -> ReLU                     (width w0)
    enc i:  maxpool 2x2, conv3x3 -> ReLU, conv3x3 -> ReLU        (width wi)
    dec i:  2x2 transpose-conv s2 + bias (linear), concat skip,
            conv3x3 -> ReLU, conv3x3 -> ReLU                     (width w(i-1))
    head:   conv1x1 -> class_count logits (f32)
``layer_plan`` writes both down once, as the sequence of steps that every
forward, parameter tree and the receptive field walk.
The concat is [up, skip] as in annonet's net (milesial's is [skip, up]:
the same function up to a permutation of the decoder conv0's input
channels). A U-Net artifact is the port's alone: its ``model_config``
carries ``topology``, which the JAX package does not read. The U-Net runs
on the float paths only (``RuntimeSegNet``, ``apply_train``); the int8,
folded and G1 paths refuse it (``require_segnet``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from annonet_tpu_torch.ops.bn_relu import BN_EPS, bn_relu_shards
from annonet_tpu_torch.ops.conv import (
    conv3x3_bias_relu,
    conv3x3_s2_bias_relu,
    up2x2_bias,
    up2x2_bias_relu,
)
from annonet_tpu_torch.ops.pool import max_pool2x2
from annonet_tpu_torch.utils.profiling import span

Params = Dict[str, Any]

#: the architectures: annonet's net (the default) and the U-Net
TOPOLOGIES = ("segnet", "unet")


@dataclasses.dataclass(frozen=True)
class SegNetConfig:
    """Architecture configuration: field for field the JAX package's, and
    ``topology``, the port's own. At its default, "segnet", ``to_dict``
    leaves it out, so an artifact's ``model_config`` reads into either
    package; a "unet" config is the port's alone."""

    class_count: int = 2
    level_count: int = 2
    width_scaler: float = 1.0
    min_filter_count: int = 1
    grayscale: bool = False
    base_width: int = 16
    compute_dtype: str = "bfloat16"
    topology: str = "segnet"

    def __post_init__(self):
        if self.topology not in TOPOLOGIES:
            raise ValueError(f"unknown topology {self.topology!r}: one of {TOPOLOGIES}")

    @property
    def unet(self) -> bool:
        return self.topology == "unet"

    @property
    def in_channels(self) -> int:
        return 1 if self.grayscale else 3

    def width(self, level: int) -> int:
        """Filter count at pyramid level ``level`` (0 = full resolution):
        the widths double at each level, up to level 3 in annonet's net."""
        base = self.base_width * (2 ** (level if self.unet else min(level, 3)))
        return max(self.min_filter_count, int(round(base * self.width_scaler)))

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        if not self.unet:
            del d["topology"]
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "SegNetConfig":
        return SegNetConfig(**d)


# --------------------------------------------------------------------------
# The layer plan: the one description of the net's topology
# --------------------------------------------------------------------------

#: conv -> BN -> ReLU (a transpose conv when the conv is "up"); in the
#: BN-folded runtime net, conv + bias -> ReLU
UNIT = "unit"
#: the U-Net's up layer: a 2x2 stride-2 transpose conv + bias, no BN, no ReLU
LINEAR_UP = "linear_up"
POOL = "pool"  # 2x2 max pool
KEEP_SKIP = "keep_skip"  # push the activation on the skip stack
CONCAT_SKIP = "concat_skip"  # pop a skip: the next conv's input is [x, skip]
HEAD = "head"  # 1x1 conv -> class_count logits (f32)


class Step(NamedTuple):
    """One step of the forward. A conv step (UNIT, LINEAR_UP) and the head
    carry their block, conv name, HWIO kernel shape and stride (2: the
    downsampling 3x3 conv and the transpose conv); the structural steps
    carry nothing."""

    op: str
    block: str = ""
    conv: str = ""
    shape: tuple = ()
    stride: int = 1

    @property
    def up(self) -> bool:
        """A 2x2 stride-2 transpose conv."""
        return self.conv == "up"

    @property
    def bn(self) -> str:
        """The BN layer after the conv: conv0 -> bn0, conv1 -> bn1, up -> bnu."""
        return "bnu" if self.up else self.conv.replace("conv", "bn")

    def receptive(self, lo: int, hi: int) -> Tuple[int, int]:
        """The interval of outputs that inputs ``lo..hi`` reach: a 3x3 conv
        widens it by one; a stride-2 3x3 conv pads (0, 1), so output o taps
        inputs 2o..2o+2; a 2x2 max pool maps u to u // 2; the transpose
        conv maps u to {2u, 2u+1}; the skips and the 1x1 head keep it."""
        if self.op == POOL:
            return lo // 2, hi // 2
        if self.up:
            return 2 * lo, 2 * hi + 1
        if self.op != UNIT:
            return lo, hi
        if self.stride == 2:
            return -(-(lo - 2) // 2), hi // 2
        return lo - 1, hi + 1


@functools.lru_cache(maxsize=None)
def layer_plan(config: SegNetConfig) -> Tuple[Step, ...]:
    """The net's forward, stem to head, as steps (the topology in the
    module docstring); built once per config. The decoder level i's skip
    is the encoder level i - 1's output, kept before that level's
    downsampling."""
    L, width, unet = config.level_count, config.width, config.unet
    w0 = width(0)
    steps = [Step(UNIT, "stem", "conv0", (3, 3, config.in_channels, w0)),
             Step(UNIT, "stem", "conv1", (3, 3, w0, w0))]
    for i in range(1, L + 1):
        cin, cout = width(i - 1), width(i)
        steps += [Step(KEEP_SKIP), Step(POOL)] if unet else [Step(KEEP_SKIP)]
        steps += [Step(UNIT, f"enc{i}", "conv0", (3, 3, cin, cout), 1 if unet else 2),
                  Step(UNIT, f"enc{i}", "conv1", (3, 3, cout, cout))]
    for i in range(L, 0, -1):
        cin, cout = width(i), width(i - 1)
        steps += [Step(LINEAR_UP if unet else UNIT, f"dec{i}", "up", (2, 2, cin, cout), 2),
                  Step(CONCAT_SKIP),
                  Step(UNIT, f"dec{i}", "conv0", (3, 3, 2 * cout, cout))]
        if unet:
            steps.append(Step(UNIT, f"dec{i}", "conv1", (3, 3, cout, cout)))
    steps.append(Step(HEAD, "head", shape=(1, 1, w0, config.class_count)))
    return tuple(steps)


def _conv_steps(config: SegNetConfig) -> Iterator[Step]:
    return (step for step in layer_plan(config) if step.op in (UNIT, LINEAR_UP))


def _head_shape(config: SegNetConfig) -> tuple:
    """The head's HWIO kernel shape (1, 1, width(0), class_count)."""
    return layer_plan(config)[-1].shape


def required_input_dimension(config: SegNetConfig) -> int:
    """Worst-case receptive field of one output pixel, in input pixels:
    the influence interval of one input pixel through the plan's steps,
    maximized over the 2**level_count parity classes."""
    L = config.level_count
    best = 1
    base = 4 ** (L + 2)  # keep all intermediate indices positive
    for parity in range(2**L):
        lo = hi = base + parity
        for step in layer_plan(config):
            lo, hi = step.receptive(lo, hi)
        best = max(best, hi - lo + 1)
    return best


def require_segnet(config: SegNetConfig, path: str) -> None:
    """Raise ValueError where ``path`` (the int8, folded and G1 paths) meets
    a U-Net config: they compute annonet's net alone."""
    if config.unet:
        raise ValueError(
            f"{path} supports annonet's SegNet topology only; the U-Net runs on "
            "the float paths (annonet_infer and annonet_train without int8, "
            "folding or use_pallas_conv)"
        )


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
    for step in _conv_steps(config):
        yield step.block, step.conv, step.shape


def runtime_param_shapes(config: SegNetConfig) -> Dict[str, tuple]:
    """{"block/conv/leaf": shape} of the BN-folded runtime tree: the keys
    (under "params/") and shapes an artifact must hold."""
    shapes = {}
    for step in _conv_steps(config):
        shapes[f"{step.block}/{step.conv}/w"] = step.shape
        shapes[f"{step.block}/{step.conv}/b"] = (step.shape[-1],)
    head = _head_shape(config)
    shapes["head/w"], shapes["head/b"] = head, (head[-1],)
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
    for step in _conv_steps(config):
        block, conv, (kh, kw, cin, cout) = step.block, step.conv, step.shape
        std = (2.0 / (kh * kw * cin)) ** 0.5
        w = rng.standard_normal((kh, kw, cin, cout)).astype(np.float32) * std
        if step.op == LINEAR_UP:  # no batch norm to fold
            tree.setdefault(block, {})[conv] = {
                "w": w, "b": (rng.standard_normal(cout) * 0.1).astype(np.float32)}
            continue
        gamma = rng.uniform(0.5, 1.5, cout).astype(np.float32)
        beta = (rng.standard_normal(cout) * 0.1).astype(np.float32)
        mean = (rng.standard_normal(cout) * 0.1).astype(np.float32)
        var = rng.uniform(0.5, 1.5, cout).astype(np.float32)
        scale = gamma / np.sqrt(var + np.float32(BN_EPS))
        tree.setdefault(block, {})[conv] = {
            "w": (w * scale).astype(np.float32),
            "b": (beta - mean * scale).astype(np.float32),
        }
    _, _, w0, k = _head_shape(config)
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


def _check_input_shape(x: torch.Tensor, config: SegNetConfig) -> None:
    """[N,H,W,C] with the config's channels and H, W multiples of
    2**level_count, or ValueError."""
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
        _check_input_shape(x, self.config)
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
        x = normalize_input(x_uint8, self.dtype)
        skips: List[torch.Tensor] = []
        pending: Optional[torch.Tensor] = None  # the skip the next conv concats
        for step in layer_plan(self.config):
            if step.op == KEEP_SKIP:
                skips.append(x)
            elif step.op == CONCAT_SKIP:
                pending = skips.pop()
            elif step.op == POOL:
                x = max_pool2x2(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            elif step.op == HEAD:
                # compute-dtype product (f32 accumulation inside), then the
                # f32 bias promotes the logits to f32 (segnet.py:459-462)
                return torch.matmul(x, self.head_w).to(torch.float32) + self.head_b
            else:
                w, b = self.weights(step.block, step.conv)
                if step.up:
                    x = (up2x2_bias if step.op == LINEAR_UP else up2x2_bias_relu)(x, w, b)
                elif step.stride == 2:
                    x = conv3x3_s2_bias_relu(x, w, b)
                else:  # the decoder's concat([up, skip]) is the kernel's second input
                    x, pending = conv3x3_bias_relu(x, w, b, x2=pending), None
                if tap is not None:
                    tap(f"{step.block}/{step.conv}", x)
        raise AssertionError("the plan ends in the head")  # pragma: no cover


# --------------------------------------------------------------------------
# Training: the BN net's state, its forward with batch statistics, the fold
# --------------------------------------------------------------------------
#
# The training tree is the JAX package's (segnet.py:171-219), numpy f32
# leaves with the same names and shapes, so a sync file carries across:
#   params[block] = {conv: HWIO kernel, bn: {"gamma", "beta"}, ...},
#   params["head"] = {"w": [1, 1, w0, K], "b": [K]},
#   bn_stats[block] = {bn: {"mean", "var"}, ...}.
# The U-Net's up layer has no batch norm: params[block]["up_bias"] [cout]
# is its bias, and neither tree has a "bnu".
# On the device the same trees hold f32 tensors (the master parameters);
# the convs run in the compute dtype on casts of them.


def train_state_shapes(config: SegNetConfig) -> Dict[str, Dict[str, tuple]]:
    """{"params": {"block/leaf path": shape}, "bn_stats": {...}}: the keys
    and shapes (all f32) of the training tree; the velocity tree has the
    params' (the JAX package's ``init_state`` layout)."""
    params: Dict[str, tuple] = {}
    stats: Dict[str, tuple] = {}
    for step in _conv_steps(config):
        block, bn, c = step.block, step.bn, step.shape[-1]
        params[f"{block}/{step.conv}"] = step.shape
        if step.op == LINEAR_UP:
            params[f"{block}/up_bias"] = (c,)
            continue
        params[f"{block}/{bn}/gamma"] = params[f"{block}/{bn}/beta"] = (c,)
        stats[f"{block}/{bn}/mean"] = stats[f"{block}/{bn}/var"] = (c,)
    head = _head_shape(config)
    params["head/w"], params["head/b"] = head, (head[-1],)
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
    for step in _conv_steps(config):
        block, c = step.block, step.shape[-1]
        params.setdefault(block, {})[step.conv] = he(step.shape)
        if step.op == LINEAR_UP:
            params[block]["up_bias"] = np.zeros(c, np.float32)
            continue
        params[block][step.bn] = {
            "gamma": np.ones(c, np.float32), "beta": np.zeros(c, np.float32),
        }
        stats.setdefault(block, {})[step.bn] = {
            "mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32),
        }
    head = _head_shape(config)
    params["head"] = {"w": he(head), "b": np.zeros(head[-1], np.float32)}
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


def _conv_transpose_train(x, w, dtype, bias=None):
    """The 2x2 stride-2 transpose conv: out[2i+u, 2j+v] = x[i, j] .
    w[1-u, 1-v] (lax.conv_transpose flips nothing; conv_transpose2d's
    kernel is the flipped one). ``bias`` (the U-Net's linear up layer) is
    cast to the compute dtype and added in the same call."""
    wt = torch.flip(w, dims=(0, 1)).permute(2, 3, 0, 1).to(dtype)
    return F.conv_transpose2d(x, wt, bias=None if bias is None else bias.to(dtype), stride=2)


def _bn_update(stats: Params, mean, var, momentum: float) -> Params:
    return {
        "mean": stats["mean"] * momentum + mean.detach() * (1.0 - momentum),
        "var": stats["var"] * momentum + var.detach() * (1.0 - momentum),
    }


def exact_convs(xs, ws, stride: int, dtype, reducer=None):
    """The training 3x3 conv of every shard in ``xs`` with its kernel in
    ``ws`` (``_conv_train``): the default ``conv_impl`` of ``apply_train``."""
    return [_conv_train(x, w, stride, dtype) for x, w in zip(xs, ws)]


def _unit(*args, up: bool, stride: int, dtype, conv_impl, reducer):
    """conv (or transpose conv) -> BN with batch statistics -> ReLU over
    the shards: ``args`` are the shards' inputs, then their kernels,
    gammas and betas (n of each). Returns (shards, mean, var)."""
    n = len(args) // 4
    xs, ws, gammas, betas = (list(args[i * n:(i + 1) * n]) for i in range(4))
    with span("conv_forward"):
        if up:
            hs = [_conv_transpose_train(x, w, dtype) for x, w in zip(xs, ws)]
        else:
            hs = conv_impl(xs, ws, stride, dtype, reducer)
    with span("bn"):
        return bn_relu_shards(hs, gammas, betas, reducer)


def apply_train(
    params,
    bn_stats: Params,
    x_uint8,
    config: SegNetConfig,
    bn_momentum: float = 0.99,
    remat: bool = False,
    conv_impl: Optional[Callable] = None,
    reducer=None,
) -> Tuple[Any, Params]:
    """Training forward with batch-stat BN: [N,H,W,C] uint8 -> (logits
    [N,H,W,K] f32, new running statistics); the counterpart of the JAX
    ``apply_train``. ``params`` and ``bn_stats`` are trees of f32 tensors
    on the input's device; the convs run in the compute dtype on casts of
    the f32 kernels (through autograd: cuDNN on the card, not the
    inference kernels K1-K3, which have no backward); each unit's batch
    norm and ReLU run as ``ops/bn_relu.py``'s op (its CUDA kernels on the
    card; ``bn_relu_shards``). ``remat``
    recomputes each conv + BN + ReLU unit in the backward pass
    (torch.utils.checkpoint, as jax.checkpoint per unit).

    ``conv_impl(xs, ws, stride, dtype, reducer) -> list`` replaces the 3x3
    convs of the stem, encoder and decoder (``exact_convs`` by default;
    ``ops/int8_train.py``'s straight-through int8 conv); the transpose
    convs and the head stay exact, as in the JAX package.

    The forward walks ``layer_plan``: the U-Net's pools run
    ``ops/pool.py``'s 2x2 max pool (each in a ``pool`` span), its linear up
    layers run inside ``conv_forward`` spans, outside any unit.

    ``reducer`` (``parallel/train.py``'s ``ShardReducer``) makes this the
    data-parallel forward: ``x_uint8`` and ``params`` are then lists over
    the mesh's local shards (each shard's input and its own copy of the
    parameters, on its device), every BN layer takes its statistics over
    all shards of the mesh (sync BN), and the logits come back as a list."""
    shards = list(x_uint8) if reducer is not None else [x_uint8]
    trees = list(params) if reducer is not None else [params]
    for x in shards:
        _check_input_shape(x, config)
    dtype = compute_dtype(config)
    conv_impl = exact_convs if conv_impl is None else conv_impl
    new_stats: Params = {k: dict(v) for k, v in bn_stats.items()}

    def run_unit(xs, step):
        ps = [t[step.block] for t in trees]
        args = (*xs, *(p[step.conv] for p in ps), *(p[step.bn]["gamma"] for p in ps),
                *(p[step.bn]["beta"] for p in ps))
        fn = functools.partial(_unit, up=step.up, stride=step.stride, dtype=dtype,
                               conv_impl=conv_impl, reducer=reducer)
        if remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    # NHWC uint8 -> NCHW view (channels_last in memory): cuDNN's NHWC convs
    xs = [normalize_input(x, dtype).permute(0, 3, 1, 2) for x in shards]
    skips = []
    for step in layer_plan(config):
        if step.op == UNIT:
            xs, mean, var = run_unit(xs, step)
            s = new_stats[step.block]
            s[step.bn] = _bn_update(s[step.bn], mean, var, bn_momentum)
        elif step.op == KEEP_SKIP:
            skips.append(xs)
        elif step.op == CONCAT_SKIP:
            xs = [torch.cat([x, skip], dim=1) for x, skip in zip(xs, skips.pop())]
        elif step.op == POOL:
            with span("pool"):
                xs = [max_pool2x2(x) for x in xs]
        elif step.op == LINEAR_UP:
            with span("conv_forward"):
                xs = [_conv_transpose_train(x, t[step.block]["up"], dtype,
                                            t[step.block]["up_bias"])
                      for x, t in zip(xs, trees)]
        else:  # HEAD
            logits = []
            with span("conv_forward"):
                for x, t in zip(xs, trees):
                    # compute-dtype head, then the f32 bias promotes the logits to f32
                    out = _conv_train(x, t["head"]["w"], 1, dtype) + t["head"]["b"][:, None, None]
                    logits.append(out.to(torch.float32).permute(0, 2, 3, 1))
            return (logits if reducer is not None else logits[0]), new_stats
    raise AssertionError("the plan ends in the head")  # pragma: no cover


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
    for step in _conv_steps(config):
        block, conv = step.block, step.conv
        if step.op == LINEAR_UP:
            folded.setdefault(block, {})[conv] = {
                "w": t(params[block][conv]).numpy().copy(),
                "b": t(params[block]["up_bias"]).numpy().copy()}
            continue
        bn = params[block][step.bn]
        st = bn_stats[block][step.bn]
        scale = t(bn["gamma"]) / torch.sqrt(t(st["var"]) + BN_EPS)
        folded.setdefault(block, {})[conv] = {
            "w": (t(params[block][conv]) * scale).numpy(),
            "b": (t(bn["beta"]) - t(st["mean"]) * scale).numpy(),
        }
    folded["head"] = {"w": t(params["head"]["w"]).numpy().copy(),
                      "b": t(params["head"]["b"]).numpy().copy()}
    return folded
