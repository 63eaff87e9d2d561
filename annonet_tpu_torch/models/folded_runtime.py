"""The folded inference net of ``TiledInferer(use_pallas_conv=True)``.

The port of the inference half of ``annonet_tpu/models/folded_runtime.py``
as ``fold_runtime_params(..., pallas_s1=True)`` builds it: the tile batch is
width-folded at ``fold0`` (``fold0`` adjacent pixels side by side in the
channel dim, a free view of NHWC), the fold halves through each stride-2
encoder stage and doubles through each 2x upsample, and every stride-1 3x3
layer at a fold above 1 is an ``s1p:<fold>:<cin>`` entry: G1
(``ops/gemm_conv.py``) with the ``(Wc, Wl, Wr)`` of
``build_gemm_kernels_aligned`` on the folded view and their table of nonzero
blocks (``g1_block_table``), made once per layer. The decoder's concat
[up, skip] in folded layout is not the NHWC concat, so its G1 weights carry
the concat permutation inside each dy group (``folded_runtime.py:195-200``).

The layers that the JAX package leaves to XLA on folded kernels (``s2``,
``up``, a stride-1 layer at fold 1, the head) run here on the NHWC view
with the unfolded weights, through K2, K3, K1 and the head matmul: a folded
``s2`` or ``up`` output is exactly the NHWC output viewed at the next fold,
so this is the same function without the fold's redundant FLOPs.

``FoldedSegNet``: [N,H,W,C] uint8 -> [N,H,W,K] f32 logits, the function of
``apply_folded_split`` with ``folded_output=False``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from annonet_tpu_torch.models.segnet import (
    RuntimeSegNet,
    SegNetConfig,
    compute_dtype,
    normalize_input,
    require_segnet,
)
from annonet_tpu_torch.ops.conv import (
    conv3x3_bias_relu,
    conv3x3_s2_bias_relu,
    up2x2_bias_relu,
)
from annonet_tpu_torch.ops.gemm_conv import (
    build_gemm_kernels_aligned,
    conv3x3_gemm_aligned,
    g1_block_table,
)

# (spec entry, runtime layer "block/conv" or None, fold at the layer's input)
Entry = Tuple[str, Optional[str], int]


def folding_supported(config: SegNetConfig, tile_width: int) -> int:
    """The base fold for this config and tile width, or 0 when folding does
    not apply (``folded_runtime.py:458-478``): the largest of 8, 4, 2 that
    divides the tile width with fold * width(0) <= 128, and at least
    2**level_count, so that the fold survives every stride-2 level. The
    U-Net never folds."""
    if config.unet:
        return 0
    fold = 8
    while fold > 1 and (tile_width % fold or fold * config.width(0) > 128):
        fold //= 2
    if fold < (1 << config.level_count):
        return 0
    return fold if fold > 1 else 0


def _concat_perm(fold: int, c1: int, c2: int) -> np.ndarray:
    """Row permutation from the concat of two folded tensors
    ([i*c1 + c ...] then [fold*c1 + i*c2 + c ...]) to the packed folded
    layout (i*(c1+c2) + c): W_actual[a] = W_packed[perm[a]]."""
    perm = np.empty(fold * (c1 + c2), np.int64)
    for a in range(fold * c1):
        i, c = divmod(a, c1)
        perm[a] = i * (c1 + c2) + c
    for a2 in range(fold * c2):
        i, c = divmod(a2, c2)
        perm[fold * c1 + a2] = i * (c1 + c2) + c1 + c
    return perm


def folded_entries(config: SegNetConfig, fold0: int) -> List[Entry]:
    """The layer walk of ``fold_runtime_params(..., pallas_s1=True)``."""
    entries: List[Entry] = []
    f = fold0

    def s1(name: str, cin: int):
        entries.append((f"s1p:{f}:{cin}" if f > 1 else "s1_plain", name, f))

    cin = config.in_channels
    if f > 1 and cin == 1:
        # grayscale: the JAX package pads the stem input to 3 channels (a
        # TPU compile-time fix); the padded weight rows are zero
        cin = 3
        entries.append(("pad_input:3", None, f))
    s1("stem/conv0", cin)
    s1("stem/conv1", config.width(0))
    entries.append(("save_skip:0", None, f))
    folds = {0: f}
    L = config.level_count
    for i in range(1, L + 1):
        entries.append(("s2" if f >= 2 else "s2_plain", f"enc{i}/conv0", f))
        f = f // 2 if f >= 2 else f
        s1(f"enc{i}/conv1", config.width(i))
        folds[i] = f
        if i < L:
            entries.append((f"save_skip:{i}", None, f))
    for i in range(L, 0, -1):
        entries.append(("up", f"dec{i}/up", f))
        f *= 2
        if f != folds[i - 1]:
            raise ValueError(
                f"fold0 {fold0} does not survive {L} stride-2 levels "
                "(see folding_supported)"
            )
        entries.append((f"concat_skip:{i - 1}", None, f))
        s1(f"dec{i}/conv0", 2 * config.width(i - 1))
    entries.append(("head", "head", f))
    return entries


def folded_spec(config: SegNetConfig, fold0: int) -> Tuple[int, Tuple[str, ...]]:
    """(fold0, spec): JAX's ``split_folded(fold_runtime_params(...,
    pallas_s1=True))[0]``."""
    return fold0, tuple(kind for kind, _name, _f in folded_entries(config, fold0))


def _unfold_from_jax_layer(kind: str, a, b, f: int):
    """The unfolded (w, b) of a JAX folded layer entry: the folded kernels
    are copies of the unfolded taps (``folded_runtime.py:84-144``)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if kind == "s2":  # [3, 2, f*cin, (f/2)*cout]: tap dx sits at block dx//f
        cin, cout = a.shape[2] // f, a.shape[3] // (f // 2)
        w = np.stack([a[:, dx // f, (dx % f) * cin : (dx % f + 1) * cin, :cout]
                      for dx in range(3)], axis=1)
        return w, b[:cout]
    if kind == "up":  # [2, 1, f*cin, 2f*cout]: column v*cout holds w[q, 1-v]
        cin, cout = a.shape[2] // f, a.shape[3] // (2 * f)
        w = np.stack([a[:, 0, :cin, (1 - kx) * cout : (2 - kx) * cout]
                      for kx in range(2)], axis=1)
        return w, b[:cout]
    if kind == "head":  # class-major [1, 1, f*cin, f*K]: class co at co*f + i
        cin = a.shape[2] // f
        return a[:, :, :cin, ::f], b[::f]
    return a, b  # s2_plain, s1_plain: unfolded already


def folded_params_from_numpy(
    source: Any, config: SegNetConfig, fold0: int, device
) -> Dict[str, torch.Tensor]:
    """The folded net's tensors on ``device``: {"block/conv/wc|wl|wr|b"} for
    the s1p layers (G1's triples in the compute dtype, bias f32 [cout]) and
    {"block/conv/w|b"} for the others (unfolded HWIO weights; the head as a
    [C, K] matrix), laid out as ``runtime_params_from_numpy`` lays them.

    ``source`` is the BN-folded runtime tree (numpy or array leaves), or what
    JAX's ``fold_runtime_params(..., pallas_s1=True)`` returns (its dict or
    its ``layers`` list), converted to numpy: then its ``(Wc, Wl, Wr)`` are
    used as they are."""
    dtype = compute_dtype(config)
    device = torch.device(device)
    entries = folded_entries(config, fold0)
    raw: Dict[str, np.ndarray] = {}
    layers = source.get("layers") if isinstance(source, dict) else source
    if isinstance(source, dict) and layers is None:  # the runtime tree
        for kind, name, f in entries:
            if name is None:
                continue
            block, _, conv = name.partition("/")
            node = source[block] if name == "head" else source[block][conv]
            w = np.asarray(node["w"], np.float32)
            b = np.asarray(node["b"], np.float32)
            if kind.startswith("s1p:"):
                cin = int(kind.split(":")[2])
                if cin > w.shape[2]:  # the grayscale stem's padded rows
                    w = np.concatenate(
                        [w, np.zeros((3, 3, cin - w.shape[2], w.shape[3]), np.float32)], 2)
                wc, wl, wr = build_gemm_kernels_aligned(w, f)
                if block.startswith("dec"):
                    perm = _concat_perm(f, cin // 2, cin // 2)
                    full = np.concatenate([perm + dy * f * cin for dy in range(3)])
                    wc, wl, wr = wc[full], wl[full], wr[full]
                raw.update({f"{name}/wc": wc, f"{name}/wl": wl, f"{name}/wr": wr})
            else:
                raw[f"{name}/w"] = w
            raw[f"{name}/b"] = b
    else:  # JAX's folded layer list
        kinds = [layer[0] for layer in layers]
        want = [kind.split(":")[0] if kind.split(":")[0] in
                ("pad_input", "save_skip", "concat_skip") else kind
                for kind, _n, _f in entries]
        if kinds != want:
            raise ValueError(f"layer kinds {kinds} do not match this config's walk {want}")
        for (kind, name, f), (_kind, a, b) in zip(entries, layers):
            if name is None:
                continue
            if kind.startswith("s1p:"):
                for key, m in zip(("wc", "wl", "wr"), a):
                    raw[f"{name}/{key}"] = np.asarray(m, np.float32)
                raw[f"{name}/b"] = np.asarray(b, np.float32)
            else:
                raw[f"{name}/w"], raw[f"{name}/b"] = _unfold_from_jax_layer(kind, a, b, f)
    out: Dict[str, torch.Tensor] = {}
    for key, value in raw.items():
        t = torch.tensor(value)  # a copy: the source arrays may be read-only
        if key == "head/w":
            t = t.reshape(t.shape[2], t.shape[3])
        is_bias = key.endswith("/b")
        out[key] = t.to(device=device, dtype=torch.float32 if is_bias else dtype).contiguous()
    return out


class FoldedSegNet(nn.Module):
    """Inference forward of the folded net: [N,H,W,C] uint8 -> [N,H,W,K]
    f32 logits (the counterpart of ``apply_folded_split`` on the spec of
    ``folded_spec``, with unfolded output)."""

    def __init__(self, source, config: SegNetConfig, fold0: int, *, device):
        super().__init__()
        require_segnet(config, "the folded runtime")
        self.config = config
        self.fold0 = fold0
        self.dtype = compute_dtype(config)
        self.entries = folded_entries(config, fold0)
        for key, t in folded_params_from_numpy(source, config, fold0, device).items():
            self.register_buffer(key.replace("/", "_"), t)
        # each G1 layer's table of nonzero weight blocks, built once
        for kind, name, _f in self.entries:
            if kind.startswith("s1p:"):
                self.register_buffer(f"{name.replace('/', '_')}_table", g1_block_table(
                    *(self.param(name, k) for k in ("wc", "wl", "wr"))))

    def param(self, name: str, leaf: str) -> torch.Tensor:
        return getattr(self, f"{name.replace('/', '_')}_{leaf}")

    def forward(
        self, x_uint8: torch.Tensor,
        tap: Optional[Callable[[str, torch.Tensor], None]] = None,
    ) -> torch.Tensor:
        """``tap(name, activation)``, when given, sees each conv and up
        layer's post-ReLU output in NHWC, as ``RuntimeSegNet.forward``'s."""
        RuntimeSegNet.check_input(self, x_uint8)
        if x_uint8.shape[2] % self.fold0:
            raise ValueError(
                f"input width {x_uint8.shape[2]} must be a multiple of the fold {self.fold0}"
            )
        if self.entries[0][0].startswith("pad_input"):
            n, h, w, c = x_uint8.shape
            x_uint8 = torch.cat([x_uint8, x_uint8.new_zeros((n, h, w, 3 - c))], dim=-1)
        x = normalize_input(x_uint8, self.dtype)
        skips: Dict[str, torch.Tensor] = {}
        pending: Optional[torch.Tensor] = None  # the skip the next conv concats
        for kind, name, f in self.entries:
            if name is None:
                marker, _, idx = kind.partition(":")
                if marker == "save_skip":
                    skips[idx] = x
                elif marker == "concat_skip":
                    pending = skips.pop(idx)
                continue
            if name == "head":
                # compute-dtype product, then the f32 bias (segnet.py:459-462)
                return torch.matmul(x, self.param(name, "w")).to(torch.float32) + \
                    self.param(name, "b")
            b = self.param(name, "b")
            if kind.startswith("s1p:"):
                n, h, w, c = x.shape
                xf = x.view(n, h, w // f, f * c)
                if pending is not None:
                    xf = torch.cat([xf, pending.view(n, h, w // f, -1)], dim=-1)
                    pending = None
                cin = xf.shape[3] // f
                x = conv3x3_gemm_aligned(
                    xf, self.param(name, "wc"), self.param(name, "wl"),
                    self.param(name, "wr"), b, f, cin, self.param(name, "table"),
                ).view(n, h, w, b.shape[0])
            elif kind == "s1_plain":
                x = conv3x3_bias_relu(x, self.param(name, "w"), b, x2=pending)
                pending = None
            elif kind in ("s2", "s2_plain"):
                x = conv3x3_s2_bias_relu(x, self.param(name, "w"), b)
            else:  # up
                x = up2x2_bias_relu(x, self.param(name, "w"), b)
            if tap is not None:
                tap(name, x)
        raise AssertionError("the folded walk ends in the head")  # pragma: no cover
