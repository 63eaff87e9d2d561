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


# --------------------------------------------------------------------------
# Folded training forward (kernels folded from the live weights each step)
# --------------------------------------------------------------------------
#
# The port of ``apply_train_folded`` (folded_runtime.py:590-722): the
# training forward in the width-folded layout, every conv at fold * c
# channels, with the folded kernels built from the f32 master kernels in
# the step (index scatters that autograd carries back to them). It computes
# ``apply_train``'s function (the same logits and statistics, summed in
# another order) and reaches no Pallas kernel in the JAX package; its convs
# here are cuDNN's. Activations are NCHW views of the folded NHWC layout
# [n, h, w / fold, fold * c] (channel i * c + k is pixel i of the group).

#: the input fold of folded training (JAX's ``fold0=8``)
TRAIN_FOLD0 = 8


def folded_training_applies(config: SegNetConfig, width: int, remat: bool) -> bool:
    """The JAX trainer's gate (trainer.py:121-131, parallel/train.py:62-76):
    not under remat, a crop width that divides by 8, and RGB input (the
    JAX package keeps grayscale unfolded)."""
    return not remat and width % TRAIN_FOLD0 == 0 and config.in_channels >= 3


def fold_width_kernel(w: torch.Tensor, fold: int) -> torch.Tensor:
    """HWIO [kh, 3, cin, cout] -> the folded [kh, 3, fold*cin, fold*cout]
    (``ops/folded_conv.py:36``): block dxb maps input pixel i of the group
    to output pixel j through tap fold * (dxb - 1) + i - j + 1 where it is
    0..2."""
    kh, kw, cin, cout = w.shape
    assert kw == 3, "width folding is implemented for 3-tap width kernels"
    i_idx = torch.arange(fold, device=w.device)[:, None]
    j_idx = torch.arange(fold, device=w.device)[None, :]
    blocks = []
    for dxb in range(3):
        kx = fold * (dxb - 1) + i_idx - j_idx + 1
        valid = (kx >= 0) & (kx <= 2)
        block = w[:, kx.clamp(0, 2)]  # [kh, fold, fold, cin, cout]
        block = torch.where(valid[None, :, :, None, None], block, torch.zeros_like(block))
        blocks.append(block.permute(0, 1, 3, 2, 4).reshape(kh, fold * cin, fold * cout))
    return torch.stack(blocks, dim=1)


def _fold_s2_kernel(w: torch.Tensor, fold: int) -> torch.Tensor:
    """The stride-(2, 1) kernel [3, 2, fold*cin, fold/2*cout] of a stride-2
    3x3 conv on a fold-``fold`` input (``_fold_s2_kernel_jnp``)."""
    _kh, _kw, cin, cout = w.shape
    half = fold // 2
    out = w.new_zeros((3, 2, fold * cin, half * cout))
    for dx in range(3):
        for j in range(half):
            i = 2 * j + dx
            out[:, i // fold, (i % fold) * cin:(i % fold + 1) * cin,
                j * cout:(j + 1) * cout] = w[:, dx]
    return out


def _fold_up_kernel(w: torch.Tensor, fold: int) -> torch.Tensor:
    """The [2, 1, fold*cin, 2*fold*cout] transpose kernel of the 2x2
    stride-2 up conv on a fold-``fold`` input (``_fold_up_kernel_jnp``)."""
    _kh, _kw, cin, cout = w.shape
    out = w.new_zeros((2, 1, fold * cin, 2 * fold * cout))
    for q in range(2):
        for v in range(2):
            for i in range(fold):
                j = 2 * i + v
                out[q, 0, i * cin:(i + 1) * cin, j * cout:(j + 1) * cout] = w[q, 1 - v]
    return out


def _fold_1x1_kernel(w: torch.Tensor, fold: int) -> torch.Tensor:
    _kh, _kw, cin, cout = w.shape
    out = w.new_zeros((1, 1, fold * cin, fold * cout))
    for i in range(fold):
        out[0, 0, i * cin:(i + 1) * cin, i * cout:(i + 1) * cout] = w[0, 0]
    return out


def _conv_hwio(x, w, stride, padding):
    """NCHW conv with an HWIO kernel; ``padding`` (top, bottom, left,
    right) applied explicitly."""
    top, bottom, left, right = padding
    if any(padding):
        x = torch.nn.functional.pad(x, (left, right, top, bottom))
    return torch.nn.functional.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)


def apply_train_folded(
    params,
    bn_stats,
    x_uint8,
    config: SegNetConfig,
    bn_momentum: float = 0.99,
    fold0: int = TRAIN_FOLD0,
    reducer=None,
):
    """Width-folded training forward (``apply_train_folded``): the function
    of ``segnet.apply_train`` with every conv on the folded layout, the
    folded kernels made from the live f32 weights (cast to the compute
    dtype first). ``reducer`` as for ``apply_train``: ``x_uint8`` is then
    the list of the mesh's shards and the logits a list."""
    from annonet_tpu_torch.models.segnet import _bn_train, _bn_update, _check_train_input

    require_segnet(config, "folded training")
    shards = list(x_uint8) if reducer is not None else [x_uint8]
    trees = list(params) if reducer is not None else [params]
    for x in shards:
        _check_train_input(x, config)
    dtype = compute_dtype(config)
    L = config.level_count
    new_stats = {k: dict(v) for k, v in bn_stats.items()}

    def convs(xs, wfs, stride, padding):
        return [_conv_hwio(x, wf, stride, padding) for x, wf in zip(xs, wfs)]

    def normalise(hs, block, bn_name, fold):
        ps = [t[block][bn_name] for t in trees]
        hs, mean, var = _bn_train(hs, [p["gamma"] for p in ps], [p["beta"] for p in ps],
                                  reducer, fold)
        s = new_stats[block]
        s[bn_name] = _bn_update(s[bn_name], mean, var, bn_momentum)
        return [torch.relu(h).to(dtype) for h in hs]

    def unit(xs, block, conv_name, bn_name, kind, fold):
        ws = [t[block][conv_name].to(dtype) for t in trees]
        if kind == "s1":
            hs = convs(xs, [fold_width_kernel(w, fold) for w in ws], 1, (1, 1, 1, 1))
            fold_out = fold
        elif kind == "s2" and fold > 1:
            hs = convs(xs, [_fold_s2_kernel(w, fold) for w in ws], (2, 1), (0, 1, 0, 1))
            fold_out = fold // 2
        elif kind == "s2":  # XLA's SAME at stride 2 on even sizes: (0, 1)
            hs, fold_out = convs(xs, ws, 2, (0, 1, 0, 1)), 1
        else:  # up: lax.conv_transpose (2, 1), no flip; conv_transpose2d flips
            hs = [torch.nn.functional.conv_transpose2d(
                x, torch.flip(_fold_up_kernel(w, fold), dims=(0, 1)).permute(2, 3, 0, 1),
                stride=(2, 1)) for x, w in zip(xs, ws)]
            fold_out = 2 * fold
        return normalise(hs, block, bn_name, fold_out), fold_out

    xs = []
    for x in shards:
        n, h, width, cin = x.shape
        assert width % fold0 == 0 and width >= fold0
        folded = normalize_input(x, dtype).reshape(n, h, width // fold0, fold0 * cin)
        xs.append(folded.permute(0, 3, 1, 2))
    f = fold0
    xs, f = unit(xs, "stem", "conv0", "bn0", "s1", f)
    xs, f = unit(xs, "stem", "conv1", "bn1", "s1", f)
    skips = [(xs, f)]
    for i in range(1, L + 1):
        xs, f = unit(xs, f"enc{i}", "conv0", "bn0", "s2", f)
        xs, f = unit(xs, f"enc{i}", "conv1", "bn1", "s1", f)
        if i < L:
            skips.append((xs, f))
    for i in range(L, 0, -1):
        xs, f = unit(xs, f"dec{i}", "up", "bnu", "up", f)
        skip_xs, skip_f = skips[i - 1]
        assert skip_f == f, (skip_f, f)
        xs = [torch.cat([x, sk], dim=1) for x, sk in zip(xs, skip_xs)]
        # the concat layout -> the packed folded layout: a row permutation
        c = config.width(i - 1)
        perm = torch.from_numpy(_concat_perm(f, c, c))
        wks = [fold_width_kernel(t[f"dec{i}"]["conv0"].to(dtype), f)[:, :, perm.to(x.device), :]
               for t, x in zip(trees, xs)]
        xs = normalise(convs(xs, wks, 1, (1, 1, 1, 1)), f"dec{i}", "bn0", f)
    logits = []
    for x, t in zip(xs, trees):
        out = _conv_hwio(x, _fold_1x1_kernel(t["head"]["w"].to(dtype), f), 1, (0, 0, 0, 0))
        n, _fk, h, wb = out.shape
        out = (out + t["head"]["b"].repeat(f)[:, None, None]).to(torch.float32)
        logits.append(out.permute(0, 2, 3, 1).reshape(n, h, wb * f, config.class_count))
    return (logits if reducer is not None else logits[0]), new_stats
