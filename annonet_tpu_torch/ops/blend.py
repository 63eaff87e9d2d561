"""K4: blend the tile logits, normalise, take the gains argmax and the
detection seeds, in one pass.

``blend_argmax_plain`` is the JAX float path's epilogue written in torch
(``infer/core.py:512-552``): per class, the ramp-weighted tiles are added
onto a zeroed canvas in tile order, the sum is multiplied by the
precomputed 1/wsum (skipped under ``reference_blend``), and the first
maximum of ``blended + gains`` is the label. A seed is a non-background
pixel whose blended margin over class 0 exceeds its class's detection
level margin over class 0's.

``blend_dtype`` bfloat16 is the int8 path's blend (infer/core.py:403-493):
logit and ramp rounded to bf16, each product and each add of the tile-order
sum rounded to bf16, then ``acc * inv_wsum + gains`` with every product and
sum rounded to bf16, and the seeds' differences too. ``wsum_factors``
(wy [Hp], wx [Wp]: tiling.weight_sum_factors) selects the argmax fold of
the int8 path without detection, ``argmax(acc + (gains * wy) * wx)``,
which skips the normalisation; it runs in either blend dtype.

``blend_argmax`` launches the CUDA kernel of ``csrc/blend.cu`` for CUDA
tensors (its labels and seeds equal the plain version's bit for bit) and
returns the plain version for CPU tensors.

Logits are the net's output, ``[T*M, th, tw, K]`` f32 with the tile index
major (row ``t*M + m`` is tile t of image m, as the JAX tile gather
stacks them); ``tile_yx`` is ``[T, 2]`` int32 (top-left corners);
``ramp`` ``[th, tw]`` and ``inv_wsum`` ``[Hp, Wp]`` f32; ``gains`` and
``det_levels`` ``[K]`` f32. Returns labels ``[M, Hp, Wp]`` (uint8, int32
when K > 255) and seeds ``[M, Hp, Wp]`` bool, or None without detection.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from annonet_tpu_torch.ops import _build


def _label_dtype(k: int) -> torch.dtype:
    return torch.uint8 if k <= 255 else torch.int32


def blend_accumulate_plain(
    logits, tile_yx, ramp, hp: int, wp: int, dtype=torch.float32
) -> torch.Tensor:
    """The ramp-weighted tile sum ``[K, M, Hp, Wp]`` in ``dtype``: per
    class, each tile's ``logits * ramp`` (both rounded to ``dtype``) added
    onto a zeroed canvas in tile order (the accumulation of
    ``pallas_blend.blend_accumulate``)."""
    n = tile_yx.shape[0]
    m = logits.shape[0] // n
    th, tw = ramp.shape
    k = logits.shape[-1]
    tiles = logits.view(n, m, th, tw, k)
    ramp = ramp.to(dtype)
    acc = torch.zeros((k, m, hp, wp), dtype=dtype, device=logits.device)
    for c in range(k):
        weighted = tiles[..., c].to(dtype) * ramp  # [n, m, th, tw]
        for i, (y, x) in enumerate(tile_yx.tolist()):
            acc[c, :, y : y + th, x : x + tw] += weighted[i]
    return acc


def blend_argmax_plain(
    logits, tile_yx, ramp, inv_wsum, gains, det_levels, *,
    with_detection: bool, reference_blend: bool,
    blend_dtype: torch.dtype = torch.float32, wsum_factors=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    hp, wp = inv_wsum.shape
    k = logits.shape[-1]
    bd = blend_dtype
    acc = blend_accumulate_plain(logits, tile_yx, ramp, hp, wp, bd)
    g = gains.to(bd)[:, None, None, None]
    if reference_blend:
        blended = acc
        scores = acc + g
    elif wsum_factors is not None:
        wy, wx = (f.to(bd) for f in wsum_factors)
        blended = acc
        scores = acc + (g * wy[None, None, :, None]) * wx
    else:
        blended = acc * inv_wsum.to(bd)  # [K, M, Hp, Wp]
        scores = blended + g
    labels = torch.argmax(scores, dim=0)
    if not with_detection:
        return labels.to(_label_dtype(k)), None
    det = det_levels.to(bd)
    label_output = torch.gather(blended, 0, labels[None])[0]
    seeds = (labels > 0) & (label_output - blended[0] > det[labels] - det[0])
    return labels.to(_label_dtype(k)), seeds


def _check(logits, tile_yx, ramp, inv_wsum, gains, det_levels, blend_dtype,
           wsum_factors, with_detection, reference_blend):
    if logits.dim() != 4 or tile_yx.dim() != 2 or tile_yx.shape[1] != 2:
        raise ValueError("blend_argmax: expected logits [T*M,th,tw,K], tile_yx [T,2]")
    n, k = tile_yx.shape[0], logits.shape[-1]
    if n == 0 or logits.shape[0] % n:
        raise ValueError(
            f"blend_argmax: {logits.shape[0]} logit tiles is not a multiple "
            f"of {n} tile positions"
        )
    if tuple(ramp.shape) != tuple(logits.shape[1:3]) or inv_wsum.dim() != 2:
        raise ValueError("blend_argmax: ramp must be [th, tw], inv_wsum [Hp, Wp]")
    if tuple(gains.shape) != (k,) or tuple(det_levels.shape) != (k,):
        raise ValueError(f"blend_argmax: gains and det_levels must be [{k}]")
    if blend_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"blend_argmax: unsupported blend_dtype {blend_dtype}")
    factors = ()
    if wsum_factors is not None:
        if with_detection or reference_blend:
            raise ValueError(
                "blend_argmax: the argmax fold (wsum_factors) runs without "
                "detection and without reference_blend"
            )
        factors = tuple(wsum_factors)
        if [tuple(f.shape) for f in factors] != [(d,) for d in inv_wsum.shape]:
            raise ValueError("blend_argmax: wsum_factors must be wy [Hp] and wx [Wp]")
    for t in (logits, ramp, inv_wsum, gains, det_levels, *factors):
        if t.dtype != torch.float32:
            raise ValueError("blend_argmax: logits, ramp, inv_wsum, gains, "
                             "det_levels and wsum_factors must be float32")
    if tile_yx.dtype != torch.int32:
        raise ValueError("blend_argmax: tile_yx must be int32")
    for t in (logits, tile_yx, ramp, inv_wsum, gains, det_levels, *factors):
        if t.device != logits.device or not t.is_contiguous():
            raise ValueError(
                f"blend_argmax: all tensors must be contiguous on {logits.device}"
            )
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"blend_argmax: unsupported device {logits.device}")


def blend_argmax(
    logits, tile_yx, ramp, inv_wsum, gains, det_levels, *,
    with_detection: bool, reference_blend: bool,
    blend_dtype: torch.dtype = torch.float32, wsum_factors=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    _check(logits, tile_yx, ramp, inv_wsum, gains, det_levels, blend_dtype,
           wsum_factors, with_detection, reference_blend)
    if logits.device.type == "cpu":
        return blend_argmax_plain(
            logits, tile_yx, ramp, inv_wsum, gains, det_levels,
            with_detection=with_detection, reference_blend=reference_blend,
            blend_dtype=blend_dtype, wsum_factors=wsum_factors,
        )
    n = tile_yx.shape[0]
    m = logits.shape[0] // n
    th, tw = ramp.shape
    hp, wp = inv_wsum.shape
    k = logits.shape[-1]
    wy, wx = (0, 0) if wsum_factors is None else (f.data_ptr() for f in wsum_factors)
    labels = torch.empty((m, hp, wp), dtype=_label_dtype(k), device=logits.device)
    seeds = (
        torch.empty((m, hp, wp), dtype=torch.bool, device=logits.device)
        if with_detection else None
    )
    blend_argmax.launches += 1
    with torch.cuda.device(logits.device):
        code = _build.lib().annonet_blend_argmax(
            logits.data_ptr(), tile_yx.data_ptr(), ramp.data_ptr(),
            inv_wsum.data_ptr(), gains.data_ptr(), det_levels.data_ptr(), wy, wx,
            labels.data_ptr(), 0 if seeds is None else seeds.data_ptr(),
            n, m, th, tw, hp, wp, k, int(k > 255), int(with_detection),
            int(reference_blend), int(blend_dtype == torch.bfloat16),
            torch.cuda.current_stream(logits.device).cuda_stream,
        )
    _build.check(code, "annonet_blend_argmax")
    return labels, seeds


blend_argmax.launches = 0
