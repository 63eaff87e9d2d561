"""Tile-grid planning for large-image inference.

A copy of annonet_tpu/infer/tiling.py (which imports JAX through its
model module), planning exactly as the JAX package does for the same
``lane_align_tiles``; ``infer/core.py::plan_image`` chooses it as the JAX
default inferer does.

Geometry:
  * tile side = recommended_input_dimension(min(max_tile, image_dim)),
    shrunk to the smallest stride-aligned size that keeps the tile count;
  * tiles are placed on an evenly spread grid with >= overlap shared
    pixels, the last row/column flush to the canvas edge;
  * overlap must be >= the receptive field (required_input_dimension) so
    every output pixel is computed by at least one tile with full context;
  * the blend weight of a pixel is the product of two 1-D ramps of its
    distance to the tile edge (min(1, (j+1)/(ov+1), (T-j)/(ov+1))), and the
    blend is normalised by the per-plan weight sum (inverse_weight_sum).

Canvas sizes round up to buckets (bucket_dim), as in the JAX package,
where they let nearby image sizes share compiled programs; here they keep
the plans, and so the results, equal to the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from annonet_tpu_torch.models.segnet import SegNetConfig, recommended_input_dimension


def default_tile_max() -> int:
    """The auto max-tile dimension: 1024, the reference's default on its
    CUDA build (annonet_infer_main.cpp:300-307). Used by the CLI when
    -w/-h are unset and by TiledInferer when no TilingParameters are
    passed."""
    return 1024


@dataclasses.dataclass(frozen=True)
class TilingParameters:
    """Mirrors tiling::parameters (annonet_infer_main.cpp:423-427)."""

    max_tile_width: int = 1024
    max_tile_height: int = 1024
    overlap_x: int = 0
    overlap_y: int = 0


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """A static tiling of one (image_h, image_w) input."""

    image_height: int
    image_width: int
    padded_height: int  # replicate-padded canvas the tiles live on
    padded_width: int
    tile_height: int
    tile_width: int
    overlap_x: int
    overlap_y: int
    tile_yx: Tuple[Tuple[int, int], ...]  # top-left corner of each tile

    @property
    def tile_count(self) -> int:
        return len(self.tile_yx)


def _positions(image_dim: int, tile_dim: int, overlap: int) -> List[int]:
    """Grid offsets along one axis: the minimum number of tiles that covers
    the canvas with >= overlap shared pixels, spread EVENLY.

    A naive fixed-stride grid with a clamped last tile can nearly duplicate
    the final column (e.g. canvas 4224, tile 2048, stride 1986 -> last two
    tiles overlap by 1858 px); even spreading keeps the per-pair overlap
    uniform and minimal, which directly cuts redundant forward FLOPs.
    Interior positions snap down to multiples of 8, as in the JAX
    package (snapping down only increases overlap, never opens gaps).
    """
    if tile_dim >= image_dim:
        return [0]
    span = image_dim - tile_dim
    max_stride = max(1, tile_dim - overlap)
    count = -(-span // max_stride) + 1  # ceil division
    raw = [min(round(i * span / (count - 1)), span) for i in range(count)]
    # snap interior positions down to multiples of 8 when that cannot
    # break the overlap guarantee
    snapped = [
        p if i in (0, count - 1) else p - p % 8 for i, p in enumerate(raw)
    ]
    gaps_ok = all(
        b - a <= max_stride for a, b in zip(snapped, snapped[1:])
    )
    return snapped if gaps_ok else raw


def _round_up(value: int, multiple: int) -> int:
    return ((value + multiple - 1) // multiple) * multiple


def bucket_dim(dim: int, bucket: int) -> int:
    """Round an image dimension up to its bucket: fine (32) granularity
    for small images, ``bucket`` granularity for large ones."""
    if dim <= bucket:
        return _round_up(dim, 32)
    return _round_up(dim, bucket)


def _even_tile_dim(
    canvas: int, max_tile: int, overlap: int, config: SegNetConfig,
    lane_align: bool = True,
) -> int:
    """The smallest stride-aligned tile size that covers ``canvas`` with the
    same number of tiles a max-size tile would need.

    Using max-size tiles with a clamped tail wastes forward FLOPs on deep
    tail overlaps; shrinking all tiles to the even size keeps the tile
    count while minimizing total tile area (the reference instead expands
    each variable tile to its own aligned size, annonet_infer.cpp:49-66 —
    impossible here because one static shape serves the whole batch).
    """
    tile_max = recommended_input_dimension(config, min(max_tile, canvas))
    if tile_max >= canvas:
        return recommended_input_dimension(config, canvas)
    count = -(-(canvas - overlap) // (tile_max - overlap))
    while True:
        even = -(-(canvas - overlap) // count) + overlap
        tile = recommended_input_dimension(config, even)
        if lane_align and tile > 128:
            # the JAX unfolded inferer rounds large tiles up to 128
            tile = _round_up(tile, 128)
        else:
            tile = _round_up(tile, 8)
        tile = min(tile, tile_max)
        if (count - 1) * (tile - overlap) + tile >= canvas:
            return tile
        count += 1


def plan_tiles(
    image_height: int,
    image_width: int,
    config: SegNetConfig,
    params: TilingParameters,
    canvas_bucket: int = 128,
    lane_align_tiles: bool = True,
) -> TilePlan:
    """Plan the static tile grid for one image size.

    The padded canvas is rounded up to buckets (see bucket_dim); the extra
    rows/columns are replicate padding, discarded after the crop back to
    H x W.
    """
    bucketed_w = bucket_dim(image_width, canvas_bucket)
    bucketed_h = bucket_dim(image_height, canvas_bucket)
    tile_w = _even_tile_dim(
        bucketed_w, params.max_tile_width, params.overlap_x, config,
        lane_align=lane_align_tiles,
    )
    tile_h = _even_tile_dim(
        bucketed_h, params.max_tile_height, params.overlap_y, config,
        lane_align=lane_align_tiles,
    )
    padded_w = max(tile_w, bucketed_w)
    padded_h = max(tile_h, bucketed_h)

    xs = _positions(padded_w, tile_w, params.overlap_x)
    ys = _positions(padded_h, tile_h, params.overlap_y)
    tile_yx = tuple((y, x) for y in ys for x in xs)

    return TilePlan(
        image_height=image_height,
        image_width=image_width,
        padded_height=padded_h,
        padded_width=padded_w,
        tile_height=tile_h,
        tile_width=tile_w,
        overlap_x=params.overlap_x,
        overlap_y=params.overlap_y,
        tile_yx=tile_yx,
    )


def plan_for_counts(
    image_height: int,
    image_width: int,
    config: SegNetConfig,
    params: TilingParameters,
    count_y: int,
    count_x: int,
    canvas_bucket: int = 128,
    lane_align_tiles: bool = True,
) -> Optional[TilePlan]:
    """The minimum-area plan with an explicit tile-grid count per axis:
    the candidates of the measured plan autotune (infer/core.py), which
    times the default plan against its denser neighbours on the device.
    None when the count cannot give a distinct covering (a count too large
    for the overlap, or one that collapses to another count), or when a
    tile would exceed the caller's max (the max-tile flags stay a hard
    cap, as in the reference)."""

    def dim_for(canvas: int, count: int, overlap: int, max_tile: int):
        if count < 1:
            return None
        if count == 1:
            tile = recommended_input_dimension(config, canvas)
        else:
            even = -(-(canvas - overlap) // count) + overlap
            tile = recommended_input_dimension(config, even)
            if lane_align_tiles and tile > 128:
                tile = _round_up(tile, 128)
            else:
                tile = _round_up(tile, 8)
            if tile >= canvas:
                return None  # this count degenerates to one tile
            if (count - 1) * (tile - overlap) + tile < canvas:
                return None  # cannot cover: the overlap is too deep
        if tile > max_tile:
            return None
        return tile

    bucketed_w = bucket_dim(image_width, canvas_bucket)
    bucketed_h = bucket_dim(image_height, canvas_bucket)
    tile_w = dim_for(bucketed_w, count_x, params.overlap_x, params.max_tile_width)
    tile_h = dim_for(bucketed_h, count_y, params.overlap_y, params.max_tile_height)
    if tile_w is None or tile_h is None:
        return None
    padded_w = max(tile_w, bucketed_w)
    padded_h = max(tile_h, bucketed_h)
    xs = _positions(padded_w, tile_w, params.overlap_x)
    ys = _positions(padded_h, tile_h, params.overlap_y)
    if len(xs) != count_x or len(ys) != count_y:
        return None  # the even grid for this count collapsed to another
    return TilePlan(
        image_height=image_height,
        image_width=image_width,
        padded_height=padded_h,
        padded_width=padded_w,
        tile_height=tile_h,
        tile_width=tile_w,
        overlap_x=params.overlap_x,
        overlap_y=params.overlap_y,
        tile_yx=tuple((y, x) for y in ys for x in xs),
    )


def _ramp_1d(n: int, ov: int, dtype=np.float32) -> np.ndarray:
    """The 1-D edge-distance blend ramp (reference get_t,
    annonet_infer.cpp:102-114)."""
    j = np.arange(n, dtype=dtype)
    return np.minimum(
        1.0, np.minimum((j + 1.0) / (ov + 1.0), (n - j) / (ov + 1.0))
    )


def ramp_weights(tile_h: int, tile_w: int, overlap_y: int, overlap_x: int) -> np.ndarray:
    """The shared [tile_h, tile_w] float32 blend-weight map: the separable
    product of 1-D edge-distance ramps (annonet_infer.cpp:102-114)."""
    return (
        _ramp_1d(tile_h, overlap_y)[:, None]
        * _ramp_1d(tile_w, overlap_x)[None, :]
    )


def inverse_weight_sum(plan: TilePlan) -> np.ndarray:
    """Precomputed 1 / sum-of-ramps over the padded canvas.

    The blend denominator depends only on the tile layout, not on the image
    content, so it is computed once per plan on the host.
    """
    ramp = ramp_weights(
        plan.tile_height, plan.tile_width, plan.overlap_y, plan.overlap_x
    )
    wsum = np.zeros((plan.padded_height, plan.padded_width), np.float64)
    for y, x in plan.tile_yx:
        wsum[y : y + plan.tile_height, x : x + plan.tile_width] += ramp
    return (1.0 / np.maximum(wsum, 1e-12)).astype(np.float32)


def weight_sum_factors(plan: TilePlan):
    """1-D factors of the blend denominator, wsum(y, x) = wy(y) * wx(x).

    The ramp is a separable product and a grid plan's tiles are ys x xs, so
    the ramp sum factorises exactly. The int8 path's argmax fold
    (ops/blend.py) adds the gains scaled by these factors instead of
    normalising the blended canvas. Returns (wy [Hp], wx [Wp]) float32,
    summed in float64 and floored at 1e-6, or None for a tile layout that
    is not a grid.
    """
    ys = sorted({y for y, _ in plan.tile_yx})
    xs = sorted({x for _, x in plan.tile_yx})
    if set(plan.tile_yx) != {(y, x) for y in ys for x in xs}:
        return None

    wy = np.zeros(plan.padded_height, np.float64)
    rh = _ramp_1d(plan.tile_height, plan.overlap_y, np.float64)
    for y in ys:
        wy[y : y + plan.tile_height] += rh
    wx = np.zeros(plan.padded_width, np.float64)
    rw = _ramp_1d(plan.tile_width, plan.overlap_x, np.float64)
    for x in xs:
        wx[x : x + plan.tile_width] += rw
    return (
        np.maximum(wy, 1e-6).astype(np.float32),
        np.maximum(wx, 1e-6).astype(np.float32),
    )
