"""Tiled inference: tile batch forward, fused blend epilogue, host blob veto.

``annonet_tpu/infer/core.py``'s ``TiledInferer`` on one device, float
and int8 paths:

  1. edge-pad the image to the plan's canvas and gather the tiles
     ([T*M, th, tw, C], tile index major, as the JAX gather stacks them);
     on the int8 path the padded canvas is quantized once first and the
     int8 tiles are gathered from it;
  2. forward the tile batch through ``RuntimeSegNet`` (kernels K1-K3), the
     int8 ``QuantizedSegNet`` (Q1, Q2, K3's requant mode) or, with
     ``use_pallas_conv`` on a plan that folds, the folded ``FoldedSegNet``
     (G1, K1-K3), in chunks when the activations would not fit;
  3. K4 (``ops.blend.blend_argmax``): ramp-weighted blend in tile order,
     1/wsum normalisation (or the raw ramp sum under
     ``reference_blend_semantics``), gains argmax, detection seeds; in
     bf16 when ``blend_dtype`` says so (the int8 path's default), with the
     argmax fold on the int8 net without detection;
  4. crop back to H x W, copy to the host, and there veto seedless
     blobs (``detection_veto``). With ``device_output=True`` the labels
     and seeds of the padded canvas stay on the device, as the JAX
     package returns them; ``HostReadback`` then crops them there and
     starts their copy to the host without waiting for it.

int8 (``quantize="int8"``, models/quantized.py): the first
``calibration_images`` images of each fold key run the float net and
record per-channel activation maxima; then the int8 net is frozen and
every later image runs it. A preloaded ``calibration`` freezes it at once.
As in the JAX package, int8 applies only to plans whose tile width folds
(``folding_supported``); other plans run the float net, which the inferer says
once on stderr and counts in ``float_fallbacks``. Blending in bf16 follows
the same rule as in the JAX package, where the bf16 blend exists only on
the folded layout: it applies when the plan folds.

``use_pallas_conv`` (float only, as in the JAX package) runs the folded
net of ``models/folded_runtime.py`` on every plan whose tile width folds
(``folding_supported``), one net per base fold, and the unfolded net on
the others, as the JAX inferer falls back to ``apply_runtime``.

Plans come from ``infer/tiling.py`` as the JAX default (folded) inferer
makes them (``plan_image``): without the lane round-up when the config
folds. The JAX folded inferer's count-cliff bump (``core.py:816-833``, a
plan heuristic measured on the TPU's XLA conv emitters) is not ported, so
the plans differ where an axis has exactly 3 tiles (the 2300x1500 image's
columns, for one). Gains enter the
argmax in logit space after normalisation; seeds compare gain-free
blended margins (annonet_infer.cpp:170-212, PARITY.md's documented
deviation and its compat mode).

``plan_autotune`` is the JAX inferer's measured plan selection: the first
image of each canvas bucket times the default plan and the denser grids
(``plan_for_counts`` at one and two more tiles per axis) on the device,
and every later image of the bucket runs the fastest. ``compiled_programs``
counts the plans whose constants the inferer holds, the counterpart of the
JAX inferer's compiled XLA programs (``len(inferer._compiled)``) that
``annonet_serve`` reports.

``mesh`` (a tuple of devices, ``parallel/mesh.py``) is tile-parallel
inference, the JAX inferer's sharding of the tile batch over a mesh: every
net the inferer builds (the float net, the folded nets, the int8 nets with
their packed weights) is replicated on each mesh device; the tile batch,
gathered on ``mesh[0]``, is split in tile order (``torch.tensor_split``),
each shard is forwarded on its own device in its own chunks, and the
logits are gathered back onto ``mesh[0]`` in tile order, where K4 blends
them. Calibration runs on ``mesh[0]``. Labels and seeds equal the
unsharded inferer's bit for bit: every tile's logits are computed the same
way whatever shard or chunk it runs in (see ``_forward_shard``).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from annonet_tpu_torch.infer.tiling import (
    TilePlan,
    TilingParameters,
    bucket_dim,
    default_tile_max,
    inverse_weight_sum,
    plan_for_counts,
    plan_tiles,
    ramp_weights,
    weight_sum_factors,
)
from annonet_tpu_torch.models.folded_runtime import FoldedSegNet, folding_supported
from annonet_tpu_torch.models.quantized import (
    QuantizedSegNet,
    calibration_layout,
    collect_calibration,
    quantize_input,
    quantize_net,
)
from annonet_tpu_torch.models.segnet import (
    RuntimeSegNet,
    SegNetConfig,
    required_input_dimension,
)
from annonet_tpu_torch.ops.blend import blend_argmax
from annonet_tpu_torch.ops.blobs import label_connected_blobs

# canvases round up to 128-pixel buckets, as in the JAX package
_CANVAS_BUCKET = 128
# live-activation budget of one forward; larger tile batches run in chunks
FORWARD_BUDGET_BYTES = 8 << 30
# the most tiles in one forward on the CPU, where every forward of a tile
# batch has the same size (``TiledInferer._forward_shard``)
CPU_TILE_GROUP = 32
_BLEND_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def default_tiling(config: SegNetConfig) -> TilingParameters:
    """The inferer's tiling when none is given: the reference's CUDA tile
    max (1024) and the net's receptive field as the overlap."""
    tile_max = default_tile_max()
    overlap = required_input_dimension(config)
    return TilingParameters(tile_max, tile_max, overlap, overlap)


def _lane_align(config: SegNetConfig) -> bool:
    """JAX's default (folded) inferer rounds tiles up to a multiple of 128
    only when the config does not fold (``annonet_tpu/infer/core.py:771-780``)."""
    return not folding_supported(config, 8 * 128)


def plan_image(image_height: int, image_width: int, config: SegNetConfig,
               tiling: TilingParameters) -> TilePlan:
    """The inferer's plan, as JAX's default (folded) inferer makes it: a
    config that folds needs tiles that divide the fold, so a 4096x4096
    image plans to 25 tiles of 872x872 with the flagship. JAX's
    count-cliff bump (``annonet_tpu/infer/core.py:816-833``) is not
    ported: the two plans differ where an axis has exactly 3 tiles."""
    return plan_tiles(
        image_height, image_width, config, tiling, canvas_bucket=_CANVAS_BUCKET,
        lane_align_tiles=_lane_align(config),
    )


def _edge_pad(x: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """Replicate-pad [M, H, W, C] to [M, hp, wp, C] (annonet_infer.cpp:71-75)."""
    m, h, w, c = x.shape
    if (h, w) == (hp, wp):
        return x
    yi = torch.arange(hp, device=x.device).clamp_(max=h - 1)
    xi = torch.arange(wp, device=x.device).clamp_(max=w - 1)
    return x.index_select(1, yi).index_select(2, xi)


class TiledInferer:
    """Holds a runtime net on one device and runs tiled inference on
    arbitrary images (the counterpart of annonet_tpu's TiledInferer)."""

    def __init__(
        self,
        runtime_params,
        config: SegNetConfig,
        tiling: Optional[TilingParameters] = None,
        *,
        device=None,  # the inferer's device; with a mesh, mesh[0]
        quantize: Optional[str] = None,  # "int8" = the quantized net
        calibration_images: int = 1,
        calibration=None,  # per-layer maxima (export_calibration / file)
        blend_dtype=None,  # None = auto: bfloat16 iff int8
        reference_blend_semantics: bool = False,
        mesh=None,  # devices to split the tile batch over (parallel.make_mesh)
        use_pallas_conv: Optional[bool] = None,  # None = False: the folded net (G1)
        plan_autotune: bool = False,
    ):
        if quantize not in (None, "int8"):
            raise ValueError(f"unsupported quantize mode: {quantize!r}")
        if quantize and use_pallas_conv:
            raise ValueError("quantize is incompatible with use_pallas_conv")
        self.use_pallas_conv = bool(use_pallas_conv)
        # base fold -> {device: the folded net on that device}
        self._folded: Dict[int, Dict[torch.device, FoldedSegNet]] = {}
        if mesh is not None:
            try:
                mesh = tuple(torch.device(d) for d in mesh)
            except (TypeError, RuntimeError) as e:
                raise ValueError(
                    "mesh must be a sequence of devices (parallel.make_mesh)"
                ) from e
            if not mesh:
                raise ValueError("mesh must hold at least one device")
            if device is not None and torch.device(device) != mesh[0]:
                raise ValueError(
                    f"device {device} is not the mesh's first device {mesh[0]}"
                )
            device = mesh[0]
        if device is None:
            raise ValueError("TiledInferer needs a device (or a mesh)")
        self.mesh = mesh
        self.quantize = quantize
        if calibration_images < 1:
            raise ValueError("calibration_images must be >= 1")
        self.calibration_images = calibration_images
        if blend_dtype is None:
            blend_dtype = "bfloat16" if quantize else "float32"
        if blend_dtype not in _BLEND_DTYPES:
            raise ValueError(f"unsupported blend_dtype: {blend_dtype!r}")
        self.blend_dtype = _BLEND_DTYPES[blend_dtype]
        if calibration is not None and quantize is None:
            raise ValueError("calibration requires quantize='int8'")
        self.device = torch.device(device)
        self._shards = mesh if mesh is not None else (self.device,)
        # each distinct device of the mesh holds one replica of every net
        self._replica_devices = tuple(dict.fromkeys(self._shards))
        self.config = config
        self.runtime_params = runtime_params
        self._nets = self._replicate(lambda d: RuntimeSegNet(runtime_params, config, device=d))
        self.net = self._nets[self.device]
        if tiling is None:
            tiling = default_tiling(config)
        if tiling.overlap_x < 0 or tiling.overlap_y < 0:
            raise ValueError("tile overlap must be non-negative")
        self.tiling = tiling
        self.reference_blend_semantics = bool(reference_blend_semantics)
        self._plan_constants: Dict[TilePlan, Tuple] = {}
        self.plan_autotune = bool(plan_autotune)
        # canvas bucket (h, w) -> the chosen plan, and the measurements
        # behind each choice: [(plan, Mpx/s), ...] fastest first
        self._autotune_cache: Dict[Tuple[int, int], TilePlan] = {}
        self.autotune_reports: Dict[Tuple[int, int], list] = {}
        self._plan_override: Optional[TilePlan] = None
        self._autotuning = False
        # int8 state per fold key, as in the JAX package: calibration
        # maxima accumulate per key and freeze into an int8 net
        self._preloaded_calib = (
            [np.asarray(v, np.float32) for v in calibration]
            if calibration is not None else None
        )
        # base fold -> {device: the frozen int8 net on that device}
        self._quantized: Dict[int, Dict[torch.device, QuantizedSegNet]] = {}
        self._calib_accum: Dict[int, List[np.ndarray]] = {}
        self._calib_seen: Dict[int, int] = {}
        self._calib_frozen: Dict[int, List[np.ndarray]] = {}
        self._calibration_paused = False
        # int8 calls that ran the float net because their plan does not fold
        self.float_fallbacks = 0

    def update_params(self, runtime_params) -> None:
        """Swap in a runtime tree of the same architecture (a new
        checkpoint: annonet_train's validation after each save). The plan
        constants stay; what the old weights made goes: the folded nets,
        the int8 nets, the calibration (it restarts as in a fresh
        inferer) and any preloaded calibration, which was fingerprinted
        to the old weights."""
        self.runtime_params = runtime_params
        self._nets = self._replicate(
            lambda d: RuntimeSegNet(runtime_params, self.config, device=d))
        self.net = self._nets[self.device]
        self._folded.clear()
        self._quantized.clear()
        self._calib_accum.clear()
        self._calib_seen.clear()
        self._calib_frozen.clear()
        self._preloaded_calib = None

    def _replicate(self, make) -> Dict[torch.device, torch.nn.Module]:
        """{device: make(device)} over the mesh's distinct devices."""
        return {d: make(d) for d in self._replica_devices}

    @property
    def compiled_programs(self) -> int:
        """The plans whose constants this inferer holds: what the JAX
        inferer's compiled programs count (one per plan it has run)."""
        return len(self._plan_constants)

    def plan(self, image_height: int, image_width: int) -> TilePlan:
        if self._plan_override is not None:
            return self._plan_override
        if self.plan_autotune:
            chosen = self._autotune_cache.get((
                bucket_dim(image_height, _CANVAS_BUCKET),
                bucket_dim(image_width, _CANVAS_BUCKET),
            ))
            if chosen is not None:
                return chosen
        return plan_image(image_height, image_width, self.config, self.tiling)

    def autotune_candidates(self, image_height: int, image_width: int) -> List[TilePlan]:
        """The plans the autotune times for this canvas: the default plan,
        then the grids with one and with two more tiles per axis that
        exist under the max-tile cap (JAX ``core.py:861-876``)."""
        default = self.plan(image_height, image_width)
        ny = len({y for y, _ in default.tile_yx})
        nx = len({x for _, x in default.tile_yx})
        candidates = [default]
        for dy, dx in ((1, 1), (2, 2)):
            p = plan_for_counts(
                image_height, image_width, self.config, self.tiling, ny + dy, nx + dx,
                canvas_bucket=_CANVAS_BUCKET, lane_align_tiles=_lane_align(self.config),
            )
            if p is not None and p not in candidates:
                candidates.append(p)
        return candidates

    def _autotune_for(self, image: np.ndarray) -> None:
        """Time each candidate plan on this image's canvas and cache the
        fastest for every later image of its bucket (JAX ``core.py:836-925``)."""
        h, w = image.shape[:2]
        key = (bucket_dim(h, _CANVAS_BUCKET), bucket_dim(w, _CANVAS_BUCKET))
        if key in self._autotune_cache:
            return
        candidates = self.autotune_candidates(h, w)
        if len(candidates) == 1:
            self._autotune_cache[key] = candidates[0]
            self.autotune_reports[key] = [(candidates[0], 0.0)]
            return
        results = self._time_plans(image, candidates)
        results.sort(key=lambda t: -t[0])
        self._autotune_cache[key] = results[0][1]
        self.autotune_reports[key] = [(p, r) for r, p in results]

    def _time_plans(self, image: np.ndarray, plans,
                    iters: Optional[int] = None) -> List[Tuple[float, TilePlan]]:
        """[(Mpx/s, plan)] of each plan on this image's canvas, in order.

        The image is edge-padded to its bucket and uploaded once; each
        plan runs once to warm up (its plan constants, and on the int8
        path the calibration, on the first plan), then ``iters`` calls
        (default ANNONET_TPU_AUTOTUNE_ITERS, else 3) are timed: by CUDA
        events on the card, by the host clock on the CPU."""
        h, w = image.shape[:2]
        key = (bucket_dim(h, _CANVAS_BUCKET), bucket_dim(w, _CANVAS_BUCKET))
        padded = np.pad(image, ((0, key[0] - h), (0, key[1] - w), (0, 0)), mode="edge")
        on_device = self._upload(padded)
        if iters is None:
            iters = int(os.environ.get("ANNONET_TPU_AUTOTUNE_ITERS", "3"))
        iters = max(1, iters)
        cuda = self.device.type == "cuda"
        results = []
        self._autotuning = True
        try:
            for p in plans:
                self._plan_override = p
                try:
                    self._infer(padded, False, None, None, True)
                    if cuda:
                        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                        events[0].record(torch.cuda.current_stream(self.device))
                    t0 = time.perf_counter()
                    for _ in range(iters):
                        self._infer(on_device, False, None, None, True)
                    if cuda:
                        events[1].record(torch.cuda.current_stream(self.device))
                        events[1].synchronize()
                        elapsed = events[0].elapsed_time(events[1]) / 1e3
                    else:
                        elapsed = time.perf_counter() - t0
                finally:
                    self._plan_override = None
                results.append((h * w * iters / 1e6 / max(elapsed, 1e-9), p))
        finally:
            self._autotuning = False
        return results

    def _constants(self, plan: TilePlan):
        """(ramp, inv_wsum, tile_yx, wsum factors or None) of a plan, on the
        device, made once."""
        constants = self._plan_constants.get(plan)
        if constants is None:
            ramp = ramp_weights(
                plan.tile_height, plan.tile_width, plan.overlap_y, plan.overlap_x
            )
            to = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
            factors = weight_sum_factors(plan)
            constants = (
                to(ramp),
                to(inverse_weight_sum(plan)),
                to(np.asarray(plan.tile_yx, np.int32).reshape(-1, 2)),
                None if factors is None else tuple(to(f) for f in factors),
            )
            self._plan_constants[plan] = constants
        return constants

    def _chunk(self, plan: TilePlan, n: int) -> int:
        """Tiles per forward: the whole batch unless ~16 bytes of live
        activations per stem channel per tile pixel would exceed
        FORWARD_BUDGET_BYTES (the JAX package's estimate), then as many as
        fit; the last chunk may be shorter."""
        per_px = max(1, self.config.width(0)) * 16
        max_tiles = FORWARD_BUDGET_BYTES // (per_px * plan.tile_height * plan.tile_width)
        return max(1, min(n, max_tiles))

    def _upload(self, images) -> torch.Tensor:
        if not isinstance(images, torch.Tensor):
            images = np.ascontiguousarray(images)
            if not images.flags.writeable:  # torch wants writable memory
                images = images.copy()
            images = torch.from_numpy(images)
        return images.to(self.device)

    def _tile_batch(self, images, plan: TilePlan, quantized: bool = False) -> torch.Tensor:
        """[M, H, W, C] uint8 (host array or tensor) -> the tile batch
        [T*M, th, tw, C] on the device: upload, edge-pad to the canvas,
        on the int8 path quantize the canvas once, gather the tiles (tile
        index major, as the JAX gather stacks them)."""
        x = self._upload(images)
        m, c = x.shape[0], x.shape[3]
        th, tw = plan.tile_height, plan.tile_width
        padded = _edge_pad(x, plan.padded_height, plan.padded_width)
        if quantized:
            padded = quantize_input(padded)
        return torch.stack(
            [padded[:, y : y + th, x0 : x0 + tw] for y, x0 in plan.tile_yx]
        ).reshape(plan.tile_count * m, th, tw, c)

    def _blend(self, logits, plan: TilePlan, gains, detection_levels,
               with_detection: bool, quantized: bool = False):
        """K4 on the tile logits: (labels [M, Hp, Wp], seeds or None);
        ``gains`` and ``detection_levels`` are [K] float32 on the device.

        As in the JAX package, the bf16 blend and the argmax fold exist
        only on the folded layout: they apply when the plan folds and its
        tiles sit on fold-aligned columns."""
        ramp, inv_wsum, tile_yx, factors = self._constants(plan)
        fold0 = folding_supported(self.config, plan.tile_width)
        folded = fold0 > 0 and all(x % fold0 == 0 for _, x in plan.tile_yx)
        argmax_fold = (
            folded and quantized and not with_detection
            and not self.reference_blend_semantics and factors is not None
        )
        return blend_argmax(
            logits, tile_yx, ramp, inv_wsum, gains, detection_levels,
            with_detection=with_detection,
            reference_blend=self.reference_blend_semantics,
            blend_dtype=self.blend_dtype if folded else torch.float32,
            wsum_factors=factors if argmax_fold else None,
        )

    def _float_nets(self, plan: TilePlan) -> Dict[torch.device, torch.nn.Module]:
        """The float net for a plan on each mesh device: the folded net of
        its base fold under ``use_pallas_conv`` when the plan folds, else
        the unfolded net."""
        fold0 = folding_supported(self.config, plan.tile_width) if self.use_pallas_conv else 0
        if not fold0:
            return self._nets
        if fold0 not in self._folded:
            self._folded[fold0] = self._replicate(
                lambda d: FoldedSegNet(self.runtime_params, self.config, fold0, device=d))
        return self._folded[fold0]

    def _float_net(self, plan: TilePlan):
        """The float net for a plan on the inferer's device (``mesh[0]``)."""
        return self._float_nets(plan)[self.device]

    def _forward(self, tiles: torch.Tensor, plan: TilePlan,
                 quantized: bool = False) -> torch.Tensor:
        """The tile batch's f32 logits on the inferer's device, through the
        frozen int8 net of the plan's fold (``quantized``) or the float net.
        Under a mesh the batch is split in tile order, each shard is
        forwarded on its own device, and the logits are gathered in tile
        order: a copy between two CUDA devices waits for the work queued
        on both devices' current streams, so the gather waits for each
        shard's forward."""
        if quantized:
            nets = self._quantized[folding_supported(self.config, plan.tile_width)]
        else:
            nets = self._float_nets(plan)
        group = None
        if tiles.device.type == "cpu":
            group = min(CPU_TILE_GROUP, tiles.shape[0], self._chunk(plan, CPU_TILE_GROUP))
        if len(self._shards) == 1:
            return self._forward_shard(tiles, plan, nets[self.device], group)
        # a mesh wider than the batch leaves its last shards empty
        logits = [
            self._forward_shard(shard.to(d), plan, nets[d], group)
            for shard, d in zip(torch.tensor_split(tiles, len(self._shards)), self._shards)
            if shard.shape[0]
        ]
        return torch.cat([part.to(self.device) for part in logits])

    def _forward_shard(self, tiles: torch.Tensor, plan: TilePlan, net,
                       group: Optional[int] = None) -> torch.Tensor:
        """One shard's logits on its own device, in ``_chunk``'s chunks, or
        with ``group`` (on the CPU) in forwards of exactly ``group`` tiles,
        the last one padded with copies of the shard's last tile.

        The CPU's group is the whole tile batch's size (at most
        CPU_TILE_GROUP, and what the budget allows), whatever the shard:
        the plain versions' convolutions and products (oneDNN, the CPU
        BLAS) choose their blocking by batch size, so a tile's logits would
        depend on the batch it ran in (in the last bits: a level-3,
        width-16 net on four 96-px tiles, tests/test_torch_parallel_infer.py's
        deep case), and the labels on how the batch was sharded. At one
        batch size they depend on neither the tile's place in the batch nor
        its neighbours. Unsharded, a batch of up to CPU_TILE_GROUP tiles is
        one forward, unpadded. The kernels on the card compute each tile's
        pixels the same way at any batch size."""
        n = tiles.shape[0]
        if group is not None:
            chunk, pad = group, -n % group
            if pad:
                tiles = torch.cat([tiles, tiles[-1:].expand(pad, *tiles.shape[1:])])
        else:
            chunk = self._chunk(plan, n)
        if chunk == tiles.shape[0]:
            return net(tiles)[:n]
        logits = torch.empty(
            (tiles.shape[0], plan.tile_height, plan.tile_width, self.config.class_count),
            dtype=torch.float32, device=tiles.device,
        )
        for s in range(0, tiles.shape[0], chunk):
            logits[s : s + chunk] = net(tiles[s : s + chunk])
        return logits[:n]

    # ------------------------------------------------------------- int8

    def _collect_calib(self, plan: TilePlan, image) -> List[np.ndarray]:
        """Per-channel activation maxima of one [H, W, C] image: up to 4
        tiles spread over the plan (first and last included), through the
        float net (models/quantized.collect_calibration)."""
        positions = list(plan.tile_yx)
        if len(positions) > 4:
            idx = np.linspace(0, len(positions) - 1, 4).round().astype(int)
            positions = [positions[i] for i in dict.fromkeys(idx)]
        x = self._upload(image)[None]
        padded = _edge_pad(x, plan.padded_height, plan.padded_width)[0]
        th, tw = plan.tile_height, plan.tile_width
        tiles = torch.stack([padded[y : y + th, x0 : x0 + tw] for y, x0 in positions])
        return collect_calibration(self.net, tiles)

    def _freeze(self, fold0: int, calibration) -> None:
        self._calib_frozen[fold0] = calibration
        qparams = quantize_net(self.runtime_params, self.config, calibration)
        self._quantized[fold0] = self._replicate(
            lambda d: QuantizedSegNet(qparams, self.config, device=d))

    def _ensure_quantized(self, fold0: int, plan: TilePlan, image) -> None:
        """Accumulate one image's calibration maxima; freeze the int8 net
        once ``calibration_images`` images have contributed (a preloaded
        calibration freezes it at once)."""
        if fold0 in self._quantized:
            return
        if self._preloaded_calib is not None:
            self._freeze(fold0, self._preloaded_calib)
            return
        calib = self._collect_calib(plan, image)
        accum = self._calib_accum.get(fold0)
        if accum is not None:
            calib = [np.maximum(a, c) for a, c in zip(accum, calib)]
        self._calib_accum[fold0] = calib
        self._calib_seen[fold0] = self._calib_seen.get(fold0, 0) + 1
        if self._calib_seen[fold0] >= self.calibration_images:
            self._freeze(fold0, calib)

    def export_calibration(self, partial: bool = False):
        """The frozen per-layer, per-channel activation maxima (merged by
        element-wise max over fold keys), or None before any freeze.
        ``partial`` also includes accumulations that have not frozen yet.
        Save with serialization.save_calibration; pass back as
        ``calibration=`` to run int8 from the first image."""
        sources = list(self._calib_frozen.values())
        if partial:
            sources.extend(self._calib_accum.values())
        if not sources:
            return None
        merged = None
        for frozen in sources:
            vecs = [np.asarray(v, np.float32) for v in frozen]
            merged = vecs if merged is None else [
                np.maximum(a, b) for a, b in zip(merged, vecs)
            ]
        return merged

    def calibration_layer_shapes(self):
        """Per-layer lengths of the export_calibration vectors (an
        architecture property), or None when this config cannot fold, so
        int8 never applies."""
        if not (self._calib_accum or self._calib_frozen) and not folding_supported(
            self.config, 64
        ):
            return None
        return [length for _name, length in calibration_layout(self.config)]

    def pause_calibration(self):
        """Context manager: images inferred inside neither contribute to
        nor freeze the int8 calibration (synthetic warm-up traffic must not
        set the scales); they run the float net until a freeze and int8
        after it."""

        @contextlib.contextmanager
        def _pause():
            prev = self._calibration_paused
            self._calibration_paused = True
            try:
                yield self
            finally:
                self._calibration_paused = prev

        return _pause()

    def calibration_overshoot(self, image) -> float:
        """Clip-saturation telemetry: the max over layers and channels of
        (this image's activation max) / (calibrated max); 1.0 fits exactly,
        2.0 means some channel reaches twice its calibrated range and is
        clipped. 0.0 before any freeze or for a plan without one."""
        if not self._calib_frozen:
            return 0.0
        h, w = image.shape[:2]
        plan = self.plan(h, w)
        frozen = self._calib_frozen.get(folding_supported(self.config, plan.tile_width))
        if frozen is None:
            return 0.0
        worst = 0.0
        for cal, frz in zip(self._collect_calib(plan, image), frozen):
            if cal.size == 0 or frz.size == 0:
                continue
            mask = frz > 0
            if mask.any():
                worst = max(worst, float((cal[mask] / frz[mask]).max()))
        return worst

    def _int8_net(self, images, plan: TilePlan):
        """The frozen int8 net for this plan on the inferer's device
        (calibrating on this call's images first while the freeze is
        pending), or None when the call runs the float net."""
        if not self.quantize:
            return None
        fold0 = folding_supported(self.config, plan.tile_width)
        if not fold0:
            if not self.float_fallbacks:
                print(
                    f"annonet_tpu_torch: int8 does not apply to the "
                    f"{plan.tile_height}x{plan.tile_width} tile plan (its "
                    "width does not fold for this net, as in the JAX "
                    "package); running the float net for such plans",
                    file=sys.stderr,
                )
            self.float_fallbacks += 1
            return None
        if fold0 not in self._quantized and not self._calibration_paused:
            # each call before the freeze contributes one image (or, when
            # batched, as many of the batch as calibration still needs)
            for one in images:
                self._ensure_quantized(fold0, plan, one)
                if fold0 in self._quantized:
                    break
        nets = self._quantized.get(fold0)
        return None if nets is None else nets[self.device]

    def infer_arrays(
        self,
        image,  # (H, W, C) uint8
        gains: Optional[Sequence[float]] = None,
        detection_levels: Optional[Sequence[float]] = None,
        device_output: bool = False,
    ):
        """One image: (labels [H, W] int32, seeds [H, W] bool or None).
        Seeds are produced only when a detection level is positive. With
        ``device_output=True`` the results of the padded canvas stay on the
        inferer's device, [Hp, Wp] tensors (labels uint8, or int32 above
        255 classes), as the JAX package returns them: for pipelines that
        start the copy to the host themselves (``HostReadback``)."""
        if image.ndim != 3 or image.shape[2] != self.config.in_channels:
            raise ValueError(
                f"expected (H, W, {self.config.in_channels}) input, "
                f"got {tuple(image.shape)}"
            )
        return self._infer(image, False, gains, detection_levels, device_output)

    def infer_arrays_batch(
        self,
        images,  # (M, H, W, C) uint8, same-size images
        gains: Optional[Sequence[float]] = None,
        detection_levels: Optional[Sequence[float]] = None,
        device_output: bool = False,
        pad_to_bucket=True,  # True | False | int target size: see below
    ):
        """M same-size images as one tile batch: (labels [M, H, W],
        seeds [M, H, W] or None). Per-image results equal infer_arrays.
        ``device_output=True`` keeps them on the device, [M, Hp, Wp] of the
        padded canvas, as infer_arrays does.

        ``pad_to_bucket`` is accepted, and validated, as the JAX package
        takes it (an int below M raises ValueError), and does nothing: the
        JAX inferer pads M up to a bucket so that odd batch sizes reuse
        compiled XLA programs, and PyTorch compiles nothing."""
        if images.ndim != 4 or images.shape[3] != self.config.in_channels:
            raise ValueError(
                f"expected (M, H, W, {self.config.in_channels}) input, "
                f"got {tuple(images.shape)}"
            )
        m = images.shape[0]
        if m < 1:
            raise ValueError("image batch must contain at least one image")
        if not isinstance(pad_to_bucket, bool) and int(pad_to_bucket) < m:
            raise ValueError(f"pad_to_bucket target {int(pad_to_bucket)} is below the "
                             f"batch size {m}")
        return self._infer(images, True, gains, detection_levels, device_output)

    def _infer(self, image, batched, gains, detection_levels, device_output=False):
        h, w = image.shape[-3:-1]
        k = self.config.class_count
        gains_arr = np.zeros(k, np.float32) if gains is None else np.asarray(
            gains, np.float32
        )
        det_arr = (
            np.zeros(k, np.float32)
            if detection_levels is None
            else np.asarray(detection_levels, np.float32)
        )
        if gains_arr.shape != (k,) or det_arr.shape != (k,):
            raise ValueError(f"gains/detection levels must have length {k}")
        with_detection = bool((det_arr > 0.0).any())

        if self.plan_autotune and not self._autotuning and self._plan_override is None:
            # the first image of a canvas bucket: time the candidate plans now
            first = image[0] if batched else image
            if isinstance(first, torch.Tensor):
                first = first.cpu().numpy()
            self._autotune_for(np.asarray(first))
        plan = self.plan(h, w)
        images = image if batched else image[None]
        with torch.inference_mode():
            # the small copies first: a pageable copy to the card waits for
            # the work queued before it, so queued after the forward it
            # would hold the host until the forward ends
            gains_t, det_t = (torch.from_numpy(v).to(self.device) for v in (gains_arr, det_arr))
            qnet = self._int8_net(images, plan)
            tiles = self._tile_batch(images, plan, quantized=qnet is not None)
            logits = self._forward(tiles, plan, quantized=qnet is not None)
            del tiles
            labels, seeds = self._blend(
                logits, plan, gains_t, det_t, with_detection,
                quantized=qnet is not None,
            )
        if device_output:
            return (labels, seeds) if batched else (labels[0], None if seeds is None else seeds[0])
        # crop the canvas back to H x W before the copy to the host
        labels = labels[:, :h, :w].cpu().numpy().astype(np.int32)
        seeds = None if seeds is None else seeds[:, :h, :w].cpu().numpy()
        if not batched:
            labels, seeds = labels[0], None if seeds is None else seeds[0]
        return labels, seeds


class HostReadback:
    """The copy to the host of a ``device_output`` call's labels and seeds
    ([..., Hp, Wp] on the inferer's device), started at once: cropped to
    H x W on the device, then on a CUDA device copied without blocking into
    pinned host memory, with an event recorded behind the copies on the
    current stream. ``wait`` waits for that event only, not for the work
    queued after it (the next image's forward), so a pipeline can start
    image i + 1 before it takes image i's results."""

    def __init__(self, labels: torch.Tensor, seeds: Optional[torch.Tensor],
                 height: int, width: int):
        crop = (..., slice(0, height), slice(0, width))
        cropped = [t[crop].contiguous() for t in (labels, seeds) if t is not None]
        self._with_seeds = seeds is not None
        self._event = None
        if labels.device.type == "cuda":
            self._host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in cropped]
            for host, t in zip(self._host, cropped):
                host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(labels.device))
        else:
            self._host = cropped

    def wait(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """(labels [..., H, W] int32, seeds [..., H, W] bool or None) on
        the host, as infer_arrays returns them."""
        if self._event is not None:
            self._event.synchronize()
        labels = self._host[0].numpy().astype(np.int32)
        return labels, self._host[1].numpy() if self._with_seeds else None


def annonet_infer(
    inferer: TiledInferer,
    input_image: np.ndarray,  # (H, W, C) uint8
    gains: Optional[Sequence[float]] = None,
    detection_levels: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """Full inference for one image: (H, W) uint16 label map, with the
    detection-level veto when any level is positive (annonet_infer.cpp)."""
    labels, seeds = inferer.infer_arrays(input_image, gains, detection_levels)
    return detection_veto(labels, seeds)


def annonet_infer_batch(
    inferer: TiledInferer,
    input_images: np.ndarray,  # (M, H, W, C) uint8, same-size images
    gains: Optional[Sequence[float]] = None,
    detection_levels: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """Full inference for M same-size images: (M, H, W) uint16 label maps;
    the blob veto runs per image."""
    labels, seeds = inferer.infer_arrays_batch(
        input_images, gains, detection_levels
    )
    return np.stack(
        [
            detection_veto(labels[i], None if seeds is None else seeds[i])
            for i in range(labels.shape[0])
        ]
    )


def detection_veto(labels: np.ndarray, seeds: Optional[np.ndarray]) -> np.ndarray:
    """Host post-pass: reset non-background blobs without a detection seed
    (annonet_infer.cpp:217-238). No-op when seeds is None (no detection
    levels active). Returns the final uint16 label map."""
    if seeds is not None:
        blobs, _count = label_connected_blobs(labels, zero_is_background=True)
        detected = np.unique(blobs[seeds]) if seeds.any() else np.empty(0, np.int32)
        keep = np.isin(blobs, detected)
        labels = np.where((blobs > 0) & ~keep, 0, labels)
    return labels.astype(np.uint16)
