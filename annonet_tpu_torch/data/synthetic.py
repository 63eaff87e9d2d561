"""Detection-graded synthetic benchmark dataset (the port's copy of
``annonet_tpu/data/synthetic.py``: the same files, byte for byte, from the
same seed).

The reference's stated purpose is defect *detection* — the
detection-biased per-region vote rule exists precisely for rare small
blobs (annonet_infer_main.cpp:250-260) — so this
generator produces the severe regime those mechanisms are for, which the
benign 2-class set (tests/test_end_to_end.py) cannot grade:

* ~1000:1 background:defect pixel imbalance (a few 3-8 px blobs per
  256² image),
* defects far smaller than the receptive field (level_count 1's
  required_input_dimension is 30 px),
* defects deliberately straddling the tile-boundary lines an inference
  tile grid puts at the image half/quarter lines,
* 3 classes (the reference's default clean/minor/major palette,
  annonet_parse_anno_classes.cpp:24-30),
* optional "oversize smear" regions — large, visually ambiguous blobs
  mislabeled as minor defect, the sloppy-annotation case
  ``--ignore-large-nonzero-regions-by-*`` exists for
  (annonet_train_main.cpp:434-502): unfiltered they teach the net that
  near-background texture is a defect.

Scored with the PER-REGION confusion matrix under nonzero gains and
detection levels; floors pinned by scripts/measure_detection.py into
PARITY_TARGETS.json; the port's run is tools/measure_detection.py.
"""

from __future__ import annotations

import numpy as np

from annonet_tpu_torch.classes import anno_classes_to_json, default_anno_classes

# mean appearance per class (RGB); per-region jitter and sensor noise on
# top. The shifts are deliberately SUBTLE — comparable to the noise
# floor — so single-pixel color is not sufficient and weak-logit blobs
# exercise the gain / detection-level machinery.
_BACKGROUND_BASE = np.array([44, 110, 44], np.float64)
_CLASS_SHIFT = {
    1: np.array([34, -10, 2], np.float64),  # minor defect: faint tan shift
    2: np.array([46, -42, 6], np.float64),  # major defect: dull red-brown
}
# clutter spots: background-labeled speckle halfway toward the minor
# shift — false-positive pressure for the blob veto / precision scoring
_CLUTTER_SHIFT = np.array([16, -5, 1], np.float64)
# the oversize smear is *barely* distinguishable from background — the
# point is that training on it (instead of region-ignoring it) drags the
# minor-defect decision boundary onto plain background texture
_SMEAR_TINT = np.array([22, -6, 0], np.float64)


def _ellipse_mask(size: int, cy: float, cx: float, ry: float, rx: float):
    y, x = np.ogrid[:size, :size]
    return ((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 2 <= 1.0


def generate_detection_image(
    rng: np.random.Generator,
    size: int = 256,
    defect_count: int = 4,
    straddle: bool = True,
    oversize_smear: bool = False,
):
    """One (image uint8 (S,S,3), labels uint16 (S,S)) pair.

    ``straddle``: half the defects are centered on the x=S/2 or y=S/2
    lines (tile boundaries for a max-tile of S/2) and one sits near the
    image border; the rest are uniform. ``oversize_smear``: additionally
    paint one large ambiguous class-1 region (for the region-size
    filter); smear area is ~60x a real defect's.
    """
    labels = np.zeros((size, size), np.uint16)
    regions = []  # (mask, class) in paint order

    def _place(cls, ry, rx, cy=None, cx=None, tries=40):
        for _ in range(tries):
            ty = cy if cy is not None else rng.uniform(ry + 1, size - ry - 1)
            tx = cx if cx is not None else rng.uniform(rx + 1, size - rx - 1)
            m = _ellipse_mask(size, ty, tx, ry, rx)
            # keep regions 8-disconnected: demand a 2-px empty moat
            moat = _ellipse_mask(size, ty, tx, ry + 2.5, rx + 2.5)
            if not labels[moat].any():
                labels[m] = cls
                regions.append((m, cls))
                return True
        return False

    if oversize_smear:
        _place(1, rng.uniform(28, 40), rng.uniform(50, 80))

    for i in range(defect_count):
        cls = 1 + int(rng.integers(0, 2))
        ry, rx = rng.uniform(1.2, 3.5, size=2)  # ~2-7 px across
        cy = cx = None
        if straddle:
            if i % 4 == 0:  # vertical tile boundary
                cx = size / 2 + rng.uniform(-1, 1)
            elif i % 4 == 1:  # horizontal tile boundary
                cy = size / 2 + rng.uniform(-1, 1)
            elif i % 4 == 2:  # near the image border
                cx = rng.uniform(rx + 1, rx + 4)
        _place(cls, ry, rx, cy, cx)

    # background-labeled clutter speckle (placed with the same moat rule
    # so it never touches a labeled defect)
    clutter = []
    for _ in range(6):
        ry, rx = rng.uniform(0.8, 2.2, size=2)
        ty = rng.uniform(ry + 1, size - ry - 1)
        tx = rng.uniform(rx + 1, size - rx - 1)
        m = _ellipse_mask(size, ty, tx, ry, rx)
        moat = _ellipse_mask(size, ty, tx, ry + 2.5, rx + 2.5)
        if not labels[moat].any():
            clutter.append(m)

    # --- appearance
    img = np.empty((size, size, 3), np.float64)
    img[:] = _BACKGROUND_BASE + rng.uniform(-12, 12, size=3)
    # low-frequency lighting plane
    y, x = np.mgrid[:size, :size]
    gy, gx = rng.uniform(-20, 20, size=2)
    img += ((y / size - 0.5) * gy + (x / size - 0.5) * gx)[..., None]
    smear_done = False
    for m, cls in regions:
        if oversize_smear and not smear_done:
            img[m] += _SMEAR_TINT + rng.uniform(-4, 4, size=3)
            smear_done = True
        else:
            img[m] += _CLASS_SHIFT[cls] + rng.uniform(-10, 10, size=3)
    for m in clutter:
        img[m] += _CLUTTER_SHIFT + rng.uniform(-6, 6, size=3)
    img += rng.normal(0.0, 12.0, size=img.shape)  # sensor noise
    return (
        np.clip(img, 0, 255).astype(np.uint8),
        labels,
    )


def write_detection_dataset(
    root,
    n_images: int = 8,
    size: int = 256,
    seed: int = 0,
    defect_count: int = 4,
    oversize_images: int = 0,
    straddle: bool = True,
    prefix: str = "img",
):
    """Write an anno-format dataset directory (PNG + _mask.png pairs +
    anno_classes.json with the reference default palette). The first
    ``oversize_images`` images each carry one oversize ambiguous smear.
    Deterministic in (seed, parameters)."""
    from PIL import Image

    anno_classes = default_anno_classes()
    root.mkdir(parents=True, exist_ok=True)
    (root / "anno_classes.json").write_text(
        anno_classes_to_json(anno_classes)
    )
    rng = np.random.default_rng(seed)
    palette = np.array(
        [c.rgba_label for c in anno_classes], np.uint8
    )
    for i in range(n_images):
        image, labels = generate_detection_image(
            rng, size=size, defect_count=defect_count,
            straddle=straddle, oversize_smear=i < oversize_images,
        )
        mask = palette[labels]
        Image.fromarray(image).save(root / f"{prefix}{i}.png")
        Image.fromarray(mask, mode="RGBA").save(
            root / f"{prefix}{i}.png_mask.png"
        )
