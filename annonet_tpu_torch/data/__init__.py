"""Data layer of the inference slice: dataset scanning, sample reading and
the RGBA label codec (copies of the annonet_tpu.data modules it needs),
plus the class palette of annonet_tpu_torch.classes, re-exported."""

from annonet_tpu_torch.classes import (
    IGNORE_LABEL,
    RGBA_IGNORE,
    AnnoClass,
    anno_classes_to_json,
    default_anno_classes,
    parse_anno_classes,
)
from annonet_tpu_torch.data.codec import (
    decode_rgba_label_image,
    index_label_image_to_rgba_label_image,
    labeled_points_by_class,
)
from annonet_tpu_torch.data.dataset import (
    ImageFilenames,
    find_image_files,
    read_anno_classes_file,
)
from annonet_tpu_torch.data.sample import (
    Sample,
    load_image,
    load_rgba,
    read_sample,
    resize_image_bilinear,
    resize_label_image,
    save_png_rgba,
)

__all__ = [
    "IGNORE_LABEL",
    "RGBA_IGNORE",
    "AnnoClass",
    "ImageFilenames",
    "Sample",
    "anno_classes_to_json",
    "decode_rgba_label_image",
    "default_anno_classes",
    "find_image_files",
    "index_label_image_to_rgba_label_image",
    "labeled_points_by_class",
    "load_image",
    "load_rgba",
    "parse_anno_classes",
    "read_anno_classes_file",
    "read_sample",
    "resize_image_bilinear",
    "resize_label_image",
    "save_png_rgba",
]
