"""Anno class definitions and the anno_classes.json codec.

The port's own copy of ``annonet_tpu/classes.py`` (which the port does not
import): the class record, the reserved ignore colour and label, the
default palette, and the JSON parser and writer, with the same validation
messages (the reference's annonet_parse_anno_classes.h:23-35 and
annonet_parse_anno_classes.cpp:21-83).

The per-pixel ignore sentinel is uint16 max (65535), dlib's
``loss_multiclass_log_per_pixel_::label_to_ignore``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Sequence, Tuple

IGNORE_LABEL: int = 0xFFFF

# RGBA (0,0,0,0) is reserved for pixels to be ignored
RGBA_IGNORE: Tuple[int, int, int, int] = (0, 0, 0, 0)


@dataclasses.dataclass(frozen=True)
class AnnoClass:
    """One segmentation class: index = position in anno_classes.json array."""

    index: int
    rgba_label: Tuple[int, int, int, int]
    classlabel: str


def default_anno_classes() -> List[AnnoClass]:
    """The default palette used when no anno_classes.json exists."""
    return [
        AnnoClass(0, (0, 255, 0, 64), "clean"),
        AnnoClass(1, (255, 255, 0, 128), "minor defect"),
        AnnoClass(2, (255, 0, 0, 128), "major defect"),
    ]


def parse_anno_classes(json_text: str) -> List[AnnoClass]:
    """Parse the anno_classes.json document into a class list.

      * empty string -> default 3-class palette
      * document must be an object with an "anno_classes" array
      * each entry must have "name" and "color" {red,green,blue,alpha}
      * the reserved ignore color (0,0,0,0) is rejected
      * class index = array position
    """
    if not json_text:
        return default_anno_classes()

    try:
        doc = json.loads(json_text)
    except json.JSONDecodeError as e:
        raise RuntimeError("Error parsing json\n" + json_text) from e

    if not isinstance(doc, dict):
        raise RuntimeError(
            "Unexpected anno classes json content - the document should be an object"
        )

    anno_classes_member = doc.get("anno_classes")
    if not isinstance(anno_classes_member, list):
        raise RuntimeError(
            "Unexpected anno classes json content - there should be an anno_classes array"
        )

    anno_classes: List[AnnoClass] = []
    for i, anno_class in enumerate(anno_classes_member):
        if "name" not in anno_class:
            raise RuntimeError(
                "Unexpected anno classes json content - no name found"
            )
        if "color" not in anno_class:
            raise RuntimeError(
                "Unexpected anno classes json content - no color found"
            )
        color = anno_class["color"]
        if any(k not in color for k in ("red", "green", "blue", "alpha")):
            raise RuntimeError(
                "Unexpected anno classes json content - color should have all "
                "components (red, green, blue, alpha)"
            )
        rgba = (
            int(color["red"]),
            int(color["green"]),
            int(color["blue"]),
            int(color["alpha"]),
        )
        if rgba == RGBA_IGNORE:
            raise RuntimeError(
                "Unexpected anno classes json content - rgba (0, 0, 0, 0) is "
                "reserved for pixels to be ignored"
            )
        anno_classes.append(AnnoClass(i, rgba, str(anno_class["name"])))

    return anno_classes


def anno_classes_to_json(anno_classes: Sequence[AnnoClass]) -> str:
    """Serialize a class list back to anno_classes.json text (for tests and
    synthetic datasets; the reference only ever reads this file)."""
    return json.dumps(
        {
            "anno_classes": [
                {
                    "name": c.classlabel,
                    "color": {
                        "red": c.rgba_label[0],
                        "green": c.rgba_label[1],
                        "blue": c.rgba_label[2],
                        "alpha": c.rgba_label[3],
                    },
                }
                for c in anno_classes
            ]
        }
    )
