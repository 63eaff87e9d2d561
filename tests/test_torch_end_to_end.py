"""The accuracy floors on a net the port trains: the counterpart of
tests/test_end_to_end.py's round trip (synthetic set -> 40 training steps
-> artifact saved and loaded back -> tiled inference, float and int8 ->
per-pixel confusion matrix), through the port's Trainer, CropPipeline,
serialization, TiledInferer and confusion matrices
(``annonet_tpu_torch/tools/measure_accuracy.py``), on the CPU.

It holds PARITY_TARGETS.json's pinned floors, read from the file as the
JAX test reads them: float pixel accuracy and mIoU, and the int8
inferer's pixel accuracy.
"""

import json
import pathlib

from annonet_tpu_torch.tools import measure_accuracy
from tests.test_end_to_end import write_synthetic_dataset

TARGETS = json.loads((pathlib.Path(__file__).parent.parent / "PARITY_TARGETS.json").read_text())


def test_the_dataset_is_the_jax_tests(tmp_path):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    ours.mkdir()
    theirs.mkdir()
    measure_accuracy.write_separable_dataset(ours)
    write_synthetic_dataset(theirs)
    names = sorted(p.name for p in theirs.iterdir())
    assert names == sorted(p.name for p in ours.iterdir()) and len(names) == 9
    for name in names:
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), name


def test_train_save_load_infer_clears_the_pinned_floors(tmp_path):
    measure_accuracy.write_separable_dataset(tmp_path)
    run = measure_accuracy.train_and_score(tmp_path, seed=0, device="cpu")
    losses = run["losses"]
    assert len(losses) == 40 and losses[-1] < losses[0], "loss must decrease on separable data"
    assert run["ground_truth_pixels"] == 4 * 48 * 48
    pixel_floor = TARGETS["pinned_pixel_accuracy_floor"]
    assert run["pixel_accuracy"] >= pixel_floor, run["confusion_per_pixel"]
    assert run["miou"] >= TARGETS["pinned_miou_floor"], run["confusion_per_pixel"]
    assert run["int8_pixel_accuracy"] >= pixel_floor
    assert measure_accuracy.below_floors(run) == []
    assert measure_accuracy.pinned_floors() == (pixel_floor, TARGETS["pinned_miou_floor"])
