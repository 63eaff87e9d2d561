"""Device ms a training step spends on its input: the crop gather, the
augmentation and the loss weights (the program's timed spans ``gather``,
``augment`` and ``weighting``, on the device's clock)."""

from perfbench.lib import spans


def read(run):
    return spans.device_ms(run, ("gather", "augment", "weighting"))
