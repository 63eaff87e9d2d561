"""Device ms a training step spends in the net's forward and the loss
(the program's timed spans ``forward`` and ``loss``, on the device's
clock)."""

from perfbench.lib import spans


def read(run):
    return spans.device_ms(run, ("forward", "loss"))
