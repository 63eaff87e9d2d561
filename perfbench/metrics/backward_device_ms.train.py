"""Device ms a training step spends in the backward (the program's timed
span ``backward``, on the device's clock)."""

from perfbench.lib import spans


def read(run):
    return spans.device_ms(run, ("backward",))
