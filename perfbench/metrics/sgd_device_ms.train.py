"""Device ms a training step spends in the SGD update (the program's
timed span ``sgd``, on the device's clock)."""

from perfbench.lib import spans


def read(run):
    return spans.device_ms(run, ("sgd",))
