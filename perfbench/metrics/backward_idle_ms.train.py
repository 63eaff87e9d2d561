"""Device idle ms a training step while the host was inside the backward
(the program's ``backward`` range against the device trace's busy
intervals)."""

from perfbench.lib import spans


def read(run):
    return spans.idle_ms(run, "backward")
