"""Device idle ms a training step while the host was inside the forward
(the program's ``forward`` range against the device trace's busy
intervals)."""

from perfbench.lib import spans


def read(run):
    return spans.idle_ms(run, "forward")
