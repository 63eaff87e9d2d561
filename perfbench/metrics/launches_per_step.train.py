"""Kernels launched per training step: the traced window's kernel events
over its steps (the device trace)."""


def read(run):
    t = run.trace
    if t is None or not run.window["calls"] or not t.count("kernel"):
        return None
    return t.count("kernel") / run.window["calls"]
