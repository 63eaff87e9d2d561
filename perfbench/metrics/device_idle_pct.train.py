"""The share of the traced window in which no kernel, copy or memset ran
on the card, in the training cell (the device trace)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
