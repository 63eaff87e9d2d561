"""The training step's share of the card's peak, %: three times the
forward's FLOP over the batch's crops per step (forward and a backward of
twice the forward), per second of the traced window, over the peak of the
compute dtype."""

from perfbench import roofline


def read(run):
    w, mix = run.window, run.mix
    if not w["calls"]:
        return None
    flop = roofline.step_flop(run.config, mix["batch"] * mix["crop"] ** 2) * w["calls"]
    return 100.0 * flop / w["seconds"] / roofline.PEAK_FLOPS[run.config["compute_dtype"]]
