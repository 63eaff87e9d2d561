"""The U-Net training step's share of the card's peak, %: three times the
forward's FLOP (``perfbench/lib/unet.py``, 1,470,208 a pixel at the
published widths) over the batch's crops per step, per second of the
traced window, over the bf16 peak of one card."""

from perfbench import roofline
from perfbench.lib import unet


def read(run):
    w, mix = run.window, run.mix
    if not w["calls"] or w["seconds"] <= 0:
        return None
    flop = unet.step_flop(run.config, mix["batch"] * mix["crop"] ** 2) * w["calls"]
    return 100.0 * flop / w["seconds"] / roofline.PEAK_FLOPS[run.config["compute_dtype"]]
