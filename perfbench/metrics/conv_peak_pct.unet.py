"""The U-Net's convolutions against the card's peak, %: their FLOP a step
(three times the forward's, every conv, the transpose convs and the head
included; ``perfbench/lib/unet.py``) over the device time of the conv
kernels of the traced window, forward and backward (cuDNN's, found by
name: ``unet.CONV_KERNELS``), at the bf16 peak of one card."""

from perfbench import roofline
from perfbench.lib import unet


def read(run):
    t, w, mix = run.trace, run.window, run.mix
    if t is None or not w["calls"]:
        return None
    seconds = unet.kernel_seconds(t, unet.CONV_KERNELS.search)
    if seconds <= 0:
        return None
    flop = unet.step_flop(run.config, mix["batch"] * mix["crop"] ** 2) * w["calls"]
    return 100.0 * flop / seconds / roofline.PEAK_FLOPS[run.config["compute_dtype"]]
