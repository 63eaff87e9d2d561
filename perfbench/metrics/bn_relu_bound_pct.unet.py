"""The batch norm + ReLU op's share of its roofline in the U-Net's step,
%: the op's byte bound at the cell's 18 units (``perfbench/lib/unet.py``
``bn_relu_bound_ms``, a frozen copy of ``chip_smoke.py``'s
``bn_relu_bound``: 9.08 ms a step at batch 16 of 624^2) over the device
time of its kernels in the traced window (``bn_reduce_kernel``,
``bn_relu_apply_kernel``, ``bn_relu_grad_kernel``), a step."""

from perfbench.lib import unet


def read(run):
    t, w, mix = run.trace, run.window, run.mix
    if t is None or not w["calls"]:
        return None
    seconds = unet.kernel_seconds(t, lambda n: any(k in n for k in unet.BN_RELU_KERNELS))
    if seconds <= 0:
        return None
    bound_ms = unet.bn_relu_bound_ms(run.config, mix["batch"] * mix["crop"] ** 2)
    return 100.0 * bound_ms * w["calls"] / (1e3 * seconds)
