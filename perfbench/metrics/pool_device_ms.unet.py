"""Device ms a U-Net training step spends in its max pools: the device
time of the pool kernels of the traced window (PyTorch's max_pool2d
kernels, found by name: ``unet.POOL_KERNELS``), forward and backward,
over the window's steps."""

from perfbench.lib import unet


def read(run):
    t, w = run.trace, run.window
    if t is None or not w["calls"]:
        return None
    seconds = unet.kernel_seconds(t, unet.POOL_KERNELS.search)
    if seconds <= 0:
        return None
    return 1e3 * seconds / w["calls"]
