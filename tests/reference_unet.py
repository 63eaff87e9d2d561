"""The plain reference of the U-Net, in float32 PyTorch, for the tests.

Ronneberger, Fischer and Brox, "U-Net: Convolutional Networks for
Biomedical Image Segmentation", MICCAI 2015, arXiv:1505.04597, Fig. 1, with
``level_count`` L max pools and widths ``w_i = base_width * width_scaler *
2**i`` (64/128/256/512/1024 at L = 4), written as the public PyTorch U-Net
(github.com/milesial/Pytorch-UNet, unet/unet_parts.py, unet/unet_model.py)
writes it:

    stem:  [conv3x3 -> BN -> ReLU] x2                               (w0)
    enc i: maxpool 2x2 -> [conv3x3 -> BN -> ReLU] x2                (wi)
    dec i: convT 2x2 stride 2 + bias (wi -> w(i-1)), concat with the
           skip, [conv3x3 -> BN -> ReLU] x2                         (w(i-1))
    head:  conv1x1 + bias -> class_count logits

Departures from the paper, each as milesial's: every 3x3 conv pads one
pixel (the paper's are unpadded, its output smaller than its input), has
no bias and is followed by batch norm (the paper has neither). Departures
from milesial's: the concat is [up, skip] (milesial's [skip, up]; the same
function up to a permutation of the decoder conv0's input channels), the
class count is the configuration's (milesial's Carvana default is 2), and
the transpose conv's kernel is HWIO and flipped: out[2i+u, 2j+v] = x[i, j]
. w[1-u, 1-v] (ConvTranspose2d's W[c, d, u, v] is w[1-u, 1-v, c, d]).

Inputs are uint8 pixels (or 0..255 floats) [N, H, W, C], normalised to
x / 255 - 0.5; logits are [N, H, W, K]. Training batch norm takes the
batch's statistics over (N, H, W), the biased variance, eps 1e-5, and
updates the running ones as ``stat * m + batch * (1 - m)``. The loss is
the weighted softmax cross-entropy over every pixel, ignored pixels
(a label of K or more) counting 0, divided by N H W. Inference folds the
running statistics into the convs: w * gamma / sqrt(var + eps), bias beta
- mean * scale.

Parameters are the flat names of the training tree: "block/convX" (HWIO),
"block/bnX/gamma" and "/beta", "decI/up" (HWIO) and "decI/up_bias",
"head/w" [1, 1, w0, K] and "head/b"; running statistics "block/bnX/mean"
and "/var". Everything is float32 with TF32 off (``exact``); nothing of
the program under test, nor of JAX, is imported.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


@contextlib.contextmanager
def exact() -> Iterator[None]:
    """float32 products stay float32 on a card: TF32 off inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def normalize(x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] 0..255 -> NCHW in [-0.5, 0.5]: float32 from uint8 or
    float32, float64 from float64."""
    x = x if x.dtype == torch.float64 else x.to(torch.float32)
    return (x / 255.0 - 0.5).permute(0, 3, 1, 2)


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 conv, padding 1, of NCHW ``x`` with an HWIO kernel."""
    return F.conv2d(x, w.permute(3, 2, 0, 1), padding=1)


def up2x2(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The 2x2 stride-2 transpose conv with bias, HWIO ``w`` flipped."""
    return F.conv_transpose2d(x, torch.flip(w, dims=(0, 1)).permute(2, 3, 0, 1),
                              bias=bias, stride=2)


def batch_norm(h: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor):
    """(normalised ``h``, batch mean, biased batch variance)."""
    mean = h.mean(dim=(0, 2, 3))
    var = h.var(dim=(0, 2, 3), unbiased=False)
    out = (h - mean[:, None, None]) / torch.sqrt(var[:, None, None] + BN_EPS)
    return out * gamma[:, None, None] + beta[:, None, None], mean, var


def train_forward(p: Dict[str, torch.Tensor], config: Dict, x: torch.Tensor,
                  stats: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """The training net: [N, H, W, C] 0..255 -> [N, H, W, K] logits, batch
    norm over this batch; ``stats`` gets every BN layer's batch mean and
    variance as "block/bnX/mean" and "/var"."""
    L = config["level_count"]

    def double(x, block):
        for i in range(2):
            y, mean, var = batch_norm(conv3x3(x, p[f"{block}/conv{i}"]),
                                      p[f"{block}/bn{i}/gamma"], p[f"{block}/bn{i}/beta"])
            if stats is not None:
                stats[f"{block}/bn{i}/mean"], stats[f"{block}/bn{i}/var"] = mean, var
            x = torch.relu(y)
        return x

    x = double(normalize(x), "stem")
    skips = [x]
    for i in range(1, L + 1):
        x = double(F.max_pool2d(x, 2), f"enc{i}")
        skips.append(x)
    skips.pop()
    for i in range(L, 0, -1):
        up = up2x2(x, p[f"dec{i}/up"], p[f"dec{i}/up_bias"])
        x = double(torch.cat([up, skips.pop()], dim=1), f"dec{i}")
    return F.conv2d(x, p["head/w"].permute(3, 2, 0, 1), p["head/b"]).permute(0, 2, 3, 1)


def loss(logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted softmax cross-entropy summed over the pixels, over N H W."""
    k = logits.shape[-1]
    valid = labels < k
    logp = torch.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, labels.clamp(max=k - 1).to(torch.int64)[..., None])[..., 0]
    return (torch.where(valid, ce, 0.0) * weights).sum() / labels.numel()


def running_update(running: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                   momentum: float) -> Dict[str, torch.Tensor]:
    return {k: running[k] * momentum + batch[k].detach() * (1.0 - momentum) for k in running}


def fold(p: Dict[str, torch.Tensor], running: Dict[str, torch.Tensor],
         config: Dict) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """{"block/convX" or "decI/up" or "head": (HWIO weight, bias)}: the
    running statistics folded into the 3x3 convs."""
    out = {}
    blocks = ["stem"] + [f"enc{i}" for i in range(1, config["level_count"] + 1)]
    blocks += [f"dec{i}" for i in range(1, config["level_count"] + 1)]
    for block in blocks:
        for i in range(2):
            bn = f"{block}/bn{i}"
            scale = p[f"{bn}/gamma"] / torch.sqrt(running[f"{bn}/var"] + BN_EPS)
            out[f"{block}/conv{i}"] = (p[f"{block}/conv{i}"] * scale,
                                       p[f"{bn}/beta"] - running[f"{bn}/mean"] * scale)
    for i in range(1, config["level_count"] + 1):
        out[f"dec{i}/up"] = (p[f"dec{i}/up"], p[f"dec{i}/up_bias"])
    out["head"] = (p["head/w"], p["head/b"])
    return out


def infer_forward(folded: Dict[str, Tuple[torch.Tensor, torch.Tensor]], config: Dict,
                  x: torch.Tensor) -> torch.Tensor:
    """The inference net on folded weights: [N, H, W, C] 0..255 -> [N, H,
    W, K] logits."""
    L = config["level_count"]

    def double(x, block):
        for i in range(2):
            w, b = folded[f"{block}/conv{i}"]
            x = torch.relu(conv3x3(x, w) + b[:, None, None])
        return x

    x = double(normalize(x), "stem")
    skips = [x]
    for i in range(1, L + 1):
        x = double(F.max_pool2d(x, 2), f"enc{i}")
        skips.append(x)
    skips.pop()
    for i in range(L, 0, -1):
        x = double(torch.cat([up2x2(x, *folded[f"dec{i}/up"]), skips.pop()], dim=1), f"dec{i}")
    w, b = folded["head"]
    return F.conv2d(x, w.permute(3, 2, 0, 1), b).permute(0, 2, 3, 1)
