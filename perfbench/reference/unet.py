"""The plain reference of the U-Net and of its training step, in float32
PyTorch.

Ronneberger, Fischer and Brox, "U-Net: Convolutional Networks for
Biomedical Image Segmentation", MICCAI 2015, arXiv:1505.04597, Fig. 1
(``level_count`` L = 4 max pools, widths ``base_width * 2**level``:
64/128/256/512/1024), as the public PyTorch U-Net writes it
(github.com/milesial/Pytorch-UNet, unet/unet_parts.py ``DoubleConv``,
``Down``, ``Up`` with bilinear=False, ``OutConv``):

    stem:  [conv3x3 -> BN -> ReLU] x2                               (w0)
    enc i: maxpool 2x2 -> [conv3x3 -> BN -> ReLU] x2                (wi)
    dec i: convT 2x2 stride 2 + bias (wi -> w(i-1)), concat with the
           skip, [conv3x3 -> BN -> ReLU] x2                         (w(i-1))
    head:  conv1x1 + bias -> class_count logits

Departures from the paper, each as milesial's: the 3x3 convs pad one pixel
(the paper's are unpadded), have no bias and are followed by batch norm
(the paper has none). Departures from milesial's: the concat is [up, skip]
(milesial's [skip, up]: the same function up to a permutation of the
decoder conv0's input channels), the class count is the configuration's
(milesial's Carvana default is 2), and the transpose conv's kernel is HWIO
and flipped, out[2i+u, 2j+v] = x[i, j] . w[1-u, 1-v] (ConvTranspose2d's
W[c, d, u, v] is w[1-u, 1-v, c, d]).

Inputs are uint8 pixels, normalised to x / 255 - 0.5. Batch norm takes the
batch's statistics over (N, H, W), biased variance, eps 1e-5. The training
step is ``reference/train.py``'s (its crops, augmentation, loss weights,
loss and SGD), with this net in place of annonet's.

At the cell's size (batch 16 of 624^2 crops) the float32 net's saved
activations would fill most of the card, so each conv + BN + ReLU unit,
and each up layer, is recomputed in the backward (torch.utils.checkpoint):
the same function, the batch statistics still over the whole batch.
Parameters are the flat names "block/convX" (HWIO), "block/bnX/gamma" and
"/beta", "decI/up" (HWIO), "decI/up_bias", "head/w", "head/b".

Every operation is float32 with TF32 off (``exact``). No kernel, cache or
batching of the program is used; nothing of the program is imported.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.segnet import _bn, exact, normalize
from perfbench.reference.train import augment, crops, loss, loss_weights


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 conv, padding 1, of NCHW ``x`` with an HWIO kernel."""
    return F.conv2d(x, w.permute(3, 2, 0, 1), padding=1)


def _up(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The 2x2 stride-2 transpose conv with bias, HWIO ``w`` flipped."""
    return F.conv_transpose2d(x, torch.flip(w, dims=(0, 1)).permute(2, 3, 0, 1),
                              bias=bias, stride=2)


def train_forward(p: Dict[str, torch.Tensor], config: Dict, x: torch.Tensor,
                  quant: Optional[Callable] = None, stats: Optional[Dict] = None,
                  recompute: bool = False) -> torch.Tensor:
    """The training net on a batch: [N, H, W, C] 0..255 floats -> [N, H,
    W, K] float32 logits, batch norm over this batch. ``quant`` (the
    control's ``segnet.fp8``) rounds every tensor the program keeps in its
    compute dtype: the normalised input, each kernel as the conv reads it,
    each conv's, batch norm's, ReLU's and up layer's output, the logits,
    with the gradients arriving at them. ``stats``, if given, gets every
    batch norm's batch mean and variance as "block/bnX/mean" and "/var".
    ``recompute``: each unit recomputed in the backward."""
    L = int(config["level_count"])
    q = quant or (lambda t: t)

    def unit(x, block, i):
        h = q(_conv(x, q(p[f"{block}/conv{i}"])))
        y, mean, var = _bn(h, p[f"{block}/bn{i}/gamma"], p[f"{block}/bn{i}/beta"])
        if stats is not None:
            stats[f"{block}/bn{i}/mean"], stats[f"{block}/bn{i}/var"] = (mean.detach(),
                                                                          var.detach())
        return q(torch.relu(q(y)))

    def up(x, block):
        return q(_up(x, q(p[f"{block}/up"]), p[f"{block}/up_bias"]))

    def run(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if recompute else fn(*args)

    def double(x, block):
        return run(unit, run(unit, x, block, 0), block, 1)

    x = double(q(normalize(x)), "stem")
    skips = [x]
    for i in range(1, L + 1):
        x = double(F.max_pool2d(x, 2), f"enc{i}")
        skips.append(x)
    skips.pop()
    for i in range(L, 0, -1):
        x = double(torch.cat([run(up, x, f"dec{i}"), skips.pop()], dim=1), f"dec{i}")
    return q(torch.einsum("nchw,ck->nhwk", x, q(p["head/w"][0, 0]))) + p["head/b"]


def steps(params0: Dict[str, np.ndarray], config: Dict, hp: Dict, pool_images: np.ndarray,
          pool_labels: np.ndarray, decisions: List[Tuple[np.ndarray, np.ndarray]],
          draws: List[Dict[str, np.ndarray]], device, quant=None) -> Dict:
    """``reference.train.steps`` with the U-Net: ``len(decisions)`` steps
    from ``params0`` with zero velocity; {"losses", "velocity1" (after the
    first step), "params3" (after the last), "stats1" (the first step's
    batch statistics)}, the trees as numpy float32 keyed by name."""
    images = torch.as_tensor(pool_images, device=device)
    labels = torch.as_tensor(pool_labels.astype(np.int64), device=device)
    p = {k: torch.tensor(v, dtype=torch.float32, device=device, requires_grad=True)
         for k, v in params0.items()}
    v = {k: torch.zeros_like(t) for k, t in p.items()}
    out: Dict = {"losses": []}
    with exact():
        for (slots, rects), d in zip(decisions, draws):
            dd = {k: torch.as_tensor(a, device=device) for k, a in d.items()}
            x, lab = crops(images, labels, slots, rects, hp["crop"])
            x, lab = augment(x, lab, dd, hp["augmentation"])
            wts = loss_weights(lab, config["class_count"], hp["class_weight"],
                               hp["image_weight"])
            stats: Dict = {}
            value = loss(train_forward(p, config, x, quant, stats, recompute=True), lab, wts)
            del x
            grads = torch.autograd.grad(value, list(p.values()))
            with torch.no_grad():
                for (name, t), g in zip(p.items(), grads):
                    decay = hp["weight_decay"] * t if t.dim() == 4 else 0.0
                    v[name].mul_(hp["momentum"]).sub_(hp["learning_rate"] * (g + decay))
                    t.add_(v[name])
            del grads
            out["losses"].append(float(value.detach()))
            if "velocity1" not in out:
                out["velocity1"] = {k: t.cpu().numpy().copy() for k, t in v.items()}
                out["stats1"] = {k: t.cpu().numpy() for k, t in stats.items()}
    out["params3"] = {k: t.detach().cpu().numpy() for k, t in p.items()}
    return out
