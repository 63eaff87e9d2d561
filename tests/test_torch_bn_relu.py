"""The training unit's batch norm and ReLU op (``ops/bn_relu.py``) on the
CPU: its closed-form backward against autograd over the eager unit
(``bn_plain`` and the ReLU), its autograd glue with the two launches
replaced by the plain versions, the layout rules that choose the kernels'
paths, and where ``apply_train`` engages it. The kernels themselves run in
tests/test_torch_cuda.py on the card.

The closed form and autograd compute the same f32 function in another
order, so each gradient is held within 1e-5 of its largest magnitude.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from annonet_tpu_torch.models import segnet
from annonet_tpu_torch.ops import bn_relu as op

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5


def _moments_diff(h):
    """mean(h^2) - mean(h)^2 per channel, as ``bn_plain`` computes it."""
    mean, mean_sq = op.bn_moments(h)
    return mean_sq - mean.square()


def _case(n, c, hh, ww, seed):
    """(h, gamma, beta, dy) with gamma != 1, beta != 0; channel 0 constant
    at a value whose moments give a negative variance (the clamp engages),
    channel 1 killed by the ReLU everywhere (beta far below h's range)."""
    g = torch.Generator().manual_seed(seed)
    h = torch.randn((n, c, hh, ww), generator=g) * 1.5 + 0.25
    gamma = 0.5 + torch.rand(c, generator=g)
    beta = torch.randn(c, generator=g) * 0.3
    dy = torch.randn((n, c, hh, ww), generator=g)
    for value in np.linspace(0.1, 3.0, 60, dtype=np.float32):
        h[:, 0] = float(value)
        if _moments_diff(h)[0] < 0:
            break
    else:
        pytest.skip(f"no constant in the sweep gives a negative variance at {h.shape}")
    if c > 1:
        beta[1] = -100.0
    return h, gamma, beta, dy


def _autograd(h, gamma, beta, dy):
    h, gamma, beta = (t.clone().requires_grad_(True) for t in (h, gamma, beta))
    (z,), _mean, _var = op.bn_plain([h], [gamma], [beta])
    torch.relu(z).backward(dy)
    return h.grad, gamma.grad, beta.grad


def _close(got, want, what):
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= RTOL * max(scale, 1e-30), f"{what}: {err:.3e} of {scale:.3e}"


# (n, c, h, w): C of 3, 16, 64 and 128; N*H*W ragged (odd sides, primes)
SHAPES = [(2, 3, 7, 5), (1, 16, 13, 11), (3, 16, 8, 8), (2, 64, 5, 9), (1, 128, 3, 7),
          (4, 128, 6, 6)]


@pytest.mark.parametrize("n,c,h,w", SHAPES)
def test_closed_form_backward_matches_autograd(n, c, h, w):
    x, gamma, beta, dy = _case(n, c, h, w, seed=c * 100 + h)
    assert _moments_diff(x)[0] < 0  # the constant channel's clamp engages
    want = _autograd(x, gamma, beta, dy)
    got = op.bn_relu_backward_plain(x, gamma, beta, dy)
    for name, a, b in zip(("dh", "dgamma", "dbeta"), got, want):
        _close(a, b, name)
    if c > 1:  # the dead channel: no gradient reaches h, gamma or beta
        assert not got[0][:, 1].any() and got[1][1] == 0 and got[2][1] == 0


def test_closed_form_backward_in_bf16_matches_f32_autograd_of_the_same_values():
    """With bf16 h and dy the closed form computes in f32 from the bf16
    values and the bf16 scale and shift: autograd over the same graph
    with the casts made explicit gives the same gradients."""
    x, gamma, beta, dy = _case(2, 16, 9, 7, seed=5)
    xb, dyb = x.to(torch.bfloat16), dy.to(torch.bfloat16)
    got = op.bn_relu_backward_plain(xb, gamma, beta, dyb)
    x32 = xb.to(torch.float32).requires_grad_(True)
    g, b = gamma.clone().requires_grad_(True), beta.clone().requires_grad_(True)
    mean, mean_sq = op.bn_moments(x32)
    var = torch.clamp(mean_sq - mean.square(), min=0.0)
    inv = torch.rsqrt(var + op.BN_EPS)
    scale, shift = inv * g, b - mean * inv * g
    # the forward's bf16 values with an identity gradient (straight through)
    sb = scale + (scale.to(torch.bfloat16).float() - scale).detach()
    tb = shift + (shift.to(torch.bfloat16).float() - shift).detach()
    z = (xb * scale.to(torch.bfloat16)[:, None, None]
         + shift.to(torch.bfloat16)[:, None, None]).float()
    mask = (z > 0).float()
    (mask * (x32 * sb[:, None, None] + tb[:, None, None])).backward(dyb.float())
    for name, a, want in zip(("dh", "dgamma", "dbeta"), got, (x32.grad, g.grad, b.grad)):
        _close(a, want, name)


def test_bn_relu_on_the_cpu_is_the_eager_unit():
    x, gamma, beta, _ = _case(2, 16, 6, 10, seed=3)
    before = (op.bn_relu.units, op.bn_relu.launches)
    for dtype in (torch.float32, torch.bfloat16):
        h = x.to(dtype)
        y, mean, var = op.bn_relu(h, gamma, beta)
        (z,), mean0, var0 = op.bn_plain([h], [gamma], [beta])
        assert y.dtype == dtype
        assert torch.equal(y, torch.relu(z)) and torch.equal(mean, mean0)
        assert torch.equal(var, var0)
    assert (op.bn_relu.units, op.bn_relu.launches) == before  # no kernel on the CPU


def _emulated_launches(monkeypatch, beta):
    """The Function's two launches replaced by the plain versions (the
    backward's needs ``beta``, which the kernels read from the forward's
    buffer as the shift)."""

    def forward(h, gamma, beta_):
        y, mean, var = op.bn_relu_plain(h, gamma, beta_)
        buf = torch.zeros((8, h.shape[1]))
        buf[0], buf[1] = mean, var
        return y, buf

    def backward(h, gamma, buf, dy):
        dh, dgamma, dbeta = op.bn_relu_backward_plain(h, gamma, beta, dy)
        return dh.to(h.dtype), dgamma, dbeta

    monkeypatch.setattr(op, "_forward", forward)
    monkeypatch.setattr(op, "_backward", backward)


@pytest.mark.parametrize("remat", [False, True])
def test_autograd_function_glue(monkeypatch, remat):
    """``_BnRelu`` returns y, mean and var, gives h, gamma and beta their
    gradients, and none to mean and var; also under checkpoint (remat)."""
    x, gamma, beta, dy = _case(2, 16, 5, 6, seed=11)
    _emulated_launches(monkeypatch, beta)
    h, g, b = (t.clone().requires_grad_(True) for t in (x, gamma, beta))
    if remat:
        y, mean, var = checkpoint(op._BnRelu.apply, h, g, b, use_reentrant=False)
    else:
        y, mean, var = op._BnRelu.apply(h, g, b)
    assert not mean.requires_grad and not var.requires_grad
    y0, mean0, var0 = op.bn_relu_plain(x, gamma, beta)
    assert torch.equal(y, y0) and torch.equal(mean, mean0) and torch.equal(var, var0)
    (y * dy).sum().backward()
    for name, got, want in zip(("dh", "dgamma", "dbeta"), (h.grad, g.grad, b.grad),
                               _autograd(x, gamma, beta, dy)):
        _close(got, want, name)


def test_saved_rows_name_the_forward_buffer(monkeypatch):
    """``saved_rows`` reads the buffer the Function saved for its backward,
    row by row under the kernels' names."""
    x, gamma, beta, _ = _case(2, 16, 5, 6, seed=12)
    _emulated_launches(monkeypatch, beta)
    h = x.clone().requires_grad_(True)
    y, mean, var = op._BnRelu.apply(h, gamma, beta)
    rows = op.saved_rows(y)
    assert tuple(rows) == ("mean", "var", "inv", "scale", "shift", "diff", "a", "b")
    assert torch.equal(rows["mean"], mean) and torch.equal(rows["var"], var)


@pytest.mark.parametrize("n,c,h,w", SHAPES[:3])
def test_backward_terms_hold_the_closed_form_coefficients(n, c, h, w):
    """The terms the card's checks hold dh to: a and b from f64 sums agree
    with the f32 closed form's (checked against autograd above); each
    element's largest term is at least |a| and a third of |dh|."""
    x, gamma, beta, dy = _case(n, c, h, w, seed=c * 10 + w)
    terms, a, b = op.bn_relu_backward_terms(x, gamma, beta, dy)
    x32, _dz_scale, a32, b32, _dgamma, _dbeta = op._closed_form(x, gamma, beta, dy,
                                                                torch.float32)
    _close(a, a32, "a")
    _close(b, b32, "b")
    dh = _autograd(x, gamma, beta, dy)[0]
    assert terms.shape == dh.shape
    assert (terms >= a.abs()[:, None, None]).all()
    assert (3 * terms >= dh.abs() * (1 - RTOL)).all()


def test_row_pitch_reads_channels_last_rows_and_concat_slices():
    t = torch.empty((2, 16, 5, 7)).contiguous(memory_format=torch.channels_last)
    assert op._row_pitch(t) == 16
    cat = torch.cat([t, t], dim=1)  # channels_last, as the decoder's concat
    assert op._row_pitch(cat[:, :16]) == 32 and op._row_pitch(cat[:, 16:]) == 32
    assert op._row_pitch(torch.empty((2, 16, 5, 7))) is None  # NCHW
    assert op._row_pitch(t[:, :, :, ::2]) is None  # rows not evenly spaced
    assert op._row_pitch(torch.empty((2, 1, 5, 7))) == 1


def test_vector_path_needs_aligned_rows_of_whole_chunks():
    aligned = torch.empty(64, dtype=torch.bfloat16)
    assert op._vec(16, (aligned,)) == 1
    assert op._vec(12, (aligned,)) == 0  # 12 bf16 channels: 1.5 chunks a row
    assert op._vec(12, (aligned.float(),)) == 1  # 12 f32 channels: 3 chunks
    assert op._vec(16, (aligned[1:],)) == 0  # not 16-byte aligned
    assert op._vec(16, (aligned,), pitch=36) == 0  # a pitch of 4.5 chunks


def test_wrapper_checks_its_arguments():
    h = torch.zeros((1, 4, 2, 2))
    with pytest.raises(ValueError, match="gamma"):
        op.bn_relu(h, torch.ones(3), torch.zeros(4))
    with pytest.raises(ValueError, match="beta"):
        op.bn_relu(h, torch.ones(4), torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="h"):
        op.bn_relu(h.to(torch.int32), torch.ones(4), torch.zeros(4))


@pytest.mark.parametrize("topology,level_count,widths", [
    ("segnet", 3, [4, 4, 8, 8, 16, 16, 32, 32, 16, 16, 8, 8, 4, 4]),
    ("unet", 4, [4, 4, 8, 8, 16, 16, 32, 32, 64, 64, 32, 32, 16, 16, 8, 8, 4, 4]),
])
def test_apply_train_runs_the_op_in_every_unit_without_a_reducer(monkeypatch, topology,
                                                                  level_count, widths):
    """14 units in the flagship's depth (level 3), 18 in the U-Net's at
    level 4; the data-parallel path (a reducer) keeps bn_plain."""
    calls = []
    real = op.bn_relu

    def counting(*args):
        calls.append(args[0].shape[1])
        return real(*args)

    monkeypatch.setattr(op, "bn_relu", counting)
    config = segnet.SegNetConfig(class_count=3, level_count=level_count, base_width=4,
                                 topology=topology)
    params, stats = segnet.init_state(config, 0)
    p, s, _ = segnet.train_state_from_numpy(params, stats, None, "cpu")
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 16, 16, 3),
                                                           dtype=np.uint8))
    segnet.apply_train(p, s, x, config)
    assert calls == widths


def test_module_imports_and_runs_on_the_cpu_without_nvcc():
    code = ("import torch\n"
            "from annonet_tpu_torch.ops import _build, bn_relu\n"
            "h = torch.randn(2, 8, 3, 3)\n"
            "y, m, v = bn_relu.bn_relu(h, torch.ones(8), torch.zeros(8))\n"
            "assert _build._lib is None and y.shape == h.shape\n"
            "print('ok')\n")
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME=os.path.join(_ROOT, "no-cuda"),
               PYTHONPATH=os.pathsep.join([_ROOT, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
