"""Q1's accumulator mode (ops/qconv.py::qconv3x3_acc) and the diagnostic
tool that runs it (annonet_tpu_torch/tools/repro_qconv_s1.py) against the
JAX package on the CPU, at small sizes.

The accumulator is an exact int32 conv sum, so it is compared bit for bit:
with the int32 ``lax.conv_general_dilated`` that scripts/repro_mosaic_s1.py
takes as its accumulator reference, and, requantized, with the Pallas Q1
kernel in interpret mode on ``build_tap_gemms`` weights (the script's own
sweep call).
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from annonet_tpu.ops.int8_conv_mosaic import build_tap_gemms, qconv3x3_s1_requant
from annonet_tpu_torch.cli.common import DEVICE_ENV
from annonet_tpu_torch.ops import qconv
from annonet_tpu_torch.tools import repro_qconv_s1 as tool


def _jax_acc(x, w):
    dn = lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
    return np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), [(1, 1), (1, 1)], dimension_numbers=dn,
        preferred_element_type=jnp.int32,
    ))


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
@pytest.mark.parametrize("two_inputs", [False, True], ids=["one", "concat"])
def test_acc_plain_equals_jax_int32_conv(signed, two_inputs):
    rng = np.random.default_rng(20 + 2 * signed + two_inputs)
    n, h, w, c1, c2, cout = 2, 9, 21, 12, 8 if two_inputs else 0, 20
    lo = -127 if signed else 0
    x = rng.integers(lo, 128, (n, h, w, c1), dtype=np.int64).astype(np.int8)
    x2 = rng.integers(lo, 128, (n, h, w, c2), dtype=np.int64).astype(np.int8)
    wq = rng.integers(-127, 128, (3, 3, c1 + c2, cout), dtype=np.int64).astype(np.int8)
    got = qconv.qconv3x3_acc_plain(
        torch.from_numpy(x), torch.from_numpy(wq),
        torch.from_numpy(x2) if two_inputs else None,
    )
    want = _jax_acc(np.concatenate([x, x2], -1) if two_inputs else x, wq)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, h, w, cout)
    assert np.abs(want).max() > 2**16  # sums well past the int16 range
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
def test_requantized_acc_equals_pallas_q1(signed):
    # the script's sweep call: NHWC activations with C channels as the
    # kernel's WB x C, and the tap GEMMs of the 3x3 kernel itself
    rng = np.random.default_rng(30 + signed)
    x, wq, scale, offset = tool.make_inputs(rng, 1, 16, 24, 32, signed=signed)
    wl, wc, wr = build_tap_gemms(wq)
    want = np.asarray(qconv3x3_s1_requant(
        jnp.asarray(x), wl, wc, wr, jnp.asarray(scale), jnp.asarray(offset),
        rows=8, interpret=True,
    ))
    acc = qconv.qconv3x3_acc_plain(torch.from_numpy(x), torch.from_numpy(wq))
    got = qconv.requant_plain(acc, torch.from_numpy(scale), torch.from_numpy(offset))
    assert (want == 0).any() and (want > 0).any()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        qconv.qconv3x3_requant_plain(torch.from_numpy(x), torch.from_numpy(wq),
                                     torch.from_numpy(scale), torch.from_numpy(offset)).numpy(),
        want)


def test_acc_wrapper_checks_and_cpu_path():
    x = torch.zeros((1, 4, 5, 8), dtype=torch.int8)
    w = torch.ones((3, 3, 8, 4), dtype=torch.int8)
    qconv.qconv3x3_acc.launches = 0
    out = qconv.qconv3x3_acc(x + 1, w)
    assert out.dtype == torch.int32 and qconv.qconv3x3_acc.launches == 0  # CPU: plain
    assert out[0, 1, 1, 0].item() == 72 and out[0, 0, 0, 0].item() == 32
    with pytest.raises(ValueError):
        qconv.qconv3x3_acc(x, torch.ones((3, 3, 7, 4), dtype=torch.int8))
    with pytest.raises(ValueError):
        qconv.qconv3x3_acc(x.float(), w)
    with pytest.raises(ValueError):
        qconv.qconv3x3_acc(x, w, torch.zeros((1, 4, 6, 2), dtype=torch.int8))


def _run_tool(monkeypatch, argv):
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = tool.main(argv)
    return code, buf.getvalue()


@pytest.mark.parametrize("signed", [[], ["--signed"]], ids=["unsigned", "signed"])
def test_tool_sweep_on_the_cpu(monkeypatch, signed):
    code, text = _run_tool(monkeypatch, ["--stage", "sweep", *signed])
    cpu = [cfg for cfg in tool.CONFIGS if cfg[0] * cfg[1] <= tool.CPU_MAX_NH]
    assert code == 0 and "FAILURES: []" in text
    assert text.count("mismatches = 0") == len(cpu) == 4


def test_tool_configs_are_the_scripts_without_the_block_knobs():
    script = [  # scripts/repro_mosaic_s1.py:69-92 as (n, h, wb, c, rows, flatten)
        (1, 8, 128, 128, 8, False), (1, 64, 128, 128, 8, False), (1, 64, 128, 128, 16, False),
        (2, 64, 128, 128, 8, False), (1, 8, 128, 128, 8, True), (1, 64, 128, 128, 8, True),
        (1, 872, 128, 128, 8, False), (1, 872, 128, 128, 8, True), (25, 872, 128, 128, 8, False),
        (4, 109, 128, 128, 1, False), (1, 436, 128, 256, 4, False), (1, 436, 64, 128, 4, False),
        (1, 218, 32, 128, 2, False), (1, 218, 32, 256, 2, False), (1, 109, 16, 256, 1, False),
        (4, 64, 16, 128, 8, False), (4, 64, 8, 128, 8, False), (1, 436, 54, 128, 4, False),
        (1, 218, 27, 128, 2, False),
    ]
    assert list(tool.CONFIGS) == list(dict.fromkeys(cfg[:4] for cfg in script))


@pytest.mark.parametrize("argv", [[], ["--signed", "--cfg", "2", "5", "9", "24"]],
                         ids=["default", "signed-cfg"])
def test_tool_bisect_on_the_cpu(monkeypatch, argv):
    code, text = _run_tool(monkeypatch, ["--stage", "bisect", *argv])
    assert code == 0 and "VERDICT: none" in text
    assert "accumulator mismatches = 0" in text and "full-kernel mismatches = 0" in text


@pytest.mark.parametrize("stage", ["composed", "prefix"])
def test_tool_refuses_the_mosaic_stages(monkeypatch, capsys, stage):
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    assert tool.main(["--stage", stage]) == 2
    assert "not ported" in capsys.readouterr().err


def test_tool_needs_the_card_unless_asked(monkeypatch, capsys):
    monkeypatch.delenv(DEVICE_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main(["--stage", "sweep"]) == 2
    assert DEVICE_ENV in capsys.readouterr().err
