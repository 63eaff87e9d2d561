"""The port's folded net and its inferer (annonet_tpu_torch/models/
folded_runtime.py, ``TiledInferer(use_pallas_conv=True)``) against the JAX
package's ``fold_runtime_params(..., pallas_s1=True)``, ``split_folded``,
``apply_folded_split`` and ``TiledInferer(use_pallas_conv=True)`` on the
CPU, the Pallas GEMM conv in interpret mode.

The fold schedule, the spec, the concat permutation and the G1 weight
triples equal JAX's exactly. Tolerances: the f32 logits within 1e-4
(rtol and atol; the same products summed in another order); the bf16
logits within ``test_torch_model.BF16_TOL`` of their scale, since each
framework's CPU bf16 conv accumulates in its own order and a rounding step
of 2**-8 relative in one layer travels through the later ones; the tiled
inferers' labels and seeds on >= 99.9% (f32) and >= 99.5% (bf16) of the
pixels on the same plan (JAX's folded planner differs from the port's:
it is pinned to the port's plan).
"""

import dataclasses
import os
import re

import jax
import numpy as np
import pytest
import torch

from annonet_tpu.infer.core import TiledInferer as JaxTiledInferer
from annonet_tpu.infer.tiling import TilingParameters as JaxTilingParameters
from annonet_tpu.models import folded_runtime as jfr
from annonet_tpu.models.segnet import SegNetConfig as JaxSegNetConfig
from annonet_tpu_torch.infer.core import TiledInferer
from annonet_tpu_torch.infer.tiling import TilingParameters
from annonet_tpu_torch.models import folded_runtime as fr
from annonet_tpu_torch.models.quantized import int8_fold
from annonet_tpu_torch.models.segnet import SegNetConfig, required_input_dimension
from tests.test_torch_model import BF16_TOL, jax_runtime_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_apply_folded = jax.jit(jfr.apply_folded_split,
                        static_argnames=("config", "fold0", "spec", "folded_output"))


def _jax_folded(config: SegNetConfig, seed: int, fold0: int):
    jcfg = JaxSegNetConfig(**config.to_dict())
    tree = jax_runtime_tree(config, seed)
    fparams = jfr.fold_runtime_params(tree, jcfg, fold0, pallas_s1=True)
    return jcfg, tree, fparams


@pytest.mark.parametrize("fold,c1,c2", [(8, 16, 16), (4, 32, 32), (2, 64, 64), (8, 3, 5),
                                        (1, 4, 4)])
def test_concat_perm_equals_jax(fold, c1, c2):
    np.testing.assert_array_equal(fr._concat_perm(fold, c1, c2), jfr._concat_perm(fold, c1, c2))


def test_folding_supported_equals_jax():
    assert int8_fold is fr.folding_supported
    for level_count in range(4):
        for base_width in (4, 8, 16, 24, 32):
            config = SegNetConfig(level_count=level_count, base_width=base_width)
            jcfg = JaxSegNetConfig(**config.to_dict())
            for width in (64, 72, 96, 100, 128, 896, 1000):
                assert fr.folding_supported(config, width) == \
                    jfr.folding_supported(jcfg, width), (config, width)


SPEC_CONFIGS = {
    "flagship_narrow": SegNetConfig(class_count=3, level_count=3, base_width=4),
    "flagship_gray": SegNetConfig(class_count=3, level_count=3, base_width=4, grayscale=True),
    "l1_w16": SegNetConfig(class_count=2, level_count=1, base_width=16),
    "l2_fold4": SegNetConfig(class_count=4, level_count=2, base_width=32),
}


@pytest.mark.parametrize("name", list(SPEC_CONFIGS))
def test_spec_and_g1_weights_equal_jax(name):
    config = dataclasses.replace(SPEC_CONFIGS[name], compute_dtype="float32")
    fold0 = fr.folding_supported(config, 896)
    assert fold0 >= 2
    _jcfg, tree, fparams = _jax_folded(config, 3, fold0)
    (jf0, jspec), _arrays = jfr.split_folded(fparams)
    assert fr.folded_spec(config, fold0) == (jf0, jspec)
    assert any(kind.startswith("s1p:") for kind in jspec)
    ours = fr.folded_params_from_numpy(tree, config, fold0, "cpu")
    theirs = fr.folded_params_from_numpy(fparams, config, fold0, "cpu")
    assert ours.keys() == theirs.keys()
    for key in ours:
        assert torch.equal(ours[key], theirs[key]), key
    for (kind, name, _f), (jkind, a, _b) in zip(fr.folded_entries(config, fold0),
                                                fparams["layers"]):
        if kind.startswith("s1p:"):  # the triples, bit for bit
            for leaf, m in zip(("wc", "wl", "wr"), a):
                np.testing.assert_array_equal(ours[f"{name}/{leaf}"].numpy(), m)


def test_spec_needs_a_fold_that_survives_the_levels():
    config = SegNetConfig(class_count=3, level_count=3, base_width=4)
    with pytest.raises(ValueError, match="folding_supported"):
        fr.folded_spec(config, 4)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grayscale", [False, True], ids=["rgb", "gray"])
@pytest.mark.parametrize("level_count", [1, 2])
def test_folded_net_matches_apply_folded_split(level_count, grayscale, compute_dtype):
    config = SegNetConfig(class_count=3, level_count=level_count, base_width=4,
                          grayscale=grayscale, compute_dtype=compute_dtype)
    fold0 = 8
    jcfg, tree, fparams = _jax_folded(config, 11 + level_count, fold0)
    (f0, spec), arrays = jfr.split_folded(fparams)
    x = np.random.default_rng(level_count).integers(
        0, 256, (2, 16, 64, config.in_channels), dtype=np.uint8)
    want = np.asarray(_apply_folded(arrays, x, jcfg, fold0=f0, spec=spec))
    layers = [(k, a, b) for k, a, b in fparams["layers"]]  # JAX's list, as numpy
    for source in (tree, layers):
        net = fr.FoldedSegNet(source, config, fold0, device="cpu")
        with torch.inference_mode():
            got = net(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape == (2, 16, 64, 3) and got.dtype == np.float32
        if compute_dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        else:
            assert np.abs(got - want).max() <= BF16_TOL * max(1.0, np.abs(want).max())


def test_folded_net_taps_every_conv_and_up_layer():
    config = SegNetConfig(class_count=3, level_count=2, base_width=4, compute_dtype="float32")
    net = fr.FoldedSegNet(jax_runtime_tree(config, 1), config, 8, device="cpu")
    seen = {}
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (1, 8, 32, 3), dtype=np.uint8))
    with torch.inference_mode():
        net(x, tap=lambda name, a: seen.__setitem__(name, tuple(a.shape)))
    assert list(seen) == ["stem/conv0", "stem/conv1", "enc1/conv0", "enc1/conv1", "enc2/conv0",
                          "enc2/conv1", "dec2/up", "dec2/conv0", "dec1/up", "dec1/conv0"]
    assert seen["dec2/conv0"] == (1, 4, 16, 8) and seen["dec1/conv0"] == (1, 8, 32, 4)
    with pytest.raises(ValueError, match="multiple of the fold"):
        net(x[:, :, :28].contiguous())


# --------------------------------------------------------------------------
# TiledInferer(use_pallas_conv=True) against JAX's
# --------------------------------------------------------------------------

SHAPE = (120, 150, 3)


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(9)
    coarse = rng.integers(0, 256, size=(8, 10, 3)).astype(np.float32)
    smooth = np.kron(coarse, np.ones((16, 16, 1)))[: SHAPE[0], : SHAPE[1]]
    return np.clip(smooth + rng.integers(-20, 21, size=SHAPE), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("compute_dtype,floor", [("float32", 0.999), ("bfloat16", 0.995)])
@pytest.mark.parametrize("levels", [None, [0.0, 0.3, 0.1]], ids=["plain", "detection"])
def test_inferer_agrees_with_jax(image, compute_dtype, floor, levels):
    config = SegNetConfig(class_count=3, level_count=2, base_width=4,
                          compute_dtype=compute_dtype)
    tree = jax_runtime_tree(config, 21)
    rf = required_input_dimension(config)
    tiling = TilingParameters(64, 64, rf, rf)
    gains = [0.0, 0.15, -0.1]
    ours = TiledInferer(tree, config, tiling, device="cpu", use_pallas_conv=True)
    plan = ours.plan(*SHAPE[:2])
    assert plan.tile_count > 4 and fr.folding_supported(config, plan.tile_width) == 8
    theirs = JaxTiledInferer(tree, JaxSegNetConfig(**config.to_dict()),
                             JaxTilingParameters(**dataclasses.asdict(tiling)),
                             use_pallas_conv=True)
    theirs._plan_override = plan  # the port's plan (JAX's folded planner differs)
    labels, seeds = ours.infer_arrays(image, gains, levels)
    want_labels, want_seeds = theirs.infer_arrays(image, gains, levels)
    assert list(ours._folded) == [8] and isinstance(ours._float_net(plan), fr.FoldedSegNet)
    assert labels.shape == SHAPE[:2] and len(np.unique(labels)) > 1
    assert (labels == want_labels).mean() >= floor
    if levels is None:
        assert seeds is None and want_seeds is None
    else:
        assert seeds.any() and (seeds == want_seeds).mean() >= floor


def test_plans_that_do_not_fold_run_the_unfolded_net(image):
    config = SegNetConfig(class_count=3, level_count=3, base_width=32,
                          compute_dtype="float32")  # 8 * 32 > 128: fold 4 < 2**3
    tree = jax_runtime_tree(config, 4)
    rf = required_input_dimension(config)
    tiling = TilingParameters(128, 128, rf, rf)
    pallas = TiledInferer(tree, config, tiling, device="cpu", use_pallas_conv=True)
    plan = pallas.plan(*SHAPE[:2])
    assert fr.folding_supported(config, plan.tile_width) == 0
    assert pallas._float_net(plan) is pallas.net
    default = TiledInferer(tree, config, tiling, device="cpu")
    np.testing.assert_array_equal(pallas.infer_arrays(image)[0], default.infer_arrays(image)[0])
    assert not pallas._folded


def test_int8_with_use_pallas_conv_raises_in_both_packages():
    config = SegNetConfig(class_count=3, level_count=1, base_width=16)
    tree = jax_runtime_tree(config, 2)
    with pytest.raises(ValueError, match="use_pallas_conv"):
        TiledInferer(tree, config, device="cpu", quantize="int8", use_pallas_conv=True)
    with pytest.raises(ValueError, match="use_pallas_conv"):
        JaxTiledInferer(tree, JaxSegNetConfig(**config.to_dict()), quantize="int8",
                        use_pallas_conv=True)
    assert TiledInferer(tree, config, device="cpu").use_pallas_conv is False


# --------------------------------------------------------------------------
# the port stands alone: no import of jax or of the JAX package
# --------------------------------------------------------------------------

_IMPORTS = re.compile(r"^\s*(?:from|import)\s+(annonet_tpu|jax)\b(?!_torch)", re.M)


def test_no_port_file_imports_jax_or_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "annonet_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path, encoding="utf-8") as f:
            found = _IMPORTS.findall(f.read())
        assert not found, f"{os.path.relpath(path, REPO)} imports {found}"
