"""The port's int8 straight-through training (annonet_tpu_torch/ops/
int8_train.py) against the JAX package's ops/int8_train.py, on the CPU.

On CPU tensors Q1's and Q2's accumulator modes run their plain versions
(exact float64 sums), and JAX's int32 conv is exact, so the quantized
operands, the int32 sums and the dequantized forward must be equal bit for
bit at both strides, in f32 and bf16. The straight-through backward is the
exact conv's own backward (``_conv_train``), bit for bit. Through the net,
the int8 forward stays within 5e-2 of the scale of JAX's int8 logits
(bf16, as the training tests hold bf16), and within 1e-4 in f32. The
rest mirrors tests/test_int8_train.py: it trains the separable task,
composes with remat, is active under data parallelism (the DP int8 step
equals the single-device int8 step within rtol 1e-4, JAX's own check) and
the QAT net serves int8 with high agreement.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annonet_tpu.models.segnet import SegNetConfig as JaxSegNetConfig
from annonet_tpu.models.segnet import apply_train as jax_apply_train
from annonet_tpu.models.segnet import init_state as jax_init_state
from annonet_tpu.ops import int8_train as jax_int8
from annonet_tpu_torch.data.crop import CropOptions
from annonet_tpu_torch.models.segnet import (
    SegNetConfig,
    _conv_train,
    apply_train,
    fold_batchnorm,
    train_state_from_numpy,
    tree_items,
)
from annonet_tpu_torch.ops import int8_train, qconv
from annonet_tpu_torch.parallel import ensure_virtual_devices
from annonet_tpu_torch.parallel.train import DataParallelTrainer
from annonet_tpu_torch.train import Trainer, TrainerConfig

_DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _xw(seed, n=2, h=12, cin=8, cout=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, h, h, cin)).astype(np.float32),
            (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32))


def _nchw(x, dtype):
    return torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype)


def int8_conv_ste(x, w, stride, dtype):
    """One shard's straight-through int8 conv, as apply_train runs it."""
    return int8_train.int8_convs([x.to(dtype)], [w], stride, dtype)[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("cin", [3, 8, 40])
def test_forward_equals_jax_bit_for_bit(stride, dtype, cin):
    """The quantized operands, the int32 sums and the dequantized output
    equal JAX's _quantize_sym and _int8_conv on the same f32 inputs (cin 3
    takes Q1's paired packing, 40 two channel chunks)."""
    jdt, tdt = _DTYPES[dtype]
    x, w = _xw(stride * 7 + cin, cin=cin)
    xj, wj = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    xq_j, sx_j = jax_int8._quantize_sym(xj, axes=None)
    wq_j, sw_j = jax_int8._quantize_sym(wj, axes=(0, 1, 2))
    acc_j = jax.lax.conv_general_dilated(xq_j, wq_j, (stride, stride), "SAME",
                                         dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                         preferred_element_type=jnp.int32)
    out_j = jax_int8._int8_conv(xj, wj, stride, None)

    xt, wt = _nchw(x, tdt), torch.from_numpy(w).to(tdt)
    amax = xt.abs().amax().float()
    xq, sx = int8_train.quantize_activation(xt, amax)
    wq, sw = int8_train.quantize_weight(wt)
    assert torch.equal(xq, torch.from_numpy(np.array(xq_j)))
    assert torch.equal(wq, torch.from_numpy(np.array(wq_j)))
    assert float(sx) == float(np.asarray(sx_j).reshape(()))
    assert np.array_equal(sw.numpy(), np.asarray(sw_j).reshape(-1))
    acc = qconv.qconv3x3_acc(xq, wq) if stride == 1 else qconv.qconv3x3_s2_acc(xq, wq)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_j))
    out = int8_conv_ste(xt, torch.from_numpy(w), stride, tdt)
    assert out.dtype == tdt
    np.testing.assert_array_equal(out.float().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(out_j.astype(jnp.float32)))


@pytest.mark.parametrize("stride", [1, 2])
def test_ste_backward_is_the_exact_convs(stride):
    """A fixed cotangent through the STE conv and through the exact conv
    gives the same gradients bit for bit, for the input and the kernel."""
    x, w = _xw(3)
    xt = _nchw(x, torch.float32).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        _conv_train(xt, wt, stride, torch.float32).shape).astype(np.float32))
    got = torch.autograd.grad(int8_conv_ste(xt, wt, stride, torch.float32),
                              (xt, wt), g)
    want = torch.autograd.grad(_conv_train(xt, wt, stride, torch.float32), (xt, wt), g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_int8_forward_error_bounded_by_grid():
    x, w = _xw(2, cin=16)
    out_q = int8_conv_ste(_nchw(x, torch.float32), torch.from_numpy(w), 1,
                                     torch.float32)
    out_e = _conv_train(_nchw(x, torch.float32), torch.from_numpy(w), 1, torch.float32)
    sx, sw = np.abs(x).max() / 127.0, np.abs(w).max(axis=(0, 1, 2)) / 127.0
    bound = 9 * 16 * (sx / 2 * np.abs(w).max() + sw / 2 * np.abs(x).max())
    diff = (out_q - out_e).abs().max().item()
    assert diff <= bound.max()
    assert diff / out_e.abs().max().item() < 0.05


def _state(config, seed=0):
    jcfg = JaxSegNetConfig(**config.to_dict())
    p, s = jax_init_state(jax.random.PRNGKey(seed), jcfg)
    p, s = jax.tree_util.tree_map(np.asarray, (p, s))
    return jcfg, p, s


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_apply_train_int8_close_to_jax(dtype, tol):
    """The net with the int8 conv against JAX's apply_train with
    int8_conv_ste, from one state: the logits within ``tol`` of their scale
    (an int8 level flips where the two frameworks' bf16 activations round
    apart), the new statistics too."""
    config = SegNetConfig(class_count=2, level_count=2, base_width=8, compute_dtype=dtype)
    jcfg, p, s = _state(config)
    x = np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3), np.uint8)
    logits_j, stats_j = jax.jit(
        lambda a, b, c: jax_apply_train(a, b, c, jcfg, conv_impl=jax_int8.int8_conv_ste)
    )(p, s, jnp.asarray(x))
    tp, ts, _v = train_state_from_numpy(p, s, None, "cpu")
    with torch.no_grad():
        logits, stats = apply_train(tp, ts, torch.from_numpy(x), config,
                                    conv_impl=int8_train.int8_convs)
    logits_j = np.asarray(logits_j)
    assert np.abs(logits.numpy() - logits_j).max() <= tol * np.abs(logits_j).max()
    ref = dict(tree_items(jax.tree_util.tree_map(np.asarray, stats_j)))
    for k, v in tree_items(stats):
        assert np.abs(v.numpy() - ref[k]).max() <= tol * max(np.abs(ref[k]).max(), 1.0), k


def _separable(rng, n, dim):
    lab = rng.integers(0, 2, (n, dim, dim)).astype(np.uint16)
    img = np.repeat(np.where(lab[..., None] == 1, 200, 50).astype(np.uint8), 3, axis=-1)
    return img, lab


def test_int8_step_trains_separable_task():
    config = SegNetConfig(class_count=2, level_count=1, base_width=8)
    trainer = Trainer(config, TrainerConfig(initial_learning_rate=0.05, int8_forward=True),
                      seed=0, device="cpu")
    rng = np.random.default_rng(1)
    losses = [trainer.train_step_crops(*_separable(rng, 4, 32), CropOptions(dim=32))
              for _ in range(12)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.5


def test_int8_forward_composes_with_remat():
    config = SegNetConfig(class_count=2, level_count=1, base_width=8, compute_dtype="float32")
    rng = np.random.default_rng(2)
    images, labels = _separable(rng, 2, 32)
    runs = []
    for remat in (False, True):
        trainer = Trainer(config, TrainerConfig(int8_forward=True, remat=remat), seed=0,
                          device="cpu")
        loss = trainer.train_step_crops(images, labels, CropOptions(dim=32))
        runs.append((loss, dict(tree_items(trainer.params))))
    assert np.isfinite(runs[1][0]) and runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


def test_int8_forward_active_under_data_parallel():
    """The DP int8 step (one activation scale over every shard) equals the
    single-device int8 step, and differs from the float step."""
    config = SegNetConfig(class_count=2, level_count=1, base_width=8, compute_dtype="float32")
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (8, 32, 32, 3), np.uint8)
    labels = rng.integers(0, 2, (8, 32, 32)).astype(np.uint16)
    co = CropOptions(dim=32)
    tc = TrainerConfig(initial_learning_rate=0.01, int8_forward=True)
    single = Trainer(config, tc, seed=0, device="cpu")
    dp = DataParallelTrainer(config, tc, seed=0, mesh=ensure_virtual_devices(8, "cpu"))
    loss_single = single.train_step_crops(images, labels, co)
    loss_dp = dp.train_step_crops(images, labels, co)
    assert np.isclose(loss_single, loss_dp, rtol=1e-4), (loss_single, loss_dp)
    for (k, a), (_k, b) in zip(tree_items(dp.params), tree_items(single.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)
    exact = Trainer(config, TrainerConfig(initial_learning_rate=0.01), seed=0, device="cpu")
    assert abs(exact.train_step_crops(images, labels, co) - loss_dp) > 1e-7


def test_qat_trained_net_serves_int8_with_high_agreement():
    from annonet_tpu_torch.infer.core import TiledInferer
    from annonet_tpu_torch.infer.tiling import TilingParameters

    config = SegNetConfig(class_count=2, level_count=1, base_width=8)
    trainer = Trainer(config, TrainerConfig(initial_learning_rate=0.05, int8_forward=True),
                      seed=0, device="cpu")
    rng = np.random.default_rng(5)
    for _ in range(25):
        trainer.train_step_crops(*_separable(rng, 8, 48), CropOptions(dim=48), seed=1)
    runtime = fold_batchnorm(trainer.params, trainer.bn_stats, config)
    tiling = TilingParameters(64, 64, 16, 16)
    lab = rng.integers(0, 2, (96, 96)).astype(np.uint16)
    img = np.repeat(np.where(lab[..., None] == 1, 200, 50).astype(np.uint8), 3, -1)
    labels_f, _ = TiledInferer(runtime, config, tiling, device="cpu").infer_arrays(img)
    int8_inf = TiledInferer(runtime, config, tiling, quantize="int8", device="cpu")
    int8_inf.infer_arrays(img)  # the first image calibrates
    labels_q, _ = int8_inf.infer_arrays(img)
    assert (labels_f == lab).mean() > 0.95
    assert (labels_q == lab).mean() > 0.95
    assert (labels_f == labels_q).mean() > 0.98


def test_qconv_s2_acc_plain_and_wrapper_checks():
    """Q2's accumulator mode on the CPU: its plain version is the exact
    int32 conv at stride 2, padding (0, 1); the wrapper runs it on CPU
    tensors without counting a launch and refuses what the kernel cannot
    take."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.integers(-127, 128, (2, 8, 10, 20), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (3, 3, 20, 5), dtype=np.int8))
    want = torch.nn.functional.conv2d(
        torch.nn.functional.pad(x.permute(0, 3, 1, 2).double(), (0, 1, 0, 1)),
        w.permute(3, 2, 0, 1).double(), stride=2).permute(0, 2, 3, 1)
    qconv.qconv3x3_s2_acc.launches = 0
    got = qconv.qconv3x3_s2_acc(x, w)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 4, 5, 5)
    assert torch.equal(got, want.to(torch.int32))
    assert qconv.qconv3x3_s2_acc.launches == 0
    with pytest.raises(ValueError, match="even"):
        qconv.qconv3x3_s2_acc(x[:, :7].contiguous(), w)
    with pytest.raises(ValueError, match="int8"):
        qconv.qconv3x3_s2_acc(x.float(), w)
    with pytest.raises(ValueError, match="packed"):
        qconv.qconv3x3_s2_acc(x, w, packed=qconv.pack_q1_weights(w)[..., :16].contiguous())
