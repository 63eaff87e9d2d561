"""annonet_tpu_torch — the PyTorch + CUDA port of annonet_tpu for NVIDIA
Hopper (H100).

The JAX package ``annonet_tpu`` stays the reference; this package keeps its
structure and names so each module's counterpart is easy to find:

  models/segnet.py     SegNetConfig, the BN-folded runtime net, the training
                       net (init_state, apply_train, fold_batchnorm)
  models/quantized.py  the int8 net (Q1-Q3: csrc/qconv_igemm.cu, qup_igemm.cu)
  models/folded_runtime.py  the folded net of use_pallas_conv (G1)
  serialization.py     the annonet.dnn npz artifact (same keys and checks)
  ops/conv.py          K1-K3: fused conv + bias + ReLU (CUDA, csrc/conv.cu,
                       conv_igemm.cu, up_igemm.cu)
  ops/gemm_conv.py     G1: the folded 3x3 conv as three block-sparse GEMMs
                       (CUDA, csrc/gemm_conv.cu)
  ops/blend.py         K4: blend + normalise + gains argmax + seeds
                       (CUDA, csrc/blend.cu)
  ops/loss.py, weighting.py, augment.py, crop_gather.py  the training step's
                       ops (plain PyTorch, as the JAX package's are XLA)
  infer/               tile planning, TiledInferer, confusion matrices
  data/                dataset scan, image/mask reading, label codec; the
                       training crops, filters, LRU cache, loader pipeline,
                       synthetic detection set
  train/               Trainer (SGD, plateau loop, sync file), the device
                       image pool, the plateau statistics
  classes.py, native.py  the class palette codec and the native host module
  utils/               process priority, the torch.profiler trace, metrics
  cli/infer.py         annonet_infer (reader and writer threads, groups in
                       flight on the device)
  cli/train.py         annonet_train
  cli/serve.py         annonet_serve (the JAX server's HTTP protocol, dynamic
                       batching, hot reload, the int8 calibration endpoint)
  cli/inspect.py       annonet_inspect
  client.py            the Python client of annonet_serve (stdlib + numpy)
  tools/               repro_qconv_s1 (Q1's diagnostic), measure_detection
                       (the detection benchmark)

This package imports neither ``jax`` nor anything of ``annonet_tpu``; it
keeps its own copies of what it needs from the JAX package's jax-free
modules. Every kernel has a plain PyTorch version beside it, which its
wrapper runs for CPU tensors; CUDA tensors always go through the kernel.
"""

__version__ = "0.1.0"
