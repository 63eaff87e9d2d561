"""int8 conv + requant: the three int8 kernels of the quantized net.

Each op has a plain PyTorch version (``*_plain``) and a wrapper. The
wrapper checks its arguments; for tensors on the CPU it returns the plain
version, for CUDA tensors it launches the hand-written kernel
(``csrc/qconv_igemm.cu`` for Q1 and Q2 and their accumulator modes,
``csrc/qup_igemm.cu`` for Q3, all on the int8 tensor cores) on the current
stream (or raises: there is no fallback from a CUDA tensor to the plain
version) and adds one to its ``launches`` count.

Layouts: activations NHWC int8 ([N, H, W, C], contiguous, the post-ReLU
grid [0, 127] except the input image's [-127, 127]), weights HWIO int8,
requant scale and offset f32. Output NHWC int8. The kernels read their
weights packed as the tensor cores' "col" B operand wants them, each
output column's K contiguous: Q1 and Q2 as ``pack_q1_weights`` lays them
out (the same at either stride), Q3 as ``pack_q3_weights``. The wrappers
take the HWIO weights and, optionally, that packed copy made once per
layer (``models/quantized.py``), checked on either device, else they pack
on each call.

Every op is ``requant(acc)`` of an exact int32 conv sum ``acc``:

    q = int8(clip(fma(float32(acc), scale, offset), 0, 127))

the ReLU and the round-half-up ride in the clip and in the +0.5 inside
``offset`` (quantized_runtime.py:381-388), so the float -> int8 step
truncates. ``fma`` is one singly rounded multiply-add: XLA contracts
``acc * scale + offset`` into an FMA on the CPU, and the kernels use
``__fmaf_rn``; ``fma_f32`` emulates it exactly. The plain versions sum in
float64, where every int32 sum of int8 products is exact (cuDNN stays off:
its algorithms need not be).

  Q1 qconv3x3_requant      3x3, stride 1, zero padding (1, 1); optional
                           second input ``x2`` whose channels follow
                           ``x``'s (the decoder's concat([up, skip]))
     qconv3x3_acc          Q1's accumulator mode: the int32 sums ``acc``
                           before the requant, [N, H, W, C'] int32 (the raw
                           accumulator of scripts/repro_mosaic_s1.py's
                           bisect; tools/repro_qconv_s1.py runs it)
  Q2 qconv3x3_s2_requant   3x3, stride 2, zero padding (0, 1) on even H, W
     qconv3x3_s2_acc       Q2's accumulator mode: the int32 sums, [N, H/2,
                           W/2, C'] int32 (the forward of int8 training's
                           stride-2 layers, ops/int8_train.py; Q1's
                           accumulator mode serves its stride-1 layers)
  Q3 qup2x2_requant        2x2 stride-2 transpose conv,
                           out[2i+u, 2j+v] = requant_v(x[i, j] . w[1-u, 1-v])
                           with scale and offset [2, C'] indexed by the
                           output column's parity v
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from annonet_tpu_torch.ops import _build


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding (an FMA), for float32 inputs.

    The float64 product of two float32 values is exact; the float64 sum is
    made round-to-odd (TwoSum error, then a step away from an even last
    bit), which makes its rounding to float32 the correct rounding of the
    exact value."""
    a, b, c = a.double(), b.double(), c.double()
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    s = torch.where(inexact_even, torch.nextafter(s, toward), s)
    return s.float()


def requant_plain(acc: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor):
    """int8(clip(fma(float32(acc), scale, offset), 0, 127)), truncating."""
    f = fma_f32(acc.to(torch.float32), scale, offset)
    return f.clamp(0.0, 127.0).to(torch.int8)


def _exact_f64(fn, *args, **kwargs):
    # float64 integer sums are exact in any order; keep cuDNN out, whose
    # algorithms (FFT, Winograd) need not be
    with torch.backends.cudnn.flags(enabled=False):
        return fn(*args, **kwargs)


def _nchw64(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).to(torch.float64)


def _oihw64(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1).to(torch.float64)


def qconv3x3_acc_plain(x, w, x2: Optional[torch.Tensor] = None):
    if x2 is not None:
        x = torch.cat([x, x2], dim=-1)
    acc = _exact_f64(F.conv2d, _nchw64(x), _oihw64(w), padding=1)
    return acc.permute(0, 2, 3, 1).to(torch.int32).contiguous()


def qconv3x3_requant_plain(x, w, scale, offset, x2: Optional[torch.Tensor] = None):
    return requant_plain(qconv3x3_acc_plain(x, w, x2), scale, offset).contiguous()


def qconv3x3_s2_acc_plain(x, w):
    # explicit (0, 1) padding: padding=1 would pad (1, 1)
    xp = F.pad(_nchw64(x), (0, 1, 0, 1))
    acc = _exact_f64(F.conv2d, xp, _oihw64(w), stride=2)
    return acc.permute(0, 2, 3, 1).to(torch.int32).contiguous()


def qconv3x3_s2_requant_plain(x, w, scale, offset):
    return requant_plain(qconv3x3_s2_acc_plain(x, w), scale, offset).contiguous()


def qup2x2_requant_plain(x, w, scale, offset):
    # conv_transpose2d computes out[2i+u, 2j+v] = x[i, j] . W[:, :, u, v];
    # the net's transpose conv uses the flipped kernel w[1-u, 1-v]
    wt = torch.flip(w, dims=(0, 1)).permute(2, 3, 0, 1).to(torch.float64)
    acc = _exact_f64(F.conv_transpose2d, _nchw64(x), wt, stride=2)
    acc = acc.permute(0, 2, 3, 1)  # [N, 2H, 2W, C']
    parity = torch.arange(acc.shape[2], device=acc.device) % 2
    return requant_plain(acc, scale[parity], offset[parity]).contiguous()


def _check(x, w, scale, offset, kh, kw, cin, scale_shape, what):
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"{what}: expected x [N,H,W,C] and w [kh,kw,cin,cout]")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(f"{what}: x and w must be int8 (got {x.dtype}, {w.dtype})")
    if tuple(w.shape[:3]) != (kh, kw, cin):
        raise ValueError(
            f"{what}: weight {tuple(w.shape)} does not match a {kh}x{kw} "
            f"conv over {cin} input channels"
        )
    shape = scale_shape + (w.shape[3],)
    vectors = () if scale is None else (scale, offset)  # None: no requant
    for t in vectors:
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{what}: scale and offset must be float32 {list(shape)}")
    for t in (x, w, *vectors):
        if t.device != x.device:
            raise ValueError(f"{what}: all tensors must be on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


# layers of at most this many input channels fill half of an int8 k32 step:
# two row taps share one (csrc/qconv_igemm.cu, PAIR; Q1 and Q2)
Q1_PAIR_CIN = 16


def pack_q1_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO [3, 3, cin, cout] int8 -> the B operand of Q1 and Q2 [chunks,
    units, cout, 32] int8, zero-padded: unit u of chunk t holds, for each
    output channel, the 32 bytes of one int8 k32 step (at either stride).

    cin > 16: chunk t covers channels 32t .. 32t + 31, unit dy*3 + dx the
    tap (dy, dx). cin <= 16: one chunk of 6 units, unit dx*2 holding taps
    (0, dx) in bytes 0-15 and (1, dx) in bytes 16-31, unit dx*2 + 1 the tap
    (2, dx) in bytes 0-15."""
    if w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) or w.dtype != torch.int8:
        raise ValueError(f"pack_q1_weights: expected int8 [3,3,cin,cout], got "
                         f"{tuple(w.shape)} {w.dtype}")
    cin, cout = w.shape[2], w.shape[3]
    taps = w.permute(0, 1, 3, 2)  # [dy, dx, cout, cin]
    if cin <= Q1_PAIR_CIN:
        p = w.new_zeros((3, 2, cout, 32))
        p[:, 0, :, :cin] = taps[0]
        p[:, 0, :, 16 : 16 + cin] = taps[1]
        p[:, 1, :, :cin] = taps[2]
        return p.reshape(1, 6, cout, 32)
    chunks = -(-cin // 32)
    p = w.new_zeros((3, 3, cout, chunks * 32))
    p[..., :cin] = taps
    return p.reshape(9, cout, chunks, 32).permute(2, 0, 1, 3).contiguous()


def _q1_shape(cin: int, cout: int):
    return (1, 6, cout, 32) if cin <= Q1_PAIR_CIN else (-(-cin // 32), 9, cout, 32)


def _checked_packed(x, packed, shape, what):
    """``packed`` if it is a contiguous int8 ``shape`` on x's device, else
    raises."""
    if (packed.dtype != torch.int8 or tuple(packed.shape) != tuple(shape)
            or packed.device != x.device or not packed.is_contiguous()):
        raise ValueError(f"{what}: packed weights must be contiguous int8 "
                         f"{list(shape)} on {x.device}, got "
                         f"{tuple(packed.shape)} {packed.dtype} on {packed.device}")
    return packed


def _q1_packed(x, c2, w, packed, what):
    """The packed weights of a launch: ``packed`` checked (on either
    device), or made here."""
    if packed is None:
        return pack_q1_weights(w)
    return _checked_packed(x, packed, _q1_shape(x.shape[3] + c2, w.shape[3]), what)


def pack_q3_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO [2, 2, cin, cout] int8 -> Q3's B operand [4 cout, kp] int8, kp =
    cin rounded up to 32 (whole int8 k32 steps), zero-padded: row (2u + v)
    * cout + co holds the flipped tap w[1-u, 1-v, :, co], the weights of
    output pixel (2i + u, 2j + v)."""
    if w.dim() != 4 or tuple(w.shape[:2]) != (2, 2) or w.dtype != torch.int8:
        raise ValueError(f"pack_q3_weights: expected int8 [2,2,cin,cout], got "
                         f"{tuple(w.shape)} {w.dtype}")
    cin, cout = w.shape[2], w.shape[3]
    cols = torch.flip(w, dims=(0, 1)).permute(0, 1, 3, 2).reshape(4 * cout, cin)
    p = w.new_zeros(_q3_shape(cin, cout))
    p[:, :cin] = cols
    return p


def _q3_shape(cin: int, cout: int):
    return (4 * cout, -(-cin // 32) * 32)


def _launch_q1(x, x2, packed, scale, offset):
    """Q1's kernel on CUDA tensors: the requantized int8, or with ``scale``
    None the int32 sums."""
    n, h, wd, c1 = x.shape
    c2 = 0 if x2 is None else x2.shape[3]
    cout = packed.shape[2]
    acc = scale is None
    out = torch.empty((n, h, wd, cout), dtype=torch.int32 if acc else torch.int8,
                      device=x.device)
    with torch.cuda.device(x.device):
        code = _build.lib().annonet_q1_igemm(
            x.data_ptr(), 0 if x2 is None else x2.data_ptr(), packed.data_ptr(),
            0 if acc else scale.data_ptr(), 0 if acc else offset.data_ptr(),
            out.data_ptr(), n, h, wd, c1, c2, cout, int(acc),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(code, "annonet_q1_igemm")
    return out


def _second_input(x, x2, what) -> int:
    """The channels of the optional second input (0 without one)."""
    if x2 is None:
        return 0
    if x2.dim() != 4 or x2.shape[:3] != x.shape[:3] or x2.dtype != torch.int8:
        raise ValueError(f"{what}: x2 must be int8 and match x in N, H, W")
    if x2.device != x.device or not x2.is_contiguous():
        raise ValueError(f"{what}: x2 must be contiguous on x's device")
    return x2.shape[3]


def qconv3x3_requant(x, w, scale, offset, x2: Optional[torch.Tensor] = None,
                     packed: Optional[torch.Tensor] = None):
    """Q1: requant(conv3x3_same([x, x2])), int8 NHWC in and out; ``packed``
    is ``pack_q1_weights(w)``, made once by the caller, or None."""
    c2 = _second_input(x, x2, "qconv3x3_requant")
    _check(x, w, scale, offset, 3, 3, x.shape[3] + c2, (), "qconv3x3_requant")
    packed = _q1_packed(x, c2, w, packed, "qconv3x3_requant")
    if x.device.type == "cpu":
        return qconv3x3_requant_plain(x, w, scale, offset, x2)
    qconv3x3_requant.launches += 1
    return _launch_q1(x, x2, packed, scale, offset)


qconv3x3_requant.launches = 0


def qconv3x3_acc(x, w, x2: Optional[torch.Tensor] = None,
                 packed: Optional[torch.Tensor] = None):
    """Q1's accumulator mode: conv3x3_same([x, x2]) as exact int32 sums,
    int8 NHWC in, [N, H, W, C'] int32 out (``packed`` as for Q1)."""
    c2 = _second_input(x, x2, "qconv3x3_acc")
    _check(x, w, None, None, 3, 3, x.shape[3] + c2, (), "qconv3x3_acc")
    packed = _q1_packed(x, c2, w, packed, "qconv3x3_acc")
    if x.device.type == "cpu":
        return qconv3x3_acc_plain(x, w, x2)
    qconv3x3_acc.launches += 1
    return _launch_q1(x, x2, packed, None, None)


qconv3x3_acc.launches = 0


def _check_s2(x, w, scale, offset, what):
    _check(x, w, scale, offset, 3, 3, x.shape[3], (), what)
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"{what}: H and W must be even, got {tuple(x.shape)}")


def _launch_q2(x, packed, scale, offset):
    """Q2's kernel on CUDA tensors: the requantized int8, or with ``scale``
    None the int32 sums."""
    n, h, wd, cin = x.shape
    cout = packed.shape[2]
    acc = scale is None
    out = torch.empty((n, h // 2, wd // 2, cout),
                      dtype=torch.int32 if acc else torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        code = _build.lib().annonet_q2_igemm(
            x.data_ptr(), packed.data_ptr(), 0 if acc else scale.data_ptr(),
            0 if acc else offset.data_ptr(), out.data_ptr(), n, h, wd, cin, cout,
            int(acc), torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(code, "annonet_q2_igemm")
    return out


def qconv3x3_s2_requant(x, w, scale, offset, packed: Optional[torch.Tensor] = None):
    """Q2: requant(conv3x3 stride 2, padding (0, 1)): [N,H,W,C] ->
    [N,H/2,W/2,C'] int8 for even H and W; ``packed`` is
    ``pack_q1_weights(w)``, made once by the caller, or None."""
    _check_s2(x, w, scale, offset, "qconv3x3_s2_requant")
    packed = _q1_packed(x, 0, w, packed, "qconv3x3_s2_requant")
    if x.device.type == "cpu":
        return qconv3x3_s2_requant_plain(x, w, scale, offset)
    qconv3x3_s2_requant.launches += 1
    return _launch_q2(x, packed, scale, offset)


qconv3x3_s2_requant.launches = 0


def qconv3x3_s2_acc(x, w, packed: Optional[torch.Tensor] = None):
    """Q2's accumulator mode: conv3x3 stride 2, padding (0, 1), as exact
    int32 sums: int8 NHWC [N,H,W,C] in (even H and W), [N,H/2,W/2,C']
    int32 out (``packed`` as for Q2)."""
    _check_s2(x, w, None, None, "qconv3x3_s2_acc")
    packed = _q1_packed(x, 0, w, packed, "qconv3x3_s2_acc")
    if x.device.type == "cpu":
        return qconv3x3_s2_acc_plain(x, w)
    qconv3x3_s2_acc.launches += 1
    return _launch_q2(x, packed, None, None)


qconv3x3_s2_acc.launches = 0


def qup2x2_requant(x, w, scale, offset, packed: Optional[torch.Tensor] = None):
    """Q3: the int8 2x2 stride-2 transpose conv + requant: [N,H,W,C] ->
    [N,2H,2W,C'] int8; scale and offset are [2, C'], row v serving the
    output columns 2j+v; ``packed`` is ``pack_q3_weights(w)``, made once by
    the caller, or None."""
    _check(x, w, scale, offset, 2, 2, x.shape[3], (2,), "qup2x2_requant")
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    packed = (pack_q3_weights(w) if packed is None
              else _checked_packed(x, packed, _q3_shape(cin, cout), "qup2x2_requant"))
    if x.device.type == "cpu":
        return qup2x2_requant_plain(x, w, scale, offset)
    qup2x2_requant.launches += 1
    out = torch.empty((n, 2 * h, 2 * wd, cout), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        code = _build.lib().annonet_qup2x2_requant(
            x.data_ptr(), packed.data_ptr(), scale.data_ptr(), offset.data_ptr(),
            out.data_ptr(), n, h, wd, cin, cout,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(code, "annonet_qup2x2_requant")
    return out


qup2x2_requant.launches = 0
