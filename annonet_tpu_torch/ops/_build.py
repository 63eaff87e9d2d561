"""Build and load the hand-written CUDA kernels (``annonet_tpu_torch/csrc``).

On first use, ``nvcc`` compiles every ``csrc/*.cu`` file for Hopper
(``sm_90a``), one compiler process per source, all started together, and
links the objects into one shared library with a plain C interface, which
is loaded with ctypes. The library's name carries a hash of the sources (and
of the compiler flags), so an edit rebuilds it; the build directory
``annonet_tpu_torch/_build/`` is listed in ``.gitignore``.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` turns a nonzero code into an exception.
Nothing here runs at import time: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    # x, x2, w, bias, out, n, h, w, c1, c2, cout, stride, bf16, stream
    "annonet_conv3x3_bias_relu": [
        _P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _I, _I, _I, _I, _P,
    ],
    # x, w, bias, out, n, h, w, cin, cout, bf16, stream
    "annonet_up2x2_bias_relu": [
        _P, _P, _P, _P, _I64, _I64, _I64, _I, _I, _I, _P,
    ],
    # x, w, bias, out, n, h, w, cin, cout, bf16, stream
    "annonet_up2x2_bias": [
        _P, _P, _P, _P, _I64, _I64, _I64, _I, _I, _I, _P,
    ],
    # x, s_in, w, scale, offset, out, n, h, w, cin, cout, bf16, stream
    "annonet_up2x2_requant": [
        _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _I, _I, _P,
    ],
    # x, x2, packed w, scale, offset, out, n, h, w, c1, c2, cout, acc, stream
    "annonet_q1_igemm": [
        _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _I, _I, _I, _P,
    ],
    # x, packed w, scale, offset, out, n, h, w, cin, cout, acc, stream
    "annonet_q2_igemm": [
        _P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _I, _I, _P,
    ],
    # x, packed w, scale, offset, out, n, h, w, cin, cout, stream
    "annonet_qup2x2_requant": [
        _P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _I, _P,
    ],
    # x, wc, wl, wr, bias, table, out, n, h, wb, k1, nc, cout, bf16, stream
    "annonet_conv3x3_gemm": [
        _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _I, _I, _I, _P,
    ],
    # logits, tile_yx, ramp, inv_wsum, gains, det, wy, wx, labels, seeds,
    # n_tiles, m, th, tw, hp, wp, k, labels_int32, with_detection,
    # reference_blend, bf16, stream
    "annonet_blend_argmax": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I64, _I64, _I64, _I64, _I64, _I64, _I, _I, _I, _I, _I, _P,
    ],
    # h, y, gamma, beta, buf, partial, per_pass, max_blocks, blocks,
    # cluster, tickets, rows, c, vec, bf16, device, stream
    "annonet_bn_relu_forward": [
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I64, _I, _I, _I, _I, _P,
    ],
    # h, dy, ld_dy, dh, gamma, buf, dgamma, dbeta, partial, per_pass,
    # max_blocks, blocks, cluster, tickets, rows, c, vec, bf16, device, stream
    "annonet_bn_relu_backward": [
        _P, _P, _I64, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I64, _I, _I, _I, _I, _P,
    ],
    # backward, c, per_pass, cluster, vec, bf16, device
    "annonet_bn_relu_clusters": [_I, _I, _I, _I, _I, _I, _I],
    # labels, out, ticket, counts, table, n, hw, k, class exponent, image
    # weight, vec, device, stream
    "annonet_label_weights": [
        _P, _P, _P, _P, _P, _I64, _I64, _I, _D, _D, _I, _I, _P,
    ],
}


def find_nvcc() -> str:
    for candidate in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if candidate and os.path.isfile(candidate):
            return candidate
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin): the CUDA kernels "
        "of annonet_tpu_torch need the CUDA toolkit"
    )


def _sources():
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return sources, headers


def library_path() -> str:
    sources, headers = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + headers:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    return os.path.join(
        BUILD_DIR, f"libannonet_kernels_{digest.hexdigest()[:16]}.so"
    )


def _run(cmds):
    """Run the compiler commands in parallel; raise with the output of the
    first that fails."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for cmd in cmds
    ]
    failed = None
    for cmd, proc in zip(cmds, procs):
        try:
            out, _ = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, out)
    if failed is not None:
        cmd, code, out = failed
        raise RuntimeError(f"nvcc failed ({code}): {' '.join(cmd)}\n{out}")


def build() -> str:
    """Compile the kernels unless a library of these sources exists;
    returns its path. Raises with the compiler's output on failure."""
    path = library_path()
    if os.path.isfile(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    sources, _ = _sources()
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objects = [
            os.path.join(tmpdir, os.path.basename(src) + ".o") for src in sources
        ]
        _run([
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            for src, obj in zip(sources, objects)
        ])
        tmp = os.path.join(tmpdir, "lib.so")
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objects]])
        os.replace(tmp, path)
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            loaded = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = loaded
    return _lib


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")
