"""ctypes bindings of the port's CUDA kernels, and their wrappers.

The library is built from ``csrc/`` by ``build.py`` on first use, never at
import. Each wrapper takes CUDA tensors only: it checks device, dtype,
contiguity and shape, allocates its output with ``torch.empty``, launches on
the current stream without synchronising, raises if the launch returned a
CUDA error, and adds one to its entry of ``launches``. The dispatch between a
kernel and its plain version happens in ``fused_bias_act.py`` and
``upfirdn2d.py``, by the device of the tensor, and the autograd Functions there call these
wrappers from their backward passes too: ``bias_lrelu_grad`` is the
gradient kernel of bias+lrelu, and upfirdn2d's gradient is the same
upfirdn2d kernel at the transposed configuration, counted apart as
``upfirdn2d_transposed``.
"""

import ctypes
import math

import numpy as np
import torch

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_MAX_TAPS = 8  # kMaxTaps in csrc/upfirdn2d.cu
_lib = None

# Kernel launches per wrapper since the last reset_launches().
launches = {"bias_lrelu": 0, "bias_lrelu_grad": 0, "upfirdn2d": 0,
            "upfirdn2d_transposed": 0}


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library, once."""
    global _lib
    if _lib is None:
        from .build import build
        lib = ctypes.CDLL(str(build()))
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.bias_lrelu_launch.argtypes = [p, p, p, ll, i, ll, f, f, i, p]
        lib.bias_lrelu_launch.restype = i
        lib.bias_lrelu_grad_launch.argtypes = [p, p, p, ll, f, f, i, p]
        lib.bias_lrelu_grad_launch.restype = i
        lib.upfirdn2d_launch.argtypes = [p, p, ctypes.POINTER(f), i, i, ll,
                                         i, i, i, i, i, i, i, i, i, p]
        lib.upfirdn2d_launch.restype = i
        _lib = lib
    return _lib


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check_tensor(name: str, x: torch.Tensor) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name}: expects a CUDA tensor, got one on {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        f"(float32, float16, bfloat16)")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expects a contiguous tensor")


def _raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def bias_lrelu(x: torch.Tensor, b: torch.Tensor, axis: int = 1,
               alpha: float = 0.2, gain: float = math.sqrt(2)) -> torch.Tensor:
    """y = lrelu(x + b, alpha) * gain with b along ``axis`` of a CUDA ``x``."""
    _check_tensor("bias_lrelu", x)
    axis = axis % x.ndim
    c = x.shape[axis]
    if b.shape != (c,) or b.device != x.device:
        raise ValueError(f"bias_lrelu: bias must be [{c}] on {x.device}, "
                         f"got {tuple(b.shape)} on {b.device}")
    b = b.to(x.dtype).contiguous()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = load_library().bias_lrelu_launch(
            x.data_ptr(), b.data_ptr(), y.data_ptr(), x.numel(), c,
            math.prod(x.shape[axis + 1:]), alpha, gain, _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    _raise_on_error("bias_lrelu", err)
    launches["bias_lrelu"] += 1
    return y


def bias_lrelu_grad(y: torch.Tensor, dy: torch.Tensor, alpha: float = 0.2,
                    gain: float = math.sqrt(2)) -> torch.Tensor:
    """dx = dy * (gain where y >= 0, else gain * alpha), elementwise, for
    CUDA tensors ``y`` (the forward's output) and ``dy`` of one shape and
    dtype."""
    _check_tensor("bias_lrelu_grad", y)
    _check_tensor("bias_lrelu_grad", dy)
    if dy.shape != y.shape or dy.dtype != y.dtype or dy.device != y.device:
        raise ValueError(f"bias_lrelu_grad: dy {tuple(dy.shape)} {dy.dtype} on "
                         f"{dy.device} does not match y {tuple(y.shape)} "
                         f"{y.dtype} on {y.device}")
    dx = torch.empty_like(y)
    with torch.cuda.device(y.device):
        err = load_library().bias_lrelu_grad_launch(
            y.data_ptr(), dy.data_ptr(), dx.data_ptr(), y.numel(), alpha, gain,
            _DTYPE_CODES[y.dtype], torch.cuda.current_stream().cuda_stream)
    _raise_on_error("bias_lrelu_grad", err)
    launches["bias_lrelu_grad"] += 1
    return dx


def upfirdn2d(x: torch.Tensor, f: np.ndarray, up: int, down: int,
              pad, gain: float, counter: str = "upfirdn2d") -> torch.Tensor:
    """upfirdn2d of a CUDA NCHW ``x`` with 2-D taps ``f`` (as in
    ``ops/upfirdn2d.py``); pad is (padx0, padx1, pady0, pady1). The launch
    counts under ``counter``: ``"upfirdn2d"`` or, for a gradient's
    transposed configuration, ``"upfirdn2d_transposed"``."""
    if counter not in ("upfirdn2d", "upfirdn2d_transposed"):
        raise ValueError(f"upfirdn2d: unknown counter {counter!r}")
    _check_tensor("upfirdn2d", x)
    if x.ndim != 4:
        raise ValueError(f"upfirdn2d: expects NCHW, got shape {tuple(x.shape)}")
    f = np.asarray(f, np.float32)
    kh, kw = f.shape
    if kh > _MAX_TAPS or kw > _MAX_TAPS:
        raise ValueError(f"upfirdn2d: filter {kh}x{kw} exceeds "
                         f"{_MAX_TAPS}x{_MAX_TAPS}")
    padx0, padx1, pady0, pady1 = pad
    n, c, h, w = x.shape
    oh = (h * up + pady0 + pady1 - kh) // down + 1
    ow = (w * up + padx0 + padx1 - kw) // down + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"upfirdn2d: empty output {oh}x{ow}")
    # flipped for convolution and scaled by gain, as the TPU kernel bakes them
    taps = np.ascontiguousarray((f * gain)[::-1, ::-1], np.float32)
    y = torch.empty((n, c, oh, ow), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = load_library().upfirdn2d_launch(
            x.data_ptr(), y.data_ptr(),
            taps.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), kh, kw,
            n * c, h, w, oh, ow, up, down, padx0, pady0, _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    _raise_on_error("upfirdn2d", err)
    launches[counter] += 1
    return y

