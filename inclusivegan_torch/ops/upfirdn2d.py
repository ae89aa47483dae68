"""upfirdn2d: zero-insert upsample, pad or crop, FIR filter, downsample.

Port of ``inclusivegan_tpu/ops/upfirdn2d.py`` with the same pad and gain
conventions, on NCHW tensors. The plain version is that module's ``ref``
shift-and-sum form. On a CUDA tensor every ``upfirdn2d`` call, the FIR inside
``upsample_conv2d`` and ``conv_downsample2d`` included, launches the upfirdn2d
kernel (``cuda_kernels.upfirdn2d``, which replaces the TPU's
``pallas_kernels.upfirdn2d_pallas``); ``impl="plain"`` asks for the tensor
code on the card instead, for comparison. The transposed and strided
convolutions around the FIR are ``torch.nn.functional`` calls, as the JAX
package leaves them to XLA.

Every call, on the CPU too, goes through the autograd Function
``_UpFirDn2d``. The op is linear in ``x``; its backward is the same
Function at the transposed configuration (the TPU kernel's
``linear_call`` pair, ``pallas_kernels.py::_upfirdn_core``): flipped taps,
``up`` and ``down`` swapped, the pad ``gpad`` that gives back the input's
extent, and the same gain. Since that backward is a Function call again,
every order of differentiation is exact and, on a CUDA tensor, runs through
the kernel; its launches count as ``upfirdn2d_transposed``.
"""

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_kernels

Pad = Union[int, Tuple[int, int], Tuple[int, int, int, int]]


def setup_filter(f, normalize: bool = True, flip: bool = False,
                 gain: float = 1.0) -> np.ndarray:
    """Prepare FIR taps as a float32 numpy array: 1-D taps are
    outer-producted to 2-D, normalized to unit sum, optionally flipped and
    scaled. Numpy on purpose: the kernel takes the taps as host floats."""
    if f is None:
        f = 1
    f = np.asarray(f, dtype=np.float32)
    if f.ndim == 0:
        f = f[np.newaxis]
    if f.ndim not in (1, 2):
        raise ValueError(f"filter must be 1-D or 2-D, got {f.ndim}-D")
    if f.ndim == 1:
        f = np.outer(f, f)
    if normalize:
        f = f / np.sum(f)
    if flip:
        f = f[::-1, ::-1]
    return f * gain


def _parse_padding(pad: Pad) -> Tuple[int, int, int, int]:
    if isinstance(pad, int):
        return pad, pad, pad, pad
    pad = tuple(pad)
    if len(pad) == 2:
        px, py = pad
        return px, px, py, py
    if len(pad) != 4:
        raise ValueError(f"pad must have 1, 2 or 4 entries, got {pad}")
    return pad  # (padx0, padx1, pady0, pady1)


def upfirdn2d(x: torch.Tensor, f, up: int = 1, down: int = 1, pad: Pad = 0,
              gain: float = 1.0, impl: str = "cuda") -> torch.Tensor:
    """y = downsample(FIR(pad(zero_insert_upsample(x)))) on NCHW ``x``.

    ``f``: 2-D taps, or 1-D separable taps (outer-producted), prepared by
    ``setup_filter``. ``pad`` may be negative (crop). Output size per axis:
    ``(in*up + pad0 + pad1 - k) // down + 1``. ``impl="cuda"`` launches the
    kernel on a CUDA tensor and uses the plain version on a CPU tensor;
    ``impl="plain"`` always uses the plain version."""
    f = np.asarray(f, dtype=np.float32)
    if f.ndim == 1:
        f = np.outer(f, f)
    if f.ndim != 2:
        raise ValueError(f"filter must be 1-D or 2-D, got {f.ndim}-D")
    if impl not in ("cuda", "plain"):
        raise ValueError(f"impl must be 'cuda' or 'plain', got {impl!r}")
    pad = _parse_padding(pad)
    return _UpFirDn2d.apply(x, f, up, down, pad, float(gain),
                            impl == "cuda" and x.is_cuda, False)


def transposed_config(f, up, down, pad, in_hw, out_hw):
    """The upfirdn2d configuration of the gradient: (taps, up, down, pad),
    with pad ``gpad`` as in ``pallas_kernels.py::_upfirdn_core``."""
    kh, kw = f.shape
    padx0, _, pady0, _ = pad
    (in_h, in_w), (out_h, out_w) = in_hw, out_hw
    gpad = (kw - padx0 - 1, in_w * up - out_w * down + padx0 - up + 1,
            kh - pady0 - 1, in_h * up - out_h * down + pady0 - up + 1)
    return np.ascontiguousarray(f[::-1, ::-1]), down, up, gpad


class _UpFirDn2d(torch.autograd.Function):
    """``transposed`` marks a gradient's configuration, for the launch
    counts only."""

    @staticmethod
    def forward(ctx, x, f, up, down, pad, gain, use_kernel, transposed):
        ctx.args = (f, up, down, pad, gain, use_kernel, transposed,
                    tuple(x.shape[2:]))
        if use_kernel:
            return cuda_kernels.upfirdn2d(
                x.contiguous(), f, up, down, pad, gain,
                counter="upfirdn2d_transposed" if transposed else "upfirdn2d")
        return _upfirdn2d_plain(x, f, up, down, pad, gain)

    @staticmethod
    def backward(ctx, dy):
        f, up, down, pad, gain, use_kernel, transposed, in_hw = ctx.args
        ft, upt, downt, gpad = transposed_config(f, up, down, pad, in_hw,
                                                 tuple(dy.shape[2:]))
        dx = _UpFirDn2d.apply(dy, ft, upt, downt, gpad, gain, use_kernel,
                              not transposed)
        return dx, None, None, None, None, None, None, None


def _upfirdn2d_plain(x, f, up, down, pad, gain):
    """Explicit zero-insert, pad or crop, shift-and-sum FIR with flipped
    taps, strided downsample (the JAX package's ``impl='ref'``). The sum is
    float32 whatever the storage type, row-major over the flipped taps and
    rounded once to the storage type, as the TPU kernel's ``_fir_kernel``
    and the CUDA kernel sum."""
    padx0, padx1, pady0, pady1 = pad
    n, c, h, w = x.shape
    kh, kw = f.shape
    if up > 1:  # zero-insert upsample to [H*up, W*up], trailing zeros included
        x = x.reshape(n, c, h, 1, w, 1)
        x = F.pad(x, [0, up - 1, 0, 0, 0, up - 1])
        x = x.reshape(n, c, h * up, w * up)
    x = F.pad(x, [max(padx0, 0), max(padx1, 0), max(pady0, 0), max(pady1, 0)])
    x = x[:, :,
          max(-pady0, 0): x.shape[2] - max(-pady1, 0),
          max(-padx0, 0): x.shape[3] - max(-padx1, 0)]
    k = f * gain
    oh, ow = x.shape[2] - kh + 1, x.shape[3] - kw + 1
    acc = torch.promote_types(x.dtype, torch.float32)
    y = torch.zeros((n, c, oh, ow), dtype=acc, device=x.device)
    for i in range(kh):
        for j in range(kw):
            y = y + x[:, :, i:i + oh, j:j + ow].to(acc) * float(k[kh - 1 - i, kw - 1 - j])
    return y[:, :, ::down, ::down].to(x.dtype)


def filter2d(x, f, gain: float = 1.0, impl: str = "cuda") -> torch.Tensor:
    """Same-size FIR filtering."""
    f = setup_filter(f)
    kh, kw = f.shape
    pw, ph = kw - 1, kh - 1
    return upfirdn2d(x, f, pad=((pw + 1) // 2, pw // 2, (ph + 1) // 2, ph // 2),
                     gain=gain, impl=impl)


def upsample2d(x, f=None, factor: int = 2, gain: float = 1.0,
               impl: str = "cuda") -> torch.Tensor:
    """Upsample by ``factor`` with FIR smoothing; the filter gain is scaled
    by factor**2 to keep the mean intensity through the zero-insert."""
    if factor < 1:
        raise ValueError(f"factor must be >= 1, got {factor}")
    f = setup_filter(f if f is not None else [1] * factor)
    p = f.shape[0] - factor
    return upfirdn2d(x, f, up=factor,
                     pad=((p + 1) // 2 + factor - 1, p // 2,
                          (p + 1) // 2 + factor - 1, p // 2),
                     gain=gain * factor * factor, impl=impl)


def downsample2d(x, f=None, factor: int = 2, gain: float = 1.0,
                 impl: str = "cuda") -> torch.Tensor:
    """FIR-smoothed downsample by ``factor``."""
    if factor < 1:
        raise ValueError(f"factor must be >= 1, got {factor}")
    f = setup_filter(f if f is not None else [1] * factor)
    p = f.shape[0] - factor
    return upfirdn2d(x, f, down=factor,
                     pad=((p + 1) // 2, p // 2, (p + 1) // 2, p // 2),
                     gain=gain, impl=impl)


def upsample_conv2d(x, w, f=None, factor: int = 2, gain: float = 1.0,
                    impl: str = "cuda") -> torch.Tensor:
    """Transposed-conv upsample followed by the FIR. ``w``: [O, I, kh, kw]."""
    if factor < 1:
        raise ValueError(f"factor must be >= 1, got {factor}")
    kh = w.shape[2]
    f = setup_filter(f if f is not None else [1] * factor,
                     gain=gain * (factor ** 2))
    # [I, O, kh, kw]: conv_transpose2d flips the taps itself
    y = F.conv_transpose2d(x, w.transpose(0, 1).to(x.dtype), stride=factor)
    p = f.shape[0] - factor - (kh - 1)
    return upfirdn2d(y, f, pad=((p + 1) // 2 + factor - 1, p // 2 + 1,
                                (p + 1) // 2 + factor - 1, p // 2 + 1),
                     impl=impl)


def conv_downsample2d(x, w, f=None, factor: int = 2, gain: float = 1.0,
                      impl: str = "cuda") -> torch.Tensor:
    """FIR followed by a strided conv downsample. ``w``: [O, I, kh, kw]."""
    if factor < 1:
        raise ValueError(f"factor must be >= 1, got {factor}")
    kh = w.shape[2]
    f = setup_filter(f if f is not None else [1] * factor, gain=gain)
    p = f.shape[0] - factor + (kh - 1)
    x = upfirdn2d(x, f, pad=((p + 1) // 2, p // 2, (p + 1) // 2, p // 2),
                  impl=impl)
    return F.conv2d(x, w.to(x.dtype), stride=factor)
