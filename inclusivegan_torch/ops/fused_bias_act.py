"""fused_bias_act: ``y = act(x + b[axis]) * gain``, optionally clamped.

Port of ``inclusivegan_tpu/ops/fused_bias_act.py``: the same 9 activations
with the same default alpha and gain. The plain version is tensor code. For
``act="lrelu"`` on a CUDA tensor it launches the bias+lrelu kernel
(``cuda_kernels.bias_lrelu``, which replaces the TPU's
``pallas_kernels.bias_act_lrelu_pallas``); ``impl="plain"`` asks for the
tensor code on the card instead, for comparison.

Every lrelu call, on the CPU too, goes through the autograd Function
``_BiasLrelu``, whose forward takes the kernel or the plain version by
device and saves only its output ``y``. Its backward is ``_BiasLreluGrad``:
``dx = slope(y) * dy`` with ``slope = gain`` where ``y >= 0`` and
``gain * alpha`` elsewhere (the TPU kernel's custom_jvp tangent), through
the gradient kernel ``cuda_kernels.bias_lrelu_grad`` on a CUDA tensor; the
bias gradient is the sum of ``dx`` over every axis but ``axis``.
``_BiasLreluGrad`` is differentiable in turn, by the same kernel
(``slope(y) * ddx``); ``y`` gets no gradient, since the slope is piecewise
constant. So every order that R1 and the path-length regularizer need runs
through the two kernels.
"""

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import cuda_kernels
from .cuda_kernels import rounded


class _Act(NamedTuple):
    fn: Callable
    def_alpha: float
    def_gain: float


activation_funcs = {
    "linear":   _Act(lambda x, a: x,                                0.0, 1.0),
    "relu":     _Act(lambda x, a: torch.clamp_min(x, 0.0),          0.0, math.sqrt(2)),
    "lrelu":    _Act(lambda x, a: torch.where(x >= 0, x, x * a),    0.2, math.sqrt(2)),
    "tanh":     _Act(lambda x, a: torch.tanh(x),                    0.0, 1.0),
    "sigmoid":  _Act(lambda x, a: torch.sigmoid(x),                 0.0, 1.0),
    "elu":      _Act(lambda x, a: F.elu(x),                         0.0, 1.0),
    "selu":     _Act(lambda x, a: F.selu(x),                        0.0, 1.0),
    "softplus": _Act(lambda x, a: F.softplus(x),                    0.0, 1.0),
    "swish":    _Act(lambda x, a: x * torch.sigmoid(x),             0.0, math.sqrt(2)),
}


def _bias_lrelu_plain(x, b, axis, alpha, gain):
    shape = [1] * x.ndim
    shape[axis] = -1
    x = x + b.reshape(shape).to(x.dtype)
    return (torch.where(x >= 0, x, x * rounded(alpha, x.dtype))
            * rounded(gain, x.dtype))


def bias_lrelu_grad_plain(y, dy, alpha, gain):
    """dx = slope(y) * dy: the plain version of the gradient kernel. As in
    the TPU kernel's tangent, the slope is float32, rounded to ``dy``'s dtype,
    and multiplies in that dtype."""
    slope = torch.where(y >= 0, gain, gain * alpha).to(dy.dtype)
    return slope * dy


class _BiasLrelu(torch.autograd.Function):
    """y = lrelu(x + b[axis], alpha) * gain; ``b`` is in ``x``'s dtype."""

    @staticmethod
    def forward(ctx, x, b, axis, alpha, gain, use_kernel):
        if use_kernel:
            y = cuda_kernels.bias_lrelu(x.contiguous(), b, axis, alpha, gain)
        else:
            y = _bias_lrelu_plain(x, b, axis, alpha, gain)
        ctx.save_for_backward(y)
        ctx.args = (axis, alpha, gain, use_kernel)
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        axis, alpha, gain, use_kernel = ctx.args
        # y enters detached: the slope has no gradient, so no gradient edge
        # may lead back to this node (it would run on zeros)
        dx = _BiasLreluGrad.apply(dy, y.detach(), alpha, gain, use_kernel)
        db = None
        if ctx.needs_input_grad[1]:
            db = dx.sum(dim=[d for d in range(dx.ndim) if d != axis])
        return dx, db, None, None, None, None


class _BiasLreluGrad(torch.autograd.Function):
    """dx = slope(y) * dy; linear in ``dy``, so its own backward is itself."""

    @staticmethod
    def forward(ctx, dy, y, alpha, gain, use_kernel):
        ctx.save_for_backward(y)
        ctx.args = (alpha, gain, use_kernel)
        if use_kernel:
            return cuda_kernels.bias_lrelu_grad(y.contiguous(),
                                                dy.to(y.dtype).contiguous(),
                                                alpha, gain)
        return bias_lrelu_grad_plain(y, dy, alpha, gain)

    @staticmethod
    def backward(ctx, ddx):
        (y,) = ctx.saved_tensors
        alpha, gain, use_kernel = ctx.args
        return (_BiasLreluGrad.apply(ddx, y, alpha, gain, use_kernel),
                None, None, None, None)


def fused_bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None,
                   axis: int = 1, act: str = "linear",
                   alpha: Optional[float] = None, gain: Optional[float] = None,
                   clamp: Optional[float] = None,
                   impl: str = "cuda") -> torch.Tensor:
    """Add per-channel bias along ``axis``, apply activation, scale by gain,
    clip to ±clamp when given.

    ``impl="cuda"`` launches the kernel for lrelu on a CUDA tensor and uses
    the tensor code on a CPU tensor; ``impl="plain"`` always uses the tensor
    code. lrelu is differentiable to every order through ``_BiasLrelu``;
    the other activations through autograd of their tensor code."""
    spec = activation_funcs[act]
    alpha = spec.def_alpha if alpha is None else float(alpha)
    gain = spec.def_gain if gain is None else float(gain)
    if b is not None and (b.ndim != 1 or b.shape[0] != x.shape[axis]):
        raise ValueError(f"bias of shape {tuple(b.shape)} does not match "
                         f"axis {axis} of {tuple(x.shape)}")
    if clamp is not None and clamp < 0:
        raise ValueError(f"clamp must be >= 0, got {clamp}")
    if impl not in ("cuda", "plain"):
        raise ValueError(f"impl must be 'cuda' or 'plain', got {impl!r}")

    if act == "lrelu":
        if b is None:
            b = torch.zeros(x.shape[axis], dtype=x.dtype, device=x.device)
        x = _BiasLrelu.apply(x, b.to(x.dtype), axis % x.ndim, alpha, gain,
                             impl == "cuda" and x.is_cuda)
    else:
        if b is not None:
            shape = [1] * x.ndim
            shape[axis] = -1
            x = x + b.reshape(shape).to(x.dtype)
        x = spec.fn(x, rounded(alpha, x.dtype))
        if gain != 1.0:
            x = x * rounded(gain, x.dtype)
    if clamp is not None:
        x = torch.clamp(x, -clamp, clamp)
    return x
