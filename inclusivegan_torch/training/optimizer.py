"""Adam with moments shared across training phases and a whole-update skip
on non-finite gradients, ported from ``inclusivegan_tpu/training/
optimizer.py``.

Parameters, gradients and moments are dicts of tensors keyed by parameter
name. The moments are float32 whatever the parameters' dtype; a step
computes in float32 and rounds to the parameter's dtype. When any gradient
is not finite, parameters, moments and count are all kept: the choice is a
``torch.where`` on a device boolean, so the host never waits for the card.
Hyperparameters are per call, because the main and lazy-regularization
phases of one network share the moments with different (lr, beta1, beta2).
"""

from typing import Dict, NamedTuple, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    count: torch.Tensor  # int32 scalar
    m: Tensors           # first moments
    v: Tensors           # second moments


def init_adam(params: Tensors) -> AdamState:
    device = next(iter(params.values())).device
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    return AdamState(torch.zeros((), dtype=torch.int32, device=device), zeros,
                     {k: z.clone() for k, z in zeros.items()})


def grads_finite(grads: Tensors) -> torch.Tensor:
    """A device boolean: every gradient is finite."""
    return torch.stack([torch.isfinite(g).all() for g in grads.values()]).all()


def adam_apply(params: Tensors, grads: Tensors, state: AdamState, *,
               learning_rate: float, beta1: float = 0.0, beta2: float = 0.99,
               epsilon: float = 1e-8) -> Tuple[Tensors, AdamState, torch.Tensor]:
    """One Adam step; returns (new_params, new_state, update_ok). Inputs are
    not modified."""
    ok = grads_finite(grads)
    count = state.count + 1
    c = count.float()
    bc1 = 1.0 - torch.pow(beta1, c)
    bc2 = 1.0 - torch.pow(beta2, c)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float()
        m = beta1 * state.m[k] + (1.0 - beta1) * g
        v = beta2 * state.v[k] + (1.0 - beta2) * g.square()
        step = learning_rate * (m / bc1) / (torch.sqrt(v / bc2) + epsilon)
        p_new = (p.detach().float() - step).to(p.dtype)
        new_p[k] = torch.where(ok, p_new, p.detach())
        new_m[k] = torch.where(ok, m, state.m[k])
        new_v[k] = torch.where(ok, v, state.v[k])
    new_state = AdamState(torch.where(ok, count, state.count), new_m, new_v)
    return new_p, new_state, ok


def lazy_reg_hparams(learning_rate, beta1, beta2, reg_interval: int):
    """Fold the lazy-regularization minibatch ratio interval/(interval+1)
    into (lr, beta1, beta2), for the main and the reg phase alike."""
    mb_ratio = reg_interval / (reg_interval + 1.0)
    return learning_rate * mb_ratio, beta1 ** mb_ratio, beta2 ** mb_ratio
