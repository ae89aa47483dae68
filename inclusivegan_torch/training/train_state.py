"""The training state and the Gs EMA, ported from
``inclusivegan_tpu/training/train_state.py``.

The state holds the three networks as modules, whose parameters and buffers
are the JAX state's ``g_params``, ``d_params`` and ``gs_params`` (the same
names, joined with "."), beside the two Adam states, ``pl_mean`` and the
step. The train step updates the modules in place, which keeps one copy of
the weights on the card; ``copy.deepcopy`` of a state gives an independent
one. The functions below work on name -> tensor dicts, as the JAX ones work
on trees; ``params_of`` and ``assign`` move between dicts and modules.
"""

from typing import Dict, Mapping, NamedTuple

import torch
from torch import nn

from .optimizer import AdamState, init_adam

Tensors = Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    G: nn.Module            # GMain: trainables, noise, dlatent_avg
    D: nn.Module            # Discriminator
    Gs: nn.Module           # EMA clone of G
    g_opt: AdamState        # over G's trainables only
    d_opt: AdamState
    pl_mean: torch.Tensor   # float32 scalar


G_NON_TRAINABLE = ("noise", "dlatent_avg")


def params_of(module: nn.Module) -> Tensors:
    """The module's parameters and buffers by name, the live tensors."""
    return dict(module.state_dict(keep_vars=True))


def assign(module: nn.Module, tensors: Mapping[str, torch.Tensor]) -> None:
    """Replace the module's named parameters and buffers by ``tensors``,
    dtype included (the JAX state's leaves change dtype the same way)."""
    live = params_of(module)
    with torch.no_grad():
        for k, v in tensors.items():
            if isinstance(live[k], nn.Parameter):
                live[k].data = v.detach()
            else:
                *path, name = k.split(".")
                setattr(module.get_submodule(".".join(path)), name, v.detach())


def g_trainables(g_params: Mapping[str, torch.Tensor]) -> Tensors:
    return {k: v for k, v in g_params.items()
            if k.split(".")[0] not in G_NON_TRAINABLE}


def merge_g(trainables: Mapping[str, torch.Tensor],
            g_params: Mapping[str, torch.Tensor]) -> Tensors:
    out = dict(g_params)
    out.update(trainables)
    return out


def create_train_state(G: nn.Module, D: nn.Module, Gs: nn.Module) -> TrainState:
    """Fresh Adam moments, ``pl_mean`` 0 and step 0 around the networks."""
    device = G.dlatent_avg.device
    return TrainState(
        step=torch.zeros((), dtype=torch.int32, device=device), G=G, D=D, Gs=Gs,
        g_opt=init_adam(g_trainables(params_of(G))),
        d_opt=init_adam(params_of(D)),
        pl_mean=torch.zeros((), dtype=torch.float32, device=device))


def update_gs(g_params: Mapping[str, torch.Tensor],
              gs_params: Mapping[str, torch.Tensor], beta) -> Tensors:
    """Gs <- G + (Gs - G) * beta on trainables, non-trainables copied from
    G. The result is float32, as in JAX, where the float32 beta promotes
    float16 weights; Gs - G is taken in the weights' own dtypes first."""
    new = {}
    for k, a in g_params.items():
        a = a.detach()
        if k.split(".")[0] in G_NON_TRAINABLE:
            new[k] = a.clone()
        else:
            new[k] = a.float() + (gs_params[k].detach() - a).float() * beta
    return new
