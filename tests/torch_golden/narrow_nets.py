"""Narrow networks given to both packages, for the port's training tests.

G and D at resolution 16 with at most 16 feature maps, two mapping layers of
width 16 and minibatch-stddev groups of 2; the leaves that JAX's ``init``
sets to zero (biases, noise strengths, dlatent_avg) get random values, so
that each shows. ``to_port`` builds the port's modules from the same numpy
trees; ``port_grads`` and ``flat`` put both packages' gradients side by
side by dotted name, in the port's layout (OIHW conv weights).

Imports JAX: used by the tests, never by the port.
"""

import dataclasses

import jax
import numpy as np
import torch

from inclusivegan_tpu.models.stylegan2 import Discriminator, GMain
from inclusivegan_torch.snapshot import discriminator_from_params, gmain_from_params

RES = 16
ZDIM = 16


def _randomize_zeros(tree, seed):
    rnd = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(0.3 * rnd.randn(*a.shape), np.float32)
        if not np.any(a) else np.asarray(a, np.float32), tree)


def narrow_nets(d_architecture="resnet", mbstd_group_size=2, label_size=0):
    """(G, D, g_params, d_params, g_config, d_config): the JAX networks,
    numpy parameter trees and snapshot-style configs."""
    G = GMain.create(resolution=RES, latent_size=ZDIM, dlatent_size=ZDIM,
                     mapping_layers=2, mapping_fmaps=ZDIM, fmap_base=128,
                     fmap_max=16, label_size=label_size)
    D = Discriminator(resolution=RES, fmap_base=128, fmap_max=16,
                      architecture=d_architecture,
                      mbstd_group_size=mbstd_group_size, label_size=label_size)
    g_params = _randomize_zeros(G.init(jax.random.key(0)), 1)
    d_params = _randomize_zeros(D.init(jax.random.key(2)), 3)
    g_config = dataclasses.asdict(G)
    for sub in ("mapping", "synthesis"):
        g_config[sub]["dtype"] = "float32"
    d_config = dataclasses.asdict(D)
    d_config["dtype"] = "float32"
    return G, D, g_params, d_params, g_config, d_config


def to_port(g_config, g_params, d_config, d_params, device="cpu"):
    return (gmain_from_params(g_config, g_params, device),
            discriminator_from_params(d_config, d_params, device))


def flat(tree):
    """A JAX tree as {dotted name: numpy array in the port's layout}."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = np.asarray(leaf)
        name = ".".join(k.key for k in path)
        if name.endswith("weight") and a.ndim == 4:
            a = np.transpose(a, (3, 2, 0, 1))
        out[name] = a
    return out


def port_grads(loss, module, skip=("noise", "dlatent_avg")):
    """{name: grad} of ``loss`` over the module's parameters."""
    named = [(k, p) for k, p in module.named_parameters()
             if k.split(".")[0] not in skip]
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True,
                                materialize_grads=True)
    return {k: g.detach().numpy() for (k, _), g in zip(named, grads)}
