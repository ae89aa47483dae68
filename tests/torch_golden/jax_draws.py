"""The JAX package's random draws, re-derived from its keys, for the port.

The port cannot reproduce JAX's PRNG streams, so every draw of the port's
training code is an argument. These functions follow the ``random.split``
chains of ``inclusivegan_tpu/training/train_step.py`` (one device: the
phase key folded with device index 0), ``training/loss.py`` and
``models/stylegan2.py`` (style mixing in ``map_latents``/``apply``, per-layer
noise in ``GSynthesis.apply``), and return numpy arrays in the layout of the
port's ``draws`` dicts (``inclusivegan_torch/training/train_step.py``).
``to_torch`` turns them into tensors; ``flatten_draws`` and
``unflatten_draws`` (the port's) store them in an .npz and read them back.

Imports JAX: used by the tests and the golden writers, never by the port.
"""

import types

import jax.numpy as jnp
import numpy as np
import torch
from jax import random

from inclusivegan_torch.training.train_step import flatten_draws, unflatten_draws  # noqa: F401


def _np(a):
    return np.asarray(a)


def synthesis_noise(G, key, batch):
    """The per-layer noise of ``GSynthesis.apply(rng=key)``, [batch, 1, h, w],
    drawn in the layer's activation dtype (the synthesis dtype; float32
    after a resnet G's first residual sum, which promotes) and returned as
    float32, which holds a bfloat16 draw exactly."""
    syn = G.synthesis
    out = {}
    for layer_idx in range(syn.num_layers - 1):
        key, k = random.split(key)
        res = 2 ** ((layer_idx + 5) // 2)
        dtype = syn.dtype if syn.architecture != "resnet" or layer_idx <= 2 else "float32"
        out[f"noise{layer_idx}"] = np.array(
            random.normal(k, (batch, 1, res, res), dtype), np.float32)
    return out


def bf16_noise_random():
    """``jax.random`` as the JAX stylegan2 module uses it, except that the
    synthesis noise images ([B, 1, h, w]) are drawn in bfloat16 and cast to
    the dtype asked for: set as ``inclusivegan_tpu.models.stylegan2.random``,
    a float32 G sees the noise values of a bf16 G, so that the two differ
    by their arithmetic alone."""
    def normal(key, shape=(), dtype=jnp.float32):
        if len(shape) == 4 and shape[1] == 1:
            return random.normal(key, shape, jnp.bfloat16).astype(dtype)
        return random.normal(key, shape, dtype)
    return types.SimpleNamespace(**{**vars(random), "normal": normal})


def mixing(G, key, batch):
    """(latents2, cutoff) of ``map_latents(rng=key)``, and the key that
    ``GMain.apply`` goes on with."""
    rest, k1, k2, k3 = random.split(key, 4)
    num_layers = G.synthesis.num_layers
    latents2 = random.normal(k1, (batch, G.mapping.latent_size), np.float32)
    cutoff = np.where(_np(random.uniform(k2)) < G.style_mixing_prob,
                      _np(random.randint(k3, (), 1, num_layers)), num_layers)
    return (_np(latents2), np.int64(cutoff)), rest


def apply_draws(G, key, batch):
    """Mixing and synthesis noise of a training-mode ``GMain.apply(rng=key)``."""
    mix, rest = mixing(G, key, batch)
    _, krng = random.split(rest)
    return mix, synthesis_noise(G, krng, batch)


def g_main(G, key, n, batched=True):
    """Draws of ``loss.g_main_loss(rng=key)``."""
    _, k_t, k1, k2, k3, k4, k_noise = random.split(key, 7)
    keys = (k1, k2, k3, k4)
    t = _np(random.uniform(k_t, (n, 1)))
    if batched:
        return {"t": t, "mixing": [mixing(G, k, n)[0] for k in keys],
                "noise": [synthesis_noise(G, k_noise, 4 * n)]}
    per = [apply_draws(G, k, n) for k in keys]
    return {"t": t, "mixing": [m for m, _ in per], "noise": [z for _, z in per]}


def g_path_reg(G, key, minibatch_size, pl_minibatch_shrink=2):
    """Draws of ``loss.g_path_reg(rng=key)``."""
    pl_mb = max(minibatch_size // pl_minibatch_shrink, 1)
    _, kz, kfwd, kn = random.split(key, 4)
    res = G.synthesis.resolution
    _, k_noise = random.split(kfwd)
    return {"pl_latents": _np(random.normal(kz, (pl_mb, G.mapping.latent_size))),
            "mixing": mixing(G, kfwd, pl_mb)[0],
            "pl_noise": _np(random.normal(kn, (pl_mb, G.synthesis.num_channels,
                                               res, res))),
            "noise": synthesis_noise(G, k_noise, pl_mb)}


def d_main(G, key, n):
    """Draws of ``loss.d_main_loss(rng=key)``."""
    mix, noise = apply_draws(G, key, n)
    return {"mixing": mix, "noise": noise}


def train_step(G, key, mb, batched=True, pl_minibatch_shrink=2):
    """Every draw of the JAX ``make_train_step`` iteration with ``rng=key``
    on a one-device mesh, in the port's layout."""
    k1, k2, k3, k4 = random.split(key, 4)
    z = G.mapping.latent_size

    def dev(k):  # train_step._device_rng on device 0
        return random.fold_in(k, 0)

    k_aug1, k_aug2, k_g, k_arb, _ = random.split(dev(k1), 5)
    g = {"flip1": _np(random.uniform(k_aug1, (mb, 1, 1, 1))).reshape(mb),
         "flip2": _np(random.uniform(k_aug2, (mb, 1, 1, 1))).reshape(mb),
         "arb_latents": _np(random.normal(k_arb, (mb, z))),
         **g_main(G, k_g, mb, batched)}
    k_aug, k_d, k_arb, _ = random.split(dev(k3), 4)
    d = {"flip": _np(random.uniform(k_aug, (2 * mb, 1, 1, 1))).reshape(2 * mb),
         "arb_latents": _np(random.normal(k_arb, (2 * mb, z))),
         **d_main(G, k_d, 2 * mb)}
    return {"g": g, "g_reg": g_path_reg(G, dev(k2), mb, pl_minibatch_shrink),
            "d": d,
            "d_reg": {"flip": _np(random.uniform(dev(k4), (2 * mb, 1, 1, 1)))
                      .reshape(2 * mb)}}


def to_torch(tree, device="cpu"):
    """numpy leaves -> tensors (cutoffs become 0-d int64), structure kept."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    return torch.as_tensor(np.asarray(tree), device=device)
