"""The JAX package's random draws, re-derived from its keys, for the port.

The port cannot reproduce JAX's PRNG streams, so every draw of the port's
training code is an argument. These functions follow the ``random.split``
chains of ``inclusivegan_tpu/training/train_step.py``, ``training/loss.py`` and
``models/stylegan2.py`` (style mixing in ``map_latents``/``apply``, per-layer
noise in ``GSynthesis.apply``), on one device of the mesh (``device``:
the phase key folded with its index, or under ``invariant_rng`` the
global example index), and return numpy arrays in the layout of the
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


def train_step(G, key, mb, batched=True, pl_minibatch_shrink=2, device=0):
    """Every draw of the JAX ``make_train_step`` iteration with ``rng=key``
    on mesh device ``device`` (of a one-device mesh by default), whose
    minibatch is ``mb``, in the port's layout."""
    k1, k2, k3, k4 = random.split(key, 4)
    z = G.mapping.latent_size

    def dev(k):  # train_step._device_rng on this device
        return random.fold_in(k, device)

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


def ppl_noise(G, num_batches):
    """The batch-shared synthesis noise ([1, 1, h, w] per layer) of each
    minibatch of the JAX ``PPL._evaluate``: ``init_noise`` of the keys split
    in turn from ``random.key(0)``."""
    key, out = random.key(0), []
    for _ in range(num_batches):
        key, k = random.split(key)
        out.append(synthesis_noise(G, k, 1))  # init_noise splits as synthesis does
    return out


def sampler_noise(G, seed, num_batches, batch):
    """The synthesis noise of each minibatch of the JAX ``GsSampler.run``
    (``random.key(seed)`` split in turn, then ``GMain.apply``'s split)."""
    key, out = random.key(seed), []
    for _ in range(num_batches):
        key, k = random.split(key)
        _, krng = random.split(k)
        out.append(synthesis_noise(G, krng, batch))
    return out


def projector_noise(seed, num_steps, shape):
    """The noise latents of each step of the JAX ``Projector`` started with
    ``seed``: [num_steps, *shape]."""
    key, out = random.key(seed), []
    for _ in range(num_steps):
        key, k = random.split(key)
        out.append(_np(random.normal(k, shape)))
    return np.stack(out)


def _split_keys(key, n):
    return [k for k in random.split(key, n)]


def train_step_rounds(G, key, mb, rounds, batched=True, pl_minibatch_shrink=2):
    """Every draw of the JAX iteration with ``grad_accum_rounds=rounds`` on a
    one-device mesh: the flips and arb latents of the whole batch, and each
    round's loss draws from ``random.split(phase key, rounds)``, under
    ``"rounds"``."""
    k1, k2, k3, k4 = random.split(key, 4)
    z = G.mapping.latent_size

    def dev(k):
        return random.fold_in(k, 0)

    k_aug1, k_aug2, k_g, k_arb, _ = random.split(dev(k1), 5)
    g = {"flip1": _np(random.uniform(k_aug1, (mb, 1, 1, 1))).reshape(mb),
         "flip2": _np(random.uniform(k_aug2, (mb, 1, 1, 1))).reshape(mb),
         "arb_latents": _np(random.normal(k_arb, (mb, z))),
         "rounds": [g_main(G, k, mb // rounds, batched) for k in _split_keys(k_g, rounds)]}
    g_reg = {"rounds": [g_path_reg(G, k, mb // rounds, pl_minibatch_shrink)
                        for k in _split_keys(dev(k2), rounds)]}
    k_aug, k_d, k_arb, _ = random.split(dev(k3), 4)
    d = {"flip": _np(random.uniform(k_aug, (2 * mb, 1, 1, 1))).reshape(2 * mb),
         "arb_latents": _np(random.normal(k_arb, (2 * mb, z))),
         "rounds": [d_main(G, k, 2 * mb // rounds) for k in _split_keys(k_d, rounds)]}
    return {"g": g, "g_reg": g_reg, "d": d,
            "d_reg": {"flip": _np(random.uniform(dev(k4), (2 * mb, 1, 1, 1)))
                      .reshape(2 * mb)}}


# the salts of inclusivegan_tpu/training/loss.py and models/stylegan2.py
_EK_T, _EK_PL_Z, _EK_PL_NOISE = (1 << 20) | 1, (1 << 20) | 2, (1 << 20) | 3
_EK_FWD_BASE, _EK_MIX = 1 << 21, 1 << 20


def _fold(keys, salt):
    return [random.fold_in(k, salt) for k in keys]


def _global_keys(key, n, start=0):
    return [random.fold_in(key, i) for i in range(start, start + n)]


def _stack(keys, draw):
    return np.stack([_np(draw(k)) for k in keys])


def synthesis_noise_invariant(G, example_keys):
    """The per-example noise of ``GSynthesis.apply(example_keys=...)``."""
    syn = G.synthesis
    out = {}
    for layer_idx in range(syn.num_layers - 1):
        res = 2 ** ((layer_idx + 5) // 2)
        out[f"noise{layer_idx}"] = _stack(
            example_keys, lambda k: random.normal(random.fold_in(k, layer_idx),
                                                  (1, res, res)))
    return out


def mixing_invariant(G, key, fwd_keys):
    """(latents2 per example, shared cutoff) of ``map_latents``/``apply``
    with ``rng=key`` and ``example_keys=fwd_keys``."""
    _, _, k2, k3 = random.split(key, 4)
    num_layers = G.synthesis.num_layers
    latents2 = _stack(fwd_keys, lambda k: random.normal(
        random.fold_in(k, _EK_MIX), (G.mapping.latent_size,)))
    cutoff = np.where(_np(random.uniform(k2)) < G.style_mixing_prob,
                      _np(random.randint(k3, (), 1, num_layers)), num_layers)
    return latents2, np.int64(cutoff)


def train_step_invariant(G, key, mb, batched=True, pl_minibatch_shrink=2, device=0):
    """Every draw of the JAX iteration with ``invariant_rng=True`` on mesh
    device ``device``, whose minibatch is ``mb`` (example keys folded from
    the global index, which starts at ``device`` times the device's
    examples)."""
    k1, k2, k3, k4 = random.split(key, 4)
    z = G.mapping.latent_size
    k_aug1, k_aug2, k_g, k_arb, k_ex = random.split(k1, 5)
    at = device * mb
    eks = _global_keys(k_ex, mb, at)
    _, k_t, kg1, kg2, kg3, kg4, _ = random.split(k_g, 7)
    fwd = [_fold(eks, _EK_FWD_BASE + fid) for fid in range(4)]
    noise = [synthesis_noise_invariant(G, f) for f in fwd]
    if batched:
        noise = [{k: np.concatenate([n[k] for n in noise]) for k in noise[0]}]
    g = {"flip1": _stack(_global_keys(k_aug1, mb, at), random.uniform),
         "flip2": _stack(_global_keys(k_aug2, mb, at), random.uniform),
         "arb_latents": _stack(_global_keys(k_arb, mb, at),
                               lambda k: random.normal(k, (z,))),
         "t": _stack(_fold(eks, _EK_T), lambda k: random.uniform(k, (1,))),
         "mixing": [mixing_invariant(G, kk, f)
                    for kk, f in zip((kg1, kg2, kg3, kg4), fwd)],
         "noise": noise}
    pl_mb = max(mb // pl_minibatch_shrink, 1)
    rng, k_ex = random.split(k2)
    pl_eks = _global_keys(k_ex, pl_mb, device * pl_mb)
    _, _, kfwd, _ = random.split(rng, 4)
    res = G.synthesis.resolution
    g_reg = {"pl_latents": _stack(_fold(pl_eks, _EK_PL_Z),
                                  lambda k: random.normal(k, (z,))),
             "mixing": mixing_invariant(G, kfwd, _fold(pl_eks, _EK_FWD_BASE)),
             "pl_noise": _stack(_fold(pl_eks, _EK_PL_NOISE), lambda k: random.normal(
                 k, (G.synthesis.num_channels, res, res))),
             "noise": synthesis_noise_invariant(G, _fold(pl_eks, _EK_FWD_BASE + 1))}
    k_aug, k_d, k_arb, k_ex = random.split(k3, 4)
    n2 = 2 * mb
    d_fwd = _fold(_global_keys(k_ex, n2, device * n2), _EK_FWD_BASE)
    d = {"flip": _stack(_global_keys(k_aug, n2, device * n2), random.uniform),
         "arb_latents": _stack(_global_keys(k_arb, n2, device * n2),
                               lambda k: random.normal(k, (z,))),
         "mixing": mixing_invariant(G, k_d, d_fwd),
         "noise": synthesis_noise_invariant(G, d_fwd)}
    return {"g": g, "g_reg": g_reg, "d": d,
            "d_reg": {"flip": _stack(_global_keys(k4, n2, device * n2), random.uniform)}}
