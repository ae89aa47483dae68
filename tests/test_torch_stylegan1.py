"""The port's StyleGAN1 (``inclusivegan_torch/models/stylegan.py``) against
the JAX package's (``inclusivegan_tpu/models/stylegan.py``) on the CPU.

The same numpy parameters (JAX's ``init``, with the zero leaves given random
values so that each shows) and inputs go to both packages; the JAX draws
(style-mixing latents and cutoff, per-layer noise) are re-derived from
their keys and handed to the port. Tolerances: the primitives at relative
error 1e-6; G's images, D's scores and D's gradients in float32 at relative
L2 1e-5; the port computing in bfloat16 against the JAX package's float32
(which has no bf16 StyleGAN1): D at 2e-2, G at 4e-2, with torch's bf16
convolutions computed as float32 sums rounded to bf16, as cuDNN computes
them (torch's CPU bf16 convolution sums in bf16; ``tests/test_torch_bf16.py``).
G's bound is wider because the narrow G amplifies rounding about fourfold:
its mapping alone in bf16 moves the images 0.6-1.2e-2 from float32, and
one bf16 rounding of each layer's output 0.4e-2; the whole G in bf16 lies
2.4-3.6e-2 from float32 on four seeds, at fresh and at randomized
parameters.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

import inclusivegan_tpu.models.stylegan as js
import inclusivegan_torch.models.stylegan as ts
from inclusivegan_torch.models.stylegan2 import set_compute_dtype
from inclusivegan_torch.snapshot import dbasic_from_params, gstyle_from_params
from torch_golden.narrow_nets import flat

RES = 16
Z = 16
MB = 4
F32_REL_L2 = 1e-5
BF16_REL_L2 = 2e-2
G_BF16_REL_L2 = 4e-2
PRIM_RTOL = 1e-6


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _randomize_zeros(tree, seed):
    rnd = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(0.3 * rnd.randn(*a.shape), np.float32)
        if not np.any(a) else np.asarray(a, np.float32), tree)


class _Jitted:
    """A JAX network whose ``apply`` is jitted (one XLA program per static
    configuration, ``lod`` traced): faster here than op-by-op dispatch."""

    def __init__(self, net, static=()):
        self.net = net
        self.apply = jax.jit(net.apply, static_argnames=static)

    def __getattr__(self, name):
        return getattr(self.net, name)


@pytest.fixture(scope="module")
def gstyle():
    G = js.GStyle.create(resolution=RES, num_channels=3, latent_size=Z, dlatent_size=Z,
                         fmap_base=256, fmap_max=16, mapping_layers=2, mapping_fmaps=Z)
    params = _randomize_zeros(G.init(random.key(0)), 1)
    JG = _Jitted(G, ("is_training", "truncation_psi", "truncation_cutoff",
                     "randomize_noise"))
    return JG, params, gstyle_from_params(dataclasses.asdict(G), params, "cpu")


@pytest.fixture(scope="module")
def dbasics():
    """{label_size: (JAX DBasic with a jitted apply, params, port DBasic)}."""
    out = {}
    for label_size in (0, 10):
        D = js.DBasic(resolution=RES, num_channels=3, fmap_base=256, fmap_max=16,
                      mbstd_group_size=2, label_size=label_size)
        params = _randomize_zeros(D.init(random.key(2)), 3)
        out[label_size] = (_Jitted(D), params,
                           dbasic_from_params(dataclasses.asdict(D), params, "cpu"))
    return out


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture
def f32_sums(monkeypatch):
    """torch's bf16 conv2d as a float32 sum rounded to bf16."""
    conv2d = torch.nn.functional.conv2d

    def call(x, w, *a, **k):
        if x.dtype == torch.bfloat16:
            return conv2d(x.float(), w.float(), *a, **k).to(torch.bfloat16)
        return conv2d(x, w, *a, **k)
    monkeypatch.setattr(torch.nn.functional, "conv2d", call)


def _draws(G, key, batch, training):
    """The draws of ``GStyle.apply(rng=key)``: with ``training``, the
    style-mixing latents and cutoff; then one noise image per layer."""
    mixing = None
    num_layers = G.synthesis.num_layers
    if training:
        key, k1, k2, k3 = random.split(key, 4)
        latents2 = np.asarray(random.normal(k1, (batch, Z)))
        cutoff = int(jnp.where(random.uniform(k2) < G.style_mixing_prob,
                               random.randint(k3, (), 1, num_layers), num_layers))
        mixing = (torch.from_numpy(latents2), torch.tensor(cutoff))
    key, k = random.split(key)
    noise = {}
    for i in range(num_layers):
        k, kk = random.split(k)
        r = 2 ** (i // 2 + 2)
        noise[f"noise{i}"] = torch.from_numpy(np.asarray(random.normal(kk, (batch, 1, r, r))))
    return mixing, noise


PRIMITIVES = {
    "blur2d": (js.blur2d, ts.blur2d),
    "upscale2d": (js.upscale2d, ts.upscale2d),
    "downscale2d": (js.downscale2d, ts.downscale2d),
    "instance_norm": (js.instance_norm, ts.instance_norm),
    "pixel_norm": (js.pixel_norm, ts.pixel_norm),
}


@pytest.mark.parametrize("name", sorted(PRIMITIVES))
def test_primitive_matches_jax(name):
    jf, tf = PRIMITIVES[name]
    x = np.random.RandomState(0).randn(2, 5, 8, 12).astype(np.float32) * 3 + 1
    want = np.asarray(jf(jnp.asarray(x)))
    got = tf(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=PRIM_RTOL, atol=PRIM_RTOL * np.abs(want).max())


def test_lerp_clip_clips():
    a, b = torch.zeros(3), torch.ones(3)
    for t, want in ((-0.5, 0.0), (0.25, 0.25), (1.7, 1.0)):
        assert torch.equal(ts.lerp_clip(a, b, t), torch.full((3,), want))


@pytest.mark.parametrize("lod", [0.0, 0.5, 1.7])
def test_gstyle_matches_jax_at_lod(gstyle, lod):
    G, params, TG = gstyle
    z = np.random.RandomState(5).randn(MB, Z).astype(np.float32)
    want = G.apply(params, jnp.asarray(z), lod=jnp.float32(lod), randomize_noise=False)
    got = TG(torch.from_numpy(z), lod=lod, randomize_noise=False)
    assert got.shape == (MB, 3, RES, RES)
    assert rel_l2(_np(got), want) <= F32_REL_L2


@pytest.mark.parametrize("cutoff", ["default", None, 3])
def test_gstyle_truncation_matches_jax(gstyle, cutoff):
    """Truncation psi 0.5 with the model's cutoff (8: every layer at 16 px),
    no cutoff, and cutoff 3; the per-layer noise drawn from a key."""
    G, params, TG = gstyle
    z = np.random.RandomState(6).randn(MB, Z).astype(np.float32)
    _, noise = _draws(G, random.key(7), MB, training=False)
    want = G.apply(params, jnp.asarray(z), rng=random.key(7), truncation_psi=0.5,
                   truncation_cutoff=cutoff)
    got = TG(torch.from_numpy(z), truncation_psi=0.5, truncation_cutoff=cutoff,
             noise=noise, randomize_noise=False)
    assert rel_l2(_np(got), want) <= F32_REL_L2


def test_gstyle_training_mode_mixing_matches_jax(gstyle):
    """is_training: no truncation, style mixing with the JAX draws."""
    G, params, TG = gstyle
    z = np.random.RandomState(8).randn(MB, Z).astype(np.float32)
    for seed in range(4):  # keys whose cutoffs mix and do not mix
        mixing, noise = _draws(G, random.key(seed), MB, training=True)
        want = G.apply(params, jnp.asarray(z), rng=random.key(seed), is_training=True,
                       lod=jnp.float32(0.3))
        got = TG(torch.from_numpy(z), is_training=True, mixing=mixing, noise=noise,
                 randomize_noise=False, lod=0.3)
        assert rel_l2(_np(got), want) <= F32_REL_L2, seed


def test_gstyle_bf16_near_jax_float32(gstyle, f32_sums):
    G, params, _ = gstyle
    TG = gstyle_from_params(dataclasses.asdict(G.net), params, "cpu")
    set_compute_dtype(TG, "bfloat16")
    z = np.random.RandomState(9).randn(MB, Z).astype(np.float32)
    want = G.apply(params, jnp.asarray(z), lod=jnp.float32(0.5), randomize_noise=False)
    got = TG(torch.from_numpy(z), lod=0.5, randomize_noise=False)
    assert got.dtype == torch.bfloat16
    assert rel_l2(_np(got), want) <= G_BF16_REL_L2


def test_gstyle_fresh_init_has_jax_layout(gstyle):
    G, params, _ = gstyle
    fresh = ts.GStyle.create(resolution=RES, latent_size=Z, dlatent_size=Z, fmap_base=256,
                             fmap_max=16, mapping_layers=2, mapping_fmaps=Z)
    fresh.init(torch.Generator().manual_seed(0))
    want = {k: v.shape for k, v in flat(params).items()}
    got = {k: tuple(v.shape) for k, v in fresh.state_dict().items()}
    assert got == want
    assert torch.equal(getattr(fresh.synthesis, "4x4").Const.const,
                       torch.ones_like(getattr(fresh.synthesis, "4x4").Const.const))
    z = torch.randn(2, Z, generator=torch.Generator().manual_seed(1))
    img = fresh(z, generator=torch.Generator().manual_seed(2))
    assert img.shape == (2, 3, RES, RES) and torch.isfinite(img).all()


def _d_inputs(label_size):
    rnd = np.random.RandomState(11)
    x = rnd.uniform(-1, 1, (MB, 3, RES, RES)).astype(np.float32)
    labels = np.eye(max(label_size, 1), dtype=np.float32)[rnd.randint(0, max(label_size, 1),
                                                                       MB)]
    return x, labels[:, :label_size]


@pytest.mark.parametrize("label_size", [0, 10])
@pytest.mark.parametrize("lod", [0.0, 1.4])
def test_dbasic_forward_matches_jax(dbasics, label_size, lod):
    D, params, TD = dbasics[label_size]
    x, labels = _d_inputs(label_size)
    want = D.apply(params, jnp.asarray(x), jnp.asarray(labels), lod=lod)
    got = TD(torch.from_numpy(x), torch.from_numpy(labels), lod=lod)
    assert got.shape == (MB,)
    assert rel_l2(_np(got), want) <= F32_REL_L2


@pytest.mark.parametrize("label_size", [0, 10])
def test_dbasic_gradients_match_jax(dbasics, label_size):
    """d sum(scores^2) / d (parameters, images), against jax.grad."""
    D, params, TD = dbasics[label_size]
    x, labels = _d_inputs(label_size)

    def loss(p, img):
        return jnp.sum(jnp.square(D.net.apply(p, img, jnp.asarray(labels), lod=0.5)))

    jgp, jgx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    named = dict(TD.named_parameters())
    out = TD(tx, torch.from_numpy(labels), lod=0.5).square().sum()
    grads = torch.autograd.grad(out, [tx, *named.values()])
    assert rel_l2(grads[0].numpy(), jgx) <= F32_REL_L2
    want = flat(jgp)
    got = {k: g.numpy() for k, g in zip(named, grads[1:])}
    assert set(got) == set(want)
    whole = [np.concatenate([d[k].ravel() for k in sorted(d)]) for d in (got, want)]
    assert rel_l2(*whole) <= F32_REL_L2
    for k in want:
        assert rel_l2(got[k], want[k]) <= 1e-4, k


def test_dbasic_bf16_near_jax_float32(dbasics, f32_sums):
    D, params, _ = dbasics[0]
    TD = dbasic_from_params(dataclasses.asdict(D.net), params, "cpu")
    set_compute_dtype(TD, "bfloat16")
    x, labels = _d_inputs(0)
    want = D.apply(params, jnp.asarray(x), jnp.asarray(labels), lod=0.0)
    got = TD(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    assert rel_l2(_np(got), want) <= BF16_REL_L2
