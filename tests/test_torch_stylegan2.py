"""The port's generator (inclusivegan_torch.models.stylegan2) against the JAX
package's, on a narrow G: resolution 32, fmap_base 256, fmap_max 32, two
mapping layers of width 32. Parameters come from the JAX ``GMain.init`` and
are carried across with ``snapshot.gmain_from_params``; latents, dlatents and
noise are numpy arrays from a seed given to both. float32 on the CPU, max abs
error <= 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inclusivegan_tpu.models.stylegan2 import GMain as JGMain
from inclusivegan_torch.snapshot import gmain_from_params

ATOL = 1e-4
BATCH = 3


def narrow_g(architecture="skip"):
    """The JAX narrow G, its numpy params and its config as a snapshot
    stores it. The leaves that init sets to zero (biases, noise strengths,
    dlatent_avg) get random values, so that each of them shows in the
    output."""
    G = JGMain.create(resolution=32, fmap_base=256, fmap_max=32, latent_size=32,
                      dlatent_size=32, mapping_layers=2, mapping_fmaps=32,
                      architecture=architecture)
    rnd = np.random.RandomState(7)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(0.5 * rnd.randn(*a.shape), np.float32)
        if not np.any(a) else np.asarray(a), G.init(jax.random.key(0)))
    config = dataclasses.asdict(G)
    for sub in ("mapping", "synthesis"):
        config[sub]["dtype"] = "float32"
    return G, params, config


def _cast(tree, dtype):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), tree)


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("architecture", ["skip", "resnet", "orig"])
def test_mapping_and_synthesis_match_jax(architecture):
    G, params, config = narrow_g(architecture)
    T = gmain_from_params(config, params, device="cpu")
    rnd = np.random.RandomState(1)
    z = rnd.randn(BATCH, 32).astype(np.float32)
    np.testing.assert_allclose(
        _np(T.mapping(torch.from_numpy(z))),
        np.asarray(G.mapping.apply(params["mapping"], jnp.asarray(z))), atol=ATOL)

    dl = rnd.randn(BATCH, G.synthesis.num_layers, 32).astype(np.float32)
    noise = {k: rnd.randn(*v.shape).astype(np.float32)
             for k, v in sorted(params["noise"].items())}
    y_jax = G.synthesis.apply(params["synthesis"], jnp.asarray(dl),
                              noise=noise, randomize_noise=False)
    y = T.synthesis(torch.from_numpy(dl), randomize_noise=False,
                    noise={k: torch.from_numpy(v) for k, v in noise.items()})
    assert tuple(y.shape) == y_jax.shape == (BATCH, 3, 32, 32)
    np.testing.assert_allclose(_np(y), np.asarray(y_jax), atol=ATOL)


@pytest.mark.parametrize("param_dtype", [np.float32, np.float16])
@pytest.mark.parametrize("psi,cutoff", [(None, "default"), (0.5, 4), (1.0, "default")])
def test_full_eval_apply_matches_jax(param_dtype, psi, cutoff):
    """Eval-mode apply with truncation, on the stored noise. float16 params
    are what the CelebA snapshot holds: the port must scale them in float16
    as JAX does before the float32 compute."""
    G, params, config = narrow_g()
    params = _cast(params, param_dtype)
    T = gmain_from_params(config, params, device="cpu")
    z = np.random.RandomState(2).randn(BATCH, 32).astype(np.float32)
    img_jax, dl_jax = G.apply(params, jnp.asarray(z), truncation_psi=psi,
                              truncation_cutoff=cutoff, randomize_noise=False,
                              return_dlatents=True)
    with torch.no_grad():
        img, dl = T(torch.from_numpy(z), truncation_psi=psi,
                    truncation_cutoff=cutoff, randomize_noise=False,
                    return_dlatents=True)
    np.testing.assert_allclose(_np(dl), np.asarray(dl_jax), atol=ATOL)
    np.testing.assert_allclose(_np(img), np.asarray(img_jax), atol=ATOL)


def test_randomize_noise_draws_from_the_generator():
    _, params, config = narrow_g()
    T = gmain_from_params(config, params, device="cpu")
    z = torch.from_numpy(np.random.RandomState(3).randn(2, 32).astype(np.float32))
    with torch.no_grad():
        a = T(z, generator=torch.Generator().manual_seed(5))
        b = T(z, generator=torch.Generator().manual_seed(5))
        c = T(z, generator=torch.Generator().manual_seed(6))
        with pytest.raises(ValueError, match="Generator"):
            T(z)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_parameter_names_follow_the_jax_tree():
    G, params, config = narrow_g("resnet")
    T = gmain_from_params(config, params, device="cpu")
    flat = {".".join(k.key for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert set(T.state_dict()) == flat
    w = params["synthesis"]["8x8"]["Conv0_up"]["weight"]
    np.testing.assert_array_equal(
        T.state_dict()["synthesis.8x8.Conv0_up.weight"].numpy(),
        np.transpose(w, (3, 2, 0, 1)))


# --- discriminator, minibatch stddev, training-mode G -----------------------
# Same tolerance (max abs error <= 1e-4, float32 on the CPU); D at resolution
# 16 with fmap_base 128, fmap_max 16 and mbstd groups of 2.

from inclusivegan_tpu.models.stylegan2 import Discriminator as JDiscriminator  # noqa: E402
from inclusivegan_tpu.models.stylegan2 import minibatch_stddev as j_mbstd  # noqa: E402
from inclusivegan_torch.models.stylegan2 import minibatch_stddev  # noqa: E402
from inclusivegan_torch.snapshot import discriminator_from_params  # noqa: E402


def narrow_d(architecture):
    D = JDiscriminator(resolution=16, fmap_base=128, fmap_max=16,
                       architecture=architecture, mbstd_group_size=2)
    rnd = np.random.RandomState(8)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(0.5 * rnd.randn(*a.shape), np.float32)
        if not np.any(a) else np.asarray(a), D.init(jax.random.key(3)))
    config = dataclasses.asdict(D)
    config["dtype"] = "float32"
    return D, params, config


@pytest.mark.parametrize("param_dtype", [np.float32, np.float16])
@pytest.mark.parametrize("architecture", ["resnet", "skip", "orig"])
def test_discriminator_matches_jax(architecture, param_dtype):
    D, params, config = narrow_d(architecture)
    params = _cast(params, param_dtype)
    T = discriminator_from_params(config, params, device="cpu")
    x = np.random.RandomState(4).randn(4, 3, 16, 16).astype(np.float32)
    scores_jax, feats_jax = D.apply(params, jnp.asarray(x))
    with torch.no_grad():
        scores, feats = T(torch.from_numpy(x))
    assert tuple(feats.shape) == feats_jax.shape
    np.testing.assert_allclose(_np(scores), np.asarray(scores_jax), atol=ATOL)
    np.testing.assert_allclose(_np(feats), np.asarray(feats_jax), atol=ATOL)
    flat = {".".join(k.key for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert set(T.state_dict()) == flat


@pytest.mark.parametrize("contiguous", [False, True])
@pytest.mark.parametrize("n,group", [(6, 2), (6, 4), (4, 6)])
def test_minibatch_stddev_matches_jax(n, group, contiguous):
    x = np.random.RandomState(5).randn(n, 4, 3, 3).astype(np.float32)
    y_jax = j_mbstd(jnp.asarray(x), group, 2, contiguous=contiguous)
    y = minibatch_stddev(torch.from_numpy(x), group, 2, contiguous=contiguous)
    np.testing.assert_allclose(_np(y), np.asarray(y_jax), atol=ATOL)


def _jax_mixing_draws(G, key, batch):
    """(latents2, cutoff) as map_latents(rng=key) draws them."""
    _, k1, k2, k3 = jax.random.split(key, 4)
    latents2 = np.asarray(jax.random.normal(k1, (batch, 32), jnp.float32))
    cutoff = int(np.where(np.asarray(jax.random.uniform(k2)) < G.style_mixing_prob,
                          np.asarray(jax.random.randint(k3, (), 1,
                                                        G.synthesis.num_layers)),
                          G.synthesis.num_layers))
    return latents2, cutoff


@pytest.mark.parametrize("seed", [0, 1, 2, 5])
def test_map_latents_with_mixing_matches_jax(seed):
    """The keys are chosen so that both a mixing and a non-mixing draw
    occur; the JAX draws are re-derived and handed to the port."""
    G, params, config = narrow_g()
    T = gmain_from_params(config, params, device="cpu")
    z = np.random.RandomState(6).randn(BATCH, 32).astype(np.float32)
    key = jax.random.key(seed)
    dl_jax, avg_jax = G.map_latents(params, jnp.asarray(z), rng=key)
    latents2, cutoff = _jax_mixing_draws(G, key, BATCH)
    with torch.no_grad():
        dl, avg = T.map_latents(torch.from_numpy(z),
                                mixing=(torch.from_numpy(latents2),
                                        torch.tensor(cutoff)))
    np.testing.assert_allclose(_np(dl), np.asarray(dl_jax), atol=ATOL)
    np.testing.assert_allclose(_np(avg), np.asarray(avg_jax), atol=ATOL)


def test_training_apply_matches_jax():
    """Training mode: no truncation, style mixing, per-example noise and
    the batch average for the dlatent_avg EMA."""
    G, params, config = narrow_g()
    T = gmain_from_params(config, params, device="cpu")
    z = np.random.RandomState(7).randn(BATCH, 32).astype(np.float32)
    key = jax.random.key(9)
    img_jax, dl_jax, avg_jax = G.apply(params, jnp.asarray(z), rng=key,
                                       is_training=True, return_dlatents=True)
    latents2, cutoff = _jax_mixing_draws(G, key, BATCH)
    rest = jax.random.split(key, 4)[0]
    krng = jax.random.split(rest)[1]
    noise = {}
    for i in range(G.synthesis.num_layers - 1):
        krng, k = jax.random.split(krng)
        res = 2 ** ((i + 5) // 2)
        noise[f"noise{i}"] = torch.from_numpy(np.asarray(
            jax.random.normal(k, (BATCH, 1, res, res))))
    with torch.no_grad():
        img, dl, avg = T(torch.from_numpy(z), is_training=True, return_dlatents=True,
                         mixing=(torch.from_numpy(latents2), torch.tensor(cutoff)),
                         noise=noise, randomize_noise=False)
    for a, b in ((dl, dl_jax), (avg, avg_jax), (img, img_jax)):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=ATOL)


def test_draw_mixing_follows_the_mixing_probability():
    _, params, config = narrow_g()
    T = gmain_from_params(config, params, device="cpu")
    gen = torch.Generator().manual_seed(0)
    cuts = [int(T.draw_mixing(2, gen)[1]) for _ in range(400)]
    L = T.synthesis.num_layers
    assert set(cuts) <= set(range(1, L + 1))
    assert 0.05 < np.mean(np.array(cuts) == L) < 0.2  # 1 - 0.9 expected
    assert T.draw_mixing(2, gen, style_mixing_prob=None) is None
