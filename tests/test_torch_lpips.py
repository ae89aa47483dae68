"""The port's LPIPS (inclusivegan_torch.models.lpips) against the JAX
package's, on the CPU: the VGG16 trunk with seeded random weights
(``init_lpips_params``) at 16 px, the converted-weights loader, and the
pixel-pyramid fallback. float32; features and distances within 1e-5
absolute + 1e-4 relative (the VGG sums 13 convolutions in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inclusivegan_tpu.models import lpips as jl
from inclusivegan_torch.models import lpips as tl

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def vgg_params():
    tree = jax.tree_util.tree_map(np.asarray, jl.init_lpips_params(seed=3))
    return tree, tl.lpips_params_from_numpy(tree, "cpu")


def _images(n, res, seed):
    return np.random.RandomState(seed).uniform(0, 255, (n, 3, res, res)).astype(np.float32)


def test_vgg_features_and_distance_match_jax(vgg_params):
    jp, tp = vgg_params
    a, b = _images(3, 16, 0), _images(3, 16, 1)
    feats_jax = jl.lpips_features(jp, jnp.asarray(a))
    feats = tl.lpips_features(tp, torch.from_numpy(a))
    assert len(feats) == 5
    for f, fj in zip(feats, feats_jax):
        np.testing.assert_allclose(f.numpy(), np.asarray(fj), **TOL)
    np.testing.assert_allclose(
        tl.lpips_distance(tp, torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jl.lpips_distance(jp, jnp.asarray(a), jnp.asarray(b))), **TOL)


def test_distance_gradient_matches_jax(vgg_params):
    """The G loss differentiates LPIPS in its first argument."""
    jp, tp = vgg_params
    a, b = _images(2, 16, 2), _images(2, 16, 3)
    at = torch.from_numpy(a).requires_grad_()
    (g,) = torch.autograd.grad(tl.lpips_distance(tp, at, torch.from_numpy(b)).sum(), at)
    g_jax = jax.grad(lambda x: jnp.sum(jl.lpips_distance(jp, x, jnp.asarray(b))))(
        jnp.asarray(a))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_jax), rtol=1e-3, atol=1e-6)


def test_load_lpips_params_matches_jax(tmp_path, vgg_params):
    jp, _ = vgg_params
    path = tmp_path / "vgg.npz"
    arrays = {f"{name}_{k}": jp[name][k] for name, _c, _p in jl._VGG_LAYOUT
              for k in ("w", "b")}
    arrays.update({f"lin_{tap}": jp[f"lin_{tap}"] for tap in jl._TAPS})
    np.savez(path, **arrays)
    jp2 = jl.load_lpips_params(str(path))
    tp2 = tl.load_lpips_params(str(path), "cpu")
    assert tp2["_mode"] == 1
    a, b = _images(2, 16, 4), _images(2, 16, 5)
    np.testing.assert_allclose(
        tl.lpips_distance(tp2, torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jl.lpips_distance(jp2, jnp.asarray(a), jnp.asarray(b))), **TOL)
    assert tl.get_lpips_params(str(path), "cpu")["_mode"] == 1


@pytest.mark.parametrize("res,channels", [(16, 3), (8, 3), (16, 1)])
def test_pixel_fallback_matches_jax(res, channels):
    """The fallback pyramid, including the rescaling below 16 px and the
    broadcast of a one-channel image."""
    jp = jl.init_pixel_fallback_params()
    tp = tl.init_pixel_fallback_params("cpu")
    rnd = np.random.RandomState(res)
    a = rnd.uniform(0, 255, (2, channels, res, res)).astype(np.float32)
    b = rnd.uniform(0, 255, (2, channels, res, res)).astype(np.float32)
    np.testing.assert_allclose(
        tl.lpips_distance(tp, torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jl.lpips_distance(jp, jnp.asarray(a), jnp.asarray(b))), **TOL)


def test_get_lpips_params_falls_back_without_weights(monkeypatch):
    monkeypatch.setenv("INCLUSIVEGAN_LPIPS_WEIGHTS", "")
    params = tl.get_lpips_params(device="cpu")
    assert params["_mode"] == 2 and "conv1_1" not in params
