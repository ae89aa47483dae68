"""generate-images: the port's ``generate_images`` against the JAX CLI's own
``run_generator.generate_images`` on a narrow snapshot, and (slow) against
the committed JAX golden of the full-width CelebA-128 Gs."""

import dataclasses
import os
import pickle
import types

import jax
import numpy as np
import PIL.Image
import pytest
import torch

import run_generator as jax_run_generator
from inclusivegan_tpu.models.stylegan2 import GMain as JGMain
from inclusivegan_torch import run_generator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "inclusivegan_torch", "testdata",
                      "celeba128_gs_golden.npz")


@pytest.fixture(scope="module")
def narrow_pkl(tmp_path_factory):
    """A network_snapshot.v1 pickle of a narrow G (resolution 32), with
    random biases and noise strengths so that every input shows."""
    G = JGMain.create(resolution=32, fmap_base=256, fmap_max=32, latent_size=32,
                      dlatent_size=32, mapping_layers=2, mapping_fmaps=32)
    rnd = np.random.RandomState(11)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(0.5 * rnd.randn(*a.shape), np.float32)
        if not np.any(a) else np.asarray(a), G.init(jax.random.key(1)))
    config = dataclasses.asdict(G)
    for sub in ("mapping", "synthesis"):
        config[sub]["dtype"] = "float32"
    net = {"config": config, "params": params}
    path = tmp_path_factory.mktemp("snap") / "narrow.pkl"
    with open(path, "wb") as f:
        pickle.dump({"format": "inclusivegan_tpu.network_snapshot.v1",
                     "G": net, "Gs": net,
                     "D": {"config": {"resolution": 32, "fmap_base": 256,
                                      "fmap_max": 32}, "params": {}}}, f)
    return str(path)


def _jax_images(pkl, num_images, minibatch_size, run_dir):
    jax_run_generator.generate_images(types.SimpleNamespace(run_dir=str(run_dir)),
                                      pkl, num_images, minibatch_size)
    return np.stack([np.asarray(PIL.Image.open(os.path.join(run_dir, f"{i:06d}.png")))
                     for i in range(num_images)])


def test_generate_images_matches_jax_cli(narrow_pkl, tmp_path):
    """Same latents and noise from RandomState(0), re-drawn per minibatch;
    3 images in minibatches of 2, so the last minibatch is cut."""
    want = _jax_images(narrow_pkl, 3, 2, tmp_path)
    got = run_generator.generate_images(narrow_pkl, 3, 2, device="cpu")
    assert got.dtype == np.uint8 and got.shape == want.shape == (3, 32, 32, 3)
    np.testing.assert_array_equal(got, want)


def test_cli_writes_pngs(narrow_pkl, tmp_path):
    out = tmp_path / "gen"
    run_generator.main(["generate-images", "--network", narrow_pkl,
                        "--num-images", "3", "--minibatch-size", "2",
                        "--device", "cpu", "--result-dir", str(out)])
    images = run_generator.generate_images(narrow_pkl, 3, 2, device="cpu")
    for i in range(3):
        np.testing.assert_array_equal(
            np.asarray(PIL.Image.open(out / f"{i:06d}.png")), images[i])


def test_generate_images_default_device_needs_cuda(narrow_pkl, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_generator.generate_images(narrow_pkl, 1, 1)


@pytest.mark.slow
def test_full_width_matches_jax_golden():
    """The CelebA-128 Gs on the CPU against the JAX package's images: at most
    2 levels apart, and at most 0.5% of values differ at all."""
    golden = np.load(GOLDEN)["images"]
    got = run_generator.generate_images(
        os.path.join(ROOT, "artifacts", "celeba_best_weights_fp16.pkl"),
        len(golden), 4, device="cpu")
    d = np.abs(got.astype(np.int32) - golden.astype(np.int32))
    assert d.max() <= 2 and np.mean(d > 0) <= 0.005


@pytest.mark.parametrize("scale", [0.8, 3.0])
def test_generator_output_to_uint8_matches_jax_cli(scale):
    """The JAX CLI's conversion (``run_generator.py`` ``sample``); scale 3.0
    sends values outside [-1, 1], so the clip shows."""
    import jax.numpy as jnp
    from inclusivegan_torch import utils
    x = np.random.RandomState(4).randn(2, 3, 5, 4).astype(np.float32) * scale
    want = jnp.transpose(jnp.clip((jnp.asarray(x) + 1.0) * 127.5 + 0.5, 0, 255)
                         .astype(jnp.uint8), (0, 2, 3, 1))
    np.testing.assert_array_equal(
        utils.generator_output_to_uint8(torch.from_numpy(x)).numpy(),
        np.asarray(want))


def test_cli_switches_tf32_off(monkeypatch, tmp_path):
    """The command line runs float32 as the JAX package does: TF32 off for
    cuDNN's convolutions and for matrix products, before the network loads.
    ``generate_images`` itself leaves the flags alone."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = {}

    def fake_generate_images(network, **kwargs):
        seen["flags"] = (torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32)
        return np.zeros((1, 4, 4, 3), np.uint8)

    monkeypatch.setattr(run_generator, "generate_images", fake_generate_images)
    run_generator.main(["generate-images", "--network", "unused.pkl",
                        "--num-images", "1", "--result-dir", str(tmp_path)])
    assert seen["flags"] == (False, False)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
