"""The port's IvOM projector (inclusivegan_torch.projector, run_projector)
against the JAX package's on the CPU: the narrow 16 px G of both packages,
one random-feature VGG LPIPS npz that both load, the same targets and
initial latents, and the JAX projector's noise latents handed to the port.

Tolerances: the latents' gradient within relative L2 1e-4 and the LPIPS
distances within rtol 1e-4 (float32 through G, LPIPS and their backward
passes, summed in other orders); after several Adam steps the latents
within 1e-4 and the distances within rtol 1e-3 (Adam's first steps are
near sign(gradient) times the learning rate, so a rounding difference in
a small gradient entry moves its latent by up to 1e-5 a step).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inclusivegan_torch import run_projector
from inclusivegan_torch.projector import Projector
from inclusivegan_torch.snapshot import gmain_from_params
from inclusivegan_torch.utils.run_harness import SubmitConfig, submit_run
from inclusivegan_tpu.data.dataset_tool import TFRecordExporter
from inclusivegan_tpu.models.lpips import get_lpips_params, lpips_distance
from inclusivegan_tpu.projector import Projector as JProjector
from inclusivegan_tpu.training.loss import slerp
from test_torch_eval import _images, lpips_npz, snapshot_16px  # noqa: F401
from torch_golden import jax_draws
from torch_golden.narrow_nets import ZDIM, narrow_nets

MB = 2


@pytest.fixture(scope="module")
def nets():
    G, _, gp, _, gc, _ = narrow_nets()
    return G, gp, gmain_from_params(gc, gp, "cpu")


def _noise_at(noise, step):
    return torch.from_numpy(noise[step])


def _targets(seed=20):
    return _images(MB, seed=seed).astype(np.float32) / 127.5 - 1.0


def _pair(nets, lpips_npz, num_steps):  # noqa: F811
    G, gp, tG = nets
    jproj = JProjector(lpips_weights=lpips_npz)
    jproj.set_network(G, gp, minibatch_size=MB, num_steps=num_steps)
    noise = jax_draws.projector_noise(0, num_steps, (MB, ZDIM))
    proj = Projector(lpips_weights=lpips_npz, noise_fn=functools.partial(_noise_at, noise))
    proj.set_network(tG, minibatch_size=MB, num_steps=num_steps)
    return jproj, proj, noise


def test_latents_gradient_matches_jax(nets, lpips_npz):  # noqa: F811
    """One step's distances and gradient, from the same latents and noise
    latents, against jax.grad of the JAX projector's loss."""
    G, gp, tG = nets
    jproj, proj, noise = _pair(nets, lpips_npz, 10)
    targets = _targets()
    jproj.start(targets)
    proj.start(targets)
    strength, lr = proj.ramps(3)
    assert (strength, lr) == pytest.approx((0.05 * (1 - 0.3 / 0.75) ** 2, 0.1))
    lat = np.random.RandomState(0).randn(MB, ZDIM).astype(np.float32)
    lp = get_lpips_params(lpips_npz)

    def loss_fn(lat):
        z = slerp(lat, jnp.asarray(noise[3]), jnp.float32(strength))
        img = G.apply(gp, z, jnp.zeros((MB, 0)), truncation_psi=1.0, randomize_noise=False)
        dist = lpips_distance(lp, (img + 1.0) * (255.0 / 2.0), jproj._targets_proc)
        return jnp.sum(dist), dist

    (_, jdist), jgrad = jax.value_and_grad(loss_fn, has_aux=True)(jnp.asarray(lat))
    dist, _, grad = proj.loss_and_grad(torch.from_numpy(lat), torch.from_numpy(noise[3]),
                                       strength)
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=1e-4)
    jgrad = np.asarray(jgrad)
    assert np.linalg.norm(grad.numpy() - jgrad) <= 1e-4 * np.linalg.norm(jgrad)
    assert all(p.grad is None and not p.requires_grad for p in tG.parameters())


@pytest.mark.parametrize("num_steps", [1, 6])
def test_projector_steps_match_jax(nets, lpips_npz, num_steps):  # noqa: F811
    jproj, proj, _ = _pair(nets, lpips_npz, num_steps)
    targets = _targets()
    jres, res = jproj.run(targets), proj.run(targets)
    assert proj.get_cur_step() == jproj.get_cur_step() == num_steps
    np.testing.assert_allclose(res.latents, jres.latents, atol=1e-4)
    np.testing.assert_allclose(proj._last_dist.numpy(), np.asarray(jproj._last_dist),
                               rtol=1e-3)
    np.testing.assert_allclose(res.dist, jres.dist, rtol=1e-3)
    np.testing.assert_allclose(res.images, jres.images, atol=1e-3)
    if num_steps > 1:  # the learning rate is 0 at step 0 only
        assert np.abs(res.latents - np.random.RandomState(0).randn(MB, ZDIM)).max() > 1e-3


@pytest.fixture(scope="module")
def projection_set(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("data") / "faces")
    images = _images(4, seed=30)
    with TFRecordExporter(d, 4, print_progress=False) as tfr:
        for img in images:
            tfr.add_image(img)
    return d, images


def test_run_projector_run_dir_and_ivom_match_jax(nets, snapshot_16px, projection_set,  # noqa: F811
                                                  lpips_npz, tmp_path):
    """``project_real_images`` through the run harness: every file of the
    JAX CLI's run dir, and the IvOM mean against the JAX projector on the
    same reals in the same order."""
    data_dir, images = projection_set
    num_steps, snaps = 4, 2
    noise = jax_draws.projector_noise(0, num_steps, (MB, ZDIM))
    root = str(tmp_path / "proj")
    mean, std = submit_run(
        SubmitConfig(run_dir_root=root, run_desc="project-real-images"),
        "inclusivegan_torch.run_projector.project_real_images",
        network_pkl=snapshot_16px, dataset_name=os.path.basename(data_dir),
        data_dir=os.path.dirname(data_dir), num_images=4, num_steps=num_steps,
        minibatch_size=MB, num_snapshots=snaps, lpips_weights=lpips_npz, device="cpu",
        noise_fn=functools.partial(_noise_at, noise))  # pickled into the run dir
    run_dir = os.path.join(root, "00000-project-real-images")
    want = {f"image{i:04d}-{kind}.png" for i in range(4) for kind in ("target", "final")}
    want |= {f"image{i:04d}-step{s:04d}.png" for i in range(4) for s in (0, 2)}
    assert want <= set(os.listdir(run_dir))
    mean_s, std_s, n = open(os.path.join(run_dir, "ivom.txt")).read().split()
    assert (float(mean_s), float(std_s), int(n)) == pytest.approx((mean, std, 4), abs=1e-6)
    assert "IvOM (LPIPS after 4 steps over 4 images)" in open(
        os.path.join(run_dir, "log.txt")).read()

    G, gp, _ = nets
    jproj = JProjector(lpips_weights=lpips_npz)
    jproj.set_network(G, gp, minibatch_size=MB, num_steps=num_steps)
    jd = np.concatenate([jproj.run(images[i:i + MB].astype(np.float32) / 127.5 - 1.0).dist
                         for i in range(0, 4, MB)])
    np.testing.assert_allclose((mean, std), (jd.mean(), jd.std()), rtol=1e-3)


def test_run_projector_cli(snapshot_16px, projection_set, tmp_path, monkeypatch):  # noqa: F811
    """The CLI on the CPU (pixel fallback LPIPS) switches TF32 off; its
    default device is the card."""
    data_dir, _ = projection_set
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    argv = ["project-real-images", "--network", snapshot_16px, "--data-dir",
            os.path.dirname(data_dir), "--dataset", os.path.basename(data_dir),
            "--num-images", "2", "--num-steps", "2", "--minibatch-size", "2",
            "--result-dir", str(tmp_path / "cli")]
    assert run_projector.parse_args(argv)["device"] == "cuda"
    mean, std = run_projector.main(argv + ["--device", "cpu"])
    assert np.isfinite(mean) and mean > 0
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_projector.main(argv)
