"""The port's evaluation at a larger scale than ``test_torch_eval.py``, which
it shares helpers with: the stacked-MNIST snapshot's modes against JAX,
``run_metrics`` with every new metric on a narrow 32 px snapshot, and the
configs ``chip_smoke.py`` builds its 32 px G and D from.

Tolerances are stated at each test."""

import dataclasses
import os
import pickle

import jax
import numpy as np
import pytest

import inclusivegan_tpu.models.feature_nets as jfn
from inclusivegan_torch.metrics import KL as tkl
from inclusivegan_torch.metrics import metric_base as tmb
from inclusivegan_torch.metrics import mode_counts as tmc
from inclusivegan_torch.models import feature_nets as tfn
from inclusivegan_tpu.data.dataset_tool import TFRecordExporter
from inclusivegan_tpu.metrics import KL as jkl
from inclusivegan_tpu.metrics import metric_base as jmb
from inclusivegan_tpu.metrics import mode_counts as jmc
from test_torch_eval import MNIST_NPZ, ROOT, _images, _np_tree, lpips_npz  # noqa: F401
from torch_golden import jax_draws


def test_mode_counts_on_the_stacked_mnist_snapshot():
    """``artifacts/best_weights_fp16.pkl`` (32 px, full width) with the
    trained classifier, 256 images, the JAX sampler's noise handed across:
    modes agree on at least 99% of the images (a uint8 level may move a
    digit on its boundary), counts within 2 and KL within 2%."""
    pkl = os.path.join(ROOT, "artifacts", "best_weights_fp16.pkl")
    num, bs = 256, 32
    jsampler = jmb.GsSampler(pkl, minibatch_size=bs)
    noise = iter([jax_draws.to_torch(n) for n in
                  jax_draws.sampler_noise(jsampler.G, 1000, num // bs, bs)])
    sampler = tmb.GsSampler(pkl, minibatch_size=bs, device="cpu",
                            noise_fn=lambda n: next(noise))
    jimgs = np.concatenate(list(jsampler.random_images(num)))
    imgs = np.concatenate(list(sampler.random_images(num)))
    jmodes = jfn.StackedMNISTClassifier(MNIST_NPZ).modes(jimgs)
    modes = tfn.StackedMNISTClassifier(MNIST_NPZ, device="cpu").modes(imgs)
    assert np.mean(modes == jmodes) >= 0.99
    assert abs(tmc.count_modes(modes) - jmc.count_modes(jmodes)) <= 2
    np.testing.assert_allclose(tkl.kl_to_uniform(modes), jkl.kl_to_uniform(jmodes),
                               rtol=2e-2)


@pytest.fixture(scope="module")
def narrow_32px(tmp_path_factory):
    """A narrow 32 px snapshot (the stacked-MNIST classifier's size) and a
    32 px TFRecord set of 24 images."""
    from inclusivegan_tpu.models.stylegan2 import Discriminator, GMain
    G = GMain.create(resolution=32, latent_size=16, dlatent_size=16, mapping_layers=2,
                     mapping_fmaps=16, fmap_base=128, fmap_max=16)
    D = Discriminator(resolution=32, fmap_base=128, fmap_max=16, mbstd_group_size=2)
    gp, dp = _np_tree(G.init(jax.random.key(4))), _np_tree(D.init(jax.random.key(5)))
    root = tmp_path_factory.mktemp("n32")
    path = str(root / "network-snapshot-000032.pkl")
    with open(path, "wb") as f:
        pickle.dump({"format": "inclusivegan_tpu.network_snapshot.v1",
                     "G": {"config": dataclasses.asdict(G), "params": gp},
                     "D": {"config": dataclasses.asdict(D), "params": dp},
                     "Gs": {"config": dataclasses.asdict(G), "params": gp}}, f)
    data = str(root / "digits")
    with TFRecordExporter(data, 24, print_progress=False) as tfr:
        for img in _images(24, res=32, seed=14):
            tfr.add_image(img)
    return path, data


def test_run_metrics_cli_runs_every_new_metric(narrow_32px, lpips_npz, tmp_path,  # noqa: F811
                                               monkeypatch):
    """``python -m inclusivegan_torch.run_metrics`` on the CPU with pr50k3,
    ppl_wend, ls, mode_counts_24k, KL24k and FID on the VGG features, each
    cut in count: one finite line per metric, with its tags."""
    from inclusivegan_torch import run_metrics
    from inclusivegan_torch.metrics.metric_defaults import metric_defaults
    from inclusivegan_torch.utils.easydict import EasyDict
    snap, data = narrow_32px
    monkeypatch.chdir(ROOT)  # the classifiers' default paths
    monkeypatch.setenv("INCLUSIVEGAN_CACHE", str(tmp_path / "cache"))
    cuts = dict(pr50k3=dict(num_images=16), ppl_wend=dict(num_samples=8),
                ls=dict(num_samples=64, num_keep=32, attrib_indices=range(3)),
                mode_counts_24k=dict(num_images=64), KL24k=dict(num_images=64),
                fid10k=dict(num_images=16, feature_net="vgg"))
    for name, cut in cuts.items():
        monkeypatch.setitem(metric_defaults, name, EasyDict(metric_defaults[name], **cut))
    results = run_metrics.main([
        "--network", snap, "--metrics", ",".join(cuts), "--data-dir",
        os.path.dirname(data), "--dataset", os.path.basename(data), "--result-dir",
        str(tmp_path / "results"), "--lpips-weights", lpips_npz, "--classifier-weights",
        MNIST_NPZ, "--device", "cpu"])
    assert set(results) == {
        "pr50k3_precision", "pr50k3_recall", "pr50k3_random_features", "ppl_wend", "ls_z",
        "ls_w", "mode_counts_24k", "mode_counts_24k_KL", "KL24k", "fid10k",
        "fid10k_random_features"}
    assert all(np.isfinite(v) for v in results.values())
    assert 1 <= results["mode_counts_24k"] <= 64 and results["ppl_wend"] > 0
    np.testing.assert_allclose(results["mode_counts_24k_KL"], results["KL24k"])
    (run_dir,) = os.listdir(tmp_path / "results")
    for name in cuts:
        lines = open(tmp_path / "results" / run_dir / f"metric-{name}.txt").read().splitlines()
        assert len(lines) == 1 and "network-snapshot-000032" in lines[0]


def test_chip_smokes_stacked_mnist_configs_are_the_snapshots():
    """chip_smoke.py builds a fresh G and D from the stacked-MNIST snapshot's
    configs, since the pickle does not fit in the card's copy beside the
    CelebA one; its dicts must be the pickle's, dtype aside."""
    import importlib.util
    from inclusivegan_torch.models.stylegan2 import Discriminator, GMain
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with open(os.path.join(ROOT, "artifacts", "best_weights_fp16.pkl"), "rb") as f:
        snap = pickle.load(f)
    G = GMain.create(**smoke.MNIST_G_CONFIG)
    D = Discriminator(**smoke.MNIST_D_CONFIG)
    for got, want in ((G.config, snap["Gs"]["config"]), (D.config, snap["D"]["config"])):
        want = {k: ({kk: vv for kk, vv in v.items() if kk != "dtype"}
                    if isinstance(v, dict) else v) for k, v in want.items() if k != "dtype"}
        got = {k: ({kk: vv for kk, vv in v.items() if kk != "dtype"}
                   if isinstance(v, dict) else v) for k, v in got.items() if k != "dtype"}
        assert got == want
