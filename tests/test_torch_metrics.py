"""The port's metric framework, FID, IS and run_metrics CLI
(inclusivegan_torch.metrics, inclusivegan_torch.run_metrics) against the JAX
package's, on the CPU.

FID and IS: both packages' metric classes evaluate the same uint8 images,
fakes from a stand-in sampler and reals from one 16 px TFRecord set
(mirror-augmented), with the same InceptionV3 parameters (the JAX net's
seeded ones, written as an npz that both load); one JAX InceptionV3 serves
every JAX metric here, so that its CPU compile happens once. Results within
relative 1e-4 (IS's standard deviation over two near-equal splits, near 0,
within 1e-4 relative + 1e-7 absolute). ``GsSampler``: the same snapshot, latents from the same seed
and the JAX sampler's noise draws handed to the port; images within 1 uint8
level. Registry: the same names and arguments; the metrics not ported yet
refused with their ROADMAP item.
"""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

import inclusivegan_tpu.models.inception as jinc
from inclusivegan_torch import run_metrics
from inclusivegan_torch.metrics import frechet_inception_distance as tfid
from inclusivegan_torch.metrics import inception_score as tis
from inclusivegan_torch.metrics import metric_base as tmb
from inclusivegan_torch.metrics.metric_defaults import (check_metric_args, metric_args,
                                                        metric_defaults)
from inclusivegan_torch.utils.easydict import EasyDict
from inclusivegan_torch.utils.misc import (apply_mirror_augment,
                                           parse_config_for_previous_run)
from inclusivegan_torch.utils.run_harness import SubmitConfig
from inclusivegan_tpu.metrics import frechet_inception_distance as jfid
from inclusivegan_tpu.metrics import inception_score as jis
from inclusivegan_tpu.metrics import metric_base as jmb
from inclusivegan_tpu.metrics.metric_defaults import metric_defaults as jax_defaults
from inclusivegan_tpu.utils import misc as jmisc
from test_torch_training_loop import LOOP, _args, toy_dataset  # noqa: F401
from torch_golden import jax_draws
from torch_golden.narrow_nets import RES, ZDIM, narrow_nets

METRIC_RTOL = 1e-4
N_IMAGES = 4
BATCH = 2


def test_registry_has_the_jax_names_and_arguments():
    assert list(metric_defaults) == list(jax_defaults)
    for name, args in metric_defaults.items():
        jargs = jax_defaults[name]
        assert args.func_name.split(".metrics.")[1] == jargs.func_name.split(".metrics.")[1]
        assert args.func_name.startswith("inclusivegan_torch.metrics.")
        assert {k: v for k, v in args.items() if k != "func_name"} == \
            {k: v for k, v in jargs.items() if k != "func_name"}


@pytest.mark.parametrize("name,item", [
    ("pr50k3", "3.1"), ("ppl_wend", "3.2"), ("ppl_zfull", "3.2"), ("ls", "3.3"),
    ("mode_counts_24k", "3.5"), ("KL24k", "3.5")])
def test_unported_metrics_are_refused_with_their_item(name, item):
    with pytest.raises(NotImplementedError, match=f"queue 1 item {item}"):
        metric_args(["fid30k", name])


def test_ported_metrics_and_unknown_names():
    assert [m.name for m in metric_args(["fid30k", "fid10k", "is50k", "dummy"])] == \
        ["fid30k", "fid10k", "is50k", "dummy"]
    with pytest.raises(ValueError, match="unknown metric"):
        metric_args(["fid50k"])
    with pytest.raises(NotImplementedError, match="feature_nets"):
        check_metric_args([dict(metric_defaults["fid30k"], feature_net="vgg")])


def test_mirror_augment_and_run_config_match_jax(tmp_path):
    imgs = np.random.RandomState(0).randint(0, 256, (16, 3, 4, 5)).astype(np.uint8)
    np.testing.assert_array_equal(
        apply_mirror_augment(imgs, np.random.default_rng(123)),
        jmisc.apply_mirror_augment(imgs, np.random.default_rng(123)))
    sc = SubmitConfig(run_func_kwargs=dict(mirror_augment=True,
                                           dataset_args=dict(tfrecord_dir="toy")))
    with open(tmp_path / "submit_config.pkl", "wb") as f:
        pickle.dump(sc, f)
    assert parse_config_for_previous_run(str(tmp_path)) == dict(
        train=sc.run_func_kwargs, dataset=dict(tfrecord_dir="toy"))


# ---------------------------------------------------------------------------
# FID and IS from identical images, GsSampler against JAX's.

class _Images:
    """A stand-in sampler: yields the same uint8 images to both packages."""

    def __init__(self, images):
        self.images = images
        self.device = torch.device("cpu")

    def random_images(self, num, seed=0):
        assert num == self.images.shape[0]
        yield self.images


@pytest.fixture(scope="module")
def shared_inception(tmp_path_factory):
    """The JAX net's seeded parameters as an npz, and one JAX InceptionV3
    that loads it, for every JAX metric of the module."""
    path = str(tmp_path_factory.mktemp("inception") / "inception.npz")
    np.savez(path, **{k: np.asarray(v) for k, v in jinc.InceptionV3(seed=0).params.items()})
    return path, jinc.InceptionV3(path)


@pytest.fixture
def jax_inception(shared_inception, monkeypatch):
    """JAX's metrics construct InceptionV3 inside ``_evaluate``: hand them
    the module's net."""
    path, net = shared_inception
    monkeypatch.setattr(jinc, "InceptionV3", lambda *a, **k: net)
    return path


def _fakes():
    return np.random.RandomState(8).randint(0, 256, (N_IMAGES, 3, RES, RES)).astype(np.uint8)


def test_fid_matches_jax_from_identical_images(jax_inception, toy_dataset, tmp_path,  # noqa: F811
                                               monkeypatch):
    data_dir, name = os.path.dirname(toy_dataset), os.path.basename(toy_dataset)
    dataset_args = dict(tfrecord_dir=name, max_label_size="full")
    out = {}
    for pkg, cls in (("jax", jfid.FID), ("port", tfid.FID)):
        monkeypatch.setenv("INCLUSIVEGAN_CACHE", str(tmp_path / pkg))
        m = cls("fid4", num_images=N_IMAGES, minibatch_per_gpu=BATCH,
                feature_net_weights=jax_inception)
        m._mirror_augment = True
        m._mirror_rng = np.random.default_rng(123)
        m._evaluate(_Images(_fakes()), dataset_args=dataset_args, data_dir=data_dir)
        out[pkg] = m._results
        assert len(os.listdir(tmp_path / pkg)) == 1  # the reals' statistics, cached
    (value, suffix, _), (jvalue, jsuffix, _) = out["port"][0], out["jax"][0]
    assert len(out["port"]) == len(out["jax"]) == 1 and suffix == jsuffix == ""
    assert value > 0
    np.testing.assert_allclose(value, jvalue, rtol=METRIC_RTOL)


def test_is_matches_jax_from_identical_images(jax_inception):
    out = {}
    for pkg, cls in (("jax", jis.IS), ("port", tis.IS)):
        m = cls("is4", num_images=N_IMAGES, num_splits=2, minibatch_per_gpu=BATCH,
                classifier_weights=jax_inception)
        m._evaluate(_Images(_fakes()), dataset_args={}, data_dir=None)
        out[pkg] = m._results
    assert [r[1] for r in out["port"]] == [r[1] for r in out["jax"]] == ["_mean", "_std"]
    for (value, _, _), (jvalue, _, _) in zip(out["port"], out["jax"]):
        np.testing.assert_allclose(value, jvalue, rtol=METRIC_RTOL, atol=1e-7)


def test_frechet_distance_of_a_set_with_itself_is_zero():
    f = np.random.RandomState(0).randn(300, 64)
    mu, sigma = f.mean(0), np.cov(f, rowvar=False)
    assert abs(tfid.frechet_distance(mu, sigma, mu, sigma)) <= 1e-6 * np.trace(sigma)


@pytest.fixture(scope="module")
def snapshot_16px(tmp_path_factory):
    """A 16 px network_snapshot.v1 pickle of the narrow nets, as both
    packages read it."""
    _, _, gp, dp, gc, dc = narrow_nets()
    path = str(tmp_path_factory.mktemp("snap") / "network-snapshot-000000.pkl")
    with open(path, "wb") as f:
        pickle.dump({"format": "inclusivegan_tpu.network_snapshot.v1",
                     "G": {"config": gc, "params": gp}, "D": {"config": dc, "params": dp},
                     "Gs": {"config": gc, "params": gp}}, f)
    return path


def test_gs_sampler_matches_jax_with_its_noise(snapshot_16px):
    """The same latents (one PCG64 stream from seed 0) and, per batch, the
    JAX sampler's synthesis noise: images within 1 uint8 level."""
    num, bs, seed = 5, 2, 1000
    jsampler = jmb.GsSampler(snapshot_16px, minibatch_size=bs, seed=seed)
    noise, key = [], jax.random.key(seed)
    for _ in range(-(-num // bs)):
        key, k = jax.random.split(key)
        _, krng = jax.random.split(k)
        noise.append({n: torch.from_numpy(v)
                      for n, v in jax_draws.synthesis_noise(jsampler.G, krng, bs).items()})
    draws = iter(noise)
    sampler = tmb.GsSampler(snapshot_16px, minibatch_size=bs, seed=seed, device="cpu",
                            noise_fn=lambda n: next(draws))
    want = np.concatenate(list(jsampler.random_images(num)))
    got = np.concatenate(list(sampler.random_images(num)))
    assert got.shape == want.shape == (num, 3, RES, RES) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert got.std() > 1


def test_run_metrics_cli_on_a_16px_snapshot(snapshot_16px, toy_dataset, tmp_path,  # noqa: F811
                                            monkeypatch):
    """``python -m inclusivegan_torch.run_metrics`` with dummy and FID (the
    registry's fid10k cut to 16 images) on the CPU: a run dir with one line
    per metric, FID finite and tagged _random_features."""
    monkeypatch.setenv("INCLUSIVEGAN_CACHE", str(tmp_path / "cache"))
    monkeypatch.setitem(metric_defaults, "fid10k",
                        EasyDict(metric_defaults["fid10k"], num_images=16))
    results = run_metrics.main([
        "--network", snapshot_16px, "--metrics", "dummy,fid10k",
        "--data-dir", os.path.dirname(toy_dataset), "--dataset",
        os.path.basename(toy_dataset), "--mirror-augment", "true",
        "--result-dir", str(tmp_path / "results"), "--device", "cpu"])
    assert results["dummy"] == 0.0 and np.isfinite(results["fid10k"])
    assert results["fid10k"] > 0 and results["fid10k_random_features"] == 1.0
    (run_dir,) = [os.path.join(tmp_path / "results", d)
                  for d in os.listdir(tmp_path / "results")]
    assert run_dir.endswith("-run_metrics")
    fid_lines = open(os.path.join(run_dir, "metric-fid10k.txt")).read().splitlines()
    assert len(fid_lines) == 1 and "fid10k_random_features 1" in fid_lines[0]
    assert "network-snapshot-000000" in fid_lines[0]
    assert len(open(os.path.join(run_dir, "metric-dummy.txt")).read().splitlines()) == 1
    log = open(os.path.join(run_dir, "log.txt")).read()
    assert "fid10k: Gs 16 images" in log and "fid10k: InceptionV3 16 images" in log


def test_run_metrics_cli_refuses_before_loading(tmp_path):
    with pytest.raises(NotImplementedError, match="queue 1 item 3.1"):
        run_metrics.main(["--network", "missing.pkl", "--metrics", "fid10k,pr50k3",
                          "--data-dir", str(tmp_path), "--dataset", "x",
                          "--result-dir", str(tmp_path / "results")])
    assert not (tmp_path / "results").exists()


def test_loop_runs_metrics_at_each_network_snapshot(toy_dataset, tmp_path):  # noqa: F811
    """The loop runs every metric on each network snapshot it writes; one
    that fails is printed and training goes on."""
    from inclusivegan_torch.utils.run_harness import submit_run
    broken = dict(name="broken", func_name="inclusivegan_torch.metrics.metric_base."
                                           "MetricBase")
    root = str(tmp_path / "results")
    state = submit_run(SubmitConfig(run_dir_root=root, run_desc="metrics"), LOOP,
                       **_args(toy_dataset, metric_arg_list=[metric_defaults["dummy"],
                                                             broken],
                               total_kimg=0.032, network_snapshot_ticks=1,
                               image_snapshot_ticks=100, prefetch_depth=0,
                               save_full_checkpoints=False, seed=3, device="cpu",
                               sched_args=dict(minibatch_size_base=8,
                                               minibatch_gpu_base=8,
                                               tick_kimg_base=0.016)))
    run_dir = os.path.join(root, "00000-metrics")
    # two ticks, two network snapshots; at this scale both are named for 0 kimg
    lines = open(os.path.join(run_dir, "metric-dummy.txt")).read().splitlines()
    assert len(lines) == 2 and int(state.step) == 4
    assert all(line.startswith("network-snapshot-000000 ") for line in lines)
    assert open(os.path.join(run_dir, "log.txt")).read().count("metric broken failed") == 2
