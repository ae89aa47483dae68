"""The port's metric framework, FID, IS and run_metrics CLI
(inclusivegan_torch.metrics, inclusivegan_torch.run_metrics) against the JAX
package's, on the CPU. FID, the CLI and the loop's metrics have files of
their own (test_torch_metrics_fid.py, _cli.py, _loop.py), which share this
module's fixtures.

FID and IS: both packages' metric classes evaluate the same uint8 images,
fakes from a stand-in sampler and reals from one 16 px TFRecord set
(mirror-augmented), with the same InceptionV3 parameters (the JAX net's
seeded ones, written as an npz that both load); one JAX InceptionV3 serves
every JAX metric here, so that its CPU compile happens once. Results within
relative 1e-4 (IS's standard deviation over two near-equal splits, near 0,
within 1e-4 relative + 1e-7 absolute). ``GsSampler``: the same snapshot, latents from the same seed
and the JAX sampler's noise draws handed to the port; images within 1 uint8
level. Registry: the same names and arguments, every metric built in both
packages; the CLI's weights routed as the JAX CLI routes them.
"""

import pickle

import jax
import numpy as np
import pytest
import torch

import inclusivegan_tpu.models.inception as jinc
from inclusivegan_torch.metrics import frechet_inception_distance as tfid
from inclusivegan_torch.metrics import inception_score as tis
from inclusivegan_torch.metrics import metric_base as tmb
from inclusivegan_torch.metrics.metric_defaults import (check_metric_args, metric_args,
                                                        metric_defaults)
from inclusivegan_torch.utils.misc import (apply_mirror_augment,
                                           parse_config_for_previous_run)
from inclusivegan_torch.utils.run_harness import SubmitConfig
from inclusivegan_tpu.metrics import inception_score as jis
from inclusivegan_tpu.metrics import metric_base as jmb
from inclusivegan_tpu.metrics.metric_defaults import metric_defaults as jax_defaults
from inclusivegan_tpu.utils import misc as jmisc
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


@pytest.mark.parametrize("name", list(jax_defaults))
def test_every_registry_name_builds_in_both_packages(name):
    """Every metric of the registry builds in both packages from the same
    arguments; nothing is refused any longer."""
    args = dict(metric_defaults[name])
    jargs = dict(jax_defaults[name])
    assert {k: v for k, v in args.items() if k != "func_name"} == \
        {k: v for k, v in jargs.items() if k != "func_name"}
    metric, jmetric = tmb.make_metric(**args), jmb.make_metric(**jargs)
    assert type(metric).__name__ == type(jmetric).__name__
    assert type(metric).__module__.startswith("inclusivegan_torch.metrics.")
    assert metric.name == jmetric.name == name


def test_ported_metrics_and_unknown_names():
    names = list(metric_defaults)
    assert [m.name for m in metric_args(names)] == names
    with pytest.raises(ValueError, match="unknown metric"):
        metric_args(["fid50k"])
    check_metric_args([dict(metric_defaults["fid30k"], feature_net="vgg")])
    with pytest.raises(AssertionError):
        check_metric_args([dict(metric_defaults["ppl_wend"], space="x")])


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
