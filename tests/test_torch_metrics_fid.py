"""FID of the port against the JAX package's from identical images, on the
CPU (moved out of test_torch_metrics.py, whose fixtures and tolerance it
uses, so that ``--dist loadfile`` runs it on a worker of its own): the fakes
of a stand-in sampler and the mirror-augmented reals of one 16 px TFRecord
set, the same InceptionV3 parameters, results within relative 1e-4."""

import os

import numpy as np

from inclusivegan_torch.metrics import frechet_inception_distance as tfid
from inclusivegan_tpu.metrics import frechet_inception_distance as jfid
from test_torch_metrics import (BATCH, METRIC_RTOL, N_IMAGES, _fakes, _Images,  # noqa: F401
                                jax_inception, shared_inception)
from test_torch_training_loop import toy_dataset  # noqa: F401


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
