"""The rest of the port's evaluation (inclusivegan_torch.models.feature_nets
and the metrics pr50k3, ppl_*, ls, mode_counts_24k, KL24k, FID's "vgg")
against the JAX package's, on the CPU, from the same numpy inputs and the
same parameters carried across (``*_params_from_numpy``, or one npz that both
packages load).

Tolerances, each with its reason: the feature nets' outputs within rtol
1e-4 (float32 convolutions of torch and XLA sum in other orders);
precision and recall within 1/n (a point on a ball's edge may fall either
way); PPL's per-pair lengths within rtol 2e-2 and the filtered mean within
1e-2 (1/epsilon^2 = 1e8 turns the float32 rounding of each end's image,
about 1e-7 of a value, into 1e-3 of a length: 2.6-5.2e-3 measured); LS
within the SVM checks stated at each test; mode counts and KL from
identical images exactly.
"""

import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import inclusivegan_tpu.models.feature_nets as jfn
import inclusivegan_tpu.models.lpips as jlpips
from inclusivegan_torch.metrics import KL as tkl
from inclusivegan_torch.metrics import frechet_inception_distance as tfid
from inclusivegan_torch.metrics import linear_separability as tls
from inclusivegan_torch.metrics import metric_base as tmb
from inclusivegan_torch.metrics import mode_counts as tmc
from inclusivegan_torch.metrics import perceptual_path_length as tppl
from inclusivegan_torch.metrics import precision_recall as tpr
from inclusivegan_torch.metrics.linear_svm import fit_linear_svc, predict
from inclusivegan_torch.models import feature_nets as tfn
from inclusivegan_tpu.data.dataset_tool import TFRecordExporter
from inclusivegan_tpu.metrics import KL as jkl
from inclusivegan_tpu.metrics import frechet_inception_distance as jfid
from inclusivegan_tpu.metrics import linear_separability as jls
from inclusivegan_tpu.metrics import metric_base as jmb
from inclusivegan_tpu.metrics import mode_counts as jmc
from inclusivegan_tpu.metrics import perceptual_path_length as jppl
from inclusivegan_tpu.metrics import precision_recall as jpr
from torch_golden import jax_draws
from torch_golden.narrow_nets import RES, narrow_nets

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST_NPZ = os.path.join(ROOT, "metrics_weights", "stacked_mnist_classifier.npz")
ATTR_NPZ = os.path.join(ROOT, "metrics_weights", "celeba_attr_classifier.npz")
RTOL = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _images(n, res=RES, seed=0, channels=3):
    return np.random.RandomState(seed).randint(0, 256, (n, channels, res, res)).astype(np.uint8)


def write_lpips_npz(path, seed):
    """The JAX package's random-feature LPIPS parameters in the converted
    weights' npz layout, which both packages load."""
    tree = _np_tree(jlpips.init_lpips_params(seed=seed))
    flat = {}
    for name, _c, _p in jlpips._VGG_LAYOUT:
        flat[f"{name}_w"], flat[f"{name}_b"] = tree[name]["w"], tree[name]["b"]
    for tap in jlpips._TAPS:
        flat[f"lin_{tap}"] = tree[f"lin_{tap}"]
    np.savez(path, **flat)
    return path


@pytest.fixture(scope="module")
def lpips_npz(tmp_path_factory):
    return write_lpips_npz(str(tmp_path_factory.mktemp("lpips") / "vgg.npz"), seed=5)


@pytest.fixture(scope="module")
def snapshot_16px(tmp_path_factory):
    _, _, gp, dp, gc, dc = narrow_nets()
    path = str(tmp_path_factory.mktemp("snap") / "network-snapshot-000000.pkl")
    with open(path, "wb") as f:
        pickle.dump({"format": "inclusivegan_tpu.network_snapshot.v1",
                     "G": {"config": gc, "params": gp}, "D": {"config": dc, "params": dp},
                     "Gs": {"config": gc, "params": gp}}, f)
    return path


@pytest.fixture(scope="module")
def reals_16px(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("data") / "reals")
    with TFRecordExporter(d, 40, print_progress=False) as tfr:
        for img in _images(40, seed=11):
            tfr.add_image(img)
    return d


class _Images:
    """A stand-in sampler: yields the same uint8 images to both packages."""

    def __init__(self, images):
        self.images = images
        self.device = torch.device("cpu")

    def random_images(self, num, seed=0):
        assert num == self.images.shape[0]
        yield self.images


# ---------------------------------------------------------------------------
# feature nets

def test_vgg_feature_net_matches_jax():
    jnet = jfn.VGGFeatureNet(seed=4)
    net = tfn.VGGFeatureNet(params=_np_tree(jnet.params), mode=jnet.mode, device="cpu")
    imgs = _images(3, res=32).astype(np.float32)
    got, want = net(imgs), jnet(imgs)
    assert got.shape == want.shape == (3, tfn.VGGFeatureNet.feature_dim)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6 * np.abs(want).max())
    assert net.checksum() == jnet.checksum()
    assert tfn.VGGFeatureNet(device="cpu").mode == "random-features"


def test_vgg_feature_net_loads_the_converted_npz(lpips_npz):
    jnet, net = jfn.VGGFeatureNet(lpips_npz), tfn.VGGFeatureNet(lpips_npz, device="cpu")
    assert net.mode == jnet.mode == "pretrained" and net.checksum() == jnet.checksum()
    imgs = _images(2, res=32, seed=1)
    np.testing.assert_allclose(net(imgs), jnet(imgs.astype(np.float32)), rtol=RTOL,
                               atol=1e-6)


@pytest.mark.parametrize("weights", ["seeded", "npz"])
def test_stacked_mnist_classifier_matches_jax(weights):
    if weights == "seeded":
        jclf = jfn.StackedMNISTClassifier(weights_path="missing.npz", seed=2)
        clf = tfn.StackedMNISTClassifier(params=_np_tree(jclf.params), mode=jclf.mode,
                                         device="cpu")
    else:
        jclf = jfn.StackedMNISTClassifier(MNIST_NPZ)
        clf = tfn.StackedMNISTClassifier(MNIST_NPZ, device="cpu")
    assert clf.mode == jclf.mode
    imgs = _images(16, res=32, seed=3)
    x = imgs.reshape(48, 1, 32, 32).astype(np.float32) / 255.0
    want = np.asarray(jfn.mnist_classifier_logits(jclf.params, jnp.asarray(x)))
    got = tfn.mnist_classifier_logits(clf.params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(clf.modes(imgs), jclf.modes(imgs))


def test_classifiers_default_paths_and_environment(monkeypatch, tmp_path):
    monkeypatch.chdir(ROOT)
    assert tfn.StackedMNISTClassifier(device="cpu").mode == "pretrained"
    assert tfn.CelebAAttrClassifier(device="cpu").mode == "pretrained"
    monkeypatch.setenv("INCLUSIVEGAN_TPU_MNIST_CLASSIFIER", str(tmp_path / "none.npz"))
    monkeypatch.setenv("INCLUSIVEGAN_TPU_ATTR_CLASSIFIER", str(tmp_path / "none.npz"))
    for cls, jcls in ((tfn.StackedMNISTClassifier, jfn.StackedMNISTClassifier),
                      (tfn.CelebAAttrClassifier, jfn.CelebAAttrClassifier)):
        assert cls(device="cpu").mode == jcls().mode != "pretrained"


@pytest.mark.parametrize("size", [16, 17, 20])
def test_same_pads_match_xla(size):
    assert tfn.same_pads(size, 3, 2) == tuple(lax.padtype_to_pads((size,), (3,), (2,),
                                                                  "SAME")[0])


@pytest.mark.parametrize("weights,res", [("seeded", 16), ("seeded", 17), ("npz", 32)])
def test_attr_classifier_matches_jax(weights, res):
    """Stride-2 SAME convolutions at even sizes pad (0, 1), at odd (1, 1)."""
    if weights == "seeded":
        jclf = jfn.CelebAAttrClassifier(weights_path="missing.npz", seed=6)
        clf = tfn.CelebAAttrClassifier(params=_np_tree(jclf.params), mode=jclf.mode,
                                       device="cpu")
    else:
        jclf = jfn.CelebAAttrClassifier(ATTR_NPZ)
        clf = tfn.CelebAAttrClassifier(ATTR_NPZ, device="cpu")
    imgs = _images(4, res=res, seed=7)
    got, want = clf(imgs), jclf(imgs)
    assert got.shape == want.shape == (4, 40)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


# ---------------------------------------------------------------------------
# FID with the VGG features; precision and recall

def test_fid_vgg_matches_jax(reals_16px, lpips_npz, tmp_path, monkeypatch):
    data_dir, name = os.path.dirname(reals_16px), os.path.basename(reals_16px)
    out = {}
    for pkg, cls in (("jax", jfid.FID), ("port", tfid.FID)):
        monkeypatch.setenv("INCLUSIVEGAN_CACHE", str(tmp_path / pkg))
        m = cls("fid8", num_images=8, minibatch_per_gpu=4, feature_net="vgg",
                feature_net_weights=lpips_npz)
        m._mirror_augment, m._mirror_rng = False, np.random.default_rng(123)
        m._evaluate(_Images(_images(8, seed=9)), dataset_args=dict(tfrecord_dir=name),
                    data_dir=data_dir)
        out[pkg] = m._results
    assert len(out["port"]) == len(out["jax"]) == 1
    assert out["port"][0][0] > 0
    np.testing.assert_allclose(out["port"][0][0], out["jax"][0][0], rtol=RTOL)


def test_manifold_radii_and_precision_recall_match_jax():
    rs = np.random.RandomState(0)
    ref = rs.randn(300, 24).astype(np.float32)
    gen = (rs.randn(250, 24) * 1.2 + 0.3).astype(np.float32)
    jm = jpr.ManifoldEstimator(ref, 3, row_batch=64, col_batch=128)
    tm = tpr.ManifoldEstimator(ref, 3, row_batch=64, col_batch=128, device="cpu")
    np.testing.assert_allclose(tm.radii2.numpy(), jm.radii2, rtol=1e-5)
    # the k-th neighbour with the self column included: index 3 of the sorted row
    d2 = ((ref[:, None] - ref[None]) ** 2).sum(-1)
    np.testing.assert_allclose(tm.radii2.numpy(), np.sort(d2, axis=1)[:, 3], rtol=1e-4)
    got = tpr.knn_precision_recall_features(ref, gen, 3, device="cpu")
    want = jpr.knn_precision_recall_features(ref, gen, 3)
    assert 0 < want["precision"] < 1 and 0 < want["recall"] < 1
    assert abs(got["precision"] - want["precision"]) <= 1 / gen.shape[0]
    assert abs(got["recall"] - want["recall"]) <= 1 / ref.shape[0]


def test_pr_metric_matches_jax(reals_16px, monkeypatch):
    """Both metrics embed with their default random-feature VGG, the JAX
    package's seeded parameters handed to the port's."""
    monkeypatch.setattr(tfn, "random_lpips_tree",
                        lambda seed: _np_tree(jlpips.init_lpips_params(seed=seed)))
    data_dir, name = os.path.dirname(reals_16px), os.path.basename(reals_16px)
    n = 24
    out = {}
    for pkg, cls in (("jax", jpr.PR), ("port", tpr.PR)):
        m = cls("pr", num_images=n, minibatch_per_gpu=8, row_batch_size=10000,
                col_batch_size=10000)
        m._mirror_augment, m._mirror_rng = False, np.random.default_rng(123)
        m._evaluate(_Images(_images(n, seed=12)), dataset_args=dict(tfrecord_dir=name),
                    data_dir=data_dir)
        out[pkg] = {s: v for v, s, _ in m._results}
    assert list(out["port"]) == list(out["jax"]) == ["_precision", "_recall",
                                                     "_random_features"]
    for k in ("_precision", "_recall"):
        assert abs(out["port"][k] - out["jax"][k]) <= 1 / n


# ---------------------------------------------------------------------------
# PPL

@pytest.mark.parametrize("space,sampling,crop,lpips", [
    ("w", "end", True, "pixel"), ("z", "full", False, "vgg"), ("w", "full", False, "vgg")])
def test_ppl_matches_jax(space, sampling, crop, lpips, snapshot_16px, lpips_npz,
                         monkeypatch):
    num, mb = 12, 4
    weights = lpips_npz if lpips == "vgg" else None
    jsampler = jmb.GsSampler(snapshot_16px)
    recorded = []

    def percentile(a, q, **kw):
        recorded.append(np.array(a))
        return np.percentile(a, q, **kw)

    monkeypatch.setattr(jppl, "np", types.SimpleNamespace(**{**vars(np),
                                                             "percentile": percentile}))
    jm = jppl.PPL("ppl", num_samples=num, space=space, sampling=sampling, crop=crop,
                  minibatch_per_gpu=mb, lpips_weights=weights)
    jm._evaluate(jsampler, dataset_args={}, data_dir=None)
    noise = iter([jax_draws.to_torch(n) for n in jax_draws.ppl_noise(jsampler.G, num // mb)])
    tm = tppl.PPL("ppl", num_samples=num, space=space, sampling=sampling, crop=crop,
                  minibatch_per_gpu=mb, lpips_weights=weights, noise_fn=lambda: next(noise))
    tm._evaluate(tmb.GsSampler(snapshot_16px, device="cpu"), dataset_args={}, data_dir=None)
    want = recorded[0]
    assert tm.dists.shape == want.shape == (num,) and np.all(want > 0)
    np.testing.assert_allclose(tm.dists, want, rtol=2e-2)
    np.testing.assert_allclose(tm._results[0][0], jm._results[0][0], rtol=1e-2)


def test_crop_window_is_the_asymmetric_face_box():
    img = torch.arange(2 * 3 * 16 * 16, dtype=torch.float32).reshape(2, 3, 16, 16)
    got = tppl.crop_and_downsample(img, True)
    want = np.asarray(jppl.crop_and_downsample(jnp.asarray(img.numpy()), True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), img[:, :, 6:14, 4:12].numpy())
    big = torch.rand(1, 3, 1024, 1024)
    np.testing.assert_allclose(
        tppl.crop_and_downsample(big, False).numpy(),
        np.asarray(jppl.crop_and_downsample(jnp.asarray(big.numpy()), False)), rtol=1e-5)


# ---------------------------------------------------------------------------
# the SVM and LS

def _svm_data(n, d, seed, correlated):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, d).astype(np.float32)
    if correlated:
        x = (x @ rs.randn(d, d).astype(np.float32) * 0.3 + 0.1).astype(np.float32)
    y = (x @ rs.randn(d) + 0.5 * rs.randn(n) > 0.3).astype(np.int32)
    return x, y


@pytest.mark.parametrize("n,d,correlated", [(2000, 16, False), (4000, 64, True),
                                            (3000, 512, False)])
def test_svm_agrees_with_sklearn_linear_svc(n, d, correlated):
    """Predictions of the port's solver (float32 and float64) against
    ``LinearSVC(C=0.1, dual="auto")`` on at least 99.9% of the points."""
    from sklearn import svm
    x, y = _svm_data(n, d, n + d, correlated)
    want = svm.LinearSVC(C=0.1, dual="auto").fit(x, y).predict(x)
    for dtype in (torch.float32, torch.float64):
        xt = torch.from_numpy(x).to(dtype)
        w, steps = fit_linear_svc(xt, torch.from_numpy(y))
        assert steps < 100
        assert np.mean(predict(w, xt).numpy() == want) >= 0.999


def test_ls_matches_jax_with_sklearn(snapshot_16px):
    """Both LS metrics on the same Gs images (the JAX sampler's noise handed
    to the port's) and the same classifier npz: the scores of both spaces
    within 2% (the SVMs may split a point or two of 64 otherwise)."""
    num, keep = 256, 64
    jsampler = jmb.GsSampler(snapshot_16px)
    noise = iter([jax_draws.to_torch(n) for n in
                  jax_draws.sampler_noise(jsampler.G, 1000, num // 32, 32)])
    sampler = tmb.GsSampler(snapshot_16px, device="cpu", noise_fn=lambda bs: next(noise))
    out = {}
    for pkg, cls, s in (("jax", jls.LS, jsampler), ("port", tls.LS, sampler)):
        m = cls("ls", num_samples=num, num_keep=keep, attrib_indices=range(6),
                classifier_weights=ATTR_NPZ)
        m._evaluate(s, dataset_args={}, data_dir=None)
        out[pkg] = {suf: v for v, suf, _ in m._results}
    assert list(out["port"]) == list(out["jax"]) == ["_z", "_w"]
    for k in ("_z", "_w"):
        assert out["port"][k] >= 1
        np.testing.assert_allclose(out["port"][k], out["jax"][k], rtol=2e-2)


def test_conditional_entropy_and_degenerate_attribute(snapshot_16px):
    rs = np.random.RandomState(1)
    y, p = rs.randint(0, 2, 200), rs.randint(0, 2, 200)
    assert tls.conditional_entropy(y, p) == jls.conditional_entropy(y, p)
    assert tls.CELEBA_ATTRS == jls.CELEBA_ATTRS

    class Sampler:  # what LS reads of a sampler
        device = torch.device("cpu")
        G = tmb.load_snapshot(snapshot_16px, device="cpu")

        @staticmethod
        def run(z):
            return np.zeros((z.shape[0], 3, RES, RES), np.uint8)

    # a scorer that puts every sample on one side of every attribute: a
    # constant predicts it, each adds 0 bits, the score is 2**0
    m = tls.LS("ls", num_samples=64, num_keep=32, attrib_indices=range(2),
               attribute_classifier=lambda imgs: np.full((imgs.shape[0], 40), 0.9, np.float32))
    m._evaluate(Sampler(), dataset_args={}, data_dir=None)
    assert [(v, s) for v, s, _ in m._results] == [(1.0, "_z"), (1.0, "_w")]


# ---------------------------------------------------------------------------
# mode_counts and KL

@pytest.mark.parametrize("cls,jcls", [(tmc.ModeCounts, jmc.ModeCounts), (tkl.KL, jkl.KL)])
def test_mode_counts_and_kl_match_jax(cls, jcls):
    imgs = _images(96, res=32, seed=13)
    out = {}
    for pkg, c in (("jax", jcls), ("port", cls)):
        m = c("m", num_images=96, classifier_weights=MNIST_NPZ)
        m._evaluate(_Images(imgs), dataset_args={}, data_dir=None)
        out[pkg] = [(s, v) for v, s, _ in m._results]
    assert [s for s, _ in out["port"]] == [s for s, _ in out["jax"]]
    for (_, v), (_, jv) in zip(out["port"], out["jax"]):
        np.testing.assert_allclose(v, jv, rtol=1e-12)
    modes = np.random.RandomState(0).randint(0, 1000, 500)
    assert tkl.kl_to_uniform(modes) == jkl.kl_to_uniform(modes)
    assert tmc.count_modes(modes) == jmc.count_modes(modes)
