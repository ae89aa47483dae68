"""The port's PRD (``inclusivegan_torch/prd``) against the JAX package's
(``inclusivegan_tpu/prd``, whose k-means is scikit-learn's), and two small
port modules: ``pretrained_networks`` and ``parse_profile``.

``compute_prd`` and the F-beta pair are the same float64 numpy, so they are
held exactly. The port's own k-means must find scikit-learn's partition of
20 well-separated Gaussian blobs (the bins equal up to a permutation of
the clusters), and the PRD curves of such blobs then agree to 1e-12.
"""

import json
import os

import numpy as np
import pytest
import torch

import inclusivegan_tpu.prd.prd_from_image_folders as jfolders
import inclusivegan_tpu.prd.prd_score as jprd
from inclusivegan_torch import parse_profile, pretrained_networks
from inclusivegan_torch.prd import prd_from_image_folders as tfolders
from inclusivegan_torch.prd import prd_score as tprd
from inclusivegan_torch.utils.misc import read_png, write_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed", range(3))
def test_compute_prd_and_f_beta_are_the_jax_packages(seed):
    rnd = np.random.RandomState(seed)
    p, q = rnd.dirichlet(np.ones(20)), rnd.dirichlet(np.ones(20) * 0.3)
    jp, jr = jprd.compute_prd(p, q, num_angles=101)
    tp, tr = tprd.compute_prd(p, q, num_angles=101)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tr, jr)
    for beta in (8, 2):
        assert tprd.prd_to_max_f_beta_pair(tp, tr, beta) == jprd.prd_to_max_f_beta_pair(
            jp, jr, beta)
    with pytest.raises(ValueError):
        tprd.compute_prd(p, q, num_angles=2)


def _blobs(seed=0, k=20, dim=8, n=300):
    """Two samples of k well-separated blobs (centers drawn with spread 50,
    blobs of spread 1), with other weights per sample, drawn from
    Dirichlet(5) so that every blob holds points: with Dirichlet(1) weights
    at seed 3, scikit-learn's MiniBatchKMeans itself misses the partition
    in 19 of 30 runs. Its draws come from numpy's global stream, which is
    seeded here, so the reference is the same in every run."""
    np.random.seed(seed)
    rnd = np.random.RandomState(seed)
    centers = rnd.randn(k, dim) * 50
    w_eval, w_ref = rnd.dirichlet(5 * np.ones(k)), rnd.dirichlet(5 * np.ones(k))
    ev = centers[rnd.choice(k, n, p=w_eval)] + rnd.randn(n, dim)
    ref = centers[rnd.choice(k, n, p=w_ref)] + rnd.randn(n, dim)
    return ev, ref


def _pairs(bins):
    return sorted(zip(*(np.round(b, 12) for b in bins)))


def test_kmeans_bins_equal_scikit_learns_up_to_a_permutation():
    ev, ref = _blobs()
    want = jprd._cluster_into_bins(ev, ref, 20)
    got = tprd._cluster_into_bins(ev, ref, 20, torch.Generator().manual_seed(1))
    assert _pairs(got) == _pairs(want)
    labels, centers, inertia, iterations = tprd.kmeans(
        torch.from_numpy(np.vstack([ev, ref])), 20, generator=torch.Generator().manual_seed(2))
    assert centers.shape == (20, 8) and len(set(labels.tolist())) == 20
    assert inertia < 2 * 600 * 8 and iterations >= 10  # about dim per point


def test_prd_from_embedding_equals_the_jax_packages_on_blobs():
    ev, ref = _blobs(seed=3)
    jp, jr = jprd.compute_prd_from_embedding(ev, ref, num_runs=2)
    tp, tr = tprd.compute_prd_from_embedding(ev, ref, num_runs=2)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tr, jr, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="same size"):
        tprd.compute_prd_from_embedding(ev, ref[:-1])
    tprd.compute_prd_from_embedding(ev, ref[:-1], num_runs=1, enforce_balance=False)


def test_plot_writes_a_png(tmp_path):
    ev, ref = _blobs(seed=4, k=5)
    pairs = [tprd.compute_prd_from_embedding(ev, ref, num_clusters=5, num_runs=1)] * 2
    path = str(tmp_path / "prd.png")
    tprd.plot(pairs, labels=["a", "b"], out_path=path, dpi=60)
    img = read_png(path)
    assert img.shape == (210, 210, 3) and img.dtype == np.uint8
    assert (img == 255).mean() > 0.5 and (img == 0).any()  # white canvas, black frame
    np.testing.assert_array_equal(tprd.plot(pairs, labels=["a", "b"], dpi=60), img)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("prd")
    rnd = np.random.RandomState(0)
    out = []
    for name in ("ref", "eval"):
        d = root / name
        d.mkdir()
        for i in range(6):
            write_png(str(d / f"{i:03d}.png"), rnd.randint(0, 256, (32, 32, 3)).astype(np.uint8))
        out.append(str(d))
    return out


def test_folder_loader_is_the_jax_packages(folders):
    np.testing.assert_array_equal(tfolders.load_images_from_folder(folders[0], 5),
                                  jfolders.load_images_from_folder(folders[0], 5))


def test_cli_on_the_cpu_hits_the_embedding_cache(folders, tmp_path, monkeypatch, capsys):
    from inclusivegan_torch.models import feature_nets
    calls = []
    inner = feature_nets.VGGFeatureNet.__call__
    monkeypatch.setattr(feature_nets.VGGFeatureNet, "__call__",
                        lambda self, x: calls.append(len(x)) or inner(self, x))
    argv = ["--reference_dir", folders[0], "--eval_dirs", folders[1], "--eval_labels", "e",
            "--num_images", "6", "--num_clusters", "3", "--num_runs", "2", "--device", "cpu",
            "--cache_dir", str(tmp_path / "cache"), "--plot_path", str(tmp_path / "p.png")]
    first = tfolders.main(argv)
    assert calls == [6, 6] and len(os.listdir(tmp_path / "cache")) == 2
    second = tfolders.main(argv)
    assert calls == [6, 6] and second == first
    assert all(0.0 <= v <= 1.0 for v in first[0])
    assert capsys.readouterr().out.count("F_8   F_1/8     model") == 2
    assert read_png(str(tmp_path / "p.png")).shape == (1050, 1050, 3)


def test_pretrained_networks_map_and_cache(monkeypatch):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "root_pretrained_networks", os.path.join(ROOT, "pretrained_networks.py"))
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    assert pretrained_networks.gdrive_urls == root.gdrive_urls
    monkeypatch.setattr(pretrained_networks, "_cached_networks", {})
    path = os.path.join(ROOT, "artifacts", "best_weights_fp16.pkl")
    G, D, Gs = pretrained_networks.load_networks(path, device="cpu")
    assert pretrained_networks.load_networks(path, device="cpu") == (G, D, Gs)
    assert Gs.synthesis.resolution == 32
    with pytest.raises(FileNotFoundError):
        pretrained_networks.load_networks("gdrive:celeba-30k.pkl", device="cpu")


def test_parse_profile_sums_a_hand_written_trace(tmp_path, capsys):
    """Kernels of 2 + 1 ms (bias_lrelu), 3 ms (a cuDNN convolution), a 0.5
    ms copy and a CPU op that does not count, over a 10 ms window with idle
    gaps of 2.5 and 1 ms."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "bias_lrelu_kernel<float>", "ts": 0, "dur": 2000},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_fprop_implicit_gemm", "ts": 1000,
         "dur": 3000},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 6500, "dur": 500},
        {"ph": "X", "cat": "kernel", "name": "bias_lrelu_kernel<float>", "ts": 8000,
         "dur": 1000},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 0, "dur": 9000},
        {"ph": "X", "cat": "kernel", "name": "upfirdn2d_tiled", "ts": 9500, "dur": 500},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = parse_profile.main([str(tmp_path), "--json", str(tmp_path / "s.json")])
    assert s["window_ms"] == pytest.approx(10.0) and s["busy_ms"] == pytest.approx(6.0)
    assert s["busy_share"] == pytest.approx(0.6) and s["device_ms"] == pytest.approx(7.0)
    groups = {g["name"]: (g["ms"], g["launches"]) for g in s["groups"]}
    assert groups == {"bias_lrelu kernel": (3.0, 2), "convolution": (3.0, 1),
                      "memory copy / set": (0.5, 1), "upfirdn2d kernel": (0.5, 1)}
    assert [g["ms"] for g in s["gaps"]] == pytest.approx([2.5, 1.0, 0.5])
    assert s["gaps"][0]["at_ms"] == pytest.approx(4.0)
    assert "device busy 6.000 ms of a 10.000 ms window (60.0%)" in capsys.readouterr().out
