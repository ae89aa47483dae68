"""The port's trainers of a run's inputs (``inclusivegan_torch/scripts/
train_{mnist_classifier, attr_classifier, perceptual_vgg}.py``) against the
repository's JAX scripts of the same names.

Each case runs the JAX script's ``main()`` in this process (``sys.argv`` set,
its ``init_*`` monkeypatched to return a seeded numpy tree) and the port's
``main`` on the CPU with the same tree and the same tiny dataset (32 px, 16
px for the VGG, a few minibatches, one epoch). Held against each other:

- every step's loss (the JAX ``train_step``'s third output, the port's
  ``adam_step``'s), rtol 1e-4, and the printed epoch lines;
- the saved npz: the same keys in the same order;
- the parameters after the run: relative L2 over the whole tree <=
  ``PARAM_REL_L2`` (1e-4; 0.9-3.8e-6 measured). Adam's first steps move each
  weight by about lr times the sign of its gradient, whatever the gradient's
  size, so a gradient that is float noise, or one that differs where an op
  is not differentiable (relu, abs, maximum at 0: the port's trainers take
  jnp's one half and one there), moves a weight by a whole lr step; the
  limit leaves room for a few such steps, not for a wrong gradient;
- the perceptual net's calibration scale (rtol 1e-4), its three geometry
  verdicts and its exit code (equal): the stacked case fails one check and
  exits 3 with a ``.rejected.npz``, the attrs case passes all three;
- each package's reader loads the other's npz.
"""

import importlib.util
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import inclusivegan_tpu.models.feature_nets as jfn
import inclusivegan_tpu.models.lpips as jlp
from inclusivegan_torch.data.dataset_tool import TFRecordExporter
from inclusivegan_torch.models import feature_nets as tfn
from inclusivegan_torch.models import lpips as tlp
from inclusivegan_torch.scripts import _train
from inclusivegan_torch.scripts import train_attr_classifier as p_attr
from inclusivegan_torch.scripts import train_mnist_classifier as p_mnist
from inclusivegan_torch.scripts import train_perceptual_vgg as p_vgg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-4
PARAM_REL_L2 = 1e-4
SCALE_RTOL = 1e-4
EPOCH_LINE = re.compile(r"^epoch \d+: loss ([0-9.]+) ")


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def few_threads():
    """Two torch threads: these tiny convolutions gain nothing from more,
    and in a parallel test run more threads than cores slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def steps(monkeypatch):
    """Each step's loss: JAX's from its jitted ``train_step``, the port's
    from ``adam_step``."""
    recorded = {"jax": [], "port": []}
    real_jit = jax.jit

    def jit(fun, *args, **kwargs):
        compiled = real_jit(fun, *args, **kwargs)
        if getattr(fun, "__name__", "") != "train_step":
            return compiled

        def run(*a):
            out = compiled(*a)
            recorded["jax"].append(float(out[2]))
            return out
        return run

    real_step = _train.adam_step

    def adam_step(*args, **kwargs):
        out = real_step(*args, **kwargs)
        recorded["port"].append(float(out[2]))
        return out

    monkeypatch.setattr(jax, "jit", jit)
    for mod in (p_mnist, p_attr, p_vgg):
        monkeypatch.setattr(mod, "adam_step", adam_step)
    return recorded


def _run(main, monkeypatch, capsys, argv, script=None):
    """(exit code, stdout) of a main: the JAX script's through ``sys.argv``,
    the port's with ``argv`` and ``--device cpu``."""
    capsys.readouterr()
    try:
        if script is None:
            main(argv + ["--device", "cpu"])
        else:
            monkeypatch.setattr(sys, "argv", [script] + argv)
            main()
        code = 0
    except SystemExit as e:
        code = e.code
    return code, capsys.readouterr().out


def _check_run(steps, jax_out, port_out, jax_npz, port_npz):
    assert len(steps["port"]) == len(steps["jax"]) > 0
    np.testing.assert_allclose(steps["port"], steps["jax"], rtol=LOSS_RTOL)
    jl = [float(m.group(1)) for m in map(EPOCH_LINE.match, jax_out.splitlines()) if m]
    pl = [float(m.group(1)) for m in map(EPOCH_LINE.match, port_out.splitlines()) if m]
    assert len(pl) == len(jl) > 0
    # printed to 4 decimals from losses within LOSS_RTOL: one unit apart at most
    np.testing.assert_allclose(pl, jl, rtol=0, atol=1.01e-4)
    want, got = np.load(jax_npz), np.load(port_npz)
    assert list(got.keys()) == list(want.keys())
    for k in want.keys():
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    a = np.concatenate([got[k].ravel() for k in want.keys()])
    b = np.concatenate([want[k].ravel() for k in want.keys()])
    rel = np.linalg.norm(a - b) / np.linalg.norm(b)
    assert rel <= PARAM_REL_L2, rel
    return want, got


def _mnist_dir(d, n=384):
    smm = _load_script("make_synthetic_mnist")
    rnd = np.random.RandomState(0)
    labels = rnd.randint(0, 10, size=n).astype(np.uint8)
    images = np.stack([smm.render_digit(int(v), rnd) for v in labels])
    images[images < 16] = 0  # MNIST's background is exactly 0
    os.makedirs(d)
    smm.write_idx_images(os.path.join(d, "train-images-idx3-ubyte"), images)
    smm.write_idx_labels(os.path.join(d, "train-labels-idx1-ubyte"), labels)
    return images


def test_mnist_classifier_matches_the_jax_script(tmp_path, monkeypatch, capsys, steps):
    mnist = str(tmp_path / "mnist")
    digits = _mnist_dir(mnist)
    tree = tfn.init_mnist_classifier(5)
    monkeypatch.setattr(jfn, "init_mnist_classifier", lambda *a, **k: tree)
    monkeypatch.setattr(p_mnist, "init_mnist_classifier", lambda *a, **k: tree)
    args = ["--mnist-dir", mnist, "--epochs", "1", "--batch", "64"]
    jnpz, pnpz = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jcode, jout = _run(_load_script("train_mnist_classifier").main, monkeypatch, capsys,
                       args + ["--out", jnpz], "train_mnist_classifier.py")
    pcode, pout = _run(p_mnist.main, monkeypatch, capsys, args + ["--out", pnpz])
    assert jcode == pcode == 0
    assert pout.splitlines()[-1] == f"saved {pnpz}"
    want, got = _check_run(steps, jout, pout, jnpz, pnpz)
    assert list(want.keys()) == [f"{n}_{leaf}" for n in ("conv1", "conv2", "dense1", "dense2")
                                 for leaf in ("w", "b")]

    # each reader takes the other's file
    stacked = np.stack([digits[:16], digits[16:32], digits[32:48]], axis=1)
    stacked = np.pad(stacked, [(0, 0), (0, 0), (2, 2), (2, 2)])
    for path in (jnpz, pnpz):
        j = jfn.StackedMNISTClassifier(weights_path=path)
        t = tfn.StackedMNISTClassifier(weights_path=path, device="cpu")
        assert j.mode == t.mode == "pretrained"
        np.testing.assert_array_equal(t.modes(stacked), j.modes(stacked))


def _tfrecord_set(d, images, labels):
    with TFRecordExporter(d, len(images), print_progress=False) as tfr:
        for img in images:
            tfr.add_image(img)
        tfr.add_labels(labels)


def test_attr_classifier_matches_the_jax_script(tmp_path, monkeypatch, capsys, steps):
    rnd = np.random.RandomState(1)
    n = 192
    labels = rnd.randint(0, 2, (n, 40)).astype(np.float32)
    images = rnd.randint(0, 256, (n, 3, 32, 32)).astype(np.uint8)
    _tfrecord_set(str(tmp_path / "data" / "attrs32"), images, labels)
    tree = tfn.init_attr_classifier(6)
    monkeypatch.setattr(jfn, "init_attr_classifier", lambda *a, **k: tree)
    monkeypatch.setattr(p_attr, "init_attr_classifier", lambda *a, **k: tree)
    args = ["--data-dir", str(tmp_path / "data"), "--dataset", "attrs32", "--epochs", "1",
            "--batch", "16", "--val-frac", "0.1667"]
    jnpz, pnpz = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jcode, jout = _run(_load_script("train_attr_classifier").main, monkeypatch, capsys,
                       args + ["--out", jnpz], "train_attr_classifier.py")
    pcode, pout = _run(p_attr.main, monkeypatch, capsys, args + ["--out", pnpz])
    assert jcode == pcode == 0
    assert "160 train / 32 val images, res 32" in jout.splitlines()
    assert "160 train / 32 val images, res 32" in pout.splitlines()
    assert len(steps["jax"]) == 10
    want, _ = _check_run(steps, jout, pout, jnpz, pnpz)
    assert list(want.keys())[-2:] == ["dense2_w", "dense2_b"]
    x = images[:8]
    for path in (jnpz, pnpz):
        j = jfn.CelebAAttrClassifier(weights_path=path)
        t = tfn.CelebAAttrClassifier(weights_path=path, device="cpu")
        assert j.mode == t.mode == "pretrained"
        np.testing.assert_allclose(t(x), j(x), rtol=1e-4, atol=1e-6)


def _perceptual_set(d, mode, n=64):
    """16 px images (VGG16's fifth block at 1x1) whose content follows the
    labels: stacked mode two digit triples (so that same-triple pairs
    exist), attrs mode 40 binary attributes."""
    rnd = np.random.RandomState(2)
    if mode == "stacked":
        modes = np.array([123, 456])[np.arange(n) % 2]
        labels = np.zeros((n, 1000), np.float32)
        labels[np.arange(n), modes] = 1.0
        base = rnd.randint(0, 256, (2, 3, 16, 16))
        images = base[np.arange(n) % 2] * 0.7 + rnd.randint(0, 77, (n, 3, 16, 16))
    else:
        labels = rnd.randint(0, 2, (n, 40)).astype(np.float32)
        images = rnd.randint(0, 256, (n, 3, 16, 16)) * 0.5 + 120 * labels[:, :3, None, None]
    _tfrecord_set(d, images.astype(np.uint8), labels)
    return images.astype(np.uint8)


def _geometry(out):
    line = [l for l in out.splitlines() if l.startswith("geometry:")]
    assert len(line) == 1, out
    return re.findall(r": (True|False)", line[0])


@pytest.mark.parametrize("mode", ["stacked", "attrs"])
def test_perceptual_vgg_matches_the_jax_script(mode, tmp_path, monkeypatch, capsys, steps):
    images = _perceptual_set(str(tmp_path / "data" / "set16"), mode)
    tree = tlp.random_lpips_tree(3)
    monkeypatch.setattr(jlp, "init_lpips_params", lambda *a, **k: dict(tree))
    monkeypatch.setattr(p_vgg, "random_lpips_tree", lambda *a, **k: dict(tree))
    args = ["--data-dir", str(tmp_path / "data"), "--dataset", "set16", "--epochs", "1",
            "--batch", "16", "--label-mode", "auto"]
    jnpz, pnpz = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jcode, jout = _run(_load_script("train_perceptual_vgg").main, monkeypatch, capsys,
                       args + ["--out", jnpz], "train_perceptual_vgg.py")
    pcode, pout = _run(p_vgg.main, monkeypatch, capsys, args + ["--out", pnpz])
    assert jcode == pcode == (3 if mode == "stacked" else 0)  # both paths of the verdict
    assert _geometry(pout) == _geometry(jout)
    if jcode == 3:
        jnpz, pnpz = (p[:-4] + ".rejected.npz" for p in (jnpz, pnpz))
    assert pout.splitlines()[-1] == f"saved {pnpz}"
    assert "dataset set16: 64 images, 16 held out" in pout.splitlines()
    want, got = _check_run(steps, jout, pout, jnpz, pnpz)
    assert len(steps["jax"]) == 3
    assert (("similar-attr pair hamming" in jout) == ("similar-attr pair hamming" in pout)
            == (mode == "attrs"))
    scale = {k: np.asarray(f["lin_conv1_2"], np.float64) * 64 for k, f in
             (("jax", want), ("port", got))}
    np.testing.assert_allclose(scale["port"], scale["jax"], rtol=SCALE_RTOL)
    for tap in tlp._TAPS:
        np.testing.assert_allclose(got[f"lin_{tap}"], want[f"lin_{tap}"], rtol=SCALE_RTOL)

    # each loader reads the other's file in mode 1; on the port's file the
    # two give the same distances
    for path in (jnpz, pnpz):
        jp = jlp.load_lpips_params(path)
        tp = tlp.load_lpips_params(path, device="cpu")
        assert int(jp["_mode"]) == tp["_mode"] == 1
        assert sorted(k for k in jp if k != "_mode") == sorted(k for k in tp if k != "_mode")
        np.testing.assert_array_equal(tp["conv5_3"]["w"].permute(2, 3, 1, 0).numpy(),
                                      np.asarray(jp["conv5_3"]["w"]))
    x0, x1 = images[:4], images[4:8]
    want_d = np.asarray(jlp.lpips_distance(jp, jnp.asarray(x0), jnp.asarray(x1)))
    got_d = tlp.lpips_distance(tp, torch.from_numpy(x0), torch.from_numpy(x1)).numpy()
    np.testing.assert_allclose(got_d, want_d, rtol=1e-4)


def test_trainers_refuse_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for mod, argv in ((p_mnist, ["--mnist-dir", str(tmp_path)]),
                      (p_attr, ["--data-dir", str(tmp_path), "--dataset", "x"]),
                      (p_vgg, ["--data-dir", str(tmp_path), "--dataset", "x"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main(argv + ["--out", str(tmp_path / "out.npz")])
