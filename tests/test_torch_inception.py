"""The port's InceptionV3 (inclusivegan_torch.models.inception) against the
JAX package's, on the CPU, float32.

One JAX InceptionV3 for the module (its CPU compile is the cost), seeded as
the metrics seed it; its parameters carried across with
``inception_params_from_numpy``. Tolerances: pool_3 features and softmax
probabilities of 2 images at 128 px within relative L2 1e-5 (94 convolutions
summed in another order); the bilinear resize to 299 alone, enlarging from
128 and shrinking (antialiased) from 512, within 1e-5 relative + 1e-4
absolute on [0, 255] values (float32 weights normalized in another order);
the checksum equal.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inclusivegan_torch.models import inception as ti
from inclusivegan_tpu.models.inception import InceptionV3 as JInceptionV3

FEAT_REL_L2 = 1e-5
RESIZE_TOL = dict(rtol=1e-5, atol=1e-4)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def nets():
    jnet = JInceptionV3(seed=0)
    tree = {k: np.asarray(v) for k, v in jnet.params.items()}
    return jnet, ti.InceptionV3(params=tree, mode=jnet.mode, device="cpu"), tree


def test_carried_params_match_jax_at_128px(nets):
    jnet, tnet, _ = nets
    imgs = np.random.RandomState(0).randint(0, 256, (2, 3, 128, 128)).astype(np.float32)
    jf = jnet(imgs)
    tf = tnet(imgs)
    assert tf.shape == (2, 2048) and tf.dtype == np.float32
    assert rel_l2(tf, jf) <= FEAT_REL_L2
    jp = jnet.softmax_probs(imgs)
    tp = tnet.softmax_probs(imgs)
    assert tp.shape == (2, 1008)
    assert rel_l2(tp, jp) <= FEAT_REL_L2
    np.testing.assert_allclose(tp.sum(1), 1.0, rtol=1e-5)


def test_checksum_and_mode_carry_across(nets):
    jnet, tnet, _ = nets
    assert tnet.checksum() == jnet.checksum()
    assert tnet.mode == jnet.mode == "random-features"


@pytest.mark.parametrize("size", [128, 512])
def test_resize_matches_jax_image_resize(size):
    """Half-pixel bilinear, enlarging (128) and antialiased shrinking (512)."""
    x = np.random.RandomState(size).uniform(0, 255, (2, 3, size, size)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3, 299, 299), "bilinear"))
    got = ti.resize_bilinear(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **RESIZE_TOL)


def test_non_square_and_gray_inputs_resize_to_299():
    x = torch.from_numpy(np.random.RandomState(5).uniform(0, 255, (1, 3, 64, 320))
                         .astype(np.float32))
    assert ti.resize_bilinear(x).shape == (1, 3, 299, 299)
    net = ti.InceptionV3(seed=1, device="cpu")
    gray = np.random.RandomState(6).randint(0, 256, (1, 1, 32, 32)).astype(np.float32)
    np.testing.assert_allclose(net(gray), net(np.repeat(gray, 3, axis=1)), rtol=1e-6)


def test_seeded_init_follows_the_jax_distributions(nets):
    """The port's own seeded init: the same names and shapes as JAX's, each
    conv weight N(0, 2 / fan_in), BN neutral, the head N(0, 0.02^2); another
    stream, so another checksum; the same values on every call."""
    _, _, jtree = nets
    tree = ti.random_numpy_params(seed=0)
    assert {k: v.shape for k, v in tree.items()} == {k: v.shape for k, v in jtree.items()}
    for name, cin, _cout, (kh, kw), _s, _p in ti.conv_table():
        w = tree[f"{name}.w"]
        assert abs(w.std() / math.sqrt(2.0 / (kh * kw * cin)) - 1) < 0.1, name
        assert not tree[f"{name}.beta"].any() and not tree[f"{name}.mean"].any()
        assert (tree[f"{name}.var"] == 1).all()
    assert abs(tree["logits.w"].std() / 0.02 - 1) < 0.01
    assert len(ti.conv_table()) == 94
    net = ti.InceptionV3(seed=0, device="cpu")
    assert net.mode == "random-features"
    assert net.checksum() == ti.checksum(tree) != ti.checksum(jtree)
    assert ti.checksum(ti.random_numpy_params(seed=0)) == net.checksum()


def test_npz_weights_load_in_both(nets, tmp_path):
    """The npz layout (``<path>.w`` as [kh, kw, Cin, Cout]) loads into both
    packages as "pretrained", with one checksum."""
    jnet, tnet, tree = nets
    path = str(tmp_path / "inception.npz")
    np.savez(path, **tree)
    t2 = ti.InceptionV3(path, device="cpu")
    j2 = JInceptionV3(path)
    assert t2.mode == j2.mode == "pretrained"
    assert t2.checksum() == j2.checksum() == jnet.checksum()
    for k, v in tnet.params.items():
        assert torch.equal(t2.params[k], v), k
