"""The port's reference-pickle converter (``inclusivegan_torch/scripts/
convert_reference_pkl.py``) against the repository's
``scripts/convert_reference_pkl.py``.

A (G, D, Gs) triple of the JAX package is dumped in the reference's
TF-variable naming, as ``tests/test_converters.py`` dumps it (what
``scripts/dump_reference_vars.py`` writes in a TF1 environment), and
converted by both scripts. The pickles hold the same format string, the
same config dicts key for key (the JAX script stores its compute dtype as
the ``jax.numpy`` type, the port its name, as the port's snapshot writer
does, so that the pickle loads without JAX) and bit-equal trees. The port's
loaders then run G, D and Gs on the CPU within ``tests/test_torch_stylegan2.py``'s
1e-4 of the JAX networks, and the JAX package's loader reads the port's
pickle.
"""

import dataclasses
import importlib.util
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inclusivegan_torch import pretrained_networks
from inclusivegan_torch.scripts import convert_reference_pkl as port_conv
from inclusivegan_tpu.models import Discriminator, GMain
from inclusivegan_tpu.training.training_loop import load_snapshot as jax_load_snapshot

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4  # tests/test_torch_stylegan2.py


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "convert_reference_pkl", os.path.join(ROOT, "scripts", "convert_reference_pkl.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _dump(path, G, D, seed):
    """The reference variables of a fresh triple, Gs offset from G."""
    kg, kgs, kd = jax.random.split(jax.random.key(seed), 3)
    params = {"G": G.init(kg),
              "Gs": jax.tree_util.tree_map(lambda x: x + 0.01, G.init(kgs)),
              "D": D.init(kd)}
    dump = {}
    for net in ("G", "Gs"):
        p = params[net]
        dump.update(_flatten(p["mapping"], f"{net}/G_mapping"))
        dump.update(_flatten(p["synthesis"], f"{net}/G_synthesis"))
        dump.update(_flatten(p["noise"], f"{net}/G_synthesis"))
        dump[f"{net}/dlatent_avg"] = np.asarray(p["dlatent_avg"])
    dump.update(_flatten(params["D"], "D"))
    np.savez(path, **dump)
    return params


def _dtype_names(config):
    """The JAX config with each compute dtype as its name."""
    return {k: (_dtype_names(v) if isinstance(v, dict)
                else np.dtype(v).name if k == "dtype" else v) for k, v in config.items()}


def _tree_equal(a, b, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _tree_equal(a[k], b[k], f"{path}/{k}")
    else:
        assert a.dtype == b.dtype and np.array_equal(a, b), path


NARROW = dict(g_kwargs=dict(fmap_max=16, mapping_layers=2, mapping_fmaps=16),
              d_kwargs=dict(fmap_max=16, mbstd_group_size=2))


@pytest.mark.parametrize("how", ["narrow", "cli"])
def test_converter_matches_the_jax_script(how, tmp_path):
    """``narrow``: ``convert`` with the narrow nets of test_converters.py;
    ``cli``: the port's command line (16 px, the flags' defaults otherwise)
    against the JAX script's ``convert`` with the same values."""
    kw = NARROW if how == "narrow" else dict(g_kwargs={}, d_kwargs={})
    G = GMain.create(resolution=16, num_channels=3, latent_size=16, dlatent_size=16,
                     fmap_base=128, architecture="skip", **kw["g_kwargs"])
    D = Discriminator(resolution=16, num_channels=3, fmap_base=128, architecture="resnet",
                      **kw["d_kwargs"])
    npz = str(tmp_path / "vars.npz")
    params = _dump(npz, G, D, seed=7)
    jax_pkl, port_pkl = str(tmp_path / "jax.pkl"), str(tmp_path / "port.pkl")
    _jax_script().convert(npz, jax_pkl, resolution=16, num_channels=3, latent_size=16,
                          fmap_base=128, g_arch="skip", d_arch="resnet", **kw)
    if how == "narrow":
        port_conv.convert(npz, port_pkl, resolution=16, num_channels=3, latent_size=16,
                          fmap_base=128, g_arch="skip", d_arch="resnet", **kw)
    else:
        port_conv.main([npz, port_pkl, "--resolution", "16", "--latent-size", "16",
                        "--fmap-base", "128", "--device", "cpu"])
    with open(jax_pkl, "rb") as f:
        want = pickle.load(f)
    with open(port_pkl, "rb") as f:
        got = pickle.load(f)
    assert list(got) == list(want) and got["format"] == want["format"]
    for net in ("G", "Gs", "D"):
        assert got[net]["config"] == _dtype_names(want[net]["config"]), net
        assert got[net]["config"] == _dtype_names(dataclasses.asdict(G if net != "D" else D))
        _tree_equal(got[net]["params"], want[net]["params"], net)

    # the port's loaders, then the JAX networks on the same inputs
    pretrained_networks._cached_networks.clear()
    TG, TD, TGs = pretrained_networks.load_networks(port_pkl, device="cpu")
    JG, JD, state = jax_load_snapshot(port_pkl)
    z = np.random.RandomState(3).randn(4, 16).astype(np.float32)
    for tnet, key in ((TG, "G"), (TGs, "Gs")):
        want_img = np.asarray(JG.apply(params[key], jnp.asarray(z), randomize_noise=False))
        with torch.no_grad():
            got_img = tnet(torch.from_numpy(z), randomize_noise=False).numpy()
        np.testing.assert_allclose(got_img, want_img, atol=ATOL, err_msg=key)
    _tree_equal(jax.tree_util.tree_map(np.asarray, state["gs_params"]),
                jax.tree_util.tree_map(np.asarray, params["Gs"]), "JAX loader Gs")
    scores_j, feats_j = JD.apply(params["D"], jnp.asarray(want_img))
    with torch.no_grad():
        scores_t, feats_t = TD(torch.from_numpy(np.array(want_img)))
    np.testing.assert_allclose(scores_t.numpy(), np.asarray(scores_j), atol=ATOL)
    np.testing.assert_allclose(feats_t.numpy(), np.asarray(feats_j), atol=ATOL)


def test_converter_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_conv.main([str(tmp_path / "vars.npz"), str(tmp_path / "out.pkl"),
                        "--resolution", "16"])
    assert not os.path.exists(tmp_path / "out.pkl")
