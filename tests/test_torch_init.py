"""Fresh initialization of the port's networks (``init`` from a
``torch.Generator``) against the JAX package's ``init`` on the CPU.

The JAX PRNG streams cannot be reproduced, so parity is held by structure
and statistics: the same tree of names, shapes and dtypes at two
architectures of G (skip, resnet) and of D (resnet, skip); every tensor that
JAX sets to zeros (or ones) is exactly that in the port; every drawn tensor
of at least 1024 entries has a sample standard deviation within 5% of the
JAX formula's (``_winit``: init_mul / lrmul under equalized learning rates)
and a mean within 4 std / sqrt(n) of 0, and ``init_mul`` scales it. The
JAX package's own draws are held to the same formula within 4 standard
errors of a sample std, which shows that the formula is JAX's. That a
JAX-initialized tree carried into the port steps like JAX's is held in
``test_torch_train_step.py`` (``test_jax_initialized_tree_steps_like_jax``),
beside the compiled JAX phases it reuses."""

import jax
import numpy as np
import pytest
import torch

from inclusivegan_torch.models import stylegan2 as tsg
from inclusivegan_tpu.models import stylegan2 as jsg
from torch_golden.narrow_nets import flat

RES = 32
NET = dict(fmap_base=256, fmap_max=32)
MIN_ENTRIES = 1024


def _nets(g_arch, d_arch, init_mul=1.0):
    g_kw = dict(resolution=RES, latent_size=32, dlatent_size=32, mapping_layers=3,
                mapping_fmaps=32, architecture=g_arch, init_mul=init_mul, label_size=2,
                **NET)
    d_kw = dict(resolution=RES, architecture=d_arch, mbstd_group_size=2, init_mul=init_mul,
                label_size=2, **NET)
    return (jsg.GMain.create(**g_kw), jsg.Discriminator(**d_kw),
            tsg.GMain.create(**g_kw), tsg.Discriminator(**d_kw))


def _expected_std(name, init_mul, mapping_lrmul=0.01):
    """The JAX formula's standard deviation of a drawn leaf, None for the
    leaves it sets to constants."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "const" or name.startswith("noise."):
        return 1.0
    if leaf in ("weight", "mod_weight"):
        return init_mul / (mapping_lrmul if name.startswith("mapping.") else 1.0)
    return None


ARCHS = [("skip", "resnet"), ("resnet", "skip")]


@pytest.fixture(scope="module", params=ARCHS, ids=lambda a: f"G{a[0]}-D{a[1]}")
def both(request):
    JG, JD, TG, TD = _nets(*request.param)
    gen = torch.Generator().manual_seed(0)
    return ({"G": flat(JG.init(jax.random.key(0))), "D": flat(JD.init(jax.random.key(1)))},
            {"G": {k: v.numpy() for k, v in TG.init(gen).state_dict().items()},
             "D": {k: v.numpy() for k, v in TD.init(gen).state_dict().items()}})


@pytest.mark.parametrize("net", ["G", "D"])
def test_same_names_shapes_and_dtypes(both, net):
    jax_tree, port_tree = both[0][net], both[1][net]
    assert set(port_tree) == set(jax_tree)
    for k, v in jax_tree.items():
        assert port_tree[k].shape == v.shape, k
        assert port_tree[k].dtype == v.dtype == np.float32, k


@pytest.mark.parametrize("net", ["G", "D"])
def test_constants_exact(both, net):
    jax_tree, port_tree = both[0][net], both[1][net]
    constant = 0
    for k, v in jax_tree.items():
        for c in (0.0, 1.0):
            if np.all(v == c):
                np.testing.assert_array_equal(port_tree[k], v, err_msg=k)
                constant += 1
    assert constant >= {"G": 10, "D": 5}[net]  # biases, noise strengths, ...


def _check_statistics(tree, init_mul, who, rel_tol=None):
    """Zeros where the formula has no draw; for each drawn tensor of at
    least MIN_ENTRIES, the sample std within ``rel_tol`` of the formula's
    (default: 4 standard errors of a normal sample's std, 4 / sqrt(2 n))
    and the mean within 4 std / sqrt(n)."""
    checked = 0
    for k, v in tree.items():
        std = _expected_std(k, init_mul)
        if std is None:
            assert not np.any(v), f"{who} {k} should be zeros"
            continue
        if v.size < MIN_ENTRIES:
            continue
        s = float(v.std())
        tol = 4 / np.sqrt(2 * v.size) if rel_tol is None else rel_tol
        assert abs(s - std) <= tol * std, f"{who} {k}: std {s} vs {std}"
        assert abs(float(v.mean())) <= 4 * std / np.sqrt(v.size), f"{who} {k}: mean"
        checked += 1
    return checked


@pytest.mark.parametrize("net", ["G", "D"])
def test_statistics_follow_the_jax_formula(both, net):
    jax_tree, port_tree = both[0][net], both[1][net]
    assert _check_statistics(jax_tree, 1.0, "JAX") == \
        _check_statistics(port_tree, 1.0, "port", rel_tol=0.05) >= 4


@pytest.mark.parametrize("init_mul", [0.25, 3.0])
def test_init_mul_scales_the_draws(init_mul):
    JG, JD, TG, TD = _nets("skip", "resnet", init_mul)
    gen = torch.Generator().manual_seed(1)
    for jtree, module in ((flat(JG.init(jax.random.key(3))), TG),
                          (flat(JD.init(jax.random.key(4))), TD)):
        port = {k: v.numpy() for k, v in module.init(gen).state_dict().items()}
        assert _check_statistics(jtree, init_mul, "JAX") == \
            _check_statistics(port, init_mul, "port", rel_tol=0.05) >= 4


def test_init_replaces_float16_parameters_with_float32():
    """A network loaded in float16 and initialized afresh is float32 again,
    as a fresh JAX tree is."""
    _, _, TG, TD = _nets("skip", "resnet")
    TG.half()
    TD.half()
    gen = torch.Generator().manual_seed(0)
    TG.init(gen)
    TD.init(gen)
    assert all(v.dtype == torch.float32 for v in TG.state_dict().values())
    assert all(v.dtype == torch.float32 for v in TD.state_dict().values())


def test_config_is_the_jax_dataclass():
    import dataclasses
    JG, JD, TG, TD = _nets("resnet", "skip", 0.5)
    jg = dataclasses.asdict(JG)
    jd = dataclasses.asdict(JD)
    for sub in ("mapping", "synthesis"):
        jg[sub]["dtype"] = "float32"
    jd["dtype"] = "float32"
    assert TG.config == jg
    assert TD.config == jd


def test_create_refuses_the_bf16_knob():
    """The bf16 knob is ported: create builds bfloat16 mapping and synthesis
    and writes the dtype into their configs; a compute dtype that is not a
    floating-point one is refused."""
    G = tsg.GMain.create(resolution=RES, dtype="bfloat16", **NET)
    assert G.mapping.dtype == G.synthesis.dtype == torch.bfloat16
    assert G.config["mapping"]["dtype"] == G.config["synthesis"]["dtype"] == "bfloat16"
    with pytest.raises(ValueError, match="floating-point"):
        tsg.GMain.create(resolution=RES, dtype="int32", **NET)
