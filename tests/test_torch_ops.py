"""The port's ops (inclusivegan_torch.ops) against the JAX package's on the
same numpy inputs, on the CPU, where every op takes its plain version through
its autograd Function. float32, atol = rtol = 1e-5 for values; gradients,
first and second order, against jax.grad at rtol 1e-4, atol 1e-5 (the
tolerance of tests/test_ops.py for its own gradient checks)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inclusivegan_tpu import ops as jops
from inclusivegan_torch import ops as tops
from inclusivegan_torch.ops import build, cuda_kernels

RK = [1, 3, 3, 1]
TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _oihw(w):
    """[kh, kw, I, O] (JAX) -> [O, I, kh, kw] (port)."""
    return _t(np.transpose(w, (3, 2, 0, 1)))


@pytest.fixture(autouse=True)
def _zero_launch_counts():
    cuda_kernels.reset_launches()
    yield
    # CPU tensors take the plain versions: no kernel is ever launched here
    assert cuda_kernels.launches == {"bias_lrelu": 0, "bias_lrelu_grad": 0,
                                     "upfirdn2d": 0, "upfirdn2d_transposed": 0}


@pytest.mark.parametrize("jax_impl", ["conv", "ref"])
@pytest.mark.parametrize("up,down,pad", [
    (1, 1, 1), (2, 1, 2), (1, 2, 1), (2, 2, 3),
    (1, 1, (2, 1, 0, 3)), (2, 1, (1, -1, 2, 0)),
])
def test_upfirdn2d_matches_jax(up, down, pad, jax_impl):
    x = _rand((2, 3, 8, 8))
    f = jops.setup_filter(RK)
    y_jax = jops.upfirdn2d(jnp.asarray(x), f, up=up, down=down, pad=pad,
                           impl=jax_impl)
    y = tops.upfirdn2d(_t(x), tops.setup_filter(RK), up=up, down=down, pad=pad)
    assert tuple(y.shape) == y_jax.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), **TOL)


@pytest.mark.parametrize("gain", [1.0, 4.0])
def test_upfirdn2d_gain_and_separable_taps(gain):
    x = _rand((1, 2, 5, 7), seed=4)
    y_jax = jops.upfirdn2d(jnp.asarray(x), [1.0, 2.0, 1.0], up=2, pad=(1, 2, 0, 1),
                           gain=gain, impl="ref")
    y = tops.upfirdn2d(_t(x), [1.0, 2.0, 1.0], up=2, pad=(1, 2, 0, 1), gain=gain)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), **TOL)


def test_setup_filter_matches_jax():
    for kw in (dict(), dict(flip=True), dict(gain=4.0), dict(normalize=False)):
        np.testing.assert_array_equal(tops.setup_filter([1, 2, 3, 1], **kw),
                                      jops.setup_filter([1, 2, 3, 1], **kw))


@pytest.mark.parametrize("name,shape", [
    ("upsample2d", (2, 3, 8, 8)), ("downsample2d", (2, 3, 16, 16)),
    ("filter2d", (1, 3, 9, 9)),
])
def test_resample_matches_jax(name, shape):
    x = _rand(shape, seed=1)
    y_jax = getattr(jops, name)(jnp.asarray(x), RK)
    y = getattr(tops, name)(_t(x), RK)
    assert tuple(y.shape) == y_jax.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), **TOL)


@pytest.mark.parametrize("name", ["upsample_conv2d", "conv_downsample2d"])
@pytest.mark.parametrize("k", [1, 3])
def test_conv_resample_matches_jax(name, k):
    x = _rand((2, 4, 8, 8), seed=2)
    w = _rand((k, k, 4, 5), seed=3)
    y_jax = getattr(jops, name)(jnp.asarray(x), jnp.asarray(w), RK, factor=2)
    y = getattr(tops, name)(_t(x), _oihw(w), RK, factor=2)
    assert tuple(y.shape) == y_jax.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), **TOL)


@pytest.mark.parametrize("act", sorted(jops.activation_funcs))
def test_fused_bias_act_all_activations(act):
    assert sorted(tops.activation_funcs) == sorted(jops.activation_funcs)
    spec, jspec = tops.activation_funcs[act], jops.activation_funcs[act]
    assert (spec.def_alpha, spec.def_gain) == (jspec.def_alpha, jspec.def_gain)
    x = _rand((2, 4, 3, 3)) * 3
    b = _rand((4,), seed=2)
    y_jax = jops.fused_bias_act(jnp.asarray(x), jnp.asarray(b), act=act)
    y = tops.fused_bias_act(_t(x), _t(b), act=act)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), **TOL)


@pytest.mark.parametrize("kwargs", [
    dict(act="lrelu", alpha=0.1, gain=2.0), dict(act="linear", clamp=1.5),
    dict(act="lrelu", clamp=0.5), dict(act="lrelu", axis=0),
    dict(act="swish", no_bias=True),
])
def test_fused_bias_act_options(kwargs):
    kwargs = dict(kwargs)
    axis = kwargs.pop("axis", 1)
    x = _rand((4, 6)) * 3
    b = None if kwargs.pop("no_bias", False) else _rand((x.shape[axis],), seed=5)
    y_jax = jops.fused_bias_act(jnp.asarray(x), None if b is None else jnp.asarray(b),
                                axis=axis, **kwargs)
    y = tops.fused_bias_act(_t(x), None if b is None else _t(b), axis=axis, **kwargs)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), **TOL)
    if "clamp" in kwargs:
        assert float(y.abs().max()) <= kwargs["clamp"]


def test_cpu_tensor_takes_plain_version_and_wrapper_refuses_it():
    """On a CPU tensor the ops never reach a kernel wrapper (the fixture
    checks that no launch was counted); a wrapper given a CPU tensor raises
    rather than computing anything."""
    x = _t(_rand((1, 2, 4, 4)))
    tops.fused_bias_act(x, torch.zeros(2), act="lrelu")
    tops.upsample2d(x, RK)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_kernels.bias_lrelu(x, torch.zeros(2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_kernels.upfirdn2d(x, tops.setup_filter(RK), 2, 1, (2, 1, 2, 1), 4.0)


def test_build_raises_clearly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_kernels, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_kernels.load_library()


GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _first_and_second_order(port_fn, jax_fn, x, w):
    """Gradients of sum(f(x)^2 * w) and of sum(grad^2), port and JAX."""
    xt = _t(x).requires_grad_()
    (g,) = torch.autograd.grad((port_fn(xt).square() * _t(w)).sum(), xt,
                               create_graph=True)
    (gg,) = torch.autograd.grad(g.square().sum(), xt)

    def loss(v):
        return jnp.sum(jax_fn(v) ** 2 * w)

    g_jax = jax.grad(loss)(jnp.asarray(x))
    gg_jax = jax.grad(lambda v: jnp.sum(jax.grad(loss)(v) ** 2))(jnp.asarray(x))
    return (g.detach().numpy(), np.asarray(g_jax)), (gg.numpy(), np.asarray(gg_jax))


@pytest.mark.parametrize("up,down,pad", [
    (1, 1, 1), (2, 1, 2), (1, 2, 1), (2, 2, 3),
    (1, 1, (2, 1, 0, 3)), (2, 1, (1, -1, 2, 0)),
])
def test_upfirdn2d_gradients_match_jax(up, down, pad):
    """The backward is the same op at the transposed configuration (flipped
    taps, up and down swapped, gpad); to second order, as R1 and the
    path-length reg need, against XLA autodiff of the JAX conv form."""
    x = _rand((2, 3, 8, 8), seed=6)
    f = jops.setup_filter(RK)
    y_shape = jops.upfirdn2d(jnp.asarray(x), f, up=up, down=down, pad=pad).shape
    w = _rand(y_shape, seed=7)
    (g, g_jax), (gg, gg_jax) = _first_and_second_order(
        lambda v: tops.upfirdn2d(v, tops.setup_filter(RK), up=up, down=down, pad=pad),
        lambda v: jops.upfirdn2d(v, f, up=up, down=down, pad=pad), x, w)
    np.testing.assert_allclose(g, g_jax, **GRAD_TOL)
    np.testing.assert_allclose(gg, gg_jax, **GRAD_TOL)


@pytest.mark.parametrize("name", ["upsample2d", "downsample2d", "upsample_conv2d",
                                  "conv_downsample2d"])
def test_resample_gradients_match_jax(name):
    """The FIR with the convolutions around it, as G and D call it; weight
    gradients too."""
    x = _rand((2, 4, 8, 8), seed=8)
    wconv = _rand((3, 3, 4, 5), seed=9)
    if name in ("upsample2d", "downsample2d"):
        def port_fn(v, wt=None):
            return getattr(tops, name)(v, RK)

        def jax_fn(v, wj=None):
            return getattr(jops, name)(v, RK)
    else:
        def port_fn(v, wt=_oihw(wconv)):
            return getattr(tops, name)(v, wt, RK, factor=2)

        def jax_fn(v, wj=jnp.asarray(wconv)):
            return getattr(jops, name)(v, wj, RK, factor=2)
    w = _rand(jax_fn(jnp.asarray(x)).shape, seed=10)
    (g, g_jax), (gg, gg_jax) = _first_and_second_order(port_fn, jax_fn, x, w)
    np.testing.assert_allclose(g, g_jax, **GRAD_TOL)
    np.testing.assert_allclose(gg, gg_jax, **GRAD_TOL)
    if name in ("upsample_conv2d", "conv_downsample2d"):
        wt = _oihw(wconv).requires_grad_()
        (gw,) = torch.autograd.grad((port_fn(_t(x), wt) * _t(w)).sum(), wt)
        gw_jax = jax.grad(lambda wj: jnp.sum(jax_fn(jnp.asarray(x), wj) * w))(
            jnp.asarray(wconv))
        np.testing.assert_allclose(gw.numpy(), np.transpose(np.asarray(gw_jax),
                                                            (3, 2, 0, 1)), **GRAD_TOL)


@pytest.mark.parametrize("shape,axis", [((2, 3, 4, 4), 1), ((2, 4, 8, 8), 1),
                                        ((4, 6), 1), ((4, 6), 0)])
def test_bias_lrelu_gradients_match_jax(shape, axis):
    """First and second order in x and the bias, against jax.grad through the
    JAX plain form (the model's path) and through the Pallas kernel's
    custom_jvp (interpreted on the CPU) for NCHW."""
    x = _rand(shape, seed=11) * 2
    b = _rand((shape[axis],), seed=12)
    w = _rand(shape, seed=13)
    impls = ["jax"] + (["pallas"] if len(shape) == 4 else [])
    for impl in impls:
        (g, g_jax), (gg, gg_jax) = _first_and_second_order(
            lambda v: tops.fused_bias_act(v, _t(b), axis=axis, act="lrelu"),
            lambda v: jops.fused_bias_act(v, jnp.asarray(b), axis=axis,
                                          act="lrelu", impl=impl), x, w)
        np.testing.assert_allclose(g, g_jax, **GRAD_TOL)
        np.testing.assert_allclose(gg, gg_jax, **GRAD_TOL)
        bt = _t(b).requires_grad_()
        xt = _t(x).requires_grad_()
        y = tops.fused_bias_act(xt, bt, axis=axis, act="lrelu")
        (gx, gb) = torch.autograd.grad((y.square() * _t(w)).sum(), (xt, bt),
                                       create_graph=True)
        (ggb,) = torch.autograd.grad(gx.square().sum() + gb.square().sum(), bt)

        def loss(xv, bv):
            y = jops.fused_bias_act(xv, bv, axis=axis, act="lrelu", impl=impl)
            return jnp.sum(y ** 2 * w)

        gx_j, gb_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(b))
        ggb_j = jax.grad(lambda bv: sum(jnp.sum(t ** 2) for t in jax.grad(
            loss, argnums=(0, 1))(jnp.asarray(x), bv)))(jnp.asarray(b))
        np.testing.assert_allclose(gb.detach().numpy(), np.asarray(gb_j), **GRAD_TOL)
        np.testing.assert_allclose(ggb.numpy(), np.asarray(ggb_j), **GRAD_TOL)


def test_the_backward_functions_are_on_the_tape():
    """The gradient of an op is the op's own Function again, so that
    create_graph=True records it: the port's second-order path never leaves
    the Functions for autograd of the plain tensor code."""
    x = _t(_rand((1, 2, 6, 6))).requires_grad_()
    y = tops.fused_bias_act(tops.upsample2d(x, RK), torch.zeros(2), act="lrelu")
    (g,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    names = set()
    stack = [g.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is not None and type(fn).__name__ not in names:
            names.add(type(fn).__name__)
            stack += [f for f, _ in fn.next_functions]
    assert {"_BiasLreluGradBackward", "_UpFirDn2dBackward"} <= names, names


# --- float16 and bfloat16: exact equality with the JAX package -------------
#
# The JAX package computes each op in the storage dtype (bias + lrelu rounds
# after the sum and after each product, with alpha and gain rounded to the
# dtype first) and the FIR in float32, rounded once. The port's plain
# versions do the same, so every value agrees exactly: against the jnp forms
# and against the Pallas kernels, interpreted on the CPU as tests/test_ops.py
# runs them. In float32 the FIR is held exactly to the JAX ``ref`` form
# (XLA contracts the interpreted kernel's and the conv form's sums into
# FMAs, which the 16-bit roundings hide).

DTYPES_16 = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
             "float16": (jnp.float16, torch.float16)}
SHAPES_16 = [(4, 32, 16, 16), (2, 8, 17, 17)]


def _both(a, dtype):
    """numpy float32 ``a`` as a JAX array and a torch tensor of one dtype."""
    jdt, tdt = {**DTYPES_16, "float32": (jnp.float32, torch.float32)}[dtype]
    return jnp.asarray(a).astype(jdt), _t(a).to(tdt)


def _assert_same(port, jax_value):
    got = port.float().numpy()
    want = np.asarray(jnp.asarray(jax_value, jnp.float32))
    assert got.shape == want.shape
    differ = np.mean(got != want)
    assert differ == 0.0, (f"{differ:.2%} of values differ, largest by "
                           f"{np.abs(got - want).max():.3g}")


@pytest.mark.parametrize("impl", ["jax", "pallas"])
@pytest.mark.parametrize("shape", SHAPES_16)
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_bias_lrelu_exact_in_every_dtype(dtype, shape, impl):
    xj, xt = _both(_rand(shape, seed=20), dtype)
    bj, bt = _both(_rand((shape[1],), seed=21), dtype)
    _assert_same(tops.fused_bias_act(xt, bt, act="lrelu"),
                 jops.fused_bias_act(xj, bj, act="lrelu", impl=impl))


@pytest.mark.parametrize("shape", SHAPES_16)
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_bias_lrelu_gradient_exact_against_the_kernels_tangent(dtype, shape):
    """``bias_lrelu_grad_plain`` against the tangent of the Pallas op's
    custom_jvp (``pallas_kernels.py::_bias_act_jvp``: the slope rounded to the
    dtype, one rounded product), and the port's autograd dx against
    jax.grad through that op."""
    from inclusivegan_torch.ops.fused_bias_act import bias_lrelu_grad_plain
    from inclusivegan_tpu.ops.pallas_kernels import bias_act_lrelu_pallas
    xj, xt = _both(_rand(shape, seed=22), dtype)
    bj, bt = _both(_rand((shape[1],), seed=23), dtype)
    dj, dt = _both(_rand(shape, seed=24), dtype)
    y_jax, tangent = jax.jvp(lambda v: bias_act_lrelu_pallas(v, bj), (xj,), (dj,))
    y = tops.fused_bias_act(xt, bt, act="lrelu")
    _assert_same(y, y_jax)
    _assert_same(bias_lrelu_grad_plain(y, dt, 0.2, float(np.sqrt(2))), tangent)
    g_jax = jax.grad(lambda v: jnp.sum(
        (bias_act_lrelu_pallas(v, bj) * dj).astype(jnp.float32)))(xj)
    xg = xt.clone().requires_grad_()
    (g,) = torch.autograd.grad(tops.fused_bias_act(xg, bt, act="lrelu"), xg, dt)
    _assert_same(g, g_jax)


FIR_CASES = {
    "upsample2d": lambda m, x, impl: m.upsample2d(x, RK, **impl),
    "downsample2d": lambda m, x, impl: m.downsample2d(x, RK, **impl),
    "up2_crop": lambda m, x, impl: m.upfirdn2d(x, m.setup_filter(RK), up=2,
                                               pad=(1, -1, 2, 0), **impl),
    "conv_fir_pad2": lambda m, x, impl: m.upfirdn2d(x, m.setup_filter(RK), pad=2,
                                                    gain=4.0, **impl),
}


@pytest.mark.parametrize("shape", SHAPES_16)
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("case", sorted(FIR_CASES))
def test_fir_exact_in_every_dtype(case, dtype, shape):
    """The FIR sums in float32 and rounds once, as ``_fir_kernel`` does:
    in 16 bits against the interpreted Pallas kernel and the conv form, in
    float32 against the ``ref`` form."""
    fn = FIR_CASES[case]
    xj, xt = _both(_rand(shape, seed=25), dtype)
    y = fn(tops, xt, {})
    for impl in (("pallas", "conv") if dtype != "float32" else ("ref",)):
        _assert_same(y, fn(jops, xj, dict(impl=impl)))


def _conv_resample(name, dtype, shape, k, impl):
    xj, xt = _both(_rand(shape, seed=26), dtype)
    wj, _ = _both(_rand((k, k, shape[1], 5), seed=27), dtype)
    wt = _oihw(np.asarray(_rand((k, k, shape[1], 5), seed=27))).to(xt.dtype)
    return (getattr(tops, name)(xt, wt, RK, factor=2),
            getattr(jops, name)(xj, wj, RK, factor=2, impl=impl))


@pytest.mark.parametrize("shape", SHAPES_16)
@pytest.mark.parametrize("dtype,name,k", [
    ("bfloat16", "upsample_conv2d", 1), ("bfloat16", "upsample_conv2d", 3),
    ("bfloat16", "conv_downsample2d", 1), ("bfloat16", "conv_downsample2d", 3),
    ("float16", "upsample_conv2d", 1), ("float16", "conv_downsample2d", 1),
])
def test_conv_resample_exact_in_16_bits(dtype, name, k, shape):
    """The FIR with the convolution around it, as G and D call it."""
    for impl in ("pallas", "conv"):
        _assert_same(*_conv_resample(name, dtype, shape, k, impl))


@pytest.mark.parametrize("shape", SHAPES_16)
@pytest.mark.parametrize("name", ["upsample_conv2d", "conv_downsample2d"])
def test_conv_resample_float16_3x3(name, shape):
    """float16, 3x3 weights: torch's and XLA's CPU convolutions both sum in
    float32 and round once to float16, but in other orders, so about 0.1% of
    the convolution's outputs differ by one unit in the last place (and the
    FIR after a transposed convolution spreads each to its neighbours). The
    FIR itself is held exactly, on the convolution's own output or input:
    the port's op equals the JAX package's FIR (interpreted Pallas kernel)
    composed with the port's convolution."""
    y, y_jax = _conv_resample(name, "float16", shape, 3, "pallas")
    got, want = y.float().numpy(), np.asarray(jnp.asarray(y_jax, jnp.float32))
    assert np.mean(got != want) < 0.01
    np.testing.assert_array_less(np.abs(got - want), 1e-2 * np.abs(want).max())
    _, xt = _both(_rand(shape, seed=26), "float16")
    wt = _oihw(np.asarray(_rand((3, 3, shape[1], 5), seed=27))).to(torch.float16)
    F = torch.nn.functional
    if name == "upsample_conv2d":
        conv = F.conv_transpose2d(xt, wt.transpose(0, 1), stride=2)
        f = jops.setup_filter(RK, gain=4.0)
        p = f.shape[0] - 2 - 2
        fir = jops.upfirdn2d(jnp.asarray(conv.float().numpy()).astype(jnp.float16), f,
                             pad=((p + 1) // 2 + 1, p // 2 + 1, (p + 1) // 2 + 1, p // 2 + 1),
                             impl="pallas")
        _assert_same(y, fir)
    else:
        f = jops.setup_filter(RK)
        p = f.shape[0] - 2 + 2
        fir = jops.upfirdn2d(jnp.asarray(xt.float().numpy()).astype(jnp.float16), f,
                             pad=((p + 1) // 2, p // 2, (p + 1) // 2, p // 2), impl="pallas")
        conv = F.conv2d(_t(np.asarray(jnp.asarray(fir, jnp.float32))).half(),
                        wt, stride=2)
        _assert_same(y, conv.float().numpy())


def test_fir_plan_refuses_a_cpu_tensor_without_building():
    x = _t(_rand((1, 2, 4, 4)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_kernels.upfirdn2d_plan(x, tops.setup_filter(RK), 2, 1, (2, 1, 2, 1))
    assert cuda_kernels._lib is None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_kernel_scalars_match_the_plain_versions(dtype):
    """The host scalars the bias kernels take (cached per value and dtype)
    are the ones the plain versions multiply by."""
    from inclusivegan_torch.ops.fused_bias_act import bias_lrelu_grad_plain
    alpha, gain = 0.2, float(np.sqrt(2))
    y = torch.tensor([1.0, -1.0], dtype=dtype)
    slopes = bias_lrelu_grad_plain(y, torch.ones(2, dtype=dtype), alpha, gain)
    assert cuda_kernels._slopes(alpha, gain, dtype) == tuple(slopes.tolist())
    x = torch.tensor([-1.0, 1.0], dtype=dtype)
    a, g = (torch.tensor(cuda_kernels.rounded(v, dtype), dtype=dtype) for v in (alpha, gain))
    y = tops.fused_bias_act(x, torch.zeros(2, dtype=dtype), axis=0, act="lrelu",
                            alpha=alpha, gain=gain)
    assert y.tolist() == [float(x[0] * a * g), float(g)]


# sigmoid and swish in 16 bits: the port rounds each op of 1 / (1 + exp(-x))
# in the storage dtype, as XLA expands jax.nn.sigmoid; exact against the JAX
# package, and against the bits stored for the card's check
# (tests/torch_golden/make_activation_bits.py).

ACT_BITS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "inclusivegan_torch", "testdata", "activation_bits.npz")


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("act", ["sigmoid", "swish"])
def test_sigmoid_and_swish_exact_in_16_bits(act, dtype):
    bits = np.load(ACT_BITS)
    xj, xt = _both(bits["x"], dtype)
    bj, bt = _both(bits["b"], dtype)
    y = tops.fused_bias_act(xt, bt, act=act)
    _assert_same(y, jops.fused_bias_act(xj, bj, act=act))
    np.testing.assert_array_equal(y.view(torch.int16).numpy().view(np.uint16),
                                  bits[f"{act}/{dtype}"])
