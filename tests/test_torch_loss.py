"""The port's training losses (inclusivegan_torch.training.loss) against the
JAX package's, on narrow networks (tests/torch_golden/narrow_nets.py) at
16 px, on the CPU; the batched G loss with seeded random LPIPS-VGG weights,
the unbatched one (six LPIPS calls) with the pixel-pyramid fallback. The JAX draws are
re-derived from the same keys (tests/torch_golden/jax_draws.py) and handed
to the port. Per-sample losses within 1e-4 relative + 1e-5 absolute;
parameter gradients, which for R1 and the path-length reg are second order,
within 2e-3 relative + 1e-5 absolute of a tensor's largest entry (float32
sums in another order through four networks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inclusivegan_tpu.models.lpips import (init_lpips_params,
                                           init_pixel_fallback_params)
from inclusivegan_tpu.training import loss as jloss
from inclusivegan_torch.models.lpips import lpips_params_from_numpy
from inclusivegan_torch.training import loss as tloss
from torch_golden import jax_draws
from torch_golden.narrow_nets import (RES, ZDIM, flat, narrow_nets, port_grads,
                                      to_port)

LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
N = 2


def assert_grads_close(port, jax_tree):
    ref = {k: v for k, v in flat(jax_tree).items() if k in port}
    assert set(ref) == set(port), set(ref) ^ set(port)
    for k in sorted(port):
        scale = max(float(np.abs(ref[k]).max()), 1e-12)
        np.testing.assert_allclose(port[k], ref[k], rtol=2e-3,
                                   atol=1e-5 + 2e-3 * scale, err_msg=k)


@pytest.fixture(scope="module")
def nets():
    G, D, gp, dp, gc, dc = narrow_nets()
    lp = jax.tree_util.tree_map(np.asarray, init_lpips_params(seed=7))
    return G, D, gp, dp, gc, dc, lp, lpips_params_from_numpy(lp, "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _trainables(gp):
    return {k: v for k, v in gp.items() if k not in ("noise", "dlatent_avg")}


def _reals(n, seed):
    return np.random.RandomState(seed).uniform(-1, 1, (n, 3, RES, RES)).astype(np.float32)


@pytest.mark.parametrize("batched", [True, False])
def test_g_main_loss_matches_jax(nets, batched):
    G, D, gp, dp, gc, dc, lp, tlp = nets
    if not batched:
        lp = jax.tree_util.tree_map(np.asarray, init_pixel_fallback_params())
        tlp = lpips_params_from_numpy(lp, "cpu")
    rnd = np.random.RandomState(1)
    data = dict(latents_rec_1=rnd.randn(N, ZDIM).astype(np.float32),
                reals_rec_1=_reals(N, 2),
                latents_rec_2=rnd.randn(N, ZDIM).astype(np.float32),
                reals_rec_2=_reals(N, 3),
                arb_latents=rnd.randn(N, ZDIM).astype(np.float32))
    labels = dict(labels_rec_1=np.zeros((N, 0), np.float32),
                  labels_rec_2=np.zeros((N, 0), np.float32),
                  arb_labels=np.zeros((N, 0), np.float32))
    key = jax.random.key(4)

    def jloss_fn(tr):
        out = jloss.g_main_loss({**gp, **tr}, dp, G=G, D=D, lpips_params=lp,
                                rng=key, batched=batched,
                                **{k: jnp.asarray(v) for k, v in {**data, **labels}.items()})
        return jnp.mean(out.loss), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        _trainables(gp))
    TG, TD = to_port(gc, gp, dc, dp)
    draws = jax_draws.to_torch(jax_draws.g_main(G, key, N, batched))
    out = tloss.g_main_loss(TG, TD, tlp, draws=draws, batched=batched, impl="plain",
                            **{k: _t(v) for k, v in {**data, **labels}.items()})
    np.testing.assert_allclose(out.loss.detach().numpy(), np.asarray(jout.loss), **LOSS_TOL)
    for k, v in jout.scalars.items():
        np.testing.assert_allclose(float(out.scalars[k]), float(v), **LOSS_TOL)
    for a, b in zip(out.dlatent_batch_avgs, jout.dlatent_batch_avgs):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **LOSS_TOL)
    assert_grads_close(port_grads(out.loss.mean(), TG), jgrads)


def test_g_path_reg_matches_jax(nets):
    """Double backward through synthesis; the gradient flows through the
    EMA'd pl_mean."""
    G, D, gp, dp, gc, dc, lp, tlp = nets
    key = jax.random.key(5)
    pl_mean = 0.7
    mb = 4

    def jreg(tr):
        reg, new_pl, scalars, ba = jloss.g_path_reg(
            {**gp, **tr}, G=G, rng=key, pl_mean=jnp.float32(pl_mean),
            minibatch_size=mb, latent_size=ZDIM, label_size=0)
        return jnp.mean(reg), (reg, new_pl, scalars, ba)

    (_, (jr, jpl, js, jba)), jgrads = jax.jit(jax.value_and_grad(jreg, has_aux=True))(
        _trainables(gp))
    TG, _ = to_port(gc, gp, dc, dp)
    draws = jax_draws.to_torch(jax_draws.g_path_reg(G, key, mb))
    reg, new_pl, scalars, ba = tloss.g_path_reg(
        TG, draws=draws, pl_mean=torch.tensor(pl_mean), label_size=0, impl="plain")
    assert reg.shape == (mb // 2,)
    np.testing.assert_allclose(reg.detach().numpy(), np.asarray(jr), **LOSS_TOL)
    np.testing.assert_allclose(float(new_pl), float(jpl), **LOSS_TOL)
    np.testing.assert_allclose(ba.detach().numpy(), np.asarray(jba), **LOSS_TOL)
    for k, v in js.items():
        np.testing.assert_allclose(float(scalars[k]), float(v), **LOSS_TOL)
    assert_grads_close(port_grads(reg.mean(), TG), jgrads)


@pytest.mark.parametrize("n_fake", [4, 3])
def test_d_main_loss_matches_jax(nets, n_fake):
    """4 fakes: one D call over fakes and reals (groups of 2 never straddle
    them); 3 fakes: two D calls."""
    G, D, gp, dp, gc, dc, lp, tlp = nets
    key = jax.random.key(6)
    rnd = np.random.RandomState(7)
    arb = rnd.randn(n_fake, ZDIM).astype(np.float32)
    reals = _reals(n_fake, 8)
    zeros = np.zeros((n_fake, 0), np.float32)

    def jfn(d):
        loss, scalars, avgs = jloss.d_main_loss(
            d, gp, G=G, D=D, rng=key, reals=jnp.asarray(reals), labels=zeros,
            arb_latents=jnp.asarray(arb), arb_labels=zeros)
        return jnp.mean(loss), (loss, scalars, avgs)

    (_, (jl, js, javgs)), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(dp)
    TG, TD = to_port(gc, gp, dc, dp)
    draws = jax_draws.to_torch(jax_draws.d_main(G, key, n_fake))
    loss, scalars, avgs = tloss.d_main_loss(
        TG, TD, draws=draws, reals=_t(reals), labels=_t(zeros), arb_latents=_t(arb),
        arb_labels=_t(zeros), impl="plain")
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jl), **LOSS_TOL)
    for k, v in js.items():
        np.testing.assert_allclose(float(scalars[k]), float(v), **LOSS_TOL)
    np.testing.assert_allclose(avgs[0].numpy(), np.asarray(javgs[0]), **LOSS_TOL)
    assert_grads_close(port_grads(loss.mean(), TD, skip=()), jgrads)


def test_d_r1_reg_matches_jax(nets):
    """Double backward through D."""
    G, D, gp, dp, gc, dc, lp, tlp = nets
    reals = _reals(4, 9)
    zeros = np.zeros((4, 0), np.float32)

    def jfn(d):
        reg, scalars = jloss.d_r1_reg(d, D=D, reals=jnp.asarray(reals),
                                      labels=zeros, gamma=100.0)
        return jnp.mean(reg), (reg, scalars)

    (_, (jr, js)), jgrads = jax.jit(jax.value_and_grad(jfn, has_aux=True))(dp)
    _, TD = to_port(gc, gp, dc, dp)
    reg, scalars = tloss.d_r1_reg(TD, reals=_t(reals), labels=_t(zeros), gamma=100.0,
                                  impl="plain")
    np.testing.assert_allclose(reg.detach().numpy(), np.asarray(jr), **LOSS_TOL)
    np.testing.assert_allclose(float(scalars["Loss/gradient_penalty_D"]),
                               float(js["Loss/gradient_penalty_D"]), **LOSS_TOL)
    assert_grads_close(port_grads(reg.mean(), TD, skip=()), jgrads)


def test_slerp_lerp_and_fold_match_jax():
    rnd = np.random.RandomState(10)
    a, b = rnd.randn(5, 8).astype(np.float32), rnd.randn(5, 8).astype(np.float32)
    t = rnd.uniform(size=(5, 1)).astype(np.float32)
    np.testing.assert_allclose(tloss.slerp(_t(a), _t(b), _t(t)).numpy(),
                               np.asarray(jloss.slerp(a, b, t)), atol=1e-6)
    np.testing.assert_allclose(tloss.lerp(_t(a), _t(b), _t(t)).numpy(),
                               np.asarray(jloss.lerp(a, b, t)), atol=1e-6)
    avgs = [rnd.randn(8).astype(np.float32) for _ in range(3)]
    np.testing.assert_allclose(
        tloss.fold_dlatent_avg(_t(a[0]), [_t(v) for v in avgs], 0.9).numpy(),
        np.asarray(jloss.fold_dlatent_avg(a[0], avgs, 0.9)), atol=1e-6)
    x = rnd.uniform(-1, 1, (2, 3, 4, 4)).astype(np.float32)
    np.testing.assert_allclose(tloss._to_255(_t(x)).numpy(),
                               np.asarray(jloss._to_255(x)), atol=1e-5)
