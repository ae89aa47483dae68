"""One full training iteration of the port (inclusivegan_torch.training.
train_step) against the JAX package's ``make_train_step`` on a one-device CPU
mesh, with both lazy regularizers, phase by phase; plus the optimizer's
pieces and the config's guards.

Narrow networks (tests/torch_golden/narrow_nets.py) at 16 px, minibatch 2
(D main then sees 4 fakes, two minibatch-stddev groups of 2, in one D call
with the reals), the pixel-pyramid LPIPS (the VGG trunk is held to JAX in
test_torch_loss.py and test_torch_lpips.py), gamma 100 and mirror augment,
as the CelebA run trains. The JAX draws of the step key are re-derived
(tests/torch_golden/jax_draws.py) and handed to the port. With beta1 = 0 the
first Adam moment after a phase is that phase's gradient, so gradients are
read there. Tolerances: loss scalars 1e-4 relative + 1e-5; each gradient,
second Adam moment and Gs tensor within 2e-3 relative + 1e-5 absolute of its
largest entry; pl_mean and dlatent_avg 1e-4 relative + 1e-6.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inclusivegan_tpu.models.lpips import init_pixel_fallback_params
from inclusivegan_tpu.parallel import make_data_mesh
from inclusivegan_tpu.training import optimizer as jopt
from inclusivegan_tpu.training.train_state import create_train_state as j_create
from inclusivegan_tpu.training.train_step import TrainConfig as JTrainConfig
from inclusivegan_tpu.training.train_step import make_train_step as j_make
from inclusivegan_torch.models.lpips import lpips_params_from_numpy
from inclusivegan_torch.training import optimizer as topt
from inclusivegan_torch.training.train_state import create_train_state
from inclusivegan_torch.training.train_step import TrainConfig, make_train_step
from torch_golden import jax_draws
from torch_golden.narrow_nets import RES, ZDIM, flat, narrow_nets, to_port

MB = 2
G_LR = D_LR = 0.002
GS_BETA = 0.99
CFG = dict(gamma=100.0, mirror_augment=True)
PHASES = (("g_main", "g_opt"), ("g_reg", "g_opt"), ("d_main", "d_opt"),
          ("d_reg", "d_opt"))


def _batch(seed=0):
    r = np.random.RandomState(seed)
    return {
        "reals_rec_1": r.randint(0, 256, (MB, 3, RES, RES)).astype(np.uint8),
        "latents_rec_1": r.randn(MB, ZDIM).astype(np.float32),
        "labels_rec_1": np.zeros((MB, 0), np.float32),
        "reals_rec_2": r.randint(0, 256, (MB, 3, RES, RES)).astype(np.uint8),
        "latents_rec_2": r.randn(MB, ZDIM).astype(np.float32),
        "labels_rec_2": np.zeros((MB, 0), np.float32),
        "reals": r.randint(0, 256, (2 * MB, 3, RES, RES)).astype(np.uint8),
        "labels": np.zeros((2 * MB, 0), np.float32),
    }


def _close(port, ref, err_msg=""):
    port = port.detach().numpy() if torch.is_tensor(port) else port
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(port, ref, rtol=2e-3, atol=1e-5 + 2e-3 * scale,
                               err_msg=err_msg)


@pytest.fixture(scope="module")
def iteration():
    """Both packages' states and scalars after each phase of one iteration."""
    G, D, gp, dp, gc, dc = narrow_nets()
    lp = jax.tree_util.tree_map(np.asarray, init_pixel_fallback_params())
    batch = _batch()
    key = jax.random.key(3)

    jstate = j_create(jax.random.key(0), G, D)._replace(
        g_params=gp, d_params=dp, gs_params=jax.tree_util.tree_map(np.copy, gp))
    ph = j_make(G, D, lp, make_data_mesh(1), JTrainConfig(**CFG)).phases
    k1, k2, k3, k4 = jax.random.split(key, 4)
    bg = {k: v for k, v in batch.items() if k.endswith(("_1", "_2"))}
    bd = {"reals": batch["reals"], "labels": batch["labels"]}
    jax_after = []
    for name, fn in (("g_main", lambda s: ph["g_step"](s, bg, k1, jnp.float32(G_LR),
                                                        jnp.float32(2.5))),
                     ("g_reg", lambda s: ph["g_reg_step"](s, k2, jnp.float32(G_LR), MB)),
                     ("d_main", lambda s: ph["d_step"](s, bd, k3, jnp.float32(D_LR),
                                                        jnp.float32(GS_BETA))),
                     ("d_reg", lambda s: ph["d_reg_step"](s, bd, k4, jnp.float32(D_LR),
                                                          jnp.float32(100.0)))):
        jstate, scalars = fn(jstate)
        jax_after.append((jax.device_get(jstate), jax.device_get(scalars)))

    TG, TD = to_port(gc, gp, dc, dp)
    TGs, _ = to_port(gc, gp, dc, dp)
    state = create_train_state(TG, TD, TGs)
    cfg = TrainConfig(**CFG)
    step = make_train_step(TG, TD, lpips_params_from_numpy(lp, "cpu"), cfg,
                           device="cpu", impl="plain")
    draws = jax_draws.to_torch(jax_draws.train_step(G, key, MB))
    tb = step.phases["to_device"](batch)
    port_after = []
    for name, fn in (("g_main", lambda s: step.phases["g_step"](s, tb, draws["g"], G_LR,
                                                                 2.5)),
                     ("g_reg", lambda s: step.phases["g_reg_step"](s, draws["g_reg"], G_LR)),
                     ("d_main", lambda s: step.phases["d_step"](s, tb, draws["d"], D_LR,
                                                                 GS_BETA)),
                     ("d_reg", lambda s: step.phases["d_reg_step"](s, tb, draws["d_reg"],
                                                                   D_LR))):
        state, scalars = fn(state)
        port_after.append((copy.deepcopy(state), scalars))
    return jax_after, port_after, (batch, state, step)


@pytest.mark.parametrize("phase", range(4), ids=[p for p, _ in PHASES])
def test_phase_scalars_and_gradients_match_jax(iteration, phase):
    jax_after, port_after, _ = iteration
    name, opt = PHASES[phase]
    (jstate, jscalars), (state, scalars) = jax_after[phase], port_after[phase]
    assert set(scalars) == set(jscalars)
    for k, v in jscalars.items():
        np.testing.assert_allclose(float(scalars[k]), float(v), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    jm = flat(getattr(jstate, opt).m)
    m = getattr(state, opt).m
    assert set(m) == set(jm)
    for k in m:
        _close(m[k], jm[k], f"{name} gradient of {k}")
    assert int(getattr(state, opt).count) == int(getattr(jstate, opt).count)


def test_state_after_the_iteration_matches_jax(iteration):
    """v, pl_mean, dlatent_avg and the Gs EMA after all four phases."""
    jax_after, port_after, _ = iteration
    jstate, state = jax_after[-1][0], port_after[-1][0]
    for opt in ("g_opt", "d_opt"):
        jv = flat(getattr(jstate, opt).v)
        for k, v in getattr(state, opt).v.items():
            _close(v, jv[k], f"{opt}.v of {k}")
    np.testing.assert_allclose(float(state.pl_mean), float(jstate.pl_mean),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(state.G.dlatent_avg.numpy(),
                               np.asarray(jstate.g_params["dlatent_avg"]),
                               rtol=1e-4, atol=1e-6)
    jgs = flat(jstate.gs_params)
    gs = dict(state.Gs.state_dict())
    assert set(gs) == set(jgs)
    for k, v in gs.items():
        _close(v, jgs[k], f"Gs {k}")
    assert int(state.step) == int(jstate.step) == 1


def test_train_step_runs_all_phases_from_a_generator(iteration):
    """The full ``train_step`` with its own draws: every phase runs, the
    scalars are finite, parameters move and Adam counts each phase."""
    _, _, (batch, state0, step) = iteration
    state = copy.deepcopy(state0)
    w0 = state.D.get_submodule("4x4").Conv.weight.detach().clone()
    state, scalars = step(state, batch, torch.Generator().manual_seed(0), G_LR, D_LR,
                          GS_BETA, do_g_reg=True, do_d_reg=True)
    assert len(scalars) == 11 and all(np.isfinite(float(v)) for v in scalars.values())
    assert int(state.g_opt.count) == int(state0.g_opt.count) + 2
    assert int(state.d_opt.count) == int(state0.d_opt.count) + 2
    assert not torch.equal(state.D.get_submodule("4x4").Conv.weight, w0)
    state, scalars = step(state, batch, torch.Generator().manual_seed(1), G_LR, D_LR,
                          GS_BETA, do_g_reg=False, do_d_reg=False)
    assert "Loss/pl_penalty" not in scalars and int(state.step) == int(state0.step) + 2


def test_adam_matches_jax_and_skips_non_finite_updates():
    rnd = np.random.RandomState(0)
    params = {"a": rnd.randn(3, 4).astype(np.float32),
              "b": rnd.randn(5).astype(np.float16)}
    grads = {"a": rnd.randn(3, 4).astype(np.float32),
             "b": rnd.randn(5).astype(np.float16)}
    hp = dict(learning_rate=0.01, beta1=0.5, beta2=0.9, epsilon=1e-8)
    js = jopt.init_adam(params)
    ts = topt.init_adam({k: torch.from_numpy(v) for k, v in params.items()})
    for _ in range(2):
        jp, js, jok = jopt.adam_apply(params, grads, js, **hp)
        tp, ts, tok = topt.adam_apply({k: torch.from_numpy(v) for k, v in params.items()},
                                      {k: torch.from_numpy(v) for k, v in grads.items()},
                                      ts, **hp)
        assert bool(jok) and bool(tok)
        for k in params:
            assert tp[k].dtype == torch.from_numpy(params[k]).dtype
            np.testing.assert_allclose(tp[k].float().numpy(), np.asarray(jp[k], np.float32),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(ts.m[k].numpy(), np.asarray(js.m[k]), rtol=1e-6)
            np.testing.assert_allclose(ts.v[k].numpy(), np.asarray(js.v[k]), rtol=1e-6)
        params = {k: np.asarray(v) for k, v in jp.items()}
    assert int(ts.count) == int(js.count) == 2
    bad = dict(grads, a=np.where(np.arange(12).reshape(3, 4) == 5, np.inf,
                                 grads["a"]).astype(np.float32))
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    tp, ts2, tok = topt.adam_apply(tparams, {k: torch.from_numpy(v) for k, v in bad.items()},
                                   ts, **hp)
    assert not bool(tok) and not bool(topt.grads_finite(
        {k: torch.from_numpy(v) for k, v in bad.items()}))
    assert int(ts2.count) == 2
    for k in params:
        assert torch.equal(tp[k], tparams[k])
        assert torch.equal(ts2.m[k], ts.m[k]) and torch.equal(ts2.v[k], ts.v[k])


@pytest.mark.parametrize("interval", [4, 16])
def test_lazy_reg_hparams_match_jax(interval):
    assert topt.lazy_reg_hparams(0.002, 0.0, 0.99, interval) == \
        jopt.lazy_reg_hparams(0.002, 0.0, 0.99, interval)


@pytest.mark.parametrize("field,value", [
    ("invariant_rng", True), ("grad_accum_rounds", 2), ("lpips_dtype", torch.bfloat16),
    ("lpips_norm", "trunk"), ("donate_state", True)])
def test_unhonoured_config_fields_raise(field, value):
    with pytest.raises(NotImplementedError, match=field):
        TrainConfig(**{field: value})
    neutral = {"invariant_rng": False, "grad_accum_rounds": 1, "lpips_dtype": None,
               "lpips_norm": "f32", "donate_state": False}[field]
    assert TrainConfig(**{field: neutral}) == TrainConfig()


GOLDEN = "inclusivegan_torch/testdata/celeba128_train_golden.npz"
# Against the JAX golden: loss scalars within 1e-3 relative, each parameter
# tensor's gradient L2 norm within 1e-2 relative (four full-width networks,
# float32 sums in other orders, and after the first phase the Adam step of
# beta1 = 0 moves each weight by +-lr whatever the size of its gradient).
GOLDEN_SCALAR_RTOL = 1e-3
GOLDEN_NORM_RTOL = 1e-2


@pytest.mark.slow
def test_full_width_iteration_matches_jax_golden():
    """CelebA-128 G, D and Gs cast to float32, minibatch 3, the CelebA
    run's perceptual weights and hyperparameters, both regularizers, phase
    by phase against tests/torch_golden/make_train_golden.py's output."""
    import os
    from inclusivegan_torch.models.lpips import load_lpips_params
    from inclusivegan_torch.snapshot import load_networks
    from inclusivegan_torch.training.train_state import create_train_state
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    golden = np.load(os.path.join(root, GOLDEN))
    nets = load_networks(os.path.join(root, str(golden["network"])), device="cpu")
    for net in nets:
        net.float()
    state = create_train_state(*nets)
    cfg = TrainConfig(**eval(str(golden["config"])))
    lpips = load_lpips_params(os.path.join(root, str(golden["lpips"])), "cpu")
    step = make_train_step(nets[0], nets[1], lpips, cfg, device="cpu", impl="plain")
    batch = step.phases["to_device"](
        {k[len("batch/"):]: golden[k] for k in golden.files if k.startswith("batch/")})
    draws = jax_draws.unflatten_draws(
        {k[len("draws/"):]: golden[k] for k in golden.files if k.startswith("draws/")})
    g_lr, d_lr = float(golden["g_lrate"]), float(golden["d_lrate"])
    runs = (("g_main", "g_opt", lambda s: step.phases["g_step"](
                s, batch, draws["g"], g_lr, cfg.NN_rec_lpips_weight)),
            ("g_reg", "g_opt", lambda s: step.phases["g_reg_step"](s, draws["g_reg"], g_lr)),
            ("d_main", "d_opt", lambda s: step.phases["d_step"](
                s, batch, draws["d"], d_lr, float(golden["gs_beta"]))),
            ("d_reg", "d_opt", lambda s: step.phases["d_reg_step"](
                s, batch, draws["d_reg"], d_lr)))
    for phase, opt, run in runs:
        state, scalars = run(state)
        for k, v in scalars.items():
            np.testing.assert_allclose(float(v), float(golden[f"scalar/{phase}/{k}"]),
                                       rtol=GOLDEN_SCALAR_RTOL, err_msg=f"{phase} {k}")
        m = getattr(state, opt).m
        ref = {k[len(f"grad_norm/{phase}/"):]: float(golden[k]) for k in golden.files
               if k.startswith(f"grad_norm/{phase}/")}
        assert set(ref) == set(m)
        for k, g in m.items():
            np.testing.assert_allclose(float(g.double().norm()), ref[k],
                                       rtol=GOLDEN_NORM_RTOL, atol=1e-12,
                                       err_msg=f"{phase} gradient norm of {k}")
    np.testing.assert_allclose(float(state.pl_mean), float(golden["pl_mean"]),
                               rtol=GOLDEN_SCALAR_RTOL)
