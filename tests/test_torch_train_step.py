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
largest entry; pl_mean and dlatent_avg 1e-4 relative + 1e-6. The same holds
from the JAX package's own fresh init carried across, and from float16
trees, as the CelebA snapshot stores its networks and the training loop
resumes them (float16 kept where JAX keeps it).
"""

import copy
import functools
import os

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
from inclusivegan_torch.training.train_state import create_train_state, g_trainables
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


@functools.lru_cache(maxsize=None)
def _jax_phases(G, D):
    lp = jax.tree_util.tree_map(np.asarray, init_pixel_fallback_params())
    return lp, j_make(G, D, lp, make_data_mesh(1), JTrainConfig(**CFG)).phases


def _run_both(G, D, gp, dp, gc, dc):
    """Both packages' states and scalars after each phase of one iteration
    from the parameter trees gp, dp (numpy, in their dtypes)."""
    lp, ph = _jax_phases(G, D)
    batch = _batch()
    key = jax.random.key(3)

    jstate = j_create(jax.random.key(0), G, D)._replace(
        g_params=gp, d_params=dp, gs_params=jax.tree_util.tree_map(np.copy, gp))
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


@pytest.fixture(scope="module")
def iteration():
    """Both packages' states and scalars after each phase of one iteration."""
    G, D, gp, dp, gc, dc = narrow_nets()
    return _run_both(G, D, gp, dp, gc, dc)


def _check_iteration(jax_after, port_after):
    """Every phase's scalars, gradients and Adam count, then v, pl_mean,
    dlatent_avg and the Gs EMA after the iteration, at the tolerances
    above."""
    for phase in range(4):
        test_phase_scalars_and_gradients_match_jax((jax_after, port_after, None), phase)
    test_state_after_the_iteration_matches_jax((jax_after, port_after, None))


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
    ("invariant_rng", True), ("grad_accum_rounds", 2)])
def test_config_takes_rounds_and_invariant_rng(field, value):
    """Both fields of the JAX TrainConfig are honoured; as there, a step
    with invariant_rng and more than one round is refused."""
    cfg = TrainConfig(**{field: value}, gamma=100.0)
    assert getattr(cfg, field) == value and cfg.gamma == 100.0
    assert TrainConfig(**{field: getattr(TrainConfig(), field)}) == TrainConfig()
    G, D, gp, dp, gc, dc = narrow_nets()
    TG, TD = to_port(gc, gp, dc, dp)
    with pytest.raises(AssertionError, match="invariant_rng"):
        make_train_step(TG, TD, None, TrainConfig(invariant_rng=True, grad_accum_rounds=2),
                        device="cpu", impl="plain")


@pytest.mark.parametrize("donate", [False, True])
def test_donate_state_is_accepted_either_way(donate):
    """The JAX training loop always passes donate_state=True; the port
    updates its state in place, so the field changes nothing."""
    assert TrainConfig(donate_state=donate, gamma=100.0) == TrainConfig(gamma=100.0)


def test_jax_initialized_tree_steps_like_jax():
    """The JAX package's own fresh init (zero biases, noise strengths and
    dlatent_avg, N(0, 1) weights) carried into the port: one iteration
    matches JAX's phase by phase, as for the randomized trees above."""
    G, D, _, _, gc, dc = narrow_nets()
    gp = jax.tree_util.tree_map(np.asarray, G.init(jax.random.key(0)))
    dp = jax.tree_util.tree_map(np.asarray, D.init(jax.random.key(2)))
    jax_after, port_after, _ = _run_both(G, D, gp, dp, gc, dc)
    _check_iteration(jax_after, port_after)


def test_float16_trees_step_like_jax_and_stay_float16():
    """G, D and Gs stored in float16, as the CelebA snapshot stores them and
    the training loop resumes them: the iteration matches JAX's, Adam
    rounds G and D back to float16 in both packages, and the Gs EMA comes
    out float32 in both (the float32 beta promotes it)."""
    G, D, gp, dp, gc, dc = narrow_nets()
    gp, dp = (jax.tree_util.tree_map(lambda a: np.asarray(a, np.float16), t)
              for t in (gp, dp))
    jax_after, port_after, _ = _run_both(G, D, gp, dp, gc, dc)
    _check_iteration(jax_after, port_after)
    jstate, state = jax_after[-1][0], port_after[-1][0]
    for module, jtree in ((state.G, jstate.g_params), (state.D, jstate.d_params),
                          (state.Gs, jstate.gs_params)):
        port = dict(module.state_dict())
        for k, v in flat(jtree).items():
            assert str(port[k].dtype) == f"torch.{v.dtype}", k
    for k in g_trainables(dict(state.G.state_dict())):
        assert state.G.state_dict()[k].dtype == torch.float16, k
    assert all(p.dtype == torch.float16 for p in state.D.parameters())
    assert state.Gs.state_dict()["synthesis.4x4.Conv.weight"].dtype == torch.float32


# ---------------------------------------------------------------------------
# Gradient accumulation and invariant_rng against the JAX step, through a
# golden of it (tests/torch_golden/make_step_golden.py: minibatch 4, two
# rounds of 2, and invariant_rng at one round), at the tolerances above.

STEP_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_golden",
                           "step_rounds_invariant_golden.npz")
STEP_CONFIGS = {"rounds": dict(grad_accum_rounds=2), "invariant": dict(invariant_rng=True)}


@pytest.fixture(scope="module")
def golden_iterations():
    """{config: (golden, port states and scalars after each phase)}."""
    from torch_golden.make_step_golden import batch
    golden = np.load(STEP_GOLDEN)
    lp = jax.tree_util.tree_map(np.asarray, init_pixel_fallback_params())
    G, D, gp, dp, gc, dc = narrow_nets()
    out = {}
    for name, kw in STEP_CONFIGS.items():
        TG, TD = to_port(gc, gp, dc, dp)
        TGs, _ = to_port(gc, gp, dc, dp)
        state = create_train_state(TG, TD, TGs)
        step = make_train_step(TG, TD, lpips_params_from_numpy(lp, "cpu"),
                               TrainConfig(**CFG, **kw), device="cpu", impl="plain")
        pre = f"{name}/draws/"
        draws = jax_draws.unflatten_draws(
            {k[len(pre):]: golden[k] for k in golden.files if k.startswith(pre)})
        tb = step.phases["to_device"](batch())
        after = []
        for fn in (lambda s: step.phases["g_step"](s, tb, draws["g"], G_LR, 2.5),
                   lambda s: step.phases["g_reg_step"](s, draws["g_reg"], G_LR),
                   lambda s: step.phases["d_step"](s, tb, draws["d"], D_LR, GS_BETA),
                   lambda s: step.phases["d_reg_step"](s, tb, draws["d_reg"], D_LR)):
            state, scalars = fn(state)
            after.append((copy.deepcopy(state), scalars))
        out[name] = (golden, after)
    return out


@pytest.mark.parametrize("phase", range(4), ids=[p for p, _ in PHASES])
@pytest.mark.parametrize("config", sorted(STEP_CONFIGS))
def test_accumulated_and_invariant_phases_match_jax(golden_iterations, config, phase):
    """Each phase's scalars (averaged over the rounds), gradient (the
    float32 mean of the rounds') and Adam count, against JAX's."""
    golden, after = golden_iterations[config]
    name, opt = PHASES[phase]
    state, scalars = after[phase]
    pre = f"{config}/scalar/{name}/"
    jscalars = {k[len(pre):]: float(golden[k]) for k in golden.files if k.startswith(pre)}
    assert set(scalars) == set(jscalars)
    for k, v in jscalars.items():
        np.testing.assert_allclose(float(scalars[k]), v, rtol=1e-4, atol=1e-5, err_msg=k)
    pre = f"{config}/m/{name}/"
    jm = {k[len(pre):]: golden[k] for k in golden.files if k.startswith(pre)}
    m = getattr(state, opt).m
    assert set(m) == set(jm)
    for k in m:
        _close(m[k], jm[k], f"{config} {name} gradient of {k}")
    assert int(getattr(state, opt).count) == int(golden[f"{config}/count/{name}"])


@pytest.mark.parametrize("config", sorted(STEP_CONFIGS))
def test_accumulated_and_invariant_state_matches_jax(golden_iterations, config):
    """v, pl_mean (threaded through the rounds) and dlatent_avg (the rounds'
    batch averages folded in round order) after the iteration."""
    golden, after = golden_iterations[config]
    state = after[-1][0]
    for opt in ("g_opt", "d_opt"):
        pre = f"{config}/v/{opt}/"
        for k, v in getattr(state, opt).v.items():
            _close(v, golden[pre + k], f"{config} {opt}.v of {k}")
    np.testing.assert_allclose(float(state.pl_mean), float(golden[f"{config}/pl_mean"]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(state.G.dlatent_avg.numpy(), golden[f"{config}/dlatent_avg"],
                               rtol=1e-4, atol=1e-6)
    assert int(state.step) == 1


def test_invariant_draws_concatenate_across_offsets():
    """invariant_rng: the draws of a global batch of 4 at offset 0 are the
    draws at offsets 0 and 2 of two batches of 2, bit for bit (per-example
    leaves concatenated, the batched G noise group by group, the
    path-length examples at offsets 0 and 1); the mixing cutoffs are shared.
    Another generator seed draws other values."""
    from inclusivegan_torch.training.train_step import draw_train_step, flatten_draws
    G, D, gp, dp, gc, dc = narrow_nets()
    TG, _ = to_port(gc, gp, dc, dp)
    cfg = TrainConfig(invariant_rng=True)

    def draws(mb, offset, seed=0):
        return flatten_draws(draw_train_step(TG, mb, torch.Generator().manual_seed(seed),
                                             cfg, example_offset=offset, device="cpu"))

    whole, a, b = draws(4, 0), draws(2, 0), draws(2, 2)
    assert set(whole) == set(a) == set(b)
    for k, w in whole.items():
        if w.ndim == 0:  # a shared cutoff
            assert torch.equal(w, a[k]) and torch.equal(w, b[k]), k
        elif k.startswith("g/noise/"):  # [4 forwards x batch, 1, h, w]
            parts = [torch.cat([x.reshape(4, -1, *x.shape[1:])[f] for x in (a[k], b[k])])
                     for f in range(4)]
            assert torch.equal(w, torch.cat(parts)), k
        else:
            assert torch.equal(w, torch.cat([a[k], b[k]])), k
    other = draws(4, 0, seed=1)
    assert not torch.equal(other["g/arb_latents"], whole["g/arb_latents"])


@pytest.mark.parametrize("do_g_reg,do_d_reg", [(False, True), (True, False), (False, False)])
def test_invariant_draws_skip_the_lazy_phases_and_keep_the_rest(do_g_reg, do_d_reg):
    """invariant_rng: an iteration without a lazy regularizer draws nothing
    for it, and its other draws equal the same keys of an iteration with
    both, bit for bit."""
    from inclusivegan_torch.training.train_step import draw_train_step, flatten_draws
    G, D, gp, dp, gc, dc = narrow_nets()
    TG, _ = to_port(gc, gp, dc, dp)
    cfg = TrainConfig(invariant_rng=True)

    def draws(**flags):
        return flatten_draws(draw_train_step(TG, 4, torch.Generator().manual_seed(0), cfg,
                                             example_offset=2, device="cpu", **flags))

    full, lazy = draws(), draws(do_g_reg=do_g_reg, do_d_reg=do_d_reg)
    skipped = {p for p, on in (("g_reg/", do_g_reg), ("d_reg/", do_d_reg)) if not on}
    assert set(lazy) == {k for k in full if not any(k.startswith(p) for p in skipped)}
    for k, v in lazy.items():
        assert torch.equal(v, full[k]), k


def test_rounds_thread_pl_mean_and_fold_dlatents_in_round_order():
    """Two rounds of the path-length reg: pl_mean after the phase is the
    second round's update of the first round's, and dlatent_avg folds the
    two rounds' batch averages in order; the gradient is the mean of the
    rounds' gradients."""
    from inclusivegan_torch.training.loss import fold_dlatent_avg, g_path_reg
    from inclusivegan_torch.training.train_step import draw_train_step
    G, D, gp, dp, gc, dc = narrow_nets()
    TG, TD = to_port(gc, gp, dc, dp)
    cfg = TrainConfig(grad_accum_rounds=2, **CFG)
    state = create_train_state(TG, TD)
    step = make_train_step(TG, TD, None, cfg, device="cpu", impl="plain")
    draws = draw_train_step(TG, 4, torch.Generator().manual_seed(0), cfg)["g_reg"]
    pl0, avg0 = state.pl_mean.clone(), TG.dlatent_avg.detach().clone()
    tr = g_trainables(dict(TG.named_parameters()))
    pl, bas, grads = pl0, [], []
    for rd in draws["rounds"]:
        reg, pl, _, ba = g_path_reg(TG, draws=rd, pl_mean=pl, label_size=0, impl="plain")
        bas.append(ba.detach())
        grads.append(torch.autograd.grad(reg.mean() * cfg.G_reg_interval,
                                         list(tr.values()), allow_unused=True,
                                         materialize_grads=True))
    want_dl = fold_dlatent_avg(avg0, bas, TG.dlatent_avg_beta)
    state, _ = step.phases["g_reg_step"](state, draws, G_LR)
    assert len(draws["rounds"]) == 2 and float(pl) != float(pl0)
    assert torch.equal(state.pl_mean, pl)
    assert torch.equal(TG.dlatent_avg, want_dl)
    for (k, m), g0, g1 in zip(state.g_opt.m.items(), *grads):
        torch.testing.assert_close(m, (g0.float() + g1.float()) / 2, rtol=0, atol=0,
                                   msg=k)


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
    from inclusivegan_torch.training.train_state import create_train_state, g_trainables
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
