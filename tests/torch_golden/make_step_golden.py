"""Write the goldens of one JAX training iteration of the narrow 16 px
networks (``narrow_nets.py``), both lazy regularizers, phase by phase, in
four configurations of the JAX ``TrainConfig`` at a global minibatch of 4:

- ``step_rounds_invariant_golden.npz``, on a one-device CPU mesh:
  ``rounds``, ``grad_accum_rounds=2`` (two rounds of 2; D main then sees 4
  fakes per round, two minibatch-stddev groups of 2), and ``invariant``,
  ``invariant_rng=True``;
- ``step_dp2_golden.npz``, on a two-device CPU mesh (2 examples per
  device): ``dp2``, the default config, and ``dp2_invariant``,
  ``invariant_rng=True``.

Each runs through the JAX ``make_train_step`` with gamma 100, mirror
augment, the pixel-pyramid LPIPS, learning rates 0.002, Gs beta 0.99 and the
step key ``jax.random.key(3)``, as ``tests/test_torch_train_step.py`` runs
one iteration. A file holds the batch (numpy seed 0) and, per
configuration, every draw re-derived from the keys on each device
(``jax_draws.train_step_rounds``, ``train_step`` and
``train_step_invariant``, in the port's layout; under ``draws<d>/`` for
device d of the two-device mesh), each phase's loss scalars, first Adam
moment (with beta1 = 0, the phase's gradient, averaged over the devices) and
Adam count, and after the iteration the second moments, pl_mean and
dlatent_avg. The tests compare the port with them, so that they do not
compile the JAX step (minutes on the CPU). Run it from the root of the
repository, with JAX on the CPU (about two minutes a file); name the files
to write, or none for both:

    python tests/torch_golden/make_step_golden.py [step_dp2_golden.npz ...]
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
MB = 4
G_LR = D_LR = 0.002
GS_BETA = 0.99
GAMMA = 100.0
STEP_KEY = 3
# file -> (mesh devices, {configuration: TrainConfig fields})
FILES = {
    "step_rounds_invariant_golden.npz": (1, {"rounds": dict(grad_accum_rounds=2),
                                             "invariant": dict(invariant_rng=True)}),
    "step_dp2_golden.npz": (2, {"dp2": {}, "dp2_invariant": dict(invariant_rng=True)}),
}


def batch(mb=MB, seed=0):
    """The iteration's inputs, numpy (the tests make the same)."""
    from torch_golden.narrow_nets import RES, ZDIM
    r = np.random.RandomState(seed)
    return {
        "reals_rec_1": r.randint(0, 256, (mb, 3, RES, RES)).astype(np.uint8),
        "latents_rec_1": r.randn(mb, ZDIM).astype(np.float32),
        "labels_rec_1": np.zeros((mb, 0), np.float32),
        "reals_rec_2": r.randint(0, 256, (mb, 3, RES, RES)).astype(np.uint8),
        "latents_rec_2": r.randn(mb, ZDIM).astype(np.float32),
        "labels_rec_2": np.zeros((mb, 0), np.float32),
        "reals": r.randint(0, 256, (2 * mb, 3, RES, RES)).astype(np.uint8),
        "labels": np.zeros((2 * mb, 0), np.float32),
    }


def main(names):
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    sys.path.insert(0, ROOT)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)
    for name in names or FILES:
        write(name, *FILES[name])


def write(file_name, num_devices, configs):
    import jax
    import jax.numpy as jnp

    from inclusivegan_tpu.models.lpips import init_pixel_fallback_params
    from inclusivegan_tpu.parallel import make_data_mesh
    from inclusivegan_tpu.training.train_state import create_train_state
    from inclusivegan_tpu.training.train_step import TrainConfig, make_train_step
    from torch_golden import jax_draws
    from torch_golden.narrow_nets import flat, narrow_nets

    G, D, gp, dp, _, _ = narrow_nets()
    lp = jax.tree_util.tree_map(np.asarray, init_pixel_fallback_params())
    b = batch()
    key = jax.random.key(STEP_KEY)
    out = {f"batch/{k}": v for k, v in b.items()}
    for name, kw in configs.items():
        cfg = TrainConfig(gamma=GAMMA, mirror_augment=True, **kw)
        ph = make_train_step(G, D, lp, make_data_mesh(num_devices), cfg).phases
        state = create_train_state(jax.random.key(0), G, D)._replace(
            g_params=gp, d_params=dp, gs_params=jax.tree_util.tree_map(np.copy, gp))
        k1, k2, k3, k4 = jax.random.split(key, 4)
        bg = {k: v for k, v in b.items() if k.endswith(("_1", "_2"))}
        bd = {"reals": b["reals"], "labels": b["labels"]}
        for phase, opt, fn in (
                ("g_main", "g_opt", lambda s: ph["g_step"](
                    s, bg, k1, jnp.float32(G_LR), jnp.float32(2.5))),
                ("g_reg", "g_opt", lambda s: ph["g_reg_step"](
                    s, k2, jnp.float32(G_LR), MB // num_devices)),
                ("d_main", "d_opt", lambda s: ph["d_step"](
                    s, bd, k3, jnp.float32(D_LR), jnp.float32(GS_BETA))),
                ("d_reg", "d_opt", lambda s: ph["d_reg_step"](
                    s, bd, k4, jnp.float32(D_LR), jnp.float32(GAMMA)))):
            state, scalars = jax.device_get(fn(state))
            for k, v in scalars.items():
                out[f"{name}/scalar/{phase}/{k}"] = np.float32(v)
            for k, v in flat(getattr(state, opt).m).items():
                out[f"{name}/m/{phase}/{k}"] = v
            out[f"{name}/count/{phase}"] = np.int32(getattr(state, opt).count)
        for opt in ("g_opt", "d_opt"):
            for k, v in flat(getattr(state, opt).v).items():
                out[f"{name}/v/{opt}/{k}"] = v
        out[f"{name}/pl_mean"] = np.float32(state.pl_mean)
        out[f"{name}/dlatent_avg"] = np.asarray(state.g_params["dlatent_avg"])
        if name == "rounds":
            per_device = [jax_draws.train_step_rounds(G, key, MB, 2)]
        else:
            draw = (jax_draws.train_step_invariant if cfg.invariant_rng
                    else jax_draws.train_step)
            per_device = [draw(G, key, MB // num_devices, device=d)
                          for d in range(num_devices)]
        for d, draws in enumerate(per_device):
            at = f"{name}/draws/" if num_devices == 1 else f"{name}/draws{d}/"
            for k, v in jax_draws.flatten_draws(draws).items():
                out[at + k] = np.asarray(v)
        print(name, "done", flush=True)
    path = os.path.join(HERE, file_name)
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main(sys.argv[1:])
