"""Write ``inclusivegan_torch/testdata/celeba128_train_golden.npz``: one JAX
training iteration of the CelebA-128 config-e-Gskip-Dresnet networks, with
both lazy regularizers, phase by phase.

Inputs: G, D and Gs of ``artifacts/celeba_best_weights_fp16.pkl``, cast to
float32 (so that float16 gradient rounding does not set the comparison's
tolerance), the perceptual weights ``artifacts/celeba_perceptual_vgg.npz``,
minibatch 3 (D main then sees 6 fakes, one full minibatch-stddev group of 6,
so fakes and reals share one D call), uint8 reals and rec latents from
numpy seed 0, the hyperparameters of ``scripts/run_celeba_quality_loop.sh``
(gamma 100, mirror augment, rec weight 2.5, lazy intervals 4 and 16) and the
step key ``jax.random.key(1)``.

The learning rates are 0, so that every phase takes its gradient at the
snapshot's weights. With beta1 = 0, Adam's first step moves each weight by
lr times the sign of its gradient, whatever the gradient's size; where a
gradient is near 0 that sign is float noise, and the next phase's gradients
would then differ between two correct implementations by more than their
float error (2% on a noise strength at lr 0.002, seen on the CPU).

The phases run one at a time through the JAX ``make_train_step`` on a
one-device CPU mesh. After each, the first Adam moment is read: with
beta1 = 0 it is the phase's gradient. The file holds the batch, every draw
re-derived from the keys (``jax_draws.train_step``, in the port's layout),
each phase's loss scalars, each parameter tensor's gradient L2 norm per
phase, and pl_mean after the iteration. Run it from the root of the
repository, with JAX on the CPU (a few minutes, a few GB of memory):

    python tests/torch_golden/make_train_golden.py [OUT.npz]

It imports JAX and the JAX package, so it lives outside
``inclusivegan_torch``, which holds only the .npz it writes.
"""

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
NETWORK = os.path.join("artifacts", "celeba_best_weights_fp16.pkl")
LPIPS = os.path.join("artifacts", "celeba_perceptual_vgg.npz")
OUT = os.path.join(ROOT, "inclusivegan_torch", "testdata",
                   "celeba128_train_golden.npz")
MINIBATCH = 3
SEED = 0
STEP_KEY = 1
G_LRATE = D_LRATE = 0.0
G_SMOOTHING_KIMG = 10.0
CONFIG = dict(gamma=100.0, mirror_augment=True, NN_rec_lpips_weight=2.5,
              G_reg_interval=4, D_reg_interval=16)


def make_batch(mb, res, z, label_size, seed=SEED):
    rnd = np.random.RandomState(seed)
    return {
        "reals_rec_1": rnd.randint(0, 256, (mb, 3, res, res)).astype(np.uint8),
        "latents_rec_1": rnd.randn(mb, z).astype(np.float32),
        "labels_rec_1": np.zeros((mb, label_size), np.float32),
        "reals_rec_2": rnd.randint(0, 256, (mb, 3, res, res)).astype(np.uint8),
        "latents_rec_2": rnd.randn(mb, z).astype(np.float32),
        "labels_rec_2": np.zeros((mb, label_size), np.float32),
        "reals": rnd.randint(0, 256, (2 * mb, 3, res, res)).astype(np.uint8),
        "labels": np.zeros((2 * mb, label_size), np.float32),
    }


def grad_norms(m):
    """{"a.b.c": |m[a][b][c]|_2} over a gradient tree."""
    import jax
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(m)[0]:
        out[".".join(k.key for k in path)] = float(np.linalg.norm(
            np.asarray(leaf, np.float64).ravel()))
    return out


def main(out=OUT):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.dirname(HERE))
    from inclusivegan_tpu.models.lpips import load_lpips_params
    from inclusivegan_tpu.parallel import make_data_mesh
    from inclusivegan_tpu.training.train_state import create_train_state
    from inclusivegan_tpu.training.train_step import TrainConfig, make_train_step
    from inclusivegan_tpu.training.training_loop import load_snapshot
    from torch_golden import jax_draws

    t0 = time.time()
    G, D, params = load_snapshot(os.path.join(ROOT, NETWORK))
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), params)
    state = create_train_state(jax.random.key(SEED), G, D)._replace(**params)
    lpips_params = load_lpips_params(os.path.join(ROOT, LPIPS))
    cfg = TrainConfig(**CONFIG)
    step = make_train_step(G, D, lpips_params, make_data_mesh(1), cfg)
    ph = step.phases
    res = G.synthesis.resolution
    batch = make_batch(MINIBATCH, res, G.mapping.latent_size, G.mapping.label_size)
    batch_g = {k: v for k, v in batch.items() if k.endswith(("_1", "_2"))}
    batch_d = {"reals": batch["reals"], "labels": batch["labels"]}
    gs_beta = 0.5 ** (MINIBATCH / (G_SMOOTHING_KIMG * 1000.0))
    key = jax.random.key(STEP_KEY)
    k1, k2, k3, k4 = jax.random.split(key, 4)

    record = {}

    def keep(phase, state, scalars, opt):
        for name, v in scalars.items():
            record[f"scalar/{phase}/{name}"] = np.float64(v)
        for name, v in grad_norms(getattr(state, opt).m).items():
            record[f"grad_norm/{phase}/{name}"] = np.float64(v)
        print(f"[{time.time() - t0:6.1f}s] {phase}: "
              + ", ".join(f"{k} {float(v):.6g}" for k, v in scalars.items()),
              flush=True)

    state, s = ph["g_step"](state, batch_g, k1, jnp.float32(G_LRATE),
                            jnp.float32(cfg.NN_rec_lpips_weight))
    keep("g_main", state, s, "g_opt")
    state, s = ph["g_reg_step"](state, k2, jnp.float32(G_LRATE), MINIBATCH)
    keep("g_reg", state, s, "g_opt")
    state, s = ph["d_step"](state, batch_d, k3, jnp.float32(D_LRATE),
                            jnp.float32(gs_beta))
    keep("d_main", state, s, "d_opt")
    state, s = ph["d_reg_step"](state, batch_d, k4, jnp.float32(D_LRATE),
                                jnp.float32(cfg.gamma))
    keep("d_reg", state, s, "d_opt")
    record["pl_mean"] = np.float64(state.pl_mean)

    draws = jax_draws.flatten_draws(jax_draws.train_step(G, key, MINIBATCH))
    np.savez_compressed(
        out, **record, **{f"batch/{k}": v for k, v in batch.items()},
        **{f"draws/{k}": np.asarray(v, np.int64 if np.ndim(v) == 0 else np.float32)
           for k, v in draws.items()},
        network=NETWORK, lpips=LPIPS, minibatch=MINIBATCH, g_lrate=G_LRATE,
        d_lrate=D_LRATE, gs_beta=gs_beta, config=repr(CONFIG))
    print(f"wrote {out} ({os.path.getsize(out) / 1e6:.2f} MB) in "
          f"{time.time() - t0:.0f} s")


if __name__ == "__main__":
    main(*sys.argv[1:2])
