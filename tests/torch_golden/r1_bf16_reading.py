"""Where R1's bfloat16 gradient lies from float64, in the port and in the
JAX package.

On the narrow 16 px networks of ``tests/test_torch_bf16.py``
(``narrow_nets.py``), its batch and its R1 draws (``jax.random.key(3)``'s
fourth phase key), one R1 phase (``d_reg_step``: gamma 100, mirror augment,
the gradient of ``reg.mean() * D_reg_interval``) is run from the narrow D's
parameters three times:

- the JAX package with D computing in bfloat16;
- the port with D computing in bfloat16 (torch's bf16 convolutions as
  float32 sums rounded to bf16, as the test runs them: torch's CPU bf16
  convolution has a wrong double backward, ``ROADMAP.md`` queue 3 item 8);
- the port's plain path with D's parameters and activations in float64,
  the yardstick (the port's float32 equals the JAX package's float32).

It prints the relative L2 distance from float64 of each bf16 gradient, per
tensor and over the whole gradient, and their distance from each other.
``reading()`` returns them for ``tests/test_torch_bf16.py``. Run from the
root of the repository (about 15 s on the CPU):

    python tests/torch_golden/r1_bf16_reading.py
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

import inclusivegan_torch.models.stylegan2 as tsg  # noqa: E402
from inclusivegan_tpu.parallel import make_data_mesh  # noqa: E402
from inclusivegan_tpu.training.train_state import create_train_state as j_create  # noqa: E402
from inclusivegan_tpu.training.train_step import TrainConfig as JTrainConfig  # noqa: E402
from inclusivegan_tpu.training.train_step import make_train_step as j_make  # noqa: E402
from inclusivegan_torch.training.loss import d_r1_reg  # noqa: E402
from inclusivegan_torch.training.train_step import _process_reals  # noqa: E402
from torch_golden import jax_draws  # noqa: E402
from torch_golden.narrow_nets import RES, flat, narrow_nets, to_port  # noqa: E402

MB = 2
GAMMA = 100.0
D_REG_INTERVAL = 16


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _reals_and_labels():
    """The D batch of ``test_torch_bf16.py::_batch``."""
    r = np.random.RandomState(0)
    for shape in ((MB, 3, RES, RES), (MB, 16), (MB, 3, RES, RES), (MB, 16)):
        (r.randint(0, 256, shape) if len(shape) == 4 else r.randn(*shape))
    reals = r.randint(0, 256, (2 * MB, 3, RES, RES)).astype(np.uint8)
    return reals, np.zeros((2 * MB, 0), np.float32)


def _f32_sums(fn):
    def call(x, w, *a, **k):
        if x.dtype == torch.bfloat16:
            return fn(x.float(), w.float(), *a, **k).to(torch.bfloat16)
        return fn(x, w, *a, **k)
    return call


def _jax_bf16(G, D, dp, reals, labels):
    import dataclasses
    JD = dataclasses.replace(D, dtype=jnp.bfloat16)
    ph = j_make(G, JD, None, make_data_mesh(1),
                JTrainConfig(gamma=GAMMA, mirror_augment=True)).phases
    _, _, _, k4 = jax.random.split(jax.random.key(3), 4)
    state = j_create(jax.random.key(0), G, JD)._replace(d_params=dp)
    state, _ = ph["d_reg_step"](state, {"reals": reals, "labels": labels}, k4,
                                jnp.float32(0.002), jnp.float32(GAMMA))
    return {k: np.asarray(v, np.float64) for k, v in flat(state.d_opt.m).items()}


def _port(dc, dp, gc, gp, reals, labels, flip, dtype):
    """R1's gradient through the port's plain path, D in ``dtype``."""
    _, D = to_port(gc, gp, dc, dp)
    if dtype == torch.float64:
        D = D.double()
    tsg.set_compute_dtype(D, dtype)
    x = _process_reals(torch.from_numpy(reals.copy()), torch.from_numpy(flip), True, [0, 255])
    params = dict(D.named_parameters())
    patch = {}
    if dtype == torch.bfloat16:
        for fn in ("conv2d", "conv_transpose2d"):
            patch[fn] = getattr(torch.nn.functional, fn)
            setattr(torch.nn.functional, fn, _f32_sums(patch[fn]))
    try:
        reg, _ = d_r1_reg(D, reals=x, labels=torch.from_numpy(labels), gamma=GAMMA,
                          impl="plain")
        grads = torch.autograd.grad(reg.mean() * D_REG_INTERVAL, list(params.values()),
                                    allow_unused=True, materialize_grads=True)
    finally:
        for fn, orig in patch.items():
            setattr(torch.nn.functional, fn, orig)
    return {k: g.detach().double().numpy() for k, g in zip(params, grads)}


def _whole(grads):
    return np.concatenate([grads[k].ravel() for k in sorted(grads)])


def reading():
    """{"per_tensor": {name: (port bf16, JAX bf16) relative L2 from float64},
    "whole": (port, JAX), "port_vs_jax": whole relative L2 of the port's bf16
    gradient from the JAX package's}."""
    G, D, gp, dp, gc, dc = narrow_nets()
    reals, labels = _reals_and_labels()
    draws = jax_draws.train_step(G, jax.random.key(3), MB)
    flip = np.asarray(draws["d_reg"]["flip"], np.float32).reshape(-1)
    j16 = _jax_bf16(G, D, dp, reals, labels)
    p16 = _port(dc, dp, gc, gp, reals, labels, flip, torch.bfloat16)
    p64 = _port(dc, dp, gc, gp, reals, labels, flip, torch.float64)
    assert set(j16) == set(p16) == set(p64)
    per_tensor = {k: (rel_l2(p16[k], p64[k]), rel_l2(j16[k], p64[k])) for k in sorted(p64)}
    whole64 = _whole(p64)
    return {"per_tensor": per_tensor,
            "whole": (rel_l2(_whole(p16), whole64), rel_l2(_whole(j16), whole64)),
            "port_vs_jax": rel_l2(_whole(p16), _whole(j16))}


def main():
    r = reading()
    print(f"{'parameter':40s} {'port bf16':>10s} {'JAX bf16':>10s}  (relative L2 from float64)")
    for k, (p, j) in r["per_tensor"].items():
        print(f"{k:40s} {p:10.3e} {j:10.3e}")
    p, j = r["whole"]
    print(f"{'whole gradient':40s} {p:10.3e} {j:10.3e}  ratio {p / j:.3f}")
    print(f"port bf16 from JAX bf16, whole gradient: {r['port_vs_jax']:.3e}")


if __name__ == "__main__":
    main()
