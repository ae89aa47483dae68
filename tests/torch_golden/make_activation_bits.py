"""Write ``inclusivegan_torch/testdata/activation_bits.npz``: the JAX
package's ``fused_bias_act`` with ``act="sigmoid"`` and ``act="swish"`` in
bfloat16 and float16, on the CPU, as the bits of each output value.

Inputs: ``x`` [4, 32, 16, 16] and the bias ``b`` [32], standard normal from
``np.random.RandomState(0)`` and ``(1)``, stored in float32 beside the
outputs; each is rounded to the dtype before the call. Keys: ``x``, ``b``,
``<act>/<dtype>`` (uint16, the output's bits). ``chip_smoke.py`` holds the
card's result against them; ``tests/test_torch_ops.py`` holds the port's
CPU result and the JAX package's against them.

    python tests/torch_golden/make_activation_bits.py [OUT.npz]

This script imports JAX, so it lives outside ``inclusivegan_torch``.
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(ROOT, "inclusivegan_torch", "testdata", "activation_bits.npz")
ACTS = ("sigmoid", "swish")
DTYPES = ("bfloat16", "float16")
SHAPE = (4, 32, 16, 16)


def inputs():
    x = np.random.RandomState(0).randn(*SHAPE).astype(np.float32)
    b = np.random.RandomState(1).randn(SHAPE[1]).astype(np.float32)
    return x, b


def jax_bits(x, b, act, dtype):
    import jax.numpy as jnp
    from inclusivegan_tpu.ops import fused_bias_act
    jdt = getattr(jnp, dtype)
    y = fused_bias_act(jnp.asarray(x).astype(jdt), jnp.asarray(b).astype(jdt), act=act)
    return np.asarray(y).view(np.uint16)


def main(out=OUT):
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    x, b = inputs()
    arrays = {"x": x, "b": b}
    for act in ACTS:
        for dtype in DTYPES:
            arrays[f"{act}/{dtype}"] = jax_bits(x, b, act, dtype)
    np.savez_compressed(out, **arrays)
    print(f"wrote {out}")


if __name__ == "__main__":
    main(*sys.argv[1:])
