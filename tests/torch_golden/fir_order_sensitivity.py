"""How far the gradients of one full-width G-main phase move when only the
order of the upfirdn2d FIR's float32 sum changes.

Runs the port's plain path on the CPU twice on the inputs of
``inclusivegan_torch/testdata/celeba128_train_golden.npz`` (CelebA-128 G, D
cast to float32, minibatch 3): once with the plain FIR, once with the same
16 products summed in reverse order. Prints the parameters whose gradient
moved most, as a relative L2 change. Both runs are float32-exact to the same
degree, so this is the float32 conditioning of each gradient: a comparison
of two correct implementations cannot be held tighter. Run from the root of
the repository (about a minute, a few GB of memory):

    python tests/torch_golden/fir_order_sensitivity.py
"""

import ast
import copy
import importlib
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def reversed_order_plain(x, f, up, down, pad, gain):
    """``ops/upfirdn2d.py::_upfirdn2d_plain`` with the taps visited last to
    first."""
    padx0, padx1, pady0, pady1 = pad
    n, c, h, w = x.shape
    kh, kw = f.shape
    if up > 1:
        x = x.reshape(n, c, h, 1, w, 1)
        x = F.pad(x, [0, up - 1, 0, 0, 0, up - 1]).reshape(n, c, h * up, w * up)
    x = F.pad(x, [max(padx0, 0), max(padx1, 0), max(pady0, 0), max(pady1, 0)])
    x = x[:, :, max(-pady0, 0): x.shape[2] - max(-pady1, 0),
          max(-padx0, 0): x.shape[3] - max(-padx1, 0)]
    k = f * gain
    oh, ow = x.shape[2] - kh + 1, x.shape[3] - kw + 1
    y = torch.zeros((n, c, oh, ow), dtype=x.dtype, device=x.device)
    for i in reversed(range(kh)):
        for j in reversed(range(kw)):
            y = y + x[:, :, i:i + oh, j:j + ow] * float(k[kh - 1 - i, kw - 1 - j])
    return y[:, :, ::down, ::down]


def main():
    sys.path.insert(0, ROOT)
    from inclusivegan_torch.models.lpips import load_lpips_params
    from inclusivegan_torch.snapshot import load_networks
    from inclusivegan_torch.training.train_state import create_train_state
    from inclusivegan_torch.training.train_step import (TrainConfig, make_train_step,
                                                        unflatten_draws)
    ufd = importlib.import_module("inclusivegan_torch.ops.upfirdn2d")
    golden = np.load(os.path.join(ROOT, "inclusivegan_torch", "testdata",
                                  "celeba128_train_golden.npz"))
    nets = load_networks(os.path.join(ROOT, str(golden["network"])), device="cpu")
    for net in nets:
        net.float()
    state0 = create_train_state(*nets)
    cfg = TrainConfig(**ast.literal_eval(str(golden["config"])))
    lpips = load_lpips_params(os.path.join(ROOT, str(golden["lpips"])), "cpu")
    step = make_train_step(nets[0], nets[1], lpips, cfg, device="cpu", impl="plain")
    batch = step.phases["to_device"](
        {k[len("batch/"):]: golden[k] for k in golden.files if k.startswith("batch/")})
    draws = unflatten_draws(
        {k[len("draws/"):]: golden[k] for k in golden.files if k.startswith("draws/")})
    grads = {}
    plain = ufd._upfirdn2d_plain
    for name, fir in (("plain order", plain), ("reversed order", reversed_order_plain)):
        ufd._upfirdn2d_plain = fir
        state, _ = step.phases["g_step"](copy.deepcopy(state0), batch, draws["g"], 0.0,
                                         cfg.NN_rec_lpips_weight)
        grads[name] = state.g_opt.m
    ufd._upfirdn2d_plain = plain
    a, b = grads["plain order"], grads["reversed order"]
    moved = sorted(((b[k] - a[k]).double().norm().item() / a[k].double().norm().item(), k)
                   for k in a)
    for change, k in moved[-8:]:
        print(f"{k}: relative L2 change {change:.3e}")


if __name__ == "__main__":
    main()
