"""Timing and bounds of the port's kernels on the card.

``device_ms`` times a call with CUDA events; ``Recorder`` records the
arguments of every call of a kernel wrapper while it is open; ``fir_ops``
and ``fir_bound`` give upfirdn2d's work and the least time an H100 could
take for it; ``time_configs`` and ``print_rows`` time upfirdn2d at each
distinct configuration that a recorder saw, beside its bound, the cuDNN
call that computes the same FIR, and the grid the wrapper launched.
``chip_smoke.py`` measures with these. Importing the module needs no card.
"""

import collections
import math
import statistics

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth and
# float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def device_ms(fn, iters: int = 20, repeats: int = 5) -> float:
    """Median device time of one ``fn()`` in ms. The card first spins on a
    sleep kernel so that the host enqueues all ``iters`` launches before the
    start event runs: the events then time the device, not the host."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms at 2 GHz
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


class Recorder:
    """Records the arguments of every kernel-wrapper call while it is open
    (the wrappers themselves are untouched and still count launches): the
    shape of the input and the arguments that are not tensors, keywords
    included, with taps as tuples so that calls can be told apart; and the
    input dtypes each wrapper saw."""

    def __init__(self, ck, names=("bias_lrelu", "upfirdn2d")):
        self.ck = ck
        self.calls = {name: [] for name in names}
        self.call_dtypes = {name: [] for name in names}  # one per call

    def __enter__(self):
        self.orig = {name: getattr(self.ck, name) for name in self.calls}
        for name, fn in self.orig.items():
            setattr(self.ck, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def call(x, *args, **kwargs):
            key = tuple(tuple(map(tuple, a)) if isinstance(a, np.ndarray)
                        else a for a in args if not hasattr(a, "data_ptr"))
            self.calls[name].append((tuple(x.shape), key + tuple(kwargs.values())))
            self.call_dtypes[name].append(x.dtype)
            return fn(x, *args, **kwargs)
        return call

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.ck, name, fn)

    @property
    def dtypes(self):
        """The input dtypes each wrapper saw."""
        return {name: set(d) for name, d in self.call_dtypes.items()}

    def unique(self, name):
        return list(dict.fromkeys(self.calls[name]))

    def unique_typed(self, name):
        """The distinct (shape, arguments, dtype) of the calls."""
        return list(dict.fromkeys((shape, key, dtype) for (shape, key), dtype
                                  in zip(self.calls[name], self.call_dtypes[name])))


def fir_out_hw(shape, f, up, down, pad):
    kh, kw = np.shape(f)
    padx0, padx1, pady0, pady1 = pad
    return ((shape[2] * up + pady0 + pady1 - kh) // down + 1,
            (shape[3] * up + padx0 + padx1 - kw) // down + 1)


def fir_ops(shape, f, up, down, pad) -> float:
    """Multiply-adds the FIR needs for these inputs: taps that fall on an
    inserted zero or outside the input are not counted."""
    n, c, h, w = shape
    kh, kw = np.shape(f)
    padx0, _, pady0, _ = pad
    oh, ow = fir_out_hw(shape, f, up, down, pad)

    def hits(o, k, size, pad0):
        u = np.arange(o)[:, None] * down + np.arange(k)[None, :] - pad0
        return int(np.sum((u >= 0) & (u < size * up) & (u % up == 0)))

    return 2.0 * n * c * hits(oh, kh, h, pady0) * hits(ow, kw, w, padx0)


def fir_bound(shape, f, up, down, pad, element_size):
    """(bound in ms, "bytes" or "operations"): each input byte read once,
    each output byte written once, against the FIR's operations."""
    oh, ow = fir_out_hw(shape, f, up, down, pad)
    nbytes = shape[0] * shape[1] * (shape[2] * shape[3] + oh * ow) * element_size
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = fir_ops(shape, f, up, down, pad) / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def depthwise_library_call(x, f, up, down, pad, gain):
    """One cuDNN call that computes the same FIR, or None: a depthwise
    ``conv2d`` (up 1, pads equal on both sides of each axis) or
    ``conv_transpose2d`` (down 1, up > 1)."""
    kh, kw = np.shape(f)
    padx0, padx1, pady0, pady1 = pad
    c = x.shape[1]
    oh, ow = fir_out_hw(x.shape, f, up, down, pad)
    if up == 1 and padx0 == padx1 >= 0 and pady0 == pady1 >= 0:
        w = torch.from_numpy(np.ascontiguousarray((f * gain)[::-1, ::-1]))
        w = w.to(device=x.device, dtype=x.dtype)[None, None].repeat(c, 1, 1, 1)
        return lambda: F.conv2d(x, w, stride=down, padding=(pady0, padx0), groups=c)
    if down == 1 and up > 1:
        # y[o] = sum_i x[i] f[o + kh - 1 - pad0 - i*up]: a transposed conv
        # with the unflipped taps and padding kh - 1 - pad0
        py, px = kh - 1 - pady0, kw - 1 - padx0
        opy = oh - ((x.shape[2] - 1) * up - 2 * py + kh)
        opx = ow - ((x.shape[3] - 1) * up - 2 * px + kw)
        if min(py, px, opy, opx) < 0 or max(opy, opx) >= up:
            return None
        w = torch.from_numpy(np.ascontiguousarray(f * gain))
        w = w.to(device=x.device, dtype=x.dtype)[None, None].repeat(c, 1, 1, 1)
        return lambda: F.conv_transpose2d(x, w, stride=up, padding=(py, px),
                                          output_padding=(opy, opx), groups=c)
    return None


def time_configs(ck, calls, gen, log=print):
    """One row per distinct configuration of ``calls``, the upfirdn2d calls
    of a ``Recorder``: launches, kernel ms, bound, cuDNN ms and the launch's
    plan (``cuda_kernels.upfirdn2d_plan``). Returns the rows, largest input
    first."""
    rows = []
    counts = collections.Counter(calls)
    with torch.no_grad():
        for (shape, (f, up, down, pad, gain, counter)), n in sorted(
                counts.items(), key=lambda kv: -math.prod(kv[0][0])):
            f = np.asarray(f, np.float32)
            x = torch.randn(shape, device="cuda", generator=gen)
            kern = lambda: ck.upfirdn2d(x, f, up, down, pad, gain,  # noqa: E731
                                        counter=counter)
            y = kern()
            plan = ck.upfirdn2d_plan(x, f, up, down, pad)
            ms = device_ms(kern)
            bound_ms, bound_by = fir_bound(shape, f, up, down, pad, x.element_size())
            lib = depthwise_library_call(x, f, up, down, pad, gain)
            library_ms = None
            if lib is not None:
                lib_err = (lib() - y).abs().max().item()
                if lib_err > 1e-4 * max(y.abs().max().item(), 1.0):
                    log(f"  cuDNN call differs from the FIR by {lib_err:.3e}; "
                        f"not timed")
                else:
                    library_ms = device_ms(lib)
            rows.append(dict(shape=list(shape), out=list(y.shape[2:]), up=up,
                             down=down, pad=list(pad), taps=list(f.shape),
                             gain=gain, counter=counter, launches=n, ms=ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=library_ms, plan=plan))
            del x, y
    return rows


def plan_summary(shape, plan) -> str:
    """The grid of a launch and, for the tiled kernel, its blocks per SM,
    images per step and steps per block (the most, and the mean)."""
    grid = f"{plan['grid_x']}x{plan['grid_y']}x{plan['grid_z']}"
    if not plan["tiled"]:
        return f"direct {grid}"
    steps = -(-shape[0] * shape[1] // plan["images_per_step"])
    return (f"{grid} {plan['blocks_per_sm']}/SM G{plan['images_per_step']} "
            f"walk {-(-steps // plan['grid_y'])}/{steps / plan['grid_y']:.2f}")


def print_rows(rows, log=print):
    """The rows of ``time_configs``, one line each, then the sums over every
    launch; returns Σ launches × (ms − bound)."""
    log(f"{'input':>20s} {'out':>9s} up dn {'pad':>14s} {'counter':>20s} "
        f"{'n':>3s} {'ms':>8s} {'bound':>8s} {'share':>6s} {'cuDNN':>8s}  launch")
    for r in rows:
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"{str(r['shape']):>20s} {'x'.join(map(str, r['out'])):>9s} "
            f"{r['up']:2d} {r['down']:2d} {str(r['pad']):>14s} {r['counter']:>20s} "
            f"{r['launches']:3d} {r['ms']:8.4f} {r['bound_ms']:8.4f} "
            f"{r['bound_ms'] / r['ms']:6.1%} {lib:>8s}  "
            f"{plan_summary(r['shape'], r['plan'])}")
    launches = sum(r["launches"] for r in rows)
    ms = sum(r["launches"] * r["ms"] for r in rows)
    bound = sum(r["launches"] * r["bound_ms"] for r in rows)
    log(f"{len(rows)} configurations, {launches} launches: Σ launches × ms "
        f"{ms:.4f}, Σ launches × bound {bound:.4f}, Σ launches × (ms − bound) "
        f"{ms - bound:.4f} ms")
    return ms - bound
