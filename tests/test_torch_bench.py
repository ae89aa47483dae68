"""The measuring helpers that need no card: the FIR's operation count and
bound, the recorder of wrapper calls and the summary of a launch plan
(``inclusivegan_torch/ops/bench.py``), and the profilers' grouping of the
port's kernels by name."""

import re
import types

import numpy as np
import pytest
import torch

from inclusivegan_torch.ops import bench, build, setup_filter
from inclusivegan_torch.profile_generate import group_of
from inclusivegan_torch.ops.upfirdn2d import _upfirdn2d_plain


@pytest.mark.parametrize("shape,up,down,pad,taps", [
    ((2, 3, 9, 9), 1, 1, (1, 1, 1, 1), 4),
    ((2, 3, 8, 8), 2, 1, (2, 1, 2, 1), 4),
    ((1, 2, 16, 16), 1, 2, (1, 1, 1, 1), 4),
    ((1, 2, 7, 5), 2, 1, (1, -1, 2, 0), 4),
    ((1, 1, 11, 13), 3, 2, (3, 2, 3, 2), 6),
])
def test_fir_ops_counts_the_taps_that_meet_input(shape, up, down, pad, taps):
    """With ones for input and taps, each output is the number of taps that
    meet an input sample; the count is twice their sum (a multiply and an
    add each)."""
    f = np.ones((taps, taps), np.float32)
    y = _upfirdn2d_plain(torch.ones(shape), f, up, down, pad, 1.0)
    assert bench.fir_ops(shape, f, up, down, pad) == 2.0 * float(y.sum())
    assert tuple(y.shape[2:]) == bench.fir_out_hw(shape, f, up, down, pad)


def test_fir_bound_is_the_larger_of_bytes_and_operations():
    shape, f, pad = (24, 128, 129, 129), setup_filter([1, 3, 3, 1]), (1, 1, 1, 1)
    ms, by = bench.fir_bound(shape, f, 1, 1, pad, 4)
    nbytes = 24 * 128 * (129 * 129 + 128 * 128) * 4
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * nbytes / bench.HBM_BYTES_PER_S)
    assert ms > 1e3 * bench.fir_ops(shape, f, 1, 1, pad) / bench.F32_OPS_PER_S


def test_recorder_records_calls_and_restores_the_wrappers():
    def upfirdn2d(x, f, up, down, pad, gain, counter="upfirdn2d"):
        return x

    ck = types.SimpleNamespace(upfirdn2d=upfirdn2d)
    f = np.ones((2, 2), np.float32)
    x = torch.zeros(1, 2, 3, 3)
    with bench.Recorder(ck, ("upfirdn2d",)) as rec:
        ck.upfirdn2d(x, f, 2, 1, (1, 0, 1, 0), 4.0)
        ck.upfirdn2d(x, f, 2, 1, (1, 0, 1, 0), 4.0)
        ck.upfirdn2d(x, f, 1, 1, (0, 0, 0, 0), 1.0, counter="upfirdn2d_transposed")
    assert ck.upfirdn2d is upfirdn2d
    key = ((1.0, 1.0), (1.0, 1.0))
    assert rec.unique("upfirdn2d") == [
        ((1, 2, 3, 3), (key, 2, 1, (1, 0, 1, 0), 4.0)),
        ((1, 2, 3, 3), (key, 1, 1, (0, 0, 0, 0), 1.0, "upfirdn2d_transposed"))]
    assert len(rec.calls["upfirdn2d"]) == 3


def test_plan_summary():
    plan = dict(tiled=1, grid_x=4, grid_y=165, grid_z=1, threads=256, smem_bytes=38080,
                sms=132, blocks_per_sm=5, images_per_step=1, tile_rows=32, tile_cols=128)
    assert bench.plan_summary((4, 128, 129, 129), plan) == "4x165x1 5/SM G1 walk 4/3.10"
    plan.update(tiled=0, grid_x=1, grid_y=1, grid_z=2)
    assert bench.plan_summary((1, 5, 19, 21), plan) == "direct 1x1x2"


KERNELS = sorted({name for src in build.CSRC.glob("*.cu")
                  for name in re.findall(
                      r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                      src.read_text())})


def test_every_kernel_source_is_scanned():
    assert {"bias_lrelu_kernel", "bias_lrelu_grad_kernel", "upfirdn2d_tiled_kernel",
            "upfirdn2d_direct_kernel"} <= set(KERNELS)


@pytest.mark.parametrize("name", KERNELS)
def test_profilers_group_each_port_kernel_as_its_own(name):
    """A kernel's device time is counted under its wrapper's group, as the
    profiler shows the name: templated, in an anonymous namespace."""
    group = next(g for g in ("bias_lrelu_grad", "bias_lrelu", "upfirdn2d")
                 if name.startswith(g))
    shown = f"void (anonymous namespace)::{name}<float, 1, 1, 4>(float const*, float*)"
    assert group_of(shown) == f"{group} kernel"
