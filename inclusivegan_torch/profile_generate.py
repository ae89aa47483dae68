"""Where the time of generate-images goes on the card.

Runs ``generate_images`` on a snapshot under ``torch.profiler`` after a
warm-up and prints the wall time, the device's busy share (the summed time of
the kernels over the wall time of the window) and the kernels by device time,
grouped into the port's two kernels, convolutions, matrix products and the
rest. Needs one CUDA card.

    python -m inclusivegan_torch.profile_generate \
        [--network artifacts/celeba_best_weights_fp16.pkl] \
        [--minibatch-size 16] [--batches 4] [--impl cuda|plain] \
        [--trace generate_trace.json]
"""

import argparse
import collections
import os
import time

import torch

from .run_generator import generate_images
from .snapshot import load_snapshot

GROUPS = (  # first match wins, on the lower-cased kernel name
    ("bias_lrelu_grad kernel", ("bias_lrelu_grad",)),
    ("bias_lrelu kernel", ("bias_lrelu",)),
    ("upfirdn2d kernel", ("upfirdn2d",)),
    ("convolution", ("conv", "xmma", "implicit", "winograd", "fft", "dgrad")),
    ("matrix product", ("gemm", "gemv", "cublas", "cutlass")),
    ("memory copy / set", ("memcpy", "memset")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other elementwise / reduction"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--network", default="artifacts/celeba_best_weights_fp16.pkl")
    parser.add_argument("--minibatch-size", type=int, default=16)
    parser.add_argument("--batches", type=int, default=4)
    parser.add_argument("--impl", default="cuda", choices=("cuda", "plain"))
    parser.add_argument("--trace", default=None,
                        help="write a Chrome trace of the window here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_generate needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    G = load_snapshot(args.network, device="cuda")
    mb, n = args.minibatch_size, args.minibatch_size * args.batches
    for _ in range(2):
        generate_images(G, mb, mb, impl=args.impl)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        generate_images(G, n, mb, impl=args.impl)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)

    print(f"{torch.cuda.get_device_name(0)}: generate-images impl={args.impl}, "
          f"{args.batches} minibatches of {mb}")
    print(f"wall {wall_ms:.3f} ms ({n / wall_ms * 1e3:.2f} images/s)")
    report(prof, wall_ms, args.trace)


def report(prof, wall_ms: float, trace=None) -> None:
    """Print the device's busy share of ``wall_ms`` and the kernels' device
    time by group and by name; write a Chrome trace when asked."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise SystemExit("the profiler saw no device time")
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"device busy {device_ms:.3f} ms = {device_ms / wall_ms:.1%} of the "
          f"wall time {wall_ms:.3f} ms")
    groups = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        g = groups[group_of(e.key)]
        g[0] += e.self_device_time_total / 1e3
        g[1] += e.count
    print("group | device ms | share of device time | launches")
    for name, (ms, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"{name} | {ms:.3f} | {ms / device_ms:.1%} | {count}")
    print("top kernels | device ms | launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"{e.key[:90]} | {e.self_device_time_total / 1e3:.3f} | {e.count}")
    if trace:
        os.makedirs(os.path.dirname(trace) or ".", exist_ok=True)
        prof.export_chrome_trace(trace)
        print(f"trace written to {trace}")


if __name__ == "__main__":
    main()
