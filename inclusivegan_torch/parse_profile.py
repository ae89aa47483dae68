"""Summarize a torch.profiler Chrome trace of the port: where the device's
time went.

Reads a trace that ``torch.profiler``'s ``export_chrome_trace`` wrote: the
training loop's ``<run_dir>/profile/trace.json`` (``enable_profiler``,
iterations 8-16), or ``profile_generate --trace`` / ``profile_train
--trace``. A directory is searched for ``*.json`` traces. Prints:

1. the device-kernel groups of ``profile_generate.GROUPS`` (the port's
   kernels, convolutions, matrix products, copies, the rest) with device
   ms, launches and share of device time, then the top kernels by name;
2. the device's busy share: the union of the device activity (kernels,
   copies and sets) over the window from its first start to its last end;
3. the longest idle gaps between device activity, with where they start.

    python -m inclusivegan_torch.parse_profile RUN_DIR/profile [--top 25] [--gaps 10]
        [--json OUT]
"""

import argparse
import collections
import glob
import gzip
import json
import os
from typing import Dict, List

from .profile_generate import group_of

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _trace_files(path: str) -> List[str]:
    if os.path.isfile(path):
        return [path]
    files = sorted(glob.glob(os.path.join(path, "**", "*.json"), recursive=True) +
                   glob.glob(os.path.join(path, "**", "*.json.gz"), recursive=True))
    if not files:
        raise SystemExit(f"no Chrome trace (*.json) under {path}")
    return files


def _device_events(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events
            if e.get("ph") == "X" and str(e.get("cat", "")).lower() in DEVICE_CATEGORIES]


def summarize(path: str, top_n: int = 25, num_gaps: int = 10) -> Dict:
    """The summary of every trace at ``path`` as a dict (times in ms)."""
    events = [e for f in _trace_files(path) for e in _device_events(f)]
    if not events:
        raise SystemExit(f"{path}: the trace holds no device activity")
    groups = collections.defaultdict(lambda: [0.0, 0])
    names = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        ms = float(e.get("dur", 0.0)) / 1e3
        group = ("memory copy / set" if e["cat"].lower() != "kernel"
                 else group_of(e.get("name", "")))
        for table, key in ((groups, group), (names, e.get("name", "?"))):
            table[key][0] += ms
            table[key][1] += 1
    device_ms = sum(ms for ms, _ in groups.values())

    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                   for e in events)
    busy_us, gaps = 0.0, []
    cur_start, cur_end = spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            busy_us += cur_end - cur_start
            gaps.append((start - cur_end, cur_end))
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy_us += cur_end - cur_start
    window_us = cur_end - spans[0][0]
    gaps.sort(reverse=True)

    def rows(table, n=None):
        items = sorted(table.items(), key=lambda kv: -kv[1][0])[:n]
        return [{"name": k, "ms": ms, "launches": count,
                 "share": ms / device_ms if device_ms else 0.0}
                for k, (ms, count) in items]

    return {"window_ms": window_us / 1e3, "busy_ms": busy_us / 1e3,
            "busy_share": busy_us / window_us if window_us else 1.0,
            "device_ms": device_ms, "groups": rows(groups), "top": rows(names, top_n),
            "gaps": [{"ms": g / 1e3, "at_ms": (at - spans[0][0]) / 1e3}
                     for g, at in gaps[:num_gaps]]}


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m inclusivegan_torch.parse_profile",
        description="Summarize a torch.profiler Chrome trace of the port.")
    parser.add_argument("profile", help="a trace file, or a directory of them")
    parser.add_argument("--top", type=int, default=25)
    parser.add_argument("--gaps", type=int, default=10)
    parser.add_argument("--json", default=None, help="also write the summary as JSON here")
    args = parser.parse_args(argv)
    s = summarize(args.profile, args.top, args.gaps)
    print(f"device busy {s['busy_ms']:.3f} ms of a {s['window_ms']:.3f} ms window "
          f"({s['busy_share']:.1%}); kernel and copy time {s['device_ms']:.3f} ms")
    print("group | device ms | share of device time | launches")
    for r in s["groups"]:
        print(f"{r['name']} | {r['ms']:.3f} | {r['share']:.1%} | {r['launches']}")
    print(f"top {args.top} | device ms | share | launches")
    for r in s["top"]:
        print(f"{r['name'][:90]} | {r['ms']:.3f} | {r['share']:.1%} | {r['launches']}")
    print(f"longest {args.gaps} idle gaps | ms | starts at ms into the window")
    for g in s["gaps"]:
        print(f"gap | {g['ms']:.3f} | {g['at_ms']:.3f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(s, f, indent=1)
        print(f"wrote {args.json}")
    return s


if __name__ == "__main__":
    main()
