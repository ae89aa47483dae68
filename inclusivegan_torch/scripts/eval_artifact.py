#!/usr/bin/env python3
"""Measure the best-weights artifact on the card and record the result: the
port's ``scripts/eval_artifact.py``, with its flags, defaults and record.

It restores ``artifacts/best_weights_fp16.pkl`` (the fp16 mirror that
``scripts/mirror_best_checkpoint.py`` writes) with
``scripts/restore_best_weights.py``, which runs unchanged, evaluates
``mode_counts_24k`` and ``KL24k`` of the restored snapshot with ``python -m
inclusivegan_torch.run_metrics``, and writes ``artifacts/best_weights_eval.json``:
the measured count and KL beside the sha256 of the pickle it measured and
the mirror's provenance (``mirror_meta``).

The paths of the restore, the dataset and the metric's results are the
module's ``RESTORE_DIR``, ``DATA_DIR``, ``DATASET`` and ``EVAL_RESULTS``, as
the JAX script has them; ``WEIGHTS`` and ``RECORD`` are the artifact and the
record.

    python -m inclusivegan_torch.scripts.eval_artifact          # restore, evaluate, record
    python -m inclusivegan_torch.scripts.eval_artifact --record-only RUN_DIR
        # record an existing run_metrics run dir (metric-mode_counts_24k.txt)
"""

import argparse
import datetime
import hashlib
import json
import os
import pickle
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WEIGHTS = os.path.join(REPO, "artifacts", "best_weights_fp16.pkl")
RECORD = os.path.join(REPO, "artifacts", "best_weights_eval.json")
RESTORE_DIR = "/tmp/exp/restore"
DATA_DIR = "/tmp/exp/datasets"
DATASET = "stacked_synth_240k"
EVAL_RESULTS = "/tmp/exp/eval_results"


def sha256(path, chunk=1 << 20):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def parse_run_dir(run_dir):
    """metric-mode_counts_24k.txt -> (count, kl): the metric reports the KL
    of the same samples under its ``_KL`` suffix."""
    path = os.path.join(run_dir, "metric-mode_counts_24k.txt")
    count = kl = None
    with open(path) as f:
        for line in f:
            m = re.search(r"\smode_counts_24k\s+(\d+)", line)
            if m:
                count = int(m.group(1))
            m = re.search(r"mode_counts_24k_KL\s+([0-9.eE+-]+)", line)
            if m:
                kl = float(m.group(1))
    if count is None:
        raise SystemExit(f"no mode_counts_24k line in {path}")
    return count, kl


def card_name():
    """The CUDA card the metric ran on, by name; the CPU without one."""
    import torch
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else "the CPU"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record-only", metavar="RUN_DIR", default=None,
                    help="parse an existing run_metrics run dir instead of evaluating")
    ap.add_argument("--weights-file", default=WEIGHTS)
    ap.add_argument("--classifier",
                    default=os.path.join(REPO, "metrics_weights", "stacked_mnist_classifier.npz"))
    args = ap.parse_args(argv)

    if args.record_only:
        run_dir = args.record_only
    else:
        out = subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts", "restore_best_weights.py"),
             "--weights-file", args.weights_file, "--out-dir", RESTORE_DIR],
            check=True, capture_output=True, text=True).stdout
        snap = json.loads(out[:out.index("\n\nresume")])["snapshot"]
        subprocess.run(
            [sys.executable, "-m", "inclusivegan_torch.run_metrics",
             "--network", snap, "--metrics", "mode_counts_24k,KL24k",
             "--dataset", DATASET, "--data-dir", DATA_DIR, "--result-dir", EVAL_RESULTS,
             "--classifier-weights", args.classifier],
            check=True, cwd=REPO)
        runs = sorted(d for d in os.listdir(EVAL_RESULTS)
                      if os.path.isdir(os.path.join(EVAL_RESULTS, d)))
        run_dir = os.path.join(EVAL_RESULTS, runs[-1])

    count, kl = parse_run_dir(run_dir)
    with open(args.weights_file, "rb") as f:
        meta = pickle.load(f).get("mirror_meta", {})
    record = {
        "artifact": os.path.relpath(args.weights_file, REPO),
        "artifact_sha256": sha256(args.weights_file),
        "mode_counts_24k": count,
        "KL24k": kl,
        "kimg": meta.get("kimg"),
        "src_run": meta.get("src_run"),
        # was the source run trained with the fused G phase
        # (G_loss_args.batched)? mirror_best_checkpoint.py stamps it into
        # mirror_meta from the run's submit_config.txt
        "g_loss_batched": meta.get("g_loss_batched"),
        "classifier": os.path.relpath(args.classifier, REPO),
        "eval_run_dir": os.path.abspath(run_dir),
        "evaluated_utc": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "note": "measured on the restored fp16->fp32 artifact itself (not a "
                "training-log scrape) via python -m inclusivegan_torch.run_metrics "
                f"on {card_name()}",
    }
    with open(RECORD, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps(record, indent=1))
    return record


if __name__ == "__main__":
    main()
