#!/bin/bash
# The price of --invariant-rng on the card, through the port: the stages of
# scripts/exp_invariant_rng_price.sh, each as its port command. The
# production CelebA-128 recipe (config-e-Gskip-Dresnet, bf16, fused-G
# default, the FIR kernel, mb6), short windows, control first then
# --invariant-rng true, back to back; every steady tick is
# reported, so that outliers are visible rather than excluded silently.
#
# Usage: bash inclusivegan_torch/scripts/exp_invariant_rng_price.sh   (the card must be idle)
set -euo pipefail
cd "$(dirname "$0")/../.."

DATA_DIR=${DATA_DIR:-/tmp/exp/datasets}
DATASET=${DATASET:-celeba_synth_30k}
KIMG=${KIMG:-8}
LPIPS_NPZ=${LPIPS_NPZ:-/tmp/exp/celeba_perceptual_vgg.npz}
RESULT_DIR=${RESULT_DIR:-results}

run_arm () {  # $1 = arm name, $2 = extra flags
  echo "== arm: $1 =="
  # shellcheck disable=SC2086
  python3 -m inclusivegan_torch.run_training --data-dir "$DATA_DIR" --dataset "$DATASET" \
    --config config-e-Gskip-Dresnet --num-gpus 1 --data-size 30000 \
    --num-epochs 1 --total-kimg "$KIMG" --metrics "" \
    --mirror-augment true --init-proj-dim 512 --candidate-batch-size 1024 \
    --lpips-weights "$LPIPS_NPZ" --dtype bfloat16 \
    --result-dir "$RESULT_DIR" $2 2>&1 | tail -4
  RUN_DIR=$(ls -d "$RESULT_DIR"/*-celeba_synth_30k* 2>/dev/null | tail -1)
  echo "--- $1 ticks ($RUN_DIR):"
  grep -E "^tick" "$RUN_DIR/log.txt" | awk '{print $1, $2, $(NF-1), $NF}'
}

run_arm control ""
run_arm invariant "--invariant-rng true"
echo "== done: compare sec/kimg of steady ticks (skip tick 0 = compile) =="
