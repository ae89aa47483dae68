#!/bin/bash
# Matched-seed experiment arms on stacked-MNIST on the card, through the
# port: the stages of scripts/exp_matched_arms.sh, each as its port command
# (python -m inclusivegan_torch.scripts.exp_stacked_mode_coverage).
#
#   A  mb32  bf16  lr 0.002          — production recipe baseline
#   B  mb32  fp32  lr 0.002          — dtype-parity arm (identical seed/data;
#                                      the ONLY difference is compute dtype)
#   C  mb128 bf16  lr 0.004, EMA 10  — large-batch recipe: 4x batch, linear-
#                                      scaled lr capped at 2x (GAN steps at
#                                      beta1=0 tolerate less than the full
#                                      linear rule), EMA horizon kept constant
#                                      in KIMG (so shorter in steps)
#
# Every arm runs the full production pipeline (IMLE rebuilds, rec+interp
# LPIPS, lazy regs) for the same total kimg from the same seed, with
# mode_counts_24k/KL evaluated every 2 ticks (40 kimg). Trajectories are
# mirrored into artifacts/matched_arms_digest.json (results/ is not kept).
#
# Card-exclusive. Usage:
#   bash inclusivegan_torch/scripts/exp_matched_arms.sh [A B C ...]
set -euo pipefail
cd "$(dirname "$0")/../.."

DATA_DIR=${DATA_DIR:-/tmp/exp/datasets}
DATASET=${DATASET:-stacked_synth_60k}
# 59904 = 936*64: data_size must divide by every arm's global batch*2
# (training_loop.py:455; arm C runs mb128 -> 256) — the r3 arms corpus
DATA_SIZE=${DATA_SIZE:-59904}
SEED=${SEED:-3000}
EPOCHS=${EPOCHS:-2} # 60k * 2 = 120 kimg
DIGEST=${DIGEST:-artifacts/matched_arms_digest.json}

run_arm() { # run_arm <name> <extra exp_stacked flags...>
  local name=$1
  shift
  echo "== arm $name: $* =="
  python3 -m inclusivegan_torch.scripts.exp_stacked_mode_coverage \
    --data-dir "$DATA_DIR" --dataset "$DATASET" --data-size "$DATA_SIZE" \
    --num-epochs "$EPOCHS" --seed "$SEED" \
    --classifier /tmp/exp/stacked_mnist_classifier.npz \
    --lpips-weights /tmp/exp/perceptual_vgg.npz \
    --init-proj-dim 128 --candidate-batch-size 2048 \
    --network-snapshot-ticks 2 --image-snapshot-ticks 10 \
    --exclusive-retrieved-code 1 \
    "$@" 2>&1 | tail -4
  local run_dir
  run_dir=$(ls -d results/[0-9]*-stacked-synth-*-mode-coverage | tail -1)
  mv "$run_dir" "${run_dir}-arm-${name}"
  python3 scripts/record_quality_digest.py "${run_dir}-arm-${name}" \
    --out "$DIGEST" --note "arm ${name} seed ${SEED} (${EPOCHS}x${DATA_SIZE} kimg)"
  git add "$DIGEST" && git commit -q -m "Matched-arms digest: arm ${name} trajectory" || true
}

ARMS=("$@")
[ ${#ARMS[@]} -eq 0 ] && ARMS=(A B C)
for arm in "${ARMS[@]}"; do
  case $arm in
  A) run_arm A --minibatch 32 --dtype bfloat16 ;;
  B) run_arm B --minibatch 32 --dtype float32 ;;
  C) run_arm C --minibatch 128 --dtype bfloat16 --g-lrate 0.004 --d-lrate 0.004 ;;
  # D: arm A + the fused G phase (one G forward + one LPIPS pass,
  # loss.py batched=True) — quality gate for the +24% throughput default
  # (BENCH_NOTES r4); identical seed/data/recipe to A otherwise
  D) run_arm D --minibatch 32 --dtype bfloat16 --g-loss-batched 1 ;;
  *)
    echo "unknown arm $arm"
    exit 1
    ;;
  esac
done
echo "== arms done; digest at $DIGEST =="
