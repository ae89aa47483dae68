#!/bin/bash
# Second-seed CelebA-128 arm on the card, through the port: the stages of
# scripts/exp_celeba_seed_noise.sh, each as its port command. One more run
# of the shipping-default configuration of the quality loop (fused-G
# batched phase, the FIR kernel, bf16, 180 kimg) with ONLY the seed changed,
# so that the fid spread between two seeds is a measured single-knob
# seed-noise bar.
#
# Lean on purpose: training (in-training fid30k trajectory at every
# snapshot tick) + best-snapshot registry fid30k + pr50k3. The long
# surfaces (ls/IvOM/ppl) belong to run_celeba_quality_loop.sh and are not
# part of the noise question. Nothing here overwrites the shipping
# best-snapshot mirror.
#
# Usage: SEED=1001 bash inclusivegan_torch/scripts/exp_celeba_seed_noise.sh
set -euo pipefail
cd "$(dirname "$0")/../.."

DATA_DIR=${DATA_DIR:-/tmp/exp/datasets}
DATASET=${DATASET:-celeba_synth_30k}
EPOCHS=${EPOCHS:-6}               # 180 kimg — r4's arm length (peak ~152)
SEED=${SEED:-1001}
RESULT_DIR=${RESULT_DIR:-results}
LPIPS_NPZ=${LPIPS_NPZ:-/tmp/exp/celeba_perceptual_vgg.npz}

echo "== seed-noise arm: seed $SEED, $((30 * EPOCHS)) kimg =="
python3 -m inclusivegan_torch.run_training --data-dir "$DATA_DIR" --dataset "$DATASET" \
  --config config-e-Gskip-Dresnet --num-gpus 1 --data-size 30000 \
  --num-epochs "$EPOCHS" --metrics fid30k --mirror-augment true \
  --init-proj-dim 512 --candidate-batch-size 1024 \
  --lpips-weights "$LPIPS_NPZ" --seed "$SEED" \
  --dtype bfloat16 --result-dir "$RESULT_DIR" 2>&1 | tail -20
RUN_DIR=$(ls -d "$RESULT_DIR"/*-celeba_synth_30k* 2>/dev/null | tail -1)
PKL=$(python3 scripts/select_best_snapshot.py "$RUN_DIR" --metric fid30k)
echo "best snapshot: $PKL"
python3 scripts/record_quality_digest.py "$RUN_DIR" \
  --note "seed-noise arm (seed $SEED, shipping defaults, $((30 * EPOCHS)) kimg); best-fid snapshot: $PKL"
git add artifacts/celeba_quality_digest.json \
  && git commit -q -m "CelebA seed-noise arm: training trajectory (seed $SEED)" || true

echo "== registry fid30k + pr50k3 on the best snapshot =="
python3 -m inclusivegan_torch.run_metrics --network "$PKL" --data-dir "$DATA_DIR" \
  --dataset "$DATASET" --mirror-augment true \
  --lpips-weights "$LPIPS_NPZ" \
  --metrics fid30k,pr50k3 2>&1 | tail -12
python3 scripts/record_quality_digest.py "$RESULT_DIR"/*-run_metrics \
  --note "seed-noise arm registry metrics (fid30k,pr50k3) on $PKL (seed $SEED)"
git add artifacts/celeba_quality_digest.json \
  && git commit -q -m "CelebA seed-noise arm: registry metrics (seed $SEED)" || true
echo "== done =="
