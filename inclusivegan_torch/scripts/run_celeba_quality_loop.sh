#!/bin/bash
# CelebA-128 production-scale quality loop on the card, through the port:
# the stages of scripts/run_celeba_quality_loop.sh, each as its port
# command. Train at the paper's config on the 30k synthetic-CelebA corpus,
# then run every quality surface at registry sizes against the best
# snapshot: fid30k, pr50k3, ppl_wend, is50k, ls (40-attr scorer), IvOM
# projection, generator CLI.
#
# After every stage the metric lines are merged into
# artifacts/celeba_quality_digest.json (in git) by
# scripts/record_quality_digest.py, and the evaluated best-FID snapshot is
# fp16-mirrored to artifacts/celeba_best_weights_fp16.pkl, so that a later
# run can re-evaluate without retraining.
#
# Card-exclusive: run only when no other trainer holds the card. Expects the
# dataset + attrs already built:
#   python3 scripts/make_synthetic_celeba.py --out /tmp/exp/celeba --num-images 30000
#   python3 -m inclusivegan_torch.dataset_tool create_celeba /tmp/exp/datasets/celeba_synth_30k /tmp/exp/celeba
set -euo pipefail
cd "$(dirname "$0")/../.."

DATA_DIR=${DATA_DIR:-/tmp/exp/datasets}
DATASET=${DATASET:-celeba_synth_30k}
EPOCHS=${EPOCHS:-14}              # total_kimg = 30 * EPOCHS
RESULT_DIR=${RESULT_DIR:-results}
STAMP=$(date +%H%M%S)

echo "== [1/6] 40-attribute classifier (LS scorer) =="
if [ ! -f metrics_weights/celeba_attr_classifier.npz ]; then
  python3 -m inclusivegan_torch.scripts.train_attr_classifier \
    --data-dir "$DATA_DIR" --dataset "$DATASET" \
    --out metrics_weights/celeba_attr_classifier.npz --epochs 4
fi

echo "== [1b/6] domain perceptual anchor (rec-LPIPS + IvOM objective) =="
# The pixel-pyramid fallback caused stacked-MNIST mode collapse; train the
# zhang-layout VGG on the face corpus itself (40-attr sigmoid heads) so the
# IMLE anchor carries perceptual pressure.
LPIPS_NPZ=${LPIPS_NPZ:-/tmp/exp/celeba_perceptual_vgg.npz}
if [ ! -f "$LPIPS_NPZ" ]; then
  python3 -m inclusivegan_torch.scripts.train_perceptual_vgg \
    --data-dir "$DATA_DIR" --dataset "$DATASET" \
    --out "$LPIPS_NPZ" --epochs 3 --batch 64
fi

echo "== [2/6] config-e-Gskip-Dresnet training, $((30 * EPOCHS)) kimg =="
# --init-proj-dim 512: the projected 512-dim features of the 300k pool fit
# the exact device backend; raw 49152-dim CelebA-128 features would not
python3 -m inclusivegan_torch.run_training --data-dir "$DATA_DIR" --dataset "$DATASET" \
  --config config-e-Gskip-Dresnet --num-gpus 1 --data-size 30000 \
  --num-epochs "$EPOCHS" --metrics fid30k --mirror-augment true \
  --init-proj-dim 512 --candidate-batch-size 1024 \
  --lpips-weights "$LPIPS_NPZ" \
  --dtype bfloat16 --result-dir "$RESULT_DIR" 2>&1 | tail -40
RUN_DIR=$(ls -d "$RESULT_DIR"/*-celeba_synth_30k* 2>/dev/null | tail -1)
# evaluate the BEST in-training snapshot, not the last: late-training D
# overfitting on a 30k corpus regresses the final FID; the paper reports
# best-snapshot numbers
PKL=$(python3 scripts/select_best_snapshot.py "$RUN_DIR" --metric fid30k)
echo "evaluating snapshot: $PKL"
# record the in-training fid trajectory + mirror the snapshot NOW, before
# any long eval stage can be interrupted
python3 scripts/record_quality_digest.py "$RUN_DIR" \
  --note "training run $RUN_DIR; best-fid snapshot: $PKL"
python3 scripts/mirror_snapshot.py "$PKL" \
  artifacts/celeba_best_weights_fp16.pkl --meta "role=celeba-best-fid"
# commit immediately: the training investment is durable even if the eval
# stages below are interrupted
git add artifacts/celeba_quality_digest.json \
  artifacts/celeba_best_weights_fp16.pkl artifacts/celeba_best_weights_fp16.pkl.json \
  && git commit -q -m "CelebA quality loop: mirror best-FID snapshot + training trajectory" \
  || true

echo "== [3/6] registry metrics on the best snapshot =="
python3 -m inclusivegan_torch.run_metrics --network "$PKL" --data-dir "$DATA_DIR" \
  --dataset "$DATASET" --mirror-augment true \
  --lpips-weights "$LPIPS_NPZ" \
  --metrics fid30k,pr50k3,ppl_wend,is50k 2>&1 | tail -20
python3 scripts/record_quality_digest.py "$RESULT_DIR"/*-run_metrics \
  --note "registry metrics (fid30k,pr50k3,ppl_wend(crop),is50k) on $PKL"

echo "== [4/6] IvOM latent projection =="
python3 -m inclusivegan_torch.run_projector project-real-images --network "$PKL" \
  --data-dir "$DATA_DIR" --dataset "$DATASET" \
  --num-images "${IVOM_IMAGES:-300}" --num-steps 400 \
  --lpips-weights "$LPIPS_NPZ" \
  --result-dir "$RESULT_DIR" 2>&1 | tail -10
python3 scripts/record_quality_digest.py "$RESULT_DIR"/*project-real-images* \
  --note "IvOM on $PKL"

echo "== [5/6] generator CLI smoke =="
python3 -m inclusivegan_torch.run_generator generate-images --network "$PKL" \
  --num-images 32 --truncation-psi 0.6 --result-dir "$RESULT_DIR" 2>&1 | tail -4

echo "== [6/6] linear separability (ls; the ~80 LinearSVC fits on 100k x"
echo "   512 latents make this the longest stage - run last so an"
echo "   interrupted session loses the least) =="
python3 -m inclusivegan_torch.run_metrics --network "$PKL" --data-dir "$DATA_DIR" \
  --dataset "$DATASET" --metrics ls 2>&1 | tail -8
python3 scripts/record_quality_digest.py "$RESULT_DIR"/*-run_metrics \
  --note "ls on $PKL"

git add artifacts/celeba_quality_digest.json \
  artifacts/celeba_best_weights_fp16.pkl* 2>/dev/null \
  && git commit -q -m "CelebA quality loop: digest + best-snapshot mirror" \
  || true
echo "== done: artifacts under $RUN_DIR, $RESULT_DIR and artifacts/ =="
