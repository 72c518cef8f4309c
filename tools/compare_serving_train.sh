#!/bin/bash
# Phase 4 (serving) and phase 5 (the pretraining step) of chip_smoke.py in
# two unpacked trees of the repository on one card, in the order A, B, B,
# A, so that the card's drift between runs falls on both sides alike; each
# run's output goes to OUT_DIR/<label><n>.txt (phase 4's p50 a request kind,
# phase 5's step p50 and profiled device ms), and the card's name and power
# limit are printed first.
#
#   git archive <parent-commit> | tar -x -C build/cmp/parent
#   git archive $(git write-tree) | tar -x -C build/cmp/change
#   bash tools/compare_serving_train.sh build/cmp/parent build/cmp/change OUT_DIR
#
# Each tree builds its own kernels into its own build/kernels/. Exits 1 if
# any run failed.
set -u
parent=$1
change=$2
mkdir -p "$3"
out=$(cd "$3" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
failed=0
for run in parent:1 change:1 change:2 parent:2; do
  label=${run%%:*}
  n=${run##*:}
  if [ "$label" = parent ]; then dir=$parent; else dir=$change; fi
  start=$(date +%s)
  (cd "$dir" && python3 -c "
import torch, chip_smoke as s
s.phase_device()
s.phase_build()
dev = torch.device('cuda', 0)
s.phase_serving(dev)
s.phase_train(dev)
") > "$out/$label$n.txt" 2>&1
  rc=$?
  echo "$label $n: exit $rc in $(($(date +%s) - start)) s"
  grep -E "^\[serving\] B=|\[train\] (profile attn_impl=auto|B=60)" "$out/$label$n.txt" | cut -c1-220
  [ $rc -eq 0 ] || failed=1
done
exit $failed
