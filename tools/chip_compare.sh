#!/bin/bash
# Runs chip_smoke.py in two unpacked trees of the repository on one card, in
# the order A, B, B, A, so that the card's drift between runs falls on both
# sides alike; each run's output goes to OUT_DIR/<label><n>.txt, and the
# card's name and power limit are printed first.
#
#   git archive <parent-commit> | tar -x -C build/cmp/parent
#   git archive $(git write-tree) | tar -x -C build/cmp/change
#   bash tools/chip_compare.sh build/cmp/parent build/cmp/change OUT_DIR [chip_smoke.py arguments]
#
# Each tree builds its own kernels into its own build/kernels/. Exits 1 if
# any run failed.
set -u
parent=$1
change=$2
mkdir -p "$3"
out=$(cd "$3" && pwd)
shift 3
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
failed=0
for run in parent:1 change:1 change:2 parent:2; do
  label=${run%%:*}
  n=${run##*:}
  if [ "$label" = parent ]; then dir=$parent; else dir=$change; fi
  start=$(date +%s)
  (cd "$dir" && python3 chip_smoke.py "$@") > "$out/$label$n.txt" 2>&1
  rc=$?
  echo "$label $n: exit $rc in $(($(date +%s) - start)) s"
  [ $rc -eq 0 ] || failed=1
done
exit $failed
