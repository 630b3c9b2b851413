#!/bin/bash
# Parent against change on one card: the whole chip_smoke.py of each tree,
# one after the other, in the order parent, change, change, parent, so that
# drift over the run falls on both trees alike.
#
#   git archive <parent commit> | tar -x -C build/parent   # before the run
#   bash pianobart_tpu_torch/scripts/ab_smoke.sh build/parent [out_dir]
#
# Run from the root of the changed checkout.  Each run's whole output goes
# to <out_dir>/ab_<i>_<parent|change>.log (default out_dir: build/ab);
# the lines that compare the trees (K1 at every [flash] shape, K2, K3a and
# K3b at every [flash_bwd] shape, K4a and K4b at every [fused_ln] shape, the
# lab's variants and its two sweeps (ms per chain), the SASS counts of the
# wgmma kernels, decode, ms/step, [train]'s losses) are printed.  Exits
# non-zero if any run did.
set -u
parent=$(cd "$1" && pwd)
out=$(mkdir -p "${2:-build/ab}" && cd "${2:-build/ab}" && pwd)
change=$(pwd)
status=0
i=0
for who in parent change change parent; do
  i=$((i + 1))
  if [ "$who" = parent ]; then d=$parent; else d=$change; fi
  log=$out/ab_${i}_$who.log
  (cd "$d" && python3 chip_smoke.py) > "$log" 2>&1
  rc=$?
  [ $rc -eq 0 ] || status=1
  echo "run $i $who rc=$rc"
  grep "force_full\|ms/step\|concurrent\|^\[serve_http\] answers\|^\[lab\] kt\|^\[lab\] hl\|^\[[01]\] \|^\[flash\] B=\|^\[flash_bwd\]\|^\[fused_ln\].*K4\|loss per step\|SASS of" "$log" \
    | grep -v "^\[train_long\] loss\|^\[train_fused\] loss\|phase ok" | cut -c1-520
done
exit $status
