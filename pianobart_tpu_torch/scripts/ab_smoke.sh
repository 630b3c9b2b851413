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
#
# AB_PHASES (optional) names the phases to run, in chip_smoke.py's order,
# e.g. "device build flash lab flash_bwd fused_ln train train_long
# train_fused train_f32": each tree's chip_smoke.py is imported and its
# PHASES cut to those (a phase a tree lacks is skipped), so the comparison
# costs the kernel and train phases alone.  Its kernels line then holds the
# records this run filled: a record needs both its kernel phase's row
# (e.g. [fused_ln]'s for k4a) and its main path's launch counts
# ([train_fused]'s), and one whose phase did not run is left out.
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
  if [ -n "${AB_PHASES:-}" ]; then
    (cd "$d" && AB_PHASES="$AB_PHASES" python3 -c '
import os, sys
sys.path.insert(0, os.getcwd())
import chip_smoke as c
keep = os.environ["AB_PHASES"].split()
def filled(state):
    c.KERNEL_RECORDS = tuple(r for r in c.KERNEL_RECORDS
                             if r[1] in state and r[5] in state["launches"])
c.PHASES = tuple(p for p in c.PHASES if p[0] in keep) + (("records", filled),)
sys.exit(c.main())') > "$log" 2>&1
  else
    (cd "$d" && python3 chip_smoke.py) > "$log" 2>&1
  fi
  rc=$?
  [ $rc -eq 0 ] || status=1
  echo "run $i $who rc=$rc"
  grep "force_full\|ms/step\|concurrent\|^\[serve_http\] answers\|^\[lab\] kt\|^\[lab\] hl\|^\[[01]\] \|^\[flash\] B=\|^\[flash_bwd\]\|^\[fused_ln\].*K4\|loss per step\|SASS of" "$log" \
    | grep -v "^\[train_long\] loss\|^\[train_fused\] loss\|phase ok" | cut -c1-520
done
exit $status
