#!/bin/bash
# The dry-run's whole sweep (every (arch x shape) cell of the reference on
# the 16x16 and the 2x16x16 mesh), one `repro_torch.launch.dryrun` process
# a cell, JOBS at once, on the CPU: each process holds its own fake process
# group. With TESTS=1 it also runs the mesh and dry-run tests beside it.
# Results (one JSON a cell and mesh, each process's log, the return codes
# and the sweep's wall time) go under OUT.
#
# Usage, from the repo root (on any machine's CPU; no card is used):
#   bash benchmarks/torch_dryrun_sweep.sh [OUT=experiments/dryrun_sweep] [JOBS=6] [TESTS=0]
set -u
cd "$(dirname "$0")/.."
OUT=${1:-experiments/dryrun_sweep}
JOBS=${2:-6}
TESTS=${3:-0}
export PYTHONPATH=src JAX_PLATFORMS=cpu OUT
mkdir -p "$OUT"
python -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'
if [ "$TESTS" = 1 ]; then
  ( timeout 900 python -m pytest -q -p no:cacheprovider tests/test_torch_distributed.py \
      tests/test_torch_dryrun.py tests/test_torch_op_cost.py > "$OUT/tests.log" 2>&1
    echo "tests rc=$?" >> "$OUT/tests.log" ) &
fi
run() {  # one cell on both meshes
  timeout 1800 python -m repro_torch.launch.dryrun --arch "$1" --shape "$2" --both-meshes \
    --out "$OUT" > "$OUT/$1__$2.log" 2>&1
  echo "$1 $2 rc=$?"
}
export -f run
start=$(date +%s)
python -c 'from repro_torch.configs import all_cells
for a, s in all_cells(): print(a, s)' | xargs -P "$JOBS" -L 1 bash -c 'run "$0" "$1"' > "$OUT/rcs.txt"
echo "sweep of $(wc -l < "$OUT/rcs.txt") cells x 2 meshes: $(( $(date +%s) - start )) s wall, $JOBS at once"
wait
cat "$OUT/rcs.txt"
[ "$TESTS" = 1 ] && tail -3 "$OUT/tests.log"
grep -h "^OK\|^FAIL" "$OUT"/*.log | sort
! grep -q "rc=[^0]" "$OUT/rcs.txt"
