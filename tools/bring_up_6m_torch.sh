#!/usr/bin/env bash
# The port at 6M SNPs on one card, in one command (nothing survives
# between chip calls): bench_torch.py --accel on its four 6M
# configurations, tools/eval_scaling_torch.py on the shared state and on
# the CLI grid's epoch state, bench_hbm_torch.py at its defaults. Each
# step's whole output is kept in OUT_DIR (a new temporary directory by
# default), its tail printed. The LD packs it caches (.bench_cache/,
# several GB each at 6M) are deleted at the end.
#
#   bash tools/bring_up_6m_torch.sh [OUT_DIR]
cd "$(dirname "$0")/.." || exit 1
out=${1:-$(mktemp -d)}
mkdir -p "$out"
echo "outputs in $out"
trap 'rm -rf .bench_cache' EXIT
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
df -h . | tail -1
status=0
step() {   # step NAME TIMEOUT_S COMMAND... (environment assignments first)
    local name=$1 limit=$2
    shift 2
    local t0=$(date +%s)
    timeout -k 30 "$limit" env "$@" > "$out/$name.txt" 2>&1
    local rc=$?
    tail -n 40 "$out/$name.txt"
    echo "== $name: exit $rc, $(( $(date +%s) - t0 )) s"
    [ $rc -eq 0 ] || status=1
}
step bench_k18 1200 BENCH_SIZE=6m python3 bench_torch.py --accel
step bench_f32 1200 BENCH_SIZE=6m BENCH_LD_DTYPE=f32 \
    python3 bench_torch.py --accel
step bench_kdim 900 BENCH_SIZE=6m BENCH_SCALE_SE=1 \
    python3 bench_torch.py --accel
step bench_cli 900 BENCH_SIZE=6m BENCH_GRID=cli BENCH_SCALE_SE=1 \
    python3 bench_torch.py --accel
step eval_shared 1500 \
    python3 tools/eval_scaling_torch.py 250000 500000 1000000 6000000
step eval_cli 1200 BENCH_GRID=cli BENCH_SCALE_SE=1 \
    python3 tools/eval_scaling_torch.py 1000000 6000000
step hbm 300 python3 bench_hbm_torch.py
du -sh .bench_cache 2>/dev/null
exit $status
