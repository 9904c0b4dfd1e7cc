#!/usr/bin/env bash
# The production fit CLI end to end on one card, from on-disk inputs at
# genome scale, in one command (nothing survives between chip calls).
# Each run goes through `python -m vilma_tpu_torch.frontend fit`'s argv
# under tools/e2e_fit_torch.py, which prints its E2E line (seconds by
# stage, iterations, RSS, device memory, bytes written):
#
#   1m: export 1,000,000 SNPs (tools/export_synthetic_schema_torch.py,
#       factored on the card); the text stage alone (E2E_TEXT); run 1,
#       the JAX tool's documented command (-K 2 --precision f32
#       --ld-precision bf16 --num-its 30); run 2, the default fit
#       (-K 12 --learn-scaling, every other flag at its default: f32 U,
#       --num-its 1000 with the convergence test, vi_sigma saved).
#   6m: export 6,000,000 SNPs; the text stage; run 4, the default fit
#       with --no-save-vi-sigma and --mmap, stopped after 10 outer steps
#       (load and set-up only); run 3, the same fit without --mmap, to
#       its end.
#
# A run whose reckoned outputs exceed the free disk stops with exit code
# 1 before it reads anything. Each step's whole output is kept in
# OUT_DIR (a new temporary directory by default), its tail printed. The
# inputs and outputs (tens of GB) live in a temporary directory
# (E2E_WORK, default `mktemp -d`) that is deleted at the end; E2E_INPUTS
# puts the exported inputs elsewhere (a RAM-backed /dev/shm/..., say,
# on a machine whose disk takes only so many bytes written).
#
#   bash tools/e2e_fit_torch.sh [OUT_DIR] [STEPS]
#
# STEPS is a comma list of text_1m, run1, run2, text_6m, run3, run4, or
# 1m (the first three), 6m (the last three) or all (the default); each
# size's inputs are exported once for the steps that need them.
cd "$(dirname "$0")/.." || exit 1
out=${1:-$(mktemp -d)}
which=${2:-all}
mkdir -p "$out"
work=${E2E_WORK:-$(mktemp -d)}
inputs=${E2E_INPUTS:-$work}
mkdir -p "$work" "$inputs"
trap 'rm -rf "$work" "$inputs"' EXIT
echo "logs in $out, inputs in $inputs, fit outputs in $work"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
df -h . "$work" "$inputs" | tail -n +2
free -g | head -2
status=0
step() {   # step NAME TIMEOUT_S COMMAND...
    local name=$1 limit=$2
    shift 2
    local t0=$(date +%s)
    timeout -k 30 "$limit" "$@" > "$out/$name.txt" 2>&1
    local rc=$?
    grep -v '^E2E' "$out/$name.txt" | tail -n 12
    grep '^E2E' "$out/$name.txt"
    echo "== $name: exit $rc, $(( $(date +%s) - t0 )) s"
    [ $rc -eq 0 ] || status=1
}
fit_argv() {   # fit_argv INPUT_DIR OUTPUT_PREFIX FLAGS...
    local d=$1 o=$2
    shift 2
    echo fit --sumstats "$d/pop1.sumstats.tsv,$d/pop2.sumstats.tsv" \
        --ld-schema "$d/schema.schema,$d/schema.schema" \
        --extract "$d/extract.tsv" --names pop1,pop2 \
        --samplesizes 1e5,1e5 --init-hg 0.3,0.3 --seed 42 \
        --output "$o" "$@"
}
text_stage() {   # text_stage TAG INPUT_DIR
    step "$1" 900 python3 tools/e2e_fit_torch.py --tag "$1" --text-only \
        $(fit_argv "$2" "$work/none")
}
run() {   # run TAG TIMEOUT_S INPUT_DIR [e2e_fit_torch.py flags] -- FIT FLAGS...
    local tag=$1 limit=$2 d=$3
    shift 3
    local own=()
    while [ "$1" != "--" ]; do own+=("$1"); shift; done
    shift
    step "$tag" "$limit" python3 tools/e2e_fit_torch.py --tag "$tag" \
        "${own[@]}" $(fit_argv "$d" "$work/$tag" "$@")
    ls -l "$work" | grep "$tag" | awk '{print $5, $9}'
    rm -f "$work/$tag".*
}
want() {   # want STEP: is STEP among the selected steps?
    case ",$which," in *",$1,"*) return 0 ;; esac
    return 1
}
steps=
for item in ${which//,/ }; do
    case $item in
        1m) steps+=,text_1m,run1,run2 ;;
        6m) steps+=,text_6m,run3,run4 ;;
        all) steps+=,text_1m,run1,run2,text_6m,run3,run4 ;;
        *) steps+=,$item ;;
    esac
done
which=$steps
if want text_1m || want run1 || want run2; then
    step export_1m 900 python3 tools/export_synthetic_schema_torch.py \
        "$inputs/in1m" 1000000
    want text_1m && text_stage text_1m "$inputs/in1m"
    want run1 && run run1 1200 "$inputs/in1m" -- -K 2 --precision f32 \
        --ld-precision bf16 --num-its 30
    want run2 && run run2 1800 "$inputs/in1m" -- -K 12 --learn-scaling
    rm -rf "$inputs/in1m"
fi
if want text_6m || want run3 || want run4; then
    step export_6m 1800 python3 tools/export_synthetic_schema_torch.py \
        "$inputs/in6m" 6000000
    df -h "$work" "$inputs" | tail -n +2
    want text_6m && text_stage text_6m "$inputs/in6m"
    want run4 && run run4 2400 "$inputs/in6m" --stop-after 10 -- -K 12 \
        --learn-scaling --no-save-vi-sigma --mmap
    want run3 && run run3 6000 "$inputs/in6m" -- -K 12 --learn-scaling \
        --no-save-vi-sigma
    rm -rf "$inputs/in6m"
fi
exit $status
