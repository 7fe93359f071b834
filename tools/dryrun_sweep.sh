#!/bin/bash
# The dry run's --all sweep on the 256-GPU production mesh, searched: every
# published arch x shape through `python -m repro_torch.launch.dryrun`, one
# process a cell, JOBS archs at a time (an arch's four shapes in turn).
#
#   bash tools/dryrun_sweep.sh [JOBS] [LOG_DIR]
#
# Each cell's log goes to LOG_DIR/<arch>__<shape>.log, its exit code and
# seconds to LOG_DIR/times.txt, its JSON to results/dryrun_torch/; the
# summary lines are printed at the end.  CELL_TIMEOUT (seconds, default
# 5400) bounds each cell.
export PYTHONPATH=src
JOBS=${1:-4}
export LOG_DIR=${2:-chiprun_out/dryrun_sweep}
mkdir -p "$LOG_DIR"
run_arch() {
  for shape in train_4k prefill_32k decode_32k long_500k; do
    start=$SECONDS
    timeout "${CELL_TIMEOUT:-5400}" python -m repro_torch.launch.dryrun \
      --arch "$1" --shape "$shape" --mesh single --strategy search \
      > "$LOG_DIR/$1__$shape.log" 2>&1
    echo "$1 $shape rc=$? seconds=$((SECONDS - start))" >> "$LOG_DIR/times.txt"
  done
}
export -f run_arch
printf "%s\n" llama3.2-1b olmo-1b qwen2.5-3b granite-3-2b olmoe-1b-7b \
  phi3.5-moe-42b-a6.6b rwkv6-1.6b jamba-1.5-large-398b internvl2-76b \
  seamless-m4t-large-v2 | xargs -P "$JOBS" -I{} bash -c 'run_arch {}'
grep -h "^\[OK\]\|^\[SKIPPED\]\|^\[FAIL\]" "$LOG_DIR"/*.log | sort
