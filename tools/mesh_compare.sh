#!/bin/bash
# The train and serve commands realized on a mesh of every GPU of the
# machine (torchrun, nccl) against the same commands on one GPU, at
# llama3.2-1b's published size:
#
#     bash tools/mesh_compare.sh
#
# Run from the repository root on a machine with several GPUs and the CUDA
# toolkit.  Train: 3 steps of 8 x 256 under the plan searched for the
# train mesh (every rank on data) and under the data baseline, against
# the plan-free run on one GPU; serve: 6 requests on the serve mesh
# (2 x n/2) under the searched plan against one GPU, every completion's
# tokens compared.  Logs and metrics land in chiprun_out/mesh/.
set -u
out=chiprun_out/mesh; mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
export PYTHONPATH=src
python -c "from repro_torch.kernels import build; build.build_all()" || exit 1
T="--arch llama3.2-1b --steps 3 --batch 8 --seq 256 --ckpt-every 0 --log-every 1"
S="--arch llama3.2-1b --width 0 --depth 0 --vocab 0 --batch 4 --requests 6 --prompt-len 96 --gen 8"
n=$(nvidia-smi -L | wc -l)
for strat in searched data; do
  timeout 400 torchrun --nproc-per-node $n -m repro_torch.launch.train $T \
    --strategy $strat --metrics-out $out/train-$strat.json \
    > $out/train-$strat.log 2>&1; echo "train-$strat rc=$?"
done
timeout 300 python -m repro_torch.launch.train $T --strategy uniform \
  --metrics-out $out/train-one.json > $out/train-one.log 2>&1
echo "train-one rc=$?"
timeout 400 torchrun --nproc-per-node $n tools/serve_tokens.py $S \
  --strategy searched > $out/serve-mesh.log 2>&1; echo "serve-mesh rc=$?"
timeout 300 python tools/serve_tokens.py $S > $out/serve-one.log 2>&1
echo "serve-one rc=$?"
one=$(grep -h "^TOKENS" $out/serve-one.log)
[ -n "$one" ] && [ "$(grep -h "^TOKENS" $out/serve-mesh.log)" = "$one" ] \
  && echo "serve tokens equal" || echo "serve tokens DIFFER"
for f in train-searched train-data train-one serve-mesh serve-one; do
  echo "== $f"
  grep -v "^\[rank\|W1018\|Warning\|warn\|^TOKENS" $out/$f.log | tail -14
done
