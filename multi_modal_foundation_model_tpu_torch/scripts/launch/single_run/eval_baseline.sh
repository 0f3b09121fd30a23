#!/usr/bin/env bash
# The reference's script/ppwang/eval_baseline.sh on the port: evaluate the
# baseline run trained by train_baseline.sh, with the per-neuron figures;
# arguments go to the script (--synthetic, --device cpu).
set -euo pipefail
cd "$(dirname "$0")/../../../.."
"${PYTHON:-python}" -m multi_modal_foundation_model_tpu_torch.scripts.eval_baseline \
    --eid db4df448-e449-4a6f-a0e7-288711e7a75a \
    --seed 42 \
    --save_plot \
    --overwrite \
    --base_path results \
    "$@"
