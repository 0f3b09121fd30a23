#!/usr/bin/env bash
# The reference's script/ppwang/train_baseline.sh on the port: one
# baseline run on the default session; arguments go to the script
# (--synthetic, --direction decoding, --device cpu).
set -euo pipefail
cd "$(dirname "$0")/../../../.."
"${PYTHON:-python}" -m multi_modal_foundation_model_tpu_torch.scripts.train_baseline \
    --eid db4df448-e449-4a6f-a0e7-288711e7a75a \
    --seed 42 \
    --base_path results \
    "$@"
