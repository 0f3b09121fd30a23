"""``train_multi_session`` as four gloo ranks on the CPU (torchrun, ``--dp
2 --tp 2 --backend gloo``): on host batches, and resident with
session-mixed batches and ``--shard_sessions``. One epoch of two sessions
(24 and 61 neurons, 40 trials each, the model cut to one layer a stack
and 64 wide); rank 0 writes one metrics file with a finite loss and
``sessions.json``; the checkpoint holds the single-device layout, which
``eval_multi_modal --multi_session`` reads in one process."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per xdist worker)
from multi_modal_foundation_model_tpu_torch.scripts import eval_multi_modal

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--synthetic", "--n_neurons", "24", "--n_trials", "40",
         "--num_sessions", "2", "--eid", "x", "--pad_multiple", "32",
         "--use_MtM", "--mixed_training", "--num_epochs", "1",
         "--set", "model.encoder.transformer.n_layers=1",
         "--set", "model.decoder.transformer.n_layers=1",
         "--set", "model.encoder.transformer.hidden_size=64",
         "--set", "model.encoder.transformer.inter_size=128",
         "--set", "model.encoder.transformer.n_heads=2"]
CASES = {"host": [],
         "sharded": ["--device_resident", "--mixed_session_batches",
                     "--shard_sessions"]}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_multi_session_as_four_gloo_ranks(case, tmp_path):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "4", "-m",
           "multi_modal_foundation_model_tpu_torch.scripts."
           "train_multi_session"]
    cmd += SMALL + CASES[case] + ["--dp", "2", "--tp", "2", "--device",
                                  "cpu", "--backend", "gloo", "--base_path",
                                  str(tmp_path)]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, (out.stdout + out.stderr)[-4000:]
    (metrics,) = Path(tmp_path).rglob("metrics.jsonl")
    log_dir = metrics.parent
    rows = [json.loads(ln) for ln in metrics.read_text().splitlines()]
    epochs = [r for r in rows if "epoch" in r]
    assert len(epochs) == 1 and math.isfinite(epochs[0]["train_loss"])
    assert json.loads((log_dir / "sessions.json").read_text())["n_max"] == 64
    tree = torch.load(log_dir / "model_last.pt", weights_only=True)
    kernel = tree["model"]["encoder_embeddings.ap.embedder.token_embed_kernel"]
    assert kernel.shape == (2, 64, 128)        # whole: (S, N_max, 2 * 64)
    results = eval_multi_modal.main(
        ["--synthetic", "--n_trials", "40", "--device", "cpu",
         "--multi_session", "--model_dir", str(log_dir), "--use_MtM",
         "--co_smooth"])
    assert set(results) == {"x-0", "x-1", "mean_over_sessions"}
