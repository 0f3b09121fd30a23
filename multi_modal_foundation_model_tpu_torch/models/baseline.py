"""Linear baseline models (``nn.Module``).

Port of ``multi_modal_foundation_model_tpu/models/baseline.py:24-74``:

- ``BaselineEncoder``: behavior -> spikes, one Linear over the flattened
  trial ``(B, T * C_in) -> (B, T * C_out)``, reshaped to ``(B, T, N)``;
  its loss is the Poisson NLL on log-rates (no Stirling term), summed and
  divided by the batch size.
- ``BaselineDecoder``: spikes -> behavior, one Linear per time bin; its
  loss is the squared error, summed and divided by the batch size.

Both compute the loss in f32 and hold their one Linear as ``layer``, so
the ``state_dict`` names are the reference's ``layer.weight`` and
``layer.bias``. Initialization is torch's default (JAX's
``torch_linear_init`` / ``torch_bias_init``: U(+-1/sqrt(fan_in)) for the
weight and the bias), drawn from ``generator`` (default: a generator
seeded with 0) on ``device`` (default: the card; the CPU must be asked
for). No kernel is written for them: JAX computes both products with XLA,
outside any Pallas kernel, and here they run on cuBLAS.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from ..ops.losses import poisson_nll_elementwise
from ..utils.device import DeviceLike, resolve_device
from .layers import reset_parameters_


@dataclasses.dataclass
class BaselineOutput:
    loss: torch.Tensor
    n_examples: torch.Tensor
    preds: torch.Tensor
    targets: torch.Tensor


class _Baseline(nn.Module):
    def __init__(self, layer: nn.Linear, device: DeviceLike,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.layer = layer
        reset_parameters_(self, generator or torch.Generator().manual_seed(0))
        self.to(resolve_device(device))

    def _output(self, preds, targets, elementwise) -> BaselineOutput:
        B = targets.shape[0]
        loss = elementwise(preds.float(), targets.float()).sum() / B
        return BaselineOutput(loss=loss, n_examples=torch.tensor(B),
                              preds=preds, targets=targets)


class BaselineEncoder(_Baseline):
    """behavior -> spikes through one flattened-trial linear map."""

    def __init__(self, in_channel: int, out_channel: int, seq_len: int = 100,
                 *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(nn.Linear(seq_len * in_channel,
                                   seq_len * out_channel), device, generator)
        self.in_channel, self.out_channel = in_channel, out_channel
        self.seq_len = seq_len

    def forward(self, data_dict: Dict[str, torch.Tensor]) -> BaselineOutput:
        inputs, targets = data_dict["inputs"], data_dict["targets"]
        B, T, N = targets.shape
        preds = self.layer(inputs.reshape(B, self.seq_len * self.in_channel)
                           ).reshape(B, T, N)
        return self._output(preds, targets, poisson_nll_elementwise)


class BaselineDecoder(_Baseline):
    """spikes -> behavior through one linear map per time bin."""

    def __init__(self, in_channel: int, out_channel: int, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(nn.Linear(in_channel, out_channel), device,
                         generator)
        self.in_channel, self.out_channel = in_channel, out_channel

    def forward(self, data_dict: Dict[str, torch.Tensor]) -> BaselineOutput:
        preds = self.layer(data_dict["inputs"])
        return self._output(preds, data_dict["targets"],
                            lambda p, t: torch.square(p - t))
