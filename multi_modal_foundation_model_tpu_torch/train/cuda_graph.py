"""Training steps as CUDA-graph replays: the port's counterpart of JAX's
K-step ``lax.scan`` (``multi_modal_foundation_model_tpu/train/trainer.py``,
``_get_multi_step_dr``, :490).

A step of the resident path reads all it needs from fixed device buffers
(``StepInputs``): its row of the group's inputs (batch indices, the valid
mask, the seed table, the optimizer's scalars and the masker's host draws),
chosen by a cursor on the device that the step advances itself, and it
writes its loss into the group's loss slots. So one captured graph of the
step serves every step of a run that has the same variant (batch size,
objective, MtM scheme, accumulate or update), and a group of K steps is
one upload of K rows and K replays with no host work between them.

``StepGraphs.run`` takes a variant's key and its step function:

- the first time a key comes up, the step runs eagerly on a side stream:
  that run is a real step (it advances the cursor and trains) and it warms
  up cuBLAS, the kernel libraries and their launch plans; the variant is
  captured after it, so no state changes twice (capturing records and runs
  nothing);
- after that, the variant's graph is replayed.

Every graph shares one memory pool: they replay in sequence on one stream,
and nothing a step allocates outlives it. A capture or a replay that fails
raises; there is no eager way around the graph on the card. On the CPU
(where CUDA graphs do not exist) the step runs eagerly every time, from
the same buffers.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Hashable, List, Optional

import numpy as np
import torch


class StepInputs:
    """The group buffers of a run's steps: ``rows`` (max_steps, width)
    int32 on the device, its pinned host ring (two buffers, each guarded by
    the event of its last copy, so the host never overwrites a buffer whose
    copy is in flight), the cursor, and the loss slots."""

    def __init__(self, max_steps: int, width: int, device):
        self.device = torch.device(device)
        self.max_steps, self.width = int(max_steps), int(width)
        cuda = self.device.type == "cuda"
        self.rows = torch.zeros((max_steps, width), dtype=torch.int32,
                                device=self.device)
        self.cursor = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.losses = torch.zeros(max_steps, dtype=torch.float32,
                                  device=self.device)
        self._ring = [torch.zeros((max_steps, width), dtype=torch.int32,
                                  pin_memory=cuda) for _ in range(2)]
        self._events: List[Optional[torch.cuda.Event]] = [None, None]
        self._next = 0

    def upload(self, rows: np.ndarray) -> None:
        """Copy ``rows`` (n, width) int32 into the first n device rows in
        one copy, and set the cursor to row 0."""
        n = len(rows)
        if n > self.max_steps or rows.shape[1] != self.width:
            raise ValueError(f"rows {rows.shape} for a buffer of "
                             f"({self.max_steps}, {self.width})")
        i = self._next
        self._next ^= 1
        if self._events[i] is not None:
            self._events[i].synchronize()     # its last copy has landed
        host = self._ring[i]
        host[:n].copy_(torch.from_numpy(rows))
        self.rows[:n].copy_(host[:n], non_blocking=True)
        if self.device.type == "cuda":
            if self._events[i] is None:
                self._events[i] = torch.cuda.Event()
            self._events[i].record()
        self.cursor.zero_()

    def current_row(self) -> torch.Tensor:
        """The cursor's row (a device read, no host sync)."""
        return self.rows.index_select(0, self.cursor)[0]

    def finish_step(self, loss: torch.Tensor) -> None:
        """Write the step's loss into its slot and advance the cursor."""
        self.losses.index_copy_(0, self.cursor,
                                loss.detach().float().reshape(1))
        self.cursor.add_(1)


class StepGraphs:
    """One CUDA graph per step variant on ``device``; eager on the CPU."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.graphs: Dict[Hashable, torch.cuda.CUDAGraph] = {}
        self.capture_s: Dict[Hashable, float] = {}
        self.replays = 0
        self._cuda = self.device.type == "cuda"
        self._pool = torch.cuda.graph_pool_handle() if self._cuda else None
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None

    def run(self, key: Hashable, step: Callable[[], None]) -> None:
        """Run ``step``: eagerly on the CPU; on the card, replay the key's
        graph, or (first occurrence) run it eagerly on a side stream and
        capture it."""
        if not self._cuda:
            step()
            return
        graph = self.graphs.get(key)
        if graph is not None:
            graph.replay()
            self.replays += 1
            return
        cur = torch.cuda.current_stream(self.device)
        side = self._stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            step()
        cur.wait_stream(side)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=side):
            step()
        self.capture_s[key] = time.perf_counter() - t0
        self.graphs[key] = graph
