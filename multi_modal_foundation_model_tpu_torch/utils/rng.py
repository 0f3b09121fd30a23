"""Seeds derived from seeds: the port's counterpart of ``jax.random.fold_in``.

Every random draw of a training step is a pure function of (trainer seed,
step, site): the trainer folds the step into its seed, the model folds in
the modality or layer, each layer folds in its dropout site. The host
computes every site's seed of one step at once, as a **seed table**
(``seed_table``): one flat int64 vector, one entry per site, in an order
fixed per model (``MultiModal.seed_paths``). The step uploads it with its
other inputs, and every kernel that draws (the Philox draws of
``ops/random.py``, K1 and K2's dropout) reads its key from its entry on
the device. So a draw repeats exactly when ``torch.utils.checkpoint``
recomputes a layer, when a CUDA graph of the step is replayed with the
table of another step, and when a restored run replays a step. Host-side
integers only: nothing here touches a device.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

_MASK64 = (1 << 64) - 1

# a site's path: the ``data`` of each nested fold_in, outermost first, so
# ((1,), (2, 4), (0,)) is fold_in(fold_in(fold_in(seed, 1), 2, 4), 0)
SeedPath = Tuple[Tuple[int, ...], ...]


def _mix64(x: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit integers."""
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _MASK64
    return x ^ (x >> 31)


def fold_in(seed: int, *data: int) -> int:
    """A 63-bit seed (``torch.Generator.manual_seed`` takes it) derived from
    ``seed`` and each of ``data`` in turn."""
    x = int(seed) & _MASK64
    for d in data:
        x = _mix64((x + 0x9E3779B97F4A7C15 * (int(d) + 1)) & _MASK64)
    return x >> 1


def seed_table(seed: int, paths: Sequence[SeedPath]) -> np.ndarray:
    """(len(paths),) int64: entry i is ``seed`` folded along ``paths[i]``
    (each shared prefix is folded once)."""
    memo: Dict[SeedPath, int] = {(): int(seed)}

    def fold(path: SeedPath) -> int:
        if path not in memo:
            memo[path] = fold_in(fold(path[:-1]), *path[-1])
        return memo[path]

    return np.array([fold(tuple(p)) for p in paths], dtype=np.int64)
