"""Seeds derived from seeds: the port's counterpart of ``jax.random.fold_in``.

Every random draw of a training step is a pure function of (trainer seed,
step, site): the trainer folds the step into its seed, the model folds in
the modality or layer, each layer folds in its dropout site. A draw made
from such a seed (a fresh ``torch.Generator`` or the kernels' Philox key)
repeats exactly when ``torch.utils.checkpoint`` recomputes a layer, and
when a restored run replays a step. Host-side integers only: nothing here
touches a device.
"""

from __future__ import annotations

_MASK64 = (1 << 64) - 1


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
