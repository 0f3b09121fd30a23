"""Philox draws keyed from the device: ``csrc/random.cu`` + plain versions.

Every random draw of a training step outside the attention kernels goes
through here: layer and embedding dropout's bytes (``u8_bits``, JAX's
``U8_DROPOUT_BITS`` policy, ``models/layers.py:227-240`` of the JAX
package) and the masker's Bernoulli uniforms (``uniform``). A draw is a
pure function of (key, stream, element index):

- the **key** is a one-element int64 tensor, an entry of the step's seed
  table (``utils/rng.py``) on the tensor's device; the kernel reads it from
  device memory, so a CUDA graph of the step replayed with a new table
  draws what the eager step with those seeds draws, and a
  ``torch.utils.checkpoint`` recompute draws the forward's bits again;
- the **stream** is a small constant of the call site, so one key can feed
  several independent draws (the masker's corruption draws three).

Element e comes from Philox4x32-10 (Salmon et al., SC'11) with counter
(n lo, n hi, stream, kind) and key (key lo, key hi): bytes (kind 0) take
n = e // 16 and byte e % 16 of the four little-endian output words;
uniforms (kind 1) take n = e // 4, word e % 4, and (word >> 8) * 2^-24,
24 bits in [0, 1) that f32 holds exactly. The plain versions draw the same
bits with torch integer operations (as ``philox_bits`` does for the
attention kernels), on any device.

Dispatch: a CPU key takes the plain version; a CUDA key launches the
kernel or raises. ``PHILOX_LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Union

import torch

PHILOX_LAUNCHES = 0

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)

SeedLike = Union[int, torch.Tensor]


def _mulhilo32(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of the 64-bit product of the constant ``a``
    and the uint32 values held in int64 ``b``. The product would overflow
    int64, so both operands are split into 16-bit halves."""
    ah, al = a >> 16, a & 0xFFFF
    bh, bl = b >> 16, b & 0xFFFF
    mid = ah * bl + al * bh                     # < 2^33
    low = al * bl + ((mid & 0xFFFF) << 16)      # < 2^33
    hi = ah * bh + (mid >> 16) + (low >> 32)
    return hi & _MASK32, low & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 of counters held in int64 tensors (uint32 values,
    broadcastable) under the key (k0, k1), each a host int or an int64
    tensor broadcastable to the counters; returns the four output words as
    int64 tensors of uint32 values."""
    k0 = k0 & _MASK32 if isinstance(k0, torch.Tensor) else int(k0) & _MASK32
    k1 = k1 & _MASK32 if isinstance(k1, torch.Tensor) else int(k1) & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo32(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def seed_tensor(seed: SeedLike, device) -> torch.Tensor:
    """The one-element int64 key tensor of ``seed`` on ``device``: a table
    entry is checked and returned as it is; a host int is copied there
    (eagerly: a copy from the host cannot be captured in a CUDA graph)."""
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int64 or seed.numel() != 1:
            raise ValueError(f"a seed tensor is one int64, got "
                             f"{seed.dtype} {tuple(seed.shape)}")
        want = torch.device(device)
        if seed.device.type != want.type or (
                want.index is not None and seed.device.index != want.index):
            raise ValueError(f"seed on {seed.device}, draw on {device}")
        return seed.reshape(1)
    return torch.tensor([int(seed)], dtype=torch.int64, device=device)


def _key(seed: SeedLike, device) -> torch.Tensor:
    """The key tensor: a table entry where it lies, a host int on
    ``device`` (the CPU by default)."""
    if isinstance(seed, torch.Tensor):
        return seed_tensor(seed, seed.device)
    return seed_tensor(seed, device if device is not None else "cpu")


def _words(key: torch.Tensor, n_blocks: int, stream: int, kind: int):
    """(n_blocks, 4) int64 uint32 words of counters 0..n_blocks-1."""
    s = key.reshape(())
    blk = torch.arange(n_blocks, dtype=torch.int64, device=key.device)
    zero = torch.zeros_like(blk)
    words = philox4x32_10(blk & _MASK32, blk >> 32, zero + int(stream),
                          zero + int(kind), s & _MASK32, (s >> 32) & _MASK32)
    return torch.stack(words, dim=-1)


def u8_bits_reference(seed: SeedLike, shape: Sequence[int], stream: int = 0,
                      device=None) -> torch.Tensor:
    """Plain version of the byte draw: a uint8 tensor of ``shape``."""
    key = _key(seed, device)
    n = _numel(shape)
    words = _words(key, -(-n // 16), stream, 0)              # (nb, 4)
    shifts = torch.arange(0, 32, 8, device=key.device)
    data = (words[..., None] >> shifts) & 0xFF                 # (nb, 4, 4)
    return data.reshape(-1)[:n].to(torch.uint8).reshape(tuple(shape))


def uniform_reference(seed: SeedLike, shape: Sequence[int], stream: int = 0,
                      device=None) -> torch.Tensor:
    """Plain version of the uniform draw: an f32 tensor of ``shape`` in
    [0, 1)."""
    key = _key(seed, device)
    n = _numel(shape)
    words = _words(key, -(-n // 4), stream, 1).reshape(-1)[:n]
    return ((words >> 8).to(torch.float32) * 2.0 ** -24).reshape(
        tuple(shape))


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _lib():
    from . import build

    lib = build.load("random")
    for fn in (lib.mmfm_philox_u8, lib.mmfm_philox_uniform):
        if fn.argtypes is None:
            p = ctypes.c_void_p
            fn.argtypes = [p, ctypes.c_uint, p, ctypes.c_longlong, p]
            fn.restype = ctypes.c_int
    return lib


def _launch(name: str, key: torch.Tensor, stream: int,
            out: torch.Tensor) -> torch.Tensor:
    global PHILOX_LAUNCHES
    if not key.is_contiguous():
        raise ValueError("philox draw: the key must be contiguous")
    fn = getattr(_lib(), name)
    with torch.cuda.device(out.device):
        cs = torch.cuda.current_stream(out.device).cuda_stream
        rc = fn(key.data_ptr(), int(stream) & _MASK32, out.data_ptr(),
                out.numel(), cs)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    PHILOX_LAUNCHES += 1
    return out


def u8_bits(seed: SeedLike, shape: Sequence[int], stream: int = 0,
            device=None) -> torch.Tensor:
    """Random bytes of ``shape`` under ``seed`` (a table entry, or a host
    int copied to ``device``): the kernel for a CUDA key, the plain version
    for a CPU one."""
    key = _key(seed, device)
    if key.device.type != "cuda":
        return u8_bits_reference(key, shape, stream)
    out = torch.empty(tuple(shape), dtype=torch.uint8, device=key.device)
    return _launch("mmfm_philox_u8", key, stream, out)


def uniform(seed: SeedLike, shape: Sequence[int], stream: int = 0,
            device=None) -> torch.Tensor:
    """f32 uniforms in [0, 1) of ``shape`` under ``seed``: the kernel for a
    CUDA key, the plain version for a CPU one."""
    key = _key(seed, device)
    if key.device.type != "cuda":
        return uniform_reference(key, shape, stream)
    out = torch.empty(tuple(shape), dtype=torch.float32, device=key.device)
    return _launch("mmfm_philox_uniform", key, stream, out)
