"""Per-sample rows of a stitched parameter stack, with a fixed-order
backward: ``csrc/session_rows.cu`` + its plain version.

A session-mixed batch (``TrainerConfig.mixed_session_batches``) runs each
sample through its own session's rows of the stitched stacks (JAX
``jnp.take(W, session_ids, axis=0)``, ``models/layers.py:651-658``,
``:686-690`` of the JAX package). ``session_rows(stack, ids, dtype)`` is
that gather: ``stack`` (S, ...) cast to ``dtype`` first (the cast is
elementwise, so casting the S rows before gathering B of them gives the
values JAX's gather-then-cast gives, with fewer bytes written), then row
``ids[b]`` for each sample, (B, ...).

Its backward sums the gradient rows of each session in f32, over the
samples in ascending order, from zero: ``out[s] = sum_{b: ids[b] = s}
g[b]``, exact zeros for the sessions absent from the batch, returned in the
stack's dtype. The order is fixed, so a CUDA-graph replay of a training
step equals the eager step bit for bit; torch's own ``index_select``
backward sums repeated ids with atomics on the card, in an order that
changes between runs.

Dispatch: CPU tensors take the plain version (a loop over the samples);
CUDA tensors launch the kernel or raise. ``SESSION_ROWS_LAUNCHES`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

SESSION_ROWS_LAUNCHES = 0
_MAX_ROWS = 12288                      # the kernel's shared row list
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def session_rows_grad_reference(g: torch.Tensor, ids: torch.Tensor,
                                n_sessions: int) -> torch.Tensor:
    """Plain version: (S, *g.shape[1:]) f32 sums of ``g``'s rows by
    ``ids``, each session's rows added in ascending order from zero."""
    out = torch.zeros((int(n_sessions),) + tuple(g.shape[1:]),
                      dtype=torch.float32, device=g.device)
    for b, s in enumerate(ids.tolist()):
        out[s] += g[b].float()
    return out


def _lib():
    from . import build

    lib = build.load("session_rows")
    fn = lib.mmfm_session_rows_grad
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_int, p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, p, p]
        fn.restype = ctypes.c_int
    return lib


def session_rows_grad(g: torch.Tensor, ids: torch.Tensor,
                      n_sessions: int) -> torch.Tensor:
    """(S, *g.shape[1:]) f32 row sums of ``g`` (B, ...) by ``ids`` (B,):
    the kernel for CUDA tensors, the plain version for CPU ones."""
    global SESSION_ROWS_LAUNCHES
    if g.device.type != "cuda":
        return session_rows_grad_reference(g, ids, n_sessions)
    if g.dtype not in _DTYPES:
        raise ValueError(f"session_rows_grad: {g.dtype} is not f32 or bf16")
    B = int(g.shape[0])
    if ids.shape != (B,) or B > _MAX_ROWS:
        raise ValueError(f"session_rows_grad: ids {tuple(ids.shape)} for "
                         f"{B} rows (at most {_MAX_ROWS})")
    g2 = g.contiguous().reshape(B, -1)
    ids = ids.to(device=g.device, dtype=torch.int64).contiguous()
    out = torch.empty((int(n_sessions), g2.shape[1]), dtype=torch.float32,
                      device=g.device)
    with torch.cuda.device(g.device):
        cs = torch.cuda.current_stream(g.device).cuda_stream
        rc = _lib().mmfm_session_rows_grad(
            g2.data_ptr(), _DTYPES[g.dtype], ids.data_ptr(), B,
            int(n_sessions), g2.shape[1], out.data_ptr(), cs)
    if rc != 0:
        raise RuntimeError(f"session_rows_grad: kernel launch failed "
                           f"(cudaError {rc})")
    SESSION_ROWS_LAUNCHES += 1
    return out.reshape((int(n_sessions),) + tuple(g.shape[1:]))


class _SessionRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stack, ids, dtype):
        ctx.save_for_backward(ids)
        ctx.n_sessions, ctx.stack_dtype = stack.shape[0], stack.dtype
        src = stack if dtype is None else stack.to(dtype)
        return src.index_select(0, ids)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        out = session_rows_grad(grad, ids, ctx.n_sessions)
        return out.to(ctx.stack_dtype), None, None


def session_rows(stack: torch.Tensor, ids: torch.Tensor,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Rows ``ids`` (B,) int64 of ``stack`` (S, ...) cast to ``dtype``,
    (B, ...), with the fixed-order backward of the module docstring."""
    return _SessionRows.apply(stack, ids, dtype)
