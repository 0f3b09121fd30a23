"""CSR spike codec: the hub's sparse rows <-> dense binned spikes.

The port's copy of ``multi_modal_foundation_model_tpu/data/sparse.py``. The
hub stores each trial as a CSR triplet (data, indices, indptr) plus its
shape, each a Python list (the reference's ``src/utils/dataset_utils.py``
schema). The host codec is numpy (bit-equal to JAX's);
``decode_spikes_on_device`` is the torch counterpart of JAX's jitted
scatter: fixed-size COO arrays (``flatten_csr_rows``) scattered into dense
``(K, T, N)`` spikes on the tensors' device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from scipy.sparse import csr_array


def dense_to_sparse_rows(binned_spikes: np.ndarray):
    """Dense (K, T, N) spikes as per-trial CSR lists: ``(data_list,
    indices_list, indptr_list, shape_list)``, the hub's storage columns."""
    data_list, indices_list, indptr_list, shape_list = [], [], [], []
    for k in range(binned_spikes.shape[0]):
        trial = np.asarray(binned_spikes[k])
        m = csr_array(trial, dtype=np.ubyte)
        data_list.append(np.asarray(m.data).tolist())
        indices_list.append(np.asarray(m.indices).tolist())
        indptr_list.append(np.asarray(m.indptr).tolist())
        shape_list.append(tuple(trial.shape))
    return data_list, indices_list, indptr_list, shape_list


def sparse_rows_to_dense(data_list: Sequence, indices_list: Sequence,
                         indptr_list: Sequence,
                         shape_list: Sequence) -> np.ndarray:
    """Per-trial CSR lists -> dense (K, T, N) float64 spikes (host path)."""
    out = []
    for data, indices, indptr, shape in zip(data_list, indices_list,
                                            indptr_list, shape_list):
        T, N = int(shape[0]), int(shape[1])
        dense = np.zeros((T, N), dtype=np.float64)
        data = np.asarray(data)
        indices = np.asarray(indices, dtype=np.int64)
        indptr = np.asarray(indptr, dtype=np.int64)
        for t in range(T):
            lo, hi = indptr[t], indptr[t + 1]
            dense[t, indices[lo:hi]] = data[lo:hi]
        out.append(dense)
    return np.stack(out, axis=0)


def flatten_csr_rows(data_list: Sequence, indices_list: Sequence,
                     indptr_list: Sequence, shape_list: Sequence,
                     max_nnz: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
    """Per-trial CSR -> fixed-shape COO ``(values, time_ids, chan_ids,
    valid)``, each ``(K, max_nnz)``; entries past a trial's nnz are zero and
    invalid. A trial with more than ``max_nnz`` nonzeros raises."""
    K = len(data_list)
    values = np.zeros((K, max_nnz), dtype=np.float32)
    time_ids = np.zeros((K, max_nnz), dtype=np.int32)
    chan_ids = np.zeros((K, max_nnz), dtype=np.int32)
    valid = np.zeros((K, max_nnz), dtype=np.bool_)
    for k, (data, indices, indptr, shape) in enumerate(
            zip(data_list, indices_list, indptr_list, shape_list)):
        data = np.asarray(data, dtype=np.float32)
        indices = np.asarray(indices, dtype=np.int32)
        indptr = np.asarray(indptr, dtype=np.int64)
        nnz = int(data.shape[0])
        if nnz > max_nnz:
            raise ValueError(f"trial {k}: nnz={nnz} exceeds max_nnz={max_nnz}")
        # row (time-bin) id per nonzero from indptr run lengths
        rows = np.repeat(np.arange(len(indptr) - 1, dtype=np.int32),
                         np.diff(indptr))
        values[k, :nnz] = data
        time_ids[k, :nnz] = rows
        chan_ids[k, :nnz] = indices
        valid[k, :nnz] = True
    return values, time_ids, chan_ids, valid


def decode_spikes_on_device(values: torch.Tensor, time_ids: torch.Tensor,
                            chan_ids: torch.Tensor, valid: torch.Tensor,
                            T: int, N: int) -> torch.Tensor:
    """Scatter flattened CSR nonzeros into dense (K, T, N) spikes on the
    tensors' device: one ``scatter_add_`` into ``(K, T*N)``. Padding
    entries add a zero at a clamped index (JAX :118-123). The indices of a
    trial are unique and the padding adds exact zeros, so the result equals
    the host decode bit for bit."""
    values = torch.where(valid, values, torch.zeros((), dtype=values.dtype,
                                                    device=values.device))
    flat = time_ids.long() * N + chan_ids.long()
    flat = flat.clamp(0, T * N - 1)
    dense = torch.zeros((values.shape[0], T * N), dtype=values.dtype,
                        device=values.device)
    dense.scatter_add_(1, flat, values)
    return dense.reshape(-1, T, N)
