"""The port's CSR spike codec (``data/sparse.py``) against the JAX
package's, on the same seeded numpy spikes.

The host codec is the same numpy in both packages, so every comparison is
exact: the CSR lists, the dense decode, the flattened COO arrays and the
nnz guard. ``decode_spikes_on_device`` is a ``scatter_add_`` in the port
and a vmapped XLA scatter in JAX; each trial's indices are unique and the
padding adds exact zeros, so both equal the host decode bit for bit (here
on CPU tensors; ``chip_smoke.py`` ``real_data`` holds it on the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per xdist worker)
from multi_modal_foundation_model_tpu.data import sparse as jsparse
from multi_modal_foundation_model_tpu_torch.data import sparse as tsparse


def _spikes(seed=0, K=6, T=12, N=9, rate=0.6):
    rng = np.random.default_rng(seed)
    spikes = rng.poisson(rate, (K, T, N)).astype(np.float32)
    spikes[1] = 0.0                      # an empty trial
    return spikes


@pytest.mark.parametrize("rate", [0.05, 0.6, 3.0])
def test_csr_round_trip_matches_jax(rate):
    spikes = _spikes(rate=rate)
    rows = tsparse.dense_to_sparse_rows(spikes)
    jrows = jsparse.dense_to_sparse_rows(spikes)
    assert rows == jrows
    dense = tsparse.sparse_rows_to_dense(*rows)
    np.testing.assert_array_equal(dense, jsparse.sparse_rows_to_dense(*jrows))
    np.testing.assert_array_equal(dense, spikes)
    assert dense.dtype == np.float64


def test_hub_nested_lists_decode():
    """The hub returns every column as nested lists (shapes too)."""
    spikes = _spikes(seed=1)
    data, indices, indptr, shape = tsparse.dense_to_sparse_rows(spikes)
    shape = [list(s) for s in shape]
    np.testing.assert_array_equal(
        tsparse.sparse_rows_to_dense(data, indices, indptr, shape),
        jsparse.sparse_rows_to_dense(data, indices, indptr, shape))


@pytest.mark.parametrize("extra", [0, 5])
def test_flatten_csr_rows_matches_jax(extra):
    rows = tsparse.dense_to_sparse_rows(_spikes(seed=2))
    max_nnz = max(len(d) for d in rows[0]) + extra
    got = tsparse.flatten_csr_rows(*rows, max_nnz=max_nnz)
    want = jsparse.flatten_csr_rows(*rows, max_nnz=max_nnz)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_flatten_nnz_guard_matches_jax():
    rows = tsparse.dense_to_sparse_rows(_spikes(seed=3))
    max_nnz = max(len(d) for d in rows[0]) - 1
    with pytest.raises(ValueError) as got:
        tsparse.flatten_csr_rows(*rows, max_nnz=max_nnz)
    with pytest.raises(ValueError) as want:
        jsparse.flatten_csr_rows(*rows, max_nnz=max_nnz)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed,extra", [(4, 0), (5, 17)])
def test_decode_on_device_matches_jax_and_host(seed, extra):
    """The port's decode of CPU tensors, JAX's jitted decode and the host
    decode are equal bit for bit, padding slots included."""
    spikes = _spikes(seed=seed, K=5, T=10, N=7, rate=1.5)
    rows = tsparse.dense_to_sparse_rows(spikes)
    max_nnz = max(len(d) for d in rows[0]) + extra
    coo = tsparse.flatten_csr_rows(*rows, max_nnz=max_nnz)
    T, N = spikes.shape[1:]
    got = tsparse.decode_spikes_on_device(
        *(torch.as_tensor(a) for a in coo), T=T, N=N)
    want = np.asarray(jsparse.decode_spikes_on_device(
        *(jnp.asarray(a) for a in coo), T=T, N=N))
    assert got.dtype == torch.float32 and got.shape == (5, T, N)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), tsparse.sparse_rows_to_dense(*rows).astype(np.float32))


def test_decode_zeroes_padding_values():
    """A padding slot with a stray value and an out-of-range index adds
    nothing (its value is zeroed, its index clamped), as in JAX."""
    values = np.array([[2.0, 9.0]], np.float32)
    time_ids = np.array([[1, 40]], np.int32)
    chan_ids = np.array([[2, 40]], np.int32)
    valid = np.array([[True, False]])
    got = tsparse.decode_spikes_on_device(
        *(torch.as_tensor(a) for a in (values, time_ids, chan_ids, valid)),
        T=3, N=4)
    want = np.asarray(jsparse.decode_spikes_on_device(
        *(jnp.asarray(a) for a in (values, time_ids, chan_ids, valid)),
        T=3, N=4))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum() == 2.0 and got[0, 1, 2] == 2.0
