from .loader import (Batch, DataLoader, attention_mask,
                     get_length_grouped_indices,
                     get_length_grouped_indices_stitched, load_nemo_units,
                     make_loader, pad_seq_left_to_n, pad_seq_right_to_n,
                     prepare_split, wrap_pad_neuron_up_to_n,
                     wrap_pad_temporal_right_to_n)
from .session import (DEFAULT_TARGETS, SessionData, SessionSplits,
                      load_ibl_dataset, load_ibl_session, synthetic_session,
                      synthetic_splits)
from .sparse import (decode_spikes_on_device, dense_to_sparse_rows,
                     flatten_csr_rows, sparse_rows_to_dense)

__all__ = [
    "Batch", "DataLoader", "DEFAULT_TARGETS", "SessionData",
    "SessionSplits", "attention_mask", "decode_spikes_on_device",
    "dense_to_sparse_rows", "flatten_csr_rows", "get_length_grouped_indices",
    "get_length_grouped_indices_stitched", "load_ibl_dataset",
    "load_ibl_session", "load_nemo_units", "make_loader",
    "pad_seq_left_to_n", "pad_seq_right_to_n", "prepare_split",
    "sparse_rows_to_dense", "synthetic_session", "synthetic_splits",
    "wrap_pad_neuron_up_to_n", "wrap_pad_temporal_right_to_n",
]
