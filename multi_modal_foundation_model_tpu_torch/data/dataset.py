"""Dataset layer: hub session datasets, the NLB/h5 reader, paired splits.

The port's copy of ``multi_modal_foundation_model_tpu/data/dataset.py``
(the reference's ``src/utils/dataset_utils.py``), over the port's CSR codec
(``data/sparse.py``):

- ``create_dataset`` / ``upload_dataset`` / ``download_dataset`` /
  ``get_user_datasets``: dense spikes + behaviors + metadata -> Hugging
  Face ``Dataset`` rows in the hub's column schema, and the hub's calls
  (``datasets`` and ``huggingface_hub``, imported inside them);
- ``get_data_from_h5``: the NLB / LFADS h5 reader (``h5py``, imported
  inside it), numpy out;
- ``split_both_dataset``: the paired aligned/unaligned split keyed on trial
  start times;
- ``read_eid_list``: the eid allow/deny lists.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .sparse import dense_to_sparse_rows

DATASET_MODES = type("DATASET_MODES", (), {"train": "train", "val": "val",
                                           "test": "test", "trainval": "trainval"})


def read_eid_list(path: str) -> list:
    """One eid per line (reference ``get_target_eids``/``get_test_re_eids``)."""
    with open(path) as f:
        return [line.rstrip() for line in f]


def create_dataset(binned_spikes: np.ndarray, eid: str,
                   params: Dict, meta_data: Optional[Dict] = None,
                   binned_behaviors: Optional[Dict[str, np.ndarray]] = None):
    """Dense (K, T, N) spikes (+behaviors, +metadata) -> HF Dataset rows."""
    from datasets import Dataset  # heavy import, kept local

    data_list, indices_list, indptr_list, shape_list = \
        dense_to_sparse_rows(binned_spikes)
    K = len(data_list)
    data_dict = {
        "spikes_sparse_data": data_list,
        "spikes_sparse_indices": indices_list,
        "spikes_sparse_indptr": indptr_list,
        "spikes_sparse_shape": shape_list,
    }
    if binned_behaviors is not None:
        data_dict.update({k: list(np.asarray(v))
                          for k, v in binned_behaviors.items()})
    if meta_data is not None:
        meta_dict = {
            "binsize": [params["binsize"]] * K,
            "interval_len": [params["interval_len"]] * K,
            "eid": [meta_data["eid"]] * K,
            "probe_name": [meta_data.get("probe_name")] * K,
            "subject": [meta_data.get("subject")] * K,
            "lab": [meta_data.get("lab")] * K,
            "sampling_freq": [meta_data.get("sampling_freq")] * K,
            "cluster_regions": [meta_data["cluster_regions"]] * K,
            "cluster_channels": [meta_data.get("cluster_channels")] * K,
            "cluster_depths": [meta_data.get("cluster_depths")] * K,
            "good_clusters": [meta_data.get("good_clusters")] * K,
            "cluster_uuids": [meta_data.get("uuids")] * K,
            "cluster_qc": [meta_data.get("cluster_qc")] * K,
        }
        data_dict.update(meta_dict)
    return Dataset.from_dict(data_dict)


def upload_dataset(dataset, org: str, eid: str, is_private: bool = True):
    dataset.push_to_hub(f"{org}/{eid}", private=is_private)


def download_dataset(org: str, eid: str, split: str = "train",
                     cache_dir: Optional[str] = None):
    from datasets import load_dataset

    if cache_dir is None:
        return load_dataset(f"{org}/{eid}", split=split)
    return load_dataset(f"{org}/{eid}", split=split, cache_dir=cache_dir)


def get_user_datasets(user_or_org_name: str) -> list:
    from huggingface_hub import list_datasets

    return [d.id for d in list_datasets(author=user_or_org_name)]


# ---------------------------------------------------------------------------
# NLB / LFADS legacy h5 reader
# ---------------------------------------------------------------------------

def get_data_from_h5(mode: str, filepath: str, use_lograte: bool = True,
                     log_epsilon: float = 1e-7):
    """Returns (spikes, rates, heldout_spikes, forward-pred spikes).

    NLB datasets carry heldout neurons/time; LFADS-type datasets carry
    ground-truth rates (optionally log-transformed). Parity with
    ``dataset_utils.py:91-156``.
    """
    import h5py

    NLB_KEY = "spikes"
    with h5py.File(filepath, "r") as h5file:
        h5dict = {key: h5file[key][()] for key in h5file.keys()}

    if f"eval_{NLB_KEY}_heldin" not in h5dict and "eval_data_heldin" in h5dict:
        NLB_KEY = "data"

    if f"eval_{NLB_KEY}_heldin" in h5dict:
        def get_key(key):
            return h5dict[key].astype(np.float32)

        train_data = get_key(f"train_{NLB_KEY}_heldin")
        train_data_fp = get_key(f"train_{NLB_KEY}_heldin_forward")
        train_data_heldout_fp = get_key(f"train_{NLB_KEY}_heldout_forward")
        train_data_all_fp = np.concatenate(
            [train_data_fp, train_data_heldout_fp], -1)
        valid_data = get_key(f"eval_{NLB_KEY}_heldin")
        train_data_heldout = get_key(f"train_{NLB_KEY}_heldout")
        if f"eval_{NLB_KEY}_heldout" in h5dict:
            valid_data_heldout = get_key(f"eval_{NLB_KEY}_heldout")
        else:
            valid_data_heldout = np.zeros(
                (valid_data.shape[0], valid_data.shape[1],
                 train_data_heldout.shape[2]), dtype=np.float32)
        if f"eval_{NLB_KEY}_heldin_forward" in h5dict:
            valid_data_fp = get_key(f"eval_{NLB_KEY}_heldin_forward")
            valid_data_heldout_fp = get_key(
                f"eval_{NLB_KEY}_heldout_forward")
            valid_data_all_fp = np.concatenate(
                [valid_data_fp, valid_data_heldout_fp], -1)
        else:
            valid_data_all_fp = np.zeros(
                (valid_data.shape[0], train_data_fp.shape[1],
                 valid_data.shape[2] + valid_data_heldout.shape[2]),
                dtype=np.float32)
        if mode == "train":
            return train_data, None, train_data_heldout, train_data_all_fp
        if mode == "val":
            return valid_data, None, valid_data_heldout, valid_data_all_fp

    train_data = h5dict["train_data"].astype(np.float32).squeeze()
    valid_data = h5dict["valid_data"].astype(np.float32).squeeze()
    train_rates = valid_rates = None
    if "train_truth" in h5dict and "valid_truth" in h5dict:
        train_rates = h5dict["train_truth"].astype(np.float32)
        valid_rates = h5dict["valid_truth"].astype(np.float32)
        train_rates = train_rates / h5dict["conversion_factor"]
        valid_rates = valid_rates / h5dict["conversion_factor"]
        if use_lograte:
            train_rates = np.log(train_rates + log_epsilon)
            valid_rates = np.log(valid_rates + log_epsilon)

    if mode == "train":
        return train_data, train_rates, None, None
    if mode == "val":
        return valid_data, valid_rates, None, None
    return None, None, None, None


# ---------------------------------------------------------------------------
# paired aligned/unaligned split
# ---------------------------------------------------------------------------

def _time_extract(data):
    data["time"] = data["intervals"][0]
    return data


def split_both_dataset(aligned_dataset, unaligned_dataset,
                       train_size: float = 0.9, test_size: float = 0.1,
                       shuffle: bool = True, seed: int = 42):
    """Split aligned data, then route unaligned chunks whose start time lies
    within 2 s of any aligned test trial into the unaligned test split."""
    from datasets import DatasetDict

    assert train_size + test_size == 1, \
        "The sum of train/test is not equal to 1."

    aligned_dataset = aligned_dataset.map(_time_extract)
    unaligned_dataset = unaligned_dataset.map(_time_extract)

    tmp = aligned_dataset.train_test_split(
        train_size=train_size, test_size=test_size, shuffle=shuffle,
        seed=seed)
    new_aligned = DatasetDict({"train": tmp["train"], "test": tmp["test"]})

    times_test = tmp["test"]["time"]
    train_idxs, test_idxs = [], []
    for i, data_ual in enumerate(unaligned_dataset):
        time_ual = data_ual["time"]
        if any(abs(time_ual - t) <= 2 for t in times_test):
            test_idxs.append(i)
        else:
            train_idxs.append(i)
    new_unaligned = DatasetDict({
        "train": unaligned_dataset.select(train_idxs),
        "test": unaligned_dataset.select(test_idxs),
    })
    return new_aligned, new_unaligned
