"""Brain-region acronym <-> index lookup (host-side preprocessing).

The port's copy of ``multi_modal_foundation_model_tpu/models/
region_lookup.py``: it turns region-acronym strings into the int32
``region_ids`` the region masking modes read (``ops/masking.py``
``RegionSets`` / ``RegionTable``). With ``iblatlas`` installed the
vocabulary is the IBL atlas's acronyms; without it, a vocabulary of the
observed acronyms (stable sorted order), consistent across sessions as long
as one lookup maps them all.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import numpy as np


class RegionLookup:
    def __init__(self, acronyms: Optional[Sequence[str]] = None):
        if acronyms is None:
            try:  # the full IBL atlas, where it is installed
                from iblatlas.regions import BrainRegions
                acronyms = list(BrainRegions().acronym)
            except Exception:
                acronyms = []
        self.region_to_indx: Dict[str, int] = {
            r: i for i, r in enumerate(acronyms)}
        self.indx_to_region: Dict[int, str] = {
            v: k for k, v in self.region_to_indx.items()}

    @property
    def max_region_indx(self) -> int:
        return len(self.region_to_indx)

    def extend(self, acronyms: Iterable[str]) -> None:
        """Add unseen acronyms (in sorted order)."""
        for r in sorted(set(acronyms) - set(self.region_to_indx)):
            idx = len(self.region_to_indx)
            self.region_to_indx[r] = idx
            self.indx_to_region[idx] = r

    def __call__(self, neuron_regions: np.ndarray) -> np.ndarray:
        """(Rows of) acronym strings -> int32 ids; 'nan' -> -1."""
        arr = np.asarray(neuron_regions, dtype=str)
        flat = arr.reshape(-1)
        self.extend(r for r in flat if r != "nan")
        ids = np.array([self.region_to_indx.get(r, -1) if r != "nan" else -1
                        for r in flat], dtype=np.int32)
        return ids.reshape(arr.shape)

    def lookup_regions(self, region_indx: np.ndarray) -> np.ndarray:
        """Inverse map: int ids back to acronym strings ('' for -1)."""
        arr = np.asarray(region_indx)
        flat = [self.indx_to_region.get(int(i), "") for i in arr.reshape(-1)]
        return np.array(flat, dtype=str).reshape(arr.shape)
