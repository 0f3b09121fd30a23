from .loader import (DataLoader, attention_mask, get_length_grouped_indices,
                     get_length_grouped_indices_stitched, make_loader,
                     prepare_split)
from .session import (DEFAULT_TARGETS, SessionData, SessionSplits,
                      synthetic_session, synthetic_splits)

__all__ = [
    "DataLoader", "attention_mask", "get_length_grouped_indices",
    "get_length_grouped_indices_stitched", "make_loader", "prepare_split",
    "DEFAULT_TARGETS", "SessionData", "SessionSplits", "synthetic_session",
    "synthetic_splits",
]
