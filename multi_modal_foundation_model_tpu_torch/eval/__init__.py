from .baseline_harness import co_smoothing_eval_baseline
from .harness import EvalForward, co_smoothing_eval
from .heldout import heldout_mask
from .loading import (load_model_config, load_model_data_local,
                      load_multisession_model_data_local,
                      load_reference_checkpoint, save_model_config)
from .metrics import (
    bits_per_spike,
    compute_PSTH,
    compute_R2_main,
    compute_R2_psth,
    compute_all_psth,
    create_behavior_conditions,
    metrics_list,
    neg_log_likelihood,
    psth_and_trial_r2,
    r2_score_nanable,
)

__all__ = [
    "EvalForward",
    "co_smoothing_eval",
    "co_smoothing_eval_baseline",
    "heldout_mask",
    "load_model_config",
    "load_model_data_local",
    "load_multisession_model_data_local",
    "load_reference_checkpoint",
    "save_model_config",
    "bits_per_spike",
    "compute_PSTH",
    "compute_R2_main",
    "compute_R2_psth",
    "compute_all_psth",
    "create_behavior_conditions",
    "metrics_list",
    "neg_log_likelihood",
    "psth_and_trial_r2",
    "r2_score_nanable",
]
