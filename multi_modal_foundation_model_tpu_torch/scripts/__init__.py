"""Entry scripts of the port, each run as
``python -m multi_modal_foundation_model_tpu_torch.scripts.<name>``:
``train_baseline``, ``eval_baseline``, ``train_multi_modal``,
``eval_multi_modal`` and ``train_multi_session``. Each has
``main(argv=None)``."""
