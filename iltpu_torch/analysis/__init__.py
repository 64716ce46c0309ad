from iltpu_torch.analysis.aggregate import (
    collect_seed_sweep,
    iqm,
    load_metrics,
    stratified_bootstrap_ci,
)

__all__ = [
    "iqm",
    "stratified_bootstrap_ci",
    "load_metrics",
    "collect_seed_sweep",
]
