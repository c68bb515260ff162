"""Evaluation harness (counterpart of tpu_knn/eval; reference LX layer:
experiments.h, gold_standard.h, eval_metrics.h, meta_analysis.h, tune.h,
report.h), plus the synthetic datasets of eval/datasets.py."""

from .gold_standard import GoldStandard
from .metrics import class_accuracy, per_query_metrics, summarize
from .experiments import ExperimentConfig, Experiments, MetaAnalysis, run_full_experiment
from .tune import tune_hnsw_ef, tune_vptree_alphas
from .report import compute_intrinsic_dimensionality, format_table, report_intrinsic_dimensionality

__all__ = [
    "GoldStandard",
    "per_query_metrics",
    "summarize",
    "class_accuracy",
    "ExperimentConfig",
    "Experiments",
    "MetaAnalysis",
    "run_full_experiment",
    "tune_hnsw_ef",
    "tune_vptree_alphas",
    "compute_intrinsic_dimensionality",
    "report_intrinsic_dimensionality",
    "format_table",
]
