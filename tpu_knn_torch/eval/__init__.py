"""Evaluation helpers: synthetic datasets, the gold standard and the
quality metrics."""

from .gold_standard import GoldStandard
from .metrics import class_accuracy, per_query_metrics, summarize

__all__ = ["GoldStandard", "per_query_metrics", "summarize", "class_accuracy"]
