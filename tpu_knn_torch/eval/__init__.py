"""Evaluation helpers: synthetic datasets."""
