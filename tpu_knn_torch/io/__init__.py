"""IO: index persistence (persist.py), tpu_knn's format v3."""
