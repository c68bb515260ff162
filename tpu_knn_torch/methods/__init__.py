"""Method registration: only the exact scan (seq_search, brute_force) is ported so far."""

from . import seq_search  # noqa: F401

from .base import Method  # noqa: F401
