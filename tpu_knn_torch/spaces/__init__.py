"""Space registration: only the l2 space is ported so far."""

from . import dense  # noqa: F401

from .base import Space  # noqa: F401
