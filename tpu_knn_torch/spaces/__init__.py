"""Space registration: every dense and sparse space of tpu_knn."""

from . import dense  # noqa: F401
from . import sparse  # noqa: F401

from .base import Space  # noqa: F401
