"""Space registration: every dense, sparse and bit space of tpu_knn and
word_embed."""

from . import bits  # noqa: F401
from . import dense  # noqa: F401
from . import embed  # noqa: F401
from . import sparse  # noqa: F401

from .base import Space  # noqa: F401
