"""Space registration: every space of tpu_knn (dense, sparse, bit, string,
SQFD, sparse-dense fusion and word_embed)."""

from . import bits  # noqa: F401
from . import dense  # noqa: F401
from . import embed  # noqa: F401
from . import fusion  # noqa: F401
from . import sparse  # noqa: F401
from . import sqfd  # noqa: F401
from . import string  # noqa: F401

from .base import Space  # noqa: F401
