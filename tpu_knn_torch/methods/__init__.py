"""Method registration: the exact scan (seq_search, brute_force), hnsw,
napp (pivot_neighb_invindx) and simple_invindx."""

from . import hnsw  # noqa: F401
from . import inv_index  # noqa: F401
from . import napp  # noqa: F401
from . import seq_search  # noqa: F401

from .base import Method  # noqa: F401
