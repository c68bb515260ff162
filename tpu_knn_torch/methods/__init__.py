"""Method registration: every method of tpu_knn: the exact scan
(seq_search, brute_force), dummy, hnsw, sw-graph (small_world_rand),
vptree, napp (pivot_neighb_invindx) and simple_invindx."""

from . import dummy  # noqa: F401
from . import hnsw  # noqa: F401
from . import inv_index  # noqa: F401
from . import napp  # noqa: F401
from . import seq_search  # noqa: F401
from . import sw_graph  # noqa: F401
from . import vptree  # noqa: F401

from .base import Method  # noqa: F401
