"""tpu_knn_torch — the PyTorch/CUDA port of tpu_knn for one NVIDIA H100.

The same public surface as tpu_knn (``Index``, ``Params``, the data and
distance kinds, the 15-code error set and the registries), with tensors
on an explicit ``device``. Every space and method of tpu_knn's registry
is ported: the dense, sparse, bit, string (``leven``, ``normleven``),
SQFD and sparse-dense fusion spaces and ``word_embed``; the exact scan
(``method="seq_search"``), ``dummy``, HNSW (the default method),
``sw-graph`` with incremental add and delete, ``vptree``, NAPP
(``napp``/``pivot_neighb_invindx``) and the inverted index
(``simple_invindx``); the experiment CLI (``python -m tpu_knn_torch``)
and its harness (``eval``); ``Index(..., mesh=)`` over logical shards
(``parallel``). The scan's
pass 1 over a space with an affine factored form is a CUDA kernel written
for sm_90a at each of tpu_knn's precision tiers
(ops/groupmin.py; csrc/groupmin.cu for f32, csrc/groupmin_wgmma_i8.cu for
int8 and csrc/groupmin_wgmma.cu for bf16x3 and bf16, both on the warpgroup
tensor cores).
Importing the package imports neither jax nor tpu_knn, initializes no
CUDA context and builds nothing.
"""

from .core.dataset import DataKind, DistKind, SparsePoint
from .core.errors import *  # noqa: F401,F403 — the 15-code taxonomy
from .core.params import Params
from .core.registry import (
    is_valid_space_type,
    known_methods,
    known_spaces,
)
from .utils.rng import set_default_seed

# Importing the subpackages runs the @register_space/@register_method
# decorators (reference: src/init.cc:37-44).
from . import spaces  # noqa: F401
from . import methods  # noqa: F401

from .api import Index, QueryResult
from .spaces.dense import clear_upload_cache

__all__ = [
    "Index",
    "QueryResult",
    "clear_upload_cache",
    "Params",
    "DataKind",
    "DistKind",
    "SparsePoint",
    "known_spaces",
    "known_methods",
    "is_valid_space_type",
    "set_default_seed",
]

__version__ = "0.1.0"
