"""Name -> constructor registries for spaces and index methods.

Counterpart of tpu_knn/core/registry.py. Mirrors SpaceFactoryRegistry /
MethodFactoryRegistry and the initLibrary registration pass (reference: include/spacefactory.h:31-58,
include/methodfactory.h:33-68, src/init.cc:37-44). Unlike the reference,
registries are not templated on dist type: each Space declares its own
dist kind and the registry validates compatibility at creation time.
"""

from __future__ import annotations

from typing import Callable

from .errors import InvalidArgumentError, PluginRegistrationError
from .params import Params

_SPACES: dict[str, Callable] = {}
_METHODS: dict[str, Callable] = {}

#: Space-name aliases, e.g. "cosine" -> "cosinesimil" (reference: lib.zig:530-533).
SPACE_ALIASES = {"cosine": "cosinesimil"}

#: The reference's 55-entry space-type whitelist, verbatim
#: (lib.zig:428-492). NB it is intentionally quirky: it contains entries
#: that are source-file names rather than registered spaces
#: (sparse_vector, sparse_scalar*, sparse_l1/l2/linf) and the sqfd_*
#: spaces its own build excludes (build.zig:16) — isValidSpaceType
#: accepts them while creation fails. We mirror that: the names below
#: validate; only registered names construct.
SPACE_TYPES_WHITELIST = frozenset(
    {
        "abdiv_fast", "abdiv_slow", "angulardist", "angulardist_sparse",
        "angulardist_sparse_fast", "bit_hamming", "bit_jaccard", "cosine",
        "cosinesimil", "cosinesimil_sparse", "cosinesimil_sparse_bin_fast",
        "cosinesimil_sparse_fast", "dummy", "itakurasaitofast",
        "itakurasaitofastrq", "itakurasaitoslow", "js_div_fast",
        "js_div_fast_approx", "js_div_slow", "kldivfast", "kldivfastrq",
        "kldivgenfast", "kldivgenfastrq", "kldivgenslow", "l1", "l2",
        "l2sqr_sift", "l1_sparse", "l2_sparse", "linf", "lp", "normleven",
        "negdotprod", "negdotprod_sparse", "negdotprod_sparse_fast",
        "negdotprod_sparse_bin_fast", "querynorm_negdotprod_sparse",
        "querynorm_negdotprod_sparse_fast", "renyidiv_fast", "renyidiv_slow",
        "sparse_dense_fusion", "sparse_vector", "sparse_vector_inter",
        "sparse_scalar", "sparse_scalar_fast", "sparse_scalar_bin_fast",
        "sparse_jaccard", "sparse_l1", "sparse_l2", "sparse_linf",
        "sqfd_gaussian_func", "sqfd_heuristic_func", "sqfd_minus_func",
        "word_embed", "word_embed_dist_cosine", "word_embed_dist_l2",
    }
)


def register_space(name: str):
    def deco(ctor: Callable):
        if name in _SPACES:
            raise PluginRegistrationError(f"space {name!r} already registered")
        _SPACES[name] = ctor
        return ctor

    return deco


def register_method(name: str):
    def deco(ctor: Callable):
        if name in _METHODS:
            raise PluginRegistrationError(f"method {name!r} already registered")
        _METHODS[name] = ctor
        return ctor

    return deco


def canonical_space_name(name: str) -> str:
    return SPACE_ALIASES.get(name, name)


def create_space(name: str, params: Params | dict | None = None, device="cpu"):
    """Construct a registered space whose tensors live on ``device``."""
    key = canonical_space_name(name)
    if key not in _SPACES:
        raise InvalidArgumentError(f"unknown space {name!r}; known: {sorted(_SPACES)}")
    return _SPACES[key](Params.of(params), device=device)


def create_method(name: str, space, params: Params | dict | None = None):
    if name not in _METHODS:
        raise InvalidArgumentError(f"unknown method {name!r}; known: {sorted(_METHODS)}")
    return _METHODS[name](space, Params.of(params))


def known_spaces() -> list[str]:
    return sorted(_SPACES)


def known_methods() -> list[str]:
    return sorted(_METHODS)


def is_valid_space_type(name: str) -> bool:
    """Reference analog: lib.zig isValidSpaceType (lib.zig:487-492):
    membership in the verbatim whitelist, extended by anything actually
    registered (we register spaces the whitelist omits, e.g. leven)."""
    return name in SPACE_TYPES_WHITELIST or canonical_space_name(name) in _SPACES
