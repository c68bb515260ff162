"""Error taxonomy for tpu_knn_torch (the same classes and codes as tpu_knn).

Mirrors the 15-code error surface of the reference C ABI
(reference: nmslib_c.h:23-39) as a Python exception hierarchy. Each
exception carries the numeric ``code`` so API-level consumers can map
errors exactly the way the Zig layer mapped ``nmslib_error_t``
(reference: lib.zig:11-27).
"""

from __future__ import annotations


class NmsError(Exception):
    """Base class for every tpu_knn_torch error. ``code`` matches nmslib_error_t."""

    code: int = 13  # NMSLIB_ERROR_RUNTIME default

    def __init__(self, message: str = ""):
        super().__init__(message or self.__class__.__name__)
        self.message = message


class NullPointerError(NmsError):
    code = 1


class InvalidArgumentError(NmsError):
    code = 2


class OutOfMemoryError(NmsError):
    code = 3


class BufferTooSmallError(NmsError):
    code = 4


class SpaceIncompatibleError(NmsError):
    """Space/method combination unsupported (e.g. range query on HNSW;
    reference: hnsw.cc:710-715 mapped at nmslib_c.cpp:1126-1141)."""

    code = 5


class QueryTooLargeError(NmsError):
    code = 6


class InvalidSparseElementError(NmsError):
    """Sparse element ids must be >= 1 and strictly increasing
    (reference: lib.zig:728-738)."""

    code = 7


class IndexBuildError(NmsError):
    code = 8


class QueryExecutionError(NmsError):
    code = 9


class DataIOError(NmsError):
    code = 10


class PluginRegistrationError(NmsError):
    code = 11


class InternalError(NmsError):
    code = 12


class RuntimeNmsError(NmsError):
    code = 13


class IndexNotBuiltError(NmsError):
    code = 14


#: code -> exception class, for ABI-style round-tripping.
ERROR_BY_CODE = {
    cls.code: cls
    for cls in [
        NullPointerError,
        InvalidArgumentError,
        OutOfMemoryError,
        BufferTooSmallError,
        SpaceIncompatibleError,
        QueryTooLargeError,
        InvalidSparseElementError,
        IndexBuildError,
        QueryExecutionError,
        DataIOError,
        PluginRegistrationError,
        InternalError,
        RuntimeNmsError,
        IndexNotBuiltError,
    ]
}
