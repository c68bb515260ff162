"""Parameter handling: the AnyParams / AnyParamManager equivalent.

The reference parses "k=v" string lists into typed values with
required/optional getters and a strict ``CheckUnused`` pass that rejects
unknown keys (reference: include/params.h:44-305). We keep the same
contract on top of a plain dict, including synonym support (e.g.
``ef``/``efSearch``, reference: hnsw.cc:478-484) and conflict detection
when two synonyms are both supplied.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping, Sequence

from .errors import InvalidArgumentError


def _convert(value: Any, ty: type) -> Any:
    """Convert a raw param value (possibly a string) to the requested type,
    mirroring AnyParamManager's string->typed conversion (params.h:173-260)."""
    if ty is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, (int, float)):
            return bool(value)
        s = str(value).strip().lower()
        if s in ("1", "true", "yes", "on"):
            return True
        if s in ("0", "false", "no", "off"):
            return False
        raise InvalidArgumentError(f"cannot convert {value!r} to bool")
    try:
        return ty(value)
    except (TypeError, ValueError) as e:
        raise InvalidArgumentError(f"cannot convert {value!r} to {ty.__name__}: {e}")


class Params:
    """An immutable-ish bag of parameters.

    Accepts a mapping, an iterable of "key=value" strings (the reference's
    native format, params.h:44-80), or keyword arguments.
    """

    def __init__(self, source: Mapping[str, Any] | Iterable[str] | None = None, **kw: Any):
        self._d: dict[str, Any] = {}
        if source is not None:
            if isinstance(source, Mapping):
                self._d.update(source)
            else:
                for item in source:
                    if not isinstance(item, str) or "=" not in item:
                        raise InvalidArgumentError(
                            f"param entries must be 'key=value' strings, got {item!r}"
                        )
                    k, v = item.split("=", 1)
                    self._d[k.strip()] = v.strip()
        self._d.update(kw)

    @classmethod
    def of(cls, source: "Params | Mapping[str, Any] | Iterable[str] | None", **kw: Any) -> "Params":
        if isinstance(source, Params):
            if kw:
                merged = dict(source._d)
                merged.update(kw)
                return cls(merged)
            return source
        return cls(source, **kw)

    def has(self, key: str) -> bool:
        return key in self._d

    def get(self, key: str, default: Any = None) -> Any:
        return self._d.get(key, default)

    def keys(self):
        return self._d.keys()

    def as_dict(self) -> dict[str, Any]:
        return dict(self._d)

    def __repr__(self) -> str:
        return f"Params({self._d!r})"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Params) and self._d == other._d


class ParamManager:
    """Typed getters + strict unused-key checking over a :class:`Params`.

    Mirrors AnyParamManager (params.h:120-305): every key must be consumed
    by a getter before :meth:`check_unused` or it is an error — this is the
    reference's defence against misspelled parameter names.
    """

    def __init__(self, params: Params | Mapping[str, Any] | Iterable[str] | None):
        self._params = Params.of(params)
        self._seen: set[str] = set()

    def get(self, key: str, default: Any, ty: type | None = None) -> Any:
        self._seen.add(key)
        if not self._params.has(key):
            return default
        v = self._params.get(key)
        if ty is None and default is not None:
            ty = type(default)
        return _convert(v, ty) if ty is not None else v

    def require(self, key: str, ty: type) -> Any:
        self._seen.add(key)
        if not self._params.has(key):
            raise InvalidArgumentError(f"required parameter {key!r} missing")
        return _convert(self._params.get(key), ty)

    def get_synonym(self, keys: Sequence[str], default: Any, ty: type | None = None) -> Any:
        """Fetch one of several synonymous keys; both present is an error
        (reference: hnsw.cc:478-484 ef/efSearch conflict detection)."""
        present = [k for k in keys if self._params.has(k)]
        for k in keys:
            self._seen.add(k)
        if len(present) > 1:
            raise InvalidArgumentError(
                f"conflicting synonymous parameters given: {present}"
            )
        if not present:
            return default
        v = self._params.get(present[0])
        if ty is None and default is not None:
            ty = type(default)
        return _convert(v, ty) if ty is not None else v

    def has(self, key: str) -> bool:
        return self._params.has(key)

    def mark_seen(self, *keys: str) -> None:
        self._seen.update(keys)

    def check_unused(self) -> None:
        unused = set(self._params.keys()) - self._seen
        if unused:
            raise InvalidArgumentError(
                f"unknown parameters: {sorted(unused)} (strict check, "
                "mirroring AnyParamManager::CheckUnused)"
            )
