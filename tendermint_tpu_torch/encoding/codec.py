"""Transport codec: registered-type msgpack serialization (the port's copy
of tendermint_tpu/encoding/codec.py, on its own msgpack subset).

Replaces amino's registered-concrete-type mechanism (reference: per-package
`codec.go` RegisterConcrete calls) for storage messages: each serializable
class registers a short type tag; values round-trip as
``{"@t": tag, ...fields}``.  Classes implement ``to_dict()`` /
``from_dict(cls, d)``.  The bytes equal the JAX package's codec's, tag for
tag, so either package reads the other's stores.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Type

from . import msgpack

_REGISTRY: Dict[str, Type] = {}
_TAGS: Dict[Type, str] = {}


class Codec:  # namespace for introspection/tests
    registry = _REGISTRY


def register(tag: str) -> Callable[[Type], Type]:
    """Class decorator: register a concrete type under a wire tag."""

    def deco(cls: Type) -> Type:
        if tag in _REGISTRY and _REGISTRY[tag] is not cls:
            raise ValueError(f"duplicate codec tag {tag!r}")
        _REGISTRY[tag] = cls
        _TAGS[cls] = tag
        return cls

    return deco


def tag_for(cls: Type) -> str | None:
    """The wire tag a class registered under, or None."""
    return _TAGS.get(cls)


def class_for(tag: str) -> Type | None:
    """The class registered under a wire tag, or None."""
    return _REGISTRY.get(tag)


def _default(obj: Any) -> Any:
    tag = _TAGS.get(type(obj))
    if tag is not None:
        d = obj.to_dict()
        d["@t"] = tag
        return d
    raise TypeError(f"unserializable type {type(obj)!r}")


def _object_hook(d: Dict) -> Any:
    tag = d.pop("@t", None)
    if tag is None:
        return d
    cls = _REGISTRY.get(tag)
    if cls is None:
        raise ValueError(f"unknown codec tag {tag!r}")
    return cls.from_dict(d)


def dumps(obj: Any) -> bytes:
    return msgpack.packb(obj, default=_default)


def loads(data: bytes) -> Any:
    return msgpack.unpackb(data, object_hook=_object_hook)
