"""Minimal name → factory registry (the model configs' ``CONFIGS``).

The port's own copy of ``repro/util/registry.py``: the same class, the
same error texts."""

from __future__ import annotations

from typing import Callable, Dict, Generic, Iterator, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    """A string-keyed registry with decorator-style registration.

    >>> configs = Registry("configs")
    >>> @configs.register("tiny")
    ... def tiny():
    ...     return {"d_model": 8}
    >>> configs.get("tiny")()["d_model"]
    8
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, T] = {}

    def register(self, name: str) -> Callable[[T], T]:
        def deco(obj: T) -> T:
            if name in self._entries:
                raise KeyError(f"{self.kind}: duplicate registration {name!r}")
            self._entries[name] = obj
            return obj

        return deco

    def get(self, name: str) -> T:
        try:
            return self._entries[name]
        except KeyError:
            known = ", ".join(sorted(self._entries))
            raise KeyError(f"{self.kind}: unknown entry {name!r} (known: {known})") from None

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._entries))

    def names(self):
        return sorted(self._entries)
