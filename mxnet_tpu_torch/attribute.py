"""Attribute scopes (reference: ``python/mxnet/attribute.py``).

``with mx.AttrScope(ctx_group='dev1'):`` attaches attributes to every symbol
created inside the scope — the mechanism behind model parallelism's
``group2ctx`` placement (reference ``src/executor/graph_executor.cc:241-318``).
"""
from __future__ import annotations

import threading


class AttrScope:
    _current = threading.local()

    def __init__(self, **kwargs):
        for value in kwargs.values():
            if not isinstance(value, str):
                raise ValueError("attributes must be strings")
        self._attr = kwargs
        self._old_scope = None

    def get(self, attr):
        """Merge user-supplied attrs over the scope attrs."""
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return attr if attr else {}

    def __enter__(self):
        self._old_scope = current()
        attr = self._old_scope._attr.copy()
        attr.update(self._attr)
        self._attr = attr
        AttrScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        AttrScope._current.value = self._old_scope


def current() -> AttrScope:
    scope = getattr(AttrScope._current, "value", None)
    if scope is None:
        scope = AttrScope()
        AttrScope._current.value = scope
    return scope
