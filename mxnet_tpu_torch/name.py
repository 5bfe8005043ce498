"""Automatic symbol naming (reference: ``python/mxnet/name.py``).

Symbols created without an explicit ``name=`` get ``<op>N`` style names from
a thread-local NameManager so argument names (``convolution0_weight``...) are
deterministic across runs — required for checkpoint compatibility.
"""
from __future__ import annotations

import threading


class NameManager:
    _current = threading.local()

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        if name:
            return name
        if hint not in self._counter:
            self._counter[hint] = 0
        name = "%s%d" % (hint, self._counter[hint])
        self._counter[hint] += 1
        return name

    def __enter__(self):
        self._old_manager = getattr(NameManager._current, "value", None)
        NameManager._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        NameManager._current.value = self._old_manager


def current() -> NameManager:
    mgr = getattr(NameManager._current, "value", None)
    if mgr is None:
        mgr = NameManager()
        NameManager._current.value = mgr
    return mgr
