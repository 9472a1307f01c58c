"""Unique name generator (counterpart of paddle_tpu/framework/unique_name.py):
per-prefix monotone counters with a `guard` to scope name spaces. Layers
and optimizers name parameters and temporaries through it, so a program
built here carries the same names as the reference's (`fc_tmp_0`, ...)."""
from __future__ import annotations

import contextlib
from collections import defaultdict


class NameGenerator:
    def __init__(self, prefix: str = ""):
        self._prefix = prefix
        self._ids = defaultdict(int)

    def __call__(self, key: str) -> str:
        tmp = self._ids[key]
        self._ids[key] += 1
        return f"{self._prefix}{key}_{tmp}"


_generator_stack = [NameGenerator()]


def generate(key: str) -> str:
    return _generator_stack[-1](key)


@contextlib.contextmanager
def guard(prefix: str = ""):
    _generator_stack.append(NameGenerator(prefix))
    try:
        yield
    finally:
        _generator_stack.pop()


def switch():
    """Reset the current generator (used between tests/programs)."""
    _generator_stack[-1] = NameGenerator(_generator_stack[-1]._prefix)
