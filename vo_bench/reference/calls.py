"""A record of the reference's calls of the ops that stand for the program's hand-written
kernels, in call order. While ``RECORD`` is a dict, each call of a function wrapped by
:func:`recorded` appends its ``(args, kwargs)`` under the op's name. The harness replays
the profiled sub-window through the reference with a record open, and a per-layer metric
reads it (``ctx.calls``) to count what each of the program's launches had to move or
compute there."""

from __future__ import annotations

import functools

RECORD: dict | None = None


def recorded(name: str):
    """Record the wrapped function's arguments under ``name`` while ``RECORD`` is set."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if RECORD is not None:
                RECORD.setdefault(name, []).append((args, kwargs))
            return fn(*args, **kwargs)

        return call

    return wrap
