"""Small helpers shared by the graph layer (reference ``graph/utils.py``)."""

from __future__ import annotations

import sys
from typing import Any


class MethodNotDefined(Exception):
    """An optional Op method (``perform``, ``impl``) is not implemented."""


class Scratchpad:
    """Free-form attribute bag attached to every node as ``.tag``."""

    def __init__(self, **kwargs: Any):
        self.__dict__.update(kwargs)

    def __update__(self, other: "Scratchpad") -> "Scratchpad":
        self.__dict__.update(other.__dict__)
        return self

    def __contains__(self, name: str) -> bool:
        return name in self.__dict__

    def __repr__(self) -> str:
        return f"Scratchpad({self.__dict__!r})"


def add_tag_trace(thing: Any, user_line: int = 1) -> Any:
    """Record the user frames that created ``thing`` in ``thing.tag.trace``:
    the innermost ``user_line`` frames outside the package, outermost
    first, as (file, line, function).  The stack is walked from the
    innermost frame and no further than needed, and no source line is
    read: a graph build makes one of these per variable."""
    frames = []
    frame = sys._getframe(1)
    while frame is not None and len(frames) < user_line:
        if "aesara_tpu_torch" not in frame.f_code.co_filename:
            frames.append((frame.f_code.co_filename, frame.f_lineno, frame.f_code.co_name))
        frame = frame.f_back
    thing.tag.trace = [frames[::-1]] if frames else []
    return thing
