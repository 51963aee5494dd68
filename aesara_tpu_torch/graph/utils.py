"""Small helpers shared by the graph layer (reference ``graph/utils.py``)."""

from __future__ import annotations

import traceback
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
    """Record the user frame that created ``thing`` in ``thing.tag.trace``."""
    frames = [
        (f.filename, f.lineno, f.name)
        for f in traceback.extract_stack()
        if "aesara_tpu_torch" not in (f.filename or "")
    ]
    thing.tag.trace = [frames[-user_line:]] if frames else []
    return thing
