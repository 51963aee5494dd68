"""Configuration flags of the PyTorch port.

The counterpart of ``aesara_tpu/config.py``, cut down to the flags the
port reads.  ``floatX`` takes float32 (the default), float64, float16 or
bfloat16, as in the JAX package.  ``device`` is new: it names the ``torch.device`` that
``shared()`` places values on and that ``TorchLinker`` runs on when it is
not given one.  It defaults to ``"cuda"``: entry points run on the card
unless the caller asks for the CPU (``change_flags(device="cpu")`` or
``device="cpu"``), and on a machine without a card they raise.
``on_unused_input`` is what ``function()`` does with an input that
nothing reads: "raise" (the default, as in the JAX package), "warn" or
"ignore".  ``allow_gc`` (the JAX package's flag, default True) lets the
linker drop each intermediate after its last reader.  ``cuda_graph`` (the
counterpart of ``jax_jit``, default True) makes ``TorchLinker`` capture
each compiled step into a CUDA graph on the card; it has no effect on
the CPU.  ``shape_buckets`` ("off", "pow2" or a comma list of sizes) and
``shape_buckets_check`` ("raise", "warn" or "off") are the JAX package's
bucketing flags (``compile/bucketing.py``), read at each call.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Callable, Dict


def _enum(*allowed):
    def check(v):
        if v not in allowed:
            raise ValueError(f"invalid value {v!r}; allowed: {allowed}")
        return v

    return check


def _buckets(v):
    from aesara_tpu_torch.compile.bucketing import parse_buckets

    parse_buckets(v)    # raises on a malformed ladder
    return v


def _device(v):
    import torch

    return str(torch.device(v))


class _Config:
    """Attribute access to typed flags; assignment validates."""

    def __init__(self):
        object.__setattr__(self, "_checks", {})
        object.__setattr__(self, "_values", {})

    def add(self, name: str, default: Any, check: Callable[[Any], Any]):
        self._checks[name] = check
        self._values[name] = check(default)

    def __getattr__(self, name):
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(f"no config flag {name!r}") from None

    def __setattr__(self, name, value):
        if name not in self._checks:
            raise AttributeError(f"no config flag {name!r}")
        self._values[name] = self._checks[name](value)

    @contextmanager
    def change_flags(self, **kwargs):
        """Temporarily set flags (reference ``configparser.py:33``)."""
        old: Dict[str, Any] = {k: getattr(self, k) for k in kwargs}
        try:
            for k, v in kwargs.items():
                setattr(self, k, v)
            yield self
        finally:
            for k, v in old.items():
                self._values[k] = v


config = _Config()
config.add("floatX", "float32", _enum("float32", "float64", "float16", "bfloat16"))
config.add("device", "cuda", _device)
config.add("on_unused_input", "raise", _enum("raise", "warn", "ignore"))
config.add("allow_gc", True, _enum(True, False))
config.add("cuda_graph", True, _enum(True, False))
# the node that computes a shared variable's update writes it into the
# variable's storage where the destroy handler allows it (the counterpart
# of jax_donate_shared); False copies every update in after the graph ran
config.add("donate_shared", True, _enum(True, False))
config.add("shape_buckets", "off", _buckets)
config.add("shape_buckets_check", "raise", _enum("raise", "warn", "off"))
config.add("seed", 0, int)    # the default RandomStream seed (reference aesara_tpu/config.py:187)

change_flags = config.change_flags
