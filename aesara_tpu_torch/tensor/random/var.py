"""Shared variables of PRNG state (the counterpart of
``aesara_tpu/tensor/random/var.py``).

The state is a threefry key, ``uint32[2]``, held on the variable's device.
``shared(np.random.default_rng(123))`` keeps the reference's idiom: it
seeds a key from the generator (a copy of it, so the caller's generator
does not move).
"""

from __future__ import annotations

import copy

import numpy as np

from aesara_tpu_torch.compile.sharedvalue import SharedVariable
from aesara_tpu_torch.tensor.random.op import default_rng, random_generator_type

__all__ = ["RandomTypeSharedVariable", "RandomGeneratorSharedVariable", "RandomStateSharedVariable",
           "key_shared"]


class RandomTypeSharedVariable(SharedVariable):
    """Shared PRNG state (a threefry key)."""

    def __str__(self):
        return self.name or f"RNG({self.get_value()!r})"


class RandomGeneratorSharedVariable(RandomTypeSharedVariable):
    pass


#: the reference's RandomState flavour: the same key representation
RandomStateSharedVariable = RandomGeneratorSharedVariable


def key_shared(key, name=None, device=None) -> RandomGeneratorSharedVariable:
    return RandomGeneratorSharedVariable(random_generator_type, np.asarray(key, dtype=np.uint32), name=name,
                                         device=device)


def generator_shared(value, name=None, device=None) -> RandomGeneratorSharedVariable:
    """A key shared variable seeded from a NumPy ``Generator`` or
    ``RandomState`` (a copy, so the caller's does not move)."""
    value = copy.deepcopy(value)
    if isinstance(value, np.random.Generator):
        seed = int(value.integers(0, 2**63 - 1))
    else:
        seed = int(value.randint(0, 2**31 - 1))
    return key_shared(default_rng(seed), name=name, device=device)
