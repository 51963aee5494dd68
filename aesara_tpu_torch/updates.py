"""``OrderedUpdates``: a dict of shared-variable updates that refuses a
target that is not shared and a second, different update of one target
(reference ``aesara_tpu/updates.py``); ``scan`` returns one."""

from __future__ import annotations

from collections import OrderedDict

from aesara_tpu_torch.compile.sharedvalue import SharedVariable


__all__ = ["OrderedUpdates"]


class OrderedUpdates(OrderedDict):
    def __setitem__(self, key, value):
        if not isinstance(key, SharedVariable):
            raise TypeError(f"update target must be a SharedVariable, got {key}")
        super().__setitem__(key, value)

    def update(self, other=None, **kwargs):
        if other is not None:
            items = other.items() if hasattr(other, "items") else other
            for k, v in items:
                if k in self and self[k] is not v:
                    raise KeyError(f"duplicate update for {k}")
                self[k] = v
        for k, v in kwargs.items():
            self[k] = v
        return self

    def __add__(self, other):
        res = OrderedUpdates()
        res.update(self)
        res.update(other)
        return res
