"""Scan convenience views: map/reduce/foldl/foldr (the counterpart of
``aesara_tpu/scan/views.py``)."""

from __future__ import annotations

from aesara_tpu_torch.scan.basic import scan


def map(fn, sequences, non_sequences=None, go_backwards=False, mode=None, name=None):
    """Apply fn independently to each step (no recurrence)."""
    return scan(
        fn, sequences=sequences, outputs_info=None,
        non_sequences=non_sequences, go_backwards=go_backwards,
        mode=mode, name=name or "map",
    )


def reduce(fn, sequences, outputs_info, non_sequences=None, go_backwards=False,
           mode=None, name=None):
    """Like scan but only the final state is returned."""
    outs, updates = scan(
        fn, sequences=sequences, outputs_info=outputs_info,
        non_sequences=non_sequences, go_backwards=go_backwards,
        mode=mode, name=name or "reduce",
    )
    if isinstance(outs, list):
        return [o[-1] for o in outs], updates
    return outs[-1], updates


def foldl(fn, sequences, outputs_info, non_sequences=None, mode=None, name=None):
    return reduce(fn, sequences, outputs_info, non_sequences,
                  go_backwards=False, mode=mode, name=name or "foldl")


def foldr(fn, sequences, outputs_info, non_sequences=None, mode=None, name=None):
    return reduce(fn, sequences, outputs_info, non_sequences,
                  go_backwards=True, mode=mode, name=name or "foldr")
