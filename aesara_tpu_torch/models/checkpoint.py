"""Training checkpoints: the parameters and the optimizer state as one
``.npz`` (reference ``aesara_tpu/models/checkpoint.py``).

The state is ``params`` plus every shared target of an ``updates`` list
(Adam moments, step counters, loss scales), in that order; each array is
keyed ``<index>:<name>``, as the JAX package keys it, so a checkpoint
either package writes loads into the same model built by the other.
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.compile.sharedvalue import SharedVariable


__all__ = ["state_shareds", "save_checkpoint", "load_checkpoint"]


def state_shareds(params, updates=None):
    """``params`` and every shared update target of ``updates``, each
    once, in order."""
    seen = []
    for p in params:
        if p not in seen:
            seen.append(p)
    for pair in updates or ():
        var = pair[0] if isinstance(pair, (tuple, list)) else pair
        if isinstance(var, SharedVariable) and var not in seen:
            seen.append(var)
    return seen


def _keys(shareds):
    return [f"{i}:{sv.name or 'shared'}" for i, sv in enumerate(shareds)]


def _npz_path(path):
    """np.savez adds '.npz' on write and np.load does not on read."""
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path, params, updates=None, extra=None):
    """Write every state variable's value, and the arrays of ``extra``
    (a dict, e.g. the data loader's position), to an ``.npz``."""
    shareds = state_shareds(params, updates)
    arrays = {k: sv.get_value() for k, sv in zip(_keys(shareds), shareds)}
    for k, v in (extra or {}).items():
        arrays[f"extra:{k}"] = np.asarray(v)
    np.savez(_npz_path(path), **arrays)


def load_checkpoint(path, params, updates=None, strict=True):
    """Restore what ``save_checkpoint`` wrote into a model and optimizer
    built the same way; returns the ``extra`` arrays.  With ``strict`` a
    different count, a missing key or another shape raises; otherwise
    missing entries are skipped."""
    shareds = state_shareds(params, updates)
    with np.load(_npz_path(path), allow_pickle=False) as archive:
        saved = {k: archive[k] for k in archive.files}
    n_state = len([k for k in saved if not k.startswith("extra:")])
    if strict and n_state != len(shareds):
        raise ValueError(f"checkpoint has {n_state} state entries, this graph has {len(shareds)}: "
                         "was the optimizer or the updates list built differently?")
    for k, sv in zip(_keys(shareds), shareds):
        if k not in saved:
            if strict:
                raise KeyError(f"checkpoint missing {k!r}")
            continue
        val, cur = saved[k], sv.get_value()
        if strict and cur.shape != val.shape:
            raise ValueError(f"checkpoint entry {k!r} has shape {val.shape}, variable has {cur.shape}")
        sv.set_value(val.astype(cur.dtype, copy=False))
    return {k[len("extra:"):]: v for k, v in saved.items() if k.startswith("extra:")}
