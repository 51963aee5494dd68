"""Training checkpoints: the parameters and the optimizer state as one
``.npz`` (reference ``aesara_tpu/models/checkpoint.py``).

The state is ``params`` plus every shared target of an ``updates`` list
(Adam moments, step counters, loss scales), in that order; each array is
keyed ``<index>:<name>``, as the JAX package keys it, so a checkpoint
either package writes loads into the same model built by the other.
A bfloat16 value is saved in float32, which holds it exactly, and loaded
back in the variable's dtype, as the JAX package does
(``aesara_tpu/models/checkpoint.py:50-58,100-110``): so the two packages'
files are alike, and neither needs ml_dtypes to read the other's.
"""

from __future__ import annotations

import numpy as np

from aesara_tpu_torch.compile.sharedvalue import SharedVariable
from aesara_tpu_torch.misc.safe_asarray import _asarray
from aesara_tpu_torch.scalar.ops import is_torch_tensor, to_host


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


def _savable(value) -> np.ndarray:
    """A value as NumPy: a torch tensor (the user form of a bfloat16 one)
    in its host form, float32."""
    return to_host(value, str(value.dtype).split(".")[-1]) if is_torch_tensor(value) else np.asarray(value)


def save_checkpoint(path, params, updates=None, extra=None):
    """Write every state variable's value, and the arrays of ``extra``
    (a dict, e.g. the data loader's position), to an ``.npz``."""
    shareds = state_shareds(params, updates)
    arrays = {k: _savable(sv.get_value()) for k, sv in zip(_keys(shareds), shareds)}
    for k, v in (extra or {}).items():
        arrays[f"extra:{k}"] = _savable(v)
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
        val, shape = saved[k], tuple(sv.get_value().shape)
        if strict and shape != val.shape:
            raise ValueError(f"checkpoint entry {k!r} has shape {val.shape}, variable has {shape}")
        sv.set_value(_asarray(val, sv.type.dtype))
    return {k[len("extra:"):]: v for k, v in saved.items() if k.startswith("extra:")}
