"""Device resolution shared by shared variables and the linker."""

from __future__ import annotations

from typing import Optional, Union


def resolve_device(device: Optional[Union[str, "torch.device"]] = None) -> "torch.device":  # noqa: F821
    """The ``torch.device`` to run on: ``device``, else ``config.device``.
    Asking for CUDA where there is none raises; nothing carries on on
    the CPU in its place."""
    import torch

    from aesara_tpu_torch.config import config

    dev = torch.device(config.device if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cpu' or 'cuda'")
    return dev
