"""K2: the flash-attention forward.

Replaces ``_flash_forward`` / ``flash_attention``
(``aesara_tpu/link/jax/pallas_kernels.py:205,370``).  The kernel is CUDA
C++ in ``csrc/flash_fwd.cu`` (its header says what bounds it on the H100
and how it is built); :func:`flash_attention` is the wrapper.  CPU
tensors take the plain PyTorch version (:func:`attention_plain`); CUDA
tensors launch the kernel.

The wrapper calls ``.contiguous()`` on q, k and v: ``FusedAttention``'s
inputs arrive as ``Reshape(DimShuffle(.))`` views, and the kernel reads
contiguous (BH, T, D) panels.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

__all__ = ["attention_plain", "flash_attention"]


def attention_plain(q, k, v, causal: bool, scale: float, with_lse: bool = False):
    """softmax(q kᵀ · scale [+ causal mask]) v in fp32 (fp64 for fp64
    inputs), cast back to the input dtype; with ``with_lse`` also the row logsumexp, (BH, T) fp32 in
    natural-log units.  The composition of ``_attention_ref``
    (``aesara_tpu/tensor/nnet/attention.py:29-40``)."""
    import torch

    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    s = torch.einsum("btd,bsd->bts", q.to(acc), k.to(acc)) * scale
    if causal:
        T = q.shape[1]
        mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bts,bsd->btd", p, v.to(acc)).to(q.dtype)
    return (out, lse.float()) if with_lse else out


def _library():
    from aesara_tpu_torch.link.torch.kernels.build import load_cuda_library

    lib = load_cuda_library("flash_fwd")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_fwd.argtypes = [p, p, p, p, p, i, i, i, ctypes.c_float, i, i, p]
        lib.flash_fwd.restype = i
        lib.flash_fwd_error_string.argtypes = [i]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def flash_attention(q, k, v, causal: bool = False, scale: Optional[float] = None,
                    with_lse: bool = False):
    """Attention over (BH, T, D) panels: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    import torch

    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if all(t.device.type == "cpu" for t in (q, k, v)):
        flash_attention.plain_calls += 1
        return attention_plain(q, k, v, causal, scale, with_lse)
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError(f"flash_attention: q, k, v on {q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash_attention needs equal (BH, T, D) shapes, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    BH, T, D = q.shape
    if D > 128 or BH > 65535:
        raise ValueError(f"flash_attention kernel takes D <= 128 and BH <= 65535, got {tuple(q.shape)}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q.device) if with_lse else None
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        None if lse is None else lse.data_ptr(), BH, T, D, float(scale),
                        int(bool(causal)), 0 if q.dtype == torch.float32 else 1, stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: {lib.flash_fwd_error_string(err).decode()}")
    flash_attention.launches += 1
    return (out, lse) if with_lse else out


#: launches of the CUDA kernel, and calls that took the plain version
flash_attention.launches = 0
flash_attention.plain_calls = 0
