"""K2, the flash-attention forward, and K3, its backward.

K2 replaces ``_flash_forward`` / ``flash_attention``
(``aesara_tpu/link/jax/pallas_kernels.py:205,370``), K3
``flash_attention_grads`` (``:403``).  The kernels are CUDA C++ in
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``, with the pieces they
share in ``csrc/flash_mma.cuh`` (their headers say what bounds them on the
H100 and how they are built); :func:`flash_attention` and
:func:`flash_attention_grads` are the wrappers.  CPU tensors take the
plain PyTorch versions (:func:`attention_plain`,
:func:`attention_grads_plain`); CUDA tensors launch the kernels.

The wrappers call ``.contiguous()`` on their inputs: the ops' operands
arrive as ``Reshape(DimShuffle(.))`` views, and the kernels read
contiguous (BH, T, D) panels.  K3 takes no saved state, as
``FusedAttentionGrad`` takes only (q, k, v, dout): it re-runs K2 for the
output and the row logsumexp (natural log), then launches the two
backward kernels.  Every product of both kernels runs on the tensor cores
with ``mma.sync``: fp32 in 3xTF32 (each operand split into two TF32
halves, three TF32 products, so fp32 stays close to fp32), bf16 as one
bf16 product, both with fp32 sums.  They use no atomics: two calls give
the same bits.  They stage rows by 16-byte ``cp.async``, so a panel whose
rows are not a multiple of 16 bytes, or not 16-byte aligned, goes to them
padded with zero columns (:func:`cp_async_rows`), and the results are cut
back.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

__all__ = ["attention_plain", "attention_grads_plain", "flash_attention", "flash_attention_grads"]


def _operand(x, dtype):
    """``x`` rounded to bfloat16 and widened again where the inputs are
    bfloat16: the kernels round P (and K3 dS) so before their second
    product, as the operands are, and so do the reference's flash kernels
    (their ``dot_dtype``, ``aesara_tpu/link/jax/pallas_kernels.py:205,403``)."""
    import torch

    return x.to(dtype).to(x.dtype) if dtype == torch.bfloat16 else x


def attention_plain(q, k, v, causal: bool, scale: float, with_lse: bool = False):
    """softmax(q kᵀ · scale [+ causal mask]) v in fp32 (fp64 for fp64
    inputs), cast back to the input dtype; with ``with_lse`` also the row logsumexp, (BH, T) fp32 in
    natural-log units.  The composition of ``_attention_ref``
    (``aesara_tpu/tensor/nnet/attention.py:29-40``); for bfloat16 inputs
    P is rounded to bfloat16 before P·V, as K2 and the reference's flash
    kernel round it."""
    import torch

    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    s = torch.einsum("btd,bsd->bts", q.to(acc), k.to(acc)) * scale
    if causal:
        T = q.shape[1]
        mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bts,bsd->btd", _operand(p, q.dtype), v.to(acc)).to(q.dtype)
    return (out, lse.float()) if with_lse else out


def attention_grads_plain(q, k, v, do, causal: bool, scale: float):
    """(dq, dk, dv) of :func:`attention_plain` for the output gradient
    ``do``, by the formulas the kernel applies, in fp32 (fp64 for fp64
    inputs), cast back to the input dtype: P = exp(scale·QKᵀ − lse),
    D = rowsum(dO ⊙ O), dS = P ⊙ (dO Vᵀ − D), dQ = scale·dS K,
    dK = scale·dSᵀ Q, dV = Pᵀ dO.  For bfloat16 inputs it rounds where K2
    and K3 (and the reference's flash kernels) round: O is the forward's
    output in bfloat16, and P and dS are rounded to bfloat16 before their
    second products."""
    import torch

    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    qa, ka, va, da = (t.to(acc) for t in (q, k, v, do))
    s = torch.einsum("btd,bsd->bts", qa, ka) * scale
    if causal:
        T = q.shape[1]
        mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    o = _operand(torch.einsum("bts,bsd->btd", _operand(p, q.dtype), va), q.dtype)
    ds = p * (torch.einsum("btd,bsd->bts", da, va) - (da * o).sum(-1, keepdim=True))
    dq = torch.einsum("bts,bsd->btd", _operand(ds, q.dtype), ka) * scale
    dk = torch.einsum("bts,btd->bsd", _operand(ds, q.dtype), qa) * scale
    dv = torch.einsum("bts,btd->bsd", _operand(p, q.dtype), da)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _library(name: str, defines=()):
    """The built kernel library ``name`` ("flash_fwd" or "flash_bwd"), a
    build variant with ``defines`` given (see ``build.load_cuda_library``)."""
    from aesara_tpu_torch.link.torch.kernels.build import load_cuda_library

    lib = load_cuda_library(name, tuple(defines))
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        entry = getattr(lib, name)
        if name == "flash_fwd":
            entry.argtypes = [p, p, p, p, p, i, i, i, f, i, i, p]
        else:
            entry.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, f, i, i, p]
        entry.restype = i
        errstr = getattr(lib, f"{name}_error_string")
        errstr.argtypes = [i]
        errstr.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_cuda_panels(name: str, *ts):
    """Raise unless the tensors are (BH, T, D) panels of one shape, one
    dtype (float32 or bfloat16) and one CUDA device that the kernels take."""
    import torch

    q = ts[0]
    if any(t.device != q.device for t in ts) or q.device.type != "cuda":
        raise ValueError(f"{name}: operands on {', '.join(str(t.device) for t in ts)}")
    if any(t.dtype != q.dtype for t in ts) or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes float32 or bfloat16, got {', '.join(str(t.dtype) for t in ts)}")
    if q.dim() != 3 or any(t.shape != q.shape for t in ts):
        raise ValueError(f"{name} needs equal (BH, T, D) shapes, got "
                         f"{', '.join(str(tuple(t.shape)) for t in ts)}")
    BH, T, D = q.shape
    if D > 128 or BH > 65535:
        raise ValueError(f"{name} kernel takes D <= 128 and BH <= 65535, got {tuple(q.shape)}")


def cp_async_width(D: int, itemsize: int) -> int:
    """The row width, in values, at which K2 and K3 stage a panel of width
    ``D``: D rounded up to a multiple of 16 bytes."""
    per = 16 // itemsize
    return -(-D // per) * per


def cp_async_rows(t, width: int):
    """``t`` as K2 and K3 stage it by 16-byte ``cp.async``: rows of
    ``width`` values from a 16-byte aligned address.  ``t`` itself when it
    is so already, else a copy padded with zero columns.  The zeros change
    no product: they add nothing to Q Kᵀ, dO Vᵀ or rowsum(dO ⊙ O), and they
    give zero output and gradient columns, which the caller cuts off."""
    if t.shape[-1] == width and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros((*t.shape[:-1], width))
    out[..., : t.shape[-1]] = t
    return out


def _flash_fwd(q, k, v, causal: bool, scale: float, with_lse: bool):
    """K2 on contiguous (BH, T, width) CUDA panels as :func:`cp_async_rows`
    gives them: (out of the same width, lse or None)."""
    import torch

    BH, T, width = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q.device) if with_lse else None
    lib = _library("flash_fwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        None if lse is None else lse.data_ptr(), BH, T, width, float(scale),
                        int(bool(causal)), 0 if q.dtype == torch.float32 else 1, stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: {lib.flash_fwd_error_string(err).decode()}")
    flash_attention.launches += 1
    return out, lse


def flash_attention(q, k, v, causal: bool = False, scale: Optional[float] = None,
                    with_lse: bool = False):
    """Attention over (BH, T, D) panels: the CUDA kernel for CUDA tensors
    (3xTF32 tensor-core products for fp32, deterministic), the plain
    version for CPU tensors."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if all(t.device.type == "cpu" for t in (q, k, v)):
        flash_attention.plain_calls += 1
        return attention_plain(q, k, v, causal, scale, with_lse)
    _check_cuda_panels("flash_attention", q, k, v)
    D = q.shape[-1]
    width = cp_async_width(D, q.element_size())
    q, k, v = (cp_async_rows(t.contiguous(), width) for t in (q, k, v))
    out, lse = _flash_fwd(q, k, v, causal, scale, with_lse)
    if width != D:
        out = out[..., :D].contiguous()
    return (out, lse) if with_lse else out


#: launches of the CUDA kernel, calls that took the plain version, and the
#: launches replayed from captured graphs (tallied by the linker)
flash_attention.launches = 0
flash_attention.plain_calls = 0
flash_attention.replayed = 0


def flash_attention_grads(q, k, v, do, causal: bool = False, scale: Optional[float] = None):
    """(dq, dk, dv) of attention over (BH, T, D) panels for the output
    gradient ``do`` (cast to q's dtype): the CUDA kernels for CUDA
    tensors, the plain version for CPU tensors.  On the card this re-runs
    the forward kernel (K2) for the output and the row logsumexp, then
    launches K3's two kernels (3xTF32 tensor-core products for fp32,
    deterministic), all on the same padded panels."""
    import torch

    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    do = do.to(q.dtype)
    if all(t.device.type == "cpu" for t in (q, k, v, do)):
        flash_attention_grads.plain_calls += 1
        return attention_grads_plain(q, k, v, do, causal, scale)
    _check_cuda_panels("flash_attention_grads", q, k, v, do)
    BH, T, D = q.shape
    # padded once: K2's recompute and K3's kernels take the same panels
    width = cp_async_width(D, q.element_size())
    q, k, v, do = (cp_async_rows(t.contiguous(), width) for t in (q, k, v, do))
    o, lse = _flash_fwd(q, k, v, causal, scale, with_lse=True)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((BH, T), dtype=torch.float32, device=q.device)
    lib = _library("flash_bwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                        lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                        delta.data_ptr(), BH, T, width, float(scale), int(bool(causal)),
                        0 if q.dtype == torch.float32 else 1, stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd launch failed: {lib.flash_bwd_error_string(err).decode()}")
    flash_attention_grads.launches += 1
    if width != D:
        dq, dk, dv = (t[..., :D].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


#: launches of the CUDA kernels, calls that took the plain version, and the
#: launches replayed from captured graphs (tallied by the linker)
flash_attention_grads.launches = 0
flash_attention_grads.plain_calls = 0
flash_attention_grads.replayed = 0
