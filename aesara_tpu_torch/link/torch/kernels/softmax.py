"""K4: row softmax and log-softmax over the last axis (CUDA C++).

Replaces ``softmax_rows`` / ``log_softmax_rows``
(``aesara_tpu/link/jax/pallas_kernels.py:89,129``), which padded rows to
8 and columns to 128 with −inf and ran one VMEM tile per 8 rows.

The kernel is ``csrc/softmax_rows.cu`` (its header says what bounds it on
the H100 and how each regime is laid out).  :func:`launch_plan` picks its
regime and block from the width alone: rows of up to ``LANE_ROWS_MAX``
values go to lane groups (a power of two of lanes a row, a warp at most,
the values in registers), rows of up to ``ONE_PASS`` values one block a
row, wider rows two passes.  The kernel takes the widest access the
tensors' addresses and the rows allow.  bf16 and fp16 compute in fp32;
fp64 in fp64.

Semantics are those of ``jax.nn.softmax`` / ``log_softmax``, which the JAX
lowering calls (``link/jax/linalg_dispatch.py:372-386``): −inf entries
give 0 (log: −inf), and a row that is −inf throughout gives nan, as
``jax.nn`` does (the Pallas kernel's ``isfinite`` guard on the max gives
nan for such a row as well).  :func:`softmax_rows` is the wrapper: CPU
tensors take :func:`softmax_rows_plain`, CUDA tensors launch the kernel.
"""

from __future__ import annotations

import ctypes

__all__ = ["BLOCK_ROWS", "LANE_GROUPS", "LANE_ROWS_MAX", "ONE_PASS", "TWO_PASS", "launch_plan", "launch_softmax",
           "softmax_rows", "softmax_rows_plain"]

#: the kernel's regimes (see ``csrc/softmax_rows.cu``)
LANE_GROUPS, BLOCK_ROWS, TWO_PASS = 0, 1, 2
#: widest row of the lane groups (32 values a lane of a warp), and of one
#: pass (32 values a thread of a block of 512); threads a block of the lane
#: groups, and of a row in two passes (all four set by the H100 sweeps of
#: ``chip_smoke.py --k4-times`` that PERF.md records)
LANE_ROWS_MAX = 1024
ONE_PASS = 16384
GROUP_THREADS = 128
TWO_PASS_THREADS = 256

_CODES: dict = {}   # torch dtype -> the kernel's dtype code, filled on first use


def softmax_rows_plain(x, log: bool = False):
    """Softmax (or log-softmax) over the last axis: subtract the row max,
    exponentiate, normalise; in fp32 (fp64 for fp64 input), cast back."""
    import torch

    if x.shape[-1] == 0:
        return x.clone()
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    z = x.to(acc)
    z = z - z.amax(dim=-1, keepdim=True)
    e = torch.exp(z)
    s = e.sum(dim=-1, keepdim=True)
    return (z - torch.log(s) if log else e / s).to(x.dtype)


def launch_plan(n: int):
    """(regime, tile) of K4's launch for rows of ``n`` values: the lane
    groups' tile is the threads of a block (a row takes as many lanes as
    its vectors, up to a warp), a wider regime's the threads of its one
    row, the fewest of at least 128 that hold the row in one pass."""
    if n <= LANE_ROWS_MAX:
        return LANE_GROUPS, GROUP_THREADS
    if n <= ONE_PASS:
        return BLOCK_ROWS, max(128, 1 << (-(-n // 32) - 1).bit_length())
    return TWO_PASS, TWO_PASS_THREADS


def _library():
    """The built library, its functions typed; kept after the first call,
    so a launch pays for no lookup."""
    from aesara_tpu_torch.link.torch.kernels.build import load_cuda_library

    if _library.lib is None:
        lib = load_cuda_library("softmax_rows")
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn in (lib.softmax_rows, lib.softmax_rows_floor):
            fn.argtypes = [p, p, q, i, q, i, i, i, i, p]
            fn.restype = i
        lib.softmax_rows_error_string.argtypes = [i]
        lib.softmax_rows_error_string.restype = ctypes.c_char_p
        _library.lib = lib
    return _library.lib


_library.lib = None


def _dtype_code(dtype):
    if not _CODES:
        import torch

        _CODES.update({torch.float32: 0, torch.float64: 1, torch.float16: 2, torch.bfloat16: 3})
    return _CODES.get(dtype)


def launch_softmax(x2, out, log: bool, regime: int, tile: int, floor: bool = False):
    """One launch of K4 into the contiguous (m, n) CUDA tensor ``out`` for
    the (m, n) ``x2`` (its rows any number of values apart, its columns
    adjacent), at ``regime`` and ``tile``, on the current stream (so a CUDA
    graph can capture it); the wrapper counts it, a direct caller (a sweep,
    a test) does not.  ``floor``: the same launch of a kernel that does
    nothing (the launch floor)."""
    import torch

    m, n = x2.shape
    if out.shape != x2.shape or out.dtype != x2.dtype or not out.is_contiguous() or (n > 1 and x2.stride(1) != 1):
        raise ValueError(f"softmax_rows: x {tuple(x2.shape)} {x2.dtype} strides {x2.stride()} into out "
                         f"{tuple(out.shape)} {out.dtype} strides {out.stride()}")
    lib = _library()
    fn = lib.softmax_rows_floor if floor else lib.softmax_rows
    # the raw stream handle, as PyTorch's own generated kernels read it:
    # a torch.cuda.Stream object would cost more host time than the kernel
    stream = torch._C._cuda_getCurrentRawStream(x2.get_device())
    err = fn(x2.data_ptr(), out.data_ptr(), m, n, x2.stride(0) if m > 1 else n, _dtype_code(x2.dtype),
             1 if log else 0, regime, tile, stream)
    if err != 0:
        raise RuntimeError(f"softmax_rows launch failed: {lib.softmax_rows_error_string(err).decode()}")


def softmax_rows(x, log: bool = False):
    """Softmax (``log=True``: log-softmax) over the last axis of ``x``: the
    CUDA kernel for a CUDA tensor, the plain version for a CPU one.  A 2-D
    view whose last axis is contiguous is read in place."""
    import torch

    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"softmax_rows: tensor on {x.device}")
        softmax_rows.plain_calls += 1
        return softmax_rows_plain(x, log)
    if _dtype_code(x.dtype) is None:
        raise TypeError(f"softmax_rows takes a floating tensor, got {x.dtype}")
    if x.numel() == 0:
        return torch.empty_like(x)
    n = x.shape[-1] if x.dim() else 1
    x2 = x if x.dim() == 2 else x.reshape(-1, n)
    if n > 1 and x2.stride(1) != 1:
        x2 = x2.contiguous()
    out = torch.empty_like(x2)    # contiguous: x2 is, or is not dense
    launch_softmax(x2, out, log, *launch_plan(n))
    softmax_rows.launches += 1
    return out if out.shape == x.shape else out.reshape(x.shape)


#: launches of the CUDA kernel, calls that took the plain version, and the
#: launches replayed from captured graphs (tallied by the linker)
softmax_rows.launches = 0
softmax_rows.plain_calls = 0
softmax_rows.replayed = 0
