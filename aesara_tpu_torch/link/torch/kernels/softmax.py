"""K4: row softmax and log-softmax over the last axis (Triton).

Replaces ``softmax_rows`` / ``log_softmax_rows``
(``aesara_tpu/link/jax/pallas_kernels.py:89,129``), which padded rows to
8 and columns to 128 with −inf and ran one VMEM tile per 8 rows.

On the H100 this is bound by device memory: it reads each value once and
writes it once for a handful of flops, so the design is about bytes and
about filling the card.  Each program takes a block of rows, so narrow
rows (the 20 classes of a text classifier) do not leave most of a program
idle: up to ``_TILE`` values a program, in one pass that keeps the row in
registers.  Rows wider than ``_ONE_PASS`` columns loop over the columns
twice, first with a running max and sum, then writing the output.  bf16
and fp16 compute in fp32; fp64 in fp64.

Semantics are those of ``jax.nn.softmax`` / ``log_softmax``, which the JAX
lowering calls (``link/jax/linalg_dispatch.py:372-386``): −inf entries
give 0 (log: −inf), and a row that is −inf throughout gives nan, as
``jax.nn`` does (the Pallas kernel's ``isfinite`` guard on the max gives
nan for such a row as well).  :func:`softmax_rows` is the wrapper: CPU
tensors take :func:`softmax_rows_plain`, CUDA tensors launch the kernel.
"""

from __future__ import annotations

__all__ = ["launch_config", "softmax_rows", "softmax_rows_plain"]

_TILE = 1024        # values a program holds in the one-pass kernel
_ONE_PASS = 8192    # widest row the one-pass kernel takes
_LOOP_BLOCK = 2048  # columns per step of the two-pass kernel

_SOURCE = '''import triton
import triton.language as tl


@triton.jit
def one_pass(x_ptr, out_ptr, m, n, stride_x, stride_o, LOG: tl.constexpr,
             BLOCK_M: tl.constexpr, BLOCK_N: tl.constexpr, ACC: tl.constexpr):
    rows = tl.program_id(0) * BLOCK_M + tl.arange(0, BLOCK_M)
    cols = tl.arange(0, BLOCK_N)
    mask = (rows[:, None] < m) & (cols[None, :] < n)
    r64 = rows[:, None].to(tl.int64)
    x = tl.load(x_ptr + r64 * stride_x + cols[None, :], mask=mask, other=float("-inf")).to(ACC)
    z = x - tl.max(x, axis=1)[:, None]
    e = tl.exp(z)
    s = tl.sum(e, axis=1)
    if LOG:
        out = z - tl.log(s)[:, None]
    else:
        out = e / s[:, None]
    tl.store(out_ptr + r64 * stride_o + cols[None, :], out.to(out_ptr.dtype.element_ty), mask=mask)


@triton.jit
def two_pass(x_ptr, out_ptr, m, n, stride_x, stride_o, LOG: tl.constexpr,
             BLOCK_M: tl.constexpr, BLOCK_N: tl.constexpr, ACC: tl.constexpr):
    rows = tl.program_id(0) * BLOCK_M + tl.arange(0, BLOCK_M)
    r64 = rows[:, None].to(tl.int64)
    row_ok = rows[:, None] < m
    m_i = tl.full([BLOCK_M], float("-inf"), ACC)
    s_i = tl.zeros([BLOCK_M], ACC)
    for start in range(0, n, BLOCK_N):
        cols = start + tl.arange(0, BLOCK_N)
        mask = row_ok & (cols[None, :] < n)
        x = tl.load(x_ptr + r64 * stride_x + cols[None, :], mask=mask, other=float("-inf")).to(ACC)
        m_new = tl.maximum(m_i, tl.max(x, axis=1))
        # while a row has seen only -inf, its running sum stays 0
        empty = m_new == float("-inf")
        alpha = tl.where(empty, 0.0, tl.exp(m_i - m_new))
        p = tl.where(empty[:, None], 0.0, tl.exp(x - m_new[:, None]))
        s_i = s_i * alpha + tl.sum(p, axis=1)
        m_i = m_new
    for start in range(0, n, BLOCK_N):
        cols = start + tl.arange(0, BLOCK_N)
        mask = row_ok & (cols[None, :] < n)
        x = tl.load(x_ptr + r64 * stride_x + cols[None, :], mask=mask, other=float("-inf")).to(ACC)
        z = x - m_i[:, None]
        if LOG:
            out = z - tl.log(s_i)[:, None]
        else:
            out = tl.exp(z) / s_i[:, None]
        tl.store(out_ptr + r64 * stride_o + cols[None, :], out.to(out_ptr.dtype.element_ty), mask=mask)
'''


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


def _module():
    from aesara_tpu_torch.link.torch.kernels.build import triton_module

    if _module.cache is None:
        _module.cache = triton_module(_SOURCE, "softmax_rows")
    return _module.cache


_module.cache = None


def launch_config(n: int):
    """(one pass?, BLOCK_M, BLOCK_N, num_warps) of K4's launch for rows of
    ``n`` columns: a function of ``n`` alone."""
    block_n = 1 << max(0, (n - 1).bit_length())
    if block_n <= _ONE_PASS:
        block_m = max(1, _TILE // block_n)
        return True, block_m, block_n, 4 if block_m * block_n <= 2048 else 8
    return False, 1, _LOOP_BLOCK, 8


def softmax_rows(x, log: bool = False):
    """Softmax (``log=True``: log-softmax) over the last axis of ``x``: the
    Triton kernel for a CUDA tensor, the plain version for a CPU one."""
    import torch

    if x.device.type == "cpu":
        softmax_rows.plain_calls += 1
        return softmax_rows_plain(x, log)
    import triton.language as tl

    if x.device.type != "cuda":
        raise ValueError(f"softmax_rows: tensor on {x.device}")
    if x.dtype not in (torch.float32, torch.float64, torch.bfloat16, torch.float16):
        raise TypeError(f"softmax_rows takes a floating tensor, got {x.dtype}")
    n = x.shape[-1] if x.dim() else 1
    x2 = x.reshape(-1, n).contiguous()
    m = x2.shape[0]
    out = torch.empty_like(x2)
    if m == 0 or n == 0:
        return out.reshape(x.shape)
    mod = _module()
    acc = tl.float64 if x.dtype == torch.float64 else tl.float32
    one_pass, block_m, block_n, num_warps = launch_config(n)
    kernel = mod.one_pass if one_pass else mod.two_pass
    grid = ((m + block_m - 1) // block_m,)
    kernel[grid](x2, out, m, n, x2.stride(0), out.stride(0), LOG=bool(log), BLOCK_M=block_m,
                 BLOCK_N=block_n, ACC=acc, num_warps=num_warps)
    softmax_rows.launches += 1
    return out.reshape(x.shape)


#: launches of the Triton kernel, and calls that took the plain version
softmax_rows.launches = 0
softmax_rows.plain_calls = 0
