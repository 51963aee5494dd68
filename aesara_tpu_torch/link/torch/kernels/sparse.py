"""K5, K6 and K7: CSR products, each with its plain PyTorch version.

K5 :func:`csr_spmv` replaces ``bss_matmul`` (``aesara_tpu/link/jax/bss.py:197``),
K6 :func:`csr_spmm` replaces ``_bss_matmul_wide`` (``bss.py:271``) and K7
:func:`csr_sddmm` replaces ``bss_sddmm`` (``bss.py:354``).  The kernels
are CUDA C++ in ``csrc/csr_spmm.cu`` (its header says what bounds them on
the H100 and how each is laid out); they read a
:class:`~aesara_tpu_torch.link.torch.csr.CSRMat`.  CPU tensors take the
plain versions (:func:`csr_matmul_plain`, :func:`csr_sddmm_plain`), CUDA
tensors launch the kernels or raise.

K6 splits the merged sequence of row ends and entries into chunks of
``SPMM_CHUNK`` items (the merge-based split of Merrill & Garland).  Its
plan, the row at which each chunk starts (:func:`merge_path_plan`), is
made on the matrix's device with torch ops and kept with the matrix
(:func:`spmm_plan`).  K7 splits x's entries by the same plan, at the
same chunk size, so one plan serves both.

:func:`csr_matmul` picks K5 for a rhs of at most ``SPMV_MAX_C`` columns
(a vector counts as one) and K6 for a wider one.  No TPU threshold carries
over: the split is set from the H100 timings of both kernels at the GLM's
shape that ``PERF.md`` records.
"""

from __future__ import annotations

import ctypes

__all__ = ["SPMM_CHUNK", "SPMM_SHORT", "SPMV_MAX_C", "csr_matmul", "csr_matmul_plain", "csr_spmv", "csr_spmm",
           "csr_sddmm", "csr_sddmm_plain", "launch_sddmm", "merge_path_plan", "row_ids", "spmm_plan",
           "spmm_vector_bytes"]

#: widest rhs that K5 takes in :func:`csr_matmul`; wider ones go to K6
SPMV_MAX_C = 8
#: items (row ends and stored entries) of K6's merged sequence per warp
SPMM_CHUNK = 128
#: K6 sums a row with at most this many warp steps' entries in a chunk with
#: one lane group alone, several such rows at once (both set from the H100
#: sweep of ``chip_smoke.py --k6-sweep`` that ``PERF.md`` records)
SPMM_SHORT = 2


def _acc_dtype(dtype):
    import torch

    return torch.float64 if dtype == torch.float64 else torch.float32


def row_ids(a):
    """The row of every stored entry of ``a``, as int64."""
    import torch

    counts = (a.indptr[1:] - a.indptr[:-1]).long()
    # the length given, so that the host does not wait for the device
    return torch.repeat_interleave(torch.arange(a.shape[0], device=counts.device), counts, output_size=a.nnz)


def csr_matmul_plain(a, b, out_dtype):
    """``a @ b`` for a CSRMat ``a`` and a dense (d,) or (d, C) ``b``: each
    stored entry times its rhs row, summed into its output row, in
    float32 (float64 for float64 output)."""
    import torch

    acc = _acc_dtype(out_dtype)
    b2 = b.reshape(b.shape[0], -1)
    prod = a.data.to(acc)[:, None] * b2.to(acc)[a.indices.long()]
    out = torch.zeros((a.shape[0], b2.shape[1]), dtype=acc, device=b.device)
    out.index_add_(0, row_ids(a), prod)
    out = out.to(out_dtype)
    return out.reshape(a.shape[0]) if b.dim() == 1 else out


def csr_sddmm_plain(a, gz, b):
    """The values of (gz @ bᵀ) at ``a``'s stored entries, in ``a``'s entry
    order and dtype."""
    acc = _acc_dtype(a.dtype)
    gz2, b2 = gz.reshape(gz.shape[0], -1).to(acc), b.reshape(b.shape[0], -1).to(acc)
    return (gz2[row_ids(a)] * b2[a.indices.long()]).sum(-1).to(a.dtype)


def merge_path_plan(indptr, nnz: int, chunk: int = SPMM_CHUNK):
    """K6's plan for a CSR with this ``indptr`` and ``nnz`` stored entries:
    int32, one more than the number of chunks; item c is the row at which
    chunk c starts.

    The merged sequence puts row r's end after its last entry, at position
    ``r + indptr[r + 1]``; chunk c covers the positions from ``c * chunk``
    (clamped to n + nnz).  The rows started before a diagonal are the row
    ends before it, so the plan is one ``searchsorted`` on the device: no
    value goes back to the host.  The number of chunks comes from the
    shapes alone."""
    import torch

    n = indptr.shape[0] - 1
    nchunks = max(1, -(-(n + nnz) // chunk))
    if n + nnz + chunk >= 2**31:
        raise ValueError("K6 takes fewer than 2**31 rows and stored entries together")
    i32 = dict(device=indptr.device, dtype=torch.int32)
    diag = torch.arange(0, (nchunks + 1) * chunk, chunk, **i32).clamp_(max=n + nnz)
    ends = indptr[1:] + torch.arange(n, **i32)
    return torch.searchsorted(ends, diag, out_int32=True)


def spmm_plan(a, chunk: int = SPMM_CHUNK):
    """K6's plan for the CSRMat ``a``, made once and kept with its pattern
    (``a.plans``, which its transposes and ``with_data`` share)."""
    plan = a.plans.get(chunk)
    if plan is None:
        plan = a.plans[chunk] = merge_path_plan(a.indptr, a.nnz, chunk)
    return plan


def spmm_vector_bytes(C: int, itemsize: int, address: int) -> int:
    """The bytes of one rhs load in K6 and K7: the widest of 16, 8, 4 and 2
    that is at least one item and divides both a rhs row (``C * itemsize``)
    and ``address``.  K7 passes its operands' addresses and row strides in
    bytes OR-ed together: a power of two divides that if and only if it
    divides each of them."""
    for vec in (16, 8, 4, 2):
        if vec >= itemsize and (C * itemsize) % vec == 0 and address % vec == 0:
            return vec
    raise ValueError(f"no load width for {C} items of {itemsize} bytes at address {address:#x}")


def _library():
    from aesara_tpu_torch.link.torch.kernels.build import load_cuda_library

    lib = load_cuda_library("csr_spmm")
    if not getattr(lib, "_typed", False):
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.csr_spmv.argtypes = [p, p, p, p, p, i, i, i, p]
        lib.csr_spmv.restype = i
        lib.csr_spmm.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        lib.csr_spmm.restype = i
        lib.csr_sddmm.argtypes = [p, p, p, p, p, p, i, i, i, q, q, i, i, i, i, p]
        lib.csr_sddmm.restype = i
        lib.csr_spmm_error_string.argtypes = [i]
        lib.csr_spmm_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_cuda(name, a, *dense):
    if a.data.device.type != "cuda" or any(t.device != a.data.device for t in dense):
        raise ValueError(f"{name}: operands on {a.data.device} and "
                         f"{', '.join(str(t.device) for t in dense)}")
    if a.shape[0] >= 2**31 or a.nnz >= 2**31:
        raise ValueError(f"{name}: the kernel takes fewer than 2**31 rows and stored entries")


def _launch_spmv(a, data, b2, out, code):
    import torch

    lib = _library()
    stream = torch.cuda.current_stream(a.data.device).cuda_stream
    err = lib.csr_spmv(a.indptr.data_ptr(), a.indices.data_ptr(), data.data_ptr(), b2.data_ptr(),
                       out.data_ptr(), a.shape[0], b2.shape[1], code, stream)
    if err != 0:
        raise RuntimeError(f"csr_spmv launch failed: {lib.csr_spmm_error_string(err).decode()}")


def _matmul_operands(name, a, b, out_dtype):
    """(data, rhs as a contiguous (d, C) matrix, dtype code) for K5/K6."""
    import torch

    if b.dim() not in (1, 2) or b.shape[0] != a.shape[1]:
        raise ValueError(f"{name}: rhs of shape {tuple(b.shape)} for a {a.shape} matrix")
    b2 = b.reshape(b.shape[0], -1)
    if out_dtype == torch.float64:
        return a.data.to(torch.float64), b2.to(torch.float64).contiguous(), 2
    if out_dtype != torch.float32 or a.data.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 or float64 values, got {a.data.dtype} -> {out_dtype}")
    if b2.dtype == torch.bfloat16:
        return a.data, b2.contiguous(), 1
    return a.data, b2.to(torch.float32).contiguous(), 0


def _launch_spmm(a, data, b2, out, code, chunk, short):
    """K6's two passes (the chunks, then the fix-up of the rows they cut)."""
    import torch

    n, C = a.shape[0], b2.shape[1]
    plan = spmm_plan(a, chunk)
    nchunks = plan.shape[0] - 1
    carry = torch.empty((nchunks, C), dtype=out.dtype, device=out.device)
    vec = spmm_vector_bytes(C, b2.element_size(), b2.data_ptr())
    lib = _library()
    stream = torch.cuda.current_stream(a.data.device).cuda_stream
    err = lib.csr_spmm(a.indptr.data_ptr(), a.indices.data_ptr(), data.data_ptr(), b2.data_ptr(),
                       out.data_ptr(), carry.data_ptr(), plan.data_ptr(), n, a.nnz, C, chunk, nchunks,
                       short, code, vec, stream)
    if err != 0:
        raise RuntimeError(f"csr_spmm launch failed: {lib.csr_spmm_error_string(err).decode()}")


def _product(kernel, a, b, out_dtype, launch):
    """``a @ b`` by ``kernel``'s plain version for CPU operands, else by
    ``launch(a, data, rhs, out, dtype code)``."""
    import torch

    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    if a.data.device.type == "cpu" and b.device.type == "cpu":
        kernel.plain_calls += 1
        return csr_matmul_plain(a, b, out_dtype)
    name = kernel.__name__
    _check_cuda(name, a, b)
    data, b2, code = _matmul_operands(name, a, b, out_dtype)
    C = b2.shape[1]
    out = torch.empty((a.shape[0], C), dtype=out_dtype, device=b.device)
    if a.shape[0] and C:
        launch(a, data, b2, out, code)
        kernel.launches += 1
    return out.reshape(a.shape[0]) if b.dim() == 1 else out


def csr_spmv(a, b, out_dtype=None):
    """K5: ``a @ b`` for a narrow rhs, one warp per row."""
    return _product(csr_spmv, a, b, out_dtype, _launch_spmv)


def csr_spmm(a, b, out_dtype=None, chunk: int = SPMM_CHUNK, short: int = SPMM_SHORT):
    """K6: ``a @ b`` for a wide rhs, split by entries into chunks of
    ``chunk`` merged items, one warp each (``short``: see ``SPMM_SHORT``);
    one launch counted per call."""
    return _product(csr_spmm, a, b, out_dtype,
                    lambda a, data, b2, out, code: _launch_spmm(a, data, b2, out, code, chunk, short))


def csr_matmul(a, b, out_dtype):
    """``a @ b`` in ``out_dtype``: K5 for a vector or a rhs of at most
    ``SPMV_MAX_C`` columns, else K6."""
    C = 1 if b.dim() == 1 else b.shape[1]
    return (csr_spmv if C <= SPMV_MAX_C else csr_spmm)(a, b, out_dtype)


def _sddmm_rows(t, dtype):
    """``t`` as a (rows, C) matrix of ``dtype`` whose columns are adjacent;
    its rows may lie any multiple of a value apart (a column slice is taken
    as it is)."""
    t2 = t.reshape(t.shape[0], -1).to(dtype)
    return t2 if t2.stride(1) == 1 or t2.shape[1] == 1 else t2.contiguous()


def launch_sddmm(a, gz2, b2, out, chunk: int = SPMM_CHUNK):
    """One launch of K7 into ``out`` for (rows, C) CUDA operands that
    ``_sddmm_rows`` gave, split by the plan at ``chunk``; the wrapper
    counts it, a direct caller (a sweep, a test) does not."""
    import torch

    n, C = a.shape[0], b2.shape[1]
    plan = spmm_plan(a, chunk)
    item = b2.element_size()
    ld_gz, ld_b = gz2.stride(0), b2.stride(0)
    vec = spmm_vector_bytes(C, item, gz2.data_ptr() | b2.data_ptr() | ld_gz * item | ld_b * item)
    lib = _library()
    stream = torch.cuda.current_stream(a.data.device).cuda_stream
    err = lib.csr_sddmm(a.indptr.data_ptr(), a.indices.data_ptr(), gz2.data_ptr(), b2.data_ptr(),
                        out.data_ptr(), plan.data_ptr(), n, a.nnz, C, ld_gz, ld_b, chunk, plan.shape[0] - 1,
                        0 if out.dtype == torch.float32 else 2, vec, stream)
    if err != 0:
        raise RuntimeError(f"csr_sddmm launch failed: {lib.csr_spmm_error_string(err).decode()}")


def csr_sddmm(a, gz, b):
    """K7: the CSRMat with ``a``'s pattern (its indptr and indices) and the
    values of (gz @ bᵀ) at its stored entries; x's entries split by K6's
    plan, one warp a chunk."""
    import torch

    if (gz.dim() != b.dim() or gz.shape[1:] != b.shape[1:] or gz.shape[0] != a.shape[0]
            or b.shape[0] != a.shape[1]):
        raise ValueError(f"csr_sddmm: gz {tuple(gz.shape)} and b {tuple(b.shape)} "
                         f"for a {a.shape} matrix")
    if a.data.device.type == "cpu" and gz.device.type == "cpu" and b.device.type == "cpu":
        csr_sddmm.plain_calls += 1
        return a.with_data(csr_sddmm_plain(a, gz, b))
    _check_cuda("csr_sddmm", a, gz, b)
    if a.data.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"csr_sddmm takes float32 or float64 values, got {a.data.dtype}")
    gz2, b2 = _sddmm_rows(gz, a.data.dtype), _sddmm_rows(b, a.data.dtype)
    out = torch.empty_like(a.data)
    if a.nnz and b2.shape[1]:
        launch_sddmm(a, gz2, b2, out)
        csr_sddmm.launches += 1
    elif a.nnz:
        out.zero_()
    return a.with_data(out)


#: launches of the CUDA kernels, calls that took the plain version, and the
#: launches replayed from captured graphs (tallied by the linker)
csr_spmv.launches = csr_spmv.plain_calls = csr_spmv.replayed = 0
csr_spmm.launches = csr_spmm.plain_calls = csr_spmm.replayed = 0
csr_sddmm.launches = csr_sddmm.plain_calls = csr_sddmm.replayed = 0
