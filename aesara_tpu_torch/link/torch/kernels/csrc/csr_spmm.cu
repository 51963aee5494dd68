// K5, K6 and K7: products of a CSR matrix on Hopper (sm_90a), plain C
// interface.
//
// K5 `csr_spmv` replaces the Pallas kernel `bss_matmul`
// (aesara_tpu/link/jax/bss.py:197), K6 `csr_spmm` replaces
// `_bss_matmul_wide` (bss.py:271), K7 `csr_sddmm` replaces `bss_sddmm`
// (bss.py:354).  They compute what those compute, not how: the TPU kernels
// worked on a blocked segment-slot layout because Mosaic has one gather
// shape; a GPU gathers freely, so these read plain CSR (int32 indptr and
// indices, values in the matrix's own dtype).
//
//   K5, K6:  out[r, :] = sum_k data[k] * b[indices[k], :]  for k in row r
//   K7:      out_data[k] = dot(gz[r, :], b[indices[k], :])  for k in row r
//
// What bounds them on the H100: each stored entry is read once (8 bytes)
// and pulls one rhs row of C values through the cache for 2*C flops, so
// all three are bound by memory traffic (HBM and, for scattered rhs rows,
// L2), never by arithmetic.  The design keeps every read of the CSR arrays
// coalesced and gives each row to one warp, so there are no atomics and
// the results do not depend on scheduling.
//
// K5 (narrow rhs, C small): one warp per row; lanes stride over the row's
// entries and keep one accumulator per rhs column (columns in groups of up
// to 8 registers); a warp-shuffle reduction ends the row.
// K6 (wide rhs): one warp per row and one 32-column tile of the rhs per
// block column; lanes own consecutive rhs columns, so each read of
// b[col, tile] is one coalesced row segment; the row's (col, val) pairs
// are loaded 32 at a time and broadcast across the warp by shuffles.
// K7: one warp per row; with C >= 32 lanes split each dot product over C
// and reduce by shuffles, otherwise each lane takes whole entries.  The
// output is the values array in x's own entry order: it shares x's indptr
// and indices.
//
// Implicit zeros never touch the rhs, so an inf or nan there poisons
// exactly the rows whose stored pattern hits it; a stored zero times inf
// gives nan, as in SciPy.  Accumulation is float32 for float32 values
// (also with a bfloat16 rhs) and float64 for float64 values.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int WARPS = 8;               // warps (rows) per block
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_acc(float x, float) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x, float) { return __bfloat162float(x); }
__device__ __forceinline__ double to_acc(double x, double) { return x; }

template <typename ACC>
__device__ __forceinline__ ACC warp_sum(ACC v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  return v;
}

// K5: C rhs columns in groups of CB accumulators.
template <typename T, typename TB, typename ACC, int CB>
__global__ void __launch_bounds__(THREADS)
csr_spmv_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                const T* __restrict__ data, const TB* __restrict__ b, T* __restrict__ out,
                int n, int C) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;                 // the whole warp leaves together
  const int start = indptr[row], end = indptr[row + 1];
  for (int c0 = 0; c0 < C; c0 += CB) {
    ACC acc[CB];
#pragma unroll
    for (int c = 0; c < CB; ++c) acc[c] = ACC(0);
    for (int k = start + lane; k < end; k += 32) {
      const ACC v = ACC(data[k]);
      const TB* brow = b + (long long)indices[k] * C + c0;
#pragma unroll
      for (int c = 0; c < CB; ++c)
        if (c0 + c < C) acc[c] += v * to_acc(brow[c], ACC(0));
    }
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      const ACC s = warp_sum(acc[c]);
      if (lane == 0 && c0 + c < C) out[(long long)row * C + c0 + c] = T(s);
    }
  }
}

// K6: blockIdx.y picks a tile of 32 rhs columns.
template <typename T, typename TB, typename ACC>
__global__ void __launch_bounds__(THREADS)
csr_spmm_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                const T* __restrict__ data, const TB* __restrict__ b, T* __restrict__ out,
                int n, int C) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const int col = blockIdx.y * 32 + lane;
  const bool live = col < C;
  const int start = indptr[row], end = indptr[row + 1];
  ACC acc = ACC(0);
  for (int k0 = start; k0 < end; k0 += 32) {
    const int k = k0 + lane;
    int my_col = 0;
    ACC my_val = ACC(0);
    if (k < end) {
      my_col = indices[k];
      my_val = ACC(data[k]);
    }
    const int cnt = min(32, end - k0);
    // unrolled so that several rhs loads are in flight at once: a long
    // row (a common word in the transposed twin) is one warp's serial walk
#pragma unroll 8
    for (int j = 0; j < cnt; ++j) {
      const int cj = __shfl_sync(FULL, my_col, j);
      const ACC vj = __shfl_sync(FULL, my_val, j);
      if (live) acc += vj * to_acc(b[(long long)cj * C + col], ACC(0));
    }
  }
  if (live) out[(long long)row * C + col] = T(acc);
}

// K7: gz is (n, C), b is (d, C); out has one value per stored entry.
template <typename T, typename ACC>
__global__ void __launch_bounds__(THREADS)
csr_sddmm_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                 const T* __restrict__ gz, const T* __restrict__ b, T* __restrict__ out,
                 int n, int C) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const int start = indptr[row], end = indptr[row + 1];
  const T* g = gz + (long long)row * C;
  if (C >= 32) {
    for (int k = start; k < end; ++k) {
      const T* brow = b + (long long)indices[k] * C;
      ACC s = ACC(0);
      for (int c = lane; c < C; c += 32) s += ACC(g[c]) * ACC(brow[c]);
      s = warp_sum(s);
      if (lane == 0) out[k] = T(s);
    }
  } else {
    for (int k = start + lane; k < end; k += 32) {
      const T* brow = b + (long long)indices[k] * C;
      ACC s = ACC(0);
      for (int c = 0; c < C; ++c) s += ACC(g[c]) * ACC(brow[c]);
      out[k] = T(s);
    }
  }
}

template <typename T, typename TB, typename ACC>
cudaError_t launch_spmv(const int* indptr, const int* indices, const void* data, const void* b,
                        void* out, int n, int C, cudaStream_t stream) {
  const dim3 grid((n + WARPS - 1) / WARPS);
  const T* d = static_cast<const T*>(data);
  const TB* bb = static_cast<const TB*>(b);
  T* o = static_cast<T*>(out);
  if (C == 1)
    csr_spmv_kernel<T, TB, ACC, 1><<<grid, THREADS, 0, stream>>>(indptr, indices, d, bb, o, n, C);
  else if (C == 2)
    csr_spmv_kernel<T, TB, ACC, 2><<<grid, THREADS, 0, stream>>>(indptr, indices, d, bb, o, n, C);
  else if (C <= 4)
    csr_spmv_kernel<T, TB, ACC, 4><<<grid, THREADS, 0, stream>>>(indptr, indices, d, bb, o, n, C);
  else
    csr_spmv_kernel<T, TB, ACC, 8><<<grid, THREADS, 0, stream>>>(indptr, indices, d, bb, o, n, C);
  return cudaGetLastError();
}

template <typename T, typename TB, typename ACC>
cudaError_t launch_spmm(const int* indptr, const int* indices, const void* data, const void* b,
                        void* out, int n, int C, cudaStream_t stream) {
  const dim3 grid((n + WARPS - 1) / WARPS, (C + 31) / 32);
  csr_spmm_kernel<T, TB, ACC><<<grid, THREADS, 0, stream>>>(
      indptr, indices, static_cast<const T*>(data), static_cast<const TB*>(b),
      static_cast<T*>(out), n, C);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32 values and rhs, 1 = float32 values with a
// bfloat16 rhs, 2 = float64 values and rhs.  Returns a cudaError_t.
extern "C" int csr_spmv(const int* indptr, const int* indices, const void* data, const void* b,
                        void* out, int n, int C, int dtype, void* stream) {
  if (n <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_spmv<float, float, float>(indptr, indices, data, b, out, n, C, s);
    case 1: return (int)launch_spmv<float, __nv_bfloat16, float>(indptr, indices, data, b, out, n, C, s);
    case 2: return (int)launch_spmv<double, double, double>(indptr, indices, data, b, out, n, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int csr_spmm(const int* indptr, const int* indices, const void* data, const void* b,
                        void* out, int n, int C, int dtype, void* stream) {
  if (n <= 0 || C <= 0 || (C + 31) / 32 > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_spmm<float, float, float>(indptr, indices, data, b, out, n, C, s);
    case 1: return (int)launch_spmm<float, __nv_bfloat16, float>(indptr, indices, data, b, out, n, C, s);
    case 2: return (int)launch_spmm<double, double, double>(indptr, indices, data, b, out, n, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dtype codes: 0 = float32, 2 = float64 (gz, b and the output alike).
extern "C" int csr_sddmm(const int* indptr, const int* indices, const void* gz, const void* b,
                         void* out, int n, int C, int dtype, void* stream) {
  if (n <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + WARPS - 1) / WARPS);
  if (dtype == 0) {
    csr_sddmm_kernel<float, float><<<grid, THREADS, 0, s>>>(
        indptr, indices, static_cast<const float*>(gz), static_cast<const float*>(b),
        static_cast<float*>(out), n, C);
  } else if (dtype == 2) {
    csr_sddmm_kernel<double, double><<<grid, THREADS, 0, s>>>(
        indptr, indices, static_cast<const double*>(gz), static_cast<const double*>(b),
        static_cast<double*>(out), n, C);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* csr_spmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
