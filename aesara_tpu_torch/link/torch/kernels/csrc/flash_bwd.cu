// K3: flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernels of `flash_attention_grads`
// (aesara_tpu/link/jax/pallas_kernels.py:403; dQ pass at :516, dK/dV pass
// at :611).  Given q, k, v, the forward's output O and its row logsumexp
// (both from K2, flash_fwd.cu) and the output gradient dO, over (BH, T, D)
// panels, it computes with P = exp(scale * Q K^T - lse) (masked):
//   D  = rowsum(dO * O)
//   dS = P * (dO V^T - D)
//   dQ = scale * dS K,   dK = scale * dS^T Q,   dV = P^T dO
// without writing the (T, T) matrices P or dS to device memory.
//
// What bounds it on the H100: at the flagship shape (BH=128, T=1024, D=64)
// the two kernels do 7 products of T x T x D per panel (S and dP in both,
// dS K in the first, dS^T Q and P^T dO in the second), 7 * 2*BH*T*T*D =
// 120 GFLOP against a few hundred MB of traffic: compute bound.  Like K2
// this version runs on the CUDA cores in fp32 (fp32 inputs keep fp32
// products), so the limit is the fp32 FMA rate and the shared-memory reads
// that feed it.  Tensor cores (mma/wgmma), TMA and pipelining are later work.
//
// Design.  The TPU kernels carried their accumulators across a sequential
// grid axis in VMEM scratch; here each accumulation is a loop inside one
// block, with the accumulator in registers, and no atomics:
//   - dq kernel: one block of 256 threads (16 x 16) per (bh, tile of BQ=64
//     query rows).  It stages the Q and dO tiles, computes D for its rows
//     (and writes it out for the second kernel), then walks the key tiles:
//     S and dP as 64 x 64 tiles, dS into shared memory, dQ += dS K.
//   - dkdv kernel: one block per (bh, tile of BK=64 key rows), launched
//     after the first on the same stream.  It stages its K and V tiles and
//     walks the query tiles: S^T and dP^T, P^T and dS^T into shared
//     memory, dV += P^T dO and dK += dS^T Q.
// Each thread owns a 4 x 4 block of every 64 x 64 tile (rows ty*4+i,
// columns tx+16*j) and a 4 x D/16 block of its accumulators (rows ty*4+i,
// features g*64 + tx*4 + jj), so every float4 read from shared memory
// feeds four FMAs; rows are padded by 4 floats so a warp's float4 reads hit
// distinct banks.  Tiles are staged as fp32 (bf16 inputs are widened);
// every sum is fp32.
//
// Units: K2 writes the lse in natural log.  The kernels take P as
// exp2(S * scale * log2(e) - lse * log2(e)), which is exp(S * scale - lse),
// so dS, dQ and dK come out in natural units with no log2(e) to undo.
//
// Causal: key tiles wholly above the diagonal are skipped (the dq loop
// stops at the diagonal tile, the dkdv loop starts there).  Ragged T and D
// are masked in the kernels: staged tiles are zero-filled and entries
// outside T or above the diagonal take P = 0.  D <= 128.  Inputs must be
// contiguous (BH, T, D), fp32 or bf16, all of one dtype.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;  // 16 x 16
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float& acc, const float4& a, const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float lane(const float4& a, int c) {
  return c == 0 ? a.x : c == 1 ? a.y : c == 2 ? a.z : a.w;
}

// Stage rows [r0, r0 + 64) of a (T, D) panel as fp32 rows of pitch DP,
// zero past T and D.
template <typename T, int DMAX>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, size_t base, int r0,
                                      int T_len, int D) {
  constexpr int DP = DMAX + 4;
  for (int i = threadIdx.x; i < 64 * DMAX; i += THREADS) {
    const int r = i / DMAX, d = i % DMAX, gr = r0 + r;
    dst[r * DP + d] = (gr < T_len && d < D) ? to_float(src[base + (size_t)gr * D + d]) : 0.f;
  }
}

// Accumulate acc[i][g*4+jj] += sum_c A[ty*4+i][c] * B[c][g*64 + tx*4 + jj]
// over the 64 columns of A (pitch AP) and rows of B (pitch BP).
template <int OG, int AP, int BP>
__device__ __forceinline__ void tile_times_rows(float (&acc)[4][4 * OG], const float* A,
                                                const float* B, int tx, int ty) {
#pragma unroll 2
  for (int c4 = 0; c4 < 64; c4 += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(&A[(ty * 4 + i) * AP + c4]);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
      for (int g = 0; g < OG; ++g) {
        const float4 b = ld4(&B[(c4 + cc) * BP + g * 64 + tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = lane(a[i], cc);
          acc[i][g * 4 + 0] = fmaf(p, b.x, acc[i][g * 4 + 0]);
          acc[i][g * 4 + 1] = fmaf(p, b.y, acc[i][g * 4 + 1]);
          acc[i][g * 4 + 2] = fmaf(p, b.z, acc[i][g * 4 + 2]);
          acc[i][g * 4 + 3] = fmaf(p, b.w, acc[i][g * 4 + 3]);
        }
      }
    }
  }
}

// s[i][j] = A[ty*4+i] . B[tx+16j] and t[i][j] = C[ty*4+i] . E[tx+16j]
// over DMAX features (all four tiles of pitch DP).
template <int DMAX>
__device__ __forceinline__ void two_score_tiles(float (&s)[4][4], float (&t)[4][4], const float* A,
                                                const float* B, const float* C, const float* E,
                                                int tx, int ty) {
  constexpr int DP = DMAX + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < DMAX; d += 4) {
    float4 a[4], b[4], c[4], e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = ld4(&A[(ty * 4 + i) * DP + d]);
      c[i] = ld4(&C[(ty * 4 + i) * DP + d]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = ld4(&B[(tx + 16 * j) * DP + d]);
      e[j] = ld4(&E[(tx + 16 * j) * DP + d]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        fma4(s[i][j], a[i], b[j]);
        fma4(t[i][j], c[i], e[j]);
      }
  }
}

template <int DMAX>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V tiles [64][DMAX + 4], dS tile [64][64 + 4], lse and D rows
  return sizeof(float) * (4 * 64 * (DMAX + 4) + 64 * 68 + 2 * 64);
}

template <int DMAX>
constexpr size_t dkdv_smem_bytes() {
  // K, V, Q, dO tiles [64][DMAX + 4], P^T and dS^T tiles [64][64 + 4], lse and D rows
  return sizeof(float) * (4 * 64 * (DMAX + 4) + 2 * 64 * 68 + 2 * 64);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, T* __restrict__ dq, float* __restrict__ delta,
                    int T_len, int D, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  constexpr int DP = DMAX + 4;
  constexpr int PP = BK + 4;
  constexpr int OG = DMAX / 64;
  float* Qs = smem;              // [BQ][DP]
  float* dOs = Qs + BQ * DP;     // [BQ][DP]
  float* Ks = dOs + BQ * DP;     // [BK][DP]
  float* Vs = Ks + BK * DP;      // [BK][DP]
  float* dSs = Vs + BK * DP;     // [BQ][PP]
  float* Ls = dSs + BQ * PP;     // [BQ] row lse, log2 units
  float* Ds = Ls + BQ;           // [BQ] row D

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)bh * T_len * D;
  const float scale_log2 = scale * LOG2E;

  stage<T, DMAX>(Qs, q, base, q0, T_len, D);
  stage<T, DMAX>(dOs, dout, base, q0, T_len, D);
  __syncthreads();

  // D of rows ty*4+i; the 16 threads of a row are 16 lanes of one warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, gr = q0 + r;
    float acc = 0.f;
    if (gr < T_len)
      for (int d = tx; d < D; d += 16)
        acc = fmaf(dOs[r * DP + d], to_float(o[base + (size_t)gr * D + d]), acc);
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) acc += __shfl_xor_sync(FULL, acc, off);
    if (tx == 0) {
      Ds[r] = acc;
      Ls[r] = gr < T_len ? lse[(size_t)bh * T_len + gr] * LOG2E : 0.f;
      if (gr < T_len) delta[(size_t)bh * T_len + gr] = acc;
    }
  }

  float acc[4][4 * OG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * OG; ++c) acc[i][c] = 0.f;

  const int k_end = causal ? min(T_len, q0 + BQ) : T_len;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tiles are consumed; Ls and Ds are written
    stage<T, DMAX>(Ks, k, base, k0, T_len, D);
    stage<T, DMAX>(Vs, v, base, k0, T_len, D);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_score_tiles<DMAX>(s, dp, Qs, Ks, dOs, Vs, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, qr = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx + 16 * j;
        const bool valid = qr < T_len && kc < T_len && (!causal || kc <= qr);
        const float p = valid ? exp2f(s[i][j] * scale_log2 - Ls[r]) : 0.f;
        dSs[r * PP + tx + 16 * j] = p * (dp[i][j] - Ds[r]);
      }
    }
    __syncthreads();  // dS is complete
    tile_times_rows<OG, PP, DP>(acc, dSs, Ks, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    if (qr >= T_len) continue;
#pragma unroll
    for (int g = 0; g < OG; ++g)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int d = g * 64 + tx * 4 + jj;
        if (d < D) dq[base + (size_t)qr * D + d] = from_float<T>(acc[i][g * 4 + jj] * scale);
      }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int T_len, int D, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  constexpr int DP = DMAX + 4;
  constexpr int PP = BQ + 4;
  constexpr int OG = DMAX / 64;
  float* Ks = smem;              // [BK][DP]
  float* Vs = Ks + BK * DP;      // [BK][DP]
  float* Qs = Vs + BK * DP;      // [BQ][DP]
  float* dOs = Qs + BQ * DP;     // [BQ][DP]
  float* Ps = dOs + BQ * DP;     // [BK][PP]  P^T
  float* dSs = Ps + BK * PP;     // [BK][PP]  dS^T
  float* Ls = dSs + BK * PP;     // [BQ] row lse of the query tile, log2 units
  float* Ds = Ls + BQ;           // [BQ] row D of the query tile

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const size_t base = (size_t)bh * T_len * D;
  const float scale_log2 = scale * LOG2E;

  stage<T, DMAX>(Ks, k, base, k0, T_len, D);
  stage<T, DMAX>(Vs, v, base, k0, T_len, D);

  float dk_acc[4][4 * OG], dv_acc[4][4 * OG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * OG; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // causal: query tiles wholly above this key tile see none of its keys
  for (int q0 = causal ? k0 : 0; q0 < T_len; q0 += BQ) {
    __syncthreads();  // the previous tiles are consumed (and K, V are staged)
    stage<T, DMAX>(Qs, q, base, q0, T_len, D);
    stage<T, DMAX>(dOs, dout, base, q0, T_len, D);
    if (threadIdx.x < BQ) {
      const int gr = q0 + threadIdx.x;
      Ls[threadIdx.x] = gr < T_len ? lse[(size_t)bh * T_len + gr] * LOG2E : 0.f;
      Ds[threadIdx.x] = gr < T_len ? delta[(size_t)bh * T_len + gr] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T: rows are keys ty*4+i, columns queries tx+16j
    float s[4][4], dp[4][4];
    two_score_tiles<DMAX>(s, dp, Ks, Qs, Vs, dOs, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, kc = k0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, qr = q0 + c;
        const bool valid = qr < T_len && kc < T_len && (!causal || kc <= qr);
        const float p = valid ? exp2f(s[i][j] * scale_log2 - Ls[c]) : 0.f;
        Ps[r * PP + c] = p;
        dSs[r * PP + c] = p * (dp[i][j] - Ds[c]);
      }
    }
    __syncthreads();  // P^T and dS^T are complete
    tile_times_rows<OG, PP, DP>(dv_acc, Ps, dOs, tx, ty);
    tile_times_rows<OG, PP, DP>(dk_acc, dSs, Qs, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty * 4 + i;
    if (kr >= T_len) continue;
#pragma unroll
    for (int g = 0; g < OG; ++g)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int d = g * 64 + tx * 4 + jj;
        if (d < D) {
          dk[base + (size_t)kr * D + d] = from_float<T>(dk_acc[i][g * 4 + jj] * scale);
          dv[base + (size_t)kr * D + d] = from_float<T>(dv_acc[i][g * 4 + jj]);
        }
      }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, void* dq, void* dk, void* dv, float* delta, int BH,
                   int T_len, int D, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem_dq = dq_smem_bytes<DMAX>();
  constexpr size_t smem_dkdv = dkdv_smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkdv);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  dim3 grid_q((T_len + BQ - 1) / BQ, BH);
  flash_bwd_dq_kernel<T, DMAX><<<grid_q, THREADS, smem_dq, stream>>>(
      qt, kt, vt, static_cast<const T*>(o), dot, lse, static_cast<T*>(dq), delta, T_len, D, scale,
      causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // same stream: reads the D that the first kernel wrote
  dim3 grid_k((T_len + BK - 1) / BK, BH);
  flash_bwd_dkdv_kernel<T, DMAX><<<grid_k, THREADS, smem_dkdv, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), T_len, D, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, void* dq, void* dk, void* dv,
                       float* delta, int BH, int T_len, int D, float scale, int causal,
                       cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, dout, lse, dq, dk, dv, delta, BH, T_len, D, scale, causal,
                         stream);
  return launch<T, 128>(q, k, v, o, dout, lse, dq, dk, dv, delta, BH, T_len, D, scale, causal,
                        stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv); lse and
// delta are (BH, T) float32, delta is scratch the call fills.  Returns the
// CUDA error of the launches (cudaSuccess = 0); the caller raises on
// anything else.
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, void* dq, void* dk, void* dv,
                         float* delta, int BH, int T_len, int D, float scale, int causal, int dtype,
                         void* stream) {
  if (BH <= 0 || BH > 65535 || T_len <= 0 || D <= 0 || D > 128 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0
      ? dispatch_d<float>(q, k, v, o, dout, lse, dq, dk, dv, delta, BH, T_len, D, scale, causal, s)
      : dispatch_d<__nv_bfloat16>(q, k, v, o, dout, lse, dq, dk, dv, delta, BH, T_len, D, scale,
                                  causal, s);
  return (int)err;
}

extern "C" const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
