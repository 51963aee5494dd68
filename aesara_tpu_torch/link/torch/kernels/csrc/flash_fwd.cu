// K2: flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel `_flash_forward` / `flash_attention`
// (aesara_tpu/link/jax/pallas_kernels.py:205,370): softmax(Q K^T * scale) V
// over (BH, T, D) panels, causal or not, without writing the (T, T) score
// matrix to device memory.
//
// What bounds it on the H100: at the flagship shape (BH=128, T=1024, D=64)
// the work is 4*BH*T*T*D = 34 GFLOP against 4*BH*T*D*4 = 134 MB of traffic,
// so it is compute bound.  This version runs on the CUDA cores in fp32 (no
// tensor cores, so fp32 inputs keep fp32 products): the limit is the fp32
// FMA rate and the shared-memory reads that feed it.  wgmma, TMA and a
// producer/consumer pipeline are later work.
//
// Design: one block of 256 threads (16 x 16) per (bh, tile of BQ=64 query
// rows).  It walks the key/value rows in tiles of BK=64 staged in shared
// memory as fp32, keeping a running row max m and denominator l (online
// softmax) and an fp32 output accumulator in registers.  Each thread owns a
// 4 x 4 block of the score tile (rows ty*4+i, columns tx+16*j) and a 4 x D/16
// block of the output, so every float4 read from shared memory feeds four
// FMAs per owned row or column; row max and row sum are combined across the
// 16 threads of a row with warp shuffles.  Rows are padded by 4 floats so
// the float4 reads of a warp hit distinct banks.  Scores are taken in log2
// units (scale * log2(e) folded in) so the softmax runs on exp2f.
//
// Causal: key tiles wholly above the diagonal are never loaded.  Ragged T
// and D are masked in the kernel (zero-filled in shared memory); D <= 128.
// A fully masked row gets output 0 and lse 0, as the Pallas kernel gives.
// The optional row logsumexp is written as (BH, T) fp32 in natural-log units.
// Inputs must be contiguous (BH, T, D), fp32 or bf16; accumulation is fp32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;  // 16 x 16
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
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

template <int DMAX>
constexpr size_t smem_bytes() {
  // Q and K tiles [64][DMAX + 4], V tile [64][DMAX], P tile [64][64 + 4]
  return sizeof(float) * (2 * BQ * (DMAX + 4) + BK * DMAX + BQ * (BK + 4));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int T_len, int D,
                 float scale_log2, int causal) {
  extern __shared__ __align__(16) float smem[];
  constexpr int DP = DMAX + 4;     // padded row of the Q and K tiles
  constexpr int PP = BK + 4;       // padded row of the P tile
  constexpr int OG = DMAX / 64;    // groups of 64 output features
  float* Qs = smem;                // [BQ][DP]
  float* Ks = Qs + BQ * DP;        // [BK][DP]
  float* Vs = Ks + BK * DP;        // [BK][DMAX]
  float* Ps = Vs + BK * DMAX;      // [BQ][PP]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)bh * T_len * D;

  for (int i = threadIdx.x; i < BQ * DMAX; i += THREADS) {
    const int r = i / DMAX, d = i % DMAX, gr = q0 + r;
    Qs[r * DP + d] = (gr < T_len && d < D) ? to_float(q[base + (size_t)gr * D + d]) : 0.f;
  }

  float m[4], l[4], acc[4][4 * OG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * OG; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? min(T_len, q0 + BQ) : T_len;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and Qs is loaded)
    for (int i = threadIdx.x; i < BK * DMAX; i += THREADS) {
      const int r = i / DMAX, d = i % DMAX, gr = k0 + r;
      const bool in = gr < T_len && d < D;
      const size_t off = base + (size_t)gr * D + d;
      Ks[r * DP + d] = in ? to_float(k[off]) : 0.f;
      Vs[r * DMAX + d] = in ? to_float(v[off]) : 0.f;
    }
    __syncthreads();

    // scores of rows ty*4+i against columns tx+16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DMAX; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = ld4(&Qs[(ty * 4 + i) * DP + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = ld4(&Ks[(tx + 16 * j) * DP + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }

    // online softmax; the 16 threads of a row are 16 lanes of one warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx + 16 * j;
        const bool valid = kc < T_len && (!causal || kc <= qr);
        s[i][j] = valid ? s[i][j] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // a row with nothing valid yet keeps m = -inf: rescale by 1, add 0
      const float alpha = (m_new == -INFINITY) ? 1.f : exp2f(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (s[i][j] == -INFINITY) ? 0.f : exp2f(s[i][j] - m_new);
        Ps[(ty * 4 + i) * PP + tx + 16 * j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) ps += __shfl_xor_sync(FULL, ps, off);
      l[i] = alpha * l[i] + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * OG; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P is complete

    // output rows ty*4+i, features g*64 + tx*4 + jj
#pragma unroll 2
    for (int c4 = 0; c4 < BK; c4 += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ld4(&Ps[(ty * 4 + i) * PP + c4]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int g = 0; g < OG; ++g) {
          const float4 vv = ld4(&Vs[(c4 + cc) * DMAX + g * 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0 ? pr[i].x : cc == 1 ? pr[i].y : cc == 2 ? pr[i].z : pr[i].w;
            acc[i][g * 4 + 0] = fmaf(p, vv.x, acc[i][g * 4 + 0]);
            acc[i][g * 4 + 1] = fmaf(p, vv.y, acc[i][g * 4 + 1]);
            acc[i][g * 4 + 2] = fmaf(p, vv.z, acc[i][g * 4 + 2]);
            acc[i][g * 4 + 3] = fmaf(p, vv.w, acc[i][g * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    if (qr >= T_len) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int g = 0; g < OG; ++g)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int d = g * 64 + tx * 4 + jj;
        if (d < D) o[base + (size_t)qr * D + d] = from_float<T>(acc[i][g * 4 + jj] * inv);
      }
    if (lse != nullptr && tx == 0)
      lse[(size_t)bh * T_len + qr] = l[i] > 0.f ? (m[i] + log2f(l[i])) * LN2 : 0.f;
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                   int T_len, int D, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T_len + BQ - 1) / BQ, BH);
  flash_fwd_kernel<T, DMAX><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, T_len, D, scale * LOG2E, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                       int T_len, int D, float scale, int causal, cudaStream_t stream) {
  if (D <= 64) return launch<T, 64>(q, k, v, o, lse, BH, T_len, D, scale, causal, stream);
  return launch<T, 128>(q, k, v, o, lse, BH, T_len, D, scale, causal, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  lse may be null.  Returns the CUDA
// error of the launch (cudaSuccess = 0); the caller raises on anything else.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                         int BH, int T_len, int D, float scale, int causal, int dtype,
                         void* stream) {
  if (BH <= 0 || T_len <= 0 || D <= 0 || D > 128 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0
      ? dispatch_d<float>(q, k, v, o, lse, BH, T_len, D, scale, causal, s)
      : dispatch_d<__nv_bfloat16>(q, k, v, o, lse, BH, T_len, D, scale, causal, s);
  return (int)err;
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
