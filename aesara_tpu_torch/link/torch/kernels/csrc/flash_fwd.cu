// K2: flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel `_flash_forward` / `flash_attention`
// (aesara_tpu/link/jax/pallas_kernels.py:205,370): softmax(Q K^T * scale) V
// over (BH, T, D) panels, causal or not, without writing the (T, T) score
// matrix to device memory; optionally the row logsumexp, (BH, T) fp32 in
// natural log, which K3's recompute reads.
//
// What bounds it on the H100: two products of T x T x D per panel,
// 4*BH*T*T*D = 34 GFLOP at the flagship shape (BH=128, T=1024, D=64)
// against 4*BH*T*D*4 = 134 MB of traffic, so the tensor cores bound it.
// Both products run on them through `mma.sync`, with the fragments, the
// cp.async staging and the walked buffers that K3 uses (flash_mma.cuh):
//   - fp32 inputs: m16n8k8 TF32 in 3xTF32 (hi/lo split, small terms first),
//     so fp32 stays close to fp32: 103 GFLOP of TF32 at the flagship shape,
//     0.21 ms at 495 TFLOP/s.
//   - bf16 and fp16 inputs: m16n8k16 in the input type with fp32 sums; P
//     is rounded to bf16 for P V, as the operands are, or in fp16 taken as
//     two fp16 terms, hi + lo (flash_mma.cuh).  The scores stay fp32: an
//     fp16 panel whose unscaled scores pass 65,504 is right.
// wgmma with TMA would take the staging and the operand reads off the
// issuing warps; that is later work (ROADMAP.md).
//
// Design (FlashAttention-2's forward).  The TPU kernel carried its running
// max, denominator and output across a sequential grid axis in VMEM
// scratch; here one block of 4 warps owns (bh, 64 query rows), each warp 16
// of them, and walks the keys in tiles of WALK rows, a loop inside the
// block, with no atomics, so two calls give the same bits.  The blocks are
// one grid dimension, (bh, row block) in turn, so any BH whose blocks
// number under 2^31 launches (gridDim.y stops at 65,535):
//   - The owned Q rows are split into their A fragments once, before the
//     walk: into registers (fp32 at D <= 64, bf16 and fp16 at D <= 128), or
//     for fp32 at D <= 128 into hi and lo planes in shared memory, which
//     the products read.  At D <= 256 they stay as they landed and each
//     tile reads them again (Q's fragments would take 64 registers, its
//     fp32 planes 133 KB beside the walked tiles).
//   - Each tile: S = Q K^T (16 x WALK a warp, in registers), the online
//     softmax on it, then O += P V with P in registers as the A fragment
//     of the second product (flash_mma.cuh).  The 16 x DMAX accumulator O
//     is rescaled by alpha in registers.
//   - Row g's scores sit on the 4 lanes of one quad, so its max takes two
//     __shfl_xor_sync (1 and 2); the denominator is kept a partial sum per
//     lane and added across the quad once, at the end.
//   - The next K and V tiles land by 16-byte cp.async while the current one
//     is computed; fp32 splits them once a block into hi/lo planes, bf16 and
//     fp16 read them where they landed (two landing buffers in turn).
// At D <= 256 the 16 x 256 fp32 accumulator O is 128 registers a thread:
// one block an SM, walked tiles of 16 rows (fp32: the hi and lo planes of
// 16 K and V rows are 100 KB) or 32 (bf16, fp16).
// Scores are taken in log2 units (scale * log2(e) folded in) so the softmax
// runs on exp2f; a row with nothing valid yet keeps m = -inf and its
// exponents are taken against 0, so every p is 0.
//
// Causal: key tiles wholly above the diagonal are never staged, and the
// blocks with the most tiles are launched first.  Ragged T and D are
// zero-filled by the copies; entries past T or above the diagonal are
// masked only on the tiles that hold any.  A fully masked row gets output
// 0 and lse 0, as the Pallas kernel gives.  The products loop over all DMAX
// columns (zero past D) with no test on D inside.  D <= 256 (variants for
// D <= 64, 128 and 256).  Inputs must be contiguous (BH, T, D), fp32, bf16
// or fp16, all of one dtype, with D a multiple of 16 bytes and q, k, v, o
// 16-byte aligned; flash_attention pads other panels with zero columns.

#include <math.h>

#include "flash_mma.cuh"

// Rows of a walked key tile in the D <= 64 variants (the encoder's): 32 in
// fp32, 64 in bf16, the fastest of 16, 32 and 64 on the H100 by
// `chip_smoke.py --k2-walk-sweep`, which builds each with FLASH_FWD_WALK
// set (PERF.md has the table).  At D <= 128 the walk is 32 rows, at D <= 256
// 16 (fp32) or 32.
#ifdef FLASH_FWD_WALK
constexpr int WALK_F32 = FLASH_FWD_WALK, WALK_BF16 = FLASH_FWD_WALK;
#else
constexpr int WALK_F32 = 32, WALK_BF16 = 64;
#endif

namespace {

constexpr float LN2 = 0.6931471805599453f;

// where the owned rows' A fragments are kept: registers, split hi and lo
// planes in shared memory (fp32), or the rows as they landed
enum QMode { Q_REGS, Q_PLANES, Q_LANDED };

template <typename T, int DMAX>
struct Fwd {
  using M = Mma<T>;
  static constexpr bool SPLIT = M::SPLIT;
  static constexpr int P = pitch<T, DMAX>();
  static constexpr int WALK = DMAX > 128 ? (SPLIT ? 16 : 32) : DMAX > 64 ? 32 : SPLIT ? WALK_F32 : WALK_BF16;
  // Q's A fragments in registers, but fp32 at D <= 128 (128 of them) and
  // every type at D <= 256
  static constexpr QMode QMODE = DMAX > 128 ? Q_LANDED : !SPLIT || DMAX <= 64 ? Q_REGS : Q_PLANES;
  using KV = Walked<T, DMAX, WALK>;
  // Q's shared memory: bf16, fp16 and landed fp32 its own landing tile;
  // fp32 held in registers lands in the walked planes, not yet in use;
  // fp32 in planes: the hi plane over its landing tile, then the lo plane
  static constexpr size_t Q_BYTES = QMODE == Q_PLANES ? 2 * sizeof(float) * OWN * P
                                    : QMODE == Q_REGS && SPLIT ? 0 : sizeof(T) * OWN * P;
  static constexpr size_t SMEM = Q_BYTES + KV::BYTES;
  // resident blocks an SM asked of ptxas (registers); fp32 at D <= 128 is
  // held to one by its shared memory, D <= 256 by its registers
  static constexpr int MIN_BLOCKS = DMAX > 128 ? 1 : !SPLIT ? (DMAX <= 64 ? 4 : 3)
                                    : DMAX > 64 ? 1 : WALK >= 64 ? 2 : 3;
  static_assert(!(SPLIT && QMODE == Q_REGS) || KV::PLANES * WALK >= OWN, "Q lands in the walked planes");
  static_assert(SMEM <= 232448, "a block's shared memory");
  static_assert(WALK % 16 == 0 && WALK <= OWN, "walked tiles of 16, 32 or 64 rows");
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS, Fwd<T, DMAX>::MIN_BLOCKS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int T_len, int D, float scale_log2,
                 int causal) {
  using F = Fwd<T, DMAX>;
  using M = Mma<T>;
  constexpr int P = F::P, WALK = F::WALK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const typename F::KV kv(smem_raw + F::Q_BYTES);   // K, V
  T* Qs = F::SPLIT && F::QMODE == Q_REGS ? reinterpret_cast<T*>(kv.planes) : reinterpret_cast<T*>(smem_raw);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // block (bh, row block), the row blocks of one bh in turn
  const int n_qb = (T_len + OWN - 1) / OWN;
  const int bh = blockIdx.x / n_qb, qb = blockIdx.x % n_qb, w0 = warp * 16;
  const int q0 = (causal ? n_qb - 1 - qb : qb) * OWN;
  const size_t base = (size_t)bh * T_len * D;
  const int n_tiles = ((causal ? min(T_len, q0 + OWN) : T_len) + WALK - 1) / WALK;

  stage_tile<T, DMAX, OWN>(Qs, q + base, q0, T_len, D);
  stage_tile<T, DMAX, WALK>(kv.landing(0, 0), k + base, 0, T_len, D);
  stage_tile<T, DMAX, WALK>(kv.landing(0, 1), v + base, 0, T_len, D);
  cp_async_commit();
  cp_async_wait_all();

  // the owned rows' A fragments
  typename M::A qa[F::QMODE == Q_REGS ? DMAX / M::KS : 1];
  const uint32_t* Qhi = reinterpret_cast<const uint32_t*>(smem_raw) + w0 * P;
  if constexpr (F::QMODE == Q_PLANES) {
    // split the pieces of Q this thread copied: hi over them, lo OWN * P on
    constexpr int E = 4, CPR = DMAX / E;
#pragma unroll
    for (int it = 0; it < OWN * CPR / THREADS; ++it) {
      const int i = it * THREADS + threadIdx.x;
      const int off = (i / CPR) * P + (i % CPR) * E;
      M::prepare(reinterpret_cast<uint32_t*>(smem_raw) + off, OWN * P,
                 reinterpret_cast<const float*>(smem_raw) + off);
    }
  }
  __syncthreads();   // Q and tile 0 have landed
  if constexpr (F::QMODE == Q_REGS) {
#pragma unroll
    for (int j = 0; j < DMAX / M::KS; ++j) qa[j] = M::load_a(Qs + w0 * P, P, j * M::KS, g, t);
    if constexpr (F::SPLIT) __syncthreads();   // every warp holds its Q before tile 0 is split over it
  }
  kv.prepare();
  if constexpr (F::SPLIT) __syncthreads();

  float acc[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // running max (log2 units) and this lane's part of the denominator, rows g and g + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_tiles; ++kt) {
    const bool next = kt + 1 < n_tiles;
    if (next) {   // lands while this tile is computed
      stage_tile<T, DMAX, WALK>(kv.landing(kt + 1, 0), k + base, (kt + 1) * WALK, T_len, D);
      stage_tile<T, DMAX, WALK>(kv.landing(kt + 1, 1), v + base, (kt + 1) * WALK, T_len, D);
      cp_async_commit();
    }
    const Prep<T>* Kp = kv.read(kt, 0);
    const Prep<T>* Vp = kv.read(kt, 1);

    float s[WALK / 8][4];
#pragma unroll
    for (int n = 0; n < WALK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    if constexpr (F::QMODE == Q_REGS)
      mma_a_rows<T, DMAX, WALK>(s, [&](int k0) { return qa[k0 / M::KS]; }, Kp, g, t);
    else if constexpr (F::QMODE == Q_PLANES)
      mma_a_rows<T, DMAX, WALK>(
          s, [&](int k0) { return M::load_a_split(Qhi, P, OWN * P, k0, g, t); }, Kp, g, t);
    else
      mma_rows_rows<T, DMAX, WALK>(s, Qs + w0 * P, Kp, g, t);

    // online softmax; masks only on a tile past T or across the warp's diagonal
    const int k0 = kt * WALK;
    const bool whole = k0 + WALK <= T_len && (!causal || k0 + WALK - 1 <= q0 + w0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < WALK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, kc = k0 + n * 8 + 2 * t + (e & 1), qr = q0 + w0 + g + 8 * h;
        const bool valid = whole || (kc < T_len && (!causal || kc <= qr));
        s[n][e] = valid ? s[n][e] * scale_log2 : -INFINITY;
        mx[h] = fmaxf(mx[h], s[n][e]);
      }
    float mu[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      mu[h] = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = exp2f(m[h] - mu[h]);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int n = 0; n < WALK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - mu[e >> 1]);
        s[n][e] = p;   // P, unnormalised
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    mma_regs_rows<T, DMAX, WALK>(acc, s, Vp, g, t);

    if (next) kv.next();
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(FULL, l[h], 1);
    l[h] += __shfl_xor_sync(FULL, l[h], 2);
    inv[h] = l[h] > 0.f ? 1.f / l[h] : 0.f;
  }
  // D is even, so columns d and d + 1 are both inside or both past it
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + w0 + g + 8 * h, d = n * 8 + 2 * t;
      if (r < T_len && d < D)
        store2(o + base + (size_t)r * D + d, acc[n][2 * h] * inv[h], acc[n][2 * h + 1] * inv[h]);
    }
  if (lse != nullptr && t == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + w0 + g + 8 * h;
      if (r < T_len) lse[(size_t)bh * T_len + r] = l[h] > 0.f ? (m[h] + log2f(l[h])) * LN2 : 0.f;
    }
}

template <typename T, int DMAX>
cudaError_t set_smem_limit() {
  return cudaFuncSetAttribute(flash_fwd_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Fwd<T, DMAX>::SMEM);
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                   int T_len, int D, float scale, int causal, cudaStream_t stream) {
  cudaError_t err = set_smem_limit<T, DMAX>();
  if (err != cudaSuccess) return err;
  const int blocks = (T_len + OWN - 1) / OWN * BH;   // under 2^31: see flash_fwd
  flash_fwd_kernel<T, DMAX><<<blocks, THREADS, Fwd<T, DMAX>::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, T_len, D, scale * LOG2E, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                       int T_len, int D, float scale, int causal, cudaStream_t stream) {
  // cp.async staging: every staged row a 16-byte multiple, 16-byte aligned
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (D % (16 / (int)sizeof(T)) != 0 || !aligned(q) || !aligned(k) || !aligned(v) || !aligned(o))
    return cudaErrorInvalidValue;
  if (D <= 64) return launch<T, 64>(q, k, v, o, lse, BH, T_len, D, scale, causal, stream);
  if (D <= 128) return launch<T, 128>(q, k, v, o, lse, BH, T_len, D, scale, causal, stream);
  return launch<T, 256>(q, k, v, o, lse, BH, T_len, D, scale, causal, stream);
}

template <typename T, int DMAX>
cudaError_t kernel_info(int* info) {
  cudaError_t err = set_smem_limit<T, DMAX>();
  if (err != cudaSuccess) return err;
  const void* fn = (const void*)flash_fwd_kernel<T, DMAX>;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS, Fwd<T, DMAX>::SMEM);
  if (err != cudaSuccess) return err;
  info[0] = THREADS;
  info[1] = (int)Fwd<T, DMAX>::SMEM;
  info[2] = attr.numRegs;
  info[3] = (int)attr.localSizeBytes;
  info[4] = blocks;
  info[5] = Fwd<T, DMAX>::WALK;
  return cudaSuccess;
}

template <typename T>
cudaError_t info_d(int dmax, int* info) {
  return dmax == 64 ? kernel_info<T, 64>(info) : dmax == 128 ? kernel_info<T, 128>(info) : kernel_info<T, 256>(info);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  lse may be null.  D <= 256,
// D * the element size a multiple of 16 and q, k, v, o 16-byte aligned; the
// blocks, ceil(T / 64) * BH, under 2^31 (cudaErrorInvalidValue otherwise).
// Returns the CUDA error of the launch (cudaSuccess = 0); the caller raises
// on anything else.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                         int BH, int T_len, int D, float scale, int causal, int dtype,
                         void* stream) {
  if (BH <= 0 || T_len <= 0 || D <= 0 || D > 256 || dtype < 0 || dtype > 2 ||
      (long long)((T_len + OWN - 1) / OWN) * BH > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch_d<float>(q, k, v, o, lse, BH, T_len, D, scale, causal, s)
                    : dtype == 1 ? dispatch_d<__nv_bfloat16>(q, k, v, o, lse, BH, T_len, D, scale, causal, s)
                    : dispatch_d<__half>(q, k, v, o, lse, BH, T_len, D, scale, causal, s);
  return (int)err;
}

// Resources of the kernel variant for dtype (as above) and dmax (64, 128 or
// 256).  Fills info with threads a block, dynamic shared memory bytes a
// block, registers a thread, local (spill) bytes a thread, resident blocks
// an SM and rows of a walked key tile.
extern "C" int flash_fwd_kernel_info(int dtype, int dmax, int* info) {
  if (dtype < 0 || dtype > 2 || (dmax != 64 && dmax != 128 && dmax != 256)) return (int)cudaErrorInvalidValue;
  cudaError_t err = dtype == 0 ? info_d<float>(dmax, info)
                    : dtype == 1 ? info_d<__nv_bfloat16>(dmax, info) : info_d<__half>(dmax, info);
  return (int)err;
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
