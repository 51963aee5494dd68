// K2: flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel `_flash_forward` / `flash_attention`
// (aesara_tpu/link/jax/pallas_kernels.py:205,370): softmax(Q K^T * scale) V
// over (BH, T, D) panels, causal or not, without writing the (T, T) score
// matrix to device memory; optionally the row logsumexp, (BH, T) in natural
// log (fp32, fp64 for fp64 panels), which K3's recompute reads.
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
//   - fp64 inputs: m16n8k8 .f64 on the fp64 tensor cores, fp64 sums, and
//     the softmax (exp2 in double, scale * log2(e) folded in fp64) and the
//     lse in fp64: 34.4 GFLOP at the flagship shape, 0.51 ms at 67 TFLOP/s.
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
// 16 K and V rows are 100 KB) or 32 (bf16, fp16).  An fp64 sum takes two
// registers, so the fp64 variants stop at D <= 128 (O 128 registers, Q read
// from shared memory, walked tiles of 16 rows).
//
// Wider heads (D over 256, over 128 in fp64) take the D split
// (flash_fwd_split_kernel): a block owns one chunk of 256 output columns
// (128 in fp64) and recomputes S over the whole of D, chunk by chunk in one
// order, so every chunk sees the same P and lse, bit for bit.  It stages
// nothing ahead; it is the simple form, not a fast one.
// Scores are taken in log2 units (scale * log2(e) folded in) so the softmax
// runs on exp2f; a row with nothing valid yet keeps m = -inf and its
// exponents are taken against 0, so every p is 0.
//
// Causal: key tiles wholly above the diagonal are never staged, and the
// blocks with the most tiles are launched first.  Ragged T and D are
// zero-filled by the copies; entries past T or above the diagonal are
// masked only on the tiles that hold any.  A fully masked row gets output
// 0 and lse 0, as the Pallas kernel gives.  The products loop over all DMAX
// columns (zero past D) with no test on D inside.  Any D (variants for
// D <= 64, 128 and 256, fp64 64 and 128, then the D split).  Inputs must be
// contiguous (BH, T, D), fp32, bf16, fp16 or fp64, all of one dtype, with D
// a multiple of 16 bytes and q, k, v, o 16-byte aligned; flash_attention
// pads other panels with zero columns.

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

// where the owned rows' A fragments are kept: registers, split hi and lo
// planes in shared memory (fp32), or the rows as they landed
enum QMode { Q_REGS, Q_PLANES, Q_LANDED };

template <typename T, int DMAX>
struct Fwd {
  using M = Mma<T>;
  static constexpr bool SPLIT = M::SPLIT;
  static constexpr bool F64 = sizeof(T) == 8;
  static constexpr int P = pitch<T, DMAX>();
  static constexpr int WALK = F64 ? (DMAX > 64 ? 16 : 32)
                              : DMAX > 128 ? (SPLIT ? 16 : 32) : DMAX > 64 ? 32 : SPLIT ? WALK_F32 : WALK_BF16;
  // Q's A fragments in registers, but fp32 at D <= 128 (128 of them), fp64
  // at D <= 128 (128 registers) and every type at D <= 256
  static constexpr QMode QMODE = DMAX > 128 || (F64 && DMAX > 64) ? Q_LANDED
                                 : !SPLIT || DMAX <= 64 ? Q_REGS : Q_PLANES;
  using KV = Walked<T, DMAX, WALK>;
  // Q's shared memory: bf16, fp16, fp64 and landed fp32 its own landing tile;
  // fp32 held in registers lands in the walked planes, not yet in use;
  // fp32 in planes: the hi plane over its landing tile, then the lo plane
  static constexpr size_t Q_BYTES = QMODE == Q_PLANES ? 2 * sizeof(float) * OWN * P
                                    : QMODE == Q_REGS && SPLIT ? 0 : sizeof(T) * OWN * P;
  static constexpr size_t SMEM = Q_BYTES + KV::BYTES;
  // resident blocks an SM asked of ptxas (registers); fp32 at D <= 128 is
  // held to one by its shared memory, D <= 256 by its registers, fp64's
  // two-register sums leave ptxas all 255
  static constexpr int MIN_BLOCKS = F64 || DMAX > 128 ? 1 : !SPLIT ? (DMAX <= 64 ? 4 : 3)
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

__device__ __forceinline__ void store2(double* p, double a, double b) {
  *reinterpret_cast<double2*>(p) = make_double2(a, b);
}

// The end of a warp's walk: its 16 rows of O (columns [0, D) of rows ld
// values apart from o) divided by their denominators, and (lse not null)
// their logsumexp in natural log; a fully masked row gets 0 for both.  D is
// even, so columns d and d + 1 are both inside or both past it.
template <typename T, int DMAX>
__device__ __forceinline__ void finish_rows(T* __restrict__ o, Acc<T>* __restrict__ lse,
                                            const Acc<T> (&acc)[DMAX / 8][4], const Acc<T> (&m)[2],
                                            Acc<T> (&l)[2], int r0, int T_len, int D, int ld, int g, int t) {
  using A = Acc<T>;
  A inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(FULL, l[h], 1);
    l[h] += __shfl_xor_sync(FULL, l[h], 2);
    inv[h] = l[h] > A(0) ? A(1) / l[h] : A(0);
  }
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h, d = n * 8 + 2 * t;
      if (r < T_len && d < D)
        store2(o + (size_t)r * ld + d, acc[n][2 * h] * inv[h], acc[n][2 * h + 1] * inv[h]);
    }
  if (lse != nullptr && t == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      if (r < T_len) lse[r] = l[h] > A(0) ? (m[h] + alog2(l[h])) * Units<A>::LN2 : A(0);
    }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS, Fwd<T, DMAX>::MIN_BLOCKS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, Acc<T>* __restrict__ lse, int T_len, int D, Acc<T> scale_log2,
                 int causal) {
  using F = Fwd<T, DMAX>;
  using M = Mma<T>;
  using A = Acc<T>;
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

  A acc[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = A(0);
  // running max (log2 units) and this lane's part of the denominator, rows g and g + 8
  A m[2] = {-INFINITY, -INFINITY}, l[2] = {A(0), A(0)};

  for (int kt = 0; kt < n_tiles; ++kt) {
    const bool next = kt + 1 < n_tiles;
    if (next) {   // lands while this tile is computed
      stage_tile<T, DMAX, WALK>(kv.landing(kt + 1, 0), k + base, (kt + 1) * WALK, T_len, D);
      stage_tile<T, DMAX, WALK>(kv.landing(kt + 1, 1), v + base, (kt + 1) * WALK, T_len, D);
      cp_async_commit();
    }
    const Prep<T>* Kp = kv.read(kt, 0);
    const Prep<T>* Vp = kv.read(kt, 1);

    A s[WALK / 8][4];
#pragma unroll
    for (int n = 0; n < WALK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = A(0);
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
    A alpha[2];
    online_softmax<A, WALK>(s, m, l, alpha, scale_log2, k0, q0 + w0 + g, T_len, causal, whole, t);
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    mma_regs_rows<T, DMAX, WALK>(acc, s, Vp, g, t);

    if (next) kv.next();
  }

  finish_rows<T, DMAX>(o + base, lse == nullptr ? nullptr : lse + (size_t)bh * T_len, acc, m, l,
                       q0 + w0, T_len, D, D, g, t);
}

// The D split: a panel wider than the variants' DMAX (fp32, bf16, fp16:
// 256; fp64: 128).  One block of 4 warps owns (bh, 64 query rows, one chunk
// of DC output columns), the chunks of a row block in turn, then the row
// blocks of a bh.  For each walked key tile it takes S = Q K^T over the
// whole of D, staging Q's and K's columns DC at a time (the chunks in one
// order, so every block of a row block computes the same S, hence the same
// P and lse, bit for bit), then the online softmax, then O_c += P V_c with
// V's chunk c staged beside K's last chunk.  Nothing is staged ahead: each
// chunk waits for its copies.  The chunk-0 block writes the lse.
template <typename T, int DC>
struct FwdSplit {
  static constexpr int P = pitch<T, DC>();
  static constexpr int WALK = Mma<T>::SPLIT || sizeof(T) == 8 ? 16 : 32;
  using KV = Walked<T, DC, WALK>;   // operand 0: a chunk of K; 1: V's chunk c
  static constexpr size_t Q_BYTES = sizeof(T) * OWN * P;
  static constexpr size_t SMEM = Q_BYTES + KV::BYTES;
  static_assert(SMEM <= 232448, "a block's shared memory");
};

template <typename T, int DC>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o, Acc<T>* __restrict__ lse, int T_len, int D, Acc<T> scale_log2,
                       int causal) {
  using F = FwdSplit<T, DC>;
  using A = Acc<T>;
  constexpr int P = F::P, WALK = F::WALK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  const typename F::KV kv(smem_raw + F::Q_BYTES);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n_c = (D + DC - 1) / DC, n_qb = (T_len + OWN - 1) / OWN;
  const int c = blockIdx.x % n_c, rb = blockIdx.x / n_c;
  const int bh = rb / n_qb, qb = rb % n_qb, w0 = warp * 16;
  const int q0 = (causal ? n_qb - 1 - qb : qb) * OWN;
  const size_t base = (size_t)bh * T_len * D;
  const int n_tiles = ((causal ? min(T_len, q0 + OWN) : T_len) + WALK - 1) / WALK;
  const int c0 = c * DC;

  A acc[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = A(0);
  A m[2] = {-INFINITY, -INFINITY}, l[2] = {A(0), A(0)};

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * WALK;
    A s[WALK / 8][4];
#pragma unroll
    for (int n = 0; n < WALK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = A(0);
    for (int dc = 0; dc < n_c; ++dc) {
      const int d0 = dc * DC;
      stage_cols<T, DC, OWN>(Qs, q + base + d0, q0, T_len, min(DC, D - d0), D);
      stage_cols<T, DC, WALK>(kv.landing(0, 0), k + base + d0, k0, T_len, min(DC, D - d0), D);
      if (dc == n_c - 1) stage_cols<T, DC, WALK>(kv.landing(0, 1), v + base + c0, k0, T_len, min(DC, D - c0), D);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      kv.prepare();
      if constexpr (F::KV::SPLIT) __syncthreads();
      mma_rows_rows<T, DC, WALK>(s, Qs + w0 * P, kv.read(0, 0), g, t);
      if (dc + 1 < n_c) __syncthreads();   // every warp is done with the chunk before the next lands
    }
    const bool whole = k0 + WALK <= T_len && (!causal || k0 + WALK - 1 <= q0 + w0);
    A alpha[2];
    online_softmax<A, WALK>(s, m, l, alpha, scale_log2, k0, q0 + w0 + g, T_len, causal, whole, t);
#pragma unroll
    for (int n = 0; n < DC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    mma_regs_rows<T, DC, WALK>(acc, s, kv.read(0, 1), g, t);
    __syncthreads();   // every warp is done with the tile before the next lands
  }

  finish_rows<T, DC>(o + base + c0, lse == nullptr || c != 0 ? nullptr : lse + (size_t)bh * T_len, acc, m, l,
                     q0 + w0, T_len, min(DC, D - c0), D, g, t);
}

// the widest variant of a dtype; wider panels take the D split in chunks of it
template <typename T>
constexpr int dmax_of() { return sizeof(T) == 8 ? 128 : 256; }

// the kernel of variant dmax (64, 128, 256, or 0 for the D split), its
// shared memory and walked rows
template <typename T, int DMAX>
struct Variant {
  static const void* kernel() { return (const void*)flash_fwd_kernel<T, DMAX>; }
  static constexpr size_t SMEM = Fwd<T, DMAX>::SMEM;
  static constexpr int WALK = Fwd<T, DMAX>::WALK;
};
template <typename T>
struct Variant<T, 0> {
  static const void* kernel() { return (const void*)flash_fwd_split_kernel<T, dmax_of<T>()>; }
  static constexpr size_t SMEM = FwdSplit<T, dmax_of<T>()>::SMEM;
  static constexpr int WALK = FwdSplit<T, dmax_of<T>()>::WALK;
};

template <typename T, int DMAX>
cudaError_t set_smem_limit() {
  return cudaFuncSetAttribute(Variant<T, DMAX>::kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Variant<T, DMAX>::SMEM);
}

// the chunks of DC columns a block of the variant owns one of: 1 but for the D split
template <typename T, int DMAX>
int chunks(int D) { return DMAX == 0 ? (D + dmax_of<T>() - 1) / dmax_of<T>() : 1; }

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                   int T_len, int D, double scale, int causal, cudaStream_t stream) {
  using A = Acc<T>;
  cudaError_t err = set_smem_limit<T, DMAX>();
  if (err != cudaSuccess) return err;
  // under 2^31: see flash_fwd
  const int blocks = (T_len + OWN - 1) / OWN * BH * chunks<T, DMAX>(D);
  // fp32 sums: scale as fp32, then times log2(e) in fp32; fp64: both in fp64
  const A scale_log2 = A(scale) * Units<A>::LOG2E;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  if constexpr (DMAX == 0)
    flash_fwd_split_kernel<T, dmax_of<T>()><<<blocks, THREADS, Variant<T, DMAX>::SMEM, stream>>>(
        qt, kt, vt, static_cast<T*>(o), static_cast<A*>(lse), T_len, D, scale_log2, causal);
  else
    flash_fwd_kernel<T, DMAX><<<blocks, THREADS, Variant<T, DMAX>::SMEM, stream>>>(
        qt, kt, vt, static_cast<T*>(o), static_cast<A*>(lse), T_len, D, scale_log2, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                       int T_len, int D, double scale, int causal, cudaStream_t stream) {
  // cp.async staging: every staged row a 16-byte multiple, 16-byte aligned
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (D % (16 / (int)sizeof(T)) != 0 || !aligned(q) || !aligned(k) || !aligned(v) || !aligned(o))
    return cudaErrorInvalidValue;
  if (D <= 64) return launch<T, 64>(q, k, v, o, lse, BH, T_len, D, scale, causal, stream);
  if (D <= 128) return launch<T, 128>(q, k, v, o, lse, BH, T_len, D, scale, causal, stream);
  if (D <= dmax_of<T>()) return launch<T, dmax_of<T>()>(q, k, v, o, lse, BH, T_len, D, scale, causal, stream);
  return launch<T, 0>(q, k, v, o, lse, BH, T_len, D, scale, causal, stream);
}

template <typename T, int DMAX>
cudaError_t kernel_info(int* info) {
  cudaError_t err = set_smem_limit<T, DMAX>();
  if (err != cudaSuccess) return err;
  const void* fn = Variant<T, DMAX>::kernel();
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS, Variant<T, DMAX>::SMEM);
  if (err != cudaSuccess) return err;
  info[0] = THREADS;
  info[1] = (int)Variant<T, DMAX>::SMEM;
  info[2] = attr.numRegs;
  info[3] = (int)attr.localSizeBytes;
  info[4] = blocks;
  info[5] = Variant<T, DMAX>::WALK;
  return cudaSuccess;
}

template <typename T>
cudaError_t info_d(int dmax, int* info) {
  if constexpr (sizeof(T) == 8)
    return dmax == 64 ? kernel_info<T, 64>(info) : dmax == 128 ? kernel_info<T, 128>(info)
           : dmax == 0 ? kernel_info<T, 0>(info) : cudaErrorInvalidValue;
  else
    return dmax == 64 ? kernel_info<T, 64>(info) : dmax == 128 ? kernel_info<T, 128>(info)
           : dmax == 256 ? kernel_info<T, 256>(info) : dmax == 0 ? kernel_info<T, 0>(info)
                         : cudaErrorInvalidValue;
}

template <typename T>
long long blocks_of(int BH, int T_len, int D) {
  const int n_c = D <= dmax_of<T>() ? 1 : (D + dmax_of<T>() - 1) / dmax_of<T>();
  return (long long)((T_len + OWN - 1) / OWN) * BH * n_c;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16, 3 = float64.  lse may be
// null; else (BH, T) of the sums' type: float32, or float64 for float64.  Any
// D, D * the element size a multiple of 16 and q, k, v, o 16-byte aligned;
// the blocks, ceil(T / 64) * BH times the D split's chunks (D over 256, or
// over 128 in float64), under 2^31 (cudaErrorInvalidValue otherwise).
// Returns the CUDA error of the launch (cudaSuccess = 0); the caller raises
// on anything else.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int BH, int T_len, int D, double scale, int causal, int dtype,
                         void* stream) {
  if (BH <= 0 || T_len <= 0 || D <= 0 || dtype < 0 || dtype > 3) return (int)cudaErrorInvalidValue;
  const long long blocks = dtype == 3 ? blocks_of<double>(BH, T_len, D) : blocks_of<float>(BH, T_len, D);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch_d<float>(q, k, v, o, lse, BH, T_len, D, scale, causal, s)
                    : dtype == 1 ? dispatch_d<__nv_bfloat16>(q, k, v, o, lse, BH, T_len, D, scale, causal, s)
                    : dtype == 2 ? dispatch_d<__half>(q, k, v, o, lse, BH, T_len, D, scale, causal, s)
                    : dispatch_d<double>(q, k, v, o, lse, BH, T_len, D, scale, causal, s);
  return (int)err;
}

// Resources of the kernel variant for dtype (as above) and dmax (64, 128,
// 256 but for float64, or 0 for the D split).  Fills info with threads a
// block, dynamic shared memory bytes a block, registers a thread, local
// (spill) bytes a thread, resident blocks an SM and rows of a walked key tile.
extern "C" int flash_fwd_kernel_info(int dtype, int dmax, int* info) {
  if (dtype < 0 || dtype > 3) return (int)cudaErrorInvalidValue;
  cudaError_t err = dtype == 0 ? info_d<float>(dmax, info)
                    : dtype == 1 ? info_d<__nv_bfloat16>(dmax, info)
                    : dtype == 2 ? info_d<__half>(dmax, info) : info_d<double>(dmax, info);
  return (int)err;
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
