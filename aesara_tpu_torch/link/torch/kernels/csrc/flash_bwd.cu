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
// What bounds it on the H100: the two kernels take 7 products of
// T x T x D per panel (S and dP in both, dS K in the first, dS^T Q and
// P^T dO in the second): 7 * 2*BH*T*T*D = 120 GFLOP at the flagship shape
// (BH=128, T=1024, D=64) against a few hundred MB of traffic, so the
// tensor cores bound it.  Every product runs on them through Ampere-class
// `mma.sync`:
//   - fp32 inputs: m16n8k8 TF32 in 3xTF32, so fp32 stays close to fp32:
//     each operand x is split into hi = rna_tf32(x) and
//     lo = rna_tf32(x - hi), and acc += a_lo*b_hi + a_hi*b_lo + a_hi*b_hi
//     (the small terms first; a_lo*b_lo is below fp32's rounding).  Three
//     TF32 products per fp32 one: 361 GFLOP of TF32 at the flagship shape,
//     0.73 ms at 495 TFLOP/s.
//   - bf16 inputs: m16n8k16 bf16, one product, fp32 accumulation; P and dS
//     are rounded to bf16 for the second product, as the operands are.
// The split is what else the fp32 path pays for: it is issued by the same
// warps as the mma.sync.  It is four instructions, and the walked tiles (the
// B operands: K and V in the dq kernel, Q and dO in the dkdv kernel) are
// split once a block as they are staged; the owned tiles (the A operands, 16
// rows a warp) and the register-held P and dS are split as they are loaded:
// each value is read by one warp only.  The staging, the fragments, the
// split and the walked buffers are K2's too, in flash_mma.cuh (its header
// says how they work); chip_smoke.py times the kernels, PERF.md has the
// numbers.
// wgmma with TMA would take both the staging and the operand reads off the
// issuing warps; that is later work (ROADMAP.md).
//
// Design.  The TPU kernels carried their accumulators across a sequential
// grid axis in VMEM scratch; here each accumulation is a loop inside one
// block, with the accumulator in registers, and no atomics, so two calls
// give the same bits:
//   - dq kernel: one block of 4 warps per (bh, 64 query rows); each warp
//     owns 16 of the rows.  It stages the Q and dO rows, computes D for
//     them (and writes it out for the second kernel), then walks the keys
//     in tiles of WALK rows: S and dP (16 x WALK a warp), then P and dS in
//     registers, then dQ += dS K.
//   - dkdv kernel: one block of 4 warps per (bh, 64 key rows), launched
//     after the first on the same stream; each warp owns 16 key rows.  It
//     stages its K and V rows and walks the queries in tiles of WALK rows:
//     S^T and dP^T, then P^T and dS^T in registers, dV += P^T dO and
//     dK += dS^T Q.
// P and dS never leave the registers: they are the A fragment of the second
// product (flash_mma.cuh).  The next walked tile arrives by 16-byte cp.async
// (4-byte for the lse and D rows) into a landing buffer while the warps
// compute on the current one.  fp32: one barrier, the landing tile is split
// into the planes, and a second barrier: two barriers a tile.  bf16: the
// products read the landing tile itself, with two landing buffers taken in
// turn, so one barrier a tile.  flash_attention_grads pads panels whose rows
// are not 16-byte multiples, or not 16-byte aligned, with zero columns,
// which change no product.
// Walked tiles of 16 rows keep the shared memory small: at D = 64, fp32,
// 61 KB a block, so three blocks (12 warps) an SM, registers capped to
// fit them; chip_smoke.py logs each kernel's registers and resident blocks
// through flash_bwd_kernel_info.  The products loop over all DMAX columns
// (zero past D) with no test on D inside: a test there cut the unrolled
// steps into separate blocks of code that ptxas could not overlap.
//
// Units: K2 writes the lse in natural log.  The kernels take P as
// exp2(S * scale * log2(e) - lse * log2(e)), which is exp(S * scale - lse),
// so dS, dQ and dK come out in natural units with no log2(e) to undo.
//
// Causal: key tiles wholly above the diagonal are skipped (the dq loop
// stops at the diagonal, the dkdv loop starts there).  Ragged T and D are
// masked: staged tiles are zero-filled and entries outside T or above the
// diagonal take P = 0.  D <= 128 (variants for D <= 64 and D <= 128).
// Inputs must be contiguous (BH, T, D), fp32 or bf16, all of one dtype,
// with D a multiple of 16 bytes and q, k, v, dout 16-byte aligned.

#include "flash_mma.cuh"

namespace {

constexpr int WALK = 16;            // rows of a walked tile: keys (dq), queries (dkdv)

// resident blocks an SM asked of ptxas: three at D <= 64 (61 KB of shared
// memory a block in fp32, so registers are the limit), one above
template <int DMAX>
__host__ __device__ constexpr int min_blocks() { return DMAX <= 64 ? 3 : 1; }

// write the warp's 16 x D block of an accumulator (rows from r0) times mul
template <typename T, int DMAX>
__device__ __forceinline__ void store_rows(T* __restrict__ out, const float (&acc)[DMAX / 8][4],
                                           int r0, int T_len, int D, float mul, int g, int t) {
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e >> 1), d = n * 8 + 2 * t + (e & 1);
      if (r < T_len && d < D) out[(size_t)r * D + d] = from_float<T>(acc[n][e] * mul);
    }
}

// two owned tiles and the walked operands' buffers
template <typename T, int DMAX>
constexpr size_t tiles_bytes() {
  return sizeof(T) * pitch<T, DMAX>() * 2 * OWN + Walked<T, DMAX, WALK>::BYTES;
}

template <typename T, int DMAX>
constexpr size_t dq_smem_bytes() { return tiles_bytes<T, DMAX>(); }

template <typename T, int DMAX>
constexpr size_t dkdv_smem_bytes() {
  return tiles_bytes<T, DMAX>() + sizeof(float) * 4 * WALK;   // two buffers of the lse, D rows
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS, min_blocks<DMAX>())
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, T* __restrict__ dq, float* __restrict__ delta,
                    int T_len, int D, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int P = pitch<T, DMAX>();
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [OWN][P]
  T* dOs = Qs + OWN * P;                    // [OWN][P]
  const Walked<T, DMAX, WALK> kv(reinterpret_cast<unsigned char*>(dOs + OWN * P));   // K, V

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * OWN, w0 = warp * 16;
  const size_t base = (size_t)bh * T_len * D;
  const float scale_log2 = scale * LOG2E;
  const int n_tiles = ((causal ? min(T_len, q0 + OWN) : T_len) + WALK - 1) / WALK;

  stage_tile<T, DMAX, OWN>(Qs, q + base, q0, T_len, D);
  stage_tile<T, DMAX, OWN>(dOs, dout + base, q0, T_len, D);
  stage_tile<T, DMAX, WALK>(kv.landing(0, 0), k + base, 0, T_len, D);
  stage_tile<T, DMAX, WALK>(kv.landing(0, 1), v + base, 0, T_len, D);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  kv.prepare();

  // D and the lse (log2 units) of the thread's rows w0 + g and w0 + g + 8
  float Dr[2] = {0.f, 0.f}, Lr[2];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int gr = q0 + w0 + r;
    float acc = 0.f;
    if (gr < T_len)
      for (int d = lane; d < D; d += 32)
        acc = fmaf(to_float(dOs[(w0 + r) * P + d]), to_float(o[base + (size_t)gr * D + d]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(FULL, acc, off);
    if (r == g) Dr[0] = acc;
    if (r == g + 8) Dr[1] = acc;
    if (lane == 0 && gr < T_len) delta[(size_t)bh * T_len + gr] = acc;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = q0 + w0 + g + 8 * h;
    Lr[h] = gr < T_len ? lse[(size_t)bh * T_len + gr] * LOG2E : 0.f;
  }
  __syncthreads();   // tile 0 is split (fp32)

  float acc[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const bool next = kt + 1 < n_tiles;
    if (next) {   // lands while this tile is computed
      stage_tile<T, DMAX, WALK>(kv.landing(kt + 1, 0), k + base, (kt + 1) * WALK, T_len, D);
      stage_tile<T, DMAX, WALK>(kv.landing(kt + 1, 1), v + base, (kt + 1) * WALK, T_len, D);
      cp_async_commit();
    }
    const Prep<T>* Kp = kv.read(kt, 0);
    const Prep<T>* Vp = kv.read(kt, 1);

    float s[WALK / 8][4], dp[WALK / 8][4];
#pragma unroll
    for (int n = 0; n < WALK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_rows_rows<T, DMAX, WALK>(s, Qs + w0 * P, Kp, g, t);
    mma_rows_rows<T, DMAX, WALK>(dp, dOs + w0 * P, Vp, g, t);

    const int k0 = kt * WALK;
#pragma unroll
    for (int n = 0; n < WALK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, qr = q0 + w0 + g + 8 * h, kc = k0 + n * 8 + 2 * t + (e & 1);
        const bool valid = qr < T_len && kc < T_len && (!causal || kc <= qr);
        const float p = valid ? exp2f(fmaf(s[n][e], scale_log2, -Lr[h])) : 0.f;
        s[n][e] = p * (dp[n][e] - Dr[h]);   // dS
      }
    mma_regs_rows<T, DMAX, WALK>(acc, s, Kp, g, t);

    if (next) kv.next();
  }

  store_rows<T, DMAX>(dq + base, acc, q0 + w0, T_len, D, scale, g, t);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS, min_blocks<DMAX>())
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int T_len, int D, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int P = pitch<T, DMAX>();
  T* Ks = reinterpret_cast<T*>(smem_raw);   // [OWN][P]
  T* Vs = Ks + OWN * P;                     // [OWN][P]
  unsigned char* walked = reinterpret_cast<unsigned char*>(Vs + OWN * P);
  const Walked<T, DMAX, WALK> qdo(walked);                                     // Q, dO
  float* Ls = reinterpret_cast<float*>(walked + Walked<T, DMAX, WALK>::BYTES);  // [2][WALK] lse
  float* Ds = Ls + 2 * WALK;                                                   // [2][WALK] D

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, k0 = blockIdx.x * OWN, w0 = warp * 16;
  const size_t base = (size_t)bh * T_len * D;
  const float* lse_row = lse + (size_t)bh * T_len;
  const float* delta_row = delta + (size_t)bh * T_len;
  const float scale_log2 = scale * LOG2E;
  // causal: query tiles wholly above this key tile see none of its keys
  const int qt0 = causal ? k0 / WALK : 0;
  const int n_qt = (T_len + WALK - 1) / WALK;

  // query tile qt into buffer buf (0, 1: the walk's tiles in turn)
  auto stage_queries = [&](int qt, int buf) {
    stage_tile<T, DMAX, WALK>(qdo.landing(buf, 0), q + base, qt * WALK, T_len, D);
    stage_tile<T, DMAX, WALK>(qdo.landing(buf, 1), dout + base, qt * WALK, T_len, D);
    if (threadIdx.x < WALK) stage_row(Ls + buf * WALK, lse_row, qt * WALK, T_len, threadIdx.x);
    else if (threadIdx.x < 2 * WALK)
      stage_row(Ds + buf * WALK, delta_row, qt * WALK, T_len, threadIdx.x - WALK);
    cp_async_commit();
  };

  stage_tile<T, DMAX, OWN>(Ks, k + base, k0, T_len, D);
  stage_tile<T, DMAX, OWN>(Vs, v + base, k0, T_len, D);
  stage_queries(qt0, 0);
  cp_async_wait_all();
  __syncthreads();
  if constexpr (Walked<T, DMAX, WALK>::SPLIT) {
    qdo.prepare();
    __syncthreads();
  }

  float dk_acc[DMAX / 8][4], dv_acc[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int buf = (qt - qt0) & 1;
    const bool next = qt + 1 < n_qt;
    if (next) stage_queries(qt + 1, buf ^ 1);   // lands while this tile is computed
    const float* Lb = Ls + buf * WALK;
    const float* Db = Ds + buf * WALK;
    const Prep<T>* Qp = qdo.read(buf, 0);
    const Prep<T>* dOp = qdo.read(buf, 1);

    // S^T and dP^T: rows are the warp's keys, columns the tile's queries
    float s[WALK / 8][4], dp[WALK / 8][4];
#pragma unroll
    for (int n = 0; n < WALK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_rows_rows<T, DMAX, WALK>(s, Ks + w0 * P, Qp, g, t);
    mma_rows_rows<T, DMAX, WALK>(dp, Vs + w0 * P, dOp, g, t);

    const int q0 = qt * WALK;
#pragma unroll
    for (int n = 0; n < WALK / 8; ++n) {
      const int c = n * 8 + 2 * t;
      const float2 l = *reinterpret_cast<const float2*>(Lb + c);
      const float2 dd = *reinterpret_cast<const float2*>(Db + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = k0 + w0 + g + 8 * (e >> 1), qc = q0 + c + (e & 1);
        const bool valid = qc < T_len && kr < T_len && (!causal || kr <= qc);
        const float lc = (e & 1) ? l.y : l.x, dc = (e & 1) ? dd.y : dd.x;
        const float p = valid ? exp2f(fmaf(s[n][e], scale_log2, -lc * LOG2E)) : 0.f;
        s[n][e] = p;                      // P^T
        dp[n][e] = p * (dp[n][e] - dc);   // dS^T
      }
    }
    mma_regs_rows<T, DMAX, WALK>(dv_acc, s, dOp, g, t);
    mma_regs_rows<T, DMAX, WALK>(dk_acc, dp, Qp, g, t);

    if (next) qdo.next();
  }

  store_rows<T, DMAX>(dk + base, dk_acc, k0 + w0, T_len, D, scale, g, t);
  store_rows<T, DMAX>(dv + base, dv_acc, k0 + w0, T_len, D, 1.f, g, t);
}

template <typename T, int DMAX>
cudaError_t set_smem_limits() {
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dq_smem_bytes<T, DMAX>());
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, DMAX>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)dkdv_smem_bytes<T, DMAX>());
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, void* dq, void* dk, void* dv, float* delta, int BH,
                   int T_len, int D, float scale, int causal, cudaStream_t stream) {
  cudaError_t err = set_smem_limits<T, DMAX>();
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const dim3 grid((T_len + OWN - 1) / OWN, BH);
  flash_bwd_dq_kernel<T, DMAX><<<grid, THREADS, dq_smem_bytes<T, DMAX>(), stream>>>(
      qt, kt, vt, static_cast<const T*>(o), dot, lse, static_cast<T*>(dq), delta, T_len, D, scale,
      causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // same stream: reads the D that the first kernel wrote
  flash_bwd_dkdv_kernel<T, DMAX><<<grid, THREADS, dkdv_smem_bytes<T, DMAX>(), stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), T_len, D, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, void* dq, void* dk, void* dv,
                       float* delta, int BH, int T_len, int D, float scale, int causal,
                       cudaStream_t stream) {
  // cp.async staging: every staged row a 16-byte multiple, 16-byte aligned
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (D % (16 / (int)sizeof(T)) != 0 || !aligned(q) || !aligned(k) || !aligned(v) || !aligned(dout))
    return cudaErrorInvalidValue;
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, dout, lse, dq, dk, dv, delta, BH, T_len, D, scale, causal,
                         stream);
  return launch<T, 128>(q, k, v, o, dout, lse, dq, dk, dv, delta, BH, T_len, D, scale, causal,
                        stream);
}

template <typename T, int DMAX>
cudaError_t kernel_info(int which, int* info) {
  cudaError_t err = set_smem_limits<T, DMAX>();
  if (err != cudaSuccess) return err;
  const void* fn = which == 0 ? (const void*)flash_bwd_dq_kernel<T, DMAX>
                              : (const void*)flash_bwd_dkdv_kernel<T, DMAX>;
  const size_t smem = which == 0 ? dq_smem_bytes<T, DMAX>() : dkdv_smem_bytes<T, DMAX>();
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS, smem);
  if (err != cudaSuccess) return err;
  info[0] = THREADS;
  info[1] = (int)smem;
  info[2] = attr.numRegs;
  info[3] = (int)attr.localSizeBytes;
  info[4] = blocks;
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv); lse and
// delta are (BH, T) float32, delta is scratch the call fills.  D * the
// element size must be a multiple of 16 and q, k, v, dout 16-byte aligned
// (cudaErrorInvalidValue otherwise).  Returns the CUDA error of the
// launches (cudaSuccess = 0); the caller raises on anything else.
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

// Resources of one kernel: which 0 = the dq kernel, 1 = the dkdv kernel, of
// the variant for dtype (as above) and dmax (64 or 128).  Fills info with
// threads a block, dynamic shared memory bytes a block, registers a thread,
// local (spill) bytes a thread and resident blocks an SM.
extern "C" int flash_bwd_kernel_info(int dtype, int dmax, int which, int* info) {
  if ((dtype != 0 && dtype != 1) || (dmax != 64 && dmax != 128) || (which != 0 && which != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == 0)
    err = dmax == 64 ? kernel_info<float, 64>(which, info) : kernel_info<float, 128>(which, info);
  else
    err = dmax == 64 ? kernel_info<__nv_bfloat16, 64>(which, info)
                     : kernel_info<__nv_bfloat16, 128>(which, info);
  return (int)err;
}

extern "C" const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
