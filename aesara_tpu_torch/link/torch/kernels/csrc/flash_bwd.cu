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
//   - bf16 and fp16 inputs: m16n8k16 in the input type, fp32 accumulation;
//     P and dS are rounded to bf16 for the second product, as the operands
//     are, or in fp16 taken as two fp16 terms, hi + lo (flash_mma.cuh).
//   - fp64 inputs: m16n8k8 .f64 on the fp64 tensor cores with fp64 sums;
//     P, dS, the lse and D in fp64: 10 * BH*T*T*D = 86 GFLOP of the 5
//     products at the flagship shape, 1.28 ms at 67 TFLOP/s.
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
//   - dq kernel: one block of 4 warps per (bh, 64 query rows), the blocks
//     one grid dimension, (bh, row block) in turn, so any BH whose blocks
//     number under 2^31 launches; each warp owns 16 of the rows.  It stages the Q and dO rows, computes D for
//     them (and writes it out for the second kernel), then walks the keys
//     in tiles of WALK rows: S and dP (16 x WALK a warp), then P and dS in
//     registers, then dQ += dS K.
//   - dkdv kernel: one block of 4 warps per (bh, 64 key rows), launched
//     after the first on the same stream; each warp owns 16 key rows.  It
//     stages its K and V rows and walks the queries in tiles of WALK rows:
//     S^T and dP^T, then P^T and dS^T in registers, dV += P^T dO and
//     dK += dS^T Q.  At D <= 256 dK and dV are 128 registers a thread each,
//     too many for one thread: the kernel runs twice, a pass for dK (S^T,
//     dP^T, dS^T) and a pass for dV (S^T, P^T), each with one accumulator;
//     so does fp64 at D <= 128, whose sums take two registers each.
//   - the D split, for wider heads (over 256, over 128 in fp64): each
//     block owns one chunk of 256 output columns (128 in fp64) of its rows
//     and takes S and dP over the whole of D, chunk by chunk in one order,
//     so every chunk sees the same P and dS; the dq kernel, then a dK pass
//     and a dV pass (the split kernels below).
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
// through flash_bwd_kernel_info.  At D <= 256 in fp32 the two owned tiles
// are 133 KB, so the walked tiles are 8 rows (16 in bf16 and fp16).  The products loop over all DMAX columns
// (zero past D) with no test on D inside: a test there cut the unrolled
// steps into separate blocks of code that ptxas could not overlap.
//
// fp16's dS.  dS is as small as dO, and a gradient's dO is often of 1e-6
// and less: below fp16's normal range (6.1e-5), where its hi + lo terms keep
// few bits.  So in fp16 dS is taken times a power of two c before its split
// and the product's sum times 1/c after it (both exact).  c starts where it
// brings the largest |dO| of the rows that share the sum into [1, 2): in
// the dq kernel a query row's own, which it writes beside D (the rowmax
// half of the delta scratch); in the dkdv kernel the largest over the
// panel's rows.  But dS is dO times V, and a large V takes c dS past
// fp16's 65,504: so each owned row keeps its own c, and where a tile's
// largest |dS| in the row times c would pass DS_CAP (2^14), c is lowered to
// put it in [2^13, 2^14) and the row's sums so far are taken times the
// same power of two (``scale_ds``).
//
// Units: K2 writes the lse in natural log.  The kernels take P as
// exp2(S * scale * log2(e) - lse * log2(e)), which is exp(S * scale - lse),
// so dS, dQ and dK come out in natural units with no log2(e) to undo.
//
// Causal: key tiles wholly above the diagonal are skipped (the dq loop
// stops at the diagonal, the dkdv loop starts there).  Ragged T and D are
// masked: staged tiles are zero-filled and entries outside T or above the
// diagonal take P = 0.  Any D (variants for D <= 64, 128 and 256, fp64 64
// and 128, then the D split).  Inputs must be contiguous (BH, T, D), fp32,
// bf16, fp16 or fp64, all of one dtype, with D a multiple of 16 bytes and
// q, k, v, dout 16-byte aligned.

#include <type_traits>

#include "flash_mma.cuh"

namespace {

// rows of a walked tile: keys (dq), queries (dkdv); 8 for fp32 at D <= 256,
// where the owned tiles take 133 KB
template <typename T, int DMAX>
__host__ __device__ constexpr int walk() { return Mma<T>::SPLIT && DMAX > 128 ? 8 : 16; }

// resident blocks an SM asked of ptxas: three at D <= 64 (61 KB of shared
// memory a block in fp32, so registers are the limit), one above, and one
// for fp64, whose two-register sums want all 255
template <typename T, int DMAX>
__host__ __device__ constexpr int min_blocks() { return sizeof(T) == 8 || DMAX > 64 ? 1 : 3; }

// the dkdv kernel's accumulators: both, or at D <= 256 (fp64: D <= 128) one a pass
enum Part { DK_DV, DK_ONLY, DV_ONLY };

// whether dS is scaled before its split (fp16: see the header)
template <typename T>
__host__ __device__ constexpr bool scales_ds() { return std::is_same<T, __half>::value; }

// 2^k with |x| 2^k in [1, 2), or 1 for 0, inf and NaN
__device__ __forceinline__ float pow2_scale(float x) {
  if (!(x > 0.f) || isinf(x)) return 1.f;
  int e;
  frexpf(x, &e);   // x = f 2^e, f in [0.5, 1)
  return ldexpf(1.f, 1 - e);
}

// fp16: c |dS| stays under this, a quarter of fp16's 65,504
constexpr float DS_CAP = 16384.f;

// fp16: the tile's dS (N columns of 8) times each of the thread's two rows'
// scale c (rows g and g + 8 of the warp's 16, whose sums are acc's entries
// 2h and 2h + 1); first, where c times the row's largest |dS| in the tile
// would pass DS_CAP, c is lowered to put it in [DS_CAP / 2, DS_CAP), and
// the row's sums so far are taken times the same power of two (exact)
template <int N, int M>
__device__ __forceinline__ void scale_ds(float (&ds)[N][4], float (&acc)[M][4], float (&c)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float m = 0.f;
#pragma unroll
    for (int n = 0; n < N; ++n) m = fmaxf(m, fmaxf(fabsf(ds[n][2 * h]), fabsf(ds[n][2 * h + 1])));
    m = fmaxf(m, __shfl_xor_sync(FULL, m, 1));   // over the row's four threads
    m = fmaxf(m, __shfl_xor_sync(FULL, m, 2));
    if (c[h] * m > DS_CAP && !isinf(m)) {
      const float lower = pow2_scale(m) * (DS_CAP / 2);
      const float r = lower / c[h];   // a power of two under 1
#pragma unroll
      for (int n = 0; n < M; ++n) {
        acc[n][2 * h] *= r;
        acc[n][2 * h + 1] *= r;
      }
      c[h] = lower;
    }
#pragma unroll
    for (int n = 0; n < N; ++n) {
      ds[n][2 * h] *= c[h];
      ds[n][2 * h + 1] *= c[h];
    }
  }
}

// write the warp's 16 x D block of an accumulator (rows from r0, ld values
// apart) times mul
template <typename T, int DMAX>
__device__ __forceinline__ void store_rows(T* __restrict__ out, const Acc<T> (&acc)[DMAX / 8][4],
                                           int r0, int T_len, int D, Acc<T> mul, int g, int t, int ld) {
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e >> 1), d = n * 8 + 2 * t + (e & 1);
      if (r < T_len && d < D) out[(size_t)r * ld + d] = from_float<T>(acc[n][e] * mul);
    }
}

template <typename A, int N>
__device__ __forceinline__ void zero(A (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = A(0);
}

// fp16: the sums divided by the rows' dS scales again (powers of two: exact)
template <int N>
__device__ __forceinline__ void unscale(float (&acc)[N][4], const float (&c)[2]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] /= c[e >> 1];
}

// D of the warp's 16 rows from r0 (rowsum(dO * O) over D, read from dO's
// rows in `dout` (ld values apart) and O's in `o`), then (fp16) the rows'
// scales of dS from their largest |dO|: the thread keeps rows g and g + 8's
// in Dr and Cr; lane 0 writes D to delta_row and (fp16) the largest |dO| to
// rowmax_row when `write`
template <typename T>
__device__ __forceinline__ void row_deltas(const T* dout, int ld, const T* __restrict__ o, int r0, int T_len,
                                           int D, Acc<T> (&Dr)[2], float (&Cr)[2], Acc<T>* delta_row,
                                           Acc<T>* rowmax_row, bool write, int lane, int g) {
  using A = Acc<T>;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int gr = r0 + r;
    A acc = A(0);
    float mx = 0.f;
    if (gr < T_len)
      for (int d = lane; d < D; d += 32) {
        const A x = to_float(dout[(size_t)r * ld + d]);
        acc = afma(x, to_float(o[(size_t)gr * D + d]), acc);
        if constexpr (scales_ds<T>()) mx = fmaxf(mx, fabsf(x));
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(FULL, acc, off);
    if (r == g) Dr[0] = acc;
    if (r == g + 8) Dr[1] = acc;
    if (write && lane == 0 && gr < T_len) delta_row[gr] = acc;
    if constexpr (scales_ds<T>()) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      if (r == g) Cr[0] = pow2_scale(mx);
      if (r == g + 8) Cr[1] = pow2_scale(mx);
      if (write && lane == 0 && gr < T_len) rowmax_row[gr] = mx;
    }
  }
}

// dS = P (dP - D) of a walked key tile in the dq kernels: P from S and the
// rows' lse (log2 units), masked past T and (causal) above the diagonal
template <typename A, int WALK>
__device__ __forceinline__ void ds_rows(A (&s)[WALK / 8][4], const A (&dp)[WALK / 8][4], const A (&Dr)[2],
                                        const A (&Lr)[2], A scale_log2, int qr0, int k0, int T_len, bool causal,
                                        int t) {
#pragma unroll
  for (int n = 0; n < WALK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, qr = qr0 + 8 * h, kc = k0 + n * 8 + 2 * t + (e & 1);
      const bool valid = qr < T_len && kc < T_len && (!causal || kc <= qr);
      const A p = valid ? aexp2(afma(s[n][e], scale_log2, -Lr[h])) : A(0);
      s[n][e] = p * (dp[n][e] - Dr[h]);   // dS
    }
}

// P^T and dS^T of a walked query tile in the dkdv kernels: rows are the
// warp's keys from kr0, columns the tile's queries from q0, whose lse and D
// are Lb and Db
template <typename A, int WALK>
__device__ __forceinline__ void p_ds_cols(A (&s)[WALK / 8][4], A (&dp)[WALK / 8][4], const A* Lb, const A* Db,
                                          A scale_log2, int kr0, int q0, int T_len, bool causal, int t) {
#pragma unroll
  for (int n = 0; n < WALK / 8; ++n) {
    const int c = n * 8 + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kr = kr0 + 8 * (e >> 1), qc = q0 + c + (e & 1);
      const bool valid = qc < T_len && kr < T_len && (!causal || kr <= qc);
      const A lc = Lb[c + (e & 1)], dc = Db[c + (e & 1)];
      const A p = valid ? aexp2(afma(s[n][e], scale_log2, -lc * Units<A>::LOG2E)) : A(0);
      s[n][e] = p;                      // P^T
      dp[n][e] = p * (dp[n][e] - dc);   // dS^T
    }
  }
}

// two owned tiles and the walked operands' buffers
template <typename T, int DMAX>
constexpr size_t tiles_bytes() {
  return sizeof(T) * pitch<T, DMAX>() * 2 * OWN + Walked<T, DMAX, walk<T, DMAX>()>::BYTES;
}

template <typename T, int DMAX>
constexpr size_t dq_smem_bytes() { return tiles_bytes<T, DMAX>(); }

template <typename T, int DMAX>
constexpr size_t dkdv_smem_bytes() {
  return tiles_bytes<T, DMAX>() + sizeof(Acc<T>) * 4 * walk<T, DMAX>();   // two buffers of the lse, D rows
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS, min_blocks<T, DMAX>())
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const Acc<T>* __restrict__ lse, T* __restrict__ dq, Acc<T>* __restrict__ delta,
                    int T_len, int D, Acc<T> scale, int causal) {
  using A = Acc<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int P = pitch<T, DMAX>(), WALK = walk<T, DMAX>();
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [OWN][P]
  T* dOs = Qs + OWN * P;                    // [OWN][P]
  const Walked<T, DMAX, WALK> kv(reinterpret_cast<unsigned char*>(dOs + OWN * P));   // K, V

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n_b = (T_len + OWN - 1) / OWN;   // block (bh, row block), a bh's in turn
  const int bh = blockIdx.x / n_b, q0 = blockIdx.x % n_b * OWN, w0 = warp * 16;
  const size_t base = (size_t)bh * T_len * D;
  const A scale_log2 = scale * Units<A>::LOG2E;
  const int n_tiles = ((causal ? min(T_len, q0 + OWN) : T_len) + WALK - 1) / WALK;

  stage_tile<T, DMAX, OWN>(Qs, q + base, q0, T_len, D);
  stage_tile<T, DMAX, OWN>(dOs, dout + base, q0, T_len, D);
  stage_tile<T, DMAX, WALK>(kv.landing(0, 0), k + base, 0, T_len, D);
  stage_tile<T, DMAX, WALK>(kv.landing(0, 1), v + base, 0, T_len, D);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  kv.prepare();

  // D, the lse (log2 units) and (fp16) dS's scale of the thread's rows
  // w0 + g and w0 + g + 8; each row's largest |dO| goes beside D for the
  // dkdv kernel
  A Dr[2] = {A(0), A(0)}, Lr[2];
  float Cr[2] = {1.f, 1.f};
  A* rowmax = delta + (size_t)(gridDim.x / n_b) * T_len;
  row_deltas<T>(dOs + w0 * P, P, o + base, q0 + w0, T_len, D, Dr, Cr, delta + (size_t)bh * T_len,
                rowmax + (size_t)bh * T_len, true, lane, g);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = q0 + w0 + g + 8 * h;
    Lr[h] = gr < T_len ? lse[(size_t)bh * T_len + gr] * Units<A>::LOG2E : A(0);
  }
  __syncthreads();   // tile 0 is split (fp32)

  A acc[DMAX / 8][4];
  zero(acc);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const bool next = kt + 1 < n_tiles;
    if (next) {   // lands while this tile is computed
      stage_tile<T, DMAX, WALK>(kv.landing(kt + 1, 0), k + base, (kt + 1) * WALK, T_len, D);
      stage_tile<T, DMAX, WALK>(kv.landing(kt + 1, 1), v + base, (kt + 1) * WALK, T_len, D);
      cp_async_commit();
    }
    const Prep<T>* Kp = kv.read(kt, 0);
    const Prep<T>* Vp = kv.read(kt, 1);

    A s[WALK / 8][4], dp[WALK / 8][4];
    zero(s);
    zero(dp);
    mma_rows_rows<T, DMAX, WALK>(s, Qs + w0 * P, Kp, g, t);
    mma_rows_rows<T, DMAX, WALK>(dp, dOs + w0 * P, Vp, g, t);

    ds_rows<A, WALK>(s, dp, Dr, Lr, scale_log2, q0 + w0 + g, kt * WALK, T_len, causal, t);
    if constexpr (scales_ds<T>()) scale_ds(s, acc, Cr);
    mma_regs_rows<T, DMAX, WALK>(acc, s, Kp, g, t);

    if (next) kv.next();
  }

  if constexpr (scales_ds<T>()) unscale(acc, Cr);
  store_rows<T, DMAX>(dq + base, acc, q0 + w0, T_len, D, scale, g, t, D);
}

// fp16: dS^T's scale for a block's key rows, from the largest |dO| of the
// panel's rows (the dq kernel's, in rowmax_row)
template <typename A>
__device__ __forceinline__ float panel_ds_scale(const A* rowmax_row, int T_len, int warp, int lane) {
  __shared__ float red[WARPS];
  float m = 0.f;
  for (int i = threadIdx.x; i < T_len; i += THREADS) m = fmaxf(m, rowmax_row[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
  if (lane == 0) red[warp] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < WARPS; ++w) m = fmaxf(m, red[w]);
  return pow2_scale(m);
}

template <typename T, int DMAX, Part PART>
__global__ void __launch_bounds__(THREADS, min_blocks<T, DMAX>())
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const Acc<T>* __restrict__ lse,
                      const Acc<T>* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int T_len, int D, Acc<T> scale, int causal) {
  using A = Acc<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int P = pitch<T, DMAX>(), WALK = walk<T, DMAX>();
  constexpr bool DK = PART != DV_ONLY, DV = PART != DK_ONLY;
  T* Ks = reinterpret_cast<T*>(smem_raw);   // [OWN][P]
  T* Vs = Ks + OWN * P;                     // [OWN][P]
  unsigned char* walked = reinterpret_cast<unsigned char*>(Vs + OWN * P);
  const Walked<T, DMAX, WALK> qdo(walked);                                 // Q, dO
  A* Ls = reinterpret_cast<A*>(walked + Walked<T, DMAX, WALK>::BYTES);     // [2][WALK] lse
  A* Ds = Ls + 2 * WALK;                                                   // [2][WALK] D

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n_b = (T_len + OWN - 1) / OWN;   // block (bh, row block), a bh's in turn
  const int bh = blockIdx.x / n_b, k0 = blockIdx.x % n_b * OWN, w0 = warp * 16;
  const size_t base = (size_t)bh * T_len * D;
  const A* lse_row = lse + (size_t)bh * T_len;
  const A* delta_row = delta + (size_t)bh * T_len;
  // fp16: dS^T's scale for each of the thread's two key rows, from the
  // largest |dO| of the panel's rows (the dq kernel's), lowered by scale_ds
  float ds_scale = 1.f;
  if constexpr (scales_ds<T>() && DK)
    ds_scale = panel_ds_scale(delta + (size_t)(gridDim.x / n_b) * T_len + (size_t)bh * T_len, T_len, warp, lane);
  float Cr[2] = {ds_scale, ds_scale};
  const A scale_log2 = scale * Units<A>::LOG2E;
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
  if constexpr (DK) stage_tile<T, DMAX, OWN>(Vs, v + base, k0, T_len, D);   // dP^T = V dO^T
  stage_queries(qt0, 0);
  cp_async_wait_all();
  __syncthreads();
  if constexpr (Walked<T, DMAX, WALK>::SPLIT) {
    qdo.prepare();
    __syncthreads();
  }

  A dk_acc[DK ? DMAX / 8 : 1][4], dv_acc[DV ? DMAX / 8 : 1][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int buf = (qt - qt0) & 1;
    const bool next = qt + 1 < n_qt;
    if (next) stage_queries(qt + 1, buf ^ 1);   // lands while this tile is computed
    const Prep<T>* Qp = qdo.read(buf, 0);
    const Prep<T>* dOp = qdo.read(buf, 1);

    // S^T and dP^T: rows are the warp's keys, columns the tile's queries
    A s[WALK / 8][4], dp[WALK / 8][4];
    zero(s);
    zero(dp);
    mma_rows_rows<T, DMAX, WALK>(s, Ks + w0 * P, Qp, g, t);
    if constexpr (DK) mma_rows_rows<T, DMAX, WALK>(dp, Vs + w0 * P, dOp, g, t);

    p_ds_cols<A, WALK>(s, dp, Ls + buf * WALK, Ds + buf * WALK, scale_log2, k0 + w0 + g, qt * WALK, T_len,
                       causal, t);
    if constexpr (scales_ds<T>() && DK) scale_ds(dp, dk_acc, Cr);
    if constexpr (DV) mma_regs_rows<T, DMAX, WALK>(dv_acc, s, dOp, g, t);
    if constexpr (DK) mma_regs_rows<T, DMAX, WALK>(dk_acc, dp, Qp, g, t);

    if (next) qdo.next();
  }

  if constexpr (scales_ds<T>() && DK) unscale(dk_acc, Cr);
  if constexpr (DK) store_rows<T, DMAX>(dk + base, dk_acc, k0 + w0, T_len, D, scale, g, t, D);
  if constexpr (DV) store_rows<T, DMAX>(dv + base, dv_acc, k0 + w0, T_len, D, A(1), g, t, D);
}

// ---------------------------------------------------------------------------
// The D split: panels wider than the variants' DMAX (fp32, bf16, fp16: 256;
// fp64: 128).  A block owns (bh, 64 rows, one chunk of DC output columns),
// the chunks of a row block in turn.  For each walked tile it takes S (and
// dP) over the whole of D, staging the owned and walked rows' columns DC at
// a time in one order, so every chunk's block computes the same P and dS,
// then stages the walked operand's chunk c for its product.  D is taken
// from dO and O in device memory over the whole row, in the order of the
// dq kernel above, and written by the chunk-0 blocks.  The dkdv kernel runs
// as two passes, dK then dV.  Nothing is staged ahead: the simple form.
// ---------------------------------------------------------------------------

template <typename T>
constexpr int dmax_of() { return sizeof(T) == 8 ? 128 : 256; }

template <typename T, int DC>
constexpr size_t split_dq_smem_bytes() { return tiles_bytes<T, DC>(); }

template <typename T, int DC>
constexpr size_t split_dkdv_smem_bytes() { return tiles_bytes<T, DC>() + sizeof(Acc<T>) * 2 * walk<T, DC>(); }

template <typename T, int DC>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                          const T* __restrict__ o, const T* __restrict__ dout,
                          const Acc<T>* __restrict__ lse, T* __restrict__ dq, Acc<T>* __restrict__ delta,
                          int T_len, int D, Acc<T> scale, int causal) {
  using A = Acc<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int P = pitch<T, DC>(), WALK = walk<T, DC>();
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [OWN][P]: a chunk of the owned Q rows
  T* dOs = Qs + OWN * P;                    // [OWN][P]: of dO
  const Walked<T, DC, WALK> kv(reinterpret_cast<unsigned char*>(dOs + OWN * P));   // chunks of K, V

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n_c = (D + DC - 1) / DC, n_b = (T_len + OWN - 1) / OWN;
  const int c = blockIdx.x % n_c, rb = blockIdx.x / n_c;
  const int bh = rb / n_b, q0 = rb % n_b * OWN, w0 = warp * 16, c0 = c * DC;
  const size_t base = (size_t)bh * T_len * D;
  const A scale_log2 = scale * Units<A>::LOG2E;
  const int n_tiles = ((causal ? min(T_len, q0 + OWN) : T_len) + WALK - 1) / WALK;

  A Dr[2] = {A(0), A(0)}, Lr[2];
  float Cr[2] = {1.f, 1.f};
  A* rowmax = delta + (size_t)(gridDim.x / (n_b * n_c)) * T_len;
  row_deltas<T>(dout + base + (size_t)(q0 + w0) * D, D, o + base, q0 + w0, T_len, D, Dr, Cr,
                delta + (size_t)bh * T_len, rowmax + (size_t)bh * T_len, c == 0, lane, g);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = q0 + w0 + g + 8 * h;
    Lr[h] = gr < T_len ? lse[(size_t)bh * T_len + gr] * Units<A>::LOG2E : A(0);
  }

  A acc[DC / 8][4];
  zero(acc);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * WALK;
    A s[WALK / 8][4], dp[WALK / 8][4];
    zero(s);
    zero(dp);
    for (int dc = 0; dc < n_c; ++dc) {
      const int d0 = dc * DC, cols = min(DC, D - d0);
      stage_cols<T, DC, OWN>(Qs, q + base + d0, q0, T_len, cols, D);
      stage_cols<T, DC, OWN>(dOs, dout + base + d0, q0, T_len, cols, D);
      stage_cols<T, DC, WALK>(kv.landing(0, 0), k + base + d0, k0, T_len, cols, D);
      stage_cols<T, DC, WALK>(kv.landing(0, 1), v + base + d0, k0, T_len, cols, D);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      kv.prepare();
      if constexpr (Walked<T, DC, WALK>::SPLIT) __syncthreads();
      mma_rows_rows<T, DC, WALK>(s, Qs + w0 * P, kv.read(0, 0), g, t);
      mma_rows_rows<T, DC, WALK>(dp, dOs + w0 * P, kv.read(0, 1), g, t);
      __syncthreads();   // every warp is done with the chunk before the next lands
    }
    // K's chunk c for dQ_c += dS K_c
    stage_cols<T, DC, WALK>(kv.landing(0, 0), k + base + c0, k0, T_len, min(DC, D - c0), D);
    cp_async_commit();
    ds_rows<A, WALK>(s, dp, Dr, Lr, scale_log2, q0 + w0 + g, k0, T_len, causal, t);
    if constexpr (scales_ds<T>()) scale_ds(s, acc, Cr);
    cp_async_wait_all();
    __syncthreads();
    kv.prepare();
    if constexpr (Walked<T, DC, WALK>::SPLIT) __syncthreads();
    mma_regs_rows<T, DC, WALK>(acc, s, kv.read(0, 0), g, t);
    __syncthreads();
  }

  if constexpr (scales_ds<T>()) unscale(acc, Cr);
  store_rows<T, DC>(dq + base + c0, acc, q0 + w0, T_len, min(DC, D - c0), scale, g, t, D);
}

template <typename T, int DC, Part PART>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                            const T* __restrict__ dout, const Acc<T>* __restrict__ lse,
                            const Acc<T>* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                            int T_len, int D, Acc<T> scale, int causal) {
  static_assert(PART != DK_DV, "the D split runs dK and dV as two passes");
  using A = Acc<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int P = pitch<T, DC>(), WALK = walk<T, DC>();
  constexpr bool DK = PART == DK_ONLY;
  T* Ks = reinterpret_cast<T*>(smem_raw);   // [OWN][P]: a chunk of the owned K rows
  T* Vs = Ks + OWN * P;                     // [OWN][P]: of V (dK's pass)
  unsigned char* walked = reinterpret_cast<unsigned char*>(Vs + OWN * P);
  const Walked<T, DC, WALK> qdo(walked);                                // chunks of Q, dO
  A* Ls = reinterpret_cast<A*>(walked + Walked<T, DC, WALK>::BYTES);    // [WALK] lse
  A* Ds = Ls + WALK;                                                    // [WALK] D

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n_c = (D + DC - 1) / DC, n_b = (T_len + OWN - 1) / OWN;
  const int c = blockIdx.x % n_c, rb = blockIdx.x / n_c;
  const int bh = rb / n_b, k0 = rb % n_b * OWN, w0 = warp * 16, c0 = c * DC;
  const size_t base = (size_t)bh * T_len * D;
  const A* lse_row = lse + (size_t)bh * T_len;
  const A* delta_row = delta + (size_t)bh * T_len;
  float ds_scale = 1.f;
  if constexpr (scales_ds<T>() && DK)
    ds_scale = panel_ds_scale(delta + (size_t)(gridDim.x / (n_b * n_c)) * T_len + (size_t)bh * T_len, T_len,
                              warp, lane);
  float Cr[2] = {ds_scale, ds_scale};
  const A scale_log2 = scale * Units<A>::LOG2E;
  const int qt0 = causal ? k0 / WALK : 0;
  const int n_qt = (T_len + WALK - 1) / WALK;

  A acc[DC / 8][4];
  zero(acc);

  for (int qt = qt0; qt < n_qt; ++qt) {
    A s[WALK / 8][4], dp[WALK / 8][4];
    zero(s);
    zero(dp);
    for (int dc = 0; dc < n_c; ++dc) {
      const int d0 = dc * DC, cols = min(DC, D - d0);
      stage_cols<T, DC, OWN>(Ks, k + base + d0, k0, T_len, cols, D);
      stage_cols<T, DC, WALK>(qdo.landing(0, 0), q + base + d0, qt * WALK, T_len, cols, D);
      if constexpr (DK) {
        stage_cols<T, DC, OWN>(Vs, v + base + d0, k0, T_len, cols, D);
        stage_cols<T, DC, WALK>(qdo.landing(0, 1), dout + base + d0, qt * WALK, T_len, cols, D);
      }
      if (dc == 0) {
        if (threadIdx.x < WALK) stage_row(Ls, lse_row, qt * WALK, T_len, threadIdx.x);
        else if (threadIdx.x < 2 * WALK) stage_row(Ds, delta_row, qt * WALK, T_len, threadIdx.x - WALK);
      }
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      qdo.prepare();
      if constexpr (Walked<T, DC, WALK>::SPLIT) __syncthreads();
      mma_rows_rows<T, DC, WALK>(s, Ks + w0 * P, qdo.read(0, 0), g, t);
      if constexpr (DK) mma_rows_rows<T, DC, WALK>(dp, Vs + w0 * P, qdo.read(0, 1), g, t);
      __syncthreads();
    }
    // the walked operand's chunk c: Q's for dK_c += dS^T Q_c, dO's for dV_c += P^T dO_c
    stage_cols<T, DC, WALK>(qdo.landing(0, DK ? 0 : 1), (DK ? q : dout) + base + c0, qt * WALK, T_len,
                            min(DC, D - c0), D);
    cp_async_commit();
    p_ds_cols<A, WALK>(s, dp, Ls, Ds, scale_log2, k0 + w0 + g, qt * WALK, T_len, causal, t);
    if constexpr (scales_ds<T>() && DK) scale_ds(dp, acc, Cr);
    cp_async_wait_all();
    __syncthreads();
    qdo.prepare();
    if constexpr (Walked<T, DC, WALK>::SPLIT) __syncthreads();
    if constexpr (DK) mma_regs_rows<T, DC, WALK>(acc, dp, qdo.read(0, 0), g, t);
    else mma_regs_rows<T, DC, WALK>(acc, s, qdo.read(0, 1), g, t);
    __syncthreads();
  }

  if constexpr (scales_ds<T>() && DK) unscale(acc, Cr);
  store_rows<T, DC>((DK ? dk : dv) + base + c0, acc, k0 + w0, T_len, min(DC, D - c0), DK ? scale : A(1), g, t, D);
}

// the dkdv passes of a variant: one with both accumulators, or at D <= 256
// (fp64: D <= 128) a pass for dK and one for dV
template <typename T, int DMAX>
constexpr bool split_dkdv() { return DMAX > 128 || (sizeof(T) == 8 && DMAX > 64); }

template <typename T, int DMAX>
cudaError_t set_smem_limits() {
  if constexpr (DMAX == 0) {
    constexpr int DC = dmax_of<T>();
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_split_kernel<T, DC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)split_dq_smem_bytes<T, DC>());
    if (err != cudaSuccess) return err;
    const int bytes = (int)split_dkdv_smem_bytes<T, DC>();
    err = cudaFuncSetAttribute(flash_bwd_dkdv_split_kernel<T, DC, DK_ONLY>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(flash_bwd_dkdv_split_kernel<T, DC, DV_ONLY>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  } else {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DMAX>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)dq_smem_bytes<T, DMAX>());
    if (err != cudaSuccess) return err;
    const int bytes = (int)dkdv_smem_bytes<T, DMAX>();
    if constexpr (!split_dkdv<T, DMAX>())
      return cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, DMAX, DK_DV>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, DMAX, DK_ONLY>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, DMAX, DV_ONLY>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, void* dq, void* dk, void* dv, void* delta, int BH,
                   int T_len, int D, double scale, int causal, cudaStream_t stream) {
  using A = Acc<T>;
  cudaError_t err = set_smem_limits<T, DMAX>();
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const A* lset = static_cast<const A*>(lse);
  A* deltat = static_cast<A*>(delta);
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  const A sc = A(scale);
  if constexpr (DMAX == 0) {
    constexpr int DC = dmax_of<T>();
    const int grid = (T_len + OWN - 1) / OWN * BH * ((D + DC - 1) / DC);   // under 2^31: see flash_bwd
    flash_bwd_dq_split_kernel<T, DC><<<grid, THREADS, split_dq_smem_bytes<T, DC>(), stream>>>(
        qt, kt, vt, static_cast<const T*>(o), dot, lset, static_cast<T*>(dq), deltat, T_len, D, sc, causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t bytes = split_dkdv_smem_bytes<T, DC>();
    flash_bwd_dkdv_split_kernel<T, DC, DK_ONLY><<<grid, THREADS, bytes, stream>>>(
        qt, kt, vt, dot, lset, deltat, dkt, dvt, T_len, D, sc, causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    flash_bwd_dkdv_split_kernel<T, DC, DV_ONLY><<<grid, THREADS, bytes, stream>>>(
        qt, kt, vt, dot, lset, deltat, dkt, dvt, T_len, D, sc, causal);
    return cudaGetLastError();
  } else {
    const int grid = (T_len + OWN - 1) / OWN * BH;   // under 2^31: see flash_bwd
    flash_bwd_dq_kernel<T, DMAX><<<grid, THREADS, dq_smem_bytes<T, DMAX>(), stream>>>(
        qt, kt, vt, static_cast<const T*>(o), dot, lset, static_cast<T*>(dq), deltat, T_len, D, sc, causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // same stream: reads the D that the first kernel wrote
    const size_t bytes = dkdv_smem_bytes<T, DMAX>();
    if constexpr (!split_dkdv<T, DMAX>()) {
      flash_bwd_dkdv_kernel<T, DMAX, DK_DV><<<grid, THREADS, bytes, stream>>>(
          qt, kt, vt, dot, lset, deltat, dkt, dvt, T_len, D, sc, causal);
    } else {
      flash_bwd_dkdv_kernel<T, DMAX, DK_ONLY><<<grid, THREADS, bytes, stream>>>(
          qt, kt, vt, dot, lset, deltat, dkt, dvt, T_len, D, sc, causal);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      flash_bwd_dkdv_kernel<T, DMAX, DV_ONLY><<<grid, THREADS, bytes, stream>>>(
          qt, kt, vt, dot, lset, deltat, dkt, dvt, T_len, D, sc, causal);
    }
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const void* lse, void* dq, void* dk, void* dv,
                       void* delta, int BH, int T_len, int D, double scale, int causal,
                       cudaStream_t stream) {
  // cp.async staging: every staged row a 16-byte multiple, 16-byte aligned
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (D % (16 / (int)sizeof(T)) != 0 || !aligned(q) || !aligned(k) || !aligned(v) || !aligned(dout))
    return cudaErrorInvalidValue;
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, dout, lse, dq, dk, dv, delta, BH, T_len, D, scale, causal, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, dout, lse, dq, dk, dv, delta, BH, T_len, D, scale, causal, stream);
  if (D <= dmax_of<T>())
    return launch<T, dmax_of<T>()>(q, k, v, o, dout, lse, dq, dk, dv, delta, BH, T_len, D, scale, causal,
                                   stream);
  return launch<T, 0>(q, k, v, o, dout, lse, dq, dk, dv, delta, BH, T_len, D, scale, causal, stream);
}

template <typename T, int DMAX>
cudaError_t kernel_info(int which, int* info) {
  cudaError_t err = set_smem_limits<T, DMAX>();
  if (err != cudaSuccess) return err;
  // only the variants a launch takes are instantiated
  const void* fn;
  size_t smem;
  int walked;
  if constexpr (DMAX == 0) {
    constexpr int DC = dmax_of<T>();
    fn = which == 0 ? (const void*)flash_bwd_dq_split_kernel<T, DC>
         : which == 1 ? (const void*)flash_bwd_dkdv_split_kernel<T, DC, DK_ONLY>
                      : (const void*)flash_bwd_dkdv_split_kernel<T, DC, DV_ONLY>;
    smem = which == 0 ? split_dq_smem_bytes<T, DC>() : split_dkdv_smem_bytes<T, DC>();
    walked = walk<T, DC>();
  } else {
    fn = (const void*)flash_bwd_dq_kernel<T, DMAX>;
    if constexpr (!split_dkdv<T, DMAX>()) {
      if (which == 2) return cudaErrorInvalidValue;
      if (which == 1) fn = (const void*)flash_bwd_dkdv_kernel<T, DMAX, DK_DV>;
    } else if (which > 0) {
      fn = which == 1 ? (const void*)flash_bwd_dkdv_kernel<T, DMAX, DK_ONLY>
                      : (const void*)flash_bwd_dkdv_kernel<T, DMAX, DV_ONLY>;
    }
    smem = which == 0 ? dq_smem_bytes<T, DMAX>() : dkdv_smem_bytes<T, DMAX>();
    walked = walk<T, DMAX>();
  }
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
  info[5] = walked;
  return cudaSuccess;
}

template <typename T>
cudaError_t info_d(int dmax, int which, int* info) {
  if constexpr (sizeof(T) == 8)
    return dmax == 64 ? kernel_info<T, 64>(which, info) : dmax == 128 ? kernel_info<T, 128>(which, info)
           : dmax == 0 ? kernel_info<T, 0>(which, info) : cudaErrorInvalidValue;
  else
    return dmax == 64 ? kernel_info<T, 64>(which, info) : dmax == 128 ? kernel_info<T, 128>(which, info)
           : dmax == 256 ? kernel_info<T, 256>(which, info) : dmax == 0 ? kernel_info<T, 0>(which, info)
                         : cudaErrorInvalidValue;
}

template <typename T>
long long blocks_of(int BH, int T_len, int D) {
  const int n_c = D <= dmax_of<T>() ? 1 : (D + dmax_of<T>() - 1) / dmax_of<T>();
  return (long long)((T_len + OWN - 1) / OWN) * BH * n_c;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16, 3 = float64 (q, k, v, o,
// dout, dq, dk, dv); lse is (BH, T) and delta (2, BH, T) scratch the call
// fills (D, then in fp16 each row's largest |dO|), both float32, or float64
// for float64.  Any D, D * the element size a multiple of 16 and q, k, v,
// dout 16-byte aligned; the blocks, ceil(T / 64) * BH times the D split's
// chunks, under 2^31 (cudaErrorInvalidValue otherwise).  Returns the CUDA
// error of the launches (cudaSuccess = 0); the caller raises on anything
// else.
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const void* lse, void* dq, void* dk, void* dv,
                         void* delta, int BH, int T_len, int D, double scale, int causal, int dtype,
                         void* stream) {
  if (BH <= 0 || T_len <= 0 || D <= 0 || dtype < 0 || dtype > 3) return (int)cudaErrorInvalidValue;
  const long long blocks = dtype == 3 ? blocks_of<double>(BH, T_len, D) : blocks_of<float>(BH, T_len, D);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? dispatch_d<float>(q, k, v, o, dout, lse, dq, dk, dv, delta, BH, T_len, D, scale, causal, s)
      : dtype == 1 ? dispatch_d<__nv_bfloat16>(q, k, v, o, dout, lse, dq, dk, dv, delta, BH, T_len, D, scale,
                                               causal, s)
      : dtype == 2 ? dispatch_d<__half>(q, k, v, o, dout, lse, dq, dk, dv, delta, BH, T_len, D, scale, causal, s)
      : dispatch_d<double>(q, k, v, o, dout, lse, dq, dk, dv, delta, BH, T_len, D, scale, causal, s);
  return (int)err;
}

// Resources of one kernel: which 0 = the dq kernel, 1 = the dkdv kernel (in
// two passes: its dK pass), 2 = its dV pass, of the variant for dtype (as
// above) and dmax (64, 128, 256 but for float64, or 0 for the D split).
// Fills info with threads a block, dynamic shared memory bytes a block,
// registers a thread, local (spill) bytes a thread, resident blocks an SM
// and rows of a walked tile.
extern "C" int flash_bwd_kernel_info(int dtype, int dmax, int which, int* info) {
  if (dtype < 0 || dtype > 3 || which < 0 || which > 2) return (int)cudaErrorInvalidValue;
  cudaError_t err = dtype == 0 ? info_d<float>(dmax, which, info)
                    : dtype == 1 ? info_d<__nv_bfloat16>(dmax, which, info)
                    : dtype == 2 ? info_d<__half>(dmax, which, info) : info_d<double>(dmax, which, info);
  return (int)err;
}

extern "C" const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
