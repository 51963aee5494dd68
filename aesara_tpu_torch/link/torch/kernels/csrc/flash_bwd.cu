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
// warps as the mma.sync.  Two measures keep it small (chip_smoke.py
// times the kernels; PERF.md has the numbers):
//   - The split is done in four integer and float instructions: adding
//     half a TF32 ulp (0x1000) to the bits of x rounds the 19 bits the
//     mma reads to nearest, ties away, which is what cvt.rna.tf32.f32
//     gives, and x - hi subtracts hi with its 13 low bits cleared.  The mma
//     ignores those bits, so it sees exactly cvt.rna's hi and lo.
//     cvt.rna.tf32.f32 itself compiles on sm_90 to a longer sequence
//     that also guards infinities and NaNs.
//   - The walked tiles (the B operands: K and V in the dq kernel, Q and
//     dO in the dkdv kernel) are split once per block as they are staged,
//     into a hi and a lo plane, instead of once per warp as each fragment
//     is loaded: every warp of the block reads the whole walked tile.  The
//     owned tiles (the A operands, 16 rows a warp) and the register-held
//     P and dS are split as they are loaded: each value is read by one
//     warp only.
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
// P and dS never leave the registers: the mma accumulator tile (row g or
// g+8, columns 2t and 2t+1 of each 8) is the A fragment of the second
// product once the contraction index is taken in the order
// (0, 2, 4, 6, 1, 3, 5, 7) within each 8 (TF32), and as it stands for
// bf16's k16 fragment.  The B operand of the second product is read in the
// same order: rows 2t and 2t+1 of each step.
// Staging: the next walked tile arrives by 16-byte cp.async (4-byte for
// the lse and D rows) into a landing buffer while the warps compute on the
// current one; rows past T and columns past D are zero-filled through the
// copy's src-size operand.  fp32: one barrier, the landing tile is split
// into the planes, and a second barrier: two barriers a tile.  bf16: the
// products read the landing tile itself, with two landing buffers taken in
// turn, so one barrier a tile.  Every row is staged so, which needs rows
// of a 16-byte multiple on 16-byte aligned panels; flash_attention_grads
// pads other panels with zero columns, which change no product.
// Banks: every tile and plane is stored row-major with a pitch of D+4
// 32-bit words (D+8 bf16).  Fragments read a tile along its rows (A, and B
// of S = Q K^T: word 4g + t, distinct for the 32 lanes) and along its
// columns (B of dQ = dS K in the order above: rows 2t, 2t+1, word 8t + g,
// distinct), so neither read has a bank conflict and no swizzle is needed.
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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int OWN = 64;             // rows a block owns: queries (dq), keys (dkdv)
constexpr int WALK = 16;            // rows of a walked tile: keys (dq), queries (dkdv)
constexpr int WARPS = OWN / 16;     // 16 owned rows each
constexpr int THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// resident blocks an SM asked of ptxas: three at D <= 64 (61 KB of shared
// memory a block in fp32, so registers are the limit), one above
template <int DMAX>
__host__ __device__ constexpr int min_blocks() { return DMAX <= 64 ? 3 : 1; }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// pitch of a staged row: 16 bytes of pad keeps rows 16-byte aligned and
// the fragment reads free of bank conflicts (see the header)
template <typename T, int DMAX>
__host__ __device__ constexpr int pitch() { return DMAX + 16 / (int)sizeof(T); }

// ---------------------------------------------------------------------------
// cp.async staging
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src, or 16 zero bytes when !in (src is then any valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage rows [r0, r0 + ROWS) of a (T_len, D) panel into dst (pitch
// pitch<T, DMAX>()) by 16-byte cp.async, zero past T_len and D.  The
// panel's rows are 16-byte multiples on a 16-byte aligned pointer.
template <typename T, int DMAX, int ROWS>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ panel, int r0, int T_len,
                                           int D) {
  constexpr int P = pitch<T, DMAX>();
  constexpr int E = 16 / sizeof(T);       // values a copy
  constexpr int CPR = DMAX / E;           // copies a row
#pragma unroll
  for (int it = 0; it < ROWS * CPR / THREADS; ++it) {
    const int i = it * THREADS + threadIdx.x;
    const int r = i / CPR, d = (i % CPR) * E, gr = r0 + r;
    const bool in = gr < T_len && d < D;
    cp_async16(dst + r * P + d, in ? panel + (size_t)gr * D + d : panel, in);
  }
}

// value i of a walked tile's (T_len,) fp32 row from r0 by 4-byte cp.async, zero past T_len
__device__ __forceinline__ void stage_row(float* dst, const float* __restrict__ row, int r0, int T_len,
                                          int i) {
  const bool in = r0 + i < T_len;
  cp_async4(dst + i, in ? row + r0 + i : row, in);
}

// ---------------------------------------------------------------------------
// mma.sync fragments.  Lane = 4g + t.  An accumulator tile (16 x 8, fp32)
// holds c[0], c[1] at row g, columns 2t, 2t+1 and c[2], c[3] at row g+8.
// A walked tile is read as Prep values of the landing tile's shape and
// pitch: fp32 from its hi and lo planes, PS values apart; bf16 from the
// landing tile itself.
// ---------------------------------------------------------------------------

template <typename T> struct Mma;

// x as hi + lo, each as the mma reads a TF32 operand (its 13 low bits
// ignored): hi = rna_tf32(x), lo = rna_tf32(x - hi), as cvt.rna.tf32.f32
// gives them, in four instructions (see the header)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) + 0x1000u;
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u)) + 0x1000u;
}

// fp32 in 3xTF32: m16n8k8.  A fragment: rows g, g+8 x columns t, t+4; B
// fragment: rows (k) t, t+4 x column g.
template <> struct Mma<float> {
  static constexpr int KS = 8;         // depth of one mma
  static constexpr bool SPLIT = true;  // walked tiles read from hi and lo planes
  using Prep = uint32_t;
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };

  // A = s[row][k0 + col] for the 16 rows from s
  static __device__ __forceinline__ A load_a(const float* s, int P, int k0, int g, int t) {
    A a;
    split_tf32(s[g * P + k0 + t], a.hi[0], a.lo[0]);
    split_tf32(s[(g + 8) * P + k0 + t], a.hi[1], a.lo[1]);
    split_tf32(s[g * P + k0 + t + 4], a.hi[2], a.lo[2]);
    split_tf32(s[(g + 8) * P + k0 + t + 4], a.hi[3], a.lo[3]);
    return a;
  }

  // the A fragment of contraction step j (columns 8j..8j+7) from the
  // accumulator tiles c, the columns taken in the order (0,2,4,6,1,3,5,7)
  template <int N>
  static __device__ __forceinline__ A a_from_c(const float (&c)[N][4], int j) {
    A a;
    split_tf32(c[j][0], a.hi[0], a.lo[0]);
    split_tf32(c[j][2], a.hi[1], a.lo[1]);
    split_tf32(c[j][1], a.hi[2], a.lo[2]);
    split_tf32(c[j][3], a.hi[3], a.lo[3]);
    return a;
  }

  // B(k, n) = s[n][k0 + k] for the 8 rows n from s
  static __device__ __forceinline__ B load_b_nk(const uint32_t* s, int P, int PS, int k0, int g,
                                                int t) {
    const uint32_t* p = s + g * P + k0 + t;
    return {{p[0], p[4]}, {p[PS], p[PS + 4]}};
  }

  // B(k, n) = s[k][n] over the 8 rows k from s, in the order of a_from_c:
  // fragment row t is row 2t, row t+4 is row 2t+1
  static __device__ __forceinline__ B load_b_kn(const uint32_t* s, int P, int PS, int g, int t) {
    const uint32_t* p = s + 2 * t * P + g;
    return {{p[0], p[P]}, {p[PS], p[PS + P]}};
  }

  // prepare 16 landed bytes: their hi and lo planes
  static __device__ __forceinline__ void prepare(uint32_t* dst, int PS, const float* src) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    uint4 hi, lo;
    split_tf32(x.x, hi.x, lo.x);
    split_tf32(x.y, hi.y, lo.y);
    split_tf32(x.z, hi.z, lo.z);
    split_tf32(x.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(dst) = hi;
    *reinterpret_cast<uint4*>(dst + PS) = lo;
  }

  static __device__ __forceinline__ void mma1(float (&d)[4], const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }

  static __device__ __forceinline__ void mma(float (&d)[4], const A& a, const B& b) {
    mma1(d, a.lo, b.hi);
    mma1(d, a.hi, b.lo);
    mma1(d, a.hi, b.hi);
  }
};

// bf16: m16n8k16.  A fragment: register i holds two adjacent columns,
// (row g, cols 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..); B
// fragment: (rows 2t..2t+1, column g), (rows 2t+8..2t+9, column g).
template <> struct Mma<__nv_bfloat16> {
  using bf16 = __nv_bfloat16;
  static constexpr int KS = 16;
  static constexpr bool SPLIT = false;  // walked tiles read as they landed
  using Prep = bf16;
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };

  static __device__ __forceinline__ uint32_t ld2(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
    return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    return pack(__float2bfloat16(lo), __float2bfloat16(hi));
  }

  static __device__ __forceinline__ A load_a(const bf16* s, int P, int k0, int g, int t) {
    return {{ld2(s + g * P + k0 + 2 * t), ld2(s + (g + 8) * P + k0 + 2 * t),
             ld2(s + g * P + k0 + 2 * t + 8), ld2(s + (g + 8) * P + k0 + 2 * t + 8)}};
  }

  // step j covers columns 16j..16j+15: the accumulator tiles 2j and 2j+1
  template <int N>
  static __device__ __forceinline__ A a_from_c(const float (&c)[N][4], int j) {
    return {{pack(c[2 * j][0], c[2 * j][1]), pack(c[2 * j][2], c[2 * j][3]),
             pack(c[2 * j + 1][0], c[2 * j + 1][1]), pack(c[2 * j + 1][2], c[2 * j + 1][3])}};
  }

  static __device__ __forceinline__ B load_b_nk(const bf16* s, int P, int, int k0, int g, int t) {
    return {{ld2(s + g * P + k0 + 2 * t), ld2(s + g * P + k0 + 2 * t + 8)}};
  }

  static __device__ __forceinline__ B load_b_kn(const bf16* s, int P, int, int g, int t) {
    return {{pack(s[2 * t * P + g], s[(2 * t + 1) * P + g]),
             pack(s[(2 * t + 8) * P + g], s[(2 * t + 9) * P + g])}};
  }

  static __device__ __forceinline__ void mma(float (&d)[4], const A& a, const B& b) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]), "r"(b.r[1]));
  }
};

template <typename T> using Prep = typename Mma<T>::Prep;

// The shared-memory buffers of the two walked operands (K and V in the dq
// kernel, Q and dO in the dkdv kernel).  fp32: tile i lands in one buffer
// per operand, then split into that operand's hi and lo planes, which the
// products read.  bf16: two buffers per operand; the products read tile i
// where it landed while tile i + 1 lands in the other.
template <typename T, int DMAX>
struct Walked {
  static constexpr bool SPLIT = Mma<T>::SPLIT;
  static constexpr int P = pitch<T, DMAX>(), TILE = WALK * P;
  static constexpr int LANDING = SPLIT ? 2 : 4;   // tiles of T: [1 or 2][operand]
  static constexpr int PLANES = SPLIT ? 4 : 0;    // tiles of Prep: [operand][hi, lo]
  static constexpr size_t BYTES = (size_t)TILE * (LANDING * sizeof(T) + PLANES * sizeof(Prep<T>));

  T* land;
  Prep<T>* planes;

  __device__ explicit Walked(unsigned char* base)
      : land(reinterpret_cast<T*>(base)), planes(reinterpret_cast<Prep<T>*>(land + LANDING * TILE)) {}

  // where operand op of tile i lands
  __device__ T* landing(int i, int op) const { return land + ((SPLIT ? 0 : 2 * (i & 1)) + op) * TILE; }

  // where the products read operand op of tile i
  __device__ const Prep<T>* read(int i, int op) const {
    if constexpr (SPLIT) return planes + 2 * op * TILE;
    else return landing(i, op);
  }

  // fp32: split the landed tiles into their planes, each thread the
  // 16-byte pieces it copied in stage_tile
  __device__ void prepare() const {
    if constexpr (SPLIT) {
      constexpr int E = 16 / sizeof(T), CPR = DMAX / E;
#pragma unroll
      for (int op = 0; op < 2; ++op)
#pragma unroll
        for (int it = 0; it < WALK * CPR / THREADS; ++it) {
          const int i = it * THREADS + threadIdx.x;
          const int off = (i / CPR) * P + (i % CPR) * E;
          Mma<T>::prepare(planes + 2 * op * TILE + off, TILE, land + op * TILE + off);
        }
    }
  }

  // after tile i + 1 was staged and tile i computed: wait for the copies,
  // then (fp32) split them; every warp is done with tile i on return
  __device__ void next() const {
    cp_async_wait_all();
    __syncthreads();   // every warp is done with tile i; tile i + 1 has landed
    if constexpr (SPLIT) {
      prepare();
      __syncthreads();
    }
  }
};

// acc (16 x WALK) += A B^T: A the warp's 16 rows from sa, B the walked
// tile's prepared rows from sb, both contracted over all DMAX columns (zero
// past D; no test on D inside, so the unrolled steps stay one block of
// code that ptxas can schedule) (S = Q K^T, dP = dO V^T and, in the dkdv
// kernel, their transposes).
template <typename T, int DMAX>
__device__ __forceinline__ void mma_rows_rows(float (&acc)[WALK / 8][4], const T* sa,
                                              const Prep<T>* sb, int g, int t) {
  using M = Mma<T>;
  constexpr int P = pitch<T, DMAX>();
#pragma unroll
  for (int k0 = 0; k0 < DMAX; k0 += M::KS) {
    const typename M::A a = M::load_a(sa, P, k0, g, t);
#pragma unroll
    for (int n = 0; n < WALK / 8; ++n)
      M::mma(acc[n], a, M::load_b_nk(sb + n * 8 * P, P, WALK * P, k0, g, t));
  }
}

// acc (16 x DMAX) += C S: C the accumulator tiles (16 x WALK) of P or dS,
// S the walked tile's prepared rows from sb, all DMAX columns (zero past D)
// (dQ = dS K, dV = P^T dO, dK = dS^T Q).
template <typename T, int DMAX>
__device__ __forceinline__ void mma_regs_rows(float (&acc)[DMAX / 8][4], const float (&c)[WALK / 8][4],
                                              const Prep<T>* sb, int g, int t) {
  using M = Mma<T>;
  constexpr int P = pitch<T, DMAX>();
#pragma unroll
  for (int j = 0; j < WALK / M::KS; ++j) {
    const typename M::A a = M::a_from_c(c, j);
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n)
      M::mma(acc[n], a, M::load_b_kn(sb + j * M::KS * P + n * 8, P, WALK * P, g, t));
  }
}

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
  return sizeof(T) * pitch<T, DMAX>() * 2 * OWN + Walked<T, DMAX>::BYTES;
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
  const Walked<T, DMAX> kv(reinterpret_cast<unsigned char*>(dOs + OWN * P));   // K, V

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
    mma_rows_rows<T, DMAX>(s, Qs + w0 * P, Kp, g, t);
    mma_rows_rows<T, DMAX>(dp, dOs + w0 * P, Vp, g, t);

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
    mma_regs_rows<T, DMAX>(acc, s, Kp, g, t);

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
  const Walked<T, DMAX> qdo(walked);                                     // Q, dO
  float* Ls = reinterpret_cast<float*>(walked + Walked<T, DMAX>::BYTES);  // [2][WALK] lse of the query tile
  float* Ds = Ls + 2 * WALK;                                             // [2][WALK] D of the query tile

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
  if constexpr (Walked<T, DMAX>::SPLIT) {
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
    mma_rows_rows<T, DMAX>(s, Ks + w0 * P, Qp, g, t);
    mma_rows_rows<T, DMAX>(dp, Vs + w0 * P, dOp, g, t);

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
    mma_regs_rows<T, DMAX>(dv_acc, s, dOp, g, t);
    mma_regs_rows<T, DMAX>(dk_acc, dp, Qp, g, t);

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
