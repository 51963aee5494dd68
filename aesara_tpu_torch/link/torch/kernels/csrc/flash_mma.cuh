// The pieces that K2 (flash_fwd.cu) and K3 (flash_bwd.cu) share: cp.async
// staging of (T, D) panel rows into shared memory, the mma.sync fragments
// of fp32 (3xTF32, m16n8k8) and bf16 (m16n8k16) with fp32 sums, the
// walked-tile buffers and the two products of a flash-attention tile.
//
// Both kernels give one block of 4 warps 64 owned rows (each warp 16) and
// walk the other operand's rows in tiles of WALK rows, a loop inside the
// block.  Every tile and plane is stored row-major with a pitch of D+4
// 32-bit words (D+8 bf16): the fragments read a tile along its rows (A,
// and B of S = Q K^T: word 4g + t, distinct for the 32 lanes) and along its
// columns (B of C V in the contraction order below: rows 2t, 2t+1, word
// 8t + g, distinct), so neither read has a bank conflict and no swizzle is
// needed.
//
// The 3xTF32 split.  Each fp32 operand x is split into hi = rna_tf32(x) and
// lo = rna_tf32(x - hi), and acc += a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (the
// small terms first; a_lo*b_lo is below fp32's rounding).  The split is four
// integer and float instructions: adding half a TF32 ulp (0x1000) to the
// bits of x rounds the 19 bits the mma reads to nearest, ties away, which is
// what cvt.rna.tf32.f32 gives, and x - hi subtracts hi with its 13 low bits
// cleared.  The mma ignores those bits, so it sees exactly cvt.rna's hi and
// lo.  cvt.rna.tf32.f32 itself compiles on sm_90 to a longer sequence that
// also guards infinities and NaNs.  A walked tile, read by every warp of the
// block, is split once as it is staged, into a hi and a lo plane.
//
// An accumulator tile (row g or g+8, columns 2t and 2t+1 of each 8) is the
// A fragment of the next product once the contraction index is taken in the
// order (0, 2, 4, 6, 1, 3, 5, 7) within each 8 (TF32), and as it stands for
// bf16's k16 fragment; the B operand of that product is read in the same
// order: rows 2t and 2t+1 of each step.  So P (and K3's dS) never leave the
// registers.
//
// Every staged row is a 16-byte multiple on a 16-byte aligned panel; the
// wrappers pad other panels with zero columns.  Rows past T and columns past
// D are zero-filled through cp.async's src-size operand.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int OWN = 64;             // rows a block owns
constexpr int WARPS = OWN / 16;     // 16 owned rows each
constexpr int THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

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

  // the same A from rows already split into a hi plane s and a lo plane
  // PS values after it
  static __device__ __forceinline__ A load_a_split(const uint32_t* s, int P, int PS, int k0, int g,
                                                   int t) {
    const uint32_t* p = s + g * P + k0 + t;
    return {{p[0], p[8 * P], p[4], p[8 * P + 4]}, {p[PS], p[PS + 8 * P], p[PS + 4], p[PS + 8 * P + 4]}};
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

  // prepare 16 landed bytes: their hi and lo planes (dst may be src: the
  // 16 bytes are read before either plane is written)
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

// The shared-memory buffers of two walked operands of WALK rows (K and V in
// K2 and K3's dq kernel, Q and dO in K3's dkdv kernel).  fp32: tile i lands
// in one buffer per operand, then is split into that operand's hi and lo
// planes, which the products read.  bf16: two buffers per operand; the
// products read tile i where it landed while tile i + 1 lands in the other.
template <typename T, int DMAX, int WALK>
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

// acc (16 x WALK) += A B^T: A the warp's 16 rows, its fragment for columns
// k0.. given by a_of(k0), B the walked tile's prepared rows from sb, both
// contracted over all DMAX columns (zero past D; no test on D inside, so
// the unrolled steps stay one block of code that ptxas can schedule)
// (S = Q K^T, dP = dO V^T and, in K3's dkdv kernel, their transposes).
template <typename T, int DMAX, int WALK, typename AOf>
__device__ __forceinline__ void mma_a_rows(float (&acc)[WALK / 8][4], const AOf& a_of,
                                           const Prep<T>* sb, int g, int t) {
  using M = Mma<T>;
  constexpr int P = pitch<T, DMAX>();
#pragma unroll
  for (int k0 = 0; k0 < DMAX; k0 += M::KS) {
    const typename M::A a = a_of(k0);
#pragma unroll
    for (int n = 0; n < WALK / 8; ++n)
      M::mma(acc[n], a, M::load_b_nk(sb + n * 8 * P, P, WALK * P, k0, g, t));
  }
}

// mma_a_rows with A the warp's 16 landed rows from sa, split as they are read
template <typename T, int DMAX, int WALK>
__device__ __forceinline__ void mma_rows_rows(float (&acc)[WALK / 8][4], const T* sa,
                                              const Prep<T>* sb, int g, int t) {
  mma_a_rows<T, DMAX, WALK>(
      acc, [&](int k0) { return Mma<T>::load_a(sa, pitch<T, DMAX>(), k0, g, t); }, sb, g, t);
}

// acc (16 x DMAX) += C S: C the accumulator tiles (16 x WALK) of P or dS,
// S the walked tile's prepared rows from sb, all DMAX columns (zero past D)
// (O = P V in K2; dQ = dS K, dV = P^T dO, dK = dS^T Q in K3).
template <typename T, int DMAX, int WALK>
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

}  // namespace
