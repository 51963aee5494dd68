// TG, TP, TB and TM: jax.random's gamma, Poisson and binomial loop
// samplers and the MRG31k3p streams on Hopper (sm_90a), plain C interface.
//
// None of them replaces a TPU kernel: the JAX package draws these by
// jax.random under XLA (aesara_tpu/tensor/random/basic.py) and MRG31k3p
// by a lax.scan (aesara_tpu/link/jax/random_dispatch.py:40-137).  TG, TP
// and TB are loops whose trip count depends on the data, so each element
// gets one thread that leaves the loop on its own.  TG's element walks its
// own threefry2x32 key chain in registers.  TP's and TB's rounds draw from
// keys that every element shares: one launch derives them, then two passes
// draw, or one launch does all three for a draw of one block (see "TP and
// TB" below).  TM spreads each stream's steps over threads by jump-ahead
// tables (see "TM" below).  The wrapper and the plain versions are
// kernels/random_loops.py.
//
// What bounds them on the H100: integer work, threefry hashes (75 32-bit
// operations each) and a few transcendentals a round an element; each
// element writes 4 or 8 bytes.  TG hashes three to five times a round; TP
// and TB twice a rejection round and once a Knuth or inversion round, and
// walk back from the batch's last round instead of running every round.
// TM's step is about ten 32-bit operations a value: its bound is the bytes
// it writes.
//
// Rounding follows the plain versions operation for operation: every sum
// and product is rounded on its own (__fadd_rn, __dmul_rn, ..., which nvcc
// does not contract), the products XLA contracts are __fma_rn, and the
// transcendentals are CUDA's, as PyTorch's CUDA ops call them; lgamma is
// XLA's Lanczos form.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Key {
  uint32_t a, b;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

// threefry2x32 of the counter pair (x0, x1) under the key k
__device__ __forceinline__ Key threefry(Key k, uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k.a, k.b, k.a ^ k.b ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return {x0, x1};
}

// split(k, num)[c]
__device__ __forceinline__ Key child(Key k, uint32_t c) { return threefry(k, 0u, c); }

// the hash of flat index i (the counter pair of a draw of the full shape)
__device__ __forceinline__ Key at(Key k, long long i) {
  return threefry(k, (uint32_t)((unsigned long long)i >> 32), (uint32_t)((unsigned long long)i & 0xFFFFFFFFull));
}

template <typename T> struct F;

template <> struct F<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float fma(float a, float b, float c) { return __fmaf_rn(a, b, c); }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
  static __device__ __forceinline__ float log(float a) { return logf(a); }
  static __device__ __forceinline__ float log1p(float a) { return log1pf(a); }
  static __device__ __forceinline__ float pow(float a, float b) { return powf(a, b); }
  static __device__ __forceinline__ float erfinv(float a) { return erfinvf(a); }
  static __device__ __forceinline__ float sin(float a) { return sinf(a); }
  static __device__ __forceinline__ float floor(float a) { return floorf(a); }
  static __device__ __forceinline__ float ceil(float a) { return ceilf(a); }
  // jax.random.uniform's float on [0, 1): the xored words' top 23 bits
  static __device__ __forceinline__ float unit(Key b) {
    return __fsub_rn(__uint_as_float(((b.a ^ b.b) >> 9) | 0x3F800000u), 1.0f);
  }
  static constexpr float NORMAL_LO = -0x1.fffffep-1f;     // nextafter(-1, 0)
  static constexpr float NORMAL_SPAN = 2.0f;            // 1 - NORMAL_LO, rounded
  static constexpr float SQRT2 = 1.41421354f;
};

template <> struct F<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double fma(double a, double b, double c) { return __fma_rn(a, b, c); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
  static __device__ __forceinline__ double log(double a) { return ::log(a); }
  static __device__ __forceinline__ double log1p(double a) { return ::log1p(a); }
  static __device__ __forceinline__ double pow(double a, double b) { return ::pow(a, b); }
  static __device__ __forceinline__ double erfinv(double a) { return ::erfinv(a); }
  static __device__ __forceinline__ double sin(double a) { return ::sin(a); }
  static __device__ __forceinline__ double floor(double a) { return ::floor(a); }
  static __device__ __forceinline__ double ceil(double a) { return ::ceil(a); }
  // the high word's 32 bits then the low word's top 20 under the exponent of 1
  static __device__ __forceinline__ double unit(Key b) {
    const unsigned long long m = ((unsigned long long)b.a << 20) | (unsigned long long)(b.b >> 12);
    return __dsub_rn(__longlong_as_double((long long)(m | 0x3FF0000000000000ull)), 1.0);
  }
  static constexpr double NORMAL_LO = -0x1.fffffffffffffp-1;     // nextafter(-1, 0)
  static constexpr double NORMAL_SPAN = 2.0;                    // 1 - NORMAL_LO, rounded
  static constexpr double SQRT2 = 1.4142135623730951;
};

// normal(k, ()): sqrt(2) erfinv(max(lo, u * span + lo))
template <typename T> __device__ __forceinline__ T normal_one(Key k) {
  using M = F<T>;
  T u = M::fma(M::unit(child(k, 0u)), M::NORMAL_SPAN, M::NORMAL_LO);
  u = u < M::NORMAL_LO ? M::NORMAL_LO : u;
  return M::mul(M::erfinv(u), M::SQRT2);
}

// log|gamma(x)| as XLA expands chlo.lgamma (Lanczos, g = 7, n = 9)
template <typename T> __device__ T lgamma_xla(T x) {
  using M = F<T>;
  const double coef[8] = {676.520368121885098567009190444019, -1259.13921672240287047156078755283,
                          771.3234287776530788486528258894, -176.61502916214059906584551354,
                          12.507343278686904814458936853, -0.13857109526572011689554707,
                          9.984369578019570859563e-6, 1.50563273514931155834e-7};
  const bool reflect = x < (T)0.5;
  const T z = reflect ? -x : M::sub(x, (T)1.0);
  T acc = M::add(M::div((T)coef[0], M::add(z, (T)1.0)), (T)0.99999999999980993227684700473478);
#pragma unroll
  for (int i = 1; i < 8; ++i) acc = M::add(acc, M::div((T)coef[i], M::add(z, (T)(i + 1))));
  const T t = M::add(z, (T)7.5);
  const T log_t = M::add(M::log1p(M::mul(z, (T)(1.0 / 7.5))), (T)2.0149030205422647);
  const T log_y = M::add(M::fma(M::sub(M::add(z, (T)0.5), M::div(t, log_t)), log_t, (T)0.91893853320467274178),
                         M::log(acc));
  const T ax = fabs(x);
  T frac = M::sub(ax, M::floor(ax));
  frac = (T)0.5 < frac ? M::sub((T)1.0, frac) : frac;
  const T denom = M::log(M::sin(M::mul(frac, (T)3.141592653589793)));
  const T refl = isfinite(denom) ? M::sub(M::sub((T)1.1447298858494002, denom), log_y) : -denom;
  const T out = reflect ? refl : log_y;
  return isinf(ax) ? (T)INFINITY : out;
}

// ---------------------------------------------------------------------------
// TG: gamma, Marsaglia and Tsang
// ---------------------------------------------------------------------------

template <typename T> __device__ __forceinline__ bool gamma_accepts(T X, T V, T U, T d) {
  using M = F<T>;
  return (U >= M::fma(M::mul(X, X), (T)-0.0331, (T)1.0)) &
         (M::log(U) >= M::fma(d, M::add(M::sub((T)1.0, V), M::log(V)), M::mul(X, (T)0.5)));
}

template <typename T>
__global__ void __launch_bounds__(THREADS) tg_kernel(const uint32_t* key, const T* alpha, T* out, long long n,
                                                    int log_space) {
  using M = F<T>;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const Key e = at(Key{key[0], key[1]}, i);     // split(key, n)[i]
  Key state = child(e, 0u);
  const Key sub = child(e, 1u);
  const T a0 = alpha[i];
  const bool boost = a0 >= (T)1.0;
  const T a = boost ? a0 : M::add(a0, (T)1.0);
  const T third = (T)(1.0 / 3.0);
  const T d = M::sub(a, third);
  const T c = M::div(third, M::sqrt(d));
  T X = 0, V = 1, U = 2;
  while (gamma_accepts(X, V, U, d)) {
    const Key next = child(state, 0u), xk0 = child(state, 1u), uk = child(state, 2u);
    Key xk = xk0;
    T x, v;
    do {
      const Key xn = child(xk, 0u), sx = child(xk, 1u);
      x = normal_one<T>(sx);
      v = M::fma(x, c, (T)1.0);
      xk = xn;
    } while (v <= (T)0);
    X = M::mul(x, x);
    V = M::mul(M::mul(v, v), v);
    U = M::unit(child(uk, 0u));
    state = next;
  }
  const T u = M::unit(child(sub, 0u));
  if (log_space) {
    const T log_u = M::log1p(-u);
    const T log_boost = (boost || log_u == (T)0) ? (T)0 : M::mul(log_u, M::div((T)1.0, a0));
    out[i] = M::add(M::add(M::log(d), M::log(V)), log_boost);
  } else {
    const T boost_v = boost ? (T)1.0 : M::pow(M::sub((T)1.0, u), M::div((T)1.0, a0));
    out[i] = M::mul(M::mul(d, V), boost_v);
  }
}

// ---------------------------------------------------------------------------
// TP and TB: the round keys of a launch, then two passes
// ---------------------------------------------------------------------------
//
// Round r of jax.random's rejection loop draws from split(kk_r, 3) =
// (kk_{r+1}, s0_r, s1_r), kk_0 the call's key, and element i hashes its
// counter i under s0_r and s1_r.  Only those two hashes are the element's
// own: round_keys_kernel derives the chain once a launch (one thread walks
// kk, the others hash the children) into the workspace for rounds below a
// cap, and a thread that needs a round past the cap derives it itself from
// the stored kk_cap.  Knuth's loop (TP) draws from split(rng_j, 2) =
// (rng_{j+1}, sub_j) on the same key: its keys are the rejection chain's
// (sub_j = s0_j).  The inversion loop (TB) draws from (sub_j, rng_{j+1}) =
// split(rng_j, 2), a chain of its own, stored beside it.
//
// jax.random keeps an element's k of the batch's last accepting round at or
// before R, the batch's round count.  Pass 0 takes every element to its first
// acceptance f (the other branch's elements too, with JAX's stand-in
// parameters: they count in R), writes the draw as if f were also its last,
// keeps f in first[i] (saturated at 255: a lower f only lengthens the walk)
// and reduces R = max(f + 1), one atomic a block; it lists the rejection
// elements.  Pass 1 walks each listed element back from round R - 1 to
// f + 1 and stops at the first acceptance, which is the last one; with
// none, pass 0's draw stands.
//
// A draw of at most THREADS values runs in one launch: its block derives the
// round keys, runs pass 0, and walks back at once, since R is final when the
// block's own reduction is done.  A larger one takes three launches (the
// round keys, pass 0, pass 1).
//
// The workspace, in 32-bit words for a cap of C rounds: R at word 0, the
// length of pass 1's list at word 1; from word 4 the rejection rounds' (s0,
// s1), four words each, then kk_C; from word 8 + 4 C the inversion rounds'
// sub, two words each, then rng_C.

constexpr int KEY_THREADS = 64;
constexpr int MAX_KEY_ROUNDS = 64;

// The resident blocks an SM that the passes ask of the register allocator
// (__launch_bounds__'s second argument).  Left to itself ptxas gives TB's
// float64 passes 76-80 registers, 3 blocks an SM; at 4 (64 registers, a few
// spilled) they ran 6-8% faster on the H100, and more than 5 for the float32
// passes (45-47 registers) spilled with no gain (PERF.md)
constexpr int BLOCKS_32 = 5, BLOCKS_64 = 4;

__host__ __device__ constexpr int rejection_tail(int cap) { return 4 + 4 * cap; }
__host__ __device__ constexpr int inversion_keys(int cap) { return 8 + 4 * cap; }
__host__ __device__ constexpr int inversion_tail(int cap) { return 8 + 6 * cap; }

// the round keys of cap rounds into ws, R and the list length zeroed; every
// thread of the block calls it
__device__ void derive_round_keys(const uint32_t* key, uint32_t* ws, int cap, int inversion) {
  __shared__ Key kk[MAX_KEY_ROUNDS + 1], rng[MAX_KEY_ROUNDS + 1];
  const int t = threadIdx.x;
  if (t == 0) {
    ws[0] = ws[1] = 0;
    Key k{key[0], key[1]};
    for (int r = 0; r < cap; ++r) {
      kk[r] = k;
      k = child(k, 0u);
    }
    kk[cap] = k;
  } else if (t == 32 && inversion) {
    Key k{key[0], key[1]};
    for (int j = 0; j < cap; ++j) {
      rng[j] = k;
      k = child(k, 1u);
    }
    rng[cap] = k;
  }
  __syncthreads();
  for (int r = t; r < cap; r += blockDim.x) {
    const Key s0 = child(kk[r], 1u), s1 = child(kk[r], 2u);
    reinterpret_cast<uint4*>(ws + 4)[r] = make_uint4(s0.a, s0.b, s1.a, s1.b);
    if (inversion) {
      const Key sub = child(rng[r], 0u);
      reinterpret_cast<uint2*>(ws + inversion_keys(cap))[r] = make_uint2(sub.a, sub.b);
    }
  }
  if (t == 0) {
    ws[rejection_tail(cap)] = kk[cap].a;
    ws[rejection_tail(cap) + 1] = kk[cap].b;
    if (inversion) {
      ws[inversion_tail(cap)] = rng[cap].a;
      ws[inversion_tail(cap) + 1] = rng[cap].b;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(KEY_THREADS) round_keys_kernel(const uint32_t* key, uint32_t* ws, int cap,
                                                                int inversion) {
  derive_round_keys(key, ws, cap, inversion);
}

// the rejection chain's keys round by round; past the cap from the thread's
// own copy of the chain, so rounds from the cap on must come in order
struct RejectionKeys {
  const uint4* stored;
  int cap;
  Key kk;
  __device__ RejectionKeys(const uint32_t* ws, int cap_)
      : stored(reinterpret_cast<const uint4*>(ws + 4)), cap(cap_),
        kk{ws[rejection_tail(cap_)], ws[rejection_tail(cap_) + 1]} {}
  __device__ void get(int r, Key* s0, Key* s1) {
    if (r < cap) {
      const uint4 w = stored[r];
      *s0 = Key{w.x, w.y};
      *s1 = Key{w.z, w.w};
    } else {
      *s0 = child(kk, 1u);
      *s1 = child(kk, 2u);
      kk = child(kk, 0u);
    }
  }
  // s0 alone: Knuth's sub key of round r
  __device__ Key first(int r) {
    if (r < cap) {
      const uint2 w = reinterpret_cast<const uint2*>(stored + r)[0];
      return Key{w.x, w.y};
    }
    const Key s0 = child(kk, 1u);
    kk = child(kk, 0u);
    return s0;
  }
};

// the inversion chain's sub keys, as RejectionKeys
struct InversionKeys {
  const uint2* stored;
  int cap;
  Key rng;
  __device__ InversionKeys(const uint32_t* ws, int cap_)
      : stored(reinterpret_cast<const uint2*>(ws + inversion_keys(cap_))), cap(cap_),
        rng{ws[inversion_tail(cap_)], ws[inversion_tail(cap_) + 1]} {}
  __device__ Key get(int j) {
    if (j < cap) {
      const uint2 w = stored[j];
      return Key{w.x, w.y};
    }
    const Key sub = child(rng, 0u);
    rng = child(rng, 1u);
    return sub;
  }
};

// the element's first accepting round of the rejection loop, its k in *k
template <typename T, typename Step>
__device__ int first_acceptance(const uint32_t* ws, int cap, long long i, const Step& step, T* k) {
  RejectionKeys keys(ws, cap);
  for (int r = 0;; ++r) {
    Key s0, s1;
    keys.get(r, &s0, &s1);
    if (step.round(s0, s1, i, k)) return r;
  }
}

// whether a round in [lo, R) accepts, the last such round's k in *k: the
// stored rounds walked back from the top, the rounds past the cap (if R
// passes it) forward from kk_cap, keeping the last
template <typename T, typename Step>
__device__ bool last_acceptance(const uint32_t* ws, int cap, int lo, int R, long long i, const Step& step, T* k) {
  bool found = false;
  if (R > cap) {
    Key kk{ws[rejection_tail(cap)], ws[rejection_tail(cap) + 1]};
    for (int r = cap; r < R; ++r) {
      T kr;
      if (r >= lo && step.round(child(kk, 1u), child(kk, 2u), i, &kr)) {
        found = true;
        *k = kr;
      }
      kk = child(kk, 0u);
    }
  }
  const uint4* stored = reinterpret_cast<const uint4*>(ws + 4);
  for (int r = (R < cap ? R : cap) - 1; !found && r >= lo; --r) {
    const uint4 w = stored[r];
    found = step.round(Key{w.x, w.y}, Key{w.z, w.w}, i, k);
  }
  return found;
}

// pass 0's end, which every thread of the block reaches: R = max(rounds)
// into ws[0], and each i whose `walk` is set appended to pass 1's list (its
// length ws[1]; one atomic a block, in order within the block)
__device__ __forceinline__ void pass0_end(uint32_t* ws, uint32_t* list, int rounds, bool walk, long long i) {
  __shared__ int warp_max[THREADS / 32];
  __shared__ uint32_t warp_start[THREADS / 32], base;
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned mask = __ballot_sync(0xFFFFFFFFu, walk);
  rounds = __reduce_max_sync(0xFFFFFFFFu, rounds);
  if (lane == 0) {
    warp_max[warp] = rounds;
    warp_start[warp] = __popc(mask);
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    rounds = __reduce_max_sync(0xFFFFFFFFu, threadIdx.x < THREADS / 32 ? warp_max[threadIdx.x] : 0);
    if (threadIdx.x == 0) {
      atomicMax(reinterpret_cast<int*>(ws), rounds);
      uint32_t total = 0;
      for (int w = 0; w < THREADS / 32; ++w) {
        const uint32_t c = warp_start[w];
        warp_start[w] = total;
        total += c;
      }
      base = total ? atomicAdd(ws + 1, total) : 0u;
    }
  }
  __syncthreads();
  if (walk) list[base + warp_start[warp] + __popc(mask & ((1u << lane) - 1u))] = (uint32_t)i;
}

// pass 1's element of this thread: the listed one, or -1 past the list
__device__ __forceinline__ long long pass1_element(const uint32_t* ws, const uint32_t* list) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  return t < (long long)ws[1] ? (long long)list[t] : -1;
}

// ---------------------------------------------------------------------------
// TP: Poisson, float32 as jax.random computes it
// ---------------------------------------------------------------------------

struct PoissonRejection {
  float lam, log_lam, b, a, inv_alpha, v_r, two_a;
  __device__ explicit PoissonRejection(float l) : lam(l) {
    using M = F<float>;
    log_lam = M::log(l);
    b = M::fma(M::sqrt(l), 2.53f, 0.931f);
    a = M::fma(b, 0.02483f, -0.059f);
    inv_alpha = M::add(1.1239f, M::div(1.1328f, M::sub(b, 3.4f)));
    v_r = M::sub(0.9277f, M::div(3.6224f, M::sub(b, 2.0f)));
    two_a = M::mul(2.0f, a);
  }
  // one round from its two subkeys: (k, accepted)
  __device__ bool round(Key s0, Key s1, long long i, float* k_out) const {
    using M = F<float>;
    const float u = M::sub(M::unit(at(s0, i)), 0.5f);
    const float v = M::unit(at(s1, i));
    const float us = M::sub(0.5f, fabsf(u));
    const float k = M::floor(M::add(M::fma(M::add(M::div(two_a, us), b), u, lam), 0.43f));
    const float s = M::log(M::div(M::mul(v, inv_alpha), M::add(M::div(a, M::mul(us, us)), b)));
    const float t = M::sub(M::fma(k, log_lam, -lam), lgamma_xla<float>(M::add(k, 1.0f)));
    const bool accept1 = (us >= 0.07f) && (v <= v_r);
    const bool reject = (k < 0.0f) || ((us < 0.013f) && (v > us));
    *k_out = k;
    return accept1 || (!reject && (s <= t));
  }
};

__device__ __forceinline__ bool poisson_knuth(float l) { return isnan(l) || l < 10.0f; }

// element i's walk back from round R - 1 to its first acceptance + 1
__device__ __forceinline__ void tp_walk(const float* lam, long long* out, const uint32_t* ws, const uint8_t* first,
                                        int cap, long long i) {
  const int R = *reinterpret_cast<const int*>(ws);
  const int lo = first[i] + 1;
  float k;
  if (lo < R && last_acceptance(ws, cap, lo, R, i, PoissonRejection(lam[i]), &k)) out[i] = (long long)k;
}

// WALK false: pass 0 (every element; with `whole`, the draw's one block,
// which derives the round keys first and walks back at the end); true: pass 1
// (the listed rejection elements)
template <bool WALK>
__global__ void __launch_bounds__(THREADS, BLOCKS_32)
    tp_kernel(const uint32_t* key, const float* lam, long long* out, long long n, uint32_t* ws, uint8_t* first,
              uint32_t* list, int cap, int whole) {
  using M = F<float>;
  if constexpr (WALK) {
    const long long i = pass1_element(ws, list);
    if (i >= 0) tp_walk(lam, out, ws, first, cap, i);
    return;
  }
  if (whole) derive_round_keys(key, ws, cap, 0);
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  int rounds = 0;
  bool walk = false;
  if (i < n) {
    const float l = lam[i];
    const bool knuth = poisson_knuth(l);
    float k;
    const int f = first_acceptance(ws, cap, i, PoissonRejection(knuth ? 1e5f : l), &k);
    first[i] = (uint8_t)(f < 255 ? f : 255);
    rounds = f + 1;
    walk = !knuth;
    long long draw = (long long)k;
    if (knuth) {
      RejectionKeys keys(ws, cap);
      long long j = 0;
      float log_prod = 0.0f;
      while (log_prod > -l) log_prod = M::add(log_prod, M::log(M::unit(at(keys.first((int)j++), i))));
      draw = l == 0.0f ? 0 : j - 1;
    }
    out[i] = draw;
  }
  pass0_end(ws, list, rounds, walk, i);
  if (whole && walk) tp_walk(lam, out, ws, first, cap, i);
}

// ---------------------------------------------------------------------------
// TB: binomial, inversion and BTRS, in the probabilities' dtype
// ---------------------------------------------------------------------------

// Stirling's series tail of log k! for k = 0..9, read through the read-only
// cache (an array local to the function would be written to the stack at
// every call)
__device__ const double STIRLING_TAIL[10] = {0.0810614667953272,  0.0413406959554092,  0.0276779256849983,
                                             0.02079067210376509, 0.0166446911898211,  0.0138761288230707,
                                             0.0118967099458917,  0.0104112652619720,  0.00925546218271273,
                                             0.00833056343336287};

template <typename T> __device__ __forceinline__ T stirling_tail(T k) {
  using M = F<T>;
  const T kc = k < (T)0 ? (T)0 : (k > (T)9 ? (T)9 : k);
  const T kp1 = M::add(kc, (T)1.0);
  const T kp1sq = M::mul(kp1, kp1);
  const T approx = M::div(M::sub((T)(1.0 / 12), M::div(M::sub((T)(1.0 / 360), M::div((T)(1.0 / 1260), kp1sq)), kp1sq)),
                          kp1);
  return k <= (T)9 ? (T)__ldg(STIRLING_TAIL + (int)M::floor(kc)) : approx;
}

// BTRS of one element: what a round computes from its parameters alone is
// computed once, each operation as the round would round it
template <typename T> struct Btrs {
  T n, p, stddev, b, a, c, v_r, r, alpha, m, two_a, n1, nm1, m_term, tail_m, tail_nm;
  __device__ Btrs(T n_, T p_) : n(n_), p(p_) {
    using M = F<T>;
    stddev = M::sqrt(M::mul(M::mul(n, p), M::sub((T)1.0, p)));
    b = M::fma(stddev, (T)2.53, (T)1.15);
    a = M::fma(p, (T)0.01, M::fma(b, (T)0.0248, (T)-0.0873));
    c = M::fma(n, p, (T)0.5);
    v_r = M::sub((T)0.92, M::div((T)4.2, b));
    r = M::div(p, M::sub((T)1.0, p));
    alpha = M::mul(M::add((T)2.83, M::div((T)5.1, b)), stddev);
    m = M::floor(M::mul(M::add(n, (T)1.0), p));
    two_a = M::mul((T)2.0, a);
    n1 = M::add(n, (T)1.0);
    nm1 = M::add(M::sub(n, m), (T)1.0);
    m_term = M::mul(M::add(m, (T)0.5), M::log(M::div(M::add(m, (T)1.0), M::mul(r, nm1))));
    tail_m = stirling_tail(m);
    tail_nm = stirling_tail(M::sub(n, m));
  }
  __device__ bool round(Key s0, Key s1, long long i, T* k_out) const {
    using M = F<T>;
    const T u = M::sub(M::unit(at(s0, i)), (T)0.5);
    T v = M::unit(at(s1, i));
    const T us = M::sub((T)0.5, fabs(u));
    const bool accept1 = (us >= (T)0.07) && (v <= v_r);
    const T k = M::floor(M::fma(M::add(M::div(two_a, us), b), u, c));
    const bool reject = (k < (T)0) || (k > n);
    v = M::log(M::div(M::mul(v, alpha), M::add(M::div(a, M::mul(us, us)), b)));
    const T nk1 = M::add(M::sub(n, k), (T)1.0);
    T ub = M::fma(M::add(k, (T)0.5), M::log(M::div(M::mul(r, nk1), M::add(k, (T)1.0))),
                  M::fma(n1, M::log(M::div(nm1, nk1)), m_term));
    ub = M::sub(M::sub(M::add(M::add(ub, tail_m), tail_nm), stirling_tail(k)), stirling_tail(M::sub(n, k)));
    *k_out = k;
    return accept1 || (!reject && (v <= ub));
  }
};

// jax.random.binomial's parameters of one element: the branch, the
// reflection and the invalid-parameter rules
template <typename T> struct BinomialParams {
  T count, q;
  bool keep, invalid, count_inf, inversion;
  __device__ BinomialParams(T count_raw, T p) {
    using M = F<T>;
    const bool p_lt_half = p < (T)0.5;
    q = p_lt_half ? p : M::sub((T)1.0, p);
    const bool count_nan_or_neg = isnan(count_raw) || count_raw < (T)0;
    count_inf = isinf(count_raw);
    const bool q_is_nan = isnan(q);
    const bool q_l_0 = q < (T)0;
    q = (q_is_nan || q_l_0) ? (T)0.01 : q;
    inversion = count_nan_or_neg || (M::mul(count_raw, q) <= (T)10.0);
    count = M::floor(count_raw);
    invalid = q_l_0 || q_is_nan || count_nan_or_neg;
    keep = p_lt_half || count_nan_or_neg || q_is_nan || count_inf;
  }
  // whether the draw is the rejection loop's k of the last accepting round
  // (nan and inf draws are not), so that pass 1 walks back for it
  __device__ bool walks() const { return !inversion && !invalid && !count_inf; }
  // the draw of the sampled value
  __device__ T finish(T sample) const {
    if (invalid) sample = (T)NAN;
    if (count_inf && !invalid) sample = (T)INFINITY;
    return keep ? sample : F<T>::sub(count, sample);
  }
};

// element i's walk back, as tp_walk
template <typename T>
__device__ __forceinline__ void tb_walk(const T* count_in, const T* prob, T* out, const uint32_t* ws,
                                        const uint8_t* first, int cap, long long i) {
  const int R = *reinterpret_cast<const int*>(ws);
  const int lo = first[i] + 1;
  if (lo >= R) return;
  const BinomialParams<T> pr(count_in[i], prob[i]);
  T k;
  if (last_acceptance(ws, cap, lo, R, i, Btrs<T>(pr.count, pr.q), &k)) out[i] = pr.finish(k);
}

// WALK and `whole` as for tp_kernel
template <typename T, bool WALK>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 8 ? BLOCKS_64 : BLOCKS_32)
    tb_kernel(const uint32_t* key, const T* count_in, const T* prob, T* out, long long n, uint32_t* ws,
              uint8_t* first, uint32_t* list, int cap, int whole) {
  using M = F<T>;
  if constexpr (WALK) {
    const long long i = pass1_element(ws, list);
    if (i >= 0) tb_walk(count_in, prob, out, ws, first, cap, i);
    return;
  }
  if (whole) derive_round_keys(key, ws, cap, 1);
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  int rounds = 0;
  bool walk = false;
  if (i < n) {
    const BinomialParams<T> pr(count_in[i], prob[i]);
    T sample;
    const int f = first_acceptance(ws, cap, i, Btrs<T>(pr.inversion ? (T)1e4 : pr.count, pr.inversion ? (T)0.5 : pr.q),
                                   &sample);
    first[i] = (uint8_t)(f < 255 ? f : 255);
    rounds = f + 1;
    walk = pr.walks();
    if (pr.inversion && !pr.invalid) {
      InversionKeys keys(ws, cap);
      const T log1mq = M::log1p(-pr.q);
      T num_geom = 0, geom_sum = 0;
      for (int j = 0; geom_sum <= pr.count; ++j) {
        num_geom = M::add(num_geom, (T)1.0);
        geom_sum = M::add(geom_sum, M::ceil(M::div(M::log(M::unit(at(keys.get(j), i))), log1mq)));
      }
      sample = M::sub(num_geom, (T)1.0);
    }
    out[i] = pr.finish(sample);
  }
  pass0_end(ws, list, rounds, walk, i);
  if (whole && walk) tb_walk(count_in, prob, out, ws, first, cap, i);
}

// ---------------------------------------------------------------------------
// TM: MRG31k3p, a thread a (stream, chunk of steps)
// ---------------------------------------------------------------------------
//
// The recurrence is linear: a stream's state after t steps is A1^t x1 mod
// m1 and A2^t x2 mod m2 (x1, x2 its two triples).  Thread (j, c) owns steps
// [c L, (c + 1) L) of stream j: it jumps the stream's state by row c of
// the jump table (A1^(c L), A2^(c L), computed exactly on the host, 18
// words a row), steps L times and writes its draws t n_streams + j, the
// stream index fastest across a warp so that each step's stores are
// coalesced.  The thread whose chunk holds the stream's last own step
// (`steps`, one fewer for streams at or past `rem`) writes its new state;
// with no own step, chunk 0 copies the state.  Chunk 0 starts from the
// state itself; a later chunk starts at step c L >= 3, where every
// component is a reduced result, so the jump gives the stepped state's
// bits.
//
// No 64-bit `%`: a step's two sums are below 2^54 and 2^47 and fold once
// (2^31 = 1 mod m1, 2^31 = 21069 mod m2) to below twice the modulus; the
// jump's rows of three 31 x 31-bit products (below 3 2^62) fold twice.
// Then one conditional subtract.  Exact for components in [0, 2^31).

constexpr uint32_t MRG_M1 = 2147483647u, MRG_M2 = 2147462579u, LOW31 = 0x7FFFFFFFu;
constexpr int MRG_JUMP_WORDS = 18;

__device__ __forceinline__ uint32_t reduce_once(uint32_t v, uint32_t m) { return v >= m ? v - m : v; }

// (2^22 x12 + 129 x13) mod m1
__device__ __forceinline__ uint32_t mrg_y1(uint32_t x12, uint32_t x13) {
  const uint64_t p = (uint64_t)x12 * 4194304u + (uint64_t)x13 * 129u;
  return reduce_once((uint32_t)(p & LOW31) + (uint32_t)(p >> 31), MRG_M1);
}

// (2^15 x21 + (2^15 + 1) x23) mod m2
__device__ __forceinline__ uint32_t mrg_y2(uint32_t x21, uint32_t x23) {
  const uint64_t p = (uint64_t)x21 * 32768u + (uint64_t)x23 * 32769u;
  return reduce_once((uint32_t)(p & LOW31) + (uint32_t)(p >> 31) * 21069u, MRG_M2);
}

// row a of a jump matrix times x, mod m1 or m2
template <bool FIRST>
__device__ __forceinline__ uint32_t mrg_row(const uint32_t* a, const uint32_t* x) {
  uint64_t p = (uint64_t)a[0] * x[0] + (uint64_t)a[1] * x[1] + (uint64_t)a[2] * x[2];
  if (FIRST) {
    p = (p & LOW31) + (p >> 31);                                               // < 2^33
    return reduce_once((uint32_t)(p & LOW31) + (uint32_t)(p >> 31), MRG_M1);   // < 2^31 + 4
  }
  p = (p & LOW31) + (p >> 31) * 21069u;                                            // < 2^47
  return reduce_once((uint32_t)(p & LOW31) + (uint32_t)(p >> 31) * 21069u, MRG_M2);  // < 2^32
}

template <typename T>
__global__ void __launch_bounds__(THREADS) tm_kernel(const int* state, int* new_state, T* out, const uint32_t* jump,
                                                    int n_streams, int chunk, int threads, long long steps, int rem,
                                                    T norm) {
  const int id = blockIdx.x * THREADS + threadIdx.x;
  if (id >= threads) return;
  const int j = id % n_streams, c = id / n_streams;
  const long long own = (rem != 0 && j >= rem) ? steps - 1 : steps;
  const long long t0 = (long long)c * chunk;
  const bool last = c == (own > 0 ? (int)((own - 1) / chunk) : 0);
  if (t0 >= own && !last) return;
  uint32_t x[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) x[k] = (uint32_t)state[(long long)j * 6 + k];
  if (c > 0) {
    uint32_t a[MRG_JUMP_WORDS];
    const uint2* row = reinterpret_cast<const uint2*>(jump + (long long)c * MRG_JUMP_WORDS);
#pragma unroll
    for (int k = 0; k < MRG_JUMP_WORDS / 2; ++k) {
      const uint2 w = __ldg(row + k);
      a[2 * k] = w.x;
      a[2 * k + 1] = w.y;
    }
    const uint32_t y[6] = {mrg_row<true>(a, x),      mrg_row<true>(a + 3, x),      mrg_row<true>(a + 6, x),
                           mrg_row<false>(a + 9, x + 3), mrg_row<false>(a + 12, x + 3), mrg_row<false>(a + 15, x + 3)};
#pragma unroll
    for (int k = 0; k < 6; ++k) x[k] = y[k];
  }
  const long long t1 = t0 + chunk < own ? t0 + chunk : own;
  T* o = out + t0 * n_streams + j;
  for (long long t = t0; t < t1; ++t, o += n_streams) {
    const uint32_t y1 = mrg_y1(x[1], x[2]), y2 = mrg_y2(x[3], x[5]);
    x[2] = x[1];
    x[1] = x[0];
    x[0] = y1;
    x[5] = x[4];
    x[4] = x[3];
    x[3] = y2;
    uint32_t d = y1 - y2;
    if ((int)d <= 0) d += MRG_M1;
    *o = F<T>::mul((T)d, norm);
  }
  if (last) {
#pragma unroll
    for (int k = 0; k < 6; ++k) new_state[(long long)j * 6 + k] = (int)x[k];
  }
}

inline unsigned blocks(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

template <typename T>
void tb_launch(const void* key, const void* count, const void* prob, void* out, long long n, void* ws, void* first,
               void* list, int cap, cudaStream_t s) {
  uint32_t* w = (uint32_t*)ws;
  const int whole = n <= THREADS;
  if (!whole) round_keys_kernel<<<1, KEY_THREADS, 0, s>>>((const uint32_t*)key, w, cap, 1);
  tb_kernel<T, false><<<blocks(n), THREADS, 0, s>>>((const uint32_t*)key, (const T*)count, (const T*)prob, (T*)out, n,
                                                    w, (uint8_t*)first, (uint32_t*)list, cap, whole);
  if (!whole)
    tb_kernel<T, true><<<blocks(n), THREADS, 0, s>>>((const uint32_t*)key, (const T*)count, (const T*)prob, (T*)out,
                                                     n, w, (uint8_t*)first, (uint32_t*)list, cap, 0);
}

template <typename Kernel> int kernel_info(Kernel kernel, int threads, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int resident = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, threads, 0);
  if (err != cudaSuccess) return (int)err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = resident;
  info[3] = threads;
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64.  Each returns cudaGetLastError() after its launches.
int tg_gamma(const void* key, const void* alpha, void* out, long long n, int dtype, int log_space, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    if (dtype == 0)
      tg_kernel<float><<<blocks(n), THREADS, 0, s>>>((const uint32_t*)key, (const float*)alpha, (float*)out, n,
                                                    log_space);
    else
      tg_kernel<double><<<blocks(n), THREADS, 0, s>>>((const uint32_t*)key, (const double*)alpha, (double*)out, n,
                                                     log_space);
  }
  return (int)cudaGetLastError();
}

// TP and TB: the round keys, pass 0 and pass 1 (three launches; one for at
// most THREADS values); ws holds 10 + 6 cap words, first n bytes, list n
// words (n < 2**32)
int tp_poisson(const void* key, const void* lam, void* out, long long n, void* ws, void* first, void* list, int cap,
               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cap < 0 || cap > MAX_KEY_ROUNDS || n >= (1ll << 32)) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    uint32_t* w = (uint32_t*)ws;
    const int whole = n <= THREADS;
    if (!whole) round_keys_kernel<<<1, KEY_THREADS, 0, s>>>((const uint32_t*)key, w, cap, 0);
    tp_kernel<false><<<blocks(n), THREADS, 0, s>>>((const uint32_t*)key, (const float*)lam, (long long*)out, n, w,
                                                   (uint8_t*)first, (uint32_t*)list, cap, whole);
    if (!whole)
      tp_kernel<true><<<blocks(n), THREADS, 0, s>>>((const uint32_t*)key, (const float*)lam, (long long*)out, n, w,
                                                    (uint8_t*)first, (uint32_t*)list, cap, 0);
  }
  return (int)cudaGetLastError();
}

int tb_binomial(const void* key, const void* count, const void* prob, void* out, long long n, int dtype, void* ws,
                void* first, void* list, int cap, void* stream) {
  if (cap < 0 || cap > MAX_KEY_ROUNDS || n >= (1ll << 32)) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    if (dtype == 0)
      tb_launch<float>(key, count, prob, out, n, ws, first, list, cap, (cudaStream_t)stream);
    else
      tb_launch<double>(key, count, prob, out, n, ws, first, list, cap, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

// info[0..3] of TP's, TB's and TM's kernels: registers a thread, local
// memory (spills and stack) bytes a thread, resident blocks an SM, threads a
// block.  which: 0 the round keys, 1 and 2 TP's passes, 3 and 4 TB's in
// float32, 5 and 6 in float64, 7 and 8 TM in float32 and float64
int random_loops_kernel_info(int which, int* info) {
  switch (which) {
    case 0: return kernel_info(round_keys_kernel, KEY_THREADS, info);
    case 1: return kernel_info(tp_kernel<false>, THREADS, info);
    case 2: return kernel_info(tp_kernel<true>, THREADS, info);
    case 3: return kernel_info(tb_kernel<float, false>, THREADS, info);
    case 4: return kernel_info(tb_kernel<float, true>, THREADS, info);
    case 5: return kernel_info(tb_kernel<double, false>, THREADS, info);
    case 6: return kernel_info(tb_kernel<double, true>, THREADS, info);
    case 7: return kernel_info(tm_kernel<float>, THREADS, info);
    case 8: return kernel_info(tm_kernel<double>, THREADS, info);
    default: return (int)cudaErrorInvalidValue;
  }
}

// TM: one launch of n_streams x chunks threads; jump holds 18 words a chunk
// (row c: A1^(c chunk), A2^(c chunk), row-major), unread with one chunk
int tm_mrg(const void* state, void* new_state, void* out, const void* jump, int n_streams, int chunk, int chunks,
           long long steps, int rem, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long threads = (long long)n_streams * chunks;
  if (n_streams < 0 || chunk < 1 || chunks < 1 || threads >= (1ll << 31) || (chunks > 1 && !jump))
    return (int)cudaErrorInvalidValue;
  if (threads > 0) {
    if (dtype == 0)
      tm_kernel<float><<<blocks(threads), THREADS, 0, s>>>((const int*)state, (int*)new_state, (float*)out,
                                                           (const uint32_t*)jump, n_streams, chunk, (int)threads,
                                                           steps, rem, 4.6566126e-10f);
    else
      tm_kernel<double><<<blocks(threads), THREADS, 0, s>>>((const int*)state, (int*)new_state, (double*)out,
                                                            (const uint32_t*)jump, n_streams, chunk, (int)threads,
                                                            steps, rem, 4.656612873077392578125e-10);
  }
  return (int)cudaGetLastError();
}

const char* random_loops_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
