// TG, TP, TB and TM: jax.random's gamma, Poisson and binomial loop
// samplers and the MRG31k3p streams on Hopper (sm_90a), plain C interface.
//
// None of them replaces a TPU kernel: the JAX package draws these by
// jax.random under XLA (aesara_tpu/tensor/random/basic.py) and MRG31k3p
// by a lax.scan (aesara_tpu/link/jax/random_dispatch.py:40-137).  They are
// loops whose trip count depends on the data, so each element (each
// stream for TM) gets one thread that walks its own threefry2x32 key chain
// in registers and leaves the loop on its own.  The wrapper and the plain
// versions are kernels/random_loops.py; its docstring says which rounds
// each sampler runs and why TP and TB take two launches (jax.random keeps
// an element's k of the batch's *last* accepting round).
//
// What bounds them on the H100: integer work, three to five threefry
// hashes (115 32-bit operations each) a round an element, and a few
// transcendentals; each element writes 4 or 8 bytes.
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
// TP: Poisson, float32 as jax.random computes it
// ---------------------------------------------------------------------------

struct PoissonRejection {
  float lam, log_lam, b, a, inv_alpha, v_r;
  __device__ explicit PoissonRejection(float l) : lam(l) {
    using M = F<float>;
    log_lam = M::log(l);
    b = M::fma(M::sqrt(l), 2.53f, 0.931f);
    a = M::fma(b, 0.02483f, -0.059f);
    inv_alpha = M::add(1.1239f, M::div(1.1328f, M::sub(b, 3.4f)));
    v_r = M::sub(0.9277f, M::div(3.6224f, M::sub(b, 2.0f)));
  }
  // one round from its two subkeys: (k, accepted)
  __device__ bool round(Key s0, Key s1, long long i, float* k_out) const {
    using M = F<float>;
    const float u = M::sub(M::unit(at(s0, i)), 0.5f);
    const float v = M::unit(at(s1, i));
    const float us = M::sub(0.5f, fabsf(u));
    const float k = M::floor(M::add(M::fma(M::add(M::div(M::mul(2.0f, a), us), b), u, lam), 0.43f));
    const float s = M::log(M::div(M::mul(v, inv_alpha), M::add(M::div(a, M::mul(us, us)), b)));
    const float t = M::sub(M::fma(k, log_lam, -lam), lgamma_xla<float>(M::add(k, 1.0f)));
    const bool accept1 = (us >= 0.07f) && (v <= v_r);
    const bool reject = (k < 0.0f) || ((us < 0.013f) && (v > us));
    *k_out = k;
    return accept1 || (!reject && (s <= t));
  }
};

// pass 0: Knuth's elements, and every element's first accepting round of
// the rejection loop into *rounds; pass 1: the rejection elements to round R
__global__ void __launch_bounds__(THREADS) tp_kernel(const uint32_t* key, const float* lam, long long* out,
                                                    long long n, int* rounds, int pass) {
  using M = F<float>;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const Key k0{key[0], key[1]};
  const float l = lam[i];
  const bool knuth = isnan(l) || l < 10.0f;
  const PoissonRejection rej(knuth ? 1e5f : l);
  if (pass == 0) {
    if (knuth) {
      long long k = 0;
      float log_prod = 0.0f;
      Key rng = k0;
      while (log_prod > -l) {
        const Key next = child(rng, 0u), sub = child(rng, 1u);
        ++k;
        log_prod = M::add(log_prod, M::log(M::unit(at(sub, i))));
        rng = next;
      }
      out[i] = l == 0.0f ? 0 : k - 1;
    }
    Key kk = k0;
    int r = 0;
    float k;
    bool accepted = false;
    while (!accepted) {
      const Key next = child(kk, 0u), s0 = child(kk, 1u), s1 = child(kk, 2u);
      accepted = rej.round(s0, s1, i, &k);
      kk = next;
      ++r;
    }
    atomicMax(rounds, r);
    return;
  }
  if (knuth) return;
  const int last = *rounds;
  float k_out = -1.0f, k;
  Key kk = k0;
  for (int r = 0; r < last; ++r) {
    const Key next = child(kk, 0u), s0 = child(kk, 1u), s1 = child(kk, 2u);
    if (rej.round(s0, s1, i, &k)) k_out = k;
    kk = next;
  }
  out[i] = l == 0.0f ? 0 : (long long)k_out;
}

// ---------------------------------------------------------------------------
// TB: binomial, inversion and BTRS, in the probabilities' dtype
// ---------------------------------------------------------------------------

template <typename T> __device__ __forceinline__ T stirling_tail(T k) {
  using M = F<T>;
  const double table[10] = {0.0810614667953272, 0.0413406959554092, 0.0276779256849983, 0.02079067210376509,
                            0.0166446911898211, 0.0138761288230707, 0.0118967099458917, 0.0104112652619720,
                            0.00925546218271273, 0.00833056343336287};
  const T kc = k < (T)0 ? (T)0 : (k > (T)9 ? (T)9 : k);
  const T kp1 = M::add(kc, (T)1.0);
  const T kp1sq = M::mul(kp1, kp1);
  const T approx = M::div(M::sub((T)(1.0 / 12), M::div(M::sub((T)(1.0 / 360), M::div((T)(1.0 / 1260), kp1sq)), kp1sq)),
                          kp1);
  return k <= (T)9 ? (T)table[(int)M::floor(kc)] : approx;
}

template <typename T> struct Btrs {
  T n, p, stddev, b, a, c, v_r, r, alpha, m;
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
  }
  __device__ bool round(Key s0, Key s1, long long i, T* k_out) const {
    using M = F<T>;
    const T u = M::sub(M::unit(at(s0, i)), (T)0.5);
    T v = M::unit(at(s1, i));
    const T us = M::sub((T)0.5, fabs(u));
    const bool accept1 = (us >= (T)0.07) && (v <= v_r);
    const T k = M::floor(M::fma(M::add(M::div(M::mul((T)2.0, a), us), b), u, c));
    const bool reject = (k < (T)0) || (k > n);
    v = M::log(M::div(M::mul(v, alpha), M::add(M::div(a, M::mul(us, us)), b)));
    const T nk1 = M::add(M::sub(n, k), (T)1.0);
    const T nm1 = M::add(M::sub(n, m), (T)1.0);
    T ub = M::fma(M::add(k, (T)0.5), M::log(M::div(M::mul(r, nk1), M::add(k, (T)1.0))),
                  M::fma(M::add(n, (T)1.0), M::log(M::div(nm1, nk1)),
                         M::mul(M::add(m, (T)0.5), M::log(M::div(M::add(m, (T)1.0), M::mul(r, nm1))))));
    ub = M::sub(M::sub(M::add(M::add(ub, stirling_tail(m)), stirling_tail(M::sub(n, m))), stirling_tail(k)),
                stirling_tail(M::sub(n, k)));
    *k_out = k;
    return accept1 || (!reject && (v <= ub));
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS) tb_kernel(const uint32_t* key, const T* count_in, const T* prob,
                                                    T* out, long long n, int* rounds, int pass) {
  using M = F<T>;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const Key k0{key[0], key[1]};
  const T p = prob[i];
  const T count_raw = count_in[i];
  const bool p_lt_half = p < (T)0.5;
  T q = p_lt_half ? p : M::sub((T)1.0, p);
  const bool count_nan_or_neg = isnan(count_raw) || count_raw < (T)0;
  const bool count_inf = isinf(count_raw);
  const bool q_is_nan = isnan(q);
  const bool q_l_0 = q < (T)0;
  q = (q_is_nan || q_l_0) ? (T)0.01 : q;
  const bool inversion = count_nan_or_neg || (M::mul(count_raw, q) <= (T)10.0);
  const T count = M::floor(count_raw);
  const Btrs<T> btrs(inversion ? (T)1e4 : count, inversion ? (T)0.5 : q);
  T sample;
  if (pass == 0) {
    Key kk = k0;
    int r = 0;
    T k;
    bool accepted = false;
    while (!accepted) {
      const Key next = child(kk, 0u), s0 = child(kk, 1u), s1 = child(kk, 2u);
      accepted = btrs.round(s0, s1, i, &k);
      kk = next;
      ++r;
    }
    atomicMax(rounds, r);
    if (!inversion) return;
    const T log1mq = M::log1p(-q);
    T num_geom = 0, geom_sum = 0;
    Key rng = k0;
    while (geom_sum <= count) {
      const Key sub = child(rng, 0u), next = child(rng, 1u);
      num_geom = M::add(num_geom, (T)1.0);
      geom_sum = M::add(geom_sum, M::ceil(M::div(M::log(M::unit(at(sub, i))), log1mq)));
      rng = next;
    }
    sample = M::sub(num_geom, (T)1.0);
  } else {
    if (inversion) return;
    const int last = *rounds;
    T k_out = (T)-1.0, k;
    Key kk = k0;
    for (int r = 0; r < last; ++r) {
      const Key next = child(kk, 0u), s0 = child(kk, 1u), s1 = child(kk, 2u);
      if (btrs.round(s0, s1, i, &k)) k_out = k;
      kk = next;
    }
    sample = k_out;
  }
  const bool invalid = q_l_0 || q_is_nan || count_nan_or_neg;
  if (invalid) sample = (T)NAN;
  if (count_inf && !invalid) sample = (T)INFINITY;
  const bool keep = p_lt_half || count_nan_or_neg || q_is_nan || count_inf;
  out[i] = keep ? sample : M::sub(count, sample);
}

// ---------------------------------------------------------------------------
// TM: MRG31k3p, one thread a stream
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS) tm_kernel(const int* state, int* new_state, T* out, long long n,
                                                    int n_streams, long long steps, int rem, T norm) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= n_streams) return;
  const unsigned long long M1 = 2147483647ull, M2 = 2147462579ull;
  unsigned long long x[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) x[c] = (unsigned long long)(unsigned)state[(long long)j * 6 + c];
  const long long own = (rem != 0 && j >= rem) ? steps - 1 : steps;
  for (long long t = 0; t < own; ++t) {
    const unsigned long long y1 = (4194304ull * x[1] + 129ull * x[2]) % M1;
    const unsigned long long y2 = (32768ull * x[3] + 32769ull * x[5]) % M2;
    x[2] = x[1];
    x[1] = x[0];
    x[0] = y1;
    x[5] = x[4];
    x[4] = x[3];
    x[3] = y2;
    unsigned long long d = (y1 + M1 - y2) % M1;
    if (d == 0) d = M1;
    const long long pos = t * n_streams + j;
    if (pos < n) out[pos] = (T)d * norm;
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) new_state[(long long)j * 6 + c] = (int)x[c];
}

inline unsigned blocks(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

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

int tp_poisson(const void* key, const void* lam, void* out, long long n, void* rounds, int pass, void* stream) {
  if (n > 0)
    tp_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>((const uint32_t*)key, (const float*)lam,
                                                               (long long*)out, n, (int*)rounds, pass);
  return (int)cudaGetLastError();
}

int tb_binomial(const void* key, const void* count, const void* prob, void* out, long long n, int dtype,
                void* rounds, int pass, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    if (dtype == 0)
      tb_kernel<float><<<blocks(n), THREADS, 0, s>>>((const uint32_t*)key, (const float*)count, (const float*)prob,
                                                    (float*)out, n, (int*)rounds, pass);
    else
      tb_kernel<double><<<blocks(n), THREADS, 0, s>>>((const uint32_t*)key, (const double*)count,
                                                     (const double*)prob, (double*)out, n, (int*)rounds, pass);
  }
  return (int)cudaGetLastError();
}

int tm_mrg(const void* state, void* new_state, void* out, long long n, int n_streams, long long steps, int rem,
           int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_streams > 0) {
    if (dtype == 0)
      tm_kernel<float><<<blocks(n_streams), THREADS, 0, s>>>((const int*)state, (int*)new_state, (float*)out, n,
                                                            n_streams, steps, rem, 4.6566126e-10f);
    else
      tm_kernel<double><<<blocks(n_streams), THREADS, 0, s>>>((const int*)state, (int*)new_state, (double*)out, n,
                                                             n_streams, steps, rem, 4.656612873077392578125e-10);
  }
  return (int)cudaGetLastError();
}

const char* random_loops_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
