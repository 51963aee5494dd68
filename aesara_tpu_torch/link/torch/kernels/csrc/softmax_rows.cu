// K4: row softmax and log-softmax over the last axis on Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas kernels `softmax_rows` / `log_softmax_rows`
// (aesara_tpu/link/jax/pallas_kernels.py:89,129), which padded rows to 8
// and columns to 128 with -inf and ran one VMEM tile per 8 rows.  It
// computes what they compute, not how:
//
//   z[r, j]   = x[r, j] - max_j x[r, j]
//   softmax:    out[r, j] = exp(z[r, j]) * (1 / sum_j exp(z[r, j]))
//   log-softmax: out[r, j] = z[r, j] - log(sum_j exp(z[r, j]))
//
// A -inf entry gives 0 (log: -inf), a row that is -inf throughout gives
// nan, and a nan anywhere in a row makes the whole row nan, as
// `jax.nn.softmax` does.  bf16 and fp16 compute in fp32, fp64 in fp64.
//
// What bounds it on the H100: each value is read once and written once
// for a handful of flops, so bytes do: the classifier's (11314, 20) fp32
// is 905 KB each way, 0.0005 ms at 3.35 TB/s.  At that size the launch and
// one chain of dependent steps a block runs (load, max, exp, sum, log,
// store) take the time, so the design keeps that chain short: every value
// in a load slot it uses (no padded columns), no staging, no barrier, no
// instruction for a slot a row does not reach, and a thin launch (one
// ctypes call from the wrapper).  Staging a block's rows through shared
// memory as one span, with 16-byte copies both ways and two barriers, was
// slower at that shape on the H100 than `torch.log_softmax` and than the
// lane groups below.
//
// The wrapper's `launch_plan` (kernels/softmax.py) picks one of three
// regimes from the width n; every access moves the widest of 16, 8, 4 or
// 2 bytes (at least one value) that divides both tensors' addresses and
// the rows' lengths and strides in bytes:
//
// - 0, lane groups: G lanes a row (a power of two, at most a warp) and S
//   vectors a lane (S > 1 only when G = 32), both fixed when compiled and
//   chosen from the row's vectors; a block of `tile` threads takes
//   tile / G rows.  The values stay in registers, a row is reduced by
//   `__shfl_xor_sync` inside its group.  At n = 20 in fp32 a row is five
//   16-byte vectors, so a group of 8 lanes, 4 rows a warp.
// - 1, block rows: `tile` threads a row (one row a block), up to
//   PER_THREAD values a thread in registers, reductions by shuffles and
//   then across the warps in shared memory.
// - 2, two passes: `tile` threads a row.  The first pass keeps each
//   thread's running max and sum, one vector at a time (while a thread has
//   seen only -inf its sum stays 0), and combines the threads' pairs in a
//   fixed tree; the second pass reads the row again and writes it.
//
// Every reduction runs in a fixed order, so two calls on the same inputs
// give the same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int PER_THREAD = 32;        // most values a thread holds in registers (regimes 0, 1)
constexpr int MAX_THREADS = 1024;
constexpr int ROW_MAX_THREADS = 512;  // regimes 0 and 1: up to 128 registers a thread
constexpr unsigned FULL = 0xffffffffu;

// 2-byte floats travel as their bits
struct f16 { unsigned short bits; };
struct bf16 { unsigned short bits; };

template <typename T> struct Elem {  // float and double compute in their own type
  using acc = T;
  static __device__ __forceinline__ T widen(T v) { return v; }
  static __device__ __forceinline__ T narrow(T v) { return v; }
};
template <> struct Elem<f16> {
  using acc = float;
  static __device__ __forceinline__ float widen(f16 v) { return __half2float(__ushort_as_half(v.bits)); }
  static __device__ __forceinline__ f16 narrow(float v) { return f16{__half_as_ushort(__float2half_rn(v))}; }
};
template <> struct Elem<bf16> {
  using acc = float;
  static __device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(__ushort_as_bfloat16(v.bits)); }
  static __device__ __forceinline__ bf16 narrow(float v) {
    return bf16{__bfloat16_as_ushort(__float2bfloat16_rn(v))};
  }
};

template <int BYTES> struct Vec;
template <> struct Vec<16> { using type = uint4; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<4> { using type = unsigned int; };
template <> struct Vec<2> { using type = unsigned short; };

__device__ __forceinline__ float vexp(float v) { return expf(v); }
__device__ __forceinline__ double vexp(double v) { return exp(v); }
__device__ __forceinline__ float vlog(float v) { return logf(v); }
__device__ __forceinline__ double vlog(double v) { return log(v); }
template <typename A> __device__ __forceinline__ A neg_inf() { return -static_cast<A>(INFINITY); }

// the larger of a and b, nan if either is nan (fmax would drop a nan)
template <typename A> __device__ __forceinline__ A vmax(A a, A b) { return (a > b || a != a) ? a : b; }

struct MaxOp {
  template <typename A> __device__ __forceinline__ A operator()(A a, A b) const { return vmax(a, b); }
};
struct SumOp {
  template <typename A> __device__ __forceinline__ A operator()(A a, A b) const { return a + b; }
};

// `v` reduced over G lanes (a power of two, at most 32) that a warp's
// lanes form in order: every lane of the group gets the same bits
template <int G, typename A, typename Op>
__device__ __forceinline__ A lane_reduce(A v, Op op) {
#pragma unroll
  for (int off = G >> 1; off > 0; off >>= 1) v = op(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// `v` reduced over the `tpr` threads of a row: a warp, or the whole block
// (then `red` holds one value a warp, added in warp order by every thread)
template <typename A, typename Op>
__device__ __forceinline__ A row_reduce(A v, int tpr, A* red, Op op) {
  v = lane_reduce<32>(v, op);
  if (tpr > 32) {
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
    __syncthreads();
    v = red[0];
    for (int w = 1; w < tpr / 32; ++w) v = op(v, red[w]);
    __syncthreads();  // red is written again by the next reduction
  }
  return v;
}

// Regime 0: G lanes a row (a power of two, at most a warp), S vectors of VB
// bytes a lane in registers, both fixed when compiled; a slot past the
// row's end holds -inf, so no lane tests a slot in its arithmetic.
template <typename T, int VB, int G, int S>
__global__ void __launch_bounds__(ROW_MAX_THREADS)
softmax_group_kernel(const T* __restrict__ x, T* __restrict__ out, long long m, int n, long long ld,
                     int log_softmax) {
  using A = typename Elem<T>::acc;
  using V = typename Vec<VB>::type;
  constexpr int VE = VB / sizeof(T);
  const int lane = threadIdx.x % G;
  const long long row = (long long)blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
  const bool active = row < m;
  const int nv = n / VE;
  const V* xr = reinterpret_cast<const V*>(x + row * ld);
  A v[S][VE];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    T e[VE];
    if (active && lane + i * G < nv) {
      const V raw = xr[lane + i * G];
      memcpy(e, &raw, sizeof(V));
#pragma unroll
      for (int q = 0; q < VE; ++q) v[i][q] = Elem<T>::widen(e[q]);
    } else {
#pragma unroll
      for (int q = 0; q < VE; ++q) v[i][q] = neg_inf<A>();
    }
  }
  A mx = neg_inf<A>();
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int q = 0; q < VE; ++q) mx = vmax(mx, v[i][q]);
  mx = lane_reduce<G>(mx, MaxOp());
  A sum = A(0);
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int q = 0; q < VE; ++q) {
      const A z = v[i][q] - mx, e = vexp(z);
      sum += e;
      v[i][q] = log_softmax ? z : e;
    }
  sum = lane_reduce<G>(sum, SumOp());
  const A scale = log_softmax ? vlog(sum) : A(1) / sum;
  V* outr = reinterpret_cast<V*>(out + row * n);
#pragma unroll
  for (int i = 0; i < S; ++i) {
    if (active && lane + i * G < nv) {
      T e[VE];
#pragma unroll
      for (int q = 0; q < VE; ++q) e[q] = Elem<T>::narrow(log_softmax ? v[i][q] - scale : v[i][q] * scale);
      V raw;
      memcpy(&raw, e, sizeof(V));
      outr[lane + i * G] = raw;
    }
  }
}

// Regime 1: one row a block, VB-byte accesses, up to PER_THREAD values a
// thread in registers.
template <typename T, int VB>
__global__ void __launch_bounds__(ROW_MAX_THREADS)
softmax_block_kernel(const T* __restrict__ x, T* __restrict__ out, int n, long long ld, int log_softmax) {
  using A = typename Elem<T>::acc;
  using V = typename Vec<VB>::type;
  constexpr int VE = VB / sizeof(T), SLOTS = PER_THREAD / VE;
  __shared__ A red[ROW_MAX_THREADS / 32];
  const int t = threadIdx.x, tpr = blockDim.x;
  const long long row = blockIdx.x;
  const int nv = n / VE;
  const V* xr = reinterpret_cast<const V*>(x + row * ld);
  V* outr = reinterpret_cast<V*>(out + row * n);
  A v[SLOTS][VE];
  A mx = neg_inf<A>();
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    const int k = t + i * tpr;
    if (k < nv) {
      const V raw = xr[k];
      T e[VE];
      memcpy(e, &raw, sizeof(V));
#pragma unroll
      for (int q = 0; q < VE; ++q) {
        v[i][q] = Elem<T>::widen(e[q]);
        mx = vmax(mx, v[i][q]);
      }
    }
  }
  mx = row_reduce(mx, tpr, red, MaxOp());
  A sum = A(0);
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    if (t + i * tpr < nv) {
#pragma unroll
      for (int q = 0; q < VE; ++q) {
        const A z = v[i][q] - mx, e = vexp(z);
        sum += e;
        v[i][q] = log_softmax ? z : e;
      }
    }
  }
  sum = row_reduce(sum, tpr, red, SumOp());
  const A scale = log_softmax ? vlog(sum) : A(1) / sum;
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    const int k = t + i * tpr;
    if (k < nv) {
      T e[VE];
#pragma unroll
      for (int q = 0; q < VE; ++q) e[q] = Elem<T>::narrow(log_softmax ? v[i][q] - scale : v[i][q] * scale);
      V raw;
      memcpy(&raw, e, sizeof(V));
      outr[k] = raw;
    }
  }
}

// (m, s) and (m2, s2), each a max and the sum of exp(value - max), as one
// pair; a pair whose max is -inf has seen only -inf and has sum 0
template <typename A>
__device__ __forceinline__ void combine(A& m, A& s, A m2, A s2) {
  const A mn = vmax(m, m2);
  s = mn == neg_inf<A>() ? A(0) : s * vexp(m - mn) + s2 * vexp(m2 - mn);
  m = mn;
}

// Regime 2: one row a block of any width, read twice.
template <typename T, int VB>
__global__ void __launch_bounds__(MAX_THREADS)
softmax_two_pass_kernel(const T* __restrict__ x, T* __restrict__ out, int n, long long ld, int log_softmax) {
  using A = typename Elem<T>::acc;
  using V = typename Vec<VB>::type;
  constexpr int VE = VB / sizeof(T);
  __shared__ A red_m[MAX_THREADS / 32], red_s[MAX_THREADS / 32];
  const long long row = blockIdx.x;
  const V* xr = reinterpret_cast<const V*>(x + row * ld);
  V* outr = reinterpret_cast<V*>(out + row * n);
  const int nv = n / VE;
  A m = neg_inf<A>(), s = A(0);
  for (int k = threadIdx.x; k < nv; k += blockDim.x) {
    const V raw = xr[k];
    T e[VE];
    memcpy(e, &raw, sizeof(V));
    A c[VE];
    A cm = neg_inf<A>();
#pragma unroll
    for (int q = 0; q < VE; ++q) {
      c[q] = Elem<T>::widen(e[q]);
      cm = vmax(cm, c[q]);
    }
    const A mn = vmax(m, cm);
    if (mn != neg_inf<A>()) {  // while a thread has seen only -inf, its sum stays 0
      A add = A(0);
#pragma unroll
      for (int q = 0; q < VE; ++q) add += vexp(c[q] - mn);
      s = s * vexp(m - mn) + add;
      m = mn;
    }
  }
  // the threads' pairs: a butterfly inside each warp, then the warps' in order
  for (int off = 16; off > 0; off >>= 1) {
    const A m2 = __shfl_xor_sync(FULL, m, off), s2 = __shfl_xor_sync(FULL, s, off);
    combine(m, s, m2, s2);
  }
  if (threadIdx.x % 32 == 0) {
    red_m[threadIdx.x / 32] = m;
    red_s[threadIdx.x / 32] = s;
  }
  __syncthreads();
  m = red_m[0];
  s = red_s[0];
  for (int w = 1; w < (int)blockDim.x / 32; ++w) combine(m, s, red_m[w], red_s[w]);
  const A scale = log_softmax ? vlog(s) : A(1) / s;
  for (int k = threadIdx.x; k < nv; k += blockDim.x) {
    const V raw = xr[k];
    T e[VE];
    memcpy(e, &raw, sizeof(V));
#pragma unroll
    for (int q = 0; q < VE; ++q) {
      const A z = Elem<T>::widen(e[q]) - m;
      e[q] = Elem<T>::narrow(log_softmax ? z - scale : vexp(z) * scale);
    }
    V o;
    memcpy(&o, e, sizeof(V));
    outr[k] = o;
  }
}

// the launch floor: a kernel that does nothing, on K4's grid
__global__ void floor_kernel() {}

struct Geometry {
  long long blocks;
  int threads, group, slots, vb;
};

// The grid of one launch, or false where the regime does not take these
// rows (see the header).
bool geometry(const void* x, const void* out, long long m, int n, long long ld, int itemsize, int regime,
              int tile, Geometry& g) {
  if (m <= 0 || n <= 0 || ld < 0 || tile < 32 || tile % 32) return false;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
                         static_cast<uintptr_t>(ld * itemsize) | static_cast<uintptr_t>((long long)n * itemsize);
  g.vb = itemsize;
  for (int vb = 16; vb > itemsize; vb /= 2)
    if (bits % vb == 0) {
      g.vb = vb;
      break;
    }
  const int ve = g.vb / itemsize, nv = n / ve;
  g.group = 1;
  g.slots = 1;
  g.threads = tile;
  switch (regime) {
    case 0:
      if (tile > ROW_MAX_THREADS) return false;
      while (g.group < nv && g.group < 32) g.group *= 2;
      while (g.group * g.slots < nv) g.slots *= 2;
      if (g.slots * ve > PER_THREAD) return false;
      g.blocks = (m + tile / g.group - 1) / (tile / g.group);
      break;
    case 1:
      // one pass: the block's registers hold the row
      if (tile > ROW_MAX_THREADS || n > tile * PER_THREAD) return false;
      g.blocks = m;
      break;
    case 2:
      if (tile > MAX_THREADS) return false;
      g.blocks = m;
      break;
    default:
      return false;
  }
  return g.blocks < (1LL << 31);
}

template <typename T, int VB, int G, int S>
cudaError_t run_group(const Geometry& g, cudaStream_t s, const T* x, T* out, long long m, int n, long long ld,
                      int log_softmax) {
  softmax_group_kernel<T, VB, G, S><<<dim3((unsigned)g.blocks), g.threads, 0, s>>>(x, out, m, n, ld, log_softmax);
  return cudaGetLastError();
}

// regime 0 at the group and slots `geometry` chose
template <typename T, int VB>
cudaError_t launch_group(const Geometry& g, cudaStream_t s, const T* x, T* out, long long m, int n, long long ld,
                         int log_softmax) {
  constexpr int MAX_S = PER_THREAD * (int)sizeof(T) / VB;
#define K4_GROUP(G, S) return run_group<T, VB, G, S>(g, s, x, out, m, n, ld, log_softmax)
  if (g.slots == 1) {
    switch (g.group) {
      case 1: K4_GROUP(1, 1);
      case 2: K4_GROUP(2, 1);
      case 4: K4_GROUP(4, 1);
      case 8: K4_GROUP(8, 1);
      case 16: K4_GROUP(16, 1);
      case 32: K4_GROUP(32, 1);
    }
  } else if (g.group == 32) {
    switch (g.slots) {
      case 2: if constexpr (MAX_S >= 2) K4_GROUP(32, 2); break;
      case 4: if constexpr (MAX_S >= 4) K4_GROUP(32, 4); break;
      case 8: if constexpr (MAX_S >= 8) K4_GROUP(32, 8); break;
      case 16: if constexpr (MAX_S >= 16) K4_GROUP(32, 16); break;
      case 32: if constexpr (MAX_S >= 32) K4_GROUP(32, 32); break;
    }
  }
#undef K4_GROUP
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(const void* xv, void* ov, long long m, int n, long long ld, int log_softmax, int regime,
                   int tile, cudaStream_t s) {
  Geometry g;
  if (!geometry(xv, ov, m, n, ld, sizeof(T), regime, tile, g)) return cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(ov);
  if (regime == 0) {
    switch (g.vb) {
      case 16: return launch_group<T, 16>(g, s, x, out, m, n, ld, log_softmax);
      case 8: if constexpr (sizeof(T) <= 8) return launch_group<T, 8>(g, s, x, out, m, n, ld, log_softmax); break;
      case 4: if constexpr (sizeof(T) <= 4) return launch_group<T, 4>(g, s, x, out, m, n, ld, log_softmax); break;
      case 2: if constexpr (sizeof(T) <= 2) return launch_group<T, 2>(g, s, x, out, m, n, ld, log_softmax); break;
    }
    return cudaErrorInvalidValue;
  }
  // the row regimes read 16 bytes or one value an access
  const dim3 grid((unsigned)g.blocks);
  if (regime == 1) {
    if (g.vb == 16)
      softmax_block_kernel<T, 16><<<grid, g.threads, 0, s>>>(x, out, n, ld, log_softmax);
    else
      softmax_block_kernel<T, sizeof(T)><<<grid, g.threads, 0, s>>>(x, out, n, ld, log_softmax);
  } else if (g.vb == 16) {
    softmax_two_pass_kernel<T, 16><<<grid, g.threads, 0, s>>>(x, out, n, ld, log_softmax);
  } else {
    softmax_two_pass_kernel<T, sizeof(T)><<<grid, g.threads, 0, s>>>(x, out, n, ld, log_softmax);
  }
  return cudaGetLastError();
}

const int ITEMSIZE[] = {4, 8, 2, 2};

}  // namespace

// x: m rows of n values, `ld` values apart; out: m rows of n values, one
// after the other.  dtype codes: 0 float32, 1 float64, 2 float16,
// 3 bfloat16.  regime and tile as `launch_plan` in kernels/softmax.py gives
// them (see the header).  Returns a cudaError_t.
extern "C" int softmax_rows(const void* x, void* out, long long m, int n, long long ld, int dtype,
                            int log_softmax, int regime, int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(x, out, m, n, ld, log_softmax, regime, tile, s);
    case 1: return (int)launch<double>(x, out, m, n, ld, log_softmax, regime, tile, s);
    case 2: return (int)launch<f16>(x, out, m, n, ld, log_softmax, regime, tile, s);
    case 3: return (int)launch<bf16>(x, out, m, n, ld, log_softmax, regime, tile, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch floor: the same arguments, the same grid and block as
// `softmax_rows`, and a kernel that does nothing.
extern "C" int softmax_rows_floor(const void* x, void* out, long long m, int n, long long ld, int dtype,
                                  int log_softmax, int regime, int tile, void* stream) {
  Geometry g;
  if (dtype < 0 || dtype > 3 || !geometry(x, out, m, n, ld, ITEMSIZE[dtype], regime, tile, g))
    return (int)cudaErrorInvalidValue;
  (void)log_softmax;
  floor_kernel<<<dim3((unsigned)g.blocks), g.threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* softmax_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
