// K5, K6 and K7: products of a CSR matrix on Hopper (sm_90a), plain C
// interface.
//
// K5 `csr_spmv` replaces the Pallas kernel `bss_matmul`
// (aesara_tpu/link/jax/bss.py:197), K6 `csr_spmm` replaces
// `_bss_matmul_wide` (bss.py:271), K7 `csr_sddmm` replaces `bss_sddmm`
// (bss.py:354).  They compute what those compute, not how: the TPU kernels
// worked on a blocked segment-slot layout because Mosaic has one gather
// shape; a GPU gathers freely, so these read plain CSR (int32 indptr and
// indices, values in the matrix's own dtype).
//
//   K5, K6:  out[r, :] = sum_k data[k] * b[indices[k], :]  for k in row r
//   K7:      out_data[k] = dot(gz[r, :], b[indices[k], :])  for k in row r
//
// What bounds them on the H100: each stored entry is read once (8 bytes)
// and pulls one rhs row of C values through the cache for 2*C flops, so
// all three are bound by memory traffic (HBM and, for scattered rhs rows,
// L2), never by arithmetic.  None uses atomics, so the results do not
// depend on scheduling.
//
// K5 (narrow rhs, C small): one warp per row; lanes stride over the row's
// entries and keep one accumulator per rhs column (columns in groups of up
// to 8 registers); a warp-shuffle reduction ends the row.
//
// K6 (wide rhs) splits the work by entries, not by rows: the merge-based
// CSR split of Merrill & Garland (SC 2016).  The merged sequence of the n
// row ends and the nnz entries (row r's end sits after its last entry, at
// position r + indptr[r + 1]) is cut into chunks of a fixed number of
// items; the plan holds the row at which each chunk starts (a diagonal
// search of indptr, made by `spmm_plan` in kernels/sparse.py), so a chunk
// covers rows i0..i1 and entries j0..j1 - 1 with (i1 - i0) + (j1 - j0) at
// most the chunk size.  One warp takes one chunk:
//
// - The chunk's row ends, indices and values are one contiguous range
//   each; they are staged into shared memory with cp.async in two groups,
//   and the rows of the first half start while the second is in flight.
// - Lanes go over entries and vector columns: a group of G lanes reads one
//   entry's rhs row with 16-, 8-, 4- or 2-byte loads (the widest that C,
//   the dtype and the rhs's alignment allow, a template parameter), and
//   32 / G groups take 32 / G entries a step, four steps unrolled, so a
//   lane keeps four gathers in flight.  At C = 20 in fp32 that is 5 lanes
//   of 16 bytes each, 6 entries a step on 30 of the 32 lanes.  A rhs wider
//   than 32 vectors is walked in tiles of 32 vectors inside the warp.
// - At a row's end the groups' partial sums meet in shared memory and are
//   added in group order; lanes write the row's C values, coalesced.
// - Short rows (at most a few steps' entries in the chunk, empty ones too;
//   most rows of a transposed bag-of-words matrix) go one to a group
//   instead, up to 32 / G rows at once, each summed in entry order by its
//   group alone: the rows' gathers overlap and no reduction is needed.
// - The rows that end inside the chunk are written; the row cut by the
//   chunk's end leaves its partial sum in the carry buffer (one row of C
//   values per chunk).  A second pass adds, for each row that started
//   before the chunk that ends it, the carries of the chunks it spans, in
//   chunk order, to what that chunk wrote.
//
// So a row of 10,909 entries (a common word in a classifier's transposed
// design matrix) is the work of some 85 warps (chunks of 128 items), and
// the time follows the bytes, not the longest row.  The chunk size is a
// constant of the plan, not of the card, and every sum runs in a fixed
// order: two calls on the same inputs give the same bits.  Tensor cores
// buy nothing here: at C = 20 the product does 2 flops per 4-byte rhs
// value gathered from a scattered row, far below what a wgmma tile needs
// to pay for itself, and TMA's tiled copies do not gather rows.
//
// K7 (`csr_sddmm_kernel`) writes one value per stored entry, so what
// bounds it is the same gather: each entry pulls its b row through L2, at
// C = 20 in float32 80 bytes that always touch three 32-byte sectors (96
// bytes an entry, some 129 MB for the GLM's 1.34 M entries), beside 8
// bytes of index and output and the gz rows, read once a row.  It takes
// K6's plan (the same chunks: one plan serves both), so the load follows
// the entries, not the rows:
//
// - One warp takes one chunk; cp.async stages the chunk's row ends and
//   indices (no values: K7 reads none of x's).
// - A group of G lanes reads one entry's b row with the widest vector
//   load that C, the dtype, the operands' addresses and their row strides
//   allow (`spmm_vector_bytes`); 32 / G groups take consecutive entries, a
//   step.  C = 20 in float32 is 5 lanes of 16 bytes, 6 entries a step.
//   One step is in flight a group: on the H100 two or four (unrolled)
//   held more registers, fitted fewer warps an SM and were no faster
//   (PERF.md); the other warps keep the gathers coming.
// - A group finds its entry's row by walking the staged row ends forward
//   (rows only increase along a chunk) and keeps its slice of gz[row] in
//   registers, reloading it only when the row changes.
// - The group's partial dots meet in a shuffle tree of fixed shape, and
//   the first lane of each group writes the entry's value: a step's
//   outputs are contiguous.  Every output belongs to one entry and one
//   warp, so there is no carry and no fix-up pass, and two calls give the
//   same bits.
// - A row of more than 32 vectors is walked in tiles of 32 inside the
//   warp (one entry a step), each lane adding its tiles in order.
// - A row of one vector (C = 1, or up to 16 bytes) needs no group and no
//   reduction: `csr_sddmm_lane_kernel` gives each lane one entry of the
//   chunk at a time and stages nothing, which keeps its registers few and
//   its warps many.  On the H100 the staged kernel with one-lane groups
//   lost at C = 1 to the row-per-warp kernel this replaces; this one
//   does not (PERF.md).
//
// Implicit zeros never touch the rhs, so an inf or nan there poisons
// exactly the rows whose stored pattern hits it; a stored zero times inf
// gives nan, as in SciPy.  Accumulation is float32 for float32 values
// (also with a bfloat16 rhs) and float64 for float64 values.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <string.h>

namespace {

constexpr int WARPS = 8;               // warps (rows) per block of K5
constexpr int THREADS = WARPS * 32;
constexpr int SPMM_WARPS = 4;          // warps (chunks) per block of K6
constexpr int SPMM_THREADS = SPMM_WARPS * 32;
constexpr int SPMM_UNROLL = 4;         // gathers in flight per lane
constexpr int SDDMM_WARPS = 4;         // warps (chunks) per block of K7
constexpr int SDDMM_THREADS = SDDMM_WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_acc(float x, float) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x, float) { return __bfloat162float(x); }
__device__ __forceinline__ double to_acc(double x, double) { return x; }

template <typename ACC>
__device__ __forceinline__ ACC warp_sum(ACC v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  return v;
}

// K5: C rhs columns in groups of CB accumulators.
template <typename T, typename TB, typename ACC, int CB>
__global__ void __launch_bounds__(THREADS)
csr_spmv_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                const T* __restrict__ data, const TB* __restrict__ b, T* __restrict__ out,
                int n, int C) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;                 // the whole warp leaves together
  const int start = indptr[row], end = indptr[row + 1];
  for (int c0 = 0; c0 < C; c0 += CB) {
    ACC acc[CB];
#pragma unroll
    for (int c = 0; c < CB; ++c) acc[c] = ACC(0);
    for (int k = start + lane; k < end; k += 32) {
      const ACC v = ACC(data[k]);
      const TB* brow = b + (long long)indices[k] * C + c0;
#pragma unroll
      for (int c = 0; c < CB; ++c)
        if (c0 + c < C) acc[c] += v * to_acc(brow[c], ACC(0));
    }
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      const ACC s = warp_sum(acc[c]);
      if (lane == 0 && c0 + c < C) out[(long long)row * C + c0 + c] = T(s);
    }
  }
}

// ---- K6 -------------------------------------------------------------------

template <int BYTES> struct Vec;
template <> struct Vec<16> { using type = uint4; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<4> { using type = unsigned int; };
template <> struct Vec<2> { using type = unsigned short; };

// a rhs element in the accumulator's type; a bfloat16 rhs arrives as its
// 16 bits, the upper half of the float32 with the same value
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ float widen(unsigned short x) { return __uint_as_float(unsigned(x) << 16); }

template <typename TB, typename ACC, int EV, typename VT>
__device__ __forceinline__ void fma_vec(ACC (&acc)[EV], ACC a, VT x) {
  static_assert(sizeof(VT) == EV * sizeof(TB), "one vector holds EV rhs values");
  TB e[EV];
  memcpy(e, &x, sizeof(VT));
#pragma unroll
  for (int q = 0; q < EV; ++q) acc[q] += a * ACC(widen(e[q]));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(BYTES) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// shared memory of one warp: the groups' partial sums (32 lanes x EV),
// then the chunk's values, indices and row ends, at most `chunk` each
template <typename T, typename ACC, int EV>
__host__ __device__ constexpr size_t spmm_warp_bytes(int chunk) {
  return (32 * EV * sizeof(ACC) + (size_t)chunk * (sizeof(T) + 2 * sizeof(int)) + 15) / 16 * 16;
}

template <typename T, typename TB, typename ACC, int VB>
__global__ void __launch_bounds__(SPMM_THREADS)
csr_spmm_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                const T* __restrict__ data, const TB* __restrict__ b, T* __restrict__ out,
                T* __restrict__ carry, const int* __restrict__ plan, int n, int nnz, int C,
                int chunk, int nchunks, int short_factor) {
  using VT = typename Vec<VB>::type;
  constexpr int EV = VB / sizeof(TB);
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * SPMM_WARPS + warp;
  if (c >= nchunks) return;             // the whole warp leaves together
  unsigned char* base = smem + warp * spmm_warp_bytes<T, ACC, EV>(chunk);
  ACC* s_red = reinterpret_cast<ACC*>(base);
  T* s_val = reinterpret_cast<T*>(base + 32 * EV * sizeof(ACC));
  int* s_idx = reinterpret_cast<int*>(s_val + chunk);
  int* s_end = s_idx + chunk;

  const long long total = (long long)n + nnz;
  const int d0 = (int)min((long long)c * chunk, total), d1 = (int)min((long long)(c + 1) * chunk, total);
  const int i0 = plan[c], i1 = plan[c + 1];
  const int j0 = d0 - i0, j1 = d1 - i1;
  const int n_end = i1 - i0, n_ent = j1 - j0, half = (n_ent + 1) >> 1;

  // stage: group 0 the row ends and the first half of the entries, group 1
  // the rest
  for (int t = lane; t < n_end; t += 32) cp_async<4>(s_end + t, indptr + i0 + 1 + t);
  for (int t = lane; t < half; t += 32) {
    cp_async<4>(s_idx + t, indices + j0 + t);
    cp_async<sizeof(T)>(s_val + t, data + j0 + t);
  }
  cp_async_commit();
  for (int t = half + lane; t < n_ent; t += 32) {
    cp_async<4>(s_idx + t, indices + j0 + t);
    cp_async<sizeof(T)>(s_val + t, data + j0 + t);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncwarp();
  bool staged = false;                  // group 1 arrived (warp-uniform)

  // row r's entries in this chunk, as offsets into the staged arrays; the
  // row ending after the chunk (r == i1) runs to the chunk's end
  auto row_lo = [&](int r) { return r == i0 ? 0 : s_end[r - 1 - i0] - j0; };
  auto row_hi = [&](int r) { return r < i1 ? s_end[r - i0] - j0 : n_ent; };

  const int NV = C / EV;                // vectors in a rhs row
  const int last = i1 < n ? i1 : n - 1; // row i1, cut by the chunk's end, goes to the carry
  for (int v0 = 0; v0 < NV; v0 += 32) {
    const int G = min(32, NV - v0), groups = 32 / G;
    const int g = lane / G, p = lane - g * G;
    const int width = G * EV, col0 = v0 * EV;
    const int short_max = short_factor * groups;
    const VT* bp = reinterpret_cast<const VT*>(b) + v0 + p;
    for (int r = i0; r <= last;) {
      // short rows (empty ones too) go one to a group, up to `groups` at once
      int nb = 0;
      while (nb < groups && r + nb <= last && row_hi(r + nb) - row_lo(r + nb) <= short_max) ++nb;
      const int hi = row_hi(nb ? r + nb - 1 : r);
      if (!staged && hi > half) {
        cp_async_wait<0>();
        __syncwarp();
        staged = true;
      }
      ACC acc[EV];
#pragma unroll
      for (int q = 0; q < EV; ++q) acc[q] = ACC(0);
      if (nb) {
        if (g < nb) {
          const int rr = r + g;
          int kk = row_lo(rr);
          const int kend = row_hi(rr);
          for (; kk + SPMM_UNROLL - 1 < kend; kk += SPMM_UNROLL) {
            VT x[SPMM_UNROLL];
#pragma unroll
            for (int u = 0; u < SPMM_UNROLL; ++u) x[u] = __ldg(bp + (long long)s_idx[kk + u] * NV);
#pragma unroll
            for (int u = 0; u < SPMM_UNROLL; ++u) fma_vec<TB, ACC, EV>(acc, ACC(s_val[kk + u]), x[u]);
          }
          for (; kk < kend; ++kk) fma_vec<TB, ACC, EV>(acc, ACC(s_val[kk]), __ldg(bp + (long long)s_idx[kk] * NV));
          T* dst = (rr < i1 ? out + (long long)rr * C : carry + (long long)c * C) + col0 + p * EV;
#pragma unroll
          for (int q = 0; q < EV; ++q) dst[q] = T(acc[q]);
        }
        r += nb;
        continue;
      }
      // a long row: every group takes every groups-th entry
      const int lo = row_lo(r);
      if (g < groups) {
        int kk = lo + g;
        for (; kk + (SPMM_UNROLL - 1) * groups < hi; kk += SPMM_UNROLL * groups) {
          VT x[SPMM_UNROLL];
#pragma unroll
          for (int u = 0; u < SPMM_UNROLL; ++u) x[u] = __ldg(bp + (long long)s_idx[kk + u * groups] * NV);
#pragma unroll
          for (int u = 0; u < SPMM_UNROLL; ++u) fma_vec<TB, ACC, EV>(acc, ACC(s_val[kk + u * groups]), x[u]);
        }
        for (; kk < hi; kk += groups)
          fma_vec<TB, ACC, EV>(acc, ACC(s_val[kk]), __ldg(bp + (long long)s_idx[kk] * NV));
      }
      // the groups' sums meet in shared memory and are added in group order
      const int used = min(groups, hi - lo);
      if (g < used) {
#pragma unroll
        for (int q = 0; q < EV; ++q) s_red[lane * EV + q] = acc[q];
      }
      __syncwarp();
      T* dst = (r < i1 ? out + (long long)r * C : carry + (long long)c * C) + col0;
      for (int e = lane; e < width; e += 32) {
        ACC s = s_red[e];
        for (int h = 1; h < used; ++h) s += s_red[h * width + e];
        dst[e] = T(s);
      }
      __syncwarp();
      ++r;
    }
  }
  cp_async_wait<0>();                   // no copy outlives the warp
}

// K6's second pass: chunk c ends row r = plan[c]; if r started before the
// chunk, add the carries of the chunks c' < c that r spans (those with
// plan[c' + 1] == r), in chunk order, to the partial sum chunk c wrote.
template <typename T>
__global__ void __launch_bounds__(SPMM_THREADS)
csr_spmm_fixup_kernel(const int* __restrict__ indptr, const int* __restrict__ plan,
                      const T* __restrict__ carry, T* __restrict__ out, int n, int nnz, int C,
                      int chunk, int nchunks) {
  const int c = blockIdx.x * SPMM_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c == 0 || c >= nchunks) return;
  const int r = plan[c];
  if (r >= plan[c + 1]) return;         // the chunk ends no row
  const int j0 = (int)min((long long)c * chunk, (long long)n + nnz) - r;
  if (indptr[r] >= j0) return;          // row r starts in this chunk
  int first = c - 1;
  while (first > 0 && plan[first] == r) --first;
  T* o = out + (long long)r * C;
  for (int col = lane; col < C; col += 32) {
    T s = carry[(long long)first * C + col];
    for (int cc = first + 1; cc < c; ++cc) s += carry[(long long)cc * C + col];
    o[col] = s + o[col];
  }
}

// ---- K7 -------------------------------------------------------------------

// shared memory of one K7 warp: the chunk's indices and row ends
__host__ __device__ constexpr size_t sddmm_warp_bytes(int chunk) {
  return ((size_t)chunk * 2 * sizeof(int) + 15) / 16 * 16;
}

template <typename T, typename ACC, int EV, typename VT>
__device__ __forceinline__ ACC dot_vec(VT x, VT y) {
  static_assert(sizeof(VT) == EV * sizeof(T), "one vector holds EV values");
  T a[EV], b[EV];
  memcpy(a, &x, sizeof(VT));
  memcpy(b, &y, sizeof(VT));
  ACC s = ACC(a[0]) * ACC(b[0]);
#pragma unroll
  for (int q = 1; q < EV; ++q) s += ACC(a[q]) * ACC(b[q]);
  return s;
}

// the sum of the G partials of a lane group, in lane p == 0 of the group:
// a tree of fixed shape, so the order of the additions never changes
template <typename ACC>
__device__ __forceinline__ ACC group_sum(ACC s, int p, int G) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    if (off >= G) break;                // G is the same in every lane
    const ACC o = __shfl_down_sync(FULL, s, off);
    if ((p & (2 * off - 1)) == 0 && p + off < G) s += o;
  }
  return s;
}

// chunk c of the plan: rows i0..i1, entries j0..j0 + n_ent - 1
struct Chunk {
  int i0, i1, j0, n_ent;
};

__device__ __forceinline__ Chunk chunk_at(const int* __restrict__ plan, int c, int chunk, int n, int nnz) {
  const long long total = (long long)n + nnz;
  const int i0 = plan[c], i1 = plan[c + 1];
  const int d0 = (int)min((long long)c * chunk, total), d1 = (int)min((long long)(c + 1) * chunk, total);
  return {i0, i1, d0 - i0, (d1 - i1) - (d0 - i0)};
}

// K7: gz is (n, C) with rows ld_gz values apart, b is (d, C) with rows
// ld_b apart (both multiples of the vector); out has one value per stored
// entry, in x's entry order.  WIDE: more than 32 vectors a row.
template <typename T, typename ACC, int VB, bool WIDE>
__global__ void __launch_bounds__(SDDMM_THREADS)
csr_sddmm_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                 const T* __restrict__ gz, const T* __restrict__ b, T* __restrict__ out,
                 const int* __restrict__ plan, int n, int nnz, int C, long long ld_gz,
                 long long ld_b, int chunk, int nchunks) {
  using VT = typename Vec<VB>::type;
  constexpr int EV = VB / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * SDDMM_WARPS + warp;
  if (c >= nchunks) return;             // the whole warp leaves together
  int* s_idx = reinterpret_cast<int*>(smem + warp * sddmm_warp_bytes(chunk));
  int* s_end = s_idx + chunk;
  const Chunk k = chunk_at(plan, c, chunk, n, nnz);
  const int i0 = k.i0, i1 = k.i1, j0 = k.j0, n_ent = k.n_ent;
  if (n_ent == 0) return;               // only row ends: nothing to write

  for (int t = lane; t < i1 - i0; t += 32) cp_async<4>(s_end + t, indptr + i0 + 1 + t);
  for (int t = lane; t < n_ent; t += 32) cp_async<4>(s_idx + t, indices + j0 + t);
  cp_async_commit();

  const int NV = C / EV;                // vectors in a row
  const int G = WIDE ? 32 : NV, groups = 32 / G;
  const int g = lane / G, p = lane - g * G;
  const long long gz_ld = ld_gz / EV, b_ld = ld_b / EV;
  const VT* gp = reinterpret_cast<const VT*>(gz) + p;
  const VT* bp = reinterpret_cast<const VT*>(b) + p;
  cp_async_wait<0>();
  __syncwarp();

  // the row of the group's latest entry and the offset at which it ends in
  // the chunk (row i1, cut by the chunk's end, runs to n_ent); the group's
  // slice of gz at that row (one tile only)
  int r = i0, r_hi = i0 < i1 ? s_end[0] - j0 : n_ent;
  int gz_row = -1;
  VT gv;
  for (int t0 = 0; t0 < n_ent; t0 += groups) {
    const int t = t0 + g;
    const bool ok = g < groups && t < n_ent;
    ACC part = ACC(0);
    if (ok) {
      while (t >= r_hi) {
        ++r;
        r_hi = r < i1 ? s_end[r - i0] - j0 : n_ent;
      }
      const VT* bu = bp + s_idx[t] * b_ld;
      if (!WIDE) {
        const VT x = __ldg(bu);          // the gather goes out before gz is looked at
        if (r != gz_row) {
          gz_row = r;
          gv = __ldg(gp + gz_row * gz_ld);
        }
        part = dot_vec<T, ACC, EV>(gv, x);
      } else {
        const VT* gu = gp + r * gz_ld;
        for (int v = 0; v + p < NV; v += 32) part += dot_vec<T, ACC, EV>(__ldg(gu + v), __ldg(bu + v));
      }
    }
    const ACC sum = group_sum(part, p, G);
    if (p == 0 && ok) out[j0 + t] = T(sum);
  }
}

// K7 for a row of one vector (C times the item size is the load, 16 bytes
// at most; C = 1 among them): one entry a lane, lanes on consecutive
// entries of the chunk, each walking indptr forward to its entry's row.
// Nothing to reduce, so nothing is staged: the lanes read their indices
// themselves, coalesced, and a lane holds few registers, so many warps fit
// an SM.
template <typename T, typename ACC, int VB>
__global__ void __launch_bounds__(SDDMM_THREADS)
csr_sddmm_lane_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                      const T* __restrict__ gz, const T* __restrict__ b, T* __restrict__ out,
                      const int* __restrict__ plan, int n, int nnz, long long ld_gz, long long ld_b,
                      int chunk, int nchunks) {
  using VT = typename Vec<VB>::type;
  constexpr int EV = VB / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * SDDMM_WARPS + (threadIdx.x >> 5);
  if (c >= nchunks) return;
  const Chunk k = chunk_at(plan, c, chunk, n, nnz);
  const int i0 = k.i0, i1 = k.i1, j0 = k.j0, n_ent = k.n_ent;
  const VT* gp = reinterpret_cast<const VT*>(gz);
  const VT* bp = reinterpret_cast<const VT*>(b);
  const long long gz_ld = ld_gz / EV, b_ld = ld_b / EV;
  int r = i0, r_hi = i0 < i1 ? __ldg(indptr + i0 + 1) - j0 : n_ent;
  for (int t = lane; t < n_ent; t += 32) {
    while (t >= r_hi) {
      ++r;
      r_hi = r < i1 ? __ldg(indptr + r + 1) - j0 : n_ent;
    }
    const VT x = __ldg(bp + __ldg(indices + j0 + t) * b_ld);
    out[j0 + t] = T(dot_vec<T, ACC, EV>(__ldg(gp + r * gz_ld), x));
  }
}

template <typename T, typename TB, typename ACC>
cudaError_t launch_spmv(const int* indptr, const int* indices, const void* data, const void* b,
                        void* out, int n, int C, cudaStream_t stream) {
  const dim3 grid((n + WARPS - 1) / WARPS);
  const T* d = static_cast<const T*>(data);
  const TB* bb = static_cast<const TB*>(b);
  T* o = static_cast<T*>(out);
  if (C == 1)
    csr_spmv_kernel<T, TB, ACC, 1><<<grid, THREADS, 0, stream>>>(indptr, indices, d, bb, o, n, C);
  else if (C == 2)
    csr_spmv_kernel<T, TB, ACC, 2><<<grid, THREADS, 0, stream>>>(indptr, indices, d, bb, o, n, C);
  else if (C <= 4)
    csr_spmv_kernel<T, TB, ACC, 4><<<grid, THREADS, 0, stream>>>(indptr, indices, d, bb, o, n, C);
  else
    csr_spmv_kernel<T, TB, ACC, 8><<<grid, THREADS, 0, stream>>>(indptr, indices, d, bb, o, n, C);
  return cudaGetLastError();
}

template <typename T, typename TB, typename ACC, int VB>
cudaError_t launch_spmm(const int* indptr, const int* indices, const void* data, const void* b,
                        void* out, void* carry, const int* plan, int n, int nnz, int C, int chunk,
                        int nchunks, int short_factor, cudaStream_t stream) {
  constexpr int EV = VB / sizeof(TB);
  if ((C * sizeof(TB)) % VB != 0) return cudaErrorInvalidValue;
  const size_t smem = SPMM_WARPS * spmm_warp_bytes<T, ACC, EV>(chunk);
  auto kernel = csr_spmm_kernel<T, TB, ACC, VB>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((nchunks + SPMM_WARPS - 1) / SPMM_WARPS);
  T* o = static_cast<T*>(out);
  T* cr = static_cast<T*>(carry);
  kernel<<<grid, SPMM_THREADS, smem, stream>>>(indptr, indices, static_cast<const T*>(data),
                                               static_cast<const TB*>(b), o, cr, plan, n, nnz, C,
                                               chunk, nchunks, short_factor);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nchunks == 1) return err;
  csr_spmm_fixup_kernel<T><<<grid, SPMM_THREADS, 0, stream>>>(indptr, plan, cr, o, n, nnz, C, chunk,
                                                              nchunks);
  return cudaGetLastError();
}

template <typename T, typename ACC, int VB, bool WIDE>
cudaError_t launch_sddmm(const int* indptr, const int* indices, const void* gz, const void* b, void* out,
                         const int* plan, int n, int nnz, int C, long long ld_gz, long long ld_b, int chunk,
                         int nchunks, cudaStream_t stream) {
  if ((C * sizeof(T)) % VB != 0 || (ld_gz * sizeof(T)) % VB != 0 || (ld_b * sizeof(T)) % VB != 0)
    return cudaErrorInvalidValue;
  const size_t smem = SDDMM_WARPS * sddmm_warp_bytes(chunk);
  const dim3 grid((nchunks + SDDMM_WARPS - 1) / SDDMM_WARPS);
  const T* g = static_cast<const T*>(gz);
  const T* bb = static_cast<const T*>(b);
  T* o = static_cast<T*>(out);
  if (!WIDE && C * sizeof(T) == VB) {    // a row is one vector
    csr_sddmm_lane_kernel<T, ACC, VB><<<grid, SDDMM_THREADS, 0, stream>>>(indptr, indices, g, bb, o, plan, n,
                                                                          nnz, ld_gz, ld_b, chunk, nchunks);
    return cudaGetLastError();
  }
  auto kernel = csr_sddmm_kernel<T, ACC, VB, WIDE>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, SDDMM_THREADS, smem, stream>>>(indptr, indices, g, bb, o, plan, n, nnz, C, ld_gz, ld_b, chunk,
                                                nchunks);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32 values and rhs, 1 = float32 values with a
// bfloat16 rhs, 2 = float64 values and rhs.  Returns a cudaError_t.
extern "C" int csr_spmv(const int* indptr, const int* indices, const void* data, const void* b,
                        void* out, int n, int C, int dtype, void* stream) {
  if (n <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_spmv<float, float, float>(indptr, indices, data, b, out, n, C, s);
    case 1: return (int)launch_spmv<float, __nv_bfloat16, float>(indptr, indices, data, b, out, n, C, s);
    case 2: return (int)launch_spmv<double, double, double>(indptr, indices, data, b, out, n, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K6.  `plan` holds nchunks + 1 row starts (see the header), `carry` room
// for nchunks x C values of the output's type, `vec` the bytes of one rhs
// load (16, 8, 4 or 2; it divides C times the rhs's item size and the
// rhs's address); a row with at most short_factor x (entries a warp step)
// entries in a chunk is summed by one lane group alone.  Dtype codes as
// for csr_spmv.
extern "C" int csr_spmm(const int* indptr, const int* indices, const void* data, const void* b,
                        void* out, void* carry, const int* plan, int n, int nnz, int C, int chunk,
                        int nchunks, int short_factor, int dtype, int vec, void* stream) {
  if (n <= 0 || nnz < 0 || C <= 0 || chunk < 32 || chunk > 4096 || nchunks <= 0 || short_factor < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K6_ARGS indptr, indices, data, b, out, carry, plan, n, nnz, C, chunk, nchunks, short_factor, s
  switch (dtype * 100 + vec) {
    case 16: return (int)launch_spmm<float, float, float, 16>(K6_ARGS);
    case 8: return (int)launch_spmm<float, float, float, 8>(K6_ARGS);
    case 4: return (int)launch_spmm<float, float, float, 4>(K6_ARGS);
    case 116: return (int)launch_spmm<float, unsigned short, float, 16>(K6_ARGS);
    case 108: return (int)launch_spmm<float, unsigned short, float, 8>(K6_ARGS);
    case 104: return (int)launch_spmm<float, unsigned short, float, 4>(K6_ARGS);
    case 102: return (int)launch_spmm<float, unsigned short, float, 2>(K6_ARGS);
    case 216: return (int)launch_spmm<double, double, double, 16>(K6_ARGS);
    case 208: return (int)launch_spmm<double, double, double, 8>(K6_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef K6_ARGS
}

// K7.  `plan` is K6's plan of x for this `chunk` (nchunks + 1 row starts);
// gz and b have rows ld_gz and ld_b values apart; `vec` is the bytes of one
// load (16, 8 or 4; it divides C, ld_gz and ld_b times the item size and
// both addresses).  dtype codes: 0 = float32, 2 = float64 (gz, b and the
// output alike).
extern "C" int csr_sddmm(const int* indptr, const int* indices, const void* gz, const void* b,
                         void* out, const int* plan, int n, int nnz, int C, long long ld_gz,
                         long long ld_b, int chunk, int nchunks, int dtype, int vec, void* stream) {
  if (n <= 0 || nnz < 0 || C <= 0 || ld_gz < 0 || ld_b < 0 || chunk < 32 || chunk > 4096 || nchunks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = (long long)C * (dtype == 2 ? 8 : 4) / vec > 32;
#define K7_ARGS indptr, indices, gz, b, out, plan, n, nnz, C, ld_gz, ld_b, chunk, nchunks, s
#define K7_CASE(code, T, VB)                                                       \
  case code:                                                                       \
    return (int)(wide ? launch_sddmm<T, T, VB, true>(K7_ARGS) : launch_sddmm<T, T, VB, false>(K7_ARGS));
  switch (dtype * 100 + vec) {
    K7_CASE(16, float, 16)
    K7_CASE(8, float, 8)
    K7_CASE(4, float, 4)
    K7_CASE(216, double, 16)
    K7_CASE(208, double, 8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef K7_CASE
#undef K7_ARGS
}

extern "C" const char* csr_spmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
