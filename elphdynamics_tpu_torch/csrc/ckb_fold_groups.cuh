// The cluster-split checkerboard fold on Hopper, shared by the plain fold
// (ckb_fold.cu) and the fused Chebyshev step (ckb_fold_fused.cu).
//
// Layout. The field is [B, N, K] row-major. A thread-block cluster of cs
// CTAs owns one batch row b and one column tile [k0, k0 + kw) (kt columns,
// the last tile kw <= kt; kt == K unless the row is too large for the
// cluster's shared memory). Cluster rank r holds the sites
// [r·N/cs, (r+1)·N/cs) as a [nsites, kt] slab in its shared memory, so with
// kt == K its part of the row is ONE contiguous chunk of device memory.
//
// Copies. A contiguous chunk whose address is 16-byte aligned moves with
// the bulk copy engine (cp.async.bulk, global -> shared completing on an
// mbarrier, shared -> global as a bulk group), in pieces, plus a scalar
// ragged tail where its size is not a multiple of 16 bytes. A misaligned
// chunk moves with 16-byte global loads/stores and scalar head and tail; a
// K-tiled slab (rows of kw out of K) with vector loads of the sweep's
// width where aligned, else scalars.
//
// Sweep. For each bond group g in application order,
//     v_i <- c_n·v_i + sign·s_n·v_j,   v_j <- c_n·v_j + sign·conj(s_n)·v_i
// for the disjoint bonds n = (i, j) of g (i the bond's first endpoint, as
// in the spec's is_lo; conj is the identity on real types, and on complex
// fields makes each bond block the Hermitian [c s; s̄ c], so the reversed
// fold is the adjoint). Bond n is owned by the rank that
// holds i; it reads and writes j in its own slab or, where j lies with
// another rank, in that rank's slab through distributed shared memory.
// A barrier separates the groups and ends the sweep: cluster.sync() where
// either neighbouring group has a bond across ranks (so no CTA reads or
// writes a remote slab of the previous group, and none leaves while its
// slab can still be touched), __syncthreads() where both stay inside each
// rank (the x bonds of a row-major lattice whose ranks hold whole rows).
// The owned-bond tables are a host-side plan (ops/ckb_cuda.cluster_plan):
// per bond (local i, local j, rank of j, bond index into c/s), grouped by
// (rank, step) with offsets poff[rank·(G+1) + step], then one flag per step
// saying whether it crosses ranks; the sweep does no division per element.
// Before the sweep each rank copies its plan entries into shared memory
// next to its slab.
//
// Coefficients. Three forms of c and s: one [Nb] table shared by every
// row; one [Nb] table per chain ([C, Nb], the row's chain is
// blockIdx.y / inner, its table at chain·Nb); or one coefficient per chain,
// bond and column ([C, Nb, K], per_column). With a table per row the
// rank's (c_n, sign·s_n) pairs are copied next to the plan entries; with
// per-column coefficients they cannot be (Nb·K of them per chain, several
// times the slab), so the sweep reads each bond's V-wide vectors of c and
// s from device memory along the thread's column chunk.
//
// Element types. T is float or double, or cplx<float> / cplx<double> for
// complex fields (complex hopping): an interleaved (re, im) pair, torch's
// complex layout, aligned to its size, so a complex element moves as one
// 8- or 16-byte access and no vector splits a pair. The sign of a direction
// stays real (RealOf<T>); the coefficients c and s are of type T.
//
// Threads. Thread t works on column chunk t % nvec (V columns, nvec = kt/V)
// of sites/bonds t / nvec, t / nvec + T/nvec, ...; the launcher makes the
// block size T a multiple of nvec. CTAs have at most 512 threads, and at
// least two share an SM.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace ckb {

namespace cg = cooperative_groups;

constexpr int kMaxThreads = 512;
constexpr int kMaxDevices = 64;
constexpr uint32_t kBulkPiece = 32768;  // bytes per bulk copy instruction

// A complex number as torch stores it: (re, im) interleaved.
template <typename R>
struct alignas(2 * sizeof(R)) cplx {
  R re, im;
};

template <typename T>
struct RealOf {
  using type = T;
};
template <typename R>
struct RealOf<cplx<R>> {
  using type = R;
};

template <typename R>
__device__ __forceinline__ cplx<R> operator+(cplx<R> a, cplx<R> b) {
  return {a.re + b.re, a.im + b.im};
}
template <typename R>
__device__ __forceinline__ cplx<R> operator*(cplx<R> a, cplx<R> b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
template <typename R>
__device__ __forceinline__ cplx<R> operator*(R a, cplx<R> b) {
  return {a * b.re, a * b.im};
}
template <typename R>
__device__ __forceinline__ cplx<R> conj_of(cplx<R> a) {
  return {a.re, -a.im};
}
__device__ __forceinline__ float conj_of(float a) { return a; }
__device__ __forceinline__ double conj_of(double a) { return a; }

// V elements moved as one access (at most 16 bytes, the widest a thread
// loads or stores).
template <typename T, int V>
struct alignas(sizeof(T) * V > 16 ? 16 : sizeof(T) * V) Pack {
  T x[V];
};

// Bytes of one slab in shared memory, rounded up so that the tables and the
// mbarrier after it stay aligned. Same formula as ckb_cuda._cta_bytes.
__host__ __device__ inline size_t slab_bytes(int N, int cs, int kt, size_t item) {
  const size_t n = (static_cast<size_t>(N) + cs - 1) / cs;
  return (n * kt * item + 127) / 128 * 128;
}

// What one CTA owns.
struct Tile {
  int rank;      // rank in the cluster
  int site0;     // first site of the slab
  int nsites;    // sites in the slab
  int k0;        // first column of the tile
  int kw;        // columns in this tile
  size_t gbase;  // element offset of (row, site0, k0) in the field
};

__device__ inline Tile tile_of_block(int N, int K, int kt, int cs) {
  Tile t;
  t.rank = static_cast<int>(cg::this_cluster().block_rank());
  t.k0 = (blockIdx.x / cs) * kt;
  t.site0 = static_cast<int>(static_cast<long long>(t.rank) * N / cs);
  t.nsites = static_cast<int>(static_cast<long long>(t.rank + 1) * N / cs) - t.site0;
  t.kw = min(kt, K - t.k0);
  t.gbase = (static_cast<size_t>(blockIdx.y) * N + t.site0) * K + t.k0;
  return t;
}

// This thread's column chunk and sites.
struct ThreadMap {
  int col;    // first column of the chunk
  int r0;     // first site / bond
  int rstep;  // stride in sites / bonds
  bool active;
};

template <int V>
__device__ inline ThreadMap thread_map(int kt, int kw) {
  const int nvec = kt / V;
  ThreadMap m;
  m.col = (threadIdx.x % nvec) * V;
  m.r0 = threadIdx.x / nvec;
  m.rstep = blockDim.x / nvec;
  m.active = m.col < kw;
  return m;
}

// ---------------------------------------------------------------------------
// mbarrier and bulk-copy primitives (PTX)
// ---------------------------------------------------------------------------

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
}

__device__ inline void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ inline void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ inline void mbar_wait(uint64_t* bar, uint32_t phase) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)), "r"(phase) : "memory");
}

__device__ inline void bulk_g2s(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

__device__ inline void bulk_s2g(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
}

// An L2 cache policy that evicts these lines first: for data that is
// written or read once and should not push out lines still to be re-read.
__device__ inline uint64_t policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ inline void bulk_s2g_hint(void* dst, const void* src, uint32_t bytes,
                                     uint64_t policy) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes), "l"(policy) : "memory");
}

__device__ inline void bulk_commit_and_wait() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ inline void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Elements of a 16-byte-aligned n-element chunk that the bulk engine moves.
template <typename T>
__device__ inline int bulk_elems(int n) {
  return static_cast<int>((static_cast<size_t>(n) * sizeof(T)) & ~size_t{15}) /
         static_cast<int>(sizeof(T));
}

// ---------------------------------------------------------------------------
// Copies of a contiguous chunk (kt == K), called by every thread
// ---------------------------------------------------------------------------

// Threads copy g[0, n) -> s[0, n) (shared s is 16-byte aligned, g need
// not be): scalar head to g's next 16-byte boundary, 16-byte global loads,
// scalar tail.
template <typename T>
__device__ void copy_in_threads(T* s, const T* __restrict__ g, int n) {
  constexpr int E = 16 / sizeof(T);
  const int head = min(n, static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(g) & 15)) & 15) / sizeof(T)));
  const int body = (n - head) / E;
  for (int u = threadIdx.x; u < body; u += blockDim.x) {
    const Pack<T, E> p = *reinterpret_cast<const Pack<T, E>*>(g + head + u * E);
#pragma unroll
    for (int e = 0; e < E; ++e) s[head + u * E + e] = p.x[e];
  }
  for (int i = threadIdx.x; i < head; i += blockDim.x) s[i] = g[i];
  for (int i = head + body * E + threadIdx.x; i < n; i += blockDim.x) s[i] = g[i];
}

template <typename T>
__device__ void copy_out_threads(T* __restrict__ g, const T* s, int n) {
  constexpr int E = 16 / sizeof(T);
  const int head = min(n, static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(g) & 15)) & 15) / sizeof(T)));
  const int body = (n - head) / E;
  for (int u = threadIdx.x; u < body; u += blockDim.x) {
    Pack<T, E> p;
#pragma unroll
    for (int e = 0; e < E; ++e) p.x[e] = s[head + u * E + e];
    *reinterpret_cast<Pack<T, E>*>(g + head + u * E) = p;
  }
  for (int i = threadIdx.x; i < head; i += blockDim.x) g[i] = s[i];
  for (int i = head + body * E + threadIdx.x; i < n; i += blockDim.x) g[i] = s[i];
}

// Start moving g[0, n) into s: the bulk engine takes the 16-byte whole part
// of an aligned chunk (thread 0 issues it, completing on `bar`); threads
// copy the rest now. Returns whether the caller must wait on `bar`
// (parity 0) before reading s.
template <typename T>
__device__ bool start_copy_in(T* s, const T* __restrict__ g, int n, uint64_t* bar) {
  const int nb = aligned16(g) ? bulk_elems<T>(n) : 0;
  if (nb > 0) {
    if (threadIdx.x == 0) {
      const uint32_t bytes = static_cast<uint32_t>(nb * sizeof(T));
      mbar_expect_tx(bar, bytes);
      const char* src = reinterpret_cast<const char*>(g);
      char* dst = reinterpret_cast<char*>(s);
      for (uint32_t off = 0; off < bytes; off += kBulkPiece)
        bulk_g2s(dst + off, src + off, min(kBulkPiece, bytes - off), bar);
    }
    for (int i = nb + threadIdx.x; i < n; i += blockDim.x) s[i] = g[i];
  } else {
    copy_in_threads(s, g, n);
  }
  return nb > 0;
}

// Move s[0, n) to g[0, n) after every thread's last write to s: the bulk
// engine where g is 16-byte aligned (thread 0 waits until it has read s,
// so the CTA does not leave before), threads for the rest. With
// `evict_first` the bulk store marks its lines to leave L2 first.
template <typename T>
__device__ void copy_out(T* __restrict__ g, const T* s, int n, bool evict_first = false) {
  const int nb = aligned16(g) ? bulk_elems<T>(n) : 0;
  if (nb > 0) {
    fence_proxy_async();  // this thread's shared-memory writes, to the bulk engine
    __syncthreads();
    if (threadIdx.x == 0) {
      const uint32_t bytes = static_cast<uint32_t>(nb * sizeof(T));
      char* dst = reinterpret_cast<char*>(g);
      const char* src = reinterpret_cast<const char*>(s);
      const uint64_t policy = policy_evict_first();
      for (uint32_t off = 0; off < bytes; off += kBulkPiece) {
        if (evict_first) {
          bulk_s2g_hint(dst + off, src + off, min(kBulkPiece, bytes - off), policy);
        } else {
          bulk_s2g(dst + off, src + off, min(kBulkPiece, bytes - off));
        }
      }
      bulk_commit_and_wait();
    }
    for (int i = nb + threadIdx.x; i < n; i += blockDim.x) g[i] = s[i];
  } else {
    __syncthreads();
    copy_out_threads(g, s, n);
  }
}

// ---------------------------------------------------------------------------
// Copies of a K-tiled slab (kt < K): rows of kw elements, stride K in the
// field and kt in the slab, each thread its own chunk
// ---------------------------------------------------------------------------

template <typename T, int V>
__device__ void copy_tile_in(T* s, const T* __restrict__ g, const Tile& t, int kt, int K,
                             const ThreadMap& m) {
  if (!m.active) return;
  const bool vec = (reinterpret_cast<uintptr_t>(g) % (V * sizeof(T))) == 0;
  for (int r = m.r0; r < t.nsites; r += m.rstep) {
    const T* src = g + static_cast<size_t>(r) * K + m.col;
    T* dst = s + r * kt + m.col;
    if (vec) {
      *reinterpret_cast<Pack<T, V>*>(dst) = *reinterpret_cast<const Pack<T, V>*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) dst[e] = src[e];
    }
  }
}

template <typename T, int V>
__device__ void copy_tile_out(T* __restrict__ g, const T* s, const Tile& t, int kt, int K,
                              const ThreadMap& m) {
  if (!m.active) return;
  const bool vec = (reinterpret_cast<uintptr_t>(g) % (V * sizeof(T))) == 0;
  for (int r = m.r0; r < t.nsites; r += m.rstep) {
    T* dst = g + static_cast<size_t>(r) * K + m.col;
    const T* src = s + r * kt + m.col;
    if (vec) {
      *reinterpret_cast<Pack<T, V>*>(dst) = *reinterpret_cast<const Pack<T, V>*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) dst[e] = src[e];
    }
  }
}

// ---------------------------------------------------------------------------
// The group sweep on the cluster
// ---------------------------------------------------------------------------

// The rank's owned bonds of every step, copied next to the slab before the
// sweep: the plan entries (local i, local j, rank of j, bond) and, unless
// the coefficients are per column (PC), their (c_n, sign·s_n) gathered
// from the row's bond table, so that the sweep reads nothing else.
template <typename T>
struct BondTables {
  int4* bond;             // [nown]
  Pack<T, 2>* coef;       // [nown], or null with per-column coefficients
  int base;               // index of the rank's first plan entry
  const int* off;         // poff + rank·(G+1): global offsets of the steps
};

// Every thread: fill the tables (call while the slab's bulk copy is in
// flight; the caller synchronises before the sweep). `c` and `s` are the
// row's [Nb] tables (unused with PC).
template <typename T, bool PC>
__device__ BondTables<T> load_bond_tables(unsigned char* where, const int4* __restrict__ bonds,
                                          const int* __restrict__ poff,
                                          const T* __restrict__ c, const T* __restrict__ s,
                                          int ngroups, typename RealOf<T>::type sign, int rank,
                                          int pmax) {
  BondTables<T> tb;
  tb.off = poff + rank * (ngroups + 1);
  tb.base = tb.off[0];
  tb.bond = reinterpret_cast<int4*>(where);
  tb.coef = PC ? nullptr
               : reinterpret_cast<Pack<T, 2>*>(where + static_cast<size_t>(pmax) * sizeof(int4));
  const int nown = tb.off[ngroups] - tb.base;
  for (int k = threadIdx.x; k < nown; k += blockDim.x) {
    const int4 e = bonds[tb.base + k];
    tb.bond[k] = e;
    if constexpr (!PC) {
      Pack<T, 2> cf;
      cf.x[0] = c[e.w];
      cf.x[1] = sign * s[e.w];
      tb.coef[k] = cf;
    }
  }
  return tb;
}

// Bytes of the bond tables of a rank owning at most pmax bonds (16-aligned):
// an int4 plan entry each, plus two coefficients unless they are per column.
// Same formula as ckb_cuda._cta_bytes.
__host__ __device__ inline size_t table_bytes(int pmax, size_t item, bool per_column) {
  const size_t entry = sizeof(int4) + (per_column ? 0 : 2 * item);
  return (static_cast<size_t>(pmax) * entry + 15) / 16 * 16;
}

// Per-column coefficients of one row's column tile: c and s point at
// (bond 0, the tile's first column) of the row's [Nb, K] tables; `vec`:
// both are aligned for V-wide loads (every offset the sweep adds is a
// multiple of V).
template <typename T>
struct ColumnCoeffs {
  const T* c;
  const T* s;
  int K;
  bool vec;
};

template <typename T, int V>
__device__ inline Pack<T, V> load_coeffs(const T* __restrict__ p, bool vec) {
  if (vec) return *reinterpret_cast<const Pack<T, V>*>(p);
  Pack<T, V> r;
#pragma unroll
  for (int e = 0; e < V; ++e) r.x[e] = p[e];
  return r;
}

// Barrier between two steps of the sweep: the whole cluster where either
// step reaches across ranks (`cross[k]`, from the plan: a remote slab must
// hold the previous step's values, and may be written only after its owner
// has read them), else the CTA alone.
__device__ inline void step_barrier(bool cluster_wide) {
  if (cluster_wide) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// Runs every group in plan order on the cluster's slabs. Precondition: the
// CTA's slab and tables are complete (its threads' writes and the bulk copy
// waited on; no barrier needed). Postcondition: every slab holds the folded
// values, visible to its CTA, and no other CTA touches it again. Each thread
// keeps two bonds in flight: the bonds of a group are disjoint, so the
// second bond's loads may pass the first's stores. With PC each bond's
// coefficients are V-wide vectors of `cc` along the thread's columns (and
// `sign` is applied here); else the pair in the tables. The bond's second
// endpoint takes conj(s) (a no-op for real T).
template <typename T, int V, bool PC>
__device__ void fold_sweep(T* slab, const BondTables<T>& tb, const int* __restrict__ cross,
                           int ngroups, int kt, const Tile& t, const ThreadMap& m,
                           const ColumnCoeffs<T>& cc, typename RealOf<T>::type sign) {
  cg::cluster_group cluster = cg::this_cluster();
  step_barrier(ngroups > 0 && cross[0]);
  for (int step = 0; step < ngroups; ++step) {
    if (m.active) {
      const int end = tb.off[step + 1] - tb.base;
      for (int k = tb.off[step] - tb.base + m.r0; k < end; k += 2 * m.rstep) {
        const int nb = k + m.rstep < end ? 2 : 1;
        Pack<T, V>* pi[2];
        Pack<T, V>* pj[2];
        Pack<T, V> vi[2], vj[2], ci[2], si[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (u < nb) {
            const int4 e = tb.bond[k + u * m.rstep];  // (local i, local j, rank of j, bond)
            T* sj = e.z == t.rank ? slab : cluster.map_shared_rank(slab, e.z);
            pi[u] = reinterpret_cast<Pack<T, V>*>(slab + e.x * kt + m.col);
            pj[u] = reinterpret_cast<Pack<T, V>*>(sj + e.y * kt + m.col);
            vi[u] = *pi[u];
            vj[u] = *pj[u];
            if constexpr (PC) {
              const size_t off = static_cast<size_t>(e.w) * cc.K + m.col;
              ci[u] = load_coeffs<T, V>(cc.c + off, cc.vec);
              si[u] = load_coeffs<T, V>(cc.s + off, cc.vec);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (u < nb) {
            if constexpr (!PC) {
              const Pack<T, 2> cf = tb.coef[k + u * m.rstep];
#pragma unroll
              for (int x = 0; x < V; ++x) {
                ci[u].x[x] = cf.x[0];
                si[u].x[x] = cf.x[1];
              }
            } else {
#pragma unroll
              for (int x = 0; x < V; ++x) si[u].x[x] = sign * si[u].x[x];
            }
            Pack<T, V> oi, oj;
#pragma unroll
            for (int x = 0; x < V; ++x) {
              oi.x[x] = ci[u].x[x] * vi[u].x[x] + si[u].x[x] * vj[u].x[x];
              oj.x[x] = ci[u].x[x] * vj[u].x[x] + conj_of(si[u].x[x]) * vi[u].x[x];
            }
            *pi[u] = oi;
            *pj[u] = oj;
          }
        }
      }
    }
    step_barrier(cross[step] || (step + 1 < ngroups && cross[step + 1]));
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Allow `kernel` `smem` bytes of dynamic shared memory, clusters above 8
// and the largest shared-memory carve-out. `smem_set` (one per kernel
// instantiation, indexed by device) remembers what is already allowed, so
// the attributes are set once, not per launch.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int* smem_set, size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (static_cast<int>(smem) <= smem_set[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) smem_set[dev] = static_cast<int>(smem);
  return err;
}

inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int ntile, int B, int cs,
                                         int threads, size_t smem, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs * ntile, B, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launch `kernel` on a grid of (cs·ntile, B) CTAs in clusters of cs.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), int* smem_set, int ntile, int B, int cs,
                   int threads, size_t smem, void* stream, Args... args) {
  cudaError_t err = prepare(kernel, smem_set, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(attr, ntile, B, cs, threads, smem, stream);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of cs CTAs of `kernel` the card holds at once, or a
// negative CUDA error code.
template <typename Kernel>
int resident_clusters(Kernel kernel, int* smem_set, int cs, int threads, size_t smem) {
  cudaError_t err = prepare(kernel, smem_set, smem);
  int n = 0;
  if (err == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(attr, 1, 1, cs, threads, smem, nullptr);
    err = cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<const void*>(kernel), &cfg);
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace ckb

// Largest dynamic shared memory a block may opt in to on `device` (bytes),
// or a negative CUDA error code.
extern "C" int ckb_smem_optin(int device) {
  int v = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? v : -static_cast<int>(err);
}
