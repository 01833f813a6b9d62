// The persistent two-slab variant of the checkerboard fold (K1) and of the
// fused Chebyshev step (K2), for NVIDIA Hopper (sm_90a). Measured against
// the shipped kernels by scripts/ckb_fold_ab.py --variants; the port does
// not use it.
//
// The shipped kernels (elphdynamics_tpu_torch/csrc/ckb_fold.cu,
// ckb_fold_fused.cu) launch one cluster of cs CTAs per batch row, one slab
// per CTA, two CTAs per SM; the rows run in waves. Here a grid of R
// clusters (as many as the card holds at once, one CTA per SM) walks the
// rows: cluster q folds rows q, q + R, q + 2R, ... Each CTA keeps two slabs
// of its contiguous site range. While it sweeps row i in one, the bulk copy
// engine loads row i + R into the other, and row i's store leaves without
// being waited for; the bond tables are loaded once per CTA, not once per
// row. The sweep, the plan and the copy primitives are the shipped ones
// (ckb_fold_groups.cuh).
//
// It takes only rows whose every chunk is 16-byte aligned and a multiple of
// 16 bytes long (kt == K): the script checks before it launches.

#include <cuda_runtime.h>

#include <type_traits>

#include "ckb_fold_groups.cuh"

namespace {

namespace cg = cooperative_groups;

// V values read once from device memory (the lines leave L2 first).
template <typename T, int V>
__device__ inline ckb::Pack<T, V> load_once(const T* __restrict__ p) {
  ckb::Pack<T, V> r;
  if constexpr (V == 4) {
    const float4 x = __ldcs(reinterpret_cast<const float4*>(p));
    r.x[0] = x.x, r.x[1] = x.y, r.x[2] = x.z, r.x[3] = x.w;
  } else if constexpr (V == 2) {
    using T2 = typename std::conditional<sizeof(T) == 4, float2, double2>::type;
    const T2 x = __ldcs(reinterpret_cast<const T2*>(p));
    r.x[0] = x.x, r.x[1] = x.y;
  } else {
    r.x[0] = __ldcs(p);
  }
  return r;
}

__device__ inline void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

template <typename T, int V, bool FUSED>
__global__ void __launch_bounds__(1024, 1)
    ckb_persist_kernel(const T* __restrict__ in, T* __restrict__ out, const T* __restrict__ prev,
                       const int4* __restrict__ bonds, const int* __restrict__ poff,
                       const T* __restrict__ c, const T* __restrict__ s, int ngroups, T sign,
                       const T* __restrict__ pre, const T* __restrict__ post,
                       const T* __restrict__ a, const T* __restrict__ b, T cprev, int B, int N,
                       int K, int cs, int inner, int pmax) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const size_t sb = ckb::slab_bytes(N, cs, K, sizeof(T));
  T* slabs[2] = {reinterpret_cast<T*>(smem_raw), reinterpret_cast<T*>(smem_raw + sb)};
  unsigned char* tables = smem_raw + 2 * sb;
  uint64_t* bar = reinterpret_cast<uint64_t*>(tables + ckb::table_bytes(pmax, sizeof(T), false));

  ckb::Tile t;
  t.rank = static_cast<int>(cg::this_cluster().block_rank());
  t.site0 = static_cast<int>(static_cast<long long>(t.rank) * N / cs);
  t.nsites = static_cast<int>(static_cast<long long>(t.rank + 1) * N / cs) - t.site0;
  t.kw = K;
  t.gbase = 0;
  const ckb::ThreadMap m = ckb::thread_map<V>(K, K);
  const uint32_t bytes = static_cast<uint32_t>(t.nsites * K * sizeof(T));
  const int stride = gridDim.x / cs;
  int row = blockIdx.x / cs;

  if (threadIdx.x == 0) {
    ckb::mbar_init(&bar[0]);
    ckb::mbar_init(&bar[1]);
    ckb::fence_mbar_init();
  }
  __syncthreads();

  auto offset = [&](int r) { return (static_cast<size_t>(r) * N + t.site0) * K; };
  auto issue = [&](int r, int buf) {
    if (threadIdx.x == 0) {
      ckb::mbar_expect_tx(&bar[buf], bytes);
      const char* src = reinterpret_cast<const char*>(in + offset(r));
      char* dst = reinterpret_cast<char*>(slabs[buf]);
      for (uint32_t off = 0; off < bytes; off += ckb::kBulkPiece)
        ckb::bulk_g2s(dst + off, src + off, min(ckb::kBulkPiece, bytes - off), &bar[buf]);
    }
  };

  if (row < B) issue(row, 0);
  const ckb::BondTables<T> tb =
      ckb::load_bond_tables<T, false>(tables, bonds, poff, c, s, ngroups, sign, t.rank, pmax);
  const int* cross = poff + cs * (ngroups + 1);
  const uint64_t policy = ckb::policy_evict_first();

  for (int it = 0; row < B; ++it, row += stride) {
    const int buf = it & 1;
    T* slab = slabs[buf];
    if (row + stride < B) {
      // the other slab's store (previous row) must have been read out
      if (threadIdx.x == 0) bulk_wait_read();
      issue(row + stride, buf ^ 1);
    }
    ckb::mbar_wait(&bar[buf], (it >> 1) & 1);
    __syncthreads();
    const size_t g0 = offset(row);
    const int chain = row / inner;

    if constexpr (FUSED) {
      if (pre && m.active) {
        const T* pre_c = pre + static_cast<size_t>(chain) * N + t.site0;
        for (int r = m.r0; r < t.nsites; r += m.rstep) {
          const T d = pre_c[r];
#pragma unroll
          for (int e = 0; e < V; ++e) slab[r * K + m.col + e] *= d;
        }
      }
    }

    ckb::fold_sweep<T, V, false>(slab, tb, cross, ngroups, K, t, m, ckb::ColumnCoeffs<T>{},
                                 sign);

    if constexpr (FUSED) {
      if (m.active) {
        const T ac = a[chain];
        const T bc = b[chain];
        const T* post_c = post ? post + static_cast<size_t>(chain) * N + t.site0 : nullptr;
        const T* v = in + g0;
        const T* p = prev ? prev + g0 : nullptr;
        for (int r = m.r0; r < t.nsites; r += 2 * m.rstep) {
          ckb::Pack<T, V> vv[2], pv[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int ru = r + u * m.rstep;
            if (ru < t.nsites) {
              const size_t goff = static_cast<size_t>(ru) * K + m.col;
              vv[u] = load_once<T, V>(v + goff);
              if (p) pv[u] = load_once<T, V>(p + goff);
            }
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int ru = r + u * m.rstep;
            if (ru < t.nsites) {
              T* f = slab + ru * K + m.col;
              const T d = post_c ? post_c[ru] : T(1);
#pragma unroll
              for (int e = 0; e < V; ++e) {
                T o = ac * (d * f[e]) + bc * vv[u].x[e];
                if (p) o += cprev * pv[u].x[e];
                f[e] = o;
              }
            }
          }
        }
      }
    }

    ckb::fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0) {
      char* dst = reinterpret_cast<char*>(out + g0);
      const char* src = reinterpret_cast<const char*>(slab);
      for (uint32_t off = 0; off < bytes; off += ckb::kBulkPiece) {
        if (FUSED) {
          ckb::bulk_s2g_hint(dst + off, src + off, min(ckb::kBulkPiece, bytes - off), policy);
        } else {
          ckb::bulk_s2g(dst + off, src + off, min(ckb::kBulkPiece, bytes - off));
        }
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  if (threadIdx.x == 0) bulk_wait_read();
}

template <typename T, int V, bool F>
int* smem_set() {
  static int set[ckb::kMaxDevices] = {};
  return set;
}

template <typename T>
size_t smem_of(int N, int K, int cs, int pmax) {
  return 2 * ckb::slab_bytes(N, cs, K, sizeof(T)) + ckb::table_bytes(pmax, sizeof(T), false) + 16;
}

template <typename T, int V, bool F>
int clusters_v(int N, int K, int cs, int pmax, int threads) {
  return ckb::resident_clusters(ckb_persist_kernel<T, V, F>, smem_set<T, V, F>(), cs, threads,
                                smem_of<T>(N, K, cs, pmax));
}

template <typename T, int V, bool F>
int launch_v(const T* in, T* out, const T* prev, const int* bonds, const int* poff, const T* c,
             const T* s, int ngroups, T sign, const T* pre, const T* post, const T* a,
             const T* b, T cprev, int B, int N, int K, int cs, int inner, int pmax, int threads,
             int nclusters, void* stream) {
  return ckb::launch_cluster(ckb_persist_kernel<T, V, F>, smem_set<T, V, F>(), nclusters, 1, cs,
                             threads, smem_of<T>(N, K, cs, pmax), stream, in, out, prev,
                             reinterpret_cast<const int4*>(bonds), poff, c, s, ngroups, sign,
                             pre, post, a, b, cprev, B, N, K, cs, inner, pmax);
}

template <typename T, bool F>
int launch_f(const T* in, T* out, const T* prev, const int* bonds, const int* poff, const T* c,
             const T* s, int ngroups, T sign, const T* pre, const T* post, const T* a,
             const T* b, T cprev, int B, int N, int K, int cs, int vec, int inner, int pmax,
             int threads, int nclusters, void* stream) {
  switch (vec) {
    case 1:
      return launch_v<T, 1, F>(in, out, prev, bonds, poff, c, s, ngroups, sign, pre, post, a, b,
                               cprev, B, N, K, cs, inner, pmax, threads, nclusters, stream);
    case 2:
      return launch_v<T, 2, F>(in, out, prev, bonds, poff, c, s, ngroups, sign, pre, post, a, b,
                               cprev, B, N, K, cs, inner, pmax, threads, nclusters, stream);
    case 4:
      if constexpr (sizeof(T) == 4)
        return launch_v<T, 4, F>(in, out, prev, bonds, poff, c, s, ngroups, sign, pre, post, a,
                                 b, cprev, B, N, K, cs, inner, pmax, threads, nclusters, stream);
      [[fallthrough]];
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, bool F>
int clusters_f(int vec, int N, int K, int cs, int pmax, int threads) {
  if constexpr (sizeof(T) == 4) {
    if (vec == 4) return clusters_v<T, 4, F>(N, K, cs, pmax, threads);
  }
  return vec == 2 ? clusters_v<T, 2, F>(N, K, cs, pmax, threads)
                  : clusters_v<T, 1, F>(N, K, cs, pmax, threads);
}

}  // namespace

extern "C" {

// Clusters of cs CTAs of the variant that the card holds at once.
int ckb_persist_clusters(int dtype64, int fused, int vec, int N, int K, int cs, int pmax,
                         int threads) {
  if (dtype64) {
    return fused ? clusters_f<double, true>(vec, N, K, cs, pmax, threads)
                 : clusters_f<double, false>(vec, N, K, cs, pmax, threads);
  }
  return fused ? clusters_f<float, true>(vec, N, K, cs, pmax, threads)
               : clusters_f<float, false>(vec, N, K, cs, pmax, threads);
}

// The fold (fused = 0: pre, post, a, b, prev unused) or the fused step over
// B rows of [N, K], on a grid of nclusters clusters of cs CTAs.
int ckb_persist_f32(const float* in, float* out, const float* prev, const int* bonds,
                    const int* poff, const float* c, const float* s, int ngroups, double sign,
                    const float* pre, const float* post, const float* a, const float* b,
                    double cprev, int fused, int B, int N, int K, int cs, int vec, int inner,
                    int pmax, int threads, int nclusters, void* stream) {
  auto fn = fused ? launch_f<float, true> : launch_f<float, false>;
  return fn(in, out, prev, bonds, poff, c, s, ngroups, static_cast<float>(sign), pre, post, a,
            b, static_cast<float>(cprev), B, N, K, cs, vec, inner, pmax, threads, nclusters,
            stream);
}

int ckb_persist_f64(const double* in, double* out, const double* prev, const int* bonds,
                    const int* poff, const double* c, const double* s, int ngroups,
                    double sign, const double* pre, const double* post, const double* a,
                    const double* b, double cprev, int fused, int B, int N, int K, int cs,
                    int vec, int inner, int pmax, int threads, int nclusters, void* stream) {
  auto fn = fused ? launch_f<double, true> : launch_f<double, false>;
  return fn(in, out, prev, bonds, poff, c, s, ngroups, sign, pre, post, a, b, cprev, B, N, K,
            cs, vec, inner, pmax, threads, nclusters, stream);
}

}  // extern "C"
