// One KPM Chebyshev step in one pass, for NVIDIA Hopper (sm_90a):
//
//     o = a·(post ⊙ fold(pre ⊙ v)) + b·v + c·prev
//
// with fold the checkerboard product exp(±Δτ·K̄)(ᵀ) (ckb_fold_groups.cuh),
// and the step's term of the Chebyshev sum on the stacked-real halves
// (K = 2Lω, columns [0, Lω) the real parts, [Lω, 2Lω) the imaginary ones)
// from the per-chain coefficients cf ([C, 2Lω]: cr | ci):
//
//     acc[k]    += cr[k]·v[k] − ci[k]·v[k+Lω]
//     acc[k+Lω] += cr[k]·v[k+Lω] + ci[k]·v[k]          (k < Lω)
//
// (with `init`, acc = that term: acc is written and not read).
//
// Replaces the Pallas TPU kernel elphdynamics_tpu/ops/ckb_pallas.py:
// _fold_fused_kernel (driven by fold_kn_fused; caller
// kpm.py:_chebyshev_apply_stacked_pallas). pre/post carry the averaged
// exp(−Δτ·V̄) diagonal of Ā (pre for Ā, post for Āᵀ); a = a_mul/λmag and
// b = −a_mul·λavg/λmag the spectral-window map; c = −1 with prev gives the
// recurrence u₊ = 2·Ap(u) − u₋.
//
// What bounds it on the card: device-memory bytes: v and prev read once, o
// written once, acc read and written once (5·B·N·K·itemsize with prev,
// 3 with init and no prev). The recurrence written out (fold kernel, then
// the diagonal, the affine map and the combine as separate elementwise
// passes) moves the field about five times per step, and the coefficient
// sum beside it about twelve more.
//
// What the design does about it: the plain fold's cluster-split slabs
// (ckb_fold.cu: one contiguous chunk of the row per cluster rank, bulk
// copies in and out, the group sweep on the cluster through distributed
// shared memory, two CTAs per SM), plus
//   * pre applied to the slab after it lands, before the sweep;
//   * the epilogue reads the CTA's own contiguous chunks of v (mostly from
//     L2: the CTA loaded it moments before) and prev, one site per thread
//     in flight; prev, the second read of v and the bulk store of o are
//     marked to leave L2 first, so that the v chunks other CTAs have yet to
//     re-read stay there. A second slab that brought prev into shared
//     memory was tried and not kept (PERF.md);
//   * o is written into the fold slab and leaves with the bulk store;
//   * the accumulation rides the same epilogue on the v it already reads:
//     each thread keeps its own column chunk and reads the partner chunk
//     (k ± Lω, the other half of the same site row, moments after its
//     neighbouring threads read it as their own) from device memory (L1 /
//     L2) beside it, as one vector where Lω is a multiple of the vector
//     width and column by column where it is not; the same code serves a
//     tile that holds the whole row and a K-tiled one whose partner columns
//     lie in another tile. acc is read and written once, marked to leave L2
//     first; the thread's coefficients stay in registers for all its sites.
// Field layout [B, N, K] row-major, B = C·inner rows, row r belongs to
// chain r / inner (the Green's solves run [C, nᵥ, N, 2Lω], the HMC solves
// [C, 2, N, 2Lω]); a[C], b[C], pre/post [C, N] (either may be null), one
// scalar c, prev may be null. The bond coefficients are one [Nb] table
// (cstride 0) or one per chain at chain·cstride (cstride Nb: the SSH
// model's Ā is τ-averaged from each chain's own field). o aliases neither
// v nor prev (every pointer is __restrict__); the wrapper allocates o. acc
// (v's layout) aliases none of v, prev and o; cf is one [2Lω] row per
// chain. The Pallas kernel's lane
// rolls and [K, N] transposes are not carried over.

#include <cuda_runtime.h>

#include <type_traits>

#include "ckb_fold_groups.cuh"

namespace {

// V values from device memory read once (ld.global.cs: the lines leave L2
// first), as one vector where `vec` says p is aligned for it.
template <typename T, int V>
__device__ inline ckb::Pack<T, V> load_once(const T* __restrict__ p, bool vec) {
  ckb::Pack<T, V> r;
  if constexpr (V == 4) {
    if (vec) {
      const float4 x = __ldcs(reinterpret_cast<const float4*>(p));
      r.x[0] = x.x, r.x[1] = x.y, r.x[2] = x.z, r.x[3] = x.w;
      return r;
    }
  } else if constexpr (V == 2) {
    if (vec) {
      using T2 = typename std::conditional<sizeof(T) == 4, float2, double2>::type;
      const T2 x = __ldcs(reinterpret_cast<const T2*>(p));
      r.x[0] = x.x, r.x[1] = x.y;
      return r;
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e) r.x[e] = __ldcs(p + e);
  return r;
}

// V values written once (st.global.cs), as one vector where `vec` says p is
// aligned for it.
template <typename T, int V>
__device__ inline void store_once(T* __restrict__ p, const ckb::Pack<T, V>& r, bool vec) {
  if constexpr (V == 4) {
    if (vec) {
      __stcs(reinterpret_cast<float4*>(p), make_float4(r.x[0], r.x[1], r.x[2], r.x[3]));
      return;
    }
  } else if constexpr (V == 2) {
    if (vec) {
      using T2 = typename std::conditional<sizeof(T) == 4, float2, double2>::type;
      T2 x;
      x.x = r.x[0], x.y = r.x[1];
      __stcs(reinterpret_cast<T2*>(p), x);
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e) __stcs(p + e, r.x[e]);
}

// The partner values v[k ± Lω] of a chunk: element e at p + e + d[e]; one
// vector where every d[e] is the same and p + d[0] is aligned (`vec`).
template <typename T, int V>
__device__ inline ckb::Pack<T, V> load_partner(const T* __restrict__ p, const int (&d)[V],
                                               bool vec) {
  if (vec) return load_once<T, V>(p + d[0], true);
  ckb::Pack<T, V> r;
#pragma unroll
  for (int e = 0; e < V; ++e) r.x[e] = __ldcs(p + e + d[e]);
  return r;
}

template <typename T, int V>
__global__ void __launch_bounds__(ckb::kMaxThreads, 2)
    ckb_fold_fused_kernel(const T* __restrict__ in, T* __restrict__ out,
                          const T* __restrict__ prev, const int4* __restrict__ bonds,
                          const int* __restrict__ poff, const T* __restrict__ c,
                          const T* __restrict__ s, int ngroups, T sign,
                          const T* __restrict__ pre, const T* __restrict__ post,
                          const T* __restrict__ a, const T* __restrict__ b, T cprev, int N,
                          int K, int kt, int cs, int inner, int pmax, long long cstride,
                          T* __restrict__ acc, const T* __restrict__ cf, int init) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const size_t sb = ckb::slab_bytes(N, cs, kt, sizeof(T));
  T* slab = reinterpret_cast<T*>(smem_raw);
  unsigned char* tables = smem_raw + sb;
  uint64_t* bar = reinterpret_cast<uint64_t*>(tables + ckb::table_bytes(pmax, sizeof(T), false));

  const ckb::Tile t = ckb::tile_of_block(N, K, kt, cs);
  const ckb::ThreadMap m = ckb::thread_map<V>(kt, t.kw);
  const bool contiguous = kt == K;
  const int chain = blockIdx.y / inner;
  const int n = t.nsites * K;
  const T* v = in + t.gbase;
  const T* p = prev ? prev + t.gbase : nullptr;

  if (threadIdx.x == 0) {
    ckb::mbar_init(bar);
    ckb::fence_mbar_init();
  }
  __syncthreads();

  bool wait = false;
  if (contiguous) {
    wait = ckb::start_copy_in(slab, v, n, bar);
  } else {
    ckb::copy_tile_in<T, V>(slab, v, t, kt, K, m);
  }
  // the chain's coefficient table (cstride 0: the one shared by all chains)
  const size_t coff = static_cast<size_t>(chain) * cstride;
  const ckb::BondTables<T> tb = ckb::load_bond_tables<T, false>(tables, bonds, poff, c + coff,
                                                                s + coff, ngroups, sign, t.rank,
                                                                pmax);
  if (wait) ckb::mbar_wait(bar, 0);
  __syncthreads();

  if (pre && m.active) {
    const T* pre_c = pre + static_cast<size_t>(chain) * N + t.site0;
    for (int r = m.r0; r < t.nsites; r += m.rstep) {
      const T d = pre_c[r];
#pragma unroll
      for (int e = 0; e < V; ++e) slab[r * kt + m.col + e] *= d;
    }
  }

  ckb::fold_sweep<T, V, false>(slab, tb, poff + cs * (ngroups + 1), ngroups, kt, t, m,
                               ckb::ColumnCoeffs<T>{}, sign);

  if (m.active) {
    const T ac = a[chain];
    const T bc = b[chain];
    const T* post_c = post ? post + static_cast<size_t>(chain) * N + t.site0 : nullptr;
    const bool vec_v = (reinterpret_cast<uintptr_t>(v) % (V * sizeof(T))) == 0;
    const bool vec_p = p && (reinterpret_cast<uintptr_t>(p) % (V * sizeof(T))) == 0;
    // the accumulation: this thread's columns k = k0 + col + e, each one's
    // partner offset dq[e] (+Lω in the real half, −Lω in the imaginary) and
    // coefficients kr[e], ki[e] (cr, and −ci or +ci), held for all its sites
    const int Lw = K / 2;
    const T* cf_c = cf + static_cast<size_t>(chain) * K;
    int dq[V];
    T kr[V], ki[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int k = t.k0 + m.col + e;
      const bool lo = k < Lw;
      const int j = lo ? k : k - Lw;
      dq[e] = lo ? Lw : -Lw;
      kr[e] = __ldg(cf_c + j);
      ki[e] = lo ? -__ldg(cf_c + j + Lw) : __ldg(cf_c + j + Lw);
    }
    T* q = acc + t.gbase;
    const bool vec_q = vec_v && Lw % V == 0;
    const bool vec_a = (reinterpret_cast<uintptr_t>(q) % (V * sizeof(T))) == 0;
    // one site per pass: its v, partner, prev and acc reads are about four
    // loads in flight within the registers that two CTAs per SM leave
    for (int r = m.r0; r < t.nsites; r += m.rstep) {
      const size_t goff = static_cast<size_t>(r) * K + m.col;
      const ckb::Pack<T, V> vv = load_once<T, V>(v + goff, vec_v);
      const ckb::Pack<T, V> wv = load_partner<T, V>(v + goff, dq, vec_q);
      ckb::Pack<T, V> pv, av;
      if (p) pv = load_once<T, V>(p + goff, vec_p);
      if (!init) av = load_once<T, V>(q + goff, vec_a);
      T* f = slab + r * kt + m.col;
      const T d = post_c ? post_c[r] : T(1);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        T o = ac * (d * f[e]) + bc * vv.x[e];
        if (p) o += cprev * pv.x[e];
        f[e] = o;
        const T x = kr[e] * vv.x[e] + ki[e] * wv.x[e];
        av.x[e] = init ? x : av.x[e] + x;
      }
      store_once<T, V>(q + goff, av, vec_a);
    }
  }

  if (contiguous) {
    ckb::copy_out(out + t.gbase, slab, n, /*evict_first=*/true);
  } else {
    ckb::copy_tile_out<T, V>(out + t.gbase, slab, t, kt, K, m);
  }
}

// Dynamic shared memory allowed so far for each instantiation, per device.
template <typename T, int V>
int* smem_set() {
  static int set[ckb::kMaxDevices] = {};
  return set;
}

template <typename T, int V>
int clusters_v(int N, int kt, int cs, int pmax, int threads) {
  const size_t smem =
      ckb::slab_bytes(N, cs, kt, sizeof(T)) + ckb::table_bytes(pmax, sizeof(T), false) + 16;
  return ckb::resident_clusters(ckb_fold_fused_kernel<T, V>, smem_set<T, V>(), cs, threads,
                                smem);
}

template <typename T, int V>
int launch_v(const T* in, T* out, const T* prev, const int* bonds, const int* poff,
             const T* c, const T* s, int ngroups, T sign, const T* pre, const T* post,
             const T* a, const T* b, T cprev, int B, int N, int K, int kt, int cs, int inner,
             int pmax, int threads, long long cstride, T* acc, const T* cf, int init,
             void* stream) {
  const size_t smem =
      ckb::slab_bytes(N, cs, kt, sizeof(T)) + ckb::table_bytes(pmax, sizeof(T), false) + 16;
  return ckb::launch_cluster(ckb_fold_fused_kernel<T, V>, smem_set<T, V>(), (K + kt - 1) / kt,
                             B, cs, threads, smem, stream, in, out, prev,
                             reinterpret_cast<const int4*>(bonds), poff, c, s, ngroups, sign,
                             pre, post, a, b, cprev, N, K, kt, cs, inner, pmax, cstride, acc,
                             cf, init);
}

// acc and cf set, K even.
template <typename T>
int launch(const T* in, T* out, const T* prev, const int* bonds, const int* poff, const T* c,
           const T* s, int ngroups, T sign, const T* pre, const T* post, const T* a,
           const T* b, T cprev, int B, int N, int K, int kt, int cs, int vec, int inner,
           int pmax, int threads, long long cstride, T* acc, const T* cf, int init,
           void* stream) {
  if (inner < 1 || !acc || !cf || K % 2) return static_cast<int>(cudaErrorInvalidValue);
  switch (vec) {
    case 1:
      return launch_v<T, 1>(in, out, prev, bonds, poff, c, s, ngroups, sign, pre, post, a, b,
                            cprev, B, N, K, kt, cs, inner, pmax, threads, cstride, acc, cf,
                            init, stream);
    case 2:
      return launch_v<T, 2>(in, out, prev, bonds, poff, c, s, ngroups, sign, pre, post, a, b,
                            cprev, B, N, K, kt, cs, inner, pmax, threads, cstride, acc, cf,
                            init, stream);
    case 4:
      if constexpr (sizeof(T) == 4)
        return launch_v<T, 4>(in, out, prev, bonds, poff, c, s, ngroups, sign, pre, post, a,
                              b, cprev, B, N, K, kt, cs, inner, pmax, threads, cstride, acc,
                              cf, init, stream);
      [[fallthrough]];
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int clusters_a(int vec, int N, int kt, int cs, int pmax, int threads) {
  if constexpr (sizeof(T) == 4) {
    if (vec == 4) return clusters_v<T, 4>(N, kt, cs, pmax, threads);
  }
  return vec == 2 ? clusters_v<T, 2>(N, kt, cs, pmax, threads)
                  : clusters_v<T, 1>(N, kt, cs, pmax, threads);
}

}  // namespace

extern "C" {

// Clusters of the launch (dtype64, vec, N, kt, cs, pmax, threads,
// per_column) the card holds at once (the grid runs in ceil(clusters /
// this) waves). This kernel takes no per-column coefficients.
int ckb_fold_fused_resident_clusters(int dtype64, int vec, int N, int kt, int cs, int pmax,
                                     int threads, int per_column) {
  if (per_column) return -static_cast<int>(cudaErrorInvalidValue);
  return dtype64 ? clusters_a<double>(vec, N, kt, cs, pmax, threads)
                 : clusters_a<float>(vec, N, kt, cs, pmax, threads);
}

int ckb_fold_fused_f32(const float* in, float* out, const float* prev, const int* bonds,
                       const int* poff, const float* c, const float* s, int ngroups,
                       double sign, const float* pre, const float* post, const float* a,
                       const float* b, double cprev, int B, int N, int K, int kt, int cs,
                       int vec, int inner, int pmax, int threads, long long cstride,
                       float* acc, const float* cf, int init, void* stream) {
  return launch<float>(in, out, prev, bonds, poff, c, s, ngroups, static_cast<float>(sign),
                       pre, post, a, b, static_cast<float>(cprev), B, N, K, kt, cs, vec,
                       inner, pmax, threads, cstride, acc, cf, init, stream);
}

int ckb_fold_fused_f64(const double* in, double* out, const double* prev, const int* bonds,
                       const int* poff, const double* c, const double* s, int ngroups,
                       double sign, const double* pre, const double* post, const double* a,
                       const double* b, double cprev, int B, int N, int K, int kt, int cs,
                       int vec, int inner, int pmax, int threads, long long cstride,
                       double* acc, const double* cf, int init, void* stream) {
  return launch<double>(in, out, prev, bonds, poff, c, s, ngroups, sign, pre, post, a, b,
                        cprev, B, N, K, kt, cs, vec, inner, pmax, threads, cstride, acc, cf,
                        init, stream);
}

}  // extern "C"
