// Checkerboard fold exp(±Δτ·K)(ᵀ)·v in one pass, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel elphdynamics_tpu/ops/ckb_pallas.py:_fold_kernel
// (driven by fold_2d). Same arithmetic: for each bond group g, in forward or
// reversed order, v <- c_g ⊙ v + sign·s_g ⊙ v[partner_g].
//
// Complex mode (complex hopping: twisted boundaries, Peierls phases; the JAX
// package folded those outside Pallas): complex64 / complex128 fields and
// coefficient tables, interleaved (re, im) as torch stores them, with the
// bond's first endpoint taking s and its second conj(s) (ckb_fold_groups.cuh).
// c is carried complex, as the plain twin carries it. The same three table
// forms, the same plan and geometry; a complex64 element is 8 bytes and a
// complex128 one 16, so the host's geometry reckons with the element size.
//
// What bounds it on the card: device-memory bytes. The fold does 3 flops per
// element per group; every field element must be read once and written once
// (2·B·N·K·itemsize bytes), and a plain fold (one gather + FMA pass per
// group, the torch twin in ops/checkerboard.py) moves that G times over.
// With per-(chain, bond, column) coefficients (the SSH fermion operator's
// [C, Nb, Lτ] cosh/sinh) the tables add 2·C·Nb·K elements, read from device
// memory by the sweep (each chain's by its inner rows, mostly from L2).
//
// What the design does about it (ckb_fold_groups.cuh):
//   * a cluster of cs CTAs owns one batch row (and one column tile where the
//     row is too large); each rank keeps its contiguous site range of the row
//     in shared memory for the whole fold, so every element is read once and
//     written once whatever the number of groups;
//   * with kt == K a rank's part is one contiguous chunk of device memory,
//     moved by the bulk copy engine (TMA, cp.async.bulk) in and out: no
//     short strided row segments, no per-element address arithmetic;
//   * the groups run on the cluster: bonds whose partner lies with another
//     rank go through distributed shared memory (~6% at 64×64, cs = 8);
//   * a slab takes at most about half the SM's shared memory, so two or
//     more CTAs share an SM; the wrapper times the cluster and block sizes
//     that fit on a shape's first launch and keeps the fastest.
// What still holds it from the bytes bound is the sweep: 2 shared-memory
// accesses per element per group (8 for a square lattice's 4 groups, against
// 2 device-memory accesses per fold), and the rows' waves: a cluster holds
// a whole row, so the last wave leaves SMs idle (PERF.md).
// The mask/roll offset classes and [N,K]→[K,N] transposes of the Pallas
// kernel existed only because Mosaic has no dynamic gather; they are gone.

#include <cuda_runtime.h>

#include "ckb_fold_groups.cuh"

namespace {

template <typename T>
using Real = typename ckb::RealOf<T>::type;

template <typename T, int V, bool PC>
__global__ void __launch_bounds__(ckb::kMaxThreads, 2)
    ckb_fold_kernel(const T* __restrict__ in, T* __restrict__ out,
                    const int4* __restrict__ bonds, const int* __restrict__ poff,
                    const T* __restrict__ c, const T* __restrict__ s, int ngroups,
                    Real<T> sign, int N, int K, int kt, int cs, int pmax, int inner,
                    long long cstride) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const size_t sb = ckb::slab_bytes(N, cs, kt, sizeof(T));
  T* slab = reinterpret_cast<T*>(smem_raw);
  uint64_t* bar =
      reinterpret_cast<uint64_t*>(smem_raw + sb + ckb::table_bytes(pmax, sizeof(T), PC));

  const ckb::Tile t = ckb::tile_of_block(N, K, kt, cs);
  const ckb::ThreadMap m = ckb::thread_map<V>(kt, t.kw);
  const bool contiguous = kt == K;
  // the row's coefficients: its chain's table (cstride 0: the shared one)
  const size_t coff = static_cast<size_t>(blockIdx.y / inner) * cstride;
  const T* cr = c + coff;
  const T* sr = s + coff;

  if (threadIdx.x == 0) {
    ckb::mbar_init(bar);
    ckb::fence_mbar_init();
  }
  __syncthreads();

  bool wait = false;
  if (contiguous) {
    wait = ckb::start_copy_in(slab, in + t.gbase, t.nsites * K, bar);
  } else {
    ckb::copy_tile_in<T, V>(slab, in + t.gbase, t, kt, K, m);
  }
  const ckb::BondTables<T> tb = ckb::load_bond_tables<T, PC>(smem_raw + sb, bonds, poff, cr, sr,
                                                             ngroups, sign, t.rank, pmax);
  ckb::ColumnCoeffs<T> cc;
  cc.c = cr + t.k0;
  cc.s = sr + t.k0;
  cc.K = K;
  cc.vec = (reinterpret_cast<uintptr_t>(c) % (V * sizeof(T))) == 0 &&
           (reinterpret_cast<uintptr_t>(s) % (V * sizeof(T))) == 0;
  if (wait) ckb::mbar_wait(bar, 0);

  ckb::fold_sweep<T, V, PC>(slab, tb, poff + cs * (ngroups + 1), ngroups, kt, t, m, cc, sign);

  if (contiguous) {
    ckb::copy_out(out + t.gbase, slab, t.nsites * K);
  } else {
    ckb::copy_tile_out<T, V>(out + t.gbase, slab, t, kt, K, m);
  }
}

// Dynamic shared memory allowed so far for each instantiation, per device.
template <typename T, int V, bool PC>
int* smem_set() {
  static int set[ckb::kMaxDevices] = {};
  return set;
}

template <typename T, int V, bool PC>
size_t smem_bytes(int N, int kt, int cs, int pmax) {
  return ckb::slab_bytes(N, cs, kt, sizeof(T)) + ckb::table_bytes(pmax, sizeof(T), PC) + 16;
}

template <typename T, int V, bool PC>
int clusters_v(int N, int kt, int cs, int pmax, int threads) {
  return ckb::resident_clusters(ckb_fold_kernel<T, V, PC>, smem_set<T, V, PC>(), cs, threads,
                                smem_bytes<T, V, PC>(N, kt, cs, pmax));
}

template <typename T, int V>
int clusters_pc(int N, int kt, int cs, int pmax, int threads, int per_column) {
  return per_column ? clusters_v<T, V, true>(N, kt, cs, pmax, threads)
                    : clusters_v<T, V, false>(N, kt, cs, pmax, threads);
}

template <typename T, int V, bool PC>
int launch_v(const T* in, T* out, const int* bonds, const int* poff, const T* c, const T* s,
             int ngroups, Real<T> sign, int B, int N, int K, int kt, int cs, int pmax, int threads,
             int inner, long long cstride, void* stream) {
  return ckb::launch_cluster(ckb_fold_kernel<T, V, PC>, smem_set<T, V, PC>(), (K + kt - 1) / kt,
                             B, cs, threads, smem_bytes<T, V, PC>(N, kt, cs, pmax), stream, in,
                             out, reinterpret_cast<const int4*>(bonds), poff, c, s, ngroups,
                             sign, N, K, kt, cs, pmax, inner, cstride);
}

template <typename T, int V>
int launch_pc(const T* in, T* out, const int* bonds, const int* poff, const T* c, const T* s,
              int ngroups, Real<T> sign, int B, int N, int K, int kt, int cs, int pmax, int threads,
              int inner, long long cstride, int per_column, void* stream) {
  return per_column
             ? launch_v<T, V, true>(in, out, bonds, poff, c, s, ngroups, sign, B, N, K, kt, cs,
                                    pmax, threads, inner, cstride, stream)
             : launch_v<T, V, false>(in, out, bonds, poff, c, s, ngroups, sign, B, N, K, kt, cs,
                                     pmax, threads, inner, cstride, stream);
}

template <typename T>
int launch(const T* in, T* out, const int* bonds, const int* poff, const T* c, const T* s,
           int ngroups, Real<T> sign, int B, int N, int K, int kt, int cs, int vec, int pmax,
           int threads, int inner, long long cstride, int per_column, void* stream) {
  if (inner < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (vec) {
    case 1:
      return launch_pc<T, 1>(in, out, bonds, poff, c, s, ngroups, sign, B, N, K, kt, cs, pmax,
                             threads, inner, cstride, per_column, stream);
    case 2:
      if constexpr (sizeof(T) * 2 <= 16)
        return launch_pc<T, 2>(in, out, bonds, poff, c, s, ngroups, sign, B, N, K, kt, cs,
                               pmax, threads, inner, cstride, per_column, stream);
      return static_cast<int>(cudaErrorInvalidValue);
    case 4:
      if constexpr (sizeof(T) * 4 <= 16)
        return launch_pc<T, 4>(in, out, bonds, poff, c, s, ngroups, sign, B, N, K, kt, cs,
                               pmax, threads, inner, cstride, per_column, stream);
      [[fallthrough]];
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Clusters of the launch (dtype, vec, N, kt, cs, pmax, threads,
// per_column) the card holds at once (the grid runs in ceil(clusters /
// this) waves). dtype: 0 float32, 1 float64, 2 complex64, 3 complex128.
int ckb_fold_resident_clusters(int dtype, int vec, int N, int kt, int cs, int pmax,
                               int threads, int per_column) {
  using c64 = ckb::cplx<float>;
  using c128 = ckb::cplx<double>;
  switch (dtype) {
    case 0:
      return vec == 4   ? clusters_pc<float, 4>(N, kt, cs, pmax, threads, per_column)
             : vec == 2 ? clusters_pc<float, 2>(N, kt, cs, pmax, threads, per_column)
                        : clusters_pc<float, 1>(N, kt, cs, pmax, threads, per_column);
    case 1:
      return vec == 2 ? clusters_pc<double, 2>(N, kt, cs, pmax, threads, per_column)
                      : clusters_pc<double, 1>(N, kt, cs, pmax, threads, per_column);
    case 2:
      return vec == 2 ? clusters_pc<c64, 2>(N, kt, cs, pmax, threads, per_column)
                      : clusters_pc<c64, 1>(N, kt, cs, pmax, threads, per_column);
    case 3:
      return clusters_pc<c128, 1>(N, kt, cs, pmax, threads, per_column);
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// Rows are [B, N, K]; row r takes its coefficients at (r / inner)·cstride
// (cstride 0: one table for all rows; Nb: one per chain; Nb·K with
// per_column: one coefficient per chain, bond and column).
int ckb_fold_f32(const float* in, float* out, const int* bonds, const int* poff,
                 const float* c, const float* s, int ngroups, double sign, int B, int N,
                 int K, int kt, int cs, int vec, int pmax, int threads, int inner,
                 long long cstride, int per_column, void* stream) {
  return launch<float>(in, out, bonds, poff, c, s, ngroups, static_cast<float>(sign), B, N,
                       K, kt, cs, vec, pmax, threads, inner, cstride, per_column, stream);
}

int ckb_fold_f64(const double* in, double* out, const int* bonds, const int* poff,
                 const double* c, const double* s, int ngroups, double sign, int B, int N,
                 int K, int kt, int cs, int vec, int pmax, int threads, int inner,
                 long long cstride, int per_column, void* stream) {
  return launch<double>(in, out, bonds, poff, c, s, ngroups, sign, B, N, K, kt, cs, vec, pmax,
                        threads, inner, cstride, per_column, stream);
}

// Complex fields and tables (interleaved re/im): the same interface, K and
// kt counted in complex elements.
int ckb_fold_c64(const void* in, void* out, const int* bonds, const int* poff, const void* c,
                 const void* s, int ngroups, double sign, int B, int N, int K, int kt, int cs,
                 int vec, int pmax, int threads, int inner, long long cstride, int per_column,
                 void* stream) {
  using T = ckb::cplx<float>;
  return launch<T>(static_cast<const T*>(in), static_cast<T*>(out), bonds, poff,
                   static_cast<const T*>(c), static_cast<const T*>(s), ngroups,
                   static_cast<float>(sign), B, N, K, kt, cs, vec, pmax, threads, inner, cstride,
                   per_column, stream);
}

int ckb_fold_c128(const void* in, void* out, const int* bonds, const int* poff, const void* c,
                  const void* s, int ngroups, double sign, int B, int N, int K, int kt, int cs,
                  int vec, int pmax, int threads, int inner, long long cstride, int per_column,
                  void* stream) {
  using T = ckb::cplx<double>;
  return launch<T>(static_cast<const T*>(in), static_cast<T*>(out), bonds, poff,
                   static_cast<const T*>(c), static_cast<const T*>(s), ngroups, sign, B, N, K,
                   kt, cs, vec, pmax, threads, inner, cstride, per_column, stream);
}

}  // extern "C"
