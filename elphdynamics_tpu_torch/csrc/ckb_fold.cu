// Checkerboard fold exp(±Δτ·K)(ᵀ)·v in one pass, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel elphdynamics_tpu/ops/ckb_pallas.py:_fold_kernel
// (driven by fold_2d). Same arithmetic: for each bond group g, in forward or
// reversed order, v <- c_g ⊙ v + sign·s_g ⊙ v[partner_g].
//
// What bounds it on the card: device-memory bytes. The fold does 3 flops per
// element per group; every field element must be read once and written once
// (2·B·N·K·itemsize bytes), and a plain fold (one gather + FMA pass per
// group, the torch twin in ops/checkerboard.py) moves that G times over.
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

template <typename T, int V>
__global__ void __launch_bounds__(ckb::kMaxThreads, 2)
    ckb_fold_kernel(const T* __restrict__ in, T* __restrict__ out,
                    const int4* __restrict__ bonds, const int* __restrict__ poff,
                    const T* __restrict__ c, const T* __restrict__ s, int ngroups,
                    T sign, int N, int K, int kt, int cs, int pmax) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const size_t sb = ckb::slab_bytes(N, cs, kt, sizeof(T));
  T* slab = reinterpret_cast<T*>(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + sb + ckb::table_bytes(pmax, sizeof(T)));

  const ckb::Tile t = ckb::tile_of_block(N, K, kt, cs);
  const ckb::ThreadMap m = ckb::thread_map<V>(kt, t.kw);
  const bool contiguous = kt == K;

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
  const ckb::BondTables<T> tb =
      ckb::load_bond_tables(smem_raw + sb, bonds, poff, c, s, ngroups, sign, t.rank, pmax);
  if (wait) ckb::mbar_wait(bar, 0);

  ckb::fold_sweep<T, V>(slab, tb, poff + cs * (ngroups + 1), ngroups, kt, t, m);

  if (contiguous) {
    ckb::copy_out(out + t.gbase, slab, t.nsites * K);
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
      ckb::slab_bytes(N, cs, kt, sizeof(T)) + ckb::table_bytes(pmax, sizeof(T)) + 16;
  return ckb::resident_clusters(ckb_fold_kernel<T, V>, smem_set<T, V>(), cs, threads, smem);
}

template <typename T, int V>
int launch_v(const T* in, T* out, const int* bonds, const int* poff, const T* c, const T* s,
             int ngroups, T sign, int B, int N, int K, int kt, int cs, int pmax, int threads,
             void* stream) {
  const size_t smem =
      ckb::slab_bytes(N, cs, kt, sizeof(T)) + ckb::table_bytes(pmax, sizeof(T)) + 16;
  return ckb::launch_cluster(ckb_fold_kernel<T, V>, smem_set<T, V>(), (K + kt - 1) / kt, B, cs,
                             threads, smem, stream, in, out,
                             reinterpret_cast<const int4*>(bonds), poff, c, s, ngroups, sign,
                             N, K, kt, cs, pmax);
}

template <typename T>
int launch(const T* in, T* out, const int* bonds, const int* poff, const T* c, const T* s,
           int ngroups, T sign, int B, int N, int K, int kt, int cs, int vec, int pmax,
           int threads, void* stream) {
  switch (vec) {
    case 1:
      return launch_v<T, 1>(in, out, bonds, poff, c, s, ngroups, sign, B, N, K, kt, cs, pmax,
                            threads, stream);
    case 2:
      return launch_v<T, 2>(in, out, bonds, poff, c, s, ngroups, sign, B, N, K, kt, cs, pmax,
                            threads, stream);
    case 4:
      if constexpr (sizeof(T) == 4)
        return launch_v<T, 4>(in, out, bonds, poff, c, s, ngroups, sign, B, N, K, kt, cs,
                              pmax, threads, stream);
      [[fallthrough]];
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Clusters of the launch (dtype64, vec, N, kt, cs, pmax, threads) the card
// holds at once (the grid runs in ceil(clusters / this) waves).
int ckb_fold_resident_clusters(int dtype64, int vec, int N, int kt, int cs, int pmax,
                               int threads) {
  if (dtype64) {
    return vec == 2 ? clusters_v<double, 2>(N, kt, cs, pmax, threads)
                    : clusters_v<double, 1>(N, kt, cs, pmax, threads);
  }
  return vec == 4   ? clusters_v<float, 4>(N, kt, cs, pmax, threads)
         : vec == 2 ? clusters_v<float, 2>(N, kt, cs, pmax, threads)
                    : clusters_v<float, 1>(N, kt, cs, pmax, threads);
}

int ckb_fold_f32(const float* in, float* out, const int* bonds, const int* poff,
                 const float* c, const float* s, int ngroups, double sign, int B, int N,
                 int K, int kt, int cs, int vec, int pmax, int threads, void* stream) {
  return launch<float>(in, out, bonds, poff, c, s, ngroups, static_cast<float>(sign), B, N,
                       K, kt, cs, vec, pmax, threads, stream);
}

int ckb_fold_f64(const double* in, double* out, const int* bonds, const int* poff,
                 const double* c, const double* s, int ngroups, double sign, int B, int N,
                 int K, int kt, int cs, int vec, int pmax, int threads, void* stream) {
  return launch<double>(in, out, bonds, poff, c, s, ngroups, sign, B, N, K, kt, cs, vec, pmax,
                        threads, stream);
}

}  // extern "C"
