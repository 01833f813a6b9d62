// One KPM Chebyshev step in one pass, for NVIDIA Hopper (sm_90a):
//
//     o = a·(post ⊙ fold(pre ⊙ v)) + b·v + c·prev
//
// with fold the checkerboard product exp(±Δτ·K̄)(ᵀ) (ckb_fold_groups.cuh).
//
// Replaces the Pallas TPU kernel elphdynamics_tpu/ops/ckb_pallas.py:
// _fold_fused_kernel (driven by fold_kn_fused; caller
// kpm.py:_chebyshev_apply_stacked_pallas). pre/post carry the averaged
// exp(−Δτ·V̄) diagonal of Ā (pre for Ā, post for Āᵀ); a = a_mul/λmag and
// b = −a_mul·λavg/λmag the spectral-window map; c = −1 with prev gives the
// recurrence u₊ = 2·Ap(u) − u₋.
//
// What bounds it on the card: device-memory bytes, like the plain fold. The
// recurrence written out (fold kernel, then the diagonal, the affine map and
// the combine as separate elementwise passes) reads and writes the field
// about five times per step; this kernel reads v once into the slab, re-reads
// v and prev once in the epilogue (at the thread's own index, so mostly from
// L2: the block has just loaded the same rows) and writes o once.
//
// Design (the plain fold's, ckb_fold.cu, plus a prologue and an epilogue):
//   * field layout [B, N, K] row-major, B = C·inner rows, where C is the
//     number of chains and row r belongs to chain r / inner (the Green's
//     solves run [C, nᵥ, N, 2Lω], the HMC solves [C, 2, N, 2Lω]);
//   * per chain: a[C], b[C] and the diagonals pre/post [C, N] (either may be
//     null); c is one scalar; prev may be null;
//   * block (tile, r) owns row r and columns [tile·kt, tile·kt + kw); one
//     [N, kt] slab in dynamic shared memory, pre applied while loading; no
//     second slab (it would halve kt);
//   * o must not alias v or prev (every pointer is __restrict__); the
//     wrapper allocates o.
// The Pallas kernel's lane rolls and [K, N] transposes are not carried over.

#include <cuda_runtime.h>

#include "ckb_fold_groups.cuh"

namespace {

template <typename T>
__global__ void ckb_fold_fused_kernel(
    const T* __restrict__ in, T* __restrict__ out, const T* __restrict__ prev,
    const int* __restrict__ bi, const int* __restrict__ bj,
    const T* __restrict__ c, const T* __restrict__ s,
    const int* __restrict__ goff, int ngroups, int reverse, T sign,
    const T* __restrict__ pre, const T* __restrict__ post,
    const T* __restrict__ a, const T* __restrict__ b, T cprev, int N, int K,
    int kt, int inner) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slab = reinterpret_cast<T*>(smem_raw);

  const int row = blockIdx.y;
  const int chain = row / inner;
  const int k0 = blockIdx.x * kt;
  const int kw = min(kt, K - k0);
  if (kw <= 0) return;
  const size_t base = static_cast<size_t>(row) * N * K + k0;
  const T* src = in + base;
  const T* pre_c = pre ? pre + static_cast<size_t>(chain) * N : nullptr;
  const T* post_c = post ? post + static_cast<size_t>(chain) * N : nullptr;

  const int nload = N * kw;
  for (int idx = threadIdx.x; idx < nload; idx += blockDim.x) {
    const int i = idx / kw;
    const int col = idx - i * kw;
    T x = src[static_cast<size_t>(i) * K + col];
    if (pre_c) x *= pre_c[i];
    slab[i * kt + col] = x;
  }
  __syncthreads();

  ckb_fold_slab(slab, bi, bj, c, s, goff, ngroups, reverse, sign, kt, kw);

  const T ac = a[chain];
  const T bc = b[chain];
  for (int idx = threadIdx.x; idx < nload; idx += blockDim.x) {
    const int i = idx / kw;
    const int col = idx - i * kw;
    const size_t off = static_cast<size_t>(i) * K + col;
    T f = slab[i * kt + col];
    if (post_c) f *= post_c[i];
    T o = ac * f + bc * src[off];
    if (prev) o += cprev * prev[base + off];
    out[base + off] = o;
  }
}

template <typename T>
int launch(const T* in, T* out, const T* prev, const int* bi, const int* bj,
           const T* c, const T* s, const int* goff, int ngroups, int reverse,
           T sign, const T* pre, const T* post, const T* a, const T* b,
           T cprev, int B, int N, int K, int kt, int inner, int threads,
           void* stream) {
  const size_t smem = static_cast<size_t>(N) * kt * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      ckb_fold_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((K + kt - 1) / kt, B);
  ckb_fold_fused_kernel<T><<<grid, threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      in, out, prev, bi, bj, c, s, goff, ngroups, reverse, sign, pre, post, a,
      b, cprev, N, K, kt, inner);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ckb_fold_fused_f32(const float* in, float* out, const float* prev,
                       const int* bi, const int* bj, const float* c,
                       const float* s, const int* goff, int ngroups,
                       int reverse, double sign, const float* pre,
                       const float* post, const float* a, const float* b,
                       double cprev, int B, int N, int K, int kt, int inner,
                       int threads, void* stream) {
  return launch<float>(in, out, prev, bi, bj, c, s, goff, ngroups, reverse,
                       static_cast<float>(sign), pre, post, a, b,
                       static_cast<float>(cprev), B, N, K, kt, inner, threads,
                       stream);
}

int ckb_fold_fused_f64(const double* in, double* out, const double* prev,
                       const int* bi, const int* bj, const double* c,
                       const double* s, const int* goff, int ngroups,
                       int reverse, double sign, const double* pre,
                       const double* post, const double* a, const double* b,
                       double cprev, int B, int N, int K, int kt, int inner,
                       int threads, void* stream) {
  return launch<double>(in, out, prev, bi, bj, c, s, goff, ngroups, reverse,
                        sign, pre, post, a, b, cprev, B, N, K, kt, inner,
                        threads, stream);
}

}  // extern "C"
