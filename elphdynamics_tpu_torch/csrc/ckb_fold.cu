// Checkerboard fold exp(±Δτ·K)(ᵀ)·v in one pass, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel elphdynamics_tpu/ops/ckb_pallas.py:_fold_kernel
// (driven by fold_2d). Same arithmetic: for each bond group g, in forward or
// reversed order, v <- c_g ⊙ v + sign·s_g ⊙ v[partner_g].
//
// What bounds it on the card: device-memory bytes. The fold does 3 flops per
// element per group, so a plain fold (one gather + FMA pass per group, the
// torch twin in ops/checkerboard.py) moves G reads and G writes of the whole
// field through device memory. This kernel keeps a [N, kt] slab of one batch
// element in shared memory for the whole fold, so every field element is read
// once and written once per fold, whatever the number of groups. The slab
// loads and stores move kt-wide row segments of the [B, N, K] field, so the
// kernel runs well below that bound (measured in PERF.md); a layout with
// sites contiguous is the first lever for making it faster.
//
// Design:
//   * one launch per fold; block (tile, b) owns batch element b and columns
//     [tile·kt, tile·kt + kt) of the [B, N, K] row-major field;
//   * the slab [N, kt] lives in dynamic shared memory (kt is chosen by the
//     wrapper from the opt-in shared-memory budget of the card);
//   * the groups run in order on the slab (ckb_fold_groups.cuh, shared with
//     the fused Chebyshev step of ckb_fold_fused.cu).
// The mask/roll offset classes and [N,K]→[K,N] transposes of the Pallas
// kernel existed only because Mosaic has no dynamic gather; they are gone.

#include <cuda_runtime.h>

#include "ckb_fold_groups.cuh"

namespace {

template <typename T>
__global__ void ckb_fold_kernel(const T* __restrict__ in, T* __restrict__ out,
                                const int* __restrict__ bi,
                                const int* __restrict__ bj,
                                const T* __restrict__ c,
                                const T* __restrict__ s,
                                const int* __restrict__ goff, int ngroups,
                                int reverse, T sign, int N, int K, int kt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slab = reinterpret_cast<T*>(smem_raw);

  const int b = blockIdx.y;
  const int k0 = blockIdx.x * kt;
  const int kw = min(kt, K - k0);
  if (kw <= 0) return;
  const size_t base = static_cast<size_t>(b) * N * K + k0;
  const T* src = in + base;
  T* dst = out + base;

  // load the [N, kw] slab (row stride kt in shared memory, K in the field)
  const int nload = N * kw;
  for (int idx = threadIdx.x; idx < nload; idx += blockDim.x) {
    const int i = idx / kw;
    const int col = idx - i * kw;
    slab[i * kt + col] = src[static_cast<size_t>(i) * K + col];
  }
  __syncthreads();

  ckb_fold_slab(slab, bi, bj, c, s, goff, ngroups, reverse, sign, kt, kw);

  for (int idx = threadIdx.x; idx < nload; idx += blockDim.x) {
    const int i = idx / kw;
    const int col = idx - i * kw;
    dst[static_cast<size_t>(i) * K + col] = slab[i * kt + col];
  }
}

template <typename T>
int launch(const T* in, T* out, const int* bi, const int* bj, const T* c,
           const T* s, const int* goff, int ngroups, int reverse, T sign,
           int B, int N, int K, int kt, int threads, void* stream) {
  const size_t smem = static_cast<size_t>(N) * kt * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      ckb_fold_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((K + kt - 1) / kt, B);
  ckb_fold_kernel<T><<<grid, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      in, out, bi, bj, c, s, goff, ngroups, reverse, sign, N, K, kt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ckb_fold_f32(const float* in, float* out, const int* bi, const int* bj,
                 const float* c, const float* s, const int* goff, int ngroups,
                 int reverse, double sign, int B, int N, int K, int kt,
                 int threads, void* stream) {
  return launch<float>(in, out, bi, bj, c, s, goff, ngroups, reverse,
                       static_cast<float>(sign), B, N, K, kt, threads, stream);
}

int ckb_fold_f64(const double* in, double* out, const int* bi, const int* bj,
                 const double* c, const double* s, const int* goff,
                 int ngroups, int reverse, double sign, int B, int N, int K,
                 int kt, int threads, void* stream) {
  return launch<double>(in, out, bi, bj, c, s, goff, ngroups, reverse, sign,
                        B, N, K, kt, threads, stream);
}

}  // extern "C"
