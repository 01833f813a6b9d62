// The group sweep of the checkerboard fold on a shared-memory slab, shared
// by the plain fold (ckb_fold.cu) and the fused Chebyshev step
// (ckb_fold_fused.cu).
//
// The slab holds a [N, kw] block of one batch row with row stride kt. For
// each bond group g, in forward or reversed order,
//     v <- c_g ⊙ v + sign·s_g ⊙ v[partner_g].
// Within a group the bonds are disjoint, so one thread per (bond, column)
// reads both endpoints and writes both new values: no two threads touch one
// site. __syncthreads() separates the groups and ends the sweep, so the
// caller may read any slab element afterwards.
//
// Bond tables: endpoints bi/bj [nb] in checkerboard order, group offsets
// goff [G+1], coefficients c/s [nb]; sign = −1 gives the inverse. With no
// groups the sweep does nothing and the slab keeps what was loaded.
//
// Also the card's opt-in shared-memory budget, which sizes the slab: each
// library that includes this header exports it.

#pragma once

#include <cuda_runtime.h>

template <typename T>
__device__ __forceinline__ void ckb_fold_slab(T* slab, const int* __restrict__ bi,
                                              const int* __restrict__ bj,
                                              const T* __restrict__ c,
                                              const T* __restrict__ s,
                                              const int* __restrict__ goff,
                                              int ngroups, int reverse, T sign,
                                              int kt, int kw) {
  for (int gi = 0; gi < ngroups; ++gi) {
    const int g = reverse ? ngroups - 1 - gi : gi;
    const int b0 = goff[g];
    const int nwork = (goff[g + 1] - b0) * kw;
    for (int idx = threadIdx.x; idx < nwork; idx += blockDim.x) {
      const int r = idx / kw;
      const int col = idx - r * kw;
      const int n = b0 + r;
      const int i = bi[n];
      const int j = bj[n];
      const T cc = c[n];
      const T ss = sign * s[n];
      const T vi = slab[i * kt + col];
      const T vj = slab[j * kt + col];
      slab[i * kt + col] = cc * vi + ss * vj;
      slab[j * kt + col] = cc * vj + ss * vi;
    }
    __syncthreads();
  }
}

// Largest dynamic shared memory a block may opt in to on `device` (bytes),
// or a negative CUDA error code.
extern "C" int ckb_smem_optin(int device) {
  int v = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? v : -static_cast<int>(err);
}
