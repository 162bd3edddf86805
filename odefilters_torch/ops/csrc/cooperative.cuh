// The cooperative launch of the kernels that meet at grid barriers
// (kron_grid.cu, tp_scan.cuh). A grid whose CTAs are not all resident at
// once would hang at its first barrier, so the launch is refused with
// cudaErrorCooperativeLaunchTooLarge unless the card launches cooperatively
// and holds every CTA: the occupancy per SM times the SM count.
#pragma once

#include <cuda_runtime.h>

namespace coop {

// Launches `kernel` on `blocks` CTAs of `threads` threads with `shared`
// bytes of dynamic shared memory on `stream`; returns the CUDA error code.
inline int launch_cooperative(const void* kernel, int blocks, int threads,
                              void** args, size_t shared, void* stream) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, shared);
  if (e != cudaSuccess) return (int)e;
  if (!coop || blocks > per_sm * sms)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  return (int)cudaLaunchCooperativeKernel(kernel, blocks, threads, args,
                                          shared, (cudaStream_t)stream);
}

}  // namespace coop
