// The grid of a persistent kernel: blocks whose warps claim their work
// from a global counter until it runs out.  Used by row_agg.cu (the row
// walks) and bitgat.cu (K5's listed walk).
#pragma once

#include <cuda_runtime.h>

// Blocks of `threads` threads for `kernel`: as many as fit the current
// device at once (at most `max_per_sm` an SM where it is above 0), and no
// more than `needed` (at least one).
template <typename K>
cudaError_t persistent_blocks(K kernel, int threads, long long needed,
                              unsigned* blocks, int max_per_sm = 0) {
  int device = 0, per_sm = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (max_per_sm > 0 && per_sm > max_per_sm) per_sm = max_per_sm;
  const long long fit = static_cast<long long>(sms) * (per_sm > 0 ? per_sm
                                                                  : 1);
  const long long n = needed < fit ? needed : fit;
  *blocks = static_cast<unsigned>(n > 0 ? n : 1);
  return cudaSuccess;
}
