// Launching a kernel whose lanes each run on a thread-block cluster,
// shared by the kernels that split a lane over a cluster (coupled.cu,
// closed_form.cu).

#pragma once

#include <cuda_runtime.h>

namespace {

// The launch of `lanes` clusters of `cluster` blocks of `threads` threads
// each (block b of the grid is rank b % cluster of lane b / cluster) with
// `smem` bytes of dynamic shared memory a block; `attr` holds its one
// attribute, the cluster's size.
inline cudaLaunchConfig_t cluster_config(int lanes, int cluster, int threads, size_t smem,
                                         cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(lanes) * static_cast<unsigned>(cluster));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launches `kernel` as cluster_config describes.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int lanes, int cluster, int threads,
                           size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(lanes, cluster, threads, smem, stream, &attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace
