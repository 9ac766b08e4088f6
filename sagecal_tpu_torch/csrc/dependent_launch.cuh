// Hopper's programmatic dependent launch (sm_90), shared by the kbisect
// gather probes #9 and #10 (csrc/kbisect_a.cu, kbisect_f.cu): a kernel
// launched as a programmatic dependent of the stream's previous kernel
// may start while that kernel runs, so its launch latency hides behind
// it; it waits for the earlier kernel's memory only where it reads it.

#pragma once

#include <cuda_runtime.h>

namespace {

// In the earlier kernel: let the dependent's blocks start now.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// In the dependent: wait until the earlier kernel has finished and its
// writes are visible.
__device__ __forceinline__ void wait_for_prerequisites() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Launch ``kernel`` as a programmatic dependent of the stream's previous
// kernel.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block,
                             cudaStream_t st, Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace
