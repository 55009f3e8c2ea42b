// Shared helpers for the port's Hopper kernels: element conversion between
// the activation types the kernels take (f32, bf16) and the f32 the math
// runs in, and the dynamic shared-memory opt-in above the 48 KB default.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// dtype codes shared with the Python wrappers (kernels/build.py)
#define REPRO_DT_F32 0
#define REPRO_DT_BF16 1

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

// Kernels size their shared memory from runtime shapes; above 48 KB the
// launch must opt in first or it is refused.
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}
