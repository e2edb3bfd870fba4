// Shared pieces of the pitch-collapse kernels: fused_quantize.cu's
// per-lane collapse, and the NaN of both it and collapse.cu.
//
// Layout: cubes (U, T, A, E) float32, contiguous; a lane l reads cube
// u_idx[l] under its own pitch mask masks[l, :] (uint8 0/1).  A
// fused_quantize block is 32 x 8 threads: threadIdx.x walks 32 adjacent
// energy columns (so a warp reads 128 contiguous bytes of one (t, a) row),
// threadIdx.y walks rows, and each block covers CST_ROWS_PER_BLOCK time
// rows of one lane.
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#define CST_COLS_PER_BLOCK 32
#define CST_ROW_THREADS 8
#define CST_ROWS_PER_BLOCK 64

// The sentinel both JAX paths use for "no finite positive value".
#define CST_BIG 3.0e38f

__device__ __forceinline__ float cst_nan() { return __int_as_float(0x7fc00000); }

// Masked nansum over the pitch axis for one (t, e) cell.  The selected
// pitch slices are added one by one IN INDEX ORDER in float32: only that
// order matches the numpy host collapse bit for bit (a tree or split-A
// reduction changes the last ulp).  Unselected slices are not even read.
// NaN counts as 0; +/-inf propagate as in np.nansum.
__device__ __forceinline__ float cst_collapse_cell(const float* __restrict__ cube,
                                                   const uint8_t* __restrict__ mask,
                                                   int t, int e, int A, int E) {
    const float* p = cube + (size_t)t * A * E + e;
    float acc = 0.0f;
    for (int a = 0; a < A; ++a) {
        if (mask[a]) {
            const float v = __ldg(p + (size_t)a * E);
            if (!isnan(v)) acc = __fadd_rn(acc, v);
        }
    }
    return acc;
}
