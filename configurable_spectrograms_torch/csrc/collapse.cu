// Pitch-collapse kernel: (U, T, A, E) cubes -> (L, T, E) masked nansum.
//
// Replaces the Pallas kernel `_collapse_kernel` / `collapse_cube_pallas`
// in configurable_spectrograms_tpu/ops/pallas_kernels.py.  On the TPU that
// kernel streamed (t_tile, A, E) blocks through VMEM on a sequential grid;
// here every lane of a render bucket (or every file of an extrema batch)
// goes in ONE launch, one thread per (lane, t, e) cell.
//
// Bound: memory.  A lane reads T*A*E*4 bytes (only its selected pitch
// slices, in fact) and writes T*E*4, with a handful of adds per 4 bytes
// read -- at 3.35 TB/s an 8192 x 64 x 128 cube (268 MB) needs ~80 us.
// Design: adjacent threads take adjacent e, so each (t, a) row is one
// coalesced 128-byte load per warp; each thread loops over a in index
// order (see collapse_common.cuh) so results are bit-identical to the
// host collapse.  No shared memory, no atomics.  Rows at or past
// t_valid[l] are written as NaN (padding rows of a bucket).

#include "collapse_common.cuh"

__global__ void cst_collapse_kernel(const float* __restrict__ cubes,
                                    const int* __restrict__ u_idx,
                                    const uint8_t* __restrict__ masks,
                                    const int* __restrict__ t_valid,
                                    float* __restrict__ out,
                                    int T, int A, int E) {
    const int l = blockIdx.z;
    const int e = blockIdx.x * CST_COLS_PER_BLOCK + threadIdx.x;
    if (e >= E) return;
    const float* cube = cubes + (size_t)u_idx[l] * T * A * E;
    const uint8_t* mask = masks + (size_t)l * A;
    const int tv = t_valid[l];
    float* o = out + (size_t)l * T * E;
    const int t0 = blockIdx.y * CST_ROWS_PER_BLOCK;
    for (int k = threadIdx.y; k < CST_ROWS_PER_BLOCK; k += CST_ROW_THREADS) {
        const int t = t0 + k;
        if (t >= T) break;
        o[(size_t)t * E + e] = (t < tv) ? cst_collapse_cell(cube, mask, t, e, A, E) : cst_nan();
    }
}

extern "C" int cst_collapse(const float* cubes, const int* u_idx, const uint8_t* masks,
                            const int* t_valid, float* out, int L, int T, int A, int E,
                            void* stream) {
    const dim3 block(CST_COLS_PER_BLOCK, CST_ROW_THREADS);
    const dim3 grid((E + CST_COLS_PER_BLOCK - 1) / CST_COLS_PER_BLOCK,
                    (T + CST_ROWS_PER_BLOCK - 1) / CST_ROWS_PER_BLOCK, L);
    cst_collapse_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(cubes, u_idx, masks, t_valid,
                                                                   out, T, A, E);
    return (int)cudaGetLastError();
}
