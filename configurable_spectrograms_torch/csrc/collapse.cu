// Pitch-collapse kernel: (U, T, A, E) cubes -> (L, T, E) masked nansum,
// one pass over each cube for all of its lanes.
//
// Replaces the Pallas kernel `_collapse_kernel` / `collapse_cube_pallas`
// in configurable_spectrograms_tpu/ops/pallas_kernels.py.  On the TPU that
// kernel streamed (t_tile, A, E) blocks of one cube through VMEM on a
// sequential grid; here every lane of a render bucket (or every file of an
// extrema batch) goes in ONE launch.
//
// Bound: memory.  The least work is one read of each cube a lane uses and
// one write of every lane's (T, E) matrix: for a bucket of 8 lanes on one
// 8192 x 64 x 128 cube, 268.4 MB + 33.6 MB, 0.090 ms at 3.35 TB/s.
//
// Design: the collapse of collapse_common.cuh (lane groups by cube, one
// read of each cube element per group, predicated in-order adds; its
// header states the layout and why the sums are bit-identical to
// `collapse_lanes_plain`).  Grid: (row-and-column tiles, lane slots).  A
// thread owns one (t, 4 columns) cell of its group and writes each lane's
// sums; rows at or past t_valid[l] are written as NaN (padding rows of a
// bucket).

#include "collapse_common.cuh"

template <int G, int VEC>
__device__ __forceinline__ void cst_collapse_group(const float* __restrict__ cube,
                                                   const uint8_t* __restrict__ s_sel, const CstGroup& grp,
                                                   float* __restrict__ out, int t, int col, int T, int A,
                                                   int E) {
    float acc[G][VEC];
    cst_accumulate<G, VEC>(cube, s_sel, t < grp.tmax, t, col, A, E, acc);
#pragma unroll
    for (int g = 0; g < G; ++g) {
        if (g < grp.n) {
            const bool live = t < grp.tv[g];
            float r[VEC];
#pragma unroll
            for (int c = 0; c < VEC; ++c) r[c] = live ? acc[g][c] : cst_nan();
            cst_store<VEC>(out + ((size_t)grp.lanes[g] * T + t) * E + col, r);
        }
    }
}

template <int VEC>
__global__ void cst_collapse_kernel(const float* __restrict__ cubes, const int* __restrict__ u_idx,
                                    const uint8_t* __restrict__ masks, const int* __restrict__ t_valid,
                                    float* __restrict__ out, int L, int T, int A, int E) {
    extern __shared__ uint8_t s_sel[];  // A bytes
    __shared__ CstGroup grp;

    const int s = blockIdx.y;  // the lane slot this block would lead
    const int n = cst_load_group(u_idx, masks, t_valid, L, A, s, grp, s_sel);
    if (n == 0) return;

    const int n_vec = E / VEC;
    const long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (item >= (long long)T * n_vec) return;
    const int t = (int)(item / n_vec);
    const int col = (int)(item % n_vec) * VEC;
    const float* cube = cubes + (size_t)u_idx[s] * T * A * E;
    // The widest accumulator set the group needs (a compile-time width each).
    if (n == 1) {
        cst_collapse_group<1, VEC>(cube, s_sel, grp, out, t, col, T, A, E);
    } else if (n == 2) {
        cst_collapse_group<2, VEC>(cube, s_sel, grp, out, t, col, T, A, E);
    } else if (n <= 4) {
        cst_collapse_group<4, VEC>(cube, s_sel, grp, out, t, col, T, A, E);
    } else {
        cst_collapse_group<CST_GROUP, VEC>(cube, s_sel, grp, out, t, col, T, A, E);
    }
}

extern "C" int cst_collapse(const float* cubes, const int* u_idx, const uint8_t* masks,
                            const int* t_valid, float* out, int L, int T, int A, int E,
                            void* stream) {
    if (L <= 0 || T <= 0 || E <= 0) return 0;
    if (L > 65535) return (int)cudaErrorInvalidConfiguration;
    // 16-byte rows need E % 4 == 0 (torch allocations are 256-byte aligned).
    const bool vec4 = E % 4 == 0 && (reinterpret_cast<uintptr_t>(cubes) & 15) == 0 &&
                      (reinterpret_cast<uintptr_t>(out) & 15) == 0;
    const long long items = (long long)T * (vec4 ? E / 4 : E);
    // Small cubes get 64-thread blocks so that a single group still spreads over the 132 SMs.
    const int threads = items >= 132LL * 4 * 128 ? 128 : 64;
    const long long bx = (items + threads - 1) / threads;
    if (bx > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)bx, (unsigned)L);
    const size_t smem = (size_t)A;
    if (vec4) {
        cst_collapse_kernel<4><<<grid, threads, smem, (cudaStream_t)stream>>>(cubes, u_idx, masks, t_valid, out,
                                                                               L, T, A, E);
    } else {
        cst_collapse_kernel<1><<<grid, threads, smem, (cudaStream_t)stream>>>(cubes, u_idx, masks, t_valid, out,
                                                                               L, T, A, E);
    }
    return (int)cudaGetLastError();
}
