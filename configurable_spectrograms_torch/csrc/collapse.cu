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
// Design: lanes are grouped by cube, up to CST_GROUP lanes a group, by
// the rule of `ops.kernels.lane_groups`: the lanes of one cube in index
// order, cut into runs of CST_GROUP; a group is found in the kernel from
// u_idx (warp ballots), so the wrapper launches once and does no host
// work.  Grid: (row-and-column tiles, lane slots); a block whose slot does
// not lead a group exits at once.  A thread owns one (t, 4 columns) cell
// of its group and reads each (t, a, e) element ONCE -- a 16-byte load
// where E % 4 == 0, a 4-byte one otherwise -- and adds it, predicated, to
// the register accumulator of every lane of the group whose mask selects
// a; the NaN test is made once per element.  The group's masks sit in
// shared memory as one byte of lane bits per pitch bin; a bin no lane
// selects is not read.  Four bins' loads are issued before their adds:
// that keeps a thread at 56 registers (G = 8), so an SM holds enough
// threads to keep loads in flight (eight bins a batch took more registers
// and ran slower on the H100).
//
// Exactness: each lane adds its selected pitch slices IN INDEX ORDER in
// fp32 (`__fadd_rn`); NaN adds +0.0 and an unselected entry adds nothing,
// which equals the +0.0 that `collapse_lanes_plain` adds (a sum that starts
// at +0.0 never becomes -0.0), so the result is bit-identical to it and to
// the numpy host collapse.  +/-inf propagate.  Rows at or past t_valid[l]
// are written as NaN (padding rows of a bucket).

#include "collapse_common.cuh"

#define CST_GROUP 8      // lanes a group (a byte of lane bits per pitch bin)
#define CST_UNROLL 4     // pitch bins whose loads are in flight together

template <int VEC>
struct CstVec;
template <>
struct CstVec<4> {
    using T = float4;
    static __device__ __forceinline__ float get(const float4& v, int c) {
        return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
    }
};
template <>
struct CstVec<1> {
    using T = float;
    static __device__ __forceinline__ float get(const float& v, int) { return v; }
};

// Lanes of this block's group: s_lanes[0..n), s_sel[a] bit g = lane g selects a.
template <int G, int VEC>
__device__ __forceinline__ void cst_collapse_group(const float* __restrict__ cube,
                                                   const uint8_t* __restrict__ s_sel,
                                                   const int* __restrict__ s_lanes,
                                                   const int* __restrict__ s_tv, int n, int t_max,
                                                   float* __restrict__ out, int t, int col, int T, int A,
                                                   int E) {
    using V = typename CstVec<VEC>::T;
    float acc[G][VEC];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
        for (int c = 0; c < VEC; ++c) acc[g][c] = 0.0f;

    if (t < t_max) {
        const float* p = cube + (size_t)t * A * E + col;
        for (int a0 = 0; a0 < A; a0 += CST_UNROLL) {
            V x[CST_UNROLL];
            unsigned sel[CST_UNROLL];
#pragma unroll
            for (int j = 0; j < CST_UNROLL; ++j) {
                const int a = a0 + j;
                sel[j] = a < A ? s_sel[a] : 0u;
                if (sel[j]) {
                    x[j] = __ldg(reinterpret_cast<const V*>(p + (size_t)a * E));
                } else {
                    x[j] = V{};
                }
            }
#pragma unroll
            for (int j = 0; j < CST_UNROLL; ++j) {
                float v[VEC];
#pragma unroll
                for (int c = 0; c < VEC; ++c) {
                    const float y = CstVec<VEC>::get(x[j], c);
                    v[c] = isnan(y) ? 0.0f : y;
                }
                // A skipped add equals adding +0.0: the sum starts at +0.0 and
                // never becomes -0.0 under round-to-nearest.
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    if ((sel[j] >> g) & 1u) {
#pragma unroll
                        for (int c = 0; c < VEC; ++c) acc[g][c] = __fadd_rn(acc[g][c], v[c]);
                    }
                }
            }
        }
    }

#pragma unroll
    for (int g = 0; g < G; ++g) {
        if (g < n) {
            const bool live = t < s_tv[g];
            float r[VEC];
#pragma unroll
            for (int c = 0; c < VEC; ++c) r[c] = live ? acc[g][c] : cst_nan();
            float* o = out + ((size_t)s_lanes[g] * T + t) * E + col;
            if (VEC == 4) {
                *reinterpret_cast<float4*>(o) = make_float4(r[0], r[1], r[2], r[3]);
            } else {
                o[0] = r[0];
            }
        }
    }
}

template <int VEC>
__global__ void cst_collapse_kernel(const float* __restrict__ cubes, const int* __restrict__ u_idx,
                                    const uint8_t* __restrict__ masks, const int* __restrict__ t_valid,
                                    float* __restrict__ out, int L, int T, int A, int E) {
    extern __shared__ uint8_t s_sel[];  // A bytes
    __shared__ int s_lanes[CST_GROUP];
    __shared__ int s_tv[CST_GROUP];
    __shared__ int s_n;
    __shared__ int s_tmax;

    const int s = blockIdx.y;  // the lane slot this block would lead
    if (threadIdx.x < 32) {
        // Group of slot s: the lanes l >= s with u_idx[l] == u_idx[s], the first
        // CST_GROUP of them, led by s only if s's rank among its cube's lanes is a
        // multiple of CST_GROUP.
        const int lane = threadIdx.x;
        const int u = u_idx[s];
        int rank = 0;
        int n = 0;
        for (int base = 0; base < L && n < CST_GROUP; base += 32) {
            const int l = base + lane;
            const bool m = l < L && u_idx[l] == u;
            rank += __popc(__ballot_sync(0xffffffffu, m && l < s));
            unsigned after = __ballot_sync(0xffffffffu, m && l >= s);
            while (after && n < CST_GROUP) {
                const int b = __ffs(after) - 1;
                after &= after - 1;
                if (lane == 0) s_lanes[n] = base + b;
                ++n;
            }
        }
        if (lane == 0) s_n = (rank % CST_GROUP == 0) ? n : 0;
    }
    __syncthreads();
    const int n = s_n;
    if (n == 0) return;
    for (int a = threadIdx.x; a < A; a += blockDim.x) {
        unsigned bits = 0;
        for (int g = 0; g < n; ++g) bits |= (masks[(size_t)s_lanes[g] * A + a] ? 1u : 0u) << g;
        s_sel[a] = (uint8_t)bits;
    }
    if (threadIdx.x == 0) {
        int tmax = 0;
        for (int g = 0; g < n; ++g) {
            s_tv[g] = t_valid[s_lanes[g]];
            tmax = max(tmax, s_tv[g]);
        }
        s_tmax = tmax;
    }
    __syncthreads();

    const int n_vec = E / VEC;
    const long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (item >= (long long)T * n_vec) return;
    const int t = (int)(item / n_vec);
    const int col = (int)(item % n_vec) * VEC;
    const float* cube = cubes + (size_t)u_idx[s] * T * A * E;
    // The widest accumulator set the group needs (a compile-time width each).
    if (n == 1) {
        cst_collapse_group<1, VEC>(cube, s_sel, s_lanes, s_tv, n, s_tmax, out, t, col, T, A, E);
    } else if (n == 2) {
        cst_collapse_group<2, VEC>(cube, s_sel, s_lanes, s_tv, n, s_tmax, out, t, col, T, A, E);
    } else if (n <= 4) {
        cst_collapse_group<4, VEC>(cube, s_sel, s_lanes, s_tv, n, s_tmax, out, t, col, T, A, E);
    } else {
        cst_collapse_group<CST_GROUP, VEC>(cube, s_sel, s_lanes, s_tv, n, s_tmax, out, t, col, T, A, E);
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
