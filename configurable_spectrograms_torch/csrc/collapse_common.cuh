// The pitch collapse that collapse.cu and fused_quantize.cu both run: lane
// groups, the group's pitch masks in shared memory, and the in-order,
// predicated accumulation of one (t, VEC columns) cell for every lane of a
// group.
//
// Layout: cubes (U, T, A, E) float32, contiguous; lane l reads cube
// u_idx[l] under its own pitch mask masks[l, :] (uint8 0/1).  Lanes are
// grouped by cube, up to CST_GROUP lanes a group, by the rule of
// `ops.kernels.lane_groups`: the lanes of one cube in index order, cut into
// runs of CST_GROUP.  A kernel launches one block row per lane slot
// (blockIdx.y); cst_load_group finds the slot's group with warp ballots
// over u_idx, so there is no host work, and a block whose slot does not
// lead a group exits at once.  The group's masks sit in shared memory as
// one byte of lane bits per pitch bin; a bin no lane selects is not read.
//
// Bound: memory.  Each (t, a, e) element of a cube is read ONCE per group --
// a 16-byte load where E % 4 == 0, a 4-byte one otherwise -- and added,
// predicated, to the register accumulator of every lane of the group whose
// mask selects a; the NaN test is made once per element.  Four bins' loads
// are issued before their adds (CST_UNROLL): at G = 8 that keeps a thread
// near 56 registers, so an SM holds enough threads to keep loads in flight.
//
// Exactness: each lane adds its selected pitch slices IN INDEX ORDER in
// fp32 (`__fadd_rn`); NaN adds +0.0 and an unselected entry adds nothing,
// which equals the +0.0 that `collapse_lanes_plain` adds (a sum that starts
// at +0.0 never becomes -0.0 under round-to-nearest), so every lane's sum
// is bit-identical to it and to the numpy host collapse (a tree or split-A
// reduction would change the last ulp).  +/-inf propagate as in np.nansum.
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#define CST_GROUP 8   // lanes a group (a byte of lane bits per pitch bin)
#define CST_UNROLL 4  // pitch bins whose loads are in flight together

// What the safe-floor minimum of _analyze_matrix takes for a cell that is
// not finite and positive inside the lane's window and e_valid.
#define CST_BIG 3.0e38f

__device__ __forceinline__ float cst_nan() { return __int_as_float(0x7fc00000); }

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

// A block's lane group, in shared memory.
struct CstGroup {
    int lanes[CST_GROUP];  // lane indices, in index order
    int tv[CST_GROUP];     // their t_valid
    int n;                 // lanes in the group; 0 when the block's slot leads none
    int tmax;              // the largest t_valid: rows at or past it read nothing
};

// Find the group that lane slot s leads, and put its mask bits in s_sel
// (A bytes, bit g = lane g selects the bin).  Every thread of the block
// calls it (it synchronises); it returns the group's size, 0 when slot s
// leads no group -- the same for every thread, so the caller may return.
__device__ __forceinline__ int cst_load_group(const int* __restrict__ u_idx, const uint8_t* __restrict__ masks,
                                              const int* __restrict__ t_valid, int L, int A, int s,
                                              CstGroup& grp, uint8_t* __restrict__ s_sel) {
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
                if (lane == 0) grp.lanes[n] = base + b;
                ++n;
            }
        }
        if (lane == 0) grp.n = (rank % CST_GROUP == 0) ? n : 0;
    }
    __syncthreads();
    const int n = grp.n;
    if (n == 0) return 0;
    for (int a = threadIdx.x; a < A; a += blockDim.x) {
        unsigned bits = 0;
        for (int g = 0; g < n; ++g) bits |= (masks[(size_t)grp.lanes[g] * A + a] ? 1u : 0u) << g;
        s_sel[a] = (uint8_t)bits;
    }
    if (threadIdx.x == 0) {
        int tmax = 0;
        for (int g = 0; g < n; ++g) {
            grp.tv[g] = t_valid[grp.lanes[g]];
            tmax = max(tmax, grp.tv[g]);
        }
        grp.tmax = tmax;
    }
    __syncthreads();
    return n;
}

// The masked nansum over pitch of cell (t, col .. col + VEC) for every lane
// g < G of the group: acc[g][c].  With read == false (a row no lane of the
// group keeps) nothing is read and every sum is +0.0.
template <int G, int VEC>
__device__ __forceinline__ void cst_accumulate(const float* __restrict__ cube, const uint8_t* __restrict__ s_sel,
                                               bool read, int t, int col, int A, int E, float (&acc)[G][VEC]) {
    using V = typename CstVec<VEC>::T;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
        for (int c = 0; c < VEC; ++c) acc[g][c] = 0.0f;
    if (!read) return;

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

// Store VEC floats at o (16-byte aligned where VEC == 4).
template <int VEC>
__device__ __forceinline__ void cst_store(float* o, const float (&r)[VEC]) {
    if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(o) = make_float4(r[0], r[1], r[2], r[3]);
    } else {
        o[0] = r[0];
    }
}
