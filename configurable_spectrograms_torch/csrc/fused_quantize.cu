// Fused collapse + explicit-bounds colormap quantize, in two launches.
//
// Replaces the Pallas kernel `_fused_quantize_kernel` /
// `fused_quantize_pallas` in configurable_spectrograms_tpu/ops/pallas_kernels.py.
// The TPU kernel ran a two-phase sequential grid and kept the whole
// collapsed (T, E) matrix in VMEM scratch between the phases.  Hopper
// blocks run in no order and a block cannot hold a (T, E) scratch, so:
//
//   1. cst_fused_stats_kernel runs the collapse of collapse_common.cuh:
//      lanes grouped by cube, each cube element read ONCE per group (16-byte
//      loads where E % 4 == 0) and added in pitch-index order to every lane
//      of the group that selects its bin.  It writes each lane's float32
//      (T, E) matrix to a scratch buffer (rows at or past t_valid as NaN,
//      bit-identical to `collapse_lanes_plain`) and, in the same pass, folds
//      the two statistics the quantize needs: per (lane, column) "any
//      non-NaN value inside the file rows", and per lane the minimum of
//      its (T, E) matrix with every cell that is not finite, positive,
//      inside its time window and e_valid replaced by CST_BIG, and whether
//      it has any such cell -- the safe floor of _analyze_matrix, which
//      does not mistake a finite value at or above CST_BIG for "none".  A
//      thread walks a run of rows of one column vector, so all three fold
//      in registers; the block then reduces them (shared memory, warp
//      shuffles) and makes one atomicMin per (block, lane) -- on the
//      float's bits, which order like unsigned ints for non-negative
//      floats -- and one atomicOr per (block, lane) and per (block, lane,
//      column).  Every reduction gives the same result in any order, so
//      the output is deterministic.
//   2. cst_fused_map_kernel reads the lane's minimum, resolves vmin the
//      way ops/spectrogram._analyze_matrix does, and maps each collapsed
//      cell to its uint8 colormap index: 16-byte loads of the scratch and
//      4-byte stores of four indices where E % 4 == 0.
//
// Bound: memory.  The least work is one read of the rows each cube's lanes
// need and one write of the uint8 indices: for a bucket of 8 lanes on one
// 8192 x 64 x 128 cube, 267.2 MB + 8.4 MB, 0.082 ms at 3.35 TB/s.  This
// design moves the cube once per group, the scratch twice (33.6 MB written,
// then read back) and the indices once.  Launch 1 is held to 64 registers
// (4 blocks of 256 an SM) so that enough loads stay in flight; launch 2 is
// bound by its arithmetic (an accurate log10f and an IEEE division a cell)
// more than by the re-read, so whether the scratch is still in L2 hardly
// shows in its time.  log10f is the accurate libdevice function (no fast math),
// and the library is built with -fmad=false, so each product and quotient
// rounds as numpy and XLA round it; a cell can still differ by one bin
// where the float32 log10 of two libraries differs in the last ulp at a bin
// boundary.

#include "collapse_common.cuh"

#define CST_STATS_THREADS 256   // the most threads a stats block has
#define CST_STATS_MIN_BLOCKS 4  // held to 64 registers: 1024 threads an SM keep enough loads in flight
#define CST_STATS_STEPS 2       // block steps (rows a thread) each stats block walks
#define CST_MAP_THREADS 256
#define CST_MAP_ITEMS 4  // vectors a map thread quantizes

// Every thread of the block calls it (it synchronises once).
template <int G, int VEC>
__device__ __forceinline__ void cst_fused_stats_group(const float* __restrict__ cube,
                                                      const uint8_t* __restrict__ s_sel, const CstGroup& grp,
                                                      const int* __restrict__ s_w0, const int* __restrict__ s_w1,
                                                      const uint8_t* __restrict__ e_valid,
                                                      float* __restrict__ collapsed, int* __restrict__ col_any,
                                                      unsigned* __restrict__ lane_min_bits, int* __restrict__ lane_pos,
                                                      unsigned* __restrict__ s_any, unsigned& s_pos,
                                                      float (*__restrict__ s_min)[CST_GROUP], bool active, int cx,
                                                      int col, int t0, int tstep, int T, int A, int E) {
    // Bit g * VEC + c of ev / any: lane g, column col + c.
    unsigned ev = 0;
    unsigned any = 0;
    unsigned pos = 0;  // bit g: lane g has a finite positive cell in its window and e_valid
    float mn[G];
#pragma unroll
    for (int g = 0; g < G; ++g) mn[g] = INFINITY;
    if (active) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
            if (g < grp.n) {
#pragma unroll
                for (int c = 0; c < VEC; ++c)
                    ev |= (e_valid[(size_t)grp.lanes[g] * E + col + c] ? 1u : 0u) << (g * VEC + c);
            }
        }
        for (int t = t0; t < T; t += tstep) {
            float acc[G][VEC];
            cst_accumulate<G, VEC>(cube, s_sel, t < grp.tmax, t, col, A, E, acc);
#pragma unroll
            for (int g = 0; g < G; ++g) {
                if (g < grp.n) {
                    const bool live = t < grp.tv[g];
                    const bool win = live && t >= s_w0[g] && t < s_w1[g];
                    float r[VEC];
#pragma unroll
                    for (int c = 0; c < VEC; ++c) {
                        const float v = acc[g][c];
                        const int b = g * VEC + c;
                        r[c] = live ? v : cst_nan();
                        if (live && !isnan(v)) any |= 1u << b;
                        const bool fp = win && ((ev >> b) & 1u) && isfinite(v) && v > 0.0f;
                        if (fp) pos |= 1u << g;
                        mn[g] = fminf(mn[g], fp ? v : CST_BIG);
                    }
                    cst_store<VEC>(collapsed + ((size_t)grp.lanes[g] * T + t) * E + col, r);
                }
            }
        }
    }

    // Block reduction: col_any per column vector in shared memory, the lane
    // minima by warp shuffles and then across the warps.
    if (any) atomicOr(&s_any[cx], any);
    if (pos) atomicOr(&s_pos, pos);
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int g = 0; g < G; ++g) {
        float m = mn[g];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
        if ((threadIdx.x & 31) == 0) s_min[warp][g] = m;
    }
    __syncthreads();
    if (active && threadIdx.x == cx) {  // the first row of threads: one column vector each
        const unsigned bits = s_any[cx];
#pragma unroll
        for (int g = 0; g < G; ++g) {
            if (g < grp.n) {
#pragma unroll
                for (int c = 0; c < VEC; ++c)
                    if ((bits >> (g * VEC + c)) & 1u) atomicOr(col_any + (size_t)grp.lanes[g] * E + col + c, 1);
            }
        }
    }
    if ((int)threadIdx.x < grp.n) {
        float m = INFINITY;
        for (int w = 0; w < (int)(blockDim.x >> 5); ++w) m = fminf(m, s_min[w][threadIdx.x]);
        if (m < INFINITY) atomicMin(lane_min_bits + grp.lanes[threadIdx.x], __float_as_uint(m));
        if ((s_pos >> threadIdx.x) & 1u) atomicOr(lane_pos + grp.lanes[threadIdx.x], 1);
    }
}

template <int VEC>
__global__ void __launch_bounds__(CST_STATS_THREADS, CST_STATS_MIN_BLOCKS)
    cst_fused_stats_kernel(const float* __restrict__ cubes, const int* __restrict__ u_idx,
                           const uint8_t* __restrict__ masks, const uint8_t* __restrict__ e_valid,
                           const int* __restrict__ t_valid, const int* __restrict__ t_start,
                           const int* __restrict__ t_count, float* __restrict__ collapsed,
                           int* __restrict__ col_any, unsigned* __restrict__ lane_min_bits,
                           int* __restrict__ lane_pos, int L, int T, int A, int E) {
    extern __shared__ uint8_t s_sel[];  // A bytes
    __shared__ CstGroup grp;
    __shared__ int s_w0[CST_GROUP];  // each lane's time window [w0, w1)
    __shared__ int s_w1[CST_GROUP];
    __shared__ unsigned s_any[CST_STATS_THREADS];
    __shared__ unsigned s_pos;
    __shared__ float s_min[CST_STATS_THREADS / 32][CST_GROUP];

    const int n = cst_load_group(u_idx, masks, t_valid, L, A, blockIdx.y, grp, s_sel);
    if (n == 0) return;
    if ((int)threadIdx.x < n) {
        const int l = grp.lanes[threadIdx.x];
        s_w0[threadIdx.x] = t_start[l];
        s_w1[threadIdx.x] = t_start[l] + t_count[l];
    }
    s_any[threadIdx.x] = 0u;
    if (threadIdx.x == 0) s_pos = 0u;
    __syncthreads();

    // A block step covers cw column vectors x rs rows; blockIdx.x is a
    // column tile plus ct times a row block, and the row blocks take the
    // steps in turn (the launch makes gridDim.x a multiple of ct).
    const int n_vec = E / VEC;
    const int cw = min(n_vec, (int)blockDim.x);
    const int rs = blockDim.x / cw;
    const int ct = (n_vec + cw - 1) / cw;
    const int cx = threadIdx.x % cw;
    const int ry = threadIdx.x / cw;
    const int vc = (blockIdx.x % ct) * cw + cx;
    const bool active = ry < rs && vc < n_vec;
    const int col = vc * VEC;
    const int t0 = (blockIdx.x / ct) * rs + ry;
    const int tstep = (gridDim.x / ct) * rs;
    const float* cube = cubes + (size_t)u_idx[blockIdx.y] * T * A * E;
#define CST_STATS_ARGS                                                                                    \
    cube, s_sel, grp, s_w0, s_w1, e_valid, collapsed, col_any, lane_min_bits, lane_pos, s_any, s_pos, s_min, \
        active, cx, col, t0, tstep, T, A, E
    // The widest accumulator set the group needs (a compile-time width each).
    if (n == 1) {
        cst_fused_stats_group<1, VEC>(CST_STATS_ARGS);
    } else if (n == 2) {
        cst_fused_stats_group<2, VEC>(CST_STATS_ARGS);
    } else if (n <= 4) {
        cst_fused_stats_group<4, VEC>(CST_STATS_ARGS);
    } else {
        cst_fused_stats_group<CST_GROUP, VEC>(CST_STATS_ARGS);
    }
#undef CST_STATS_ARGS
}

// One collapsed cell -> its colormap index (the rule of _analyze_matrix and
// matplotlib's Colormap).
__device__ __forceinline__ uint32_t cst_quantize(float x, float vmin, float vmax, float log_vmin, float denom,
                                                 int log_z) {
    float norm;
    if (log_z) {
        const float work = (!isfinite(x) || x <= 0.0f) ? vmin : x;
        norm = __fdiv_rn(__fsub_rn(log10f(fmaxf(work, 1e-37f)), log_vmin), denom);
    } else {
        float work = isnan(x) ? vmin : x;
        if (isinf(work)) work = (work < 0.0f) ? vmin : vmax;
        norm = __fdiv_rn(__fsub_rn(work, vmin), denom);
    }
    // matplotlib's Normalize fills 0 when vmin == vmax; a NaN norm pins to
    // LUT[0]; then Colormap's index rule int(norm * 256) clipped.
    if (vmin == vmax || isnan(norm)) norm = 0.0f;
    return (uint32_t)fminf(fmaxf(floorf(__fmul_rn(norm, 256.0f)), 0.0f), 255.0f);
}

template <int VEC>
__global__ void cst_fused_map_kernel(const float* __restrict__ collapsed, const int* __restrict__ col_any,
                                     const unsigned* __restrict__ lane_min_bits, const int* __restrict__ lane_pos,
                                     const float* __restrict__ z_bounds,
                                     int log_z, uint8_t* __restrict__ idx, float* __restrict__ vmin_out,
                                     uint8_t* __restrict__ col_all_nan, int T, int E) {
    const int l = blockIdx.y;
    // The lane's safe floor: its minimum where it has a finite positive cell, else 1e-10.
    const float safe_vmin = lane_pos[l] ? __uint_as_float(lane_min_bits[l]) : 1e-10f;

    float vmin = z_bounds[2 * l];
    const float vmax = z_bounds[2 * l + 1];
    float log_vmin = 0.0f, denom = 1.0f;
    if (log_z) {
        vmin = fmaxf(fmaxf(vmin, safe_vmin), 1e-10f);
        log_vmin = log10f(vmin);
        const float log_span = __fsub_rn(log10f(vmax), log_vmin);
        denom = (log_span == 0.0f) ? 1.0f : log_span;
    } else {
        const float span = __fsub_rn(vmax, vmin);
        denom = (span == 0.0f) ? 1.0f : span;
    }
    if (blockIdx.x == 0) {
        for (int e = threadIdx.x; e < E; e += blockDim.x)
            col_all_nan[(size_t)l * E + e] = col_any[(size_t)l * E + e] ? 0 : 1;
        if (threadIdx.x == 0) vmin_out[l] = vmin;
    }

    using V = typename CstVec<VEC>::T;
    const V* c = reinterpret_cast<const V*>(collapsed + (size_t)l * T * E);
    uint8_t* out = idx + (size_t)l * T * E;
    const long long n = (long long)T * E / VEC;
    // CST_MAP_ITEMS vectors a thread, a block's width apart: all loads first.
    const long long i0 = (long long)blockIdx.x * blockDim.x * CST_MAP_ITEMS + threadIdx.x;
    V x[CST_MAP_ITEMS];
#pragma unroll
    for (int k = 0; k < CST_MAP_ITEMS; ++k) {
        const long long i = i0 + (long long)k * blockDim.x;
        x[k] = i < n ? __ldcs(c + i) : V{};  // the scratch's last use
    }
#pragma unroll
    for (int k = 0; k < CST_MAP_ITEMS; ++k) {
        const long long i = i0 + (long long)k * blockDim.x;
        if (i >= n) break;
        if constexpr (VEC == 4) {
            const uint32_t q = cst_quantize(x[k].x, vmin, vmax, log_vmin, denom, log_z) |
                               cst_quantize(x[k].y, vmin, vmax, log_vmin, denom, log_z) << 8 |
                               cst_quantize(x[k].z, vmin, vmax, log_vmin, denom, log_z) << 16 |
                               cst_quantize(x[k].w, vmin, vmax, log_vmin, denom, log_z) << 24;
            reinterpret_cast<uint32_t*>(out)[i] = q;
        } else {
            out[i] = (uint8_t)cst_quantize(x[k], vmin, vmax, log_vmin, denom, log_z);
        }
    }
}

template <int VEC>
static cudaError_t cst_launch_stats(const float* cubes, const int* u_idx, const uint8_t* masks,
                                    const uint8_t* e_valid, const int* t_valid, const int* t_start,
                                    const int* t_count, float* collapsed, int* col_any, unsigned* lane_min_bits,
                                    int* lane_pos, int L, int T, int A, int E, cudaStream_t s) {
    const long long n_vec = E / VEC;
    // Small cubes get 64-thread blocks so that a single group still spreads over the SMs.
    const int threads = (long long)T * n_vec >= 132LL * 4 * CST_STATS_THREADS ? CST_STATS_THREADS : 64;
    const int cw = (int)(n_vec < threads ? n_vec : threads);
    const int rs = threads / cw;
    const long long ct = (n_vec + cw - 1) / cw;
    const size_t smem = (size_t)A;
    const long long steps = ((long long)T + rs - 1) / rs;
    const long long row_blocks = (steps + CST_STATS_STEPS - 1) / CST_STATS_STEPS;
    if (ct * row_blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)(ct * row_blocks), (unsigned)L);
    cst_fused_stats_kernel<VEC><<<grid, threads, smem, s>>>(cubes, u_idx, masks, e_valid, t_valid, t_start, t_count,
                                                             collapsed, col_any, lane_min_bits, lane_pos, L, T, A,
                                                             E);
    return cudaGetLastError();
}

template <int VEC>
static cudaError_t cst_launch_map(const float* collapsed, const int* col_any, const unsigned* lane_min_bits,
                                  const int* lane_pos, const float* z_bounds, int log_z, uint8_t* idx,
                                  float* vmin_out,
                                  uint8_t* col_all_nan, int L, int T, int E, cudaStream_t s) {
    const long long n = (long long)T * E / VEC;
    const long long bx = (n + CST_MAP_THREADS * CST_MAP_ITEMS - 1) / (CST_MAP_THREADS * CST_MAP_ITEMS);
    if (bx > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)(bx > 0 ? bx : 1), (unsigned)L);
    cst_fused_map_kernel<VEC><<<grid, CST_MAP_THREADS, 0, s>>>(collapsed, col_any, lane_min_bits, lane_pos,
                                                                z_bounds, log_z, idx, vmin_out, col_all_nan, T, E);
    return cudaGetLastError();
}

// phases: bit 0 = clear the statistics and run launch 1, bit 1 = launch 2
// (3 in production; one at a time only to time them apart).
extern "C" int cst_fused_quantize(const float* cubes, const int* u_idx, const uint8_t* masks,
                                  const uint8_t* e_valid, const int* t_valid, const int* t_start,
                                  const int* t_count, const float* z_bounds, int log_z, float* collapsed,
                                  int* col_any, unsigned* lane_min_bits, int* lane_pos, uint8_t* idx, float* vmin_out,
                                  uint8_t* col_all_nan, int L, int T, int A, int E, int phases, void* stream) {
    if (L <= 0 || T <= 0 || E <= 0) return 0;
    if (L > 65535) return (int)cudaErrorInvalidConfiguration;
    const cudaStream_t s = (cudaStream_t)stream;
    // 16-byte rows need E % 4 == 0 (torch allocations are 256-byte aligned).
    const bool vec4 = E % 4 == 0 && (reinterpret_cast<uintptr_t>(cubes) & 15) == 0 &&
                      (reinterpret_cast<uintptr_t>(collapsed) & 15) == 0 &&
                      (reinterpret_cast<uintptr_t>(idx) & 3) == 0;
    cudaError_t err = cudaSuccess;
    if (phases & 1) {
        // col_any and lane_pos start at 0; the minima at 0xffffffff, above the bits of +inf.
        err = cudaMemsetAsync(col_any, 0, (size_t)L * E * sizeof(int), s);
        if (err == cudaSuccess) err = cudaMemsetAsync(lane_min_bits, 0xff, (size_t)L * sizeof(unsigned), s);
        if (err == cudaSuccess) err = cudaMemsetAsync(lane_pos, 0, (size_t)L * sizeof(int), s);
        if (err != cudaSuccess) return (int)err;
        err = vec4 ? cst_launch_stats<4>(cubes, u_idx, masks, e_valid, t_valid, t_start, t_count, collapsed,
                                         col_any, lane_min_bits, lane_pos, L, T, A, E, s)
                   : cst_launch_stats<1>(cubes, u_idx, masks, e_valid, t_valid, t_start, t_count, collapsed,
                                         col_any, lane_min_bits, lane_pos, L, T, A, E, s);
        if (err != cudaSuccess) return (int)err;
    }
    if (phases & 2) {
        err = vec4 ? cst_launch_map<4>(collapsed, col_any, lane_min_bits, lane_pos, z_bounds, log_z, idx,
                                       vmin_out, col_all_nan, L, T, E, s)
                   : cst_launch_map<1>(collapsed, col_any, lane_min_bits, lane_pos, z_bounds, log_z, idx,
                                       vmin_out, col_all_nan, L, T, E, s);
    }
    return (int)err;
}
