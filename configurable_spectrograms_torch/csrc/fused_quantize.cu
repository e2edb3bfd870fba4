// Fused collapse + explicit-bounds colormap quantize, in two launches.
//
// Replaces the Pallas kernel `_fused_quantize_kernel` /
// `fused_quantize_pallas` in configurable_spectrograms_tpu/ops/pallas_kernels.py.
// The TPU kernel ran a two-phase sequential grid and kept the whole
// collapsed (T, E) matrix in VMEM scratch between the phases.  Hopper
// blocks run in no order and a block cannot hold a (T, E) scratch, so:
//
//   1. cst_fused_stats_kernel collapses each (lane, 64-row, 32-column)
//      tile, writes the float32 matrix to a scratch buffer, and folds two
//      per-column statistics into (L, E) slots with atomics: "any non-NaN
//      value inside the file rows" (atomicOr) and "min finite positive
//      value inside the time window and e_valid" (atomicMin on the float's
//      bits, which order like ints for positive floats).  Both reductions
//      give the same result in any order, so the output is deterministic.
//   2. cst_fused_quantize_kernel reduces the lane's column minima to the
//      safe floor, resolves vmin the way ops/spectrogram._analyze_matrix
//      does, and maps each collapsed cell to its uint8 colormap index.
//
// Bound: memory.  Launch 1 reads the selected pitch slices of the cube
// (up to T*A*E*4 bytes) and writes T*E*4; launch 2 reads those T*E*4
// bytes back (1/A of the cube) and writes T*E bytes.  At 3.35 TB/s an
// 8192 x 64 x 128 lane needs ~85 us in all.  log10f is the accurate
// libdevice function (no fast math), and the library is built with
// -fmad=false, so each product and quotient rounds as numpy and XLA
// round it; a cell can still differ by one bin where the float32 log10
// of two libraries differs in the last ulp at a bin boundary.

#include "collapse_common.cuh"

__global__ void cst_fused_stats_kernel(const float* __restrict__ cubes,
                                       const int* __restrict__ u_idx,
                                       const uint8_t* __restrict__ masks,
                                       const uint8_t* __restrict__ e_valid,
                                       const int* __restrict__ t_valid,
                                       const int* __restrict__ t_start,
                                       const int* __restrict__ t_count,
                                       float* __restrict__ collapsed,
                                       int* __restrict__ col_any,
                                       int* __restrict__ col_min_bits,
                                       int T, int A, int E) {
    __shared__ int s_any[CST_ROW_THREADS][CST_COLS_PER_BLOCK];
    __shared__ float s_min[CST_ROW_THREADS][CST_COLS_PER_BLOCK];
    const int l = blockIdx.z;
    const int e = blockIdx.x * CST_COLS_PER_BLOCK + threadIdx.x;
    const bool col_ok = e < E;
    const float* cube = cubes + (size_t)u_idx[l] * T * A * E;
    const uint8_t* mask = masks + (size_t)l * A;
    const int tv = t_valid[l];
    const int w0 = t_start[l];
    const int w1 = t_start[l] + t_count[l];
    const bool ev = col_ok && e_valid[(size_t)l * E + e];
    float* o = collapsed + (size_t)l * T * E;
    int any = 0;
    float mn = CST_BIG;
    const int t0 = blockIdx.y * CST_ROWS_PER_BLOCK;
    if (col_ok) {
        for (int k = threadIdx.y; k < CST_ROWS_PER_BLOCK; k += CST_ROW_THREADS) {
            const int t = t0 + k;
            if (t >= T) break;
            const bool in_file = t < tv;
            const float v = in_file ? cst_collapse_cell(cube, mask, t, e, A, E) : cst_nan();
            o[(size_t)t * E + e] = v;
            if (in_file && !isnan(v)) any = 1;
            if (ev && in_file && t >= w0 && t < w1 && isfinite(v) && v > 0.0f) mn = fminf(mn, v);
        }
    }
    s_any[threadIdx.y][threadIdx.x] = any;
    s_min[threadIdx.y][threadIdx.x] = mn;
    __syncthreads();
    if (threadIdx.y == 0 && col_ok) {
        for (int y = 1; y < CST_ROW_THREADS; ++y) {
            any |= s_any[y][threadIdx.x];
            mn = fminf(mn, s_min[y][threadIdx.x]);
        }
        const size_t slot = (size_t)l * E + e;
        if (any) atomicOr(col_any + slot, 1);
        if (mn < CST_BIG) atomicMin(col_min_bits + slot, __float_as_int(mn));
    }
}

__global__ void cst_fused_quantize_kernel(const float* __restrict__ collapsed,
                                          const int* __restrict__ col_any,
                                          const int* __restrict__ col_min_bits,
                                          const float* __restrict__ z_bounds,
                                          int log_z,
                                          uint8_t* __restrict__ idx,
                                          float* __restrict__ vmin_out,
                                          uint8_t* __restrict__ col_all_nan,
                                          int T, int E) {
    __shared__ int s_red[CST_ROW_THREADS * CST_COLS_PER_BLOCK];
    const int l = blockIdx.z;
    const int tid = threadIdx.y * CST_COLS_PER_BLOCK + threadIdx.x;
    const int nthreads = CST_ROW_THREADS * CST_COLS_PER_BLOCK;

    // Lane-wide safe floor: the min over the lane's column minima.  Every
    // block recomputes it from E ints (cheap next to its tile).
    int m = __float_as_int(CST_BIG);
    for (int j = tid; j < E; j += nthreads) m = min(m, col_min_bits[(size_t)l * E + j]);
    s_red[tid] = m;
    __syncthreads();
    for (int s = nthreads / 2; s > 0; s >>= 1) {
        if (tid < s) s_red[tid] = min(s_red[tid], s_red[tid + s]);
        __syncthreads();
    }
    const float minpos = __int_as_float(s_red[0]);
    const float safe_vmin = (minpos < CST_BIG) ? minpos : 1e-10f;

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

    const int e = blockIdx.x * CST_COLS_PER_BLOCK + threadIdx.x;
    if (e >= E) return;
    if (blockIdx.y == 0 && threadIdx.y == 0) {
        col_all_nan[(size_t)l * E + e] = col_any[(size_t)l * E + e] ? 0 : 1;
        if (e == 0) vmin_out[l] = vmin;
    }
    const float* c = collapsed + (size_t)l * T * E;
    uint8_t* out = idx + (size_t)l * T * E;
    const int t0 = blockIdx.y * CST_ROWS_PER_BLOCK;
    for (int k = threadIdx.y; k < CST_ROWS_PER_BLOCK; k += CST_ROW_THREADS) {
        const int t = t0 + k;
        if (t >= T) break;
        const float x = c[(size_t)t * E + e];
        float norm;
        if (log_z) {
            const float work = (!isfinite(x) || x <= 0.0f) ? vmin : x;
            norm = __fdiv_rn(__fsub_rn(log10f(fmaxf(work, 1e-37f)), log_vmin), denom);
        } else {
            float work = isnan(x) ? vmin : x;
            if (isinf(work)) work = (work < 0.0f) ? vmin : vmax;
            norm = __fdiv_rn(__fsub_rn(work, vmin), denom);
        }
        // matplotlib's Normalize fills 0 when vmin == vmax; a NaN norm pins
        // to LUT[0]; then Colormap's index rule int(norm * 256) clipped.
        if (vmin == vmax || isnan(norm)) norm = 0.0f;
        const float f = fminf(fmaxf(floorf(__fmul_rn(norm, 256.0f)), 0.0f), 255.0f);
        out[(size_t)t * E + e] = (uint8_t)f;
    }
}

extern "C" int cst_fused_quantize(const float* cubes, const int* u_idx, const uint8_t* masks,
                                  const uint8_t* e_valid, const int* t_valid, const int* t_start,
                                  const int* t_count, const float* z_bounds, int log_z,
                                  float* collapsed, int* col_any, int* col_min_bits,
                                  uint8_t* idx, float* vmin_out, uint8_t* col_all_nan,
                                  int L, int T, int A, int E, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const dim3 block(CST_COLS_PER_BLOCK, CST_ROW_THREADS);
    const dim3 grid((E + CST_COLS_PER_BLOCK - 1) / CST_COLS_PER_BLOCK,
                    (T + CST_ROWS_PER_BLOCK - 1) / CST_ROWS_PER_BLOCK, L);
    cst_fused_stats_kernel<<<grid, block, 0, s>>>(cubes, u_idx, masks, e_valid, t_valid, t_start,
                                                  t_count, collapsed, col_any, col_min_bits, T, A,
                                                  E);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cst_fused_quantize_kernel<<<grid, block, 0, s>>>(collapsed, col_any, col_min_bits, z_bounds,
                                                     log_z, idx, vmin_out, col_all_nan, T, E);
    return (int)cudaGetLastError();
}
