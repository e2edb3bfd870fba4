// Windowed-DFT power kernel: frames (F, L) x bases (L, K) -> power (F, K),
// with the products on the tensor cores in 3xTF32.
//
// Replaces the Pallas kernel `_stft_power_kernel` / `stft_power_pallas` in
// configurable_spectrograms_tpu/ops/pallas_kernels.py.  On the TPU the
// kernel held a (128, L) frame block and two (L, 128) basis blocks in VMEM
// per grid step, which capped L at 4096; the caller padded F and K to 128.
// Here the frames are read straight from the signal (frame f starts at
// f * frame_stride, unit stride inside a frame: the `unfold` view), L is
// streamed through shared memory, so any L runs, and the F and L tails are
// zero-filled by the copies.
//
// Bound: 4 F K L FLOP for the two products; 3xTF32 triples it: 651.5 GFLOP
// at F = 103,356, L = 1024, K = 513, which at the H100's 495 TFLOP/s dense
// TF32 rate is 1.32 ms (HBM: 322 MB moved, 0.10 ms).  Plain fp32 SIMT
// (67 TFLOP/s) cannot go below 3.24 ms, so the products must run on the
// tensor cores, and TF32 alone keeps only 11 significant bits.
//
// Split: every operand x = hi + lo with hi = tf32(x), lo = tf32(x - hi);
// each product is lo*hi + hi*lo + hi*hi (lo*lo dropped, about 2^-22 of it),
// small terms first, by `mma.sync.m16n8k8.tf32`.  The tensor cores
// truncate as they add in fp32, an error that grows with L (measured on the
// H100: 3.4x the tolerance at L = 8192 with one running sum), so each
// k8 step's three products start from zero and join the running fp32 sum
// with a rounded `__fadd_rn`.  The bases come pre-split and transposed
// from the wrapper as scratch bt[4][Kp][Lp] = (cos hi, cos lo, sin hi,
// sin lo), bins x samples with L contiguous (the tensor cores take TF32 B
// only K-major), zero-padded to Kp = 16 * ceil(K / 16) and
// Lp = 16 * ceil(L / 16).  The frames are split in registers as they leave
// shared memory (`cvt.rna.tf32.f32`, `__fsub_rn`).
//
// Design: 128 threads, 4 warps; a block computes 128 frames x 64 bins
// (warp tile 64 x 32, re and im: 128 fp32 accumulators a thread).  The
// last bins (K = L/2 + 1 leaves one bin past a multiple of 64) go to
// narrow blocks of 16 bins (warp tile 64 x 8) in the same launch, not to a
// 63/64-empty full tile.  L is streamed in 16-sample stages through a
// 4-deep ring of shared-memory buffers filled by `cp.async` (loads of
// stages s+1..s+3 in flight while the products of stage s run): 16-byte
// copies where the frames' row stride and base allow it (hop % 4 == 0),
// 4-byte copies otherwise -- the same kernel, templated on the copy width.
// Operands reach registers by `ldmatrix` from rows swizzled against bank
// conflicts.  Blocks are ordered bins-fastest, so the blocks that share a
// frame tile run together and the frames come from HBM about once.
//
// Why mma.sync and not wgmma: `wgmma` (m64nNk8.tf32) is the route to the
// full TF32 rate.  A wgmma version was brought up beside this one and
// agreed with the plain version -- A split in registers (the fragment
// layout of mma.m16n8k8), B = cos and sin bins as one n = 128 operand in
// the no-swizzle core-matrix layout (8 rows x 16 B; leading offset 128 B
// along K, stride offset 512 B along N) -- but it ran slower than this
// kernel on the H100: the promotion must wait for each stage's wgmma, which
// under a block-wide __syncthreads idles the tensor cores, and keeping one
// group in flight made ptxas serialize the wgmma (warning C7514).  The
// design that would pay is warp-specialised (a producer warp, consumer
// warpgroups promoting in turn); that is later work.
//
// Result: not bit-identical to the plain version (the tensor cores sum in
// another order); chip_smoke.py holds it to the plain version's tolerance
// and its float64 error to within 4x the plain version's.  Built with
// -fmad=false: the split and the epilogue are written with explicit
// __fsub_rn / __fmul_rn / __fadd_rn.

#include <cstdint>

#include <cuda_runtime.h>

#define CST_STFT_WARPS_M 2     // warps along frames, 64 frames each
#define CST_STFT_WARPS_N 2     // warps along bins
#define CST_STFT_MIN_BLOCKS 2  // resident blocks an SM (caps registers at 255)
#define CST_STFT_NT 4          // n8 tiles a warp in a full block
#define CST_STFT_THREADS (32 * CST_STFT_WARPS_M * CST_STFT_WARPS_N)
#define CST_STFT_BM (64 * CST_STFT_WARPS_M)                        // frames per block
#define CST_STFT_BN (CST_STFT_WARPS_N * CST_STFT_NT * 8)           // bins per full block
#define CST_STFT_BN_TAIL (CST_STFT_WARPS_N * 8)                    // bins per tail block
#define CST_STFT_BK 16         // samples per stage
#define CST_STFT_STAGES 4

// Floats of one stage: the frame tile, then 4 basis tiles of CST_STFT_BN rows.
#define CST_STFT_A_FLOATS (CST_STFT_BM * CST_STFT_BK)
#define CST_STFT_B_FLOATS (CST_STFT_BN * CST_STFT_BK)
#define CST_STFT_STAGE_FLOATS (CST_STFT_A_FLOATS + 4 * CST_STFT_B_FLOATS)
#define CST_STFT_SMEM_BYTES (CST_STFT_STAGES * CST_STFT_STAGE_FLOATS * 4)

// A tile row holds 16 floats = four 16-byte chunks; chunk c of row r is
// stored at chunk c ^ ((r >> 1) & 3), so the 8 rows an ldmatrix reads hit
// 8 distinct 16-byte bank groups.
__device__ __forceinline__ int cst_swz(int r, int l) {
    return r * CST_STFT_BK + ((((l >> 2) ^ (r >> 1)) & 3) << 2) + (l & 3);
}

__device__ __forceinline__ uint32_t cst_smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cst_cp_async16(float* dst, const float* src, bool ok) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(cst_smem_addr(dst)), "l"(src),
                 "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cst_cp_async4(float* dst, const float* src, bool ok) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(cst_smem_addr(dst)), "l"(src),
                 "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cst_ldmatrix_x4(uint32_t (&r)[4], const float* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(cst_smem_addr(p)));
}

__device__ __forceinline__ uint32_t cst_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
}

// d += a * b on the tensor cores, m16n8k8, TF32 in, fp32 accumulate.  Not
// volatile: it touches registers only, so the compiler may interleave chains.
__device__ __forceinline__ void cst_mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Issue the copies of one stage: the frame tile (rows f0.., samples l0..)
// and the rows k0..k0+BN-1 of the four basis matrices.
template <bool kVec16, int BN>
__device__ __forceinline__ void cst_stft_load_stage(float* st, const float* __restrict__ signal,
                                                    long long frame_stride, int F, int L, int f0, int l0,
                                                    const float* __restrict__ bt, int Kp, int Lp, int k0) {
    const int tid = threadIdx.x;
    float* as = st;
    float* bs = st + CST_STFT_A_FLOATS;
    if (kVec16) {
        // 128 rows x 4 chunks: 4 chunks a thread.
#pragma unroll
        for (int i = 0; i < (CST_STFT_BM * 4) / CST_STFT_THREADS; ++i) {
            const int c = tid + i * CST_STFT_THREADS;
            const int r = c >> 2;
            const int l = (c & 3) << 2;
            const int f = f0 + r;
            const bool ok = f < F && l0 + l < L;  // L % 4 == 0: a chunk is all in or all out
            const float* src = ok ? signal + (long long)f * frame_stride + l0 + l : signal;
            cst_cp_async16(as + cst_swz(r, l), src, ok);
        }
    } else {
        // 128 rows x 16 samples: 16 floats a thread, a half-warp on one row.
#pragma unroll
        for (int i = 0; i < CST_STFT_A_FLOATS / CST_STFT_THREADS; ++i) {
            const int e = tid + i * CST_STFT_THREADS;
            const int r = e >> 4;
            const int l = e & 15;
            const int f = f0 + r;
            const bool ok = f < F && l0 + l < L;
            const float* src = ok ? signal + (long long)f * frame_stride + l0 + l : signal;
            cst_cp_async4(as + cst_swz(r, l), src, ok);
        }
    }
    // Bases: 4 matrices x BN rows x 4 chunks, padded, so never out of range.
    constexpr int kChunks = 4 * BN * 4;
#pragma unroll
    for (int i = 0; i < (kChunks + CST_STFT_THREADS - 1) / CST_STFT_THREADS; ++i) {
        const int c = tid + i * CST_STFT_THREADS;
        if (kChunks % CST_STFT_THREADS == 0 || c < kChunks) {
            const int m = c / (BN * 4);
            const int r = (c >> 2) % BN;
            const int l = (c & 3) << 2;
            const float* src = bt + ((long long)m * Kp + k0 + r) * Lp + l0 + l;
            cst_cp_async16(bs + m * CST_STFT_B_FLOATS + cst_swz(r, l), src, true);
        }
    }
}

// One block: frames f0..f0+BM-1 x bins k0..k0+BN-1.  Warp w takes frame
// rows (w % WARPS_M) * 64.. and bins (w / WARPS_M) * NT * 8..; NT n8 tiles a warp.
template <bool kVec16, int NT>
__device__ __forceinline__ void cst_stft_block(float* smem, const float* __restrict__ signal,
                                               long long frame_stride, int F, int L, int f0,
                                               const float* __restrict__ bt, int K, int Kp, int Lp, int k0,
                                               float* __restrict__ out) {
    constexpr int BN = CST_STFT_WARPS_N * NT * 8;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int wm = (warp % CST_STFT_WARPS_M) * 64;
    const int wn = (warp / CST_STFT_WARPS_M) * NT * 8;
    const int n_stages = Lp / CST_STFT_BK;

    float re[4][NT][4], im[4][NT][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < NT; ++nj)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                re[mi][nj][c] = 0.0f;
                im[mi][nj][c] = 0.0f;
            }

#pragma unroll
    for (int s = 0; s < CST_STFT_STAGES - 1; ++s) {
        if (s < n_stages)
            cst_stft_load_stage<kVec16, BN>(smem + s * CST_STFT_STAGE_FLOATS, signal, frame_stride, F, L, f0,
                                            s * CST_STFT_BK, bt, Kp, Lp, k0);
        asm volatile("cp.async.commit_group;\n" ::);
    }

    // ldmatrix row addresses: lane i names row (i & 7) of matrix (i >> 3).
    const int mat = lane >> 3;
    const int mrow = lane & 7;

    for (int s = 0; s < n_stages; ++s) {
        asm volatile("cp.async.wait_group %0;\n" ::"n"(CST_STFT_STAGES - 2));
        __syncthreads();  // stage s landed for every thread; stage s-1's slot is free
        const int next = s + CST_STFT_STAGES - 1;
        if (next < n_stages)
            cst_stft_load_stage<kVec16, BN>(smem + (next % CST_STFT_STAGES) * CST_STFT_STAGE_FLOATS, signal,
                                            frame_stride, F, L, f0, next * CST_STFT_BK, bt, Kp, Lp, k0);
        asm volatile("cp.async.commit_group;\n" ::);

        const float* as = smem + (s % CST_STFT_STAGES) * CST_STFT_STAGE_FLOATS;
        const float* bs = as + CST_STFT_A_FLOATS;
#pragma unroll
        for (int ks = 0; ks < CST_STFT_BK / 8; ++ks) {
            // A fragments (m16 x k8): matrices (rows 0-7, k 0-3), (rows 8-15, k 0-3),
            // (rows 0-7, k 4-7), (rows 8-15, k 4-7) = a0..a3 of mma.m16n8k8.
            uint32_t ahi[4][4], alo[4][4];
#pragma unroll
            for (int mi = 0; mi < 4; ++mi) {
                const int r = wm + mi * 16 + mrow + (mat & 1) * 8;
                const int l = ks * 8 + (mat >> 1) * 4;
                uint32_t raw[4];
                cst_ldmatrix_x4(raw, as + cst_swz(r, l));
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const float x = __uint_as_float(raw[c]);
                    ahi[mi][c] = cst_tf32(x);
                    alo[mi][c] = cst_tf32(__fsub_rn(x, __uint_as_float(ahi[mi][c])));
                }
            }
#pragma unroll
            for (int nj = 0; nj < NT; ++nj) {
                // B fragments (k8 x n8) from bins-major rows: b0 = k 0-3, b1 = k 4-7;
                // one ldmatrix gives (hi b0, hi b1, lo b0, lo b1) of cos, one of sin.
                const int r = wn + nj * 8 + mrow;
                const int l = ks * 8 + (mat & 1) * 4;
                const int hl = mat >> 1;
                uint32_t bc[4], bsn[4];
                cst_ldmatrix_x4(bc, bs + (0 + hl) * CST_STFT_B_FLOATS + cst_swz(r, l));
                cst_ldmatrix_x4(bsn, bs + (2 + hl) * CST_STFT_B_FLOATS + cst_swz(r, l));
#pragma unroll
                for (int mi = 0; mi < 4; ++mi) {
                    // The tensor cores truncate as they accumulate; the three products of
                    // this k8 step go to a fresh sum, promoted with a rounded fp32 add.
                    float pr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                    float pi[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                    cst_mma_tf32(pr, alo[mi], bc[0], bc[1]);
                    cst_mma_tf32(pr, ahi[mi], bc[2], bc[3]);
                    cst_mma_tf32(pr, ahi[mi], bc[0], bc[1]);
                    cst_mma_tf32(pi, alo[mi], bsn[0], bsn[1]);
                    cst_mma_tf32(pi, ahi[mi], bsn[2], bsn[3]);
                    cst_mma_tf32(pi, ahi[mi], bsn[0], bsn[1]);
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        re[mi][nj][c] = __fadd_rn(re[mi][nj][c], pr[c]);
                        im[mi][nj][c] = __fadd_rn(im[mi][nj][c], pi[c]);
                    }
                }
            }
        }
    }
    asm volatile("cp.async.wait_group 0;\n" ::);

    // Accumulator layout of m16n8: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1).
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int f = f0 + wm + mi * 16 + g + half * 8;
            if (f >= F) continue;
            float* row = out + (long long)f * K;
#pragma unroll
            for (int nj = 0; nj < NT; ++nj) {
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    const int k = k0 + wn + nj * 8 + 2 * t + c;
                    const float vr = re[mi][nj][2 * half + c];
                    const float vi = im[mi][nj][2 * half + c];
                    if (k < K) row[k] = __fadd_rn(__fmul_rn(vr, vr), __fmul_rn(vi, vi));
                }
            }
        }
    }
}

// Block b: bin tile b % n_bin_tiles (bins fastest), frame tile b / n_bin_tiles.
// Bin tiles below n_full are 64 wide; the rest are 16-wide tail tiles.
template <bool kVec16>
__global__ void __launch_bounds__(CST_STFT_THREADS, CST_STFT_MIN_BLOCKS)
cst_stft_power_kernel(const float* __restrict__ signal, long long frame_stride, int F, int L,
                      const float* __restrict__ bt, int K, int Kp, int Lp, int n_full, int n_bin_tiles,
                      float* __restrict__ out) {
    extern __shared__ __align__(128) float smem[];
    const int tile = blockIdx.x % n_bin_tiles;
    const int f0 = (blockIdx.x / n_bin_tiles) * CST_STFT_BM;
    if (tile < n_full) {
        cst_stft_block<kVec16, CST_STFT_NT>(smem, signal, frame_stride, F, L, f0, bt, K, Kp, Lp, tile * CST_STFT_BN, out);
    } else {
        const int k0 = n_full * CST_STFT_BN + (tile - n_full) * CST_STFT_BN_TAIL;
        cst_stft_block<kVec16, 1>(smem, signal, frame_stride, F, L, f0, bt, K, Kp, Lp, k0, out);
    }
}

// bt: the wrapper's pre-split, transposed, padded bases (see the header).
extern "C" int cst_stft_power(const float* signal, int frame_stride, int F, int L, const float* bt, int K,
                              int Kp, int Lp, float* out, void* stream) {
    if (F <= 0 || K <= 0) return 0;
    if (Kp % CST_STFT_BN_TAIL != 0 || Lp % CST_STFT_BK != 0 || Kp < K || Lp < L) return (int)cudaErrorInvalidValue;
    const int n_full = K / CST_STFT_BN;
    const int n_tail = (K - n_full * CST_STFT_BN + CST_STFT_BN_TAIL - 1) / CST_STFT_BN_TAIL;
    const int n_bin_tiles = n_full + n_tail;
    const long long blocks = (long long)((F + CST_STFT_BM - 1) / CST_STFT_BM) * n_bin_tiles;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    const bool vec16 = frame_stride % 4 == 0 && L % 4 == 0 && (reinterpret_cast<uintptr_t>(signal) & 15) == 0;
    cudaError_t err;
    if (vec16) {
        err = cudaFuncSetAttribute(cst_stft_power_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   CST_STFT_SMEM_BYTES);
        if (err != cudaSuccess) return (int)err;
        cst_stft_power_kernel<true><<<(unsigned)blocks, CST_STFT_THREADS, CST_STFT_SMEM_BYTES, (cudaStream_t)stream>>>(
            signal, frame_stride, F, L, bt, K, Kp, Lp, n_full, n_bin_tiles, out);
    } else {
        err = cudaFuncSetAttribute(cst_stft_power_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   CST_STFT_SMEM_BYTES);
        if (err != cudaSuccess) return (int)err;
        cst_stft_power_kernel<false><<<(unsigned)blocks, CST_STFT_THREADS, CST_STFT_SMEM_BYTES, (cudaStream_t)stream>>>(
            signal, frame_stride, F, L, bt, K, Kp, Lp, n_full, n_bin_tiles, out);
    }
    return (int)cudaGetLastError();
}
