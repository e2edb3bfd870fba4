// Windowed-DFT power kernel: frames (F, L) x bases (L, K) -> power (F, K).
//
// Replaces the Pallas kernel `_stft_power_kernel` / `stft_power_pallas` in
// configurable_spectrograms_tpu/ops/pallas_kernels.py.  On the TPU the
// kernel held a (128, L) frame block and two (L, 128) basis blocks in VMEM
// per grid step, which capped L at 4096; the caller padded F and K to 128.
// Here the frames are read straight from the signal (frame f starts at
// f * frame_stride, unit stride inside a frame: the `unfold` view), L is
// streamed through shared memory in BK-sample stages, so any L runs, and
// the F, K and L tails are masked in the kernel.
//
// Design: one 256-thread block per 64 frames x 64 bins; each thread holds a
// 4 x 4 `re` and a 4 x 4 `im` accumulator (frames ty + 16 i, bins
// tx + 16 j).  Per stage the block stages a 16 x 64 frame tile (transposed,
// padded against bank conflicts) and the two 16 x 64 basis tiles; the two
// products share the frame values.  Epilogue re^2 + im^2 rounded as the
// plain version rounds it.
//
// Bound: fp32 SIMT compute.  Each output costs about 2 L FMAs for re and
// 2 L for im -- 217 GFLOP at F = 103,356, L = 1024, K = 513 -- against
// the H100's 67 TFLOP/s non-tensor fp32; per stage a thread issues 12
// shared loads for 32 FMAs, so shared-memory issue, not HBM, limits it.
// Accumulation is explicit `__fmaf_rn` (the library builds with
// -fmad=false, which would otherwise split a*b+c into FMUL + FADD).  No
// TF32.  A later PR would move the products to the tensor cores with an
// error-compensated split (3xTF32 or bf16x3: x = hi + lo, three products)
// to keep fp32 accuracy at several times the rate.

#include <cuda_runtime.h>

#define CST_STFT_BM 64   // frames per block
#define CST_STFT_BN 64   // bins per block
#define CST_STFT_BK 16   // samples per shared-memory stage
#define CST_STFT_THREADS 256

__global__ void __launch_bounds__(CST_STFT_THREADS)
cst_stft_power_kernel(const float* __restrict__ signal, int frame_stride, int F, int L,
                      const float* __restrict__ cos_b, const float* __restrict__ sin_b, int K,
                      float* __restrict__ out) {
    __shared__ float fs[CST_STFT_BK][CST_STFT_BM + 1];
    __shared__ float cs[CST_STFT_BK][CST_STFT_BN];
    __shared__ float ss[CST_STFT_BK][CST_STFT_BN];

    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;
    const int f0 = blockIdx.x * CST_STFT_BM;
    const int k0 = blockIdx.y * CST_STFT_BN;

    float re[4][4], im[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            re[i][j] = 0.0f;
            im[i][j] = 0.0f;
        }
    }

    for (int l0 = 0; l0 < L; l0 += CST_STFT_BK) {
        // Frame tile: 16 consecutive samples of a frame per half-warp.
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = tid / CST_STFT_BK + 16 * i;
            const int c = tid % CST_STFT_BK;
            const int f = f0 + r;
            const int l = l0 + c;
            fs[c][r] = (f < F && l < L) ? signal[(size_t)f * frame_stride + l] : 0.0f;
        }
        // Basis tiles: 64 consecutive bins of one sample row per pair of warps.
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int kk = tid / CST_STFT_BN + 4 * i;
            const int c = tid % CST_STFT_BN;
            const int l = l0 + kk;
            const int k = k0 + c;
            const bool ok = l < L && k < K;
            const size_t off = (size_t)l * K + k;
            cs[kk][c] = ok ? cos_b[off] : 0.0f;
            ss[kk][c] = ok ? sin_b[off] : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < CST_STFT_BK; ++kk) {
            float a[4], bc[4], bs[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = fs[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                bc[j] = cs[kk][tx + 16 * j];
                bs[j] = ss[kk][tx + 16 * j];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    re[i][j] = __fmaf_rn(a[i], bc[j], re[i][j]);
                    im[i][j] = __fmaf_rn(a[i], bs[j], im[i][j]);
                }
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int f = f0 + ty + 16 * i;
        if (f >= F) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int k = k0 + tx + 16 * j;
            if (k < K) {
                out[(size_t)f * K + k] =
                    __fadd_rn(__fmul_rn(re[i][j], re[i][j]), __fmul_rn(im[i][j], im[i][j]));
            }
        }
    }
}

extern "C" int cst_stft_power(const float* signal, int frame_stride, int F, int L,
                              const float* cos_b, const float* sin_b, int K, float* out,
                              void* stream) {
    const dim3 grid((F + CST_STFT_BM - 1) / CST_STFT_BM, (K + CST_STFT_BN - 1) / CST_STFT_BN);
    cst_stft_power_kernel<<<grid, CST_STFT_THREADS, 0, (cudaStream_t)stream>>>(
        signal, frame_stride, F, L, cos_b, sin_b, K, out);
    return (int)cudaGetLastError();
}
