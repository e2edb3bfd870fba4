// Percentile bounds, normalisation and colormap index of collapsed matrices: the tail of the
// render dispatch's collapse route, in one launch.
//
// Replaces no TPU kernel.  On the TPU this tail was XLA's fusion of
// configurable_spectrograms_tpu/ops/spectrogram._analyze_matrix; the port ran
// ops/spectrogram._analyze_matrix as ~400 eager torch calls a bucket (32
// compare-and-count passes of select_order_stats over int64 keys, a stable
// argsort, the masks, the normalisation), each a launch the host enqueues.
// That function stays the plain version (the CPU path, and what the tests
// hold this kernel to).
//
// Input: the collapse kernel's (L, T, E) float32 matrices (rows at or past
// t_valid NaN) and the bucket's lane arrays.  Per lane it computes what
// _analyze_matrix computes:
//   * col_all_nan (no non-NaN cell in the file rows), e_keep, the window
//     and bounds masks, n_ok;
//   * the 4 order statistics of the low and high percentile over the
//     bounds pool (zb rows x zb_e_valid, NaN left out) by an exact radix
//     select over the IEEE total-order keys of _sortable_u32: digits of
//     11, 11 and 10 bits, MSB first, histograms in shared memory, no sort
//     and no (L, N, R) intermediate; numpy's lerp branch for branch, the
//     product rounded before the add (__fmul_rn, __fadd_rn);
//   * the safe floor (the minimum finite positive cell of the window, or
//     1e-10), the log or linear normalisation with the linear route's
//     fallback to the matrix's own range on degenerate bounds and
//     matplotlib's vmin == vmax rule, and the colormap index int(norm *
//     256) clipped to [0, 255] into uint8;
//   * kept_pos / n_kept / flip / y0 / y1 as the stable argsort gives them:
//     the kept columns in order, then the rest in order, from a block-wide
//     prefix scan of the column flags.
//
// Bound: memory, and barely: the least work is one read of the matrix and
// one write of the uint8 indices (5 bytes a cell).  This design reads the
// matrix three times (statistics with the first digit over the file rows,
// the second digit over the bounds pool's rows, the quantize), four where a
// block's keys of the second digit's buckets overflow the shared memory
// that carries them to the third; the re-reads come from L2 (a lane is
// 2.1 MB at the audio shape, 0.4 MB at the FAST one).  On the card the
// time goes to the few SMs a lane has and the passes between barriers, not
// to the bytes.
//
// Layout: one thread block cluster per lane (grid (C, L), cluster (C, 1,
// 1)), C from 1 to 16 by the bucket's cells and lanes: many small lanes get
// small clusters, one large lane a cluster of 16 SMs (8, the portable size,
// where the card cannot schedule 16).  Each pass cuts its rows into C runs;
// a thread owns a column (cw columns x rs row strides a block) and walks
// its run's rows, PQ_UNROLL loads ahead, so the column flags fold in
// registers.
// The cluster's blocks fold their statistics and histograms into block 0's
// shared memory (distributed shared memory atomics); block 0 picks each
// target's digit, resolves the lane's scalars and writes kept_pos; the
// others read the result from block 0 after a cluster barrier.  Every
// reduction is exact and order-free (integer counts, min/max), so the
// output does not depend on the schedule.
//
// Exactness: the order statistics are the exact keys select_order_stats
// finds; every float operation of the bounds and of a cell's index is the
// one eager torch makes, rounded alone (the library builds with
// -fmad=false; log10f is libdevice's accurate one, as torch's).  Collapsed
// sums are never -0.0 (collapse_common.cuh), so the min/max folds need no
// rule for signed zeros.
//
// Output per lane l (words, int32, row stride 2E + PQ_SCALARS): kept_pos in
// [0, E), the column flags (scratch) in [E, 2E), then y0, y1, vmin, vmax
// (float bits), n_kept, n_ok, and the four order statistics (float bits;
// NaN where the pool is empty or the select is off).  flags (uint8, L x 2):
// flip, empty.

#include <cooperative_groups.h>

#include <cstddef>
#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define PQ_TARGETS 4        // lo, hi of the low percentile; lo, hi of the high one
#define PQ_BINS 2048        // the widest digit: 11 bits
#define PQ_SCALARS 12       // per-lane scalars after kept_pos and the column flags
#define PQ_PORTABLE_CLUSTER 8  // the portable cluster size
#define PQ_MAX_CLUSTER 16       // Hopper's largest (non-portable) cluster
#define PQ_CAND 3072            // keys of the second digit's buckets a block keeps for the third
#define PQ_CELLS_A_BLOCK 4096
#define PQ_UNROLL 8         // rows a thread loads before it uses them
#define PQ_BIG 3.0e38f      // the fill of _analyze_matrix's minima
#define PQ_FLOOR 1e-10f     // the log scale's floor
#define PQ_KEY_NONE 0xFFFFFFFFu

// The statistics bits.
#define PQ_HAS_FP 1u    // a finite positive cell in the window and e_valid
#define PQ_NINF_SEL 2u  // a -inf cell in the window and e_valid
#define PQ_PINF_SEL 4u  // a +inf cell in the window and e_valid
// Column flag bits.
#define PQ_COL_ANY 1u   // a non-NaN cell in the file rows
#define PQ_COL_NANW 2u  // a NaN cell in the window rows

struct PqArgs {
    const float* m;
    const float* energy;
    const uint8_t* e_valid;
    const uint8_t* zb_e_valid;
    const int* t_valid;
    const int* t_start;
    const int* t_count;
    const float* z_bounds;
    const uint8_t* zb_full;  // may be null: every lane takes its window rows
    float q_lo, q_hi;        // percentile / 100, rounded once in float32 on the host
    int log_z, select;
    uint8_t* idx;
    int* words;
    uint8_t* flags;
    int T, E, cw, rs;
};

// A block's state; block 0's is the cluster's.
struct PqState {
    int n_ok;
    unsigned fp_min;   // float bits of a positive minimum
    unsigned fin_min;  // sortable keys of the window's finite cells' range
    unsigned fin_max;
    unsigned stats;    // PQ_HAS_FP | PQ_NINF_SEL | PQ_PINF_SEL
    int select;        // the radix select runs (same in every block after the barrier)
    unsigned prefix[PQ_TARGETS];  // each target's key bits found so far
    int rank[PQ_TARGETS];         // its rank among the keys with that prefix
    int slot[PQ_TARGETS];         // the histogram it reads
    unsigned slot_prefix[PQ_TARGETS];
    int nslots;
    float frac_lo, frac_hi;
    // Resolved by block 0 for the quantize pass.
    float sub_lo, sub_hi, vmin, vmax, log_vmin, denom;
    int zero_all;
    int first_col, last_col, nan_sel;
};

__device__ __forceinline__ unsigned pq_key(float v) {
    const unsigned u = __float_as_uint(v);
    return (u >> 31) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float pq_unkey(unsigned k) {
    return __uint_as_float((k >> 31) ? (k & 0x7FFFFFFFu) : ~k);
}

__device__ __forceinline__ float pq_nan() { return __int_as_float(0x7fc00000); }

// torch.maximum: NaN if either is NaN.
__device__ __forceinline__ float pq_max_nan(float a, float b) {
    return (isnan(a) || isnan(b)) ? pq_nan() : fmaxf(a, b);
}

// numpy's _lerp, then _lerp_or_nan of ops/spectrogram.py.
__device__ __forceinline__ float pq_lerp_or_nan(float a, float b, float t, int n) {
    if (n <= 0) return pq_nan();
    if (t == 0.0f) return a;
    const float diff = __fsub_rn(b, a);
    return t >= 0.5f ? __fsub_rn(b, __fmul_rn(diff, __fsub_rn(1.0f, t))) : __fadd_rn(a, __fmul_rn(diff, t));
}

// f(t, v) over rows t0, t0 + rs, ... below t1 of column e, PQ_UNROLL loads in flight before their uses
// (a block holds ~17 warps at the audio shape: one load each would leave the SM waiting on L2).
template <class F>
__device__ __forceinline__ void pq_rows(const float* __restrict__ m, int E, int e, int t0, int t1, int rs, F&& f) {
    for (int t = t0; t < t1; t += PQ_UNROLL * rs) {
        float v[PQ_UNROLL];
#pragma unroll
        for (int u = 0; u < PQ_UNROLL; ++u) {
            const int tu = t + u * rs;
            v[u] = tu < t1 ? __ldg(m + (size_t)tu * E + e) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < PQ_UNROLL; ++u) {
            if (t + u * rs < t1) f(t + u * rs, v[u]);
        }
    }
}

// One cell -> its colormap index, with the lane's resolved scalars.
__device__ __forceinline__ uint8_t pq_index(float x, const PqState& s, int log_z) {
    float r;
    if (log_z) {
        float w = (!isfinite(x) || x <= 0.0f) ? s.vmin : x;
        w = w < 1e-37f ? 1e-37f : w;  // torch.clamp_min keeps a NaN
        r = __fdiv_rn(__fsub_rn(log10f(w), s.log_vmin), s.denom);
    } else {
        float w = isnan(x) ? s.sub_lo : x;
        if (w == -INFINITY) w = s.sub_lo;
        if (w == INFINITY) w = s.sub_hi;
        r = __fdiv_rn(__fsub_rn(w, s.vmin), s.denom);
    }
    if (s.zero_all || isnan(r)) r = 0.0f;
    return (uint8_t)fminf(fmaxf(floorf(__fmul_rn(r, 256.0f)), 0.0f), 255.0f);
}

// Block-wide exclusive scan of one int a thread; returns the thread's offset and sets *total.
__device__ int pq_block_scan(int v, int* s_warp, int* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = (blockDim.x + 31) >> 5;
    int inc = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += y;
    }
    if (lane == 31) s_warp[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        int w = lane < nw ? s_warp[lane] : 0;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, w, off);
            if (lane >= off) w += y;
        }
        if (lane < nw) s_warp[lane] = w;  // inclusive over the warps
    }
    __syncthreads();
    *total = s_warp[nw - 1];
    const int before = warp > 0 ? s_warp[warp - 1] : 0;
    __syncthreads();
    return before + inc - v;
}

// Block 0, warp j < PQ_TARGETS: the digit of target j in the merged histogram of its slot.  The warp
// sums the 32 chunks of bins with coalesced reads, finds the chunk that holds the target's rank, then
// the bin inside it.
__device__ void pq_pick_digit(PqState& st, const unsigned* s_hist, int nb, int width) {
    const int j = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (j >= PQ_TARGETS) return;
    const unsigned* h = s_hist + st.slot[j] * PQ_BINS;
    const unsigned rank = (unsigned)st.rank[j];
    const int per = nb / 32;  // bins a chunk: 64 or 32
    unsigned mine = 0;        // lane c: the sum of chunk c
    for (int c = 0; c < 32; ++c) {
        unsigned v = 0;
        for (int i = lane; i < per; i += 32) v += h[c * per + i];
        v = __reduce_add_sync(0xffffffffu, v);
        if (lane == c) mine = v;
    }
    unsigned inc = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += y;
    }
    const unsigned owner = __ballot_sync(0xffffffffu, rank >= inc - mine && rank < inc);
    if (!owner) return;  // no key at this rank: the lane's pool is empty
    const int c = __ffs(owner) - 1;
    const unsigned before = __shfl_sync(0xffffffffu, inc - mine, c);
    // Inside chunk c: lane k holds bins c * per + k * q .. + q - 1.
    const int q = per / 32;
    unsigned x[2] = {0u, 0u};
    for (int i = 0; i < q; ++i) x[i] = h[c * per + lane * q + i];
    const unsigned s = x[0] + x[1];
    unsigned incl = s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
    }
    const unsigned r = rank - before;
    if (r >= incl - s && r < incl) {
        unsigned cum = before + incl - s;
        int b = c * per + lane * q;
        if (q == 2 && cum + x[0] <= rank) {
            cum += x[0];
            ++b;
        }
        st.prefix[j] = (st.prefix[j] << width) | (unsigned)b;
        st.rank[j] = (int)(rank - cum);
    }
}

// Block 0, thread 0: one histogram for each distinct prefix.
__device__ void pq_assign_slots(PqState& st) {
    st.nslots = 0;
    for (int j = 0; j < PQ_TARGETS; ++j) {
        int s = -1;
        for (int i = 0; i < st.nslots; ++i)
            if (st.slot_prefix[i] == st.prefix[j]) s = i;
        if (s < 0) {
            s = st.nslots++;
            st.slot_prefix[s] = st.prefix[j];
        }
        st.slot[j] = s;
    }
}

// Block r's share of the rows [lo, hi) of its lane.
__device__ __forceinline__ void pq_span(int lo, int hi, int C, int r, int& r0, int& r1) {
    const int n = max(0, hi - lo), chunk = (n + C - 1) / C;
    r0 = lo + min(n, r * chunk);
    r1 = lo + min(n, (r + 1) * chunk);
}

// Add key k's digit to the histogram of the slot whose prefix it has, if any; true when it did.
__device__ __forceinline__ bool pq_count(unsigned* s_hist, const unsigned (&sp)[PQ_TARGETS], int nslots, unsigned k,
                                         int shift, int width) {
    const unsigned hi = k >> (shift + width);
#pragma unroll
    for (int j = 0; j < PQ_TARGETS; ++j) {
        if (j < nslots && hi == sp[j]) {
            atomicAdd(&s_hist[j * PQ_BINS + ((k >> shift) & ((1u << width) - 1u))], 1u);
            return true;
        }
    }
    return false;
}

__global__ void __launch_bounds__(1024) cst_percentile_quantize_kernel(const PqArgs a) {
    __shared__ unsigned s_hist[PQ_TARGETS * PQ_BINS];  // 32 KB
    __shared__ unsigned s_cand[PQ_CAND];               // 12 KB: the keys of the second digit's buckets
    __shared__ PqState st;
    __shared__ int s_warp[32];
    __shared__ unsigned s_ncand;

    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)gridDim.x;  // the cluster spans the grid's x
    const int r = (int)blockIdx.x;
    const int l = (int)blockIdx.y;
    const int T = a.T, E = a.E;
    PqState* st0 = cluster.map_shared_rank(&st, 0);
    unsigned* hist0 = cluster.map_shared_rank(s_hist, 0);

    const int W = 2 * E + PQ_SCALARS;
    int* words = a.words + (size_t)l * W;
    int* colflags = words + E;
    const float* m = a.m + (size_t)l * T * E;
    uint8_t* idx = a.idx + (size_t)l * T * E;
    const uint8_t* ev = a.e_valid + (size_t)l * E;
    const uint8_t* zev = a.zb_e_valid + (size_t)l * E;
    const int tv = min(a.t_valid[l], T), ts = a.t_start[l], te = a.t_start[l] + a.t_count[l];
    const bool full = a.zb_full != nullptr && a.zb_full[l];
    // The bounds pool's rows: the file's, or the window's inside the file.
    const int zlo = full ? 0 : max(ts, 0), zhi = full ? tv : min(te, tv);

    // This thread's column and row stride.
    const int cx = threadIdx.x % a.cw, ry = threadIdx.x / a.cw;
    const bool active = ry < a.rs;
    const int ct = (E + a.cw - 1) / a.cw;

    for (int i = threadIdx.x; i < PQ_TARGETS * PQ_BINS; i += blockDim.x) s_hist[i] = 0u;
    for (int e = r * blockDim.x + threadIdx.x; e < E; e += C * blockDim.x) colflags[e] = 0;
    if (threadIdx.x == 0) {
        st.n_ok = 0;
        st.fp_min = 0x7F800000u;  // +inf
        st.fin_min = PQ_KEY_NONE;
        st.fin_max = 0u;
        st.stats = 0u;
        st.first_col = E;
        st.last_col = -1;
        st.nan_sel = 0;
        s_ncand = 0u;
    }
    __threadfence();
    cluster.sync();

    // Pass 1, over the file rows (no other row adds to a column flag, a statistic or the pool): column
    // flags, statistics, the first digit's histogram.
    {
        int r0, r1;
        pq_span(0, tv, C, r, r0, r1);
        int n_ok = 0;
        float fpmin = INFINITY;
        unsigned fmin = PQ_KEY_NONE, fmax = 0u, stats = 0u;
        for (int tile = 0; tile < ct; ++tile) {
            const int e = tile * a.cw + cx;
            if (!active || e >= E) continue;
            const bool e_ok = ev[e] != 0, z_ok = zev[e] != 0;
            unsigned col = 0u;
            pq_rows(m, E, e, r0 + ry, r1, a.rs, [&](int t, float v) {
                const bool in_win = t >= ts && t < te;
                const bool nan = isnan(v);
                if (!nan) col |= PQ_COL_ANY;
                if (in_win && nan) col |= PQ_COL_NANW;
                bool fp = false;
                if (in_win && e_ok && !nan) {
                    if (isfinite(v)) {
                        const unsigned k = pq_key(v);
                        fmin = min(fmin, k);
                        fmax = max(fmax, k);
                        fp = v > 0.0f;
                    } else {
                        stats |= v < 0.0f ? PQ_NINF_SEL : PQ_PINF_SEL;
                    }
                }
                if (fp) stats |= PQ_HAS_FP;
                fpmin = fminf(fpmin, fp ? v : PQ_BIG);
                if (a.select && t >= zlo && t < zhi && z_ok && !nan) {
                    ++n_ok;
                    atomicAdd(&s_hist[pq_key(v) >> 21], 1u);
                }
            });
            if (col) atomicOr(colflags + e, (int)col);
        }
        n_ok = __reduce_add_sync(0xffffffffu, n_ok);
        fmin = __reduce_min_sync(0xffffffffu, fmin);
        fmax = __reduce_max_sync(0xffffffffu, fmax);
        stats = __reduce_or_sync(0xffffffffu, stats);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) fpmin = fminf(fpmin, __shfl_xor_sync(0xffffffffu, fpmin, off));
        if ((threadIdx.x & 31) == 0) {
            if (n_ok) atomicAdd(&st0->n_ok, n_ok);
            atomicMin(&st0->fp_min, __float_as_uint(fpmin));  // positive floats order as unsigned ints
            if (fmin != PQ_KEY_NONE) atomicMin(&st0->fin_min, fmin);
            if (fmax) atomicMax(&st0->fin_max, fmax);
            if (stats) atomicOr(&st0->stats, stats);
        }
    }
    __syncthreads();
    if (r != 0) {
        for (int b = threadIdx.x; b < PQ_BINS; b += blockDim.x) {
            const unsigned v = s_hist[b];
            if (v) atomicAdd(hist0 + b, v);
        }
    }
    __threadfence();
    cluster.sync();

    // The first digit of each target.
    if (r == 0) {
        if (threadIdx.x == 0) {
            st.select = a.select && st.n_ok > 0;
            const float nf = __int2float_rn(max(st.n_ok - 1, 0));
            const float pos_lo = __fmul_rn(a.q_lo, nf), pos_hi = __fmul_rn(a.q_hi, nf);
            st.rank[0] = (int)floorf(pos_lo);
            st.rank[1] = (int)ceilf(pos_lo);
            st.rank[2] = (int)floorf(pos_hi);
            st.rank[3] = (int)ceilf(pos_hi);
            st.frac_lo = __fsub_rn(pos_lo, floorf(pos_lo));
            st.frac_hi = __fsub_rn(pos_hi, floorf(pos_hi));
            for (int j = 0; j < PQ_TARGETS; ++j) {
                st.prefix[j] = 0u;
                st.slot[j] = 0;
            }
        }
        __syncthreads();
        if (st.select) pq_pick_digit(st, s_hist, PQ_BINS, 11);
        __syncthreads();
        if (threadIdx.x == 0) pq_assign_slots(st);
        for (int i = threadIdx.x; i < PQ_TARGETS * PQ_BINS; i += blockDim.x) s_hist[i] = 0u;
    }
    __syncthreads();
    cluster.sync();

    // Passes 2 and 3: the next digits of the keys that share a target's prefix.  Pass 2 keeps those keys
    // in shared memory, so pass 3 reads them there unless they overflowed it.
    const int selecting = st0->select;
    for (int pass = 0; selecting && pass < 2; ++pass) {
        const int shift = pass == 0 ? 10 : 0;
        const int width = pass == 0 ? 11 : 10;
        if (r != 0) {
            if (threadIdx.x == 0) {
                st.nslots = st0->nslots;
                for (int j = 0; j < PQ_TARGETS; ++j) st.slot_prefix[j] = st0->slot_prefix[j];
            }
            for (int i = threadIdx.x; i < PQ_TARGETS * PQ_BINS; i += blockDim.x) s_hist[i] = 0u;
        }
        __syncthreads();
        const int nslots = st.nslots;
        unsigned sp[PQ_TARGETS];
#pragma unroll
        for (int j = 0; j < PQ_TARGETS; ++j) sp[j] = st.slot_prefix[j];
        const unsigned ncand = s_ncand;
        if (pass == 1 && ncand <= PQ_CAND) {
            for (unsigned i = threadIdx.x; i < ncand; i += blockDim.x) pq_count(s_hist, sp, nslots, s_cand[i], shift, width);
        } else {
            int r0, r1;
            pq_span(zlo, zhi, C, r, r0, r1);
            for (int tile = 0; tile < ct; ++tile) {
                const int e = tile * a.cw + cx;
                if (!active || e >= E || !zev[e]) continue;
                pq_rows(m, E, e, r0 + ry, r1, a.rs, [&](int t, float v) {
                    if (isnan(v)) return;
                    const unsigned k = pq_key(v);
                    if (pq_count(s_hist, sp, nslots, k, shift, width) && pass == 0) {
                        // Keep the key: the warp's matching threads take consecutive places.
                        cg::coalesced_group g = cg::coalesced_threads();
                        unsigned base = 0;
                        if (g.thread_rank() == 0) base = atomicAdd(&s_ncand, (unsigned)g.size());
                        const unsigned at = g.shfl(base, 0u) + (unsigned)g.thread_rank();
                        if (at < PQ_CAND) s_cand[at] = k;
                    }
                });
            }
        }
        __syncthreads();
        if (r != 0) {
            for (int i = threadIdx.x; i < nslots * PQ_BINS; i += blockDim.x) {
                const unsigned v = s_hist[i];
                if (v) atomicAdd(hist0 + i, v);
            }
        }
        cluster.sync();
        if (r == 0) {
            pq_pick_digit(st, s_hist, 1 << width, width);
            __syncthreads();
            if (threadIdx.x == 0) pq_assign_slots(st);
            for (int i = threadIdx.x; i < PQ_TARGETS * PQ_BINS; i += blockDim.x) s_hist[i] = 0u;
            __syncthreads();
        }
        cluster.sync();
    }

    // Block 0 resolves the lane: kept columns, energy extent, bounds.
    if (r == 0) {
        const int per = (E + blockDim.x - 1) / blockDim.x;
        const int e0 = min(E, (int)threadIdx.x * per), e1 = min(E, e0 + per);
        int cnt = 0, nan_sel = 0, first = E, last = -1;
        for (int e = e0; e < e1; ++e) {
            const int f = __ldcg(colflags + e);
            if ((f & PQ_COL_ANY) && ev[e]) {
                ++cnt;
                nan_sel |= f & PQ_COL_NANW;
                first = min(first, e);
                last = max(last, e);
            }
        }
        int n_kept;
        int before = pq_block_scan(cnt, s_warp, &n_kept);
        for (int e = e0; e < e1; ++e) {
            const int f = __ldcg(colflags + e);
            if ((f & PQ_COL_ANY) && ev[e]) {
                words[before++] = e;
            } else {
                words[n_kept + e - before] = e;
            }
        }
        if (nan_sel) atomicOr(&st.nan_sel, 1);
        if (cnt) {
            atomicMin(&st.first_col, first);
            atomicMax(&st.last_col, last);
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            const int fc = n_kept > 0 ? st.first_col : 0, lc = n_kept > 0 ? st.last_col : 0;
            const float y_first = a.energy[(size_t)l * E + fc], y_last = a.energy[(size_t)l * E + lc];
            const bool flip = y_first > y_last;
            const bool empty = n_kept == 0 || a.t_count[l] <= 0;

            float vmin = a.z_bounds[2 * l], vmax = a.z_bounds[2 * l + 1];
            float s[PQ_TARGETS];
            for (int j = 0; j < PQ_TARGETS; ++j) s[j] = pq_unkey(st.select ? st.prefix[j] : PQ_KEY_NONE);
            if (a.select) {
                const float p_lo = pq_lerp_or_nan(s[0], s[1], st.frac_lo, st.n_ok);
                const float p_hi = pq_lerp_or_nan(s[2], s[3], st.frac_hi, st.n_ok);
                if (isnan(vmin)) vmin = p_lo;
                if (isnan(vmax)) vmax = p_hi;
            }
            float sub_lo = vmin, sub_hi = vmax, log_vmin = 0.0f, denom = 1.0f;
            if (a.log_z) {
                // Rows past the file are not finite positive: the minimum takes the fill for them.
                const float fp_min = tv < T ? fminf(__uint_as_float(st.fp_min), PQ_BIG) : __uint_as_float(st.fp_min);
                const float safe = (st.stats & PQ_HAS_FP) ? fp_min : PQ_FLOOR;
                vmin = pq_max_nan(pq_max_nan(vmin, safe), PQ_FLOOR);
                log_vmin = log10f(vmin);
                const float span = __fsub_rn(log10f(vmax), log_vmin);
                denom = span == 0.0f ? 1.0f : span;
                sub_lo = vmin;
            } else {
                const bool bad = !(isfinite(vmin) && isfinite(vmax) && vmax > vmin);
                if (bad && !empty) {
                    // The substituted matrix's own range over the kept window cells
                    // (reference plotting.py:313-315): the finite cells, the fill
                    // where a cell is outside, and the substitutes of NaN and +-inf.
                    const long long win = max(0, min(min(tv, te), T) - max(ts, 0));
                    const bool outside = win * n_kept < (long long)T * E;
                    const bool use_lo = st.nan_sel || (st.stats & PQ_NINF_SEL);
                    const bool use_hi = (st.stats & PQ_PINF_SEL) != 0;
                    float lo = INFINITY, hi = -INFINITY;
                    if (st.fin_min != PQ_KEY_NONE) {
                        lo = pq_unkey(st.fin_min);
                        hi = pq_unkey(st.fin_max);
                    }
                    if (outside) {
                        lo = fminf(lo, PQ_BIG);
                        hi = fmaxf(hi, -PQ_BIG);
                    }
                    bool nan = false;
                    if (use_lo) {
                        nan |= isnan(sub_lo);
                        lo = fminf(lo, sub_lo);
                        hi = fmaxf(hi, sub_lo);
                    }
                    if (use_hi) {
                        nan |= isnan(sub_hi);
                        lo = fminf(lo, sub_hi);
                        hi = fmaxf(hi, sub_hi);
                    }
                    vmin = nan ? pq_nan() : lo;
                    vmax = nan ? pq_nan() : hi;
                }
                const float span = __fsub_rn(vmax, vmin);
                denom = span == 0.0f ? 1.0f : span;
            }
            st.sub_lo = sub_lo;
            st.sub_hi = sub_hi;
            st.vmin = vmin;
            st.vmax = vmax;
            st.log_vmin = log_vmin;
            st.denom = denom;
            st.zero_all = vmin == vmax;

            float* out = reinterpret_cast<float*>(words + 2 * E);
            out[0] = flip ? y_last : y_first;
            out[1] = flip ? y_first : y_last;
            out[2] = vmin;
            out[3] = vmax;
            words[2 * E + 4] = n_kept;
            words[2 * E + 5] = st.n_ok;
            for (int j = 0; j < PQ_TARGETS; ++j) out[6 + j] = s[j];
            a.flags[2 * l] = flip;
            a.flags[2 * l + 1] = empty;
        }
        __syncthreads();
    }
    cluster.sync();
    if (r != 0 && threadIdx.x == 0) {
        st.sub_lo = st0->sub_lo;
        st.sub_hi = st0->sub_hi;
        st.vmin = st0->vmin;
        st.vmax = st0->vmax;
        st.log_vmin = st0->log_vmin;
        st.denom = st0->denom;
        st.zero_all = st0->zero_all;
    }
    cluster.sync();  // no block reads block 0's memory past here

    // The quantize pass: every cell of the block's rows; a NaN cell (the rows past the file, mostly)
    // takes the lane's one index for NaN.
    int r0, r1;
    pq_span(0, T, C, r, r0, r1);
    const uint8_t nan_idx = pq_index(pq_nan(), st, a.log_z);
    for (int tile = 0; tile < ct; ++tile) {
        const int e = tile * a.cw + cx;
        if (!active || e >= E) continue;
        pq_rows(m, E, e, r0 + ry, r1, a.rs, [&](int t, float v) {
            idx[(size_t)t * E + e] = isnan(v) ? nan_idx : pq_index(v, st, a.log_z);
        });
    }
}

// What the card offers this kernel: the largest cluster it schedules, 16 blocks where it can (a
// non-portable size), else the portable 8; and its number of SMs.  Asked once a process.
struct PqCard {
    int most = PQ_PORTABLE_CLUSTER;
    int sms = 132;  // an H100 SXM's, where the device cannot be asked
};

static const PqCard& pq_card() {
    static std::once_flag once;
    static PqCard card;
    std::call_once(once, [] {
        int dev = 0, sms = 0;
        if (cudaGetDevice(&dev) == cudaSuccess &&
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess && sms > 0) {
            card.sms = sms;
        } else {
            cudaGetLastError();
        }
        if (cudaFuncSetAttribute(cst_percentile_quantize_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
            cudaSuccess) {
            cudaGetLastError();
            return;
        }
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(PQ_MAX_CLUSTER, 1, 1);
        cfg.blockDim = dim3(1024, 1, 1);
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = PQ_MAX_CLUSTER;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        int n = 0;
        if (cudaOccupancyMaxActiveClusters(&n, cst_percentile_quantize_kernel, &cfg) == cudaSuccess && n > 0) {
            card.most = PQ_MAX_CLUSTER;
        } else {
            cudaGetLastError();
        }
    });
    return card;
}

extern "C" int cst_percentile_quantize(const float* m, const float* energy, const uint8_t* e_valid,
                                       const uint8_t* zb_e_valid, const int* t_valid, const int* t_start,
                                       const int* t_count, const float* z_bounds, const uint8_t* zb_full,
                                       float q_lo, float q_hi, int log_z, int select, uint8_t* idx, int* words,
                                       uint8_t* flags, int L, int T, int E, void* stream) {
    if (L <= 0 || T <= 0 || E <= 0) return 0;
    if (L > 65535) return (int)cudaErrorInvalidConfiguration;
    PqArgs a{m, energy, e_valid, zb_e_valid, t_valid, t_start, t_count, z_bounds, zb_full, q_lo, q_hi, log_z,
             select, idx, words, flags, T, E, 0, 0};
    // A thread a column; short rows stack row strides up to ~512 threads a block.
    a.cw = E < 1024 ? E : 1024;
    a.rs = E >= 512 ? 1 : 512 / E;
    const int threads = ((a.cw * a.rs + 31) / 32) * 32;
    // A cluster a lane: enough blocks for the lane's cells, fewer when many lanes fill the card.
    const long long cells = (long long)T * E;
    long long c = (cells + PQ_CELLS_A_BLOCK - 1) / PQ_CELLS_A_BLOCK;
    const PqCard& card = pq_card();
    const long long fill = (2LL * card.sms + L - 1) / L;
    const long long most = card.most;
    c = c < fill ? c : fill;
    const int C = (int)(c < 1 ? 1 : c > most ? most : c);
    if (C > PQ_PORTABLE_CLUSTER) {
        const cudaError_t err = cudaFuncSetAttribute(cst_percentile_quantize_kernel,
                                                     cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return (int)err;
    }

    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)C, (unsigned)L, 1);
    cfg.blockDim = dim3((unsigned)threads, 1, 1);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, cst_percentile_quantize_kernel, a);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
