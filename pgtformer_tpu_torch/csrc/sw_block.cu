// Fused shifted-window transformer block for Hopper (sm_90a), bf16.
//
// Replaces the TPU kernel pgtformer_tpu/ops/pallas_attn.py:_pallas_sw_block_5d
// (reached through fused_sw_block_5d).  One block computes, for every window
// of T*wh*ww tokens read straight from the [B, T, H, W, C] layout:
//
//     x += proj(softmax(q k^T * hd^-1/2 + relbias[h] [+ shift mask]) v)
//     x += fc2(gelu(fc1(LN2 x)))          (q, k, v from LN1 x)
//
// The half-window roll is an address change: token (t, i, j) of window
// (r, c) reads and writes pixel ((r*wh+i+sh) mod H, (c*ww+j+sw) mod W).
// Numerics follow the XLA path of the JAX package: LayerNorm eps 1e-6 with
// fp32 statistics, exact erf GELU, fp32 softmax, bf16 GEMM operands with
// fp32 accumulation, and an fp32 residual stream.
//
// What bounds it on an H100: the block is 12*C^2 + O(N*C) FLOP per token, so
// at C=256/512 it is compute-bound on paper (~295 FLOP/byte needed; the
// kernel does >1000 per byte of activations).  In practice this first
// version is bound by its weight traffic and tensor-core feed: it uses
// nvcuda::wmma 16x16x16 fragments with B operands (the weights, 6*C^2 bf16
// per block) loaded straight from L2 by every CTA.  What the design does
// about it: a CTA holds 48 token rows (one T=3 window), so each weight
// fragment feeds 3 MMAs, and at C<=256 two CTAs share an SM to hide the L2
// latency (96-row CTAs, one per SM, were slower); the whole block
// (LN, attention per head, proj, MLP) stays in shared memory, so activations
// cross device memory once in and once out.  wgmma/TMA with weights staged
// in shared memory are left to a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#define NWARPS 8
#define NTHREADS (NWARPS * 32)
constexpr int MT = 3;       // 16-row tiles per CTA
constexpr int M = 16 * MT;  // token rows per CTA: one T=3 window of 4x4

struct SWArgs {
    const bf16* x;
    bf16* out;
    const float* ln1w;
    const float* ln1b;
    const bf16* wq;
    const float* bq;
    const bf16* wk;
    const float* bk;
    const bf16* wv;
    const float* bv;
    const bf16* wp;
    const float* bp;
    const float* ln2w;
    const float* ln2b;
    const bf16* w1;
    const float* b1;
    const bf16* w2;
    const float* b2;
    const float* relb;  // [heads, N, N]
    int B, T, H, W, C, heads, hd, wh, ww, sh, sw, N, nWh, nWw, nwin;
    int wpc;            // windows per CTA
    float scale;
    // shared-memory carve-up (bytes)
    int off_y, off_z, off_k, off_v, off_s, off_p, off_stg, off_lab;
};

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> AFrag;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> BColFrag;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> BRowFrag;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// Element offset of token n of window `win` in the [B, T, H, W, C] array.
__device__ __forceinline__ long long pix_offset(const SWArgs& a, int win, int n) {
    int per_img = a.nWh * a.nWw;
    int b = win / per_img;
    int rc = win - b * per_img;
    int r = rc / a.nWw, c = rc - (rc / a.nWw) * a.nWw;
    int per = a.wh * a.ww;
    int t = n / per, sp = n - (n / per) * per;
    int i = sp / a.ww, j = sp - (sp / a.ww) * a.ww;
    int y = r * a.wh + i + a.sh;
    if (y >= a.H) y -= a.H;
    int xx = c * a.ww + j + a.sw;
    if (xx >= a.W) xx -= a.W;
    return ((((long long)b * a.T + t) * a.H + y) * a.W + xx) * a.C;
}

// Shift-mask region label of token n of window `win` (rolled coordinates).
__device__ __forceinline__ int region_label(const SWArgs& a, int win, int n) {
    int rc = win % (a.nWh * a.nWw);
    int r = rc / a.nWw, c = rc % a.nWw;
    int sp = n % (a.wh * a.ww);
    int y = r * a.wh + sp / a.ww;
    int xx = c * a.ww + sp % a.ww;
    int hl = y < a.H - a.wh ? 0 : (y < a.H - a.sh ? 1 : 2);
    int wl = xx < a.W - a.ww ? 0 : (xx < a.W - a.sw ? 1 : 2);
    return hl * 3 + wl;
}

// acc[mt] = A[mt*16 .. +16, 0:K] @ W[n0 .. n0+16, 0:K]^T  (W is (O, I) row-major)
__device__ __forceinline__ void gemm_strip(AccFrag (&acc)[MT], const bf16* A, int lda,
                                           const bf16* wrow, int K) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) wmma::fill_fragment(acc[mt], 0.0f);
    for (int k0 = 0; k0 < K; k0 += 16) {
        BColFrag b;
        wmma::load_matrix_sync(b, wrow + k0, K);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            AFrag a;
            wmma::load_matrix_sync(a, A + mt * 16 * lda + k0, lda);
            wmma::mma_sync(acc[mt], a, b, acc[mt]);
        }
    }
}

// Stage one 16x16 accumulator through this warp's fp32 tile and hand each
// element to f(row, col, value).
template <typename F>
__device__ __forceinline__ void epilogue(float* stg, const AccFrag& acc, int lane, F f) {
    wmma::store_matrix_sync(stg, acc, 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        int e = lane * 8 + i;
        f(e >> 4, e & 15, stg[e]);
    }
    __syncwarp();
}

// LayerNorm of one C-wide row held as 2 values per lane per 64 channels.
__device__ __forceinline__ void ln_row(float (&v)[16], int nk, int C, const float* w,
                                       const float* b, bf16* dst, int lane) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k)
        if (k < nk) s += v[2 * k] + v[2 * k + 1];
    float mean = warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k)
        if (k < nk) {
            float d0 = v[2 * k] - mean, d1 = v[2 * k + 1] - mean;
            q += d0 * d0 + d1 * d1;
        }
    float rstd = rsqrtf(warp_sum(q) / C + 1e-6f);
#pragma unroll
    for (int k = 0; k < 8; ++k)
        if (k < nk) {
            int c = k * 64 + lane * 2;
            float y0 = (v[2 * k] - mean) * rstd * w[c] + b[c];
            float y1 = (v[2 * k + 1] - mean) * rstd * w[c + 1] + b[c + 1];
            *reinterpret_cast<__nv_bfloat162*>(dst + c) = __floats2bfloat162_rn(y0, y1);
        }
}

// Two CTAs per SM at C<=256 (108 KB of shared memory each): cap registers at 128.
__global__ void __launch_bounds__(NTHREADS, 2) sw_block_kernel(SWArgs a) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int C = a.C, N = a.N, hd = a.hd;
    const int ldh = C + 8;   // bf16 row stride of [M, C] tiles
    const int ldf = C + 4;   // fp32 row stride of the residual stream
    const int ldd = hd + 8;  // bf16 row stride of per-head q/k/v
    const int ldn = N + 4;   // fp32 row stride of scores
    const int ldp = N + 8;   // bf16 row stride of probabilities
    const int nk = C / 64;

    bf16* h1 = reinterpret_cast<bf16*>(smem);             // phase A: LN1 x
    float* xs = reinterpret_cast<float*>(smem);           // phases B-D: residual
    bf16* ybuf = reinterpret_cast<bf16*>(smem + a.off_y); // attn out, then LN2 x
    bf16* zbuf = reinterpret_cast<bf16*>(smem + a.off_z); // fc1 out
    bf16* qh = zbuf;                                      // phase A per-head scratch
    bf16* kh = reinterpret_cast<bf16*>(smem + a.off_k);
    bf16* vh = reinterpret_cast<bf16*>(smem + a.off_v);
    float* sc = reinterpret_cast<float*>(smem + a.off_s);
    bf16* pr = reinterpret_cast<bf16*>(smem + a.off_p);

    int* lab = reinterpret_cast<int*>(smem + a.off_lab);  // shift-region label per row

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* stg = reinterpret_cast<float*>(smem + a.off_stg) + warp * 256;
    const int win0 = blockIdx.x * a.wpc;
    const bool masked = a.sh > 0 || a.sw > 0;
    if (masked)
        for (int row = threadIdx.x; row < M; row += NTHREADS)
            lab[row] = region_label(a, win0 + row / N, row % N);

    // ---- LN1 straight from the 5-D input -----------------------------------
    for (int row = warp; row < M; row += NWARPS) {
        int win = win0 + row / N;
        bf16* dst = h1 + row * ldh;
        if (win >= a.nwin) {
            for (int c = lane * 2; c < C; c += 64)
                *reinterpret_cast<__nv_bfloat162*>(dst + c) = __floats2bfloat162_rn(0.f, 0.f);
            continue;
        }
        const bf16* src = a.x + pix_offset(a, win, row % N);
        float v[16];
#pragma unroll
        for (int k = 0; k < 8; ++k)
            if (k < nk) {
                float2 f = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(src + k * 64 + lane * 2));
                v[2 * k] = f.x;
                v[2 * k + 1] = f.y;
            }
        ln_row(v, nk, C, a.ln1w, a.ln1b, dst, lane);
    }
    __syncthreads();

    // ---- attention, one head at a time ------------------------------------
    const int nsh = hd / 16;      // 16-wide strips per projection of one head
    const int nt = N / 16;        // 16-row tiles per window
    for (int hh = 0; hh < a.heads; ++hh) {
        for (int s = warp; s < 3 * nsh; s += NWARPS) {
            int which = s / nsh, col0 = (s % nsh) * 16;
            int n0 = hh * hd + col0;
            const bf16* w = which == 0 ? a.wq : (which == 1 ? a.wk : a.wv);
            const float* bias = which == 0 ? a.bq : (which == 1 ? a.bk : a.bv);
            bf16* dst = which == 0 ? qh : (which == 1 ? kh : vh);
            float mul = which == 0 ? a.scale : 1.0f;
            AccFrag acc[MT];
            gemm_strip(acc, h1, ldh, w + (long long)n0 * C, C);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
                epilogue(stg, acc[mt], lane, [&](int rr, int cc, float val) {
                    dst[(mt * 16 + rr) * ldd + col0 + cc] =
                        __float2bfloat16((val + bias[n0 + cc]) * mul);
                });
        }
        __syncthreads();

        // scores S_w = q_w k_w^T for every window of the CTA
        for (int t = warp; t < a.wpc * nt * nt; t += NWARPS) {
            int wi = t / (nt * nt), rem = t % (nt * nt);
            int ti = rem / nt, tj = rem % nt;
            AccFrag acc;
            wmma::fill_fragment(acc, 0.0f);
            for (int k0 = 0; k0 < hd; k0 += 16) {
                AFrag fa;
                BColFrag fb;
                wmma::load_matrix_sync(fa, qh + (wi * N + ti * 16) * ldd + k0, ldd);
                wmma::load_matrix_sync(fb, kh + (wi * N + tj * 16) * ldd + k0, ldd);
                wmma::mma_sync(acc, fa, fb, acc);
            }
            wmma::store_matrix_sync(sc + (wi * N + ti * 16) * ldn + tj * 16, acc, ldn,
                                    wmma::mem_row_major);
        }
        __syncthreads();

        // softmax rows (fp32) -> bf16 probabilities
        for (int row = warp; row < a.wpc * N; row += NWARPS) {
            int wi = row / N, i = row % N;
            const int* wlab = lab + wi * N;
            const float* srow = sc + row * ldn;
            const float* brow = a.relb + ((long long)hh * N + i) * N;
            float v0 = -INFINITY, v1 = -INFINITY;
            int j0 = lane, j1 = lane + 32;
            if (j0 < N) {
                v0 = srow[j0] + brow[j0];
                if (masked && wlab[j0] != wlab[i]) v0 -= 100.0f;
            }
            if (j1 < N) {
                v1 = srow[j1] + brow[j1];
                if (masked && wlab[j1] != wlab[i]) v1 -= 100.0f;
            }
            float m = warp_max(fmaxf(v0, v1));
            float e0 = j0 < N ? __expf(v0 - m) : 0.f;
            float e1 = j1 < N ? __expf(v1 - m) : 0.f;
            float inv = 1.0f / warp_sum(e0 + e1);
            bf16* prow = pr + row * ldp;
            if (j0 < N) prow[j0] = __float2bfloat16(e0 * inv);
            if (j1 < N) prow[j1] = __float2bfloat16(e1 * inv);
        }
        __syncthreads();

        // o_w = p_w v_w, written into this head's columns of the attn output
        for (int t = warp; t < a.wpc * nt * nsh; t += NWARPS) {
            int wi = t / (nt * nsh), rem = t % (nt * nsh);
            int ti = rem / nsh, tj = rem % nsh;
            AccFrag acc;
            wmma::fill_fragment(acc, 0.0f);
            for (int k0 = 0; k0 < N; k0 += 16) {
                AFrag fa;
                BRowFrag fb;
                wmma::load_matrix_sync(fa, pr + (wi * N + ti * 16) * ldp + k0, ldp);
                wmma::load_matrix_sync(fb, vh + (wi * N + k0) * ldd + tj * 16, ldd);
                wmma::mma_sync(acc, fa, fb, acc);
            }
            int r0 = wi * N + ti * 16, c0 = hh * hd + tj * 16;
            epilogue(stg, acc, lane, [&](int rr, int cc, float val) {
                ybuf[(r0 + rr) * ldh + c0 + cc] = __float2bfloat16(val);
            });
        }
        __syncthreads();
    }

    // ---- residual stream in fp32, proj -------------------------------------
    for (int row = warp; row < M; row += NWARPS) {
        int win = win0 + row / N;
        float* dst = xs + row * ldf;
        if (win >= a.nwin) {
            for (int c = lane * 2; c < C; c += 64) dst[c] = dst[c + 1] = 0.f;
            continue;
        }
        const bf16* src = a.x + pix_offset(a, win, row % N);
        for (int c = lane * 2; c < C; c += 64) {
            float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + c));
            dst[c] = f.x;
            dst[c + 1] = f.y;
        }
    }
    __syncthreads();

    for (int s = warp; s < C / 16; s += NWARPS) {
        int n0 = s * 16;
        AccFrag acc[MT];
        gemm_strip(acc, ybuf, ldh, a.wp + (long long)n0 * C, C);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
            epilogue(stg, acc[mt], lane, [&](int rr, int cc, float val) {
                xs[(mt * 16 + rr) * ldf + n0 + cc] += val + a.bp[n0 + cc];
            });
    }
    __syncthreads();

    // ---- MLP ----------------------------------------------------------------
    for (int row = warp; row < M; row += NWARPS) {
        const float* src = xs + row * ldf;
        float v[16];
#pragma unroll
        for (int k = 0; k < 8; ++k)
            if (k < nk) {
                v[2 * k] = src[k * 64 + lane * 2];
                v[2 * k + 1] = src[k * 64 + lane * 2 + 1];
            }
        ln_row(v, nk, C, a.ln2w, a.ln2b, ybuf + row * ldh, lane);
    }
    __syncthreads();

    for (int s = warp; s < C / 16; s += NWARPS) {
        int n0 = s * 16;
        AccFrag acc[MT];
        gemm_strip(acc, ybuf, ldh, a.w1 + (long long)n0 * C, C);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
            epilogue(stg, acc[mt], lane, [&](int rr, int cc, float val) {
                float u = val + a.b1[n0 + cc];
                u = 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
                zbuf[(mt * 16 + rr) * ldh + n0 + cc] = __float2bfloat16(u);
            });
    }
    __syncthreads();

    for (int s = warp; s < C / 16; s += NWARPS) {
        int n0 = s * 16;
        AccFrag acc[MT];
        gemm_strip(acc, zbuf, ldh, a.w2 + (long long)n0 * C, C);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
            epilogue(stg, acc[mt], lane, [&](int rr, int cc, float val) {
                xs[(mt * 16 + rr) * ldf + n0 + cc] += val + a.b2[n0 + cc];
            });
    }
    __syncthreads();

    // ---- write back to the same (shifted) pixels ---------------------------
    for (int row = warp; row < M; row += NWARPS) {
        int win = win0 + row / N;
        if (win >= a.nwin) continue;
        bf16* dst = a.out + pix_offset(a, win, row % N);
        const float* src = xs + row * ldf;
        for (int c = lane * 2; c < C; c += 64)
            *reinterpret_cast<__nv_bfloat162*>(dst + c) = __floats2bfloat162_rn(src[c], src[c + 1]);
    }
}

static int align128(int v) { return (v + 127) & ~127; }

static int launch(SWArgs a, cudaStream_t stream) {
    const int C = a.C, N = a.N, hd = a.hd;
    int x_bytes = align128(M * (C + 4) * 4);
    int y_bytes = align128(M * (C + 8) * 2);
    int head_q = align128(M * (hd + 8) * 2);
    int head_s = align128(a.wpc * N * (N + 4) * 4);
    int head_p = align128(a.wpc * N * (N + 8) * 2);
    int head_bytes = 3 * head_q + head_s + head_p;
    int z_bytes = y_bytes > head_bytes ? y_bytes : head_bytes;
    a.off_y = x_bytes;
    a.off_z = x_bytes + y_bytes;
    a.off_k = a.off_z + head_q;
    a.off_v = a.off_k + head_q;
    a.off_s = a.off_v + head_q;
    a.off_p = a.off_s + head_s;
    a.off_stg = a.off_z + z_bytes;
    a.off_lab = a.off_stg + NWARPS * 256 * 4;
    int smem = a.off_lab + align128(M * 4);
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(sw_block_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    int grid = (a.nwin + a.wpc - 1) / a.wpc;
    sw_block_kernel<<<grid, NTHREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

// Plain C entry point (loaded with ctypes).  Every pointer is a device
// pointer; matrices are bf16 (out_features, in_features) row-major, vectors
// and the [heads, N, N] relative bias fp32.  Returns a cudaError_t code (0 on
// success).
extern "C" int sw_block_launch(const void* x, void* out, const void* ln1w, const void* ln1b,
                               const void* wq, const void* bq, const void* wk, const void* bk,
                               const void* wv, const void* bv, const void* wp, const void* bp,
                               const void* ln2w, const void* ln2b, const void* w1, const void* b1,
                               const void* w2, const void* b2, const void* relb, int B, int T,
                               int H, int W, int C, int heads, int wh, int ww, int sh, int sw,
                               float scale, void* stream) {
    SWArgs a;
    a.x = (const bf16*)x;
    a.out = (bf16*)out;
    a.ln1w = (const float*)ln1w;
    a.ln1b = (const float*)ln1b;
    a.wq = (const bf16*)wq;
    a.bq = (const float*)bq;
    a.wk = (const bf16*)wk;
    a.bk = (const float*)bk;
    a.wv = (const bf16*)wv;
    a.bv = (const float*)bv;
    a.wp = (const bf16*)wp;
    a.bp = (const float*)bp;
    a.ln2w = (const float*)ln2w;
    a.ln2b = (const float*)ln2b;
    a.w1 = (const bf16*)w1;
    a.b1 = (const float*)b1;
    a.w2 = (const bf16*)w2;
    a.b2 = (const float*)b2;
    a.relb = (const float*)relb;
    a.B = B;
    a.T = T;
    a.H = H;
    a.W = W;
    a.C = C;
    a.heads = heads;
    a.hd = C / heads;
    a.wh = wh;
    a.ww = ww;
    a.sh = sh;
    a.sw = sw;
    a.N = T * wh * ww;
    a.nWh = H / wh;
    a.nWw = W / ww;
    a.nwin = B * a.nWh * a.nWw;
    a.scale = scale;
    if (C % 64 || C > 512 || a.hd % 16 || a.hd > 64 || a.N % 16 || a.N > 64 ||
        H % wh || W % ww || sh < 0 || sh >= wh || sw < 0 || sw >= ww || M % a.N)
        return (int)cudaErrorInvalidValue;
    a.wpc = M / a.N;
    return launch(a, (cudaStream_t)stream);
}
