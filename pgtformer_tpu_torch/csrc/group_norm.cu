// GroupNorm(32) with an optional SiLU on a channels-last bf16 tensor, Hopper
// (sm_90a).
//
// Replaces no TPU kernel: on the TPU, XLA fuses the JAX package's GroupNorm
// and SiLU into the neighbouring ops.  On the card the port ran them as
// ATen's reductions, about a dozen small ops on [N, C] and a mixed-dtype
// addcmul, then a separate SiLU: x read three times and written twice, and
// some twenty launches a norm.
//
//     y = x * a[n, c] + b[n, c],    a = gamma * rsqrt(var + eps),  b = beta - mean * a
//     out = bf16(y)                 or, with silu:  bf16(silu(float(bf16(y))))
//
// with mean and var = E[x^2] - mean^2 per (sample, group) in fp32, as flax
// and the plain version compute them.  The two roundings are the plain
// version's (its addcmul with a bf16 output, then F.silu); only the order in
// which the fp32 statistics are summed differs.
//
// What bounds it on an H100: bytes.  It does no work worth counting per
// element, so the least traffic is x read once and y written once (4 bytes
// an element).  The design reads x twice (6 bytes an element) in two
// launches and keeps everything else off device memory:
//  * x [N, H*W, C] with dense pixel rows and any batch stride; a thread owns
//    8 neighbouring channels (one 16-byte load), a row of C/8 threads covers
//    a pixel, the R rows of a CTA (up to 512 threads) cover R pixels, four
//    loads in flight a thread;
//  * the grid is (CTA of a sample, sample), about four CTAs an SM even at
//    N = 8; a sample's CTAs take its chunks of 4R pixels in turn, so they
//    stream through it side by side;
//  * group_norm_stats_kernel sums per thread in fp32 registers, then over
//    the CTA's rows and the group's channels in shared memory, in a fixed
//    order, and writes one (sum, sum of squares) per group and CTA to a
//    scratch buffer: no atomics, so the result repeats bit for bit;
//  * group_norm_apply_kernel folds its sample's partials per group (in a
//    fixed order), derives its threads' a and b, and streams x to y; a
//    tensor that fits in the 50 MB L2 is read from device memory once.
// Both passes run at 2.6-2.7 TB/s at the serving shapes (PERF.md), so the
// pair reaches about half of the 4-byte bound.  Tried and dropped: 8 loads
// in flight a thread, an L2 prefetch hint, twice the CTAs, contiguous
// per-CTA slabs, the apply pass in reverse order (no better or slower).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define GN_GROUPS 32
#define GN_THREADS 512   // the most threads a CTA takes
#define GN_UNROLL 4      // 16-byte loads in flight a thread
#define GN_MAX_C 2048    // C / 8 threads a pixel, at most GN_THREADS
#define GN_MAX_CTAS 64   // CTAs a sample: the apply pass folds all their partials
#define GN_TARGET_CTAS (4 * 132)

namespace {

struct Geometry {
    int V;      // 16-byte vectors a pixel: threads in a row
    int R;      // rows of a CTA
    int ctas;   // CTAs a sample
};

Geometry geometry(int N, int P, int C) {
    Geometry g;
    g.V = C / 8;
    g.R = GN_THREADS / g.V > 0 ? GN_THREADS / g.V : 1;
    const int want = (GN_TARGET_CTAS + N - 1) / N;
    const int chunks = (P + GN_UNROLL * g.R - 1) / (GN_UNROLL * g.R);
    g.ctas = want < GN_MAX_CTAS ? want : GN_MAX_CTAS;
    if (chunks < g.ctas) g.ctas = chunks;
    return g;
}

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
}

// the two bf16 of a 32-bit word as floats (exact)
__device__ __forceinline__ float lo_f(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ void accumulate(const uint4 q, float* s1, float* s2) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float a = lo_f(w[i]), b = hi_f(w[i]);
        s1[2 * i] += a;
        s2[2 * i] = fmaf(a, a, s2[2 * i]);
        s1[2 * i + 1] += b;
        s2[2 * i + 1] = fmaf(b, b, s2[2 * i + 1]);
    }
}

// bf16(x * a + b), multiplied and added with one rounding each, as the plain
// version's addcmul; then, with silu, bf16(y / (1 + exp(-y))) of that value
__device__ __forceinline__ float affine(float x, float a, float b, int silu) {
    const float y = __bfloat162float(__float2bfloat16_rn(__fadd_rn(__fmul_rn(x, a), b)));
    return silu ? y / (1.0f + expf(-y)) : y;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint4 apply(const uint4 q, const float* a, const float* b, int silu) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
        o[i] = pack(affine(lo_f(w[i]), a[2 * i], b[2 * i], silu),
                    affine(hi_f(w[i]), a[2 * i + 1], b[2 * i + 1], silu));
    return make_uint4(o[0], o[1], o[2], o[3]);
}

}  // namespace

// part [N, ctas, 2, 32]: per (sample, CTA) the sums and sums of squares of
// each group's channels over the CTA's pixels.
extern "C" __global__ void __launch_bounds__(GN_THREADS)
    group_norm_stats_kernel(const __nv_bfloat16* __restrict__ x, long long sN, int P, int C,
                            int V, int R, float* __restrict__ part) {
    __shared__ float red[2][GN_THREADS * 8];  // [sum | sumsq][row][channel]
    const int s = blockIdx.x, n = blockIdx.y, ctas = gridDim.x;
    const int t = threadIdx.x, v = t % V, r = t / V;
    const __nv_bfloat16* xb = x + n * sN + v * 8;
    float s1[8], s2[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) s1[k] = s2[k] = 0.0f;
    // the sample's pixels in chunks of GN_UNROLL * R, chunk i to CTA i % ctas:
    // the CTAs of a sample stream through it side by side
    const int chunk = GN_UNROLL * R;
    for (int c0 = s * chunk; c0 < P; c0 += ctas * chunk) {
        const int p = c0 + r;
        if (c0 + chunk <= P) {
            uint4 q[GN_UNROLL];
#pragma unroll
            for (int u = 0; u < GN_UNROLL; ++u) q[u] = load16(xb + (long long)(p + u * R) * C);
#pragma unroll
            for (int u = 0; u < GN_UNROLL; ++u) accumulate(q[u], s1, s2);
        } else {
            for (int u = 0; u < GN_UNROLL; ++u)
                if (p + u * R < P) accumulate(load16(xb + (long long)(p + u * R) * C), s1, s2);
        }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        red[0][r * C + v * 8 + k] = s1[k];
        red[1][r * C + v * 8 + k] = s2[k];
    }
    __syncthreads();
    // over the rows, in row order, into row 0 (each channel by one thread)
    for (int c = t; c < C; c += blockDim.x) {
        float a = red[0][c], b = red[1][c];
        for (int i = 1; i < R; ++i) {
            a += red[0][i * C + c];
            b += red[1][i * C + c];
        }
        red[0][c] = a;
        red[1][c] = b;
    }
    __syncthreads();
    // over the group's channels, in channel order
    if (t < GN_GROUPS) {
        const int cg = C / GN_GROUPS;
        float a = 0.0f, b = 0.0f;
        for (int c = t * cg; c < (t + 1) * cg; ++c) {
            a += red[0][c];
            b += red[1][c];
        }
        float* out = part + ((long long)n * ctas + s) * 2 * GN_GROUPS;
        out[t] = a;
        out[GN_GROUPS + t] = b;
    }
}

// y [N, P, C] dense; the grid and the pixels of a CTA as in the statistics
// pass.
extern "C" __global__ void __launch_bounds__(GN_THREADS)
    group_norm_apply_kernel(const __nv_bfloat16* __restrict__ x, long long sN,
                            const float* __restrict__ gamma, const float* __restrict__ beta,
                            const float* __restrict__ part, __nv_bfloat16* __restrict__ y, int P,
                            int C, int V, int R, float eps, int silu) {
    __shared__ float fold[2][8][GN_GROUPS];
    __shared__ float mean_s[GN_GROUPS], inv_s[GN_GROUPS];
    const int s = blockIdx.x, n = blockIdx.y, ctas = gridDim.x;
    const int t = threadIdx.x, v = t % V, r = t / V;
    // fold the sample's partials: lane j sums CTAs j, j + J, ... of group g,
    // then the J lanes are summed in lane order
    const int J = min(8, (int)blockDim.x / GN_GROUPS);
    const float* ps = part + (long long)n * ctas * 2 * GN_GROUPS;
    if (t < J * GN_GROUPS) {
        const int g = t % GN_GROUPS, j = t / GN_GROUPS;
        float a = 0.0f, b = 0.0f;
        for (int k = j; k < ctas; k += J) {
            a += ps[k * 2 * GN_GROUPS + g];
            b += ps[k * 2 * GN_GROUPS + GN_GROUPS + g];
        }
        fold[0][j][g] = a;
        fold[1][j][g] = b;
    }
    __syncthreads();
    const int cg = C / GN_GROUPS;
    if (t < GN_GROUPS) {
        float a = 0.0f, b = 0.0f;
        for (int j = 0; j < J; ++j) {
            a += fold[0][j][t];
            b += fold[1][j][t];
        }
        // the plain version's operations, one rounding each
        const float cnt = (float)P * (float)cg;
        const float mean = __fdiv_rn(a, cnt);
        const float var = __fsub_rn(__fdiv_rn(b, cnt), __fmul_rn(mean, mean));
        mean_s[t] = mean;
        inv_s[t] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
    }
    __syncthreads();
    float a[8], b[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const int c = v * 8 + k, g = c / cg;
        a[k] = __fmul_rn(inv_s[g], gamma[c]);
        b[k] = __fsub_rn(beta[c], __fmul_rn(mean_s[g], a[k]));
    }
    const __nv_bfloat16* xb = x + n * sN + v * 8;
    __nv_bfloat16* yb = y + (long long)n * P * C + v * 8;
    const int chunk = GN_UNROLL * R;
    for (int c0 = s * chunk; c0 < P; c0 += ctas * chunk) {
        const int p = c0 + r;
        if (c0 + chunk <= P) {
            uint4 q[GN_UNROLL];
#pragma unroll
            for (int u = 0; u < GN_UNROLL; ++u) q[u] = load16(xb + (long long)(p + u * R) * C);
#pragma unroll
            for (int u = 0; u < GN_UNROLL; ++u)
                *reinterpret_cast<uint4*>(yb + (long long)(p + u * R) * C) =
                    apply(q[u], a, b, silu);
        } else {
            for (int u = 0; u < GN_UNROLL; ++u)
                if (p + u * R < P)
                    *reinterpret_cast<uint4*>(yb + (long long)(p + u * R) * C) =
                        apply(load16(xb + (long long)(p + u * R) * C), a, b, silu);
        }
    }
}

// CTAs a sample: the partials buffer the wrapper allocates is [N, ctas, 2, 32].
extern "C" int group_norm_ctas(int N, int P, int C) { return geometry(N, P, C).ctas; }

// x [N, P, C] bf16, pixel rows dense, batch stride sN elements; gamma, beta
// [C] fp32; y [N, P, C] bf16 dense; part as group_norm_ctas says.  C a
// multiple of 32 up to GN_MAX_C; x, y 16-byte aligned, sN a multiple of 8.
extern "C" int group_norm_silu_launch(const void* x, long long sN, const void* gamma,
                                      const void* beta, void* y, void* part, int N, int P, int C,
                                      float eps, int silu, void* stream) {
    if (N <= 0 || N > 65535 || P <= 0 || C <= 0 || C % GN_GROUPS || C > GN_MAX_C)
        return (int)cudaErrorInvalidValue;
    const Geometry g = geometry(N, P, C);
    const dim3 grid(g.ctas, N);
    const int threads = g.V * g.R;
    cudaStream_t st = (cudaStream_t)stream;
    group_norm_stats_kernel<<<grid, threads, 0, st>>>((const __nv_bfloat16*)x, sN, P, C, g.V,
                                                      g.R, (float*)part);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    group_norm_apply_kernel<<<grid, threads, 0, st>>>(
        (const __nv_bfloat16*)x, sN, (const float*)gamma, (const float*)beta,
        (const float*)part, (__nv_bfloat16*)y, P, C, g.V, g.R, eps, silu);
    return (int)cudaGetLastError();
}
