// Fused nearest-code lookup of the residual quantizer, Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel pgtformer_tpu/ops/pallas_vq.py:nearest_code_pallas
// (_vq_kernel).  For every row x_i of [N, D] it returns
//
//     argmin_j ( |c_j|^2 - 2 x_i . c_j )        over the n codes c_j of [n, D]
//
// the squared distance without the per-row |x_i|^2 term, which does not
// move the argmin.  The [N, n] distance matrix never reaches device memory.
// Products and sums are plain fp32 FMAs (no tensor cores: TF32 or bf16
// operands would move near-ties), and the lowest index wins a tie, as
// argmin does.
//
// What bounds it on an H100: 2*N*n*D FLOP of fp32 FMA against (N + n)*D*4
// bytes: 25.8 GFLOP vs 52 MB at the deployed shape (N=24576, n=1024,
// D=512), bound by operations at the 67 TFLOP/s non-tensor fp32 peak.
//
// The TPU kernel keeps the whole codebook (2 MB) in VMEM and streams row
// blocks past it.  Here a CTA of 128 threads owns 64 rows and walks the
// codebook in tiles of 128 codes, 32-deep slices at a time:
//  * each thread holds an 8 x 8 block of products (rows ty + 8i, codes
//    tx + 16j) in registers: per 4 of depth, 8 + 8 sixteen-byte
//    shared-memory loads feed 256 FMAs;
//  * the x and code slices are staged row-major (row stride 36 floats, so
//    the 16 code rows a half-warp reads fall in distinct bank groups) by
//    16-byte cp.async into two buffers: slice s+1 is in flight while slice
//    s multiplies.  The (tile, slice) steps form one sequence, so the
//    pipeline does not drain at a tile boundary.  Rows, codes and depth past
//    the arrays are zero-filled by the copy itself;
//  * 128 threads, <= 168 registers (the depth loop unrolled by two, not
//    eight: fully unrolled it spilled) and 54 KB of shared memory keep three
//    CTAs resident per SM: the 384 CTAs of the deployed shape fill the 132
//    SMs in one wave;
//  * a finished code tile is folded into a running (min, index) per row in
//    ascending code order with a strict `<`, and the 16 threads that share a
//    row (16 consecutive lanes) are reduced at the end by shuffles that
//    prefer the lower index on equal distance: the first minimum.  Each
//    product sums over the depth in ascending order, as before.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define VQ_BM 64        // rows per CTA
#define VQ_BN 128       // codes per tile
#define VQ_BK 32        // depth of one staged slice
#define VQ_THREADS 128  // 8 row groups x 16 code groups
#define VQ_LDS (VQ_BK + 4)

// csq[j] = |c_j|^2, one warp per code.
__global__ void code_sqnorm_kernel(const float* codes, float* csq, int n, int D) {
    const int j = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (j >= n) return;
    const float* row = codes + (long long)j * D;
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s = fmaf(row[d], row[d], s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) csq[j] = s;
}

// 16-byte asynchronous copy; an invalid source fills the 16 bytes with zero.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows [r0, r0 + ROWS) x depth [k0, k0 + VQ_BK) of src [R, D] into dst
// row-major (dst[r * VQ_LDS + k]).  Word group e = tid + VQ_THREADS * i is
// (row e/G, depth 4*(e%G)), G = VQ_BK/4: G lanes read one row's 4*VQ_BK
// contiguous bytes.
template <int ROWS>
__device__ __forceinline__ void stage(float* dst, const float* src, int r0, int R, int k0, int D,
                                      int tid) {
    constexpr int G = VQ_BK / 4;
#pragma unroll
    for (int i = 0; i < ROWS * G / VQ_THREADS; ++i) {
        const unsigned e = tid + VQ_THREADS * i;
        const int r = e / G, k = e % G * 4;
        const bool valid = r0 + r < R && k0 + k < D;
        cp_async16(dst + r * VQ_LDS + k, valid ? src + (long long)(r0 + r) * D + k0 + k : src,
                   valid);
    }
}

struct VQSmem {
    float xs[2][VQ_BM * VQ_LDS];
    float cs[2][VQ_BN * VQ_LDS];
};

__global__ void __launch_bounds__(VQ_THREADS, 3)
vq_nearest_kernel(const float* x, const float* codes, const float* csq, long long* out, int N,
                  int n, int D) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    VQSmem& sm = *reinterpret_cast<VQSmem*>(smem_raw);
    const int tid = threadIdx.x;
    const int tx = tid & 15;  // codes tx + 16j of a tile
    const int ty = tid >> 4;  // rows ty + 8i of the CTA
    const int row0 = blockIdx.x * VQ_BM;
    const int nks = (D + VQ_BK - 1) / VQ_BK;
    const int ntiles = (n + VQ_BN - 1) / VQ_BN;
    const int steps = nks * ntiles;

    float best[8];
    int besti[8];
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        best[i] = INFINITY;
        besti[i] = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }

    // step s stages code tile s / nks at depth (s % nks) * VQ_BK into buffer s & 1
    auto issue = [&](int s) {
        const int b = s & 1;
        const int c0 = (s / nks) * VQ_BN, k0 = (s % nks) * VQ_BK;
        stage<VQ_BM>(sm.xs[b], x, row0, N, k0, D, tid);
        stage<VQ_BN>(sm.cs[b], codes, c0, n, k0, D, tid);
        cp_async_commit();
    };

    issue(0);
    for (int s = 0; s < steps; ++s) {
        if (s + 1 < steps) {
            issue(s + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const float* xs = sm.xs[s & 1] + ty * VQ_LDS;
        const float* cs = sm.cs[s & 1] + tx * VQ_LDS;
        // unrolled by two: fully unrolled, the depth loop spilled at the
        // 168-register cap
#pragma unroll 2
        for (int kq = 0; kq < VQ_BK; kq += 4) {
            float4 a[8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
                a[i] = *reinterpret_cast<const float4*>(xs + 8 * i * VQ_LDS + kq);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const float4 b = *reinterpret_cast<const float4*>(cs + 16 * j * VQ_LDS + kq);
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    float t = fmaf(a[i].x, b.x, acc[i][j]);
                    t = fmaf(a[i].y, b.y, t);
                    t = fmaf(a[i].z, b.z, t);
                    acc[i][j] = fmaf(a[i].w, b.w, t);
                }
            }
        }
        if (s % nks == nks - 1) {
            // fold this tile in, ascending code index, strict `<`: first minimum
            const int c0 = (s / nks) * VQ_BN;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int jj = c0 + tx + 16 * j;
                const float cq = jj < n ? csq[jj] : INFINITY;
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const float d = cq - 2.0f * acc[i][j];
                    if (jj < n && d < best[i]) {
                        best[i] = d;
                        besti[i] = jj;
                    }
                    acc[i][j] = 0.f;
                }
            }
        }
        __syncthreads();  // buffer s & 1 is refilled by step s + 2
    }

    // the 16 threads of a row group are 16 consecutive lanes of one warp
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) {
            const float od = __shfl_xor_sync(0xffffffffu, best[i], o);
            const int oi = __shfl_xor_sync(0xffffffffu, besti[i], o);
            if (od < best[i] || (od == best[i] && oi < besti[i])) {
                best[i] = od;
                besti[i] = oi;
            }
        }
        const int row = row0 + ty + 8 * i;
        if (tx == 0 && row < N) out[row] = (long long)besti[i];
    }
}

// Plain C entry point (loaded with ctypes).  x [N, D] and codes [n, D] are
// contiguous fp32 device arrays with 16-byte aligned rows (D % 4 == 0), csq
// is fp32 scratch of n values, out receives N int64 indices.  Returns a
// cudaError_t code (0 on success).
extern "C" int vq_nearest_launch(const void* x, const void* codes, void* csq, void* out, int N,
                                 int n, int D, void* stream) {
    if (N <= 0 || n <= 0 || D <= 0 || D % 4) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int warps_per_block = 8;
    code_sqnorm_kernel<<<(n + warps_per_block - 1) / warps_per_block, warps_per_block * 32, 0,
                         s>>>((const float*)codes, (float*)csq, n, D);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int smem = (int)sizeof(VQSmem);
    e = cudaFuncSetAttribute(vq_nearest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    vq_nearest_kernel<<<(N + VQ_BM - 1) / VQ_BM, VQ_THREADS, smem, s>>>(
        (const float*)x, (const float*)codes, (const float*)csq, (long long*)out, N, n, D);
    return (int)cudaGetLastError();
}
