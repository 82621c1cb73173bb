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
// The TPU kernel keeps the whole codebook (2 MB at 1024 x 512) in VMEM and
// streams 1024-row blocks past it.  An SM has 227 KB of shared memory, so
// here a CTA owns 64 rows and walks the codebook in tiles of 128 codes,
// staging 16-deep slices of both operands in shared memory (k-major, so the
// inner loop reads float4s).  Each thread holds a 4 x 8 block of products in
// registers and a running (min, index) for its 4 rows; a code tile is folded
// into it with a strict `<` in ascending index order, and the 16 threads
// that share a row are reduced at the end by shuffles that prefer the lower
// index on equal distance.
//
// What bounds it on an H100: 2*N*n*D FLOP of fp32 FMA against (N + n)*D*4
// bytes: 25.8 GFLOP vs 52 MB at the deployed shape, bound by operations at
// the 67 TFLOP/s non-tensor fp32 peak.  This version does 32 FMAs for
// three 16-byte shared-memory loads per thread and k step and re-reads each
// x slice once per code tile from L2; double-buffered cp.async staging and a
// larger register tile are left to a later version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define VQ_BM 64        // rows per CTA
#define VQ_BN 128       // codes per tile
#define VQ_BK 16        // depth of one staged slice
#define VQ_THREADS 256  // 16 row groups x 16 code groups
#define VQ_LDX (VQ_BM + 4)
#define VQ_LDC (VQ_BN + 4)

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

// Stage rows [r0, r0+rows) x depth [k0, k0+VQ_BK) of src [R, D] into dst
// k-major (dst[k][r]); rows past R and depth past D are zero.
__device__ __forceinline__ void stage(float* dst, int ld, const float* src, int r0, int R,
                                      int k0, int D, int lr, int lk) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + lr < R && k0 + lk < D)
        v = *reinterpret_cast<const float4*>(src + (long long)(r0 + lr) * D + k0 + lk);
    dst[(lk + 0) * ld + lr] = v.x;
    dst[(lk + 1) * ld + lr] = v.y;
    dst[(lk + 2) * ld + lr] = v.z;
    dst[(lk + 3) * ld + lr] = v.w;
}

__global__ void __launch_bounds__(VQ_THREADS)
vq_nearest_kernel(const float* x, const float* codes, const float* csq, long long* out, int N,
                  int n, int D) {
    __shared__ __align__(16) float xs[VQ_BK * VQ_LDX];
    __shared__ __align__(16) float cs[VQ_BK * VQ_LDC];
    const int tid = threadIdx.x;
    const int tx = tid & 15;  // codes tx*4..+3 and 64+tx*4..+3 of a tile
    const int ty = tid >> 4;  // rows ty*4..+3 of the CTA
    const int lr = tid >> 2;  // staging: row within 64
    const int lk = (tid & 3) * 4;
    const int row0 = blockIdx.x * VQ_BM;

    float best[4];
    int besti[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        best[i] = INFINITY;
        besti[i] = 0;
    }

    for (int c0 = 0; c0 < n; c0 += VQ_BN) {
        float acc[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

        for (int k0 = 0; k0 < D; k0 += VQ_BK) {
            stage(xs, VQ_LDX, x, row0, N, k0, D, lr, lk);
            stage(cs, VQ_LDC, codes, c0, n, k0, D, lr, lk);
            stage(cs + 64, VQ_LDC, codes, c0 + 64, n, k0, D, lr, lk);
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < VQ_BK; ++kk) {
                const float4 a = *reinterpret_cast<const float4*>(xs + kk * VQ_LDX + ty * 4);
                const float4 b0 = *reinterpret_cast<const float4*>(cs + kk * VQ_LDC + tx * 4);
                const float4 b1 =
                    *reinterpret_cast<const float4*>(cs + kk * VQ_LDC + 64 + tx * 4);
                const float av[4] = {a.x, a.y, a.z, a.w};
                const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
            }
            __syncthreads();
        }

        // fold this tile in, ascending code index, strict `<`: first minimum
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int jj = c0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
            if (jj < n) {
                const float cq = csq[jj];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float d = cq - 2.0f * acc[i][j];
                    if (d < best[i]) {
                        best[i] = d;
                        besti[i] = jj;
                    }
                }
            }
        }
    }

    // the 16 threads of a row group are 16 consecutive lanes of one warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) {
            const float od = __shfl_xor_sync(0xffffffffu, best[i], o);
            const int oi = __shfl_xor_sync(0xffffffffu, besti[i], o);
            if (od < best[i] || (od == best[i] && oi < besti[i])) {
                best[i] = od;
                besti[i] = oi;
            }
        }
        const int row = row0 + ty * 4 + i;
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
    vq_nearest_kernel<<<(N + VQ_BM - 1) / VQ_BM, VQ_THREADS, 0, s>>>(
        (const float*)x, (const float*)codes, (const float*)csq, (long long*)out, N, n, D);
    return (int)cudaGetLastError();
}
