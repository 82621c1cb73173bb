// Dense multi-head attention for the code transformer, Hopper (sm_90a), bf16.
//
// Replaces the TPU kernel pgtformer_tpu/ops/flash_attn.py:_dense_mha_pallas
// (reached through dense_mha(layout="bhnd")), and reads the heads-minor
// layout of _dense_mha_pallas_bnhd as well: q, k, v and the output are
// addressed through (batch, row) strides with head h at columns h*D, so the
// packed [B, N, 2C] / [B, N, C] projections are read in place and no head
// transpose is ever materialized.
//
//     out = softmax(q * scale . k^T) . v      (scale folded into q)
//
// The TPU kernel holds one head's whole K/V (768 KB at N=3072) in VMEM and
// runs a single-pass softmax.  A Hopper SM has 227 KB of shared memory, so
// this kernel runs an online softmax over 64-key tiles: one CTA per
// (batch, head, 64-row query tile), K/V tiles staged in shared memory, fp32
// scores, running max and sum in fp32, unnormalized probabilities cast to
// bf16 before the PV product (as the TPU kernel does), an fp32 output
// accumulator normalized once at the end.
//
// What bounds it on an H100: 4*N^2*D FLOP per (batch, head) against
// 4*N*D*2 bytes of q/k/v/out, i.e. ~N/2 = 1536 FLOP/byte at N=3072: compute
// bound.  This first version feeds the tensor cores with nvcuda::wmma
// 16x16x16 fragments from shared memory and rescales the output through
// shared memory, so it runs well below the bf16 peak; wgmma with the
// accumulator in registers and TMA K/V pipelining are left to a later
// version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#define BQ 64
#define BK 64
#define MHA_THREADS 128

struct MhaArgs {
    const bf16* q;
    const bf16* k;
    const bf16* v;
    bf16* o;
    int N;
    long long q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn;
    float scale;
};

// Copy rows [row0, row0+64) x [0, D) of one head into a shared tile with row
// stride ld; rows past N are zero.  With `scale` != 1 each value becomes
// bf16(float(v) * scale).
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* base, long long sn,
                                          int row0, int N, float scale) {
    const int chunks = D / 8;
    for (int idx = threadIdx.x; idx < BQ * chunks; idx += MHA_THREADS) {
        int r = idx / chunks, ch = idx - (idx / chunks) * chunks;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + r < N) {
            val = *reinterpret_cast<const uint4*>(base + (long long)(row0 + r) * sn + ch * 8);
            if (scale != 1.0f) {
                __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    float2 f = __bfloat1622float2(h[i]);
                    h[i] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
                }
            }
        }
        *reinterpret_cast<uint4*>(dst + r * ld + ch * 8) = val;
    }
}

template <int D>
__global__ void __launch_bounds__(MHA_THREADS) dense_mha_kernel(MhaArgs a) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int LD = D + 8;      // bf16 q/k/v tile stride
    const int LDS = BK + 4;    // fp32 score / PV staging stride
    const int LDP = BK + 8;    // bf16 probability stride
    const int LDO = D + 4;     // fp32 output accumulator stride
    bf16* qs = reinterpret_cast<bf16*>(smem);
    bf16* ks = qs + BQ * LD;
    bf16* vs = ks + BK * LD;
    float* ss = reinterpret_cast<float*>(vs + BK * LD);
    bf16* ps = reinterpret_cast<bf16*>(ss + BQ * LDS);
    float* os = reinterpret_cast<float*>(ps + BQ * LDP);
    float* m_s = os + BQ * LDO;
    float* l_s = m_s + BQ;
    float* c_s = l_s + BQ;

    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
    const int N = a.N;
    const bf16* qb = a.q + b * a.q_sb + h * D;
    const bf16* kb = a.k + b * a.k_sb + h * D;
    const bf16* vb = a.v + b * a.v_sb + h * D;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wr0 = warp * 16;

    for (int i = threadIdx.x; i < BQ * LDO; i += MHA_THREADS) os[i] = 0.f;
    for (int i = threadIdx.x; i < BQ; i += MHA_THREADS) {
        m_s[i] = -INFINITY;
        l_s[i] = 0.f;
    }
    load_tile<D>(qs, LD, qb, a.q_sn, q0, N, a.scale);

    for (int kt = 0; kt < N; kt += BK) {
        __syncthreads();  // every warp is done with the previous K/V tile
        load_tile<D>(ks, LD, kb, a.k_sn, kt, N, 1.0f);
        load_tile<D>(vs, LD, vb, a.v_sn, kt, N, 1.0f);
        __syncthreads();

        // S = q_w k^T for this warp's 16 query rows
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
            wmma::fill_fragment(acc, 0.0f);
#pragma unroll
            for (int k0 = 0; k0 < D; k0 += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
                wmma::load_matrix_sync(fa, qs + wr0 * LD + k0, LD);
                wmma::load_matrix_sync(fb, ks + j * 16 * LD + k0, LD);
                wmma::mma_sync(acc, fa, fb, acc);
            }
            wmma::store_matrix_sync(ss + wr0 * LDS + j * 16, acc, LDS, wmma::mem_row_major);
        }
        __syncwarp();

        // online softmax: two lanes per row, 32 columns each
        {
            const int row = wr0 + (lane >> 1), c0 = (lane & 1) * 32;
            const int valid = N - kt;
            float vals[32];
            float mx = -INFINITY;
#pragma unroll
            for (int c = 0; c < 32; ++c) {
                float s = (c0 + c < valid) ? ss[row * LDS + c0 + c] : -INFINITY;
                vals[c] = s;
                mx = fmaxf(mx, s);
            }
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            const float m_old = m_s[row];
            const float m_new = fmaxf(m_old, mx);
            const float corr = __expf(m_old - m_new);
            float sum = 0.f;
#pragma unroll
            for (int c = 0; c < 32; ++c) {
                float p = __expf(vals[c] - m_new);
                sum += p;
                ps[row * LDP + c0 + c] = __float2bfloat16(p);
            }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            __syncwarp();
            if ((lane & 1) == 0) {
                m_s[row] = m_new;
                l_s[row] = l_s[row] * corr + sum;
                c_s[row] = corr;
            }
        }
        __syncwarp();

        // PV for this tile, staged through the (consumed) score rows
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
            wmma::fill_fragment(acc, 0.0f);
#pragma unroll
            for (int k0 = 0; k0 < BK; k0 += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
                wmma::load_matrix_sync(fa, ps + wr0 * LDP + k0, LDP);
                wmma::load_matrix_sync(fb, vs + k0 * LD + j * 16, LD);
                wmma::mma_sync(acc, fa, fb, acc);
            }
            wmma::store_matrix_sync(ss + wr0 * LDS + j * 16, acc, LDS, wmma::mem_row_major);
        }
        __syncwarp();
        for (int e = lane; e < 16 * D; e += 32) {
            int r = wr0 + e / D, c = e % D;
            os[r * LDO + c] = os[r * LDO + c] * c_s[r] + ss[r * LDS + c];
        }
        __syncwarp();
    }

    bf16* ob = a.o + b * a.o_sb + h * D;
    for (int e = lane; e < 16 * (D / 2); e += 32) {
        int r = wr0 + e / (D / 2), c = (e % (D / 2)) * 2;
        if (q0 + r >= N) continue;
        float inv = 1.0f / l_s[r];
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)(q0 + r) * a.o_sn + c) =
            __floats2bfloat162_rn(os[r * LDO + c] * inv, os[r * LDO + c + 1] * inv);
    }
}

template <int D>
static int launch(MhaArgs a, int B, int H, cudaStream_t stream) {
    const int smem = (BQ * (D + 8) * 3) * 2 + BQ * (BK + 4) * 4 + BQ * (BK + 8) * 2 +
                     BQ * (D + 4) * 4 + 3 * BQ * 4;
    cudaError_t e = cudaFuncSetAttribute(dense_mha_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((a.N + BQ - 1) / BQ, H, B);
    dense_mha_kernel<D><<<grid, MHA_THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

// Plain C entry point (loaded with ctypes).  q/k/v/o are device pointers to
// head 0 of batch 0; *_sb and *_sn are the batch and row strides in
// elements; head h lives at columns [h*D, (h+1)*D).  Returns a cudaError_t
// code (0 on success).
extern "C" int dense_mha_launch(const void* q, const void* k, const void* v, void* o, int B,
                                int H, int N, int D, long long q_sb, long long q_sn,
                                long long k_sb, long long k_sn, long long v_sb, long long v_sn,
                                long long o_sb, long long o_sn, float scale, void* stream) {
    MhaArgs a;
    a.q = (const bf16*)q;
    a.k = (const bf16*)k;
    a.v = (const bf16*)v;
    a.o = (bf16*)o;
    a.N = N;
    a.q_sb = q_sb;
    a.q_sn = q_sn;
    a.k_sb = k_sb;
    a.k_sn = k_sn;
    a.v_sb = v_sb;
    a.v_sn = v_sn;
    a.o_sb = o_sb;
    a.o_sn = o_sn;
    a.scale = scale;
    cudaStream_t s = (cudaStream_t)stream;
    switch (D) {
        case 16: return launch<16>(a, B, H, s);
        case 32: return launch<32>(a, B, H, s);
        case 64: return launch<64>(a, B, H, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
