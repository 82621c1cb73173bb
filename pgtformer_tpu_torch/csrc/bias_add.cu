// A conv's per-channel bias, and optionally a residual, added in one dense
// pass over a channels-last bf16 tensor, Hopper (sm_90a).
//
// Replaces no TPU kernel: on the TPU, XLA fuses the JAX package's conv bias
// into the conv and the residual add into the ops around it.  On the card
// ATen runs every biased conv as cuDNN without its bias, then
// `output.add_(bias.reshape(1, C, 1, 1))`; that add broadcasts along batch,
// height and width, so TensorIterator cannot treat it as dense and sends it
// to its strided legacy kernel (elementwise_kernel<128, 4>), which computes
// every element's offsets and moves about 1.35 TB/s.  A residual add on
// the conv's output (`x + h`) is one more pass and one more activation.
//
//     y = bf16(h + b[c])                  (bias_add_kernel)
//     y = bf16(r + bf16(h + b[c]))        (bias_residual_add_kernel)
//
// in place over h, each sum in fp32 and rounded once, as ATen's add_ and
// then its `x + h` round: the result is bit-equal to that chain.  A bias
// given in fp32 is rounded to bf16 first, as the port's fp32-weight convs
// round it before the add.
//
// What bounds it on an H100: bytes (h read and written, r read: 4 or 6
// bytes an element, no work worth counting).  The design streams:
//  * h [N, P*C] with each sample's P*C elements dense and any batch stride;
//    a thread owns 8 neighbouring elements (one 16-byte load of h, one of
//    r, one 16-byte store), four vectors in flight a thread;
//  * the bias lives in shared memory as fp32 (already rounded to bf16), read
//    8 channels at a time where C is a multiple of 8 and channel by channel,
//    wrapping, where it is not (the 3-channel output convs);
//  * the grid is (CTA of a sample, sample), about one wave of 8 CTAs an SM
//    over all samples; a sample's CTAs take its chunks in turn.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BA_THREADS 256
#define BA_UNROLL 4       // 16-byte vectors in flight a thread
#define BA_MAX_C 4096     // channels the shared bias holds
#define BA_TARGET_CTAS (8 * 132)

namespace {

__device__ __forceinline__ float lo_f(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ float round_bf16(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

// the bias of the 8 elements from element e0 of a sample (channel e0 % C)
__device__ __forceinline__ void bias8(const float* sb, int e0, int C, float* b) {
    int c = e0 % C;
    if (C % 8 == 0) {
        const float4 p = *reinterpret_cast<const float4*>(sb + c);
        const float4 q = *reinterpret_cast<const float4*>(sb + c + 4);
        b[0] = p.x; b[1] = p.y; b[2] = p.z; b[3] = p.w;
        b[4] = q.x; b[5] = q.y; b[6] = q.z; b[7] = q.w;
    } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            b[k] = sb[c];
            c = c + 1 == C ? 0 : c + 1;
        }
    }
}

template <bool kResidual>
__device__ __forceinline__ uint4 combine(uint4 h, uint4 r, const float* b) {
    const uint32_t wh[4] = {h.x, h.y, h.z, h.w};
    const uint32_t wr[4] = {r.x, r.y, r.z, r.w};
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        float lo = round_bf16(__fadd_rn(lo_f(wh[i]), b[2 * i]));
        float hi = round_bf16(__fadd_rn(hi_f(wh[i]), b[2 * i + 1]));
        if (kResidual) {
            lo = __fadd_rn(lo_f(wr[i]), lo);
            hi = __fadd_rn(hi_f(wr[i]), hi);
        }
        o[i] = pack(lo, hi);
    }
    return make_uint4(o[0], o[1], o[2], o[3]);
}

template <bool kResidual>
__device__ __forceinline__ void run(__nv_bfloat16* h, long long sH, const void* bias, int bias_f32,
                                    const __nv_bfloat16* __restrict__ r, long long sR, int E,
                                    int C) {
    __shared__ __align__(16) float sb[BA_MAX_C];
    for (int c = threadIdx.x; c < C; c += blockDim.x)
        sb[c] = bias_f32 ? round_bf16(static_cast<const float*>(bias)[c])
                         : __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[c]);
    __syncthreads();
    const int n = blockIdx.y;
    uint4* hv = reinterpret_cast<uint4*>(h + n * sH);
    const uint4* rv = kResidual ? reinterpret_cast<const uint4*>(r + n * sR) : nullptr;
    const int vecs = E / 8;
    const int chunk = BA_UNROLL * BA_THREADS;
    for (int v0 = blockIdx.x * chunk + threadIdx.x; v0 < vecs; v0 += gridDim.x * chunk) {
        uint4 qh[BA_UNROLL], qr[BA_UNROLL];
#pragma unroll
        for (int u = 0; u < BA_UNROLL; ++u) {
            const int v = v0 + u * BA_THREADS;
            if (v < vecs) {
                qh[u] = hv[v];
                if (kResidual) qr[u] = __ldg(rv + v);
            }
        }
#pragma unroll
        for (int u = 0; u < BA_UNROLL; ++u) {
            const int v = v0 + u * BA_THREADS;
            if (v < vecs) {
                float b[8];
                bias8(sb, v * 8, C, b);
                hv[v] = combine<kResidual>(qh[u], kResidual ? qr[u] : qh[u], b);
            }
        }
    }
}

}  // namespace

// h [N, E] bf16 in place (each sample's E elements dense, batch stride sH);
// bias [C] bf16 or fp32, channel = element index % C.
extern "C" __global__ void __launch_bounds__(BA_THREADS)
    bias_add_kernel(__nv_bfloat16* h, long long sH, const void* bias, int bias_f32, int E,
                    int C) {
    run<false>(h, sH, bias, bias_f32, nullptr, 0, E, C);
}

// as bias_add_kernel, then r [N, E] bf16 (batch stride sR) added.
extern "C" __global__ void __launch_bounds__(BA_THREADS)
    bias_residual_add_kernel(__nv_bfloat16* h, long long sH, const void* bias, int bias_f32,
                             const __nv_bfloat16* __restrict__ r, long long sR, int E, int C) {
    run<true>(h, sH, bias, bias_f32, r, sR, E, C);
}

// h, r 16-byte aligned, sH, sR and E multiples of 8, E < 2^31, C at most
// BA_MAX_C; r null for the bias alone.
extern "C" int bias_add_launch(void* h, long long sH, const void* bias, int bias_f32,
                               const void* r, long long sR, int N, int E, int C, void* stream) {
    if (N <= 0 || N > 65535 || E <= 0 || E % 8 || C <= 0 || C > BA_MAX_C)
        return (int)cudaErrorInvalidValue;
    const int chunk = BA_UNROLL * BA_THREADS;
    const int want = (BA_TARGET_CTAS + N - 1) / N;
    const int chunks = (E / 8 + chunk - 1) / chunk;
    const dim3 grid(chunks < want ? chunks : want, N);
    cudaStream_t st = (cudaStream_t)stream;
    if (r == nullptr)
        bias_add_kernel<<<grid, BA_THREADS, 0, st>>>((__nv_bfloat16*)h, sH, bias, bias_f32, E, C);
    else
        bias_residual_add_kernel<<<grid, BA_THREADS, 0, st>>>(
            (__nv_bfloat16*)h, sH, bias, bias_f32, (const __nv_bfloat16*)r, sR, E, C);
    return (int)cudaGetLastError();
}
