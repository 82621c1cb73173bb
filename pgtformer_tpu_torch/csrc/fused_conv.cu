// Fused GroupNorm-affine + SiLU + conv3x3 chain of the decoder's per-frame
// tail, Hopper (sm_90a), bf16 operands, fp32 accumulation.
//
// Replaces the TPU kernels of pgtformer_tpu/ops/pallas_conv.py:
//   gn_silu_conv3x3      (_gsc_kernel)  -> gn_silu_conv3x3_kernel
//   subpixel_up_conv3x3  (_sub_kernel)  -> subpixel_up_conv3x3_kernel
//
// gn_silu_conv3x3:  out = conv3x3(silu(x*a + b)) + bias [+ xs @ sk + sb] [+ res]
//   x [N,H,W,C] bf16 (batch stride given), a/b [N,C] fp32 (null: plain conv),
//   k [3,3,C,64] bf16, xs [N,H,W,Cs] bf16, sk [Cs,64] bf16, res [N,H,W,64]
//   bf16.  The affine and SiLU run in fp32 and round to bf16; the conv's zero
//   padding applies AFTER the activation (silu(b) != 0), in rows and columns;
//   taps, bias, shortcut and residual add in fp32 and round once.
// subpixel_up_conv3x3:  out = conv3x3(nearest_up2(x)) + bias as four 2x2 phase
//   convs: out[n, 2r+a, 2w+b] = bias + sum_{u,v} xpad[r+a+u, w+b+v] @ k2[a,b,u,v]
//   with k2 [2,2,2,2,C,C] bf16 (pre-summed by the caller), written interleaved.
// Both can emit per-(sample, channel) (sum, sum of squares) of their ROUNDED
// bf16 output, the statistics of the next GroupNorm in the chain.
//
// The TPU kernels walk row blocks in grid order, carry the top halo row in
// scratch memory and accumulate the statistics across grid steps.  A CUDA
// grid has no order, so here every CTA stages its own pixel tile with a
// one-pixel halo on all four sides, and writes its tile's partial statistics
// to part[n][tile][2][C]; the caller sums over tiles (no atomics: the result
// does not change from run to run).
//
// Both are implicit GEMMs on the tensor cores (wmma 16x16x16): one M-tile is a
// row of 16 pixels, whose A operand for tap (di, dj) is the staged tile
// shifted by (di, dj) pixels: no im2col copy.  A staged pixel is padded by
// 16 channels, which keeps every shifted fragment pointer 32-byte aligned.
//
//  * gn_silu_conv3x3: the whole 3x3 kernel (147 KB at C=128, 74 KB at C=64)
//    and the 1x1 shortcut stay in shared memory of a persistent CTA (one per
//    SM) that walks TH x 16 pixel tiles; each of 8 warps owns TH/8 rows x 64
//    output channels.  A tile's raw pixels travel through registers: the
//    loads of the next tile are started before this tile's MMAs.
//  * subpixel_up_conv3x3: the sixteen C x C matrices do not fit (0.5 to 8 MB),
//    so a CTA owns 8 x 16 input pixels x 64 output channels and loops over
//    32-channel slices of the input, copying the next slice of x and of all
//    sixteen matrices (cp.async, two stage buffers) while it multiplies the
//    current one.  A warp owns one row phase of two rows: 2 column phases x
//    2 rows x 4 N-tiles of accumulators, so a B fragment feeds two MMAs and a
//    shifted A fragment both column phases that use it.
//
// What bounds them on an H100: at 512x512 x 8 frames the 128->64 conv and the
// upsample are bound by operations (3.1e11 / 2.7e11 FLOP against 0.8 / 0.7 GB),
// the 64->64 forms by bytes.  Both sit well above their bounds: with 8 warps
// per SM the wmma fragments come from shared memory with little latency
// hidden (the 32-byte pixel pitch also costs a 2-way bank conflict on every A
// fragment), and in gn_silu_conv3x3 activation, MMAs and epilogue of a tile
// run one after the other.  wgmma with operands read from shared memory, TMA
// and a ring of tiles are left to a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#define FC_THREADS 256
#define FC_WARPS 8
#define FC_TW 16          // tile width in pixels: one M-tile is a row of 16 pixels
#define FC_TWH (FC_TW + 2)
#define FC_PAD 16         // channel padding of a staged pixel (32 bytes)
#define FC_CO 64          // output channels per CTA
#define FC_LDW (FC_CO + 8)  // pitch of a staged [rows][64] weight matrix
#define FC_SMEM_MAX 232448

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> AFrag;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> BFrag;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy `rows` rows of 64 bf16 (row pitch src_pitch elements) to dst (pitch
// FC_LDW), asynchronously.
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, long long src_pitch,
                                           int rows, int tid) {
    for (int idx = tid; idx < rows * 8; idx += FC_THREADS) {
        const int r = idx >> 3, v = idx & 7;
        cp_async16(dst + r * FC_LDW + v * 8, src + r * src_pitch + v * 8);
    }
}

// silu(x*a + b) on 8 packed bf16 values, in fp32, rounded to bf16.
__device__ __forceinline__ uint4 affine_silu8(uint4 val, const float* a, const float* b) {
    const float4 a0 = __ldg(reinterpret_cast<const float4*>(a));
    const float4 a1 = __ldg(reinterpret_cast<const float4*>(a) + 1);
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(b));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(b) + 1);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(p[j]);
        float y0 = fmaf(f.x, av[2 * j], bv[2 * j]);
        float y1 = fmaf(f.y, av[2 * j + 1], bv[2 * j + 1]);
        y0 = __fdividef(y0, 1.0f + __expf(-y0));
        y1 = __fdividef(y1, 1.0f + __expf(-y1));
        p[j] = __floats2bfloat162_rn(y0, y1);
    }
    return val;
}

// One 16-pixel x 16-channel accumulator tile: add bias (and the residual),
// round to bf16, store the pixels that lie inside the image, and return this
// lane's share of the statistics of the rounded values: lanes 0-15 the sum of
// channel (lane & 15) over the 16 pixels, lanes 16-31 the sum of squares.
// stg is this warp's 16x16 fp32 staging tile.  Pixel i of the tile goes to
// out_pix0 + i * out_step (elements); valid_w pixels are inside the image.
__device__ __forceinline__ float epilogue16(const AccFrag& acc, float* stg, int lane,
                                            const float* bias, const float* bias2,
                                            const bf16* res_pix0, bf16* out_pix0,
                                            long long out_step, int valid_w, bool want_stats) {
    wmma::store_matrix_sync(stg, acc, 16, wmma::mem_row_major);
    __syncwarp();
    const int i = lane >> 1, c8 = (lane & 1) * 8;
    float* mine = stg + i * 16 + c8;
    float v[8];
    if (i < valid_w) {
        const float4 s0 = *reinterpret_cast<const float4*>(mine);
        const float4 s1 = *reinterpret_cast<const float4*>(mine + 4);
        const float4 g0 = __ldg(reinterpret_cast<const float4*>(bias + c8));
        const float4 g1 = __ldg(reinterpret_cast<const float4*>(bias + c8) + 1);
        v[0] = s0.x + g0.x; v[1] = s0.y + g0.y; v[2] = s0.z + g0.z; v[3] = s0.w + g0.w;
        v[4] = s1.x + g1.x; v[5] = s1.y + g1.y; v[6] = s1.z + g1.z; v[7] = s1.w + g1.w;
        if (bias2 != nullptr) {
            const float4 h0 = __ldg(reinterpret_cast<const float4*>(bias2 + c8));
            const float4 h1 = __ldg(reinterpret_cast<const float4*>(bias2 + c8) + 1);
            v[0] += h0.x; v[1] += h0.y; v[2] += h0.z; v[3] += h0.w;
            v[4] += h1.x; v[5] += h1.y; v[6] += h1.z; v[7] += h1.w;
        }
        if (res_pix0 != nullptr) {
            const uint4 r = *reinterpret_cast<const uint4*>(res_pix0 + i * out_step + c8);
            const __nv_bfloat162* rp = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float2 f = __bfloat1622float2(rp[j]);
                v[2 * j] += f.x;
                v[2 * j + 1] += f.y;
            }
        }
        uint4 o;
        __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            op[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
            const float2 f = __bfloat1622float2(op[j]);
            v[2 * j] = f.x;
            v[2 * j + 1] = f.y;
        }
        *reinterpret_cast<uint4*>(out_pix0 + i * out_step + c8) = o;
    } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.0f;
    }
    float s = 0.0f;
    if (want_stats) {
        *reinterpret_cast<float4*>(mine) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(mine + 4) = make_float4(v[4], v[5], v[6], v[7]);
        __syncwarp();
        const int col = lane & 15;
        const bool sq = lane >= 16;
#pragma unroll
        for (int r = 0; r < 16; ++r) {
            const float q = stg[r * 16 + col];
            s += sq ? q * q : q;
        }
    }
    __syncwarp();
    return s;
}

// Sum the warps' statistics of one tile in a fixed order and write them to
// part[2][ldc] at channel offset c0.  wpart is [FC_WARPS][2][64] fp32.
__device__ __forceinline__ void write_tile_stats(float* wpart, const float wsum[4], float* part,
                                                 int ldc, int c0, int tid) {
    const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
        wpart[(warp * 2 + (lane >> 4)) * FC_CO + nt * 16 + (lane & 15)] = wsum[nt];
    __syncthreads();
    if (tid < 2 * FC_CO) {
        const int kind = tid >> 6, ch = tid & 63;
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < FC_WARPS; ++w) s += wpart[(w * 2 + kind) * FC_CO + ch];
        part[kind * ldc + c0 + ch] = s;
    }
}

// --------------------------------------------------------------------------
// gn_silu_conv3x3
// --------------------------------------------------------------------------

struct GscArgs {
    const bf16* x;
    long long x_sn;  // batch stride of x in elements (rows and pixels are dense)
    const float* a;  // [N, C] or null (no activation)
    const float* b;
    const bf16* k;      // [9 * C, 64]
    const float* bias;  // [64]
    const bf16* xs;     // [N, H, W, CS] or null
    const bf16* sk;     // [CS, 64]
    const float* sb;    // [64]
    const bf16* res;    // [N, H, W, 64] or null
    bf16* out;          // [N, H, W, 64]
    float* part;        // [N, tiles, 2, 64] or null
    int N, H, W, tiles_h, tiles_w;
};

template <int C, int TH, int CS>
struct GscSmem {
    static constexpr int LDX = C + FC_PAD;
    static constexpr int LDS = CS + FC_PAD;
    static constexpr int TPIX = (TH + 2) * FC_TWH;
    static constexpr int wk = 0;
    static constexpr int wsk = wk + 9 * C * FC_LDW * 2;
    static constexpr int xt = wsk + CS * FC_LDW * 2;
    static constexpr int xst = xt + TPIX * LDX * 2;
    static constexpr int stg = xst + (CS ? TH * FC_TW * LDS * 2 : 0);
    static constexpr int wpart = stg + FC_WARPS * 256 * 4;
    static constexpr int bytes = wpart + FC_WARPS * 2 * FC_CO * 4;
};

template <int C, int TH, int CS>
__global__ void __launch_bounds__(FC_THREADS, 1) gn_silu_conv3x3_kernel(GscArgs g) {
    typedef GscSmem<C, TH, CS> L;
    constexpr int MT = TH / FC_WARPS;
    constexpr int VEC = C / 8;  // 16-byte vectors per pixel
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* wk = reinterpret_cast<bf16*>(smem + L::wk);
    bf16* wsk = reinterpret_cast<bf16*>(smem + L::wsk);
    bf16* xt = reinterpret_cast<bf16*>(smem + L::xt);
    bf16* xst = reinterpret_cast<bf16*>(smem + L::xst);
    float* wpart = reinterpret_cast<float*>(smem + L::wpart);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    float* stg = reinterpret_cast<float*>(smem + L::stg) + warp * 256;

    // the whole kernel, once per CTA (completion is awaited with the first tile)
    stage_rows(wk, g.k, FC_CO, 9 * C, tid);
    if (CS) stage_rows(wsk, g.sk, FC_CO, CS, tid);

    const int H = g.H, W = g.W;
    const int tiles_img = g.tiles_h * g.tiles_w;
    const int total = g.N * tiles_img;

    // A tile's raw pixels travel through registers: the loads of the NEXT
    // tile are started before this tile's MMAs and land while they run.
    constexpr int NV = (L::TPIX * VEC + FC_THREADS - 1) / FC_THREADS;
    uint4 pre[NV];
    unsigned inside = 0;  // bit j: pre[j] lies inside the image
    auto fetch = [&](int tt) {
        const int n = tt / tiles_img, ti = tt - n * tiles_img;
        const int h0 = (ti / g.tiles_w) * TH, w0 = (ti % g.tiles_w) * FC_TW;
        const bf16* xn = g.x + n * g.x_sn;
        inside = 0;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
            const int idx = tid + j * FC_THREADS;
            const int pix = idx / VEC, v = idx - pix * VEC;
            const int r = pix / FC_TWH, c = pix - r * FC_TWH;
            const int hh = h0 + r - 1, ww = w0 + c - 1;
            pre[j] = make_uint4(0u, 0u, 0u, 0u);
            if (idx < L::TPIX * VEC && hh >= 0 && hh < H && ww >= 0 && ww < W) {
                pre[j] = __ldg(
                    reinterpret_cast<const uint4*>(xn + ((long long)hh * W + ww) * C + v * 8));
                inside |= 1u << j;
            }
        }
    };
    if (blockIdx.x < total) fetch(blockIdx.x);

    for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const int n = t / tiles_img, ti = t - n * tiles_img;
        const int h0 = (ti / g.tiles_w) * TH, w0 = (ti % g.tiles_w) * FC_TW;
        const float* an = g.a ? g.a + (long long)n * C : nullptr;
        const float* bn = g.a ? g.b + (long long)n * C : nullptr;

        // the activated tile with its halo; outside the image: zero (after
        // the activation)
#pragma unroll
        for (int j = 0; j < NV; ++j) {
            const int idx = tid + j * FC_THREADS;
            const int pix = idx / VEC, v = idx - pix * VEC;
            if (idx < L::TPIX * VEC) {
                uint4 val = pre[j];
                if (an && ((inside >> j) & 1u)) val = affine_silu8(val, an + v * 8, bn + v * 8);
                *reinterpret_cast<uint4*>(xt + pix * L::LDX + v * 8) = val;
            }
        }
        if (CS) {
            constexpr int VS = (CS ? CS : 8) / 8;
            const bf16* xsn = g.xs + (long long)n * H * W * CS;
            for (int idx = tid; idx < TH * FC_TW * VS; idx += FC_THREADS) {
                const int pix = idx / VS, v = idx - pix * VS;
                const int hh = h0 + pix / FC_TW, ww = w0 + pix % FC_TW;
                bf16* dst = xst + pix * L::LDS + v * 8;
                if (hh < H && ww < W)
                    cp_async16(dst, xsn + ((long long)hh * W + ww) * CS + v * 8);
                else
                    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
            }
        }
        cp_async_wait_all();
        __syncthreads();
        if (t + (int)gridDim.x < total) fetch(t + gridDim.x);

        AccFrag acc[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) wmma::fill_fragment(acc[mt][nt], 0.0f);

        for (int tap = 0; tap < 9; ++tap) {
            const int di = tap / 3, dj = tap - di * 3;
#pragma unroll 2
            for (int k0 = 0; k0 < C; k0 += 16) {
                BFrag bf[4];
#pragma unroll
                for (int nt = 0; nt < 4; ++nt)
                    wmma::load_matrix_sync(bf[nt], wk + (tap * C + k0) * FC_LDW + nt * 16, FC_LDW);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    const int row = warp + mt * FC_WARPS;
                    AFrag af;
                    wmma::load_matrix_sync(af, xt + ((row + di) * FC_TWH + dj) * L::LDX + k0,
                                           L::LDX);
#pragma unroll
                    for (int nt = 0; nt < 4; ++nt)
                        wmma::mma_sync(acc[mt][nt], af, bf[nt], acc[mt][nt]);
                }
            }
        }
        if (CS) {
#pragma unroll 2
            for (int k0 = 0; k0 < CS; k0 += 16) {
                BFrag bf[4];
#pragma unroll
                for (int nt = 0; nt < 4; ++nt)
                    wmma::load_matrix_sync(bf[nt], wsk + k0 * FC_LDW + nt * 16, FC_LDW);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    const int row = warp + mt * FC_WARPS;
                    AFrag af;
                    wmma::load_matrix_sync(af, xst + row * FC_TW * L::LDS + k0, L::LDS);
#pragma unroll
                    for (int nt = 0; nt < 4; ++nt)
                        wmma::mma_sync(acc[mt][nt], af, bf[nt], acc[mt][nt]);
                }
            }
        }

        float wsum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const bool want_stats = g.part != nullptr;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            const int hh = h0 + warp + mt * FC_WARPS;
            const int valid_w = hh < H ? min(FC_TW, W - w0) : 0;
            const long long pix0 = (((long long)n * H + hh) * W + w0) * FC_CO;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
                wsum[nt] += epilogue16(acc[mt][nt], stg, lane, g.bias + nt * 16,
                                       CS ? g.sb + nt * 16 : nullptr,
                                       g.res ? g.res + pix0 + nt * 16 : nullptr,
                                       g.out + pix0 + nt * 16, FC_CO, valid_w, want_stats);
        }
        if (want_stats) {
            write_tile_stats(wpart, wsum, g.part + (long long)t * 2 * FC_CO, FC_CO, 0, tid);
        } else {
            __syncthreads();  // every warp is done with the tile before it is restaged
        }
    }
    cp_async_wait_all();  // a CTA without a tile still waits for its weight copy
}

// --------------------------------------------------------------------------
// subpixel_up_conv3x3
// --------------------------------------------------------------------------

#define SUB_TH 8
#define SUB_KC 32  // input channels per staged slice
#define SUB_LDX (SUB_KC + FC_PAD)
#define SUB_TPIX ((SUB_TH + 2) * FC_TWH)
#define SUB_X_BYTES (SUB_TPIX * SUB_LDX * 2)
#define SUB_STAGE_BYTES (SUB_X_BYTES + 16 * SUB_KC * FC_LDW * 2)
#define SUB_OFF_STG (2 * SUB_STAGE_BYTES)
#define SUB_OFF_WPART (SUB_OFF_STG + FC_WARPS * 256 * 4)
#define SUB_SMEM (SUB_OFF_WPART + FC_WARPS * 2 * FC_CO * 4)

struct SubArgs {
    const bf16* x;
    long long x_sn;     // batch stride of x in elements
    const bf16* k2;     // [2, 2, 2, 2, C, C]
    const float* bias;  // [C]
    bf16* out;          // [N, 2H, 2W, C]
    float* part;        // [N, tiles, 2, C] or null
    int N, H, W, C, tiles_h, tiles_w;
};

// Start the copy of input channels [kc, kc + SUB_KC) of the pixel tile at
// (h0, w0) with its halo, and of the same rows of all sixteen matrices
// (columns [nc0, nc0 + 64)), into one stage buffer; one copy group.
__device__ __forceinline__ void sub_stage(unsigned char* stage, const SubArgs& g, const bf16* xn,
                                          int h0, int w0, int kc, int nc0, int tid) {
    bf16* xt = reinterpret_cast<bf16*>(stage);
    bf16* wt = reinterpret_cast<bf16*>(stage + SUB_X_BYTES);
    constexpr int VEC = SUB_KC / 8;
    for (int idx = tid; idx < SUB_TPIX * VEC; idx += FC_THREADS) {
        const int pix = idx / VEC, v = idx - pix * VEC;
        const int r = pix / FC_TWH, c = pix - r * FC_TWH;
        const int hh = h0 + r - 1, ww = w0 + c - 1;
        bf16* dst = xt + pix * SUB_LDX + v * 8;
        if (hh >= 0 && hh < g.H && ww >= 0 && ww < g.W)
            cp_async16(dst, xn + ((long long)hh * g.W + ww) * g.C + kc + v * 8);
        else
            *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    for (int m = 0; m < 16; ++m)
        stage_rows(wt + m * SUB_KC * FC_LDW, g.k2 + ((long long)m * g.C + kc) * g.C + nc0, g.C,
                   SUB_KC, tid);
    cp_async_commit();
}

__global__ void __launch_bounds__(FC_THREADS, 1) subpixel_up_conv3x3_kernel(SubArgs g) {
    extern __shared__ __align__(128) unsigned char smem[];
    float* wpart = reinterpret_cast<float*>(smem + SUB_OFF_WPART);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    float* stg = reinterpret_cast<float*>(smem + SUB_OFF_STG) + warp * 256;
    // a warp owns row phase pa of two rows of the tile: 2 column phases x
    // 2 rows x 4 N-tiles of accumulators, every B fragment feeds two MMAs
    const int pa = warp >> 2, r0 = (warp & 3) * 2;

    const int H = g.H, W = g.W, C = g.C;
    const int nchunks = C / FC_CO;
    const int tiles_img = g.tiles_h * g.tiles_w;
    const int t = blockIdx.x / nchunks;
    const int nc0 = (blockIdx.x - t * nchunks) * FC_CO;
    const int n = t / tiles_img, ti = t - n * tiles_img;
    const int h0 = (ti / g.tiles_w) * SUB_TH, w0 = (ti % g.tiles_w) * FC_TW;
    const bf16* xn = g.x + n * g.x_sn;

    AccFrag acc[2][2][4];  // [column phase b][row of the pair][N-tile]
#pragma unroll
    for (int pb = 0; pb < 2; ++pb)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) wmma::fill_fragment(acc[pb][mt][nt], 0.0f);

    // two stage buffers: slice s + 1 is copied while slice s is multiplied
    const int slices = C / SUB_KC;
    sub_stage(smem, g, xn, h0, w0, 0, nc0, tid);
    for (int s = 0; s < slices; ++s) {
        if (s + 1 < slices) {
            sub_stage(smem + ((s + 1) & 1) * SUB_STAGE_BYTES, g, xn, h0, w0, (s + 1) * SUB_KC, nc0,
                      tid);
            cp_async_wait_group<1>();
        } else {
            cp_async_wait_group<0>();
        }
        __syncthreads();
        const bf16* xt = reinterpret_cast<const bf16*>(smem + (s & 1) * SUB_STAGE_BYTES);
        const bf16* wt = reinterpret_cast<const bf16*>(smem + (s & 1) * SUB_STAGE_BYTES + SUB_X_BYTES);

#pragma unroll
        for (int k0 = 0; k0 < SUB_KC; k0 += 16) {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
#pragma unroll
                for (int dc = 0; dc < 3; ++dc) {
                    const bf16* ap = xt + ((r0 + pa + u) * FC_TWH + dc) * SUB_LDX + k0;
                    AFrag a0, a1;
                    wmma::load_matrix_sync(a0, ap, SUB_LDX);
                    wmma::load_matrix_sync(a1, ap + FC_TWH * SUB_LDX, SUB_LDX);
#pragma unroll
                    for (int pb = 0; pb < 2; ++pb) {
                        const int v = dc - pb;
                        if (v < 0 || v > 1) continue;
                        const int m = ((pa * 2 + pb) * 2 + u) * 2 + v;
#pragma unroll
                        for (int nt = 0; nt < 4; ++nt) {
                            BFrag bf;
                            wmma::load_matrix_sync(bf, wt + (m * SUB_KC + k0) * FC_LDW + nt * 16,
                                                   FC_LDW);
                            wmma::mma_sync(acc[pb][0][nt], a0, bf, acc[pb][0][nt]);
                            wmma::mma_sync(acc[pb][1][nt], a1, bf, acc[pb][1][nt]);
                        }
                    }
                }
            }
        }
        __syncthreads();  // the slice has been consumed: its buffer may be refilled
    }

    float wsum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const bool want_stats = g.part != nullptr;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
        const int hh = h0 + r0 + mt;
        const int valid_w = hh < H ? min(FC_TW, W - w0) : 0;
#pragma unroll
        for (int pb = 0; pb < 2; ++pb) {
            const long long pix0 =
                (((long long)n * 2 * H + 2 * hh + pa) * 2 * W + 2 * w0 + pb) * C + nc0;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
                wsum[nt] += epilogue16(acc[pb][mt][nt], stg, lane, g.bias + nc0 + nt * 16, nullptr,
                                       nullptr, g.out + pix0 + nt * 16, 2LL * C, valid_w,
                                       want_stats);
        }
    }
    if (want_stats) write_tile_stats(wpart, wsum, g.part + (long long)t * 2 * C, C, nc0, tid);
}

// --------------------------------------------------------------------------
// Plain C entry points (loaded with ctypes); each returns a cudaError_t code.
// --------------------------------------------------------------------------

static int sm_count(int* sms) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

template <int C, int TH, int CS>
static int launch_gsc(GscArgs g, cudaStream_t stream) {
    typedef GscSmem<C, TH, CS> L;
    static_assert(L::bytes <= FC_SMEM_MAX, "shared memory");
    g.tiles_h = (g.H + TH - 1) / TH;
    g.tiles_w = (g.W + FC_TW - 1) / FC_TW;
    auto kernel = gn_silu_conv3x3_kernel<C, TH, CS>;
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
    if (e != cudaSuccess) return (int)e;
    int sms = 0;
    int rc = sm_count(&sms);
    if (rc != 0) return rc;
    const long long total = (long long)g.N * g.tiles_h * g.tiles_w;
    if (total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int grid = total < sms ? (int)total : sms;
    kernel<<<grid, FC_THREADS, L::bytes, stream>>>(g);
    return (int)cudaGetLastError();
}

// Rows of one pixel tile of gn_silu_conv3x3 for the widths (a tile is that
// many rows by FC_TW pixels), 0 where the kernel does not take them.
static int gsc_tile_rows(int C, int Co, int Cs) {
    if (Co != FC_CO) return 0;
    if (C == 128 && Cs == 0) return 8;
    if (C == 64 && Cs == 0) return 16;
    if (C == 64 && Cs == 128) return 8;
    return 0;
}

// Tiles per sample of gn_silu_conv3x3 on an H x W image: the second extent
// of its `part` buffer.  0 where the kernel does not take the widths.
extern "C" int gn_silu_conv3x3_tiles(int H, int W, int C, int Co, int Cs) {
    const int th = gsc_tile_rows(C, Co, Cs);
    return th ? ((H + th - 1) / th) * ((W + FC_TW - 1) / FC_TW) : 0;
}

// x [N,H,W,C] bf16 with batch stride x_sn elements; a, b [N,C] fp32 or both
// null; k [3,3,C,Co] bf16; bias [Co] fp32; xs [N,H,W,Cs] / sk [Cs,Co] bf16 /
// sb [Co] fp32 or all null with Cs = 0; res [N,H,W,Co] bf16 or null; out
// [N,H,W,Co] bf16; part [N, tiles, 2, Co] fp32 or null.  Every pointer is
// 16-byte aligned, x_sn a multiple of 8.
extern "C" int gn_silu_conv3x3_launch(const void* x, long long x_sn, const void* a, const void* b,
                                      const void* k, const void* bias, const void* xs,
                                      const void* sk, const void* sb, const void* res, void* out,
                                      void* part, int N, int H, int W, int C, int Co, int Cs,
                                      void* stream) {
    if (N <= 0 || H <= 0 || W <= 0 || x_sn % 8 || (a == nullptr) != (b == nullptr))
        return (int)cudaErrorInvalidValue;
    if ((Cs != 0) != (xs != nullptr) || (Cs != 0) != (sk != nullptr) ||
        (Cs != 0) != (sb != nullptr))
        return (int)cudaErrorInvalidValue;
    GscArgs g = {};
    g.x = (const bf16*)x;
    g.x_sn = x_sn;
    g.a = (const float*)a;
    g.b = (const float*)b;
    g.k = (const bf16*)k;
    g.bias = (const float*)bias;
    g.xs = (const bf16*)xs;
    g.sk = (const bf16*)sk;
    g.sb = (const float*)sb;
    g.res = (const bf16*)res;
    g.out = (bf16*)out;
    g.part = (float*)part;
    g.N = N;
    g.H = H;
    g.W = W;
    cudaStream_t s = (cudaStream_t)stream;
    if (!gsc_tile_rows(C, Co, Cs)) return (int)cudaErrorInvalidValue;
    if (C == 128) return launch_gsc<128, 8, 0>(g, s);
    if (Cs) return launch_gsc<64, 8, 128>(g, s);
    return launch_gsc<64, 16, 0>(g, s);
}

// Tiles per sample of subpixel_up_conv3x3 on an H x W input: the second
// extent of its `part` buffer.
extern "C" int subpixel_up_conv3x3_tiles(int H, int W) {
    return ((H + SUB_TH - 1) / SUB_TH) * ((W + FC_TW - 1) / FC_TW);
}

// x [N,H,W,C] bf16 with batch stride x_sn elements; k2 [2,2,2,2,C,C] bf16;
// bias [C] fp32; out [N,2H,2W,C] bf16; part [N, tiles, 2, C] fp32 or null.
// C is a multiple of 64; every pointer is 16-byte aligned, x_sn a multiple
// of 8.
extern "C" int subpixel_up_conv3x3_launch(const void* x, long long x_sn, const void* k2,
                                          const void* bias, void* out, void* part, int N, int H,
                                          int W, int C, void* stream) {
    if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || C % FC_CO || x_sn % 8)
        return (int)cudaErrorInvalidValue;
    static_assert(SUB_SMEM <= FC_SMEM_MAX && FC_CO % SUB_KC == 0, "shared memory, slices");
    SubArgs g = {};
    g.x = (const bf16*)x;
    g.x_sn = x_sn;
    g.k2 = (const bf16*)k2;
    g.bias = (const float*)bias;
    g.out = (bf16*)out;
    g.part = (float*)part;
    g.N = N;
    g.H = H;
    g.W = W;
    g.C = C;
    g.tiles_h = (H + SUB_TH - 1) / SUB_TH;
    g.tiles_w = (W + FC_TW - 1) / FC_TW;
    cudaError_t e = cudaFuncSetAttribute(subpixel_up_conv3x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SUB_SMEM);
    if (e != cudaSuccess) return (int)e;
    const long long grid = (long long)N * g.tiles_h * g.tiles_w * (C / FC_CO);
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    subpixel_up_conv3x3_kernel<<<(unsigned)grid, FC_THREADS, SUB_SMEM, (cudaStream_t)stream>>>(g);
    return (int)cudaGetLastError();
}
