// Subpixel upsample conv (K8), Hopper (sm_90a), bf16 operands, fp32 sums.
//
// Replaces the TPU kernel pgtformer_tpu/ops/pallas_conv.py:subpixel_up_conv3x3
// (_sub_kernel).
//
//     out = conv3x3(nearest_up2(x)) + bias, as four 2x2 phase convs:
//     out[n, 2r+a, 2w+b] = bias + sum_{u,v} xpad[r+a+u, w+b+v] @ k2[a,b,u,v]
//
// x [N,H,W,C] bf16 (batch stride given), k2 [2,2,2,2,C,C] bf16 (pre-summed by
// the caller from the fp32 3x3 kernel), bias [C] fp32, out [N,2H,2W,C] bf16
// written interleaved, rounded once.  Optionally per-tile partial (sum, sum
// of squares) of the ROUNDED output per channel, part[n][tile][2][C], summed
// over tiles by the caller: no atomics, two launches are bit-equal.
//
// What bounds it on an H100: 32*C^2 FLOP per input pixel against ~10*C bytes,
// so by the arithmetic it is bound by operations.  But the sixteen C x C
// phase matrices (0.5 to 8 MB) do not fit in a CTA: every CTA streams them
// from L2 for its pixel tile, and the register file caps how many pixels one
// weight element read from L2 can feed.  The weight feed from L2 is the
// limit (the first, wmma, version read its weights by per-thread cp.async
// at ~1.1 TB/s, 15-18% of the tensor peak).
//
// Design: a work item is (12 x 16 input pixel tile, 64 output channels,
// output row phase a); one persistent CTA per SM walks the items with three
// consumer warpgroups and one producer warp, whose ring and input buffers
// carry on from item to item, so the next item's loads overlap this one's
// epilogue.  The two row phases of a tile are neighbouring items: its input
// is read from L2.
//  * The producer warp: one thread issues every TMA load.  The weights come
//    through a ring of STAGES 64 x 64 tiles (8 KB, 128-byte swizzle) of a
//    2-D tensor map over k2 as [16*C, C], with full and empty mbarriers: per
//    64-channel slice the eight matrices of phase row a, two slices in
//    flight.  The input comes through two buffers of one slice of the
//    13 x 18 halo rows that phase row reads (a 4-D map (C, W, H, N) whose
//    out-of-range rows and columns the TMA fills with zeros: the conv's
//    padding and the ragged edge cost no code).
//  * Consumer warpgroups 0..2 each own 4 tile rows (64 pixels) x 2 column
//    phases x 64 channels: 64 fp32 accumulators per thread in registers.
//    Per slice, for each of the six input shifts (u, dx) a warp loads its 16
//    pixels' A fragments by ldmatrix, one row address per pixel (so the
//    shift costs nothing, and the swizzle keeps it free of bank conflicts),
//    and feeds them to wgmma m64n64k16 (A from registers, B from the ring,
//    MN-major) for each column phase that uses that shift: 6 A loads serve 8
//    products.  All three warpgroups read the same weight tile, so each
//    weight element read from L2 feeds 192 pixels.  (All four phases per
//    item, 128 accumulators per thread, made ptxas spill and serialize the
//    wgmma; two consumer warpgroups were 5-16% slower; a cluster of two CTAs
//    sharing each tile by TMA multicast was 2-3x slower at every serving
//    shape on an H100: PERF.md keeps the times.)
//  * The epilogue adds the bias, rounds, writes the interleaved output and
//    reduces the tile's statistics from the registers (shuffles, then the
//    consumer warps in a fixed order through shared memory), one partial
//    per (tile, row phase).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NCONS = 3;                 // consumer warpgroups, 4 tile rows each
constexpr int TH = 4 * NCONS;            // input rows per tile
constexpr int TW = 16;                   // input columns per tile (one warp's 16 A rows)
constexpr int XH = TH + 1, XW = TW + 2;  // the rows and columns one row phase reads
constexpr int KC = 64;                   // input channels per slice (one 128-byte row)
constexpr int NC = 64;                   // output channels per CTA
constexpr int TILES = 8;                 // weight tiles per slice: one row phase's 8 matrices
constexpr int STAGES = 2 * TILES;        // weight ring: two slices
constexpr int THREADS = 128 * NCONS + 32;  // + one producer warp
constexpr uint32_t TILE_BYTES = KC * NC * 2;
constexpr uint32_t X_TX = XH * XW * KC * 2;              // bytes a slice's box moves
constexpr uint32_t X_BYTES = (X_TX + 1023) / 1024 * 1024;
constexpr uint32_t OFF_X = STAGES * TILE_BYTES;
constexpr uint32_t OFF_STATS = OFF_X + 2 * X_BYTES;       // [consumer warps][2][64] fp32
constexpr uint32_t OFF_BAR = OFF_STATS + NCONS * 4 * 2 * NC * 4;
constexpr uint32_t SMEM = OFF_BAR + (2 * STAGES + 4) * 8 + 1024;  // + alignment slack
static_assert(SMEM <= 232448, "shared memory");

struct Args {
    const float* bias;  // [C]
    bf16* out;          // [N, 2H, 2W, C]
    float* part;        // [N, tiles, 2, C] or null
    int H, W, C, tiles_h, tiles_w;
    int work;           // work items: N * tiles * (C / NC) * 2 row phases
};

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    return t;
}

// Wait until the phase of the given parity has completed.  A wait that
// lasts 10 s can only be a broken protocol: trap, so the launch fails
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    uint32_t done = 0;
    uint32_t t0 = 0;  // start of the wait in units of 2^20 ns, 0 before it is read
    for (uint32_t spin = 0; !done; ++spin) {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(addr), "r"(parity)
            : "memory");
        if (!done && (spin & 1023) == 1023) {
            const uint32_t now = (uint32_t)(global_ns() >> 20) | 1u;
            if (t0 == 0) t0 = now;
            else if (now - t0 > 9537u) __trap();
        }
    }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
        : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
        "r"(c3)
        : "memory");
}

// wgmma descriptor of a weight tile: 64 rows (k) of 128 bytes (n), 128-byte
// swizzle, 8-row atoms 1024 bytes apart; read MN-major.
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
    uint64_t d = (addr & 0x3FFFF) >> 4;
    d |= (uint64_t)1 << 16;             // leading offset: one 64-wide atom, unused
    d |= (uint64_t)(1024 >> 4) << 32;   // stride offset: next 8 rows of k
    d |= (uint64_t)1 << 62;             // 128-byte swizzle
    return d;
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D[64 x 64] += A.B, A (bf16) from registers, B from shared memory MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Keep the compiler from reusing an A operand's registers, or touching an
// accumulator, while a product that reads them may still run.
__device__ __forceinline__ void fence_a(uint32_t (&a)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Column phase b reads input column shift dx through tap v = dx - b, which
// must be 0 or 1.  The loops over shifts and phases are fully unrolled, so
// this folds to a constant.
__host__ __device__ constexpr bool uses(int dx, int b) { return dx - b == 0 || dx - b == 1; }

// ------------------------------------------------------------------ kernel

// Work item w -> (pixel tile t, output channel block, row phase a).  The two
// row phases of a tile and block are neighbours, run at the same time on
// neighbouring SMs and share the tile's input in L2.
struct Work {
    int pa, t, nc0, n, h0, w0;
};

__device__ __forceinline__ Work decode(int w, const Args& g) {
    Work k;
    const int nblk = g.C / NC;
    const int tiles_img = g.tiles_h * g.tiles_w;
    k.pa = w & 1;
    k.t = (w >> 1) / nblk;
    k.nc0 = ((w >> 1) - k.t * nblk) * NC;
    k.n = k.t / tiles_img;
    const int ti = k.t - k.n * tiles_img;
    k.h0 = (ti / g.tiles_w) * TH;
    k.w0 = (ti % g.tiles_w) * TW;
    return k;
}

__global__ void __launch_bounds__(THREADS, 1)
    subpixel_up_conv3x3_kernel(const __grid_constant__ CUtensorMap xmap,
                               const __grid_constant__ CUtensorMap wmap, const Args g) {
    extern __shared__ unsigned char smem_raw[];
    // TMA swizzle and the wgmma descriptors assume 1024-byte aligned tiles
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
    uint64_t* empty = full + STAGES;
    uint64_t* x_full = empty + STAGES;
    uint64_t* x_empty = x_full + 2;

    // a persistent CTA per SM walks the work items w = blockIdx.x, + gridDim.x,
    // ...; the ring and the input buffers carry on from one item to the next
    // (slice gs of the CTA uses buffers gs & 1), so the producer loads an
    // item while the consumers finish the last one
    const int C = g.C;
    const int nk = C / KC;
    const int wg = threadIdx.x / 128;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], NCONS * 4);  // lane 0 of every consumer warp
        }
        for (int b = 0; b < 2; ++b) {
            mbar_init(&x_full[b], 1);
            mbar_init(&x_empty[b], NCONS * 4);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (wg == NCONS) {
        // ---- producer: one thread issues every TMA load, in the consumers' order ----
        if (threadIdx.x == NCONS * 128) {
            int gs = 0;
            for (int w = blockIdx.x; w < g.work; w += gridDim.x) {
                const Work k = decode(w, g);
                for (int kc = 0; kc < nk; ++kc, ++gs) {
                    const int xb = gs & 1;
                    const uint32_t par = ((gs >> 1) & 1) ^ 1;
                    mbar_wait(&x_empty[xb], par);
                    mbar_expect_tx(&x_full[xb], X_TX);
                    // input rows h0 - 1 + pa .. h0 + 7 + pa: the halo rows phase pa reads
                    tma_load_4d(smem + OFF_X + xb * X_BYTES, &xmap, &x_full[xb], kc * KC,
                                k.w0 - 1, k.h0 - 1 + k.pa, k.n);
                    // the consumers' order: by input shift (u, dx), then the
                    // column phases b that read it through tap v = dx - b
                    int slot = xb * TILES;
#pragma unroll
                    for (int u = 0; u < 2; ++u)
#pragma unroll
                        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
                            for (int b = 0; b < 2; ++b) {
                                if (!uses(dx, b)) continue;
                                const int m = ((k.pa * 2 + b) * 2 + u) * 2 + dx - b;
                                mbar_wait(&empty[slot], par);
                                mbar_expect_tx(&full[slot], TILE_BYTES);
                                tma_load_2d(smem + slot * TILE_BYTES, &wmap, &full[slot], k.nc0,
                                            m * C + kc * KC);
                                ++slot;
                            }
                }
            }
        }
        return;
    }

    // ---- consumers: warpgroup wg owns tile rows 4*wg .. 4*wg + 3 ----
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int row = wg * 4 + warp;        // this warp's tile row
    const int pc = lane & 15;             // the pixel column whose A row this lane addresses
    const int khalf = lane >> 4;          // and which 8 of each 16 channels
    const int q = lane % 4, r8 = lane / 4;  // accumulator column pair, row within 8
    const uint32_t ring = smem_u32(smem);
    const bool want_stats = g.part != nullptr;
    float* wpart = reinterpret_cast<float*>(smem + OFF_STATS);

    float acc[2][32];                     // [column phase b][wgmma m64n64 fragment]
    uint32_t afr[2][4][4];                // A fragments of two shifts [shift % 2][k16]
    int gs = 0;
    for (int w = blockIdx.x; w < g.work; w += gridDim.x) {
        const Work k = decode(w, g);
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;

        for (int kc = 0; kc < nk; ++kc, ++gs) {
            const int xb = gs & 1;
            const uint32_t par = (gs >> 1) & 1;
            const uint32_t xs = smem_u32(smem + OFF_X + xb * X_BYTES);
            const int base = xb * TILES;  // this slice's ring slots
            mbar_wait(&x_full[xb], par);
            int j = 0;
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
                for (int dx = 0; dx < 3; ++dx) {
                    // six shifts a slice: a shift's A buffer is the same in every slice
                    uint32_t (&A)[4][4] = afr[(u * 3 + dx) % 2];
                    // pixel (row + u, pc + dx) of the staged rows: one 128-byte
                    // row whose 16-byte chunks the TMA swizzled by (pixel & 7)
                    const int pix = (row + u) * XW + pc + dx;
                    const uint32_t prow = xs + pix * 128;
#pragma unroll
                    for (int k16 = 0; k16 < 4; ++k16)
                        ldsm_x4(A[k16], prow + (((k16 * 2 + khalf) ^ (pix & 7)) << 4));
                    if (u == 1 && dx == 2) {  // the slice's last reads of x
                        // order these generic-proxy reads before the TMA's
                        // (async-proxy) refill of the buffer: without it the
                        // refill can overtake them
                        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
                        __syncwarp();
                        if (lane == 0) mbar_arrive(&x_empty[xb]);
                    }
#pragma unroll
                    for (int b = 0; b < 2; ++b) {
                        if (!uses(dx, b)) continue;
                        float (&d)[32] = acc[b];
                        mbar_wait(&full[base + j], par);
                        const uint64_t db = tile_desc(ring + (base + j) * TILE_BYTES);
                        wgmma_fence();
#pragma unroll
                        for (int k16 = 0; k16 < 4; ++k16)
                            wgmma_rs_n64(d, A[k16], db + ((k16 * 16 * 128) >> 4));
                        wgmma_commit();
                        // the tile before this one (the last of the previous
                        // slice for the first) has been consumed
                        wgmma_wait<1>();
                        fence_a(afr[0]);
                        fence_a(afr[1]);
                        __syncwarp();
                        if (lane == 0 && (j > 0 || kc > 0))
                            mbar_arrive(&empty[j > 0 ? base + j - 1 : (base ^ TILES) + TILES - 1]);
                        ++j;
                    }
                }
        }
        wgmma_wait<0>();
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[((gs - 1) & 1) * TILES + TILES - 1]);

        // ---- epilogue: bias, one rounding, interleaved write, tile statistics ----
        const int H = g.H, W = g.W;
        const int hh = k.h0 + row;
        float s1[16], s2[16];                     // [8-column chunk i][2]
#pragma unroll
        for (int i = 0; i < 16; ++i) s1[i] = s2[i] = 0.f;
        float bv[16];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const float2 bb =
                __ldg(reinterpret_cast<const float2*>(g.bias + k.nc0 + 8 * i + 2 * q));
            bv[2 * i] = bb.x;
            bv[2 * i + 1] = bb.y;
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int ww = k.w0 + r8 + 8 * half;
            const bool valid = hh < H && ww < W;
#pragma unroll
            for (int b = 0; b < 2; ++b) {
                bf16* o = g.out +
                          (((long long)k.n * 2 * H + 2 * hh + k.pa) * 2 * W + 2 * ww + b) * C +
                          k.nc0 + 2 * q;
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const float* d = &acc[b][4 * i + 2 * half];
                    const __nv_bfloat162 v = __floats2bfloat162_rn(d[0] + bv[2 * i],
                                                                   d[1] + bv[2 * i + 1]);
                    if (valid) {
                        *reinterpret_cast<__nv_bfloat162*>(o + 8 * i) = v;
                        const float2 f = __bfloat1622float2(v);
                        s1[2 * i] += f.x;
                        s1[2 * i + 1] += f.y;
                        s2[2 * i] += f.x * f.x;
                        s2[2 * i + 1] += f.y * f.y;
                    }
                }
            }
        }
        if (want_stats) {
            // sum over the 8 lanes of a column (lane / 4), then over the
            // consumer warps in order
#pragma unroll
            for (int i = 0; i < 16; ++i) {
#pragma unroll
                for (int o = 4; o < 32; o <<= 1) {
                    s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], o);
                    s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], o);
                }
            }
            const int gw = wg * 4 + warp;
            if (lane < 4) {
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    wpart[(gw * 2 + 0) * NC + 8 * i + 2 * q] = s1[2 * i];
                    wpart[(gw * 2 + 0) * NC + 8 * i + 2 * q + 1] = s1[2 * i + 1];
                    wpart[(gw * 2 + 1) * NC + 8 * i + 2 * q] = s2[2 * i];
                    wpart[(gw * 2 + 1) * NC + 8 * i + 2 * q + 1] = s2[2 * i + 1];
                }
            }
            named_sync(1, NCONS * 128);
            const int ctid = wg * 128 + tid;
            if (ctid < 2 * NC) {
                const int kind = ctid / NC, ch = ctid % NC;
                float s = 0.f;
#pragma unroll
                for (int cw = 0; cw < NCONS * 4; ++cw) s += wpart[(cw * 2 + kind) * NC + ch];
                // one partial per (tile, row phase)
                g.part[((long long)(k.t * 2 + k.pa) * 2 + kind) * C + k.nc0 + ch] = s;
            }
            named_sync(1, NCONS * 128);  // the next item may overwrite wpart
        }
    }
}

// ------------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime's entry-point
// query so that the library needs no -lcuda.
EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                         cudaEnableDefault, &found);
#else
        cudaError_t e =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// Error codes beyond cudaError_t's range.
constexpr int ERR_NO_ENCODER = 10000;
constexpr int ERR_ENCODE = 20000;  // + CUresult

}  // namespace

// Partial statistics per sample on an H x W input, one per (pixel tile, row
// phase): the second extent of `part`.
extern "C" int subpixel_up_conv3x3_tiles(int H, int W) {
    return 2 * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
}

// x [N,H,W,C] bf16 with batch stride x_sn elements; k2 [2,2,2,2,C,C] bf16;
// bias [C] fp32; out [N,2H,2W,C] bf16; part [N, subpixel_up_conv3x3_tiles(H, W),
// 2, C] fp32 or null.
// C is a multiple of 64; every pointer is 16-byte aligned, x_sn a multiple
// of 8.
extern "C" int subpixel_up_conv3x3_launch(const void* x, long long x_sn, const void* k2,
                                          const void* bias, void* out, void* part, int N, int H,
                                          int W, int C, void* stream) {
    if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || C % NC || x_sn % 8)
        return (int)cudaErrorInvalidValue;
    EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return ERR_NO_ENCODER;
    CUtensorMap xmap, wmap;
    {
        const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
        const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                       (cuuint64_t)x_sn * 2};
        const cuuint32_t box[4] = {KC, XW, XH, 1};
        const cuuint32_t estride[4] = {1, 1, 1, 1};
        CUresult r = fn(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
                        strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
        if (r != CUDA_SUCCESS) return ERR_ENCODE + (int)r;
    }
    {
        const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)16 * C};
        const cuuint64_t strides[1] = {(cuuint64_t)C * 2};
        const cuuint32_t box[2] = {NC, KC};
        const cuuint32_t estride[2] = {1, 1};
        CUresult r = fn(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(k2), dims,
                        strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
        if (r != CUDA_SUCCESS) return ERR_ENCODE + (int)r;
    }
    Args g = {};
    g.bias = (const float*)bias;
    g.out = (bf16*)out;
    g.part = (float*)part;
    g.H = H;
    g.W = W;
    g.C = C;
    g.tiles_h = (H + TH - 1) / TH;
    g.tiles_w = (W + TW - 1) / TW;
    cudaError_t e = cudaFuncSetAttribute(subpixel_up_conv3x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    const long long work = (long long)N * g.tiles_h * g.tiles_w * (C / NC) * 2;
    if (work > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    g.work = (int)work;
    int dev = 0, sms = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const int grid = g.work < sms ? g.work : sms;  // one persistent CTA per SM
    subpixel_up_conv3x3_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(xmap, wmap, g);
    return (int)cudaGetLastError();
}
