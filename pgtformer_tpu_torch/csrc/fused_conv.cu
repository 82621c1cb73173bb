// Fused GroupNorm-affine + SiLU + conv3x3 of the decoder's per-frame tail
// (K7), Hopper (sm_90a), bf16 operands, fp32 accumulation.
//
// Replaces the TPU kernel pgtformer_tpu/ops/pallas_conv.py:gn_silu_conv3x3
// (_gsc_kernel).  Its partner in the chain, the subpixel upsample (K8), is
// csrc/subpixel_up.cu.
//
// gn_silu_conv3x3:  out = conv3x3(silu(x*a + b)) + bias [+ xs @ sk + sb] [+ res]
//   x [N,H,W,C] bf16 (batch stride given), a/b [N,C] fp32 (null: plain conv),
//   k [3,3,C,64] bf16, xs [N,H,W,Cs] bf16, sk [Cs,64] bf16, res [N,H,W,64]
//   bf16.  The affine and SiLU run in fp32 and round to bf16; the conv's zero
//   padding applies AFTER the activation (silu(b) != 0), in rows and columns;
//   taps, bias, shortcut and residual add in fp32 and round once.  It can emit
//   per-(sample, channel) (sum, sum of squares) of its ROUNDED bf16 output,
//   the statistics of the next GroupNorm in the chain.
//
// The TPU kernel walks row blocks in grid order, carries the top halo row in
// scratch memory and accumulates the statistics across grid steps.  A CUDA
// grid has no order, so here every pixel tile is read with a one-pixel halo
// on all four sides, and its partial statistics go to part[n][tile * 3 +
// warpgroup][2][64]; the caller sums them (no atomics: two launches are
// bit-equal).
//
// What bounds it on an H100: at 512x512 x 8 frames the 128->64 conv is bound
// by operations (3.1e11 FLOP against 0.8 GB), the 64->64 forms by bytes.  The
// whole 3x3 kernel fits in a CTA (144 KB at C=128, 72 KB at C=64, + 16 KB for
// the 1x1 shortcut), so unlike K8 the weights are read from L2 once per CTA
// and stay resident; what is streamed is the input.  Inside the CTA the
// products are bound by shared-memory reads: a wgmma m64n64k16 reads 2 KB of
// B and its A fragments 2 KB by ldmatrix, 32 cycles of the SM's 128 B/cycle
// against 32 cycles of tensor-core work, so the design aims at about half
// the tensor peak.  The activation is the other cost: one exp2 and one
// reciprocal on the MUFU per input element, ~350 M elements with the halo
// at 128->64.
//
// Design: a work item is a 12 x 16 pixel tile x 64 output channels; one
// persistent CTA per SM (512 threads, 128 registers each) walks the tiles
// with three consumer warpgroups and a fourth warpgroup of three activation
// warps and one producer warp.
//  * Producer: one thread issues every TMA load.  First the weights,
//    resident for the CTA's life: k as a 2-D map over [9C, 64] in 64 x 64
//    tiles (8 KB, 128-byte swizzle; 9C/64 tiles) and sk likewise, behind one
//    mbarrier, in the layout wgmma reads B from (MN-major, as K8's B).  Then,
//    per tile, its input slices through a ring of 4 slots with full,
//    activated and empty mbarriers: per KS input channels the 14 x 18 halo
//    box (a 4-D map (C, W, H, N) with the batch stride x_sn, so a strided
//    view takes no copy; rows and columns outside the image arrive as
//    zeros), then per 64 shortcut channels the 12 x 16 box of xs.  KS is 64
//    (128-byte rows, 128-byte swizzle) at C=64 and 32 (64-byte rows, 64-byte
//    swizzle) at C=128, where the resident weights leave room for four slots
//    only at half the depth.  Plan<C, CS> works out the carve-up per form.
//  * Activation warps: rewrite each halo slice in place,
//    silu(x*a[n,c] + b[n,c]) in fp32 rounded to bf16, and 0 for a pixel
//    outside the image (the conv pads the ACTIVATED tensor: TMA's zero fill
//    alone would give silu(b)).  The box is swizzled: a 16-byte chunk's
//    channels are its physical index XOR bits of its byte offset
//    (swz_chunk).  Each thread keeps one logical chunk, so it loads its 8 a
//    and 8 b once per slice, and takes three chunks at a time through each
//    stage of the SiLU, so one warp per SMSP keeps the MUFU busy.  They run
//    on slot s+1 while the consumers multiply slot s.
//  * Consumer warpgroups 0..2 each own 4 tile rows (64 pixels) x 64 output
//    channels: one m64n64 fp32 accumulator, 32 registers a thread; three
//    warpgroups keep three independent product chains in flight (one chain
//    is latency-bound at ~20% of the tensor cores, PERF.md PR 5).  Per
//    slice, for each of the nine taps (di, dj) a warp loads its 16 pixels'
//    A fragments by ldmatrix, one row address per pixel (halo pixel
//    (row + di, col + dj): the shift costs nothing, and the swizzle keeps the
//    reads free of bank conflicts), and feeds them to wgmma m64n64k16 with B
//    from the resident weight rows of that tap and slice.  The A fragments
//    are double-buffered: the next tap's ldmatrix runs while this tap's
//    products do.  The shortcut's slices add a K=Cs chain into the same
//    accumulator; the residual is requested before the products.
//  * Epilogue, from the fragments: bias (+ sb) and the residual in fp32, one
//    rounding; a 4 x 4 transpose within each quad of lanes turns the
//    fragment's 4-byte pieces into 16-byte stores; and the (sum, sumsq) of
//    the rounded values, one partial per (tile, consumer warpgroup), summed
//    over the warpgroup's warps in a fixed order, so the warpgroups never
//    wait for each other.  Meanwhile the producer and the activation warps
//    already fill the next tile's slots.
//  * Ordering: every generic-proxy access to a slot (the activation's
//    in-place writes, the consumers' ldmatrix reads) is followed by
//    fence.proxy.async.shared::cta before the slot's release to the next
//    TMA refill (without it K8 computed wrong outputs).  A ring wait that
//    lasts 10 s traps, so a broken protocol fails the launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NCONS = 3;                   // consumer warpgroups, 4 tile rows each
constexpr int TH = 4 * NCONS;              // tile rows
constexpr int TW = 16;                     // tile columns (one warp's 16 A rows)
constexpr int XH = TH + 2, XW = TW + 2;    // the halo box
constexpr int KC = 64;                     // rows of a weight tile; shortcut slice channels
constexpr int NC = 64;                     // output channels
constexpr int ACT_WARPS = 3;               // activation warps; the fourth warp of their
constexpr int THREADS = 128 * (NCONS + 1); // warpgroup is the producer
constexpr int ACT_BATCH = 3;               // chunks an activation thread takes at once
constexpr int SMEM_MAX = 232448;
constexpr uint32_t TILE_BYTES = KC * NC * 2;             // one 64 x 64 weight tile
constexpr uint32_t SC_TX = TH * TW * KC * 2;             // bytes a shortcut slice's box moves
constexpr uint32_t STATS_BYTES = NCONS * 4 * 2 * NC * 4;  // [consumer warps][2][64] fp32
constexpr int STAGES = 4;                  // slots of the input ring

// The 16-byte chunk at which a TMA box row of `rowb` bytes (64 or 128, the
// swizzle's span) keeps logical chunk c of its pixel p: the swizzle XORs the
// chunk index with bits 7.. of the byte offset.
__host__ __device__ constexpr int swz_chunk(int p, int c, int rowb) {
    return c ^ ((p * rowb >> 7) & (rowb / 16 - 1));
}

// The shared-memory carve-up of one form (C input channels, CS shortcut
// channels), from a 1024-byte aligned base: resident weight tiles, the
// shortcut's, the input ring, the warps' statistics, the barriers (the
// weights', then full, activated and empty per slot), and the slack that
// aligns the base.
template <int C, int CS>
struct Plan {
    // channels of a halo slice: 32 at C=128, where the resident weights
    // leave room for four slots only at half the depth (a 64-byte row,
    // 64-byte swizzle); else 64 (a 128-byte row, 128-byte swizzle)
    static constexpr int KS = C > 64 ? 32 : 64;
    static constexpr int ROWB = KS * 2;
    static constexpr uint32_t HALO_TX = XH * XW * ROWB;   // bytes a halo slice's box moves
    static constexpr uint32_t SLOT_TX = CS > 0 && SC_TX > HALO_TX ? SC_TX : HALO_TX;
    static constexpr uint32_t SLOT_BYTES = (SLOT_TX + 1023) / 1024 * 1024;
    static constexpr int SLICES = C / KS;         // halo slices per tile
    static constexpr int SC_SLICES = CS / KC;     // shortcut slices per tile
    static constexpr uint32_t OFF_W = 0;
    static constexpr uint32_t OFF_SK = OFF_W + 9 * (C / KC) * TILE_BYTES;
    static constexpr uint32_t OFF_X = OFF_SK + SC_SLICES * TILE_BYTES;
    static constexpr uint32_t OFF_STATS = OFF_X + STAGES * SLOT_BYTES;
    static constexpr uint32_t OFF_BAR = OFF_STATS + STATS_BYTES;
    static constexpr uint32_t SMEM = OFF_BAR + (1 + 3 * STAGES) * 8 + 1024;
    static_assert(C % KC == 0 && CS % KC == 0, "weights in tiles of 64 rows");
    static_assert(SMEM <= SMEM_MAX, "shared memory");
    static_assert(OFF_X % 1024 == 0 && SLOT_BYTES % 1024 == 0, "swizzle atoms");
    static_assert(KS * 2 == ROWB && (ROWB == 64 || ROWB == 128), "a swizzle span");
};

struct Args {
    const float* a;     // [N, C] or null (no activation)
    const float* b;
    const float* bias;  // [64]
    const float* sb;    // [64] or null
    const bf16* res;    // [N, H, W, 64] or null
    bf16* out;          // [N, H, W, 64]
    float* part;        // [N, tiles, 2, 64] or null
    int H, W, tiles_h, tiles_w, total;
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

// Order this thread's generic-proxy accesses to shared memory before later
// async-proxy (TMA) ones.
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
    uint4 v;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(addr));
    return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
                 "r"(v.z), "r"(v.w)
                 : "memory");
}

// silu(x*a + b) on NV chunks of 8 packed bf16 values (channels 8 lc ..
// 8 lc + 7 each), in fp32, rounded to bf16: y / (1 + 2^(-y log2 e)) with the
// MUFU's exp2 and reciprocal, each stage over all 8 NV values before the
// next, so that one warp per SMSP keeps the MUFU busy.
template <int NV>
__device__ __forceinline__ void affine_silu(uint4 (&v)[NV], const float (&a)[8],
                                            const float (&b)[8]) {
    float y[NV][8], e[NV][8];
#pragma unroll
    for (int u = 0; u < NV; ++u) {
        const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            y[u][2 * j] = fmaf(__uint_as_float(w[j] << 16), a[2 * j], b[2 * j]);
            y[u][2 * j + 1] =
                fmaf(__uint_as_float(w[j] & 0xffff0000u), a[2 * j + 1], b[2 * j + 1]);
        }
    }
#pragma unroll
    for (int u = 0; u < NV; ++u)
#pragma unroll
        for (int j = 0; j < 8; ++j)
            asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e[u][j]) : "f"(y[u][j] * -1.44269504f));
#pragma unroll
    for (int u = 0; u < NV; ++u)
#pragma unroll
        for (int j = 0; j < 8; ++j)
            asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(e[u][j]) : "f"(1.0f + e[u][j]));
#pragma unroll
    for (int u = 0; u < NV; ++u) {
        uint32_t o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const __nv_bfloat162 r = __floats2bfloat162_rn(y[u][2 * j] * e[u][2 * j],
                                                           y[u][2 * j + 1] * e[u][2 * j + 1]);
            o[j] = *reinterpret_cast<const uint32_t*>(&r);
        }
        v[u] = make_uint4(o[0], o[1], o[2], o[3]);
    }
}

// Tile t -> (sample, first row, first column).
struct Tile {
    int n, h0, w0;
};

__device__ __forceinline__ Tile decode(int t, const Args& g) {
    const int tiles_img = g.tiles_h * g.tiles_w;
    Tile k;
    k.n = t / tiles_img;
    const int ti = t - k.n * tiles_img;
    k.h0 = (ti / g.tiles_w) * TH;
    k.w0 = (ti % g.tiles_w) * TW;
    return k;
}

// One tap of a slice for a consumer warp: load the A fragments of its 16
// pixels (halo pixel `pix` of the slot at `xs`) into A, release the slot
// after its last read if `release`, and issue the four k16 products with
// the weight rows at descriptor `db`.  Waits for the products issued before, which read
// `other`, so that the next tap may load into it.
template <int ROWB>
__device__ __forceinline__ void tap_mma(float (&acc)[32], uint32_t (&A)[4][4],
                                        uint32_t (&other)[4][4], uint32_t xs, int pix, int khalf,
                                        uint64_t db, bool release, uint64_t* empty, int lane) {
    constexpr int NK16 = ROWB / 32;  // k16 steps in a box row
    // pixel `pix` of the box: one ROWB-byte row whose 16-byte chunks the
    // TMA swizzled
    const uint32_t prow = xs + pix * ROWB;
#pragma unroll
    for (int k16 = 0; k16 < NK16; ++k16)
        ldsm_x4(A[k16], prow + (swz_chunk(pix, k16 * 2 + khalf, ROWB) << 4));
    if (release) {
        // order these generic-proxy reads before the TMA's (async-proxy)
        // refill of the slot: without it the refill can overtake them
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(empty);
    }
    wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < NK16; ++k16) wgmma_rs_n64(acc, A[k16], db + ((k16 * 16 * 128) >> 4));
    wgmma_commit();
    wgmma_wait<1>();
    fence_a(A);
    fence_a(other);
}

template <int C, int CS, bool RES>
__global__ void __launch_bounds__(THREADS, 1)
    gn_silu_conv3x3_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap wmap,
                           const __grid_constant__ CUtensorMap xsmap,
                           const __grid_constant__ CUtensorMap skmap, const Args g) {
    typedef Plan<C, CS> P;
    constexpr int S = STAGES;
    constexpr int SLICES = P::SLICES, SC_SLICES = P::SC_SLICES;
    constexpr int KS = P::KS, ROWB = P::ROWB;
    constexpr int WTILES = 9 * (C / KC);  // resident 64 x 64 tiles of k
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    // TMA swizzle and the wgmma descriptors assume 1024-byte aligned tiles
    // (offset from the array itself, so the compiler keeps shared loads)
    unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
    uint64_t* wbar = reinterpret_cast<uint64_t*>(smem + P::OFF_BAR);
    uint64_t* full = wbar + 1;
    uint64_t* act = full + S;
    uint64_t* empty = act + S;
    const int wg = threadIdx.x / 128;

    if (threadIdx.x == 0) {
        mbar_init(wbar, 1);
        for (int s = 0; s < S; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&act[s], ACT_WARPS);         // lane 0 of every activation warp
            mbar_init(&empty[s], NCONS * 4);       // lane 0 of every consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // a persistent CTA per SM walks the tiles t = blockIdx.x, + gridDim.x,
    // ...; every role walks the same slices (a tile's halo slices, then its
    // shortcut slices) through the same ring slots
    if (threadIdx.x >= NCONS * 128 + ACT_WARPS * 32) {
        // ---- producer: one thread issues every TMA load ----
        if (threadIdx.x == NCONS * 128 + ACT_WARPS * 32) {
            mbar_expect_tx(wbar, (WTILES + SC_SLICES) * TILE_BYTES);
            for (int i = 0; i < WTILES; ++i)  // tile i: rows 64 i .. 64 i + 63 of k
                tma_load_2d(smem + P::OFF_W + i * TILE_BYTES, &wmap, wbar, 0, i * KC);
            for (int i = 0; i < SC_SLICES; ++i)
                tma_load_2d(smem + P::OFF_SK + i * TILE_BYTES, &skmap, wbar, 0, i * KC);
            int slot = 0;
            uint32_t ph = 0;
            for (int t = blockIdx.x; t < g.total; t += gridDim.x) {
                const Tile k = decode(t, g);
                for (int kc = 0; kc < SLICES + SC_SLICES; ++kc) {
                    mbar_wait(&empty[slot], ph ^ 1);
                    unsigned char* dst = smem + P::OFF_X + slot * P::SLOT_BYTES;
                    if (kc < SLICES) {
                        mbar_expect_tx(&full[slot], P::HALO_TX);
                        tma_load_4d(dst, &xmap, &full[slot], kc * KS, k.w0 - 1, k.h0 - 1, k.n);
                    } else {
                        mbar_expect_tx(&full[slot], SC_TX);
                        tma_load_4d(dst, &xsmap, &full[slot], (kc - SLICES) * KC, k.w0, k.h0,
                                    k.n);
                    }
                    if (++slot == S) {
                        slot = 0;
                        ph ^= 1;
                    }
                }
            }
        }
        return;
    }

    if (wg == NCONS) {
        // ---- activation warps: rewrite each halo slice in place ----
        const int at = threadIdx.x - NCONS * 128;
        const int lane = at & 31;
        // this thread's logical chunk (channels 8 lc .. 8 lc + 7 of the
        // slice) and first pixel; a warp covers 512 contiguous bytes of the
        // box, conflict-free
        constexpr int CPP = KS / 8;                   // chunks per pixel
        constexpr int STRIDE = ACT_WARPS * 32 / CPP;  // pixels between a thread's chunks
        constexpr int NIT = (XH * XW + STRIDE - 1) / STRIDE;
        const int lc = at % CPP, p0 = at / CPP;
        int slot = 0;
        uint32_t ph = 0;
        for (int t = blockIdx.x; t < g.total; t += gridDim.x) {
            const Tile k = decode(t, g);
            for (int kc = 0; kc < SLICES + SC_SLICES; ++kc) {
                mbar_wait(&full[slot], ph);
                if (kc < SLICES && g.a != nullptr) {
                    const long long c0 = (long long)k.n * C + kc * KS + lc * 8;
                    const float4 a0 = __ldg(reinterpret_cast<const float4*>(g.a + c0));
                    const float4 a1 = __ldg(reinterpret_cast<const float4*>(g.a + c0) + 1);
                    const float4 b0 = __ldg(reinterpret_cast<const float4*>(g.b + c0));
                    const float4 b1 = __ldg(reinterpret_cast<const float4*>(g.b + c0) + 1);
                    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
                    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
                    const uint32_t base = smem_u32(smem + P::OFF_X + slot * P::SLOT_BYTES);
                    // NIT pixels a thread, in batches of ACT_BATCH chunks
                    // loaded together, so one warp per SMSP keeps the MUFU busy
#pragma unroll
                    for (int i0 = 0; i0 < NIT; i0 += ACT_BATCH) {
                        uint4 v[ACT_BATCH];
#pragma unroll
                        for (int u = 0; u < ACT_BATCH; ++u) {
                            const int p = p0 + STRIDE * (i0 + u);
                            v[u] = make_uint4(0u, 0u, 0u, 0u);
                            if (i0 + u < NIT && p < XH * XW)
                                v[u] = lds128(base + p * ROWB + (swz_chunk(p, lc, ROWB) << 4));
                        }
                        affine_silu(v, av, bv);
#pragma unroll
                        for (int u = 0; u < ACT_BATCH; ++u) {
                            const int p = p0 + STRIDE * (i0 + u);
                            const int hr = p / XW, hc = p - hr * XW;
                            const int hh = k.h0 - 1 + hr, ww = k.w0 - 1 + hc;
                            // outside the image: the conv's padding, after the SiLU
                            if (!(hh >= 0 && hh < g.H && ww >= 0 && ww < g.W))
                                v[u] = make_uint4(0u, 0u, 0u, 0u);
                            if (i0 + u < NIT && p < XH * XW)
                                sts128(base + p * ROWB + (swz_chunk(p, lc, ROWB) << 4), v[u]);
                        }
                    }
                    fence_proxy_async();  // these writes before the slot's next refill
                }
                __syncwarp();
                if (lane == 0) mbar_arrive(&act[slot]);
                if (++slot == S) {
                    slot = 0;
                    ph ^= 1;
                }
            }
        }
        return;
    }

    // ---- consumers: warpgroup wg owns tile rows 4*wg .. 4*wg + 3 ----
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int row = wg * 4 + warp;          // this warp's tile row
    const int pc = lane & 15;               // the pixel column whose A row this lane addresses
    const int khalf = lane >> 4;            // and which 8 of each 16 channels
    const int q = lane % 4, r8 = lane / 4;  // accumulator column pair, row within 8
    const uint32_t xbase = smem_u32(smem + P::OFF_X);
    const uint32_t wbase = smem_u32(smem + P::OFF_W);
    const uint32_t skbase = smem_u32(smem + P::OFF_SK);
    float* wpart = reinterpret_cast<float*>(smem + P::OFF_STATS);
    const bool want_stats = g.part != nullptr;

    float acc[32];
    uint32_t afr[2][4][4];  // A fragments of two taps, [tap % 2][k16]
    int slot = 0;
    uint32_t ph = 0;
    mbar_wait(wbar, 0);
    for (int t = blockIdx.x; t < g.total; t += gridDim.x) {
        const Tile k = decode(t, g);
        const int hh = k.h0 + row;
        // the residual of this lane's outputs, requested before the products
        // that hide its latency (rows and columns clamped into the image:
        // the loads need no branch; the epilogue drops what lies outside)
        uint32_t rv[2][8];
        if (RES) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const long long o =
                    (((long long)k.n * g.H + min(hh, g.H - 1)) * g.W +
                     min(k.w0 + r8 + 8 * half, g.W - 1)) * NC + 2 * q;
#pragma unroll
                for (int i = 0; i < 8; ++i)
                    rv[half][i] = __ldg(reinterpret_cast<const unsigned*>(g.res + o + 8 * i));
            }
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
        for (int kc = 0; kc < SLICES; ++kc) {
            mbar_wait(&full[slot], ph);
            mbar_wait(&act[slot], ph);
            const uint32_t xs = xbase + slot * P::SLOT_BYTES;
#pragma unroll
            for (int tap = 0; tap < 9; ++tap) {
                const int n = kc * 9 + tap;
                const int di = tap / 3, dj = tap % 3;
                // rows kc * KS .. of tap's C x 64 matrix: a whole tile, or
                // its upper or lower 32 rows (four 8-row swizzle atoms)
                const uint32_t wt = wbase + (tap * (C / KC) + kc * KS / KC) * TILE_BYTES +
                                    (kc * KS % KC) * 128;
                tap_mma<ROWB>(acc, afr[n & 1], afr[(n + 1) & 1], xs, (row + di) * XW + pc + dj,
                              khalf, tile_desc(wt), tap == 8, &empty[slot], lane);
            }
            if (++slot == S) {
                slot = 0;
                ph ^= 1;
            }
        }
#pragma unroll
        for (int j = 0; j < SC_SLICES; ++j) {
            mbar_wait(&full[slot], ph);
            mbar_wait(&act[slot], ph);
            const int n = SLICES * 9 + j;
            tap_mma<KC * 2>(acc, afr[n & 1], afr[(n + 1) & 1], xbase + slot * P::SLOT_BYTES,
                            row * TW + pc, khalf, tile_desc(skbase + j * TILE_BYTES), true,
                            &empty[slot], lane);
            if (++slot == S) {
                slot = 0;
                ph ^= 1;
            }
        }
        wgmma_wait<0>();
        fence_acc(acc);

        // ---- epilogue: bias, shortcut bias, residual, one rounding, the
        // write, the statistics of this warpgroup's part of the tile ----
        float bv[16];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            float2 bb = __ldg(reinterpret_cast<const float2*>(g.bias + 8 * i + 2 * q));
            if (CS) {
                const float2 sv = __ldg(reinterpret_cast<const float2*>(g.sb + 8 * i + 2 * q));
                bb.x += sv.x;
                bb.y += sv.y;
            }
            bv[2 * i] = bb.x;
            bv[2 * i + 1] = bb.y;
        }
        float s1[16], s2[16];  // [channel 8 i + 2 q + e at 2 i + e]
#pragma unroll
        for (int i = 0; i < 16; ++i) s1[i] = s2[i] = 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int ww = k.w0 + r8 + 8 * half;
            const bool valid = hh < g.H && ww < g.W;
            uint32_t pk[8];  // channels 8 i + 2 q, + 1 of pixel (row, r8 + 8 half), rounded
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                float v0 = acc[4 * i + 2 * half] + bv[2 * i];
                float v1 = acc[4 * i + 2 * half + 1] + bv[2 * i + 1];
                if (RES) {
                    const float2 f =
                        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv[half][i]));
                    v0 += f.x;
                    v1 += f.y;
                }
                const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
                pk[i] = *reinterpret_cast<const uint32_t*>(&v);
                if (valid) {
                    const float2 f = __bfloat1622float2(v);
                    s1[2 * i] += f.x;
                    s1[2 * i + 1] += f.y;
                    s2[2 * i] += f.x * f.x;
                    s2[2 * i + 1] += f.y * f.y;
                }
            }
            // transpose 4 x 4 words within each quad, twice, so that lane q
            // holds channels 8 q .. 8 q + 7 and 32 + 8 q .. 32 + 8 q + 7: two
            // 16-byte stores a pixel instead of eight 4-byte ones
#pragma unroll
            for (int x = 2; x >= 1; x >>= 1) {
                const bool hi = (q & x) != 0;
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    if (j & x) continue;
                    const uint32_t send = hi ? pk[j] : pk[j + x];
                    const uint32_t got = __shfl_xor_sync(0xffffffffu, send, x);
                    if (hi) pk[j] = got;
                    else pk[j + x] = got;
                }
            }
            if (valid) {
                bf16* o = g.out + (((long long)k.n * g.H + hh) * g.W + ww) * NC + 8 * q;
                *reinterpret_cast<uint4*>(o) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
                *reinterpret_cast<uint4*>(o + 32) = make_uint4(pk[4], pk[5], pk[6], pk[7]);
            }
        }
        if (want_stats) {
            // sum over the 8 lanes of a column pair (lane / 4), then over the
            // warpgroup's warps in order: one partial per (tile, warpgroup),
            // so the warpgroups never wait for each other
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
            named_sync(1 + wg, 128);
            const int kind = tid / NC, ch = tid % NC;
            float sum = 0.f;
#pragma unroll
            for (int w = 0; w < 4; ++w) sum += wpart[((wg * 4 + w) * 2 + kind) * NC + ch];
            g.part[(((long long)t * NCONS + wg) * 2 + kind) * NC + ch] = sum;
            named_sync(1 + wg, 128);  // the next tile may overwrite wpart
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

// An [N, H, W, C] bf16 image (batch stride sn elements) read in boxes of
// bc channels (32 or 64) x bw x bh pixels, swizzled over the box row (64 or
// 128 bytes), zeros outside.
int image_map(EncodeTiled fn, CUtensorMap* map, const void* x, long long sn, int N, int H, int W,
              int C, int bc, int bw, int bh) {
    const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
    const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2, (cuuint64_t)sn * 2};
    const cuuint32_t box[4] = {(cuuint32_t)bc, (cuuint32_t)bw, (cuuint32_t)bh, 1};
    const cuuint32_t estride[4] = {1, 1, 1, 1};
    CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides,
                    box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                    bc == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

// A [rows, 64] bf16 weight matrix read in 64 x 64 tiles, 128-byte swizzle.
int weight_map(EncodeTiled fn, CUtensorMap* map, const void* w, int rows) {
    const cuuint64_t dims[2] = {(cuuint64_t)NC, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)NC * 2};
    const cuuint32_t box[2] = {NC, KC};
    const cuuint32_t estride[2] = {1, 1};
    CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims, strides,
                    box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

template <int C, int CS, bool RES>
int launch_gsc(const void* x, long long x_sn, const void* k, const void* xs, const void* sk,
               Args g, int N, cudaStream_t stream) {
    typedef Plan<C, CS> P;
    EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return ERR_NO_ENCODER;
    CUtensorMap xmap, wmap, xsmap = {}, skmap = {};
    int rc = image_map(fn, &xmap, x, x_sn, N, g.H, g.W, C, P::KS, XW, XH);
    if (rc == 0) rc = weight_map(fn, &wmap, k, 9 * C);
    if (rc == 0 && CS)
        rc = image_map(fn, &xsmap, xs, (long long)g.H * g.W * CS, N, g.H, g.W, CS, KC, TW, TH);
    if (rc == 0 && CS) rc = weight_map(fn, &skmap, sk, CS);
    if (rc != 0) return rc;
    auto kernel = gn_silu_conv3x3_kernel<C, CS, RES>;
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const int grid = g.total < sms ? g.total : sms;  // one persistent CTA per SM
    kernel<<<grid, THREADS, P::SMEM, stream>>>(xmap, wmap, xsmap, skmap, g);
    return (int)cudaGetLastError();
}

bool takes(int C, int Co, int Cs) {
    return Co == NC && ((C == 128 && Cs == 0) || (C == 64 && (Cs == 0 || Cs == 128)));
}

}  // namespace

// Partial statistics per sample of gn_silu_conv3x3 on an H x W image, one
// per (pixel tile, consumer warpgroup): the second extent of its `part`
// buffer.  0 where the kernel does not take the widths.
extern "C" int gn_silu_conv3x3_tiles(int H, int W, int C, int Co, int Cs) {
    return takes(C, Co, Cs) ? NCONS * ((H + TH - 1) / TH) * ((W + TW - 1) / TW) : 0;
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
    if (!takes(C, Co, Cs)) return (int)cudaErrorInvalidValue;
    Args g = {};
    g.a = (const float*)a;
    g.b = (const float*)b;
    g.bias = (const float*)bias;
    g.sb = (const float*)sb;
    g.res = (const bf16*)res;
    g.out = (bf16*)out;
    g.part = (float*)part;
    g.H = H;
    g.W = W;
    g.tiles_h = (H + TH - 1) / TH;
    g.tiles_w = (W + TW - 1) / TW;
    const long long total = (long long)N * g.tiles_h * g.tiles_w;
    if (total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    g.total = (int)total;
    cudaStream_t s = (cudaStream_t)stream;
    if (res != nullptr) {
        if (C == 128) return launch_gsc<128, 0, true>(x, x_sn, k, xs, sk, g, N, s);
        if (Cs) return launch_gsc<64, 128, true>(x, x_sn, k, xs, sk, g, N, s);
        return launch_gsc<64, 0, true>(x, x_sn, k, xs, sk, g, N, s);
    }
    if (C == 128) return launch_gsc<128, 0, false>(x, x_sn, k, xs, sk, g, N, s);
    if (Cs) return launch_gsc<64, 128, false>(x, x_sn, k, xs, sk, g, N, s);
    return launch_gsc<64, 0, false>(x, x_sn, k, xs, sk, g, N, s);
}
