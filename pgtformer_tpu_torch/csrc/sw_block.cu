// Fused shifted-window transformer block for Hopper (sm_90a), bf16 in, bf16
// or fp32 out.
//
// Three entry points over one device function (slab_pass):
//   sw_block_launch        replaces pgtformer_tpu/ops/pallas_attn.py:
//                          _pallas_sw_block_5d (fused_sw_block_5d): windows
//                          read straight from [B, T, H, W, C], shift in-kernel;
//   sw_block_tokens_launch replaces _pallas_sw_block (fused_sw_block_tokens):
//                          the same math on pre-partitioned window tokens
//                          [M, N, C], with the caller's additive mask
//                          [nW, N, N] indexed by window-in-image;
//   sw_block_pair_launch   replaces _pallas_sw_block_pair_5d
//                          (fused_sw_block_pair_5d): blocks [no-shift, shift]
//                          of one layer in one launch (see the pair kernel).
//
// One block computes, for every window of T*wh*ww tokens:
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
// What bounds it on an H100: the block is 12*C^2 + 4*N*C FLOP per token, so
// at C=256/512 it is compute-bound on paper; what the design has to do is
// keep the tensor cores fed.  This design:
//
//  * A slab is 48 token rows (one T=3 window, or three T=1 windows), padded
//    to a 64-row wgmma tile.  A consumer warpgroup owns one slab at a time;
//    a CTA holds nw slabs (2 at C <= 256, 1 at C=512 and in the pair kernel)
//    and a producer warpgroup, which hands its registers to the consumers
//    (ops/sw_block.py:sw_plan lays it out).  CTAs are persistent: one per SM
//    walks groups of nw slabs, and while a slab's fc2 runs, the next slab's
//    rows are already on their way into shared memory.  (A window-aligned
//    unit without padding rows is 192 rows, three tiles, whose A buffers
//    alone would take 192 KB at C=256; and the consumers share every weight
//    box, so they run in step: an order that let one's epilogues overlap the
//    other's products would need the ring to hold a whole phase of boxes.)
//  * Weights reach shared memory only by TMA, as boxes of 64 input columns x
//    64*nb output rows (128-byte swizzle) through a ring of `stages` slots
//    with full/empty mbarriers, so a box leaves L2 once per nw slabs.
//    (Clusters of 2 and 4 CTAs sharing each tile by TMA multicast were
//    slower at every serving shape on an H100; PERF.md keeps the times.)
//  * The four GEMMs (q, k, v a head group at a time, proj, fc1, fc2) run on
//    wgmma m64n(64*nb)k16, nb = 2 where the widths allow: a 64-row A tile
//    (LN1 output, attention output, LN2 output, GELU output) from shared
//    memory in the 128-byte swizzle, B from the ring, the accumulator in
//    registers; two commit groups in flight.  Bias, q scale, erf GELU and
//    the fp32 residual adds are applied from registers in the epilogue, with
//    the bias and residual values requested before the chunk's products.
//  * q/k/v are produced a head group at a time (lcm(hd, 64*nb) columns of
//    each) and the window attention of those heads runs right after on
//    mma.sync m16n8k16, one (16 query rows, head) task per warp at a time
//    over all four warps: scores, softmax and P stay in registers; only q/k/v
//    of the group and the output pass shared memory.
//  * The fp32 residual x1 = x + proj(...) stays out of shared memory: each
//    thread keeps the x1 values of its own accumulator elements in a slice
//    of a scratch array (L2-resident, one slice per consumer warpgroup of the
//    grid), written once by proj's epilogue, read back by LN2 (whose row
//    statistics are shuffles inside each quad of the accumulator layout) and
//    by fc2's epilogue.  That frees the shared memory the weight ring needs;
//    LN2's weight and bias pass through the q/k/v region once it is free.
//  * The slab's input rows arrive by 16-byte cp.async through a per-slab row
//    table (pixel offsets, shift-region labels); the final residual add
//    writes bf16, or with `out_f32` the fp32 sum unrounded, straight to the
//    output.  That is the fp32 form of the TPU kernels: they round their
//    input to bf16 (_pallas_sw_block_5d's xb = x.astype(bfloat16); the
//    wrapper does the same here) and store the fp32 result in x.dtype.  The
//    output is never staged in shared memory, so its element size changes no
//    part of the carve-up.
//  * Slabs past the input (a ragged last group) run on zeros and write
//    nothing.
// Built with -DSW_PROBE, CTA 0 counts the clock cycles of each phase of its
// slab passes (pgtformer_tpu_torch/probe_sw_block.py).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int SLAB = 48;                  // token rows per consumer warpgroup
constexpr int TILE = 64;                  // weight box: 64 input columns x 64*nb output rows
constexpr int TILE_BYTES = TILE * TILE * 2;   // a box's bytes per 64 output rows
constexpr int CHUNK_BYTES = SLAB * 128;   // one 64-column chunk of an A buffer
constexpr int MAX_NW = 2;
constexpr int ROW_TABLE = 768;            // per slab: 64 int labels, 64 int64 row offsets
constexpr int X1_THREADS = SLAB / 16 * 32;   // threads of a warpgroup whose rows are real
constexpr int STATIC_SMEM = 512;          // static shared memory a kernel may add

struct SWArgs {
    const bf16* x;
    void* out;          // bf16, or fp32 with out_f32
    float* x1s;         // fp32 scratch: X1_THREADS * C / 2 per consumer warpgroup of the grid
    int out_f32;
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
    const float* mask;  // token entry only: additive [nW, N, N], or null
    int nW;             // token entry only: windows per image
    int B, T, H, W, C, heads, hd, wh, ww, sh, sw, N, nWh, nWw, nwin;
    int nslab;          // slabs of SLAB rows: ceil(nwin * N / SLAB)
    float scale;
    // plan (ops/sw_block.py:sw_plan): slabs per CTA, ring slots, head-group
    // width, product width in 64-column tiles, and the shared-memory carve-up
    // in bytes from the 1024-aligned base: slab s's A, B and X regions at
    // off_slab + s * slab_bytes + {0, off_b, off_x}; two row tables per slab
    // and the barriers at off_lab, off_bar
    int nw, stages, gw, nb, off_slab, slab_bytes, off_b, off_x, off_lab, off_bar, smem;
};

struct Maps {
    CUtensorMap w[6];   // wq, wk, wv, wp, w1, w2: (C, C) bf16, box (64, 64 * nb)
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
    // start of the wait in units of 2^20 ns (9537 of them are 10 s), 0 before
    // it is read: a 32-bit clock keeps the wait to few registers
    uint32_t t0 = 0;
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

// Rows [row, row + box rows) x columns [col, col + 64) of a weight into dst.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int row) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row)
        : "memory");
}

// wgmma descriptor of a K-major operand in the 128-byte swizzle: rows of
// 128 bytes, 8-row atoms 1024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
    uint64_t d = (addr & 0x3FFFF) >> 4;
    d |= (uint64_t)1 << 16;
    d |= (uint64_t)(1024 >> 4) << 32;
    d |= (uint64_t)1 << 62;
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
template <int NB>
__device__ __forceinline__ void fence_regs(float (&d)[32 * NB]) {
#pragma unroll
    for (int i = 0; i < 32 * NB; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 64*NB] += A.B^T, A and B K-major from shared memory.
template <int NB>
__device__ __forceinline__ void wgmma(float (&d)[32 * NB], uint64_t da, uint64_t db) {
    if constexpr (NB == 1) {
        asm volatile(
            "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
            " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
            "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
            "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
            "%30, %31}, "
            "%32, %33, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31])
            : "l"(da), "l"(db), "r"(1));
    } else {
        asm volatile(
            "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
            " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
            "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
            "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
            "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
            "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
            "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
            "%60, %61, %62, %63}, "
            "%64, %65, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
              "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
              "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
              "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
              "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
            : "l"(da), "l"(db), "r"(1));
    }
}

__device__ __forceinline__ void named_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// mma.sync m16n8k16 bf16 -> fp32, and the ldmatrix loads that feed it.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r0), "=r"(r1)
                 : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r0), "=r"(r1)
                 : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// ------------------------------------------------------- optional probe
// Built with -DSW_PROBE (pgtformer_tpu_torch/probe_sw_block.py), thread 0 of
// CTA 0 adds the clock cycles of each phase of its slab passes to counters
// in shared memory, and adds them to g_probe when its passes are done
// (g_probe[15]: the passes counted); the normal build has none of it.
#ifdef SW_PROBE
__device__ unsigned long long g_probe[24];
__shared__ unsigned long long s_probe[24];
#define PROBE_DECL unsigned long long probe_t = clock64();
#define PROBE(i)                                                   \
    do {                                                           \
        if (blockIdx.x == 0 && threadIdx.x == 0) {                 \
            const unsigned long long t = clock64();                \
            s_probe[i] += t - probe_t;                             \
            probe_t = t;                                           \
        }                                                          \
    } while (0)
#define PROBE_COUNT(i, n)                                          \
    do {                                                           \
        if (blockIdx.x == 0 && threadIdx.x == 0) s_probe[i] += n;  \
    } while (0)
#define PROBE_SPAN unsigned long long probe_s = clock64();
#define PROBE_SPAN_END(i) PROBE_COUNT(i, clock64() - probe_s)
#else
#define PROBE_DECL
#define PROBE(i) \
    do {         \
    } while (0)
#define PROBE_COUNT(i, n) \
    do {                  \
    } while (0)
#define PROBE_SPAN
#define PROBE_SPAN_END(i) PROBE_COUNT(i, 0)
#endif

// ------------------------------------------------------------ addressing

// Element offset of token n of window `win`: row win*N+n of the [M*N, C]
// token array, or the (shifted) pixel of the [B, T, H, W, C] array.
template <bool TOKENS>
__device__ __forceinline__ long long pix_offset(const SWArgs& a, int win, int n) {
    if (TOKENS) return ((long long)win * a.N + n) * a.C;
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

// Byte offset of (row, col) in an A buffer: 64-column chunks of 48 rows x
// 128 bytes in the 128-byte swizzle (16-byte unit (col/8) ^ (row%8)).  A
// 64-row wgmma tile of chunk k reads rows 48..63 from chunk k+1 (or, after
// the last chunk, from the slab's next region): rows of padding, whose
// products are dropped.
__device__ __forceinline__ int aoff(int row, int col) {
    return (col >> 6) * CHUNK_BYTES + row * 128 + ((((col >> 3) & 7) ^ (row & 7)) << 4) +
           (col & 7) * 2;
}

// ------------------------------------------------------------- weight ring

struct Ring {
    unsigned char* slots;   // stages x nb * TILE_BYTES, 1024-aligned
    uint64_t* full;
    uint64_t* empty;
    int stages;
    uint32_t it;            // slots consumed (consumer) or issued (producer)
};

// Every weight box of one slab pass, in the order the consumers use them:
// q, k, v of head group 0, ..., of the last group; then proj, fc1, fc2.
// f(matrix 0..5, first output row, first input column).
template <int NB, typename F>
__device__ __forceinline__ void for_each_box(const SWArgs& a, F f) {
    constexpr int W = TILE * NB;
    const int nk = a.C / TILE;
    for (int g = 0; g < a.C / a.gw; ++g)
        for (int m = 0; m < 3; ++m)
            for (int nc = 0; nc < a.gw / W; ++nc)
                for (int kc = 0; kc < nk; ++kc) f(m, g * a.gw + nc * W, kc * TILE);
    for (int m = 3; m < 6; ++m)
        for (int nc = 0; nc < a.C / W; ++nc)
            for (int kc = 0; kc < nk; ++kc) f(m, nc * W, kc * TILE);
}

// The producer's share of one slab pass: every box into the ring.
template <int NB>
__device__ __forceinline__ void produce_pass(const SWArgs& a, const Maps& maps, Ring& ring) {
    for_each_box<NB>(a, [&](int m, int n0, int k0) {
        const int s = ring.it % ring.stages;
        mbar_wait(&ring.empty[s], ((ring.it / ring.stages) & 1) ^ 1);
        mbar_expect_tx(&ring.full[s], NB * TILE_BYTES);
        tma_load(ring.slots + s * NB * TILE_BYTES, &maps.w[m], &ring.full[s], k0, n0);
        ++ring.it;
    });
}

// This warp is done with slot s.
__device__ __forceinline__ void release(Ring& ring, int s, int lane) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&ring.empty[s]);
}

// One k-step of a chunk: acc += A[:, 64kc : 64kc + 64] . W-slot^T with the
// ring's next slot (4 wgmma k16, one commit group).  Returns the slot, which
// stays held until the group is known to be done.
template <int NB>
__device__ __forceinline__ int kstep(float (&acc)[32 * NB], uint32_t abase, int kc, Ring& ring) {
    constexpr uint32_t SB = NB * TILE_BYTES;
    const uint32_t slots = smem_u32(ring.slots);
    const int s = ring.it % ring.stages;
    {
        PROBE_SPAN
        mbar_wait(&ring.full[s], (ring.it / ring.stages) & 1);
        PROBE_SPAN_END(8);
    }
    PROBE_SPAN
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
        wgmma<NB>(acc, smem_desc(abase + kc * CHUNK_BYTES + kk * 32),
                  smem_desc(slots + s * SB + kk * 32));
    wgmma_commit();
    PROBE_SPAN_END(9);
    ++ring.it;
    return s;
}

// Wait until at most N commit groups are in flight (probe counter I).
template <int N, int I>
__device__ __forceinline__ void wait_products() {
    PROBE_SPAN
    wgmma_wait<N>();
    PROBE_SPAN_END(I);
}

// A GEMM of nch chunks over one A buffer (abase): chunk c is
// acc = A[64 x C] . W_c^T with W_c the next C/64 slots of the ring (64*NB
// output columns), two commit groups in flight, each k-step releasing the
// slot of the one before once that is done.  pre(c) requests what chunk c's
// epilogue reads, before its products hide the latency; epi(c, acc)
// consumes the accumulator (probe counter I).
template <int NB, int I, typename Pre, typename Epi>
__device__ __forceinline__ void gemm(int nch, uint32_t abase, int nk, Ring& ring, int lane,
                                     Pre pre, Epi epi) {
    float acc[32 * NB];
    for (int c = 0; c < nch; ++c) {
        pre(c);
#pragma unroll
        for (int i = 0; i < 32 * NB; ++i) acc[i] = 0.f;
        int s = kstep<NB>(acc, abase, 0, ring);
        for (int kc = 1; kc < nk; ++kc) {
            const int sp = s;
            s = kstep<NB>(acc, abase, kc, ring);
            wait_products<1, 14>();
            release(ring, sp, lane);
        }
        wait_products<0, 10>();
        fence_regs<NB>(acc);
        release(ring, s, lane);
        PROBE_SPAN
        epi(c, acc);
        PROBE_SPAN_END(I);
    }
}

// Hand every element of this thread's accumulator rows (r0 and r0 + 8,
// both < SLAB or neither) to f(row, 0 or 1, j, col, v0, v1) as pairs of
// adjacent columns col = 8j + 2*(lane%4) of the chunk.
template <int NB, typename F>
__device__ __forceinline__ void epilogue(const float (&acc)[32 * NB], int warp, int lane, F f) {
    const int r0 = warp * 16 + (lane >> 2);
    const int c0 = 2 * (lane & 3);
    if (r0 >= SLAB) return;   // warp 3: rows of padding only
#pragma unroll
    for (int j = 0; j < 8 * NB; ++j) {
        f(r0, 0, j, 8 * j + c0, acc[4 * j], acc[4 * j + 1]);
        f(r0 + 8, 1, j, 8 * j + c0, acc[4 * j + 2], acc[4 * j + 3]);
    }
}

// A vector's values at this thread's epilogue columns of the chunk at c0,
// loaded before the chunk's GEMM so that their latency hides behind it.
template <int NB>
__device__ __forceinline__ void chunk_vec(float2 (&v)[8 * NB], const float* p, int c0, int lane) {
#pragma unroll
    for (int j = 0; j < 8 * NB; ++j)
        v[j] = *reinterpret_cast<const float2*>(p + c0 + 8 * j + 2 * (lane & 3));
}

// LN1 of the slab's raw rows (bf16 [SLAB, C] at rb) into the A buffer ra,
// a warp per row, lane l holding columns 64k + 2l and 64k + 2l + 1 (NK = C /
// 64 chunks): the sum of each lane's values in k order, then a butterfly
// over the lanes (warp_sum), for the mean and then the squared deviations.
template <int NK>
__device__ __forceinline__ void ln1_rows(const SWArgs& a, const unsigned char* rb,
                                         unsigned char* ra, int warp, int lane) {
    constexpr int C = NK * 64;
    float2 w[NK], b[NK];
#pragma unroll
    for (int k = 0; k < NK; ++k) {
        w[k] = *reinterpret_cast<const float2*>(a.ln1w + k * 64 + lane * 2);
        b[k] = *reinterpret_cast<const float2*>(a.ln1b + k * 64 + lane * 2);
    }
#pragma unroll 2
    for (int row = warp; row < SLAB; row += 4) {
        const bf16* src = reinterpret_cast<const bf16*>(rb) + row * C;
        float v[2 * NK];
#pragma unroll
        for (int k = 0; k < NK; ++k) {
            const float2 f =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + k * 64 + lane * 2));
            v[2 * k] = f.x;
            v[2 * k + 1] = f.y;
        }
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < NK; ++k) sum += v[2 * k] + v[2 * k + 1];
        const float mean = warp_sum(sum) / C;
        float q = 0.f;
#pragma unroll
        for (int k = 0; k < NK; ++k) {
            const float d0 = v[2 * k] - mean, d1 = v[2 * k + 1] - mean;
            q += d0 * d0 + d1 * d1;
        }
        const float rstd = rsqrtf(warp_sum(q) / C + 1e-6f);
#pragma unroll
        for (int k = 0; k < NK; ++k) {
            const float y0 = (v[2 * k] - mean) * rstd * w[k].x + b[k].x;
            const float y1 = (v[2 * k + 1] - mean) * rstd * w[k].y + b[k].y;
            *reinterpret_cast<__nv_bfloat162*>(ra + aoff(row, k * 64 + lane * 2)) =
                __floats2bfloat162_rn(y0, y1);
        }
    }
}

__device__ __forceinline__ void ln1(const SWArgs& a, const unsigned char* rb, unsigned char* ra,
                                    int warp, int lane) {
    switch (a.C / 64) {
#define SW_LN1(NK) \
    case NK: return ln1_rows<NK>(a, rb, ra, warp, lane);
        SW_LN1(1) SW_LN1(2) SW_LN1(3) SW_LN1(4) SW_LN1(5) SW_LN1(6) SW_LN1(7) SW_LN1(8)
#undef SW_LN1
    }
}

// The sum over a row of the partials that lanes 4m + q (m < 8) of a warp
// holding the row as ln1_rows does would have, p[m], with q = lane % 4 of
// this thread's quad (whose four threads share the row): warp_sum's
// butterfly, its steps 16, 8 and 4 inside the thread, 2 and 1 across the
// quad.
__device__ __forceinline__ float lane_tree(const float (&p)[8]) {
    const float r0 = (p[0] + p[4]) + (p[2] + p[6]);
    const float r1 = (p[1] + p[5]) + (p[3] + p[7]);
    float s = r0 + r1;
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    return s + __shfl_xor_sync(0xffffffffu, s, 1);
}

// Window attention of the heads of group g: tasks of (16 query rows, head),
// warp w taking tasks w, w + 4, ... (a 16-row tile lies in one window since
// N is 16 or 48).  q, k and v of the group are [SLAB, ld] bf16 (q already
// scaled); the output goes into the A buffer `ybuf` at columns h*HD.. of
// each head.
template <int N, int HD, bool TOKENS>
__device__ __forceinline__ void attend_group(const SWArgs& a, int slab, int g, const bf16* qs,
                                             const bf16* ks, const bf16* vs, int ld,
                                             unsigned char* ybuf, const int* lab, int warp,
                                             int lane) {
    constexpr int NT = N / 8;     // key tiles of 8
    constexpr int DT = HD / 8;    // output tiles of 8
    constexpr int RT = SLAB / 16; // query tiles of 16 rows
    const bool masked = !TOKENS && (a.sh > 0 || a.sw > 0);
    const int g4 = lane >> 2, c2 = 2 * (lane & 3);
    const int hpg = a.gw / HD;    // heads of the group
    const int ntask = RT * hpg;
    for (int task = warp; task < ntask; task += 4) {
        const int rt = task % RT;
        const int h = g * hpg + task / RT;
        const int kb = (16 * rt / N) * N;             // first row of this tile's window
        const int win = slab * (SLAB / N) + 16 * rt / N;
        const float* mwin =
            (TOKENS && a.mask) ? a.mask + (long long)(win % a.nW) * N * N : nullptr;
        const int i0 = 16 * rt + g4 - kb;             // query rows i0 and i0 + 8 of the window
        const int hoff = h * HD - g * a.gw;
        // relative bias (and the caller's mask) of this thread's scores,
        // requested before the products that hide their latency
        const float* brow = a.relb + ((long long)h * N + i0) * N;
        float add[NT][4];
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) add[t][e] = brow[8 * (e >> 1) * N + 8 * t + c2 + (e & 1)];
        float s[NT][4];
#pragma unroll
        for (int t = 0; t < NT; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
        for (int kq = 0; kq < HD / 16; ++kq) {
            uint32_t qa[4];
            ldsm_x4(qa, qs + (16 * rt + (lane & 15)) * ld + hoff + kq * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int t = 0; t < NT; ++t) {
                uint32_t b0, b1;
                ldsm_x2(b0, b1,
                        ks + (kb + 8 * t + (lane & 7)) * ld + hoff + kq * 16 + ((lane >> 3) & 1) * 8);
                mma16816(s[t], qa, b0, b1);
            }
        }
        // fp32 softmax of rows i0 (s[t][0..1]) and i0 + 8 (s[t][2..3])
        float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int i = i0 + 8 * (e >> 1), j = 8 * t + c2 + (e & 1);
                float v = s[t][e] + add[t][e];
                if (masked && lab[kb + j] != lab[kb + i]) v -= 100.0f;
                if (TOKENS && mwin) v += mwin[i * N + j];
                s[t][e] = v;
                m[e >> 1] = fmaxf(m[e >> 1], v);
            }
        float l[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
            m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
        }
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                s[t][e] = __expf(s[t][e] - m[e >> 1]);
                l[e >> 1] += s[t][e];
            }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
            l[r] = 1.0f / l[r];
        }
        // normalized probabilities in bf16: the accumulator layout of two
        // key tiles is the A fragment of 16 keys
        uint32_t pa[N / 16][4];
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
            pa[kk][0] = pack_bf16(s[2 * kk][0] * l[0], s[2 * kk][1] * l[0]);
            pa[kk][1] = pack_bf16(s[2 * kk][2] * l[1], s[2 * kk][3] * l[1]);
            pa[kk][2] = pack_bf16(s[2 * kk + 1][0] * l[0], s[2 * kk + 1][1] * l[0]);
            pa[kk][3] = pack_bf16(s[2 * kk + 1][2] * l[1], s[2 * kk + 1][3] * l[1]);
        }
        float o[DT][4];
#pragma unroll
        for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
            for (int d = 0; d < DT; ++d) {
                uint32_t b0, b1;
                ldsm_x2_trans(b0, b1, vs + (kb + 16 * kk + (lane & 15)) * ld + hoff + d * 8);
                mma16816(o[d], pa[kk], b0, b1);
            }
        const int r = 16 * rt + g4;
#pragma unroll
        for (int d = 0; d < DT; ++d) {
            const int col = h * HD + d * 8 + c2;
            *reinterpret_cast<__nv_bfloat162*>(ybuf + aoff(r, col)) =
                __floats2bfloat162_rn(o[d][0], o[d][1]);
            *reinterpret_cast<__nv_bfloat162*>(ybuf + aoff(r + 8, col)) =
                __floats2bfloat162_rn(o[d][2], o[d][3]);
        }
    }
}

template <bool TOKENS>
__device__ __forceinline__ void attend(const SWArgs& a, int slab, int g, const bf16* qs,
                                       const bf16* ks, const bf16* vs, int ld,
                                       unsigned char* ybuf, const int* lab, int warp, int lane) {
#define SW_ATTEND(NN, HH)                                                                     \
    if (a.N == NN && a.hd == HH)                                                              \
        return attend_group<NN, HH, TOKENS>(a, slab, g, qs, ks, vs, ld, ybuf, lab, warp, lane);
    SW_ATTEND(48, 64) SW_ATTEND(48, 32) SW_ATTEND(48, 16) SW_ATTEND(48, 48)
    SW_ATTEND(16, 64) SW_ATTEND(16, 32) SW_ATTEND(16, 16) SW_ATTEND(16, 48)
#undef SW_ATTEND
}

// 16-byte asynchronous copy; an invalid source fills the 16 bytes with zero.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
}

// The row table of slab `slab` at `lab`: each row's element offset in x /
// out (-1 past the input) and its shift-region label.
template <bool TOKENS>
__device__ __forceinline__ void row_table(const SWArgs& a, int slab, int* lab, int tid) {
    long long* pix = reinterpret_cast<long long*>(lab + 64);
    if (tid < SLAB) {
        const int win = slab * (SLAB / a.N) + tid / a.N;
        pix[tid] = win < a.nwin ? pix_offset<TOKENS>(a, win, tid % a.N) : -1;
        if (!TOKENS && (a.sh > 0 || a.sw > 0)) lab[tid] = region_label(a, win, tid % a.N);
    }
}

// The rows of the table at `lab`, raw bf16 [SLAB, C], into rb (zeros past
// the input), as one cp.async group.
__device__ __forceinline__ void load_rows(const SWArgs& a, const int* lab, unsigned char* rb,
                                          int tid) {
    const long long* pix = reinterpret_cast<const long long*>(lab + 64);
    const int row_chunks = a.C / 8;   // 16-byte pieces of a row
    int row = tid / row_chunks, piece = tid - row * row_chunks;
    const int step_rows = 128 / row_chunks, step_pieces = 128 - step_rows * row_chunks;
    for (; row < SLAB; row += step_rows, piece += step_pieces) {
        if (piece >= row_chunks) piece -= row_chunks, ++row;
        if (row >= SLAB) break;
        const long long off = pix[row];
        cp_async16(rb + (row * a.C + piece * 8) * 2, off >= 0 ? a.x + off + piece * 8 : a.x,
                   off >= 0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The whole block for slab `slab` (SLAB token rows), by consumer warpgroup
// w, whose regions start at `reg`; `lab` holds the slab's row table and,
// where `ready`, its rows are already on their way into the B buffer.  If
// `next` >= 0, the pass requests that slab's rows (table at `lab_next`)
// once its B buffer is free.  TOKENS selects the addressing (token rows vs
// 5-D pixels) and the mask (the caller's array vs region labels of the
// shift).  Slabs past the input run on zeros and write nothing.  `xs` is
// this warpgroup's slice of the x1 scratch: thread tid < X1_THREADS keeps
// accumulator elements (rows r0, r0 + 8; columns c, c + 1) as the float4
// xs[q * X1_THREADS + tid], q = c / 8.
template <bool TOKENS, int NB>
__device__ __forceinline__ void slab_pass(const SWArgs& a, int slab, int next, unsigned char* reg,
                                          int* lab, int* lab_next, bool ready, float4* xs,
                                          Ring& ring, int w) {
    constexpr int W = TILE * NB;      // columns of one product
    constexpr int NJ = 8 * NB;        // column pairs of a row in one product, per thread
    const int C = a.C, nk = C / TILE;
    const int tid = threadIdx.x - w * 128, warp = tid >> 5, lane = tid & 31;
    const int bar = 1 + w;
    const int r0 = warp * 16 + (lane >> 2), c2 = 2 * (lane & 3);
    const bool real = r0 < SLAB;                                 // warps 0..2
    unsigned char* ra = reg;                                     // LN1 out, then GELU out
    unsigned char* rb = reg + a.off_b;                           // x rows, attn out, LN2 out
    const int ld = a.gw + 8;
    bf16* qkv = reinterpret_cast<bf16*>(reg + a.off_x);          // q/k/v of a head group
    const uint32_t abase_a = smem_u32(ra), abase_b = smem_u32(rb);
    const long long* pix = reinterpret_cast<const long long*>(lab + 64);
    PROBE_DECL

    if (!ready) {
        row_table<TOKENS>(a, slab, lab, tid);
        named_sync(bar, 128);
        load_rows(a, lab, rb, tid);
    }

    // ---- LN1 ------------------------------------------------------------------
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    named_sync(bar, 128);
    PROBE(7);
    ln1(a, rb, ra, warp, lane);
    fence_async_smem();
    named_sync(bar, 128);
    PROBE(0);

    // ---- q/k/v a head group at a time, each group's attention right after ----
    float2 bv[NJ];
    const int per = a.gw / W;    // chunks of each of q, k, v in a group
    for (int g = 0; g < C / a.gw; ++g) {
        gemm<NB, 16>(3 * per, abase_a, nk, ring, lane,
                 [&](int c) {
                     const int m = c / per;
                     chunk_vec<NB>(bv, m == 0 ? a.bq : (m == 1 ? a.bk : a.bv),
                                   g * a.gw + (c - m * per) * W, lane);
                 },
                 [&](int c, const float(&acc)[32 * NB]) {
                     const int m = c / per;
                     const float mul = m == 0 ? a.scale : 1.0f;
                     bf16* dst = qkv + m * SLAB * ld + (c - m * per) * W;
                     epilogue<NB>(acc, warp, lane,
                                  [&](int r, int hh, int j, int col, float v0, float v1) {
                                      *reinterpret_cast<__nv_bfloat162*>(dst + r * ld + col) =
                                          __floats2bfloat162_rn((v0 + bv[j].x) * mul,
                                                                (v1 + bv[j].y) * mul);
                                  });
                 });
        named_sync(bar, 128);
        PROBE(1);
        attend<TOKENS>(a, slab, g, qkv, qkv + SLAB * ld, qkv + 2 * SLAB * ld, ld, rb, lab, warp,
                       lane);
        fence_async_smem();
        named_sync(bar, 128);
        PROBE(2);
    }

    // LN2's weight and bias into the X region (free until the next pass's
    // q/k/v), to be read from shared memory after proj
    float* ln2p = reinterpret_cast<float*>(reg + a.off_x);
    for (int e = tid; e < C / 2; e += 128) {
        const float* src = e < C / 4 ? a.ln2w + 4 * e : a.ln2b + 4 * (e - C / 4);
        cp_async16(ln2p + 4 * e, src, true);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    // ---- x1 = x + proj(attn), to the scratch slice ------------------------------
    {
        uint32_t xr[2][NJ];
        gemm<NB, 17>(C / W, abase_b, nk, ring, lane,
                 [&](int c) {
                     chunk_vec<NB>(bv, a.bp, c * W, lane);
#pragma unroll
                     for (int hh = 0; hh < 2; ++hh) {
                         const long long off = real ? pix[r0 + 8 * hh] : -1;
#pragma unroll
                         for (int j = 0; j < NJ; ++j)
                             xr[hh][j] = off < 0 ? 0u
                                                 : *reinterpret_cast<const uint32_t*>(
                                                       a.x + off + c * W + 8 * j + c2);
                     }
                 },
                 [&](int c, const float(&acc)[32 * NB]) {
                     if (!real) return;
#pragma unroll
                     for (int j = 0; j < NJ; ++j) {
                         const float2 x0 = __bfloat1622float2(
                             *reinterpret_cast<const __nv_bfloat162*>(&xr[0][j]));
                         const float2 x8 = __bfloat1622float2(
                             *reinterpret_cast<const __nv_bfloat162*>(&xr[1][j]));
                         const float4 v = make_float4(x0.x + (acc[4 * j] + bv[j].x),
                                                      x0.y + (acc[4 * j + 1] + bv[j].y),
                                                      x8.x + (acc[4 * j + 2] + bv[j].x),
                                                      x8.y + (acc[4 * j + 3] + bv[j].y));
                         xs[(c * NJ + j) * X1_THREADS + tid] = v;
                     }
                 });
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    named_sync(bar, 128);   // proj's products have read rb, which LN2 writes
    PROBE(3);

    // ---- LN2 of rows r0 and r0 + 8 from the scratch slice, into rb -------------
    // LN1's arithmetic in LN1's order: this thread's elements of the quad
    // layout (columns nc*W + 8j + 2q, j = 8h + m) are the columns 64k + 2l of
    // lanes l = 4m + q, k = nc*NB + h, whose partials it sums in k order
    if (real) {
        const int nch = C / W;
        auto load = [&](int nc, float4 (&v)[NJ]) {
#pragma unroll
            for (int j = 0; j < NJ; ++j) v[j] = xs[(nc * NJ + j) * X1_THREADS + tid];
        };
        auto sums = [&](const float4 (&v)[NJ], float (&p0)[8], float (&p1)[8]) {
#pragma unroll
            for (int h = 0; h < NB; ++h)
#pragma unroll
                for (int m = 0; m < 8; ++m) {
                    p0[m] += v[8 * h + m].x + v[8 * h + m].y;
                    p1[m] += v[8 * h + m].z + v[8 * h + m].w;
                }
        };
        auto deviations = [&](const float4 (&v)[NJ], float m0, float m1, float (&p0)[8],
                              float (&p1)[8]) {
#pragma unroll
            for (int h = 0; h < NB; ++h)
#pragma unroll
                for (int m = 0; m < 8; ++m) {
                    const float4 u = v[8 * h + m];
                    float d0 = u.x - m0, d1 = u.y - m0;
                    p0[m] += d0 * d0 + d1 * d1;
                    d0 = u.z - m1;
                    d1 = u.w - m1;
                    p1[m] += d0 * d0 + d1 * d1;
                }
        };
        auto normalize = [&](int nc, const float4 (&v)[NJ], float m0, float m1, float rs0,
                             float rs1) {
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const int col = nc * W + 8 * j + c2;
                const float2 lw = *reinterpret_cast<const float2*>(ln2p + col);
                const float2 lb = *reinterpret_cast<const float2*>(ln2p + C + col);
                *reinterpret_cast<__nv_bfloat162*>(rb + aoff(r0, col)) = __floats2bfloat162_rn(
                    (v[j].x - m0) * rs0 * lw.x + lb.x, (v[j].y - m0) * rs0 * lw.y + lb.y);
                *reinterpret_cast<__nv_bfloat162*>(rb + aoff(r0 + 8, col)) =
                    __floats2bfloat162_rn((v[j].z - m1) * rs1 * lw.x + lb.x,
                                          (v[j].w - m1) * rs1 * lw.y + lb.y);
            }
        };
        // three reads of the slice: the sums, the squared deviations, the
        // normalized values (holding the values in registers spills)
        float p0[8] = {}, p1[8] = {}, d0[8] = {}, d1[8] = {};
        float4 v[NJ];
        for (int nc = 0; nc < nch; ++nc) {
            load(nc, v);
            sums(v, p0, p1);
        }
        const float m0 = lane_tree(p0) / C, m1 = lane_tree(p1) / C;
        for (int nc = 0; nc < nch; ++nc) {
            load(nc, v);
            deviations(v, m0, m1, d0, d1);
        }
        const float rs0 = rsqrtf(lane_tree(d0) / C + 1e-6f);
        const float rs1 = rsqrtf(lane_tree(d1) / C + 1e-6f);
        for (int nc = 0; nc < nch; ++nc) {
            load(nc, v);
            normalize(nc, v, m0, m1, rs0, rs1);
        }
    }
    fence_async_smem();
    named_sync(bar, 128);
    PROBE(4);

    // ---- fc1 + erf GELU --------------------------------------------------------
    gemm<NB, 18>(C / W, abase_b, nk, ring, lane, [&](int c) { chunk_vec<NB>(bv, a.b1, c * W, lane); },
             [&](int c, const float(&acc)[32 * NB]) {
                 epilogue<NB>(acc, warp, lane,
                              [&](int r, int hh, int j, int col, float v0, float v1) {
                                  float u0 = v0 + bv[j].x, u1 = v1 + bv[j].y;
                                  u0 = 0.5f * u0 * (1.0f + erff(u0 * 0.70710678118654752f));
                                  u1 = 0.5f * u1 * (1.0f + erff(u1 * 0.70710678118654752f));
                                  *reinterpret_cast<__nv_bfloat162*>(ra + aoff(r, c * W + col)) =
                                      __floats2bfloat162_rn(u0, u1);
                              });
             });
    fence_async_smem();
    named_sync(bar, 128);
    PROBE(5);
    // the next slab's rows, into rb (free until the next pass's LN1)
    if (next >= 0) {
        row_table<TOKENS>(a, next, lab_next, tid);
        named_sync(bar, 128);
        load_rows(a, lab_next, rb, tid);
    }
    PROBE(11);

    // ---- out = x1 + fc2(.), written to the same (shifted) pixels --------------
    gemm<NB, 19>(C / W, abase_a, nk, ring, lane, [&](int c) { chunk_vec<NB>(bv, a.b2, c * W, lane); },
             [&](int c, const float(&acc)[32 * NB]) {
                 if (!real) return;
                 const long long o0 = pix[r0], o8 = pix[r0 + 8];
                 float4 xq[NJ];
#pragma unroll
                 for (int j = 0; j < NJ; ++j) xq[j] = xs[(c * NJ + j) * X1_THREADS + tid];
#pragma unroll
                 for (int j = 0; j < NJ; ++j) {
                     const int col = c * W + 8 * j + c2;
                     const float2 y0 = make_float2(xq[j].x + (acc[4 * j] + bv[j].x),
                                                   xq[j].y + (acc[4 * j + 1] + bv[j].y));
                     const float2 y8 = make_float2(xq[j].z + (acc[4 * j + 2] + bv[j].x),
                                                   xq[j].w + (acc[4 * j + 3] + bv[j].y));
                     if (a.out_f32) {
                         float* out = static_cast<float*>(a.out);
                         if (o0 >= 0) *reinterpret_cast<float2*>(out + o0 + col) = y0;
                         if (o8 >= 0) *reinterpret_cast<float2*>(out + o8 + col) = y8;
                     } else {
                         bf16* out = static_cast<bf16*>(a.out);
                         if (o0 >= 0)
                             *reinterpret_cast<__nv_bfloat162*>(out + o0 + col) =
                                 __floats2bfloat162_rn(y0.x, y0.y);
                         if (o8 >= 0)
                             *reinterpret_cast<__nv_bfloat162*>(out + o8 + col) =
                                 __floats2bfloat162_rn(y8.x, y8.y);
                     }
                 }
             });
    named_sync(bar, 128);   // the regions are reused by the next pass
    PROBE(6);
    PROBE_COUNT(15, 1);
}

struct Smem {
    unsigned char* base;   // 1024-aligned
    Ring ring;
};

// Align the dynamic shared memory, set up the ring and its barriers (every
// consumer warp releases a slot).
__device__ __forceinline__ Smem setup(const SWArgs& a, unsigned char* raw) {
    Smem sm;
    sm.base = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                               ~static_cast<uintptr_t>(1023));
    uint64_t* bars = reinterpret_cast<uint64_t*>(sm.base + a.off_bar);
    sm.ring = Ring{sm.base, bars, bars + a.stages, a.stages, 0};
    if (threadIdx.x == 0) {
        for (int s = 0; s < a.stages; ++s) {
            mbar_init(&sm.ring.full[s], 1);
            mbar_init(&sm.ring.empty[s], a.nw * 4);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#ifdef SW_PROBE
        for (int i = 0; i < 24; ++i) s_probe[i] = 0;
#endif
    }
    __syncthreads();
    return sm;
}

// Groups first, first + stride, ... of nw slabs each: thread 0 of the
// warpgroup after the consumers produces, consumer warpgroup w takes slab
// group * nw + w.  With REG the producer warpgroup hands registers to the
// consumers (setmaxnreg; its paths never meet again).
template <bool TOKENS, int NB, bool REG>
__device__ __forceinline__ void run(const SWArgs& a, const Maps& maps, Smem& sm, int first,
                                    int stride) {
    const int ngroups = (a.nslab + a.nw - 1) / a.nw;
    const int wg = threadIdx.x / 128;
    if (wg == a.nw) {
        if (REG) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
        if (threadIdx.x == a.nw * 128)
            for (int g = first; g < ngroups; g += stride) produce_pass<NB>(a, maps, sm.ring);
        __syncwarp();
        return;
    }
    if (REG) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    unsigned char* reg = sm.base + a.off_slab + wg * a.slab_bytes;
    int* tables = reinterpret_cast<int*>(sm.base + a.off_lab + wg * 2 * ROW_TABLE);
    float4* xs = reinterpret_cast<float4*>(a.x1s) +
                 (size_t)(blockIdx.x * a.nw + wg) * (a.C / 8) * X1_THREADS;
    int cur = 0;
    for (int g = first; g < ngroups; g += stride) {
        const int next = g + stride < ngroups ? (g + stride) * a.nw + wg : -1;
        slab_pass<TOKENS, NB>(a, g * a.nw + wg, next, reg, tables + cur * (ROW_TABLE / 4),
                              tables + (cur ^ 1) * (ROW_TABLE / 4), g != first, xs, sm.ring, wg);
        cur ^= 1;
    }
#ifdef SW_PROBE
    if (blockIdx.x == 0 && threadIdx.x == 0)
        for (int i = 0; i < 24; ++i) {
            atomicAdd(&g_probe[i], s_probe[i]);
            s_probe[i] = 0;
        }
#endif
}

// K1 / K3: persistent CTAs; CTA b takes groups b, b + gridDim.x, ...
template <bool TOKENS, int NB>
__global__ void __launch_bounds__(128 * (MAX_NW + 1), 1)
    sw_block_kernel(const __grid_constant__ SWArgs a, const __grid_constant__ Maps maps) {
    extern __shared__ unsigned char smem_raw[];
    Smem sm = setup(a, smem_raw);
    run<TOKENS, NB, true>(a, maps, sm, blockIdx.x, gridDim.x);
}

// Blocks [no-shift, shift] of one layer in one cooperative launch.  The TPU
// kernel carries block 0's stripe in VMEM across sequential grid steps; CUDA
// CTAs run in no order and at C=512 one slab already fills an SM's shared
// memory, so block 0's result cannot stay on chip beside block 1.  Instead
// the grid is sized to the CTAs that are resident at once, every CTA walks
// its share of the slabs through block 0 (a0: x -> scratch), the grid meets
// at a barrier, and the same CTAs walk the shifted slabs through block 1
// (a1: scratch -> out).  The scratch holds block 0's bf16 output, as two
// launches would hand it over, and the arithmetic is K1's, so the result is
// the same bit for bit; what goes away is one launch.  With an fp32 output
// only block 1 stores fp32: the TPU kernel carries block 0's result in
// out_dtype (fp32) and rounds it to bf16 as block 1's input, and the bf16
// scratch holds exactly that rounding of the same fp32 value.  One slab per
// CTA (the plan's), so the register cap is that of 256 threads.
template <int NB>
__global__ void __launch_bounds__(128 * 2, 1)
    sw_block_pair_kernel(const __grid_constant__ SWArgs a0, const __grid_constant__ SWArgs a1,
                         const __grid_constant__ Maps m0, const __grid_constant__ Maps m1) {
    extern __shared__ unsigned char smem_raw[];
    // the phase's arguments live in shared memory: read there as needed, so
    // that the pass keeps no more registers than K1's (K1's copy is in the
    // constant bank)
    __shared__ SWArgs sa;
    Smem sm = setup(a0, smem_raw);
    for (int phase = 0; phase < 2; ++phase) {
        if (threadIdx.x == 0) sa = phase ? a1 : a0;
        __syncthreads();
        run<false, NB, false>(sa, phase ? m1 : m0, sm, blockIdx.x, gridDim.x);
        if (phase == 0) cg::this_grid().sync();
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
constexpr int ERR_PLAN = 10001;
constexpr int ERR_ENCODE = 20000;   // + CUresult

// The six (C, C) weights as 2-D tensor maps, box 64 columns x 64*nb rows.
int encode_maps(Maps& m, const SWArgs& a) {
    EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return ERR_NO_ENCODER;
    const bf16* w[6] = {a.wq, a.wk, a.wv, a.wp, a.w1, a.w2};
    const cuuint64_t dims[2] = {(cuuint64_t)a.C, (cuuint64_t)a.C};
    const cuuint64_t strides[1] = {(cuuint64_t)a.C * 2};
    const cuuint32_t box[2] = {(cuuint32_t)TILE, (cuuint32_t)(TILE * a.nb)};
    const cuuint32_t estride[2] = {1, 1};
    for (int i = 0; i < 6; ++i) {
        CUresult r = fn(&m.w[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(w[i]),
                        dims, strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
        if (r != CUDA_SUCCESS) return ERR_ENCODE + (int)r;
    }
    return 0;
}

// plan[12] (ops/sw_block.py:sw_plan): nw, stages, gw, nb, off_slab,
// slab_bytes, off_b, off_x, off_lab, off_bar, smem, grid.  Returns the grid
// or -1 if the plan does not fit these limits.
int apply_plan(SWArgs& a, const int* plan) {
    a.nw = plan[0];
    a.stages = plan[1];
    a.gw = plan[2];
    a.nb = plan[3];
    a.off_slab = plan[4];
    a.slab_bytes = plan[5];
    a.off_b = plan[6];
    a.off_x = plan[7];
    a.off_lab = plan[8];
    a.off_bar = plan[9];
    a.smem = plan[10];
    const int grid = plan[11];
    const int qkv_bytes = 3 * SLAB * (a.gw + 8) * 2;
    const bool ok =
        a.nw >= 1 && a.nw <= MAX_NW && a.stages >= 2 && (a.nb == 1 || a.nb == 2) &&
        a.gw % (TILE * a.nb) == 0 && a.gw % a.hd == 0 && a.C % a.gw == 0 &&
        a.off_slab % 1024 == 0 && a.off_slab >= a.stages * a.nb * TILE_BYTES &&
        a.slab_bytes % 1024 == 0 && a.off_b >= SLAB * a.C * 2 && a.off_b % 1024 == 0 &&
        a.off_x >= 2 * a.off_b && a.off_x % 1024 == 0 && a.slab_bytes - a.off_x >= 2048 &&
        a.slab_bytes >= a.off_x + qkv_bytes && a.slab_bytes >= a.off_x + 8 * a.C &&
        a.off_lab >= a.off_slab + a.nw * a.slab_bytes &&
        a.off_bar >= a.off_lab + a.nw * 2 * ROW_TABLE && a.off_bar % 8 == 0 &&
        a.smem >= a.off_bar + 16 * a.stages + 1023 && a.smem + STATIC_SMEM <= 232448 &&
        grid >= 1 && grid <= (a.nslab + a.nw - 1) / a.nw;
    return ok ? grid : -1;
}

template <bool TOKENS>
int launch(SWArgs a, const int* plan, cudaStream_t stream) {
    const int grid = apply_plan(a, plan);
    if (grid < 0) return ERR_PLAN;
    Maps maps;
    int err = encode_maps(maps, a);
    if (err) return err;
    auto kernel = a.nb == 2 ? &sw_block_kernel<TOKENS, 2> : &sw_block_kernel<TOKENS, 1>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         a.smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, 128 * (a.nw + 1), a.smem, stream>>>(a, maps);
    return (int)cudaGetLastError();
}

int launch_pair(SWArgs a0, SWArgs a1, const int* plan, cudaStream_t stream) {
    const int planned = apply_plan(a0, plan);
    if (planned < 0 || apply_plan(a1, plan) < 0 || a0.nw != 1) return ERR_PLAN;
    Maps m0, m1;
    int err = encode_maps(m0, a0);
    if (!err) err = encode_maps(m1, a1);
    if (err) return err;
    auto kernel = a0.nb == 2 ? &sw_block_pair_kernel<2> : &sw_block_pair_kernel<1>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         a0.smem);
    if (e != cudaSuccess) return (int)e;
    // a grid barrier needs every CTA resident: at most the CTAs that fit at
    // once at the real block and dynamic shared-memory size
    const int threads = 128 * (a0.nw + 1);
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, a0.smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    const int grid = per_sm * sms < planned ? per_sm * sms : planned;
    void* params[] = {&a0, &a1, &m0, &m1};
    e = cudaLaunchCooperativeKernel((void*)kernel, dim3(grid), dim3(threads), params, a0.smem,
                                    stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// p: x, out, x1 scratch, ln1w, ln1b, wq, bq, wk, bk, wv, bv, wp, bp, ln2w,
// ln2b, w1, b1, w2, b2, relb (20 device pointers).
void set_pointers(SWArgs& a, const void* const* p, int out_f32) {
    a.x = (const bf16*)p[0];
    a.out = const_cast<void*>(p[1]);
    a.x1s = (float*)const_cast<void*>(p[2]);
    a.out_f32 = out_f32 ? 1 : 0;
    a.ln1w = (const float*)p[3];
    a.ln1b = (const float*)p[4];
    a.wq = (const bf16*)p[5];
    a.bq = (const float*)p[6];
    a.wk = (const bf16*)p[7];
    a.bk = (const float*)p[8];
    a.wv = (const bf16*)p[9];
    a.bv = (const float*)p[10];
    a.wp = (const bf16*)p[11];
    a.bp = (const float*)p[12];
    a.ln2w = (const float*)p[13];
    a.ln2b = (const float*)p[14];
    a.w1 = (const bf16*)p[15];
    a.b1 = (const float*)p[16];
    a.w2 = (const bf16*)p[17];
    a.b2 = (const float*)p[18];
    a.relb = (const float*)p[19];
    a.mask = nullptr;
    a.nW = 1;
}

// Width and window-size limits shared by every entry; sets hd and scale.
bool set_width(SWArgs& a, int C, int heads, int N, float scale) {
    if (heads <= 0 || C % heads) return false;
    a.C = C;
    a.heads = heads;
    a.hd = C / heads;
    a.N = N;
    a.scale = scale;
    return !(C % 64 || C > 512 || a.hd % 16 || a.hd > 64 || (N != 16 && N != 48));
}

void set_count(SWArgs& a, int nwin) {
    a.nwin = nwin;
    a.nslab = (int)(((long long)nwin * a.N + SLAB - 1) / SLAB);
}

bool set_geometry_5d(SWArgs& a, int B, int T, int H, int W, int C, int heads, int wh, int ww,
                     int sh, int sw, float scale) {
    if (wh <= 0 || ww <= 0 || !set_width(a, C, heads, T * wh * ww, scale)) return false;
    if (H % wh || W % ww || sh < 0 || sh >= wh || sw < 0 || sw >= ww) return false;
    a.B = B;
    a.T = T;
    a.H = H;
    a.W = W;
    a.wh = wh;
    a.ww = ww;
    a.sh = sh;
    a.sw = sw;
    a.nWh = H / wh;
    a.nWw = W / ww;
    set_count(a, B * a.nWh * a.nWw);
    return true;
}

}  // namespace

#ifdef SW_PROBE
// Copy the probe's 24 counters to host[24] and clear them.
extern "C" int sw_block_probe_read(unsigned long long* host) {
    cudaError_t e = cudaMemcpyFromSymbol(host, g_probe, sizeof(g_probe));
    if (e != cudaSuccess) return (int)e;
    unsigned long long zero[24] = {};
    return (int)cudaMemcpyToSymbol(g_probe, zero, sizeof(g_probe));
}
#endif

// Plain C entry points (loaded with ctypes).  p is a host table of 20 device
// pointers (set_pointers); x is bf16, the output bf16 or, with out_f32,
// fp32; the x1 scratch fp32 of grid * nw * C * 48 elements; matrices are
// bf16 (out_features, in_features) row-major with 16-byte aligned rows,
// vectors and the [heads, N, N] relative bias fp32.  plan is the host array
// of ops/sw_block.py:sw_plan.  Each returns 0 on success, a cudaError_t code
// or one of the ERR_ codes above.

// One block on x [B, T, H, W, C] with shift (sh, sw).
extern "C" int sw_block_launch(const void* const* p, const int* plan, int B, int T, int H, int W,
                               int C, int heads, int wh, int ww, int sh, int sw, int out_f32,
                               float scale, void* stream) {
    SWArgs a = {};
    set_pointers(a, p, out_f32);
    if (!set_geometry_5d(a, B, T, H, W, C, heads, wh, ww, sh, sw, scale))
        return (int)cudaErrorInvalidValue;
    return launch<false>(a, plan, (cudaStream_t)stream);
}

// One block on window tokens [Mwin, N, C]; mask is null or fp32 [nW, N, N],
// added to the scores of window m as mask[m % nW].
extern "C" int sw_block_tokens_launch(const void* const* p, const int* plan, const void* mask,
                                      int Mwin, int N, int C, int heads, int nW, int out_f32,
                                      float scale, void* stream) {
    SWArgs a = {};
    set_pointers(a, p, out_f32);
    if (Mwin <= 0 || nW <= 0 || !set_width(a, C, heads, N, scale))
        return (int)cudaErrorInvalidValue;
    a.mask = (const float*)mask;
    a.nW = nW;
    set_count(a, Mwin);
    return launch<true>(a, plan, (cudaStream_t)stream);
}

// Blocks [no-shift, shift (sh, sw)] on x [B, T, H, W, C]: p0 = (x, scratch,
// x1 scratch, block 0's weights), p1 = (scratch, out, the same x1 scratch,
// block 1's weights); the scratch is bf16, the output fp32 with out_f32.
extern "C" int sw_block_pair_launch(const void* const* p0, const void* const* p1,
                                    const int* plan, int B, int T, int H, int W, int C, int heads,
                                    int wh, int ww, int sh, int sw, int out_f32, float scale,
                                    void* stream) {
    SWArgs a0 = {}, a1 = {};
    set_pointers(a0, p0, 0);
    set_pointers(a1, p1, out_f32);
    if (!set_geometry_5d(a0, B, T, H, W, C, heads, wh, ww, 0, 0, scale) ||
        !set_geometry_5d(a1, B, T, H, W, C, heads, wh, ww, sh, sw, scale))
        return (int)cudaErrorInvalidValue;
    return launch_pair(a0, a1, plan, (cudaStream_t)stream);
}
