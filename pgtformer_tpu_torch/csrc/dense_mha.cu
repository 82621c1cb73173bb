// Dense multi-head attention for the code transformer, Hopper (sm_90a), bf16
// operands, bf16 or fp32 output.
//
// Replaces two TPU kernels of pgtformer_tpu/ops/flash_attn.py with one
// strided kernel: _dense_mha_pallas (dense_mha(layout="bhnd"), operands and
// output [B, H, N, D]) and _dense_mha_pallas_bnhd (layout="bnhd", operands
// [B, N, H, D] views of the packed projections, output written packed
// [B, N, H*D]).  Every operand is read through a 4-D TMA tensor map
// (D, rows, heads, batch) built from the tensor's own byte strides
// (ops/dense_mha.py:tma_geometry), so either layout, and the halves of a
// packed [B, N, 2C] projection, are read in place; the output is written
// through its (batch, head, row) strides.
//
//     out = softmax(bf16(q * scale) . k^T) . v
//
// What bounds it on an H100: 4*N^2*D FLOP per (batch, head) against
// 4*N*D*2 bytes of q/k/v/out, i.e. ~N/2 = 1536 FLOP/byte at N=3072, five
// times the card's ~295 FLOP/byte balance point: it is bound by operations
// (the tensor cores, and the exponentials: one MUFU ex2 per 4*D FLOP).
//
// The TPU kernel holds one head's whole K/V in VMEM and runs a single-pass
// softmax.  Here one CTA takes (batch, head, 128-row query tile) and streams
// 128-key tiles with an online softmax, in three warpgroups:
//  * warpgroup 2 is the producer: after setmaxnreg.dec (24 registers) one
//    thread issues the TMA loads, Q once, K and V through a ring of STAGES
//    slots with full and empty mbarriers, so later tiles' copies overlap
//    this tile's math;
//  * warpgroups 0 and 1 are consumers of 64 query rows each (setmaxnreg.inc,
//    240 registers: one CTA of 384 threads per SM; 112 KB of shared memory
//    at D=64).  S = Q.K^T is one wgmma m64n128k16 per 16 of D, both
//    operands read from shared memory through descriptors in the TMA's
//    swizzle (128B at D=64, 64B at D=32, 32B at D=16: one row of D is one
//    swizzle span);
//  * the softmax runs on S in registers: the 4 threads that share a row
//    reduce its max with two shuffles; keys >= N (zero-filled by TMA) are set
//    to -inf before the max; exp2 with log2(e) folded into one FMA; running
//    max in fp32 per row, running sum kept per thread and reduced at the end;
//  * O += P.V with P cast to bf16 in registers as wgmma's A operand (the
//    fp32 accumulator layout of S is the bf16 A-fragment layout of the next
//    product, 16 keys at a time) and V read from shared memory transposed
//    (its rows are keys, D contiguous).  O (D/2 fp32 per thread) stays in
//    registers and is rescaled there by exp2(m_old - m_new);
//  * within a consumer, S(t) = Q.K(t)^T and P(t-1).V(t-1) are issued
//    together and the softmax of tile t runs while the second still holds
//    the tensor cores; the other consumer fills the gaps between them;
//  * the epilogue writes bf16(O / l), or with `out_f32` the fp32 O / l
//    unrounded, straight from registers, rows >= N skipped.  The fp32 form is
//    the TPU kernel's under fp32 activations: q/k/v rounded to bf16 (here by
//    the wrapper), the output stored in q.dtype.
//
// Rounding points, as the TPU kernel: q * scale is rounded to bf16 once, in
// shared memory, before the first product; the unnormalized probabilities
// are rounded to bf16 before P.V; the row sum stays fp32 and the output is
// normalized once at the end.  No atomics: two launches are bit-equal, and so
// are the two layouts on the same data.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NCONS = 2;                  // consumer warpgroups, 64 query rows each
constexpr int BQ = 64 * NCONS;            // query rows per CTA
constexpr int BK = 128;                   // keys per tile
constexpr int STAGES = 3;                 // K/V ring slots
constexpr int THREADS = 128 * (NCONS + 1);
static_assert(BQ == BK, "one TMA box shape serves Q, K and V");
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {
    bf16 q[BQ * D];
    bf16 k[STAGES][BK * D];
    bf16 v[STAGES][BK * D];
    uint64_t q_full, k_full[STAGES], v_full[STAGES], empty[STAGES];
};

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

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(addr), "r"(parity)
            : "memory");
    }
}

// One box of a 4-D tensor map (D, rows, heads, batch) into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int row, int head, int batch) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(row), "r"(head),
        "r"(batch)
        : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle of a row of D bf16 (D*2 bytes).
template <int D>
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t sbo_bytes) {
    constexpr uint64_t layout = D == 64 ? 1 : (D == 32 ? 2 : 3);   // 128B, 64B, 32B
    uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;
    d |= (uint64_t)1 << 16;                          // leading offset: unused by these layouts
    d |= (uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32;
    d |= layout << 62;
    return d;
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of a wgmma operand across a wait
// (and from reusing an A operand's registers while the product reads them).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
}

// D[64 x 128] (+)= A.B^T, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                             int accumulate) {
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
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
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
        : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A.B, A (bf16) from registers, B from shared memory MN-major
// (transposed: its rows are the k index).
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
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 32] += A.B, A (bf16) from registers, B from shared memory MN-major
// (transposed: its rows are the k index).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
        "%10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 16] += A.B, A (bf16) from registers, B from shared memory MN-major
// (transposed: its rows are the k index).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P.V for 16 keys: N = D.
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t db) {
    if constexpr (D == 64) wgmma_rs_n64(o, a, db);
    else if constexpr (D == 32) wgmma_rs_n32(o, a, db);
    else wgmma_rs_n16(o, a, db);
}

// Issue S = q k^T for one key tile ([64 x 128] fp32, D/16 products).
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint64_t qdesc, uint64_t kdesc) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)   // 16 of D = 32 bytes along a swizzled row
        wgmma_ss_n128(sc, qdesc + 2 * kk, kdesc + 2 * kk, kk > 0);
    wgmma_commit();
}

// Online softmax on one tile's scores, in place: keys >= N (zero-filled by
// TMA) are set to -inf before the max, the running max m of this thread's
// two rows (r0, r0 + 8) moves to the tile's, the thread's shares l of the
// row sums are rescaled and added to, and sc becomes exp2((s - m) log2 e).
// corr receives the factors that rescale O.  (sc[4j + e]: row r0 + 8*(e/2),
// column 8j + c0 + e%2.)
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int kt, int N, int c0) {
    if (kt + BK > N) {
#pragma unroll
        for (int i = 0; i < 64; ++i)
            if (kt + 8 * (i / 4) + c0 + (i & 1) >= N) sc[i] = -INFINITY;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 64; ++i) mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], sc[i]);
    float ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        // the 4 threads that share a row hold its 128 columns
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = ex2((m[r] - mx[r]) * LOG2E);
        m[r] = mx[r];
        ms[r] = mx[r] * LOG2E;
        l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
        const int r = (i / 2) & 1;
        sc[i] = ex2(fmaf(sc[i], LOG2E, -ms[r]));
        l[r] += sc[i];
    }
}

// bf16(P) as wgmma A fragments, 16 keys each: the accumulator layout of S
// is the A-fragment layout of the next product.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4], const float (&sc)[64]) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
}

// O += bf16(P) v for one key tile, once V has landed: 16 keys (16 rows of V)
// per product.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[BK / 16][4],
                                         uint64_t* v_full, uint32_t parity, const bf16* vs) {
    mbar_wait(v_full, parity);
    const uint64_t vdesc = smem_desc<D>(vs, 8 * D * 2);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_pv<D>(o, pa[kk], vdesc + ((16 * D * 2) >> 4) * kk);
    wgmma_commit();
}

struct OutArgs {
    void* o;                // bf16, or fp32 with out_f32
    int out_f32;
    long long sb, sh, sn;   // output strides in elements
    int N;
    float scale;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    dense_mha_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const OutArgs a) {
    extern __shared__ unsigned char smem_raw[];
    // TMA swizzle and the wgmma descriptors assume 1024-byte aligned tiles
    Smem<D>& sm = *reinterpret_cast<Smem<D>*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
    constexpr uint32_t TILE_BYTES = BK * D * 2;
    constexpr uint32_t ROW8_BYTES = 8 * D * 2;       // one 8-row swizzle atom

    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
    const int N = a.N;
    const int ntiles = (N + BK - 1) / BK;
    const int wg = threadIdx.x / 128;

    if (threadIdx.x == 0) {
        mbar_init(&sm.q_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&sm.k_full[s], 1);
            mbar_init(&sm.v_full[s], 1);
            mbar_init(&sm.empty[s], NCONS * 4);     // lane 0 of every consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (wg == NCONS) {
        // ---- producer warpgroup: one thread issues every TMA load ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
        if (threadIdx.x == NCONS * 128) {
            mbar_expect_tx(&sm.q_full, BQ * D * 2);
            tma_load(sm.q, &qmap, &sm.q_full, q0, h, b);
            for (int t = 0; t < ntiles; ++t) {
                const int s = t % STAGES;
                mbar_wait(&sm.empty[s], ((t / STAGES) & 1) ^ 1);
                mbar_expect_tx(&sm.k_full[s], TILE_BYTES);
                tma_load(sm.k[s], &kmap, &sm.k_full[s], t * BK, h, b);
                mbar_expect_tx(&sm.v_full[s], TILE_BYTES);
                tma_load(sm.v[s], &vmap, &sm.v_full[s], t * BK, h, b);
            }
        }
    } else {
        // ---- consumer warpgroup: 64 query rows ----
        asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
        const int tid = threadIdx.x % 128;
        const int warp = tid / 32, lane = tid % 32;
        bf16* qs = sm.q + wg * 64 * D;

        // q * scale rounded to bf16 once, in place (elementwise, so the
        // swizzle does not matter), before the async proxy reads it
        mbar_wait(&sm.q_full, 0);
        for (int i = tid; i < 64 * D / 8; i += 128) {
            uint4 val = reinterpret_cast<uint4*>(qs)[i];
            __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                float2 f = __bfloat1622float2(hv[j]);
                hv[j] = __floats2bfloat162_rn(f.x * a.scale, f.y * a.scale);
            }
            reinterpret_cast<uint4*>(qs)[i] = val;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        named_sync(1 + wg, 128);

        // this thread's rows within the 64: r0 and r0 + 8; its columns
        // within each 8-column chunk: c0, c0 + 1
        const int r0 = warp * 16 + lane / 4;
        const int c0 = 2 * (lane % 4);
        float o[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
        float m[2] = {-INFINITY, -INFINITY};     // running max of raw scores
        float l[2] = {0.f, 0.f};                 // this thread's share of the row sum
        const uint64_t qdesc = smem_desc<D>(qs, ROW8_BYTES);

        // Tile t's softmax runs while the tensor cores compute P(t-1).V(t-1);
        // S(t) = q k(t)^T is issued before either.
        float sc[64], corr[2];
        uint32_t pa[BK / 16][4];
        mbar_wait(&sm.k_full[0], 0);
        issue_qk<D>(sc, qdesc, smem_desc<D>(sm.k[0], ROW8_BYTES));
        wgmma_wait<0>();
        fence_regs(sc);
        softmax_tile(sc, m, l, corr, 0, N, c0);
        pack_p(pa, sc);
        // No branch around a wgmma in the loop, and no other instruction
        // touches an accumulator between a product's issue and its wait:
        // ptxas then keeps the products asynchronous.  O is rescaled for
        // tile t once P(t-1).V(t-1) has retired.
        for (int t = 1; t < ntiles; ++t) {
            const int s = t % STAGES, sp = (t - 1) % STAGES;
            mbar_wait(&sm.k_full[s], (t / STAGES) & 1);
            issue_qk<D>(sc, qdesc, smem_desc<D>(sm.k[s], ROW8_BYTES));
            issue_pv<D>(o, pa, &sm.v_full[sp], ((t - 1) / STAGES) & 1, sm.v[sp]);
            wgmma_wait<1>();                      // S(t) is ready, P.V still runs
            fence_regs(sc);
            softmax_tile(sc, m, l, corr, t * BK, N, c0);
            wgmma_wait<0>();
            fence_regs(o);
            fence_regs(pa);
            __syncwarp();
            if (lane == 0) mbar_arrive(&sm.empty[sp]);   // this warp is done with slot sp
#pragma unroll
            for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i / 2) & 1];
            pack_p(pa, sc);
        }
        const int sl = (ntiles - 1) % STAGES;
        issue_pv<D>(o, pa, &sm.v_full[sl], ((ntiles - 1) / STAGES) & 1, sm.v[sl]);
        wgmma_wait<0>();
        fence_regs(o);

        // epilogue: bf16(O / l) (or fp32) through the output strides, rows >=
        // N skipped
        const long long obase = b * a.sb + h * a.sh;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
            l[r] = 1.0f / l[r];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = q0 + wg * 64 + r0 + 8 * r;
            if (row >= N) continue;
            const long long orow = obase + (long long)row * a.sn;
            if (a.out_f32) {
                float* of = static_cast<float*>(a.o) + orow;
#pragma unroll
                for (int j = 0; j < D / 8; ++j)
                    *reinterpret_cast<float2*>(of + 8 * j + c0) =
                        make_float2(o[4 * j + 2 * r] * l[r], o[4 * j + 2 * r + 1] * l[r]);
            } else {
                bf16* ob = static_cast<bf16*>(a.o) + orow;
#pragma unroll
                for (int j = 0; j < D / 8; ++j)
                    *reinterpret_cast<__nv_bfloat162*>(ob + 8 * j + c0) = __floats2bfloat162_rn(
                        o[4 * j + 2 * r] * l[r], o[4 * j + 2 * r + 1] * l[r]);
            }
        }
    }
}

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
constexpr int ERR_GEOMETRY = 10001;
constexpr int ERR_ENCODE = 20000;   // + CUresult

// g: dims[4] (D, rows, heads, batch), byte strides[3] (rows, heads, batch),
// box[4], swizzle bytes; as ops/dense_mha.py:tma_geometry gives them.
int encode(CUtensorMap* map, const void* base, const long long* g, int D) {
    if (g[0] != D || g[7] != D || g[8] != BK || g[9] != 1 || g[10] != 1 || g[11] != 2 * D)
        return ERR_GEOMETRY;
    EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return ERR_NO_ENCODER;
    const cuuint64_t dims[4] = {(cuuint64_t)g[0], (cuuint64_t)g[1], (cuuint64_t)g[2],
                                (cuuint64_t)g[3]};
    const cuuint64_t strides[3] = {(cuuint64_t)g[4], (cuuint64_t)g[5], (cuuint64_t)g[6]};
    const cuuint32_t box[4] = {(cuuint32_t)g[7], (cuuint32_t)g[8], (cuuint32_t)g[9],
                               (cuuint32_t)g[10]};
    const cuuint32_t estride[4] = {1, 1, 1, 1};
    const CUtensorMapSwizzle swz = D == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                   : D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_32B;
    CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                    strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const long long* geom, OutArgs a,
           cudaStream_t stream) {
    CUtensorMap maps[3];
    const void* bases[3] = {q, k, v};
    for (int i = 0; i < 3; ++i) {
        int e = encode(&maps[i], bases[i], geom + 12 * i, D);
        if (e) return e;
    }
    const int B = (int)geom[3], H = (int)geom[2];
    const int smem = (int)sizeof(Smem<D>) + 1024;
    cudaError_t e = cudaFuncSetAttribute(dense_mha_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((a.N + BQ - 1) / BQ, H, B);
    dense_mha_kernel<D><<<grid, THREADS, smem, stream>>>(maps[0], maps[1], maps[2], a);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  q/k/v/o are device pointers to
// head 0 of batch 0.  geom[36] holds the TMA geometry of q, k and v, 12
// values each (ops/dense_mha.py:tma_geometry): dims (D, N, H, B), byte
// strides of rows, heads and batch (multiples of 16), box (D, 128, 1, 1) and
// the swizzle in bytes (2*D).  o_strides[3] holds the output's batch, head
// and row strides in elements (unit stride along D); the output is bf16, or
// fp32 with out_f32.  Returns 0 on success, a cudaError_t code, or one of
// the ERR_ codes above.
extern "C" int dense_mha_launch(const void* q, const void* k, const void* v, void* o,
                                const long long* geom, const long long* o_strides, int out_f32,
                                float scale, void* stream) {
    OutArgs a;
    a.o = o;
    a.out_f32 = out_f32 ? 1 : 0;
    a.sb = o_strides[0];
    a.sh = o_strides[1];
    a.sn = o_strides[2];
    a.N = (int)geom[1];
    a.scale = scale;
    cudaStream_t s = (cudaStream_t)stream;
    switch (geom[0]) {
        case 16: return launch<16>(q, k, v, geom, a, s);
        case 32: return launch<32>(q, k, v, geom, a, s);
        case 64: return launch<64>(q, k, v, geom, a, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
