#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (pgtformer_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
 1. the card's name and power limit, torch/CUDA versions, TF32 off;
 2. build the hand-written kernels from pgtformer_tpu_torch/csrc/ with nvcc
    (one process per source, in parallel) and print ptxas register/smem use
    (K7's and K8's registers and spilled bytes summed up);
 3. each kernel's wrapper against its plain PyTorch version on the card at
    the shapes its path gives it, with its time, the plain version's time,
    the bound from shapes and, where one PyTorch call computes the same
    function, that call's time as a yardstick (the port never calls it):
    K1 sw_block, K3 sw_block_tokens, K4 sw_block_pair (also bit-equal to two
    K1 launches), K2/K6 dense_mha in both layouts (two launches and the two
    layouts bit-equal, achieved TFLOP/s and share of the bound; edge cases:
    partial tiles, D=32 and 16, strongly negative and sharp logits), K5
    nearest_code (rate of agreement, every disagreement a near-tie in fp64,
    ragged shapes, a codebook of near-twins, an exact tie), K7
    gn_silu_conv3x3 in its four forms at 8 x 512 x 512 (TFLOP/s and share of
    the bound; 30 launches bit-equal there and at ragged shapes) and K8
    subpixel_up_conv3x3 at its four shapes (output and emitted statistics,
    ragged shapes, a strided batch), each beside the stock PyTorch sequence
    for the same function;
 4. the serving step at full width: RELEASE_PGTFORMER (512x512, B=8
    windows) with seeded random weights through VideoRestorer, prime + 5
    chunks; asserts exactly 22 K1 and 9 K6 launches per step and no other
    kernel's, and prints step time, frames/s and peak memory;
 5. the same step under its other evaluation plans (SW_KERNEL=tokens: 22 K3;
    SW_PAIR=1: 11 K4; mha_layout="bhnd": 9 K2), each with exact launch
    counts, its step time beside the default's, and its uint8 output
    compared with the default step's on the same frames; and under the
    fused decoder tail (FUSED_TAIL=1: 22 K1 + 9 K6 + 1 K8 + 4 K7;
    FUSED_TAIL=up: 22 K1 + 9 K6 + 4 K8), whose output rounds to bf16 at
    other places and is held to a mean and a maximum difference;
 6. the autoencoder / code path at full width: TDCRQVAE3 forward on 2 clips
    of 3 frames at 512x512 (22 K1 + 1 K5), decode_code(get_codes(x)) against
    the forward's output, the forward under FUSED_TAIL=up (+ 4 K8) against
    the default forward and under FUSED_TAIL=1 (three frames per clip at the
    last upsample: the stock tail, no K7/K8), and PGTFormer.get_codes on 8
    clips (8 K1 + 1 K5);
 7. the whole models at a small geometry: CUDA bf16 (kernels) against CPU
    fp32 (plain versions): PGTFormer (lq_feat and logits error, code
    agreement held to a CPU bf16 run's, forced-code restoration) and
    TDCRQVAE3 (latent error, code agreement, forced-code decode); and a
    small PGTFormer whose geometry passes the fused tail's guard, under
    FUSED_TAIL=1: CUDA bf16 (kernels) against CPU bf16 (the plain chain);
 8. a JSON line of kernel numbers, then the device JSON as the last line.

Launch counts are set to 0 just before each path is driven and read just
after it; launches made to compare or time a kernel do not count.
"""

from __future__ import annotations

import hashlib
import json
import re
import subprocess
import sys
import time

H100_BF16_FLOPS = 989e12     # dense bf16 tensor-core peak, H100 SXM
H100_FP32_FLOPS = 67e12      # fp32 peak outside the tensor cores, H100 SXM
H100_BYTES_PER_S = 3.35e12   # HBM3 bandwidth, H100 SXM

K1_TOL = 2e-2   # max|kernel - plain| <= K1_TOL * max|plain|: bf16 rounding of
                # every intermediate in the plain version vs fp32 residual/LN
                # in the kernel, over two GEMM chains (K1, K3 and K4)
K2_TOL = 1e-2   # max|kernel - plain| <= K2_TOL * max|plain|: bf16 probabilities
                # rounded before (kernel) vs after (plain) normalization
K5_AGREE = 0.999        # share of rows on which kernel and plain pick one code
K5_NEAR_TIE = 1e-5      # on any other row: |d_kernel - d_plain| <= this * d_plain,
                        # distances recomputed in fp64 (summation order only)
SMALL_LQ_TOL = 5e-2      # ||lq_cuda - lq_cpu|| / ||lq_cpu|| (bf16 vs fp32 encoder)
SMALL_LOGIT_TOL = 5e-2   # ||logits_cuda - logits_cpu|| / ||logits_cpu||
# Code agreement, CUDA bf16 vs CPU fp32.  With random weights the top-2
# logits of ~2.7% of tokens lie within bf16 noise of each other, so a bf16
# run of the plain versions on the CPU flips as many codes as the kernels
# do (0.973 for both at this geometry).  The check holds the CUDA path to that same-
# run bf16 baseline (minus SMALL_AGREE_SLACK) and to an absolute floor.
SMALL_AGREE = 0.95
SMALL_AGREE_SLACK = 0.01
SMALL_OUT_TOL = 5e-2     # mean|out_cuda - out_cpu| / max|out_cpu|, forced codes
# decode_code(get_codes(x)) vs the forward's output, bf16: the forward
# decodes x + (q - x) rounded in bf16, decode_code decodes q rounded once,
# so the decoder inputs differ by up to a bf16 ulp; mean|d| / max|out|.
VAE_ROUNDTRIP_TOL = 2e-2
VARIANT_LSB = 1          # max |uint8 difference| between a variant step and the default
K7_TOL = 1e-2   # max|kernel - plain| <= K7_TOL * max|plain| (K7 and K8): one bf16 ulp
                # of the output where fp32 sums in another order round the other way
K7_STATS_TOL = 1e-3     # emitted (sum, sumsq) per channel: max|d| over the channels
                        # <= this * the largest per-channel value of that kind
# The fused tail rounds to bf16 at other places than the stock modules (the
# GroupNorm affine from fp32 statistics of rounded outputs, one rounding after
# bias + shortcut + residual; the upsample's 2x2 phase kernels are sums of
# 3x3 taps rounded once more), so its uint8 frames are close to the default
# step's, not equal.  (mean |d|, max |d|) in LSB per plan, each about twice
# what the first run on an H100 measured (0.45 / 10 for the tail; 1.02 / 20
# for `up`, whose three earlier upsamples feed seven attention layers that
# amplify a bf16 ulp under random weights).
FUSED_LSB = {"fused_tail": (1.0, 20), "fused_up": (2.0, 40)}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, peak_flops: float = H100_BF16_FLOPS):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _wrappers():
    """Every kernel wrapper that carries a launch count, by its JSON name."""
    from pgtformer_tpu_torch.ops.dense_mha import dense_mha_bhnd, dense_mha_bnhd
    from pgtformer_tpu_torch.ops.fused_conv import gn_silu_conv3x3, subpixel_up_conv3x3
    from pgtformer_tpu_torch.ops.sw_block import sw_block, sw_block_pair, sw_block_tokens
    from pgtformer_tpu_torch.ops.vq import nearest_code
    return {"sw_block": sw_block, "sw_block_tokens": sw_block_tokens,
            "sw_block_pair": sw_block_pair, "dense_mha_bhnd": dense_mha_bhnd,
            "dense_mha_bnhd": dense_mha_bnhd, "vq_nearest": nearest_code,
            "gn_silu_conv3x3": gn_silu_conv3x3, "subpixel_up_conv3x3": subpixel_up_conv3x3}


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def expect_counts(what: str, **want) -> dict:
    """Read every launch count; exactly the named kernels were launched,
    each exactly as often as named."""
    got = {name: fn.launches for name, fn in _wrappers().items()}
    expected = {name: want.get(name, 0) for name in got}
    if got != expected:
        raise SystemExit(f"{what}: launch counts {got}, expected {expected}")
    return got


def phase_device():
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from pgtformer_tpu_torch.ops import _build
    t0 = time.perf_counter()
    reports = _build.build(force=True)
    log(f"[build] {len(reports)} sources in {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill", "smem", "C75")):
                log(f"[build:{name}] {line.strip()}")
    for name in ("fused_conv", "subpixel_up"):
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", reports[name])]
        spill = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", reports[name]))
        log(f"[build:{name}] {len(regs)} kernels, at most {max(regs)} registers, "
            f"{spill} bytes spilled")


def _sw_block_weights(C: int, heads: int, T: int, seed: int):
    import torch
    from pgtformer_tpu_torch.nn.blocks import SWTransformerBlock, init_weights
    g = torch.Generator().manual_seed(seed)
    blk = SWTransformerBlock(C, heads, T, (4, 4), (0, 0), mlp_ratio=1.0)
    init_weights(blk, g)
    with torch.no_grad():
        for p in blk.parameters():      # non-trivial biases and norm affines
            if p.dim() == 1:
                p.add_(torch.randn(p.shape, generator=g) * 0.1)
    return blk.cuda().kernel_weights(torch.device("cuda"))


def _compare(name: str, out, ref, tol: float):
    """(max|out - ref|, max|ref|); exits unless finite and within tol * max|ref|."""
    import torch
    err = (out.float() - ref.float()).abs().max().item()
    mag = ref.float().abs().max().item()
    if not (bool(torch.isfinite(out).all().item()) and err <= tol * mag):
        raise SystemExit(f"{name} disagrees with its plain version: max|d|={err:.3e}, "
                         f"max|ref|={mag:.3e}, tol {tol}*max|ref|")
    return err, mag


# (shape [B,T,H,W,C], shift, launches of this shape per serving step)
K1_CASES = [((8, 3, 128, 128, 256), (0, 0), 3), ((8, 3, 128, 128, 256), (2, 2), 3),
            ((8, 3, 64, 64, 256), (0, 0), 3), ((8, 3, 64, 64, 256), (2, 2), 3),
            ((8, 3, 32, 32, 512), (0, 0), 5), ((8, 3, 32, 32, 512), (2, 2), 5)]
# 3 windows at C=256: 3 slabs at two per CTA, so the last CTA's second slab
# lies past the input; and 7 windows of N=16 at C=512: 3 slabs of three
# windows (one per CTA), the last slab holding one window
K1_RAGGED = [((1, 3, 4, 12, 256), (2, 2)), ((1, 1, 4, 28, 512), (2, 2))]


def _sw_block_flops(shape, blocks: int = 1) -> float:
    B, T, H, W, C = shape
    return blocks * B * T * H * W * (12 * C * C + 4 * T * 16 * C)


def _sw_block_bound(shape, blocks: int = 1, mask_bytes: int = 0):
    """Bound of `blocks` SW blocks in one launch: x read once and written
    once, each block's weights, bias table (and the mask array) read once."""
    B, T, H, W, C = shape
    M = B * T * H * W
    N = T * 16
    flops = _sw_block_flops(shape, blocks)
    nbytes = 2 * M * C * 2 + blocks * (6 * C * C * 2 + 10 * C * 4 + 8 * N * N * 4) + mask_bytes
    return bound_ms(flops, nbytes)


def _case_input(i: int, shape):
    import torch
    g = torch.Generator(device="cuda").manual_seed(i)
    return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)


def phase_k1(iters: int):
    import torch
    from pgtformer_tpu_torch.ops.sw_block import sw_block, sw_block_plain
    rows, worst = [], 0.0
    for i, (shape, shift, per_step) in enumerate(K1_CASES):
        w = _sw_block_weights(shape[-1], 8, shape[1], seed=100 + i)
        x = _case_input(i, shape)
        out = sw_block(x, w, shift)
        ref = sw_block_plain(x, w, shift)
        torch.cuda.synchronize()
        err, scale = _compare(f"K1 {shape} {shift}", out, ref, K1_TOL)
        ms = time_ms(lambda: sw_block(x, w, shift), iters)
        plain = time_ms(lambda: sw_block_plain(x, w, shift), max(1, iters // 4), warmup=1)
        bms, by = _sw_block_bound(shape)
        tflops = _sw_block_flops(shape) / ms / 1e9
        log(f"[k1] x{list(shape)} shift{shift}: max|d|={err:.3e} (max|ref|={scale:.3e}, "
            f"tol {K1_TOL}*max|ref|) kernel_ms={ms:.4f} ({tflops:.1f} TFLOP/s, "
            f"{bms / ms:.3f} of the bound) plain_ms={plain:.4f} bound_ms={bms:.4f} ({by}) OK")
        worst = max(worst, err)
        rows.append(dict(shape=list(shape), shift=list(shift), per_step=per_step,
                         ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, max_abs_err=err,
                         tflops=tflops))
    for i, (shape, shift) in enumerate(K1_RAGGED):
        w = _sw_block_weights(shape[-1], 8, shape[1], seed=150 + i)
        x = _case_input(50 + i, shape)
        out = sw_block(x, w, shift)
        err, scale = _compare(f"K1 ragged {shape}", out, sw_block_plain(x, w, shift), K1_TOL)
        if not torch.equal(sw_block(x, w, shift), out):
            raise SystemExit(f"K1 ragged {shape}: two launches differ")
        log(f"[k1] ragged x{list(shape)} shift{shift}: max|d|={err:.3e} "
            f"(max|ref|={scale:.3e}, tol {K1_TOL}*max|ref|), two launches bit-equal OK")
        worst = max(worst, err)
    return rows, worst


def phase_k3(iters: int):
    """K3 on the six K1 shapes as window-token arrays (rolled and masked for
    the shifted ones), against sw_block_tokens_plain."""
    import torch
    from pgtformer_tpu_torch.ops.sw_block import (
        sw_block, sw_block_tokens, sw_block_tokens_plain)
    from pgtformer_tpu_torch.ops.window import shifted_window_mask, window_partition
    rows, worst = [], 0.0
    for i, (shape, shift, per_step) in enumerate(K1_CASES):
        B, T, H, W, C = shape
        w = _sw_block_weights(C, 8, T, seed=100 + i)
        x = _case_input(i, shape)
        shifted = any(shift)
        rolled = torch.roll(x, (-shift[0], -shift[1]), dims=(2, 3)) if shifted else x
        tok = window_partition(rolled, (4, 4)).contiguous()
        nW = (H // 4) * (W // 4)
        mask = (torch.as_tensor(shifted_window_mask(T, H, W, (4, 4), shift), device="cuda")
                if shifted else None)
        out = sw_block_tokens(tok, w, mask, nW)
        ref = sw_block_tokens_plain(tok, w, mask, nW)
        torch.cuda.synchronize()
        err, scale = _compare(f"K3 {shape} {shift}", out, ref, K1_TOL)
        # the same windows through K1 (one device function): expected equal
        k1_tok = window_partition(
            torch.roll(sw_block(x, w, shift), (-shift[0], -shift[1]), dims=(2, 3)), (4, 4))
        same = bool(torch.equal(out, k1_tok))
        ms = time_ms(lambda: sw_block_tokens(tok, w, mask, nW), iters)
        plain = time_ms(lambda: sw_block_tokens_plain(tok, w, mask, nW),
                        max(1, iters // 4), warmup=1)
        bms, by = _sw_block_bound(shape, mask_bytes=0 if mask is None else mask.numel() * 4)
        log(f"[k3] tokens{list(tok.shape)} of x{list(shape)} shift{shift}: max|d|={err:.3e} "
            f"(max|ref|={scale:.3e}, tol {K1_TOL}*max|ref|) bit_equal_to_k1={same} "
            f"kernel_ms={ms:.4f} plain_ms={plain:.4f} bound_ms={bms:.4f} ({by}) OK")
        worst = max(worst, err)
        rows.append(dict(shape=list(tok.shape), shift=list(shift), per_step=per_step, ms=ms,
                         plain_ms=plain, bound_ms=bms, bound_by=by, max_abs_err=err,
                         bit_equal_to_k1=same))
    return rows, worst


# (shape, [no-shift, shift] pairs of this shape per serving step)
K4_CASES = [((8, 3, 128, 128, 256), 3), ((8, 3, 64, 64, 256), 3), ((8, 3, 32, 32, 512), 5)]


def phase_k4(iters: int):
    """K4 on the serving step's three layer shapes: bit-equal to two K1
    launches, within K1's tolerance of the plain pair."""
    import torch
    from pgtformer_tpu_torch.ops.sw_block import sw_block, sw_block_pair, sw_block_pair_plain
    rows, worst = [], 0.0
    half = (2, 2)
    for i, (shape, per_step) in enumerate(K4_CASES):
        w0 = _sw_block_weights(shape[-1], 8, shape[1], seed=200 + i)
        w1 = _sw_block_weights(shape[-1], 8, shape[1], seed=300 + i)
        x = _case_input(10 + i, shape)
        two = lambda: sw_block(sw_block(x, w0, (0, 0)), w1, half)
        out = sw_block_pair(x, w0, w1, half)
        ref2 = two()
        plain_out = sw_block_pair_plain(x, w0, w1, half)
        torch.cuda.synchronize()
        if not torch.equal(out, ref2):
            n = int((out != ref2).sum().item())
            raise SystemExit(f"K4 {shape}: {n} elements differ from two K1 launches")
        err, scale = _compare(f"K4 {shape}", out, plain_out, K1_TOL)
        ms = time_ms(lambda: sw_block_pair(x, w0, w1, half), iters)
        two_ms = time_ms(two, iters)
        plain = time_ms(lambda: sw_block_pair_plain(x, w0, w1, half),
                        max(1, iters // 4), warmup=1)
        bms, by = _sw_block_bound(shape, blocks=2)
        log(f"[k4] x{list(shape)} pair: bit-equal to two K1 launches; max|d|={err:.3e} "
            f"(max|ref|={scale:.3e}, tol {K1_TOL}*max|ref|) kernel_ms={ms:.4f} "
            f"two_k1_launches_ms={two_ms:.4f} plain_ms={plain:.4f} bound_ms={bms:.4f} ({by}) OK")
        worst = max(worst, err)
        rows.append(dict(shape=list(shape), per_step=per_step, ms=ms, two_k1_launches_ms=two_ms,
                         plain_ms=plain, bound_ms=bms, bound_by=by, max_abs_err=err))
    return rows, worst


# (label, B, H, N, D, kind) held to K2_TOL in both layouts besides the
# deployed shape: partial query and key tiles (N not a multiple of 128, and
# N=8: one partial tile of each), D=32 (scale 2^-2.5 is no power of two) and
# D=16; "negative" makes every logit about -9*sqrt(D), so an unmasked
# zero-filled key (logit 0) would take the softmax; "sharp" multiplies the
# logits by 30, so the running max moves by far from tile to tile.
MHA_EDGE_CASES = [("N=200", 1, 2, 200, 64, "normal"), ("N=136", 2, 2, 136, 64, "normal"),
                  ("N=8", 1, 2, 8, 64, "normal"), ("D=32", 2, 4, 768, 32, "normal"),
                  ("D=16", 2, 4, 768, 16, "normal"), ("negative", 1, 2, 200, 64, "negative"),
                  ("sharp", 2, 2, 520, 64, "sharp")]


def mha_operands(B: int, H: int, N: int, D: int, kind: str, seed: int):
    """The serving step's operands on the card: q/k are halves of one packed
    [B, N, 2C] projection, v its own [B, N, C]; returned as that packed
    projection and v."""
    import torch
    C = H * D
    g = torch.Generator(device="cuda").manual_seed(seed)
    qk = torch.randn((B, N, 2 * C), generator=g, device="cuda") * 1.5
    if kind == "negative":
        qk = qk * 0.2
        qk[..., :C] += 3.0
        qk[..., C:] -= 3.0
    elif kind == "sharp":
        qk[..., :C] *= 30.0
    vp = torch.randn((B, N, C), generator=g, device="cuda")
    return qk.to(torch.bfloat16), vp.to(torch.bfloat16)


def _mha_views(qk, vp, H: int, layout: str):
    B, N, C = vp.shape
    split = lambda a: a.reshape(B, N, H, C // H)
    view = split if layout == "bnhd" else (lambda a: split(a).transpose(1, 2))
    return view(qk[..., :C]), view(qk[..., C:]), view(vp)


def _mha_check(label: str, qk, vp, H: int):
    """Both layouts against their plain versions; two launches bit-equal;
    bnhd bit-equal to bhnd.  Returns {layout: (out, max|d|, max|ref|)}."""
    import torch
    from pgtformer_tpu_torch.ops.dense_mha import (
        dense_mha, dense_mha_plain, dense_mha_plain_bnhd)
    scale = (qk.shape[-1] // 2 // H) ** -0.5
    res = {}
    for layout, plain_fn in (("bnhd", dense_mha_plain_bnhd), ("bhnd", dense_mha_plain)):
        q, k, v = _mha_views(qk, vp, H, layout)
        out = dense_mha(q, k, v, scale=scale, layout=layout)
        again = dense_mha(q, k, v, scale=scale, layout=layout)
        ref = plain_fn(q, k, v, scale)
        torch.cuda.synchronize()
        err, mag = _compare(f"dense_mha {layout} {label}", out, ref, K2_TOL)
        if not torch.equal(out, again):
            raise SystemExit(f"dense_mha {layout} {label}: two launches differ")
        res[layout] = (out, err, mag)
    if not torch.equal(res["bnhd"][0].transpose(1, 2), res["bhnd"][0]):
        raise SystemExit(f"dense_mha {label}: bnhd and bhnd outputs differ")
    return res


def phase_mha(iters: int):
    """K6 (bnhd) and K2 (bhnd) at the code transformer's shape, each against
    its plain version, bit-equal across two launches and across the two
    layouts; SDPA on the same operands as the yardstick; then the edge
    cases of MHA_EDGE_CASES."""
    import torch.nn.functional as F
    from pgtformer_tpu_torch.ops.dense_mha import (
        dense_mha, dense_mha_plain, dense_mha_plain_bnhd)
    B, H, N, D = 8, 8, 3072, 64
    C = H * D
    scale = D ** -0.5
    qk, vp = mha_operands(B, H, N, D, "normal", seed=7)
    flops = 4 * B * H * N * N * D
    nbytes = 4 * B * N * C * 2
    bms, by = bound_ms(flops, nbytes)
    checked = _mha_check("[8, 3072, 8, 64]", qk, vp, H)
    res = {}
    for layout, plain_fn in (("bnhd", dense_mha_plain_bnhd), ("bhnd", dense_mha_plain)):
        q, k, v = _mha_views(qk, vp, H, layout)
        _, err, mag = checked[layout]
        ms = time_ms(lambda: dense_mha(q, k, v, scale=scale, layout=layout), iters)
        plain = time_ms(lambda: plain_fn(q, k, v, scale), max(1, iters // 4), warmup=1)
        hq, hk, hv = (a if layout == "bhnd" else a.transpose(1, 2) for a in (q, k, v))
        lib = time_ms(lambda: F.scaled_dot_product_attention(hq, hk, hv, scale=scale), iters)
        log(f"[mha:{layout}] q/k/v {list(q.shape)} (views of packed projections): "
            f"max|d|={err:.3e} (max|ref|={mag:.3e}, tol {K2_TOL}*max|ref|), two launches "
            f"bit-equal, bnhd == bhnd; kernel_ms={ms:.4f} ({flops / ms / 1e9:.1f} TFLOP/s, "
            f"{bms / ms:.3f} of the bound) plain_ms={plain:.4f} sdpa_ms={lib:.4f} "
            f"bound_ms={bms:.4f} ({by}) OK")
        res[layout] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
                           max_abs_err=err, tflops=flops / ms / 1e9)
    for i, (label, b, h, n, d, kind) in enumerate(MHA_EDGE_CASES):
        checked = _mha_check(label, *mha_operands(b, h, n, d, kind, seed=20 + i), h)
        log(f"[mha:edge] {label} [B={b}, H={h}, N={n}, D={d}] ({kind}): "
            + ", ".join(f"{lay} max|d|={e:.3e} (max|ref|={m:.3e})"
                        for lay, (_, e, m) in checked.items())
            + f", tol {K2_TOL}*max|ref|, two launches bit-equal, bnhd == bhnd OK")
    return res


def _fp64_gap(x, codes, a, b):
    """(absolute, relative) gap of the exact squared distances of choices a
    and b, per row."""
    xd = x.double()
    da = ((xd - codes[a].double()) ** 2).sum(-1)
    db = ((xd - codes[b].double()) ** 2).sum(-1)
    return (da - db).abs(), (da - db).abs() / db


def phase_k5(iters: int):
    """K5 at the deployed shape (8 clips x 3 frames x 32x32 latents against
    the 1024 x 512 codebook), a ragged shape and an exact tie."""
    import torch
    from pgtformer_tpu_torch.ops.vq import nearest_code, nearest_code_plain
    N, n, D = 24576, 1024, 512
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((N, D), generator=g, device="cuda")
    codes = torch.randn((n, D), generator=g, device="cuda")

    def check(what, xs, cs, need_rate=True):
        out = nearest_code(xs, cs)
        ref = nearest_code_plain(xs, cs)
        torch.cuda.synchronize()
        if out.dtype != torch.int64 or out.shape != (xs.shape[0],):
            raise SystemExit(f"K5 {what}: output {out.dtype} {tuple(out.shape)}")
        if int(out.min()) < 0 or int(out.max()) >= cs.shape[0]:
            raise SystemExit(f"K5 {what}: index out of range")
        differ = torch.nonzero(out != ref).flatten()
        agree = 1.0 - len(differ) / xs.shape[0]
        abs_gap = gap = 0.0
        if len(differ):
            ag, rg = _fp64_gap(xs[differ], cs, out[differ], ref[differ])
            abs_gap, gap = ag.max().item(), rg.max().item()
        ok = (agree >= K5_AGREE or not need_rate) and gap <= K5_NEAR_TIE
        log(f"[k5] {what}: x{list(xs.shape)} codes{list(cs.shape)} agreement={agree:.6f} "
            f"({f'need >= {K5_AGREE}' if need_rate else 'no rate asked'}) rows_differing={len(differ)} worst_fp64_gap={gap:.3e} "
            f"(need <= {K5_NEAR_TIE}) {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"K5 {what} disagrees with its plain version")
        return len(differ), abs_gap, gap

    n_diff, abs_gap, gap = check("deployed shape", x, codes)
    check("ragged N and n", x[:1000], codes[:1000].contiguous())
    check("ragged D", x[:257, :36].contiguous(), codes[:100, :36].contiguous())
    # every code has a twin one fp32 ulp away: each row's two best distances
    # are a near-tie, so kernel and plain may part ways, but only by rounding
    twins = torch.cat([codes[:n // 2], codes[:n // 2] * (1.0 + 2.0 ** -23)])
    check("near-tie stress (codebook of twins)", x[:4096], twins, need_rate=False)
    tied = codes.clone()
    tied[900] = tied[130]       # a later tile of 128 codes,
    tied[200] = tied[130]       # another thread of the same tile,
    tied[131] = tied[130]       # and the same thread's next code
    near = tied[130][None] + 0.01 * torch.randn((64, D), generator=g, device="cuda")
    picked = nearest_code(near, tied)
    if not bool((picked == 130).all()):
        raise SystemExit(f"K5 exact tie: picked {picked.unique().tolist()}, expected 130")
    log("[k5] exact tie (codes 130 = 131 = 200 = 900): lowest index wins OK")

    ms = time_ms(lambda: nearest_code(x, codes), iters)
    plain = time_ms(lambda: nearest_code_plain(x, codes), iters)
    csq = (codes * codes).sum(-1)
    lib = time_ms(lambda: torch.addmm(csq, x, codes.T, alpha=-2.0).argmin(-1), iters)
    bms, by = bound_ms(2.0 * N * n * D, (N * D + n * D) * 4 + N * 8, H100_FP32_FLOPS)
    log(f"[k5] x[{N},{D}] codes[{n},{D}] fp32: kernel_ms={ms:.4f} ("
        f"{2.0 * N * n * D / ms / 1e9:.1f} TFLOP/s, {bms / ms:.3f} of the bound) plain_ms={plain:.4f} "
        f"addmm_argmin_ms={lib:.4f} (fp32 matmul, TF32 off) bound_ms={bms:.4f} ({by} at the "
        f"{H100_FP32_FLOPS / 1e12:.0f} TFLOP/s fp32 peak)")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
                max_abs_err=abs_gap, rows_differing=n_diff, worst_fp64_rel_gap=gap)


def _compare_stats(name: str, st, ref):
    """Largest error of the emitted statistics, relative to the largest
    per-channel value of its kind; exits beyond K7_STATS_TOL."""
    err = ((st - ref).abs().amax(dim=(0, 2)) / ref.abs().amax(dim=(0, 2))).max().item()
    if not err <= K7_STATS_TOL:
        raise SystemExit(f"{name}: emitted statistics differ from the plain version's by "
                         f"{err:.3e} of the largest value (tol {K7_STATS_TOL})")
    return err


def _k7_operands(seed: int, N: int, H: int, W: int, C: int, Cs: int, residual: bool):
    """x with its GroupNorm affine folded from its own statistics, a fan-in
    scaled kernel, and the form's shortcut or residual."""
    import torch
    from pgtformer_tpu_torch.ops.fused_conv import channel_stats, gn_affine_from_stats
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    bf = torch.bfloat16
    x = (rnd(N, H, W, C) * 0.7 + 0.2).to(bf)
    gamma, beta = 1.0 + 0.1 * rnd(C), 0.1 * rnd(C)
    ab = gn_affine_from_stats(channel_stats(x), gamma, beta, H * W)
    k = (rnd(3, 3, C, 64) * (9 * C) ** -0.5).to(bf)
    bias = 0.1 * rnd(64)
    kw = {}
    if Cs:
        kw["shortcut"] = ((rnd(N, H, W, Cs) * 0.7).to(bf), (rnd(Cs, 64) * Cs ** -0.5).to(bf),
                          0.1 * rnd(64))
    if residual:
        kw["residual"] = (rnd(N, H, W, 64) * 0.7).to(bf)
    return x, ab, (gamma, beta), k, bias, kw


K7_REPEATS = 30   # launches that must be bit-equal, output and statistics

# (name, C, Cs, residual): the four launches of the fused tail per serving step
K7_FORMS = [("128->64", 128, 0, False), ("64->64 + 1x1 shortcut from 128", 64, 128, False),
            ("64->64", 64, 0, False), ("64->64 + residual", 64, 0, True)]


def _k7_repeats(name: str, fn, out, st):
    """K7_REPEATS launches of fn bit-equal to (out, st): no atomics, and no
    race between a ring slot's last reads and its refill (which shows only
    with many tiles per CTA)."""
    import torch
    for _ in range(K7_REPEATS - 1):
        o2, s2 = fn()
        if not (torch.equal(o2, out) and torch.equal(s2, st)):
            raise SystemExit(f"K7 {name}: {K7_REPEATS} runs on the same operands differ")


def phase_k7(iters: int):
    """K7 in the fused tail's four forms at 8 x 512 x 512, then ragged shapes
    (N=1, H and W no multiples of the tile), a plain conv (no activation) and
    a strided batch; K7_REPEATS launches bit-equal at every form and ragged
    shape."""
    import torch
    import torch.nn.functional as F
    from pgtformer_tpu_torch.ops.fused_conv import gn_silu_conv3x3, gn_silu_conv3x3_plain
    N, H, W = 8, 512, 512
    nchw = lambda a: a.permute(0, 3, 1, 2)
    rows, worst = [], 0.0
    for i, (name, C, Cs, residual) in enumerate(K7_FORMS):
        x, ab, (gamma, beta), k, bias, kw = _k7_operands(40 + i, N, H, W, C, Cs, residual)
        out, st = gn_silu_conv3x3(x, ab, k, bias, **kw)
        ref, ref_st = gn_silu_conv3x3_plain(x, ab, k, bias, **kw)
        torch.cuda.synchronize()
        err, mag = _compare(f"K7 {name}", out, ref, K7_TOL)
        st_err = _compare_stats(f"K7 {name}", st, ref_st)
        _k7_repeats(name, lambda: gn_silu_conv3x3(x, ab, k, bias, **kw), out, st)
        ms = time_ms(lambda: gn_silu_conv3x3(x, ab, k, bias, **kw), iters)
        ms_bare = time_ms(lambda: gn_silu_conv3x3(x, ab, k, bias, emit_stats=False, **kw), iters)
        # the same launch without the activation (a plain conv): what the
        # in-place SiLU costs
        ms_conv = time_ms(lambda: gn_silu_conv3x3(x, None, k, bias, emit_stats=False, **kw), iters)
        plain = time_ms(lambda: gn_silu_conv3x3_plain(x, ab, k, bias, **kw), 1, warmup=0)
        # the stock modules' sequence for the same function, bf16 through cuDNN
        bf = torch.bfloat16
        w16, b16 = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last), bias.to(bf)
        g16, be16 = gamma.to(bf), beta.to(bf)
        if Cs:
            xs, sk, sb = kw["shortcut"]
            sk16, sb16 = sk.t().reshape(64, Cs, 1, 1).contiguous(), sb.to(bf)

        def stock():
            o = F.conv2d(F.silu(F.group_norm(nchw(x), 32, g16, be16, 1e-6)), w16, b16, padding=1)
            if Cs:
                o = o + F.conv2d(nchw(xs), sk16, sb16)
            if residual:
                o = o + nchw(kw["residual"])
            return o

        lib = time_ms(stock, iters)
        flops = 2.0 * N * H * W * 64 * (9 * C + Cs)
        nbytes = (N * H * W * (C + 64 + Cs + (64 if residual else 0)) * 2
                  + (9 * C + Cs) * 64 * 2 + 2 * N * C * 4 + 2 * N * 64 * 4 + 64 * 8)
        bms, by = bound_ms(flops, nbytes)
        tflops = flops / ms * 1e-9
        log(f"[k7] {name}: x[{N},{H},{W},{C}] max|d|={err:.3e} (max|ref|={mag:.3e}, tol "
            f"{K7_TOL}*max|ref|) stats_err={st_err:.3e} (tol {K7_STATS_TOL}) "
            f"{K7_REPEATS} launches bit-equal kernel_ms={ms:.4f} without_stats_ms={ms_bare:.4f} "
            f"without_stats_or_activation_ms={ms_conv:.4f} plain_ms={plain:.4f} "
            f"stock_sequence_ms={lib:.4f} bound_ms={bms:.4f} ({by}) "
            f"{tflops:.1f} TFLOP/s = {bms / ms:.3f} of the bound OK")
        worst = max(worst, err)
        rows.append(dict(form=name, shape=[N, H, W, C], per_step=1, ms=ms,
                         without_stats_ms=ms_bare, without_activation_ms=ms_conv,
                         plain_ms=plain,
                         library_ms=lib, bound_ms=bms, bound_by=by, max_abs_err=err,
                         stats_err=st_err, tflops=tflops, bound_share=bms / ms))
        del x, ab, k, kw, out, ref
    for i, (name, C, Cs, residual) in enumerate(K7_FORMS):
        x, ab, _, k, bias, kw = _k7_operands(50 + i, 1, 37, 53, C, Cs, residual)
        out, st = gn_silu_conv3x3(x, ab, k, bias, **kw)
        ref, ref_st = gn_silu_conv3x3_plain(x, ab, k, bias, **kw)
        err, _ = _compare(f"K7 ragged {name}", out, ref, K7_TOL)
        st_err = _compare_stats(f"K7 ragged {name}", st, ref_st)
        _k7_repeats(f"ragged {name}", lambda: gn_silu_conv3x3(x, ab, k, bias, **kw), out, st)
        log(f"[k7] ragged x[1,37,53,{C}] {name}: max|d|={err:.3e} stats_err={st_err:.3e} "
            f"{K7_REPEATS} launches bit-equal OK")
    x, _, _, k, bias, _ = _k7_operands(60, 2, 24, 40, 128, 0, False)
    out, st = gn_silu_conv3x3(x, None, k, bias, emit_stats=False)
    err, _ = _compare("K7 plain conv", out, gn_silu_conv3x3_plain(x, None, k, bias)[0], K7_TOL)
    frames = torch.stack([x, x + 1, x - 1], dim=1)            # [2, 3, H, W, C]
    mid = frames[:, 1:2].reshape(2, 24, 40, 128)              # a view: batch stride 3*H*W*C
    same = torch.equal(gn_silu_conv3x3(mid, None, k, bias, emit_stats=False)[0],
                       gn_silu_conv3x3(mid.contiguous(), None, k, bias, emit_stats=False)[0])
    if st is not None or mid.is_contiguous() or not same:
        raise SystemExit("K7: emit_stats=False or the strided batch went wrong")
    log(f"[k7] no activation x[2,24,40,128]: max|d|={err:.3e}; strided batch equals its copy OK")
    return rows, worst


# (x shape [N,H,W,C], launches per serving step under FUSED_TAIL=1, under FUSED_TAIL=up)
K8_CASES = [((8, 256, 256, 128), 1, 1), ((24, 32, 32, 512), 0, 1), ((24, 64, 64, 256), 0, 1),
            ((24, 128, 128, 256), 0, 1)]


def _k8_operands(seed: int, shape):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    C = shape[-1]
    x = (torch.randn(shape, generator=g, device="cuda") * 0.7).to(torch.bfloat16)
    k3 = (torch.randn((3, 3, C, C), generator=g, device="cuda") * (9 * C) ** -0.5)
    bias = 0.1 * torch.randn((C,), generator=g, device="cuda")
    return x, k3.to(torch.bfloat16), bias


def phase_k8(iters: int):
    """K8 at the four upsample shapes of the serving step, with and without
    statistics, then ragged shapes and a strided batch."""
    import torch
    import torch.nn.functional as F
    from pgtformer_tpu_torch.ops.fused_conv import (
        _up_lib, phase_kernels_2x2, subpixel_up_conv3x3, subpixel_up_conv3x3_plain)
    rows, worst = [], 0.0
    for i, (shape, per_tail, per_up) in enumerate(K8_CASES):
        N, H, W, C = shape
        x, k3, bias = _k8_operands(70 + i, shape)
        k2 = phase_kernels_2x2(k3).to(torch.bfloat16)
        out, st = subpixel_up_conv3x3(x, k2, bias)
        ref, ref_st = subpixel_up_conv3x3_plain(x, k2, bias)
        torch.cuda.synchronize()
        err, mag = _compare(f"K8 {shape}", out, ref, K7_TOL)
        st_err = _compare_stats(f"K8 {shape}", st, ref_st)
        bare, none = subpixel_up_conv3x3(x, k3, bias, emit_stats=False)
        if none is not None or not torch.equal(bare, out):
            raise SystemExit(f"K8 {shape}: emit_stats=False or the 3x3 kernel went wrong")
        ms = time_ms(lambda: subpixel_up_conv3x3(x, k2, bias, emit_stats=False), iters)
        ms_st = time_ms(lambda: subpixel_up_conv3x3(x, k2, bias), iters)
        plain = time_ms(lambda: subpixel_up_conv3x3_plain(x, k2, bias), 1, warmup=0)
        w16 = k3.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        b16 = bias.to(torch.bfloat16)
        xc = x.permute(0, 3, 1, 2)
        lib = time_ms(lambda: F.conv2d(F.interpolate(xc, scale_factor=2, mode="nearest"), w16,
                                       b16, padding=1), iters)
        flops = 2.0 * N * H * W * 4 * 4 * C * C
        nbytes = N * H * W * C * 2 * 5 + 16 * C * C * 2 + C * 4
        bms, by = bound_ms(flops, nbytes)
        # every work item (one pixel tile x 64 output channels x one output
        # row phase: one statistics partial each) reads its 64 columns of
        # the eight phase matrices of its row phase from L2
        items = N * _up_lib().subpixel_up_conv3x3_tiles(H, W) * (C // 64)
        wbytes = items * 8 * C * 64 * 2
        tflops = flops / ms * 1e-9
        feed = wbytes / ms * 1e-9
        log(f"[k8] x{list(shape)}: max|d|={err:.3e} (max|ref|={mag:.3e}, tol {K7_TOL}*max|ref|) "
            f"stats_err={st_err:.3e} (tol {K7_STATS_TOL}) kernel_ms={ms:.4f} "
            f"with_stats_ms={ms_st:.4f} plain_ms={plain:.4f} interpolate_conv_ms={lib:.4f} "
            f"bound_ms={bms:.4f} ({by}) {tflops:.1f} TFLOP/s = {bms / ms:.3f} of the bound; "
            f"L2 weight reads {wbytes / 1e9:.3f} GB/launch = {feed:.3f} TB/s OK")
        worst = max(worst, err)
        rows.append(dict(shape=list(shape), per_step=per_up, per_step_fused_tail=per_tail, ms=ms,
                         with_stats_ms=ms_st, plain_ms=plain, library_ms=lib, bound_ms=bms,
                         bound_by=by, max_abs_err=err, stats_err=st_err, tflops=tflops,
                         bound_share=bms / ms, l2_weight_gb=wbytes / 1e9, weight_feed_tb_s=feed))
        del x, out, ref, bare
    for i, shape in enumerate([(1, 13, 21, 128), (1, 9, 37, 64)]):
        x, k3, bias = _k8_operands(80 + i, shape)
        out, st = subpixel_up_conv3x3(x, k3, bias)
        ref, ref_st = subpixel_up_conv3x3_plain(x, k3, bias)
        err, _ = _compare(f"K8 ragged {shape}", out, ref, K7_TOL)
        st_err = _compare_stats(f"K8 ragged {shape}", st, ref_st)
        log(f"[k8] ragged x{list(shape)}: max|d|={err:.3e} stats_err={st_err:.3e} OK")
    x, k3, bias = _k8_operands(90, (2, 16, 24, 128))
    frames = torch.stack([x + 1, x, x - 1], dim=1)
    mid = frames[:, 1:2].reshape(2, 16, 24, 128)
    if mid.is_contiguous() or not torch.equal(subpixel_up_conv3x3(mid, k3, bias)[0],
                                              subpixel_up_conv3x3(x, k3, bias)[0]):
        raise SystemExit("K8: the strided batch went wrong")
    log("[k8] strided batch (the middle frame of [2,3,16,24,128]) equals its copy OK")
    return rows, worst


def _serve(r, frames, n_chunks: int, B: int):
    """prime + n_chunks steps; returns (outputs, steady step ms over the
    steps after the first)."""
    import torch
    r.reset()
    r.prime(frames[0])
    outs = [r.restore_chunk(frames[1:1 + B])]        # first step (warm-up)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in range(1, n_chunks):
        outs.append(r.restore_chunk(frames[1 + c * B:1 + (c + 1) * B]))
    torch.cuda.synchronize()
    return outs, (time.perf_counter() - t0) * 1e3 / (n_chunks - 1)


def phase_serving(n_chunks: int = 5):
    import numpy as np
    import torch
    from pgtformer_tpu_torch.config import RELEASE_PGTFORMER
    from pgtformer_tpu_torch.pipeline import VideoRestorer

    B = 8
    res = RELEASE_PGTFORMER.vqvae.ddconfig.resolution
    t0 = time.perf_counter()
    r = VideoRestorer(None, RELEASE_PGTFORMER, w=1.0, batch_windows=B,
                      dtype=torch.bfloat16, device="cuda", seed=0)
    log(f"[serve] model built in {time.perf_counter() - t0:.1f} s")
    finite = []
    hook = r.model.decoder.register_forward_hook(
        lambda m, i, o: finite.append(torch.isfinite(o).all()))
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (n_chunks * B + 1, res, res, 3), dtype=np.uint8)

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    outs, step_ms = _serve(r, frames, n_chunks, B)
    counts = expect_counts("default serving step", sw_block=22 * n_chunks,
                           dense_mha_bnhd=9 * n_chunks)
    peak = torch.cuda.max_memory_allocated()
    hook.remove()
    for o in outs:
        if o.shape != (B, res, res, 3) or o.dtype != torch.uint8:
            raise SystemExit(f"serving output {tuple(o.shape)} {o.dtype}")
    if not all(bool(f.item()) for f in finite) or len(finite) != n_chunks:
        raise SystemExit("serving step produced non-finite values")
    # a digest of the restored frames: two trees that print the same one
    # compute the default step bit for bit alike
    digest = hashlib.sha256(b"".join(o.cpu().numpy().tobytes() for o in outs)).hexdigest()[:16]
    log(f"[serve] RELEASE_PGTFORMER {res}x{res}, B={B}: {n_chunks} steps, launches "
        f"K1={counts['sw_block']} (22/step) K6 dense_mha_bnhd={counts['dense_mha_bnhd']} "
        f"(9/step), no other kernel; steady step_ms={step_ms:.2f} "
        f"frames_per_s={B * 1e3 / step_ms:.3f} peak_mem_GiB={peak / 2 ** 30:.2f} "
        f"first_step_s={r._first_chunk_s:.2f} prime_s={r._prime_s:.2f} out_sha256={digest}")
    return dict(counts=counts, steps=n_chunks, step_ms=step_ms, restorer=r, frames=frames,
                outs=outs)


def phase_variants(serve: dict, n_chunks: int = 3):
    """The serving step under its other evaluation plans, on the default
    run's model and frames: launch counts, step time, uint8 output against
    the default step's."""
    import torch
    from pgtformer_tpu_torch import knobs
    from pgtformer_tpu_torch.nn.transformer import MultiHeadSelfAttention
    r, frames, B = serve["restorer"], serve["frames"], 8
    default_ms = serve["step_ms"]

    def set_layout(layout):
        for m in r.model.modules():
            if isinstance(m, MultiHeadSelfAttention):
                m.mha_layout = layout

    # name: (select, expected launches, held to VARIANT_LSB of the default)
    plans = {
        "tokens": (lambda: knobs.set_knob("SW_KERNEL", "tokens"),
                   dict(sw_block_tokens=22 * n_chunks, dense_mha_bnhd=9 * n_chunks), True),
        "pair": (lambda: knobs.set_knob("SW_PAIR", "1"),
                 dict(sw_block_pair=11 * n_chunks, dense_mha_bnhd=9 * n_chunks), True),
        "bhnd": (lambda: set_layout("bhnd"),
                 dict(sw_block=22 * n_chunks, dense_mha_bhnd=9 * n_chunks), True),
        "fused_tail": (lambda: knobs.set_knob("FUSED_TAIL", "1"),
                       dict(sw_block=22 * n_chunks, dense_mha_bnhd=9 * n_chunks,
                            subpixel_up_conv3x3=n_chunks, gn_silu_conv3x3=4 * n_chunks), False),
        "fused_up": (lambda: knobs.set_knob("FUSED_TAIL", "up"),
                     dict(sw_block=22 * n_chunks, dense_mha_bnhd=9 * n_chunks,
                          subpixel_up_conv3x3=4 * n_chunks), False),
    }
    res = {}
    for name, (select, want, same_arithmetic) in plans.items():
        try:
            select()
            reset_counts()
            outs, step_ms = _serve(r, frames, n_chunks, B)
            counts = expect_counts(f"serving step [{name}]", **want)
        finally:
            knobs.reset()
            set_layout("bnhd")
        diff = torch.stack([(a.to(torch.int16) - b.to(torch.int16)).abs()
                            for a, b in zip(outs, serve["outs"])])
        worst, n_diff = int(diff.max().item()), int((diff > 0).sum().item())
        mean = diff.float().mean().item()
        if same_arithmetic:
            ok, need = worst <= VARIANT_LSB, f"need <= {VARIANT_LSB} LSB"
        else:
            mean_lsb, max_lsb = FUSED_LSB[name]
            ok = mean <= mean_lsb and worst <= max_lsb
            need = f"need mean <= {mean_lsb} and max <= {max_lsb} LSB"
        launched = {k: v for k, v in counts.items() if v}
        log(f"[variant:{name}] {n_chunks} steps, launches {launched}; steady "
            f"step_ms={step_ms:.2f} frames_per_s={B * 1e3 / step_ms:.3f} (default "
            f"{default_ms:.2f} ms, {B * 1e3 / default_ms:.3f} frames/s in this run); uint8 "
            f"output vs default: max|d|={worst} LSB, mean|d|={mean:.4f} LSB, {n_diff} of "
            f"{diff.numel()} values differ ({need}) {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"serving step [{name}] differs from the default step")
        res[name] = dict(counts=counts, step_ms=step_ms, max_lsb=worst, mean_lsb=mean,
                         n_diff=n_diff)
    return res


def phase_autoencoder(serve: dict):
    """The autoencoder / code path at full width."""
    import numpy as np
    import torch
    from pgtformer_tpu_torch import knobs
    from pgtformer_tpu_torch.config import RELEASE_PGTFORMER
    from pgtformer_tpu_torch.models.vae import TDCRQVAE3
    cfg = RELEASE_PGTFORMER.vqvae
    res = cfg.ddconfig.resolution
    t0 = time.perf_counter()
    vae = TDCRQVAE3(cfg, generator=torch.Generator().manual_seed(1))
    vae = vae.to(device="cuda", dtype=torch.bfloat16).eval()
    log(f"[vae] TDCRQVAE3 built in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, cfg.tf, res, res, 3)).astype(np.float32))
    x = x.cuda().to(torch.bfloat16)
    n_embed = cfg.n_embed
    with torch.inference_mode():
        vae(x)                                       # warm-up (cuDNN plans)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        out, loss, codes = vae(x)
        torch.cuda.synchronize()
        counts = expect_counts("TDCRQVAE3 forward", sw_block=22, vq_nearest=1)
        peak = torch.cuda.max_memory_allocated()
        if (out.shape != (2 * cfg.tf, res, res, 3) or not bool(torch.isfinite(out).all())
                or not bool(torch.isfinite(loss))):
            raise SystemExit(f"TDCRQVAE3 output {tuple(out.shape)} or non-finite values")
        if (codes.shape != (2 * cfg.tf, 32, 32, 1) or int(codes.min()) < 0
                or int(codes.max()) >= n_embed):
            raise SystemExit(f"TDCRQVAE3 codes {tuple(codes.shape)} or out of range")
        reset_counts()
        again = vae.get_codes(x)
        dec = vae.decode_code(again)
        torch.cuda.synchronize()
        expect_counts("TDCRQVAE3 get_codes + decode_code", sw_block=22, vq_nearest=1)
        if not torch.equal(again, codes):
            raise SystemExit("TDCRQVAE3.get_codes differs from the forward's codes")
        d = (dec.float() - out.float()).abs()
        rt_mean = (d.mean() / out.float().abs().max()).item()
        rt_ok = rt_mean <= VAE_ROUNDTRIP_TOL
        fwd_ms = time_ms(lambda: vae(x), 3, warmup=0)
        codes_ms = time_ms(lambda: vae.get_codes(x), 3, warmup=0)
    log(f"[vae] TDCRQVAE3 {res}x{res}, 2 clips x {cfg.tf} frames, bf16: launches K1=22 K5=1; "
        f"out {list(out.shape)} finite, codes {list(codes.shape)} in [0,{n_embed}), "
        f"commitment={loss.item():.4f}; forward_ms={fwd_ms:.2f} get_codes_ms={codes_ms:.2f} "
        f"peak_mem_GiB={peak / 2 ** 30:.2f}; decode_code(get_codes(x)) vs forward: "
        f"mean|d|/max|out|={rt_mean:.3e} max|d|={d.max().item():.3e} "
        f"(tol {VAE_ROUNDTRIP_TOL}) {'OK' if rt_ok else 'FAIL'}")
    if not rt_ok:
        raise SystemExit("decode_code(get_codes(x)) is not the forward's reconstruction")
    del dec

    # the forward under the fused upsamples (all six frames pass through them),
    # and under FUSED_TAIL=1, whose guard wants one frame per clip at the last
    # upsample and so keeps the stock tail here
    try:
        with torch.inference_mode():
            knobs.set_knob("FUSED_TAIL", "up")
            vae(x)
            torch.cuda.synchronize()
            reset_counts()
            out_up, _, codes_up = vae(x)
            torch.cuda.synchronize()
            expect_counts("TDCRQVAE3 forward [FUSED_TAIL=up]", sw_block=22, vq_nearest=1,
                          subpixel_up_conv3x3=4)
            up_ms = time_ms(lambda: vae(x), 3, warmup=0)
            knobs.set_knob("FUSED_TAIL", "1")
            reset_counts()
            out_1, _, _ = vae(x)
            torch.cuda.synchronize()
            expect_counts("TDCRQVAE3 forward [FUSED_TAIL=1]", sw_block=22, vq_nearest=1)
    finally:
        knobs.reset()
    d_up = (out_up.float() - out.float()).abs()
    up_mean = (d_up.mean() / out.float().abs().max()).item()
    d_1 = (out_1.float() - out.float()).abs().max().item()
    up_ok = (up_mean <= VAE_ROUNDTRIP_TOL and torch.equal(codes_up, codes)
             and bool(torch.isfinite(out_up).all()))
    log(f"[vae] TDCRQVAE3 forward under FUSED_TAIL=up: launches K1=22 K5=1 K8=4; vs the default "
        f"forward mean|d|/max|out|={up_mean:.3e} max|d|={d_up.max().item():.3e} (tol "
        f"{VAE_ROUNDTRIP_TOL}) forward_ms={up_ms:.2f} (default {fwd_ms:.2f}) "
        f"{'OK' if up_ok else 'FAIL'}; under FUSED_TAIL=1: K1=22 K5=1, no K7/K8 (three frames "
        f"per clip: stock tail), max|d| vs default={d_1:.3e}")
    if not up_ok:
        raise SystemExit("TDCRQVAE3 forward under FUSED_TAIL=up differs from the default")
    del vae, out, out_up, out_1

    model = serve["restorer"].model
    x8 = torch.from_numpy(rng.uniform(0, 1, (8, cfg.tf, res, res, 3)).astype(np.float32))
    x8 = x8.cuda().to(torch.bfloat16)
    with torch.inference_mode():
        model.get_codes(x8)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        c8 = model.get_codes(x8)
        torch.cuda.synchronize()
        counts8 = expect_counts("PGTFormer.get_codes", sw_block=8, vq_nearest=1)
        peak8 = torch.cuda.max_memory_allocated()
        if (c8.shape != (8 * cfg.tf, 32, 32, 1) or int(c8.min()) < 0
                or int(c8.max()) >= n_embed):
            raise SystemExit(f"PGTFormer.get_codes {tuple(c8.shape)} or out of range")
        pgt_ms = time_ms(lambda: model.get_codes(x8), 3, warmup=0)
    log(f"[vae] PGTFormer.get_codes, 8 clips x {cfg.tf} frames: launches K1=8 K5=1; codes "
        f"{list(c8.shape)} in [0,{n_embed}), {len(c8.unique())} distinct; "
        f"get_codes_ms={pgt_ms:.2f} peak_mem_GiB={peak8 / 2 ** 30:.2f}")
    return dict(vq_launches=counts["vq_nearest"] + counts8["vq_nearest"], forward_ms=fwd_ms,
                forward_fused_up_ms=up_ms, get_codes_ms=codes_ms, pgt_get_codes_ms=pgt_ms)


def _small_config():
    from pgtformer_tpu_torch.config import DDConfig, PGTFormerConfig, VQVAEConfig
    dd = DDConfig(z_channels=32, resolution=32, ch=32, ch_mult=(1, 2), depths=(2, 2),
                  num_heads=(4, 4), window_sizes=((4, 4), (4, 4)), attn_resolutions=(16,))
    vq = VQVAEConfig(ddconfig=dd, embed_dim=32, n_embed=64, latent_shape=(16, 16, 32),
                     code_shape=(16, 16, 1))
    return PGTFormerConfig(vqvae=vq, dim_embd=64, n_head=4, n_layers=2,
                           connect_list=("16", "32"), w=1.0, adain=True)


def phase_small_model():
    import copy
    import numpy as np
    import torch
    from pgtformer_tpu_torch.models.pgtformer import PGTFormer
    cfg = _small_config()
    cpu = PGTFormer(cfg, generator=torch.Generator().manual_seed(3)).eval()
    gpu = copy.deepcopy(cpu).to(device="cuda", dtype=torch.bfloat16)
    cpu16 = copy.deepcopy(cpu).to(dtype=torch.bfloat16)
    x = np.random.default_rng(3).uniform(0, 1, (2, 3, 32, 32, 3)).astype(np.float32)
    xc = torch.from_numpy(x)
    xg = xc.cuda().to(torch.bfloat16)
    rel = lambda a, b: ((a.float().cpu() - b).norm() / b.norm()).item()
    with torch.inference_mode():
        _, logits_c, lq_c = cpu(xc)
        _, logits_g, lq_g = gpu(xg)
        _, logits_16, _ = cpu16(xc.to(torch.bfloat16))
        lq_err, logit_err = rel(lq_g, lq_c), rel(logits_g, logits_c)
        codes_c = logits_c.argmax(-1)
        agree = (logits_g.float().cpu().argmax(-1) == codes_c).float().mean().item()
        agree16 = (logits_16.float().argmax(-1) == codes_c).float().mean().item()
        out_c = cpu.restore_from_codes(xc, codes_c)
        out_g = gpu.restore_from_codes(xg, codes_c.cuda()).float().cpu()
    out_err = ((out_g - out_c).abs().mean() / out_c.abs().max()).item()
    ok = (lq_err <= SMALL_LQ_TOL and logit_err <= SMALL_LOGIT_TOL
          and agree >= max(SMALL_AGREE, agree16 - SMALL_AGREE_SLACK)
          and out_err <= SMALL_OUT_TOL and bool(torch.isfinite(out_g).all()))
    log(f"[model] small geometry CUDA bf16 vs CPU fp32: lq_rel_err={lq_err:.3e} "
        f"(tol {SMALL_LQ_TOL}) logits_rel_err={logit_err:.3e} (tol {SMALL_LOGIT_TOL}) "
        f"code_agreement={agree:.4f} (CPU bf16 plain: {agree16:.4f}; need >= "
        f"max({SMALL_AGREE}, that - {SMALL_AGREE_SLACK})) forced_code_out "
        f"mean|d|/max|ref|={out_err:.3e} (tol {SMALL_OUT_TOL}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("small-geometry whole-model check failed")


def _small_tail_config():
    """A second small geometry, because the first cannot pass the fused
    tail's guard: level 1 must be 128 wide (ch 64, not 32) with H divisible
    by 16 (64x64 frames, not 32x32), and no fuse block may sit at the last
    resolution (connect_list stops at 32)."""
    from pgtformer_tpu_torch.config import DDConfig, PGTFormerConfig, VQVAEConfig
    dd = DDConfig(z_channels=32, resolution=64, ch=64, ch_mult=(1, 2), depths=(2, 2),
                  num_heads=(4, 4), window_sizes=((4, 4), (4, 4)), attn_resolutions=(32,))
    vq = VQVAEConfig(ddconfig=dd, embed_dim=32, n_embed=64, latent_shape=(32, 32, 32),
                     code_shape=(32, 32, 1))
    return PGTFormerConfig(vqvae=vq, dim_embd=64, n_head=4, n_layers=2, connect_list=("32",),
                           w=1.0, adain=True)


def phase_small_fused_tail():
    """A small PGTFormer under FUSED_TAIL=1, forced codes, middle frames:
    CUDA bf16 (K8 + 4 K7) against CPU bf16 (the same chain through the plain
    versions), and against the stock tail on the card."""
    import copy
    import numpy as np
    import torch
    from pgtformer_tpu_torch import knobs
    from pgtformer_tpu_torch.models.pgtformer import PGTFormer
    cfg = _small_tail_config()
    cpu16 = PGTFormer(cfg, generator=torch.Generator().manual_seed(9)).eval().to(torch.bfloat16)
    gpu = copy.deepcopy(cpu16).to(device="cuda")
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 3, 64, 64, 3)).astype(np.float32))
    x = x.to(torch.bfloat16)
    codes = torch.from_numpy(rng.integers(0, 64, (6, 32, 32, 1)))
    try:
        with torch.inference_mode():
            stock = gpu.restore_from_codes(x.cuda(), codes.cuda(), middle_only=True)
            knobs.set_knob("FUSED_TAIL", "1")
            out_c = cpu16.restore_from_codes(x, codes, middle_only=True).float()
            reset_counts()
            out_g = gpu.restore_from_codes(x.cuda(), codes.cuda(), middle_only=True)
            torch.cuda.synchronize()
            counts = expect_counts("small PGTFormer [FUSED_TAIL=1]", sw_block=10,
                                   subpixel_up_conv3x3=1, gn_silu_conv3x3=4)
    finally:
        knobs.reset()
    scale = out_c.abs().max()
    out_err = ((out_g.float().cpu() - out_c).abs().mean() / scale).item()
    stock_err = ((out_g.float() - stock.float()).abs().mean().cpu() / scale).item()
    ok = (out_g.shape == (2, 64, 64, 3) and bool(torch.isfinite(out_g).all())
          and out_err <= SMALL_OUT_TOL and stock_err <= SMALL_OUT_TOL)
    log(f"[model] small PGTFormer 64x64 under FUSED_TAIL=1, forced codes, middle frames: "
        f"launches K1={counts['sw_block']} K8=1 K7=4; CUDA bf16 (kernels) vs CPU bf16 (plain "
        f"chain) mean|d|/max|ref|={out_err:.3e}, vs the stock tail on the card {stock_err:.3e} "
        f"(tol {SMALL_OUT_TOL}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("small-geometry fused-tail check failed")


def phase_small_vae():
    """TDCRQVAE3 at the small geometry: CUDA bf16 (kernels K1 and K5)
    against CPU fp32 (plain versions, exact argmin)."""
    import copy
    import numpy as np
    import torch
    from pgtformer_tpu_torch.models.vae import TDCRQVAE3
    cfg = _small_config().vqvae
    cpu = TDCRQVAE3(cfg, generator=torch.Generator().manual_seed(5)).eval()
    gpu = copy.deepcopy(cpu).to(device="cuda", dtype=torch.bfloat16)
    cpu16 = copy.deepcopy(cpu).to(dtype=torch.bfloat16)
    x = np.random.default_rng(5).uniform(-1, 1, (2, 3, 32, 32, 3)).astype(np.float32)
    xc = torch.from_numpy(x)
    xg = xc.cuda().to(torch.bfloat16)
    with torch.inference_mode():
        z_c, z_g = cpu.encode(xc), gpu.encode(xg).float().cpu()
        codes_c = cpu.get_codes(xc)
        codes_g = gpu.get_codes(xg).cpu()
        codes_16 = cpu16.get_codes(xc.to(torch.bfloat16))
        out_c = cpu.decode_code(codes_c)
        out_g = gpu.decode_code(codes_c.cuda()).float().cpu()
    z_err = ((z_g - z_c).norm() / z_c.norm()).item()
    agree = (codes_g == codes_c).float().mean().item()
    agree16 = (codes_16 == codes_c).float().mean().item()
    out_err = ((out_g - out_c).abs().mean() / out_c.abs().max()).item()
    ok = (z_err <= SMALL_LQ_TOL and agree >= max(SMALL_AGREE, agree16 - SMALL_AGREE_SLACK)
          and out_err <= SMALL_OUT_TOL and bool(torch.isfinite(out_g).all()))
    log(f"[model] small TDCRQVAE3 CUDA bf16 vs CPU fp32: z_e_rel_err={z_err:.3e} "
        f"(tol {SMALL_LQ_TOL}) code_agreement={agree:.4f} (CPU bf16 plain: {agree16:.4f}; "
        f"need >= max({SMALL_AGREE}, that - {SMALL_AGREE_SLACK})) forced_code_decode "
        f"mean|d|/max|ref|={out_err:.3e} (tol {SMALL_OUT_TOL}) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("small-geometry TDCRQVAE3 check failed")


def _mix(rows, key):
    """Per-launch average over the serving step's mix of shapes."""
    return sum(r[key] * r["per_step"] for r in rows) / sum(r["per_step"] for r in rows)


def _entry(name, source, replaces, rows, err, launches, **extra):
    """A kernel with several shapes on its path: per-launch averages over the
    launches of one serving step.  library_ms, where the rows carry one, is
    the stock PyTorch sequence for the same function."""
    return {"name": name, "route": "cuda", "source": f"pgtformer_tpu_torch/csrc/{source}",
            "replaces": f"pgtformer_tpu/ops/{replaces}", "launches": launches,
            "max_abs_err": err, "ms": _mix(rows, "ms"), "plain_ms": _mix(rows, "plain_ms"),
            "bound_ms": _mix(rows, "bound_ms"),
            "bound_by": ("operations" if all(r["bound_by"] == "operations" for r in rows)
                         else "bytes"),
            "library_ms": _mix(rows, "library_ms") if "library_ms" in rows[0] else None,
            "cases": rows, **extra}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import pgtformer_tpu_torch  # noqa: F401  (fails outside a checkout)
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    k1_rows, k1_err = phase_k1(iters=10)
    k3_rows, k3_err = phase_k3(iters=10)
    k4_rows, k4_err = phase_k4(iters=10)
    mha = phase_mha(iters=10)
    k5 = phase_k5(iters=10)
    k7_rows, k7_err = phase_k7(iters=5)
    k8_rows, k8_err = phase_k8(iters=5)
    serve = phase_serving()
    variants = phase_variants(serve)
    vae = phase_autoencoder(serve)
    phase_small_model()
    phase_small_vae()
    phase_small_fused_tail()

    step = serve["step_ms"]
    mha_src = "pgtformer_tpu_torch/csrc/dense_mha.cu"
    kernels = [
        _entry("sw_block", "sw_block.cu", "pallas_attn.py:546", k1_rows, k1_err,
               serve["counts"]["sw_block"], step_share=_mix(k1_rows, "ms") * 22 / step),
        _entry("sw_block_tokens", "sw_block.cu", "pallas_attn.py:306", k3_rows, k3_err,
               variants["tokens"]["counts"]["sw_block_tokens"],
               step_ms=variants["tokens"]["step_ms"]),
        _entry("sw_block_pair", "sw_block.cu", "pallas_attn.py:845", k4_rows, k4_err,
               variants["pair"]["counts"]["sw_block_pair"],
               step_ms=variants["pair"]["step_ms"]),
        {"name": "dense_mha_bhnd", "route": "cuda", "source": mha_src,
         "replaces": "pgtformer_tpu/ops/flash_attn.py:137",
         "launches": variants["bhnd"]["counts"]["dense_mha_bhnd"], **mha["bhnd"],
         "step_ms": variants["bhnd"]["step_ms"]},
        {"name": "dense_mha_bnhd", "route": "cuda", "source": mha_src,
         "replaces": "pgtformer_tpu/ops/flash_attn.py:171",
         "launches": serve["counts"]["dense_mha_bnhd"], **mha["bnhd"],
         "step_share": mha["bnhd"]["ms"] * 9 / step},
        {"name": "vq_nearest", "route": "cuda",
         "source": "pgtformer_tpu_torch/csrc/vq_nearest.cu",
         "replaces": "pgtformer_tpu/ops/pallas_vq.py:61", "launches": vae["vq_launches"],
         **k5, "max_abs_err_is": "largest fp64 squared-distance gap between the kernel's "
                                 "and the plain version's code on a row where they differ"},
        _entry("gn_silu_conv3x3", "fused_conv.cu", "pallas_conv.py:241", k7_rows, k7_err,
               variants["fused_tail"]["counts"]["gn_silu_conv3x3"],
               step_ms=variants["fused_tail"]["step_ms"]),
        _entry("subpixel_up_conv3x3", "subpixel_up.cu", "pallas_conv.py:360", k8_rows, k8_err,
               variants["fused_up"]["counts"]["subpixel_up_conv3x3"],
               step_ms=variants["fused_up"]["step_ms"]),
    ]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels, "default_step_ms": step,
                      "variant_step_ms": {k: v["step_ms"] for k, v in variants.items()},
                      "autoencoder_ms": {k: v for k, v in vae.items() if k.endswith("_ms")}}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
