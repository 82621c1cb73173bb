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
 8. the kernels' gradients (after phase 3, before the serving step): each
    autograd Function (K1 at the six K1_CASES and at the training step's
    three B=1 shapes with both shifts, K3 and K4 at one serving shape and at
    each training shape, K2/K6 at [1, 3072, 8, 64]; kernel forward,
    plain-version backward) against autograd through the plain version: the
    forward to the kernel's tolerance, the gradients of x, of every weight
    and of the bias table to GRAD_TOL, one launch per forward and none in
    the backward, the forward + backward timed both ways (K5 is held to its
    plain version at the training shape [3072, 512] in phase 3);
 9. training at full width and depth: Stage1Trainer on RELEASE_PGTFORMER.vqvae
    and PGTFormerTrainer("III") on RELEASE_PGTFORMER, one seeded 512x512
    3-frame uint8 clip per step, bf16 compute over fp32 parameters, random
    LPIPS VGG, GAN from step 0, 1 warm-up + 10 timed steps each (median,
    min and max step ms); asserts finite
    losses, moved parameters, EMA and stage-I codebook, untouched frozen
    modules and teacher, and exact launches per step (I: 22 K1 + 1 K5; III:
    30 K1 + 9 K6 + 1 K5); prints `[train:I]` / `[train:III]` lines with step
    ms, peak memory, the losses and the card's name and power limit;
10. the training run end to end through `train_cli.main` (`phase_train_loop`):
    a seeded VFHQ tree of 512x512 PNGs in a temporary directory (train: 2
    clips x 5 frames, val: 1 clip x 3), copies of configs/demo_stage_I.yml
    and demo_stage_III.yml with only the cadence changed (print every step,
    save and validate every 2); stage I for 4 steps, then resumed to 6
    ("auto-resumed from step 4", the schedulers at 6, the loader past its 4
    batches); stage III for 3 steps from stage I's step-6 exports (teacher,
    student, discriminator; merge_pretrained's counts); exact launches per
    training step and, apart, per validation forward (I: 22 K1 + 1 K5 both;
    III: 30 K1 + 9 K6 + 1 K5 a step, 22 K1 + 9 K6 a validation forward); the
    teacher and the frozen modules bit-identical; validation's saved frames,
    computed while the live parameters were moved far from their EMA,
    against fresh models loaded from the same step's exports (K1_TOL); stage
    III's last export served through VideoRestorer (22 K1 + 9 K6); prints
    `[train_loop:...]` lines with steps/s, the loader's batch assembly and
    the step's wait, checkpoint bytes and save/restore seconds, validation
    seconds and peak memory, and the card;
11. evaluation end to end through `eval_cli.main` (`phase_eval`): a seeded
    VFHQ-Test tree of 512x512 PNGs (2 clips x 5 frames) in a temporary
    directory, the serving phase's seeded weights as a reference-format
    .pth and a seeded IResNet-50 state dict; first K1 (both shifts at the
    three layer shapes) and K6 at the eval forward's batches of 4 and 2
    against their plain versions; `--batch 4 --face-metrics --niqe-fit-gt
    --arcface-weights --save-dir` (10 samples), then `--rotate
    --inter-space 2` (6 samples); every column printed and finite, exact
    launches (22 K1 + 9 K6 a forward, no other kernel), the saved PNGs
    equal (0 LSB) to a direct `PGTFormer.forward(middle_only=True)` of the
    same batches, ArcFace, LPIPS and the parser's class maps and landmarks
    on the card against the CPU in fp32 (ArcFace and LPIPS also read with
    TF32 on, the failure the limits are set to catch); `[eval:...]` lines
    with the CLI's setup seconds and seconds per sample split into loading,
    the forward, LPIPS, the face metrics, NIQE features, PSNR/SSIM and the
    rest, peak memory and the card;
12. the file path (`phase_video`): the native libav I/O library built from
    pgtformer_tpu_torch/io/native/videoio.cc (where it cannot be built, as
    on a machine without libav's headers, the reason is logged, the native
    cases do not run, and their GPU side runs instead: OpenCV I/O at
    inflight 3 and 1, and yuv420 readback into a plane recorder standing in
    for the encoder); a seeded 192-frame
    512x512 clip (prime + 23 full chunks + a last chunk of 7 frames padded
    with the last one: 24 steps, each with 8 valid outputs) restored by
    `VideoRestorer.restore_video` on RELEASE_PGTFORMER, B=8, bf16 (a seed-0
    restorer, checked bit-equal to the serving phase's on its first chunk)
    with OpenCV I/O; native mpeg4 at inflight 3 and 1; native `auto`
    (libx265 CRF 18 hvc1 where libav has it) with yuv420 readback. Each:
    exactly 24 x 22 K1 + 24 x 9 K6 and no other kernel, 192 frames at the
    input's fps, the hvc1 tag from libx265, the frames (or written planes)
    bit-equal to restore_chunk over the frames the case's own reader
    decodes, each chunk's host copy ending within a quarter step after its
    own step (CUDA events: the copies do not wait for later steps), the
    yuv420 planes within 1 LSB of `_rgb_to_yuv420` of the step's float
    output on the CPU, the frames bit-equal across inflight, the yuv420
    file's decoded luma within a mean 3 of the restored frames; `[video:...]`
    lines with wall, frames/s, steady frames/s, startup, each phase's total
    and mean, readback bytes, peak memory. Then the rate at inflight 1, 2
    and 3, twice in an ABBA order (`[video:inflight]`), `cli.main --codec mpeg4
    --encode-quality-check` (exact launches; PSNR, SSIM, vmaf(own-impl) and
    VMAF's time), `profile_stages` (each stage and the whole step, ms) and
    `bench_encode` (mpeg4, libx264, libx265 at their default presets, 48
    frames at 512x512: the host's encoder frames/s);
13. several ranks (`phase_multi`, `parallel/`): (a) two ranks spawned on the
    one card over gloo (CUDA tensors on cuda:0, the collectives staged
    through host memory) serve RELEASE_PGTFORMER 512x512 bf16 with B=8 (4
    windows a rank) over the serving phase's seeded weights and first 3
    chunks of frames: rank 0's gathered frames bit-equal to one process at
    batch_windows=4 over the same frames, the largest difference from the
    B=8 step printed, exactly 22 K1 + 9 K6 a step on each rank; (b) the
    stage-I and stage-III steps of phase 9 at full width, 2 ranks x 1 clip
    for 2 steps each: after every step the ranks' parameters, Adam moments,
    EMA, codebook buffers and BatchNorm statistics bit-equal (sha256), the
    averaged losses within MULTI_LOSS_TOL of one process over both clips
    taking each step from the same state (the seeded start; then the
    ranks' state after step 1, saved by rank 0 and restored), exact
    launches per rank and step; step ms and peak memory per rank,
    time-sliced on one card (stage I without codebook restarts, which draw
    from rank 0's clip across ranks and from both clips in one process; the
    EMA update with restarts is held apart: bit-equal across the ranks,
    every restarted code one of rank 0's latents); (c) where the call has
    two or more cards, (a) and (b) over NCCL with rank k on card k ((a) also
    over all the call's cards), with frames/s per world size; on one card
    one line says that NCCL and scaling are unmeasured.  `[multi:...]`
    lines;
14. a JSON line of kernel numbers (each with its backward route, its
    launches per training step, in the training run, in evaluation, on
    the file path and per rank in phase_multi), then the device JSON as
    the last line.

Launch counts are set to 0 just before each path is driven and read just
after it; launches made to compare or time a kernel do not count.
"""

from __future__ import annotations

import gc
import hashlib
import json
import math
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
    check("training shape (1 clip x 3 frames)", x[:TRAIN_VQ_ROWS], codes)
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


# -- training: the kernels' gradients, then the step of stages I and III -------

# The Functions' gradients against autograd through the plain version: both
# run the plain version's backward on the same saved inputs (the Function's
# forward output is the kernel's, which the backward does not read), so they
# differ only where cuBLAS or a scatter-add sums in another order.  Held to
# GRAD_TOL of each gradient's largest magnitude.
GRAD_TOL = 1e-3
TRAIN_WARMUP, TRAIN_TIMED = 1, 10    # steps of phase_train: warm-up, then timed one by one
# The EMA moves each step by (1 - decay) * (param - EMA), ~1e-7 after a few
# steps of lr 2e-5 to 4e-5: on a tensor of values near 1 that can stay
# within one fp32 ulp.  So the EMA must have moved on this share of the
# trainable tensors, not on every one.
EMA_MOVED_SHARE = 0.9
TRAIN_RES = 512
# the kernels' shapes on the training path: one clip of 3 frames at 512^2
TRAIN_K1_SHAPES = [(1, 3, 128, 128, 256), (1, 3, 64, 64, 256), (1, 3, 32, 32, 512)]
TRAIN_VQ_ROWS = 3 * 32 * 32


def _grad_leaves(shape, seed, dtype):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def _compare_grads(name: str, got, ref, names):
    """Worst max|d| / max|ref| over the gradients; exits on a missing,
    non-finite or disagreeing one."""
    import torch
    worst = 0.0
    for n, a, b in zip(names, got, ref):
        if a is None or b is None:
            raise SystemExit(f"{name}: no gradient for {n}")
        err = (a.float() - b.float()).abs().max().item()
        mag = b.float().abs().max().item()
        if not (bool(torch.isfinite(a).all()) and err <= GRAD_TOL * mag and mag > 0):
            raise SystemExit(f"{name}: gradient of {n} max|d|={err:.3e}, max|ref|={mag:.3e}, "
                             f"tol {GRAD_TOL}*max|ref|")
        worst = max(worst, err / mag)
    return worst


def _block_module(C: int, T: int, seed: int):
    """A block with non-trivial fp32 parameters on the card: the master
    weights of the training path."""
    import torch
    from pgtformer_tpu_torch.nn.blocks import SWTransformerBlock, init_weights
    g = torch.Generator().manual_seed(seed)
    blk = init_weights(SWTransformerBlock(C, 8, T, (4, 4), (0, 0), mlp_ratio=1.0), g)
    with torch.no_grad():
        for p in blk.parameters():
            if p.dim() == 1:
                p.add_(torch.randn(p.shape, generator=g) * 0.1)
    return blk.cuda()


def _block_grads(fn, x, cot, blocks):
    """(output, [grad of x, then of every parameter of `blocks`]) of one
    forward + backward of fn(x, *live weights)."""
    for b in blocks:
        b.zero_grad(set_to_none=True)
    xx = x.detach().clone().requires_grad_()
    out = fn(xx, *(b.live_weights() for b in blocks))
    out.backward(cot)
    return out.detach(), [xx.grad] + [p.grad for b in blocks for p in b.parameters()]


def phase_train_grad(iters: int = 3):
    """Each kernel's autograd Function (kernel forward, plain-version
    backward) against autograd through the plain version: K1 at the six
    K1_CASES and at the training path's B=1 shapes (TRAIN_K1_SHAPES, both
    shifts), K3 and K4 at one serving shape and at each training shape, K2/K6
    at [1, 3072, 8, 64]; the forwards held to K1_TOL / K2_TOL, the gradients
    of x, of every weight and of the relative-position table to GRAD_TOL;
    one launch per forward, none in the backward.  Times one forward +
    backward each way."""
    import torch
    from pgtformer_tpu_torch.ops import dense_mha as dm
    from pgtformer_tpu_torch.ops import sw_block as sw
    from pgtformer_tpu_torch.ops.window import shifted_window_mask, window_partition
    k1_rows, res = [], {}

    def check(tag, kernel_fn, plain_fn, x, blocks, counter, tol):
        cot = _grad_leaves(x.shape, 900 + len(k1_rows) + len(res), x.dtype)
        names = ["x"] + [f"{i}.{n}" for i, b in enumerate(blocks) for n, _ in b.named_parameters()]
        reset_counts()
        out_k, g_k = _block_grads(kernel_fn, x, cot, blocks)
        torch.cuda.synchronize()
        expect_counts(f"{tag} Function forward + backward", **{counter: 1})
        out_p, g_p = _block_grads(plain_fn, x, cot, blocks)
        torch.cuda.synchronize()
        err, _ = _compare(f"{tag} Function forward", out_k, out_p, tol)
        gerr = _compare_grads(f"{tag} Function", g_k, g_p, names)
        ms = time_ms(lambda: _block_grads(kernel_fn, x, cot, blocks), iters, warmup=1)
        pms = time_ms(lambda: _block_grads(plain_fn, x, cot, blocks), iters, warmup=1)
        log(f"[grad] {tag}: forward max|d|={err:.3e} (tol {tol}*max|ref|); {len(names)} "
            f"gradients (x, every weight, the bias table) worst max|d|/max|ref|={gerr:.3e} "
            f"(tol {GRAD_TOL}); launches: 1 forward, 0 backward; fwd+bwd ms: Function "
            f"{ms:.3f}, plain {pms:.3f} OK")
        return dict(max_abs_err=err, grad_rel_err=gerr, fwd_bwd_ms=ms, plain_fwd_bwd_ms=pms)

    for i, (shape, shift, per_step) in enumerate(K1_CASES):
        blk = _block_module(shape[-1], shape[1], seed=700 + i)
        x = _case_input(70 + i, shape)
        row = check(f"K1 x{list(shape)} shift{shift}",
                    lambda xx, w: sw.sw_block(xx, w, shift),
                    lambda xx, w: sw.sw_block_plain(xx, w, shift), x, [blk], "sw_block", K1_TOL)
        k1_rows.append(dict(shape=list(shape), shift=list(shift), per_step=per_step, **row))

    shape = (8, 3, 64, 64, 256)
    B, T, H, W, C = shape
    blk = _block_module(C, T, seed=750)
    tok = window_partition(torch.roll(_case_input(80, shape), (-2, -2), dims=(2, 3)),
                           (4, 4)).contiguous()
    mask = torch.as_tensor(shifted_window_mask(T, H, W, (4, 4), (2, 2)), device="cuda")
    nW = (H // 4) * (W // 4)
    res["sw_block_tokens"] = check(
        f"K3 tokens{list(tok.shape)}", lambda xx, w: sw.sw_block_tokens(xx, w, mask, nW),
        lambda xx, w: sw.sw_block_tokens_plain(xx, w, mask, nW), tok, [blk],
        "sw_block_tokens", K1_TOL)
    shape = (8, 3, 32, 32, 512)
    b0, b1 = _block_module(512, 3, seed=760), _block_module(512, 3, seed=761)
    res["sw_block_pair"] = check(
        f"K4 pair x{list(shape)}", lambda xx, w0, w1: sw.sw_block_pair(xx, w0, w1, (2, 2)),
        lambda xx, w0, w1: sw.sw_block_pair_plain(xx, w0, w1, (2, 2)),
        _case_input(81, shape), [b0, b1], "sw_block_pair", K1_TOL)

    # the training step's shapes: one clip, B=1
    train_rows = []
    for i, shape in enumerate(TRAIN_K1_SHAPES):
        B, T, H, W, C = shape
        for shift in ((0, 0), (2, 2)):
            blk = _block_module(C, T, seed=770 + 2 * i + any(shift))
            row = check(f"K1 x{list(shape)} shift{shift} (training)",
                        lambda xx, w, s=shift: sw.sw_block(xx, w, s),
                        lambda xx, w, s=shift: sw.sw_block_plain(xx, w, s),
                        _case_input(90 + 2 * i + any(shift), shape), [blk], "sw_block", K1_TOL)
            train_rows.append(dict(kernel="sw_block", shape=list(shape), shift=list(shift), **row))
        blk = _block_module(C, T, seed=780 + i)
        tok = window_partition(torch.roll(_case_input(96 + i, shape), (-2, -2), dims=(2, 3)),
                               (4, 4)).contiguous()
        mask = torch.as_tensor(shifted_window_mask(T, H, W, (4, 4), (2, 2)), device="cuda")
        nW = (H // 4) * (W // 4)
        row = check(f"K3 tokens{list(tok.shape)} (training)",
                    lambda xx, w, m=mask, n=nW: sw.sw_block_tokens(xx, w, m, n),
                    lambda xx, w, m=mask, n=nW: sw.sw_block_tokens_plain(xx, w, m, n),
                    tok, [blk], "sw_block_tokens", K1_TOL)
        train_rows.append(dict(kernel="sw_block_tokens", shape=list(tok.shape), **row))
        b0, b1 = _block_module(C, T, seed=790 + 2 * i), _block_module(C, T, seed=791 + 2 * i)
        row = check(f"K4 pair x{list(shape)} (training)",
                    lambda xx, w0, w1: sw.sw_block_pair(xx, w0, w1, (2, 2)),
                    lambda xx, w0, w1: sw.sw_block_pair_plain(xx, w0, w1, (2, 2)),
                    _case_input(99 + i, shape), [b0, b1], "sw_block_pair", K1_TOL)
        train_rows.append(dict(kernel="sw_block_pair", shape=list(shape), **row))

    qk, vp = mha_operands(1, 8, 3072, 64, "normal", seed=82)
    for layout, plain, counter in (("bnhd", dm.dense_mha_plain_bnhd, "dense_mha_bnhd"),
                                   ("bhnd", dm.dense_mha_plain, "dense_mha_bhnd")):
        q, k, v = (a.detach().clone().requires_grad_() for a in _mha_views(qk, vp, 8, layout))
        cot = _grad_leaves(q.shape, 83, q.dtype)

        def run(fn):
            for a in (q, k, v):
                a.grad = None
            out = fn(q, k, v)
            out.backward(cot)
            return out.detach(), [q.grad, k.grad, v.grad]
        kfn = lambda a, b, c: dm.dense_mha(a, b, c, scale=0.125, layout=layout)
        pfn = lambda a, b, c: plain(a, b, c, 0.125)
        reset_counts()
        out_k, g_k = run(kfn)
        torch.cuda.synchronize()
        expect_counts(f"dense_mha {layout} Function forward + backward", **{counter: 1})
        out_p, g_p = run(pfn)
        err, _ = _compare(f"dense_mha {layout} Function forward", out_k, out_p, K2_TOL)
        gerr = _compare_grads(f"dense_mha {layout} Function", g_k, g_p, "qkv")
        ms = time_ms(lambda: run(kfn), iters, warmup=1)
        pms = time_ms(lambda: run(pfn), iters, warmup=1)
        log(f"[grad] {'K6' if layout == 'bnhd' else 'K2'} dense_mha {layout} "
            f"{list(q.shape)}: forward max|d|={err:.3e} (tol {K2_TOL}*max|ref|); gradients "
            f"of q, k, v worst max|d|/max|ref|={gerr:.3e} (tol {GRAD_TOL}); launches: 1 "
            f"forward, 0 backward; fwd+bwd ms: Function {ms:.3f}, plain {pms:.3f} OK")
        res[counter] = dict(max_abs_err=err, grad_rel_err=gerr, fwd_bwd_ms=ms,
                            plain_fwd_bwd_ms=pms)
    res["sw_block"] = dict(grad_rel_err=max(r["grad_rel_err"] for r in k1_rows),
                           fwd_bwd_ms=_mix(k1_rows, "fwd_bwd_ms"),
                           plain_fwd_bwd_ms=_mix(k1_rows, "plain_fwd_bwd_ms"), cases=k1_rows)
    for name, r in res.items():
        r["training_shapes"] = [{k: v for k, v in row.items() if k != "kernel"}
                                for row in train_rows if row["kernel"] == name]
    return res


def _clone_params(named):
    return {n: p.detach().clone() for n, p in named}


def _moved(before, after_named):
    """Names whose tensor changed."""
    import torch
    return {n for n, p in after_named if not torch.equal(before[n], p.detach())}


def _train(tag: str, trainer, state, batch, smi: str, per_step: dict):
    """TRAIN_WARMUP steps, then TRAIN_TIMED steps each timed on the host
    clock up to its `torch.cuda.synchronize()`; exact launch counts over the
    timed ones; every metric finite.  Returns (state, step ms {median, min,
    max, all}, peak bytes, last metrics)."""
    import statistics
    import torch
    step = trainer.make_step()
    for _ in range(TRAIN_WARMUP):
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    for _ in range(TRAIN_TIMED):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = dict(median=statistics.median(times), min=min(times), max=max(times), all=times)
    counts = expect_counts(f"training step {tag}",
                           **{k: v * TRAIN_TIMED for k, v in per_step.items()})
    peak = torch.cuda.max_memory_allocated()
    losses = {k: float(v) for k, v in metrics.items()}
    if not all(math.isfinite(v) for v in losses.values()):
        raise SystemExit(f"training step {tag}: non-finite losses {losses}")
    launched = {k: v // TRAIN_TIMED for k, v in counts.items() if v}
    log(f"[train:{tag}] {TRAIN_WARMUP} warm-up + {TRAIN_TIMED} timed steps, 1 clip x 3 frames "
        f"at {TRAIN_RES}x{TRAIN_RES}, bf16 compute over fp32 parameters: step_ms median="
        f"{step_ms['median']:.2f} min={step_ms['min']:.2f} max={step_ms['max']:.2f} "
        f"(all: {' '.join(f'{t:.2f}' for t in times)}) peak_mem_GiB={peak / 2 ** 30:.2f}; "
        f"launches per step {launched} (forwards only: the backwards launch none); losses "
        + " ".join(f"{k}={v:.5f}" for k, v in losses.items()) + f"; card: {smi}")
    return state, step_ms, peak, losses


def phase_train(smi: str):
    """Stage I (Stage1Trainer on RELEASE_PGTFORMER.vqvae) and stage III
    (PGTFormerTrainer on RELEASE_PGTFORMER) at full width and depth, one
    seeded 512x512 3-frame uint8 clip per step, seeded random weights (the
    teacher's from its own seed), LPIPS on its random VGG, GAN from step 0,
    no learning-rate warm-up.  Asserts finite losses, moved trainable parameters, EMA and
    (stage I) codebook, untouched frozen modules and teacher, and exact
    launch counts per step (K1, K5, K6; the backward launches none)."""
    import dataclasses
    import numpy as np
    import torch
    from pgtformer_tpu_torch.config import RELEASE_PGTFORMER
    from pgtformer_tpu_torch.models.vae import TDCRQVAE3
    from pgtformer_tpu_torch.train.lpips import make_lpips_fn
    from pgtformer_tpu_torch.train.stages import STAGE_HYPERS, PGTFormerTrainer, Stage1Trainer
    rng = np.random.default_rng(5)
    gt = rng.integers(0, 256, (1, 3, TRAIN_RES, TRAIN_RES, 3), dtype=np.uint8)
    lq = np.clip(gt.astype(np.int16) + rng.integers(-24, 25, gt.shape), 0, 255).astype(np.uint8)
    lpips_fn = make_lpips_fn(device="cuda")
    out = {}

    t0 = time.perf_counter()
    hp = dataclasses.replace(STAGE_HYPERS["I"], warmup_iter=-1)
    tr = Stage1Trainer(RELEASE_PGTFORMER.vqvae, hp, lpips_fn=lpips_fn, device="cuda",
                       dtype=torch.bfloat16)
    state = tr.init_state(torch.Generator().manual_seed(11))
    log(f"[train:I] trainer built in {time.perf_counter() - t0:.1f} s")
    p0 = _clone_params(state.g.params.items())
    e0 = {n: t.clone() for n, t in state.g.ema_params.items()}
    c0 = {n: t.detach().clone() for n, t in state.g.codebook.items()}
    state, ms1, peak1, losses1 = _train("I", tr, state, gt, smi,
                                        dict(sw_block=22, vq_nearest=1))
    trainable = {n for n, p in state.g.params.items() if p.requires_grad}
    moved = _moved(p0, state.g.params.items())
    ema_moved = {n for n, t in state.g.ema_params.items() if not torch.equal(e0[n], t)}
    cb_moved = {n for n, t in state.g.codebook.items() if not torch.equal(c0[n], t)}
    if (moved != trainable or len(ema_moved & trainable) < EMA_MOVED_SHARE * len(trainable)
            or cb_moved != set(c0)):
        raise SystemExit(f"stage I: {len(trainable - moved)} trainable parameters, "
                         f"{len(trainable - ema_moved)} EMA tensors, "
                         f"{len(set(c0) - cb_moved)} codebook tensors did not move")
    log(f"[train:I] all {len(trainable)} parameters, the EMA of {len(ema_moved & trainable)} "
        f"of them and the {len(c0)} codebook buffers moved OK")
    out["I"] = dict(step_ms=ms1, peak_gib=peak1 / 2 ** 30, losses=losses1,
                    per_step=dict(sw_block=22, vq_nearest=1))
    del tr, state, p0, e0, c0
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    teacher = TDCRQVAE3(RELEASE_PGTFORMER.vqvae, generator=torch.Generator().manual_seed(12))
    hp = dataclasses.replace(STAGE_HYPERS["III"], warmup_iter=-1)
    tr = PGTFormerTrainer(RELEASE_PGTFORMER, "III", hp, lpips_fn=lpips_fn, device="cuda",
                          dtype=torch.bfloat16)
    state = tr.init_state(torch.Generator().manual_seed(13), teacher.state_dict())
    del teacher
    log(f"[train:III] trainer built in {time.perf_counter() - t0:.1f} s")
    p0 = _clone_params(state.g.params.items())
    t_before = _clone_params(tr.teacher.state_dict().items())
    buffers0 = {n: b.detach().clone() for n, b in tr.model.named_buffers()}
    e0 = {n: t.clone() for n, t in state.g.ema_params.items()}
    c0 = _clone_params(state.g.codebook.items())
    per_step = dict(sw_block=22 + 8, vq_nearest=1, dense_mha_bnhd=9)
    state, ms3, peak3, losses3 = _train("III", tr, state, {"lq": lq, "gt": gt}, smi, per_step)
    trainable = {n for n, p in state.g.params.items() if p.requires_grad}
    frozen = set(state.g.params) - trainable
    moved = _moved(p0, state.g.params.items())
    ema_moved = {n for n, t in state.g.ema_params.items() if not torch.equal(e0[n], t)}
    t_moved = _moved(t_before, tr.teacher.state_dict().items())
    b_moved = _moved(buffers0, tr.model.named_buffers())
    cb_moved = _moved(c0, state.g.codebook.items())
    if (moved != trainable or not frozen or t_moved or b_moved or cb_moved
            or len(ema_moved & trainable) < EMA_MOVED_SHARE * len(trainable)):
        raise SystemExit(f"stage III: {len(trainable - moved)} trainable parameters did not "
                         f"move, {len(moved & frozen)} frozen ones did, the EMA of "
                         f"{len(trainable - ema_moved)} trainable ones did not move, "
                         f"{len(t_moved)} teacher, {len(b_moved)} buffer and "
                         f"{len(cb_moved)} codebook tensors moved")
    tops = sorted({n.split(".")[0] for n in frozen})
    log(f"[train:III] all {len(trainable)} trainable parameters (the EMA of "
        f"{len(ema_moved & trainable)}) moved; the "
        f"{len(frozen)} frozen ones ({', '.join(tops)}), the buffers and the teacher are "
        f"bit-identical OK")
    out["III"] = dict(step_ms=ms3, peak_gib=peak3 / 2 ** 30, losses=losses3, per_step=per_step)
    return out


# -- the training run end to end (train_cli) ----------------------------------

LOOP_RES = 512            # the seeded VFHQ tree's frames
LOOP_VAL_SAMPLES = 3      # val/GT: 1 clip x 3 frames, inter_space 1
LOOP_PER_STEP = {"I": dict(sw_block=22, vq_nearest=1),
                 "III": dict(sw_block=22 + 8, dense_mha_bnhd=9, vq_nearest=1)}
LOOP_PER_VAL = {"I": dict(sw_block=22, vq_nearest=1),        # TDCRQVAE3 forward
                "III": dict(sw_block=22, dense_mha_bnhd=9)}  # PGTFormer forward
LOOP_FROZEN = ("quantizer", "decoder", "conditionnet", "post_quant_conv")
LOOP_METRIC_KEYS = {"I": {"l_pix", "l_percep", "l_quant", "l_g_gan", "l_g_total", "l_d"},
                    "III": {"l_token", "l_feat", "l_pix", "l_percep", "l_g_gan", "l_g_total",
                            "l_d"}}


def _launch_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


class _LoopObserver:
    """Watches `train_cli.main` from outside: wraps `Trainer.fit` to keep the
    stage trainer and snapshot its teacher and frozen modules before the
    loop, and `Trainer._validate` to count each validation's launches apart
    from the training steps'; collects the log's records.  For the length of
    each validation it moves the live parameters far from their EMA (noise
    of their mean magnitude) and puts them back bit for bit after, so that
    a validation which read them instead of the EMA fails
    `_val_matches_export`; the run is otherwise unchanged.  Undone on exit."""

    def __enter__(self):
        import logging
        from pgtformer_tpu_torch.train import trainer as tmod
        self.tmod, self.fit0, self.validate0 = tmod, tmod.Trainer.fit, tmod.Trainer._validate
        self.records, self.val_launches, self.stage, self.before = [], [], None, None
        obs = self

        class Capture(logging.Handler):
            def emit(self, record):
                obs.records.append(record.getMessage())

        from pgtformer_tpu_torch.utils.logging import get_root_logger
        self.handler = Capture()
        get_root_logger().addHandler(self.handler)

        def fit(loop, state, batches, total_iter=None, val_fn=None):
            obs.stage = loop.stage
            st = loop.stage
            snap = {f"student.{k}": v.detach().clone() for k, v in st.model.state_dict().items()}
            if hasattr(st, "teacher"):
                snap.update({f"teacher.{k}": v.detach().clone()
                             for k, v in st.teacher.state_dict().items()})
            obs.before = snap
            return obs.fit0(loop, state, batches, total_iter, val_fn)

        def validate(loop, val_fn, state, step, timings):
            import torch
            live = {k: p.detach().clone() for k, p in state.g.params.items()}
            noise = torch.Generator(device=loop.stage.device).manual_seed(step)
            with torch.no_grad():
                for p in state.g.params.values():
                    p.add_(torch.randn(p.shape, generator=noise, device=p.device, dtype=p.dtype)
                           * p.abs().mean().clamp_min(1e-2))
            try:
                c0 = _launch_counts()
                out = obs.validate0(loop, val_fn, state, step, timings)
                obs.val_launches.append({k: v - c0[k] for k, v in _launch_counts().items()})
            finally:
                with torch.no_grad():
                    for k, p in state.g.params.items():
                        p.copy_(live[k])
            return out

        tmod.Trainer.fit, tmod.Trainer._validate = fit, validate
        return self

    def __exit__(self, *exc):
        import logging
        self.tmod.Trainer.fit, self.tmod.Trainer._validate = self.fit0, self.validate0
        logging.getLogger("pgtformer_tpu_torch").removeHandler(self.handler)
        return False


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _loop_run(tag: str, stage: str, argv, obs_steps: int, smi: str, expect_resume=None):
    """One `train_cli.main(argv)` with the launch counts set to 0 just before
    and read just after; asserts exact launches (training steps and each
    validation apart), metrics.jsonl's keys and finite values.  Returns
    (observer, new metrics.jsonl step lines, this fit's timings record)."""
    import statistics
    import torch
    from pgtformer_tpu_torch import train_cli
    exp = argv[argv.index("--exp-dir") + 1]
    n_lines = len(_jsonl(f"{exp}/metrics.jsonl")) if expect_resume else 0
    reset_counts()
    t0 = time.perf_counter()
    with _LoopObserver() as obs:
        rc = train_cli.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise SystemExit(f"[train_loop:{tag}] train_cli.main returned {rc}")
    got = _launch_counts()
    val = {k: sum(v[k] for v in obs.val_launches) for k in got}
    n_val = len(obs.val_launches) * LOOP_VAL_SAMPLES
    want_val = {k: LOOP_PER_VAL[stage].get(k, 0) * n_val for k in got}
    want_train = {k: LOOP_PER_STEP[stage].get(k, 0) * obs_steps for k in got}
    train = {k: got[k] - val[k] for k in got}
    if val != want_val or train != want_train:
        raise SystemExit(f"[train_loop:{tag}] launches: training {train} (expected "
                         f"{want_train}), validation {val} (expected {want_val})")
    for name in LOOP_PER_STEP[stage]:
        if got[name] == 0:
            raise SystemExit(f"[train_loop:{tag}] {name} was never launched")
    lines = _jsonl(f"{exp}/metrics.jsonl")[n_lines:]
    steps = [r for r in lines if "it_per_s" in r]
    for r in steps:
        if set(r) != {"step", "it_per_s"} | LOOP_METRIC_KEYS[stage]:
            raise SystemExit(f"[train_loop:{tag}] metrics.jsonl keys {sorted(r)}")
        if not all(math.isfinite(v) for v in r.values()):
            raise SystemExit(f"[train_loop:{tag}] non-finite metrics {r}")
    timing = _jsonl(f"{exp}/timings.jsonl")[-1]
    rates = [r["it_per_s"] for r in steps]
    load = timing.get("loader_load_s") or [0.0]
    saves, vals = timing["save"], timing["val"]
    log(f"[train_loop:{tag}] train_cli.main in {wall:.1f} s: steps "
        f"{[r['step'] for r in steps]}, steps/s median {statistics.median(rates):.3f} "
        f"(each: {' '.join(f'{x:.3f}' for x in rates)}); loader: batch assembly median "
        f"{statistics.median(load) * 1e3:.1f} ms over {len(load)} batches (decode + blind "
        f"degradation at {LOOP_RES}x{LOOP_RES}), the step's wait per batch median "
        f"{statistics.median(timing['data_wait_s']) * 1e3:.2f} ms; checkpoints "
        + ", ".join(f"step {s['step']}: {s['bytes'] / 2 ** 30:.3f} GiB in {s['seconds']:.2f} s "
                    f"(+ exports {s['export_seconds']:.2f} s)" for s in saves)
        + (f"; restore of step {timing['restore']['step']}: "
           f"{timing['restore']['bytes'] / 2 ** 30:.3f} GiB in {timing['restore']['seconds']:.2f} s"
           if timing["restore"] else "")
        + "; validation " + ", ".join(
            f"step {v['step']}: {v['seconds']:.2f} s, peak "
            + (f"{v['peak_bytes'] / 2 ** 30:.2f} GiB" if v["peak_bytes"] is not None else "n/a")
            for v in vals)
        + f"; launches: training {{{', '.join(f'{k}: {v}' for k, v in train.items() if v)}}}, "
        f"validation {{{', '.join(f'{k}: {v}' for k, v in val.items() if v)}}}; card: {smi}")
    torch.cuda.empty_cache()
    return obs, steps, timing, dict(wall_s=wall, steps_per_s=rates, train_launches=train,
                                    val_launches=val)


def _val_matches_export(tag: str, model, export: str, dataset, png_dir: str, stage: str):
    """Validation's saved frames of one step (computed while the live
    parameters were moved away from their EMA: `_LoopObserver`) against a
    fresh model loaded from that step's export, both on the card under bf16
    autocast: max |d| / 255 <= K1_TOL."""
    import os
    import cv2
    import numpy as np
    import torch
    from pgtformer_tpu_torch.convert import load_checkpoint, load_into
    model = load_into(model, load_checkpoint(export)).cuda().eval().requires_grad_(False)
    T = 2 * dataset.r + 1
    worst, mean = 0, []
    for i in range(len(dataset)):
        s = dataset[i]
        x = torch.from_numpy(s["gt" if stage == "I" else "lq"][None]).cuda()
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            if stage == "I":
                out = model(x)[0][0]
            else:
                out = model(x, w=model.cfg.w)[0].reshape(1, T, *x.shape[2:])[0, T // 2]
        img = out.float().clamp(0, 1).cpu().numpy()
        mine = (np.clip(img[..., ::-1], 0, 1) * 255).astype(np.uint8)
        saved = cv2.imread(os.path.join(png_dir, s["path"].replace("/", "_")))
        d = np.abs(mine.astype(int) - saved.astype(int))
        worst, mean = max(worst, int(d.max())), mean + [float(d.mean())]
    if worst / 255 > K1_TOL:
        raise SystemExit(f"[train_loop:{tag}] validation's frames differ from the export's "
                         f"by {worst} LSB (> {K1_TOL} * 255)")
    log(f"[train_loop:{tag}] validation's {len(dataset)} saved frames against a fresh "
        f"{type(model).__name__} from {os.path.basename(export)}: max {worst} LSB, mean "
        f"{sum(mean) / len(mean):.4f} LSB (<= K1_TOL * 255) OK")
    return worst


def phase_train_loop(smi: str):
    """The training run end to end through `train_cli.main`, at the full
    width and depth of RELEASE_PGTFORMER (the demo YAMLs, 512x512, T=3,
    bf16 autocast over fp32 parameters, random LPIPS VGG), on a seeded
    VFHQ tree of PNGs in a temporary directory (train: 2 clips x 5 frames,
    val: 1 clip x 3 frames), with copies of configs/demo_stage_I.yml and
    demo_stage_III.yml whose cadence alone is changed (print every step,
    save and validate every 2):
      stage I for 4 steps, then resumed to 6 (auto-resume at step 4, the
      scheduler and the loader continuing); stage III for 3 steps from
      stage I's step-6 exports (teacher, student, discriminator);
      stage III's last export served through VideoRestorer; validation's
      saved frames against fresh models loaded from the exports.
    Exact launches per training step and per validation forward; the
    teacher and the frozen modules bit-identical."""
    import os
    import shutil
    import statistics
    import tempfile
    import cv2
    import numpy as np
    import torch
    import yaml
    from pgtformer_tpu_torch.config import load_options, pgtformer_config_from_options, \
        vqvae_config_from_options
    from pgtformer_tpu_torch.convert import load_checkpoint
    from pgtformer_tpu_torch.data.vfhq import VFHQTestDataset
    from pgtformer_tpu_torch.models.pgtformer import PGTFormer
    from pgtformer_tpu_torch.models.vae import TDCRQVAE3
    from pgtformer_tpu_torch.pipeline import VideoRestorer
    from pgtformer_tpu_torch.utils.checkpoint import CheckpointManager
    root = tempfile.mkdtemp(prefix="pgt_train_loop_")
    out = {}
    try:
        rng = np.random.default_rng(21)
        for split, clips, n in (("train", 2, 5), ("val", 1, 3)):
            for c in range(clips):
                d = os.path.join(root, "vfhq", split, "GT", f"clip_{c}")
                os.makedirs(d)
                for i in range(n):
                    cv2.imwrite(os.path.join(d, f"{i:08d}.png"),
                                rng.integers(0, 256, (LOOP_RES, LOOP_RES, 3), dtype=np.uint8))
        ymls = {}
        for stage in ("I", "III"):
            opt = load_options(f"configs/demo_stage_{stage}.yml")
            opt["logger"].update(print_freq=1, save_checkpoint_freq=2)
            opt["val"]["val_freq"] = 2
            ymls[stage] = os.path.join(root, f"demo_stage_{stage}.yml")
            with open(ymls[stage], "w") as f:
                yaml.safe_dump(opt, f)
        train, val = os.path.join(root, "vfhq", "train"), os.path.join(root, "vfhq", "val")
        # one sample's assembly with the host otherwise idle, against the
        # loader's own times beside a running step
        from pgtformer_tpu_torch.data.vfhq import VFHQTrainDataset
        from scipy import special  # noqa: F401  (the first sinc kernel's import, untimed)
        tds, alone = VFHQTrainDataset(train, output_dtype="uint8"), []
        for i in range(3):
            t0 = time.perf_counter()
            tds[i]
            alone.append((time.perf_counter() - t0) * 1e3)
        log(f"[train_loop] one 3-frame {LOOP_RES}x{LOOP_RES} sample (PNG decode, blind "
            f"degradation, uint8) assembled alone on the main thread: "
            f"{' '.join(f'{a:.1f}' for a in alone)} ms")
        exp1, exp3 = os.path.join(root, "exp", "stage_I"), os.path.join(root, "exp", "stage_III")
        common = ["--data-root", train, "--val-data-root", val, "--bf16"]

        # stage I: 4 steps (saves and validations at 2 and 4), then resumed to 6
        _, steps, t1, r1 = _loop_run("I", "I", ["-opt", ymls["I"], "--exp-dir", exp1,
                                                "--total-iter", "4", *common], 4, smi)
        ck = CheckpointManager(exp1)
        if ([r["step"] for r in steps] != [1, 2, 3, 4] or ck.latest_step() != 4
                or [s["step"] for s in t1["save"]] != [2, 4]
                or [v["step"] for v in t1["val"]] != [2, 4]):
            raise SystemExit(f"[train_loop:I] steps {[r['step'] for r in steps]}, saves "
                             f"{t1['save']}, validations {t1['val']}")
        obs, steps, t2, r2 = _loop_run("I+resume", "I", ["-opt", ymls["I"], "--exp-dir", exp1,
                                                         "--total-iter", "6", *common], 2, smi,
                                       expect_resume=True)
        st = ck.read_state(6)

        def at(pos):
            return (pos["epoch"], pos["consumed"])

        if ("auto-resumed from step 4" not in " ".join(obs.records)
                or [r["step"] for r in steps] != [5, 6] or t2["restore"]["step"] != 4
                or at(t2["restore"]["loader"]) != (0, 4) or at(st["loader"]) != (0, 6)
                or st["sched_g"]["last_epoch"] != 6 or st["sched_d"]["last_epoch"] != 6):
            raise SystemExit(f"[train_loop:I+resume] steps {[r['step'] for r in steps]}, "
                             f"restore {t2['restore']}, state at 6: loader {st['loader']}, "
                             f"schedulers {st['sched_g']['last_epoch']} / "
                             f"{st['sched_d']['last_epoch']}")
        resume_line = next(m for m in obs.records if m.startswith("the loader starts at"))
        log(f"[train_loop:I+resume] 'auto-resumed from step 4'; '{resume_line}'; wrote steps "
            f"5 and 6 only; the schedulers' count is 6 (lr_g {st['opt_g']['param_groups'][0]['lr']:.3e}, "
            f"warm-up 1000); the loader stands at (epoch, batches) {at(st['loader'])} OK")
        del st
        vds = VFHQTestDataset(val)
        cfg1 = vqvae_config_from_options(load_options(ymls["I"]), network_key="network_g")
        err1 = _val_matches_export("I", TDCRQVAE3(cfg1), f"{exp1}/net_g_6.pth", vds,
                                   f"{exp1}/visualization/iter_6", "I")

        # stage III from stage I's step-6 exports
        obs, steps, t3, r3 = _loop_run(
            "III", "III", ["-opt", ymls["III"], "--exp-dir", exp3, "--total-iter", "3",
                           "--teacher-ckpt", f"{exp1}/net_g_6.pth",
                           "--student-ckpt", f"{exp1}/net_g_6.pth",
                           "--disc-ckpt", f"{exp1}/net_d_6.pth", *common], 3, smi)
        merge = next(m for m in obs.records if m.startswith("student init:"))
        n_loaded, n_skipped = (int(x) for x in re.findall(r"(\d+) (?:pretrained )?tensors", merge))
        tr = obs.stage
        after = {f"student.{k}": v for k, v in tr.model.state_dict().items()}
        after.update({f"teacher.{k}": v for k, v in tr.teacher.state_dict().items()})
        fixed = [k for k in obs.before if k.startswith("teacher.")
                 or k.split(".")[1] in LOOP_FROZEN]
        changed = [k for k in fixed if not torch.equal(obs.before[k], after[k])]
        trainable = [f"student.{n}" for n, p in tr.model.named_parameters() if p.requires_grad]
        moved = [k for k in trainable if not torch.equal(obs.before[k], after[k])]
        if (changed or len(moved) != len(trainable) or [r["step"] for r in steps] != [1, 2, 3]
                or [s["step"] for s in t3["save"]] != [2, 3] or [v["step"] for v in t3["val"]] != [2]):
            raise SystemExit(f"[train_loop:III] {len(changed)} teacher/frozen tensors changed "
                             f"({changed[:5]}), {len(trainable) - len(moved)} trainable parameters "
                             f"did not move; steps {[r['step'] for r in steps]}, saves "
                             f"{t3['save']}, validations {t3['val']}")
        log(f"[train_loop:III] merge_pretrained: {n_loaded} tensors loaded from stage I's "
            f"net_g_6.pth, {n_skipped} skipped; the teacher and the frozen modules "
            f"({', '.join(LOOP_FROZEN)}): {len(fixed)} tensors bit-identical; all "
            f"{len(trainable)} trainable parameters moved OK")
        del obs, tr, after
        torch.cuda.empty_cache()
        cfg3 = pgtformer_config_from_options(load_options(ymls["III"]))
        err3 = _val_matches_export("III", PGTFormer(cfg3), f"{exp3}/net_g_2.pth", vds,
                                   f"{exp3}/visualization/iter_2", "III")

        # trained to served: stage III's last export through VideoRestorer
        frames = np.stack([cv2.imread(os.path.join(train, "GT", "clip_0", f"{i:08d}.png"))[..., ::-1]
                           for i in range(5)] * 2)[:9]
        r = VideoRestorer(weights=load_checkpoint(f"{exp3}/net_g_3.pth"), cfg=cfg3,
                          batch_windows=8, device="cuda")
        reset_counts()
        r.prime(frames[0])
        served = r.restore_chunk(frames[1:9]).cpu().numpy()
        counts = expect_counts("serving stage III's export", sw_block=22, dense_mha_bnhd=9)
        if served.dtype != np.uint8 or served.shape != (8, LOOP_RES, LOOP_RES, 3):
            raise SystemExit(f"[train_loop:serve] frames {served.dtype} {served.shape}")
        log(f"[train_loop:serve] net_g_3.pth through VideoRestorer.restore_chunk: 8 frames "
            f"uint8 {served.shape}, mean {served.mean():.2f}, launches "
            f"{ {k: v for k, v in counts.items() if v} } OK")
        del r
        torch.cuda.empty_cache()
        du = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
        log(f"[train_loop] {du / 2 ** 30:.2f} GiB written under the temporary tree")
        for tag, t, rr in (("I", t1, r1), ("I+resume", t2, r2), ("III", t3, r3)):
            out[tag] = dict(
                steps_per_s_median=statistics.median(rr["steps_per_s"]),
                steps_per_s=rr["steps_per_s"], wall_s=rr["wall_s"],
                loader_assembly_ms_median=statistics.median(t["loader_load_s"]) * 1e3,
                data_wait_ms_median=statistics.median(t["data_wait_s"]) * 1e3,
                checkpoints=t["save"], restore=t["restore"], validation=t["val"],
                train_launches={k: v for k, v in rr["train_launches"].items() if v},
                val_launches={k: v for k, v in rr["val_launches"].items() if v})
        out["sample_alone_ms"] = alone
        out["val_vs_export_lsb"] = {"I": err1, "III": err3}
        out["merge_pretrained"] = {"loaded": n_loaded, "skipped": n_skipped}
        out["card"] = smi
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# -- evaluation end to end (eval_cli) ------------------------------------------

EVAL_RES = 512
EVAL_CLIPS, EVAL_FRAMES = 2, 5     # the seeded VFHQ-Test tree: GT/<clip>/%08d.png
EVAL_BATCH = 4
EVAL_PER_FORWARD = dict(sw_block=22, dense_mha_bnhd=9)
# the eval forward's kernel shapes: its batches of 4 clips and the tails of 2
EVAL_K1_SHAPES = [(b, 3, h, h, c) for b in (4, 2) for h, c in ((128, 256), (64, 256), (32, 512))]
EVAL_MHA_BATCHES = (4, 2)      # K6 at [B, 3072, 8, 64]
# Card (fp32, TF32 off) against CPU (fp32), the same module and weights on
# the same restored frames; only the summation order differs.  Each limit
# lies between that reading and the control's, the card with TF32 on (the
# failure to catch), both read by `_eval_metric_nets` on an H100: ArcFace
# 6.1e-6 against 1.7e-3, LPIPS 0 against 1.2e-4.
EVAL_ARC_TOL = 1e-4      # ArcFace: max|e_card - e_cpu| <= this * max|e_cpu| (IResNet-50)
EVAL_LPIPS_TOL = 1e-5    # LPIPS: |d_card - d_cpu| <= this * d_cpu (VGG16 at 512x512)
# Parser: a class-map cell may differ only where the CPU's top two logits lie
# within this * max|logit| of each other (argmax near-tie); landmarks are a
# function of the class map, so equal maps must give equal landmarks
EVAL_NEAR_TIE = 1e-3
EVAL_PARTS = ("loading", "forward", "lpips", "face", "niqe", "psnr_ssim")


class _EvalObserver:
    """Times `eval_cli.main` from outside: wraps the module's calls (the
    loader's batches, the restoration forward under CUDA events, the LPIPS
    metric, the face metrics of a frame, NIQE's features, PSNR/SSIM) and
    sums their seconds; the setup is the time from `t0` to the loader's
    first call.  The run is otherwise unchanged.  Undone on exit."""

    def __init__(self, t0: float):
        self.t0 = t0

    def __enter__(self):
        import torch
        from pgtformer_tpu_torch import eval_cli
        from pgtformer_tpu_torch.data import vfhq
        self.mods = {eval_cli: ("restore_middle", "calculate_lpips_fn", "face_metrics_frame",
                                "image_niqe_features", "calculate_psnr", "calculate_ssim"),
                     vfhq: ("clip_batches",)}
        self.saved = {(m, n): getattr(m, n) for m, names in self.mods.items() for n in names}
        saved = {n: fn for (_, n), fn in self.saved.items()}
        self.s = {p: 0.0 for p in EVAL_PARTS}
        self.setup_s = None
        self.batch_ms, self.batch_sizes = [], []
        obs = self

        def timed(part, fn):
            def call(*a, **k):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                obs.s[part] += time.perf_counter() - t0
                return out
            return call

        def clip_batches(*a, **k):
            obs.setup_s = time.perf_counter() - obs.t0
            it = saved["clip_batches"](*a, **k)
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                finally:
                    obs.s["loading"] += time.perf_counter() - t0
                yield batch

        def restore_middle(model, lq, w):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = saved["restore_middle"](model, lq, w)     # ends in a readback
            end.record()
            end.synchronize()
            obs.batch_ms.append(start.elapsed_time(end))
            obs.batch_sizes.append(len(lq))
            obs.s["forward"] += obs.batch_ms[-1] / 1e3
            return out

        def lpips_fn(*a, **k):
            metric = saved["calculate_lpips_fn"](*a, **k)
            timed_metric = timed("lpips", metric)
            timed_metric.random_weights = metric.random_weights
            return timed_metric

        vfhq.clip_batches = clip_batches
        eval_cli.restore_middle = restore_middle
        eval_cli.calculate_lpips_fn = lpips_fn
        eval_cli.face_metrics_frame = timed("face", saved["face_metrics_frame"])
        eval_cli.image_niqe_features = timed("niqe", saved["image_niqe_features"])
        eval_cli.calculate_psnr = timed("psnr_ssim", saved["calculate_psnr"])
        eval_cli.calculate_ssim = timed("psnr_ssim", saved["calculate_ssim"])
        return self

    def __exit__(self, *exc):
        for (m, n), fn in self.saved.items():
            setattr(m, n, fn)
        return False


def _eval_run(tag: str, argv, n_samples: int, smi: str):
    """One `eval_cli.main(argv)` with the launch counts set to 0 just before
    and read just after; asserts rc 0, every column printed and finite,
    exact launches.  Returns this run's numbers."""
    import contextlib
    import io
    import statistics
    import torch
    from pgtformer_tpu_torch import eval_cli
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()       # what earlier phases left
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with _EvalObserver(t0) as obs, contextlib.redirect_stdout(out):
        rc = eval_cli.main(argv)
    wall = time.perf_counter() - t0
    forwards = len(obs.batch_ms)
    counts = expect_counts(f"[eval:{tag}] eval_cli.main", **{
        k: v * forwards for k, v in EVAL_PER_FORWARD.items()})
    peak = torch.cuda.max_memory_allocated() - resident
    text = out.getvalue()
    for line in text.splitlines():
        log(f"[eval:{tag}] | {line}")
    if rc != 0:
        raise SystemExit(f"[eval:{tag}] eval_cli.main returned {rc}")
    cols = {}
    for line in text.strip().splitlines():
        k, v = line.rsplit(":", 1)
        cols[k] = float(v)
    want = ["samples", "psnr", "ssim", "lpips(random-vgg)", "deg", "lmd(parser-lm)",
            "msrl(own-def)", "niqe(gt-fit)", "tlme(parser-lm)"]
    if list(cols) != want or cols["samples"] != n_samples or not all(
            math.isfinite(v) for v in cols.values()):
        raise SystemExit(f"[eval:{tag}] columns {cols}, expected the finite columns {want} "
                         f"over {n_samples} samples")
    if sum(obs.batch_sizes) != n_samples or forwards != math.ceil(n_samples / EVAL_BATCH):
        raise SystemExit(f"[eval:{tag}] forwards of {obs.batch_sizes}")
    setup = obs.setup_s
    per = {p: obs.s[p] / n_samples for p in EVAL_PARTS}
    per["rest"] = (wall - setup) / n_samples - sum(per.values())
    full = [ms for ms, b in zip(obs.batch_ms, obs.batch_sizes) if b == EVAL_BATCH]
    log(f"[eval:{tag}] eval_cli.main in {wall:.2f} s, {n_samples} samples, {forwards} "
        f"forwards (batches {obs.batch_sizes}): setup {setup:.2f} s (the model's build and "
        f"load, the metric networks' builds, the dataset), then {(wall - setup) / n_samples:.4f} "
        f"s per sample: loading {per['loading']:.4f}, forward {per['forward']:.4f} (CUDA "
        f"events; each batch: {' '.join(f'{ms:.1f}' for ms in obs.batch_ms)} ms), LPIPS "
        f"{per['lpips']:.4f}, face metrics (parser + ArcFace + MSRL) {per['face']:.4f}, NIQE "
        f"features {per['niqe']:.4f}, PSNR/SSIM {per['psnr_ssim']:.4f}, the rest "
        f"{per['rest']:.4f}; peak device memory {peak / 2 ** 30:.2f} GiB above the "
        f"{resident / 2 ** 30:.2f} GiB resident before it; "
        f"launches {{{', '.join(f'{k}: {v}' for k, v in counts.items() if v)}}} "
        f"({', '.join(f'{v}/forward' for v in EVAL_PER_FORWARD.values())}); card: {smi}")
    return dict(wall_s=wall, setup_s=setup, samples=n_samples, forwards=forwards,
                batch_ms=obs.batch_ms, batch_sizes=obs.batch_sizes,
                batch4_ms_median=statistics.median(full) if full else None,
                s_per_sample=per, s_per_sample_after_setup=(wall - setup) / n_samples,
                peak_gib=peak / 2 ** 30, resident_gib=resident / 2 ** 30, columns=cols,
                launches={k: v for k, v in counts.items() if v})


def _eval_kernel_checks():
    """K1 (both shifts) and K6 at the eval forward's shapes, its batches of
    4 clips and its tails of 2, against their plain versions (K1_TOL,
    K2_TOL; K6 through `_mha_check`, which also holds K2 and the two
    layouts bit-equal)."""
    from pgtformer_tpu_torch.ops.sw_block import sw_block, sw_block_plain
    rows = []
    for i, shape in enumerate(EVAL_K1_SHAPES):
        for shift in ((0, 0), (2, 2)):
            j = 400 + 2 * i + any(shift)
            w = _sw_block_weights(shape[-1], 8, shape[1], seed=j)
            x = _case_input(j, shape)
            err, mag = _compare(f"K1 {shape} {shift} (eval)", sw_block(x, w, shift),
                                sw_block_plain(x, w, shift), K1_TOL)
            log(f"[eval:kernels] K1 x{list(shape)} shift{shift}: max|d|={err:.3e} "
                f"(max|ref|={mag:.3e}, tol {K1_TOL}*max|ref|) OK")
            rows.append(dict(kernel="sw_block", shape=list(shape), shift=list(shift),
                             max_abs_err=err, max_abs_ref=mag))
    for i, b in enumerate(EVAL_MHA_BATCHES):
        shape = [b, 3072, 8, 64]
        checked = _mha_check(f"{shape} (eval)", *mha_operands(b, 8, 3072, 64, "normal",
                                                              seed=420 + i), 8)
        _, err, mag = checked["bnhd"]
        log(f"[eval:kernels] K6 dense_mha_bnhd {shape}: max|d|={err:.3e} (max|ref|={mag:.3e}, "
            f"tol {K2_TOL}*max|ref|); bhnd max|d|={checked['bhnd'][1]:.3e}, two launches "
            f"bit-equal, bnhd == bhnd OK")
        rows.append(dict(kernel="dense_mha_bnhd", shape=shape, max_abs_err=err, max_abs_ref=mag))
    return rows


def _eval_metric_nets(tag: str, frames, gts, cond_sd, arc_path: str):
    """The metric networks on the card against the same modules on the CPU
    in fp32, on restored frames (and their GT for LPIPS).  ArcFace and LPIPS
    are also read with TF32 on (the control: the failure EVAL_ARC_TOL and
    EVAL_LPIPS_TOL are set to catch), logged beside the sound reading."""
    import numpy as np
    import torch
    from pgtformer_tpu_torch.eval.arcface import ArcFaceEmbedder
    from pgtformer_tpu_torch.eval.landmarks import ParserLandmarkDetector, landmarks_from_parsing
    from pgtformer_tpu_torch.eval.metrics import calculate_lpips_fn
    from pgtformer_tpu_torch.ops.image import imagenet_normalize
    det = {d: ParserLandmarkDetector(cond_sd, device=d) for d in ("cuda", "cpu")}
    arc = {d: ArcFaceEmbedder(arc_path, detector=det["cpu"], device=d) for d in ("cuda", "cpu")}
    lp = {d: calculate_lpips_fn(device=d) for d in ("cuda", "cpu")}
    flags = torch.backends.cudnn, torch.backends.cuda.matmul
    worst = dict(arc=0.0, arc_deg=0.0, lpips=0.0, arc_tf32=0.0, lpips_tf32=0.0, lm_px=0.0,
                 cells=0, ties=0)
    for img, gt in zip(frames, gts):
        e_cpu = arc["cpu"](img).astype(np.float64)
        d_cpu = lp["cpu"](img, gt)
        for key, tf32 in (("", False), ("_tf32", True)):
            before = [f.allow_tf32 for f in flags]
            for f in flags:
                f.allow_tf32 = tf32
            try:
                e = arc["cuda"](img).astype(np.float64)
                d = lp["cuda"](img, gt)
            finally:
                for f, v in zip(flags, before):
                    f.allow_tf32 = v
            worst["arc" + key] = max(worst["arc" + key],
                                     float(np.abs(e - e_cpu).max() / np.abs(e_cpu).max()))
            worst["lpips" + key] = max(worst["lpips" + key], abs(d - d_cpu) / d_cpu)
            if not tf32:
                cos = float(np.dot(e, e_cpu) / np.linalg.norm(e) / np.linalg.norm(e_cpu))
                worst["arc_deg"] = max(worst["arc_deg"], math.degrees(math.acos(min(1.0, cos))))
        maps = {k: det[k].class_map(img) for k in det}
        differ = maps["cuda"] != maps["cpu"]
        if differ.any():
            with torch.no_grad():
                logits = det["cpu"].net(imagenet_normalize(torch.from_numpy(img)[None]))
            top2 = logits[0, :, :, :19].topk(2, dim=-1).values.numpy()
            gap = top2[..., 0] - top2[..., 1]
            worst["ties"] += int((gap[differ] <= EVAL_NEAR_TIE * np.abs(top2).max()).sum())
        worst["cells"] += int(differ.sum())
        lm = {k: landmarks_from_parsing(maps[k], img.shape[0]) for k in maps}
        if not differ.any() and not np.array_equal(lm["cuda"], lm["cpu"]):
            raise SystemExit(f"[eval:{tag}] landmarks differ on equal class maps")
        worst["lm_px"] = max(worst["lm_px"],
                             float(np.linalg.norm(lm["cuda"] - lm["cpu"], axis=-1).max()))
    ok = (worst["arc"] <= EVAL_ARC_TOL and worst["lpips"] <= EVAL_LPIPS_TOL
          and worst["ties"] == worst["cells"])
    log(f"[eval:{tag}] metric networks on the card vs the CPU (fp32, {len(frames)} restored "
        f"frames): ArcFace IResNet-50 max|d|/max|e| {worst['arc']:.3e} (tol {EVAL_ARC_TOL}; "
        f"with TF32 on {worst['arc_tf32']:.3e}), angle {worst['arc_deg']:.4f} deg; LPIPS max "
        f"rel {worst['lpips']:.3e} (tol {EVAL_LPIPS_TOL}; with TF32 on "
        f"{worst['lpips_tf32']:.3e}); parser: {worst['cells']} class-map cells differ of "
        f"{len(frames) * 64 * 64}, {worst['ties']} of them near-ties (<= {EVAL_NEAR_TIE} of "
        f"max|logit|), landmarks equal where the maps are, max {worst['lm_px']:.3f} px apart "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"[eval:{tag}] metric networks disagree between card and CPU")
    return worst


def phase_eval(smi: str):
    """Evaluation end to end through `eval_cli.main` at the full width and
    depth of RELEASE_PGTFORMER (512x512, T=3, bf16, the default plan: K1 and
    K6), on a seeded VFHQ-Test tree of PNGs in a temporary directory (2
    clips x 5 frames), the serving phase's seeded random weights as a
    reference-format .pth (`--weights`) and a seeded IResNet-50 state dict
    (`--arcface-weights`: the strict load and the ArcFace forward run on the
    card; its `deg` therefore comes from random weights):
      `--batch 4 --face-metrics --niqe-fit-gt --arcface-weights ... --save-dir`
      (10 samples, 3 forwards), then `--rotate --inter-space 2` with the same
      flags but `--save-dir` (6 samples, 2 forwards).
    First K1 and K6 at the forward's shapes against their plain versions.
    Exact launches per forward; every column printed and finite; the saved
    PNGs against a direct `PGTFormer.forward(middle_only=True)` of the same
    batches by a model loaded from the same file (0 LSB); ArcFace, LPIPS and
    the parser's landmarks on the card against the CPU."""
    import os
    import shutil
    import tempfile
    import cv2
    import numpy as np
    import torch
    from pgtformer_tpu_torch.config import RELEASE_PGTFORMER
    from pgtformer_tpu_torch.convert import load_checkpoint, load_into
    from pgtformer_tpu_torch.data.vfhq import VFHQTestDataset, clip_batches
    from pgtformer_tpu_torch.eval.arcface import IRESNET50_LAYERS, IResNet
    from pgtformer_tpu_torch.models.pgtformer import PGTFormer
    from pgtformer_tpu_torch.nn.blocks import init_weights
    kernel_checks = _eval_kernel_checks()
    root = tempfile.mkdtemp(prefix="pgt_eval_")
    try:
        rng = np.random.default_rng(31)
        data = os.path.join(root, "vfhq_test")
        for c in range(EVAL_CLIPS):
            d = os.path.join(data, "GT", f"clip_{c}")
            os.makedirs(d)
            for i in range(EVAL_FRAMES):
                cv2.imwrite(os.path.join(d, f"{i:08d}.png"),
                            rng.integers(0, 256, (EVAL_RES, EVAL_RES, 3), dtype=np.uint8))
        weights = os.path.join(root, "pgtformer_seed0.pth")
        model = PGTFormer(RELEASE_PGTFORMER, generator=torch.Generator().manual_seed(0))
        torch.save({"params_ema": model.state_dict()}, weights)
        cond_sd = {k: v.clone() for k, v in model.conditionnet.state_dict().items()}
        del model
        # a seeded IResNet-50 with non-trivial BatchNorm statistics, and the
        # `num_batches_tracked` entries a released backbone.pth carries
        g = torch.Generator().manual_seed(32)
        arc_sd = init_weights(IResNet(IRESNET50_LAYERS), g).state_dict()
        for k in list(arc_sd):
            if k.endswith("running_var"):
                arc_sd[k] = torch.rand(arc_sd[k].shape, generator=g) + 0.5
            elif k.endswith("running_mean"):
                arc_sd[k] = torch.randn(arc_sd[k].shape, generator=g) * 0.1
                arc_sd[k[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(100)
        arc = os.path.join(root, "arcface_r50_seed32.pth")
        torch.save(arc_sd, arc)
        log(f"[eval] seeded VFHQ-Test tree ({EVAL_CLIPS} clips x {EVAL_FRAMES} frames, "
            f"{EVAL_RES}x{EVAL_RES}), --weights {os.path.getsize(weights) / 2 ** 20:.1f} MiB "
            f"(the serving phase's seed-0 weights), --arcface-weights "
            f"{os.path.getsize(arc) / 2 ** 20:.1f} MiB (a seeded IResNet-50: RANDOM weights, "
            f"so 'deg' measures nothing yet)")
        saved = os.path.join(root, "saved")
        common = ["--data-root", data, "--weights", weights, "--batch", str(EVAL_BATCH),
                  "--face-metrics", "--niqe-fit-gt", "--arcface-weights", arc]
        n1 = EVAL_CLIPS * EVAL_FRAMES
        run1 = _eval_run("test", common + ["--save-dir", saved], n1, smi)
        n2 = EVAL_CLIPS * len(range(0, EVAL_FRAMES, 2))
        run2 = _eval_run("rotate", common + ["--rotate", "--inter-space", "2"], n2, smi)
        torch.cuda.empty_cache()

        # the saved frames are the model's: a direct forward of the same batches
        model = load_into(PGTFormer(RELEASE_PGTFORMER), load_checkpoint(weights))
        model = model.to("cuda", torch.bfloat16).eval().requires_grad_(False)
        ds = VFHQTestDataset(data, r=1, degradation="blr")
        worst, n, frames, gts = 0, 0, [], []
        for batch in clip_batches(ds, EVAL_BATCH, drop_last=False):
            with torch.no_grad():
                outs = model(torch.from_numpy(batch["lq"]).cuda(), w=1.0,
                             middle_only=True)[0].float().clamp(0, 1).cpu().numpy()
            for i, out in enumerate(outs):
                mine = (out[..., ::-1] * 255).astype(np.uint8)
                png = cv2.imread(os.path.join(saved, batch["path"][i].replace("/", "_")))
                worst = max(worst, int(np.abs(mine.astype(int) - png.astype(int)).max()))
                n += 1
                if len(frames) < 2:
                    frames.append(out)
                    gts.append(batch["gt"][i][1])
        if n != n1 or worst != 0:
            raise SystemExit(f"[eval] {n} saved frames, max {worst} LSB from the model's own "
                             "forward")
        log(f"[eval] the {n} saved PNGs equal a direct PGTFormer.forward(middle_only=True) of "
            f"the same batches by a model loaded from the same .pth: max 0 LSB OK")
        del model
        torch.cuda.empty_cache()
        nets = _eval_metric_nets("nets", frames, gts, cond_sd, arc)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(test=run1, rotate=run2, metric_nets=nets, saved_frames_lsb=worst,
                kernel_checks=kernel_checks, card=smi)


VIDEO_RES = 512
# prime + 23 full chunks of 8 + 7 frames, whose chunk the last frame pads: every
# step restores 8 frames, so the steady rate is not diluted by a 1-frame tail
VIDEO_FRAMES = 192
VIDEO_STEPS = 24
VIDEO_FPS = 25.0
VIDEO_FPS_TOL = 0.01     # |fps(output) - fps(input)| as the reader reports them
VIDEO_PER_STEP = dict(sw_block=22, dense_mha_bnhd=9)
VIDEO_YUV_LSB = 1        # written planes vs _rgb_to_yuv420 of the step's float output on the CPU
VIDEO_LUMA_TOL = 3.0     # mean |luma(decoded yuv420 file) - luma(restored frames)|, as JAX's test
VIDEO_COPY_SHARE = 0.25  # each chunk's host copy ends within this share of a step after its step
VIDEO_CASES = (          # tag, io_backend, readback, inflight, codec
    ("opencv", "opencv", "rgb", 3, "auto"),
    ("mpeg4", "native", "rgb", 3, "mpeg4"),
    ("mpeg4_inflight1", "native", "rgb", 1, "mpeg4"),
    ("auto_yuv420", "native", "yuv420", 3, "auto"),
)
# where the native library cannot be built: the GPU side of the last three
# (inflight, yuv420 readback) still runs, with OpenCV reading and, for
# yuv420, a writer that keeps the planes in place of the encoder
VIDEO_CASES_WITHOUT_NATIVE = (
    ("opencv", "opencv", "rgb", 3, "auto"),
    ("opencv_inflight1", "opencv", "rgb", 1, "auto"),
    ("yuv420_no_encoder", "opencv", "yuv420", 3, "auto"),
)


def _video_clip(path: str):
    """A seeded VIDEO_FRAMES-frame 512x512 clip at 25 fps (OpenCV, mp4v): smooth
    gradients moving a little each frame, plus noise, so lossy codecs
    round-trip meaningfully."""
    import cv2
    import numpy as np
    rng = np.random.default_rng(41)
    yy, xx = np.mgrid[0:VIDEO_RES, 0:VIDEO_RES].astype(np.float32) / VIDEO_RES
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), VIDEO_FPS, (VIDEO_RES, VIDEO_RES))
    for i in range(VIDEO_FRAMES):
        t = i / VIDEO_FRAMES
        rgb = np.stack([np.sin(2 * np.pi * (xx + t)), np.sin(2 * np.pi * (1.3 * yy - t)),
                        np.cos(2 * np.pi * (xx + yy + 0.5 * t))], -1)
        rgb = 128 + 90 * rgb + rng.normal(0, 4, rgb.shape)
        w.write(np.ascontiguousarray(np.clip(rgb, 0, 255).astype(np.uint8)[..., ::-1]))
    w.release()


def _video_decode(path: str, backend: str):
    from pgtformer_tpu_torch.pipeline import _open_reader
    rd = _open_reader(path, backend)
    try:
        return list(rd), rd.fps
    finally:
        rd.close()


def _video_reference(r, frames, float_outs=None):
    """restore_chunk over `frames` in restore_video's chunk schedule: the
    restored frames (rgb) or planes (yuv420) of each chunk's valid rows.
    With `float_outs` (a list), the float output each step converts is
    appended to it (CPU copies of the valid rows)."""
    import numpy as np
    import torch
    from pgtformer_tpu_torch import pipeline
    B, outs = r.batch, []
    convert = pipeline._rgb_to_yuv420
    r.reset()
    r.prime(frames[0])
    rest, valid = list(frames[1:]), []
    while len(rest) >= B:
        valid.append((rest[:B], B))
        rest = rest[B:]
    needed = len(rest) + r.radius
    while needed > 0:
        valid.append((rest + [frames[-1]] * (B - len(rest)), min(B, needed)))
        needed -= min(B, needed)
        rest = []
    try:
        if float_outs is not None:
            pipeline._rgb_to_yuv420 = lambda out: float_outs.append(out) or convert(out)
        for chunk, n in valid:
            got = r.restore_chunk(np.stack(chunk))
            outs.append([t[:n].cpu().numpy() for t in (got if r.readback == "yuv420" else [got])])
    finally:
        pipeline._rgb_to_yuv420 = convert
    torch.cuda.synchronize()
    if float_outs is not None:
        float_outs[:] = [o[:n].cpu() for o, (_, n) in zip(float_outs, valid)]
    return [np.concatenate([o[i] for o in outs]) for i in range(len(outs[0]))]


class _TimedEvents:
    """Within the block every torch.cuda.Event records time, and each one
    made is kept in order (restore_video makes two per chunk: its step's
    end on the compute stream, its host copy's end on the copy stream)."""

    def __enter__(self):
        import torch
        self.real, made = torch.cuda.Event, []

        class Event(torch.cuda.Event):
            def __new__(cls, enable_timing=False, blocking=False, interprocess=False):
                ev = super().__new__(cls, enable_timing=True, blocking=blocking,
                                     interprocess=interprocess)
                made.append(ev)
                return ev
        self.made = made
        torch.cuda.Event = Event
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.Event = self.real


class _PlaneRecorder:
    """Stands in for the native writer where it cannot be built: keeps the
    yuv420 planes restore_video hands it and encodes nothing."""

    def __init__(self, *a, **k):
        pass

    def write_yuv420(self, y, u, v):
        pass

    def close(self):
        pass


def _video_case(tag, r, src, backend, readback, inflight, codec, root, smi, step_ms,
                x265: bool, encoder: bool = True):
    """One restore_video run on the card with the launch counts set to 0
    just before and read just after, then its checks against restore_chunk
    over the frames the case's own reader decodes.  `encoder` False: the
    yuv420 planes go to a `_PlaneRecorder` and no file is written."""
    import os
    import numpy as np
    import torch
    from pgtformer_tpu_torch import pipeline
    decoded, src_fps = _video_decode(src, backend)
    r.io_backend, r.readback, r.inflight = backend, readback, inflight
    out = os.path.join(root, f"{tag}.mp4")
    frames, planes = [], []
    real_open_writer = pipeline._open_writer
    if readback == "yuv420":
        def open_writer(*a, **k):
            w = real_open_writer(*a, **k) if encoder else _PlaneRecorder()
            write = w.write_yuv420

            def record(y, u, v):
                planes.append((y.copy(), u.copy(), v.copy()))
                write(y, u, v)
            w.write_yuv420 = record
            return w
        pipeline._open_writer = open_writer
    cb = None if readback == "yuv420" else (lambda i, f: frames.append(f.copy()))
    # earlier phases' unreachable tensors go now, not inside the case, where
    # their release would lower the peak read against `resident`
    gc.collect()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    try:
        with _TimedEvents() as ev:
            reset_counts()
            stats = r.restore_video(src, out, frame_callback=cb, codec=codec)
            counts = expect_counts(f"[video:{tag}] restore_video", **{
                k: v * VIDEO_STEPS for k, v in VIDEO_PER_STEP.items()})
    finally:
        pipeline._open_writer = real_open_writer
    peak = torch.cuda.max_memory_allocated() - resident
    # the allocator's side of the peak: what it held from the driver, and
    # how often a cudaMalloc failed and it freed its cache to retry
    reserved = torch.cuda.max_memory_reserved()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
    torch.cuda.synchronize()
    if len(ev.made) != 2 * VIDEO_STEPS:
        raise SystemExit(f"[video:{tag}] {len(ev.made)} CUDA events, expected 2 a chunk")
    copy_ms = [a.elapsed_time(b) for a, b in zip(ev.made[::2], ev.made[1::2])]
    if max(copy_ms) > VIDEO_COPY_SHARE * step_ms:
        raise SystemExit(f"[video:{tag}] a host copy ended {max(copy_ms):.2f} ms after its "
                         f"step (a step is {step_ms:.2f} ms): the copies wait for later steps")
    # the output file: frame count, fps, and the hvc1 sample entry from libx265
    got, fps, data = [], src_fps, b""
    if encoder:
        got, fps = _video_decode(out, backend)
        data = open(out, "rb").read()
    elif readback == "yuv420" and len(planes) != VIDEO_FRAMES:
        raise SystemExit(f"[video:{tag}] {len(planes)} frames of planes written")
    if (encoder and len(got) != VIDEO_FRAMES) or abs(fps - src_fps) > VIDEO_FPS_TOL or \
            stats["frames"] != VIDEO_FRAMES:
        raise SystemExit(f"[video:{tag}] output {len(got)} frames at {fps} fps, stats "
                         f"{stats['frames']} frames; expected {VIDEO_FRAMES} at {src_fps}")
    tagged = b"hvc1" in data and b"hev1" not in data
    if codec == "auto" and backend == "native" and x265 and not tagged:
        raise SystemExit(f"[video:{tag}] libx265 was picked but the file lacks the hvc1 tag")
    # against restore_chunk over the frames this case's reader decodes
    float_outs = [] if readback == "yuv420" else None
    ref = _video_reference(r, decoded, float_outs)
    res = dict(stats=stats, counts={k: v for k, v in counts.items() if v},
               peak_gib=peak / 2 ** 30, resident_gib=resident / 2 ** 30,
               peak_reserved_gib=reserved / 2 ** 30, alloc_retries=retries,
               copy_after_step_ms=copy_ms, file_bytes=len(data), hvc1=tagged,
               readback_bytes_per_frame=1.5 * VIDEO_RES ** 2 if readback == "yuv420"
               else 3.0 * VIDEO_RES ** 2)
    if readback == "rgb":
        mine = np.stack(frames)
        if mine.shape != ref[0].shape or not np.array_equal(mine, ref[0]):
            raise SystemExit(f"[video:{tag}] frame_callback frames differ from restore_chunk "
                             "over the same reader's frames")
        res["frames"] = mine
    else:
        mine = [np.stack([p[i] for p in planes]) for i in range(3)]
        if any(m.shape != f.shape or not np.array_equal(m, f) for m, f in zip(mine, ref)):
            raise SystemExit(f"[video:{tag}] written planes differ from restore_chunk's")
        cpu = pipeline._rgb_to_yuv420(torch.cat(float_outs))
        lsb = max(int((torch.from_numpy(m).int() - c.int()).abs().max())
                  for m, c in zip(mine, cpu))
        if lsb > VIDEO_YUV_LSB:
            raise SystemExit(f"[video:{tag}] planes {lsb} LSB from _rgb_to_yuv420 of the "
                             "step's float output on the CPU")
        res["yuv_lsb_vs_cpu"] = lsb
    res["decoded"] = got
    ph = stats["phases"]
    log(f"[video:{tag}] restore_video({backend}, readback={readback}, inflight={inflight}, "
        f"codec={codec}) RELEASE_PGTFORMER {VIDEO_RES}x{VIDEO_RES} B={r.batch} bf16, "
        f"{VIDEO_FRAMES} frames: wall {stats['seconds']:.3f} s, {stats['fps']:.3f} frames/s, "
        f"steady {stats['steady_fps']:.3f} frames/s, startup_seconds "
        f"{stats['startup_seconds']:.3f}; phases (total s / mean ms): "
        + ", ".join(f"{k} {v['total_s']:.3f} / {v['mean_ms']:.2f} (x{v['count']})"
                    for k, v in ph.items())
        + f"; readback {res['readback_bytes_per_frame'] / VIDEO_RES ** 2:g} B/pixel; each "
        f"chunk's host copy ended {min(copy_ms):.2f}-{max(copy_ms):.2f} ms after its step; "
        f"peak {peak / 2 ** 30:.2f} GiB above the {resident / 2 ** 30:.2f} GiB resident "
        f"({reserved / 2 ** 30:.2f} GiB reserved at most, {retries} allocation retries); "
        f"launches {res['counts']}; "
        + (f"file {len(data)} bytes{' hvc1' if tagged else ''}; " if encoder else
           "no file: the planes went to a recorder in place of the native writer; ")
        + (f"planes {res['yuv_lsb_vs_cpu']} LSB from the CPU conversion; "
           if readback == "yuv420" else "")
        + f"frames equal restore_chunk over the same reader's frames OK; card: {smi}")
    return res


def _video_inflight_sweep(r, src, root, smi, depths=(1, 2, 3, 3, 2, 1)):
    """restore_video at each inflight depth, in an ABBA order against drift:
    OpenCV I/O, rgb, no frame callback (the CLI without --dump-frames);
    exact launches each run.  Returns {depth: [(frames/s, steady), ...]}."""
    import os
    r.io_backend, r.readback = "opencv", "rgb"
    rates = {}
    for depth in depths:
        r.inflight = depth
        reset_counts()
        st = r.restore_video(src, os.path.join(root, "sweep.mp4"))
        expect_counts(f"[video:inflight] restore_video(inflight={depth})", **{
            k: v * VIDEO_STEPS for k, v in VIDEO_PER_STEP.items()})
        rates.setdefault(depth, []).append((st["fps"], st["steady_fps"]))
    log(f"[video:inflight] restore_video(opencv, rgb, no callback), {VIDEO_FRAMES} frames, "
        f"depths in the order {depths}: "
        + "; ".join(f"inflight {d}: " + ", ".join(f"{fps:.3f} ({steady:.3f} steady)"
                                                  for fps, steady in runs)
                    for d, runs in sorted(rates.items()))
        + f" frames/s; card: {smi}")
    return rates


def _video_cli(src, root, smi, native_ok):
    """cli.main on the clip with `--codec mpeg4 --encode-quality-check`:
    exact launches, its printed lines, the quality check's and VMAF's time."""
    import contextlib
    import io
    import os
    from pgtformer_tpu_torch import cli
    from pgtformer_tpu_torch.eval import vmaf
    spent = {"quality_check": 0.0, "vmaf": 0.0}
    real_qc, real_update = cli.quality_check, vmaf.VmafScorer.update

    def qc(*a, **k):
        t0 = time.perf_counter()
        real_qc(*a, **k)
        spent["quality_check"] += time.perf_counter() - t0

    def update(self, *a, **k):
        t0 = time.perf_counter()
        real_update(self, *a, **k)
        spent["vmaf"] += time.perf_counter() - t0
    text = io.StringIO()
    cli.quality_check, vmaf.VmafScorer.update = qc, update
    try:
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = cli.main(["-i", src, "-o", os.path.join(root, "cli.mp4"), "--codec", "mpeg4",
                           "--encode-quality-check"])
        wall = time.perf_counter() - t0
        counts = expect_counts("[video:cli] cli.main", **{
            k: v * VIDEO_STEPS for k, v in VIDEO_PER_STEP.items()})
    finally:
        cli.quality_check, vmaf.VmafScorer.update = real_qc, real_update
    lines = text.getvalue().splitlines()
    for line in lines:
        log(f"[video:cli] | {line}")
    q = [ln for ln in lines if ln.startswith("encode quality")]
    v = [ln for ln in lines if ln.startswith("vmaf(own-impl)")]
    nums = [float(x) for x in re.findall(r"(?:psnr|ssim|:) (-?[\d.]+)", " ".join(q + v))]
    if rc != 0 or len(q) != 1 or len(v) != 1 or len(nums) != 3 or not all(
            math.isfinite(x) for x in nums):
        raise SystemExit(f"[video:cli] rc {rc}; quality lines {q + v}")
    log(f"[video:cli] cli.main in {wall:.2f} s ({'native' if native_ok else 'OpenCV'} I/O): "
        f"psnr {nums[0]} dB, ssim {nums[1]}, vmaf(own-impl) {nums[2]}; the quality check "
        f"{spent['quality_check']:.2f} s, of it VMAF {spent['vmaf']:.2f} s over 16 frames; "
        f"launches {({k: n for k, n in counts.items() if n})}; card: {smi}")
    return dict(wall_s=wall, psnr=nums[0], ssim=nums[1], vmaf=nums[2],
                quality_check_s=spent["quality_check"], vmaf_s=spent["vmaf"],
                counts={k: n for k, n in counts.items() if n})


def phase_video(smi: str, serve: dict):
    """The file path on the card (`VideoRestorer.restore_video`, the CLI,
    the stage profiler and the encoder bench): see the module docstring."""
    import os
    import shutil
    import tempfile
    import cv2
    import numpy as np
    import torch
    from pgtformer_tpu_torch import bench_encode, profile_stages
    from pgtformer_tpu_torch.config import RELEASE_PGTFORMER
    from pgtformer_tpu_torch.io import native
    from pgtformer_tpu_torch.pipeline import VideoRestorer
    t0 = time.perf_counter()
    try:
        native.load_library()
        native_ok, why = True, ""
        log(f"[video] native I/O: built in {time.perf_counter() - t0:.2f} s "
            f"({native.LIBRARY})")
    except native.NativeVideoUnavailable as e:
        native_ok, why = False, str(e).strip().splitlines()[-1] if str(e).strip() else repr(e)
        log(f"[video] native I/O: unavailable: {e}")
        log(f"[video] the native cases ({', '.join(c[0] for c in VIDEO_CASES[1:])}: "
            f"native decode and encode, libx265, the yuv420 file) did NOT run on this "
            f"machine: {why}; instead "
            f"{', '.join(c[0] for c in VIDEO_CASES_WITHOUT_NATIVE[1:])} run the GPU side "
            "(inflight, yuv420 readback) with OpenCV reading and no yuv420 encoder")
    x265 = False
    root = tempfile.mkdtemp(prefix="pgt_video_")
    try:
        if native_ok:
            try:
                native.NativeVideoWriter(os.path.join(root, "probe.mp4"), VIDEO_FPS,
                                         (64, 64), codec="libx265").close()
                x265 = True
            except IOError:
                pass
        src = os.path.join(root, "in.mp4")
        _video_clip(src)
        log(f"[video] seeded clip: {VIDEO_FRAMES} frames {VIDEO_RES}x{VIDEO_RES} at "
            f"{VIDEO_FPS} fps (OpenCV mp4v, {os.path.getsize(src)} bytes); libx265 in this libav "
            f"build: {x265}")
        # the serving phase's model: the same seed, checked on its first chunk
        r = VideoRestorer(None, RELEASE_PGTFORMER, batch_windows=8, dtype=torch.bfloat16,
                          device="cuda", seed=0)
        r.prime(serve["frames"][0])
        if not torch.equal(r.restore_chunk(serve["frames"][1:9]), serve["outs"][0]):
            raise SystemExit("[video] the seed-0 restorer differs from the serving phase's")
        step_ms = serve["step_ms"]
        cases = {}
        for tag, backend, readback, inflight, codec in (
                VIDEO_CASES if native_ok else VIDEO_CASES_WITHOUT_NATIVE):
            cases[tag] = _video_case(tag, r, src, backend, readback, inflight, codec,
                                     root, smi, step_ms, x265,
                                     encoder=native_ok or readback == "rgb")
        a, b = ((cases["mpeg4"], cases["mpeg4_inflight1"]) if native_ok else
                (cases["opencv"], cases["opencv_inflight1"]))
        if not np.array_equal(a["frames"], b["frames"]):
            raise SystemExit("[video] frames differ between inflight 3 and 1")
        log("[video] frames bit-equal across inflight 3 and 1 OK")
        if native_ok:
            a = a["frames"]
            luma = lambda fs: np.stack([cv2.cvtColor(f, cv2.COLOR_RGB2YUV)[..., 0]
                                        for f in fs]).astype(np.int32)
            d_luma = float(np.abs(luma(cases["auto_yuv420"]["decoded"]) - luma(a)).mean())
            b_luma = float(np.abs(luma(cases["mpeg4"]["decoded"]) - luma(a)).mean())
            if d_luma >= VIDEO_LUMA_TOL:
                raise SystemExit(f"[video] yuv420 file's decoded luma {d_luma:.3f} from the "
                                 "restored frames")
            log(f"[video] decoded luma mean|d| from the restored frames: yuv420 ({'libx265' if x265 else 'auto'}) "
                f"{d_luma:.4f} (tol {VIDEO_LUMA_TOL}), mpeg4 rgb {b_luma:.4f}; yuv420 planes "
                f"{cases['auto_yuv420']['yuv_lsb_vs_cpu']} LSB from the CPU conversion")
            cases["auto_yuv420"]["luma_vs_restored"] = d_luma
            cases["mpeg4"]["luma_vs_restored"] = b_luma
        sweep = _video_inflight_sweep(r, src, root, smi)
        del r
        torch.cuda.empty_cache()
        cli_run = _video_cli(src, root, smi, native_ok)
        torch.cuda.empty_cache()
        prof = profile_stages.profile(batch=8, iters=5, device="cuda")
        log(f"[video:stages] profile_stages, serving step B=8 {VIDEO_RES}x{VIDEO_RES} bf16, "
            f"CUDA events over 5 calls: "
            + ", ".join(f"{k} {v:.3f}" for k, v in prof["stages_ms"].items())
            + f" ms; stage sum {prof['stage_sum_ms']:.3f} ms, whole step "
            f"{prof['step_ms']:.3f} ms; card: {smi}")
        torch.cuda.empty_cache()
        enc = None
        if native_ok:
            enc = bench_encode.bench(frames=48, size=VIDEO_RES,
                                     codecs=("mpeg4", "libx264", "libx265"))
            log(f"[video:encode] bench_encode, 48 frames {VIDEO_RES}x{VIDEO_RES}, "
                f"{enc['host_cores']} host cores, default presets: "
                + ", ".join(f"{row['codec']} " + (f"{row['fps']:.2f} frames/s "
                                                  f"{row['kbits_per_frame']:.1f} kbit/frame"
                                                  if "fps" in row else "unavailable")
                            for row in enc["rows"]))
        else:
            log(f"[video:encode] bench_encode did NOT run: native I/O unavailable ({why})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for c in cases.values():
        for k in ("frames", "decoded"):
            c.pop(k, None)
    log(f"[video] phase in {time.perf_counter() - t0:.1f} s")
    return dict(native=native_ok, native_unavailable=why or None, libx265=x265, cases=cases,
                inflight_sweep=sweep, cli=cli_run, stages=prof, encode=enc, card=smi)


# -- several ranks (phase_multi) ------------------------------------------------

MULTI_B = 8                   # the serving chunk: Bl = 4 windows a rank at two ranks
MULTI_CHUNKS = 3
MULTI_SERVE_PER_STEP = dict(sw_block=22, dense_mha_bnhd=9)    # per rank and step
MULTI_TRAIN_STEPS = 2
MULTI_TRAIN_PER_STEP = {"I": dict(sw_block=22, vq_nearest=1),
                        "III": dict(sw_block=30, vq_nearest=1, dense_mha_bnhd=9)}
MULTI_LOSS_TOL = 5e-2         # |loss(ranks) - loss(one process)| <= this * max(|ref|, 0.1),
                              # the card test's bf16 step tolerance
MULTI_TIMEOUT_S = 600.0


def _multi_group(rank: int, world: int, store: str, backend: str):
    """A rank of phase_multi: gloo with every rank on cuda:0 (two ranks
    time-sliced on one card), or NCCL with rank k on cuda:k."""
    import torch
    from pgtformer_tpu_torch import parallel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if backend == "gloo":
        return parallel.init_group(rank, world, store, device="cuda:0", backend="gloo",
                                   share_device=True, timeout_s=MULTI_TIMEOUT_S)
    return parallel.init_group(rank, world, store, device=f"cuda:{rank}",
                               timeout_s=MULTI_TIMEOUT_S)


def _launches() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items() if fn.launches}


def _multi_serve_rank(rank: int, world: int, store: str, backend: str, frames):
    """One rank of the sharded serving step: prime + MULTI_CHUNKS chunks of
    MULTI_B frames (rank 0 holds them); each chunk timed on the host clock
    to its synchronize.  Returns rank 0's gathered frames, the rank's
    launches, step times and peak memory."""
    import numpy as np
    import torch
    from pgtformer_tpu_torch import parallel
    from pgtformer_tpu_torch.config import RELEASE_PGTFORMER
    from pgtformer_tpu_torch.pipeline import VideoRestorer
    g = _multi_group(rank, world, store, backend)
    try:
        r = VideoRestorer(None, RELEASE_PGTFORMER, w=1.0, batch_windows=MULTI_B,
                          dtype=torch.bfloat16, seed=0, group=g)
        r.prime(frames[0] if rank == 0 else None)
        torch.cuda.reset_peak_memory_stats(g.device)
        reset_counts()
        outs, times = [], []
        for c in range(MULTI_CHUNKS):
            t0 = time.perf_counter()
            out = r.restore_chunk(frames[1 + c * MULTI_B:1 + (c + 1) * MULTI_B]
                                  if rank == 0 else None)
            torch.cuda.synchronize(g.device)
            times.append((time.perf_counter() - t0) * 1e3)
            if out is not None:
                outs.append(out.cpu().numpy())
        return dict(frames=np.concatenate(outs) if rank == 0 else None, counts=_launches(),
                    step_ms=times, peak=torch.cuda.max_memory_allocated(g.device),
                    device=str(g.device))
    finally:
        parallel.destroy_group()


def _multi_trainer(kind: str, group=None):
    """phase_train's trainers (same seeds, random LPIPS VGG, bf16), on the
    group's device or cuda."""
    import dataclasses
    import torch
    from pgtformer_tpu_torch.config import RELEASE_PGTFORMER
    from pgtformer_tpu_torch.models.vae import TDCRQVAE3
    from pgtformer_tpu_torch.train.lpips import make_lpips_fn
    from pgtformer_tpu_torch.train.stages import STAGE_HYPERS, PGTFormerTrainer, Stage1Trainer
    dev = group.device if group is not None else torch.device("cuda")
    lpips_fn = make_lpips_fn(device=dev, warn_random=False)
    hp = dataclasses.replace(STAGE_HYPERS[kind], warmup_iter=-1)
    if kind == "I":
        # no restarts: across ranks a restart draws from rank 0's clip (the
        # reference's DDP broadcast), in one process from both clips, so the
        # runs would part after the first step; _multi_restart_check holds
        # the restart's broadcast on the card
        vq = dataclasses.replace(RELEASE_PGTFORMER.vqvae, restart_unused_codes=False)
        tr = Stage1Trainer(vq, hp, lpips_fn=lpips_fn, device=dev,
                           dtype=torch.bfloat16, group=group)
        return tr, tr.init_state(torch.Generator().manual_seed(11))
    teacher = TDCRQVAE3(RELEASE_PGTFORMER.vqvae, generator=torch.Generator().manual_seed(12))
    tr = PGTFormerTrainer(RELEASE_PGTFORMER, "III", hp, lpips_fn=lpips_fn, device=dev,
                          dtype=torch.bfloat16, group=group)
    return tr, tr.init_state(torch.Generator().manual_seed(13), teacher.state_dict())


def _trained_digest(tr, state) -> str:
    """sha256 over every tensor a data-parallel step keeps equal across the
    ranks: parameters and buffers of both networks (codebooks and their
    EMAs, BatchNorm statistics), the parameters' EMA, both Adams' moments."""
    import torch
    h = hashlib.sha256()
    named = {f"g.{k}": v for k, v in tr.model.state_dict().items()}
    named.update({f"ema.{k}": v for k, v in state.g.ema_params.items()})
    named.update({f"d.{k}": v for k, v in tr.disc.state_dict().items()})
    for name, opt in (("opt_g", tr.opt_g), ("opt_d", tr.opt_d)):
        for i, st in opt.state_dict()["state"].items():
            named.update({f"{name}.{i}.{k}": v for k, v in st.items() if torch.is_tensor(v)})
    for k in sorted(named):
        h.update(k.encode())
        h.update(named[k].detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def _multi_batch(kind: str, rows):
    """phase_train's clip (seed 5) and a second one: [2, 3, 512, 512, 3] uint8."""
    import numpy as np
    rng = np.random.default_rng(5)
    gt = rng.integers(0, 256, (2, 3, TRAIN_RES, TRAIN_RES, 3), dtype=np.uint8)
    lq = np.clip(gt.astype(np.int16) + rng.integers(-24, 25, gt.shape), 0, 255).astype(np.uint8)
    gt, lq = gt[rows], lq[rows]
    return gt if kind == "I" else {"lq": lq, "gt": gt}


def _train_steps(tr, state, batch, digest: bool, steps: int = MULTI_TRAIN_STEPS,
                 after_first=None):
    """`steps` steps on `batch`, each timed to its synchronize, with its
    launches, metrics and (with `digest`) the digest of the trained tensors;
    `after_first(state)` runs untimed after the first."""
    import torch
    step = tr.make_step()
    out = []
    for i in range(steps):
        reset_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize(tr.device)
        ms = (time.perf_counter() - t0) * 1e3
        out.append(dict(ms=ms, counts=_launches(),
                        metrics={k: float(v) for k, v in metrics.items()},
                        digest=_trained_digest(tr, state) if digest else None))
        if i == 0 and after_first is not None:
            after_first(state)
    return out


def _multi_restart_check(group):
    """The codebook EMA update with restarts across the ranks on the card,
    at the deployed codebook (1024 x 512) and one clip's 3072 latents a rank
    (seeded per rank): returns the digest of the updated buffers and whether
    every restarted code is one of rank 0's latents."""
    import torch
    from pgtformer_tpu_torch.models.quantizer import ema_codebook_update
    dev = group.device
    g = torch.Generator().manual_seed(21)
    weight = torch.randn(1025, 512, generator=g).to(dev)
    weight[-1] = 0
    cluster = (torch.rand(1024, generator=g) * 2).to(dev)
    embed_ema = torch.randn(1024, 512, generator=g).to(dev)
    vecs = [torch.randn(TRAIN_VQ_ROWS, 512, generator=torch.Generator().manual_seed(30 + r))
            .to(dev) for r in (0, group.rank)]
    idx = torch.randint(0, 512, (TRAIN_VQ_ROWS,), generator=torch.Generator()
                        .manual_seed(40 + group.rank)).to(dev)        # half the codes unused
    ema_codebook_update(weight, cluster, embed_ema, vecs[1], idx, decay=0.99,
                        restart_unused_codes=True,
                        generator=torch.Generator(device=dev).manual_seed(50), group=group)
    restarted = cluster == 1.0
    rows = embed_ema[restarted]
    from_rank0 = bool((torch.cdist(rows, vecs[0], compute_mode="donot_use_mm_for_euclid_dist")
                       .min(dim=1).values == 0).all())
    h = hashlib.sha256()
    for t in (weight, cluster, embed_ema):
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return dict(digest=h.hexdigest()[:16], restarted=int(restarted.sum()), from_rank0=from_rank0)


def _multi_train_rank(rank: int, world: int, store: str, backend: str, kind: str,
                      save_dir: str):
    """One rank of the data-parallel step: its clip of the two, the steps'
    times, launches, metrics and the digest of its trained tensors.  After
    the first step rank 0 saves the training state into `save_dir`, from
    which one process takes the second step on both clips."""
    import torch
    from pgtformer_tpu_torch import parallel
    from pgtformer_tpu_torch.utils.checkpoint import CheckpointManager
    g = _multi_group(rank, world, store, backend)

    def save(state):
        if rank == 0:
            CheckpointManager(save_dir).save(1, state, tr)
        parallel.barrier(g)

    try:
        t0 = time.perf_counter()
        tr, state = _multi_trainer(kind, g)
        built = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(g.device)
        per = 2 // world
        steps = _train_steps(tr, state, _multi_batch(kind, slice(rank * per, (rank + 1) * per)),
                             digest=True, after_first=save)
        return dict(steps=steps, peak=torch.cuda.max_memory_allocated(g.device),
                    built_s=built, device=str(g.device),
                    restart=_multi_restart_check(g) if kind == "I" else None)
    finally:
        parallel.destroy_group()


def _multi_serving(tag: str, backend: str, world: int, frames, ref, serve: dict, smi: str):
    """(a) / (c): the sharded step on `world` ranks against one process at
    MULTI_B / world windows (bit for bit) and the B=8 default step."""
    import numpy as np
    from pgtformer_tpu_torch import parallel
    t0 = time.perf_counter()
    res = parallel.spawn(_multi_serve_rank, world, args=(backend, frames),
                         timeout_s=MULTI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for k, r in enumerate(res):
        want = {n: v * MULTI_CHUNKS for n, v in MULTI_SERVE_PER_STEP.items()}
        if r["counts"] != want:
            raise SystemExit(f"[multi:{tag}] rank {k} launched {r['counts']}, expected {want}")
    got = res[0]["frames"]
    if got.shape != ref.shape or not np.array_equal(got, ref):
        diff = (np.abs(got.astype(int) - ref.astype(int)).max() if got.shape == ref.shape
                else f"shape {got.shape}")
        raise SystemExit(f"[multi:{tag}] rank 0's frames differ from one process at "
                         f"batch_windows={MULTI_B // world}: {diff}")
    b8 = np.concatenate([o.cpu().numpy() for o in serve["outs"][:MULTI_CHUNKS]])
    d8 = np.abs(got.astype(int) - b8.astype(int))
    step_ms = max(sorted(r["step_ms"][1:])[len(r["step_ms"][1:]) // 2] for r in res)
    log(f"[multi:{tag}] {world} ranks over {backend} on {', '.join(r['device'] for r in res)}, "
        f"RELEASE_PGTFORMER 512x512 B={MULTI_B} (Bl={MULTI_B // world} windows a rank), "
        f"{MULTI_CHUNKS} chunks: rank 0's frames bit-equal to one process at batch_windows="
        f"{MULTI_B // world} OK; vs the one-process B={MULTI_B} step max {d8.max()} LSB, "
        f"mean {d8.mean():.4f}; launches per rank "
        f"{[{n: v // MULTI_CHUNKS for n, v in r['counts'].items()} for r in res]} a step "
        f"(exact); step ms per rank (first, then steady) "
        f"{[[round(t, 2) for t in r['step_ms']] for r in res]}; frames/s "
        f"{MULTI_B * 1e3 / step_ms:.3f} (one process B={MULTI_B}: "
        f"{MULTI_B * 1e3 / serve['step_ms']:.3f}); peak_mem_GiB per rank "
        f"{[round(r['peak'] / 2 ** 30, 2) for r in res]}; spawn to end {wall:.1f} s"
        + ("; time-sliced on one card: no throughput claim" if backend == "gloo" else "")
        + f"; card: {smi}")
    return dict(world=world, backend=backend, step_ms=[r["step_ms"] for r in res],
                frames_per_s=MULTI_B * 1e3 / step_ms, vs_b8_max_lsb=int(d8.max()),
                vs_b8_mean_lsb=float(d8.mean()), counts=res[0]["counts"],
                peak_gib=[r["peak"] / 2 ** 30 for r in res])


def _multi_training(tag: str, backend: str, kind: str, ref_first, smi: str):
    """(b) / (c): one stage's data-parallel steps on two ranks against one
    process over both clips, each step from the same state: the first from
    the seeded start (`ref_first`), the second from the ranks' state after
    the first (saved by rank 0, restored into one process)."""
    import gc
    import shutil
    import tempfile
    import torch
    from pgtformer_tpu_torch import parallel
    from pgtformer_tpu_torch.utils.checkpoint import CheckpointManager
    root = tempfile.mkdtemp(prefix="pgt_multi_")
    try:
        res = parallel.spawn(_multi_train_rank, 2, args=(backend, kind, root),
                             timeout_s=MULTI_TIMEOUT_S)
        tr, state = _multi_trainer(kind)
        CheckpointManager(root).restore(state, tr)
        ref_steps = [ref_first] + _train_steps(tr, state, _multi_batch(kind, slice(0, 2)),
                                               digest=False, steps=MULTI_TRAIN_STEPS - 1)
        del tr, state
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    want = MULTI_TRAIN_PER_STEP[kind]
    for i in range(MULTI_TRAIN_STEPS):
        digests = [r["steps"][i]["digest"] for r in res]
        if len(set(digests)) != 1:
            raise SystemExit(f"[multi:{tag}] step {i + 1}: the ranks' trained tensors differ "
                             f"({digests})")
        for k, r in enumerate(res):
            if r["steps"][i]["counts"] != want:
                raise SystemExit(f"[multi:{tag}] rank {k} step {i + 1} launched "
                                 f"{r['steps'][i]['counts']}, expected {want}")
        ours, ref = res[0]["steps"][i]["metrics"], ref_steps[i]["metrics"]
        if res[1]["steps"][i]["metrics"] != ours:
            raise SystemExit(f"[multi:{tag}] step {i + 1}: the ranks' metrics differ")
        bad = {k: (ours[k], v) for k, v in ref.items()
               if not abs(ours[k] - v) <= MULTI_LOSS_TOL * max(abs(v), 0.1)}
        if bad or ours.keys() != ref.keys():
            raise SystemExit(f"[multi:{tag}] step {i + 1}: losses (ranks, one process) "
                             f"outside {MULTI_LOSS_TOL}: {bad}")
    restart = ""
    if kind == "I":
        rs = [r["restart"] for r in res]
        if len({r["digest"] for r in rs}) != 1 or not all(r["from_rank0"] for r in rs) \
                or not rs[0]["restarted"]:
            raise SystemExit(f"[multi:{tag}] the codebook restart across the ranks: {rs}")
        restart = (f"; the EMA update with restarts (1024 x 512 codebook, {TRAIN_VQ_ROWS} "
                   f"latents a rank): {rs[0]['restarted']} codes restarted, each from rank 0's "
                   f"latents, buffers bit-equal across the ranks OK")
    log(f"[multi:{tag}] stage {kind}, 2 ranks x 1 clip over {backend} on "
        f"{', '.join(r['device'] for r in res)}, 512x512, bf16: after each of "
        f"{MULTI_TRAIN_STEPS} steps parameters, Adam moments, EMA, codebook and BatchNorm "
        f"statistics bit-equal across the ranks (sha256 {[r['steps'][-1]['digest'] for r in res][0]}) OK; "
        f"launches per rank and step {want} (exact); losses within {MULTI_LOSS_TOL} of one "
        f"process x 2 clips OK: "
        + " (each step from the same state: the seeded start, then the ranks' state after "
        "step 1 restored into one process); "
        + "; ".join(f"step {i + 1} " + " ".join(
            f"{k}={res[0]['steps'][i]['metrics'][k]:.5f}/{v:.5f}"
            for k, v in ref_steps[i]["metrics"].items()) for i in range(MULTI_TRAIN_STEPS))
        + f"; step ms per rank {[[round(s['ms'], 2) for s in r['steps']] for r in res]} "
        f"(one process x 2 clips {[round(s['ms'], 2) for s in ref_steps]})"
        + (" time-sliced on one card" if backend == "gloo" else "")
        + f"; peak_mem_GiB per rank {[round(r['peak'] / 2 ** 30, 2) for r in res]}; trainer "
        f"built in {[round(r['built_s'], 1) for r in res]} s{restart}; card: {smi}")
    return dict(backend=backend, digests=[s["digest"] for s in res[0]["steps"]],
                step_ms=[[s["ms"] for s in r["steps"]] for r in res],
                one_process_ms=[s["ms"] for s in ref_steps],
                metrics=[s["metrics"] for s in res[0]["steps"]],
                one_process_metrics=[s["metrics"] for s in ref_steps],
                peak_gib=[r["peak"] / 2 ** 30 for r in res], counts=res[0]["steps"][0]["counts"])


def phase_multi(smi: str, serve: dict, nccl_only: bool = False):
    """Serving and training across ranks (the module docstring, phase 13)."""
    import gc
    import numpy as np
    import torch
    from pgtformer_tpu_torch.config import RELEASE_PGTFORMER
    from pgtformer_tpu_torch.pipeline import VideoRestorer
    t0 = time.perf_counter()
    frames = serve["frames"][:1 + MULTI_CHUNKS * MULTI_B]
    cards = torch.cuda.device_count()
    worlds = sorted({2, cards} - {1}) if cards >= 2 else []
    refs = {}
    for world in ([2] if not nccl_only else []) + worlds:
        bl = MULTI_B // world
        if bl in refs:
            continue
        r = VideoRestorer(None, RELEASE_PGTFORMER, w=1.0, batch_windows=bl,
                          dtype=torch.bfloat16, device="cuda", seed=0)
        r.prime(frames[0])
        refs[bl] = np.concatenate([r.restore_chunk(frames[1 + c * bl:1 + (c + 1) * bl])
                                   .cpu().numpy() for c in range(MULTI_CHUNKS * world)])
        del r
    gc.collect()
    torch.cuda.empty_cache()
    out = {"serve": {}, "train": {}}
    if not nccl_only:
        out["serve"]["gloo_one_card"] = _multi_serving(
            "serve", "gloo", 2, frames, refs[MULTI_B // 2], serve, smi)
    for world in worlds:
        out["serve"][f"nccl_{world}"] = _multi_serving(
            f"serve:nccl{world}", "nccl", world, frames, refs[MULTI_B // world], serve, smi)
    for kind in ("I", "III"):
        tr, state = _multi_trainer(kind)
        ref_first = _train_steps(tr, state, _multi_batch(kind, slice(0, 2)), digest=False,
                                 steps=1)[0]
        del tr, state
        gc.collect()
        torch.cuda.empty_cache()
        if not nccl_only:
            out["train"][f"{kind}:gloo_one_card"] = _multi_training(
                f"train:{kind}", "gloo", kind, ref_first, smi)
        if cards >= 2:
            out["train"][f"{kind}:nccl_2"] = _multi_training(
                f"train:{kind}:nccl", "nccl", kind, ref_first, smi)
    if cards < 2:
        log(f"[multi:nccl] this call has {cards} card: NCCL across cards and any scaling "
            "with the card count are unmeasured on it")
    log(f"[multi] phase in {time.perf_counter() - t0:.1f} s")
    return out


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
    smi = phase_device()
    phase_build()
    k1_rows, k1_err = phase_k1(iters=10)
    k3_rows, k3_err = phase_k3(iters=10)
    k4_rows, k4_err = phase_k4(iters=10)
    mha = phase_mha(iters=10)
    k5 = phase_k5(iters=10)
    k7_rows, k7_err = phase_k7(iters=5)
    k8_rows, k8_err = phase_k8(iters=5)
    grads = phase_train_grad()
    serve = phase_serving()
    variants = phase_variants(serve)
    vae = phase_autoencoder(serve)
    phase_small_model()
    phase_small_vae()
    phase_small_fused_tail()
    serve.pop("restorer")
    torch.cuda.empty_cache()
    train = phase_train(smi)
    torch.cuda.empty_cache()
    train_loop = phase_train_loop(smi)
    torch.cuda.empty_cache()
    ev = phase_eval(smi)
    torch.cuda.empty_cache()
    video = phase_video(smi, serve)
    torch.cuda.empty_cache()
    multi = phase_multi(smi, serve)

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
    # the backward of each kernel, and its launches per training step
    for k in kernels:
        name = k["name"]
        if name in grads:
            k["backward"] = "autograd Function: kernel forward, plain-version backward"
            k["grad"] = {key: v for key, v in grads[name].items() if key != "cases"}
        else:
            k["backward"] = ("none: no gradient (argmin)" if name == "vq_nearest" else
                             "none: inference-only (FUSED_TAIL refuses a recorded gradient)")
        k["launches_per_train_step"] = {stage: r["per_step"].get(name, 0)
                                        for stage, r in train.items()}
        k["launches_train_loop"] = {
            tag: {part: train_loop[tag][f"{part}_launches"].get(name, 0)
                  for part in ("train", "val")} for tag in ("I", "I+resume", "III")}
        k["launches_eval"] = {tag: ev[tag]["launches"].get(name, 0) for tag in ("test", "rotate")}
        k["launches_video"] = {tag: c["counts"].get(name, 0) for tag, c in video["cases"].items()}
        k["launches_video"]["cli"] = video["cli"]["counts"].get(name, 0)
        # per rank, over the sharded serving run and per data-parallel training step
        k["launches_multi"] = {
            **{f"serve:{tag}": c["counts"].get(name, 0) for tag, c in multi["serve"].items()},
            **{f"train:{tag}": c["counts"].get(name, 0) for tag, c in multi["train"].items()}}
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels, "default_step_ms": step,
                      "train": {stage: {key: v for key, v in r.items() if key != "per_step"}
                                for stage, r in train.items()},
                      "train_loop": train_loop,
                      "eval": ev,
                      "video": video,
                      "multi": multi,
                      "variant_step_ms": {k: v["step_ms"] for k, v in variants.items()},
                      "autoencoder_ms": {k: v for k, v in vae.items() if k.endswith("_ms")}}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
