"""Time the kernels K1, K2/K6, K5 and K8 and the serving step of several
source trees on one card, in turns, and compare their restored frames.

Each tree is a checkout of the repo (for example the parent commit unpacked
with ``git archive <commit> | tar -x -C build/parent``).  Every turn runs in
a process of its own that imports that tree's ``pgtformer_tpu_torch``,
builds its kernels into the tree's ``build/kernels`` and measures, on the
same seeded inputs:

* ``dense_mha`` at the code transformer's shape [B=8, N=3072, H=8, D=64] in
  both layouts (K6 ``bnhd`` on views of the packed projections, K2
  ``bhnd``), CUDA events over repeated launches: the best and the median of
  ``--repeats`` runs of ``--iters`` launches;
* K1 ``sw_block`` at the serving step's three layer shapes ([8, 3, 128, 128,
  256], [8, 3, 64, 64, 256], [8, 3, 32, 32, 512]), unshifted and shifted, and
  K5 ``nearest_code`` at the deployed shape (x [24576, 512] against codes
  [1024, 512], fp32) beside ``addmm`` + ``argmin`` on the same operands,
  timed the same way;
* K8 ``subpixel_up_conv3x3`` (without statistics, as ``FUSED_TAIL=up``
  calls it) at the four upsample shapes of the serving step, beside
  ``F.interpolate`` + cuDNN conv on the same operands, timed the same way,
  and its output held to the tree's own plain version (max|d| <= 1e-2 *
  max|plain|, TF32 off);
* the default serving step (RELEASE_PGTFORMER, 512x512, B=8 windows, seeded
  random weights): prime + ``--chunks`` steps, steady ms per step.

Then every tree's uint8 frames are compared with the first tree's (mean and
max absolute difference in LSB), and so are the codes the code transformer
chose (share of tokens whose code differs: a code that flips between two
near-tied logits changes a whole patch of the restored frame).  List a tree twice to see the spread:

    python -m pgtformer_tpu_torch.ab_compare build/parent . . build/parent [--json PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def _time_ms(fn, iters: int, repeats: int):
    import torch
    for _ in range(3):
        fn()
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return min(runs), float(np.median(runs))


K1_SHAPES = [(8, 3, 128, 128, 256), (8, 3, 64, 64, 256), (8, 3, 32, 32, 512)]


def _time_k1_k5(iters: int, repeats: int) -> dict:
    """K1 per layer shape (both shifts) and K5 at the deployed shape, on
    seeded operands: {name: best ms}, medians beside them."""
    import torch
    from pgtformer_tpu_torch.nn.blocks import SWTransformerBlock, init_weights
    from pgtformer_tpu_torch.ops.sw_block import sw_block
    from pgtformer_tpu_torch.ops.vq import nearest_code
    out = {}
    for i, shape in enumerate(K1_SHAPES):
        B, T, H, W, C = shape
        g = torch.Generator().manual_seed(100 + i)
        blk = init_weights(SWTransformerBlock(C, 8, T, (4, 4), (0, 0), mlp_ratio=1.0), g)
        with torch.no_grad():
            for p in blk.parameters():
                if p.dim() == 1:
                    p.add_(torch.randn(p.shape, generator=g) * 0.1)
        w = blk.cuda().kernel_weights(torch.device("cuda"))
        x = torch.randn(shape, generator=torch.Generator(device="cuda").manual_seed(i),
                        device="cuda").to(torch.bfloat16)
        for shift in ((0, 0), (2, 2)):
            key = f"k1_{H}x{W}x{C}_shift{shift[0]}"
            out[f"{key}_ms"], out[f"{key}_median_ms"] = _time_ms(
                lambda: sw_block(x, w, shift), iters, repeats)
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((24576, 512), generator=g, device="cuda")
    codes = torch.randn((1024, 512), generator=g, device="cuda")
    out["k5_ms"], out["k5_median_ms"] = _time_ms(lambda: nearest_code(x, codes), iters, repeats)
    torch.backends.cuda.matmul.allow_tf32 = False
    csq = (codes * codes).sum(-1)
    out["addmm_argmin_ms"], out["addmm_argmin_median_ms"] = _time_ms(
        lambda: torch.addmm(csq, x, codes.T, alpha=-2.0).argmin(-1), iters, repeats)
    return out


K8_SHAPES = [(8, 256, 256, 128), (24, 32, 32, 512), (24, 64, 64, 256), (24, 128, 128, 256)]


def _time_k8(iters: int, repeats: int) -> dict:
    """K8 and interpolate + conv per shape: {name: best ms}, medians and the
    kernel's error against the tree's plain version beside them."""
    import torch
    import torch.nn.functional as F
    from pgtformer_tpu_torch.ops.fused_conv import (
        phase_kernels_2x2, subpixel_up_conv3x3, subpixel_up_conv3x3_plain)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for i, shape in enumerate(K8_SHAPES):
        N, H, W, C = shape
        g = torch.Generator(device="cuda").manual_seed(70 + i)
        x = (torch.randn(shape, generator=g, device="cuda") * 0.7).to(torch.bfloat16)
        k3 = (torch.randn((3, 3, C, C), generator=g, device="cuda") * (9 * C) ** -0.5
              ).to(torch.bfloat16)
        bias = 0.1 * torch.randn((C,), generator=g, device="cuda")
        k2 = phase_kernels_2x2(k3).to(torch.bfloat16)
        key = "k8_" + "x".join(map(str, shape))
        got = subpixel_up_conv3x3(x, k2, bias, emit_stats=False)[0].float()
        ref = subpixel_up_conv3x3_plain(x, k2, bias, emit_stats=False)[0].float()
        err, mag = (got - ref).abs().max().item(), ref.abs().max().item()
        if not err <= 1e-2 * mag:
            raise SystemExit(f"K8 {shape}: max|kernel - plain| {err} > 1e-2 * {mag}")
        out[f"{key}_err"] = err
        del got, ref
        out[f"{key}_ms"], out[f"{key}_median_ms"] = _time_ms(
            lambda: subpixel_up_conv3x3(x, k2, bias, emit_stats=False), iters, repeats)
        w16 = k3.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        b16, xc = bias.to(torch.bfloat16), x.permute(0, 3, 1, 2)
        out[f"{key}_interp_conv_ms"], out[f"{key}_interp_conv_median_ms"] = _time_ms(
            lambda: F.conv2d(F.interpolate(xc, scale_factor=2, mode="nearest"), w16, b16,
                             padding=1), iters, repeats)
    torch.backends.cudnn.allow_tf32 = tf32
    return out


def _worker(frames_path: str, iters: int, repeats: int, chunks: int) -> dict:
    """One turn, inside the tree: the tree's package is first on sys.path."""
    import torch
    import pgtformer_tpu_torch
    from pgtformer_tpu_torch.config import RELEASE_PGTFORMER
    from pgtformer_tpu_torch.ops import _build
    from pgtformer_tpu_torch.ops.dense_mha import dense_mha
    from pgtformer_tpu_torch.pipeline import VideoRestorer

    _build.build()
    out = {"package": str(Path(pgtformer_tpu_torch.__file__).parent)}
    B, H, N, D = 8, 8, 3072, 64
    C = H * D
    g = torch.Generator(device="cuda").manual_seed(7)
    qk = (torch.randn((B, N, 2 * C), generator=g, device="cuda") * 1.5).to(torch.bfloat16)
    vp = torch.randn((B, N, C), generator=g, device="cuda").to(torch.bfloat16)
    split = lambda a: a.reshape(B, N, H, D)
    for layout, view in (("bnhd", split), ("bhnd", lambda a: split(a).transpose(1, 2))):
        q, k, v = view(qk[..., :C]), view(qk[..., C:]), view(vp)
        best, med = _time_ms(lambda: dense_mha(q, k, v, scale=D ** -0.5, layout=layout),
                             iters, repeats)
        out[f"{layout}_ms"], out[f"{layout}_median_ms"] = best, med

    out.update(_time_k1_k5(iters, repeats))
    out.update(_time_k8(iters, repeats))

    Bw = 8
    res = RELEASE_PGTFORMER.vqvae.ddconfig.resolution
    r = VideoRestorer(None, RELEASE_PGTFORMER, w=1.0, batch_windows=Bw,
                      dtype=torch.bfloat16, device="cuda", seed=0)
    frames = np.random.default_rng(0).integers(0, 256, (chunks * Bw + 1, res, res, 3),
                                               dtype=np.uint8)
    codes = []
    decode = r.model._decode_restored

    def record(c, *a, **kw):
        codes.append(c.cpu().numpy())
        return decode(c, *a, **kw)

    r.model._decode_restored = record
    r.prime(frames[0])
    outs = [r.restore_chunk(frames[1:1 + Bw])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in range(1, chunks):
        outs.append(r.restore_chunk(frames[1 + c * Bw:1 + (c + 1) * Bw]))
    torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t0) * 1e3 / (chunks - 1)
    np.savez(frames_path, frames=np.stack([o.cpu().numpy() for o in outs]),
             codes=np.stack(codes))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", help="source trees, measured in this order")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--chunks", type=int, default=5)
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--worker", type=str, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(_worker(args.worker, args.iters, args.repeats, args.chunks)))
        return 0
    if not args.trees:
        ap.error("name at least one tree")

    import torch
    if not torch.cuda.is_available():
        print("ab_compare: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    scratch = Path("build") / "ab"
    scratch.mkdir(parents=True, exist_ok=True)
    turns, frames = [], {}
    for i, tree in enumerate(args.trees):
        root = Path(tree).resolve()
        path = scratch.resolve() / f"turn_{i}.npz"
        # -P: the script's own directory (this package) stays off sys.path,
        # so the tree's package is the one imported
        proc = subprocess.run(
            [sys.executable, "-P", str(Path(__file__).resolve()), "--worker", str(path),
             "--iters", str(args.iters), "--repeats", str(args.repeats),
             "--chunks", str(args.chunks)],
            cwd=root, env={**os.environ, "PYTHONPATH": str(root)}, capture_output=True,
            text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"turn {i} ({tree}) failed with exit {proc.returncode}")
        turn = {"tree": tree, **json.loads(proc.stdout.strip().splitlines()[-1])}
        frames.setdefault(tree, path)
        turns.append(turn)
        print(f"[turn {i}] {tree}: K6 bnhd {turn['bnhd_ms']:.4f} ms (median "
              f"{turn['bnhd_median_ms']:.4f}), K2 bhnd {turn['bhnd_ms']:.4f} ms (median "
              f"{turn['bhnd_median_ms']:.4f}), serving step {turn['step_ms']:.2f} ms", flush=True)
        print(f"[turn {i}] {tree}: K1 "
              + ", ".join(f"{k[3:-3]} {v:.4f}" for k, v in turn.items()
                          if k.startswith("k1_") and not k.endswith("median_ms"))
              + f" ms; K5 {turn['k5_ms']:.4f} ms (median {turn['k5_median_ms']:.4f}), "
              f"addmm+argmin {turn['addmm_argmin_ms']:.4f} ms", flush=True)
        print(f"[turn {i}] {tree}: K8 "
              + ", ".join(f"{list(s)} {turn[f'k8_{k}_ms']:.4f} (median "
                          f"{turn[f'k8_{k}_median_ms']:.4f}, interpolate+conv "
                          f"{turn[f'k8_{k}_interp_conv_ms']:.4f}, max|d| "
                          f"{turn[f'k8_{k}_err']:.3e})"
                          for s in K8_SHAPES for k in ["x".join(map(str, s))])
              + " ms", flush=True)
    first = np.load(frames[args.trees[0]])
    diffs = {}
    for tree, path in frames.items():
        got = np.load(path)
        d = np.abs(got["frames"].astype(np.int16) - first["frames"].astype(np.int16))
        flips = float((got["codes"] != first["codes"]).mean())
        diffs[tree] = {"mean_lsb": float(d.mean()), "max_lsb": int(d.max()),
                       "n_differ": int((d > 0).sum()), "n": int(d.size), "codes_differ": flips}
        print(f"[frames] {tree} vs {args.trees[0]}: mean|d|={d.mean():.4f} LSB, "
              f"max|d|={int(d.max())} LSB, {int((d > 0).sum())} of {d.size} values differ; "
              f"codes differ on {flips:.4%} of tokens")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": smi, "turns": turns, "frames_vs_first": diffs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
