"""Where the serving step's (or a training step's) device time goes.

Builds RELEASE_PGTFORMER with seeded random weights on the card, runs the
serving step (B windows of 512x512 frames) a few times to warm up, then
records `--steps` steps with torch.profiler and prints device time per
kernel group, the device busy share of the wall time, and the top kernels.
Optionally writes the same as JSON (`--json PATH`).  The knob flags and
`--mha-layout` profile the step's other evaluation plans.  `--train I` or
`--train III` profiles the training step of that stage instead, as
`chip_smoke.py` takes it (one seeded 512x512 3-frame clip, bf16 autocast
over fp32 parameters, LPIPS on its random VGG, GAN from step 0).

    python -m pgtformer_tpu_torch.profile_step [--steps 3] [--json out.json] \
        [--sw-kernel 5d|tokens] [--sw-pair 0|1] [--fused-tail 0|up|1] \
        [--mha-layout bnhd|bhnd] [--train I|III]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from pgtformer_tpu_torch import knobs

GROUPS = (("sw_block_pair (K4)", ("sw_block_pair_kernel",)),
          ("sw_block_tokens (K3)", ("sw_block_tokens_kernel",)),
          ("sw_block (K1)", ("sw_block_kernel",)),
          ("dense_mha (K2/K6)", ("dense_mha_kernel",)),
          ("vq_nearest (K5)", ("vq_nearest_kernel", "code_sqnorm_kernel")),
          ("gn_silu_conv3x3 (K7)", ("gn_silu_conv3x3_kernel",)),
          ("subpixel_up_conv3x3 (K8)", ("subpixel_up_conv3x3_kernel",)),
          ("conv (cuDNN)", ("conv", "cudnn", "implicit", "winograd", "fprop", "dgrad")),
          ("gemm", ("gemm", "cutlass", "cublas")),
          ("norm", ("norm",)),
          ("copy/layout", ("copy", "transpose", "cat", "index", "gather", "elementwise_kernel_with_index")),
          )


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "elementwise/other"


def _train_step(stage: str, res: int):
    """A closure taking one training step of `stage` as chip_smoke.py's
    phase_train does (same seeds)."""
    import dataclasses

    from pgtformer_tpu_torch.config import RELEASE_PGTFORMER
    from pgtformer_tpu_torch.models.vae import TDCRQVAE3
    from pgtformer_tpu_torch.train.lpips import make_lpips_fn
    from pgtformer_tpu_torch.train.stages import STAGE_HYPERS, PGTFormerTrainer, Stage1Trainer
    rng = np.random.default_rng(5)
    gt = rng.integers(0, 256, (1, 3, res, res, 3), dtype=np.uint8)
    lq = np.clip(gt.astype(np.int16) + rng.integers(-24, 25, gt.shape), 0, 255).astype(np.uint8)
    hp = dataclasses.replace(STAGE_HYPERS[stage], warmup_iter=-1)
    kw = dict(lpips_fn=make_lpips_fn(device="cuda"), device="cuda", dtype=torch.bfloat16)
    if stage == "I":
        tr = Stage1Trainer(RELEASE_PGTFORMER.vqvae, hp, **kw)
        state, batch = tr.init_state(torch.Generator().manual_seed(11)), gt
    else:
        teacher = TDCRQVAE3(RELEASE_PGTFORMER.vqvae, generator=torch.Generator().manual_seed(12))
        tr = PGTFormerTrainer(RELEASE_PGTFORMER, stage, hp, **kw)
        state = tr.init_state(torch.Generator().manual_seed(13), teacher.state_dict())
        batch = {"lq": lq, "gt": gt}
    step, box = tr.make_step(), [state]

    def run():
        box[0], _ = step(box[0], batch)
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--mha-layout", type=str, default="bnhd", choices=("bnhd", "bhnd"),
                    help="attention plan of the code transformer")
    ap.add_argument("--train", type=str, default=None, choices=("I", "III"),
                    help="profile this stage's training step instead of serving")
    knobs.add_cli_flags(ap)
    args = ap.parse_args(argv)
    knobs.apply_cli_args(args)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from pgtformer_tpu_torch.config import RELEASE_PGTFORMER

    B = args.batch
    res = RELEASE_PGTFORMER.vqvae.ddconfig.resolution
    if args.train:
        run, what = _train_step(args.train, res), f"training step {args.train}, 1 clip x 3"
    else:
        from pgtformer_tpu_torch.pipeline import VideoRestorer
        r = VideoRestorer(None, RELEASE_PGTFORMER, batch_windows=B, device="cuda",
                          mha_layout=args.mha_layout)
        frames = np.random.default_rng(0).integers(0, 256, (B, res, res, 3), dtype=np.uint8)
        r.prime(frames[0])
        run, what = (lambda: r.restore_chunk(frames)), f"serving step B={B}"
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = (dev_us / 1e3 / args.steps, ev.count // args.steps)
    if not kernels:
        raise SystemExit("profiler recorded no device time")
    groups = {}
    for name, (ms, _) in kernels.items():
        g = _group(name)
        groups[g] = groups.get(g, 0.0) + ms
    busy = sum(groups.values())
    smi = torch.cuda.get_device_name(0)
    plan = (f"SW_KERNEL={knobs.get('SW_KERNEL')} SW_PAIR={knobs.get('SW_PAIR')} "
            f"FUSED_TAIL={knobs.get('FUSED_TAIL')} mha_layout={args.mha_layout}")
    print(f"device {smi}; {what} {res}x{res} [{plan}]: wall {wall_ms:.2f} ms/step, "
          f"device busy {busy:.2f} ms/step ({100 * busy / wall_ms:.1f}%), "
          f"idle share {100 * (1 - busy / wall_ms):.1f}%")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g:20s} {ms:9.3f} ms/step  {100 * ms / busy:5.1f}% of device time")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (ms, n) in top:
        print(f"    {ms:8.3f} ms  x{n:<4d} {name[:110]}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": smi, "batch": B, "plan": plan, "wall_ms": wall_ms, "busy_ms": busy,
                       "groups_ms": groups,
                       "top": [[n, ms, c] for n, (ms, c) in top]}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
