"""Where the serving step's (or a training step's) device time goes.

Builds RELEASE_PGTFORMER with seeded random weights on the card, runs the
serving step (B windows of 512x512 frames) a few times to warm up, then
records `--steps` steps with torch.profiler and prints device time per
kernel group, the device busy share of the wall time, and the top kernels.
Optionally writes the same as JSON (`--json PATH`).  The knob flags and
`--mha-layout` profile the step's other evaluation plans.  `--train I` or
`--train III` profiles the training step of that stage instead, as
`chip_smoke.py` takes it (one seeded 512x512 3-frame clip, bf16 autocast
over fp32 parameters, LPIPS on its random VGG, GAN from step 0, the
kernels' plan: ``use_pallas=True``).  `--code` profiles the code path
instead, in bf16 on the kernels: the ``TDCRQVAE3`` forward and
``TDCRQVAE3.get_codes`` on 2 clips, ``PGTFormer.get_codes`` on `--batch`
clips, each apart, with the same groups (K5's row among them).
``--device cpu`` (with ``--res``) runs any of them on the CPU, where the
times are the host's op times (the plain versions stand in for the
kernels), not a device's.

    python -m pgtformer_tpu_torch.profile_step [--steps 3] [--json out.json] \
        [--sw-kernel 5d|tokens] [--sw-pair 0|1] [--fused-tail 0|up|1] \
        [--mha-layout bnhd|bhnd] [--train I|III | --code] [--device cpu --res 64]
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


def _train_step(stage: str, res: int, device="cuda"):
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
    kw = dict(lpips_fn=make_lpips_fn(device=device), device=device, dtype=torch.bfloat16,
              use_pallas=True)
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


def _code_paths(res: int, clips: int, device):
    """{name: closure} of the code path in bf16 on the kernels' plan:
    the TDCRQVAE3 forward and get_codes on 2 clips, PGTFormer.get_codes on
    `clips` clips (chip_smoke.py:phase_autoencoder's seeds and shapes)."""
    from pgtformer_tpu_torch.config import RELEASE_PGTFORMER
    from pgtformer_tpu_torch.models.pgtformer import PGTFormer
    from pgtformer_tpu_torch.models.vae import TDCRQVAE3
    cfg = RELEASE_PGTFORMER.vqvae
    bf = torch.bfloat16
    vae = TDCRQVAE3(cfg, generator=torch.Generator().manual_seed(1), use_pallas=True)
    vae = vae.to(device=device, dtype=bf).eval()
    pgt = PGTFormer(RELEASE_PGTFORMER, generator=torch.Generator().manual_seed(0),
                    use_pallas=True).to(device=device, dtype=bf).eval()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, cfg.tf, res, res, 3)).astype(np.float32))
    x = x.to(device=device, dtype=bf)
    x8 = torch.from_numpy(rng.uniform(0, 1, (clips, cfg.tf, res, res, 3)).astype(np.float32))
    x8 = x8.to(device=device, dtype=bf)
    return {"vae_forward": lambda: vae(x), "vae_get_codes": lambda: vae.get_codes(x),
            "pgtformer_get_codes": lambda: pgt.get_codes(x8)}


def _profile(run, steps: int, device, grad: bool = False) -> dict:
    """Warm up (on the card), then profile `steps` calls of `run` (under
    inference mode unless `grad`: a training step records its gradient):
    wall ms per call and {kernel: (ms per call, launches per call)} of
    device time (host op time on the CPU)."""
    from torch.profiler import ProfilerActivity, profile
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    mode = torch.enable_grad if grad else torch.inference_mode
    with mode():
        for _ in range(3 if cuda else 0):
            run()
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with mode(), profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = {}
    for ev in prof.key_averages():
        if cuda:
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0.0)
            mine = ev.device_type == torch.autograd.DeviceType.CUDA
        else:
            us, mine = ev.self_cpu_time_total, ev.key.startswith("aten::")
        if us > 0 and mine:
            kernels[ev.key] = (us / 1e3 / steps, ev.count // steps)
    if not kernels:
        raise SystemExit("profiler recorded no device time")
    groups = {}
    for name, (ms, _) in kernels.items():
        g = _group(name)
        groups[g] = groups.get(g, 0.0) + ms
    return dict(wall_ms=wall_ms, busy_ms=sum(groups.values()), groups_ms=groups,
                top=sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15])


def _print(what: str, where: str, plan: str, p: dict, cuda: bool) -> None:
    wall, busy = p["wall_ms"], p["busy_ms"]
    kind = "device" if cuda else "host op"
    print(f"{where}; {what} [{plan}]: wall {wall:.2f} ms/step, "
          f"{kind} busy {busy:.2f} ms/step ({100 * busy / wall:.1f}%), "
          f"idle share {100 * (1 - busy / wall):.1f}%")
    for g, ms in sorted(p["groups_ms"].items(), key=lambda kv: -kv[1]):
        print(f"  {g:20s} {ms:9.3f} ms/step  {100 * ms / busy:5.1f}% of {kind} time")
    for name, (ms, n) in p["top"]:
        print(f"    {ms:8.3f} ms  x{n:<4d} {name[:110]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--mha-layout", type=str, default="bnhd", choices=("bnhd", "bhnd"),
                    help="attention plan of the code transformer")
    ap.add_argument("--train", type=str, default=None, choices=("I", "III"),
                    help="profile this stage's training step instead of serving")
    ap.add_argument("--code", action="store_true",
                    help="profile the code path (TDCRQVAE3 forward and get_codes, "
                         "PGTFormer.get_codes) instead of serving")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda); on the CPU the times are host op times")
    ap.add_argument("--res", type=int, default=None,
                    help="frame size (default: the config's 512; at least 64)")
    knobs.add_cli_flags(ap)
    args = ap.parse_args(argv)
    knobs.apply_cli_args(args)
    if args.device is None and not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    from pgtformer_tpu_torch.config import RELEASE_PGTFORMER

    device = torch.device(args.device or "cuda")
    B = args.batch
    res = args.res or RELEASE_PGTFORMER.vqvae.ddconfig.resolution
    if args.code:
        runs = {name: (run, f"{name.replace('_', ' ')}, "
                            f"{B if name.startswith('pgt') else 2} clips x 3")
                for name, run in _code_paths(res, B, device).items()}
    elif args.train:
        runs = {"train": (_train_step(args.train, res, device),
                          f"training step {args.train}, 1 clip x 3")}
    else:
        from pgtformer_tpu_torch.pipeline import VideoRestorer
        r = VideoRestorer(None, RELEASE_PGTFORMER, batch_windows=B, device=device,
                          mha_layout=args.mha_layout)
        frames = np.random.default_rng(0).integers(0, 256, (B, res, res, 3), dtype=np.uint8)
        r.prime(frames[0])
        runs = {"serve": (lambda: r.restore_chunk(frames), f"serving step B={B}")}
    where = (f"device {torch.cuda.get_device_name(device)}" if device.type == "cuda"
             else "cpu (host op times)")
    plan = (f"SW_KERNEL={knobs.get('SW_KERNEL')} SW_PAIR={knobs.get('SW_PAIR')} "
            f"FUSED_TAIL={knobs.get('FUSED_TAIL')} mha_layout={args.mha_layout}")
    out = {}
    for name, (run, what) in runs.items():
        out[name] = p = _profile(run, args.steps, device, grad=name == "train")
        _print(f"{what} {res}x{res}", where, plan, p, device.type == "cuda")
    if args.json:
        rec = {name: {"wall_ms": p["wall_ms"], "busy_ms": p["busy_ms"],
                      "groups_ms": p["groups_ms"],
                      "top": [[n, ms, c] for n, (ms, c) in p["top"]]}
               for name, p in out.items()}
        if len(rec) == 1:
            rec = next(iter(rec.values()))
        with open(args.json, "w") as f:
            json.dump({"device": where, "batch": B, "res": res, "plan": plan, **rec}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
