"""The training step under the two plans of ``use_pallas``: the towers on
the module path (JAX's "XLA towers": plain PyTorch, ``use_pallas=False``)
against the towers on the hand-written kernels ("Pallas towers": K1 and K6,
whose backward recomputes the module math).  The counterpart of the JAX
package's ``tools/bench_train_step.py``.

    python -m pgtformer_tpu_torch.bench_train_step [--res 512] [--batch 1] \\
        [--iters 6] [--mode xla|pallas|both] [--stage I|III] \\
        [--dtype bf16|fp32] [--device cuda] [--json out.json]

RELEASE_PGTFORMER's stage-I autoencoder (or stage III's PGTFormer with a
seeded teacher), seeded weights, one seeded clip of `--batch` x 3 frames at
`--res`, no LPIPS and the GAN from step 0, as the JAX tool takes it.  Per
mode: one warm-up step, then two rounds of `--iters` steps, and the best
round's mean step time (CUDA events on the card, the host clock on the CPU),
the peak device memory and the launches of every kernel per step.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time

import numpy as np
import torch

MODES = {"xla": False, "pallas": True}
NAMES = {False: "XLA towers: module path", True: "Pallas towers: kernels"}
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _wrappers():
    from pgtformer_tpu_torch.ops.dense_mha import dense_mha_bhnd, dense_mha_bnhd
    from pgtformer_tpu_torch.ops.fused_conv import gn_silu_conv3x3, subpixel_up_conv3x3
    from pgtformer_tpu_torch.ops.sw_block import sw_block, sw_block_pair, sw_block_tokens
    from pgtformer_tpu_torch.ops.vq import nearest_code
    return {"sw_block": sw_block, "sw_block_tokens": sw_block_tokens,
            "sw_block_pair": sw_block_pair, "dense_mha_bhnd": dense_mha_bhnd,
            "dense_mha_bnhd": dense_mha_bnhd, "vq_nearest": nearest_code,
            "gn_silu_conv3x3": gn_silu_conv3x3, "subpixel_up_conv3x3": subpixel_up_conv3x3}


def build(stage: str, use_pallas: bool, dtype, device, res: int, batch: int):
    """(trainer, state, batch) of `stage`, seeded."""
    from pgtformer_tpu_torch.config import RELEASE_PGTFORMER
    from pgtformer_tpu_torch.models.vae import TDCRQVAE3
    from pgtformer_tpu_torch.train.stages import STAGE_HYPERS, PGTFormerTrainer, Stage1Trainer
    hp = dataclasses.replace(STAGE_HYPERS[stage], milestones=(10 ** 9,), warmup_iter=-1,
                             total_iter=10 ** 9, gan_start_iter=0)
    kw = dict(lpips_fn=None, device=device, dtype=dtype, use_pallas=use_pallas)
    rng = np.random.default_rng(0)
    gt = torch.from_numpy(rng.uniform(0, 1, (batch, 3, res, res, 3)).astype(np.float32))
    if stage == "I":
        tr = Stage1Trainer(RELEASE_PGTFORMER.vqvae, hp, **kw)
        return tr, tr.init_state(torch.Generator().manual_seed(0)), gt
    teacher = TDCRQVAE3(RELEASE_PGTFORMER.vqvae, generator=torch.Generator().manual_seed(1))
    tr = PGTFormerTrainer(RELEASE_PGTFORMER, stage, hp, **kw)
    state = tr.init_state(torch.Generator().manual_seed(0), teacher.state_dict())
    lq = torch.clamp(gt + torch.from_numpy(rng.normal(0, 0.05, gt.shape).astype(np.float32)), 0, 1)
    return tr, state, {"lq": lq, "gt": gt}


def set_plan(tr, use_pallas: bool, dtype) -> None:
    """Switch a built trainer and its model in place to the plan `use_pallas`
    and the compute dtype `dtype` (the weights stay; a stage II-IV teacher
    keeps the module path)."""
    tr.use_pallas, tr.dtype = use_pallas, dtype
    for m in tr.model.modules():
        if hasattr(m, "use_pallas"):
            m.use_pallas = use_pallas


def bench(tr, state, data, iters: int, rounds: int = 2):
    """The trainer's step on `data`: one warm-up step, then `rounds` rounds
    of `iters` steps.  Returns (state, {step_ms: the best round's mean,
    launches_per_step: exact launches of every kernel per step, peak_bytes
    (None on the CPU), losses: the last step's metrics})."""
    device = tr.device
    cuda = device.type == "cuda"
    step = tr.make_step()
    wrappers = _wrappers()

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    state, metrics = step(state, data)          # warm-up (cuDNN plans, kernel loads)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    for fn in wrappers.values():
        fn.launches = 0
    best = float("inf")
    for _ in range(rounds):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            state, metrics = step(state, data)
        if cuda:
            end.record()
            sync()
            ms = start.elapsed_time(end) / iters
        else:
            ms = (time.perf_counter() - t0) * 1e3 / iters
        best = min(best, ms)
    launches = {}
    for name, fn in wrappers.items():
        if fn.launches % (rounds * iters):
            raise RuntimeError(f"{name}: {fn.launches} launches in {rounds * iters} steps")
        if fn.launches:
            launches[name] = fn.launches // (rounds * iters)
    losses = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in losses.values()):
        raise RuntimeError(f"non-finite metrics {losses}")
    return state, dict(step_ms=best, launches_per_step=launches,
                       peak_bytes=torch.cuda.max_memory_allocated(device) if cuda else None,
                       losses=losses)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--mode", choices=["xla", "pallas", "both"], default="both",
                    help="xla: use_pallas=False (the module path); pallas: the kernels")
    ap.add_argument("--stage", choices=["I", "III"], default="I")
    ap.add_argument("--dtype", choices=list(DTYPES), default="bf16")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda; fails without a card)")
    ap.add_argument("--json", type=str, default=None)
    args = ap.parse_args(argv)

    from pgtformer_tpu_torch import resolve_device
    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        what = torch.cuda.get_device_name(device)
    else:
        what = "cpu"
    modes = ["xla", "pallas"] if args.mode == "both" else [args.mode]
    recs = []
    for mode in modes:
        tr, state, data = build(args.stage, MODES[mode], dtype, device, args.res, args.batch)
        _, r = bench(tr, state, data, args.iters)
        r = dict(stage=args.stage, pallas=MODES[mode], dtype=str(dtype).replace("torch.", ""),
                 res=args.res, batch=args.batch, iters=args.iters, **r)
        del tr, state, data
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        peak = "" if r["peak_bytes"] is None else f", peak {r['peak_bytes'] / 2 ** 30:.2f} GiB"
        print(f"stage-{args.stage} step ({NAMES[r['pallas']]}) {args.dtype} on {what}: "
              f"{r['step_ms']:.1f} ms (best of 2 rounds of {args.iters}){peak}, "
              f"launches/step {r['launches_per_step']}", flush=True)
        recs.append(r)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": what, "runs": recs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
