"""Training CLI — the `python basicsr/train.py -opt <yml>` analog (the
port's counterpart of the JAX package's ``train_cli.py``).

Reads a reference-style option YAML (the files under ``configs/`` load
unmodified) and builds the stage trainer, dataset, loader, validation and
loop:

    python -m pgtformer_tpu_torch.train_cli -opt configs/demo_stage_I.yml \\
        --data-root /data/vfhq --exp-dir exp/stage1 --bf16 [--stage I]

It trains on the card unless ``--device`` names another device (the CUDA
kernels take bf16, so the card needs ``--bf16``).  Checkpoints, exports,
``metrics.jsonl``, ``timings.jsonl``, TensorBoard events and validation
images land in ``--exp-dir`` (``utils/checkpoint.py`` gives the layout); a
run whose directory holds a checkpoint resumes from it, inside the epoch
where it stopped.  Stage II–IV runs chain through the exports:
``--teacher-ckpt``/``--student-ckpt`` take a previous stage's
``net_g_<step>.pth``, ``--disc-ckpt`` its ``net_d_<step>.pth``.

``--devices N`` trains data-parallel over min(N, cards) cards, as the JAX
package's CLI does over its devices: the global batch is N times the
per-device batch, and the CLI spawns one process per card itself
(``parallel.spawn``; NCCL, each rank on ``cuda:<rank>``).  Under
``--device cpu`` it spawns N ranks on the CPU over gloo.  Each rank's loader
assembles only its rows of each global batch, and rank 0 alone writes the
experiment directory (``train/trainer.py``).

Differences from the JAX package's CLI:

  * There is no ``--pallas``: on a CUDA tensor the kernels always run.
  * ``--devices`` counts processes (one per card), not the devices of one
    controller, and defaults to 1 (the JAX CLI takes every device).
  * Resuming stage II–IV needs ``--teacher-ckpt``: the frozen teacher is no
    part of the training state (in either package), and the JAX package's
    resume builds only an abstract teacher that no step can run.
  * On resume ``--student-ckpt`` and ``--disc-ckpt`` are not applied (the
    checkpoint holds both networks), and the loader starts inside the
    epoch where the restored state saved it (``Trainer.fit``); a resume
    with another batch size or dataset, which would place the step
    elsewhere, is refused.
  * The YAML's ``logger: use_tb_logger: false`` turns TensorBoard off, and
    its ``network_d`` block's ``nc``/``ndf``/``n_layers`` size the
    discriminator.
"""

from __future__ import annotations

import argparse
import os
import re
import sys


def detect_stage(opt: dict, options_path: str) -> str:
    """Resolve the training stage (I/II/III/IV).

    Precedence: an explicit `stage:` key in the options -> the filename's
    `stage_<I+>` run length (longest match, so the reference's
    `..._stage_IIII_dont_need_align_version.yml` resolves to IV, not III)
    -> the `model_type`/`code_only` convention (TRQVAEModel = I,
    TRQCodeFormerModel + code_only = II).  Raises rather than guessing:
    silently training the wrong stage recipe is worse than asking for
    --stage.
    """
    s = str(opt.get("stage", "")).upper()
    roman = {"I": "I", "II": "II", "III": "III", "IV": "IV", "IIII": "IV",
             "1": "I", "2": "II", "3": "III", "4": "IV"}
    if s:
        if s not in roman:
            raise SystemExit(f"options key stage: {s!r} is not a stage "
                             "(expected I/II/III/IV)")
        return roman[s]
    # match the FILENAME only — a stage-named directory component
    # (exp/stage_II_sweeps/...) must not override it
    m = re.search(r"stage_(IV|I+)(?![IV])", os.path.basename(options_path))
    if m and m.group(1) in roman:
        return roman[m.group(1)]
    mt = str(opt.get("model_type", ""))
    if mt == "TRQVAEModel":
        return "I"
    if mt == "TRQCodeFormerModel" and opt.get("code_only"):
        return "II"
    raise SystemExit(
        f"cannot infer training stage from {options_path!r} (no `stage:` "
        "key, no stage_<N> filename pattern, ambiguous model_type) — "
        "pass --stage I/II/III/IV")


def build_from_options(opt: dict, stage: str, data_root: str = None,
                       lpips_fn=None, dtype=None, device=None, group=None):
    """(stage trainer, StageHyper) from an option tree: the YAML's `train:`
    subtree overrides the stage's defaults, and its loss blocks pick the
    loss recipe.  Unlike the JAX package, the `network_d` block's `nc`,
    `ndf` and `n_layers` size the discriminator (the reference builds it
    from that block; every YAML in configs/ names only its type).  `group`:
    the ranks of a data-parallel run."""
    import torch
    from pgtformer_tpu_torch.config import (
        pgtformer_config_from_options, vqvae_config_from_options)
    from pgtformer_tpu_torch.models.vqgan import VQGANDiscriminator
    from pgtformer_tpu_torch.train.stages import (
        STAGE_HYPERS, PGTFormerTrainer, Stage1Trainer, StageHyper)

    tr = opt.get("train", {})
    base = STAGE_HYPERS[stage]
    over = {
        "lr_g": float(tr.get("optim_g", {}).get("lr", base.lr_g)),
        "lr_d": float(tr.get("optim_d", {}).get("lr", base.lr_d)),
        "milestones": tuple(int(m) for m in
                            tr.get("scheduler", {}).get("milestones",
                                                        base.milestones)),
        "gamma": float(tr.get("scheduler", {}).get("gamma", base.gamma)),
        "warmup_iter": int(tr.get("warmup_iter", base.warmup_iter)),
        "total_iter": int(tr.get("total_iter", base.total_iter)),
        "ema_decay": float(tr.get("ema_decay", base.ema_decay)),
        "gan_start_iter": int(tr.get("gan_start_iter", base.gan_start_iter)),
        "gan_weight": float(tr.get("gan_opt", {}).get("loss_weight",
                                                      base.gan_weight)),
    }
    # the YAML loss blocks drive the loss recipe directly (the reference's
    # build_loss of each *_opt subtree; per-stage blocks differ — e.g. feat
    # is MSELoss in stages II/III but L1Loss in IV)
    _loss_types = {"CrossEntropyLoss": "ce", "FocalLoss": "focal",
                   "MSELoss": "mse", "L1Loss": "l1",
                   "GRADL1Loss": "gradl1", "LPIPSLoss": "lpips",
                   "TemporalLPIPSLoss": "temporal_lpips"}

    def _loss(key, kind_field, weight_field, absent_kind):
        blk = tr.get(key)
        if blk is None:
            if key in ("pixel_opt", "perceptual_opt"):
                over[kind_field] = absent_kind
            return
        over[kind_field] = _loss_types.get(str(blk.get("type")),
                                           getattr(base, kind_field))
        if weight_field and "loss_weight" in blk:
            over[weight_field] = float(blk["loss_weight"])
        if key == "pixel_opt" and "lossmulti" in blk:
            over["lossmulti"] = tuple(float(x) for x in blk["lossmulti"])
        if key == "perceptual_opt" and "tgrad_weight" in blk:
            over["tgrad_weight"] = float(blk["tgrad_weight"])

    if stage != "I":
        _loss("token_opt", "token_loss", "token_weight", "ce")
        _loss("feat_opt", "feat_loss", "feat_weight", "mse")
    _loss("pixel_opt", "pixel_loss", "pixel_weight", "none")
    _loss("perceptual_opt", "perceptual", None, "none")
    if "gan_opt" in tr or "use_gan" in tr:
        over["use_gan"] = bool(tr.get("use_gan", tr.get("gan_opt")))
    hp = StageHyper(**{**base.__dict__, **over})

    dtype = dtype if dtype is not None else torch.float32
    disc_kw = {k: int(v) for k, v in (opt.get("network_d") or {}).items()
               if k in ("nc", "ndf", "n_layers")}
    disc = VQGANDiscriminator(**disc_kw) if disc_kw else None
    if stage == "I":
        cfg = vqvae_config_from_options(opt, network_key="network_g")
        trainer = Stage1Trainer(cfg, hp, lpips_fn=lpips_fn, device=device, dtype=dtype,
                                disc=disc, group=group)
    else:
        cfg = pgtformer_config_from_options(opt, network_key="network_g")
        trainer = PGTFormerTrainer(cfg, stage=stage, hp=hp, lpips_fn=lpips_fn,
                                   device=device, dtype=dtype, disc=disc, group=group)
    return trainer, hp


def _parse(argv):
    parser = argparse.ArgumentParser(description="pgtformer_tpu_torch trainer")
    parser.add_argument("-opt", "--options", required=True,
                        help="reference-style option YAML")
    parser.add_argument("--data-root", required=True,
                        help="VFHQ dataset root (see data/vfhq.py layout)")
    parser.add_argument("--exp-dir", default=None)
    parser.add_argument("--stage", default=None,
                        choices=["I", "II", "III", "IV"],
                        help="override stage detection from the YAML name")
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--teacher-ckpt", default=None,
                        help="stage II+: frozen teacher (`network_gt`), a "
                             "reference-format .pth such as a stage-I run's "
                             "net_g_<step>.pth")
    parser.add_argument("--student-ckpt", default=None,
                        help="stage II+: initialize the student from a "
                             "previous stage's net_g_<step>.pth (non-strict "
                             "merge, the reference's `pretrain_network_g` + "
                             "`strict_load_g: false` chain: I->II->III->IV)")
    parser.add_argument("--disc-ckpt", default=None,
                        help="initialize the discriminator from a previous "
                             "stage's net_d_<step>.pth (the reference's "
                             "`pretrain_network_d` + `strict_load_d: true`)")
    parser.add_argument("--no-lpips", action="store_true")
    parser.add_argument("--lpips-weights", default=None,
                        help="lpips.LPIPS(net='vgg') state_dict (.pth) for "
                             "metric-grade perceptual loss; without it the "
                             "VGG runs randomly initialized (loud warning)")
    parser.add_argument("--total-iter", type=int, default=None,
                        help="override the YAML's total_iter (smoke runs)")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute under autocast over fp32 "
                             "parameters (needed on the card)")
    parser.add_argument("--val-data-root", default=None,
                        help="VFHQ val split root; enables the periodic "
                             "val loop (PSNR/SSIM + saved images)")
    parser.add_argument("--val-samples", type=int, default=8)
    parser.add_argument("--devices", type=int, default=None,
                        help="train data-parallel on the first N cards (at "
                             "most the cards present; default 1), one "
                             "process each; with --device cpu, N ranks on "
                             "the CPU")
    parser.add_argument("--num-workers", type=int, default=None,
                        help="loader workers (default: YAML "
                             "num_worker_per_gpu); 0 = synchronous")
    parser.add_argument("--prefetch", type=int, default=2,
                        help="batches kept in flight ahead of the consumer")
    parser.add_argument("--batch-dtype", default="uint8",
                        choices=["uint8", "float32"],
                        help="host->device batch dtype: uint8 ships 4x fewer "
                             "bytes and dequantizes on the device (default)")
    parser.add_argument("--upload-prefetch", type=int, default=2,
                        help="batches uploaded ahead of the train step on a "
                             "transfer thread (0 = synchronous upload)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; fails without a card)")
    from pgtformer_tpu_torch import knobs
    knobs.add_cli_flags(parser)
    args = parser.parse_args(argv)
    knobs.apply_cli_args(args)
    return parser, args


def main(argv=None):
    parser, args = _parse(argv)
    n_dev = _world(args)
    if n_dev > 1:
        # one process per device; each parses `argv` again and joins the group
        import torch
        from pgtformer_tpu_torch.parallel import spawn
        argv = list(argv) if argv is not None else sys.argv[1:]
        try:
            results = spawn(_rank_main, n_dev, args=(argv, torch.get_num_threads()))
        except RuntimeError as e:
            raise SystemExit(f"data-parallel training on {n_dev} ranks failed: {e}") from None
        return max(results)
    return _train(args, parser, None)


def _world(args) -> int:
    """Ranks of the run: `--devices`, at most the cards present on the card
    (as the JAX CLI takes at most the devices present), as asked on the
    CPU."""
    if args.devices is None:
        return 1
    if args.devices < 1:
        raise SystemExit(f"--devices {args.devices}: at least 1")
    if args.device is not None and not str(args.device).startswith("cuda"):
        return args.devices
    import torch
    return max(1, min(args.devices, torch.cuda.device_count()))


RANK_TIMEOUT_S = 1800.0   # a collective or barrier waits this long for the other ranks


def _rank_main(rank: int, world: int, store: str, argv, threads: int) -> int:
    """One rank of `main`'s run; on the CPU the ranks share the parent's
    torch threads."""
    from pgtformer_tpu_torch import parallel
    parser, args = _parse(argv)
    import torch
    cpu = args.device is not None and not str(args.device).startswith("cuda")
    if cpu:
        torch.set_num_threads(max(1, threads // world))
    group = parallel.init_group(rank, world, store, device="cpu" if cpu else f"cuda:{rank}",
                                timeout_s=RANK_TIMEOUT_S)
    try:
        return _train(args, parser, group)
    finally:
        parallel.destroy_group()


def _train(args, parser, group) -> int:
    import torch
    from pgtformer_tpu_torch import resolve_device
    from pgtformer_tpu_torch.config import load_options
    from pgtformer_tpu_torch.data.loader import PrefetchLoader, device_prefetch, upload_fn
    from pgtformer_tpu_torch.data.vfhq import VFHQTrainDataset
    from pgtformer_tpu_torch.models.vae import TDCRQVAE3
    from pgtformer_tpu_torch.nn.blocks import init_weights
    from pgtformer_tpu_torch.train.lpips import make_lpips_fn
    from pgtformer_tpu_torch.train.trainer import Trainer, epoch_repeat
    from pgtformer_tpu_torch.utils.checkpoint import (
        CheckpointManager, merge_pretrained, read_export)
    from pgtformer_tpu_torch.utils.logging import get_root_logger

    device = group.device if group is not None else resolve_device(args.device)
    if device.type == "cuda" and not args.bf16:
        parser.error("training on the card needs --bf16: the CUDA kernels take bf16")
    world, rank = (group.world, group.rank) if group is not None else (1, 0)
    logger = get_root_logger()
    if rank:
        logger.setLevel("WARNING")      # rank 0 reports
    opt = load_options(args.options)
    stage = args.stage or detect_stage(opt, args.options)
    exp_dir = args.exp_dir or f"exp/{opt.get('name', 'run')}"
    seed = int(opt.get("manual_seed", 0))

    lpips_fn = None if args.no_lpips else make_lpips_fn(
        weights_path=args.lpips_weights, device=device)
    trainer, hp = build_from_options(
        opt, stage, args.data_root, lpips_fn=lpips_fn,
        dtype=torch.bfloat16 if args.bf16 else torch.float32, device=device, group=group)

    ds_opt = opt.get("datasets", {}).get("train", {})
    batch = (args.batch_size or int(ds_opt.get("batch_size_per_gpu", 1))) * world
    dataset = VFHQTrainDataset(
        args.data_root, r=int(ds_opt.get("r", 1)),
        is_aligned=bool(ds_opt.get("is_aligned", False)),
        degradation=str(ds_opt.get("degradation", "blr")),
        use_hflip=bool(ds_opt.get("use_hflip", True)),
        output_dtype=args.batch_dtype)
    num_workers = (args.num_workers if args.num_workers is not None
                   else int(ds_opt.get("num_worker_per_gpu", 4)))
    loader = PrefetchLoader(
        dataset, batch, shuffle=True, seed=seed,
        num_workers=num_workers, prefetch=args.prefetch,
        backend="sync" if num_workers == 0 else "thread",
        keys=("gt",) if stage == "I" else ("gt", "lq"),
        reseed_dataset=True, shard=(rank, world) if group is not None else None)
    if len(loader) == 0:
        raise SystemExit(f"{args.data_root}: {len(dataset)} samples, fewer than one batch "
                         f"of {batch}")

    # Trainer.fit restores the newest state and starts the loader where it
    # was saved; here the resume only decides which weights to build from
    resuming = CheckpointManager(exp_dir).latest_step() is not None

    # build the state; a resumed run then loads the checkpoint over it
    gen = torch.Generator().manual_seed(seed)
    disc_sd = None
    if args.disc_ckpt and not resuming and trainer.disc is not None:
        # reference `pretrain_network_d` + `strict_load_d: true`
        disc_sd = read_export(args.disc_ckpt)
        logger.info(f"discriminator initialized from {args.disc_ckpt} (strict_load_d)")
    if stage == "I":
        state = trainer.init_state(gen, disc_state_dict=disc_sd)
    else:
        if args.teacher_ckpt:
            teacher_sd = read_export(args.teacher_ckpt)
        elif resuming:
            raise SystemExit(f"resuming stage {stage} needs --teacher-ckpt: the frozen "
                             "teacher is not part of the training state")
        else:
            print(f"WARNING: stage {stage} without --teacher-ckpt: random teacher",
                  file=sys.stderr)
            teacher_sd = TDCRQVAE3(trainer.cfg.vqvae,
                                   generator=torch.Generator().manual_seed(7)).state_dict()
        student_sd = None
        if args.student_ckpt and not resuming:
            # reference `pretrain_network_g` + `strict_load_g: false`: init
            # the whole student, then overlay every pretrained tensor whose
            # key and shape match
            init_weights(trainer.model, torch.Generator().manual_seed(11))
            student_sd, n_loaded, skipped = merge_pretrained(
                trainer.model.state_dict(), read_export(args.student_ckpt))
            logger.info(f"student init: {n_loaded} tensors loaded from "
                        f"{args.student_ckpt}, {len(skipped)} pretrained tensors "
                        "without a destination (strict_load_g: false)")
        state = trainer.init_state(gen, teacher_sd, student_sd, disc_sd)

    def host_batches():
        for b in loader:
            if stage == "I":
                yield b["gt"]
            else:
                yield {"lq": b["lq"], "gt": b["gt"]}

    if args.upload_prefetch > 0:
        put = upload_fn(device)

        def iter_batches():
            # uploads run `upload_prefetch` batches ahead on a transfer
            # thread, overlapping host->device bytes with device compute
            yield from device_prefetch(host_batches(), put,
                                       depth=args.upload_prefetch)
    else:
        put = upload_fn(device, stream=False)

        def iter_batches():
            for b in host_batches():
                yield put(b)

    val_fn = None
    if args.val_data_root:
        from pgtformer_tpu_torch.data.vfhq import VFHQTestDataset
        from pgtformer_tpu_torch.train.validate import make_val_fn
        val_opt = opt.get("datasets", {}).get("val", {})
        val_ds = VFHQTestDataset(
            args.val_data_root, r=int(val_opt.get("r", ds_opt.get("r", 1))),
            is_aligned=bool(val_opt.get("is_aligned",
                                        ds_opt.get("is_aligned", False))),
            degradation=str(val_opt.get("degradation",
                                        ds_opt.get("degradation", "blr"))),
            inter_space=int(val_opt.get("inter_space", 1)))
        val_fn = make_val_fn(trainer, val_ds, stage,
                             max_samples=args.val_samples,
                             save_dir=f"{exp_dir}/visualization",
                             # stage II's config leaves w at the arch
                             # default 0: validating through w>0 would
                             # inject the untrained fuse blocks
                             w=float(getattr(trainer.cfg, "w", 1.0)))

    log_opt = opt.get("logger", {})
    loop = Trainer(trainer, exp_dir,
                   print_freq=int(log_opt.get("print_freq", 100)),
                   save_checkpoint_freq=int(float(log_opt.get("save_checkpoint_freq", 1e4))),
                   val_freq=int(float(opt.get("val", {}).get("val_freq", 2e4))),
                   use_tb_logger=bool(log_opt.get("use_tb_logger", True)),
                   loader=loader, group=group)
    batches = epoch_repeat(iter_batches)
    try:
        loop.fit(state, batches, total_iter=args.total_iter or hp.total_iter, val_fn=val_fn)
    finally:
        batches.close()
        loop.tb.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
