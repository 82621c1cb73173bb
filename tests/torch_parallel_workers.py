"""Rank functions of tests/test_torch_parallel.py, run by
``pgtformer_tpu_torch.parallel.spawn`` in processes of their own.

A spawned process imports this module afresh, so it imports no JAX (and
nothing of the JAX package): the tests pass it numpy weights and configs.
Each function runs torch on one thread, joins a gloo group on the CPU
through the file store it is given, and returns numpy arrays or plain
values."""

from __future__ import annotations

import numpy as np
import torch

from pgtformer_tpu_torch import parallel as P

TIMEOUT_S = 120.0


def _join(rank, world, store):
    torch.set_num_threads(1)
    return P.init_group(rank, world, store, device="cpu", timeout_s=TIMEOUT_S)


def serve(rank, world, store, kw, device="cpu"):
    """VideoRestorer(group=) over `kw`'s frames (:func:`_serve`); with a
    CUDA `device` every rank computes on cuda:0 over gloo."""
    if device == "cpu":
        g = _join(rank, world, store)
    else:
        g = P.init_group(rank, world, store, device="cuda:0", backend="gloo",
                         share_device=True, timeout_s=TIMEOUT_S)
    try:
        return _serve(g, **kw)
    finally:
        P.destroy_group()


def _digest(tensors) -> str:
    """A digest of every tensor's bytes, in name order: two ranks that print
    the same one hold the same bits."""
    import hashlib
    h = hashlib.sha256()
    for name in sorted(tensors):
        h.update(name.encode())
        h.update(tensors[name].detach().cpu().reshape(-1).contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def trainer_tensors(tr, state) -> dict:
    """Every tensor a data-parallel step must keep equal across the ranks:
    the generator's and discriminator's parameters and buffers (codebooks,
    BatchNorm statistics), the EMA, and both optimizers' moments."""
    out = {f"g.{k}": v for k, v in tr.model.state_dict().items()}
    out.update({f"ema.{k}": v for k, v in state.g.ema_params.items()})
    if tr.disc is not None:
        out.update({f"d.{k}": v for k, v in tr.disc.state_dict().items()})
    for name, opt in (("opt_g", tr.opt_g), ("opt_d", getattr(tr, "opt_d", None))):
        if opt is None:
            continue
        for i, st in opt.state_dict()["state"].items():
            out.update({f"{name}.{i}.{k}": v for k, v in st.items() if torch.is_tensor(v)})
    return out


def build_trainer(kind, cfg, hp, disc_kw, teacher_sd=None, group=None, device=None):
    """(trainer, state) of stage I (`cfg` a VQVAEConfig) or III (a
    PGTFormerConfig with `teacher_sd`), seeded alike on every rank."""
    from pgtformer_tpu_torch.models.vqgan import VQGANDiscriminator
    from pgtformer_tpu_torch.train.stages import PGTFormerTrainer, Stage1Trainer
    disc = VQGANDiscriminator(**disc_kw)
    if kind == "I":
        tr = Stage1Trainer(cfg, hp, device=device, disc=disc, group=group)
        return tr, tr.init_state(torch.Generator().manual_seed(3))
    tr = PGTFormerTrainer(cfg, "III", hp, device=device, disc=disc, group=group)
    return tr, tr.init_state(torch.Generator().manual_seed(3),
                             {k: torch.from_numpy(v) for k, v in teacher_sd.items()})


def two_ranks(rank, world, store, cases):
    """Every two-rank check of tests/test_torch_parallel.py in one group:
    `cases` maps a name to its arguments; returns {name: result}."""
    from pgtformer_tpu_torch.models.quantizer import ema_codebook_update
    from pgtformer_tpu_torch.models.vqgan import VQGANDiscriminator
    g = _join(rank, world, store)
    out = {}
    try:
        if "serve" in cases:
            out["serve"] = _serve(g, **cases["serve"])
        if "ema" in cases:
            res = []
            for w, c, e, vecs, idx in cases["ema"]:
                args = [torch.from_numpy(np.array(a)) for a in (w, c, e)]
                ema_codebook_update(*args, P.shard_rows(torch.from_numpy(vecs), g),
                                    P.shard_rows(torch.from_numpy(idx), g), decay=0.9,
                                    restart_unused_codes=True,
                                    generator=torch.Generator().manual_seed(5), group=g)
                res.append([a.numpy() for a in args])
            out["ema"] = res
        if "bn" in cases:
            sd, x, kw = cases["bn"]
            d = VQGANDiscriminator(**kw)
            d.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
            d.set_group(g)
            logits = d(P.shard_rows(torch.from_numpy(x), g), train=True)
            logits.mean().backward()
            params = list(d.parameters())
            P.mean_tensors_([p.grad for p in params], g)
            out["bn"] = dict(logits=logits.detach().numpy(),
                             stats={k: v.numpy() for k, v in d.state_dict().items()
                                    if k.endswith(("running_mean", "running_var"))},
                             grads={n: p.grad.numpy() for n, p in d.named_parameters()})
        for kind in ("I", "III"):
            if kind not in cases:
                continue
            c = cases[kind]
            tr, state = build_trainer(kind, c["cfg"], c["hp"], c["disc"], c.get("teacher"),
                                      group=g)
            state, metrics = tr.make_step()(state, P.shard_rows(c["batch"], g))
            out[kind] = dict(
                metrics={k: float(v) for k, v in metrics.items()},
                digest=_digest(trainer_tensors(tr, state)),
                params={n: p.detach().numpy().copy() for n, p in state.g.params.items()},
                codebook={n: t.numpy().copy() for n, t in (state.g.codebook or {}).items()})
        return out
    finally:
        P.destroy_group()


def _serve(g, state_dict, cfg, frames, B, video=None, dtype=torch.float32, seed=0):
    """prime + every full chunk of B frames (rank 0 holds them), then with
    `video` = (src, dst) restore_video; returns rank 0's frames, the video
    stats, and the rank's K1 and K6 launches over the chunks."""
    from pgtformer_tpu_torch.ops.dense_mha import dense_mha_bnhd
    from pgtformer_tpu_torch.ops.sw_block import sw_block
    from pgtformer_tpu_torch.pipeline import VideoRestorer
    r = VideoRestorer(state_dict, cfg, w=1.0, batch_windows=B, dtype=dtype,
                      io_backend="opencv", seed=seed, group=g)
    r.prime(frames[0] if g.rank == 0 else None)
    before = sw_block.launches, dense_mha_bnhd.launches
    outs = []
    for c in range((len(frames) - 1) // B):
        out = r.restore_chunk(frames[1 + c * B:1 + (c + 1) * B] if g.rank == 0 else None)
        outs.append(None if out is None else out.cpu().numpy())
    res = {"frames": np.concatenate(outs) if g.rank == 0 else None,
           "launches": (sw_block.launches - before[0], dense_mha_bnhd.launches - before[1])}
    if video is not None:
        stats = r.restore_video(*video) if g.rank == 0 else r.restore_video()
        res["video"] = {k: v for k, v in stats.items() if k in ("frames", "steps")}
    return res
