"""The four-stage training recipe: one training step per stage, on one
device or data-parallel across the ranks of a group (PyTorch port of the
JAX package's ``train/stages.py``).

  * stage I   - TDCRQVAE3 VQGAN pretrain: L1 + LPIPS + 0.25 * commitment +
                hinge GAN, EMA codebook (:class:`Stage1Trainer`);
  * stage II  - code prediction: CE(logits, teacher codes) * 0.5 +
                MSE(lq_feat, teacher z_q), ``code_only``;
  * stage III - the whole PGTFormer + GAN: CE + feature MSE + pixel L1 +
                LPIPS + hinge, {quantizer, decoder, conditionnet} frozen;
  * stage IV  - focal loss + GRADL1 + temporal LPIPS
                (:class:`PGTFormerTrainer` for II-IV).

Entry points as in the JAX package: ``trainer.init_state(...)`` returns a
:class:`~pgtformer_tpu_torch.train.state.TrainState`, and
``trainer.make_step()`` returns ``step(state, batch) -> (state, metrics)``.
The step runs on the trainer's device, the card unless the caller passes
``device="cpu"``; it updates the modules' parameters and buffers in place
and returns the same state with its step counter advanced.

Parameters are fp32 masters, optimized by Adam.  With ``dtype=bfloat16``
the forwards of the generator, teacher and discriminator run under
``torch.autocast`` (bf16 compute over fp32 parameters, as flax's
``dtype=bfloat16`` with fp32 ``param_dtype``): convs and linears round
their operands to bf16, the norms keep fp32 statistics and round once, the
shifted-window and attention kernels take their weights cast from the
live parameters.  The quantizer, LPIPS and every loss compute in fp32.

On the card the forwards launch the hand-written kernels (K1, K5, K6, or
K3/K4/K2 under their plans); their backwards recompute through the plain
versions (``ops/sw_block.py``, ``ops/dense_mha.py``), so a backward launches
no kernel.  The fused decoder tail (``FUSED_TAIL``) stays inference-only.

With a ``group`` of ranks (``parallel/group.py``; the JAX package's mesh,
its ``shard_map`` and ``_pmean_if``) every rank builds the same trainer,
``init_state`` takes rank 0's modules on every rank, and each step takes
the rank's rows of the global batch: the gradients of each optimizer are
averaged over the ranks after the backward (one all-reduce of its
flattened gradient; ``DistributedDataParallel`` would rename the state
dict's keys and need unused-parameter detection for the frozen parts), as
are the metrics; the codebook's EMA statistics are summed and rank 0's
restart vectors taken (``models/quantizer.py``), and the discriminator's
BatchNorms sync their batch statistics (``models/vqgan.py``).  Every rank
then holds the same parameters, optimizer state and buffers.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from pgtformer_tpu_torch import resolve_device
from pgtformer_tpu_torch.config import PGTFormerConfig, VQVAEConfig
from pgtformer_tpu_torch.convert import load_into
from pgtformer_tpu_torch.models.pgtformer import PGTFormer
from pgtformer_tpu_torch.models.quantizer import VQEmbedding
from pgtformer_tpu_torch.models.vae import TDCRQVAE3
from pgtformer_tpu_torch.models.vqgan import VQGANDiscriminator
from pgtformer_tpu_torch.nn.blocks import init_weights
from pgtformer_tpu_torch.parallel import group as P
from pgtformer_tpu_torch.train import losses as L
from pgtformer_tpu_torch.train.ema import ema_init, ema_update
from pgtformer_tpu_torch.train.schedule import make_adam, multistep_with_warmup
from pgtformer_tpu_torch.train.state import DiscriminatorState, GeneratorState, TrainState


@dataclass(frozen=True)
class StageHyper:
    """Per-stage hyperparameters (YAML `train:` subtree)."""
    lr_g: float = 4e-5
    lr_d: float = 4e-5
    betas: Tuple[float, float] = (0.5, 0.9)
    milestones: Tuple[int, ...] = (800000,)
    gamma: float = 0.5
    warmup_iter: int = -1
    total_iter: int = 800000
    ema_decay: float = 0.999
    gan_start_iter: int = -1
    gan_weight: float = 0.75
    # stage II+ options
    token_loss: str = "ce"          # "ce" | "focal"
    token_weight: float = 0.5
    feat_loss: str = "mse"          # "mse" | "l1"
    feat_weight: float = 1.0
    feat_target: str = "zq"         # "zq" (teacher quantized) | "ze" (pre-VQ)
    pixel_loss: str = "l1"          # "l1" | "gradl1" | "none"
    pixel_weight: float = 1.0
    lossmulti: Tuple[float, ...] = (0.2, 0.05, 0.05)
    perceptual: str = "lpips"       # "lpips" | "temporal_lpips" | "none"
    tgrad_weight: float = 0.8
    use_gan: bool = True
    # "fixed": constant gan_weight; "adaptive": taming's last-layer
    # gradient-norm ratio (two extra backward passes to that layer)
    gan_weight_mode: str = "fixed"


STAGE_HYPERS = {
    "I": StageHyper(lr_g=4e-5, lr_d=4e-5, milestones=(800000,),
                    warmup_iter=20000, total_iter=800000),
    "II": StageHyper(lr_g=8e-5, lr_d=8e-5, milestones=(400000,),
                     total_iter=400000, use_gan=False, token_loss="ce",
                     feat_loss="mse", pixel_loss="none", perceptual="none"),
    "III": StageHyper(lr_g=2e-5, lr_d=2e-5, milestones=(200000,),
                      total_iter=200000, token_loss="ce", feat_loss="mse",
                      pixel_loss="l1", perceptual="lpips", gan_weight=1.0),
    "IV": StageHyper(lr_g=2e-5, lr_d=2e-5, milestones=(200000,),
                     total_iter=200000, token_loss="focal", feat_loss="l1",
                     pixel_loss="gradl1", perceptual="temporal_lpips"),
}


def _dequantize(x, device: torch.device) -> torch.Tensor:
    """uint8 [0, 255] -> fp32 [0, 1] on `device` (the upload stays uint8);
    a float batch is moved as fp32."""
    x = torch.as_tensor(x).to(device)
    return x.float() / 255.0 if x.dtype == torch.uint8 else x.float()


def _flat_frames(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, W, C] -> [B*T, H, W, C]."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def trainable_mask(model: nn.Module, frozen_top_level: Sequence[str]) -> Dict[str, bool]:
    """Parameter name -> True (trainable) unless it lies under one of the
    frozen top-level modules (the reference's `fix_modules`)."""
    frozen = set(frozen_top_level)
    return {n: n.split(".")[0] not in frozen for n, _ in model.named_parameters()}


def _codebook_names(model: nn.Module) -> Tuple[List[str], List[str]]:
    """(codebook weight names, every codebook tensor name): the quantizer's
    state, which the JAX package keeps out of `params`."""
    weights, tensors = [], []
    for prefix, m in model.named_modules():
        if isinstance(m, VQEmbedding):
            weights.append(f"{prefix}.weight")
            tensors += [f"{prefix}.{n}" for n in ("weight", "cluster_size_ema", "embed_ema")]
    return weights, tensors


def _adaptive_gan_weight(nll: torch.Tensor, gan: torch.Tensor, last_layer: torch.Tensor,
                         max_weight: float = 1e4) -> torch.Tensor:
    """taming's calculate_adaptive_weight: ||d nll / d w|| / (||d gan / d w||
    + 1e-4), clipped to [0, max_weight], with gradients taken with respect to
    the last layer's weight `w` only; no gradient flows through it."""
    g_nll, = torch.autograd.grad(nll, last_layer, retain_graph=True)
    g_gan, = torch.autograd.grad(gan, last_layer)
    n = torch.linalg.vector_norm(g_nll.float())
    g = torch.linalg.vector_norm(g_gan.float())
    return (n / (g + 1e-4)).clamp(0.0, max_weight).detach()


class _Trainer:
    """What the two trainers share: device and compute dtype, the
    generator's optimizer over its trainable parameters, the discriminator
    and its optimizer, state bookkeeping, the discriminator's step."""

    model: nn.Module
    disc: Optional[VQGANDiscriminator]

    def __init__(self, hp: StageHyper, lpips_fn: Optional[Callable], device, dtype: torch.dtype,
                 group: Optional[P.Group] = None):
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype {dtype} (choices: float32, bfloat16)")
        if group is not None and device is not None and torch.device(device) != group.device:
            raise ValueError(f"device {device} is not the group's {group.device}")
        self.hp = hp
        self.group = group if group is not None and group.world > 1 else None
        self.device = group.device if group is not None else resolve_device(device)
        self.dtype = dtype
        self.lpips_fn = lpips_fn
        self.hinge = L.HingeGANLoss("hinge", hp.gan_weight)
        self._state: Optional[TrainState] = None

    # -- helpers -------------------------------------------------------------
    def _autocast(self):
        """bf16 compute over the fp32 parameters (or nothing, in fp32)."""
        if self.dtype == torch.float32:
            return nullcontext()
        return torch.autocast(self.device.type, dtype=self.dtype)

    def _lpips(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.lpips_fn(x, y).mean()

    def _load_disc(self, generator: torch.Generator, disc_state_dict) -> None:
        if disc_state_dict is None:
            init_weights(self.disc, generator)
        else:
            load_into(self.disc, disc_state_dict)
        self.disc.to(self.device)

    def _make_state(self, rng_seed: int, frozen: Sequence[str] = ()) -> TrainState:
        """Freeze, build the optimizers and the state over the modules as
        they now stand on the device (with a group: as they stand on rank
        0)."""
        hp = self.hp
        if self.group is not None:
            nets = [m for m in (self.model, getattr(self, "teacher", None), self.disc)
                    if m is not None]
            P.broadcast_tensors_([t for m in nets for t in m.state_dict().values()], self.group)
        cb_weights, cb_tensors = _codebook_names(self.model)
        mask = trainable_mask(self.model, frozen)
        named = dict(self.model.named_parameters())
        params = {n: p for n, p in named.items() if n not in cb_weights}
        for n, p in params.items():
            p.requires_grad_(mask[n])
        self._g_trainable = [p for n, p in params.items() if mask[n]]
        self.opt_g, self.sched_g = make_adam(
            self._g_trainable,
            multistep_with_warmup(hp.lr_g, hp.milestones, hp.gamma, hp.warmup_iter), hp.betas)
        tensors = self.model.state_dict(keep_vars=True)
        codebook = {n: tensors[n] for n in cb_tensors} or None
        stats = {n: t for n, t in tensors.items()
                 if n.endswith(("running_mean", "running_var"))} or None
        g = GeneratorState(params=params, ema_params=ema_init(params),
                           opt_state=self.opt_g.state_dict(), codebook=codebook,
                           batch_stats=stats)
        d = None
        if self.disc is not None:
            self.opt_d, self.sched_d = make_adam(
                list(self.disc.parameters()),
                multistep_with_warmup(hp.lr_d, hp.milestones, hp.gamma, hp.warmup_iter),
                hp.betas)
            dt = self.disc.state_dict(keep_vars=True)
            d = DiscriminatorState(
                params=dict(self.disc.named_parameters()), opt_state=self.opt_d.state_dict(),
                batch_stats={n: t for n, t in dt.items() if n.endswith(("mean", "var"))})
        rng = torch.Generator(device=self.device).manual_seed(rng_seed)
        self._state = TrainState(step=0, g=g, d=d, rng=rng)
        return self._state

    def _check(self, state: TrainState) -> None:
        if state is not self._state:
            raise ValueError("this state was not made by this trainer's init_state "
                             "(its tensors are the trainer's modules' own)")

    def _mean_grads(self, params) -> None:
        """With a group: each gradient replaced by its mean over the ranks
        (the JAX package's ``_pmean_if`` of the gradients)."""
        if self.group is not None:
            P.mean_tensors_([p.grad for p in params if p.grad is not None], self.group)

    def _metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Detached fp32 scalars; with a group, their means over the ranks."""
        out = {k: torch.as_tensor(v, device=self.device).detach().float()
               for k, v in metrics.items()}
        if self.group is not None:
            P.mean_tensors_(list(out.values()), self.group)
        return out

    def _g_update(self, state: TrainState, total: torch.Tensor) -> None:
        """Backward of the generator's loss into its trainable parameters
        only (their gradients averaged over a group's ranks), then Adam, the
        schedule and the EMA."""
        total.backward(inputs=self._g_trainable)
        self._mean_grads(self._g_trainable)
        self.opt_g.step()
        self.sched_g.step()
        ema_update(state.g.ema_params, state.g.params, self.hp.ema_decay)

    def _d_step(self, real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
        """The discriminator's hinge step on real, then fake frames: both
        passes in train mode, threading the BN statistics after the
        generator's pass."""
        self.opt_d.zero_grad(set_to_none=True)
        with self._autocast():
            real_logits = self.disc(real, train=True)
            fake_logits = self.disc(fake.detach(), train=True)
        loss = self.hinge.d_loss(real_logits, fake_logits)
        loss.backward()
        self._mean_grads(self.disc.parameters())
        self.opt_d.step()
        self.sched_d.step()
        return loss.detach()

    def _finish(self, state: TrainState) -> TrainState:
        state.step += 1
        state.g.opt_state = self.opt_g.state_dict()
        if state.d is not None:
            state.d.opt_state = self.opt_d.state_dict()
        return state

    def make_step(self):
        """step(state, batch) -> (state, metrics): metrics are detached fp32
        scalars on the device."""
        return self._step


class Stage1Trainer(_Trainer):
    """VQGAN pretrain of the temporal RQ-VAE (reference stage I).

    `lpips_fn`: ``train/lpips.py:make_lpips_fn()`` or None (no perceptual
    term).  `dtype`: the compute dtype (fp32, or bf16 under autocast).
    `group`: train data-parallel over its ranks (module docstring); the
    device is then the group's."""

    def __init__(self, cfg: VQVAEConfig, hp: StageHyper = STAGE_HYPERS["I"],
                 lpips_fn: Optional[Callable] = None, device=None,
                 dtype: torch.dtype = torch.float32,
                 disc: Optional[VQGANDiscriminator] = None,
                 group: Optional[P.Group] = None):
        super().__init__(hp, lpips_fn, device, dtype, group)
        self.cfg = cfg
        self.model = TDCRQVAE3(cfg, group=self.group)
        self.disc = (disc if disc is not None else VQGANDiscriminator()).set_group(self.group)

    def init_state(self, generator: torch.Generator, state_dict: Optional[Mapping] = None,
                   disc_state_dict: Optional[Mapping] = None) -> TrainState:
        """Initialize (from `generator`) or load (reference-format state
        dicts, e.g. ``convert.flax_to_state_dict`` of JAX variables) the
        autoencoder and the discriminator, move them to the device and
        return the state.  (The JAX package's `sample_gt` argument is not
        needed: the modules' shapes come from the config.)"""
        if state_dict is None:
            init_weights(self.model, generator)
        else:
            load_into(self.model, state_dict)
        self.model.to(self.device)
        self._load_disc(generator, disc_state_dict)
        seed = int(torch.randint(2 ** 62, (1,), generator=generator))
        return self._make_state(seed)

    def _nll(self, out, gt_flat):
        r = L.l1_loss(out, gt_flat)
        if self.lpips_fn is not None:
            r = r + self._lpips(out, gt_flat)
        return r

    def _adaptive_weight(self, gt: torch.Tensor, gt_flat: torch.Tensor) -> torch.Tensor:
        """The adaptive GAN weight at the decoder's last conv (reference
        get_last_layer(), tdcrqvae3_arch.py:847-848), from a recompute with
        train=False: before this step's codebook update, with the
        discriminator's statistics left as they are."""
        with self._autocast():
            out, _, _ = self.model(gt)
            logits = self.disc(out, train=True, update_stats=False)
        return _adaptive_gan_weight(self._nll(out, gt_flat), self.hinge.g_loss(logits),
                                    self.model.decoder.conv_out.weight)

    def _step(self, state: TrainState, gt) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        self._check(state)
        hp = self.hp
        gt = _dequantize(gt, self.device)
        gt_flat = _flat_frames(gt)
        self.opt_g.zero_grad(set_to_none=True)
        d_weight = (self._adaptive_weight(gt, gt_flat) if hp.gan_weight_mode == "adaptive"
                    else 1.0)
        with self._autocast():
            out, quant_loss, _ = self.model(gt, train=True, generator=state.rng)
            fake_logits = self.disc(out, train=True)
        l_pix = L.l1_loss(out, gt_flat)
        l_percep = (self._lpips(out, gt_flat) if self.lpips_fn is not None
                    else torch.zeros((), device=self.device))
        nll = l_pix + l_percep + self.cfg.latent_loss_weight * quant_loss
        l_gan = self.hinge.g_loss(fake_logits)
        gan_on = float(state.step >= hp.gan_start_iter)
        total = nll + gan_on * d_weight * l_gan
        self._g_update(state, total)
        l_d = self._d_step(gt_flat, out)
        metrics = {"l_pix": l_pix, "l_percep": l_percep, "l_quant": quant_loss,
                   "l_g_gan": l_gan, "l_g_total": total, "l_d": l_d}
        if hp.gan_weight_mode == "adaptive":
            metrics["d_weight"] = d_weight
        return self._finish(state), self._metrics(metrics)


class PGTFormerTrainer(_Trainer):
    """Code prediction (II) and the end-to-end GAN stages (III, IV).

    The teacher is a frozen stage-I `TDCRQVAE3` run under no_grad (encode,
    then the quantizer); the student is a `PGTFormer` whose `fix_modules`
    (but the quantizer, whose codebooks are buffers anyway), plus
    `post_quant_conv` with a frozen decoder, are frozen: kept out of the
    optimizer, `requires_grad=False`."""

    def __init__(self, cfg: PGTFormerConfig, stage: str = "III",
                 hp: Optional[StageHyper] = None, lpips_fn: Optional[Callable] = None,
                 device=None, dtype: torch.dtype = torch.float32,
                 disc: Optional[VQGANDiscriminator] = None,
                 group: Optional[P.Group] = None):
        if stage not in ("II", "III", "IV"):
            raise ValueError(f"stage {stage!r} (choices: II, III, IV)")
        super().__init__(hp or STAGE_HYPERS[stage], lpips_fn, device, dtype, group)
        self.cfg = cfg
        self.stage = stage
        self.code_only = stage == "II"
        self.model = PGTFormer(cfg)
        self.teacher = TDCRQVAE3(cfg.vqvae)
        self.disc = ((disc if disc is not None else VQGANDiscriminator()).set_group(self.group)
                     if self.hp.use_gan else None)

    def frozen_modules(self) -> List[str]:
        frozen = [m for m in self.cfg.fix_modules if m != "quantizer"]
        if "decoder" in frozen:
            frozen.append("post_quant_conv")
        return frozen

    def init_state(self, generator: torch.Generator, teacher_state_dict: Mapping,
                   student_state_dict: Optional[Mapping] = None,
                   disc_state_dict: Optional[Mapping] = None) -> TrainState:
        """Load the teacher (a stage-I state dict), initialize (from
        `generator`) or load the student and the discriminator, move them to
        the device and return the state."""
        load_into(self.teacher, teacher_state_dict)
        self.teacher.to(self.device).eval().requires_grad_(False)
        if student_state_dict is None:
            init_weights(self.model, generator)
        else:
            load_into(self.model, student_state_dict)
        self.model.to(self.device)
        if self.disc is not None:
            self._load_disc(generator, disc_state_dict)
        seed = int(torch.randint(2 ** 62, (1,), generator=generator))
        return self._make_state(seed, self.frozen_modules())

    def _last_layer(self) -> torch.Tensor:
        """Reference get_last_layer() with a frozen decoder: the last fuse
        block's encode_enc.conv2 (pgtformer_arch.py:592-596)."""
        return self.model.fuse_convs_dict[self.cfg.connect_list[-1]].encode_enc.conv2.weight

    def _student(self, lq: torch.Tensor):
        with self._autocast():
            return self.model(lq, w=self.cfg.w, detach_16=True, adain=self.cfg.adain)

    def _adaptive_weight(self, lq: torch.Tensor, gt_flat: torch.Tensor) -> torch.Tensor:
        out, _, _ = self._student(lq)
        nll = L.l1_loss(out, gt_flat)
        if self.lpips_fn is not None:
            nll = nll + self._lpips(out, gt_flat)
        with self._autocast():
            logits = self.disc(out, train=True, update_stats=False)
        return _adaptive_gan_weight(nll, self.hinge.g_loss(logits), self._last_layer())

    def _step(self, state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        self._check(state)
        hp = self.hp
        lq = _dequantize(batch["lq"], self.device)
        gt = _dequantize(batch["gt"], self.device)
        gt_flat = _flat_frames(gt)
        B, T = gt.shape[:2]

        # teacher targets (frozen, no gradient)
        with torch.no_grad(), self._autocast():
            t_z = self.teacher.encode(gt)
            t_zq, _, t_codes = self.teacher.quantizer(t_z)
        t_feat = t_zq if hp.feat_target == "zq" else t_z

        self.opt_g.zero_grad(set_to_none=True)
        gan = hp.use_gan and self.disc is not None and not self.code_only
        d_weight = (self._adaptive_weight(lq, gt_flat)
                    if gan and hp.gan_weight_mode == "adaptive" else 1.0)
        if self.code_only:
            with self._autocast():
                logits, lq_feat = self.model(lq, code_only=True)
            out = None
        else:
            out, logits, lq_feat = self._student(lq)

        token = L.focal_loss if hp.token_loss == "focal" else L.cross_entropy_loss
        l_token = token(logits, t_codes, loss_weight=hp.token_weight)
        feat = L.l1_loss if hp.feat_loss == "l1" else L.mse_loss
        l_feat = feat(lq_feat, t_feat, loss_weight=hp.feat_weight)
        total = l_token + l_feat
        metrics = {"l_token": l_token, "l_feat": l_feat}

        if out is not None:
            out5 = out.reshape(B, T, *out.shape[1:])
            zero = torch.zeros((), device=self.device)
            if hp.pixel_loss == "gradl1":
                l_pix = L.grad_l1_loss(out5, gt, hp.pixel_weight, hp.lossmulti, T)
            elif hp.pixel_loss == "l1":
                l_pix = L.l1_loss(out, gt_flat, hp.pixel_weight)
            else:
                l_pix = zero
            if hp.perceptual == "temporal_lpips" and self.lpips_fn is not None:
                l_percep = L.temporal_lpips_loss(self.lpips_fn, out5, gt, T, hp.tgrad_weight)
            elif hp.perceptual == "lpips" and self.lpips_fn is not None:
                l_percep = self._lpips(out, gt_flat)
            else:
                l_percep = zero
            total = total + l_pix + l_percep
            metrics.update(l_pix=l_pix, l_percep=l_percep)
            if gan:
                with self._autocast():
                    fake_logits = self.disc(out, train=True)
                l_gan = self.hinge.g_loss(fake_logits)
                gan_on = float(state.step >= hp.gan_start_iter)
                total = total + gan_on * d_weight * l_gan
                metrics["l_g_gan"] = l_gan
                if hp.gan_weight_mode == "adaptive":
                    metrics["d_weight"] = d_weight

        self._g_update(state, total)
        metrics["l_g_total"] = total
        if gan:
            metrics["l_d"] = self._d_step(gt_flat, out)
        return self._finish(state), self._metrics(metrics)
