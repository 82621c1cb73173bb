"""Evaluation CLI (PyTorch port): VFHQ-Test metrics (the reference's `val:`
loop, options/...yml:148-175: PSNR/SSIM/LPIPS(/NIQE) over the test split,
plus the face metrics Deg/LMD/TLME/MSRL).

    python -m pgtformer_tpu_torch.eval_cli --data-root /data/vfhq \
        --weights pgtformer-base.pth [--rotate] [--inter-space 10] \
        [--save-dir exp/val_imgs] [--niqe-params niqe_pris_params.npz] \
        [--niqe-fit-gt] [--face-metrics] [--arcface-weights backbone.pth] \
        [--lpips-weights vgg_lpips.pth] [--device cuda]

Runs on the card in bf16 by default (the restoration forward launches the
hand-written kernels, `use_pallas` where the device is CUDA, as the JAX
CLI's where the backend is not the CPU); `--fp32` computes in float32 (the
kernels in their fp32 form, TF32 off).  Each batch of clips
takes one `PGTFormer.forward(middle_only=True)`; the metric networks
(LPIPS's VGG, the landmark parser, ArcFace) run in fp32 on the same device,
one image at a time.  The printed lines and column labels are the JAX
package's `eval_cli`'s; a short tail batch runs as a smaller batch (no
recompile to avoid here).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from pgtformer_tpu_torch import knobs
from pgtformer_tpu_torch.eval.landmarks import face_metrics_frame
from pgtformer_tpu_torch.eval.metrics import (
    calculate_lpips_fn, calculate_psnr, calculate_ssim, temporal_landmark_error)
from pgtformer_tpu_torch.eval.niqe import (
    calculate_niqe, fit_pris_params, image_niqe_features, niqe_from_features)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="pgtformer_tpu_torch evaluation")
    parser.add_argument("--data-root", required=True)
    parser.add_argument("--weights", default=None,
                        help="Reference-format checkpoint (.pth or .safetensors), or a "
                             "directory holding model.safetensors / pytorch_model.bin")
    parser.add_argument("--fidelity", "-w", type=float, default=1.0)
    parser.add_argument("--inter-space", type=int, default=1,
                        help="evaluate every k-th frame (reference "
                             "V2TESTUP inter_space)")
    parser.add_argument("--rotate", action="store_true",
                        help="±30° rotation robustness eval "
                             "(reference V2TESTUPROTATE)")
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--save-dir", default=None)
    parser.add_argument("--niqe-params", default=None)
    parser.add_argument("--niqe-fit-gt", action="store_true",
                        help="no-reference NIQE with the pristine MVG "
                             "fitted from THIS eval set's GT frames "
                             "(labeled 'niqe(gt-fit)'; exercises the full "
                             "NIQE pipeline but is NOT comparable to "
                             "scores under BasicSR's niqe_pris_params.npz "
                             "-- pass --niqe-params for those)")
    parser.add_argument("--lpips-weights", default=None,
                        help="lpips.LPIPS(net='vgg') state_dict for "
                             "metric-grade LPIPS (random VGG otherwise)")
    parser.add_argument("--arcface-weights", default=None,
                        help="insightface arcface_torch iresnet50 "
                             "backbone.pth for metric-grade Deg (the "
                             "gray-patch proxy embedder otherwise)")
    parser.add_argument("--fp32", action="store_true",
                        help="Compute in float32 (default bfloat16); on the card the "
                             "kernels take fp32 activations and TF32 is off")
    parser.add_argument("--face-metrics", action="store_true",
                        help="also emit Deg/LMD/TLME/MSRL (reference "
                             "README.md:127) via the pluggable "
                             "landmark/embedder fallbacks (eval/landmarks.py)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; fails without a card)")
    knobs.add_cli_flags(parser)
    args = parser.parse_args(argv)
    knobs.apply_cli_args(args)

    from pgtformer_tpu_torch import default_use_pallas, resolve_device
    from pgtformer_tpu_torch.config import RELEASE_PGTFORMER
    from pgtformer_tpu_torch.convert import load_checkpoint, load_into, local_checkpoint
    from pgtformer_tpu_torch.data.vfhq import (
        VFHQRotateTestDataset, VFHQTestDataset, clip_batches)
    from pgtformer_tpu_torch.models.pgtformer import PGTFormer

    device = resolve_device(args.device)
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    if device.type == "cuda":
        # the metric networks (and an fp32 model) compute in fp32; cuDNN
        # would take TF32 for their convs (a bf16 model is unaffected)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    cfg = RELEASE_PGTFORMER
    T = cfg.vqvae.tf
    kernels = default_use_pallas(device)
    if args.weights:
        model = load_into(PGTFormer(cfg, use_pallas=kernels),
                          load_checkpoint(local_checkpoint(args.weights)))
    else:
        print("WARNING: no --weights given; running with random weights "
              "(pipeline smoke test only).", file=sys.stderr)
        model = PGTFormer(cfg, generator=torch.Generator().manual_seed(0), use_pallas=kernels)
    # the landmark parser takes the fp32 parsing weights, before the cast
    cond_sd = model.conditionnet.state_dict() if args.face_metrics else None
    model = model.to(device=device, dtype=dtype).eval().requires_grad_(False)

    ds_cls = VFHQRotateTestDataset if args.rotate else VFHQTestDataset
    dataset = ds_cls(args.data_root, r=(T - 1) // 2, degradation="blr",
                     inter_space=args.inter_space)

    lpips_metric = calculate_lpips_fn(weights_path=args.lpips_weights, device=device)
    niqe_fn = None
    niqe_fit = None
    if args.niqe_params:
        niqe_fn = lambda img: calculate_niqe(img, args.niqe_params)
    if args.niqe_fit_gt:   # independent of --niqe-params; both can emit
        niqe_fit = {"out": [], "gt": []}

    face = None
    if args.face_metrics:
        from pgtformer_tpu_torch.eval.landmarks import (
            GrayPatchEmbedder, ParserLandmarkDetector)
        detector = ParserLandmarkDetector(cond_sd, device=device)
        # column labels mark non-metric-grade fallbacks at the output
        # surface so no table can be mistaken for paper-comparable numbers
        # (MSRL has no public definition at all -- eval/landmarks.py)
        labels = {"lmd": "lmd(parser-lm)", "tlme": "tlme(parser-lm)",
                  "msrl": "msrl(own-def)"}
        if args.arcface_weights:
            from pgtformer_tpu_torch.eval.arcface import ArcFaceEmbedder
            embedder = ArcFaceEmbedder(args.arcface_weights, detector=detector,
                                       device=device)
            labels["deg"] = "deg"          # metric-grade
        else:
            embedder = GrayPatchEmbedder()
            labels["deg"] = "deg(proxy-embedder)"
        face = {"detector": detector, "embedder": embedder,
                "labels": labels,
                "clip_lms": {}}  # clip -> list of (lm_pred, lm_gt)

    rows = []
    n = 0
    for batch in clip_batches(dataset, args.batch, drop_last=False):
        outs = restore_middle(model, batch["lq"], args.fidelity)
        for i, out_i in enumerate(outs):
            _accumulate(rows, out_i, batch, i, lpips_metric, niqe_fn,
                        args, T, face, niqe_fit)
            n += 1
        if args.limit and n >= args.limit:
            break

    if not rows:
        print("no samples evaluated", file=sys.stderr)
        return 1
    if niqe_fit is not None and niqe_fit["gt"]:
        # pristine MVG from the GT frames, then score every output --
        # the same Mahalanobis machinery as the published model, with a
        # corpus swap (see eval/niqe.py fit_pris_params docstring)
        mu_p, cov_p = fit_pris_params(niqe_fit["gt"])
        for row, feats in zip(rows, niqe_fit["out"]):
            row["niqe(gt-fit)"] = niqe_from_features(feats, mu_p, cov_p)
    keys = rows[0].keys()
    print("samples:", len(rows))
    for k in keys:
        vals = [r[k] for r in rows]
        print(f"{k}: {np.mean(vals):.4f}")
    if face is not None:
        # TLME needs landmark *sequences*: frame-to-frame motion error per
        # clip, averaged over clips (eval/metrics.py temporal_landmark_error)
        tlmes = []
        for clip, lms in face["clip_lms"].items():
            if len(lms) >= 2:
                lp = np.stack([a for a, _ in lms])
                lg = np.stack([b for _, b in lms])
                tlmes.append(temporal_landmark_error(lp, lg))
        if tlmes:
            print(f"{face['labels']['tlme']}: {np.mean(tlmes):.4f}")
        else:
            print("tlme: n/a (need >=2 frames per clip; lower inter-space)",
                  file=sys.stderr)
    return 0


def restore_middle(model, lq: np.ndarray, w: float) -> np.ndarray:
    """One forward of a batch of clips lq [B, T, H, W, 3] (float in [0, 1])
    -> the restored middle frames [B, H, W, 3], fp32 clipped to [0, 1]."""
    device = next(model.parameters()).device
    with torch.no_grad():
        out = model(torch.from_numpy(lq).to(device), w=w, middle_only=True)[0]
        return out.float().clamp(0.0, 1.0).cpu().numpy()


def _accumulate(rows, out_i, batch, i, lpips_metric, niqe_fn, args, T,
                face=None, niqe_fit=None):
    import cv2
    gt = batch["gt"][i][T // 2]
    lpips_key = ("lpips" if not getattr(lpips_metric, "random_weights",
                                        False) else "lpips(random-vgg)")
    row = {"psnr": calculate_psnr(out_i, gt),
           "ssim": calculate_ssim(out_i, gt),
           lpips_key: lpips_metric(out_i, gt)}
    if niqe_fn is not None:
        row["niqe"] = niqe_fn(out_i)
    if niqe_fit is not None:
        niqe_fit["out"].append(image_niqe_features(out_i))
        niqe_fit["gt"].append(image_niqe_features(gt))
    if face is not None:
        fm = face_metrics_frame(out_i, gt, face["detector"],
                                face["embedder"])
        clip = batch["path"][i].rsplit("/", 1)[0]
        face["clip_lms"].setdefault(clip, []).append(
            (fm.pop("_lm_pred"), fm.pop("_lm_gt")))
        row.update({face["labels"].get(k, k): v for k, v in fm.items()})
    rows.append(row)
    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)
        name = batch["path"][i].replace("/", "_")
        cv2.imwrite(os.path.join(args.save_dir, name),
                    (out_i[..., ::-1] * 255).astype(np.uint8))


if __name__ == "__main__":
    sys.exit(main())
