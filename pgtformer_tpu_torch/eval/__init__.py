"""Evaluation metrics of the port: PSNR/SSIM, LPIPS, NIQE (``niqe.py``),
and the face metrics Deg / LMD / TLME / MSRL with their landmark detector
(``landmarks.py``) and ArcFace embedder (``arcface.py``); ``eval_cli.py``
runs them over VFHQ-Test."""

from pgtformer_tpu_torch.eval.metrics import (
    calculate_psnr, calculate_ssim, calculate_lpips_fn,
    landmark_distance, temporal_landmark_error, identity_degradation)
