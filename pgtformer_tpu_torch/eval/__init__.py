"""Evaluation metrics of the port (so far the PSNR/SSIM that training-time
validation reports)."""
