"""Training of stages I-IV (PyTorch port of the JAX package's ``train/``):
the step of each stage (``stages.py``), its losses, LPIPS, optimizer
schedule, parameter EMA and state."""
