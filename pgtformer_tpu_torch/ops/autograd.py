"""The autograd Function of the hand-written kernels: the forward launches
the kernel (its wrapper), the backward recomputes the kernel's plain
PyTorch version with autograd and differentiates it, as the JAX package's
``custom_vjp``s do through its XLA path.  Neither package has a backward
kernel."""

from __future__ import annotations

from typing import Callable

import torch


class KernelFunction(torch.autograd.Function):
    """``KernelFunction.apply(kernel, plain, *inputs)``: ``kernel(*inputs)``
    forward; the gradients of ``plain(*inputs)`` backward, for every input
    that needs one.  The backward turns autocast off: the plain version
    states its own dtypes."""

    @staticmethod
    def forward(ctx, kernel: Callable, plain: Callable, *inputs):
        ctx.save_for_backward(*inputs)
        ctx.plain = plain
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, grad):
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad(), torch.autocast(grad.device.type, enabled=False):
            leaves = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            out = ctx.plain(*leaves)
            wanted = [t for t, n in zip(leaves, need) if n]
            got = iter(torch.autograd.grad(out, wanted, grad.to(out.dtype)) if wanted else ())
        return (None, None, *(next(got) if n else None for n in need))
