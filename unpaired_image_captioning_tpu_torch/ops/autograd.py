"""Autograd helpers shared by the kernel wrappers."""

from __future__ import annotations

import torch


def plain_vjp(plain, saved, needs, grads_out):
    """Gradients of `plain(*saved)` for the inputs flagged in `needs`,
    recomputed from the saved inputs (None for the others): the backward of
    a kernel whose JAX custom VJP differentiates its reference formula."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
        outs = plain(*ins)
        outs = outs if isinstance(outs, tuple) else (outs,)
        wrt = [t for t, n in zip(ins, needs) if n]
        got = iter(torch.autograd.grad(outs, wrt, grads_out,
                                       allow_unused=True))
    return tuple(next(got) if n else None for n in needs)
