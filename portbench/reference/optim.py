"""Adam as PyTorch and optax define it (eps added after the square root),
plain."""

from __future__ import annotations

import torch


class Adam:
    """Adam over a list of leaves, each with its own rate ``lrs[i]``."""

    def __init__(self, leaves, lrs, betas, eps: float = 1e-8):
        self.leaves, self.lrs = list(leaves), list(lrs)
        self.b1, self.b2 = betas
        self.eps = eps
        self.t = 0
        self.m = [torch.zeros_like(p) for p in self.leaves]
        self.v = [torch.zeros_like(p) for p in self.leaves]

    @torch.no_grad()
    def step(self, scale: float = 1.0) -> None:
        """One update from the leaves' ``.grad``, every rate times
        ``scale``."""
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, lr, m, v in zip(self.leaves, self.lrs, self.m, self.v):
            g = p.grad
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(lr * scale / c1 * m / ((v / c2).sqrt() + self.eps))
            p.grad = None
