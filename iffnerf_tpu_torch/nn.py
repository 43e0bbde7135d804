"""Functional Linear/MLP layers on parameter dicts, in the JAX package's
layout: weights are stored **[in, out]** (the transpose of ``torch.nn``),
so the forward pass is ``x @ W``.

Initialisation matches torch ``nn.Linear`` defaults, U(-1/sqrt(fan_in),
1/sqrt(fan_in)) on both the weight and the bias, drawn from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math

import torch


def uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    """U(-bound, bound) float32 draws on the generator's device."""
    return (torch.rand(shape, generator=gen, device=gen.device) * 2.0
            - 1.0) * bound


def linear_init(gen: torch.Generator, in_dim: int, out_dim: int,
                bias: bool = True):
    """Parameters for a Linear layer: {'w': [in, out], 'b': [out]} (no
    'b' without ``bias``)."""
    bound = 1.0 / math.sqrt(in_dim)
    params = {"w": uniform(gen, (in_dim, out_dim), bound)}
    if bias:
        params["b"] = uniform(gen, (out_dim,), bound)
    return params


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated in float32 and rounded once to ``x.dtype``:
    the product XLA forms for bf16 operands, on any device (cuBLAS may
    otherwise reduce split-K partial sums in bf16)."""
    if x.dtype == torch.float32:
        return x @ w
    return (x.float() @ w.float()).to(x.dtype)


def linear_apply(params, x: torch.Tensor) -> torch.Tensor:
    y = matmul(x, params["w"])
    if "b" in params:
        y = y + params["b"]
    return y


def mlp_init(gen: torch.Generator, dims: list[int],
             zero_last_bias: bool = False):
    """Stack of Linear layers: dims = [in, h1, ..., out]; the last bias
    zero with ``zero_last_bias`` (the reference's MLP heads)."""
    layers = tuple(linear_init(gen, dims[i], dims[i + 1])
                   for i in range(len(dims) - 1))
    if zero_last_bias:
        layers[-1]["b"] = torch.zeros_like(layers[-1]["b"])
    return layers


def mlp_apply(layers, x: torch.Tensor, activation=torch.relu) -> torch.Tensor:
    """Linear -> act -> ... -> Linear (no activation after the last layer)."""
    for layer in layers[:-1]:
        x = activation(linear_apply(layer, x))
    return linear_apply(layers[-1], x)
