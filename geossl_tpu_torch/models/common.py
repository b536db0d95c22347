"""Shared model building blocks: SchNet's RBF expansion, cosine envelope and
shifted softplus, PaiNN's Gaussian RBF, cosine cutoff, ``Dense`` and
halving-MLP head, and the reference-matching initializers (counterpart of
``geossl_tpu/models/common.py``).

Initialization follows PyTorch semantics as the JAX package does:
Xavier-uniform weights, zero biases, N(0,1) embeddings, every draw from an
explicit ``torch.Generator``.

A compute dtype (``--compute_dtype bfloat16``) follows flax's: :func:`linear`
casts input, weight and bias to it, takes the product (rounded once) and
adds the bias (rounded again), as ``flax.linen.Dense(dtype=...)``; the
activations round each elementwise op's result on a bf16 input, where
XLA's ``jax.nn.softplus``/``jax.nn.silu`` round on a bf16 array (bitwise
the same on the CPU). The parameters stay f32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F_
from torch import nn

LOG2 = math.log(2.0)


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """softplus(x) - log(2). ``jax.nn.softplus`` is ``logaddexp(x, 0)``;
    ``torch.nn.functional.softplus`` returns x itself above its threshold of
    20, which differs by ~2e-9 there and breaks f64 parity, so this uses
    ``logaddexp`` too. On a bf16 input it rounds where XLA rounds
    ``jax.nn.softplus(x) - log 2`` on a bf16 array: after exp(-|x|), after
    log1p, after max(x, 0) + that, and after subtracting log 2 rounded to
    bf16 (0.69140625: JAX's weakly typed constant takes the array's
    dtype)."""
    if x.dtype == torch.bfloat16:
        # maximum (not clamp): at x = 0 its gradient splits evenly, as
        # jnp.maximum's, so that the derivative there is 1/2 (zero biases
        # on padded rows put x at 0 exactly)
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        sp = torch.maximum(x, zero) + torch.log1p(torch.exp(-torch.abs(x)))
        # torch.full writes the constant on the device: no host copy, so a
        # CUDA graph can capture it
        return sp - torch.full((), LOG2, dtype=x.dtype, device=x.device)
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device)) - LOG2


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x). On a bf16 input rounded where XLA rounds
    ``jax.nn.silu`` on a bf16 array (x / (1 + exp(-x)) as exp, add,
    reciprocal and product, each rounded); else ``F.silu``."""
    if x.dtype == torch.bfloat16:
        return x * (1.0 / (1.0 + torch.exp(-x)))
    return F_.silu(x)


def linear(lin: nn.Linear, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """``lin(x)`` (``F.linear``, as ``nn.Linear.forward``); with a compute
    ``dtype``, flax's ``Dense(dtype=...)``:
    input, weight and bias cast to it, the product rounded to it, then the
    bias added (a second rounding). The parameters stay in their own
    dtype; their gradients come back through the casts."""
    if dtype is None:
        return F_.linear(x, lin.weight, lin.bias)  # nn.Linear.forward
    y = F_.linear(x.to(dtype), lin.weight.to(dtype))
    return y if lin.bias is None else y + lin.bias.to(dtype)


class ShiftedSoftplus(nn.Module):
    """Parameter-free module, so ``mlp.{0,2}`` keep the reference's indices."""

    def forward(self, x):
        return shifted_softplus(x)


def rbf_offsets(start: float, stop: float, num_gaussians: int, dtype,
                device) -> tuple:
    """(μ_k = linspace(start, stop) [num_gaussians], -0.5/Δ² as a 0-dim
    tensor), both of ``dtype``: the basis of :func:`gaussian_smearing`."""
    offset = torch.linspace(start, stop, num_gaussians, dtype=dtype,
                            device=device)
    return offset, -0.5 / (offset[1] - offset[0]) ** 2


def gaussian_smearing(dist: torch.Tensor, start: float, stop: float,
                      num_gaussians: int) -> torch.Tensor:
    """exp(-0.5/Δ² (d - μ_k)²) with μ_k = linspace(start, stop); appends a
    trailing axis of size ``num_gaussians``. (The kernels make the offsets as
    start + Δ·k in f32, about 1 ulp from ``linspace``, up to 64 Gaussians;
    above, they read these, ``ops/cfconv._rbf_table``.)"""
    offset, coeff = rbf_offsets(start, stop, num_gaussians, dist.dtype,
                                dist.device)
    diff = dist[..., None] - offset
    return torch.exp(coeff * diff * diff)


def cosine_envelope(dist: torch.Tensor, cutoff: float) -> torch.Tensor:
    """SchNet's CFConv envelope, with no hard gate: callers mask by the
    adjacency."""
    return 0.5 * (torch.cos(dist * math.pi / cutoff) + 1.0)


def jax_linspace(stop: float, num: int, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """``jnp.linspace(0, stop, num, dtype=dtype)`` as XLA compiles it, bit
    for bit in f32: entry k is k * (stop * (1 / (num - 1))) in ``dtype``,
    the last ``stop`` itself. (``torch.linspace`` differs from it by an ulp
    on some f32 entries, which PaiNN's f32 offsets would carry into the f64
    parity of the plain versions.) The step is rounded on the host and
    nothing is copied to the device, so a CUDA graph can capture it."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    unit = np_dtype.type(stop) * (np_dtype.type(1.0)
                                  / np_dtype.type(num - 1))
    k = torch.arange(num - 1, dtype=dtype, device=device)
    last = torch.full((1,), stop, dtype=dtype, device=device)
    return torch.cat([k * float(unit), last])


def gaussian_rbf(dist: torch.Tensor, offsets: torch.Tensor,
                 widths: torch.Tensor) -> torch.Tensor:
    """PaiNN's Gaussian RBF with per-basis widths: exp(-0.5/w² (d - μ)²)."""
    coeff = -0.5 / (widths * widths)
    diff = dist[..., None] - offsets
    return torch.exp(coeff * diff * diff)


def cosine_cutoff(dist: torch.Tensor, cutoff: float) -> torch.Tensor:
    """Behler cosine cutoff with the hard ``d < cutoff`` gate (PaiNN's; not
    SchNet's :func:`cosine_envelope`, which has no gate)."""
    env = 0.5 * (torch.cos(dist * math.pi / cutoff) + 1.0)
    return env * (dist < cutoff).to(dist.dtype)


class Dense(nn.Linear):
    """Linear layer with an optional activation (the reference's
    ``painn_utils.Dense``: state_dict keys ``weight``/``bias``), in the
    compute ``dtype`` when one is set (:func:`linear`)."""

    def __init__(self, n_in: int, n_out: int, bias: bool = True,
                 activation=None, dtype=None):
        super().__init__(n_in, n_out, bias=bias)
        self.activation = activation
        self.dtype = dtype

    def forward(self, x):
        y = linear(self, x, self.dtype)
        return y if self.activation is None else self.activation(y)


def halving_mlp_dims(n_in: int, n_out: int, n_layers: int = 2) -> list:
    """Layer widths of PaiNN's ``build_mlp`` with no hidden width given:
    halving from ``n_in``, floored at ``n_out``."""
    c, dims = n_in, []
    for _ in range(n_layers):
        dims.append(c)
        c = max(n_out, c // 2)
    dims.append(n_out)
    return dims[1:]


class HalvingMLP(nn.Sequential):
    """PaiNN's output head (``create_output_layers``): Dense layers of
    halving width, silu on all but the last; keys ``0.*``, ``1.*``, ..."""

    def __init__(self, n_in: int, n_out: int, n_layers: int = 2,
                 generator: Optional[torch.Generator] = None):
        dims = halving_mlp_dims(n_in, n_out, n_layers)
        widths = [n_in] + dims
        layers = [Dense(a, b, activation=torch.nn.functional.silu
                        if k < len(dims) - 1 else None)
                  for k, (a, b) in enumerate(zip(widths[:-1], widths[1:]))]
        super().__init__(*layers)
        for lin in layers:
            init_linear_(lin, generator)


def xavier_uniform_(weight: torch.Tensor,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
    """Glorot-uniform init of a ``[out, in]`` weight (the bound is symmetric
    in fan-in and fan-out, so the ``[in, out]`` layout gives the same law)."""
    fan_out, fan_in = weight.shape
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return weight.uniform_(-bound, bound, generator=generator)


def init_linear_(lin: nn.Linear, generator: Optional[torch.Generator]) -> None:
    """Xavier-uniform weight, zero bias."""
    xavier_uniform_(lin.weight, generator)
    if lin.bias is not None:
        with torch.no_grad():
            lin.bias.zero_()


def normal_(weight: torch.Tensor,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """N(0, 1) init (the embedding table)."""
    with torch.no_grad():
        return weight.normal_(0.0, 1.0, generator=generator)
