"""Log-space helpers, device resolution and index helpers over torch tensors.

Counterpart of pclean_tpu/utils.py. The JAX package's gathers clamp
out-of-range indices and its scatters (`mode="drop"`) drop them; torch raises
on both, so the port routes every gather that can see a padded index through
`take` and every dropping scatter through `scatter_add_drop` /
`scatter_max_drop` / `index_set_drop`. Indices in this package are never
negative, so clamping and wrapping agree.
"""
from __future__ import annotations

import torch

# Large-but-finite stand-in for -Inf inside masked reductions (the reference
# uses -1e5 as its "IMPOSSIBLE" score, add_typos.jl:34).
NEG_INF = -1e30
IMPOSSIBLE = -1e5


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. `None` and "cuda" mean the card;
    with no card this raises rather than falling back to the CPU, so only a
    caller that asks for "cpu" gets it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pclean_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    return dev


def logsumexp(logits: torch.Tensor, dim: int = -1,
              keepdim: bool = False) -> torch.Tensor:
    """Stable logsumexp with pclean_tpu.utils.logsumexp's finite-NINF rules:
    the max is floored at NEG_INF, so an all-NEG_INF row gives ~NEG_INF, not
    NaN."""
    m = torch.amax(logits, dim=dim, keepdim=True)
    m = torch.clamp(m, min=NEG_INF)
    out = torch.log(torch.sum(torch.exp(logits - m), dim=dim,
                              keepdim=True)) + m
    out = torch.where(torch.isfinite(m) | (m > NEG_INF / 2), out,
                      torch.full_like(out, NEG_INF))
    if not keepdim:
        out = out.squeeze(dim)
    return out


def take(x: torch.Tensor, idx) -> torch.Tensor:
    """x[idx] along dim 0 with out-of-range indices clamped (JAX gather)."""
    if not torch.is_tensor(idx):
        idx = torch.as_tensor(idx, device=x.device)
    return x[idx.long().clamp(0, x.shape[0] - 1)]


def bgather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row-wise gather: out[b, ...] = table[b][idx[b, ...]] for a per-row
    table [Bt, V] and an index of rank >= 1 whose dim 0 is Bt or 1. A table
    with Bt == 1 is shared by every row. Out-of-range indices clamp."""
    if table.shape[0] == 1:
        return take(table[0], idx)
    B = table.shape[0]
    shp = torch.broadcast_shapes(idx.shape, (B,) + (1,) * (idx.dim() - 1))
    flat = idx.long().clamp(0, table.shape[1] - 1).expand(shp).reshape(B, -1)
    return torch.gather(table, 1, flat).reshape(shp)


def scatter_add_drop(target: torch.Tensor, idx: torch.Tensor,
                     vals) -> torch.Tensor:
    """target.at[idx].add(vals, mode="drop") along dim 0 (out of place)."""
    idx = idx.long().reshape(-1)
    vals = torch.as_tensor(vals, device=target.device, dtype=target.dtype)
    vals = vals.expand(idx.shape) if vals.dim() == 0 else vals.reshape(-1)
    ok = (idx >= 0) & (idx < target.shape[0])
    return target.index_add(0, idx[ok], vals[ok])


def scatter_max_drop(target: torch.Tensor, idx: torch.Tensor,
                     vals: torch.Tensor) -> torch.Tensor:
    """target.at[idx].max(vals, mode="drop") along dim 0 (out of place)."""
    idx = idx.long().reshape(-1)
    vals = vals.to(target.dtype).reshape(-1).expand(idx.shape)
    ok = (idx >= 0) & (idx < target.shape[0])
    return target.scatter_reduce(0, idx[ok], vals[ok], reduce="amax",
                                 include_self=True)


def index_set_drop(target: torch.Tensor, idx: torch.Tensor,
                   vals) -> torch.Tensor:
    """target.at[idx].set(vals, mode="drop") along dim 0 (out of place).
    Callers pass distinct in-range indices; duplicates have no defined
    winner, as in JAX."""
    idx = idx.long().reshape(-1)
    vals = torch.as_tensor(vals, device=target.device, dtype=target.dtype)
    vals = vals.expand(idx.shape) if vals.dim() == 0 else vals.reshape(-1)
    ok = (idx >= 0) & (idx < target.shape[0])
    out = target.clone()
    out[idx[ok]] = vals[ok]
    return out


def sample_gamma(gen: torch.Generator, alpha: torch.Tensor) -> torch.Tensor:
    """Gamma(alpha, 1) draws from an explicit generator (Marsaglia-Tsang with
    the alpha < 1 boost); torch's own gamma sampler takes no generator."""
    alpha = alpha.to(torch.float32)
    boost = alpha < 1.0
    a = torch.where(boost, alpha + 1.0, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros_like(a)
    todo = torch.ones_like(a, dtype=torch.bool)
    while bool(todo.any()):
        x = torch.randn(a.shape, generator=gen, device=a.device)
        u = torch.rand(a.shape, generator=gen, device=a.device)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u.clamp_min(1e-38)) <
                        0.5 * x * x + d - d * v +
                        d * torch.log(v.clamp_min(1e-38)))
        take_ = todo & ok
        out = torch.where(take_, d * v, out)
        todo = todo & ~ok
    u = torch.rand(a.shape, generator=gen, device=a.device)
    return torch.where(boost, out * u.clamp_min(1e-38) ** (1.0 / alpha), out)


def sample_dirichlet(gen: torch.Generator, conc: torch.Tensor) -> torch.Tensor:
    """Dirichlet(conc) along the last axis, from gamma draws."""
    g = sample_gamma(gen, conc)
    return g / g.sum(dim=-1, keepdim=True)
