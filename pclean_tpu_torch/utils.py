"""Log-space helpers, device resolution and index helpers over torch tensors.

Counterpart of pclean_tpu/utils.py. The JAX package's gathers clamp
out-of-range indices and its scatters (`mode="drop"`) wrap an index in
[-C, -1] to the end of the target and drop the rest of those outside
[0, C); torch raises on both, so the port routes every gather that can see
a padded index through `take` and every dropping scatter through
`scatter_add_drop` / `scatter_max_drop` / `index_set_drop`, which follow
JAX's rule with a fixed shape: each dropped entry goes to one extra slot of
a target one longer, sliced off after, so nothing waits for the card to
count the entries kept. `take` clamps, as JAX's gather does for an
index >= 0; JAX's wraps a negative index first, and no path of the port
makes one (tests/test_torch_rel_kernels.py), so the two agree.
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


def log_normalize(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """logits - logsumexp(logits): normalized log-probabilities."""
    return logits - logsumexp(logits, dim=dim, keepdim=True)


def effective_sample_size(log_normalized_weights: torch.Tensor,
                          dim: int = -1) -> torch.Tensor:
    """ESS of normalized log weights (reference row_inference.jl:82-85)."""
    return torch.exp(-logsumexp(2.0 * log_normalized_weights, dim=dim))


def gather_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """An index into n entries clamped into [0, n), as JAX's gather clamps
    one >= 0 (JAX wraps a negative index first, which no path of the port
    makes)."""
    return idx.long().clamp(0, n - 1)


def take(x: torch.Tensor, idx) -> torch.Tensor:
    """x[idx] along dim 0 with out-of-range indices clamped (JAX gather)."""
    if not torch.is_tensor(idx):
        idx = torch.as_tensor(idx, device=x.device)
    return x[gather_index(idx, x.shape[0])]


def chase(hops) -> torch.Tensor:
    """An fk chain's target per source row: t = hops[0], then t =
    hops[h][t] for each later hop (the fk columns in the order they are
    followed), indices clamped like the JAX gathers."""
    t = hops[0]
    for col in hops[1:]:
        t = take(col, t)
    return t


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


def drop_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's mode="drop" rule for a scatter into n entries, as an int64
    index into n + 1: an index in [-n, -1] wraps to idx + n, one in [0, n)
    stays, every other goes to n (the extra slot the helpers slice off)."""
    idx = idx.long().reshape(-1)
    idx = torch.where(idx < 0, idx + n, idx)
    return torch.where((idx < 0) | (idx >= n), torch.full_like(idx, n), idx)


def _padded(target: torch.Tensor) -> torch.Tensor:
    """target with one extra row at the end along dim 0 (zeros)."""
    return torch.cat([target, target.new_zeros((1,) + target.shape[1:])])


def _vals(target: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    vals = torch.as_tensor(vals, device=target.device, dtype=target.dtype)
    if vals.dim() == 0:
        return vals.expand(idx.shape + target.shape[1:])
    return vals.reshape(idx.shape + target.shape[1:])


def scatter_add_drop(target: torch.Tensor, idx: torch.Tensor,
                     vals) -> torch.Tensor:
    """target.at[idx].add(vals, mode="drop") along dim 0 (out of place)."""
    n = target.shape[0]
    idx = drop_index(idx, n)
    return _padded(target).index_add_(0, idx, _vals(target, idx, vals))[:n]


def scatter_max_drop(target: torch.Tensor, idx: torch.Tensor,
                     vals: torch.Tensor) -> torch.Tensor:
    """target.at[idx].max(vals, mode="drop") along dim 0 (out of place)."""
    n = target.shape[0]
    idx = drop_index(idx, n)
    vals = vals.to(target.dtype).reshape(-1).expand(idx.shape)
    return _padded(target).scatter_reduce_(0, idx, vals, reduce="amax",
                                           include_self=True)[:n]


def index_set_drop(target: torch.Tensor, idx: torch.Tensor,
                   vals) -> torch.Tensor:
    """target.at[idx].set(vals, mode="drop") along dim 0 (out of place).
    Callers pass distinct indices; duplicates have no defined winner, as in
    JAX."""
    n = target.shape[0]
    idx = drop_index(idx, n)
    return _padded(target).index_copy_(0, idx, _vals(target, idx, vals))[:n]


def index_set_where(target: torch.Tensor, idx: torch.Tensor, vals,
                    ok) -> torch.Tensor:
    """target.at[idx].set(where(ok, vals, target[idx]), mode="drop") along
    dim 0 (out of place), the kept value read at the index the drop rule
    wraps to, as JAX's gather reads target[idx] there."""
    n = target.shape[0]
    idx = drop_index(idx, n)
    pad = _padded(target)
    new = torch.where(ok, _vals(target, idx, vals), pad[idx])
    return pad.index_copy_(0, idx, new)[:n]
