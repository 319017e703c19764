"""Per-choice-node distribution kernels: dense tables + tensor closures.

Counterpart of pclean_tpu/engine/kernels.py (kernels.py:48-474, 690-707),
for the distributions of the port's scaled, rents and flights paths.
Each ChoiceNode gets a DistKernel at model-compile time:

  * enum_logits  — the discrete proposal as a dense (masked) log-weight
                   vector over the node's Domain (reference
                   `discrete_proposal`, e.g. choose_proportionally.jl:15-17,
                   string_prior.jl:16-22);
  * obs_logdensity / missing_logdensity — vectorized `logdensity`;
  * sample_prior — `random` for non-enumerable nodes left to the prior
    (enumerable kernels are never sampled from their prior: the tracer
    enumerates them).

Dynamic arguments arrive through a ctx supplied by the proposal tracer:
ctx.value(vid) (another vertex's value, already aligned to the enumeration
axes and carrying the batch axis first) and ctx.pstate(cid, vid) (parameter
state). Host tables are numpy; `cm.use` hands out their device tensors.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import ops
from ..dists.core import (AddNoise, AddTypos, ChooseProportionally,
                          ChooseUniformly, MaybeSwap, StringPrior, TimePrior,
                          Transformation, TransformedGaussian, Unmodeled,
                          residual_dummy_logit)
from ..domains import CATEGORICAL
from ..model.ir import ChoiceNode, ClassID, ParameterNode, VertexID
from ..strings import typos_logdensity_matrix
from ..utils import NEG_INF

NINF = float(NEG_INF)


class DistKernel:
    enumerable = False
    supports_missing = False
    V: Optional[int] = None  # domain size for categorical-valued nodes
    dummy_code: Optional[int] = None
    # False for kernels whose sample_prior is deterministic (modal)
    prior_needs_key = True

    def __init__(self, cm):
        self._use = cm.use
        self._const = cm.const
        self.device = cm.device

    def enum_logits(self, ctx):  # -> [*, V]
        raise NotImplementedError

    def obs_logdensity(self, ctx, obs):  # obs: code or float tensor
        raise NotImplementedError

    def missing_logdensity(self, ctx):
        return 0.0

    def sample_prior(self, ctx, gen):
        raise NotImplementedError(f"{type(self).__name__} cannot be sampled")


def build_kernel(cm, cid: ClassID, vid: VertexID, node: ChoiceNode) -> DistKernel:
    d = node.dist
    if isinstance(d, ChooseProportionally):
        return _ChooseProportionallyK(cm, cid, vid, node)
    if isinstance(d, ChooseUniformly):
        return _ChooseUniformlyK(cm, cid, vid, node)
    if isinstance(d, StringPrior):
        return _StringPriorK(cm, cid, vid, node)
    if isinstance(d, TimePrior):
        return _TimePriorK(cm, cid, vid, node)
    if isinstance(d, AddTypos):
        return _AddTyposK(cm, cid, vid, node)
    if isinstance(d, MaybeSwap):
        return _MaybeSwapK(cm, cid, vid, node)
    if isinstance(d, (AddNoise, TransformedGaussian)):
        return _GaussianK(cm, cid, vid, node)
    if isinstance(d, Unmodeled):
        return _UnmodeledK(cm, cid, vid, node)
    raise TypeError(f"{type(d).__name__} is not ported yet")


class _ChooseProportionallyK(DistKernel):
    """choose_proportionally.jl: weights either a static vector (raw,
    unnormalized logs — the reference's `logprobs` does not normalize) or a
    learned ProportionsParameter (normalized Dirichlet draw)."""

    enumerable = True

    def __init__(self, cm, cid, vid, node):
        super().__init__(cm)
        dom = cm.domain(cid, vid)
        self.V = dom.size
        self.node = node
        self.param_key = None
        probs = node.dist.probs
        options = node.dist.options
        assert "options" not in node.arg_ids or "probs" not in node.arg_ids, \
            "dynamic options with learned probs unsupported"
        if "probs" in node.arg_ids:
            pv = node.arg_ids["probs"]
            assert isinstance(cm.node(cid, pv), ParameterNode)
            self.param_key = cm.canon(cid, pv)
            # the Dirichlet axis spans the option codes (a prefix of the
            # domain, which ingest may have extended with observed values)
            self.num_options = len({dom.vocab.encode(o) for o in options}) \
                if options is not None else self.V
        else:
            w = np.full(self.V, -np.inf, dtype=np.float32)
            probs = np.asarray(probs, dtype=np.float64)
            for pos, o in enumerate(options):
                code = dom.vocab.encode(o)
                cur = w[code]
                w[code] = np.logaddexp(cur, math.log(probs[pos])) \
                    if np.isfinite(cur) else math.log(probs[pos])
            self.static_logw = w

    def _logw(self, ctx):
        if self.param_key is None:
            return self._use(self.static_logw)
        logv = ctx.pstate(*self.param_key)["log_value"][0]  # [num_options]
        pad = self.V - logv.shape[0]
        if pad > 0:
            logv = torch.cat([logv, torch.full((pad,), NINF, dtype=logv.dtype,
                                               device=logv.device)])
        return logv

    def enum_logits(self, ctx):
        return self._logw(ctx)

    def obs_logdensity(self, ctx, obs):
        return self._logw(ctx)[obs.long()]


class _ChooseUniformlyK(DistKernel):
    """choose_uniformly.jl: logdensity = -log(n) *assuming the observation is
    possible* — a constant, even off-support (reference lines 7-10)."""

    enumerable = True

    def __init__(self, cm, cid, vid, node):
        super().__init__(cm)
        dom = cm.domain(cid, vid)
        self.V = dom.size
        self.node = node
        self.dynamic = "options" in node.arg_ids
        if self.dynamic:
            lk = cm.canon(cid, node.arg_ids["options"])
            reg = cm.list_reg[lk]
            self.mask = reg.mask_matrix()  # [L, V]
            self.lens = np.maximum(reg.lengths(), 1)
        else:
            options = node.dist.options
            m = np.zeros(self.V, dtype=bool)
            for o in options:
                m[dom.vocab.encode(o)] = True
            self.mask = m
            self.n = max(len(set(dom.vocab.encode(o) for o in options)), 1)
            self.n_raw = max(len(options), 1)

    def enum_logits(self, ctx):
        if self.dynamic:
            lc = ctx.value(self.node.arg_ids["options"]).long()
            m = self._use(self.mask)[lc]  # [*, V]
            n = self._use(self.lens)[lc].to(torch.float32)
            return torch.where(m, -torch.log(n)[..., None],
                               torch.full_like(n[..., None], NINF))
        mask = self._use(self.mask)
        return torch.where(mask, torch.full(mask.shape, -math.log(self.n_raw),
                                            device=mask.device),
                           torch.full(mask.shape, NINF, device=mask.device))

    def obs_logdensity(self, ctx, obs):
        if self.dynamic:
            lc = ctx.value(self.node.arg_ids["options"]).long()
            n = self._use(self.lens)[lc].to(torch.float32)
            return -torch.log(n) + 0.0 * obs
        return torch.full(obs.shape, -math.log(self.n_raw),
                          dtype=torch.float32, device=obs.device)


class _AtomPriorK(DistKernel):
    """Per-atom scores + residual-mass dummy (string_prior.jl:16-26)."""

    enumerable = True

    def __init__(self, cm, cid, vid, node, score_vec: np.ndarray):
        super().__init__(cm)
        dom = cm.domain(cid, vid)
        self.V = dom.size
        self.node = node
        self.dummy_code = cm.dummy_code[(cid, vid)]
        self.score_vec = score_vec.astype(np.float32)
        self.dynamic = "atoms" in node.arg_ids
        if self.dynamic:
            lk = cm.canon(cid, node.arg_ids["atoms"])
            reg = cm.list_reg[lk]
            mask = reg.mask_matrix()  # [L, V]
            L = mask.shape[0]
            enum = np.full((L, self.V), -np.inf, dtype=np.float64)
            for l in range(L):
                enum[l, mask[l]] = score_vec[mask[l]]
                enum[l, self.dummy_code] = residual_dummy_logit(enum[l])
            self.enum_mat = enum.astype(np.float32)
        else:
            atoms = self._static_atoms()
            enum = np.full(self.V, -np.inf, dtype=np.float64)
            codes = [dom.vocab.encode(a) for a in atoms]
            enum[codes] = score_vec[codes]
            enum[self.dummy_code] = residual_dummy_logit(enum)
            self.enum_vec = enum.astype(np.float32)

    def _static_atoms(self):
        raise NotImplementedError

    def enum_logits(self, ctx):
        if self.dynamic:
            lc = ctx.value(self.node.arg_ids["atoms"]).long()
            return self._use(self.enum_mat)[lc]
        return self._use(self.enum_vec)

    def obs_logdensity(self, ctx, obs):
        return self._use(self.score_vec)[obs.long()]


class _StringPriorK(_AtomPriorK):
    def __init__(self, cm, cid, vid, node):
        dom = cm.domain(cid, vid)
        d = node.dist
        sv = np.array([cm.lm.logdensity(v, d.min_length, d.max_length)
                       if isinstance(v, str) else -np.inf
                       for v in dom.vocab.values])
        self._atoms_arg = d.atoms
        super().__init__(cm, cid, vid, node, sv)

    def _static_atoms(self):
        return self._atoms_arg


class _TimePriorK(_AtomPriorK):
    def __init__(self, cm, cid, vid, node):
        dom = cm.domain(cid, vid)
        d = node.dist
        sv = np.array([TimePrior.atom_logprob(v) if isinstance(v, str)
                       else -np.inf for v in dom.vocab.values])
        self._atoms_arg = d.atoms
        super().__init__(cm, cid, vid, node, sv)
        # the reference's logdensity is -log(1440) for *any* observed string
        # (time_prior.jl:25-27): keep the constant for observed scoring
        self.score_vec = np.full((self.V,), -math.log(1440.0),
                                 dtype=np.float32)

    def _static_atoms(self):
        return self._atoms_arg


class _AddTyposK(DistKernel):
    """Dense [V, V] typo-likelihood matrix over the shared source/observed
    vocabulary (add_typos.jl:50-66 computed eagerly for all pairs). The
    observed-column terms it contributes to the Record enumeration are
    summed by the obs_gather_sum kernel (ops.py), one launch per sibling
    group of statically observed AddTypos columns."""

    supports_missing = True

    def __init__(self, cm, cid, vid, node):
        super().__init__(cm)
        dom = cm.domain(cid, vid)
        self.V = dom.size
        self.node = node
        strs = [v if isinstance(v, str) else str(v) for v in dom.vocab.values]
        self.M = typos_logdensity_matrix(strs, strs, node.dist.max_typos)

    def obs_logdensity(self, ctx, obs):
        word = ctx.value(self.node.arg_ids["word"])
        return self._use(self.M)[obs.long(), word.long()]

    def missing_logdensity(self, ctx):
        return 0.0  # add_typos.jl:51-53

    prior_needs_key = False

    def sample_prior(self, ctx, gen):
        # Modal (zero-typo) outcome, as the JAX package does
        # (pclean_tpu/engine/kernels.py:307-311): the reference's generative
        # typo process (add_typos.jl:36-45) only matters for unobserved
        # corrupted cells, which queries never read back.
        return ctx.value(self.node.arg_ids["word"])


class _MaybeSwapK(DistKernel):
    """maybe_swap.jl:13-28. options static or a list vertex sharing val's
    vocabulary; prob static, a learned Prob parameter, or a vertex (the
    flights model's gated indexed lookup)."""

    supports_missing = True

    def __init__(self, cm, cid, vid, node):
        super().__init__(cm)
        dom = cm.domain(cid, vid)
        self.V = dom.size
        self.node = node
        d = node.dist
        self.dynamic_opts = "options" in node.arg_ids
        if self.dynamic_opts:
            reg = cm.list_reg[cm.canon(cid, node.arg_ids["options"])]
            assert reg.domain.vocab is dom.vocab, \
                "MaybeSwap options and val must share a domain"
            self.mask = reg.mask_matrix()                         # [L, V]
            self.lens = np.maximum(reg.lengths(), 1)
        else:
            m = np.zeros(self.V, dtype=bool)
            for o in d.options:
                m[dom.vocab.encode(o)] = True
            self.mask = m
            self.n = max(len(d.options), 1)
        self.param_key = None
        self.prob_vid = None
        self.static_prob = None
        pv = node.arg_ids.get("prob")
        if pv is not None and isinstance(cm.node(cid, pv), ParameterNode):
            self.param_key = cm.canon(cid, pv)
        elif pv is not None:
            self.prob_vid = pv
        else:
            self.static_prob = float(d.prob)

    def _prob(self, ctx):
        if self.param_key is not None:
            return ctx.pstate(*self.param_key)["value"][0]
        if self.prob_vid is not None:
            return ctx.value(self.prob_vid)
        return self._const(self.static_prob)

    def _loglen(self, ctx):
        if self.dynamic_opts:
            lc = ctx.value(self.node.arg_ids["options"]).long()
            return torch.log(self._use(self.lens)[lc].to(torch.float32))
        return math.log(self.n)

    def _member_rows(self, ctx):
        """The options mask [*, V] (dynamic) or [V] (static)."""
        if self.dynamic_opts:
            lc = ctx.value(self.node.arg_ids["options"]).long()
            return self._use(self.mask)[lc]
        return self._use(self.mask)

    def obs_logdensity(self, ctx, obs):
        val = ctx.value(self.node.arg_ids["val"])
        p = self._prob(ctx)
        return torch.where(obs == val, torch.log1p(-p),
                           torch.log(p) - self._loglen(ctx))

    def missing_logdensity(self, ctx):
        # maybe_swap.jl:18-23: 0 if val in options else -1000
        val = ctx.value(self.node.arg_ids["val"]).long()
        if self.dynamic_opts:
            lc = ctx.value(self.node.arg_ids["options"]).long()
            member = self._use(self.mask)[lc, val]
        else:
            member = self._use(self.mask)[val]
        return torch.where(member, torch.zeros((), device=self.device),
                           torch.full((), -1000.0, device=self.device))

    def sample_prior(self, ctx, gen):
        """val, swapped with probability p for a uniform option: the option
        drawn by inverse CDF (K2) over the options mask, the swap by a
        uniform below p (the JAX package's categorical and bernoulli, from a
        torch.Generator)."""
        val = ctx.value(self.node.arg_ids["val"])
        p = torch.as_tensor(self._prob(ctx), dtype=torch.float32,
                            device=self.device)
        rows = self._member_rows(ctx)
        shape = torch.broadcast_shapes(val.shape, p.shape, rows.shape[:-1])
        logits = torch.where(rows, torch.zeros((), device=self.device),
                             torch.full((), NINF, device=self.device))
        logits = logits.expand(shape + (self.V,)).reshape(-1, self.V)
        u = torch.rand((logits.shape[0],), generator=gen, device=self.device)
        alt = ops.inv_cdf_sample(logits.contiguous(), u).reshape(shape)
        swap = torch.rand(shape, generator=gen, device=self.device) < p
        return torch.where(swap, alt, val.to(alt.dtype))


class _GaussianK(DistKernel):
    """AddNoise / TransformedGaussian (add_noise.jl:5-7,
    transformed_gaussian.jl:13-16). Float-valued; never enumerable. The mean
    is static, a learned Mean parameter, or a vertex (a ParamLookup of an
    indexed Mean); the transformation is static or a categorical vertex
    whose vocabulary holds Transformation objects."""

    def __init__(self, cm, cid, vid, node):
        super().__init__(cm)
        self.node = node
        d = node.dist
        self.std = d.std
        self.mean_vid = node.arg_ids.get("mean")
        self.mean_param_key = None
        if self.mean_vid is not None and \
                isinstance(cm.node(cid, self.mean_vid), ParameterNode):
            self.mean_param_key = cm.canon(cid, self.mean_vid)
            self.mean_vid = None
        self.static_mean = None if (self.mean_vid is not None or
                                    self.mean_param_key) else float(d.mean)
        self.transforms = None
        self.static_transform = None
        if isinstance(d, TransformedGaussian):
            tv = node.arg_ids.get("transform")
            if tv is None:
                self.static_transform = d.transform
            else:
                self.transform_vid = tv
                tdom = cm.domain(cid, tv)
                assert tdom.kind == CATEGORICAL
                self.transforms = list(tdom.vocab.values)
                assert all(isinstance(t, Transformation)
                           for t in self.transforms)

    def _mean(self, ctx):
        if self.mean_param_key is not None:
            return ctx.pstate(*self.mean_param_key)["value"][0]
        if self.mean_vid is not None:
            return ctx.value(self.mean_vid)
        return self.static_mean

    def _per_unit(self, ctx, fn, x):
        """fn(t, x) under the transformation of each value: the static one,
        or the one the transform vertex selects (broadcast over its axes)."""
        if self.static_transform is not None:
            return fn(self.static_transform, x)
        if self.transforms is None:
            return None
        tc = ctx.value(self.transform_vid).long().clamp(
            0, len(self.transforms) - 1)
        outs = torch.broadcast_tensors(
            *[fn(t, x) + torch.zeros_like(x) for t in self.transforms], tc)
        out = outs[0]
        for i in range(1, len(self.transforms)):
            out = torch.where(outs[-1] == i, outs[i], out)
        return out

    def backward(self, ctx, y):
        z = self._per_unit(ctx, lambda t, v: t.backward(v), y)
        return y if z is None else z

    def _log_abs_deriv(self, ctx, z):
        # `+ zeros_like`: a constant deriv comes back as a Python number
        out = self._per_unit(ctx, lambda t, v: torch.log(torch.abs(
            t.deriv(v) + torch.zeros_like(v))), z)
        return 0.0 if out is None else out

    def forward(self, ctx, x):
        y = self._per_unit(ctx, lambda t, v: t.forward(v), x)
        return x if y is None else y

    def obs_logdensity(self, ctx, obs):
        z = self.backward(ctx, obs.to(torch.float32))
        mean = self._mean(ctx)
        ll = -0.5 * ((z - mean) / self.std) ** 2 \
            - math.log(self.std) - 0.5 * math.log(2 * math.pi)
        return ll - self._log_abs_deriv(ctx, z)

    def sample_prior(self, ctx, gen):
        mean = torch.as_tensor(self._mean(ctx), dtype=torch.float32,
                               device=self.device)
        x = mean + self.std * torch.randn(mean.shape, generator=gen,
                                          device=self.device)
        return self.forward(ctx, x)


class _UnmodeledK(DistKernel):
    """unmodeled.jl: logdensity 0 for anything."""

    supports_missing = True
    prior_needs_key = False

    def __init__(self, cm, cid, vid, node):
        super().__init__(cm)
        self.V = cm.domain(cid, vid).size

    def obs_logdensity(self, ctx, obs):
        return torch.zeros(obs.shape, dtype=torch.float32, device=obs.device)

    def sample_prior(self, ctx, gen):
        return torch.zeros((), dtype=torch.int32, device=self.device)
