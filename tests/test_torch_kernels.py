"""The port's three hand kernels: plain versions against their JAX
counterparts (CPU), and CUDA kernels against the plain versions (card only).

  K1 enum_logsumexp — pclean_tpu.utils.logsumexp over concat([exist, new])
     (propose.py score_fk / score_choice): rtol 1e-6, the same f32 formula
     summed in another order; the finite NEG_INF rules exactly.
  K2 inv_cdf_sample — pclean_tpu.engine.propose._inv_cdf_from_u fed the same
     uniforms: equal indices, dead (NEG_INF) entries never drawn.
  K3 obs_gather_sum — sum of AddTypos gathers M_c[obs_c, word_c], and the
     one-hot contraction of _matmul_obs_term/_mm_flush: rtol 1e-5.

The CUDA tests carry the `cuda` marker and skip where no card is present;
run them on the card with `python -m pytest -m cuda tests/test_torch_kernels.py`.
The JAX package is imported inside the CPU tests only, so the module also
loads where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from pclean_tpu_torch import ops
from pclean_tpu_torch.utils import NEG_INF


def _logits(rng, R, K, dead=0.3):
    x = rng.normal(0.0, 3.0, size=(R, K)).astype(np.float32)
    x[rng.random((R, K)) < dead] = NEG_INF
    x[0, :] = NEG_INF  # an all-dead row
    return x


def test_k1_plain_matches_jax_logsumexp():
    import jax.numpy as jnp
    from pclean_tpu.utils import logsumexp as jlogsumexp

    rng = np.random.default_rng(0)
    ex = _logits(rng, 64, 257)
    new = rng.normal(size=64).astype(np.float32)
    new[0] = NEG_INF
    rec, lz = ops.enum_logsumexp_plain(torch.as_tensor(ex),
                                       torch.as_tensor(new))
    cat = jnp.concatenate([jnp.asarray(ex), jnp.asarray(new)[:, None]], -1)
    np.testing.assert_array_equal(rec.numpy(), np.asarray(cat))
    np.testing.assert_allclose(lz.numpy(), np.asarray(jlogsumexp(cat, -1)),
                               rtol=1e-6)
    rec2, lz2 = ops.enum_logsumexp_plain(torch.as_tensor(ex))
    assert rec2.data_ptr() == torch.as_tensor(ex).data_ptr() or \
        np.array_equal(rec2.numpy(), ex)
    np.testing.assert_allclose(lz2.numpy(),
                               np.asarray(jlogsumexp(jnp.asarray(ex), -1)),
                               rtol=1e-6)


def test_k2_plain_matches_jax_inv_cdf():
    import jax
    import jax.numpy as jnp
    from pclean_tpu.engine.propose import _inv_cdf_from_u

    rng = np.random.default_rng(1)
    lg = _logits(rng, 256, 130)
    lg[0, 5] = 0.0  # row 0: one live entry
    lg[:, 0] = NEG_INF  # a dead leading slot
    u = np.array(jax.random.uniform(jax.random.PRNGKey(3), (256,)))
    u[1] = 0.0  # the threshold edge: must not draw dead index 0
    got = ops.inv_cdf_sample_plain(torch.as_tensor(lg), torch.as_tensor(u))
    want = np.asarray(jax.vmap(_inv_cdf_from_u)(jnp.asarray(u),
                                                 jnp.asarray(lg)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == 5 and (got != 0).all()
    assert (lg[np.arange(256), got.numpy()] > NEG_INF / 2).all()


def test_k3_plain_matches_jax_gather_and_onehot():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    Vs = [40, 17, 9]
    mats = [rng.normal(size=(v, v)).astype(np.float32) for v in Vs]
    B, K = 32, 50
    obs = np.stack([rng.integers(0, v, size=B) for v in Vs], 1).astype(np.int32)
    word = np.stack([rng.integers(0, v, size=K) for v in Vs]).astype(np.int32)
    got = ops.obs_gather_sum_plain([torch.as_tensor(m) for m in mats],
                                   torch.as_tensor(obs), torch.as_tensor(word))
    # the JAX eager gather path: one M[obs, word] term per column
    gather = sum(jnp.asarray(m)[jnp.asarray(obs[:, c])[:, None],
                                jnp.asarray(word[c])[None, :]]
                 for c, m in enumerate(mats))
    np.testing.assert_allclose(got.numpy(), np.asarray(gather), rtol=1e-5,
                               atol=1e-5)
    # the _mm_flush form: concat(onehot(obs)) @ concat(T_c[o, k])
    oh = jnp.concatenate([jax.nn.one_hot(obs[:, c], v) for c, v in
                          enumerate(Vs)], -1)
    T = jnp.concatenate([jnp.asarray(m)[:, word[c]] for c, m in
                         enumerate(mats)], 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(oh @ T), rtol=1e-5,
                               atol=1e-4)


def test_wrappers_take_plain_version_on_cpu_without_counting():
    ops.reset_counts()
    x = torch.zeros((2, 3))
    ops.enum_logsumexp(x, torch.zeros(2))
    ops.inv_cdf_sample(x, torch.zeros(2))
    ops.obs_gather_sum([torch.zeros((3, 3))], torch.zeros((2, 1), dtype=torch.int32),
                       torch.zeros((1, 3), dtype=torch.int32))
    assert all(v == 0 for v in ops.LAUNCHES.values())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    ops.build_kernels()
    return torch.device("cuda")


@pytest.mark.cuda
def test_k1_cuda_matches_plain(card):
    rng = np.random.default_rng(5)
    ex = torch.as_tensor(_logits(rng, 300, 11265), device=card)
    new = torch.as_tensor(rng.normal(size=300).astype(np.float32), device=card)
    r0, z0 = ops.enum_logsumexp_plain(ex, new)
    r1, z1 = ops.enum_logsumexp(ex, new)
    torch.cuda.synchronize()
    assert torch.equal(r0, r1)
    torch.testing.assert_close(z1, z0, rtol=1e-6, atol=0)
    _r, z2 = ops.enum_logsumexp(ex)
    torch.testing.assert_close(z2, ops.enum_logsumexp_plain(ex)[1], rtol=1e-6,
                               atol=0)


@pytest.mark.cuda
def test_k2_cuda_matches_plain(card):
    rng = np.random.default_rng(6)
    lg = torch.as_tensor(_logits(rng, 4096, 1473), device=card)
    u = torch.rand(4096, device=card)
    a = ops.inv_cdf_sample(lg, u)
    b = ops.inv_cdf_sample_plain(lg, u)
    torch.cuda.synchronize()
    assert (a != b).float().mean().item() <= 1e-2
    picked = lg.gather(1, a.long()[:, None])[:, 0]
    assert bool((picked[1:] > NEG_INF / 2).all())


@pytest.mark.cuda
def test_k3_cuda_matches_plain(card):
    rng = np.random.default_rng(7)
    Vs = [300, 120, 40]
    mats = [torch.as_tensor(rng.normal(size=(v, v)).astype(np.float32),
                            device=card) for v in Vs]
    obs = torch.as_tensor(np.stack([rng.integers(0, v, 513) for v in Vs], 1)
                          .astype(np.int32), device=card)
    word = torch.as_tensor(np.stack([rng.integers(0, v, 1000) for v in Vs])
                           .astype(np.int32), device=card)
    a = ops.obs_gather_sum(mats, obs, word)
    b = ops.obs_gather_sum_plain(mats, obs, word)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
