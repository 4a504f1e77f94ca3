"""The port's kernel modules against the JAX Pallas kernels.

Each plain PyTorch version in `repro_torch.kernels.ref` (what a CPU tensor
runs, and what the CUDA kernel is held to on the card) is compared with the
JAX package's Pallas kernel run in interpret mode, on the same numpy inputs
at fp32. The CUDA kernels themselves run only on the card: `chip_smoke.py`
holds each one to these plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


# ---------------------------------------------------------------------------
# #3 fused adapter + residual + norm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layernorm", [False, True])
@pytest.mark.parametrize("shape", [(2, 7, 64), (5, 256)])
def test_fused_adapter_norm_matches_pallas(shape, layernorm):
    d = shape[-1]
    x, res = _rand(shape, 1), _rand(shape, 2)
    w, b = 1 + _rand((d,), 3, 0.2), _rand((d,), 4, 0.2)
    scale = 1 + _rand((d,), 5, 0.2)
    bias = _rand((d,), 6, 0.2) if layernorm else None
    want = jops.fused_adapter_norm(
        jnp.asarray(x), jnp.asarray(res), jnp.asarray(w), jnp.asarray(b),
        jnp.asarray(scale), bias=None if bias is None else jnp.asarray(bias),
        eps=1e-6, impl="interpret")
    got = tops.fused_adapter_norm(_t(x), _t(res), _t(w), _t(b), _t(scale),
                                  bias=None if bias is None else _t(bias),
                                  eps=1e-6)
    for g, wt in zip(got, want):
        _close(g, wt, 1e-5)


# ---------------------------------------------------------------------------
# #4 flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gqa", [1, 2])
@pytest.mark.parametrize("kwargs", [
    dict(causal=True), dict(causal=True, window=8),
    dict(causal=True, cap=20.0), dict(causal=True, sq=16),
    dict(causal=False),
])
def test_flash_attention_matches_pallas(gqa, kwargs):
    kwargs = dict(kwargs)
    # lengths are multiples of the Pallas blocks: interpret mode reads
    # past the end of a ragged last block
    B, KH, S, D = 2, 2, 48, 16
    sq = kwargs.pop("sq", S)
    H = KH * gqa
    q = _rand((B, H, sq, D), 10)
    k, v = _rand((B, KH, S, D), 11), _rand((B, KH, S, D), 12)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), impl="interpret", block_q=16,
                                block_k=16, **kwargs)
    got = tops.flash_attention(_t(q), _t(k), _t(v), **kwargs)
    assert got.shape == (B, H, sq, D)
    _close(got, want, 2e-4)


# ---------------------------------------------------------------------------
# #5 paged decode attention
# ---------------------------------------------------------------------------


def _pool(seed, B=3, H=4, KH=2, D=16, page=8, nb=16, nbt=4, sq=1):
    r = np.random.default_rng(seed)
    qshape = (B, H, D) if sq == 1 else (B, H, sq, D)
    q = r.standard_normal(qshape).astype(np.float32)
    kp = r.standard_normal((nb, page, KH, D)).astype(np.float32)
    vp = r.standard_normal((nb, page, KH, D)).astype(np.float32)
    tables = r.choice(np.arange(1, nb), (B, nbt), replace=False).astype(
        np.int32)
    lens = r.integers(sq, nbt * page + 1, (B,)).astype(np.int32)
    return q, kp, vp, tables, lens


def _int8(pool):
    """Per-token absmax int8 over D with fp32 scales (the QTensor layout)."""
    s = np.maximum(np.abs(pool).max(-1, keepdims=True), 1e-8) / 127.0
    return np.clip(np.round(pool / s), -127, 127).astype(np.int8), \
        s.astype(np.float32)


@pytest.mark.parametrize("case", [
    dict(), dict(window=12), dict(window=8, cap=30.0), dict(int8=True),
    dict(int8=True, window=12), dict(sq=3), dict(sq=3, window=12),
])
def test_paged_attention_matches_pallas(case):
    sq = case.get("sq", 1)
    q, kp, vp, tables, lens = _pool(20 + sq, sq=sq)
    kw = dict(window=case.get("window"), cap=case.get("cap", 0.0))
    jkw, tkw = dict(kw), dict(kw)
    if case.get("int8"):
        kp, ks = _int8(kp)
        vp, vs = _int8(vp)
        jkw.update(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
        tkw.update(k_scales=_t(ks), v_scales=_t(vs))
    want = jops.paged_attention(jnp.asarray(q), jnp.asarray(kp),
                                jnp.asarray(vp), jnp.asarray(tables),
                                jnp.asarray(lens), impl="interpret", **jkw)
    got = tops.paged_attention(_t(q), _t(kp), _t(vp), _t(tables), _t(lens),
                               **tkw)
    assert got.dtype == torch.float32 and got.shape == q.shape
    _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# #6 multitask Hadamard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,d,T", [(4, 6, 32, 3), (2, 1, 128, 5)])
def test_multitask_hadamard_matches_pallas(B, S, d, T):
    x = _rand((B, S, d), 30)
    wb, bb = 1 + _rand((T, d), 31, 0.2), _rand((T, d), 32, 0.2)
    tids = (np.arange(B) * 2 % T).astype(np.int32)
    want = jops.multitask_hadamard(jnp.asarray(x), jnp.asarray(wb),
                                   jnp.asarray(bb), jnp.asarray(tids),
                                   impl="interpret")
    got = tops.multitask_hadamard(_t(x), _t(wb), _t(bb), _t(tids))
    _close(got, want, 1e-6)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    _build.reset_launches()
    x, res = _t(_rand((3, 32), 40)), _t(_rand((3, 32), 41))
    w, b, scale = torch.ones(32), torch.zeros(32), torch.ones(32)
    xn, h = tops.fused_adapter_norm(x, res, w, b, scale)
    ref = tops.fused_adapter_norm(x, res, w, b, scale, impl="ref")
    assert torch.equal(xn, ref[0]) and torch.equal(h, ref[1])
    assert all(v == 0 for v in _build.launch_counts().values())


@pytest.mark.parametrize("call", [
    lambda: tops.fused_adapter_norm(torch.zeros(2, 8), torch.zeros(2, 8),
                                    torch.ones(8), torch.zeros(8),
                                    torch.ones(8), impl="kernel"),
    lambda: tops.flash_attention(torch.zeros(1, 2, 4, 64),
                                 torch.zeros(1, 2, 4, 64),
                                 torch.zeros(1, 2, 4, 64), impl="kernel"),
    lambda: tops.paged_attention(torch.zeros(1, 2, 16), torch.zeros(2, 4, 2, 16),
                                 torch.zeros(2, 4, 2, 16),
                                 torch.zeros(1, 2, dtype=torch.int32),
                                 torch.ones(1, dtype=torch.int32),
                                 impl="kernel"),
    lambda: tops.multitask_hadamard(torch.zeros(1, 2, 8), torch.ones(2, 8),
                                    torch.zeros(2, 8),
                                    torch.zeros(1, dtype=torch.int32),
                                    impl="kernel"),
])
def test_kernel_impl_on_a_cpu_tensor_raises(call):
    with pytest.raises(ValueError, match="CUDA"):
        call()


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="impl"):
        tops.multitask_hadamard(torch.zeros(1, 2, 8), torch.ones(2, 8),
                                torch.zeros(2, 8),
                                torch.zeros(1, dtype=torch.int32),
                                impl="interpret")
