"""The port's Hadamard-affine kernels (#1, #2) and the autograd Functions
around its kernels against the JAX package.

The plain versions of #1 and #2 (what a CPU tensor runs, and what the CUDA
kernels are held to on the card) are compared with the Pallas kernels in
interpret mode. `HadamardAffine`, `FusedAdapterResidualNorm` and
`FlashAttention` run here with those plain versions inside, so their
backward passes are held to `jax.vjp` of the JAX custom VJPs (the Pallas
affine backward, the jnp norm VJP, the jnp flash backward) on the same
numpy inputs at fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import hadamard as jhad
from repro.models import flash as jflash
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels.attention import FlashAttention
from repro_torch.kernels.hadamard import (FusedAdapterResidualNorm,
                                          HadamardAffine)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close_rel(got, want, rel):
    """max |got - want| within `rel` of max |want| (sums over rows are
    taken in another order in the two packages)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


# ---------------------------------------------------------------------------
# #1 hadamard_affine and #2 its backward: plain versions against Pallas
# ---------------------------------------------------------------------------


# 300 rows: one whole 256-row Pallas block and a ragged one
@pytest.mark.parametrize("shape", [(300, 96), (3, 7, 64), (1, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hadamard_affine_matches_pallas(shape, dtype):
    d = shape[-1]
    x = _rand(shape, 1)
    w, b = 1 + _rand((d,), 2, 0.2), _rand((d,), 3, 0.2)
    want = jhad.hadamard_affine(jnp.asarray(x, dtype), jnp.asarray(w),
                                jnp.asarray(b), True)
    xt = _t(x).to(getattr(torch, dtype))
    got = tops.hadamard(xt, _t(w), _t(b))
    assert got.dtype == xt.dtype and got.shape == xt.shape
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    else:  # both round the fp32 result once; allow one bf16 ulp
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8,
                                   atol=1e-6)


# n not a multiple of the Pallas block rows (256 at these widths): the
# kernel's last block holds pad rows that its sums must mask. g and x fp32,
# then the pairs the port's trainers hand #2: g fp32 over x bf16 (the norm
# VJP's cotangent over the adapter's input) and bf16 over bf16
_AFFINE_BWD_SHAPES = [(300, 64), (513, 96), (5, 128)]


@pytest.mark.parametrize("n,d,g_dtype,x_dtype", [
    pytest.param(n, d, "float32", "float32", id=f"{n}-{d}")
    for n, d in _AFFINE_BWD_SHAPES] + [
    pytest.param(n, d, gdt, xdt, id=f"{n}-{d}-{gdt}-{xdt}")
    for n, d in _AFFINE_BWD_SHAPES
    for gdt, xdt in (("float32", "bfloat16"), ("bfloat16", "bfloat16"))])
def test_hadamard_affine_bwd_matches_pallas(n, d, g_dtype, x_dtype):
    assert n % jhad._block_rows(d)
    g = jnp.asarray(_rand((n, d), 10)).astype(g_dtype)
    x = jnp.asarray(_rand((n, d), 11)).astype(x_dtype)
    w = 1 + _rand((d,), 12, 0.2)
    want = jhad._affine_bwd_call(g, x, jnp.asarray(w), interpret=True)

    def torch_of(a, dtype):  # the same values, in the same dtype
        return _t(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype))

    got = tops.hadamard_affine_bwd(torch_of(g, g_dtype), torch_of(x, x_dtype),
                                   _t(w))
    assert got[0].dtype == getattr(torch, g_dtype)
    # dx = g*w in fp32, rounded once to g's dtype in both packages
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(want[0].astype(jnp.float32)),
                               atol=1e-6, rtol=0)
    for gt, wt in zip(got[1:], want[1:]):
        assert gt.dtype == torch.float32
        _close_rel(gt.numpy(), wt, 1e-5)


# ---------------------------------------------------------------------------
# autograd Functions against jax.vjp
# ---------------------------------------------------------------------------


def _grads(fn, inputs, cotangents):
    """Torch gradients of fn's outputs (cotangent None: the output is
    discarded) with respect to every input."""
    leaves = [_t(a).clone().requires_grad_(True) for a in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    kept = [(o, _t(c)) for o, c in zip(outs, cotangents) if c is not None]
    return torch.autograd.grad([o for o, _ in kept], leaves,
                               [c for _, c in kept])


def test_hadamard_affine_function_grads_match_jax():
    shape = (3, 100, 96)
    d = shape[-1]
    x, g = _rand(shape, 20), _rand(shape, 21)
    w, b = 1 + _rand((d,), 22, 0.2), _rand((d,), 23, 0.2)
    y, vjp = jax.vjp(lambda *a: jhad.hadamard_affine(*a, True),
                     *map(jnp.asarray, (x, w, b)))
    want = vjp(jnp.asarray(g))
    got = _grads(lambda *a: HadamardAffine.apply(*a, "auto"), (x, w, b), (g,))
    for gt, wt in zip(got, want):
        _close_rel(gt.numpy(), wt, 1e-5)
    np.testing.assert_allclose(
        HadamardAffine.apply(_t(x), _t(w), _t(b)).numpy(), np.asarray(y),
        atol=1e-6, rtol=0)


@pytest.mark.parametrize("layernorm,eps", [(True, 1e-12), (False, 1e-6)])
@pytest.mark.parametrize("with_g_xn", [True, False])
def test_fused_adapter_residual_norm_grads_match_jax(layernorm, eps,
                                                     with_g_xn):
    shape = (3, 50, 64)
    d = shape[-1]
    x, res = _rand(shape, 30), _rand(shape, 31)
    w, b = 1 + _rand((d,), 32, 0.2), _rand((d,), 33, 0.2)
    scale, bias = 1 + _rand((d,), 34, 0.2), _rand((d,), 35, 0.2)
    g_xn, g_h = _rand(shape, 36), _rand(shape, 37)
    inputs = (x, res, w, b, scale) + ((bias,) if layernorm else ())

    def jfn(*a):
        return jhad.fused_adapter_residual_norm(
            *a[:5], eps=eps, bias=a[5] if layernorm else None, interpret=True)

    _, vjp = jax.vjp(jfn, *map(jnp.asarray, inputs))
    # an absent cotangent is a zero one in JAX
    want = vjp((jnp.asarray(g_xn if with_g_xn else np.zeros_like(g_xn)),
                jnp.asarray(g_h)))

    def tfn(*a):
        return FusedAdapterResidualNorm.apply(
            *a[:5], a[5] if layernorm else None, eps, "auto")

    got = _grads(tfn, inputs, (g_xn if with_g_xn else None, g_h))
    assert len(got) == len(want) == len(inputs)
    for gt, wt in zip(got, want):
        _close_rel(gt.numpy(), wt, 1e-5)


@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (4, 2)])
def test_flash_attention_function_grads_match_jax(heads, kv_heads):
    B, S, D = 2, 24, 16
    G = heads // kv_heads
    q = _rand((B, heads, S, D), 40)
    k, v = _rand((B, kv_heads, S, D), 41), _rand((B, kv_heads, S, D), 42)
    g = _rand((B, heads, S, D), 43)
    pos = jnp.arange(S)

    def jfn(q, k, v):
        # the port's (B, H, S, D) layout <-> JAX's (B, S, KH, G, D)
        qg = q.reshape(B, kv_heads, G, S, D).transpose(0, 3, 1, 2, 4)
        out = jflash.attend(qg, k.transpose(0, 2, 1, 3),
                            v.transpose(0, 2, 1, 3), q_pos=pos, kv_pos=pos,
                            causal=False, q_chunk=8, kv_chunk=8)
        return out.transpose(0, 2, 3, 1, 4).reshape(B, heads, S, D)

    y, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    got = _grads(lambda *a: FlashAttention.apply(*a, False, None, None, 0.0,
                                                 "auto"), (q, k, v), (g,))
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), atol=1e-4,
                                   rtol=0)
    out = FlashAttention.apply(_t(q), _t(k), _t(v), False, None, None, 0.0,
                               "auto")
    np.testing.assert_allclose(out.numpy(), np.asarray(y), atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# dispatch of the new wrappers
# ---------------------------------------------------------------------------


def test_affine_wrappers_take_the_plain_version_on_cpu_without_a_launch():
    _build.reset_launches()
    x, g = _t(_rand((5, 32), 50)), _t(_rand((5, 32), 51))
    w, b = _t(1 + _rand((32,), 52, 0.2)), _t(_rand((32,), 53, 0.2))
    assert torch.equal(tops.hadamard(x, w, b),
                       tops.hadamard(x, w, b, impl="ref"))
    for a, r in zip(tops.hadamard_affine_bwd(g, x, w),
                    tops.hadamard_affine_bwd(g, x, w, impl="ref")):
        assert torch.equal(a, r)
    out = HadamardAffine.apply(x.clone().requires_grad_(True), w, b)
    out.sum().backward()
    assert all(v == 0 for v in _build.launch_counts().values())


@pytest.mark.parametrize("call", [
    lambda: tops.hadamard(torch.zeros(2, 8), torch.ones(8), torch.zeros(8),
                          impl="kernel"),
    lambda: tops.hadamard_affine_bwd(torch.zeros(2, 8), torch.zeros(2, 8),
                                     torch.ones(8), impl="kernel"),
    lambda: HadamardAffine.apply(torch.zeros(2, 8), torch.ones(8),
                                 torch.zeros(8), "kernel"),
])
def test_affine_kernel_impl_on_a_cpu_tensor_raises(call):
    with pytest.raises(ValueError, match="CUDA"):
        call()
