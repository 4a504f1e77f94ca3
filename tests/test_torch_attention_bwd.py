"""The port's tiled attention backward and the paged kernel's split plan.

`attention.flash_attention_bwd` is JAX's flash backward (`_flash_bwd_impl`
of `repro/models/flash.py`) in PyTorch: P recomputed tile by tile from q,
k and the forward's log-sum-exp, so its memory grows with the tile, not
with Sq*Skv. It is held to `jax.vjp` of `repro.models.flash.attend` with
the same small chunks (several q and kv tiles) on the same numpy inputs,
to the untiled plain backward `ref.attention_bwd_ref`, and the plain
forward's log-sum-exp to JAX's residual. The split plan of
`paged_attention.cu` (flash-decoding) is checked at the serve shape.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import flash as jflash
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import attention as tattn
from repro_torch.kernels.attention import FlashAttention

# (B, H, KH, Sq, Skv, D, causal, window, cap): GQA 16/8, grouped and not,
# local window, soft-cap, and ragged right-aligned Sq < Skv
CASES = {
    "causal_gqa": (1, 16, 8, 70, 70, 16, True, None, 0.0),
    "noncausal": (2, 4, 4, 70, 70, 16, False, None, 0.0),
    "window": (1, 4, 2, 70, 70, 16, True, 20, 0.0),
    "softcap": (2, 4, 2, 70, 70, 16, True, None, 5.0),
    "ragged": (1, 4, 2, 45, 70, 16, True, None, 0.0),
    "ragged_noncausal_window_cap": (1, 4, 2, 45, 70, 16, False, 24, 8.0),
}
Q_CHUNK, KV_CHUNK = 16, 32  # 5 x 3 tiles at S = 70


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close_rel(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, top = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * top, f"max abs err {err:.3g} > {rel} x {top:.3g}"


def _inputs(case, seed=0):
    B, H, KH, Sq, Skv, D = CASES[case][:6]
    return (_rand((B, H, Sq, D), seed), _rand((B, KH, Skv, D), seed + 1),
            _rand((B, KH, Skv, D), seed + 2), _rand((B, H, Sq, D), seed + 3))


def _jax_layout(q, k, v, KH):
    """The port's (B, H, S, D) q and (B, KH, S, D) k, v -> JAX's (B, S, KH,
    G, D) and (B, S, KH, D)."""
    B, H, Sq, D = q.shape
    qg = q.reshape(B, KH, H // KH, Sq, D).transpose(0, 3, 1, 2, 4)
    return qg, k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)


def _jax_attend(case):
    """fn(q, k, v) in the port's layout through `jflash.attend` with the
    case's masks and the small chunks."""
    B, H, KH, Sq, Skv, D, causal, window, cap = CASES[case]

    def fn(q, k, v):
        qg, kj, vj = _jax_layout(q, k, v, KH)
        out = jflash.attend(qg, kj, vj, q_pos=jnp.arange(Sq) + (Skv - Sq),
                            kv_pos=jnp.arange(Skv), causal=causal,
                            window=window, cap=cap, q_chunk=Q_CHUNK,
                            kv_chunk=KV_CHUNK)
        return out.transpose(0, 2, 3, 1, 4).reshape(B, H, Sq, D)
    return fn


def _kw(case):
    causal, window, cap = CASES[case][6:]
    return dict(causal=causal, window=window, cap=cap)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiled_backward_matches_jax_flash_backward(case):
    q, k, v, g = _inputs(case)
    y, vjp = jax.vjp(_jax_attend(case), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    out, lse = ref.attention_ref(_t(q), _t(k), _t(v), return_lse=True,
                                 **_kw(case))
    _close_rel(out.numpy(), y, 1e-5)
    got = tattn.flash_attention_bwd(_t(g), _t(q), _t(k), _t(v), out, lse,
                                    q_chunk=Q_CHUNK, kv_chunk=KV_CHUNK,
                                    **_kw(case))
    for gt, wt in zip(got, want):
        _close_rel(gt.numpy(), wt, 1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiled_backward_matches_the_untiled_plain_backward(case):
    q, k, v, g = map(_t, _inputs(case, seed=10))
    out, lse = ref.attention_ref(q, k, v, return_lse=True, **_kw(case))
    want = ref.attention_bwd_ref(g, q, k, v, out, **_kw(case))
    for chunks in ((Q_CHUNK, KV_CHUNK), (7, 64), (512, 1024)):
        got = tattn.flash_attention_bwd(g, q, k, v, out, lse,
                                        q_chunk=chunks[0],
                                        kv_chunk=chunks[1], **_kw(case))
        for gt, wt in zip(got, want):
            assert gt.dtype == wt.dtype and gt.shape == wt.shape
            _close_rel(gt.numpy(), wt.numpy(), 1e-5)


@pytest.mark.parametrize("case", ["causal_gqa", "window", "ragged"])
def test_plain_forward_lse_matches_the_jax_residual(case):
    """The log-sum-exp `FlashAttention` saves is the one JAX's flash
    forward hands its backward (`_flash_fwd_impl`, (B, KH, G, Sq))."""
    B, H, KH, Sq, Skv, D, causal, window, cap = CASES[case]
    q, k, v, _ = _inputs(case, seed=20)
    qg, kj, vj = _jax_layout(*map(jnp.asarray, (q, k, v)), KH)
    _, jlse = jflash._flash_fwd_impl(
        qg, kj, vj, jnp.arange(Sq) + (Skv - Sq), jnp.arange(Skv),
        jnp.asarray(Skv, jnp.int32), causal, window, D ** -0.5, cap,
        Q_CHUNK, KV_CHUNK)
    _, lse = ref.attention_ref(_t(q), _t(k), _t(v), return_lse=True,
                               **_kw(case))
    assert lse.dtype == torch.float32 and lse.shape == (B, H, Sq)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(jlse).reshape(B, H, Sq),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["causal_gqa", "ragged"])
def test_flash_attention_function_takes_the_tiled_backward(case, monkeypatch):
    """`FlashAttention.backward` is the tiled backward, on the lse its
    forward saved; a forward that needs no gradient saves none."""
    q, k, v, g = map(_t, _inputs(case, seed=30))
    calls = []
    real = tattn.flash_attention_bwd

    def spy(*a, **kw):
        calls.append(a[5].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tattn, "flash_attention_bwd", spy)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    causal, window, cap = CASES[case][6:]
    out = FlashAttention.apply(*leaves, causal, window, None, cap, "auto")
    out.backward(g)
    assert calls == [q.shape[:3]]
    want = ref.attention_bwd_ref(g, q, k, v, out.detach(), **_kw(case))
    for leaf, wt in zip(leaves, want):
        _close_rel(leaf.grad.numpy(), wt.numpy(), 1e-5)
    with torch.no_grad():
        FlashAttention.apply(q, k, v, causal, window, None, cap, "auto")
    assert len(calls) == 1


@pytest.mark.parametrize("case,tiles", [
    # 5 x 5 tiles of 16 at S = 70: the 15 on or below the causal diagonal
    ("causal_gqa", 15),
    # a window of 20: a kv tile whose last key is 20 or more behind a q
    # tile's first query is skipped too, leaving 3 a row
    ("window", 12),
    ("noncausal", 25),
])
def test_tiled_backward_skips_tiles_masked_for_every_query(case, tiles,
                                                           monkeypatch):
    """A tile masked for every query (above the causal diagonal, before the
    window) has P = dS = 0 exactly, so it is skipped: 5 products a tile."""
    q, k, v, g = map(_t, _inputs(case, seed=40))
    out, lse = ref.attention_ref(q, k, v, return_lse=True, **_kw(case))
    want = ref.attention_bwd_ref(g, q, k, v, out, **_kw(case))
    products = []
    einsum = torch.einsum

    def counted(*a):
        products.append(a[0])
        return einsum(*a)

    monkeypatch.setattr(torch, "einsum", counted)
    got = tattn.flash_attention_bwd(g, q, k, v, out, lse, q_chunk=16,
                                    kv_chunk=16, **_kw(case))
    monkeypatch.undo()
    assert len(products) == 5 * tiles
    for gt, wt in zip(got, want):
        _close_rel(gt.numpy(), wt.numpy(), 1e-5)


# ---------------------------------------------------------------------------
# #5's split plan (flash-decoding)
# ---------------------------------------------------------------------------


def test_paged_split_plan_fills_the_card_at_the_serve_shape():
    """q (4, 16, 128) over a (4, 512, 8, 128) bf16 slot cache of 16-token
    pages: splits of 2 pages, 16 per row, the last ending at page nbt - 1;
    512 blocks for 132 SMs; the scratch (B, H, Sq, splits, D + 2); the
    warps' merge within the shared memory a block may have."""
    page, nbt = 16, 32
    plan = tattn.paged_split_plan(4, 16, 8, 1, 128, page, nbt)
    assert plan["blocks"] >= 132
    assert plan["pages_per_split"] * page == tattn.PAGED_SPLIT_KEYS
    last = plan["splits"] - 1
    first_page = last * plan["pages_per_split"]
    assert first_page <= nbt - 1 < first_page + plan["pages_per_split"]
    assert plan["scratch_shape"] == (4, 16, 1, plan["splits"], 130)
    assert plan["rows_per_block"] == 2 and plan["row_chunks"] == 1
    assert plan["smem_bytes"] <= tattn.SMEM_LIMIT


@pytest.mark.parametrize("kw,want", [
    # a ring window of 100 keys: 7 pages, 4 splits
    (dict(window=100), dict(splits=4, ring=100)),
    # Sq = 5 over G = 2: 10 query rows in chunks of the lane layout's limit
    (dict(sq=5), dict(rows_per_block=8, row_chunks=2)),
    (dict(sq=5, kv_dtype=torch.int8), dict(rows_per_block=4, row_chunks=3)),
    (dict(sq=5, kv_dtype=torch.float32), dict(rows_per_block=16,
                                             row_chunks=1)),
    (dict(page=64), dict(pages_per_split=1, splits=8)),
    (dict(page=8, D=256), dict(pages_per_split=4, splits=16)),
])
def test_paged_split_plan_cases(kw, want):
    kw = dict(dict(B=6, H=16, KH=8, sq=1, D=128, page=16, nbt=32), **kw)
    nbt = kw["nbt"] * 16 // kw["page"]  # the same 512-token cache
    plan = tattn.paged_split_plan(kw["B"], kw["H"], kw["KH"], kw["sq"],
                                  kw["D"], kw["page"], nbt, kw.get("window"),
                                  kw.get("kv_dtype", torch.bfloat16))
    for key, value in want.items():
        assert plan[key] == value, (key, plan)
    covered = plan["splits"] * plan["pages_per_split"] * kw["page"]
    assert covered >= plan["ring"] > covered - plan["pages_per_split"] * kw["page"]
    assert plan["blocks"] == (plan["splits"] * kw["KH"] * plan["row_chunks"]
                              * kw["B"])


def test_paged_split_plan_refuses_other_head_dims():
    with pytest.raises(ValueError, match="head_dim"):
        tattn.paged_split_plan(1, 2, 1, 1, 96, 16, 4)


def test_attention_wrappers_on_cpu_launch_nothing():
    _build.reset_launches()
    q, k, v, g = map(_t, _inputs("ragged", seed=50))
    out, lse = ops.flash_attention(q, k, v, return_lse=True)
    assert lse.shape == q.shape[:3]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    FlashAttention.apply(*leaves, True, None, None, 0.0, "auto").backward(g)
    assert all(n == 0 for n in _build.launch_counts().values())
