"""The port's kernel modules against the JAX Pallas kernels.

Each plain PyTorch version in `repro_torch.kernels.ref` (what a CPU tensor
runs, and what the CUDA kernel is held to on the card) is compared with the
JAX package's Pallas kernel run in interpret mode, on the same numpy inputs
at fp32. The CUDA kernels themselves run only on the card: `chip_smoke.py`
holds each one to these plain versions there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build
from repro_torch.kernels import hadamard as thad
from repro_torch.kernels import multitask as tmt
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


# #3's plan: the launch of fused_adapter_norm.cu from shapes alone
FAN_WIDTHS = [768, 1000, 1024, 2048, 4000, thad.MAX_D]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 4, 7, 4096])
@pytest.mark.parametrize("d", FAN_WIDTHS)
def test_fused_norm_plan_covers_every_row_once(d, n, dtype):
    """What the C entry point checks before it launches the plan as it
    is: every row once, every element of a row once, and warp_row's rows
    in registers of at most MAX_LANE_ELEMS elements a lane."""
    dt = getattr(torch, dtype)
    plan = thad.fused_norm_plan(n, d, dt)
    vec, wpr = plan["vec"], plan["warps_per_row"]
    rpb, blocks = plan["rows_per_block"], plan["blocks"]
    assert vec in (1, _build.full_vec(dt)) and d % vec == 0
    assert rpb >= 1 and blocks * rpb >= n and (blocks - 1) * rpb < n
    if plan["kernel"] == "warp_row":
        lanes = 32 * wpr
        assert vec > 1 and wpr in thad.WARP_ROW_WARPS
        assert d % (lanes * vec) == 0  # whole vectors, the same count a lane
        assert d // lanes <= thad.MAX_LANE_ELEMS
        assert rpb * lanes <= thad.WARP_ROW_THREADS
    else:
        assert plan["kernel"] == "split_row"
        assert rpb == 1 and blocks == n and 1 <= wpr <= 32


@pytest.mark.parametrize("d,dtype,warps", [
    (768, "float32", 1),     # bert-base, trained in fp32
    (1024, "bfloat16", 1),   # qwen3-0.6b, served in bf16
    (2048, "bfloat16", 2),   # rwkv6-1.6b, served in bf16
    (1024, "float32", 1), (2048, "float32", 2)])  # the fp32 parity models
def test_fused_norm_plan_holds_the_served_widths_in_registers(d, dtype, warps):
    dt = getattr(torch, dtype)
    for n in (1, 4, 128, 4096):
        plan = thad.fused_norm_plan(n, d, dt)
        assert plan["kernel"] == "warp_row" and plan["warps_per_row"] == warps
        assert plan["vec"] == _build.full_vec(dt)
    # a 4-slot decode tick: a block a row; a bert-base train step (4096
    # rows): several rows a block, with every SM still given blocks
    assert thad.fused_norm_plan(4, d, dt)["blocks"] == 4
    train = thad.fused_norm_plan(4096, d, dt)
    assert train["rows_per_block"] > 1 and train["blocks"] >= _build.SMS


@pytest.mark.parametrize("d", [4000, 5000, thad.MAX_D])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_norm_plan_sends_wide_and_ragged_rows_to_split_row(d, dtype):
    dt = getattr(torch, dtype)
    plan = thad.fused_norm_plan(7, d, dt)
    assert plan["kernel"] == "split_row" and plan["vec"] == _build.full_vec(dt)


@pytest.mark.parametrize("d,aligned", [(999, True), (1001, True), (1024, False),
                                       (2048, False), (768, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_norm_plan_loads_one_element_at_a_time_off_the_grid(d, aligned,
                                                                  dtype):
    """A width that is no whole number of 16-byte vectors, or a pointer
    that takes no 16-byte access, gives vec = 1 (and split_row)."""
    plan = thad.fused_norm_plan(4, d, getattr(torch, dtype), aligned)
    assert plan["vec"] == 1 and plan["kernel"] == "split_row"


def test_aligned16_sees_a_storage_offset():
    base = torch.zeros(4 * 1024 + 8)
    assert _build.aligned16(base, None)
    assert not _build.aligned16(base[1:].view(-1)[:4096].view(4, 1024))
    assert _build.aligned16(base[4:])  # 4 fp32 = 16 bytes in


@pytest.mark.parametrize("plan", [None, dict(kernel="warp_row", vec=4,
                                            warps_per_row=1, rows_per_block=1,
                                            blocks=2)])
def test_fused_norm_wrapper_refuses_cpu_tensors(plan):
    with pytest.raises(ValueError, match="CUDA"):
        thad.fused_adapter_residual_norm(
            torch.zeros(2, 128), torch.zeros(2, 128), torch.ones(128),
            torch.zeros(128), torch.ones(128), plan=plan)


# ---------------------------------------------------------------------------
# #1 and #2's plans: the launches of hadamard_affine.cu from shapes alone
# ---------------------------------------------------------------------------

_F32, _BF = torch.float32, torch.bfloat16
# (n, d, g dtype, x dtype): the timed seams (whisper-tiny, bert-base,
# train_lm, rwkv6, internvl2, gemma2-27b's decode and prefill), then ragged
# ones: no whole column tile, d off the 16-byte vector (4001, 999), one row
# past bert's chunks, one row, no rows
_AFFINE_SHAPES = [(12000, 384, _F32, _BF), (4096, 768, _F32, _F32),
                  (2048, 1024, _F32, _BF), (2048, 2048, _F32, _BF),
                  (768, 8192, _F32, _BF), (2, 4608, _BF, _BF),
                  (4160, 4608, _BF, _BF), (7, 4000, _BF, _BF),
                  (5, 4001, _F32, _F32), (3, 999, _BF, _BF),
                  (97, 768, _F32, _F32), (1, 384, _F32, _BF),
                  (0, 384, _F32, _F32)]


def _affine_covers_once(plan, n, d, full):
    """What hadamard_affine.cu's entry points check before they launch a
    plan, and the cover itself: every row of every chunk is one warp's, and
    every column one lane's, once."""
    vec, warps = plan["vec"], plan["warps"]
    rows, chunks = plan["rows_per_block"], plan["chunks"]
    assert vec in (1, full) and d % vec == 0
    assert 1 <= warps <= min(thad.AFFINE_MAX_WARPS, rows)
    assert plan["unroll"] in thad.AFFINE_UNROLLS
    tiles = -(-(d // vec) // thad.AFFINE_LANES)
    assert plan["col_tiles"] == tiles and plan["blocks"] == chunks * tiles
    assert plan["tile_cols"] == thad.AFFINE_LANES * vec
    row_cover = np.zeros(n, np.int64)
    for k in range(chunks):
        end = min((k + 1) * rows, n)
        assert end > k * rows or n == 0  # no chunk without a row
        for ty in range(warps):
            row_cover[k * rows + ty:end:warps] += 1
    col_cover = np.zeros(d, np.int64)
    for lane in range(tiles * thad.AFFINE_LANES):
        c0 = lane * vec
        if c0 < d:
            assert c0 + vec <= d
            col_cover[c0:c0 + vec] += 1
    assert (row_cover == 1).all() and (col_cover == 1).all()
    assert chunks == 1 if n == 0 else chunks * rows >= n > (chunks - 1) * rows


@pytest.mark.parametrize("n,d,g_dtype,x_dtype", _AFFINE_SHAPES)
def test_affine_plans_cover_every_row_and_column_once(n, d, g_dtype, x_dtype):
    fwd = thad.affine_plan(n, d, x_dtype)
    _affine_covers_once(fwd, n, d, _build.full_vec(x_dtype))
    bwd = thad.affine_bwd_plan(n, d, g_dtype, x_dtype)
    _affine_covers_once(bwd, n, d, 16 // max(g_dtype.itemsize,
                                             x_dtype.itemsize))
    assert bwd["partial"] == (bwd["chunks"], 2, d)
    # a few blocks an SM at most: the grid is sized to the card, not to n
    assert fwd["blocks"] <= thad.AFFINE_BLOCKS_PER_SM * _build.SMS \
        + fwd["col_tiles"]
    assert bwd["blocks"] <= thad.AFFINE_BWD_BLOCKS_PER_SM * _build.SMS \
        + bwd["col_tiles"]


@pytest.mark.parametrize("g_dtype,x_dtype,vec", [
    (_F32, _F32, 4), (_F32, _BF, 4), (_BF, _F32, 4), (_BF, _BF, 8)])
def test_affine_plan_vec_follows_the_dtypes_and_alignment(g_dtype, x_dtype,
                                                          vec):
    assert thad.affine_bwd_plan(64, 1024, g_dtype, x_dtype)["vec"] == vec
    assert thad.affine_bwd_plan(64, 1024, g_dtype, x_dtype, False)["vec"] == 1
    # 16 bytes of the wider operand must divide d
    assert thad.affine_bwd_plan(64, 1004, g_dtype, x_dtype)["vec"] == (
        1 if 1004 % vec else vec)
    assert thad.affine_plan(64, 1024, x_dtype)["vec"] == _build.full_vec(x_dtype)
    assert thad.affine_plan(64, 1024, x_dtype, False)["vec"] == 1
    assert thad.affine_plan(64, 1001, x_dtype)["vec"] == 1


@pytest.mark.parametrize("d", [1024, 2048, 4608, 8192])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_affine_decode_plans_launch_no_block_or_warp_without_a_row(n, d):
    for plan in (thad.affine_plan(n, d, _BF),
                 thad.affine_bwd_plan(n, d, _F32, _BF)):
        # one chunk holding every row: each block (a column tile) has all n
        # rows, one a warp
        assert plan["chunks"] == 1 and plan["blocks"] == plan["col_tiles"]
        assert plan["warps"] == n and plan["rows_per_block"] == n


def test_affine_plans_fill_the_card_at_the_train_seams():
    # whisper-tiny's seam: 252 blocks of 8 warps, 84 chunks a column tile,
    # 18 rows a thread, 4 in flight; train_lm's 8 rows a thread, 2
    plan = thad.affine_bwd_plan(12000, 384, _F32, _BF)
    assert (plan["blocks"], plan["chunks"], plan["warps"]) == (252, 84, 8)
    assert plan["unroll"] == 4
    assert thad.affine_bwd_plan(2048, 1024, _F32, _BF)["unroll"] == 2
    # gemma2-27b's prefill: 4 rows in flight a thread where it has 18
    plan = thad.affine_plan(4160, 4608, _BF)
    assert (plan["blocks"], plan["unroll"], plan["vec"]) == (522, 4, 8)
    # bert-base's 6 rows a thread: 2 in flight
    assert thad.affine_plan(4096, 768, _F32)["unroll"] == 2


@pytest.mark.parametrize("dtype", [_F32, _BF])
def test_affine_wrappers_refuse_cpu_tensors(dtype):
    with pytest.raises(ValueError, match="CUDA"):
        thad.hadamard_affine(torch.zeros(2, 128, dtype=dtype), torch.ones(128),
                             torch.zeros(128))
    with pytest.raises(ValueError, match="CUDA"):
        thad.hadamard_affine_bwd(torch.zeros(2, 128), torch.zeros(2, 128,
                                                                  dtype=dtype),
                                 torch.ones(128))


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


def _fp8(pool):
    """Per-token absmax e4m3 over D with fp32 scales: (the port's payload,
    the scales, the same bytes as JAX's float8_e4m3fn)."""
    from repro_torch.quant.qtensor import quantize_kv

    qt = quantize_kv(_t(pool), "fp8")
    raw = qt.values.view(torch.uint8).numpy()
    return (qt.values, qt.scales.numpy(),
            jax.lax.bitcast_convert_type(jnp.asarray(raw), jnp.float8_e4m3fn))


@pytest.mark.parametrize("case", [
    dict(), dict(window=12), dict(window=8, cap=30.0), dict(int8=True),
    dict(int8=True, window=12), dict(sq=3), dict(sq=3, window=12),
    # rows whose queries see no key: kv_len 0, and kv_len below Sq (the
    # batch's last row sees keys); a ring of 2 slots under 3 queries hides
    # every key from the first query of every row
    dict(keyless=True), dict(sq=3, keyless=True),
    dict(sq=3, window=12, keyless=True), dict(sq=3, window=2, keyless=True),
    dict(int8=True, keyless=True), dict(int8=True, sq=3, keyless=True),
    dict(int8=True, sq=3, window=2, keyless=True),
    dict(sq=3, cap=30.0, keyless=True),
    # e4m3 pools, which the Pallas kernel widens to fp32 as any pool dtype
    dict(fp8=True), dict(fp8=True, window=12), dict(fp8=True, sq=3),
    dict(fp8=True, keyless=True), dict(fp8=True, sq=3, window=2,
                                       keyless=True),
])
def test_paged_attention_matches_pallas(case):
    sq = case.get("sq", 1)
    q, kp, vp, tables, lens = _pool(20 + sq, sq=sq)
    if case.get("keyless"):
        lens[:2] = (0, sq - 1 if sq > 1 else 0)
    kw = dict(window=case.get("window"), cap=case.get("cap", 0.0))
    jkw, tkw = dict(kw), dict(kw)
    jk, jv, tk, tv = kp, vp, _t(kp), _t(vp)
    if case.get("int8"):
        kp, ks = _int8(kp)
        vp, vs = _int8(vp)
        jk, jv, tk, tv = kp, vp, _t(kp), _t(vp)
        jkw.update(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
        tkw.update(k_scales=_t(ks), v_scales=_t(vs))
    if case.get("fp8"):
        (tk, ks, jk), (tv, vs, jv) = _fp8(kp), _fp8(vp)
        jkw.update(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
        tkw.update(k_scales=_t(ks), v_scales=_t(vs))
    want = jops.paged_attention(jnp.asarray(q), jnp.asarray(jk),
                                jnp.asarray(jv), jnp.asarray(tables),
                                jnp.asarray(lens), impl="interpret", **jkw)
    got = tops.paged_attention(_t(q), tk, tv, _t(tables), _t(lens), **tkw)
    assert got.dtype == torch.float32 and got.shape == q.shape
    _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# #6 multitask Hadamard
# ---------------------------------------------------------------------------


# the last two: a ragged width (no whole 16-byte vectors) and rwkv6's
@pytest.mark.parametrize("B,S,d,T", [(4, 6, 32, 3), (2, 1, 128, 5),
                                     (3, 2, 999, 3), (4, 1, 2048, 3)])
def test_multitask_hadamard_matches_pallas(B, S, d, T):
    x = _rand((B, S, d), 30)
    wb, bb = 1 + _rand((T, d), 31, 0.2), _rand((T, d), 32, 0.2)
    tids = (np.arange(B) * 2 % T).astype(np.int32)
    want = jops.multitask_hadamard(jnp.asarray(x), jnp.asarray(wb),
                                   jnp.asarray(bb), jnp.asarray(tids),
                                   impl="interpret")
    got = tops.multitask_hadamard(_t(x), _t(wb), _t(bb), _t(tids))
    _close(got, want, 1e-6)


def test_multitask_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tmt.multitask_hadamard(torch.zeros(1, 2, 8), torch.ones(2, 8),
                               torch.zeros(2, 8),
                               torch.zeros(1, dtype=torch.int32))


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
