"""The port's quantization against the JAX package's.

`quantize` must give JAX's payload and scales byte for byte (int8 and
fp8); the plain dequant matmul (what a CPU tensor runs, and what the CUDA
kernel #7 is held to on the card) must agree with the Pallas kernel in
interpret mode; `DequantMatmul`'s dx with `jax.vjp` of `dequant_matmul_tpu`;
and `quantize_tree`, `quant_summary` and `convert` with their JAX
counterparts on the qwen3 smoke tree. All inputs come from numpy seeds.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.tree import path_str
from repro.kernels import ops as jops
from repro.kernels.quant import dequant_matmul_tpu
from repro.quant import qtensor as jq
from repro_torch import convert
from repro_torch.common import tree as tu
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant as tquant
from repro_torch.kernels.quant import DequantMatmul
from repro_torch.quant import qtensor as tq
from test_torch_model import jax_cfg, jax_params, np_tree, port_cfg

MODES = ["int8", "fp8"]


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _bytes(a):
    """The payload's bit pattern: int8, or fp8 through a uint8 view."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn else a
        return a.numpy().view(np.uint8)
    return np.asarray(a).view(np.uint8)


def named_np_tree(tree):
    """A JAX tree as nested dicts of numpy arrays under JAX's own path
    names: a QTensor leaf becomes `<leaf>/values` and `<leaf>/scales`."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        node = out
        *heads, last = path_str(path).split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = np.asarray(leaf)
    return out


def _flat(tree):
    return {path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# quantize: byte for byte
# ---------------------------------------------------------------------------


def _cases():
    zero = _rand((48, 40), 3)
    zero[:, 7] = 0.0  # an all-zero output channel: scale 1.0
    return {
        "random": (_rand((64, 96), 1), 1.0),
        "wide": (_rand((33, 130), 2, 0.02), 1.0),
        "zero_channel": (zero, 1.0),
        "clip": (_rand((64, 96), 4), 0.9),
        "stacked": (_rand((3, 40, 24), 5, 0.05), 1.0),
    }


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(_cases()))
def test_quantize_is_byte_identical_to_jax(mode, case):
    x, clip = _cases()[case]
    want = jq.quantize(jnp.asarray(x), mode, clip=clip)
    got = tq.quantize(torch.from_numpy(x), mode, clip=clip)
    assert got.values.dtype == (torch.int8 if mode == "int8"
                                else torch.float8_e4m3fn)
    assert got.scales.dtype == torch.float32
    assert tuple(got.scales.shape) == np.asarray(want.scales).shape
    np.testing.assert_array_equal(_bytes(got.values), _bytes(want.values))
    np.testing.assert_array_equal(got.scales.numpy(),
                                  np.asarray(want.scales))
    if case == "zero_channel":
        assert float(got.scales[0, 7]) == 1.0
        assert not got.values[:, 7].float().any()


@pytest.mark.parametrize("mode", MODES)
def test_per_tensor_quantize_and_errors_match_jax(mode):
    x = _rand((20, 30), 6)
    want = jq.quantize(jnp.asarray(x), mode, axis=None)
    got = tq.quantize(torch.from_numpy(x), mode, axis=None)
    np.testing.assert_array_equal(_bytes(got.values), _bytes(want.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    np.testing.assert_array_equal(
        tq.fake_quantize(torch.from_numpy(x), mode).numpy(),
        np.asarray(jq.fake_quantize(jnp.asarray(x), mode)))
    np.testing.assert_allclose(
        float(tq.quantization_error(torch.from_numpy(x), got)),
        float(jq.quantization_error(jnp.asarray(x), want)), rtol=1e-6)


def test_qtensor_is_one_leaf_with_tensor_accounting():
    qt = tq.quantize(torch.from_numpy(_rand((16, 8), 7)), "int8")
    assert qt.shape == (16, 8) and qt.ndim == 2 and qt.numel() == 128
    assert qt.nbytes == 16 * 8 + 8 * 4
    moved = qt.to("cpu")
    assert isinstance(moved, tq.QTensor) and moved.values.device.type == "cpu"
    assert tq.is_qtensor(qt) and not tq.is_qtensor(qt.values)
    assert tq.QUANT_MODES == jq.QUANT_MODES
    with pytest.raises(ValueError, match="unknown quantization mode"):
        tq.quantize(torch.zeros(4, 4), "int4")


# ---------------------------------------------------------------------------
# #7: the plain dequant matmul against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mkn", [(1, 64, 128), (5, 77, 130), (128, 256, 384)])
def test_dequant_matmul_ref_matches_pallas(mkn, dtype, mode):
    M, K, N = mkn
    qt = jq.quantize(jnp.asarray(_rand((K, N), 11, 0.05)), mode)
    x = jnp.asarray(_rand((M, K), 12)).astype(dtype)
    want = jops.dequant_matmul(x, qt.values, qt.scales, impl="interpret")
    values = convert.to_tensor(np.asarray(qt.values), "cpu")
    scales = torch.from_numpy(np.array(qt.scales))
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = tops.dequant_matmul(tx, values, scales)
    assert got.dtype == tx.dtype and tuple(got.shape) == (M, N)
    want32 = np.asarray(want.astype(jnp.float32))
    tol = (1e-5 if dtype == "float32" else 2e-2) * np.abs(want32).max()
    np.testing.assert_allclose(got.float().numpy(), want32, atol=tol, rtol=0)


def test_dequant_matmul_function_dx_matches_jax_vjp():
    M, K, N = 6, 40, 24
    qt = jq.quantize(jnp.asarray(_rand((K, N), 21, 0.1)), "int8")
    x, g = _rand((M, K), 22), _rand((M, N), 23)
    _, vjp = jax.vjp(lambda a: dequant_matmul_tpu(a, qt.values, qt.scales,
                                                  True), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    values = torch.from_numpy(np.array(qt.values))
    scales = torch.from_numpy(np.array(qt.scales))
    y = DequantMatmul.apply(tx, values, scales, "auto")
    (dx,) = torch.autograd.grad(y, tx, torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # through qdense on a (B, S, K) activation, as the model calls it
    tx3 = torch.from_numpy(x.reshape(2, 3, K)).requires_grad_(True)
    y3 = tq.qdense(tx3, tq.QTensor(values, scales), torch.float32)
    (dx3,) = torch.autograd.grad(y3, tx3, torch.from_numpy(g.reshape(2, 3, N)))
    np.testing.assert_allclose(dx3.reshape(M, K).numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)


def test_qdense_keeps_the_activation_dtype_and_rejects_stacked_weights():
    values = torch.from_numpy(np.array(
        jq.quantize(jnp.asarray(_rand((16, 8), 24)), "int8").values))
    qt = tq.QTensor(values, torch.full((1, 8), 0.01))
    x = torch.from_numpy(_rand((3, 16), 25))
    # as JAX's QTensor branch: x is not cast to the compute dtype
    assert tq.qdense(x, qt, torch.bfloat16).dtype == torch.float32
    assert tq.qdense(x.bfloat16(), qt, torch.float32).dtype == torch.bfloat16
    stacked = tq.QTensor(values[None], torch.full((1, 1, 8), 0.01))
    with pytest.raises(ValueError, match="2D QTensor"):
        tq.qdense(x, stacked, torch.float32)


def test_cpu_tensors_take_the_plain_dequant_matmul_without_a_launch():
    _build.reset_launches()
    x = torch.from_numpy(_rand((3, 16), 26))
    values = torch.ones((16, 4), dtype=torch.int8)
    scales = torch.full((1, 4), 0.5)
    y = tops.dequant_matmul(x, values, scales)
    assert torch.equal(y, tops.dequant_matmul(x, values, scales, impl="ref"))
    assert _build.launch_counts()["dequant_matmul"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        tops.dequant_matmul(x, values, scales, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        tquant.dequant_matmul(x, values, scales)


# ---------------------------------------------------------------------------
# #7 on the tensor cores: the widening is exact, and the plan
# ---------------------------------------------------------------------------


def test_every_int8_value_widens_to_bf16_exactly():
    """The tensor-core kernels feed bf16 weights to mma.sync: every int8
    value is exact in bf16, and the kernel's widening (the fp32 magic
    number 0x4B000000 | (b ^ 0x80), less 2^23 + 128) gives it back."""
    b = np.arange(256, dtype=np.uint32)
    signed = b.astype(np.uint8).view(np.int8).astype(np.float32)
    magic = ((b ^ 0x80) | 0x4B000000).view(np.float32) - np.float32(8388736.0)
    np.testing.assert_array_equal(magic, signed)
    values = torch.from_numpy(signed.astype(np.int8))
    np.testing.assert_array_equal(
        values.to(torch.bfloat16).to(torch.float32).numpy(), signed)


def test_every_finite_e4m3_value_widens_to_bf16_exactly():
    """Every finite e4m3 value survives e4m3 -> f16 (the kernel's
    cvt.rn.f16x2.e4m3x2) -> fp32 -> bf16 unchanged."""
    bits = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    f32 = bits.view(torch.float8_e4m3fn).to(torch.float32)
    finite = torch.isfinite(f32)
    assert int(finite.sum()) == 254  # all but the two NaN patterns
    f32 = f32[finite]
    via_f16 = f32.to(torch.float16).to(torch.float32)
    assert torch.equal(via_f16, f32)
    assert torch.equal(via_f16.to(torch.bfloat16).to(torch.float32), f32)


# the served paths' (M, K, N): qwen3-0.6b's seven projections at a 4-slot
# decode tick and a 128-token prefill (and M = 1), the rwkv6-1.6b head
QWEN_KN = [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072),
           (3072, 1024)]
SERVED = ([(m, k, n) for k, n in QWEN_KN for m in (1, 4, 128)]
          + [(4, 2048, 65536), (128, 2048, 65536), (5, 77, 130)])


@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("mkn", SERVED)
def test_dequant_matmul_plan_covers_every_output_once(mkn, x_dtype):
    """The grid, cluster and K rows a part that the C entry point launches
    as they are: every output tile once, and K parts that reach K."""
    M, K, N = mkn
    dt = getattr(torch, x_dtype)
    plan = tquant.dequant_matmul_plan(M, K, N, dt, torch.int8)
    tm, tn = plan["tile"]
    gx, gy, gz = plan["grid"]
    cluster, kpp = plan["cluster"], plan["k_per_part"]
    # output tiles: every column and row once, no tile wholly outside
    assert gx * tn >= N and (gx - 1) * tn < N
    if plan["kernel"] in ("ffma_tiled", "mma_tiled"):
        assert gy * tm >= M and (gy - 1) * tm < M
        assert gz == cluster
        k_parts = cluster
    else:  # all M rows in each block, the cluster's ranks along y
        assert tm == M and gy == cluster and gz == 1
        k_parts = cluster * (tquant.STREAM_WARPS if plan["kernel"] == "mma_stream"
                             else tquant.FFMA_WARPS)
    # the K parts cover K, in whole MMA steps (16 rows) or K tiles
    assert k_parts * kpp >= K
    if plan["kernel"] == "mma_stream":
        assert kpp % tquant.STREAM_K == 0
    if plan["kernel"] == "mma_tiled":
        assert kpp % tquant.TILE_K == 0
    assert 1 <= cluster <= tquant.MAX_CLUSTER


@pytest.mark.parametrize("mkn", SERVED)
def test_dequant_matmul_plan_keeps_fp32_off_the_tensor_cores(mkn):
    M, K, N = mkn
    for vdt in tquant.VALUE_DTYPES:
        f32 = tquant.dequant_matmul_plan(M, K, N, torch.float32, vdt)
        bf = tquant.dequant_matmul_plan(M, K, N, torch.bfloat16, vdt)
        assert not f32["tensor_cores"] and f32["kernel"].startswith("ffma")
        assert bf["tensor_cores"] and bf["kernel"].startswith("mma")
        assert bf["kernel"] == ("mma_stream" if M <= tquant.MAX_SMALL_M
                                else "mma_tiled")


@pytest.mark.parametrize("mkn", SERVED)
def test_dequant_matmul_plan_fills_the_card_where_the_shape_allows(mkn):
    """bf16: the K split puts its target of blocks on the card (a full
    wave of 132 for the tiled kernel; STREAM_BLOCKS for the decode one,
    the fill that timed fastest), unless the cluster cap or K's depth
    (a step a warp, two K tiles a rank) stops it first."""
    M, K, N = mkn
    plan = tquant.dequant_matmul_plan(M, K, N, torch.bfloat16, torch.int8)
    blocks = math.prod(plan["grid"])
    cdiv = lambda a, b: -(-a // b)
    if plan["kernel"] == "mma_stream":
        strips = cdiv(N, tquant.STRIP)
        cap = max(1, min(tquant.MAX_CLUSTER,
                         cdiv(K, tquant.STREAM_K) // tquant.STREAM_WARPS))
        want = min(tquant.STREAM_BLOCKS, strips * cap)
    else:
        tm, tn = plan["tile"]
        tiles = cdiv(M, tm) * cdiv(N, tn)
        cap = max(1, min(tquant.MAX_CLUSTER, cdiv(K, tquant.TILE_K) // 2))
        want = min(tquant.SMS, tiles * cap)
    assert blocks >= want
    if (M, K, N) in [(128, k, n) for k, n in QWEN_KN] + [(4, 2048, 65536)]:
        assert blocks >= tquant.SMS


# ---------------------------------------------------------------------------
# quantize_tree, quant_summary and convert on the qwen3 smoke tree
# ---------------------------------------------------------------------------


def _smoke(tasks=0):
    from repro.core.hadamard import build_bank

    jcfg = jax_cfg("qwen3-smoke")
    params = jax_params(jcfg, tasks)
    return jcfg, port_cfg(jcfg), build_bank(params) if tasks else params


def _jax_quantized_paths(jtree):
    return {path_str(p) for p, v in jax.tree_util.tree_flatten_with_path(
        jtree, is_leaf=jq.is_qtensor)[0] if jq.is_qtensor(v)}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tasks", [0, 3])
def test_quantize_tree_matches_jax_on_the_smoke_tree(mode, tasks):
    jcfg, pcfg, jtree = _smoke(tasks)
    ported = convert.from_jax_params(np_tree(jtree), pcfg, "cpu")
    q = tq.quantize_tree(ported, mode)
    jqt = jq.quantize_tree(jtree, mode)
    flat = dict(tu.flatten_with_paths(q))
    quantized = {p for p, v in flat.items() if tq.is_qtensor(v)}
    assert {convert.jax_path(p, pcfg) for p in quantized} == \
        _jax_quantized_paths(jqt)
    assert len(quantized) == 7 * pcfg.n_layers
    # adapters, norms and the embedding untouched (the same tensors)
    before = dict(tu.flatten_with_paths(ported))
    for p, v in flat.items():
        if p not in quantized:
            assert v is before[p], p
    assert "embed/table" in flat and not tq.is_qtensor(flat["embed/table"])
    # idempotent: a quantized tree passes through whole
    again = dict(tu.flatten_with_paths(tq.quantize_tree(q, mode)))
    assert all(again[p] is flat[p] for p in flat)
    # the summary, leaf count included, as JAX reports it
    got = tq.quant_summary(q, lambda p: convert.jax_path(p, pcfg))
    want = jq.quant_summary(jqt)
    assert got == want
    assert got["n_quantized_leaves"] == 7
    assert tq.quant_summary(q)["n_quantized_leaves"] == 7 * pcfg.n_layers
    # and back to dense
    deq = dict(tu.flatten_with_paths(tq.dequantize_tree(q)))
    for p in quantized:
        assert torch.equal(deq[p], flat[p].dequantize())


@pytest.mark.parametrize("mode", MODES)
def test_convert_carries_a_jax_quantized_tree_both_ways(mode):
    _, pcfg, jtree = _smoke()
    jqt = jq.quantize_tree(jtree, mode)
    carried = convert.from_jax_params(named_np_tree(jqt), pcfg, "cpu")
    own = tq.quantize_tree(convert.from_jax_params(np_tree(jtree), pcfg,
                                                   "cpu"), mode)
    got, want = (dict(tu.flatten_with_paths(t)) for t in (carried, own))
    assert set(got) == set(want)
    for p, v in want.items():
        if tq.is_qtensor(v):
            assert tq.is_qtensor(got[p]) and got[p].ndim == 2, p
            assert got[p].values.dtype == v.values.dtype
            np.testing.assert_array_equal(_bytes(got[p].values),
                                          _bytes(v.values))
            np.testing.assert_array_equal(got[p].scales.numpy(),
                                          v.scales.numpy())
        else:
            assert torch.equal(got[p], v), p
    back = _flat(convert.to_jax_params(carried, pcfg))
    jflat = _flat(jqt)
    assert set(back) == set(jflat)
    for p, v in jflat.items():
        assert back[p].dtype == v.dtype, p
        np.testing.assert_array_equal(back[p].view(np.uint8)
                                      if v.dtype.itemsize == 1 else back[p],
                                      v.view(np.uint8)
                                      if v.dtype.itemsize == 1 else v)


def test_quantize_tree_stats_waits_for_the_qpeft_slice():
    _, pcfg, jtree = _smoke()
    ported = convert.from_jax_params(np_tree(jtree), pcfg, "cpu")
    with pytest.raises(ValueError, match="needs the model's cfg"):
        tq.quantize_tree(ported, "int8", stats={"mlp/wi": np.ones(64)})
