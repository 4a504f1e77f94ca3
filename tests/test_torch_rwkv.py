"""The port's RWKV6 serving path against the JAX package, at the rwkv6-1.6b
smoke size (2 layers, d=64, heads of 16) on the CPU.

Inputs are made with numpy from a seed, or with JAX (weights, adapters
moved off the identity by `perturb_adapters`, so a missing adapter seam
shows) and carried into the port by `convert.from_jax_params`. On the CPU
`ops.wkv6` takes its plain version, `ref.wkv6_ref`; that is held to the
Pallas kernel #8 in interpret mode, and every layer above it to JAX.
The serving modes JAX offers over RWKV6 hold too: an int8 or fp8 backbone
(the untied LM head is the one leaf JAX's table quantizes) and hot-swap
tenants from a registry (pruned or shared-w, with runtime add, eviction
and removal), token for token.
"""
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint.store as jstore
from repro.configs import get as jax_get
from repro.configs import get_smoke as jax_get_smoke
from repro.core import hadamard as jhad
from repro.core import peft as jpeft
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import model as JM
from repro.models import rwkv as jrwkv
from repro.quant import qtensor as jq
from repro.serving import MultiTaskEngine as JMultiTaskEngine
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro.serving import ServingConfig as JServingConfig
from repro.serving import make_scheduler as jmake_scheduler
from repro.serving.registry import AdapterBank as JAdapterBank
from repro.serving.registry import AdapterRegistry as JAdapterRegistry
from repro_torch import convert
from repro_torch.common import tree as tu
from repro_torch.configs import get, get_smoke
from repro_torch.core import peft
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rwkv6 as krwkv6
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.models import rwkv
from repro_torch.quant import qtensor as tq
from repro_torch.quant import quant_summary
from repro_torch.serving import (AdapterBank, AdapterRegistry,
                                 MultiTaskEngine, Request, ServeEngine,
                                 ServingConfig, make_scheduler)
from repro_torch.serving.scheduler import Scheduler
from test_torch_model import KEY, np_tree, port_cfg
from test_torch_registry import (assert_lifecycle_matches_jax, publish,
                                 tenants)

ARCH = "rwkv6-1.6b"
MAX_LEN = 32


def close(got, want, tol):
    """max |got - want| within tol of max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, top = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * top, f"max abs err {err:.3g} > {tol} x {top:.3g}"


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def jax_cfg(strategy="hadamard", **kw):
    return jpeft.attach(jax_get_smoke(ARCH), jpeft.strategy(strategy)).replace(
        **kw)


def jax_params(cfg, tasks=0):
    base = JM.init_params(KEY, cfg)
    variants = [jhad.perturb_adapters(base, jax.random.fold_in(KEY, 100 + i),
                                      scale=0.2) for i in range(max(tasks, 1))]
    return variants if tasks else variants[0]


def wkv_inputs(B, H, T, n, seed, w_zero=False):
    rs = np.random.RandomState(seed)
    r, k, v = (rs.randn(B, H, T, n).astype(np.float32) for _ in range(3))
    w = (np.zeros((B, H, T, n), np.float32) if w_zero else
         (0.45 + 0.5 / (1 + np.exp(-rs.randn(B, H, T, n)))).astype(np.float32))
    u = (0.1 * rs.randn(H, n)).astype(np.float32)
    return r, k, v, w, u


# ---------------------------------------------------------------------------
# (a) kernel #8's plain version against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,chunk", [(32, 8), (33, 16), (16, 64)])
def test_wkv6_ref_matches_the_pallas_kernel(T, chunk):
    r, k, v, w, u = wkv_inputs(2, 3, T, 16, seed=T)
    want = jops.wkv6(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                     impl="interpret", chunk=chunk)
    got, _ = ops.wkv6(*(t(a) for a in (r, k, v, w, u)))
    assert got.dtype == torch.float32 and got.shape == (2, 3, T, 16)
    close(got.numpy(), want, 1e-5)


def test_wkv6_ref_decay_property():
    """With w = 0, S_t = k_t v_t^T exactly: the output at step t is the
    bonus term plus attention to the previous token only (JAX's property
    case), against the Pallas kernel too."""
    r, k, v, w, u = wkv_inputs(1, 1, 8, 16, seed=5, w_zero=True)
    u = np.full_like(u, 0.5)
    got, _ = ops.wkv6(*(t(a) for a in (r, k, v, w, u)))
    rn, kn, vn, un = (a.astype(np.float64) for a in (r, k, v, u))
    want = np.zeros((1, 1, 8, 16))
    for s in range(8):
        S = (np.outer(kn[0, 0, s - 1], vn[0, 0, s - 1]) if s
             else np.zeros((16, 16)))
        want[0, 0, s] = rn[0, 0, s] @ S + np.sum(
            rn[0, 0, s] * un[0] * kn[0, 0, s]) * vn[0, 0, s]
    close(got.numpy(), want, 1e-5)
    pallas = jops.wkv6(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                       impl="interpret", chunk=4)
    close(got.numpy(), pallas, 1e-5)


def wkv_zero_one_inputs(B, H, T, n, seed):
    """wkv_inputs with exact 0s and 1s in w: a band of i held at 0, one at
    1, and every step t = 3 mod 7 at 0 (w = exp(-exp(x)) underflows to 0
    and rounds to 1; a log-space chunked form would give NaN)."""
    r, k, v, w, u = wkv_inputs(B, H, T, n, seed)
    w[..., :3] = 0.0
    w[..., 3:6] = 1.0
    w[:, :, 3::7] = 0.0
    return r, k, v, w, u


@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("L", [16, 32])
@pytest.mark.parametrize("T", [1, 7, 16, 33, 128])
def test_wkv6_chunked_ref_matches_the_step_ref_and_pallas(T, L, state, n):
    """The chunked form (the CUDA kernel's arithmetic for long T) against
    the step-by-step plain version, and from a zero state against the
    Pallas kernel in interpret mode; fp32, within 1e-5 of max |ref|."""
    r, k, v, w, u = wkv_zero_one_inputs(1, 2, T, n, seed=T + L + n)
    s0 = ((0.3 * np.random.RandomState(T).randn(1, 2, n, n)).astype(
        np.float32) if state else None)
    args = [t(a) for a in (r, k, v, w, u)]
    s0_t = None if s0 is None else t(s0)
    got, got_S = ref.wkv6_chunked_ref(*args, s0_t, L)
    want, want_S = ref.wkv6_ref(*args, s0_t)
    assert torch.isfinite(got).all() and torch.isfinite(got_S).all()
    close(got.numpy(), want.numpy(), 1e-5)
    close(got_S.numpy(), want_S.numpy(), 1e-5)
    if s0 is not None:
        assert torch.equal(s0_t, t(s0))  # s0 is not written
    else:
        pallas = jops.wkv6(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                           impl="interpret", chunk=L)
        close(got.numpy(), pallas, 1e-5)


# the served paths' (B, H, T, n): rwkv6-1.6b (32 heads of 64) at a 4- and
# 8-slot decode tick, prefills on both sides of the chunked threshold, of
# 128 tokens and longer; the smoke config's heads of 16 and 32
SERVED_WKV = [(4, 32, 1, 64), (1, 32, 128, 64), (1, 32, 512, 64),
              (2, 4, 33, 16), (4, 4, 1, 16), (2, 4, 7, 32), (8, 32, 1, 64),
              (1, 32, 15, 64), (1, 32, 16, 64), (1, 32, 2048, 64),
              (2, 4, 128, 16), (1, 4, 16, 32)]


@pytest.mark.parametrize("bhtn", SERVED_WKV)
def test_wkv6_plan_covers_every_head_and_column_once(bhtn):
    """The kernel, chunk, column group and blocks that the C entry point
    launches as they are: one block for every (b, h) and group of value
    columns."""
    B, H, T, n = bhtn
    plan = krwkv6.wkv6_plan(B, H, T, n)
    J = plan["col_group"]
    assert n % J == 0 and plan["blocks"] == B * H * (n // J)
    if T < krwkv6.CHUNKED_MIN_T:  # decode: the step kernel, a column a thread
        assert plan["kernel"] == "step" and J == n and plan["chunk"] == 0
        return
    # the carry runs once a chunk, not once a step
    assert plan["kernel"] == "chunked" and plan["chunk"] == krwkv6.CHUNK
    assert -(-T // plan["chunk"]) < T
    if (B, H, T, n) == (1, 32, 128, 64):  # 4 column groups a head: 128
        assert plan["blocks"] == 128 and J == 16


# ---------------------------------------------------------------------------
# (b) the state in and out
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_wkv6_ref_with_a_state_matches_jax(dtype):
    r, k, v, w, u = wkv_inputs(2, 4, 11, 16, seed=3)
    s0 = (0.3 * np.random.RandomState(4).randn(2, 4, 16, 16)).astype(
        np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    # both sides start from the same bf16-rounded inputs
    ins = [np.asarray(jnp.asarray(a).astype(jdt).astype(jnp.float32))
           for a in (r, k, v, w)]
    jo, jS = jref.wkv6_ref(*(jnp.asarray(a).astype(jdt) for a in ins),
                           jnp.asarray(u), jnp.asarray(s0))
    s0_t = t(s0)
    o, S = ops.wkv6(*(t(a).to(tdt) for a in ins), t(u), s0=s0_t)
    assert o.dtype == tdt and S.dtype == torch.float32
    assert S is s0_t  # the final state is written over s0
    close(o.float().numpy(), np.asarray(jo.astype(jnp.float32)),
          1e-5 if dtype == np.float32 else 1e-2)
    close(S.numpy(), jS, 1e-5)


def test_wkv6_prefill_then_steps_equals_one_pass():
    """prefill(T) then T' single steps, the state carried in place, equals
    one pass over T + T'."""
    r, k, v, w, u = (t(a) for a in wkv_inputs(2, 4, 13, 16, seed=9))
    want, want_S = ops.wkv6(r, k, v, w, u)
    got, S = ops.wkv6(r[:, :, :9], k[:, :, :9], v[:, :, :9], w[:, :, :9], u)
    outs = [got]
    for s in range(9, 13):
        o, S2 = ops.wkv6(*(a[:, :, s:s + 1] for a in (r, k, v, w)), u, s0=S)
        assert S2 is S  # written in place
        outs.append(o)
    close(torch.cat(outs, dim=2).numpy(), want.numpy(), 1e-6)
    close(S.numpy(), want_S.numpy(), 1e-6)


def test_wkv6_kernel_wrapper_takes_cuda_tensors_only():
    r, k, v, w, u = (t(a) for a in wkv_inputs(1, 2, 3, 16, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        krwkv6.wkv6(r, k, v, w, u)
    with pytest.raises(ValueError, match="CUDA"):
        ops.wkv6(r, k, v, w, u, impl="kernel")


# ---------------------------------------------------------------------------
# (c) the time mix and the channel mix on carried weights
# ---------------------------------------------------------------------------


def _layer0(jcfg):
    """Layer 0's JAX parameters and the port's, carried over."""
    params = jax_params(jcfg)
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["g0"]["slot0"])
    pp = convert.from_jax_params(np_tree(params), port_cfg(jcfg),
                                 "cpu")["layers"][0]
    return jp, pp


def _cache(cfg, B, seed):
    rs = np.random.RandomState(seed)
    H, n = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    return {"S": (0.2 * rs.randn(B, H, n, n)).astype(np.float32),
            "tm_prev": rs.randn(B, cfg.d_model).astype(np.float32),
            "cm_prev": rs.randn(B, cfg.d_model).astype(np.float32)}


@pytest.mark.parametrize("S", [15, 1])
def test_time_and_channel_mix_match_jax(S):
    """S = 15 with rwkv_chunk 4: JAX's scan runs 5 chunks of 3. S = 1:
    JAX's one-step einsum from a cache, which the port writes in place."""
    jcfg = jax_cfg(rwkv_chunk=4)
    pcfg = port_cfg(jcfg)
    jp, pp = _layer0(jcfg)
    x = np.random.RandomState(S).randn(2, S, jcfg.d_model).astype(np.float32)
    cache = _cache(jcfg, 2, seed=S) if S == 1 else None
    jcache = None if cache is None else jax.tree.map(jnp.asarray, cache)
    pcache = None if cache is None else {k_: t(a) for k_, a in cache.items()}

    jy, jtm = jrwkv.rwkv_time_mix(jp["rwkv_tm"], jcfg, jnp.asarray(x), jcache)
    y, tm = rwkv.rwkv_time_mix(pp["rwkv_tm"], pcfg, t(x), pcache)
    close(y.numpy(), jy, 1e-5)
    close(tm["S"].numpy(), jtm["S"], 1e-5)
    np.testing.assert_array_equal(tm["tm_prev"].numpy(), x[:, -1])
    jf, jcm = jrwkv.rwkv_channel_mix(jp["rwkv_cm"], jcfg, jnp.asarray(x),
                                     jcache)
    f, cm = rwkv.rwkv_channel_mix(pp["rwkv_cm"], pcfg, t(x), pcache)
    close(f.numpy(), jf, 1e-5)
    np.testing.assert_array_equal(cm["cm_prev"].numpy(), np.asarray(jcm[
        "cm_prev"]))
    if pcache is not None:  # the decode cache was updated in place
        assert tm["S"] is pcache["S"] and cm["cm_prev"] is pcache["cm_prev"]
        close(pcache["S"].numpy(), jtm["S"], 1e-5)
        np.testing.assert_array_equal(pcache["tm_prev"].numpy(), x[:, -1])


# ---------------------------------------------------------------------------
# (d) the whole model
# ---------------------------------------------------------------------------


def test_rwkv6_configs_match_jax_field_for_field():
    assert dataclasses.asdict(port_cfg(jax_get_smoke(ARCH))) == \
        dataclasses.asdict(get_smoke(ARCH))
    assert dataclasses.asdict(port_cfg(jax_get(ARCH))) == \
        dataclasses.asdict(get(ARCH))


def test_rwkv6_parameter_count_matches_jax_at_full_size():
    """1,599,967,232 parameters under the Hadamard strategy, counted
    without making them (JAX's eval_shape; the port on the meta device)."""
    jcfg = jpeft.attach(jax_get(ARCH), jpeft.strategy("hadamard"))
    shapes = jax.eval_shape(lambda: JM.init_params(KEY, jcfg))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    with torch.device("meta"):
        params = M.init_params(None, port_cfg(jcfg))
    got = sum(a.numel() for _, a in convert.tu.flatten_with_paths(params))
    assert got == want == 1_599_967_232


@pytest.mark.parametrize("tasks", [0, 3])
def test_from_jax_params_round_trips_every_rwkv_leaf(tasks):
    jcfg = jax_cfg()
    params = jax_params(jcfg, tasks)
    tree = np_tree(jhad.build_bank(params) if tasks else params)
    ported = convert.from_jax_params(tree, port_cfg(jcfg), "cpu")
    back = convert.to_jax_params(ported, port_cfg(jcfg))
    want = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert got[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(got[path], leaf)
    layer = ported["layers"][1]
    assert set(layer) == {"attn_norm", "ffn_norm", "rwkv_tm", "rwkv_cm",
                          "adapter"}
    assert layer["rwkv_tm"]["u"].shape == (4, 16)
    assert layer["rwkv_tm"]["lora2"].shape == (5, 32, 64)
    np.testing.assert_array_equal(
        layer["rwkv_tm"]["u"].numpy(),
        tree["blocks"]["g0"]["slot0"]["rwkv_tm"]["u"][1])


@pytest.mark.parametrize("tasks", [0, 3])
def test_prefill_and_decode_match_jax(tasks):
    jcfg = jax_cfg()
    pcfg = port_cfg(jcfg)
    params = jax_params(jcfg, tasks)
    task_ids = np.array([0, 2], np.int32)
    if tasks:
        bank = jhad.build_bank(params)
        jparams = jhad.select_tasks(bank, jnp.asarray(task_ids))
        ported = convert.from_jax_params(np_tree(bank), pcfg, "cpu")
        tids = torch.from_numpy(task_ids)
    else:
        jparams = params
        ported = convert.from_jax_params(np_tree(params), pcfg, "cpu")
        tids = None
    rs = np.random.RandomState(7)
    B, S = 2, 10
    tokens = rs.randint(0, pcfg.vocab_size, (B, S))
    want, jcaches = JM.prefill_lm(jparams, jcfg, jnp.asarray(tokens),
                                  cache_len=MAX_LEN)
    got, caches = M.prefill_lm(ported, pcfg, torch.from_numpy(tokens),
                               MAX_LEN, task_ids=tids)
    close(got.numpy(), want, 1e-4)
    jstate = jcaches["g0"]["slot0"]["rwkv"]
    for i, c in enumerate(caches):
        assert set(c) == {"S", "tm_prev", "cm_prev"}
        close(c["S"].numpy(), jstate["S"][i], 1e-4)
        close(c["cm_prev"].numpy(), jstate["cm_prev"][i], 1e-5)
    pos = np.array([S, S - 3])
    for step in range(4):
        tok = rs.randint(0, pcfg.vocab_size, (B, 1))
        want, jcaches = JM.decode_lm(jparams, jcfg, jcaches, jnp.asarray(tok),
                                     jnp.asarray(pos + step, jnp.int32))
        got, caches = M.decode_lm(ported, pcfg, caches, torch.from_numpy(tok),
                                  torch.from_numpy(pos + step), task_ids=tids)
        assert got.shape == (B, 1, pcfg.vocab_size)
        close(got.numpy(), want, 1e-4)


def test_perturbed_adapters_change_the_rwkv_logits():
    """Identity adapters would hide a missing seam: the perturbed ones
    used above move the logits."""
    jcfg = jax_cfg()
    pcfg = port_cfg(jcfg)
    tokens = torch.from_numpy(np.random.RandomState(1).randint(0, 503, (1, 6)))
    base = convert.from_jax_params(np_tree(JM.init_params(KEY, jcfg)), pcfg,
                                   "cpu")
    tuned = convert.from_jax_params(np_tree(jax_params(jcfg)), pcfg, "cpu")
    a, _ = M.prefill_lm(base, pcfg, tokens, MAX_LEN)
    b, _ = M.prefill_lm(tuned, pcfg, tokens, MAX_LEN)
    assert (a - b).abs().max() > 1e-3


# ---------------------------------------------------------------------------
# (e) the scheduler against JAX's, token for token
# ---------------------------------------------------------------------------


def _traffic(vocab, tasks, n=6, seed=3):
    rs = np.random.RandomState(seed)
    return [dict(prompt=rs.randint(0, vocab, (int(rs.choice([4, 9])),)),
                 max_new_tokens=int(rs.randint(2, 8)),
                 task_id=i % tasks if tasks else 0) for i in range(n)]


@pytest.mark.parametrize("tasks", [0, 3])
def test_scheduler_greedy_tokens_match_jax(tasks):
    """More requests than slots, so admissions land mid-decode and every
    leaf of a freed slot's state is overwritten."""
    jcfg = jax_cfg()
    pcfg = port_cfg(jcfg)
    params = jax_params(jcfg, tasks)
    if tasks:
        jeng = JMultiTaskEngine(jcfg, params)
        peng = MultiTaskEngine(pcfg, [convert.from_jax_params(
            np_tree(p), pcfg, "cpu") for p in params], device="cpu")
    else:
        jeng = JServeEngine(jcfg, params)
        peng = ServeEngine(pcfg, convert.from_jax_params(np_tree(params), pcfg,
                                                         "cpu"), device="cpu")
    traffic = _traffic(pcfg.vocab_size, tasks)
    jdone, _ = jmake_scheduler(jeng, JServingConfig(
        num_slots=2, max_len=MAX_LEN)).run([JRequest(**r) for r in traffic])
    pdone, report = make_scheduler(peng, ServingConfig(
        num_slots=2, max_len=MAX_LEN)).run([Request(**r) for r in traffic])
    assert report["requests"] == len(traffic)
    for j, p, r in zip(jdone, pdone, traffic):
        assert p.finish_reason == "length"
        assert len(p.tokens) == r["max_new_tokens"]
        np.testing.assert_array_equal(p.tokens, np.asarray(j.tokens))


# ---------------------------------------------------------------------------
# (f) the repairs and the refusals
# ---------------------------------------------------------------------------


def test_attn_concat_adapter_is_d_model_on_an_rwkv_block():
    """JAX sizes the adapter by the slot kind: q_dim only on attention
    blocks; an rwkv block's adapter is d_model wide, and it applies to
    the time-mix output under any position."""
    jcfg = jax_cfg("hadamard_concat").replace(q_chunk=16)
    pcfg = port_cfg(jcfg)
    jshape = jax.eval_shape(lambda: JM.init_params(KEY, jcfg))
    want = jshape["blocks"]["g0"]["slot0"]["adapter"]["w"].shape[1:]
    params = M.init_params(torch.Generator().manual_seed(0), pcfg)
    assert tuple(params["layers"][0]["adapter"]["w"].shape) == want == (64,)
    jparams = jax_params(jcfg)
    ported = convert.from_jax_params(np_tree(jparams), pcfg, "cpu")
    tokens = np.random.RandomState(2).randint(0, 503, (2, 7))
    want, _ = JM.prefill_lm(jparams, jcfg, jnp.asarray(tokens),
                            cache_len=MAX_LEN)
    got, _ = M.prefill_lm(ported, pcfg, torch.from_numpy(tokens), MAX_LEN)
    close(got.numpy(), want, 1e-4)


def test_prefill_bucket_is_refused_for_recurrent_state():
    pcfg = port_cfg(jax_cfg())
    eng = ServeEngine(pcfg, M.init_params(torch.Generator().manual_seed(0),
                                          pcfg), device="cpu")
    assert not Scheduler.supports_bucketing(pcfg)
    assert Scheduler.supports_bucketing(get_smoke("qwen3-0.6b"))
    with pytest.raises(ValueError, match="prefill_bucket"):
        make_scheduler(eng, ServingConfig(num_slots=2, max_len=MAX_LEN,
                                          prefill_bucket=8))
    with pytest.raises(ValueError, match="last_pos"):
        M.prefill_lm(eng.params, pcfg, torch.zeros((1, 8), dtype=torch.long),
                     MAX_LEN, last_pos=5)


@pytest.fixture
def jax_zlib(monkeypatch):
    """JAX's store writes zlib, as it does where `zstandard` is absent."""
    monkeypatch.setattr(jstore, "zstandard", None)


def _quant_engines(mode):
    jcfg = jax_cfg()
    pcfg = port_cfg(jcfg)
    params = jax_params(jcfg)
    return (JServeEngine(jcfg, params, quant=mode),
            ServeEngine(pcfg, convert.from_jax_params(np_tree(params), pcfg,
                                                      "cpu"),
                        quant=mode, device="cpu"), pcfg)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_rwkv_engine_logits_and_summary_match_jax(mode):
    """JAX's quantization table matches no time- or channel-mix leaf: of an
    RWKV6 tree it quantizes the untied LM head alone, and so does the port,
    byte for byte; prefill and decode logits within 1e-4."""
    jeng, peng, pcfg = _quant_engines(mode)
    want = jq.quant_summary(jeng.params)
    got = quant_summary(peng.params, lambda p: convert.jax_path(p, pcfg))
    assert got == want and got["n_quantized_leaves"] == 1
    assert [p for p, v in tu.flatten_with_paths(peng.params)
            if tq.is_qtensor(v)] == ["lm_head/kernel"]
    assert serve.quant_line(peng).startswith(f"{mode} backbone: 1 matmul "
                                             "leaves")
    rs = np.random.RandomState(7)
    B, S = 2, 9
    tokens = rs.randint(0, pcfg.vocab_size, (B, S))
    want, jcaches = jeng.prefill(jnp.asarray(tokens), MAX_LEN)
    got, caches = peng.prefill(tokens, MAX_LEN)
    close(got.numpy(), want, 1e-4)
    pos = np.array([S, S])
    for step in range(3):
        tok = rs.randint(0, pcfg.vocab_size, (B, 1))
        want, jcaches = jeng.decode_step(jcaches, jnp.asarray(tok),
                                         jnp.asarray(pos + step, jnp.int32))
        got, caches = peng.decode_step(caches, tok, pos + step)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_rwkv_scheduler_greedy_tokens_match_jax(mode):
    jeng, peng, pcfg = _quant_engines(mode)
    traffic = _traffic(pcfg.vocab_size, 0)
    jdone, _ = jmake_scheduler(jeng, JServingConfig(
        num_slots=2, max_len=MAX_LEN, backbone_quant=mode)).run(
        [JRequest(**r) for r in traffic])
    pdone, report = make_scheduler(peng, ServingConfig(
        num_slots=2, max_len=MAX_LEN, backbone_quant=mode)).run(
        [Request(**r) for r in traffic])
    assert report["requests"] == len(traffic)
    for j, p, r in zip(jdone, pdone, traffic):
        assert p.finish_reason == "length"
        assert len(p.tokens) == r["max_new_tokens"]
        np.testing.assert_array_equal(p.tokens, np.asarray(j.tokens))


@pytest.fixture(scope="module")
def rwkv_world():
    """The rwkv6 smoke backbone (JAX and port copies) and 4 JAX task
    variants with their port copies, in the shape the registry tests'
    helpers take."""
    jcfg = jax_cfg()
    pcfg = port_cfg(jcfg)
    jbase = JM.init_params(KEY, jcfg)
    jvars = [jhad.perturb_adapters(jbase, jax.random.fold_in(KEY, t),
                                   scale=0.2) for t in range(4)]
    return dict(jcfg=jcfg, pcfg=pcfg, jbase=jbase,
                pbase=convert.from_jax_params(np_tree(jbase), pcfg, "cpu"),
                jvars=jvars,
                pvars=[convert.from_jax_params(np_tree(v), pcfg, "cpu")
                       for v in jvars])


@pytest.mark.parametrize("by,kind", [("jax", "mixed"), ("port", "shared")])
def test_rwkv_hot_swap_lifecycle_is_token_identical_to_jax(rwkv_world,
                                                           jax_zlib, by,
                                                           kind):
    """Hot-swap over RWKV6 blocks, as JAX serves it: tenants pruned to the
    top layer (or sharing one w) in a 3-row bank over 4 tenants, the last
    published mid-stream, task0 removed at the end; greedy tokens, bank
    counts and gates equal JAX's. The adapter rows are d_model wide."""
    w = rwkv_world
    assert tuple(w["pbase"]["layers"][0]["adapter"]["w"].shape) == (
        w["pcfg"].d_model,)
    assert_lifecycle_matches_jax(w, by, kind)


def test_rwkv_hot_swap_logits_match_jax(rwkv_world, jax_zlib):
    """A bank holding a pruned and a dense tenant over RWKV6 blocks: the
    gated masked op at every seam, prefill and decode logits within 1e-4
    of JAX's."""
    w = rwkv_world
    ts, jbase, pbase = tenants(w, "mixed")
    with tempfile.TemporaryDirectory() as td:
        jreg = JAdapterRegistry(td)
        for t in (0, 1):
            publish(jreg, "jax", w, ts[t], f"task{t}")
        jbank = JAdapterBank(w["jcfg"], jbase, 3, jreg)
        pbank = AdapterBank(w["pcfg"], pbase, 3, AdapterRegistry(td))
        rows = [jbank.lookup(f"task{t}") for t in (0, 1)]
        assert [pbank.lookup(f"task{t}") for t in (0, 1)] == rows
    np.testing.assert_array_equal(pbank.gates(), jbank.gates())
    jeng = JMultiTaskEngine(w["jcfg"], jbank)
    peng = MultiTaskEngine(w["pcfg"], pbank, device="cpu")
    toks = np.random.RandomState(4).randint(0, w["pcfg"].vocab_size, (2, 7))
    jl, jc = jeng.prefill(toks, MAX_LEN, task_ids=rows)
    pl, pc = peng.prefill(toks, MAX_LEN, task_ids=rows)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4)
    for i in range(2):
        tok = np.array(jnp.argmax(jl[:, -1], -1))[:, None]
        jl, jc = jeng.decode_step(jc, jnp.asarray(tok),
                                  jnp.full((2,), 7 + i, jnp.int32),
                                  task_ids=rows)
        pl, pc = peng.decode_step(pc, tok, np.full((2,), 7 + i),
                                  task_ids=rows)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4)


# ---------------------------------------------------------------------------
# (g) the CPU launcher smoke
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tasks", [0, 3])
def test_serve_launcher_rwkv6_smoke_on_the_cpu(tasks, capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                "--tasks", str(tasks)])
    out = capsys.readouterr().out
    assert "served 8 requests / 64 tokens" in out and "cpu" in out
    assert out.count("tok (length") == 8


@pytest.mark.parametrize("flags", [["--quant", "int8"],
                                   ["--quant", "fp8", "--tasks", "3"]])
def test_serve_launcher_rwkv6_quant_on_the_cpu(flags, capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", *flags])
    out = capsys.readouterr().out
    mode = flags[1]
    assert f"{mode} backbone: 1 matmul leaves" in out
    assert "served 8 requests / 64 tokens" in out
    assert out.count("tok (length") == 8


@pytest.mark.parametrize("share_w", [False, True])
def test_serve_launcher_rwkv6_hot_swap_on_the_cpu(share_w, capsys):
    with tempfile.TemporaryDirectory() as td:
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--tasks",
                    "4", "--adapter-dir", td, "--bank-size", "3",
                    "--prune-to", "1"] + (["--share-w"] if share_w else []))
        assert sorted(os.listdir(td)) == ["task1", "task2", "task3"]
    out = capsys.readouterr().out
    assert "pruned serving: top 1/2 layers active" in out
    assert "++ runtime add: published 'task3'" in out
    assert "-- runtime remove: 'task0' unpublished + row freed" in out
    assert "adapter bank: 3/3 rows resident, 4 loads, 1 evictions" in out
    assert ("(shared-w: one w row-set for all tenants)" in out) == share_w
    assert "served 8 requests / 64 tokens" in out
    assert out.count("tok (length") == 8
