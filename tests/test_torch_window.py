"""Windowed ring caches and gemma2 serving: the port against the JAX package.

Same JAX-made weights (perturbed adapters) on both sides, fp32, on the CPU
(#1, #4, #5, #6 and #9 take their plain versions here; `chip_smoke.py`
holds the kernels to them on the card):
  * gemma2's smoke config (a (window 16, global) group: soft-caps,
    post-norms, GeGLU, embed scale), the same with repeats=2, and a tiny
    config under JAX's windows 4, 8 and 12: prefill and per-row decode
    logits within 1e-4 of JAX's over prompts longer than the ring and
    decode steps that wrap it again;
  * the contiguous scheduler with mid-decode admission and the paged
    windowed lane (cold, no prefix cache, the pool drained), tokens equal
    to JAX's schedulers'; a ring that is not a multiple of the page
    refused;
  * a static 3-task bank (#6) and a hot-swap bank holding a pruned tenant
    (#9 with its gates) on gemma2 smoke, tokens equal to JAX's;
  * the faults this slice repaired, each shown: the post-norm seam's
    dropped gate, one table for every cache length, `paged_insert`'s one
    length for every layer;
  * the refusals: bucketing and speculation (JAX's text), verify and
    extend over windowed layers;
  * a two-slot group's layers unstacked group, repeat, slot, both ways,
    and a gemma2 delta written by either package the same bytes.
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
from repro.common.types import Group as JGroup
from repro.common.types import Slot as JSlot
from repro.configs import get as jax_get
from repro.configs import get_smoke as jax_get_smoke
from repro.core import hadamard as jhad
from repro.core import peft as jpeft
from repro.models import model as JM
from repro.serving import MultiTaskEngine as JMultiTaskEngine
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro.serving import ServingConfig as JServingConfig
from repro.serving import make_scheduler as jmake_scheduler
from repro.serving.registry import AdapterBank as JAdapterBank
from repro.serving.registry import AdapterRegistry as JAdapterRegistry
from repro.serving.spec import SpecScheduler as JSpecScheduler
from repro.sparse import importance as jimp
from repro.sparse import prune as jprune
from repro_torch import convert
from repro_torch.configs import get, get_smoke
from repro_torch.core import hadamard as had
from repro_torch.launch import serve as launcher
from repro_torch.models import model as M
from repro_torch.serving import (AdapterBank, AdapterRegistry,
                                 MultiTaskEngine, PagedScheduler, Request,
                                 Scheduler, ServeEngine, ServingConfig,
                                 make_scheduler)
from repro_torch.sparse import importance as imp
from repro_torch.sparse import prune
from conftest import tiny_cfg
from test_torch_model import KEY, np_tree, port_cfg

MAX_LEN = 48


def gemma_cfg(repeats=1):
    cfg = jpeft.attach(jax_get_smoke("gemma2-27b"), jpeft.strategy("hadamard"))
    return cfg.replace(groups=(JGroup(cfg.groups[0].slots, repeats),))


def window_cfg(window):
    """A tiny config of (window, global) layers: JAX's test windows."""
    return tiny_cfg(groups=(JGroup((JSlot("attn", window=window),
                                    JSlot("attn")), 1),))


def world(jcfg, tasks=0, scale=0.2):
    """(JAX variants, port variants, port cfg) over the same weights."""
    pcfg = port_cfg(jcfg)
    base = JM.init_params(KEY, jcfg)
    jvars = [jhad.perturb_adapters(base, jax.random.fold_in(KEY, 100 + t),
                                   scale=scale) for t in range(max(tasks, 1))]
    pvars = [convert.from_jax_params(np_tree(v), pcfg, "cpu") for v in jvars]
    return jvars, pvars, pcfg


@pytest.fixture(scope="module")
def gemma():
    jvars, pvars, pcfg = world(gemma_cfg(), tasks=3)
    return dict(jcfg=gemma_cfg(), jvars=jvars, pvars=pvars, pcfg=pcfg)


def test_gemma2_configs_match_jax_field_for_field():
    for jc, pc in ((jax_get("gemma2-27b"), get("gemma2-27b")),
                   (jax_get_smoke("gemma2-27b"), get_smoke("gemma2-27b"))):
        assert dataclasses.asdict(port_cfg(jc)) == dataclasses.asdict(pc)
    full = get("gemma2-27b")
    assert [s.window for s in full.layer_slots()][:4] == [4096, None] * 2
    assert full.n_layers == 46


# ---------------------------------------------------------------------------
# the model: prefill and decode past the ring
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["gemma2", "gemma2_repeats2", "window4",
                                  "window8", "window12"])
def test_prefill_and_decode_match_jax_past_the_ring(name):
    jcfg = {"gemma2": gemma_cfg(), "gemma2_repeats2": gemma_cfg(2),
            "window4": window_cfg(4), "window8": window_cfg(8),
            "window12": window_cfg(12)}[name]
    (jp,), (pp,), pcfg = world(jcfg)
    window = pcfg.layer_slots()[0].window
    rs = np.random.RandomState(7)
    B, S, L = 2, 20, 32  # a 20-token prompt passes every ring
    tokens = rs.randint(0, pcfg.vocab_size, (B, S))
    want, jcaches = JM.prefill_lm(jp, jcfg, jnp.asarray(tokens), cache_len=L)
    got, caches = M.prefill_lm(pp, pcfg, torch.from_numpy(tokens), L)
    assert [tuple(c["k"].shape[:2]) for c in caches][:2] == [(B, window),
                                                             (B, L)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    pos = np.array([S, S - 5])  # the rows at different depths
    for step in range(6):  # positions up to 25: the 16-ring wraps again
        tok = rs.randint(0, pcfg.vocab_size, (B, 1))
        want, jcaches = JM.decode_lm(jp, jcfg, jcaches, jnp.asarray(tok),
                                     jnp.asarray(pos + step, jnp.int32))
        got, caches = M.decode_lm(pp, pcfg, caches, torch.from_numpy(tok),
                                  torch.from_numpy(pos + step))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0, err_msg=f"{name} step {step}")


def test_ring_cache_holds_the_last_tokens_at_their_slots(gemma):
    """The prefill's ring (window 16) holds positions 4..19 of a 20-token
    prompt at slot p % 16, as JAX's cache does."""
    pcfg, pp = gemma["pcfg"], gemma["pvars"][0]
    jp = gemma["jvars"][0]
    tokens = np.random.RandomState(3).randint(0, pcfg.vocab_size, (1, 20))
    _, jcaches = JM.prefill_lm(jp, gemma["jcfg"], jnp.asarray(tokens),
                               cache_len=32)
    _, caches = M.prefill_lm(pp, pcfg, torch.from_numpy(tokens), 32)
    jring = np.asarray(jcaches["g0"]["slot0"]["attn"]["k"][0])
    jfull = np.asarray(jcaches["g0"]["slot1"]["attn"]["k"][0])
    np.testing.assert_allclose(caches[0]["k"].numpy(), jring, atol=1e-5)
    np.testing.assert_allclose(caches[1]["k"].numpy(), jfull, atol=1e-5)
    assert caches[0]["k"].shape[1] == 16 and caches[1]["k"].shape[1] == 32


def test_fault_one_table_for_every_cache_length(gemma):
    """Gemma2's layer 0 keeps a 16-ring, layer 1 a 32-token cache. A decode
    step that built one set of tables from the first attention layer's
    length gave layer 1 the ring's tables; each length now has its own, and
    a ring of 12 (not a multiple of 16) is viewed as 4-token pages."""
    from repro_torch.models.attention import decode_page, decode_tables
    assert decode_page(16) == 16 and decode_page(12) == 4
    assert decode_page(4352) == 16 and decode_page(4096) == 16
    np.testing.assert_array_equal(decode_tables(2, 12, "cpu").numpy(),
                                  [[0, 1, 2], [3, 4, 5]])
    seen = []
    real = M._pool_step

    def spy(params, cfg, pool, tokens, write_pos, tables, *a, **kw):
        seen.append([None if t is None else tuple(t.shape) for t in tables])
        return real(params, cfg, pool, tokens, write_pos, tables, *a, **kw)

    pcfg, pp = gemma["pcfg"], gemma["pvars"][0]
    _, caches = M.prefill_lm(pp, pcfg, torch.zeros((2, 4), dtype=torch.long),
                             32)
    M._pool_step = spy
    try:
        M.decode_lm(pp, pcfg, caches, torch.zeros((2, 1), dtype=torch.long),
                    torch.tensor([4, 4]))
    finally:
        M._pool_step = real
    assert seen == [[(2, 1), (2, 2)]]


# ---------------------------------------------------------------------------
# the post-norm seam
# ---------------------------------------------------------------------------


def test_fault_post_norm_seam_keeps_the_bank_gate(gemma):
    """A gated-off bank row passes its layer through as the identity, also
    under post-norms (the seam used to drop `gate` there): the row's
    logits equal those of an identity adapter, and a gated-on row's those
    of its own adapter."""
    pcfg = gemma["pcfg"]
    bank = had.build_bank(gemma["pvars"])
    tokens = torch.from_numpy(np.random.RandomState(4).randint(
        0, pcfg.vocab_size, (2, 7)))
    tids = torch.tensor([0, 1], dtype=torch.int32)
    gates = torch.ones((pcfg.n_layers, 3))
    gates[:, 1] = 0.0  # row 1 gated off in every layer
    got, _ = M.prefill_lm(bank, pcfg, tokens, 16, task_ids=tids, gates=gates)
    one, _ = M.prefill_lm(gemma["pvars"][0], pcfg, tokens[:1], 16)
    ident = dict(gemma["pvars"][0], layers=[
        dict(layer, adapter={"w": torch.ones_like(layer["adapter"]["w"]),
                             "b": torch.zeros_like(layer["adapter"]["b"])})
        for layer in gemma["pvars"][0]["layers"]])
    base, _ = M.prefill_lm(ident, pcfg, tokens[1:], 16)
    np.testing.assert_allclose(got[0].numpy(), one[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), base[0].numpy(), atol=1e-5)


def test_post_norm_seam_runs_the_kernels_ops(gemma, monkeypatch):
    """Under post-norms the single adapter takes `HadamardAffine` (#1), a
    static bank `ops.multitask_hadamard` (#6) and a gated bank
    `ops.masked_multitask_hadamard` (#9), one call a layer; no plain
    affine remains on the path."""
    from repro_torch.kernels import hadamard as khad
    from repro_torch.kernels import ops
    from repro_torch.models import program

    calls = {"affine": 0, "multitask": 0, "masked": 0}

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(khad.HadamardAffine, "apply",
                        count("affine", khad.HadamardAffine.apply))
    monkeypatch.setattr(ops, "multitask_hadamard",
                        count("multitask", ops.multitask_hadamard))
    monkeypatch.setattr(ops, "masked_multitask_hadamard",
                        count("masked", ops.masked_multitask_hadamard))
    assert not hasattr(program, "apply_hadamard")
    pcfg = gemma["pcfg"]
    tokens = torch.zeros((2, 5), dtype=torch.long)
    tids = torch.tensor([0, 2], dtype=torch.int32)
    bank = had.build_bank(gemma["pvars"])
    M.prefill_lm(gemma["pvars"][0], pcfg, tokens, 16)
    M.prefill_lm(bank, pcfg, tokens, 16, task_ids=tids)
    M.prefill_lm(bank, pcfg, tokens, 16, task_ids=tids,
                 gates=torch.ones((pcfg.n_layers, 3)))
    assert calls == {"affine": 2, "multitask": 2, "masked": 2}


# ---------------------------------------------------------------------------
# the schedulers
# ---------------------------------------------------------------------------


def _traffic(vocab, n=6, tasks=0, seed=11):
    """Prompts of 18-23 tokens (past the 16-ring) and of 5, budgets of 3-8:
    more requests than slots, so admissions land mid-decode."""
    rs = np.random.RandomState(seed)
    return [dict(prompt=rs.randint(0, vocab, (int(rs.choice([5, 18, 23])),)),
                 max_new_tokens=int(rs.randint(3, 9)),
                 task_id=i % tasks if tasks else 0) for i in range(n)]


def _jax_engine(jcfg, jvars, tasks):
    return JMultiTaskEngine(jcfg, jvars) if tasks else JServeEngine(jcfg,
                                                                   jvars[0])


def _port_engine(pcfg, pvars, tasks):
    return (MultiTaskEngine(pcfg, pvars, device="cpu") if tasks
            else ServeEngine(pcfg, pvars[0], device="cpu"))


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("tasks", [0, 3])
def test_scheduler_tokens_match_jax(gemma, paged, tasks):
    """Mid-decode admission over ring caches, contiguous or paged (the
    cold windowed lane: no prefix cache, 16-token pages, the pool drained),
    tokens equal to JAX's scheduler's and to the contiguous port's."""
    traffic = _traffic(gemma["pcfg"].vocab_size, tasks=tasks)
    kw = dict(num_slots=2, max_len=MAX_LEN)
    if paged:
        kw.update(paged=True, page_size=16, num_blocks=8)
    jsched = jmake_scheduler(_jax_engine(gemma["jcfg"], gemma["jvars"],
                                         tasks), JServingConfig(**kw))
    jdone, _ = jsched.run([JRequest(**t) for t in traffic])
    peng = _port_engine(gemma["pcfg"], gemma["pvars"], tasks)
    psched = make_scheduler(peng, ServingConfig(**kw))
    pdone, report = psched.run([Request(**t) for t in traffic])
    assert report["requests"] == len(traffic)
    for j, p, t in zip(jdone, pdone, traffic):
        assert len(p.tokens) == t["max_new_tokens"]
        np.testing.assert_array_equal(p.tokens, np.asarray(j.tokens))
    if paged:
        assert type(psched) is PagedScheduler and psched.prefix is None
        assert psched.stats == jsched.stats == {
            "full_hits": 0, "partial_hits": 0, "cold": len(traffic)}
        assert psched.pool_report() == jsched.pool_report()
        assert psched.pool_report()["live_blocks"] == 0


def test_fault_paged_insert_writes_each_layer_its_own_length(gemma):
    """A fresh prefill holds a 16-ring in layer 0 and 48 tokens in layer
    1; the insert writes each its own pages (the ring into the first one
    of the table's three), the pools JAX's after its insert."""
    jcfg, pcfg = gemma["jcfg"], gemma["pcfg"]
    jeng = JServeEngine(jcfg, gemma["jvars"][0])
    peng = ServeEngine(pcfg, gemma["pvars"][0], device="cpu")
    tokens = np.random.RandomState(5).randint(0, pcfg.vocab_size, (1, 20))
    _, jfresh = jeng.prefill(tokens, MAX_LEN)
    _, pfresh = peng.prefill(tokens, MAX_LEN)
    bids = [3, 1, 4]
    jpool = jeng.paged_insert(jeng.init_paged_pool(6, 16), jfresh, bids)
    ppool = peng.paged_insert(peng.init_paged_pool(6, 16), pfresh, bids)
    for si, layer in enumerate(ppool):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                layer[name].numpy(),
                np.asarray(jpool["g0"][f"slot{si}"]["attn"][name][0]),
                atol=1e-5, err_msg=f"layer {si} {name}")
    assert not ppool[0]["k"][1].any() and not ppool[0]["k"][4].any()


def test_windowed_paged_lane_refuses_a_ring_off_the_page():
    (_,), (pp,), pcfg = world(window_cfg(12))
    peng = ServeEngine(pcfg, pp, device="cpu")
    with pytest.raises(ValueError, match="ring 12 must be a multiple of "
                                         "the page size 8"):
        PagedScheduler(peng, num_slots=2, num_blocks=9, page=8, max_len=32)
    sched = PagedScheduler(peng, num_slots=2, num_blocks=9, page=4,
                           max_len=32)
    assert sched.prefix is None and sched._nbl_windowed == 8


@pytest.mark.parametrize("window", [4, 8, 12])
def test_tiny_windows_serve_jax_tokens(window):
    """JAX's windows on a tiny config: the contiguous scheduler's tokens
    (rings of 4, 8 and 12 viewed as 4-, 8- and 4-token pages) equal
    JAX's."""
    jcfg = window_cfg(window)
    jvars, pvars, pcfg = world(jcfg)
    traffic = _traffic(pcfg.vocab_size, n=4, seed=window)
    kw = dict(num_slots=2, max_len=32)
    jdone, _ = jmake_scheduler(JServeEngine(jcfg, jvars[0]),
                               JServingConfig(**kw)).run(
        [JRequest(**t) for t in traffic])
    pdone, _ = make_scheduler(ServeEngine(pcfg, pvars[0], device="cpu"),
                              ServingConfig(**kw)).run(
        [Request(**t) for t in traffic])
    for j, p in zip(jdone, pdone):
        np.testing.assert_array_equal(p.tokens, np.asarray(j.tokens))


# ---------------------------------------------------------------------------
# hot-swap with a pruned tenant
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_zlib(monkeypatch):
    """JAX's store writes zlib, as it does where `zstandard` is absent."""
    monkeypatch.setattr(jstore, "zstandard", None)


def test_hot_swap_with_a_pruned_tenant_matches_jax(gemma, jax_zlib):
    """A 3-row bank over a pruned tenant (the global layer only) and a
    dense one, each package serving the deltas it published: tokens equal,
    and each delta file the same bytes in both registries."""
    jcfg, pcfg = gemma["jcfg"], gemma["pcfg"]
    mask = imp.depth_mask(pcfg, 1)
    assert list(mask) == list(jimp.depth_mask(jcfg, 1))
    jv = [jimp.apply_layer_mask(gemma["jvars"][0], jcfg, mask),
          gemma["jvars"][1]]
    pv = [imp.apply_layer_mask(gemma["pvars"][0], pcfg, mask),
          gemma["pvars"][1]]
    traffic = _traffic(pcfg.vocab_size, n=4, seed=2)
    for i, t in enumerate(traffic):
        t.pop("task_id")
        t["adapter"] = f"task{i % 2}"
    with tempfile.TemporaryDirectory() as td:
        jreg = JAdapterRegistry(os.path.join(td, "jax"))
        preg = AdapterRegistry(os.path.join(td, "port"))
        for t, m in ((0, mask), (1, None)):
            jd = jhad.extract_delta(jv[t])
            jreg.publish(f"task{t}", jd if m is None
                         else jprune.prune_delta(jd, jcfg, m))
            preg.publish(f"task{t}", launcher.task_delta(pv[t], pcfg, m))
        for t in range(2):
            rel = os.path.join(f"task{t}", "step_0000000000", "delta.ckpt")
            with open(os.path.join(td, "jax", rel), "rb") as f, \
                    open(os.path.join(td, "port", rel), "rb") as g:
                assert f.read() == g.read(), t
        jbase = gemma["jvars"][2]
        jeng = JMultiTaskEngine(jcfg, JAdapterBank(jcfg, jbase, 3, jreg))
        peng = MultiTaskEngine(pcfg, AdapterBank(pcfg, gemma["pvars"][2], 3,
                                                 preg), device="cpu")
        kw = dict(num_slots=2, max_len=MAX_LEN)
        jdone, _ = jmake_scheduler(jeng, JServingConfig(**kw)).run(
            [JRequest(**t) for t in traffic])
        pdone, _ = make_scheduler(peng, ServingConfig(**kw)).run(
            [Request(**t) for t in traffic])
    for j, p in zip(jdone, pdone):
        np.testing.assert_array_equal(p.tokens, np.asarray(j.tokens),
                                      err_msg=p.adapter)
    np.testing.assert_array_equal(peng.adapter_bank.gates(),
                                  jeng.adapter_bank.gates())


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_bucketing_speculation_verify_and_extend_refuse_windows(gemma):
    pcfg, jcfg = gemma["pcfg"], gemma["jcfg"]
    peng = ServeEngine(pcfg, gemma["pvars"][0], device="cpu")
    assert not Scheduler.supports_bucketing(pcfg)
    assert Scheduler.supports_bucketing(get_smoke("qwen3-0.6b"))
    assert not Scheduler.supports_bucketing(get_smoke("rwkv6-1.6b"))
    with pytest.raises(ValueError, match="prefill_bucket requires "
                                         "full-attention slots"):
        make_scheduler(peng, ServingConfig(num_slots=2, max_len=MAX_LEN,
                                           prefill_bucket=8))
    with pytest.raises(ValueError) as jerr:
        JSpecScheduler(JServeEngine(jcfg, gemma["jvars"][0]), num_slots=2,
                       max_len=MAX_LEN, spec_k=2)
    for paged in (False, True):
        with pytest.raises(ValueError) as perr:
            make_scheduler(peng, ServingConfig(
                num_slots=2, max_len=MAX_LEN, spec_k=2, paged=paged))
        assert str(perr.value) == str(jerr.value)
    caches = peng.init_slot_caches(1, 32)
    with pytest.raises(ValueError, match="ring window"):
        peng.verify_step(caches, np.zeros((1, 3), np.int64), [4])
    pool = peng.init_paged_pool(4, 16)
    with pytest.raises(ValueError, match="ring layouts"):
        peng.paged_extend(pool, np.zeros((1, 16), np.int64),
                          np.asarray([[1, 2]]), start=16, kv_len=20,
                          last_pos=3)


# ---------------------------------------------------------------------------
# convert: two-slot groups, both directions
# ---------------------------------------------------------------------------


def test_two_slot_groups_unstack_group_repeat_slot_both_ways():
    """repeats=2 shows the order a (window, global) group unstacks in:
    layer 2*r + s holds repeat r of slot s, params and deltas both ways."""
    jcfg = gemma_cfg(2)
    (jp,), (pp,), pcfg = world(jcfg)
    tree = np_tree(jp)
    assert [s.window for s in pcfg.layer_slots()] == [16, None, 16, None]
    for li, (r, s) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        for leaf in (("adapter", "w"), ("post_attn_norm", "scale"),
                     ("attn", "wq")):
            np.testing.assert_array_equal(
                pp["layers"][li][leaf[0]][leaf[1]].numpy(),
                tree["blocks"]["g0"][f"slot{s}"][leaf[0]][leaf[1]][r])
    back = convert.to_jax_params(pp, pcfg)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        got = back
        for k in path:
            got = got[k.key]
        np.testing.assert_array_equal(got, leaf)
    jd = np_tree(jhad.extract_delta(jp))
    pd = convert.stack_delta(had.extract_delta(pp), pcfg)
    for slot in ("slot0", "slot1"):
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(
                pd["blocks"]["g0"][slot]["adapter"][leaf].numpy(),
                jd["blocks"]["g0"][slot]["adapter"][leaf])
    un = convert.unstack_delta(pd, pcfg)
    for li in range(4):
        np.testing.assert_array_equal(
            un["layers"][li]["adapter"]["w"].numpy(),
            pp["layers"][li]["adapter"]["w"].numpy())
    mask = imp.depth_mask(pcfg, 3)
    packed = prune.prune_delta(had.extract_delta(pp), pcfg, mask)
    jpacked = jprune.prune_delta(jhad.extract_delta(jp), jcfg, mask)
    for slot in ("slot0", "slot1"):
        p_leaf = packed["blocks"]["g0"][slot]["adapter"]["w"]
        j_leaf = jpacked["blocks"]["g0"][slot]["adapter"]["w"]
        np.testing.assert_array_equal(p_leaf.mask.numpy(),
                                      np.asarray(j_leaf.mask))
        np.testing.assert_array_equal(p_leaf.rows.numpy(),
                                      np.asarray(j_leaf.rows))
