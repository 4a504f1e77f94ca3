"""RG-LRU blocks and recurrentgemma serving: the port against the JAX package.

Same seed-made inputs and JAX-made weights on both sides, on the CPU
(#3, #4, #5, #6, #7 and #9 take their plain versions here; `chip_smoke.py`
holds the kernels to them on the card):
  * `rec_apply` in fp32 within 1e-5 at S in {1, 2, 3, 5, 37, 256}, with and
    without an incoming state (the conv state of prompts shorter than
    cw - 1 tokens included), the scan against a sequential recurrence, and
    bf16 within 2e-2 of max|ref|;
  * recurrentgemma's smoke config and a variant with its head layout (10
    heads of 256 on one KV head, at d 64), adapters perturbed under
    attn_out and attn_concat: a 40-token prefill past the window of 16
    and 8 greedy decode steps, each call's logits within 1e-4 of JAX's
    forward_lm at its position and each token JAX's argmax there, and
    forward_lm over the whole sequence within 1e-4;
  * the schedulers' tokens, with mid-decode admission, over one adapter, a
    3-task bank, a hot-swap bank holding a pruned tenant and an int8 trunk
    (its quant_summary JAX's, no rec projection quantized);
  * the refusals (the paged pool, speculation, bucketing: JAX's text; a
    padded last_pos), `fold_adapter` folding the attention layers alone,
    `lm_loss` and its adapter gradients, `convert` both ways, and the
    kernels' plans at the full model's shapes.
The JAX side runs under `jax.jit` where it is called directly: one
compile for each length of the block's cases, one forward a model config,
the int8 trunk quantized under it.
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
from repro.common import tree as jtu
from repro.configs import get as jax_get
from repro.configs import get_smoke as jax_get_smoke
from repro.core import hadamard as jhad
from repro.core import peft as jpeft
from repro.models import model as JM
from repro.models import recurrent as jrec
from repro.quant import qtensor as jq
from repro.serving import MultiTaskEngine as JMultiTaskEngine
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro.serving import ServingConfig as JServingConfig
from repro.serving import make_scheduler as jmake_scheduler
from repro.serving.registry import AdapterBank as JAdapterBank
from repro.serving.registry import AdapterRegistry as JAdapterRegistry
from repro.sparse import importance as jimp
from repro.sparse import prune as jprune
from repro.train import losses as jlosses
from repro_torch import convert
from repro_torch.common import tree as tu
from repro_torch.common import types as T
from repro_torch.configs import get, get_smoke
from repro_torch.core import hadamard as had
from repro_torch.core import peft
from repro_torch.kernels.attention import paged_split_plan
from repro_torch.kernels.hadamard import fused_norm_plan
from repro_torch.kernels.sparse import masked_plan
from repro_torch.launch import serve as launcher
from repro_torch.models import model as M
from repro_torch.models import recurrent as rec
from repro_torch.quant import qtensor
from repro_torch.quant import quant_summary
from repro_torch.serving import (AdapterBank, AdapterRegistry,
                                 MultiTaskEngine, Request, Scheduler,
                                 ServeEngine, ServingConfig, make_scheduler)
from repro_torch.sparse import importance as imp
from repro_torch.sparse import prune
from repro_torch.train import steps
from test_torch_model import KEY, np_tree, port_cfg

ARCH = "recurrentgemma-2b"
MAX_LEN = 48

_jrec = jax.jit(jrec.rec_apply, static_argnums=1)
# one compile a length covers the block without and with an incoming state
_jrec_both = jax.jit(lambda p, cfg, x, st: (jrec.rec_apply(p, cfg, x, None),
                                            jrec.rec_apply(p, cfg, x, st)),
                     static_argnums=1)
_jforward = jax.jit(JM.forward_lm, static_argnums=1)
_jquant = jax.jit(lambda t: jq.quantize_tree(t, "int8"))


def rg_cfg(position="attn_out", heads=False):
    """recurrentgemma smoke under the Hadamard adapter; with `heads`, the
    full model's head layout (10 heads of 256 on one KV head) at d 64."""
    name = "hadamard" if position == "attn_out" else "hadamard_concat"
    cfg = jpeft.attach(jax_get_smoke(ARCH), jpeft.strategy(name))
    return cfg.replace(n_heads=10, n_kv_heads=1, head_dim=256) if heads \
        else cfg


def world(jcfg, tasks=1):
    """(JAX variants, port variants, port cfg) over the same weights: the
    port's init from a seeded generator, each variant's adapters perturbed,
    carried into the JAX layout by `convert` (JAX's jitted init takes
    seconds to compile at every config)."""
    pcfg = port_cfg(jcfg)
    base = M.init_params(torch.Generator().manual_seed(0), pcfg)
    pvars = [had.perturb_adapters(base, 100 + t, scale=0.2)
             for t in range(tasks)]
    jvars = [jax.tree.map(jnp.asarray, convert.to_jax_params(v, pcfg))
             for v in pvars]
    return jvars, pvars, pcfg


@pytest.fixture(scope="module")
def rg():
    jcfg = rg_cfg()
    jvars, pvars, pcfg = world(jcfg, tasks=3)
    return dict(jcfg=jcfg, jvars=jvars, pvars=pvars, pcfg=pcfg)


def test_recurrentgemma_configs_match_jax_field_for_field():
    for jc, pc in ((jax_get(ARCH), get(ARCH)),
                   (jax_get_smoke(ARCH), get_smoke(ARCH))):
        assert dataclasses.asdict(port_cfg(jc)) == dataclasses.asdict(pc)
    full = get(ARCH)
    kinds = [s.kind for s in full.layer_slots()]
    assert full.n_layers == 26 and kinds.count("rec") == 18
    assert [s.window for s in full.layer_slots() if s.kind == "attn"] == \
        [2048] * 8


def test_full_size_parameters_by_shape():
    """2.894 B parameters, as JAX counts them (jax.eval_shape): 1,651 M in
    the 18 rec layers, 587 M in the 8 attention layers, 655 M in the tied
    embedding; a_param fp32 in a bf16 model."""
    cfg = get(ARCH)
    shapes = jax.eval_shape(lambda: JM.init_params(KEY, jax_get(ARCH)))
    want = sum(int(np.prod(s.shape)) for _, s in
               jtu.flatten_with_paths(shapes))
    with torch.device("meta"):
        params = M.init_params(None, cfg)
    count = [sum(t.numel() for _, t in tu.flatten_with_paths(layer))
             for layer in params["layers"]]
    total = sum(t.numel() for _, t in tu.flatten_with_paths(params))
    assert total == want
    slots = cfg.layer_slots()
    rec_n = sum(n for n, s in zip(count, slots) if s.kind == "rec")
    attn_n = sum(n for n, s in zip(count, slots) if s.kind == "attn")
    assert (total, rec_n, attn_n) == (2_894_574_080, 1_651_968_000,
                                      587_243_520)
    assert params["embed"]["table"].numel() == 655_360_000
    assert params["layers"][0]["rec"]["a_param"].dtype == torch.float32
    assert params["layers"][0]["rec"]["gate_a"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------


def _rec_world(dtype, seed=3):
    """A rec block of the smoke config (d = W = 64, cw 4) in `dtype`, its
    biases and conv taps moved off their init so every term shows; the
    JAX side holds the same values in the same dtypes."""
    jcfg = jax_get_smoke(ARCH).replace(param_dtype=dtype,
                                       compute_dtype=dtype)
    pcfg = port_cfg(jcfg)
    pp = rec.rec_init(torch.Generator().manual_seed(seed), pcfg)
    rs = np.random.RandomState(seed)
    for name in ("conv_b", "gate_a_b", "gate_x_b", "conv_w"):
        pp[name] = torch.from_numpy(rs.normal(0, 0.5, pp[name].shape)).to(
            pp[name].dtype)
    jp = {k: jnp.asarray(convert.to_numpy(v), jnp.dtype(str(v.dtype)[6:]))
          for k, v in pp.items()}
    return jcfg, pcfg, jp, pp, rs


def _state(rs, B, W, cw):
    return {"h": rs.normal(0, 1, (B, W)).astype(np.float32),
            "conv": rs.normal(0, 1, (B, cw - 1, W)).astype(np.float32)}


@pytest.fixture(scope="module")
def rec_fp32():
    """Per length S: the fp32 block, x, an incoming state, and JAX's
    outputs without and with that state, from one jitted JAX call."""
    cases = {}

    def case(S):
        if S not in cases:
            jcfg, pcfg, jp, pp, rs = _rec_world("float32")
            B, W, cw = 2, pcfg.lru_width, pcfg.conv1d_width
            x = rs.normal(0, 1, (B, S, pcfg.d_model)).astype(np.float32)
            st = _state(rs, B, W, cw)
            want = _jrec_both(jp, jcfg, jnp.asarray(x),
                              {k: jnp.asarray(v) for k, v in st.items()})
            cases[S] = (pcfg, pp, x, st, jax.tree.map(np.asarray, want))
        return cases[S]
    return case


@pytest.mark.parametrize("incoming", [False, True])
@pytest.mark.parametrize("S", [1, 2, 3, 5, 37, 256])
def test_rec_apply_fp32_matches_jax(rec_fp32, S, incoming):
    """y, h and the conv state within 1e-5; a prompt shorter than cw - 1
    tokens keeps the tail of the incoming conv state, as JAX's does."""
    pcfg, pp, x, st, wants = rec_fp32(S)
    cw = pcfg.conv1d_width
    want_y, want_c = wants[1] if incoming else wants[0]
    cache = {k: torch.from_numpy(v.copy()) for k, v in st.items()} \
        if incoming else None
    got_y, got_c = rec.rec_apply(pp, pcfg, torch.from_numpy(x), cache)
    np.testing.assert_allclose(got_y.numpy(), want_y, atol=1e-5, rtol=0)
    for k in ("h", "conv"):
        np.testing.assert_allclose(got_c[k].numpy(), want_c[k], atol=1e-5,
                                   rtol=0, err_msg=k)
    if incoming:  # decode writes the cache it was given, in place
        assert got_c is cache
        if S < cw - 1:
            np.testing.assert_array_equal(got_c["conv"][:, :cw - 1 - S],
                                          st["conv"][:, S:])


def test_scan_is_the_sequential_recurrence():
    """The associative scan's h_t against h_t = a_t h_{t-1} + b_t step by
    step, in float64, over ragged lengths."""
    rs = np.random.RandomState(0)
    for S in (2, 3, 7, 64, 101):
        a = torch.from_numpy(rs.uniform(0.5, 1.0, (2, S, 8)))
        b = torch.from_numpy(rs.normal(0, 1, (2, S, 8)))
        A, Bc = rec._assoc_scan(a, b)
        h = torch.zeros(2, 8, dtype=torch.float64)
        h0 = torch.from_numpy(rs.normal(0, 1, (2, 8)))
        hs, prod = [], torch.ones(2, 8, dtype=torch.float64)
        h = h0.clone()
        for t in range(S):
            h = a[:, t] * h + b[:, t]
            prod = prod * a[:, t]
            hs.append(h)
        got = Bc + A * h0[:, None]
        torch.testing.assert_close(got, torch.stack(hs, 1), rtol=1e-12,
                                   atol=1e-12)
        torch.testing.assert_close(A[:, -1], prod, rtol=1e-12, atol=0)


@pytest.mark.parametrize("S", [1, 37])
def test_rec_apply_bf16_within_2e2_of_max_ref(S):
    jcfg, pcfg, jp, pp, rs = _rec_world("bfloat16", seed=5)
    B, W, cw = 2, pcfg.lru_width, pcfg.conv1d_width
    x = rs.normal(0, 1, (B, S, pcfg.d_model)).astype(np.float32)
    st = _state(rs, B, W, cw)
    jst = {"h": jnp.asarray(st["h"]),
           "conv": jnp.asarray(st["conv"], jnp.bfloat16)}
    want_y, want_c = _jrec(jp, jcfg, jnp.asarray(x, jnp.bfloat16), jst)
    cache = {"h": torch.from_numpy(st["h"].copy()),
             "conv": torch.from_numpy(st["conv"]).to(torch.bfloat16)}
    got_y, got_c = rec.rec_apply(pp, pcfg, torch.from_numpy(x).to(
        torch.bfloat16), cache)
    assert got_y.dtype == torch.bfloat16 and got_c["h"].dtype == torch.float32
    for got, want in ((got_y, want_y), (got_c["h"], want_c["h"])):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=2e-2 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("heads", [False, True])
@pytest.mark.parametrize("position", ["attn_out", "attn_concat"])
def test_forward_prefill_and_decode_match_jax(position, heads):
    """A 40-token prefill past the window of 16 and 8 greedy decode steps:
    the prefill's and each step's logits within 1e-4 of JAX's forward_lm
    at that position over the greedy sequence, each greedy token JAX's
    argmax there; forward_lm over the whole sequence within 1e-4. One JAX
    call a config (the schedulers' tests hold the decode path to JAX's
    own, token for token)."""
    jcfg = rg_cfg(position, heads)
    (jp,), (pp,), pcfg = world(jcfg)
    if position == "attn_concat":  # the rec seam is d_model wide
        widths = {s.kind: layer["adapter"]["w"].shape[0] for s, layer in
                  zip(pcfg.layer_slots(), pp["layers"])}
        assert widths == {"rec": pcfg.d_model, "attn": pcfg.q_dim}
    rs = np.random.RandomState(7)
    tokens = rs.randint(0, pcfg.vocab_size, (2, 40))
    got, pc = M.prefill_lm(pp, pcfg, torch.from_numpy(tokens), MAX_LEN)
    assert [tuple(c) for c in pc[:3]] == [("h", "conv")] * 2 + [("k", "v")]
    assert pc[2]["k"].shape[1] == 16
    steps_logits, picked = [got[:, -1]], []
    for step in range(8):
        pt = got[:, -1].argmax(-1)
        picked.append(pt.numpy())
        pos = torch.full((2,), 40 + step)
        got, pc = M.decode_lm(pp, pcfg, pc, pt[:, None], pos)
        steps_logits.append(got[:, -1])
    seq = np.concatenate([tokens, np.stack(picked, 1)], 1)
    want = np.asarray(_jforward(jp, jcfg, jnp.asarray(seq))[0])
    np.testing.assert_allclose(
        M.forward_lm(pp, pcfg, torch.from_numpy(seq)).numpy(), want,
        atol=1e-4, rtol=0)
    for step, logits in enumerate(steps_logits):
        w = want[:, 39 + step]
        np.testing.assert_allclose(logits.numpy(), w, atol=1e-4, rtol=0,
                                   err_msg=f"step {step}")
        if step < 8:
            np.testing.assert_array_equal(picked[step], w.argmax(-1),
                                          err_msg=f"step {step}")


# ---------------------------------------------------------------------------
# the schedulers
# ---------------------------------------------------------------------------


def _traffic(vocab, n=5, tasks=0, seed=11):
    """Prompts of 2 or 20 tokens (one under cw - 1, one past the 16-ring),
    budgets of 3-7: more requests than slots, so admissions land
    mid-decode over rows whose state an earlier request left."""
    rs = np.random.RandomState(seed)
    return [dict(prompt=rs.randint(0, vocab, (int(rs.choice([2, 20])),)),
                 max_new_tokens=int(rs.randint(3, 8)),
                 task_id=i % tasks if tasks else 0) for i in range(n)]


def _run_both(jeng, peng, traffic, **kw):
    kw = dict(num_slots=2, max_len=MAX_LEN, **kw)
    jdone, _ = jmake_scheduler(jeng, JServingConfig(**kw)).run(
        [JRequest(**t) for t in traffic])
    pdone, report = make_scheduler(peng, ServingConfig(**kw)).run(
        [Request(**t) for t in traffic])
    assert report["requests"] == len(traffic)
    for j, p, t in zip(jdone, pdone, traffic):
        assert len(p.tokens) == t["max_new_tokens"]
        np.testing.assert_array_equal(p.tokens, np.asarray(j.tokens),
                                      err_msg=f"request {p.request_id}")


@pytest.mark.parametrize("mode", ["single", "bank", "int8"])
def test_scheduler_tokens_match_jax(rg, mode):
    """Mid-decode admission into 2 slots: one adapter, a 3-task bank (#6 at
    every seam, rec layers too), an int8 trunk (attention and MLP
    projections; quant_summary JAX's)."""
    jcfg, pcfg = rg["jcfg"], rg["pcfg"]
    tasks = 3 if mode == "bank" else 0
    traffic = _traffic(pcfg.vocab_size, tasks=tasks)
    quant = "int8" if mode == "int8" else None
    if tasks:
        jeng = JMultiTaskEngine(jcfg, rg["jvars"])
        peng = MultiTaskEngine(pcfg, rg["pvars"], device="cpu")
    else:
        # quantized under jax.jit: the engine's quantize_tree passes the
        # QTensor leaves through (its eager op-by-op dispatch took ~2 s)
        jp = rg["jvars"][0] if quant is None else _jquant(rg["jvars"][0])
        jeng = JServeEngine(jcfg, jp, quant=quant)
        peng = ServeEngine(pcfg, rg["pvars"][0], quant=quant, device="cpu")
    _run_both(jeng, peng, traffic)
    if quant:
        jqs = jq.quant_summary(jeng.params)
        pqs = quant_summary(peng.params, lambda p: convert.jax_path(p, pcfg))
        assert pqs["n_quantized_leaves"] == jqs["n_quantized_leaves"] == 19
        assert pqs["quantized_bytes"] == jqs["quantized_bytes"]
        for path, leaf in tu.flatten_with_paths(peng.params):
            if "/rec/" in path:
                assert not isinstance(leaf, qtensor.QTensor), path


@pytest.fixture
def jax_zlib(monkeypatch):
    """JAX's store writes zlib, as it does where `zstandard` is absent."""
    monkeypatch.setattr(jstore, "zstandard", None)


def test_hot_swap_with_a_pruned_tenant_matches_jax(rg, jax_zlib):
    """A 3-row bank over a tenant pruned to the paper-0.022 preset (the top
    3 of 5 layers: rec, attention, rec, rec) and a dense one (#9 at every
    seam with its gates), each package serving the deltas it published:
    tokens and gates equal."""
    jcfg, pcfg = rg["jcfg"], rg["pcfg"]
    mask = prune.preset_mask(pcfg)
    assert list(mask) == list(jprune.preset_mask(jcfg)) == [False] * 2 + \
        [True] * 3
    jv = [jimp.apply_layer_mask(rg["jvars"][0], jcfg, mask), rg["jvars"][1]]
    pv = [imp.apply_layer_mask(rg["pvars"][0], pcfg, mask), rg["pvars"][1]]
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
        jeng = JMultiTaskEngine(jcfg, JAdapterBank(jcfg, rg["jvars"][2], 3,
                                                   jreg))
        peng = MultiTaskEngine(pcfg, AdapterBank(pcfg, rg["pvars"][2], 3,
                                                 preg), device="cpu")
        _run_both(jeng, peng, traffic)
    np.testing.assert_array_equal(peng.adapter_bank.gates(),
                                  jeng.adapter_bank.gates())


def test_int8_forward_runs_dequant_matmul_at_every_projection_but_rec(
        rg, monkeypatch):
    """Each quantized leaf takes one #7 call a forward: 19 at the smoke
    config (5 MLPs and one attention layer); at full size the port holds
    110 such leaves (26 MLPs x 3 + 8 attention layers x 4), which JAX
    stacks into 19, and no rec projection is among them."""
    calls = []
    real = qtensor.DequantMatmul.apply
    monkeypatch.setattr(qtensor.DequantMatmul, "apply",
                        lambda *a: calls.append(a[1].shape) or real(*a))
    peng = ServeEngine(rg["pcfg"], rg["pvars"][0], quant="int8",
                       device="cpu")
    M.forward_lm(peng.params, rg["pcfg"], torch.zeros((1, 4), dtype=torch.long))
    assert len(calls) == 19
    cfg = get(ARCH)
    with torch.device("meta"):
        params = M.init_params(None, cfg)
    paths = [p for p, _ in tu.flatten_with_paths(params)
             if qtensor.quantizable("/" + p)]
    assert len(paths) == 110 and not any("/rec/" in p for p in paths)
    shapes = jax.eval_shape(lambda: JM.init_params(KEY, jax_get(ARCH)))
    assert {convert.jax_path(p, cfg) for p in paths} == {
        p for p, _ in jtu.flatten_with_paths(shapes)
        if jq.quantizable("/" + p)}


# ---------------------------------------------------------------------------
# refusals, folding, training, convert, plans
# ---------------------------------------------------------------------------


def test_paged_speculation_bucketing_and_padded_prefill_refuse(rg):
    jcfg, pcfg = rg["jcfg"], rg["pcfg"]
    peng = ServeEngine(pcfg, rg["pvars"][0], device="cpu")
    jeng = JServeEngine(jcfg, rg["jvars"][0])
    assert not Scheduler.supports_bucketing(pcfg)
    for kw in (dict(paged=True, page_size=16), dict(prefill_bucket=8),
               dict(spec_k=2), dict(spec_k=2, paged=True, page_size=16)):
        with pytest.raises(ValueError) as jerr:
            jmake_scheduler(jeng, JServingConfig(num_slots=2, max_len=MAX_LEN,
                                                 **kw))
        with pytest.raises(ValueError) as perr:
            make_scheduler(peng, ServingConfig(num_slots=2, max_len=MAX_LEN,
                                               **kw))
        assert str(perr.value) == str(jerr.value), kw
    with pytest.raises(ValueError, match="pure attention slots"):
        peng.init_paged_pool(4, 16)
    with pytest.raises(ValueError, match="recurrent state would take"):
        M.prefill_lm(rg["pvars"][0], pcfg, torch.zeros((1, 8),
                                                      dtype=torch.long),
                     MAX_LEN, last_pos=5)
    with pytest.raises(ValueError, match="recurrent state would take"):
        peng.verify_step(peng.init_slot_caches(1, 32),
                         np.zeros((1, 3), np.int64), [4])


def test_fold_adapter_folds_the_attention_layers_alone(rg):
    """JAX's fold touches the blocks that hold attn: the rec layers keep
    their adapters live, leaf for leaf JAX's; folded greedy tokens equal
    JAX's folded engine's."""
    jcfg, pcfg = rg["jcfg"], rg["pcfg"]
    jp, pp = rg["jvars"][0], rg["pvars"][0]
    want = np_tree(jhad.fold_adapter(jp, jcfg))
    folded = had.fold_adapter(pp, pcfg)
    got = convert.to_jax_params(folded, pcfg)
    flat = dict(jtu.flatten_with_paths(want))
    for path, leaf in jtu.flatten_with_paths(got):
        np.testing.assert_allclose(leaf, flat[path], atol=1e-6, rtol=0,
                                   err_msg=path)
    for s, before, after in zip(pcfg.layer_slots(), pp["layers"],
                                folded["layers"]):
        same = torch.equal(before["adapter"]["w"], after["adapter"]["w"])
        assert same == (s.kind == "rec"), s
    traffic = _traffic(pcfg.vocab_size, n=3, seed=6)
    _run_both(JServeEngine(jcfg, jp, fold=True),
              ServeEngine(pcfg, pp, fold=True, device="cpu"), traffic)


def test_lm_loss_and_adapter_gradients_match_jax(rg):
    """lm_loss within 1e-5 relative, every adapter (and ffn-norm) gradient
    within 1e-5 of its max |JAX gradient|: the rec layers' adapters
    included, and through the scan."""
    jcfg, pcfg = rg["jcfg"], rg["pcfg"]
    jparams, ported = rg["jvars"][0], rg["pvars"][0]
    rs = np.random.RandomState(2)
    tokens = rs.randint(0, pcfg.vocab_size, (2, 24))
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    strat = jpeft.strategy("hadamard")
    jtr, jfr = jtu.partition(jparams, jpeft.trainable_mask(jparams, strat))

    def jloss(tr):
        return jlosses.lm_loss(jcfg, jtu.merge(tr, jfr),
                               {k: jnp.asarray(v) for k, v in batch.items()})

    (wl, _), wg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jtr)
    state = steps.make_state(None, pcfg, peft.strategy("hadamard"),
                             T.OptimCfg(), params=ported)
    gl, _, gg = steps.loss_and_grads(
        pcfg, state, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    assert abs(gl.item() - float(wl)) <= 1e-5 * abs(float(wl))
    want = dict(jtu.flatten_with_paths(wg))
    got = {}
    for path, g in gg.items():
        got.setdefault(convert.jax_path(path, pcfg), []).append(g.numpy())
    assert set(got) == {p for p, v in want.items() if v is not None}
    assert any("g1/slot0/adapter" in p for p in got)  # a rec layer's
    for path, g in got.items():
        w = np.asarray(want[path])
        np.testing.assert_allclose(np.stack(g), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=path)


def test_convert_round_trips_across_the_two_groups(rg):
    """Layer 3*r + s holds repeat r of group 0's slot s, then group 1's two
    rec layers; every leaf back in the JAX layout the same bits, a_param
    fp32 in a bf16 tree too; jax_path names each leaf."""
    jp, pp, pcfg = rg["jvars"][0], rg["pvars"][0], rg["pcfg"]
    tree = np_tree(jp)
    order = [("g0", "slot0"), ("g0", "slot1"), ("g0", "slot2"),
             ("g1", "slot0"), ("g1", "slot1")]
    for li, (g, s) in enumerate(order):
        kind = "attn" if s == "slot2" else "rec"
        assert kind in pp["layers"][li]
        for leaf, v in pp["layers"][li][kind].items():
            np.testing.assert_array_equal(
                v.numpy(), tree["blocks"][g][s][kind][leaf][0])
            assert convert.jax_path(f"layers/{li}/{kind}/{leaf}", pcfg) == \
                f"blocks/{g}/{s}/{kind}/{leaf}"
    back = convert.to_jax_params(pp, pcfg)
    flat = dict(jtu.flatten_with_paths(tree))
    got = dict(jtu.flatten_with_paths(back))
    assert set(got) == set(flat) and any("/rec/a_param" in p for p in flat)
    for path, leaf in flat.items():
        np.testing.assert_array_equal(got[path], leaf, err_msg=path)
    bf = jax_get_smoke(ARCH).replace(param_dtype="bfloat16",
                                     compute_dtype="bfloat16")
    shapes = jax.eval_shape(lambda: JM.init_params(KEY, bf))
    pb = convert.from_jax_params(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), shapes), port_cfg(bf), "cpu")
    assert pb["layers"][0]["rec"]["a_param"].dtype == torch.float32
    assert pb["layers"][0]["rec"]["gate_x"].dtype == torch.bfloat16


def test_plans_at_the_full_shapes():
    """From shapes alone: #3 at d 2560 takes `split_row` in bf16 (3 warps
    a row, the fp32 row in shared memory) and `warp_row` in fp32 (4 warps
    a row); #5's 10 query rows on one KV head in 2 chunks of 8, 64
    splits over the ring of 2048, 33,024 B of shared memory; #6/#9 a
    block of 256 threads a request."""
    bf, f32 = torch.bfloat16, torch.float32
    for n in (4, 128, 4160):
        assert fused_norm_plan(n, 2560, bf) == dict(
            kernel="split_row", vec=8, warps_per_row=3, rows_per_block=1,
            blocks=n)
        assert fused_norm_plan(n, 2560, f32) == dict(
            kernel="warp_row", vec=4, warps_per_row=4, rows_per_block=1,
            blocks=n)
    for B in (2, 4):
        assert paged_split_plan(B, 10, 1, 1, 256, 16, 2048 // 16, 2048) == {
            "pages_per_split": 2, "splits": 64, "rows_per_block": 8,
            "row_chunks": 2, "blocks": 128 * B, "ring": 2048,
            "scratch_shape": (B, 10, 1, 64, 258), "smem_bytes": 33024}
    assert masked_plan(4, 1, 2560) == dict(vec=8, threads=256, blocks=8)
    assert masked_plan(4, 1, 2560, f32) == dict(vec=4, threads=256,
                                                blocks=12)
