"""Folding, the unified `generate`, the stream callback and the launcher's
--fold, --static and --stream: the port against the JAX package.

Same JAX-made weights (perturbed adapters) on both sides, fp32, on the CPU:
  * `fold_adapter` leaf by leaf JAX's, at both positions, with and without
    attention biases; JAX's token-identity test of a folded engine
    (`tests/test_serving.py:34`) in the port and against JAX's folded
    engine, and folding before an int8 quantization, the quantized leaves
    JAX's byte for byte and the tokens JAX's;
  * `generate(list[Request])`: per-request budgets and EOS, each row
    JAX's; the deprecated `generate_for_tasks`/`generate_for_adapters`
    JAX's tokens, warning as JAX's do;
  * the `stream` callback: every (request id, token) in JAX's order,
    contiguous and paged;
  * the launcher's --static (single adapter and bank), --stream and
    --fold at --smoke, and its refusal of --static with --adapter-dir.
"""
import ast
import contextlib
import io
import os
import re
import tempfile

import jax
import numpy as np
import pytest

import repro.checkpoint.store as jstore
from repro.common.types import AdapterCfg as JAdapterCfg
from repro.core import hadamard as jhad
from repro.models import model as JM
from repro.quant.qtensor import quantize_tree as jquantize_tree
from repro.serving import MultiTaskEngine as JMultiTaskEngine
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro.serving import ServingConfig as JServingConfig
from repro.serving import make_scheduler as jmake_scheduler
from repro.serving.registry import AdapterBank as JAdapterBank
from repro.serving.registry import AdapterRegistry as JAdapterRegistry
from repro_torch import convert
from repro_torch.common import tree as tu
from repro_torch.core import hadamard as had
from repro_torch.launch import serve as launcher
from repro_torch.quant.qtensor import is_qtensor
from repro_torch.serving import (AdapterBank, AdapterRegistry,
                                 MultiTaskEngine, Request, ServeEngine,
                                 ServingConfig, make_scheduler)
from conftest import tiny_cfg
from test_torch_model import KEY, jax_cfg, np_tree, port_cfg

SMOKE = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu"]


def fold_world(position, attn_bias):
    """JAX's fold test's world: a tiny config, adapters off the identity
    (JAX's `_perturbed_params`: 0.1-sized normal draws on w and b)."""
    jcfg = tiny_cfg(adapter=JAdapterCfg(kind="hadamard", position=position),
                    attn_bias=attn_bias)
    p = JM.init_params(KEY, jcfg)

    def perturb(path, v):
        if path.endswith("adapter/w"):
            return v + 0.1 * jax.random.normal(jax.random.fold_in(KEY, 1),
                                               v.shape)
        if path.endswith("adapter/b"):
            return v + 0.1 * jax.random.normal(jax.random.fold_in(KEY, 2),
                                               v.shape)
        return v

    from repro.common import tree as jtu
    jp = jtu.map_with_path(perturb, p)
    pcfg = port_cfg(jcfg)
    return jcfg, jp, pcfg, convert.from_jax_params(np_tree(jp), pcfg, "cpu")


@pytest.mark.parametrize("attn_bias", [True, False])
@pytest.mark.parametrize("position", ["attn_out", "attn_concat"])
def test_fold_adapter_is_jax_leaf_by_leaf(position, attn_bias):
    jcfg, jp, pcfg, pp = fold_world(position, attn_bias)
    want = np_tree(jhad.fold_adapter(jp, jcfg))
    got = convert.to_jax_params(had.fold_adapter(pp, pcfg), pcfg)
    flat_w = dict(tu.flatten_with_paths(want))
    flat_g = dict(tu.flatten_with_paths(got))
    assert set(flat_g) == set(flat_w)
    for path, leaf in flat_w.items():
        g = flat_g[path]
        assert g.dtype == leaf.dtype and g.shape == leaf.shape, path
        np.testing.assert_allclose(g, leaf, atol=1e-6, rtol=1e-6,
                                   err_msg=path)
    for layer in had.fold_adapter(pp, pcfg)["layers"]:
        assert bool((layer["adapter"]["w"] == 1).all())
        assert not layer["adapter"]["b"].any()
    # the input is not changed
    np.testing.assert_array_equal(
        pp["layers"][0]["adapter"]["w"].numpy(),
        np.asarray(jp["blocks"]["g0"]["slot0"]["adapter"]["w"][0]))


@pytest.mark.parametrize("position", ["attn_out", "attn_concat"])
def test_serve_fold_equivalence_token_identical(position):
    """JAX's test, in the port: the folded engine generates the unfolded
    engine's tokens through prefill and cached decode, and JAX's folded
    engine's."""
    jcfg, jp, pcfg, pp = fold_world(position, True)
    toks = np.asarray(jax.random.randint(KEY, (2, 10), 0, 97))
    out = ServeEngine(pcfg, pp, device="cpu").generate(toks, 8)
    folded = ServeEngine(pcfg, pp, fold=True, device="cpu").generate(toks, 8)
    np.testing.assert_array_equal(out, folded, err_msg=position)
    jout = JServeEngine(jcfg, jp, fold=True).generate(toks, 8)
    np.testing.assert_array_equal(folded, np.asarray(jout), err_msg=position)


def test_fold_then_quant_is_jax_byte_for_byte():
    """Folding comes before quantization, as in JAX: the folded, int8
    trunk's leaves are JAX's bytes, and the tokens JAX's."""
    jcfg, jp, pcfg, pp = fold_world("attn_out", True)
    jeng = JServeEngine(jcfg, jp, fold=True, quant="int8")
    peng = ServeEngine(pcfg, pp, fold=True, quant="int8", device="cpu")
    want = jquantize_tree(jhad.fold_adapter(jp, jcfg), mode="int8")
    wo = want["blocks"]["g0"]["slot0"]["attn"]["wo"]
    for r in range(jcfg.groups[0].repeats):
        got = peng.params["layers"][r]["attn"]["wo"]
        assert is_qtensor(got)
        np.testing.assert_array_equal(got.values.numpy(),
                                      np.asarray(wo.values[r]))
        np.testing.assert_array_equal(got.scales.numpy(),
                                      np.asarray(wo.scales[r]))
    toks = np.asarray(jax.random.randint(KEY, (2, 10), 0, 97))
    np.testing.assert_array_equal(peng.generate(toks, 6),
                                  np.asarray(jeng.generate(toks, 6)))
    # the quantized, folded engine keeps the identity adapter
    assert bool((peng.params["layers"][0]["adapter"]["w"] == 1).all())


# ---------------------------------------------------------------------------
# generate(list[Request]) and the deprecated entry points
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bank_world():
    jcfg = jax_cfg("tiny")
    pcfg = port_cfg(jcfg)
    base = JM.init_params(KEY, jcfg)
    jvars = [jhad.perturb_adapters(base, jax.random.fold_in(KEY, 100 + t),
                                   scale=0.2) for t in range(3)]
    pvars = [convert.from_jax_params(np_tree(v), pcfg, "cpu") for v in jvars]
    return dict(jcfg=jcfg, pcfg=pcfg, jvars=jvars, pvars=pvars,
                jbase=base, pbase=convert.from_jax_params(np_tree(base),
                                                          pcfg, "cpu"))


def test_generate_requests_budgets_and_eos_match_jax(bank_world):
    w = bank_world
    prompts = np.random.RandomState(3).randint(0, 97, (3, 7))
    jeng = JServeEngine(w["jcfg"], w["jvars"][0])
    peng = ServeEngine(w["pcfg"], w["pvars"][0], device="cpu")
    full = peng.generate(prompts, 6)
    np.testing.assert_array_equal(full, np.asarray(jeng.generate(prompts, 6)))
    eos = int(full[1, 2])
    reqs = [dict(prompt=prompts[0], max_new_tokens=3),
            dict(prompt=prompts[1], max_new_tokens=6, eos_id=eos),
            dict(prompt=prompts[2], max_new_tokens=5)]
    got = peng.generate([Request(**r) for r in reqs])
    want = jeng.generate([JRequest(**r) for r in reqs])
    assert [len(g) for g in got] == [3, int(np.flatnonzero(
        full[1] == eos)[0]) + 1, 5]
    for g, j in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(j))
    # max_new_tokens caps every budget
    capped = peng.generate([Request(**r) for r in reqs], max_new_tokens=2)
    assert [len(g) for g in capped] == [2, min(2, len(got[1])), 2]
    with pytest.raises(ValueError, match="same-length"):
        peng.generate([Request(prompt=prompts[0], max_new_tokens=2),
                       Request(prompt=prompts[1, :5], max_new_tokens=2)])
    with pytest.raises(ValueError, match="MultiTaskEngine"):
        peng.generate([Request(prompt=prompts[0], max_new_tokens=2,
                               task_id=1)])
    with pytest.raises(ValueError, match="max_new_tokens"):
        peng.generate(prompts)


@pytest.fixture
def jax_zlib(monkeypatch):
    monkeypatch.setattr(jstore, "zstandard", None)


def test_bank_generate_paths_match_jax(bank_world, jax_zlib):
    """A static bank's generate(list[Request]) and generate_for_tasks, and
    a hot-swap bank's generate_for_adapters, greedy: JAX's tokens, with
    JAX's deprecation warnings; the pins released."""
    w = bank_world
    prompts = np.random.RandomState(5).randint(0, 97, (3, 6))
    tids = [2, 0, 1]
    jeng = JMultiTaskEngine(w["jcfg"], w["jvars"])
    peng = MultiTaskEngine(w["pcfg"], w["pvars"], device="cpu")
    reqs = [dict(prompt=p, max_new_tokens=4, task_id=t)
            for p, t in zip(prompts, tids)]
    got = peng.generate([Request(**r) for r in reqs])
    want = jeng.generate([JRequest(**r) for r in reqs])
    for g, j in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(j))
    with pytest.warns(DeprecationWarning, match="generate_for_tasks"):
        ptasks = peng.generate_for_tasks(prompts, tids, 4)
    with pytest.warns(DeprecationWarning):
        jtasks = jeng.generate_for_tasks(prompts, np.asarray(tids), 4)
    np.testing.assert_array_equal(ptasks, np.asarray(jtasks))
    np.testing.assert_array_equal(ptasks, np.stack(got))
    with tempfile.TemporaryDirectory() as td:
        jreg = JAdapterRegistry(os.path.join(td, "j"))
        preg = AdapterRegistry(os.path.join(td, "p"))
        for t in range(3):
            jreg.publish(f"task{t}", jhad.extract_delta(w["jvars"][t]))
            preg.publish(f"task{t}", launcher.task_delta(w["pvars"][t],
                                                         w["pcfg"]))
        jbank = JMultiTaskEngine(w["jcfg"], JAdapterBank(
            w["jcfg"], w["jbase"], 2, jreg))
        pbank = MultiTaskEngine(w["pcfg"], AdapterBank(
            w["pcfg"], w["pbase"], 2, preg), device="cpu")
        names = ["task1", "task0", "task1"]
        with pytest.warns(DeprecationWarning, match="generate_for_adapters"):
            pnamed = pbank.generate_for_adapters(prompts, names, 4)
        with pytest.warns(DeprecationWarning):
            jnamed = jbank.generate_for_adapters(prompts, names, 4)
        np.testing.assert_array_equal(pnamed, np.asarray(jnamed))
        np.testing.assert_array_equal(pnamed[1], ptasks[1])
        assert not any(pbank.adapter_bank._pins.values())
        assert pbank.adapter_bank.stats() == {
            k: v for k, v in jbank.adapter_bank.stats().items()
            if k in pbank.adapter_bank.stats()}
    with pytest.raises(ValueError, match="AdapterBank"):
        peng.generate_for_adapters(prompts, names, 2)


# ---------------------------------------------------------------------------
# the stream callback
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True])
def test_stream_callback_order_matches_jax(bank_world, paged):
    w = bank_world
    rs = np.random.RandomState(8)
    traffic = [dict(prompt=rs.randint(0, 97, (int(rs.choice([4, 9])),)),
                    max_new_tokens=int(rs.randint(2, 6))) for _ in range(5)]
    kw = dict(num_slots=2, max_len=32)
    if paged:
        kw.update(paged=True, page_size=8, num_blocks=12)
    seen = {"jax": [], "port": []}
    jdone, _ = jmake_scheduler(JServeEngine(w["jcfg"], w["jvars"][0]),
                               JServingConfig(stream=lambda r, t: seen[
                                   "jax"].append((r, t)), **kw)).run(
        [JRequest(**t) for t in traffic])
    scfg = ServingConfig(stream=lambda r, t: seen["port"].append((r, t)),
                         **kw)
    pdone, _ = make_scheduler(ServeEngine(w["pcfg"], w["pvars"][0],
                                          device="cpu"), scfg).run(
        [Request(**t) for t in traffic])
    assert seen["port"] == [(int(r), int(t)) for r, t in seen["jax"]]
    assert len(seen["port"]) == sum(t["max_new_tokens"] for t in traffic)
    for c in pdone:
        assert [t for r, t in seen["port"] if r == c.request_id] == \
            c.tokens.tolist()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def run_launcher(*flags):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launcher.main([*SMOKE, *flags])
    return out.getvalue()


def served_tokens(text):
    """Each request's first 8 tokens as the launcher prints them."""
    return re.findall(r"^req\d+ .*: (\[.*\])$", text, re.M)


@pytest.mark.parametrize("tasks", [0, 3])
def test_launcher_static_is_the_scheduler_s_tokens(tasks):
    flags = ["--requests", "4", "--new-tokens", "5"] + (
        ["--tasks", str(tasks)] if tasks else [])
    static = run_launcher("--static", *flags)
    assert "static batch: generated (4, 5) in" in static
    rows = re.findall(r"\[([\d ]+)\]", static.split("static batch:")[1])
    served = served_tokens(run_launcher(*flags))
    assert len(rows) == len(served) == 4
    for row, s in zip(rows, served):
        assert [int(t) for t in row.split()] == ast.literal_eval(s)


def test_launcher_stream_prints_every_token_in_order():
    text = run_launcher("--stream", "--requests", "3", "--new-tokens", "4")
    streamed = re.findall(r"^  req(\d+) \+= (\d+)$", text, re.M)
    assert len(streamed) == 12
    for rid, toks in enumerate(served_tokens(text)):
        assert [int(t) for r, t in streamed if int(r) == rid] == ast.literal_eval(toks)


def test_launcher_fold_serves_the_unfolded_tokens():
    flags = ["--requests", "3", "--new-tokens", "6"]
    folded = run_launcher("--fold", *flags)
    assert "served 3 requests / 18 tokens" in folded
    assert served_tokens(folded) == served_tokens(run_launcher(*flags))
    static = run_launcher("--fold", "--static", *flags)
    rows = re.findall(r"\[([\d ]+)\]", static.split("static batch:")[1])
    assert [[int(t) for t in r.split()] for r in rows] == \
        [ast.literal_eval(s) for s in served_tokens(folded)]


def test_launcher_refuses_static_with_an_adapter_dir(tmp_path):
    with pytest.raises(SystemExit, match="drop --static"):
        launcher.main([*SMOKE, "--static", "--tasks", "2", "--adapter-dir",
                       str(tmp_path)])
