"""Quantized-backbone serving of the port against the JAX package's.

Engines over the qwen3 smoke config (fp32) with perturbed adapters,
quantized int8 and fp8 by each package from the same JAX-made weights:
prefill and decode logits within 1e-4 of JAX's quantized engine, and
greedy scheduler tokens identical to JAX's with mid-decode admission, for
one adapter and a 3-task bank. On weights that lie on the int8 grid an int8
engine must give the tokens of the unquantized one. On the CPU the dequant
matmul takes its plain version; the CUDA kernel is held to it on the card.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.core import hadamard as jhad
from repro.core import peft as jpeft
from repro.kernels import ops as jops
from repro.models import model as JM
from repro.quant import qtensor as jq
from repro.serving import MultiTaskEngine as JMultiTaskEngine
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro.serving import ServingConfig as JServingConfig
from repro.serving import make_scheduler as jmake_scheduler
from repro_torch import convert
from repro_torch.common import tree as tu
from repro_torch.configs import get_smoke
from repro_torch.core import peft
from repro_torch.models import model as M
from repro_torch.quant import qtensor as tq
from repro_torch.serving import (MultiTaskEngine, Request, ServeEngine,
                                 ServingConfig, make_scheduler)
from test_torch_model import KEY, jax_cfg, jax_params, np_tree, port_cfg
from test_torch_serving import MAX_LEN, _traffic

MODES = ["int8", "fp8"]


def _engines(mode, tasks, params=None):
    """(JAX engine, port engine, port cfg) over the same JAX-made weights,
    each package quantizing them itself."""
    jcfg = jax_cfg("qwen3-smoke")
    pcfg = port_cfg(jcfg)
    params = jax_params(jcfg, tasks) if params is None else params
    if tasks:
        return (JMultiTaskEngine(jcfg, params, quant=mode),
                MultiTaskEngine(pcfg, [convert.from_jax_params(np_tree(p),
                                                               pcfg, "cpu")
                                       for p in params], quant=mode,
                                device="cpu"), pcfg)
    return (JServeEngine(jcfg, params, quant=mode),
            ServeEngine(pcfg, convert.from_jax_params(np_tree(params), pcfg,
                                                      "cpu"),
                        quant=mode, device="cpu"), pcfg)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tasks", [0, 3])
def test_quantized_engine_logits_match_jax(mode, tasks):
    jeng, peng, pcfg = _engines(mode, tasks)
    assert peng.quant == mode == jeng.quant
    assert any(tq.is_qtensor(v) for _, v in tu.flatten_with_paths(peng.params))
    tids = [0, 2] if tasks else None
    rs = np.random.RandomState(7)
    B, S = 2, 10
    tokens = rs.randint(0, pcfg.vocab_size, (B, S))
    want, jcaches = jeng.prefill(jnp.asarray(tokens), MAX_LEN, task_ids=tids)
    got, caches = peng.prefill(tokens, MAX_LEN, task_ids=tids)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    pos = np.array([S, S - 3])
    for step in range(3):
        tok = rs.randint(0, pcfg.vocab_size, (B, 1))
        want, jcaches = jeng.decode_step(jcaches, jnp.asarray(tok),
                                         jnp.asarray(pos + step, jnp.int32),
                                         task_ids=tids)
        got, caches = peng.decode_step(caches, tok, pos + step, task_ids=tids)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tasks", [0, 3])
def test_quantized_scheduler_greedy_tokens_match_jax(mode, tasks):
    jeng, peng, pcfg = _engines(mode, tasks)
    traffic = _traffic(pcfg.vocab_size, tasks)
    jdone, _ = jmake_scheduler(jeng, JServingConfig(
        num_slots=3, max_len=MAX_LEN, backbone_quant=mode)).run(
        [JRequest(**t) for t in traffic])
    pdone, report = make_scheduler(peng, ServingConfig(
        num_slots=3, max_len=MAX_LEN, backbone_quant=mode)).run(
        [Request(**t) for t in traffic])
    assert report["requests"] == len(traffic)
    for j, p, t in zip(jdone, pdone, traffic):
        assert p.finish_reason == "length"
        assert len(p.tokens) == t["max_new_tokens"]
        np.testing.assert_array_equal(p.tokens, np.asarray(j.tokens))


def _snap_to_grid(params):
    """Each quantizable leaf -> integers in [-127, 127] (127 in row 0)
    times a power of two per output column, so int8 quantization of it is
    exact (the JAX package's `_snap_to_grid` of tests/test_quant_serving)."""
    def snap(path, leaf):
        if not tq.quantizable("/" + path):
            return leaf
        rs = np.random.RandomState(len(path) * 7919 + leaf.numel())
        v = rs.randint(-127, 128, size=tuple(leaf.shape)).astype(np.float32)
        v[0, :] = 127.0
        e = rs.randint(-8, -3, size=(1, leaf.shape[-1]))
        return torch.from_numpy(v * (2.0 ** e).astype(np.float32))

    return tu.map_with_path(snap, params)


@pytest.mark.parametrize("tasks", [0, 3])
def test_int8_engine_on_grid_weights_gives_the_unquantized_tokens(tasks):
    jcfg = jax_cfg("qwen3-smoke")
    pcfg = port_cfg(jcfg)
    variants = [_snap_to_grid(convert.from_jax_params(np_tree(p), pcfg, "cpu"))
                for p in (jax_params(jcfg, tasks) if tasks
                          else [jax_params(jcfg)])]

    def engine(quant):
        if tasks:
            return MultiTaskEngine(pcfg, variants, quant=quant, device="cpu")
        return ServeEngine(pcfg, variants[0], quant=quant, device="cpu")

    dense, q8 = engine(None), engine("int8")
    flat, qflat = (dict(tu.flatten_with_paths(e.params)) for e in (dense, q8))
    for path, leaf in qflat.items():
        if tq.is_qtensor(leaf):
            assert torch.equal(leaf.dequantize(), flat[path]), path
    prompts = np.random.RandomState(4).randint(0, pcfg.vocab_size, (3, 9))
    tids = [0, 2, 1] if tasks else None
    np.testing.assert_array_equal(q8.generate(prompts, 6, task_ids=tids),
                                  dense.generate(prompts, 6, task_ids=tids))
    traffic = _traffic(pcfg.vocab_size, tasks, n=5)
    runs = [make_scheduler(e, ServingConfig(num_slots=2, max_len=MAX_LEN,
                                            backbone_quant=e.quant)).run(
        [Request(**t) for t in traffic])[0] for e in (dense, q8)]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_a_quantized_tree_passes_through_an_engine_untouched():
    _, peng, pcfg = _engines("int8", 0)
    again = ServeEngine(pcfg, peng.params, quant="int8", device="cpu")
    a, b = (dict(tu.flatten_with_paths(e.params)) for e in (peng, again))
    for path, leaf in a.items():
        if tq.is_qtensor(leaf):
            assert torch.equal(b[path].values, leaf.values)
            assert torch.equal(b[path].scales, leaf.scales)


def test_the_seven_call_sites_take_bf16_in_both_packages(monkeypatch):
    """In a bf16 model every quantized projection sees bf16 activations,
    in JAX (whose QTensor branch does not cast) and in the port: the port
    calls #7 7 times per layer at prefill and at each decode step."""
    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg = dataclasses.replace(jpeft.attach(
        jax_get_smoke("qwen3-0.6b"), jpeft.strategy("hadamard")), **bf16)
    jseen, pseen = [], []
    real_j = jops.dequant_matmul

    def jrecord(x, values, scales, impl="auto"):
        jseen.append(str(x.dtype))
        return real_j(x, values, scales, impl=impl)

    monkeypatch.setattr(jops, "dequant_matmul", jrecord)
    jparams = jq.quantize_tree(jhad.perturb_adapters(
        JM.init_params(KEY, jcfg), KEY, scale=0.2), "int8")
    toks = np.random.RandomState(3).randint(0, jcfg.vocab_size, (2, 6))
    _, jcaches = JM.prefill_lm(jparams, jcfg, jnp.asarray(toks), cache_len=16)
    JM.decode_lm(jparams, jcfg, jcaches, jnp.asarray(toks[:, :1]),
                 jnp.asarray([6, 6], jnp.int32))

    real_p = tq.DequantMatmul

    class Record:
        @staticmethod
        def apply(x, values, scales, impl):
            pseen.append(str(x.dtype).removeprefix("torch."))
            return real_p.apply(x, values, scales, impl)

    monkeypatch.setattr(tq, "DequantMatmul", Record)
    pcfg = peft.attach(get_smoke("qwen3-0.6b"),
                       peft.strategy("hadamard")).replace(**bf16)
    eng = ServeEngine(pcfg, M.init_params(torch.Generator().manual_seed(0),
                                          pcfg), quant="int8", device="cpu")
    _, caches = eng.prefill(toks, 16)
    n_prefill = len(pseen)
    eng.decode_step(caches, toks[:, :1], [6, 6])
    per_call = 7 * pcfg.n_layers
    assert n_prefill == per_call and len(pseen) == 2 * per_call
    assert pseen == ["bfloat16"] * 2 * per_call
    # JAX traces its scan over the stacked layers once per call
    assert jseen == ["bfloat16"] * 2 * 7


@pytest.mark.parametrize("mode,tasks", [("int8", 0), ("int8", 3),
                                        ("fp8", 0)])
def test_serve_launcher_quantizes_and_prints_the_jax_summary(mode, tasks,
                                                             capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                "--quant", mode, "--tasks", str(tasks), "--requests", "3",
                "--num-slots", "2", "--prompt-len", "5", "--new-tokens",
                "3"])
    out = capsys.readouterr().out
    assert "served 3 requests / 9 tokens" in out
    # the JAX launcher's line, from JAX's quant_summary of a tree of the
    # same shapes (the numbers depend on shapes and dtypes only)
    jcfg = jpeft.attach(jax_get_smoke("qwen3-0.6b"), jpeft.strategy("hadamard"))
    base = JM.init_params(KEY, jcfg)
    tree = jhad.build_bank([base] * tasks) if tasks else base
    qs = jq.quant_summary(jq.quantize_tree(tree, mode))
    line = (f"{mode} backbone: {qs['n_quantized_leaves']} matmul leaves, "
            f"{qs['dense_bytes_fp32'] / 2**20:.2f} MiB fp32 -> "
            f"{qs['quantized_bytes'] / 2**20:.2f} MiB "
            f"({qs['ratio']:.2f}x); tree total "
            f"{qs['total_bytes'] / 2**20:.2f} MiB")
    assert line in out.splitlines(), (line, out)
