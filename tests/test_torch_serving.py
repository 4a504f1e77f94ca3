"""The port's scheduler against the JAX scheduler, token for token.

Same JAX-made weights (perturbed adapters) on both sides, more requests
than slots (admissions land mid-decode) and mixed prompt lengths; greedy
tokens must be identical, for a single adapter and for a 3-task bank. The
port's scheduler is also held to its own lock-step `generate`.
"""
import numpy as np
import pytest

from repro.serving import MultiTaskEngine as JMultiTaskEngine
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro.serving import ServingConfig as JServingConfig
from repro.serving import make_scheduler as jmake_scheduler
from repro_torch import convert
from repro_torch.obs import SLOSpec, queue_depth_max
from repro_torch.serving import (AdmissionConfig, MultiTaskEngine, Request,
                                 ServeEngine, ServingConfig, make_scheduler)
from test_torch_model import jax_cfg, jax_params, np_tree, port_cfg

MAX_LEN = 32


def _traffic(vocab, tasks, n=7, seed=3):
    """n requests with mixed prompt lengths (three, to bound the JAX
    prefill compiles) and budgets."""
    rs = np.random.RandomState(seed)
    return [dict(prompt=rs.randint(0, vocab, (int(rs.choice([4, 9, 13])),)),
                 max_new_tokens=int(rs.randint(2, 9)),
                 task_id=i % tasks if tasks else 0) for i in range(n)]


def _engines(name, tasks):
    jcfg = jax_cfg(name)
    pcfg = port_cfg(jcfg)
    params = jax_params(jcfg, tasks)
    if tasks:
        return (JMultiTaskEngine(jcfg, params),
                MultiTaskEngine(pcfg, [convert.from_jax_params(np_tree(p), pcfg,
                                                               "cpu")
                                       for p in params], device="cpu"),
                pcfg)
    return (JServeEngine(jcfg, params),
            ServeEngine(pcfg, convert.from_jax_params(np_tree(params), pcfg,
                                                      "cpu"), device="cpu"),
            pcfg)


@pytest.mark.parametrize("tasks", [0, 3])
def test_scheduler_greedy_tokens_match_jax(tasks):
    jeng, peng, pcfg = _engines("qwen3-smoke", tasks)
    traffic = _traffic(pcfg.vocab_size, tasks)
    jdone, _ = jmake_scheduler(jeng, JServingConfig(num_slots=3,
                                                    max_len=MAX_LEN)).run(
        [JRequest(**t) for t in traffic])
    pdone, report = make_scheduler(peng, ServingConfig(num_slots=3,
                                                       max_len=MAX_LEN)).run(
        [Request(**t) for t in traffic])
    assert report["requests"] == len(traffic)
    for j, p, t in zip(jdone, pdone, traffic):
        assert p.finish_reason == "length"
        assert len(p.tokens) == t["max_new_tokens"]
        np.testing.assert_array_equal(p.tokens, np.asarray(j.tokens))


@pytest.mark.parametrize("tasks", [0, 3])
def test_scheduler_matches_its_own_lockstep_generate(tasks):
    _, peng, pcfg = _engines("tiny", tasks)
    rs = np.random.RandomState(5)
    prompts = rs.randint(0, pcfg.vocab_size, (4, 9))
    task_ids = [i % 3 for i in range(4)] if tasks else None
    want = peng.generate(prompts, 6, task_ids=task_ids)
    done, _ = make_scheduler(peng, ServingConfig(num_slots=2,
                                                 max_len=MAX_LEN)).run(
        [Request(prompt=p, max_new_tokens=6,
                 task_id=task_ids[i] if tasks else 0)
         for i, p in enumerate(prompts)])
    np.testing.assert_array_equal(np.stack([c.tokens for c in done]), want)


def test_prefill_bucketing_is_token_exact():
    _, peng, pcfg = _engines("tiny", 0)
    traffic = _traffic(pcfg.vocab_size, 0, n=4)
    want, _ = make_scheduler(peng, ServingConfig(num_slots=2,
                                                 max_len=MAX_LEN)).run(
        [Request(**t) for t in traffic])
    got, _ = make_scheduler(peng, ServingConfig(num_slots=2, max_len=MAX_LEN,
                                                prefill_bucket=8)).run(
        [Request(**t) for t in traffic])
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.tokens, w.tokens)


def test_eos_and_top_k_are_per_request():
    _, peng, pcfg = _engines("tiny", 0)
    prompt = np.arange(1, 8)
    greedy, _ = make_scheduler(peng, ServingConfig(num_slots=2,
                                                   max_len=MAX_LEN)).run(
        [Request(prompt=prompt, max_new_tokens=6)])
    eos = int(greedy[0].tokens[2])
    first = int(np.flatnonzero(greedy[0].tokens == eos)[0])
    sched = make_scheduler(peng, ServingConfig(num_slots=2, max_len=MAX_LEN))
    done, _ = sched.run([Request(prompt=prompt, max_new_tokens=6, eos_id=eos),
                         Request(prompt=prompt, max_new_tokens=6, top_k=5,
                                 seed=11),
                         Request(prompt=prompt, max_new_tokens=6, top_k=5,
                                 seed=11)])
    assert done[0].finish_reason == "eos" and len(done[0].tokens) == first + 1
    np.testing.assert_array_equal(done[1].tokens, done[2].tokens)


# the ids the cases had beside the paged, spec_k and kv_quant cases. The
# SLO and admission switches are ported now: slo alone builds a scheduler
# that watches (no ladder), admission alone raises JAX's ValueError
@pytest.mark.parametrize("kw", [
    pytest.param(dict(slo=SLOSpec(objectives=(queue_depth_max(4),))),
                 id="kw3"),
    pytest.param(dict(admission=AdmissionConfig()), id="kw4")])
def test_serving_config_features_of_later_slices_raise(kw):
    if "admission" in kw:
        with pytest.raises(ValueError, match="needs objectives"):
            ServingConfig(**kw)
        return
    _, peng, _ = _engines("tiny", 0)
    sched = make_scheduler(peng, ServingConfig(num_slots=1, max_len=MAX_LEN,
                                               **kw))
    assert sched._slo_monitor is not None and sched._admission is None


def test_serving_config_validates():
    with pytest.raises(ValueError, match="multiple of 16"):
        ServingConfig(max_len=40)
    _, peng, _ = _engines("tiny", 0)
    sched = make_scheduler(peng, ServingConfig(num_slots=1, max_len=16))
    with pytest.raises(ValueError, match="exceeds"):
        sched.submit(Request(prompt=np.arange(12), max_new_tokens=5))
    with pytest.raises(NotImplementedError, match="fused"):
        ServeEngine(peng.cfg, peng.params, fold=True, device="cpu")


@pytest.mark.parametrize("engine_quant,config_quant",
                         [(None, "int8"), ("fp8", "int8"), ("int8", "fp8")])
def test_make_scheduler_refuses_an_engine_of_another_quantization(
        engine_quant, config_quant):
    _, peng, _ = _engines("tiny", 0)
    eng = ServeEngine(peng.cfg, peng.params, quant=engine_quant, device="cpu")
    with pytest.raises(ValueError, match="backbone_quant"):
        make_scheduler(eng, ServingConfig(num_slots=1, max_len=16,
                                          backbone_quant=config_quant))
    # a config that names no quantization takes any engine
    make_scheduler(eng, ServingConfig(num_slots=1, max_len=16))
    with pytest.raises(ValueError, match="backbone_quant"):
        ServingConfig(backbone_quant="int4")


def test_multitask_engine_rejects_out_of_range_task_ids():
    _, peng, _ = _engines("tiny", 3)
    with pytest.raises(ValueError, match="bank"):
        peng.prefill(np.arange(5)[None], 16, task_ids=[3])
