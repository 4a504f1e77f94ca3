"""The port's speculative decoding and serving config against the JAX
package's.

Same JAX-made weights on both sides, fp32, on the CPU: near-identity task
rows (perturbed by 0.01) so that a self draft is accepted at some
positions and rejected at others. Greedy tokens of `SpecScheduler` and
`SpecPagedScheduler`, with a self draft and with a separate draft model,
equal plain decoding's and JAX's, with JAX's `spec_stats`; a sampled
(top_k) slot draws from the verify's column 0, so it gets the plain
scheduler's tokens too. Then JAX's `ServingConfig` validation matrix,
`make_scheduler`'s choices and refusals, the refusals of a recurrent
target and a non-Hadamard self draft, and the launcher's lines.
"""
import contextlib
import io

import jax
import numpy as np
import pytest

from repro.core import hadamard as jhad
from repro.models import model as JM
from repro.serving import MultiTaskEngine as JMultiTaskEngine
from repro.serving import Request as JRequest
from repro.serving import ServingConfig as JServingConfig
from repro.serving import make_scheduler as jmake_scheduler
from repro_torch import convert
from repro_torch.common.types import AdapterCfg
from repro_torch.configs import get_smoke
from repro_torch.core import peft
from repro_torch.launch import serve as launcher
from repro_torch.serving import (DraftLane, MultiTaskEngine, PagedScheduler,
                                 Request, Scheduler, ServeEngine,
                                 ServingConfig, SpecPagedScheduler,
                                 SpecScheduler, make_scheduler)
from test_torch_model import KEY, jax_cfg, np_tree, port_cfg

SERVE = dict(num_slots=3, max_len=32)
PAGED = dict(paged=True, page_size=8)


@pytest.fixture(scope="module")
def world():
    jcfg = jax_cfg("tiny")
    pcfg = port_cfg(jcfg)
    jbase = JM.init_params(KEY, jcfg)
    jtasks = [jhad.perturb_adapters(jbase, jax.random.fold_in(KEY, 40 + t),
                                    scale=0.01) for t in range(3)]
    jdraft = JM.init_params(jax.random.fold_in(KEY, 99), jcfg)
    port = lambda t: convert.from_jax_params(np_tree(t), pcfg, "cpu")  # noqa
    return dict(jcfg=jcfg, pcfg=pcfg, jeng=JMultiTaskEngine(jcfg, jtasks),
                peng=MultiTaskEngine(pcfg, [port(t) for t in jtasks],
                                     device="cpu"),
                jbase=jbase, pbase=port(jbase), jdraft=jdraft,
                pdraft=port(jdraft))


def _traffic(n=6, budget=5, sampled=True):
    rs = np.random.RandomState(17)
    out = []
    for i in range(n):
        kw = {"top_k": 5, "seed": 3} if sampled and i == n - 1 else {}
        out.append(dict(prompt=rs.randint(0, 97, size=(6 + i % 4,)),
                        max_new_tokens=budget, task_id=i % 3, **kw))
    return out


def _same_tokens(a, b, only=None):
    for i, (ca, cb) in enumerate(zip(a, b)):
        if only is None or i in only:
            np.testing.assert_array_equal(np.asarray(ca.tokens),
                                          np.asarray(cb.tokens),
                                          err_msg=f"request {i}")


@pytest.mark.parametrize("draft", ["self", "model"])
@pytest.mark.parametrize("paged", [False, True])
def test_spec_tokens_match_plain_decoding_and_jax(world, paged, draft):
    """Greedy tokens equal plain decoding's and JAX's speculative ones,
    with accepted and rejected drafts and JAX's spec_stats; the sampled
    slot (the last) equals the plain scheduler's draws."""
    kw = dict(SERVE, spec_k=3, spec_draft=draft, **(PAGED if paged else {}))
    jd = (world["jcfg"], world["jdraft"]) if draft == "model" else None
    pd = (world["pcfg"], world["pdraft"]) if draft == "model" else None
    traffic = _traffic()
    jsched = jmake_scheduler(world["jeng"], JServingConfig(**kw),
                             draft_model=jd)
    jdone, _ = jsched.run([JRequest(**t) for t in traffic])
    psched = make_scheduler(world["peng"], ServingConfig(**kw),
                            draft_model=pd)
    assert type(psched) is (SpecPagedScheduler if paged else SpecScheduler)
    pdone, rep = psched.run([Request(**t) for t in traffic])
    plain, _ = make_scheduler(world["peng"], ServingConfig(
        **SERVE, **(PAGED if paged else {}))).run(
        [Request(**t) for t in traffic])
    greedy = range(len(traffic) - 1)
    _same_tokens(pdone, jdone, only=greedy)
    _same_tokens(pdone, plain)
    st = psched.spec_stats
    assert st == jsched.spec_stats
    # the self draft is accepted at some positions and rejected at others;
    # an unrelated draft model mostly drafts in vain
    assert (0 < st["accepted"] < st["drafted"] if draft == "self"
            else st["drafted"] > 0), st
    assert psched.acceptance_rate == jsched.acceptance_rate
    assert rep["ticks"] == st["spec_ticks"]
    if paged:
        assert psched.stats == jsched.stats
        psched.prefix.clear(psched.alloc)
        assert psched.pool_report()["live_blocks"] == 0


def test_all_accepting_draft_needs_fewer_ticks(world):
    """Identity rows (the backbone itself): every draft is accepted, and a
    10-token budget takes 2 verify ticks where plain decoding takes 9."""
    base = world["pbase"]
    eng = MultiTaskEngine(world["pcfg"], [base, base], device="cpu")
    rs = np.random.RandomState(23)
    reqs = lambda: [Request(prompt=rs.randint(0, 97, size=(5,)),  # noqa
                            max_new_tokens=10, task_id=i % 2)
                    for i in range(2)]
    plain, rep_p = make_scheduler(eng, ServingConfig(**SERVE)).run(reqs())
    rs = np.random.RandomState(23)
    spec = make_scheduler(eng, ServingConfig(**SERVE, spec_k=4))
    done, rep_s = spec.run(reqs())
    _same_tokens(done, plain)
    assert spec.acceptance_rate == 1.0
    assert rep_s["ticks"] == 2 < rep_p["ticks"] == 9


def test_set_spec_k_steps_down_without_changing_tokens(world):
    traffic = _traffic(sampled=False)
    want, _ = make_scheduler(world["peng"], ServingConfig(**SERVE)).run(
        [Request(**t) for t in traffic])
    for k in (0, 1, 3):
        spec = make_scheduler(world["peng"], ServingConfig(**SERVE,
                                                           spec_k=3))
        spec.set_spec_k(k)
        done, _ = spec.run([Request(**t) for t in traffic])
        _same_tokens(done, want)
        assert spec.spec_stats["spec_ticks"] == (0 if k == 0 else
                                                 spec._ticks)
    for bad in (-1, 4, 2.0):
        with pytest.raises(ValueError, match="spec_k"):
            spec.set_spec_k(bad)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_headroom_guard_refuses_at_submit(world):
    spec = make_scheduler(world["peng"], ServingConfig(num_slots=2,
                                                       max_len=16, spec_k=4))
    with pytest.raises(ValueError, match="spec_k"):
        spec.submit(Request(prompt=np.zeros(8, np.int64), max_new_tokens=5))
    make_scheduler(world["peng"], ServingConfig(num_slots=2, max_len=16)) \
        .submit(Request(prompt=np.zeros(8, np.int64), max_new_tokens=5))


def test_recurrent_target_refused():
    cfg = peft.attach(get_smoke("rwkv6-1.6b"), peft.strategy("hadamard"))
    eng = launcher.build_engine(cfg, seed=0, device="cpu")
    for paged in (False, True):
        with pytest.raises(ValueError, match="attention"):
            make_scheduler(eng, ServingConfig(num_slots=2, max_len=32,
                                              spec_k=2, paged=paged))


def test_self_draft_needs_a_hadamard_adapter(world):
    class _Eng:  # the lane refuses before it reads anything but cfg
        cfg = world["pcfg"].replace(adapter=AdapterCfg(kind="lora"))

    with pytest.raises(ValueError, match="hadamard"):
        DraftLane(_Eng(), num_slots=2, max_len=32, k=2)
    with pytest.raises(ValueError, match="spec_k"):
        DraftLane(world["peng"], num_slots=2, max_len=32, k=0)


def test_draft_model_vocab_must_match(world):
    dcfg = world["pcfg"].replace(vocab_size=89)
    with pytest.raises(ValueError, match="vocab"):
        make_scheduler(world["peng"], ServingConfig(
            **SERVE, spec_k=2, spec_draft="model"),
            draft_model=(dcfg, world["pdraft"]))


# ---------------------------------------------------------------------------
# the config and the factory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(num_slots=0),
    dict(max_len=0),
    dict(kv_quant="int8"),                       # quantized KV needs paging
    dict(kv_quant="int4", paged=True),           # unknown mode
    dict(num_blocks=8),                          # pool size needs paging
    dict(paged=True, page_size=16, max_len=40),  # not page-aligned
    dict(paged=True, page_size=16, num_blocks=1),  # null block only
    dict(paged=True, page_size=16, max_len=32, prefill_bucket=12),
    dict(spec_k=-1),
    dict(spec_draft="oracle", spec_k=2),
    dict(spec_draft="model"),                    # meaningless at spec_k=0
    dict(prefill_bucket=0),
    dict(top_k=-1),
])
def test_serving_config_rejects_what_jax_rejects(kw):
    with pytest.raises(ValueError):
        JServingConfig(**kw)
    with pytest.raises(ValueError):
        ServingConfig(**kw)


def test_make_scheduler_picks_jax_scheduler_and_refuses_incoherence(world):
    eng, pcfg = world["peng"], world["pcfg"]
    for kw, cls in ((dict(), Scheduler), (PAGED, PagedScheduler),
                    (dict(spec_k=2), SpecScheduler),
                    (dict(PAGED, spec_k=2), SpecPagedScheduler)):
        kw = dict(num_slots=2, max_len=32, **kw)
        assert type(make_scheduler(eng, ServingConfig(**kw))) is cls
        assert type(jmake_scheduler(world["jeng"], JServingConfig(**kw))
                    ).__name__ == cls.__name__
    sched = make_scheduler(eng, ServingConfig(num_slots=2, max_len=32,
                                              **PAGED))
    assert sched.alloc.num_blocks == 1 + 2 * (32 // 8) * 3 // 2
    sched = make_scheduler(eng, ServingConfig(num_slots=4, max_len=512,
                                              paged=True))
    assert sched.alloc.num_blocks == 193
    with pytest.raises(ValueError, match="backbone_quant"):
        make_scheduler(eng, ServingConfig(num_slots=2, max_len=32,
                                          backbone_quant="int8"))
    with pytest.raises(ValueError, match="draft_model"):
        make_scheduler(eng, ServingConfig(num_slots=2, max_len=32, spec_k=2,
                                          spec_draft="model"))
    with pytest.raises(ValueError, match="spec_draft"):
        make_scheduler(eng, ServingConfig(num_slots=2, max_len=32, spec_k=2),
                       draft_model=(pcfg, world["pdraft"]))
    with pytest.raises(ValueError, match="spec_k"):
        make_scheduler(eng, ServingConfig(num_slots=2, max_len=32),
                       draft_model=(pcfg, world["pdraft"]))
    with pytest.raises(NotImplementedError, match="slice"):
        ServingConfig(slo=object())


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags,want", [
    (["--page-size", "16"], ["paged KV: 12 x 16-token blocks",
                             "pool: 8/12 blocks live, 8 cached prompts; 0 "
                             "full / 0 partial prefix hits, 8 cold prefills"]),
    (["--page-size", "16", "--kv-quant", "int8", "--no-prefix-cache"],
     ["paged KV: 12 x 16-token blocks, int8 blocks, prefix cache off",
      "pool: 0/12 blocks live, 0 cached prompts"]),
    (["--page-size", "16", "--kv-quant", "fp8"],
     ["paged KV: 12 x 16-token blocks, fp8 blocks"]),
    (["--spec-k", "4"], ["speculative decoding: k=4, draft=self",
                         "speculation: 64/64 drafts accepted (100%) over 4 "
                         "verify ticks"]),
    (["--spec-k", "4", "--spec-draft", "model", "--page-size", "16",
      "--tasks", "3"], ["speculative decoding: k=4, draft=model",
                        "paged KV: 12 x 16-token blocks",
                        "over 4 verify ticks"]),
])
def test_launcher_prints_jax_lines(flags, want):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launcher.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                       *flags])
    text = out.getvalue()
    assert "served 8 requests / 64 tokens" in text
    for line in want:
        assert line in text, text


def test_launcher_refuses_incoherent_flags():
    with pytest.raises(SystemExit, match="paged"):
        launcher.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                       "--kv-quant", "int8"])


def test_engine_verify_needs_attention_layers():
    cfg = peft.attach(get_smoke("rwkv6-1.6b"), peft.strategy("hadamard"))
    eng = ServeEngine(cfg, launcher.build_params(cfg, 0, 0, "cpu")[0],
                      device="cpu")
    caches = eng.init_slot_caches(1, 16)
    with pytest.raises(ValueError, match="recurrent"):
        eng.verify_step(caches, np.zeros((1, 3), np.int64), [0])
