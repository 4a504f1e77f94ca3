"""Mixture-of-experts decoders: the port against the JAX package.

Same JAX-made weights on both sides (fp32, adapters moved off the identity,
carried over by `convert.from_jax_params`), on the CPU, where #3, #4 and
#5 take their plain versions (`chip_smoke.py` holds the kernels to them
on the card). deepseek-moe-16b's smoke config (a dense layer, then two of
8 experts top-2 with one shared expert, gates not renormalized) and
qwen3-moe-235b-a22b's (8 experts top-2, gates renormalized, no shared
expert, qk-norm):
  * `moe_apply` over normalize_weights on and off, n_shared 0 and 1 and a
    capacity tight enough that routes drop: the routes (top-k experts,
    dest, keep, the sorted tokens) equal JAX's, the gates, y and the aux
    loss within 1e-5;
  * the whole model: prefill logits within 1e-4, `lm_loss` with the aux
    loss and its adapter gradients within 1e-5 of their max;
  * the convert round trip; the quantization table's leaves (experts and
    shared experts stay dense) and JAX's leaf count at full size;
  * the schedulers: greedy tokens equal to JAX's scheduler's. Under MoE
    the rows of a batch interact: every token routes, and takes expert
    capacity, so an idle or retired slot's row (fed its last token and
    position, as JAX's scheduler feeds it) changes which of the live
    rows' routes drop. Over the slot caches, 7 requests admitted
    mid-decode into 4 slots and retiring at their budgets, some decode
    tick dropping a route; over the paged pool, cold, and (deepseek) with
    a shared prefix, whose hits route only the suffix; with prompt
    bucketing, whose pad tokens take capacity; with self speculation
    (qwen3-moe), whose verify routes B * (k + 1) rows: the last three are
    not token-exact against plain decoding under MoE, as in JAX, and are
    held to JAX; a static 3-task bank (#6).
The JAX side runs under `jax.jit` (its eager op-by-op dispatch compiles
every small op at every shape); the init draws the same bits either way.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import tree as jtu
from repro.common.types import MoECfg as JMoECfg
from repro.configs import get as jax_get
from repro.configs import get_smoke as jax_get_smoke
from repro.core import peft as jpeft
from repro.models import model as JM
from repro.core import hadamard as jhad
from repro.models import moe as jmoe
from repro.quant import qtensor as jq
from repro.serving import MultiTaskEngine as JMultiTaskEngine
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro.serving import ServingConfig as JServingConfig
from repro.serving import make_scheduler as jmake_scheduler
from repro.train import losses as jlosses
from repro_torch import convert
from repro_torch.common import tree as tu
from repro_torch.common import types as T
from repro_torch.configs import get, get_smoke
from repro_torch.core import peft
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.quant import quant_summary, quantize_tree
from repro_torch.quant.qtensor import quantizable
from repro_torch.serving import (MultiTaskEngine, Request, ServeEngine,
                                 ServingConfig, make_scheduler)
from repro_torch.train import steps
from test_torch_model import KEY, np_tree, port_cfg

ARCHS = ("deepseek-moe-16b", "qwen3-moe-235b-a22b")


def moe_cfg(arch, **moe_over):
    cfg = jpeft.attach(jax_get_smoke(arch), jpeft.strategy("hadamard"))
    if moe_over:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_over))
    return cfg


_jinit = jax.jit(JM.init_params, static_argnums=1)
_japply = jax.jit(jmoe.moe_apply, static_argnums=1)
_jroute = jax.jit(jmoe._route_group, static_argnums=(2, 3, 4))
_jprefill = jax.jit(JM.prefill_lm, static_argnums=(1, 3))
_jdecode = jax.jit(JM.decode_lm, static_argnums=1)


@pytest.fixture(scope="module", params=ARCHS)
def arch_world(request):
    """JAX's weights (3 adapter variants) and the port's copies."""
    jcfg = moe_cfg(request.param)
    pcfg = port_cfg(jcfg)
    base = _jinit(KEY, jcfg)
    jvars = [jhad.perturb_adapters(base, jax.random.fold_in(KEY, 100 + t),
                                   scale=0.2) for t in range(3)]
    pvars = [convert.from_jax_params(np_tree(v), pcfg, "cpu") for v in jvars]
    return dict(arch=request.param, jcfg=jcfg, jvars=jvars, pvars=pvars,
                pcfg=pcfg, jengine=JServeEngine(jcfg, jvars[0]))


def test_moe_configs_match_jax_field_for_field():
    for arch in ARCHS:
        for jc, pc in ((jax_get(arch), get(arch)),
                       (jax_get_smoke(arch), get_smoke(arch))):
            assert dataclasses.asdict(port_cfg(jc)) == dataclasses.asdict(pc)
            assert isinstance(pc.moe, T.MoECfg)
    assert {f.name: f.default for f in dataclasses.fields(JMoECfg)} == {
        f.name: f.default for f in dataclasses.fields(T.MoECfg)}
    full = get("deepseek-moe-16b")
    assert [s.moe for s in full.layer_slots()] == [False] + [True] * 27
    qm = get_smoke("qwen3-moe-235b-a22b")
    assert qm.moe.normalize_weights and qm.moe.n_shared == 0 and qm.qk_norm


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

# (normalize_weights, n_shared, capacity_factor): 0.5 leaves room for half
# the routes, so some drop
MOE_CASES = {"deepseek": (False, 1, 1.25), "qwen3moe": (True, 0, 1.25),
             "norm_shared_tight": (True, 1, 0.5),
             "plain_unshared_tight": (False, 0, 0.5)}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_jax(case):
    normalize, n_shared, cf = MOE_CASES[case]
    jcfg = moe_cfg("deepseek-moe-16b", normalize_weights=normalize,
                   n_shared=n_shared, capacity_factor=cf)
    pcfg = port_cfg(jcfg)
    jp = jmoe.moe_init(jax.random.fold_in(KEY, 7), jcfg)
    pp = {k: convert.to_tensor(np.asarray(v), "cpu") for k, v in jp.items()}
    assert ("shared_wi" in pp) == bool(n_shared)
    x = np.random.RandomState(3).randn(3, 10, pcfg.d_model).astype(
        np.float32)
    m, T_ = jcfg.moe, 30
    cap = moe.capacity(pcfg.moe, T_)
    assert cap == int(max(1, -(-T_ * m.top_k * m.capacity_factor
                                // m.n_experts)))
    xf = x.reshape(T_, -1)
    _, jinfo, jprobs = _jroute(jnp.asarray(xf), jp["router"], m, cap,
                               jnp.float32)
    _, pinfo, pprobs = moe._route_group(torch.from_numpy(xf), pp["router"],
                                        pcfg.moe, cap, torch.float32)
    np.testing.assert_allclose(pprobs.numpy(), np.asarray(jprobs), atol=1e-6)
    _, jidx = jax.lax.top_k(jprobs, m.top_k)
    _, pidx = moe.top_k(pprobs, m.top_k)
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    for i, name in enumerate(("dest", "keep", "t_sorted")):
        np.testing.assert_array_equal(pinfo[i].numpy(), np.asarray(jinfo[i]),
                                      err_msg=name)
    np.testing.assert_allclose(pinfo[3].numpy(), np.asarray(jinfo[3]),
                               atol=1e-6, err_msg="g_sorted")
    dropped = int((~pinfo[1]).sum())
    if cf < 1:  # at most half the routes fit
        assert dropped >= T_ * m.top_k - m.n_experts * cap > 0, dropped
    jy, jaux = _japply(jp, jcfg, jnp.asarray(x))
    py, paux = moe.moe_apply(pp, pcfg, torch.from_numpy(x))
    assert py.shape == x.shape and py.dtype == torch.float32
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    assert abs(paux.item() - float(jaux)) <= 1e-5
    assert paux.item() > 0


def test_moe_routing_ties_go_to_the_lower_expert():
    """Equal probabilities (a zero token: uniform logits) pick experts 0..k-1
    in both packages, and the aux loss's argmax takes the first."""
    jcfg = moe_cfg("qwen3-moe-235b-a22b")
    pcfg = port_cfg(jcfg)
    jp = jmoe.moe_init(KEY, jcfg)
    pp = {k: convert.to_tensor(np.asarray(v), "cpu") for k, v in jp.items()}
    x = np.zeros((1, 4, pcfg.d_model), np.float32)
    x[0, 2] = np.random.RandomState(0).randn(pcfg.d_model)
    _, jinfo, jprobs = _jroute(jnp.asarray(x[0]), jp["router"], jcfg.moe, 2,
                               jnp.float32)
    _, pinfo, pprobs = moe._route_group(torch.from_numpy(x[0]), pp["router"],
                                        pcfg.moe, 2, torch.float32)
    _, pidx = moe.top_k(pprobs, 2)
    assert pidx[0].tolist() == [0, 1]
    np.testing.assert_array_equal(pidx.numpy(),
                                  np.asarray(jax.lax.top_k(jprobs, 2)[1]))
    np.testing.assert_array_equal(pinfo[0].numpy(), np.asarray(jinfo[0]))
    _, jaux = _japply(jp, jcfg, jnp.asarray(x))
    _, paux = moe.moe_apply(pp, pcfg, torch.from_numpy(x))
    assert abs(paux.item() - float(jaux)) <= 1e-6


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


def test_prefill_and_decode_match_jax(arch_world):
    jcfg, pcfg = arch_world["jcfg"], arch_world["pcfg"]
    jp, pp = arch_world["jvars"][0], arch_world["pvars"][0]
    rs = np.random.RandomState(7)
    B, S, L = 3, 11, 32
    tokens = rs.randint(0, pcfg.vocab_size, (B, S))
    want, jcaches = _jprefill(jp, jcfg, jnp.asarray(tokens), L)
    got, caches = M.prefill_lm(pp, pcfg, torch.from_numpy(tokens), L)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    pos = np.array([S, S - 3, S - 6])
    for step in range(4):
        tok = rs.randint(0, pcfg.vocab_size, (B, 1))
        want, jcaches = _jdecode(jp, jcfg, jcaches, jnp.asarray(tok),
                                 jnp.asarray(pos + step, jnp.int32))
        got, caches = M.decode_lm(pp, pcfg, caches, torch.from_numpy(tok),
                                  torch.from_numpy(pos + step))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0, err_msg=f"step {step}")


def test_lm_loss_with_aux_and_its_gradients_match_jax(arch_world):
    """JAX's lm_loss adds the summed aux loss; so does the port's. Loss
    within 1e-5 relative, aux within 1e-6, every adapter gradient within
    1e-5 of its max |JAX gradient|."""
    jcfg, pcfg = arch_world["jcfg"], arch_world["pcfg"]
    jparams, ported = arch_world["jvars"][0], arch_world["pvars"][0]
    rs = np.random.RandomState(2)
    tokens = rs.randint(0, pcfg.vocab_size, (2, 12))
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    strat = jpeft.strategy("hadamard")
    jtr, jfr = jtu.partition(jparams, jpeft.trainable_mask(jparams, strat))

    def jloss(tr):
        return jlosses.lm_loss(jcfg, jtu.merge(tr, jfr),
                               {k: jnp.asarray(v) for k, v in batch.items()})

    (wl, wm), wg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jtr)
    state = steps.make_state(None, pcfg, peft.strategy("hadamard"),
                             T.OptimCfg(), params=ported)
    gl, metrics, gg = steps.loss_and_grads(
        pcfg, state, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    assert float(wm["aux"]) > 0
    assert abs(metrics["aux"].item() - float(wm["aux"])) <= 1e-6
    assert abs(gl.item() - float(wl)) <= 1e-5 * abs(float(wl))
    want = dict(jtu.flatten_with_paths(wg))
    got = {}
    for path, g in gg.items():
        got.setdefault(convert.jax_path(path, pcfg), []).append(g.numpy())
    assert set(got) == {p for p, v in want.items() if v is not None}
    assert any("/adapter/" in p for p in got)
    for path, g in got.items():
        w = np.asarray(want[path])
        np.testing.assert_allclose(np.stack(g), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=path)


# ---------------------------------------------------------------------------
# convert and the quantization table
# ---------------------------------------------------------------------------


def test_convert_round_trips_the_expert_stacks(arch_world):
    jp, pp, pcfg = (arch_world["jvars"][0], arch_world["pvars"][0],
                    arch_world["pcfg"])
    tree = np_tree(jp)
    moe_layers = [i for i, s in enumerate(pcfg.layer_slots()) if s.moe]
    g = len(pcfg.groups) - 1  # the MoE group
    E, f = pcfg.moe.n_experts, pcfg.moe.d_expert
    for r, li in enumerate(moe_layers):
        layer = pp["layers"][li]
        assert "mlp" not in layer
        assert layer["moe"]["router"].dtype == torch.float32
        assert tuple(layer["moe"]["wi"].shape) == (E, pcfg.d_model, f)
        for leaf in layer["moe"]:
            np.testing.assert_array_equal(
                layer["moe"][leaf].numpy(),
                tree["blocks"][f"g{g}"]["slot0"]["moe"][leaf][r])
    back = convert.to_jax_params(pp, pcfg)
    flat = dict(jtu.flatten_with_paths(tree))
    got = dict(jtu.flatten_with_paths(back))
    assert set(got) == set(flat)
    for path, leaf in flat.items():
        np.testing.assert_array_equal(got[path], leaf, err_msg=path)


def test_quantization_keeps_the_experts_dense(arch_world):
    """JAX's table quantizes the attention projections, a dense layer's
    MLP and an untied head; the routed and shared experts and the router
    stay as they are, in both packages, with the same leaf count."""
    jp, pp, pcfg, jcfg = (arch_world["jvars"][0], arch_world["pvars"][0],
                          arch_world["pcfg"], arch_world["jcfg"])
    jqs = jq.quant_summary(jax.jit(lambda t: jq.quantize_tree(t, "int8"))(jp))
    qp = quantize_tree(pp, "int8")
    pqs = quant_summary(qp, lambda p: convert.jax_path(p, pcfg))
    assert pqs["n_quantized_leaves"] == jqs["n_quantized_leaves"]
    assert pqs["quantized_bytes"] == jqs["quantized_bytes"]
    for path, leaf in tu.flatten_with_paths(qp):
        if "/moe/" in path:
            assert isinstance(leaf, torch.Tensor), path


def test_full_size_quantized_leaf_count_is_jaxs():
    """At full size, by shapes alone: deepseek-moe-16b quantizes 12 JAX
    leaves (the dense layer's 4 attention and 3 MLP projections, the MoE
    group's 4 attention projections, the untied head), qwen3-moe 5, none
    of them an expert; the port's meta-device parameters name the same."""
    for arch, want in (("deepseek-moe-16b", 12), ("qwen3-moe-235b-a22b", 5)):
        shapes = jax.eval_shape(lambda: JM.init_params(KEY, jax_get(arch)))
        jpaths = {p for p, _ in jtu.flatten_with_paths(shapes)
                  if jq.quantizable("/" + p)}
        assert len(jpaths) == want, (arch, sorted(jpaths))
        assert not any("/moe/" in p for p in jpaths)
        with torch.device("meta"):
            params = M.init_params(None, get(arch))
        assert {convert.jax_path(p, get(arch))
                for p, _ in tu.flatten_with_paths(params)
                if quantizable("/" + p)} == jpaths


# ---------------------------------------------------------------------------
# the schedulers
# ---------------------------------------------------------------------------

MAX_LEN = 48


def _traffic(vocab, n=7, tasks=0, seed=11, prefix=None):
    """Prompts of 5 or 19 tokens (two prefill shapes to compile), budgets of
    3-9: more requests than slots, so admissions land mid-decode and slots
    retire (and idle) while others decode. With `prefix`, every prompt
    starts with it."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        p = rs.randint(0, vocab, (int(rs.choice([5, 19])),))
        if prefix is not None:
            p = np.concatenate([prefix, p])
        out.append(dict(prompt=p, max_new_tokens=int(rs.randint(3, 10)),
                        task_id=i % tasks if tasks else 0))
    return out


@pytest.fixture
def route_log(monkeypatch):
    """(tokens, dropped routes) of every group the port routes."""
    log = []
    real = moe._route_group

    def spy(xg, *a):
        out = real(xg, *a)
        log.append((xg.shape[0], int((~out[1][1]).sum())))
        return out

    monkeypatch.setattr(moe, "_route_group", spy)
    return log


SCHED_MODES = {
    "slots": dict(),
    "paged_cold": dict(paged=True, page_size=16, prefix_cache=False),
    "paged_prefix": dict(paged=True, page_size=16),
    "bucketed": dict(prefill_bucket=8),
    "spec": dict(spec_k=2),
}
# the fourth mode of each arch: prefix hits over deepseek (its shared
# expert), self speculation over qwen3-moe (renormalized gates)
FOURTH_MODE = {"deepseek-moe-16b": "paged_prefix",
               "qwen3-moe-235b-a22b": "spec"}


@pytest.mark.parametrize("mode", ["slots", "paged_cold", "bucketed",
                                  "prefix_or_spec"])
def test_scheduler_tokens_match_jax(arch_world, mode, route_log):
    """4 slots, 7 requests admitted mid-decode, each retiring at its
    budget: greedy tokens equal to JAX's scheduler's. Over slot caches a
    decode tick must have dropped a route (idle rows route too)."""
    pcfg = arch_world["pcfg"]
    if mode == "prefix_or_spec":
        mode = FOURTH_MODE[arch_world["arch"]]
    prefix = (np.random.RandomState(5).randint(0, pcfg.vocab_size, (16,))
              if mode == "paged_prefix" else None)
    traffic = _traffic(pcfg.vocab_size, prefix=prefix)
    kw = dict(num_slots=4, max_len=MAX_LEN, **SCHED_MODES[mode])
    jsched = jmake_scheduler(arch_world["jengine"], JServingConfig(**kw))
    jdone, _ = jsched.run([JRequest(**t) for t in traffic])
    psched = make_scheduler(ServeEngine(pcfg, arch_world["pvars"][0],
                                        device="cpu"), ServingConfig(**kw))
    pdone, report = psched.run([Request(**t) for t in traffic])
    assert report["requests"] == len(traffic)
    for j, p, t in zip(jdone, pdone, traffic):
        assert len(p.tokens) == t["max_new_tokens"]
        np.testing.assert_array_equal(p.tokens, np.asarray(j.tokens),
                                      err_msg=f"{mode} request {p.request_id}")
    if mode.startswith("paged"):
        assert psched.stats == jsched.stats
        assert psched.stats["cold"] < len(traffic) or mode == "paged_cold"
    if mode == "slots":
        decode_drops = [n for t, n in route_log if t == kw["num_slots"]]
        assert decode_drops and max(decode_drops) > 0, route_log
    if mode == "spec":
        assert psched.spec_stats == jsched.spec_stats


def test_static_bank_tokens_match_jax(arch_world):
    """A 3-task bank (#6 at every seam): tokens equal to JAX's
    MultiTaskEngine's."""
    pcfg, jcfg = arch_world["pcfg"], arch_world["jcfg"]
    traffic = _traffic(pcfg.vocab_size, n=6, tasks=3, seed=4)
    kw = dict(num_slots=3, max_len=MAX_LEN)
    jdone, _ = jmake_scheduler(JMultiTaskEngine(jcfg, arch_world["jvars"]),
                               JServingConfig(**kw)).run(
        [JRequest(**t) for t in traffic])
    pdone, _ = make_scheduler(MultiTaskEngine(pcfg, arch_world["pvars"],
                                              device="cpu"),
                              ServingConfig(**kw)).run(
        [Request(**t) for t in traffic])
    for j, p in zip(jdone, pdone):
        np.testing.assert_array_equal(p.tokens, np.asarray(j.tokens))


