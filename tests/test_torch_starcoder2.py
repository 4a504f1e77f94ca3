"""starcoder2-3b and starcoder2-7b: the port against the JAX package.

A pre-LN LayerNorm decoder with biases in every projection and norm, a
non-gated GeLU MLP, RoPE and an untied head. Two configs at smoke dims
under the Hadamard adapter: JAX's smoke config (GQA 4/2) and the same
with 9 query heads on one KV head, as starcoder2-7b's 36/4 puts them.
JAX-made weights with the adapters perturbed, the norms moved off (1, 0),
every projection bias moved off 0 and q/k sharpened, carried into the
port by `convert.from_jax_params`, fp32 on the CPU (every kernel call
takes its plain version; `chip_smoke.py` holds the kernels to them on the
card):
  * both configs field for field, at full size and at smoke size, and the
    full-size parameter counts and quantized leaves by shapes;
  * `convert` both ways over the biases, the untied head and LayerNorm's
    scale and bias;
  * prefill logits and 6 greedy decode steps within 1e-4, tokens equal;
  * the schedulers' greedy tokens equal to JAX's with mid-decode
    admission: slot caches, the paged pool with prefix hits, self
    speculation, a 3-task bank;
  * `lm_loss` within 1e-5 and every adapter gradient within 1e-5 of its
    max;
  * int8 and fp8 engines: the QTensors byte for byte JAX's engine's, 7
    leaves in `quant_summary`, logits within 1e-4;
  * the kernels' plans at the full widths: #5 cuts 9 (36/4) and 12 (24/2)
    query rows of a KV head into chunks of 8, #3 takes d 3072 on
    `warp_row` and d 4608 on `split_row`.
The JAX side runs under `jax.jit` where it is called more than once.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import tree as jtu
from repro.configs import get as jax_get
from repro.configs import get_smoke as jax_get_smoke
from repro.core import hadamard as jhad
from repro.core import peft as jpeft
from repro.models import model as JM
from repro.quant import qtensor as jq
from repro.serving import MultiTaskEngine as JMultiTaskEngine
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro.serving import ServingConfig as JServingConfig
from repro.serving import make_scheduler as jmake_scheduler
from repro.train import losses as jlosses
from repro_torch import convert
from repro_torch.common import tree as tu
from repro_torch.configs import get, get_smoke
from repro_torch.core import peft
from repro_torch.kernels.attention import paged_split_plan
from repro_torch.kernels.hadamard import fused_norm_plan
from repro_torch.models import model as M
from repro_torch.quant import qtensor as tq
from repro_torch.serving import (MultiTaskEngine, Request, ServeEngine,
                                 ServingConfig, make_scheduler)
from repro_torch.train import losses
from test_torch_encdec import sharpen, t, tu_flat
from test_torch_model import KEY, np_tree, port_cfg
from test_torch_quant import _bytes, _flat

ARCHS = ("starcoder2-3b", "starcoder2-7b")
B, S, CACHE, MAX_LEN = 2, 11, 32, 48

_jinit = jax.jit(JM.init_params, static_argnums=1)
_jprefill = jax.jit(JM.prefill_lm, static_argnums=(1, 3))
_jdecode = jax.jit(JM.decode_lm, static_argnums=1)


def sc_jcfg(kind):
    """starcoder2's smoke config under the Hadamard adapter; "gqa9" puts
    9 query heads on one KV head (starcoder2-7b's 36/4 ratio)."""
    cfg = jpeft.attach(jax_get_smoke("starcoder2-7b"),
                       jpeft.strategy("hadamard"))
    return cfg.replace(n_heads=9, n_kv_heads=1) if kind == "gqa9" else cfg


def move_biases(tree, seed):
    """Every projection bias of a numpy tree moved off 0 (JAX inits them
    at 0, which would hide a dropped bias)."""
    rs = np.random.RandomState(seed)

    def one(path, leaf):
        name = jax.tree_util.keystr(path)
        if any(f"'{b}'" in name for b in ("bq", "bk", "bv", "bo", "bi")):
            return (leaf + 0.1 * rs.standard_normal(leaf.shape)).astype(
                leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(one, tree)


@functools.lru_cache(maxsize=None)
def _world(kind):
    """JAX's weights (3 adapter variants over one trunk), the port's
    copies and JAX's single-adapter engine."""
    jcfg = sc_jcfg(kind)
    pcfg = port_cfg(jcfg)
    base = np_tree(_jinit(KEY, jcfg))
    base = move_biases(sharpen(base, 3), 5)
    jvars = [jax.tree.map(jnp.asarray, np_tree(jhad.perturb_adapters(
        base, jax.random.fold_in(KEY, 100 + i), scale=0.2)))
        for i in range(3)]
    pvars = [convert.from_jax_params(np_tree(v), pcfg, "cpu") for v in jvars]
    return dict(kind=kind, jcfg=jcfg, pcfg=pcfg, jvars=jvars, pvars=pvars,
                jengine=JServeEngine(jcfg, jvars[0]))


@pytest.fixture(scope="module", params=["smoke", "gqa9"])
def sc(request):
    return _world(request.param)


@pytest.mark.parametrize("arch", ARCHS)
def test_starcoder2_configs_match_jax_field_for_field(arch):
    for jcfg, pcfg in ((jax_get(arch), get(arch)),
                       (jax_get_smoke(arch), get_smoke(arch))):
        assert dataclasses.asdict(port_cfg(jcfg)) == dataclasses.asdict(pcfg)
        assert pcfg.norm == "layernorm" and pcfg.attn_bias and pcfg.mlp_bias
        assert not pcfg.tie_embeddings and not pcfg.gated_mlp
        assert pcfg.norm_eps == jcfg.norm_eps
        assert all(s.window is None for s in pcfg.layer_slots())


@pytest.mark.parametrize("arch,want", [("starcoder2-3b", 3_181_550_592),
                                       ("starcoder2-7b", 7_400_711_168)])
def test_full_size_counts_and_quantized_leaves_are_jaxs(arch, want):
    """The parameter count with Hadamard adapters, by shapes on
    device="meta", is JAX's; the quantization table takes 7 JAX leaves
    (4 attention and 2 MLP projections, the untied head) and no bias."""
    pcfg = peft.attach(get(arch), peft.strategy("hadamard"))
    jcfg = jpeft.attach(jax_get(arch), jpeft.strategy("hadamard"))
    with torch.device("meta"):
        params = M.init_params(None, pcfg)
    shapes = jax.eval_shape(lambda: JM.init_params(KEY, jcfg))
    assert tu.count_params(params) == want == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    jpaths = {p for p, _ in jtu.flatten_with_paths(shapes)
              if jq.quantizable("/" + p)}
    assert len(jpaths) == 7 and all(
        p.rsplit("/", 1)[-1] in ("wq", "wk", "wv", "wo", "wi", "kernel")
        for p in jpaths)
    assert {convert.jax_path(p, pcfg) for p, _ in tu.flatten_with_paths(
        params) if tq.quantizable("/" + p)} == jpaths
    assert params["lm_head"]["kernel"].shape == (pcfg.d_model, 49152)


def test_convert_carries_biases_head_and_layernorm_both_ways(sc):
    jtree, pp, pcfg = np_tree(sc["jvars"][0]), sc["pvars"][0], sc["pcfg"]
    layer = pp["layers"][1]
    assert sorted(layer["attn"]) == ["bk", "bo", "bq", "bv", "wk", "wo",
                                     "wq", "wv"]
    assert sorted(layer["mlp"]) == ["bi", "bo", "wi", "wo"]
    assert sorted(layer["ffn_norm"]) == ["bias", "scale"]
    assert sorted(pp["final_norm"]) == ["bias", "scale"]
    assert "lm_head" in pp and not torch.equal(
        pp["lm_head"]["kernel"], pp["embed"]["table"].T)
    back = dict(tu_flat(convert.to_jax_params(pp, pcfg)))
    want = dict(tu_flat(jtree))
    assert set(back) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(back[path]), leaf, path)
        if path.endswith(("bq", "bo", "bi", "norm/bias")):
            assert np.abs(leaf).max() > 0, path


def test_prefill_and_greedy_decode_match_jax(sc):
    """prefill_lm (and a last_pos inside the prompt), then 6 greedy
    decode_lm steps at per-row positions: logits within 1e-4, every token
    JAX's."""
    jcfg, pcfg, jp, pp = sc["jcfg"], sc["pcfg"], sc["jvars"][0], \
        sc["pvars"][0]
    toks = np.random.RandomState(2).randint(0, pcfg.vocab_size, (B, S)
                                            ).astype(np.int32)
    want, _ = JM.prefill_lm(jp, jcfg, jnp.asarray(toks), cache_len=CACHE,
                            last_pos=S - 4)
    got, _ = M.prefill_lm(pp, pcfg, t(toks), CACHE, last_pos=S - 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    want, jc = _jprefill(jp, jcfg, jnp.asarray(toks), CACHE)
    got, pc = M.prefill_lm(pp, pcfg, t(toks), CACHE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    tok_j = np.asarray(want).argmax(-1).astype(np.int32)
    tok_p = got.argmax(-1)
    for step in range(6):
        assert np.array_equal(tok_p.numpy(), tok_j)
        pos = np.array([S + step, S + step], np.int32)
        want, jc = _jdecode(jp, jcfg, jc, jnp.asarray(tok_j), jnp.asarray(pos))
        got, pc = M.decode_lm(pp, pcfg, pc, tok_p, torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)
        tok_j = np.asarray(want).argmax(-1).astype(np.int32)
        tok_p = got.argmax(-1)
    assert np.array_equal(tok_p.numpy(), tok_j)


def _traffic(vocab, n=7, tasks=0, seed=11, prefix=None):
    """Prompts of 5 or 19 tokens, budgets of 3-9: more requests than
    slots, so admissions land mid-decode and slots retire while others
    decode. With `prefix`, every prompt starts with it."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        p = rs.randint(0, vocab, (int(rs.choice([5, 19])),))
        if prefix is not None:
            p = np.concatenate([prefix, p])
        out.append(dict(prompt=p, max_new_tokens=int(rs.randint(3, 10)),
                        task_id=i % tasks if tasks else 0))
    return out


SCHED_MODES = {
    "slots": dict(),
    "paged_prefix": dict(paged=True, page_size=16),
    "spec": dict(spec_k=2),
    "bank": dict(),
}


@pytest.mark.parametrize("mode", sorted(SCHED_MODES))
def test_scheduler_tokens_match_jax(mode):
    """4 slots (3 for the bank), 7 requests admitted mid-decode, each
    retiring at its budget, over the 9-on-1 config: greedy tokens equal
    to JAX's scheduler's, with its pool and speculation counters."""
    w = _world("gqa9")
    pcfg, jcfg = w["pcfg"], w["jcfg"]
    prefix = (np.random.RandomState(5).randint(0, pcfg.vocab_size, (16,))
              if mode == "paged_prefix" else None)
    tasks = 3 if mode == "bank" else 0
    traffic = _traffic(pcfg.vocab_size, tasks=tasks, prefix=prefix)
    kw = dict(num_slots=3 if tasks else 4, max_len=MAX_LEN,
              **SCHED_MODES[mode])
    jeng = JMultiTaskEngine(jcfg, w["jvars"]) if tasks else w["jengine"]
    peng = (MultiTaskEngine(pcfg, w["pvars"], device="cpu") if tasks
            else ServeEngine(pcfg, w["pvars"][0], device="cpu"))
    jsched = jmake_scheduler(jeng, JServingConfig(**kw))
    jdone, _ = jsched.run([JRequest(**r) for r in traffic])
    psched = make_scheduler(peng, ServingConfig(**kw))
    pdone, report = psched.run([Request(**r) for r in traffic])
    assert report["requests"] == len(traffic)
    for j, p, r in zip(jdone, pdone, traffic):
        assert len(p.tokens) == r["max_new_tokens"]
        np.testing.assert_array_equal(p.tokens, np.asarray(j.tokens),
                                      err_msg=f"{mode} req {p.request_id}")
    if mode == "paged_prefix":
        assert psched.stats == jsched.stats
        assert psched.stats["cold"] < len(traffic)
    if mode == "spec":
        assert psched.spec_stats == jsched.spec_stats


def test_lm_loss_and_adapter_gradients_match_jax(sc):
    """lm_loss within 1e-5 and every adapter leaf's gradient within 1e-5
    of max|ref| of jax.grad."""
    jcfg, pcfg = sc["jcfg"], sc["pcfg"]
    rs = np.random.RandomState(9)
    toks = rs.randint(0, pcfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -100
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    want_l, want_g = jax.jit(jax.value_and_grad(
        lambda p: jlosses.lm_loss(jcfg, p, jb)[0]))(sc["jvars"][0])
    pp = tu.map_with_path(lambda _, x: x.clone(), sc["pvars"][0])
    leaves = {p: x.requires_grad_(True) for p, x in tu.flatten_with_paths(pp)
              if "/adapter/" in p}
    loss, _ = losses.lm_loss(pcfg, pp, {k: t(v) for k, v in jb.items()})
    np.testing.assert_allclose(loss.item(), float(want_l), atol=1e-5, rtol=0)
    want = dict(tu_flat(want_g))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert len(grads) == 2 * pcfg.n_layers
    for (path, _), g in zip(leaves.items(), grads):
        ref_g = np.asarray(want[convert.jax_path(path, pcfg)])[
            int(path.split("/")[1])]
        np.testing.assert_allclose(
            g.numpy(), ref_g, rtol=0,
            atol=1e-5 * max(1.0, float(np.abs(ref_g).max())))


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_engines_match_jax(mode):
    """ServeEngine(quant=mode) against JAX's quantized engine over the
    9-on-1 config: every QTensor byte for byte, 7 leaves in quant_summary
    (the biases stay as they are), prefill and decode logits within
    1e-4."""
    sc = _world("gqa9")
    jcfg, pcfg = sc["jcfg"], sc["pcfg"]
    jeng = JServeEngine(jcfg, sc["jvars"][0], quant=mode)
    peng = ServeEngine(pcfg, sc["pvars"][0], quant=mode, device="cpu")
    want, got = _flat(jeng.params), _flat(convert.to_jax_params(peng.params,
                                                                pcfg))
    assert set(got) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(_bytes(got[path]), _bytes(leaf), path)
    qs = tq.quant_summary(peng.params, lambda p: convert.jax_path(p, pcfg))
    jqs = jq.quant_summary(jeng.params)
    assert qs["n_quantized_leaves"] == jqs["n_quantized_leaves"] == 7
    assert qs["quantized_bytes"] == jqs["quantized_bytes"]
    assert not any(tq.is_qtensor(v) for p, v in tu.flatten_with_paths(
        peng.params) if p.rsplit("/", 1)[-1] in ("bq", "bk", "bv", "bo",
                                                 "bi"))
    toks = np.random.RandomState(4).randint(0, pcfg.vocab_size, (B, S))
    wl, jc = jeng.prefill(jnp.asarray(toks), MAX_LEN)
    gl, pc = peng.prefill(toks, MAX_LEN)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=1e-4, rtol=0)
    tok = np.asarray(wl).argmax(-1)
    pos = np.array([S, S - 3])
    wl, _ = jeng.decode_step(jc, jnp.asarray(tok), jnp.asarray(pos, jnp.int32))
    gl, _ = peng.decode_step(pc, tok, pos)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch,H,KH", [("starcoder2-7b", 36, 4),
                                       ("starcoder2-3b", 24, 2)])
def test_kernel_plans_at_the_full_widths(arch, H, KH):
    """#5 over a 4-slot cache of 512 cuts a KV head's H/KH query rows into
    chunks of 8 (7b: 9 = 8 + 1, 3b: 12 = 8 + 4); #3 runs d 3072 on
    warp_row (4 warps, 24 bf16 a lane) and d 4608, no multiple of 1024,
    on split_row."""
    cfg = get(arch)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (H, KH, 128)
    plan = paged_split_plan(4, H, KH, 1, 128, 16, 512 // 16)
    assert (plan["rows_per_block"], plan["row_chunks"]) == (8, 2)
    assert plan["blocks"] == plan["splits"] * KH * 2 * 4
    for n in (4, 128):
        for dt in (torch.bfloat16, torch.float32):
            p = fused_norm_plan(n, cfg.d_model, dt)
            if cfg.d_model == 3072:
                assert (p["kernel"], p["warps_per_row"]) == ("warp_row", 4)
                assert cfg.d_model // (32 * 4) == 24
            else:
                assert p["kernel"] == "split_row" and p["blocks"] == n
