"""The port's LoRA, IA3 and Houlsby baselines (paper Table 3) against the
JAX package: the adapters' hooks in the post-LN encoder (bert smoke) and
the pre-LN decoder (qwen3 smoke), prefill and greedy decode through them,
LoRA over an int8 trunk, and the strategies' trainable counts at
bert-base.

JAX makes the weights; every adapter leaf is moved off its start by
`perturb_adapters` (a fresh LoRA, IA3 or Houlsby adapter is the identity,
which would hide a dropped or misplaced hook), and
`convert.from_jax_params` carries them into the port. On the CPU every
kernel call takes its plain version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import tree as jtu
from repro.common.types import OptimCfg as JOptimCfg
from repro.configs import get as jget
from repro.configs import get_smoke as jget_smoke
from repro.core import hadamard as jhad
from repro.core import peft as jpeft
from repro.data import synthetic as jdata
from repro.models import model as JM
from repro.train import losses as jlosses
from repro.train import steps as jsteps
from repro_torch import convert
from repro_torch.common import tree as tu
from repro_torch.common import types as T
from repro_torch.configs import get
from repro_torch.core import peft
from repro_torch.models import model as M
from repro_torch.train import steps
from repro_torch.train.loop import to_device
from test_torch_model import np_tree, port_cfg

KEY = jax.random.PRNGKey(0)
KINDS = ["lora", "ia3", "houlsby"]
# every adapter leaf of each baseline, as `perturb_adapters` names them
LEAVES = {
    "lora": ("qa", "qb", "va", "vb"),
    "ia3": ("lk", "lv", "lff"),
    "houlsby": tuple(f"{ad}/{w}" for ad in ("attn_ad", "ffn_ad")
                     for w in ("down", "down_b", "up", "up_b")),
}
ARCHS = ["bert-smoke", "qwen3-smoke"]
# the trainable count of each strategy at bert-base, then the total, as
# the JAX package counts them (jax.eval_shape of its init)
BERT_BASE_COUNTS = {
    "hadamard": (36_864, 109_503_746),
    "lora": (887_042, 109_780_226),
    "ia3": (647_426, 109_540_610),
    "houlsby": (3_008_258, 111_864_578),
    "full": (109_485_314, 109_485_314),
    "classifier_only": (592_130, 109_485_314),
}


def cfgs(arch, kind, **over):
    base = jget_smoke("bert-base" if arch == "bert-smoke" else "qwen3-0.6b")
    jcfg = dataclasses.replace(jpeft.attach(base, jpeft.strategy(kind)),
                               **over)
    return jcfg, port_cfg(jcfg)


def weights(jcfg, pcfg, kind):
    """JAX weights with every adapter leaf moved, and the port's copy."""
    jparams = jhad.perturb_adapters(JM.init_params(KEY, jcfg),
                                    jax.random.fold_in(KEY, 3), scale=0.2,
                                    leaves=LEAVES[kind])
    return jparams, convert.from_jax_params(np_tree(jparams), pcfg, "cpu")


def batch_of(arch, pcfg, seed=5):
    """A classification batch of bert smoke, an lm_batches one of qwen3."""
    rs = np.random.RandomState(seed)
    B, S = 3, 12
    if arch == "qwen3-smoke":
        corpus = jdata.lm_corpus(pcfg.vocab_size, 5_000, seed=seed)
        return next(jdata.lm_batches(corpus, 1, B, S, seed=seed))
    types = np.zeros((B, S), np.int32)
    types[:, S // 2:] = 1
    return {"tokens": rs.randint(10, pcfg.vocab_size, (B, S)).astype(np.int32),
            "type_ids": types,
            "labels": rs.randint(0, pcfg.n_classes, (B,)).astype(np.int32)}


def _close_rel(got, want, rel, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


def _jloss(arch):
    return (jlosses.lm_loss if arch == "qwen3-smoke"
            else jlosses.classification_loss)


def _port_grads_in_jax_layout(state, grads, pcfg):
    gtree = tu.map_with_path(lambda p, t: grads.get(p, torch.zeros_like(t)),
                             state["params"])
    return dict(jtu.flatten_with_paths(convert.to_jax_params(gtree, pcfg)))


def test_baseline_strategies_match_jax_field_for_field():
    for kind in KINDS:
        assert dataclasses.asdict(peft.strategy(kind)) == \
            dataclasses.asdict(jpeft.strategy(kind))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", KINDS)
def test_baseline_params_round_trip_through_jax_layout(arch, kind):
    """Every JAX leaf of the adapter carries over, each layer's (d, r)
    slice of a stacked (repeats, d, r) leaf, and stacks back the same."""
    jcfg, pcfg = cfgs(arch, kind)
    jparams, ported = weights(jcfg, pcfg, kind)
    layer = ported["layers"][1]["adapter"]
    if kind == "lora":
        assert tuple(layer["qa"].shape) == (pcfg.d_model, pcfg.adapter.lora_rank)
    want = dict(jtu.flatten_with_paths(np_tree(jparams)))
    got = dict(jtu.flatten_with_paths(convert.to_jax_params(ported, pcfg)))
    assert set(got) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], leaf, err_msg=path)
    # and the port's own init makes the same tree: names, shapes, dtypes
    params = M.init_params(torch.Generator().manual_seed(0), pcfg)
    mine = dict(jtu.flatten_with_paths(convert.to_jax_params(params, pcfg)))
    assert {p: (v.shape, str(v.dtype)) for p, v in mine.items()} == \
        {p: (v.shape, str(v.dtype)) for p, v in want.items()}


def test_fresh_baseline_adapters_are_the_identity():
    """The port's init of each baseline leaves the model's output as it
    is without an adapter: LoRA's qb/vb and Houlsby's up are zero, IA3's
    scales are one. (Hence every parity test here perturbs them.)"""
    _, plain = cfgs("qwen3-smoke", "hadamard")
    tokens = torch.from_numpy(np.random.RandomState(2).randint(0, 503, (2, 9)))
    gen = torch.Generator().manual_seed(4)
    base = M.init_params(gen, peft.attach(plain, peft.strategy("full")))
    want = M.forward_lm(base, plain.replace(
        adapter=T.AdapterCfg(kind="none")), tokens)
    for kind in KINDS:
        pcfg = peft.attach(plain, peft.strategy(kind))
        params = M.init_params(torch.Generator().manual_seed(9), pcfg)
        for path, leaf in tu.flatten_with_paths(base):
            t = params
            for k in path.split("/"):
                t = t[int(k)] if isinstance(t, list) else t[k]
            t.copy_(leaf)
        got = M.forward_lm(params, pcfg, tokens)
        assert torch.equal(got, want), kind


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", KINDS)
def test_baseline_logits_loss_and_gradients_match_jax(arch, kind):
    """The forward (class logits of the post-LN encoder, the decoder's
    LM logits through rope and GQA) within 1e-4 of max |logit|; one
    step's loss within 1e-4 relative and each trainable gradient of the
    strategy (adapter, head, and Houlsby's norms) within 1e-4 of its own
    max |JAX gradient|."""
    jcfg, pcfg = cfgs(arch, kind)
    jparams, ported = weights(jcfg, pcfg, kind)
    b = batch_of(arch, pcfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = to_device(b, "cpu")
    if arch == "qwen3-smoke":
        want = JM.forward_lm(jparams, jcfg, jb["tokens"])[0]
        got = M.forward_lm(ported, pcfg, tb["tokens"])
    else:
        want = JM.forward_encoder(jparams, jcfg, jb["tokens"],
                                  jb["type_ids"])[0]
        got = M.forward_encoder(ported, pcfg, tb["tokens"], tb["type_ids"])[0]
    _close_rel(got.detach().numpy(), want, 1e-4, "logits")

    strat = jpeft.strategy(kind)
    trainable, frozen = jtu.partition(
        jparams, jpeft.trainable_mask(jparams, strat, stage=2))

    def jloss(tr):
        return _jloss(arch)(jcfg, jtu.merge(tr, frozen), jb)[0]

    want_loss, wgrads = jax.jit(jax.value_and_grad(jloss))(trainable)
    state = steps.make_state(None, pcfg, peft.strategy(kind), T.OptimCfg(),
                             params=ported)
    loss, _, grads = steps.loss_and_grads(pcfg, state, tb)
    assert abs(loss.item() - float(want_loss)) <= \
        1e-4 * abs(float(want_loss))
    got = _port_grads_in_jax_layout(state, grads, pcfg)
    wgrads = {p: v for p, v in jtu.flatten_with_paths(wgrads)
              if v is not None}
    assert {convert.jax_path(p, pcfg) for p in grads} == set(wgrads)
    assert any("/adapter/" in p for p in wgrads)
    for path, w in wgrads.items():
        _close_rel(got[path], w, 1e-4, path)


@pytest.mark.parametrize("kind", KINDS)
def test_baseline_train_steps_match_jax(kind):
    """3 train steps on bert smoke from one backbone: losses within 1e-4
    relative and every trainable leaf within 1e-5 of JAX's. AdamW decays
    the leaves JAX decays (rank >= 2 in its stacked layout: every adapter
    leaf, IA3's vectors and Houlsby's biases included), so IA3's scales,
    which start at 1, move by the decay even where their gradient is
    small."""
    from repro.train import loop as jloop
    from repro_torch.train import loop

    jcfg, pcfg = cfgs("bert-smoke", kind)
    jparams, ported = weights(jcfg, pcfg, kind)
    data = jdata.TaskData("sst2", pcfg.vocab_size, seq_len=16)
    ocfg = dict(lr=3e-3, total_steps=3)
    jstate = jsteps.make_state(KEY, jcfg, jpeft.strategy(kind),
                               JOptimCfg(**ocfg), params=jparams)
    jstate, jhist = jloop.run_train(
        jstate, jsteps.build_train_step(jcfg, JOptimCfg(**ocfg)),
        data.train_batches(3, 4, seed=0), steps=3, log=lambda m: None)
    state = steps.make_state(None, pcfg, peft.strategy(kind),
                             T.OptimCfg(**ocfg), params=ported)
    state, hist = loop.run_train(
        state, steps.build_train_step(pcfg, T.OptimCfg(**ocfg)),
        data.train_batches(3, 4, seed=0), steps=3, log=lambda m: None)
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [float(h["loss"]) for h in jhist],
                               rtol=1e-4, atol=0)
    want = {p: v for p, v in jtu.flatten_with_paths(jstate["trainable"])
            if v is not None}
    assert {convert.jax_path(p, pcfg) for p in state["trainable"]} == \
        set(want)
    with torch.no_grad():
        got = dict(jtu.flatten_with_paths(
            convert.to_jax_params(state["params"], pcfg)))
    for path, w in want.items():
        np.testing.assert_allclose(got[path], np.asarray(w), atol=1e-5,
                                   rtol=0, err_msg=path)


@pytest.mark.parametrize("kind", KINDS)
def test_baseline_prefill_and_greedy_decode_match_jax(kind):
    """A prefill and 4 greedy decode steps on qwen3 smoke: the tokens are
    JAX's, the logits within 1e-4. IA3 scales k after rope and before the
    cache stores it, so the decode steps read the scaled keys."""
    jcfg, pcfg = cfgs("qwen3-smoke", kind)
    jparams, ported = weights(jcfg, pcfg, kind)
    tokens = np.random.RandomState(7).randint(0, pcfg.vocab_size, (2, 10))
    cache_len = 32
    want, jcaches = JM.prefill_lm(jparams, jcfg, jnp.asarray(tokens),
                                  cache_len=cache_len)
    got, caches = M.prefill_lm(ported, pcfg, torch.from_numpy(tokens),
                               cache_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    jtok = np.asarray(jnp.argmax(want[:, -1], -1))[:, None]
    tok = got[:, -1].argmax(-1)[:, None].numpy()
    pos = np.full((2,), tokens.shape[1])
    jtoks, toks = [jtok], [tok]
    for step in range(4):
        np.testing.assert_array_equal(tok, jtok)
        want, jcaches = JM.decode_lm(jparams, jcfg, jcaches, jnp.asarray(jtok),
                                     jnp.asarray(pos + step, jnp.int32))
        got, caches = M.decode_lm(ported, pcfg, caches, torch.from_numpy(tok),
                                  torch.from_numpy(pos + step))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)
        jtok = np.asarray(jnp.argmax(want[:, -1], -1))[:, None]
        tok = got[:, -1].argmax(-1)[:, None].numpy()
        jtoks.append(jtok)
        toks.append(tok)
    np.testing.assert_array_equal(np.concatenate(toks, 1),
                                  np.concatenate(jtoks, 1))


def test_lora_over_an_int8_trunk_matches_jax():
    """QPEFT with LoRA: the frozen trunk int8 in both packages (byte for
    byte JAX's quantize), the loss within 1e-4 relative and each LoRA
    gradient within 1e-4 of its max |JAX gradient|."""
    jcfg, pcfg = cfgs("qwen3-smoke", "lora")
    jparams, ported = weights(jcfg, pcfg, "lora")
    corpus = jdata.lm_corpus(pcfg.vocab_size, 20_000, seed=0)
    batches = list(jdata.lm_batches(corpus, 1, 2, 8, seed=0))
    ocfg = dict(lr=3e-3, total_steps=5)
    strat, jstrat = peft.strategy("lora"), jpeft.strategy("lora")
    jstate = jsteps.make_state(KEY, jcfg, jstrat, JOptimCfg(**ocfg),
                               params=jparams, quant="int8")
    state = steps.make_state(None, pcfg, strat, T.OptimCfg(**ocfg),
                             params=ported, quant="int8")
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}

    def jloss(tr):
        return jlosses.lm_loss(jcfg, jtu.merge(tr, jstate["frozen"]), jb)[0]

    want_loss, wgrads = jax.jit(jax.value_and_grad(jloss))(
        jstate["trainable"])
    loss, _, grads = steps.loss_and_grads(pcfg, state, to_device(batches[0],
                                                                 "cpu"))
    assert abs(loss.item() - float(want_loss)) <= 1e-4 * abs(float(want_loss))
    per_jax = {}
    for path, g in grads.items():
        per_jax.setdefault(convert.jax_path(path, pcfg), []).append(g.numpy())
    wgrads = {p: v for p, v in jtu.flatten_with_paths(wgrads)
              if v is not None}
    assert set(per_jax) == set(wgrads)
    for path, w in wgrads.items():
        _close_rel(np.stack(per_jax[path]), w, 1e-4, path)



@pytest.mark.parametrize("sname", sorted(BERT_BASE_COUNTS))
def test_bert_base_trainable_counts_match_jax(sname):
    """Each strategy's trainable and total counts at bert-base (Table 3),
    as JAX counts them on jax.eval_shape of its init; the port builds its
    tree on the meta device, so no weights are made."""
    strat = peft.strategy(sname)
    pcfg = peft.attach(get("bert-base"), strat)
    with torch.device("meta"):
        params = M.init_params(None, pcfg)
    stats = peft.param_stats(params,
                             peft.trainable_mask(params, strat, 2, cfg=pcfg))
    assert (stats["trainable"], stats["total"]) == BERT_BASE_COUNTS[sname]
    jstrat = jpeft.strategy(sname)
    jcfg = jpeft.attach(jget("bert-base"), jstrat)
    shapes = jax.eval_shape(lambda: JM.init_params(KEY, jcfg))
    want = jpeft.param_stats(shapes, jpeft.trainable_mask(shapes, jstrat,
                                                          stage=2))
    assert stats == want


def test_baselines_on_rwkv_blocks_raise():
    """The three baselines on RWKV6 blocks (rwkv6-1.6b smoke) raise
    nothing and serve JAX's logits: a 10-token prefill and 3 decode steps,
    within 1e-4, for each. Houlsby's bottlenecks wrap the time-mix and the
    channel-mix outputs; LoRA's and IA3's leaves, perturbed too, are read
    by no rwkv op, so those models' logits are the bare backbone's."""
    tokens = np.random.RandomState(7).randint(0, 503, (2, 10))
    bare = None
    for kind in KINDS:
        jcfg = jpeft.attach(jget_smoke("rwkv6-1.6b"), jpeft.strategy(kind))
        pcfg = port_cfg(jcfg)
        jparams, ported = weights(jcfg, pcfg, kind)
        want, jcaches = JM.prefill_lm(jparams, jcfg, jnp.asarray(tokens),
                                      cache_len=16)
        got, caches = M.prefill_lm(ported, pcfg, torch.from_numpy(tokens),
                                   16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0, err_msg=kind)
        if kind != "houlsby":
            bare = got if bare is None else bare
            assert torch.equal(got, bare), kind
        tok = got[:, -1].argmax(-1)[:, None]
        for step in range(3):
            pos = np.full((2,), tokens.shape[1] + step, np.int32)
            want, jcaches = JM.decode_lm(jparams, jcfg, jcaches,
                                         jnp.asarray(tok.numpy()),
                                         jnp.asarray(pos))
            got, caches = M.decode_lm(ported, pcfg, caches, tok,
                                      torch.from_numpy(pos))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-4, rtol=0, err_msg=kind)
            tok = got[:, -1].argmax(-1)[:, None]
