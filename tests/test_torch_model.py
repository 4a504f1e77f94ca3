"""The port's decoder against the JAX model on the same weights.

The weights are made with JAX (adapters moved off the identity by
`perturb_adapters`, so a misplaced adapter shows), converted to numpy, and
carried into the port by `convert.from_jax_params`. Prefill and three
per-row decode steps must give the JAX logits within 1e-4 at fp32, through
the fused adapter seam (one adapter) and the multitask seam (a 3-task bank
against JAX `select_tasks`). On the CPU every kernel call takes its plain
version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro.configs import get_smoke as jax_get_smoke
from repro.core import hadamard as jhad
from repro.core import peft as jpeft
from repro.models import model as JM
from repro_torch import convert
from repro_torch.common import types as T
from repro_torch.configs import get_smoke
from repro_torch.core import peft
from repro_torch.models import model as M

KEY = jax.random.PRNGKey(0)


def port_cfg(jcfg) -> T.ModelCfg:
    """The port's ModelCfg with every field of a JAX ModelCfg."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    for name in ("groups", "enc_groups"):
        kw[name] = tuple(
            T.Group(tuple(T.Slot(**dataclasses.asdict(s)) for s in g.slots),
                    g.repeats) for g in getattr(jcfg, name))
    kw["adapter"] = T.AdapterCfg(**dataclasses.asdict(jcfg.adapter))
    if jcfg.moe is not None:
        kw["moe"] = T.MoECfg(**dataclasses.asdict(jcfg.moe))
    return T.ModelCfg(**kw)


def jax_cfg(name):
    if name == "tiny":
        return tiny_cfg()
    return jpeft.attach(jax_get_smoke("qwen3-0.6b"), jpeft.strategy("hadamard"))


def jax_params(cfg, tasks=0):
    base = JM.init_params(KEY, cfg)
    variants = [jhad.perturb_adapters(base, jax.random.fold_in(KEY, 100 + t),
                                      scale=0.2) for t in range(max(tasks, 1))]
    return variants if tasks else variants[0]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_qwen3_configs_match_jax_field_for_field():
    jcfg = jax_get_smoke("qwen3-0.6b")
    assert dataclasses.asdict(port_cfg(jcfg)) == dataclasses.asdict(
        get_smoke("qwen3-0.6b"))
    attached = peft.attach(get_smoke("qwen3-0.6b"), peft.strategy("hadamard"))
    assert attached.adapter == port_cfg(
        jpeft.attach(jcfg, jpeft.strategy("hadamard"))).adapter
    assert {f.name for f in dataclasses.fields(jcfg)} == {
        f.name for f in dataclasses.fields(T.ModelCfg)}


@pytest.mark.parametrize("tasks", [0, 3])
def test_from_jax_params_round_trips_every_leaf(tasks):
    jcfg = jax_cfg("tiny")
    params = jax_params(jcfg, tasks)
    tree = np_tree(jhad.build_bank(params) if tasks else params)
    ported = convert.from_jax_params(tree, port_cfg(jcfg), "cpu")
    back = convert.to_jax_params(ported, port_cfg(jcfg))
    want = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(got) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], leaf)
    # layer r of group 0 holds slice r of every stacked leaf
    w = tree["blocks"]["g0"]["slot0"]["adapter"]["w"]
    for r in range(jcfg.groups[0].repeats):
        np.testing.assert_array_equal(
            ported["layers"][r]["adapter"]["w"].numpy(), w[r])
    assert ported["layers"][0]["adapter"]["w"].shape == (
        (tasks, jcfg.d_model) if tasks else (jcfg.d_model,))


def test_from_jax_params_raises_on_an_unknown_leaf():
    jcfg = jax_cfg("tiny")
    tree = np_tree(jax_params(jcfg))
    tree["blocks"]["g0"]["slot0"]["attn"]["mystery"] = np.zeros((2, 3))
    with pytest.raises(KeyError, match="mystery"):
        convert.from_jax_params(tree, port_cfg(jcfg), "cpu")
    tree = np_tree(jax_params(jcfg))
    tree["pooler"] = {"kernel": np.zeros((3, 3))}
    with pytest.raises(KeyError, match="pooler"):
        convert.from_jax_params(tree, port_cfg(jcfg), "cpu")


@pytest.mark.parametrize("name", ["tiny", "qwen3-smoke"])
@pytest.mark.parametrize("tasks", [0, 3])
def test_prefill_and_decode_match_jax(name, tasks):
    jcfg = jax_cfg(name)
    pcfg = port_cfg(jcfg)
    params = jax_params(jcfg, tasks)
    task_ids = np.array([0, 2], np.int32)
    if tasks:
        jparams = jhad.select_tasks(jhad.build_bank(params),
                                    jnp.asarray(task_ids))
        ported = convert.from_jax_params(np_tree(jhad.build_bank(params)),
                                         pcfg, "cpu")
        tids = torch.from_numpy(task_ids)
    else:
        jparams = params
        ported = convert.from_jax_params(np_tree(params), pcfg, "cpu")
        tids = None
    rs = np.random.RandomState(7)
    B, S, cache_len = 2, 10, 32
    tokens = rs.randint(0, pcfg.vocab_size, (B, S))
    want, jcaches = JM.prefill_lm(jparams, jcfg, jnp.asarray(tokens),
                                  cache_len=cache_len)
    got, caches = M.prefill_lm(ported, pcfg, torch.from_numpy(tokens),
                               cache_len, task_ids=tids)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    # per-row positions: the rows sit at different depths of their caches
    pos = np.array([S, S - 3])
    for step in range(3):
        tok = rs.randint(0, pcfg.vocab_size, (B, 1))
        want, jcaches = JM.decode_lm(jparams, jcfg, jcaches, jnp.asarray(tok),
                                     jnp.asarray(pos + step, jnp.int32))
        got, caches = M.decode_lm(ported, pcfg, caches, torch.from_numpy(tok),
                                  torch.from_numpy(pos + step), task_ids=tids)
        assert got.shape == (B, 1, pcfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)


def test_identity_adapters_would_hide_the_seam():
    """The perturbed adapters above change the logits: a dropped or
    misplaced adapter could not pass the parity test by accident."""
    jcfg = jax_cfg("tiny")
    pcfg = port_cfg(jcfg)
    tokens = torch.from_numpy(np.random.RandomState(1).randint(0, 97, (1, 6)))
    base = convert.from_jax_params(np_tree(JM.init_params(KEY, jcfg)), pcfg,
                                   "cpu")
    tuned = convert.from_jax_params(np_tree(jax_params(jcfg)), pcfg, "cpu")
    a, _ = M.prefill_lm(base, pcfg, tokens, 16)
    b, _ = M.prefill_lm(tuned, pcfg, tokens, 16)
    assert (a - b).abs().max() > 1e-3


def test_unported_blocks_raise_naming_the_slice():
    # windowed layers (the ring cache), MoE FFNs on attention blocks,
    # RG-LRU blocks and cross-attention (an encdec decoder's) are ported;
    # an RWKV6 block with experts is not, and a cross slot outside an
    # encdec config has no encoder to attend over
    cfg = get_smoke("qwen3-0.6b").replace(
        groups=(T.Group((T.Slot("rwkv", moe=True),), 2),))
    with pytest.raises(NotImplementedError, match="RWKV6 block with experts"):
        M.init_params(torch.Generator().manual_seed(0), cfg)
    cfg = get_smoke("qwen3-0.6b").replace(
        groups=(T.Group((T.Slot("attn", cross_attn=True),), 2),))
    with pytest.raises(ValueError, match="encdec config's decoder"):
        M.init_params(torch.Generator().manual_seed(0), cfg)
    rec = get_smoke("qwen3-0.6b").replace(
        groups=(T.Group((T.Slot("rec"),), 2),), lru_width=64)
    layers = M.init_params(torch.Generator().manual_seed(0), rec)["layers"]
    assert "attn" not in layers[0] and layers[0]["rec"]["gate_a"].shape == (
        64, 64)
    windowed = get_smoke("qwen3-0.6b").replace(
        groups=(T.Group((T.Slot("attn", window=8),), 2),))
    M.init_params(torch.Generator().manual_seed(0), windowed)
    moe = get_smoke("qwen3-0.6b").replace(
        groups=(T.Group((T.Slot("attn", moe=True),), 2),))
    with pytest.raises(ValueError, match="needs cfg.moe"):
        M.init_params(torch.Generator().manual_seed(0), moe)
    moe = moe.replace(moe=T.MoECfg(n_experts=4, top_k=2, d_expert=16))
    layers = M.init_params(torch.Generator().manual_seed(0), moe)["layers"]
    assert "mlp" not in layers[0] and layers[0]["moe"]["wi"].shape == (
        4, 64, 16)
    # an encdec config without its encoder stack (enc_groups) is refused
    with pytest.raises(ValueError, match="encdec config holds its encoder"):
        M.init_params(torch.Generator().manual_seed(0),
                      get_smoke("qwen3-0.6b").replace(family="encdec"))
