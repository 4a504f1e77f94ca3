"""The port's BERT-family encoder and its PEFT partition against JAX.

JAX makes the weights (adapters moved off the identity by
`perturb_adapters`, so a misplaced adapter shows); `convert.from_jax_params`
carries them into the port. The encoder's logits, one train step's loss and
trainable gradients, and the trainable counts of every ported strategy must
agree with the JAX package at fp32. On the CPU every kernel call inside
takes its plain version.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.common import tree as jtu
from repro.configs import get as jget
from repro.configs import get_smoke as jget_smoke
from repro.core import hadamard as jhad
from repro.core import peft as jpeft
from repro.models import model as JM
from repro.train import losses as jlosses
from repro_torch import convert
from repro_torch.common import tree as tu
from repro_torch.common.types import OptimCfg
from repro_torch.configs import get, get_smoke
from repro_torch.core import peft
from repro_torch.models import model as M
from repro_torch.train.loop import to_device
from repro_torch.train.steps import loss_and_grads, make_state

KEY = jax.random.PRNGKey(0)
ARCHS = ["bert-tiny", "bert-smoke"]


def cfgs(arch, sname):
    """(JAX config, port config) of `arch` with strategy `sname` attached;
    the two agree field for field."""
    jcfg = jget_smoke("bert-base") if arch == "bert-smoke" else jget(arch)
    pcfg = get_smoke("bert-base") if arch == "bert-smoke" else get(arch)
    jcfg = jpeft.attach(jcfg, jpeft.strategy(sname))
    pcfg = peft.attach(pcfg, peft.strategy(sname))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    return jcfg, pcfg


def weights(jcfg, pcfg):
    """Perturbed JAX weights and their port copy."""
    jparams = jhad.perturb_adapters(JM.init_params(KEY, jcfg),
                                    jax.random.fold_in(KEY, 7), scale=0.2)
    return jparams, convert.from_jax_params(
        jax.tree.map(np.asarray, jparams), pcfg, "cpu")


def batch(pcfg, B=3, S=12, seed=5):
    rs = np.random.RandomState(seed)
    types = np.zeros((B, S), np.int32)
    types[:, S // 2:] = 1
    return {"tokens": rs.randint(10, pcfg.vocab_size, (B, S)).astype(np.int32),
            "type_ids": types,
            "labels": rs.randint(0, pcfg.n_classes, (B,)).astype(np.int32)}


def _close_rel(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("sname", ["hadamard", "hadamard_concat"])
def test_forward_encoder_matches_jax(arch, sname):
    jcfg, pcfg = cfgs(arch, sname)
    jparams, ported = weights(jcfg, pcfg)
    b = batch(pcfg)
    want = JM.forward_encoder(jparams, jcfg, b["tokens"], b["type_ids"])
    got = M.forward_encoder(ported, pcfg, torch.from_numpy(b["tokens"]),
                            torch.from_numpy(b["type_ids"]))
    assert got[0].shape == (3, pcfg.n_classes) and got[0].dtype == torch.float32
    for g, w in zip(got, want):  # logits, pooled, sequence states
        _close_rel(g.numpy(), w, 1e-4)
    # the identity adapters would give other logits: the seam is exercised
    plain = convert.from_jax_params(
        jax.tree.map(np.asarray, JM.init_params(KEY, jcfg)), pcfg, "cpu")
    base = M.forward_encoder(plain, pcfg, torch.from_numpy(b["tokens"]),
                             torch.from_numpy(b["type_ids"]))[0]
    assert (base - got[0]).abs().max() > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("sname", ["hadamard", "hadamard_concat"])
def test_train_step_loss_and_grads_match_jax(arch, sname):
    jcfg, pcfg = cfgs(arch, sname)
    jparams, ported = weights(jcfg, pcfg)
    b = batch(pcfg)
    trainable, frozen = jtu.partition(
        jparams, jpeft.trainable_mask(jparams, jpeft.strategy(sname), stage=2))

    def jloss(tr):
        return jlosses.classification_loss(jcfg, jtu.merge(tr, frozen), b)[0]

    want_loss, want = jax.value_and_grad(jloss)(trainable)
    state = make_state(None, pcfg, peft.strategy(sname), OptimCfg(),
                       params=ported)
    loss, _, grads = loss_and_grads(pcfg, state, to_device(b, "cpu"))
    assert abs(loss.item() - float(want_loss)) <= 1e-4 * abs(float(want_loss))
    # the port's grads in JAX's layout (stacked per group), zero where frozen
    gtree = tu.map_with_path(lambda p, t: grads.get(p, torch.zeros_like(t)),
                             state["params"])
    got = dict(jtu.flatten_with_paths(convert.to_jax_params(gtree, pcfg)))
    want = dict(jtu.flatten_with_paths(want))
    assert set(want) == {p for p in got if p in want}
    assert len(want) == 4  # adapter w, b and the ffn norm's scale, bias
    for path, w in want.items():
        _close_rel(got[path], w, 1e-4)


STRATS = ["full", "classifier_only", "hadamard", "hadamard_concat", "bitfit",
          "ln_tuning"]


@pytest.mark.parametrize("sname", STRATS + ["ablation:B+N", "ablation:W+A"])
def test_param_stats_match_jax(sname):
    if sname.startswith("ablation:"):
        jstrat = jpeft.ablation_strategy(sname.split(":")[1])
        strat = peft.ablation_strategy(sname.split(":")[1])
    else:
        jstrat, strat = jpeft.strategy(sname), peft.strategy(sname)
    assert dataclasses.asdict(jstrat) == dataclasses.asdict(strat)
    jcfg = jpeft.attach(jget("bert-tiny"), jstrat)
    pcfg = peft.attach(get("bert-tiny"), strat)
    jparams = JM.init_params(KEY, jcfg)
    params = M.init_params(torch.Generator().manual_seed(0), pcfg)
    for stage in (1, 2):
        want = jpeft.param_stats(
            jparams, jpeft.trainable_mask(jparams, jstrat, stage=stage))
        got = peft.param_stats(
            params, peft.trainable_mask(params, strat, stage, cfg=pcfg))
        assert got == want


def test_bert_base_trains_the_papers_fraction():
    """0.0337 % of bert-base, as the JAX package counts it (no weights are
    made: the tree is built on the meta device)."""
    pcfg = peft.attach(get("bert-base"), peft.strategy("hadamard"))
    with torch.device("meta"):
        params = M.init_params(None, pcfg)
    stats = peft.param_stats(
        params, peft.trainable_mask(params, peft.strategy("hadamard"), 2,
                                    cfg=pcfg))
    assert (stats["trainable"], stats["total"]) == (36_864, 109_503_746)
    assert round(stats["percent"], 4) == 0.0337


def test_unported_strategies_and_gating_raise_naming_the_slice():
    for name in ("lora", "houlsby", "ia3"):
        with pytest.raises(NotImplementedError, match="slice"):
            peft.strategy(name)
    with pytest.raises(NotImplementedError, match="sparse"):
        peft.layer_gate({}, get("bert-tiny"), 1)
    with pytest.raises(KeyError, match="unknown strategy"):
        peft.strategy("nope")


def test_encoder_params_round_trip_through_jax_layout():
    jcfg, pcfg = cfgs("bert-tiny", "hadamard")
    jparams, ported = weights(jcfg, pcfg)
    want = dict(jtu.flatten_with_paths(jax.tree.map(np.asarray, jparams)))
    got = dict(jtu.flatten_with_paths(convert.to_jax_params(ported, pcfg)))
    assert set(got) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], leaf)
    assert convert.jax_path("layers/1/adapter/w", pcfg) == \
        "blocks/g0/slot0/adapter/w"
    assert convert.jax_path("pooler/kernel", pcfg) == "pooler/kernel"
