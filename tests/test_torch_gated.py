"""The port's gated training (paper Table 5: only the top k layers'
adapters tune) and its layer search against the JAX package: the
gradient gate, gated train steps, the two-stage recipe under a layer
mask, `layer_gate`'s clamp, `ablation_importance` and `search_mask`.

JAX makes the bert weights and `convert.from_jax_params` carries them
over; on the CPU every kernel call takes its plain version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import tree as jtu
from repro.common.types import Group as JGroup
from repro.common.types import OptimCfg as JOptimCfg
from repro.common.types import Slot as JSlot
from repro.common.types import TrainCfg as JTrainCfg
from repro.configs import get as jget
from repro.configs import get_smoke as jget_smoke
from repro.core import hadamard as jhad
from repro.core import peft as jpeft
from repro.data import synthetic as jdata
from repro.models import model as JM
from repro.sparse import importance as jimp
from repro.sparse import prune as jprune
from repro.train import loop as jloop
from repro.train import steps as jsteps
from repro_torch import convert
from repro_torch.common import tree as tu
from repro_torch.common import types as T
from repro_torch.core import peft
from repro_torch.data import synthetic as tdata
from repro_torch.models import model as M
from repro_torch.sparse import importance as imp
from repro_torch.sparse import prune
from repro_torch.train import loop, steps
from test_torch_model import np_tree, port_cfg

KEY = jax.random.PRNGKey(0)
STEPS, LR = 5, 3e-3


def _cfgs(n_layers=2, sname="hadamard"):
    jcfg = jpeft.attach(jget_smoke("bert-base"), jpeft.strategy(sname))
    jcfg = dataclasses.replace(
        jcfg, groups=(JGroup((JSlot("attn"),), n_layers),))
    return jcfg, port_cfg(jcfg)


def _batches(pcfg, n=STEPS):
    data = jdata.TaskData("sst2", pcfg.vocab_size, seq_len=16)
    return list(data.train_batches(n, 4, seed=0))


def _leaves(pcfg, state):
    """The port's trainable leaves by JAX path, stacked as JAX holds
    them."""
    got = {}
    for path, t in state["trainable"].items():
        got.setdefault(convert.jax_path(path, pcfg), []).append(
            t.detach().numpy())
    return {p: np.stack(v) for p, v in got.items()}


@pytest.mark.parametrize("perturbed", [False, True])
def test_gated_train_steps_match_jax(perturbed):
    """5 steps with layer 0 gated off, from the identity adapters of a
    fresh stage 2 and from perturbed ones: losses within 1e-4 relative,
    every trainable leaf within 1e-5 of JAX's. The gate multiplies the
    gradient, it does not freeze the leaf: AdamW still steps a gated-off
    leaf with a zero gradient, so weight decay (0.01) pulls that layer's
    adapter w and ffn_norm scale (leaves of rank 2 in JAX's stacked
    layout) toward 0, while its b and ffn_norm bias, which start at 0,
    stay exactly 0. `gate=peft.layer_gate(...)` gives the same bits as
    `layer_mask=`."""
    jcfg, pcfg = _cfgs()
    jparams = JM.init_params(KEY, jcfg)
    if perturbed:
        jparams = jhad.perturb_adapters(jparams, jax.random.fold_in(KEY, 1),
                                        scale=0.2)
    ported = convert.from_jax_params(np_tree(jparams), pcfg, "cpu")
    mask = np.array([False, True])
    ocfg = dict(lr=LR, total_steps=STEPS)
    strat, jstrat = peft.strategy("hadamard"), jpeft.strategy("hadamard")
    jstate = jsteps.make_state(KEY, jcfg, jstrat, JOptimCfg(**ocfg),
                               params=jparams)
    jstate, jhist = jloop.run_train(
        jstate, jsteps.build_train_step(jcfg, JOptimCfg(**ocfg),
                                        layer_mask=mask),
        _batches(pcfg), steps=STEPS, log=lambda m: None)
    runs = []
    for how in ("layer_mask", "gate"):
        state = steps.make_state(None, pcfg, strat, T.OptimCfg(**ocfg),
                                 params=ported)
        kw = ({"layer_mask": mask} if how == "layer_mask" else
              {"gate": peft.layer_gate(state["params"], pcfg, 1)})
        state, hist = loop.run_train(
            state, steps.build_train_step(pcfg, T.OptimCfg(**ocfg), **kw),
            _batches(pcfg), steps=STEPS, log=lambda m: None)
        runs.append((state, [h["loss"] for h in hist]))
    (state, losses_), (state_g, losses_g) = runs
    np.testing.assert_allclose(losses_, [float(h["loss"]) for h in jhist],
                               rtol=1e-4, atol=0)
    assert losses_g == losses_
    assert all(torch.equal(state_g["trainable"][p], t)
               for p, t in state["trainable"].items())
    want = dict(jtu.flatten_with_paths(jstate["trainable"]))
    got = _leaves(pcfg, state)
    assert set(got) == {p for p, v in want.items() if v is not None}
    for path, g in got.items():
        np.testing.assert_allclose(g, np.asarray(want[path]), atol=1e-5,
                                   rtol=0, err_msg=path)
    start = ported["layers"]
    off, on = state["params"]["layers"]
    for leaf in ("adapter/w", "ffn_norm/scale"):
        a, n = leaf.split("/")
        assert (off[a][n].abs() < start[0][a][n].abs()).all(), leaf
    if not perturbed:
        assert not off["adapter"]["b"].any()
        assert not off["ffn_norm"]["bias"].any()
        assert on["adapter"]["b"].abs().max() > 1e-4


def test_gate_and_layer_mask_together_raise():
    _, pcfg = _cfgs()
    with pytest.raises(ValueError, match="either gate or layer_mask"):
        steps.build_train_step(pcfg, T.OptimCfg(), gate={},
                               layer_mask=np.array([True, True]))


@pytest.mark.parametrize("top", [None, -3, 0, 1, 2, 7])
def test_layer_gate_clamps_and_counts_as_jax(top):
    """top_layers clamped to [0, L] (0 gates every layer off), None gates
    nothing: each layer leaf's gate equals its row of JAX's stacked gate,
    and gated_param_count is JAX's."""
    jcfg, pcfg = _cfgs(n_layers=3)
    jparams = JM.init_params(KEY, jcfg)
    params = convert.from_jax_params(np_tree(jparams), pcfg, "cpu")
    want = dict(jtu.flatten_with_paths(jpeft.layer_gate(jparams, jcfg, top)))
    got = dict(tu.flatten_with_paths(peft.layer_gate(params, pcfg, top)))
    for path, g in got.items():
        w = np.asarray(want[convert.jax_path(path, pcfg)], np.float32)
        if path.startswith("layers/"):
            w = w.reshape(w.shape[0], -1)[int(path.split("/")[1]), 0] \
                if w.ndim else w
        assert float(g) == float(w), path
    strat = jpeft.strategy("hadamard")
    jmask = jpeft.trainable_mask(jparams, strat)
    mask = peft.trainable_mask(params, peft.strategy("hadamard"), cfg=pcfg)
    assert peft.gated_param_count(params, mask,
                                  peft.layer_gate(params, pcfg, top)) == \
        jpeft.gated_param_count(jparams, jmask,
                                jpeft.layer_gate(jparams, jcfg, top))


def test_two_stage_finetune_under_a_layer_mask_matches_jax():
    """The recipe's stage 2 gated to the top layer of bert-tiny (3 + 3
    steps, as tests/test_torch_train.py runs it): losses within 1e-4, the
    metrics and the gated param_stats equal, trained leaves within 1e-5;
    the gated-off layer's b and ffn_norm bias still exactly 0."""
    jcfg, pcfg = jget("bert-tiny"), port_cfg(jget("bert-tiny"))
    tc = dict(steps=3, batch_size=4, seq_len=16, log_every=0)
    jtc = JTrainCfg(optim=JOptimCfg(lr=LR, total_steps=3), **tc)
    ttc = T.TrainCfg(optim=T.OptimCfg(lr=LR, total_steps=3), **tc)
    mask = jimp.depth_mask(jcfg, 1)
    assert (mask == imp.depth_mask(pcfg, 1)).all()
    backbone = JM.init_params(KEY, jcfg)
    want = jloop.two_stage_finetune(
        KEY, jcfg, "hadamard",
        jdata.TaskData("sst2", jcfg.vocab_size, seq_len=16),
        stage1=jtc, stage2=jtc, pretrained_params=backbone,
        layer_mask=mask, log=lambda m: None)
    got = loop.two_stage_finetune(
        0, pcfg, "hadamard", tdata.TaskData("sst2", pcfg.vocab_size,
                                            seq_len=16),
        stage1=ttc, stage2=ttc, device="cpu", layer_mask=mask,
        log=lambda m: None,
        pretrained_params=convert.from_jax_params(np_tree(backbone), pcfg,
                                                  "cpu"))
    for stage in ("stage1", "stage2"):
        np.testing.assert_allclose(
            [h["loss"] for h in got["history"][stage]],
            [float(h["loss"]) for h in want["history"][stage]],
            rtol=1e-4, atol=0)
    assert got["final_metric"] == want["final_metric"]
    assert got["param_stats"] == want["param_stats"]
    # one layer of four 128-vectors: adapter w, b and the norm's scale, bias
    assert got["param_stats"]["trainable"] == 4 * 128
    gtree = dict(jtu.flatten_with_paths(
        convert.to_jax_params(got["params"], got["cfg"])))
    for path, w in jtu.flatten_with_paths(want["params"]):
        if "/adapter/" in path or "/ffn_norm/" in path:
            np.testing.assert_allclose(gtree[path], np.asarray(w), atol=1e-5,
                                       rtol=0, err_msg=path)
    layer0 = got["params"]["layers"][0]
    assert not layer0["adapter"]["b"].any()
    assert not layer0["ffn_norm"]["bias"].any()


def _quality(jcfg, pcfg, jparams, params, batch):
    """The same eval function in both packages, of params given in each
    package's layout: minus the mean squared distance of the encoder's
    sequence states from those of the tuned model (`jparams`/`params`),
    so that every ablated adapter costs quality."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = loop.to_device(batch, "cpu")
    jstates = jax.jit(lambda p: JM.forward_encoder(p, jcfg, jb["tokens"],
                                                   jb["type_ids"])[2])
    jref = jstates(jparams)

    def jq(p):
        return -float(jnp.mean(jnp.square(jstates(p) - jref)))

    @torch.no_grad()
    def tstates(p):
        return M.forward_encoder(p, pcfg, tb["tokens"], tb["type_ids"])[2]

    tref = tstates(params)

    def tq(p):
        return -(tstates(p) - tref).square().mean().item()

    return jq, tq


def test_ablation_importance_and_search_mask_match_jax():
    """On 4 perturbed layers: each layer's ablation score (quality lost
    when its adapter alone is reset) within 1e-5 of JAX's, and the
    post-training search over those scores accepting and refusing the
    same layers, each probe's quality within 1e-5."""
    jcfg, pcfg = _cfgs(n_layers=4)
    jparams = jhad.perturb_adapters(JM.init_params(KEY, jcfg),
                                    jax.random.fold_in(KEY, 5), scale=0.5)
    params = convert.from_jax_params(np_tree(jparams), pcfg, "cpu")
    jq, tq = _quality(jcfg, pcfg, jparams, params, _batches(pcfg, 1)[0])
    want = jimp.ablation_importance(jparams, jcfg, jq)
    got = imp.ablation_importance(params, pcfg, tq)
    assert got.shape == (4,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    budget = float(np.sort(np.abs(want))[1]) * 1.5
    wmask, whist = jprune.search_mask(
        want, lambda m: jq(jimp.apply_layer_mask(jparams, jcfg, m)),
        budget=budget)
    gmask, ghist = prune.search_mask(
        got, lambda m: tq(imp.apply_layer_mask(params, pcfg, m)),
        budget=budget)
    assert gmask.tolist() == wmask.tolist()
    assert [h["accepted"] for h in ghist] == [h["accepted"] for h in whist]
    assert any(h["accepted"] for h in ghist[1:])
    assert not all(h["accepted"] for h in ghist)
    for g, w in zip(ghist, whist):
        assert g["mask"].tolist() == w["mask"].tolist()
        assert abs(g["quality"] - w["quality"]) <= 1e-5


@pytest.mark.parametrize("budget,min_layers", [(0.01, 1), (10.0, 1),
                                               (10.0, 3), (0.0, 1)])
def test_search_mask_is_jaxs_search(budget, min_layers):
    """The numpy search itself, on a quality that every layer's cost
    decides exactly, with tied scores (broken toward dropping shallow
    layers first): the same mask and probes as JAX's."""
    cost = np.array([0.001, 0.05, 0.002, 0.3, 0.002, 0.0])
    scores = np.array([0.1, 0.5, 0.1, 0.9, 0.1, 0.1])

    def quality(mask):
        return 1.0 - float(cost[~np.asarray(mask, bool)].sum())

    wmask, whist = jprune.search_mask(scores, quality, budget=budget,
                                      min_layers=min_layers)
    gmask, ghist = prune.search_mask(scores, quality, budget=budget,
                                     min_layers=min_layers)
    assert gmask.tolist() == wmask.tolist()
    assert len(ghist) == len(whist)
    for g, w in zip(ghist, whist):
        assert g["mask"].tolist() == w["mask"].tolist()
        assert (g["quality"], g["kept"], g["accepted"]) == \
            (w["quality"], w["kept"], w["accepted"])
    with pytest.raises(ValueError, match="min_layers"):
        prune.search_mask(scores, quality, budget=budget, min_layers=0)


def test_ablate_layers_resets_only_the_given_layers():
    jcfg, pcfg = _cfgs(n_layers=3)
    jparams = jhad.perturb_adapters(JM.init_params(KEY, jcfg),
                                    jax.random.fold_in(KEY, 2), scale=0.3)
    params = convert.from_jax_params(np_tree(jparams), pcfg, "cpu")
    got = convert.to_jax_params(imp.ablate_layers(params, pcfg, [0, 2]), pcfg)
    want = jimp.ablate_layers(jparams, jcfg, [0, 2])
    for path, w in jtu.flatten_with_paths(np_tree(want)):
        np.testing.assert_array_equal(dict(jtu.flatten_with_paths(got))[path],
                                      w, err_msg=path)


@pytest.mark.parametrize("arch", ["bert-tiny", "qwen3-0.6b"])
@pytest.mark.parametrize("k", ["-1", "3"])
def test_train_launcher_refuses_a_prune_to_out_of_range(arch, k):
    """JAX's message and exit for a K outside [1, L], on the encoder and
    the decoder branch."""
    from repro_torch.launch import train as launcher

    with pytest.raises(SystemExit, match=r"--prune-to: top_layers must be "
                                         r"in \[1, 2\], got " + k):
        launcher.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--steps", "1", "--prune-to", k])
