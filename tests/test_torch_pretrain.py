"""The port's MLM pretraining (`train/pretrain.py`) against the JAX
package: the masked batches byte for byte, the MLM loss and the gradient
of every leaf under `full`, five pretraining steps, the cache key and the
port's own cache.

JAX makes the bert smoke weights and `convert.from_jax_params` carries
them over; on the CPU every kernel call takes its plain version.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import tree as jtu
from repro.common.types import OptimCfg as JOptimCfg
from repro.configs import get_smoke as jget_smoke
from repro.core import peft as jpeft
from repro.data import synthetic as jdata
from repro.models import model as JM
from repro.train import loop as jloop
from repro.train import pretrain as jpre
from repro.train import steps as jsteps
from repro_torch import convert
from repro_torch.common import tree as tu
from repro_torch.common import types as T
from repro_torch.configs import get_smoke
from repro_torch.core import peft
from repro_torch.data import synthetic as tdata
from repro_torch.train import loop, pretrain, steps
from test_torch_model import np_tree, port_cfg

KEY = jax.random.PRNGKey(0)
B, S = 4, 16


def _cfgs():
    jcfg = jpeft.attach(jget_smoke("bert-base"), jpeft.strategy("full"))
    return jcfg, port_cfg(jcfg)


def _weights(jcfg, pcfg):
    jparams = JM.init_params(KEY, jcfg)
    return jparams, convert.from_jax_params(np_tree(jparams), pcfg, "cpu")


def _batches(n, vocab=503, mask_rate=0.15, seed=0):
    corpus = jdata.lm_corpus(vocab, 20_000, seed=seed)
    return list(jpre.mlm_batches(corpus, n, B, S, mask_rate=mask_rate,
                                 seed=seed))


@pytest.mark.parametrize("mask_rate,seed", [(0.15, 0), (0.4, 3)])
def test_mlm_batches_are_byte_identical_to_jax(mask_rate, seed):
    corpus = tdata.lm_corpus(1000, 5000, seed=seed)
    want = list(jpre.mlm_batches(corpus, 3, 4, 24, mask_rate=mask_rate,
                                 seed=seed))
    got = list(pretrain.mlm_batches(corpus, 3, 4, 24, mask_rate=mask_rate,
                                    seed=seed))
    assert len(got) == len(want) == 3
    for gb, wb in zip(got, want):
        assert set(gb) == set(wb) == {"tokens", "targets", "mask", "type_ids"}
        for k in wb:
            assert gb[k].dtype == wb[k].dtype and gb[k].shape == wb[k].shape
            assert gb[k].tobytes() == wb[k].tobytes(), k
        assert (gb["tokens"][gb["mask"]] == pretrain.MASK_ID).all()
    assert pretrain.MASK_ID == jpre.MASK_ID


def test_mlm_loss_and_every_gradient_match_jax():
    """Under `full` every leaf trains: the embeddings (through the lookup
    and the tied head), every projection and norm. The loss within 1e-5
    relative, each leaf's gradient within 1e-5 of its own max |JAX
    gradient|; the pooler, the classifier and final_norm, which the MLM
    loss never reads, get exact zeros in both packages. A key bias shifts all of a
    query's scores by one amount, which the softmax cancels: its gradient
    is 0 in exact arithmetic, and both packages read rounding noise
    (~1e-12), held under 1e-9."""
    jcfg, pcfg = _cfgs()
    jparams, ported = _weights(jcfg, pcfg)
    batch = _batches(1)[0]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (wl, _), wg = jax.jit(jax.value_and_grad(
        lambda p: jpre.mlm_loss(jcfg, p, jb), has_aux=True))(jparams)
    state = steps.make_state(None, pcfg, peft.strategy("full"), T.OptimCfg(),
                             params=ported)
    gl, metrics, grads = steps.loss_and_grads(
        pcfg, state, loop.to_device(batch, "cpu"), loss_fn=pretrain.mlm_loss)
    assert abs(gl.item() - float(wl)) <= 1e-5 * abs(float(wl))
    assert metrics["mlm_ce"].item() == gl.item()
    assert set(grads) == {p for p, _ in tu.flatten_with_paths(ported)}
    got = dict(jtu.flatten_with_paths(
        convert.to_jax_params(grads_tree(ported, grads), pcfg)))
    want = dict(jtu.flatten_with_paths(np_tree(wg)))
    assert set(got) == set(want)
    for path, w in want.items():
        if path.startswith(("pooler/", "classifier/", "final_norm/")):
            assert not w.any() and not got[path].any(), path
            continue
        if path.endswith("/attn/bk"):
            assert np.abs(w).max() < 1e-9 and np.abs(got[path]).max() < 1e-9
            continue
        assert np.abs(w).max() > 0, path
        np.testing.assert_allclose(got[path], w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=path)


def grads_tree(params, grads):
    return tu.map_with_path(lambda p, _: grads[p], params)


def test_mlm_pretraining_steps_match_jax():
    """5 steps of `build_train_step(loss_fn=mlm_loss)` under `full` from
    one backbone, with pretrain_encoder's warmup: losses within 1e-4
    relative, every leaf within 1e-5 after the last step (AdamW moves an
    element by about lr = 1e-3 a step: 1e-5 is 1 % of a step's update)."""
    jcfg, pcfg = _cfgs()
    jparams, ported = _weights(jcfg, pcfg)
    ocfg = dict(lr=1e-3, total_steps=5, warmup_steps=2)
    jstate = jsteps.make_state(KEY, jcfg, jpeft.strategy("full"),
                               JOptimCfg(**ocfg), params=jparams)
    jstate, jhist = jloop.run_train(
        jstate, jsteps.build_train_step(jcfg, JOptimCfg(**ocfg),
                                        loss_fn=jpre.mlm_loss),
        _batches(5), steps=5, log=lambda m: None)
    state = steps.make_state(None, pcfg, peft.strategy("full"),
                             T.OptimCfg(**ocfg), params=ported)
    state, hist = loop.run_train(
        state, steps.build_train_step(pcfg, T.OptimCfg(**ocfg),
                                      loss_fn=pretrain.mlm_loss),
        _batches(5), steps=5, log=lambda m: None)
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [float(h["loss"]) for h in jhist],
                               rtol=1e-4, atol=0)
    assert hist[-1]["loss"] < hist[0]["loss"]
    want = dict(jtu.flatten_with_paths(np_tree(jsteps.merged_params(jstate))))
    got = dict(jtu.flatten_with_paths(
        convert.to_jax_params(steps.merged_params(state), pcfg)))
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, atol=1e-5, rtol=0,
                                   err_msg=path)


def test_pretrain_tag_is_jaxs_string():
    jcfg, pcfg = _cfgs()
    base = dict(steps=10, batch=4, seq=16, lr=1e-3, mask_rate=0.15, seed=0)
    for over, optim in (({}, None), ({"lr": 2e-3}, None),
                        ({"mask_rate": 0.3, "seed": 1}, None),
                        ({}, ("bfloat16", "int8")), ({}, ("float32",) * 2)):
        kw = dict(base, **over)
        jo = to = None
        if optim is not None:
            jo = JOptimCfg(m_dtype=optim[0], v_dtype=optim[1])
            to = T.OptimCfg(m_dtype=optim[0], v_dtype=optim[1])
        assert pretrain.pretrain_tag(pcfg, optim=to, **kw) == \
            jpre.pretrain_tag(jcfg, optim=jo, **kw)


def test_pretrain_encoder_caches_a_file_per_lr_and_mask_rate(tmp_path):
    """A distinct cache file per lr and mask_rate (the key holds every
    knob of the trajectory); a second call with the same knobs reads the
    file, writes none, and gives the trained parameters back."""
    _, pcfg = _cfgs()
    kw = dict(steps=2, batch=2, seq=8, cache_dir=str(tmp_path),
              log=lambda *_: None, device="cpu")
    trained = pretrain.pretrain_encoder(pcfg, lr=1e-3, **kw)
    pretrain.pretrain_encoder(pcfg, lr=2e-3, **kw)
    pretrain.pretrain_encoder(pcfg, lr=1e-3, mask_rate=0.4, **kw)
    assert len(os.listdir(tmp_path)) == 3
    cached = pretrain.pretrain_encoder(pcfg, lr=1e-3, **kw)
    assert len(os.listdir(tmp_path)) == 3
    want = dict(tu.flatten_with_paths(trained))
    got = dict(tu.flatten_with_paths(cached))
    assert set(got) == set(want)
    assert all(torch.equal(got[p], want[p]) for p in want)
    # the same knobs in an empty cache train again, to the same bits
    fresh = dict(tu.flatten_with_paths(pretrain.pretrain_encoder(
        pcfg, lr=1e-3, **dict(kw, cache_dir=str(tmp_path / "other")))))
    assert all(torch.equal(fresh[p], want[p]) for p in want)
