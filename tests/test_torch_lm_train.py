"""The port's decoder-LM fine-tuning against the JAX package: the LM
corpus, the LM losses, the train step (plain, gradient accumulation, over
an int8 trunk, in bf16), calibration and the clip search, checkpointed
resume, QPEFT's refusals, the launcher's decoder branch and the
full-width trainable count.

Both packages start from the same JAX-made qwen3 smoke weights (fp32,
adapters moved off the identity by `perturb_adapters`, carried over by
`convert.from_jax_params`) and the same `lm_batches`, and run on the CPU,
where the port's kernel calls take their plain versions.
"""
import dataclasses
import re

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
from repro.quant.calibrate import calibrate as jcalibrate
from repro.quant import qtensor as jq
from repro.train import loop as jloop
from repro.train import losses as jlosses
from repro.train import steps as jsteps
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.common import tree as tu
from repro_torch.common import types as T
from repro_torch.core import peft
from repro_torch.data import synthetic as tdata
from repro_torch.launch import train as launcher
from repro_torch.models import model as M
from repro_torch.quant.calibrate import (calibrate, collect_stats,
                                          collecting)
from repro_torch.quant import qtensor as tq
from repro_torch.train import loop, losses, steps
from test_torch_model import np_tree, port_cfg

KEY = jax.random.PRNGKey(0)
B, S, STEPS, LR = 4, 16, 5, 3e-3
CORPUS = jdata.lm_corpus(503, 20_000, seed=0)


def _cfgs(sname="hadamard", **over):
    jcfg = jpeft.attach(jget_smoke("qwen3-0.6b"), jpeft.strategy(sname))
    jcfg = dataclasses.replace(jcfg, **over)
    return jcfg, port_cfg(jcfg)


def _weights(jcfg, pcfg):
    jparams = jhad.perturb_adapters(JM.init_params(KEY, jcfg),
                                    jax.random.fold_in(KEY, 1), scale=0.2)
    return jparams, convert.from_jax_params(np_tree(jparams), pcfg, "cpu")


def _batches(n, seed=0):
    return list(jdata.lm_batches(CORPUS, n, B, S, seed=seed))


def _tensors(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _trained_leaves(jstate, pcfg, state):
    """(JAX, port) numpy arrays of every trainable leaf, by JAX path."""
    want = dict(jtu.flatten_with_paths(jstate["trainable"]))
    got = {}
    for path, t in state["trainable"].items():
        got.setdefault(convert.jax_path(path, pcfg), []).append(
            convert.to_numpy(t))
    return want, {p: np.stack(v) for p, v in got.items()}


# ---------------------------------------------------------------------------
# data and losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", [2, 3])
def test_lm_corpus_and_batches_are_byte_identical_to_jax(order):
    want = jdata.lm_corpus(1000, 5000, seed=3, order=order)
    got = tdata.lm_corpus(1000, 5000, seed=3, order=order)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    for gb, wb in zip(tdata.lm_batches(got, 3, 4, 24, seed=1),
                      jdata.lm_batches(want, 3, 4, 24, seed=1)):
        assert set(gb) == set(wb) == {"tokens", "labels"}
        assert all(gb[k].dtype == wb[k].dtype
                   and gb[k].tobytes() == wb[k].tobytes() for k in wb)


@pytest.mark.parametrize("chunk", [0, 5, 16])
def test_lm_loss_and_its_gradients_match_jax(chunk):
    """chunk 5 pads the 16 positions to 20 with ignored labels; 16 is one
    chunk. Loss within 1e-5 relative, each trainable gradient within 1e-5
    of its max |JAX gradient|."""
    jcfg, pcfg = _cfgs(ce_chunk=chunk)
    jparams, ported = _weights(jcfg, pcfg)
    batch = _batches(1)[0]
    strat = jpeft.strategy("hadamard")
    jtr, jfr = jtu.partition(jparams, jpeft.trainable_mask(jparams, strat))

    def jloss(tr):
        return jlosses.lm_loss(jcfg, jtu.merge(tr, jfr),
                               {k: jnp.asarray(v) for k, v in batch.items()})

    (wl, _), wg = jax.value_and_grad(jloss, has_aux=True)(jtr)
    state = steps.make_state(None, pcfg, peft.strategy("hadamard"),
                             T.OptimCfg(), params=ported)
    gl, metrics, gg = steps.loss_and_grads(pcfg, state, _tensors(batch))
    assert abs(gl.item() - float(wl)) <= 1e-5 * abs(float(wl))
    assert float(metrics["aux"]) == 0.0
    want = dict(jtu.flatten_with_paths(wg))
    got = {}
    for path, g in gg.items():
        got.setdefault(convert.jax_path(path, pcfg), []).append(g.numpy())
    assert set(got) == {p for p, v in want.items() if v is not None}
    for path, g in got.items():
        w = np.asarray(want[path])
        np.testing.assert_allclose(np.stack(g), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=path)


def test_chunked_cross_entropy_equals_the_whole_one():
    """The port's chunked CE (padded, recomputed in the backward) against
    its unchunked CE on the same states: loss and the states' gradient
    within 1e-5 relative."""
    _, pcfg = _cfgs()
    _, ported = _weights(*_cfgs())
    batch = _tensors(_batches(1)[0])
    with torch.no_grad():
        h0 = M.forward_hidden(ported, pcfg, batch["tokens"])
    out = []
    for chunk in (0, 3, 7, 16):
        h = h0.clone().requires_grad_(True)
        loss = (losses.chunked_cross_entropy(pcfg, ported, h, batch["labels"],
                                             chunk) if chunk else
                losses.cross_entropy(M.lm_logits(ported, pcfg, h),
                                     batch["labels"]))
        loss.backward()
        out.append((loss.item(), h.grad))
    for loss, grad in out[1:]:
        assert abs(loss - out[0][0]) <= 1e-5 * abs(out[0][0])
        assert (grad - out[0][1]).abs().max() <= 1e-5 * out[0][1].abs().max()


def _ce_gradient_readings(g, ref):
    """The two readings of chip_smoke's phase 7d chunked-CE check: the
    gradient as one vector, |g - ref| / |ref|, and the worst leaf's
    max|g - ref| over its max|ref|."""
    sq_d = sum((g[p] - ref[p]).double().square().sum().item() for p in ref)
    sq_r = sum(ref[p].double().square().sum().item() for p in ref)
    leaf = max((g[p] - ref[p]).abs().max().item() / ref[p].abs().max().item()
               for p in ref)
    return (sq_d / sq_r) ** 0.5, leaf


def test_chunked_ce_leaf_check_sees_a_fault_the_loss_hides(monkeypatch):
    """Phase 7d holds the chunked CE's gradient to the whole CE's as one
    vector (1e-5) and leaf by leaf (1e-4). The sound chunked CE is within
    both; a planted fault, the chunks' logits rounded to bf16, moves the
    loss by less than 1e-5 relative yet reads above 1e-4 on its worst
    leaf, so the leaf check catches what the loss check cannot."""
    _, pcfg = _cfgs()
    _, ported = _weights(*_cfgs())
    batch = _tensors(_batches(1)[0])

    def grads(cfg):
        state = steps.make_state(None, cfg, peft.strategy("hadamard"),
                                 T.OptimCfg(), params=ported)
        loss, _, g = steps.loss_and_grads(cfg, state, batch)
        return loss.item(), g

    chunked = dataclasses.replace(pcfg, ce_chunk=5)
    loss_u, g_u = grads(pcfg)
    loss_c, g_c = grads(chunked)
    vec, leaf = _ce_gradient_readings(g_c, g_u)
    assert abs(loss_c - loss_u) <= 1e-5 * abs(loss_u)
    assert vec <= 1e-5 and leaf <= 1e-4, (vec, leaf)
    logits = M.lm_logits
    monkeypatch.setattr(M, "lm_logits", lambda *a, **k: logits(
        *a, **k).to(torch.bfloat16).float())
    loss_f, g_f = grads(chunked)
    vec_f, leaf_f = _ce_gradient_readings(g_f, g_u)
    print(f"sound: vector {vec:.3g}, worst leaf {leaf:.3g}; bf16 chunks: "
          f"loss rel {abs(loss_f - loss_u) / abs(loss_u):.3g}, vector "
          f"{vec_f:.3g}, worst leaf {leaf_f:.3g}")
    assert abs(loss_f - loss_u) <= 1e-5 * abs(loss_u)
    assert leaf_f > 1e-4, leaf_f


# ---------------------------------------------------------------------------
# training against JAX
# ---------------------------------------------------------------------------


def _train_both(sname="hadamard", microbatch=0, quant=None, steps_=STEPS,
                **over):
    jcfg, pcfg = _cfgs(sname, **over)
    jparams, ported = _weights(jcfg, pcfg)
    ocfg = dict(lr=LR, total_steps=steps_)
    jstate = jsteps.make_state(KEY, jcfg, jpeft.strategy(sname),
                               JOptimCfg(**ocfg), params=jparams, quant=quant)
    jstate, jhist = jloop.run_train(
        jstate, jsteps.build_train_step(jcfg, JOptimCfg(**ocfg),
                                        microbatch=microbatch),
        _batches(steps_), steps=steps_, log=lambda m: None)
    state = steps.make_state(None, pcfg, peft.strategy(sname),
                             T.OptimCfg(**ocfg), params=ported, quant=quant)
    state, hist = loop.run_train(
        state, steps.build_train_step(pcfg, T.OptimCfg(**ocfg),
                                      microbatch=microbatch),
        _batches(steps_), steps=steps_, log=lambda m: None)
    return (jstate, [float(h["loss"]) for h in jhist], state,
            [h["loss"] for h in hist], pcfg)


@pytest.mark.parametrize("sname,microbatch,quant", [
    ("hadamard", 0, None), ("hadamard_concat", 0, None),
    ("hadamard", 2, None), ("hadamard", 0, "int8")])
def test_lm_fine_tuning_matches_jax(sname, microbatch, quant):
    """5 steps from one backbone. As in test_torch_train: per-step losses
    within 1e-4 relative, each trained leaf within 1e-5 after the last
    step (one AdamW step moves an element by about lr = 3e-3, so 1e-5 is a
    difference of ~3e-3 in an update: far above fp32 noise, far below one
    flipped sign)."""
    jstate, jl, state, pl, pcfg = _train_both(sname, microbatch, quant)
    np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=0)
    want, got = _trained_leaves(jstate, pcfg, state)
    assert set(got) == {p for p, v in want.items() if v is not None}
    assert len(got) == 3  # adapter w, b and the ffn norm scale
    for path, g in got.items():
        np.testing.assert_allclose(g, np.asarray(want[path]), atol=1e-5,
                                   rtol=0, err_msg=path)
    assert state["step"] == int(jstate["step"]) == STEPS
    if quant:
        # the quantized trunk, leaf by leaf as JAX stacks it, and the
        # launcher's byte accounting
        name = {p: convert.jax_path(p, pcfg) for p, _ in
                tu.flatten_with_paths(state["params"])}
        qs = tq.quant_summary(state["params"], leaf_name=name.get)
        jqs = jq.quant_summary(jstate["frozen"])
        assert {k: qs[k] for k in ("n_quantized_leaves", "quantized_bytes",
                                   "dense_bytes_fp32")} == \
            {k: jqs[k] for k in ("n_quantized_leaves", "quantized_bytes",
                                 "dense_bytes_fp32")}
        assert qs["n_quantized_leaves"] == 7


def test_bf16_lm_fine_tuning_tracks_jax():
    """The same run in bf16 (qwen3-0.6b's own dtypes): losses within 2e-2
    relative a step. Not tighter, because the two packages round in
    different places: JAX rounds the adapter's output and then the
    residual add to bf16, the fused seam (#3 and its plain version) adds
    in fp32 and rounds once; and bf16 matmuls sum in another order. The
    trained leaves keep their dtypes: adapter w/b fp32, the norm scale
    bf16, updated in fp32 and rounded once, as JAX's AdamW does.

    The loss barely moves in 5 steps, so the trained leaves are held to
    JAX's too. Readings (CPU, this run): the adapter's w and b differ from
    JAX's by at most 2.7e-4 and the norm scale by one bf16 step (2^-8 in
    [0.5, 1)), while leaves left at their start differ from JAX's by
    1.08e-2 (adapter) and 1.17e-2 (scale); 2e-3 and 4e-3 sit between. 48 %
    of the scale's elements move from their start; a step whose update of
    the bf16 scale rounds away moves none."""
    over = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jstate, jl, state, pl, pcfg = _train_both(**over)
    assert all(np.isfinite(pl))
    np.testing.assert_allclose(pl, jl, rtol=2e-2, atol=0)
    dtypes = {convert.jax_path(p, pcfg): t.dtype
              for p, t in state["trainable"].items()}
    assert dtypes == {"blocks/g0/slot0/adapter/w": torch.float32,
                      "blocks/g0/slot0/adapter/b": torch.float32,
                      "blocks/g0/slot0/ffn_norm/scale": torch.bfloat16}
    want = dict(jtu.flatten_with_paths(jstate["trainable"]))
    assert {p: str(v.dtype) for p, v in want.items() if v is not None} == {
        "blocks/g0/slot0/adapter/w": "float32",
        "blocks/g0/slot0/adapter/b": "float32",
        "blocks/g0/slot0/ffn_norm/scale": "bfloat16"}
    start = dict(tu.flatten_with_paths(_weights(*_cfgs(**over))[1]))
    first = {}
    for path in state["trainable"]:
        first.setdefault(convert.jax_path(path, pcfg), []).append(
            convert.to_numpy(start[path]).astype(np.float32))
    want, got = _trained_leaves(jstate, pcfg, state)
    for path, g in got.items():
        g = g.astype(np.float32)
        w = np.asarray(want[path]).astype(np.float32)
        atol = 4e-3 if path.endswith("ffn_norm/scale") else 2e-3
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=path)
    scale = "blocks/g0/slot0/ffn_norm/scale"
    moved = (got[scale].astype(np.float32) != np.stack(first[scale])).mean()
    assert moved >= 0.25, f"{moved:.0%} of the bf16 norm scale moved"


def test_decoder_eval_step_matches_jax():
    jcfg, pcfg = _cfgs()
    jparams, ported = _weights(jcfg, pcfg)
    batch = _batches(1)[0]
    want = jsteps.build_eval_step(jcfg)(jparams,
                                        {"tokens": jnp.asarray(batch["tokens"])})
    got = steps.build_eval_step(pcfg)(ported, _tensors(batch))
    assert got.shape == (B, S)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# calibration and the clip search
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_calibration_and_clip_search_match_jax(mode):
    """Per-tag statistics within 1e-5 relative; the clip JAX picks for
    each stacked leaf equal to the port's over the leaf's layers; the
    quantized trunk byte for byte JAX's quantize_tree(stats=)."""
    jcfg, pcfg = _cfgs()
    jparams, _ = _weights(jcfg, pcfg)
    # input channel 0 of q, k and v: the data barely drives it (its norm
    # scale is 1e-3) and its weights are outliers (0.5, where the rest are
    # ~0.02), so clipping it costs little and buys int8 resolution
    blk = jparams["blocks"]["g0"]["slot0"]
    blk["attn_norm"]["scale"] = blk["attn_norm"]["scale"].at[:, 0].set(1e-3)
    for w in ("wq", "wk", "wv"):
        blk["attn"][w] = blk["attn"][w].at[:, 0, :].set(0.5)
    ported = convert.from_jax_params(np_tree(jparams), pcfg, "cpu")
    cal = _batches(2, seed=1)
    jstats = jcalibrate(jcfg, jparams, iter(cal), max_batches=2)
    pstats = calibrate(pcfg, ported, iter(cal), max_batches=2)
    assert set(pstats) == set(jstats) == {
        "attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/wi", "mlp/wg",
        "mlp/wo"}
    for tag, w in jstats.items():
        assert pstats[tag].dtype == np.float32 and pstats[tag].shape == w.shape
        np.testing.assert_allclose(pstats[tag], w, rtol=1e-5, atol=0,
                                   err_msg=tag)
    name = lambda p: convert.jax_path(p, pcfg)
    stacked = {}
    for path, leaf in tu.flatten_with_paths(ported):
        if tq.quantizable(path) and isinstance(leaf, torch.Tensor):
            stacked.setdefault(name(path), []).append(leaf)
    clips = set()
    for jpath, leaves in stacked.items():
        jleaf = dict(jtu.flatten_with_paths(jparams))[jpath]
        tag = tq.tag_of(jpath)
        want = jq._best_clip(jleaf, mode, jstats[tag])
        assert tq._best_clip(torch.stack(leaves), mode, pstats[tag]) == want
        clips.add(want)
    if mode == "int8":
        assert min(clips) < 1.0, "no leaf took a clip below 1: idle search"
    got = tq.quantize_tree(ported, mode, stats=pstats, cfg=pcfg)
    jqt = jq.quantize_tree(jparams, mode, stats=jstats)
    back = dict(jtu.flatten_with_paths(convert.to_jax_params(got, pcfg)))
    jflat = {jtu.path_str(p): v for p, v in
             jax.tree_util.tree_flatten_with_path(jqt)[0]}
    assert {p for p in jflat if p.endswith("/values")} == \
        {p for p in back if p.endswith("/values")} and len(back) == len(jflat)
    for path, v in jflat.items():
        a = np.asarray(v)
        assert back[path].dtype == a.dtype, path
        assert back[path].tobytes() == a.tobytes(), path
    with pytest.raises(ValueError, match="needs the model's cfg"):
        tq.quantize_tree(ported, mode, stats=pstats)


def test_calibration_forward_changes_nothing_and_collects_only_inside():
    _, pcfg = _cfgs()
    _, ported = _weights(*_cfgs())
    tokens = _tensors(_batches(1)[0])["tokens"]
    plain = M.forward_lm(ported, pcfg, tokens)
    with collect_stats() as col:
        assert collecting()
        with pytest.raises(RuntimeError, match="already active"):
            collect_stats().__enter__()
        seen = M.forward_lm(ported, pcfg, tokens)
    assert not collecting()
    assert torch.equal(plain, seen)
    stats = col.result()
    assert set(stats) == {"attn/wq", "attn/wk", "attn/wv", "attn/wo",
                          "mlp/wi", "mlp/wg", "mlp/wo"}
    assert stats["attn/wq"].shape == (pcfg.d_model,)
    assert stats["mlp/wo"].shape == (pcfg.d_ff,)
    # a mean over every call: the same batch twice gives the same mean
    with collect_stats() as col:
        for _ in range(2):
            M.forward_lm(ported, pcfg, tokens)
    for tag, v in col.result().items():
        np.testing.assert_allclose(v, stats[tag], rtol=1e-6, err_msg=tag)


# ---------------------------------------------------------------------------
# checkpointed resume, QPEFT's refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", [None, "int8"])
def test_resumed_run_equals_the_unbroken_one_bit_for_bit(tmp_path, quant):
    """6 steps saving at steps 3 and 6; then a fresh state (same weights)
    restored from step 3 runs steps 4-6 on the same batches."""
    _, pcfg = _cfgs()
    _, ported = _weights(*_cfgs())
    ocfg = T.OptimCfg(lr=LR, total_steps=6)
    strat = peft.strategy("hadamard")
    step = steps.build_train_step(pcfg, ocfg)
    mgr = CheckpointManager(str(tmp_path), keep=3)
    state = steps.make_state(None, pcfg, strat, ocfg, params=ported,
                             quant=quant)
    state, whole = loop.run_train(state, step, _batches(6), steps=6,
                                  manager=mgr, save_every=3, log=lambda m: None)
    assert mgr.steps() == [3, 6]
    again = steps.make_state(None, pcfg, strat, ocfg, params=ported,
                             quant=quant)
    restored, meta = mgr.restore(3)
    assert meta["step"] == 3
    assert set(restored) == {"step", "trainable", "opt"}
    steps.restore_state(again, restored)
    assert again["step"] == 3 and again["opt"]["count"] == 3
    again, rest = loop.run_train(again, step, _batches(6)[3:], steps=3,
                                 log=lambda m: None)
    assert [h["loss"] for h in rest] == [h["loss"] for h in whole[3:]]
    for path, t in state["trainable"].items():
        assert torch.equal(again["trainable"][path], t), path
    for k in ("m", "v"):
        for path, t in state["opt"][k].items():
            assert torch.equal(again["opt"][k][path], t), path


def test_resume_refuses_a_checkpoint_of_another_train_state(tmp_path):
    """A checkpoint that lacks one of the state's leaves, holds one more,
    or holds one at another shape raises, and the state is left as it
    was: resuming at its step with fresh adapters would be a wrong run."""
    _, pcfg = _cfgs()
    _, ported = _weights(*_cfgs())
    strat, ocfg = peft.strategy("hadamard"), T.OptimCfg(lr=LR)
    state = steps.make_state(None, pcfg, strat, ocfg, params=ported)
    state, _ = loop.run_train(state, steps.build_train_step(pcfg, ocfg),
                              _batches(1), steps=1, log=lambda m: None)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, steps.state_tree(state))
    good, _ = mgr.restore()
    # the same tree by flat path (restore_state reads either)
    flat = dict(tu.flatten_with_paths(good))
    leaf = "trainable/layers/0/adapter/w"
    lacking = {k: v for k, v in flat.items() if k != leaf}
    more = {**flat, "trainable/layers/0/adapter/extra": torch.zeros(2)}
    wrong = {**flat, leaf: torch.zeros(1)}
    fresh = steps.make_state(None, pcfg, strat, ocfg, params=ported)
    before = {k: t.clone() for k, t in fresh["trainable"].items()}
    for bad, match in ((lacking, "1 of its paths missing"),
                       (more, "1 paths not in it"), (wrong, "shapes differ")):
        with pytest.raises(ValueError, match=match):
            steps.restore_state(fresh, bad)
        assert fresh["step"] == 0 and fresh["opt"]["count"] == 0
        assert all(torch.equal(t, before[k])
                   for k, t in fresh["trainable"].items())
    steps.restore_state(fresh, good)
    assert fresh["step"] == 1
    assert all(torch.equal(t, state["trainable"][k])
               for k, t in fresh["trainable"].items())


def test_resume_refuses_a_state_directory_the_jax_trainer_wrote(tmp_path):
    """JAX's train state (its layers stacked, `frozen` beside `trainable`)
    in JAX's own step directory: the port's launcher reads the file but
    refuses to resume from it, naming the checkpoint-interop slice, rather
    than resuming at its step with fresh adapters."""
    from repro.checkpoint.store import save_tree as jsave_tree

    jcfg, _ = _cfgs()
    jstate = jsteps.make_state(KEY, jcfg, jpeft.strategy("hadamard"),
                               JOptimCfg(lr=LR))
    d = tmp_path / "step_0000000003"
    d.mkdir()
    # uncompressed, so the port reads it (a zstd frame is refused earlier)
    jsave_tree(str(d / "state.ckpt"), jax.device_get(jstate), compress=False,
               metadata={"step": 3})
    restored, meta = CheckpointManager(str(tmp_path)).restore()
    assert meta["step"] == 3 and "trainable" in restored
    with pytest.raises(ValueError, match="checkpoint-interop slice"):
        launcher.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                       "--steps", "1", "--batch", "2", "--seq", "8",
                       "--ckpt-dir", str(tmp_path), "--resume"])


def test_restore_into_casts_to_the_skeleton_by_path():
    from repro_torch.checkpoint import restore_into

    skel = {"a": {"w": torch.zeros(3, dtype=torch.bfloat16)},
            "b": torch.ones(2), "n": None}
    got = restore_into(skel, {"a": {"w": torch.tensor([1.5, 2.0, 3.0],
                                                      dtype=torch.float64)},
                              "extra": torch.zeros(1)})
    assert got["a"]["w"].dtype == torch.bfloat16
    assert got["a"]["w"].tolist() == [1.5, 2.0, 3.0]
    assert got["b"] is skel["b"] and got["n"] is None and "extra" not in got


def test_qpeft_make_state_raises_as_jax_raises():
    jcfg, pcfg = _cfgs("full")
    jparams, ported = _weights(jcfg, pcfg)
    for make, params, strat, ocfg, qt in (
            (jsteps.make_state, jparams, jpeft.strategy("full"), JOptimCfg(),
             jq.quantize_tree),
            (steps.make_state, ported, peft.strategy("full"), T.OptimCfg(),
             tq.quantize_tree)):
        key = KEY if make is jsteps.make_state else None
        with pytest.raises(ValueError, match="quantized nothing"):
            make(key, jcfg if key is not None else pcfg, strat, ocfg,
                 params=params, quant="int8")
        with pytest.raises(ValueError, match="trainable subtree contains "
                                             "quantized leaves"):
            make(key, jcfg if key is not None else pcfg, strat, ocfg,
                 params=qt(params, "int8"), quant="int8")


# ---------------------------------------------------------------------------
# the launcher's decoder branch; the full-width count
# ---------------------------------------------------------------------------


def test_train_launcher_trains_a_decoder_on_the_cpu(capsys, tmp_path):
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--steps",
            "4", "--batch", "4", "--seq", "16", "--quant", "int8",
            "--calibrate-batches", "1", "--ckpt-dir", str(tmp_path),
            "--save-every", "2"]
    launcher.main(argv)
    out = capsys.readouterr().out
    assert "calibrated 7 call sites over 1 batches" in out
    assert re.search(r"quantized trunk: 7 leaves, [\d.]+ MiB fp32 -> [\d.]+ "
                     r"MiB \([\d.]+x\)", out)
    assert out.strip().splitlines()[-1].startswith("final loss: ")
    launcher.main(argv + ["--resume"])
    assert "resumed from step 4" in capsys.readouterr().out


@pytest.mark.parametrize("argv,exc,match", [
    # gated training is ported: it runs and prints JAX's line (exc None)
    pytest.param(["--arch", "qwen3-0.6b", "--prune-to", "1"], None,
                 "pruned training: top 1/2 layers' adapters unfrozen",
                 id="argv0-NotImplementedError-sparse"),
    (["--arch", "qwen3-0.6b", "--mesh", "2x4"], NotImplementedError,
     "distributed"),
    # gradient compression and rwkv6 training are ported: they run
    pytest.param(["--arch", "qwen3-0.6b", "--compress-grads"], None,
                 "final loss: ",
                 id="argv2-NotImplementedError-optimizer-state"),
    pytest.param(["--arch", "rwkv6-1.6b"], None, "final loss: ",
                 id="argv3-NotImplementedError-WKV6"),
    (["--arch", "bert-tiny", "--quant", "int8"], SystemExit, "decoder-LM"),
])
def test_train_launcher_refuses_what_it_does_not_train(argv, exc, match,
                                                       capsys):
    argv = argv + ["--smoke", "--device", "cpu", "--steps", "1"]
    if exc is None:
        launcher.main(argv + ["--batch", "2", "--seq", "8"])
        out = capsys.readouterr().out
        assert match in out
        assert out.strip().splitlines()[-1].startswith("final loss: ")
        return
    with pytest.raises(exc, match=match):
        launcher.main(argv)


def test_full_width_qwen3_trainable_count_matches_jax_and_chip_smoke():
    import chip_smoke

    jcfg = jpeft.attach(jget("qwen3-0.6b"), jpeft.strategy("hadamard"))
    shapes = jax.eval_shape(lambda k: JM.init_params(k, jcfg), KEY)
    mask = jpeft.trainable_mask(shapes, jpeft.strategy("hadamard"))
    leaves = jax.tree.leaves(shapes)
    total = sum(int(np.prod(v.shape)) for v in leaves)
    trainable = sum(int(np.prod(v.shape)) for v, m in zip(
        leaves, jax.tree.leaves(mask)) if m)
    assert (trainable, total) == (86_016, 596_107_264)
    assert chip_smoke.QWEN3_TRAINABLE == (trainable, total)
    pcfg = peft.attach(T.ModelCfg(**{
        f.name: getattr(port_cfg(jcfg), f.name)
        for f in dataclasses.fields(T.ModelCfg)}), peft.strategy("hadamard"))
    with torch.device("meta"):
        params = M.init_params(None, pcfg)
    stats = peft.param_stats(params, peft.trainable_mask(
        params, peft.strategy("hadamard"), 2, cfg=pcfg))
    assert (stats["trainable"], stats["total"]) == (trainable, total)
