"""The VLM family (internvl2) and learned decoder positions: the port
against the JAX package.

internvl2-76b's smoke config (d 64, 2 layers, 4 image tokens) under the
Hadamard adapter, JAX-made weights perturbed and sharpened as in
`test_torch_encdec.py`, carried into the port by `convert`. The patches
(B, 4, d) go through `vlm_proj` ahead of the text, and RoPE positions run
over both: `forward_lm` with patches within 1e-4 of JAX's, `prefill_lm`
(with a `last_pos` into the text) and greedy decode after it token for
token, `lm_loss` over the text positions alone, whole and chunked, within
1e-5 with its adapter gradients, one train step and the eval step with
patches, the trainable counts and `quant_summary` of an int8 tree
(`vlm_proj` quantized) equal to JAX's. A decoder with `pos="learned"`
embeds its prompt at positions 0..S-1, as JAX's `_decoder_embed` does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro.common.types import OptimCfg as JOptimCfg
from repro.configs import get as jax_get
from repro.configs import get_smoke as jax_get_smoke
from repro.core import peft as jpeft
from repro.models import model as JM
from repro.quant import qtensor as jq
from repro.train import losses as jlosses
from repro.train import steps as jsteps
from repro_torch import convert
from repro_torch.common import tree as tu
from repro_torch.common.types import OptimCfg
from repro_torch.configs import get, get_smoke
from repro_torch.core import peft
from repro_torch.models import model as M
from repro_torch.quant import qtensor
from repro_torch.train import losses, steps
from test_torch_encdec import t, tu_flat, world
from test_torch_model import KEY, port_cfg

ARCH = "internvl2-76b"
B, S_TXT, CACHE = 2, 8, 32


@pytest.fixture(scope="module")
def vl():
    jcfg = jpeft.attach(jax_get_smoke(ARCH), jpeft.strategy("hadamard"))
    jp, pp, pcfg = world(jcfg)
    rs = np.random.RandomState(13)
    patches = rs.standard_normal((B, pcfg.n_image_tokens, pcfg.d_model)
                                 ).astype(np.float32)
    tokens = rs.randint(0, pcfg.vocab_size, (B, S_TXT)).astype(np.int32)
    return dict(jcfg=jcfg, jp=jp, pp=pp, pcfg=pcfg, patches=patches,
                tokens=tokens)


def test_internvl2_configs_match_jax_field_for_field():
    for jcfg, pcfg in ((jax_get(ARCH), get(ARCH)),
                       (jax_get_smoke(ARCH), get_smoke(ARCH))):
        assert dataclasses.asdict(port_cfg(jcfg)) == dataclasses.asdict(pcfg)
    assert get(ARCH).family == "vlm" and get(ARCH).n_image_tokens == 256


def test_full_size_parameter_count_is_jax():
    """70,622,126,080 with Hadamard adapters (855,670,784 a layer; the
    embedding, head, vlm_proj and final norm 2,168,463,360), JAX's count
    by shapes, on device="meta"."""
    pcfg = peft.attach(get(ARCH), peft.strategy("hadamard"))
    with torch.device("meta"):
        params = M.init_params(None, pcfg)
    jcfg = jpeft.attach(jax_get(ARCH), jpeft.strategy("hadamard"))
    shapes = jax.eval_shape(lambda: JM.init_params(KEY, jcfg))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert tu.count_params(params) == want == 70_622_126_080
    assert tu.count_params(params["layers"][0]) == 855_670_784
    top = {k: v for k, v in params.items() if k != "layers"}
    assert tu.count_params(top) == 2_168_463_360
    assert params["vlm_proj"]["kernel"].shape == (8192, 8192)


def test_forward_lm_with_patches_matches_jax(vl):
    want, _ = JM.forward_lm(vl["jp"], vl["jcfg"], jnp.asarray(vl["tokens"]),
                            patches=jnp.asarray(vl["patches"]))
    got = M.forward_lm(vl["pp"], vl["pcfg"], t(vl["tokens"]),
                       patches=t(vl["patches"]))
    n = vl["pcfg"].n_image_tokens
    assert got.shape == (B, n + S_TXT, vl["pcfg"].vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    # the text sees the image: another patch moves the text's logits
    moved = vl["patches"].copy()
    moved[0, 0] += 1.0
    other = M.forward_lm(vl["pp"], vl["pcfg"], t(vl["tokens"]),
                         patches=t(moved))
    assert float((other[0, n:] - got[0, n:]).abs().max()) > 1e-3


def test_rope_positions_run_over_image_and_text(vl):
    """RoPE positions 0..n_img+S-1 over the concatenation: text whose
    positions restart at 0 after the image rows (4iv's planted fault)
    gives other logits."""
    pcfg = vl["pcfg"]
    x = M._decoder_embed(vl["pp"], pcfg, t(vl["tokens"]), t(vl["patches"]))
    n = pcfg.n_image_tokens
    right = torch.arange(n + S_TXT)
    wrong = torch.cat([torch.arange(n), torch.arange(S_TXT)])
    a, _, _ = M._run_layers(vl["pp"], pcfg, x, q_pos=right)
    b, _, _ = M._run_layers(vl["pp"], pcfg, x, q_pos=wrong)
    assert float((a[:, n:] - b[:, n:]).abs().max()) > 1e-3


def test_prefill_with_patches_and_greedy_decode_match_jax(vl):
    """prefill_lm with patches (and a last_pos into the text), then 6
    greedy decode_lm steps at positions n_img + S onward: logits within
    1e-4 and every token JAX's."""
    jcfg, pcfg = vl["jcfg"], vl["pcfg"]
    n = pcfg.n_image_tokens
    lp = n + S_TXT - 3
    want, _ = JM.prefill_lm(vl["jp"], jcfg, jnp.asarray(vl["tokens"]),
                            cache_len=CACHE, patches=jnp.asarray(
                                vl["patches"]), last_pos=lp)
    got, _ = M.prefill_lm(vl["pp"], pcfg, t(vl["tokens"]), CACHE,
                          last_pos=lp, patches=t(vl["patches"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    want, jc = JM.prefill_lm(vl["jp"], jcfg, jnp.asarray(vl["tokens"]),
                             cache_len=CACHE,
                             patches=jnp.asarray(vl["patches"]))
    got, pc = M.prefill_lm(vl["pp"], pcfg, t(vl["tokens"]), CACHE,
                           patches=t(vl["patches"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    assert pc[0]["k"].shape[1] == CACHE
    jdec = jax.jit(JM.decode_lm, static_argnums=1)
    tok_j = np.asarray(want).argmax(-1).astype(np.int32)
    tok_p = got.argmax(-1)
    for step in range(6):
        assert np.array_equal(tok_p.numpy(), tok_j)
        pos = np.full((B,), n + S_TXT + step, np.int32)
        want, jc = jdec(vl["jp"], jcfg, jc, jnp.asarray(tok_j),
                        jnp.asarray(pos))
        got, pc = M.decode_lm(vl["pp"], pcfg, pc, tok_p, torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)
        tok_j = np.asarray(want).argmax(-1).astype(np.int32)
        tok_p = got.argmax(-1)
    assert np.array_equal(tok_p.numpy(), tok_j)


@pytest.mark.parametrize("ce_chunk", [0, 3])
def test_lm_loss_over_text_positions_matches_jax(vl, ce_chunk):
    """lm_loss reads the last S positions (the text's) alone, whole and in
    3-token chunks: loss within 1e-5 and every adapter gradient within 1e-5
    of max|ref| of jax.grad."""
    jcfg = vl["jcfg"].replace(ce_chunk=ce_chunk)
    pcfg = vl["pcfg"].replace(ce_chunk=ce_chunk)
    labels = np.roll(vl["tokens"], -1, axis=1)
    labels[:, -1] = -100
    jb = {"tokens": jnp.asarray(vl["tokens"]), "labels": jnp.asarray(labels),
          "patches": jnp.asarray(vl["patches"])}

    def jloss(params):
        return jlosses.lm_loss(jcfg, params, jb)[0]

    want_l, want_g = jax.value_and_grad(jloss)(vl["jp"])
    pp = tu.map_with_path(lambda _, x: x.clone(), vl["pp"])
    leaves = {p: x.requires_grad_(True) for p, x in tu.flatten_with_paths(pp)
              if "/adapter/" in p}
    loss, _ = losses.loss_for(pcfg)(pcfg, pp, {k: t(v) for k, v in
                                               jb.items()})
    np.testing.assert_allclose(loss.item(), float(want_l), atol=1e-5, rtol=0)
    want = dict(tu_flat(want_g))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for (path, _), g in zip(leaves.items(), grads):
        i = int(path.split("/")[1])
        ref_g = np.asarray(want[convert.jax_path(path, pcfg)])[i]
        np.testing.assert_allclose(
            g.numpy(), ref_g, rtol=0,
            atol=1e-5 * max(1.0, float(np.abs(ref_g).max())))


def test_train_and_eval_steps_take_patches(vl):
    """One Hadamard train step over a VLM batch: trainable counts equal
    JAX's, the loss within 1e-5 and the leaves after the step within 1e-4,
    1 % of the step (lr 1e-2): AdamW's first step moves a leaf by
    lr * g / (|g| + 1e-8), which multiplies a gradient's error by
    lr * 1e-8 / g^2 where |g| nears 1e-7 (one adapter b entry here: fp32
    gradients agree to 1e-5 of their max, `test_lm_loss_...`, ~5e-9
    absolute). microbatch 2 splits the patches with the tokens; the eval
    step passes the patches."""
    jcfg, pcfg = vl["jcfg"], vl["pcfg"]
    labels = np.roll(vl["tokens"], -1, axis=1).astype(np.int32)
    batch = {"tokens": vl["tokens"], "labels": labels,
             "patches": vl["patches"]}
    ocfg = dict(lr=1e-2, total_steps=10)
    jstate = jsteps.make_state(KEY, jcfg, jpeft.strategy("hadamard"),
                               JOptimCfg(**ocfg), params=vl["jp"])
    jstate, jm = jsteps.build_train_step(jcfg, JOptimCfg(**ocfg))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    for mb in (0, 2):
        state = steps.make_state(None, pcfg, peft.strategy("hadamard"),
                                 OptimCfg(**ocfg), params=vl["pp"])
        assert sum(x.numel() for x in state["trainable"].values()) == sum(
            int(np.prod(x.shape)) for x in jax.tree.leaves(
                jstate["trainable"]))
        state, m = steps.build_train_step(pcfg, OptimCfg(**ocfg),
                                          microbatch=mb)(
            state, {k: t(v) for k, v in batch.items()})
        if mb:
            assert np.isfinite(float(m["loss"]))
            continue
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=1e-5, rtol=0)
        got = dict(tu_flat(convert.to_jax_params(state["params"], pcfg)))
        for path, leaf in tu_flat(jstate["trainable"]):
            if leaf is not None:
                np.testing.assert_allclose(got[path], np.asarray(leaf),
                                           atol=1e-4, rtol=0)
    want = jsteps.build_eval_step(jcfg)(vl["jp"], {
        k: jnp.asarray(v) for k, v in batch.items()})
    got = steps.build_eval_step(pcfg)(vl["pp"], {k: t(v) for k, v in
                                                 batch.items()})
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_quant_summary_of_a_vlm_tree_is_jax(vl):
    """int8 over the whole VLM tree: the same leaves quantized (vlm_proj,
    the untied head, the projections; counted in the JAX layout) and the
    same bytes as JAX's `quant_summary`; the logits with patches within
    1e-4 of JAX's over the quantized trees."""
    jtree = jq.quantize_tree(vl["jp"], "int8")
    ptree = qtensor.quantize_tree(vl["pp"], "int8", cfg=vl["pcfg"])
    want = jq.quant_summary(jtree)
    got = qtensor.quant_summary(ptree, lambda p: convert.jax_path(
        p, vl["pcfg"]))
    assert isinstance(ptree["vlm_proj"]["kernel"], qtensor.QTensor)
    for key in ("n_quantized_leaves", "quantized_bytes", "dense_bytes_fp32"):
        assert got[key] == want[key], key
    assert got["n_quantized_leaves"] == 9  # 7 a layer's kind, head, vlm_proj
    jl, _ = JM.forward_lm(jtree, vl["jcfg"], jnp.asarray(vl["tokens"]),
                          patches=jnp.asarray(vl["patches"]))
    pl = M.forward_lm(ptree, vl["pcfg"], t(vl["tokens"]),
                      patches=t(vl["patches"]))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)


def test_learned_positions_reach_the_decoder_prompt():
    """A decoder with pos="learned": forward_lm and prefill_lm embed the
    prompt at positions 0..S-1 (JAX's `_decoder_embed`); decode_lm adds
    none, as JAX's does. Logits within 1e-4 of JAX's."""
    jcfg = tiny_cfg(pos="learned")
    jp, pp, pcfg = world(jcfg)
    toks = np.random.RandomState(2).randint(0, 97, (2, 9)).astype(np.int32)
    want, _ = JM.forward_lm(jp, jcfg, jnp.asarray(toks))
    got = M.forward_lm(pp, pcfg, t(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    want, jc = JM.prefill_lm(jp, jcfg, jnp.asarray(toks), cache_len=16)
    got, pc = M.prefill_lm(pp, pcfg, t(toks), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    tok = np.asarray(want).argmax(-1).astype(np.int32)
    want, _ = JM.decode_lm(jp, jcfg, jc, jnp.asarray(tok), jnp.int32(9))
    got, _ = M.decode_lm(pp, pcfg, pc, t(tok), torch.full((2,), 9))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    # without positions the prompt's logits would differ
    bare = {k: v for k, v in pp.items()}
    bare["pos_embed"] = {"table": torch.zeros_like(pp["pos_embed"]["table"])}
    other = M.forward_lm(bare, pcfg, t(toks))
    assert float((other - M.forward_lm(pp, pcfg, t(toks))).abs().max()) > 1e-3
