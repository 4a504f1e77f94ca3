"""The encoder-decoder family (whisper): the port against the JAX package.

The weights are made by JAX (`init_params`), their adapters perturbed,
every norm's scale and bias moved off 1 and 0 and the query and key
projections scaled up (so attention is not uniform, the norm the decoder's
seam normalises by, `cross_norm`, differs from `ffn_norm`, and a seam that
took the wrong one shows), then carried into the port by
`convert.from_jax_params`. On the CPU every kernel call takes its plain
version; `chip_smoke.py` holds the kernels to those on the card. Two
configs: whisper-tiny's smoke dims (d 64, 4/4 heads of 16, 8 frames, 2 +
2 layers) and JAX's tiny encdec config of `tests/test_models.py` (4/2
heads). fp32 throughout: modules within 1e-5, whole-model logits within
1e-4, greedy tokens identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_cfg
from repro.common.types import Group as JGroup
from repro.common.types import Slot as JSlot
from repro.common.types import OptimCfg as JOptimCfg
from repro.configs import get as jax_get
from repro.configs import get_smoke as jax_get_smoke
from repro.core import hadamard as jhad
from repro.core import peft as jpeft
from repro.models import model as JM
from repro.models import flash as jflash
from repro.train import losses as jlosses
from repro.train import steps as jsteps
from repro_torch import convert
from repro_torch.common import tree as tu
from repro_torch.common.types import OptimCfg
from repro_torch.configs import get, get_smoke
from repro_torch.core import hadamard as had
from repro_torch.core import peft
from repro_torch.kernels import ref
from repro_torch.kernels.attention import flash_shapes
from repro_torch.models import model as M
from repro_torch.train import losses, steps
from test_torch_model import KEY, np_tree, port_cfg

ARCH = "whisper-tiny"
B, S_TXT, CACHE = 2, 6, 24


def whisper_jcfg(name="smoke", position="attn_out"):
    strat = "hadamard" if position == "attn_out" else "hadamard_concat"
    if name == "smoke":
        cfg = jax_get_smoke(ARCH)
    else:  # JAX's tiny encdec config (tests/test_models.py)
        cfg = tiny_cfg(family="encdec", pos="learned", norm="layernorm",
                       gated_mlp=False, act="gelu", attn_bias=True,
                       groups=(JGroup((JSlot("attn", cross_attn=True),), 2),),
                       enc_groups=(JGroup((JSlot("attn"),), 2),),
                       n_audio_frames=8)
    return jpeft.attach(cfg, jpeft.strategy(strat))


def sharpen(tree, seed):
    """A numpy tree's norm leaves (scale, bias) moved off 1 and 0, and its
    query and key projections scaled by 8: at init (std 0.02) every
    attention is near uniform, so its query, and so the norm before it,
    would hardly move the output."""
    rs = np.random.RandomState(seed)

    def one(path, leaf):
        name = jax.tree_util.keystr(path)
        if "norm" in name and ("scale" in name or "bias" in name):
            return (leaf + 0.5 * rs.standard_normal(leaf.shape)).astype(
                leaf.dtype)
        if "'wq'" in name or "'wk'" in name:
            return leaf * np.float32(8.0)
        return leaf

    return jax.tree_util.tree_map_with_path(one, tree)


def world(jcfg):
    """(JAX params, port params, port cfg): JAX-made weights with the
    adapters perturbed and the rest sharpened (`sharpen`)."""
    base = JM.init_params(KEY, jcfg)
    tree = sharpen(np_tree(jhad.perturb_adapters(
        base, jax.random.fold_in(KEY, 100), scale=0.2)), 3)
    pcfg = port_cfg(jcfg)
    return (jax.tree.map(jnp.asarray, tree),
            convert.from_jax_params(tree, pcfg, "cpu"), pcfg)


@pytest.fixture(scope="module", params=["smoke", "tiny"])
def wh(request):
    jcfg = whisper_jcfg(request.param)
    jp, pp, pcfg = world(jcfg)
    rs = np.random.RandomState(11)
    frames = rs.standard_normal((B, pcfg.n_audio_frames, pcfg.d_model)
                                ).astype(np.float32)
    tokens = rs.randint(0, pcfg.vocab_size, (B, S_TXT)).astype(np.int32)
    return dict(jcfg=jcfg, jp=jp, pp=pp, pcfg=pcfg, frames=frames,
                tokens=tokens)


def t(a):
    return torch.from_numpy(np.array(a))


def test_whisper_configs_match_jax_field_for_field():
    for jcfg, pcfg in ((jax_get(ARCH), get(ARCH)),
                       (jax_get_smoke(ARCH), get_smoke(ARCH))):
        assert dataclasses.asdict(port_cfg(jcfg)) == dataclasses.asdict(pcfg)
    cfg = get(ARCH)
    assert len(cfg.layer_slots()) == 4 and len(cfg.enc_layer_slots()) == 4
    assert cfg.n_layers == 8  # both stacks, as JAX counts them
    assert all(s.cross_attn for s in cfg.layer_slots())
    assert not any(s.cross_attn for s in cfg.enc_layer_slots())


def test_full_size_parameter_count_is_jax():
    """49,646,976 with Hadamard adapters on both stacks, JAX's count by
    shapes, on device="meta"; the decoder's position table is 32k rows."""
    pcfg = peft.attach(get(ARCH), peft.strategy("hadamard"))
    with torch.device("meta"):
        params = M.init_params(None, pcfg)
    jcfg = jpeft.attach(jax_get(ARCH), jpeft.strategy("hadamard"))
    shapes = jax.eval_shape(lambda: JM.init_params(KEY, jcfg))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert tu.count_params(params) == want == 49_646_976
    assert len(params["enc_layers"]) == 4 and len(params["layers"]) == 4
    assert params["enc_pos_embed"]["table"].shape == (1500, 384)
    assert params["pos_embed"]["table"].shape == (32768, 384)
    assert "q_norm" not in params["layers"][0]["cross"]


def test_encode_audio_matches_jax(wh):
    want = JM.encode_audio(wh["jp"], wh["jcfg"], jnp.asarray(wh["frames"]))
    got = M.encode_audio(wh["pp"], wh["pcfg"], t(wh["frames"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_forward_encdec_matches_jax(wh):
    want, _ = JM.forward_encdec(wh["jp"], wh["jcfg"],
                                jnp.asarray(wh["frames"]),
                                jnp.asarray(wh["tokens"]))
    got, aux = M.forward_encdec(wh["pp"], wh["pcfg"], t(wh["frames"]),
                                t(wh["tokens"]))
    assert got.shape == (B, S_TXT, wh["pcfg"].vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    assert float(aux) == 0.0


def test_the_seam_normalises_by_cross_norm(wh):
    """The decoder's seam feeds cross_norm: with the two norms swapped the
    logits move far past the parity tolerance, so the test above would
    catch a seam fused into ffn_norm."""
    faulty = {**wh["pp"], "layers": [
        {**lyr, "cross_norm": lyr["ffn_norm"]} for lyr in wh["pp"]["layers"]]}
    good, _ = M.forward_encdec(wh["pp"], wh["pcfg"], t(wh["frames"]),
                               t(wh["tokens"]))
    bad, _ = M.forward_encdec(faulty, wh["pcfg"], t(wh["frames"]),
                              t(wh["tokens"]))
    assert float((good - bad).abs().max()) > 1e-2, \
        float((good - bad).abs().max())


@pytest.mark.parametrize("per_row", [False, True])
def test_prefill_and_greedy_decode_match_jax(wh, per_row):
    """prefill_encdec, then 12 greedy decode_encdec steps: each step's
    logits within 1e-4 of JAX's and each greedy token JAX's, with one
    scalar position or per-row positions (row 1 three tokens behind,
    rewriting its cache from there)."""
    jcfg, pcfg = wh["jcfg"], wh["pcfg"]
    frames, tokens = wh["frames"], wh["tokens"]
    want, jc = JM.prefill_encdec(wh["jp"], jcfg, jnp.asarray(frames),
                                 jnp.asarray(tokens), cache_len=CACHE)
    got, pc = M.prefill_encdec(wh["pp"], pcfg, t(frames), t(tokens), CACHE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    assert set(pc[0]) == {"k", "v", "ck", "cv"}
    assert pc[0]["ck"].shape == (B, pcfg.n_audio_frames, pcfg.n_kv_heads,
                                 pcfg.head_dim)
    jdec = jax.jit(JM.decode_encdec, static_argnums=1)
    tok_j = np.asarray(want).argmax(-1).astype(np.int32)
    tok_p = got.argmax(-1)
    offset = np.array([0, 3]) if per_row else np.zeros(2, int)
    for step in range(12):
        assert np.array_equal(tok_p.numpy(), tok_j)
        p = S_TXT + step - offset
        jpos = jnp.asarray(p, jnp.int32) if per_row else jnp.int32(p[0])
        ppos = torch.from_numpy(p) if per_row else int(p[0])
        want, jc = jdec(wh["jp"], jcfg, jc, jnp.asarray(tok_j), jpos)
        got, pc = M.decode_encdec(wh["pp"], pcfg, pc, tok_p, ppos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)
        tok_j = np.asarray(want).argmax(-1).astype(np.int32)
        tok_p = got.argmax(-1)
    assert np.array_equal(tok_p.numpy(), tok_j)


def test_encdec_caches_and_refusals():
    pcfg = port_cfg(whisper_jcfg())
    caches = M.init_encdec_caches(pcfg, 3, 16, "cpu")
    assert len(caches) == 2 and caches[1]["ck"].shape == (3, 8, 4, 16)
    assert caches[1]["k"].shape == (3, 16, 4, 16)
    # the paged pool refuses a cross slot with JAX's text
    msg = "paged KV pools require pure attention slots (got kind='attn', " \
          "cross_attn=True)"
    with pytest.raises(ValueError) as want:
        JM.init_paged_pool(whisper_jcfg(), 8, 4)
    assert str(want.value) == msg
    with pytest.raises(ValueError, match=r"pure attention slots \(got "
                       r"kind='attn', cross_attn=True\)"):
        M.init_paged_pool(pcfg, 8, 4)
    # the decoder-LM functions need a decoder or VLM config
    with pytest.raises(ValueError, match="decoder or VLM config"):
        M.prefill_lm(M.init_params(torch.Generator().manual_seed(0), pcfg),
                     pcfg, torch.zeros((1, 4), dtype=torch.long), 8)
    with pytest.raises(ValueError, match="no eval step"):
        steps.build_eval_step(pcfg)


def test_encdec_loss_and_adapter_gradients_match_jax(wh):
    """encdec_loss within 1e-5 and the gradient of every adapter leaf, the
    encoder's and the decoder's, within 1e-5 of max|ref| of jax.grad."""
    jcfg, pcfg = wh["jcfg"], wh["pcfg"]
    labels = np.roll(wh["tokens"], -1, axis=1)
    labels[:, -1] = -100
    jb = {"frames": jnp.asarray(wh["frames"]),
          "tokens": jnp.asarray(wh["tokens"]), "labels": jnp.asarray(labels)}

    def jloss(adapters):
        return jlosses.encdec_loss(jcfg, jhad.apply_delta(wh["jp"], adapters),
                                   jb)[0]

    jdelta = jhad.extract_delta(wh["jp"])
    want_l, want_g = jax.value_and_grad(jloss)(jdelta)
    pp = tu.map_with_path(lambda _, x: x.clone(), wh["pp"])
    leaves = {p: x.requires_grad_(True) for p, x in tu.flatten_with_paths(pp)
              if "/adapter/" in p}
    assert any(p.startswith("enc_layers/") for p in leaves)
    pb = {k: t(v) for k, v in jb.items()}
    loss, _ = losses.loss_for(pcfg)(pcfg, pp, pb)
    np.testing.assert_allclose(loss.item(), float(want_l), atol=1e-5, rtol=0)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    want = dict(tu_flat(want_g))
    for path, g in grads.items():
        jp = convert.jax_path(path, pcfg)
        enc = path.startswith("enc_layers/")
        idx = convert._layer_position(pcfg, enc)[int(path.split("/")[1])][1]
        ref_g = np.asarray(want[jp])[idx]
        np.testing.assert_allclose(
            g.numpy(), ref_g, rtol=0,
            atol=1e-5 * max(1.0, float(np.abs(ref_g).max())))


def tu_flat(tree):
    """(path, leaf) of a JAX tree of dicts, paths joined by '/'."""
    out = []
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out.append(("/".join(str(k.key) for k in kp), leaf))
    return out


def test_train_step_matches_jax(wh):
    """One build_train_step step of the Hadamard strategy under
    encdec_loss: the trainable counts and every trainable leaf after the
    step equal JAX's within 1e-5; microbatch 2 splits the frames too."""
    jcfg, pcfg = wh["jcfg"], wh["pcfg"]
    strat = peft.strategy("hadamard")
    labels = np.roll(wh["tokens"], -1, axis=1)
    batch = {"frames": wh["frames"], "tokens": wh["tokens"],
             "labels": labels.astype(np.int32)}
    jstate = jsteps.make_state(KEY, jcfg, jpeft.strategy("hadamard"),
                               JOptimCfg(lr=1e-2, total_steps=10),
                               params=wh["jp"])
    jstate, jm = jsteps.build_train_step(jcfg, JOptimCfg(
        lr=1e-2, total_steps=10))(jstate, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    for mb in (0, 2):
        state = steps.make_state(None, pcfg, strat,
                                 OptimCfg(lr=1e-2, total_steps=10),
                                 params=wh["pp"])
        n_train = sum(x.numel() for x in state["trainable"].values())
        jn = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
            jstate["trainable"]))
        assert n_train == jn
        state, m = steps.build_train_step(
            pcfg, OptimCfg(lr=1e-2, total_steps=10), microbatch=mb)(
            state, {k: t(v) for k, v in batch.items()})
        if mb == 0:
            np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                       atol=1e-5, rtol=0)
            want = convert.to_jax_params(state["params"], pcfg)
            got_flat = dict(tu_flat(want))
            for path, leaf in tu_flat(jstate["trainable"]):
                if leaf is None:
                    continue
                np.testing.assert_allclose(got_flat[path], np.asarray(leaf),
                                           atol=1e-5, rtol=0)
        else:
            assert np.isfinite(float(m["loss"]))


def test_convert_and_deltas_round_trip_over_enc_layers():
    jcfg = whisper_jcfg("tiny")
    jp, pp, pcfg = world(jcfg)
    back = convert.to_jax_params(pp, pcfg)
    want = dict(tu_flat(np_tree(jp)))
    got = dict(tu_flat(back))
    assert set(got) == set(want)
    assert any(p.startswith("enc_blocks/") for p in want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], leaf)
    assert convert.jax_path("enc_layers/1/adapter/w", pcfg) == \
        "enc_blocks/g0/slot0/adapter/w"
    assert convert.jax_ndim("enc_layers/1/adapter/w",
                            pp["enc_layers"][1]["adapter"]["w"]) == 2
    # a task delta stacks to JAX's layout and back
    delta = had.extract_delta(pp)
    stacked = convert.stack_delta(delta, pcfg)
    jdelta = dict(tu_flat(np_tree(jhad.extract_delta(jp))))
    flat = dict(tu_flat(stacked))
    assert {p for p, v in flat.items() if v is not None} == {
        p for p, v in jdelta.items() if v is not None}
    for path, leaf in jdelta.items():
        if leaf is not None:
            np.testing.assert_array_equal(flat[path].numpy(), leaf)
    un = convert.unstack_delta(stacked, pcfg)
    for i in range(2):
        np.testing.assert_array_equal(
            un["enc_layers"][i]["adapter"]["b"].numpy(),
            pp["enc_layers"][i]["adapter"]["b"].numpy())


def test_flash_wrapper_admits_non_causal_queries_past_the_keys():
    """#4's shape checks admit a non-causal call of Sq > Skv (a decoder
    longer than the encoder's frames cross-attending) and still refuse a
    causal one; the plain version agrees with JAX's flash.attend there."""
    rs = np.random.RandomState(5)
    q = rs.standard_normal((2, 4, 20, 64)).astype(np.float32)
    k = rs.standard_normal((2, 2, 8, 64)).astype(np.float32)
    v = rs.standard_normal((2, 2, 8, 64)).astype(np.float32)
    assert flash_shapes(t(q), t(k), t(v), causal=False) == (2, 4, 2, 20, 8,
                                                            64)
    with pytest.raises(ValueError, match="causal Sq 20 > Skv 8"):
        flash_shapes(t(q), t(k), t(v), causal=True)
    got = ref.attention_ref(t(q), t(k), t(v), causal=False)
    qg = jnp.asarray(q.transpose(0, 2, 1, 3).reshape(2, 20, 2, 2, 64))
    want = jflash.attend(qg, jnp.asarray(k.transpose(0, 2, 1, 3)),
                         jnp.asarray(v.transpose(0, 2, 1, 3)),
                         q_pos=jnp.arange(20), kv_pos=jnp.arange(8),
                         causal=False, q_chunk=8, kv_chunk=8)
    want = np.asarray(want).reshape(2, 20, 4, 64).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
