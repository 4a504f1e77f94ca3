"""The quantized build that fits one card, and the quantized trunks of
gemma2 and internvl2, against the JAX package.

`quantize_tree` returns a new tree and leaves its argument whole, so an
engine over a caller's tree holds the dense trunk beside the quantized
one (gemma2-27b: 54.5 + 28.4 GB). The launcher and `build_engine` own
the trees they make and quantize them in place, leaf by leaf
(`quant.quantize_owned`, `launch.serve.own_trunk`):
  * the QTensors are `quantize_tree`'s byte for byte, for one tree, for
    variants that share a trunk (one QTensor a leaf, shared), and after a
    fold; `quantize_tree`'s argument stays untouched;
  * no more than one dense projection is still referenced once its
    QTensor exists, held by weakrefs over `build_engine`'s own build, and
    none once the engine is built;
  * gemma2's and internvl2's smoke trees quantized that way match JAX's
    quantized model: 14 and 9 leaves (`vlm_proj` among them), the same
    bytes, logits within 1e-4.
"""
import re
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.core import hadamard as jhad
from repro.core import peft as jpeft
from repro.models import model as JM
from repro.quant import qtensor as jq
from repro_torch import convert
from repro_torch.common import tree as tu
from repro_torch.launch import serve as launcher
from repro_torch.models import model as M
from repro_torch.quant import qtensor as tq
from repro_torch.serving import ServeEngine
from test_torch_encdec import sharpen, t
from test_torch_model import KEY, np_tree, port_cfg
from test_torch_quant import _bytes, _flat

ARCH = "starcoder2-7b"
_jinit = jax.jit(JM.init_params, static_argnums=1)


def world(jcfg):
    """`test_torch_encdec.world` with JAX's init under jit: (JAX params,
    port params, port cfg), adapters perturbed, norms and q/k sharpened."""
    tree = sharpen(np_tree(jhad.perturb_adapters(
        _jinit(KEY, jcfg), jax.random.fold_in(KEY, 100), scale=0.2)), 3)
    pcfg = port_cfg(jcfg)
    return (jax.tree.map(jnp.asarray, tree),
            convert.from_jax_params(tree, pcfg, "cpu"), pcfg)


def _same_bytes(a, b):
    fa, fb = (dict(tu.flatten_with_paths(x)) for x in (a, b))
    assert set(fa) == set(fb)
    for path, x in fa.items():
        y = fb[path]
        assert tq.is_qtensor(x) == tq.is_qtensor(y), path
        if tq.is_qtensor(x):
            assert x.values.dtype == y.values.dtype, path
            np.testing.assert_array_equal(_bytes(x.values), _bytes(y.values))
            assert torch.equal(x.scales, y.scales), path
        else:
            assert torch.equal(x, y), path


@pytest.mark.parametrize("case", ["one_tree", "three_variants", "fold"])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_owned_build_gives_quantize_trees_bytes(mode, case):
    """own_trunk over trees the build owns against quantize_tree over an
    equal copy: the same QTensors; shared trunk leaves become one shared
    QTensor; a fold comes first, as ServeEngine(fold=True) does it."""
    cfg = launcher.build_config(ARCH, smoke=True)
    tasks = 3 if case == "three_variants" else 0
    ref = launcher.build_params(cfg, 0, tasks, "cpu")
    snapshot = [tu.map_with_path(lambda _, x: x.clone(), v) for v in ref]
    owned = launcher.build_params(cfg, 0, tasks, "cpu")
    got = launcher.own_trunk(cfg, owned, mode, fold=case == "fold")
    if case == "fold":
        want = [ServeEngine(cfg, ref[0], fold=True, quant=mode,
                            device="cpu").params]
    else:
        want = [tq.quantize_tree(v, mode) for v in ref]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_bytes(g, w)
    for r, s in zip(ref, snapshot):  # quantize_tree left its argument
        _same_bytes(r, s)
    flats = [dict(tu.flatten_with_paths(g)) for g in got]
    n_q = 0
    for path, leaf in flats[0].items():
        if tq.is_qtensor(leaf):
            n_q += 1
            assert all(f[path] is leaf for f in flats[1:]), path
    assert n_q == 6 * cfg.n_layers + 1  # 6 projections a layer, the head
    assert tq.quant_summary(got[0], lambda p: convert.jax_path(p, cfg))[
        "n_quantized_leaves"] == 7


@pytest.mark.parametrize("tasks", [0, 3])
def test_no_more_than_one_dense_projection_outlives_its_qtensor(
        monkeypatch, tasks):
    """Weakrefs to every dense projection build_engine's build makes: when
    each QTensor is made, at most one projection already quantized is
    still referenced (the one just quantized), and once the engine is
    built none is."""
    refs, quantized, most = {}, [], [0]
    real_base, real_quantize = launcher.build_base, tq.quantize

    def base(*a, **kw):
        tree = real_base(*a, **kw)
        for path, leaf in tu.flatten_with_paths(tree):
            if tq.quantizable("/" + path):
                refs[path] = weakref.ref(leaf)
        return tree

    def quantize(x, *a, **kw):
        out = real_quantize(x, *a, **kw)
        quantized.extend(p for p, r in refs.items() if r() is x)
        most[0] = max(most[0], sum(refs[p]() is not None for p in quantized))
        return out

    monkeypatch.setattr(launcher, "build_base", base)
    monkeypatch.setattr(tq, "quantize", quantize)
    cfg = launcher.build_config(ARCH, smoke=True)
    eng = launcher.build_engine(cfg, seed=0, tasks=tasks, device="cpu",
                                quant="int8")
    assert len(refs) == len(quantized) == 6 * cfg.n_layers + 1
    assert most[0] == 1
    assert all(r() is None for r in refs.values())
    assert sum(tq.is_qtensor(v) for _, v in tu.flatten_with_paths(
        eng.params)) == len(refs)


@pytest.mark.parametrize("arch,leaves", [("gemma2-27b", 14),
                                         ("internvl2-76b", 9)])
def test_owned_quantized_trunks_match_jax(arch, leaves):
    """JAX's smoke tree quantized by JAX and by the owned build of the
    port: JAX's leaf count (gemma2: 7 kinds in each of its two layer
    slots; internvl2: 7, the head and vlm_proj), the same bytes, forward
    logits within 1e-4 (internvl2 with patches)."""
    jcfg = jpeft.attach(jax_get_smoke(arch), jpeft.strategy("hadamard"))
    jp, pp, pcfg = world(jcfg)
    jqt = jq.quantize_tree(jp, "int8")  # eager, as JAX's engine runs it
    launcher.own_trunk(pcfg, [pp], "int8")
    want = _flat(jqt)
    got = _flat(convert.to_jax_params(pp, pcfg))
    assert set(got) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(_bytes(got[path]), _bytes(leaf), path)
    qs = tq.quant_summary(pp, lambda p: convert.jax_path(p, pcfg))
    assert qs["n_quantized_leaves"] == jq.quant_summary(jqt)[
        "n_quantized_leaves"] == leaves
    rs = np.random.RandomState(3)
    toks = rs.randint(0, pcfg.vocab_size, (2, 9)).astype(np.int32)
    kw, jkw = {}, {}
    if arch == "internvl2-76b":
        assert tq.is_qtensor(pp["vlm_proj"]["kernel"])
        patches = rs.standard_normal((2, pcfg.n_image_tokens, pcfg.d_model)
                                     ).astype(np.float32)
        kw, jkw = {"patches": t(patches)}, {"patches": jnp.asarray(patches)}
    jl, _ = jax.jit(JM.forward_lm, static_argnums=1)(
        jqt, jcfg, jnp.asarray(toks), **jkw)
    pl = M.forward_lm(pp, pcfg, t(toks), **kw)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)


@pytest.mark.parametrize("flags", [[], ["--fold"], ["--tasks", "3"],
                                   ["--spec-k", "2", "--spec-draft", "model"],
                                   ["--tasks", "3", "--adapter-dir", None,
                                    "--bank-size", "2"]])
def test_launcher_serves_the_owned_trunk_as_the_engine_built_it(
        monkeypatch, capsys, tmp_path, flags):
    """The serve launcher under --quant int8, its trunk quantized in place,
    against the same run with the engine quantizing a dense copy, as it did
    before the launcher owned the build: the same quant line and every
    request's tokens (--fold folds first either way; the fold's bytes are
    held to ServeEngine(fold=True) above)."""
    flags = [str(tmp_path / "reg") if f is None else f for f in flags]
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--quant", "int8",
            "--requests", "4", "--num-slots", "2", "--prompt-len", "7",
            "--new-tokens", "4"] + flags

    def lines():
        """The quant line, each request's tokens and the served count,
        without the times."""
        out = capsys.readouterr().out.splitlines()
        return [re.sub(r"(, ttft [\d.]+ms| in [\d.]+s)", "", ln)
                for ln in out if ln.startswith(("int8 backbone", "req",
                                                "served 4 requests"))]

    launcher.main(argv)
    got = lines()
    if "--adapter-dir" in flags:
        flags[flags.index("--adapter-dir") + 1] = str(tmp_path / "reg2")
        argv = argv[:-len(flags)] + flags
    # the reference: the trees left dense (a fold still comes first), the
    # engine quantizing a copy of them
    monkeypatch.setattr(launcher, "quantize_owned", lambda *a, **k: None)
    launcher.main(argv)
    want = lines()
    assert len(got) == 6 and got[0].startswith("int8 backbone: 7 matmul")
    assert got == want
