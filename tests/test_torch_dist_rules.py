"""The port's sharding rules and dry-run yardstick against JAX's (no
processes, no devices).

For every leaf of every assigned architecture, on the meshes (1, 2), (2, 4),
(16, 16) and (2, 16, 16): the port's `param_spec` (a port leaf named by
`convert.jax_path`, shaped by `convert.jax_shape`) equals JAX's on the JAX
leaf; so do `cache_spec`, `slot_cache_spec` and `paged_cache_spec` on the
caches and pools; and the port's per-device parameter bytes equal JAX's
over its stacked leaves. `analytic_model_flops` equals JAX's for every
arch x shape. The smoke configs' vocab of 503 (replicated by `fit_spec`)
stands beside one of 512 (sharded).
"""
import functools
import os

import jax
import numpy as np
import pytest
import torch

from repro.common import tree as jtu
from repro.configs import ASSIGNED as JAX_ASSIGNED
from repro.quant import quantize_tree as jquantize_tree
from repro.configs import get as jget
from repro.configs import get_smoke as jget_smoke
from repro.core import peft as jpeft
from repro.dist import sharding as JS
from repro.launch.specs import params_shapes as jparams_shapes
from repro.models import model as JM

from repro_torch.common import tree as tu
from repro_torch.common.types import SHAPES
from repro_torch.configs import ASSIGNED, get, get_smoke
from repro_torch.core import peft
from repro_torch.dist import sharding as S
from repro_torch.dist.api import Mesh
from repro_torch.launch import dryrun as D
from repro_torch.launch.specs import params_shapes
from repro_torch.models import model as M
from repro_torch.quant.qtensor import is_qtensor, quantize_tree

MESHES = [(1, 2), (2, 4), (16, 16), (2, 16, 16)]
ARCHS = sorted(ASSIGNED)


def test_the_port_carries_every_assigned_architecture():
    assert ARCHS == sorted(JAX_ASSIGNED)


class JaxMesh:
    """What JAX's rules read of a mesh: axis names and the device grid."""

    def __init__(self, shape):
        self.axis_names = (("data", "model") if len(shape) == 2
                           else ("pod", "data", "model"))
        self.devices = np.empty(shape)


def _jax_dryrun():
    """JAX's dry-run module, which sets XLA_FLAGS at import: the backend is
    initialised first, so the flag no longer takes, and put back."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


def _cfgs(arch, smoke=False, **kw):
    jc = jget_smoke(arch) if smoke else jget(arch)
    tc = get_smoke(arch) if smoke else get(arch)
    jc = jpeft.attach(jc.replace(**kw), jpeft.strategy("hadamard"))
    tc = peft.attach(tc.replace(**kw), peft.strategy("hadamard"))
    return jc, tc


@functools.lru_cache(maxsize=None)
def _jax_params(arch, smoke=False, vocab=None):
    jc, _ = _cfgs(arch, smoke, **({} if vocab is None
                                  else {"vocab_size": vocab}))
    return {p: tuple(l.shape) for p, l in
            jtu.flatten_with_paths(jparams_shapes(jc))}


@functools.lru_cache(maxsize=None)
def _port_params(arch, smoke=False, vocab=None):
    _, tc = _cfgs(arch, smoke, **({} if vocab is None
                                  else {"vocab_size": vocab}))
    return params_shapes(tc)


def _check_params(arch, shape, smoke=False, vocab=None):
    jc, tc = _cfgs(arch, smoke, **({} if vocab is None
                                   else {"vocab_size": vocab}))
    jleaves = _jax_params(arch, smoke, vocab)
    jmesh, mesh = JaxMesh(shape), Mesh(shape)
    params = _port_params(arch, smoke, vocab)
    seen = set()
    for path, leaf in tu.flatten_with_paths(params):
        for name, (jp, jshape, spec) in S.leaf_specs(path, leaf, tc,
                                                     mesh).items():
            assert jleaves[jp] == jshape, (path, jp)
            want = tuple(JS.param_spec(jp, jshape, jc, jmesh))
            assert spec == want, (jp, jshape, spec, want)
            seen.add(jp)
    assert seen == set(jleaves), sorted(set(jleaves) - seen)[:3]

    # JAX's bytes a device: each stacked leaf over its spec's shards
    jax_dt = {p: l.dtype for p, l in
              jtu.flatten_with_paths(jparams_shapes(jc))}
    jbytes = sum(
        int(np.prod(s)) * np.dtype(jax_dt[p]).itemsize // int(np.prod(
            [JS._axis_size(e, dict(zip(jmesh.axis_names, shape)))
             for e in JS.param_spec(p, s, jc, jmesh) if e is not None]
            or [1]))
        for p, s in jleaves.items())
    assert S.per_device_param_bytes(params, tc, mesh) == jbytes


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_bytes_match_jax(arch, shape):
    _check_params(arch, shape)


@pytest.mark.parametrize("vocab", [503, 512])
@pytest.mark.parametrize("shape", [(1, 2), (2, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_smoke_vocab_shards_only_where_it_divides(vocab, shape):
    _check_params("qwen3-0.6b", shape, smoke=True, vocab=vocab)
    _, tc = _cfgs("qwen3-0.6b", True, vocab_size=vocab)
    spec = S.leaf_specs("embed/table", _port_params("qwen3-0.6b", True,
                                                    vocab)["embed"]["table"],
                        tc, Mesh(shape))[""][2]
    assert spec == (("model", None) if vocab == 512 else (None, None))


def _port_cache_leaves(caches, cfg):
    out = {}
    for jp, jshape, leaf in D.cache_leaves(caches, cfg):
        if is_qtensor(leaf):
            for name in ("values", "scales"):
                part = getattr(leaf, name)
                out[f"{jp}/{name}"] = (jshape[:1] + tuple(part.shape))
        else:
            out[jp] = jshape
    return out


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_jax(arch, shape):
    jc, tc = _cfgs(arch, smoke=True)
    jmesh, mesh = JaxMesh(shape), Mesh(shape)
    B, L = 32, 48
    if jc.family == "encdec":
        jcaches = jax.eval_shape(functools.partial(JM.init_encdec_caches, jc,
                                                   B, L))
    else:
        jcaches = jax.eval_shape(functools.partial(JM.init_decode_caches, jc,
                                                   B, L))
    jleaves = {p: tuple(l.shape) for p, l in jtu.flatten_with_paths(jcaches)}
    ports = _port_cache_leaves(
        M.init_decode_caches(tc, B, L, torch.device("meta")), tc)
    assert ports == jleaves
    for jp, js in jleaves.items():
        for fn in ("cache_spec", "slot_cache_spec"):
            assert getattr(S, fn)(jp, js, tc, mesh) == tuple(
                getattr(JS, fn)(jp, js, jc, jmesh)), (fn, jp)
    if all(s.kind == "attn" and not s.cross_attn for s in tc.layer_slots()):
        for quant in (None, "int8"):
            jpool = jax.eval_shape(functools.partial(
                JM.init_paged_pool, jc, 12, 16, quant=quant))
            jl = {p: tuple(l.shape) for p, l in jtu.flatten_with_paths(jpool)}
            pl = _port_cache_leaves(M.init_paged_pool(
                tc, 12, 16, quant, torch.device("meta")), tc)
            assert pl == jl
            for jp, js in jl.items():
                assert S.paged_cache_spec(jp, js, tc, mesh) == tuple(
                    JS.paged_cache_spec(jp, js, jc, jmesh)), jp


def test_kv_heads_fall_back_to_head_dim_as_jax():
    """recurrentgemma's one KV head: JAX shards head_dim (which the port's
    Megatron layout refuses to run, but the rule agrees)."""
    _, tc = _cfgs("recurrentgemma-2b")
    spec = S.cache_spec("g0/slot2/attn/k", (8, 128, 2048, 1, 256), tc,
                        Mesh((4, 8)))
    assert spec == (None, "data", None, None, "model")


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_model_flops_match_jax(arch):
    jd = _jax_dryrun()
    jc, tc = _cfgs(arch)
    from repro.common.types import SHAPES as JSHAPES
    for name, spec in SHAPES.items():
        assert D.analytic_model_flops(tc, spec) == jd.analytic_model_flops(
            jc, JSHAPES[name]), name
    assert D.skip_reason(tc, SHAPES["long_500k"]) == jd.skip_reason(
        jc, JSHAPES["long_500k"])


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "starcoder2-7b",
                                  "internvl2-76b"])
def test_quantized_leaves_take_their_base_leafs_rule(arch):
    """int8 values shard as the weight, scales by the same template: a
    row-parallel weight's (1, N) scales replicated, a column-parallel
    one's sharded with its columns, as JAX places them."""
    jc, tc = _cfgs(arch, smoke=True, vocab_size=512)
    jq = jax.eval_shape(lambda k: jquantize_tree(JM.init_params(k, jc),
                                                 mode="int8"),
                        jax.random.PRNGKey(0))
    jl = {p: tuple(l.shape) for p, l in jtu.flatten_with_paths(jq)}
    q = quantize_tree(M.init_params(torch.Generator().manual_seed(0), tc),
                      mode="int8")
    for shape in [(1, 2), (2, 4)]:
        mesh, jmesh = Mesh(shape), JaxMesh(shape)
        seen = set()
        for path, leaf in tu.flatten_with_paths(q):
            for jp, js, spec in S.leaf_specs(path, leaf, tc, mesh).values():
                assert jl[jp] == js
                assert spec == tuple(JS.param_spec(jp, js, jc, jmesh)), jp
                seen.add(jp)
        assert seen == set(jl)
        assert any(p.endswith("/scales") for p in seen)
