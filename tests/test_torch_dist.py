"""Sharded serving and training of the port against JAX on one device.

Each world is spawned ranks on the CPU over gloo, meeting through a
file store (`launch.mesh.run_world`), once a module; the rank programs are
`torch_dist_ranks`. Everything runs in fp32:

  * qwen3 smoke with 4 KV heads and a vocab of 512 (sharded) at 1x2 and
    1x4: prefill and decode logits within 1e-4 of JAX's single-device
    ones, and the scheduler's greedy tokens over a 3-task bank with
    mid-decode admission identical to JAX's;
  * the same under an int8 trunk at 1x2 (quantized whole, then sliced):
    tokens equal to JAX's int8 engine;
  * starcoder2 smoke at 1x2 with its biases moved off zero (the
    all-reduce comes before bo, the column biases are sliced);
  * gemma2 smoke at 1x2: #1's post-norm seam, soft-caps and a ring past
    its window;
  * internvl2 smoke at 1x2: `vlm_proj` column-parallel, its output
    gathered;
  * a 2x2 train step of the hadamard strategy against JAX's single-device
    step within rtol=2e-4, as `tests/test_distribution.py` holds its mesh;
  * a 2x1 step of deepseek-moe smoke against JAX's step on a (2, 1) mesh,
    whose routing groups are the dp shards (JAX's side in a subprocess
    with two forced host devices, as `tests/test_distribution.py` runs
    its meshes);
  * every refusal, with the ROADMAP item it names;
  * a rank's exception raised again in the caller of `run_world`.
"""
import concurrent.futures
import functools
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.common.types import OptimCfg as JOptimCfg
from repro.configs import get_smoke as jget_smoke
from repro.core import hadamard as jhad
from repro.core import peft as jpeft
from repro.data.synthetic import lm_batches, lm_corpus
from repro.models import model as JM
from repro.serving import MultiTaskEngine as JMultiTaskEngine
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro.serving import ServingConfig as JServingConfig
from repro.serving import make_scheduler as jmake_scheduler
from repro.train.steps import build_train_step as jbuild_train_step
from repro.train.steps import make_state as jmake_state
from repro.train.steps import merged_params as jmerged_params

from repro_torch import convert
from repro_torch.common.types import OptimCfg
from repro_torch.configs import get_smoke
from repro_torch.core import peft
from repro_torch.dist import sharding as S
from repro_torch.dist.api import Mesh, use_mesh
from repro_torch.launch.mesh import run_world
from repro_torch.serving import ServeEngine
from test_torch_model import np_tree, port_cfg

import torch_dist_ranks as ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = jax.random.PRNGKey(0)
MAX_LEN = 32


def _world(shape, fn, *args):
    """run_world without PYTHONPATH in the ranks' environment (it would
    load `src/sitecustomize.py`, which imports JAX): a spawned rank takes
    its sys.path from this process."""
    saved = os.environ.pop("PYTHONPATH", None)
    try:
        return run_world(shape, fn, *args, device="cpu", timeout=300)
    finally:
        if saved is not None:
            os.environ["PYTHONPATH"] = saved


def _cfg(arch, **kw):
    jc = jpeft.attach(jget_smoke(arch).replace(**kw),
                      jpeft.strategy("hadamard"))
    return jc, port_cfg(jc)


def _params(jc, tasks=0, seed=0, biases=False):
    """JAX's weights, adapters moved off the identity (per task), biases
    too where asked; as numpy trees."""
    base = jax.jit(JM.init_params, static_argnums=1)(
        jax.random.PRNGKey(seed), jc)
    if biases:
        rs = np.random.RandomState(seed + 7)

        def bump(path, leaf):
            if path.rsplit("/", 1)[-1] in ("bq", "bk", "bv", "bo", "bi"):
                return leaf + jnp.asarray(
                    0.1 * rs.standard_normal(leaf.shape), leaf.dtype)
            return leaf

        from repro.common import tree as jtu
        base = jtu.map_with_path(bump, base)
    variants = [jhad.perturb_adapters(base, jax.random.fold_in(KEY, 100 + t),
                                      scale=0.2)
                for t in range(max(tasks, 1))]
    return variants


def _traffic(vocab, tasks, n=7, seed=3):
    rs = np.random.RandomState(seed)
    return [dict(prompt=rs.randint(0, vocab, (int(rs.choice([4, 9, 13])),)),
                 max_new_tokens=int(rs.randint(2, 9)),
                 task_id=i % tasks if tasks else 0) for i in range(n)]


def _jax_tokens(jc, jparams, traffic, tasks, quant=None):
    eng = (JMultiTaskEngine(jc, jparams, quant=quant) if tasks
           else JServeEngine(jc, jparams[0], quant=quant))
    done, _ = jmake_scheduler(eng, JServingConfig(
        num_slots=3, max_len=MAX_LEN, backbone_quant=quant)).run(
        [JRequest(**t) for t in traffic])
    return [np.asarray(d.tokens) for d in done]


def _jax_logits(jc, jparams, prompts, cache_len, steps, patches=None):
    toks = jnp.asarray(prompts, jnp.int32)
    B, S = prompts.shape
    n_img = 0 if patches is None else patches.shape[1]
    prefill = jax.jit(lambda p, t, x: JM.prefill_lm(p, jc, t, cache_len,
                                                    patches=x))
    decode = jax.jit(lambda p, c, t, pos: JM.decode_lm(p, jc, c, t, pos))
    logits, caches = prefill(
        jparams, toks, None if patches is None else jnp.asarray(patches))
    out = [np.asarray(logits)]
    for i in range(steps):
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
        logits, caches = decode(jparams, caches, tok[:, None],
                                jnp.full((B,), n_img + S + i, jnp.int32))
        out.append(np.asarray(logits))
    return out


@functools.lru_cache(maxsize=None)
def _serve_case(name, arch, *, tasks=0, quant=None, biases=False,
                prompts=False, steps=3, cache_len=32, patches=False,
                traffic=False, n_kv_heads=None, vocab_size=None):
    """(the ranks' case, a thunk of JAX's results) of one serve case, made
    once a module: prompts/patches name the module's inputs."""
    kw = {k: v for k, v in (("n_kv_heads", n_kv_heads),
                            ("vocab_size", vocab_size)) if v is not None}
    prompts = PROMPTS[:, :prompts] if prompts else None
    patches = PATCHES if patches else None
    jc, pc = _cfg(arch, **kw)
    jparams = _params(jc, tasks, biases=biases)
    case = {"name": name, "cfg": pc, "tasks": tasks, "quant": quant,
            "params": [np_tree(p) for p in jparams]}
    if prompts is not None:
        case.update(prompts=prompts, steps=steps, cache_len=cache_len,
                    patches=patches)
    if traffic:
        case.update(traffic=_traffic(pc.vocab_size, tasks), num_slots=3,
                    max_len=MAX_LEN)

    @functools.lru_cache(maxsize=None)
    def want():
        out = {}
        if prompts is not None:
            out["logits"] = _jax_logits(jc, jparams[0], prompts, cache_len,
                                        steps, patches)
        if traffic:
            out["tokens"] = _jax_tokens(jc, jparams, case["traffic"], tasks,
                                        quant)
        return out
    return case, want


PROMPTS = np.random.RandomState(11).randint(0, 503, (2, 20))
PATCHES = np.random.RandomState(5).standard_normal((2, 4, 64)).astype(
    np.float32)
QWEN3 = [dict(name="qwen3", arch="qwen3-0.6b", n_kv_heads=4, vocab_size=512,
              prompts=20),
         dict(name="qwen3_bank", arch="qwen3-0.6b", tasks=3, n_kv_heads=4,
              vocab_size=512, traffic=True)]


def _served(shape, cases):
    """The ranks' results and JAX's: the world runs in a thread while
    JAX computes its side here."""
    made = [_serve_case(**c) for c in cases]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        outs = pool.submit(_world, shape, ranks.serve_cases,
                           [c for c, _ in made])
        wants = {c["name"]: want() for c, want in made}
        return outs.result(), wants


@pytest.fixture(scope="module")
def world_1x2():
    return _served((1, 2), QWEN3 + [
        dict(name="qwen3_int8", arch="qwen3-0.6b", quant="int8",
             n_kv_heads=4, vocab_size=512, traffic=True),
        dict(name="starcoder2", arch="starcoder2-7b", biases=True,
             prompts=20),
        dict(name="gemma2", arch="gemma2-27b", prompts=20, steps=6),
        dict(name="internvl2", arch="internvl2-76b", prompts=8,
             patches=True),
    ])


@pytest.fixture(scope="module")
def world_1x4():
    return _served((1, 4), QWEN3)


def _check(outs, wants, name, n_kv):
    for r, out in enumerate(outs):
        got = out[name]
        assert got["n_kv_heads"] == n_kv
        want = wants[name]
        for i, (g, w) in enumerate(zip(got.get("logits", []),
                                       want.get("logits", []))):
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0,
                                       err_msg=f"rank {r} logits {i}")
        for i, (g, w) in enumerate(zip(got.get("tokens", []),
                                       want.get("tokens", []))):
            np.testing.assert_array_equal(g, w, err_msg=f"rank {r} req {i}")
        assert len(got.get("tokens", [])) == len(want.get("tokens", []))


def test_qwen3_1x2_logits_and_bank_tokens_match_jax(world_1x2):
    outs, wants = world_1x2
    _check(outs, wants, "qwen3", 2)
    _check(outs, wants, "qwen3_bank", 2)
    # 2 all-reduces a layer (2 layers) and the vocab-parallel embedding;
    # one all-gather of the head's vocab columns
    colls = outs[0]["qwen3"]["prefill_colls"]
    assert colls["all-reduce"]["count"] == 2 * 2 + 1
    assert colls["all-gather"]["count"] == 1


def test_qwen3_1x4_logits_and_bank_tokens_match_jax(world_1x4):
    outs, wants = world_1x4
    assert len(outs) == 4
    _check(outs, wants, "qwen3", 1)
    _check(outs, wants, "qwen3_bank", 1)


def test_int8_trunk_is_quantized_whole_then_sliced(world_1x2):
    outs, wants = world_1x2
    _check(outs, wants, "qwen3_int8", 2)


def test_starcoder2_biases_are_added_once(world_1x2):
    outs, wants = world_1x2
    _check(outs, wants, "starcoder2", 1)


def test_gemma2_post_norm_seam_and_rings(world_1x2):
    outs, wants = world_1x2
    _check(outs, wants, "gemma2", 1)
    assert len(outs[0]["gemma2"]["logits"]) == 7  # past the 16-token ring


def test_internvl2_vlm_proj_is_gathered(world_1x2):
    outs, wants = world_1x2
    _check(outs, wants, "internvl2", 1)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _tiny(jc_kw=None):
    from conftest import tiny_cfg

    jc = tiny_cfg(**(jc_kw or {}))
    return jc, port_cfg(jc)


def _jax_init(jc, ocfg):
    state = jmake_state(KEY, jc, jpeft.strategy("hadamard"), ocfg)
    return state, np_tree(jmerged_params(state))


def _jax_train(jc, ocfg, state, batches):
    """JAX's losses, gradient norms and final parameters."""
    step = jax.jit(jbuild_train_step(jc, ocfg))
    losses, norms = [], []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, np_tree(jmerged_params(state))


def _trained(np_params, pc, paths):
    """The leaves at `paths` of JAX's parameters, in the port's layout."""
    port = dict(convert.tu.flatten_with_paths(
        convert.from_jax_params(np_params, pc, "cpu")))
    return {p: port[p].numpy() for p in paths}


def test_2x2_train_steps_match_jax_single_device():
    jc, pc = _tiny()
    jocfg = JOptimCfg(lr=1e-3, total_steps=4, grad_clip=1.0)
    ocfg = OptimCfg(lr=1e-3, total_steps=4, grad_clip=1.0)
    batches = list(lm_batches(lm_corpus(97, 4000, seed=1), 3, 8, 16,
                              seed=2))
    state, init = _jax_init(jc, jocfg)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        outs = pool.submit(_world, (2, 2), ranks.train_steps,
                           {"cfg": pc, "ocfg": ocfg, "params": init,
                            "batches": batches})
        jlosses, jnorms, jfinal = _jax_train(jc, jocfg, state, batches)
        outs = outs.result()
    want = _trained(jfinal, pc, outs[0]["adapters"])
    assert any("/adapter/" in p for p in want)
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["losses"], jlosses, rtol=2e-4)
        np.testing.assert_allclose(out["grad_norms"], jnorms, rtol=2e-4)
        assert set(out["adapters"]) == set(want)
        for p, w in want.items():
            np.testing.assert_allclose(out["adapters"][p], w, rtol=2e-4,
                                       atol=2e-6, err_msg=f"rank {r} {p}")


_JAX_MESH_STEP = r"""
import sys, numpy as np, jax
from jax.sharding import AxisType
from repro.common.types import OptimCfg
from repro.configs import get_smoke
from repro.core import peft
from repro.dist.api import use_mesh
from repro.train.steps import build_train_step, make_state, merged_params
from repro.common import tree as tu
d = np.load(sys.argv[1], allow_pickle=True)
cfg = peft.attach(get_smoke('deepseek-moe-16b'), peft.strategy('hadamard'))
ocfg = OptimCfg(lr=1e-3, total_steps=4, grad_clip=1.0)
mesh = jax.make_mesh((2, 1), ('data', 'model'),
                     axis_types=(AxisType.Auto, AxisType.Auto))
with use_mesh(mesh):
    state = make_state(jax.random.PRNGKey(0), cfg, peft.strategy('hadamard'),
                       ocfg)
    step = jax.jit(build_train_step(cfg, ocfg))
    losses, norms = [], []
    for b in d['batches']:
        state, m = step(state, b)
        losses.append(float(m['loss']))
        norms.append(float(m['grad_norm']))
out = {'losses': np.asarray(losses), 'grad_norms': np.asarray(norms)}
for p, v in tu.flatten_with_paths(merged_params(state)):
    out[p] = np.asarray(v)
np.savez(sys.argv[2], **out)
"""


def test_2x1_moe_step_routes_per_dp_shard_as_jax():
    jc = jpeft.attach(jget_smoke("deepseek-moe-16b"),
                      jpeft.strategy("hadamard"))
    pc = port_cfg(jc)
    batches = list(lm_batches(lm_corpus(jc.vocab_size, 4000, seed=1), 2, 4,
                              16, seed=2))
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        np.savez(src, batches=np.asarray(batches, dtype=object))
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                   XLA_FLAGS="--xla_force_host_platform_device_count=2",
                   JAX_PLATFORMS="cpu")
        proc = subprocess.Popen([sys.executable, "-c", _JAX_MESH_STEP, src,
                                 dst], env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        ocfg = OptimCfg(lr=1e-3, total_steps=4, grad_clip=1.0)
        state = jmake_state(KEY, jc, jpeft.strategy("hadamard"),
                            JOptimCfg(lr=1e-3, total_steps=4, grad_clip=1.0))
        outs = _world((2, 1), ranks.train_steps,
                      {"cfg": pc, "ocfg": ocfg,
                       "params": np_tree(jmerged_params(state)),
                       "batches": batches})
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        want = dict(np.load(dst))
    jlosses, jnorms = want.pop("losses"), want.pop("grad_norms")
    tree = {}
    for p, v in want.items():  # JAX's merged parameters, nested again
        convert._set(tree, p, v)
    want = _trained(tree, pc, outs[0]["adapters"])
    assert any("/adapter/" in p for p in want)
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["losses"], jlosses, rtol=2e-4)
        np.testing.assert_allclose(out["grad_norms"], jnorms, rtol=2e-4)
        for p, w in want.items():
            np.testing.assert_allclose(out["adapters"][p], w, rtol=2e-4,
                                       atol=2e-6, err_msg=f"rank {r} {p}")


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape,match", [
    ("deepseek-moe-16b", (1, 2), "expert parallelism"),
    ("rwkv6-1.6b", (1, 2), "RWKV6, RG-LRU, encdec and encoder"),
    ("recurrentgemma-2b", (1, 2), "RWKV6, RG-LRU, encdec and encoder"),
    ("whisper-tiny", (1, 2), "RWKV6, RG-LRU, encdec and encoder"),
    ("bert-base", (1, 2), "RWKV6, RG-LRU, encdec and encoder"),
    ("gemma2-27b", (2, 1), "FSDP under a tp_fsdp config"),
    ("qwen3-0.6b", (1, 4), "KV-head replication"),
])
def test_refusals_name_their_roadmap_item(arch, shape, match):
    from repro_torch.configs import get

    cfg = peft.attach(get(arch) if arch in ("gemma2-27b",) else
                      get_smoke(arch), peft.strategy("hadamard"))
    with pytest.raises(NotImplementedError, match=match) as e:
        S.local_cfg(cfg, Mesh(shape))
    assert "ROADMAP queue 1, 'Distribution' refusal" in str(e.value)
    # an engine built under such a mesh refuses before placing anything
    if arch == "qwen3-0.6b":
        with use_mesh(Mesh(shape, rank=0)), pytest.raises(
                NotImplementedError, match=match):
            ServeEngine(cfg, {}, device="cpu")


def test_a_rank_failure_is_raised_in_the_caller():
    with pytest.raises(RuntimeError, match="rank 1: ValueError: planted "
                       "failure on rank 1"):
        _world((1, 2), ranks.fail_on_rank, 1)
    assert _world((1, 2), ranks.fail_on_rank, 5) == [0, 1]
