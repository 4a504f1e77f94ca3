"""The port's sparse adapters (`repro_torch.sparse`) and the masked
multitask op (#9) against the JAX package.

The same weights, made by JAX with perturbed adapters and carried over by
`convert`, go through both packages: layer masks, importance, pruning and
packing, the shared-w factorization and its byte accounting must agree
exactly, leaf for leaf in the JAX layout (a per-layer port delta is
stacked by `convert.stack_delta`). The configs include one whose group
has two slots and one with two groups, where a stacked leaf's rows are
not consecutive layers. The plain #9 is held to the Pallas kernel in
interpret mode, and its autograd Function to `jax.vjp`. Hot-swap serving
of pruned and shared-w tenants is held to a static bank of the same
tenants (`test_torch_registry.py` holds it to the JAX hot-swap engine).
"""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from conftest import tiny_cfg
from repro.common import tree as jtu
from repro.common.types import Group as JGroup
from repro.common.types import Slot as JSlot
from repro.configs import get as jget
from repro.core import hadamard as jhad
from repro.core import patterns as jpatterns
from repro.core import peft as jpeft
from repro.kernels import ops as jops
from repro.models import model as JM
from repro.sparse import importance as jimp
from repro.sparse import prune as jprune
from repro.sparse import shared as jshared
from repro_torch import convert
from repro_torch.common import tree as tu
from repro_torch.configs import get
from repro_torch.core import hadamard as had
from repro_torch.core import peft
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sparse as tsparse
from repro_torch.kernels._build import full_vec
from repro_torch.kernels.sparse import MaskedMultitaskHadamard
from repro_torch.serving import (AdapterBank, AdapterRegistry,
                                 MultiTaskEngine, Request, ServingConfig,
                                 make_scheduler)
from repro_torch.sparse import importance as imp
from repro_torch.sparse import prune, shared
from test_torch_model import jax_cfg, np_tree, port_cfg

KEY = jax.random.PRNGKey(0)
CFGS = ["qwen3", "bert-tiny", "grouped"]


def cfgs(name):
    """(JAX config, port config) with the Hadamard adapter attached."""
    if name == "qwen3":
        jcfg = jax_cfg("qwen3-smoke")
    elif name == "bert-tiny":
        jcfg = jpeft.attach(jget("bert-tiny"), jpeft.strategy("hadamard"))
    else:  # 5 layers: a two-slot group of 2 repeats, then a one-slot group
        jcfg = tiny_cfg(groups=(JGroup((JSlot("attn"), JSlot("attn")), 2),
                                JGroup((JSlot("attn"),), 1)))
    return jcfg, port_cfg(jcfg)


def weights(jcfg, pcfg, seed=0, scale=0.3, leaves=("w", "b"), base=None):
    """Perturbed JAX params and their port copy."""
    base = JM.init_params(KEY, jcfg) if base is None else base
    jp = jhad.perturb_adapters(base, jax.random.fold_in(KEY, seed),
                               scale=scale, leaves=leaves)
    return jp, convert.from_jax_params(np_tree(jp), pcfg, "cpu")


def mixed_mask(L):
    """A layer mask that is neither a prefix nor a suffix."""
    m = np.zeros((L,), bool)
    m[1::2] = True
    m[-1] = True
    return m


def assert_same_tree(port_tree, jax_tree):
    """A JAX-layout port tree (torch leaves, port PackedRows) equals a JAX
    tree leaf for leaf, exactly."""
    got = {p: v for p, v in tu.flatten_with_paths(port_tree) if v is not None}
    want = dict(jtu.flatten_with_paths(jax_tree))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        if jprune.is_packed(w):
            assert prune.is_packed(g), path
            np.testing.assert_array_equal(g.mask.numpy(), w.mask, path)
            np.testing.assert_array_equal(g.rows.numpy(), w.rows, path)
            assert g.fill == w.fill
        else:
            np.testing.assert_array_equal(convert.to_numpy(g), np.asarray(w),
                                          err_msg=path)


def port_delta(pp, pcfg):
    return convert.stack_delta(had.extract_delta(pp), pcfg)


# ---------------------------------------------------------------------------
# masks, importance, gating
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CFGS)
def test_depth_topk_and_layer_ids_match_jax(name):
    jcfg, pcfg = cfgs(name)
    L = imp.n_layers(pcfg)
    assert L == jimp.n_layers(jcfg)
    for k in range(1, L + 1):
        np.testing.assert_array_equal(imp.depth_mask(pcfg, k),
                                      jimp.depth_mask(jcfg, k))
    rs = np.random.RandomState(1)
    scores = np.round(rs.rand(L), 1)  # ties break toward depth
    for k in range(1, L + 1):
        np.testing.assert_array_equal(imp.topk_mask(scores, k),
                                      jimp.topk_mask(scores, k))
    for bad in (0, L + 1):
        with pytest.raises(ValueError):
            imp.depth_mask(pcfg, bad)
    # a port layer leaf maps to its layer; a stacked leaf as in JAX
    _, pp = weights(jcfg, pcfg)
    for path, _ in tu.flatten_with_paths(pp):
        ids = imp.leaf_layer_ids(pcfg, path)
        if path.startswith("layers/"):
            assert ids.tolist() == [int(path.split("/")[1])]
            jids = jimp.leaf_layer_ids(jcfg, convert.jax_path(path, pcfg))
            assert ids[0] in jids.tolist()
        else:
            assert ids is None


@pytest.mark.parametrize("name", CFGS)
def test_importance_matches_jax(name):
    jcfg, pcfg = cfgs(name)
    tasks = [weights(jcfg, pcfg, seed=s) for s in range(3)]
    for jp, pp in tasks:
        np.testing.assert_allclose(imp.magnitude_importance(pp, pcfg),
                                   jimp.magnitude_importance(jp, jcfg),
                                   rtol=1e-6)
    np.testing.assert_allclose(
        imp.cross_task_importance({str(i): t[1] for i, t in
                                   enumerate(tasks)}, pcfg),
        jimp.cross_task_importance({str(i): t[0] for i, t in
                                    enumerate(tasks)}, jcfg), rtol=1e-6)
    # a layer bumped alone scores highest
    L = imp.n_layers(pcfg)
    only = np.zeros((L,), bool)
    only[L // 2] = True
    scores = imp.magnitude_importance(
        imp.apply_layer_mask(tasks[0][1], pcfg, only), pcfg)
    assert imp.topk_mask(scores, 1).tolist() == only.tolist()


@pytest.mark.parametrize("name", CFGS)
def test_apply_layer_mask_matches_jax(name):
    jcfg, pcfg = cfgs(name)
    jp, pp = weights(jcfg, pcfg)
    mask = mixed_mask(imp.n_layers(pcfg))
    got = convert.to_jax_params(imp.apply_layer_mask(pp, pcfg, mask), pcfg)
    assert_same_tree(convert.from_jax_delta(got),
                     np_tree(jimp.apply_layer_mask(jp, jcfg, mask)))
    masked = imp.apply_layer_mask(pp, pcfg, mask)
    for i, layer in enumerate(masked["layers"]):
        if not mask[i]:
            assert bool((layer["adapter"]["w"] == 1).all())
            assert bool((layer["adapter"]["b"] == 0).all())
        else:
            assert torch.equal(layer["adapter"]["w"],
                               pp["layers"][i]["adapter"]["w"])
    with pytest.raises(ValueError, match="mask shape"):
        imp.apply_layer_mask(pp, pcfg, mask[:-1])


@pytest.mark.parametrize("name", CFGS)
def test_mask_gate_and_gated_count_match_jax(name):
    jcfg, pcfg = cfgs(name)
    jp, pp = weights(jcfg, pcfg)
    mask = mixed_mask(imp.n_layers(pcfg))
    jgate = dict(jtu.flatten_with_paths(jimp.mask_gate(jp, jcfg, mask)))
    for path, g in tu.flatten_with_paths(imp.mask_gate(pp, pcfg, mask)):
        want = jgate[convert.jax_path(path, pcfg)]
        if path.startswith("layers/") and not isinstance(want, float):
            layer = int(path.split("/")[1])
            assert g == float(mask[layer]), path
        else:
            assert g == want, path
    for m in (mask, None, imp.depth_mask(pcfg, 1)):
        tmask = peft.trainable_mask(pp, peft.strategy("hadamard"), cfg=pcfg)
        jtmask = jpeft.trainable_mask(jp, jpeft.strategy("hadamard"))
        assert imp.gated_param_count(pp, tmask, imp.mask_gate(pp, pcfg, m)) \
            == jimp.gated_param_count(jp, jtmask, jimp.mask_gate(jp, jcfg, m))
    # a stacked leaf gets JAX's (repeats, 1) gate
    st = convert.stack_delta(had.extract_delta(pp), pcfg)
    sg = dict(tu.flatten_with_paths(imp.mask_gate(st, pcfg, mask)))
    for path, want in jgate.items():
        if path in sg and not isinstance(want, float):
            np.testing.assert_array_equal(sg[path].numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["qwen3", "bert-tiny"])
def test_preset_and_sparse_param_stats_match_jax(name):
    jcfg, pcfg = cfgs(name)
    jp, pp = weights(jcfg, pcfg)
    mask = prune.preset_mask(pcfg)
    np.testing.assert_array_equal(mask, jprune.preset_mask(jcfg))
    assert prune.sparse_param_stats(pp, pcfg, mask) == \
        jprune.sparse_param_stats(jp, jcfg, mask)
    with pytest.raises(KeyError, match="unknown prune preset"):
        prune.preset_mask(pcfg, "nope")


@pytest.mark.parametrize("arch,kept,L", [("qwen3-0.6b", 18, 28),
                                         ("bert-base", 8, 12)])
def test_paper_preset_keeps_the_top_two_thirds(arch, kept, L):
    mask = prune.preset_mask(get(arch), "paper-0.022")
    assert mask.shape == (L,) and mask.sum() == kept
    assert mask[L - kept:].all() and not mask[:L - kept].any()


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------


@settings(max_examples=25, deadline=None)
@given(repeats=st.integers(1, 6), d=st.integers(1, 16),
       seed=st.integers(0, 2**31 - 1), fill=st.sampled_from([0.0, 1.0]))
def test_pack_unpack_leaf_matches_jax(repeats, d, seed, fill):
    rs = np.random.RandomState(seed)
    leaf = rs.randn(repeats, d).astype(np.float32)
    keep = rs.rand(repeats) < 0.5
    pr = prune.pack_leaf(torch.from_numpy(leaf), keep, fill)
    jpr = jprune.pack_leaf(leaf, keep, fill)
    np.testing.assert_array_equal(pr.rows.numpy(), jpr.rows)
    np.testing.assert_array_equal(pr.mask.numpy(), jpr.mask)
    assert pr.shape == jpr.shape and pr.nbytes == jpr.nbytes
    dense = prune.unpack_leaf(pr)
    np.testing.assert_array_equal(dense.numpy(), jprune.unpack_leaf(jpr))
    back = prune.pack_leaf(dense, keep, fill)  # a fixed point
    assert torch.equal(back.rows, pr.rows) and torch.equal(back.mask, pr.mask)


def test_packed_rows_reject_non_fp32():
    for dt in (torch.int8, torch.float16, torch.bfloat16):
        with pytest.raises(ValueError, match="fp32"):
            prune.PackedRows(np.array([True]), torch.zeros((1, 4), dtype=dt),
                             0.0)
    with pytest.raises(ValueError, match="kept rows"):
        prune.PackedRows(np.array([True, True]), torch.zeros((1, 4)), 0.0)


@pytest.mark.parametrize("name", CFGS)
def test_prune_delta_and_delta_mask_match_jax(name):
    jcfg, pcfg = cfgs(name)
    jp, pp = weights(jcfg, pcfg)
    mask = mixed_mask(imp.n_layers(pcfg))
    delta = port_delta(pp, pcfg)
    assert_same_tree(delta, np_tree(jhad.extract_delta(jp)))
    sp = prune.prune_delta(had.extract_delta(pp), pcfg, mask)
    jsp = jprune.prune_delta(jhad.extract_delta(jp), jcfg, mask)
    assert_same_tree(sp, jsp)
    assert_same_tree(prune.pack_delta(
        imp.apply_layer_mask(delta, pcfg, mask), pcfg, mask), jsp)
    np.testing.assert_array_equal(prune.delta_mask(sp, pcfg), mask)
    np.testing.assert_array_equal(prune.delta_mask(sp, pcfg),
                                  jprune.delta_mask(jsp, jcfg))
    assert prune.delta_mask(delta, pcfg).all()
    assert prune.delta_mask(had.extract_delta(pp), pcfg).all()
    assert_same_tree(prune.unpack_delta(sp), jprune.unpack_delta(jsp))
    # the port's packed delta carried back to JAX is JAX's own
    back = convert.to_jax_delta(sp, packed=jprune.PackedRows)
    np.testing.assert_array_equal(jprune.delta_mask(back, jcfg), mask)
    assert_same_tree(convert.from_jax_delta(back), jsp)
    with pytest.raises(ValueError, match="packed="):
        convert.to_jax_delta(sp)
    assert prune.packed_bytes(sp) == jprune.packed_bytes(jsp) \
        < prune.packed_bytes(delta) == jprune.packed_bytes(
            jhad.extract_delta(jp))
    # the per-layer tree comes back from the JAX layout unchanged
    back = convert.unstack_delta(prune.unpack_delta(delta), pcfg)
    for path, v in tu.flatten_with_paths(had.extract_delta(pp)):
        if v is not None:
            assert torch.equal(dict(tu.flatten_with_paths(back))[path], v)


def test_prune_delta_accepts_packed_input_and_mask_guard():
    jcfg, pcfg = cfgs("grouped")
    _, pp = weights(jcfg, pcfg)
    delta = had.extract_delta(pp)
    L = imp.n_layers(pcfg)
    once = prune.prune_delta(delta, pcfg, np.ones((L,), bool))
    again = prune.prune_delta(once, pcfg, mixed_mask(L))
    np.testing.assert_array_equal(prune.delta_mask(again, pcfg), mixed_mask(L))
    want = imp.apply_layer_mask(convert.stack_delta(delta, pcfg), pcfg,
                                mixed_mask(L))
    for (pa, a), (_, b) in zip(tu.flatten_with_paths(prune.unpack_delta(
            again)), tu.flatten_with_paths(want)):
        if a is not None:
            assert torch.equal(a, b), pa
    with pytest.raises(ValueError, match="unpack_delta"):
        imp.apply_layer_mask(once, pcfg, mixed_mask(L))
    assert shared.factorize({"a": once, "b": once}, pcfg).tasks == ["a", "b"]


def test_packed_delta_store_round_trip():
    from repro_torch.checkpoint.store import load_tree, save_tree

    jcfg, pcfg = cfgs("grouped")
    _, pp = weights(jcfg, pcfg)
    sp = prune.prune_delta(had.extract_delta(pp), pcfg,
                           mixed_mask(imp.n_layers(pcfg)))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "sp.ckpt")
        save_tree(path, sp, metadata={"k": 1})
        back, meta = load_tree(path)
    assert meta == {"k": 1}
    flat_a = {p: v for p, v in tu.flatten_with_paths(sp) if v is not None}
    flat_b = dict(tu.flatten_with_paths(back))
    assert set(flat_a) == set(flat_b)
    for path, a in flat_a.items():
        b = flat_b[path]
        if prune.is_packed(a):
            assert torch.equal(a.mask, b.mask) and torch.equal(a.rows, b.rows)
            assert a.fill == b.fill
        else:
            assert torch.equal(a, b), path


# ---------------------------------------------------------------------------
# shared-w factorization
# ---------------------------------------------------------------------------


def shared_world(name, n_tasks=3, scale=0.2):
    """(jcfg, pcfg, JAX base, port base, [(JAX variant, port variant)]):
    one w perturbation shared by every task, then a b per task."""
    jcfg, pcfg = cfgs(name)
    jbase = JM.init_params(KEY, jcfg)
    stem = jhad.perturb_adapters(jbase, jax.random.fold_in(KEY, 7),
                                 leaves=("w",), scale=scale)
    variants = [weights(jcfg, pcfg, seed=100 + t, scale=scale, leaves=("b",),
                        base=stem) for t in range(n_tasks)]
    return (jcfg, pcfg, jbase,
            convert.from_jax_params(np_tree(jbase), pcfg, "cpu"), variants)


@pytest.mark.parametrize("masked", [False, True])
def test_factorize_task_row_and_overlay_match_jax(masked):
    jcfg, pcfg, jbase, pbase, variants = shared_world("grouped")
    mask = mixed_mask(imp.n_layers(pcfg)) if masked else None
    sa = shared.factorize({f"t{i}": had.extract_delta(v[1])
                           for i, v in enumerate(variants)}, pcfg, mask=mask)
    jsa = jshared.factorize({f"t{i}": jhad.extract_delta(v[0])
                             for i, v in enumerate(variants)}, jcfg, mask=mask)
    assert sa.tasks == jsa.tasks
    assert_same_tree(sa.w, jsa.w)
    for t in sa.tasks:
        assert_same_tree(sa.b[t], jsa.b[t])
        assert_same_tree(shared.task_row(sa, t), jshared.task_row(jsa, t))
        assert sa.bytes_b(t) == jsa.bytes_b(t)
    assert sa.bytes_w() == jsa.bytes_w()
    got = convert.to_jax_params(shared.shared_w_overlay(pbase, sa, pcfg), pcfg)
    assert_same_tree(convert.from_jax_delta(got),
                     np_tree(jshared.shared_w_overlay(jbase, jsa)))


def test_shared_w_bank_rows_and_clamping_gather_match_jax():
    """Tenants written into a shared-w bank skip its one w row, and
    `select_tasks` clamps every id into that row, as in JAX."""
    jcfg, pcfg, jbase, pbase, variants = shared_world("grouped")
    jbank = jhad.init_bank(jbase, 3, shared_w=True)
    pbank = had.init_bank(pbase, 3, shared_w=True)
    for t, (jv, pv) in enumerate(variants):
        jbank = jhad.insert_bank_row(jbank, jhad.adapter_row(
            jhad.extract_delta(jv)), t, skip=jhad.SHARED_W_RE)
        had.insert_bank_row(pbank, had.adapter_row(had.extract_delta(pv)),
                            t, skip=had.SHARED_W_RE)
    ids = [2, 0, 1, 2]
    got = convert.to_jax_params(had.select_tasks(pbank, torch.tensor(ids)),
                                pcfg)
    want = np_tree(jhad.select_tasks(jbank, jnp.asarray(ids)))
    assert_same_tree(convert.from_jax_delta(got), want)
    w = dict(jtu.flatten_with_paths(want))["blocks/g0/slot0/adapter/w"]
    assert (np.asarray(w) == np.asarray(w)[:, :1]).all()  # one row, shared


def test_from_vectors_matches_jax_suggest_shared_weight():
    jcfg, pcfg, _, _, variants = shared_world("grouped")
    sw, per_b = jpatterns.suggest_shared_weight(
        {f"t{i}": v[0] for i, v in enumerate(variants)}, jcfg)
    mask = mixed_mask(imp.n_layers(pcfg))
    for m in (None, mask):
        sa = shared.from_vectors(sw, per_b, had.extract_delta(variants[0][1]),
                                 pcfg, mask=m)
        jsa = jshared.from_vectors(sw, per_b,
                                   jhad.extract_delta(variants[0][0]), jcfg,
                                   mask=m)
        assert_same_tree(sa.w, jsa.w)
        for t in jsa.tasks:
            assert_same_tree(sa.b[t], jsa.b[t])


def test_shared_adapter_save_load_is_jax_byte_for_byte(monkeypatch):
    import repro.checkpoint.store as jstore

    monkeypatch.setattr(jstore, "zstandard", None)  # zlib, as the port
    jcfg, pcfg, _, _, variants = shared_world("grouped")
    mask = mixed_mask(imp.n_layers(pcfg))
    sa = shared.factorize({f"t{i}": had.extract_delta(v[1])
                           for i, v in enumerate(variants)}, pcfg, mask=mask)
    jsa = jshared.factorize({f"t{i}": jhad.extract_delta(v[0])
                             for i, v in enumerate(variants)}, jcfg, mask=mask)
    with tempfile.TemporaryDirectory() as d:
        shared.save_shared(os.path.join(d, "p.ckpt"), sa)
        jshared.save_shared(os.path.join(d, "j.ckpt"), jsa)
        with open(os.path.join(d, "p.ckpt"), "rb") as f:
            pbytes = f.read()
        with open(os.path.join(d, "j.ckpt"), "rb") as f:
            assert f.read() == pbytes
        back = shared.load_shared(os.path.join(d, "j.ckpt"))
        from repro_torch.checkpoint.store import save_tree

        save_tree(os.path.join(d, "other.ckpt"), {"x": torch.zeros(2)})
        with pytest.raises(ValueError, match="shared-adapter"):
            shared.load_shared(os.path.join(d, "other.ckpt"))
    assert back.tasks == sa.tasks
    np.testing.assert_array_equal(back.mask, mask)
    assert_same_tree(shared.task_row(back, "t1"), jshared.task_row(jsa, "t1"))


@pytest.mark.parametrize("masked", [False, True])
def test_bank_bytes_report_matches_jax(masked):
    jcfg, pcfg, _, _, variants = shared_world("qwen3")
    mask = prune.preset_mask(pcfg) if masked else None
    rep = shared.bank_bytes_report(pcfg, port_delta(variants[0][1], pcfg), 8,
                                   mask=mask)
    assert rep == jshared.bank_bytes_report(
        jcfg, jhad.extract_delta(variants[0][0]), 8, mask=mask)
    if not masked:
        assert rep["marginal_reduction"] == pytest.approx(2.0)
        assert rep["total_reduction"] == pytest.approx(16 / 9)


# ---------------------------------------------------------------------------
# the masked multitask op (#9): plain version and autograd Function
# ---------------------------------------------------------------------------


def op_inputs(B, S, d, Tw, Tb, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, S, d).astype(np.float32)
    wb = (1 + 0.1 * rs.randn(Tw, d)).astype(np.float32)
    bb = (0.1 * rs.randn(Tb, d)).astype(np.float32)
    gate = (np.arange(Tb) % 2 == 0).astype(np.float32)
    gate[rs.rand(Tb) < 0.3] = 0.0
    tids = (np.arange(B) * 7 % Tb).astype(np.int32)
    return x, wb, bb, gate, tids


@pytest.mark.parametrize("B,S,d,Tw,Tb", [(3, 4, 8, 5, 5), (2, 1, 16, 2, 2),
                                         (4, 3, 12, 1, 3), (5, 2, 8, 1, 4)])
def test_plain_masked_op_matches_the_pallas_kernel(B, S, d, Tw, Tb):
    """Tw == 1 is a shared-w bank: each id is clamped into the one w row,
    as the serving path's gather clamps it."""
    x, wb, bb, gate, tids = op_inputs(B, S, d, Tw, Tb)
    got = ref.masked_multitask_hadamard_ref(*map(torch.from_numpy,
                                                 (x, wb, bb, gate, tids)))
    want = jops.masked_multitask_hadamard(
        jnp.asarray(x), jnp.asarray(wb), jnp.asarray(bb), jnp.asarray(gate),
        jnp.asarray(tids), impl="interpret")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(ops.masked_multitask_hadamard(
        *map(torch.from_numpy, (x, wb, bb, gate, tids))), got)


def test_masked_op_gates_reduce_to_multitask_and_identity():
    x, wb, bb, _, tids = map(torch.from_numpy, op_inputs(4, 3, 8, 3, 3))
    ones, zeros = torch.ones(3), torch.zeros(3)
    torch.testing.assert_close(
        ops.masked_multitask_hadamard(x, wb, bb, ones, tids),
        ops.multitask_hadamard(x, wb, bb, tids), rtol=1e-6, atol=1e-6)
    assert torch.equal(ops.masked_multitask_hadamard(x, wb, bb, zeros, tids),
                       x)
    xb = x.to(torch.bfloat16)  # fp32 math, one rounding to x.dtype
    yb = ops.masked_multitask_hadamard(xb, wb, bb, ones, tids)
    assert yb.dtype == torch.bfloat16
    assert torch.equal(yb, ref.masked_multitask_hadamard_ref(
        xb.float(), wb, bb, ones, tids).to(torch.bfloat16))


# #9's plan: the launch of masked_multitask_hadamard.cu from shapes alone
MASKED_SHAPES = [(4, 1, 1024), (1, 128, 1024), (4, 1, 2048), (1, 128, 2048),
                 (4, 5, 1000), (2, 3, 999), (7, 1, 768), (1, 4096, 768),
                 (3, 4, 8), (2, 128, 1024), (2, 128, 2048)]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", MASKED_SHAPES)
def test_masked_plan_covers_every_element_once(shape, dtype, aligned):
    """What the C entry point checks before it launches the plan as it
    is: whole vectors within a row, and each request's blocks (blocks / B
    along x) covering its S*d elements once, none wholly idle."""
    B, S, d = shape
    dt = getattr(torch, dtype)
    plan = tsparse.masked_plan(B, S, d, dt, aligned)
    vec, threads, blocks = plan["vec"], plan["threads"], plan["blocks"]
    assert vec == (full_vec(dt) if aligned and d % full_vec(dt) == 0 else 1)
    assert d % vec == 0
    assert threads % 32 == 0 and 32 <= threads <= tsparse.MAX_THREADS
    assert blocks % B == 0
    per, vecs = blocks // B, S * d // vec
    assert per * threads >= vecs and (per - 1) * threads < vecs


@pytest.mark.parametrize("shape,dtype,want", [
    ((4, 1, 1024), "bfloat16", dict(vec=8, threads=128, blocks=4)),
    ((1, 128, 1024), "bfloat16", dict(vec=8, threads=128, blocks=128)),
    ((4, 1, 1024), "float32", dict(vec=4, threads=256, blocks=4)),
    ((4, 1, 2048), "bfloat16", dict(vec=8, threads=256, blocks=4)),
    ((1, 128, 2048), "bfloat16", dict(vec=8, threads=256, blocks=128)),
    ((2, 128, 1024), "bfloat16", dict(vec=8, threads=128, blocks=256)),
    ((2, 3, 999), "bfloat16", dict(vec=1, threads=256, blocks=24))])
def test_masked_plan_sizes_the_served_shapes(shape, dtype, want):
    """A decode tick: a block a request, a thread a 16-byte vector; a
    128-token prefill: about one block an SM."""
    assert tsparse.masked_plan(*shape, getattr(torch, dtype)) == want


# #6 (kernels/multitask.py) launches #9's plan: the shapes both serve, a
# ragged width and x off the 16-byte grid
WRAPPER_SHAPES = [((4, 1, 1024), "bfloat16", True),
                  ((4, 1, 2048), "bfloat16", True),
                  ((1, 128, 1024), "bfloat16", True),
                  ((1, 128, 2048), "bfloat16", True),
                  ((4, 1, 1024), "float32", True),
                  ((2, 3, 999), "bfloat16", True),
                  ((4, 1, 1024), "bfloat16", False)]


@pytest.mark.parametrize("shape,dtype,aligned", WRAPPER_SHAPES)
@pytest.mark.parametrize("wrapper", ["masked_multitask_hadamard",
                                     "multitask_hadamard"])
def test_both_wrappers_launch_the_masked_plan(monkeypatch, wrapper, shape,
                                              dtype, aligned):
    """What each wrapper hands its C entry point: masked_plan's vec,
    threads and blocks, with vec = 1 where x starts off the 16-byte grid."""
    from repro_torch.kernels import multitask as tmt

    mod = tsparse if wrapper == "masked_multitask_hadamard" else tmt
    launched = []
    monkeypatch.setattr(mod, "check_inputs", lambda *a, **k: None)
    monkeypatch.setattr(mod, "launch", lambda *a: launched.append(a))
    B, S, d = shape
    dt = getattr(torch, dtype)
    x = torch.zeros(B * S * d + 1, dtype=dt)[0 if aligned else 1:]
    x = x[:B * S * d].view(B, S, d)
    banks = (torch.ones(3, d), torch.zeros(3, d))
    ids = torch.zeros(B, dtype=torch.int32)
    if mod is tsparse:
        tsparse.masked_multitask_hadamard(x, *banks, torch.ones(3), ids)
    else:
        tmt.multitask_hadamard(x, *banks, ids)
    (args,) = launched
    assert args[0] == wrapper
    assert dict(zip(("vec", "threads", "blocks"), args[-3:])) \
        == tsparse.masked_plan(B, S, d, dt, aligned)


def test_masked_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tsparse.masked_multitask_hadamard(
            torch.zeros(1, 2, 8), torch.ones(2, 8), torch.zeros(2, 8),
            torch.ones(2), torch.zeros(1, dtype=torch.int32))


def test_masked_function_gradients_match_jax_vjp():
    x, wb, bb, gate, tids = op_inputs(3, 4, 8, 4, 4, seed=2)
    gate = np.asarray([1.0, 0.0, 1.0, 0.0], np.float32)
    tids = np.asarray([0, 1, 3], np.int32)
    dy = np.random.RandomState(3).randn(*x.shape).astype(np.float32)

    def f(xx, ww, bbb):
        return jops.masked_multitask_hadamard(xx, ww, bbb, jnp.asarray(gate),
                                              jnp.asarray(tids),
                                              impl="interpret")

    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(wb), jnp.asarray(bb))
    want = vjp(jnp.asarray(dy))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, wb, bb)]
    y = MaskedMultitaskHadamard.apply(*leaves, torch.from_numpy(gate),
                                      torch.from_numpy(tids), "auto")
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    assert (got[1][1] == 0).all() and (got[2][3] == 0).all()  # gated off
    # the backward takes the Pallas VJP's shapes only
    ys = MaskedMultitaskHadamard.apply(
        leaves[0], leaves[1][:1], leaves[2], torch.from_numpy(gate),
        torch.from_numpy(tids), "auto")
    with pytest.raises(ValueError, match="one row count"):
        ys.sum().backward()


# ---------------------------------------------------------------------------
# serving pruned and shared-w tenants
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def serving_world():
    """One qwen3 smoke backbone, 4 tenants in a shared-w world: tasks 0
    and 1 dense, 2 and 3 pruned to the top layer and published packed;
    a dense registry and a shared-w registry (each tenant publishes its
    factorized row), static oracles over the same tenants."""
    jcfg, pcfg, _, pbase, variants = shared_world("qwen3", n_tasks=4)
    mask = imp.depth_mask(pcfg, 1)
    served = [v[1] if t < 2 else imp.apply_layer_mask(v[1], pcfg, mask)
              for t, v in enumerate(variants)]
    td = tempfile.TemporaryDirectory()
    registry = AdapterRegistry(os.path.join(td.name, "dense"))
    for t, v in enumerate(served):
        delta = port_delta(v, pcfg)
        registry.publish(f"task{t}", delta if t < 2 else
                         prune.prune_delta(delta, pcfg, mask))
    sa = shared.factorize({f"task{t}": had.extract_delta(v)
                           for t, v in enumerate(served)}, pcfg)
    sreg = AdapterRegistry(os.path.join(td.name, "shared"))
    for t in range(4):
        sreg.publish(f"task{t}", shared.task_row(sa, f"task{t}"))
    rows = [convert.unstack_delta(shared.task_row(sa, f"task{t}"), pcfg)
            for t in range(4)]
    shared_served = [had.apply_delta(v, r) for v, r in zip(served, rows)]
    yield dict(
        pcfg=pcfg, mask=mask, registry=registry,
        oracle=MultiTaskEngine(pcfg, served, device="cpu"),
        hot=MultiTaskEngine(pcfg, AdapterBank(pcfg, pbase, 2, registry),
                            device="cpu"),
        shared_oracle=MultiTaskEngine(pcfg, shared_served, device="cpu"),
        shared_hot=MultiTaskEngine(
            pcfg, AdapterBank(pcfg, shared.shared_w_overlay(pbase, sa, pcfg),
                              2, sreg, shared_w=True), device="cpu"))
    td.cleanup()


def serve(engine, reqs, slots=2):
    done, _ = make_scheduler(engine, ServingConfig(
        num_slots=slots, max_len=32)).run(reqs)
    return [c.tokens for c in done]


def test_bank_serves_packed_rows_token_exact_and_gates_them(serving_world):
    w = serving_world
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, w["pcfg"].vocab_size, (6,)) for _ in range(8)]
    want = serve(w["oracle"], [Request(prompt=p, max_new_tokens=5,
                                       task_id=i % 4)
                               for i, p in enumerate(prompts)])
    got = serve(w["hot"], [Request(prompt=p, max_new_tokens=5,
                                   adapter=f"task{i % 4}")
                           for i, p in enumerate(prompts)])
    for g, t in zip(got, want):
        np.testing.assert_array_equal(g, t)
    bank = w["hot"].adapter_bank
    bank.lookup("task2")
    np.testing.assert_array_equal(bank.mask_of("task2"), w["mask"])
    assert bank.mask_of("missing") is None
    gates = bank.gates()
    assert gates.shape == (2, 2)
    np.testing.assert_array_equal(gates, bank.gate_tensor.numpy())
    np.testing.assert_array_equal(gates[:, bank.row_of("task2")],
                                  w["mask"].astype(np.float32))


def test_shared_w_bank_serves_factorized_tenants(serving_world):
    w = serving_world
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, w["pcfg"].vocab_size, (5,)) for _ in range(4)]
    want = serve(w["shared_oracle"], [Request(prompt=p, max_new_tokens=4,
                                              task_id=t)
                                      for t, p in enumerate(prompts)])
    got = serve(w["shared_hot"], [Request(prompt=p, max_new_tokens=4,
                                          adapter=f"task{t}")
                                  for t, p in enumerate(prompts)])
    for g, t in zip(got, want):
        np.testing.assert_array_equal(g, t)
    dense_b = w["hot"].adapter_bank.adapter_bytes()
    shared_b = w["shared_hot"].adapter_bank.adapter_bytes()
    assert w["shared_hot"].adapter_bank.shared_w
    assert dense_b / (dense_b - shared_b) == pytest.approx(4.0)  # T=2 rows


@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_fuzz_mixed_sparse_dense_vs_static_bank(serving_world,
                                                          seed):
    """Random arrivals, budgets and EOS over the 2-row bank (evictions and
    reloads mid-stream) give the static bank's tokens."""
    w = serving_world
    rs = np.random.RandomState(800 + seed)
    V = w["pcfg"].vocab_size
    reqs, wants = [], []
    for _ in range(8):
        plen, budget, task = rs.randint(2, 9), rs.randint(1, 7), rs.randint(4)
        prompt = rs.randint(0, V, size=(plen,))
        ref_toks = w["oracle"].generate(prompt[None], budget,
                                        task_ids=[task])[0]
        eos = int(ref_toks[rs.randint(0, budget)]) if rs.rand() < 0.3 \
            else None
        if eos is not None:
            ref_toks = ref_toks[:np.flatnonzero(ref_toks == eos)[0] + 1]
        reqs.append((rs.randint(0, 6), Request(
            prompt=prompt, max_new_tokens=budget, adapter=f"task{task}",
            eos_id=eos)))
        wants.append(ref_toks)
    sched = make_scheduler(w["hot"], ServingConfig(num_slots=2, max_len=32))
    ids, t = [None] * len(reqs), 0
    while None in ids or sched.pending or sched.active:
        for i, (arrival, r) in enumerate(reqs):
            if ids[i] is None and arrival <= t:
                ids[i] = sched.submit(r)
        sched.step()
        t += 1
        assert t < 300, "the episode did not drain"
    for i, rid in enumerate(ids):
        np.testing.assert_array_equal(sched.completions.pop(rid).tokens,
                                      wants[i], err_msg=f"req {i}")
    bank = w["hot"].adapter_bank
    assert bank.loads >= 3 and bank.evictions >= 1
    assert all(bank.pins(n) == 0 for n in bank.resident)


def test_wrong_arch_packed_delta_fails_loud_validation():
    jcfg, pcfg = cfgs("qwen3")
    _, pbase = weights(jcfg, pcfg)
    jbig = tiny_cfg(groups=(JGroup((JSlot("attn"),), 4),))
    big = port_cfg(jbig)
    _, alien = weights(jbig, big)
    with tempfile.TemporaryDirectory() as d:
        registry = AdapterRegistry(d)
        registry.publish("alien", prune.prune_delta(
            had.extract_delta(alien), big, imp.depth_mask(big, 2)))
        eng = MultiTaskEngine(pcfg, AdapterBank(pcfg, pbase, 2, registry),
                              device="cpu")
        with pytest.raises(ValueError, match="does not fit bank"):
            eng.acquire_adapter("alien")
    assert eng.adapter_bank.resident == []


def test_shared_w_bank_rejects_deviant_tenant_w():
    jcfg, pcfg, _, pbase, variants = shared_world("qwen3")
    sa = shared.factorize({f"t{i}": had.extract_delta(v[1])
                           for i, v in enumerate(variants)}, pcfg)
    with tempfile.TemporaryDirectory() as d:
        registry = AdapterRegistry(d)
        registry.publish("ok", port_delta(variants[0][1], pcfg))
        deviant = had.perturb_adapters(variants[0][1], 999, scale=1.0,
                                       leaves=("w",))
        registry.publish("deviant", port_delta(deviant, pcfg))
        bank = AdapterBank(pcfg, shared.shared_w_overlay(pbase, sa, pcfg), 2,
                           registry, shared_w=True)
        bank.lookup("ok")  # the stem w: accepted
        with pytest.raises(ValueError, match="deviates from the bank's shared"):
            bank.acquire("deviant")
    assert "deviant" not in bank.resident  # nothing half-written
    # the shared w row was never written by a tenant
    for path, leaf in tu.flatten_with_paths(bank.tree):
        if path.endswith("adapter/w"):
            assert leaf.shape[0] == 1
