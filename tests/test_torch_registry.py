"""The port's checkpoint store, adapter registry and hot-swap bank against
the JAX package.

The port writes the JAX package's checkpoint format with its own msgpack
codec: the codec's bytes equal `msgpack.packb(..., use_bin_type=True)`,
a tree (PackedRows and bf16 leaves included) written by either package
reads in the other and the two files are the same bytes. JAX's writer
takes zstd where `zstandard` is installed, which the port cannot read;
the tests that let JAX write for the port take JAX's zlib path (the one it
takes where `zstandard` is absent). The registry and bank keep JAX's
behaviours (versions, GC, LRU, pins, invalidation, gates, shared-w
refusal), and a tenant published by either package serves from the other
token for token, through runtime add, eviction and removal, with logits
within 1e-4 at fp32.
"""
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

import repro.checkpoint.store as jstore
from repro.core import hadamard as jhad
from repro.models import model as JM
from repro.quant.qtensor import QTensor as JQTensor
from repro.serving import MultiTaskEngine as JMultiTaskEngine
from repro.serving import Request as JRequest
from repro.serving import ServingConfig as JServingConfig
from repro.serving import make_scheduler as jmake_scheduler
from repro.serving.registry import AdapterBank as JAdapterBank
from repro.serving.registry import AdapterRegistry as JAdapterRegistry
from repro.sparse import importance as jimp
from repro.sparse import prune as jprune
from repro.sparse import shared as jshared
from repro_torch import convert
from repro_torch.checkpoint import _msgpack
from repro_torch.checkpoint.store import load_tree, save_tree
from repro_torch.common import tree as tu
from repro_torch.core import hadamard as had
from repro_torch.launch import serve as launcher
from repro_torch.quant.qtensor import QTensor
from repro_torch.serving import (AdapterBank, AdapterRegistry, BankFullError,
                                 MultiTaskEngine, Request, ServeEngine,
                                 ServingConfig, make_scheduler)
from repro_torch.sparse import importance as imp
from repro_torch.sparse import prune, shared
from test_torch_model import jax_cfg, np_tree, port_cfg
from test_torch_sparse import assert_same_tree

ROOT = Path(__file__).resolve().parents[1]
KEY = jax.random.PRNGKey(0)


@pytest.fixture
def jax_zlib(monkeypatch):
    """JAX's store writes zlib, as it does where `zstandard` is absent."""
    monkeypatch.setattr(jstore, "zstandard", None)


@pytest.fixture(scope="module")
def world():
    """The qwen3 smoke backbone (JAX and port copies), 4 JAX task variants
    and their port copies, and a port registry of all four."""
    jcfg = jax_cfg("qwen3-smoke")
    pcfg = port_cfg(jcfg)
    jbase = JM.init_params(KEY, jcfg)
    jvars = [jhad.perturb_adapters(jbase, jax.random.fold_in(KEY, t),
                                   scale=0.2) for t in range(4)]
    pvars = [convert.from_jax_params(np_tree(v), pcfg, "cpu") for v in jvars]
    td = tempfile.TemporaryDirectory()
    registry = AdapterRegistry(td.name)
    for t, v in enumerate(pvars):
        registry.publish(f"task{t}", launcher.task_delta(v, pcfg))
    yield dict(jcfg=jcfg, pcfg=pcfg, jbase=jbase,
               pbase=convert.from_jax_params(np_tree(jbase), pcfg, "cpu"),
               jvars=jvars, pvars=pvars, registry=registry)
    td.cleanup()


def delta(w, t):
    return launcher.task_delta(w["pvars"][t], w["pcfg"])


# ---------------------------------------------------------------------------
# the msgpack codec and the store
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 127, 128, 255, 256, 65535, 65536,
                                  2**32 - 1, 2**32, -1, -32, -33, -129,
                                  -40000])
def test_codec_bytes_equal_msgpack_for_the_envelope(step):
    env = {"meta": {"name": "task0", "step": step, "ratio": 0.25,
                    "tasks": ["a", "b" * 40], "mask": [True, False],
                    "none": None},
           "arrays": {f"blocks/g0/slot0/adapter/w/{i}": {
               "dtype": "float32", "shape": [28, 1024],
               "data": bytes(range(256)) * n}
               for i, n in enumerate((0, 1, 300))}}
    packed = _msgpack.packb(env)
    assert packed == msgpack.packb(env, use_bin_type=True)
    assert _msgpack.unpackb(packed) == msgpack.unpackb(packed, raw=False)


def jax_and_port_trees(world):
    """One tree in both packages: a packed sparse delta, a bf16 leaf, a
    bool leaf and an int8 QTensor, with an empty leaf."""
    jcfg, pcfg = world["jcfg"], world["pcfg"]
    mask = imp.depth_mask(pcfg, 1)
    jsp = jprune.prune_delta(jhad.extract_delta(world["jvars"][0]), jcfg,
                             mask)
    psp = prune.prune_delta(had.extract_delta(world["pvars"][0]), pcfg, mask)
    rs = np.random.RandomState(0)
    bf = rs.randn(3, 5).astype(np.float32)
    vals = rs.randint(-127, 128, (4, 6)).astype(np.int8)
    scales = rs.rand(1, 6).astype(np.float32)
    extra_j = {"emb": jnp.asarray(bf, jnp.bfloat16),
               "flags": np.array([True, False]),
               "q": JQTensor(vals, scales), "empty": np.zeros((0, 4),
                                                              np.float32)}
    extra_p = {"emb": torch.from_numpy(bf).to(torch.bfloat16),
               "flags": torch.tensor([True, False]),
               "q": QTensor(torch.from_numpy(vals), torch.from_numpy(scales)),
               "empty": torch.zeros((0, 4))}
    return dict(jsp, extra=extra_j), dict(psp, extra=extra_p)


def test_store_files_are_jax_byte_for_byte_both_ways(world, jax_zlib):
    jtree, ptree = jax_and_port_trees(world)
    meta = {"name": "task0", "step": 300}
    with tempfile.TemporaryDirectory() as d:
        jpath, ppath = os.path.join(d, "j.ckpt"), os.path.join(d, "p.ckpt")
        jstore.save_tree(jpath, jtree, metadata=meta)
        save_tree(ppath, ptree, metadata=meta)
        with open(jpath, "rb") as f, open(ppath, "rb") as g:
            assert f.read() == g.read()
        got, gmeta = load_tree(jpath)  # JAX's file in the port
        back, bmeta = jstore.load_tree(ppath)  # the port's file in JAX
    assert gmeta == bmeta == meta
    gq, bq, jq = got["extra"].pop("q"), back["extra"].pop("q"), \
        jtree["extra"]["q"]
    assert isinstance(gq, QTensor) and isinstance(bq, JQTensor)
    for g, b_, j in ((gq.values, bq.values, jq.values),
                     (gq.scales, bq.scales, jq.scales)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
        np.testing.assert_array_equal(np.asarray(b_), np.asarray(j))
    assert got["extra"]["emb"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["extra"]["emb"].float().numpy(),
                                  np.asarray(jtree["extra"]["emb"],
                                             np.float32))
    assert back["extra"]["emb"].dtype == np.asarray(jtree["extra"]["emb"]
                                                    ).dtype
    assert got["extra"]["flags"].tolist() == [True, False]
    assert tuple(got["extra"]["empty"].shape) == (0, 4)

    def adapters(t):
        return {k: v for k, v in t.items() if k != "extra"}

    assert_same_tree(adapters(got), adapters(jtree))
    assert_same_tree(convert.from_jax_delta(adapters(back)), adapters(jtree))


def test_corrupt_and_zstd_files_raise_value_error(world):
    _, ptree = jax_and_port_trees(world)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.ckpt")
        save_tree(path, ptree)
        with open(path, "rb") as f:
            raw = f.read()
        cases = {"truncated": raw[: len(raw) // 2],
                 "flipped": raw[:40] + bytes([raw[40] ^ 0xFF]) + raw[41:],
                 "empty": b"",
                 "zstd": b"ZSTD" + raw[4:]}
        for name, data in cases.items():
            with open(path, "wb") as f:
                f.write(data)
            match = "zstandard" if name == "zstd" else "corrupt checkpoint"
            with pytest.raises(ValueError, match=match):
                load_tree(path)
        save_tree(path, {"x": torch.zeros(3)}, compress=False)
        with open(path, "rb") as f:  # bytes that do not fit dtype * shape
            raw = f.read().replace(b"\xa5shape\x91\x03", b"\xa5shape\x91\x04")
        with open(path, "wb") as f:
            f.write(raw)
        with pytest.raises(ValueError, match="corrupt checkpoint"):
            load_tree(path)
        with pytest.raises(TypeError, match="nested dicts"):
            save_tree(path, {"layers": [{"w": torch.zeros(2)}]})


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def test_registry_publish_load_versions(world):
    reg = world["registry"]
    got, meta = reg.load("task1")
    assert meta == {"name": "task1", "step": 0}
    assert_same_tree(got, np_tree(jhad.extract_delta(world["jvars"][1])))
    assert reg.publish("task1", delta(world, 2)) == 1
    assert reg.versions("task1") == [0, 1]
    old, _ = reg.load("task1", version=0)
    new, _ = reg.load("task1")
    w = "blocks/g0/slot0/adapter/w"
    assert not torch.equal(dict(tu.flatten_with_paths(old))[w],
                           dict(tu.flatten_with_paths(new))[w])
    reg.publish("task1", delta(world, 1))  # as the other tests expect


def test_registry_names_contains_remove_and_bad_input(world):
    with tempfile.TemporaryDirectory() as td:
        reg = AdapterRegistry(td)
        reg.publish("a", delta(world, 0))
        reg.publish("b", delta(world, 1))
        assert reg.names() == ["a", "b"]
        assert "a" in reg and "zzz" not in reg and "../x" not in reg
        reg.remove("a")
        assert reg.names() == ["b"]
        with pytest.raises(KeyError):
            reg.load("a")
        with pytest.raises(ValueError, match="bad adapter name"):
            reg.publish("../escape", delta(world, 0))
        with pytest.raises(ValueError, match="no /adapter/ leaves"):
            reg.publish("nodelta", {"pooler": {"w": torch.ones(2, 2)}})
        with pytest.raises(ValueError, match="per-layer layout"):
            reg.publish("flat", had.extract_delta(world["pvars"][0]))
        with pytest.raises(KeyError, match="unknown"):
            reg.load("unknown")


def test_registry_gc_and_read_paths_do_not_write(world):
    with tempfile.TemporaryDirectory() as td:
        reg = AdapterRegistry(td, keep=2)
        for i in range(5):
            reg.publish("t", delta(world, i % 4))
        assert reg.versions("t") == [3, 4]
        assert reg.load("t")[1]["step"] == 4
        assert "ghost" not in reg and reg.versions("ghost") == []
        with pytest.raises(KeyError):
            reg.load("ghost")
        assert sorted(os.listdir(td)) == ["t"]
        reg.remove("t")
        assert "t" not in reg and os.listdir(td) == []


# ---------------------------------------------------------------------------
# bank surgery and the AdapterBank
# ---------------------------------------------------------------------------


def test_bank_row_round_trip_and_validation(world):
    bank = had.init_bank(world["pbase"], 3)
    row = had.adapter_row(had.extract_delta(world["pvars"][2]))
    had.insert_bank_row(bank, row, 1)
    want = {p: v for p, v in tu.flatten_with_paths(row) if v is not None}
    got = {p: v for p, v in tu.flatten_with_paths(had.extract_bank_row(bank, 1))
           if v is not None}
    assert set(got) == set(want)
    assert all(torch.equal(got[p], want[p]) for p in want)
    base_row = had.adapter_row(world["pbase"])
    for p, v in tu.flatten_with_paths(had.extract_bank_row(bank, 0)):
        if v is not None:
            assert torch.equal(v, dict(tu.flatten_with_paths(base_row))[p])
    # the JAX bank row of the same tenant, through convert
    jbank = jhad.insert_bank_row(jhad.init_bank(world["jbase"], 3),
                                 jhad.adapter_row(jhad.extract_delta(
                                     world["jvars"][2])), 1)
    assert_same_tree(convert.stack_delta(had.extract_bank_row(bank, 1),
                                         world["pcfg"]),
                     np_tree(jhad.extract_bank_row(jbank, 1)))
    had.validate_adapter_row(bank, row)
    bad = tu.map_with_path(lambda p, v: None if v is None or not p.endswith(
        "adapter/w") else v[:-1], row)
    with pytest.raises(ValueError, match="does not fit bank"):
        had.validate_adapter_row(bank, bad)
    missing = tu.map_with_path(
        lambda p, v: None if p.endswith("adapter/b") else v, row)
    with pytest.raises(ValueError, match="missing adapter leaf"):
        had.validate_adapter_row(bank, missing)
    had.validate_adapter_row(had.init_bank(world["pbase"], 3, shared_w=True),
                             tu.map_with_path(lambda p, v: None if p.endswith(
                                 "adapter/w") else v, row), shared_w=True)


def test_bank_lru_pins_invalidate_and_gates(world):
    cfg = world["pcfg"]
    bank = AdapterBank(cfg, world["pbase"], 2, world["registry"])
    assert bank.gates().sum() == 0 and bank.gate_tensor.sum() == 0
    r0 = bank.lookup("task0")
    r1 = bank.lookup("task1")
    assert sorted([r0, r1]) == [0, 1]
    bank.lookup("task0")  # task1 is now the coldest
    assert bank.lookup("task2") == r1 and bank.resident == ["task0", "task2"]
    assert (bank.loads, bank.evictions, bank.hits) == (3, 1, 1)
    bank.acquire("task0")
    bank.acquire("task2")
    with pytest.raises(BankFullError):
        bank.acquire("task3")
    assert bank.pin_stalls == 1 and bank.loads == 3  # refused before loading
    assert not bank.invalidate("task0")  # pinned
    bank.release("task0")
    bank.release("task2")
    np.testing.assert_array_equal(bank.gates(), np.ones((2, 2), np.float32))
    assert bank.invalidate("task0") and not bank.invalidate("task0")
    want = np.zeros((2, 2), np.float32)
    want[:, bank.row_of("task2")] = 1
    np.testing.assert_array_equal(bank.gates(), want)
    np.testing.assert_array_equal(bank.gate_tensor.numpy(), want)
    with pytest.raises(KeyError):
        bank.acquire("never-published")
    st = bank.stats()
    assert st["resident"] == 1 and st["adapter_bytes"] == \
        2 * 2 * cfg.n_layers * cfg.d_model * 4


def test_bank_invalidate_picks_up_a_new_version(world):
    cfg = world["pcfg"]
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (1, 6))
    with tempfile.TemporaryDirectory() as td:
        reg = AdapterRegistry(td)
        reg.publish("t", delta(world, 0))
        eng = MultiTaskEngine(cfg, AdapterBank(cfg, world["pbase"], 1, reg),
                              device="cpu")

        def run():
            done, _ = make_scheduler(eng, ServingConfig(
                num_slots=1, max_len=16)).run(
                [Request(prompt=toks[0], max_new_tokens=4, adapter="t")])
            return done[0].tokens

        v0 = run()
        reg.publish("t", delta(world, 1))
        np.testing.assert_array_equal(run(), v0)  # resident row still v0
        assert eng.adapter_bank.invalidate("t")
        want = ServeEngine(cfg, world["pvars"][1], device="cpu").generate(
            toks, 4)
        np.testing.assert_array_equal(run(), want[0])


# ---------------------------------------------------------------------------
# the scheduler with named adapters
# ---------------------------------------------------------------------------


def test_scheduler_bank_backpressure_defers_and_drains(world):
    """2 rows, 3 tenants, 4 slots: admissions wait for a retirement."""
    cfg = world["pcfg"]
    hot = MultiTaskEngine(cfg, AdapterBank(cfg, world["pbase"], 2,
                                           world["registry"]), device="cpu")
    rs = np.random.RandomState(3)
    reqs = [Request(prompt=rs.randint(0, cfg.vocab_size, (5,)),
                    max_new_tokens=2 + i % 3, adapter=f"task{i % 3}")
            for i in range(7)]
    done, report = make_scheduler(hot, ServingConfig(
        num_slots=4, max_len=16)).run(reqs)
    assert report["requests"] == 7
    for r, c in zip(reqs, done):
        assert len(c.tokens) == r.max_new_tokens and c.adapter == r.adapter
    bank = hot.adapter_bank
    assert bank.pin_stalls > 0 and bank.evictions > 0
    assert all(bank.pins(f"task{t}") == 0 for t in range(3))


def test_scheduler_submit_validates_names(world):
    cfg = world["pcfg"]
    hot = MultiTaskEngine(cfg, AdapterBank(cfg, world["pbase"], 2,
                                           world["registry"]), device="cpu")
    req = dict(prompt=np.zeros(4, np.int64), max_new_tokens=2)
    with pytest.raises(KeyError, match="neither bank-resident"):
        make_scheduler(hot, ServingConfig(num_slots=1, max_len=16)).submit(
            Request(adapter="ghost", **req))
    for eng in (MultiTaskEngine(cfg, world["pvars"][:2], device="cpu"),
                ServeEngine(cfg, world["pbase"], device="cpu")):
        with pytest.raises(ValueError, match="AdapterBank"):
            make_scheduler(eng, ServingConfig(num_slots=1, max_len=16)
                           ).submit(Request(adapter="task0", **req))


def test_scheduler_adapter_removed_between_submit_and_admission(world):
    cfg = world["pcfg"]
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (6,))
    with tempfile.TemporaryDirectory() as td:
        reg = AdapterRegistry(td)
        for t in range(2):
            reg.publish(f"task{t}", delta(world, t))
        hot = MultiTaskEngine(cfg, AdapterBank(cfg, world["pbase"], 2, reg),
                              device="cpu")
        sched = make_scheduler(hot, ServingConfig(num_slots=1, max_len=16))
        ok = sched.submit(Request(prompt=toks, max_new_tokens=3,
                                  adapter="task0"))
        doomed = sched.submit(Request(prompt=toks, max_new_tokens=3,
                                      adapter="task1"))
        reg.remove("task1")
        while sched.pending or sched.active:
            sched.step()
    want = ServeEngine(cfg, world["pvars"][0], device="cpu").generate(
        toks[None], 3)
    assert sched.completions[ok].finish_reason == "length"
    np.testing.assert_array_equal(sched.completions[ok].tokens, want[0])
    err = sched.completions[doomed]
    assert err.finish_reason == "error" and err.tokens.size == 0
    assert err.adapter == "task1"


# ---------------------------------------------------------------------------
# interop: tenants of either package serve from the other
# ---------------------------------------------------------------------------


def tenants(w, kind):
    """Per-task (JAX params, port params, layer mask or None) and the
    bank's base in each package. 'mixed': tasks 0 and 2 pruned to the top
    layer, 1 and 3 dense. 'shared': the shared-w world, all pruned."""
    jcfg, pcfg = w["jcfg"], w["pcfg"]
    mask = imp.depth_mask(pcfg, 1)
    if kind == "mixed":
        out = []
        for t in range(4):
            m = mask if t % 2 == 0 else None
            jv, pv = w["jvars"][t], w["pvars"][t]
            if m is not None:
                jv = jimp.apply_layer_mask(jv, jcfg, m)
                pv = imp.apply_layer_mask(pv, pcfg, m)
            out.append((jv, pv, m))
        return out, w["jbase"], w["pbase"]
    stem = jhad.perturb_adapters(w["jbase"], jax.random.fold_in(KEY, 7),
                                 leaves=("w",), scale=0.2)
    jvs = [jimp.apply_layer_mask(jhad.perturb_adapters(
        stem, jax.random.fold_in(KEY, 100 + t), leaves=("b",), scale=0.2),
        jcfg, mask) for t in range(4)]
    pvs = [convert.from_jax_params(np_tree(v), pcfg, "cpu") for v in jvs]
    jsa = jshared.factorize({f"task{t}": jhad.extract_delta(v)
                             for t, v in enumerate(jvs)}, jcfg, mask=mask)
    sa = shared.factorize({f"task{t}": had.extract_delta(v)
                           for t, v in enumerate(pvs)}, pcfg, mask=mask)
    return ([(jv, pv, mask) for jv, pv in zip(jvs, pvs)],
            jshared.shared_w_overlay(w["jbase"], jsa),
            shared.shared_w_overlay(w["pbase"], sa, pcfg))


def publish(registry, by, w, tenant, name):
    jv, pv, m = tenant
    if by == "jax":
        d = jhad.extract_delta(jv)
        registry.publish(name, d if m is None else
                         jprune.prune_delta(d, w["jcfg"], m))
    else:
        registry.publish(name, launcher.task_delta(pv, w["pcfg"], m))


def assert_lifecycle_matches_jax(w, by, kind):
    """Each package serves the tenants `by` published over the backbone of
    `w`: a 3-row bank over 4 tenants, the last published mid-stream, task0
    removed at the end; greedy tokens and bank counts equal JAX's."""
    ts, jbase, pbase = tenants(w, kind)
    share = kind == "shared"
    rs = np.random.RandomState(9)
    traffic = [dict(prompt=rs.randint(0, w["pcfg"].vocab_size, (6,)),
                    max_new_tokens=int(rs.randint(2, 6)),
                    adapter=f"task{i % 4}") for i in range(8)]
    with tempfile.TemporaryDirectory() as td:
        regs = {}
        for pkg, cls in (("jax", JAdapterRegistry), ("port", AdapterRegistry)):
            regs[pkg] = cls(os.path.join(td, pkg))
            publisher = (JAdapterRegistry if by == "jax" else
                         AdapterRegistry)(os.path.join(td, pkg))
            for t in range(3):
                publish(publisher, by, w, ts[t], f"task{t}")
        jeng = JMultiTaskEngine(w["jcfg"], JAdapterBank(
            w["jcfg"], jbase, 3, regs["jax"], shared_w=share))
        peng = MultiTaskEngine(w["pcfg"], AdapterBank(
            w["pcfg"], pbase, 3, regs["port"], shared_w=share), device="cpu")

        def hot(pkg):
            return lambda: publish((JAdapterRegistry if by == "jax" else
                                    AdapterRegistry)(os.path.join(td, pkg)),
                                   by, w, ts[3], "task3")

        pdone, _ = launcher.serve_with_runtime_add(
            make_scheduler(peng, ServingConfig(num_slots=3, max_len=16)),
            [Request(**t) for t in traffic], "task3", hot("port"),
            log=lambda _: None)
        jsched = jmake_scheduler(jeng, JServingConfig(num_slots=3,
                                                      max_len=16))
        early = [JRequest(**t) for t in traffic if t["adapter"] != "task3"]
        late = [JRequest(**t) for t in traffic if t["adapter"] == "task3"]
        ids = [jsched.submit(r) for r in early]
        while jsched.pending or jsched.active or late:
            jsched.step()
            if late and len(jsched.completions) * 2 >= len(early):
                hot("jax")()
                ids += [jsched.submit(r) for r in late]
                late = []
        jdone = [jsched.completions.pop(i) for i in ids]
        for pkg, eng in (("jax", jeng), ("port", peng)):
            regs[pkg].remove("task0")
            eng.adapter_bank.invalidate("task0")
    for p, j in zip(pdone, jdone):
        assert p.adapter == j.adapter and p.finish_reason == "length"
        np.testing.assert_array_equal(p.tokens, np.asarray(j.tokens),
                                      err_msg=p.adapter)
    pst, jst = peng.adapter_bank.stats(), jeng.adapter_bank.stats()
    for k in ("resident", "loads", "evictions", "shared_w", "adapter_bytes"):
        assert pst[k] == jst[k], k
    assert pst["evictions"] >= 1
    np.testing.assert_array_equal(peng.adapter_bank.gates(),
                                  jeng.adapter_bank.gates())


@pytest.mark.parametrize("by,kind", [("jax", "mixed"), ("port", "shared")])
def test_hot_swap_lifecycle_is_token_identical_to_jax(world, jax_zlib, by,
                                                      kind):
    """Each package serves the tenants the other (or it) published: a 3-row
    bank over 4 tenants, the last published mid-stream, task0 removed at
    the end; greedy tokens and bank counts equal JAX's."""
    assert_lifecycle_matches_jax(world, by, kind)


@pytest.mark.parametrize("kind", ["mixed", "shared"])
def test_hot_swap_logits_match_jax(world, jax_zlib, kind):
    """Prefill and two decode steps over a bank holding a pruned and a
    dense tenant (or two shared-w tenants): logits within 1e-4."""
    w = world
    ts, jbase, pbase = tenants(w, kind)
    share = kind == "shared"
    with tempfile.TemporaryDirectory() as td:
        jreg = JAdapterRegistry(td)
        for t in (0, 1):
            publish(jreg, "jax", w, ts[t], f"task{t}")
        jbank = JAdapterBank(w["jcfg"], jbase, 3, jreg, shared_w=share)
        pbank = AdapterBank(w["pcfg"], pbase, 3, AdapterRegistry(td),
                            shared_w=share)
        rows = [jbank.lookup(f"task{t}") for t in (0, 1)]
        assert [pbank.lookup(f"task{t}") for t in (0, 1)] == rows
    jeng = JMultiTaskEngine(w["jcfg"], jbank)
    peng = MultiTaskEngine(w["pcfg"], pbank, device="cpu")
    toks = np.random.RandomState(4).randint(0, w["pcfg"].vocab_size, (2, 7))
    jl, jc = jeng.prefill(toks, 16, task_ids=rows)
    pl, pc = peng.prefill(toks, 16, task_ids=rows)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4)
    for i in range(2):
        tok = np.array(jnp.argmax(jl[:, -1], -1))[:, None]
        jl, jc = jeng.decode_step(jc, jnp.asarray(tok),
                                  jnp.full((2,), 7 + i, jnp.int32),
                                  task_ids=rows)
        pl, pc = peng.decode_step(pc, tok, np.full((2,), 7 + i),
                                  task_ids=rows)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("share_w", [False, True])
def test_serve_launcher_hot_swap_prints_the_jax_lines(share_w, capsys):
    with tempfile.TemporaryDirectory() as td:
        launcher.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                       "--tasks", "4", "--adapter-dir", td, "--bank-size",
                       "3", "--prune-to", "1", "--requests", "8",
                       "--prompt-len", "6", "--new-tokens", "3"]
                      + (["--share-w"] if share_w else []))
        assert sorted(os.listdir(td)) == ["task1", "task2", "task3"]
    out = capsys.readouterr().out
    assert "pruned serving: top 1/2 layers active, packed deltas published" \
        in out
    assert "++ runtime add: published 'task3', submitting 2 request(s)" in out
    assert "-- runtime remove: 'task0' unpublished + row freed" in out
    assert "adapter bank: 3/3 rows resident, 4 loads, 1 evictions" in out
    assert ("(shared-w: one w row-set for all tenants)" in out) == share_w
    assert "served 8 requests / 24 tokens" in out
    base = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu"]
    with tempfile.TemporaryDirectory() as td:
        for bad in (["--tasks", "2", "--share-w"], ["--adapter-dir", td],
                    ["--tasks", "2", "--prune-to", "3"]):
            with pytest.raises(SystemExit):
                launcher.main(base + bad)


def test_registry_survives_a_fresh_process(world):
    """A registry directory written here serves from a new interpreter:
    the lifecycle is file-backed."""
    code = (
        "import sys; sys.path.insert(0, {src!r})\n"
        "from repro_torch.serving import AdapterRegistry\n"
        "reg = AdapterRegistry({d!r})\n"
        "tree, meta = reg.load('task3')\n"
        "print(reg.names(), meta['step'], sorted(tree['blocks']['g0']"
        "['slot0']['adapter']))\n").format(src=str(ROOT / "src"),
                                           d=world["registry"].dir)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["['task0',", "'task1',", "'task2',",
                                  "'task3']", "0", "['b',", "'w']"]
