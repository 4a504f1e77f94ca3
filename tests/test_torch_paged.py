"""The port's paged KV serving against the JAX package's.

Same JAX-made weights (perturbed adapters) on both sides, fp32, on the CPU
(#5 takes its plain version here; `chip_smoke.py` holds the kernel to it
on the card):
  * `BlockAllocator` refcounts under random traces, and `PrefixCache`'s
    LRU eviction, step for step with JAX's;
  * paged decode, extend and verify logits within 1e-4 of JAX's on the
    same block tables; int8/fp8 pools, payload and scales, byte for byte
    JAX's after `paged_insert` and after every write;
  * `PagedScheduler` greedy tokens equal to JAX's `PagedScheduler` and to
    the port's contiguous `Scheduler`, with mid-decode admission and
    traffic that makes whole-prompt, prefix and cold admissions, the same
    stats and pool accounting; the COW fork, exhaustion deferring and
    draining, refusals; int8/fp8 blocks' tokens equal to JAX's and near
    the contiguous ones (JAX's own bar).
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hadamard as jhad
from repro.models import model as JM
from repro.serving import MultiTaskEngine as JMultiTaskEngine
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro.serving import ServingConfig as JServingConfig
from repro.serving import make_scheduler as jmake_scheduler
from repro.serving.paged import BlockAllocator as JBlockAllocator
from repro.serving.paged import BlockPoolFullError as JBlockPoolFullError
from repro.serving.paged import PrefixCache as JPrefixCache
from repro_torch import convert
from repro_torch.configs import get_smoke
from repro_torch.core import peft
from repro_torch.serving import (AdapterBank, AdapterRegistry,
                                 BlockAllocator, BlockPoolFullError,
                                 MultiTaskEngine, PagedScheduler, PrefixCache,
                                 Request, ServeEngine, ServingConfig,
                                 make_scheduler)
from repro_torch.launch import serve as launcher
from test_torch_model import KEY, jax_cfg, np_tree, port_cfg

QUANTS = [None, "int8", "fp8"]
PAGE = 8


def _world(name="tiny", tasks=0, scale=0.2):
    """(JAX engine, port engine, JAX cfg, port cfg) over the same weights."""
    jcfg = jax_cfg(name)
    pcfg = port_cfg(jcfg)
    base = JM.init_params(KEY, jcfg)
    variants = [jhad.perturb_adapters(base, jax.random.fold_in(KEY, 100 + t),
                                      scale=scale)
                for t in range(max(tasks, 1))]
    ported = [convert.from_jax_params(np_tree(v), pcfg, "cpu")
              for v in variants]
    if tasks:
        return (JMultiTaskEngine(jcfg, variants),
                MultiTaskEngine(pcfg, ported, device="cpu"), jcfg, pcfg)
    return (JServeEngine(jcfg, variants[0]),
            ServeEngine(pcfg, ported[0], device="cpu"), jcfg, pcfg)


def _np(t):
    """A port tensor as numpy; an int8/fp8 payload as its bytes."""
    return (t.view(torch.uint8) if t.element_size() == 1 else t).numpy()


def _jnp_bytes(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


def _layers(jpool, pcfg):
    """Per-layer (k, v) JAX leaves, the group's repeat index applied."""
    out = []
    for gi, r, si in convert._layer_position(pcfg):
        layer = jpool[f"g{gi}"][f"slot{si}"]["attn"]
        out.append({n: jax.tree.map(lambda a: a[r], layer[n])
                    for n in ("k", "v")})
    return out


def _same_pools(jpool, ppool, pcfg, quant, skip=None):
    """Pools within 1e-5 (fp32), or (int8/fp8) dequantized within one
    quantum: the two packages' K/V differ in the last bits, which may move
    a value across a rounding edge. `skip` (block, offsets) is left out
    past the first layer."""
    for li, (jl, pl) in enumerate(zip(_layers(jpool, pcfg), ppool)):
        for n in ("k", "v"):
            j, p = jl[n], pl[n]
            if quant:
                got = p.dequantize().numpy()
                want = (np.asarray(j.values, np.float32)
                        * np.asarray(j.scales))
                tol = np.asarray(j.scales) * 1.01 + 1e-6
            else:
                got, want, tol = p.numpy(), np.asarray(j), 1e-5
            err = np.abs(got - want) - tol
            if skip is not None and li:
                err[skip] = 0
            assert (err <= 0).all(), f"layer {li} {n}: {err.max()}"


def _same_bytes(jleaf, pleaf):
    np.testing.assert_array_equal(_np(pleaf.values),
                                  _jnp_bytes(jleaf.values))
    np.testing.assert_array_equal(pleaf.scales.numpy(),
                                  np.asarray(jleaf.scales))


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


# ---------------------------------------------------------------------------
# the allocator and the prefix cache, step for step with JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_allocator_refcounts_match_jax_under_a_random_trace(seed):
    """One random trace of alloc/incref/decref through both allocators and
    a shadow dict of refcounts: the same ids, frees, errors and counts."""
    rng = random.Random(seed)
    nb = rng.randint(2, 24)
    ours, theirs, shadow = BlockAllocator(nb), JBlockAllocator(nb), {}
    for _ in range(200):
        op = rng.choice(("alloc", "incref", "decref"))
        if op == "alloc":
            if ours.num_free == 0:
                with pytest.raises(BlockPoolFullError):
                    ours.alloc()
                with pytest.raises(JBlockPoolFullError):
                    theirs.alloc()
                continue
            bid = ours.alloc()
            assert bid == theirs.alloc() and bid not in shadow and bid != 0
            shadow[bid] = 1
        elif op == "incref" and shadow:
            bid = rng.choice(sorted(shadow))
            ours.incref(bid)
            theirs.incref(bid)
            shadow[bid] += 1
        elif op == "decref" and shadow:
            bid = rng.choice(sorted(shadow))
            freed = ours.decref(bid)
            assert freed == theirs.decref(bid)
            shadow[bid] -= 1
            assert freed == (shadow[bid] == 0)
            if not shadow[bid]:
                del shadow[bid]
        assert ours.num_free == theirs.num_free == nb - 1 - len(shadow)
        for bid in range(nb):
            assert ours.refcount(bid) == theirs.refcount(bid) \
                == shadow.get(bid, 0)
    for bad in (0, nb - 1 if nb - 1 not in shadow else None):
        if bad is not None:
            with pytest.raises(ValueError):
                ours.decref(bad)
            with pytest.raises(ValueError):
                ours.incref(bad)


def test_prefix_cache_lru_eviction_releases_blocks():
    """Both caches over one op sequence: a touched chain entry outlives an
    untouched one, full entries go first, and clearing frees every block
    once the owner has dropped its references."""
    caches = [(BlockAllocator(10), PrefixCache()),
              (JBlockAllocator(10), JPrefixCache())]
    freed = []
    for alloc, cache in caches:
        bids = [alloc.alloc() for _ in range(4)]
        for i, b in enumerate(bids):
            cache.insert_block(alloc, ("task", 0), 100 + i, b)
        cache.insert_full(alloc, ("task", 0), 13, 999, bids[:2],
                          np.zeros((1, 1, 7), np.float32))
        for b in bids:  # the owner retires
            alloc.decref(b)
        assert cache.match_prefix(("task", 0), [100]) == [bids[0]]
        assert cache.match_full(("task", 1), 13, 999) is None
        steps = [alloc.num_free]
        while cache.evict_one(alloc):
            steps.append(alloc.num_free)
        steps.append((cache.hits_full, cache.hits_partial))
        freed.append(steps)
        assert alloc.num_free == 9 and not cache.blocks and not cache.full
    # full tier first (its blocks stay pinned by the chain), then LRU
    # chain entries: 101, 102, 103 before the touched 100
    assert freed[0] == freed[1] == [5, 5, 6, 7, 8, 9, (0, 1)]


# ---------------------------------------------------------------------------
# the model calls against JAX's on the same block tables
# ---------------------------------------------------------------------------


def test_init_paged_pool_layout():
    _, peng, _, pcfg = _world()
    for quant in QUANTS:
        pool = peng.init_paged_pool(7, PAGE, quant)
        assert len(pool) == pcfg.n_layers
        for layer in pool:
            for leaf in layer.values():
                vals = leaf.values if quant else leaf
                assert vals.shape == (7, PAGE, pcfg.n_kv_heads,
                                      pcfg.head_dim)
                assert vals.dtype == {None: torch.float32,
                                      "int8": torch.int8,
                                      "fp8": torch.float8_e4m3fn}[quant]
                if quant:
                    assert leaf.scales.shape == (7, PAGE, pcfg.n_kv_heads, 1)
                    assert bool((leaf.scales == 1).all())


def _insert_prompts(jeng, peng, quant, prompts, tables, task_ids=None):
    """Prefill each prompt (B = 1, padded to whole pages) in both packages
    and insert it into the blocks of its table row."""
    jpool = jeng.init_paged_pool(16, PAGE, quant)
    ppool = peng.init_paged_pool(16, PAGE, quant)
    for b, prompt in enumerate(prompts):
        S = len(prompt)
        nbl = -(-S // PAGE)
        toks = np.pad(prompt, (0, nbl * PAGE - S))[None]
        tid = None if task_ids is None else [task_ids[b]]
        _, jfresh = jeng.prefill(toks, nbl * PAGE, task_ids=tid,
                                 last_pos=S - 1)
        _, pfresh = peng.prefill(toks, nbl * PAGE, task_ids=tid,
                                 last_pos=S - 1)
        jpool = jeng.paged_insert(jpool, jfresh, tables[b, :nbl])
        ppool = peng.paged_insert(ppool, pfresh, tables[b, :nbl])
    return jpool, ppool


@pytest.mark.parametrize("tasks", [0, 3])
@pytest.mark.parametrize("quant", QUANTS)
def test_paged_decode_logits_and_pools_match_jax(quant, tasks):
    """Two rows over scattered block tables: pools equal after the insert
    and after every decode write (int8/fp8 byte for byte), logits within
    1e-4, and at fp32 the port's paged logits equal its contiguous ones."""
    jeng, peng, _, pcfg = _world(tasks=tasks)
    rs = np.random.RandomState(3)
    prompts = [rs.randint(1, pcfg.vocab_size, 11), rs.randint(
        1, pcfg.vocab_size, 16)]
    tables = np.array([[2, 1, 3, 0], [5, 4, 6, 0]], np.int32)
    tids = [0, 2] if tasks else None
    jpool, ppool = _insert_prompts(jeng, peng, quant, prompts, tables, tids)
    _same_pools(jpool, ppool, pcfg, quant)
    if quant is None:
        # the contiguous decode of the same page-padded prompts (the same
        # prefill rows, so the same K/V bits), for the port alone
        caches = peng.init_slot_caches(2, 32)
        for b, p in enumerate(prompts):
            _, fresh = peng.prefill(np.pad(p, (0, 16 - len(p)))[None], 32,
                                    task_ids=None if tids is None
                                    else [tids[b]], last_pos=len(p) - 1)
            for c, f in zip(caches, fresh):
                for n in c:
                    c[n][b].copy_(f[n][0])
    pos = np.array([11, 16])
    tok = rs.randint(1, pcfg.vocab_size, (2, 1))
    for step in range(5):
        want, jpool = jeng.paged_decode_step(
            jpool, jnp.asarray(tok), jnp.asarray(pos + step, jnp.int32),
            tables, task_ids=tids)
        got, ppool = peng.paged_decode_step(ppool, tok, pos + step, tables,
                                            task_ids=tids)
        _close(got, want)
        _same_pools(jpool, ppool, pcfg, quant)
        if quant is None:
            flat, caches = peng.decode_step(caches, tok, pos + step,
                                            task_ids=tids)
            assert torch.equal(got, flat)
        tok = got[:, -1].argmax(-1, keepdim=True).numpy()


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_quantized_insert_and_write_bytes_match_jax(quant):
    """JAX's K/V bits through both packages: `paged_insert` of one fresh
    prefill cache and the decode write of (B, S) tokens give the same
    payload bytes and scales (absmax per token and head, JAX's order)."""
    from repro.quant.qtensor import QTensor as JQTensor
    from repro.quant.qtensor import quantize as jquantize
    from repro_torch.models.attention import write_pool

    jeng, peng, _, pcfg = _world()
    prompt = np.random.RandomState(10).randint(1, pcfg.vocab_size, 16)
    _, jfresh = jeng.prefill(prompt[None], 16)
    pfresh = [{n: torch.from_numpy(np.array(layer[n])) for n in ("k", "v")}
              for layer in _layers_of_cache(jfresh, pcfg)]
    bids = np.array([3, 1], np.int32)
    jpool = jeng.paged_insert(jeng.init_paged_pool(6, PAGE, quant), jfresh,
                              bids)
    ppool = peng.paged_insert(peng.init_paged_pool(6, PAGE, quant), pfresh,
                              bids)
    for jl, pl in zip(_layers(jpool, pcfg), ppool):
        for n in ("k", "v"):
            _same_bytes(jl[n], pl[n])
    # one layer's write of 2 rows x 3 positions through scattered tables
    rs = np.random.RandomState(11)
    kv = rs.standard_normal((2, 2, 3, pcfg.n_kv_heads, pcfg.head_dim)
                            ).astype(np.float32)
    tables = np.array([[4, 2], [5, 0]], np.int32)
    wp = np.array([[6, 7, 8], [0, 1, 2]])
    blk = tables[np.arange(2)[:, None], wp // PAGE]
    jl = _layers(jpool, pcfg)[0]

    @jax.jit
    def jwrite(leaf, x):  # JAX's decode write, compiled as the model runs it
        q = jquantize(x, quant, axis=-1)
        return JQTensor(leaf.values.at[blk, wp % PAGE].set(q.values),
                        leaf.scales.at[blk, wp % PAGE].set(q.scales))

    want = {n: jwrite(jl[n], jnp.asarray(x)) for n, x in zip(("k", "v"), kv)}
    write_pool(ppool[0], torch.from_numpy(tables),
               torch.from_numpy(wp), *map(torch.from_numpy, kv))
    for n in ("k", "v"):
        _same_bytes(want[n], ppool[0][n])


def _layers_of_cache(jcaches, pcfg):
    """JAX's stacked prefill caches as the port's per-layer list (B = 1)."""
    out = []
    for gi, r, si in convert._layer_position(pcfg):
        layer = jcaches[f"g{gi}"][f"slot{si}"]["attn"]
        out.append({n: np.asarray(layer[n][r]) for n in ("k", "v")})
    return out


@pytest.mark.parametrize("quant", QUANTS)
def test_extend_logits_match_jax_and_a_cold_prefill(quant):
    """A 21-token prompt whose first 16 tokens sit in the pool: extending
    the 5-token suffix (padded to a page) gives JAX's logits and a cold
    prefill's within 1e-4, and writes the suffix's K/V as JAX does."""
    jeng, peng, _, pcfg = _world()
    rs = np.random.RandomState(4)
    prompt = rs.randint(1, pcfg.vocab_size, 21)
    tables = np.array([[3, 1, 2, 0]], np.int32)
    jpool, ppool = _insert_prompts(jeng, peng, quant, [prompt[:16]], tables)
    sfx = np.pad(prompt[16:], (0, 3))[None]
    want, jpool = jeng.paged_extend(jpool, sfx, tables, start=16, kv_len=21,
                                    last_pos=4)
    got, ppool = peng.paged_extend(ppool, sfx, tables, start=16, kv_len=21,
                                   last_pos=4)
    assert got.shape == (1, 1, pcfg.vocab_size)
    _close(got, want)
    # the 3 pad tokens' K/V past the first layer come from queries JAX
    # masks by kv_len and #5 by the causal bound alone: they differ, and a
    # decode write replaces each before any query's bound reaches it
    _same_pools(jpool, ppool, pcfg, quant, skip=(2, slice(5, 8)))
    cold, _ = peng.prefill(prompt[None], 32)
    _close(got, cold.numpy(), 1e-4 if quant is None else 0.5)
    with pytest.raises(ValueError, match="extend"):
        peng.paged_extend(ppool, sfx, tables, start=16, kv_len=16,
                          last_pos=4)


@pytest.mark.parametrize("paged", [False, True])
def test_verify_logits_match_jax_and_plain_decode(paged):
    """k+1 = 4 tokens a row in one verify: JAX's logits within 1e-4, and
    column j within 1e-5 of a plain decode step at pos + j."""
    jeng, peng, _, pcfg = _world()
    rs = np.random.RandomState(5)
    prompts = [rs.randint(1, pcfg.vocab_size, 9) for _ in range(2)]
    toks = rs.randint(1, pcfg.vocab_size, (2, 4))
    pos = np.array([9, 9])
    if paged:
        tables = np.array([[4, 2, 7, 0], [1, 3, 5, 0]], np.int32)
        jstate, pstate = _insert_prompts(jeng, peng, None, prompts, tables)
        want, _ = jeng.paged_verify_step(jstate, toks, pos, tables)
        got, _ = peng.paged_verify_step(pstate, toks, pos, tables)
    else:
        stack = np.stack(prompts)
        _, jstate = jeng.prefill(stack, 32)
        _, pstate = peng.prefill(stack, 32)
        want, _ = jeng.verify_step(jstate, toks, pos)
        got, pstate = peng.verify_step(pstate, toks, pos)
    assert got.shape == (2, 4, pcfg.vocab_size)
    _close(got, want)
    _, caches = peng.prefill(np.stack(prompts), 32)
    for j in range(4):
        step, caches = peng.decode_step(caches, toks[:, j:j + 1], pos + j)
        _close(got[:, j:j + 1], step.numpy(), 1e-5)
    with pytest.raises(ValueError, match="outside"):
        peng.verify_step(peng.init_slot_caches(2, 32), toks,
                         np.array([29, 0]))


# ---------------------------------------------------------------------------
# the scheduler against JAX's and against the contiguous one
# ---------------------------------------------------------------------------


def _traffic(vocab, n=9, tasks=0, seed=6):
    """A shared 10-token stem under odd requests (prefix hits), requests
    that repeat earlier prompts (whole-prompt hits, a partial tail page
    among them), fresh prompts (cold); budgets vary, so admissions land
    mid-decode."""
    rs = np.random.RandomState(seed)
    stem = rs.randint(1, vocab, 10)
    out = []
    for i in range(n):
        if i in (5, 6):
            prompt = out[i - 4]["prompt"]
        elif i % 2:
            prompt = np.concatenate([stem, rs.randint(1, vocab,
                                                      rs.randint(1, 8))])
        else:
            prompt = rs.randint(1, vocab, rs.randint(3, 14))
        out.append(dict(prompt=prompt.astype(np.int32),
                        max_new_tokens=int(rs.randint(2, 8)),
                        task_id=i % tasks if tasks else 0))
    return out


def _contiguous(peng, traffic, max_len=48):
    done, _ = make_scheduler(peng, ServingConfig(
        num_slots=3, max_len=max_len)).run([Request(**t) for t in traffic])
    return [c.tokens for c in done]


@pytest.mark.parametrize("name,tasks", [("tiny", 0), ("tiny", 3),
                                        ("qwen3-smoke", 0)])
def test_paged_scheduler_tokens_match_jax_and_the_contiguous_one(name,
                                                                  tasks):
    jeng, peng, _, pcfg = _world(name, tasks)
    traffic = _traffic(pcfg.vocab_size, tasks=tasks)
    kw = dict(num_slots=3, max_len=48, paged=True, page_size=PAGE,
              num_blocks=40)
    jsched = jmake_scheduler(jeng, JServingConfig(**kw))
    jdone, _ = jsched.run([JRequest(**t) for t in traffic])
    psched = make_scheduler(peng, ServingConfig(**kw))
    assert type(psched) is PagedScheduler
    pdone, report = psched.run([Request(**t) for t in traffic])
    assert report["requests"] == len(traffic)
    for j, p, c, t in zip(jdone, pdone, _contiguous(peng, traffic), traffic):
        assert len(p.tokens) == t["max_new_tokens"]
        np.testing.assert_array_equal(p.tokens, np.asarray(j.tokens))
        np.testing.assert_array_equal(p.tokens, c)
    assert psched.stats == jsched.stats
    assert psched.pool_report() == jsched.pool_report()
    st = psched.stats
    if tasks == 0:
        assert st["full_hits"] and st["partial_hits"] and st["cold"], st
    psched.prefix.clear(psched.alloc)
    rep = psched.pool_report()
    assert rep["live_blocks"] == 0 and rep["reserved_blocks"] == 0


def test_full_hit_runs_no_forward_and_cow_fork_isolates_sharers():
    """One cached prompt with a partial tail page, then three requests for
    it in one tick: three whole-prompt hits, no prefill, each forking its
    own tail, and every one the contiguous scheduler's tokens."""
    _, peng, _, pcfg = _world()
    prompt = np.random.RandomState(7).randint(1, pcfg.vocab_size, 11)
    mk = lambda: Request(prompt=prompt, max_new_tokens=5)  # noqa: E731
    want = _contiguous(peng, [dict(prompt=prompt, max_new_tokens=5)])[0]
    sched = make_scheduler(peng, ServingConfig(
        num_slots=3, max_len=32, paged=True, page_size=PAGE, num_blocks=32))
    sched.run([mk()])
    calls = []
    orig = peng.prefill
    peng.prefill = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        done, _ = sched.run([mk(), mk(), mk()])
    finally:
        del peng.prefill
    assert sched.stats["full_hits"] == 3 and not calls
    for c in done:
        np.testing.assert_array_equal(c.tokens, want)


def test_block_exhaustion_defers_then_drains():
    """A pool far smaller than the load: admissions defer in order until
    retirements free blocks, every request completes with the contiguous
    tokens, and no block or reservation is left - with sharing off, and
    with it on once the prefix cache is cleared."""
    _, peng, _, pcfg = _world()
    traffic = [dict(t, max_new_tokens=5) for t in _traffic(pcfg.vocab_size,
                                                           n=10, seed=8)]
    want = _contiguous(peng, traffic, max_len=32)
    for prefix_cache in (False, True):
        sched = make_scheduler(peng, ServingConfig(
            num_slots=4, max_len=32, paged=True, page_size=PAGE,
            num_blocks=9, prefix_cache=prefix_cache))
        deferred = []
        orig = sched._admit_one

        def admit(*a, _orig=orig):
            try:
                return _orig(*a)
            except BlockPoolFullError:
                deferred.append(a[1])
                raise
        sched._admit_one = admit
        done, _ = sched.run([Request(**t) for t in traffic])
        assert deferred, "the pool never ran short"
        assert [c.request_id for c in done] == sorted(c.request_id
                                                      for c in done)
        for w, c in zip(want, done):
            np.testing.assert_array_equal(c.tokens, w)
        if sched.prefix is not None:
            sched.prefix.clear(sched.alloc)
        rep = sched.pool_report()
        assert rep["live_blocks"] == 0 and rep["reserved_blocks"] == 0


def test_oversized_request_refused_at_submit():
    _, peng, _, _ = _world()
    sched = make_scheduler(peng, ServingConfig(
        num_slots=2, max_len=32, paged=True, page_size=PAGE, num_blocks=3))
    with pytest.raises(ValueError, match="blocks"):
        sched.submit(Request(prompt=np.arange(1, 20), max_new_tokens=8))
    assert not sched.queue


def test_named_tenants_never_share_kv(tmp_path):
    """Hot-swap requests name their adapter: the same prompt twice under
    one name is prefilled cold both times and publishes nothing, while a
    static row's repeat is a whole-prompt hit."""
    _, _, jcfg, pcfg = _world("qwen3-smoke")
    base = convert.from_jax_params(np_tree(JM.init_params(KEY, jcfg)), pcfg,
                                   "cpu")
    from repro_torch.core.hadamard import perturb_adapters
    variants = [perturb_adapters(base, 10 + t) for t in range(2)]
    reg = AdapterRegistry(str(tmp_path))
    for t, v in enumerate(variants):
        reg.publish(f"task{t}", launcher.task_delta(v, pcfg))
    hot = MultiTaskEngine(pcfg, AdapterBank(pcfg, base, 2, reg),
                          device="cpu")
    prompt = np.arange(3, 20)
    sched = make_scheduler(hot, ServingConfig(
        num_slots=2, max_len=32, paged=True, page_size=PAGE))
    sched.run([Request(prompt=prompt, max_new_tokens=3, adapter="task1")])
    done, _ = sched.run([Request(prompt=prompt, max_new_tokens=3,
                                 adapter="task1")])
    assert sched.stats == {"full_hits": 0, "partial_hits": 0, "cold": 2}
    assert sched.pool_report()["prefix_full_entries"] == 0
    assert sched.pool_report()["live_blocks"] == 0
    static = MultiTaskEngine(pcfg, variants, device="cpu")
    ssched = make_scheduler(static, ServingConfig(
        num_slots=2, max_len=32, paged=True, page_size=PAGE))
    for _ in range(2):
        sdone, _ = ssched.run([Request(prompt=prompt, max_new_tokens=3,
                                       task_id=1)])
    assert ssched.stats["full_hits"] == 1
    np.testing.assert_array_equal(done[0].tokens, sdone[0].tokens)


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_quantized_kv_blocks_match_jax_and_hold_top1(quant):
    """int8/fp8 KV blocks: JAX's greedy tokens (at fp32 both dequantize in
    fp32), and top-1 agreement with the unquantized contiguous run at
    JAX's own bar (0.8)."""
    jeng, peng, _, pcfg = _world()
    traffic = _traffic(pcfg.vocab_size, seed=9)
    kw = dict(num_slots=3, max_len=48, paged=True, page_size=PAGE,
              num_blocks=40, kv_quant=quant)
    jdone, _ = jmake_scheduler(jeng, JServingConfig(**kw)).run(
        [JRequest(**t) for t in traffic])
    pdone, _ = make_scheduler(peng, ServingConfig(**kw)).run(
        [Request(**t) for t in traffic])
    for j, p in zip(jdone, pdone):
        np.testing.assert_array_equal(p.tokens, np.asarray(j.tokens))
    got = np.concatenate([c.tokens for c in pdone])
    want = np.concatenate(_contiguous(peng, traffic))
    assert (got == want).mean() >= 0.8


def test_paged_scheduler_refuses_recurrent_state_and_bad_pages():
    cfg = peft.attach(get_smoke("rwkv6-1.6b"), peft.strategy("hadamard"))
    eng = launcher.build_engine(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="pure attention"):
        PagedScheduler(eng, num_slots=2, num_blocks=9, page=PAGE, max_len=32)
    with pytest.raises(ValueError, match="pure attention"):
        eng.init_paged_pool(4, PAGE)
    _, peng, _, _ = _world()
    with pytest.raises(ValueError, match="multiple of the page"):
        PagedScheduler(peng, num_slots=2, num_blocks=9, page=PAGE, max_len=36)
    with pytest.raises(ValueError, match="page size"):
        PagedScheduler(peng, num_slots=2, num_blocks=9, page=PAGE, max_len=32,
                       prefill_bucket=12)
