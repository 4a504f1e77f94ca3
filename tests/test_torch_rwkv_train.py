"""The port's RWKV6 training against the JAX package, at the rwkv6-1.6b
smoke size (2 layers, d=64, heads of 16) on the CPU: the recurrence's
autograd Function `WKV6` (#8 forward, the plain chunked backward), the
time mix's VJP, `lm_loss` and its gradients under the Hadamard adapter and
the three baselines, the trainable counts at full size, train steps over
the plain and an int8 trunk, and the train launcher.

JAX makes the weights (every adapter leaf moved off its start by
`perturb_adapters`) and `convert.from_jax_params` carries them over. On
the CPU `ops.wkv6` takes its plain version; JAX differentiates its
chunk-rematted `lax.scan`.
"""
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
from repro.models import rwkv as jrwkv
from repro.train import loop as jloop
from repro.train import losses as jlosses
from repro.train import steps as jsteps
from repro_torch import convert
from repro_torch.common import tree as tu
from repro_torch.common import types as T
from repro_torch.configs import get
from repro_torch.core import peft
from repro_torch.kernels import ref
from repro_torch.kernels.rwkv6 import WKV6
from repro_torch.launch import train as launcher
from repro_torch.models import model as M
from repro_torch.models import rwkv
from repro_torch.quant import is_qtensor
from repro_torch.train import loop, steps
from test_torch_baselines import LEAVES
from test_torch_model import np_tree, port_cfg

KEY = jax.random.PRNGKey(0)
ARCH = "rwkv6-1.6b"
STRATEGIES = ["hadamard", "houlsby", "lora", "ia3"]
LEAVES = dict(LEAVES, hadamard=("w", "b"))
# trainable parameters of each strategy at rwkv6-1.6b's full size, as the
# JAX package counts them (jax.eval_shape of its init)
FULL_COUNTS = {"hadamard": 196_608, "houlsby": 12_880_896,
               "lora": 1_572_864, "ia3": 270_336}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread in each test: the tier-1 run puts several
    test processes on the host's cores, where torch's thread pool over
    these small tensors waits on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# WKV6: the recurrence's backward
# ---------------------------------------------------------------------------


def _wkv_inputs(B, H, T_, n, s0, zeros, seed=0):
    rs = np.random.default_rng(seed)
    r, k, v = (rs.standard_normal((B, H, T_, n)).astype(np.float32)
               for _ in range(3))
    w = 1 / (1 + np.exp(-rs.standard_normal((B, H, T_, n))))
    if zeros:  # exact 0s and 1s: w = exp(-exp(x)) underflows and rounds
        w[..., :3] = 0.0
        w[..., 3:5] = 1.0
    u = (rs.standard_normal((H, n)) * 0.1).astype(np.float32)
    S0 = (rs.standard_normal((B, H, n, n)) * 0.3).astype(np.float32) \
        if s0 else None
    do = rs.standard_normal((B, H, T_, n)).astype(np.float32)
    dS = rs.standard_normal((B, H, n, n)).astype(np.float32)
    return [r, k, v, w.astype(np.float32), u, S0], do, dS


@pytest.mark.parametrize("T_,chunk", [(33, 8), (16, 16), (20, 128)])
@pytest.mark.parametrize("s0", [False, True])
def test_wkv6_backward_matches_autograd_through_the_plain_forward(T_, chunk,
                                                                  s0):
    """dr, dk, dv, dw, du (and ds0 from a given state) of `WKV6` against
    autograd through `ref.wkv6_ref`, with cotangents on o and on the final
    state, over ragged and whole chunks and w with exact 0s and 1s: each
    within 1e-5 of its max |ref|."""
    ins, do, dS = _wkv_inputs(2, 3, T_, 16, s0, zeros=True)
    do, dS = torch.from_numpy(do), torch.from_numpy(dS)

    def grads(fn):
        leaves = [None if a is None else torch.from_numpy(a).requires_grad_()
                  for a in ins]
        o, S = fn(*leaves)
        return torch.autograd.grad(
            [o, S], [t for t in leaves if t is not None], [do, dS])

    want = grads(lambda *a: ref.wkv6_ref(*a))
    got = grads(lambda *a: WKV6.apply(*a, chunk, "auto"))
    assert len(got) == len(want) == (6 if s0 else 5)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert _rel(g, w) <= 1e-5, (i, _rel(g, w))


def test_wkv6_leaves_a_given_state_as_it_was():
    """`ops.wkv6` writes its s0 over; under `WKV6` the caller's state and
    the one the backward reads stay as they were."""
    ins, do, _ = _wkv_inputs(1, 2, 9, 16, True, zeros=False)
    t = [torch.from_numpy(a) for a in ins]
    S0 = t[5].clone()
    r = t[0].clone().requires_grad_()
    o, S = WKV6.apply(r, *t[1:5], t[5], 4, "auto")
    assert torch.equal(t[5], S0) and not torch.equal(S, S0)
    o.backward(torch.from_numpy(do))
    want = torch.autograd.grad(
        ref.wkv6_ref(r, *t[1:5], S0)[0], r, torch.from_numpy(do))[0]
    assert _rel(r.grad, want) <= 1e-5


def _tm_params(jcfg):
    jp = jrwkv.rwkv_tm_init(jax.random.fold_in(KEY, 5), jcfg)
    # a nonzero group-norm affine, so that its gradient path shows
    jp = dict(jp, ln_x_scale=jp["ln_x_scale"] + 0.1,
              ln_x_bias=jp["ln_x_bias"] + 0.05)
    return jp


@pytest.mark.parametrize("cached", [False, True])
def test_time_mix_vjp_matches_jax(cached):
    """The gradient of the time mix's output, with respect to its input and
    every parameter, against `jax.vjp` of JAX's `rwkv_time_mix` (its
    chunk-rematted scan), at 21 steps with rwkv_chunk 8 (the port's chunks
    8, 8, 5; JAX's remat 3 chunks of 7), from a zero state and from a
    cached one: each within 1e-5 of its max |JAX|."""
    _check_time_mix_vjp(cached, "auto")


def test_plain_path_differentiates_the_step_by_step_recurrence(monkeypatch):
    """Under autograd the plain path (impl="ref") differentiates
    `ref.wkv6_ref` step by step and never enters `WKV6`, so the plain path
    that chip_smoke.py holds the kernel path's gradients against shares no
    code with `WKV6`'s backward; its time-mix VJP is JAX's within 1e-5."""
    class Refused:
        @staticmethod
        def apply(*a):
            raise AssertionError("the plain path entered WKV6")

    monkeypatch.setattr(rwkv, "WKV6", Refused)
    _check_time_mix_vjp(False, "ref")


def _check_time_mix_vjp(cached, impl):
    jcfg = jget_smoke(ARCH).replace(rwkv_chunk=8)
    pcfg = port_cfg(jcfg)
    jp = _tm_params(jcfg)
    rs = np.random.default_rng(3)
    B, S, d = 2, 21, jcfg.d_model
    x = rs.standard_normal((B, S, d)).astype(np.float32)
    g = rs.standard_normal((B, S, d)).astype(np.float32)
    cache = None
    if cached:
        n = jcfg.rwkv_head_dim
        cache = {"S": (rs.standard_normal((B, d // n, n, n)) * 0.3
                       ).astype(np.float32),
                 "tm_prev": rs.standard_normal((B, d)).astype(np.float32)}
    jcache = None if cache is None else {
        k: jnp.asarray(v) for k, v in dict(
            cache, cm_prev=np.zeros((B, d), np.float32)).items()}
    (y, jc), vjp = jax.vjp(
        lambda p, x_: jrwkv.rwkv_time_mix(p, jcfg, x_, jcache),
        jp, jnp.asarray(x))
    gp, gx = vjp((jnp.asarray(g), jax.tree.map(jnp.zeros_like, jc)))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    tcache = None if cache is None else {
        k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    ty, _ = rwkv.rwkv_time_mix(tp, pcfg, tx, tcache, impl)
    assert _rel(ty.detach(), y) <= 1e-5
    grads = torch.autograd.grad(ty, [tx] + list(tp.values()),
                                torch.from_numpy(g))
    assert _rel(grads[0], gx) <= 1e-5, _rel(grads[0], gx)
    for name, got in zip(tp, grads[1:]):
        assert _rel(got, gp[name]) <= 1e-5, (name, _rel(got, gp[name]))


# ---------------------------------------------------------------------------
# the LM loss and its gradients, the counts, the train steps
# ---------------------------------------------------------------------------


def _cfgs(sname, **over):
    jcfg = jpeft.attach(jget_smoke(ARCH), jpeft.strategy(sname)).replace(
        **over)
    return jcfg, port_cfg(jcfg)


def _weights(jcfg, pcfg, sname):
    jparams = jhad.perturb_adapters(JM.init_params(KEY, jcfg),
                                    jax.random.fold_in(KEY, 1), scale=0.2,
                                    leaves=LEAVES[sname])
    return jparams, convert.from_jax_params(np_tree(jparams), pcfg, "cpu")


def _batches(n, B=3, S=12, seed=0):
    corpus = jdata.lm_corpus(503, 20_000, seed=seed)
    return list(jdata.lm_batches(corpus, n, B, S, seed=seed))


@pytest.mark.parametrize("sname", STRATEGIES)
def test_lm_loss_and_its_gradients_match_jax(sname):
    """A 2-layer rwkv stack's `lm_loss` (12 tokens, rwkv_chunk 5: ragged
    chunks) and the gradient of every trainable leaf against `jax.grad` of
    JAX's: the loss within 1e-5 relative, each gradient within 1e-4 of its
    max |JAX gradient|; the trainable leaves and counts JAX's. LoRA's and
    IA3's leaves are read by no rwkv op: their gradients are exactly 0 on
    both sides, as are the leaves of the head that the LM loss skips."""
    jcfg, pcfg = _cfgs(sname, rwkv_chunk=5)
    jparams, ported = _weights(jcfg, pcfg, sname)
    batch = _batches(1)[0]
    strat = jpeft.strategy(sname)
    mask = jpeft.trainable_mask(jparams, strat)
    jtr, jfr = jtu.partition(jparams, mask)

    def jloss(tr):
        return jlosses.lm_loss(jcfg, jtu.merge(tr, jfr),
                               {k: jnp.asarray(v) for k, v in batch.items()})

    (wl, _), wg = jax.value_and_grad(jloss, has_aux=True)(jtr)
    state = steps.make_state(None, pcfg, peft.strategy(sname), T.OptimCfg(),
                             params=ported)
    stats = peft.param_stats(state["params"], peft.trainable_mask(
        state["params"], peft.strategy(sname), cfg=pcfg))
    assert stats == jpeft.param_stats(jparams, mask)
    gl, _, gg = steps.loss_and_grads(
        pcfg, state, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    assert abs(gl.item() - float(wl)) <= 1e-5 * abs(float(wl))
    want = {p: np.asarray(v) for p, v in jtu.flatten_with_paths(wg)
            if v is not None}
    got = {}
    for path, g in gg.items():
        got.setdefault(convert.jax_path(path, pcfg), []).append(g.numpy())
    assert set(got) == set(want)
    for path, g in got.items():
        g, w = np.stack(g), want[path]
        if not np.abs(w).max():
            assert not np.abs(g).max(), path
            continue
        assert _rel(g, w) <= 1e-4, (path, _rel(g, w))
    unread = {"lora": ("qa", "qb", "va", "vb"), "ia3": ("lk", "lv", "lff")}
    for leaf in unread.get(sname, ()):
        assert not any(np.abs(g).max() for p, g in got.items()
                       if p.endswith(f"/adapter/{leaf}")), leaf


@pytest.mark.parametrize("sname", STRATEGIES)
def test_full_size_trainable_counts_equal_jaxs(sname):
    """rwkv6-1.6b at full size (a meta-device tree, no memory): the
    trainable count of each strategy and the total equal JAX's, and
    chip_smoke.py's."""
    pcfg = peft.attach(get(ARCH), peft.strategy(sname))
    with torch.device("meta"):
        params = M.init_params(None, pcfg)
    stats = peft.param_stats(params, peft.trainable_mask(
        params, peft.strategy(sname), 2, cfg=pcfg))
    jcfg = jpeft.attach(jget(ARCH), jpeft.strategy(sname))
    shapes = jax.eval_shape(lambda: JM.init_params(KEY, jcfg))
    want = jpeft.param_stats(shapes, jpeft.trainable_mask(
        shapes, jpeft.strategy(sname)))
    assert stats == want
    assert stats["trainable"] == FULL_COUNTS[sname]
    import chip_smoke  # its phases 7r and 8r hold the card to these counts

    if sname in chip_smoke.RWKV_TRAINABLE:
        assert chip_smoke.RWKV_TRAINABLE[sname] == (stats["trainable"],
                                                    stats["total"])


@pytest.mark.parametrize("sname,quant", [("hadamard", None),
                                         ("hadamard", "int8"),
                                         ("houlsby", None)])
def test_rwkv_train_steps_match_jax(sname, quant):
    """3 train steps from one backbone, plain or over an int8 trunk (the
    untied LM head is the one leaf JAX's table quantizes; it runs #7
    forward and the plain fp32 dx): per-step losses within 1e-4 relative,
    each trained leaf within 2e-5 after the last step (lr 3e-3: AdamW's
    first steps move an element by about lr whatever its gradient's size,
    so an element whose gradient is near 0 carries the gradients' fp32
    differences into its update; CPU reading: 1.2e-5 for one of Houlsby's
    8,192 `ffn_ad/up` elements, every other leaf within 1e-5)."""
    jcfg, pcfg = _cfgs(sname)
    jparams, ported = _weights(jcfg, pcfg, sname)
    ocfg = dict(lr=3e-3, total_steps=3)
    batches = _batches(3, B=4, S=16)
    jstate = jsteps.make_state(KEY, jcfg, jpeft.strategy(sname),
                               JOptimCfg(**ocfg), params=jparams, quant=quant)
    jstate, jhist = jloop.run_train(
        jstate, jsteps.build_train_step(jcfg, JOptimCfg(**ocfg)), batches,
        steps=3, log=lambda m: None)
    state = steps.make_state(None, pcfg, peft.strategy(sname),
                             T.OptimCfg(**ocfg), params=ported, quant=quant)
    state, hist = loop.run_train(
        state, steps.build_train_step(pcfg, T.OptimCfg(**ocfg)), batches,
        steps=3, log=lambda m: None)
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [float(h["loss"]) for h in jhist],
                               rtol=1e-4, atol=0)
    want = {p: np.asarray(v) for p, v in
            jtu.flatten_with_paths(jstate["trainable"]) if v is not None}
    got = {}
    for path, t in state["trainable"].items():
        got.setdefault(convert.jax_path(path, pcfg), []).append(
            convert.to_numpy(t))
    assert set(got) == set(want)
    for path, g in got.items():
        np.testing.assert_allclose(np.stack(g), want[path], atol=2e-5,
                                   rtol=0, err_msg=path)
    if quant:
        assert [p for p, leaf in tu.flatten_with_paths(state["params"])
                if is_qtensor(leaf)] == ["lm_head/kernel"]


@pytest.mark.parametrize("extra,line", [
    ([], None), (["--quant", "int8"], "quantized trunk: 1 leaves"),
    (["--peft", "houlsby"], None),
    (["--compress-grads", "--quant-moments", "bf16+int8"],
     "optimizer state: ")])
def test_train_launcher_trains_rwkv6_on_the_cpu(extra, line, capsys):
    launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps",
                   "2", "--batch", "2", "--seq", "8"] + extra)
    out = capsys.readouterr().out
    if line:
        assert line in out, out
    assert out.strip().splitlines()[-1].startswith("final loss: ")
