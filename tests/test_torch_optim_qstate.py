"""The port's optimizer state against the JAX package: quantized AdamW
moments (`optim/qstate.py`), int8 gradient compression with error
feedback (`optim/compression.py`), AdamW over them, the train step's
order (gate, compress, clip, AdamW), the checkpoint of such a state and
its resume, and `launch.pretrain`.

JAX quantizes moments and gradients inside its jitted train step, where
XLA computes absmax / qmax as absmax * fp32(1/qmax) and x - q*scale as
one fused multiply-subtract; the port follows the jitted form
(`quant.qtensor.quantize_jitted`, `residual_of`), so its int8 payloads are
the jitted ones byte for byte. Every comparison runs on the CPU, the
weights made by JAX and carried over by `convert.from_jax_params`.
"""
import dataclasses
import functools
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import tree as jtu
from repro.common.types import OptimCfg as JOptimCfg
from repro.configs import get_smoke as jget_smoke
from repro.core import hadamard as jhad
from repro.core import peft as jpeft
from repro.data import synthetic as jdata
from repro.launch import pretrain as jlaunch_pretrain
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.optim import qstate as jqstate
from repro.train import loop as jloop
from repro.train import pretrain as jpre
from repro.train import steps as jsteps
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager, load_tree, save_tree
from repro_torch.common import types as T
from repro_torch.core import peft
from repro_torch.launch import pretrain as launch_pretrain
from repro_torch.launch import train as launch_train
from repro_torch.optim import adamw, compression, qstate
from repro_torch.quant.qtensor import QTensor, is_qtensor
from repro_torch.train import loop, pretrain, steps
from test_torch_model import np_tree, port_cfg

KEY = jax.random.PRNGKey(0)
PRESETS = ["", "bf16", "bf16+int8", "int8"]
# (m_dtype, v_dtype, qstate_ef) of each case: JAX's presets, and all-int8
# without error feedback
OPTIMS = {p: jlaunch_pretrain.QUANT_PRESETS[p] + (True,) for p in PRESETS}
OPTIMS["int8-no-ef"] = ("int8", "int8", False)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread in each test: the tier-1 run puts several
    test processes on the host's cores, where torch's thread pool over
    these small tensors waits on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ocfgs(case, **kw):
    m, v, ef = OPTIMS[case]
    kw = dict(kw, m_dtype=m, v_dtype=v, qstate_ef=ef)
    return JOptimCfg(**kw), T.OptimCfg(**kw)


def _rows(seed, shape=(48, 40)):
    """fp32 rows whose magnitudes span 1e-9 .. 1e2, row by row, with an
    all-zero row (its scale falls back to 1)."""
    rs = np.random.default_rng(seed)
    x = rs.standard_normal(shape) * 10.0 ** rs.uniform(-9, 2, (shape[0], 1))
    x[3] = 0.0
    return x.astype(np.float32)


def _t(a):
    return convert.to_tensor(np.array(a), "cpu")


def _same_bytes(got, want, what=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert got.tobytes() == want.tobytes(), (
        what, int((got != want).sum()), got.size)


def _qt(jq):
    return QTensor(_t(jq.values), _t(jq.scales))


# ---------------------------------------------------------------------------
# encode / decode and compression, byte for byte
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ef", [False, True])
def test_int8_moments_are_jaxs_jitted_payloads_byte_for_byte(ef):
    """encode_moment's int8 QTensor (and its EF residual) equals JAX's
    jitted encode_moment byte for byte on rows of every magnitude. The
    eager JAX form differs from the jitted one on some of them: the
    division by qmax against the product with its reciprocal, and the
    residual's two roundings against one."""
    jit_enc = jax.jit(functools.partial(jqstate.encode_moment, dtype="int8",
                                        ef=ef))
    differs = 0
    for seed in range(6):
        x = _rows(seed)
        jq, jerr = jit_enc(jnp.asarray(x))
        eq, eerr = jqstate.encode_moment(jnp.asarray(x), "int8", ef=ef)
        q, err = qstate.encode_moment(_t(x), "int8", ef=ef)
        _same_bytes(q.values, jq.values, "values")
        _same_bytes(q.scales, jq.scales, "scales")
        differs += int((np.asarray(eq.scales) != np.asarray(jq.scales)).sum())
        if ef:
            _same_bytes(err.values, jerr.values, "residual values")
            _same_bytes(err.scales, jerr.scales, "residual scales")
            differs += int((np.asarray(eerr.scales)
                            != np.asarray(jerr.scales)).sum())
        else:
            assert err is None and jerr is None
    assert differs > 0, "the jitted and eager JAX forms agree here"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_float_moments_encode_and_decode_as_jax(dtype):
    x = _rows(7)
    want, _ = jqstate.encode_moment(jnp.asarray(x), dtype)
    got, err = qstate.encode_moment(_t(x), dtype)
    assert err is None
    _same_bytes(got.view(torch.int16) if dtype == "bfloat16" else got,
                np.asarray(want).view(np.int16) if dtype == "bfloat16"
                else want, dtype)
    _same_bytes(qstate.decode_moment(got),
                jqstate.decode_moment(want), "decoded")


def test_compress_is_jaxs_jitted_compress_byte_for_byte():
    """A JAX leaf stacked over 3 layers takes one scale; the port's three
    per-layer leaves, grouped as one, take the same scale: the compressed
    gradients and the carried errors equal JAX's jitted ones byte for byte
    over 12 steps, leaf by leaf; the eager JAX form differs."""
    rs = np.random.default_rng(0)
    jit_comp = jax.jit(jcomp.compress)
    jerr = jcomp.ef_init({"stack": jnp.zeros((3, 40)),
                          "emb": jnp.zeros((7, 5))})
    err = compression.ef_init({f"stack/{i}": torch.zeros(40)
                               for i in range(3)} | {"emb": torch.zeros(7, 5)})
    differs = 0
    for step in range(12):
        g = {"stack": (rs.standard_normal((3, 40))
                       * 10.0 ** rs.uniform(-6, 1)).astype(np.float32),
             "emb": rs.standard_normal((7, 5)).astype(np.float32)}
        jg, jerr_new = jit_comp({k: jnp.asarray(v) for k, v in g.items()},
                                jerr)
        eg, eerr = jcomp.compress({k: jnp.asarray(v) for k, v in g.items()},
                                  jerr)
        differs += sum(int((np.asarray(e[k]) != np.asarray(j[k])).sum())
                       for e, j in ((eg, jg), (eerr, jerr_new)) for k in e)
        tg = {f"stack/{i}": _t(g["stack"][i]) for i in range(3)}
        tg["emb"] = _t(g["emb"])
        got, err = compression.compress(
            tg, err, group_of=lambda p: p.split("/")[0])
        jerr = jerr_new
        for i in range(3):
            _same_bytes(got[f"stack/{i}"], np.asarray(jg["stack"])[i],
                        f"step {step} grad {i}")
            _same_bytes(err[f"stack/{i}"], np.asarray(jerr["stack"])[i],
                        f"step {step} err {i}")
        _same_bytes(got["emb"], jg["emb"], f"step {step} emb")
        _same_bytes(err["emb"], jerr["emb"], f"step {step} emb err")
    assert differs > 0


# ---------------------------------------------------------------------------
# the state's layout, AdamW over it, its bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(OPTIMS))
def test_init_opt_state_layout_per_optim_cfg(case):
    jo, to = _ocfgs(case)
    jst = jqstate.init_opt_state({"w": jnp.ones((4, 8)), "b": jnp.ones((8,))},
                                 jo)
    st = adamw.adamw_init({"w": torch.ones(4, 8), "b": torch.ones(8)},
                          ["w"], to)
    assert set(st) - {"decay"} == set(jst)
    assert st["count"] == 0 and st["decay"] == frozenset({"w"})
    for key in set(jst) - {"count"}:
        for leaf in ("w", "b"):
            j, t = jst[key][leaf], st[key][leaf]
            assert is_qtensor(t) == jqstate.is_qtensor(j), (key, leaf)
            if is_qtensor(t):
                _same_bytes(t.values, j.values)
                _same_bytes(t.scales, j.scales)
            else:
                assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
                assert not t.any()
    with pytest.raises(ValueError, match="v_dtype"):
        adamw.adamw_init({"w": torch.ones(2)}, [], T.OptimCfg(v_dtype="int4"))


def _state_to_port(jst, decay):
    def leaf(v):
        return _qt(v) if jqstate.is_qtensor(v) else _t(v)

    st = {k: {p: leaf(v) for p, v in jst[k].items()}
          for k in jst if k != "count"}
    return dict(st, count=int(jst["count"]), decay=frozenset(decay))


@pytest.mark.parametrize("case", list(OPTIMS))
def test_adamw_update_matches_jaxs_jitted_update(case):
    """From the same state (3 jitted JAX updates in) and the same
    gradients, one update on each side: the parameters within 1e-6 of
    their max |JAX| (the two round the fused multiply-adds of the moments
    differently), fp32 moments within 1e-6 of their max |JAX|, bf16 ones
    within one
    bf16 step of the rare element that sits on a rounding edge, and each
    decoded int8 moment within one step of its row's grid."""
    jo, to = _ocfgs(case, lr=1e-2, weight_decay=0.1)
    rs = np.random.default_rng(1)
    params = {"w": rs.standard_normal((6, 16)).astype(np.float32),
              "b": rs.standard_normal((16,)).astype(np.float32)}
    grads = [{k: (rs.standard_normal(v.shape) * s).astype(np.float32)
              for k, v in params.items()} for s in (1.0, 0.3, 1e-3, 2.0)]
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = jadamw.adamw_init(jp, jo)
    upd = jax.jit(lambda g, s, p: jadamw.adamw_update(g, s, p, jo, 1e-2))
    for g in grads[:3]:
        jp, jst = upd({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
    tp = {k: _t(v) for k, v in jp.items()}
    tst = _state_to_port(jst, decay=["w"])
    jp2, jst2 = upd({k: jnp.asarray(v) for k, v in grads[3].items()}, jst, jp)
    tst2 = adamw.adamw_update({k: _t(v) for k, v in grads[3].items()}, tst,
                              tp, to, 1e-2)
    assert tst2["count"] == int(jst2["count"]) == 4
    for k, w in jp2.items():
        w = np.asarray(w)
        np.testing.assert_allclose(tp[k].numpy(), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)
    for key in set(jst2) - {"count"}:
        for k in params:
            j, t = jst2[key][k], tst2[key][k]
            want = np.asarray(jqstate.decode_moment(j))
            got = qstate.decode_moment(t).numpy()
            if is_qtensor(t):
                step = np.asarray(j.scales)
                assert (np.abs(got - want) <= step * (1 + 1e-6)).all(), \
                    (key, k)
            elif t.dtype == torch.bfloat16:
                assert (np.abs(got - want)
                        <= 2.0 ** -7 * np.abs(want) + 1e-30).all(), (key, k)
                assert (got == want).mean() >= 0.95, (key, k)
            else:
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=1e-6 * np.abs(want).max(),
                                           err_msg=f"{key}/{k}")


def _bert(case, steps_=4, **kw):
    jcfg = jpeft.attach(jget_smoke("bert-base"), jpeft.strategy("full"))
    pcfg = port_cfg(jcfg)
    jparams = JM.init_params(KEY, jcfg)
    jo, to = _ocfgs(case, lr=1e-3, total_steps=steps_, warmup_steps=2, **kw)
    return jcfg, pcfg, jparams, jo, to


def _mlm_batches(n, seed=0):
    corpus = jdata.lm_corpus(503, 20_000, seed=seed)
    return list(jpre.mlm_batches(corpus, n, 4, 16, seed=seed))


@pytest.mark.parametrize("case", list(OPTIMS))
def test_state_summary_equals_jaxs(case):
    """The bytes of the whole optimizer state of bert smoke under `full`,
    and of qwen3 smoke under `hadamard` (per-layer (d,) leaves, stacked
    (repeats, d) in JAX), equal JAX's state_summary field for field."""
    jcfg, pcfg, jparams, jo, to = _bert(case)
    jst = jsteps.make_state(KEY, jcfg, jpeft.strategy("full"), jo,
                            params=jparams)
    st = steps.make_state(None, pcfg, peft.strategy("full"), to,
                          params=convert.from_jax_params(np_tree(jparams),
                                                         pcfg, "cpu"))
    assert qstate.state_summary(st["opt"], to) == \
        jqstate.state_summary(jst["opt"], jo)
    qcfg = jpeft.attach(jget_smoke("qwen3-0.6b"), jpeft.strategy("hadamard"))
    qparams = JM.init_params(KEY, qcfg)
    jst = jsteps.make_state(KEY, qcfg, jpeft.strategy("hadamard"), jo,
                            params=qparams)
    st = steps.make_state(None, port_cfg(qcfg), peft.strategy("hadamard"),
                          to, params=convert.from_jax_params(
                              np_tree(qparams), port_cfg(qcfg), "cpu"))
    assert qstate.state_summary(st["opt"], to) == \
        jqstate.state_summary(jst["opt"], jo)


# ---------------------------------------------------------------------------
# train steps against JAX's jitted steps
# ---------------------------------------------------------------------------


def _run_both(jcfg, pcfg, jparams, jo, to, strat, batches):
    jstate = jsteps.make_state(KEY, jcfg, jpeft.strategy(strat), jo,
                               params=jparams)
    jstate, jhist = jloop.run_train(
        jstate, jsteps.build_train_step(jcfg, jo), batches,
        steps=len(batches), log=lambda m: None)
    state = steps.make_state(None, pcfg, peft.strategy(strat), to,
                             params=convert.from_jax_params(
                                 np_tree(jparams), pcfg, "cpu"))
    state, hist = loop.run_train(
        state, steps.build_train_step(pcfg, to), batches,
        steps=len(batches), log=lambda m: None)
    return jstate, [float(h["loss"]) for h in jhist], state, \
        [h["loss"] for h in hist]


@pytest.mark.parametrize("case", list(OPTIMS))
def test_mlm_steps_of_bert_full_match_jax_per_preset(case):
    """2 MLM steps of bert smoke under `full` from one backbone with each
    moment preset (the resume test below takes more steps): losses within
    1e-4 relative a step, every leaf within 2e-5 after the last step (an
    AdamW step moves an element by about lr = 1e-3; the jitted step and the
    port round the moments' multiply-adds differently, which may move an
    int8 moment by one grid step), and the state's layout JAX's.

    All-int8 without error feedback is held leaf by leaf after its first
    step only, where both sides' moments are exact: from then on, an
    element whose v rounds to the zero grid point on one side alone steps
    by m / eps (the deadzone of `optim.qstate`'s docstring), so the two
    runs part element by element (656 of 112,002 elements beyond 2e-5
    after 4 steps on the CPU) while their losses still agree."""
    n_leaf = 1 if case == "int8-no-ef" else 2
    batches = _mlm_batches(2)
    jcfg, pcfg, jparams, jo, to = _bert(case, steps_=2)
    jstate = jsteps.make_state(KEY, jcfg, jpeft.strategy("full"), jo,
                               params=jparams)
    jstep = jsteps.build_train_step(jcfg, jo, loss_fn=jpre.mlm_loss)
    state = steps.make_state(None, pcfg, peft.strategy("full"), to,
                             params=convert.from_jax_params(
                                 np_tree(jparams), pcfg, "cpu"))
    step = steps.build_train_step(pcfg, to, loss_fn=pretrain.mlm_loss)
    jl, pl = [], []
    # one step at a time through the same step functions (one compile)
    for n, batch in enumerate(batches, 1):
        jstate, jh = jloop.run_train(jstate, jstep, [batch], steps=1,
                                     log=lambda m: None)
        state, h = loop.run_train(state, step, [batch], steps=1,
                                  log=lambda m: None)
        jl.append(float(jh[0]["loss"]))
        pl.append(h[0]["loss"])
        if n != n_leaf:
            continue
        want = dict(jtu.flatten_with_paths(
            np_tree(jsteps.merged_params(jstate))))
        got = dict(jtu.flatten_with_paths(
            convert.to_jax_params(steps.merged_params(state), pcfg)))
        assert set(got) == set(want)
        worst = max(np.abs(got[p] - w).max() for p, w in want.items())
        assert worst <= 2e-5, (n, worst)
    np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=0)
    assert set(state["opt"]) - {"decay"} == set(jstate["opt"])


def test_compressed_gradient_steps_match_jax():
    """5 steps of qwen3 smoke's adapter with compress_grads and bf16+int8
    moments: losses within 1e-4 relative, the trained leaves within 2e-5
    (lr is 3e-3), and each error buffer, stacked per JAX leaf, JAX's within
    1e-6 but for at most one element in a hundred: where the two sides'
    gradients differ by a rounding at an int8 rounding edge, one element's
    compressed gradient, and so its error, lands one grid step of its group
    apart (CPU readings: 1 of 128 elements of the adapter's b, 1.0e-5
    apart, and of the norm scale, 4.5e-7 apart)."""
    jcfg = jpeft.attach(jget_smoke("qwen3-0.6b"), jpeft.strategy("hadamard"))
    pcfg = port_cfg(jcfg)
    jparams = jhad.perturb_adapters(JM.init_params(KEY, jcfg),
                                    jax.random.fold_in(KEY, 1), scale=0.2)
    jo, to = _ocfgs("bf16+int8", lr=3e-3, total_steps=5,
                    compress_grads=True)
    corpus = jdata.lm_corpus(503, 20_000, seed=0)
    batches = list(jdata.lm_batches(corpus, 5, 4, 16, seed=0))
    jstate, jl, state, pl = _run_both(jcfg, pcfg, jparams, jo, to,
                                      "hadamard", batches)
    np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=0)
    assert "err" in state and "err" in jstate
    for name in ("trainable", "err"):
        want = {p: np.asarray(v).astype(np.float32) for p, v in
                jtu.flatten_with_paths(jstate[name]) if v is not None}
        got = {}
        for path, t in state[name].items():
            got.setdefault(convert.jax_path(path, pcfg), []).append(
                convert.to_numpy(t))
        assert set(got) == set(want)
        for p, w in want.items():
            d = np.abs(np.stack(got[p]).astype(np.float32) - w)
            if name == "trainable":
                assert d.max() <= 2e-5, (p, d.max())
            else:
                assert (d > 1e-6).mean() <= 0.01, (p, (d > 1e-6).sum())


# ---------------------------------------------------------------------------
# checkpoints and resume
# ---------------------------------------------------------------------------


def _pstate(case, **kw):
    jcfg, pcfg, jparams, jo, to = _bert(case, **kw)
    ported = convert.from_jax_params(np_tree(jparams), pcfg, "cpu")
    return pcfg, to, steps.make_state(None, pcfg, peft.strategy("full"), to,
                                      params=ported)


@pytest.mark.parametrize("case", ["bf16", "bf16+int8", "int8-no-ef"])
def test_checkpoint_keeps_moments_in_their_dtype(case, tmp_path):
    """A state after 2 steps saved and loaded: every moment, residual and
    error buffer comes back as stored (a QTensor's int8 values and fp32
    scales, bf16 as bf16), byte for byte; a state of another OptimCfg
    (moment dtypes, error feedback, compression) refuses it."""
    pcfg, to, state = _pstate(case, compress_grads=True)
    step = steps.build_train_step(pcfg, to, loss_fn=pretrain.mlm_loss)
    state, _ = loop.run_train(state, step, _mlm_batches(2), steps=2,
                              log=lambda m: None)
    path = str(tmp_path / "s.ckpt")
    save_tree(path, steps.state_tree(state))
    tree, _ = load_tree(path)
    for key in ("m", "v", "m_err", "v_err"):
        for p, t in state["opt"].get(key, {}).items():
            got = tree["opt"][key]
            for part in p.split("/"):
                got = got[part]
            assert is_qtensor(got) == is_qtensor(t), (key, p)
            if is_qtensor(t):
                _same_bytes(got.values, t.values.numpy())
                _same_bytes(got.scales, t.scales.numpy())
            else:
                assert got.dtype == t.dtype and torch.equal(got, t)
    assert set(tree["err"]) == {p.split("/")[0] for p in state["err"]}
    for other in (dataclasses.replace(to, m_dtype="float32"),
                  dataclasses.replace(to, qstate_ef=not to.qstate_ef),
                  dataclasses.replace(to, compress_grads=False)):
        if other == to or (other.qstate_ef != to.qstate_ef
                           and "int8" not in (to.m_dtype, to.v_dtype)):
            continue
        fresh = steps.make_state(None, pcfg, peft.strategy("full"), other,
                                 params=steps.merged_params(state))
        with pytest.raises(ValueError, match="optimizer|checkpoint"):
            steps.restore_state(fresh, tree)


@pytest.mark.parametrize("case", ["bf16+int8", "int8"])
def test_quantized_moment_resume_is_bit_identical(case, tmp_path):
    """4 steps saving at step 2, then a fresh state restored from step 2
    takes steps 3-4 on the same batches: losses, trainable leaves,
    moments, residuals and error buffers bit for bit the unbroken run's."""
    batches = _mlm_batches(4)
    pcfg, to, whole = _pstate(case, compress_grads=True)
    base = {p: t.detach().clone() for p, t in whole["trainable"].items()}
    step = steps.build_train_step(pcfg, to, loss_fn=pretrain.mlm_loss)
    mgr = CheckpointManager(str(tmp_path), keep=3)
    whole, hw = loop.run_train(whole, step, batches, steps=4, manager=mgr,
                               save_every=2, log=lambda m: None)
    _, _, fresh = _pstate(case, compress_grads=True)
    assert all(torch.equal(fresh["trainable"][p], t) for p, t in base.items())
    restored, meta = mgr.restore(2)
    steps.restore_state(fresh, restored)
    assert fresh["step"] == meta["step"] == 2
    fresh, hr = loop.run_train(fresh, step, batches[2:], steps=2,
                               log=lambda m: None)
    assert [h["loss"] for h in hr] == [h["loss"] for h in hw[2:]]
    a = dict(steps.state_tree(whole).items())
    b = steps.state_tree(fresh)
    from repro_torch.common import tree as tu

    fa, fb = dict(tu.flatten_with_paths(a)), dict(tu.flatten_with_paths(b))
    assert set(fa) == set(fb)
    for p, t in fa.items():
        u = fb[p]
        if is_qtensor(t):
            assert torch.equal(t.values, u.values) and \
                torch.equal(t.scales, u.scales), p
        else:
            assert torch.equal(t, u), p


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


def _jax_pretrain_lines(argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["pretrain"] + argv)
    jlaunch_pretrain.main()
    return capsys.readouterr().out.strip().splitlines()


@pytest.mark.parametrize("preset,ef", [("bf16+int8", True), ("int8", False)])
def test_pretrain_launcher_runs_resumes_and_prints_jaxs_lines(
        preset, ef, tmp_path, monkeypatch, capsys):
    """`launch.pretrain` on the CPU at bert-tiny: its backbone and
    optimizer-state lines are JAX's launcher's, word for word (JAX's
    launcher prints both before it trains, so it runs 0 steps here); a run
    saving every 3 steps, then `--resume` from the last snapshot at step
    3 of 6, replays the stream and ends on the unbroken run's loss."""
    argv = ["--arch", "bert-tiny", "--steps", "6", "--batch", "4", "--seq",
            "16", "--quant-moments", preset, "--log-every", "0"] + \
        ([] if ef else ["--no-ef"])
    want = _jax_pretrain_lines(argv[:2] + ["--steps", "0"] + argv[4:]
                               + ["--ckpt-dir", str(tmp_path / "j")],
                               monkeypatch, capsys)
    assert want[-1].startswith("nothing to do")
    launch_pretrain.main(argv + ["--device", "cpu"])
    whole = capsys.readouterr().out.strip().splitlines()
    assert whole[:2] == want[:2]
    assert re.match(r"done: mlm ce [\d.]+ -> [\d.]+ over steps 0..6$",
                    whole[-1])
    d = str(tmp_path / "t")
    launch_pretrain.main(argv[:2] + ["--steps", "3"] + argv[4:] +
                         ["--device", "cpu", "--save-every", "3",
                          "--ckpt-dir", d])
    capsys.readouterr()
    launch_pretrain.main(argv + ["--device", "cpu", "--ckpt-dir", d,
                                 "--resume"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[:2] == want[:2]
    assert f"resumed from step 3 in {d}" in out
    assert out[-1].endswith("over steps 3..6")
    assert out[-1].split(" -> ")[1].split()[0] == \
        whole[-1].split(" -> ")[1].split()[0]


@pytest.mark.parametrize("extra", [
    ["--quant-moments", "bf16"], ["--quant-moments", "int8", "--no-ef"],
    ["--compress-grads", "--quant-moments", "bf16+int8"]])
def test_train_launcher_takes_jaxs_optimizer_flags(extra, capsys):
    """--quant-moments, --no-ef and --compress-grads run on the decoder
    path and print JAX's optimizer-state line."""
    launch_train.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "8"] + extra)
    out = capsys.readouterr().out
    assert re.search(r"optimizer state: [\d.]+ MiB for 384 params \(fp32 "
                     r"would be [\d.]+ MiB; [\d.]+x\)", out)
    assert out.strip().splitlines()[-1].startswith("final loss: ")
