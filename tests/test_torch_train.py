"""The port's trainer against the JAX package: optimizer, schedule, data,
metrics, the paper's two-stage recipe and the training launcher.

Both packages start from the same JAX-made backbone (carried over by
`convert.from_jax_params`) and the same synthetic task data, and train on
the CPU, where the port's kernel calls take their plain versions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import tree as jtu
from repro.common.types import OptimCfg as JOptimCfg
from repro.common.types import TrainCfg as JTrainCfg
from repro.configs import get as jget
from repro.data import synthetic as jdata
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.train import loop as jloop
from repro.train import metrics as jmetrics
from repro_torch import convert
from repro_torch.common import types as T
from repro_torch.configs import get
from repro_torch.data import synthetic as tdata
from repro_torch.launch import train as launcher
from repro_torch.optim import adamw, schedule
from repro_torch.train import loop, metrics

KEY = jax.random.PRNGKey(0)


def test_train_configs_match_jax_field_for_field():
    assert dataclasses.asdict(T.OptimCfg()) == dataclasses.asdict(JOptimCfg())
    assert dataclasses.asdict(T.TrainCfg()) == dataclasses.asdict(JTrainCfg())


@pytest.mark.parametrize("sched", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("warmup", [0, 4])
def test_lr_at_matches_jax(sched, warmup):
    kw = dict(lr=3e-3, schedule=sched, warmup_steps=warmup, total_steps=20,
              min_lr_ratio=0.1)
    for step in range(25):
        want = float(jschedule.lr_at(JOptimCfg(**kw), step))
        got = schedule.lr_at(T.OptimCfg(**kw), step)
        assert abs(got - want) <= 1e-6 * want


def test_adamw_update_and_clip_match_jax():
    rs = np.random.default_rng(0)
    params = {"m": rs.standard_normal((6, 5)).astype(np.float32),
              "v": rs.standard_normal((5,)).astype(np.float32)}
    ocfg = dict(lr=1e-2, weight_decay=0.1)
    jstate = jadamw.adamw_init({k: jnp.asarray(v) for k, v in params.items()},
                               JOptimCfg(**ocfg))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = adamw.adamw_init(tp, decay=["m"])  # JAX decays ndim >= 2
    for step in range(3):
        g = {k: (rs.standard_normal(v.shape) * 3).astype(np.float32)
             for k, v in params.items()}
        jg, jnorm = jadamw.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, 1.0)
        tg, tnorm = adamw.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
        assert abs(float(tnorm) - float(jnorm)) <= 1e-6 * float(jnorm)
        lr = schedule.lr_at(T.OptimCfg(**ocfg, total_steps=3), step)
        jp, jstate = jadamw.adamw_update(jg, jstate, jp, JOptimCfg(**ocfg), lr)
        tstate = adamw.adamw_update(tg, tstate, tp, T.OptimCfg(**ocfg), lr)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=0)
            np.testing.assert_allclose(tstate["m"][k].numpy(),
                                       np.asarray(jstate["m"][k]), atol=1e-6,
                                       rtol=0)
    assert tstate["count"] == int(jstate["count"]) == 3


@pytest.mark.parametrize("task", ["sst2", "mnli", "stsb"])
def test_task_data_is_byte_identical_to_jax(task):
    want = jdata.TaskData(task, 2048, seq_len=24, n_train=64, n_eval=32,
                          seed=3)
    got = tdata.TaskData(task, 2048, seq_len=24, n_train=64, n_eval=32,
                         seed=3)
    for split in ("train", "eval"):
        assert set(got.__dict__[split]) == set(want.__dict__[split])
        for k, v in want.__dict__[split].items():
            g = got.__dict__[split][k]
            assert g.dtype == v.dtype and g.tobytes() == v.tobytes()
    for gb, wb in zip(got.train_batches(3, 5, seed=1),
                      want.train_batches(3, 5, seed=1)):
        assert all(gb[k].tobytes() == wb[k].tobytes() for k in wb)
    assert dataclasses.asdict(got.spec) == dataclasses.asdict(
        jdata.TASKS[task])


def test_metrics_match_jax():
    rs = np.random.default_rng(1)
    preds, labels = rs.integers(0, 2, 200), rs.integers(0, 2, 200)
    for name in ("acc", "mcc"):
        assert metrics.metric_fn(name)(preds, labels) == \
            jmetrics.metric_fn(name)(preds, labels)
    x, y = rs.standard_normal(50), rs.standard_normal(50)
    assert metrics.pearson(x, y) == jmetrics.pearson(x, y)
    assert metrics.matthews_corrcoef(np.zeros(4), np.zeros(4)) == 0.0


@pytest.mark.parametrize("sname", ["hadamard", "hadamard_concat"])
def test_two_stage_finetune_matches_jax(sname):
    """3 + 3 steps on bert-tiny from one backbone. lr 3e-3: one AdamW step
    moves an element by about lr (its first step is nearly lr * sign(g)),
    so the 1e-5 tolerance on the trained leaves allows a relative
    difference of ~1e-3 in each update, far above fp32 noise and far below
    the 2 * lr of one sign that flips between the packages."""
    jcfg, pcfg = jget("bert-tiny"), get("bert-tiny")
    tc = dict(steps=3, batch_size=4, seq_len=16, log_every=0)
    jtc = JTrainCfg(optim=JOptimCfg(lr=3e-3, total_steps=3), **tc)
    ttc = T.TrainCfg(optim=T.OptimCfg(lr=3e-3, total_steps=3), **tc)
    backbone = JM.init_params(KEY, jcfg)
    want = jloop.two_stage_finetune(
        KEY, jcfg, sname, jdata.TaskData("sst2", jcfg.vocab_size, seq_len=16),
        stage1=jtc, stage2=jtc, pretrained_params=backbone, log=lambda m: None)
    got = loop.two_stage_finetune(
        0, pcfg, sname, tdata.TaskData("sst2", pcfg.vocab_size, seq_len=16),
        stage1=ttc, stage2=ttc, device="cpu", log=lambda m: None,
        pretrained_params=convert.from_jax_params(
            jax.tree.map(np.asarray, backbone), pcfg, "cpu"))
    for stage in ("stage1", "stage2"):
        wl = [float(h["loss"]) for h in want["history"][stage]]
        gl = [h["loss"] for h in got["history"][stage]]
        np.testing.assert_allclose(gl, wl, rtol=1e-4, atol=0)
    assert got["stage1_metric"] == want["stage1_metric"]
    assert got["final_metric"] == want["final_metric"]
    assert got["param_stats"] == want["param_stats"]
    gtree = dict(jtu.flatten_with_paths(
        convert.to_jax_params(got["params"], got["cfg"])))
    trained = 0
    for path, w in jtu.flatten_with_paths(want["params"]):
        if "/adapter/" in path or "/ffn_norm/" in path or \
                path.startswith(("pooler/", "classifier/")):
            np.testing.assert_allclose(gtree[path], np.asarray(w), atol=1e-5,
                                       rtol=0, err_msg=path)
            trained += 1
    assert trained == 8


def test_train_launcher_without_a_device_or_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launcher.main(["--arch", "bert-tiny", "--smoke", "--steps", "1"])


def test_train_launcher_runs_on_the_cpu_when_asked(capsys):
    launcher.main(["--arch", "bert-tiny", "--smoke", "--device", "cpu",
                   "--steps", "2", "--batch", "4", "--seq", "16"])
    out = capsys.readouterr().out
    assert "[stage1] classifier-only acc=" in out
    assert "[stage2] hadamard acc=" in out
    assert out.strip().splitlines()[-1].startswith("final acc: ")


SHORT = ["--steps", "2", "--batch", "4", "--seq", "16"]


@pytest.mark.parametrize("argv,match", [
    # rwkv6 LM fine-tuning and quantized moments are ported: they run and
    # print their lines (a list of lines to find, not an error to match)
    pytest.param(["--arch", "rwkv6-1.6b", "--smoke"] + SHORT,
                 ["final loss: "], id="argv0-decoder-LM"),
    pytest.param(["--arch", "bert-tiny", "--smoke", "--quant-moments",
                  "int8"] + SHORT, ["[stage2] hadamard acc=", "final acc: "],
                 id="argv1-quantization"),
    # gated training is ported: it runs, with JAX's line (match None)
    pytest.param(["--arch", "bert-tiny", "--smoke", "--prune-to", "1",
                  "--steps", "2", "--batch", "4", "--seq", "16"], None,
                 id="argv2-sparse"),
    (["--arch", "bert-tiny", "--mesh", "2x4"], "distributed"),
])
def test_train_launcher_later_slices_raise(argv, match, capsys):
    """The one option of a later slice (--mesh) raises; the options that
    have arrived run."""
    if isinstance(match, list):
        launcher.main(argv + ["--device", "cpu"])
        out = capsys.readouterr().out
        assert all(line in out for line in match), out
        assert out.strip().splitlines()[-1].startswith(match[-1])
        return
    if match is None:
        launcher.main(argv + ["--device", "cpu"])
        out = capsys.readouterr().out
        assert "pruned training: top 1/2 layers' adapters unfrozen " \
               "(mask-gated gradients)" in out
        # stage 2 counts the top layer's adapter w, b and ffn_norm alone
        assert "[stage2] hadamard acc=" in out and "trainable=256 " in out
        return
    with pytest.raises(NotImplementedError, match=match):
        launcher.main(argv + ["--device", "cpu"])
