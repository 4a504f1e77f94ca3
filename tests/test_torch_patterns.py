"""The port's tuning-pattern analysis (paper Fig. 5, `core/patterns.py`)
against the JAX package: per-layer distributions of the adapters' w and
b, cross-task cosines, their summary and the shared-w proposal, on three
tasks' adapters made by JAX and carried over by `convert`."""
import jax
import numpy as np
import pytest

from repro.configs import get_smoke as jget_smoke
from repro.core import hadamard as jhad
from repro.core import patterns as jpat
from repro.core import peft as jpeft
from repro.models import model as JM
from repro_torch import convert
from repro_torch.core import patterns
from test_torch_model import np_tree, port_cfg

KEY = jax.random.PRNGKey(0)


def _tasks(zero_b_task=False):
    """Three tasks' adapters sharing a w moved once (the paper's finding
    that w agrees across tasks) and each with its own b; with
    zero_b_task, one task keeps b = 0 (a zero norm, cosine 0)."""
    jcfg = jpeft.attach(jget_smoke("bert-base"), jpeft.strategy("hadamard"))
    pcfg = port_cfg(jcfg)
    base = jhad.perturb_adapters(JM.init_params(KEY, jcfg),
                                 jax.random.fold_in(KEY, 1), scale=0.1,
                                 leaves=("w",))
    jtasks = {}
    for i, name in enumerate(("sst2", "cola", "mrpc")):
        jtasks[name] = base if zero_b_task and i == 2 else \
            jhad.perturb_adapters(base, jax.random.fold_in(KEY, 10 + i),
                                  scale=0.3, leaves=("b",))
    ported = {t: convert.from_jax_params(np_tree(p), pcfg, "cpu")
              for t, p in jtasks.items()}
    return jcfg, pcfg, jtasks, ported


@pytest.mark.parametrize("zero_b_task", [False, True])
def test_patterns_match_jax(zero_b_task):
    """Every number within 1e-6 of JAX's."""
    jcfg, pcfg, jtasks, ported = _tasks(zero_b_task)
    want = jpat.layer_distributions(jtasks["sst2"], jcfg)
    got = patterns.layer_distributions(ported["sst2"], pcfg)
    assert set(got) == set(want) == {"w", "b"}
    for k in want:
        assert got[k].shape == (pcfg.n_layers, 5)
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0)
    wsim = jpat.cross_task_similarity(jtasks, jcfg)
    sim = patterns.cross_task_similarity(ported, pcfg)
    assert sim["tasks"] == wsim["tasks"] == ["cola", "mrpc", "sst2"]
    for k in ("w", "b"):
        assert sim[k].shape == (pcfg.n_layers, 3, 3)
        np.testing.assert_allclose(sim[k], wsim[k], atol=1e-6, rtol=0)
    rep, wrep = (patterns.consistency_report(sim),
                 jpat.consistency_report(wsim))
    assert set(rep) == set(wrep)
    for k in wrep:
        assert abs(rep[k] - wrep[k]) <= 1e-6, k
    # the planted pattern: w shared (cosine ~1), b apart
    assert rep["w_mean_cross_task_cos"] > 0.99
    assert rep["b_mean_cross_task_cos"] < 0.5
    w, bs = patterns.suggest_shared_weight(ported, pcfg)
    jw, jbs = jpat.suggest_shared_weight(jtasks, jcfg)
    np.testing.assert_allclose(w, jw, atol=1e-6, rtol=0)
    assert set(bs) == set(jbs)
    for t in jbs:
        np.testing.assert_allclose(bs[t], jbs[t], atol=1e-6, rtol=0)
