"""The port's dry run, its collective counts, and the layout-free train
checkpoint.

  * the per-group linear extrapolation from repeats 1 and 2 equals
    `FlopCounterMode` over the whole stack, for every architecture and
    step kind (smoke widths, each group three deep);
  * a decode step at 1x2 counts 2 x layers + 1 all-reduces of
    B x d x dtype bytes (the two row-parallel outputs a layer and the
    vocab-parallel embedding) and one all-gather of the head's vocab
    columns; a prefill, the same over B x S rows;
  * the CLI writes JAX's record keys, a refused mesh's reason beside the
    one-device FLOPs, and null for what has no meta-device counterpart;
  * inside `cost_mode_ctx` a meta tensor takes a kernel's plain version,
    outside it raises;
  * a train checkpoint written at 1x2 resumes at 2x1 to the same next
    loss (the port's counterpart of JAX's
    `test_elastic_reshard_checkpoint`).
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.data.synthetic import lm_batches, lm_corpus

from repro_torch.common.costmode import cost_mode_ctx
from repro_torch.common.types import OptimCfg, ShapeSpec
from repro_torch.configs import ASSIGNED, get_smoke
from repro_torch.core import peft
from repro_torch.dist.api import Mesh
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import run_world
from repro_torch.launch.specs import params_shapes
from test_torch_model import port_cfg

import torch_dist_ranks as ranks

HADAMARD = peft.strategy("hadamard")


def _smoke(arch, **kw):
    return peft.attach(get_smoke(arch).replace(**kw), HADAMARD)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", sorted(ASSIGNED))
def test_linear_extrapolation_equals_the_full_depth_count(arch, kind):
    cfg = _smoke(arch)
    deep = D._replace_repeats(cfg, [3] * len(cfg.groups),
                              [3] * len(cfg.enc_groups))
    spec = ShapeSpec("t", 32, 4, kind)
    got = D.proxy_costs(deep, spec, None, HADAMARD)
    want = D.count_step(deep, spec, None, HADAMARD, OptimCfg())
    assert got["flops"] > 0
    assert got["flops"] == want["flops"]
    assert got["coll"] == want["coll"] == 0.0


@pytest.mark.parametrize("kind,rows", [("decode", 1), ("prefill", 16)])
def test_collectives_of_a_step_at_1x2(kind, rows):
    cfg = _smoke("qwen3-0.6b", n_kv_heads=4, vocab_size=512)
    B, L = 4, cfg.n_layers
    item = torch.empty((), dtype=cfg.cdtype).element_size()
    got = D.count_step(cfg, ShapeSpec("t", 16, B, kind), Mesh((1, 2)),
                       HADAMARD, OptimCfg())
    ar, ag = got["coll_detail"]["all-reduce"], got["coll_detail"]["all-gather"]
    assert got["coll_detail"]["count"] == (2 * L + 1) + 1
    assert ar == (2 * L + 1) * B * rows * cfg.d_model * item
    # the prefill's head reads the last position alone
    assert ag == B * 1 * (cfg.vocab_size // 2) * item
    assert got["coll"] == ar + ag
    # a rank runs half the heads and half the MLP
    one = D.count_step(cfg, ShapeSpec("t", 16, B, kind), None, HADAMARD,
                       OptimCfg())
    assert 0.4 * one["flops"] < got["flops"] < 0.6 * one["flops"]


def test_cli_writes_jax_record_keys(tmp_path):
    out = tmp_path / "dry.json"
    D.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--mesh", "1x1",
            "--out", str(out)])
    D.main(["--arch", "internvl2-76b", "--shape", "prefill_32k", "--mesh",
            "single", "--out", str(out), "--no-costs"])
    recs = {r["key"][0]: r for r in json.loads(out.read_text())}
    q = recs["qwen3-0.6b"]
    assert q["status"] == "ok" and q["n_devices"] == 1
    params = params_shapes(peft.attach(D.get_cfg("qwen3-0.6b"), HADAMARD))
    assert q["memory"]["param_bytes"] == sum(
        t.numel() * t.element_size()
        for _, t in D.tu.flatten_with_paths(params) if t is not None)
    assert q["memory"]["temp_bytes"] is None and q["memory"]["temp_bytes_reason"]
    assert q["costs"]["bytes"] is None and q["costs"]["bytes_reason"]
    assert q["costs"]["flops"] == q["costs"]["global_flops"] > 0
    assert {"model_flops", "model_flops_peft", "n_active_params",
            "n_total_params"} <= set(q)
    v = recs["internvl2-76b"]
    assert v["n_devices"] == 256 and "costs" not in v
    # tp_fsdp shards over data too: 1/256 of the weights a device
    assert v["memory"]["param_bytes"] < 0.6e9

    # a refused mesh: the reason, beside the one-device count
    rec = D.run_cell("deepseek-moe-16b", "decode_32k", "1x2")
    assert rec["status"] == "ok" and rec["n_devices"] == 2
    assert rec["costs"]["flops"] is None
    assert "expert parallelism" in rec["costs"]["reason"]
    assert rec["costs"]["global_flops"] > 0


def test_meta_tensors_take_the_plain_version_in_cost_mode_alone():
    t = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.use_kernel(t, "auto")
    with cost_mode_ctx():
        assert ops.use_kernel(t, "auto") is False
    with pytest.raises(ValueError, match="no kernel"):
        ops.use_kernel(t, "auto")


def _world(shape, fn, *args):
    saved = os.environ.pop("PYTHONPATH", None)  # see test_torch_dist._world
    try:
        return run_world(shape, fn, *args, device="cpu", timeout=300)
    finally:
        if saved is not None:
            os.environ["PYTHONPATH"] = saved


def test_checkpoint_written_at_1x2_resumes_at_2x1(tmp_path):
    """Three steps at 1x2, rank 0 saving after two; then a 2x1 world from
    the same weights restores that checkpoint and takes the third step:
    the same loss and adapters, since the train state (trainable leaves
    and moments) is replicated over 'model' and written whole."""
    import jax

    from conftest import tiny_cfg
    from repro.core import peft as jpeft
    from repro.models import model as JM
    from test_torch_model import np_tree

    jc = jpeft.attach(tiny_cfg(), jpeft.strategy("hadamard"))
    pc = port_cfg(jc)
    params = np_tree(JM.init_params(jax.random.PRNGKey(0), jc))
    ocfg = OptimCfg(lr=1e-3, total_steps=4, grad_clip=1.0)
    batches = list(lm_batches(lm_corpus(97, 4000, seed=1), 3, 8, 16,
                              seed=2))
    case = {"cfg": pc, "ocfg": ocfg, "params": params}
    whole = _world((1, 2), ranks.train_steps,
                   dict(case, batches=batches, save_dir=str(tmp_path),
                        save_after=2))
    assert os.listdir(tmp_path)
    resumed = _world((2, 1), ranks.train_steps,
                     dict(case, batches=batches[2:],
                          resume_dir=str(tmp_path)))
    for r, out in enumerate(resumed):
        np.testing.assert_allclose(out["losses"], whole[0]["losses"][2:],
                                   rtol=1e-5, err_msg=f"rank {r}")
        for p, w in whole[0]["adapters"].items():
            np.testing.assert_allclose(out["adapters"][p], w, rtol=2e-4,
                                       atol=2e-6, err_msg=f"rank {r} {p}")
