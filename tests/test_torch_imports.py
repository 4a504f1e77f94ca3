"""Import hygiene and device resolution of the port.

The port and `chip_smoke.py` run where there is no JAX, so neither may
import `jax` or anything of `repro`; nor `msgpack`, `zstandard` or
`ml_dtypes`, which the card's machine lacks too (the port keeps its own
msgpack codec for the checkpoint format). The check runs in a fresh interpreter
started without PYTHONPATH: `src/sitecustomize.py` imports jax at start-up
whenever `src` is on PYTHONPATH, which would hide what the port imports.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro.")
             or m.split(".")[0] in ("msgpack", "zstandard", "ml_dtypes"))
print(json.dumps({{"modules": len(names), "names": names, "bad": bad}}))
"""


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    """Every module of the port, and chip_smoke.py, in one fresh process."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(src=str(ROOT / "src"),
                                             root=str(ROOT))],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["modules"] >= 76, res
    assert {"repro_torch.quant.qtensor", "repro_torch.kernels.quant",
            "repro_torch.kernels.sparse", "repro_torch.sparse.prune",
            "repro_torch.sparse.shared", "repro_torch.checkpoint.store",
            "repro_torch.checkpoint._msgpack", "repro_torch.serving.registry",
            "repro_torch.models.rwkv", "repro_torch.kernels.rwkv6",
            "repro_torch.configs.rwkv6_1_6b", "repro_torch.serving.paged",
            "repro_torch.models.recurrent",
            "repro_torch.configs.recurrentgemma_2b",
            "repro_torch.serving.spec", "repro_torch.optim.qstate",
            "repro_torch.optim.compression",
            "repro_torch.launch.pretrain", "repro_torch.obs",
            "repro_torch.obs.trace", "repro_torch.obs.metrics",
            "repro_torch.obs.export", "repro_torch.obs.slo",
            "repro_torch.obs.aggregate", "repro_torch.obs.profile",
            "repro_torch.obs.regress",
            "repro_torch.serving.admission", "repro_torch.models.moe",
            "repro_torch.configs.deepseek_moe_16b",
            "repro_torch.configs.qwen3_moe_235b_a22b"} <= set(res["names"])
    assert res["bad"] == [], f"the port imported {res['bad']}"


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_serve_engine_without_a_device_or_cuda_raises(monkeypatch):
    from repro_torch.configs import get_smoke
    from repro_torch.models import model as M
    from repro_torch.serving import ServeEngine

    _no_cuda(monkeypatch)
    cfg = get_smoke("qwen3-0.6b")
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, params)
    assert ServeEngine(cfg, params, device="cpu").device.type == "cpu"


def test_serve_launcher_without_a_device_or_cuda_raises(monkeypatch):
    from repro_torch.launch import serve

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "qwen3-0.6b", "--smoke", "--requests", "1"])


def test_serve_launcher_runs_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                "--requests", "3", "--num-slots", "2", "--prompt-len", "5",
                "--new-tokens", "3", "--tasks", "2"])
    out = capsys.readouterr().out
    assert "served 3 requests / 9 tokens" in out and "cpu" in out


def test_chip_smoke_without_cuda_exits_nonzero_and_prints_no_result():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=env, capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
