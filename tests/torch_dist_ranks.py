"""Rank programs of the port's distribution tests (`test_torch_dist.py`,
`test_torch_dryrun.py`). Each runs in a spawned rank (`launch.mesh.
run_world`), so this module imports the port alone: no JAX. Inputs arrive
as numpy (JAX's weights, batches and prompts); results leave as numpy."""
import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import peft
from repro_torch.data.pipeline import shard_batch
from repro_torch.dist.api import (collective_counts, reset_collectives,
                                  use_mesh)
from repro_torch.dist.sharding import local_cfg
from repro_torch.models import model as M
from repro_torch.serving import (MultiTaskEngine, Request, ServeEngine,
                                 ServingConfig, make_scheduler)
from repro_torch.train.loop import to_device
from repro_torch.train.steps import (build_train_step, loss_and_grads,
                                     make_mesh_state, restore_state,
                                     state_tree)


def _engine(mesh, case):
    cfg = case["cfg"]
    trees = [convert.from_jax_params(t, cfg, "cpu") for t in case["params"]]
    with use_mesh(mesh):
        if case.get("tasks"):
            return MultiTaskEngine(cfg, trees, quant=case.get("quant"),
                                   device="cpu")
        return ServeEngine(cfg, trees[0], quant=case.get("quant"),
                           device="cpu")


def _logits(eng, case):
    """Prefill logits of the prompts, then greedy decode steps' logits."""
    toks = torch.as_tensor(case["prompts"], dtype=torch.long)
    patches = case.get("patches")
    B, S = toks.shape
    n_img = 0 if patches is None else patches.shape[1]
    with eng._calls():
        reset_collectives()
        logits, caches = M.prefill_lm(
            eng.params, eng.cfg, toks, case["cache_len"],
            patches=None if patches is None else torch.as_tensor(patches))
        colls = collective_counts()
        out = [logits.numpy()]
        for i in range(case["steps"]):
            tok = logits[:, -1].argmax(-1)
            logits, caches = M.decode_lm(
                eng.params, eng.cfg, caches, tok[:, None],
                torch.full((B,), n_img + S + i, dtype=torch.long))
            out.append(logits.numpy())
    return {"logits": out, "prefill_colls": colls}


def _tokens(eng, case):
    done, _ = make_scheduler(eng, ServingConfig(
        num_slots=case["num_slots"], max_len=case["max_len"])).run(
        [Request(**t) for t in case["traffic"]])
    return {"tokens": [np.asarray(c.tokens) for c in done]}


def serve_cases(mesh, cases):
    """Each case's engine built under the mesh: its logits ("prompts") or
    its scheduler's greedy tokens ("traffic"); the local KV heads."""
    out = {}
    for case in cases:
        eng = _engine(mesh, case)
        res = {"n_kv_heads": eng.cfg.n_kv_heads}
        if "prompts" in case:
            res.update(_logits(eng, case))
        if "traffic" in case:
            res.update(_tokens(eng, case))
        out[case["name"]] = res
    return out


def train_steps(mesh, case):
    """`case["batches"]` steps of the port's train step under the mesh,
    from JAX's initial parameters: each step's loss and gradient norm
    (AdamW would hide a gradient scaled by a constant), and the adapter
    leaves after the last one, by port path. With "resume_dir" the
    state first restores the latest checkpoint there; with "save_dir",
    rank 0 writes one after "save_after" steps (`CheckpointManager`)."""
    cfg = case["cfg"]
    strat = peft.strategy(case.get("peft", "hadamard"))
    params = convert.from_jax_params(case["params"], cfg, "cpu")
    with use_mesh(mesh):
        state = make_mesh_state(None, cfg, strat, case["ocfg"], mesh,
                                params=params)
        if case.get("resume_dir"):
            restored, _ = CheckpointManager(case["resume_dir"]).restore()
            restore_state(state, restored)
        step = build_train_step(local_cfg(cfg, mesh), case["ocfg"])
        losses, norms = [], []
        for i, b in enumerate(case["batches"]):
            state, m = step(state, to_device(shard_batch(b, mesh), "cpu"))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            if (case.get("save_dir") and mesh.rank == 0
                    and i + 1 == case["save_after"]):
                CheckpointManager(case["save_dir"]).save(state["step"],
                                                         state_tree(state))
    return {"losses": losses, "grad_norms": norms,
            "adapters": {p: t.detach().numpy().copy()
                         for p, t in state["trainable"].items()}}


def local_grads(mesh, case):
    """Each rank's adapter gradients on its shard of one batch, before
    any all-reduce (`loss_and_grads` under the mesh)."""
    cfg = case["cfg"]
    params = convert.from_jax_params(case["params"], cfg, "cpu")
    with use_mesh(mesh):
        state = make_mesh_state(None, cfg, peft.strategy("hadamard"),
                                case["ocfg"], mesh, params=params)
        batch = to_device(shard_batch(case["batch"], mesh), "cpu")
        loss, _, grads = loss_and_grads(local_cfg(cfg, mesh), state, batch)
    return {"loss": float(loss.detach()),
            "grads": {p: g.numpy().copy() for p, g in grads.items()}}




def fail_on_rank(mesh, which):
    """Raises on rank `which`; the others return their rank."""
    if mesh.rank == which:
        raise ValueError(f"planted failure on rank {which}")
    return mesh.rank


def exit_on_rank(mesh, which):
    """Rank `which` dies without raising (a crash); the others return."""
    if mesh.rank == which:
        import os

        os._exit(3)
    return mesh.rank


def launcher_batches(mesh, args, corpus):
    """The train launcher's batches on this rank (`train_batches`, made in
    its prefetch thread): the mesh's device and each leaf's device and
    values."""
    from repro_torch.launch.train import train_batches

    return str(mesh.device), [
        {k: (str(v.device), v.numpy()) for k, v in b.items()}
        for b in train_batches(corpus, args, mesh)]
