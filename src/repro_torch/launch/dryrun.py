"""Dry run: per-device memory and FLOPs of every (architecture x input
shape x mesh) cell, with nothing allocated (port of `repro.launch.dryrun`).

JAX lowers and compiles each cell for its production mesh and reads XLA's
memory and cost analyses. The port has no compiler to ask, so it counts:

  * memory, per device, from the rule table (`dist.sharding`): the
    parameters, the train state's trainable leaves and AdamW moments, a
    decode step's caches and the inputs, each leaf's bytes over its spec's
    shard count; beside the H100's 80 GB (`DEVICE_BYTES`). XLA's
    `temp_bytes` (activations, workspace) has no meta-device counterpart
    and is written null with the reason;
  * `costs.flops`: `torch.utils.flop_counter.FlopCounterMode` over the
    step run on meta tensors (`launch.specs`) inside
    `common.costmode.cost_mode_ctx` (every kernel takes its plain version,
    every collective counts its bytes), at each group's repeats 1 and 2,
    extrapolated linearly over depth as JAX does. Under a mesh this is the
    program one rank runs (`local_cfg`, its shards, its dp share of the
    batch); where this slice refuses that mesh (`sharding.check_mesh`) it
    is null with the refusal, and `costs.global_flops`, the step on one
    device, stands beside it. The port's layers are a Python loop, so no
    scan hides a trip count and rwkv6 needs no fit in T;
  * `costs.coll`: the collective bytes one rank contributes
    (`dist.api.collective_counts`), by kind in `coll_detail`;
  * `costs.bytes` (XLA's "bytes accessed") has no counterpart: null, with
    the reason;
  * `analytic_model_flops`: JAX's yardstick, number for number.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape decode_32k --mesh 1x1
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun_torch.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import time
import traceback
from typing import Dict, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.common import tree as tu
from repro_torch.common.costmode import cost_mode_ctx
from repro_torch.common.types import SHAPES, ModelCfg, OptimCfg, ShapeSpec
from repro_torch.configs import ASSIGNED, get as get_cfg
from repro_torch.convert import _groups, _layer_position
from repro_torch.core import peft
from repro_torch.dist.api import (Mesh, collective_counts, reset_collectives,
                                  use_mesh)
from repro_torch.dist.sharding import (_shards, batch_spec, cache_spec,
                                       check_mesh, leaf_specs, local_cfg,
                                       per_device_param_bytes, shard_leaf,
                                       shard_params)
from repro_torch.launch.mesh import make_production_mesh, parse_mesh
from repro_torch.launch.specs import (build_step_fn, input_specs,
                                      params_shapes, state_shapes)
from repro_torch.quant.qtensor import is_qtensor

DEVICE_BYTES = 80e9  # one H100's memory
NO_TEMP = ("activations and workspace: XLA's temp_bytes has no meta-device "
           "counterpart in eager PyTorch")
NO_BYTES = ("XLA's 'bytes accessed' has no meta-device counterpart; the "
            "port counts FLOPs alone")


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS (the "useful compute" yardstick), JAX's line for line
# ---------------------------------------------------------------------------


def _matmul_param_count(cfg: ModelCfg) -> Dict[str, float]:
    """Active and total matmul-participating params (embeddings excluded,
    lm_head included; MoE routed experts scaled by top_k/E for 'active')."""
    total = active = 0.0
    for path, leaf in tu.flatten_with_paths(params_shapes(cfg)):
        if leaf is None or leaf.dim() == 0:
            continue
        n = float(leaf.numel())
        if re.search(r"(embed|pos_embed|type_embed)/table", path):
            continue
        total += n
        if re.search(r"moe/w[igo]$", path):
            active += n * (cfg.moe.top_k / cfg.moe.n_experts)
        else:
            active += n
    if cfg.tie_embeddings:  # tied unembedding still does the matmul
        v = cfg.vocab_size * cfg.d_model
        total += v
        active += v
    return {"total": total, "active": active}


def _attn_layers(cfg: ModelCfg):
    out = []
    for g in tuple(cfg.groups) + tuple(cfg.enc_groups):
        for s in g.slots:
            if s.kind == "attn":
                out.extend([s] * g.repeats)
    return out


def analytic_model_flops(cfg: ModelCfg, spec: ShapeSpec) -> Dict[str, float]:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) + attention dots.
    For PEFT training frozen matmuls skip their dW: ~4*N*D + 6*N_adapter*D."""
    counts = _matmul_param_count(cfg)
    B, S = spec.global_batch, spec.seq_len
    if spec.kind == "train":
        D = B * S
        train_mult = 6.0
    elif spec.kind == "prefill":
        D = B * S
        train_mult = 2.0
    else:  # decode: one token per sequence
        D = B * 1
        train_mult = 2.0

    attn = 0.0
    for s in _attn_layers(cfg):
        kv_span = S if s.window is None else min(s.window, S)
        if spec.kind == "decode":
            attn += 4.0 * B * 1 * kv_span * cfg.n_heads * cfg.head_dim
        else:
            span = kv_span / 2 if s.window is None else kv_span
            attn += 4.0 * B * S * span * cfg.n_heads * cfg.head_dim
    attn_mult = 3.0 if spec.kind == "train" else 1.0

    n_act = counts["active"]
    flops = train_mult * n_act * D + attn_mult * attn
    flops_peft = (
        (4.0 * n_act * D + attn_mult * attn) if spec.kind == "train" else flops
    )
    return {
        "model_flops": flops,
        "model_flops_peft": flops_peft,
        "n_active_params": n_act,
        "n_total_params": counts["total"],
    }


# ---------------------------------------------------------------------------
# per-device memory from the rule table
# ---------------------------------------------------------------------------


def cache_leaves(caches, cfg: ModelCfg):
    """(JAX path, JAX shape, port leaf) of each decode-cache leaf, JAX's
    stacked name: 'g<G>/slot<S>/<attn|cross|rwkv|rec>/<key>' with the
    group's repeats in front."""
    pos = _layer_position(cfg)
    groups = _groups(cfg, False)
    slots = cfg.layer_slots()
    for i, layer in enumerate(caches):
        gi, _, si = pos[i]
        for key, leaf in layer.items():
            kind = ("attn" if key in ("k", "v") else
                    "cross" if key in ("ck", "cv") else slots[i].kind)
            yield (f"g{gi}/slot{si}/{kind}/{key}",
                   (groups[gi].repeats,) + tuple(leaf.shape), leaf)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def memory_per_device(cfg: ModelCfg, spec: ShapeSpec, mesh, strat,
                      ocfg: OptimCfg) -> Dict:
    params = params_shapes(cfg)
    mem = {"param_bytes": per_device_param_bytes(params, cfg, mesh),
           "opt_bytes": 0, "cache_bytes": 0, "input_bytes": 0}
    if spec.kind == "train":
        # a moment shards as the leaf it tracks (JAX's
        # opt_state_shardings: the same rules over the same paths)
        opt = state_shapes(cfg, strat, ocfg, params=params)["opt"]
        for key in ("m", "v", "m_err", "v_err"):
            for path, t in opt.get(key, {}).items():
                parts = ({"values": t.values, "scales": t.scales}
                         if is_qtensor(t) else {"": t})
                specs = leaf_specs(path, t, cfg, mesh)
                mem["opt_bytes"] += sum(
                    _nbytes(part) // _shards(specs[name][2], mesh)
                    for name, part in parts.items())
    inputs = input_specs(cfg, spec)
    if spec.kind == "decode":
        for jp, shape, leaf in cache_leaves(inputs.pop("caches"), cfg):
            mem["cache_bytes"] += _nbytes(leaf) // _shards(
                cache_spec(jp, shape, cfg, mesh), mesh)
    for v in inputs.values():
        mem["input_bytes"] += _nbytes(v) // _shards(
            batch_spec(mesh, v.dim(), tuple(v.shape)), mesh)
    mem["argument_bytes"] = sum(mem[k] for k in (
        "param_bytes", "opt_bytes", "cache_bytes", "input_bytes"))
    mem["temp_bytes"] = None
    mem["temp_bytes_reason"] = NO_TEMP
    mem["device_bytes"] = DEVICE_BYTES
    mem["fits"] = mem["argument_bytes"] <= DEVICE_BYTES
    return mem


# ---------------------------------------------------------------------------
# FLOPs over meta proxies
# ---------------------------------------------------------------------------


def _replace_repeats(cfg: ModelCfg, dec_repeats, enc_repeats) -> ModelCfg:
    groups = tuple(dataclasses.replace(g, repeats=r)
                   for g, r in zip(cfg.groups, dec_repeats))
    enc = tuple(dataclasses.replace(g, repeats=r)
                for g, r in zip(cfg.enc_groups, enc_repeats))
    return cfg.replace(groups=groups, enc_groups=enc)


def _local_inputs(inputs: dict, mesh: Optional[Mesh]) -> dict:
    if mesh is None:
        return inputs
    out = {}
    for k, v in inputs.items():
        if k == "caches":
            out[k] = [{n: shard_leaf(t, batch_spec(mesh, t.dim(),
                                                   tuple(t.shape)), mesh)
                       for n, t in layer.items()} for layer in v]
        else:
            out[k] = shard_leaf(v, batch_spec(mesh, v.dim(), tuple(v.shape)),
                                mesh)
    return out


def count_step(cfg: ModelCfg, spec: ShapeSpec, mesh: Optional[Mesh],
               strat, ocfg: OptimCfg) -> Dict:
    """FLOPs and collective bytes of one step as one rank runs it under
    `mesh` (None: one device), on meta tensors."""
    lcfg = local_cfg(cfg, mesh)
    fn, kind = build_step_fn(lcfg, spec, ocfg)
    params = params_shapes(cfg)
    if mesh is not None:
        params = shard_params(params, cfg, mesh)
    # the caches and inputs at the rank's heads, then its dp share
    inputs = _local_inputs(input_specs(lcfg, spec), mesh)
    reset_collectives()
    with use_mesh(mesh), cost_mode_ctx(), \
            FlopCounterMode(display=False) as counter:
        if kind == "train":
            fn(state_shapes(lcfg, strat, ocfg, params=params), inputs)
        elif kind == "prefill":
            fn(params, inputs)
        else:
            fn(params, inputs["caches"], inputs["token"], inputs["pos"])
    colls = collective_counts()
    reset_collectives()
    detail = {k: v["bytes"] for k, v in colls.items()}
    detail["count"] = sum(v["count"] for v in colls.values())
    return {"flops": float(counter.get_total_flops()),
            "coll": float(sum(v["bytes"] for v in colls.values())),
            "coll_detail": detail}


def _combine(base, diffs_scaled):
    out = dict(base)
    for d, scale in diffs_scaled:
        for k in ("flops", "coll"):
            out[k] = out[k] + max(0.0, d[k] - base[k]) * scale
    return out


def proxy_costs(cfg: ModelCfg, spec: ShapeSpec, mesh: Optional[Mesh],
                strat, ocfg: OptimCfg = OptimCfg()) -> Dict:
    """Per-rank costs from proxies at each group's repeats 1 and 2,
    extrapolated linearly over depth (JAX's per-group linear method)."""
    dec_R = [g.repeats for g in cfg.groups]
    enc_R = [g.repeats for g in cfg.enc_groups]
    ones_dec = [min(1, r) for r in dec_R]
    ones_enc = [min(1, r) for r in enc_R]
    base = count_step(_replace_repeats(cfg, ones_dec, ones_enc), spec, mesh,
                      strat, ocfg)
    diffs = []
    for i, r in enumerate(dec_R):
        if r > 1:
            bump = list(ones_dec)
            bump[i] = 2
            diffs.append((count_step(_replace_repeats(cfg, bump, ones_enc),
                                     spec, mesh, strat, ocfg), r - 1))
    for i, r in enumerate(enc_R):
        if r > 1:
            bump = list(ones_enc)
            bump[i] = 2
            diffs.append((count_step(_replace_repeats(cfg, ones_dec, bump),
                                     spec, mesh, strat, ocfg), r - 1))
    out = _combine(base, diffs)
    out["coll_detail"] = base["coll_detail"]
    out["method"] = "per-group linear"
    return out


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def skip_reason(cfg: ModelCfg, spec: ShapeSpec) -> Optional[str]:
    if spec.name == "long_500k" and not cfg.sub_quadratic:
        return ("full-range attention layers present -> not sub-quadratic; "
                "long_500k skipped per task spec (see DESIGN.md §5)")
    return None


def mesh_of(kind: str) -> Mesh:
    """'single' (16, 16), 'multi' (2, 16, 16) or 'DxM' as a rank layout."""
    if kind in ("single", "multi"):
        return make_production_mesh(multi_pod=(kind == "multi"))
    return Mesh(parse_mesh(kind))


def run_cell(arch: str, shape: str, mesh_kind: str, peft_name: str = "hadamard",
             with_costs: bool = True) -> Dict:
    cfg = peft.attach(get_cfg(arch), peft.strategy(peft_name))
    spec = SHAPES[shape]
    strat, ocfg = peft.strategy(peft_name), OptimCfg()
    # JAX's record keys; the port takes no config overrides
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind, "peft": peft_name,
           "overrides": {}}
    reason = skip_reason(cfg, spec)
    if reason:
        rec.update(status="skipped", reason=reason)
        return rec
    mesh = mesh_of(mesh_kind)
    t0 = time.time()
    try:
        rec["memory"] = memory_per_device(cfg, spec, mesh, strat, ocfg)
        rec["n_devices"] = mesh.size
        rec["step_kind"] = spec.kind
        if with_costs:
            t1 = time.time()
            try:
                check_mesh(cfg, mesh)
                costs = proxy_costs(cfg, spec, mesh, strat, ocfg)
            except NotImplementedError as e:
                costs = {"flops": None, "coll": None, "reason": str(e)}
            costs["global_flops"] = (
                costs["flops"] if mesh.size == 1 else
                proxy_costs(cfg, spec, None, strat, ocfg)["flops"])
            costs["bytes"] = None
            costs["bytes_reason"] = NO_BYTES
            rec["costs"] = costs
            rec["proxy_count_s"] = round(time.time() - t1, 1)
        rec.update(analytic_model_flops(cfg, spec))
        rec["count_s"] = round(time.time() - t0, 1)
        rec["status"] = "ok"
    except Exception as e:  # a failure here is a bug in the port
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def all_cells(mesh_kinds, peft_name):
    for arch in sorted(ASSIGNED):
        for shape in SHAPES:
            for mk in mesh_kinds:
                yield arch, shape, mk, peft_name


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="single",
                    help="single (16x16), multi (2x16x16), both, or DxM")
    ap.add_argument("--peft", default="hadamard")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-costs", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    args = ap.parse_args(argv)

    mesh_kinds = (["single", "multi"] if args.mesh == "both"
                  else [args.mesh])
    for mk in mesh_kinds:
        mesh_of(mk)  # a bad --mesh fails before any cell
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    records = {}
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            records = {tuple(r["key"]): r for r in json.load(f)}
    if args.all:
        cells = list(all_cells(mesh_kinds, args.peft))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape, mk, args.peft) for mk in mesh_kinds]

    for arch, shape, mk, pf in cells:
        key = (arch, shape, mk, pf)
        if key in records and records[key].get("status") == "ok":
            print(f"[skip-cached] {key}")
            continue
        print(f"[dryrun] {arch} x {shape} x {mk} ({pf}) ...", flush=True)
        rec = run_cell(arch, shape, mk, pf, with_costs=not args.no_costs)
        rec["key"] = list(key)
        records[key] = rec
        extra = rec.get("reason") or rec.get("error") or (
            f"mem={rec['memory']['argument_bytes'] / 2**30:.2f}GiB a device "
            f"(params {rec['memory']['param_bytes'] / 2**30:.2f}GiB)"
            + (f" flops={rec['costs']['flops']}" if "costs" in rec else ""))
        print(f"  -> {rec['status']}: {extra}", flush=True)
        with open(args.out, "w") as f:
            json.dump(list(records.values()), f, indent=1)
    print(f"wrote {args.out} ({len(records)} records)")
    return records


if __name__ == "__main__":
    main()
