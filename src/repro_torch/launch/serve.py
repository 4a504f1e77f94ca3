"""Serving launcher of the port: continuous-batching generation on a
config, single-tenant or over a multi-task Hadamard adapter bank.

The weights are random, made from --seed on the device, with the
adapters moved off the identity as a fine-tune would move them (one
variant per task with --tasks N, else one). Requests come with prompts of
--prompt-len tokens and budgets of --new-tokens; with --tasks N their task
ids go round-robin. With --quant int8|fp8 the engine quantizes the frozen
backbone's matmul weights at construction and the launcher prints their
byte accounting, as the JAX launcher does. The scheduler admits the
requests into --num-slots cache slots mid-decode and prints a
throughput/latency report.

Multi-tenant hot-swap, as the JAX launcher runs it: with --adapter-dir the
task deltas live in an on-disk AdapterRegistry and requests name their
adapter; only --bank-size rows are on the device at once (LRU eviction,
pinned while in flight). Every tenant but the last is published up front;
the last is published mid-stream, once half of the others' requests have
completed, and served without rebuilding the engine; `task0` is removed at
the end. --prune-to K prunes every tenant to its top K layers and
publishes packed deltas (the paper's 0.022 % variant is K = 2L/3: 18 of
qwen3-0.6b's 28); --share-w serves the paper's Fig-5 world, one w shared by
every tenant and a b per tenant, from a bank that stores the w once.

  python -m repro_torch.launch.serve --arch qwen3-0.6b --requests 8 \
      --num-slots 4 --prompt-len 128 --new-tokens 32 [--tasks 3] \
      [--quant int8]
  python -m repro_torch.launch.serve --arch qwen3-0.6b --requests 8 \
      --num-slots 4 --prompt-len 128 --new-tokens 32 --tasks 4 \
      --adapter-dir DIR --bank-size 3 [--prune-to 18] [--share-w]

With --mesh DxM the backbone is served tensor-parallel over M ranks by
JAX's sharding rules (`dist.sharding`; every one of the D data ranks is a
replica that computes every slot, as JAX's replicated slot dim implies),
rank 0 printing. Under `torchrun --nproc-per-node N` each process is a
rank (a card each, NCCL); without torchrun the launcher spawns the ranks
itself (--backend gloo for ranks that share one card):

  torchrun --nproc-per-node 2 -m repro_torch.launch.serve --arch qwen3-0.6b --mesh 1x2
  python -m repro_torch.launch.serve --arch qwen3-0.6b --mesh 1x2 --backend gloo
  python -m repro_torch.launch.serve --arch rwkv6-1.6b --requests 8 \
      --num-slots 4 --prompt-len 128 --new-tokens 32 [--tasks 3] \
      [--quant int8]
  python -m repro_torch.launch.serve --arch rwkv6-1.6b --requests 8 \
      --num-slots 4 --prompt-len 128 --new-tokens 32 --tasks 4 \
      --adapter-dir DIR --bank-size 3 [--prune-to 16]
  python -m repro_torch.launch.serve --arch qwen3-0.6b --requests 8 \
      --num-slots 4 --prompt-len 128 --new-tokens 32 --page-size 16 \
      [--kv-quant int8|fp8] [--no-prefix-cache] [--spec-k 4 \
      [--spec-draft model]]
  python -m repro_torch.launch.serve --arch qwen3-0.6b --smoke --device cpu
  python -m repro_torch.launch.serve --arch gemma2-27b --requests 4 \
      --num-slots 2 --prompt-len 128 --new-tokens 32 [--page-size 16]
  python -m repro_torch.launch.serve --arch deepseek-moe-16b \
      --requests 8 --num-slots 4 --prompt-len 128 --new-tokens 32 \
      [--tasks 3] [--quant int8]

gemma2-27b (46 layers alternating a 4096-token window with full range,
soft-capped, post-norms) serves at full width on one 80 GB card: its
27.2 B parameters take 54.5 GB in bf16. Its windowed layers keep ring
caches; the paged pool serves it cold (no prefix cache), and speculation
and prompt bucketing are refused for it, as in JAX.

deepseek-moe-16b (28 layers: a dense one, then 64 routed experts top-6
and 2 shared experts a layer) serves at full width on one card, 32.8 GB
in bf16. Its rows route together: an idle slot's row takes expert
capacity too, and bucketing, prefix hits and speculation follow JAX's
behaviour, not plain decoding's. --quant quantizes the attention
projections, the dense layer's MLP and the head; the experts stay bf16,
as in JAX.

--fold folds the single adapter into W_O at construction (the adapter op
then runs on the identity); --static serves the requests as JAX's
lock-step `generate` batch instead of through the scheduler; --stream
prints every token the moment it is sampled.

Paged KV (--page-size P): a block pool of P-token pages with copy-on-write
prefix sharing (--no-prefix-cache turns sharing off), --kv-blocks blocks
(default: 1.5x what every slot can reserve), and with --kv-quant int8|fp8
quantized KV blocks. Speculative decoding (--spec-k K): K greedy drafts a
tick from the identity-adapter backbone (--spec-draft self) or from the
untuned base model (--spec-draft model), verified in one forward; over
the slot caches or, with --page-size, over the pool.

An RWKV6 architecture serves in every mode: its time and channel mixes
match no projection of the quantization table, so --quant quantizes its
untied LM head alone, as the JAX launcher does; its adapter is d_model wide
and hot-swaps like an attention block's.

Observability and SLOs, JAX's two flag groups: one MetricsRegistry takes
every series of the serve; --metrics-every N prints a digest every N
ticks, --metrics-file writes its final snapshot (JSON, or Prometheus text
for a .prom path), --events-file appends its events as JSONL, and
--profile-dir writes a Chrome trace of the first --profile-ticks ticks
(`trace.json`: the host's ops and the `repro.*` kernel ranges beside the
device's kernels). --slo-ttft-ms/--slo-tpot-ms/--slo-queue-depth/
--slo-kv-free/--slo-accept declare objectives, evaluated as multi-window
burn rates; with --admission the degradation ladder acts on them (prefix
fill stop, spec_k halving, defer, shed):

  python -m repro_torch.launch.serve --arch qwen3-0.6b --page-size 16 \
      --spec-k 4 --slo-queue-depth 2 --admission --metrics-every 16 \
      --metrics-file m.json --events-file e.jsonl --profile-dir prof \
      --profile-ticks 2
"""
from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys
import tempfile
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch import convert
from repro_torch.common.device import resolve_device
from repro_torch.common.types import ModelCfg
from repro_torch.configs import get, get_smoke
from repro_torch.core import peft
from repro_torch.core.hadamard import (extract_delta, fold_adapter,
                                      perturb_adapters)
from repro_torch.dist.api import use_mesh
from repro_torch.launch.mesh import parse_mesh, run_world
from repro_torch.models import model as M
from repro_torch.obs import (JsonlSink, MetricsRegistry, ProfiledTicks,
                             SLOSpec, accept_floor, kv_free_floor,
                             queue_depth_max, tpot_target, ttft_target,
                             write_snapshot)
from repro_torch.quant import quant_summary, quantize_owned
from repro_torch.serving import (AdapterBank, AdapterRegistry,
                                 AdmissionConfig, AdmissionShedError,
                                 MultiTaskEngine, Request, ServeEngine,
                                 ServingConfig, format_report, make_scheduler)
from repro_torch.serving.engine import round_to_page
from repro_torch.sparse import (apply_layer_mask, depth_mask, factorize,
                                n_layers, prune_delta, shared_w_overlay)


def build_config(arch: str, smoke: bool = False) -> ModelCfg:
    cfg = get_smoke(arch) if smoke else get(arch)
    return peft.attach(cfg, peft.strategy("hadamard"))


def build_base(cfg: ModelCfg, seed: int, device) -> dict:
    """The backbone from `seed` on `device`, its adapters the identity."""
    return M.init_params(torch.Generator(device=device).manual_seed(seed),
                         cfg)


def task_variants(base: dict, seed: int, tasks: int,
                  share_w: bool = False) -> List[dict]:
    """max(tasks, 1) variants of `base` whose adapters are perturbed per
    task (distinct adapters, as if fine-tuned per task). share_w builds the
    paper's Fig-5 world: ONE w perturbation common to every task, then a
    b per task, the regime a shared-w bank serves exactly."""
    if share_w:
        stem = perturb_adapters(base, seed * 1000 + 7, leaves=("w",))
        return [perturb_adapters(stem, seed * 1000 + 100 + t, leaves=("b",))
                for t in range(max(tasks, 1))]
    return [perturb_adapters(base, seed * 1000 + 100 + t)
            for t in range(max(tasks, 1))]


def build_params(cfg: ModelCfg, seed: int, tasks: int, device) -> List[dict]:
    """`task_variants` of the backbone from `seed`."""
    return task_variants(build_base(cfg, seed, device), seed, tasks)


def own_trunk(cfg: ModelCfg, trees: List[dict], quant: Optional[str],
              fold: bool = False) -> List[dict]:
    """The build's own trees, ready for an engine: with `quant`, the single
    adapter folded into W_O first where `fold` asks (as the engine would
    fold it) and the backbone quantized in place, leaf by leaf
    (`quantize_owned`), over `trees` that share their backbone leaves and
    that nothing else references. Returns the trees to hand the engine
    (with fold=False where they are folded)."""
    if not quant:
        return trees
    if fold and cfg.adapter.kind == "hadamard":
        trees = [fold_adapter(trees.pop(0), cfg)]
    quantize_owned(trees, quant)
    return trees


def build_engine(cfg: ModelCfg, seed: int = 0, tasks: int = 0, device=None,
                 quant: Optional[str] = None, fold: bool = False):
    """ServeEngine over one perturbed adapter, or a MultiTaskEngine over
    `tasks` of them; `quant` quantizes the backbone and `fold` folds the
    single adapter into W_O (see ServeEngine).

    The build owns the trees it makes, so with `quant` it quantizes them
    in place, one leaf at a time (`own_trunk`): at its peak the device
    holds the dense tree and one projection's fp32 temporaries (gemma2-27b
    int8: 54.5 GB of bf16, a 57.1 GB peak on an H100), never the dense
    tree beside the quantized one (~83 GB there), and it ends holding the
    quantized tree alone (28.4 GB)."""
    device = resolve_device(device)
    variants = build_params(cfg, seed, tasks, device)
    if quant:
        variants = own_trunk(cfg, variants, quant, fold and tasks <= 0)
        fold = False
    if tasks > 0:
        return MultiTaskEngine(cfg, variants, quant=quant, device=device)
    return ServeEngine(cfg, variants[0], fold=fold, quant=quant,
                       device=device)


def quant_line(engine) -> str:
    """The JAX launcher's byte-accounting line of a quantized engine, with
    leaves counted in the JAX layout (a group's layers share one leaf)."""
    qs = quant_summary(engine.params,
                       lambda p: convert.jax_path(p, engine.cfg))
    return (f"{engine.quant} backbone: {qs['n_quantized_leaves']} matmul "
            f"leaves, {qs['dense_bytes_fp32'] / 2**20:.2f} MiB fp32 -> "
            f"{qs['quantized_bytes'] / 2**20:.2f} MiB ({qs['ratio']:.2f}x); "
            f"tree total {qs['total_bytes'] / 2**20:.2f} MiB")


def make_requests(cfg: ModelCfg, n: int, prompt_len: int, new_tokens: int,
                  tasks: int = 0, seed: int = 0, top_k: int = 0,
                  temperature: float = 1.0,
                  named: bool = False) -> List[Request]:
    """n requests, tasks round-robin: by bank row, or with named=True by
    adapter name ('task<i>', resolved by a hot-swap engine)."""
    rs = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        task = i % tasks if tasks > 0 else 0
        reqs.append(Request(
            prompt=rs.randint(10, cfg.vocab_size, size=(prompt_len,)),
            max_new_tokens=new_tokens, top_k=top_k, temperature=temperature,
            seed=seed + i, **({"adapter": f"task{task}"} if named
                              else {"task_id": task})))
    return reqs


def task_delta(params: dict, cfg: ModelCfg, layer_mask=None) -> dict:
    """One tenant's registry payload: its delta in the JAX layout, packed
    under `layer_mask` when given."""
    delta = convert.stack_delta(extract_delta(params), cfg)
    return delta if layer_mask is None else prune_delta(delta, cfg,
                                                        layer_mask)


def hot_swap_engine(cfg: ModelCfg, base: dict, variants: List[dict],
                    registry: AdapterRegistry, bank_size: int, *,
                    share_w: bool = False, layer_mask=None, device=None,
                    quant: Optional[str] = None) -> MultiTaskEngine:
    """A MultiTaskEngine over an AdapterBank of `bank_size` rows that
    loads its tenants from `registry`. share_w: the bank stores the w that
    `factorize` finds across `variants` once, and each tenant's b."""
    bank_base = base
    if share_w:
        sa = factorize({f"task{t}": extract_delta(v)
                        for t, v in enumerate(variants)}, cfg,
                       mask=layer_mask)
        bank_base = shared_w_overlay(base, sa, cfg)
    bank = AdapterBank(cfg, bank_base, bank_size, registry, shared_w=share_w)
    return MultiTaskEngine(cfg, bank, quant=quant, device=device)


def serve_with_runtime_add(sched, requests: List[Request], hot: str,
                           publish_hot: Callable[[], None], log=print,
                           on_tick: Optional[Callable[[], None]] = None):
    """The JAX launcher's tenant lifecycle: serve every request but those
    of `hot`; once half of them have completed, `publish_hot()` and submit
    the rest mid-stream (a request the admission ladder sheds is logged
    and dropped). `on_tick()` runs after every tick. Returns (completions
    in submit order, report)."""
    early = [r for r in requests if r.adapter != hot]
    late = [r for r in requests if r.adapter == hot]

    def tick() -> List[int]:
        nonlocal late
        if on_tick is not None:
            on_tick()
        if not late or len(sched.completions) * 2 < len(early):
            return []
        publish_hot()
        log(f"  ++ runtime add: published {hot!r}, submitting "
            f"{len(late)} request(s) for it mid-stream")
        ids = []
        for r in late:
            try:
                ids.append(sched.submit(r))
            except AdmissionShedError as e:
                log(f"  !! shed: {e}")
        late = []
        return ids

    return sched.run(early, on_tick=tick)


def remove_tenant(registry: AdapterRegistry, engine: MultiTaskEngine,
                  name: str, log=print) -> None:
    """Runtime remove: unpublish `name` and free its bank row."""
    registry.remove(name)
    engine.adapter_bank.invalidate(name)
    log(f"  -- runtime remove: {name!r} unpublished + row freed")


def bank_lines(engine: MultiTaskEngine) -> List[str]:
    """The JAX launcher's bank report lines."""
    st = engine.adapter_bank.stats()
    return [f"adapter bank: {st['resident']}/{st['size']} rows resident, "
            f"{st['loads']} loads, {st['evictions']} evictions",
            f"bank adapter bytes: {st['adapter_bytes'] / 1024:.1f} KiB"
            + (" (shared-w: one w row-set for all tenants)"
               if st["shared_w"] else "")]


def feature_lines(args, sched) -> List[str]:
    """The JAX launcher's lines naming the paged pool and the speculation
    a run serves with."""
    lines = []
    if args.page_size > 0:
        lines.append(f"paged KV: {sched.alloc.num_blocks - 1} x "
                     f"{args.page_size}-token blocks"
                     + (f", {args.kv_quant} blocks" if args.kv_quant else "")
                     + ("" if args.prefix_cache else ", prefix cache off"))
    if args.spec_k:
        lines.append(f"speculative decoding: k={args.spec_k}, "
                     f"draft={args.spec_draft}")
    return lines


def outcome_lines(sched) -> List[str]:
    """The JAX launcher's acceptance and prefix-hit lines of a run."""
    lines = []
    if hasattr(sched, "spec_stats"):
        st = sched.spec_stats
        lines.append(f"speculation: {st['accepted']}/{st['drafted']} drafts "
                     f"accepted ({sched.acceptance_rate:.0%}) over "
                     f"{st['spec_ticks']} verify ticks")
    if hasattr(sched, "pool_report"):
        pr = sched.pool_report()
        lines.append(f"pool: {pr['live_blocks']}/{pr['num_blocks']} blocks "
                     f"live, {pr['prefix_full_entries']} cached prompts; "
                     f"{pr['full_hits']} full / {pr['partial_hits']} partial "
                     f"prefix hits, {pr['cold']} cold prefills")
    return lines


def stream_print(rid: int, tok: int) -> None:
    """The JAX launcher's --stream line of one token."""
    print(f"  req{rid} += {tok}", flush=True)


def slo_objectives(args, paged: bool) -> list:
    """The objectives the --slo-* flags declare, with JAX's refusals."""
    objectives = []
    if args.slo_ttft_ms > 0:
        objectives.append(ttft_target(args.slo_ttft_ms,
                                      target=args.slo_target))
    if args.slo_tpot_ms > 0:
        objectives.append(tpot_target(args.slo_tpot_ms,
                                      target=args.slo_target))
    if args.slo_queue_depth > 0:
        objectives.append(queue_depth_max(args.slo_queue_depth,
                                          target=args.slo_target))
    if args.slo_kv_free > 0:
        if not paged:
            raise SystemExit("--slo-kv-free needs paged KV (--page-size)")
        objectives.append(kv_free_floor(args.slo_kv_free,
                                        target=args.slo_target))
    if args.slo_accept > 0:
        if not args.spec_k:
            raise SystemExit("--slo-accept needs speculation (--spec-k)")
        objectives.append(accept_floor(args.slo_accept))
    if args.admission and not objectives:
        raise SystemExit("--admission needs at least one --slo-* objective")
    return objectives


def slo_line(obs: MetricsRegistry, report: dict, admission: bool) -> str:
    """The JAX launcher's closing SLO line."""
    breaches = obs.events_of("slo_breach")
    return (f"SLO: {len(breaches)} breach event(s)"
            + (f" ({', '.join(sorted({e['objective'] for e in breaches}))})"
               if breaches else "")
            + (f"; ladder level {report['degrade_level']}, "
               f"{report['shed']} shed, {report['deferred_ticks']} "
               "deferred tick(s)" if admission else ""))


def serve_static(engine, requests: List[Request], top_k: int, seed: int,
                 log=print) -> np.ndarray:
    """JAX's --static path: the requests' prompts as one lock-step
    `generate` batch (per-request task rows over a bank), greedy, or top-k
    from one generator seeded by `seed`. Logs the line JAX prints and the
    first 8 tokens of each row; returns the (n, new_tokens) tokens."""
    gen = (torch.Generator(device=engine.device).manual_seed(seed)
           if top_k else None)
    t0 = time.perf_counter()
    if isinstance(engine, MultiTaskEngine):
        out = np.stack(engine.generate(requests, generator=gen, top_k=top_k))
    else:
        out = engine.generate(np.stack([r.prompt for r in requests]),
                              requests[0].max_new_tokens, top_k=top_k,
                              generator=gen)
    dt = time.perf_counter() - t0
    log(f"static batch: generated {out.shape} in {dt:.2f}s "
        f"({out.size / dt:.1f} tok/s)")
    log(str(out[:, :8]))
    return out


def main(argv=None) -> MetricsRegistry:
    """Serve as the flags say; returns the serve's MetricsRegistry (None
    under --static, which runs no scheduler)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced smoke config")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--num-slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=0,
                    help="slot cache length (0: longest prompt + budget, "
                         "rounded up to a multiple of 16)")
    ap.add_argument("--tasks", type=int, default=0,
                    help=">0: multi-task adapter bank with this many tasks")
    ap.add_argument("--adapter-dir", default="",
                    help="hot-swap serving: publish and load the task deltas "
                         "through an AdapterRegistry at this path; requests "
                         "name their adapter, resolved at admission")
    ap.add_argument("--bank-size", type=int, default=4,
                    help="device-resident adapter rows for --adapter-dir "
                         "(misses load from disk, cold rows are evicted LRU)")
    ap.add_argument("--prune-to", type=int, default=0,
                    help="prune every tenant's adapter to its top K layers "
                         "and publish PACKED deltas (pruned layers serve as "
                         "the identity); 0 = dense; the paper's 0.022%% "
                         "preset is K = 2L/3")
    ap.add_argument("--share-w", action="store_true",
                    help="shared-w serving (paper Fig 5): the bank stores ONE "
                         "w row-set and each tenant's insert writes only its "
                         "b. Requires --adapter-dir")
    ap.add_argument("--top-k", type=int, default=0,
                    help=">0: per-request top-k sampling (greedy otherwise)")
    ap.add_argument("--temperature", type=float, default=1.0,
                    help="sampling temperature of top-k requests")
    ap.add_argument("--quant", default="", choices=["", "int8", "fp8"],
                    help="quantize the frozen backbone's matmul weights at "
                         "engine construction (adapter rows and norms keep "
                         "their dtype)")
    ap.add_argument("--page-size", type=int, default=0,
                    help=">0: paged KV serving - a block-table cache of "
                         "pages of this many tokens, copy-on-write prefix "
                         "sharing, admission gated on free blocks")
    ap.add_argument("--kv-blocks", type=int, default=0,
                    help="physical blocks in the paged pool (0 = 1.5x what "
                         "every slot can reserve, plus the null block)")
    ap.add_argument("--prefix-cache", dest="prefix_cache",
                    action="store_true", default=True,
                    help="share identical prompt prefixes across requests "
                         "(default on; paged mode only)")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false")
    ap.add_argument("--kv-quant", default="", choices=["", "int8", "fp8"],
                    help="store paged KV blocks quantized with per-token "
                         "scales (dequantized inside the attention kernel)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help=">0: speculative decoding - draft this many tokens "
                         "a tick and verify them in one target forward "
                         "(greedy output stays token-identical)")
    ap.add_argument("--spec-draft", default="self", choices=["self", "model"],
                    help="draft source: 'self' drafts with the identity-"
                         "adapter backbone; 'model' with a separate model "
                         "(here: the untuned base)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--static", action="store_true",
                    help="lock-step ServeEngine.generate batch instead of "
                         "the continuous-batching scheduler")
    ap.add_argument("--stream", action="store_true",
                    help="print every token the moment it is sampled")
    ap.add_argument("--fold", action="store_true",
                    help="fold the adapter into W_O (zero-overhead serving)")

    g = ap.add_argument_group("observability (repro_torch.obs)")
    g.add_argument("--metrics-every", type=int, default=0,
                   help=">0: print a one-line metrics digest every N "
                        "scheduler ticks")
    g.add_argument("--metrics-file", default="",
                   help="write the final MetricsRegistry snapshot here "
                        "(JSON; a .prom suffix writes Prometheus text "
                        "exposition instead)")
    g.add_argument("--events-file", default="",
                   help="append structured events (retraces, bank "
                        "evictions/pin stalls, degradation steps) as JSONL "
                        "here")
    g.add_argument("--profile-dir", default="",
                   help="capture a torch.profiler trace of the first "
                        "--profile-ticks scheduler ticks into this "
                        "directory (trace.json, Chrome trace format)")
    g.add_argument("--profile-ticks", type=int, default=8,
                   help="scheduler ticks the --profile-dir capture spans")

    g = ap.add_argument_group("SLOs / admission control")
    g.add_argument("--slo-ttft-ms", type=float, default=0,
                   help=">0: TTFT objective - --slo-target of requests "
                        "must see first token under this many ms")
    g.add_argument("--slo-tpot-ms", type=float, default=0,
                   help=">0: per-output-token latency objective")
    g.add_argument("--slo-queue-depth", type=int, default=0,
                   help=">0: queued requests must stay at or under this")
    g.add_argument("--slo-kv-free", type=int, default=0,
                   help=">0: paged KV pool must keep this many free blocks")
    g.add_argument("--slo-accept", type=float, default=0,
                   help=">0: speculative acceptance-rate floor (0..1)")
    g.add_argument("--slo-target", type=float, default=0.95,
                   help="good fraction the latency/gauge objectives must "
                        "hold (error budget = 1 - target)")
    g.add_argument("--admission", action="store_true",
                   help="act on SLO breaches with the degradation ladder: "
                        "stop prefix fill -> step spec_k down -> defer -> "
                        "shed (serving/admission.py); without this, "
                        "breaches only land as registry events")
    g.add_argument("--admission-check-every", type=int, default=4,
                   help="evaluate the SLO monitor every N scheduler ticks")
    g = ap.add_argument_group("distribution (repro_torch.dist)")
    g.add_argument("--mesh", default="",
                   help="'DATAxMODEL' (e.g. 1x2): serve the backbone "
                        "tensor-parallel over MODEL ranks (every data rank "
                        "a replica); under torchrun this process is one "
                        "rank, else the ranks are spawned here")
    g.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                   help="the ranks' backend: nccl with a card a rank "
                        "(default on the card), gloo on the CPU or for "
                        "ranks that share one card")
    args = ap.parse_args(argv)
    if args.mesh:
        try:
            shape = parse_mesh(args.mesh)
        except ValueError as e:
            raise SystemExit(str(e))
        device = resolve_device(args.device)
        run_world(shape, _serve_rank, args, device=device,
                  backend=args.backend)
        return None
    return _serve(args)


def _serve_rank(mesh, args):
    """One rank of a --mesh serve: the engine built under the mesh; rank
    0 prints, the others serve silently. A rank's hot-swap registry is
    its own directory under --adapter-dir (each publishes the same
    deltas at the same tick)."""
    if args.adapter_dir and mesh.size > 1:
        args.adapter_dir = os.path.join(args.adapter_dir,
                                        f"rank{mesh.rank}")
    out = sys.stdout if mesh.rank == 0 else io.StringIO()
    with use_mesh(mesh), contextlib.redirect_stdout(out):
        if mesh.rank == 0:
            print(f"mesh {'x'.join(map(str, mesh.shape))}: "
                  f"{mesh.size} rank(s) over {mesh.backend}, model degree "
                  f"{mesh.degree('model')}")
        _serve(args)
    return None


def _serve(args) -> Optional[MetricsRegistry]:
    quant = args.quant or None
    cfg = build_config(args.arch, args.smoke)
    if args.share_w and not args.adapter_dir:
        raise SystemExit("--share-w factorizes the hot-swap bank "
                         "(pass --adapter-dir)")
    if args.adapter_dir and args.tasks <= 0:
        raise SystemExit("--adapter-dir requires --tasks > 0")
    if args.adapter_dir and args.static:
        raise SystemExit("--adapter-dir serves through the scheduler "
                         "(drop --static)")
    device = resolve_device(args.device)
    base = build_base(cfg, args.seed, device)
    variants = task_variants(base, args.seed, args.tasks, args.share_w)
    layer_mask = None
    if args.prune_to:
        try:
            layer_mask = depth_mask(cfg, args.prune_to)
        except ValueError as e:
            raise SystemExit(f"--prune-to: {e}")
        # pruned at the source: packed publishing is an exact round trip
        variants = [apply_layer_mask(v, cfg, layer_mask) for v in variants]
        print(f"pruned serving: top {args.prune_to}/{n_layers(cfg)} "
              "layers active, packed deltas published")
    # --spec-draft model drafts with the untuned base, kept dense as in JAX
    draft_model = ((cfg, base) if args.spec_k and args.spec_draft == "model"
                   else None)
    if quant:
        # the launcher owns these trees: quantized in place, leaf by leaf,
        # so the dense trunk is never held beside the quantized one unless
        # the drafter reads it
        fold_one = args.fold and args.tasks <= 0
        if fold_one or draft_model is not None:
            variants = own_trunk(cfg, variants, quant, fold_one)
            if draft_model is None:
                base = None
        else:
            own_trunk(cfg, [base] + variants, quant)

    registry = None
    if args.adapter_dir:
        registry = AdapterRegistry(args.adapter_dir)
        for t, params in enumerate(variants[:-1] or variants):
            registry.publish(f"task{t}", task_delta(params, cfg, layer_mask))
        engine = hot_swap_engine(cfg, base, variants, registry,
                                 args.bank_size, share_w=args.share_w,
                                 layer_mask=layer_mask, device=device,
                                 quant=quant)
    elif args.tasks > 0:
        engine = MultiTaskEngine(cfg, variants, quant=quant, device=device)
    else:
        engine = ServeEngine(cfg, variants[0], fold=args.fold and not quant,
                             quant=quant, device=device)
    if quant:
        print(quant_line(engine))
    if args.static:
        serve_static(engine, make_requests(
            cfg, args.requests, args.prompt_len, args.new_tokens, args.tasks,
            args.seed, args.top_k, args.temperature), args.top_k, args.seed)
        return None
    paged = args.page_size > 0
    # a verify writes spec_k positions past the budget; a paged cache is
    # whole pages, as the slot cache is whole 16-token decode pages
    max_len = args.max_len or round_to_page(
        args.prompt_len + args.new_tokens + args.spec_k)
    if paged:
        max_len = -(-max_len // args.page_size) * args.page_size
    # one registry for the whole serve: every scheduler, bank and cache
    # series, the request tracer, and the exporters attached to it
    obs = MetricsRegistry()
    events_sink = None
    if args.events_file:
        events_sink = JsonlSink(args.events_file)
        obs.add_sink(events_sink)
    objectives = slo_objectives(args, paged)
    slo = SLOSpec(objectives=tuple(objectives)) if objectives else None
    admission = (AdmissionConfig(check_every=args.admission_check_every)
                 if args.admission else None)
    if slo is not None:
        print("SLOs: " + ", ".join(o.name for o in objectives)
              + (" (admission ladder armed)" if args.admission
                 else " (monitor only)"))
    try:
        scfg = ServingConfig(
            num_slots=args.num_slots, max_len=max_len, paged=paged,
            page_size=args.page_size if paged else 16,
            num_blocks=(args.kv_blocks or None) if paged else None,
            prefix_cache=args.prefix_cache, kv_quant=args.kv_quant or None,
            spec_k=args.spec_k, spec_draft=args.spec_draft,
            top_k=args.top_k, temperature=args.temperature,
            backbone_quant=quant, stream=stream_print if args.stream
            else None, slo=slo, admission=admission)
        sched = make_scheduler(
            engine, scfg,
            draft_model=draft_model, obs=obs)
    except ValueError as e:
        raise SystemExit(str(e))
    requests = make_requests(cfg, args.requests, args.prompt_len,
                             args.new_tokens, args.tasks, args.seed,
                             scfg.top_k, scfg.temperature,
                             named=registry is not None)
    prof = (ProfiledTicks(args.profile_dir, n=args.profile_ticks)
            if args.profile_dir else None)

    def after_tick():
        """The launcher's obs hooks after a scheduler tick."""
        if prof is not None:
            prof.tick()
        if (args.metrics_every and sched._ticks
                and sched._ticks % args.metrics_every == 0):
            snap = obs.snapshot()
            tok = sum(v for k, v in snap["counters"].items()
                      if k.startswith("serve_tokens_total"))
            print(f"[obs] tick {sched._ticks}: {tok} tokens emitted, "
                  f"{sched.active} active, {sched.pending} queued, "
                  f"{snap['events_by_kind'].get('retrace', 0)} retrace "
                  "events", flush=True)

    for line in feature_lines(args, sched):
        print(line)
    if registry is not None and args.tasks > 1:
        hot = f"task{args.tasks - 1}"
        done, report = serve_with_runtime_add(
            sched, requests, hot,
            lambda: registry.publish(hot, task_delta(variants[-1], cfg,
                                                     layer_mask)),
            on_tick=after_tick)
        remove_tenant(registry, engine, "task0")
        for line in bank_lines(engine):
            print(line)
    else:
        done, report = sched.run(requests, on_tick=after_tick)
    for c in done:
        who = c.adapter if c.adapter is not None else f"task{c.task_id}"
        print(f"req{c.request_id} {who} prompt={c.prompt_len} "
              f"-> {len(c.tokens)} tok ({c.finish_reason}, "
              f"ttft {c.ttft_s * 1e3:.1f}ms): {c.tokens[:8].tolist()}")
    where = (torch.cuda.get_device_name(engine.device)
             if engine.device.type == "cuda" else "cpu")
    print(f"served {report['requests']} requests / {report['tokens']} tokens "
          f"in {report['elapsed_s']:.3f}s over {report['ticks']} ticks "
          f"({args.num_slots} slots, {where})")
    print("scheduler report:")
    print(format_report(report))
    for line in outcome_lines(sched):
        print(line)
    if slo is not None:
        print(slo_line(obs, report, args.admission))
    n_retrace = len(obs.events_of("retrace"))
    if n_retrace:
        print(f"WARNING: {n_retrace} mid-serve retrace event(s) - see "
              "--events-file for details")
    if prof is not None:
        prof.stop()
        print(f"profiler trace -> {args.profile_dir}")
    if args.metrics_file:
        write_snapshot(obs, args.metrics_file)
        print(f"metrics snapshot -> {args.metrics_file}")
    if events_sink is not None:
        events_sink.close()
    return obs


if __name__ == "__main__":
    main()
