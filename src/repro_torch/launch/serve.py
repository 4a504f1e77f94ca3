"""Serving launcher of the port: continuous-batching generation on a
config, single-tenant or over a multi-task Hadamard adapter bank.

The weights are random, made from --seed on the device, with the
adapters moved off the identity as a fine-tune would move them (one
variant per task with --tasks N, else one). Requests come with prompts of
--prompt-len tokens and budgets of --new-tokens; with --tasks N their task
ids go round-robin. The scheduler admits them into --num-slots cache slots
mid-decode and prints a throughput/latency report.

  python -m repro_torch.launch.serve --arch qwen3-0.6b --requests 8 \
      --num-slots 4 --prompt-len 128 --new-tokens 32 [--tasks 3]
  python -m repro_torch.launch.serve --arch qwen3-0.6b --smoke --device cpu
"""
from __future__ import annotations

import argparse
from typing import List

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.types import ModelCfg
from repro_torch.configs import get, get_smoke
from repro_torch.core import peft
from repro_torch.core.hadamard import perturb_adapters
from repro_torch.models import model as M
from repro_torch.serving import (MultiTaskEngine, Request, ServeEngine,
                                 ServingConfig, format_report, make_scheduler)
from repro_torch.serving.engine import round_to_page


def build_config(arch: str, smoke: bool = False) -> ModelCfg:
    cfg = get_smoke(arch) if smoke else get(arch)
    return peft.attach(cfg, peft.strategy("hadamard"))


def build_params(cfg: ModelCfg, seed: int, tasks: int, device) -> List[dict]:
    """One backbone from `seed` on `device`, and max(tasks, 1) variants of
    it whose adapters are perturbed per task (distinct adapters, as if
    fine-tuned per task)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    base = M.init_params(gen, cfg)
    return [perturb_adapters(base, seed * 1000 + 100 + t)
            for t in range(max(tasks, 1))]


def build_engine(cfg: ModelCfg, seed: int = 0, tasks: int = 0, device=None):
    """ServeEngine over one perturbed adapter, or a MultiTaskEngine over
    `tasks` of them."""
    device = resolve_device(device)
    variants = build_params(cfg, seed, tasks, device)
    if tasks > 0:
        return MultiTaskEngine(cfg, variants, device=device)
    return ServeEngine(cfg, variants[0], device=device)


def make_requests(cfg: ModelCfg, n: int, prompt_len: int, new_tokens: int,
                  tasks: int = 0, seed: int = 0, top_k: int = 0,
                  temperature: float = 1.0) -> List[Request]:
    rs = np.random.RandomState(seed)
    return [Request(prompt=rs.randint(10, cfg.vocab_size, size=(prompt_len,)),
                    max_new_tokens=new_tokens, top_k=top_k,
                    temperature=temperature, seed=seed + i,
                    task_id=i % tasks if tasks > 0 else 0)
            for i in range(n)]


def main(argv=None):
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
    ap.add_argument("--top-k", type=int, default=0,
                    help=">0: per-request top-k sampling (greedy otherwise)")
    ap.add_argument("--temperature", type=float, default=1.0,
                    help="sampling temperature of top-k requests")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = build_config(args.arch, args.smoke)
    engine = build_engine(cfg, args.seed, args.tasks, args.device)
    scfg = ServingConfig(
        num_slots=args.num_slots,
        max_len=args.max_len or round_to_page(args.prompt_len
                                              + args.new_tokens),
        top_k=args.top_k, temperature=args.temperature)
    requests = make_requests(cfg, args.requests, args.prompt_len,
                             args.new_tokens, args.tasks, args.seed,
                             scfg.top_k, scfg.temperature)
    done, report = make_scheduler(engine, scfg).run(requests)
    for c in done:
        print(f"req{c.request_id} task{c.task_id} prompt={c.prompt_len} "
              f"-> {len(c.tokens)} tok ({c.finish_reason}, "
              f"ttft {c.ttft_s * 1e3:.1f}ms): {c.tokens[:8].tolist()}")
    where = (torch.cuda.get_device_name(engine.device)
             if engine.device.type == "cuda" else "cpu")
    print(f"served {report['requests']} requests / {report['tokens']} tokens "
          f"in {report['elapsed_s']:.3f}s over {report['ticks']} ticks "
          f"({args.num_slots} slots, {where})")
    print("scheduler report:")
    print(format_report(report))


if __name__ == "__main__":
    main()
