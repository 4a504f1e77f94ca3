"""Training launcher of the port: decoder-LM fine-tuning with a PEFT
strategy on the synthetic Markov corpus (optionally over an int8/fp8
trunk, QPEFT, and with checkpoints), or the paper's two-stage fine-tune
of a BERT-family encoder on a synthetic GLUE-style task.

The backbone is random, made from --seed on the device. A decoder trains
--steps steps of --batch windows of --seq tokens of `lm_corpus`; with
--quant the frozen trunk is quantized after the PEFT partition, with
activation-weighted clips from --calibrate-batches batches of calibration
(0: plain absmax); with --ckpt-dir every --save-every-th step is saved
and --resume starts from the newest snapshot. An encoder runs stage 1
(the classification head) and stage 2 (the --peft strategy's adapter on
the reloaded head), --steps steps each. --peft picks the paper's adapter
or a baseline (lora, houlsby, ia3, full, ...); --prune-to K trains only
the top K layers' adapters (paper Table 5). --quant-moments stores the
AdamW moments in bf16 or int8 (`launch.pretrain.QUANT_PRESETS`, with
error feedback unless --no-ef), --compress-grads compresses each gradient
to int8 with error feedback. A decoder is an attention stack (qwen3) or
an RWKV6 one (rwkv6-1.6b).

  python -m repro_torch.launch.train --arch qwen3-0.6b --peft hadamard \\
      --steps 30 --batch 16 --seq 128 [--quant int8 --calibrate-batches 2]
  python -m repro_torch.launch.train --arch qwen3-0.6b --smoke --device cpu \\
      --steps 12 --batch 8 --seq 32 [--ckpt-dir D --save-every 6 --resume]
  python -m repro_torch.launch.train --arch rwkv6-1.6b --peft hadamard \\
      --steps 30 --batch 16 --seq 128 [--quant int8] [--compress-grads] \\
      [--quant-moments bf16+int8 [--no-ef]]
  python -m repro_torch.launch.train --arch bert-base --task sst2 \\
      --steps 30 --batch 32 --seq 128
  python -m repro_torch.launch.train --arch bert-tiny --task sst2 --smoke \\
      --device cpu [--peft lora] [--prune-to 1]

With --mesh DxM a decoder trains data-parallel over D ranks (each its
shard of every batch, `data.pipeline.shard_batch`; the gradients averaged
before the compression and the clip, as JAX's step sees the global
batch) and tensor-parallel over M (`dist.sharding`'s rules, Megatron's
layout), rank 0 printing and saving. Under `torchrun --nproc-per-node N`
each process is a rank; without torchrun the launcher spawns them
(--backend gloo for ranks that share one card):

  torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch qwen3-0.6b --mesh 2x1
  python -m repro_torch.launch.train --arch qwen3-0.6b --smoke --device cpu --mesh 2x2
"""
from __future__ import annotations

import argparse
import contextlib
import io
import sys

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.common.device import resolve_device
from repro_torch.common.types import OptimCfg, TrainCfg
from repro_torch.configs import get, get_smoke
from repro_torch.convert import jax_path
from repro_torch.core import peft
from repro_torch.data.pipeline import Prefetcher, shard_batches
from repro_torch.data.synthetic import TASKS, TaskData, lm_batches, lm_corpus
from repro_torch.dist.api import Mesh, use_mesh
from repro_torch.dist.sharding import check_mesh, local_cfg
from repro_torch.launch.mesh import parse_mesh, run_world
from repro_torch.launch.pretrain import QUANT_PRESETS
from repro_torch.models import model as M
from repro_torch.optim import qstate
from repro_torch.quant import calibrate, quant_summary
from repro_torch.sparse.importance import depth_mask, n_layers
from repro_torch.train.loop import StepWatchdog, run_train, two_stage_finetune
from repro_torch.train.losses import loss_for
from repro_torch.train.steps import (build_train_step, make_mesh_state,
                                    make_state, restore_state)

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-trainable)")
    ap.add_argument("--peft", default="hadamard",
                    choices=sorted(peft.STRATEGIES))
    ap.add_argument("--task", default=None, choices=sorted(TASKS),
                    help="GLUE-style task (encoder archs, default sst2)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--quant", default="", choices=["", "int8", "fp8"],
                    help="QPEFT: quantize the frozen trunk (int8/fp8) and "
                         "train the adapter on top of it (decoder-LM path; "
                         "needs a frozen-trunk strategy)")
    ap.add_argument("--calibrate-batches", type=int, default=0,
                    help="with --quant: run this many batches of "
                         "activation-statistics calibration before "
                         "quantizing (0 = plain absmax scales)")
    ap.add_argument("--prune-to", type=int, default=0,
                    help="train only the top-K layers' adapters (mask-gated "
                         "gradients; the rest stay identity). 0 = all "
                         "layers; the paper's 0.022%% variant is K = 2L/3")
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 gradient compression with error feedback")
    ap.add_argument("--quant-moments", default="",
                    choices=sorted(QUANT_PRESETS),
                    help="AdamW moment storage (optim.qstate): bf16 / "
                         "bf16+int8 / int8; '' keeps exact fp32 moments")
    ap.add_argument("--no-ef", action="store_true",
                    help="disable int8 moment error feedback (bytes floor "
                         "only: no-EF int8 v deadzones and diverges)")
    ap.add_argument("--mesh", default="",
                    help="'DATAxMODEL' (e.g. 2x1): the decoder-LM step "
                         "data-parallel over DATA ranks (a batch shard "
                         "each, gradients averaged) and tensor-parallel "
                         "over MODEL; under torchrun this process is one "
                         "rank, else the ranks are spawned here")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="the ranks' backend: nccl with a card a rank "
                         "(default on the card), gloo on the CPU or for "
                         "ranks that share one card")
    args = ap.parse_args(argv)
    if args.mesh:
        try:
            shape = parse_mesh(args.mesh)
        except ValueError as e:
            raise SystemExit(str(e))
        cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
        if cfg.family == "encoder":
            raise SystemExit("--mesh runs the decoder-LM path; the "
                             "two-stage encoder recipe runs on one device")
        try:  # refused meshes fail before any rank starts
            check_mesh(peft.attach(cfg, peft.strategy(args.peft)),
                       Mesh(shape))
        except NotImplementedError as e:
            raise SystemExit(f"--mesh {args.mesh}: {e}")
        run_world(shape, _train_rank, args,
                  device=resolve_device(args.device), backend=args.backend)
        return
    _train(args)


def _train_rank(mesh, args):
    """One rank of a --mesh run; rank 0 prints and writes checkpoints."""
    out = sys.stdout if mesh.rank == 0 else io.StringIO()
    with use_mesh(mesh), contextlib.redirect_stdout(out):
        if mesh.rank == 0:
            print(f"mesh {'x'.join(map(str, mesh.shape))}: {mesh.size} "
                  f"rank(s) over {mesh.backend}, data degree "
                  f"{mesh.degree('dp')}, model degree "
                  f"{mesh.degree('model')}")
        _train(args, mesh)


def train_batches(corpus, args, mesh=None) -> Prefetcher:
    """--steps batches of `corpus`, made in a prefetch thread; under a
    mesh, each rank's shard of every batch, copied to `mesh.device`."""
    source = lm_batches(corpus, args.steps, args.batch, args.seq,
                        seed=args.seed)
    if mesh is not None:
        dp = mesh.degree("dp")
        if args.batch % dp:
            raise SystemExit(f"--batch {args.batch} does not split over "
                             f"{dp} data ranks")
        source = shard_batches(source, mesh, mesh.device)
    return Prefetcher(source)


def _train(args, mesh=None):
    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    strat = peft.strategy(args.peft)
    # a rank's own card, named for the prefetch thread's copies too
    device = resolve_device(args.device) if mesh is None else mesh.device
    m_dt, v_dt = QUANT_PRESETS[args.quant_moments]
    ocfg = OptimCfg(lr=args.lr, total_steps=args.steps,
                    compress_grads=args.compress_grads, m_dtype=m_dt,
                    v_dtype=v_dt, qstate_ef=not args.no_ef)

    layer_mask = None
    if args.prune_to:
        try:
            layer_mask = depth_mask(cfg, args.prune_to)
        except ValueError as e:
            raise SystemExit(f"--prune-to: {e}")
        print(f"pruned training: top {args.prune_to}/{n_layers(cfg)} "
              "layers' adapters unfrozen (mask-gated gradients)")

    if cfg.family == "encoder":
        if args.quant:
            raise SystemExit("--quant targets the decoder-LM path; the "
                             "two-stage encoder recipe manages its own "
                             "states (quantize post-training for serving)")
        task = args.task or "sst2"
        data = TaskData(task, cfg.vocab_size, seq_len=args.seq, seed=args.seed)
        tc = TrainCfg(optim=ocfg, steps=args.steps, batch_size=args.batch,
                      seq_len=args.seq, log_every=10)
        res = two_stage_finetune(args.seed, cfg, args.peft, data, stage1=tc,
                                 stage2=tc, metric=TASKS[task].metric,
                                 layer_mask=layer_mask, device=device)
        stats = res.get("param_stats")
        if stats is not None:
            print(f"trainable {stats['trainable']:,} of {stats['total']:,} "
                  f"({stats['percent']:.4f}%)")
        print(f"final {TASKS[task].metric}: {res['final_metric']:.4f}")
        return

    # decoder-family LM fine-tuning with PEFT
    cfg = peft.attach(cfg, strat)
    loss_for(cfg)  # a family or layer the port does not train raises here

    def gen():
        return torch.Generator(device=device).manual_seed(args.seed)

    corpus = lm_corpus(cfg.vocab_size, 200_000, seed=args.seed)
    batches = train_batches(corpus, args, mesh)
    params = stats = None
    if args.quant and args.calibrate_batches:
        params = M.init_params(gen(), cfg)
        cal = lm_batches(corpus, args.calibrate_batches, args.batch,
                         args.seq, seed=args.seed + 1)
        stats = calibrate(cfg, params, cal,
                          max_batches=args.calibrate_batches)
        print(f"calibrated {len(stats)} call sites over "
              f"{args.calibrate_batches} batches")
    if mesh is None:
        state = make_state(gen(), cfg, strat, ocfg, params=params,
                           quant=args.quant or None, quant_stats=stats)
    else:  # the whole state from the seed (quantized whole), then sliced
        state = make_mesh_state(gen(), cfg, strat, ocfg, mesh, params=params,
                                quant=args.quant or None, quant_stats=stats)
        cfg = local_cfg(cfg, mesh)
    del params
    if qstate.quantized_moments(ocfg):
        qss = qstate.state_summary(state["opt"], ocfg)
        print(f"optimizer state: {qss['bytes'] / 2**20:.2f} MiB for "
              f"{qss['n_params']:,} params (fp32 would be "
              f"{qss['bytes_fp32'] / 2**20:.2f} MiB; {qss['ratio']:.2f}x)")
    if args.quant:
        qs = quant_summary(state["params"],
                           leaf_name=lambda p: jax_path(p, cfg))
        print(f"quantized trunk: {qs['n_quantized_leaves']} leaves, "
              f"{qs['dense_bytes_fp32'] / 2**20:.1f} MiB fp32 -> "
              f"{qs['quantized_bytes'] / 2**20:.1f} MiB "
              f"({qs['ratio']:.2f}x)")
    manager = None
    if args.ckpt_dir:
        if state.get("sharded"):
            raise SystemExit(
                "--ckpt-dir under --mesh: trainable leaves sharded over "
                "'model' would be written as one rank's slice")
        manager = CheckpointManager(args.ckpt_dir, keep=3)
        if args.resume and manager.latest() is not None:
            restored, meta = manager.restore()
            restore_state(state, restored)
            print(f"resumed from step {meta['step']}")
    step = build_train_step(cfg, ocfg, layer_mask=layer_mask)
    # every rank holds the same trainable leaves and moments; rank 0 saves
    saver = manager if mesh is None or mesh.rank == 0 else None
    state, hist = run_train(state, step, batches, steps=args.steps,
                            log_every=10, manager=saver,
                            save_every=args.save_every,
                            watchdog=StepWatchdog())
    print(f"final loss: {hist[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
