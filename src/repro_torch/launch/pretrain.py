"""Full-backbone MLM pretraining launcher with memory-lean optimizer state
(port of `repro.launch.pretrain`).

  python -m repro_torch.launch.pretrain --arch bert-base --steps 200
  python -m repro_torch.launch.pretrain --arch bert-tiny --device cpu \\
      --quant-moments bf16+int8 --save-every 50 --ckpt-dir D [--resume]

Every leaf of a BERT-family encoder trains (strategy `full`) on the MLM
loss over the synthetic corpus (`train.pretrain`). `--quant-moments`
selects the AdamW moment storage (`optim.qstate`):

  bf16       m bf16  + v bf16   2.0x smaller optimizer state
  bf16+int8  m bf16  + v int8   ~2x with EF (the quality-safest int8 preset)
  int8       m int8  + v int8   ~2x with EF; ~3.9x with --no-ef, but no-EF
                                int8 v deadzones and diverges: a bytes
                                floor only

Checkpoints written by `--save-every` hold the moments in their stored
dtype; `--resume` rebuilds the same-OptimCfg state, restores the newest
snapshot into it and replays the batch stream up to its step, so a resumed
run continues bit for bit as the unbroken one. The backbone is random,
made from --seed on --device (cuda unless cpu is named).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.common.device import resolve_device
from repro_torch.common.types import OptimCfg
from repro_torch.configs import PAPER
from repro_torch.core import peft
from repro_torch.data.synthetic import lm_corpus
from repro_torch.optim import qstate
from repro_torch.train.loop import StepWatchdog, run_train
from repro_torch.train.pretrain import mlm_batches, mlm_loss
from repro_torch.train.steps import build_train_step, make_state, restore_state

# preset -> (m_dtype, v_dtype); see qstate's bytes per parameter for why
# the >= 3x config is all-int8 while bf16+int8 is the quality-safest one
QUANT_PRESETS = {
    "": ("float32", "float32"),
    "bf16": ("bfloat16", "bfloat16"),
    "bf16+int8": ("bfloat16", "int8"),
    "int8": ("int8", "int8"),
}


def optim_for(preset: str, *, lr: float, steps: int,
              ef: bool = True) -> OptimCfg:
    m_dt, v_dt = QUANT_PRESETS[preset]
    return OptimCfg(lr=lr, total_steps=steps,
                    warmup_steps=max(steps // 20, 5),
                    m_dtype=m_dt, v_dtype=v_dt, qstate_ef=ef)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="bert-tiny", choices=sorted(PAPER))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mask-rate", type=float, default=0.15)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--quant-moments", default="",
                    choices=sorted(QUANT_PRESETS),
                    help="AdamW moment storage preset (default fp32 exact)")
    ap.add_argument("--no-ef", action="store_true",
                    help="disable int8 error feedback (smaller, but no-EF "
                         "int8 v deadzones: bytes measurement only)")
    ap.add_argument("--save-every", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="results/pretrain_ckpt_torch")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest snapshot in --ckpt-dir")
    ap.add_argument("--log-every", type=int, default=25)
    args = ap.parse_args(argv)

    cfg = PAPER[args.arch]()
    device = resolve_device(args.device)
    ocfg = optim_for(args.quant_moments, lr=args.lr, steps=args.steps,
                     ef=not args.no_ef)
    ef = qstate.quantized_moments(ocfg) and ocfg.qstate_ef
    print(f"backbone: {cfg.name} ({cfg.n_layers}L, d={cfg.d_model}); "
          f"moments m={ocfg.m_dtype} v={ocfg.v_dtype}{' +ef' if ef else ''}")

    state = make_state(torch.Generator(device=device).manual_seed(args.seed),
                       cfg, peft.strategy("full"), ocfg)
    s = qstate.state_summary(state["opt"], ocfg)
    print(f"optimizer state: {s['bytes'] / 2**20:.2f} MiB for "
          f"{s['n_params']:,} params (fp32 would be "
          f"{s['bytes_fp32'] / 2**20:.2f} MiB; {s['ratio']:.2f}x)")

    manager = None
    start = 0
    if args.save_every or args.resume:
        manager = CheckpointManager(args.ckpt_dir)
    if args.resume and manager.latest() is not None:
        restored, _ = manager.restore()
        restore_state(state, restored)
        start = state["step"]
        print(f"resumed from step {start} in {args.ckpt_dir}")
    if start >= args.steps:
        print("nothing to do: checkpoint is at/after --steps")
        return

    corpus = lm_corpus(cfg.vocab_size, 300_000, seed=args.seed)
    batches = mlm_batches(corpus, args.steps, args.batch, args.seq,
                          mask_rate=args.mask_rate, seed=args.seed)
    for _ in range(start):  # replay the stream up to the resume point
        next(batches)

    step_fn = build_train_step(cfg, ocfg, loss_fn=mlm_loss)
    state, hist = run_train(state, step_fn, batches,
                            steps=args.steps - start,
                            log_every=args.log_every, manager=manager,
                            save_every=args.save_every,
                            watchdog=StepWatchdog())
    print(f"done: mlm ce {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
          f"over steps {start}..{args.steps}")


if __name__ == "__main__":
    main()
