"""Training launcher of the port: the paper's two-stage fine-tune of a
BERT-family encoder on a synthetic GLUE-style task.

The backbone is random, made from --seed on the device. Stage 1 trains
the classification head; stage 2 injects the --peft strategy's adapter,
reloads the head and tunes the strategy's leaves. Both stages run --steps
steps of --batch sequences of --seq tokens.

  python -m repro_torch.launch.train --arch bert-base --task sst2 \\
      --steps 30 --batch 32 --seq 128
  python -m repro_torch.launch.train --arch bert-tiny --task sst2 --smoke \\
      --device cpu
"""
from __future__ import annotations

import argparse

from repro_torch.common.device import resolve_device
from repro_torch.common.types import OptimCfg, TrainCfg
from repro_torch.configs import PAPER, get, get_smoke
from repro_torch.core import peft
from repro_torch.data.synthetic import TASKS, TaskData
from repro_torch.train.loop import two_stage_finetune

# options of the JAX launcher that arrive with later slices
LATER = {
    "quant": "the quantization slice (QPEFT)",
    "prune_to": "the sparse-adapter slice",
    "compress_grads": "the optimizer-state slice",
    "quant_moments": "the optimizer-state slice",
    "mesh": "the distributed slice (torch.distributed)",
    "ckpt_dir": "the checkpoint-interop slice",
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-trainable)")
    ap.add_argument("--peft", default="hadamard",
                    choices=sorted(peft.STRATEGIES))
    ap.add_argument("--task", default=None, choices=sorted(TASKS),
                    help="GLUE-style task (default sst2)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--quant", default="")
    ap.add_argument("--prune-to", type=int, default=0)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--quant-moments", default="")
    ap.add_argument("--mesh", default="")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)

    for opt, slice_ in LATER.items():
        if getattr(args, opt):
            raise NotImplementedError(
                f"--{opt.replace('_', '-')} is not ported yet; it arrives "
                f"with {slice_}")
    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    if cfg.family != "encoder":
        raise NotImplementedError(
            f"{args.arch} is a {cfg.family}: the port trains the paper's "
            f"encoders ({', '.join(sorted(PAPER))}); decoder-LM fine-tuning "
            "is the next training slice")
    device = resolve_device(args.device)
    task = args.task or "sst2"
    data = TaskData(task, cfg.vocab_size, seq_len=args.seq, seed=args.seed)
    tc = TrainCfg(optim=OptimCfg(lr=args.lr, total_steps=args.steps),
                  steps=args.steps, batch_size=args.batch, seq_len=args.seq,
                  log_every=10)
    res = two_stage_finetune(args.seed, cfg, args.peft, data, stage1=tc,
                             stage2=tc, metric=TASKS[task].metric,
                             device=device)
    stats = res.get("param_stats")
    if stats is not None:
        print(f"trainable {stats['trainable']:,} of {stats['total']:,} "
              f"({stats['percent']:.4f}%)")
    print(f"final {TASKS[task].metric}: {res['final_metric']:.4f}")


if __name__ == "__main__":
    main()
