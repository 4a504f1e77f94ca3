#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU.

  python3 chip_smoke.py

Phases (any failed check exits non-zero; no phase catches its own failure):
  1. the card and its settings (TF32 off for fp32 matmuls);
  2. build every CUDA kernel from the sources in this checkout;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the serve and train paths give it, in fp32 and bf16, with its
     time, the plain version's time and, where one exists, one PyTorch
     call's time; the backward of every autograd Function around a kernel
     against autograd through the plain forward;
  4. the full-width qwen3-0.6b model (28 layers) in fp32: prefill and four
     decode steps through the kernels against the plain versions
     (impl="ref"), single adapter and a 3-task bank;
  5. single-tenant serving: ServeEngine + Scheduler, 8 requests, 4 slots,
     max_len 512, prompt 128, 32 new tokens, bf16;
  6. multi-tenant serving: the same traffic through a 3-task
     MultiTaskEngine, task ids round-robin;
  7. the full-width bert-base encoder (12 layers) in fp32 on one batch of
     32x128 sst2 tokens with perturbed adapters: logits, stage-2 loss and
     every trainable gradient through the kernels against the plain path,
     for the 'hadamard' (attn_out) and 'hadamard_concat' strategies;
  8. the paper's two-stage fine-tune of bert-base on sst2 (seq 128, batch
     32, 30 steps per stage) for 'hadamard', then stage 2 alone for
     'hadamard_concat': finite losses, the trainable count, the launches of
     every train step and eval batch counted inside those runs, step rates
     and a torch.profiler breakdown of a train step;
  9. one JSON line of per-kernel results (launch counts from phases 5, 6
     and 8);
  then the card's name and power limit, and the last line,
  {"ok": true, "device": {...}}.

It needs a CUDA device and the repo's `src/` beside it, and imports no JAX.
The GPUs other than the first are hidden from it: it drives one card.
"""
from __future__ import annotations

import itertools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published H100 SXM peaks (NVIDIA data sheet, dense): the roofline bound of
# each kernel is the larger of bytes over the memory rate and flops over the
# peak of the type it computes in
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

ARCH = "qwen3-0.6b"
SERVE = dict(requests=8, num_slots=4, max_len=512, prompt_len=128,
             new_tokens=32, seed=0)
TASKS = 3
# the paper's experiment: two-stage fine-tune of bert-base on sst2
TRAIN = dict(arch="bert-base", task="sst2", batch=32, seq=128, steps=30,
             lr=3e-3, seed=0)
# bert-base's stage-2 trainable count under 'hadamard' (adapter w and b
# plus the ffn-output LayerNorm of 12 layers), as the JAX package counts it
BERT_BASE_TRAINABLE = (36_864, 109_503_746)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def main() -> int:
    # one card: the first visible one, and only it
    os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get(
        "CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2

    import torch.nn.functional as F

    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.attention import FlashAttention
    from repro_torch.kernels.hadamard import FusedAdapterResidualNorm
    from repro_torch.launch import serve as launcher
    from repro_torch.models import model as M
    from repro_torch.serving import ServingConfig, make_scheduler

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- phase 1: card and settings -----------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = f"{smi} (torch {torch.__version__}, CUDA {torch.version.cuda})"
    log(f"[1] card: {card}")
    log(smi)

    # -- phase 2: build -----------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    log(f"[2] built {len(_build.sources())} CUDA sources in "
        f"{time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def time_ms(fn, iters=20, reps=10):
        """(device ms per call, host ms per call). The device time comes
        from replays of a CUDA graph of `iters` calls, so it holds no host
        launch cost; the host time is the same calls made eagerly, what a
        Python caller pays per call where the host is the limit."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters * reps):
            fn()
        end.record()
        end.synchronize()
        eager = start.elapsed_time(end) / (iters * reps)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (iters * reps), eager

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    # fp32 tolerances: max abs error of an elementwise output; an output
    # summed over rows (dw, db, dscale, dbias) is held to SUM_TOL of its
    # reference's max abs, since the kernel sums in another order. bf16:
    # each output within BF16_TOL of its own reference's max abs.
    TOL = {"fused_adapter_norm": 1e-5, "flash_attention": 1e-4,
           "paged_attention": 1e-4, "multitask_hadamard": 1e-5,
           "hadamard_affine": 1e-5, "hadamard_affine_bwd": 1e-5,
           "fused_adapter_norm_bwd": 1e-5, "flash_attention_bwd": 1e-4}
    SUM_TOL, BF16_TOL = 1e-5, 2e-2
    # errs: fp32 max abs err of the elementwise outputs, per case; rels:
    # bf16 worst max abs err / max |ref| over the outputs, per case
    checks = {name: {"errs": [], "rels": [], "summed": False} for name in TOL}

    def compare(name, case, dtype, kernel_fn, plain_fn, summed=()):
        """Kernel against plain version on the same inputs, output by
        output. fp32: max abs error within TOL (SUM_TOL of max |ref| for the
        outputs whose index is in `summed`); bf16: within BF16_TOL of the
        output's own max |ref|."""
        got, want = kernel_fn(), plain_fn()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        check(len(got) == len(want), f"{name} {case}: {len(got)} outputs, "
                                     f"want {len(want)}")
        checks[name]["summed"] |= bool(summed)
        worst = 0.0
        for i, (g, w) in enumerate(zip(got, want)):
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"{name} {case}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
            check(bool(torch.isfinite(g.float()).all()),
                  f"{name} {case}: non-finite output")
            e = (g.float() - w.float()).abs().max().item()
            m = w.float().abs().max().item()
            if dtype != torch.float32:
                tol = BF16_TOL * m
                worst = max(worst, e / max(m, 1e-30))
            elif i in summed:
                tol = SUM_TOL * m
            else:
                tol = TOL[name]
                worst = max(worst, e)
            check(e <= tol, f"{name} {case} {dtype}: output {i} max abs err "
                            f"{e:.3g} > tol {tol:.3g} (max|ref| {m:.3g})")
        key = "errs" if dtype == torch.float32 else "rels"
        checks[name][key].append(worst)

    def errors(name):
        """The worst errors of a kernel's checks, for the log."""
        c = checks[name]
        summed = (f"; outputs summed over rows within {SUM_TOL} of their "
                  "max|ref|") if c["summed"] else ""
        return (f"fp32 max abs err {max(c['errs']):.3g} (tol {TOL[name]}"
                f"{summed}), bf16 worst max abs err / max|ref| per output "
                f"{max(c['rels']):.3g} (tol {BF16_TOL})")

    results = {}

    def record(key, name, shape, dtype, kernel_fn, plain_fn, library_fn,
               bytes_, flops):
        """Time kernel, plain version and library call at one shape of the
        serve or train path; the bound is the larger of bytes over the
        memory rate and flops over the peak of `dtype`, the type of the
        timed inputs."""
        ms, host_ms = time_ms(kernel_fn)
        plain_ms, plain_host_ms = time_ms(plain_fn)
        lib_ms = lib_host_ms = None
        if library_fn is not None:
            lib_ms, lib_host_ms = time_ms(library_fn)
        t_mem = bytes_ / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[str(dtype).removeprefix("torch.")]
        r = dict(shape=shape, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                 host_ms=host_ms, plain_host_ms=plain_host_ms,
                 library_host_ms=lib_host_ms, bytes=bytes_, flops=flops,
                 bound_ms=max(t_mem, t_ops) * 1e3,
                 bound_by="bytes" if t_mem >= t_ops else "operations")
        results[key] = r
        log(f"[3] {name}: {errors(name)}; {shape}: device ms kernel {ms:.5f}, plain {plain_ms:.5f}, "
            f"library {lib_ms}, bound {r['bound_ms']:.6f} ({r['bound_by']}); "
            f"host ms per eager call kernel {host_ms:.5f}, plain "
            f"{plain_host_ms:.5f}; on {smi}")

    # -- phase 3: each kernel against its plain version ---------------------
    d = 1024
    bf = torch.bfloat16
    # #3 fused adapter-residual-norm: rows x 1024, both norm forms
    for dt in (torch.float32, bf):
        for rows, width in ((4, d), (128, d), (1000, d), (7, 4000)):
            x, res = randn(rows, width, dtype=dt), randn(rows, width, dtype=dt)
            w, b = 1 + randn(width, scale=0.1), randn(width, scale=0.1)
            scale, bias = randn(width, dtype=dt), randn(width, dtype=dt)
            for bi in (None, bias):
                kw = dict(bias=bi, eps=1e-6)
                compare("fused_adapter_norm",
                        f"rows={rows} d={width} ln={bi is not None}",
                        dt,
                        lambda: ops.fused_adapter_norm(x, res, w, b, scale,
                                                       impl="kernel", **kw),
                        lambda: ops.fused_adapter_norm(x, res, w, b, scale,
                                                       impl="ref", **kw))
    x, res = randn(4, 1, d, dtype=bf), randn(4, 1, d, dtype=bf)
    w, b, scale = 1 + randn(d, scale=0.1), randn(d, scale=0.1), randn(d, dtype=bf)
    record("fused_adapter_norm", "fused_adapter_norm",
           "x,res (4,1,1024) bf16, fp32 w/b, RMSNorm (one layer of a 4-slot "
           "decode tick)", bf,
           lambda: ops.fused_adapter_norm(x, res, w, b, scale, impl="kernel"),
           lambda: ops.fused_adapter_norm(x, res, w, b, scale, impl="ref"),
           None, nbytes(x, res, w, b, scale) + 2 * nbytes(x), 8 * x.numel())

    # #4 flash attention: (1,16,S,128) q over (1,8,S,128) k/v
    # the serve shapes, then the other masks, head dims and group sizes
    cases = [dict(sq=s, skv=s) for s in (1, 37, 128, 512)]
    cases += [dict(sq=200, skv=200, window=64, cap=30.0),
              dict(sq=37, skv=300), dict(sq=70, skv=70, D=64, kh=16),
              dict(sq=40, skv=100, D=256, b=2)]
    # the encoder's non-causal attention: bert-base's train shape (12 heads
    # of 64, no grouping) and a ragged one
    B_tr, S_tr = TRAIN["batch"], TRAIN["seq"]
    cases += [dict(sq=S_tr, skv=S_tr, D=64, h=12, kh=12, b=B_tr, causal=False),
              dict(sq=37, skv=300, D=64, h=12, kh=12, b=2, causal=False)]
    for dt in (torch.float32, bf):
        for c in cases:
            nb_, kh, D = c.get("b", 1), c.get("kh", 8), c.get("D", 128)
            q = randn(nb_, c.get("h", 16), c["sq"], D, dtype=dt)
            k = randn(nb_, kh, c["skv"], D, dtype=dt)
            v = randn(nb_, kh, c["skv"], D, dtype=dt)
            kw = dict(causal=c.get("causal", True), window=c.get("window"),
                      cap=c.get("cap", 0.0))
            compare("flash_attention", str(c), dt,
                    lambda: ops.flash_attention(q, k, v, impl="kernel", **kw),
                    lambda: ops.flash_attention(q, k, v, impl="ref", **kw))
    S = SERVE["prompt_len"]
    q = randn(1, 16, S, 128, dtype=bf)
    k, v = randn(1, 8, S, 128, dtype=bf), randn(1, 8, S, 128, dtype=bf)
    record("flash_attention", "flash_attention",
           f"q (1,16,{S},128) over k/v (1,8,{S},128) bf16 causal (one layer "
           "of a prefill)", bf,
           lambda: ops.flash_attention(q, k, v, impl="kernel"),
           lambda: ops.flash_attention(q, k, v, impl="ref"),
           lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True),
           2 * nbytes(q) + nbytes(k, v), 4 * 16 * 128 * (S * (S + 1) // 2))

    # #5 paged decode attention: 16 heads over 8, D=128, page 16
    page, nbt, B = 16, 32, 6
    nb = B * nbt + 1
    tables = (torch.randperm(nb - 1, generator=gen, device=dev)[:B * nbt] + 1
              ).to(torch.int32).reshape(B, nbt)
    lens = torch.tensor([1, 17, 129, 300, 511, 512], dtype=torch.int32,
                        device=dev)
    pcases = [dict(), dict(window=100), dict(int8=True), dict(sq=5),
              dict(sq=5, window=100), dict(cap=30.0), dict(int8=True, sq=5)]
    for dt in (torch.float32, bf):
        for c in pcases:
            sq = c.get("sq", 1)
            q = randn(B, 16, sq, 128, dtype=dt) if sq > 1 else \
                randn(B, 16, 128, dtype=dt)
            kw = dict(window=c.get("window"), cap=c.get("cap", 0.0))
            if c.get("int8"):
                kp = torch.randint(-127, 128, (nb, page, 8, 128), generator=gen,
                                   device=dev, dtype=torch.int8)
                vp = torch.randint(-127, 128, (nb, page, 8, 128), generator=gen,
                                   device=dev, dtype=torch.int8)
                kw.update(k_scales=randn(nb, page, 8, 1).abs() * 0.01,
                          v_scales=randn(nb, page, 8, 1).abs() * 0.01)
            else:
                kp = randn(nb, page, 8, 128, dtype=dt)
                vp = randn(nb, page, 8, 128, dtype=dt)
            kl = lens.clamp(min=sq)
            compare("paged_attention", str(c), dt,
                    lambda: ops.paged_attention(q, kp, vp, tables, kl,
                                                impl="kernel", **kw),
                    lambda: ops.paged_attention(q, kp, vp, tables, kl,
                                                impl="ref", **kw))
    B, max_len = SERVE["num_slots"], SERVE["max_len"]
    nbt = max_len // page
    q = randn(B, 16, 128, dtype=bf)
    kp = randn(B * nbt, page, 8, 128, dtype=bf)
    vp = randn(B * nbt, page, 8, 128, dtype=bf)
    tables = (torch.arange(B, device=dev, dtype=torch.int32)[:, None] * nbt
              + torch.arange(nbt, device=dev, dtype=torch.int32))
    kl = torch.tensor([129, 140, 150, 160], dtype=torch.int32, device=dev)
    n_keys = int(kl.sum())
    record("paged_attention", "paged_attention",
           f"q ({B},16,128) bf16 over a ({B},{max_len},8,128) bf16 slot cache, "
           f"kv_lens {kl.tolist()} (one layer of a 4-slot decode tick)", bf,
           lambda: ops.paged_attention(q, kp, vp, tables, kl, impl="kernel"),
           lambda: ops.paged_attention(q, kp, vp, tables, kl, impl="ref"),
           None,
           # q, the valid K and V rows, tables, lens, fp32 out
           nbytes(q, tables, kl) + n_keys * 8 * 128 * 2 * 2 + B * 16 * 128 * 4,
           4 * 16 * 128 * n_keys)

    # #6 multitask Hadamard: (4, S, 1024), T = 3; and a ragged width
    tids = torch.tensor([0, 2, 1, 2], dtype=torch.int32, device=dev)
    for dt in (torch.float32, bf):
        for s, width in ((1, d), (128, d), (5, 1000)):
            x = randn(4, s, width, dtype=dt)
            wb = 1 + randn(TASKS, width, scale=0.1)
            bb = randn(TASKS, width, scale=0.1)
            compare("multitask_hadamard", f"S={s} d={width}", dt,
                    lambda: ops.multitask_hadamard(x, wb, bb, tids,
                                                   impl="kernel"),
                    lambda: ops.multitask_hadamard(x, wb, bb, tids, impl="ref"))
    x = randn(4, 1, d, dtype=bf)
    wb, bb = 1 + randn(TASKS, d, scale=0.1), randn(TASKS, d, scale=0.1)
    record("multitask_hadamard", "multitask_hadamard",
           "x (4,1,1024) bf16, fp32 bank (3,1024) (one layer of a 4-slot "
           "decode tick)", bf,
           lambda: ops.multitask_hadamard(x, wb, bb, tids, impl="kernel"),
           lambda: ops.multitask_hadamard(x, wb, bb, tids, impl="ref"),
           None,
           # x, y, ids, and the 3 distinct (w, b) rows the ids name
           2 * nbytes(x) + nbytes(tids) + 3 * 2 * d * 4, 2 * x.numel())

    # #1 hadamard_affine and #2 its backward, hadamard_affine_bwd: the rows
    # of a bert-base train batch (32x128 tokens, d=768), and ragged shapes
    d_tr, n_tr = 768, B_tr * S_tr
    f32 = torch.float32
    for dt in (f32, bf):
        for rows, width in ((n_tr, d_tr), (1000, d_tr), (7, 4000)):
            x, g = randn(rows, width, dtype=dt), randn(rows, width, dtype=dt)
            w, b = 1 + randn(width, scale=0.1), randn(width, scale=0.1)
            case = f"rows={rows} d={width}"
            compare("hadamard_affine", case, dt,
                    lambda: ops.hadamard(x, w, b, impl="kernel"),
                    lambda: ops.hadamard(x, w, b, impl="ref"))
            compare("hadamard_affine_bwd", case, dt,
                    lambda: ops.hadamard_affine_bwd(g, x, w, impl="kernel"),
                    lambda: ops.hadamard_affine_bwd(g, x, w, impl="ref"),
                    summed=(1, 2))

    def grads_of(fn, inputs, cotangents):
        """Gradients of fn's outputs with the given cotangents (None: that
        output is discarded) with respect to every input."""
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        outs = fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        kept = [(o, c) for o, c in zip(outs, cotangents) if c is not None]
        return torch.autograd.grad([o for o, _ in kept], leaves,
                                   [c for _, c in kept])

    # the backward of FusedAdapterResidualNorm (norm VJP in plain torch,
    # then #2) against autograd through the plain forward, for the post-LN
    # encoder's LayerNorm (eps 1e-12) and the decoder's RMSNorm; with and
    # without a cotangent for x_new (the encoder block discards it)
    for dt in (f32, bf):
        for shape in ((B_tr, S_tr, d_tr), (1000, d_tr), (7, 4000)):
            width = shape[-1]
            x, res = randn(*shape, dtype=dt), randn(*shape, dtype=dt)
            w, b = 1 + randn(width, scale=0.1), randn(width, scale=0.1)
            scale, bias = 1 + randn(width, dtype=dt, scale=0.1), \
                randn(width, dtype=dt, scale=0.1)
            g_xn, g_h = randn(*shape, dtype=dt), randn(*shape, dtype=dt)
            for ln, eps in ((True, 1e-12), (False, 1e-6)):
                for gx in (None, g_xn):
                    ins = (x, res, w, b, scale) + ((bias,) if ln else ())

                    def kern(*t, eps=eps, ln=ln):
                        return FusedAdapterResidualNorm.apply(
                            *t[:5], t[5] if ln else None, eps, "kernel")

                    def plain(*t, eps=eps, ln=ln):
                        return ref.fused_adapter_residual_norm_ref(
                            *t[:5], eps=eps, bias=t[5] if ln else None)

                    compare("fused_adapter_norm_bwd",
                            f"{shape} ln={ln} g_xn={gx is not None}", dt,
                            lambda: grads_of(kern, ins, (gx, g_h)),
                            lambda: grads_of(plain, ins, (gx, g_h)),
                            summed=(2, 3, 4, 5))

    # the backward of FlashAttention (plain PyTorch: P recomputed from q
    # and k, delta from the kernel's output) against autograd through the
    # plain forward: the encoder's shapes, and a causal grouped one
    fcases = [dict(b=B_tr, h=12, kh=12, sq=S_tr, skv=S_tr, D=64, causal=False),
              dict(b=2, h=12, kh=12, sq=37, skv=300, D=64, causal=False),
              dict(b=1, h=16, kh=8, sq=128, skv=128, D=128, causal=True)]
    for dt in (f32, bf):
        for c in fcases:
            q = randn(c["b"], c["h"], c["sq"], c["D"], dtype=dt)
            k = randn(c["b"], c["kh"], c["skv"], c["D"], dtype=dt)
            v = randn(c["b"], c["kh"], c["skv"], c["D"], dtype=dt)
            g = randn(c["b"], c["h"], c["sq"], c["D"], dtype=dt)
            causal = c["causal"]
            compare("flash_attention_bwd", str(c), dt,
                    lambda: grads_of(lambda *t: FlashAttention.apply(
                        *t, causal, None, None, 0.0, "kernel"), (q, k, v), (g,)),
                    lambda: grads_of(lambda *t: ops.flash_attention(
                        *t, causal=causal, impl="ref"), (q, k, v), (g,)))
    for name in ("fused_adapter_norm_bwd", "flash_attention_bwd"):
        log(f"[3] {name} (the gradients): {errors(name)}")

    # timed at the train shapes, fp32 as bert-base trains. Each timed call
    # takes the next of several copies of its inputs, together over twice
    # the 50 MB L2, so that it reads them from device memory as a train
    # step does (one copy would stay in L2 from one replay to the next)
    def rotating(copies, fn):
        sets = itertools.cycle(copies)
        return lambda: fn(*next(sets))

    w, b = 1 + randn(d_tr, scale=0.1), randn(d_tr, scale=0.1)
    xs = [(randn(n_tr, d_tr),) for _ in range(8)]
    record("hadamard_affine", "hadamard_affine",
           f"x ({n_tr},{d_tr}) fp32 (8 copies in turn), fp32 w/b (one layer "
           "of a bert-base train step, hadamard_concat)", f32,
           rotating(xs, lambda x: ops.hadamard(x, w, b, impl="kernel")),
           rotating(xs, lambda x: ops.hadamard(x, w, b, impl="ref")),
           rotating(xs, lambda x: torch.addcmul(b, x, w)),
           2 * nbytes(xs[0][0]) + nbytes(w, b), 2 * xs[0][0].numel())
    gxs = [(randn(n_tr, d_tr), randn(n_tr, d_tr)) for _ in range(4)]
    record("hadamard_affine_bwd", "hadamard_affine_bwd",
           f"g, x ({n_tr},{d_tr}) fp32 (4 copies in turn), fp32 w (one layer "
           "of a bert-base train step's backward)", f32,
           rotating(gxs, lambda g, x: ops.hadamard_affine_bwd(
               g, x, w, impl="kernel")),
           rotating(gxs, lambda g, x: ops.hadamard_affine_bwd(
               g, x, w, impl="ref")),
           None,
           # read g, x, w; write dx, dw, db
           3 * nbytes(gxs[0][0]) + nbytes(w) + 2 * d_tr * 4,
           4 * gxs[0][0].numel())
    qkvs = [tuple(randn(B_tr, 12, S_tr, 64) for _ in range(3))
            for _ in range(3)]
    record("flash_attention@train", "flash_attention",
           f"q, k, v ({B_tr},12,{S_tr},64) fp32 (3 copies in turn) "
           "non-causal (one layer of a bert-base forward)", f32,
           rotating(qkvs, lambda q, k, v: ops.flash_attention(
               q, k, v, causal=False, impl="kernel")),
           rotating(qkvs, lambda q, k, v: ops.flash_attention(
               q, k, v, causal=False, impl="ref")),
           rotating(qkvs, F.scaled_dot_product_attention),
           4 * nbytes(qkvs[0][0]), 4 * B_tr * 12 * S_tr * S_tr * 64)
    xrs = [(randn(B_tr, S_tr, d_tr), randn(B_tr, S_tr, d_tr))
           for _ in range(4)]
    scale, bias = randn(d_tr), randn(d_tr)
    record("fused_adapter_norm@train", "fused_adapter_norm",
           f"x, res ({B_tr},{S_tr},{d_tr}) fp32 (4 copies in turn), "
           "LayerNorm (one layer of a bert-base forward, hadamard)", f32,
           rotating(xrs, lambda x, res: ops.fused_adapter_norm(
               x, res, w, b, scale, bias=bias, eps=1e-12, impl="kernel")),
           rotating(xrs, lambda x, res: ops.fused_adapter_norm(
               x, res, w, b, scale, bias=bias, eps=1e-12, impl="ref")),
           None, 4 * nbytes(xrs[0][0]) + nbytes(w, b, scale, bias),
           8 * xrs[0][0].numel())
    del xs, gxs, qkvs, xrs

    # -- phase 4: full-width model in fp32, kernel path vs plain path -------
    cfg32 = launcher.build_config(ARCH).replace(param_dtype="float32",
                                                compute_dtype="float32")
    for tasks in (0, TASKS):
        eng = launcher.build_engine(cfg32, seed=1, tasks=tasks, device=dev)
        toks = torch.randint(10, cfg32.vocab_size, (2, 64), generator=gen,
                             device=dev)
        tids = torch.tensor([0, TASKS - 1], dtype=torch.int32, device=dev) \
            if tasks else None
        with torch.no_grad():
            runs = {}
            for impl in ("auto", "ref"):
                lg, caches = M.prefill_lm(eng.params, cfg32, toks, 80,
                                          task_ids=tids, impl=impl)
                out = [lg]
                for i in range(4):
                    tok = torch.randint(10, cfg32.vocab_size, (2, 1),
                                        generator=torch.Generator(device=dev)
                                        .manual_seed(i), device=dev)
                    pos = torch.tensor([64 + i, 64 + i], device=dev)
                    lg, caches = M.decode_lm(eng.params, cfg32, caches, tok,
                                             pos, task_ids=tids, impl=impl)
                    out.append(lg)
                runs[impl] = out
        worst = 0.0
        for step, (a, r) in enumerate(zip(runs["auto"], runs["ref"])):
            check(a.shape == (2, 1, cfg32.vocab_size), f"logits shape {a.shape}")
            check(bool(torch.isfinite(a).all()), "non-finite logits")
            diff = (a - r).abs().max().item()
            tol = 1e-3 * r.abs().max().item()
            check(diff <= tol, f"fp32 model step {step} (tasks={tasks}): "
                               f"|kernel - plain| {diff:.3g} > {tol:.3g}")
            worst = max(worst, diff / r.abs().max().item())
        log(f"[4] qwen3-0.6b fp32, {cfg32.n_layers} layers, "
            f"{'bank of %d tasks' % tasks if tasks else 'single adapter'}: "
            f"prefill + 4 decode steps, kernel path vs plain path max "
            f"|diff| / max|ref| = {worst:.3g} (tol 1e-3)")
        del eng, caches, runs
        torch.cuda.empty_cache()

    def profile_calls(fn, n):
        """Where the time of a call goes: host wall ms per call (each ending
        in a device sync), the device's busy share of it, and the kernels
        that take the device time, from torch.profiler."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
            torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) * 1e3 / n
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
                torch.cuda.synchronize()
        # device-side events only: each kernel once (an aten op's entry
        # repeats the device time of the kernels it launched)
        dev_us, launches = {}, 0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                dev_us[e.key] = e.self_device_time_total / n
                launches += e.count
        busy_ms = sum(dev_us.values()) / 1e3
        top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:10]
        return {"ms": call_ms, "device_ms": busy_ms if dev_us else None,
                "device_busy_share": busy_ms / call_ms if dev_us else None,
                "device_kernels": launches / n,
                "top_device_us": [[k[:80], v] for k, v in top]}

    def count_per_call(eng):
        """Record each engine prefill's and decode step's own launches in
        the run that follows: wraps the two methods on this instance and
        returns {method: [launch-count change per call]}."""
        per_call = {"prefill": [], "decode_step": []}
        for name, calls in per_call.items():
            def wrapped(*a, _fn=getattr(eng, name), _calls=calls, **kw):
                before = _build.launch_counts()
                out = _fn(*a, **kw)
                after = _build.launch_counts()
                _calls.append({k: after[k] - before[k] for k in after})
                return out
            setattr(eng, name, wrapped)
        return per_call

    # -- phases 5-6: serving at full width, bf16 ----------------------------
    cfg = launcher.build_config(ARCH)
    launches = {}
    serve_reports = {}
    for phase, tasks in ((5, 0), (6, TASKS)):
        eng = launcher.build_engine(cfg, seed=SERVE["seed"], tasks=tasks,
                                    device=dev)
        reqs = launcher.make_requests(cfg, SERVE["requests"],
                                      SERVE["prompt_len"], SERVE["new_tokens"],
                                      tasks, SERVE["seed"])
        scfg = ServingConfig(num_slots=SERVE["num_slots"],
                             max_len=SERVE["max_len"])
        make_scheduler(eng, scfg).run(reqs[:2])  # warm-up: library init, caches
        sched = make_scheduler(eng, scfg)
        per_call = count_per_call(eng)
        torch.cuda.synchronize()
        _build.reset_launches()
        done, rep = sched.run(reqs)
        torch.cuda.synchronize()
        launches[phase] = _build.launch_counts()
        del eng.prefill, eng.decode_step  # back to the class's methods
        check(len(per_call["decode_step"]) == rep["ticks"],
              f"phase {phase}: {len(per_call['decode_step'])} decode steps "
              f"counted, {rep['ticks']} ticks reported")
        for k in launches[phase]:
            check(sum(c[k] for calls in per_call.values() for c in calls)
                  == launches[phase][k],
                  f"phase {phase}: {k} launched outside prefill and decode")
        # the distinct per-call counts of this run, e.g. [28] per tick
        per_tick = {k: sorted({c[k] for c in per_call["decode_step"]})
                    for k in launches[phase]}
        per_prefill = {k: sorted({c[k] for c in per_call["prefill"]})
                       for k in launches[phase]}
        check(len(done) == SERVE["requests"], f"phase {phase}: "
              f"{len(done)} completions")
        for c in done:
            check(len(c.tokens) == SERVE["new_tokens"]
                  and c.finish_reason == "length",
                  f"phase {phase}: request {c.request_id} retired with "
                  f"{len(c.tokens)} tokens ({c.finish_reason})")
            check(bool(((c.tokens >= 0) & (c.tokens < cfg.vocab_size)).all()),
                  f"phase {phase}: token ids out of range")
        check(all(bool(torch.isfinite(c["k"]).all() and torch.isfinite(c["v"]).all())
                  for c in sched.caches), f"phase {phase}: non-finite KV cache")
        need = (("fused_adapter_norm", "flash_attention", "paged_attention")
                if tasks == 0 else
                ("multitask_hadamard", "flash_attention", "paged_attention"))
        for k in need:
            check(launches[phase][k] > 0,
                  f"phase {phase}: kernel {k} never launched on the serve path")
        # the profile of a 4-slot decode tick
        slots = SERVE["num_slots"]
        caches = eng.init_slot_caches(slots, SERVE["max_len"])
        args = ([[11]] * slots, [140 + i for i in range(slots)])
        stids = [t % max(tasks, 1) for t in range(slots)]
        tick = profile_calls(
            lambda: eng.decode_step(caches, *args, task_ids=stids), 8)
        del caches
        serve_reports[phase] = dict(rep, launches_per_decode_tick=per_tick,
                                    launches_per_prefill=per_prefill,
                                    tick=tick)
        log(f"[{phase}] serve {'single-tenant' if tasks == 0 else f'{tasks}-task bank'}"
            f" on {smi}: {rep['requests']} requests / {rep['tokens']} tokens, "
            f"{rep['ticks']} ticks, {rep['requests_per_s']:.3f} req/s, "
            f"{rep['tokens_per_s']:.1f} tok/s, TTFT mean/p50/max "
            f"{rep['mean_ttft_s'] * 1e3:.1f}/{rep['ttft_p50_s'] * 1e3:.1f}/"
            f"{rep['ttft_max_s'] * 1e3:.1f} ms, token gap p50/max "
            f"{rep['tpot_p50_s'] * 1e3:.1f}/{rep['tpot_max_s'] * 1e3:.1f} ms, "
            f"host s in prefill/decode {rep['prefill_s']:.3f}/"
            f"{rep['decode_s']:.3f}; launches {launches[phase]}; "
            f"per decode tick {per_tick}; per prefill {per_prefill}; "
            f"decode tick {tick}")
        del eng, sched
        torch.cuda.empty_cache()

    # -- phase 7: full-width bert-base in fp32, kernel path vs plain path ---
    from repro_torch.common.types import OptimCfg, TrainCfg
    from repro_torch.configs import get as get_arch
    from repro_torch.core import peft
    from repro_torch.core.hadamard import perturb_adapters
    from repro_torch.data.synthetic import TASKS as GLUE, TaskData
    from repro_torch.train import loop
    from repro_torch.train.steps import (build_train_step, loss_and_grads,
                                         make_state)

    bert = get_arch(TRAIN["arch"])
    L = bert.n_layers
    data = TaskData(TRAIN["task"], bert.vocab_size, seq_len=S_tr,
                    seed=TRAIN["seed"])
    batch = loop.to_device(next(data.train_batches(1, B_tr, seed=0)), dev)
    for sname in ("hadamard", "hadamard_concat"):
        strat = peft.strategy(sname)
        cfg_s = peft.attach(bert, strat)
        params = perturb_adapters(
            M.init_params(torch.Generator(device=dev).manual_seed(1), cfg_s),
            seed=2, scale=0.2)
        runs = {}
        for impl in ("auto", "ref"):
            state = make_state(None, cfg_s, strat, OptimCfg(), params=params)
            loss, _, grads = loss_and_grads(cfg_s, state, batch, impl)
            with torch.no_grad():
                logits, _, _ = M.forward_encoder(state["params"], cfg_s,
                                                 batch["tokens"],
                                                 batch["type_ids"], impl=impl)
            runs[impl] = (logits, loss.item(), grads)
            del state
        (lg, loss_k, gk), (lr_, loss_r, gr) = runs["auto"], runs["ref"]
        check(lg.shape == (B_tr, bert.n_classes) and
              bool(torch.isfinite(lg).all()), f"phase 7 {sname}: logits "
              f"{tuple(lg.shape)}, finite {bool(torch.isfinite(lg).all())}")
        diff, top = (lg - lr_).abs().max().item(), lr_.abs().max().item()
        check(diff <= 1e-3 * top, f"phase 7 {sname}: |kernel - plain| logits "
              f"{diff:.3g} > 1e-3 x {top:.3g}")
        loss_rel = abs(loss_k - loss_r) / abs(loss_r)
        check(math.isfinite(loss_k) and loss_rel <= 1e-5,
              f"phase 7 {sname}: loss {loss_k} vs plain {loss_r}")
        want = {f"layers/{i}/{leaf}" for i in range(L)
                for leaf in ("adapter/w", "adapter/b", "ffn_norm/scale",
                             "ffn_norm/bias")}
        check(set(gk) == want == set(gr),
              f"phase 7 {sname}: trainable leaves {sorted(set(gk) ^ want)}")
        worst = 0.0
        for path in sorted(want):
            e = (gk[path] - gr[path]).abs().max().item()
            m = gr[path].abs().max().item()
            check(bool(torch.isfinite(gk[path]).all()) and e <= 1e-3 * m,
                  f"phase 7 {sname}: gradient {path} max abs err {e:.3g} > "
                  f"1e-3 x {m:.3g}")
            worst = max(worst, e / m)
        log(f"[7] {TRAIN['arch']} fp32, {L} layers, {sname}, one {B_tr}x{S_tr} "
            f"{TRAIN['task']} batch: kernel path vs plain path logits max "
            f"|diff| / max|ref| {diff / top:.3g} (tol 1e-3), loss {loss_k:.6f}"
            f" vs {loss_r:.6f} (rel {loss_rel:.3g}, tol 1e-5), {len(want)} "
            f"gradient leaves, worst max|diff| / max|ref| {worst:.3g} "
            f"(tol 1e-3)")
        del runs, params
    torch.cuda.empty_cache()

    # -- phase 8: two-stage training at full width, fp32 --------------------
    def count_loop_calls():
        """Wrap the train loop's step and eval builders for one run: each
        step function they build records, per call, its own change of the
        launch counts. Returns ({"train": [...], "eval": [...]}, one list of
        per-call dicts per built function, in build order), restore)."""
        runs = {"train": [], "eval": []}
        originals = (loop.build_train_step, loop.build_eval_step)

        def wrap(builder, built):
            def build(*a, **kw):
                fn, calls = builder(*a, **kw), []
                built.append(calls)

                def counted(*a2, **kw2):
                    before = _build.launch_counts()
                    out = fn(*a2, **kw2)
                    after = _build.launch_counts()
                    calls.append({k: after[k] - before[k] for k in after})
                    return out
                return counted
            return build

        loop.build_train_step = wrap(originals[0], runs["train"])
        loop.build_eval_step = wrap(originals[1], runs["eval"])

        def restore():
            loop.build_train_step, loop.build_eval_step = originals
        return runs, restore

    def per_call(counts):
        """A launch dict with every kernel, zero where not given."""
        return {k: counts.get(k, 0) for k in _build.LAUNCHES}

    flash, fused = "flash_attention", "fused_adapter_norm"
    aff, aff_bwd = "hadamard_affine", "hadamard_affine_bwd"
    # predicted launches per train step and per eval batch: the forward
    # runs #4 in every layer and the adapter's forward kernel (#3 at
    # attn_out, #1 at attn_concat); stage 1's backward reaches only the
    # head, stage 2's reaches every layer's adapter through #2
    want_step = {"stage1": per_call({flash: L}),
                 "hadamard": per_call({flash: L, fused: L, aff_bwd: L}),
                 "hadamard_concat": per_call({flash: L, aff: L, aff_bwd: L})}
    want_eval = {"stage1": per_call({flash: L}),
                 "hadamard": per_call({flash: L, fused: L}),
                 "hadamard_concat": per_call({flash: L, aff: L})}
    n_eval = 512 // B_tr  # TaskData's eval set, in whole batches
    metric = GLUE[TRAIN["task"]].metric
    tc = TrainCfg(optim=OptimCfg(lr=TRAIN["lr"], total_steps=TRAIN["steps"]),
                  steps=TRAIN["steps"], batch_size=B_tr, seq_len=S_tr,
                  log_every=10)

    def check_calls(phase, stage, calls, want, n):
        check(len(calls) == n, f"phase 8 {phase}: {len(calls)} {stage} "
                               f"calls counted, want {n}")
        for i, c in enumerate(calls):
            check(c == want, f"phase 8 {phase}: {stage} call {i} launched "
                             f"{c}, predicted {want}")

    def rates(hist):
        """Step rates of a stage from its history (each step timed to a
        device sync); the first step, which warms the caches, apart."""
        s = [h["step_s"] for h in hist[1:]]
        mean = sum(s) / len(s)
        return {"first_step_ms": hist[0]["step_s"] * 1e3,
                "host_ms_per_step": mean * 1e3, "steps_per_s": 1 / mean,
                "tokens_per_s": B_tr * S_tr / mean,
                "losses": [h["loss"] for h in hist]}

    def profile_steps(cfg_s, strat, params):
        """profile_calls of one train step of `strat` from `params`, on a
        fixed batch (a copy of the state: `params` stays as it was)."""
        state = make_state(None, cfg_s, strat, tc.optim, params=params)
        step = build_train_step(cfg_s, tc.optim)
        r = profile_calls(lambda: step(state, batch), 5)
        del state
        return r

    train_launches, train_report = {}, {}
    step_calls, eval_calls = {}, {}  # per stage: the per-call launch dicts
    for phase in ("train_hadamard", "train_concat"):
        calls, restore = count_loop_calls()
        torch.cuda.synchronize()
        _build.reset_launches()
        try:
            if phase == "train_hadamard":
                res = loop.two_stage_finetune(
                    TRAIN["seed"], bert, "hadamard", data, stage1=tc,
                    stage2=tc, metric=metric, device=dev, log=log)
            else:  # stage 2 alone from the same tuned head
                res = loop.run_stage2(bert, "hadamard_concat", data, tc,
                                      stage1_params, metric=metric,
                                      seed=TRAIN["seed"], log=log)
            torch.cuda.synchronize()
        finally:
            restore()
        train_launches[phase] = _build.launch_counts()
        stages = (("stage1", "hadamard") if phase == "train_hadamard"
                  else ("hadamard_concat",))
        check(len(calls["train"]) == len(stages) == len(calls["eval"]),
              f"phase 8 {phase}: {len(calls['train'])} train and "
              f"{len(calls['eval'])} eval step functions for {stages}")
        for stage, tcalls, ecalls in zip(stages, calls["train"],
                                         calls["eval"]):
            check_calls(phase, f"{stage} train step", tcalls,
                        want_step[stage], TRAIN["steps"])
            check_calls(phase, f"{stage} eval batch", ecalls,
                        want_eval[stage], n_eval)
            step_calls[stage], eval_calls[stage] = tcalls, ecalls
        for k, total in train_launches[phase].items():
            check(sum(c[k] for fn_calls in calls["train"] + calls["eval"]
                      for c in fn_calls) == total,
                  f"phase 8 {phase}: {k} launched outside train steps and "
                  "eval batches")
        stats = res["param_stats"]
        if TRAIN["arch"] == "bert-base":
            check((stats["trainable"], stats["total"]) == BERT_BASE_TRAINABLE,
                  f"phase 8 {phase}: trainable {stats['trainable']} of "
                  f"{stats['total']}, want {BERT_BASE_TRAINABLE}")
        hist = res["history"]
        rep = {"trainable": stats["trainable"], "total": stats["total"],
               "percent": stats["percent"], metric: res["final_metric"]}
        if phase == "train_hadamard":
            stage1_params = res["stage1_params"]
            cfg1 = peft.attach(bert, peft.strategy("classifier_only"))
            rep["stage1"] = dict(rates(hist["stage1"]),
                                 **{metric: res["stage1_metric"]})
            rep["stage1"]["profile"] = profile_steps(
                cfg1, peft.strategy("classifier_only"), stage1_params)
            hist2 = hist["stage2"]
        else:
            hist2 = hist
        rep["stage2"] = dict(rates(hist2), **{metric: res["final_metric"]})
        rep["stage2"]["profile"] = profile_steps(
            res["cfg"], peft.strategy(stages[-1]), res["params"])
        for st in ("stage1", "stage2"):
            if st in rep:
                check(all(math.isfinite(v) for v in rep[st]["losses"]),
                      f"phase 8 {phase}: non-finite {st} loss")
        train_report[phase] = rep
        log(f"[8] {phase} on {smi}: {TRAIN['arch']} {TRAIN['task']} fp32, "
            f"{TRAIN['steps']} steps per stage of {B_tr}x{S_tr} tokens; "
            f"trainable {stats['trainable']:,} of {stats['total']:,} "
            f"({stats['percent']:.4f}%); launches {train_launches[phase]}; "
            f"per train step and eval batch as predicted; {json.dumps(rep)}")
        del res
        torch.cuda.empty_cache()

    # -- phase 9: the kernels line ------------------------------------------
    csrc = "src/repro_torch/kernels/csrc/"
    meta = {
        "hadamard_affine": (csrc + "hadamard_affine.cu",
                            "src/repro/kernels/hadamard.py:69"),
        "hadamard_affine_bwd": (csrc + "hadamard_affine.cu",
                                "src/repro/kernels/hadamard.py:87"),
        "fused_adapter_norm": (csrc + "fused_adapter_norm.cu",
                               "src/repro/kernels/hadamard.py:159"),
        "flash_attention": (csrc + "flash_attention.cu",
                            "src/repro/kernels/attention.py:74"),
        "paged_attention": (csrc + "paged_attention.cu",
                            "src/repro/kernels/attention.py:194"),
        "multitask_hadamard": (csrc + "multitask_hadamard.cu",
                               "src/repro/kernels/multitask.py:26"),
    }
    by_phase = {"serve_single": launches[5], "serve_multitask": launches[6],
                **train_launches}
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "host_ms",
             "plain_host_ms", "library_host_ms", "bytes", "flops")
    kernels = []
    for name, (src, replaces) in meta.items():
        r = results[name]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            # every check failure has already exited; these all passed
            "check": "pass",
            "launches": sum(counts[name] for counts in by_phase.values()),
            "launches_by_phase": {p: counts[name]
                                  for p, counts in by_phase.items()},
            # distinct counts per call in the same runs
            "launches_per_decode_tick": {
                "serve_single": serve_reports[5]["launches_per_decode_tick"][name],
                "serve_multitask": serve_reports[6]["launches_per_decode_tick"][name]},
            "launches_per_prefill": {
                "serve_single": serve_reports[5]["launches_per_prefill"][name],
                "serve_multitask": serve_reports[6]["launches_per_prefill"][name]},
            "launches_per_train_step": {
                s: sorted({c[name] for c in calls})
                for s, calls in step_calls.items()},
            "launches_per_eval_batch": {
                s: sorted({c[name] for c in calls})
                for s, calls in eval_calls.items()},
            "max_abs_err": max(checks[name]["errs"]), "tol_fp32": TOL[name],
            "max_rel_err_bf16": max(checks[name]["rels"]),
            "tol_bf16_rel": BF16_TOL,
            **{k: r[k] for k in timed},
            "timed_shape": r["shape"],
        }
        if name + "@train" in results:
            t = results[name + "@train"]
            entry["train_shape_timing"] = dict(
                {k: t[k] for k in timed}, shape=t["shape"])
        if name in ("fused_adapter_norm", "flash_attention"):
            # the backward of the autograd Function around this kernel
            bwd = checks[name + "_bwd"]
            entry["bwd_max_abs_err"] = max(bwd["errs"])
            entry["bwd_max_rel_err_bf16"] = max(bwd["rels"])
        kernels.append(entry)
    serve = {("serve_single" if p == 5 else "serve_multitask"): {
        k: v for k, v in rep.items()
        if k not in ("launches_per_decode_tick", "launches_per_prefill")}
        for p, rep in serve_reports.items()}
    print(json.dumps({"kernels": kernels, "serve": serve,
                      "train": train_report, "card": smi}))
    print(smi)
    count = torch.cuda.device_count()
    check(count == 1, f"{count} CUDA devices visible, want the one it drove")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
