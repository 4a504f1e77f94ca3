#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU.

  python3 chip_smoke.py

Phases (any failed check exits non-zero; no phase catches its own failure):
  1. the card and its settings (TF32 off for fp32 matmuls);
  2. build every CUDA kernel from the sources in this checkout, and report
     each source's registers and spill bytes from ptxas (#3, #6 and #9,
     which hold their data in registers, must spill nothing);
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the serve and train paths give it, in fp32 and bf16 (the
     dequant matmul also with int8 and fp8 weights), with its time, the
     plain version's time and, where one exists, one PyTorch call's time
     (flash and paged attention, #4 and #5, L2-cold beside SDPA; #4's
     log-sum-exp output too; #5 bit-identical across two runs, and on
     rows whose queries see no key: kv_len 0, kv_len under Sq, windowed,
     int8, e4m3, each in a batch whose other rows see keys; over bf16,
     int8 and e4m3 pools at the verify shape, 4 slots x 5 queries, and at
     a 112-token extend, each timed beside its byte bound); the multitask
     kernel (#6) at the edges of the plan it shares with #9 (decode,
     rwkv6's seam, prefills, two requests, widths 1000 and 999, x off the
     16-byte grid, fp32/bf16 activations over fp32/bf16 banks), equal to
     its plain version byte for byte and across two runs, its C entry
     refusing plans that do not cover every element once, timed L2-cold at
     the decode, prefill and rwkv6 seam shapes with a trace of each (and
     L2-warm at decode); the
     backward of every autograd Function around a kernel against autograd
     through the plain forward (the attention backward tiled as JAX's, over
     several tiles, and its peak memory at S = 2048); the masked multitask
     kernel (#9)
     also over a shared-w bank and with gated-off rows that are not the
     identity; the WKV6 recurrence (#8) with its state in and out, at the
     rwkv6-1.6b decode and prefill shapes, ragged T and w with exact 0s
     and 1s; #3 and #9 at the edges of their plans (one warp or two a row,
     a short last block, widths past a row in registers, ragged widths,
     pointers off the 16-byte grid, fp32/bf16 parameter mixes, ids out of
     range); #1 and #2 at the edges of theirs (a last chunk of one row,
     widths 4000 and 4001, pointers off the 16-byte grid, g fp32 over x
     bf16); #1, #2, #3, #7, #8 and #9 bit-identical across two runs of
     every case, #7 also timed at the rwkv6 head's decode shape, #3 at the serve
     shape L2-cold and L2-warm, at rwkv6's seam and under the other plan of
     4 rows, beside F.rms_norm/F.layer_norm of x alone, and the plan each
     timed row ran (`split_plan`); first the launch floor, an in-place add
     on a one-element tensor, which every row of the kernels line carries
     (`floor_ms`), and for #3 and #9 a torch.profiler trace of a timed
     graph's replay (each kernel's span, and start to start) beside the
     floor's; then the four kernels of a qwen3-0.6b fine-tuning step at
     its shapes (16 x 128 tokens, bf16): #3 and its backward, #2 on the
     fp32 cotangent the norm VJP hands it and through HadamardAffine, #4
     causal over 16 heads on 8 with its log-sum-exp, #7 at M = 2048, each
     against its plain version and timed L2-cold (#4 beside SDPA, #3
     beside F.rms_norm of x alone); the recurrence's autograd Function
     (`WKV6`: #8 forward, the plain chunked backward) against autograd
     through the plain forward, dr, dk, dv, dw, du and ds0, at 4 rows of
     rwkv6-1.6b's train shape and a ragged T = 33 with w holding exact 0s
     and 1s, and #8 timed at the train shape (16, 32, 128, 64) fp32,
     L2-cold, beside its byte bound, with the plain backward's time there;
     then the kernels of an rwkv6-1.6b fine-tuning step at its shapes (16 x
     128 tokens of 2048, bf16): #3 at the seam with its LayerNorm and its
     backward, #2 on the fp32 cotangent the norm VJP hands it (and timed
     there, L2-cold), and #7 at the int8 head's training shape, x (2048,
     2048) @ (2048, 65536);
  4. the full-width qwen3-0.6b model (28 layers) in fp32: prefill and four
     decode steps through the kernels against the plain versions
     (impl="ref"), single adapter and a 3-task bank;
  4b. the same model int8-quantized: prefill and a decode step through the
     kernels (the dequant matmul in every projection) against the plain
     path, and, ungated, against the unquantized fp32 model;
  4c. the fp32 model over a 3-row hot-swap AdapterBank holding a pruned
     tenant (the paper-0.022 mask, 18 of 28 layers), a dense one and an
     unloaded row: prefill and four decode steps through #9 against the
     plain path, and against a static bank (#6) of the same tenants;
  4p. the fp32 model over a paged pool (fp32, bf16, int8 and e4m3 blocks):
     a 112-token extend after a shared page, two decode steps and a
     verify of 5 tokens through the kernels against the plain path; the
     paged decode equal to the contiguous one, the extend against a cold
     prefill, and speculative greedy tokens (self draft, k = 4) equal to
     plain greedy ones over the slot caches and over the pool;
  4r. the full-width rwkv6-1.6b model (24 layers) in fp32, one adapter, a
     3-task bank, a 3-row hot-swap bank (pruned, dense and unloaded rows)
     and an int8 trunk (the LM head alone quantized): a 128-token prefill
     and four decode steps through the kernels (120 #8 launches; 120 #3,
     #6 or #9; 5 #7) against the plain path, logits and states;
  5. single-tenant serving: ServeEngine + Scheduler, 8 requests, 4 slots,
     max_len 512, prompt 128, 32 new tokens, bf16;
  6. multi-tenant serving: the same traffic through a 3-task
     MultiTaskEngine, task ids round-robin;
  5q, 6q, 5f. the same two runs over an int8-quantized backbone, and the
     single-tenant one over fp8: 196 dequant-matmul launches (7 per layer)
     in every decode tick and every prefill, the weight bytes, the peak
     device memory against the bf16 engine's, and greedy-token agreement
     with the bf16 run;
  5p, 5pq, 5pf, 5s, 5sp, 6p. paged KV and speculative decoding: 8
     requests sharing a 96-token prefix (4 cold admissions, 2 whole-prompt
     hits, 2 prefix hits) in 16-token pages of bf16, int8 and e4m3, then
     self speculation (k = 4, budgets of 8 tokens) over the slot caches
     and over the pool, and
     a 3-task bank's pool: the admissions and the launches of every
     prefill, extend, decode or verify tick and draft call as predicted,
     the pool drained to 0 live blocks once the prefix cache is cleared,
     cold and whole-prompt hits equal to the contiguous scheduler's tokens;
  5a. observability and SLO admission control: 12 requests of 5p's shape
     overload a paged, self-drafting (k = 4) scheduler built with
     ServingConfig(slo=, admission=) and a MetricsRegistry, its monitor on
     a clock of one second a tick: the ladder walks prefix_fill_stop,
     spec_k=2, spec_k=1, spec_k=0, defer, shed in order, a submit while
     shedding raises AdmissionShedError at level 6, every request finishes
     (traces complete), shed 1, deferred ticks >= 1, level 0 after 20 idle
     ticks, no retrace; in bf16 the tokens' agreement with an unloaded run
     of plain greedy decoding (spec_k = 0) over the same pool is reported,
     in fp32 (4p's model) they must be equal; then phase 5's
     traffic with metrics on and off, one pair (host ms a
     tick and tok/s, their ratio reported), and the serve launcher
     in-process with JAX's obs and SLO flags: its JSON snapshot's series,
     the .prom text of the registry it returns (cumulative buckets), its
     JSONL events, and a 2-tick
     profile holding the repro.paged_attention and
     repro.fused_adapter_norm ranges and both sources' device kernels;
  6s. hot-swap serving, the launcher's lifecycle over the same traffic: 4
     tenants in an AdapterRegistry on disk (task0 and task2 pruned to
     paper-0.022 and published packed, task1 and task3 dense), a 3-row
     bank, task3 published mid-stream, task0 removed at the end; 28 #9
     launches (and no #6 or #3) in every decode tick and prefill, each
     resident row's gates equal to its tenant's mask;
  6w. the launcher's --share-w --prune-to 18 world: 4 pruned tenants with
     one shared w and a b each, from a bank that stores the w once;
  6rs. 6s's lifecycle over rwkv6-1.6b (task0, task2 pruned to 16 of 24
     layers): 24 #9 and 24 #8 launches in every decode tick and prefill,
     no #3, #6 or attention kernel;
  each serve phase also profiles a decode tick and a 128-token prefill,
     and fails if #7 or #8 ran in either and no __global__ function of its
     source shows device time;
  5r, 6r, 5rq. the traffic of 5 and 6 over rwkv6-1.6b in bf16, one
     adapter, a 3-task bank, and one adapter over an int8 trunk: 24 #8
     launches, and 24 #3 or #6, in every decode tick and prefill, no
     attention kernel; 5rq also one #7 (the LM head) and its engine bytes
     below 5r's by the head's saving;
  3g. #1, #4, #5, #6 and #9 at gemma2-27b's serve shapes against their
     plain versions, fp32 and bf16, and timed L2-cold in bf16: #1 at the
     post-norm seam of a 2-slot decode tick (2,1,4608) and of a 4160-token
     prefill; #4 over a 4160-token prompt, local (window 4096) and global,
     capped at 50 and scaled by 144^-0.5, beside SDPA uncapped; #5 over a
     4096-entry ring past its wrap (kv_lens the last write) and a 4352-token
     cache (the last write + 1), capped, bit-identical across two runs; #6
     and #9 (a gated-off row) at (4,1,4608) and (1,128,4608), equal to
     their plain versions byte for byte;
  4g. gemma2-27b in fp32 at full width, depth cut to 2 of its 23 (local,
     global) groups: a 4160-token prompt and 32 greedy tokens through the
     kernels against the plain path, over the slot caches and over a paged
     pool, logits within 1e-3 of max|ref|, tokens identical, the launches
     of every call (a prefill 4 #4 + 4 #1, a step 4 #5 + 4 #1);
  5g, 5gp. gemma2-27b at full width and depth in bf16 (54.5 GB), one
     adapter: 4 requests (prompts of 4160 and 128 tokens, 32 greedy tokens
     each) admitted mid-decode into 2 slots of 4352 tokens, over the slot
     caches (5g) and a pool of 16-token pages (5gp, every admission cold,
     the pool drained): 46 #1 and 46 #5 a decode tick, 46 #4 and 46 #1 a
     prefill; memory before the build and the build's peak; tok/s, TTFT,
     token gap, a tick's and a long prefill's profile; the prefill's last
     logits against the plain path within GEMMA["prefill_tol"], which two
     planted faults (the local layers' window dropped, every adapter's w
     30 % further from 1) must exceed; the serve launcher at gemma2-27b
     over the paged pool;
  6g, 6gs. the same model over a 3-task bank (#6) and a 3-row hot-swap
     bank holding two pruned tenants (#9, each resident row's gates its
     mask), 8 requests of 128 + 32 tokens on 4 slots: 46 #6 or #9 and 46
     #5 a tick, 46 #4 a prefill;
  3m. #3, #4 and #5 at deepseek-moe-16b's serve shapes against their
     plain versions, fp32 and bf16, timed L2-cold in bf16: #3 at the
     RMSNorm seam (4,1,2048) and (1,128,2048); #4 over a 128-token prompt
     with one query head a KV head (16/16) and with qwen3-moe-235b-a22b's
     64/4, beside SDPA; #5 over a (4,512,16,128) and a (4,512,4,128) slot
     cache, bit-identical across two runs, beside SDPA; #7 over int8 at
     every (K, N) that 5mq quantizes (2048x2048, 2048x10944, 10944x2048,
     2048x102400) at M 4 and 128, bit-identical across two runs; #6 and
     #9 at (4,1,2048) and #7 at each of those (K, N) at M 4 timed L2-cold
     (#7 beside torch._weight_int8pack_mm and the bf16 matmul);
  4m. deepseek-moe-16b in fp32 at full width, depth cut to the dense layer
     and 2 MoE layers: 4 prompts of 128 tokens and 32 greedy tokens
     through the kernels against the plain path, logits within 1e-3 of
     max|ref|, tokens identical, the same routes dropped on both paths,
     the launches of every call (3 #4 + 3 #3 a prefill, 3 #5 + 3 #3 a
     step), a planted top-(k-1) routing fault past the limit;
  5m, 6m, 5mq. deepseek-moe-16b at full width and depth in bf16 (32.8
     GB): phase 5's traffic admitted mid-decode (one request first, the
     rest after 2 ticks), one adapter (28 #5 + 28 #3 a tick, 28 #4 + 28
     #3 a prefill), a 3-task bank (#6) and an int8 backbone (116 #7 a
     call: the attention projections, the dense layer's MLP, the head;
     JAX's 12 quantized leaves, no expert among them); tok/s, a tick's
     and a prefill's profile, peak bytes, the share of routes dropped at
     decode and at prefill; two bf16 runs of an MoE layer the same bits
     with no host sync; on 4 prompts, the prefill's last logits against
     the plain path within MOE["prefill_tol"], which every adapter's w 30 %
     further from 1 must exceed, and the share of the plain path's routes
     that the kernel path takes at least MOE["route_share_min"], which
     top-(k-1) routing must miss; the serve launcher at deepseek-moe-16b;
  3rg. #3, #4, #5, #6, #7 and #9 at recurrentgemma-2b's serve shapes
     against their plain versions, fp32 and bf16, the same bits across two
     runs, timed L2-cold: #3 at d 2560 under both plans (split_row in bf16
     at a 2-slot tick and a 4160-token prefill, warp_row in fp32); #4 over
     a 4160-token prompt, window 2048, 10 query heads on one KV head of
     256, beside SDPA with the window's mask (the same function) and
     causal SDPA; #5 over a 2048-entry ring past its wrap, 10 rows on one
     KV head, beside SDPA with a key mask; #6 and #9 at (4,1,2560) and
     (1,128,2560); #7 at every (K, N) that 5rgq quantizes; then the
     RG-LRU's plain parts (the scan, the fp32 gate products, a tick's
     gate casts) timed alike;
  4rg. recurrentgemma-2b in fp32 at full width, depth cut to the first
     (rec, rec, attention) group and the (rec, rec) tail: a 2100-token
     prefill of 2 rows (the ring wraps) and 4 decode steps through the
     kernels against the plain path over one adapter, a 3-task bank and a
     hot-swap bank with a pruned tenant: logits and rec states within
     1e-3 of max|ref|, the launches of every call (a prefill 1 #4 + 5 of
     the seam's kernel, a step 1 #5 + 5);
  5rg. recurrentgemma-2b at full width and depth in bf16 (5.79 GB): 5g's
     traffic (prompts of 4160 and 128 tokens, 32 greedy tokens each,
     admitted mid-decode into 2 slots of 4352): 8 #5 + 26 #3 a tick, 8 #4
     + 26 #3 a prefill; tok/s, TTFT, token gap, a tick's and a long
     prefill's profile with the shares of #4, the scan and the gates;
     two bf16 runs of a rec layer the same bits with no host sync; the
     long prefills' last logits against the plain path within
     RGEMMA["prefill_tol"] (relative L2) and with the same top-1, which a
     planted fault (every rec layer's decay 30 % off) must exceed; the
     first prompt in fp32 on the same weights, kernel path against plain
     path within RGEMMA["fp32_tol"], which every adapter's w 30 % further
     from 1 must exceed; each bf16 path's distance from the plain fp32
     logits, the kernel path's within RGEMMA["witness_ratio"] x the plain
     path's; the serve launcher;
  6rg, 6rgs, 5rgq. the same model on SERVE's traffic through a 3-task
     bank (26 #6 a call), a 3-row hot-swap bank over tenants pruned to
     17 of 26 layers (26 #9, each resident row's gates its mask) and an
     int8 trunk (JAX's 19 leaves, 110 #7 a call, no rec projection);
  3wt. #4, #5, #3 and #2 at whisper-tiny's shapes against their plain
     versions, fp32 and bf16, the same bits twice, timed L2-cold in bf16:
     #4 non-causal over the encoder's 1500 frames (8,6,1500,64), the cross
     prefill (8,6,16|1500,64) and a decoder longer than the frames
     (1,6,2048|1500,64), beside SDPA; #5 over the 1500-frame cross cache
     in pages of 4 (kv_lens 1500 on every row) and over self-attention
     caches of 80, beside SDPA; #3 LayerNorm with bias at (8,1500,384) and
     (8,1,384), beside F.layer_norm of x alone; #4's backward at the cross
     prefill and #3's (its VJP, then #2) at 8wt's seams against autograd
     through the plain forward, #2 on the fp32 cotangent at (12000,384)
     timed;
  4wt. whisper-tiny in fp32 (TF32 off) at full width and depth, norms and
     q/k moved off their init: 4 clips, a prefill and 8 greedy decode
     steps through the kernels against the plain path (relative L2 within
     WHISPER["fp32_tol"], tokens equal, a prefill 12 #4 + 8 #3, a step 8
     #5 + 4 #3), which an encoder adapter fault and a seam normalised by
     ffn_norm in place of cross_norm must exceed;
  5wt. whisper-tiny bf16: 8 clips of 1500 seeded frames, 16-token
     prompts, 64 greedy tokens through prefill_encdec and decode_encdec
     (4 #5 self + 4 #5 cross + 4 #3 a tick, 12 #4 + 8 #3 a prefill), the
     plain path's tokens beside them, a tick's and a prefill's profile;
  8wt. encdec_loss fine-tuning of whisper-tiny, Hadamard, bf16, 8 clips x
     64 tokens, 6 steps: a fixed batch's loss falls, every trainable leaf
     (the encoder's too) moves, JAX's 12,288 trainable, 12 #4 + 8 #3 + 8
     #2 a step;
  3iv. #4 causal (2,64|8,384,128), #5 (2,64,128) over (2,416,8,128), #3
     RMSNorm at (2,1,8192) and (2,384,8192) and its backward and #2 at
     (768,8192), internvl2-76b's shapes, as 3wt;
  4iv. internvl2-76b in fp32 at full width and 2 of 80 layers: 2 x (256
     patches + 128 tokens), a prefill and 4 decode steps, kernel path vs
     plain path as 4wt, past which text RoPE positions restarted after
     the image must land;
  5iv, 8iv. internvl2-76b bf16 at full width and 8 of 80 layers (9.01 B
     parameters, 18.0 GB, built on the card from a seed): 2 x (256
     patches + 128 tokens), 32 greedy tokens (8 #5 + 8 #3 a tick, 8 #4 +
     8 #3 a prefill), reported as 5wt; then 2 lm_loss steps over the text
     positions (adapters move, 196,608 trainable, 8 #4 + 8 #3 + 8 #2 a
     step);
  3sc. #3 LayerNorm with its bias (split_row at d 4608, warp_row at
     3072), #4 causal (1,36|4,128,128) and (1,24|2,128,128) and #5 (4,36,128)
     over (4,512,4,128) and (4,24,128) over (4,512,2,128), starcoder2-7b's
     and -3b's serve shapes, as 3iv; #7 at every (K, N) of starcoder2-7b's,
     starcoder2-3b's, gemma2-27b's and internvl2-76b's quantized trunks
     (the untied heads and vlm_proj included) at M 4 and 128, fp32 and bf16
     x over int8 and e4m3 values, the same bits twice, each timed L2-cold
     at M 4;
  4sc. starcoder2-7b in fp32 at full width and 2 layers, biases moved off 0:
     2 x 128 tokens, a prefill and 4 decode steps, kernel path vs plain path
     within STARCODER["fp32_tol"], past which every adapter's w 30 % off
     and the attention biases dropped must land;
  5sc, 5scq. starcoder2-7b bf16 at full width and depth (14.8 GB): SERVE's
     traffic admitted mid-decode, 32 #5 + 32 #3 a tick and 32 #4 + 32 #3 a
     prefill (+ 193 #7 over 5scq's int8 trunk, JAX's 7 leaves); the plain
     path's tokens beside them, the prefill's last logits against the
     plain path beside planted faults, the launcher at starcoder2-3b;
  5gq. gemma2-27b over an int8 trunk at full depth, built leaf by leaf in
     place (the build's peak under 80 GB; JAX's 14 leaves): 8 x (128 +
     32) on 4 slots of 160, 46 #5 + 46 #1 + 322 #7 a tick; the prefill's
     last logits against the plain path beside a planted fault;
  5ivq. internvl2-76b at 8 of 80 layers over an int8 trunk (JAX's 9
     leaves, vlm_proj and the head among them) on 5iv's traffic: 57 #7 a
     tick, 58 a prefill;
  5o. qwen3-0.6b with fold=True: at fp32 (phase 4's model) greedy tokens
     equal to the unfolded engine's and each call's launches the same (#3
     on the identity adapter); bf16 and --fold --quant int8 agreement
     reported; the launcher with --static --fold and with --stream;
  7. the full-width bert-base encoder (12 layers) in fp32 on one batch of
     32x128 sst2 tokens with every adapter leaf perturbed: logits, stage-2
     loss and every trainable gradient through the kernels against the
     plain path, for the 'hadamard' (attn_out) and 'hadamard_concat'
     strategies and the LoRA, IA3 and Houlsby baselines, each training
     the leaves its patterns select;
  7m. one 'full' MLM step of bert-base (32x128 `mlm_batches` tokens):
     the loss and the gradient of every leaf, embeddings included, through
     the kernels against the plain path; the pooler, classifier and
     final_norm, which the MLM loss never reads, exactly zero;
  7d. the full-width qwen3-0.6b decoder in fp32 on one batch of 4x128
     `lm_batches` tokens with perturbed adapters: logits, lm_loss and every
     trainable gradient through the kernels against the plain path, over
     the plain trunk and an int8 one (#7 in every projection), the
     launches of the loss and its gradients as predicted; and with
     ce_chunk=32, the loss and gradients against the unchunked ones;
  7r. the full-width rwkv6-1.6b decoder in fp32 on one 4x128 batch with
     perturbed adapters, labels from position 32 on: logits, lm_loss and
     every trainable gradient through the kernels against the plain path
     (which differentiates the step-by-step recurrence), under the
     Hadamard adapter and Houlsby's bottlenecks, with JAX's trainable
     counts and the launches of the loss and its gradients as predicted;
     and a control, the recurrence's backward 10 % off, which the
     gradients' limit must catch;
  8. the paper's two-stage fine-tune of bert-base on sst2 (seq 128, batch
     32, 30 steps per stage) for 'hadamard', then stage 2 alone for
     'hadamard_concat': finite losses, the trainable count, the launches of
     every train step and eval batch counted inside those runs, step rates
     and a torch.profiler breakdown of a train step;
  8d. decoder-LM fine-tuning of qwen3-0.6b in bf16, 16x128 `lm_batches`
     tokens a step: 12 steps of 'hadamard' (the loss of one fixed batch
     falls, and every trainable leaf moves), 4 over an
     int8 trunk calibrated on 2 batches, 4 over fp8, 4 with microbatch=2,
     and a resume (6 steps saving at step 3; a fresh state restored from
     step 3 takes steps 4-6, held to the unbroken run): finite losses,
     the trainable count (86,016 of 596,107,264), the launches of every
     step as predicted, step rates, peak device bytes and a
     torch.profiler breakdown of a step;
  8p. the paper's own experiment over a pretrained bert-base, fp32, 32x128
     tokens a step: MLM pretraining of every leaf (its loss falls; host
     and device ms a step, peak bytes), stage 1 on sst2, stage 2 from that
     one stage-1 tree under hadamard, full, lora, ia3 and houlsby (Tables
     2-3), hadamard gated to the top 1, 6, 8 and 12 layers (Table 5: a
     gated-off layer's b stays exactly 0, an ungated one's moves), Table
     4's B+N and W+B+N, a two-stage hadamard run on cola and Fig. 5's
     cross-task cosines over the two tasks' adapters, and the sst2
     adapter's layer importance and a budgeted mask search by eval-only
     quality: every trainable count as JAX counts it, the launches of
     every train step and eval batch as predicted; quality is reported,
     not gated;
  8r. rwkv6-1.6b LM fine-tuning in bf16, 16x128 tokens a step: the
     Hadamard adapter for 6 steps (a fixed batch's loss falls, every
     trainable leaf moves), an int8 trunk (the head alone: one #7 a step)
     and compressed gradients over bf16 m + int8 v moments, 2 steps each:
     196,608 trainable, 24 #8, 24 #3 and 24 #2 launches every step, rates,
     peak bytes and a torch.profiler breakdown of a step;
  8q. launch.pretrain's path on bert-base (`full`, MLM, fp32, 6 steps a
     preset): fp32, bf16, bf16+int8 and int8 moments with error feedback,
     and int8 without: each state's bytes equal to state_summary's formula,
     bf16 2.0x, all-int8 no-EF >= 3x, bf16+int8's final loss within 1 % of
     fp32's, a bf16+int8 run resumed at step 3 bit for bit the unbroken
     one, 12 #4 and nothing else launched a step;
  9. one JSON line of per-kernel results (launch counts from phases 5-6rs,
     5p-6p, 5a, 5g-6gs, 5m-5mq, 5rg-5rgq, 5wt, 5iv, 5sc-5ivq,
     8, 8d, 8r, 8p, 8q, 8wt and 8iv, and each kernel's device us per decode
     tick and per prefill from the serve profiles);
  then the card's name and power limit, and the last line,
  {"ok": true, "device": {...}}. Each phase logs its seconds.


It needs a CUDA device and the repo's `src/` beside it, and imports no JAX.
The GPUs other than the first are hidden from it: it drives one card.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
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
RWKV_ARCH = "rwkv6-1.6b"
SERVE = dict(requests=8, num_slots=4, max_len=512, prompt_len=128,
             new_tokens=32, seed=0, spec_new_tokens=8)
TASKS = 3
# the paper's experiment: two-stage fine-tune of bert-base on sst2
TRAIN = dict(arch="bert-base", task="sst2", batch=32, seq=128, steps=30,
             lr=3e-3, seed=0)
# bert-base's stage-2 trainable count under 'hadamard' (adapter w and b
# plus the ffn-output LayerNorm of 12 layers), as the JAX package counts it
BERT_BASE_TRAINABLE = (36_864, 109_503_746)
# qwen3-0.6b's trainable count under 'hadamard' (adapter w and b, fp32, and
# the ffn-output RMSNorm scale, bf16, of 28 layers), as the JAX package
# counts it (jax.eval_shape of its init)
QWEN3_TRAINABLE = (86_016, 596_107_264)
# rwkv6-1.6b's trainable and total counts under 'hadamard' (adapter w and
# b, fp32, and the ffn-output LayerNorm of 24 layers) and 'houlsby' (both
# bottlenecks and both LayerNorms of every layer), as the JAX package
# counts them (jax.eval_shape of its init)
RWKV_TRAINABLE = {"hadamard": (196_608, 1_599_967_232),
                  "houlsby": (12_880_896, 1_612_553_216)}
# the paper's own experiment at bert-base's full width (phase 8p), fp32,
# TRAIN's 32 x 128 tokens a step: MLM pretraining, then the recipe's lanes
# over it; only the step counts are cut. Pretraining takes JAX's
# pretrain_encoder defaults (lr 1e-3, mask rate 0.15) but 24 steps of its
# 600, and each lane 8 steps, to keep the script inside its time limit
# (a 1000-step run on an H100 had its MLM loss at its plateau, near 9.5,
# by step 400; 300 steps reached 9.52, 100 steps 9.73), the lanes the
# learning rates of JAX's paper benchmarks (benchmarks/common.py: stage 1
# 3e-3, adapters 8e-3, full fine-tuning 3e-4, warmup a tenth of the steps)
PAPER = dict(pretrain_steps=24, pretrain_lr=1e-3, mask_rate=0.15, seed=0,
             steps=8, stage1_lr=3e-3, stage2_lr=8e-3, full_lr=3e-4,
             second_task="cola", table5_top=(1, 6, 8, 12),
             table4=("B+N", "W+B+N"), search_budget=0.01)
# each lane's trainable count at bert-base, then the total, as the JAX
# package counts them (jax.eval_shape of its init)
PAPER_COUNTS = {
    "classifier_only": (592_130, 109_485_314),
    "hadamard": (36_864, 109_503_746),
    "full": (109_485_314, 109_485_314),
    "lora": (887_042, 109_780_226),
    "ia3": (647_426, 109_540_610),
    "houlsby": (3_008_258, 111_864_578),
    "hadamard[B+N]": (27_648, 109_503_746),
    "hadamard[W+B+N]": (36_864, 109_503_746),
}
# decoder-LM fine-tuning of qwen3-0.6b in bf16 on the synthetic Markov
# corpus (`lm_corpus`, 200,000 tokens): steps of batch x seq tokens
LM_TRAIN = dict(batch=16, seq=128, lr=3e-3, seed=0, steps=12, quant_steps=4,
                microbatch_steps=4, resume_steps=6, save_every=3,
                calibrate_batches=2)
# launch.pretrain's path (phase 8q): MLM steps of bert-base a moment
# preset, on the paper's pretraining stream and rate; the bf16+int8 lane
# saves at resume_at and a fresh state resumes from there
PRETRAIN_Q = dict(steps=6, resume_at=3)
# rwkv6-1.6b's LM fine-tuning (phase 8r) on LM_TRAIN's batches and rate:
# the Hadamard lane's steps, then the int8-trunk and the compressed lanes'
RWKV_TRAIN = dict(steps=6, other_steps=2)
# gemma2-27b serving (phases 3g-6g): 4 requests, prompts of 4160 tokens
# (past the 4096-token window: every ring wraps at prefill and again at
# decode) and of 128, 32 greedy tokens each, on 2 slots of 4352 tokens; 4g
# cuts the depth to 2 of the 23 groups (fp32); 6g serves a bank, 8
# requests of 128 + 32 tokens on 4 slots. prefill_tol: the limit of the
# bf16 prefill's last logits, kernel path against plain path, set from an
# H100's readings (the kernel path 0.133 from the plain one; the plain
# path without the window 0.335, with every adapter's w 10 % off 0.164,
# too near to gate on, so the planted adapter fault is 30 %; PERF.md §6)
GEMMA = dict(arch="gemma2-27b", num_slots=2, max_len=4352, long_prompt=4160,
             new_tokens=32, seed=0, depth_groups=2, bank_prompt=128,
             bank_requests=8, bank_slots=4, bank_max_len=160,
             prefill_tol=0.25)
# deepseek-moe-16b serving (phases 3m-5mq) on SERVE's traffic: 4m cuts the
# depth to the dense layer and moe_layers_4m MoE layers (fp32); 3m also
# runs qwen3-moe-235b-a22b's attention shapes (its 470 GB fit no one
# card). quant_leaves: the leaves JAX's quantization table takes at
# deepseek-moe-16b (tests/test_torch_moe.py counts them from JAX's own
# tree). prefill_tol: the limit of the bf16 prefills' last logits, kernel
# path against plain path, over the first 4 requests' prompts, set from an
# H100's readings (the kernel path 0.0557-0.0625 from the plain one; every
# adapter's w 30 % off 0.1504 on the first prompt). route_share_min: the
# least share of the plain path's routes (every MoE layer's top-6 experts
# of every prompt token) that the kernel path must take; top-5 routing
# takes at most 5/6 of them. A top-5 fault moves the bf16 logits no more
# than bf16 noise does (0.0625-0.0723 against the kernel's 0.0557-0.0625),
# so the routes, not the logits, are what catch it (PERF.md section 6)
MOE = dict(arch="deepseek-moe-16b", attn_arch="qwen3-moe-235b-a22b",
           moe_layers_4m=2, quant_leaves=12, prefill_tol=0.1,
           route_share_min=0.9)
# recurrentgemma-2b serving (phases 3rg-5rgq): 5rg serves 5g's traffic (2
# prompts of 4160 tokens, past the 2048-token window, and 2 of 128, 32
# greedy tokens each, on 2 slots of 4352) at full depth in bf16; 4rg cuts
# the depth to the first (rec, rec, attention) group and the (rec, rec)
# tail in fp32, over a 2100-token prompt (the ring wraps) and 4 decode
# steps; 6rg, 6rgs and 5rgq serve SERVE's traffic through a 3-task bank, a
# hot-swap bank and an int8 trunk. n_params: the JAX package's count at
# full size under the Hadamard adapter (2,894,574,080 without it, as
# tests/test_torch_recurrent.py counts); quant_leaves: the leaves JAX's
# quantization table takes (the attention and MLP projections; no rec
# projection, no head: it is tied). prefill_tol: the limit of the relative
# L2 distance of the bf16 4160-token prefills' last logits, kernel path
# against plain path, set from an H100's readings (the kernel path
# 0.021-0.022; planted faults: every rec layer's decay 30 % off 0.056, 10 %
# off 0.036, every adapter's w 30 % further from 1 0.028; PERF.md section 6).
# fp32_tol: the limit of the same distance with the same weights in fp32
# (TF32 off), kernel path against plain path (an H100: 3.2e-6), which the
# adapter fault must exceed (0.0023); witness_ratio: how much further from
# the plain fp32 logits the bf16 kernel path's may lie than the plain bf16
# path's (0.0253 and 0.0255; the adapter fault's 0.0249: bf16 noise hides
# it there)
RGEMMA = dict(arch="recurrentgemma-2b", num_slots=2, max_len=4352,
              long_prompt=4160, new_tokens=32, seed=0, prompt_4rg=2100,
              steps_4rg=4, n_params=2_894_707_200, quant_leaves=19,
              prefill_tol=0.035, fp32_tol=1e-4, witness_ratio=1.25)


# whisper-tiny (phases 3wt-8wt) at full width and depth: 5wt generates 64
# greedy tokens after 16-token prompts for 8 clips of 1500 seeded frame
# embeddings into self-attention caches of 80; 4wt runs 4 clips and 8
# decode steps in fp32; 8wt takes 6 encdec_loss steps of 8 clips x 64
# tokens. internvl2-76b (phases 3iv-8iv) at full width and 8 of its 80
# layers (4iv: 2, in fp32): 2 requests of 256 seeded patch embeddings and
# 128 text tokens, 32 greedy tokens into caches of 416; 8iv 2 lm_loss
# steps over the text positions. n_params and trainable: the JAX
# package's counts at these depths under the Hadamard adapter
# (tests/test_torch_encdec.py and test_torch_vlm.py count the full sizes).
# fp32_tol: the limit of the relative L2 distance of each call's logits,
# kernel path against plain path, in fp32 with TF32 off; the planted
# faults (an encoder adapter's w 30 % off, the decoder seam normalised by
# ffn_norm in place of cross_norm; the text's RoPE positions restarted
# after the image) must exceed it
WHISPER = dict(arch="whisper-tiny", clips=8, prompt=16, new_tokens=64,
               cache_len=80, seed=0, clips_4wt=4, steps_4wt=8,
               train_steps=6, train_seq=64, fp32_tol=1e-4,
               n_params=49_646_976, trainable=12_288)
INTERNVL = dict(arch="internvl2-76b", layers=8, layers_4iv=2, requests=2,
                text=128, new_tokens=32, cache_len=416, seed=0, steps_4iv=4,
                train_steps=2, fp32_tol=1e-4, n_params=9_013_829_632,
                trainable=196_608)
# starcoder2-7b (phases 3sc-5scq) at full width and depth: 5sc serves
# SERVE's traffic in bf16, 5scq over an int8 trunk; 4sc cuts the depth to
# 2 layers in fp32 (2 prompts of 128 tokens, 4 decode steps); 3sc also
# runs starcoder2-3b's shapes, and 5sc its launcher. n_params: the JAX
# package's count under the Hadamard adapter; quant_leaves: the leaves
# JAX's quantization table takes (tests/test_torch_starcoder2.py).
# fp32_tol: 4sc's limit of the relative L2 distance of each call's
# logits, kernel path against plain path, which planted faults must
# exceed; prefill_tol: the limit of the relative L2 distance of 5sc's
# bf16 prefill's last logits, kernel path against plain path, set from an
# H100's readings (0.0164) beside planted faults (0.028, 0.041; PERF.md
# section 6)
STARCODER = dict(arch="starcoder2-7b", small="starcoder2-3b", seed=0,
                 layers_4sc=2, steps_4sc=4, n_params=7_400_711_168,
                 quant_leaves=7, fp32_tol=1e-4, prefill_tol=0.022)
# the int8 trunks of gemma2-27b at full depth (5gq, on 6g's short
# traffic; its build's peak under build_peak_max) and internvl2-76b at
# 5iv's 8 layers (5ivq). *_leaves: the leaves JAX's quantization table
# takes (tests/test_torch_quant_build.py); dq_shapes: the (K, N) of every
# projection that 5scq, 5gq and 5ivq quantize (wq, wk and wv, wo, the
# MLP's in and out, the untied heads; internvl2's vlm_proj is (8192,
# 8192), wq's), which 3sc holds; gemma_prefill_tol (max |diff|) and
# internvl_prefill_tol (relative L2): the limits of the int8 prefills'
# last logits, kernel path against plain path, set from an H100's
# readings (0.150; 0.026) beside the planted adapter fault (0.312; 0.208)
QUANT_TRUNKS = dict(
    build_peak_max=80e9, gemma_leaves=14, internvl_leaves=9,
    gemma_prefill_tol=0.25, internvl_prefill_tol=0.05,
    dq_shapes=(
        ("starcoder2-7b", "starcoder2_7b",
         ((4608, 4608), (4608, 512), (4608, 18432), (18432, 4608),
          (4608, 49152))),
        ("starcoder2-3b", "starcoder2_3b",
         ((3072, 3072), (3072, 256), (3072, 12288), (12288, 3072),
          (3072, 49152))),
        ("gemma2-27b", "gemma2",
         ((4608, 4096), (4608, 2048), (4096, 4608), (4608, 36864),
          (36864, 4608))),
        ("internvl2-76b", "internvl2",
         ((8192, 8192), (8192, 1024), (8192, 28672), (28672, 8192),
          (8192, 128256)))))


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

    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels import _build, hadamard, ops, ref
    from repro_torch.kernels.attention import FlashAttention, paged_split_plan
    from repro_torch.kernels._build import aligned16
    from repro_torch.kernels.hadamard import (MAX_D, FusedAdapterResidualNorm,
                                              HadamardAffine, affine_bwd_plan,
                                              affine_plan, fused_norm_plan)
    from repro_torch.kernels.quant import DequantMatmul, dequant_matmul_plan
    from repro_torch.kernels.rwkv6 import wkv6_plan
    from repro_torch.kernels.sparse import MaskedMultitaskHadamard, masked_plan
    from repro_torch.launch import serve as launcher
    from repro_torch.models import model as M
    from repro_torch.quant import quant_summary
    from repro_torch.serving import ServeEngine, ServingConfig, make_scheduler

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_s = {}
    clock = [time.perf_counter()]

    def phase_done(tag):
        """Log and keep the seconds since the previous phase ended."""
        now = time.perf_counter()
        phase_s[tag] = now - clock[0]
        clock[0] = now
        log(f"[{tag}] phase took {phase_s[tag]:.1f} s")

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
    # the port's kernels by name, for the profiles (PyTorch's own kernels
    # live in anonymous namespaces too), and by source: #7 and #8 launch one
    # of several __global__ functions by plan
    source_kernels = {p.name: set(re.findall(
        r"__global__\s+void\s+(?:__\w+__\([^)]*\)\s*)*(\w+)\s*\(",
        p.read_text())) for p in _build.sources()}
    port_kernels = set().union(*source_kernels.values())
    # each wrapper's counter and the __global__ functions one of its calls
    # launches first (one a call: #5's combine follows the kernel named
    # here; #2 sums across its blocks inside its one launch), so a
    # profile's raw events can be counted against the counters
    entry_kernels = {
        "hadamard_affine": {"affine_fwd_kernel"},
        "hadamard_affine_bwd": {"affine_bwd_kernel"},
        "fused_adapter_norm": source_kernels["fused_adapter_norm.cu"],
        "flash_attention": source_kernels["flash_attention.cu"],
        "paged_attention": {"paged_split_kernel"},
        "multitask_hadamard": source_kernels["multitask_hadamard.cu"],
        "dequant_matmul": source_kernels["dequant_matmul.cu"],
        "masked_multitask_hadamard":
            source_kernels["masked_multitask_hadamard.cu"],
        "wkv6": source_kernels["wkv6.cu"]}
    check(set(entry_kernels) == set(_build.launch_counts()) and all(
        v and v <= port_kernels for v in entry_kernels.values()),
        f"phase 2: entry kernels {entry_kernels} against the counters "
        f"{sorted(_build.launch_counts())} and the sources' {port_kernels}")
    log(f"[2] built {len(_build.sources())} CUDA sources in "
        f"{time.perf_counter() - t0:.1f} s")
    # each source's kernel instances, their most registers and their spill
    # bytes, from ptxas's report (nvcc -Xptxas -v) kept beside the library
    ptxas = {}
    for src in _build.sources():
        if src.suffix == ".cu":
            text = (_build.build_dir() / (src.stem + ".log")).read_text()
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
            spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                text)
            ptxas[src.name] = dict(instances=len(regs),
                                   max_registers=max(regs, default=0),
                                   spill_bytes=sum(int(a) + int(b)
                                                   for a, b in spills))
    for src in ("fused_adapter_norm.cu", "masked_multitask_hadamard.cu",
                "multitask_hadamard.cu"):
        check(ptxas[src]["instances"] > 0 and ptxas[src]["spill_bytes"] == 0,
              f"{src}: ptxas {ptxas[src]}, want instances and no spill bytes")
    log(f"[2] ptxas per source: {ptxas}")
    phase_done("1-2")

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def graph_of(fn, iters):
        """A CUDA graph of `iters` calls of fn, captured after warm-up calls
        on a side stream, replayed once."""
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
        return graph

    def time_ms(fn, iters=20, reps=10):
        """(device ms per call, host ms per call). The device time comes
        from replays of a CUDA graph of `iters` calls, so it holds no host
        launch cost; the host time is the same calls made eagerly, what a
        Python caller pays per call where the host is the limit, over at
        most 200 calls (a graph over thousands of L2-cold copies of a
        decode's inputs needs no more for the host's mean, and the host
        set the script's time: PERF.md section 6)."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        n_eager = min(iters * reps, 200)
        start.record()
        for _ in range(n_eager):
            fn()
        end.record()
        end.synchronize()
        eager = start.elapsed_time(end) / n_eager
        graph = graph_of(fn, iters)
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
    # reference's max abs, since the kernel sums in another order; a matmul
    # (REL_TOL) to its tolerance times its reference's max abs, since its
    # sums of K products run in another order too. bf16: each output
    # within BF16_TOL of its own reference's max abs.
    TOL = {"fused_adapter_norm": 1e-5, "flash_attention": 1e-4,
           "paged_attention": 1e-4, "multitask_hadamard": 1e-5,
           "hadamard_affine": 1e-5, "hadamard_affine_bwd": 1e-5,
           "fused_adapter_norm_bwd": 1e-5, "flash_attention_bwd": 1e-4,
           "dequant_matmul": 1e-5, "dequant_matmul_bwd": 1e-5,
           "masked_multitask_hadamard": 1e-5,
           "masked_multitask_hadamard_bwd": 1e-5, "wkv6": 1e-5,
           "wkv6_bwd": 1e-5}
    REL_TOL = ("dequant_matmul", "dequant_matmul_bwd", "wkv6", "wkv6_bwd")
    SUM_TOL, BF16_TOL = 1e-5, 2e-2
    # errs: fp32 max abs err of the elementwise outputs, per case; rel_errs:
    # the same over max |ref| (REL_TOL kernels); rels: bf16 worst max abs
    # err / max |ref| over the outputs, per case
    checks = {name: {"errs": [], "rel_errs": [], "rels": [], "summed": False}
              for name in TOL}

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
        worst = worst_rel = 0.0
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
            elif name in REL_TOL:
                tol = TOL[name] * m
                worst = max(worst, e)
                worst_rel = max(worst_rel, e / max(m, 1e-30))
            else:
                tol = TOL[name]
                worst = max(worst, e)
            check(e <= tol, f"{name} {case} {dtype}: output {i} max abs err "
                            f"{e:.3g} > tol {tol:.3g} (max|ref| {m:.3g})")
        key = "errs" if dtype == torch.float32 else "rels"
        checks[name][key].append(worst)
        if dtype == torch.float32 and name in REL_TOL:
            checks[name]["rel_errs"].append(worst_rel)

    def errors(name):
        """The worst errors of a kernel's checks, for the log."""
        c = checks[name]
        summed = (f"; outputs summed over rows within {SUM_TOL} of their "
                  "max|ref|") if c["summed"] else ""
        fp32 = (f"fp32 max abs err {max(c['errs']):.3g}, / max|ref| "
                f"{max(c['rel_errs']):.3g} (tol {TOL[name]} x max|ref|"
                if name in REL_TOL else
                f"fp32 max abs err {max(c['errs']):.3g} (tol {TOL[name]}")
        return (f"{fp32}{summed}), bf16 worst max abs err / max|ref| per "
                f"output {max(c['rels']):.3g} (tol {BF16_TOL})")

    results = {}

    def record(key, name, shape, dtype, kernel_fn, plain_fn, library_fn,
               bytes_, flops, yardstick_fn=None, iters=20, reps=10):
        """Time kernel, plain version and library call at one shape of the
        serve or train path (and, given one, a yardstick that computes
        something else); the bound is the larger of bytes over the memory
        rate and flops over the peak of `dtype`, the type of the timed
        inputs. iters: calls per CUDA graph (see time_ms)."""
        ms, host_ms = time_ms(kernel_fn, iters, reps)
        plain_ms, plain_host_ms = time_ms(plain_fn, iters, reps)
        lib_ms = lib_host_ms = None
        if library_fn is not None:
            lib_ms, lib_host_ms = time_ms(library_fn, iters, reps)
        yard = {}
        if yardstick_fn is not None:
            yard = dict(zip(("yardstick_ms", "yardstick_host_ms"),
                            time_ms(yardstick_fn, iters, reps)))
        t_mem = bytes_ / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[str(dtype).removeprefix("torch.")]
        r = dict(shape=shape, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                 host_ms=host_ms, plain_host_ms=plain_host_ms,
                 library_host_ms=lib_host_ms, bytes=bytes_, flops=flops,
                 bound_ms=max(t_mem, t_ops) * 1e3,
                 bound_by="bytes" if t_mem >= t_ops else "operations", **yard)
        results[key] = r
        log(f"[3] {name}: {errors(name)}; {shape}: device ms kernel {ms:.5f}, plain {plain_ms:.5f}, "
            f"library {lib_ms}, yardstick {yard.get('yardstick_ms')}, "
            f"bound {r['bound_ms']:.6f} ({r['bound_by']}); "
            f"host ms per eager call kernel {host_ms:.5f}, plain "
            f"{plain_host_ms:.5f}; on {smi}")

    def rotating(copies, fn):
        """fn over the next of `copies` at every call."""
        sets = itertools.cycle(copies)
        return lambda: fn(*next(sets))

    # -- phase 3: each kernel against its plain version ---------------------
    d = 1024
    bf, f32 = torch.bfloat16, torch.float32
    # the launch floor: the smallest PyTorch kernel, an in-place add on a
    # one-element tensor, in the same harness. A kernel whose bytes take
    # nanoseconds is judged against it, not against its byte bound
    one = torch.zeros(1, device=dev)
    floor_ms = time_ms(lambda: one.add_(1.0))[0]

    def trace_graph(fn, iters):
        """Where a timed call's time goes: torch.profiler over one replay of
        a CUDA graph of `iters` calls of fn, one kernel each: their mean
        device span and the mean time from one's start to the next's, in
        us. The profiler adds to both: compare with the floor's, traced
        alike."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        graph = graph_of(fn, iters)
        # the profiler may drop an event of thousands (3 of a 20-call
        # replay once), so a trace short of 90 % of the calls is
        # taken again, up to 3 times, as profile_calls retakes its
        # profiles; the means are over the kernels it saw
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                graph.replay()
                torch.cuda.synchronize()
            spans = sorted((e.start_ns() / 1e3, e.end_ns() / 1e3)
                           for e in prof.profiler.kineto_results.events()
                           if e.device_type() == DeviceType.CUDA)
            if 0.9 * iters <= len(spans) <= iters:
                break
        check(0.9 * iters <= len(spans) <= iters, f"trace: {len(spans)} "
              f"kernels in the replay of a graph of {iters} calls")
        return dict(kernel_span_us=sum(e - s for s, e in spans) / len(spans),
                    start_to_start_us=(spans[-1][0] - spans[0][0])
                    / (len(spans) - 1), kernels_seen=len(spans))

    floor_trace = trace_graph(lambda: one.add_(1.0), 200)
    log(f"[3] launch floor: {floor_ms:.5f} device ms per call (an in-place "
        f"add on a one-element tensor; traced: a {floor_trace['kernel_span_us']:.3f} "
        f"us span, {floor_trace['start_to_start_us']:.3f} us start to start) "
        f"on {smi}")

    def offset_view(*shape, dtype):
        """A contiguous tensor whose data starts one element past an
        allocation: no 16-byte access lines up with it."""
        return randn(math.prod(shape) + 1, dtype=dtype)[1:].view(*shape)

    def ids_of(*rows):
        return torch.tensor(rows, dtype=torch.int32, device=dev)

    # #3 fused adapter-residual-norm against its plain version at the
    # edges of `fused_norm_plan`: warp_row on 1 warp a row (768, 1024) and
    # on 2 (2048), one row and a row count that is not a multiple of the
    # rows a block takes (4099 at 4 a block); split_row at widths over
    # 4096 (up to MAX_D) and at a ragged one (4000: no whole 16-byte
    # vectors a lane); x and res one element off the 16-byte grid (vec =
    # 1); w, b, scale and bias in fp32/bf16 mixes; RMSNorm (eps 1e-6),
    # rwkv6's LayerNorm (1e-5) and bert's (1e-12). Two calls on the same
    # inputs give the same bytes
    fan_cases = [dict(rows=r, d=wd) for r, wd in (
        (4, d), (128, d), (1000, d), (7, 4000), (1, 768), (4099, 768),
        (13, 2048), (1, 2048), (3, 5000), (2, MAX_D))]
    fan_cases += [dict(rows=5, d=wd, mix=mix) for wd in (768, d, 2048)
                  for mix in ((bf, f32, f32, bf), (f32, bf, bf, f32))]
    fan_cases += [dict(rows=4, d=wd, offset=True) for wd in (d, 2048)]
    fan_plans, fan_repeats = set(), 0
    for dt in (f32, bf):
        for c in fan_cases:
            rows, width = c["rows"], c["d"]
            mk = functools.partial(offset_view if c.get("offset") else randn,
                                   rows, width, dtype=dt)
            x, res = mk(), mk()
            wdt, bdt, sdt, cdt = c.get("mix", (f32, f32, dt, dt))
            w = (1 + randn(width, scale=0.1)).to(wdt)
            b = randn(width, scale=0.1).to(bdt)
            scale, bias = randn(width, dtype=sdt), randn(width, dtype=cdt)
            plan = fused_norm_plan(rows, width, dt, aligned16(x, res, w, b,
                                                              scale, bias))
            fan_plans.add((plan["kernel"], plan["vec"] > 1,
                           plan["warps_per_row"] if plan["kernel"] == "warp_row"
                           else None, rows % plan["rows_per_block"] != 0))
            extra = {k: v for k, v in c.items() if k not in ("rows", "d")}
            for bi, eps in ((None, 1e-6), (bias, 1e-5), (bias, 1e-12)):
                kw = dict(bias=bi, eps=eps)
                case = (f"rows={rows} d={width} ln={bi is not None} eps={eps} "
                        f"{extra} plan={plan}")
                compare("fused_adapter_norm", case, dt,
                        lambda: ops.fused_adapter_norm(x, res, w, b, scale,
                                                       impl="kernel", **kw),
                        lambda: ops.fused_adapter_norm(x, res, w, b, scale,
                                                       impl="ref", **kw))
                (xn1, h1), (xn2, h2) = (ops.fused_adapter_norm(
                    x, res, w, b, scale, impl="kernel", **kw) for _ in range(2))
                check(torch.equal(xn1, xn2) and torch.equal(h1, h2),
                      f"fused_adapter_norm {case} {dt}: two runs differ")
                fan_repeats += 1
    for want in (("warp_row", True, 1, False), ("warp_row", True, 2, False),
                 ("warp_row", True, 1, True), ("split_row", True, None, False),
                 ("split_row", False, None, False)):
        check(want in fan_plans, f"fused_adapter_norm: no case ran the plan "
                                 f"{want} (kernel, vec > 1, warps a row, a "
                                 f"last block short of rows); ran {fan_plans}")
    # timed L2-cold at the serve shape (4, 1, 1024) bf16, fp32 w/b, RMSNorm,
    # and at rwkv6's seam (4, 1, 2048) bf16, LayerNorm with bf16 scale and
    # bias: each call of the timed graph takes its own copy of x and res,
    # the copies together twice the 50 MB L2. Beside them: the serve shape
    # L2-warm (one copy, as PRs 11-17 timed it), the other plan of 4 rows
    # (one block for all of them, where the plan gives each row its own),
    # and the yardstick, F.rms_norm or F.layer_norm of x alone: a norm that
    # reads one tensor and writes one, less work than #3, not a twin
    fan_note = ("none: rms_norm/layer_norm take no adapter affine or residual; "
                "the yardstick is F.rms_norm (serve) or F.layer_norm (rwkv "
                "seam, train) of x alone, which reads one tensor and writes one")
    for key, width, ln, eps in (("fused_adapter_norm", d, False, 1e-6),
                                ("fused_adapter_norm@rwkv", 2048, True, 1e-5)):
        rows = SERVE["num_slots"]
        xrs = [(randn(rows, 1, width, dtype=bf), randn(rows, 1, width, dtype=bf))
               for _ in range(-(-100 * 2**20 // (2 * rows * width * 2)))]
        w, b = 1 + randn(width, scale=0.1), randn(width, scale=0.1)
        scale = randn(width, dtype=bf)
        bias = randn(width, dtype=bf) if ln else None
        x = xrs[0][0]
        plan = fused_norm_plan(rows, width, bf)
        one_block = dict(plan, rows_per_block=rows, blocks=1)

        def fan(x_, res_, impl="kernel", plan=None):
            if plan is not None:
                return hadamard.fused_adapter_residual_norm(
                    x_, res_, w, b, scale, bias=bias, eps=eps, plan=plan)
            return ops.fused_adapter_norm(x_, res_, w, b, scale, bias=bias,
                                          eps=eps, impl=impl)

        def yard(x_, res_):
            if ln:
                return F.layer_norm(x_, (width,), scale, bias, eps)
            return F.rms_norm(x_, (width,), scale, eps)

        record(key, "fused_adapter_norm",
               f"x,res ({rows},1,{width}) bf16 ({len(xrs)} copies in turn), "
               f"fp32 w/b, bf16 scale{'/bias, LayerNorm' if ln else ', RMSNorm'}"
               f" (one layer of a 4-slot {'rwkv6 ' if ln else ''}decode tick; "
               f"{plan['kernel']}, {plan['warps_per_row']} warp(s) a row, "
               f"{plan['blocks']} blocks)", bf,
               rotating(xrs, fan), rotating(xrs, functools.partial(fan, impl="ref")),
               None, nbytes(x, x, w, b, scale, bias) + 2 * nbytes(x),
               8 * x.numel(), yardstick_fn=rotating(xrs, yard),
               iters=len(xrs), reps=2)
        x_, res_ = xrs[0]
        results[key].update(
            trace=trace_graph(rotating(xrs, fan), len(xrs)),
            ms_l2_warm=time_ms(lambda: fan(x_, res_))[0],
            alt_plan=dict(plan=one_block,
                          ms=time_ms(rotating(xrs, functools.partial(
                              fan, plan=one_block)), len(xrs), 2)[0],
                          ms_l2_warm=time_ms(lambda: fan(x_, res_,
                                                         plan=one_block))[0]),
            library_note=fan_note, split_plan=plan,
            bit_identical_repeats=fan_repeats)
        log(f"[3] {key}: L2-warm {results[key]['ms_l2_warm']:.5f} ms; one "
            f"block for the {rows} rows {results[key]['alt_plan']['ms']:.5f} "
            f"L2-cold, {results[key]['alt_plan']['ms_l2_warm']:.5f} L2-warm; "
            f"floor {floor_ms:.5f}; traced L2-cold {results[key]['trace']}")
        del xrs

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
                      cap=c.get("cap", 0.0), return_lse=True)
            # the output and each row's log-sum-exp (the backward's residual)
            compare("flash_attention", str(c), dt,
                    lambda: ops.flash_attention(q, k, v, impl="kernel", **kw),
                    lambda: ops.flash_attention(q, k, v, impl="ref", **kw))
    # timed L2-cold at the serve prefill shape: each call of the timed graph
    # takes its own copy of q, k, v, the copies together over twice the
    # 50 MB L2, as a prefill finds them after the other layers' weights
    S = SERVE["prompt_len"]
    per_copy = 2 * (16 + 8 + 8) * S * 128
    qkvs = [(randn(1, 16, S, 128, dtype=bf), randn(1, 8, S, 128, dtype=bf),
             randn(1, 8, S, 128, dtype=bf))
            for _ in range(-(-100 * 2**20 // per_copy))]
    q, k, v = qkvs[0]
    record("flash_attention", "flash_attention",
           f"q (1,16,{S},128) over k/v (1,8,{S},128) bf16 causal "
           f"({len(qkvs)} copies in turn; one layer of a prefill)", bf,
           rotating(qkvs, lambda q_, k_, v_: ops.flash_attention(
               q_, k_, v_, impl="kernel")),
           rotating(qkvs, lambda q_, k_, v_: ops.flash_attention(
               q_, k_, v_, impl="ref")),
           rotating(qkvs, lambda q_, k_, v_: F.scaled_dot_product_attention(
               q_, k_, v_, is_causal=True, enable_gqa=True)),
           2 * nbytes(q) + nbytes(k, v), 4 * 16 * 128 * (S * (S + 1) // 2),
           iters=len(qkvs), reps=3)
    results["flash_attention"]["library_note"] = (
        "torch.nn.functional.scaled_dot_product_attention(is_causal=True, "
        "enable_gqa=True)")
    del qkvs

    # #5 paged decode attention: 16 heads over 8, D=128, page 16
    page, nbt, B = 16, 32, 6
    nb = B * nbt + 1
    tables = (torch.randperm(nb - 1, generator=gen, device=dev)[:B * nbt] + 1
              ).to(torch.int32).reshape(B, nbt)
    lens = torch.tensor([1, 17, 129, 300, 511, 512], dtype=torch.int32,
                        device=dev)
    pcases = [dict(), dict(window=100), dict(int8=True), dict(sq=5),
              dict(sq=5, window=100), dict(cap=30.0), dict(int8=True, sq=5)]
    # rows whose queries see no key, to which the kernel gives the plain
    # version's (and the Pallas kernel's) mean of V over the row's table:
    # kv_len 0 (every query of the row), kv_len 1 and 2 under Sq = 3 (the
    # queries before the first key), a ring of 100 at kv_len 0 and 1, a
    # ring of 2 slots under 3 queries (the first query of every row), int8
    # pools, a soft cap; the batch's other rows see keys
    keyless_lens = torch.tensor([0, 1, 2, 129, 300, 512], dtype=torch.int32,
                                device=dev)
    pcases += [dict(keyless=True), dict(sq=3, keyless=True),
               dict(sq=3, window=100, keyless=True),
               dict(sq=3, window=2, keyless=True),
               dict(int8=True, keyless=True),
               dict(int8=True, sq=3, keyless=True),
               dict(int8=True, sq=3, window=2, keyless=True),
               dict(sq=3, cap=30.0, keyless=True)]
    # e4m3 pools (--kv-quant fp8): linear, windowed, the verify's Sq = 5,
    # and key-less rows
    pcases += [dict(fp8=True), dict(fp8=True, window=100),
               dict(fp8=True, sq=5), dict(fp8=True, keyless=True),
               dict(fp8=True, sq=3, keyless=True),
               dict(fp8=True, sq=3, window=2, keyless=True)]
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
            elif c.get("fp8"):
                kp = (randn(nb, page, 8, 128) * 64).to(torch.float8_e4m3fn)
                vp = (randn(nb, page, 8, 128) * 64).to(torch.float8_e4m3fn)
                kw.update(k_scales=randn(nb, page, 8, 1).abs() * 0.01,
                          v_scales=randn(nb, page, 8, 1).abs() * 0.01)
            else:
                kp = randn(nb, page, 8, 128, dtype=dt)
                vp = randn(nb, page, 8, 128, dtype=dt)
            kl = keyless_lens if c.get("keyless") else lens.clamp(min=sq)
            if c.get("keyless"):
                # query 0 of row 0 sees no key: its mean of V is far from
                # the zeros a kernel that skipped its keys would give
                mean = ops.paged_attention(q, kp, vp, tables, kl, impl="ref",
                                           **kw)[0]
                mean = mean if sq == 1 else mean[:, 0]
                check(mean.abs().max().item() > 100 * TOL["paged_attention"],
                      f"paged_attention {c}: the key-less row's mean is "
                      f"{mean.abs().max().item():.3g}, too small to check")
            compare("paged_attention", str(c), dt,
                    lambda: ops.paged_attention(q, kp, vp, tables, kl,
                                                impl="kernel", **kw),
                    lambda: ops.paged_attention(q, kp, vp, tables, kl,
                                                impl="ref", **kw))
            # the splits combine in a fixed order, with no atomics
            runs = [ops.paged_attention(q, kp, vp, tables, kl, impl="kernel",
                                        **kw) for _ in range(2)]
            check(torch.equal(*runs), f"paged_attention {c} {dt}: two runs "
                                      "differ")
    paged_repeats = 2 * len(pcases)
    paged_keyless = 2 * sum(bool(c.get("keyless")) for c in pcases)
    # timed L2-cold at the serve decode shape: each call takes its own copy
    # of q and of the slot cache (8.4 MB), the copies together over twice
    # the 50 MB L2. The yardstick is SDPA over the same contiguous cache
    # with a key-length mask: the same function for these fixed tables,
    # but it takes no block table
    B, max_len = SERVE["num_slots"], SERVE["max_len"]
    nbt = max_len // page
    tables = (torch.arange(B, device=dev, dtype=torch.int32)[:, None] * nbt
              + torch.arange(nbt, device=dev, dtype=torch.int32))
    kl = torch.tensor([129, 140, 150, 160], dtype=torch.int32, device=dev)
    n_keys = int(kl.sum())
    per_copy = 2 * B * max_len * 8 * 128 * 2
    pcopies = [(randn(B, 16, 128, dtype=bf),
                randn(B * nbt, page, 8, 128, dtype=bf),
                randn(B * nbt, page, 8, 128, dtype=bf))
               for _ in range(-(-100 * 2**20 // per_copy))]
    q = pcopies[0][0]
    key_mask = (torch.arange(max_len, device=dev)[None, :]
                < kl[:, None])[:, None, None, :]

    def sdpa_slots(q_, kp_, vp_):
        k_ = kp_.view(B, max_len, 8, 128).transpose(1, 2)
        v_ = vp_.view(B, max_len, 8, 128).transpose(1, 2)
        return F.scaled_dot_product_attention(q_[:, :, None], k_, v_,
                                              attn_mask=key_mask,
                                              enable_gqa=True)

    got = sdpa_slots(*pcopies[0])[:, :, 0].float()
    want = ops.paged_attention(*pcopies[0], tables, kl, impl="ref")
    yard_err = ((got - want).abs().max() / want.abs().max()).item()
    check(yard_err <= BF16_TOL, f"paged_attention yardstick: SDPA over the "
                                f"slot cache differs by {yard_err:.3g}")
    plan = paged_split_plan(B, 16, 8, 1, 128, page, nbt)
    record("paged_attention", "paged_attention",
           f"q ({B},16,128) bf16 over a ({B},{max_len},8,128) bf16 slot cache, "
           f"kv_lens {kl.tolist()} ({len(pcopies)} copies in turn; one layer "
           f"of a 4-slot decode tick; {plan['splits']} splits of "
           f"{plan['pages_per_split']} pages, {plan['blocks']} blocks)", bf,
           rotating(pcopies, lambda q_, kp_, vp_: ops.paged_attention(
               q_, kp_, vp_, tables, kl, impl="kernel")),
           rotating(pcopies, lambda q_, kp_, vp_: ops.paged_attention(
               q_, kp_, vp_, tables, kl, impl="ref")),
           None,
           # q, the valid K and V rows, tables, lens, fp32 out
           nbytes(q, tables, kl) + n_keys * 8 * 128 * 2 * 2 + B * 16 * 128 * 4,
           4 * 16 * 128 * n_keys, yardstick_fn=rotating(pcopies, sdpa_slots),
           iters=len(pcopies))
    results["paged_attention"].update(
        library_note="none: SDPA takes no block table; the yardstick is SDPA "
                     "over the contiguous slot cache with a key-length mask "
                     f"(max |diff| / max|ref| {yard_err:.3g} vs the plain "
                     "version)",
        bit_identical_repeats=paged_repeats, keyless_cases=paged_keyless,
        split_plan=plan)
    del pcopies
    # #5 at the paged serve path's other shapes, L2-cold as above (each call
    # its own copy of q and of the pool): a speculative verify of 4 slots x
    # (k+1 = 5) queries, and a 112-token prefix-cache extend after one
    # shared page (kv_len 128), over bf16, int8 and e4m3 pools (quantized
    # pools with fp32 scales per token and head). The bound: the valid keys'
    # K/V bytes (and scales), q, tables, lens and the fp32 out, once each
    f8 = torch.float8_e4m3fn

    def pool_copy(n, dt_):
        if dt_ == bf:
            return (randn(n, page, 8, 128, dtype=bf),
                    randn(n, page, 8, 128, dtype=bf), None, None)
        if dt_ == f8:
            vals = [(randn(n, page, 8, 128) * 64).to(f8) for _ in range(2)]
        else:
            vals = [torch.randint(-127, 128, (n, page, 8, 128), generator=gen,
                                  device=dev, dtype=torch.int8)
                    for _ in range(2)]
        return (*vals, randn(n, page, 8, 1).abs() * 0.01,
                randn(n, page, 8, 1).abs() * 0.01)

    for what, B_, sq_, kl_ in (("verify", B, 5, [133, 144, 154, 164]),
                               ("extend", 1, 112, [128])):
        tables_ = (torch.arange(B_, device=dev, dtype=torch.int32)[:, None]
                   * nbt + torch.arange(nbt, device=dev, dtype=torch.int32))
        kl_t = torch.tensor(kl_, dtype=torch.int32, device=dev)
        # query i of Sq sees kv_len - Sq + i + 1 keys
        seen = sum(sq_ * (n_ - sq_) + sq_ * (sq_ + 1) // 2 for n_ in kl_)
        for tag, dt_ in (("", bf), ("_int8", torch.int8), ("_fp8", f8)):
            elt = 2 if dt_ == bf else 1
            per_copy = 2 * B_ * max_len * 8 * 128 * elt
            copies = [(randn(B_, 16, sq_, 128, dtype=bf),
                       *pool_copy(B_ * nbt, dt_))
                      for _ in range(-(-100 * 2**20 // per_copy))]

            def kern(q_, kp_, vp_, ks_, vs_, tables_=tables_, kl_t=kl_t):
                return ops.paged_attention(q_, kp_, vp_, tables_, kl_t,
                                           k_scales=ks_, v_scales=vs_,
                                           impl="kernel")

            def plain(q_, kp_, vp_, ks_, vs_, tables_=tables_, kl_t=kl_t):
                return ops.paged_attention(q_, kp_, vp_, tables_, kl_t,
                                           k_scales=ks_, v_scales=vs_,
                                           impl="ref")

            c0 = copies[0]
            compare("paged_attention", f"{what}{tag}", bf,
                    lambda: kern(*c0), lambda: plain(*c0))
            runs = [kern(*c0) for _ in range(2)]
            check(torch.equal(*runs), f"paged_attention {what}{tag}: two "
                                      "runs differ")
            paged_repeats += 1
            scale_b = 0 if dt_ == bf else 4
            plan_ = paged_split_plan(B_, 16, 8, sq_, 128, page, nbt,
                                     kv_dtype=dt_)
            record(f"paged_attention@{what}{tag}", "paged_attention",
                   f"q ({B_},16,{sq_},128) bf16 over a ({B_ * nbt},{page},8,"
                   f"128) {str(dt_).removeprefix('torch.')} pool, kv_lens "
                   f"{kl_} ({len(copies)} copies in turn; one layer of a "
                   f"{what}; {plan_['splits']} splits, {plan_['row_chunks']} "
                   f"row chunks of {plan_['rows_per_block']}, "
                   f"{plan_['blocks']} blocks)", bf,
                   rotating(copies, kern), rotating(copies, plain), None,
                   nbytes(c0[0], tables_, kl_t)
                   + sum(kl_) * 8 * (128 * elt + scale_b) * 2
                   + B_ * 16 * sq_ * 128 * 4,
                   4 * 16 * 128 * seen, iters=len(copies), reps=3)
            results[f"paged_attention@{what}{tag}"].update(
                split_plan=plan_, library_note="none: SDPA takes no block "
                "table")
            del copies, runs
    results["paged_attention"]["bit_identical_repeats"] = paged_repeats

    # #6 multitask Hadamard at the edges of `masked_plan`, the plan it
    # shares with #9: the decode tick (4, 1, 1024), rwkv6's seam (4, 1,
    # 2048), prefills (1, 128, 1024 | 2048), two and four requests of 128,
    # width 1000 (125 vectors a row: a block spans rows), width 999 (no
    # whole 16-byte vectors) and x one element off the 16-byte grid (both
    # vec = 1); fp32 and bf16 activations over fp32 and bf16 banks. The kernel
    # rounds as the plain version does, so every case holds to it byte for
    # byte, and two calls give the same bytes
    tcases = [dict(S=1, d=d, ids=(0, 2, 1, 2)),
              dict(S=1, d=2048, ids=(0, 2, 1, 2)),
              dict(S=128, d=d, ids=(1,)), dict(S=128, d=2048, ids=(2,)),
              dict(S=128, d=d, ids=(0, 1)),
              dict(S=128, d=d, ids=(0, 2, 1, 2)),
              dict(S=5, d=1000, ids=(2, 1, 0, 1)),
              dict(S=3, d=999, ids=(2, 0, 1)),
              dict(S=2, d=d, ids=(1, 2), offset=True)]
    mt_vecs, mt_repeats = set(), 0
    for dt in (f32, bf):
        for bank_dt in (f32, bf):
            for c in tcases:
                shape = (len(c["ids"]), c["S"], c["d"])
                x = (offset_view if c.get("offset") else randn)(*shape,
                                                                dtype=dt)
                wb = (1 + randn(TASKS, c["d"], scale=0.5)).to(bank_dt)
                bb = randn(TASKS, c["d"], scale=0.5).to(bank_dt)
                ids = ids_of(*c["ids"])
                plan = masked_plan(*shape, dt, aligned16(x, wb, bb))
                mt_vecs.add(plan["vec"] > 1)
                case = f"{c} bank {bank_dt} plan={plan}"
                runs = [ops.multitask_hadamard(x, wb, bb, ids, impl="kernel")
                        for _ in range(2)]
                want = ops.multitask_hadamard(x, wb, bb, ids, impl="ref")
                compare("multitask_hadamard", case, dt, lambda: runs[0],
                        lambda: want)
                check(torch.equal(runs[0], want), f"multitask_hadamard {case} "
                      f"{dt}: not the plain version's bytes")
                check(torch.equal(*runs), f"multitask_hadamard {case} {dt}: "
                                          "two runs differ")
                mt_repeats += 1
    check(mt_vecs == {True, False}, f"multitask_hadamard: the cases ran vec "
                                    f"> 1: {mt_vecs}, want both")
    # the C entry point launches a plan as it is given, and refuses one that
    # leaves elements out (no block, half the threads), holds an idle block,
    # does not split evenly over the requests or takes 4 bf16 a thread
    x, wb, bb = randn(4, 1, d, dtype=bf), randn(TASKS, d), randn(TASKS, d)
    y, ids = torch.empty_like(x), ids_of(0, 2, 1, 2)
    good = masked_plan(4, 1, d, bf)
    bad_plans = [dict(good, blocks=good["blocks"] - 4),
                 dict(good, blocks=good["blocks"] + 4),
                 dict(good, threads=good["threads"] // 2),
                 dict(good, blocks=5), dict(good, vec=4)]
    launched_before = _build.launch_counts()["multitask_hadamard"]
    for bad in bad_plans:
        try:
            _build.launch("multitask_hadamard", "rt_multitask_hadamard",
                          x.data_ptr(), wb.data_ptr(), 0, bb.data_ptr(), 0,
                          ids.data_ptr(), y.data_ptr(), 4, 1, d, TASKS, 1,
                          bad["vec"], bad["threads"], bad["blocks"])
        except RuntimeError:
            continue
        fail(f"multitask_hadamard: the C entry point launched the plan {bad}")
    check(_build.launch_counts()["multitask_hadamard"] == launched_before,
          "multitask_hadamard: a refused plan was counted as a launch")
    # #6 timed L2-cold, bf16 x and fp32 bank rows as the bf16 engine runs
    # it, at the 4-slot decode tick, a 128-token prefill and rwkv6's seam:
    # every call of the timed graph takes its own copy of x and of the
    # bank, the copies together twice the 50 MB L2 (as #9's rows), with a
    # trace of one replay; beside the decode row, its one-copy L2-warm
    # time, the one earlier versions of this script took
    for key, B, S, width, what in (
            ("multitask_hadamard", 4, 1, d, "a 4-slot decode tick"),
            ("multitask_hadamard@prefill", 1, SERVE["prompt_len"], d,
             "a 128-token prefill"),
            ("multitask_hadamard@rwkv", 4, 1, 2048,
             "a 4-slot rwkv6 decode tick")):
        ids = ids_of(0, 2, 1, 2) if B == 4 else ids_of(1)
        per_copy = 2 * B * S * width * 2 + 2 * TASKS * width * 4
        copies = [(randn(B, S, width, dtype=bf),
                   1 + randn(TASKS, width, scale=0.1),
                   randn(TASKS, width, scale=0.1))
                  for _ in range(-(-100 * 2**20 // per_copy))]
        x = copies[0][0]
        plan = masked_plan(B, S, width, bf)

        def kern(x_, w_, b_, ids=ids):
            return ops.multitask_hadamard(x_, w_, b_, ids, impl="kernel")

        def plain(x_, w_, b_, ids=ids):
            return ops.multitask_hadamard(x_, w_, b_, ids, impl="ref")

        record(key, "multitask_hadamard",
               f"x ({B},{S},{width}) bf16, fp32 bank (3,{width}), ids "
               f"{ids.tolist()} ({len(copies)} copies in turn; one layer "
               f"of {what}; masked_plan {plan['blocks']} blocks of "
               f"{plan['threads']})",
               bf, rotating(copies, kern), rotating(copies, plain), None,
               # x, y, ids, and the distinct (w, b) rows the ids name
               2 * nbytes(x) + nbytes(ids)
               + len(set(ids.tolist())) * 2 * width * 4,
               2 * x.numel(), iters=len(copies), reps=2)
        results[key].update(
            library_note="none: the bank gather and the affine are two "
                         "calls",
            split_plan=plan,
            trace=trace_graph(rotating(copies, kern), len(copies)))
        if key == "multitask_hadamard":
            results[key]["ms_l2_warm"] = time_ms(
                lambda: kern(*copies[0]))[0]
        log(f"[3] {key}: L2-warm {results[key].get('ms_l2_warm')}; "
            f"floor {floor_ms:.5f}; traced L2-cold {results[key]['trace']}")
        del copies
    results["multitask_hadamard"].update(bit_identical_repeats=mt_repeats,
                                         refused_plans=len(bad_plans))

    # #9 masked multitask Hadamard: the decode (4, 1, 1024) and prefill
    # (1, 128, 1024) shapes over a 3-row bank, a shared-w bank (one w row),
    # two requests of 128 and a ragged width; the gates mix 0 and 1 and the
    # gated-off rows hold values far from the identity, so the gate does
    # real work
    gate3 = torch.tensor([1.0, 0.0, 1.0], device=dev)

    # at the edges of `masked_plan` too: ids out of range (clamped into each
    # row count), rwkv6's width, a width with no whole 16-byte vectors (999)
    # and x one element off the 16-byte grid (both vec = 1). Two calls on
    # the same inputs give the same bytes
    mcases = [dict(S=1, d=d, w_rows=TASKS, ids=(0, 2, 1, 2)),
              dict(S=128, d=d, w_rows=TASKS, ids=(1,)),
              dict(S=128, d=d, w_rows=TASKS, ids=(0, 1)),
              dict(S=1, d=d, w_rows=1, ids=(0, 2, 1, 2)),
              dict(S=5, d=1000, w_rows=TASKS, ids=(2, 1, 0, 1)),
              dict(S=1, d=d, w_rows=TASKS, ids=(-1, 2, 7, 1)),
              dict(S=3, d=d, w_rows=1, ids=(5, -3)),
              dict(S=1, d=2048, w_rows=TASKS, ids=(0, 2, 1, 2)),
              dict(S=3, d=999, w_rows=TASKS, ids=(2, 0, 1)),
              dict(S=2, d=d, w_rows=TASKS, ids=(1, 2), offset=True)]
    mm_vecs, mm_repeats = set(), 0
    for dt in (torch.float32, bf):
        for c in mcases:
            shape = (len(c["ids"]), c["S"], c["d"])
            x = (offset_view if c.get("offset") else randn)(*shape, dtype=dt)
            wb = 1 + randn(c["w_rows"], c["d"], scale=0.5)
            bb = randn(TASKS, c["d"], scale=0.5)
            ids = ids_of(*c["ids"])
            plan = masked_plan(*shape, dt, aligned16(x, wb, bb))
            mm_vecs.add(plan["vec"] > 1)
            compare("masked_multitask_hadamard", f"{c} plan={plan}", dt,
                    lambda: ops.masked_multitask_hadamard(
                        x, wb, bb, gate3, ids, impl="kernel"),
                    lambda: ops.masked_multitask_hadamard(
                        x, wb, bb, gate3, ids, impl="ref"))
            runs = [ops.masked_multitask_hadamard(x, wb, bb, gate3, ids,
                                                  impl="kernel")
                    for _ in range(2)]
            check(torch.equal(*runs), f"masked_multitask_hadamard {c} {dt}: "
                                      "two runs differ")
            mm_repeats += 1
    check(mm_vecs == {True, False}, f"masked_multitask_hadamard: the cases "
                                    f"ran vec > 1: {mm_vecs}, want both")
    # timed L2-cold, bf16 activations and fp32 rows as the bf16 engine runs
    # it: every call of the timed CUDA graph takes its own copy of x and of
    # the bank, the copies together twice the 50 MB L2
    for key, ids in (("masked_multitask_hadamard", ids_of(0, 2, 1, 2)),
                     ("masked_multitask_hadamard@prefill", ids_of(1))):
        S = 1 if key == "masked_multitask_hadamard" else SERVE["prompt_len"]
        B = ids.numel()
        per_copy = 2 * B * S * d * 2 + 2 * TASKS * d * 4
        copies = [(randn(B, S, d, dtype=bf), 1 + randn(TASKS, d, scale=0.1),
                   randn(TASKS, d, scale=0.1))
                  for _ in range(-(-100 * 2**20 // per_copy))]
        x = copies[0][0]
        n_rows = len(set(ids.tolist()))
        record(key, "masked_multitask_hadamard",
               f"x ({B},{S},{d}) bf16, fp32 bank (3,{d}), fp32 gate (3,), "
               f"ids {ids.tolist()} ({len(copies)} copies in turn; one layer "
               f"of {'a 4-slot decode tick' if S == 1 else 'a 128-token prefill'})",
               bf,
               rotating(copies, lambda x_, w_, b_: ops.masked_multitask_hadamard(
                   x_, w_, b_, gate3, ids, impl="kernel")),
               rotating(copies, lambda x_, w_, b_: ops.masked_multitask_hadamard(
                   x_, w_, b_, gate3, ids, impl="ref")),
               None,
               # x, y, ids, the gates and the (w, b) rows the ids name
               2 * nbytes(x) + nbytes(ids) + TASKS * 4 + n_rows * 2 * d * 4,
               5 * x.numel(), iters=len(copies), reps=2)
        results[key].update(
            library_note="none: the per-row bank gather, the gate and the "
                         "affine are separate calls",
            split_plan=masked_plan(B, S, d, bf),
            bit_identical_repeats=mm_repeats,
            trace=trace_graph(rotating(
                copies, lambda x_, w_, b_: ops.masked_multitask_hadamard(
                    x_, w_, b_, gate3, ids, impl="kernel")), len(copies)))
        log(f"[3] {key}: traced L2-cold {results[key]['trace']}")
        del copies

    # #7 dequant matmul: every (K, N) of a qwen3-0.6b layer's projections
    # at M = 1, 4 (decode slots) and 128 (a prefill), and a ragged shape;
    # fp32 and bf16 activations, int8 and fp8 weights with per-column scales
    QWEN_KN = ((1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072),
               (3072, 1024))
    VALUE_DTYPES = (torch.int8, torch.float8_e4m3fn)

    def quantized(K, N, vdt, copies=1):
        """`copies` (values (K, N), scales (1, N)) pairs of a random weight
        quantized as the engine quantizes one (`quantize_tree`)."""
        from repro_torch.quant import quantize

        out = []
        for _ in range(copies):
            qt = quantize(randn(K, N, scale=0.02),
                          "int8" if vdt == torch.int8 else "fp8")
            out.append((qt.values, qt.scales))
        return out

    # the rwkv6-1.6b LM head's decode shapes, (1|4, 2048) @ (2048, 65536):
    # a wide N that no qwen3 projection has (mma_stream with no K split)
    dq_shapes = [(m, k, n) for k, n in QWEN_KN for m in (1, 4, 128)] \
        + [(m, 2048, 65536) for m in (1, 4)]
    for dt in (torch.float32, bf):
        for vdt in VALUE_DTYPES:
            for m, k, n in dq_shapes + [(5, 77, 130)]:
                x = randn(m, k, dtype=dt)
                (v, sc), = quantized(k, n, vdt)
                compare("dequant_matmul", f"M={m} K={k} N={n} {vdt}", dt,
                        lambda: ops.dequant_matmul(x, v, sc, impl="kernel"),
                        lambda: ops.dequant_matmul(x, v, sc, impl="ref"))
    # every sum in a fixed order, no atomics: two runs give the same bits,
    # at the decode and prefill shapes of the served projections and the
    # rwkv6 head's decode shape
    dq_repeats = 0
    for dt in (torch.float32, bf):
        for vdt in VALUE_DTYPES:
            for m, k, n in [(m, k, n) for k, n in QWEN_KN for m in (4, 128)] \
                    + [(4, 2048, 65536)]:
                x = randn(m, k, dtype=dt)
                (v, sc), = quantized(k, n, vdt)
                runs = [ops.dequant_matmul(x, v, sc, impl="kernel")
                        for _ in range(2)]
                check(torch.equal(*runs), f"dequant_matmul M={m} K={k} N={n} "
                                          f"{vdt} {dt}: two runs differ")
                dq_repeats += 1

    # #1 hadamard_affine and #2 its backward, hadamard_affine_bwd, at the
    # edges of their plans (`affine_plan`, `affine_bwd_plan`): the rows of a
    # bert-base train batch (32x128 tokens, d=768); a row count one past
    # whole chunks (#2's last block of each column tile holds one row);
    # ragged widths (4000: no whole column tile; 4001: no whole 16-byte
    # vector, vec = 1); d = 4000 with x and g one element off the 16-byte
    # grid (vec = 1); g fp32 over x bf16, as the norm VJP hands #2 its
    # cotangent. Each within tolerance of its plain version, and two calls
    # on the same inputs give the same bits (y; dx, dw, db). All but the
    # bert-width, 1000-row and 7x4000 cases of one dtype (and #2's timing
    # at rwkv6's seam below) draw from a generator of their own, so the
    # phases after this one get the same inputs whatever cases it holds
    d_tr, n_tr = 768, B_tr * S_tr
    agen = torch.Generator(device=dev).manual_seed(30)

    def arandn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=agen, device=dev)
                * scale).to(dtype)

    def aoffset_view(*shape, dtype):
        return arandn(math.prod(shape) + 1, dtype=dtype)[1:].view(*shape)

    aff_rows = affine_bwd_plan(n_tr, d_tr, f32, f32)["rows_per_block"] + 1
    aff_cases = [(n_tr, d_tr, False), (aff_rows, d_tr, False), (1000, d_tr, False),
                 (7, 4000, False), (5, 4001, False), (7, 4000, True)]
    aff_plans, aff_repeats = set(), 0
    for dt, xdt in ((f32, f32), (bf, bf), (f32, bf)):
        for rows, width, off in aff_cases:
            old = dt == xdt and not off and (rows, width) in (
                (n_tr, d_tr), (1000, d_tr), (7, 4000))
            rnd = randn if old else arandn
            mk = aoffset_view if off else rnd
            x, g = mk(rows, width, dtype=xdt), mk(rows, width, dtype=dt)
            w, b = 1 + rnd(width, scale=0.1), rnd(width, scale=0.1)
            plan = affine_bwd_plan(rows, width, dt, xdt, aligned16(g, x, w))
            aff_plans.add((plan["vec"], plan["chunks"] > 1,
                           rows % plan["rows_per_block"] != 0))
            case = (f"rows={rows} d={width} g {str(dt)[6:]}, x {str(xdt)[6:]}"
                    f"{', off the 16-byte grid' if off else ''} plan={plan}")
            if dt == xdt:
                compare("hadamard_affine", case, dt,
                        lambda: ops.hadamard(x, w, b, impl="kernel"),
                        lambda: ops.hadamard(x, w, b, impl="ref"))
            compare("hadamard_affine_bwd", case, dt,
                    lambda: ops.hadamard_affine_bwd(g, x, w, impl="kernel"),
                    lambda: ops.hadamard_affine_bwd(g, x, w, impl="ref"),
                    summed=(1, 2))
            runs = [ops.hadamard_affine_bwd(g, x, w, impl="kernel")
                    + (ops.hadamard(x, w, b, impl="kernel"),) for _ in range(2)]
            check(all(torch.equal(a, b_) for a, b_ in zip(*runs)),
                  f"hadamard_affine(_bwd) {case}: two runs differ")
            aff_repeats += 1
    for want in ((4, True, True), (8, True, True), (1, False, False)):
        check(want in aff_plans, f"hadamard_affine_bwd: no case ran the plan "
                                 f"{want} (vec, chunks > 1, a last chunk "
                                 f"short of rows); ran {aff_plans}")

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
              dict(b=1, h=16, kh=8, sq=128, skv=128, D=128, causal=True),
              # 3 q chunks of 512 x 2 kv chunks of 1024, ragged
              dict(b=1, h=16, kh=8, sq=1100, skv=1300, D=128, causal=True),
              dict(b=1, h=12, kh=12, sq=1300, skv=1300, D=64, causal=False)]
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
    # the backward of DequantMatmul (dx in plain PyTorch, as `_dqmm_bwd`)
    # against autograd through the plain forward
    for dt in (f32, bf):
        for vdt in VALUE_DTYPES:
            for m, k, n in ((4, 1024, 3072), (128, 3072, 1024), (5, 77, 130)):
                x, g = randn(m, k, dtype=dt), randn(m, n, dtype=dt)
                (v, sc), = quantized(k, n, vdt)
                compare("dequant_matmul_bwd", f"M={m} K={k} N={n} {vdt}", dt,
                        lambda: grads_of(lambda t: DequantMatmul.apply(
                            t, v, sc, "kernel"), (x,), (g,)),
                        lambda: grads_of(lambda t: ref.dequant_matmul_ref(
                            t, v, sc), (x,), (g,)))
    # the backward of MaskedMultitaskHadamard (dx through #9 on dy with
    # b = 0, dw/db gated fp32 sums per task by a one-hot matmul) against
    # autograd through the plain forward
    for dt in (f32, bf):
        for ids in (ids_of(0, 2, 1, 2), ids_of(1), ids_of(2, 0)):
            S = 1 if ids.numel() == 4 else SERVE["prompt_len"]
            x = randn(ids.numel(), S, d, dtype=dt)
            g = randn(ids.numel(), S, d, dtype=dt)
            wb, bb = 1 + randn(TASKS, d, scale=0.5), randn(TASKS, d, scale=0.5)
            compare("masked_multitask_hadamard_bwd", f"ids={ids.tolist()} "
                    f"S={S}", dt,
                    lambda: grads_of(lambda *t: MaskedMultitaskHadamard.apply(
                        *t, gate3, ids, "kernel"), (x, wb, bb), (g,)),
                    lambda: grads_of(lambda *t: ops.masked_multitask_hadamard(
                        *t, gate3, ids, impl="ref"), (x, wb, bb), (g,)),
                    summed=(1, 2))
    for name in ("fused_adapter_norm_bwd", "flash_attention_bwd",
                 "dequant_matmul_bwd", "masked_multitask_hadamard_bwd"):
        log(f"[3] {name} (the gradients): {errors(name)}")
    # the tiled backward's memory at a long sequence: bert-base's heads at
    # S = 2048, fp32 non-causal, 4 x 2 tiles; the untiled plain backward
    # holds several (1, 12, 2048, 2048) fp32 buffers of 201 MB each
    q, k, v, g = (randn(1, 12, 2048, 64) for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    FlashAttention.apply(*leaves, False, None, None, 0.0, "kernel").backward(g)
    torch.cuda.synchronize()
    bwd_peak = torch.cuda.max_memory_allocated() - held
    want = ref.attention_bwd_ref(g, q, k, v,
                                 ref.attention_ref(q, k, v, causal=False),
                                 causal=False)
    bwd_err = max(((t.grad - w).abs().max() / w.abs().max()).item()
                  for t, w in zip(leaves, want))
    check(bwd_peak < 256e6, f"tiled attention backward at (1,12,2048,64): "
                            f"peak {bwd_peak} B above what was held")
    check(bwd_err <= TOL["flash_attention_bwd"],
          f"tiled attention backward at (1,12,2048,64): max |diff| / "
          f"max|ref| {bwd_err:.3g} against the untiled plain backward")
    tiled_bwd = {"shape": "q, k, v, g (1,12,2048,64) fp32 non-causal",
                 "peak_bytes_above_held": bwd_peak,
                 "vs_untiled_max_rel_err": bwd_err}
    log(f"[3] flash_attention_bwd tiled (q chunks of 512, kv chunks of "
        f"1024) at (1,12,2048,64) fp32: forward + backward peak "
        f"{bwd_peak / 1e6:.1f} MB above what was held (limit 256 MB), "
        f"gradients within {bwd_err:.3g} of max|ref| of the untiled plain "
        "backward")
    del q, k, v, g, leaves, want

    # timed at the train shapes, fp32 as bert-base trains. Each timed call
    # takes the next of several copies of its inputs, together over twice
    # the 50 MB L2, so that it reads them from device memory as a train
    # step does (one copy would stay in L2 from one replay to the next)
    w, b = 1 + randn(d_tr, scale=0.1), randn(d_tr, scale=0.1)
    xs = [(randn(n_tr, d_tr),) for _ in range(8)]
    aff_plan = affine_plan(n_tr, d_tr, f32)
    record("hadamard_affine", "hadamard_affine",
           f"x ({n_tr},{d_tr}) fp32 (8 copies in turn), fp32 w/b (one layer "
           "of a bert-base train step, hadamard_concat; "
           f"{aff_plan['blocks']} blocks of {aff_plan['warps']} warps)", f32,
           rotating(xs, lambda x: ops.hadamard(x, w, b, impl="kernel")),
           rotating(xs, lambda x: ops.hadamard(x, w, b, impl="ref")),
           rotating(xs, lambda x: torch.addcmul(b, x, w)),
           2 * nbytes(xs[0][0]) + nbytes(w, b), 2 * xs[0][0].numel())
    results["hadamard_affine"].update(split_plan=aff_plan,
                                      bit_identical_repeats=aff_repeats)
    gxs = [(randn(n_tr, d_tr), randn(n_tr, d_tr)) for _ in range(4)]
    aff_plan = affine_bwd_plan(n_tr, d_tr, f32, f32)
    record("hadamard_affine_bwd", "hadamard_affine_bwd",
           f"g, x ({n_tr},{d_tr}) fp32 (4 copies in turn), fp32 w (one layer "
           "of a bert-base train step's backward; "
           f"{aff_plan['blocks']} blocks, {aff_plan['chunks']} row chunks)",
           f32,
           rotating(gxs, lambda g, x: ops.hadamard_affine_bwd(
               g, x, w, impl="kernel")),
           rotating(gxs, lambda g, x: ops.hadamard_affine_bwd(
               g, x, w, impl="ref")),
           None,
           # read g, x, w; write dx, dw, db
           3 * nbytes(gxs[0][0]) + nbytes(w) + 2 * d_tr * 4,
           4 * gxs[0][0].numel())
    results["hadamard_affine_bwd"].update(split_plan=aff_plan,
                                          bit_identical_repeats=aff_repeats)
    qkvs = [tuple(randn(B_tr, 12, S_tr, 64) for _ in range(3))
            for _ in range(6)]
    record("flash_attention@train", "flash_attention",
           f"q, k, v ({B_tr},12,{S_tr},64) fp32 (6 copies in turn) "
           "non-causal (one layer of a bert-base forward)", f32,
           rotating(qkvs, lambda q, k, v: ops.flash_attention(
               q, k, v, causal=False, impl="kernel")),
           rotating(qkvs, lambda q, k, v: ops.flash_attention(
               q, k, v, causal=False, impl="ref")),
           rotating(qkvs, F.scaled_dot_product_attention),
           4 * nbytes(qkvs[0][0]), 4 * B_tr * 12 * S_tr * S_tr * 64,
           iters=len(qkvs))
    xrs = [(randn(B_tr, S_tr, d_tr), randn(B_tr, S_tr, d_tr))
           for _ in range(4)]
    scale, bias = randn(d_tr), randn(d_tr)
    plan = fused_norm_plan(n_tr, d_tr, f32)
    record("fused_adapter_norm@train", "fused_adapter_norm",
           f"x, res ({B_tr},{S_tr},{d_tr}) fp32 (4 copies in turn), "
           "LayerNorm (one layer of a bert-base forward, hadamard; "
           f"{plan['kernel']}, {plan['rows_per_block']} rows a block)", f32,
           rotating(xrs, lambda x, res: ops.fused_adapter_norm(
               x, res, w, b, scale, bias=bias, eps=1e-12, impl="kernel")),
           rotating(xrs, lambda x, res: ops.fused_adapter_norm(
               x, res, w, b, scale, bias=bias, eps=1e-12, impl="ref")),
           None, 4 * nbytes(xrs[0][0]) + nbytes(w, b, scale, bias),
           8 * xrs[0][0].numel(),
           yardstick_fn=rotating(xrs, lambda x, res: F.layer_norm(
               x, (d_tr,), scale, bias, 1e-12)))
    results["fused_adapter_norm@train"].update(
        library_note=fan_note, split_plan=plan,
        bit_identical_repeats=fan_repeats,
        trace=trace_graph(rotating(xrs, lambda x, res: ops.fused_adapter_norm(
            x, res, w, b, scale, bias=bias, eps=1e-12, impl="kernel")), 20))
    log(f"[3] fused_adapter_norm@train: traced {results['fused_adapter_norm@train']['trace']}")
    del xs, gxs, qkvs, xrs

    def time_dequant(key, m, K, N, copies, what):
        """#7 timed L2-cold at x (m, K) bf16 @ int8 values (K, N), as the
        quantized tick runs it: `copies` weights in turn, past the 50 MB L2
        that one weight would otherwise sit in from one replay to the next,
        as it never does in a tick. The yardstick is torch.matmul of x with
        the same weight already dequantized to bf16: the unquantized path's
        projection, not a call that computes this function. The library
        call, where the installed torch has one, is its weight-only int8
        matmul, which takes the weight transposed (N, K)."""
        wq = quantized(K, N, torch.int8, copies=copies)
        half = wq[:max(2, copies // 2)]
        wbf = [(v.float().mul(sc).to(bf),) for v, sc in half]
        x = randn(m, K, dtype=bf)
        int8pack, lib_rel = None, None
        if hasattr(torch, "_weight_int8pack_mm"):
            wt = [(v.t().contiguous(), sc.reshape(-1).to(bf))
                  for v, sc in half]
            try:
                got = torch._weight_int8pack_mm(x, *wt[0])
                int8pack = wt
                note = ("torch._weight_int8pack_mm, weight (N, K) int8, bf16 "
                        "scales")
                want = ops.dequant_matmul(x, *wq[0], impl="ref").float()
                lib_rel = ((got.float() - want).abs().max().item()
                           / want.abs().max().item())
            except (RuntimeError, NotImplementedError) as e:
                note = (f"none: torch._weight_int8pack_mm refused these CUDA "
                        f"tensors in torch {torch.__version__} "
                        f"({str(e).splitlines()[0][:160]})")
        else:
            note = (f"none: torch {torch.__version__} has no weight-only int8 "
                    "matmul call")
        plan = dequant_matmul_plan(m, K, N, bf, torch.int8)
        record(key, "dequant_matmul",
               f"x ({m},{K}) bf16 @ int8 values ({K},{N}) ({copies} copies in "
               f"turn), fp32 scales (1,{N}) ({what}; {plan['kernel']}, "
               f"{math.prod(plan['grid'])} blocks, cluster {plan['cluster']})", bf,
               rotating(wq, lambda v, sc: ops.dequant_matmul(
                   x, v, sc, impl="kernel")),
               rotating(wq, lambda v, sc: ops.dequant_matmul(
                   x, v, sc, impl="ref")),
               None if int8pack is None else rotating(
                   int8pack, lambda w, s_: torch._weight_int8pack_mm(x, w, s_)),
               # read x, values, scales; write y
               nbytes(x, *wq[0]) + m * N * 2, 2 * m * K * N,
               yardstick_fn=rotating(wbf, lambda w: torch.matmul(x, w)),
               iters=max(copies, 16), reps=10 if copies > 2 else 5)
        results[key].update(library_note=note, split_plan=plan,
                            library_rel_diff_vs_plain=lib_rel)
        log(f"[3] {key} library call: {note}; max |diff| / max|ref| vs the "
            f"plain version {lib_rel}")
        del wq, wbf, int8pack
        torch.cuda.empty_cache()

    # #7 timed at wi's decode (M = 4 slots) and prefill (M = 128) shapes
    # and at the rwkv6 head's decode shape (x (4, 2048) @ int8 (2048,
    # 65536), 134 MB: the streaming rate)
    for key, m, K, N, copies, what in (
            ("dequant_matmul", SERVE["num_slots"], 1024, 3072, 32,
             "wi of one layer, a 4-slot decode tick"),
            ("dequant_matmul@prefill", SERVE["prompt_len"], 1024, 3072, 32,
             "wi of one layer, a 128-token prefill"),
            ("dequant_matmul@head", SERVE["num_slots"], 2048, 65536, 2,
             "the rwkv6-1.6b LM head, a 4-slot decode tick")):
        time_dequant(key, m, K, N, copies, what)
        results[key]["bit_identical_repeats"] = dq_repeats

    # #8 the WKV6 recurrence: o and the final state against the plain
    # version, relative to their max |ref| (a T-step sum). The serve path's
    # shapes in its layout ((B, T, H, n) tensors seen as (B, H, T, n)):
    # a 4-slot decode tick from a random state, written in place as the
    # decode cache is, and a 128-token prefill from zeros; then ragged T
    # (not a multiple of the chunk), the smoke config's head size 16,
    # contiguous, and w holding exact 0s and 1s (w = exp(-exp(x)) underflows
    # to 0 and rounds to 1: a log-space chunked form would give NaN)
    RW = dict(H=32, n=64)  # rwkv6-1.6b: 32 heads of 64

    def wkv_inputs(B, H, T, n, dt, layout="bthn", state=True, zeros=False):
        def mk(x):
            x = x if layout == "bhtn" else x.reshape(B, T, H, n).transpose(1, 2)
            return x.to(dt)
        rkv = [mk(randn(B, H, T, n) if layout == "bhtn" else randn(B, T, H, n))
               for _ in range(3)]
        w = torch.sigmoid(randn(B, H, T, n) if layout == "bhtn"
                          else randn(B, T, H, n))
        if zeros:  # exact 0s and 1s, in a band of i and at some steps
            w[..., :5] = 0.0
            w[..., 5:9] = 1.0
            (w[:, :, 3::7] if layout == "bhtn" else w[:, 3::7]).zero_()
        w = mk(w)
        u = randn(H, n, scale=0.1)
        s0 = randn(B, H, n, n, scale=0.3) if state else None
        return (*rkv, w, u, s0)

    def wkv_on_copy(ins, impl):
        """ops.wkv6 over ins as the decode path calls it: the final state
        written over s0, here a copy, so that both sides start from it."""
        *rkvwu, s0_ = ins
        return ops.wkv6(*rkvwu, s0=None if s0_ is None else s0_.clone(),
                        impl=impl)

    wcases = [dict(B=4, T=1, **RW), dict(B=1, T=128, state=False, **RW),
              dict(B=1, T=128, **RW),
              dict(B=2, H=3, T=33, n=64, layout="bhtn"),
              dict(B=2, H=4, T=33, n=16, layout="bhtn"),
              dict(B=2, H=4, T=1, n=32, layout="bhtn"),
              dict(B=1, T=128, zeros=True, **RW),
              dict(B=1, T=128, state=False, zeros=True, **RW),
              dict(B=2, H=3, T=37, n=64, layout="bhtn", zeros=True),
              dict(B=2, H=3, T=37, n=64, layout="bhtn", state=False,
                   zeros=True),
              dict(B=2, H=4, T=70, n=32, layout="bhtn", zeros=True),
              dict(B=2, H=4, T=21, n=16, layout="bhtn", state=False,
                   zeros=True)]
    wkv_repeats = 0
    for dt in (torch.float32, bf):
        for c in wcases:
            ins = wkv_inputs(c["B"], c["H"], c["T"], c["n"], dt,
                             c.get("layout", "bthn"), c.get("state", True),
                             c.get("zeros", False))
            compare("wkv6", str(c), dt, lambda: wkv_on_copy(ins, "kernel"),
                    lambda: wkv_on_copy(ins, "ref"))
            # a fixed summation order and no atomics: the same bits twice
            (o1, s1), (o2, s2) = (wkv_on_copy(ins, "kernel") for _ in range(2))
            check(torch.equal(o1, o2) and torch.equal(s1, s2),
                  f"wkv6 {c} {dt}: two runs differ")
            wkv_repeats += 1
    # timed at the decode tick's and the prefill's shapes, fp32 as the time
    # mix passes them (r, k, v, w cast to fp32 before the recurrence). Each
    # timed call takes the next of `copies` input sets, together over twice
    # the 50 MB L2: on the serve path a layer's state and inputs come from
    # device memory, after the other layers' states and weights have gone
    # through the cache. The graph holds one call per copy
    for key, B, T, copies in (("wkv6", SERVE["num_slots"], 1, 48),
                              ("wkv6@prefill", 1, SERVE["prompt_len"], 24)):
        sets = [wkv_inputs(B, RW["H"], T, RW["n"], f32, state=T == 1)
                for _ in range(copies)]
        # r, k, v, w read and o written; u read
        io = 5 * B * T * RW["H"] * RW["n"] * 4 + nbytes(sets[0][4])
        state_bytes = B * RW["H"] * RW["n"] ** 2 * 4
        record(key, "wkv6",
               f"r,k,v,w ({B},{RW['H']},{T},{RW['n']}) fp32 in the (B,T,H,n) "
               f"layout, u ({RW['H']},{RW['n']}), {copies} copies in turn, "
               + ("the state read and written in place (one layer of a "
                  "4-slot decode tick)" if T == 1 else
                  "from a zero state, the state written (one layer of a "
                  "128-token prefill)"), f32,
               rotating(sets, lambda *a: ops.wkv6(*a[:5], s0=a[5],
                                                  impl="kernel")),
               rotating(sets, lambda *a: ops.wkv6(*a[:5], s0=a[5],
                                                  impl="ref")),
               None,
               # the state written, and read too when there is one
               io + state_bytes * (2 if T == 1 else 1),
               # per step n^2 multiply-adds for o and n^2 for the state
               4 * B * RW["H"] * T * RW["n"] ** 2, iters=copies)
        del sets
        results[key].update(
            library_note="none: no PyTorch call computes the recurrence",
            split_plan=wkv6_plan(B, RW["H"], T, RW["n"]),
            bit_identical_repeats=wkv_repeats)
    torch.cuda.empty_cache()

    # the recurrence's backward for training (`WKV6`: #8 forward, the
    # plain chunked backward `wkv6_backward`, as JAX's trainer
    # differentiates its chunk-rematted scan) against autograd through the
    # plain forward: dr, dk, dv, dw, du, and ds0 from a given state, with
    # cotangents on o and on the final state; 4 rows of the rwkv6-1.6b
    # train shape in its layout (one chunk of 128), and a ragged T = 33 in
    # chunks of 16 with w holding exact 0s and 1s; fp32 and bf16 inputs
    from repro_torch.kernels.rwkv6 import WKV6, wkv6_backward

    wbcases = [dict(B=4, T=128, state=False, chunk=128, **RW),
               dict(B=2, H=3, T=33, n=64, layout="bhtn", zeros=True,
                    chunk=16),
               dict(B=2, H=3, T=33, n=64, layout="bhtn", zeros=True,
                    state=False, chunk=128)]
    for dt in (f32, bf):
        for c in wbcases:
            *ins, s0_ = wkv_inputs(c["B"], c["H"], c["T"], c["n"], dt,
                                   c.get("layout", "bthn"),
                                   c.get("state", True), c.get("zeros", False))
            ins = tuple(ins) + (() if s0_ is None else (s0_,))
            cot = (randn(c["B"], c["H"], c["T"], c["n"], dtype=dt),
                   randn(c["B"], c["H"], c["n"], c["n"]))
            compare("wkv6_bwd", str(c), dt,
                    lambda: grads_of(lambda *t: WKV6.apply(
                        *t[:5], t[5] if len(t) > 5 else None, c["chunk"],
                        "kernel"), ins, cot),
                    lambda: grads_of(lambda *t: ref.wkv6_ref(
                        *t[:5], t[5] if len(t) > 5 else None), ins, cot))
    del ins, cot
    # #8 at the train shape: a 16 x 128-token step's layer, fp32 as the
    # time mix passes it, L2-cold (2 copies of 92 MB in turn); and the
    # plain backward's eager time there (device events around calls)
    B_w, T_w = LM_TRAIN["batch"], LM_TRAIN["seq"]
    sets = [wkv_inputs(B_w, RW["H"], T_w, RW["n"], f32, state=False)
            for _ in range(2)]
    record("wkv6@train", "wkv6",
           f"r,k,v,w ({B_w},{RW['H']},{T_w},{RW['n']}) fp32 in the (B,T,H,n) "
           "layout, u, 2 copies in turn, from a zero state, the state "
           "written (one layer of an rwkv6-1.6b 16 x 128-token train step)",
           f32, rotating(sets, lambda *a: ops.wkv6(*a[:5], impl="kernel")),
           rotating(sets, lambda *a: ops.wkv6(*a[:5], impl="ref")), None,
           5 * B_w * T_w * RW["H"] * RW["n"] * 4 + nbytes(sets[0][4])
           + B_w * RW["H"] * RW["n"] ** 2 * 4,
           4 * B_w * RW["H"] * T_w * RW["n"] ** 2, iters=2)
    r_, k_, v_, w_, u_, _ = sets[0]
    do_ = randn(B_w, RW["H"], T_w, RW["n"])
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    wkv6_backward(r_, k_, v_, w_, u_, do_, chunk=128)
    torch.cuda.synchronize()
    ev0.record()
    for _ in range(3):
        wkv6_backward(r_, k_, v_, w_, u_, do_, chunk=128)
    ev1.record()
    ev1.synchronize()
    results["wkv6@train"].update(
        library_note="none: no PyTorch call computes the recurrence",
        split_plan=wkv6_plan(B_w, RW["H"], T_w, RW["n"]),
        bwd_plain_eager_ms=ev0.elapsed_time(ev1) / 3,
        bwd_route="plain PyTorch, chunk by chunk (rwkv6.wkv6_backward)")
    log(f"[3] wkv6 backward (WKV6, plain chunked): "
        f"{errors('wkv6_bwd')}; at the train shape "
        f"({B_w},{RW['H']},{T_w},{RW['n']}) fp32 "
        f"{results['wkv6@train']['bwd_plain_eager_ms']:.3f} ms a call, "
        f"eager, device events; on {smi}")
    del sets, r_, k_, v_, w_, u_, do_
    torch.cuda.empty_cache()

    # the train_lm shapes: a qwen3-0.6b fine-tuning step in bf16 (phase
    # 8d), 16 x 128 tokens. #3's forward and its backward (the norm VJP in
    # plain torch, then #2 on the fp32 cotangent it hands on and the bf16
    # adapter input), #2 also through HadamardAffine on a bf16 cotangent,
    # #4 causal over 16 heads on 8 with its log-sum-exp, #7 at M = 2048;
    # each kernel against its plain version, each backward against
    # autograd through the plain forward, every output within BF16_TOL of
    # its own max |ref|
    B_lm, S_lm = LM_TRAIN["batch"], LM_TRAIN["seq"]
    n_lm, shp_lm = B_lm * S_lm, (B_lm, S_lm, d)
    w, b = 1 + randn(d, scale=0.1), randn(d, scale=0.1)
    scale_lm = 1 + randn(d, dtype=bf, scale=0.1)
    x, res = randn(*shp_lm, dtype=bf), randn(*shp_lm, dtype=bf)
    g_xn, g_h = randn(*shp_lm, dtype=bf), randn(*shp_lm, dtype=bf)
    lm_case = f"{shp_lm} bf16, fp32 w/b, bf16 scale, RMSNorm (train_lm)"
    compare("fused_adapter_norm", lm_case, bf,
            lambda: ops.fused_adapter_norm(x, res, w, b, scale_lm, eps=1e-6,
                                           impl="kernel"),
            lambda: ops.fused_adapter_norm(x, res, w, b, scale_lm, eps=1e-6,
                                           impl="ref"))
    compare("fused_adapter_norm_bwd", lm_case, bf,
            lambda: grads_of(lambda *t: FusedAdapterResidualNorm.apply(
                *t, None, 1e-6, "kernel"), (x, res, w, b, scale_lm),
                (g_xn, g_h)),
            lambda: grads_of(lambda *t: ref.fused_adapter_residual_norm_ref(
                *t, eps=1e-6), (x, res, w, b, scale_lm), (g_xn, g_h)))
    gt, xa = randn(n_lm, d), randn(n_lm, d, dtype=bf)
    compare("hadamard_affine_bwd", f"g ({n_lm},{d}) fp32, x bf16 (train_lm)",
            bf, lambda: ops.hadamard_affine_bwd(gt, xa, w, impl="kernel"),
            lambda: ops.hadamard_affine_bwd(gt, xa, w, impl="ref"))
    ga = randn(n_lm, d, dtype=bf)
    compare("hadamard_affine_bwd", f"HadamardAffine ({n_lm},{d}) bf16 "
            "(train_lm)", bf,
            lambda: grads_of(lambda *t: HadamardAffine.apply(*t, "kernel"),
                             (xa, w, b), (ga,)),
            lambda: grads_of(ref.hadamard_ref, (xa, w, b), (ga,)))
    qkv_lm = dict(q=(B_lm, 16, S_lm, 128), k=(B_lm, 8, S_lm, 128),
                  v=(B_lm, 8, S_lm, 128))
    q, k, v = (randn(*qkv_lm[n], dtype=bf) for n in "qkv")
    compare("flash_attention", "train_lm causal GQA 16/8 with lse", bf,
            lambda: ops.flash_attention(q, k, v, return_lse=True,
                                        impl="kernel"),
            lambda: ops.flash_attention(q, k, v, return_lse=True, impl="ref"))
    del x, res, g_xn, g_h, gt, xa, ga, q, k, v

    # timed L2-cold at these shapes: each call takes the next of copies
    # that together pass twice the 50 MB L2
    xrs = [(randn(*shp_lm, dtype=bf), randn(*shp_lm, dtype=bf))
           for _ in range(8)]
    plan = fused_norm_plan(n_lm, d, bf)
    record("fused_adapter_norm@train_lm", "fused_adapter_norm",
           f"x, res {shp_lm} bf16 (8 copies in turn), fp32 w/b, bf16 scale, "
           f"RMSNorm (one layer of a qwen3-0.6b train_lm forward; "
           f"{plan['kernel']}, {plan['rows_per_block']} rows a block)", bf,
           rotating(xrs, lambda x_, r_: ops.fused_adapter_norm(
               x_, r_, w, b, scale_lm, eps=1e-6, impl="kernel")),
           rotating(xrs, lambda x_, r_: ops.fused_adapter_norm(
               x_, r_, w, b, scale_lm, eps=1e-6, impl="ref")),
           None, 4 * nbytes(xrs[0][0]) + nbytes(w, b, scale_lm),
           8 * xrs[0][0].numel(),
           yardstick_fn=rotating(xrs, lambda x_, r_: F.rms_norm(
               x_, (d,), scale_lm, 1e-6)))
    results["fused_adapter_norm@train_lm"].update(
        library_note=fan_note, split_plan=plan)
    gxs = [(randn(n_lm, d), randn(n_lm, d, dtype=bf)) for _ in range(8)]
    record("hadamard_affine_bwd@train_lm", "hadamard_affine_bwd",
           f"g ({n_lm},{d}) fp32, x ({n_lm},{d}) bf16 (8 copies in turn), "
           "fp32 w (one layer of a qwen3-0.6b train_lm backward, under #3)",
           f32,
           rotating(gxs, lambda g_, x_: ops.hadamard_affine_bwd(
               g_, x_, w, impl="kernel")),
           rotating(gxs, lambda g_, x_: ops.hadamard_affine_bwd(
               g_, x_, w, impl="ref")),
           None,
           # read g, x, w; write dx (fp32), dw, db
           2 * nbytes(gxs[0][0]) + nbytes(gxs[0][1], w) + 2 * d * 4,
           4 * n_lm * d)
    qkvs = [tuple(randn(*qkv_lm[n], dtype=bf) for n in "qkv")
            for _ in range(6)]
    record("flash_attention@train_lm", "flash_attention",
           f"q {qkv_lm['q']} over k/v {qkv_lm['k']} bf16 causal, with lse "
           f"({len(qkvs)} copies in turn; one layer of a qwen3-0.6b train_lm "
           "forward)", bf,
           rotating(qkvs, lambda q_, k_, v_: ops.flash_attention(
               q_, k_, v_, return_lse=True, impl="kernel")),
           rotating(qkvs, lambda q_, k_, v_: ops.flash_attention(
               q_, k_, v_, return_lse=True, impl="ref")),
           rotating(qkvs, lambda q_, k_, v_: F.scaled_dot_product_attention(
               q_, k_, v_, is_causal=True, enable_gqa=True)),
           # read q, k, v; write out and the fp32 lse
           2 * nbytes(qkvs[0][0]) + nbytes(*qkvs[0][1:]) + B_lm * 16 * S_lm * 4,
           4 * B_lm * 16 * 128 * (S_lm * (S_lm + 1) // 2),
           iters=len(qkvs), reps=5)
    results["flash_attention@train_lm"]["library_note"] = (
        "torch.nn.functional.scaled_dot_product_attention(is_causal=True, "
        "enable_gqa=True), no lse")
    del xrs, gxs, qkvs
    (v_, sc), = quantized(d, 3072, torch.int8)
    x = randn(n_lm, d, dtype=bf)
    compare("dequant_matmul", f"M={n_lm} K={d} N=3072 int8 (train_lm)", bf,
            lambda: ops.dequant_matmul(x, v_, sc, impl="kernel"),
            lambda: ops.dequant_matmul(x, v_, sc, impl="ref"))
    del v_, sc, x
    time_dequant("dequant_matmul@train_lm", n_lm, d, 3072, 32,
                 "wi of one layer, a qwen3-0.6b train_lm forward")

    # the rwkv6 train shapes: an rwkv6-1.6b fine-tuning step in bf16 (phase
    # 8r), 16 x 128 tokens of 2048. #3 at the seam, LayerNorm with bf16
    # scale and bias, and its backward (the norm VJP in plain torch, then #2
    # on the fp32 cotangent it hands on and the bf16 adapter input); #2
    # alone at that pair of dtypes; #7 at the int8 head's training shape,
    # x (2048, 2048) bf16 @ (2048, 65536). Each against its plain version,
    # each backward against autograd through the plain forward, every
    # output within BF16_TOL of its own max |ref|
    d_rw, eps_rw = 2048, launcher.build_config(RWKV_ARCH).norm_eps
    n_rw, shp_rw = B_lm * S_lm, (B_lm, S_lm, d_rw)
    w, b = 1 + randn(d_rw, scale=0.1), randn(d_rw, scale=0.1)
    scale_rw = 1 + randn(d_rw, dtype=bf, scale=0.1)
    bias_rw = randn(d_rw, dtype=bf, scale=0.1)
    x, res = randn(*shp_rw, dtype=bf), randn(*shp_rw, dtype=bf)
    g_xn, g_h = randn(*shp_rw, dtype=bf), randn(*shp_rw, dtype=bf)
    rw_case = (f"{shp_rw} bf16, fp32 w/b, bf16 scale/bias, LayerNorm eps "
               f"{eps_rw} (train_rwkv)")
    compare("fused_adapter_norm", rw_case, bf,
            lambda: ops.fused_adapter_norm(x, res, w, b, scale_rw, bias_rw,
                                           eps=eps_rw, impl="kernel"),
            lambda: ops.fused_adapter_norm(x, res, w, b, scale_rw, bias_rw,
                                           eps=eps_rw, impl="ref"))
    compare("fused_adapter_norm_bwd", rw_case, bf,
            lambda: grads_of(lambda *t: FusedAdapterResidualNorm.apply(
                *t, eps_rw, "kernel"), (x, res, w, b, scale_rw, bias_rw),
                (g_xn, g_h)),
            lambda: grads_of(lambda *t: ref.fused_adapter_residual_norm_ref(
                *t[:5], eps=eps_rw, bias=t[5]),
                (x, res, w, b, scale_rw, bias_rw), (g_xn, g_h)))
    gt, xa = randn(n_rw, d_rw), randn(n_rw, d_rw, dtype=bf)
    compare("hadamard_affine_bwd", f"g ({n_rw},{d_rw}) fp32, x bf16 "
            "(train_rwkv)", bf,
            lambda: ops.hadamard_affine_bwd(gt, xa, w, impl="kernel"),
            lambda: ops.hadamard_affine_bwd(gt, xa, w, impl="ref"))
    del x, res, g_xn, g_h, gt, xa
    # #2 timed L2-cold at that seam, as at train_lm's
    gxs = [(arandn(n_rw, d_rw), arandn(n_rw, d_rw, dtype=bf))
           for _ in range(4)]
    aff_plan = affine_bwd_plan(n_rw, d_rw, f32, bf)
    record("hadamard_affine_bwd@train_rwkv", "hadamard_affine_bwd",
           f"g ({n_rw},{d_rw}) fp32, x ({n_rw},{d_rw}) bf16 (4 copies in "
           "turn), fp32 w (one layer of an rwkv6-1.6b train step's backward, "
           f"under #3; {aff_plan['blocks']} blocks)", f32,
           rotating(gxs, lambda g_, x_: ops.hadamard_affine_bwd(
               g_, x_, w, impl="kernel")),
           rotating(gxs, lambda g_, x_: ops.hadamard_affine_bwd(
               g_, x_, w, impl="ref")),
           None,
           # read g, x, w; write dx (fp32), dw, db
           2 * nbytes(gxs[0][0]) + nbytes(gxs[0][1], w) + 2 * d_rw * 4,
           4 * n_rw * d_rw, iters=len(gxs))
    results["hadamard_affine_bwd@train_rwkv"].update(
        split_plan=aff_plan, library_note="none: no one call gives g*w with "
        "the column sums of g*x and g")
    del gxs
    (v_head, sc_head), = quantized(d_rw, 65536, torch.int8)
    x = randn(n_rw, d_rw, dtype=bf)
    compare("dequant_matmul", f"M={n_rw} K={d_rw} N=65536 int8 (train_rwkv "
            f"head; {dequant_matmul_plan(n_rw, d_rw, 65536, bf, torch.int8)})",
            bf, lambda: ops.dequant_matmul(x, v_head, sc_head, impl="kernel"),
            lambda: ops.dequant_matmul(x, v_head, sc_head, impl="ref"))
    del v_head, sc_head, x
    log("[3] train_rwkv shapes, worst max abs err / max|ref| per output "
        f"(tol {BF16_TOL}): fused_adapter_norm "
        f"{checks['fused_adapter_norm']['rels'][-1]:.3g}, its backward "
        f"{checks['fused_adapter_norm_bwd']['rels'][-1]:.3g}, "
        f"hadamard_affine_bwd {checks['hadamard_affine_bwd']['rels'][-1]:.3g}"
        f", dequant_matmul {checks['dequant_matmul']['rels'][-1]:.3g}")
    torch.cuda.empty_cache()
    phase_done("3")

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
    phase_done("4")

    # -- phase 4b: the same model int8-quantized, kernel path vs plain path --
    toks = torch.randint(10, cfg32.vocab_size, (2, 64), generator=gen,
                         device=dev)
    tok = torch.randint(10, cfg32.vocab_size, (2, 1), generator=gen,
                        device=dev)
    pos = torch.tensor([64, 64], device=dev)
    runs = {}
    for quant, impl in (("int8", "auto"), ("int8", "ref"), (None, "auto")):
        eng = launcher.build_engine(cfg32, seed=1, tasks=0, device=dev,
                                    quant=quant)
        _build.reset_launches()
        with torch.no_grad():
            lg, caches = M.prefill_lm(eng.params, cfg32, toks, 80, impl=impl)
            lg2, _ = M.decode_lm(eng.params, cfg32, caches, tok, pos,
                                 impl=impl)
        torch.cuda.synchronize()
        runs[(quant, impl)] = (lg, lg2, _build.launch_counts()["dequant_matmul"])
        del eng, caches
        torch.cuda.empty_cache()
    n_dq = 7 * cfg32.n_layers
    check(runs[("int8", "auto")][2] == 2 * n_dq,
          f"phase 4b: {runs[('int8', 'auto')][2]} dequant_matmul launches in "
          f"a prefill and a decode step, want {2 * n_dq}")
    check(runs[("int8", "ref")][2] == 0 == runs[(None, "auto")][2],
          "phase 4b: the plain and the unquantized paths launched #7")
    worst = vs_fp32 = 0.0
    for step in range(2):
        a, r, u = (runs[k][step] for k in (("int8", "auto"), ("int8", "ref"),
                                           (None, "auto")))
        check(a.shape == (2, 1, cfg32.vocab_size)
              and bool(torch.isfinite(a).all()), f"phase 4b logits {a.shape}")
        diff, top = (a - r).abs().max().item(), r.abs().max().item()
        check(diff <= 1e-3 * top, f"phase 4b step {step}: |kernel - plain| "
                                  f"{diff:.3g} > 1e-3 x {top:.3g}")
        worst = max(worst, diff / top)
        vs_fp32 = max(vs_fp32, (a - u).abs().max().item() / u.abs().max().item())
    quant_model = {"kernel_vs_plain": worst, "int8_vs_fp32_ungated": vs_fp32,
                   "dequant_matmul_launches": runs[("int8", "auto")][2]}
    log(f"[4b] qwen3-0.6b fp32 int8-quantized, {cfg32.n_layers} layers: "
        f"prefill + 1 decode step, {runs[('int8', 'auto')][2]} dequant_matmul "
        f"launches, kernel path vs plain path max |diff| / max|ref| = "
        f"{worst:.3g} (tol 1e-3); int8 vs unquantized fp32 logits max "
        f"|diff| / max|ref| = {vs_fp32:.3g} (not gated: random weights)")
    del runs
    torch.cuda.empty_cache()
    phase_done("4b")

    # -- phase 4c: the fp32 model over a hot-swap bank, kernel vs plain -----
    from repro_torch.serving import AdapterBank, AdapterRegistry, MultiTaskEngine
    from repro_torch.sparse import apply_layer_mask, preset_mask

    base32 = launcher.build_base(cfg32, 1, dev)
    dense32, pruned32 = launcher.task_variants(base32, 1, 2)
    pmask = preset_mask(cfg32)
    check(int(pmask.sum()) == 18 and pmask[10:].all(),
          f"phase 4c: paper-0.022 keeps {int(pmask.sum())} of {len(pmask)}")
    pruned32 = apply_layer_mask(pruned32, cfg32, pmask)
    with tempfile.TemporaryDirectory() as td:
        reg = AdapterRegistry(td)
        reg.publish("pruned", launcher.task_delta(pruned32, cfg32, pmask))
        reg.publish("dense", launcher.task_delta(dense32, cfg32))
        hot = MultiTaskEngine(cfg32, AdapterBank(cfg32, base32, 3, reg),
                              device=dev)
        rows = [hot.adapter_bank.lookup(n) for n in ("pruned", "dense")]
    gates = hot.adapter_bank.gate_tensor
    want_gates = torch.zeros_like(gates)
    want_gates[:, 0] = torch.as_tensor(pmask, dtype=torch.float32)
    want_gates[:, 1] = 1.0
    check(rows == [0, 1] and torch.equal(gates, want_gates),
          f"phase 4c: rows {rows}, gates per row {gates.sum(0).tolist()}")
    # the static bank of the same three rows: pruned, dense, identity
    static = MultiTaskEngine(cfg32, [pruned32, dense32, base32], device=dev)
    toks = torch.randint(10, cfg32.vocab_size, (3, 64), generator=gen,
                         device=dev)
    tids = torch.tensor([0, 1, 2], dtype=torch.int32, device=dev)
    runs = {}
    for name, model, impl, g in (("kernel", hot, "auto", gates),
                                 ("plain", hot, "ref", gates),
                                 ("static", static, "auto", None)):
        _build.reset_launches()
        with torch.no_grad():
            lg, caches = M.prefill_lm(model.params, cfg32, toks, 80,
                                      task_ids=tids, gates=g, impl=impl)
            out = [lg]
            for i in range(4):
                tok = torch.randint(10, cfg32.vocab_size, (3, 1),
                                    generator=torch.Generator(device=dev)
                                    .manual_seed(i), device=dev)
                pos = torch.full((3,), 64 + i, device=dev)
                lg, caches = M.decode_lm(model.params, cfg32, caches, tok,
                                         pos, task_ids=tids, gates=g,
                                         impl=impl)
                out.append(lg)
        torch.cuda.synchronize()
        runs[name] = (out, _build.launch_counts())
    n_calls = 5 * cfg32.n_layers
    for name, k, want in (("kernel", "masked_multitask_hadamard", n_calls),
                          ("kernel", "multitask_hadamard", 0),
                          ("kernel", "fused_adapter_norm", 0),
                          ("plain", "masked_multitask_hadamard", 0),
                          ("static", "multitask_hadamard", n_calls),
                          ("static", "masked_multitask_hadamard", 0)):
        check(runs[name][1][k] == want, f"phase 4c: {name} path launched "
              f"{k} {runs[name][1][k]} times, want {want}")
    hot_model = {"rows": rows, "kept_layers": int(pmask.sum()),
                 "masked_multitask_hadamard_launches": n_calls}
    for other in ("plain", "static"):
        worst = 0.0
        for step, (a, r) in enumerate(zip(runs["kernel"][0], runs[other][0])):
            check(a.shape == (3, 1, cfg32.vocab_size)
                  and bool(torch.isfinite(a).all()),
                  f"phase 4c logits {tuple(a.shape)}")
            diff, top = (a - r).abs().max().item(), r.abs().max().item()
            check(diff <= 1e-3 * top, f"phase 4c step {step}: |kernel - "
                  f"{other}| {diff:.3g} > 1e-3 x {top:.3g}")
            worst = max(worst, diff / top)
        hot_model[f"kernel_vs_{other}"] = worst
    pruned_vs_dense = (runs["kernel"][0][0][0] - runs["kernel"][0][0][1]
                       ).abs().max().item()
    log(f"[4c] qwen3-0.6b fp32, {cfg32.n_layers} layers, a 3-row hot-swap "
        f"bank (pruned tenant, top {int(pmask.sum())} layers; dense tenant; "
        f"unloaded row): prefill + 4 decode steps, {n_calls} "
        f"masked_multitask_hadamard launches and no multitask or fused one; "
        f"kernel path vs plain path max |diff| / max|ref| = "
        f"{hot_model['kernel_vs_plain']:.3g}, vs the static bank (#6) of the "
        f"same tenants {hot_model['kernel_vs_static']:.3g} (tol 1e-3); "
        f"pruned vs dense tenant prefill logits differ by {pruned_vs_dense:.3g}")
    del base32, dense32, pruned32, hot, static, model, runs, caches, gates
    torch.cuda.empty_cache()
    phase_done("4c")

    # -- phase 4p: the fp32 model over a paged pool, kernel path vs plain ---
    # two rows of 128-token prompts whose first page sits in the pool (a
    # prefix-cache hit): the 112-token suffix extended in place, two decode
    # steps and a verify of k+1 = 5 tokens per row, over an fp32 pool (the
    # model's own), a bf16, an int8 and an e4m3 one, through the kernels
    # (#5 and #3 in every layer of every call, no #4) and through the plain
    # versions; then the paged decode against the contiguous one on the
    # same K/V bits (the same pages and split plan: equal), the extend
    # against a cold prefill of the prompt, and greedy speculation (self
    # draft, k = 4) against plain greedy decoding, token for token, over
    # the slot caches and over the pool
    from repro_torch.serving import Request

    page4, P4, k4 = 16, SERVE["prompt_len"], 4
    nbt4 = SERVE["max_len"] // page4
    L4 = cfg32.n_layers
    base4 = launcher.build_base(cfg32, 1, dev)
    tuned4 = launcher.task_variants(base4, 1, 1)[0]
    eng = ServeEngine(cfg32, tuned4, device=dev)
    V4 = cfg32.vocab_size
    toks = torch.randint(10, V4, (2, P4), generator=gen, device=dev)
    tables4 = (torch.randperm(2 * nbt4, generator=gen, device=dev) + 1
               ).to(torch.int32).reshape(2, nbt4)
    step_toks = [torch.randint(10, V4, (2, 1), generator=gen, device=dev)
                 for _ in range(2)]
    vtoks = torch.randint(10, V4, (2, k4 + 1), generator=gen, device=dev)
    per_call = {name: 0 for name in _build.launch_counts()}
    per_call.update(paged_attention=L4, fused_adapter_norm=L4)

    from repro_torch.quant.qtensor import QTensor, is_qtensor

    def clone_pool(pool):
        return [{n: (QTensor(leaf.values.clone(), leaf.scales.clone())
                     if is_qtensor(leaf) else leaf.clone())
                 for n, leaf in layer.items()} for layer in pool]

    def paged_calls(pool):
        """The extend of each row, two decode steps and a verify, each
        through the kernels on `pool` (which carries on) and through the
        plain versions on a copy of the same pool, so both start from the
        same K/V bits: [(kernel logits, plain logits, kernel launches,
        plain launches)] a call. (Run apart, a quantized pool's K/V would
        part from the first 1e-6 difference that moves a value across a
        rounding edge of int8 or e4m3.)"""
        out = []

        def call(fn):
            res = []
            for impl, p in (("auto", pool), ("ref", clone_pool(pool))):
                _build.reset_launches()
                with torch.no_grad():
                    lg, _ = fn(p, impl)
                torch.cuda.synchronize()
                res += [lg, _build.launch_counts()]
            out.append(res)

        for b in range(2):
            with torch.no_grad():
                _, fresh = M.prefill_lm(eng.params, cfg32,
                                        toks[b:b + 1, :page4], page4)
            eng.paged_insert(pool, fresh, tables4[b, :1].cpu().numpy())
            call(lambda p, impl: M.extend_lm(
                eng.params, cfg32, p, toks[b:b + 1, page4:],
                tables4[b:b + 1], page4, P4, P4 - page4 - 1, impl=impl))
        for i, t in enumerate(step_toks):
            call(lambda p, impl: M.decode_lm_paged(
                eng.params, cfg32, p, t,
                torch.full((2,), P4 + i, device=dev), tables4, impl=impl))
        call(lambda p, impl: M.verify_lm_paged(
            eng.params, cfg32, p, vtoks,
            torch.full((2,), P4 + 2, device=dev), tables4, impl=impl))
        return out

    paged_model = {}
    for kind, pcfg4, quant in (
            ("fp32", cfg32, None),
            ("bf16", cfg32.replace(compute_dtype="bfloat16"), None),
            ("int8", cfg32, "int8"), ("fp8", cfg32, "fp8")):
        pool = M.init_paged_pool(pcfg4, 2 * nbt4 + 1, page4, quant, dev)
        calls = paged_calls(pool)
        worst = 0.0
        for i, (a, ca, r, cr) in enumerate(calls):
            check(a.shape == r.shape and bool(torch.isfinite(a).all()),
                  f"phase 4p {kind} call {i}: logits {tuple(a.shape)}")
            diff, top = (a - r).abs().max().item(), r.abs().max().item()
            check(diff <= 1e-3 * top, f"phase 4p {kind} call {i}: |kernel "
                  f"- plain| {diff:.3g} > 1e-3 x {top:.3g}")
            worst = max(worst, diff / top)
            check(ca == per_call and not any(cr.values()),
                  f"phase 4p {kind} call {i}: launches {ca} (plain {cr}), "
                  f"want {per_call}")
        paged_model[kind] = {"kernel_vs_plain": worst,
                             "extend_logits": [c[0] for c in calls[:2]]}
        del calls, pool
    # the extend (fp32 pool, kernel path) against a cold prefill of the
    # whole prompt; the paged decode against the contiguous one
    with torch.no_grad():
        cold, fresh = M.prefill_lm(eng.params, cfg32, toks, P4)
    ext = torch.cat(paged_model["fp32"].pop("extend_logits"))
    for kind in ("bf16", "int8", "fp8"):
        del paged_model[kind]["extend_logits"]
    ext_err = ((ext - cold).abs().max() / cold.abs().max()).item()
    check(ext_err <= 1e-3, f"phase 4p: extend vs a cold prefill {ext_err:.3g}"
                           " of max|logit| (tol 1e-3)")
    pool = M.init_paged_pool(cfg32, 2 * nbt4 + 1, page4, None, dev)
    for b in range(2):
        eng.paged_insert(pool, [{n: f[n][b:b + 1] for n in f} for f in fresh],
                         tables4[b, :P4 // page4].cpu().numpy())
    caches = eng.init_slot_caches(2, SERVE["max_len"])
    for c, f in zip(caches, fresh):
        for n in c:
            c[n][:, :P4].copy_(f[n])
    with torch.no_grad():
        for i, t in enumerate(step_toks):
            pos = torch.full((2,), P4 + i, device=dev)
            a, _ = M.decode_lm_paged(eng.params, cfg32, pool, t, pos, tables4)
            c_, _ = M.decode_lm(eng.params, cfg32, caches, t, pos)
            check(torch.equal(a, c_), f"phase 4p: paged decode step {i} is "
                  f"not the contiguous one (max |diff| "
                  f"{(a - c_).abs().max().item():.3g})")
    del pool, caches, fresh, eng
    # speculation: the backbone's row (every draft accepted) and a tuned
    # row (drafts rejected) in one tick
    bank4 = MultiTaskEngine(cfg32, [base4, tuned4], device=dev)
    rs4 = np.random.RandomState(4)
    reqs4 = [Request(prompt=rs4.randint(10, V4, 64), max_new_tokens=16,
                     task_id=i % 2) for i in range(4)]
    want4, rep4 = make_scheduler(bank4, ServingConfig(num_slots=4,
                                                      max_len=96)).run(reqs4)
    for tag, kw in (("slots", {}), ("paged", dict(paged=True))):
        sched = make_scheduler(bank4, ServingConfig(num_slots=4, max_len=96,
                                                    spec_k=k4, **kw))
        done, rep = sched.run(reqs4)
        for w, c in zip(want4, done):
            check(np.array_equal(w.tokens, c.tokens),
                  f"phase 4p: speculation over the {tag} gave {c.tokens}, "
                  f"plain greedy {w.tokens} (request {c.request_id})")
        paged_model[f"spec_{tag}"] = dict(sched.spec_stats,
                                          acceptance=sched.acceptance_rate,
                                          ticks=rep["ticks"],
                                          plain_ticks=rep4["ticks"])
    by_pool = {k: paged_model[k]["kernel_vs_plain"]
               for k in ("fp32", "bf16", "int8", "fp8")}
    paged_model.update(extend_vs_cold_prefill=ext_err,
                       paged_equals_contiguous_decode=True)
    log(f"[4p] qwen3-0.6b fp32, {L4} layers, paged pool: extend (112 tokens "
        f"after a shared page), 2 decode steps, a verify of {k4 + 1}, each "
        f"with {L4} #5 + {L4} #3 and no #4; kernel vs plain max |diff| / "
        f"max|ref| by pool {json.dumps(by_pool)} "
        f"(tol 1e-3); extend vs cold prefill {ext_err:.3g}; paged decode "
        f"equal to the contiguous one; speculation (k={k4}, self draft) "
        f"token for token plain greedy over slots "
        f"{paged_model['spec_slots']} and pool {paged_model['spec_paged']}")
    del bank4, base4, tuned4, sched
    torch.cuda.empty_cache()
    phase_done("4p")

    # -- phase 4r: full-width rwkv6-1.6b in fp32, kernel path vs plain path -
    # every layer's recurrence through #8 at prefill and at decode (the
    # state carried in the cache), the adapter seam through #3 (one
    # adapter), #6 (a 3-task bank) or #9 (a 3-row hot-swap bank holding a
    # pruned tenant, top 16 of 24 layers, a dense one and an unloaded row);
    # and over an int8-quantized trunk, where only the untied LM head
    # matches the quantization table: one #7 per step
    cfg32r = launcher.build_config(RWKV_ARCH).replace(
        param_dtype="float32", compute_dtype="float32")
    Lr = cfg32r.n_layers
    rwkv_model = {}

    def rwkv_vs_plain(tag, params, tids, gates, want):
        """A 128-token prefill and 4 decode steps of `params` through the
        kernels and through the plain versions: logits and final states
        within 1e-3 of the plain path's max, and the kernel path's launches
        exactly `want` (every other kernel 0; the plain path none)."""
        toks = torch.randint(10, cfg32r.vocab_size, (2, SERVE["prompt_len"]),
                             generator=gen, device=dev)
        runs = {}
        with torch.no_grad():
            for impl in ("auto", "ref"):
                _build.reset_launches()
                lg, caches = M.prefill_lm(params, cfg32r, toks,
                                          SERVE["max_len"], task_ids=tids,
                                          gates=gates, impl=impl)
                out = [lg]
                for i in range(4):
                    tok = torch.randint(10, cfg32r.vocab_size, (2, 1),
                                        generator=torch.Generator(device=dev)
                                        .manual_seed(i), device=dev)
                    pos = torch.full((2,), SERVE["prompt_len"] + i, device=dev)
                    lg, caches = M.decode_lm(params, cfg32r, caches, tok, pos,
                                             task_ids=tids, gates=gates,
                                             impl=impl)
                    out.append(lg)
                torch.cuda.synchronize()
                runs[impl] = (out, _build.launch_counts(), caches)
        for impl in ("auto", "ref"):
            for k, n in runs[impl][1].items():
                w = want.get(k, 0) if impl == "auto" else 0
                check(n == w, f"phase 4r ({tag}): {impl} path launched {k} "
                              f"{n} times, want {w}")
        worst = 0.0
        for step, (a, r) in enumerate(zip(runs["auto"][0], runs["ref"][0])):
            check(a.shape == (2, 1, cfg32r.vocab_size)
                  and bool(torch.isfinite(a).all()),
                  f"phase 4r logits {tuple(a.shape)}")
            diff, top = (a - r).abs().max().item(), r.abs().max().item()
            check(diff <= 1e-3 * top, f"phase 4r step {step} ({tag}): "
                  f"|kernel - plain| {diff:.3g} > 1e-3 x {top:.3g}")
            worst = max(worst, diff / top)
        state_diff = max(
            (ca["S"] - cr["S"]).abs().max().item()
            / cr["S"].abs().max().item()
            for ca, cr in zip(runs["auto"][2], runs["ref"][2]))
        check(state_diff <= 1e-3, f"phase 4r ({tag}): final states differ "
                                  f"by {state_diff:.3g} of their max")
        launched = {k: n for k, n in runs["auto"][1].items() if n}
        rwkv_model[tag] = {"kernel_vs_plain": worst,
                           "state_kernel_vs_plain": state_diff,
                           "launches": launched}
        log(f"[4r] {RWKV_ARCH} fp32, {Lr} layers, {tag}: a "
            f"{SERVE['prompt_len']}-token prefill + 4 decode steps, launches "
            f"{launched}; kernel path vs plain path max |diff| / max|ref| = "
            f"{worst:.3g} (tol 1e-3), final states {state_diff:.3g}")

    steps = 5  # the prefill and 4 decode steps
    for tasks in (0, TASKS):
        eng = launcher.build_engine(cfg32r, seed=1, tasks=tasks, device=dev)
        tids = torch.tensor([0, TASKS - 1], dtype=torch.int32, device=dev) \
            if tasks else None
        seam = "multitask_hadamard" if tasks else "fused_adapter_norm"
        rwkv_vs_plain("bank" if tasks else "single", eng.params, tids, None,
                      {"wkv6": steps * Lr, seam: steps * Lr})
        del eng
        torch.cuda.empty_cache()
    base32r = launcher.build_base(cfg32r, 1, dev)
    dense32r, pruned32r = launcher.task_variants(base32r, 1, 2)
    pmask_r = preset_mask(cfg32r)
    check(int(pmask_r.sum()) == 16 and pmask_r[8:].all(),
          f"phase 4r: paper-0.022 keeps {int(pmask_r.sum())} of {Lr}")
    pruned32r = apply_layer_mask(pruned32r, cfg32r, pmask_r)
    with tempfile.TemporaryDirectory() as td:
        reg = AdapterRegistry(td)
        reg.publish("pruned", launcher.task_delta(pruned32r, cfg32r, pmask_r))
        reg.publish("dense", launcher.task_delta(dense32r, cfg32r))
        hot = MultiTaskEngine(cfg32r, AdapterBank(cfg32r, base32r, 3, reg),
                              device=dev)
        rows = [hot.adapter_bank.lookup(n) for n in ("pruned", "dense")]
    check(rows == [0, 1], f"phase 4r: bank rows {rows}")
    rwkv_vs_plain("hot_swap", hot.params,
                  torch.tensor([0, 1], dtype=torch.int32, device=dev),
                  hot.adapter_bank.gate_tensor,
                  {"wkv6": steps * Lr,
                   "masked_multitask_hadamard": steps * Lr})
    del hot
    qeng = ServeEngine(cfg32r, dense32r, quant="int8", device=dev)
    check(quant_summary(qeng.params)["n_quantized_leaves"] == 1,
          "phase 4r: int8 rwkv6 quantized more than the LM head")
    rwkv_vs_plain("int8", qeng.params, None, None,
                  {"wkv6": steps * Lr, "fused_adapter_norm": steps * Lr,
                   "dequant_matmul": steps})
    del qeng, base32r, dense32r, pruned32r
    torch.cuda.empty_cache()
    phase_done("4r")

    def profile_calls(fn, n, warm=3):
        """Where the time of a call goes: host wall ms per call (each ending
        in a device sync), the device's busy share of it, the kernels that
        take the device time, and the device us per call of each of the
        port's own kernels (the __global__ functions of csrc/), from
        torch.profiler tracing device activity alone: nothing here reads
        the host's op events, and collecting them took about 1 ms a kernel
        (two rwkv6 train steps of 38,000 kernels each, ~75 s). `warm` calls
        run first (1 where fn's run has just warmed it, a train step)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
            torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) * 1e3 / n
        # device-side events only: each kernel once (an aten op's entry
        # repeats the device time of the kernels it launched), read from
        # the profiler's raw events: key_averages() first builds the host
        # event tree, ~0.17 ms a kernel (PERF.md section 6). The events
        # should hold every launch the wrappers counted: a profile that
        # lost one under-counts the device time. Late in a long process
        # each profile lost up to 3 of the port's kernels, the same count
        # whatever its length (PERF.md section 6), so one more call runs at
        # each end of the window, a spin kernel marks the n calls off
        # from them, and only the events between the marks count. A
        # profile short of a counted launch is taken again, up to 3 times;
        # the last may lack at most 3 launches of a kernel, or 2 %, and its
        # shortfall is reported
        for attempt in range(1, 4):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda._sleep(1)
                torch.cuda.synchronize()
                before = _build.launch_counts()
                for _ in range(n):
                    fn()
                    torch.cuda.synchronize()
                after = _build.launch_counts()
                torch.cuda._sleep(1)
                fn()
                torch.cuda.synchronize()
            evs = [e for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA]
            marks = sorted(e.start_ns() for e in evs  # torch.cuda._sleep's
                           if "spin" in e.name() or "sleep" in e.name())
            dev_us, launches, seen = {}, 0, {}
            for e in evs:
                if len(marks) == 2 and marks[0] < e.start_ns() < marks[1]:
                    dev_us[e.name()] = (dev_us.get(e.name(), 0.0)
                                        + e.duration_ns() / 1e3 / n)
                    launches += 1
                    for fn_name in re.findall(r"::(\w+)[<(]", e.name())[:1]:
                        seen[fn_name] = seen.get(fn_name, 0) + 1
            short = {k: (after[k] - before[k],
                         sum(seen.get(f, 0) for f in ks))
                     for k, ks in entry_kernels.items()}
            short = {k: v for k, v in short.items() if v[0] != v[1]}
            if len(marks) == 2 and not short:
                break
            log(f"profile: attempt {attempt} of {n} calls: {len(marks)} "
                f"marks, short of the counted launches (counted, seen): "
                f"{short}")
        check(len(marks) == 2 and all(
            seen_ >= min(counted - 3, 0.98 * counted)
            for counted, seen_ in short.values()),
            f"profile: 3 profiles of {n} calls each lost launches: "
            f"{len(marks)} marks, (counted, seen): {short}")
        busy_ms = sum(dev_us.values()) / 1e3
        top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:10]
        # summed over a kernel's template instantiations
        port_us = {}
        for k, v in dev_us.items():
            for fn_name in re.findall(r"::(\w+)[<(]", k)[:1]:
                if fn_name in port_kernels:
                    port_us[fn_name] = port_us.get(fn_name, 0.0) + v
        return {"ms": call_ms, "device_ms": busy_ms if dev_us else None,
                "profile_attempts": attempt, "events_short": short,
                "device_busy_share": busy_ms / call_ms if dev_us else None,
                "device_kernels": launches / n,
                "top_device_us": [[k[:80], v] for k, v in top],
                "port_kernel_us": port_us}

    def check_profiled(phase, tick, per_tick):
        """#7 and #8 run one of several kernels by plan: a tick that
        launched either shows device time for the __global__ functions of
        its source, summed over them, in the tick's profile."""
        for name in ("dequant_matmul", "wkv6"):
            if any(per_tick[name]):
                found = source_kernels[name + ".cu"]
                us = sum(tick["port_kernel_us"].get(k, 0.0) for k in found)
                check(us > 0, f"phase {phase}: {name} launched "
                              f"{per_tick[name]} a tick, but the tick's "
                              f"profile shows no device time in "
                              f"{sorted(found)}")

    def profile_prefill(eng):
        """profile_calls of one 128-token prefill into fresh caches, as the
        scheduler admits a request (bank row 0)."""
        prompt = np.full((1, SERVE["prompt_len"]), 11, np.int64)
        return profile_calls(lambda: eng.prefill(
            prompt, SERVE["max_len"], task_ids=np.asarray([0])), 3)

    def count_per_call(eng, names=("prefill", "decode_step")):
        """Record each call's own launches in the run that follows (by
        default each engine prefill's and decode step's): wraps the methods
        `names` on this instance and returns {method: [launch-count change
        per call]}."""
        per_call = {name: [] for name in names}
        for name, calls in per_call.items():
            def wrapped(*a, _fn=getattr(eng, name), _calls=calls, **kw):
                before = _build.launch_counts()
                out = _fn(*a, **kw)
                after = _build.launch_counts()
                _calls.append({k: after[k] - before[k] for k in after})
                return out
            setattr(eng, name, wrapped)
        return per_call

    def check_serve_run(phase, per_call, rep, done, counts, sched, need,
                        run_cfg):
        """The checks every serve run passes: each request retires with its
        whole budget of tokens in `run_cfg`'s vocabulary, every leaf of the
        slot caches (K/V, or an RWKV6 layer's state) stays finite, every
        launch happened inside a prefill or a decode step, and each kernel
        of `need` launched. Returns the distinct launch counts per decode
        tick and per prefill of each kernel, e.g. {"paged_attention":
        [28]}."""
        check(len(per_call["decode_step"]) == rep["ticks"],
              f"phase {phase}: {len(per_call['decode_step'])} decode steps "
              f"counted, {rep['ticks']} ticks reported")
        for k in counts:
            check(sum(c[k] for calls in per_call.values() for c in calls)
                  == counts[k],
                  f"phase {phase}: {k} launched outside prefill and decode")
        check(len(done) == SERVE["requests"], f"phase {phase}: "
              f"{len(done)} completions")
        for c in done:
            check(len(c.tokens) == SERVE["new_tokens"]
                  and c.finish_reason == "length",
                  f"phase {phase}: request {c.request_id} retired with "
                  f"{len(c.tokens)} tokens ({c.finish_reason})")
            check(bool(((c.tokens >= 0)
                        & (c.tokens < run_cfg.vocab_size)).all()),
                  f"phase {phase}: token ids out of range")
        check(all(bool(torch.isfinite(leaf.float()).all())
                  for c in sched.caches for leaf in c.values()),
              f"phase {phase}: non-finite cache")
        for k in need:
            check(counts[k] > 0,
                  f"phase {phase}: kernel {k} never launched on the serve path")
        return ({k: sorted({c[k] for c in per_call["decode_step"]})
                 for k in counts},
                {k: sorted({c[k] for c in per_call["prefill"]})
                 for k in counts})

    def exact_latency(done):
        """The exact p50 and max TTFT and token gap (a request's mean gap
        between its output tokens) over the completions `done`, seconds:
        the figures of PERF.md §5 (the report's p50/p95/p99 are histogram
        estimates, over every request since the scheduler was built)."""
        ttft = np.array([c.ttft_s for c in done], np.float64)
        gap = np.array([(c.latency_s - c.ttft_s) / (len(c.tokens) - 1)
                        for c in done if len(c.tokens) > 1], np.float64)

        def stat(a, fn):
            return float(fn(a)) if a.size else 0.0

        return {"ttft_p50_exact_s": stat(ttft, np.median),
                "ttft_max_s": stat(ttft, np.max),
                "tpot_p50_exact_s": stat(gap, np.median),
                "tpot_max_s": stat(gap, np.max)}

    def serve_line(rep, done):
        ex = exact_latency(done)
        return (f"{rep['requests']} requests / {rep['tokens']} tokens, "
                f"{rep['ticks']} ticks, {rep['requests_per_s']:.3f} req/s, "
                f"{rep['tokens_per_s']:.1f} tok/s, TTFT mean/p50/max "
                f"{rep['mean_ttft_s'] * 1e3:.1f}/"
                f"{ex['ttft_p50_exact_s'] * 1e3:.1f}/"
                f"{ex['ttft_max_s'] * 1e3:.1f} ms (histogram p50/p95/p99 "
                f"{rep['ttft_p50_s'] * 1e3:.1f}/{rep['ttft_p95_s'] * 1e3:.1f}/"
                f"{rep['ttft_p99_s'] * 1e3:.1f}), token gap p50/max "
                f"{ex['tpot_p50_exact_s'] * 1e3:.1f}/"
                f"{ex['tpot_max_s'] * 1e3:.1f} ms (histogram p50/p95/p99 "
                f"{rep['tpot_p50_s'] * 1e3:.1f}/{rep['tpot_p95_s'] * 1e3:.1f}/"
                f"{rep['tpot_p99_s'] * 1e3:.1f}), host s in prefill/decode "
                f"{rep['prefill_s']:.3f}/{rep['decode_s']:.3f}")

    # -- phases 5-6: serving at full width, bf16; 5q, 6q, 5f: quantized -----
    masked_name = "masked_multitask_hadamard"
    cfg = launcher.build_config(ARCH)
    launches = {}
    serve_reports = {}
    tokens_of = {}  # phase -> each request's greedy tokens
    n_dq = 7 * cfg.n_layers  # quantized projections of one step
    SERVE_RUNS = (("5", 0, None), ("6", TASKS, None), ("5q", 0, "int8"),
                  ("6q", TASKS, "int8"), ("5f", 0, "fp8"))
    for phase, tasks, quant in SERVE_RUNS:
        # device memory of the engine and of its run: allocated bytes above
        # what the earlier phases still hold
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        eng = launcher.build_engine(cfg, seed=SERVE["seed"], tasks=tasks,
                                    device=dev, quant=quant)
        torch.cuda.synchronize()
        weights_bytes = torch.cuda.memory_allocated() - held
        torch.cuda.reset_peak_memory_stats()
        reqs = launcher.make_requests(cfg, SERVE["requests"],
                                      SERVE["prompt_len"], SERVE["new_tokens"],
                                      tasks, SERVE["seed"])
        scfg = ServingConfig(num_slots=SERVE["num_slots"],
                             max_len=SERVE["max_len"], backbone_quant=quant)
        make_scheduler(eng, scfg).run([dataclasses.replace(
            r, max_new_tokens=2) for r in reqs[:2]])  # warm-up
        sched = make_scheduler(eng, scfg)
        per_call = count_per_call(eng)
        torch.cuda.synchronize()
        _build.reset_launches()
        done, rep = sched.run(reqs)
        torch.cuda.synchronize()
        launches[phase] = _build.launch_counts()
        peak_bytes = torch.cuda.max_memory_allocated() - held
        del eng.prefill, eng.decode_step  # back to the class's methods
        per_tick, per_prefill = check_serve_run(
            phase, per_call, rep, done, launches[phase], sched,
            ("fused_adapter_norm", "flash_attention", "paged_attention")
            if tasks == 0 else
            ("multitask_hadamard", "flash_attention", "paged_attention"), cfg)
        tokens_of[phase] = {c.request_id: c.tokens for c in done}
        check(per_tick[masked_name] == [0] == per_prefill[masked_name],
              f"phase {phase}: {masked_name} launched without a hot-swap bank")
        want_dq = [n_dq] if quant else [0]
        check(per_tick["dequant_matmul"] == want_dq
              and per_prefill["dequant_matmul"] == want_dq,
              f"phase {phase}: dequant_matmul per decode tick "
              f"{per_tick['dequant_matmul']}, per prefill "
              f"{per_prefill['dequant_matmul']}, want {want_dq}")
        extra = {"weights_bytes_allocated": weights_bytes,
                 "peak_bytes_allocated": peak_bytes}
        if quant:
            qs = quant_summary(eng.params)
            base = "5" if tasks == 0 else "6"
            same = [float((tokens_of[phase][i] == tokens_of[base][i]).mean())
                    for i in sorted(tokens_of[phase])]
            extra.update(
                quant=quant, quant_line=launcher.quant_line(eng),
                quantized_bytes=qs["quantized_bytes"],
                dense_bytes_fp32=qs["dense_bytes_fp32"],
                tree_bytes=qs["total_bytes"],
                greedy_agreement_with_bf16_ungated=sum(same) / len(same),
                peak_bytes_vs_bf16=peak_bytes
                / serve_reports[base]["peak_bytes_allocated"],
                weights_bytes_vs_bf16=weights_bytes
                / serve_reports[base]["weights_bytes_allocated"])
        # the profile of a 4-slot decode tick
        slots = SERVE["num_slots"]
        caches = eng.init_slot_caches(slots, SERVE["max_len"])
        args = ([[11]] * slots, [140 + i for i in range(slots)])
        stids = [t % max(tasks, 1) for t in range(slots)]
        tick = profile_calls(
            lambda: eng.decode_step(caches, *args, task_ids=stids), 8)
        check_profiled(phase, tick, per_tick)
        del caches
        pre = profile_prefill(eng)
        check_profiled(phase, pre, per_prefill)
        serve_reports[phase] = dict(rep, launches_per_decode_tick=per_tick,
                                    launches_per_prefill=per_prefill,
                                    tick=tick, prefill=pre, **extra,
                                    **exact_latency(done))
        kind = ("single-tenant" if tasks == 0 else f"{tasks}-task bank") + \
            (f", {quant} backbone" if quant else "")
        log(f"[{phase}] serve {kind} on {smi}: {serve_line(rep, done)}; "
            f"launches {launches[phase]}; "
            f"per decode tick {per_tick}; per prefill {per_prefill}; "
            f"memory {json.dumps(extra)}; decode tick {tick}")
        del eng, sched
        torch.cuda.empty_cache()
        phase_done(phase)

    # -- phases 5p, 5pq, 5pf, 5s, 5sp, 6p: paged KV and speculation, bf16 ---
    # 8 requests x (128 + 32 greedy) on 4 slots of 512 tokens in 16-token
    # pages (`_auto_blocks`: 193 blocks). The prompts share a 96-token
    # prefix; requests 4-5 repeat prompts 0-1 and 6-7 share the prefix
    # alone, so, prompts being published when they retire, the admissions
    # are 0-3 cold, 4-5 whole-prompt hits and 6-7 prefix hits (a 32-token
    # extend). 5p: bf16 blocks; 5pq, 5pf: int8, e4m3 blocks; 5s, 5sp: self
    # speculation (k = 4) over the slot caches and over the pool, the same
    # prompts with budgets of SERVE["spec_new_tokens"] (a verify tick is 6
    # forwards; more of them repeat the same checks); 6p: a
    # 3-task bank (#6) on the launcher's traffic with requests 4-5
    # repeating prompts 0-1 under other tasks, so every admission is cold.
    # Launches per call, predicted: a cold prefill 28 #4 + 28 seam (#3, or
    # #6 over a bank); an extend 28 #5 + 28 seam and no #4; a whole-prompt
    # hit none; a decode tick 28 #5 + 28 seam; a verify tick 28 #5 + 28
    # seam and the k+1 = 5 draft steps' 5 x (28 #5 + 28 #3); a draft
    # lane's admission 28 #4 + 28 #3
    k_s, Ls = 4, cfg.n_layers
    rs = np.random.RandomState(SERVE["seed"])
    V = cfg.vocab_size
    stem = rs.randint(10, V, 96)
    tail = lambda: rs.randint(10, V, SERVE["prompt_len"] - 96)  # noqa: E731
    pprompts = [np.concatenate([stem, tail()]) for _ in range(4)]
    pprompts += pprompts[:2] + [np.concatenate([stem, tail()])
                                for _ in range(2)]

    def kernels(**nonzero):
        out = {name: 0 for name in _build.launch_counts()}
        out.update(nonzero)
        return out

    def pool_leaves(pool):
        """Every tensor of per-layer caches or block pools (a quantized
        block's payload and scales)."""
        return [t for layer in pool for leaf in layer.values()
                for t in ((leaf.values, leaf.scales) if is_qtensor(leaf)
                          else (leaf,))]

    def pool_bytes(pool):
        return sum(t.numel() * t.element_size() for t in pool_leaves(pool))

    def pool_finite(pool):
        return all(bool(torch.isfinite(t.float()).all())
                   for t in pool_leaves(pool))

    PAGED_RUNS = (("5p", 0, dict(paged=True)),
                  ("5pq", 0, dict(paged=True, kv_quant="int8")),
                  ("5pf", 0, dict(paged=True, kv_quant="fp8")),
                  ("5s", 0, dict(spec_k=k_s)),
                  ("5sp", 0, dict(paged=True, spec_k=k_s)),
                  ("6p", TASKS, dict(paged=True)))
    want_stats = {"full_hits": 2, "partial_hits": 2, "cold": 4}
    ref_tokens = {}
    eng = pre_of = None
    for phase, tasks, feat in PAGED_RUNS:
        if eng is None or eng_tasks != tasks:
            eng = pre_of = None
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            eng, eng_tasks = launcher.build_engine(
                cfg, seed=SERVE["seed"], tasks=tasks, device=dev), tasks
            torch.cuda.synchronize()
            weights_bytes = torch.cuda.memory_allocated() - held
            if tasks:
                preqs = launcher.make_requests(
                    cfg, SERVE["requests"], SERVE["prompt_len"],
                    SERVE["new_tokens"], tasks, SERVE["seed"])
                for i in (4, 5):
                    preqs[i].prompt = preqs[i - 4].prompt
            else:
                preqs = [Request(prompt=p, max_new_tokens=SERVE["new_tokens"])
                         for p in pprompts]
            # the contiguous scheduler on the same prompts (and warm-up)
            ref_done, ref_rep = make_scheduler(eng, ServingConfig(
                num_slots=SERVE["num_slots"],
                max_len=SERVE["max_len"])).run(preqs)
            ref_tokens = {c.request_id: c.tokens for c in ref_done}
        seam = "multitask_hadamard" if tasks else "fused_adapter_norm"
        torch.cuda.reset_peak_memory_stats()
        sched = make_scheduler(eng, ServingConfig(
            num_slots=SERVE["num_slots"], max_len=SERVE["max_len"], **feat))
        paged, spec = feat.get("paged", False), "spec_k" in feat
        budget = SERVE["spec_new_tokens"] if spec else SERVE["new_tokens"]
        run_reqs = [dataclasses.replace(r, max_new_tokens=budget)
                    for r in preqs]
        tick_call = (("paged_verify_step" if paged else "verify_step") if spec
                     else "paged_decode_step")
        per_call = count_per_call(eng, ("prefill", "paged_extend", tick_call))
        lane_calls = (count_per_call(sched.draft_lane, ("draft", "admit"))
                      if spec else {})
        torch.cuda.synchronize()
        _build.reset_launches()
        done, rep = sched.run(run_reqs)
        torch.cuda.synchronize()
        launches[phase] = _build.launch_counts()
        peak_bytes = torch.cuda.max_memory_allocated() - held
        for name in per_call:
            delattr(eng, name)
        # every launch inside a counted call, each call as predicted
        all_calls = {**per_call, **lane_calls}
        for k in launches[phase]:
            check(sum(c[k] for calls in all_calls.values() for c in calls)
                  == launches[phase][k],
                  f"phase {phase}: {k} launched outside the counted calls")
        want_call = {
            "prefill": kernels(flash_attention=Ls, **{seam: Ls}),
            "paged_extend": kernels(paged_attention=Ls, **{seam: Ls}),
            tick_call: kernels(paged_attention=Ls, **{seam: Ls}),
            "draft": kernels(paged_attention=(k_s + 1) * Ls,
                             fused_adapter_norm=(k_s + 1) * Ls),
            "admit": kernels(flash_attention=Ls, fused_adapter_norm=Ls)}
        for name, calls in all_calls.items():
            bad = [c for c in calls if c != want_call[name]]
            check(not bad, f"phase {phase}: {name} launched {bad[:1]}, want "
                           f"{want_call[name]} a call")
        check(len(per_call[tick_call]) == rep["ticks"]
              and len(lane_calls.get("draft", per_call[tick_call]))
              == rep["ticks"], f"phase {phase}: {len(per_call[tick_call])} "
              f"{tick_call} calls over {rep['ticks']} ticks")
        check(len(done) == SERVE["requests"] and all(
            len(c.tokens) == budget and c.finish_reason == "length"
            and bool(((c.tokens >= 0) & (c.tokens < V)).all()) for c in done),
            f"phase {phase}: requests retired as "
            f"{[(len(c.tokens), c.finish_reason) for c in done]}")
        check(pool_finite(sched.pool if paged else sched.caches),
              f"phase {phase}: non-finite KV")
        same = [float((c.tokens == ref_tokens[c.request_id][:budget]).mean())
                for c in done]
        extra = {"weights_bytes_allocated": weights_bytes,
                 "peak_bytes_allocated": peak_bytes,
                 "agreement_with_contiguous": same,
                 "reference_ticks": ref_rep["ticks"]}
        if paged:
            stats = sched.stats
            want = ({"full_hits": 0, "partial_hits": 0, "cold": 8} if tasks
                    else want_stats)
            check(stats == want, f"phase {phase}: admissions {stats}, "
                                 f"predicted {want}")
            check(len(per_call["prefill"]) == stats["cold"]
                  and len(per_call["paged_extend"]) == stats["partial_hits"],
                  f"phase {phase}: {len(per_call['prefill'])} prefills, "
                  f"{len(per_call['paged_extend'])} extends for {stats}")
            report_before = sched.pool_report()
            sched.prefix.clear(sched.alloc)
            pr = sched.pool_report()
            check(pr["live_blocks"] == 0 and pr["reserved_blocks"] == 0,
                  f"phase {phase}: pool {pr} after clearing the prefix cache")
            extra.update(pool_bytes=pool_bytes(sched.pool),
                         pool_report=report_before, admissions=stats,
                         pool_line=launcher.outcome_lines(sched)[-1])
        if phase in ("5p", "6p"):
            # cold and whole-prompt hits: the contiguous scheduler's tokens
            exact = [i for i in range(8) if tasks or i < 6]
            check(all(same[i] == 1.0 for i in exact),
                  f"phase {phase}: agreement with the contiguous scheduler "
                  f"{same} (requests {exact} must be equal)")
        if phase in ("5pq", "5pf"):
            extra.update(
                pool_bytes_vs_bf16=extra["pool_bytes"]
                / serve_reports["5p"]["pool_bytes"],
                top1_agreement_with_5p=float(np.mean([
                    (c.tokens == tokens_of["5p"][c.request_id]).mean()
                    for c in done])))
            check(0.5 <= extra["pool_bytes_vs_bf16"] <= 0.54,
                  f"phase {phase}: pool bytes {extra['pool_bytes_vs_bf16']:.3f}"
                  " of 5p's, want (128 + 4) / 256")
        if spec:
            extra.update(spec_stats=sched.spec_stats,
                         acceptance_rate=sched.acceptance_rate,
                         new_tokens=budget,
                         ticks_vs_5p=rep["ticks"] / serve_reports["5p"]["ticks"],
                         spec_line=launcher.outcome_lines(sched)[0])
        tokens_of[phase] = {c.request_id: c.tokens for c in done}
        # the profile of one tick at positions 140-143 over blocks 1-128
        slots = SERVE["num_slots"]
        tok_h = np.full((slots, 1), 11)
        pos_h = np.array([140 + i for i in range(slots)])
        stids = [t % max(tasks, 1) for t in range(slots)]
        tbl = np.arange(1, 1 + slots * (SERVE["max_len"] // 16),
                        dtype=np.int32).reshape(slots, -1)
        if spec:
            lane = sched.draft_lane
            target = sched.pool if paged else sched.caches

            def one_tick():
                d = lane.draft(torch.as_tensor(tok_h[:, 0], device=dev),
                               torch.as_tensor(pos_h, device=dev))
                v = torch.cat([torch.as_tensor(tok_h, device=dev), d], 1)
                if paged:
                    return eng.paged_verify_step(target, v, pos_h, tbl,
                                                 task_ids=stids)
                return eng.verify_step(target, v, pos_h, task_ids=stids)
        else:
            def one_tick():
                return eng.paged_decode_step(sched.pool, tok_h, pos_h, tbl,
                                             task_ids=stids)
        # a verify tick is 6 forwards (~14,600 kernels): 2 of them give the
        # profiler as many events as 12 decode ticks. The prefill is the
        # engine's own, whatever holds the KV: profiled once an engine
        tick = profile_calls(one_tick, 2 if spec else 8)
        if pre_of is not eng:
            pre, pre_of = profile_prefill(eng), eng
        per_tick = {k: sorted({c[k] + sum(d[k] for d in lane_calls.get(
            "draft", [])[i:i + 1]) for i, c in enumerate(per_call[tick_call])})
            for k in launches[phase]}
        per_prefill = {k: sorted({c[k] for c in per_call["prefill"]})
                       for k in launches[phase]}
        serve_reports[phase] = dict(rep, launches_per_decode_tick=per_tick,
                                    launches_per_prefill=per_prefill,
                                    tick=tick, prefill=pre, **extra,
                                    **exact_latency(done))
        log(f"[{phase}] serve {feat} {'bank of %d' % tasks if tasks else 'one adapter'} "
            f"on {smi}: {serve_line(rep, done)}; launches {launches[phase]}; per "
            f"tick {per_tick}; per prefill {per_prefill}; "
            f"{json.dumps({k: v for k, v in extra.items() if k != 'pool_report'})}; "
            f"pool {extra.get('pool_report')}; tick {tick}")
        del sched
        torch.cuda.empty_cache()
        phase_done(phase)
    del eng, pre_of
    torch.cuda.empty_cache()

    # -- phase 5a: observability and SLO admission control, full width ----
    # qwen3-0.6b over a paged pool (16-token pages, prefix cache on) with a
    # self draft at k = 4, built by make_scheduler(ServingConfig(slo=,
    # admission=), obs=). Overload: 12 requests of 5p's shape (prompts 0-3
    # distinct after the 96-token stem, 4-7 repeating them, 8-11 sharing
    # the stem alone) on 4 slots, JAX's acceptance SLO (queue depth <= 2,
    # target 0.5, windows 2 s and 10 s, a step down per breaching
    # evaluation, two healthy ones a step up) on a clock advanced 1.0 a
    # tick, so the walk is the ticks', not the host's. The ladder must walk
    # its six rungs in order, shed a probe with the typed error at level 6,
    # finish every request and recover to level 0; the loaded tokens are
    # held to an unloaded run of plain greedy decoding over the same pool
    # (spec_k = 0, which every rung must reproduce, as 4p holds; a
    # verify-tick run at k = 4 costs 30-36 s on random weights): in bf16
    # their agreement is reported, in fp32 (4p's model, TF32 off) they must
    # be equal. Then phase 5's traffic with
    # metrics on and off (one pair: the ratio is reported),
    # and the serve launcher's obs and SLO flags in-process, once: the
    # .prom text is written from the registry it returns
    from repro_torch.obs import MetricsRegistry, SLOSpec, queue_depth_max
    from repro_torch.serving import AdmissionConfig, AdmissionShedError

    LADDER = ["prefix_fill_stop", "spec_k=2", "spec_k=1", "spec_k=0",
              "defer", "shed"]
    stem5a = rs.randint(10, V, 96)
    tails5a = [np.concatenate([stem5a, rs.randint(10, V, 32)])
               for _ in range(8)]
    prompts5a = tails5a[:4] + tails5a[:4] + tails5a[4:]
    slo_launches = {}
    slo_report = {}
    t5a, t5 = {}, time.perf_counter()  # the phase's seconds by part

    class TickClock:
        def __init__(self):
            self.t = 0.0

        def __call__(self):
            return self.t

    def scfg_5a(spec_k=k_s, **kw):
        return ServingConfig(num_slots=SERVE["num_slots"],
                             max_len=SERVE["max_len"], paged=True,
                             spec_k=spec_k, **kw)

    def overload(tag, eng5, V5):
        """The overload walk and an unloaded plain run of the same requests
        over `eng5`; returns the walk's summary (the checks all passed)."""
        reqs = lambda: [Request(prompt=p, max_new_tokens=SERVE["new_tokens"])  # noqa: E731
                        for p in prompts5a]
        clk = TickClock()
        reg = MetricsRegistry()
        spec5 = SLOSpec(objectives=(queue_depth_max(2, target=0.5),),
                        windows=((2.0, 1.0), (10.0, 1.0)))
        sched = make_scheduler(eng5, scfg_5a(
            slo=spec5, admission=AdmissionConfig(
                check_every=1, degrade_after=1, recover_after=2)), obs=reg)
        # the config's monitor reads the host's clock; it reads the tick
        # clock here, as JAX's acceptance test injects one
        sched._slo_monitor.clock = clk
        ctrl = sched._admission
        check(ctrl.rung_names() == LADDER, f"phase 5a {tag}: rungs "
              f"{ctrl.rung_names()}, want {LADDER}")
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        ids = [sched.submit(r) for r in reqs()]
        shed_level, ticks = None, 0
        while sched.pending or sched.active:
            clk.t += 1.0
            sched.step()
            ticks += 1
            check(ticks < 2000, f"phase 5a {tag}: the overloaded drain "
                                "did not converge")
            if ctrl.shedding and shed_level is None:
                try:
                    sched.submit(Request(prompt=np.arange(4),
                                         max_new_tokens=2))
                except AdmissionShedError as e:
                    shed_level = (e.level, e.objectives)
                check(shed_level is not None,
                      f"phase 5a {tag}: a submit while shedding was taken")
        torch.cuda.synchronize()
        walk_s = time.perf_counter() - t0
        counts = _build.launch_counts()
        for k in ("fused_adapter_norm", "flash_attention", "paged_attention"):
            check(counts[k] > 0, f"phase 5a {tag}: {k} never launched")
        check(shed_level == (6, ("queue_le_2",)), f"phase 5a {tag}: shed "
              f"at {shed_level}, want level 6 for queue_le_2")
        down = [e["rung"] for e in reg.events_of("degrade")
                if e["direction"] == "down"]
        check(down[:6] == LADDER, f"phase 5a {tag}: steps down {down}")
        done = [sched.completions.pop(i) for i in ids]
        rep5 = sched.report(done, walk_s, ticks=ticks)
        check(rep5["shed"] == 1 and rep5["deferred_ticks"] >= 1,
              f"phase 5a {tag}: shed {rep5['shed']}, deferred ticks "
              f"{rep5['deferred_ticks']}")
        check(all(len(c.tokens) == SERVE["new_tokens"]
                  and c.finish_reason == "length"
                  and bool(((c.tokens >= 0) & (c.tokens < V5)).all())
                  for c in done), f"phase 5a {tag}: requests retired as "
              f"{[(len(c.tokens), c.finish_reason) for c in done]}")
        for c in done:
            tr = reg.tracer.find(c.request_id)
            names = tr.names()
            check(names[0] == "submit" and names[-1] == "retire"
                  and tr.count("admit") == 1
                  and tr.count("token") == len(c.tokens),
                  f"phase 5a {tag}: request {c.request_id}'s trace "
                  f"{sorted(set(names))} ({tr.count('admit')} admits, "
                  f"{tr.count('token')} token marks)")
        level_at_drain = ctrl.level
        clk.t += 11.0
        for _ in range(20):
            clk.t += 1.0
            sched.step()
        check(ctrl.level == 0 and sched.spec_k_eff == k_s
              and sched._prefix_fill and not ctrl.deferring,
              f"phase 5a {tag}: after 20 idle ticks level {ctrl.level}, "
              f"spec_k_eff {sched.spec_k_eff}, prefix fill "
              f"{sched._prefix_fill}")
        check(not reg.events_of("retrace"), f"phase 5a {tag}: retraces")
        # the unloaded run: the same requests, no SLO, plain greedy decoding
        t0 = time.perf_counter()
        udone, urep = make_scheduler(eng5, scfg_5a(spec_k=0)).run(reqs())
        unloaded_s = time.perf_counter() - t0
        same = [float((c.tokens == u.tokens).mean())
                for c, u in zip(done, udone)]
        snap = reg.snapshot()
        return dict(
            walk_s=walk_s, unloaded_s=unloaded_s, ticks=ticks, report=rep5,
            counts=counts,
            level_at_drain=level_at_drain, shed_level=shed_level[0],
            degrade=[(e["rung"], e["direction"], e["level"])
                     for e in reg.events_of("degrade")],
            events=snap["events_by_kind"], stats=sched.stats,
            spec_stats=sched.spec_stats, agreement_with_unloaded=same,
            unloaded_ticks=urep["ticks"], tokens_equal=all(v == 1.0 for v in same))

    # bf16: phase 5's engine
    eng = launcher.build_engine(cfg, seed=SERVE["seed"], device=dev)
    make_scheduler(eng, scfg_5a()).run(  # warm-up
        [Request(prompt=p, max_new_tokens=4) for p in prompts5a[:2]])
    t5a["bf16 build"] = time.perf_counter() - t5
    t5 = time.perf_counter()
    slo_report["bf16"] = r5 = overload("bf16", eng, V)
    t5a["bf16 walk"] = time.perf_counter() - t5
    t5 = time.perf_counter()
    slo_launches["serve_slo_bf16"] = r5["counts"]
    log(f"[5a] bf16 overload on {smi}: {r5['ticks']} ticks in "
        f"{r5['walk_s']:.2f} s, shed at level {r5['shed_level']}, level "
        f"{r5['level_at_drain']} when drained, 0 after 20 idle ticks; "
        f"degrade {r5['degrade']}; report {r5['report']}; events "
        f"{r5['events']}; admissions {r5['stats']}; {r5['spec_stats']}; "
        f"agreement with the unloaded plain run (reported, not gated) "
        f"{np.mean(r5['agreement_with_unloaded']):.4f} "
        f"{r5['agreement_with_unloaded']}; launches {r5['counts']}")

    # the cost of metrics: phase 5's traffic through the contiguous
    # scheduler, metrics on / off in turns
    reqs5 = launcher.make_requests(cfg, SERVE["requests"],
                                   SERVE["prompt_len"], SERVE["new_tokens"],
                                   0, SERVE["seed"])
    cost = {"on": [], "off": []}
    _build.reset_launches()
    for leg in ("on", "off"):
        sched = make_scheduler(eng, ServingConfig(
            num_slots=SERVE["num_slots"], max_len=SERVE["max_len"]),
            obs=MetricsRegistry(enabled=leg == "on"))
        torch.cuda.synchronize()
        _, rep5 = sched.run(reqs5)
        cost[leg].append((rep5["elapsed_s"] / rep5["ticks"] * 1e3,
                          rep5["tokens_per_s"]))
    slo_launches["serve_obs_cost"] = _build.launch_counts()
    med = {leg: (float(np.median([a for a, _ in v])),
                 float(np.median([b for _, b in v])))
           for leg, v in cost.items()}
    slo_report["metrics_cost"] = dict(
        runs=cost, median_host_ms_per_tick_on=med["on"][0],
        median_host_ms_per_tick_off=med["off"][0],
        median_tok_s_on=med["on"][1], median_tok_s_off=med["off"][1],
        tok_s_ratio_on_over_off=med["on"][1] / med["off"][1])
    log(f"[5a] metrics on/off, phase 5's traffic, on {smi}: median host ms "
        f"a tick {med['on'][0]:.2f} / {med['off'][0]:.2f}, tok/s "
        f"{med['on'][1]:.1f} / {med['off'][1]:.1f}, ratio on/off "
        f"{med['on'][1] / med['off'][1]:.4f} (reported, not gated); runs "
        f"{cost}")
    del eng, sched
    torch.cuda.empty_cache()
    t5a["metrics on/off"] = time.perf_counter() - t5
    t5 = time.perf_counter()

    # fp32, TF32 off: 4p's model
    base5 = launcher.build_base(cfg32, 1, dev)
    eng = ServeEngine(cfg32, launcher.task_variants(base5, 1, 1)[0],
                      device=dev)
    del base5
    slo_report["fp32"] = r5 = overload("fp32", eng, cfg32.vocab_size)
    slo_launches["serve_slo_fp32"] = r5["counts"]
    check(r5["tokens_equal"], f"phase 5a fp32: the loaded run's tokens "
          f"differ from the unloaded plain run's: "
          f"{r5['agreement_with_unloaded']}")
    log(f"[5a] fp32 overload on {smi}: {r5['ticks']} ticks in "
        f"{r5['walk_s']:.2f} s, shed at level {r5['shed_level']}; degrade "
        f"{r5['degrade']}; report {r5['report']}; admissions {r5['stats']} "
        f"(unloaded plain run {r5['unloaded_ticks']} ticks); tokens equal to "
        f"the unloaded plain run's: {r5['tokens_equal']}; launches "
        f"{r5['counts']}")
    del eng
    torch.cuda.empty_cache()

    # the launcher: JAX's obs and SLO flags, a JSON snapshot, the events,
    # a profile of 2 ticks; then its registry's snapshot as Prometheus text
    import contextlib
    import io

    from repro_torch.obs import write_snapshot

    t5a["fp32 build and walk"] = time.perf_counter() - t5
    t5 = time.perf_counter()
    td5 = tempfile.TemporaryDirectory()
    d5 = Path(td5.name)
    _build.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        reg5 = launcher.main([
            "--arch", ARCH, "--page-size", "16", "--spec-k", str(k_s),
            "--slo-queue-depth", "2", "--admission", "--metrics-every", "16",
            "--metrics-file", str(d5 / "m.json"), "--events-file",
            str(d5 / "e.jsonl"), "--profile-dir", str(d5 / "prof"),
            "--profile-ticks", "2"])
    write_snapshot(reg5, str(d5 / "m.prom"))  # a .prom path, as the flag
    torch.cuda.empty_cache()
    slo_launches["serve_launcher"] = _build.launch_counts()
    t5a["launcher"] = time.perf_counter() - t5
    t5 = time.perf_counter()
    text5 = buf.getvalue()
    for line in text5.splitlines():
        if line.startswith(("SLO", "[obs]", "speculation:", "pool:",
                            "served", "metrics snapshot", "profiler trace",
                            "WARNING")):
            log(f"[5a] launcher: {line}")
    check("SLOs: queue_le_2 (admission ladder armed)" in text5
          and any(x.startswith("SLO: ") for x in text5.splitlines())
          and "WARNING" not in text5, "phase 5a: the launcher's SLO lines")
    snap5 = json.loads((d5 / "m.json").read_text())
    hists, ctrs = snap5["histograms"], snap5["counters"]
    for key in ("serve_ttft_s{sched=spec_paged}",
                "serve_tpot_s{sched=spec_paged}"):
        h = hists.get(key, {})
        check(h.get("count", 0) > 0
              and 0 <= h["p50"] <= h["p95"] <= h["p99"],
              f"phase 5a: launcher snapshot {key} = {h}")
    for key in ("serve_prefix_hits_total{tier=full}",
                "serve_prefix_hits_total{tier=partial}",
                "serve_prefix_hits_total{tier=cold}",
                "serve_spec_drafted_total", "serve_spec_accepted_total",
                "serve_spec_ticks_total", "serve_tokens_total{sched=spec_paged}",
                "serve_retrace_events_total{sched=spec_paged}",
                "serve_admission_shed_total{sched=spec_paged}"):
        check(key in ctrs, f"phase 5a: launcher snapshot lacks {key}")
    check(ctrs["serve_retrace_events_total{sched=spec_paged}"] == 0
          and snap5["events_by_kind"].get("retrace", 0) == 0,
          "phase 5a: retraces in the launcher's serve")
    for key in ("prefix_hit_ratio_full", "prefix_hit_ratio_partial",
                "spec_acceptance_rate"):
        check(key in snap5["derived"], f"phase 5a: snapshot lacks {key}")
    check("kv_free_blocks" in snap5["gauges"],
          "phase 5a: snapshot lacks kv_free_blocks")
    events5 = [json.loads(x) for x in
               (d5 / "e.jsonl").read_text().splitlines()]
    # the .prom text: TYPE lines once a name, cumulative buckets ending at
    # +Inf == _count
    prom = (d5 / "m.prom").read_text()
    typed, buckets, counts5 = {}, {}, {}
    for line in prom.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            check(name not in typed, f"phase 5a: .prom types {name} twice")
            typed[name] = kind
            continue
        m = re.fullmatch(r"([a-zA-Z_:][\w:]*)(\{.*\})? (\S+)", line)
        check(m is not None, f"phase 5a: .prom line {line!r}")
        name, val = m.group(1), float(m.group(3))
        labels = dict(re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"',
                                 m.group(2) or ""))
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        check(name in typed or base in typed,
              f"phase 5a: .prom sample {name} has no TYPE line")
        series = (base, tuple(sorted((k, v) for k, v in labels.items()
                                     if k != "le")))
        if name.endswith("_bucket") and typed.get(base) == "histogram":
            buckets.setdefault(series, []).append(val)
        elif name.endswith("_count") and typed.get(base) == "histogram":
            counts5[series] = val
    check(buckets and all(
        all(a <= b for a, b in zip(v, v[1:])) and v[-1] == counts5[k]
        for k, v in buckets.items()), "phase 5a: .prom buckets not "
        "cumulative to _count")
    # the profile: the repro.* ranges and the port's kernels on the device
    trace5 = json.loads((d5 / "prof" / "trace.json").read_text())
    names5 = [e.get("name", "") for e in trace5["traceEvents"]]
    ranges = {n: names5.count(n) for n in ("repro.paged_attention",
                                           "repro.fused_adapter_norm",
                                           "repro.flash_attention")}
    dev_kernels = {}
    for src in ("paged_attention.cu", "fused_adapter_norm.cu"):
        pat = re.compile(r"\b(" + "|".join(sorted(source_kernels[src]))
                         + r")\b")
        dev_kernels[src] = sum(
            1 for e in trace5["traceEvents"]
            if e.get("cat") == "kernel" and pat.search(e.get("name", "")))
    check(ranges["repro.paged_attention"] >= 1
          and ranges["repro.fused_adapter_norm"] >= 1
          and all(v >= 1 for v in dev_kernels.values()),
          f"phase 5a: profile ranges {ranges}, device kernels "
          f"{dev_kernels}")
    t5a["launcher files"] = time.perf_counter() - t5
    slo_report["seconds"] = t5a
    slo_report["launcher"] = dict(
        seconds=t5a["launcher"], events=len(events5),
        events_by_kind=snap5["events_by_kind"], ranges=ranges,
        device_kernels=dev_kernels, trace_events=len(names5),
        trace_bytes=(d5 / "prof" / "trace.json").stat().st_size,
        prom_series=len(typed), snapshot_counters=ctrs,
        snapshot_derived=snap5["derived"],
        ttft=hists["serve_ttft_s{sched=spec_paged}"],
        tpot=hists["serve_tpot_s{sched=spec_paged}"])
    log(f"[5a] launcher on {smi}: {t5a['launcher']:.2f} s; profile of 2 "
        f"ticks: {len(names5)} trace events "
        f"({slo_report['launcher']['trace_bytes']} bytes), ranges {ranges}, "
        f"device kernels {dev_kernels}; {len(events5)} events "
        f"{snap5['events_by_kind']}; .prom {len(typed)} series; derived "
        f"{snap5['derived']}; launches {slo_launches['serve_launcher']}")
    log("[5a] seconds by part: " + ", ".join(
        f"{k} {v:.2f}" for k, v in t5a.items())
        + f" (unloaded plain runs: bf16 "
        f"{slo_report['bf16']['unloaded_s']:.2f}, "
        f"fp32 {slo_report['fp32']['unloaded_s']:.2f})")
    td5.cleanup()
    phase_done("5a")

    # -- phases 6s, 6w, 6rs: hot-swap serving at full width, bf16 ----------
    # the launcher's lifecycle over the traffic of phases 5-6: tenants in an
    # AdapterRegistry on disk, all but the last published up front, the
    # last once half of the others' requests have completed, task0 removed
    # at the end; a bank of fewer rows than tenants, so rows are evicted
    # and loaded mid-run. 6rs runs 6s's tenants over rwkv6-1.6b: #9 at the
    # seam of every RWKV6 block, d_model wide
    HOT_TASKS, BANK_ROWS = 4, 3
    cfgr = launcher.build_config(RWKV_ARCH)
    hot_base = None
    for phase, hcfg, share in (("6s", cfg, False), ("6w", cfg, True),
                               ("6rs", cfgr, False)):
        if hot_base is None or hot_base_cfg is not hcfg:
            hot_base, hot_base_cfg = None, hcfg
            torch.cuda.empty_cache()
            hot_base = launcher.build_base(hcfg, SERVE["seed"], dev)
        pmask = preset_mask(hcfg)
        variants = launcher.task_variants(hot_base, SERVE["seed"], HOT_TASKS,
                                          share_w=share)
        # 6s: task0 and task2 pruned, task1 and task3 dense; 6w: all pruned
        masks = [pmask if share or t % 2 == 0 else None
                 for t in range(HOT_TASKS)]
        variants = [v if m is None else apply_layer_mask(v, hcfg, m)
                    for v, m in zip(variants, masks)]
        td = tempfile.TemporaryDirectory()
        registry = AdapterRegistry(td.name)
        for t in range(HOT_TASKS - 1):
            registry.publish(f"task{t}", launcher.task_delta(
                variants[t], hcfg, masks[t]))
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        eng = launcher.hot_swap_engine(
            hcfg, hot_base, variants, registry, BANK_ROWS, share_w=share,
            layer_mask=pmask if share else None, device=dev)
        torch.cuda.synchronize()
        weights_bytes = torch.cuda.memory_allocated() - held
        torch.cuda.reset_peak_memory_stats()
        reqs = launcher.make_requests(hcfg, SERVE["requests"],
                                      SERVE["prompt_len"], SERVE["new_tokens"],
                                      HOT_TASKS, SERVE["seed"], named=True)
        sched = make_scheduler(eng, ServingConfig(
            num_slots=SERVE["num_slots"], max_len=SERVE["max_len"]))
        per_call = count_per_call(eng)
        hot_name = f"task{HOT_TASKS - 1}"
        torch.cuda.synchronize()
        _build.reset_launches()
        done, rep = launcher.serve_with_runtime_add(
            sched, reqs, hot_name,
            lambda: registry.publish(hot_name, launcher.task_delta(
                variants[-1], hcfg, masks[-1])), log=log)
        torch.cuda.synchronize()
        launches[phase] = _build.launch_counts()
        peak_bytes = torch.cuda.max_memory_allocated() - held
        del eng.prefill, eng.decode_step
        bank = eng.adapter_bank
        # each resident row's gates, on the device and on the host, are its
        # tenant's layer mask
        dev_gates = bank.gate_tensor.cpu().numpy()
        for name in bank.resident:
            t = int(name.removeprefix("task"))
            want = (masks[t] if masks[t] is not None
                    else np.ones(hcfg.n_layers, bool)).astype(np.float32)
            row = bank.row_of(name)
            check((bank.gates()[:, row] == want).all()
                  and (dev_gates[:, row] == want).all()
                  and (bank.mask_of(name) == want.astype(bool)).all(),
                  f"phase {phase}: {name}'s gates in row {row} are not its "
                  "mask")
        stats_run = bank.stats()
        launcher.remove_tenant(registry, eng, "task0", log=log)
        td.cleanup()
        stats = bank.stats()
        lines = launcher.bank_lines(eng)
        for line in lines:
            log(f"[{phase}] {line}")
        check(stats_run["evictions"] >= 1
              and stats_run["loads"] >= HOT_TASKS,
              f"phase {phase}: bank {stats_run}, want at least one eviction "
              f"and {HOT_TASKS} loads")
        rwkv_run = M.has_recurrent_state(hcfg)
        per_tick, per_prefill = check_serve_run(
            phase, per_call, rep, done, launches[phase], sched,
            (masked_name, "wkv6") if rwkv_run else
            (masked_name, "flash_attention", "paged_attention"), hcfg)
        L_h = hcfg.n_layers
        want_both = {masked_name: [L_h], "multitask_hadamard": [0],
                     "fused_adapter_norm": [0],
                     "wkv6": [L_h] if rwkv_run else [0]}
        if rwkv_run:
            want_both.update(flash_attention=[0], paged_attention=[0])
            widths = {tuple(p["adapter"]["w"].shape)
                      for p in eng.params["layers"]}
            check(widths == {(BANK_ROWS, hcfg.d_model)},
                  f"phase {phase}: bank adapter rows {widths}, want "
                  f"({BANK_ROWS}, d_model={hcfg.d_model})")
        for k, want in want_both.items():
            check(per_tick[k] == want and per_prefill[k] == want,
                  f"phase {phase}: {k} per decode tick {per_tick[k]}, per "
                  f"prefill {per_prefill[k]}, want {want}")
        check(not share or stats["adapter_bytes"]
              < serve_reports["6s"]["bank"]["adapter_bytes"],
              f"phase 6w: shared-w bank bytes {stats['adapter_bytes']} not "
              "below the dense bank's")
        slots = SERVE["num_slots"]
        caches = eng.init_slot_caches(slots, SERVE["max_len"])
        args = ([[11]] * slots, [140 + i for i in range(slots)])
        stids = [bank.row_of(n) for n in bank.resident]
        stids = (stids * slots)[:slots]
        tick = profile_calls(
            lambda: eng.decode_step(caches, *args, task_ids=stids), 8)
        check_profiled(phase, tick, per_tick)
        del caches
        pre = profile_prefill(eng)
        check_profiled(phase, pre, per_prefill)
        serve_reports[phase] = dict(
            rep, **exact_latency(done), launches_per_decode_tick=per_tick,
            launches_per_prefill=per_prefill, tick=tick, prefill=pre,
            bank=stats, bank_during_run=stats_run, bank_lines=lines,
            weights_bytes_allocated=weights_bytes,
            peak_bytes_allocated=peak_bytes)
        kind = (("hot-swap bank, 2 pruned + 2 dense tenants" if not share
                 else "hot-swap shared-w bank, 4 pruned tenants")
                + (f", {RWKV_ARCH}" if rwkv_run else ""))
        log(f"[{phase}] serve {kind}, {BANK_ROWS} rows, on {smi}: "
            f"{serve_line(rep, done)}; launches {launches[phase]}; per decode tick "
            f"{per_tick}; per prefill {per_prefill}; bank during the run "
            f"{stats_run}; engine bytes {weights_bytes}, peak {peak_bytes}; "
            f"decode tick {tick}")
        del eng, sched, bank, variants
        torch.cuda.empty_cache()
        phase_done(phase)
    del hot_base

    # -- phases 5r, 6r, 5rq: rwkv6-1.6b serving at full width, bf16 -------
    # the traffic of phases 5-6 over the attention-free family: every
    # layer's recurrence through #8 from the slot's state, the adapter seam
    # through #3 (one adapter) or #6 (a 3-task bank); no attention kernel.
    # 5rq quantizes the trunk to int8: the untied LM head is the one leaf
    n_r = cfgr.n_layers
    for phase, tasks, quant in (("5r", 0, None), ("6r", TASKS, None),
                                ("5rq", 0, "int8")):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        eng = launcher.build_engine(cfgr, seed=SERVE["seed"], tasks=tasks,
                                    device=dev, quant=quant)
        torch.cuda.synchronize()
        weights_bytes = torch.cuda.memory_allocated() - held
        torch.cuda.reset_peak_memory_stats()
        reqs = launcher.make_requests(cfgr, SERVE["requests"],
                                      SERVE["prompt_len"], SERVE["new_tokens"],
                                      tasks, SERVE["seed"])
        scfg = ServingConfig(num_slots=SERVE["num_slots"],
                             max_len=SERVE["max_len"], backbone_quant=quant)
        make_scheduler(eng, scfg).run([dataclasses.replace(
            r, max_new_tokens=2) for r in reqs[:2]])  # warm-up
        sched = make_scheduler(eng, scfg)
        state_bytes = sum(leaf.numel() * leaf.element_size()
                          for c in sched.caches for leaf in c.values())
        per_call = count_per_call(eng)
        torch.cuda.synchronize()
        _build.reset_launches()
        done, rep = sched.run(reqs)
        torch.cuda.synchronize()
        launches[phase] = _build.launch_counts()
        peak_bytes = torch.cuda.max_memory_allocated() - held
        del eng.prefill, eng.decode_step
        seam = "multitask_hadamard" if tasks else "fused_adapter_norm"
        # the untied LM head, the one leaf the table quantizes, is one #7 a
        # step: prefill takes logits at the last position only
        want_of = {"wkv6": [n_r], seam: [n_r],
                   "dequant_matmul": [1] if quant else [0]}
        per_tick, per_prefill = check_serve_run(
            phase, per_call, rep, done, launches[phase], sched,
            [k for k, w in want_of.items() if w != [0]], cfgr)
        tokens_of[phase] = {c.request_id: c.tokens for c in done}
        for k in launches[phase]:
            want = want_of.get(k, [0])
            check(per_tick[k] == want and per_prefill[k] == want,
                  f"phase {phase}: {k} per decode tick {per_tick[k]}, per "
                  f"prefill {per_prefill[k]}, want {want}")
        slots = SERVE["num_slots"]
        caches = eng.init_slot_caches(slots, SERVE["max_len"])
        args = ([[11]] * slots, [140 + i for i in range(slots)])
        stids = [t % max(tasks, 1) for t in range(slots)]
        tick = profile_calls(
            lambda: eng.decode_step(caches, *args, task_ids=stids), 8)
        check_profiled(phase, tick, per_tick)
        del caches
        pre = profile_prefill(eng)
        check_profiled(phase, pre, per_prefill)
        extra = {"weights_bytes_allocated": weights_bytes,
                 "peak_bytes_allocated": peak_bytes,
                 "state_bytes": state_bytes}
        if quant:
            qs = quant_summary(eng.params)
            check(qs["n_quantized_leaves"] == 1,
                  f"phase {phase}: {qs['n_quantized_leaves']} quantized "
                  "leaves, want the LM head alone")
            head = cfgr.d_model * cfgr.vocab_size
            # the head's bf16 bytes against its int8 values and fp32 scales
            saved = head * 2 - qs["quantized_bytes"]
            drop = serve_reports["5r"]["weights_bytes_allocated"] - weights_bytes
            check(abs(drop - saved) <= 2**20,
                  f"phase {phase}: engine bytes fell by {drop} against 5r's, "
                  f"want the head's {saved}")
            same = [float((tokens_of[phase][i] == tokens_of["5r"][i]).mean())
                    for i in sorted(tokens_of[phase])]
            extra.update(quant=quant, quant_line=launcher.quant_line(eng),
                         quantized_bytes=qs["quantized_bytes"],
                         engine_bytes_saved_vs_bf16=drop,
                         greedy_agreement_with_bf16_ungated=sum(same) / len(same))
        serve_reports[phase] = dict(rep, launches_per_decode_tick=per_tick,
                                    launches_per_prefill=per_prefill,
                                    tick=tick, prefill=pre, **extra,
                                    **exact_latency(done))
        kind = ("single-tenant" if tasks == 0 else f"{tasks}-task bank") + \
            (f", {quant} backbone" if quant else "")
        log(f"[{phase}] serve {RWKV_ARCH} {kind} on {smi}: {serve_line(rep, done)}; "
            f"launches {launches[phase]}; per decode tick {per_tick}; per "
            f"prefill {per_prefill}; memory {json.dumps(extra)}; decode tick "
            f"{tick}")
        del eng, sched
        torch.cuda.empty_cache()
        phase_done(phase)

    # -- the gemma2-27b phases (3g, 4g, 5g, 6g) and the fold lane (5o) ------
    # gemma2-27b (configs/gemma2_27b.py): 46 layers in 23 (local window
    # 4096, global) groups, d 4608, GQA 32/16 of 128, d_ff 36,864 (GeGLU),
    # vocab 256,000, soft-caps 50 (attention) and 30 (logits), post-norms,
    # query scale 144^-0.5, tied embeddings: 54.5 GB in bf16. Its adapter
    # seam sits before post_attn_norm, so one adapter runs #1, a bank #6
    # and a hot-swap bank #9; its local layers keep 4096-entry rings, which
    # #4 masks at prefill and #5 reads at decode
    from repro_torch.common import tree as tu
    from repro_torch.common.types import Group
    from repro_torch.serving import (AdapterBank, AdapterRegistry,
                                     MultiTaskEngine, Request)
    from repro_torch.sparse import apply_layer_mask, preset_mask

    gcfg = launcher.build_config(GEMMA["arch"])
    g_layers = gcfg.n_layers
    g_slots, g_len = GEMMA["num_slots"], GEMMA["max_len"]
    g_long, g_new = GEMMA["long_prompt"], GEMMA["new_tokens"]
    g_window = gcfg.layer_slots()[0].window
    gemma_launches, gemma_reports = {}, {}

    def release():
        """Free what the dropped engines held: a scheduler's metrics keep
        reference cycles through it, so collect them before the cache."""
        import gc

        gc.collect()
        torch.cuda.empty_cache()

    def copies_of(make, per_copy):
        """Copies of a timed call's inputs, together over twice the 50 MB
        L2 (two at least), each call of a timed graph taking the next."""
        return [make() for _ in range(max(2, -(-100 * 2**20 // per_copy)))]

    def bank_fns(name, wb, bb, gate, ids):
        """(kernel, plain) of #6 (name "multitask_hadamard") or #9 over the
        bank (wb, bb), #9 with its row gates, at the rows `ids`."""
        if name == "multitask_hadamard":
            return tuple(lambda x, impl=impl: ops.multitask_hadamard(
                x, wb, bb, ids, impl=impl) for impl in ("kernel", "ref"))
        return tuple(lambda x, impl=impl: ops.masked_multitask_hadamard(
            x, wb, bb, gate, ids, impl=impl) for impl in ("kernel", "ref"))

    def hold_bank(arch, rows, S, d_, wb, bb, gate):
        """#6 and #9 at x (rows, S, d_) fp32 and bf16, request r on bank
        row r mod rows: each equal to its plain version byte for byte."""
        ids = torch.arange(rows, dtype=torch.int32, device=dev) % wb.shape[0]
        for dt in (f32, bf):
            x = randn(rows, S, d_, dtype=dt)
            for name in ("multitask_hadamard", masked_name):
                kern, plain = bank_fns(name, wb, bb, gate, ids)
                compare(name, f"{arch} ({rows},{S},{d_})", dt,
                        lambda: kern(x), lambda: plain(x))
                check(torch.equal(kern(x), plain(x)),
                      f"{name} {arch} ({rows},{S},{d_}) {dt}: not the plain "
                      "version byte for byte")

    def time_bank(key, rows, S, d_, wb, bb, gate, what):
        """#6 and #9 timed L2-cold at x (rows, S, d_) bf16 over the bank
        (wb, bb): `<name>@<key>` in the kernels line."""
        ids = torch.arange(rows, dtype=torch.int32, device=dev) % wb.shape[0]
        xs = copies_of(lambda: (randn(rows, S, d_, dtype=bf),),
                       rows * S * d_ * 2)
        rows_read = nbytes(wb[:1], bb[:1]) * min(rows, wb.shape[0])
        for name in ("multitask_hadamard", masked_name):
            kern, plain = bank_fns(name, wb, bb, gate, ids)
            record(f"{name}@{key}", name,
                   f"x ({rows},{S},{d_}) bf16 ({len(xs)} copies in turn), a "
                   f"{wb.shape[0]}-row fp32 bank"
                   f"{', gates' if name == masked_name else ''} ({what})",
                   bf, rotating(xs, kern), rotating(xs, plain), None,
                   2 * nbytes(xs[0][0]) + rows_read + 4 * rows,
                   3 * xs[0][0].numel(), iters=len(xs), reps=2)
            results[f"{name}@{key}"]["library_note"] = (
                "none: the bank gather and the affine are separate calls")
        del xs

    def gemma2_kernels():
        """Phase 3g: #1, #4, #5, #6 and #9 at gemma2-27b's serve shapes,
        each against its plain version in fp32 and bf16 and timed L2-cold
        in bf16."""
        d_g, H, KH, D = gcfg.d_model, gcfg.n_heads, gcfg.n_kv_heads, \
            gcfg.head_dim
        cap, qs = gcfg.attn_softcap, gcfg.query_scale
        f32, bf = torch.float32, torch.bfloat16
        # #1: the single adapter's seam at a 2-slot decode tick and at a
        # 4160-token prefill
        for key, rows, S in (("gemma2_decode", g_slots, 1),
                             ("gemma2_prefill", 1, g_long)):
            w, b = 1 + randn(d_g, scale=0.1), randn(d_g, scale=0.1)
            for dt in (f32, bf):
                x = randn(rows, S, d_g, dtype=dt)
                compare("hadamard_affine", f"gemma2 ({rows},{S},{d_g})", dt,
                        lambda: ops.hadamard(x, w, b, impl="kernel"),
                        lambda: ops.hadamard(x, w, b, impl="ref"))
            xs = copies_of(lambda: (randn(rows, S, d_g, dtype=bf),),
                           rows * S * d_g * 2)
            wb, bb = w.to(bf), b.to(bf)
            record(f"hadamard_affine@{key}", "hadamard_affine",
                   f"x ({rows},{S},{d_g}) bf16 ({len(xs)} copies in turn), "
                   f"fp32 w/b (gemma2-27b's post-norm seam, one layer of a "
                   f"{'2-slot decode tick' if S == 1 else 'prefill'})", bf,
                   rotating(xs, lambda x: ops.hadamard(x, w, b,
                                                       impl="kernel")),
                   rotating(xs, lambda x: ops.hadamard(x, w, b, impl="ref")),
                   rotating(xs, lambda x: torch.addcmul(bb, x, wb)),
                   2 * nbytes(xs[0][0]) + nbytes(w, b),
                   2 * xs[0][0].numel(), iters=len(xs), reps=2)
            results[f"hadamard_affine@{key}"]["library_note"] = (
                "torch.addcmul(b, x, w), b and w cast to bf16")
            del xs
        # #4: a 4160-token prefill, local (window 4096) and global layers,
        # capped at 50 and scaled by 144^-0.5, fp32 and bf16
        S = g_long
        for dt in (f32, bf):
            q = randn(1, H, S, D, dtype=dt)
            k, v = randn(1, KH, S, D, dtype=dt), randn(1, KH, S, D, dtype=dt)
            for win in (g_window, None):
                kw = dict(causal=True, window=win, cap=cap, scale=qs)
                compare("flash_attention", f"gemma2 S={S} window={win} "
                        f"cap={cap}", dt,
                        lambda: ops.flash_attention(q, k, v, impl="kernel",
                                                    **kw),
                        lambda: ops.flash_attention(q, k, v, impl="ref",
                                                    **kw))
            del q, k, v
            release()
        qkvs = copies_of(lambda: (randn(1, H, S, D, dtype=bf),
                                  randn(1, KH, S, D, dtype=bf),
                                  randn(1, KH, S, D, dtype=bf)),
                         2 * (H + 2 * KH) * S * D)
        q, k, v = qkvs[0]
        # query i sees min(i + 1, window) keys
        pairs = sum(min(i + 1, g_window) for i in range(S))
        record("flash_attention@gemma2_local", "flash_attention",
               f"q (1,{H},{S},{D}) over k/v (1,{KH},{S},{D}) bf16, causal, "
               f"window {g_window}, cap {cap}, scale 144^-0.5 "
               f"({len(qkvs)} copies in turn; one local layer of a gemma2-27b "
               "prefill)", bf,
               rotating(qkvs, lambda q_, k_, v_: ops.flash_attention(
                   q_, k_, v_, window=g_window, cap=cap, scale=qs,
                   impl="kernel")),
               rotating(qkvs, lambda q_, k_, v_: ops.flash_attention(
                   q_, k_, v_, window=g_window, cap=cap, scale=qs,
                   impl="ref")),
               None, 2 * nbytes(q) + nbytes(k, v), 4 * H * D * pairs,
               yardstick_fn=rotating(qkvs, lambda q_, k_, v_:
                                     F.scaled_dot_product_attention(
                                         q_, k_, v_, is_causal=True,
                                         scale=qs, enable_gqa=True)),
               iters=len(qkvs), reps=2)
        results["flash_attention@gemma2_local"]["library_note"] = (
            "none: SDPA takes no soft-cap or window; the yardstick is "
            "scaled_dot_product_attention(is_causal=True, enable_gqa=True) "
            "over all the keys, uncapped")
        del qkvs
        release()
        # #5: a 2-slot decode tick over the ring (4096 of a 4352 cache, in
        # 16-token pages; kv_lens the last write, past the wrap) and over a
        # global layer's cache (kv_lens the last write + 1), capped
        page = 16
        for key, win, size, kl in (
                ("gemma2_ring", g_window, g_window, [4200, 4170]),
                ("gemma2_linear", None, g_len, [4201, 4171])):
            nbt = size // page
            tables = (torch.arange(g_slots, device=dev, dtype=torch.int32)
                      [:, None] * nbt + torch.arange(nbt, device=dev,
                                                     dtype=torch.int32))
            kl_t = torch.tensor(kl, dtype=torch.int32, device=dev)
            kw = dict(window=win, cap=cap, scale=qs)
            for dt in (f32, bf):
                q = randn(g_slots, H, D, dtype=dt)
                kp = randn(g_slots * nbt, page, KH, D, dtype=dt)
                vp = randn(g_slots * nbt, page, KH, D, dtype=dt)
                compare("paged_attention", f"gemma2 {key} kv_lens {kl}", dt,
                        lambda: ops.paged_attention(q, kp, vp, tables, kl_t,
                                                    impl="kernel", **kw),
                        lambda: ops.paged_attention(q, kp, vp, tables, kl_t,
                                                    impl="ref", **kw))
                runs = [ops.paged_attention(q, kp, vp, tables, kl_t,
                                            impl="kernel", **kw)
                        for _ in range(2)]
                check(torch.equal(*runs), f"paged_attention gemma2 {key} "
                                          f"{dt}: two runs differ")
            pcopies = copies_of(
                lambda: (randn(g_slots, H, D, dtype=bf),
                         randn(g_slots * nbt, page, KH, D, dtype=bf),
                         randn(g_slots * nbt, page, KH, D, dtype=bf)),
                2 * g_slots * size * KH * D * 2)
            n_keys = g_slots * size if win else sum(kl)
            mask = None if win else (torch.arange(size, device=dev)[None, :]
                                     < kl_t[:, None])[:, None, None, :]

            def sdpa(q_, kp_, vp_, size=size, mask=mask):
                k_ = kp_.view(g_slots, size, KH, D).transpose(1, 2)
                v_ = vp_.view(g_slots, size, KH, D).transpose(1, 2)
                return F.scaled_dot_product_attention(
                    q_[:, :, None], k_, v_, attn_mask=mask, scale=qs,
                    enable_gqa=True)

            plan = paged_split_plan(g_slots, H, KH, 1, D, page, nbt, win)
            record(f"paged_attention@{key}", "paged_attention",
                   f"q ({g_slots},{H},{D}) bf16 over "
                   f"{'a ring of ' + str(win) if win else 'a cache of ' + str(size)}"
                   f" keys a row in {page}-token pages, kv_lens {kl}, cap "
                   f"{cap} ({len(pcopies)} copies in turn; one "
                   f"{'local' if win else 'global'} layer of a gemma2-27b "
                   f"2-slot decode tick; {plan['splits']} splits, "
                   f"{plan['blocks']} blocks)", bf,
                   rotating(pcopies, lambda q_, kp_, vp_: ops.paged_attention(
                       q_, kp_, vp_, tables, kl_t, impl="kernel", **kw)),
                   rotating(pcopies, lambda q_, kp_, vp_: ops.paged_attention(
                       q_, kp_, vp_, tables, kl_t, impl="ref", **kw)),
                   None,
                   nbytes(pcopies[0][0], tables, kl_t)
                   + n_keys * KH * D * 2 * 2 + g_slots * H * D * 4,
                   4 * H * D * n_keys, yardstick_fn=rotating(pcopies, sdpa),
                   iters=len(pcopies), reps=3)
            results[f"paged_attention@{key}"].update(
                library_note="none: SDPA takes no block table, ring or "
                             "soft-cap; the yardstick is SDPA over the "
                             "contiguous cache, uncapped",
                split_plan=plan)
            del pcopies
        # #6 and #9 at d 4608: a 4-slot decode tick and a 128-token prefill
        # over a 3-row bank (fp32 rows), #9 with a gated-off row that is
        # not the identity
        wb3, bb3 = 1 + randn(3, d_g, scale=0.1), randn(3, d_g, scale=0.1)
        gate3 = torch.tensor([1.0, 0.0, 1.0], device=dev)
        for key, rows, S in (("gemma2_decode", 4, 1),
                             ("gemma2_prefill", 1, GEMMA["bank_prompt"])):
            hold_bank("gemma2", rows, S, d_g, wb3, bb3, gate3)
            time_bank(key, rows, S, d_g, wb3, bb3, gate3,
                      f"one layer of a gemma2-27b "
                      f"{'4-slot decode tick' if S == 1 else '128-token prefill'}")
        release()
        phase_done("3g")

    def gemma2_fp32_model():
        """Phase 4g: gemma2-27b at full width in fp32, its depth cut to 2 of
        its 23 (local, global) groups, TF32 off: a 4160-token prompt (every
        ring wraps) and 32 greedy tokens through the kernels against the
        plain versions (impl="ref"), over the slot caches and over a paged
        pool: logits within 1e-3 of max|ref| and greedy tokens identical;
        the launches of each call as predicted (a prefill 4 #4 + 4 #1, a
        decode step 4 #5 + 4 #1)."""
        cfg4 = gcfg.replace(param_dtype="float32", compute_dtype="float32",
                            groups=(Group(gcfg.groups[0].slots,
                                          GEMMA["depth_groups"]),))
        L4 = cfg4.n_layers
        torch.cuda.synchronize()
        release()
        log(f"[4g] device memory allocated before the build: "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
        eng = launcher.build_engine(cfg4, seed=1, device=dev)
        prompt = torch.randint(10, cfg4.vocab_size, (1, g_long), generator=gen,
                               device=dev)
        want_pre = kernels(flash_attention=L4, hadamard_affine=L4)
        want_dec = kernels(paged_attention=L4, hadamard_affine=L4)
        runs, worst = {}, 0.0
        with torch.no_grad():
            for impl in ("auto", "ref"):
                _build.reset_launches()
                lg, caches = M.prefill_lm(eng.params, cfg4, prompt, g_len,
                                          impl=impl)
                torch.cuda.synchronize()
                pre_counts = _build.launch_counts()
                logits, toks = [lg], []
                for i in range(g_new):
                    tok = lg[:, -1].argmax(-1)
                    toks.append(tok)
                    _build.reset_launches()
                    lg, caches = M.decode_lm(
                        eng.params, cfg4, caches, tok[:, None],
                        torch.tensor([g_long + i], device=dev), impl=impl)
                    torch.cuda.synchronize()
                    dec_counts = _build.launch_counts()
                    if impl == "auto":
                        check(dec_counts == want_dec, f"[4g] decode step {i} "
                              f"launched {dec_counts}, want {want_dec}")
                    logits.append(lg)
                if impl == "auto":
                    check(pre_counts == want_pre, f"[4g] prefill launched "
                          f"{pre_counts}, want {want_pre}")
                    kern_caches = caches
                runs[impl] = (logits, torch.cat(toks))
            check([c["k"].shape[1] for c in kern_caches[:2]]
                  == [g_window, g_len], "[4g] cache lengths "
                  f"{[c['k'].shape[1] for c in kern_caches[:2]]}")
            for step, (a, r) in enumerate(zip(runs["auto"][0],
                                              runs["ref"][0])):
                check(bool(torch.isfinite(a).all()), "[4g] non-finite logits")
                diff = (a - r).abs().max().item()
                check(diff <= 1e-3 * r.abs().max().item(),
                      f"[4g] step {step}: |kernel - plain| {diff:.3g} > "
                      f"1e-3 x {r.abs().max().item():.3g}")
                worst = max(worst, diff / r.abs().max().item())
            same = bool(torch.equal(runs["auto"][1], runs["ref"][1]))
            check(same, f"[4g] greedy tokens differ: kernel "
                        f"{runs['auto'][1].tolist()}, plain "
                        f"{runs['ref'][1].tolist()}")
            toks = runs["auto"][1]
            # the same steps over a paged pool: the fresh prefill inserted
            # into shuffled blocks (each layer its own length: the ring into
            # the first 256 entries), then the kernel path's tokens fed
            nbt = g_len // 16
            tables = (torch.randperm(nbt, generator=gen, device=dev) + 1
                      ).to(torch.int32)[None]
            paged, pworst = {}, 0.0
            for impl in ("auto", "ref"):
                pool = eng.init_paged_pool(nbt + 1, 16)
                lg, fresh = M.prefill_lm(eng.params, cfg4, prompt, g_len,
                                         impl=impl)
                eng.paged_insert(pool, fresh, tables[0].cpu().numpy())
                del fresh
                out = [lg]
                for i in range(g_new):
                    _build.reset_launches()
                    lg, _ = M.decode_lm_paged(
                        eng.params, cfg4, pool, toks[i].view(1, 1),
                        torch.tensor([g_long + i], device=dev), tables,
                        impl=impl)
                    torch.cuda.synchronize()
                    if impl == "auto":
                        check(_build.launch_counts() == want_dec,
                              f"[4g] paged decode step {i} launched "
                              f"{_build.launch_counts()}")
                    out.append(lg)
                paged[impl] = out
                del pool
            for step, (a, r, c) in enumerate(zip(paged["auto"], paged["ref"],
                                                 runs["auto"][0])):
                diff = (a - r).abs().max().item()
                check(diff <= 1e-3 * r.abs().max().item(),
                      f"[4g] paged step {step}: |kernel - plain| {diff:.3g}")
                check(int(a[0, -1].argmax()) == int(c[0, -1].argmax()),
                      f"[4g] paged step {step}: greedy token differs from "
                      "the slot caches'")
                pworst = max(pworst, diff / r.abs().max().item())
            paged_equal = all(torch.equal(a, c) for a, c in
                              zip(paged["auto"], runs["auto"][0]))
        gemma_reports["4g"] = dict(
            layers=L4, prompt=g_long, new_tokens=g_new,
            max_rel_diff_contiguous=worst, max_rel_diff_paged=pworst,
            paged_logits_equal_contiguous=paged_equal,
            tokens=toks.tolist())
        log(f"[4g] gemma2-27b fp32, {L4} layers (2 of 23 groups), a "
            f"{g_long}-token prompt + {g_new} greedy tokens: kernel path vs "
            f"plain path max |diff| / max|ref| {worst:.3g} over the slot "
            f"caches, {pworst:.3g} over the pool (tol 1e-3), tokens "
            f"identical; paged logits equal to the slot caches' "
            f"{paged_equal}; launches a prefill {want_pre}, a decode step "
            f"{want_dec}")
        del eng, caches, kern_caches, runs, paged
        release()
        phase_done("4g")

    def gemma2_requests(n_long, n_short, seed):
        """Requests of g_long- and 128-token prompts, g_new greedy tokens
        each, long and short in turn."""
        rs = np.random.RandomState(seed)
        lens = [g_long, GEMMA["bank_prompt"]] * max(n_long, n_short)
        return [Request(prompt=rs.randint(10, gcfg.vocab_size, size=(n,)),
                        max_new_tokens=g_new) for n in lens[:n_long + n_short]]

    def staggered_run(sched, reqs, at_tick=2):
        """`reqs[0]` alone, the rest submitted after `at_tick` ticks: every
        later admission lands in the middle of another request's decode."""
        n = [0]

        def hook():
            n[0] += 1
            return ([sched.submit(r) for r in reqs[1:]] if n[0] == at_tick
                    else [])

        return sched.run(reqs[:1], on_tick=hook)

    def serve_checks(tag, per_call, rep, done, counts, reqs, want,
                     vocab=gcfg.vocab_size):
        """Each request retires with its whole budget of in-vocabulary
        tokens, every launch falls inside a prefill or a decode step, and
        each call launches what `want` says ({kernel: n} per decode tick
        and per prefill). Returns the distinct counts per tick and per
        prefill."""
        check(len(done) == len(reqs), f"[{tag}] {len(done)} completions")
        for c, r in zip(sorted(done, key=lambda c: c.request_id), reqs):
            check(len(c.tokens) == r.max_new_tokens
                  and c.finish_reason == "length"
                  and bool(((c.tokens >= 0) & (c.tokens < vocab)).all()),
                  f"[{tag}] request {c.request_id}: {len(c.tokens)} tokens "
                  f"({c.finish_reason})")
        for k in counts:
            check(sum(c[k] for calls in per_call.values() for c in calls)
                  == counts[k], f"[{tag}] {k} launched outside prefill and "
                                "decode")
        per_tick = {k: sorted({c[k] for c in per_call["decode_step"]})
                    for k in counts}
        per_prefill = {k: sorted({c[k] for c in per_call["prefill"]})
                       for k in counts}
        for k in counts:
            for what, got in (("tick", per_tick), ("prefill", per_prefill)):
                w_ = [want[what].get(k, 0)]
                check(got[k] == w_, f"[{tag}] {k} per {what} {got[k]}, "
                                    f"want {w_}")
        check(len(per_call["decode_step"]) == rep["ticks"],
              f"[{tag}] {len(per_call['decode_step'])} decode steps, "
              f"{rep['ticks']} ticks")
        return per_tick, per_prefill

    def gemma2_serve():
        """Phases 5g and 6g: gemma2-27b at full width and depth in bf16.
        5g: one adapter (#1 at the post-norm seam), 4 requests (prompts of
        4160 and 128 tokens, 32 greedy tokens each) admitted mid-decode
        into 2 slots of 4352 tokens, over the slot caches and over a paged
        pool of 16-token pages (the cold windowed lane); the prefill's last
        logits against the plain path; the serve launcher. 6g: a 3-task
        bank (#6) and a 3-row hot-swap bank holding pruned tenants (#9),
        8 requests of 128 + 32 tokens on 4 slots."""
        import contextlib
        import io

        torch.cuda.synchronize()
        release()
        held = torch.cuda.memory_allocated()
        log(f"[5g] device memory allocated before the build: "
            f"{held / 1e9:.2f} GB (reserved "
            f"{torch.cuda.memory_reserved() / 1e9:.2f} GB)")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = launcher.build_engine(gcfg, seed=GEMMA["seed"], device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        weights_bytes = torch.cuda.memory_allocated() - held
        build_peak = torch.cuda.max_memory_allocated()
        n_params = sum(t.numel() for _, t in tu.flatten_with_paths(eng.params))
        check(build_peak < 80e9, f"[5g] the build peaked at "
                                 f"{build_peak / 1e9:.2f} GB")
        log(f"[5g] gemma2-27b bf16: {n_params:,} parameters, "
            f"{weights_bytes / 1e9:.2f} GB on the card, the build peaking at "
            f"{build_peak / 1e9:.2f} GB in {build_s:.1f} s")
        reqs = gemma2_requests(2, 2, GEMMA["seed"])
        want = {"tick": {"paged_attention": g_layers,
                         "hadamard_affine": g_layers},
                "prefill": {"flash_attention": g_layers,
                            "hadamard_affine": g_layers}}
        tokens_of = {}
        for tag, paged in (("5g", False), ("5gp", True)):
            scfg = ServingConfig(num_slots=g_slots, max_len=g_len,
                                 paged=paged)
            # warm-up: library init, the first call of every kernel
            make_scheduler(eng, scfg).run([Request(
                prompt=reqs[1].prompt, max_new_tokens=2)])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            sched = make_scheduler(eng, scfg)
            step_fn = "paged_decode_step" if paged else "decode_step"
            per_call = count_per_call(eng, ("prefill", step_fn))
            _build.reset_launches()
            done, rep = staggered_run(sched, reqs)
            torch.cuda.synchronize()
            counts = _build.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            delattr(eng, "prefill")
            delattr(eng, step_fn)
            per_tick, per_prefill = serve_checks(
                tag, {"prefill": per_call["prefill"],
                      "decode_step": per_call[step_fn]}, rep, done,
                counts, reqs, want)
            tokens_of[tag] = [c.tokens for c in done]
            extra = {}
            if paged:
                pr = sched.pool_report()
                check(sched.prefix is None and pr["cold"] == len(reqs)
                      and pr["live_blocks"] == 0,
                      f"[5gp] pool {pr}: want every admission cold and the "
                      "pool drained")
                same = [float((a == b).mean()) for a, b in
                        zip(tokens_of["5gp"], tokens_of["5g"])]
                extra.update(pool=pr, pool_bytes=sum(
                    t.numel() * t.element_size() for layer in sched.pool
                    for t in layer.values()),
                    token_agreement_with_5g=sum(same) / len(same))
            else:
                check([c["k"].shape[1] for c in sched.caches[:2]]
                      == [g_window, g_len], "[5g] slot cache lengths")
            del sched
            # the profile of a 2-slot decode tick (one row past the wrap)
            # and of a 4160-token prefill
            caches = eng.init_slot_caches(g_slots, g_len)
            tick = profile_calls(lambda: eng.decode_step(
                caches, [[11]] * g_slots, [g_long + 40, 300]), 5)
            del caches
            long_prompt = reqs[0].prompt[None]
            pre = profile_calls(lambda: eng.prefill(long_prompt, g_len), 2)
            ex = exact_latency(done)
            gemma_launches[tag] = counts
            gemma_reports[tag] = dict(
                rep, launches_per_decode_tick=per_tick,
                launches_per_prefill=per_prefill, tick=tick, prefill=pre,
                weights_bytes_allocated=weights_bytes,
                build_peak_bytes=build_peak, build_s=build_s,
                peak_bytes_allocated=peak, n_params=n_params, **extra, **ex)
            kind = ("paged (16-token pages, the cold windowed lane)"
                    if paged else "slot caches")
            log(f"[{tag}] gemma2-27b bf16 {kind}, 2 slots of "
                f"{g_len}, prompts {[len(r.prompt) for r in reqs]} on {smi}: "
                f"{serve_line(rep, done)}; launches {counts}; per decode "
                f"tick {per_tick}; per prefill {per_prefill}; peak "
                f"{peak / 1e9:.2f} GB; decode tick {tick}; 4160-token "
                f"prefill {pre}; {extra}")
            phase_done(tag)
        # the prefill's last logits through the kernels against the plain
        # path, and against planted faults: the plain path without the
        # local layers' window, and with every adapter's w 30 % further
        # from 1, so that the limit sits between the readings
        prompt_t = torch.as_tensor(reqs[0].prompt[None], device=dev)
        with torch.no_grad():
            got, _ = eng.prefill(reqs[0].prompt[None], g_len)
            want_l, _ = M.prefill_lm(eng.params, gcfg, prompt_t, g_len,
                                     impl="ref")
            unwindowed = gcfg.replace(groups=(Group(
                (gcfg.groups[0].slots[1],) * 2, gcfg.groups[0].repeats),))
            fault_w, _ = M.prefill_lm(eng.params, unwindowed, prompt_t,
                                      g_len, impl="ref")
            off = dict(eng.params, layers=[dict(layer, adapter={
                "w": 1 + 1.3 * (layer["adapter"]["w"] - 1),
                "b": layer["adapter"]["b"]}) for layer in eng.params["layers"]])
            fault_a, _ = M.prefill_lm(off, gcfg, prompt_t, g_len, impl="ref")
            del off
        release()
        diff = (got - want_l).abs().max().item()
        d_win = (fault_w - want_l).abs().max().item()
        d_ad = (fault_a - want_l).abs().max().item()
        top = bool(got[0, -1].argmax() == want_l[0, -1].argmax())
        gemma_reports["5g"]["prefill_vs_plain"] = dict(
            max_abs_diff=diff, limit=GEMMA["prefill_tol"],
            fault_no_window=d_win, fault_adapter_w_30pc=d_ad,
            same_top1=top, max_abs_ref=want_l.abs().max().item())
        log(f"[5g] the {g_long}-token prefill's last logits, kernel path vs "
            f"plain path: max |diff| {diff:.4g} (limit "
            f"{GEMMA['prefill_tol']}), same top-1 {top}; planted faults: no "
            f"window {d_win:.4g}, adapter w 30 % off {d_ad:.4g}")
        check(bool(torch.isfinite(got).all()), "[5g] non-finite logits")
        check(diff <= GEMMA["prefill_tol"], f"[5g] the prefill's last logits: "
              f"|kernel - plain| {diff:.4g} > {GEMMA['prefill_tol']}")
        check(min(d_win, d_ad) > GEMMA["prefill_tol"], f"[5g] a planted "
              f"fault moved the plain path's logits only {d_win:.4g} (no "
              f"window) and {d_ad:.4g} (adapter w 30 % off): the limit "
              f"{GEMMA['prefill_tol']} would not catch it")
        del eng, got, want_l, fault_w, fault_a
        release()
        # the serve launcher itself, at gemma2-27b, over the paged pool
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            launcher.main(["--arch", GEMMA["arch"], "--requests", "2",
                           "--num-slots", "2", "--prompt-len", "128",
                           "--new-tokens", "8", "--page-size", "16",
                           "--seed", str(GEMMA["seed"])])
        text = out.getvalue()
        check("served 2 requests / 16 tokens" in text
              and "2 cold prefills" in text,
              f"[5g] the launcher printed {text[-800:]!r}")
        gemma_reports["5g"]["launcher_s"] = time.perf_counter() - t0
        log(f"[5g] launcher --arch {GEMMA['arch']} --page-size 16 in "
            f"{gemma_reports['5g']['launcher_s']:.1f} s: "
            + " | ".join(ln for ln in text.splitlines()
                         if ln.startswith(("paged KV", "served", "pool"))))
        release()
        phase_done("5g launcher")

        # 6g: a 3-task bank (#6), then a 3-row hot-swap bank over 3 tenants,
        # task0 and task2 pruned to the paper-0.022 preset (#9 with gates)
        release()
        log(f"[6g] device memory allocated before the build: "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
        base = launcher.build_base(gcfg, GEMMA["seed"], dev)
        variants = launcher.task_variants(base, GEMMA["seed"], TASKS)
        pmask = preset_mask(gcfg)
        masks = [pmask if t % 2 == 0 else None for t in range(TASKS)]
        td = tempfile.TemporaryDirectory()
        registry = AdapterRegistry(td.name)
        for t, (v, m) in enumerate(zip(variants, masks)):
            if m is not None:
                v = apply_layer_mask(v, gcfg, m)
            registry.publish(f"task{t}", launcher.task_delta(v, gcfg, m))
        nb, bank_len = GEMMA["bank_requests"], GEMMA["bank_max_len"]
        rs = np.random.RandomState(GEMMA["seed"])
        for tag in ("6g", "6gs"):
            hot = tag == "6gs"
            eng = (MultiTaskEngine(gcfg, AdapterBank(gcfg, base, TASKS,
                                                     registry), device=dev)
                   if hot else MultiTaskEngine(gcfg, variants, device=dev))
            reqs = [Request(prompt=rs.randint(10, gcfg.vocab_size,
                                              size=(GEMMA["bank_prompt"],)),
                            max_new_tokens=g_new,
                            **({"adapter": f"task{i % TASKS}"} if hot
                               else {"task_id": i % TASKS}))
                    for i in range(nb)]
            scfg = ServingConfig(num_slots=GEMMA["bank_slots"],
                                 max_len=bank_len)
            make_scheduler(eng, scfg).run([dataclasses.replace(
                reqs[0], max_new_tokens=2)])  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            sched = make_scheduler(eng, scfg)
            per_call = count_per_call(eng)
            _build.reset_launches()
            done, rep = sched.run(reqs)
            torch.cuda.synchronize()
            counts = _build.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            del eng.prefill, eng.decode_step
            seam = masked_name if hot else "multitask_hadamard"
            per_tick, per_prefill = serve_checks(
                tag, per_call, rep, done, counts, reqs,
                {"tick": {"paged_attention": g_layers, seam: g_layers},
                 "prefill": {"flash_attention": g_layers, seam: g_layers}})
            extra = {}
            if hot:
                bank = eng.adapter_bank
                for name in bank.resident:
                    t = int(name.removeprefix("task"))
                    want_g = (masks[t] if masks[t] is not None else
                              np.ones(g_layers, bool)).astype(np.float32)
                    check((bank.gates()[:, bank.row_of(name)] == want_g).all(),
                          f"[6gs] {name}'s gates are not its mask")
                extra.update(bank=bank.stats(), pruned_layers=int(
                    g_layers - pmask.sum()))
            stids = [t % TASKS for t in range(GEMMA["bank_slots"])]
            caches = eng.init_slot_caches(GEMMA["bank_slots"], bank_len)
            tick = profile_calls(lambda: eng.decode_step(
                caches, [[11]] * GEMMA["bank_slots"],
                [140 + i for i in range(GEMMA["bank_slots"])],
                task_ids=stids), 5)
            del caches
            pre = profile_calls(lambda: eng.prefill(
                np.full((1, GEMMA["bank_prompt"]), 11, np.int64), bank_len,
                task_ids=np.asarray([0])), 3)
            gemma_launches[tag] = counts
            gemma_reports[tag] = dict(
                rep, launches_per_decode_tick=per_tick,
                launches_per_prefill=per_prefill, tick=tick, prefill=pre,
                peak_bytes_allocated=peak, **extra, **exact_latency(done))
            kind = ("a 3-row hot-swap bank (task0, task2 pruned)" if hot
                    else "a 3-task bank")
            log(f"[{tag}] gemma2-27b bf16, {kind}, {nb} requests "
                f"of {GEMMA['bank_prompt']} + {g_new} on "
                f"{GEMMA['bank_slots']} slots on {smi}: "
                f"{serve_line(rep, done)}; launches {counts}; per decode "
                f"tick {per_tick}; per prefill {per_prefill}; peak "
                f"{peak / 1e9:.2f} GB; decode tick {tick}; {extra}")
            del eng, sched
            release()
        td.cleanup()
        del base, variants
        release()
        phase_done("6g")

    def fold_lane():
        """Phase 5o: qwen3-0.6b with fold=True. At fp32 (phase 4's model,
        TF32 off) the folded engine's greedy tokens equal the unfolded
        one's and each call launches the same kernels (#3 still runs, on
        the identity); at bf16, and folded before an int8 quantization,
        the agreement with the unfolded engine is reported; the launcher
        runs once with --static --fold and once with --stream."""
        import contextlib
        import io

        qcfg = launcher.build_config(ARCH)
        cfg32 = qcfg.replace(param_dtype="float32", compute_dtype="float32")
        prompts = np.random.RandomState(5).randint(10, qcfg.vocab_size,
                                                   (4, SERVE["prompt_len"]))
        n_new = 16
        report = {}
        for tag, c, seed, quant in (("fp32", cfg32, 1, None),
                                    ("bf16", qcfg, SERVE["seed"], None),
                                    ("int8", qcfg, SERVE["seed"], "int8")):
            tuned = launcher.build_params(c, seed, 0, dev)[0]
            out = {}
            for fold in (False, True):
                eng = ServeEngine(c, tuned, fold=fold, quant=quant,
                                  device=dev)
                _build.reset_launches()
                out[fold] = (eng.generate(prompts, n_new),
                             _build.launch_counts())
                del eng
                release()
            agree = float((out[True][0] == out[False][0]).mean())
            check(out[True][1] == out[False][1],
                  f"[5o] {tag}: folded launches {out[True][1]}, unfolded "
                  f"{out[False][1]}")
            check(out[True][1]["fused_adapter_norm"] > 0,
                  f"[5o] {tag}: the folded engine launched no #3")
            if tag == "fp32":
                check(agree == 1.0, f"[5o] fp32: folded tokens differ from "
                      f"the unfolded ones ({agree:.4f} agree)")
            report[tag] = dict(token_agreement=agree, launches=out[True][1])
            gemma_launches.setdefault("5o", {k: 0 for k in out[True][1]})
            for k, n in out[True][1].items():
                gemma_launches["5o"][k] += n
            del tuned
            release()
        texts = {}
        for tag, flags in (("static_fold", ["--static", "--fold"]),
                           ("stream", ["--stream"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                launcher.main(["--arch", ARCH, "--requests", "4",
                               "--num-slots", "4", "--prompt-len", "128",
                               "--new-tokens", "8", *flags])
            texts[tag] = buf.getvalue()
        check("static batch: generated (4, 8)" in texts["static_fold"],
              f"[5o] --static --fold printed {texts['static_fold'][-400:]!r}")
        streamed = re.findall(r"^  req(\d+) \+= (\d+)$", texts["stream"],
                              re.M)
        check(len(streamed) == 32 and "served 4 requests / 32 tokens"
              in texts["stream"], f"[5o] --stream printed "
              f"{len(streamed)} token lines")
        report["launcher"] = {
            "static_fold": [ln for ln in texts["static_fold"].splitlines()
                            if ln.startswith("static batch")],
            "stream_token_lines": len(streamed)}
        gemma_reports["5o"] = report
        log(f"[5o] qwen3-0.6b fold=True, {len(prompts)} prompts x "
            f"{n_new} greedy tokens: folded vs unfolded agreement fp32 "
            f"{report['fp32']['token_agreement']:.4f} (must be 1), bf16 "
            f"{report['bf16']['token_agreement']:.4f}, --fold --quant int8 "
            f"{report['int8']['token_agreement']:.4f} (reported); launches "
            f"equal folded and unfolded; launcher: "
            f"{report['launcher']}")
        phase_done("5o")

    # -- phases 3g, 4g, 5g, 5gp, 6g, 6gs, 5o: gemma2-27b and the fold lane --
    gemma2_kernels()
    gemma2_fp32_model()
    gemma2_serve()
    fold_lane()
    launches.update(gemma_launches)
    serve_reports.update({p: gemma_reports[p]
                          for p in ("5g", "5gp", "6g", "6gs")})

    # -- the deepseek-moe-16b phases (3m, 4m, 5m, 6m, 5mq) -------------------
    # deepseek-moe-16b (configs/deepseek_moe_16b.py): 28 layers, the first
    # with a dense MLP (d_ff 10,944), the other 27 with 64 routed experts of
    # 1408 (top-6, gates not renormalized, capacity factor 1.25) and 2
    # shared ones; d 2048, MHA 16/16 of 128, vocab 102,400, untied head:
    # 16.4 B parameters, 32.8 GB in bf16. Routing, dispatch, the expert
    # products and the combine are plain PyTorch, as they are plain jnp in
    # JAX; the kernels meet new shapes: #3 at d 2048 over RMSNorm, #4 and
    # #5 with one query head a KV head (and qwen3-moe-235b-a22b's 64/4, 16
    # a KV head, which only phase 3m runs: 470 GB holds on no one card)
    from repro_torch import convert
    from repro_torch.models import moe as moe_mod

    mcfg = launcher.build_config(MOE["arch"])
    m_layers = mcfg.n_layers
    moe_launches, moe_reports = {}, {}

    def route_tally():
        """Wrap `moe._route_group` to keep each MoE layer call's `keep`
        mask, by the tokens routed together (4 at a 4-slot decode tick, 128
        at a prefill): a list append a call, no device work, so the timed
        runs it watches launch nothing more. Returns undo(), which unwraps
        it and sums {tokens: [dropped, routes]}."""
        real = moe_mod._route_group
        kept = {}

        def spy(xg, *a):
            out = real(xg, *a)
            kept.setdefault(xg.shape[0], []).append(out[1][1])
            return out

        moe_mod._route_group = spy

        def undo():
            moe_mod._route_group = real
            return {t: [int(sum((~k).sum() for k in ks)),
                        sum(k.numel() for k in ks)]
                    for t, ks in sorted(kept.items())}

        return undo

    def route_sets():
        """Wrap `moe._route_group` to keep the top-k experts of every token
        of each MoE layer call, in call order. Returns undo(), which
        unwraps it and gives the list of (tokens, k) index tensors."""
        real = moe_mod._route_group
        sets = []

        def spy(xg, router, m, *a):
            out = real(xg, router, m, *a)
            sets.append(moe_mod.top_k(out[2], m.top_k)[1])
            return out

        moe_mod._route_group = spy

        def undo():
            moe_mod._route_group = real
            return sets

        return undo

    def route_agreement(got, want):
        """The share of `want`'s routes (every layer's top-k experts of
        every token) that `got` routes too."""
        hit = sum(int((g[:, :, None] == w[:, None, :]).any(1).sum())
                  for g, w in zip(got, want, strict=True))
        return hit / sum(w.numel() for w in want)

    def moe_kernels():
        """Phase 3m: #3 at deepseek's seam, #4 and #5 with deepseek's 16/16
        heads and qwen3-moe's 64/4 at the serve shapes, each against its
        plain version in fp32 and bf16 (#5 also bit-identical across two
        runs) and timed L2-cold in bf16 beside its bound and SDPA."""
        d_m, D = mcfg.d_model, mcfg.head_dim
        qm = launcher.build_config(MOE["attn_arch"])
        rows, S = SERVE["num_slots"], SERVE["prompt_len"]
        # #3: the seam of a 4-slot decode tick and of a 128-token prefill,
        # RMSNorm, fp32 w/b, bf16 scale
        w, b = 1 + randn(d_m, scale=0.1), randn(d_m, scale=0.1)
        for key, r, s in (("deepseek_decode", rows, 1),
                          ("deepseek_prefill", 1, S)):
            for dt in (f32, bf):
                x, res = randn(r, s, d_m, dtype=dt), randn(r, s, d_m, dtype=dt)
                scale = randn(d_m, dtype=dt)
                compare("fused_adapter_norm", f"deepseek ({r},{s},{d_m})", dt,
                        lambda: ops.fused_adapter_norm(x, res, w, b, scale,
                                                       impl="kernel"),
                        lambda: ops.fused_adapter_norm(x, res, w, b, scale,
                                                       impl="ref"))
            scale = randn(d_m, dtype=bf)
            xrs = copies_of(lambda: (randn(r, s, d_m, dtype=bf),
                                     randn(r, s, d_m, dtype=bf)),
                            2 * r * s * d_m * 2)
            plan = fused_norm_plan(r * s, d_m, bf)
            record(f"fused_adapter_norm@{key}", "fused_adapter_norm",
                   f"x,res ({r},{s},{d_m}) bf16 ({len(xrs)} copies in turn), "
                   f"fp32 w/b, bf16 scale, RMSNorm (one layer of a "
                   f"deepseek-moe-16b {'4-slot decode tick' if s == 1 else 'prefill'};"
                   f" {plan['kernel']}, {plan['blocks']} blocks)", bf,
                   rotating(xrs, lambda x_, r_: ops.fused_adapter_norm(
                       x_, r_, w, b, scale, impl="kernel")),
                   rotating(xrs, lambda x_, r_: ops.fused_adapter_norm(
                       x_, r_, w, b, scale, impl="ref")),
                   None, 4 * nbytes(xrs[0][0]) + nbytes(w, b, scale),
                   8 * xrs[0][0].numel(),
                   yardstick_fn=rotating(xrs, lambda x_, r_: F.rms_norm(
                       x_, (d_m,), scale, 1e-6)), iters=len(xrs), reps=2)
            results[f"fused_adapter_norm@{key}"].update(
                library_note="none: rms_norm takes no adapter affine or "
                             "residual; the yardstick is F.rms_norm of x alone",
                split_plan=plan)
            del xrs
        # #4: a 128-token prefill, causal, with the log-sum-exp in the
        # checks; deepseek 16 heads on 16, qwen3-moe 64 on 4
        for key, c in (("deepseek_prefill", mcfg), ("qwen3moe_prefill", qm)):
            H, KH = c.n_heads, c.n_kv_heads
            for dt in (f32, bf):
                q = randn(1, H, S, D, dtype=dt)
                k, v = randn(1, KH, S, D, dtype=dt), randn(1, KH, S, D, dtype=dt)
                compare("flash_attention", f"{key} {H}/{KH} heads S={S}", dt,
                        lambda: ops.flash_attention(q, k, v, impl="kernel",
                                                    return_lse=True),
                        lambda: ops.flash_attention(q, k, v, impl="ref",
                                                    return_lse=True))
            qkvs = copies_of(lambda: (randn(1, H, S, D, dtype=bf),
                                      randn(1, KH, S, D, dtype=bf),
                                      randn(1, KH, S, D, dtype=bf)),
                             2 * (H + 2 * KH) * S * D)
            q, k, v = qkvs[0]
            record(f"flash_attention@{key}", "flash_attention",
                   f"q (1,{H},{S},{D}) over k/v (1,{KH},{S},{D}) bf16 causal "
                   f"({len(qkvs)} copies in turn; one layer of a "
                   f"{c.name} prefill)", bf,
                   rotating(qkvs, lambda q_, k_, v_: ops.flash_attention(
                       q_, k_, v_, impl="kernel")),
                   rotating(qkvs, lambda q_, k_, v_: ops.flash_attention(
                       q_, k_, v_, impl="ref")),
                   rotating(qkvs, lambda q_, k_, v_:
                            F.scaled_dot_product_attention(
                                q_, k_, v_, is_causal=True, enable_gqa=True)),
                   2 * nbytes(q) + nbytes(k, v), 4 * H * D * (S * (S + 1) // 2),
                   iters=len(qkvs), reps=3)
            results[f"flash_attention@{key}"]["library_note"] = (
                "torch.nn.functional.scaled_dot_product_attention("
                "is_causal=True, enable_gqa=True)")
            del qkvs
        # #5: a 4-slot decode tick over the slot cache of 512, 16-token pages
        page, max_len = 16, SERVE["max_len"]
        nbt = max_len // page
        tables = (torch.arange(rows, device=dev, dtype=torch.int32)[:, None]
                  * nbt + torch.arange(nbt, device=dev, dtype=torch.int32))
        kl = torch.tensor([129, 140, 150, 160], dtype=torch.int32, device=dev)
        n_keys = int(kl.sum())
        key_mask = (torch.arange(max_len, device=dev)[None, :]
                    < kl[:, None])[:, None, None, :]
        for key, c in (("deepseek_decode", mcfg), ("qwen3moe_decode", qm)):
            H, KH = c.n_heads, c.n_kv_heads
            for dt in (f32, bf):
                q = randn(rows, H, D, dtype=dt)
                kp = randn(rows * nbt, page, KH, D, dtype=dt)
                vp = randn(rows * nbt, page, KH, D, dtype=dt)
                compare("paged_attention", f"{key} {H}/{KH} heads", dt,
                        lambda: ops.paged_attention(q, kp, vp, tables, kl,
                                                    impl="kernel"),
                        lambda: ops.paged_attention(q, kp, vp, tables, kl,
                                                    impl="ref"))
                runs = [ops.paged_attention(q, kp, vp, tables, kl,
                                            impl="kernel") for _ in range(2)]
                check(torch.equal(*runs), f"paged_attention {key} {dt}: two "
                                          "runs differ")
            pcopies = copies_of(
                lambda: (randn(rows, H, D, dtype=bf),
                         randn(rows * nbt, page, KH, D, dtype=bf),
                         randn(rows * nbt, page, KH, D, dtype=bf)),
                2 * rows * max_len * KH * D * 2)

            def sdpa(q_, kp_, vp_, KH=KH):
                k_ = kp_.view(rows, max_len, KH, D).transpose(1, 2)
                v_ = vp_.view(rows, max_len, KH, D).transpose(1, 2)
                return F.scaled_dot_product_attention(
                    q_[:, :, None], k_, v_, attn_mask=key_mask,
                    enable_gqa=True)

            plan = paged_split_plan(rows, H, KH, 1, D, page, nbt)
            record(f"paged_attention@{key}", "paged_attention",
                   f"q ({rows},{H},{D}) bf16 over a ({rows},{max_len},{KH},"
                   f"{D}) bf16 slot cache, kv_lens {kl.tolist()} "
                   f"({len(pcopies)} copies in turn; one layer of a {c.name} "
                   f"4-slot decode tick; {plan['splits']} splits, "
                   f"{plan['blocks']} blocks)", bf,
                   rotating(pcopies, lambda q_, kp_, vp_: ops.paged_attention(
                       q_, kp_, vp_, tables, kl, impl="kernel")),
                   rotating(pcopies, lambda q_, kp_, vp_: ops.paged_attention(
                       q_, kp_, vp_, tables, kl, impl="ref")),
                   None,
                   nbytes(pcopies[0][0], tables, kl)
                   + n_keys * KH * D * 2 * 2 + rows * H * D * 4,
                   4 * H * D * n_keys, yardstick_fn=rotating(pcopies, sdpa),
                   iters=len(pcopies), reps=3)
            results[f"paged_attention@{key}"].update(
                library_note="none: SDPA takes no block table; the yardstick "
                             "is SDPA over the contiguous slot cache with a "
                             "key-length mask",
                split_plan=plan)
            del pcopies
        # #7 at every (K, N) that 5mq quantizes: the attention projections
        # (2048, 2048), the dense layer's MLP (2048, 10944) and (10944,
        # 2048), the untied head (2048, 102400), each at a 4-slot decode
        # tick and a 128-token prefill, over int8 values: within phase 3's
        # tolerances of the plain version, and the same bits across two runs
        dq = checks["dequant_matmul"]
        n_f, n_b, plans = len(dq["rel_errs"]), len(dq["rels"]), {}
        for K, N in ((d_m, mcfg.n_heads * D), (d_m, mcfg.d_ff),
                     (mcfg.d_ff, d_m), (d_m, mcfg.vocab_size)):
            (v, sc), = quantized(K, N, torch.int8)
            for m in (rows, S):
                for dt in (f32, bf):
                    x = randn(m, K, dtype=dt)
                    plan = dequant_matmul_plan(m, K, N, dt, torch.int8)
                    plans[f"M={m} K={K} N={N} {str(dt)[6:]}"] = plan
                    compare("dequant_matmul", f"deepseek M={m} K={K} N={N} "
                            f"int8 ({plan})", dt,
                            lambda: ops.dequant_matmul(x, v, sc,
                                                       impl="kernel"),
                            lambda: ops.dequant_matmul(x, v, sc, impl="ref"))
                    runs = [ops.dequant_matmul(x, v, sc, impl="kernel")
                            for _ in range(2)]
                    check(torch.equal(*runs), f"dequant_matmul deepseek M={m}"
                                              f" K={K} N={N} {dt}: two runs "
                                              "differ")
            del v, sc
        log(f"[3m] dequant_matmul at deepseek-moe-16b's quantized (K, N), "
            f"M {rows} and {S}, int8: fp32 max abs err / max|ref| "
            f"{max(dq['rel_errs'][n_f:]):.3g} (tol {TOL['dequant_matmul']}),"
            f" bf16 {max(dq['rels'][n_b:]):.3g} (tol {BF16_TOL}); two runs "
            f"the same bits at each; plans {plans}")
        # timed L2-cold at 6m's and 5mq's decode tick: #6 (and #9) at the
        # seam, #7 at each (K, N)
        wb3, bb3 = 1 + randn(3, d_m, scale=0.1), randn(3, d_m, scale=0.1)
        gate3 = torch.tensor([1.0, 0.0, 1.0], device=dev)
        hold_bank("deepseek", rows, 1, d_m, wb3, bb3, gate3)
        time_bank("deepseek_decode", rows, 1, d_m, wb3, bb3, gate3,
                  "one layer of a deepseek-moe-16b 4-slot decode tick")
        for K, N, what in ((d_m, mcfg.n_heads * D, "an attention projection"),
                           (d_m, mcfg.d_ff, "the dense layer's wi or wg"),
                           (mcfg.d_ff, d_m, "the dense layer's wo"),
                           (d_m, mcfg.vocab_size, "the untied head")):
            time_dequant(f"dequant_matmul@deepseek_{K}x{N}", rows, K, N,
                         max(2, -(-100 * 2**20 // (K * N))),
                         f"{what} of deepseek-moe-16b, a 4-slot decode tick")
        release()
        phase_done("3m")

    def moe_fp32_model():
        """Phase 4m: deepseek-moe-16b at full width in fp32, TF32 off, its
        depth cut to the dense layer and 2 MoE layers: 4 prompts of 128
        tokens and 32 greedy tokens each through the kernels against the
        plain versions, logits within 1e-3 of max|ref|, tokens identical,
        the launches of every call as predicted (a prefill 3 #4 + 3 #3, a
        decode step 3 #5 + 3 #3), and the routes dropped."""
        cfg4 = mcfg.replace(param_dtype="float32", compute_dtype="float32",
                            groups=(mcfg.groups[0], Group(
                                mcfg.groups[1].slots, MOE["moe_layers_4m"])))
        L4, rows, S = cfg4.n_layers, SERVE["num_slots"], SERVE["prompt_len"]
        n_new = SERVE["new_tokens"]
        release()
        eng = launcher.build_engine(cfg4, seed=1, device=dev)
        prompts = torch.randint(10, cfg4.vocab_size, (rows, S), generator=gen,
                                device=dev)
        want_pre = kernels(flash_attention=L4, fused_adapter_norm=L4)
        want_dec = kernels(paged_attention=L4, fused_adapter_norm=L4)
        runs, worst = {}, 0.0
        with torch.no_grad():
            for impl in ("auto", "ref"):
                undo = route_tally()
                _build.reset_launches()
                lg, caches = M.prefill_lm(eng.params, cfg4, prompts,
                                          SERVE["max_len"], impl=impl)
                torch.cuda.synchronize()
                pre_counts = _build.launch_counts()
                logits, toks = [lg], []
                for i in range(n_new):
                    tok = lg[:, -1].argmax(-1)
                    toks.append(tok)
                    _build.reset_launches()
                    lg, caches = M.decode_lm(
                        eng.params, cfg4, caches, tok[:, None],
                        torch.full((rows,), S + i, device=dev), impl=impl)
                    torch.cuda.synchronize()
                    if impl == "auto":
                        check(_build.launch_counts() == want_dec,
                              f"[4m] decode step {i} launched "
                              f"{_build.launch_counts()}, want {want_dec}")
                    logits.append(lg)
                if impl == "auto":
                    check(pre_counts == want_pre, f"[4m] prefill launched "
                          f"{pre_counts}, want {want_pre}")
                runs[impl] = (logits, torch.stack(toks, 1), undo())
        for step, (a, r) in enumerate(zip(runs["auto"][0], runs["ref"][0])):
            check(bool(torch.isfinite(a).all()), "[4m] non-finite logits")
            diff = (a - r).abs().max().item()
            check(diff <= 1e-3 * r.abs().max().item(),
                  f"[4m] step {step}: |kernel - plain| {diff:.3g} > 1e-3 x "
                  f"{r.abs().max().item():.3g}")
            worst = max(worst, diff / r.abs().max().item())
        check(torch.equal(runs["auto"][1], runs["ref"][1]),
              f"[4m] greedy tokens differ: kernel {runs['auto'][1].tolist()}, "
              f"plain {runs['ref'][1].tolist()}")
        tally = runs["auto"][2]
        check(tally == runs["ref"][2], f"[4m] the paths dropped different "
              f"routes: kernel {tally}, plain {runs['ref'][2]}")
        # a planted fault, the plain path with top-(k-1) routing: past the
        # 1e-3 limit at the prefill
        topk = cfg4.replace(moe=dataclasses.replace(
            cfg4.moe, top_k=cfg4.moe.top_k - 1))
        with torch.no_grad():
            fault, _ = M.prefill_lm(eng.params, topk, prompts,
                                    SERVE["max_len"], impl="ref")
        ref0 = runs["ref"][0][0]
        fault_rel = ((fault - ref0).abs().max() / ref0.abs().max()).item()
        check(fault_rel > 1e-3, f"[4m] top-{topk.moe.top_k} routing moved "
              f"the fp32 prefill's logits only {fault_rel:.3g} of max|ref|")
        moe_reports["4m"] = dict(layers=L4, rows=rows, prompt=S,
                                 new_tokens=n_new, max_rel_diff=worst,
                                 fault_top_k_minus_1_rel=fault_rel,
                                 routes_dropped=tally,
                                 drop_share={t: n / r for t, (n, r)
                                             in tally.items()},
                                 tokens=runs["auto"][1].tolist())
        log(f"[4m] deepseek-moe-16b fp32, {L4} layers (the dense one and "
            f"{MOE['moe_layers_4m']} MoE), {rows} prompts of {S} + {n_new} "
            f"greedy tokens: kernel path vs plain path max |diff| / max|ref| "
            f"{worst:.3g} (tol 1e-3), tokens identical; the planted "
            f"top-{topk.moe.top_k} routing fault {fault_rel:.3g} of max|ref| "
            f"at the prefill; routes dropped "
            f"[dropped, routes] by tokens routed together {tally}, the "
            f"same on both paths; launches a prefill {want_pre}, a decode "
            f"step {want_dec}")
        del eng, caches, runs, fault
        release()
        phase_done("4m")

    def moe_serve_run(tag, eng, reqs, want, ref_tokens=None):
        """SERVE's traffic through make_scheduler on `eng`, reqs[0] alone
        and the rest submitted after 2 ticks (admissions mid-decode, then
        retires while other rows decode): the serve checks, each call's
        launches as `want` says, a decode tick's and a prefill's profile,
        the routes dropped at decode and at prefill, the peak bytes."""
        scfg = ServingConfig(num_slots=SERVE["num_slots"],
                             max_len=SERVE["max_len"],
                             backbone_quant=getattr(eng, "quant", None))
        # warm-up: library init, the first call of every kernel
        make_scheduler(eng, scfg).run([dataclasses.replace(
            r, max_new_tokens=2) for r in reqs[:2]])
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sched = make_scheduler(eng, scfg)
        per_call = count_per_call(eng)
        undo = route_tally()
        _build.reset_launches()
        done, rep = staggered_run(sched, reqs)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        tally = undo()
        peak = torch.cuda.max_memory_allocated()
        del eng.prefill, eng.decode_step
        per_tick, per_prefill = check_serve_run(
            tag, per_call, rep, done, counts, sched,
            tuple(k for k, n in want["tick"].items() if n), mcfg)
        for k in counts:
            for what, got in (("tick", per_tick), ("prefill", per_prefill)):
                w_ = [want[what].get(k, 0)]
                check(got[k] == w_, f"[{tag}] {k} per {what} {got[k]}, "
                                    f"want {w_}")
        slots = SERVE["num_slots"]
        check(set(tally) == {slots, SERVE["prompt_len"]},
              f"[{tag}] routed token counts {sorted(tally)}")
        caches = eng.init_slot_caches(slots, SERVE["max_len"])
        stids = [t % TASKS for t in range(slots)]
        tick = profile_calls(lambda: eng.decode_step(
            caches, [[11]] * slots, [140 + i for i in range(slots)],
            task_ids=stids if isinstance(eng, MultiTaskEngine) else None), 5)
        check_profiled(tag, tick, per_tick)
        del caches
        pre = profile_prefill(eng)
        check_profiled(tag, pre, per_prefill)
        tokens = {c.request_id: c.tokens for c in done}
        extra = {}
        if ref_tokens is not None:
            same = [float((tokens[i] == ref_tokens[i]).mean())
                    for i in sorted(tokens)]
            extra["greedy_agreement_with_5m_ungated"] = sum(same) / len(same)
        moe_launches[tag] = counts
        moe_reports[tag] = dict(
            rep, launches_per_decode_tick=per_tick,
            launches_per_prefill=per_prefill, tick=tick, prefill=pre,
            peak_bytes_allocated=peak, bytes_held_before_run=held,
            routes_dropped=tally,
            drop_share_decode=tally[slots][0] / tally[slots][1],
            drop_share_prefill=(tally[SERVE["prompt_len"]][0]
                                / tally[SERVE["prompt_len"]][1]),
            **extra, **exact_latency(done))
        r = moe_reports[tag]
        log(f"[{tag}] {serve_line(rep, done)}; launches {counts}; per decode "
            f"tick {per_tick}; per prefill {per_prefill}; peak "
            f"{peak / 1e9:.2f} GB; routes dropped at decode "
            f"{r['drop_share_decode']:.4f}, at prefill "
            f"{r['drop_share_prefill']:.4f} ({tally}); decode tick {tick}; "
            f"prefill {pre}; {extra}")
        del sched
        return tokens

    def moe_serve():
        """Phases 5m, 6m and 5mq: deepseek-moe-16b at full width and depth
        in bf16, SERVE's traffic admitted mid-decode into 4 slots of 512:
        one adapter (5m, #3 at every seam), a 3-task bank (6m, #6) and one
        adapter over an int8 backbone (5mq, #7 at the attention
        projections, the dense layer's MLP and the head). 5m also holds two
        bf16 runs of an MoE layer to the same bits, the prefill's last
        logits to the plain path's beside two planted faults, and runs the
        serve launcher at deepseek-moe-16b."""
        import contextlib
        import io

        torch.cuda.synchronize()
        release()
        held = torch.cuda.memory_allocated()
        log(f"[5m] device memory allocated before the build: "
            f"{held / 1e9:.2f} GB")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = launcher.build_engine(mcfg, seed=SERVE["seed"], device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        weights_bytes = torch.cuda.memory_allocated() - held
        build_peak = torch.cuda.max_memory_allocated()
        n_params = sum(t.numel() for _, t in tu.flatten_with_paths(eng.params))
        log(f"[5m] deepseek-moe-16b bf16: {n_params:,} parameters, "
            f"{weights_bytes / 1e9:.2f} GB on the card, the build peaking at "
            f"{build_peak / 1e9:.2f} GB in {build_s:.1f} s")
        L = m_layers
        reqs = launcher.make_requests(mcfg, SERVE["requests"],
                                      SERVE["prompt_len"], SERVE["new_tokens"],
                                      0, SERVE["seed"])
        tokens_5m = moe_serve_run(
            "5m", eng, reqs, {"tick": {"paged_attention": L,
                                       "fused_adapter_norm": L},
                              "prefill": {"flash_attention": L,
                                          "fused_adapter_norm": L}})
        moe_reports["5m"].update(weights_bytes_allocated=weights_bytes,
                                 build_peak_bytes=build_peak, build_s=build_s,
                                 n_params=n_params)
        # an MoE layer twice on the same bf16 input: the same bits (no
        # atomics in the dispatch or the combine), and no host sync (CUDA's
        # sync debug mode raises on one)
        layer = eng.params["layers"][1]["moe"]
        for shape in ((SERVE["num_slots"], 1, mcfg.d_model),
                      (1, SERVE["prompt_len"], mcfg.d_model)):
            x = randn(*shape, dtype=bf)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                with torch.no_grad():
                    (y1, a1), (y2, a2) = (moe_mod.moe_apply(layer, mcfg, x)
                                          for _ in range(2))
            finally:
                torch.cuda.set_sync_debug_mode("default")
            check(torch.equal(y1, y2) and torch.equal(a1, a2)
                  and bool(torch.isfinite(y1.float()).all()),
                  f"[5m] two bf16 runs of an MoE layer at {shape} differ")
        moe_reports["5m"]["moe_layer_bit_identical_no_sync"] = True
        # the prefill's last logits and its routes through the kernels
        # against the plain path, on the first 4 requests' prompts, each
        # beside a planted fault: every adapter's w 30 % further from 1
        # (the logits), the plain path with top-(k-1) routing (the routes:
        # bf16 noise hides its logits, PERF.md section 6)
        topk = mcfg.replace(moe=dataclasses.replace(
            mcfg.moe, top_k=mcfg.moe.top_k - 1))
        off = dict(eng.params, layers=[dict(layer, adapter={
            "w": 1 + 1.3 * (layer["adapter"]["w"] - 1),
            "b": layer["adapter"]["b"]}) for layer in eng.params["layers"]])
        pre = {k: [] for k in ("kernel", "fault_adapter_w_30pc",
                               "routes_kernel", "routes_top_k_minus_1")}
        top = []
        with torch.no_grad():
            for req in reqs[:SERVE["num_slots"]]:
                prompt_t = torch.as_tensor(req.prompt[None], device=dev)
                undo = route_sets()
                got, _ = eng.prefill(req.prompt[None], SERVE["max_len"])
                got_r = undo()
                undo = route_sets()
                want_l, _ = M.prefill_lm(eng.params, mcfg, prompt_t,
                                         SERVE["max_len"], impl="ref")
                want_r = undo()
                undo = route_sets()
                M.prefill_lm(eng.params, topk, prompt_t, SERVE["max_len"],
                             impl="ref")
                fault_r = undo()
                fault_a, _ = M.prefill_lm(off, mcfg, prompt_t,
                                          SERVE["max_len"], impl="ref")
                check(bool(torch.isfinite(got).all()),
                      "[5m] non-finite logits")
                pre["kernel"].append((got - want_l).abs().max().item())
                pre["fault_adapter_w_30pc"].append(
                    (fault_a - want_l).abs().max().item())
                pre["routes_kernel"].append(route_agreement(got_r, want_r))
                pre["routes_top_k_minus_1"].append(
                    route_agreement(fault_r, want_r))
                top.append(bool(got[0, -1].argmax()
                                == want_l[0, -1].argmax()))
        del off, got, want_l, fault_a
        lim, rlim = MOE["prefill_tol"], MOE["route_share_min"]
        moe_reports["5m"]["prefill_vs_plain"] = dict(
            max_abs_diff=pre["kernel"], limit=lim,
            fault_adapter_w_30pc=pre["fault_adapter_w_30pc"],
            route_share=pre["routes_kernel"], route_share_min=rlim,
            fault_top_k_minus_1_route_share=pre["routes_top_k_minus_1"],
            same_top1=top)
        log(f"[5m] {len(top)} prefills of {SERVE['prompt_len']} tokens, "
            f"kernel path vs plain path: last logits max |diff| "
            f"{pre['kernel']} (limit {lim}; planted fault, adapter w 30 % "
            f"off: {pre['fault_adapter_w_30pc']}); the share of the plain "
            f"path's routes taken {pre['routes_kernel']} (least {rlim}; "
            f"planted fault, top-{topk.moe.top_k} routing: "
            f"{pre['routes_top_k_minus_1']}); same top-1 {top}")
        check(max(pre["kernel"]) <= lim, f"[5m] the prefill's last logits: "
              f"|kernel - plain| {max(pre['kernel']):.4g} > {lim}")
        check(min(pre["fault_adapter_w_30pc"]) > lim, f"[5m] the planted "
              f"adapter fault moved the plain path's logits only "
              f"{min(pre['fault_adapter_w_30pc']):.4g}: the limit {lim} "
              f"would not catch it")
        check(min(pre["routes_kernel"]) >= rlim, f"[5m] the kernel path "
              f"took only {min(pre['routes_kernel']):.4g} of the plain "
              f"path's routes, least {rlim}")
        check(max(pre["routes_top_k_minus_1"]) < rlim, f"[5m] the planted "
              f"top-{topk.moe.top_k} fault took "
              f"{max(pre['routes_top_k_minus_1']):.4g} of the plain path's "
              f"routes: the limit {rlim} would not catch it")
        del eng, layer
        release()
        phase_done("5m")
        # the serve launcher itself, on the card by default
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            launcher.main(["--arch", MOE["arch"], "--requests", "2",
                           "--num-slots", "2", "--prompt-len", "128",
                           "--new-tokens", "8", "--seed", str(SERVE["seed"])])
        text = out.getvalue()
        check("served 2 requests / 16 tokens" in text
              and torch.cuda.get_device_name(0) in text,
              f"[5m] the launcher printed {text[-800:]!r}")
        moe_reports["5m"]["launcher_s"] = time.perf_counter() - t0
        log(f"[5m] launcher --arch {MOE['arch']} in "
            f"{moe_reports['5m']['launcher_s']:.1f} s: "
            + " | ".join(ln for ln in text.splitlines()
                         if ln.startswith("served")))
        release()
        phase_done("5m launcher")
        # 6m: a 3-task bank (#6 at every seam)
        eng = launcher.build_engine(mcfg, seed=SERVE["seed"], tasks=TASKS,
                                    device=dev)
        reqs = launcher.make_requests(mcfg, SERVE["requests"],
                                      SERVE["prompt_len"], SERVE["new_tokens"],
                                      TASKS, SERVE["seed"])
        moe_serve_run("6m", eng, reqs, {
            "tick": {"paged_attention": L, "multitask_hadamard": L},
            "prefill": {"flash_attention": L, "multitask_hadamard": L}})
        del eng
        release()
        phase_done("6m")
        # 5mq: int8 backbone: 4 attention projections a layer, the dense
        # layer's 3 MLP projections and the untied head (116 #7 a call);
        # the experts stay bf16, as in JAX
        n_dq = 4 * L + 3 + 1
        eng = launcher.build_engine(mcfg, seed=SERVE["seed"], device=dev,
                                    quant="int8")
        qs = quant_summary(eng.params, lambda p: convert.jax_path(p, mcfg))
        check(qs["n_quantized_leaves"] == MOE["quant_leaves"],
              f"[5mq] {qs['n_quantized_leaves']} quantized leaves, JAX "
              f"quantizes {MOE['quant_leaves']}")
        check(not any(isinstance(t, QTensor) for p, t in
                      tu.flatten_with_paths(eng.params) if "/moe/" in p),
              "[5mq] an expert leaf was quantized")
        reqs = launcher.make_requests(mcfg, SERVE["requests"],
                                      SERVE["prompt_len"], SERVE["new_tokens"],
                                      0, SERVE["seed"])
        moe_serve_run("5mq", eng, reqs, {
            "tick": {"paged_attention": L, "fused_adapter_norm": L,
                     "dequant_matmul": n_dq},
            "prefill": {"flash_attention": L, "fused_adapter_norm": L,
                        "dequant_matmul": n_dq}}, ref_tokens=tokens_5m)
        moe_reports["5mq"].update(quant_line=launcher.quant_line(eng),
                                  quantized_bytes=qs["quantized_bytes"],
                                  tree_bytes=qs["total_bytes"])
        log(f"[5mq] {moe_reports['5mq']['quant_line']}")
        del eng
        release()
        phase_done("5mq")

    # -- phases 3m, 4m, 5m, 6m, 5mq: deepseek-moe-16b -------------------------
    moe_kernels()
    moe_fp32_model()
    moe_serve()
    launches.update(moe_launches)
    serve_reports.update({p: moe_reports[p] for p in ("5m", "6m", "5mq")})

    # -- the recurrentgemma-2b phases (3rg, 4rg, 5rg, 6rg, 6rgs, 5rgq) ------
    # recurrentgemma-2b (configs/recurrentgemma_2b.py): 26 layers, (rec,
    # rec, attention with window 2048) x 8 then (rec, rec); d 2560, MQA
    # 10/1 of 256, d_ff 7680 (GeGLU), lru_width 2560, conv width 4, vocab
    # 256,000 tied: 2.894 B parameters, 5.79 GB in bf16. The RG-LRU is
    # plain PyTorch, as it is plain jnp in JAX; the kernels meet new shapes:
    # #3 at d 2560 (split_row in bf16, warp_row in fp32), #4 and #5 at
    # head_dim 256 with 10 query heads on one KV head, #6 and #9 at d 2560,
    # #7 at the attention and MLP projections (the rec projections stay
    # bf16, as in JAX)
    from repro_torch.models import recurrent as rec_mod

    rcfg = launcher.build_config(RGEMMA["arch"])
    r_layers = rcfg.n_layers
    r_attn = sum(s.kind == "attn" for s in rcfg.layer_slots())
    r_rec = r_layers - r_attn
    r_window = rcfg.layer_slots()[2].window
    r_slots, r_len = RGEMMA["num_slots"], RGEMMA["max_len"]
    r_long, r_new = RGEMMA["long_prompt"], RGEMMA["new_tokens"]
    rg_launches, rg_reports, rg_parts = {}, {}, {}

    def same_bits(fn, what):
        """fn twice on the same inputs: every output the same bits."""
        a, b = fn(), fn()
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"{what}: two runs differ")

    def rg_kernels():
        """Phase 3rg: #3, #4, #5, #6, #7 and #9 at recurrentgemma-2b's
        serve shapes, each against its plain version in fp32 and bf16,
        the same bits across two runs, and timed L2-cold in bf16 beside its
        bound; then the RG-LRU's two heavy plain parts at the 4160-token
        prefill (the scan, the fp32 gate products) and a decode tick's gate
        casts, timed alike."""
        d_r, H, KH, D = rcfg.d_model, rcfg.n_heads, rcfg.n_kv_heads, \
            rcfg.head_dim
        # #3: the seam of a 2- and a 4-slot decode tick and of a 4160-token
        # prefill, RMSNorm; bf16 takes split_row, fp32 warp_row
        w, b = 1 + randn(d_r, scale=0.1), randn(d_r, scale=0.1)
        plans = {}
        for rows, S in ((r_slots, 1), (SERVE["num_slots"], 1), (1, r_long)):
            for dt in (f32, bf):
                x, res = randn(rows, S, d_r, dtype=dt), randn(rows, S, d_r,
                                                              dtype=dt)
                scale = randn(d_r, dtype=dt)
                plan = fused_norm_plan(rows * S, d_r, dt)
                plans[f"({rows},{S}) {str(dt)[6:]}"] = plan["kernel"]
                compare("fused_adapter_norm", f"recurrentgemma ({rows},{S},"
                        f"{d_r}) {plan['kernel']}", dt,
                        lambda: ops.fused_adapter_norm(x, res, w, b, scale,
                                                       impl="kernel"),
                        lambda: ops.fused_adapter_norm(x, res, w, b, scale,
                                                       impl="ref"))
                same_bits(lambda: ops.fused_adapter_norm(
                    x, res, w, b, scale, impl="kernel"),
                    f"fused_adapter_norm recurrentgemma ({rows},{S}) {dt}")
        check(set(plans.values()) == {"split_row", "warp_row"}
              and all(k.endswith("float32") == (v == "warp_row")
                      for k, v in plans.items()),
              f"[3rg] #3's plans at d {d_r}: {plans}")
        for key, rows, S, dt in (("rgemma_decode", r_slots, 1, bf),
                                 ("rgemma_decode_fp32", r_slots, 1, f32),
                                 ("rgemma_prefill", 1, r_long, bf)):
            scale = randn(d_r, dtype=dt)
            xrs = copies_of(lambda: (randn(rows, S, d_r, dtype=dt),
                                     randn(rows, S, d_r, dtype=dt)),
                            2 * rows * S * d_r * dt.itemsize)
            plan = fused_norm_plan(rows * S, d_r, dt)
            record(f"fused_adapter_norm@{key}", "fused_adapter_norm",
                   f"x,res ({rows},{S},{d_r}) {str(dt)[6:]} ({len(xrs)} "
                   f"copies in turn), fp32 w/b, scale, RMSNorm (one layer of "
                   f"a recurrentgemma-2b "
                   f"{'2-slot decode tick' if S == 1 else 'prefill'}; "
                   f"{plan['kernel']}, {plan['warps_per_row']} warps a row, "
                   f"{plan['blocks']} blocks)", dt,
                   rotating(xrs, lambda x_, r_: ops.fused_adapter_norm(
                       x_, r_, w, b, scale, impl="kernel")),
                   rotating(xrs, lambda x_, r_: ops.fused_adapter_norm(
                       x_, r_, w, b, scale, impl="ref")),
                   None, 4 * nbytes(xrs[0][0]) + nbytes(w, b, scale),
                   8 * xrs[0][0].numel(),
                   yardstick_fn=rotating(xrs, lambda x_, r_: F.rms_norm(
                       x_, (d_r,), scale, 1e-6)), iters=len(xrs), reps=2)
            results[f"fused_adapter_norm@{key}"].update(
                library_note="none: rms_norm takes no adapter affine or "
                             "residual; the yardstick is F.rms_norm of x alone",
                split_plan=plan)
            del xrs
        # #4: a 4160-token prefill through a windowed layer (2048), 10
        # query heads on one KV head of 256, fp32 and bf16
        S = r_long
        qi = torch.arange(S, device=dev)
        wmask = (qi[None, :] <= qi[:, None]) & (qi[:, None] - qi[None, :]
                                                < r_window)
        for dt in (f32, bf):
            q = randn(1, H, S, D, dtype=dt)
            k, v = randn(1, KH, S, D, dtype=dt), randn(1, KH, S, D, dtype=dt)
            compare("flash_attention", f"recurrentgemma S={S} window="
                    f"{r_window} {H}/{KH} heads of {D}", dt,
                    lambda: ops.flash_attention(q, k, v, window=r_window,
                                                impl="kernel"),
                    lambda: ops.flash_attention(q, k, v, window=r_window,
                                                impl="ref"))
            same_bits(lambda: ops.flash_attention(q, k, v, window=r_window,
                                                  impl="kernel"),
                      f"flash_attention recurrentgemma {dt}")
            del q, k, v
            release()
        qkvs = copies_of(lambda: (randn(1, H, S, D, dtype=bf),
                                  randn(1, KH, S, D, dtype=bf),
                                  randn(1, KH, S, D, dtype=bf)),
                         2 * (H + 2 * KH) * S * D)
        q, k, v = qkvs[0]
        pairs = sum(min(i + 1, r_window) for i in range(S))
        record("flash_attention@rgemma_prefill", "flash_attention",
               f"q (1,{H},{S},{D}) over k/v (1,{KH},{S},{D}) bf16, causal, "
               f"window {r_window} ({len(qkvs)} copies in turn; one "
               f"attention layer of a recurrentgemma-2b prefill; {pairs:,} "
               "query-key pairs a head)", bf,
               rotating(qkvs, lambda q_, k_, v_: ops.flash_attention(
                   q_, k_, v_, window=r_window, impl="kernel")),
               rotating(qkvs, lambda q_, k_, v_: ops.flash_attention(
                   q_, k_, v_, window=r_window, impl="ref")),
               rotating(qkvs, lambda q_, k_, v_:
                        F.scaled_dot_product_attention(
                            q_, k_, v_, attn_mask=wmask, enable_gqa=True)),
               2 * nbytes(q) + nbytes(k, v), 4 * H * D * pairs,
               yardstick_fn=rotating(qkvs, lambda q_, k_, v_:
                                     F.scaled_dot_product_attention(
                                         q_, k_, v_, is_causal=True,
                                         enable_gqa=True)),
               iters=len(qkvs), reps=2)
        results["flash_attention@rgemma_prefill"]["library_note"] = (
            "scaled_dot_product_attention(attn_mask=the causal window, "
            "enable_gqa=True): the same function; the yardstick is SDPA "
            "is_causal over every key")
        del qkvs, wmask
        release()
        # #5: a 2-slot decode tick over the ring (2048 entries in 16-token
        # pages; kv_lens the last write, past the wrap), 10 rows on 1 KV
        # head in 2 chunks
        page, size = 16, r_window
        nbt = size // page
        tables = (torch.arange(r_slots, device=dev, dtype=torch.int32)
                  [:, None] * nbt + torch.arange(nbt, device=dev,
                                                 dtype=torch.int32))
        kl = [4200, 4170]
        kl_t = torch.tensor(kl, dtype=torch.int32, device=dev)
        for dt in (f32, bf):
            q = randn(r_slots, H, D, dtype=dt)
            kp = randn(r_slots * nbt, page, KH, D, dtype=dt)
            vp = randn(r_slots * nbt, page, KH, D, dtype=dt)
            compare("paged_attention", f"recurrentgemma ring {size} kv_lens "
                    f"{kl} {H}/{KH} heads of {D}", dt,
                    lambda: ops.paged_attention(q, kp, vp, tables, kl_t,
                                                window=r_window,
                                                impl="kernel"),
                    lambda: ops.paged_attention(q, kp, vp, tables, kl_t,
                                                window=r_window, impl="ref"))
            same_bits(lambda: ops.paged_attention(q, kp, vp, tables, kl_t,
                                                  window=r_window,
                                                  impl="kernel"),
                      f"paged_attention recurrentgemma {dt}")
        pcopies = copies_of(
            lambda: (randn(r_slots, H, D, dtype=bf),
                     randn(r_slots * nbt, page, KH, D, dtype=bf),
                     randn(r_slots * nbt, page, KH, D, dtype=bf)),
            2 * r_slots * size * KH * D * 2)
        # every ring entry holds a key the query sees, once the ring wrapped
        key_mask = (torch.arange(size, device=dev)[None, :]
                    < torch.clamp(kl_t + 1, max=size)[:, None])[:, None,
                                                                None, :]

        def sdpa(q_, kp_, vp_):
            k_ = kp_.view(r_slots, size, KH, D).transpose(1, 2)
            v_ = vp_.view(r_slots, size, KH, D).transpose(1, 2)
            return F.scaled_dot_product_attention(
                q_[:, :, None], k_, v_, attn_mask=key_mask, enable_gqa=True)

        plan = paged_split_plan(r_slots, H, KH, 1, D, page, nbt, r_window)
        record("paged_attention@rgemma_ring", "paged_attention",
               f"q ({r_slots},{H},{D}) bf16 over a ring of {size} keys a row "
               f"in {page}-token pages, kv_lens {kl} ({len(pcopies)} copies "
               f"in turn; one attention layer of a recurrentgemma-2b 2-slot "
               f"decode tick; {plan['splits']} splits, {plan['row_chunks']} "
               f"row chunks of {plan['rows_per_block']}, {plan['blocks']} "
               f"blocks, {plan['smem_bytes']} B of shared memory)", bf,
               rotating(pcopies, lambda q_, kp_, vp_: ops.paged_attention(
                   q_, kp_, vp_, tables, kl_t, window=r_window,
                   impl="kernel")),
               rotating(pcopies, lambda q_, kp_, vp_: ops.paged_attention(
                   q_, kp_, vp_, tables, kl_t, window=r_window, impl="ref")),
               rotating(pcopies, sdpa),
               nbytes(pcopies[0][0], tables, kl_t)
               + r_slots * size * KH * D * 2 * 2 + r_slots * H * D * 4,
               4 * H * D * r_slots * size, iters=len(pcopies), reps=3)
        results["paged_attention@rgemma_ring"].update(
            library_note="scaled_dot_product_attention over the ring's "
                         "contiguous keys with a key mask (every entry "
                         "live past the wrap; softmax is blind to the "
                         "ring's order): the same function",
            split_plan=plan)
        del pcopies
        # #6 and #9 at d 2560: a 4-slot decode tick and a 128-token prefill
        # over a 3-row fp32 bank, #9 with a gated-off row
        wb3, bb3 = 1 + randn(3, d_r, scale=0.1), randn(3, d_r, scale=0.1)
        gate3 = torch.tensor([1.0, 0.0, 1.0], device=dev)
        for key, rows, S in (("rgemma_decode", SERVE["num_slots"], 1),
                             ("rgemma_prefill", 1, SERVE["prompt_len"])):
            hold_bank("recurrentgemma", rows, S, d_r, wb3, bb3, gate3)
            time_bank(key, rows, S, d_r, wb3, bb3, gate3,
                      f"one layer of a recurrentgemma-2b "
                      f"{'4-slot decode tick' if S == 1 else '128-token prefill'}")
        # #7 at every (K, N) that 5rgq quantizes: wq and wo (2560, 2560),
        # wk and wv (2560, 256), wi and wg (2560, 7680), the MLP's wo
        # (7680, 2560), at a 4-slot decode tick and a 128-token prefill,
        # against the plain version and the same bits twice; timed at the
        # decode tick
        dq = checks["dequant_matmul"]
        n_f, n_b, dq_plans = len(dq["rel_errs"]), len(dq["rels"]), {}
        kns = ((d_r, H * D), (d_r, KH * D), (d_r, rcfg.d_ff),
               (rcfg.d_ff, d_r))
        for K, N in kns:
            (v, sc), = quantized(K, N, torch.int8)
            for m in (SERVE["num_slots"], SERVE["prompt_len"]):
                for dt in (f32, bf):
                    x = randn(m, K, dtype=dt)
                    plan = dequant_matmul_plan(m, K, N, dt, torch.int8)
                    dq_plans[f"M={m} K={K} N={N} {str(dt)[6:]}"] = \
                        plan["kernel"]
                    compare("dequant_matmul", f"recurrentgemma M={m} K={K} "
                            f"N={N} int8", dt,
                            lambda: ops.dequant_matmul(x, v, sc,
                                                       impl="kernel"),
                            lambda: ops.dequant_matmul(x, v, sc, impl="ref"))
                    same_bits(lambda: ops.dequant_matmul(x, v, sc,
                                                         impl="kernel"),
                              f"dequant_matmul recurrentgemma M={m} K={K} "
                              f"N={N} {dt}")
            del v, sc
            time_dequant(f"dequant_matmul@rgemma_{K}x{N}", SERVE["num_slots"],
                         K, N, max(2, -(-100 * 2**20 // (K * N))),
                         f"a recurrentgemma-2b projection, a 4-slot decode "
                         f"tick")
        log(f"[3rg] dequant_matmul at recurrentgemma-2b's quantized (K, N) "
            f"{kns}, M {SERVE['num_slots']} and {SERVE['prompt_len']}, int8: "
            f"fp32 max abs err / max|ref| {max(dq['rel_errs'][n_f:]):.3g} "
            f"(tol {TOL['dequant_matmul']}), bf16 "
            f"{max(dq['rels'][n_b:]):.3g} (tol {BF16_TOL}); the same bits "
            f"twice; plans {dq_plans}")
        # the RG-LRU's plain parts at a 4160-token prefill, fp32 as JAX
        # runs them: the associative scan (13 levels) and the two gate
        # products (TF32 off, the bf16 gates cast to fp32 at every call);
        # and at a 2-slot decode tick the two gate casts alone
        W = rcfg.lru_width
        p = rec_mod.rec_init(torch.Generator(device=dev).manual_seed(0),
                             rcfg)
        xc = randn(1, r_long, W)
        a = torch.rand(1, r_long, W, generator=gen, device=dev)
        bb = randn(1, r_long, W)

        def gates(x_):
            with torch.no_grad():
                return rec_mod._rg_lru(p, x_, torch.zeros(
                    x_.shape[0], W, device=dev))

        with torch.no_grad():
            for key, fn, what in (
                    ("scan", lambda: rec_mod._assoc_scan(a, bb),
                     f"the associative scan of (1,{r_long},{W}) fp32"),
                    ("rg_lru", lambda: gates(xc),
                     f"the whole RG-LRU of (1,{r_long},{W}) fp32: the gate "
                     "products, the decay and the scan"),
                    ("gate_cast", lambda: (p["gate_a"].float(),
                                           p["gate_x"].float()),
                     f"the two gate casts of a decode step, ({W},{W}) "
                     "bf16 -> fp32")):
                ms, host = time_ms(fn, iters=5, reps=3)
                rg_parts[key] = dict(ms=ms, host_ms=host, what=what)
        rg_parts["gates_and_decay"] = dict(
            ms=rg_parts["rg_lru"]["ms"] - rg_parts["scan"]["ms"],
            what="the RG-LRU less its scan")
        log(f"[3rg] the RG-LRU's plain parts, device ms a layer on {smi}: "
            f"{json.dumps(rg_parts)}")
        del p, xc, a, bb
        release()
        phase_done("3rg")

    def rg_fp32_model():
        """Phase 4rg: recurrentgemma-2b at full width in fp32, TF32 off,
        its depth cut to the first (rec, rec, attention) group and the
        (rec, rec) tail: a 2100-token prefill (the 2048-ring wraps) of 2
        rows and 4 decode steps through the kernels against the plain
        versions (impl="ref"), over one adapter, a 3-task bank and a 3-row
        hot-swap bank holding a tenant pruned to the paper-0.022 preset:
        logits and the rec states within 1e-3 of max|ref|, and the
        launches of each path as predicted (a prefill 1 #4 + 5 of the
        seam's kernel, a step 1 #5 + 5)."""
        cfg4 = rcfg.replace(param_dtype="float32", compute_dtype="float32",
                            groups=(Group(rcfg.groups[0].slots, 1),
                                    rcfg.groups[1]))
        L4, S4, n4 = cfg4.n_layers, RGEMMA["prompt_4rg"], RGEMMA["steps_4rg"]
        cache_len = r_len  # the attention layer's ring: min(2048, r_len)
        release()
        base = launcher.build_base(cfg4, 1, dev)
        variants = launcher.task_variants(base, 1, TASKS)
        pmask = preset_mask(cfg4)
        check(int(pmask.sum()) == 3 and pmask[2:].all(),
              f"[4rg] paper-0.022 keeps {pmask.tolist()} of {L4}")
        pruned = apply_layer_mask(variants[0], cfg4, pmask)
        static = MultiTaskEngine(cfg4, variants, device=dev)
        with tempfile.TemporaryDirectory() as td:
            reg = AdapterRegistry(td)
            reg.publish("pruned", launcher.task_delta(pruned, cfg4, pmask))
            reg.publish("dense", launcher.task_delta(variants[1], cfg4))
            hot = MultiTaskEngine(cfg4, AdapterBank(cfg4, base, 3, reg),
                                  device=dev)
            rows = [hot.adapter_bank.lookup(n) for n in ("pruned", "dense")]
        check(rows == [0, 1], f"[4rg] bank rows {rows}")
        toks = torch.randint(10, cfg4.vocab_size, (2, S4), generator=gen,
                             device=dev)
        steps_ = n4 + 1
        report = {}
        for tag, params, tids, gates_, seam in (
                ("single", variants[0], None, None, "fused_adapter_norm"),
                ("bank", static.params,
                 torch.tensor([0, 2], dtype=torch.int32, device=dev), None,
                 "multitask_hadamard"),
                ("hot_swap", hot.params,
                 torch.tensor([0, 1], dtype=torch.int32, device=dev),
                 hot.adapter_bank.gate_tensor, masked_name)):
            want = {"flash_attention": 1, "paged_attention": n4,
                    seam: steps_ * L4}
            runs = {}
            with torch.no_grad():
                for impl in ("auto", "ref"):
                    _build.reset_launches()
                    lg, caches = M.prefill_lm(params, cfg4, toks, cache_len,
                                              task_ids=tids, gates=gates_,
                                              impl=impl)
                    out = [lg]
                    for i in range(n4):
                        tok = torch.randint(
                            10, cfg4.vocab_size, (2, 1), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(i))
                        pos = torch.full((2,), S4 + i, device=dev)
                        lg, caches = M.decode_lm(params, cfg4, caches, tok,
                                                 pos, task_ids=tids,
                                                 gates=gates_, impl=impl)
                        out.append(lg)
                    torch.cuda.synchronize()
                    runs[impl] = (out, _build.launch_counts(), caches)
            for impl in ("auto", "ref"):
                for k, n in runs[impl][1].items():
                    w_ = want.get(k, 0) if impl == "auto" else 0
                    check(n == w_, f"[4rg] ({tag}): the {impl} path "
                                   f"launched {k} {n} times, want {w_}")
            worst = 0.0
            for step, (a_, r_) in enumerate(zip(runs["auto"][0],
                                                runs["ref"][0])):
                check(a_.shape == (2, 1, cfg4.vocab_size)
                      and bool(torch.isfinite(a_).all()),
                      f"[4rg] logits {tuple(a_.shape)}")
                diff, top = (a_ - r_).abs().max().item(), \
                    r_.abs().max().item()
                check(diff <= 1e-3 * top, f"[4rg] step {step} ({tag}): "
                      f"|kernel - plain| {diff:.3g} > 1e-3 x {top:.3g}")
                worst = max(worst, diff / top)
            state = max((ca[n] - cr[n]).abs().max().item()
                        / cr[n].abs().max().item()
                        for ca, cr in zip(runs["auto"][2], runs["ref"][2])
                        if "h" in ca for n in ("h", "conv"))
            check(state <= 1e-3, f"[4rg] ({tag}): rec states differ by "
                                 f"{state:.3g} of their max")
            report[tag] = dict(kernel_vs_plain=worst,
                               rec_state_kernel_vs_plain=state,
                               launches={k: n for k, n in
                                         runs["auto"][1].items() if n})
            log(f"[4rg] recurrentgemma-2b fp32, {L4} layers (rec, rec, "
                f"attention; rec, rec), {tag}: a {S4}-token prefill of 2 "
                f"rows + {n4} decode steps, launches "
                f"{report[tag]['launches']}; kernel path vs plain path max "
                f"|diff| / max|ref| {worst:.3g} (tol 1e-3), rec states "
                f"{state:.3g}")
            del runs, caches
        rg_reports["4rg"] = dict(report, layers=L4, prompt=S4, steps=n4,
                                 kept_layers=int(pmask.sum()))
        del base, variants, pruned, static, hot
        release()
        phase_done("4rg")

    def rg_serve_run(tag, eng, reqs, want):
        """reqs through make_scheduler on `eng` (SERVE's slots and length),
        reqs[0] alone and the rest after 2 ticks: the serve checks, each
        call's launches as `want` says, a decode tick's and a 128-token
        prefill's profile, the peak bytes."""
        scfg = ServingConfig(num_slots=SERVE["num_slots"],
                             max_len=SERVE["max_len"],
                             backbone_quant=getattr(eng, "quant", None))
        make_scheduler(eng, scfg).run([dataclasses.replace(
            r, max_new_tokens=2) for r in reqs[:2]])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sched = make_scheduler(eng, scfg)
        per_call = count_per_call(eng)
        _build.reset_launches()
        done, rep = staggered_run(sched, reqs)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        del eng.prefill, eng.decode_step
        per_tick, per_prefill = serve_checks(
            tag, per_call, rep, done, counts, reqs, want, rcfg.vocab_size)
        check(all(bool(torch.isfinite(leaf.float()).all())
                  for c in sched.caches for leaf in c.values()),
              f"[{tag}] non-finite cache")
        slots = SERVE["num_slots"]
        caches = eng.init_slot_caches(slots, SERVE["max_len"])
        stids = [t % TASKS for t in range(slots)]
        tick = profile_calls(lambda: eng.decode_step(
            caches, [[11]] * slots, [140 + i for i in range(slots)],
            task_ids=stids if isinstance(eng, MultiTaskEngine) else None), 5)
        check_profiled(tag, tick, per_tick)
        del caches
        pre = profile_prefill(eng)
        check_profiled(tag, pre, per_prefill)
        rg_launches[tag] = counts
        rg_reports[tag] = dict(
            rep, launches_per_decode_tick=per_tick,
            launches_per_prefill=per_prefill, tick=tick, prefill=pre,
            peak_bytes_allocated=peak, **exact_latency(done))
        log(f"[{tag}] recurrentgemma-2b bf16 on {smi}: "
            f"{serve_line(rep, done)}; launches {counts}; per decode tick "
            f"{per_tick}; per prefill {per_prefill}; peak "
            f"{peak / 1e9:.2f} GB; decode tick {tick}; prefill {pre}")
        del sched
        return {c.request_id: c.tokens for c in done}

    def rg_serve():
        """Phases 5rg, 6rg, 6rgs and 5rgq: recurrentgemma-2b at full width
        and depth in bf16. 5rg: one adapter (#3 at every seam), 2 prompts
        of 4160 and 2 of 128 tokens, 32 greedy tokens each, admitted
        mid-decode into 2 slots of 4352; a rec layer's two bf16 runs the
        same bits with no host sync; the long prefill's last logits against
        the plain path beside two planted faults; the serve launcher. Then
        SERVE's traffic through a 3-task bank (#6), a 3-row hot-swap bank
        holding pruned tenants (#9) and an int8 trunk (#7)."""
        import contextlib
        import io

        torch.cuda.synchronize()
        release()
        held = torch.cuda.memory_allocated()
        log(f"[5rg] device memory allocated before the build: "
            f"{held / 1e9:.2f} GB")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = launcher.build_engine(rcfg, seed=RGEMMA["seed"], device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        weights_bytes = torch.cuda.memory_allocated() - held
        n_params = sum(t.numel() for _, t in tu.flatten_with_paths(eng.params))
        check(n_params == RGEMMA["n_params"], f"[5rg] {n_params:,} "
              f"parameters, JAX counts {RGEMMA['n_params']:,}")
        log(f"[5rg] recurrentgemma-2b bf16: {n_params:,} parameters, "
            f"{weights_bytes / 1e9:.2f} GB on the card, built in "
            f"{build_s:.1f} s")
        rs = np.random.RandomState(RGEMMA["seed"])
        lens = [r_long, SERVE["prompt_len"]] * 2
        reqs = [Request(prompt=rs.randint(10, rcfg.vocab_size, size=(n,)),
                        max_new_tokens=r_new) for n in lens]
        want = {"tick": {"paged_attention": r_attn,
                         "fused_adapter_norm": r_layers},
                "prefill": {"flash_attention": r_attn,
                            "fused_adapter_norm": r_layers}}
        scfg = ServingConfig(num_slots=r_slots, max_len=r_len)
        make_scheduler(eng, scfg).run([Request(prompt=reqs[1].prompt,
                                               max_new_tokens=2)])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sched = make_scheduler(eng, scfg)
        per_call = count_per_call(eng)
        _build.reset_launches()
        done, rep = staggered_run(sched, reqs)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        del eng.prefill, eng.decode_step
        per_tick, per_prefill = serve_checks(
            "5rg", per_call, rep, done, counts, reqs, want, rcfg.vocab_size)
        kinds = [sorted(c) for c in sched.caches[:3]]
        check(kinds == [["conv", "h"], ["conv", "h"], ["k", "v"]]
              and sched.caches[2]["k"].shape[1] == r_window
              and sched.caches[0]["h"].dtype == torch.float32,
              f"[5rg] slot caches {kinds}")
        del sched
        caches = eng.init_slot_caches(r_slots, r_len)
        tick = profile_calls(lambda: eng.decode_step(
            caches, [[11]] * r_slots, [r_long + 40, 300]), 5)
        del caches
        pre = profile_calls(lambda: eng.prefill(reqs[0].prompt[None], r_len),
                            2)
        pre_ms = pre["device_ms"]
        check(pre_ms is not None, "[5rg] the prefill's profile shows no "
                                  "device time")
        flash_us = sum(pre["port_kernel_us"].get(k, 0.0)
                       for k in source_kernels["flash_attention.cu"])
        shares = dict(
            flash_attention=flash_us / 1e3 / pre_ms,
            scan=r_rec * rg_parts["scan"]["ms"] / pre_ms,
            gates_and_decay=r_rec * rg_parts["gates_and_decay"]["ms"] / pre_ms,
            gate_casts_of_a_tick_ms=r_rec * rg_parts["gate_cast"]["ms"])
        rg_reports["5rg"] = dict(
            rep, launches_per_decode_tick=per_tick,
            launches_per_prefill=per_prefill, tick=tick, prefill=pre,
            prefill_shares=shares, weights_bytes_allocated=weights_bytes,
            build_s=build_s, peak_bytes_allocated=peak, n_params=n_params,
            **exact_latency(done))
        rg_launches["5rg"] = counts
        log(f"[5rg] recurrentgemma-2b bf16 slot caches, 2 slots of {r_len}, "
            f"prompts {lens} on {smi}: {serve_line(rep, done)}; launches "
            f"{counts}; per decode tick {per_tick}; per prefill "
            f"{per_prefill}; peak {peak / 1e9:.2f} GB; decode tick {tick}; "
            f"{r_long}-token prefill {pre}; its shares (the scan and the "
            f"gates from 3rg's timings x {r_rec} rec layers) {shares}")
        # a rec layer twice on the same bf16 inputs, a decode step into a
        # cache and a prefill: the same bits, and no host sync (CUDA's sync
        # debug mode raises on one)
        layer = eng.params["layers"][0]["rec"]
        for shape in ((r_slots, 1, rcfg.d_model),
                      (1, SERVE["prompt_len"], rcfg.d_model)):
            x = randn(*shape, dtype=bf)
            c0 = rec_mod.rec_cache_init(rcfg, shape[0], dev)
            c0["h"].normal_(generator=gen)
            outs = []
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                with torch.no_grad():
                    for _ in range(2):
                        c = {k: t.clone() for k, t in c0.items()}
                        y, c = rec_mod.rec_apply(layer, rcfg, x, c)
                        outs.append((y, c["h"], c["conv"]))
            finally:
                torch.cuda.set_sync_debug_mode("default")
            check(all(torch.equal(a_, b_) for a_, b_ in zip(*outs))
                  and bool(torch.isfinite(outs[0][0].float()).all()),
                  f"[5rg] two bf16 runs of a rec layer at {shape} differ")
        rg_reports["5rg"]["rec_layer_bit_identical_no_sync"] = True
        # the long prefills' last logits through the kernels against the
        # plain path, and the first one's beside planted faults: every
        # adapter's w 30 % further from 1 (the arithmetic #3 does at each
        # seam) and every rec layer's decay parameter 10 % and 30 % off.
        # The measure is the logits' relative L2 distance (one bf16 step of
        # the largest logit, ~0.1, is as large as the faults' max |diff|).
        # In bf16 any change, a kernel's rounding or a fault, leaves ~0.02
        # of noise after 26 layers over 4160 tokens, so the bf16 limit
        # catches only the 30 % decay fault. The adapter fault moves the
        # logits ~0.002 (in fp32), far under that noise, so the same
        # weights run in fp32 (TF32 off) too: the kernel path within
        # RGEMMA["fp32_tol"] of the plain path, the adapter fault past it.
        # And each bf16 path's distance from the plain fp32 logits is the
        # witness of the noise floor: the kernel path's within
        # RGEMMA["witness_ratio"] x the plain bf16 path's
        lim, lim32 = RGEMMA["prefill_tol"], RGEMMA["fp32_tol"]
        ratio = RGEMMA["witness_ratio"]

        def rel_l2(a_, b_):
            return ((a_.float() - b_.float()).norm() / b_.float().norm()).item()

        def faulty(params, scale_w, scale_a):
            return dict(params, layers=[dict(
                layer_, adapter={
                    "w": 1 + scale_w * (layer_["adapter"]["w"] - 1),
                    "b": layer_["adapter"]["b"]},
                **({"rec": dict(layer_["rec"], a_param=layer_["rec"][
                    "a_param"] * scale_a)} if "rec" in layer_ else {}))
                for layer_ in params["layers"]])

        fault_scales = {"adapter_w_30pc": (1.3, 1.0),
                        "decay_10pc": (1.0, 1.1), "decay_30pc": (1.0, 1.3)}
        dists, maxes, top = [], [], []
        with torch.no_grad():
            for req in (reqs[0], reqs[2]):
                prompt_t = torch.as_tensor(req.prompt[None], device=dev)
                got, _ = eng.prefill(req.prompt[None], r_len)
                want_l, _ = M.prefill_lm(eng.params, rcfg, prompt_t, r_len,
                                         impl="ref")
                check(bool(torch.isfinite(got).all()),
                      "[5rg] non-finite logits")
                dists.append(rel_l2(got, want_l))
                maxes.append((got - want_l).abs().max().item())
                top.append(bool(got[0, -1].argmax()
                                == want_l[0, -1].argmax()))
                if req is reqs[0]:
                    got_0, want_0, prompt_0 = got, want_l, prompt_t
            faults, fault_logits = {}, {}
            for name, (scale_w, scale_a) in fault_scales.items():
                off = faulty(eng.params, scale_w, scale_a)
                fault, _ = M.prefill_lm(off, rcfg, prompt_0, r_len,
                                        impl="ref")
                faults[name] = dict(rel_l2=rel_l2(fault, want_0),
                                    max_abs=(fault - want_0).abs().max()
                                    .item())
                fault_logits[name] = fault
                del off, fault
            # the same weights in fp32: plain, kernels, the adapter fault
            cfg32 = rcfg.replace(param_dtype="float32",
                                 compute_dtype="float32")
            p32 = tu.map_with_path(lambda _, t: t.float(), eng.params)
            ref32, _ = M.prefill_lm(p32, cfg32, prompt_0, r_len, impl="ref")
            ker32, _ = M.prefill_lm(p32, cfg32, prompt_0, r_len)
            off = faulty(p32, *fault_scales["adapter_w_30pc"])
            fault32, _ = M.prefill_lm(off, cfg32, prompt_0, r_len,
                                      impl="ref")
            del off, p32
            fp32 = dict(kernel_vs_plain=rel_l2(ker32, ref32),
                        adapter_w_30pc_vs_plain=rel_l2(fault32, ref32),
                        same_top1=bool(ker32[0, -1].argmax()
                                       == ref32[0, -1].argmax()),
                        limit=lim32)
            witness = dict(plain_bf16=rel_l2(want_0, ref32),
                           kernel_bf16=rel_l2(got_0, ref32),
                           **{f"{k}_bf16": rel_l2(v, ref32)
                              for k, v in fault_logits.items()},
                           ratio_limit=ratio)
            bf16_top = bool(want_0[0, -1].argmax() == ref32[0, -1].argmax())
            del ker32, fault32, fault_logits
        release()
        rg_reports["5rg"]["prefill_vs_plain"] = dict(
            rel_l2=dists, max_abs_diff=maxes, limit=lim, faults=faults,
            same_top1=top, max_abs_ref=want_0.abs().max().item(), fp32=fp32,
            vs_plain_fp32=witness, plain_bf16_same_top1_as_fp32=bf16_top)
        log(f"[5rg] the {r_long}-token prefills' last logits, kernel path vs "
            f"plain path: relative L2 {dists} (limit {lim}), max |diff| "
            f"{maxes}, same top-1 {top}; planted faults on the first: "
            f"{faults}; in fp32 {fp32}; each bf16 path against the plain "
            f"fp32 logits {witness}, plain bf16 same top-1 as fp32 "
            f"{bf16_top}")
        check(max(dists) <= lim, f"[5rg] the prefills' last logits: "
              f"relative L2 |kernel - plain| {max(dists):.4g} > {lim}")
        check(all(top), f"[5rg] the kernel path's top-1 differs from the "
                        f"plain path's: {top}")
        check(faults["decay_30pc"]["rel_l2"] > lim, f"[5rg] the planted "
              f"fault (decay 30 % off) moved the plain path's logits only "
              f"{faults['decay_30pc']['rel_l2']:.4g}: the limit {lim} would "
              "not catch it")
        check(fp32["kernel_vs_plain"] <= lim32 and fp32["same_top1"],
              f"[5rg] fp32: kernel path vs plain path {fp32}")
        check(fp32["adapter_w_30pc_vs_plain"] > lim32, f"[5rg] fp32: the "
              f"planted adapter fault moved the logits only "
              f"{fp32['adapter_w_30pc_vs_plain']:.4g}, within {lim32}")
        check(witness["kernel_bf16"] <= ratio * witness["plain_bf16"],
              f"[5rg] the bf16 kernel path is further from the fp32 logits "
              f"than {ratio} x the plain bf16 path's: {witness}")
        del eng, got, want_l, want_0, got_0, ref32, layer
        release()
        phase_done("5rg")
        # the serve launcher itself, at recurrentgemma-2b, on the card
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            launcher.main(["--arch", RGEMMA["arch"], "--requests", "2",
                           "--num-slots", "2", "--prompt-len", "128",
                           "--new-tokens", "8", "--seed",
                           str(RGEMMA["seed"])])
        text = out.getvalue()
        check("served 2 requests / 16 tokens" in text
              and torch.cuda.get_device_name(0) in text,
              f"[5rg] the launcher printed {text[-800:]!r}")
        rg_reports["5rg"]["launcher_s"] = time.perf_counter() - t0
        log(f"[5rg] launcher --arch {RGEMMA['arch']} in "
            f"{rg_reports['5rg']['launcher_s']:.1f} s: "
            + " | ".join(ln for ln in text.splitlines()
                         if ln.startswith("served")))
        release()
        phase_done("5rg launcher")
        L, A = r_layers, r_attn
        # 6rg: a 3-task bank (#6 at every seam, the rec layers' too)
        eng = launcher.build_engine(rcfg, seed=RGEMMA["seed"], tasks=TASKS,
                                    device=dev)
        reqs = launcher.make_requests(rcfg, SERVE["requests"],
                                      SERVE["prompt_len"], SERVE["new_tokens"],
                                      TASKS, RGEMMA["seed"])
        rg_serve_run("6rg", eng, reqs, {
            "tick": {"paged_attention": A, "multitask_hadamard": L},
            "prefill": {"flash_attention": A, "multitask_hadamard": L}})
        del eng
        release()
        phase_done("6rg")
        # 6rgs: a 3-row hot-swap bank over 3 tenants, task0 and task2
        # pruned to the paper-0.022 preset (17 of 26 layers)
        base = launcher.build_base(rcfg, RGEMMA["seed"], dev)
        variants = launcher.task_variants(base, RGEMMA["seed"], TASKS)
        pmask = preset_mask(rcfg)
        check(int(pmask.sum()) == 17, f"[6rgs] paper-0.022 keeps "
              f"{int(pmask.sum())} of {L}")
        masks = [pmask if t % 2 == 0 else None for t in range(TASKS)]
        with tempfile.TemporaryDirectory() as td:
            registry = AdapterRegistry(td)
            for t, (v, m) in enumerate(zip(variants, masks)):
                if m is not None:
                    v = apply_layer_mask(v, rcfg, m)
                registry.publish(f"task{t}", launcher.task_delta(v, rcfg, m))
            eng = MultiTaskEngine(rcfg, AdapterBank(rcfg, base, TASKS,
                                                    registry), device=dev)
            reqs = launcher.make_requests(rcfg, SERVE["requests"],
                                          SERVE["prompt_len"],
                                          SERVE["new_tokens"], TASKS,
                                          RGEMMA["seed"], named=True)
            rg_serve_run("6rgs", eng, reqs, {
                "tick": {"paged_attention": A, masked_name: L},
                "prefill": {"flash_attention": A, masked_name: L}})
            bank = eng.adapter_bank
            for name in bank.resident:
                t = int(name.removeprefix("task"))
                want_g = (masks[t] if masks[t] is not None else
                          np.ones(L, bool)).astype(np.float32)
                check((bank.gates()[:, bank.row_of(name)] == want_g).all(),
                      f"[6rgs] {name}'s gates are not its mask")
            rg_reports["6rgs"].update(bank=bank.stats(),
                                      kept_layers=int(pmask.sum()))
        del eng, base, variants, bank
        release()
        phase_done("6rgs")
        # 5rgq: an int8 trunk, JAX's 19 leaves: 4 attention projections in
        # 8 layers and 3 MLP projections in 26 (110 #7 a call); the rec
        # projections stay bf16 and the tied head is no leaf
        n_dq = 4 * A + 3 * L
        eng = launcher.build_engine(rcfg, seed=RGEMMA["seed"], device=dev,
                                    quant="int8")
        qs = quant_summary(eng.params, lambda p: convert.jax_path(p, rcfg))
        check(qs["n_quantized_leaves"] == RGEMMA["quant_leaves"],
              f"[5rgq] {qs['n_quantized_leaves']} quantized leaves, JAX "
              f"quantizes {RGEMMA['quant_leaves']}")
        check(not any(isinstance(t, QTensor) for p, t in
                      tu.flatten_with_paths(eng.params) if "/rec/" in p),
              "[5rgq] a rec leaf was quantized")
        reqs = launcher.make_requests(rcfg, SERVE["requests"],
                                      SERVE["prompt_len"], SERVE["new_tokens"],
                                      0, RGEMMA["seed"])
        rg_serve_run("5rgq", eng, reqs, {
            "tick": {"paged_attention": A, "fused_adapter_norm": L,
                     "dequant_matmul": n_dq},
            "prefill": {"flash_attention": A, "fused_adapter_norm": L,
                        "dequant_matmul": n_dq}})
        rg_reports["5rgq"].update(quant_line=launcher.quant_line(eng),
                                  quantized_bytes=qs["quantized_bytes"],
                                  tree_bytes=qs["total_bytes"])
        log(f"[5rgq] {rg_reports['5rgq']['quant_line']}")
        del eng
        release()
        phase_done("5rgq")

    # -- phases 3rg, 4rg, 5rg, 6rg, 6rgs, 5rgq: recurrentgemma-2b -----------
    rg_kernels()
    rg_fp32_model()
    rg_serve()
    launches.update(rg_launches)
    serve_reports.update({p: rg_reports[p]
                          for p in ("5rg", "6rg", "6rgs", "5rgq")})

    # -- the encoder-decoder and VLM phases (3wt-8wt, 3iv-8iv) -------------
    # whisper-tiny (configs/whisper_tiny.py): 4 encoder + 4 decoder layers,
    # d 384, MHA 6/6 of 64, LayerNorm with biases, learned positions, 1500
    # frames, a tied vocabulary of 51,865; ~99 MB in bf16. internvl2-76b
    # (configs/internvl2_76b.py) at full width and 8 of its 80 layers: d
    # 8192, GQA 64/8 of 128, d_ff 28,672, RMSNorm, an untied vocabulary of
    # 128,256 and vlm_proj; ~18.0 GB in bf16 (the whole model, ~141 GB, fits
    # no one card). Neither has a scheduler in JAX: the phases drive the
    # model functions themselves (encode_audio, prefill_encdec,
    # decode_encdec; prefill_lm and decode_lm with patches), encdec_loss and
    # lm_loss over build_train_step
    from repro_torch.common.types import OptimCfg
    from repro_torch.configs.util import dense_decoder
    from repro_torch.core import peft
    from repro_torch.core.hadamard import perturb_adapters as perturb
    from repro_torch.data.synthetic import lm_batches, lm_corpus
    from repro_torch.models.attention import decode_page, decode_tables
    from repro_torch.models.layers import apply_norm
    from repro_torch.train import losses as losses_mod
    from repro_torch.train.steps import build_train_step, make_state

    wcfg = launcher.build_config(WHISPER["arch"])
    icfg = launcher.build_config(INTERNVL["arch"]).replace(
        groups=dense_decoder(INTERNVL["layers"]))
    fam_launches, fam_reports = {}, {}
    fam_train_launches, fam_step_calls = {}, {}

    def rel_dist(a_, b_):
        """The relative L2 distance of a from b, in fp64."""
        return ((a_.double() - b_.double()).norm()
                / b_.double().norm()).item()

    def launches_of(fn):
        """(fn's result, the launches each wrapper counted inside it)."""
        before = _build.launch_counts()
        out = fn()
        after = _build.launch_counts()
        return out, {k: after[k] - before[k] for k in after}

    def want_launches(tag, what, got, want):
        """got launched exactly `want` ({kernel: n}) and nothing else."""
        full = {k: want.get(k, 0) for k in got}
        check(got == full, f"[{tag}] {what} launched {got}, want {full}")

    def sharpen(params):
        """Every norm's scale and bias moved off 1 and 0 and every query
        and key projection scaled by 8, in place (as the CPU tests do): at
        init (std 0.02) attention is near uniform and the norms are equal,
        which would hide a fault in the norm that feeds a query."""
        g_ = torch.Generator(device=dev).manual_seed(7)
        with torch.no_grad():
            for path, leaf in tu.flatten_with_paths(params):
                if re.search(r"norm/(scale|bias)$", path):
                    leaf.add_(0.5 * torch.randn(leaf.shape, generator=g_,
                                                device=dev).to(leaf.dtype))
                elif re.search(r"/(wq|wk)$", path):
                    leaf.mul_(8.0)
        return params

    def seed_tokens(n, s, vocab, seed):
        g_ = torch.Generator(device=dev).manual_seed(seed)
        return torch.randint(10, vocab, (n, s), generator=g_, device=dev)

    def seed_embeds(*shape, dtype, seed):
        """Frame or patch embeddings (the stubbed front ends' outputs),
        made on the card from a seed."""
        g_ = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, generator=g_, device=dev).to(dtype)

    def fam_kernels(tag, arch, attn_cases, paged_cases, norm_cases,
                    norm_kind, train_cases):
        """#4, #5, #3 and #2 at a family's shapes: each case against its
        plain version in fp32 and bf16 (a kernel's own output the same bits
        twice; #3's autograd Function, whose backward runs #2, against
        autograd through the plain forward), then timed L2-cold in bf16
        (#2 on the fp32 cotangent the norm VJP hands it) beside its bound
        and one PyTorch call. attn_cases: (key, b, H, KH, Sq, Skv, D,
        causal); paged_cases: (key, b, H, KH, D, L, kv_lens); norm_cases:
        (key, rows, S, d); train_cases: (key, rows, d), the first timed."""
        for key, b_, H, KH, sq, skv, D, causal in attn_cases:
            what = (f"({b_},{H}|{KH},{sq}|{skv},{D}) "
                    f"{'causal' if causal else 'non-causal'}")
            for dt in (f32, bf):
                q = randn(b_, H, sq, D, dtype=dt)
                k, v = randn(b_, KH, skv, D, dtype=dt), randn(b_, KH, skv, D,
                                                              dtype=dt)
                compare("flash_attention", f"{arch} {key} {what}", dt,
                        lambda: ops.flash_attention(q, k, v, causal=causal,
                                                    impl="kernel"),
                        lambda: ops.flash_attention(q, k, v, causal=causal,
                                                    impl="ref"))
                same_bits(lambda: ops.flash_attention(q, k, v, causal=causal,
                                                      impl="kernel"),
                          f"flash_attention {arch} {key} {dt}")
                del q, k, v
            qkvs = copies_of(lambda: (randn(b_, H, sq, D, dtype=bf),
                                      randn(b_, KH, skv, D, dtype=bf),
                                      randn(b_, KH, skv, D, dtype=bf)),
                             2 * b_ * (H * sq + 2 * KH * skv) * D)
            q = qkvs[0][0]
            pairs = b_ * sum(min(i + 1 + skv - sq, skv) for i in range(sq)) \
                if causal else b_ * sq * skv
            record(f"flash_attention@{tag}_{key}", "flash_attention",
                   f"q ({b_},{H},{sq},{D}) over k/v ({b_},{KH},{skv},{D}) "
                   f"bf16, {'causal' if causal else 'non-causal'} "
                   f"({len(qkvs)} copies in turn; one {arch} {key} "
                   f"attention call)", bf,
                   rotating(qkvs, lambda q_, k_, v_: ops.flash_attention(
                       q_, k_, v_, causal=causal, impl="kernel")),
                   rotating(qkvs, lambda q_, k_, v_: ops.flash_attention(
                       q_, k_, v_, causal=causal, impl="ref")),
                   rotating(qkvs, lambda q_, k_, v_:
                            F.scaled_dot_product_attention(
                                q_, k_, v_, is_causal=causal,
                                enable_gqa=H != KH)),
                   2 * nbytes(q) + nbytes(*qkvs[0][1:]), 4 * H * D * pairs,
                   iters=len(qkvs), reps=2)
            results[f"flash_attention@{tag}_{key}"]["library_note"] = (
                f"scaled_dot_product_attention(is_causal={causal}): the same "
                "function")
            del qkvs, q
            torch.cuda.empty_cache()  # the copies hold no cycle
        for key, b_, H, KH, D, L, lens in paged_cases:
            page = decode_page(L)
            nbt = L // page
            tables = decode_tables(b_, L, dev)
            kl_t = torch.tensor(lens, dtype=torch.int32, device=dev)
            what = (f"q ({b_},{H},{D}) over ({b_},{L},{KH},{D}) in "
                    f"{page}-token pages, kv_lens {sorted(set(lens))}")
            for dt in (f32, bf):
                q = randn(b_, H, D, dtype=dt)
                kc = randn(b_ * nbt, page, KH, D, dtype=dt)
                vc = randn(b_ * nbt, page, KH, D, dtype=dt)
                compare("paged_attention", f"{arch} {key} {what}", dt,
                        lambda: ops.paged_attention(q, kc, vc, tables, kl_t,
                                                    impl="kernel"),
                        lambda: ops.paged_attention(q, kc, vc, tables, kl_t,
                                                    impl="ref"))
                same_bits(lambda: ops.paged_attention(q, kc, vc, tables,
                                                      kl_t, impl="kernel"),
                          f"paged_attention {arch} {key} {dt}")
                del q, kc, vc
            pcopies = copies_of(
                lambda: (randn(b_, H, D, dtype=bf),
                         randn(b_ * nbt, page, KH, D, dtype=bf),
                         randn(b_ * nbt, page, KH, D, dtype=bf)),
                2 * b_ * L * KH * D * 2)
            full = all(n == L for n in lens)
            key_mask = (torch.arange(L, device=dev)[None, :]
                        < kl_t[:, None])[:, None, None, :]

            def sdpa(q_, kp_, vp_, b_=b_, L=L, KH=KH, D=D, full=full,
                     key_mask=key_mask, gqa=H != KH):
                k_ = kp_.view(b_, L, KH, D).transpose(1, 2)
                v_ = vp_.view(b_, L, KH, D).transpose(1, 2)
                return F.scaled_dot_product_attention(
                    q_[:, :, None], k_, v_,
                    attn_mask=None if full else key_mask, enable_gqa=gqa)

            plan = paged_split_plan(b_, H, KH, 1, D, page, nbt)
            keys_read = sum(lens)
            record(f"paged_attention@{tag}_{key}", "paged_attention",
                   f"{what} bf16 ({len(pcopies)} copies in turn; one {arch} "
                   f"{key} layer of a decode tick; {plan['splits']} splits, "
                   f"{plan['row_chunks']} row chunks of "
                   f"{plan['rows_per_block']}, {plan['blocks']} blocks)", bf,
                   rotating(pcopies, lambda q_, kp_, vp_: ops.paged_attention(
                       q_, kp_, vp_, tables, kl_t, impl="kernel")),
                   rotating(pcopies, lambda q_, kp_, vp_: ops.paged_attention(
                       q_, kp_, vp_, tables, kl_t, impl="ref")),
                   rotating(pcopies, sdpa),
                   nbytes(pcopies[0][0], tables, kl_t)
                   + keys_read * KH * D * 2 * 2 + b_ * H * D * 4,
                   4 * H * D * keys_read, iters=len(pcopies), reps=3)
            results[f"paged_attention@{tag}_{key}"].update(
                library_note=(
                    "scaled_dot_product_attention over the contiguous cache"
                    + ("" if full else " with a key mask")
                    + ": the same function"), split_plan=plan)
            del pcopies
            torch.cuda.empty_cache()  # the copies hold no cycle
        for key, rows, S, d_ in norm_cases:
            w, b = 1 + randn(d_, scale=0.1), randn(d_, scale=0.1)
            ln = norm_kind == "layernorm"
            for dt in (f32, bf):
                x, res = randn(rows, S, d_, dtype=dt), randn(rows, S, d_,
                                                             dtype=dt)
                scale = 1 + randn(d_, dtype=dt, scale=0.1)
                bias = randn(d_, dtype=dt, scale=0.1) if ln else None
                plan = fused_norm_plan(rows * S, d_, dt)
                compare("fused_adapter_norm", f"{arch} ({rows},{S},{d_}) "
                        f"{norm_kind} {plan['kernel']}", dt,
                        lambda: ops.fused_adapter_norm(x, res, w, b, scale,
                                                       bias, impl="kernel"),
                        lambda: ops.fused_adapter_norm(x, res, w, b, scale,
                                                       bias, impl="ref"))
                same_bits(lambda: ops.fused_adapter_norm(
                    x, res, w, b, scale, bias, impl="kernel"),
                    f"fused_adapter_norm {arch} ({rows},{S}) {dt}")
            scale = 1 + randn(d_, dtype=bf, scale=0.1)
            bias = randn(d_, dtype=bf, scale=0.1) if ln else None
            xrs = copies_of(lambda: (randn(rows, S, d_, dtype=bf),
                                     randn(rows, S, d_, dtype=bf)),
                            4 * rows * S * d_)
            plan = fused_norm_plan(rows * S, d_, bf)
            yard = (lambda x_, r_: F.layer_norm(x_, (d_,), scale, bias,
                                                1e-6)) if ln else \
                (lambda x_, r_: F.rms_norm(x_, (d_,), scale, 1e-6))
            record(f"fused_adapter_norm@{tag}_{key}", "fused_adapter_norm",
                   f"x,res ({rows},{S},{d_}) bf16 ({len(xrs)} copies in "
                   f"turn), fp32 w/b, {norm_kind} (one {arch} seam; "
                   f"{plan['kernel']}, {plan['blocks']} blocks)", bf,
                   rotating(xrs, lambda x_, r_: ops.fused_adapter_norm(
                       x_, r_, w, b, scale, bias, impl="kernel")),
                   rotating(xrs, lambda x_, r_: ops.fused_adapter_norm(
                       x_, r_, w, b, scale, bias, impl="ref")),
                   None, 4 * nbytes(xrs[0][0]) + nbytes(w, b, scale, bias),
                   8 * xrs[0][0].numel(), yardstick_fn=rotating(xrs, yard),
                   iters=len(xrs), reps=2)
            results[f"fused_adapter_norm@{tag}_{key}"].update(
                library_note=f"none: {'layer_norm' if ln else 'rms_norm'} "
                             "takes no adapter affine or residual; the "
                             f"yardstick is F.{'layer_norm' if ln else 'rms_norm'}"
                             " of x alone", split_plan=plan)
            del xrs
            torch.cuda.empty_cache()  # the copies hold no cycle
        ln = norm_kind == "layernorm"
        for i, (key, n_, d_) in enumerate(train_cases):
            w, b = 1 + randn(d_, scale=0.1), randn(d_, scale=0.1)
            for dt in (f32, bf):
                x, res = randn(n_, d_, dtype=dt), randn(n_, d_, dtype=dt)
                scale = 1 + randn(d_, dtype=dt, scale=0.1)
                ins = (x, res, w, b, scale) + (
                    (randn(d_, dtype=dt, scale=0.1),) if ln else ())
                cots = (randn(n_, d_, dtype=dt), randn(n_, d_, dtype=dt))
                compare("fused_adapter_norm_bwd", f"{arch} {key} ({n_},{d_}) "
                        f"{norm_kind}", dt,
                        lambda: grads_of(lambda *t: FusedAdapterResidualNorm
                                         .apply(*t[:5], t[5] if ln else None,
                                                1e-6, "kernel"), ins, cots),
                        lambda: grads_of(lambda *t: ref
                                         .fused_adapter_residual_norm_ref(
                                             *t[:5], eps=1e-6,
                                             bias=t[5] if ln else None),
                                         ins, cots),
                        summed=(2, 3, 4, 5))
                gt = randn(n_, d_)  # the fp32 cotangent the norm VJP hands on
                compare("hadamard_affine_bwd", f"{arch} {key} g ({n_},{d_}) "
                        f"fp32, x {str(dt)[6:]}", dt,
                        lambda: ops.hadamard_affine_bwd(gt, x, w,
                                                        impl="kernel"),
                        lambda: ops.hadamard_affine_bwd(gt, x, w,
                                                        impl="ref"),
                        summed=(1, 2))
                del x, res, ins, cots, gt
            if i:
                continue
            gxs = copies_of(lambda: (randn(n_, d_), randn(n_, d_, dtype=bf)),
                            6 * n_ * d_)
            record(f"hadamard_affine_bwd@{tag}_{key}", "hadamard_affine_bwd",
                   f"g ({n_},{d_}) fp32, x ({n_},{d_}) bf16 ({len(gxs)} "
                   f"copies in turn), fp32 w (one {arch} seam of a train "
                   "step's backward, under #3)", f32,
                   rotating(gxs, lambda g_, x_: ops.hadamard_affine_bwd(
                       g_, x_, w, impl="kernel")),
                   rotating(gxs, lambda g_, x_: ops.hadamard_affine_bwd(
                       g_, x_, w, impl="ref")),
                   None,
                   # read g, x, w; write dx (fp32), dw, db
                   2 * nbytes(gxs[0][0]) + nbytes(gxs[0][1], w) + 2 * d_ * 4,
                   4 * n_ * d_, iters=len(gxs), reps=2)
            results[f"hadamard_affine_bwd@{tag}_{key}"]["library_note"] = (
                "none: no one call gives g*w with the column sums of g*x "
                "and g")
            del gxs
            torch.cuda.empty_cache()  # the copies hold no cycle

    def wt_kernels():
        """Phase 3wt: #4, #5 and #3 at whisper-tiny's shapes (and #4's
        backward at the cross-attention prefill)."""
        H, KH, D, d_w = wcfg.n_heads, wcfg.n_kv_heads, wcfg.head_dim, \
            wcfg.d_model
        B, Fr, S, L = WHISPER["clips"], wcfg.n_audio_frames, \
            WHISPER["prompt"], WHISPER["cache_len"]
        fam_kernels(
            "whisper", "whisper-tiny",
            (("encoder", B, H, KH, Fr, Fr, D, False),
             ("cross", B, H, KH, S, Fr, D, False),
             ("cross_long", 1, H, KH, 2048, Fr, D, False)),
            (("cross", B, H, KH, D, Fr, [Fr] * B),
             ("self", B, H, KH, D, L, [S + 1 + 8 * i for i in range(B)])),
            (("encoder", B, Fr, d_w), ("decode", B, 1, d_w)), "layernorm",
            (("train_encoder", B * Fr, d_w),
             ("train_decoder", B * WHISPER["train_seq"], d_w)))
        # the backward of FlashAttention at the cross prefill (16 queries
        # over 1500 keys) against autograd through the plain forward
        for dt in (f32, bf):
            q, g = randn(B, H, S, D, dtype=dt), randn(B, H, S, D, dtype=dt)
            k, v = randn(B, KH, Fr, D, dtype=dt), randn(B, KH, Fr, D,
                                                        dtype=dt)
            compare("flash_attention_bwd", f"whisper cross ({B},{H},{S}|{Fr},"
                    f"{D}) non-causal", dt,
                    lambda: grads_of(lambda *t: FlashAttention.apply(
                        *t, False, None, None, 0.0, "kernel"), (q, k, v),
                        (g,)),
                    lambda: grads_of(lambda *t: ops.flash_attention(
                        *t, causal=False, impl="ref"), (q, k, v), (g,)))
        log(f"[3wt] whisper-tiny: {errors('flash_attention')}; backward "
            f"{checks['flash_attention_bwd']['errs'][-1]:.3g} fp32, "
            f"{checks['flash_attention_bwd']['rels'][-1]:.3g} bf16 / max|ref|"
            f"; paged {errors('paged_attention')}; #3 "
            f"{errors('fused_adapter_norm')}; #3's backward "
            f"{errors('fused_adapter_norm_bwd')}; #2 "
            f"{errors('hadamard_affine_bwd')}")
        phase_done("3wt")

    def encdec_run(params, cfg_, frames, toks, steps_, impl):
        """prefill_encdec, then `steps_` greedy decode_encdec steps:
        (logits of each call, tokens (B, 1 + steps_), each call's
        launches)."""
        S, L = toks.shape[1], WHISPER["cache_len"]
        (lg, caches), n = launches_of(lambda: M.prefill_encdec(
            params, cfg_, frames, toks, L, impl=impl))
        outs, calls, tok = [lg], [n], lg.argmax(-1)
        out_toks = [tok]
        for step in range(steps_):
            (lg, caches), n = launches_of(lambda: M.decode_encdec(
                params, cfg_, caches, tok, S + step, impl=impl))
            outs.append(lg)
            calls.append(n)
            tok = lg.argmax(-1)
            out_toks.append(tok)
        return outs, torch.cat(out_toks, 1), calls

    def wt_fp32_model():
        """Phase 4wt: whisper-tiny in fp32 (TF32 off) at full width and
        depth, the same seeded weights with perturbed adapters (norms moved
        off their init and q/k sharpened, `sharpen`): 4 clips of 1500
        frames, 16-token prompts, a prefill and 8 greedy decode steps
        through the kernels against the plain path (impl="ref"), each
        call's logits within WHISPER["fp32_tol"] relative L2, the greedy
        tokens equal, each call's launches as predicted; two planted faults
        (every encoder adapter's w 30 % off, the decoder's seams
        normalised by ffn_norm in place of cross_norm) past the limit."""
        cfg32 = wcfg.replace(param_dtype="float32", compute_dtype="float32")
        params = sharpen(perturb(M.init_params(
            torch.Generator(device=dev).manual_seed(WHISPER["seed"]), cfg32),
            WHISPER["seed"] + 100, scale=0.2))
        B4, Fr, S, n = WHISPER["clips_4wt"], cfg32.n_audio_frames, \
            WHISPER["prompt"], WHISPER["steps_4wt"]
        frames = seed_embeds(B4, Fr, cfg32.d_model, dtype=f32, seed=1)
        toks = seed_tokens(B4, S, cfg32.vocab_size, 2)
        with torch.no_grad():
            ref_outs, ref_toks, ref_calls = encdec_run(params, cfg32, frames,
                                                       toks, n, "ref")
            ker_outs, ker_toks, ker_calls = encdec_run(params, cfg32, frames,
                                                       toks, n, "auto")
            check(all(not any(c.values()) for c in ref_calls),
                  f"[4wt] the plain path launched {ref_calls}")
            Le = len(cfg32.layer_slots())
            want_launches("4wt", "the prefill", ker_calls[0],
                          {"flash_attention": 3 * Le,
                           "fused_adapter_norm": 2 * Le})
            for c in ker_calls[1:]:
                want_launches("4wt", "a decode step", c,
                              {"paged_attention": 2 * Le,
                               "fused_adapter_norm": Le})
            dists = [rel_dist(a_, b_) for a_, b_ in zip(ker_outs, ref_outs)]
            # the planted faults, through the kernels on the prefill
            enc_w = dict(params, enc_layers=[
                dict(lyr, adapter=dict(lyr["adapter"],
                                       w=lyr["adapter"]["w"] * 1.3))
                for lyr in params["enc_layers"]])
            seam = dict(params, layers=[dict(lyr, cross_norm=lyr["ffn_norm"])
                                        for lyr in params["layers"]])
            faults = {name: rel_dist(M.prefill_encdec(
                p_, cfg32, frames, toks, WHISPER["cache_len"])[0],
                ref_outs[0]) for name, p_ in (("encoder_adapter_w_30pc", enc_w),
                                              ("seam_ffn_norm", seam))}
        lim = WHISPER["fp32_tol"]
        log(f"[4wt] whisper-tiny fp32 on {smi}: {B4} clips x {Fr} frames, "
            f"{S}-token prompts, {n} greedy steps; kernel path vs plain path "
            f"relative L2 prefill {dists[0]:.3g}, steps max "
            f"{max(dists[1:]):.3g} (limit {lim}); tokens equal "
            f"{torch.equal(ker_toks, ref_toks)}; planted faults {faults}; "
            f"launches a prefill {ker_calls[0]}, a step {ker_calls[1]}")
        check(max(dists) <= lim, f"[4wt] kernel path vs plain path {dists}")
        check(torch.equal(ker_toks, ref_toks), "[4wt] greedy tokens differ")
        check(all(v > lim for v in faults.values()),
              f"[4wt] a planted fault within the limit {lim}: {faults}")
        fam_reports["4wt"] = dict(rel_l2=dists, faults=faults, limit=lim,
                                  launches_prefill=ker_calls[0],
                                  launches_step=ker_calls[1])
        del params, enc_w, seam
        release()
        phase_done("4wt")

    def fam_tick_report(tag, prefill_fn, tick_fn, per_tick, per_prefill):
        """A tick's and a prefill's profile (device ms, busy share,
        kernels, the port's kernels' us), each checked against the
        wrappers' counts."""
        tick = profile_calls(tick_fn, 5)
        pre = profile_calls(prefill_fn, 2)
        check_profiled(tag, tick, per_tick)
        check_profiled(tag, pre, per_prefill)
        return tick, pre

    def wt_serve():
        """Phase 5wt: whisper-tiny bf16 at full width and depth, one
        perturbed adapter: 8 clips of 1500 seeded frames, 16-token prompts,
        64 greedy tokens, self-attention caches of 80: per tick 4 #5 self +
        4 #5 cross + 4 #3, per prefill 12 #4 + 8 #3; the plain path's tokens
        beside the kernel path's (agreement reported, bf16); device and
        host ms a tick and a prefill, a tick's profile."""
        params = launcher.build_params(wcfg, WHISPER["seed"], 0, dev)[0]
        n_params = tu.count_params(params)
        check(n_params == WHISPER["n_params"], f"[5wt] {n_params:,} "
              f"parameters, JAX counts {WHISPER['n_params']:,}")
        B, Fr, S, L = WHISPER["clips"], wcfg.n_audio_frames, \
            WHISPER["prompt"], WHISPER["cache_len"]
        steps_ = WHISPER["new_tokens"] - 1
        frames = seed_embeds(B, Fr, wcfg.d_model, dtype=bf, seed=3)
        toks = seed_tokens(B, S, wcfg.vocab_size, 4)
        Le = len(wcfg.layer_slots())
        with torch.no_grad():
            encdec_run(params, wcfg, frames, toks, 2, "auto")  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            outs, ker_toks, calls = encdec_run(params, wcfg, frames, toks,
                                               steps_, "auto")
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            want_launches("5wt", "the prefill", calls[0],
                          {"flash_attention": 3 * Le,
                           "fused_adapter_norm": 2 * Le})
            for c in calls[1:]:
                want_launches("5wt", "a decode tick", c,
                              {"paged_attention": 2 * Le,
                               "fused_adapter_norm": Le})
            check(all(bool(torch.isfinite(o).all()) for o in outs),
                  "[5wt] non-finite logits")
            check(bool(((ker_toks >= 0) & (ker_toks < wcfg.vocab_size)).all()),
                  "[5wt] token ids out of range")
            _, ref_toks, _ = encdec_run(params, wcfg, frames, toks, steps_,
                                        "ref")
            agree = (ker_toks == ref_toks).float().mean().item()
            # host ms: a prefill and a tick, each synced
            lg, caches = M.prefill_encdec(params, wcfg, frames, toks, L)
            tok = lg.argmax(-1)
            pre_host = time_host(lambda: M.prefill_encdec(
                params, wcfg, frames, toks, L), 3)
            tick_host = time_host(lambda: M.decode_encdec(
                params, wcfg, caches, tok, S + 5), 10)
            counts = {k: sum(c[k] for c in calls) for k in calls[0]}
            per_tick = {k: sorted({c[k] for c in calls[1:]}) for k in counts}
            per_prefill = {k: [calls[0][k]] for k in counts}
            tick, pre = fam_tick_report(
                "5wt", lambda: M.prefill_encdec(params, wcfg, frames, toks,
                                                L),
                lambda: M.decode_encdec(params, wcfg, caches, tok, S + 5),
                per_tick, per_prefill)
        fam_launches["5wt"] = counts
        fam_reports["5wt"] = dict(
            clips=B, frames=Fr, prompt=S, new_tokens=WHISPER["new_tokens"],
            cache_len=L, ticks=steps_, run_s=run_s,
            tok_per_s=B * WHISPER["new_tokens"] / run_s,
            host_ms_per_tick=tick_host, host_ms_per_prefill=pre_host,
            token_agreement_vs_plain=agree, n_params=n_params,
            peak_bytes_allocated=peak, launches_per_decode_tick=per_tick,
            launches_per_prefill=per_prefill, tick=tick, prefill=pre)
        log(f"[5wt] whisper-tiny bf16 on {smi}: {n_params:,} parameters; "
            f"{B} clips, {S}-token prompts, {WHISPER['new_tokens']} greedy "
            f"tokens in {run_s:.3f} s ({B * WHISPER['new_tokens'] / run_s:.1f}"
            f" tok/s); host ms a tick {tick_host:.3f}, a prefill "
            f"{pre_host:.3f}; tokens vs the plain path's {agree:.4f}; "
            f"launches {counts}; per tick {per_tick}; per prefill "
            f"{per_prefill}; peak {peak / 1e9:.3f} GB; tick {tick}; "
            f"prefill {pre}")
        del params, caches
        release()
        phase_done("5wt")

    def time_host(fn, n):
        """Host wall ms per call, each call ending in a device sync."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    def fam_train(tag, cfg_, batches, steps_, want_step, want_trainable,
                  params, fixed=None):
        """steps_ Hadamard steps of build_train_step (the family's loss)
        over `batches` from `params` (identity adapters moved by
        perturbation): finite losses, the trainable count JAX's, each
        step's launches `want_step`, every trainable leaf moved; with
        `fixed`, that batch's loss before and after (it must fall)."""
        strat = peft.strategy("hadamard")
        ocfg = OptimCfg(lr=3e-3, total_steps=steps_)
        state = make_state(None, cfg_, strat, ocfg, params=params)
        del params
        release()
        n_train = sum(x.numel() for x in state["trainable"].values())
        check(n_train == want_trainable, f"[{tag}] {n_train:,} trainable, "
              f"JAX's {want_trainable:,}")
        start = {p: x.detach().clone() for p, x in state["trainable"].items()}
        loss_fn = losses_mod.loss_for(cfg_)

        def probe():
            with torch.no_grad():
                return loss_fn(cfg_, state["params"], fixed)[0].item()

        before = probe() if fixed is not None else None
        step = build_train_step(cfg_, ocfg)
        hist, calls, times = [], [], []
        for b_ in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (state, m), n = launches_of(lambda: step(state, b_))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            hist.append(m["loss"].item())
            calls.append(n)
            want_launches(tag, "a train step", n, want_step)
        after = probe() if fixed is not None else None
        check(all(math.isfinite(x) for x in hist), f"[{tag}] losses {hist}")
        moved = {p: bool((x.detach() != start[p]).any())
                 for p, x in state["trainable"].items()}
        check(all(moved.values()), f"[{tag}] leaves that did not move: "
              f"{[p for p, v in moved.items() if not v][:4]}")
        if fixed is not None:
            check(after < before, f"[{tag}] the fixed batch's loss "
                  f"{before:.5f} -> {after:.5f} did not fall")
        fam_train_launches[tag] = {k: sum(c[k] for c in calls)
                                   for k in calls[0]}
        fam_step_calls[tag] = calls
        rep = dict(steps=len(hist), losses=hist, trainable=n_train,
                   fixed_batch_loss=[before, after],
                   host_ms_per_step=times, moved_leaves=len(moved),
                   enc_leaves_moved=sum(p.startswith("enc_layers/")
                                        for p in moved),
                   peak_bytes_allocated=torch.cuda.max_memory_allocated())
        del state, step
        release()
        return rep

    def wt_train():
        """Phase 8wt: encdec_loss fine-tuning of whisper-tiny, Hadamard
        strategy, bf16, 8 clips x 64 tokens a step, 6 steps: a fixed
        batch's loss falls, every trainable leaf moves (the encoder's too),
        12,288 trainable (JAX's), 12 #4 + 8 #3 + 8 #2 a step."""
        B, Fr, S = WHISPER["clips"], wcfg.n_audio_frames, WHISPER["train_seq"]
        corpus = lm_corpus(wcfg.vocab_size, 20_000, seed=WHISPER["seed"])
        batches = []
        for i, b_ in enumerate(lm_batches(corpus, WHISPER["train_steps"], B,
                                          S, seed=WHISPER["seed"])):
            batches.append({"tokens": torch.from_numpy(b_["tokens"]).to(dev),
                            "labels": torch.from_numpy(b_["labels"]).to(dev),
                            "frames": seed_embeds(B, Fr, wcfg.d_model,
                                                  dtype=bf, seed=20 + i)})
        params = launcher.build_base(wcfg, WHISPER["seed"], dev)
        Le = len(wcfg.layer_slots()) + len(wcfg.enc_layer_slots())
        torch.cuda.reset_peak_memory_stats()
        rep = fam_train("8wt", wcfg, batches, len(batches),
                        {"flash_attention": 3 * len(wcfg.layer_slots()),
                         "fused_adapter_norm": Le,
                         "hadamard_affine_bwd": Le},
                        WHISPER["trainable"], params, fixed=batches[0])
        fam_reports["8wt"] = rep
        log(f"[8wt] whisper-tiny encdec_loss, hadamard, bf16, {B} clips x "
            f"{S} tokens on {smi}: {json.dumps(rep)}")
        phase_done("8wt")

    def iv_params(cfg_, seed):
        """internvl2 weights made on the card from a seed, adapters
        perturbed."""
        return perturb(M.init_params(torch.Generator(device=dev).manual_seed(
            seed), cfg_), seed + 100, scale=0.2)

    def iv_kernels():
        """Phase 3iv: #4, #5 and #3 at internvl2-76b's shapes."""
        H, KH, D, d_i = icfg.n_heads, icfg.n_kv_heads, icfg.head_dim, \
            icfg.d_model
        R, n_img, S, L = INTERNVL["requests"], icfg.n_image_tokens, \
            INTERNVL["text"], INTERNVL["cache_len"]
        T = n_img + S
        fam_kernels(
            "internvl2", "internvl2-76b",
            (("prefill", R, H, KH, T, T, D, True),),
            (("decode", R, H, KH, D, L, [T + 5, T + 20]),),
            (("decode", R, 1, d_i), ("prefill", R, T, d_i)), "rmsnorm",
            (("train", R * T, d_i),))
        log(f"[3iv] internvl2-76b: {errors('flash_attention')}; paged "
            f"{errors('paged_attention')}; #3 {errors('fused_adapter_norm')}"
            f"; #3's backward {errors('fused_adapter_norm_bwd')}; #2 "
            f"{errors('hadamard_affine_bwd')}")
        phase_done("3iv")

    def vlm_run(params, cfg_, patches, toks, steps_, impl):
        """prefill_lm with patches, then `steps_` greedy decode_lm steps at
        n_img + S onward: (logits of each call, tokens, each call's
        launches)."""
        R, T = toks.shape[0], patches.shape[1] + toks.shape[1]
        (lg, caches), n = launches_of(lambda: M.prefill_lm(
            params, cfg_, toks, INTERNVL["cache_len"], patches=patches,
            impl=impl))
        outs, calls, tok = [lg], [n], lg.argmax(-1)
        out_toks = [tok]
        for step in range(steps_):
            pos = torch.full((R,), T + step, dtype=torch.int32, device=dev)
            (lg, caches), n = launches_of(lambda: M.decode_lm(
                params, cfg_, caches, tok, pos, impl=impl))
            outs.append(lg)
            calls.append(n)
            tok = lg.argmax(-1)
            out_toks.append(tok)
        return outs, torch.cat(out_toks, 1), calls

    def iv_inputs(cfg_, dtype):
        R, S = INTERNVL["requests"], INTERNVL["text"]
        return (seed_embeds(R, cfg_.n_image_tokens, cfg_.d_model, dtype=dtype,
                            seed=5),
                seed_tokens(R, S, cfg_.vocab_size, 6))

    def iv_fp32_model():
        """Phase 4iv: internvl2-76b in fp32 (TF32 off) at full width and 2
        of its 80 layers: 2 requests of 256 patches + 128 text tokens, a
        prefill and 4 greedy decode steps through the kernels against the
        plain path, each call's logits within INTERNVL["fp32_tol"] relative
        L2 and the tokens equal; a planted fault (the text's RoPE positions
        restarted at 0 after the image rows) past the limit."""
        cfg32 = icfg.replace(groups=dense_decoder(INTERNVL["layers_4iv"]),
                             param_dtype="float32", compute_dtype="float32")
        params = iv_params(cfg32, INTERNVL["seed"])
        patches, toks = iv_inputs(cfg32, f32)
        n_img, S, n = cfg32.n_image_tokens, toks.shape[1], \
            INTERNVL["steps_4iv"]
        Lr = len(cfg32.layer_slots())
        with torch.no_grad():
            ref_outs, ref_toks, ref_calls = vlm_run(params, cfg32, patches,
                                                    toks, n, "ref")
            ker_outs, ker_toks, ker_calls = vlm_run(params, cfg32, patches,
                                                    toks, n, "auto")
            check(all(not any(c.values()) for c in ref_calls),
                  f"[4iv] the plain path launched {ref_calls}")
            want_launches("4iv", "the prefill", ker_calls[0],
                          {"flash_attention": Lr, "fused_adapter_norm": Lr})
            for c in ker_calls[1:]:
                want_launches("4iv", "a decode step", c,
                              {"paged_attention": Lr,
                               "fused_adapter_norm": Lr})
            dists = [rel_dist(a_, b_) for a_, b_ in zip(ker_outs, ref_outs)]
            # the planted fault: the text's positions restart at 0
            x = M._decoder_embed(params, cfg32, toks, patches)
            q_pos = torch.cat([torch.arange(n_img, device=dev),
                               torch.arange(S, device=dev)])
            x, _, _ = M._run_layers(params, cfg32, x, q_pos=q_pos,
                                    cache_len=INTERNVL["cache_len"])
            x = apply_norm(params["final_norm"], cfg32, x[:, -1:])
            fault = rel_dist(M.lm_logits(params, cfg32, x), ref_outs[0])
        lim = INTERNVL["fp32_tol"]
        log(f"[4iv] internvl2-76b fp32, {Lr} of 80 layers, on {smi}: "
            f"{patches.shape[0]} x ({n_img} patches + {S} tokens), {n} "
            f"greedy steps; kernel path vs plain path relative L2 prefill "
            f"{dists[0]:.3g}, steps max {max(dists[1:]):.3g} (limit {lim}); "
            f"tokens equal {torch.equal(ker_toks, ref_toks)}; planted fault "
            f"(text RoPE restarted at 0) {fault:.3g}; launches a prefill "
            f"{ker_calls[0]}, a step {ker_calls[1]}")
        check(max(dists) <= lim, f"[4iv] kernel path vs plain path {dists}")
        check(torch.equal(ker_toks, ref_toks), "[4iv] greedy tokens differ")
        check(fault > lim, f"[4iv] the planted fault {fault} within {lim}")
        fam_reports["4iv"] = dict(rel_l2=dists, rope_restart_fault=fault,
                                  limit=lim, launches_prefill=ker_calls[0],
                                  launches_step=ker_calls[1])
        del params, x
        release()
        phase_done("4iv")

    def iv_serve():
        """Phase 5iv: internvl2-76b bf16 at full width, 8 of 80 layers
        (9.01 B parameters, 18.0 GB), built on the card from a seed: 2
        requests of 256 seeded patch embeddings + 128 text tokens, 32
        greedy tokens, caches of 416: 8 #5 + 8 #3 a tick, 8 #4 + 8 #3 a
        prefill; reported as 5wt. Returns the parameters (8iv trains
        them)."""
        torch.cuda.synchronize()
        before_b = torch.cuda.memory_allocated()
        params = iv_params(icfg, INTERNVL["seed"])
        n_params = tu.count_params(params)
        weights = torch.cuda.memory_allocated() - before_b
        check(n_params == INTERNVL["n_params"], f"[5iv] {n_params:,} "
              f"parameters, JAX counts {INTERNVL['n_params']:,}")
        patches, toks = iv_inputs(icfg, bf)
        R, T, L = toks.shape[0], patches.shape[1] + toks.shape[1], \
            INTERNVL["cache_len"]
        steps_ = INTERNVL["new_tokens"] - 1
        Li = len(icfg.layer_slots())
        with torch.no_grad():
            vlm_run(params, icfg, patches, toks, 2, "auto")  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            outs, ker_toks, calls = vlm_run(params, icfg, patches, toks,
                                            steps_, "auto")
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            want_launches("5iv", "the prefill", calls[0],
                          {"flash_attention": Li, "fused_adapter_norm": Li})
            for c in calls[1:]:
                want_launches("5iv", "a decode tick", c,
                              {"paged_attention": Li,
                               "fused_adapter_norm": Li})
            check(all(bool(torch.isfinite(o).all()) for o in outs),
                  "[5iv] non-finite logits")
            _, ref_toks, _ = vlm_run(params, icfg, patches, toks, steps_,
                                     "ref")
            agree = (ker_toks == ref_toks).float().mean().item()
            lg, caches = M.prefill_lm(params, icfg, toks, L, patches=patches)
            tok = lg.argmax(-1)
            pos = torch.full((R,), T + 5, dtype=torch.int32, device=dev)
            pre_host = time_host(lambda: M.prefill_lm(
                params, icfg, toks, L, patches=patches), 3)
            tick_host = time_host(lambda: M.decode_lm(
                params, icfg, caches, tok, pos), 10)
            counts = {k: sum(c[k] for c in calls) for k in calls[0]}
            per_tick = {k: sorted({c[k] for c in calls[1:]}) for k in counts}
            per_prefill = {k: [calls[0][k]] for k in counts}
            tick, pre = fam_tick_report(
                "5iv", lambda: M.prefill_lm(params, icfg, toks, L,
                                            patches=patches),
                lambda: M.decode_lm(params, icfg, caches, tok, pos),
                per_tick, per_prefill)
        floor = weights / HBM_BYTES_PER_S * 1e3
        fam_launches["5iv"] = counts
        fam_reports["5iv"] = dict(
            requests=R, patches=patches.shape[1], text=toks.shape[1],
            new_tokens=INTERNVL["new_tokens"], cache_len=L, ticks=steps_,
            run_s=run_s, tok_per_s=R * INTERNVL["new_tokens"] / run_s,
            host_ms_per_tick=tick_host, host_ms_per_prefill=pre_host,
            token_agreement_vs_plain=agree, n_params=n_params,
            weights_bytes_allocated=weights, tick_read_floor_ms=floor,
            peak_bytes_allocated=peak, launches_per_decode_tick=per_tick,
            launches_per_prefill=per_prefill, tick=tick, prefill=pre)
        log(f"[5iv] internvl2-76b bf16, {Li} of 80 layers, on {smi}: "
            f"{n_params:,} parameters, {weights / 1e9:.2f} GB (a tick's "
            f"read floor {floor:.2f} ms); {R} x ({patches.shape[1]} patches "
            f"+ {toks.shape[1]} tokens), {INTERNVL['new_tokens']} greedy "
            f"tokens in {run_s:.3f} s; host ms a tick {tick_host:.3f}, a "
            f"prefill {pre_host:.3f}; tokens vs the plain path's "
            f"{agree:.4f}; launches {counts}; per tick {per_tick}; per "
            f"prefill {per_prefill}; peak {peak / 1e9:.2f} GB; tick {tick}; "
            f"prefill {pre}")
        del caches, lg, outs
        release()
        phase_done("5iv")
        return params

    def iv_train(params):
        """Phase 8iv: 2 Hadamard steps of lm_loss over the text positions
        of 2 x (256 patches + 128 tokens), bf16, 8 layers: finite losses,
        the adapters move, 196,608 trainable (JAX's), 8 #4 + 8 #3 + 8 #2 a
        step."""
        R, S = INTERNVL["requests"], INTERNVL["text"]
        batches = []
        for i in range(INTERNVL["train_steps"]):
            toks = seed_tokens(R, S + 1, icfg.vocab_size, 30 + i)
            batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                            "patches": seed_embeds(R, icfg.n_image_tokens,
                                                   icfg.d_model, dtype=bf,
                                                   seed=40 + i)})
        Li = len(icfg.layer_slots())
        torch.cuda.reset_peak_memory_stats()
        rep = fam_train("8iv", icfg, batches, len(batches),
                        {"flash_attention": Li, "fused_adapter_norm": Li,
                         "hadamard_affine_bwd": Li},
                        INTERNVL["trainable"], params)
        fam_reports["8iv"] = rep
        log(f"[8iv] internvl2-76b lm_loss over the text, hadamard, bf16, "
            f"{Li} layers, {R} x ({icfg.n_image_tokens} + {S}) on {smi}: "
            f"{json.dumps(rep)}")
        phase_done("8iv")

    # -- phases 3wt, 4wt, 5wt, 8wt, 3iv, 4iv, 5iv, 8iv ------------------------
    wt_kernels()
    wt_fp32_model()
    wt_serve()
    wt_train()
    iv_kernels()
    iv_fp32_model()
    iv_train(iv_serve())
    launches.update(fam_launches)
    serve_reports.update({p: fam_reports[p] for p in ("5wt", "5iv")})

    # -- the starcoder2 phases and the quantized trunks (3sc-5ivq) ----------
    # starcoder2-7b (configs/starcoder2_7b.py): 32 layers, d 4608, GQA 36/4
    # of 128, d_ff 18,432, pre-LN LayerNorm with biases in every norm and
    # projection, a non-gated GeLU MLP, an untied vocabulary of 49,152;
    # 14.8 GB in bf16. starcoder2-3b: 30 layers, d 3072, GQA 24/2; 6.4 GB.
    # Then the int8 trunks that no earlier phase served: starcoder2-7b's,
    # gemma2-27b's at full depth (built leaf by leaf in place by
    # build_engine, under QUANT_TRUNKS["build_peak_max"]) and internvl2-76b's
    # at 8 of 80 layers (vlm_proj and the untied head quantized too)
    from repro_torch.quant import quantize_owned

    scfg = launcher.build_config(STARCODER["arch"])
    scfg3 = launcher.build_config(STARCODER["small"])

    def sc_kernels():
        """Phase 3sc: #3 (LayerNorm with its bias), #4 causal and #5 at
        starcoder2-7b's and starcoder2-3b's serve shapes (fam_kernels, as
        3iv), and #7 at every (K, N) that 5scq, 5gq and 5ivq quantize and
        no earlier phase ran: each at M 4 (a 4-slot tick) and 128 (a
        prefill), fp32 and bf16 x, int8 and e4m3 values, against the plain
        version within phase 3's tolerances and the same bits twice; then
        timed L2-cold at M 4, bf16 x over int8 values, beside its bound,
        the library call and the bf16 matmul yardstick."""
        slots, S, Lc = SERVE["num_slots"], SERVE["prompt_len"], \
            SERVE["max_len"]
        lens = [S + 1 + 8 * i for i in range(slots)]
        t3 = {"attention and norms": 0.0, "#7 checks": 0.0, "#7 timing": 0.0}
        t0 = time.perf_counter()
        for arch_, c_ in ((STARCODER["arch"], scfg),
                          (STARCODER["small"], scfg3)):
            H, KH, D, d_ = c_.n_heads, c_.n_kv_heads, c_.head_dim, c_.d_model
            fam_kernels(
                "starcoder2_" + arch_.rsplit("-", 1)[1], arch_,
                (("prefill", 1, H, KH, S, S, D, True),),
                (("decode", slots, H, KH, D, Lc, lens),),
                (("decode", slots, 1, d_), ("prefill", 1, S, d_)),
                "layernorm", ())
        t3["attention and norms"] += time.perf_counter() - t0
        dq = checks["dequant_matmul"]
        n_f, n_b, dq_plans = len(dq["rel_errs"]), len(dq["rels"]), {}
        iv_rows = INTERNVL["requests"] * (icfg.n_image_tokens
                                          + INTERNVL["text"])
        for owner, tag, kns in QUANT_TRUNKS["dq_shapes"]:
            # internvl2's prefill runs 2 x (256 + 128) rows (5ivq)
            ms = (slots, S) + ((iv_rows,) if tag == "internvl2" else ())
            for K, N in kns:
                t0 = time.perf_counter()
                for vdt in VALUE_DTYPES:
                    (v, sc_), = quantized(K, N, vdt)
                    for m in ms:
                        for dt in (f32, bf):
                            x = randn(m, K, dtype=dt)
                            dq_plans[f"M={m} K={K} N={N} {str(dt)[6:]}"] = \
                                dequant_matmul_plan(m, K, N, dt, vdt)["kernel"]
                            case = f"{owner} M={m} K={K} N={N} {vdt}"
                            compare("dequant_matmul", case, dt,
                                    lambda: ops.dequant_matmul(
                                        x, v, sc_, impl="kernel"),
                                    lambda: ops.dequant_matmul(
                                        x, v, sc_, impl="ref"))
                            same_bits(lambda: ops.dequant_matmul(
                                x, v, sc_, impl="kernel"),
                                f"dequant_matmul {case} {dt}")
                            del x
                    del v, sc_
                t3["#7 checks"] += time.perf_counter() - t0
                t0 = time.perf_counter()
                time_dequant(f"dequant_matmul@{tag}_{K}x{N}", slots, K, N,
                             max(2, -(-100 * 2**20 // (K * N))),
                             f"a {owner} projection, a 4-slot decode tick")
                t3["#7 timing"] += time.perf_counter() - t0
        log(f"[3sc] starcoder2-7b and -3b: {errors('flash_attention')}; "
            f"paged {errors('paged_attention')}; #3 "
            f"{errors('fused_adapter_norm')}; dequant_matmul at "
            f"{[(o, k) for o, _, k in QUANT_TRUNKS['dq_shapes']]}, M {slots} "
            f"and {S}, int8 and e4m3: fp32 max abs err / max|ref| "
            f"{max(dq['rel_errs'][n_f:]):.3g} (tol {TOL['dequant_matmul']}), "
            f"bf16 {max(dq['rels'][n_b:]):.3g} (tol {BF16_TOL}); the same "
            f"bits twice; plans {dq_plans}; seconds by part {t3}")
        phase_done("3sc")

    def move_biases(params):
        """Every projection bias moved off 0, in place (the init's zeros
        would hide a dropped bias)."""
        g_ = torch.Generator(device=dev).manual_seed(9)
        with torch.no_grad():
            for path, leaf in tu.flatten_with_paths(params):
                if re.search(r"/(attn/b[qkvo]|mlp/b[io])$", path):
                    leaf.add_(0.1 * torch.randn(leaf.shape, generator=g_,
                                                device=dev).to(leaf.dtype))
        return params

    def text_run(params, cfg_, toks, steps_, impl, cache_len):
        """prefill_lm, then `steps_` greedy decode_lm steps: (logits of
        each call, tokens, each call's launches)."""
        R, S = toks.shape
        (lg, caches), n = launches_of(lambda: M.prefill_lm(
            params, cfg_, toks, cache_len, impl=impl))
        outs, calls, tok = [lg], [n], lg.argmax(-1)
        out_toks = [tok]
        for step in range(steps_):
            pos = torch.full((R,), S + step, dtype=torch.int32, device=dev)
            (lg, caches), n = launches_of(lambda: M.decode_lm(
                params, cfg_, caches, tok, pos, impl=impl))
            outs.append(lg)
            calls.append(n)
            tok = lg.argmax(-1)
            out_toks.append(tok)
        return outs, torch.cat(out_toks, 1), calls

    def sc_fp32_model():
        """Phase 4sc: starcoder2-7b in fp32 (TF32 off) at full width and 2
        layers, adapters perturbed, norms and q/k sharpened and every
        projection bias moved off 0: 2 prompts of 128 tokens, a prefill and
        4 greedy decode steps through the kernels against the plain path,
        each call's logits within STARCODER["fp32_tol"] relative L2, the
        tokens equal, each call's launches as predicted; two planted
        faults (every adapter's w 30 % further from 1, every attention
        bias dropped) past the limit."""
        cfg32 = scfg.replace(groups=dense_decoder(STARCODER["layers_4sc"]),
                             param_dtype="float32", compute_dtype="float32")
        params = move_biases(sharpen(perturb(M.init_params(
            torch.Generator(device=dev).manual_seed(STARCODER["seed"]),
            cfg32), STARCODER["seed"] + 100, scale=0.2)))
        toks = seed_tokens(2, SERVE["prompt_len"], cfg32.vocab_size, 12)
        n, Lq, Lc = STARCODER["steps_4sc"], cfg32.n_layers, SERVE["max_len"]
        with torch.no_grad():
            ref_outs, ref_toks, ref_calls = text_run(params, cfg32, toks, n,
                                                     "ref", Lc)
            ker_outs, ker_toks, ker_calls = text_run(params, cfg32, toks, n,
                                                     "auto", Lc)
            check(all(not any(c.values()) for c in ref_calls),
                  f"[4sc] the plain path launched {ref_calls}")
            want_launches("4sc", "the prefill", ker_calls[0],
                          {"flash_attention": Lq, "fused_adapter_norm": Lq})
            for c in ker_calls[1:]:
                want_launches("4sc", "a decode step", c,
                              {"paged_attention": Lq,
                               "fused_adapter_norm": Lq})
            dists = [rel_dist(a_, b_) for a_, b_ in zip(ker_outs, ref_outs)]
            adapter_w = dict(params, layers=[
                dict(lyr, adapter=dict(lyr["adapter"], w=1 + 1.3 * (
                    lyr["adapter"]["w"] - 1))) for lyr in params["layers"]])
            no_bias = dict(params, layers=[
                dict(lyr, attn={k: v for k, v in lyr["attn"].items()
                                if not k.startswith("b")})
                for lyr in params["layers"]])
            faults = {name: rel_dist(M.prefill_lm(p_, cfg32, toks, Lc)[0],
                                     ref_outs[0])
                      for name, p_ in (("adapter_w_30pc", adapter_w),
                                       ("attention_bias_dropped", no_bias))}
        lim = STARCODER["fp32_tol"]
        log(f"[4sc] starcoder2-7b fp32, {Lq} of 32 layers, on {smi}: 2 x "
            f"{toks.shape[1]} tokens, {n} greedy steps; kernel path vs plain "
            f"path relative L2 prefill {dists[0]:.3g}, steps max "
            f"{max(dists[1:]):.3g} (limit {lim}); tokens equal "
            f"{torch.equal(ker_toks, ref_toks)}; planted faults {faults}; "
            f"launches a prefill {ker_calls[0]}, a step {ker_calls[1]}")
        check(max(dists) <= lim, f"[4sc] kernel path vs plain path {dists}")
        check(torch.equal(ker_toks, ref_toks), "[4sc] greedy tokens differ")
        check(all(v > lim for v in faults.values()),
              f"[4sc] a planted fault within the limit {lim}: {faults}")
        fam_reports["4sc"] = dict(rel_l2=dists, faults=faults, limit=lim,
                                  launches_prefill=ker_calls[0],
                                  launches_step=ker_calls[1])
        del params, adapter_w, no_bias
        release()
        phase_done("4sc")

    def plain_tokens(eng, reqs, slots, max_len):
        """The greedy tokens of `reqs` through the same scheduler and
        admissions, every engine step on the plain path (impl="ref"): no
        kernel launches."""
        def prefill(tokens, cache_len, task_ids=None, last_pos=None):
            with torch.no_grad():
                return M.prefill_lm(eng.params, eng.cfg, eng._tokens(tokens),
                                    cache_len, last_pos=last_pos, impl="ref")

        def decode_step(caches, tok, pos, task_ids=None):
            pos = eng._positions(pos, 1, eng._slot_len(caches))
            with torch.no_grad():
                return M.decode_lm(eng.params, eng.cfg, caches,
                                   eng._tokens(tok), pos, impl="ref")

        eng.prefill, eng.decode_step = prefill, decode_step
        _build.reset_launches()
        try:
            done, _ = staggered_run(make_scheduler(eng, ServingConfig(
                num_slots=slots, max_len=max_len, backbone_quant=eng.quant)),
                reqs)
        finally:
            del eng.prefill, eng.decode_step
        check(not any(_build.launch_counts().values()),
              f"the plain path launched {_build.launch_counts()}")
        return {c.request_id: c.tokens for c in done}

    def fam_serve_run(tag, eng, cfg_, reqs, want, slots, max_len):
        """reqs through make_scheduler on `eng`, reqs[0] alone and the rest
        after 2 ticks: the serve checks, each call's launches as `want`
        says, a decode tick's and a prefill's profile checked against the
        wrappers' counts, the peak bytes. Returns (report, tokens by
        request)."""
        scfg_ = ServingConfig(num_slots=slots, max_len=max_len,
                              backbone_quant=eng.quant)
        make_scheduler(eng, scfg_).run([dataclasses.replace(
            r, max_new_tokens=2) for r in reqs[:2]])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sched = make_scheduler(eng, scfg_)
        per_call = count_per_call(eng)
        _build.reset_launches()
        done, rep = staggered_run(sched, reqs)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        del eng.prefill, eng.decode_step
        per_tick, per_prefill = serve_checks(
            tag, per_call, rep, done, counts, reqs, want, cfg_.vocab_size)
        check(all(bool(torch.isfinite(leaf.float()).all())
                  for c in sched.caches for leaf in c.values()),
              f"[{tag}] non-finite cache")
        del sched
        caches = eng.init_slot_caches(slots, max_len)
        pos = [len(reqs[0].prompt) + 8 + i for i in range(slots)]
        prompt = reqs[0].prompt[None]
        tick, pre = fam_tick_report(
            tag, lambda: eng.prefill(prompt, max_len),
            lambda: eng.decode_step(caches, [[11]] * slots, pos),
            per_tick, per_prefill)
        del caches
        fam_launches[tag] = counts
        report = dict(rep, launches_per_decode_tick=per_tick,
                      launches_per_prefill=per_prefill, tick=tick,
                      prefill=pre, peak_bytes_allocated=peak,
                      **exact_latency(done))
        log(f"[{tag}] {cfg_.name} on {smi}: {serve_line(rep, done)}; "
            f"launches {counts}; per decode tick {per_tick}; per prefill "
            f"{per_prefill}; peak {peak / 1e9:.2f} GB; decode tick {tick}; "
            f"prefill {pre}")
        return report, {c.request_id: c.tokens for c in done}

    def built(tag, make):
        """(engine or tree that `make()` builds, its bytes on the card, the
        build's peak bytes, seconds), the device memory held before it
        logged."""
        torch.cuda.synchronize()
        release()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = make()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        weights = torch.cuda.memory_allocated() - held
        peak = torch.cuda.max_memory_allocated()
        log(f"[{tag}] the build: {held / 1e9:.2f} GB held before it, "
            f"{weights / 1e9:.2f} GB after, peaking at {peak / 1e9:.2f} GB "
            f"in {build_s:.1f} s")
        return out, weights, peak, build_s

    def adapter_fault(params):
        """A tree whose every adapter w lies 30 % further from 1."""
        return dict(params, layers=[dict(lyr, adapter={
            "w": 1 + 1.3 * (lyr["adapter"]["w"] - 1),
            "b": lyr["adapter"]["b"]}) for lyr in params["layers"]])

    def prefill_vs_plain(tag, eng, cfg_, prompt, max_len, faults, limit,
                         metric):
        """The bf16 prefill's last logits through the kernels against the
        plain path on the same weights, within `limit` by `metric`
        ("rel_l2" or "max_abs") and with the same top-1; every planted
        fault ({name: (params, cfg)} on the plain path) past the limit."""
        dist = rel_dist if metric == "rel_l2" else (
            lambda a_, b_: (a_.float() - b_.float()).abs().max().item())
        prompt_t = torch.as_tensor(prompt[None], device=dev)
        with torch.no_grad():
            got, _ = eng.prefill(prompt[None], max_len)
            want_l, _ = M.prefill_lm(eng.params, cfg_, prompt_t, max_len,
                                     impl="ref")
            fault_d = {name: dist(M.prefill_lm(p_, c_, prompt_t, max_len,
                                               impl="ref")[0], want_l)
                       for name, (p_, c_) in faults.items()}
        d_ = dist(got, want_l)
        top = bool(got[0, -1].argmax() == want_l[0, -1].argmax())
        out = dict(metric=metric, kernel_vs_plain=d_, limit=limit,
                   faults=fault_d, same_top1=top)
        log(f"[{tag}] the prefill's last logits ({len(prompt)} tokens), "
            f"kernel path vs plain path: {metric} {d_:.4g} (limit {limit}), "
            f"same top-1 {top}; planted faults {fault_d}")
        check(bool(torch.isfinite(got).all()), f"[{tag}] non-finite logits")
        check(d_ <= limit and top, f"[{tag}] the prefill's last logits: "
              f"{metric} {d_:.4g} (limit {limit}), same top-1 {top}")
        check(all(v > limit for v in fault_d.values()),
              f"[{tag}] a planted fault within the limit {limit}: {fault_d}")
        return out

    def sc_serve():
        """Phase 5sc: starcoder2-7b bf16 at full width and depth, one
        perturbed adapter, SERVE's traffic admitted mid-decode into 4 slots
        of 512: 32 #5 + 32 #3 a tick, 32 #4 + 32 #3 a prefill; the plain
        path's tokens on the same admissions (agreement reported), the
        prefill's last logits against the plain path beside a planted
        fault (the plain path normalising by RMSNorm), tok/s, a tick's and
        a prefill's profile, the weights' read floor, the peak; then the
        serve launcher at starcoder2-3b, full depth, briefly."""
        import contextlib
        import io

        eng, weights, build_peak, build_s = built("5sc", lambda: (
            launcher.build_engine(scfg, seed=STARCODER["seed"], device=dev)))
        n_params = tu.count_params(eng.params)
        check(n_params == STARCODER["n_params"], f"[5sc] {n_params:,} "
              f"parameters, JAX counts {STARCODER['n_params']:,}")
        Ls = scfg.n_layers
        slots, Lc = SERVE["num_slots"], SERVE["max_len"]
        reqs = launcher.make_requests(scfg, SERVE["requests"],
                                      SERVE["prompt_len"],
                                      SERVE["new_tokens"], 0,
                                      STARCODER["seed"])
        rep, toks = fam_serve_run(
            "5sc", eng, scfg, reqs,
            {"tick": {"paged_attention": Ls, "fused_adapter_norm": Ls},
             "prefill": {"flash_attention": Ls, "fused_adapter_norm": Ls}},
            slots, Lc)
        plain = plain_tokens(eng, reqs, slots, Lc)
        agree = float(np.mean([(toks[i] == plain[i]).mean() for i in toks]))
        logits = prefill_vs_plain(
            "5sc", eng, scfg, reqs[0].prompt, Lc,
            {"rmsnorm_for_layernorm": (eng.params, scfg.replace(
                norm="rmsnorm")),
             "adapter_w_30pc": (adapter_fault(eng.params), scfg)},
            STARCODER["prefill_tol"], "rel_l2")
        floor = weights / HBM_BYTES_PER_S * 1e3
        rep.update(token_agreement_vs_plain=agree, prefill_vs_plain=logits,
                   n_params=n_params, weights_bytes_allocated=weights,
                   build_peak_bytes=build_peak, build_s=build_s,
                   tick_read_floor_ms=floor)
        fam_reports["5sc"] = rep
        log(f"[5sc] starcoder2-7b bf16: {n_params:,} parameters, "
            f"{weights / 1e9:.2f} GB (a tick's read floor {floor:.2f} ms); "
            f"greedy tokens vs the plain path's {agree:.4f}; tick "
            f"{rep['tick']['device_ms']:.3f} device ms, "
            f"{rep['tick']['ms']:.2f} host ms, busy "
            f"{rep['tick']['device_busy_share']:.3f}, "
            f"{rep['tick']['device_kernels']:.0f} kernels")
        del eng
        release()
        phase_done("5sc")
        # the serve launcher itself, at starcoder2-3b's full depth
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            launcher.main(["--arch", STARCODER["small"], "--requests", "2",
                           "--num-slots", "2", "--prompt-len", "128",
                           "--new-tokens", "8",
                           "--seed", str(STARCODER["seed"])])
        text = out.getvalue()
        check("served 2 requests / 16 tokens" in text,
              f"[5sc] the launcher printed {text[-800:]!r}")
        fam_reports["5sc"]["launcher_3b_s"] = time.perf_counter() - t0
        log(f"[5sc] launcher --arch {STARCODER['small']} in "
            f"{fam_reports['5sc']['launcher_3b_s']:.1f} s: "
            + " | ".join(ln for ln in text.splitlines()
                         if ln.startswith("served")))
        release()
        phase_done("5sc launcher")

    def quant_checks(tag, eng, cfg_, want_leaves):
        """quant_summary's leaves by convert.jax_path: JAX's count."""
        qs = quant_summary(eng.params, lambda p: convert.jax_path(p, cfg_))
        check(qs["n_quantized_leaves"] == want_leaves,
              f"[{tag}] {qs['n_quantized_leaves']} quantized leaves, JAX "
              f"quantizes {want_leaves}")
        return qs

    def sc_quant():
        """Phase 5scq: starcoder2-7b over an int8 trunk (JAX's 7 leaves:
        the 6 projections of every layer and the untied head, 193 #7 a
        call; the biases stay bf16) on 5sc's traffic."""
        eng, weights, build_peak, _ = built("5scq", lambda: (
            launcher.build_engine(scfg, seed=STARCODER["seed"], device=dev,
                                  quant="int8")))
        qs = quant_checks("5scq", eng, scfg, STARCODER["quant_leaves"])
        Ls = scfg.n_layers
        n_dq = 6 * Ls + 1
        reqs = launcher.make_requests(scfg, SERVE["requests"],
                                      SERVE["prompt_len"],
                                      SERVE["new_tokens"], 0,
                                      STARCODER["seed"])
        rep, _ = fam_serve_run(
            "5scq", eng, scfg, reqs,
            {"tick": {"paged_attention": Ls, "fused_adapter_norm": Ls,
                      "dequant_matmul": n_dq},
             "prefill": {"flash_attention": Ls, "fused_adapter_norm": Ls,
                         "dequant_matmul": n_dq}},
            SERVE["num_slots"], SERVE["max_len"])
        rep.update(quant_line=launcher.quant_line(eng),
                   quantized_bytes=qs["quantized_bytes"],
                   tree_bytes=qs["total_bytes"],
                   weights_bytes_allocated=weights,
                   build_peak_bytes=build_peak,
                   tick_read_floor_ms=weights / HBM_BYTES_PER_S * 1e3)
        fam_reports["5scq"] = rep
        log(f"[5scq] {rep['quant_line']}; tick "
            f"{rep['tick']['device_ms']:.3f} device ms against a "
            f"{rep['tick_read_floor_ms']:.2f} ms read floor")
        del eng
        release()
        phase_done("5scq")

    def gemma2_quant():
        """Phase 5gq: gemma2-27b over an int8 trunk at full depth, built by
        build_engine leaf by leaf (its build peak under
        QUANT_TRUNKS["build_peak_max"]; JAX's 14 leaves: 7 in each of the two
        layer slots, the head tied), on 6g's short traffic (8 x (128 + 32)
        on 4 slots of 160): 46 #5 + 46 #1 + 322 #7 a tick, 46 #4 + 46 #1 +
        322 #7 a prefill; the prefill's last logits against the plain path
        (max |diff|, the same top-1) beside a planted fault (every
        adapter's w 30 % further from 1)."""
        eng, weights, build_peak, build_s = built("5gq", lambda: (
            launcher.build_engine(gcfg, seed=GEMMA["seed"], device=dev,
                                  quant="int8")))
        check(build_peak < QUANT_TRUNKS["build_peak_max"], f"[5gq] the build "
              f"peaked at {build_peak / 1e9:.2f} GB")
        qs = quant_checks("5gq", eng, gcfg, QUANT_TRUNKS["gemma_leaves"])
        n_dq = 7 * g_layers
        slots, Lc = GEMMA["bank_slots"], GEMMA["bank_max_len"]
        reqs = launcher.make_requests(gcfg, GEMMA["bank_requests"],
                                      GEMMA["bank_prompt"], g_new, 0,
                                      GEMMA["seed"])
        rep, _ = fam_serve_run(
            "5gq", eng, gcfg, reqs,
            {"tick": {"paged_attention": g_layers,
                      "hadamard_affine": g_layers, "dequant_matmul": n_dq},
             "prefill": {"flash_attention": g_layers,
                         "hadamard_affine": g_layers,
                         "dequant_matmul": n_dq}}, slots, Lc)
        logits = prefill_vs_plain(
            "5gq", eng, gcfg, reqs[0].prompt, Lc,
            {"adapter_w_30pc": (adapter_fault(eng.params), gcfg)},
            QUANT_TRUNKS["gemma_prefill_tol"], "max_abs")
        rep.update(quant_line=launcher.quant_line(eng),
                   quantized_bytes=qs["quantized_bytes"],
                   tree_bytes=qs["total_bytes"], prefill_vs_plain=logits,
                   weights_bytes_allocated=weights,
                   build_peak_bytes=build_peak, build_s=build_s,
                   tick_read_floor_ms=weights / HBM_BYTES_PER_S * 1e3)
        fam_reports["5gq"] = rep
        log(f"[5gq] {rep['quant_line']}; the build peaked at "
            f"{build_peak / 1e9:.2f} GB (limit "
            f"{QUANT_TRUNKS['build_peak_max'] / 1e9:.0f} GB), "
            f"{weights / 1e9:.2f} GB held; tick "
            f"{rep['tick']['device_ms']:.3f} device ms against a "
            f"{rep['tick_read_floor_ms']:.2f} ms read floor")
        del eng
        release()
        phase_done("5gq")

    def iv_quant():
        """Phase 5ivq: internvl2-76b at 8 of 80 layers over an int8 trunk
        (JAX's 9 leaves: 7 a layer's kind, the untied head, vlm_proj),
        quantized in place leaf by leaf as it is made, on 5iv's traffic: 8
        #5 + 8 #3 + 57 #7 a tick, 8 #4 + 8 #3 + 58 #7 a prefill
        (vlm_proj's); the plain path's tokens beside the kernel path's;
        the prefill's last logits against the plain path (relative L2)
        beside a planted fault (every adapter's w 30 % further from 1);
        reported as 5iv."""
        def make():
            p_ = iv_params(icfg, INTERNVL["seed"])
            quantize_owned(p_, "int8")
            return p_

        params, weights, build_peak, _ = built("5ivq", make)
        qs = quant_summary(params, lambda p: convert.jax_path(p, icfg))
        check(qs["n_quantized_leaves"] == QUANT_TRUNKS["internvl_leaves"]
              and isinstance(params["vlm_proj"]["kernel"], QTensor),
              f"[5ivq] {qs['n_quantized_leaves']} quantized leaves, JAX "
              f"quantizes {QUANT_TRUNKS['internvl_leaves']} with vlm_proj")
        patches, toks = iv_inputs(icfg, bf)
        R, T, L = toks.shape[0], patches.shape[1] + toks.shape[1], \
            INTERNVL["cache_len"]
        steps_ = INTERNVL["new_tokens"] - 1
        Li = len(icfg.layer_slots())
        n_dq = 7 * Li + 1
        with torch.no_grad():
            vlm_run(params, icfg, patches, toks, 2, "auto")  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            outs, ker_toks, calls = vlm_run(params, icfg, patches, toks,
                                            steps_, "auto")
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            want_launches("5ivq", "the prefill", calls[0],
                          {"flash_attention": Li, "fused_adapter_norm": Li,
                           "dequant_matmul": n_dq + 1})
            for c in calls[1:]:
                want_launches("5ivq", "a decode tick", c,
                              {"paged_attention": Li,
                               "fused_adapter_norm": Li,
                               "dequant_matmul": n_dq})
            check(all(bool(torch.isfinite(o).all()) for o in outs),
                  "[5ivq] non-finite logits")
            _, ref_toks, _ = vlm_run(params, icfg, patches, toks, steps_,
                                     "ref")
            agree = (ker_toks == ref_toks).float().mean().item()
            want_l, _ = M.prefill_lm(params, icfg, toks, L, patches=patches,
                                     impl="ref")
            fault = rel_dist(M.prefill_lm(adapter_fault(params), icfg, toks,
                                          L, patches=patches,
                                          impl="ref")[0], want_l)
            lg, caches = M.prefill_lm(params, icfg, toks, L, patches=patches)
            # random weights leave internvl2's logits flat (5iv's bf16
            # tokens agree 0.70 with the plain path's): the top-1 and the
            # margin between the plain path's two best are reported
            top2 = want_l[:, -1].float().topk(2, dim=-1).values
            logits = dict(kernel_vs_plain=rel_dist(lg, want_l),
                          limit=QUANT_TRUNKS["internvl_prefill_tol"],
                          fault_adapter_w_30pc=fault, same_top1=bool(
                              (lg[:, -1].argmax(-1)
                               == want_l[:, -1].argmax(-1)).all()),
                          plain_top2_margin=(top2[:, 0] - top2[:, 1]).tolist(),
                          plain_logit_std=want_l[:, -1].float().std(
                              -1).tolist())
            log(f"[5ivq] the prefill's last logits, kernel path vs plain "
                f"path: relative L2 {logits['kernel_vs_plain']:.4g} (limit "
                f"{logits['limit']}); the planted adapter fault "
                f"{fault:.4g}; same top-1 {logits['same_top1']} (the plain "
                f"path's top-2 margins {logits['plain_top2_margin']}, its "
                f"logits' std {logits['plain_logit_std']})")
            check(logits["kernel_vs_plain"] <= logits["limit"] < fault,
                  f"[5ivq] the prefill's last logits {logits}")
            del want_l
            tok = lg.argmax(-1)
            pos = torch.full((R,), T + 5, dtype=torch.int32, device=dev)
            counts = {k: sum(c[k] for c in calls) for k in calls[0]}
            per_tick = {k: sorted({c[k] for c in calls[1:]}) for k in counts}
            per_prefill = {k: [calls[0][k]] for k in counts}
            tick, pre = fam_tick_report(
                "5ivq", lambda: M.prefill_lm(params, icfg, toks, L,
                                             patches=patches),
                lambda: M.decode_lm(params, icfg, caches, tok, pos),
                per_tick, per_prefill)
        floor = weights / HBM_BYTES_PER_S * 1e3
        fam_launches["5ivq"] = counts
        fam_reports["5ivq"] = dict(
            requests=R, ticks=steps_, run_s=run_s,
            tok_per_s=R * INTERNVL["new_tokens"] / run_s,
            token_agreement_vs_plain=agree, quant_summary=qs,
            prefill_vs_plain=logits,
            weights_bytes_allocated=weights, build_peak_bytes=build_peak,
            tick_read_floor_ms=floor, peak_bytes_allocated=peak,
            launches_per_decode_tick=per_tick,
            launches_per_prefill=per_prefill, tick=tick, prefill=pre)
        log(f"[5ivq] internvl2-76b int8, {Li} of 80 layers, on {smi}: "
            f"{qs['n_quantized_leaves']} quantized leaves, "
            f"{weights / 1e9:.2f} GB (a tick's read floor {floor:.2f} ms), "
            f"the build peaking at {build_peak / 1e9:.2f} GB; {R} x "
            f"({patches.shape[1]} patches + {toks.shape[1]} tokens), "
            f"{INTERNVL['new_tokens']} greedy tokens in {run_s:.3f} s; "
            f"tokens vs the plain path's {agree:.4f}; launches {counts}; per "
            f"tick {per_tick}; per prefill {per_prefill}; peak "
            f"{peak / 1e9:.2f} GB; tick {tick}; prefill {pre}")
        del params, caches, lg, outs
        release()
        phase_done("5ivq")

    # -- phases 3sc, 4sc, 5sc, 5scq, 5gq, 5ivq ------------------------------
    sc_kernels()
    sc_fp32_model()
    sc_serve()
    sc_quant()
    gemma2_quant()
    iv_quant()
    launches.update({p: fam_launches[p]
                     for p in ("5sc", "5scq", "5gq", "5ivq")})
    serve_reports.update({p: fam_reports[p]
                          for p in ("5sc", "5scq", "5gq", "5ivq")})

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
    head = {f"{m}/{leaf}" for m in ("pooler", "classifier")
            for leaf in ("kernel", "bias")}

    def layer_leaves(*leaves):
        return {f"layers/{i}/{leaf}" for i in range(L) for leaf in leaves}

    # each strategy's adapter leaves (all moved off the identity, which
    # would hide a dropped hook) and the leaves its patterns train
    adapter_leaves = {
        "hadamard": ("w", "b"), "hadamard_concat": ("w", "b"),
        "lora": ("qa", "qb", "va", "vb"), "ia3": ("lk", "lv", "lff"),
        "houlsby": tuple(f"{ad}/{w}" for ad in ("attn_ad", "ffn_ad")
                         for w in ("down", "down_b", "up", "up_b"))}
    norm = ("scale", "bias")
    trained_leaves = {
        "hadamard": layer_leaves("adapter/w", "adapter/b",
                                 *(f"ffn_norm/{n}" for n in norm)),
        "lora": layer_leaves(*(f"adapter/{a}" for a in adapter_leaves["lora"]))
        | head,
        "ia3": layer_leaves(*(f"adapter/{a}" for a in adapter_leaves["ia3"]))
        | head,
        "houlsby": layer_leaves(
            *(f"adapter/{a}" for a in adapter_leaves["houlsby"]),
            *(f"{m}/{n}" for m in ("attn_norm", "ffn_norm") for n in norm))
        | head}
    trained_leaves["hadamard_concat"] = trained_leaves["hadamard"]

    def grad_scale_leaf(path):
        """The leaf whose max |plain gradient| scales the tolerance of
        `path`'s: its own, but for the q and k side of attention. Those
        reach the loss only through the softmax backward, whose terms
        cancel where a layer attends almost evenly over almost equal
        values, as a random bert-base's deep layers do (LoRA's
        layers/10/adapter/qa read a max |gradient| of 3.5e-9, its kernel
        path 4.3e-9 from it): what is left is rounding of terms of the
        size of the v side's gradient, which sets their scale. A key bias
        shifts all of a query's scores by one amount, which the softmax
        cancels: its gradient is 0 in exact arithmetic."""
        for qk, v in (("/adapter/qa", "/adapter/va"),
                      ("/adapter/qb", "/adapter/vb"),
                      ("/adapter/lk", "/adapter/lv"),
                      ("/attn/wq", "/attn/wv"), ("/attn/wk", "/attn/wv"),
                      ("/attn/bq", "/attn/bv"), ("/attn/bk", "/attn/bv")):
            if path.endswith(qk):
                return path[:-len(qk)] + v
        return path
    for sname in ("hadamard", "hadamard_concat", "lora", "ia3", "houlsby"):
        strat = peft.strategy(sname)
        cfg_s = peft.attach(bert, strat)
        params = perturb_adapters(
            M.init_params(torch.Generator(device=dev).manual_seed(1), cfg_s),
            seed=2, scale=0.2, leaves=adapter_leaves[sname])
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
        want = trained_leaves[sname]
        check(set(gk) == want == set(gr),
              f"phase 7 {sname}: trainable leaves {sorted(set(gk) ^ want)}")
        worst = 0.0
        for path in sorted(want):
            e = (gk[path] - gr[path]).abs().max().item()
            m = gr[grad_scale_leaf(path)].abs().max().item()
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
    phase_done("7")

    # -- phase 7m: one full MLM step of bert-base, kernel path vs plain --
    from repro_torch.common import tree as tu
    from repro_torch.data.synthetic import lm_corpus
    from repro_torch.train import pretrain as pretrain_mod

    full = peft.strategy("full")
    bert_full = peft.attach(bert, full)
    mlm_corpus = lm_corpus(bert.vocab_size, 300_000, seed=PAPER["seed"])
    mlm_batch = loop.to_device(next(pretrain_mod.mlm_batches(
        mlm_corpus, 1, B_tr, S_tr, seed=PAPER["seed"] + 7)), dev)
    params = M.init_params(torch.Generator(device=dev).manual_seed(1),
                           bert_full)
    runs = {}
    for impl in ("auto", "ref"):
        state = make_state(None, bert_full, full, OptimCfg(), params=params)
        loss, _, grads = loss_and_grads(bert_full, state, mlm_batch, impl,
                                        loss_fn=pretrain_mod.mlm_loss)
        runs[impl] = (loss.item(), grads)
        del state
    (loss_k, gk), (loss_r, gr) = runs["auto"], runs["ref"]
    loss_rel = abs(loss_k - loss_r) / abs(loss_r)
    check(math.isfinite(loss_k) and loss_rel <= 1e-5,
          f"phase 7m: mlm loss {loss_k} vs plain {loss_r}")
    every = {p for p, _ in tu.flatten_with_paths(params)}
    check(set(gk) == every == set(gr), f"phase 7m: gradient leaves "
          f"{sorted(set(gk) ^ every)[:4]}")
    # the pooler, the classifier and final_norm: the MLM loss reads none
    unread = {p for p in every
              if p.startswith(("pooler/", "classifier/", "final_norm/"))}
    check(len(unread) == 6 and all(not gk[p].any() and not gr[p].any()
                                   for p in unread),
          f"phase 7m: unread leaves {sorted(unread)} not exactly zero")
    worst, worst_leaf = 0.0, None
    for path in sorted(every - unread):
        e = (gk[path] - gr[path]).abs().max().item()
        m = gr[grad_scale_leaf(path)].abs().max().item()
        check(bool(torch.isfinite(gk[path]).all()) and e <= 1e-3 * m,
              f"phase 7m: gradient {path} max abs err {e:.3g} > 1e-3 x "
              f"{m:.3g}")
        if e / m > worst:
            worst, worst_leaf = e / m, path
    mlm_check = {"loss": loss_k, "loss_plain": loss_r, "loss_rel": loss_rel,
                 "leaves": len(every), "unread_zero": sorted(unread),
                 "grad_worst_rel": worst, "grad_worst_leaf": worst_leaf}
    log(f"[7m] {TRAIN['arch']} fp32, {L} layers, full, one {B_tr}x{S_tr} "
        f"mlm_batches batch: kernel path vs plain path mlm_loss "
        f"{loss_k:.6f} vs {loss_r:.6f} (rel {loss_rel:.3g}, tol 1e-5); "
        f"{len(every)} gradient leaves, embeddings included, worst "
        f"max|diff| / max|ref| {worst:.3g} at {worst_leaf} (tol 1e-3); "
        f"{len(unread)} unread leaves exactly 0")
    del runs, gk, gr, params
    torch.cuda.empty_cache()
    phase_done("7m")

    # -- phase 7d: full-width qwen3-0.6b in fp32, the train path's kernels
    # against the plain path ------------------------------------------------
    def per_call(counts):
        """A launch dict with every kernel, zero where not given."""
        return {k: counts.get(k, 0) for k in _build.LAUNCHES}

    from repro_torch.convert import jax_path
    from repro_torch.data.synthetic import lm_batches

    lm_strat = peft.strategy("hadamard")
    qwen32 = peft.attach(get_arch(ARCH), lm_strat).replace(
        param_dtype="float32", compute_dtype="float32")
    Lq = qwen32.n_layers
    corpus = lm_corpus(qwen32.vocab_size, 200_000, seed=LM_TRAIN["seed"])
    B7 = 4
    batch7 = loop.to_device(next(lm_batches(corpus, 1, B7, LM_TRAIN["seq"],
                                            seed=LM_TRAIN["seed"] + 7)), dev)
    params = perturb_adapters(
        M.init_params(torch.Generator(device=dev).manual_seed(1), qwen32),
        seed=2, scale=0.2)
    fa, fl, ab, dq = ("fused_adapter_norm", "flash_attention",
                      "hadamard_affine_bwd", "dequant_matmul")
    want_lm = {None: per_call({fa: Lq, fl: Lq, ab: Lq}),
               "int8": per_call({fa: Lq, fl: Lq, ab: Lq, dq: 7 * Lq})}
    lm_leaves = {f"layers/{i}/{leaf}" for i in range(Lq)
                 for leaf in ("adapter/w", "adapter/b", "ffn_norm/scale")}
    lm_model, unchunked = {}, None
    for variant, cfg_v, quant in (("fp32", qwen32, None),
                                  ("int8", qwen32, "int8"),
                                  ("fp32 ce_chunk=32",
                                   qwen32.replace(ce_chunk=32), None)):
        runs = {}
        for impl in (("auto",) if cfg_v.ce_chunk else ("auto", "ref")):
            state = make_state(None, cfg_v, lm_strat, OptimCfg(),
                               params=params, quant=quant)
            torch.cuda.synchronize()
            before = _build.launch_counts()
            loss, _, grads = loss_and_grads(cfg_v, state, batch7, impl)
            after = _build.launch_counts()
            with torch.no_grad():
                logits = M.forward_lm(state["params"], cfg_v,
                                      batch7["tokens"], impl=impl)
            runs[impl] = (logits, loss.item(), grads,
                          {k: after[k] - before[k] for k in after})
            del state
        lg, loss_k, gk, launched = runs["auto"]
        check(launched == want_lm[quant], f"phase 7d {variant}: the loss and "
              f"its gradients launched {launched}, predicted {want_lm[quant]}")
        check(lg.shape == (B7, LM_TRAIN["seq"], qwen32.vocab_size) and
              bool(torch.isfinite(lg).all()), f"phase 7d {variant}: logits "
              f"{tuple(lg.shape)}, finite {bool(torch.isfinite(lg).all())}")
        check(set(gk) == lm_leaves, f"phase 7d {variant}: trainable leaves "
              f"{sorted(set(gk) ^ lm_leaves)[:6]}")
        rep = {"launches": {k: v for k, v in launched.items() if v}}
        if cfg_v.ce_chunk:
            # the chunked CE against the unchunked one, both through the
            # kernels: the same loss and gradients up to summation order
            loss_u, g_u = unchunked
            rep["loss_rel_vs_unchunked"] = abs(loss_k - loss_u) / abs(loss_u)
            check(rep["loss_rel_vs_unchunked"] <= 1e-5, f"phase 7d {variant}: "
                  f"loss {loss_k} vs unchunked {loss_u}")
            # the gradient as one vector over the trainable leaves,
            # |g_chunked - g| / |g| <= 1e-5, and leaf by leaf, max|diff|
            # over the leaf's max|g| <= 1e-4. The head's GEMMs run at
            # another M a chunk, so cuBLAS sums the 151,936-long
            # contraction of the backward in another split: each element
            # moves by fp32 rounding, which a leaf of small gradients
            # shows most (1.36e-5 at the worst on an H100). The leaf
            # limit sits below what a fault reads that the loss and the
            # vector norm barely see: the last chunk's logits rounded to
            # bf16 read 5.4e-4 on the worst leaf (qwen3 smoke, CPU)
            sq_d = sum((gk[p] - g_u[p]).double().square().sum().item()
                       for p in lm_leaves)
            sq_g = sum(g_u[p].double().square().sum().item()
                       for p in lm_leaves)
            rep["grad_rel_vs_unchunked"] = math.sqrt(sq_d / sq_g)
            leaf_rel = {p: (gk[p] - g_u[p]).abs().max().item()
                        / g_u[p].abs().max().item() for p in lm_leaves}
            worst_leaf = max(leaf_rel, key=leaf_rel.get)
            rep["grad_worst_leaf_max_rel_vs_unchunked"] = leaf_rel[worst_leaf]
            rep["grad_worst_leaf"] = worst_leaf
            check(rep["grad_rel_vs_unchunked"] <= 1e-5, f"phase 7d {variant}: "
                  f"|g - g_unchunked| / |g_unchunked| "
                  f"{rep['grad_rel_vs_unchunked']:.3g} > 1e-5")
            check(leaf_rel[worst_leaf] <= 1e-4, f"phase 7d {variant}: "
                  f"gradient {worst_leaf} max|diff| / its max|g_unchunked| "
                  f"{leaf_rel[worst_leaf]:.3g} > 1e-4")
            log(f"[7d] {ARCH} fp32, {Lq} layers, ce_chunk=32 through the "
                f"kernels vs unchunked: loss rel "
                f"{rep['loss_rel_vs_unchunked']:.3g} (tol 1e-5), gradient of "
                f"{len(lm_leaves)} leaves |diff| / |ref| "
                f"{rep['grad_rel_vs_unchunked']:.3g} (tol 1e-5); worst leaf "
                f"{worst_leaf} max|diff| / its max|ref| "
                f"{leaf_rel[worst_leaf]:.3g} (tol 1e-4)")
        else:
            lr_, loss_r, gr, _ = runs["ref"]
            diff, top = (lg - lr_).abs().max().item(), lr_.abs().max().item()
            check(diff <= 1e-3 * top, f"phase 7d {variant}: |kernel - plain| "
                  f"logits {diff:.3g} > 1e-3 x {top:.3g}")
            loss_rel = abs(loss_k - loss_r) / abs(loss_r)
            check(math.isfinite(loss_k) and loss_rel <= 1e-5,
                  f"phase 7d {variant}: loss {loss_k} vs plain {loss_r}")
            worst = 0.0
            for path in sorted(lm_leaves):
                e = (gk[path] - gr[path]).abs().max().item()
                m = gr[path].abs().max().item()
                check(bool(torch.isfinite(gk[path]).all()) and e <= 1e-3 * m,
                      f"phase 7d {variant}: gradient {path} max abs err "
                      f"{e:.3g} > 1e-3 x {m:.3g}")
                worst = max(worst, e / m)
            rep.update(logits_rel=diff / top, loss=loss_k, loss_plain=loss_r,
                       loss_rel=loss_rel, grad_worst_rel=worst)
            if quant is None:
                unchunked = (loss_k, gk)
            log(f"[7d] {ARCH} {variant}, {Lq} layers, hadamard, one "
                f"{B7}x{LM_TRAIN['seq']} lm_batches batch: kernel path vs "
                f"plain path logits max |diff| / max|ref| {diff / top:.3g} "
                f"(tol 1e-3), lm_loss {loss_k:.6f} vs {loss_r:.6f} (rel "
                f"{loss_rel:.3g}, tol 1e-5), {len(lm_leaves)} gradient "
                f"leaves, worst max|diff| / max|ref| {worst:.3g} (tol 1e-3); "
                f"launches of the loss and its gradients {rep['launches']}")
        lm_model[variant] = rep
        del runs, lg, gk
    del params, unchunked, batch7
    torch.cuda.empty_cache()
    phase_done("7d")

    # -- phase 7r: full-width rwkv6-1.6b in fp32, the train path's kernels
    # against the plain path -------------------------------------------------
    # one 4 x 128 lm_batches batch, every adapter leaf perturbed: the
    # logits, lm_loss and every trainable gradient through the kernels
    # (#8 forward in every layer; under autograd `WKV6`, whose backward is
    # plain torch chunk by chunk; the Hadamard seam #3 forward and #2 under
    # it) against impl="ref", which differentiates the step-by-step
    # recurrence `ref.wkv6_ref` itself, for the Hadamard adapter and for
    # Houlsby's bottlenecks (no #3 or #2: their seam is plain), with JAX's
    # trainable counts. The first R7_SKIP positions' labels are ignored:
    # there the random-weight stack is ill-conditioned (each head's
    # time-mix output is a sum of few r . (u k) v terms that the per-head
    # group norm rescales), and their loss terms moved the lower layers'
    # gradients by up to 45 % under a 1e-6 move of the embedding table on
    # the plain path alone. The logits and each gradient leaf are held as
    # vectors, |kernel - plain| / |plain|, to R7_LIMIT. A control shows that
    # the limit sees a fault: the kernel path again with every gradient
    # the recurrence's backward hands back R7_FAULT off (scaled by 1 +
    # R7_FAULT) must take some leaf past it. On an H100 the Hadamard
    # adapter's worst leaf read 2.0e-3 and one of Houlsby's layer-0 leaves
    # 1.2e-2, the control 0.48: the limit sits between them
    R7_SKIP, R7_LIMIT, R7_FAULT = 32, 5e-2, 0.1
    from repro_torch.kernels import rwkv6 as rwkv6_mod

    def vec_rel(a, b):
        return ((a - b).double().norm() / b.double().norm()).item()

    sound_backward = rwkv6_mod.wkv6_backward

    def faulty_backward(*a, **kw):
        return tuple(g * (1 + R7_FAULT) for g in sound_backward(*a, **kw))

    Lr7 = get_arch(RWKV_ARCH).n_layers
    wk = "wkv6"
    want_7r = {"hadamard": per_call({wk: Lr7, fa: Lr7, ab: Lr7}),
               "houlsby": per_call({wk: Lr7})}
    rwkv_train_model, pending = {}, []
    batch7r = loop.to_device(next(lm_batches(
        lm_corpus(get_arch(RWKV_ARCH).vocab_size, 200_000,
                  seed=LM_TRAIN["seed"]), 1, B7, LM_TRAIN["seq"],
        seed=LM_TRAIN["seed"] + 7)), dev)
    batch7r["labels"][:, :R7_SKIP] = -100
    for sname in ("hadamard", "houlsby"):
        strat7 = peft.strategy(sname)
        cfg7 = peft.attach(get_arch(RWKV_ARCH), strat7).replace(
            param_dtype="float32", compute_dtype="float32")
        params = perturb_adapters(
            M.init_params(torch.Generator(device=dev).manual_seed(1), cfg7),
            seed=2, scale=0.2, leaves=adapter_leaves[sname])
        runs = {}
        for run in ("auto", "ref", "control"):
            impl = "ref" if run == "ref" else "auto"
            state = make_state(None, cfg7, strat7, OptimCfg(), params=params)
            torch.cuda.synchronize()
            before = _build.launch_counts()
            if run == "control":
                rwkv6_mod.wkv6_backward = faulty_backward
            try:
                loss, _, grads = loss_and_grads(cfg7, state, batch7r, impl)
            finally:
                rwkv6_mod.wkv6_backward = sound_backward
            after = _build.launch_counts()
            logits = None
            if run != "control":
                with torch.no_grad():
                    logits = M.forward_lm(state["params"], cfg7,
                                          batch7r["tokens"], impl=impl)
            runs[run] = (logits, loss.item(), grads,
                         {k: after[k] - before[k] for k in after})
            pstats = peft.param_stats(state["params"], peft.trainable_mask(
                state["params"], strat7, 2, cfg=cfg7))
            del state
        check((pstats["trainable"], pstats["total"]) == RWKV_TRAINABLE[sname],
              f"phase 7r {sname}: trainable {pstats['trainable']} of "
              f"{pstats['total']}, want {RWKV_TRAINABLE[sname]}")
        lg, loss_k, gk, launched = runs["auto"]
        lr_, loss_r, gr, _ = runs["ref"]
        gc = runs["control"][2]
        check(launched == want_7r[sname], f"phase 7r {sname}: the loss and "
              f"its gradients launched {launched}, predicted {want_7r[sname]}")
        check(set(gk) == set(gr) and sum(t.numel() for t in gk.values())
              == pstats["trainable"], f"phase 7r {sname}: gradient leaves")
        # the readings of both strategies are logged before any is checked
        diff, top = (lg - lr_).abs().max().item(), lr_.abs().max().item()
        lg_rel = vec_rel(lg, lr_)
        pending.append((bool(torch.isfinite(lg).all()) and lg_rel <= R7_LIMIT,
                        f"phase 7r {sname}: |kernel - plain| / |plain| logits "
                        f"{lg_rel:.3g} > {R7_LIMIT} (max |diff| {diff:.3g} of "
                        f"{top:.3g})"))
        loss_rel = abs(loss_k - loss_r) / abs(loss_r)
        pending.append((math.isfinite(loss_k) and loss_rel <= 1e-5,
                        f"phase 7r {sname}: loss {loss_k} vs plain {loss_r}"))
        rel = {p: vec_rel(gk[p], gr[p]) for p in sorted(gk)}
        control = {p: vec_rel(gc[p], gr[p]) for p in sorted(gk)}
        for path, e in rel.items():
            pending.append((bool(torch.isfinite(gk[path]).all())
                            and gr[path].abs().max().item() > 0
                            and e <= R7_LIMIT,
                            f"phase 7r {sname}: gradient {path} |diff| / "
                            f"|ref| {e:.3g} > {R7_LIMIT}"))
        worst = sorted(rel, key=rel.get, reverse=True)[:3]
        worst_leaf = worst[0]
        worst_max = max((gk[p] - gr[p]).abs().max().item()
                        / gr[p].abs().max().item() for p in gk)
        caught = sum(e > R7_LIMIT for e in control.values())
        pending.append((caught > 0, f"phase 7r {sname}: the control (the "
                        f"recurrence's backward {R7_FAULT} off) took no leaf "
                        f"past {R7_LIMIT}: worst {max(control.values()):.3g}"))
        rwkv_train_model[sname] = dict(
            labels_ignored_before=R7_SKIP, limit=R7_LIMIT,
            logits_vec_rel=lg_rel, logits_max_rel=diff / top, loss=loss_k,
            loss_plain=loss_r, loss_rel=loss_rel, grad_leaves=len(gk),
            grad_worst_leaf=worst_leaf, grad_worst_vec_rel=rel[worst_leaf],
            grad_worst_max_rel=worst_max, control_fault=R7_FAULT,
            control_worst_vec_rel=max(control.values()),
            control_leaves_past_limit=caught, trainable=pstats["trainable"],
            total=pstats["total"], kernel_vs_plain=rel,
            control_vs_plain=control,
            launches={k: v for k, v in launched.items() if v})
        log(f"[7r] {RWKV_ARCH} fp32 {sname}, {Lr7} layers, one "
            f"{B7}x{LM_TRAIN['seq']} lm_batches batch, labels from position "
            f"{R7_SKIP} on: kernel path vs plain path logits |diff| / |ref| "
            f"{lg_rel:.3g} (limit {R7_LIMIT}; max |diff| / max|ref| "
            f"{diff / top:.3g}), lm_loss {loss_k:.6f} vs {loss_r:.6f} (rel "
            f"{loss_rel:.3g}, tol 1e-5), {len(gk)} gradient leaves, worst "
            + ", ".join(f"{p}: {rel[p]:.3g}" for p in worst)
            + f" (limit {R7_LIMIT}; {sum(e > 1e-2 for e in rel.values())} "
            f"past 1e-2; worst max |diff| / max|ref| {worst_max:.3g}); "
            f"control, the "
            f"recurrence's backward {R7_FAULT} off: worst "
            f"{max(control.values()):.3g}, {caught} of {len(gk)} leaves past "
            f"the limit; trainable {pstats['trainable']:,} of "
            f"{pstats['total']:,}; launches of the loss and its gradients "
            f"{rwkv_train_model[sname]['launches']}")
        del runs, lg, lr_, gk, gr, gc, params
        torch.cuda.empty_cache()
    del batch7r
    for cond, msg in pending:
        check(cond, msg)
    phase_done("7r")

    # -- phase 8: two-stage training at full width, fp32 --------------------
    def count_loop_calls(mod=loop):
        """Wrap the step and eval builders that `mod` calls (the train
        loop's; the pretrainer has a train step alone) for one run: each
        step function they build records, per call, its own change of the
        launch counts. Returns ({"train": [...], "eval": [...]}, one list of
        per-call dicts per built function, in build order), restore)."""
        runs = {"train": [], "eval": []}

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

        originals = {name: getattr(mod, name)
                     for name in ("build_train_step", "build_eval_step")
                     if hasattr(mod, name)}
        for name, builder in originals.items():
            setattr(mod, name, wrap(builder, runs[name.split("_")[1]]))

        def restore():
            for name, builder in originals.items():
                setattr(mod, name, builder)
        return runs, restore

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

    def rates(hist, tokens=B_tr * S_tr):
        """Step rates of a stage from its history (each step timed to a
        device sync) of `tokens` a step; the first step, which warms the
        caches, apart."""
        s = [h["step_s"] for h in hist[1:]]
        mean = sum(s) / len(s)
        return {"first_step_ms": hist[0]["step_s"] * 1e3,
                "host_ms_per_step": mean * 1e3, "steps_per_s": 1 / mean,
                "tokens_per_s": tokens / mean,
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
        phase_done(f"8 {phase}")

    # -- phase 8d: decoder-LM fine-tuning of qwen3-0.6b in bf16 ------------
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.quant import calibrate
    from repro_torch.train.losses import loss_for
    from repro_torch.train.steps import restore_state

    lm_cfg = peft.attach(get_arch(ARCH), lm_strat)  # bf16, as JAX's defaults
    Bl, Sl = LM_TRAIN["batch"], LM_TRAIN["seq"]
    base = M.init_params(
        torch.Generator(device=dev).manual_seed(LM_TRAIN["seed"]), lm_cfg)
    # predicted launches of every train step, from the code: the forward
    # runs #3 at each layer's adapter seam and #4 in each layer's
    # attention, the backward #2 under each #3 (the attention backward is
    # plain torch, the tied head a matmul); a quantized trunk adds #7 in
    # each of a layer's 7 projections (dx is plain torch); microbatch=2
    # runs all of it twice
    want_bf = per_call({fa: Lq, fl: Lq, ab: Lq})
    want_q = per_call({fa: Lq, fl: Lq, ab: Lq, dq: 7 * Lq})
    lm_report, lm_launches = {}, {}
    # what lm_run trains: 8d's qwen3-0.6b here, 8r's rwkv6-1.6b later
    lm_ctx = dict(cfg=lm_cfg, strat=lm_strat, base=base, corpus=corpus,
                  count=QWEN3_TRAINABLE, phase="8d", arch=ARCH,
                  report=lm_report, launches=lm_launches, key="train_lm_")

    def lm_batches_of(n, seed=LM_TRAIN["seed"]):
        return lm_batches(lm_ctx["corpus"], n, Bl, Sl, seed=seed)

    def probe_loss(state, batch):
        with torch.no_grad():
            cfg_ = lm_ctx["cfg"]
            return loss_for(cfg_)(cfg_, state["params"], batch)[0].item()

    def lm_run(tag, steps_, want, total=None, microbatch=0, state=None,
               batches=None, manager=None, save_every=0, profile=True,
               probe=None, ocfg=None):
        """`steps_` steps of `run_train` from `base` (or `state`), each
        step's own launches counted and held to `want`; the trainable
        count, finite losses, rates, the run's peak device bytes and,
        with `profile`, a torch.profiler breakdown of two more steps.
        Given a `probe` batch, also its loss before and after the steps
        (outside the launch counts) and the trainable leaves that the
        steps left as they were."""
        ocfg = ocfg or OptimCfg(lr=LM_TRAIN["lr"], total_steps=total or steps_)
        cfg_, strat_, ph = lm_ctx["cfg"], lm_ctx["strat"], lm_ctx["phase"]
        if state is None:
            state = make_state(None, cfg_, strat_, ocfg,
                               params=lm_ctx["base"])
        plain_step = build_train_step(cfg_, ocfg, microbatch=microbatch)
        calls = []
        if probe is not None:
            probe_before = probe_loss(state, probe)
            start = {p: t.detach().clone()
                     for p, t in state["trainable"].items()}

        def counted(st, batch):
            before = _build.launch_counts()
            out = plain_step(st, batch)
            after = _build.launch_counts()
            calls.append({k: after[k] - before[k] for k in after})
            return out

        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        state, hist = loop.run_train(
            state, counted, batches if batches is not None
            else lm_batches_of(steps_), steps=steps_, log_every=10,
            manager=manager, save_every=save_every, log=log)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launched = lm_ctx["launches"][tag] = _build.launch_counts()
        check(len(calls) == steps_, f"phase {ph} {tag}: {len(calls)} steps "
                                    f"counted, want {steps_}")
        for i, c in enumerate(calls):
            check(c == want, f"phase {ph} {tag}: step {i} launched {c}, "
                             f"predicted {want}")
        for k, total_k in launched.items():
            check(sum(c[k] for c in calls) == total_k,
                  f"phase {ph} {tag}: {k} launched outside the train steps")
        pstats = peft.param_stats(state["params"], peft.trainable_mask(
            state["params"], strat_, 2, cfg=cfg_))
        check((pstats["trainable"], pstats["total"]) == lm_ctx["count"],
              f"phase {ph} {tag}: trainable {pstats['trainable']} of "
              f"{pstats['total']}, want {lm_ctx['count']}")
        rep = dict(rates(hist, Bl * Sl), steps=steps_,
                   launches_per_step={k: v for k, v in want.items() if v},
                   trainable=pstats["trainable"], total=pstats["total"],
                   percent=pstats["percent"], peak_bytes=peak,
                   held_bytes_before=held)
        check(all(math.isfinite(v) for v in rep["losses"]),
              f"phase {ph} {tag}: non-finite loss {rep['losses']}")
        if probe is not None:
            rep["probe_loss_before"] = probe_before
            rep["probe_loss_after"] = probe_loss(state, probe)
            rep["leaves_unmoved"] = sorted(
                p for p, t in state["trainable"].items()
                if torch.equal(t, start[p]))
            del start
        if profile:
            batch = loop.to_device(next(lm_batches_of(1, seed=99)), dev)
            rep["profile"] = profile_calls(lambda: plain_step(state, batch), 2,
                                           warm=1)  # the lane warmed it
        lm_ctx["report"][tag] = rep
        step_calls[lm_ctx["key"] + tag] = calls
        log(f"[{ph}] {tag} on {smi}: {lm_ctx['arch']} bf16, {steps_} steps "
            f"of {Bl}x{Sl} "
            f"lm_batches tokens; trainable {pstats['trainable']:,} of "
            f"{pstats['total']:,} ({pstats['percent']:.4f}%); launches per "
            f"step as predicted {rep['launches_per_step']}; "
            f"{json.dumps(rep)}")
        return state, rep

    # (a) the adapter on the bf16 trunk: the loss falls. The steps' own
    # losses are of different batches and fall by about their spread, so
    # the loss of one fixed batch (the first step's, the run is
    # deterministic) is taken before and after the steps, and every
    # trainable leaf, the bf16 norm scales included, must have moved
    probe = loop.to_device(next(lm_batches_of(1)), dev)
    state, rep = lm_run("hadamard", LM_TRAIN["steps"], want_bf, probe=probe)
    first, last = rep["losses"][:5], rep["losses"][-5:]
    check(sum(last) / 5 < sum(first) / 5, f"phase 8d hadamard: the last 5 "
          f"losses' mean {sum(last) / 5} is not below the first 5's "
          f"{sum(first) / 5}")
    check(rep["probe_loss_after"] < rep["probe_loss_before"],
          f"phase 8d hadamard: the fixed batch's loss went from "
          f"{rep['probe_loss_before']} to {rep['probe_loss_after']}")
    check(not rep["leaves_unmoved"], f"phase 8d hadamard: "
          f"{len(rep['leaves_unmoved'])} trainable leaves never moved "
          f"{rep['leaves_unmoved'][:4]}")
    log(f"[8d] hadamard: the fixed batch's loss {rep['probe_loss_before']:.6f}"
        f" -> {rep['probe_loss_after']:.6f} over {LM_TRAIN['steps']} steps; "
        f"every one of {len(state['trainable'])} trainable leaves moved")
    del state, probe
    # (b) QPEFT over an int8 trunk whose clips come from calibration on 2
    # batches drawn from seed + 1, as the launcher draws them
    t0 = time.perf_counter()
    stats = calibrate(lm_cfg, base, lm_batches_of(
        LM_TRAIN["calibrate_batches"], seed=LM_TRAIN["seed"] + 1),
        max_batches=LM_TRAIN["calibrate_batches"])
    cal_s = time.perf_counter() - t0
    check(sorted(stats) == sorted(f"{g}/{w}" for g, ws in (
        ("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("wi", "wg", "wo")))
        for w in ws), f"phase 8d: calibrated tags {sorted(stats)}")
    for quant, tag in (("int8", "int8_calibrated"), ("fp8", "fp8")):
        t0 = time.perf_counter()
        state = make_state(None, lm_cfg, lm_strat, OptimCfg(
            lr=LM_TRAIN["lr"], total_steps=LM_TRAIN["quant_steps"]),
            params=base, quant=quant,
            quant_stats=stats if quant == "int8" else None)
        quant_s = time.perf_counter() - t0
        qs = quant_summary(state["params"],
                           leaf_name=lambda p: jax_path(p, lm_cfg))
        qline = (f"quantized trunk: {qs['n_quantized_leaves']} leaves, "
                 f"{qs['dense_bytes_fp32'] / 2**20:.1f} MiB fp32 -> "
                 f"{qs['quantized_bytes'] / 2**20:.1f} MiB "
                 f"({qs['ratio']:.2f}x)")
        check(qs["n_quantized_leaves"] == 7, f"phase 8d {tag}: {qline}")
        log(f"[8d] {tag}: {qline}; quantized in {quant_s:.1f} s"
            + (f" after calibrating {len(stats)} call sites over "
               f"{LM_TRAIN['calibrate_batches']} batches in {cal_s:.1f} s"
               if quant == "int8" else ""))
        state, rep = lm_run(tag, LM_TRAIN["quant_steps"], want_q, state=state)
        rep.update(quant_line=qline, quant_summary=qs, quantize_s=quant_s)
        if quant == "int8":
            rep["calibrate_s"] = cal_s
        del state
    # (d) gradient accumulation over 2 slices of each batch
    state, _ = lm_run("microbatch2", LM_TRAIN["microbatch_steps"],
                      {k: 2 * v for k, v in want_bf.items()}, microbatch=2)
    del state
    # (e) checkpointed resume: an unbroken run saving every 3 steps, then a
    # fresh state restored from step 3 takes steps 4-6 on the same batches
    n_r, k_r = LM_TRAIN["resume_steps"], LM_TRAIN["save_every"]
    with tempfile.TemporaryDirectory() as ckdir:
        mgr = CheckpointManager(ckdir, keep=3)
        whole, rep_w = lm_run("resume_unbroken", n_r, want_bf, manager=mgr,
                              save_every=k_r, profile=False)
        check(mgr.steps() == list(range(k_r, n_r + 1, k_r)),
              f"phase 8d resume: snapshots {mgr.steps()}")
        restored, meta = mgr.restore(k_r)
        fresh = make_state(None, lm_cfg, lm_strat, OptimCfg(
            lr=LM_TRAIN["lr"], total_steps=n_r), params=base)
        restore_state(fresh, restored)
        check(fresh["step"] == k_r == meta["step"], f"phase 8d resume: "
              f"restored step {fresh['step']}, meta {meta}")
        fresh, rep_r = lm_run(
            "resume_from_3", n_r - k_r, want_bf, total=n_r, state=fresh,
            batches=itertools.islice(lm_batches_of(n_r), k_r, None),
            profile=False)
    got, want = rep_r["losses"], rep_w["losses"][k_r:]
    rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    leaves_equal = all(torch.equal(fresh["trainable"][p], t)
                       for p, t in whole["trainable"].items())
    check(rel <= 1e-5, f"phase 8d resume: steps {k_r + 1}-{n_r} losses {got} "
                       f"vs unbroken {want}")
    lm_report["resume"] = {"losses_resumed": got, "losses_unbroken": want,
                           "bit_for_bit_losses": got == want,
                           "max_rel_loss_diff": rel,
                           "trainable_leaves_bit_for_bit": leaves_equal}
    log(f"[8d] resume on {smi}: steps {k_r + 1}-{n_r} restored from step "
        f"{k_r}: losses {got} vs unbroken {want}; bit for bit "
        f"{got == want} (max rel diff {rel:.3g}, limit 1e-5); trainable "
        f"leaves after step {n_r} bit for bit {leaves_equal}")
    del whole, fresh, base, corpus
    lm_ctx.update(base=None, corpus=None)
    torch.cuda.empty_cache()
    phase_done("8d")

    # -- phase 8r: rwkv6-1.6b LM fine-tuning in bf16 ------------------------
    # lm_run over rwkv6-1.6b at full width, 16 x 128 lm_batches tokens a
    # step: the Hadamard adapter (the fixed batch's loss falls, every
    # trainable leaf moves), an int8 trunk (the untied head alone
    # quantized: #7 forward, the plain fp32 dx) and compressed gradients
    # over bf16 m + int8 v moments with error feedback. Predicted launches
    # of every step, from the code: #8 in every layer (its backward is
    # plain torch), #3 at every seam and #2 under it; the int8 head one #7
    from repro_torch.optim import qstate

    rwkv_cfg = peft.attach(get_arch(RWKV_ARCH), lm_strat)  # bf16
    Lr8 = rwkv_cfg.n_layers
    rwkv_report, rwkv_launches = {}, {}
    lm_ctx.update(
        cfg=rwkv_cfg, base=M.init_params(torch.Generator(device=dev)
                                         .manual_seed(LM_TRAIN["seed"]),
                                         rwkv_cfg),
        corpus=lm_corpus(rwkv_cfg.vocab_size, 200_000, seed=LM_TRAIN["seed"]),
        count=RWKV_TRAINABLE["hadamard"], phase="8r", arch=RWKV_ARCH,
        report=rwkv_report, launches=rwkv_launches, key="train_rwkv_")
    want_r = per_call({"wkv6": Lr8, fa: Lr8, ab: Lr8})
    probe = loop.to_device(next(lm_batches_of(1)), dev)
    state, rep = lm_run("hadamard", RWKV_TRAIN["steps"], want_r, probe=probe)
    check(rep["probe_loss_after"] < rep["probe_loss_before"],
          f"phase 8r hadamard: the fixed batch's loss went from "
          f"{rep['probe_loss_before']} to {rep['probe_loss_after']}")
    check(not rep["leaves_unmoved"], f"phase 8r hadamard: "
          f"{len(rep['leaves_unmoved'])} trainable leaves never moved "
          f"{rep['leaves_unmoved'][:4]}")
    log(f"[8r] hadamard: the fixed batch's loss {rep['probe_loss_before']:.6f}"
        f" -> {rep['probe_loss_after']:.6f} over {RWKV_TRAIN['steps']} "
        f"steps; every one of {len(state['trainable'])} trainable leaves "
        "moved")
    del state, probe
    n_q = RWKV_TRAIN["other_steps"]
    ocfg_q = OptimCfg(lr=LM_TRAIN["lr"], total_steps=n_q)
    state = make_state(None, rwkv_cfg, lm_strat, ocfg_q,
                       params=lm_ctx["base"], quant="int8")
    qs = quant_summary(state["params"],
                       leaf_name=lambda p: jax_path(p, rwkv_cfg))
    check(qs["n_quantized_leaves"] == 1, f"phase 8r int8: {qs}")
    # (the Hadamard lane's profile stands for the three: the other two
    # lanes add one #7 or the optimizer's compression to the same step)
    state, rep = lm_run("int8", n_q, per_call({"wkv6": Lr8, fa: Lr8,
                                               ab: Lr8, dq: 1}),
                        state=state, ocfg=ocfg_q, profile=False)
    rep["quant_summary"] = qs
    del state
    ocfg_c = OptimCfg(lr=LM_TRAIN["lr"], total_steps=n_q,
                      compress_grads=True, m_dtype="bfloat16",
                      v_dtype="int8")
    state = make_state(None, rwkv_cfg, lm_strat, ocfg_c,
                       params=lm_ctx["base"])
    state, rep = lm_run("compress_bf16_int8", n_q, want_r, state=state,
                        ocfg=ocfg_c, profile=False)
    rep["optimizer_state"] = qstate.state_summary(state["opt"], ocfg_c)
    check(set(state["err"]) == set(state["trainable"]) and "v_err" in
          state["opt"], f"phase 8r compress: state {sorted(state)}, "
          f"opt {sorted(state['opt'])}")
    log(f"[8r] compress_bf16_int8: optimizer state "
        f"{json.dumps(rep['optimizer_state'])}")
    del state
    lm_ctx.update(base=None, corpus=None)
    torch.cuda.empty_cache()
    phase_done("8r")

    # -- phase 8p: the paper's tables at full width, over a pretrained
    # bert-base ------------------------------------------------------------
    from repro_torch.core import patterns
    from repro_torch.sparse import importance as imp
    from repro_torch.sparse import prune as prune_mod

    paper_launches, paper_report = {}, {}
    # predicted launches per train step and eval batch, from the code: the
    # forward runs #4 in every layer; a Hadamard adapter at attn_out adds
    # #3 in every layer's seam, and any stage that trains a Hadamard leaf
    # (w, b or the norms past it: Table 4's B+N too) runs the seam's
    # backward, #2, once a layer, whatever the gate does to the gradient
    # afterwards; the baselines' hooks and MLM pretraining run no kernel
    # of their own, and their backward through #4 is plain torch
    plain_step = per_call({flash: L})
    had_step = per_call({flash: L, fused: L, aff_bwd: L})
    had_eval = per_call({flash: L, fused: L})

    def paper_lane(tag, run, want_steps, want_evals, mod=loop):
        """`run()` with every train step and eval batch it builds through
        `mod` counted: the i-th built train (eval) function's calls each
        launch want_steps[i] (want_evals[i]; a dict stands for all of
        them), and nothing launches outside them. Returns (run's result,
        the lane's seconds, its train step calls)."""
        calls, restore = count_loop_calls(mod)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        try:
            res = run()
            torch.cuda.synchronize()
        finally:
            restore()
        lane_s = time.perf_counter() - t0
        paper_launches[tag] = _build.launch_counts()
        for kind, want in (("train step", want_steps),
                           ("eval batch", want_evals)):
            built = calls["train" if kind == "train step" else "eval"]
            wants = want if isinstance(want, list) else [want] * len(built)
            check(len(built) == len(wants), f"phase 8p {tag}: {len(built)} "
                  f"{kind} functions built, want {len(wants)}")
            for j, (fn_calls, w) in enumerate(zip(built, wants)):
                check(len(fn_calls) > 0, f"phase 8p {tag}: {kind} function "
                      f"{j} never called")
                for i, c in enumerate(fn_calls):
                    check(c == w, f"phase 8p {tag}: {kind} function {j} "
                          f"call {i} launched {c}, predicted {w}")
        for k, total in paper_launches[tag].items():
            check(sum(c[k] for fn_calls in calls["train"] + calls["eval"]
                      for c in fn_calls) == total,
                  f"phase 8p {tag}: {k} launched outside train steps and "
                  "eval batches")
        if calls["train"]:
            step_calls[f"paper_{tag}"] = [c for f in calls["train"]
                                          for c in f]
        if calls["eval"]:
            eval_calls[f"paper_{tag}"] = [c for f in calls["eval"] for c in f]
        return res, lane_s

    def lane_report(tag, res, lane_s, counts=None, hist=None, metric_=None):
        """A lane's quality, trainable count (held to `counts`), rates and
        seconds; every loss finite."""
        stats = res.get("param_stats")
        rep = {"lane_s": lane_s}
        if stats is not None:
            rep.update(trainable=stats["trainable"], total=stats["total"],
                       percent=stats["percent"])
            if counts is not None:
                check((stats["trainable"], stats["total"]) == counts,
                      f"phase 8p {tag}: trainable {stats['trainable']} of "
                      f"{stats['total']}, want {counts}")
        hist = hist if hist is not None else res["history"]
        rep.update(rates(hist))
        check(all(math.isfinite(v) for v in rep["losses"]),
              f"phase 8p {tag}: non-finite loss")
        rep[metric_ or metric] = res["final_metric"]
        paper_report[tag] = rep
        log(f"[8p] {tag} on {smi}: {metric_ or metric} "
            f"{res['final_metric']:.4f}; "
            + (f"trainable {rep['trainable']:,} of {rep['total']:,} "
               f"({rep['percent']:.4f}%); " if stats is not None else "")
            + f"{rep['host_ms_per_step']:.1f} host ms a step, "
            f"{rep['tokens_per_s']:.0f} tok/s; lane {lane_s:.1f} s; launches "
            f"{ {k: v for k, v in paper_launches[tag].items() if v} }")
        return rep

    # (1) MLM pretraining of bert-base, every leaf trained (`full`), in a
    # cache directory of its own, so that no earlier run's file is read
    pre_hist = []
    run_train_of_pretrain = pretrain_mod.run_train

    def kept_history(*a, **kw):
        state_, hist_ = run_train_of_pretrain(*a, **kw)
        pre_hist.extend(hist_)
        return state_, hist_

    with tempfile.TemporaryDirectory() as pre_dir:
        torch.cuda.synchronize()
        pre_held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        pretrain_mod.run_train = kept_history
        try:
            pretrained, pre_s = paper_lane(
                "pretrain", lambda: pretrain_mod.pretrain_encoder(
                    bert, steps=PAPER["pretrain_steps"], batch=B_tr,
                    seq=S_tr, lr=PAPER["pretrain_lr"],
                    mask_rate=PAPER["mask_rate"], seed=PAPER["seed"],
                    cache_dir=pre_dir, log=log, device=dev),
                plain_step, [], mod=pretrain_mod)
        finally:
            pretrain_mod.run_train = run_train_of_pretrain
        torch.cuda.synchronize()
        pre_peak = torch.cuda.max_memory_allocated()
    check(len(pre_hist) == PAPER["pretrain_steps"],
          f"phase 8p pretrain: {len(pre_hist)} steps run")
    pre_rep = dict(rates(pre_hist), steps=PAPER["pretrain_steps"],
                   lane_s=pre_s, peak_bytes=pre_peak,
                   held_bytes_before=pre_held)
    losses_ = pre_rep.pop("losses")
    first5, last5 = sum(losses_[:5]) / 5, sum(losses_[-5:]) / 5
    check(all(math.isfinite(v) for v in losses_),
          "phase 8p pretrain: non-finite mlm loss")
    check(last5 < first5, f"phase 8p pretrain: the last 5 mlm losses' mean "
          f"{last5} is not below the first 5's {first5}")
    pre_rep.update(mlm_first5_mean=first5, mlm_last5_mean=last5,
                   mlm_losses_every_50=losses_[::50])
    ocfg_pre = OptimCfg(lr=PAPER["pretrain_lr"],
                        total_steps=PAPER["pretrain_steps"])
    pre_state = make_state(None, bert_full, full, ocfg_pre, params=pretrained)
    pre_step = build_train_step(bert_full, ocfg_pre,
                                loss_fn=pretrain_mod.mlm_loss)
    pre_rep["profile"] = profile_calls(lambda: pre_step(pre_state, mlm_batch),
                                       2, warm=1)
    del pre_state, pre_step
    paper_report["pretrain"] = pre_rep
    log(f"[8p] pretrain on {smi}: {TRAIN['arch']} fp32 MLM, "
        f"{PAPER['pretrain_steps']} steps of {B_tr}x{S_tr} tokens; mlm loss "
        f"first-5 mean {first5:.4f}, last-5 mean {last5:.4f} (ln "
        f"{bert.vocab_size} = {math.log(bert.vocab_size):.4f}); "
        f"{pre_rep['host_ms_per_step']:.1f} host ms a step "
        f"({pre_rep['tokens_per_s']:.0f} tok/s), device ms a step "
        f"{pre_rep['profile']['device_ms']:.1f}, peak {pre_peak / 1e9:.2f} GB;"
        f" lane {pre_s:.1f} s; launches per step as predicted")
    torch.cuda.empty_cache()

    # (2) stage 1, the classifier alone, on sst2 over the pretrained
    # backbone (Table 2's first column)
    def paper_tc(lr):
        n = PAPER["steps"]
        return TrainCfg(optim=OptimCfg(lr=lr, total_steps=n,
                                       warmup_steps=n // 10),
                        steps=n, batch_size=B_tr, seq_len=S_tr, log_every=10)

    tc1, tc2 = paper_tc(PAPER["stage1_lr"]), paper_tc(PAPER["stage2_lr"])
    res, lane_s = paper_lane(
        "stage1_sst2", lambda: loop.two_stage_finetune(
            PAPER["seed"], bert, "classifier_only", data, stage1=tc1,
            stage2=tc2, metric=metric, pretrained_params=pretrained,
            device=dev, log=log), plain_step, plain_step)
    stage1_sst2 = res["stage1_params"]
    cfg1 = peft.attach(bert, peft.strategy("classifier_only"))
    res["param_stats"] = peft.param_stats(stage1_sst2, peft.trainable_mask(
        stage1_sst2, peft.strategy("classifier_only"), 2, cfg=cfg1))
    lane_report("stage1_sst2", res, lane_s, PAPER_COUNTS["classifier_only"],
                hist=res["history"]["stage1"])
    del res

    # (3) stage 2 on sst2 from that one stage-1 tree (Tables 2 and 3)
    stage2 = {}
    for sname in ("hadamard", "full", "lora", "ia3", "houlsby"):
        want_s = had_step if sname == "hadamard" else plain_step
        want_e = had_eval if sname == "hadamard" else plain_step
        res, lane_s = paper_lane(
            f"stage2_{sname}", lambda sname=sname: loop.run_stage2(
                bert, sname, data,
                paper_tc(PAPER["full_lr"]) if sname == "full" else tc2,
                stage1_sst2, metric=metric, seed=PAPER["seed"], log=log),
            want_s, want_e)
        lane_report(f"stage2_{sname}", res, lane_s, PAPER_COUNTS[sname])
        stage2[sname] = res["final_metric"]
        if sname == "hadamard":
            sst2_hadamard = (res["params"], res["cfg"])
        del res
        torch.cuda.empty_cache()
    clf = paper_report["stage1_sst2"][metric]
    gap = stage2["full"] - clf
    table2 = {"classifier_only": clf, "hadamard": stage2["hadamard"],
              "full": stage2["full"],
              "gap_recovered": (stage2["hadamard"] - clf) / gap if gap
              else None}

    # (4) Table 5: the Hadamard adapter of the top k layers alone
    for k in PAPER["table5_top"]:
        lmask = imp.depth_mask(bert, k)
        res, lane_s = paper_lane(
            f"table5_top{k}", lambda lmask=lmask: loop.run_stage2(
                bert, "hadamard", data, tc2, stage1_sst2,
                metric=metric, seed=PAPER["seed"], layer_mask=lmask,
                log=log), had_step, had_eval)
        # the adapter w, b and ffn_norm of k layers (3,072 at bert-base's
        # width: Table 5's top 8 is 24,576, the paper's 0.022 %)
        lane_report(f"table5_top{k}", res, lane_s,
                    (k * PAPER_COUNTS["hadamard"][0] // L,
                     PAPER_COUNTS["hadamard"][1]))
        # a gated-off layer's b gets zero gradients, and AdamW's decay of
        # a zero leaf is zero: it stays exactly 0, where the gate is a
        # multiplier and not a freeze; an ungated layer's b moves
        b_moved = [bool(layer["adapter"]["b"].any())
                   for layer in res["params"]["layers"]]
        check(b_moved == list(lmask), f"phase 8p table5_top{k}: adapter b "
              f"moved in layers {b_moved}, mask {lmask.tolist()}")
        w_off = [layer["adapter"]["w"]
                 for layer, on in zip(res["params"]["layers"], lmask)
                 if not on]
        paper_report[f"table5_top{k}"]["gated_off_w_max_abs_dev"] = max(
            ((w - 1).abs().max().item() for w in w_off), default=0.0)
        del res
        torch.cuda.empty_cache()

    # (5) Table 4: two of its module combos
    for combo in PAPER["table4"]:
        res, lane_s = paper_lane(
            f"table4_{combo}", lambda combo=combo: loop.run_stage2(
                bert, peft.ablation_strategy(combo), data, tc2,
                stage1_sst2, metric=metric, seed=PAPER["seed"], log=log),
            had_step, had_eval)
        lane_report(f"table4_{combo}", res, lane_s,
                    PAPER_COUNTS[f"hadamard[{combo}]"])
        del res
        torch.cuda.empty_cache()

    # (6) a second task's two-stage Hadamard run, then Fig. 5's patterns
    # across the two tasks' adapters
    task2 = PAPER["second_task"]
    data2 = TaskData(task2, bert.vocab_size, seq_len=S_tr, seed=TRAIN["seed"])
    metric2 = GLUE[task2].metric
    res, lane_s = paper_lane(
        f"two_stage_{task2}", lambda: loop.two_stage_finetune(
            PAPER["seed"], bert, "hadamard", data2, stage1=tc1,
            stage2=tc2, metric=metric2, pretrained_params=pretrained,
            device=dev, log=log),
        [plain_step, had_step], [plain_step, had_eval])
    lane_report(f"two_stage_{task2}", res, lane_s, PAPER_COUNTS["hadamard"],
                hist=res["history"]["stage2"], metric_=metric2)
    paper_report[f"two_stage_{task2}"]["stage1_" + metric2] = \
        res["stage1_metric"]
    task_params = {TRAIN["task"]: sst2_hadamard[0], task2: res["params"]}
    sim = patterns.cross_task_similarity(task_params, sst2_hadamard[1])
    fig5 = dict(patterns.consistency_report(sim), tasks=sim["tasks"],
                w_cos_per_layer=sim["w"][:, 0, 1].tolist(),
                b_cos_per_layer=sim["b"][:, 0, 1].tolist())
    dists = patterns.layer_distributions(sst2_hadamard[0], sst2_hadamard[1])
    fig5["sst2_w_mean_per_layer"] = dists["w"][:, 0].tolist()
    fig5["sst2_b_std_per_layer"] = dists["b"][:, 1].tolist()
    log(f"[8p] fig5 on {smi}: {TRAIN['task']} and {task2} Hadamard adapters:"
        f" mean cross-task cosine of w {fig5['w_mean_cross_task_cos']:.4f}, "
        f"of b {fig5['b_mean_cross_task_cos']:.4f}")
    del res, task_params
    torch.cuda.empty_cache()

    # (7) post-training layer importance and a budgeted mask search over
    # the sst2 Hadamard adapter, by eval-only quality
    had_params, had_cfg = sst2_hadamard

    def quality(p):
        return loop.evaluate(had_cfg, p, data.eval_batches(B_tr), metric)

    scores, lane_s = paper_lane(
        "ablation_importance",
        lambda: imp.ablation_importance(had_params, had_cfg, quality),
        [], [had_eval] * (L + 1))
    (search, history), search_s = paper_lane(
        "search_mask", lambda: prune_mod.search_mask(
            scores, lambda m: quality(imp.apply_layer_mask(
                had_params, had_cfg, m)),
            budget=PAPER["search_budget"]),
        [], had_eval)
    search_rep = {"importance": scores.tolist(), "importance_s": lane_s,
                  "budget": PAPER["search_budget"],
                  "kept_layers": int(search.sum()),
                  "mask": search.tolist(),
                  "quality_all_layers": history[0]["quality"],
                  "quality_kept": [h for h in history
                                   if h["accepted"]][-1]["quality"],
                  "probes": len(history), "search_s": search_s}
    log(f"[8p] layer search on {smi}: importance {json.dumps(scores.tolist())}"
        f"; search_mask (budget {PAPER['search_budget']}) keeps "
        f"{int(search.sum())} of {L} layers at {metric} "
        f"{search_rep['quality_kept']:.4f} (all layers "
        f"{history[0]['quality']:.4f}) over {len(history)} probes")
    del had_params, sst2_hadamard, stage1_sst2, pretrained
    torch.cuda.empty_cache()
    paper_report.update(table2=table2, fig5=fig5, layer_search=search_rep)
    log(f"[8p] table2 on {smi}: classifier-only {clf:.4f}, hadamard "
        f"{stage2['hadamard']:.4f}, full {stage2['full']:.4f}; gap "
        f"recovered {table2['gap_recovered']}; lora {stage2['lora']:.4f}, "
        f"ia3 {stage2['ia3']:.4f}, houlsby {stage2['houlsby']:.4f}")
    phase_done("8p")

    # -- phase 8q: launch.pretrain's path on bert-base, quantized moments ---
    # MLM pretraining of every leaf of bert-base (fp32, TRAIN's 32 x 128
    # tokens a step) with each moment preset of `launch.pretrain`, as its
    # main() builds them (`optim_for`), PRETRAIN_Q["steps"] steps each on
    # the same batch stream: every step's launches as predicted (#4 in
    # every layer, nothing else: `full` has no adapter, and the optimizer
    # is plain torch); each state's bytes equal to state_summary's formula
    # counted from the leaves' shapes, bf16 2.0x and all-int8 without
    # error feedback >= 3x (JAX's optim bench's bytes gate); bf16+int8's
    # final MLM loss (the mean of the last 10 steps', the bench's tail)
    # within 1 % of fp32 moments' (its quality gate); and a bf16+int8 run
    # resumed from its snapshot at PRETRAIN_Q["resume_at"] bit for bit the
    # unbroken one
    from repro_torch.launch.pretrain import optim_for
    from repro_torch.optim import qstate
    from repro_torch.quant.qtensor import is_qtensor
    from repro_torch.train.steps import state_tree

    n_pq, at_pq = PRETRAIN_Q["steps"], PRETRAIN_Q["resume_at"]
    pq_corpus = lm_corpus(bert.vocab_size, 300_000, seed=PAPER["seed"])
    want_pq = per_call({flash: L})
    pq_report, pq_launches = {}, {}

    def pq_batches():
        return pretrain_mod.mlm_batches(pq_corpus, n_pq, B_tr, S_tr,
                                        mask_rate=PAPER["mask_rate"],
                                        seed=PAPER["seed"])

    def formula_bytes(trainable, ocfg):
        """state_summary's bytes from the leaves' shapes: per moment its
        payload (4, 2 or 1 bytes an element) and, int8, one fp32 scale a
        row of the trailing dim; the residuals of int8 under EF alike;
        the int32 count."""
        def one(dt, t):
            return t.numel() * {"float32": 4, "bfloat16": 2, "int8": 1}[dt] \
                + (4 * t.numel() // t.shape[-1] if dt == "int8" else 0)
        total = 4
        for t in trainable.values():
            for dt in (ocfg.m_dtype, ocfg.v_dtype):
                total += one(dt, t) * (2 if dt == "int8" and ocfg.qstate_ef
                                       else 1)
        return total

    def pq_state(ocfg):
        return make_state(
            torch.Generator(device=dev).manual_seed(PAPER["seed"]), bert_full,
            full, ocfg)

    def pq_run(tag, state, ocfg, batches, steps_, manager=None,
               save_every=0):
        step = build_train_step(bert_full, ocfg, loss_fn=pretrain_mod.mlm_loss)
        calls = []

        def counted(st, batch):
            before = _build.launch_counts()
            out = step(st, batch)
            after = _build.launch_counts()
            calls.append({k: after[k] - before[k] for k in after})
            return out

        torch.cuda.synchronize()
        _build.reset_launches()
        state, hist = loop.run_train(state, counted, batches, steps=steps_,
                                     log_every=0, manager=manager,
                                     save_every=save_every, log=log)
        torch.cuda.synchronize()
        pq_launches[tag] = _build.launch_counts()
        for i, c in enumerate(calls):
            check(c == want_pq, f"phase 8q {tag}: step {i} launched {c}, "
                                f"predicted {want_pq}")
        check(len(calls) == steps_, f"phase 8q {tag}: {len(calls)} steps")
        step_calls[f"pretrain_{tag}"] = calls
        return state, hist, step

    lanes = (("fp32", "", True), ("bf16", "bf16", True),
             ("bf16+int8", "bf16+int8", True), ("int8", "int8", True),
             ("int8_no_ef", "int8", False))
    final_loss = {}
    t8q = {"states": 0.0, "steps": 0.0, "resume": 0.0, "profile": 0.0}
    with tempfile.TemporaryDirectory() as ckdir:
        for tag, preset, ef in lanes:
            ocfg = optim_for(preset, lr=PAPER["pretrain_lr"], steps=n_pq,
                             ef=ef)
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            state = pq_state(ocfg)
            torch.cuda.synchronize()
            made = torch.cuda.memory_allocated() - held
            t8q["states"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            summ = qstate.state_summary(state["opt"], ocfg)
            want_b = formula_bytes(state["trainable"], ocfg)
            check(summ["bytes"] == want_b and summ["n_params"] ==
                  PAPER_COUNTS["full"][0], f"phase 8q {tag}: state bytes "
                  f"{summ}, formula {want_b}")
            torch.cuda.reset_peak_memory_stats()
            stream = pq_batches()
            if tag == "bf16+int8":
                # the unbroken run, its first at_pq steps saving once, as
                # launch/pretrain saves (zlib-framed)
                mgr = CheckpointManager(ckdir, keep=1)
                state, hist, step = pq_run(tag, state, ocfg, stream, at_pq,
                                           manager=mgr, save_every=at_pq)
                calls_a = step_calls[f"pretrain_{tag}"]
                launches_a = pq_launches[tag]
                state, hist_b, step = pq_run(tag, state, ocfg, stream,
                                             n_pq - at_pq)
                hist += hist_b
                step_calls[f"pretrain_{tag}"] = calls_a + \
                    step_calls[f"pretrain_{tag}"]
                pq_launches[tag] = {k: v + launches_a[k] for k, v in
                                    pq_launches[tag].items()}
            else:
                state, hist, step = pq_run(tag, state, ocfg, stream, n_pq)
            t8q["steps"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            peak = torch.cuda.max_memory_allocated()
            rep = dict(rates(hist), optimizer_state=summ,
                       formula_bytes=want_b, allocated_by_make_state=made,
                       peak_bytes=peak, steps=n_pq,
                       launches_per_step={k: v for k, v in want_pq.items()
                                          if v})
            tail = rep["losses"][-10:]
            final_loss[tag] = sum(tail) / len(tail)
            rep["final_loss_tail10"] = final_loss[tag]
            if ef:
                check(all(math.isfinite(v) for v in rep["losses"]),
                      f"phase 8q {tag}: non-finite loss {rep['losses']}")
            if tag == "bf16+int8":
                # the resume: a fresh state restored from the snapshot at
                # at_pq takes the remaining steps on the replayed stream
                fresh = pq_state(ocfg)
                restored, meta = mgr.restore(at_pq)
                restore_state(fresh, restored)
                check(fresh["step"] == at_pq == meta["step"],
                      f"phase 8q resume: restored step {fresh['step']}")
                replay = pq_batches()
                for _ in range(at_pq):
                    next(replay)
                fresh, hist_r, _ = pq_run("bf16+int8_resumed", fresh, ocfg,
                                          replay, n_pq - at_pq)
                got = [h["loss"] for h in hist_r]
                want_l = rep["losses"][at_pq:]
                fa_ = dict(tu.flatten_with_paths(state_tree(state)))
                fb_ = dict(tu.flatten_with_paths(state_tree(fresh)))
                same = set(fa_) == set(fb_) and all(
                    (torch.equal(a.values, fb_[p].values)
                     and torch.equal(a.scales, fb_[p].scales))
                    if is_qtensor(a) else torch.equal(a, fb_[p])
                    for p, a in fa_.items())
                check(got == want_l and same, f"phase 8q resume: steps "
                      f"{at_pq + 1}-{n_pq} losses {got} vs unbroken {want_l}; "
                      f"state bit for bit {same}")
                rep["resume"] = {"from_step": at_pq, "losses_resumed": got,
                                 "bit_for_bit_losses": got == want_l,
                                 "state_bit_for_bit": same}
                del fresh, restored
            t8q["resume"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            if tag == "int8":  # after the checks; the slowest lane on an H100
                batch = loop.to_device(next(pq_batches()), dev)
                rep["profile"] = profile_calls(lambda: step(state, batch), 2,
                                               warm=1)  # the lane warmed it
            t8q["profile"] += time.perf_counter() - t0
            pq_report[tag] = rep
            log(f"[8q] {tag} on {smi}: {TRAIN['arch']} full MLM, fp32, "
                f"{n_pq} steps of {B_tr}x{S_tr} tokens, moments "
                f"m={ocfg.m_dtype} v={ocfg.v_dtype}"
                f"{' +ef' if ef and 'int8' in preset else ''}: optimizer "
                f"state {summ['bytes']:,} bytes ({summ['ratio']:.4f}x "
                f"smaller than fp32's {summ['bytes_fp32']:,}; the formula "
                f"{want_b:,}); final loss (last 10) {final_loss[tag]:.5f}; "
                f"{json.dumps(rep)}")
            del state, step
            torch.cuda.empty_cache()
    ratio_bf16 = pq_report["bf16"]["optimizer_state"]["ratio"]
    ratio_floor = pq_report["int8_no_ef"]["optimizer_state"]["ratio"]
    rel_q = abs(final_loss["bf16+int8"] - final_loss["fp32"]) \
        / final_loss["fp32"]
    check(abs(ratio_bf16 - 2.0) <= 1e-6, f"phase 8q: bf16 ratio {ratio_bf16}")
    check(ratio_floor >= 3.0, f"phase 8q: all-int8 no-EF ratio {ratio_floor}"
                              " < 3 (JAX's bench gate)")
    check(rel_q <= 0.01, f"phase 8q: bf16+int8 final loss "
          f"{final_loss['bf16+int8']} off fp32's {final_loss['fp32']} by "
          f"{100 * rel_q:.3f} % (> 1 %, JAX's bench gate)")
    pq_report["gates"] = {"bf16_ratio": ratio_bf16,
                          "int8_no_ef_ratio": ratio_floor,
                          "bf16_int8_final_loss_rel_vs_fp32": rel_q}
    pq_report["seconds"] = t8q
    log("[8q] seconds by part: " + ", ".join(f"{k} {v:.2f}"
                                            for k, v in t8q.items()))
    log(f"[8q] gates on {smi}: bf16 {ratio_bf16:.6f}x (2.0), all-int8 "
        f"no-EF {ratio_floor:.4f}x (>= 3), bf16+int8 final loss "
        f"{100 * rel_q:.4f} % off fp32 (<= 1 %); resume bit for bit")
    del pq_corpus
    phase_done("8q")

    # -- phase 9: the kernels line ------------------------------------------
    fam_train_name = {"8wt": "train_whisper", "8iv": "train_internvl2"}
    train_launches.update({fam_train_name[t]: c
                           for t, c in fam_train_launches.items()})
    step_calls.update({fam_train_name[t]: c
                       for t, c in fam_step_calls.items()})
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
        "dequant_matmul": (csrc + "dequant_matmul.cu",
                           "src/repro/kernels/quant.py:44"),
        "masked_multitask_hadamard": (csrc + "masked_multitask_hadamard.cu",
                                      "src/repro/kernels/sparse.py:50"),
        "wkv6": (csrc + "wkv6.cu", "src/repro/kernels/rwkv6.py:47"),
    }
    serve_name = {"5": "serve_single", "6": "serve_multitask",
                  "5p": "serve_paged", "5pq": "serve_paged_int8",
                  "5pf": "serve_paged_fp8", "5s": "serve_spec",
                  "5sp": "serve_spec_paged", "6p": "serve_paged_multitask",
                  "5q": "serve_single_int8", "6q": "serve_multitask_int8",
                  "5f": "serve_single_fp8", "6s": "serve_hot_swap",
                  "6w": "serve_hot_swap_shared_w", "5r": "serve_rwkv_single",
                  "6r": "serve_rwkv_multitask",
                  "5rq": "serve_rwkv_single_int8",
                  "6rs": "serve_rwkv_hot_swap", "5g": "serve_gemma2_single",
                  "5gp": "serve_gemma2_paged",
                  "6g": "serve_gemma2_multitask",
                  "6gs": "serve_gemma2_hot_swap", "5o": "serve_fold",
                  "5m": "serve_deepseek_single",
                  "6m": "serve_deepseek_multitask",
                  "5mq": "serve_deepseek_single_int8",
                  "5rg": "serve_rgemma_single",
                  "6rg": "serve_rgemma_multitask",
                  "6rgs": "serve_rgemma_hot_swap",
                  "5rgq": "serve_rgemma_single_int8",
                  "5wt": "serve_whisper", "5iv": "serve_internvl2",
                  "5sc": "serve_starcoder2_single",
                  "5scq": "serve_starcoder2_single_int8",
                  "5gq": "serve_gemma2_single_int8",
                  "5ivq": "serve_internvl2_int8"}
    by_phase = {**{serve_name[p]: counts for p, counts in launches.items()},
                **train_launches,
                **{f"train_lm_{t}": c for t, c in lm_launches.items()},
                **{f"train_rwkv_{t}": c for t, c in rwkv_launches.items()},
                **{f"pretrain_{t}": c for t, c in pq_launches.items()},
                **{f"paper_{t}": c for t, c in paper_launches.items()},
                **slo_launches}
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "host_ms",
             "plain_host_ms", "library_host_ms", "bytes", "flops")
    extra_timed = ("yardstick_ms", "yardstick_host_ms", "library_note",
                   "split_plan", "bit_identical_repeats", "ms_l2_warm",
                   "alt_plan", "trace", "refused_plans", "keyless_cases",
                   "bwd_plain_eager_ms", "bwd_route",
                   "library_rel_diff_vs_plain")
    kernels = []
    for name, (src, replaces) in meta.items():
        r = results[name]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "floor_ms": floor_ms, "floor_trace": floor_trace,
            "ptxas": ptxas[Path(src).name],
            # every check failure has already exited; these all passed
            "check": "pass",
            "launches": sum(counts[name] for counts in by_phase.values()),
            "launches_by_phase": {p: counts[name]
                                  for p, counts in by_phase.items()},
            # distinct counts per call in the same runs
            "launches_per_decode_tick": {
                serve_name[p]: rep["launches_per_decode_tick"][name]
                for p, rep in serve_reports.items()},
            "launches_per_prefill": {
                serve_name[p]: rep["launches_per_prefill"][name]
                for p, rep in serve_reports.items()},
            "launches_per_train_step": {
                s: sorted({c[name] for c in calls})
                for s, calls in step_calls.items()},
            "launches_per_eval_batch": {
                s: sorted({c[name] for c in calls})
                for s, calls in eval_calls.items()},
            # from the serve runs' profiles, summed over the source's
            # __global__ functions
            **{f"device_us_per_{call}": {
                serve_name[p]: sum(rep[key]["port_kernel_us"].get(k, 0.0)
                                   for k in source_kernels[Path(src).name])
                for p, rep in serve_reports.items()}
               for call, key in (("decode_tick", "tick"),
                                 ("prefill", "prefill"))},
            "max_abs_err": max(checks[name]["errs"]), "tol_fp32": TOL[name],
            "max_rel_err_bf16": max(checks[name]["rels"]),
            "tol_bf16_rel": BF16_TOL,
            **{k: r[k] for k in timed + extra_timed if k in r},
            "timed_shape": r["shape"],
        }
        if name in REL_TOL:
            entry["max_rel_err_fp32"] = max(checks[name]["rel_errs"])
        for rkey, t in results.items():
            if rkey.startswith(name + "@"):
                entry[f"{rkey.split('@', 1)[1]}_shape_timing"] = dict(
                    {k: t[k] for k in timed + extra_timed if k in t},
                    shape=t["shape"])
        if name == "flash_attention":
            entry["bwd_tiled_long_sequence"] = tiled_bwd
        if name in ("fused_adapter_norm", "flash_attention", "dequant_matmul",
                    "masked_multitask_hadamard", "wkv6"):
            # the backward of the autograd Function around this kernel
            bwd = checks[name + "_bwd"]
            entry["bwd_max_abs_err"] = max(bwd["errs"])
            entry["bwd_max_rel_err_bf16"] = max(bwd["rels"])
        kernels.append(entry)
    serve = {serve_name[p]: {
        k: v for k, v in rep.items()
        if k not in ("launches_per_decode_tick", "launches_per_prefill")}
        for p, rep in serve_reports.items()}
    phase_done("9")
    print(json.dumps({"kernels": kernels, "serve": serve,
                      "quant_model": quant_model, "hot_model": hot_model,
                      "rwkv_model": rwkv_model,
                      "train": train_report, "lm_model": lm_model,
                      "train_lm": lm_report, "mlm_model": mlm_check,
                      "rwkv_train_model": rwkv_train_model,
                      "train_rwkv": rwkv_report, "pretrain_q": pq_report,
                      "paper": paper_report, "slo_admission": slo_report,
                      "gemma2_model": gemma_reports["4g"],
                      "moe_model": moe_reports["4m"],
                      "rgemma_model": rg_reports["4rg"],
                      "rgemma_rg_lru_parts": rg_parts,
                      "whisper_model": fam_reports["4wt"],
                      "internvl2_model": fam_reports["4iv"],
                      "starcoder2_model": fam_reports["4sc"],
                      "train_whisper": fam_reports["8wt"],
                      "train_internvl2": fam_reports["8iv"],
                      "fold": gemma_reports["5o"],
                      "phase_s": phase_s, "card": smi}))
    print(smi)
    count = torch.cuda.device_count()
    check(count == 1, f"{count} CUDA devices visible, want the one it drove")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
