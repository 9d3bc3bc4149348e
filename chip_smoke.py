#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

  python3 chip_smoke.py        # from the repository root, one card

Phases, each fatal on failure (non-zero exit, no result line); each
prints its seconds on a "[time]" line:
  1. device    the card's name and power limit (nvidia-smi)
  2. build     nvcc builds every kernel of csrc/, one process each, at once
  3. kernels   each kernel against its plain version on the card, at
               starcoder2-7b shapes (and granite-moe's and the dense
               configs' attention, sidedelta and scatter_apply shapes);
               times (cold L2) beside the bound (each wrapper's cost()
               over analysis.roofline.HW, the card's peaks):
               sidedelta (S = 1, 16, 256, with the path each S takes,
               and where the token-minor path starts to pay) and
               scatter_apply (serving), sparse_adamw (blocks and rows,
               f32/bf16/int8 moments) and the trainable sidedelta's forward
               and gradients (dx through the forward kernel, dvals) of
               training, and the attention kernels flash_decode ((B,) and
               scalar kv_len), flash_decode_paged (pages of 16, 8, 24;
               G = 9 and 48; and int8 pools), flash_decode's log-sum-exp
               instance (kv_len 0 among them) and flash_prefill, bf16 and
               f32, beside F.scaled_dot_product_attention
  4. serve     starcoder2-7b at full width through repro_torch.launch.serve:
               sequential switching, --fuse, --multi-tenant (f32, int8);
               launch counts are zeroed before each mode and must be > 0
               for every kernel of that mode's path
  5. profile   device time by kernel of one full-width decode step, base
               model and multi-tenant, and of one batch-1, 1024-token
               prefill with flash_prefill's share (torch.profiler)
  6. consistency  full width, 2 layers, f32: multi-tenant tokens equal the
               switch-per-request reference, unfused and with a hot adapter
  7. continuous  full width, 8 of 32 layers (CC_LAYERS, printed: since
               the sequence-sharded slice, for the script's time limit;
               12 since the distributed slice, 16 since the vision and
               audio slice):
               serve --continuous --int8, then a 24-request
               trace (prompts of 64..1024 tokens, half with one shared
               256-token prefix, 32 tokens each) through ServingEngine,
               PagedServingEngine and PagedServingEngine(quant_kv=True)
               over an AdapterStore: tokens/s, TTFT, steps, residency, COW
               copies, launches, peak memory, and one decode-only and one
               prefill step of each engine under torch.profiler; the int8
               pages' KV bytes at most 0.52 of bf16's, every paged launch
               through the int8 instance (continuous-int8)
  8. continuous-consistency  full width, 2 layers, f32: both engines'
               tokens equal each request's fixed-batch tokens, with COW
  9. train     full width, 8 of 32 layers (TRAIN_LAYERS, printed: since
               the sequence-sharded slice, for the script's time limit;
               16 since the analysis slice):
               repro_torch.launch.train (packed SHiRA, Trainer)
               and MultiAdapterTrainer (3 adapters, f32 then int8
               moments), launch counts > 0 for every kernel of each path,
               and a torch.profiler breakdown of one multi-adapter step
  10. train-consistency  full width, 2 layers, f32: adapter a of the
               multi-adapter trainer tracks Trainer(init a) to 5e-3
  11. train (wm, hook)  full width: launch.train --adapter shira-wm (the
               reference's default mask, packed, all 32 layers), then a
               hook-mode Trainer (shira-wm, packed=False) cut to 12 layers:
               step ms, tokens/s, peak memory, the mask build's seconds,
               masked_update launched 6 times a step; its exported pack's
               %C, and the pack loaded back through SwitchEngine
               (scatter_apply) equal to the trained weights
  12. hook-consistency  full width, 2 layers, f32: hook and packed runs on
               one wm mask give the same losses to 2e-3; grad and snip
               masks from one batch's calibration gradients train, and
               their exported packs load
  13. personalization  full width, 8 of 32 layers (for the time
               limit): three f32 packs published as
               adapter_i@1 into an AdapterStore (resident budget one pack,
               pinned staging two), the continuous trace's first 12
               requests, adapter_0@2 published after step 10, the other
               12; ServingEngine and PagedServingEngine with a FusedLRU and
               slot_pad=4, async_prefetch off and on, traced: tok/s, cold
               and hot TTFT, decode-only step ms with and without a build
               in flight, the pipeline's span ms by thread, async build
               counters, the un-fuse of adapter_0@1, peak memory and
               pinned staging; the hot swap's invariants are held
  14. personalization-consistency  full width, 2 layers, f32: each
               request through the swap equals a run of the same engine
               that saw only its version, both engines, both modes
  15. analysis  the port's analysis modules on the card: (a) the profile
               phase's three steps (base and multi-tenant decode, the
               1024-token prefill) through analysis.profile.program_cost
               (each kernel at its wrapper's cost()) and
               roofline.roofline_terms at the card's HW: compute, memory,
               bound_ms, the dominant term beside the step's device and
               wall ms (a bound over SHARE_MAX of the device time fails);
               (b) replay.join_costs of a traced full-width base-decode
               lane run against the base step's cost (measured/model);
               (c) the personalization traces replayed: the port's spans
               cover >= 0.90 of every run's wall less the harness's own
               spans, realized overlap >= 0.5 of each async run
               against its sync run, critical path, a what-if; (d)
               sidedelta's two paths timed at the classes the serve and
               continuous phases planned (observe()), starcoder2-7b's
               full-width w_up and w_down ones and a 2-layer f32 serve's,
               the winners saved under build/ and installed, that serve's
               tokens unchanged with the cache hit, the cache cleared
  16. slo-chaos  full width, 16 of 32 layers (SLO_LAYERS, printed: since
               the distributed slice, for the script's time limit; its 30
               s of arrivals a pass are fixed, the rest is depth): the
               reference's slo_load.py --chaos on
               PagedServingEngine (async prefetch): LoadGen traffic (seed
               0, Zipf over 4 f32 packs, 2 of them cold, an overload
               phase), a fault-free pass and a chaos pass under a seeded
               FaultPlan whose load-side kinds each fire at their first
               draw in the pass; latency, TTFT, goodput, the injector's
               counts, health(); every future terminal and typed, every
               kind fired, one poisoned slot, nothing pinned, <= 72 GB
  17. faults-consistency  full width, 2 layers, f32: a poisoned slot's
               survivors, a degrade to name@v-1, crash recovery after a
               SimulatedPreemption (both engines), and int8 pages' first
               tokens equal their fault-free or unquantized runs
  18. train (kinds)  full width, through repro_torch.launch.train at the
               train phase's shapes: --adapter lora, dora, shira-dora (32
               layers) and none (full finetuning, cut to the deepest stack
               that fits, its arithmetic printed): step ms, tokens/s, peak
               memory, first and last loss, launches (sparse_adamw_blocks
               on every kind, scatter_apply on shira-dora), %C of the
               effective weights layer by layer (shira-dora < 0.05, lora
               above 5x the packed SHiRA run's)
  19. switch (LoRA vs SHiRA)  full width, 32 layers, six target leaves:
               LoraEngine fuse and unfuse at rank 64 beside SwitchEngine
               load and unload of a 138.9M-entry pack, median of 5 each,
               the fuse's bound, the base restored within 1e-5, and the
               fuse's peak (no stacked delta)
  20. train (checkpoint, preemption)  full width, 16 of 32 layers (for
               the time limit), packed shira-wm: a clean
               6-step fit and one preempted at step 3 (one restore, from
               step 2; last loss within 1e-6; steps [4, 6] committed), a
               fresh Trainer resuming at 6, the state's device-to-host
               copy, save and restore (seconds, bytes), and the trainers'
               publish snapshots read back from the checkpoint
  21. kinds-consistency  full width, 1 layer, f32: lora, dora and
               shira-dora losses on the card track the CPU Trainer to 5e-3
               over CPU_STEPS = 2 steps (3 before the analysis slice, for
               the script's time limit, as in 23, 25, 27, 29, 31 and 32);
               hook mode with weight decay 0.01: the decayed weights within
               1e-6 of the largest weight of the CPU run's, the masked
               ones as train-consistency holds trained values
  22. moe serve, moe profile, moe continuous, moe train
               granite-moe-1b-a400m at full width, cut to 6 of its 24
               layers (MOE_LAYERS, printed: since the sequence-sharded
               slice, 8 since the analysis slice, 12 since the hybrid
               slice, for the script's time limit)
               through phases 4, 5, 7 and 9's
               code: launch.serve in four
               modes (no routing choice dropped: every call is under 512
               tokens), a decode step (base and multi-tenant) and a
               1024-token prefill under torch.profiler with the MoE time
               split into routing, experts and their weight casts, and the
               rest (moe_ranges), the 24-request trace through both
               engines (bf16 and int8 pages; dropped choices counted),
               launch.train and MultiAdapterTrainer (f32, int8 moments;
               the aux and the dropped choices a step)
  23. moe-consistency  full width, 2 layers, f32: multi-tenant tokens
               equal the switch-per-request reference, both engines the
               fixed batch (a 501-token prompt: drop-free calls), and
               Trainer and MultiAdapterTrainer track the CPU run to 5e-3
  24. mla serve, mla profile, mla continuous, mla train
               deepseek-v2-lite-16b (MLA attention, 64 experts top-6, 2
               shared, a first dense layer) at full width, at the depths
               mla_depth prints (all 27 layers where its arithmetic fits
               MLA_BUDGET), cut to at most 4 (MLA_LAYERS, printed: since
               the sequence-sharded slice, for the script's time limit; 6
               since the distributed slice, 8 since the vision and audio
               slice, 14 since the hybrid slice), through
               the same code as 22: launch.serve in
               four modes, a decode step (base, multi-tenant) and a
               1024-token prefill under torch.profiler with MLA's
               attention split out (mla_ranges: the q_eff and w_uv
               products, scores and softmax, the latent cache write), the
               24-request trace through both engines on bf16 and int8
               latent pages (resident requests per GB beside the other
               archs'), both trainers; sidedelta, scatter_apply and
               sparse_adamw launch, and no attention kernel: MLA's
               attention is plain torch, as the reference's is jnp
  25. mla-consistency  full width, 2 layers, f32: as 23, and the int8
               latent pages' tokens equal the same engine's on the CPU
  26. mamba serve, mamba profile, mamba continuous, mamba train
               mamba2-780m (Mamba2 / SSD, attention-free) at full width,
               cut to 16 of its 48 layers (MAMBA_LAYERS, printed: since
               the sequence-sharded slice, for the script's time limit;
               24 since the vision and audio slice),
               its arithmetic printed first
               ([mamba]: parameters, three adapters at 2% of out_proj,
               the lanes' state), through the same code as 22: launch.serve
               in four modes (a switch's ms beside its bound on the
               (48, 3072, 1536) out_proj leaf), a decode step (base,
               multi-tenant) and a 1024-token prefill under torch.profiler
               with the mixer split out (mamba_ranges: projections, conv,
               the SSD's intra-chunk product, chunk states and recurrence,
               inter-chunk output, gated norm + out_proj, decode's state
               update) and the prefill's peak memory, the 24-request trace
               on the lanes (resident requests per GB of state beside the
               other archs' KV figures), both trainers; sidedelta,
               scatter_apply, sparse_adamw and sidedelta_dvals launch, and
               no attention kernel; PagedServingEngine must refuse the
               family with the reference's NotImplementedError
  27. mamba-consistency  full width, 2 layers, f32: multi-tenant tokens
               equal switch-per-request, the lanes the fixed batch (with
               prompts of 1 and 2 tokens, shorter than the conv window),
               and both trainers track the CPU run to 5e-3
  28. zamba serve, zamba profile, zamba continuous, zamba train
               zamba2-2.7b (the hybrid: 9 groups of 6 Mamba2 layers, each
               followed by one shared attention + MLP block of 32 heads of
               80, fed concat(hidden, embedding) through w_fuse) at full
               width, cut to 18 of its 54 layers, 3 of the 9 groups
               (ZAMBA_LAYERS, printed: since the sequence-sharded slice,
               for the script's time limit; 24 since the distributed
               slice, 30 since the vision and audio slice), its
               arithmetic printed first
               ([zamba]: parameters, three adapters at 2% of out_proj and
               of the shared block's seven target leaves, a lane's state
               and KV), through the same code as 22: launch.serve in four
               modes (a switch's ms beside its bound), a decode step (base,
               multi-tenant) and a 1024-token prefill under torch.profiler
               with the mixers split out (mamba_ranges) and the shared
               block (hybrid_ranges: w_fuse, its attention and the flash
               kernels within it, its MLP), flash_decode launched once at
               each of the 5 sites a decode step and flash_prefill once
               at each a prefill, the 24-request trace on the lanes
               (resident requests per GB of state and KV), both trainers;
               sidedelta, scatter_apply, sparse_adamw, sidedelta_dvals,
               flash_decode and flash_prefill launch (the D = 80
               instances), flash_decode_paged never; PagedServingEngine
               must refuse the family with the reference's
               NotImplementedError
  29. zamba-consistency  full width, 2 groups (12 layers), f32:
               multi-tenant tokens equal switch-per-request, the lanes the
               fixed batch (prompts of 1 and 2 tokens included), and both
               trainers track the CPU run to 5e-3
  30. vlm serve, vlm profile, vlm continuous, vlm train
               paligemma-3b (18 layers of 8 query heads of 256 over one KV
               head, gelu, a 257,280-row tied embedding; 256 zero patch
               embeddings before every prompt, a prefix-LM prefix) at full
               width and all 18 layers, its arithmetic printed first
               ([vlm]: parameters, three adapters at 2%, a lane's KV rows
               with the prefix), through the same code as 22: launch.serve
               in four modes (prompts of 16 after the patches; a switch's
               ms beside its bound), a decode step (base, multi-tenant:
               flash_decode once a layer, D = 256) and a batch-1 prefill of
               256 patches + 768 tokens under torch.profiler with the plain
               prefix attention's share (prefix_ranges), the 24-request
               trace on the lanes (1056 + 256 rows each), launch.train at
               8 x 512 (256 patches + 256 tokens); sidedelta,
               scatter_apply, sparse_adamw and flash_decode launch,
               flash_prefill and flash_decode_paged never (the prefix
               prefill is plain chunked_attention); PagedServingEngine and
               MultiAdapterTrainer must refuse the family with the
               reference's NotImplementedError
  31. vlm-consistency  full width, 2 layers, f32: multi-tenant tokens
               equal switch-per-request with seeded patch embeddings (each
               request its own), the lanes the fixed batch, and the Trainer
               tracks the CPU run to 5e-3
  32. audio encode, audio train, audio-consistency
               hubert-xlarge (encoder only: 48 layers of 16 heads of 80,
               bidirectional, gelu, an untied 504-class head; frame
               embeddings in) at full width and all 48 layers, its
               arithmetic printed first ([audio]): lm.encode of 8 x 1024
               frames for the base, after SwitchEngine switches to each of
               three adapters (the switch's ms beside its bound), with all
               three fused and unloaded again (the base within 1e-5), one
               encode under torch.profiler (flash_prefill's share,
               non-causal D = 80, once a layer), launch.serve's exit and
               both engines' refusals with the reference's messages;
               launch.train at 8 x 256 frames and MultiAdapterTrainer's
               refusal; at 2 layers in f32 the card's encode against the
               CPU's (every frame's argmax equal, within 1e-4 of the
               largest logit) and the Trainer against the CPU run
  33. dense     qwen1.5-32b (G 1), deepseek-coder-33b (G 7) and
               granite-34b (G 48) at full width, each cut to the deepest
               stack whose f32 parameters and three adapters' packs and
               tables fit 60 GB (the arithmetic printed): a multi-tenant
               serve, a multi-tenant decode step under torch.profiler, and
               at 2 layers in f32 tokens equal to switch-per-request
  34. distributed  the launch modules on torch.distributed: (a) world
               size 1 through NCCL on a (1, 1) mesh, starcoder2-7b at full
               width and DIST_LAYERS = 4 (printed): the packed SHiRA step
               on shard-local indices split from a rand pack at 0.99 for 3
               steps, its f32 losses within 1e-5 of
               make_shira_train_step(mesh=None), the prefill and decode
               steps' tokens equal the unsharded ones', scatter_apply,
               flash_prefill and flash_decode launched on that path, and
               granite-moe's moe_ffn under "moe_ep_mesh" equal to the dense
               dispatch on a drop-free call; (b) four ranks on cuda:0
               through gloo (NCCL refuses two ranks on one device), a
               (2, 2) mesh, spawned here, each loading the build phase's
               kernels: gloo's all_reduce, all_gather and reduce_scatter
               probed on CUDA tensors, then for starcoder2-7b and
               granite-moe (EP over 2) at full width and 2 layers the
               packed SHiRA step and the full-finetune step with fsdp=True,
               2 steps each, their f32 cross-entropies within 1e-4 of one
               rank's on the same batches, decode logits on local heads
               within the bf16 attention tolerance (starcoder2-7b) or
               f32's (granite-moe), each rank's collective bytes, one TP
               block's equal to the count by hand, the step's wall beside
               its device time; granite-moe in bf16: the expert-parallel
               moe_ffn within 0.05 of the dense dispatch on each rank,
               and, on a DIST_MOE_PROMPT = 32-token prompt, every route
               that differs from one rank's on a one-rank margin below
               bf16's rounding of its router product, the logits within
               2e of one rank's at every step no flipped route reaches (e
               one rank's own bf16 error against the f32 model); then, on
               the same ranks, sequence-sharded serving (SEQ_CASES, full
               width, SEQ_LAYERS = 2): starcoder2-7b on (4, 1), batch 1,
               a 32,768-row cache (8,192 a rank), prompts of 25,000 and
               1,000 tokens, and granite-34b on (1, 4), batch 2, 16,384
               rows, 10,000 tokens (q gathered over ``model``), 8 decode
               steps each: f32 greedy tokens equal one rank's unsharded
               run's and logits within 1e-4, bf16 logits fed one rank's
               tokens within ATTN_TOL["bf16"] x max(1, max |logit|), each
               rank's collective bytes for a decode step, its wall beside
               its device time, flash_decode's log-sum-exp instance
               launched (its counts zeroed just before these cases);
               then the last five families' TP forward (A11_CASES, full
               width: deepseek-v2-lite at 2 layers, mamba2-780m at 2,
               zamba2-2.7b at 6, paligemma-3b at 2 with its 256-row
               prefix, hubert-xlarge at 2), each family's counts zeroed
               just before it: the packed SHiRA step on (2, 2), A11_STEPS
               = 2 steps (deepseek's base FSDP-sharded), f32 ce within
               A11_TOL = 1e-4 of one rank's (two microbatches, the data
               shards); prefill + 8 decode steps on (1, 4) (hubert's
               encode), f32 greedy tokens equal one rank's and logits
               within 1e-4, each rank's collective bytes for one decode
               step; zamba2 also at batch 1 on (4, 1); launched:
               scatter_apply in every SHiRA step, flash_decode's
               log-sum-exp instance at D = 256 (paligemma) and D = 80
               (zamba2), flash_prefill at D = 80 (zamba2's shared block,
               hubert's non-causal encode); no attention kernel on MLA or
               Mamba2. Cut for the script's time limit (each printed):
               the fsdp full-finetune step of starcoder2-7b and
               granite-moe to DIST4_FSDP_STEPS = 1 step;
               (c) the dry run (launch.dryrun, one CPU process a group,
               after (b)): starcoder2-7b and granite-moe
               train_4k on the 16 x 16 and 2 x 16 x 16 meshes, --adapter
               none and shira, starcoder2-7b's decode_32k and
               prefill_32k on 16 x 16 (DIST_SEQ_CELLS), and one cell a
               family of the last five on 16 x 16 (DIST_A11_CELLS):
               deepseek-v2-lite and paligemma-3b decode_32k, mamba2-780m
               and zamba2-2.7b long_500k, hubert-xlarge prefill_32k: GB,
               TFLOP and collective GB a rank
  35. summary   one JSON line of kernel numbers (the D = 80 instances of
               flash_decode and flash_prefill, flash_decode's D = 256
               instance, its log-sum-exp instance at D = 64/128, at
               D = 256 and at D = 80, and flash_prefill's non-causal
               D = 80 case on rows of their own), the card line, and
               last
               {"ok": true, "device": {...}}, after "[time] total"

Every engine run with no fault injected (phases 7, 8, 13, 14, the
fault-free slo-chaos pass and the reference runs of 17) must serve every
request as asked: the engines walk
the fallback ladder by default, so none may be degraded, shed, poisoned
or failed, no load retried and nothing quarantined (hold_as_asked).

The kernels phase also holds sidedelta at deepseek-v2-lite-16b's widths
(wq 2048x3072, w_dkv 2048x576, layer 0's MLP 2048x10944 and 10944x2048,
the shared experts' 2048x2816; S = 1 and 256, f32 and int8 tables) and
scatter_apply bit for bit at its (26, 2048, 3072) and (26, 512, 2048)
leaves, and sidedelta at mamba2-780m's out_proj (3072x1536; S = 1, 16
and 256, f32 and int8 tables) with scatter_apply bit for bit at its
(48, 3072, 1536) leaf; a phase of its own, kernels (mamba widths), times
scatter_apply there and sparse_adamw (blocks over the Trainer's (48 k,)
vector, rows over the multi-adapter trainer's (144, k) f32 rows) beside
their plain versions, a library call and their bounds, and the training
kernels' phase adds a dvals case at out_proj's width. A phase of its
own, kernels (zamba widths), holds sidedelta at zamba2-2.7b's out_proj
(5120x2560) and the shared block's w_up (2560x10240) widths and
scatter_apply bit for bit on its (9, 6, 5120, 2560) out_proj stack (two
leading dims; timed beside its bound) and the shared (2560, 10240) w_up.
The attention phase holds the D = 80 instances that zamba2's shared
block takes (decode (8, 32, 1, 80) at S = 1056, (B,) and scalar kv_len;
causal prefills (1, 1024), (1, 777) and (8, 16) of 32 heads), the
D = 256 instances paligemma-3b's decode takes ((8, 1, 8, 256) at S =
1312, the lanes' rows with the prefix, (B,) and scalar kv_len) and the
non-causal prefills of hubert-xlarge's encode ((8, 1024) and (1, 777) of
16 heads of 80), and flash_decode_paged must refuse D = 80 and D = 256
on the card. starcoder2-7b's one request at 32k runs unsharded through
the existing flash_decode instance and through flash_decode_paged over
2,048 pages of 16, and every decode case prints its plan's splits a
request (nsplit). It prints every flash_decode instance's registers and
spills, and flash_prefill's, and fails if a flash_decode instance or a
D = 80 flash_prefill instance spills. It also holds masked_update (the dense-mask apply of hook
mode) against its plain version, bit for bit, at the stacked (32, 4608,
18432) w_up leaf with a 1% mask: f32 W with a bool mask, bf16 W with a
bool mask, f32 W with an f32 mask, beside Tensor.addcmul_. Its
sparse_adamw part prints each kernel instance's registers and spills
(fatal on a spill), holds every case at inputs where the check would see
an output zeroed or permuted within a vector, prints the achieved TB/s
and share of the bound of every timed case, checks rows
of K = 3 and 13 in every moment type and views one element past their
start (the one-element instance, which must count an unaligned launch),
and times qstate.encode's int8 re-encode beside the int8 update; the
train phase fails if any update there took the one-element instance.
scatter_apply is held bit for bit against its plain version on a padded
fused pack, on (37, 96, 160) with k = 307 and (70001, 8, 8) with k = 3
(layer boundaries inside a block, more layers than a grid dimension
holds), and on the (32, 4608, 18432) leaf with ascending and shuffled
indices; its bound counts the 32-byte sectors of W its entries touch
(scatter_apply.sector_bytes). A pack with repeated indices (ROADMAP C3) loads
through apply_pack within one ulp of its plain version's sum, and a
second process shows the kernel's assertion on an unmerged row; the
merged-form check is timed on the leaf. The train phases publish the
trained packs into a store and read them back equal. The dvals kernel is
timed alone on grouped token-minor
inputs beside the wrapper as the backward calls it and the whole
wrapper, and held within 1e-4 at S = 250 (the one-token instance, which
must count an unaligned launch) and with an adapter that has no tokens;
the train phase fails if a multi-adapter step took the one-token
instance. The scatter_apply, sidedelta_grad and sparse_adamw parts print
each kernel instance's registers and spills and fail on a spill.
"""
from __future__ import annotations

import contextlib
import json
import re
import statistics
import subprocess
import sys
import time
from concurrent import futures
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ATTN_TOL = {"bf16": 1e-2,      # 2.5x the largest bf16 error measured on the
            "f32": 1e-5}       # card (3.9e-3, one bf16 ulp near 1)
SIDEDELTA_TOL = 1e-4           # f32 sums of ~400 products in another order
LSE_TOL = 1e-4                 # flash_decode's log-sum-exp, ~9 at 8,192
                               # rows: f32 sums of up to 8,192 terms in
                               # another order, exp2 against exp
LSE_SHAPES = ((1, 4, 9, 128, 8192),   # (B, KV, G, D, S): starcoder2-7b's
              (2, 1, 48, 128, 4096),  # decode_32k over 4 ranks,
                                      # granite-34b's gathered q (48 heads
                                      # over one KV head) over 4 ranks,
              (8, 8, 2, 64, 2048),    # and granite-moe's decode_32k on
                                      # 16 x 16 (the D = 64 instance: 16
                                      # gathered q heads, 2,048 rows a rank)
              (8, 1, 8, 256, 8192),   # paligemma-3b's decode_32k rows on
                                      # (1, 4), its 8 q heads gathered over
                                      # the one KV head (D = 256);
              (1, 2, 1, 80, 32768),   # zamba2-2.7b's shared block at
                                      # long_500k on 16 x 16 (2 KV heads, a
                                      # 16th of 524,288 rows) and on (4, 1)
              (1, 8, 1, 80, 8192))    # cut (8 KV heads, D = 80)
LONG_CACHE = 32768             # an unsharded request's cache at 32k
RESTORE_TOL = 1e-5             # the JAX package's load/unload tolerance
ADAMW_TOL = 1e-6               # rtol = atol: the JAX package's own, and the
                               # kernel rounds as its plain version does
TRAIN_TOL = 5e-3               # the JAX package's trainer-parity tolerance
GRAD_TOL = 1e-4                # value gradients, of each leaf's largest
B, PROMPT, TOKENS = 8, 16, 16  # serving batch, prompt and generated tokens
CACHE = 1056                   # the lane engine's rows a request: prompts
                               # up to 1024 + 32 generated tokens
CC_REQUESTS, CC_TOKENS = 24, 32   # the continuous-batching trace
CC_LAYERS = 8                  # phase 7's depth since the sequence-
                               # sharded slice, for the script's time
                               # limit (12 since the distributed slice, 16
                               # since the vision and audio slice, 32
                               # before)
CHUNK = 256                    # the paged engine's prefill chunk, and a
                               # training sequence's rows
IDS = [0, 1, 2, -1, 0, 1, 2, 0]
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 256, 8, 4   # launch.train phase
TRAIN_LAYERS = 8               # phase 9's depth since the sequence-
                               # sharded slice, for the script's time
                               # limit (16 since the analysis slice, 32
                               # before)
MT_SEQ, MT_BATCH, MT_STEPS = 256, 2, 3            # per adapter, A = 3
MT_IDS = [0, 0, 1, 1, 2, 2]    # the multi-adapter batch: T_a = 512 tokens
MU_DENSITY = 0.01              # masked_update's mask: 1% of the leaf
HOOK_LAYERS, HOOK_STEPS = 12, 4  # hook mode at full width: 21 B a target
                                # entry, 54.7 GB at 12 of 32 layers
HOOK_TOL = 2e-3                # hook vs packed losses: the JAX package's
                               # own claim (tests/test_training.py)
ROUND_TRIP_TOL = 1e-6          # a loaded pack vs the trained weights, of
                               # the largest weight: base + (W - base)
KV_INT8_MAX = 0.52             # int8 KV bytes of bf16's: (128 + 2) / 256;
                               # MLA's latents (512 + 2 + 64 + 2) / 1152
PEAK_GB_MAX = 72               # slo-chaos: device memory allocated, GB
SLO_LAYERS = 16                # slo-chaos's depth since the distributed
                               # slice, for the script's time limit (32
                               # before)
FACTOR_KINDS = ("lora", "dora", "shira-dora")
KINDS_CPU = ("shira-dora",)   # the factor kinds kinds-consistency holds
                               # against the CPU (all three before the last
                               # five families' TP forward; shira-dora runs
                               # the DoRA magnitude and the LoRA factors
                               # beside the SHiRA mask, and lora and dora
                               # train on the card in train (kinds))
NONE_BYTES = 20                # full finetuning, a parameter: f32 base,
                               # trainable copy, two moments and gradient
NONE_HEADROOM = 8e9            # activations, logits, per-matrix AdamW
                               # outputs, the allocator's slack
SWITCH_RANK, SWITCH_RUNS = 64, 5   # LoRA fuse vs SHiRA switch
CKPT_STEPS, CKPT_PREEMPT = 6, 3    # checkpoint phase: ckpt_every 2, keep 2
CKPT_LAYERS = 8                # its depth: a quarter of starcoder2-7b's
                               # 32, for the script's time limit (16 before
                               # the last five families' TP forward)
RESUME_TOL = 1e-6              # a resumed run's last loss against a clean
                               # run's: the JAX package's own (test_ft.py)
WD_TOL = 1e-6                  # hook mode with weight decay, card vs CPU:
                               # decayed weights, of the largest weight
KINDS_LAYERS = 1               # kinds-consistency's depth: at 2 layers its
                               # CPU side took ~110 s of the script
CPU_STEPS = 2                  # steps of the card-vs-CPU trainer checks
                               # (kinds-consistency's factor kinds and each
                               # slice's Trainer and MultiAdapterTrainer):
                               # 3 before the analysis slice; their CPU
                               # side, ~105 s of the script at 3, is the
                               # part of its time that moves most by host
MOE_ARCH = "granite-moe-1b-a400m"  # the MoE slice: full width, 24 layers
MOE_LAYERS = 6                 # its phases' depth since the sequence-
                               # sharded slice, for the script's time
                               # limit (8 since the analysis slice, 12
                               # since the hybrid slice, 24 before)
MOE_LONG = 501                 # moe-consistency's long prompt: one call of
                               # at most 512 tokens drops no routing choice
MLA_ARCH = "deepseek-v2-lite-16b"  # the MLA slice: full width, 27 layers
MLA_LAYERS = 4                 # its phases' deepest cut since the
                               # sequence-sharded slice (the first dense
                               # layer and 3 MoE), for the script's time
                               # limit (6 since the distributed slice, 8
                               # since the vision and audio slice, 14 since
                               # the hybrid slice, 27 before)
MLA_BUDGET = 76e9              # the device bytes mla_depth plans for, of
                               # the card's 85.0e9: the rest is allocator
                               # slack and the activations it leaves out
MT_ENTRY_BYTES = 40            # a multi-adapter trainer, per 2% entry of
                               # an adapter: index, value, two moments and
                               # gradient (f32) and the trainable table's
                               # rows, perm, t_rows and t_perm (int32)
MAMBA_ARCH = "mamba2-780m"     # the SSM slice: full width, 48 layers
MAMBA_LAYERS = 16              # its phases' depth since the sequence-
                               # sharded slice, for the script's time
                               # limit (24 since the vision and audio
                               # slice, 48 before)
ZAMBA_ARCH = "zamba2-2.7b"     # the hybrid slice: full width, 54 layers
ZAMBA_LAYERS = 18              # its phases' depth since the sequence-
                               # sharded slice: 3 of its 9 groups of 6,
                               # for the script's time limit (24 since the
                               # distributed slice, 30 since the vision
                               # and audio slice, 54 before)
VLM_ARCH = "paligemma-3b"      # the vision slice: full width, all 18 layers
VLM_PREFIX = 256               # its patch embeddings, a prefix of cache rows
AUDIO_ARCH = "hubert-xlarge"   # the audio slice: full width, all 48 layers
ENCODE_FRAMES = 1024           # hubert-xlarge's encode: B x 1024 frames
ENCODE_TOL = 1e-4              # audio-consistency: card against CPU encode
                               # logits, of the largest logit (f32 sums of
                               # 48 layers in another order)
ATTN_KERNELS = ("flash_decode", "flash_decode_paged", "flash_prefill")
RESIDENCY = {}                 # (arch, engine) -> resident requests per GB
A11_LAUNCHES = {}              # arch -> (b)'s launches of its mesh steps
DENSE_ARCHS = ("qwen1.5-32b", "deepseek-coder-33b", "granite-34b")
DENSE_BUDGET = 60e9            # dense configs: f32 parameters, three
                               # adapters' packs and tables, KV
ADAPTER_BYTES = 100            # the three serve adapters, per 2% entry of
                               # a target leaf: their packs (3 x 8 B: int32
                               # index, f32 value) and, at the peak of a
                               # fused transition's table rebuild, the five
                               # slots of the fused state (two diff packs
                               # of ~2 entries, the negated hot pack) beside
                               # the three of the unfused one (8 x 9.5 B:
                               # f32 value, int32 row, column offsets)
MIN_DEPTH = 8                  # no dense config is cut below this


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def timed(label: str, fn, *args):
    """Run one phase and print its seconds on a line of its own."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[time] {label} {time.perf_counter() - t0:.1f}s", flush=True)
    return out


def card_hw():
    """The card's published peaks (H100 SXM, 700 W): the port's
    ``analysis.roofline.HW``."""
    from repro_torch.analysis.roofline import HW
    return HW()


def bound(nbytes: float, flops: float, bf16_flops: float = 0) -> dict:
    """The least time the card could take: bytes over the memory rate or
    the operations over the peak rate of their operands' type, whichever
    is larger. ``flops`` have an f32 operand (non-tensor-core rate);
    ``bf16_flops`` are products of two bf16 operands summed in f32, which
    the tensor cores compute exactly."""
    hw = card_hw()
    b_ms = nbytes / hw.hbm_bw * 1e3
    o_ms = (flops / hw.f32_flops + bf16_flops / hw.peak_flops) * 1e3
    return {"bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations"}


def bound_of(cost: dict) -> dict:
    """``bound`` of a kernel wrapper's ``cost()``."""
    return bound(cost["bytes_accessed"], cost["flops"], cost["bf16_flops"])


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """name<template arguments> of a kernel from its mangled name, whose
    identifier is the one ending in "_kernel" after its length."""
    end = mangled.find("_kernel") + len("_kernel")
    for i in range(end - 1, -1, -1):
        m = re.match(r"\d+", mangled[i:end])
        if m and int(m.group()) == end - i - len(m.group()):
            args = re.match(r"I(\w*?)EE", mangled[end:])
            return (mangled[i + len(m.group()):end]
                    + (f"<{args.group(1)}>" if args else ""))
    return mangled[:48]


def cold_ms(torch, fn, iters: int, flush) -> float:
    """Mean device time of fn over ``iters`` launches (``cold_times``)."""
    return statistics.fmean(cold_times(torch, fn, iters, flush))


def cold_times(torch, fn, iters: int, flush) -> list:
    """Device ms of each of ``iters`` launches of fn, L2 flushed before
    each (a decode step streams other weights between two calls). The card
    spins ~1 ms before each start event, so the host has enqueued fn's
    launches by the time it is timed: host overhead is not counted unless
    fn waits for the device itself."""
    fn()
    events = []
    for _ in range(iters):
        flush()
        torch.cuda._sleep(2_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events]


def device_kernels(torch, prof):
    """(device ms, launches, name) of each kernel a torch.profiler run saw
    (not the device side of the ``moe_ranges``/``mla_ranges``/
    ``mamba_ranges``/``hybrid_ranges``/``prefix_ranges`` annotations)."""
    cuda = torch.autograd.DeviceType.CUDA
    ranges = (MOE_RANGES + MLA_RANGES + MAMBA_RANGES + HYBRID_RANGES
              + PREFIX_RANGES)
    return [(getattr(e, "self_device_time_total", 0) / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == cuda and e.key not in ranges]


def kernel_share(label, kern) -> None:
    """Print the device ms, launches and share of the port's attention and
    sidedelta kernels among the profiled kernels ``kern``."""
    busy = sum(k[0] for k in kern)
    for ms, n, name in sorted(kern, reverse=True):
        if ("flash_" in name or "sidedelta" in name) and busy:
            print(f"[profile]   {label}: {ms:.3f} ms x{n} ({ms / busy:.1%} of "
                  f"device time) {name[:70]}", flush=True)


def rand_entries(torch, gen, nl, n, m, k):
    """nl rows of k unique ascending flat indices, as a rand mask's pack
    holds them, and their values."""
    idx = torch.stack([torch.randperm(n * m, generator=gen, device="cuda")[:k]
                       .sort().values for _ in range(nl)]).to(torch.int32)
    vals = 0.01 * torch.randn((nl, k), generator=gen, device="cuda")
    return idx, vals


def repeat_entries(torch, gen, nl, n, m):
    """The entries of ROADMAP C3's case: each of nl rows holds 1% of its
    (n, m) matrix's indices ascending, then every tenth entry takes an
    index already in its row, alternately that of the entry just before it
    and of the one five before; row 0 begins with index 0 and takes it
    again, with a nonzero value, just before the padding (index 0, value
    0) that ends every row."""
    k = n * m // 100
    idx, vals = rand_entries(torch, gen, nl, n, m, k)
    pos = torch.arange(9, k, 10, device=idx.device)
    odd = torch.arange(pos.numel(), device=idx.device) % 2 == 1
    idx[:, pos] = idx[:, torch.where(odd, pos - 5, pos - 1)]
    idx[0, 0] = 0
    tail_i = torch.zeros((nl, 4), dtype=torch.int32, device=idx.device)
    tail_v = torch.zeros((nl, 4), device=idx.device)
    tail_v[0, 0] = 0.5
    return torch.cat([idx, tail_i], 1), torch.cat([vals, tail_v], 1)


def ulp_tol(torch, want) -> float:
    """One ulp of the largest |want|: the tolerance of a merged pack's
    load, whose kernel adds W + (a + b) where the plain version adds
    (W + a) + b."""
    mx = want.abs().max()
    return float(torch.nextafter(mx, torch.tensor(float("inf"),
                                                  device=mx.device)) - mx)


def repeat_case(torch, gen, apply, label):
    """C3 on a (4, 4608, 18432) f32 slice of w_up: ``apply(w, idx, vals)``
    loads the repeat pack (``repeat_entries``); held against
    scatter_apply_plain of the same entries, which sums the repeats, to
    one ulp of the largest result. Returns (max_abs_err, tol, entries,
    repeats)."""
    from repro_torch.kernels.scatter_apply import scatter_apply_plain
    d, f = 4608, 18432
    w = torch.randn((4, d, f), generator=gen, device="cuda")
    ri, rv = repeat_entries(torch, gen, 4, d, f)
    want = scatter_apply_plain(w.clone(), ri, rv, 1.0)
    apply(w, ri, rv)
    torch.cuda.synchronize()
    err, tol = float((w - want).abs().max()), ulp_tol(torch, want)
    repeats = 4 * len(range(9, d * f // 100, 10)) + 1
    print(f"[kernels] scatter_apply repeated indices ({label}): "
          f"{ri.numel()} entries, {repeats} repeats: max_abs_err={err:.3g} "
          f"(tol {tol:.3g}, one ulp of the largest result)", flush=True)
    return err, tol, ri.numel(), repeats


def assert_probe():
    """Start a process that hands scatter_apply's kernel a row with a
    repeated index; ``check_assert_probe`` holds it to the kernel's
    assertion."""
    code = ("import sys, torch; sys.path.insert(0, 'src')\n"
            "from repro_torch.kernels.scatter_apply import scatter_apply\n"
            "w = torch.zeros((1, 64, 64), device='cuda')\n"
            "i = torch.tensor([[3, 7, 7]], dtype=torch.int32, device='cuda')\n"
            "scatter_apply(w, i, torch.ones((1, 3), device='cuda'))\n"
            "try:\n"
            "    torch.cuda.synchronize()\n"
            "except RuntimeError as e:\n"
            "    print('raised:', str(e).splitlines()[0])\n"
            "    sys.exit(3)\n")
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def check_assert_probe(proc) -> None:
    out, _ = proc.communicate(timeout=300)
    said = [ln for ln in out.splitlines() if "raised:" in ln
            or "Assertion" in ln]
    print(f"[kernels] scatter_apply on an unmerged row (another process): "
          f"exit {proc.returncode}; {said[-2:]}", flush=True)
    if proc.returncode != 3 or not any("assert" in ln.lower()
                                       for ln in said):
        fail("scatter_apply's kernel did not assert on an unmerged row:\n"
             + out[-2000:])


def stage_leaves(torch, cfg):
    """Per stage of ``cfg``: (layers, {path: (n, m)} of one layer's
    matrices, one layer's parameters), and the parameters outside the
    stages (a hybrid model's shared block among them), from a model of one
    layer a stage on the card (a hybrid stage: one group of one layer)."""
    import dataclasses
    from repro_torch.core.masks import iter_leaves
    from repro_torch.models import lm
    plan = lm.stage_plan(cfg)
    cut = cfg.replace(num_layers=len(plan))
    lead = 1                        # stacked dims in front of a layer
    if cfg.family == "moe" and cfg.moe.first_dense_layers:
        cut = cut.replace(moe=dataclasses.replace(cfg.moe,
                                                  first_dense_layers=1))
    if cfg.family == "hybrid":
        cut, lead = cut.replace(hybrid_attn_every=1), 2
    one = lm.init_params(cut, seed=0, device="cuda")
    stages = [(n, {p: tuple(x.shape[-2:]) for p, x in iter_leaves(sp)
                   if x.ndim >= lead + 2},
               sum(x[(0,) * lead].numel() for _, x in iter_leaves(sp)))
              for (_, n), sp in zip(plan, one["stages"])]
    rest = (sum(x.numel() for _, x in iter_leaves(one))
            - sum(x.numel() for _, x in iter_leaves(one["stages"])))
    del one
    torch.cuda.empty_cache()
    return stages, rest


def default_targets(mats):
    """The (n, m) of each matrix of ``mats`` ({path: (n, m)}) that the
    default AdapterConfig targets."""
    from repro_torch.configs import AdapterConfig
    from repro_torch.core.masks import leaf_name
    targets = AdapterConfig().target_modules
    return [nm for p, nm in mats.items() if leaf_name(p) in targets]


def shared_targets(cfg):
    """(path, (n, m)) of the default targets of a hybrid model's shared
    block (zamba2): wq, wk, wv, wo, w_up, w_gate, w_down, one unstacked
    matrix each, which one entry set adapts at every site; w_fuse is no
    target."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    return [("shared_attn/attn/wq", (d, q)), ("shared_attn/attn/wk", (d, kv)),
            ("shared_attn/attn/wv", (d, kv)), ("shared_attn/attn/wo", (q, d)),
            ("shared_attn/mlp/w_up", (d, f)),
            ("shared_attn/mlp/w_gate", (d, f)),
            ("shared_attn/mlp/w_down", (f, d))]


def switch_bound(torch, cfg):
    """(bound, entries, sectors) of one whole adapter load as the serve
    phase's packs make it: every adapted leaf of ``cfg`` (the default
    targets: wq, wk, wv, wo, w_up, w_gate, w_down, MLA's w_dkv, w_uk and
    w_uv, Mamba2's out_proj, each stacked over its stage's layers; an MoE
    model's experts are no target, its shared experts are; a hybrid
    model's shared block's seven, once each) at sparsity 0.98, the
    sectors counted from a draw of the same masks."""
    from repro_torch.core.masks import budget
    from repro_torch.kernels.scatter_apply import sector_bytes
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    nbytes = sectors = entries = 0
    stages, _ = stage_leaves(torch, cfg)
    leaves = [(L, n, m) for L, mats, _ in stages
              for n, m in default_targets(mats)]
    if cfg.family == "hybrid":
        leaves += [(1, n, m) for _, (n, m) in shared_targets(cfg)]
    for L, n, m in leaves:
        idx, vals = rand_entries(torch, gen, L, n, m, budget(n, m, 0.98))
        b, s = sector_bytes(torch.empty((L, n, m), device="meta"), idx,
                            vals)
        nbytes, sectors = nbytes + b, sectors + s
        entries += idx.numel()
        del idx, vals
    return bound(nbytes, 0), entries, sectors


def sidedelta_case(torch, gen, flush, label, n, m, S, int8, slots=None,
                   pad_to=0):
    """One sidedelta comparison at (n, m) on layer 0 of ``slots`` (three
    random single-layer adapters by default), its rows/vals padded with
    zeros to ``pad_to`` entries when given; returns its numbers."""
    import torch.nn.functional as F
    from repro_torch.core.masks import budget
    from repro_torch.kernels import ops
    from repro_torch.kernels.sidedelta import (kernel_path, sidedelta,
                                               sidedelta_cost,
                                               sidedelta_plain)
    if slots is None:
        slots = [rand_entries(torch, gen, 1, n, m, budget(n, m, 0.98))
                 for _ in range(3)]
    nl = slots[0][0].shape[0]
    t = {k: v[0].contiguous() for k, v in ops.sidedelta_table(
        slots, nl, n, m, int8=int8).items()}
    for k in ("rows", "vals"):
        t[k] = F.pad(t[k], (0, max(pad_to - t[k].shape[-1], 0)))
    x = torch.randn((B, S, n), generator=gen, device="cuda").to(
        torch.bfloat16)
    ids = torch.tensor(IDS, dtype=torch.int32, device="cuda")
    args = (x, t["rows"], t["vals"], t["colptr"], ids, t.get("scale"))
    got = sidedelta(*args)
    want = sidedelta_plain(*args)
    err = float((got - want).abs().max())
    if not err <= SIDEDELTA_TOL:
        fail(f"sidedelta {label}: max_abs_err {err} > {SIDEDELTA_TOL}")
    times = cold_times(torch, lambda: sidedelta(*args), 20, flush)
    ms = statistics.fmean(times)
    plain_ms = cold_ms(torch, lambda: sidedelta_plain(*args), 3, flush)
    # yardstick: one batched matmul against densified per-request dW
    valid = t["colptr"][:, -1].long()
    dense = torch.zeros((len(slots) + 1, n * m), device="cuda")
    for a in range(len(slots)):
        col = torch.repeat_interleave(
            torch.arange(m, device="cuda"),
            torch.diff(t["colptr"][a].long()))
        v = t["vals"][a, :valid[a]].float()
        if int8:
            v = v * t["scale"][a]
        dense[a].index_put_((t["rows"][a, :valid[a]].long() * m + col,), v,
                            accumulate=True)
    per_req = dense.reshape(-1, n, m)[torch.tensor(
        [a if a >= 0 else len(slots) for a in IDS], device="cuda")]
    xf = x.float()
    library_ms = cold_ms(torch, lambda: torch.bmm(xf, per_req), 5, flush)
    del dense, per_req
    r = {"label": label, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
         "library_ms": library_ms, **bound_of(sidedelta_cost(*args)),
         "K": [int(valid[a]) for a in range(len(slots))], "times": times}
    print(f"[kernels] sidedelta {label} ({n}x{m}) K={r['K']} S={S} "
          f"{'int8/int16' if int8 else 'f32/int32'} "
          f"path={kernel_path(B, S)}: "
          f"max_abs_err={err:.3g} "
          f"(tol {SIDEDELTA_TOL}) ms={ms:.4f} plain_ms={plain_ms:.3f} "
          f"library_ms(bmm, dense dW)={library_ms:.3f} "
          f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
    return r


def sidedelta_crossover(torch, gen, flush, n, m):
    """Where the token-minor path starts to pay, which sets the wrapper's
    rule (kernel_path): at the w_up shape, the serving batch's adapters at
    S = 2..32 and one adapter's single request at S = 4..32, each through
    both paths' launches on the same inputs. Prints both times and the
    path the rule takes; the paths' results must agree."""
    from repro_torch.core.masks import budget
    from repro_torch.kernels import ops
    from repro_torch.kernels.sidedelta import (_launch_rows, _launch_tokens,
                                               kernel_path)
    slots = [rand_entries(torch, gen, 1, n, m, budget(n, m, 0.98))
             for _ in range(3)]
    t = {k: v[0].contiguous() for k, v in ops.sidedelta_table(
        slots, 1, n, m).items()}
    tab = (t["rows"], t["vals"], t["colptr"])
    ids = torch.tensor(IDS, dtype=torch.int32, device="cuda")
    for Bx, S in [(B, s) for s in (2, 4, 8, 16, 32)] + [
            (1, s) for s in (4, 8, 16, 32)]:
        x = torch.randn((Bx, S, n), generator=gen, device="cuda").to(
            torch.bfloat16)
        xi = ids[:Bx]
        err = float((_launch_tokens(x, *tab, xi) - _launch_rows(x, *tab, xi))
                    .abs().max())
        if not err <= SIDEDELTA_TOL:
            fail(f"sidedelta crossover B={Bx} S={S}: the paths differ by "
                 f"{err}")
        tok = cold_ms(torch, lambda: _launch_tokens(x, *tab, xi), 20, flush)
        row = cold_ms(torch, lambda: _launch_rows(x, *tab, xi), 20, flush)
        print(f"[kernels] sidedelta crossover w_up B={Bx} S={S} "
              f"({len(set(xi.tolist()) - {-1})} adapters): tokens "
              f"{tok:.4f} ms, rows {row:.4f} ms, paths differ by "
              f"{err:.3g}; the rule takes {kernel_path(Bx, S)}", flush=True)


def kernels_phase(torch, flush):
    from repro_torch.core.adapters import AdapterPack
    from repro_torch.core.masks import budget
    from repro_torch.core.fusion import fuse_packs
    from repro_torch.kernels.scatter_apply import (scatter_apply,
                                                   scatter_apply_plain)
    d, f = 4608, 18432
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    side = []
    for n, m, name in ((d, f, "w_up"), (d, d, "wq"), (d, 512, "wk"),
                       (f, d, "w_down")):
        for S in (1, PROMPT) + ((CHUNK,) if m == f or n == f else ()):
            for int8 in (False, True):
                side.append(sidedelta_case(torch, gen, flush, name, n, m,
                                           S, int8))
        torch.cuda.empty_cache()
    # granite-moe-1b-a400m's attention leaves (its adapters' targets):
    # wq (1024, 1024) and wk (1024, 512), decode and a paged chunk
    for n, m, name in ((1024, 1024, "granite-moe wq"),
                       (1024, 512, "granite-moe wk")):
        for S in (1, CHUNK):
            for int8 in (False, True):
                side.append(sidedelta_case(torch, gen, flush, name, n, m,
                                           S, int8))
    # deepseek-v2-lite-16b's multi-tenant targets: wq, w_dkv, layer 0's
    # MLP, the shared experts (flattened tokens, the same call)
    for n, m, name in ((2048, 3072, "deepseek wq"),
                       (2048, 576, "deepseek w_dkv"),
                       (2048, 10944, "deepseek layer-0 w_up"),
                       (10944, 2048, "deepseek layer-0 w_down"),
                       (2048, 2816, "deepseek shared w_up")):
        for S in (1, CHUNK):
            for int8 in (False, True):
                side.append(sidedelta_case(torch, gen, flush, name, n, m,
                                           S, int8))
        torch.cuda.empty_cache()
    # mamba2-780m's one multi-tenant target: out_proj (3072, 1536), decode,
    # a serve prompt and a training sequence's chunk
    for S in (1, PROMPT, CHUNK):
        for int8 in (False, True):
            side.append(sidedelta_case(torch, gen, flush, "mamba out_proj",
                                       3072, 1536, S, int8))
    torch.cuda.empty_cache()
    sidedelta_crossover(torch, gen, flush, d, f)
    # the fused state of two stacked w_up layers, as MultiTenantEngine
    # builds it with adapter_0 hot: diff packs (whose shorter layer is
    # padded with index 0, value 0) and slot padding past each valid count
    k = budget(d, f, 0.98)
    packs = [AdapterPack(f"a{i}", {"w": rand_entries(torch, gen, 2, d, f, k)})
             for i in range(3)]
    fused = [fuse_packs([packs[1], packs[0]], [1.0, -1.0]),
             fuse_packs([packs[2], packs[0]], [1.0, -1.0]),
             fuse_packs([packs[0]], [-1.0])]
    slots = [p.entries["w"] for p in fused]
    pad = max(s[0].shape[-1] for s in slots)
    for S in (1, PROMPT, CHUNK):     # the decode and token-minor paths
        tight = sidedelta_case(torch, gen, flush, "w_up fused state", d,
                               f, S, False, slots=slots)
        padded = sidedelta_case(torch, gen, flush,
                                "w_up fused state, padded x2", d, f, S,
                                False, slots=slots, pad_to=2 * pad)
        again = sidedelta_case(torch, gen, flush, "w_up fused state", d,
                               f, S, False, slots=slots)
        # the gate reads each case's median launch: one launch stalled by
        # something else on the card moves a mean of 20 by a lot (C6)
        med = lambda r: statistics.median(r["times"])
        ref_ms = (med(tight) + med(again)) / 2
        if med(padded) > 1.25 * ref_ms + 0.01:
            for r in (tight, padded, again):
                print(f"[kernels] sidedelta {r['label']} S={S} launches "
                      f"(ms): {[round(t, 4) for t in r['times']]}",
                      flush=True)
            fail(f"padding is walked: padded median {med(padded):.4f} ms vs "
                 f"{ref_ms:.4f} ms unpadded (S={S})")
        side += [tight, padded, again]

    # scatter_apply, every case bit for bit against its plain version.
    # First a fused pack of two w_up layers, padded as fuse_packs pads a
    # shorter layer (index 0, value 0), 4096 more entries a layer
    kernel_ptxas("scatter_apply")
    import torch.nn.functional as F
    w2 = torch.randn((2, d, f), generator=gen, device="cuda")
    fi, fv = (F.pad(t, (0, 4096)) for t in fused[0].entries["w"])
    want = scatter_apply_plain(w2.clone(), fi, fv, 1.0)
    scatter_apply(w2, fi, fv, 1.0)
    pad_err = float((w2 - want).abs().max())
    print(f"[kernels] scatter_apply fused pack (2, {d}, {f}) K={fi.shape[-1]}"
          f" padded entries {int((fv == 0).sum())}: max_abs_err={pad_err}",
          flush=True)
    if pad_err != 0.0:
        fail("scatter_apply disagrees with its plain version on a padded "
             "fused pack")
    del packs, fused, slots, w2, want, fi, fv
    # C3: a pack with repeated indices, merged when it is built
    from repro_torch.core.adapters import apply_pack
    probe = assert_probe()
    err, tol, _, _ = repeat_case(
        torch, gen, lambda w, i, v: apply_pack(
            {"w": w}, AdapterPack("repeats", {"w": (i, v)})), "apply_pack")
    if not err <= tol:
        fail(f"scatter_apply: a pack with repeated indices loads "
             f"{err:.3g} away from its plain version (tol {tol:.3g})")
    check_assert_probe(probe)
    torch.cuda.empty_cache()
    # many layers of odd k: layer boundaries inside a block, and at 70,001
    # layers more layers than a grid dimension holds; then granite-moe's
    # stacked wq leaf and its experts' w_up flattened to (L * E, n, m),
    # deepseek-v2-lite-16b's MoE-stage wq and w_uk leaves, and
    # mamba2-780m's out_proj
    for nl, n, m, kk in ((37, 96, 160, 307), (70001, 8, 8, 3),
                         (24, 1024, 1024, budget(1024, 1024, 0.98)),
                         (24 * 32, 1024, 512, budget(1024, 512, 0.98)),
                         (26, 2048, 3072, budget(2048, 3072, 0.98)),
                         (26, 512, 2048, budget(512, 2048, 0.98)),
                         (48, 3072, 1536, budget(3072, 1536, 0.98))):
        ws = torch.randn((nl, n, m), generator=gen, device="cuda")
        ii = torch.argsort(torch.rand((nl, n * m), generator=gen,
                                      device="cuda"), 1)[:, :kk]
        ii = ii.sort(1).values.to(torch.int32)
        vv = torch.randn((nl, kk), generator=gen, device="cuda")
        want = scatter_apply_plain(ws.clone(), ii, vv, 0.5)
        scatter_apply(ws, ii, vv, 0.5)
        equal = bool(torch.equal(ws, want))
        print(f"[kernels] scatter_apply ({nl}, {n}, {m}) k={kk}: bit-equal "
              f"to its plain version: {equal}", flush=True)
        if not equal:
            fail(f"scatter_apply disagrees with its plain version at "
                 f"({nl}, {n}, {m}) k={kk}")
    del ws, ii, vv, want

    # the stacked (32, 4608, 18432) leaf: load, unload, with the indices
    # ascending (as every pack holds them) and shuffled within each layer
    L = 32
    w = torch.randn((L, d, f), generator=gen, device="cuda")
    idx, vals = rand_entries(torch, gen, L, d, f, k)
    perm = torch.argsort(torch.rand((L, k), generator=gen, device="cuda"),
                         dim=1)
    shuffled = idx.gather(1, perm), vals.gather(1, perm)
    del perm
    gi = (torch.arange(L, device="cuda")[:, None] * (d * f)
          + idx.long()).reshape(-1)
    before = w.view(-1)[gi].clone()
    probe = torch.randint(0, w.numel(), (1 << 20,), generator=gen,
                          device="cuda")
    probe = probe[~torch.isin(probe, gi)]          # entries no pack touches
    probe_before = w.view(-1)[probe].clone()
    want = scatter_apply_plain(before.clone()[None], torch.arange(
        gi.numel(), dtype=torch.int32, device="cuda"), vals.reshape(-1),
        1.0)[0]
    errs = []
    for label, entries in (("ascending", (idx, vals)),
                           ("shuffled", shuffled)):
        ordered = label == "ascending"   # shuffled rows are not merged
        scatter_apply(w, *entries, 1.0, ordered=ordered)
        load_err = float((w.view(-1)[gi] - want).abs().max())
        scatter_apply(w, *entries, -1.0, ordered=ordered)
        restore_err = float((w.view(-1)[gi] - before).abs().max())
        untouched = bool(torch.equal(w.view(-1)[probe], probe_before))
        print(f"[kernels] scatter_apply ({L}, {d}, {f}) K={gi.numel()} "
              f"{label}: load err={load_err} restore err={restore_err:.3g} "
              f"(tol {RESTORE_TOL}) untouched entries equal: {untouched}",
              flush=True)
        if (load_err != 0.0 or not restore_err <= RESTORE_TOL
                or not untouched):
            fail(f"scatter_apply disagrees with its plain version "
                 f"({label} indices)")
        w.view(-1)[gi] = before         # the exact base for the next case
        errs += [load_err, restore_err]
    sign = [1.0]

    def flip(fn):
        def go():
            fn(sign[0])
            sign[0] = -sign[0]
        return go
    ms = cold_ms(torch, flip(lambda a: scatter_apply(w, idx, vals, a)), 10,
                 flush)
    shuffled_ms = cold_ms(torch, flip(
        lambda a: scatter_apply(w, *shuffled, a, ordered=False)), 10, flush)
    plain_ms = cold_ms(torch, flip(
        lambda a: scatter_apply_plain(w, idx, vals, a)), 4, flush)
    upd = {1.0: vals.reshape(-1).clone(), -1.0: -vals.reshape(-1)}
    library_ms = cold_ms(torch, flip(lambda a: w.view(-1).index_put_(
        (gi,), upd[a], accumulate=True)), 4, flush)
    # C3's check, paid once where a pack is built (AdapterPack): one
    # compare pass over the leaf's entries and one read of the result
    from repro_torch.core.adapters import merged_form
    check_ms = cold_ms(torch, lambda: merged_form(idx, vals), 10, flush)
    hi, hv = idx.cpu(), vals.cpu()
    t0 = time.perf_counter()
    ok = merged_form(hi, hv)
    check_cpu = time.perf_counter() - t0
    print(f"[kernels] merged-form check of the leaf's {idx.numel()} entries "
          f"(once, when a pack is built): {check_ms:.4f} ms on the card, "
          f"{check_cpu * 1e3:.1f} ms on the host (a pack from a file); "
          f"merged {ok}", flush=True)
    if not ok:
        fail("merged_form refused a pack of ascending unique indices")
    del hi, hv
    from repro_torch.kernels.scatter_apply import sector_bytes
    nbytes, sectors = sector_bytes(w, idx, vals)
    scat = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, **bound(nbytes, 0)}
    print(f"[kernels] scatter_apply ms={ms:.4f} (shuffled {shuffled_ms:.4f})"
          f" plain_ms(index_add_)={plain_ms:.4f} library_ms(index_put_ "
          f"accumulate)={library_ms:.4f} bound_ms={scat['bound_ms']:.4f} "
          f"(bytes: {sectors} of {w.numel() // 8} W sectors read and "
          f"written, 8 B an entry): {rate_line(scat, nbytes)}", flush=True)
    del w, idx, vals, shuffled, gi, before, probe, probe_before, upd, want
    return side, scat


def adamw_inputs(torch, gen, shape):
    """v, g, m, u on the card, at magnitudes where every output lies far
    above ADAMW_TOL (as the CPU tests' inputs): v, g ~ N(0, 1),
    m ~ N(0, 0.1^2), u = |N(0, 1)| * 0.01, so u_out ~ 0.01 and m_out ~ 0.1."""
    r = lambda: torch.randn(shape, generator=gen, device="cuda")
    return r(), r(), r().mul_(0.1), r().abs_().mul_(0.01)


def adamw_within(got, want) -> bool:
    """Every kernel output within rtol = atol = ADAMW_TOL of the plain
    version's."""
    return all(bool(((a - b).abs() <= ADAMW_TOL * b.abs() + ADAMW_TOL).all())
               for a, b in zip(got, want))


def adamw_planted(torch, want):
    """Faults the check must see: each output in turn zeroed, or rotated
    within each vector of 4 elements (the last n mod 4 left as they are)."""
    for j, w in enumerate(want):
        rot = w.clone().reshape(-1)
        n4 = rot.numel() // 4 * 4
        rot[:n4] = rot[:n4].view(-1, 4).roll(1, dims=1).reshape(-1)
        for bad in (torch.zeros_like(w), rot.view_as(w)):
            yield [bad if i == j else x for i, x in enumerate(want)]


def adamw_close(torch, got, want):
    """(max_abs_err, max_rel_err, bit-equal) of kernel outputs against the
    plain version's; fails beyond rtol = atol = ADAMW_TOL, and fails if
    that check would pass a planted fault (``adamw_planted``) at these
    inputs."""
    if not adamw_within(got, want):
        fail("sparse_adamw disagrees with its plain version")
    if any(adamw_within(p, want) for p in adamw_planted(torch, want)):
        fail("sparse_adamw: the check passes a zeroed or permuted output "
             "at these inputs")
    errs = []
    for a, b in zip(got, want):
        d = (a - b).abs()
        errs.append((float(d.max()),
                     float((d / b.abs().clamp(min=1e-30)).max()),
                     bool(torch.equal(a, b))))
    return (max(e[0] for e in errs), max(e[1] for e in errs),
            all(e[2] for e in errs))


def fused_adamw_ms(torch, flush, v, g, m, u, scalars):
    """library_ms: torch._fused_adamw_ over the same f32 vector, in place on
    copies (PyTorch's own fused AdamW; the port never calls it)."""
    p, e1, e2 = v.clone(), m.clone(), u.clone()
    steps = [torch.tensor(3.0, device="cuda")]
    lr, b1, b2, eps, wd = scalars[:5]
    return cold_ms(torch, lambda: torch._fused_adamw_(
        [p], [g], [e1], [e2], [], steps, lr=lr, beta1=b1, beta2=b2,
        weight_decay=wd, eps=eps, amsgrad=False, maximize=False), 10, flush)


def rate_line(r: dict, nbytes: float) -> str:
    """Achieved TB/s of one timed case's bytes and its share of the
    bound."""
    return (f"{nbytes / r['ms'] / 1e9:.3f} TB/s, {r['bound_ms'] / r['ms']:.1%}"
            " of bound")


def ptxas_lines(log: str):
    """(kernel, line) of each registers or spills line of a ptxas log."""
    fn = ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = kernel_name(ln.split("'")[1])
        if "registers" in ln or "spill" in ln:
            yield fn, ln.strip()


def kernel_ptxas(name: str, held: str = "") -> None:
    """Prints the -Xptxas -v lines (registers, spills) of every kernel
    instance of library ``name``; fails if the log is missing or an
    instance whose name contains ``held`` (every instance by default)
    spills."""
    from repro_torch.kernels import build
    lines = list(ptxas_lines(build.ptxas(name)))
    if not any("spill stores" in ln for _, ln in lines):
        fail(f"{name}: no ptxas log beside its library")
    for fn, ln in lines:
        print(f"[kernels] {name} ptxas: {fn}: {ln}", flush=True)
        if held in fn and re.search(r"[1-9]\d* bytes spill (stores|loads)",
                                    ln):
            fail(f"{name}: {fn} spills registers")


def adamw_kernels(torch, flush, cfg):
    """sparse_adamw (blocks) on the stacked w_up leaf's packed vector and
    sparse_adamw_rows on (3 adapters x layers, K) rows with f32, bf16 and
    int8 moments, at sparsity 0.98 as the multi-adapter phase trains; then
    short rows (K = 3 and 13: row boundaries inside a vector) in every
    moment type, and views at an element offset of 1, which take the
    one-element instance."""
    from repro_torch.core.masks import budget
    from repro_torch.kernels import ops
    from repro_torch.kernels.sparse_adamw import (sparse_adamw,
                                                  sparse_adamw_cost,
                                                  sparse_adamw_plain,
                                                  sparse_adamw_rows,
                                                  sparse_adamw_rows_cost,
                                                  sparse_adamw_rows_plain)
    from repro_torch.training import qstate
    kernel_ptxas("sparse_adamw")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    k = budget(cfg.d_model, cfg.d_ff, 0.98)
    L = cfg.num_layers
    scalars = ops._adamw_scalars(3, 3e-4, 0.9, 0.999, 1e-8, 0.0)

    v, g, m, u = adamw_inputs(torch, gen, (L * k,))
    got = sparse_adamw(v, g, m, u, scalars)
    want = sparse_adamw_plain(v, g, m, u, scalars)
    err, rel, equal = adamw_close(torch, got, want)
    del got, want
    blocks = {"max_abs_err": err,
              "ms": cold_ms(torch, lambda: sparse_adamw(v, g, m, u, scalars),
                            20, flush),
              "plain_ms": cold_ms(torch, lambda: sparse_adamw_plain(
                  v, g, m, u, scalars), 3, flush),
              "library_ms": fused_adamw_ms(torch, flush, v, g, m, u, scalars),
              **bound_of(sparse_adamw_cost(v, g, m, u, scalars))}
    blocks_bytes = sparse_adamw_cost(v, g, m, u, scalars)["bytes_accessed"]
    print(f"[kernels] sparse_adamw_blocks w_up leaf ({L}*{k},): "
          f"max_abs_err={err:.3g} max_rel_err={rel:.3g} bit-equal={equal} "
          f"(tol rtol=atol={ADAMW_TOL}) ms={blocks['ms']:.4f} "
          f"plain_ms={blocks['plain_ms']:.3f} library_ms(_fused_adamw_)="
          f"{blocks['library_ms']} bound_ms={blocks['bound_ms']:.4f} "
          f"({blocks['bound_by']}), {rate_line(blocks, blocks_bytes)}",
          flush=True)
    # the one-element instance: every operand one element past its start
    before = sparse_adamw.unaligned_launches
    views = [t[1:] for t in (v, g, m, u)]
    got = sparse_adamw(*views, scalars)
    if sparse_adamw.unaligned_launches != before + 1:
        fail("sparse_adamw at an offset of 1 did not take the one-element "
             "instance")
    err1, _, _ = adamw_close(torch, got,
                             sparse_adamw_plain(*views, scalars))
    blocks["max_abs_err"] = max(err, err1)
    ms1 = cold_ms(torch, lambda: sparse_adamw(*views, scalars), 10, flush)
    print(f"[kernels] sparse_adamw_blocks at offset 1 (one-element "
          f"instance): max_abs_err={err1:.3g} ms={ms1:.4f}, "
          f"{blocks_bytes / ms1 / 1e9:.3f} TB/s", flush=True)
    del v, g, m, u, views, got

    R = 3 * L
    v, g, m, u = adamw_inputs(torch, gen, (R, k))
    rows = {}
    for mode in ("f32", "bf16", "int8"):
        mq, ms = qstate.encode(m, mode)
        uq, us = qstate.encode(u, mode, sqrt_domain=True)
        args = (v, g, mq, uq, ms, us, scalars)
        got = sparse_adamw_rows(*args)
        want = sparse_adamw_rows_plain(*args)
        err, rel, equal = adamw_close(torch, got, want)
        del got, want
        c = sparse_adamw_rows_cost(*args)
        nbytes = c["bytes_accessed"]
        r = {"max_abs_err": err,
             "ms": cold_ms(torch, lambda: sparse_adamw_rows(*args), 10,
                           flush),
             "plain_ms": cold_ms(torch, lambda: sparse_adamw_rows_plain(
                 *args), 3, flush),
             "library_ms": (fused_adamw_ms(torch, flush, v, g, m, u, scalars)
                            if mode == "f32" else None),
             **bound_of(c)}
        rows[mode] = r
        print(f"[kernels] sparse_adamw_rows ({R}, {k}) {mode} moments: "
              f"max_abs_err={err:.3g} max_rel_err={rel:.3g} bit-equal="
              f"{equal} (tol rtol=atol={ADAMW_TOL}) ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.3f} library_ms(_fused_adamw_, f32)"
              f"={r['library_ms']} bound_ms={r['bound_ms']:.4f} "
              f"({r['bound_by']}), {rate_line(r, nbytes)}", flush=True)
        if mode == "int8":   # the re-encode that follows every int8 update
            enc = cold_ms(torch, lambda: (
                qstate.encode(m, "int8"),
                qstate.encode(u, "int8", sqrt_domain=True)), 10, flush)
            print(f"[kernels] qstate.encode int8 of both ({R}, {k}) f32 "
                  f"moments: ms={enc:.4f} (the int8 update above: "
                  f"{r['ms']:.4f})", flush=True)
        del mq, uq, ms, us, args
    # f32 rows one element past the start: the one-element instance
    before = sparse_adamw_rows.unaligned_launches
    views = [t.view(-1)[1:1 + (R - 1) * k].view(R - 1, k)
             for t in (v, g, m, u)]
    got = sparse_adamw_rows(*views, None, None, scalars)
    if sparse_adamw_rows.unaligned_launches != before + 1:
        fail("sparse_adamw_rows at an offset of 1 did not take the "
             "one-element instance")
    err1, _, _ = adamw_close(torch, got, sparse_adamw_rows_plain(
        *views, None, None, scalars))
    ms1 = cold_ms(torch, lambda: sparse_adamw_rows(*views, None, None,
                                                   scalars), 10, flush)
    print(f"[kernels] sparse_adamw_rows ({R - 1}, {k}) f32 at offset 1 "
          f"(one-element instance): max_abs_err={err1:.3g} ms={ms1:.4f}, "
          f"{views[0].numel() * 28 / ms1 / 1e9:.3f} TB/s", flush=True)
    rows["f32"]["max_abs_err"] = max(rows["f32"]["max_abs_err"], err1)
    del v, g, m, u, views, got
    # short rows: a row boundary inside a vector, or rows shorter than one
    for R, K in ((5, 3), (7, 13)):
        v, g, m, u = adamw_inputs(torch, gen, (R, K))
        for mode in ("f32", "bf16", "int8"):
            mq, ms = qstate.encode(m, mode)
            uq, us = qstate.encode(u, mode, sqrt_domain=True)
            args = (v, g, mq, uq, ms, us, scalars)
            err, _, equal = adamw_close(torch, sparse_adamw_rows(*args),
                                        sparse_adamw_rows_plain(*args))
            rows[mode]["max_abs_err"] = max(rows[mode]["max_abs_err"], err)
            print(f"[kernels] sparse_adamw_rows ({R}, {K}) {mode} moments: "
                  f"max_abs_err={err:.3g} bit-equal={equal}", flush=True)
    return blocks, rows


def sampled_addmm_ms(torch, flush, t, x, dy, A, n, m, S):
    """library_ms of dvals: torch.sparse.sampled_addmm of x^T @ dy at each
    adapter's pattern, one batched CSR call (the row-sorted table is the
    CSR layout)."""
    Ta = x.shape[0] // A * S
    xa = x.float().reshape(A, Ta, n).transpose(1, 2).contiguous()
    dya = dy.reshape(A, Ta, m).contiguous()
    csr = torch.sparse_csr_tensor(
        t["t_ptr"].long(), t["t_rows"].long(),
        torch.zeros(t["t_rows"].shape, device="cuda"), (A, n, m))
    return cold_ms(torch, lambda: torch.sparse.sampled_addmm(
        csr, xa, dya, beta=0.0), 5, flush)


def grad_case(torch, gen, flush, label, n, m):
    """The trainable side delta at one layer's (n, m) leaf, 3 adapters at
    sparsity 0.98 and T_a = 512 tokens each, x bf16 as the multi-adapter
    forward runs it: the forward over the column-sorted table, dx through
    the forward kernel over the transposed table, each against the plain
    version beside one bmm on the densified per-request dW (dW^T for dx),
    and dvals against its plain version. dy is scaled by 1e-2, a
    gradient's size, so the f32 sums of 512 products stay within the
    absolute tolerance."""
    from repro_torch.core.masks import budget
    from repro_torch.kernels import ops
    from repro_torch.kernels.sidedelta import (_launch_dvals,
                                               _sidedelta_dvals, dvals_cost,
                                               group_by_adapter, kernel_path,
                                               sidedelta, sidedelta_cost,
                                               sidedelta_dvals,
                                               sidedelta_dvals_plain,
                                               sidedelta_plain, token_minor)
    A, S = 3, MT_SEQ
    k = budget(n, m, 0.98)
    idx = [rand_entries(torch, gen, 1, n, m, k)[0] for _ in range(A)]
    t = {key: v[0].contiguous() for key, v in ops.sidedelta_table(
        idx, 1, n, m, trainable=True).items()}
    del idx
    vals = 0.01 * torch.randn((A, k), generator=gen, device="cuda")
    vals_t = vals.gather(1, t["perm"].long()).gather(1, t["t_perm"].long())
    ids = torch.tensor(MT_IDS, dtype=torch.int32, device="cuda")
    Bt = len(MT_IDS)
    x = torch.randn((Bt, S, n), generator=gen, device="cuda").to(
        torch.bfloat16)
    dy = 0.01 * torch.randn((Bt, S, m), generator=gen, device="cuda")
    out = {}
    dx_args = (dy, t["t_rows"], vals_t, t["t_ptr"], ids)
    err = float((sidedelta(*dx_args) - sidedelta_plain(*dx_args)).abs().max())
    if not err <= SIDEDELTA_TOL:
        fail(f"sidedelta dx {label}: max_abs_err {err} > {SIDEDELTA_TOL}")
    dense = torch.zeros((A, n * m), device="cuda")
    vs = vals.gather(1, t["perm"].long())
    col = torch.repeat_interleave(torch.arange(m, device="cuda")[None]
                                  .expand(A, m).reshape(-1),
                                  torch.diff(t["colptr"].long()).reshape(-1))
    dense.scatter_(1, t["rows"].long() * m + col.reshape(A, k), vs)
    fw_args = (x, t["rows"], vs, t["colptr"], ids)
    err_fw = float((sidedelta(*fw_args)
                    - sidedelta_plain(*fw_args)).abs().max())
    if not err_fw <= SIDEDELTA_TOL:
        fail(f"sidedelta forward {label}: max_abs_err {err_fw} > "
             f"{SIDEDELTA_TOL}")
    dense_f = dense.reshape(A, n, m)[ids.long()]
    xf = x.float()
    out["forward"] = {
        "max_abs_err": err_fw,
        "ms": cold_ms(torch, lambda: sidedelta(*fw_args), 10, flush),
        "plain_ms": cold_ms(torch, lambda: sidedelta_plain(*fw_args), 2,
                            flush),
        "library_ms": cold_ms(torch, lambda: torch.bmm(xf, dense_f), 5,
                              flush),
        **bound_of(sidedelta_cost(*fw_args))}
    del dense_f, xf
    dense_t = dense.reshape(A, n, m).transpose(1, 2)[ids.long()]
    out["dx"] = {"max_abs_err": err,
                 "ms": cold_ms(torch, lambda: sidedelta(*dx_args), 10, flush),
                 "plain_ms": cold_ms(torch, lambda: sidedelta_plain(*dx_args),
                                     2, flush),
                 "library_ms": cold_ms(torch, lambda: torch.bmm(dy, dense_t),
                                       5, flush),
                 **bound_of(sidedelta_cost(*dx_args))}
    del dense, dense_t, col
    dv_args = (x, dy, t["rows"], t["colptr"], ids)
    want = sidedelta_dvals_plain(*dv_args)
    err = float((sidedelta_dvals(*dv_args) - want).abs().max())
    # the kernel alone, on the grouping and token-minor x and dy that the
    # wrapper prepares (the backward passes dy's, shared with dx)
    order, rptr = group_by_adapter(ids, A)
    dyT, xT = token_minor(dy, order), token_minor(x, order)
    dv_out = torch.zeros((A, k), device="cuda")
    alone = lambda: _launch_dvals(xT, dyT, t["rows"], t["colptr"], rptr, S,
                                  dv_out)
    err = max(err, float((alone() - want).abs().max()))
    if not err <= SIDEDELTA_TOL:
        fail(f"sidedelta_dvals {label}: max_abs_err {err} > {SIDEDELTA_TOL}")
    del want
    nbytes_dv = dvals_cost(*dv_args)["bytes_accessed"]
    out["dvals"] = {
        "max_abs_err": err,
        "ms": cold_ms(torch, alone, 10, flush),
        "backward_ms": cold_ms(torch, lambda: _sidedelta_dvals(
            *dv_args, grouped=(order, rptr, dyT)), 10, flush),
        "wrapper_ms": cold_ms(torch, lambda: sidedelta_dvals(*dv_args), 10,
                              flush),
        "plain_ms": cold_ms(torch, lambda: sidedelta_dvals_plain(*dv_args),
                            2, flush),
        "library_ms": sampled_addmm_ms(torch, flush, t, x, dy, A, n, m, S),
        **bound_of(dvals_cost(*dv_args))}
    del xT, dyT, dv_out
    # the wrapper's prep for dx (and dvals, which shares it): the grouping
    # and dy in token-minor order
    prep_ms = cold_ms(torch, lambda: token_minor(
        dy, group_by_adapter(ids, A)[0]), 10, flush)
    print(f"[kernels] sidedelta {label}: grouping + token-minor dy "
          f"({Bt}, {S}, {m}) f32: {prep_ms:.4f} ms of each dx call",
          flush=True)
    for name, r in out.items():
        yard = {"forward": "bmm, dense dW", "dx": "bmm, dense dW^T",
                "dvals": "sampled_addmm"}[name]
        path = (f" path={kernel_path(Bt, S)}" if name != "dvals"
                else " kernel alone")
        print(f"[kernels] sidedelta {name} {label} ({n}x{m}) K={k}x{A} "
              f"T_a={2 * S}{path}: max_abs_err={r['max_abs_err']:.3g} (tol "
              f"{SIDEDELTA_TOL}) ms={r['ms']:.4f} plain_ms="
              f"{r['plain_ms']:.3f} library_ms({yard})="
              f"{r['library_ms']:.3f} bound_ms="
              f"{r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
    r = out["dvals"]
    print(f"[kernels] sidedelta dvals {label}: as the backward calls it "
          f"(x to token-minor order) {r['backward_ms']:.4f} ms, the whole "
          f"wrapper (grouping, x and dy to token-minor order) "
          f"{r['wrapper_ms']:.4f} ms; the kernel alone "
          f"{rate_line(r, nbytes_dv)}, "
          f"{2 * Bt * S * k / r['ms'] / 1e9:.3f} TB/s of x gathered",
          flush=True)
    return out


def dvals_edge_cases(torch, gen, n, m):
    """sidedelta_dvals at (n, m) against its plain version on the
    multi-adapter batch at S = 250 (not a multiple of a vector: the
    one-token instance, which must count an unaligned launch), and at
    S = 256 with adapter 1 given no tokens (its gradient must be zero)."""
    from repro_torch.core.masks import budget
    from repro_torch.kernels import ops
    from repro_torch.kernels.sidedelta import (sidedelta_dvals,
                                               sidedelta_dvals_plain)
    A, k = 3, budget(n, m, 0.98)
    t = {key: v[0].contiguous() for key, v in ops.sidedelta_table(
        [rand_entries(torch, gen, 1, n, m, k)[0] for _ in range(A)], 1, n,
        m, trainable=True).items()}
    for S, ids, one_token in ((250, MT_IDS, True),
                              (MT_SEQ, [0, 0, 2, 2, -1, 0], False)):
        ids = torch.tensor(ids, dtype=torch.int32, device="cuda")
        x = torch.randn((len(ids), S, n), generator=gen, device="cuda").to(
            torch.bfloat16)
        dy = 0.01 * torch.randn((len(ids), S, m), generator=gen,
                                device="cuda")
        args = (x, dy, t["rows"], t["colptr"], ids)
        before = sidedelta_dvals.unaligned_launches
        got = sidedelta_dvals(*args)
        took = sidedelta_dvals.unaligned_launches - before
        err = float((got - sidedelta_dvals_plain(*args)).abs().max())
        empty = [a for a in range(A) if a not in ids.tolist()]
        zero = all(float(got[a].abs().max()) == 0.0 for a in empty)
        print(f"[kernels] sidedelta dvals ({n}x{m}) S={S} ids "
              f"{ids.tolist()}: max_abs_err={err:.3g} (tol {SIDEDELTA_TOL}),"
              f" one-token launches {took}, adapters without tokens "
              f"{empty} all zero: {zero}", flush=True)
        if not err <= SIDEDELTA_TOL or not zero:
            fail(f"sidedelta_dvals disagrees with its plain version at "
                 f"S={S}")
        if took != int(one_token):
            fail(f"sidedelta_dvals at S={S}: {took} one-token launches, "
                 f"expected {int(one_token)}")


def train_kernels_phase(torch, flush):
    from repro_torch.configs import get_config
    cfg = get_config("starcoder2-7b")
    blocks, rows = adamw_kernels(torch, flush, cfg)
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    d, f = cfg.d_model, cfg.d_ff
    kv = cfg.num_kv_heads * cfg.resolved_head_dim
    kernel_ptxas("sidedelta_grad")
    grads = {}
    for label, n, m in (("w_up", d, f), ("wq", d, d), ("wk", d, kv),
                        ("w_down", f, d), ("mamba out_proj", 3072, 1536)):
        grads[label] = grad_case(torch, gen, flush, label, n, m)
        torch.cuda.empty_cache()
    dvals_edge_cases(torch, gen, d, f)
    torch.cuda.empty_cache()
    return blocks, rows, grads


def mamba_kernels(torch, flush):
    """The SHiRA kernels at mamba2-780m's one target leaf, out_proj (48,
    3072, 1536) at sparsity 0.98, timed beside their plain versions, one
    library call and their bounds: scatter_apply (a switch's whole work:
    load of the ascending pack; bit-equal), sparse_adamw_blocks over the
    Trainer's packed (48 k,) vector and sparse_adamw_rows over the
    multi-adapter trainer's (3 x 48, k) f32 rows (within ADAMW_TOL).
    sidedelta's cases at this width are in the kernels phase, dvals' in
    the training one. Returns {kernel: numbers}."""
    from repro_torch.core.masks import budget
    from repro_torch.kernels import ops
    from repro_torch.kernels.scatter_apply import (scatter_apply,
                                                   scatter_apply_plain,
                                                   sector_bytes)
    from repro_torch.kernels.sparse_adamw import (sparse_adamw,
                                                  sparse_adamw_cost,
                                                  sparse_adamw_plain,
                                                  sparse_adamw_rows,
                                                  sparse_adamw_rows_cost,
                                                  sparse_adamw_rows_plain)
    L, n, m = 48, 3072, 1536
    k = budget(n, m, 0.98)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    out = {}
    w = torch.randn((L, n, m), generator=gen, device="cuda")
    idx, vals = rand_entries(torch, gen, L, n, m, k)
    want = scatter_apply_plain(w.clone(), idx, vals, 1.0)
    scatter_apply(w, idx, vals, 1.0)
    if not torch.equal(w, want):
        fail("scatter_apply disagrees with its plain version at mamba's "
             "out_proj")
    del want
    gi = (torch.arange(L, device="cuda")[:, None] * (n * m)
          + idx.long()).reshape(-1)
    sign = [-1.0]

    def flip(fn):
        def go():
            fn(sign[0])
            sign[0] = -sign[0]
        return go
    upd = {1.0: vals.reshape(-1).clone(), -1.0: -vals.reshape(-1)}
    nbytes, sectors = sector_bytes(w, idx, vals)
    out["scatter_apply"] = r = {
        "max_abs_err": 0.0,
        "ms": cold_ms(torch, flip(lambda a: scatter_apply(w, idx, vals, a)),
                      10, flush),
        "plain_ms": cold_ms(torch, flip(lambda a: scatter_apply_plain(
            w, idx, vals, a)), 4, flush),
        "library_ms": cold_ms(torch, flip(lambda a: w.view(-1).index_put_(
            (gi,), upd[a], accumulate=True)), 4, flush),
        **bound(nbytes, 0)}
    print(f"[kernels] scatter_apply mamba out_proj ({L}, {n}, {m}) "
          f"K={idx.numel()}: bit-equal, ms={r['ms']:.4f} plain_ms(index_add_)"
          f"={r['plain_ms']:.4f} library_ms(index_put_ accumulate)="
          f"{r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({sectors} W "
          f"sectors): {rate_line(r, nbytes)}", flush=True)
    del w, idx, vals, gi, upd
    scalars = ops._adamw_scalars(3, 3e-4, 0.9, 0.999, 1e-8, 0.0)
    for name, shape, fn, plain, cost in (
            ("sparse_adamw_blocks", (L * k,), sparse_adamw,
             sparse_adamw_plain, sparse_adamw_cost),
            ("sparse_adamw_rows", (3 * L, k),
             lambda *a: sparse_adamw_rows(*a[:4], None, None, a[4]),
             lambda *a: sparse_adamw_rows_plain(*a[:4], None, None, a[4]),
             lambda *a: sparse_adamw_rows_cost(*a[:4], None, None, a[4]))):
        v, g, mu, nu = adamw_inputs(torch, gen, shape)
        err, _, equal = adamw_close(torch, fn(v, g, mu, nu, scalars),
                                    plain(v, g, mu, nu, scalars))
        c = cost(v, g, mu, nu, scalars)
        nbytes = c["bytes_accessed"]
        out[name] = r = {
            "max_abs_err": err,
            "ms": cold_ms(torch, lambda: fn(v, g, mu, nu, scalars), 20,
                          flush),
            "plain_ms": cold_ms(torch, lambda: plain(v, g, mu, nu, scalars),
                                3, flush),
            "library_ms": fused_adamw_ms(torch, flush, v, g, mu, nu,
                                         scalars),
            **bound_of(c)}
        print(f"[kernels] {name} mamba out_proj {shape} f32: max_abs_err="
              f"{err:.3g} bit-equal={equal} (tol rtol=atol={ADAMW_TOL}) "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.3f} library_ms("
              f"_fused_adamw_)={r['library_ms']:.4f} bound_ms="
              f"{r['bound_ms']:.4f} ({r['bound_by']}), "
              f"{rate_line(r, nbytes)}", flush=True)
        del v, g, mu, nu
    torch.cuda.empty_cache()
    return out


def zamba_kernels(torch, flush):
    """The SHiRA serving kernels at zamba2-2.7b's target leaves, sparsity
    0.98: scatter_apply bit for bit on the (9, 6, 5120, 2560) out_proj
    stack (two leading dims: a switch's whole load of that leaf, timed
    beside its plain version, index_put_ and its sector bound) and on the
    shared block's unstacked (2560, 10240) w_up (one entry set that
    serves all 9 sites); sidedelta at out_proj's (5120x2560) and the
    shared w_up's widths, S = 1 (decode) and 256, f32 and int8 tables,
    within SIDEDELTA_TOL. Returns {"scatter_apply": numbers, "sidedelta":
    [numbers]}."""
    from repro_torch.configs import get_config
    from repro_torch.core.masks import budget
    from repro_torch.kernels.scatter_apply import (scatter_apply,
                                                   scatter_apply_plain,
                                                   sector_bytes)
    cfg = get_config(ZAMBA_ARCH)
    g, k = cfg.num_layers // cfg.hybrid_attn_every, cfg.hybrid_attn_every
    d, f = cfg.d_model, cfg.d_ff
    n, m = cfg.ssm.expand * d, d
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    out = {"sidedelta": []}
    for label, nn, mm in (("zamba out_proj", n, m),
                          ("zamba shared w_up", d, f)):
        for S in (1, CHUNK):
            for int8 in (False, True):
                out["sidedelta"].append(sidedelta_case(
                    torch, gen, flush, label, nn, mm, S, int8))
    torch.cuda.empty_cache()
    # the shared block's w_up: one (K,) entry set on a 2-D leaf
    w = torch.randn((d, f), generator=gen, device="cuda")
    idx, vals = rand_entries(torch, gen, 1, d, f, budget(d, f, 0.98))
    idx, vals = idx[0], vals[0]
    want = scatter_apply_plain(w.clone(), idx, vals, 0.5)
    scatter_apply(w, idx, vals, 0.5)
    if not torch.equal(w, want):
        fail("scatter_apply disagrees with its plain version at zamba's "
             "shared w_up")
    print(f"[kernels] scatter_apply zamba shared w_up ({d}, {f}) "
          f"K={idx.numel()}: bit-equal", flush=True)
    del w, want, idx, vals
    # the (g, k, n, m) out_proj stack
    kk = budget(n, m, 0.98)
    w = torch.randn((g, k, n, m), generator=gen, device="cuda")
    idx, vals = rand_entries(torch, gen, g * k, n, m, kk)
    idx, vals = idx.reshape(g, k, kk), vals.reshape(g, k, kk)
    want = scatter_apply_plain(w.clone(), idx, vals, 1.0)
    scatter_apply(w, idx, vals, 1.0)
    if not torch.equal(w, want):
        fail("scatter_apply disagrees with its plain version at zamba's "
             "(g, k) out_proj stack")
    del want
    gi = (torch.arange(g * k, device="cuda")[:, None] * (n * m)
          + idx.reshape(g * k, kk).long()).reshape(-1)
    sign = [-1.0]

    def flip(fn):
        def go():
            fn(sign[0])
            sign[0] = -sign[0]
        return go
    upd = {1.0: vals.reshape(-1).clone(), -1.0: -vals.reshape(-1)}
    nbytes, sectors = sector_bytes(w, idx, vals)
    out["scatter_apply"] = r = {
        "max_abs_err": 0.0,
        "ms": cold_ms(torch, flip(lambda a: scatter_apply(w, idx, vals, a)),
                      10, flush),
        "plain_ms": cold_ms(torch, flip(lambda a: scatter_apply_plain(
            w, idx, vals, a)), 4, flush),
        "library_ms": cold_ms(torch, flip(lambda a: w.view(-1).index_put_(
            (gi,), upd[a], accumulate=True)), 4, flush),
        **bound(nbytes, 0)}
    print(f"[kernels] scatter_apply zamba out_proj ({g}, {k}, {n}, {m}) "
          f"K={idx.numel()}: bit-equal, ms={r['ms']:.4f} plain_ms(index_add_)"
          f"={r['plain_ms']:.4f} library_ms(index_put_ accumulate)="
          f"{r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({sectors} W "
          f"sectors): {rate_line(r, nbytes)}", flush=True)
    del w, idx, vals, gi, upd
    torch.cuda.empty_cache()
    return out


def attn_case(torch, flush, label, fn, plain, library, tol, cost,
              iters=20, nsplit=None):
    """One attention kernel against its plain version on the same inputs:
    max_abs_err within ``tol``, then cold-L2 times of the kernel, the plain
    version and the library call, and the bound from the wrapper's
    ``cost()`` of this call: its bytes, and the score products (q . k) and
    value products (p . v) the function needs, all at the rate of the
    inputs' type, whatever a kernel does within (flash_prefill's bf16
    p . v runs as two products, p = hi + lo, 1.5x these operations).
    ``nsplit``: a decode kernel's splits a request (its plan), printed."""
    got = fn()
    want = plain()
    err = float((got.float() - want.float()).abs().max())
    if not err <= tol:
        fail(f"{label}: max_abs_err {err} > {tol}")
    r = {"max_abs_err": err, "ms": cold_ms(torch, fn, iters, flush),
         "plain_ms": cold_ms(torch, plain, 3, flush),
         "library_ms": cold_ms(torch, library, 10, flush),
         **bound_of(cost)}
    if nsplit is not None:
        r["nsplit"] = nsplit
    print(f"[kernels] {label}: max_abs_err={err:.3g} (tol {tol}) "
          f"{'' if nsplit is None else f'nsplit={nsplit} '}"
          f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.3f} library_ms(sdpa)="
          f"{r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
          f"({r['bound_by']})", flush=True)
    return r


def lse_case(torch, flush, label, q, k, v, kl):
    """The log-sum-exp instance of flash_decode against its plain version
    on the same inputs: the f32 output within ATTN_TOL["f32"] whatever the
    inputs' dtype (the instance writes f32 and the plain version upcasts
    the same inputs, so nothing is rounded to bf16), lse within LSE_TOL
    where finite and -inf exactly where the plain version's is (kv_len 0,
    beside a zero output); its cold-L2 time beside the existing instance's
    on the same inputs, the plain version's, SDPA's and the bound of its
    ``cost()``, and the splits a request its launch took."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import (decode_lengths,
                                                  decode_splits,
                                                  flash_decode_blocks,
                                                  flash_decode_cost,
                                                  flash_decode_plain,
                                                  sm_count)
    Bd, KV, G, D = q.shape
    S = k.shape[1]
    tol = ATTN_TOL["f32"]
    lens = decode_lengths(kl, Bd, "cuda")
    out, lse = flash_decode_blocks(q, k, v, kl, lse=True)
    want, wlse = flash_decode_plain(q, k, v, lens, lse=True)
    if out.dtype != torch.float32 or lse.shape != (Bd, KV, G):
        fail(f"{label}: the log-sum-exp instance gave {out.dtype} "
             f"{tuple(lse.shape)}")
    fin = torch.isfinite(wlse)
    if bool(torch.isnan(out).any()) or bool(torch.isnan(lse).any()) or \
            not torch.equal(torch.isfinite(lse), fin) or \
            not bool((lse[~fin] == wlse[~fin]).all()):
        fail(f"{label}: lse {lse.flatten()[:4].tolist()} where the plain "
             f"version has {wlse.flatten()[:4].tolist()}")
    err = float((out - want).abs().max())
    lerr = float((lse[fin] - wlse[fin]).abs().max()) if bool(fin.any()) \
        else 0.0
    if not (err <= tol and lerr <= LSE_TOL):
        fail(f"{label}: max_abs_err {err} (tol {tol}), lse {lerr} (tol "
             f"{LSE_TOL})")
    qs = q.reshape(Bd, KV * G, 1, D)
    ks, vs = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    mask = (torch.arange(S, device="cuda")[None, :]
            < lens.long()[:, None])[:, None, None, :]
    r = {"max_abs_err": max(err, lerr),
         "ms": cold_ms(torch, lambda: flash_decode_blocks(q, k, v, kl,
                                                          lse=True), 20,
                       flush),
         "base_ms": cold_ms(torch, lambda: flash_decode_blocks(q, k, v, kl),
                            20, flush),
         "plain_ms": cold_ms(torch, lambda: flash_decode_plain(
             q, k, v, lens, lse=True), 3, flush),
         "library_ms": cold_ms(torch, lambda: F.scaled_dot_product_attention(
             qs, ks, vs, attn_mask=mask, enable_gqa=True), 10, flush),
         **bound_of(flash_decode_cost(q, k, v, kl, lse=True)), "D": D,
         "nsplit": decode_splits(q, S, sm_count("cuda"))}
    print(f"[kernels] {label}: max_abs_err={err:.3g} (tol {tol}) lse "
          f"err={lerr:.3g} (tol {LSE_TOL}) nsplit={r['nsplit']} "
          f"ms={r['ms']:.4f} (the existing "
          f"instance {r['base_ms']:.4f}) plain_ms={r['plain_ms']:.3f} "
          f"library_ms(sdpa)={r['library_ms']:.4f} bound_ms="
          f"{r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
    return r


def attention_kernels_phase(torch, flush):
    """flash_decode, flash_decode_paged and flash_prefill against their
    plain versions at the continuous-batching shapes of starcoder2-7b (KV
    4, G 9, D 128), bf16 (the serving dtype) and f32, within ATTN_TOL;
    then both decode kernels at granite-34b's grouping (KV 1, G 48), the
    paged kernel with pages of 8 (the engine's default) and of 24 (which
    do not divide the kernel's 64-position splits), a prefill whose length
    is no multiple of the kernel's 64-row tiles (S 777), and one small
    case (B 1, S 256, H 8, KV 2) of each kernel at each other head dim the
    wrappers take (16, 32, 64), so that every template instance they can
    reach runs once. The paged kernel also reads int8 pools (the
    continuous engine's ``quant_kv``: codes and bf16 scales from
    ``quantize_kv`` of random rows) at the main shapes, pages of 8 and
    G = 48, and at D = 16/32/64, bf16 and f32 q, each held against its
    plain version on the same dequantized values. The serving shapes of
    the configs since the MoE slice follow: granite-moe (KV 8, G 2,
    D 64), qwen1.5-32b (KV 40, G 1), deepseek-coder-33b (KV 8, G 7) and
    granite-34b (KV 1, G 48), each kernel and int8 pools, and prefills of
    (1, 1024) and (8, 16). zamba2-2.7b's shared block takes the D = 80
    instances (32 heads of 80, G = 1): decode at the lanes' shape with
    (B,) and scalar kv_len, and prefills of (1, 1024), (1, 777) (a
    partial last tile; row 63 of every full one) and (8, 16); the paged
    kernel must refuse D = 80 on the card, since no path pages such a
    cache (returned under "d80" too). paligemma-3b's decode takes the
    D = 256 instances (8 heads over one KV head) at the lanes' 1056 rows
    after its 256-row prefix, (B,) and scalar kv_len ("d256"), and
    hubert-xlarge's encode the non-causal prefill at 16 heads of 80,
    (8, 1024) and (1, 777) ("bidir"); the paged kernel must refuse
    D = 256 too. The log-sum-exp instance of flash_decode (sequence-
    sharded serving) runs at LSE_SHAPES, one rank's shard of
    starcoder2-7b's decode_32k, granite-34b's gathered q, granite-moe's
    decode_32k on 16 x 16 (its D = 64 instance), paligemma-3b's on (1, 4)
    (D = 256) and zamba2-2.7b's shared block at long_500k (D = 80), with
    kv_len
    S, 0 (a rank that holds none of the positions), 1 and 700 ("lse",
    ``lse_case``). starcoder2-7b's one request at 32k on one card runs
    unsharded in bf16 ("long"): the existing instance at S = LONG_CACHE
    with kv_len S and 700, and the paged kernel over 2,048 pages of 16
    with the same lengths. Every decode case prints the splits a request
    its launch took (``decode_splits``, the wrapper's plan) beside its
    times; paligemma-3b's batch-1 decode over 8,192 rows (128 splits of
    one request, bf16 and f32) takes the kernel's two-level merge
    ("long" too). The yardstick is one
    F.scaled_dot_product_attention(..., enable_gqa=True) call on the same
    inputs, laid out as it wants them beforehand (for paged: a gather of
    the pages, dequantized for int8 pools, then the call)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import (decode_lengths,
                                                  decode_splits,
                                                  flash_decode_blocks,
                                                  flash_decode_cost,
                                                  flash_decode_paged,
                                                  flash_decode_paged_cost,
                                                  flash_decode_paged_plain,
                                                  flash_decode_plain,
                                                  paged_gather, sm_count)
    from repro_torch.kernels.flash_prefill import (flash_prefill_blocks,
                                                   flash_prefill_cost,
                                                   flash_prefill_plain)
    from repro_torch.serving.kvcache import quantize_kv
    # every flash_decode instance (D = 256's among them) must not spill;
    # of flash_prefill the D = 80 instances that hubert's encode takes (f32
    # at D = 32 spills 4 bytes, as it always has)
    kernel_ptxas("flash_decode")
    kernel_ptxas("flash_prefill", held="Li80E")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    Bd, KV, G, D = B, 4, 9, 128
    H = KV * G
    out = {"flash_decode": [], "flash_decode_paged": [], "flash_prefill": []}
    d80 = {"flash_decode": [], "flash_prefill": []}
    d256, bidir, lse, long = [], [], [], []
    sms = sm_count("cuda")
    spread = torch.linspace(1, CACHE, Bd, device="cuda").round().to(
        torch.int32)
    for dt in (torch.bfloat16, torch.float32):
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        tol = ATTN_TOL[tag]
        r = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)

        def decode(Bd, KV, G, D, S, kls):
            q, k, v = r(Bd, KV, G, D), r(Bd, S, KV, D), r(Bd, S, KV, D)
            qs = q.reshape(Bd, KV * G, 1, D)
            ks = k.transpose(1, 2).contiguous()
            vs = v.transpose(1, 2).contiguous()
            for name, kl in kls:
                lens = decode_lengths(kl, Bd, "cuda")
                mask = (torch.arange(S, device="cuda")[None, :]
                        < lens.long()[:, None])[:, None, None, :]
                out["flash_decode"].append(attn_case(
                    torch, flush, f"flash_decode {tag} ({Bd},{KV},{G},{D}) "
                    f"S={S} {name}",
                    lambda: flash_decode_blocks(q, k, v, kl),
                    lambda: flash_decode_plain(q, k, v, lens),
                    lambda: F.scaled_dot_product_attention(
                        qs, ks, vs, attn_mask=mask, enable_gqa=True), tol,
                    flash_decode_cost(q, k, v, kl),
                    nsplit=decode_splits(q, S, sms)))

        def prefill(Bp, Sp, H, KV, D, causal=True):
            q, k, v = r(Bp, Sp, H, D), r(Bp, Sp, KV, D), r(Bp, Sp, KV, D)
            qs = q.transpose(1, 2)
            ks, vs = k.transpose(1, 2), v.transpose(1, 2)
            out["flash_prefill"].append(attn_case(
                torch, flush, f"flash_prefill {tag} "
                f"{'causal' if causal else 'non-causal'} B={Bp} S={Sp} "
                f"H={H} KV={KV} D={D}",
                lambda: flash_prefill_blocks(q, k, v, causal=causal),
                lambda: flash_prefill_plain(q, k, v, causal),
                lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=causal, enable_gqa=True), tol,
                flash_prefill_cost(q, k, v, causal), iters=10))

        def paged(Bd, KV, G, D, S, page, name, kl, quant=False):
            """A shuffled pool of ``page``-row pages, tables S positions
            wide; entries past each request's pages are the scratch page
            0. ``quant``: int8 pools, (codes, scales) from quantize_kv of
            bf16 rows, which the kernel reads as D + 2 bytes a row and
            head."""
            lens = decode_lengths(kl, Bd, "cuda")
            nblk = -(-S // page)
            used = [-(-int(n) // page) for n in lens.tolist()]
            P = 1 + sum(used) + 8
            perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
            bt = torch.zeros((Bd, nblk), dtype=torch.int32, device="cuda")
            o = 0
            for b, u in enumerate(used):
                bt[b, :u] = perm[o:o + u].to(torch.int32)
                o += u
            q = r(Bd, KV, G, D)
            if quant:
                kp, vp = (quantize_kv(torch.randn(
                    (P, page, KV, D), generator=gen, device="cuda").to(
                        torch.bfloat16)) for _ in range(2))
            else:
                kp, vp = r(P, page, KV, D), r(P, page, KV, D)
            qs = q.reshape(Bd, KV * G, 1, D)
            mask = (torch.arange(nblk * page, device="cuda")[None, :]
                    < lens.long()[:, None])[:, None, None, :]

            def paged_sdpa():
                kk = paged_gather(kp, bt).to(dt).transpose(1, 2)
                vv = paged_gather(vp, bt).to(dt).transpose(1, 2)
                return F.scaled_dot_product_attention(
                    qs, kk, vv, attn_mask=mask, enable_gqa=True)
            out["flash_decode_paged"].append(attn_case(
                torch, flush, f"flash_decode_paged "
                f"{'int8 pools, ' if quant else ''}{tag}"
                f"{' q' if quant else ''} ({Bd},{KV},{G},{D}) "
                f"pages of {page}, {P} pages, nblk={nblk}, {name}",
                lambda: flash_decode_paged(q, kp, vp, bt, lens),
                lambda: flash_decode_paged_plain(q, kp, vp, bt, lens),
                paged_sdpa, tol,
                flash_decode_paged_cost(q, kp, vp, bt, lens),
                nsplit=decode_splits(q, nblk * page, sms, quant)))
            out["flash_decode_paged"][-1]["int8"] = quant

        decode(Bd, KV, G, D, CACHE, (("(B,) kv_len 1..1056", spread),
                                     ("scalar kv_len 700", 700)))
        paged(Bd, KV, G, D, CACHE, 16, "kv_len 1..1056", spread)
        for page, g in ((16, G), (8, G), (16, 48)):
            paged(Bd, KV if g == G else 1, g, D, CACHE, page,
                  "kv_len 1..1056", spread, quant=True)
        for Bp, Sp in ((1, 1024), (B, PROMPT), (1, 777)):
            prefill(Bp, Sp, H, KV, D)
        decode(Bd, 1, 48, D, CACHE, (("(B,) kv_len 1..1056", spread),))
        paged(Bd, 1, 48, D, CACHE, 16, "kv_len 1..1056", spread)
        for page in (8, 24):
            paged(Bd, KV, G, D, CACHE, page, "kv_len 1..1056", spread)
        for d in (16, 32, 64):
            prefill(1, 256, 8, 2, d)
            decode(1, 2, 4, d, 256, (("kv_len 200", 200),))
            paged(1, 2, 4, d, 256, 16, "kv_len 200", 200)
            paged(1, 2, 4, d, 256, 16, "kv_len 200", 200, quant=True)
        # the serving shapes of the configs since the MoE slice:
        # granite-moe (KV 8, G 2, D 64), qwen1.5-32b (KV 40, G 1),
        # deepseek-coder-33b (KV 8, G 7) and granite-34b (KV 1, G 48)
        for kv, g, dd in ((8, 2, 64), (40, 1, 128), (8, 7, 128),
                          (1, 48, 128)):
            if g != 48:     # G = 48's decode cases run above
                decode(Bd, kv, g, dd, CACHE,
                       (("(B,) kv_len 1..1056", spread),))
                paged(Bd, kv, g, dd, CACHE, 16, "kv_len 1..1056", spread)
                paged(Bd, kv, g, dd, CACHE, 8, "kv_len 1..1056", spread,
                      quant=True)
            for Bp, Sp in ((1, 1024), (B, PROMPT)):
                prefill(Bp, Sp, kv * g, kv, dd)
        # zamba2-2.7b's shared block: 32 heads of 80, G = 1
        n0 = {k: len(out[k]) for k in d80}
        decode(Bd, 32, 1, 80, CACHE, (("(B,) kv_len 1..1056", spread),
                                      ("scalar kv_len 700", 700)))
        for Bp, Sp in ((1, 1024), (1, 777), (B, PROMPT)):
            prefill(Bp, Sp, 32, 32, 80)
        for k in d80:
            d80[k] += out[k][n0[k]:]
        # paligemma-3b's decode: 8 heads of 256 over one KV head, the
        # lanes' 1056 rows after the 256-row prefix (each lane holds the
        # prefix and a token at least); hubert-xlarge's encode: 16 heads
        # of 80, bidirectional
        n0 = len(out["flash_decode"])
        S256 = CACHE + VLM_PREFIX
        lanes = torch.linspace(VLM_PREFIX + 1, S256, Bd,
                               device="cuda").round().to(torch.int32)
        decode(Bd, 1, 8, 256, S256,
               ((f"(B,) kv_len {VLM_PREFIX + 1}..{S256}", lanes),
                (f"scalar kv_len {700 + VLM_PREFIX}", 700 + VLM_PREFIX)))
        d256 += out["flash_decode"][n0:]
        # paligemma-3b's batch-1 decode over 8,192 rows: 128 splits of one
        # request, whose merge goes in two levels (chunks of 8 splits)
        n0 = len(out["flash_decode"])
        decode(1, 1, 8, 256, 8192, (("kv_len 8192", 8192),
                                    ("scalar kv_len 700", 700)))
        long += out["flash_decode"][n0:]
        n0 = len(out["flash_prefill"])
        for Bp, Sp in ((B, ENCODE_FRAMES), (1, 777)):
            prefill(Bp, Sp, 16, 16, 80, causal=False)
        bidir += out["flash_prefill"][n0:]
        if dt == torch.bfloat16:
            # starcoder2-7b's one request at 32k on one card, unsharded:
            # the existing instance over a contiguous cache, and over
            # 2,048 pages of 16
            n0 = {k: len(out[k]) for k in ("flash_decode",
                                            "flash_decode_paged")}
            decode(1, KV, G, D, LONG_CACHE,
                   ((f"kv_len {LONG_CACHE}", LONG_CACHE),
                    ("scalar kv_len 700", 700)))
            for kl in (LONG_CACHE, 700):
                paged(1, KV, G, D, LONG_CACHE, 16, f"kv_len {kl}", kl)
            for k in n0:
                long += out[k][n0[k]:]
        for Bl, kv, g, dd, Sl in LSE_SHAPES:
            q, k, v = r(Bl, kv, g, dd), r(Bl, Sl, kv, dd), r(Bl, Sl, kv, dd)
            for kl in (Sl, 0, 1, 700):
                lse.append(lse_case(
                    torch, flush, f"flash_decode log-sum-exp {tag} "
                    f"({Bl},{kv},{g},{dd}) S={Sl} kv_len {kl}", q, k, v, kl))
    for D, why in ((80, "the hybrid family"), (256, "the vision family")):
        q = torch.zeros((1, 2, 1, D), dtype=torch.bfloat16, device="cuda")
        pool = torch.zeros((2, 16, 2, D), dtype=torch.bfloat16,
                           device="cuda")
        try:
            flash_decode_paged(q, pool, pool, torch.ones(
                (1, 1), dtype=torch.int32, device="cuda"), 1)
        except ValueError as e:
            print(f"[kernels] flash_decode_paged refuses D = {D} on the card"
                  f" (no path pages such a cache: the paged engine refuses "
                  f"{why}): {e}", flush=True)
        else:
            fail(f"flash_decode_paged accepted D = {D}, which no path pages "
                 "and no case holds")
    out["d80"] = d80
    out["d256"] = d256
    out["bidir"] = bidir
    out["lse"] = lse
    out["long"] = long
    return out


def masked_update_kernels(torch, flush):
    """masked_update at the stacked (32, 4608, 18432) w_up leaf, 1% mask,
    alpha = -3e-4: f32 W with a bool mask (the hook path's), bf16 W with a
    bool mask, f32 W with an f32 mask (the reference's masks), each held
    bit for bit against its plain version. The plain version runs layer by
    layer, on a copy of W: its f32 temporaries of the whole leaf would not
    fit beside it. The yardstick is one w.addcmul_(m, v) call on the same
    inputs (addcmul_ promotes a bool m). The bound reads W, M and V whole
    (a NaN in V or a -0 in W changes W off the mask too) and writes only
    the 32-byte sectors of W that hold a masked entry, counted on this
    run's mask: the update is in place."""
    from repro_torch.kernels.masked_update import (masked_update,
                                                   masked_update_cost,
                                                   masked_update_plain,
                                                   written_sectors)
    L, d, f = 32, 4608, 18432
    n = L * d * f
    alpha = -3e-4
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    mask = torch.empty((L, d, f), dtype=torch.bool, device="cuda")
    for i in range(L):
        mask[i] = torch.rand((d, f), generator=gen, device="cuda") < MU_DENSITY
    v = torch.randn((L, d, f), generator=gen, device="cuda")
    out = {}

    def case(label, w, m):
        bits = torch.int32 if w.dtype == torch.float32 else torch.int16
        w0, first = w.clone(), w[0].clone()
        masked_update(w, m, v, alpha)
        for i in range(L):
            masked_update_plain(w0[i], m[i], v[i], alpha)
        torch.cuda.synchronize()
        err = max(float((w[i].float() - w0[i].float()).abs().max())
                  for i in range(L))
        equal = all(bool(torch.equal(w[i].view(bits), w0[i].view(bits)))
                    for i in range(L))
        on = m[0].bool()        # the update moves masked entries only
        moved = bool((w[0] != first)[on].any()) and bool(torch.equal(
            w[0][~on].view(bits), first[~on].view(bits)))
        del first
        per = 32 // w.element_size()        # W entries a 32-byte sector
        sectors = written_sectors(w, m)
        if not equal or err != 0.0 or not moved:
            fail(f"masked_update {label}: not bit-equal to its plain version"
                 f" (max_abs_err {err})")
        r = {"max_abs_err": err,
             "ms": cold_ms(torch, lambda: masked_update(w, m, v, alpha), 10,
                           flush),
             "plain_ms": cold_ms(torch, lambda: [masked_update_plain(
                 w0[i], m[i], v[i], alpha) for i in range(L)], 2, flush),
             "library_ms": cold_ms(torch, lambda: w.addcmul_(
                 m, v, value=alpha), 10, flush),
             **bound_of(masked_update_cost(w, m, v, alpha))}
        print(f"[kernels] masked_update ({L}, {d}, {f}) {label}, "
              f"{int(m[0].count_nonzero())} of {d * f} entries a layer, "
              f"{sectors} of {n // per} W sectors written: "
              f"max_abs_err={err} bit-equal={equal} ms={r['ms']:.4f} "
              f"plain_ms(layer by layer)={r['plain_ms']:.3f} "
              f"library_ms(addcmul_)={r['library_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
        out[label] = r
        del w0

    w = torch.randn((L, d, f), generator=gen, device="cuda")
    case("f32 W, bool M", w, mask)
    del w
    w = torch.randn((L, d, f), generator=gen, device="cuda").to(
        torch.bfloat16)
    case("bf16 W, bool M", w, mask)
    del w
    mask_f = mask.float()
    del mask
    torch.cuda.empty_cache()
    w = torch.randn((L, d, f), generator=gen, device="cuda")
    case("f32 W, f32 M", w, mask_f)
    del w, mask_f, v
    return out


def with_patches(torch, cfg, batch, gen=None):
    """``batch`` with a vision model's patch embeddings (B, prefix_rows,
    d_model) f32 on the card: zeros, as the serve CLI and the lane engine
    give a request, or with ``gen`` N(0, 1) draws; another model's batch
    as it is."""
    if not cfg.prefix_rows:
        return batch
    shape = (batch["tokens"].shape[0], cfg.prefix_rows, cfg.d_model)
    return {**batch, "patch_embeds": (
        torch.zeros(shape, device="cuda") if gen is None else
        torch.randn(shape, generator=gen, device="cuda"))}


SERVE_MODES = (("sequential", [], ("scatter_apply",)),
               ("fuse", ["--fuse"], ("scatter_apply",)),
               ("multi-tenant f32", ["--multi-tenant", "--skew", "0.8"],
                ("sidedelta", "scatter_apply")),
               ("multi-tenant int8", ["--multi-tenant", "--int8", "--skew",
                                      "0.8"], ("sidedelta", "scatter_apply")))


def serve_phase(torch, arch="starcoder2-7b", layers=0, modes=SERVE_MODES,
                tag="serve"):
    """``arch`` at full width (cut to ``layers`` when given) through
    launch.serve in each of ``modes``: launch counts zeroed before each
    mode, every kernel of its path launched; an MoE model's routing must
    drop no choice (every call is under 512 tokens)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.moe import count_drops
    cfg = get_config(arch)
    common = ["--arch", arch, "--batch", str(B), "--prompt-len",
              str(PROMPT), "--tokens", str(TOKENS), "--adapters", "3"] + (
                  ["--layers", str(layers)] if layers else [])
    attn, absent = attention_kernels(cfg, "flash_prefill", "flash_decode")
    totals = {}
    torch.cuda.reset_peak_memory_stats()
    for label, extra, needed in modes:
        zero_counts()
        t0 = time.perf_counter()
        with count_drops() as drops:
            stats = serve.main(common + extra)
        torch.cuda.synchronize()
        counts = {k: v for k, v in read_counts().items() if v}
        out = stats["last_out"]
        ok = (out.shape == (B, TOKENS) and int(out.min()) >= 0
              and int(out.max()) < cfg.vocab_size)
        if "table_bytes" in stats:
            extra_info = (f"tables {stats['table_bytes'] / 1e9:.2f} GB, "
                          f"{stats['tok_s']:.1f} tok/s, "
                          f"{stats['fuse_transitions']} fuse transitions")
        else:
            tok_s = {k: round(v, 1) for k, v in stats["tok_s"].items()}
            extra_info = (f"switch ms "
                          f"{[round(x, 3) for x in stats['switch_ms']]}, "
                          f"tok/s {tok_s}")
        dropped = int(sum(int(d) for d in drops))
        moe_info = (f", routing: {len(drops)} MoE calls, {dropped} dropped "
                    "choices" if cfg.family == "moe" else "")
        print(f"[{tag}] {arch} {label}: launches {counts}, {extra_info}"
              f"{moe_info}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB, "
              f"{time.perf_counter() - t0:.1f}s wall", flush=True)
        if not ok:
            fail(f"{tag} {label}: tokens out of range or misshapen")
        if dropped:
            fail(f"{tag} {label}: {dropped} routing choices dropped in "
                 "drop-free calls")
        check_run(f"{tag} {label}", read_counts(), needed + attn, totals,
                  absent)
        del stats, out                 # the next mode builds its own model
        torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[{tag}] peak memory {peak:.1f} GB (max_memory_allocated)",
          flush=True)
    if any("--multi-tenant" not in extra for _, extra, _ in modes):
        b, entries, sectors = switch_bound(
            torch, cfg.replace(num_layers=layers) if layers else cfg)
        print(f"[{tag}] a switch's bound (one adapter load, {entries} "
              f"entries, {sectors} W sectors read and written): "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']})", flush=True)
    torch.cuda.empty_cache()
    return totals


def continuous_trace(vocab: int, packs):
    """The full-width request trace, from seed 0: 24 requests, prompt
    lengths uniform in 64..1024, 12 of the prompts at least 257 tokens long
    beginning with one 256-token system prefix; adapters drawn as
    ``serve --multi-tenant`` draws them (skew 0.8 to the first, the rest
    over the others and the base model), and requests 5 and 17 on the base
    model. Returns [(prompt int32, adapter)]."""
    import numpy as np
    from repro_torch.launch.serve import tenant_mix
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 1025, CC_REQUESTS)
    prefix = rng.integers(0, vocab, 256).astype(np.int32)
    shared = [i for i in range(CC_REQUESTS) if lens[i] > 256][:12]
    adapters = [tenant_mix(rng, packs, 1, 0.8)[0]
                for _ in range(CC_REQUESTS)]
    for i in (5, 17):
        adapters[i] = None
    trace = []
    for i, n in enumerate(lens):
        p = rng.integers(0, vocab, int(n)).astype(np.int32)
        if i in shared:
            p[:256] = prefix
        trace.append((p, adapters[i]))
    return trace


def drive(torch, engine, trace, max_tokens, profile_from=5):
    """Submit the whole trace at once, then step the engine until every
    request resolved; returns (futures, wall seconds, peak resident
    requests, per-step numbers, profiles), synchronized. Each step's
    host-clock time is kept with whether it admitted a request (lanes) or
    ran a prefill chunk (pages). Engine step ``profile_from`` runs under
    torch.profiler, and after it each step that follows a step of a kind
    (decode-only, or with a prefill) not yet profiled, since kinds come in
    runs: profiles maps "decode-only" and "prefill" to (engine step,
    profile), the first of each; profiled steps are left out of the
    per-step times."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = [engine.submit(p, a, max_tokens=max_tokens) for p, a in trace]
    peak, steps, profs, last = 0, [], {}, None
    while engine.pending():
        admitted = sum(f.submitted_step is not None for f in futs)
        chunks = getattr(engine, "prefill_chunks", 0)
        at = engine.step_count
        ts = time.perf_counter()
        prof = None
        if at == profile_from or (at > profile_from
                                  and last not in profs):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                engine.step()
                torch.cuda.synchronize()
        else:
            engine.step()
            torch.cuda.synchronize()
        wall = time.perf_counter() - ts
        prefilled = (sum(f.submitted_step is not None for f in futs)
                     > admitted
                     or getattr(engine, "prefill_chunks", 0) > chunks)
        last = "prefill" if prefilled else "decode-only"
        if prof is None:
            steps.append((wall, prefilled))
        else:
            profs.setdefault(last, (at + 1, prof))
        peak = max(peak, sum(a is not None for a in engine._active))
    torch.cuda.synchronize()
    return futs, time.perf_counter() - t0, peak, steps, profs


def step_report(label, steps, profs):
    """Median host-clock ms of decode-only steps and of steps that
    prefilled, and each profiled step's device time by kernel."""
    import statistics
    import torch
    dec = [t for t, pf in steps if not pf]
    pre = [t for t, pf in steps if pf]
    med = lambda xs: statistics.median(xs) * 1e3 if xs else float("nan")
    line = (f"[continuous] {label} steps (profiled ones left out): "
            f"{len(dec)} decode-only, median {med(dec):.1f} ms; {len(pre)} "
            f"with a prefill, median {med(pre):.1f} ms")
    print(line, flush=True)
    for kind, (at, prof) in sorted(profs.items()):
        kern = device_kernels(torch, prof)
        busy = sum(k[0] for k in kern)
        print(f"[profile] {label} engine step {at}, {kind} (profiler on): "
              f"kernels {busy:.2f} ms" + ("" if busy else
                                          " (profiler saw no device time: "
                                          "not measured)"), flush=True)
        for ms, n, name in sorted(kern, reverse=True)[:6]:
            print(f"[profile]   {ms:8.3f} ms  x{n:<5d} {name[:90]}")
        kernel_share(f"{label} step {at}", kern)


def hold_as_asked(label, health, retries, futs):
    """Fail unless a run with no fault injected served every request as
    it asked. The engines walk the fallback ladder by default, so a real
    load failure (an OSError, a CRC mismatch, a dead prefetch worker)
    would otherwise finish its request on an older version or the base
    model with in-range tokens: no request may be degraded or end with an
    error, the engine's shed/degraded/poisoned/failed counters stay 0, no
    load was retried and nothing is quarantined. ``health`` is the
    engine's ``health()``, ``retries`` its store's (0 without one)."""
    bad = [i for i, f in enumerate(futs) if f.degraded or f.error is not None]
    counters = {k: health[k] for k in ("shed", "degraded", "poisoned",
                                       "failed") if health[k]}
    if bad or counters or retries or health["quarantined"]:
        fail(f"{label}: a run without injected faults did not serve every "
             f"request as asked: requests {bad} degraded or failed, "
             f"counters {counters}, store retries {retries}, quarantined "
             f"{health['quarantined']}")


def store_retries(engine):
    store = engine.engine.store
    return store.retries if store is not None else 0


def report_engine(torch, label, engine, futs, wall, peak, vocab, needed,
                  totals, tag="continuous", absent=()):
    """Print one engine's numbers and fail unless every future is done
    with in-range tokens and every kernel of its path launched."""
    import numpy as np
    counts = read_counts()
    ttft = np.array([f.ttft for f in futs])
    kv_gb = engine.kv_cache_bytes() / 1e9
    outs = [f.result() for f in futs]
    ok = all(f.done() and f.error is None for f in futs) and all(
        len(o) == CC_TOKENS and 0 <= int(o.min()) and int(o.max()) < vocab
        for o in outs)
    extra = ""
    if hasattr(engine, "pool"):
        extra = (f", COW copies {engine.pool.cow_copies}, prefill chunks "
                 f"{engine.prefill_chunks}, prefix hits "
                 f"{engine.pool.prefix_hits} ({engine.pool.prefix_shared_tokens}"
                 f" tokens), peak pages {engine.peak_used_pages}")
    print(f"[{tag}] {label}: {len(futs)} requests, {engine.tokens_out} "
          f"tokens in {wall:.2f}s ({engine.tokens_out / wall:.1f} tok/s), "
          f"TTFT p50 {np.percentile(ttft, 50):.3f}s p99 "
          f"{np.percentile(ttft, 99):.3f}s, {engine.step_count} decode steps,"
          f" {engine.decode_slot_waste} idle-lane steps, peak resident "
          f"{peak} requests, KV {kv_gb:.3f} GB ({peak / kv_gb:.1f} resident "
          f"requests per GB){extra}, launches "
          f"{ {k: v for k, v in counts.items() if v} }, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB", flush=True)
    if not ok:
        fail(f"{tag} {label}: a request failed or its tokens are out of "
             "range")
    hold_as_asked(f"{tag} {label}", engine.health(), store_retries(engine),
                  futs)
    check_run(f"{tag} {label}", counts, needed, totals, absent)
    return outs


def continuous_int8_report(outs, kv, mla=False):
    """The int8-KV paged run beside the bf16 one: KV bytes (held to at
    most KV_INT8_MAX of bf16's), resident requests per GB of KV, the
    paged kernel's launches (all through its int8 instance, and more than
    0; with ``mla`` none: MLA's latent pages are read by plain torch), and
    how many requests give the bf16 pools' tokens (reported, not
    held)."""
    (b_bytes, b_peak, _, _), (q_bytes, q_peak, q_launch, q_int8) = (
        kv["PagedServingEngine"], kv["PagedServingEngine int8 KV"])
    a, b = outs["PagedServingEngine"], outs["PagedServingEngine int8 KV"]
    same = sum(bool((x == y).all()) for x, y in zip(a, b))
    first = sum(int(x[0]) == int(y[0]) for x, y in zip(a, b))
    ratio = q_bytes / b_bytes
    print(f"[continuous-int8] KV {q_bytes / 1e9:.4f} GB int8 against "
          f"{b_bytes / 1e9:.4f} GB bf16 ({ratio:.4f}); resident requests "
          f"per GB of KV {q_peak / (q_bytes / 1e9):.1f} against "
          f"{b_peak / (b_bytes / 1e9):.1f}; flash_decode_paged launches "
          f"{q_launch}, of them the int8 instance {q_int8}; against the bf16 "
          f"pools: {same}/{len(a)} requests token-equal, {first}/{len(a)} "
          f"first tokens equal (reported, not held)", flush=True)
    if ratio > KV_INT8_MAX:
        fail(f"continuous-int8: KV bytes {ratio:.4f} of bf16's > "
             f"{KV_INT8_MAX}")
    if (q_launch != 0) if mla else not 0 < q_launch == q_int8:
        fail(f"continuous-int8: flash_decode_paged launched {q_launch} "
             f"times, {q_int8} through the int8 instance")


def kv_row_bytes(cfg, quant: bool) -> int:
    """KV bytes a token and layer: K and V (KV heads x head_dim each), or
    MLA's latents (rank + rope), bf16; int8 with a bf16 scale a row and
    head."""
    import math
    from repro_torch.models import lm
    return sum(math.prod(t) + 2 * math.prod(t[:-1]) if quant
               else 2 * math.prod(t) for t in lm.kv_tails(cfg))


def state_bytes(cfg) -> int:
    """A request's bytes a layer of a mamba stage, whatever its length:
    the f32 SSM state (H x P x N) and the two conv windows (d_conv - 1
    rows of d_inner and of 2 g n) in bf16."""
    from repro_torch.models.mamba2 import dims
    d_inner, heads, bc = dims(cfg)
    s = cfg.ssm
    return (heads * s.head_dim * s.d_state * 4
            + (s.d_conv - 1) * (d_inner + bc) * 2)


def residency_report(tag):
    """Resident requests per GB of KV (a mamba model's: of state) of each
    engine beside the other archs' runs in this process, and the KV bytes
    a token and layer (the state bytes a request and layer)."""
    from repro_torch.configs import get_config
    archs = list(dict.fromkeys(a for a, _ in RESIDENCY))
    for a in archs:
        c = get_config(a)
        runs = {e: round(v, 1) for (x, e), v in RESIDENCY.items() if x == a}
        if c.family == "hybrid":
            g = c.num_layers // c.hybrid_attn_every
            st, kvt = state_bytes(c) * c.num_layers, kv_row_bytes(c, False)
            print(f"[{tag}] resident requests per GB of state and KV, {a}: "
                  f"{runs}; a request's state {st} bytes over "
                  f"{c.num_layers} mamba layers ({state_bytes(c)} a layer) "
                  f"and KV {kvt * g} bytes a token over the shared block's "
                  f"{g} sites ({kvt} a site), bf16: a {CACHE}-row lane "
                  f"{st + CACHE * kvt * g} bytes, "
                  f"{1e9 / (st + CACHE * kvt * g):.2f} lanes per GB",
                  flush=True)
            continue
        if c.family == "ssm":
            per = state_bytes(c) * c.num_layers
            print(f"[{tag}] resident requests per GB of state, {a}: {runs};"
                  f" state bytes a request and layer {state_bytes(c)} (f32 "
                  f"state, bf16 conv windows), {per} a request over "
                  f"{c.num_layers} layers: {1e9 / per:.2f} requests per GB "
                  f"whatever the length", flush=True)
            continue
        print(f"[{tag}] resident requests per GB of KV, {a}: {runs}; KV "
              f"bytes a token and layer {kv_row_bytes(c, False)} bf16, "
              f"{kv_row_bytes(c, True)} int8", flush=True)


def paged_refused(torch, cfg, params, tag):
    """Fail unless PagedServingEngine refuses ``cfg`` (a family with no
    paged cache) with the reference's NotImplementedError."""
    from repro_torch.hub import PagedServingEngine
    try:
        PagedServingEngine(cfg, params, slots=B, num_pages=321,
                           page_size=16, chunk_size=CHUNK)
    except NotImplementedError as e:
        if "paged" not in str(e):
            fail(f"{tag}: PagedServingEngine refused {cfg.name} with "
                 f"another message: {e}")
        print(f"[{tag}] {cfg.name} PagedServingEngine refused, as the "
              f"reference's: NotImplementedError({str(e)!r})", flush=True)
        return
    fail(f"{tag}: PagedServingEngine accepted {cfg.name}")


def has_pages(cfg) -> bool:
    """Whether the paged engine serves ``cfg``: the dense and MoE families
    (``lm.init_paged_cache`` refuses the others, as the reference's
    does)."""
    return cfg.family in ("dense", "moe")


def continuous_phase(torch, arch="starcoder2-7b", tag="continuous",
                     layers=0):
    """Continuous batching at full width: ``serve --continuous --int8``
    (the CLI, int8 packs and tables), then the 24-request trace through
    ServingEngine (8 lanes of 1056 rows), PagedServingEngine (8 slots,
    321 pages of 16 rows, about 61% of the lanes' KV bytes, chunks of 256)
    and PagedServingEngine(quant_kv=True) (the same pages as int8 codes
    and bf16 scales: continuous-int8) over an AdapterStore of 3 f32 packs
    in a temporary directory, one engine after the other on one copy of
    the base. An MoE model's dropped routing choices are counted per
    engine: the lanes admit a prompt of over 512 tokens in one call, whose
    capacity may drop choices (the reference's too), the pages' chunks
    and every decode step are drop-free. A family with no paged cache
    (``has_pages``; Mamba2's state is O(1) a request) runs on the lanes
    alone, and the paged engine must refuse the model. A vision model's
    lanes hold its patch prefix's rows besides (1056 + 256), and each
    request is admitted with zero patch embeddings."""
    import tempfile
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.hub import AdapterStore, PagedServingEngine, ServingEngine
    from repro_torch.kernels.flash_decode import flash_decode_paged
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.models.moe import count_drops
    totals = {}
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    lane_rows = CACHE + cfg.prefix_rows
    attn_dec, absent = attention_kernels(cfg, "flash_prefill",
                                         "flash_decode")
    attn_paged, _ = attention_kernels(cfg, "flash_decode_paged")
    paged = has_pages(cfg)
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = serve.main(["--arch", arch, "--continuous", "--int8",
                        "--requests", str(B), "--slots", str(B),
                        "--prompt-len", "64", "--tokens", "8",
                        "--adapters", "3", "--skew", "0.8"] + (
                            ["--layers", str(layers)] if layers else []))
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"[{tag}] {arch} serve --continuous --int8 ({B} requests, prompt 64,"
          f" 8 tokens, {B} lanes): {stats['done']}/{stats['requests']} done,"
          f" {stats['tok_s']:.1f} tok/s, {stats['steps']} decode steps, "
          f"launches { {k: v for k, v in counts.items() if v} }, "
          f"{time.perf_counter() - t0:.1f}s wall", flush=True)
    if stats["done"] != stats["requests"] or any(
            int(o.min()) < 0 or int(o.max()) >= cfg.vocab_size
            for o in stats["outs"]):
        fail("serve --continuous: a request failed or is out of range")
    hold_as_asked("serve --continuous", stats["health"],
                  stats["store_retries"], stats["futs"])
    check_run("serve --continuous", counts, attn_dec + ("sidedelta",),
              totals, absent)
    del stats
    torch.cuda.empty_cache()

    params = lm.init_params(cfg, seed=0, device="cuda")
    packs = serve.make_adapters(cfg, params, 3, multi_tenant=True)
    trace = continuous_trace(cfg.vocab_size, packs)
    with tempfile.TemporaryDirectory(prefix="adapter-store-") as root:
        t0 = time.perf_counter()
        store = AdapterStore(root)
        for p in packs:
            store.add(p)
        del packs
        torch.cuda.empty_cache()
        print(f"[{tag}] store: {len(store.names())} f32 packs written in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        outs, kv = {}, {}
        engines = [
            ("ServingEngine", lambda: ServingEngine(
                cfg, params, slots=B, cache_size=lane_rows, store=store),
             attn_dec + ("sidedelta",))]
        if paged:
            engines += [
                ("PagedServingEngine", lambda: PagedServingEngine(
                    cfg, params, slots=B, num_pages=321, page_size=16,
                    chunk_size=CHUNK, store=store),
                 attn_paged + ("sidedelta",)),
                ("PagedServingEngine int8 KV", lambda: PagedServingEngine(
                    cfg, params, slots=B, num_pages=321, page_size=16,
                    chunk_size=CHUNK, store=store, quant_kv=True),
                 attn_paged + ("sidedelta",))]
        for label, make, needed in engines:
            zero_counts()
            flash_decode_paged.int8_launches = 0
            torch.cuda.reset_peak_memory_stats()
            engine = make()
            with count_drops() as drops:
                futs, wall, peak, steps, profs = drive(torch, engine, trace,
                                                       CC_TOKENS)
            if hasattr(engine, "peak_resident"):
                peak = engine.peak_resident
            outs[label] = report_engine(torch, f"{arch} {label}", engine,
                                        futs, wall, peak, cfg.vocab_size,
                                        needed, totals, tag, absent)
            RESIDENCY[(arch, label)] = peak / (engine.kv_cache_bytes() / 1e9)
            if cfg.family == "moe":
                print(f"[{tag}] {arch} {label} routing: {len(drops)} MoE "
                      f"calls, {sum(int(d) for d in drops)} dropped choices",
                      flush=True)
            kv[label] = (engine.kv_cache_bytes(), peak,
                         flash_decode_paged.launches,
                         flash_decode_paged.int8_launches)
            step_report(f"{arch} {label}", steps, profs)
            del engine, futs
            torch.cuda.empty_cache()
    if not paged:
        paged_refused(torch, cfg, params, tag)
        residency_report(tag)
        del params
        return totals
    continuous_int8_report(outs, kv, mla=cfg.attn_type == "mla")
    residency_report(tag)
    pairs = list(zip(outs["ServingEngine"], outs["PagedServingEngine"]))
    same = sum(bool((a == b).all()) for a, b in pairs)
    first = sum(int(a[0]) == int(b[0]) for a, b in pairs)
    split = {i: int(np.argmax(a != b)) for i, (a, b) in enumerate(pairs)
             if not (a == b).all()}
    print(f"[{tag}] {arch} bf16: {same}/{len(trace)} requests token-equal "
          f"across the two engines, {first}/{len(trace)} first tokens equal;"
          f" request: first differing token {split}", flush=True)
    del params
    return totals


def continuous_consistency_phase(torch, arch="starcoder2-7b", long=601,
                                 tag="continuous-consistency", quant=False):
    """Both engines against the fixed batch: full widths cut to 2 layers,
    f32. Each request's tokens from ServingEngine and PagedServingEngine
    must equal its own MultiTenantEngine.generate tokens, on a trace with
    a shared prefix (COW), one prompt under two adapters, an adapter
    stack, the base model and a ``long`` prompt that the paged engine
    prefills in chunks of up to 256 (an MoE model's at most 512 tokens,
    so that the fixed batch's one-call prefill drops no routing choice,
    as the chunks do not); the paged engine must share prefix pages and
    copy on write. With ``quant`` a third run on int8 pages must give
    each request the tokens of the same engine on the CPU (the port's
    plain path, which tests/test_torch_mla_serving.py holds to the JAX
    paged engine's int8 tokens); against the fixed batch its first and
    whole tokens are counted, not held: a chunk attends to its own
    latents quantized, so a near tie may flip (the reference's engine
    flips them too). A family with no paged cache (``has_pages``: Mamba2)
    runs on the lanes alone, on a trace that adds prompts of 1 and 2
    tokens (shorter than its conv window), and the paged engine must
    refuse the model. A vision model's fixed batch gives each request the
    zero patch embeddings its lane gives it, before its prompt."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.masks import map_leaves
    from repro_torch.hub import PagedServingEngine, ServingEngine
    from repro_torch.launch import serve
    from repro_torch.models import layers, lm
    from repro_torch.serving import MultiTenantEngine
    cfg = two_layers(get_config(arch))
    paged = has_pages(cfg)
    T = 8
    rng = np.random.default_rng(7)
    tok = lambda n: rng.integers(0, cfg.vocab_size, n).astype(np.int32)
    prefix = tok(40)
    first = (np.concatenate([prefix, tok(10)]), "adapter_0")
    same = tok(37)
    rest = [(np.concatenate([prefix, tok(23)]), "adapter_0"),
            (same, "adapter_1"), (same, "adapter_2"),
            (tok(70), ("adapter_0", "adapter_1")), (tok(19), None),
            (tok(long), "adapter_1"), first]
    if not paged:
        rest += [(tok(1), "adapter_2"), (tok(2), None)]
    trace = [first] + rest
    with layers.compute_precision(torch.float32):
        params = lm.init_params(cfg, seed=0, device="cuda")
        packs = serve.make_adapters(cfg, params, 3, multi_tenant=True)
        mt = MultiTenantEngine(cfg, params)
        for p in packs:
            mt.register(p)
        want = [mt.generate(with_patches(torch, cfg, {
            "tokens": torch.from_numpy(p[None].copy()).to("cuda")}), [a],
            T)[0][0].cpu().numpy() for p, a in trace]
        se = ServingEngine(cfg, params, slots=3,
                           cache_size=640 + cfg.prefix_rows)
        for p in packs:
            se.register(p)
        lane = [se.submit(p, a, max_tokens=T) for p, a in trace]
        se.run()
        runs = [("ServingEngine", lane, se)]
        if paged:
            pe = PagedServingEngine(cfg, params, slots=3, num_pages=80,
                                    page_size=16, chunk_size=256)
            for p in packs:
                pe.register(p)
            # the first request's prompt pages are registered before the
            # rest arrive, so they can share its prefix
            pf = [pe.submit(*first, max_tokens=T)]
            while not pf[0].tokens:
                pe.step()
            pf += [pe.submit(p, a, max_tokens=T) for p, a in rest]
            pe.run()
            runs.append(("PagedServingEngine", pf, pe))
        else:
            paged_refused(torch, cfg, params, tag)
        if quant:
            qe = PagedServingEngine(cfg, params, slots=3, num_pages=80,
                                    page_size=16, chunk_size=256,
                                    quant_kv=True)
            for p in packs:
                qe.register(p)
            q8 = [qe.submit(p, a, max_tokens=T) for p, a in trace]
            qe.run()
    if quant:
        hold_as_asked(f"{tag} int8 pages", qe.health(), 0, q8)
        t0 = time.perf_counter()
        with layers.compute_precision(torch.float32):
            qc = PagedServingEngine(cfg, map_leaves(lambda _, x: x.cpu(),
                                                    params),
                                    slots=3, num_pages=80, page_size=16,
                                    chunk_size=256, quant_kv=True)
            for p in packs:
                qc.register(p)
            c8 = [qc.submit(p, a, max_tokens=T) for p, a in trace]
            qc.run()
        cpu_s = time.perf_counter() - t0
        same = [bool(np.array_equal(f.result(), g.result()))
                for f, g in zip(q8, c8)]
        firsts = sum(int(f.result()[0]) == int(w[0]) for f, w in zip(q8, want))
        whole = sum(bool(np.array_equal(f.result(), w))
                    for f, w in zip(q8, want))
        print(f"[{tag}] {arch} f32, {cfg.num_layers} layers, full width, "
              f"PagedServingEngine int8 pages: {sum(same)}/{len(same)} "
              f"requests token-equal to the same engine on the CPU (held; "
              f"CPU {cpu_s:.1f}s); against the fixed batch {firsts}/"
              f"{len(want)} first tokens and {whole}/{len(want)} requests "
              f"equal (reported)", flush=True)
        if not all(same):
            fail(f"{tag}: {arch} int8 pages on the card differ from the CPU "
                 f"on requests {[i for i, e in enumerate(same) if not e]}")
    for label, futs, eng in runs:
        hold_as_asked(f"{tag} {label}", eng.health(), 0, futs)
        equal = [bool(np.array_equal(f.result(), w))
                 for f, w in zip(futs, want)]
        print(f"[{tag}] {arch} f32, {cfg.num_layers} layers, full width, "
              f"{label}: {sum(equal)}/{len(equal)} requests token-equal to "
              f"the fixed batch", flush=True)
        if not all(equal):
            fail(f"{tag}: {arch} {label} differs from the fixed "
                 f"batch on requests "
                 f"{[i for i, e in enumerate(equal) if not e]}")
    if not paged:
        return
    print(f"[{tag}] {arch} paged: prefix hits "
          f"{pe.pool.prefix_hits} ({pe.pool.prefix_shared_tokens} tokens), "
          f"COW copies {pe.pool.cow_copies}, prefill chunks "
          f"{pe.prefill_chunks}", flush=True)
    if pe.pool.prefix_hits < 2 or pe.pool.cow_copies < 1:
        fail(f"{tag}: the paged engine did not share the "
             "prefix pages or copy on write")


PZ_PUBLISH_STEP = 10     # personalization: adapter_0@2 after this step
PZ_LANES = B             # 8 lanes, as the continuous phase
PZ_LAYERS = 8            # a quarter of starcoder2-7b's depth, for the
                         # script's time limit
PZ_TRACES = {}           # (engine, async_prefetch) -> the run's events
                         # and wall seconds, which the analysis phase
                         # replays


def pz_store(root, files, one):
    """A store over the three published adapter_i@1 files: a resident
    budget of one pack (the others are cold) and a pinned staging tier of
    two."""
    from repro_torch.hub import AdapterStore
    store = AdapterStore(root, budget_bytes=int(1.5 * one),
                         staging_bytes=int(2.5 * one))
    for f in files:
        store.register_file(f)
    return store


def pz_drive(torch, engine, store, trace_reqs, v2, max_tokens):
    """Submit the first half of the trace, step the engine, publish v2 (as
    adapter_0's next version) after step PZ_PUBLISH_STEP and submit the
    rest, then step until every request resolved. Returns (futures, wall
    seconds, per-step (wall s, prefilled, build in flight), the steps at
    which a request on adapter_0@1 was still open and adapter_0@1 had left
    the engine, peak staged bytes)."""
    from repro_torch.analysis import trace
    half = len(trace_reqs) // 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = [engine.submit(p, a, max_tokens=max_tokens)
            for p, a in trace_reqs[:half]]
    steps, early, staged, published = [], [], 0, False
    mt = engine.engine
    while engine.pending() or not published:
        if not published and (engine.step_count >= PZ_PUBLISH_STEP
                              or not engine.pending()):
            # the operator's publish (the pack written to the store) and
            # the second half's submits, on the serving thread: a span of
            # the harness's own, so that a replay attributes their time
            with trace.span("publish", cat="harness"):
                store.publish(v2)
                futs += [engine.submit(p, a, max_tokens=max_tokens)
                         for p, a in trace_reqs[half:]]
            published = True
        admitted = sum(f.submitted_step is not None for f in futs)
        chunks = getattr(engine, "prefill_chunks", 0)
        kicked = mt.async_builds
        bf = mt._build_fut is not None and not mt._build_fut[1].done()
        ts = time.perf_counter()
        engine.step()
        # the card finishing the step's work after its spans closed (and,
        # with async_prefetch, any build queued on the side stream): the
        # harness's own span, so that a replay sees where that time went
        with trace.span("drain", cat="harness"):
            torch.cuda.synchronize()
        wall = time.perf_counter() - ts
        # a build ran beside this step: in flight when it began, kicked
        # during it, or still running when it ended
        bf = bf or mt.async_builds > kicked or (
            mt._build_fut is not None and not mt._build_fut[1].done())
        prefilled = (sum(f.submitted_step is not None for f in futs)
                     > admitted
                     or getattr(engine, "prefill_chunks", 0) > chunks)
        steps.append((wall, prefilled, bf))
        if "adapter_0@1" not in mt.packs and any(
                f.adapter == "adapter_0@1" and not f.done() for f in futs):
            early.append(engine.step_count)
        staged = max(staged, store.staged_bytes())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # a build kicked by the last steps (the retirement's) is settled, so
    # that every build is adopted, found stale, or raises here
    if mt._build_fut is not None:
        futures.wait([mt._build_fut[1]])
        mt.poll_async_build()
    return futs, wall, steps, early, staged


def pz_thread_ms(tr):
    """Milliseconds of the pipeline's spans by (name, thread): disk reads
    (``disk_load`` on the serving thread, ``prefetch.disk`` on a store
    worker), pinning into staging (``dequant``, ``prefetch.decode``),
    table builds (``table_rebuild``, ``prefetch.h2d`` on the build
    worker) and the waits for them (``prefetch.stall``)."""
    out = {}
    for e in tr.events():
        if e["ph"] == "X" and e["name"] in (
                "prefetch.stall", "prefetch.disk", "prefetch.decode",
                "prefetch.h2d", "disk_load", "dequant", "table_rebuild"):
            k = f"{e['name']}@tid{e['tid']}"
            out[k] = round(out.get(k, 0.0) + e["dur"] / 1e3, 1)
    return out


def pz_time_demote(torch, mt, demote_ms):
    """Time each un-fuse of adapter_0@1 (the scatter_apply demote) with
    CUDA events, noting whether the scheduler or the retirement
    (``unregister``) asked for it; the one synchronization is this
    measurement's. Returns a function that removes the wrappers."""
    from repro_torch.core.switching import tenant_members
    demote, unregister = mt._demote, mt.unregister
    why = ["scheduler"]

    def timed():
        if "adapter_0@1" not in tenant_members(mt.fused):
            return demote()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        demote()
        e1.record()
        e1.synchronize()
        demote_ms.append((why[0], round(e0.elapsed_time(e1), 3)))

    def retiring(name):
        why[0] = "retirement"
        try:
            return unregister(name)
        finally:
            why[0] = "scheduler"
    mt._demote, mt.unregister = timed, retiring

    def undo():
        del mt._demote, mt.unregister
    return undo


def personalization_phase(torch):
    """The personalization loop at full width (starcoder2-7b cut to
    PZ_LAYERS layers, bf16 compute): three f32 packs at sparsity 0.98
    published as adapter_i@1 into a store whose resident budget holds one
    pack and whose pinned
    staging tier holds two; the continuous phase's 24-request trace (seed
    0, prompts of 64..1024, skew 0.8), the first 12 submitted at once, and
    after step 10 adapter_0@2 is published (values from a numpy seed) and
    the other 12 submitted. Through ServingEngine (8 lanes) and
    PagedServingEngine (321 pages of 16), each with a FusedLRU and
    slot_pad=4, with async_prefetch off and on, traced. FusedLRU's
    promote_at is 0.3, so that adapter_0@1 is fused before the swap and
    its un-fuse, the paper's rapid switch on a live server, is timed."""
    import gc
    import tempfile
    import numpy as np
    from repro_torch.analysis import trace
    from repro_torch.configs import get_config
    from repro_torch.core import FusedLRU
    from repro_torch.core.adapters import AdapterPack, map_entries
    from repro_torch.hub import PagedServingEngine, ServingEngine, save_pack
    from repro_torch.launch import serve
    from repro_torch.models import lm
    totals = {}
    cfg = get_config("starcoder2-7b").replace(num_layers=PZ_LAYERS)
    params = lm.init_params(cfg, seed=0, device="cuda")
    packs = serve.make_adapters(cfg, params, 3)
    trace_reqs = continuous_trace(cfg.vocab_size, packs)
    one = packs[0].nbytes()
    rng = np.random.default_rng(21)
    v2 = AdapterPack("adapter_0", {p: (i.cpu(), torch.from_numpy(
        (0.01 * rng.standard_normal(tuple(v.shape))).astype(np.float32)))
        for p, (i, v) in packs[0].entries.items()})
    outs, base = {}, 0
    with tempfile.TemporaryDirectory(prefix="personalize-") as root:
        t0 = time.perf_counter()
        files = [save_pack(map_entries(p, name=f"{p.name}@1"),
                           f"{root}/{p.name}@1.shpk") for p in packs]
        del packs
        torch.cuda.empty_cache()
        print(f"[personalization] 3 f32 packs published as adapter_i@1 "
              f"({one / 1e9:.2f} GB each) in {time.perf_counter() - t0:.1f}s"
              f"; store budget {1.5 * one / 1e9:.2f} GB (one pack), pinned "
              f"staging {2.5 * one / 1e9:.2f} GB (two)", flush=True)
        for label, make, needed in (
                ("ServingEngine", lambda **kw: ServingEngine(
                    cfg, params, slots=PZ_LANES, cache_size=CACHE, **kw),
                 ("flash_prefill", "flash_decode", "sidedelta",
                  "scatter_apply")),
                ("PagedServingEngine", lambda **kw: PagedServingEngine(
                    cfg, params, slots=PZ_LANES, num_pages=321, page_size=16,
                    chunk_size=CHUNK, **kw),
                 ("flash_decode_paged", "sidedelta", "scatter_apply"))):
            for mode in (False, True):
                tag = f"{label} async_prefetch={mode}"
                store = pz_store(f"{root}/{label}-{mode}", files, one)
                zero_counts()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                base = base or before
                print(f"[personalization] {tag}: {before / 1e9:.1f} GB "
                      f"allocated before the engine (the base: "
                      f"{base / 1e9:.1f} GB before the first)", flush=True)
                if before - base > 2 ** 30:
                    fail(f"personalization {tag}: "
                         f"{(before - base) / 1e9:.1f} GB of an earlier "
                         "run are still allocated")
                # promote_at 0.3: adapter_0@1 (3 of the first 8 live
                # lanes) is fused before the publish and un-fused after
                eng = make(store=store, scheduler=FusedLRU(promote_at=0.3),
                           slot_pad=4, async_prefetch=mode)
                demote_ms = []
                undo = pz_time_demote(torch, eng.engine, demote_ms)
                tr = trace.install(trace.Tracer(capacity=1 << 20))
                try:
                    futs, wall, steps, early, staged = pz_drive(
                        torch, eng, store, trace_reqs, v2, CC_TOKENS)
                finally:
                    trace.uninstall()
                counts = read_counts()
                PZ_TRACES[label, mode] = tr.events(), wall
                outs[label, mode] = pz_report(
                    torch, tag, eng, store, futs, wall, steps, early, staged,
                    tr, demote_ms, cfg.vocab_size, needed, counts, totals)
                undo()
                eng.engine.close()          # un-fuse: the base is back
                eng.shutdown(include_store=True)
                # undo's closure holds the engine: dropped with it, or its
                # tables and packs stay allocated into the next run
                del eng, store, futs, tr, undo
                gc.collect()
                torch.cuda.empty_cache()
    for label in ("ServingEngine", "PagedServingEngine"):
        a, b = outs[label, False], outs[label, True]
        same = sum(bool((x == y).all()) for x, y in zip(a, b))
        print(f"[personalization] bf16 {label}: {same}/{len(a)} requests "
              f"token-equal between async_prefetch off and on (reported, "
              f"not held)", flush=True)
    del params
    return totals


def pz_report(torch, tag, eng, store, futs, wall, steps, early, staged, tr,
              demote_ms, vocab, needed, counts, totals):
    """Print one run's numbers and hold its invariants."""
    import statistics
    import numpy as np
    mt = eng.engine
    total = torch.cuda.get_device_properties(0).total_memory
    reserved = torch.cuda.max_memory_reserved()
    outs = [f.result() if f.error is None else None for f in futs]
    ok = all(f.done() and f.error is None for f in futs) and all(
        o is not None and len(o) == CC_TOKENS and 0 <= int(o.min())
        and int(o.max()) < vocab for o in outs)
    if not ok:
        fail(f"personalization {tag}: a request failed or its tokens are "
             "out of range")
    hold_as_asked(f"personalization {tag}", eng.health(), store.retries,
                  futs)
    half = len(futs) // 2
    want = ["adapter_0@1"] * half + ["adapter_0@2"] * (len(futs) - half)
    wrong = [i for i, f in enumerate(futs)
             if f.adapter in ("adapter_0@1", "adapter_0@2")
             and f.adapter != want[i]]
    if wrong:
        fail(f"personalization {tag}: requests {wrong} resolved to the "
             "wrong version of adapter_0")
    evs = tr.events()
    evicted = [e for e in evs if e["name"] == "hotswap.evict"
               and e["args"].get("name") == "adapter_0@1"]
    if early or len(evicted) != 1 or "adapter_0@1" in mt.packs \
            or store.is_resident("adapter_0@1") or eng._vpins:
        fail(f"personalization {tag}: adapter_0@1 retired at steps {early} "
             f"with a request open, {len(evicted)} hotswap.evict, still "
             f"registered {'adapter_0@1' in mt.packs}, resident "
             f"{store.is_resident('adapter_0@1')}, pins {eng._vpins}")
    failed = sum(e["name"] == "prefetch.h2d_failed" for e in evs)
    if (failed or mt.async_failed or mt._build_fut is not None
            or mt.async_builds != mt.async_adopted + mt.async_stale):
        fail(f"personalization {tag}: background builds {mt.async_builds} "
             f"are not all adopted ({mt.async_adopted}) or stale "
             f"({mt.async_stale}): {mt.async_failed} failed, {failed} "
             f"prefetch.h2d_failed events, in flight "
             f"{mt._build_fut is not None}")
    neg = [e["name"] for e in evs if e["dur"] < 0]
    if neg or any(tr._depths.values()) or tr.dropped:
        fail(f"personalization {tag}: trace has negative durations {neg}, "
             f"open depths {tr._depths}, {tr.dropped} dropped events")
    ttft = lambda fs: (np.percentile([f.ttft for f in fs], 50),
                       np.percentile([f.ttft for f in fs], 99)) if fs else (
                           float("nan"),) * 2
    cold = ttft([f for f in futs if f.cold])
    hot = ttft([f for f in futs if not f.cold])
    med = lambda xs: statistics.median(xs) * 1e3 if xs else float("nan")
    dec = [w for w, pf, _ in steps if not pf]
    dec_build = [w for w, pf, bf in steps if not pf and bf]
    dec_plain = [w for w, pf, bf in steps if not pf and not bf]
    print(f"[personalization] {tag}: {len(futs)} requests, "
          f"{eng.tokens_out} tokens in {wall:.2f}s "
          f"({eng.tokens_out / wall:.1f} tok/s), TTFT cold "
          f"({sum(f.cold for f in futs)}) p50 {cold[0]:.3f}s p99 "
          f"{cold[1]:.3f}s, hot p50 {hot[0]:.3f}s p99 {hot[1]:.3f}s; "
          f"{eng.step_count} steps, decode-only step median {med(dec):.1f} "
          f"ms, with a build in flight {med(dec_build):.1f} ms "
          f"({len(dec_build)} steps), without {med(dec_plain):.1f} ms "
          f"({len(dec_plain)} steps); spans by thread (ms) {pz_thread_ms(tr)}"
          f"; async_builds {mt.async_builds} async_adopted "
          f"{mt.async_adopted} async_stale {mt.async_stale} async_failed "
          f"{mt.async_failed}; fuse "
          f"transitions {mt.fuse_transitions}, un-fuse of adapter_0@1 "
          f"(scatter_apply, by whom, ms) {demote_ms}; store "
          f"loads {store.loads}, evictions {store.evictions}, peak pinned "
          f"staging {staged / 1e9:.2f} GB; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB allocated, "
          f"{reserved / 1e9:.1f} GB reserved of {total / 1e9:.1f} GB "
          f"(headroom {(total - reserved) / 1e9:.1f} GB); launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    check_run(f"personalization {tag}", counts, needed, totals)
    return outs


def pz_consistency_phase(torch):
    """The hot swap at full width cut to 2 layers, f32: each request
    through the swap (ServingEngine and PagedServingEngine, FusedLRU,
    slot_pad=4, async_prefetch off and on) gives the tokens of a run of
    the same engine that only ever saw the version it resolved to."""
    import tempfile
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import FusedLRU
    from repro_torch.core.adapters import map_entries
    from repro_torch.hub import (AdapterStore, PagedServingEngine,
                                 ServingEngine)
    from repro_torch.core.masks import map_leaves
    from repro_torch.launch import serve
    from repro_torch.models import layers, lm
    cfg = get_config("starcoder2-7b").replace(num_layers=2)
    T = 8
    rng = np.random.default_rng(11)
    tok = lambda n: rng.integers(0, cfg.vocab_size, n).astype(np.int32)
    first = [(tok(40), "adapter_0"), (tok(23), "adapter_1"),
             (tok(301), "adapter_0"), (tok(17), None)]
    second = [(tok(33), "adapter_0"), (tok(280), "adapter_0"),
              (tok(12), "adapter_1")]
    with layers.compute_precision(torch.float32), \
            tempfile.TemporaryDirectory(prefix="pz-consistency-") as root:
        params = lm.init_params(cfg, seed=0, device="cuda")
        packs = serve.make_adapters(cfg, params, 2)
        v2 = map_entries(packs[1], name="adapter_0")   # other values

        def make(kind, store, base=params, **kw):
            if kind == "lane":
                return ServingEngine(cfg, base, slots=3, cache_size=400,
                                     store=store, **kw)
            return PagedServingEngine(cfg, base, slots=3, num_pages=80,
                                      page_size=16, chunk_size=256,
                                      store=store, **kw)

        def single(kind, mode, pack_for_0, reqs, sub):
            store = AdapterStore(f"{root}/{sub}")
            store.publish(map_entries(pack_for_0, name="adapter_0"))
            store.publish(packs[1])
            eng = make(kind, store, async_prefetch=mode)
            futs = [eng.submit(p, a, max_tokens=T) for p, a in reqs]
            eng.run()
            eng.shutdown(include_store=True)
            hold_as_asked(f"personalization-consistency {sub}", eng.health(),
                          store.retries, futs)
            return [f.result() for f in futs]

        for kind in ("lane", "paged"):
            for mode in (False, True):
                store = AdapterStore(f"{root}/{kind}-{mode}")
                store.publish(packs[0])
                store.publish(packs[1])
                # fusion updates the base in place: each swap run gets
                # its own copy, and the references the untouched one
                eng = make(kind, store, map_leaves(lambda _, x: x.clone(),
                                                   params),
                           scheduler=FusedLRU(promote_at=0.3), slot_pad=4,
                           async_prefetch=mode)
                futs = [eng.submit(p, a, max_tokens=T) for p, a in first]
                for _ in range(3):
                    eng.step()
                store.publish(v2)
                futs += [eng.submit(p, a, max_tokens=T) for p, a in second]
                eng.run()
                eng.shutdown(include_store=True)
                hold_as_asked(f"personalization-consistency {kind} "
                              f"async_prefetch={mode}", eng.health(),
                              store.retries, futs)
                got = [f.result() for f in futs]
                vers = [f.adapter for f in futs]
                want = (single(kind, mode, packs[0], first,
                               f"{kind}-{mode}-v1")
                        + single(kind, mode, v2, second, f"{kind}-{mode}-v2"))
                equal = [bool(np.array_equal(g, w))
                         for g, w in zip(got, want)]
                print(f"[personalization-consistency] f32, 2 layers, full "
                      f"width, {kind} async_prefetch={mode}: {sum(equal)}/"
                      f"{len(equal)} requests through the swap token-equal "
                      f"to single-version runs; versions {vers}; fuse "
                      f"transitions {eng.engine.fuse_transitions}",
                      flush=True)
                if not all(equal) or vers[0] != "adapter_0@1" \
                        or vers[4] != "adapter_0@2" \
                        or "adapter_0@1" in eng.engine.packs:
                    fail(f"personalization-consistency: {kind} "
                         f"async_prefetch={mode} differs on requests "
                         f"{[i for i, e in enumerate(equal) if not e]} "
                         f"(versions {vers})")
                del eng


SLO_PHASES = ((10.0, 0.3, 3.0),   # (seconds, requests/s, burst): normal,
              (10.0, 1.2, 3.0),   # overload at 4x, normal again
              (10.0, 0.3, 3.0))
SLO_HOT = 2                       # Zipf-head packs registered before a pass
CHAOS_KINDS = ("io_latency", "disk_fail", "corrupt", "worker_death",
               "build_fail", "poison")


class Recorder:
    """An engine as ``loadgen.run`` drives it, keeping every future."""

    def __init__(self, engine):
        self.engine, self.futs = engine, []

    def submit(self, *args, **kw):
        fut = self.engine.submit(*args, **kw)
        self.futs.append(fut)
        return fut

    def step(self):
        return self.engine.step()

    def pending(self):
        return self.engine.pending()


ANALYSIS_TOKENS = 8      # the traced lane run: tokens a request
SHARE_MAX = 1.05         # a step's roofline bound over its device time:
                         # above this the cost count is wrong
COVERAGE_MIN = 0.90      # replay gates, benchmarks/check_replay.py's
REALIZED_MIN = 0.5       # defaults
AUTOTUNE_CLASSES = 24    # the observed sidedelta classes swept, most
                         # requested first (the lanes' admissions plan one
                         # per prompt length)
AUTOTUNE_REPS = 5        # best of, a path and class
PLAN_CACHE = ROOT / "build" / "plan_cache.json"


def traced_lanes(torch, cfg, params):
    """A traced base-decode run of the lane engine at ``cfg``'s width: B
    requests of PROMPT tokens, ANALYSIS_TOKENS each, every request on the
    base, after a one-request warm-up. Returns the run's events."""
    import numpy as np
    from repro_torch.analysis import trace
    from repro_torch.hub import ServingEngine
    rng = np.random.default_rng(9)
    eng = ServingEngine(cfg, params, slots=B,
                        cache_size=PROMPT + ANALYSIS_TOKENS)
    eng.submit(rng.integers(0, cfg.vocab_size, PROMPT), None, max_tokens=2)
    eng.run()
    tr = trace.install(trace.Tracer(capacity=1 << 20))
    try:
        futs = [eng.submit(rng.integers(0, cfg.vocab_size, PROMPT), None,
                           max_tokens=ANALYSIS_TOKENS) for _ in range(B)]
        eng.run()
    finally:
        trace.uninstall()
    eng.shutdown()
    if not all(f.done() and len(f.result()) == ANALYSIS_TOKENS
               for f in futs):
        fail("analysis: the traced lane run did not serve every request")
    return tr.events()


def analysis_roofline(analysis):
    """(a) Each profiled step's program cost against the card's roofline:
    terms, the dominant one, the bound beside the step's measured device
    and wall ms. A bound above SHARE_MAX of the device time is a count
    that cannot be true."""
    from repro_torch.analysis import roofline
    hw = roofline.HW()
    for label in ("base", "multi-tenant f32", "base prefill"):
        a = analysis[label]
        c, cfg = a["cost"], a["cfg"]
        r = roofline.roofline_terms({"mesh": (1,), "shape": a["shape"],
                                     "cost": c, "collectives": {
                                         "total_bytes": 0}}, cfg, hw)
        n = roofline.count_params(cfg)["total"]
        bound_ms = r["bound_s"] * 1e3
        print(f"[analysis] roofline {label} ({a['shape'].name}): "
              f"{c['flops'] / 1e9:.1f} GFLOP ({c['dot_flops'] / 1e9:.1f} in "
              f"matmuls), {c['bytes_accessed'] / 1e9:.2f} GB "
              f"({c['bytes_accessed'] / n:.2f} B a parameter of "
              f"{n / 1e9:.3f} B) in {c['ops']} ops, kernels "
              f"{c['kernel_calls']}, {c['ops_without_cost']:.0f} not "
              f"costed: compute {r['compute_s'] * 1e3:.3f} ms, memory "
              f"{r['memory_s'] * 1e3:.3f} ms, bound_ms {bound_ms:.3f} "
              f"({r['dominant']}); model FLOPs {r['model_flops_global']:.4g},"
              f" useful ratio {r['useful_flops_ratio']:.3f}, roofline "
              f"fraction {r['roofline_fraction']:.3f}", flush=True)
        if not a["device_ms"]:
            fail(f"analysis: {label}'s device time was not measured")
        share = bound_ms / a["device_ms"]
        print(f"[analysis] roofline {label}: device {a['device_ms']:.2f} ms,"
              f" wall {a['wall_ms']:.2f} ms; bound_ms / device_ms "
              f"{share:.3f}, bound_ms / wall_ms "
              f"{bound_ms / a['wall_ms']:.3f} (card: {hw.hbm_bw / 1e12} TB/s,"
              f" {hw.peak_flops / 1e12:.0f} TFLOP/s bf16)", flush=True)
        if "memory" in a:
            m = a["memory"]
            print(f"[analysis] memory_summary {label}: arguments "
                  f"{m['args_mb']} MB, output "
                  f"{m['output_size_in_bytes'] / 1e6:.1f} MB, temporaries "
                  f"{m['temp_mb']} MB (the allocator's peak), peak "
                  f"{m['peak_device_mb']} MB", flush=True)
        if not share <= SHARE_MAX:
            fail(f"analysis: {label}'s roofline bound {bound_ms:.3f} ms is "
                 f"{share:.3f} of its measured {a['device_ms']:.2f} device "
                 f"ms (> {SHARE_MAX}): the cost count is wrong")


def uncovered(events, top: int = 3):
    """The ``top`` longest intervals between the serving thread's
    top-level spans: (ms from the first span, ms long, the instants in
    it)."""
    from repro_torch.analysis import replay
    sps = [e for e in replay.main_spans(events) if e.get("depth", 0) == 0]
    t0 = sps[0]["ts"] if sps else 0.0
    gaps, end = [], t0
    for e in sps:
        if e["ts"] > end:
            gaps.append((e["ts"] - end, end))
        end = max(end, e["ts"] + e["dur"])
    out = []
    for dur, lo in sorted(gaps, reverse=True)[:top]:
        names = sorted({e["name"] for e in events if e.get("ph") == "i"
                        and lo <= e["ts"] <= lo + dur})
        out.append((round((lo - t0) / 1e3, 1), round(dur / 1e3, 1), names))
    return out


def port_events(events):
    """(the trace without the harness's own spans, the microseconds of the
    harness's top-level spans on the serving thread: ``pz_drive``'s
    publish and per-step drains)."""
    from repro_torch.analysis import replay
    held = sum(e["dur"] for e in replay.main_spans(events)
               if e.get("cat") == "harness" and e.get("depth", 0) == 0)
    return [e for e in events if e.get("cat") != "harness"], held


def analysis_replay(analysis):
    """(b) The traced lane run's decode spans joined with the base decode
    step's cost (measured / modelled time); (c) the personalization runs'
    traces replayed without the harness's own spans: the coverage gated is
    the port's spans' share of every run's measured wall less the
    harness's spans (as the reference's test holds a traced run's; the
    share with the harness's spans counted is printed beside it), the
    async runs' realized overlap against their sync run, the async runs'
    critical path and a what-if of table builds hidden under decode."""
    from repro_torch.analysis import replay
    from repro_torch.analysis.roofline import HW
    lanes = analysis["lanes"]
    jc = replay.join_costs(lanes, {"decode": analysis["base"]["cost"]},
                           HW())["decode"]
    att = replay.attribute(lanes)
    print(f"[analysis] join_costs: {jc['count']:.0f} decode spans of the "
          f"lane engine (base, B={B}), mean {jc['measured_us_mean'] / 1e3:.3f}"
          f" ms against the roofline model's {jc['model_us'] / 1e3:.3f} ms: "
          f"measured/model {jc['ratio']:.2f}; the trace's coverage "
          f"{att['coverage']:.1%}, self ms by span "
          f"{ {k: round(v / 1e3, 1) for k, v in att['by_name'].items()} }",
          flush=True)
    if not jc["count"]:
        fail("analysis: the traced lane run has no decode span")
    for label in ("ServingEngine", "PagedServingEngine"):
        runs = {}
        for mode in (False, True):
            ev, wall = PZ_TRACES[label, mode]
            runs[mode], held = port_events(ev)
            att = replay.attribute(runs[mode], wall_us=wall * 1e6 - held)
            print(f"[analysis] replay personalization {label} async_prefetch"
                  f"={mode}: {att['spans']} spans of the port, coverage "
                  f"{att['coverage']:.1%} of the run's {wall:.2f} s wall "
                  f"less the harness's {held / 1e6:.2f} s (min "
                  f"{COVERAGE_MIN:.0%}; with the harness's spans "
                  f"{replay.attribute(ev, wall_us=wall * 1e6)['coverage']:.1%}"
                  f"); the largest gaps between top-level spans "
                  f"{uncovered(ev)}", flush=True)
            if not att["coverage"] >= COVERAGE_MIN:
                fail(f"analysis: {label} async_prefetch={mode}: the port's "
                     f"spans cover {att['coverage']:.1%} of the trace's wall")
        vo = replay.verify_overlap(runs[True], baseline=runs[False])
        alone = replay.verify_overlap(runs[True])
        workers = {k: round(v / 1e3, 1)
                   for k, v in vo["async_by_name"].items()}
        print(f"[analysis] replay personalization {label}: "
              f"{vo['async_spans']} worker spans {workers} ms; "
              f"{vo['measured_hidden_us'] / 1e3:.1f} ms hidden under "
              f"{vo['under']} of {vo['predicted_hidden_us'] / 1e3:.1f} ms the"
              f" sync run's what-if predicts: realized "
              f"{vo['realized_frac']:.1%} (min {REALIZED_MIN:.0%}); against "
              f"the async run's own bound "
              f"{alone['predicted_hidden_us'] / 1e3:.1f} ms: "
              f"{alone['realized_frac']:.1%}", flush=True)
        if not vo["async_spans"]:
            fail(f"analysis: {label}'s async run has no worker span")
        if not vo["realized_frac"] >= REALIZED_MIN:
            fail(f"analysis: {label}'s async run realized "
                 f"{vo['realized_frac']:.1%} of the predicted hiding")
        top = [(r["name"], round(r["self_us"] / 1e3, 1), round(r["frac"], 3))
               for r in replay.critical_path(runs[True], top=5)]
        wi = replay.what_if(runs[True], overlap=("table_rebuild",),
                            under="decode")
        print(f"[analysis] replay personalization {label} async: critical "
              f"path (name, self ms, share) {top}; what_if table_rebuild "
              f"under decode: {wi['baseline_us'] / 1e3:.1f} -> "
              f"{wi['replayed_us'] / 1e3:.1f} ms ({wi['hidden_us'] / 1e3:.1f}"
              f" ms hidden, {wi['speedup']:.3f}x)", flush=True)


def mt_f32_tokens(torch, cfg, params, packs):
    """A multi-tenant serve at ``cfg``, f32: B requests of PROMPT tokens
    over three adapters and the base, TOKENS tokens each (seed 12)."""
    from repro_torch.models import layers
    from repro_torch.serving import MultiTenantEngine
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    toks = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen,
                         device="cuda")
    names = ["adapter_0", "adapter_1", None, "adapter_2"] * (B // 4)
    with layers.compute_precision(torch.float32):
        eng = MultiTenantEngine(cfg, params)
        for p in packs:
            eng.register(p)
        out, _ = eng.generate({"tokens": toks}, names, TOKENS)
        eng.close()
    return out


def analysis_autotune(torch, observed):
    """(d) sidedelta's paths timed at every class the serve and continuous
    phases planned (the AUTOTUNE_CLASSES most requested of ``observed``),
    starcoder2-7b's full-width w_up and w_down classes and a 2-layer f32
    multi-tenant serve's: both paths on the same inputs within
    SIDEDELTA_TOL, each's best of AUTOTUNE_REPS, the winner beside the
    static rule's choice. The winners are saved under build/ and
    installed; the 2-layer serve's tokens must equal its tokens without
    the cache, with the cache hit; then the cache is cleared."""
    import importlib
    from repro_torch.analysis import autotune
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    sd = importlib.import_module("repro_torch.kernels.sidedelta")
    cfg = two_layers(get_config("starcoder2-7b"))
    params = lm.init_params(cfg, seed=0, device="cuda")
    packs = serve.make_adapters(cfg, params, 3, multi_tenant=True)
    autotune.clear_observed()
    with autotune.observe():
        want = mt_f32_tokens(torch, cfg, params, packs)
    f32 = autotune.observed_shapes()
    served = observed[:AUTOTUNE_CLASSES]
    classes = list(dict.fromkeys(
        served + autotune.full_width_classes("starcoder2-7b") + f32))
    print(f"[analysis] autotune: {len(observed)} sidedelta classes observed "
          f"in the serve and continuous phases, the {len(served)} most "
          f"requested swept, with {len(classes) - len(served)} more "
          f"(starcoder2-7b's w_up and w_down at full width, the 2-layer f32 "
          f"serve's)", flush=True)
    plans, differ = {}, 0
    for key in classes:
        inputs = autotune.class_inputs(key)
        paths = autotune.candidates(key)
        outs = [autotune.run_plan(key, p, inputs) for p in paths]
        err = max([float((o - outs[0]).abs().max()) for o in outs[1:]]
                  + [0.0])
        if not err <= SIDEDELTA_TOL:
            fail(f"analysis: sidedelta's paths differ by {err} at {key}")
        times = {p: autotune.measure_plan(key, p, reps=AUTOTUNE_REPS,
                                          inputs=inputs) for p in paths}
        plans[key] = win = min(times, key=times.get)
        static = sd.static_path(*key[:2])
        differ += win != static
        where = ("observed" if key in served else "f32 serve" if key in f32
                 else "full width")
        print(f"[analysis] autotune B={key[0]} S={key[1]} {key[2]}x{key[3]} "
              f"K={key[4]} x {key[5]} B ({where}): "
              + ", ".join(f"{p} {t * 1e3:.4f} ms" for p, t in times.items())
              + f"; winner {win}, static rule {static}"
              f"{' (differs)' if win != static else ''}; paths differ by "
              f"{err:.3g}", flush=True)
        del inputs, outs
    path = autotune.save_cache(plans, str(PLAN_CACHE), meta={
        "arch": "starcoder2-7b", "source": "chip_smoke.py analysis",
        "device": torch.cuda.get_device_name(0), "card": card_line(),
        "changed_vs_static": differ})
    autotune.install(plans, replace=True)
    sd.plan_cache_stats.update(hits=0, misses=0, rejected=0)
    try:
        got = mt_f32_tokens(torch, cfg, params, packs)
        stats = dict(sd.plan_cache_stats)
    finally:
        sd.clear_plan_cache()
    equal = bool(torch.equal(got, want))
    print(f"[analysis] autotune: {len(plans)} plans, {differ} differ from "
          f"the static rule, saved to {Path(path).relative_to(ROOT)} and "
          f"installed; the 2-layer f32 multi-tenant serve with the cache: "
          f"lookups {stats}, tokens equal to the run without it: {equal}; "
          f"cache cleared", flush=True)
    if not stats["hits"]:
        fail("analysis: the installed plan cache was never hit")
    if not equal:
        fail("analysis: the plan cache changed the served tokens")
    del params, packs


def analysis_phase(torch, analysis, observed):
    """The analysis modules on the card: (a) the roofline of the profiled
    steps, (b) join_costs of a traced lane run, (c) the personalization
    traces replayed, (d) sidedelta path autotuning."""
    analysis_roofline(analysis)
    analysis_replay(analysis)
    analysis_autotune(torch, observed)


def goodput(futs, wall, slo_ms):
    """Tokens per second of the requests that finished within slo_ms."""
    return sum(len(f.tokens) for f in futs if f.error is None and f.done()
               and (f.finish_time - f.submit_time) * 1e3 <= slo_ms) / wall


def slo_pass(torch, tag, engine, store, reqs, slo_ms, deadline_s, inj):
    """Drive one pass of the trace through ``engine`` with loadgen.run;
    print its numbers and return (report, futures, goodput, slo_ms, peak
    GB allocated since the caller reset the peak)."""
    import numpy as np
    from repro_torch.serving import loadgen
    rec = Recorder(engine)
    rep = loadgen.run(rec, reqs, slo_ms=slo_ms, deadline_s=deadline_s)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    pct = lambda xs: ("/".join(f"{np.percentile(xs, q) / 1e3:.3f}"
                               for q in (50, 95, 99)) if xs else "-")
    cold = lambda xs: ("/".join(f"{np.percentile(xs, q) / 1e3:.3f}"
                                for q in (50, 99)) if xs else "-")
    slo = slo_ms if slo_ms is not None else 2 * float(np.median(
        rep.latencies_ms))
    gp = goodput(rec.futs, rep.wall_s, slo)
    print(f"[slo-chaos] {tag}: offered {rep.offered}, completed "
          f"{rep.completed}, failed {rep.failed}, shed {rep.shed}, degraded "
          f"{rep.degraded}, errors {rep.errors_by_type}; latency p50/p95/p99 "
          f"{pct(rep.latencies_ms)} s, TTFT {pct(rep.ttfts_ms)} s, cold "
          f"TTFT p50/p99 {cold(rep.ttfts_cold_ms)} s "
          f"({len(rep.ttfts_cold_ms)} cold); {rep.tokens_out} tokens in "
          f"{rep.wall_s:.2f}s, {rep.tokens_per_s:.2f} tok/s, goodput "
          f"{gp:.2f} tok/s at slo_ms {slo:.0f}; {rep.steps} steps; "
          f"injected {dict(inj.counts) if inj else {}}; store retries "
          f"{store.retries}, quarantines {store.load_failures} "
          f"{store.quarantined()}; health {engine.health()}; peak memory "
          f"{peak:.1f} GB allocated, "
          f"{torch.cuda.max_memory_reserved() / 1e9:.1f} GB reserved",
          flush=True)
    return rep, rec.futs, gp, slo, peak


FIRST_FIRE = {"disk": "disk_fail", "corrupt": "corrupt",
              "worker": "worker_death", "build": "build_fail"}


def first_touch_injector(plan):
    """Install an injector of ``plan`` whose draws are the plan's, except
    that a site's draw fires while its kind has not fired yet: each
    load-side kind then fires at its first chance inside the pass, under
    its traffic (a cold adapter's first prefetch and disk reads, the first
    table build), and every later draw is the plan's own. Its ``forced``
    names the kinds that fired so."""
    from repro_torch.runtime import faults

    class FirstTouch(faults.FaultInjector):
        def __init__(self, plan):
            super().__init__(plan)
            self.forced = set()

        def _draw(self, site, key):
            u = super()._draw(site, key)
            kind = FIRST_FIRE[site]
            with self._lock:
                if self.counts.get(kind) or kind in self.forced:
                    return u
                self.forced.add(kind)
            return 0.0

    return faults.install(FirstTouch(plan))


def slo_chaos_phase(torch):
    """The reference's ``benchmarks/slo_load.py --chaos`` at full width on
    PagedServingEngine (async prefetch, 8 slots, 321 pages of 16, chunks
    of 256, slot_pad 4): 4 f32 packs at sparsity 0.98 in pack files, the 2
    Zipf-head ones registered (and one short request each served) before
    each pass, the other 2 on disk only, so that their first touch is
    cold. Traffic from the port's LoadGen, seed 0: Zipf s = 1.1, burst 3,
    prompts of 64..512 tokens after a shared 64-token prefix, 8..32 tokens
    out, 10 s at 0.3 requests/s, 10 s at 1.2, 10 s at 0.3. A fault-free
    pass sets slo_ms = 2 x its p50 latency; the chaos pass (nan_guard,
    deadline 4 x slo_ms) runs under FaultPlan(seed=0, disk_fail_p=0.10,
    io_latency_s=0.002, corrupt_p=0.05, worker_death_p=0.05,
    build_fail_p=0.05, poison 8 steps in, slot 0). Its draws are
    sha256(seed, site, key, attempt): with two cold first touches the
    pass draws each load site only a few times, and seed 0's own draws
    there fire nowhere, so each load-side kind that has not fired yet
    fires at its site's next draw (first_touch_injector): a disk failure,
    a corrupt payload, a dead worker and a failed table build each run
    the ladder under the pass's traffic. The fault-free pass must serve
    every request as asked (hold_as_asked). Holds for the chaos pass:
    every future terminal, every failure typed, every kind fired, exactly
    one slot.poison, nothing left pinned, at most PEAK_GB_MAX allocated.
    The goodput under faults as a share of the fault-free pass is printed,
    not held."""
    import gc
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.hub import AdapterStore, PagedServingEngine, save_pack
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.runtime import faults
    from repro_torch.serving import loadgen
    zero_counts()
    cfg = get_config("starcoder2-7b").replace(num_layers=SLO_LAYERS)
    print(f"[slo-chaos] starcoder2-7b at full width, {SLO_LAYERS} of 32 "
          f"layers (SLO_LAYERS: cut for the script's time limit since the "
          f"distributed slice; all 32 before)", flush=True)
    params = lm.init_params(cfg, seed=0, device="cuda")
    packs = serve.make_adapters(cfg, params, 4)
    names = [p.name for p in packs]
    reqs = loadgen.LoadGen(
        adapters=names, vocab=cfg.vocab_size, seed=0, zipf_s=1.1,
        phases=[loadgen.Phase(*ph) for ph in SLO_PHASES],
        prompt_len=(64, 512), max_tokens=(8, 32),
        shared_prefix=64).schedule()
    peaks, passes = [], {}
    with tempfile.TemporaryDirectory(prefix="slo-chaos-") as root:
        t0 = time.perf_counter()
        files = [save_pack(p, f"{root}/{p.name}.shpk") for p in packs]
        del packs
        torch.cuda.empty_cache()
        print(f"[slo-chaos] {len(files)} f32 packs written in "
              f"{time.perf_counter() - t0:.1f}s; {len(reqs)} requests "
              f"offered over {sum(p[0] for p in SLO_PHASES):.0f}s "
              f"(per phase {[sum(r.phase == i for r in reqs) for i in range(3)]}"
              f", adapters {[sum(r.adapter == n for r in reqs) for n in names]})",
              flush=True)
        slo_ms = None
        for tag in ("fault-free", "chaos"):
            chaos = tag == "chaos"
            torch.cuda.reset_peak_memory_stats()
            store = AdapterStore(f"{root}/{tag}")
            for f in files:
                store.register_file(f)
            engine = PagedServingEngine(
                cfg, params, slots=B, num_pages=321, page_size=16,
                chunk_size=CHUNK, store=store, async_prefetch=True,
                slot_pad=4, nan_guard=chaos)
            for n in names[:SLO_HOT]:
                engine.register(n)
                engine.submit(reqs[0].prompt[:65], n, max_tokens=1)
            engine.run()
            inj = None
            if chaos:
                inj = first_touch_injector(faults.FaultPlan(
                    seed=0, disk_fail_p=0.10, io_latency_s=0.002,
                    corrupt_p=0.05, worker_death_p=0.05, build_fail_p=0.05,
                    poison_step=engine.step_count + 8, poison_slot=0))
            try:
                rep, futs, gp, slo, peak = slo_pass(
                    torch, tag, engine, store, reqs, slo_ms,
                    4 * slo_ms / 1e3 if chaos else None, inj)
            finally:
                faults.uninstall()
            peaks.append(peak)
            slo_ms = slo_ms or slo
            passes[tag] = (rep, gp)
            if not all(f.done() for f in futs):
                fail(f"slo-chaos {tag}: {sum(not f.done() for f in futs)} "
                     "requests are not terminal")
            if not chaos:
                hold_as_asked("slo-chaos fault-free", engine.health(),
                              store.retries, futs)
            else:
                print(f"[slo-chaos] chaos pass: fired {dict(inj.counts)}, of "
                      f"them forced at their first draw "
                      f"{sorted(inj.forced)}", flush=True)
                untyped = {type(f.error).__name__ for f in futs
                           if f.error is not None
                           and not isinstance(f.error, faults.ServingError)}
                missing = [k for k in CHAOS_KINDS if not inj.counts.get(k)]
                if untyped or missing or engine.poisoned != 1 \
                        or inj.counts.get("poison") != 1:
                    fail(f"slo-chaos: untyped failures {untyped}, kinds "
                         f"that never fired {missing}, {engine.poisoned} "
                         f"slots poisoned")
            pinned = store.inflight_names()
            engine.shutdown(include_store=True)
            if pinned or engine._vpins:
                fail(f"slo-chaos {tag}: {pinned} still pinned in the store, "
                     f"{engine._vpins} in the engine")
            del engine, store, futs
            gc.collect()
            torch.cuda.empty_cache()
    share = passes["chaos"][1] / max(passes["fault-free"][1], 1e-9)
    print(f"[slo-chaos] goodput under faults {passes['chaos'][1]:.2f} tok/s "
          f"= {share:.1%} of the fault-free pass's "
          f"{passes['fault-free'][1]:.2f} (reported, not held; the "
          f"reference bench's own gate is 70%); peak allocated "
          f"{max(peaks):.1f} GB", flush=True)
    if max(peaks) > PEAK_GB_MAX:
        fail(f"slo-chaos: {max(peaks):.1f} GB allocated > {PEAK_GB_MAX} GB")
    totals = read_counts()
    check_run("slo-chaos", totals, ("flash_decode_paged", "sidedelta"), {})
    del params
    return totals


def faults_consistency_phase(torch):
    """The fault ladder's outcomes at full width cut to 2 layers, f32, as
    tests/test_faults.py holds them on the CPU: a poisoned slot's
    survivors give the tokens of a fault-free run (both engines); a
    request degraded to name@v-1 gives that version's tokens; a
    SimulatedPreemption at step k, then a rebuilt engine and the requests
    resubmitted, gives the uninterrupted run's tokens; with int8 pages the
    first token of each request equals the unquantized pools' (f32 here),
    the reference's own bar (tests/test_paged.py:299-315)."""
    import tempfile
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.adapters import map_entries
    from repro_torch.hub import (AdapterStore, PagedServingEngine,
                                 ServingEngine)
    from repro_torch.launch import serve
    from repro_torch.models import layers, lm
    from repro_torch.runtime import faults
    from repro_torch.runtime.ft import SimulatedPreemption
    cfg = get_config("starcoder2-7b").replace(num_layers=2)
    rng = np.random.default_rng(13)
    tok = lambda n: rng.integers(0, cfg.vocab_size, n).astype(np.int32)
    prompts = [tok(n) for n in (40, 301, 17, 88)]
    adapters = ["adapter_0", "adapter_1", None, "adapter_0"]
    checks = []

    def make(kind, store, **kw):
        if kind == "lane":
            return ServingEngine(cfg, params, slots=3, cache_size=400,
                                 store=store, **kw)
        return PagedServingEngine(cfg, params, slots=3, num_pages=80,
                                  page_size=16, chunk_size=256, store=store,
                                  **kw)

    def run(eng, reqs, T=6, clean=None):
        """Serve ``reqs``; a run named by ``clean`` had no fault injected
        and must serve every request as asked."""
        futs = [eng.submit(p, a, max_tokens=T) for p, a in reqs]
        eng.run()
        if clean:
            hold_as_asked(f"faults-consistency {clean}", eng.health(),
                          store_retries(eng), futs)
        return futs

    with layers.compute_precision(torch.float32), \
            tempfile.TemporaryDirectory(prefix="faults-consistency-") as root:
        params = lm.init_params(cfg, seed=0, device="cuda")
        packs = serve.make_adapters(cfg, params, 2)
        store = AdapterStore(f"{root}/s")
        for p in packs:
            store.add(p)
        reqs = list(zip(prompts, adapters))
        for kind in ("lane", "paged"):
            eng = make(kind, store, nan_guard=True)
            want = [f.result() for f in run(eng, reqs,
                                            clean=f"{kind} nan_guard")]
            inj = faults.install(faults.FaultPlan(
                poison_step=eng.step_count + 2, poison_slot=0))
            try:
                futs = run(eng, reqs)
            finally:
                faults.uninstall()
            hit = [i for i, f in enumerate(futs) if f.error is not None]
            ok = (inj.counts == {"poison": 1} and len(hit) == 1
                  and type(futs[hit[0]].error).__name__ == "SlotPoisoned"
                  and all(np.array_equal(f.result(), w)
                          for i, (f, w) in enumerate(zip(futs, want))
                          if i not in hit))
            checks.append((f"{kind}: a poisoned slot (request {hit}), the "
                           "survivors' tokens equal the fault-free run", ok))
            eng.shutdown()

            vstore = AdapterStore(f"{root}/v-{kind}")
            vstore.publish(map_entries(packs[0], name="p"))
            vstore.publish(map_entries(packs[1], name="p"))
            eng = make(kind, vstore)
            want = run(eng, [(prompts[0], "p@1")],
                       clean=f"{kind} p@1")[0].result()
            vstore.quarantine("p@2", reason="consistency")
            got = run(eng, [(prompts[0], "p")])[0]
            checks.append((f"{kind}: p@2 quarantined, a request for p is "
                           "degraded to p@1 and gives its tokens",
                           got.degraded and got.degraded_from == "p"
                           and np.array_equal(got.result(), want)))
            eng.shutdown()

            eng = make(kind, store)
            want = [f.result() for f in run(eng, reqs, clean=kind)]
            eng = make(kind, store)
            futs = [eng.submit(p, a, max_tokens=6) for p, a in reqs]
            faults.install(faults.FaultPlan(preempt_step=3))
            died = False
            try:
                eng.run()
            except SimulatedPreemption:
                died = True
            finally:
                faults.uninstall()
            unfinished = sum(not f.done() for f in futs)
            eng = make(kind, store)
            again = [f.result() for f in run(eng, reqs,
                                             clean=f"{kind} rebuilt")]
            checks.append((f"{kind}: preempted at step 3 ({unfinished} "
                           "requests unfinished), rebuilt and resubmitted, "
                           "the uninterrupted tokens",
                           died and unfinished > 0 and all(
                               np.array_equal(a, w)
                               for a, w in zip(again, want))))
            eng.shutdown()
        firsts = {}
        for quant in (False, True):
            eng = make("paged", store, quant_kv=quant)
            firsts[quant] = [int(f.result()[0]) for f in run(
                eng, reqs, clean=f"paged quant_kv={quant}")]
        checks.append((f"paged, int8 pages: first tokens {firsts[True]} "
                       f"equal the f32 pools' {firsts[False]}",
                       firsts[True] == firsts[False]))
    for label, ok in checks:
        print(f"[faults-consistency] f32, 2 layers, full width, {label}: "
              f"{'ok' if ok else 'FAILED'}", flush=True)
    bad = [label for label, ok in checks if not ok]
    if bad:
        fail(f"faults-consistency: {bad}")


MOE_RANGES = ("moe_ffn", "moe.route", "moe.experts", "moe.expert_casts")
MLA_RANGES = ("mla.attention", "mla.q_eff", "mla.scores", "mla.out",
              "mla.cache_write", "mla.expand_kv", "mla.attend")
MAMBA_RANGES = ("mamba.mixer", "mamba.project", "mamba.conv",
                "mamba.ssd_intra", "mamba.ssd_states", "mamba.ssd_inter",
                "mamba.gated_out", "mamba.state_update")
HYBRID_RANGES = ("hybrid.shared", "hybrid.w_fuse", "hybrid.attention",
                 "hybrid.mlp")
PREFIX_RANGES = ("vlm.prefix_attention",)


class wrapped_ranges:
    """Within the block, each named function (module, attribute, range)
    runs under a profiler range of that name."""

    def __init__(self, specs):
        self.specs = specs

    def __enter__(self):
        from torch.profiler import record_function

        def wrap(name, fn):
            def go(*a, **k):
                with record_function(name):
                    return fn(*a, **k)
            return go
        self.saved = [(mod, attr, getattr(mod, attr))
                      for mod, attr, _ in self.specs]
        for mod, attr, name in self.specs:
            setattr(mod, attr, wrap(name, getattr(mod, attr)))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)


def moe_ranges():
    """Every MoE call under profiler ranges: the whole FFN
    (blocks.moe_ffn), its routing (moe.route: softmax, the stable sort,
    the one-hot cumsum of the slots), the experts (moe._expert_ffn: the
    three bmm and the casts of the expert weights) and those casts
    (moe._expert_weight). The rest of moe_ffn is the router's matmul, the
    dispatch scatter and the combine."""
    from repro_torch.models import blocks, moe
    return wrapped_ranges(list(zip(
        (blocks, moe, moe, moe),
        ("moe_ffn", "route", "_expert_ffn", "_expert_weight"), MOE_RANGES)))


def mla_ranges():
    """Every MLA attention call under profiler ranges: the whole call
    (mla.attention: projections, latents, attention and wo), and within
    it the absorbed decode's q_eff product (q_nope into the latent space
    through w_uk), its scores and softmax over [c_kv | k_rope], its out
    product (probs . c_kv, then w_uv), the latent cache or page write,
    and the prefill's K/V expansion and attention (chunked_attention)."""
    from repro_torch.models import attention as A
    whole = [(A, f, "mla.attention") for f in (
        "mla_train", "mla_prefill", "mla_decode", "mla_decode_paged",
        "mla_prefill_chunk")]
    return wrapped_ranges(whole + [
        (A, "_mla_q_eff", "mla.q_eff"), (A, "_mla_latent_probs",
                                         "mla.scores"),
        (A, "_mla_latent_out", "mla.out"), (A, "_mla_write",
                                            "mla.cache_write"),
        (A, "_mla_page_write", "mla.cache_write"),
        (A, "_mla_expand_kv", "mla.expand_kv"),
        (A, "chunked_attention", "mla.attend")])


def mamba_ranges():
    """Every Mamba2 mixer call under profiler ranges: the whole mixer
    (mamba.mixer: mamba_train, mamba_prefill, mamba_decode), and within
    it the four input projections (_project, with dt's softplus), the
    depthwise conv (_causal_conv, and decode's _conv_step), the SSD's
    intra-chunk product (_ssd_intra), its chunk states and the recurrence
    over chunks (_ssd_states), its inter-chunk output (_ssd_inter), the
    gated RMSNorm with out_proj (_gated_out) and decode's state update
    (_ssm_step). The rest of the mixer is the skip (D x), the B/C split
    and decode's window write."""
    from repro_torch.models import mamba2 as M
    whole = [(M, f, "mamba.mixer") for f in (
        "mamba_train", "mamba_prefill", "mamba_decode")]
    return wrapped_ranges(whole + [
        (M, "_project", "mamba.project"), (M, "_causal_conv", "mamba.conv"),
        (M, "_conv_step", "mamba.conv"), (M, "_ssd_intra", "mamba.ssd_intra"),
        (M, "_ssd_states", "mamba.ssd_states"),
        (M, "_ssd_inter", "mamba.ssd_inter"),
        (M, "_gated_out", "mamba.gated_out"),
        (M, "_ssm_step", "mamba.state_update")])


def hybrid_ranges():
    """zamba2's shared block under profiler ranges, at each of its sites:
    the whole block (hybrid.shared: blocks.shared_attn_*), its input
    fusion concat(h, emb) . w_fuse (hybrid.w_fuse: blocks._fuse), its
    attention (hybrid.attention: attention.gqa_*, the q/k/v projections,
    rope, the cache write and wo) and its MLP (hybrid.mlp: blocks.mlp).
    The rest of the block is its two norms and residuals. The flash
    kernels launch through ctypes, outside the dispatcher whose ops the
    profiler ties to a range, so no range holds their device time:
    print_hybrid_ranges adds them by name."""
    from repro_torch.models import attention as A
    from repro_torch.models import blocks as Bk
    whole = [(Bk, f, "hybrid.shared") for f in (
        "shared_attn_train", "shared_attn_prefill", "shared_attn_decode")]
    attn = [(A, f, "hybrid.attention") for f in (
        "gqa_train", "gqa_prefill", "gqa_decode")]
    return wrapped_ranges(whole + attn + [
        (Bk, "_fuse", "hybrid.w_fuse"), (Bk, "mlp", "hybrid.mlp")])


def prefix_ranges():
    """A vision model's plain prefix attention under a profiler range:
    every chunked_attention call (the prefill's, whose patch prefix no
    attention kernel computes; the score product, its masks and softmax,
    the value product; the projections and rope are outside it)."""
    from repro_torch.models import attention as A
    return wrapped_ranges([(A, "chunked_attention", PREFIX_RANGES[0])])


def print_prefix_ranges(torch, label, prof, busy):
    (ms, n), = range_ms(torch, prof, PREFIX_RANGES).values()
    if not n:                           # a decode step attends on the kernel
        return
    share = f" ({ms / busy:.1%})" if busy else ""
    print(f"[profile] {label} plain prefix attention (chunked_attention, "
          f"{n} calls): {ms:.3f} ms{share}" + (
              "" if ms else " (the profiler gave the range no "
              "device time: not measured)"), flush=True)


def ranged(cfg) -> bool:
    """Whether ``cfg``'s model has profiler ranges (model_ranges)."""
    return (cfg.family in ("moe", "ssm", "hybrid") or cfg.attn_type == "mla"
            or cfg.modality == "vision")


def model_ranges(cfg):
    """The profiler ranges of ``cfg``'s model: moe_ranges for an MoE
    model, mla_ranges for MLA attention (both for deepseek-v2-lite-16b),
    mamba_ranges for Mamba2, for the hybrid both mamba_ranges and
    hybrid_ranges, and prefix_ranges for a vision model."""
    stack = contextlib.ExitStack()
    if cfg.family == "moe":
        stack.enter_context(moe_ranges())
    if cfg.attn_type == "mla":
        stack.enter_context(mla_ranges())
    if cfg.family in ("ssm", "hybrid"):
        stack.enter_context(mamba_ranges())
    if cfg.family == "hybrid":
        stack.enter_context(hybrid_ranges())
    if cfg.modality == "vision":
        stack.enter_context(prefix_ranges())
    return stack


def print_ranges(torch, cfg, label, prof, busy):
    if cfg.family == "moe":
        print_moe_ranges(torch, label, prof, busy)
    if cfg.attn_type == "mla":
        print_mla_ranges(torch, label, prof, busy)
    if cfg.family in ("ssm", "hybrid"):
        print_mamba_ranges(torch, label, prof, busy)
    if cfg.family == "hybrid":
        print_hybrid_ranges(torch, label, prof, busy)
    if cfg.modality == "vision":
        print_prefix_ranges(torch, label, prof, busy)


def range_ms(torch, prof, names):
    """Device ms of each named range in a profile (its kernels and its
    children's), and how many times it ran."""
    out = {n: [0.0, 0] for n in names}
    for e in prof.events():
        if e.name in out and e.device_type == torch.autograd.DeviceType.CPU:
            out[e.name][0] += e.device_time_total / 1e3
            out[e.name][1] += 1
    return out


def print_moe_ranges(torch, label, prof, busy):
    r = range_ms(torch, prof, MOE_RANGES)
    (ffn, n), route, experts, casts = (r[k] for k in MOE_RANGES)
    rest = ffn - route[0] - experts[0]
    share = lambda x: f" ({x / busy:.1%})" if busy else ""
    print(f"[profile] {label} MoE ({n} calls): moe_ffn {ffn:.3f} ms"
          f"{share(ffn)} = routing {route[0]:.3f}{share(route[0])} + experts "
          f"{experts[0]:.3f}{share(experts[0])} (of it the expert weight "
          f"casts {casts[0]:.3f}{share(casts[0])}, the bmm and the SwiGLU "
          f"{experts[0] - casts[0]:.3f}) + router matmul, dispatch and "
          f"combine {rest:.3f}{share(rest)}" + (
              "" if ffn else " (the profiler gave the ranges no device "
              "time: not measured)"), flush=True)


def print_mla_ranges(torch, label, prof, busy):
    """MLA's attention ms and its parts."""
    r = range_ms(torch, prof, MLA_RANGES)
    (whole, n), *parts = (r[k] for k in MLA_RANGES)
    share = lambda x: f" ({x / busy:.1%})" if busy else ""
    named = ", ".join(f"{k.split('.')[1]} {ms:.3f}{share(ms)} (x{c})"
                      for k, (ms, c) in zip(MLA_RANGES[1:], parts) if c)
    rest = whole - sum(ms for ms, _ in parts)
    print(f"[profile] {label} MLA attention ({n} calls): {whole:.3f} ms"
          f"{share(whole)} = {named} + projections, norms, rope and wo "
          f"{rest:.3f}{share(rest)}" + (
              "" if whole else " (the profiler gave the ranges no device "
              "time: not measured)"), flush=True)


def print_mamba_ranges(torch, label, prof, busy):
    """The Mamba2 mixers' ms, their parts, and the SSD's share (intra-chunk,
    chunk states and recurrence, inter-chunk)."""
    r = range_ms(torch, prof, MAMBA_RANGES)
    (whole, n), *parts = (r[k] for k in MAMBA_RANGES)
    share = lambda x: f" ({x / busy:.1%})" if busy else ""
    named = ", ".join(f"{k.split('.')[1]} {ms:.3f}{share(ms)} (x{c})"
                      for k, (ms, c) in zip(MAMBA_RANGES[1:], parts) if c)
    ssd = sum(r[k][0] for k in ("mamba.ssd_intra", "mamba.ssd_states",
                                "mamba.ssd_inter"))
    rest = whole - sum(ms for ms, _ in parts)
    print(f"[profile] {label} Mamba2 mixers ({n} calls): {whole:.3f} ms"
          f"{share(whole)} = {named} + skip, B/C split and window writes "
          f"{rest:.3f}{share(rest)}; the SSD scan {ssd:.3f} ms{share(ssd)}"
          + ("" if whole else " (the profiler gave the ranges no device "
             "time: not measured)"), flush=True)


def print_hybrid_ranges(torch, label, prof, busy):
    """The shared block's ms at its sites and its parts: w_fuse, the
    attention (its torch ops by range, the flash kernels by name) and the
    MLP."""
    r = range_ms(torch, prof, HYBRID_RANGES)
    (ops, n), (fuse, _), (att, _), (mlp, _) = (r[k] for k in HYBRID_RANGES)
    flash = [(getattr(e, "self_device_time_total", 0) / 1e3, e.count)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and ("flash_decode" in e.key or "flash_prefill" in e.key)]
    kern, nk = sum(f[0] for f in flash), sum(f[1] for f in flash)
    whole = ops + kern
    share = lambda x: f" ({x / busy:.1%})" if busy else ""
    rest = ops - fuse - att - mlp
    print(f"[profile] {label} shared block ({n} sites): {whole:.3f} ms"
          f"{share(whole)} = w_fuse {fuse:.3f}{share(fuse)} + attention "
          f"{att + kern:.3f}{share(att + kern)} (its torch ops "
          f"{att:.3f}, the flash kernels {kern:.3f}{share(kern)} in {nk} "
          f"launches) + MLP {mlp:.3f}{share(mlp)} + norms and residuals "
          f"{rest:.3f}{share(rest)}" + (
              "" if ops else " (the profiler gave the ranges no device "
              "time: not measured)"), flush=True)


def attention_launches(cfg, label, before, after, name, tag):
    """Print the launches of the attention kernel ``name`` between two
    read_counts; a hybrid model's shared block must launch it once at
    each of its sites, num_layers / hybrid_attn_every times, and a vision
    model's decode step once a layer."""
    n = after[name] - before[name]
    print(f"[{tag}] {cfg.name} {label}: {name} launches {n}", flush=True)
    if cfg.modality == "vision" and name == "flash_decode":
        if n != cfg.num_layers:
            fail(f"{tag} {label}: {name} launched {n} times, not once in "
                 f"each of the {cfg.num_layers} layers")
    if cfg.family == "hybrid":
        sites = cfg.num_layers // cfg.hybrid_attn_every
        if n != sites:
            fail(f"{tag} {label}: {name} launched {n} times, not once at "
                 f"each of the shared block's {sites} sites")


def profile_phase(torch, arch="starcoder2-7b", layers=0, prefill=True,
                  tag="profile", labels=("base", "multi-tenant f32"),
                  analysis=None):
    """Where a full-width decode step (B=8) spends its device time: the
    base model, and multi-tenant with every request on an adapter or the
    base; then (``prefill``) one batch-1, 1024-token prefill of the base
    model, a lane admission's unit of work. Device time per kernel from
    torch.profiler, an MoE model's also per range (``moe_ranges``); wall
    time from the host clock around synchronized steps (decode: mean of 3;
    prefill: one, after a warm-up; profiler off). With ``analysis`` (a
    dict), each step's ``program_cost``, its device and wall ms and its
    shape land there by label, and a traced lane-engine run of base
    decode (``traced_lanes``) under "lanes", for ``analysis_phase``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.analysis.profile import memory_summary, program_cost
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serving import MultiTenantEngine
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    P = cfg.prefix_rows
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                      if ranged(cfg) else [])
    zero_counts()
    params = lm.init_params(cfg, seed=0, device="cuda")
    eng = MultiTenantEngine(cfg, params)
    for p in serve.make_adapters(cfg, params, 3, multi_tenant=True):
        eng.register(p)
    names = ["adapter_0", "adapter_1", None, "adapter_2"] * (B // 4)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    batch = with_patches(torch, cfg, {"tokens": torch.randint(
        0, cfg.vocab_size, (B, PROMPT), generator=gen, device="cuda")})
    for label, p in (("base", params),
                     ("multi-tenant f32",
                      eng.wrapped_params(eng.ids_for(names)))):
        if label not in labels:
            continue
        logits, caches = lm.prefill(p, cfg, batch, P + PROMPT + 8)
        nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]

        def step():
            lm.decode_step(p, cfg, nxt, caches, P + PROMPT)
            torch.cuda.synchronize()
        step()
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        wall = (time.perf_counter() - t0) / 3 * 1e3
        before = read_counts()
        with model_ranges(cfg):
            with profile(activities=acts) as prof:
                step()
        if cfg.attn_type == "gqa":
            attention_launches(cfg, f"{label} decode step", before,
                               read_counts(), "flash_decode", tag)
        kern = device_kernels(torch, prof)
        busy = sum(k[0] for k in kern)
        print(f"[{tag}] {arch} {label} decode step (B={B}, "
              f"{cfg.num_layers} layers{f', {P} prefix rows' if P else ''}"
              f"): wall {wall:.2f} ms; kernels "
              f"{busy:.2f} ms in {sum(k[1] for k in kern)} launches"
              + (f" ({busy / wall:.0%} of wall)" if busy else
                 " (profiler saw no device time: not measured)"),
              flush=True)
        for ms, n, name in sorted(kern, reverse=True)[:8]:
            print(f"[{tag}]   {ms:8.3f} ms  x{n:<4d} {name[:90]}")
        kernel_share(f"{arch} {label}", kern)
        print_ranges(torch, cfg, f"{arch} {label}", prof, busy)
        if analysis is not None:
            analysis[label] = {
                "cost": program_cost(lm.decode_step, p, cfg, nxt, caches,
                                     P + PROMPT),
                "device_ms": busy, "wall_ms": wall, "cfg": cfg,
                "shape": ShapeSpec(f"decode, B={B}", P + PROMPT + 8, B,
                                   "decode")}
    eng.close()
    if analysis is not None:
        analysis["lanes"] = traced_lanes(torch, cfg, params)
    if not prefill:
        check_run(f"{tag} {arch}", read_counts(), (), {},
                  attention_kernels(cfg)[1])
        return

    # a lane admission's unit of work: one batch-1, 1024-token prefill (a
    # vision model's: its patches and 1024 - P tokens)
    pre = with_patches(torch, cfg, {"tokens": torch.randint(
        0, cfg.vocab_size, (1, 1024 - P), generator=gen, device="cuda")})
    what = f"{P} patches + {1024 - P} tokens" if P else "S=1024"

    def run_prefill():
        lm.prefill(params, cfg, pre, CACHE + P)
        torch.cuda.synchronize()
    run_prefill()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run_prefill()
    wall = (time.perf_counter() - t0) * 1e3
    transient = (torch.cuda.max_memory_allocated() - before) / 1e9
    counts = read_counts()
    with model_ranges(cfg):
        with profile(activities=acts) as prof:
            run_prefill()
    if cfg.attn_type == "gqa":
        attention_launches(cfg, f"prefill (B=1, {what})", counts,
                           read_counts(), "flash_prefill", tag)
    kern = device_kernels(torch, prof)
    busy = sum(k[0] for k in kern)
    fp = sum(ms for ms, _, name in kern if "flash_prefill" in name)
    print(f"[{tag}] {arch} base prefill (B=1, {what}, {cfg.num_layers} "
          f"layers): wall {wall:.2f} ms, peak memory above the model's "
          f"{transient:.3f} GB; kernels {busy:.2f} ms"
          + (f"; flash_prefill {fp:.3f} ms ({fp / busy:.1%})" if busy else
             " (profiler saw no device time: not measured)"), flush=True)
    for ms, n, name in sorted(kern, reverse=True)[:8]:
        print(f"[{tag}]   {ms:8.3f} ms  x{n:<4d} {name[:90]}")
    print_ranges(torch, cfg, f"{arch} base prefill", prof, busy)
    if analysis is not None:
        analysis["base prefill"] = {
            "cost": program_cost(lm.prefill, params, cfg, pre, CACHE + P),
            "memory": memory_summary(lm.prefill, params, cfg, pre,
                                     CACHE + P),
            "device_ms": busy, "wall_ms": wall, "cfg": cfg,
            "shape": ShapeSpec(f"prefill, B=1, S={1024 - P}", 1024 - P, 1,
                               "prefill")}
    check_run(f"{tag} {arch}", read_counts(), (), {},
              attention_kernels(cfg)[1])


def consistency_phase(torch, arch="starcoder2-7b", tag="consistency"):
    """Full width, 2 layers, f32: multi-tenant tokens equal the
    switch-per-request reference, unfused and with a hot adapter (a
    vision model's requests with seeded patch embeddings, each its own in
    the reference)."""
    from repro_torch.configs import get_config
    from repro_torch.core import FusedLRU
    from repro_torch.launch import serve
    from repro_torch.models import layers, lm
    from repro_torch.serving import MultiTenantEngine
    from repro_torch.serving.multitenant import (greedy_decode,
                                                 serving_cache_size,
                                                 switch_per_request_reference)
    cfg = two_layers(get_config(arch))
    names = ["adapter_0", "adapter_2", None, "adapter_1", "adapter_0",
             "adapter_1", None, "adapter_2"]
    T = 8
    with layers.compute_precision(torch.float32):
        params = lm.init_params(cfg, seed=0, device="cuda")
        packs = serve.make_adapters(cfg, params, 3, multi_tenant=True)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(3)
        toks = torch.randint(0, cfg.vocab_size, (len(names), PROMPT),
                             generator=gen, device="cuda")
        batch = with_patches(torch, cfg, {"tokens": toks}, gen)
        ref, ref_logits, _ = switch_per_request_reference(
            cfg, params, packs, toks, names, T, batch.get("patch_embeds"))
        # promote_at 0.1: adapter_0 wins the three-way tie on its name
        for label, sched in (("unfused", None),
                             ("adapter_0 fused", FusedLRU(promote_at=0.1,
                                                          demote_at=0.0))):
            eng = MultiTenantEngine(cfg, params, scheduler=sched)
            for p in packs:
                eng.register(p)
            out, _ = eng.generate(batch, names, T)
            p = eng.wrapped_params(eng.ids_for(names))
            _, logits = greedy_decode(
                cfg, batch, T, lambda b: lm.prefill(
                    p, cfg, b, serving_cache_size(cfg, PROMPT, T)),
                lambda t, c, pos: lm.decode_step(p, cfg, t, c, pos))
            equal = bool(torch.equal(out, ref))
            diff = float((logits - ref_logits).abs().max())
            print(f"[{tag}] {arch} f32, {cfg.num_layers} layers, full "
                  f"width, {label}: tokens equal {equal}, last-step "
                  f"logits max diff {diff:.3g}", flush=True)
            if not equal or (sched is not None and eng.fused != "adapter_0"):
                fail(f"{tag} {arch} {label}: multi-tenant tokens differ "
                     "from the switch-per-request reference")
            eng.close()


KERNEL_COUNTERS = ("sidedelta", "sidedelta_dvals", "scatter_apply",
                   "sparse_adamw_blocks", "sparse_adamw_rows", "flash_decode",
                   "flash_decode_paged", "flash_prefill", "masked_update")


def counters():
    """The launch counter of every kernel wrapper of the port, by the
    kernel's name in the summary."""
    from repro_torch.kernels.flash_decode import (flash_decode_blocks,
                                                  flash_decode_paged)
    from repro_torch.kernels.flash_prefill import flash_prefill_blocks
    from repro_torch.kernels.masked_update import masked_update
    from repro_torch.kernels.scatter_apply import scatter_apply
    from repro_torch.kernels.sidedelta import sidedelta, sidedelta_dvals
    from repro_torch.kernels.sparse_adamw import (sparse_adamw,
                                                  sparse_adamw_rows)
    return dict(zip(KERNEL_COUNTERS, (sidedelta, sidedelta_dvals,
                                      scatter_apply, sparse_adamw,
                                      sparse_adamw_rows, flash_decode_blocks,
                                      flash_decode_paged,
                                      flash_prefill_blocks, masked_update)))


def zero_counts():
    from repro_torch.kernels.flash_decode import flash_decode_blocks
    for fn in counters().values():
        fn.launches = 0
    flash_decode_blocks.lse_launches = 0


def read_counts():
    """Each counter's launches, and flash_decode's log-sum-exp instance's
    (which its ``launches`` count too) as "flash_decode (lse)"."""
    from repro_torch.kernels.flash_decode import flash_decode_blocks
    out = {k: fn.launches for k, fn in counters().items()}
    out["flash_decode (lse)"] = flash_decode_blocks.lse_launches
    return out


def check_run(label, counts, needed, totals, absent=()):
    """Fail unless every kernel of ``needed`` launched and none of
    ``absent`` did; add the counts to ``totals``."""
    for k in needed:
        if counts[k] <= 0:
            fail(f"{label}: kernel {k} was never launched")
    for k in absent:
        if counts[k]:
            fail(f"{label}: kernel {k} launched {counts[k]} times on a "
                 "path that must not run it")
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v


def attention_kernels(cfg, *names):
    """(needed, absent) attention kernels of a serving path: GQA needs
    ``names``; MLA's attention is plain torch (no TPU kernel computes it,
    as the reference's calls none) and Mamba2 has no attention, so there
    no attention kernel may launch; a hybrid model's shared block pages
    nothing (the paged engine refuses the family), so flash_decode_paged
    may not; a vision model pages nothing either, and prefills its patch
    prefix through the plain chunked_attention, so neither
    flash_decode_paged nor flash_prefill may launch."""
    if cfg.attn_type != "gqa":
        return (), ATTN_KERNELS
    if cfg.family == "hybrid":
        return names, ("flash_decode_paged",)
    if cfg.modality == "vision":
        return (tuple(n for n in names if n != "flash_prefill"),
                ("flash_decode_paged", "flash_prefill"))
    return names, ()


def two_layers(cfg):
    """``cfg`` cut for the f32 consistency phases: 2 layers, a hybrid
    model 2 groups (2 x hybrid_attn_every layers)."""
    return cfg.replace(num_layers=2 * (cfg.hybrid_attn_every or 1))


def train_phase(torch, arch="starcoder2-7b", tag="train", layers=0):
    """Full-width training through the entry points a user calls: the
    launch.train CLI (one packed adapter, Trainer), then
    MultiAdapterTrainer with 3 adapters, f32 then int8 moments. An MoE
    model's aux (the loss adds 0.01 of it) and dropped routing choices
    are printed per step: a step's 2048 or 1536 tokens are one call of
    each layer, whose capacity may drop choices, as the reference's
    does. A vision model's sequences hold its patch prefix besides (256 +
    256 positions), an audio model's are frames; neither has a
    multi-adapter trainer, which must refuse them (``multi_refused``)."""
    import math
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import (AdapterConfig, RunConfig, ShapeSpec,
                                     TrainConfig, get_config)
    from repro_torch.launch import train
    from repro_torch.kernels.sidedelta import sidedelta_dvals
    from repro_torch.kernels.sparse_adamw import (sparse_adamw,
                                                  sparse_adamw_rows)
    from repro_torch.training import MultiAdapterTrainer
    from repro_torch.models.moe import count_drops
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    moe = cfg.family == "moe"
    seq = TRAIN_SEQ + cfg.prefix_rows
    _, absent = attention_kernels(cfg)
    totals = {}
    zero_counts()
    sparse_adamw.unaligned_launches = sparse_adamw_rows.unaligned_launches = 0
    sidedelta_dvals.unaligned_launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with count_drops() as drops:
        stats = train.main(["--arch", arch, "--adapter", "shira-rand",
                            "--seq", str(seq), "--batch",
                            str(TRAIN_BATCH), "--steps", str(TRAIN_STEPS)]
                           + (["--layers", str(layers)] if layers else []),
                           keep=True)
    torch.cuda.synchronize()
    counts = read_counts()
    losses = stats["losses"]
    print(f"[{tag}] {arch} Trainer (launch.train, {cfg.num_layers} layers, "
          f"{TRAIN_BATCH}x{seq} positions,"
          f" {stats['trained_values']} packed values): launches {counts}, "
          f"step {stats['steady_step_ms']:.1f} ms (median after the first; "
          f"all {[round(x, 1) for x in stats['step_ms']]}), "
          f"{stats['tokens_per_s']:.0f} {stats['rate_unit']}, loss "
          f"{losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB, "
          f"{time.perf_counter() - t0:.1f}s wall", flush=True)
    if moe:
        moe_train_line(tag, "Trainer", stats["trainer"].cfg, stats["aux"],
                       drops, TRAIN_STEPS)
    if not all(math.isfinite(x) for x in losses):
        fail("Trainer: a loss is not finite")
    check_run("Trainer", counts, ("scatter_apply", "sparse_adamw_blocks"),
              totals, absent)
    tr, state = stats.pop("trainer"), stats.pop("state")
    publish_check(torch, "Trainer", lambda store: [
        tr.publish(store, state, "adapter")], [tr.export_pack(state,
                                                             "adapter")])
    c_shira = percent_changed(torch, tr, state)
    print(f"[{tag}] {arch} Trainer (packed SHiRA) %C of the effective "
          f"weights, "
          f"layer by layer: {c_shira:.6f}", flush=True)
    del stats, tr, state
    torch.cuda.empty_cache()
    if cfg.modality != "text":
        multi_refused(torch, cfg, tag)
        if sparse_adamw.unaligned_launches:
            fail("train: a sparse_adamw update took the one-element "
                 "instance")
        return totals, c_shira

    run = RunConfig(model=cfg,
                    shape=ShapeSpec("mt", MT_SEQ, MT_BATCH, "train"),
                    adapter=AdapterConfig(kind="shira", mask="rand",
                                          sparsity=0.98),
                    train=TrainConfig(learning_rate=3e-4,
                                      total_steps=2 * MT_STEPS,
                                      warmup_steps=1))
    names = [f"adapter_{a}" for a in range(3)]
    base = auxes = None
    for moments in ("f32", "int8"):
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mt = MultiAdapterTrainer(run, names, moments=moments,
                                 base_params=base, auxes=auxes)
        base, auxes = mt.base, mt.auxes
        setup_s = time.perf_counter() - t0
        with count_drops() as drops:
            out = mt.fit(MT_STEPS, log=None)
        torch.cuda.synchronize()
        counts = read_counts()
        hist = out["history"]
        step_ms = [h["step_ms"] for h in hist]
        steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
        tokens = 3 * MT_BATCH * MT_SEQ
        values = out["state"]["values"]
        finite = all(bool(torch.isfinite(v).all()) for v in values.values())
        print(f"[{tag}] {arch} MultiAdapterTrainer 3 adapters, {moments} "
              f"moments, {cfg.num_layers} layers "
              f"({tokens} tokens a step, "
              f"{sum(v.numel() for v in values.values())} packed values): "
              f"launches {counts}, step {steady:.1f} ms (median after the "
              f"first; all {[round(x, 1) for x in step_ms]}), "
              f"{tokens / steady * 1e3:.0f} tokens/s, loss "
              f"{hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, peak "
              f"memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB, "
              f"set-up {setup_s:.1f}s, {time.perf_counter() - t0:.1f}s wall",
              flush=True)
        if moe:
            print(f"[{tag}] {arch} MultiAdapterTrainer {moments}: aux "
                  f"{[round(h['aux'], 4) for h in hist]}, dropped routing "
                  f"choices a step {drops_per_step(drops, MT_STEPS)}",
                  flush=True)
        if not finite or not all(math.isfinite(h["loss"]) for h in hist):
            fail(f"MultiAdapterTrainer {moments}: not finite")
        check_run(f"MultiAdapterTrainer {moments}", counts,
                  ("sidedelta", "sidedelta_dvals", "sparse_adamw_rows"),
                  totals, absent)
        if moments == "f32":
            profile_train_step(torch, profile, ProfilerActivity, mt, out)
            publish_check(torch, "MultiAdapterTrainer",
                          lambda store: mt.publish(store, out["state"]),
                          mt.export_packs(out["state"]))
        del mt, out, values
        torch.cuda.empty_cache()
    unaligned = (sparse_adamw.unaligned_launches,
                 sparse_adamw_rows.unaligned_launches)
    print(f"[train] sparse_adamw one-element (unaligned) launches over the "
          f"three runs: blocks {unaligned[0]}, rows {unaligned[1]}",
          flush=True)
    if any(unaligned):
        fail("train: a sparse_adamw update took the one-element instance")
    print(f"[train] sidedelta_dvals one-token (unaligned) launches over the "
          f"two multi-adapter runs: {sidedelta_dvals.unaligned_launches}",
          flush=True)
    if sidedelta_dvals.unaligned_launches:
        fail("train: a dvals launch took the one-token instance")
    return totals, c_shira


def multi_refused(torch, cfg, tag):
    """Fail unless MultiAdapterTrainer refuses ``cfg`` (a vision or audio
    model) with the reference's NotImplementedError at its first step;
    its tables are built at 2 layers for the time it takes."""
    from repro_torch.configs import (AdapterConfig, RunConfig, ShapeSpec,
                                     TrainConfig)
    from repro_torch.training import MultiAdapterTrainer
    run = RunConfig(model=two_layers(cfg), shape=ShapeSpec(
        "r", 16 + cfg.prefix_rows, 1, "train"),
                    adapter=AdapterConfig(kind="shira", mask="rand",
                                          sparsity=0.98),
                    train=TrainConfig(total_steps=1, warmup_steps=1))
    mt = MultiAdapterTrainer(run, ["a0", "a1"])
    try:
        mt.fit(1, log=None)
    except NotImplementedError as e:
        if "text modality only" not in str(e):
            fail(f"{tag}: MultiAdapterTrainer refused {cfg.name} with "
                 f"another message: {e}")
        print(f"[{tag}] {cfg.name} MultiAdapterTrainer refused at its first "
              f"step, as the reference's: NotImplementedError({str(e)!r})",
              flush=True)
    else:
        fail(f"{tag}: MultiAdapterTrainer trained {cfg.name}")
    del mt
    torch.cuda.empty_cache()


def drops_per_step(drops, steps):
    """The dropped routing choices of each step, from ``count_drops``'s
    list of every MoE call of the run (the same number of calls a
    step)."""
    per = len(drops) // steps
    return [int(sum(int(d) for d in drops[i * per:(i + 1) * per]))
            for i in range(steps)]


def moe_train_line(tag, label, cfg, aux, drops, steps):
    """A trainer's MoE aux and dropped routing choices, step by step."""
    from repro_torch.models.moe import expert_capacity
    T = TRAIN_BATCH * TRAIN_SEQ
    print(f"[{tag}] {cfg.name} {label}: aux {[round(a, 4) for a in aux]}, "
          f"dropped routing choices a step {drops_per_step(drops, steps)} "
          f"({len(drops) // steps} MoE calls a step, each of "
          f"{T * cfg.moe.top_k} choices into {cfg.moe.num_experts} experts "
          f"of capacity {expert_capacity(cfg.moe, T)})", flush=True)


def percent_changed(torch, tr, state) -> float:
    """%C of a Trainer's effective weights against its base (the paper's
    Tab. 2 column), through the lazy bundles layer by layer: no effective
    leaf is built whole."""
    from repro_torch import core
    eff = core.materialize(tr.base, state["trainable"], tr.aux, tr.acfg,
                           alpha=1.0)
    c = core.changed_fraction(tr.base, eff)
    torch.cuda.synchronize()
    return c


def publish_check(torch, label, publish, trained):
    """Publish a trainer's packs into a store (``publish(store)`` returns
    the versioned ids) and hold each stored pack, read back from its file,
    equal to the trained pack: the same indices, the same f32 values."""
    import tempfile
    from repro_torch.hub import AdapterStore
    with tempfile.TemporaryDirectory(prefix="publish-") as root:
        store = AdapterStore(root)
        t0 = time.perf_counter()
        vids = publish(store)
        dt = time.perf_counter() - t0
        for vid, want in zip(vids, trained):
            got = store.get(vid)
            same = got.entries.keys() == want.entries.keys() and all(
                torch.equal(got.entries[p][0], i.cpu())
                and torch.equal(got.entries[p][1], v.detach().float().cpu())
                for p, (i, v) in want.entries.items())
            if not same or vid != f"{want.name}@1":
                fail(f"{label}.publish: {vid} does not hold the trained "
                     "values")
        values = sum(p.num_params() for p in trained)
        print(f"[train] {label}.publish: {vids} ({values} values) in "
              f"{dt:.1f}s, read back equal to the trained packs", flush=True)


def profile_train_step(torch, profile, ProfilerActivity, mt, out):
    """Device time by kernel of one more multi-adapter step (an MoE
    model's also by ``moe_ranges``, MLA's by ``mla_ranges``)."""
    from repro_torch.runtime.trainer import device_batch
    from repro_torch.training import multi_batch_iterator
    from repro_torch.data import TaskSpec
    batch = device_batch(next(multi_batch_iterator(
        mt.cfg, mt.run.shape, 0, [TaskSpec(a) for a in range(mt.A)],
        start_step=MT_STEPS)), mt.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                      if ranged(mt.cfg) else [])
    with model_ranges(mt.cfg):
        with profile(activities=acts) as prof:
            mt.step(out["state"], batch)
            torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    kern = device_kernels(torch, prof)
    busy = sum(k[0] for k in kern)
    print(f"[profile] {mt.cfg.name} multi-adapter train step (3 adapters, "
          f"f32 moments): "
          f"wall {wall:.1f} ms (profiler on); kernels {busy:.1f} ms"
          + (f" ({busy / wall:.0%} of wall)" if busy else
             " (profiler saw no device time: not measured)"), flush=True)
    for ms, n, name in sorted(kern, reverse=True)[:10]:
        print(f"[profile]   {ms:9.3f} ms  x{n:<5d} {name[:90]}")
    kernel_share("multi-adapter step", kern)
    print_ranges(torch, mt.cfg, f"{mt.cfg.name} multi-adapter step", prof,
                 busy)


def train_consistency_phase(torch):
    """The JAX package's multi-adapter contract with the kernels in the
    loop: full width, 2 layers, f32 on the card, adapter a of
    MultiAdapterTrainer (fused) against Trainer(init a) on task a.

    Held: (1) the first step's value gradients, the sidedelta kernels'
    against materialize's dense gradient, to GRAD_TOL of each leaf's
    largest; (2) the losses of 3 steps to TRAIN_TOL; (3) the packed values
    after 3 steps to rtol = atol = TRAIN_TOL at every entry whose
    first-step gradient is not within (1)'s bound of zero. At those few
    entries the two f32 summation orders may disagree on the sign, and
    Adam's normalised first step (about lr * g / |g|) turns either sign
    into a full +-lr move; they are counted and printed, and held to the
    largest move that can make: 2 * lr * steps."""
    from repro_torch.configs import (AdapterConfig, RunConfig, ShapeSpec,
                                     TrainConfig, get_config)
    from repro_torch.data import TaskSpec, batch_iterator
    from repro_torch.models import layers
    from repro_torch.runtime import Trainer
    from repro_torch.runtime.trainer import device_batch
    from repro_torch.training import MultiAdapterTrainer, multi_batch_iterator
    cfg = get_config("starcoder2-7b").replace(num_layers=2)
    lr, steps = 1e-2, 3
    run = RunConfig(model=cfg, shape=ShapeSpec("c", 64, 2, "train"),
                    adapter=AdapterConfig(kind="shira", mask="rand",
                                          sparsity=0.98),
                    train=TrainConfig(learning_rate=lr, total_steps=steps,
                                      warmup_steps=1))
    names = [f"a{a}" for a in range(3)]
    tasks = [TaskSpec(a) for a in range(3)]
    with layers.compute_precision(torch.float32):
        mt = MultiAdapterTrainer(run, names, init_key=0)
        _, g_mt, _ = mt.loss_and_grads(mt.init_state()["values"], device_batch(
            next(multi_batch_iterator(cfg, run.shape, 0, tasks)), "cuda"))
        out = mt.fit(steps, log=None)
        packs = mt.export_packs(out["state"])
        for a, pack in enumerate(packs):
            tr = Trainer(run, init_key=a, base_params=mt.base)
            stream = lambda: batch_iterator(cfg, run.shape, seed=0,
                                            task=tasks[a])
            _, _, g_tr = tr.loss_and_grads(
                tr.init_state()["trainable"],
                device_batch(next(stream()), "cuda"))
            ref = tr.fit(steps, log=None, batches=stream())
            ref_pack = tr.export_pack(ref["state"], pack.name)
            loss_d = max(abs(h[f"loss:{pack.name}"] - r["loss"])
                         for h, r in zip(out["history"], ref["history"]))
            grad_rel, val_d, undetermined, moved, ok = 0.0, 0.0, 0, 0, True
            for p, (idx, v) in pack.entries.items():
                gt, gm = g_tr[p], g_mt[p][a]
                bound_g = GRAD_TOL * float(gt.abs().max())
                grad_rel = max(grad_rel, float((gm - gt).abs().max())
                               / float(gt.abs().max()))
                d = (v - ref_pack.entries[p][1]).abs()
                free = gt.abs() <= bound_g
                held = ~free
                val_d = max(val_d, float(d[held].max()))
                undetermined += int(free.sum())
                moved += int((d[free] > TRAIN_TOL).sum())
                ok &= bool(torch.equal(idx, ref_pack.entries[p][0]))
                ok &= bool((d[held] <= TRAIN_TOL * (
                    1 + ref_pack.entries[p][1][held].abs())).all())
                ok &= bool((d <= 2 * lr * steps).all())
            print(f"[train-consistency] f32, 2 layers, full width, adapter "
                  f"{a}: first-step value gradients max diff "
                  f"{grad_rel:.3g} of their largest (tol {GRAD_TOL}); loss "
                  f"max diff {loss_d:.3g}; packed values max diff "
                  f"{val_d:.3g} (tol rtol=atol={TRAIN_TOL}) at entries "
                  f"with a determined gradient sign; {undetermined} entries "
                  f"with |g| <= {GRAD_TOL} of the largest, {moved} of them "
                  f"apart by more than {TRAIN_TOL}", flush=True)
            if (not ok or grad_rel > GRAD_TOL
                    or not loss_d <= TRAIN_TOL * (1 + abs(
                        ref["history"][0]["loss"]))):
                fail(f"train-consistency: adapter {a} departs from its "
                     "single-adapter Trainer")
            del tr, ref, ref_pack, g_tr


def wm_ties(torch, tr):
    """How often the wm mask's K-th largest |W| of a matrix is tied with
    an entry left out (where torch.topk's own order would pick apart from
    lax.top_k's). Returns (matrices with such a tie, matrices, tied
    entries beyond the K)."""
    from repro_torch.core.masks import budget, iter_leaves
    masks = dict(iter_leaves(tr.masks))
    tied = rows = extra = 0
    for p, w in iter_leaves(tr.base):
        if p not in masks:
            continue
        k = budget(*w.shape[-2:], tr.acfg.sparsity)
        for r in w.reshape(-1, w.shape[-2] * w.shape[-1]):
            s = r.abs()
            kth = torch.topk(s, k, sorted=False).values.min()
            over = int((s >= kth).sum()) - k
            rows += 1
            tied += over > 0
            extra += over
    return tied, rows, extra


def profile_hook_step(torch, tr, state):
    """Device time by kernel of one more hook-mode step (its launches are
    not counted: the counts were read before it)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import batch_iterator
    from repro_torch.runtime.trainer import device_batch
    batch = device_batch(next(batch_iterator(tr.cfg, tr.run.shape, seed=1)),
                         tr.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tr.step(state, batch)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    kern = device_kernels(torch, prof)
    busy = sum(k[0] for k in kern)
    print(f"[profile] hook-mode train step ({HOOK_LAYERS} layers): wall "
          f"{wall:.1f} ms (profiler on); kernels {busy:.1f} ms"
          + (f" ({busy / wall:.0%} of wall)" if busy else
             " (profiler saw no device time: not measured)"), flush=True)
    for ms, n, name in sorted(kern, reverse=True)[:12]:
        print(f"[profile]   {ms:9.3f} ms  x{n:<5d} {name[:90]}")


def hook_round_trip(torch, tr, state):
    """Export the hook trainer's pack, check its %C, and load it onto the
    trainer's base through SwitchEngine (scatter_apply, in place): the
    loaded target leaves must equal the trained weights within
    ROUND_TRIP_TOL of the largest. Returns (pack, %C, largest diff)."""
    from repro_torch.core import SwitchEngine, changed_fraction
    from repro_torch.core.masks import budget, iter_leaves
    pack = tr.export_pack(state, "hook")
    frac = changed_fraction(tr.base, state["trainable"])
    total = sum(x.numel() for _, x in iter_leaves(tr.base))
    most = sum(m.numel() // (m.shape[-2] * m.shape[-1])
               * budget(*m.shape[-2:], tr.acfg.sparsity)
               for _, m in iter_leaves(tr.masks)) / total
    if not 0 < frac <= most:
        fail(f"hook export: %C {frac} outside (0, {most}]")
    SwitchEngine(tr.base).switch(pack)
    trained = dict(iter_leaves(state["trainable"]))
    diff, scale = 0.0, 0.0
    for p, w in iter_leaves(tr.base):
        if p in pack.entries:
            diff = max(diff, float((w - trained[p]).abs().max()))
            scale = max(scale, float(trained[p].abs().max()))
    if not diff <= ROUND_TRIP_TOL * scale:
        fail(f"hook export: the loaded pack is {diff} from the trained "
             f"weights (tol {ROUND_TRIP_TOL} of {scale})")
    return pack, frac, most, diff, scale


def train_masks_phase(torch):
    """The reference's default adapter at full width: the launch.train CLI
    with --adapter shira-wm (packed, all layers), then hook mode (shira-wm,
    packed=False) through the Trainer API at full width cut to
    HOOK_LAYERS layers, its pack exported and loaded back."""
    import math
    import statistics
    from repro_torch.configs import (AdapterConfig, RunConfig, ShapeSpec,
                                     TrainConfig, get_config)
    from repro_torch.core.masks import iter_leaves
    from repro_torch.launch import train
    from repro_torch.runtime import Trainer
    totals = {}
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = train.main(["--arch", "starcoder2-7b", "--adapter", "shira-wm",
                        "--seq", str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH),
                        "--steps", str(TRAIN_STEPS)])
    torch.cuda.synchronize()
    counts = read_counts()
    losses = stats["losses"]
    print(f"[train] Trainer shira-wm (launch.train, packed, "
          f"{TRAIN_BATCH}x{TRAIN_SEQ} tokens, {stats['trained_values']} "
          f"packed values): wm mask built in {stats['mask_seconds']:.2f}s, "
          f"launches {counts}, step {stats['steady_step_ms']:.1f} ms (median"
          f" after the first; all {[round(x, 1) for x in stats['step_ms']]})"
          f", {stats['tokens_per_s']:.0f} tokens/s, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB, "
          f"{time.perf_counter() - t0:.1f}s wall", flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail("Trainer shira-wm: a loss is not finite")
    check_run("Trainer shira-wm", counts,
              ("scatter_apply", "sparse_adamw_blocks"), totals)
    del stats
    torch.cuda.empty_cache()

    cfg = get_config("starcoder2-7b").replace(num_layers=HOOK_LAYERS)
    run = RunConfig(model=cfg,
                    shape=ShapeSpec("hook", TRAIN_SEQ, TRAIN_BATCH, "train"),
                    adapter=AdapterConfig(kind="shira", mask="wm",
                                          packed=False),
                    train=TrainConfig(learning_rate=3e-4,
                                      total_steps=HOOK_STEPS,
                                      warmup_steps=1))
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(run)
    setup_s = time.perf_counter() - t0
    out = tr.fit(HOOK_STEPS, log=None)
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    hist = out["history"]
    step_ms = [h["step_ms"] for h in hist]
    steady = statistics.median(step_ms[1:])
    leaves = len(list(iter_leaves(tr.masks)))
    entries = sum(m.numel() for _, m in iter_leaves(tr.masks))
    print(f"[train] hook-mode Trainer shira-wm ({HOOK_LAYERS} of "
          f"{get_config('starcoder2-7b').num_layers} layers, "
          f"{run.shape.tokens} tokens a step, {leaves} target leaves, "
          f"{entries} target entries, bool masks): wm masks built in "
          f"{tr.mask_seconds:.2f}s (set-up {setup_s:.1f}s), launches "
          f"{counts}, step {steady:.1f} ms (median after the first; all "
          f"{[round(x, 1) for x in step_ms]}), "
          f"{run.shape.tokens / steady * 1e3:.0f} tokens/s, loss "
          f"{hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, peak memory "
          f"{peak:.1f} GB, {time.perf_counter() - t0:.1f}s wall", flush=True)
    if not all(math.isfinite(h["loss"]) for h in hist):
        fail("hook-mode Trainer: a loss is not finite")
    tied, rows, entries_tied = wm_ties(torch, tr)
    print(f"[train] wm ties: {tied} of {rows} matrices have |W| values "
          f"equal to the K-th largest beside it ({entries_tied} entries), "
          f"decided by the lower index as lax.top_k decides them",
          flush=True)
    if leaves != 6 or counts["masked_update"] != leaves * HOOK_STEPS:
        fail(f"hook-mode Trainer: masked_update launched "
             f"{counts['masked_update']} times over {HOOK_STEPS} steps of "
             f"{leaves} target leaves")
    check_run("hook-mode Trainer", counts, ("masked_update",), totals)
    profile_hook_step(torch, tr, out["state"])
    state = {"trainable": out["state"]["trainable"]}
    del out                         # the moments: 8 bytes a target entry
    torch.cuda.empty_cache()
    # published before the round trip, which loads the pack onto tr.base
    publish_check(torch, "hook-mode Trainer",
                  lambda store: [tr.publish(store, state, "hook")],
                  [tr.export_pack(state, "hook")])
    zero_counts()
    t0 = time.perf_counter()
    pack, frac, most, diff, scale = hook_round_trip(torch, tr, state)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"[train] hook export: pack_from_delta {pack.num_params()} values "
          f"({pack.nbytes() / 1e6:.1f} MB), %C {frac:.6f} (<= {most:.6f}, "
          f"1 - sparsity {1 - run.adapter.sparsity:.2f} at the target "
          f"leaves); loaded through SwitchEngine: max |loaded - trained| "
          f"{diff:.3g} (tol {ROUND_TRIP_TOL} of {scale:.3g}), launches "
          f"{ {k: v for k, v in counts.items() if v} }, "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    check_run("hook export", counts, ("scatter_apply",), totals)
    del tr, state, pack
    torch.cuda.empty_cache()
    return totals


def hook_consistency_phase(torch):
    """Hook mode against packed at full width cut to 2 layers, f32: 3
    steps of each on one wm mask give the same losses to HOOK_TOL (the
    reference's claim, with masked_update on one side and scatter_apply +
    sparse_adamw on the other). Then grad (packed) and snip (hook) masks
    from one batch's calibration gradients: one step each, and each
    exported pack, loaded onto a copy of the base through SwitchEngine,
    gives the trained weights."""
    import numpy as np
    from repro_torch.configs import (AdapterConfig, RunConfig, ShapeSpec,
                                     TrainConfig, get_config)
    from repro_torch.core import SwitchEngine
    from repro_torch.core.masks import iter_leaves, map_leaves
    from repro_torch.data import batch_iterator
    from repro_torch.models import layers, lm
    from repro_torch.runtime import Trainer
    from repro_torch.runtime.trainer import dense_grads, device_batch
    cfg = get_config("starcoder2-7b").replace(num_layers=2)
    shape = ShapeSpec("c", 64, 2, "train")
    steps = 3

    def run_of(mask, packed):
        return RunConfig(model=cfg, shape=shape,
                         adapter=AdapterConfig(kind="shira", mask=mask,
                                               packed=packed),
                         train=TrainConfig(learning_rate=1e-2,
                                           total_steps=steps,
                                           warmup_steps=1))
    with layers.compute_precision(torch.float32):
        base = lm.init_params(cfg, seed=0, device="cuda")
        losses = {}
        zero_counts()
        for packed in (False, True):
            t = Trainer(run_of("wm", packed), base_params=base)
            losses[packed] = [h["loss"] for h in
                              t.fit(steps, log=None)["history"]]
            del t
        counts = read_counts()
        d = max(abs(a - b) for a, b in zip(losses[False], losses[True]))
        print(f"[hook-consistency] f32, 2 layers, full width, wm mask, "
              f"{steps} steps: hook losses {losses[False]}, packed "
              f"{losses[True]}, max diff {d:.3g} (tol rtol=atol={HOOK_TOL});"
              f" launches { {k: v for k, v in counts.items() if v} }",
              flush=True)
        if not np.allclose(losses[False], losses[True], rtol=HOOK_TOL,
                           atol=HOOK_TOL):
            fail("hook-consistency: hook and packed losses differ")
        for k in ("masked_update", "scatter_apply", "sparse_adamw_blocks"):
            if counts[k] <= 0:
                fail(f"hook-consistency: kernel {k} was never launched")
        batch = device_batch(next(batch_iterator(cfg, shape, seed=1)),
                             "cuda")
        calib = dense_grads(base, cfg, batch,
                            AdapterConfig().target_modules)[2]
        for mask, packed in (("grad", True), ("snip", False)):
            t = Trainer(run_of(mask, packed), base_params=base,
                        calib_grads=calib)
            state = t.fit(1, log=None)["state"]
            pack = t.export_pack(state, mask)
            trained = (materialize_dense(torch, base, state, t) if packed
                       else dict(iter_leaves(state["trainable"])))
            copy = map_leaves(lambda _, x: x.clone(), base)
            SwitchEngine(copy).switch(pack)
            diff = max(float((w - trained[p]).abs().max())
                       for p, w in iter_leaves(copy) if p in pack.entries)
            scale = max(float(trained[p].abs().max()) for p in pack.entries)
            mode = "packed" if packed else "hook"
            print(f"[hook-consistency] {mask} mask ({mode}, calibration "
                  f"gradients of one {shape.tokens}-token "
                  f"batch, built in {t.mask_seconds:.2f}s): pack of "
                  f"{pack.num_params()} values loads to max diff {diff:.3g} "
                  f"from the trained weights (tol {ROUND_TRIP_TOL} of "
                  f"{scale:.3g})", flush=True)
            if not diff <= ROUND_TRIP_TOL * scale:
                fail(f"hook-consistency: the {mask} pack does not load to "
                     "its trained weights")
            del t, state, pack, trained, copy


def none_depth(torch, cfg):
    """The deepest stack of ``cfg`` that full finetuning fits on the card:
    NONE_BYTES a parameter, NONE_HEADROOM besides. Returns (layers, the
    arithmetic as text)."""
    from repro_torch.core.masks import iter_leaves
    from repro_torch.models import lm
    one = lm.init_params(cfg.replace(num_layers=1), seed=0, device="cuda")
    per_layer = sum(x.numel() for _, x in iter_leaves(one["stages"]))
    rest = sum(x.numel() for _, x in iter_leaves(one)) - per_layer
    del one
    torch.cuda.empty_cache()
    # the card's memory less what earlier phases still hold
    total = torch.cuda.mem_get_info()[1] - torch.cuda.memory_allocated()
    layers = int((total - rest * NONE_BYTES - NONE_HEADROOM)
                 // (per_layer * NONE_BYTES))
    whole = (rest + cfg.num_layers * per_layer) * NONE_BYTES
    text = (f"{NONE_BYTES} B a parameter (f32 base, trainable copy, mu, nu, "
            f"gradient): {cfg.num_layers} layers need {whole / 1e9:.1f} GB; "
            f"({total / 1e9:.1f} GB free - {rest} embedding, unembedding "
            f"and norm parameters x {NONE_BYTES} B = "
            f"{rest * NONE_BYTES / 1e9:.2f} GB - {NONE_HEADROOM / 1e9:.0f} GB"
            f" headroom) / ({per_layer} a layer x {NONE_BYTES} B = "
            f"{per_layer * NONE_BYTES / 1e9:.3f} GB) = {layers} layers")
    return layers, text


def train_kinds_phase(torch, c_shira):
    """The adapter kinds beyond SHiRA through launch.train at full width
    and the train phase's shapes: lora, dora and shira-dora at 32 layers,
    then none (full finetuning) cut to the deepest stack that fits. Per
    kind: step ms, tokens/s, peak memory, first and last loss, launches
    (sparse_adamw_blocks on every kind, scatter_apply on shira-dora), and
    the %C of the effective weights, layer by layer: shira-dora < 0.05,
    lora above 5x the packed SHiRA run's (the reference's
    test_percent_changed_shira_vs_lora, the paper's Tab. 2)."""
    import math
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    totals, cs = {}, {}
    common = ["--arch", "starcoder2-7b", "--seq", str(TRAIN_SEQ), "--batch",
              str(TRAIN_BATCH), "--steps", str(TRAIN_STEPS)]
    layers, arithmetic = none_depth(torch, get_config("starcoder2-7b"))
    print(f"[train-kinds] none (full finetuning): {arithmetic}", flush=True)
    for kind in FACTOR_KINDS + ("none",):
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cut = ["--layers", str(layers)] if kind == "none" else []
        stats = train.main(common + ["--adapter", kind] + cut, keep=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        tr, state = stats.pop("trainer"), stats.pop("state")
        losses = stats["losses"]
        cs[kind] = (percent_changed(torch, tr, state) if kind != "none"
                    else None)
        depth = layers if kind == "none" else tr.cfg.num_layers
        print(f"[train-kinds] {kind} (launch.train, {depth} layers, "
              f"{TRAIN_BATCH}x{TRAIN_SEQ} tokens, {stats['trained_values']}"
              f" trained values, adapter built in "
              f"{stats['mask_seconds']:.2f}s): launches "
              f"{ {k: v for k, v in counts.items() if v} }, step "
              f"{stats['steady_step_ms']:.1f} ms (median after the first; "
              f"all {[round(x, 1) for x in stats['step_ms']]}), "
              f"{stats['tokens_per_s']:.0f} tokens/s, loss {losses[0]:.4f} "
              f"-> {losses[-1]:.4f}, peak memory {peak:.1f} GB"
              + (f", %C {cs[kind]:.6f}" if cs[kind] is not None else "")
              + f", {wall:.1f}s wall", flush=True)
        if not all(math.isfinite(x) for x in losses):
            fail(f"train-kinds {kind}: a loss is not finite")
        check_run(f"train-kinds {kind}", counts, ("sparse_adamw_blocks",)
                  + (("scatter_apply",) if kind == "shira-dora" else ()),
                  totals)
        del stats, tr, state
        torch.cuda.empty_cache()
    print(f"[train-kinds] %C: packed SHiRA {c_shira:.6f}, shira-dora "
          f"{cs['shira-dora']:.6f} (< 0.05), lora {cs['lora']:.6f} (> 5x "
          f"SHiRA's {5 * c_shira:.6f}), dora {cs['dora']:.6f}", flush=True)
    if not cs["shira-dora"] < 0.05:
        fail(f"train-kinds: shira-dora %C {cs['shira-dora']} is not sparse")
    if not cs["lora"] > 5 * c_shira:
        fail(f"train-kinds: lora %C {cs['lora']} not above 5x SHiRA's "
             f"{c_shira}")
    return totals


def switch_lora_phase(torch):
    """The paper's headline contrast (Fig. 5) at full width, 32 layers,
    the six target leaves: LoraEngine.fuse and unfuse at rank
    SWITCH_RANK (factors from seed 0) beside SwitchEngine load and unload
    of a 138.9M-entry rand pack (sparsity 0.98, as the serve phase's), in
    one run: the median of SWITCH_RUNS of each by the CUDA-synchronized
    host clock, the fuse's bound from its bytes (W read and written once,
    A and B read) and f32 FLOPs, W within RESTORE_TOL of the largest base
    weight after every unfuse and unload, and the fuse's peak over what
    was allocated before it, which a stacked delta would raise by
    gigabytes."""
    import math
    import statistics
    from repro_torch import core
    from repro_torch.configs import AdapterConfig, get_config
    from repro_torch.core.masks import is_target, iter_leaves, map_leaves
    from repro_torch.models import lm
    cfg = get_config("starcoder2-7b")
    acfg = AdapterConfig(kind="shira", mask="rand", sparsity=0.98)
    base = lm.init_params(cfg, seed=0, device="cuda")
    targets = {p: w for p, w in iter_leaves(base)
               if is_target(p, w, acfg.target_modules)}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    lora, nbytes, flops = {}, 0, 0
    for p, w in targets.items():
        L, n, m = w.shape
        lora[p] = {
            "A": torch.randn((L, n, SWITCH_RANK), generator=gen,
                             device="cuda") / math.sqrt(n),
            "B": torch.randn((L, SWITCH_RANK, m), generator=gen,
                             device="cuda") * 0.01}
        nbytes += 2 * w.numel() * 4 + sum(t.numel() * 4
                                          for t in lora[p].values())
        flops += 2 * L * n * SWITCH_RANK * m
    _, aux = core.init_adapter(gen, base, acfg)
    pack = core.pack_from_shira("shira", map_leaves(
        lambda _, i: torch.randn(i.shape, generator=gen, device="cuda")
        * 0.01, aux["indices"]), aux)
    del aux
    keep = {p: w.clone() for p, w in targets.items()}
    top = max(float(w.abs().max()) for w in keep.values())
    scale = AdapterConfig().lora_alpha / SWITCH_RANK
    lo, sw = core.LoraEngine(base), core.SwitchEngine(base)
    ms = {k: [] for k in ("fuse", "unfuse", "load", "unload")}
    diffs, extra = [], 0
    layer_delta = max(w[0].numel() * 4 for w in targets.values())
    totals = {}
    zero_counts()
    for _ in range(SWITCH_RUNS):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms["fuse"].append(lo.fuse(lora, scale) * 1e3)
        extra = max(extra, torch.cuda.max_memory_allocated() - before)
        ms["unfuse"].append(lo.unfuse() * 1e3)
        diffs.append(max(float((w - keep[p]).abs().max())
                         for p, w in targets.items()))
        ms["load"].append(sw.load(pack).seconds * 1e3)
        ms["unload"].append(sw.unload().seconds * 1e3)
        diffs.append(max(float((w - keep[p]).abs().max())
                         for p, w in targets.items()))
    counts = read_counts()
    med = {k: statistics.median(v) for k, v in ms.items()}
    b = bound(nbytes, flops)
    print(f"[switch] LoRA rank {SWITCH_RANK} fuse over {len(targets)} leaves"
          f" x {cfg.num_layers} layers ({sum(w.numel() for w in keep.values())}"
          f" weights) beside the SHiRA switch ({pack.num_params()} entries),"
          f" median of {SWITCH_RUNS} (CUDA-synchronized host clock): fuse "
          f"{med['fuse']:.3f} ms, unfuse {med['unfuse']:.3f} ms; SHiRA load "
          f"{med['load']:.3f} ms, unload {med['unload']:.3f} ms; all "
          f"{ {k: [round(x, 3) for x in v] for k, v in ms.items()} }",
          flush=True)
    print(f"[switch] the fuse's bound: {nbytes / 1e9:.2f} GB and "
          f"{flops / 1e9:.1f} GFLOP f32 -> {b['bound_ms']:.3f} ms "
          f"({b['bound_by']}; bytes {nbytes / card_hw().hbm_bw * 1e3:.3f} "
          f"ms, f32 {flops / card_hw().f32_flops * 1e3:.3f} ms), fuse at "
          f"{b['bound_ms'] / med['fuse']:.1%} of it; fuse / SHiRA load "
          f"{med['fuse'] / med['load']:.2f}x; the fuse's peak over what was "
          f"allocated before it {extra / 1e6:.1f} MB (one layer's f32 delta "
          f"would be {layer_delta / 1e6:.1f} MB, a stacked one "
          f"{max(w.numel() * 4 for w in keep.values()) / 1e9:.2f} GB); W "
          f"after each unfuse and unload within {max(diffs):.3g} of the base"
          f" (tol {RESTORE_TOL} of {top:.3g}); launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    if not max(diffs) <= RESTORE_TOL * top:
        fail("switch: unfuse or unload does not restore the base")
    if extra >= layer_delta:
        fail(f"switch: the LoRA fuse allocated {extra} bytes")
    check_run("switch", counts, ("scatter_apply",), totals)
    return totals


def checkpoint_phase(torch):
    """Checkpoints and preemption recovery at full width: packed shira-wm
    (sparsity 0.98) through Trainer with ckpt_every 2, keep 2, in a temp
    directory. A clean CKPT_STEPS-step fit; a fit whose injector raises
    SimulatedPreemption once at step CKPT_PREEMPT, which must restore once,
    from step 2, end within RESUME_TOL of the clean run's last loss and
    leave steps [4, 6] committed; a fresh Trainer on the same directory
    (its own wm mask, which must equal the first's) resumes at 6 and takes
    2 steps to 8. Then the state's device-to-host copy, save and restore
    (seconds, bytes; restored bit for bit), Trainer.publish's snapshot into
    the step read back equal, and MultiAdapterTrainer.publish(ckpt=) at 2
    layers. The Trainer runs at CKPT_LAYERS of starcoder2-7b's 32."""
    import os
    import tempfile
    from repro_torch.checkpoint import CheckpointManager, flatten
    from repro_torch.configs import (AdapterConfig, RunConfig, ShapeSpec,
                                     TrainConfig, get_config)
    from repro_torch.core.masks import iter_leaves
    from repro_torch.hub import AdapterStore
    from repro_torch.models import lm
    from repro_torch.runtime import SimulatedPreemption, Trainer, TrainerConfig
    from repro_torch.training import MultiAdapterTrainer
    cfg = get_config("starcoder2-7b").replace(num_layers=CKPT_LAYERS)
    run = RunConfig(model=cfg, shape=ShapeSpec("ck", TRAIN_SEQ, TRAIN_BATCH,
                                               "train"),
                    adapter=AdapterConfig(kind="shira", mask="wm",
                                          sparsity=0.98),
                    train=TrainConfig(learning_rate=3e-4, total_steps=8,
                                      warmup_steps=1))
    base = lm.init_params(cfg, seed=0, device="cuda")
    totals = {}
    zero_counts()
    with tempfile.TemporaryDirectory(prefix="ckpt-") as root:
        tcfg = lambda sub: TrainerConfig(ckpt_dir=os.path.join(root, sub),
                                         ckpt_every=2, keep=2,
                                         log_every=1000)
        first = Trainer(run, tcfg("clean"), base_params=base)
        clean = first.fit(CKPT_STEPS, log=None)["history"]
        hits, logs = [], []

        def injector(s):
            if s == CKPT_PREEMPT and not hits:
                hits.append(s)
                raise SimulatedPreemption()
        tr = Trainer(run, tcfg("run"), base_params=base, aux=first.aux)
        resumed = tr.fit(CKPT_STEPS, fault_injector=injector,
                         log=logs.append)["history"]
        restores = [m for m in logs if "preempted" in m]
        d = abs(clean[-1]["loss"] - resumed[-1]["loss"])
        print(f"[checkpoint] full width, {CKPT_LAYERS} of 32 layers "
              f"(CKPT_LAYERS: cut for the script's time limit, 16 before the "
              f"last five families' TP forward), packed shira-wm, "
              f"{TRAIN_BATCH}x{TRAIN_SEQ} tokens: clean losses "
              f"{[h['loss'] for h in clean]}; preempted at step "
              f"{CKPT_PREEMPT}: {restores}, losses "
              f"{[h['loss'] for h in resumed]}; last loss diff {d:.3g} "
              f"(tol {RESUME_TOL}; bit-equal: {d == 0}); committed "
              f"{tr.ckpt.steps()}", flush=True)
        if restores != ["[trainer] preempted: restored step 2"]:
            fail(f"checkpoint: expected one restore from step 2, {restores}")
        if not d <= RESUME_TOL:
            fail("checkpoint: the resumed run departs from the clean run")
        if tr.ckpt.steps() != [4, 6]:
            fail(f"checkpoint: committed steps {tr.ckpt.steps()}")
        del first, clean
        logs = []
        again = Trainer(run, tcfg("run"), base_params=base)
        same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            iter_leaves(again.aux), iter_leaves(tr.aux)))
        out = again.fit(8, log=logs.append)
        print(f"[checkpoint] a fresh Trainer on the same directory: wm mask "
              f"rebuilt in {again.mask_seconds:.2f}s, equal to the first's: "
              f"{same}; {logs[:1]}, {len(out['history'])} steps to step "
              f"{out['state']['step']}, straggler monitor EWMA "
              f"{again.monitor.ewma[0] * 1e3:.1f} ms", flush=True)
        if (not same or logs[:1] != ["[trainer] resumed from step 6"]
                or len(out["history"]) != 2):
            fail("checkpoint: the fresh Trainer did not resume at step 6")
        state = out["state"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = flatten({"state": state})
        d2h = time.perf_counter() - t0
        nbytes = sum(a.nbytes for a in host.values())
        del host
        mgr = CheckpointManager(os.path.join(root, "timed"), keep=1)
        t0 = time.perf_counter()
        mgr.save(8, {"state": state}, meta={"arch": cfg.name})
        save_s = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(mgr._step_dir(8), "state.npz"))
        t0 = time.perf_counter()
        back = mgr.restore({"state": state})["state"]
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        equal = back["step"] == state["step"] and all(
            torch.equal(a, b) for (_, a), (_, b) in zip(
                iter_leaves(back), iter_leaves(state))
            if isinstance(a, torch.Tensor))
        print(f"[checkpoint] the state (trainable, mu, nu: {nbytes} bytes): "
              f"device to host {d2h:.2f}s, save (copy, .npz write, commit) "
              f"{save_s:.2f}s, {size} bytes on disk; restore to the card "
              f"{restore_s:.2f}s, bit-equal: {equal}", flush=True)
        if not equal:
            fail("checkpoint: the restored state differs")
        del back
        store = AdapterStore(os.path.join(root, "store"))
        vid = again.publish(store, state, "ckpt")
        snap = again.ckpt.restore_adapter(vid, step=state["step"])
        want = again.export_pack(state, "ckpt")
        ok = again.ckpt.adapters(state["step"]) == [vid] and all(
            torch.equal(snap.entries[p][0], i.cpu())
            and torch.equal(snap.entries[p][1], v.cpu())
            for p, (i, v) in want.entries.items())
        print(f"[checkpoint] Trainer.publish: {vid} snapshotted into step "
              f"{state['step']}, read back equal: {ok}", flush=True)
        if not ok:
            fail("checkpoint: Trainer.publish's snapshot differs")
        check_run("checkpoint", read_counts(),
                  ("scatter_apply", "sparse_adamw_blocks"), totals)
        del again, tr, out, state, want, snap, base
        torch.cuda.empty_cache()
        mrun = RunConfig(model=cfg.replace(num_layers=2), shape=ShapeSpec(
            "mt", 64, 2, "train"), adapter=AdapterConfig(
                kind="shira", mask="rand", sparsity=0.98),
            train=TrainConfig(total_steps=2, warmup_steps=1))
        mt = MultiAdapterTrainer(mrun, ["m0", "m1"])
        mstate = mt.fit(1, log=None)["state"]
        mgr = CheckpointManager(os.path.join(root, "multi"))
        vids = mt.publish(AdapterStore(os.path.join(root, "mstore")),
                          mstate, ckpt=mgr)
        ok = mgr.adapters(1) == vids and all(
            torch.equal(mgr.restore_adapter(vid, step=1).entries[p][1],
                        v.cpu())
            for vid, pack in zip(vids, mt.export_packs(mstate))
            for p, (_, v) in pack.entries.items())
        print(f"[checkpoint] MultiAdapterTrainer.publish(ckpt=), 2 layers: "
              f"{vids} snapshotted into step 1, read back equal: {ok}",
              flush=True)
        if not ok:
            fail("checkpoint: MultiAdapterTrainer.publish's snapshot differs")
    return totals


def kinds_consistency_phase(torch):
    """The kinds with the kernels in the loop against the same Trainer on the
    CPU, where the wrappers compute their plain versions: full width,
    KINDS_LAYERS layer(s), f32, one 16-token sequence a step (the CPU
    side's size: a few seconds a step). The kinds of KINDS_CPU (shira-dora;
    lora, dora and shira-dora before the last five families' TP forward):
    CPU_STEPS of losses to TRAIN_TOL, on the card's factors and mask. Hook
    mode (shira-wm) with weight_decay 0.01, 2 steps: the weights that only
    decay
    (every leaf off the mask) within WD_TOL of the largest weight of the
    CPU run's; the masked weights, which also move by -lr * U, as train-
    consistency holds trained values: to rtol = atol = TRAIN_TOL where the
    first step's gradient is not within GRAD_TOL of zero on the CPU, and,
    where it is (the two summation orders may disagree on its sign, and
    Adam's normalised step turns either into a full lr move), counted and
    held to the largest move that can make, 2 * lr * steps."""
    from repro_torch.configs import (AdapterConfig, RunConfig, ShapeSpec,
                                     TrainConfig, get_config)
    from repro_torch.core.masks import iter_leaves, map_leaves
    from repro_torch.data import batch_iterator
    from repro_torch.models import layers, lm
    from repro_torch.runtime import Trainer
    from repro_torch.runtime.trainer import dense_grads, device_batch
    cfg = get_config("starcoder2-7b").replace(num_layers=KINDS_LAYERS)
    shape = ShapeSpec("c", 16, 1, "train")
    cpu = lambda t: map_leaves(lambda _, x: x.cpu(), t)
    with layers.compute_precision(torch.float32):
        base = lm.init_params(cfg, seed=0, device="cuda")
        base_cpu = cpu(base)
        print(f"[kinds-consistency] the factor kinds held against the CPU: "
              f"{KINDS_CPU} (KINDS_CPU, of {FACTOR_KINDS}: cut for the "
              f"script's time limit)", flush=True)
        for kind in KINDS_CPU:
            run = RunConfig(model=cfg, shape=shape, adapter=AdapterConfig(
                kind=kind, mask="wm", sparsity=0.98, rank=16),
                train=TrainConfig(learning_rate=1e-3, total_steps=CPU_STEPS,
                                  warmup_steps=1))
            zero_counts()
            tg = Trainer(run, base_params=base)
            tc = Trainer(run, base_params=base_cpu, device="cpu",
                         trainable0=cpu(tg.trainable0),
                         aux=None if tg.aux is None else cpu(tg.aux))
            t0 = time.perf_counter()
            lg = [h["loss"] for h in tg.fit(CPU_STEPS, log=None)["history"]]
            t1 = time.perf_counter()
            lc = [h["loss"] for h in tc.fit(CPU_STEPS, log=None)["history"]]
            t2 = time.perf_counter()
            counts = read_counts()
            d = max(abs(a - b) for a, b in zip(lg, lc))
            print(f"[kinds-consistency] {kind}, f32, {KINDS_LAYERS} layer(s), "
                  f"full width, {CPU_STEPS} steps (CPU_STEPS): "
                  f"card losses {lg}, CPU {lc}, max diff {d:.3g} (tol "
                  f"rtol=atol={TRAIN_TOL}); card {t1 - t0:.1f}s, CPU "
                  f"{t2 - t1:.1f}s; launches "
                  f"{ {k: v for k, v in counts.items() if v} }", flush=True)
            if not d <= TRAIN_TOL * (1 + abs(lc[0])):
                fail(f"kinds-consistency: {kind} departs from the CPU run")
            if counts["sparse_adamw_blocks"] <= 0 or (
                    kind == "shira-dora" and counts["scatter_apply"] <= 0):
                fail(f"kinds-consistency: {kind} launched no kernel")
            del tg, tc
        lr, steps = 1e-2, 2
        run = RunConfig(model=cfg, shape=shape, adapter=AdapterConfig(
            kind="shira", mask="wm", sparsity=0.98, packed=False),
            train=TrainConfig(learning_rate=lr, weight_decay=0.01,
                              total_steps=steps, warmup_steps=1))
        zero_counts()
        tg = Trainer(run, base_params=base)
        tc = Trainer(run, base_params=base_cpu, device="cpu")
        g1 = dense_grads(base_cpu, cfg, device_batch(next(batch_iterator(
            cfg, shape, seed=0)), "cpu"), run.adapter.target_modules)[2]
        t0 = time.perf_counter()
        wg = dict(iter_leaves(tg.fit(steps, log=None)["state"]["trainable"]))
        t1 = time.perf_counter()
        wc = dict(iter_leaves(tc.fit(steps, log=None)["state"]["trainable"]))
        t2 = time.perf_counter()
        counts = read_counts()
        top = max(float(x.abs().max()) for x in wc.values())
        masks, b0 = dict(iter_leaves(tc.masks)), dict(iter_leaves(base_cpu))
        decay_d, held_d, free_d, free_n, ok = 0.0, 0.0, 0.0, 0, True
        for p, x in wc.items():
            dd = (wg[p].cpu() - x).abs()
            on = masks.get(p, torch.zeros(x.shape, dtype=torch.bool))
            decay_d = max(decay_d, float(dd[~on].max()) if (~on).any()
                          else 0.0)
            moved = (x != b0[p]) | (x == 0)     # zero biases stay zero
            ok &= bool(moved.float().mean() > 0.9)
            if not on.any():
                continue
            g = (g1[p] * on).abs()
            free = on & (g <= GRAD_TOL * float(g.max()))
            held = on & ~free
            held_d = max(held_d, float(dd[held].max()))
            ok &= bool((dd[held] <= TRAIN_TOL * (1 + x[held].abs())).all())
            if free.any():
                free_d = max(free_d, float(dd[free].max()))
                free_n += int(free.sum())
        print(f"[kinds-consistency] hook mode (shira-wm) with weight decay "
              f"0.01, lr {lr}, {steps} steps, f32, {KINDS_LAYERS} layer(s): "
              f"weights off "
              f"the mask (decay only) max diff {decay_d:.3g} (tol {WD_TOL} "
              f"of {top:.3g}); masked weights max diff {held_d:.3g} (tol "
              f"rtol=atol={TRAIN_TOL}), {free_n} of them with |g| <= "
              f"{GRAD_TOL} of the largest, max diff {free_d:.3g} (tol "
              f"{2 * lr * steps}); every leaf decayed: {ok}; card "
              f"{t1 - t0:.1f}s, CPU {t2 - t1:.1f}s; launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
        if not (decay_d <= WD_TOL * top and free_d <= 2 * lr * steps
                and ok and counts["masked_update"] > 0):
            fail("kinds-consistency: hook mode with weight decay departs "
                 "from the CPU run")


def train_cpu_consistency(torch, arch, tag):
    """Trainer (packed shira-rand) and MultiAdapterTrainer (3 adapters)
    with the kernels in the loop against the same trainers on the CPU,
    where the wrappers compute their plain versions: full width, 2 layers,
    f32, one 16-token sequence a step (an adapter; a vision model's after
    its patch prefix), the card's indices, CPU_STEPS steps of losses to
    TRAIN_TOL. A vision or audio model has the Trainer alone (the
    multi-adapter trainer refuses it: ``multi_refused``)."""
    from repro_torch.configs import (AdapterConfig, RunConfig, ShapeSpec,
                                     TrainConfig, get_config)
    from repro_torch.core.masks import map_leaves
    from repro_torch.models import layers, lm
    from repro_torch.runtime import Trainer
    from repro_torch.training import MultiAdapterTrainer
    cfg = two_layers(get_config(arch))
    run = RunConfig(model=cfg, shape=ShapeSpec("c", 16 + cfg.prefix_rows,
                                               1, "train"),
                    adapter=AdapterConfig(kind="shira", mask="rand",
                                          sparsity=0.98),
                    train=TrainConfig(learning_rate=1e-2,
                                      total_steps=CPU_STEPS, warmup_steps=1))
    cpu = lambda t: map_leaves(lambda _, x: x.cpu(), t)
    names = ["a0", "a1", "a2"]
    with layers.compute_precision(torch.float32):
        base = lm.init_params(cfg, seed=0, device="cuda")
        base_cpu = cpu(base)
        for label, make in (
                ("Trainer", lambda: Trainer(run, base_params=base)),
                ("MultiAdapterTrainer", lambda: MultiAdapterTrainer(
                    run, names, base_params=base)))[
                        :1 if cfg.modality != "text" else 2]:
            zero_counts()
            tg = make()
            if label == "Trainer":
                tc = Trainer(run, base_params=base_cpu, device="cpu",
                             aux=cpu(tg.aux))
                keys = ["loss"]
            else:
                tc = MultiAdapterTrainer(run, names, base_params=base_cpu,
                                         auxes=[cpu(a) for a in tg.auxes],
                                         device="cpu")
                keys = [f"loss:{n}" for n in names]
            t0 = time.perf_counter()
            hg = tg.fit(CPU_STEPS, log=None)["history"]
            t1 = time.perf_counter()
            hc = tc.fit(CPU_STEPS, log=None)["history"]
            t2 = time.perf_counter()
            counts = {k: v for k, v in read_counts().items() if v}
            d = max(abs(a[k] - b[k]) for a, b in zip(hg, hc) for k in keys)
            top = max(abs(b[k]) for b in hc for k in keys)
            print(f"[{tag}] {arch} {label}, f32, {cfg.num_layers} layers, "
                  f"full width, {CPU_STEPS} steps (CPU_STEPS): card losses {[[h[k] for k in keys] for h in hg]}"
                  f", CPU {[[h[k] for k in keys] for h in hc]}, aux card "
                  f"{[round(h['aux'], 5) for h in hg]}, max diff {d:.3g} "
                  f"(tol rtol=atol={TRAIN_TOL}); card {t1 - t0:.1f}s, CPU "
                  f"{t2 - t1:.1f}s; launches {counts}", flush=True)
            if not d <= TRAIN_TOL * (1 + top):
                fail(f"{tag}: {label} departs from the CPU run")
            if not counts:
                fail(f"{tag}: {label} launched no kernel")
            del tg, tc


def slice_phases(torch, arch, tag, serve_layers=0, train_layers=0,
                 quant=False):
    """One slice's arch at full width through the earlier phases' code:
    serve (4 modes), profile (decode steps and a 1024-token prefill, with
    the model's ranges), continuous (both engines, bf16 and int8 pages;
    for a family with no pages the lanes alone, the paged engine
    refusing), train
    (both trainers), each at its depth (0: all layers), then
    ``tag``-consistency at 2 layers in f32 (multi-tenant against
    switch-per-request, the engines against the fixed batch, with
    ``quant`` int8 pages too, both trainers against the CPU). Returns the
    launches."""
    totals = {}
    for label, phase, args in (
            ("serve", serve_phase, dict(layers=serve_layers,
                                        tag=f"{tag}-serve")),
            ("profile", profile_phase, dict(layers=serve_layers,
                                            tag=f"{tag}-profile")),
            ("continuous", continuous_phase,
             dict(layers=serve_layers, tag=f"{tag}-continuous")),
            ("train", train_phase, dict(layers=train_layers,
                                        tag=f"{tag}-train"))):
        out = timed(f"{tag} {label}", lambda: phase(torch, arch, **args))
        if isinstance(out, tuple):          # train_phase: (totals, %C)
            out = out[0]
        for k, v in (out or {}).items():
            totals[k] = totals.get(k, 0) + v
        torch.cuda.empty_cache()

    def consistency():
        consistency_phase(torch, arch, tag=f"{tag}-consistency")
        continuous_consistency_phase(torch, arch, long=MOE_LONG,
                                     tag=f"{tag}-consistency", quant=quant)
        train_cpu_consistency(torch, arch, f"{tag}-consistency")
    timed(f"{tag}-consistency", consistency)
    torch.cuda.empty_cache()
    return totals


def moe_phases(torch):
    """The MoE slice (MOE_ARCH) at full width, cut to MOE_LAYERS of its 24
    layers for the script's time limit (printed)."""
    print(f"[moe] {MOE_ARCH}: serve, profile, continuous and train at "
          f"{MOE_LAYERS} of 24 layers (cut for the script's time limit: 12 "
          f"since the hybrid slice, 8 since the analysis slice, "
          f"{MOE_LAYERS} since the sequence-sharded slice; all 24 before)",
          flush=True)
    return slice_phases(torch, MOE_ARCH, "moe", MOE_LAYERS, MOE_LAYERS)


def mla_depth(torch, cfg):
    """The deepest stacks of ``cfg`` (an MLA model with a first dense
    layer) that fit MLA_BUDGET, at least the first dense layers and one
    MoE layer, at most the config's: for serving, the f32 parameters, the
    three adapters' packs and tables at 2% of each target leaf
    (ADAPTER_BYTES), the lanes' latent KV (B x CACHE rows of rank + rope
    bf16 values a layer) and one MoE call's expert-weight transient (all
    E experts' three casts to bf16 and the up/gate products' f32 copies);
    for training, the f32 parameters, three adapters' trainer state
    (MT_ENTRY_BYTES a 2% entry), the logits of the Trainer's step with
    their softmax and gradient (3 x 4 B a token and vocab entry) and two
    expert-weight transients (forward recompute and backward). Returns
    (serve layers, train layers, the arithmetic as text)."""
    stages, rest = stage_leaves(torch, cfg)
    (fd, _, first), (_, _, moe) = stages
    tgt = [sum(n * m for n, m in default_targets(mats))
           for _, mats, _ in stages]
    m, e = cfg.mla, cfg.moe
    kv = B * CACHE * (m.kv_lora_rank + m.qk_rope_head_dim) * 2
    cast = e.num_experts * cfg.d_model * e.d_ff * (3 * 2 + 2 * 4)
    logits = TRAIN_BATCH * TRAIN_SEQ * cfg.padded_vocab * 4 * 3
    serve_layer = [p * 4 + 0.02 * t * ADAPTER_BYTES + kv
                   for p, t in zip((first, moe), tgt)]
    train_layer = [p * 4 + 0.02 * t * 3 * MT_ENTRY_BYTES
                   for p, t in zip((first, moe), tgt)]
    depth = lambda per, fixed: min(cfg.num_layers, fd + max(1, int(
        (MLA_BUDGET - fixed - fd * per[0]) // per[1])))
    total = lambda per, fixed, n: fixed + fd * per[0] + (n - fd) * per[1]
    s_fixed, t_fixed = rest * 4 + cast, rest * 4 + logits + 2 * cast
    serve_l, train_l = depth(serve_layer, s_fixed), depth(train_layer,
                                                          t_fixed)
    gb = lambda x: f"{x / 1e9:.3f} GB"
    text = (f"{cfg.num_layers} layers at full width ({fd} dense first, "
            f"{first} and {moe} parameters a dense / MoE layer, "
            f"{tgt[0]} / {tgt[1]} default-target entries, {rest} outside "
            f"the layers); serve: {rest} x 4 B + the expert-cast transient "
            f"{gb(cast)} + a dense layer {gb(serve_layer[0])} and a MoE "
            f"layer {gb(serve_layer[1])} (f32 parameters, 2% x "
            f"{ADAPTER_BYTES} B, latent KV {gb(kv)}) against "
            f"{MLA_BUDGET / 1e9:.0f} GB -> {serve_l} layers, "
            f"{gb(total(serve_layer, s_fixed, serve_l))}; "
            f"train: {rest} x 4 B + logits {gb(logits)} + two transients "
            f"+ a dense layer {gb(train_layer[0])} and a MoE layer "
            f"{gb(train_layer[1])} (f32 parameters, 3 x 2% x "
            f"{MT_ENTRY_BYTES} B) -> {train_l} layers, "
            f"{gb(total(train_layer, t_fixed, train_l))}")
    return serve_l, train_l, text


def mla_phases(torch):
    """The MLA slice (MLA_ARCH) at full width, at mla_depth's depths,
    through slice_phases, with int8 latent pages in mla-consistency."""
    from repro_torch.configs import get_config
    cfg = get_config(MLA_ARCH)
    serve_l, train_l, text = mla_depth(torch, cfg)
    print(f"[mla] {MLA_ARCH} (d_model {cfg.d_model}, {cfg.num_heads} heads, "
          f"kv_lora_rank {cfg.mla.kv_lora_rank}, {cfg.moe.num_experts} "
          f"experts top-{cfg.moe.top_k}, vocab {cfg.vocab_size}): {text}; "
          f"cut to at most {MLA_LAYERS} layers for the script's time limit "
          f"(14 since the hybrid slice, 8 since the vision and audio "
          f"slice, 6 since the distributed slice, {MLA_LAYERS} since the "
          f"sequence-sharded slice): serve "
          f"{min(serve_l, MLA_LAYERS)}, train "
          f"{min(train_l, MLA_LAYERS)}", flush=True)
    serve_l, train_l = min(serve_l, MLA_LAYERS), min(train_l, MLA_LAYERS)
    return slice_phases(torch, MLA_ARCH, "mla", serve_l, train_l,
                        quant=True)


def mamba_phases(torch):
    """The SSM slice (MAMBA_ARCH) at full width and all 48 layers through
    slice_phases, the lanes alone (the paged engine refuses the family);
    prints the arithmetic first: parameters, three adapters at 2% of
    out_proj, the lanes' state."""
    from repro_torch.configs import get_config
    from repro_torch.core.masks import budget
    cfg = get_config(MAMBA_ARCH)
    ((L, mats, per_layer),), rest = stage_leaves(torch, cfg)
    (n, m), = default_targets(mats)
    params = L * per_layer + rest
    entries = L * budget(n, m, 0.98)
    per = state_bytes(cfg) * L
    s = cfg.ssm
    print(f"[mamba] {MAMBA_ARCH} (d_model {cfg.d_model}, d_inner "
          f"{s.expand * cfg.d_model}, {cfg.num_heads} heads of {s.head_dim},"
          f" d_state {s.d_state}, chunk {s.chunk}, vocab {cfg.vocab_size}, "
          f"tied embeddings): {L} layers of {per_layer} parameters and "
          f"{rest} outside them = {params} parameters, {params * 4 / 1e9:.3f}"
          f" GB in f32; the one default target out_proj ({n}, {m}) a layer:"
          f" three adapters at 2% = 3 x {entries} entries = "
          f"{3 * entries * 8 / 1e6:.1f} MB of packs (int32 index, f32 "
          f"value); a lane's state {per} bytes over {L} layers ("
          f"{state_bytes(cfg)} a layer: f32 state {cfg.num_heads} x "
          f"{s.head_dim} x {s.d_state}, bf16 windows), {B} lanes "
          f"{B * per / 1e9:.3f} GB, {1e9 / per:.2f} requests per GB "
          f"whatever the length", flush=True)
    print(f"[mamba] serve, profile, continuous and train at "
          f"{MAMBA_LAYERS} of {L} layers (cut for the script's time limit: "
          f"24 since the vision and audio slice, {MAMBA_LAYERS} since the "
          f"sequence-sharded slice; all {L} before): the "
          f"arithmetic above counts the whole model, the engines' resident "
          f"requests per GB {MAMBA_LAYERS} layers", flush=True)
    return slice_phases(torch, MAMBA_ARCH, "mamba", MAMBA_LAYERS,
                        MAMBA_LAYERS)


def zamba_phases(torch):
    """The hybrid slice (ZAMBA_ARCH) at full width and all 54 layers
    through slice_phases, the lanes alone (the paged engine refuses the
    family); prints the arithmetic first: parameters, three adapters at 2%
    of out_proj and of the shared block's seven target leaves, a lane's
    state and KV."""
    from repro_torch.configs import get_config
    from repro_torch.core.masks import budget
    cfg = get_config(ZAMBA_ARCH)
    ((L, mats, per_layer),), rest = stage_leaves(torch, cfg)
    (n, m), = default_targets(mats)
    shared = shared_targets(cfg)
    g, k = L // cfg.hybrid_attn_every, cfg.hybrid_attn_every
    params = L * per_layer + rest
    e_out = L * budget(n, m, 0.98)
    e_shared = sum(budget(a, b, 0.98) for _, (a, b) in shared)
    block = sum(a * b for _, (a, b) in shared)
    st, kvt = state_bytes(cfg) * L, kv_row_bytes(cfg, False) * g
    lane = st + CACHE * kvt
    s = cfg.ssm
    print(f"[zamba] {ZAMBA_ARCH} (d_model {cfg.d_model}, d_inner "
          f"{s.expand * cfg.d_model}, {cfg.d_model * s.expand // s.head_dim}"
          f" SSM heads of {s.head_dim}, d_state {s.d_state}, chunk "
          f"{s.chunk}; the shared block: {cfg.num_heads} heads of "
          f"{cfg.resolved_head_dim}, KV {cfg.num_kv_heads}, d_ff {cfg.d_ff},"
          f" after each group of {k}; vocab {cfg.vocab_size}): {L} mamba "
          f"layers of {per_layer} parameters and {rest} outside them (the "
          f"shared block's {block} target-leaf entries and w_fuse "
          f"{2 * cfg.d_model * cfg.d_model} among them) = {params} "
          f"parameters, {params * 4 / 1e9:.3f} GB in f32; targets out_proj "
          f"({g}, {k}, {n}, {m}) and the shared block's seven: three "
          f"adapters at 2% = 3 x ({e_out} + {e_shared}) entries = "
          f"{3 * (e_out + e_shared) * 8 / 1e6:.1f} MB of packs (int32 "
          f"index, f32 value); a lane's state {st} bytes over {L} layers "
          f"({state_bytes(cfg)} a layer) and KV {kvt} bytes a token over "
          f"{g} sites, {lane} bytes a {CACHE}-row lane, {B} lanes "
          f"{B * lane / 1e9:.3f} GB", flush=True)
    print(f"[zamba] serve, profile, continuous and train at "
          f"{ZAMBA_LAYERS} of {L} layers ({ZAMBA_LAYERS // k} of {g} groups:"
          f" cut for the script's time limit: 30 since the vision and "
          f"audio slice, 24 since the distributed slice, {ZAMBA_LAYERS} "
          f"since the sequence-sharded slice; all "
          f"{L} before): the arithmetic above and in the "
          f"residency line counts the whole model, the engines' resident "
          f"requests per GB {ZAMBA_LAYERS} layers", flush=True)
    return slice_phases(torch, ZAMBA_ARCH, "zamba", ZAMBA_LAYERS,
                        ZAMBA_LAYERS)


def vlm_phases(torch):
    """The vision slice (VLM_ARCH) at full width and all 18 layers through
    slice_phases, the lanes alone (the paged engine refuses the family);
    prints the arithmetic first: parameters, three adapters at 2% of the
    default targets, a lane's KV rows with the patch prefix."""
    from repro_torch.configs import get_config
    from repro_torch.core.masks import budget
    cfg = get_config(VLM_ARCH)
    ((L, mats, per_layer),), rest = stage_leaves(torch, cfg)
    targets = default_targets(mats)
    params = L * per_layer + rest
    entries = L * sum(budget(n, m, 0.98) for n, m in targets)
    P = cfg.prefix_rows
    rows, kvt = CACHE + P, kv_row_bytes(cfg, False) * L
    hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads
    print(f"[vlm] {VLM_ARCH} (d_model {cfg.d_model}, {cfg.num_heads} heads "
          f"of {hd} over {kv} KV head (G = {cfg.num_heads // kv}), d_ff "
          f"{cfg.d_ff}, gelu, vocab {cfg.vocab_size}, the tied embedding "
          f"({cfg.padded_vocab}, {cfg.d_model}); {P} patch "
          f"embeddings a request): {L} layers of {per_layer} parameters and "
          f"{rest} outside them = {params} parameters, "
          f"{params * 4 / 1e9:.3f} GB in f32; targets {targets} a layer: "
          f"three adapters at 2% = 3 x {entries} entries = "
          f"{3 * entries * 8 / 1e6:.1f} MB of packs (int32 index, f32 "
          f"value); a lane's KV {rows} rows ({CACHE} + the {P}-row "
          f"prefix) x {kvt} bytes a token over {L} layers = "
          f"{rows * kvt / 1e6:.1f} MB, {B} lanes {B * rows * kvt / 1e9:.3f} "
          f"GB", flush=True)
    totals = slice_phases(torch, VLM_ARCH, "vlm")
    check_run("vlm phases", totals, ("sidedelta", "scatter_apply",
                                     "sparse_adamw_blocks", "flash_decode"),
              {}, ("flash_decode_paged", "flash_prefill"))
    return totals


def encoder_refused(torch, cfg, params, tag):
    """Fail unless the serve CLI exits for ``cfg`` (encoder only) with the
    reference's message before it builds anything, and both engines
    refuse it with the reference's ValueError."""
    from repro_torch.hub import PagedServingEngine, ServingEngine
    from repro_torch.launch import serve
    msg = "encoder-only archs have no decode serving path"
    try:
        serve.main(["--arch", cfg.name])
    except SystemExit as e:
        if str(e) != msg:
            fail(f"{tag}: launch.serve exited for {cfg.name} with another "
                 f"message: {e}")
        print(f"[{tag}] launch.serve --arch {cfg.name} exits, as the "
              f"reference's: SystemExit({str(e)!r})", flush=True)
    else:
        fail(f"{tag}: launch.serve served {cfg.name}")
    for name, make in (
            ("ServingEngine", lambda: ServingEngine(
                cfg, params, slots=B, cache_size=CACHE)),
            ("PagedServingEngine", lambda: PagedServingEngine(
                cfg, params, slots=B, num_pages=321, page_size=16,
                chunk_size=CHUNK))):
        try:
            make()
        except ValueError as e:
            if str(e) != msg:
                fail(f"{tag}: {name} refused {cfg.name} with another "
                     f"message: {e}")
            print(f"[{tag}] {cfg.name} {name} refused, as the reference's:"
                  f" ValueError({str(e)!r})", flush=True)
        else:
            fail(f"{tag}: {name} accepted {cfg.name}")


def audio_encode_phase(torch, cfg, tag="audio"):
    """hubert-xlarge at full width: lm.encode of B x ENCODE_FRAMES frames
    for the base, after SwitchEngine switches to each of three adapters
    (the switch's ms beside its bound), after fusing all three, and after
    unloading them (the target leaves restored within RESTORE_TOL); one
    base encode under torch.profiler, flash_prefill's share; flash_prefill
    launched once a layer an encode, non-causal; the serve CLI's exit and
    the engines' refusals. Returns the launches."""
    import statistics
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import AdapterConfig, ShapeSpec
    from repro_torch.core import SwitchEngine
    from repro_torch.core.masks import iter_leaves, leaf_name
    from repro_torch.data import make_batch
    from repro_torch.launch import serve
    from repro_torch.models import lm
    totals = {}
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, seed=0, device="cuda")
    frames = torch.from_numpy(make_batch(cfg, ShapeSpec(
        "e", ENCODE_FRAMES, B, "train"), 0, 0)["frame_embeds"]).to("cuda")
    batch = {"frame_embeds": frames}

    def enc():
        out = lm.encode(params, cfg, batch)
        torch.cuda.synchronize()
        return out

    def timed_encode(label, want=None):
        before = read_counts()["flash_prefill"]
        logits = enc()
        n = read_counts()["flash_prefill"] - before
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            enc()
            walls.append((time.perf_counter() - t0) * 1e3)
        ok = (logits.shape == (B, ENCODE_FRAMES, cfg.padded_vocab)
              and bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()))
        diff = ("" if want is None else
                f", frames whose argmax moved from the base's "
                f"{int((logits.argmax(-1) != want.argmax(-1)).sum())}/"
                f"{B * ENCODE_FRAMES}")
        print(f"[{tag}] {cfg.name} encode {label} ({B} x {ENCODE_FRAMES} "
              f"frames, {cfg.num_layers} layers): "
              f"{statistics.median(walls):.2f} ms (median of 3, wall, "
              f"synchronized), flash_prefill launches {n}{diff}", flush=True)
        if not ok:
            fail(f"{tag} encode {label}: logits misshapen or not finite")
        if n != cfg.num_layers:
            fail(f"{tag} encode {label}: flash_prefill launched {n} times, "
                 f"not once in each of the {cfg.num_layers} layers")
        return logits

    base = timed_encode("base")
    targets = AdapterConfig().target_modules
    saved = {p: w.clone() for p, w in iter_leaves(params)
             if leaf_name(p) in targets}
    packs = serve.make_adapters(cfg, params, 3)
    b, entries, sectors = switch_bound(torch, cfg)
    eng = SwitchEngine(params)
    for pack in packs:
        st = eng.switch(pack)
        print(f"[{tag}] {cfg.name} switched to {pack.name}: "
              f"{st.seconds * 1e3:.3f} ms, {st.entries_written} entries "
              f"(bound {b['bound_ms']:.4f} ms, {b['bound_by']}: {entries} "
              f"entries, {sectors} W sectors read and written)", flush=True)
        timed_encode(f"on {pack.name}", base)
    while eng.active:
        eng.unload()
    st = eng.load_fused(packs)
    print(f"[{tag}] {cfg.name} fused {len(packs)} adapters: "
          f"{sum(x.seconds for x in st) * 1e3:.3f} ms, "
          f"{sum(x.entries_written for x in st)} entries", flush=True)
    timed_encode("with all three fused", base)
    while eng.active:
        eng.unload()
    err = max(float((w - saved[p]).abs().max())
              for p, w in iter_leaves(params) if p in saved)
    print(f"[{tag}] {cfg.name} unloaded: target leaves within {err:.3g} of "
          f"the base (tol {RESTORE_TOL})", flush=True)
    if not err <= RESTORE_TOL:
        fail(f"{tag}: the base was not restored after unload")
    del saved, packs
    check_run(f"{tag} encode", read_counts(), ("flash_prefill",
                                               "scatter_apply"), totals,
              ("flash_decode", "flash_decode_paged"))
    print(f"[{tag}] peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f}"
          f" GB (max_memory_allocated)", flush=True)

    # one base encode under the profiler
    zero_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        enc()
    kern = device_kernels(torch, prof)
    busy = sum(k[0] for k in kern)
    fp = sum(ms for ms, _, name in kern if "flash_prefill" in name)
    n = read_counts()["flash_prefill"]
    print(f"[{tag}-profile] {cfg.name} encode ({B} x {ENCODE_FRAMES} frames,"
          f" {cfg.num_layers} layers): kernels {busy:.2f} ms in "
          f"{sum(k[1] for k in kern)} launches"
          + (f"; flash_prefill (non-causal, D = 80) {fp:.3f} ms "
             f"({fp / busy:.1%}) in {n} launches" if busy else
             " (profiler saw no device time: not measured)"), flush=True)
    for ms, k, name in sorted(kern, reverse=True)[:8]:
        print(f"[{tag}-profile]   {ms:8.3f} ms  x{k:<4d} {name[:90]}")
    kernel_share(f"{cfg.name} encode", kern)
    if n != cfg.num_layers:
        fail(f"{tag} profile: flash_prefill launched {n} times")
    check_run(f"{tag} profile", read_counts(), (), totals)
    encoder_refused(torch, cfg, params, tag)
    del params, base
    torch.cuda.empty_cache()
    return totals


def audio_consistency_phase(torch, cfg, tag="audio-consistency"):
    """Full width, 2 layers, f32: lm.encode on the card (flash_prefill's
    f32 instance) against the same call on the CPU (its plain version):
    every frame's argmax equal, the logits within ENCODE_TOL of the
    largest; then the Trainer against the CPU run (train_cpu_
    consistency)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.core.masks import map_leaves
    from repro_torch.data import make_batch
    from repro_torch.models import layers, lm
    cfg2 = two_layers(cfg)
    frames = torch.from_numpy(make_batch(cfg2, ShapeSpec(
        "c", ENCODE_FRAMES, 2, "train"), 1, 0)["frame_embeds"])
    with layers.compute_precision(torch.float32):
        params = lm.init_params(cfg2, seed=0, device="cuda")
        zero_counts()
        card = lm.encode(params, cfg2,
                         {"frame_embeds": frames.to("cuda")})
        n = read_counts()["flash_prefill"]
        t0 = time.perf_counter()
        cpu = lm.encode(map_leaves(lambda _, x: x.cpu(), params), cfg2,
                        {"frame_embeds": frames})
        cpu_s = time.perf_counter() - t0
    card = card.cpu()[..., :cfg2.vocab_size]
    cpu = cpu[..., :cfg2.vocab_size]
    top = float(cpu.abs().max())
    err = float((card - cpu).abs().max())
    moved = int((card.argmax(-1) != cpu.argmax(-1)).sum())
    print(f"[{tag}] {cfg.name} f32, {cfg2.num_layers} layers, full width, "
          f"encode of 2 x {ENCODE_FRAMES} frames: card (flash_prefill, {n} "
          f"launches) against CPU (plain; {cpu_s:.1f}s): max abs diff "
          f"{err:.3g} of the largest logit {top:.3g} (tol {ENCODE_TOL} of "
          f"it), frames whose argmax differs {moved}/{2 * ENCODE_FRAMES}",
          flush=True)
    if moved or not err <= ENCODE_TOL * top or n != cfg2.num_layers:
        fail(f"{tag}: the card's encode departs from the CPU's")
    del params
    train_cpu_consistency(torch, cfg.name, tag)


def audio_phases(torch):
    """The audio slice (AUDIO_ARCH, encoder only) at full width and all 48
    layers: its arithmetic first (parameters, three adapters at 2% of the
    default targets), then audio encode (with its profile, the CLI's exit
    and the engines' refusals), audio train (launch.train, packed SHiRA,
    8 x 256 frames; the multi-adapter trainer refusing) and
    audio-consistency at 2 layers in f32. Returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.masks import budget
    cfg = get_config(AUDIO_ARCH)
    ((L, mats, per_layer),), rest = stage_leaves(torch, cfg)
    targets = default_targets(mats)
    params = L * per_layer + rest
    entries = L * sum(budget(n, m, 0.98) for n, m in targets)
    print(f"[audio] {AUDIO_ARCH} (d_model {cfg.d_model}, {cfg.num_heads} "
          f"heads of {cfg.resolved_head_dim}, bidirectional, d_ff "
          f"{cfg.d_ff}, gelu, {cfg.vocab_size} classes, an untied head "
          f"({cfg.d_model}, {cfg.padded_vocab}); frame embeddings in, no "
          f"decode): {L} layers of {per_layer} parameters and {rest} outside"
          f" them = {params} parameters, {params * 4 / 1e9:.3f} GB in f32; "
          f"targets {targets} a layer: three adapters at 2% = 3 x {entries}"
          f" entries = {3 * entries * 8 / 1e6:.1f} MB of packs", flush=True)
    totals = {}
    for label, fn in (
            ("audio encode", lambda: audio_encode_phase(torch, cfg)),
            ("audio train", lambda: train_phase(torch, AUDIO_ARCH,
                                                tag="audio-train")[0]),
            ("audio-consistency", lambda: audio_consistency_phase(torch,
                                                                  cfg))):
        for k, v in (timed(label, fn) or {}).items():
            totals[k] = totals.get(k, 0) + v
        torch.cuda.empty_cache()
    check_run("audio phases", totals, ("flash_prefill", "scatter_apply",
                                       "sparse_adamw_blocks"), {},
              ("flash_decode", "flash_decode_paged"))
    return totals


def dense_depth(torch, cfg):
    """The deepest stack of ``cfg`` whose f32 parameters, three adapters'
    packs and side-delta tables at 2% of each target leaf (ADAPTER_BYTES:
    the tables as a fused transition's rebuild holds them), and the serve
    batch's bf16 KV fit in DENSE_BUDGET (at least MIN_DEPTH layers, at
    most the config's); what is left of the card takes the transients (a
    leaf's table build, the weight casts, the logits). Returns (layers,
    the arithmetic as text)."""
    ((_, mats, per_layer),), rest = stage_leaves(torch, cfg)
    target = sum(n * m for n, m in default_targets(mats))
    kv = B * (PROMPT + TOKENS + 8) * 2 * cfg.num_kv_heads \
        * cfg.resolved_head_dim * 2
    adapters = 0.02 * target * ADAPTER_BYTES
    layer_bytes = per_layer * 4 + adapters + kv
    fit = int((DENSE_BUDGET - rest * 4) // layer_bytes)
    layers = min(max(fit, MIN_DEPTH), cfg.num_layers)
    text = (f"{cfg.num_layers} layers at full width; a layer: {per_layer} "
            f"f32 parameters = {per_layer * 4 / 1e9:.3f} GB, 2% of its "
            f"{target} target entries x {ADAPTER_BYTES} B (three packs and "
            f"the fused state's tables beside the unfused ones) = "
            f"{adapters / 1e9:.3f} GB, KV of {B} x "
            f"{PROMPT + TOKENS + 8} rows = {kv / 1e6:.2f} MB; ("
            f"{DENSE_BUDGET / 1e9:.0f} GB - {rest} embedding, unembedding "
            f"and norm parameters x 4 B = {rest * 4 / 1e9:.2f} GB) / "
            f"{layer_bytes / 1e9:.3f} GB = {fit} layers -> {layers}")
    return layers, text


def dense_configs_phase(torch):
    """qwen1.5-32b (G 1), deepseek-coder-33b (G 7) and granite-34b (G 48)
    at full width, cut to ``dense_depth``: a multi-tenant serve through
    launch.serve --layers (3 adapters, B 8, 16 tokens: tok/s, peak memory,
    flash_decode / flash_prefill / sidedelta launches > 0), one
    multi-tenant decode step under torch.profiler, and at 2 layers in f32
    multi-tenant tokens equal to the switch-per-request reference."""
    from repro_torch.configs import get_config
    totals = {}
    mt = (SERVE_MODES[2],)
    for arch in DENSE_ARCHS:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        layers, text = dense_depth(torch, cfg)
        print(f"[dense] {arch} (H {cfg.num_heads}, KV {cfg.num_kv_heads}, G "
              f"{cfg.num_heads // cfg.num_kv_heads}): {text}", flush=True)
        for k, v in serve_phase(torch, arch, layers, mt, "dense").items():
            totals[k] = totals.get(k, 0) + v
        torch.cuda.empty_cache()
        profile_phase(torch, arch, layers, prefill=False, tag="dense",
                      labels=("multi-tenant f32",))
        torch.cuda.empty_cache()
        consistency_phase(torch, arch, tag="dense-consistency")
        torch.cuda.empty_cache()
        print(f"[time] dense {arch} {time.perf_counter() - t0:.1f}s",
              flush=True)
    return totals


def materialize_dense(torch, base, state, t):
    """{path: base + scatter(values)} of a packed trainer's target leaves,
    by the plain scatter."""
    from repro_torch.core.masks import iter_leaves, scatter_packed_add
    vals = dict(iter_leaves(state["trainable"]))
    idx = dict(iter_leaves(t.aux["indices"]))
    return {p: scatter_packed_add(w, idx[p], vals[p])
            for p, w in iter_leaves(base) if p in idx}


# ---------------------------------------------------------------------------
# 34. distributed: the launch modules (mesh, sharding, steps, dryrun) on
# torch.distributed
# ---------------------------------------------------------------------------

DIST_ARCH = "starcoder2-7b"
DIST_MOE = "granite-moe-1b-a400m"
DIST_LAYERS = 4          # (a)'s depth at world size 1 (NCCL): full width
DIST_STEPS = 3           # (a)'s train steps, mesh against mesh=None
DIST4_LAYERS = 2         # (b)'s depth: four ranks share the one card
DIST4_STEPS = 2          # (b)'s steps of each train step
DIST4_FSDP_STEPS = 1     # of them the full-finetune (fsdp) step's: 2 before
                         # the TP forward of the last five families, cut
                         # for the script's time limit
DIST_BATCH = (4, 256)    # a train batch: 4 x 256 tokens (data shards of 2)
DIST_PROMPT = 128        # the serve checks' prompts: 4 x 128 tokens
DIST_MOE_PROMPT = 32     # granite-moe's bf16 witness: 4 x 32 tokens, so
                         # that some row-steps lie beyond every flipped
                         # route's reach (none did at 128)
DIST_DECODE = 8          # and their decode steps
DIST_TOL = 1e-5          # (a): f32 losses, the mesh step against mesh=None
DIST4_TOL = 1e-4         # (b): f32 losses over 4 ranks against one
                         # rank's over the same two data shards
                         # (4608-wide sums split across ranks)
DIST_EP_TOL = 0.05       # (b): bf16 expert-parallel moe_ffn against the
                         # dense dispatch on the same tokens (the
                         # reference's bf16 tolerance for the same check)
BF16_U = 2.0 ** -8       # bf16's unit roundoff (8 significant bits)
DIST_CELLS = (("starcoder2-7b", "granite-moe-1b-a400m"), ("train_4k",))
DIST_SEQ_CELLS = ("starcoder2-7b", ("decode_32k", "prefill_32k"))  # (c),
                         # on 16 x 16: the sequence over ``model``
DIST_PATH = ("scatter_apply", "flash_prefill", "flash_decode")
SEQ_LAYERS = 2           # (b)'s sequence-sharded serving: full width, 2
SEQ_DECODE = 8           # layers, 8 greedy decode steps a prompt
SEQ_CASES = (            # (arch, mesh, batch, cache rows, prompt lengths)
    # decode_32k's 32,768 rows over 4 data ranks (batch 1, below the dp
    # size): 25,000 tokens put keys on every rank and the decode writes on
    # rank 3; 1,000 leave three ranks empty
    ("starcoder2-7b", (4, 1), 1, 32_768, (25_000, 1_000)),
    # one KV head against 4-way TP: the sequence over ``model``, 12 q heads
    # a rank gathered to 48 for the attention (the gather-q case)
    ("granite-34b", (1, 4), 2, 16_384, (10_000,)),
)
DIST_SEQ_PATH = ("flash_prefill", "flash_decode", "flash_decode (lse)")
A11_CASES = (            # (b)'s last five families' TP forward, full width:
    ("deepseek-v2-lite-16b", 2),  # its dense layer and an MoE layer (64
                                  # experts: 32 a rank on (2, 2), 16 on
                                  # (1, 4)); its config's fsdp=True
    ("mamba2-780m", 2),
    ("zamba2-2.7b", 6),           # one group: the shared block once
    ("paligemma-3b", 2),          # its 256-row patch prefix
    ("hubert-xlarge", 2))         # the encode step for serving
A11_STEPS = 2            # the packed SHiRA step's steps on (2, 2)
A11_PROMPT = 64          # serving: 2 x 64 tokens (after the prefix) on
A11_FRAMES = 256         # (1, 4), 8 greedy decode steps; hubert encodes
                         # 2 x 256 frames; each rank routes at most 512
                         # tokens a call, so no routing choice drops
A11_SEQ = ("zamba2-2.7b", (4, 1))  # batch 1 on (4, 1): the shared block's
                         # cache over ``data``, flash_decode's D = 80
                         # log-sum-exp instance
A11_TOL = 1e-4           # f32 cross-entropies and logits against one rank's
DIST_A11_CELLS = (       # (c) on 16 x 16, one cell a family of the last
    ("deepseek-v2-lite-16b,paligemma-3b", "decode_32k"),   # five: archs and
    ("mamba2-780m,zamba2-2.7b", "long_500k"),              # a shape, one
    ("hubert-xlarge", "prefill_32k"))                      # process a line


def dist_inputs(torch, arch, layers, fsdp=None, steps=DIST_STEPS):
    """(cfg, global f32 params, the global rand pack at 0.99, the train
    batches): the same on every rank, from seeds; ``fsdp`` None keeps the
    config's; ``steps`` batches of DIST_BATCH (a vision batch's patch
    prefix ahead of its tokens)."""
    from repro_torch.configs import AdapterConfig, ShapeSpec, get_config
    from repro_torch.core import masks as MK
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import lm
    cfg = get_config(arch).replace(num_layers=layers)
    if fsdp is not None:
        cfg = cfg.replace(fsdp=fsdp)
    params = lm.init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    acfg = AdapterConfig(kind="shira", mask="rand", sparsity=0.99)
    pack = MK.make_packed_indices(params, acfg, gen)
    B, S = DIST_BATCH
    batches = [make_batch(cfg, ShapeSpec("dist", S + cfg.prefix_rows, B,
                                         "train"), 0, i)
               for i in range(steps)]
    return cfg, params, pack, acfg, batches


def dist_rows(torch, batch, mesh=None):
    """A numpy batch on the card, its data-parallel rows on ``mesh`` (the
    whole batch without one): tokens and labels as int64, embeddings as
    f32."""
    n, i = (1, 0) if mesh is None else (mesh.shape.get("data", 1),
                                         mesh.coord("data"))
    out = {}
    for k, v in batch.items():
        per = v.shape[0] // n
        t = torch.from_numpy(v[i * per:(i + 1) * per]).to("cuda")
        out[k] = t.float() if t.is_floating_point() else t.long()
    return out


def dist_shira_state(torch, params, pack, pspecs, mesh):
    """Shard-local indices split from the global pack (core.adapters.
    split_packed: (..., DPC, TPC, Ks) over each leaf's tiles), this rank's
    slice of them, and a zero train state of their values."""
    from repro_torch.core import adapters as A
    from repro_torch.core.masks import iter_leaves, map_leaves
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps as S
    specs, shapes = dict(iter_leaves(pspecs)), dict(iter_leaves(params))
    idx4 = {}
    for p, i in iter_leaves(pack):
        tiles = shd.tile_counts(specs[p], shapes[p].ndim, mesh)
        idx4[p] = A.split_packed(i, torch.zeros(i.shape, device="cuda"),
                                 shapes[p].shape, tiles)[0]
    vspecs = S.value_specs(pspecs, idx4)
    local = map_leaves(lambda p, _: shd.local_shard(idx4[p], vspecs[p], mesh),
                       pack)
    vals = map_leaves(lambda _, t: torch.zeros(t.shape, device="cuda"), local)
    return local, dist_state(torch, vals)


def dist_state(torch, trainable):
    from repro_torch.core.masks import map_leaves
    zeros = lambda: map_leaves(lambda _, t: torch.zeros_like(t), trainable)
    return {"trainable": trainable, "step": 0, "mu": zeros(), "nu": zeros()}


def dist_metrics(m) -> dict:
    return {k: float(v) for k, v in m.items()}


def dist_serve(torch, cfg, params, mesh, prompt, force=None, size=None,
               steps=DIST_DECODE, with_caches=False):
    """Prefill + ``steps`` decode steps in bf16 through the steps
    (mesh=None: the unsharded steps), greedy or fed the tokens ``force``,
    into caches of ``size`` rows (the prompt and the steps by default; the
    serving shape is then a batch of the prompt's rows): the tokens and
    every step's logits, and with ``with_caches`` the caches and the
    decode step."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import steps as S
    P = prompt.shape[1]
    shape = None
    if size is not None:
        shape = ShapeSpec("serve", size, prompt.shape[0], "decode")
    size = size or P + DIST_DECODE + 1
    prefill = S.make_prefill_step(cfg, size, mesh, shape)
    decode = S.make_decode_step(cfg, mesh, shape)
    logits, caches = prefill(params, {"tokens": prompt})
    toks, outs = [], [logits]
    for i in range(steps):
        nxt = (torch.argmax(logits, -1)[:, None] if force is None
               else force[:, i:i + 1].to(prompt.device))
        toks.append(nxt)
        logits, caches = decode(params, caches, nxt, P + i)
        outs.append(logits)
    if with_caches:
        return (torch.cat(toks, 1), torch.stack(outs, 1).float(), caches,
                decode)
    return torch.cat(toks, 1), torch.stack(outs, 1).float()


def dist_serve_precision(torch, arch):
    """(b)'s held serving precision: bf16, but f32 for the MoE model, whose
    routing flips on near-tied experts when the TP ranks' bf16 partial
    sums round the hidden state another way: a flipped route is another
    model output, not a tolerance. Its bf16 run is held by
    ``dist_moe_bf16`` instead."""
    from repro_torch.models import layers
    if arch == DIST_MOE:
        return layers.compute_precision(torch.float32)
    return contextlib.nullcontext()


def dist_prompt(torch, cfg):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    return torch.randint(0, cfg.vocab_size, (DIST_BATCH[0], DIST_PROMPT),
                         generator=gen, device="cuda")


def dist_world1(torch, tmp):
    """(a) World size 1 through NCCL on a (1, 1) mesh, full width, at
    DIST_LAYERS: the packed SHiRA step on shard-local indices against
    make_shira_train_step(mesh=None), the prefill and decode steps against
    the unsharded ones, granite-moe's moe_ffn under "moe_ep_mesh" against
    the dense dispatch. Returns the path's launch counts."""
    import torch.distributed as dist
    from repro_torch.configs import TrainConfig
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps as S
    from repro_torch.launch.actctx import sharding_hints
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers, lm
    from repro_torch.models.moe import moe_ffn
    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl", rank=0,
                            world_size=1)
    try:
        probe = torch.full((8,), 3.0, device="cuda")
        dist.all_reduce(probe)
        if not bool((probe == 3.0).all()):
            fail("distributed: NCCL all_reduce of world size 1 changed its "
                 "input")
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        print(f"[distributed] (a) NCCL {dist.get_backend()}, world size "
              f"{dist.get_world_size()}, {mesh}; {DIST_ARCH} at full width, "
              f"{DIST_LAYERS} of 32 layers (DIST_LAYERS)", flush=True)
        tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1)
        with layers.compute_precision(torch.float32):
            cfg, params, pack, acfg, batches = dist_inputs(
                torch, DIST_ARCH, DIST_LAYERS)
            pspecs = shd.param_specs(params, cfg, mesh)
            base = shd.shard_tree(params, pspecs, mesh)
            idx, state = dist_shira_state(torch, params, pack, pspecs, mesh)
            step = S.make_shira_train_step(cfg, tcfg, acfg, mesh, pspecs)
            zero_counts()
            got, walls = [], []
            for b in batches:
                t0 = time.perf_counter()
                state, m = step(state, dist_rows(torch, b, mesh), base, idx)
                got.append(dist_metrics(m))
                walls.append((time.perf_counter() - t0) * 1e3)
            del state, idx
        with torch.no_grad():
            prompt = dist_prompt(torch, cfg)
            toks, logits = dist_serve(torch, cfg, base, mesh, prompt)
        counts = read_counts()
        check_run("distributed (a)", counts, DIST_PATH, {})
        with layers.compute_precision(torch.float32):
            ref_step = S.make_shira_train_step(cfg, tcfg, acfg)
            state = dist_state(torch, dist_zeros(torch, pack))
            ref = []
            for b in batches:
                state, m = ref_step(state, dist_rows(torch, b, mesh), params,
                                    pack)
                ref.append(dist_metrics(m))
            del state
        with torch.no_grad():
            rtoks, rlogits = dist_serve(torch, cfg, params, None, prompt)
        dl = max(abs(g["loss"] - r["loss"]) for g, r in zip(got, ref))
        print(f"[distributed] (a) SHiRA step on the mesh: losses "
              f"{[round(g['loss'], 6) for g in got]}, mesh=None "
              f"{[round(r['loss'], 6) for r in ref]}: max diff {dl:.3g} "
              f"(tol {DIST_TOL}); steps {[round(w, 1) for w in walls]} ms "
              f"(wall, {DIST_BATCH[0]} x {DIST_BATCH[1]} tokens, f32)",
              flush=True)
        if not dl <= DIST_TOL:
            fail("distributed (a): the sharded SHiRA step's losses depart "
                 "from mesh=None's")
        same = bool(torch.equal(toks, rtoks))
        ld = float((logits - rlogits).abs().max())
        print(f"[distributed] (a) prefill + {DIST_DECODE} decode steps, "
              f"bf16: tokens equal the unsharded steps' {same}, logits max "
              f"diff {ld:.3g}; launches on the path {counts}", flush=True)
        if not same:
            fail("distributed (a): the mesh's serving tokens differ")
        del base, params, pack, logits, rlogits
        torch.cuda.empty_cache()
        # granite-moe: expert-parallel dispatch on the (1, 1) mesh
        from repro_torch.configs import get_config
        from repro_torch.models.lm import layer_slice
        mcfg = get_config(DIST_MOE).replace(num_layers=2)
        mp = lm.init_params(mcfg, seed=0, device="cuda")
        moe = layer_slice(mp["stages"][0], 0)["moe"]
        gen = torch.Generator(device="cuda")
        gen.manual_seed(2)
        x = torch.randn((4, 128, mcfg.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16)
        with torch.no_grad():
            y, aux = moe_ffn(moe, mcfg, x)
            with sharding_hints(moe_ep_mesh=(mesh, 1)):
                y_ep, aux_ep = moe_ffn(moe, mcfg, x)
        md = float((y.float() - y_ep.float()).abs().max())
        print(f"[distributed] (a) {DIST_MOE} moe_ffn (full width, 512 "
              f"tokens: drop-free) under moe_ep_mesh: max diff {md:.3g} "
              f"against the dense dispatch, aux {float(aux_ep):.6f} vs "
              f"{float(aux):.6f}", flush=True)
        if md > 0 or float(aux) != float(aux_ep):
            fail("distributed (a): expert-parallel moe_ffn departs from the "
                 "dense dispatch on one rank")
        del mp, moe, x, y, y_ep
        torch.cuda.empty_cache()
        return counts
    finally:
        dist.destroy_process_group()


def dist_zeros(torch, pack):
    """Zero packed values shaped as the pack's indices (None elsewhere)."""
    from repro_torch.core.masks import map_leaves
    return map_leaves(lambda _, i: torch.zeros(i.shape, device="cuda"),
                      pack)


def dist_refs(torch):
    """The single-rank runs (b) is held against, at DIST4_LAYERS, f32:
    per arch the unsharded SHiRA and full-finetune steps' metrics on the
    global batches, and bf16 serving logits."""
    from repro_torch.configs import TrainConfig
    from repro_torch.core.masks import map_leaves
    from repro_torch.launch import steps as S
    from repro_torch.models import layers
    # two slices of each batch, the mesh's data shards: the MoE aux of
    # each shard is its own, as under expert parallelism
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, microbatch=2)
    out = {}
    for arch in (DIST_ARCH, DIST_MOE):
        with layers.compute_precision(torch.float32):
            cfg, params, pack, acfg, batches = dist_inputs(
                torch, arch, DIST4_LAYERS, fsdp=True)
            batches = batches[:DIST4_STEPS]
            step = S.make_shira_train_step(cfg, tcfg, acfg)
            state = dist_state(torch, dist_zeros(torch, pack))
            shira = []
            for b in batches:
                state, m = step(state, dist_rows(torch, b), params, pack)
                shira.append(dist_metrics(m))
            del state
            step = S.make_train_step(cfg, tcfg)
            state = dist_state(torch, map_leaves(lambda _, t: t.clone(),
                                                 params))
            full = []
            for b in batches[:DIST4_FSDP_STEPS]:
                state, m = step(state, dist_rows(torch, b))
                full.append(dist_metrics(m))
            del state
            torch.cuda.empty_cache()
        prompt = dist_prompt(torch, cfg)
        with torch.no_grad(), dist_serve_precision(torch, arch):
            toks, logits = dist_serve(torch, cfg, params, None, prompt)
        out[arch] = {"shira": shira, "full": full, "tokens": toks.cpu(),
                     "logits": logits.cpu()}
        if arch == DIST_MOE:
            from repro_torch.models import moe
            short = prompt[:, :DIST_MOE_PROMPT]
            with torch.no_grad(), moe.record_routes() as calls:
                toks, logits = dist_serve(torch, cfg, params, None, short)
            # the f32 model on the same tokens: one rank's own bf16 error
            # where the two route alike, the scale the mesh is held at
            with torch.no_grad(), layers.compute_precision(torch.float32), \
                    moe.record_routes() as f32_calls:
                _, f32 = dist_serve(torch, cfg, params, None, short, toks)
            out[arch]["bf16"] = {
                "tokens": toks.cpu(), "logits": logits.cpu(),
                "f32_logits": f32.cpu(),
                "f32_routes": [c["top_i"].cpu() for c in f32_calls],
                "routes": [{k: v.cpu() for k, v in c.items()}
                           for c in calls]}
        del params, pack
        torch.cuda.empty_cache()
    return out


def seq_prompt(torch, cfg, batch, P):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(P)
    return torch.randint(0, cfg.vocab_size, (batch, P), generator=gen,
                         device="cuda")


def dist_seq_refs(torch):
    """(b)'s sequence-sharded cases on one rank, unsharded (mesh=None):
    for each case and prompt, the f32 greedy tokens and logits and the bf16
    greedy tokens and logits, on the card's caches of the case's rows."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers, lm
    out = {}
    for arch, _, batch, rows, prompts in SEQ_CASES:
        cfg = get_config(arch).replace(num_layers=SEQ_LAYERS)
        params = lm.init_params(cfg, seed=0, device="cuda")
        for P in prompts:
            prompt = seq_prompt(torch, cfg, batch, P)
            with torch.no_grad(), layers.compute_precision(torch.float32):
                toks, logits = dist_serve(torch, cfg, params, None, prompt,
                                          size=rows, steps=SEQ_DECODE)
            with torch.no_grad():
                toks16, logits16 = dist_serve(torch, cfg, params, None,
                                              prompt, size=rows,
                                              steps=SEQ_DECODE)
            out[(arch, P)] = {"tokens": toks.cpu(), "logits": logits.cpu(),
                              "bf16_tokens": toks16.cpu(),
                              "bf16_logits": logits16.cpu()}
            del logits, logits16
        del params
        torch.cuda.empty_cache()
    return out


def dist_seq_rank(torch, case, seq_refs):
    """(b) One rank's sequence-sharded serving of one of SEQ_CASES: its
    mesh, the weights' serving shards, and per prompt the f32 greedy run,
    the bf16 run fed one rank's bf16 tokens, then one more bf16 decode
    step's collectives and wall (recorded) and device time (profiled)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.analysis.profile import collective_summary
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps as S
    from repro_torch.models import layers, lm
    arch, shape, batch, rows, prompts = case
    mesh = M.make_mesh(shape, ("data", "model"), "cuda")
    cfg = get_config(arch).replace(num_layers=SEQ_LAYERS)
    params = lm.init_params(cfg, seed=0, device="cuda")
    local = shd.shard_tree(params, S.serve_param_shardings(cfg, mesh), mesh)
    del params
    torch.cuda.empty_cache()
    sshape = ShapeSpec("serve", rows, batch, "decode")
    out = {"coords": mesh.coords,
           "axes": shd.kv_seq_axes(cfg, shd.cache_specs(cfg, sshape,
                                                       mesh))}
    for P in prompts:
        ref = seq_refs[(arch, P)]
        prompt = seq_prompt(torch, cfg, batch, P)
        with torch.no_grad(), layers.compute_precision(torch.float32):
            toks, logits = dist_serve(torch, cfg, local, mesh, prompt,
                                      size=rows, steps=SEQ_DECODE)
        with torch.no_grad():
            _, logits16, caches, decode = dist_serve(
                torch, cfg, local, mesh, prompt, force=ref["bf16_tokens"],
                size=rows, steps=SEQ_DECODE, with_caches=True)
            # one more step, at the position after the fed ones, timed
            at = P + SEQ_DECODE
            tok = ref["bf16_tokens"][:, -1:].to("cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with M.record() as ev:
                decode(local, caches, tok, at)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                decode(local, caches, tok, at)
                torch.cuda.synchronize()
            held = int(caches[0].k.shape[2])
            del caches
        out[P] = {"tokens": toks.cpu(), "logits": logits.cpu(),
                  "bf16_logits": logits16.cpu(), "wall_ms": wall,
                  "device_ms": sum(
                      getattr(e, "self_device_time_total", 0)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
                  / 1e3, "coll": collective_summary(ev), "cache_rows": held}
        torch.cuda.empty_cache()
    del local
    torch.cuda.empty_cache()
    return out


def a11_prompt(torch, cfg, batch):
    """A serving batch, seeded: ``batch`` x A11_PROMPT tokens after a
    vision model's patch prefix, or ``batch`` x A11_FRAMES frames."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    if cfg.modality == "audio":
        return {"frame_embeds": torch.randn(
            (batch, A11_FRAMES, cfg.d_model), generator=gen, device="cuda")}
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, A11_PROMPT),
                                   generator=gen, device="cuda")}
    if cfg.modality == "vision":
        out["patch_embeds"] = torch.randn(
            (batch, cfg.prefix_rows, cfg.d_model), generator=gen,
            device="cuda") * 0.5
    return out


def a11_size(cfg, mesh_shape) -> int:
    """The serving cache's rows: the prefix, the prompt and the decode
    steps, rounded up to a multiple of the mesh's size (a sequence-sharded
    cache divides over its ranks)."""
    n = mesh_shape[0] * mesh_shape[1]
    need = cfg.prefix_rows + A11_PROMPT + DIST_DECODE + 1
    return -(-need // n) * n


def a11_serve(torch, cfg, params, mesh, inputs, mesh_shape):
    """f32 serving through the steps (mesh=None: the unsharded ones):
    greedy prefill + DIST_DECODE decode steps, or an encoder's encode
    step; the tokens, the logits, the collectives of the first decode
    step (or of the encode) and the rows a rank's first KV cache holds."""
    from repro_torch.analysis.profile import collective_summary
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps as S
    from repro_torch.models import layers
    B = next(iter(inputs.values())).shape[0]
    with torch.no_grad(), layers.compute_precision(torch.float32):
        if cfg.encoder_only:
            shape = ShapeSpec("a11", A11_FRAMES, B, "prefill")
            step = S.make_encode_step(cfg, mesh, shape)
            with M.record() as ev:
                logits = step(params, inputs)
            return {"logits": logits.float().cpu(),
                    "coll": collective_summary(ev)}
        size = a11_size(cfg, mesh_shape)
        shape = ShapeSpec("a11", size, B, "decode")
        prefill = S.make_prefill_step(cfg, size, mesh, shape)
        decode = S.make_decode_step(cfg, mesh, shape)
        logits, caches = prefill(params, inputs)
        at = cfg.prefix_rows + A11_PROMPT
        toks, outs, coll = [], [logits], None
        for i in range(DIST_DECODE):
            nxt = torch.argmax(logits, -1)[:, None]
            toks.append(nxt)
            with M.record() as ev:
                logits, caches = decode(params, caches, nxt, at + i)
            coll = coll or collective_summary(ev)
            outs.append(logits)
    rows = None
    for st in caches:
        kv = st["attn"] if isinstance(st, dict) else st
        if hasattr(kv, "k"):
            rows = int(kv.k.shape[-3 if kv.k.ndim == 5 else -2])
            break
    return {"tokens": torch.cat(toks, 1).cpu(),
            "logits": torch.stack(outs, 1).float().cpu(), "coll": coll,
            "cache_rows": rows}


def a11_refs(torch):
    """The one-rank runs (b)'s A11_CASES are held against, f32, on the
    card: the unsharded packed SHiRA step over two microbatches (the
    mesh's data shards, each shard's MoE aux its own) on the same batches
    and pack, and the unsharded serving steps (or encode) on the same
    prompts; A11_SEQ's batch-1 serve too."""
    from repro_torch.configs import TrainConfig
    from repro_torch.launch import steps as S
    from repro_torch.models import layers
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, microbatch=2)
    out = {}
    for arch, n in A11_CASES:
        with layers.compute_precision(torch.float32):
            cfg, params, pack, acfg, batches = dist_inputs(
                torch, arch, n, steps=A11_STEPS)
            step = S.make_shira_train_step(cfg, tcfg, acfg)
            state = dist_state(torch, dist_zeros(torch, pack))
            shira = []
            for b in batches:
                state, m = step(state, dist_rows(torch, b), params, pack)
                shira.append(dist_metrics(m))
            del state
        out[arch] = {"shira": shira, "serve": a11_serve(
            torch, cfg, params, None, a11_prompt(torch, cfg, 2), (1, 4))}
        if arch == A11_SEQ[0]:
            out[arch]["seq"] = a11_serve(torch, cfg, params, None,
                                         a11_prompt(torch, cfg, 1),
                                         A11_SEQ[1])
        del params, pack
        torch.cuda.empty_cache()
    return out


def a11_rank(torch, mesh):
    """(b) One rank's A11_CASES: per family, the counts zeroed just before
    and read just after, the packed SHiRA step on the (2, 2) ``mesh``
    (shard-local indices; deepseek-v2-lite's base FSDP-sharded as its
    config trains), its ce, loss and one step's collectives; then the
    serving steps (hubert's encode) on a (1, 4) mesh of the same ranks;
    zamba2 also at batch 1 on (4, 1) (A11_SEQ)."""
    from repro_torch.analysis.profile import collective_summary
    from repro_torch.configs import TrainConfig
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps as S
    from repro_torch.models import layers
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1)
    m14 = M.make_mesh((1, 4), ("data", "model"), "cuda")
    out = {}
    for arch, n in A11_CASES:
        zero_counts()
        r = out[arch] = {}
        with layers.compute_precision(torch.float32):
            cfg, params, pack, acfg, batches = dist_inputs(
                torch, arch, n, steps=A11_STEPS)
            pspecs = shd.param_specs(params, cfg, mesh)
            base = shd.shard_tree(params, pspecs, mesh)
            idx, state = dist_shira_state(torch, params, pack, pspecs, mesh)
            step = S.make_shira_train_step(cfg, tcfg, acfg, mesh, pspecs)
            r["shira"], walls = [], []
            for b in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with M.record() as ev:
                    state, m = step(state, dist_rows(torch, b, mesh), base,
                                    idx)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                r["shira"].append(dist_metrics(m))
            r["shira_coll"] = collective_summary(ev)
            r["shira_wall_ms"] = walls
            del state, idx, base
        torch.cuda.empty_cache()
        local = shd.shard_tree(params, S.serve_param_shardings(cfg, m14),
                               m14)
        r["serve"] = a11_serve(torch, cfg, local, m14,
                               a11_prompt(torch, cfg, 2), (1, 4))
        del local
        if arch == A11_SEQ[0]:
            mseq = M.make_mesh(A11_SEQ[1], ("data", "model"), "cuda")
            local = shd.shard_tree(params, S.serve_param_shardings(
                cfg, mseq), mseq)
            r["seq"] = a11_serve(torch, cfg, local, mseq,
                                 a11_prompt(torch, cfg, 1), A11_SEQ[1])
            del local
        del params, pack
        torch.cuda.empty_cache()
        r["counts"] = read_counts()
    return out


def a11_report(torch, ranks, refs, totals):
    """(b) A11_CASES held: on rank 0 (its losses are the dp mean) the f32
    cross-entropies of the SHiRA step within A11_TOL of one rank's; on
    every rank the f32 greedy tokens equal one rank's and the logits (the
    frame logits of hubert's encode) within A11_TOL; each rank's
    collective bytes for one decode step (or the encode); the launch
    check of each family's path (scatter_apply in every SHiRA step;
    flash_decode's log-sum-exp instance on paligemma's cache, sequence-
    sharded over ``model``, at D = 256, and on zamba2's over ``data`` at
    D = 80; flash_prefill at D = 80 on zamba2's shared block and non-
    causal on hubert's encode; no attention kernel on MLA or Mamba2), the
    counts added to ``totals``. Returns the launches by (kernel, arch)."""
    from repro_torch.configs import get_config
    needed = {"deepseek-v2-lite-16b": ("scatter_apply",),
              "mamba2-780m": ("scatter_apply",),
              "zamba2-2.7b": ("scatter_apply", "flash_prefill",
                              "flash_decode", "flash_decode (lse)"),
              "paligemma-3b": ("scatter_apply", "flash_decode",
                               "flash_decode (lse)"),
              "hubert-xlarge": ("scatter_apply", "flash_prefill")}
    absent = {"deepseek-v2-lite-16b": ATTN_KERNELS,
              "mamba2-780m": ATTN_KERNELS,
              "zamba2-2.7b": ("flash_decode_paged",),
              "paligemma-3b": ("flash_decode_paged", "flash_prefill"),
              "hubert-xlarge": ("flash_decode", "flash_decode_paged")}
    by_arch = {}
    for arch, n in A11_CASES:
        counts = {}
        for rr in ranks:
            for k, v in rr["a11"][arch]["counts"].items():
                counts[k] = counts.get(k, 0) + v
        check_run(f"distributed (b) {arch}", counts, needed[arch], totals,
                  absent[arch])
        by_arch[arch] = counts
        ref, r0 = refs[arch], ranks[0]["a11"][arch]
        V = get_config(arch).vocab_size      # the pad columns are -1e30
        d = max(abs(g["ce"] - w["ce"]) for g, w in zip(r0["shira"],
                                                       ref["shira"]))
        got_ce = [round(g["ce"], 6) for g in r0["shira"]]
        want_ce = [round(w["ce"], 6) for w in ref["shira"]]
        print(f"[distributed] (b) {arch} at full width, {n} layers: packed "
              f"SHiRA on (2, 2), f32 ce {got_ce} against one rank's "
              f"{want_ce}: max diff {d:.3g} (tol {A11_TOL}); step walls "
              f"{[round(w, 1) for w in r0['shira_wall_ms']]} ms on rank 0; "
              f"launches {({k: v for k, v in counts.items() if v})}",
              flush=True)
        if not d <= A11_TOL:
            fail(f"distributed (b): {arch}'s sharded SHiRA step departs from "
                 "one rank's")
        for i, rr in enumerate(ranks):
            c = rr["a11"][arch]["shira_coll"]
            print(f"[distributed] (b)   rank {i} {tuple(rr['coords'])}: "
                  f"SHiRA step collectives {c['total_bytes'] / 1e6:.2f} MB "
                  f"({c['by_kind_count']})", flush=True)
        cases = [("serve", "(1, 4)")]
        if arch == A11_SEQ[0]:
            cases.append(("seq", f"{A11_SEQ[1]}, batch 1"))
        for key, where in cases:
            want = ref[key]
            got = [rr["a11"][arch][key] for rr in ranks]
            ld = max(float((g["logits"][..., :V] - want["logits"][..., :V])
                           .abs().max()) for g in got)
            same = all(torch.equal(g["tokens"], want["tokens"]) for g in got
                       if "tokens" in g)
            what = (f"encode of 2 x {A11_FRAMES} frames" if "tokens" not in
                    want else f"prefill + {DIST_DECODE} decode steps (cache "
                    f"rows a rank {got[0]['cache_rows']}), greedy tokens "
                    f"equal one rank's on every rank {same},")
            print(f"[distributed] (b) {arch} {what} on {where}, f32: logits "
                  f"max diff {ld:.3g} (tol {A11_TOL}, max |logit| "
                  f"{float(want['logits'][..., :V].abs().max()):.3g})",
                  flush=True)
            for i, g in enumerate(got):
                c = g["coll"]
                print(f"[distributed] (b)   rank {i}: one "
                      f"{'encode' if 'tokens' not in g else 'decode step'}'s "
                      f"collectives {c['total_bytes']} bytes "
                      f"({c['by_kind_count']})", flush=True)
            if not (same and ld <= A11_TOL):
                fail(f"distributed (b): {arch}'s serving on {where} departs "
                     "from one rank's")
    return by_arch


def dist_probe(torch, mesh):
    """One call of each collective the steps use, on CUDA tensors through
    gloo, checked: all_reduce (sum, max), all_gather, reduce_scatter."""
    from repro_torch.launch import mesh as M
    r = torch.distributed.get_rank()
    for axis in ("model", "data"):
        i = mesh.axis_names.index(axis)
        # the ranks that differ from this one along ``axis`` only (ranks
        # lie row-major over the mesh, as init_device_mesh lays them out)
        stride = 1
        for size in mesh.devices_shape[i + 1:]:
            stride *= size
        peers = [r + (j - mesh.coord(axis)) * stride
                 for j in range(mesh.shape[axis])]
        x = torch.full((4,), float(r + 1), device="cuda")
        got = {"all_reduce sum": (M.all_reduce(mesh, x, axis),
                                  sum(p + 1 for p in peers)),
               "all_reduce max": (M.all_reduce(mesh, x, axis, "max"),
                                  max(p + 1 for p in peers)),
               "reduce_scatter": (M.reduce_scatter(mesh, x, axis),
                                  sum(p + 1 for p in peers)),
               "all_gather": (M.all_gather(mesh, x[:1] * 0 + mesh.coord(
                   axis), axis), None)}
        for k, (t, want) in got.items():
            ok = (t.tolist() == [float(j) for j in range(mesh.shape[axis])]
                  if want is None else bool((t == want).all()))
            if t.device.type != "cuda" or not ok:
                raise RuntimeError(f"gloo {k} over {axis} on CUDA tensors: "
                                   f"{t.device} {t.tolist()}")


def dist_ep_combine(torch, cfg, params, local, mesh) -> float:
    """(b) The bf16 expert-parallel moe_ffn of layer 0 on this rank's
    shard (its E / 2 experts, the partial outputs summed over ``model``)
    against the dense dispatch of every expert on the same tokens (its data
    shard, 2 of 4 x 128 tokens, drop-free): the max |y| difference. The same
    input gives the same routes, so only the combine's order differs."""
    from repro_torch.launch import steps as S
    from repro_torch.launch.actctx import sharding_hints
    from repro_torch.models.lm import layer_slice
    from repro_torch.models.moe import moe_ffn
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    x = torch.randn((4, 128, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    x = x[mesh.coord("data") * 2:(mesh.coord("data") + 1) * 2]
    full = layer_slice(params["stages"][0], 0)["moe"]
    mine = layer_slice(local["stages"][0], 0)["moe"]
    hints = S.sharding_hints_for(cfg.replace(fsdp=False), None, mesh)
    with torch.no_grad():
        y, _ = moe_ffn(full, cfg, x)
        with sharding_hints(**hints):
            y_ep, _ = moe_ffn(mine, cfg, x)
    return float((y.float() - y_ep.float()).abs().max())


def route_witness(torch, ref, mesh, B, layers, k):
    """(b)'s bf16 witness for the MoE model's routes. ``ref``: one rank's
    recorded calls (``moe.record_routes``: x, w, logits, top_i over the B
    rows); ``mesh``: per data rank, its calls' top_i over its rows. A call
    of S tokens a row runs layer (call index % layers) at the row's next S
    positions. Returns (flips, gaps): each token whose expert set differs,
    as a dict of row, layer, pos, one rank's margin ``gap`` of the most
    separated pair that swapped (an expert the mesh lost over one it
    gained), its ``bound``, bf16's rounding of the router's product there,
    2^-8 * sum_i |x_i| (|w_ia| + |w_ib|) (one rounding of the hidden
    state, for each of the two), and ``primary`` (no route of an earlier
    layer flipped in its row at its position or before, so the hidden
    state it routed on came through the same experts); and every one-rank
    token's margin between its k-th and (k+1)-th logit."""
    per = B // len(mesh)
    pos = [0] * layers
    flips, gaps = [], []
    for c, call in enumerate(ref):
        layer = c % layers
        T = call["top_i"].shape[0]
        S_c = T // B
        want = call["top_i"].reshape(B, S_c, k)
        got = torch.cat([m[c].reshape(per, S_c, k) for m in mesh])
        vals = torch.sort(call["logits"], -1, descending=True)[0]
        gaps.append(vals[:, k - 1] - vals[:, k])
        differ = (torch.sort(want, -1)[0] != torch.sort(got, -1)[0]).any(-1)
        for b, sq in differ.nonzero().tolist():
            t = b * S_c + sq
            a_set = set(want[b, sq].tolist())
            g_set = set(got[b, sq].tolist())
            lg = call["logits"][t]
            a = max(a_set - g_set, key=lambda e: float(lg[e]))
            g = min(g_set - a_set, key=lambda e: float(lg[e]))
            xa = call["x"][t].float().abs()
            w = call["w"].float().abs()
            flips.append({"row": b, "layer": layer, "pos": pos[layer] + sq,
                          "gap": float(lg[a] - lg[g]),
                          "bound": BF16_U * float(xa @ (w[:, a] + w[:, g]))})
        pos[layer] += S_c
    for f in flips:
        f["primary"] = not any(e["row"] == f["row"] and e["layer"] <
                               f["layer"] and e["pos"] <= f["pos"]
                               for e in flips)
    return flips, torch.cat(gaps)


def clean_steps(flips, B, layers, positions):
    """(B, steps) True where no flipped route can reach the step's logits:
    no flip in its row at an earlier layer than the last at its position
    or before, none in the last layer at its position."""
    out = [[True] * len(positions) for _ in range(B)]
    for f in flips:
        for s, q in enumerate(positions):
            if (f["layer"] < layers - 1 and f["pos"] <= q) or \
                    f["pos"] == q:
                out[f["row"]][s] = False
    return out


def dist_rank(rank, world, tmp, out, ref_tokens, seq_refs):
    """(b) One of four ranks on cuda:0 through gloo, on a (2, 2) mesh;
    its decode is fed the single-rank run's tokens ``ref_tokens``. Then
    the sequence-sharded cases (SEQ_CASES, each on its own mesh of the
    four ranks), held against ``seq_refs``, and the last five families
    (A11_CASES, ``a11_rank``)."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    from repro_torch.analysis.profile import (collective_bytes,
                                              collective_summary)
    from repro_torch.configs import TrainConfig
    from repro_torch.core.masks import iter_leaves
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps as S
    from repro_torch.launch.actctx import sharding_hints
    from repro_torch.models import blocks, layers, lm
    missing = [n for n in ("scatter_apply", "flash_prefill", "flash_decode")
               if not build.library_path(n).exists()]
    if missing:
        raise RuntimeError(f"rank {rank}: kernels {missing} not built by "
                           "the build phase")
    dist.init_process_group("gloo", init_method=f"file://{tmp}/gloo",
                            rank=rank, world_size=world)
    mesh = M.make_mesh((2, 2), ("data", "model"), "cuda")
    dist_probe(torch, mesh)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1)
    res = {"coords": mesh.coords, "rank": rank}
    zero_counts()
    for arch in (DIST_ARCH, DIST_MOE):
        r = res[arch] = {}
        with layers.compute_precision(torch.float32):
            cfg, params, pack, acfg, batches = dist_inputs(
                torch, arch, DIST4_LAYERS, fsdp=True)
            batches = batches[:DIST4_STEPS]
            # the packed SHiRA step (no FSDP: the values are the trained
            # part; the base is TP-sharded)
            scfg = cfg.replace(fsdp=False)
            pspecs = shd.param_specs(params, scfg, mesh)
            r["specs"] = {p: repr(s) for p, s in iter_leaves(pspecs)
                          if p.startswith("embed") or p.startswith("unembed")}
            base = shd.shard_tree(params, pspecs, mesh)
            idx, state = dist_shira_state(torch, params, pack, pspecs, mesh)
            step = S.make_shira_train_step(scfg, tcfg, acfg, mesh, pspecs)
            r["shira"], walls = [], []
            for i, b in enumerate(batches):
                rows = dist_rows(torch, b, mesh)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with M.record() as ev:
                    state, m = step(state, rows, base, idx)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                r["shira"].append(dist_metrics(m))
            r["shira_coll"] = collective_summary(ev)
            r["shira_wall_ms"] = walls[-1] * 1e3
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                state, _ = step(state, dist_rows(torch, batches[-1], mesh),
                                base, idx)
                torch.cuda.synchronize()
            r["shira_device_ms"] = sum(
                getattr(e, "self_device_time_total", 0)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
            if arch == DIST_ARCH:
                # one TP block, forward and backward, counted by hand
                B, Sq = DIST_BATCH
                x = torch.randn((B // 2, Sq, cfg.d_model), device="cuda",
                                requires_grad=True)

                def block():
                    with sharding_hints(tp=shd.TPLayout(scfg, mesh)):
                        h, _ = blocks.block_train(
                            lm.layer_slice(base["stages"][0], 0), scfg, x)
                        h.sum().backward()
                r["block_coll"] = collective_bytes(block)
                r["block_hand"] = 4 * (B // 2) * Sq * cfg.d_model * 4
            del state, idx, base
            torch.cuda.empty_cache()
            # the full-finetune step with fsdp=True
            pspecs = shd.param_specs(params, cfg, mesh)
            local = shd.shard_tree(params, pspecs, mesh)
            step = S.make_train_step(cfg, tcfg, mesh, pspecs)
            state = dist_state(torch, local)
            r["full"], walls = [], []
            for b in batches[:DIST4_FSDP_STEPS]:
                rows = dist_rows(torch, b, mesh)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with M.record() as ev:
                    state, m = step(state, rows)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                r["full"].append(dist_metrics(m))
            r["full_coll"] = collective_summary(ev)
            r["full_wall_ms"] = walls[-1] * 1e3
            del state, local
            torch.cuda.empty_cache()
        # decode on local heads, bf16
        serve = S.serve_param_shardings(cfg, mesh)
        local = shd.shard_tree(params, serve, mesh)
        if arch == DIST_MOE:
            r["ep_diff"] = dist_ep_combine(torch, cfg, params, local, mesh)
        del params, pack
        torch.cuda.empty_cache()
        prompt = dist_prompt(torch, cfg)
        per = prompt.shape[0] // 2
        rows = slice(mesh.coord("data") * per, (mesh.coord("data") + 1) * per)
        with torch.no_grad(), dist_serve_precision(torch, arch):
            toks, logits = dist_serve(torch, cfg, local, mesh, prompt[rows],
                                      ref_tokens[arch][rows])
        r["tokens"], r["logits"] = toks.cpu(), logits.cpu()
        if arch == DIST_MOE:
            from repro_torch.models import moe
            with torch.no_grad(), moe.record_routes() as calls:
                _, logits = dist_serve(
                    torch, cfg, local, mesh, prompt[rows, :DIST_MOE_PROMPT],
                    ref_tokens["bf16"][rows])
            r["bf16_logits"] = logits.cpu()
            r["bf16_routes"] = [c["top_i"].cpu() for c in calls]
        del local
        torch.cuda.empty_cache()
    res["counts"] = read_counts()
    zero_counts()      # the sequence-sharded path's launches, on their own
    for case in SEQ_CASES:
        res[("seq",) + case[:2]] = dist_seq_rank(torch, case, seq_refs)
    res["seq_counts"] = read_counts()
    # the last five families' TP forward, each family's counts on their own
    res["a11"] = a11_rank(torch, mesh)
    allres = [None] * world
    dist.all_gather_object(allres, res)
    if rank == 0:
        torch.save(allres, out)
    dist.barrier()
    dist.destroy_process_group()


def dist_four(torch, tmp, refs, seq_refs, a11):
    """(b) Spawn four ranks on cuda:0 through gloo; hold their losses and
    decode logits against the single-rank runs, print their collective
    bytes and the gloo step's wall against its device time; then the
    sequence-sharded cases (``dist_seq_report``) and the last five
    families against ``a11`` (``a11_report``)."""
    import torch.multiprocessing as mp
    out = f"{tmp}/four.pt"
    t0 = time.perf_counter()
    ref_tokens = {a: r["tokens"] for a, r in refs.items()}
    ref_tokens["bf16"] = refs[DIST_MOE]["bf16"]["tokens"]
    mp.spawn(dist_rank, args=(4, tmp, out, ref_tokens, seq_refs), nprocs=4)
    ranks = torch.load(out, weights_only=False)
    print(f"[distributed] (b) 4 ranks on cuda:0 through gloo, a (2, 2) mesh, "
          f"{DIST4_LAYERS} layers at full width: "
          f"{time.perf_counter() - t0:.1f} s (spawn included); gloo "
          f"all_reduce, all_gather and "
          f"reduce_scatter each probed on CUDA tensors; the fsdp step "
          f"{DIST4_FSDP_STEPS} of {DIST4_STEPS} steps (DIST4_FSDP_STEPS: cut "
          f"for the script's time limit)", flush=True)
    counts, seq_counts = {}, {}
    for r in ranks:
        for total, key in ((counts, "counts"), (seq_counts, "seq_counts")):
            for k, v in r[key].items():
                total[k] = total.get(k, 0) + v
    check_run("distributed (b)", counts, DIST_PATH, {})
    check_run("distributed (b) sequence-sharded", seq_counts, DIST_SEQ_PATH,
              counts)
    from repro_torch.configs import get_config
    for arch in (DIST_ARCH, DIST_MOE):
        ref = refs[arch]
        r0 = ranks[0][arch]
        print(f"[distributed] (b) {arch}: embedding specs {r0['specs']} "
              f"(the padded vocabulary, {get_config(arch).padded_vocab} "
              f"rows, divides the model axis, so the vocab-parallel form "
              f"is taken, not the d-sharded fallback)", flush=True)
        for mode in ("shira", "full"):
            got = r0[mode]
            d = max(abs(g["loss"] - w["loss"]) for g, w in zip(got,
                                                               ref[mode]))
            gn = max(abs(g["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
                     for g, w in zip(got, ref[mode]))
            tag = "full (fsdp)" if mode == "full" else mode
            print(f"[distributed] (b) {arch} {tag}: "
                  f"loss {[round(g['loss'], 6) for g in got]} against one "
                  f"rank's {[round(w['loss'], 6) for w in ref[mode]]}: max "
                  f"diff {d:.3g} (tol {DIST4_TOL}); aux "
                  f"{[round(g['aux'], 6) for g in got]}; grad norm "
                  f"rel diff {gn:.3g}; step wall {r0[mode + '_wall_ms']:.1f} "
                  f"ms on rank 0", flush=True)
            if not d <= DIST4_TOL:
                fail(f"distributed (b): {arch} {mode} departs from one rank")
            for i, rr in enumerate(ranks):
                c = rr[arch][mode + "_coll"]
                print(f"[distributed] (b)   rank {i} {tuple(rr['coords'])}: "
                      f"{mode} step collectives {c['total_bytes'] / 1e6:.2f} "
                      f"MB ({c['by_kind_count']})", flush=True)
        print(f"[distributed] (b) {arch} SHiRA step on rank 0: wall "
              f"{r0['shira_wall_ms']:.1f} ms, device "
              f"{r0['shira_device_ms']:.1f} ms (gloo stages each collective "
              f"through the host)", flush=True)
        if arch == DIST_ARCH:
            for i, rr in enumerate(ranks):
                c = rr[arch]["block_coll"]
                print(f"[distributed] (b)   rank {i}: one TP block forward "
                      f"+ backward {c['total_bytes']} bytes "
                      f"({c['by_kind_count']}), by hand "
                      f"{rr[arch]['block_hand']} (4 all-reduces of "
                      f"B/2 x S x d f32 over 2 ranks)", flush=True)
                if c["total_bytes"] != rr[arch]["block_hand"]:
                    fail("distributed (b): a TP block's collective bytes "
                         "differ from the count by hand")
        # decode logits: data rank 0 holds rows [0, B/2), data rank 1 the rest
        rows = {}
        for rr in ranks:
            rows[rr["coords"][0]] = rr[arch]
        V = get_config(arch).vocab_size      # the pad columns are -1e30
        logits = torch.cat([rows[0]["logits"], rows[1]["logits"]])[..., :V]
        want = ref["logits"][..., :V]
        scale = float(want.abs().max())
        ld = float((logits - want).abs().max())
        same = float((logits.argmax(-1) == want.argmax(-1)).float().mean())
        tol = DIST4_TOL if arch == DIST_MOE else ATTN_TOL["bf16"]
        print(f"[distributed] (b) {arch} "
              f"{'f32' if arch == DIST_MOE else 'bf16'} prefill + "
              f"{DIST_DECODE} decode steps on local heads, fed one rank's "
              f"greedy tokens: logits max diff {ld:.3g} (tol {tol} x max(1, "
              f"max |logit| {scale:.3g})), argmax equal {same:.1%}",
              flush=True)
        if not ld <= tol * max(1.0, scale):
            fail(f"distributed (b): {arch}'s decode logits on local heads "
                 "depart from one rank's")
        if arch == DIST_MOE:
            dist_moe_bf16(torch, ranks, ref["bf16"], get_config(arch))
    dist_seq_report(torch, ranks, seq_refs)
    A11_LAUNCHES.update(a11_report(torch, ranks, a11, counts))
    return counts


def dist_seq_report(torch, ranks, seq_refs):
    """(b) The sequence-sharded cases: on every rank the f32 greedy tokens
    equal one rank's unsharded run's and the logits lie within DIST4_TOL
    of it, absolute; the bf16 logits, fed one rank's bf16 greedy tokens,
    within ATTN_TOL["bf16"] x max(1, max |logit|), as the head-sharded
    serve holds them (bf16 rounds relative to the logits' size); each
    rank's collective bytes for one decode step, and rank 0's decode wall
    beside its device time."""
    from repro_torch.configs import get_config
    for arch, shape, batch, rows, prompts in SEQ_CASES:
        V = get_config(arch).vocab_size      # the pad columns are -1e30
        got = [rr[("seq", arch, shape)] for rr in ranks]
        want_rows = rows // (shape[0] * shape[1])  # over all four ranks
        if any(g[P]["cache_rows"] != want_rows for g in got for P in prompts):
            fail(f"distributed (b): {arch}'s caches on {shape} do not hold "
                 f"{want_rows} rows a rank")
        print(f"[distributed] (b) {arch} sequence-sharded on {shape}, "
              f"{SEQ_LAYERS} layers at full width, batch {batch}, a cache "
              f"of {rows} rows: {got[0][prompts[0]]['cache_rows']} a rank, "
              f"the sequence over {got[0]['axes']}", flush=True)
        for P in prompts:
            ref = seq_refs[(arch, P)]
            want, want16 = ref["logits"][..., :V], ref["bf16_logits"][..., :V]
            scale = float(want.abs().max())
            same = all(torch.equal(g[P]["tokens"].cpu(), ref["tokens"])
                       for g in got)
            ld = max(float((g[P]["logits"][..., :V] - want).abs().max())
                     for g in got)
            ld16 = max(float((g[P]["bf16_logits"][..., :V] - want16)
                             .abs().max()) for g in got)
            print(f"[distributed] (b) {arch} prompt {P} + {SEQ_DECODE} "
                  f"decode steps: f32 greedy tokens equal one rank's on "
                  f"every rank {same}, logits max diff {ld:.3g} (tol "
                  f"{DIST4_TOL}, max |logit| {scale:.3g}); bf16 fed one "
                  f"rank's tokens: logits max diff {ld16:.3g} (tol "
                  f"{ATTN_TOL['bf16']} x max(1, "
                  f"{float(want16.abs().max()):.3g})); one decode step on "
                  f"rank 0: wall {got[0][P]['wall_ms']:.2f} ms, device "
                  f"{got[0][P]['device_ms']:.3f} ms", flush=True)
            for i, g in enumerate(got):
                c = g[P]["coll"]
                print(f"[distributed] (b)   rank {i} {tuple(g['coords'])}: "
                      f"one bf16 decode step's collectives "
                      f"{c['total_bytes']} bytes ({c['by_kind_count']})",
                      flush=True)
            if not same:
                fail(f"distributed (b): {arch}'s sequence-sharded greedy "
                     f"tokens (prompt {P}) differ from one rank's")
            if not ld <= DIST4_TOL:
                fail(f"distributed (b): {arch}'s sequence-sharded f32 logits "
                     f"(prompt {P}) depart from one rank's")
            if not ld16 <= ATTN_TOL["bf16"] * max(
                    1.0, float(want16.abs().max())):
                fail(f"distributed (b): {arch}'s sequence-sharded bf16 "
                     f"logits (prompt {P}) depart from one rank's")


def dist_moe_bf16(torch, ranks, ref, cfg):
    """(b) The MoE model's bf16 serving on the mesh: the expert-parallel
    combine against the dense dispatch on each rank; then, fed one rank's
    bf16 greedy tokens, every token whose expert set differs from one
    rank's, each primary flip's margin against bf16's rounding of its
    router product, and the logits at every step that no flipped route
    can reach held within 2e of one rank's, e one rank's own bf16 error
    (its largest distance from the f32 model's logits at the steps that
    no route the two choose differently reaches): two bf16 runs that each
    lie within e of the f32 model lie within 2e of each other."""
    B, L, k = DIST_BATCH[0], DIST4_LAYERS, cfg.moe.top_k
    ep = [rr[DIST_MOE]["ep_diff"] for rr in ranks]
    print(f"[distributed] (b) {DIST_MOE} bf16 moe_ffn, expert-parallel over "
          f"2 ({cfg.moe.num_experts // 2} experts a rank) against the dense "
          f"dispatch on each rank's 256 tokens: max diff per rank "
          f"{[f'{e:.3g}' for e in ep]} (tol {DIST_EP_TOL})", flush=True)
    if not max(ep) <= DIST_EP_TOL:
        fail("distributed (b): the bf16 expert-parallel combine departs from "
             "the dense dispatch")
    data = {}
    for rr in ranks:                 # model rank 0 of each data rank
        if rr["coords"][1] == 0:
            data[rr["coords"][0]] = rr[DIST_MOE]
    mesh = [data[d]["bf16_routes"] for d in sorted(data)]
    if any(len(m) != len(ref["routes"]) for m in mesh):
        fail("distributed (b): the mesh made another number of moe_ffn "
             "calls than one rank")
    flips, gaps = route_witness(torch, ref["routes"], mesh, B, L, k)
    prim = [f for f in flips if f["primary"]]
    worst = max(prim, key=lambda f: f["gap"] / f["bound"], default=None)
    top = max((f["gap"] for f in prim), default=0.0)
    below = float((gaps <= top).float().mean())
    print(f"[distributed] (b) {DIST_MOE} bf16 routes on the mesh against one "
          f"rank: {len(flips)} of {gaps.numel()} token-layer routes differ "
          f"({len(prim)} primary, {len(flips) - len(prim)} downstream of an "
          f"earlier layer's flip); primary flips' one-rank margin max "
          f"{top:.4g}, max margin / bf16 rounding bound "
          f"{(worst['gap'] / worst['bound']) if worst else 0.0:.3g}; "
          f"median k-th minus (k+1)-th logit over every token "
          f"{float(gaps.median()):.4g}, {below:.2%} of tokens at or below "
          f"the largest flipped margin", flush=True)
    for f in flips[:12]:
        print(f"[distributed] (b)   flip row {f['row']} layer {f['layer']} "
              f"pos {f['pos']}: margin {f['gap']:.4g}, bound "
              f"{f['bound']:.4g}{'' if f['primary'] else ' (downstream)'}",
              flush=True)
    if worst is not None and worst["gap"] > worst["bound"]:
        fail("distributed (b): a route flipped on the mesh where one rank's "
             "margin exceeds bf16's rounding of the router product")
    P = DIST_MOE_PROMPT
    positions = [P - 1] + [P + i for i in range(DIST_DECODE)]
    clean = torch.tensor(clean_steps(flips, B, L, positions))
    V = cfg.vocab_size
    got = torch.cat([data[d]["bf16_logits"] for d in sorted(data)])[..., :V]
    want = ref["logits"][..., :V]
    scale = float(want.abs().max())
    diff = (got - want).abs().amax(-1)                 # (B, steps)
    f32 = ref["f32_logits"][..., :V]
    f32_flips, _ = route_witness(torch, ref["routes"], [ref["f32_routes"]],
                                 B, L, k)
    alike = torch.tensor(clean_steps(f32_flips, B, L, positions))
    pick = lambda t, m: float(t[m].max()) if bool(m.any()) else 0.0
    held = pick(diff, clean)
    e_one = pick((want - f32).abs().amax(-1), alike)
    e_mesh = pick((got - f32).abs().amax(-1), alike & clean)
    same = float((got.argmax(-1) == want.argmax(-1))[clean].float().mean()) \
        if bool(clean.any()) else 1.0
    print(f"[distributed] (b) {DIST_MOE} bf16 against f32 on one rank: "
          f"{len(f32_flips)} of {gaps.numel()} routes differ; at the "
          f"{int(alike.sum())} row-steps none reaches, one rank's bf16 "
          f"error e = {e_one:.3g}, the mesh's {e_mesh:.3g} (at "
          f"{int((alike & clean).sum())} also out of the mesh's flips' "
          f"reach)", flush=True)
    print(f"[distributed] (b) {DIST_MOE} bf16 prefill ({DIST_MOE_PROMPT} "
          f"tokens, DIST_MOE_PROMPT) + {DIST_DECODE} decode steps: "
          f"{int(clean.sum())} of {clean.numel()} row-steps no flipped route "
          f"reaches: logits max diff {held:.3g} against one rank's (tol 2e "
          f"= {2 * e_one:.3g}; {ATTN_TOL['bf16']} x max |logit| "
          f"{scale:.3g} would be {ATTN_TOL['bf16'] * max(1.0, scale):.3g})"
          f", argmax equal "
          f"{same:.1%}; over every row-step max diff {float(diff.max()):.3g}"
          f", argmax equal "
          f"{float((got.argmax(-1) == want.argmax(-1)).float().mean()):.1%}",
          flush=True)
    if not held <= 2 * e_one:
        fail(f"distributed (b): {DIST_MOE}'s bf16 logits depart from one "
             "rank's where no route flipped")


def dist_dryrun_start():
    """(c) The dry run's cells, one CPU process a group of them (the
    machine's 8 cores are free once (b) is done; 8 processes, so that none
    waits for a core): (process, out path) a group. Each of DIST_CELLS'
    archs with each adapter on both meshes, DIST_SEQ_CELLS, and each line
    of DIST_A11_CELLS."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    groups = [(arch, ",".join(DIST_CELLS[1]), "both", adapter)
              for arch in DIST_CELLS[0] for adapter in ("none", "shira")]
    groups.append((DIST_SEQ_CELLS[0], ",".join(DIST_SEQ_CELLS[1]), "single",
                   "none"))
    groups += [(archs, shape, "single", "none")
               for archs, shape in DIST_A11_CELLS]
    outs = []
    for i, (archs, shapes, mesh, adapter) in enumerate(groups):
        path = ROOT / "build" / "dryrun" / f"chip_cells_{i}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        if path.exists():
            path.unlink()
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               archs, "--shape", shapes, "--mesh", mesh, "--adapter",
               adapter, "--out", str(path)]
        outs.append((subprocess.Popen(
            cmd, env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), path))
    return outs


def dist_dryrun_report(procs):
    for proc, path in procs:
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            fail(f"distributed (c): launch.dryrun failed:\n{log[-2000:]}")
        for r in json.loads(path.read_text()):
            if not r.get("ok") or r["cost"] is None:
                fail(f"distributed (c): cell {r['arch']} {r['shape']} "
                     f"{r['mesh']} {r.get('error') or r.get('reason')}")
            print(f"[distributed] (c) dryrun {r['arch']} {r['shape']} mesh "
                  f"{tuple(r['mesh'])} --adapter {r['adapter']}: "
                  f"{r['memory']['per_rank_gb']:.3f} GB a rank (params "
                  f"{r['memory']['params_bytes'] / 1e9:.3f}), "
                  f"{r['cost']['flops'] / 1e12:.3f} TFLOP, "
                  f"{r['cost']['bytes_accessed'] / 1e9:.3f} GB accessed, "
                  f"collectives "
                  f"{r['collectives']['total_gb']:.2f} GB (pod axis "
                  f"{r['collectives']['pod_axis_bytes'] / 1e9:.2f}), meta run "
                  f"{r['compile_s']} s", flush=True)


def distributed_phase(torch):
    """34. The launch modules on torch.distributed: (a) world size 1
    through NCCL, (b) four ranks on cuda:0 through gloo, (c) the dry run's
    cells. Returns the launch counts of (a)'s and (b)'s sharded paths."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        counts = dict(dist_world1(torch, tmp))
        refs = dist_refs(torch)
        seq_refs = dist_seq_refs(torch)
        a11 = a11_refs(torch)
        torch.cuda.empty_cache()
        print(f"[distributed] (a) and the one-rank references: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for k, v in dist_four(torch, tmp, refs, seq_refs, a11).items():
            counts[k] = counts.get(k, 0) + v
    t0 = time.perf_counter()
    procs = dist_dryrun_start()
    try:
        dist_dryrun_report(procs)
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"[distributed] (c) {len(procs)} processes: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return counts


def main() -> None:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs on an NVIDIA card")
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        fail(f"the repro_torch package is not beside this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line = card_line()
    print(f"[device] {line}", flush=True)

    def build_all():
        build.build()
        print(f"[build] {len(build.KERNELS)} kernel libraries", flush=True)
        for name in build.KERNELS:
            for fn, ln in ptxas_lines(build.ptxas(name)):
                print(f"[build] {name}: {fn}: {ln}")
    timed("build", build_all)

    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scratch.fill_(1)
    side, scat = timed("kernels (serving)", kernels_phase, torch, flush)
    torch.cuda.empty_cache()
    blocks, rows, grads = timed("kernels (training)", train_kernels_phase,
                                torch, flush)
    torch.cuda.empty_cache()
    attn = timed("kernels (attention)", attention_kernels_phase, torch, flush)
    torch.cuda.empty_cache()
    masked = timed("kernels (masked_update)", masked_update_kernels, torch,
                   flush)
    timed("kernels (mamba widths)", mamba_kernels, torch, flush)
    torch.cuda.empty_cache()
    timed("kernels (zamba widths)", zamba_kernels, torch, flush)
    del scratch
    torch.cuda.empty_cache()
    from repro_torch.analysis import autotune
    autotune.clear_observed()
    with autotune.observe():        # the classes sidedelta plans, for the
        launches = timed("serve", serve_phase, torch)   # analysis phase
    torch.cuda.empty_cache()
    analysis = {}
    timed("profile", lambda: profile_phase(torch, analysis=analysis))
    torch.cuda.empty_cache()
    timed("consistency", consistency_phase, torch)
    torch.cuda.empty_cache()
    print(f"[continuous] starcoder2-7b: serve --continuous and the "
          f"24-request trace at {CC_LAYERS} of 32 layers (cut for the "
          f"script's time limit: 16 since the vision and audio slice, 12 "
          f"since the distributed slice, {CC_LAYERS} since the sequence-"
          f"sharded slice; all 32 before): KV "
          f"and resident requests per GB below are of "
          f"{CC_LAYERS} layers", flush=True)
    with autotune.observe():
        for k, v in timed("continuous", lambda: continuous_phase(
                torch, layers=CC_LAYERS)).items():
            launches[k] = launches.get(k, 0) + v
    observed = autotune.observed_shapes()
    torch.cuda.empty_cache()
    timed("continuous-consistency", continuous_consistency_phase, torch)
    torch.cuda.empty_cache()
    print(f"[train] starcoder2-7b: launch.train and MultiAdapterTrainer at "
          f"{TRAIN_LAYERS} of 32 layers (TRAIN_LAYERS: cut for the script's "
          f"time limit: 16 since the analysis slice, {TRAIN_LAYERS} since "
          f"the sequence-sharded slice; all 32 before)", flush=True)
    totals, c_shira = timed("train", lambda: train_phase(
        torch, layers=TRAIN_LAYERS))
    for k, v in totals.items():
        launches[k] = launches.get(k, 0) + v
    torch.cuda.empty_cache()
    timed("train-consistency", train_consistency_phase, torch)
    torch.cuda.empty_cache()
    for k, v in timed("train (wm, hook)", train_masks_phase, torch).items():
        launches[k] = launches.get(k, 0) + v
    torch.cuda.empty_cache()
    timed("hook-consistency", hook_consistency_phase, torch)
    torch.cuda.empty_cache()
    for k, v in timed("personalization", personalization_phase,
                      torch).items():
        launches[k] = launches.get(k, 0) + v
    torch.cuda.empty_cache()
    timed("personalization-consistency", pz_consistency_phase, torch)
    torch.cuda.empty_cache()
    timed("analysis", analysis_phase, torch, analysis, observed)
    PZ_TRACES.clear()
    torch.cuda.empty_cache()
    for k, v in timed("slo-chaos", slo_chaos_phase, torch).items():
        launches[k] = launches.get(k, 0) + v
    torch.cuda.empty_cache()
    timed("faults-consistency", faults_consistency_phase, torch)
    torch.cuda.empty_cache()
    for label, phase, args in (
            ("train (kinds)", train_kinds_phase, (torch, c_shira)),
            ("switch (LoRA vs SHiRA)", switch_lora_phase, (torch,)),
            ("train (checkpoint, preemption)", checkpoint_phase, (torch,))):
        for k, v in timed(label, phase, *args).items():
            launches[k] = launches.get(k, 0) + v
        torch.cuda.empty_cache()
    timed("kinds-consistency", kinds_consistency_phase, torch)
    torch.cuda.empty_cache()
    by_slice = {}
    for tag, phase in (("moe", moe_phases), ("mla", mla_phases),
                       ("mamba", mamba_phases), ("zamba", zamba_phases),
                       ("vlm", vlm_phases), ("audio", audio_phases),
                       ("dense", dense_configs_phase)):
        totals = by_slice[tag] = phase(torch)
        if tag in ("mamba", "zamba", "vlm", "audio"):
            print(f"[{tag}] launches over the {tag} phases: "
                  f"{ {k: v for k, v in totals.items() if v} }", flush=True)
        for k, v in totals.items():
            launches[k] = launches.get(k, 0) + v
        torch.cuda.empty_cache()
    for k, v in timed("distributed", distributed_phase, torch).items():
        launches[k] = launches.get(k, 0) + v
    torch.cuda.empty_cache()

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    main_side = side[0]     # w_up, S=1, f32 tables: the multi-tenant decode
    side_err = max([r["max_abs_err"] for r in side]
                   + [g[e]["max_abs_err"] for g in grads.values()
                      for e in ("forward", "dx")])
    dvals = grads["w_up"]["dvals"]
    kernels = [
        {"name": "sidedelta", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sidedelta.cu",
         "replaces": "src/repro/kernels/sidedelta.py:282",
         "launches": launches["sidedelta"], "max_abs_err": side_err,
         **{k: main_side[k] for k in keys}},
        {"name": "sidedelta_dvals", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sidedelta_grad.cu",
         "replaces": "src/repro/kernels/sidedelta.py:245",
         "launches": launches["sidedelta_dvals"],
         "max_abs_err": max(g["dvals"]["max_abs_err"]
                            for g in grads.values()),
         **{k: dvals[k] for k in keys}},
        {"name": "scatter_apply", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/scatter_apply.cu",
         "replaces": "src/repro/kernels/scatter_apply.py:49",
         "launches": launches["scatter_apply"], **scat},
        {"name": "sparse_adamw_blocks", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sparse_adamw.cu",
         "replaces": "src/repro/kernels/sparse_adamw.py:38",
         "launches": launches["sparse_adamw_blocks"], **blocks},
        {"name": "sparse_adamw_rows", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sparse_adamw.cu",
         "replaces": "src/repro/kernels/sparse_adamw.py:99",
         "launches": launches["sparse_adamw_rows"],
         **rows["f32"],
         "max_abs_err": max(r["max_abs_err"] for r in rows.values())},
    ]
    # each attention kernel's row: its bf16 case at the main path's shape
    # (the first case of each list), its largest error over every case
    for name, src, rep in (
            ("flash_decode", "flash_decode.cu", "flash_decode.py:71"),
            ("flash_decode_paged", "flash_decode.cu", "flash_decode.py:141"),
            ("flash_prefill", "flash_prefill.cu", "flash_prefill.py:74")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{rep}",
            "launches": launches.get(name, 0),
            **{k: attn[name][0][k] for k in keys},
            "max_abs_err": max(r["max_abs_err"] for r in attn[name])})
    # the D = 80 instances (zamba2's shared block): its bf16 decode and
    # prefill at the lanes' shapes, the largest error over their cases,
    # the launches of the zamba phases (which attend at D = 80 only)
    for name, src, rep in (
            ("flash_decode", "flash_decode.cu", "flash_decode.py:71"),
            ("flash_prefill", "flash_prefill.cu", "flash_prefill.py:74")):
        d80 = attn["d80"][name]
        kernels.append({
            "name": f"{name} (D = 80)", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{rep}",
            "launches": by_slice["zamba"].get(name, 0),
            **{k: d80[0][k] for k in keys},
            "max_abs_err": max(r["max_abs_err"] for r in d80)})
    # the D = 256 decode instance (paligemma-3b) and the non-causal D = 80
    # prefill (hubert-xlarge's encode): the bf16 case at each path's shape,
    # the largest error over their cases, the launches of the phases that
    # take them (the vision phases decode at D = 256 only, the audio
    # phases prefill non-causally at D = 80 only)
    for name, src, rep, cases, tag in (
            ("flash_decode (D = 256)", "flash_decode.cu",
             "flash_decode.py:71", attn["d256"], "vlm"),
            ("flash_prefill (D = 80, non-causal)", "flash_prefill.cu",
             "flash_prefill.py:74", attn["bidir"], "audio")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{rep}",
            "launches": by_slice[tag].get(name.split(" ")[0], 0),
            **{k: cases[0][k] for k in keys},
            "max_abs_err": max(r["max_abs_err"] for r in cases)})
    # flash_decode's log-sum-exp instance (sequence-sharded serving): at
    # D = 64 and 128 its bf16 case at one rank's shard of starcoder2-7b's
    # decode_32k, the largest error over those cases, its launches on the
    # GQA text models' mesh decode steps; at D = 256 (paligemma-3b's cache
    # over ``model``) and D = 80 (zamba2-2.7b's shared block at batch 1)
    # the same from their cases and the launches of those families' mesh
    # steps
    a11_lse = {arch: A11_LAUNCHES.get(arch, {}).get("flash_decode (lse)", 0)
               for arch in ("paligemma-3b", "zamba2-2.7b")}
    for name, dims, n in (
            ("flash_decode (log-sum-exp)", (64, 128),
             launches.get("flash_decode (lse)", 0) - sum(a11_lse.values())),
            ("flash_decode (log-sum-exp, D = 256)", (256,),
             a11_lse["paligemma-3b"]),
            ("flash_decode (log-sum-exp, D = 80)", (80,),
             a11_lse["zamba2-2.7b"])):
        cases = [r for r in attn["lse"] if r["D"] in dims]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode.py:71",
            "launches": n, **{k: cases[0][k] for k in keys},
            "max_abs_err": max(r["max_abs_err"] for r in cases)})
    # masked_update's row: the hook path's case (f32 W, bool M)
    kernels.append({
        "name": "masked_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/masked_update.cu",
        "replaces": "src/repro/kernels/masked_update.py:23",
        "launches": launches.get("masked_update", 0),
        **{k: masked["f32 W, bool M"][k] for k in keys},
        "max_abs_err": max(r["max_abs_err"] for r in masked.values())})
    print(f"[time] total {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
