#!/usr/bin/env python3
"""Drive the PyTorch port (``ldmseg_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each:
  0. device: name, count and ``nvidia-smi`` name/power limit;
  1. build every CUDA kernel under ``ldmseg_torch/csrc/`` (one nvcc each,
     all at once);
  2. K1 (self-attention forward) against its plain PyTorch version at the
     sampling path's shapes and the trained gate's (bf16 and fp32), with
     times (CUDA events, and the kernel's device time per launch from
     ``torch.profiler``), the bound and the library yardstick (SDPA,
     event-timed and its device time);
  3. the full-width SD-1.4 UNet forward on K1 against the same module on the
     plain attention;
  4. ``TrainerDiffusion.sample_panoptic`` end to end at full width
     (``SAMPLE_STEPS``, 20 DDIM steps, the default's 50 cut for the time
     limit, as every sampling phase's below; batch 2 of 256x512 frames) and ``panoptic_post_process``, with
     K1's and K2's launch counts over that run; like every sampling phase
     below (9, 12, 13, 16, 18, 21, 23, 26, 28, 31, 33, 34, 35, 43, 44, 46,
     47) its steps
     replay a CUDA graph (``ddim_sample``'s default on the card; the
     counters count the replays); here the eager loop too, at the same
     noise: x0 bit-equal, the same launches, and one call of each profiled
     (wall, kernel time, host time, busy share);
  5. K2 (self-attention backward) against its plain PyTorch version at the
     training path's shapes and the trained gate's, two calls bit-equal, with times (CUDA events,
     and the device time of each of its two kernels from
     ``torch.profiler``), TFLOP/s, the bound and the library yardstick
     (SDPA's backward, event-timed and its device time);
  6. ``TrainerDiffusion.train_loop`` at full width (bf16 on fp32 masters,
     self-conditioning, AdamW, batch 8 of 192x640 ``SyntheticDVPS`` frames):
     2 warm-up steps, 5 timed steps with K1's and K2's launch counts, the
     update checks, and one step's loss and gradients on K1/K2 against the
     same step on the plain attention;
  7. K3 (the int8 LN + attention block) and K4 (the int8 LN + GEGLU block,
     dynamic and static interior scale) against their plain PyTorch
     versions at the int8 sampling path's shapes, a ragged T and the
     trained gate's 2-head sites, each call launching its kernel, with
     times (CUDA events, and the device time of each stage from
     ``torch.profiler``), the bound and the bf16 block each replaces; two
     calls of each bit-equal; their Hopper product (``ops/gemm.py``) at
     every product shape of K3 and K4, in the form each launches (K4's W1
     with two operands), against ``torch._int_mm`` on W's transposed view
     (int32, bit for bit) and ``torch.matmul`` (bf16, within
     ``BF16_ATOL`` of max|ref|), with both times;
  8. the full-width int8 UNet forward (the weights of phase 3) against the
     bf16 one on K1: 16 K3, 16 K4, 0 K1 launches, no fallback, the
     relative error and correlation, ms per forward and the s8 convs' share;
  9. ``sample_panoptic`` with ``int8_inference`` as in phase 4: twice with
     the default scales (dynamic interior), then ``calibrate_int8`` and
     twice with the calibrated scales (static interior); 320 K3 and 320 K4,
     0 K1 and no fallback per call; each mode's graph held bit for bit to
     the eager loop (and profiled), the calibrated x0 different from the
     default one (no stale graph);
  10. K13 (the int8 attention without fused norms) and K12 (the int8 GEGLU
     feed-forward without LN and residual, dynamic and static interior
     scale) against their plain PyTorch versions at the unfused int8 path's
     shapes and a ragged T, with times, the bound and the bf16 function
     each replaces (K1 and SDPA for K13, the bf16 GEGLU FF for K12), and
     K13's device time by stage (quantize, attention; ``torch.profiler``);
  11. the full-width int8 UNet without fused norms (``fused_norms: False``,
     the weights of phase 3) against the bf16 one: 16 K13, 16 K12, 0 K1,
     K3 and K4 launches, no fallback, correlation, ms per forward;
  12. ``sample_panoptic`` with ``fused_norms: False``, variant (a) (K13 +
     K12) and (b) (``fused_ff: False``: K13 + s8 linears), each with the
     default scales and after ``calibrate_int8``: 320 K13 per call, 320 K12
     in (a) and 0 in (b), 0 K1/K3/K4, no fallback;
  13. one call of (c) (``fused_ff: False`` with fused norms: K3 + s8
     linears): 320 K3, 0 K4, K12 and K13;
  14. the GroupNorm + SiLU family on the UNet built with
     ``UNetConfig(use_pallas_gn=True, int8_fuse_gn=True)`` (its resnet norm
     scales and shifts and conv biases drawn too): the input of each of the
     44 resnet halves of one bf16 forward captured by hooks, and K5 (bf16
     and fp32; bf16 also at the training shapes), K6 and K7 (with the
     half's own conv; 43 launches, 1 fallback by the 6 MiB rule) against
     their plain versions there, with times (CUDA events; the device time,
     the kernels a call and their split from ``torch.profiler``; the host
     time a call, ``tools/profile_gn.py:measure``: one kernel a K5 call,
     two a K6 call, two or three a K7 call as its plan says), the bound
     and the bf16 PyTorch composition each replaces, per forward and per
     shape class; K7 also bit-equal from call to call and per level (32x64
     to 4x8) with its weight pack's time apart from the call and
     ``F.conv2d``'s device time on the same y (cuDNN, the conv part's
     yardstick), at the deep levels its share of 3.35 TB/s; then K7 at the
     two shapes its repair added (Cin 36 in 4 groups; 320 channels at
     64x64 in one group), against its plain version, bit-equal repeats;
  15. that UNet's forward on K5 against the plain GN: 44 K5 launches;
  16. ``sample_panoptic`` on it as phase 4: 880 K5 and 320 K1 per call;
  17. ``train_loop`` on it (2 warm-up, 3 timed steps): 88 K5, 32 K1, 16 K2
     per step; one step's loss and gradients against the plain GN, a
     gradient on every resnet norm;
  18. its int8 UNet (``int8_fuse_gn``: K6 feeding the s8 convs) against the
     bf16 one (44 K6, 16 K3, 16 K4 per forward), and int8
     ``sample_panoptic`` with default and calibrated scales: 880 K6, 320
     K3, 320 K4, 0 K5, no fallback per call;
  19. the padded-attention flags on the int8 trainer built with
     ``UNetConfig(use_fused_projs=True)`` (the Transformer2D proj biases and
     the blocks' LayerNorm rows and ``to_out`` biases drawn too): K8 and K9
     with that int8 UNet's packs and K11 with the packs of the K11 UNet
     (variant (a)'s flags with ``use_padded_attention``, filled from the
     same masters) against their plain versions at the four shapes of a
     forward, with times, the bound and the PyTorch composition each
     replaces, K8's, K9's and K11's device time by stage (K8: the
     ``proj_in`` prologue and K3's four; K9: K4's four and ``proj_out``,
     beside ``F.linear`` on its operands; K11: quantize, the Q/K and V
     products, the attention, to_out; a kernel outside the stages fails),
     K8's prologue
     alone against ``torch.matmul`` in fp32 with x channel-major and as
     tokens, and a ragged T = 30 that the rule sends to each fallback;
  20. the int8 UNet with fused projs against the bf16 one: 16 K8, 16 K9,
     0 K1, K3 and K4, no fallback, correlation, ms per forward beside phase
     8's int8 UNet;
  21. ``sample_panoptic`` on it with the default and the calibrated scales:
     320 K8 and 320 K9 per call, every other kernel 0;
  22. F1 at full width: the UNet with variant B's flags
     (``tools/perf/acc_check.py:62-67``) runs 16 K13 and 16 K4, 0 K3;
  23. the K11 UNet against the bf16 one (16 K11, 16 K12, 0 K3 and K13),
     and the port's 20-step ``ddim_sample`` on it: 320 K11 and 320 K12;
  24. ``use_packed_attention``'s kernels and K10: K14 (bf16 and fp32) at
     the four shapes of the sampling forward and the three of the training
     forward, its backward (K2 on the head views) at the training shapes,
     K15 at the sampling shapes and K10 in both ``v_bf16`` variants (an op)
     at the int8 shapes, against their plain versions, with times, the
     bound and the yardstick (SDPA and SDPA's backward for K14; SDPA and
     K13 on the head views for K15; K3, or LN + K11 + the residual, for
     K10), K14's, K2's and SDPA's device times from ``torch.profiler``,
     K15's and K10's (``v_bf16`` False) device time by stage, F2's code
     check (the LN + quantize stage's codes against the plain ones, +-1 at
     no more than ``LN_CODE_FLIPS`` of them and next to a .5; K10 without
     ``v_bf16`` against the plain steps fed those codes), and a ragged T =
     30 that each rule sends to its fallback;
  25. the full-width bf16 UNet built with
     ``UNetConfig(use_packed_attention=True)`` against the same module on
     K1: 16 K14, 0 K1, no fallback;
  26. ``sample_panoptic`` on it as phase 4: 320 K14 per call, 0 K1;
  27. ``train_loop`` on it (2 warm-up, 3 timed steps): 30 K14, 2 fallbacks
     (T = 30) and 15 K2 per step, 0 K1; one step's loss and gradients
     against the plain attention;
  28. int8 ``sample_panoptic`` with ``fused_norms: False`` on it, default
     and calibrated scales: 320 K15 and 320 K12 per call, 0 K1/K3/K4/K13,
     no fallback; its UNet forward (16 K15, 16 K12) against the bf16 one;
  29. ``use_absorbed_attention``'s kernels and K18: K16 (bf16 and fp32) at
     the four shapes of the sampling forward and the three of the training
     forward, its backward (K2 on the head views of the saved q, k, v, the
     gradient products in ``torch.matmul``) at the training shapes, K17
     and K18 (an op) at the sampling shapes, against their plain versions,
     with times, the bound and the yardstick (F.linear x 3 + SDPA +
     F.linear and its backward for K16; the same in bf16 and float
     projections + K13 for K17 and K18), K16's device time (all its
     launches, its attention stage alone and, in bf16, by stage: the Q/K/V
     product, the attention, to_out; a kernel outside the stages fails),
     K2's in its backward and
     SDPA's from ``torch.profiler``, K17's and K18's device time by stage
     (quantize, projection, the code pass, attention, per-head to_out),
     and a ragged T = 30 that the rule sends to each fallback;
  30. the full-width bf16 UNet built with
     ``UNetConfig(use_absorbed_attention=True)`` against the same module
     on K1: 16 K16, 0 K1 and K14, no fallback;
  31. ``sample_panoptic`` on it as phase 4: 320 K16 per call, 0 K1;
  32. ``train_loop`` on it (2 warm-up, 3 timed steps): 30 K16, 2 fallbacks
     (T = 30) and 15 K2 per step, 0 K1 and K14, the peak memory; one
     step's loss and gradients against the plain attention;
  33. int8 ``sample_panoptic`` with ``fused_norms: False`` on it, default
     and calibrated scales: 320 K17 and 320 K12 per call, 0 K1/K3/K4/K13/
     K15, no fallback, K17's input scale 0.1 in both; its UNet forward (16
     K17, 16 K12) against the bf16 one; the absorbed-storage UNet
     (``prepare_int8_unet(..., absorbed_attention=True)``) whose K17s read
     the calibrated ``to_q`` sites, against the bf16 one;
  34. ``TrainerDiffusion.compute_pq`` end to end at full width: a
     KITTI-DVPS val tree of 4 frames at 375x1242 written from seeded numpy,
     read at 256x512 with ``keep_fullres_gt``, the phase-4 trainer at batch
     2 with 20 DDIM steps (320 K1 a call), each prediction restored to
     375x1242 and scored, then one batch of the resize branch; PQ, SQ, RQ,
     s per frame, peak memory, and the card's cleaned maps against the CPU
     path's restore of the same logits (>= 99.9% of the pixels equal);
  35. ``ldmseg_torch.entry.entry()``'s forward against the plain attention,
     and ``ldmseg_torch/tools/bench.py`` at batch 2 (its JSON line on a
     line of its own, the JAX bench's image VAE, the DPM-Solver++(2M)
     frames/s beside the headline, its launches checked);
  36. the run around the UNet at SD-1.4's widths and one resnet a block
     (10 transformer blocks), in a temporary directory:
     ``tools/main_ldm.py`` (the default configuration with ``ema_on``,
     2 steps at batch 8 of 192x640 synthetic frames through the threaded
     loader and the H2D prefetch, the save, ``compute_pq`` at 4 DDIM
     steps with the best-PQ snapshot; 20 K1 and 10 K2 a step), a fresh
     trainer's ``resume`` (masters, AdamW state and EMA bit-equal),
     ``tools/export_checkpoint.py --ema`` (read back equal by
     ``load_reference_ldm``) and ``tools/predict.py`` from the checkpoint
     (2 frames' PNG pairs); the checkpoint's bytes and the save and resume
     seconds;
  37. stage 1 at full width: ``TrainerAE.train_loop`` on the default
     SegVAE (blocks 32-256, 256 interior channels, 128 logits, the KITTI
     preset's 10 bit channels) at batch 8 of 192x640 synthetic frames with
     12,544 points, AdamW, bf16 on fp32 masters: 2 warm-up and 5 timed
     steps (s/step, peak memory, no kernel launched), one step's loss on
     the card against the same step on the CPU (same weights, batch and
     draws; 1e-2 relative), ``compute_miou`` and ``compute_pq`` over 2
     batches;
  38. stage 1 to stage 2: ``tools/main_ae.py`` (synthetic preset, 3 steps
     at batch 8), ``tools/export_checkpoint.py --stage ae``, and
     ``tools/main_ldm.py`` (a narrow UNet) reading that file through
     ``vae_model_kwargs.pretrained_path`` (its seg VAE equal to the
     stage-1 weights) for 2 steps, its launches checked;
  39. phase 6's training with ``gradient_checkpointing``: 1 warm-up and 2
     timed steps with exactly 47 K1 (16 + 16 + the 15 sites of the
     rematerialised down and up blocks again in the backward) and 16 K2
     launches a step, one step's gradients against the same step without
     remat (cosine >= 0.999), both steps' peak memory;
  40. one full-width training step (batch 2) each with Adafactor, dropout
     0.1 (standard and gaussian), ``sample_posterior_rgb``, the int8
     UNet trained through the straight-through path and the JAX bench's
     image VAE encoding the batch (one K1 D=512 a step): finite losses,
     changed parameters;
  41. K1's wide class (head dim 512, the image VAE's mid attention)
     against its plain version at [2, 2048, 1, 512], [16, 2048, 1, 512]
     and [8, 1920, 1, 512], two calls bit-equal, one launch a call on its
     own counter, P one bf16 ulp off at few entries; event and device ms,
     the plain version's, SDPA's (and its backend) and the bound;
  42. the JAX bench's image VAE at full width (int8, ``int8_act_scale``
     0.05, fused attention, prepared from bf16 weights) against the bf16
     encoder at batch 2 of 256x512 (correlation >= 0.99, one K1 D=512
     counted and traced, no other hand-written kernel in the trace), the
     int8 seg-VAE decode against the bf16 one, and an image-VAE round trip
     through the decoder;
  43. ``sample_panoptic`` in the JAX bench's serving configuration
     (``tools/bench.py:bench_config``) at batch 2 with 20 DDIM steps: 320
     K3, 320 K4 and one K1 D=512 a call, the graph bit-equal to the eager
     loop, one traced graph call's kernels against the counters;
  44. the same with 10 DPM-Solver++(2M) steps (``DPM_STEPS``; 160 K3 and
     160 K4);
  45. the native host codec built with g++ at first use, equal to the
     numpy codec on a 375x1242 frame, with both host ms;
  46. ``sample_panoptic_clip`` in the default deployment at full width on
     one static clip of 3 frames of 256x512 with a full-size
     ``PoseExpNet`` attached: DDIM 20 and a 6-step DDIM tail
     (``ddim_refine``), both CUDA graphs: 416 K1 a call counted and
     traced, graph bit-equal to eager (the call, and the first pass alone),
     the warped clip more consistent than the unwarped one; s a call,
     kernel ms, busy share, peak memory;
  47. the same in the JAX bench's serving configuration, DDIM 20 (416 K3
     and 416 K4) and DPM-Solver++(2M) 10 with a 3-step DDIM tail (208
     each), one K1 D=512 a call, graph bit-equal to eager; DDIM's call
     traced and its x0 correlated >= 0.9 with the bf16 UNet's;
  48. clip training at full width (2 clips of 3 frames of 192x640,
     ``temporal_consistency_weight`` 0.1, the pose net attached): 32 K1
     and 16 K2 a step, the consistency term finite and > 0, the parameters
     moved, one step's loss and gradient cosine against the plain
     attention; s/step, peak memory;
  49. ``TrainerPose`` at full size (batch 4 of 3-frame clips of 192x640,
     the explainability decoder): 3 timed steps, finite terms, moved
     parameters, no hand-written kernel;
  50. VPQ on the card: ``vpq_eval_device`` on phase 46's maps and on a
     crowded pair (over 256 segments: ``evaluate_dvpq`` grows
     ``max_seg``) equal to the numpy oracle's counts, iou within 1e-5;
  51. the video CLIs chained: ``main_pose`` -> ``main_ldm video_clips=3``
     with its pose checkpoint -> ``predict clips=3`` -> ``eval_dvpq`` on
     the written PNGs, launches checked;
  52. ``tools/trained_gate.py`` at reduced steps (20 / 30 / 5, one
     validation batch of 8 frames of 96x320): DVPQ(gt, gt) 100 in every
     category the frames hold, every number finite, each stage's launches
     exactly those JAX's shape rules send to kernels at the gate's shapes
     (K1 and K2 in stage-2 training, K1 in bf16 sampling, K3 and K4 in
     int8 sampling, no fallback), stage 2's sampling graph bit-equal to
     its eager loop; the three gates printed, not asserted;
  53. ``tools/loader_bench.py`` at 32 frames of 375x1242 (samples/s and the
     host's cores);
  54. ``tools/profile_training.py --remat-sweep`` and ``tools/bench.py
     --breakdown`` at batch 2, one timed step or call each;
  55. conditioning at full width (SD-1.4, cross_attention_dim 768, 8
     heads; the ``none`` descriptor, a seeded context [2, 77, 768]): bf16
     ``sample_panoptic`` at guidance 7.5 (classifier-free guidance, two
     UNet calls a step: 640 K1 a call), the graph bit-equal to the eager
     loop and one call traced (busy share), s a call and peak memory; at
     guidance 1.0 (320 K1) another x0; another context another x0; a
     3-frame clip with CFG (2,080 K1);
  56. the same in int8 with fused norms (K3 -> attn2 in bf16 -> K4 a
     block: 640 K3 and 640 K4, no fallback), x0 correlated >= 0.9 with
     phase 55's; ``calibrate_int8`` refuses the descriptor (the trait);
  57. training with ``learnable`` queries (77 x 768), ``separate_encoder``
     and ``add_adaptor`` (22 attention sites: 44 K1 and 22 K2 a step),
     batch 8 of 192x640, 3 timed steps (s/step, peak memory), one step's
     loss (1e-2) and gradient cosine (>= 0.99) against the plain attention;
  58. one forward each of ``separate_conv``, the upscaler head (on K1,
     within 2e-2 of the plain attention) and ``Upscaler``: finite, of the
     right shape;
  59. one rank over NCCL: a process started with torchrun's variables
     (world size 1) runs phase 6's stage-2 step (its UNet at one resnet a
     block, as phases 60 and 62: ``_shallow_unet``) with ZeRO-1 without a
     process group and again after ``initialize_from_env``: the loss and
     the masters bit-equal, the K1 and K2 launches equal;
  60. two ranks sharing the card: NCCL's refusal of two ranks on one
     device printed; the one-rank stage-2 and stage-1 steps in this
     process, handed over in a temporary file; two gloo ranks of 4 rows
     each (ZeRO-1, self-conditioning): loss within 1e-3 and the reduced
     gradients' cosine >= 0.999 against the one-rank step, the update's
     cosine >= 0.999 against the one-rank step on the ranks' two
     micro-batches, the ranks' masters bit-equal, each rank's optimizer
     state 45-55% of one rank's; the step timed (s/step, the reduction's
     device ms, peak memory, launches; two ranks on one card are no
     scaling figure); ``compute_pq`` on 4 frames, 2 a rank, equal to one
     process fed the same images; the stage-1 step's loss within 1e-3;
  61. ``entry.dryrun_multichip(4, "cuda")``: stages A-D on four gloo
     ranks, each stage's seconds; B (a ``(2, 2)`` mesh): the TP UNet's
     forward and gradients within 1e-2 of the replicated one's and a
     rank's share of its parameters; C: a TP + ZeRO-1 + SP step, each
     rank's ZeRO-1 state about a quarter of the ranks' sum; K1 and K2
     launched on each rank and no other kernel. It runs first, with
     nothing else on the card; phase 59's process then runs beside phase
     60's one-rank steps (their seconds printed as contended), and phase
     60's ranks run alone;
  62. the model axis at full width (one resnet a block): the one-rank
     step (phase 6's configuration at batch 2 with ZeRO-1, the image VAE
     on K1's wide class) and a 4-step bf16 ``sample_panoptic`` in this
     process, then
     two gloo ranks sharing the card on a ``(data=1, model=2)`` mesh with
     ``tensor_parallel`` and ``spatial_parallel``: loss within 1e-3, the
     gathered gradients' cosine >= 0.9999, the one-rank optimizer fed the
     gathered TP gradients within 1e-3 x lr (plus an ulp of the fp32
     master) of the gathered TP masters (the update's cosine against the
     one-rank step printed), x0 within 2e-2 of max|x0|; each rank's UNet
     bytes (50-55% of one rank's), peak memory, K1, K2 and K1 wide launches, the spatial
     stages run whole (none), seconds;
  63. serving on the model axis at full width: K3, K4, K12 and K13 in
     their partial modes at a rank's shapes of a model axis of 2 (4 of 8
     heads, half the GEGLU columns; dynamic and static scales) against
     their plain versions, and the two ranks' partials summed against the
     one-rank kernel (phase 7's tolerances); then, on phase 62's ranks
     after it and on one rank here first, the JAX bench's int8 pipeline
     with the int8 seg decoder (``tools/bench.py:bench_config``) at batch 2
     of 256x512 with ``tensor_parallel`` and ``spatial_parallel``:
     ``calibrate_int8`` (and ``calibrate_act_scale_tree`` on the cut
     masters), 4-step samples with fused norms (K3, K4), without (K13,
     K12), and guided (CFG 7.5, a ``none`` context of [2, 77, 768]) in
     int8 and bf16: a UNet forward and x0 within the larger of 2e-2 of
     max|ref| (2e-3 on the mean) and twice one rank's own move for a nudge
     of its input below a bf16 ulp, the launches a rank (K3 and K4
     64, 128 with CFG; K13 and K12 64; K1 wide 1), no fallback, the scales
     against one rank's, 50-55% of the int8 UNet's bytes, no stage run
     whole, seconds a sample; controls on the unfused UNet (K12's
     dynamic interior): the 16 amaxes its model group returns in a
     forward are the same on both ranks, each rank's own amax planted
     makes them differ, and the other rank's partials dropped put the
     forward outside the bound above;
  64. the rest of the model axis (``phase_axis_kernels``, then on phase
     62's ranks): K14-K17 on a rank's heads and K8, K9, K11 and K6 in
     their model-axis modes at the int8 UNet's shapes, each rank against
     its plain version and the ranks together against the one-rank kernel
     (K11 and K6's column s8 conv bit for bit, the others within a bf16
     ulp or 2^-16 of max|out|), with each rank's launch time beside the
     one-rank kernel's, the plain version's and the bound; every partial
     mode's module on the mesh bit-equal to a one-process emulation, the
     planted rank-local amax (K12) and rank-local max(wos) (K11) caught;
     the packed and absorbed UNets' step and bf16 and int8 samples, and
     the int8 options at full width (a 4-step calibrated sample with
     ``use_fused_projs`` and ``int8_fuse_gn``: K8 and K9 64, K6 176; the
     K11 UNet's 4-step ``ddim_sample``: K11 and K12 64), each forward and
     x0 within phase 63's bound of one rank's, no fallback;
  65. the script's total seconds, then a JSON line ``{"kernels": [...]}``
     (K1-K18, K10 in both variants, K1's wide class; K5, K6 and K7 with
     their device time and host time a call; K3, K4, K12 and K13 with
     their partial modes; K6, K8, K9, K11 and K14-K17 with their model-axis
     modes);
  66. the last line, ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the last line. Without a CUDA device
it exits 1 at once. Weights are random, made from a seed; fp32 comparisons
run with TF32 off.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a call
# is the larger of its operations over the peak rate of their type and its
# bytes over the memory rate.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12

BF16_ATOL = 1.6e-2  # two bf16 ulps at 1.0: sums run in another order
FP32_ATOL = 1e-4

# (B, T, H, D) of K1's launches in one UNet forward on a 32x64 latent at
# batch 2, with the number of launches of each
K1_SHAPES = [((2, 2048, 8, 40), 5), ((2, 512, 8, 80), 5),
             ((2, 128, 8, 160), 5), ((2, 32, 8, 160), 1)]
# (B, T, H, D) of K2's launches in one UNet backward on a 24x80 latent at
# batch 8 (192x640 frames), with the number of launches of each
K2_SHAPES = [((8, 1920, 8, 40), 5), ((8, 480, 8, 80), 5),
             ((8, 120, 8, 160), 5), ((8, 30, 8, 160), 1)]
# (B, T, H, D) of K1's and K2's launches in the trained gate's UNet
# (tools/trained_gate.py: widths 32 and 64, 2 heads, a 12x40 latent at
# batch 8): the head classes 16 and 32, checked in bf16 (stage-2 training
# and sampling) and fp32 (K1 in the int8 calibration's forward)
GATE_ATTN_SHAPES = [(8, 480, 2, 16), (8, 120, 2, 32)]
TRAIN_BATCH, TRAIN_HW = 8, (192, 640)
WARMUP_STEPS, TIMED_STEPS = 2, 5
# (B, T, C) of K3's and K4's launches in one int8 UNet forward on a 32x64
# latent at batch 2 (8 heads; K4's interior is M = 4C), with the number of
# launches of each
INT8_SHAPES = [((2, 2048, 320), 5), ((2, 512, 640), 5),
               ((2, 128, 1280), 5), ((2, 32, 1280), 1)]
# (B, T, C) of K3's and K4's launches in the trained gate's int8 sampling
# (2 heads: head dims 16 and 32; K4's interior M = 128 and 256)
GATE_INT8_SHAPES = [((8, 480, 32), 0), ((8, 120, 64), 0)]
# K3/K4 against their plain versions: two bf16 ulps of max|ref| at most,
# and 2.5e-3 of mean|ref| on the mean (a rare int8 code that a summation
# order flips moves a few outputs by a code's worth); K12 and K13 the same
INT8_MAX_TOL, INT8_MEAN_TOL = 1.6e-2, 2.5e-3
# (B, T, H, D) of K13's launches in one unfused int8 UNet forward on a 32x64
# latent at batch 2, with the number of launches of each; K12's are the
# (B, T, C) of INT8_SHAPES
K13_SHAPES = [((2, 2048, 8, 40), 5), ((2, 512, 8, 80), 5),
              ((2, 128, 8, 160), 5), ((2, 32, 8, 160), 1)]


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise CheckFailed(what)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, pattern: str, per_call: str = None, iters: int = 20,
              warmup: int = 3, whole_call: bool = False):
    """Device time per call of ``fn`` in the kernels whose name matches the
    regex ``pattern``, from ``torch.profiler`` over ``iters`` calls: their
    CUDA time over the number of calls the trace shows, counted as the
    kernels matching ``per_call`` (one launch per call; default
    ``pattern``), so that a trace that comes back short still averages
    right; with ``whole_call`` (a library call of several kernels) over
    ``iters``. None when the trace holds no device time for them."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(2):  # a trace now and then comes back without them
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        us = sum(e.time_range.elapsed_us() for e in kernels
                 if re.search(pattern, e.name))
        calls = iters if whole_call else sum(
            1 for e in kernels if re.search(per_call or pattern, e.name))
        if us > 0 and calls:
            return us / calls / 1e3
    return None


# kernel names in a trace: K1/K14's bf16 and fp32 forward, K2's two kernels
# (bf16: stats and main; fp32: dq and dkv), SDPA's kernels (flash,
# memory-efficient or cuDNN), every kernel
K1_KERNEL = r"attention_fwd_kernel"
K2_KERNELS = r"attention_bwd_\w*kernel"
K2_STATS = r"attention_bwd_(stats|dq)_kernel"
K2_MAIN = r"attention_bwd_(main|dkv)_kernel"
SDPA_KERNELS = r"flash|fmha|attention|cudnn|sdpa"
ALL_KERNELS = r""

# K13's, K15's, K11's, K10's (v_bf16 False), K17's and K18's Hopper
# design, in their kernels-line entries
S8PV_REDESIGN = {
    "redesigned": "attention stage attn_s8pv_kernel_sm90 on the Hopper "
                  "skeleton csrc/attention_sm90.cuh (TMA, s8 wgmma Q K^T, "
                  "e8 V with the codes from registers); K11's, K10's and "
                  "K17's products on csrc/gemm_sm90.cuh"}


def _ms(x):
    if isinstance(x, str):
        return x
    return "n/a" if x is None else f"{x:.4f}"


def attention_bound_ms(shape, dtype_name: str, products: int = 2,
                       tensors: int = 4):
    """The bound of ``products`` [T x T x D] products over B*H heads that
    read and write ``tensors`` [B, T, H, D] tensors: forward 2 and 4 (q, k,
    v in, o out), backward 5 and 7 (q, k, v, dO in, dQ, dK, dV out)."""
    b, t, h, d = shape
    esize = 2 if dtype_name == "bfloat16" else 4
    flops = 2.0 * products * b * h * t * t * d
    nbytes = float(tensors) * b * h * t * d * esize
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else
                                 "bytes"), flops, nbytes


def ln_attention_bound_ms(b: int, t: int, c: int, heads: int = 8):
    """K3's bound for one call on bf16 x: int8 operations (three
    projections, QKᵀ) at the int8 peak plus bf16 operations (PV, to_out) at
    the bf16 peak, against x in, the weights (int8 q/k/v, bf16 to_out, six
    float rows) and the bf16 output."""
    d = c // heads
    ops8 = 3 * 2.0 * b * t * c * c + 2.0 * b * heads * t * t * d
    ops16 = 2.0 * b * heads * t * t * d + 2.0 * b * t * c * c
    nbytes = 2 * b * t * c + 3 * c * c + 2 * c * c + 4 * 6 * c + 2 * b * t * c
    t_ops = (ops8 / PEAK_FLOPS["int8"] + ops16 / PEAK_FLOPS["bfloat16"]) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", ops8, ops16, float(nbytes))


def geglu_ln_bound_ms(b: int, t: int, c: int):
    """K4's bound for one call on bf16 x (M = 4C): 2·T·C·2M + 2·T·M·C int8
    operations per image at the int8 peak against x in, W1, W2, the float
    rows and the bf16 output."""
    m = 4 * c
    ops = 2.0 * b * t * c * 2 * m + 2.0 * b * t * m * c
    nbytes = 2 * b * t * c + 3 * m * c + 4 * (4 * m + 5 * c) + 2 * b * t * c
    t_ops = ops / PEAK_FLOPS["int8"] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", ops, float(nbytes))


def k13_bound_ms(b: int, t: int, h: int, d: int):
    """K13's bound for one call: 2·2·BH·T²·D int8 operations (QKᵀ and the
    e8·V product) at the int8 peak against the int8 q, k, v in and the bf16
    output (3 + 2 bytes per element of one [BH, T, D] tensor)."""
    ops = 2.0 * 2 * b * h * t * t * d
    nbytes = 3.0 * b * h * t * d + 2.0 * b * h * t * d
    t_ops = ops / PEAK_FLOPS["int8"] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", ops, nbytes)


def geglu_bound_ms(b: int, t: int, c: int):
    """K12's bound for one call on bf16 x (M = 4C): K4's int8 operations
    against x in, W1, W2, their scales and b1 (no LN rows, no b2) and the
    bf16 output."""
    m = 4 * c
    ops = 2.0 * b * t * c * 2 * m + 2.0 * b * t * m * c
    nbytes = 2 * b * t * c + 3 * m * c + 4 * (4 * m + c) + 2 * b * t * c
    t_ops = ops / PEAK_FLOPS["int8"] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", ops, float(nbytes))


def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"phase 0 device: {name}, count {count}, torch {torch.__version__}"
          f", cuda {torch.version.cuda}", flush=True)
    print(smi_line, flush=True)
    return name, count, smi_line


def phase_build():
    from ldmseg_torch.ops import _build
    t0 = time.monotonic()
    report = _build.build()
    secs = time.monotonic() - t0
    for name, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  [{name}] {line.strip()}", file=sys.stderr)
    print(f"phase 1 build: {len(report)} kernel source(s) "
          f"{sorted(report)} in {secs:.2f} s", flush=True)
    return secs


def phase_attention():
    import torch
    import torch.nn.functional as F
    from ldmseg_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(shape, dtype):
        return [torch.randn(shape, generator=gen, device="cuda",
                            dtype=torch.float32).to(dtype) for _ in range(3)]

    cases = [(s, n, torch.bfloat16) for s, n in K1_SHAPES]
    cases += [((2, 512, 8, 80), 0, torch.float32),
              ((2, 100, 8, 40), 0, torch.bfloat16),
              ((1, 100, 2, 160), 0, torch.float32)]
    cases += [(s, 0, dt) for s in GATE_ATTN_SHAPES
              for dt in (torch.bfloat16, torch.float32)]
    rows = []
    for shape, per_fwd, dtype in cases:
        q, k, v = inputs(shape, dtype)
        scale = shape[3] ** -0.5
        out = A.fused_self_attention(q, k, v, scale)
        torch.cuda.synchronize()
        ref = A.attention_reference(q, k, v, scale)
        err = (out.float() - ref.float()).abs().max().item()
        dname = str(dtype).split(".")[-1]
        tol = BF16_ATOL if dtype == torch.bfloat16 else FP32_ATOL
        check(math.isfinite(err) and err <= tol,
              f"K1 {shape} {dname}: max abs err {err} > {tol}")
        ms = time_ms(lambda: A.fused_self_attention(q, k, v, scale))
        plain_ms = time_ms(lambda: A.attention_reference(q, k, v, scale))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, scale=scale)
        lib_ms = time_ms(sdpa)
        dev_ms = device_ms(lambda: A.fused_self_attention(q, k, v, scale),
                           K1_KERNEL)
        lib_dev_ms = device_ms(sdpa, SDPA_KERNELS)
        bound, by, flops, nbytes = attention_bound_ms(shape, dname)
        rows.append({"shape_btHd": list(shape), "dtype": dname,
                     "per_unet_forward": per_fwd, "max_abs_err": err,
                     "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
                     "bound_ms": bound, "bound_by": by, "flops": flops,
                     "bytes": nbytes})
        print(f"phase 2 K1 {tuple(shape)} {dname}: err {err:.3e} (tol {tol})"
              f", kernel {ms:.4f} ms (device {_ms(dev_ms)}), plain "
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (device "
              f"{_ms(lib_dev_ms)}), bound {bound:.4f} ms ({by}), "
              f"{flops / (dev_ms or ms) / 1e9:.1f} TFLOP/s", flush=True)
    return rows


# the sampling phases' DDIM steps (the default deployment's 50, cut so that
# the script keeps inside its limit with phase 63 beside them), and the
# serving configuration's DPM-Solver++(2M) steps (its 20, cut alike)
SAMPLE_STEPS = 20
DPM_STEPS = 10


def _config():
    from ldmseg_torch.utils.config import DEFAULT_CONFIG, merge_dicts
    # the default deployment: SD-1.4 UNet and image VAE, the seg VAE of
    # DEFAULT_CONFIG, bf16 compute, self-conditioning; SAMPLE_STEPS DDIM
    # steps
    return merge_dicts(DEFAULT_CONFIG, {
        "train_kwargs": {"self_condition": True, "weight_dtype": "bfloat16"},
        "sampling_kwargs": {"num_inference_steps": SAMPLE_STEPS}})


def phase_unet(trainer, seed: int = 1):
    """Full-width UNet forward on K1 against the same module with the plain
    attention (the einsum path), bf16, batch 2, 32x64 latent."""
    import torch
    from ldmseg_torch.models.unet import CrossAttention
    from ldmseg_torch.ops import attention as A

    unet = trainer.inference_unet()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((2, unet.config.in_channels, 32, 64), generator=gen,
                    device="cuda").to(torch.bfloat16)
    t = torch.tensor([999, 19], device="cuda")
    attn = [m for m in unet.modules() if isinstance(m, CrossAttention)]
    with torch.inference_mode():
        before = A.fused_self_attention.launches
        fused = unet(x, t).float()
        torch.cuda.synchronize()
        per_forward = A.fused_self_attention.launches - before
        fused_ms = time_ms(lambda: unet(x, t), iters=10)
        for m in attn:
            m.use_fused = False
        try:
            plain = unet(x, t).float()
            plain_ms = time_ms(lambda: unet(x, t), iters=10)
        finally:
            for m in attn:
                m.use_fused = True
    check(per_forward == 16, f"UNet forward made {per_forward} K1 launches, "
          f"expected 16")
    check(bool(torch.isfinite(fused).all()), "UNet output not finite")
    rel = ((fused - plain).abs().max() / plain.abs().max()).item()
    check(rel <= 2e-2, f"UNet on K1 vs plain attention: max rel err {rel}")
    n_params = sum(p.numel() for p in unet.parameters())
    print(f"phase 3 UNet forward: {n_params / 1e6:.1f} M params, bf16 "
          f"[2, {unet.config.in_channels}, 32, 64]: K1 path {fused_ms:.3f} ms,"
          f" plain-attention path {plain_ms:.3f} ms, max rel err {rel:.3e} "
          f"(tol 2e-2), {per_forward} K1 launches", flush=True)
    return {"fused_ms": fused_ms, "plain_ms": plain_ms, "max_rel_err": rel}


def phase_sample(trainer, smi_line: str, seed: int = 0, phase: int = 4,
                 expect=None, eager_check: bool = False):
    """``sample_panoptic`` end to end at full width: the trainer's DDIM
    steps (``SAMPLE_STEPS`` in :func:`_config`) on 2
    frames of 256x512 (a CUDA graph replayed, ``ddim_sample``'s default on
    the card), then ``panoptic_post_process``. Returns the launch counts
    over the timed call (the main path), checked against ``expect`` per
    UNet forward (default: 16 K1, every other kernel 0). With
    ``eager_check`` the eager loop runs at the same noise and its x0 must
    equal the graph's bit for bit with the same launches, and one call of
    each is profiled (:func:`host_profile`)."""
    import numpy as np
    import torch
    from ldmseg_torch.ops.panoptic import panoptic_post_process

    image = np.random.RandomState(seed).randn(2, 256, 512, 3).astype(
        np.float32)
    batch = {"image": image}
    steps = trainer.num_inference_steps
    trainer.sample_panoptic(batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    logits, x0 = trainer.sample_panoptic(batch)
    cleaned, keep = panoptic_post_process(
        logits, mask_th=trainer.mask_th, count_th=trainer.count_th,
        overlap_th=trainer.overlap_th, ignore_label=trainer.ignore_label)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts()
    launches = counts["K1"]
    peak = torch.cuda.max_memory_allocated()
    c = trainer.num_classes
    check(tuple(logits.shape) == (2, 256, 512, c),
          f"logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "logits not finite")
    check(tuple(x0.shape) == (2, 32, 64, 4), f"x0 shape {tuple(x0.shape)}")
    check(tuple(cleaned.shape) == (2, 256, 512) and
          cleaned.dtype == torch.int32, "cleaned map shape/dtype")
    check(tuple(keep.shape) == (2, c), f"keep shape {tuple(keep.shape)}")
    want = _expect(**{k: n * steps for k, n in
                      (expect or {"K1": 16}).items()})
    check(counts == want, f"bf16 sampling launched {counts}, expected "
          f"{want}")
    x0_host = x0.float().cpu().numpy()
    print(f"phase {phase} sample_panoptic: {steps} DDIM steps (CUDA graph),"
          f" 2 x 256x512 frames -> logits {tuple(logits.shape)}: "
          f"{secs:.3f} s per call (post-process included), "
          f"{2 / secs:.3f} frames/s, peak memory {peak / 2**30:.2f} GiB, "
          f"K1 launches {launches}, launches {counts} [{smi_line}]",
          flush=True)
    result = {"seconds": secs, "frames_per_s": 2 / secs,
              "peak_bytes": peak, "x0": x0_host}
    if eager_check:
        result["eager"] = graph_vs_eager(
            f"phase {phase} bf16", lambda g: trainer.sample_panoptic(
                batch, graph=g), x0, counts, smi_line)
    return counts, result


def graph_vs_eager(label: str, sample, x0_graph, graph_counts,
                   smi_line: str, profile: bool = True) -> dict:
    """The eager loop (``graph=False``) at the graph call's noise: x0 bit
    for bit and the same launches, its wall time beside; with ``profile``
    one graph call traced (:func:`host_profile`)."""
    import torch
    _zero_counts()
    t0 = time.perf_counter()
    _, x0_eager = sample(False)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    counts = _counts()
    check(torch.equal(x0_eager, x0_graph),
          f"{label}: the graph's x0 differs from the eager loop's, max "
          f"{(x0_eager - x0_graph).abs().max().item()}")
    check(counts == graph_counts, f"{label}: the eager loop launched "
          f"{counts}, the graph {graph_counts}")
    prof = None
    if profile:
        # the counters add the capture's delta per replay: the trace shows
        # that the replays ran those kernels on the card (a trace can drop
        # events, never add them: a short one is taken again)
        want = {k: graph_counts[k] for k in TRACE_NAMES}
        for _ in range(3):
            prof = host_profile(lambda: sample(True))
            if prof["trace_launches"] == want:
                break
        check(prof["trace_launches"] == want,
              f"{label}: one traced graph call ran {prof['trace_launches']}"
              f" kernels by name, its counters say {want}")
    print(f"{label} graph vs eager: x0 bit-equal, the same launches"
          + ("; the traced graph call ran the counted kernels "
             f"{prof['trace_launches']}" if prof else "") + "; eager "
          f"{eager_s:.3f} s a call" + (
              f"; a graph call traced: wall {prof['wall_ms']:.1f} ms, "
              f"kernels {_ms(prof.get('device_ms'))} ms, host "
              f"{_ms(prof.get('host_ms'))} ms, busy "
              f"{_ms(prof.get('busy_share'))}" if prof else "")
          + f" [{smi_line}]", flush=True)
    return {"x0_bit_equal": True, "eager_seconds": eager_s,
            "graph_profile": prof}


# one device kernel of each sampling wrapper per launch, by its name in a
# trace: K1's attention (the Hopper bf16 kernel or the fp32 one), K3's
# attention stage, K4's down product
TRACE_NAMES = {"K1": r"attention_fwd_kernel(?!_sm90_wide)",
               "K1w": r"attention_fwd_kernel_sm90_wide",
               "K3": r"attn_s8_kernel_sm90", "K4": r"DownEpi"}


def trace_launches(prof, per: int) -> dict:
    """The device kernels of ``TRACE_NAMES`` that ran in the trace ``prof``
    of ``per`` calls, per call, counted by name: what the card ran, beside
    what the wrappers' counters say."""
    import re
    import torch
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)]
    return {"trace_launches": {
        k: sum(1 for n in names if re.search(p, n)) // per
        for k, p in TRACE_NAMES.items()}}


def host_profile(fn) -> dict:
    """One traced call of ``fn`` after an untraced one
    (``tools/profile_sampling.py:_profile``): wall ms, kernel ms, the
    device's busy share, host ms = wall minus kernel time, and the
    :func:`trace_launches` of the call."""
    from ldmseg_torch.tools.profile_sampling import _profile
    for _ in range(2):  # a trace now and then comes back without them
        out = _profile(fn, 1, "call", trace_launches)
        if isinstance(out.get("device_ms"), float):
            break
    if isinstance(out.get("device_ms"), float):
        out["host_ms"] = out["wall_ms"] - out["device_ms"]
    for k in ("families_ms", "top_kernels_ms"):
        out.pop(k, None)
    return out


def k2_device_ms(fn):
    """K2's device time per call of ``fn`` (one K2 launch per call): all
    its kernels, the stats kernel (fp32: dq) and the main kernel (fp32:
    dkv), from ``torch.profiler``."""
    return {"device_ms": device_ms(fn, K2_KERNELS, per_call=K2_MAIN),
            "stats_device_ms": device_ms(fn, K2_STATS, per_call=K2_MAIN),
            "main_device_ms": device_ms(fn, K2_MAIN)}


def sdpa_backward(q, k, v, do, scale):
    """SDPA's backward alone on the [B, H, T, D] transposes (the library
    yardstick of K2): a call that computes dQ, dK and dV."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
    dot = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)


def phase_attention_backward():
    """K2 against its plain version at the training path's shapes, plus one
    fp32 and two ragged-T cases. Each of dQ, dK and dV is held to the
    tolerance times its own max|ref|: two bf16 ulps at the gradient's
    largest value, 1e-4 in fp32; a second call must give the same bits.
    Times: CUDA events, and the device time of each of K2's two kernels
    and of SDPA's backward (``torch.profiler``); TFLOP/s on the five
    products' operations and the device time."""
    import torch
    from ldmseg_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [(s, n, torch.bfloat16) for s, n in K2_SHAPES]
    cases += [((8, 480, 8, 80), 0, torch.float32),
              ((8, 100, 8, 40), 0, torch.bfloat16),
              ((1, 100, 2, 160), 0, torch.float32)]
    cases += [(s, 0, torch.bfloat16) for s in GATE_ATTN_SHAPES]
    rows = []
    for shape, per_bwd, dtype in cases:
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for _ in range(4))
        scale = shape[3] ** -0.5
        grads = A.fused_self_attention_backward(q, k, v, do, scale)
        again = A.fused_self_attention_backward(q, k, v, do, scale)
        torch.cuda.synchronize()
        same = all(torch.equal(g, h) for g, h in zip(grads, again))
        check(same, f"K2 {shape}: two calls differ")
        refs = A.attention_backward_reference(q, k, v, do, scale)
        dname = str(dtype).split(".")[-1]
        rtol = BF16_ATOL if dtype == torch.bfloat16 else FP32_ATOL
        per_grad = {}
        for gname, g, r in zip(("dQ", "dK", "dV"), grads, refs):
            e = (g.float() - r.float()).abs().max().item()
            m = r.float().abs().max().item()
            check(m > 0 and math.isfinite(e) and e <= rtol * m,
                  f"K2 {shape} {dname} {gname}: max abs err {e} > {rtol} x "
                  f"max|ref| {m}")
            per_grad[gname] = {"max_abs_err": e, "max_abs_ref": m,
                               "tol": rtol * m}
        del grads, again, refs
        err = max(x["max_abs_err"] for x in per_grad.values())
        k2 = lambda: A.fused_self_attention_backward(  # noqa: E731
            q, k, v, do, scale)
        ms = time_ms(k2, iters=10)
        dev = k2_device_ms(k2)
        plain_ms = time_ms(lambda: A.attention_backward_reference(
            q, k, v, do, scale), iters=5, warmup=1)
        lib = sdpa_backward(q, k, v, do, scale)
        lib_ms = time_ms(lib, iters=10)
        lib_dev_ms = device_ms(lib, ALL_KERNELS, whole_call=True, iters=10)
        del lib
        bound, by, flops, nbytes = attention_bound_ms(shape, dname, 5, 7)
        tflops = flops / (dev["device_ms"] or ms) / 1e9
        rows.append({"shape_btHd": list(shape), "dtype": dname,
                     "per_unet_backward": per_bwd, "max_abs_err": err,
                     "per_gradient": per_grad, "deterministic": same,
                     "ms": ms, **dev, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
                     "bound_ms": bound, "bound_by": by, "flops": flops,
                     "bytes": nbytes, "tflops_device": tflops})
        errs = ", ".join(f"{g} {x['max_abs_err']:.3e} of max|ref| "
                         f"{x['max_abs_ref']:.3e}"
                         for g, x in per_grad.items())
        print(f"phase 5 K2 {tuple(shape)} {dname}: err {errs} (tol {rtol} "
              f"x max|ref|), two calls bit-equal, kernel {ms:.4f} ms "
              f"(device {_ms(dev['device_ms'])}: stats "
              f"{_ms(dev['stats_device_ms'])} + main "
              f"{_ms(dev['main_device_ms'])}), plain {plain_ms:.4f} ms, "
              f"sdpa-bwd {lib_ms:.4f} ms (device {_ms(lib_dev_ms)}), bound "
              f"{bound:.4f} ms ({by}), {tflops:.1f} TFLOP/s", flush=True)
    return rows


def _train_config():
    from ldmseg_torch.utils.config import DEFAULT_CONFIG, merge_dicts
    # the default deployment trained as the reference trains it: SD-1.4
    # UNet with self-conditioning (12 input channels), bf16 compute on fp32
    # masters, AdamW lr 1e-4 with warm-up, clip_grad 3.0, time_embedding
    # frozen; SyntheticDVPS's ignore label (0)
    return merge_dicts(DEFAULT_CONFIG, {
        "train_kwargs": {"self_condition": True, "weight_dtype": "bfloat16",
                         "batch_size": TRAIN_BATCH},
        "ignore_label": 0})


def _flat_grads(unet):
    import torch
    return torch.cat([p.grad.reshape(-1) for p in unet.parameters()])


def phase_train(smi_line: str, seed: int = 0):
    """``train_loop`` at full width: warm-up, then the timed steps with the
    launch counts (the training path), then the update and gradient checks.
    Returns the counts over the timed steps and the measurements."""
    import torch
    from ldmseg_torch.data.loader import Loader
    from ldmseg_torch.data.synthetic import SyntheticDVPS
    from ldmseg_torch.models.unet import CrossAttention
    from ldmseg_torch.train.trainer_ldm import TrainerDiffusion

    ds = SyntheticDVPS(length=2 * TRAIN_BATCH, size=TRAIN_HW, num_bits=8)
    trainer = TrainerDiffusion(_train_config(), dataset=ds)
    trainer.init_params(seed=seed)
    unet = trainer.unet
    masters = {n: p.detach().clone() for n, p in unet.named_parameters()}
    warm = trainer.train_loop(max_steps=WARMUP_STEPS, log_every=WARMUP_STEPS,
                              seed=seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    timed = trainer.train_loop(max_steps=TIMED_STEPS, log_every=TIMED_STEPS,
                               seed=seed + 1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    train_counts = _counts()
    fwd, bwd = train_counts["K1"], train_counts["K2"]
    peak = torch.cuda.max_memory_allocated()
    losses = warm + timed
    check(len(losses) == WARMUP_STEPS + TIMED_STEPS
          and all(math.isfinite(x) for x in losses),
          f"train losses not finite: {losses}")
    check(fwd == 32 * TIMED_STEPS and bwd == 16 * TIMED_STEPS,
          f"train steps launched K1 {fwd} and K2 {bwd} times, expected "
          f"{32 * TIMED_STEPS} and {16 * TIMED_STEPS}")
    check(all(train_counts[k] == 0 for k in train_counts
              if k not in ("K1", "K2")),
          f"the train steps launched an int8 kernel: {train_counts}")
    check(trainer.state.step == WARMUP_STEPS + TIMED_STEPS,
          f"optimizer steps {trainer.state.step}")
    frozen, moved = [], []
    for n, p in unet.named_parameters():
        same = torch.equal(p.detach(), masters[n])
        if n.startswith("time_embedding"):
            frozen.append(same)
        else:
            moved.append(not same)
    check(frozen and all(frozen), "a time_embedding parameter changed")
    check(all(moved), f"{moved.count(False)} trained parameters unchanged")
    del masters
    print(f"phase 6 train_loop: {TIMED_STEPS} steps, batch {TRAIN_BATCH} x "
          f"{TRAIN_HW[0]}x{TRAIN_HW[1]}, bf16 on fp32 masters: "
          f"{secs / TIMED_STEPS:.4f} s/step, "
          f"{TRAIN_BATCH * TIMED_STEPS / secs:.3f} samples/s, peak memory "
          f"{peak / 2**30:.2f} GiB, K1 {fwd} / K2 {bwd} launches, losses "
          f"{[round(x, 4) for x in losses]} [{smi_line}]", flush=True)

    # the host's data path alone, and train_step on a batch already loaded
    t0 = time.perf_counter()
    batch = next(iter(Loader(ds, TRAIN_BATCH, seed=seed + 2)))
    data_secs = time.perf_counter() - t0
    trainer.train_step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    step_secs = (time.perf_counter() - t0) / 3
    print(f"phase 6 train_step on a loaded batch: {step_secs:.4f} s/step; "
          f"loading and collating one batch: {data_secs:.4f} s", flush=True)

    # one step's loss and gradients on K1/K2 against the plain attention
    dev = trainer.device
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    lh, lw = TRAIN_HW[0] // 8, TRAIN_HW[1] // 8
    noise = torch.randn((TRAIN_BATCH, lh, lw, 4), generator=gen, device=dev)
    steps = torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen, device=dev)
    attn = [m for m in unet.modules() if isinstance(m, CrossAttention)]
    results = {}
    for fused in (True, False):
        for m in attn:
            m.use_fused = fused
        trainer.state.zero_grad()
        loss, _, _ = trainer.forward_backward(batch, noise=noise,
                                              timesteps=steps)
        if fused:
            for m in attn:
                g = m.to_q.weight.grad
                check(g is not None and bool(torch.isfinite(g).all())
                      and g.abs().max().item() > 0,
                      "a to_q.weight.grad is missing, zero or not finite")
        results[fused] = (loss.item(), _flat_grads(unet))
    for m in attn:
        m.use_fused = True
    trainer.state.zero_grad()
    (loss_f, g_f), (loss_p, g_p) = results[True], results[False]
    norm_f, norm_p = g_f.norm().item(), g_p.norm().item()
    cos = (torch.dot(g_f, g_p) / (g_f.norm() * g_p.norm())).item()
    loss_rel = abs(loss_f - loss_p) / abs(loss_p)
    norm_rel = abs(norm_f - norm_p) / norm_p
    del results, g_f, g_p
    check(loss_rel <= 1e-2, f"train loss on K1/K2 vs plain: rel {loss_rel}")
    check(norm_rel <= 2e-2, f"gradient norm on K1/K2 vs plain: rel "
          f"{norm_rel}")
    check(cos >= 0.99, f"gradient cosine on K1/K2 vs plain: {cos}")
    print(f"phase 6 one step on K1/K2 vs plain attention: loss {loss_f:.6f} "
          f"vs {loss_p:.6f} (rel {loss_rel:.2e}, tol 1e-2), gradient norm "
          f"{norm_f:.6f} vs {norm_p:.6f} (rel {norm_rel:.2e}, tol 2e-2), "
          f"cosine {cos:.6f} (>= 0.99); every to_q.weight.grad finite and "
          f"non-zero ({len(attn)} layers)", flush=True)
    return train_counts, {"seconds_per_step": secs / TIMED_STEPS,
                      "samples_per_s": TRAIN_BATCH * TIMED_STEPS / secs,
                      "train_step_seconds_loaded_batch": step_secs,
                      "batch_load_seconds": data_secs,
                      "peak_bytes": peak, "losses": losses,
                      "loss_rel": loss_rel, "grad_norm_rel": norm_rel,
                      "grad_cosine": cos}


def _int8_config(**sk):
    """The default deployment with ``int8_inference`` and the sampling keys
    ``sk`` (``fused_norms``, ``fused_ff``)."""
    cfg = _config()
    cfg["sampling_kwargs"].update(int8_inference=True, **sk)
    return cfg


def _block_modules(c: int, seed: int, heads: int = 8):
    """A transformer block's float modules (LayerNorm, CrossAttention on K1,
    LayerNorm, FeedForward) on the card in fp32 with seeded weights, which
    the kernels' packs quantize."""
    import torch
    from ldmseg_torch.models.layers import LayerNorm, init_random_
    from ldmseg_torch.models.unet import CrossAttention, FeedForward
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mods = [LayerNorm(c), CrossAttention(c, heads, use_fused=True),
            LayerNorm(c), FeedForward(c)]
    for m in mods:
        m.to("cuda")
        init_random_(m, gen)
    return mods


def _launched(wrapper, *args):
    """``wrapper(*args)``; fails unless it launched its kernel once and fell
    back to the plain version no time."""
    n, fb = wrapper.launches, wrapper.fallbacks
    out = wrapper(*args)
    check(wrapper.launches == n + 1 and wrapper.fallbacks == fb,
          f"{wrapper.__name__} at {tuple(args[0].shape)}: "
          f"{wrapper.launches - n} launches, {wrapper.fallbacks - fb} "
          "fallbacks, expected one launch")
    return out


def _int8_row(name, shape, per_fwd, out, ref, fn, plain, context, bound):
    import torch
    err = (out.float() - ref.float()).abs()
    emax, emean = err.max().item(), err.mean().item()
    rmax, rmean = (ref.float().abs().max().item(),
                   ref.float().abs().mean().item())
    check(bool(torch.isfinite(out).all()) and emax <= INT8_MAX_TOL * rmax
          and emean <= INT8_MEAN_TOL * rmean,
          f"{name} {shape}: max abs err {emax} (max|ref| {rmax}), mean "
          f"{emean} (mean|ref| {rmean})")
    ms = time_ms(fn)
    plain_ms = time_ms(plain, iters=5, warmup=1)
    context_ms = time_ms(context)
    bound_ms, by, *work = bound
    return {"shape_btc": list(shape), "per_unet_forward": per_fwd,
            "max_abs_err": emax, "max_abs_ref": rmax, "mean_abs_err": emean,
            "mean_abs_ref": rmean, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bf16_block_ms": context_ms,
            "bound_ms": bound_ms, "bound_by": by, "work": work}


def _stage_split(fn, stages: dict):
    """Device time per call of ``fn`` in total and by stage (``stages``:
    name -> regex on the kernel's short name), from ``torch.profiler``;
    fails if a kernel of the call matches no stage (an old kernel back on
    the path)."""
    import re
    from ldmseg_torch.tools.profile_int8_blocks import stages as trace
    row = trace(fn)
    by_name = row["stages_device_ms"]
    if not by_name:
        return None, {}
    split = {k: sum(v for n, v in by_name.items() if re.search(p, n))
             for k, p in stages.items()}
    unknown = [n for n in by_name
               if not any(re.search(p, n) for p in stages.values())]
    check(not unknown, f"kernels outside the stages {sorted(stages)}: "
                       f"{unknown}")
    return row["device_ms"], split


def _stages(kid: str) -> dict:
    """A block's stages by kernel name (tools/profile_int8_blocks.py's
    ``STAGES``: the LN + quantize, the Hopper products by their epilogue,
    the attention, the quantize passes)."""
    from ldmseg_torch.tools.profile_int8_blocks import STAGES
    return STAGES[kid]


def _gemm_rows(shape, per_fwd):
    """The Hopper product (ops/gemm.py) at each product shape of K3 and K4
    for ``shape``, in the form each block launches (K4's up with two
    operands, W1's h and gate rows, as K4 runs it): int32 sums bit-equal to
    ``torch._int_mm`` on the transposed view of W that
    ``ops/quant.py:int8_matmul`` passes, fp32 sums within BF16_ATOL of
    max|ref| of ``torch.matmul``; event and device times of both."""
    import torch
    from ldmseg_torch.ops import gemm as G
    b, t, c = shape
    rows, m = b * t, 4 * c
    gen = torch.Generator(device="cuda").manual_seed(rows + c)
    out_rows = []
    for kid, what, n, k, dtype, operands in (
            ("K3", "qkv", 3 * c, c, "int8", 1),
            ("K3", "to_out", c, c, "bfloat16", 1),
            ("K4", "up", 2 * m, c, "int8", 2),
            ("K4", "down", c, m, "int8", 1)):
        if dtype == "int8":
            a = torch.randint(-127, 128, (rows, k), generator=gen,
                              device="cuda", dtype=torch.int8)
            w = torch.randint(-127, 128, (n, k), generator=gen,
                              device="cuda", dtype=torch.int8)
            ours = lambda: G.gemm_s8(a, w, operands)  # noqa: E731
            lib = lambda: torch._int_mm(a, w.t())  # noqa: E731
            out, ref = ours(), lib()
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            check(torch.equal(out, ref), f"gemm_s8 [{rows}, {k}] x [{n}, "
                  f"{k}]^T: int32 sums differ from torch._int_mm by {err}")
        else:
            a = torch.randn((rows, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            w = torch.randn((n, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            ours = lambda: G.gemm_bf16(a, w)  # noqa: E731
            lib = lambda: torch.matmul(a, w.t())  # noqa: E731
            out = ours()
            ref = a.float() @ w.float().t()
            err = (out - ref).abs().max().item()
            tol = BF16_ATOL * ref.abs().max().item()
            check(err <= tol, f"gemm_bf16 [{rows}, {k}] x [{n}, {k}]^T: "
                  f"max abs err {err} > {tol}")
        ops = 2.0 * rows * n * k
        out_rows.append({
            "block": kid, "product": what, "rows_n_k": [rows, n, k],
            "dtype": dtype, "operands": operands, "per_unet_forward": per_fwd,
            "max_abs_err": err, "ms": time_ms(ours),
            "device_ms": device_ms(ours, r"gemm_kernel"),
            "library": "torch._int_mm(a, w.t())" if dtype == "int8" else
                       "torch.matmul(a, w.t()) (bf16)",
            "library_ms": time_ms(lib),
            "library_device_ms": device_ms(lib, ALL_KERNELS,
                                           whole_call=True),
            "bound_ms": max(ops / PEAK_FLOPS[dtype],
                            (rows * k + n * k) * (1 if dtype == "int8"
                                                  else 2)
                            / PEAK_BYTES) * 1e3})
        r = out_rows[-1]
        print(f"phase 7 product {kid} {what} [{rows}, {k}] x [{n}, {k}]^T "
              f"{dtype} x{operands}: err {err}, ours {r['ms']:.4f} ms (device "
              f"{_ms(r['device_ms'])}), {r['library']} {r['library_ms']:.4f}"
              f" ms (device {_ms(r['library_device_ms'])})", flush=True)
    return out_rows


def phase_int8_kernels():
    """K3 and K4 against their plain versions on the card, at every shape of
    the int8 UNet forward and a ragged T the shape rule still sends to the
    kernel; K4 in both interior-scale modes and once more with two
    512-token blocks. Beside each, the bf16 block the kernel replaces, as
    context (a different function): norm1 + attn1 on K1 + the residual, or
    norm3 + ff + the residual; at the forward's shapes the device time of
    each stage, two calls bit-equal, and the Hopper product against
    ``torch._int_mm`` / ``torch.matmul`` at each product shape."""
    import torch
    from ldmseg_torch.ops import attention_s8 as K3
    from ldmseg_torch.ops import geglu as K4

    gen = torch.Generator(device="cuda").manual_seed(7)
    k3_rows, k4_rows, gemm_rows = [], [], []
    # the ragged T and the trained gate's 2-head sites go to K3 as well
    ragged = [((1, 120, 320), 0)] + GATE_INT8_SHAPES
    for shape, per_fwd in INT8_SHAPES + ragged + [((1, 1024, 320), 0)]:
        b, t, c = shape
        heads = 2 if (shape, per_fwd) in GATE_INT8_SHAPES else 8
        norm1, attn, norm3, ff = _block_modules(c, t + c, heads)
        apack = K3.pack_ln_attention(norm1, attn, heads, 0.1)
        fpacks = {mode: K4.pack_geglu(norm3, ff.net[0].proj, ff.net[2],
                                      0.05, gs)
                  for mode, gs in (("dynamic", None), ("static", 0.02))}
        n1, at, n3, f = (m.to(torch.bfloat16)
                         for m in (norm1, attn, norm3, ff))
        x = torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        with torch.inference_mode():
            if (shape, per_fwd) in INT8_SHAPES + ragged:
                out = _launched(K3.ln_attention_s8, x, apack)
                torch.cuda.synchronize()
                row = _int8_row(
                    "K3", shape, per_fwd, out,
                    K3.ln_attention_s8_reference(x, apack),
                    lambda: K3.ln_attention_s8(x, apack),
                    lambda: K3.ln_attention_s8_reference(x, apack),
                    lambda: x + at(n1(x)), ln_attention_bound_ms(b, t, c))
                row["heads"] = heads
                if per_fwd:
                    check(torch.equal(out, K3.ln_attention_s8(x, apack)),
                          f"K3 {shape}: two calls differ")
                    row["device_ms"], row["stages_device_ms"] = (
                        _stage_split(lambda: K3.ln_attention_s8(x, apack),
                                     _stages("K3")))
                k3_rows.append(row)
                print(f"phase 7 K3 {shape} {heads} heads: err "
                      f"{row['max_abs_err']:.3e} of "
                      f"max|ref| {row['max_abs_ref']:.3e}, mean "
                      f"{row['mean_abs_err']:.3e} of {row['mean_abs_ref']:.3e}"
                      f"; kernel {row['ms']:.4f} ms (device "
                      f"{_ms(row.get('device_ms'))}: "
                      f"{row.get('stages_device_ms')}), plain "
                      f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f}"
                      f" ms ({row['bound_by']}), bf16 block on K1 "
                      f"{row['bf16_block_ms']:.4f} ms", flush=True)
            for mode, fpack in fpacks.items():
                out = _launched(K4.geglu_ln_s8, x, fpack)
                torch.cuda.synchronize()
                row = _int8_row(
                    "K4", shape, per_fwd, out,
                    K4.geglu_ln_s8_reference(x, fpack),
                    lambda: K4.geglu_ln_s8(x, fpack),
                    lambda: K4.geglu_ln_s8_reference(x, fpack),
                    lambda: x + f(n3(x)), geglu_ln_bound_ms(b, t, c))
                row["interior"] = mode
                if per_fwd:
                    check(torch.equal(out, K4.geglu_ln_s8(x, fpack)),
                          f"K4 {shape} {mode}: two calls differ")
                    row["device_ms"], row["stages_device_ms"] = (
                        _stage_split(lambda: K4.geglu_ln_s8(x, fpack),
                                     _stages("K4")))
                k4_rows.append(row)
                print(f"phase 7 K4 {shape} {mode}: err "
                      f"{row['max_abs_err']:.3e} of max|ref| "
                      f"{row['max_abs_ref']:.3e}, mean "
                      f"{row['mean_abs_err']:.3e} of {row['mean_abs_ref']:.3e}"
                      f"; kernel {row['ms']:.4f} ms (device "
                      f"{_ms(row.get('device_ms'))}: "
                      f"{row.get('stages_device_ms')}), plain "
                      f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f}"
                      f" ms ({row['bound_by']}), bf16 block "
                      f"{row['bf16_block_ms']:.4f} ms", flush=True)
        if (shape, per_fwd) in INT8_SHAPES:
            gemm_rows += _gemm_rows(shape, per_fwd)
    return k3_rows, k4_rows, gemm_rows


def _wrappers():
    """Every kernel's wrapper by id; all but K1 and K2 count fallbacks
    too (K14's are the float ``_xla_btc``)."""
    from ldmseg_torch.ops import attention as A
    from ldmseg_torch.ops import attention_s8 as S8
    from ldmseg_torch.ops import geglu as G
    from ldmseg_torch.ops import gn_silu_conv as GC
    from ldmseg_torch.ops import groupnorm_silu as GN
    return {"K1": A.fused_self_attention,
            "K2": A.fused_self_attention_backward,
            "K3": S8.ln_attention_s8, "K4": G.geglu_ln_s8,
            "K8": S8.ln_attention_s8_pin, "K9": G.geglu_ln_s8_pout,
            "K11": S8.padded_attention_s8,
            "K5": GN.group_norm_silu, "K6": GN.group_norm_silu_quant,
            "K7": GC.gn_silu_conv,
            "K12": G.fused_geglu_s8, "K13": S8.fused_self_attention_s8,
            "K10": S8.ln_attention_s8_rowmajor,
            "K14": A.fused_self_attention_packed,
            "K15": S8.fused_self_attention_packed_s8,
            "K16": A.absorbed_self_attention,
            "K17": S8.absorbed_self_attention_s8,
            "K18": S8.absorbed_fullc_self_attention_s8}


def _counts():
    """Launches by kernel id (``K1w``: K1's wide class, head dim 512, on
    its own counter) and the fallbacks summed."""
    w = _wrappers()
    out = {k: f.launches for k, f in w.items()}
    out["K1w"] = w["K1"].wide_launches
    out["fallbacks"] = sum(getattr(f, "fallbacks", 0) for f in w.values())
    return out


def _zero_counts():
    for f in _wrappers().values():
        f.launches = 0
        if hasattr(f, "fallbacks"):
            f.fallbacks = 0
    _wrappers()["K1"].wide_launches = 0


def _expect(**launches):
    """The counts of a run that launched only ``launches``."""
    out = {k: 0 for k in _wrappers()}
    out["K1w"] = 0
    out.update(launches)
    out["fallbacks"] = 0
    return out


def phase_int8_unet(trainer, seed: int = 1):
    """The int8 UNet forward at full width against the bf16 UNet on K1 of
    the same masters (the input of phase 3); the time of the s8 convs from
    CUDA events around each ``QuantConv2d``."""
    import torch
    from ldmseg_torch.ops.quant import QuantConv2d

    bf16 = trainer.inference_unet()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((2, bf16.config.in_channels, 32, 64), generator=gen,
                    device="cuda").to(torch.bfloat16)
    t = torch.tensor([999, 19], device="cuda")
    int8 = trainer.int8_unet()
    with torch.inference_mode():
        ref = bf16(x, t).float()
        _zero_counts()
        out = int8(x, t).float()
        torch.cuda.synchronize()
        counts = _counts()
        int8_ms = time_ms(lambda: int8(x, t), iters=10)
        bf16_ms = time_ms(lambda: bf16(x, t), iters=10)
        events = []

        def pre(_m, _i):
            events.append([torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)])
            events[-1][0].record()

        def post(_m, _i, _o):
            events[-1][1].record()
        convs = [m for m in int8.modules() if isinstance(m, QuantConv2d)]
        hooks = [h for m in convs for h in (
            m.register_forward_pre_hook(pre), m.register_forward_hook(post))]
        int8(x, t)
        torch.cuda.synchronize()
        for h in hooks:
            h.remove()
        conv_ms = sum(a.elapsed_time(b) for a, b in events)
    check(counts == _expect(K3=16, K4=16),
          f"int8 UNet forward launched {counts}, expected 16 K3, 16 K4, "
          f"0 K1, 0 fallbacks")
    check(bool(torch.isfinite(out).all()), "int8 UNet output not finite")
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    rel_mean = ((out - ref).abs().mean() / ref.abs().mean()).item()
    corr = torch.corrcoef(torch.stack([out.flatten(), ref.flatten()]))[
        0, 1].item()
    check(corr >= 0.9, f"int8 UNet vs bf16: correlation {corr} < 0.9")
    print(f"phase 8 int8 UNet forward, [2, {bf16.config.in_channels}, 32, 64]"
          f": {int8_ms:.3f} ms (bf16 on K1 {bf16_ms:.3f} ms), s8 convs "
          f"{conv_ms:.3f} ms in {len(convs)} convs ({conv_ms / int8_ms:.1%} "
          f"of the forward, with the hooks' events), launches {counts}; vs "
          f"bf16: max rel err {rel:.3e}, mean rel err {rel_mean:.3e}, "
          f"correlation {corr:.6f} (>= 0.9)", flush=True)
    return {"int8_ms": int8_ms, "bf16_ms": bf16_ms, "s8_conv_ms": conv_ms,
            "s8_convs": len(convs), "max_rel_err": rel,
            "mean_rel_err": rel_mean, "correlation": corr}


def phase_unfused_kernels():
    """K13 and K12 against their plain versions on the card, at every shape
    of the unfused int8 UNet forward and a ragged T (K12 in both
    interior-scale modes). K13 runs on bf16 q, k, v with the path's static
    scale 0.1 (the ragged T with dynamic scales). Beside each, the bf16
    function the kernel replaces, a different function: K1 and SDPA on the
    same q, k, v for K13, the bf16 GEGLU FF (``ff``) for K12."""
    import torch
    import torch.nn.functional as F
    from ldmseg_torch.ops import attention as A
    from ldmseg_torch.ops import attention_s8 as S8
    from ldmseg_torch.ops import geglu as G

    gen = torch.Generator(device="cuda").manual_seed(11)
    k13_rows, k12_rows = [], []
    for shape, per_fwd in K13_SHAPES + [((1, 120, 8, 160), 0)]:
        b, t, h, d = shape
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        scale, act = d ** -0.5, (0.1 if per_fwd else None)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        with torch.inference_mode():
            out = S8.fused_self_attention_s8(q, k, v, scale, act)
            torch.cuda.synchronize()
            row = _int8_row(
                "K13", shape, per_fwd, out,
                S8.fused_self_attention_s8_reference(q, k, v, scale, act),
                lambda: S8.fused_self_attention_s8(q, k, v, scale, act),
                lambda: S8.fused_self_attention_s8_reference(q, k, v, scale,
                                                             act),
                lambda: A.fused_self_attention(q, k, v, scale),
                k13_bound_ms(b, t, h, d))
            row["sdpa_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, scale=scale))
            if per_fwd:
                row["device_ms"], row["stages_device_ms"] = _stage_split(
                    lambda: S8.fused_self_attention_s8(q, k, v, scale, act),
                    _stages("K13"))
        row["act_scale"] = act
        k13_rows.append(row)
        print(f"phase 10 K13 {shape} {'static 0.1' if act else 'dynamic'}"
              f": err {row['max_abs_err']:.3e} of max|ref| "
              f"{row['max_abs_ref']:.3e}, mean {row['mean_abs_err']:.3e} of "
              f"{row['mean_abs_ref']:.3e}; kernel {row['ms']:.4f} ms (device "
              f"{_ms(row.get('device_ms'))}: {row.get('stages_device_ms')}),"
              f" plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f}"
              f" ms ({row['bound_by']}); bf16 K1 {row['bf16_block_ms']:.4f} "
              f"ms, sdpa {row['sdpa_ms']:.4f} ms", flush=True)
        del q, k, v, qt, kt, vt
    for shape, per_fwd in INT8_SHAPES + [((1, 120, 320), 0)]:
        b, t, c = shape
        _, _, norm3, ff = _block_modules(c, seed=t + c + 1)
        fpacks = {mode: G.pack_geglu(norm3, ff.net[0].proj, ff.net[2],
                                     0.05, gs)
                  for mode, gs in (("dynamic", None), ("static", 0.02))}
        f = ff.to(torch.bfloat16)
        x = torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        with torch.inference_mode():
            for mode, fpack in fpacks.items():
                out = G.fused_geglu_s8(x, fpack)
                torch.cuda.synchronize()
                row = _int8_row(
                    "K12", shape, per_fwd, out,
                    G.geglu_s8_reference(x, fpack),
                    lambda: G.fused_geglu_s8(x, fpack),
                    lambda: G.geglu_s8_reference(x, fpack),
                    lambda: f(x), geglu_bound_ms(b, t, c))
                row["interior"] = mode
                if per_fwd:
                    row["device_ms"], row["stages_device_ms"] = (
                        _stage_split(lambda: G.fused_geglu_s8(x, fpack),
                                     _stages("K12")))
                k12_rows.append(row)
                print(f"phase 10 K12 {shape} {mode}: err "
                      f"{row['max_abs_err']:.3e} of max|ref| "
                      f"{row['max_abs_ref']:.3e}, mean "
                      f"{row['mean_abs_err']:.3e} of {row['mean_abs_ref']:.3e}"
                      f"; kernel {row['ms']:.4f} ms, plain "
                      f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f}"
                      f" ms ({row['bound_by']}), bf16 FF "
                      f"{row['bf16_block_ms']:.4f} ms; device "
                      f"{_ms(row.get('device_ms'))}: "
                      f"{row.get('stages_device_ms')}", flush=True)
    return k13_rows, k12_rows


def phase_unfused_unet(trainer, seed: int = 1):
    """The unfused int8 UNet forward (variant (a): K13 + K12) at full width
    against the bf16 UNet on K1 of the same masters (the input of
    phase 3)."""
    import torch
    bf16 = trainer.inference_unet()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((2, bf16.config.in_channels, 32, 64), generator=gen,
                    device="cuda").to(torch.bfloat16)
    t = torch.tensor([999, 19], device="cuda")
    int8 = trainer.int8_unet()
    with torch.inference_mode():
        ref = bf16(x, t).float()
        _zero_counts()
        out = int8(x, t).float()
        torch.cuda.synchronize()
        counts = _counts()
        int8_ms = time_ms(lambda: int8(x, t), iters=10)
        bf16_ms = time_ms(lambda: bf16(x, t), iters=10)
    check(counts == _expect(K12=16, K13=16),
          f"unfused int8 UNet forward launched {counts}, expected 16 K13, "
          f"16 K12, 0 K1/K3/K4, 0 fallbacks")
    check(bool(torch.isfinite(out).all()), "unfused int8 UNet not finite")
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    rel_mean = ((out - ref).abs().mean() / ref.abs().mean()).item()
    corr = torch.corrcoef(torch.stack([out.flatten(), ref.flatten()]))[
        0, 1].item()
    check(corr >= 0.9, f"unfused int8 UNet vs bf16: correlation {corr}")
    print(f"phase 11 unfused int8 UNet forward (K13 + K12), "
          f"[2, {bf16.config.in_channels}, 32, 64]: {int8_ms:.3f} ms (bf16 "
          f"on K1 {bf16_ms:.3f} ms), launches {counts}; vs bf16: max rel err"
          f" {rel:.3e}, mean rel err {rel_mean:.3e}, correlation "
          f"{corr:.6f} (>= 0.9)", flush=True)
    return {"int8_ms": int8_ms, "bf16_ms": bf16_ms, "max_rel_err": rel,
            "mean_rel_err": rel_mean, "correlation": corr}


def phase_int8_sample(trainer, label: str, expect: dict, smi_line: str,
                      bf16_result: dict, calibrate: bool, phase: int,
                      calls: int = 1, seed: int = 0,
                      eager_check: bool = False, per_call=None):
    """int8 ``sample_panoptic`` as phase 4 (same frames, same init noise):
    a warm-up call, ``calls`` timed calls with the default scales and, with
    ``calibrate``, ``calls`` after ``calibrate_int8`` (the host's speed
    moves a single call: the fastest is reported); every call's launches
    checked against ``expect`` (per UNet forward) and ``per_call`` (per
    call: the image encode's K1 D=512). With ``eager_check``
    each mode's last call is held bit for bit to the eager loop
    (:func:`graph_vs_eager`), and the calibrated graph's x0 must differ
    from the default scales' (a graph captured afresh after the
    recalibration, not replayed stale). Returns each mode's counts and
    measurements."""
    import numpy as np
    import torch
    from ldmseg_torch.ops.panoptic import panoptic_post_process

    image = np.random.RandomState(seed).randn(2, 256, 512, 3).astype(
        np.float32)
    batch = {"image": image}
    steps = trainer.num_inference_steps
    want = _expect(**{k: n * steps for k, n in expect.items()},
                   **(per_call or {}))
    results, x0s = {}, {}
    modes = (["warm-up"] + ["default scales"] * calls
             + (["calibrated"] * calls if calibrate else []))
    timings = {}
    for i, mode in enumerate(modes):
        if mode == "calibrated" and modes[i - 1] != mode:
            t0 = time.perf_counter()
            scales = trainer.calibrate_int8(batch)
            torch.cuda.synchronize()
            calib_s = time.perf_counter() - t0
            check(len(scales) == 2 * 22 + 3 * 16,
                  f"calibrate_int8 gave {len(scales)} sites")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        logits, x0 = trainer.sample_panoptic(batch)
        cleaned, keep = panoptic_post_process(
            logits, mask_th=trainer.mask_th, count_th=trainer.count_th,
            overlap_th=trainer.overlap_th, ignore_label=trainer.ignore_label)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _counts()
        peak = torch.cuda.max_memory_allocated()
        c = trainer.num_classes
        check(tuple(logits.shape) == (2, 256, 512, c)
              and bool(torch.isfinite(logits).all())
              and tuple(cleaned.shape) == (2, 256, 512)
              and tuple(keep.shape) == (2, c),
              f"{label} {mode}: logits or post-process of the wrong shape "
              f"or not finite")
        check(counts == want, f"{label} {mode}: launched {counts}, "
              f"expected {want}")
        if mode == "warm-up":
            continue
        timings.setdefault(mode, []).append(secs)
        if len(timings[mode]) < calls:
            continue
        secs = min(timings[mode])
        corr = float(np.corrcoef(x0.float().cpu().numpy().ravel(),
                                 bf16_result["x0"].ravel())[0, 1])
        results[mode] = {"seconds": secs, "seconds_each_call": timings[mode],
                         "frames_per_s": 2 / secs, "peak_bytes": peak,
                         "counts": counts, "x0_correlation_with_bf16": corr}
        if eager_check:
            results[mode]["eager"] = graph_vs_eager(
                f"phase {phase} {label} ({mode})",
                lambda g: trainer.sample_panoptic(batch, graph=g), x0,
                counts, smi_line, profile=mode == "default scales")
            x0s[mode] = x0
            if mode == "calibrated":
                check(not torch.equal(x0, x0s["default scales"]),
                      f"{label}: the calibrated call's x0 equals the default"
                      f" scales' (a stale graph?)")
        if mode == "calibrated":
            results[mode]["calibrate_seconds"] = calib_s
        each = ", ".join(f"{x:.3f}" for x in timings[mode])
        sampler = "DPM-Solver++(2M)" if trainer.sampler == "dpmpp_2m" \
            else "DDIM"
        print(f"phase {phase} {label} sample_panoptic ({mode}): {steps} "
              f"{sampler} steps, 2 x 256x512 -> logits "
              f"{tuple(logits.shape)}: "
              f"{secs:.3f} s per call (the fastest of {each}), "
              f"{2 / secs:.3f} frames/s, peak memory {peak / 2**30:.2f} GiB,"
              f" launches {counts}; x0 correlation with the bf16 call "
              f"{corr:.4f}; bf16 (phase 4): {bf16_result['seconds']:.3f} s, "
              f"{bf16_result['peak_bytes'] / 2**30:.2f} GiB [{smi_line}]",
              flush=True)
    return results


def int8_entry(name, kid, source, replaces, tpu_kernel, rows, launches,
               by_path):
    """The kernels-line entry for K3, K4, K8-K13 or K15: times summed over
    the 16 launches of one int8 UNet forward (dynamic interior for K4 and
    K12), per-shape rows beside them. ``bf16_block_ms`` is the bf16 (or
    other) function the kernel replaces (for K13 K1, with SDPA in
    ``sdpa_ms``; for K11 bf16 projections and SDPA, with float projections
    and K13 in ``k13_block_ms``; for K15 SDPA, with K13 on the head views in
    ``k13_ms``; for K10 K3, or LN + K11 + the residual)."""
    main = [r for r in rows if r["per_unet_forward"]
            and r.get("interior", "dynamic") == "dynamic"]
    checked = [r for r in rows if not r.get("fallback")]

    def total(key):
        return sum(r[key] * r["per_unet_forward"] for r in main)
    ops_ms = sum(r["work"][0] / PEAK_FLOPS["int8"] * 1e3
                 * r["per_unet_forward"] for r in main)
    ops_ms += sum(r["work"][1] / PEAK_FLOPS["bfloat16"] * 1e3
                  * r["per_unet_forward"] for r in main
                  if len(r["work"]) == 3)
    bytes_ms = sum(r["work"][-1] / PEAK_BYTES * 1e3 * r["per_unet_forward"]
                   for r in main)
    return {
        "name": name, "id": kid, "route": "cuda", "source": source,
        "replaces": replaces, "tpu_kernel": tpu_kernel,
        "launches": launches, "launches_by_path": by_path, "checked": True,
        "max_abs_err": max(r["max_abs_err"] for r in checked),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
        "library_note": "no single PyTorch call computes this function",
        "bf16_block_ms": total("bf16_block_ms"),
        **{key: total(key) for key in ("sdpa_ms", "k13_block_ms", "k13_ms")
           if key in main[0]},
        **({"device_ms": total("device_ms"),
            "stages_device_ms": {
                k: sum(r["stages_device_ms"][k] * r["per_unet_forward"]
                       for r in main) for k in main[0]["stages_device_ms"]}}
           if all(r.get("device_ms") is not None for r in main) else {}),
        "unit": "one UNet forward (16 launches, int8, batch 2, 32x64 "
                "latent)",
        "shapes": rows,
    }


def products_entry(rows, kid):
    """K3's or K4's products (phase 7) summed over one UNet forward, beside
    the library calls that compute the same products (the blocks
    themselves have none)."""
    main = [r for r in rows if r["block"] == kid]

    def total(key):
        if any(r[key] is None for r in main):
            return None
        return sum(r[key] * r["per_unet_forward"] for r in main)
    return {"products": main,
            "products_library": "torch._int_mm(a, w.t()) (int8), "
                                "torch.matmul (bf16)",
            **{f"products_{key}": total(key)
               for key in ("ms", "device_ms", "library_ms",
                           "library_device_ms", "bound_ms")}}


def _per_unit(rows, per_key):
    main = [r for r in rows if r[per_key]]

    def total(key):
        return sum(r[key] * r[per_key] for r in main)

    ops = sum(r["flops"] * r[per_key] for r in main)
    nbytes = sum(r["bytes"] * r[per_key] for r in main)
    out = {
        "max_abs_err": max(r["max_abs_err"] for r in main),
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": ("operations" if ops / PEAK_FLOPS["bfloat16"]
                     >= nbytes / PEAK_BYTES else "bytes"),
        "library_ms": total("library_ms"),
    }
    # profiler times where every row has one (phases 2, 5, 24 and 29)
    for key in ("device_ms", "attention_device_ms", "library_device_ms",
                "stats_device_ms", "main_device_ms", "k2_device_ms"):
        if all(r.get(key) is not None for r in main):
            out[key] = total(key)
    return out


def k2_entry(rows, launches, by_path):
    """The kernels-line entry for K2: times summed over the 16 launches of
    one UNet backward (the training path's shapes at batch 8); beside them
    the device time of its two kernels, SDPA's backward's, and TFLOP/s on
    the five products' operations."""
    unit = _per_unit(rows, "per_unet_backward")
    main = [r for r in rows if r["per_unet_backward"]]
    flops = sum(r["flops"] * r["per_unet_backward"] for r in main)
    return {
        "name": "attention_bwd",
        "id": "K2",
        "route": "cuda",
        "source": "ldmseg_torch/csrc/attention_bwd.cu",
        "replaces": "ldmseg_tpu/ops/pallas/attention.py:1298",
        "tpu_kernel": "ldmseg_tpu/ops/pallas/attention.py:_attn_bwd_kernel",
        "launches": launches,
        "launches_by_path": by_path,
        "checked": True,
        "deterministic": all(r["deterministic"] for r in rows),
        "kernels": ["attention_bwd_stats_kernel",
                    "attention_bwd_main_kernel"],
        **unit,
        "tflops_device": (flops / unit["device_ms"] / 1e9
                          if unit.get("device_ms") else None),
        "unit": "one UNet backward (16 launches, bf16, batch 8, 24x80 "
                "latent)",
        "shapes": rows,
    }


def k1_entry(rows, launches, by_path):
    """The kernels-line entry for K1: times summed over the 16 launches of
    one UNet forward (the sampling path's shapes at batch 2), per-shape rows
    beside them."""
    return {
        "name": "attention_fwd",
        "id": "K1",
        "route": "cuda",
        "source": "ldmseg_torch/csrc/attention_fwd.cu",
        "replaces": "ldmseg_tpu/ops/pallas/attention.py:28",
        "tpu_kernel": "ldmseg_tpu/ops/pallas/attention.py:_attn_kernel",
        "launches": launches,
        "launches_by_path": by_path,
        "checked": True,
        **_per_unit(rows, "per_unet_forward"),
        "unit": "one UNet forward (16 launches, bf16, batch 2, 32x64 latent)",
        "shapes": rows,
    }


# ---------------------------------------------------------------------------
# the GroupNorm + SiLU family: K5, K6, K7 (phases 14-18)
# ---------------------------------------------------------------------------
# fp32 operations per element, for the bound (all far below the bytes): the
# statistics (add, multiply-add), the normalize and affine (4), the SiLU
# (exp, add, divide, multiply); K6 adds |y|, the max and the quantize (3)
GN_OPS, GN_QUANT_OPS = 9, 12
GN_BF16_TOL, GN_FP32_TOL, GN_CONV_TOL = 1.6e-2, 1e-5, 2e-2
# K6 codes: +-1 at no more than this share of the elements, where y / s
# sits on a .5 tie that a summation order moves
GN_CODE_FLIPS = 1e-3


def _gn_trainer(cfg, seed: int = 0, **kw):
    """A trainer on the GN UNet with seeded weights; the resnet norms' scale
    and shift and the resnet convs' biases drawn too (the init leaves them
    1 and 0), so that every kernel's affine and bias are exercised."""
    import torch
    from ldmseg_torch.tools.profile_sampling import unet_config_for
    from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
    trainer = TrainerDiffusion(cfg, unet_config=unet_config_for(gn=True),
                               **kw)
    trainer.init_params(seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 100)
    with torch.no_grad():
        for name, p in trainer.unet.named_parameters():
            if ".resnets." not in name:
                continue
            if name.endswith(("norm1.weight", "norm2.weight")):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=gen,
                                                device="cuda"))
            elif name.endswith(("norm1.bias", "norm2.bias", "conv1.bias",
                                "conv2.bias")):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen,
                                          device="cuda"))
    return trainer


def _resnets(unet):
    from ldmseg_torch.models.layers import ResnetBlock
    return [(n, m) for n, m in unet.named_modules()
            if isinstance(m, ResnetBlock)]


def _gn_norms(unet):
    return [m for _, r in _resnets(unet) for m in (r.norm1, r.norm2)]


def _capture_halves(unet, x, t):
    """One forward of ``unet`` with pre-hooks on every resnet norm: the
    input of each (norm, the conv after it) half, in the order of the
    forward."""
    import torch
    sites = []
    handles = []
    for name, r in _resnets(unet):
        for norm, conv, label in ((r.norm1, r.conv1, "norm1"),
                                  (r.norm2, r.conv2, "norm2")):
            def hook(_m, inputs, norm=norm, conv=conv,
                     label=f"{name}.{label}"):
                sites.append((label, inputs[0].detach().clone(), norm, conv))
            handles.append(norm.register_forward_pre_hook(hook))
    try:
        with torch.inference_mode():
            unet(x, t)
    finally:
        for h in handles:
            h.remove()
    return sites


def _gn_bound(shape, in_bytes: int, out_bytes: float, ops: int):
    b, c, h, w = shape
    n = b * c * h * w
    nbytes = n * (in_bytes + out_bytes) + 2 * 4 * c
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops * n / PEAK_FLOPS["float32"] * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", float(ops * n), float(nbytes))


def _conv_bound(shape, cout: int):
    b, cin, h, w = shape
    ops = 2.0 * b * h * w * 9 * cin * cout
    nbytes = (2.0 * b * h * w * (cin + cout) + 2 * 9 * cin * cout
              + 4 * (2 * cin + cout))
    t_ops = ops / PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", ops, nbytes)


def _max_err(out, ref):
    err = (out.float() - ref.float()).abs().max().item()
    return err, ref.float().abs().max().item()


def _gn_row(shape, dtype, err, rmax, fn, plain, composition, bound,
            **extra):
    """A GN kernel's row at one half: its CUDA-event ms, device ms, kernels
    per call (by name) and host µs per call (``tools/profile_gn.py:
    measure``), beside the plain version's and the bf16 composition's event
    ms and the bound."""
    from ldmseg_torch.tools.profile_gn import measure
    m = measure(fn)
    plain_ms = time_ms(plain, iters=5, warmup=1)
    comp_ms = time_ms(composition)
    bound_ms, by, ops, nbytes = bound
    return {"shape_bchw": list(shape), "dtype": dtype, "max_abs_err": err,
            "max_abs_ref": rmax, "ms": m["event_ms"],
            "device_ms": m["device_ms"], "host_us": m["host_us"],
            "kernels_per_call": m["kernels_per_call"],
            "kernel_launches": m["kernel_launches"],
            "traced_calls": m["traced_calls"],
            "kernels_device_ms": m["kernels_device_ms"], "plain_ms": plain_ms,
            "library_ms": None, "bf16_composition_ms": comp_ms,
            "bound_ms": bound_ms, "bound_by": by, "ops": ops,
            "bytes": nbytes, **extra}


def _per_forward(rows, key):
    """The rows' ``key`` times their launches per forward, summed; None
    when a trace gave no device time."""
    vals = [(r.get(key), r["per_unet_forward"]) for r in rows
            if r.get("per_unet_forward")]
    return (None if any(v is None for v, _ in vals)
            else sum(v * n for v, n in vals))


def _sum(rows, key):
    """The rows' sum of ``key``; None when a trace gave no device time."""
    vals = [r[key] for r in rows]
    return None if any(v is None for v in vals) else sum(vals)


def _kernels_summed(rows):
    """Device ms by kernel name, summed over the rows."""
    total = {}
    for r in rows:
        for name, ms in (r.get("kernels_device_ms") or {}).items():
            total[name] = total.get(name, 0.0) + ms
    return total


def phase_gn_kernels(trainer, smi_line: str):
    """K5, K6 and K7 against their plain versions at the 44 resnet halves
    of one full-width bf16 forward (batch 2, 32x64 latent; inputs captured
    by hooks, the UNet's own norm and conv weights), K5 also in fp32 there
    and in bf16 at the training shapes (batch 8, 24x80). Beside each, its
    bound, the plain version's time and the bf16 composition it replaces:
    ``F.silu(F.group_norm(x))`` for K5, that and the per-image quantize for
    K6, ``F.conv2d`` of it for K7 (no single PyTorch call computes any of
    the three)."""
    import torch
    import torch.nn.functional as F
    from ldmseg_torch.ops import gn_silu_conv as GC
    from ldmseg_torch.ops import groupnorm_silu as GN

    unet = trainer.inference_unet()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((2, unet.config.in_channels, 32, 64), generator=gen,
                    device="cuda").to(torch.bfloat16)
    xt = torch.randn((TRAIN_BATCH, unet.config.in_channels, 24, 80),
                     generator=gen, device="cuda").to(torch.bfloat16)
    t = torch.tensor([999, 19], device="cuda")
    tt = torch.full((TRAIN_BATCH,), 500, device="cuda")
    sites = _capture_halves(unet, x, t)
    train_sites = _capture_halves(unet, xt, tt)
    check(len(sites) == 44 and len(train_sites) == 44,
          f"captured {len(sites)} and {len(train_sites)} resnet halves")
    k5, k6, k7 = [], [], []
    flips_total = codes_total = k7_launched = k7_fallbacks = 0
    with torch.inference_mode():
        for group, rows_sites in (("sampling", sites),
                                  ("training", train_sites)):
            for label, xs, norm, conv in rows_sites:
                g, eps = norm.num_groups, norm.eps
                sc, bi = norm.weight, norm.bias
                shape = tuple(xs.shape)
                # K5 in bf16 (and fp32 at the sampling shapes)
                for dtype in ((torch.bfloat16, torch.float32)
                              if group == "sampling" else (torch.bfloat16,)):
                    xd = xs.to(dtype)
                    out = GN.group_norm_silu(xd, sc, bi, g, eps)
                    torch.cuda.synchronize()
                    ref = GN.group_norm_silu_reference(xd, sc, bi, g, eps)
                    err, rmax = _max_err(out, ref)
                    tol = (GN_BF16_TOL if dtype == torch.bfloat16
                           else GN_FP32_TOL)
                    check(out.dtype == dtype and math.isfinite(err)
                          and err <= tol * rmax,
                          f"K5 {label} {shape} {dtype}: max abs err {err} > "
                          f"{tol} x max|ref| {rmax}")
                    if dtype != torch.bfloat16:
                        k5[-1]["fp32_max_abs_err"] = err
                        k5[-1]["fp32_max_abs_ref"] = rmax
                        continue
                    bound = _gn_bound(shape, 2, 2, GN_OPS)
                    row = _gn_row(
                        shape, "bfloat16", err, rmax,
                        lambda: GN.group_norm_silu(xd, sc, bi, g, eps),
                        lambda: GN.group_norm_silu_reference(xd, sc, bi, g,
                                                             eps),
                        lambda: F.silu(F.group_norm(xd, g, sc, bi, eps)),
                        bound, site=label, path=group)
                    k5.append(row)
                if group != "sampling":
                    continue
                # K6
                q, s = GN.group_norm_silu_quant(xs, sc, bi, g, eps)
                torch.cuda.synchronize()
                rq, rs = GN.group_norm_silu_quant_reference(xs, sc, bi, g,
                                                           eps)
                srel = ((s - rs).abs() / rs).max().item()
                diff = (q.int() - rq.int()).abs()
                flips = int((diff > 0).sum().item())
                check(srel <= 1e-5 and int(diff.max().item()) <= 1
                      and flips <= GN_CODE_FLIPS * q.numel(),
                      f"K6 {label} {shape}: scale rel err {srel}, codes off "
                      f"by up to {int(diff.max().item())} at {flips} of "
                      f"{q.numel()}")
                flips_total += flips
                codes_total += q.numel()
                # the error of the dequantized values q * s
                err, rmax = _max_err(q.float() * s[:, None, None, None],
                                     rq.float() * rs[:, None, None, None])

                def k6_composition(xs=xs, sc=sc, bi=bi, g=g, eps=eps):
                    y = F.silu(F.group_norm(xs, g, sc, bi, eps)).float()
                    s = y.abs().amax(dim=(1, 2, 3)).clamp_min(1e-6) / 127.0
                    return torch.round(y / s[:, None, None, None]).to(
                        torch.int8), s
                row = _gn_row(
                    shape, "bfloat16", err, rmax,
                    lambda: GN.group_norm_silu_quant(xs, sc, bi, g, eps),
                    lambda: GN.group_norm_silu_quant_reference(xs, sc, bi, g,
                                                               eps),
                    k6_composition, _gn_bound(shape, 2, 1, GN_QUANT_OPS),
                    site=label, path=group, scale_max_rel_err=srel,
                    code_flips=flips, codes=q.numel())
                k6.append(row)
                # K7: this half with its conv
                w, cb = conv.weight, conv.bias
                before = (GC.gn_silu_conv.launches,
                          GC.gn_silu_conv.fallbacks)
                out = GC.gn_silu_conv(xs, sc, bi, w, cb, g, eps)
                torch.cuda.synchronize()
                launched = GC.gn_silu_conv.launches - before[0]
                fell = GC.gn_silu_conv.fallbacks - before[1]
                k7_launched += launched
                k7_fallbacks += fell
                if fell:
                    k7.append({"site": label, "shape_bchw": list(shape),
                               "cout": w.shape[0], "fallback": True})
                    continue
                ref = GC.gn_silu_conv_reference(xs, sc, bi, w, cb, g, eps)
                err, rmax = _max_err(out, ref)
                check(math.isfinite(err) and err <= GN_CONV_TOL * rmax,
                      f"K7 {label} {shape} -> {w.shape[0]}: max abs err "
                      f"{err} > {GN_CONV_TOL} x max|ref| {rmax}")
                check(torch.equal(out, GC.gn_silu_conv(xs, sc, bi, w, cb, g,
                                                       eps)),
                      f"K7 {label} {shape}: two calls differ")
                plan = GC.sm90_conv_plan(shape[0], shape[1], w.shape[0],
                                         shape[2], shape[3], g)
                row = _gn_row(
                    shape, "bfloat16", err, rmax,
                    lambda: GC.gn_silu_conv(xs, sc, bi, w, cb, g, eps),
                    lambda: GC.gn_silu_conv_reference(xs, sc, bi, w, cb, g,
                                                      eps),
                    lambda: F.conv2d(F.silu(F.group_norm(xs, g, sc, bi, eps)),
                                     w, cb, padding=1),
                    _conv_bound(shape, w.shape[0]), site=label, path=group,
                    cout=w.shape[0], fallback=False, splits=plan.splits,
                    plan_launches=plan.launches)
                row["tflops"] = row["ops"] / row["ms"] / 1e9
                # the conv part's yardstick: cuDNN on the same y (K5's
                # plain arithmetic, rounded to bf16), and the weight pack
                # the call reads from its cache, timed apart
                y = GN.group_norm_silu_reference(xs, sc, bi, g, eps)
                row["conv2d_ms"] = time_ms(
                    lambda: F.conv2d(y, w, cb, padding=1))
                row["conv2d_device_ms"] = device_ms(
                    lambda: F.conv2d(y, w, cb, padding=1), ALL_KERNELS,
                    whole_call=True)
                row["pack_ms"] = time_ms(lambda: GC.pack_conv_weight(w),
                                         iters=5, warmup=1)
                k7.append(row)
    check((k7_launched, k7_fallbacks) == (43, 1),
          f"K7 over the 44 halves: {k7_launched} launches and "
          f"{k7_fallbacks} fallbacks, expected 43 and 1")
    for kid, rows in (("K5", [r for r in k5 if r["path"] == "sampling"]),
                      ("K5 training shapes",
                       [r for r in k5 if r["path"] == "training"]),
                      ("K6", k6), ("K7", [r for r in k7
                                          if not r["fallback"]])):
        kpc = sorted({round(r["kernels_per_call"], 2) for r in rows
                      if r["kernels_per_call"] is not None})
        print(f"phase 14 {kid}: {len(rows)} halves, max err "
              f"{max(r['max_abs_err'] for r in rows):.3e}; kernel "
              f"{sum(r['ms'] for r in rows):.4f} ms (device "
              f"{_ms(_sum(rows, 'device_ms'))} ms, host "
              f"{_sum(rows, 'host_us') / len(rows):.1f} us a call, kernels a "
              f"call {kpc}: {_kernels_ms(_kernels_summed(rows))}), plain "
              f"{sum(r['plain_ms'] for r in rows):.4f} ms, bf16 composition"
              f" {sum(r['bf16_composition_ms'] for r in rows):.4f} ms, bound "
              f"{sum(r['bound_ms'] for r in rows):.4f} ms per UNet forward "
              f"[{smi_line}]", flush=True)
    # the trace: one kernel a K5 call, two a K6 call (launch A and B), two
    # or three a K7 call (the activation pass, the product, the split's
    # sum), each at most once a call (a trace may drop a few events, never
    # add one)
    k7_want = [(r, {"gn_pad_kernel", "gemm_kernel"}
                | ({"conv_sum_kernel"} if r["splits"] > 1 else set()))
               for r in k7 if not r["fallback"]]
    for kid, rows_want in (("K5", [(r, {"gn_cluster_kernel"}) for r in k5]),
                           ("K6", [(r, {"gn_cluster_kernel",
                                        "gn_quant_kernel"}) for r in k6]),
                           ("K7", k7_want)):
        for r, want in rows_want:
            seen = r["kernel_launches"]
            names = {n.split("<")[0] for n in seen}
            check(not seen or (names == want and max(seen.values())
                               <= r["traced_calls"]),
                  f"{kid} {r['shape_bchw']}: the trace shows {seen} over "
                  f"{r['traced_calls']} calls; expected {sorted(want)} once "
                  f"a call")
    for kid, rows in (("K5", [r for r in k5 if r["path"] == "sampling"]),
                      ("K6", k6), ("K7", [r for r in k7
                                          if not r["fallback"]])):
        for line in _by_shape_class(rows):
            print(f"phase 14 {kid} {line}", flush=True)
    for line in _k7_levels([r for r in k7 if not r["fallback"]], smi_line):
        print(f"phase 14 K7 {line}", flush=True)
    fp32_rel = max(r["fp32_max_abs_err"] / r["fp32_max_abs_ref"]
                   for r in k5 if "fp32_max_abs_err" in r)
    print(f"phase 14 K5 fp32: max err {fp32_rel:.3e} of max|ref| (tol "
          f"{GN_FP32_TOL}); K6 codes off by one at "
          f"{flips_total} of {codes_total}; K7 {k7_launched} launches, "
          f"{k7_fallbacks} fallback", flush=True)
    return k5, k6, k7, k7_launched


# the two shape classes JAX's K7 takes that the port's plan refused before
# its repair: ((B, Cin, H, W), Cout, groups)
K7_REPAIRED = [((2, 36, 32, 64), 64, 4), ((2, 320, 64, 64), 320, 1)]


def phase_k7_repaired(smi_line: str, seed: int = 5):
    """K7 at :data:`K7_REPAIRED` (Cin 36 in 4 groups: scratch and pack rows
    of 40 channels; 320 channels at 64x64 in one group: a CTA's slice of
    329 KB read twice, in chunks) against ``gn_silu_conv_reference`` within
    ``GN_CONV_TOL`` of max|ref|, two calls bit-equal, with the time, the
    bound, the plain version's and the bf16 composition's time."""
    import torch
    import torch.nn.functional as F
    from ldmseg_torch.ops import gn_silu_conv as GC
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    # no inference mode: K7 keeps its weight pack and fp32 casts per tensor
    # and version, and an inference tensor has no version (made anew at
    # every call, elementwise launches in the trace)
    with torch.no_grad():
        for shape, cout, g in K7_REPAIRED:
            cin = shape[1]
            xs = (1.5 * torch.randn(shape, generator=gen, device="cuda")
                  + 0.3).to(torch.bfloat16)
            sc = 1.0 + 0.1 * torch.randn(cin, generator=gen, device="cuda")
            bi = 0.1 * torch.randn(cin, generator=gen, device="cuda")
            w = (torch.randn((cout, cin, 3, 3), generator=gen,
                             device="cuda") / (9 * cin) ** 0.5).to(
                torch.bfloat16)
            cb = (0.1 * torch.randn(cout, generator=gen, device="cuda")).to(
                torch.bfloat16)
            plan = GC.sm90_conv_plan(*shape[:2], cout, *shape[2:], g)
            # x read once when a CTA's slice is one chunk, else twice
            x_reads = 1 if (plan.chunk_ch, plan.chunk_pix) == (
                cin // g, plan.rows_per_cta * shape[3]) else 2
            before = GC.gn_silu_conv.launches
            out = GC.gn_silu_conv(xs, sc, bi, w, cb, g, 1e-5)
            again = GC.gn_silu_conv(xs, sc, bi, w, cb, g, 1e-5)
            torch.cuda.synchronize()
            launched = GC.gn_silu_conv.launches - before
            check(launched == 2,
                  f"K7 repaired {shape}: launched {launched} times, not 2")
            ref = GC.gn_silu_conv_reference(xs, sc, bi, w, cb, g, 1e-5)
            err, rmax = _max_err(out, ref)
            check(math.isfinite(err) and err <= GN_CONV_TOL * rmax,
                  f"K7 repaired {shape} -> {cout} in {g} groups: max abs err"
                  f" {err} > {GN_CONV_TOL} x max|ref| {rmax}")
            check(torch.equal(out, again),
                  f"K7 repaired {shape}: two calls differ")
            row = _gn_row(
                shape, "bfloat16", err, rmax,
                lambda: GC.gn_silu_conv(xs, sc, bi, w, cb, g, 1e-5),
                lambda: GC.gn_silu_conv_reference(xs, sc, bi, w, cb, g,
                                                  1e-5),
                lambda: F.conv2d(F.silu(F.group_norm(
                    xs, g, sc.to(xs.dtype), bi.to(xs.dtype), 1e-5)), w, cb,
                    padding=1),
                _conv_bound(shape, cout), cout=cout, groups=g,
                cin8=plan.cin8, chunk=[plan.chunk_ch, plan.chunk_pix],
                x_reads=x_reads, splits=plan.splits,
                plan_launches=plan.launches, launches=launched)
            names = {n.split("<")[0] for n in row["kernel_launches"]}
            want = {"gn_pad_kernel", "gemm_kernel"} | (
                {"conv_sum_kernel"} if plan.splits > 1 else set())
            check(not names or names == want,
                  f"K7 repaired {shape}: the trace shows {names}")
            print(f"phase 14 K7 repaired {list(shape)} -> {cout} in {g} "
                  f"groups (cin8 {plan.cin8}, chunk {plan.chunk_ch} x "
                  f"{plan.chunk_pix}, x read {x_reads}x, splits "
                  f"{plan.splits}): max err {err:.3e} of max|ref| {rmax:.3e}"
                  f" (tol {GN_CONV_TOL}), bit-equal repeats; kernel "
                  f"{row['ms']:.4f} ms (device {_ms(row['device_ms'])}), "
                  f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                  f"plain {row['plain_ms']:.4f} ms, bf16 composition "
                  f"{row['bf16_composition_ms']:.4f} ms [{smi_line}]",
                  flush=True)
            rows.append(row)
    return rows


def k7_levels(rows):
    """K7's halves summed per level (H x W): halves, kernel (event) and
    device ms, the bound, ``F.conv2d``'s device ms on the same y, the
    weight packs' ms, the kernels a call, and the device's share of 3.35
    TB/s for the bytes the bound counts."""
    levels = {}
    for r in rows:
        _, _, h, w = r["shape_bchw"]
        levels.setdefault(f"{h}x{w}", []).append(r)
    out = {}
    for level, rs in levels.items():
        dev = _sum(rs, "device_ms")
        out[level] = {
            "halves": len(rs), "ms": sum(r["ms"] for r in rs),
            "device_ms": dev, "bound_ms": sum(r["bound_ms"] for r in rs),
            "bytes": sum(r["bytes"] for r in rs),
            "conv2d_device_ms": _sum(rs, "conv2d_device_ms"),
            "conv2d_ms": sum(r["conv2d_ms"] for r in rs),
            "pack_ms": sum(r["pack_ms"] for r in rs),
            "kernels_per_call": sorted({round(r["kernels_per_call"], 2)
                                        for r in rs
                                        if r["kernels_per_call"]}),
            "splits": sorted({r["splits"] for r in rs}),
            "bandwidth_share": (sum(r["bytes"] for r in rs) / (dev * 1e-3)
                                / PEAK_BYTES if dev else None)}
    return out


def _k7_levels(rows, smi_line):
    for level, v in k7_levels(rows).items():
        yield (f"level {level}: {v['halves']} halves, kernel "
               f"{v['ms']:.4f} ms (device {_ms(v['device_ms'])} ms, "
               f"kernels a call {v['kernels_per_call']}, splits "
               f"{v['splits']}), bound {v['bound_ms']:.4f} ms, F.conv2d on "
               f"the same y: device {_ms(v['conv2d_device_ms'])} ms, the "
               f"weight packs {v['pack_ms']:.4f} ms (apart from the calls),"
               f" share of 3.35 TB/s {v['bandwidth_share']} [{smi_line}]")


def _kernels_ms(by_name):
    """``{short name: ms}`` of a kernel split, four places."""
    return {n.split("<")[0]: round(v, 4) for n, v in by_name.items()}


def _by_shape_class(rows):
    """One line per (channels, pixels) of the rows: the number of halves
    and their summed kernel (event), device, bound, plain and bf16
    composition ms, the host µs a call and the device ms by kernel."""
    classes = {}
    for r in rows:
        _, c, h, w = r["shape_bchw"]
        classes.setdefault((c, h * w), []).append(r)
    for (c, hw), rs in sorted(classes.items(), key=lambda kv: -kv[0][1]):
        total = {k: sum(r[k] for r in rs) for k in
                 ("ms", "bound_ms", "plain_ms", "bf16_composition_ms")}
        yield (f"C={c} at {hw} px: {len(rs)} halves, kernel "
               f"{total['ms']:.4f} ms (device {_ms(_sum(rs, 'device_ms'))} "
               f"ms, host {_sum(rs, 'host_us') / len(rs):.1f} us a call: "
               f"{_kernels_ms(_kernels_summed(rs))}), bound "
               f"{total['bound_ms']:.4f} ms, plain {total['plain_ms']:.4f} "
               f"ms, bf16 composition {total['bf16_composition_ms']:.4f} ms")


def phase_gn_unet(trainer):
    """The full-width bf16 UNet with ``use_pallas_gn`` against the same
    module on the plain GN (phase 3's input): 44 K5 launches per forward,
    no fallback."""
    import torch
    unet = trainer.inference_unet()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((2, unet.config.in_channels, 32, 64), generator=gen,
                    device="cuda").to(torch.bfloat16)
    t = torch.tensor([999, 19], device="cuda")
    norms = _gn_norms(unet)
    with torch.inference_mode():
        _zero_counts()
        fused = unet(x, t).float()
        torch.cuda.synchronize()
        counts = _counts()
        fused_ms = time_ms(lambda: unet(x, t), iters=10)
        for m in norms:
            m.use_pallas = False
        try:
            plain = unet(x, t).float()
            plain_ms = time_ms(lambda: unet(x, t), iters=10)
        finally:
            for m in norms:
                m.use_pallas = True
    check(counts == _expect(K1=16, K5=44),
          f"GN UNet forward launched {counts}, expected 16 K1, 44 K5")
    check(bool(torch.isfinite(fused).all()), "GN UNet output not finite")
    rel = ((fused - plain).abs().max() / plain.abs().max()).item()
    check(rel <= 2e-2, f"UNet on K5 vs plain GN: max rel err {rel}")
    print(f"phase 15 UNet forward with use_pallas_gn, [2, 12, 32, 64]: K5 "
          f"path {fused_ms:.3f} ms, plain-GN path {plain_ms:.3f} ms, max rel"
          f" err {rel:.3e} (tol 2e-2), launches {counts}", flush=True)
    return {"gn_ms": fused_ms, "plain_gn_ms": plain_ms, "max_rel_err": rel}


def phase_gn_train(smi_line: str, seed: int = 0, timed: int = 3):
    """``train_loop`` with ``use_pallas_gn`` as phase 6 (2 warm-up and
    ``timed`` steps): 88 K5, 32 K1, 16 K2 per step; then one step's loss
    and gradients against the same step on the plain GN, and a gradient on
    every resnet norm weight."""
    import torch
    from ldmseg_torch.data.loader import Loader
    from ldmseg_torch.data.synthetic import SyntheticDVPS

    ds = SyntheticDVPS(length=2 * TRAIN_BATCH, size=TRAIN_HW, num_bits=8)
    trainer = _gn_trainer(_train_config(), seed, dataset=ds)
    trainer.train_loop(max_steps=WARMUP_STEPS, log_every=WARMUP_STEPS,
                       seed=seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    losses = trainer.train_loop(max_steps=timed, log_every=timed,
                                seed=seed + 1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    want = _expect(K1=32 * timed, K2=16 * timed, K5=88 * timed)
    check(counts == want, f"GN train steps launched {counts}, expected "
          f"{want}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    print(f"phase 17 train_loop with use_pallas_gn: {timed} steps, batch "
          f"{TRAIN_BATCH} x {TRAIN_HW[0]}x{TRAIN_HW[1]}: "
          f"{secs / timed:.4f} s/step, {TRAIN_BATCH * timed / secs:.3f} "
          f"samples/s, peak memory {peak / 2**30:.2f} GiB, launches "
          f"{counts} [{smi_line}]", flush=True)

    batch = next(iter(Loader(ds, TRAIN_BATCH, seed=seed + 2)))
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    lh, lw = TRAIN_HW[0] // 8, TRAIN_HW[1] // 8
    noise = torch.randn((TRAIN_BATCH, lh, lw, 4), generator=gen,
                        device="cuda")
    steps = torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen,
                          device="cuda")
    norms = _gn_norms(trainer.unet)
    results = {}
    for fused in (True, False):
        for m in norms:
            m.use_pallas = fused
        trainer.state.zero_grad()
        loss, _, _ = trainer.forward_backward(batch, noise=noise,
                                              timesteps=steps)
        if fused:
            for m in norms:
                for p in (m.weight, m.bias):
                    check(p.grad is not None
                          and bool(torch.isfinite(p.grad).all())
                          and p.grad.abs().max().item() > 0,
                          "a resnet norm gradient is missing, zero or not "
                          "finite")
        results[fused] = (loss.item(), _flat_grads(trainer.unet))
    for m in norms:
        m.use_pallas = True
    (loss_f, g_f), (loss_p, g_p) = results[True], results[False]
    cos = (torch.dot(g_f, g_p) / (g_f.norm() * g_p.norm())).item()
    loss_rel = abs(loss_f - loss_p) / abs(loss_p)
    del results, g_f, g_p, trainer
    check(loss_rel <= 1e-2, f"train loss on K5 vs plain GN: rel {loss_rel}")
    check(cos >= 0.99, f"gradient cosine on K5 vs plain GN: {cos}")
    print(f"phase 17 one step on K5 vs plain GN: loss {loss_f:.6f} vs "
          f"{loss_p:.6f} (rel {loss_rel:.2e}, tol 1e-2), gradient cosine "
          f"{cos:.6f} (>= 0.99); every resnet norm weight and bias has a "
          f"finite non-zero gradient ({len(norms)} norms)", flush=True)
    return counts, {"seconds_per_step": secs / timed,
                    "samples_per_s": TRAIN_BATCH * timed / secs,
                    "peak_bytes": peak, "losses": losses,
                    "loss_rel": loss_rel, "grad_cosine": cos}


def phase_gn_int8_unet(trainer, seed: int = 1):
    """The full-width int8 UNet with ``int8_fuse_gn`` (K6 into the s8
    convs, K3 + K4) against the bf16 UNet with ``use_pallas_gn`` of the
    same masters: 44 K6, 16 K3, 16 K4 per forward, 0 K5."""
    import torch
    bf16 = trainer.inference_unet()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((2, bf16.config.in_channels, 32, 64), generator=gen,
                    device="cuda").to(torch.bfloat16)
    t = torch.tensor([999, 19], device="cuda")
    int8 = trainer.int8_unet()
    with torch.inference_mode():
        ref = bf16(x, t).float()
        _zero_counts()
        out = int8(x, t).float()
        torch.cuda.synchronize()
        counts = _counts()
        int8_ms = time_ms(lambda: int8(x, t), iters=10)
        bf16_ms = time_ms(lambda: bf16(x, t), iters=10)
    check(counts == _expect(K3=16, K4=16, K6=44),
          f"int8 GN UNet forward launched {counts}, expected 44 K6, 16 K3, "
          f"16 K4")
    check(bool(torch.isfinite(out).all()), "int8 GN UNet not finite")
    corr = torch.corrcoef(torch.stack([out.flatten(), ref.flatten()]))[
        0, 1].item()
    rel = ((out - ref).abs().mean() / ref.abs().mean()).item()
    check(corr >= 0.9, f"int8 GN UNet vs bf16: correlation {corr}")
    print(f"phase 18 int8 UNet forward with int8_fuse_gn: {int8_ms:.3f} ms "
          f"(bf16 on K1 + K5 {bf16_ms:.3f} ms), launches {counts}; vs bf16:"
          f" mean rel err {rel:.3e}, correlation {corr:.6f} (>= 0.9)",
          flush=True)
    return {"int8_ms": int8_ms, "bf16_ms": bf16_ms, "mean_rel_err": rel,
            "correlation": corr}


def gn_entry(name, kid, source, replaces, tpu_kernel, rows, launches,
             by_path, unit):
    """The kernels-line entry for K5, K6 or K7: times summed over the
    halves of one UNet forward at the sampling shapes, per-site rows
    beside them."""
    ops_ms = sum(r["ops"] / PEAK_FLOPS["bfloat16" if kid == "K7"
                                       else "float32"] * 1e3 for r in rows)
    bytes_ms = sum(r["bytes"] / PEAK_BYTES * 1e3 for r in rows)
    return {
        "name": name, "id": kid, "route": "cuda", "source": source,
        "replaces": replaces, "tpu_kernel": tpu_kernel,
        "launches": launches, "launches_by_path": by_path, "checked": True,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in rows),
        "device_ms": _sum(rows, "device_ms"),
        "device_ms_by_kernel": _kernels_summed(rows),
        "host_us_per_call": _sum(rows, "host_us") / len(rows),
        "kernels_per_call": sorted({round(r["kernels_per_call"], 2)
                                    for r in rows
                                    if r["kernels_per_call"] is not None}),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
        "library_note": "no single PyTorch call computes this function; "
                        "bf16_composition_ms times the PyTorch calls it "
                        "replaces",
        "bf16_composition_ms": sum(r["bf16_composition_ms"] for r in rows),
        "unit": unit, "shapes": rows,
    }


# ---------------------------------------------------------------------------
# the padded-attention flags: K8, K9 (use_fused_projs) and K11
# (use_padded_attention without fused norms), phases 19-23
# ---------------------------------------------------------------------------
# tools/perf/acc_check.py:62-67, variant B: fused norms without padded
# attention, K13 + K4 (fault F1 built K3 + K4); without the fused projs of
# the masters' config, which need padded attention
VARIANT_B_FLAGS = dict(use_fused_attention=True, use_int8_conv=True,
                       int8_act_scale=0.05, use_int8_ff=True,
                       use_fused_ff=True, int8_attn_act_scale=0.1,
                       use_int8_attention=True, use_fused_norms=True,
                       use_fused_projs=False)
# the Transformer2D of each INT8_SHAPES entry; the ragged T = 30 (the KITTI
# mid block) on the first level's weights goes to the fallbacks
PADDED_SITES = ["down_blocks.0.attentions.0", "down_blocks.1.attentions.0",
                "down_blocks.2.attentions.0", "mid_block.attentions.0"]
RAGGED_T = 30


def _projs_trainer(seed: int = 0):
    """An int8 trainer with ``UNetConfig.use_fused_projs`` and seeded
    weights; the Transformer2D proj biases and the transformer blocks'
    LayerNorm rows and ``to_out`` biases drawn too (the init leaves them 0
    or 1, so a dropped bias would not show)."""
    import torch
    from ldmseg_torch.tools.profile_sampling import unet_config_for
    from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
    trainer = TrainerDiffusion(_int8_config(),
                               unet_config=unet_config_for(projs=True))
    trainer.init_params(seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 200)
    with torch.no_grad():
        for name, p in trainer.unet.named_parameters():
            if ".attentions." not in name:
                continue
            if name.endswith(("norm1.weight", "norm3.weight")):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=gen,
                                                device="cuda"))
            elif name.endswith(("proj_in.bias", "proj_out.bias",
                                "norm1.bias", "norm3.bias", "to_out.0.bias")):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen,
                                          device="cuda"))
    return trainer


def pin_bound_ms(b: int, t: int, c: int):
    """K8's bound: K3's plus the prologue's 2·T·C² bf16 operations per
    image and its bf16 weight and fp32 bias; x is read once either way."""
    _, _, ops8, ops16, nbytes = ln_attention_bound_ms(b, t, c)
    ops16 += 2.0 * b * t * c * c
    nbytes += 2 * c * c + 4 * c
    t_ops = (ops8 / PEAK_FLOPS["int8"] + ops16 / PEAK_FLOPS["bfloat16"]) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", ops8, ops16, nbytes)


def pout_bound_ms(b: int, t: int, c: int):
    """K9's bound: K4's plus the epilogue's 2·T·C² bf16 operations per
    image and its bf16 weight and fp32 bias."""
    _, _, ops8, nbytes = geglu_ln_bound_ms(b, t, c)
    ops16 = 2.0 * b * t * c * c
    nbytes += 2 * c * c + 4 * c
    t_ops = (ops8 / PEAK_FLOPS["int8"] + ops16 / PEAK_FLOPS["bfloat16"]) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", ops8, ops16, nbytes)


def padded_bound_ms(b: int, t: int, c: int, heads: int = 8):
    """K11's bound: four int8 projections (q, k, v, to_out) of 2·T·C² and
    two int8 products (QKᵀ, e8·V) of 2·H·T²·d per image at the int8 peak,
    against bf16 x in, the int8 weights, the float rows and bf16 out."""
    d = c // heads
    ops8 = 4 * 2.0 * b * t * c * c + 2 * 2.0 * b * heads * t * t * d
    nbytes = 2 * b * t * c + 4 * c * c + 4 * (3 * c + heads) + 2 * b * t * c
    t_ops = ops8 / PEAK_FLOPS["int8"] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", ops8, 0.0, float(nbytes))


def _fallback_row(name, shape, fn, wrapper):
    """A shape the JAX rule sends to the fallback: one call, counted as a
    fallback and no launch, finite."""
    import torch
    launches, fallbacks = wrapper.launches, wrapper.fallbacks
    out = fn()
    torch.cuda.synchronize()
    check(wrapper.fallbacks == fallbacks + 1
          and wrapper.launches == launches
          and bool(torch.isfinite(out.float()).all()),
          f"{name} {shape}: the rule's fallback was not taken or not finite")
    return {"shape_btc": list(shape), "per_unet_forward": 0,
            "fallback": True, "ms": time_ms(fn, iters=5, warmup=1)}


def _proj_in_check(xg, p8):
    """K8's prologue alone (``ops/attention_s8.py:proj_in_f32``) on the
    GroupNorm's tokens view ``xg`` (read channel-major) and on the same
    tokens made contiguous, against ``x·Wpiᵀ + b_pi`` by ``torch.matmul``
    in fp32 (TF32 off): within FP32_ATOL of max|ref| (the sums in another
    order; the bf16 products are exact in fp32). Returns the larger
    error relative to max|ref|."""
    import torch
    from ldmseg_torch.ops import attention_s8 as S8
    b, t, c = xg.shape
    ref = (torch.matmul(xg.float().reshape(b * t, c), p8.wpi.float().t())
           + p8.bpi)
    rmax = ref.abs().max().item()
    worst = 0.0
    for layout, x in (("channel-major", xg), ("tokens", xg.contiguous())):
        err = (S8.proj_in_f32(x, p8) - ref).abs().max().item()
        check(math.isfinite(err) and err <= FP32_ATOL * rmax,
              f"K8 prologue ({layout}) {tuple(xg.shape)}: max abs err {err} "
              f"> {FP32_ATOL} x max|ref| {rmax}")
        worst = max(worst, err / rmax)
    return worst


def phase_padded_kernels(trainer, seed: int = 13):
    """K8, K9 and K11 against their plain versions on the card with the
    UNet's own weights (the fused-projs int8 UNet's packs for K8 and K9,
    for K11 the pack that the K11 UNet's ``prepare`` makes from the same
    masters) at every shape of a forward, and a ragged T that the rule
    sends to each fallback. Beside each, the PyTorch composition it
    replaces: for K8 the bf16 ``proj_in`` conv, the permute and K3; for K9
    K4, the permute and the ``proj_out`` conv; for K11 bf16 projections,
    SDPA and ``to_out``, and (``k13_block_ms``) the float projections
    around K13."""
    import torch
    import torch.nn.functional as F
    from ldmseg_torch.models.unet import CrossAttention
    from ldmseg_torch.ops import attention_s8 as S8
    from ldmseg_torch.ops import geglu as G

    int8 = trainer.int8_unet()
    bf16 = trainer.inference_unet()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = {"K8": [], "K9": [], "K11": []}
    shapes = [(s, n, site) for (s, n), site in zip(INT8_SHAPES,
                                                   PADDED_SITES)]
    for shape, per_fwd, site in shapes + [((2, RAGGED_T, 320), 0,
                                           PADDED_SITES[0])]:
        b, t, c = shape
        t2d = int8.get_submodule(site)
        blk = t2d.transformer_blocks[0]
        p8, p9 = blk.attn1.pack, blk.ff.pack
        p11 = S8.pack_padded_attention(
            trainer.unet.get_submodule(site).transformer_blocks[0].attn1, 8,
            0.1)
        attn = bf16.get_submodule(site).transformer_blocks[0].attn1
        x_nchw = torch.randn((b, c, t, 1), generator=gen,
                             device="cuda").to(torch.bfloat16)
        xg = x_nchw.reshape(b, c, t).transpose(1, 2)   # the GN's tokens
        xs = torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        with torch.inference_mode():
            if not per_fwd:
                rows["K8"].append(_fallback_row(
                    "K8", shape, lambda: S8.ln_attention_s8_pin(xg, p8),
                    S8.ln_attention_s8_pin))
                rows["K9"].append(_fallback_row(
                    "K9", shape, lambda: G.geglu_ln_s8_pout(xs, p9),
                    G.geglu_ln_s8_pout))
                rows["K11"].append(_fallback_row(
                    "K11", shape, lambda: S8.padded_attention_s8(xs, p11),
                    S8.padded_attention_s8))
                continue

            def k8_composition():
                y = t2d.proj_in(x_nchw).permute(0, 2, 3, 1).reshape(b, t, c)
                return S8.ln_attention_s8(y, p8)

            def k9_composition():
                y = G.geglu_ln_s8(xs, p9)
                return t2d.proj_out(y.reshape(b, t, 1, c).permute(0, 3, 1, 2))

            def sdpa_block():
                q, k, v = (m(xs).reshape(b, t, 8, -1).transpose(1, 2)
                           for m in (attn.to_q, attn.to_k, attn.to_v))
                o = F.scaled_dot_product_attention(q, k, v)
                return attn.to_out[0](o.transpose(1, 2).reshape(b, t, c))

            k13 = CrossAttention(c, 8, use_fused=True, int8=True,
                                 int8_act_scale=0.1).to("cuda",
                                                        torch.bfloat16)
            k13.load_state_dict(attn.state_dict())
            for kid, fn, ref, comp, bound, pack in (
                    ("K8", lambda: S8.ln_attention_s8_pin(xg, p8),
                     lambda: S8.ln_attention_s8_pin_reference(xg, p8),
                     k8_composition, pin_bound_ms(b, t, c), p8),
                    ("K9", lambda: G.geglu_ln_s8_pout(xs, p9),
                     lambda: G.geglu_ln_s8_pout_reference(xs, p9),
                     k9_composition, pout_bound_ms(b, t, c), p9),
                    ("K11", lambda: S8.padded_attention_s8(xs, p11),
                     lambda: S8.padded_attention_s8_reference(xs, p11),
                     sdpa_block, padded_bound_ms(b, t, c), p11)):
                out = fn()
                torch.cuda.synchronize()
                row = _int8_row(kid, shape, per_fwd, out, ref(), fn, ref,
                                comp, bound)
                if kid == "K11":
                    row["k13_block_ms"] = time_ms(lambda: k13(xs))
                if kid in ("K8", "K9", "K11"):
                    row["device_ms"], row["stages_device_ms"] = (
                        _stage_split(fn, _stages(kid)))
                if kid == "K9":
                    # proj_out's library yardstick: F.linear on operands of
                    # its shapes (cuBLAS), never called by the port
                    r2 = xs.reshape(b * t, c)
                    row["proj_out_linear_device_ms"] = device_ms(
                        lambda: F.linear(r2, p9.wpo), ALL_KERNELS,
                        whole_call=True)
                if kid == "K8":
                    row["proj_in_max_abs_err"] = _proj_in_check(xg, p8)
                rows[kid].append(row)
                print(f"phase 19 {kid} {shape} ({site}): err "
                      f"{row['max_abs_err']:.3e} of max|ref| "
                      f"{row['max_abs_ref']:.3e}, mean "
                      f"{row['mean_abs_err']:.3e} of {row['mean_abs_ref']:.3e}"
                      f"; kernel {row['ms']:.4f} ms, plain "
                      f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f}"
                      f" ms ({row['bound_by']}), composition "
                      f"{row['bf16_block_ms']:.4f} ms"
                      + (f", float projections + K13 "
                         f"{row['k13_block_ms']:.4f} ms"
                         if kid == "K11" else "")
                      + (f"; device {_ms(row.get('device_ms'))}: "
                         f"{row.get('stages_device_ms')}"
                         if kid in ("K8", "K9", "K11") else "")
                      + (f", F.linear on proj_out's operands (cuBLAS) "
                         f"device {_ms(row['proj_out_linear_device_ms'])}"
                         if kid == "K9" else "")
                      + (f"; the prologue alone against torch.matmul (fp32)"
                         f", tokens and channel-major: max abs err "
                         f"{row['proj_in_max_abs_err']}"
                         if kid == "K8" else ""), flush=True)
    for kid, rs in rows.items():
        fb = [r for r in rs if r.get("fallback")]
        print(f"phase 19 {kid} T={RAGGED_T}: the rule's fallback, "
              f"{fb[0]['ms']:.4f} ms", flush=True)
    return rows


def _unet_vs_bf16(label, phase, unet, bf16, expect, seed: int = 1,
                  reference_ms=None):
    """One forward of ``unet`` at full width against the bf16 UNet on K1 of
    the same masters (the input of phase 3): the launches of that forward
    checked against ``expect``, no fallback, correlation >= 0.9, ms per
    forward."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((2, bf16.config.in_channels, 32, 64), generator=gen,
                    device="cuda").to(torch.bfloat16)
    t = torch.tensor([999, 19], device="cuda")
    with torch.inference_mode():
        ref = bf16(x, t).float()
        _zero_counts()
        out = unet(x, t).float()
        torch.cuda.synchronize()
        counts = _counts()
        ms = time_ms(lambda: unet(x, t), iters=10)
        bf16_ms = time_ms(lambda: bf16(x, t), iters=10)
    check(counts == _expect(**expect), f"{label} forward launched {counts}, "
          f"expected {expect} and 0 fallbacks")
    check(bool(torch.isfinite(out).all()), f"{label} output not finite")
    rel = ((out - ref).abs().mean() / ref.abs().mean()).item()
    corr = torch.corrcoef(torch.stack([out.flatten(), ref.flatten()]))[
        0, 1].item()
    check(corr >= 0.9, f"{label} vs bf16: correlation {corr} < 0.9")
    extra = ("" if reference_ms is None else
             f", phase 8's int8 UNet (K3 + K4) {reference_ms:.3f} ms")
    print(f"phase {phase} {label} forward, [2, 12, 32, 64]: {ms:.3f} ms "
          f"(bf16 on K1 {bf16_ms:.3f} ms{extra}), launches {counts}; vs "
          f"bf16: mean rel err {rel:.3e}, correlation {corr:.6f} (>= 0.9)",
          flush=True)
    return {"ms": ms, "bf16_ms": bf16_ms, "mean_rel_err": rel,
            "correlation": corr, "counts": counts}


def phase_padded_sample(unet, seed: int = 2, steps: int = SAMPLE_STEPS):
    """The port's ``ddim_sample`` with self-conditioning on the K11 UNet, 50
    steps at batch 2 on a 32x64 latent (random RGB latents): 320 K11 and
    320 K12 launches, 0 of every other kernel, no fallback."""
    import torch
    from ldmseg_torch.tools.profile_sampling import padded_sample
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rgb, noise = (torch.randn((2, 4, 32, 64), generator=gen, device="cuda")
                  for _ in range(2))
    rgb = rgb.to(torch.bfloat16)
    padded_sample(unet, rgb, noise, steps=2)   # warm-up
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    x0 = padded_sample(unet, rgb, noise, steps=steps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts()
    want = _expect(K11=16 * steps, K12=16 * steps)
    check(counts == want, f"K11 ddim_sample launched {counts}, expected "
          f"{want}")
    check(tuple(x0.shape) == (2, 4, 32, 64)
          and bool(torch.isfinite(x0).all()), "K11 ddim_sample x0")
    print(f"phase 23 K11 UNet ddim_sample: {steps} DDIM steps, [2, 4, 32, "
          f"64]: {secs:.3f} s, launches {counts}", flush=True)
    return counts, {"seconds": secs}


# ---------------------------------------------------------------------------
# use_packed_attention: K14, K15, and K10 as an op (phases 24-28)
# ---------------------------------------------------------------------------
# (B, T, C) of K14's launches in one UNet forward (8 heads) on a 32x64 latent
# at batch 2, and on a 24x80 latent at batch 8 (the training shapes; the
# rule sends the mid block's T = 30 to the fallback), with the number of
# launches of each; K15's are the sampling ones
K14_SHAPES = [((2, 2048, 320), 5), ((2, 512, 640), 5), ((2, 128, 1280), 5),
              ((2, 32, 1280), 1)]
K14_TRAIN_SHAPES = [((8, 1920, 320), 5), ((8, 480, 640), 5),
                    ((8, 120, 1280), 5)]
PACKED_TIMED_STEPS = 3


def _packed_trainer(cfg, seed: int = 0, **kw):
    """A trainer with ``UNetConfig.use_packed_attention`` and seeded
    weights."""
    from ldmseg_torch.tools.profile_sampling import unet_config_for
    from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
    trainer = TrainerDiffusion(cfg, unet_config=unet_config_for(packed=True),
                               **kw)
    trainer.init_params(seed=seed)
    return trainer


def _head_view(x, heads: int = 8):
    """``[B, T, C]`` -> ``[B, T, H, D]``, a view."""
    return x.unflatten(-1, (heads, x.shape[-1] // heads))


def k15_bound_ms(b: int, t: int, c: int, heads: int = 8):
    """K15's bound for one call: K13's 2·2·BH·T²·D int8 operations against
    the bf16 q, k, v it reads (the quantize is its own) and the bf16
    output."""
    d = c // heads
    ops = 2.0 * 2 * b * heads * t * t * d
    nbytes = 3 * 2.0 * b * t * c + 2.0 * b * t * c
    t_ops = ops / PEAK_FLOPS["int8"] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", ops, nbytes)


def ln_padded_bound_ms(b: int, t: int, c: int, heads: int = 8):
    """K10's bound with ``v_bf16=False``: K11's int8 operations (four
    projections, QKᵀ and e8·V) against bf16 x in, the int8 weights, the
    LN, bias and scale rows and the bf16 output."""
    _, _, ops8, _, nbytes = padded_bound_ms(b, t, c, heads)
    nbytes += 4 * 3 * c
    t_ops = ops8 / PEAK_FLOPS["int8"] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", ops8, 0.0, nbytes)


# F2: the int8 blocks' LN + quantize codes against the plain version's: +-1,
# at no more than LN_CODE_FLIPS of them, each where the plain hn / xs lies
# within LN_TIE_ULPS ulps of a .5 (the order of a row's sums is the one
# difference; tests/test_torch_port_gn_sm90_card.py)
LN_CODE_FLIPS, LN_TIE_ULPS = 1e-4, 8


def _code_flips(label, x8, ref8, t):
    """Check ``x8`` against ``ref8`` by F2's rule, ``t`` the plain hn / xs;
    return the flips and their largest distance from a .5 in ulps."""
    import torch
    d = (x8.int() - ref8.int()).abs()
    flipped = d > 0
    n = int(flipped.sum().item())
    dist = 0.0
    if n:
        t = t[flipped].abs()
        ulp = torch.nextafter(t, torch.full_like(t, float("inf"))) - t
        dist = ((t - (torch.floor(t) + 0.5)).abs() / ulp).max().item()
    check(int(d.max().item()) <= 1 and n <= LN_CODE_FLIPS * x8.numel()
          and dist <= LN_TIE_ULPS,
          f"{label}: LN + quantize codes off by up to {int(d.max().item())}"
          f" at {n} of {x8.numel()}, {dist} ulps from a .5")
    return n, dist


def phase_packed_kernels(seed: int = 17):
    """K14, K15 and K10 against their plain versions on the card. K14 in
    bf16 and fp32 at the four shapes of the sampling path's forward and the
    three of the training path's, beside SDPA on the same q, k, v; its
    backward, K2 on the head views, at the training shapes beside SDPA's
    backward; K15 on bf16 q, k, v (its dynamic scales) at the sampling
    shapes, beside SDPA and K13 on the head views; K10 in both ``v_bf16``
    variants at the int8 shapes, beside K3 on the same pack (``v_bf16``) or
    LN + K11 + the residual and bias, with F2's code check (the codes of
    the LN + quantize stage, ``ops/attention_s8.py:ln_quant_s8``, against
    the plain ones; K10 without ``v_bf16`` also against the plain steps fed
    those codes); and a ragged T = 30 that each rule sends to its
    fallback."""
    import torch
    import torch.nn.functional as F
    from ldmseg_torch.ops import attention as A
    from ldmseg_torch.ops import attention_s8 as S8

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = {"K14": [], "K14 training": [], "K14 backward": [], "K15": [],
            "K10 v_bf16": [], "K10 s8": []}
    k10_checked = 0

    def rand(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    with torch.inference_mode():
        for group, shapes in (("K14", K14_SHAPES),
                              ("K14 training", K14_TRAIN_SHAPES)):
            for shape, per in shapes:
                b, t, c = shape
                for dtype in (torch.bfloat16, torch.float32):
                    q, k, v = (rand(shape, dtype) for _ in range(3))
                    scale = (c // 8) ** -0.5
                    before = A.fused_self_attention_packed.launches
                    out = A.fused_self_attention_packed(q, k, v, 8, scale)
                    torch.cuda.synchronize()
                    ref = A.packed_attention_reference(q, k, v, 8, scale)
                    err = (out.float() - ref.float()).abs().max().item()
                    dname = str(dtype).split(".")[-1]
                    tol = BF16_ATOL if dtype == torch.bfloat16 else FP32_ATOL
                    check(A.fused_self_attention_packed.launches
                          == before + 1 and math.isfinite(err)
                          and err <= tol,
                          f"K14 {shape} {dname}: max abs err {err} > {tol}")
                    del ref
                    ms = time_ms(lambda: A.fused_self_attention_packed(
                        q, k, v, 8, scale))
                    plain_ms = time_ms(lambda: A.packed_attention_reference(
                        q, k, v, 8, scale), iters=5, warmup=1)
                    qt, kt, vt = (_head_view(x).transpose(1, 2)
                                  for x in (q, k, v))
                    sdpa = lambda: F.scaled_dot_product_attention(  # noqa
                        qt, kt, vt, scale=scale)
                    lib_ms = time_ms(sdpa)
                    dev_ms = device_ms(lambda: A.fused_self_attention_packed(
                        q, k, v, 8, scale), K1_KERNEL)
                    lib_dev_ms = device_ms(sdpa, SDPA_KERNELS)
                    bound, by, flops, nbytes = attention_bound_ms(
                        (b, t, 8, c // 8), dname)
                    rows[group].append({
                        "shape_btc": list(shape), "dtype": dname,
                        "per_unet_forward": per if dname == "bfloat16"
                        else 0, "max_abs_err": err, "ms": ms,
                        "device_ms": dev_ms, "plain_ms": plain_ms,
                        "library_ms": lib_ms,
                        "library_device_ms": lib_dev_ms,
                        "bound_ms": bound, "bound_by": by, "flops": flops,
                        "bytes": nbytes})
                    print(f"phase 24 {group} {shape} {dname}: err "
                          f"{err:.3e} (tol {tol}), kernel {ms:.4f} ms "
                          f"(device {_ms(dev_ms)}), plain {plain_ms:.4f} "
                          f"ms, sdpa {lib_ms:.4f} ms (device "
                          f"{_ms(lib_dev_ms)}), bound {bound:.4f} ms ({by})",
                          flush=True)
                    del q, k, v, qt, kt, vt, out
        ragged = [rand((8, RAGGED_T, 1280)) for _ in range(3)]
        rows["K14"].append(_fallback_row(
            "K14", (8, RAGGED_T, 1280),
            lambda: A.fused_self_attention_packed(*ragged, 8, 0.08),
            A.fused_self_attention_packed))

        for shape, per in K14_SHAPES + [((2, RAGGED_T, 1280), 0)]:
            b, t, c = shape
            q, k, v = (rand(shape) for _ in range(3))
            scale = (c // 8) ** -0.5
            if not per:
                rows["K15"].append(_fallback_row(
                    "K15", shape, lambda: S8.fused_self_attention_packed_s8(
                        q, k, v, 8, scale), S8.fused_self_attention_packed_s8))
                continue
            qt, kt, vt = (_head_view(x).transpose(1, 2) for x in (q, k, v))
            qh, kh, vh = (_head_view(x) for x in (q, k, v))
            out = S8.fused_self_attention_packed_s8(q, k, v, 8, scale)
            torch.cuda.synchronize()
            row = _int8_row(
                "K15", shape, per, out,
                S8.fused_self_attention_packed_s8_reference(q, k, v, 8,
                                                            scale),
                lambda: S8.fused_self_attention_packed_s8(q, k, v, 8, scale),
                lambda: S8.fused_self_attention_packed_s8_reference(
                    q, k, v, 8, scale),
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       scale=scale),
                k15_bound_ms(b, t, c))
            row["k13_ms"] = time_ms(lambda: S8.fused_self_attention_s8(
                qh, kh, vh, scale))
            row["device_ms"], row["stages_device_ms"] = _stage_split(
                lambda: S8.fused_self_attention_packed_s8(q, k, v, 8, scale),
                _stages("K15"))
            rows["K15"].append(row)
            print(f"phase 24 K15 {shape}: err {row['max_abs_err']:.3e} of "
                  f"max|ref| {row['max_abs_ref']:.3e}, mean "
                  f"{row['mean_abs_err']:.3e} of {row['mean_abs_ref']:.3e}; "
                  f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} "
                  f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
                  f"sdpa {row['bf16_block_ms']:.4f} ms, K13 on the head "
                  f"views {row['k13_ms']:.4f} ms; device "
                  f"{_ms(row['device_ms'])}: {row['stages_device_ms']}",
                  flush=True)

        for shape, per in INT8_SHAPES + [((2, RAGGED_T, 320), 0)]:
            b, t, c = shape
            norm1, attn, _, _ = _block_modules(c, seed=t + c + 2)
            pack = S8.pack_ln_attention_rowmajor(norm1, attn, 8, 0.1)
            n1 = norm1.to(torch.bfloat16)
            out_b = pack.ln.out_b.to(torch.bfloat16)
            x = rand(shape)
            if per:  # F2: the codes of K10's (and K3's, K4's) LN + quantize
                ln, xs = pack.ln, pack.padded.xs
                x8 = S8.ln_quant_s8(x, ln.ln_w, ln.ln_b, xs, ln.eps)
                hn = S8._layer_norm(x.float(), ln.ln_w, ln.ln_b, ln.eps)
                flips, ulps = _code_flips(
                    f"K10 {shape}", x8,
                    S8.ln_quant_reference(x, ln.ln_w, ln.ln_b, xs, ln.eps),
                    hn / torch.full((), xs, device="cuda"))
                print(f"phase 24 F2 {shape}: LN + quantize codes off by one "
                      f"at {flips} of {x8.numel()} (<= {LN_CODE_FLIPS}), "
                      f"{ulps:.1f} ulps from a .5 at most (<= "
                      f"{LN_TIE_ULPS})", flush=True)
            for v_bf16, key in ((True, "K10 v_bf16"), (False, "K10 s8")):
                def fn(v_bf16=v_bf16):
                    return S8.ln_attention_s8_rowmajor(x, pack, v_bf16)
                if not per:
                    rows[key].append(_fallback_row(
                        f"K10 v_bf16={v_bf16}", shape, fn,
                        S8.ln_attention_s8_rowmajor))
                    continue
                if v_bf16:
                    def composition():
                        return S8.ln_attention_s8(x, pack.ln)
                    bound = ln_attention_bound_ms(b, t, c)
                else:
                    def composition():
                        return x + (S8.padded_attention_s8(n1(x), pack.padded)
                                    + out_b)
                    bound = ln_padded_bound_ms(b, t, c)
                out = fn()
                torch.cuda.synchronize()
                k10_checked += 1
                row = _int8_row(
                    f"K10 v_bf16={v_bf16}", shape, per, out,
                    S8.ln_attention_s8_rowmajor_reference(x, pack, v_bf16),
                    fn, lambda v_bf16=v_bf16:
                    S8.ln_attention_s8_rowmajor_reference(x, pack, v_bf16),
                    composition, bound)
                row["v_bf16"] = v_bf16
                row["ln_code_flips"], row["ln_flip_ulps"] = flips, ulps
                if not v_bf16:
                    row["device_ms"], row["stages_device_ms"] = (
                        _stage_split(fn, _stages("K10")))
                    # the plain steps fed the kernel's own codes
                    own = S8.ln_attention_s8_rowmajor_reference(x, pack,
                                                                False, x8)
                    err = (out.float() - own.float()).abs()
                    emax, rmax = err.max().item(), own.float().abs().max(
                    ).item()
                    check(emax <= INT8_MAX_TOL * rmax
                          and err.mean().item() <= INT8_MEAN_TOL
                          * own.float().abs().mean().item(),
                          f"K10 v_bf16=False {shape} on its own codes: max "
                          f"abs err {emax} (max|ref| {rmax})")
                    row["own_codes_max_abs_err"] = emax
                rows[key].append(row)
                print(f"phase 24 K10 v_bf16={v_bf16} {shape}: err "
                      f"{row['max_abs_err']:.3e} of max|ref| "
                      f"{row['max_abs_ref']:.3e}, mean "
                      f"{row['mean_abs_err']:.3e} of {row['mean_abs_ref']:.3e}"
                      f"; kernel {row['ms']:.4f} ms, plain "
                      f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f}"
                      f" ms ({row['bound_by']}), "
                      f"{'K3' if v_bf16 else 'LN + K11 + residual'} "
                      f"{row['bf16_block_ms']:.4f} ms"
                      + ("" if v_bf16 else
                         f"; device {_ms(row['device_ms'])}: "
                         f"{row['stages_device_ms']}; against the plain "
                         f"steps on its own codes: max err "
                         f"{row['own_codes_max_abs_err']:.3e}"), flush=True)

    # K14's backward: autograd through the wrapper (K14, then K2 on the
    # head views) against the plain backward; each gradient within the
    # tolerance times its own max|ref| (phase 5's rule)
    for shape, per, dtype in ([(s, n, torch.bfloat16)
                               for s, n in K14_TRAIN_SHAPES]
                              + [((8, 480, 640), 0, torch.float32)]):
        b, t, c = shape
        q, k, v, do = (rand(shape, dtype) for _ in range(4))
        scale = (c // 8) ** -0.5
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        before = (A.fused_self_attention_packed.launches,
                  A.fused_self_attention_backward.launches)
        A.fused_self_attention_packed(*leaves, 8, scale).backward(do)
        torch.cuda.synchronize()
        check((A.fused_self_attention_packed.launches,
               A.fused_self_attention_backward.launches)
              == (before[0] + 1, before[1] + 1),
              f"K14 backward {shape}: not K14 then K2")
        views = [_head_view(x) for x in (q, k, v, do)]
        refs = A.attention_backward_reference(*views, scale)
        dname = str(dtype).split(".")[-1]
        rtol = BF16_ATOL if dtype == torch.bfloat16 else FP32_ATOL
        err = 0.0
        for gname, leaf, r in zip(("dQ", "dK", "dV"), leaves, refs):
            e = (leaf.grad.float() - r.reshape(b, t, c).float()).abs().max(
            ).item()
            m = r.float().abs().max().item()
            check(m > 0 and math.isfinite(e) and e <= rtol * m,
                  f"K14 backward {shape} {dname} {gname}: max abs err {e} > "
                  f"{rtol} x max|ref| {m}")
            err = max(err, e)
        del refs, leaves
        k2 = lambda: A.fused_self_attention_backward(  # noqa: E731
            *views, scale)
        ms = time_ms(k2, iters=10)
        dev = k2_device_ms(k2)
        plain_ms = time_ms(lambda: A.attention_backward_reference(
            *views, scale), iters=5, warmup=1)
        lib = sdpa_backward(*views, scale)
        lib_ms = time_ms(lib, iters=10)
        lib_dev_ms = device_ms(lib, ALL_KERNELS, whole_call=True, iters=10)
        del lib
        bound, by, flops, nbytes = attention_bound_ms((b, t, 8, c // 8),
                                                      dname, 5, 7)
        rows["K14 backward"].append({
            "shape_btc": list(shape), "dtype": dname,
            "per_unet_backward": per, "max_abs_err": err, "ms": ms, **dev,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_device_ms": lib_dev_ms, "bound_ms": bound,
            "bound_by": by, "flops": flops, "bytes": nbytes})
        print(f"phase 24 K14 backward (K2 on the head views) {shape} "
              f"{dname}: max err {err:.3e} (tol {rtol} x max|ref|), kernel "
              f"{ms:.4f} ms (device {_ms(dev['device_ms'])}: stats "
              f"{_ms(dev['stats_device_ms'])} + main "
              f"{_ms(dev['main_device_ms'])}), plain {plain_ms:.4f} ms, "
              f"sdpa-bwd {lib_ms:.4f} ms (device {_ms(lib_dev_ms)}), bound "
              f"{bound:.4f} ms ({by})", flush=True)
    for key in ("K14", "K15", "K10 v_bf16", "K10 s8"):
        fb = [r for r in rows[key] if r.get("fallback")]
        print(f"phase 24 {key} {tuple(fb[0]['shape_btc'])}: the rule's "
              f"fallback, {fb[0]['ms']:.4f} ms", flush=True)
    return rows, k10_checked


def phase_packed_unet(trainer, seed: int = 1):
    """The full-width bf16 UNet with ``use_packed_attention`` against the
    same module on K1 (``packed`` off; phase 3's input): 16 K14, no K1, no
    fallback, within phase 3's tolerance."""
    import torch
    from ldmseg_torch.models.unet import CrossAttention
    unet = trainer.inference_unet()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((2, unet.config.in_channels, 32, 64), generator=gen,
                    device="cuda").to(torch.bfloat16)
    t = torch.tensor([999, 19], device="cuda")
    attn = [m for m in unet.modules() if isinstance(m, CrossAttention)]
    with torch.inference_mode():
        _zero_counts()
        packed = unet(x, t).float()
        torch.cuda.synchronize()
        counts = _counts()
        packed_ms = time_ms(lambda: unet(x, t), iters=10)
        for m in attn:
            m.packed = False
        try:
            k1 = unet(x, t).float()
            k1_ms = time_ms(lambda: unet(x, t), iters=10)
        finally:
            for m in attn:
                m.packed = True
    check(counts == _expect(K14=16), f"packed UNet forward launched "
          f"{counts}, expected 16 K14 and nothing else")
    check(bool(torch.isfinite(packed).all()), "packed UNet not finite")
    rel = ((packed - k1).abs().max() / k1.abs().max()).item()
    check(rel <= 2e-2, f"UNet on K14 vs K1: max rel err {rel}")
    print(f"phase 25 UNet forward with use_packed_attention, [2, 12, 32, "
          f"64]: K14 path {packed_ms:.3f} ms, K1 path {k1_ms:.3f} ms, max "
          f"rel err {rel:.3e} (tol 2e-2), launches {counts}", flush=True)
    return {"packed_ms": packed_ms, "k1_ms": k1_ms, "max_rel_err": rel,
            "counts": counts}


def phase_packed_train(smi_line: str, seed: int = 0,
                       timed: int = PACKED_TIMED_STEPS):
    """``train_loop`` with ``use_packed_attention`` as phase 6 (2 warm-up and
    ``timed`` steps): per step 30 K14 and 2 fallbacks (two forwards of 15
    sites; the rule sends the mid block's T = 30 away), 15 K2, no K1; then
    one step's loss and gradients against the same step on the plain
    attention, and a gradient on every ``to_q``."""
    import torch
    from ldmseg_torch.data.loader import Loader
    from ldmseg_torch.data.synthetic import SyntheticDVPS
    from ldmseg_torch.models.unet import CrossAttention

    ds = SyntheticDVPS(length=2 * TRAIN_BATCH, size=TRAIN_HW, num_bits=8)
    trainer = _packed_trainer(_train_config(), seed, dataset=ds)
    trainer.train_loop(max_steps=WARMUP_STEPS, log_every=WARMUP_STEPS,
                       seed=seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    losses = trainer.train_loop(max_steps=timed, log_every=timed,
                                seed=seed + 1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    want = _expect(K14=30 * timed, K2=15 * timed)
    want["fallbacks"] = 2 * timed
    check(counts == want, f"packed train steps launched {counts}, expected "
          f"{want}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    print(f"phase 27 train_loop with use_packed_attention: {timed} steps, "
          f"batch {TRAIN_BATCH} x {TRAIN_HW[0]}x{TRAIN_HW[1]}: "
          f"{secs / timed:.4f} s/step, {TRAIN_BATCH * timed / secs:.3f} "
          f"samples/s, peak memory {peak / 2**30:.2f} GiB, launches "
          f"{counts} [{smi_line}]", flush=True)

    batch = next(iter(Loader(ds, TRAIN_BATCH, seed=seed + 2)))
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    lh, lw = TRAIN_HW[0] // 8, TRAIN_HW[1] // 8
    noise = torch.randn((TRAIN_BATCH, lh, lw, 4), generator=gen,
                        device="cuda")
    steps = torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen,
                          device="cuda")
    attn = [m for m in trainer.unet.modules()
            if isinstance(m, CrossAttention)]
    results = {}
    for packed in (True, False):
        for m in attn:
            m.packed = m.use_fused = packed
        trainer.state.zero_grad()
        loss, _, _ = trainer.forward_backward(batch, noise=noise,
                                              timesteps=steps)
        if packed:
            for m in attn:
                g = m.to_q.weight.grad
                check(g is not None and bool(torch.isfinite(g).all())
                      and g.abs().max().item() > 0,
                      "a to_q.weight.grad is missing, zero or not finite")
        results[packed] = (loss.item(), _flat_grads(trainer.unet))
    for m in attn:
        m.packed = m.use_fused = True
    (loss_k, g_k), (loss_p, g_p) = results[True], results[False]
    cos = (torch.dot(g_k, g_p) / (g_k.norm() * g_p.norm())).item()
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    del results, g_k, g_p, trainer
    check(loss_rel <= 1e-2, f"train loss on K14/K2 vs plain: rel "
          f"{loss_rel}")
    check(cos >= 0.99, f"gradient cosine on K14/K2 vs plain: {cos}")
    print(f"phase 27 one step on K14/K2 vs plain attention: loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (rel {loss_rel:.2e}, tol 1e-2), "
          f"gradient cosine {cos:.6f} (>= 0.99); every to_q.weight.grad "
          f"finite and non-zero ({len(attn)} layers)", flush=True)
    return counts, {"seconds_per_step": secs / timed,
                    "samples_per_s": TRAIN_BATCH * timed / secs,
                    "peak_bytes": peak, "losses": losses,
                    "loss_rel": loss_rel, "grad_cosine": cos}


def k14_entry(rows, launches, by_path):
    """The kernels-line entry for K14: times summed over the 16 launches of
    one UNet forward at the sampling shapes (bf16, batch 2), the training
    forward's rows and the backward (K2 on the head views, per UNet
    backward at batch 8) beside them."""
    return {
        "name": "attention_fwd_packed", "id": "K14", "route": "cuda",
        "source": "ldmseg_torch/csrc/attention_fwd.cu",
        "replaces": "ldmseg_tpu/ops/pallas/attention.py:1427",
        "tpu_kernel": "ldmseg_tpu/ops/pallas/attention.py:_attn_kernel_btc",
        "launches": launches, "launches_by_path": by_path, "checked": True,
        **_per_unit(rows["K14"], "per_unet_forward"),
        "unit": "one UNet forward (16 launches, bf16, batch 2, 32x64 latent)",
        "shapes": rows["K14"],
        "training_forward": {**_per_unit(rows["K14 training"],
                                         "per_unet_forward"),
                             "unit": "one UNet forward at batch 8, 24x80 "
                                     "(15 launches; T = 30 falls back)",
                             "shapes": rows["K14 training"]},
        "backward": {**_per_unit(rows["K14 backward"], "per_unet_backward"),
                     "unit": "one UNet backward at batch 8, 24x80 (15 K2 "
                             "launches on the head views)",
                     "shapes": rows["K14 backward"]},
    }



# ---------------------------------------------------------------------------
# use_absorbed_attention: K16, K17, and K18 as an op (phases 29-33)
# ---------------------------------------------------------------------------
# K16's launches are K14's shapes (the same sites); K17's and K18's the
# sampling ones. The weights of phase 29 have the std of a trained
# projection (0.05) so that the scores stay near 1.
ABSORBED_TIMED_STEPS = 3
ABSORBED_W_STD = 0.05
# variant (a)'s flags with use_absorbed_attention: the UNet of the
# absorbed-storage switch (prepare_int8_unet(..., absorbed_attention=True))
ABSORBED_A_FLAGS = dict(use_int8_conv=True, int8_act_scale=0.05,
                        use_int8_attention=True, use_fused_attention=True,
                        use_int8_ff=True, use_fused_ff=True,
                        int8_attn_act_scale=0.1)


def _absorbed_trainer(cfg, seed: int = 0, **kw):
    """A trainer with ``UNetConfig.use_absorbed_attention`` and seeded
    weights."""
    from ldmseg_torch.tools.profile_sampling import unet_config_for
    from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
    trainer = TrainerDiffusion(cfg, unet_config=unet_config_for(
        absorbed=True), **kw)
    trainer.init_params(seed=seed)
    return trainer


def absorbed_bound_ms(b: int, t: int, c: int, dtype_name: str):
    """K16's bound for one call: four projections of 2·B·T·C² and the
    attention's 2·2·B·T²·C operations at the type's peak, against x in, the
    four [C, C] weights and the output."""
    esize = 2 if dtype_name == "bfloat16" else 4
    flops = 4 * 2.0 * b * t * c * c + 2 * 2.0 * b * t * t * c
    nbytes = float(esize) * (2 * b * t * c + 4 * c * c)
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes)


def absorbed_bwd_bound_ms(b: int, t: int, c: int, dtype_name: str):
    """K16's backward: K2's five T x T products (2·B·T²·C each) and eight
    [T, C] x [C, C] products (dO_h = g·Wo, dx from dq, dk, dv, and the four
    weight gradients), against x, the four weights, the saved q, k, v, oh
    and g in, dx and the four weight gradients out."""
    esize = 2 if dtype_name == "bfloat16" else 4
    flops = 5 * 2.0 * b * t * t * c + 8 * 2.0 * b * t * c * c
    nbytes = float(esize) * (7 * b * t * c + 8 * c * c)
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes)


def absorbed_s8_bound_ms(b: int, t: int, c: int, heads: int = 8):
    """K17's and K18's bound: K16's operations on int8 at the int8 peak
    (the one-hot head picks of K18's TPU kernel are layout, no work),
    against bf16 x in, the int8 weights and their scales and bf16 out."""
    ops8 = 4 * 2.0 * b * t * c * c + 2 * 2.0 * b * t * t * c
    nbytes = 2 * b * t * c + 4 * c * c + 4 * 4 * heads + 2 * b * t * c
    t_ops = ops8 / PEAK_FLOPS["int8"] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", ops8, 0.0, float(nbytes))


def _absorbed_weights(gen, c, dtype):
    import torch
    return [(ABSORBED_W_STD * torch.randn((c, c), generator=gen,
                                          device="cuda")).to(dtype)
            for _ in range(4)]


def _absorbed_composition(x, ws, heads: int = 8):
    """What K16 replaces in PyTorch calls, in x's dtype: F.linear x 3, SDPA
    on the head views, F.linear."""
    import torch.nn.functional as F
    b, t, c = x.shape
    q, k, v = (F.linear(x, w).unflatten(-1, (heads, c // heads))
               .transpose(1, 2) for w in ws[:3])
    o = F.scaled_dot_product_attention(q, k, v, scale=(c // heads) ** -0.5)
    return F.linear(o.transpose(1, 2).reshape(b, t, c), ws[3])


def phase_absorbed_kernels(seed: int = 19):
    """K16, its backward, K17 and K18 against their plain versions on the
    card. K16 in bf16 and fp32 at the four shapes of the sampling path's
    forward and the three of the training path's, beside the bf16
    composition it replaces (F.linear x 3 + SDPA + F.linear); its backward
    (K2 on the head views of the saved q, k, v, the weight and input
    products in torch.matmul) at the training shapes against autograd
    through the plain version, beside the composition's backward; K17 and
    K18 on bf16 x at the sampling shapes, beside the same bf16 composition
    and float projections + K13 + F.linear; and a ragged T = 30 that the
    rule sends to each fallback."""
    import torch
    import torch.nn.functional as F
    from ldmseg_torch.ops import attention as A
    from ldmseg_torch.ops import attention_s8 as S8
    from ldmseg_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = {"K16": [], "K16 training": [], "K16 backward": [], "K17": [],
            "K18": []}

    def rand(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    with torch.inference_mode():
        for group, shapes in (("K16", K14_SHAPES),
                              ("K16 training", K14_TRAIN_SHAPES)):
            for shape, per in shapes:
                b, t, c = shape
                for dtype in (torch.bfloat16, torch.float32):
                    x = rand(shape, dtype)
                    ws = _absorbed_weights(gen, c, dtype)
                    scale = (c // 8) ** -0.5
                    before = A.absorbed_self_attention.launches
                    out = A.absorbed_self_attention(x, *ws, 8, scale)
                    torch.cuda.synchronize()
                    ref = A.absorbed_attention_reference(x, *ws, 8, scale)
                    err = (out.float() - ref.float()).abs().max().item()
                    rmax = ref.float().abs().max().item()
                    dname = str(dtype).split(".")[-1]
                    tol = BF16_ATOL if dtype == torch.bfloat16 else FP32_ATOL
                    check(A.absorbed_self_attention.launches == before + 1
                          and math.isfinite(err) and err <= tol * rmax,
                          f"K16 {shape} {dname}: max abs err {err} > {tol} "
                          f"x max|ref| {rmax}")
                    del ref
                    ms = time_ms(lambda: A.absorbed_self_attention(
                        x, *ws, 8, scale))
                    plain_ms = time_ms(lambda: A.absorbed_attention_reference(
                        x, *ws, 8, scale), iters=5, warmup=1)
                    comp_ms = time_ms(lambda: _absorbed_composition(x, ws))
                    k16 = lambda: A.absorbed_self_attention(  # noqa: E731
                        x, *ws, 8, scale)
                    dev_ms = device_ms(k16, ALL_KERNELS, K1_KERNEL)
                    attn_dev_ms = device_ms(k16, K1_KERNEL)
                    # bf16: the device time by stage (the Q/K/V product,
                    # the attention, to_out); fails if another kernel
                    # (the wmma product it left) runs in the call
                    stages = (_stage_split(k16, _stages("K16"))[1]
                              if dtype == torch.bfloat16 else None)
                    # the products' library yardstick: F.linear x 4
                    # (cuBLAS), device time
                    lin_dev_ms = (device_ms(
                        lambda: [F.linear(x, w) for w in ws], ALL_KERNELS,
                        whole_call=True) if dtype == torch.bfloat16
                        else None)
                    qt = (x.unflatten(-1, (8, c // 8)).transpose(1, 2)
                          .contiguous())
                    lib_dev_ms = device_ms(
                        lambda: F.scaled_dot_product_attention(
                            qt, qt, qt, scale=scale), SDPA_KERNELS)
                    bound, by, flops, nbytes = absorbed_bound_ms(b, t, c,
                                                                 dname)
                    rows[group].append({
                        "shape_btc": list(shape), "dtype": dname,
                        "per_unet_forward": per if dname == "bfloat16"
                        else 0, "max_abs_err": err, "max_abs_ref": rmax,
                        "ms": ms, "device_ms": dev_ms,
                        "attention_device_ms": attn_dev_ms,
                        "stages_device_ms": stages,
                        "linear_x4_device_ms": lin_dev_ms,
                        "plain_ms": plain_ms, "library_ms": None,
                        "library_device_ms": lib_dev_ms,
                        "composition_ms": comp_ms, "bound_ms": bound,
                        "bound_by": by, "flops": flops, "bytes": nbytes})
                    print(f"phase 29 {group} {shape} {dname}: err {err:.3e} "
                          f"(tol {tol} x max|ref| {rmax:.3e}), kernel "
                          f"{ms:.4f} ms (device {_ms(dev_ms)}, attention "
                          f"stage {_ms(attn_dev_ms)}; by stage {stages}; "
                          f"F.linear x 4 (device) {_ms(lin_dev_ms)}), "
                          f"plain {plain_ms:.4f} "
                          f"ms, F.linear x3 + sdpa + F.linear {comp_ms:.4f} "
                          f"ms, sdpa (device) {_ms(lib_dev_ms)}, bound "
                          f"{bound:.4f} ms ({by})", flush=True)
                    del qt
                    del x, ws, out
        ragged = rand((8, RAGGED_T, 1280))
        ragged_w = _absorbed_weights(gen, 1280, torch.bfloat16)
        rows["K16"].append(_fallback_row(
            "K16", (8, RAGGED_T, 1280),
            lambda: A.absorbed_self_attention(ragged, *ragged_w, 8, 0.08),
            A.absorbed_self_attention))

        for shape, per in K14_SHAPES + [((2, RAGGED_T, 1280), 0)]:
            b, t, c = shape
            _, attn, _, _ = _block_modules(c, seed=t + c + 3)
            wf = [m.weight for m in (attn.to_q, attn.to_k, attn.to_v,
                                     attn.to_out[0])]
            wb = [w.to(torch.bfloat16) for w in wf]
            x = rand(shape)
            scale = (c // 8) ** -0.5
            for kid, fn, codes in (
                    ("K17", S8.absorbed_self_attention_s8,
                     quant.quantize_head_weights(*wf, 8)),
                    ("K18", S8.absorbed_fullc_self_attention_s8,
                     quant.quantize_fullc_weights(*wf))):
                w_qkv = torch.cat(codes[:3]).contiguous()
                wo8, sc = codes[3], codes[4]
                wo_p = S8.head_padded_wo(wo8, 8)  # a pack's, made once

                def call(fn=fn, w_qkv=w_qkv, wo8=wo8, sc=sc, wo_p=wo_p):
                    return fn(x, w_qkv, wo8, sc, 8, scale, 0.1, wo_p)
                if not per:
                    rows[kid].append(_fallback_row(kid, shape, call, fn))
                    continue
                out = call()
                torch.cuda.synchronize()

                def plain(kid=kid, w_qkv=w_qkv, wo8=wo8, sc=sc):
                    return S8.absorbed_attention_s8_reference(
                        x, w_qkv, wo8, sc, 8, scale, 0.1,
                        per_image=kid == "K18")
                row = _int8_row(kid, shape, per, out, plain(), call, plain,
                                lambda: _absorbed_composition(x, wb),
                                absorbed_s8_bound_ms(b, t, c))

                def k13_block():
                    q, k, v = (F.linear(x, w).unflatten(-1, (8, c // 8))
                               for w in wb[:3])
                    o = S8.fused_self_attention_s8(q, k, v, scale)
                    return F.linear(o.reshape(b, t, c), wb[3])
                row["k13_block_ms"] = time_ms(k13_block)
                row["device_ms"], row["stages_device_ms"] = _stage_split(
                    call, _stages(kid))
                rows[kid].append(row)
                print(f"phase 29 {kid} {shape}: err {row['max_abs_err']:.3e}"
                      f" of max|ref| {row['max_abs_ref']:.3e}, mean "
                      f"{row['mean_abs_err']:.3e} of "
                      f"{row['mean_abs_ref']:.3e}; kernel {row['ms']:.4f} ms,"
                      f" plain {row['plain_ms']:.4f} ms, bound "
                      f"{row['bound_ms']:.4f} ms ({row['bound_by']}); bf16 "
                      f"F.linear x3 + sdpa + F.linear "
                      f"{row['bf16_block_ms']:.4f} ms, float projections + "
                      f"K13 {row['k13_block_ms']:.4f} ms; device "
                      f"{_ms(row['device_ms'])}: {row['stages_device_ms']}",
                      flush=True)

    # K16's backward: autograd through the wrapper (K16, then K2 on the head
    # views) against autograd through the plain version; each gradient
    # within twice the forward's tolerance times its own max|ref| (the
    # bf16 products of x's and the weights' gradients round where the
    # plain version's fp32 ones do not)
    for shape, per, dtype in ([(s, n, torch.bfloat16)
                               for s, n in K14_TRAIN_SHAPES]
                              + [((8, 480, 640), 0, torch.float32)]):
        b, t, c = shape
        x, g = rand(shape, dtype), rand(shape, dtype)
        ws = _absorbed_weights(gen, c, dtype)
        scale = (c // 8) ** -0.5
        leaves = [z.clone().requires_grad_(True) for z in (x, *ws)]
        before = (A.absorbed_self_attention.launches,
                  A.fused_self_attention_backward.launches)
        out = A.absorbed_self_attention(*leaves, 8, scale)
        grads = torch.autograd.grad(out, leaves, g, retain_graph=True)
        torch.cuda.synchronize()
        check((A.absorbed_self_attention.launches,
               A.fused_self_attention_backward.launches)
              == (before[0] + 1, before[1] + 1),
              f"K16 backward {shape}: not K16 then K2")
        plain = [z.clone().requires_grad_(True) for z in (x, *ws)]
        pout = A.absorbed_attention_reference(*plain, 8, scale)
        refs = torch.autograd.grad(pout, plain, g, retain_graph=True)
        dname = str(dtype).split(".")[-1]
        rtol = 2 * (BF16_ATOL if dtype == torch.bfloat16 else FP32_ATOL)
        err = 0.0
        for gname, gr, r in zip(("dx", "dWq", "dWk", "dWv", "dWo"), grads,
                                refs):
            e = (gr.float() - r.float()).abs().max().item()
            m = r.float().abs().max().item()
            check(m > 0 and math.isfinite(e) and e <= rtol * m,
                  f"K16 backward {shape} {dname} {gname}: max abs err {e} > "
                  f"{rtol} x max|ref| {m}")
            err = max(err, e / m)
        del grads, refs
        bwd = lambda: torch.autograd.grad(  # noqa: E731
            out, leaves, g, retain_graph=True)
        ms = time_ms(bwd, iters=10)
        # K2's share of it, on the head views of the saved q, k, v
        k2_dev = k2_device_ms(bwd)
        plain_ms = time_ms(lambda: torch.autograd.grad(
            pout, plain, g, retain_graph=True), iters=5, warmup=1)
        comp_leaves = [z.clone().requires_grad_(True) for z in (x, *ws)]
        cout = _absorbed_composition(comp_leaves[0], comp_leaves[1:])
        comp_ms = time_ms(lambda: torch.autograd.grad(
            cout, comp_leaves, g, retain_graph=True), iters=10)
        del out, pout, cout
        bound, by, flops, nbytes = absorbed_bwd_bound_ms(b, t, c, dname)
        rows["K16 backward"].append({
            "shape_btc": list(shape), "dtype": dname,
            "per_unet_backward": per, "max_abs_err": err,
            "err_is_relative_to_max_ref": True, "ms": ms,
            "k2_device_ms": k2_dev["device_ms"],
            "k2_stats_device_ms": k2_dev["stats_device_ms"],
            "k2_main_device_ms": k2_dev["main_device_ms"],
            "plain_ms": plain_ms, "library_ms": None,
            "composition_ms": comp_ms, "bound_ms": bound, "bound_by": by,
            "flops": flops, "bytes": nbytes})
        print(f"phase 29 K16 backward (K2 on the head views + torch.matmul) "
              f"{shape} {dname}: max err {err:.3e} of max|ref| (tol {rtol}),"
              f" backward {ms:.4f} ms (K2's device time "
              f"{_ms(k2_dev['device_ms'])}: stats "
              f"{_ms(k2_dev['stats_device_ms'])} + main "
              f"{_ms(k2_dev['main_device_ms'])}), plain {plain_ms:.4f} ms, "
              f"the composition's backward {comp_ms:.4f} ms, bound "
              f"{bound:.4f} ms ({by})", flush=True)
    for key in ("K16", "K17", "K18"):
        fb = [r for r in rows[key] if r.get("fallback")]
        print(f"phase 29 {key} {tuple(fb[0]['shape_btc'])}: the rule's "
              f"fallback, {fb[0]['ms']:.4f} ms", flush=True)
    return rows


def phase_absorbed_unet(trainer, seed: int = 1):
    """The full-width bf16 UNet with ``use_absorbed_attention`` against the
    same module on K1 (``absorbed`` off; phase 3's input): 16 K16, no K1 or
    K14, no fallback, within phase 3's tolerance."""
    import torch
    from ldmseg_torch.models.unet import CrossAttention
    unet = trainer.inference_unet()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((2, unet.config.in_channels, 32, 64), generator=gen,
                    device="cuda").to(torch.bfloat16)
    t = torch.tensor([999, 19], device="cuda")
    attn = [m for m in unet.modules() if isinstance(m, CrossAttention)]
    with torch.inference_mode():
        _zero_counts()
        absorbed = unet(x, t).float()
        torch.cuda.synchronize()
        counts = _counts()
        absorbed_ms = time_ms(lambda: unet(x, t), iters=10)
        for m in attn:
            m.absorbed = False
        try:
            _zero_counts()
            k1 = unet(x, t).float()
            torch.cuda.synchronize()
            k1_counts = _counts()
            k1_ms = time_ms(lambda: unet(x, t), iters=10)
        finally:
            for m in attn:
                m.absorbed = True
    check(counts == _expect(K16=16), f"absorbed UNet forward launched "
          f"{counts}, expected 16 K16 and nothing else")
    check(k1_counts == _expect(K1=16), f"the UNet with absorbed off "
          f"launched {k1_counts}, expected 16 K1")
    check(bool(torch.isfinite(absorbed).all()), "absorbed UNet not finite")
    rel = ((absorbed - k1).abs().max() / k1.abs().max()).item()
    check(rel <= 2e-2, f"UNet on K16 vs K1: max rel err {rel}")
    print(f"phase 30 UNet forward with use_absorbed_attention, [2, 12, 32, "
          f"64]: K16 path {absorbed_ms:.3f} ms, K1 path {k1_ms:.3f} ms, max "
          f"rel err {rel:.3e} (tol 2e-2), launches {counts}", flush=True)
    return {"absorbed_ms": absorbed_ms, "k1_ms": k1_ms, "max_rel_err": rel,
            "counts": counts}


def phase_absorbed_train(smi_line: str, seed: int = 0,
                         timed: int = ABSORBED_TIMED_STEPS):
    """``train_loop`` with ``use_absorbed_attention`` as phase 6 (2 warm-up
    and ``timed`` steps): per step 30 K16 and 2 fallbacks (two forwards of
    15 sites; the rule sends the mid block's T = 30 away), 15 K2, no K1 or
    K14, and the peak memory; then one step's loss and gradients against
    the same step on the plain attention, and a gradient on every
    attention weight."""
    import torch
    from ldmseg_torch.data.loader import Loader
    from ldmseg_torch.data.synthetic import SyntheticDVPS
    from ldmseg_torch.models.unet import CrossAttention

    ds = SyntheticDVPS(length=2 * TRAIN_BATCH, size=TRAIN_HW, num_bits=8)
    trainer = _absorbed_trainer(_train_config(), seed, dataset=ds)
    trainer.train_loop(max_steps=WARMUP_STEPS, log_every=WARMUP_STEPS,
                       seed=seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    losses = trainer.train_loop(max_steps=timed, log_every=timed,
                                seed=seed + 1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    want = _expect(K16=30 * timed, K2=15 * timed)
    want["fallbacks"] = 2 * timed
    check(counts == want, f"absorbed train steps launched {counts}, "
          f"expected {want}")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    print(f"phase 32 train_loop with use_absorbed_attention: {timed} steps, "
          f"batch {TRAIN_BATCH} x {TRAIN_HW[0]}x{TRAIN_HW[1]}: "
          f"{secs / timed:.4f} s/step, {TRAIN_BATCH * timed / secs:.3f} "
          f"samples/s, peak memory {peak / 2**30:.2f} GiB, launches "
          f"{counts} [{smi_line}]", flush=True)

    batch = next(iter(Loader(ds, TRAIN_BATCH, seed=seed + 2)))
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    lh, lw = TRAIN_HW[0] // 8, TRAIN_HW[1] // 8
    noise = torch.randn((TRAIN_BATCH, lh, lw, 4), generator=gen,
                        device="cuda")
    steps = torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen,
                          device="cuda")
    attn = [m for m in trainer.unet.modules()
            if isinstance(m, CrossAttention)]
    results = {}
    for absorbed in (True, False):
        for m in attn:
            m.absorbed = m.use_fused = absorbed
        trainer.state.zero_grad()
        loss, _, _ = trainer.forward_backward(batch, noise=noise,
                                              timesteps=steps)
        if absorbed:
            for m in attn:
                for lin in (m.to_q, m.to_k, m.to_v, m.to_out[0]):
                    g = lin.weight.grad
                    check(g is not None and bool(torch.isfinite(g).all())
                          and g.abs().max().item() > 0,
                          "an attention weight's grad is missing, zero or "
                          "not finite")
        results[absorbed] = (loss.item(), _flat_grads(trainer.unet))
    for m in attn:
        m.absorbed = m.use_fused = True
    (loss_k, g_k), (loss_p, g_p) = results[True], results[False]
    cos = (torch.dot(g_k, g_p) / (g_k.norm() * g_p.norm())).item()
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    del results, g_k, g_p, trainer
    check(loss_rel <= 1e-2, f"train loss on K16/K2 vs plain: rel "
          f"{loss_rel}")
    check(cos >= 0.99, f"gradient cosine on K16/K2 vs plain: {cos}")
    print(f"phase 32 one step on K16/K2 vs plain attention: loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (rel {loss_rel:.2e}, tol 1e-2), "
          f"gradient cosine {cos:.6f} (>= 0.99); every attention weight's "
          f"grad finite and non-zero ({len(attn)} layers)", flush=True)
    return counts, {"seconds_per_step": secs / timed,
                    "samples_per_s": TRAIN_BATCH * timed / secs,
                    "peak_bytes": peak, "losses": losses,
                    "loss_rel": loss_rel, "grad_cosine": cos}


def _k17_scales(unet):
    """{input scale K17 packed} over the UNet's int8 absorbed attentions."""
    from ldmseg_torch.models.unet import AbsorbedAttentionS8
    mods = [m for m in unet.modules() if isinstance(m, AbsorbedAttentionS8)]
    check(len(mods) == 16, f"{len(mods)} int8 absorbed attentions, not 16")
    return mods


def phase_absorbed_int8(trainer, smi_line: str, bf16_result: dict):
    """int8 (a) with absorbed attention (phase 33): its UNet forward
    against the bf16 one (16 K17, 16 K12); ``sample_panoptic`` with the
    default and the calibrated scales (320 K17 + 320 K12 per call), K17's
    input scale 0.1 (``int8_attn_act_scale``) in both, as JAX's in-graph
    branch; then the absorbed-storage UNet (``prepare_int8_unet(...,
    absorbed_attention=True)`` on the calibrated scales), whose K17s read
    the calibrated ``to_q`` sites, against the bf16 UNet."""
    from ldmseg_torch.ops.quant import f32
    from ldmseg_torch.tools.profile_sampling import int8_unet_from
    bf16 = trainer.inference_unet()
    unet_result = _unet_vs_bf16(
        "int8 UNet (a) with absorbed attention (K17 + K12)", 33,
        trainer.int8_unet(), bf16, {"K17": 16, "K12": 16})
    check({m.pack.xs for m in _k17_scales(trainer._unet_int8)}
          == {f32(0.1)}, "K17's input scale is not 0.1 (default scales)")
    sample = phase_int8_sample(
        trainer, "int8 (a) with absorbed attention", {"K17": 16, "K12": 16},
        smi_line, bf16_result, calibrate=True, phase=33)
    mods = _k17_scales(trainer._unet_int8)
    check(all(m.x_scale is not None for m in mods)
          and {m.pack.xs for m in mods} == {f32(0.1)},
          "under the trainer K17 must keep 0.1 after calibrate_int8")
    print(f"phase 33 K17's input scale under the trainer: 0.1 with the "
          f"default and the calibrated scales ({len(mods)} sites hold a "
          f"calibrated to_q scale and ignore it)", flush=True)
    scales = trainer._int8_act_scales
    storage = int8_unet_from(trainer.unet, dict(
        ABSORBED_A_FLAGS, use_absorbed_attention=True), scales=scales,
        absorbed_attention=True)
    names = {m: n for n, m in storage.named_modules()}
    mods = _k17_scales(storage)
    read = [(m.pack.xs, f32(scales[f"{names[m]}.to_q"])) for m in mods]
    check(all(a == b for a, b in read) and any(a != f32(0.1)
                                               for a, _ in read),
          f"absorbed storage: K17 did not read the calibrated to_q sites "
          f"{read[:3]}")
    storage_result = _unet_vs_bf16(
        "int8 UNet (a), absorbed storage (K17 on calibrated to_q)", 33,
        storage, bf16, {"K17": 16, "K12": 16})
    print(f"phase 33 absorbed storage: K17 reads the calibrated to_q sites "
          f"({min(a for a, _ in read):.4g}-{max(a for a, _ in read):.4g}, "
          f"not 0.1)", flush=True)
    del storage
    return unet_result, sample, storage_result


def k16_entry(rows, launches, by_path):
    """The kernels-line entry for K16: times summed over the 16 launches of
    one UNet forward at the sampling shapes (bf16, batch 2), the training
    forward's rows and the backward (K2 on the head views with the gradient
    products, per UNet backward at batch 8) beside them."""
    def unit(key, per_key):
        main = [r for r in rows[key] if r.get(per_key)]
        out = _per_unit([{**r, "library_ms": 0.0} for r in main], per_key)
        out["composition_ms"] = sum(r["composition_ms"] * r[per_key]
                                    for r in main)
        out["library_ms"] = None
        if all(r.get("stages_device_ms") for r in main):
            out["stages_device_ms"] = {
                k: sum(r["stages_device_ms"][k] * r[per_key] for r in main)
                for k in main[0]["stages_device_ms"]}
        if all(r.get("linear_x4_device_ms") is not None for r in main):
            out["linear_x4_device_ms"] = sum(
                r["linear_x4_device_ms"] * r[per_key] for r in main)
        return out
    return {
        "name": "attention_absorbed", "id": "K16", "route": "cuda",
        "source": "ldmseg_torch/csrc/attention_fwd.cu",
        "replaces": "ldmseg_tpu/ops/pallas/attention.py:239",
        "tpu_kernel": "ldmseg_tpu/ops/pallas/attention.py:"
                      "_attn_kernel_absorbed",
        "launches": launches, "launches_by_path": by_path, "checked": True,
        **unit("K16", "per_unet_forward"),
        "library_note": "no single PyTorch call computes this function; "
                        "composition_ms is F.linear x 3 + SDPA + F.linear, "
                        "linear_x4_device_ms the device time of its four "
                        "F.linear (cuBLAS), the yardstick of the qkv and "
                        "to_out stages",
        "unit": "one UNet forward (16 launches, bf16, batch 2, 32x64 latent)",
        "shapes": rows["K16"],
        "training_forward": {**unit("K16 training", "per_unet_forward"),
                             "unit": "one UNet forward at batch 8, 24x80 "
                                     "(15 launches; T = 30 falls back)",
                             "shapes": rows["K16 training"]},
        "backward": {**unit("K16 backward", "per_unet_backward"),
                     "unit": "one UNet backward at batch 8, 24x80 (15 K2 "
                             "launches on the head views and the gradient "
                             "products); max_abs_err relative to max|ref|",
                     "shapes": rows["K16 backward"]},
    }


# ---------------------------------------------------------------------------
# the serving path's metric (phase 34), the entry and the bench line (35)
# ---------------------------------------------------------------------------
PQ_FRAMES, PQ_BATCH = 4, 2
PQ_AGREE = 0.999  # the card's cleaned maps against the CPU path's


def _agreement(trainer, captured, resize_hw=None):
    """The share of pixels on which the card's restore + post-processing of
    the captured logits equals the CPU path's on the same logits, the
    pixels the card's maps keep (not -1), and the same share with the
    thresholds at 0 (the restored logits' argmax under the valid mask:
    random weights leave few segments past ``count_th``)."""
    ths = (trainer.mask_th, trainer.count_th, trainer.overlap_th)
    try:
        trainer.mask_th = trainer.count_th = trainer.overlap_th = 0
        argmax, _, _ = _agreement_at(trainer, captured, resize_hw)
    finally:
        trainer.mask_th, trainer.count_th, trainer.overlap_th = ths
    share, total, kept = _agreement_at(trainer, captured, resize_hw)
    return share, total, kept, argmax


def _agreement_at(trainer, captured, resize_hw):
    import numpy as np
    same = total = kept = 0
    for batch, logits in captured:
        if resize_hw is None:
            card = trainer.restore_fullres(logits, batch["meta"])
            cpu = trainer.restore_fullres(logits.cpu(), batch["meta"])
        else:
            card = list(trainer.restore_resized(logits, resize_hw,
                                                batch["mask"]))
            cpu = list(trainer.restore_resized(logits.cpu(), resize_hw,
                                               batch["mask"]))
        for a, b in zip(card, cpu):
            same += int(np.count_nonzero(a == b))
            kept += int(np.count_nonzero(a != -1))
            total += a.size
    return same / total, total, kept


def phase_compute_pq(smi_line: str, seed: int = 0):
    """``TrainerDiffusion.compute_pq`` end to end at full width: a KITTI-DVPS
    val tree of :data:`PQ_FRAMES` frames at KITTI's 375x1242 written from
    seeded numpy into a temporary directory, read by ``get_dataset("kitti",
    split="val", size=(256, 512), keep_fullres_gt=True)``, the phase-4
    trainer (bf16, K1, the same seeded weights) at batch 2 with
    ``SAMPLE_STEPS`` DDIM steps: each prediction restored to 375x1242 and
    scored; then one batch without ``keep_fullres_gt`` (the resize branch).
    Gates: the launches (16 K1 a step, nothing else) and the card's cleaned maps equal to the
    CPU path's restore of the same logits on >= ``PQ_AGREE`` of the
    pixels."""
    import tempfile
    import torch
    from ldmseg_torch.data import get_dataset
    from ldmseg_torch.tools.kitti_tree import write_kitti_dvps_tree
    from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
    from ldmseg_torch.utils.config import merge_dicts

    cfg = merge_dicts(_config(), {"train_kwargs": {"batch_size": PQ_BATCH}})
    out = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_kitti_dvps_tree(root, "val", frames=PQ_FRAMES, seed=seed)
        tree_s = time.perf_counter() - t0
        trainer = TrainerDiffusion(cfg)
        trainer.init_params(seed=0)
        captured = []
        sample = trainer.sample_panoptic

        def recording(batch, *a, **kw):
            logits, x0 = sample(batch, *a, **kw)
            captured.append((batch, logits))
            return logits, x0
        trainer.sample_panoptic = recording
        steps = trainer.num_inference_steps
        for branch, fullres, max_batches in (("full resolution", True,
                                              None),
                                             ("resize", False, 1)):
            trainer.ds_val = get_dataset(
                "kitti", prefix=root, split="val", size=(256, 512),
                keep_fullres_gt=fullres)
            calls = min(-(-len(trainer.ds_val) // PQ_BATCH),
                        max_batches or 1 << 30)
            frames = min(len(trainer.ds_val), calls * PQ_BATCH)
            captured.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            t0 = time.perf_counter()
            res = trainer.compute_pq(max_batches=max_batches, seed=seed)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = _counts()
            peak = torch.cuda.max_memory_allocated()
            want = _expect(K1=16 * steps * calls)
            check(counts == want, f"compute_pq ({branch}) launched {counts},"
                  f" expected {want}")
            check(len(captured) == calls and all(
                tuple(lg.shape) == (PQ_BATCH, 256, 512, trainer.num_classes)
                and bool(torch.isfinite(lg).all()) for _, lg in captured),
                f"compute_pq ({branch}): logits of {len(captured)} calls")
            check(all(math.isfinite(res[k]) for k in ("pq", "sq", "rq")),
                  f"compute_pq ({branch}): {res}")
            agree, pixels, kept, argmax = _agreement(
                trainer, captured, None if fullres else (256, 512))
            check(agree >= PQ_AGREE and argmax >= PQ_AGREE,
                  f"compute_pq ({branch}): the card's cleaned maps equal the "
                  f"CPU path's on {agree:.6f} of {pixels} pixels, the argmax "
                  f"maps on {argmax:.6f} (< {PQ_AGREE})")
            out[branch] = {
                "pq": res["pq"], "sq": res["sq"], "rq": res["rq"],
                "tp": res["tp"], "fp": res["fp"], "fn": res["fn"],
                "seconds": secs, "s_per_frame": secs / frames,
                "frames": frames, "calls": calls,
                "k1_launches": counts["K1"],
                "k1_launches_per_call": counts["K1"] / calls,
                "peak_bytes": peak, "cpu_agreement": agree,
                "cpu_agreement_argmax": argmax, "pixels": pixels,
                "pixels_kept": kept, "counts": counts}
            print(f"phase 34 compute_pq ({branch}): {frames} KITTI-DVPS "
                  f"frames of 375x1242 at 256x512, batch {PQ_BATCH}, {steps}"
                  f" DDIM steps: PQ {res['pq']:.4f}, SQ {res['sq']:.4f}, RQ "
                  f"{res['rq']:.4f} (tp {res['tp']}, fp {res['fp']}, fn "
                  f"{res['fn']}; random weights), {secs:.3f} s, "
                  f"{secs / frames:.3f} s per frame, K1 launches "
                  f"{counts['K1']} ({counts['K1'] / calls:.0f} per call), "
                  f"peak memory {peak / 2**30:.2f} GiB, cleaned maps equal "
                  f"to the CPU path's on {agree:.6f} of {pixels} pixels "
                  f"({kept} kept), the argmax maps on {argmax:.6f} "
                  f"[{smi_line}]", flush=True)
        out["tree_seconds"] = tree_s
        del trainer, captured
    torch.cuda.empty_cache()
    return out


def phase_entry_bench(smi_line: str, seed: int = 1):
    """``ldmseg_torch.entry.entry()``'s forward (16 K1 a forward) against
    the same UNet on the plain attention: on a random sample within 2e-2 of
    max|ref|, as phase 3; on its own zero sample, whose near-constant maps
    give GroupNorm a variance near 0 that magnifies any rounding, both bf16
    paths against the fp32 forward on the plain attention, K1's error no
    more than 1.25 times the plain path's or 2e-2. Then ``tools/bench.py``'s
    ``run`` at batch 2 (one warm-up and one timed call per dtype): its JSON
    line printed, its launches checked (the entry forward 23 times, 800 K1
    a bf16 call, 800 K3 and 800 K4 an int8 call, 320 of each a DPM call,
    one K1 D=512 a call in the image encode, nothing else)."""
    import copy
    import torch
    from ldmseg_torch.entry import entry
    from ldmseg_torch.models.unet import CrossAttention
    from ldmseg_torch.tools import bench

    fn, args = entry()
    unet = fn.unet
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rand = (torch.randn(args[0].shape, generator=gen, device="cuda").to(
        torch.bfloat16), torch.tensor([500], device="cuda"))
    attn = [m for m in unet.modules() if isinstance(m, CrossAttention)]
    unet32 = copy.deepcopy(unet).float()
    for m in unet32.modules():
        if isinstance(m, CrossAttention):
            m.use_fused = False

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
    errs = {}
    for label, inputs in (("random sample, t 500", rand),
                          ("zero sample, t 0", args)):
        _zero_counts()
        got = fn(*inputs).float()
        torch.cuda.synchronize()
        counts = _counts()
        for m in attn:
            m.use_fused = False
        try:
            ref = fn(*inputs).float()
        finally:
            for m in attn:
                m.use_fused = True
        with torch.inference_mode():
            ref32 = unet32(inputs[0].float(), inputs[1]).float()
        check(counts == _expect(K1=16),
              f"entry forward ({label}) launched {counts}, expected 16 K1")
        check(tuple(got.shape) == (1, 4, 32, 64)
              and bool(torch.isfinite(got).all()),
              f"entry forward ({label}): {tuple(got.shape)}, finite "
              f"{bool(torch.isfinite(got).all())}")
        e = {"vs_plain": rel(got, ref), "k1_vs_fp32": rel(got, ref32),
             "plain_vs_fp32": rel(ref, ref32)}
        if label.startswith("random"):
            check(e["vs_plain"] <= 2e-2, f"entry forward ({label}) on K1 vs "
                  f"the plain attention: max rel err {e['vs_plain']}")
        else:
            check(e["k1_vs_fp32"] <= max(2e-2, 1.25 * e["plain_vs_fp32"]),
                  f"entry forward ({label}): K1's error against the fp32 "
                  f"forward {e['k1_vs_fp32']} > max(2e-2, 1.25 x the plain "
                  f"bf16 path's {e['plain_vs_fp32']})")
        errs[label] = e
    del unet32
    del fn, args, unet, attn
    torch.cuda.empty_cache()
    _zero_counts()
    line = bench.run(batch=2, steps=50, calls=1, warmup=1)
    counts = _counts()
    check((line["metric"], line["unit"]) == ("frames_per_s", "frames/s")
          and line["value"] == line["int8"]["frames_per_s"] > 0
          and line["dpm_fps"] == line["dpm"]["frames_per_s"] > 0
          and line["image_vae"]["use_int8"] is True
          and "vs_baseline" not in line and "CUDA graph" in line["sampler"],
          f"the bench line's head: {line['metric']}, {line['unit']}, "
          f"{line['value']}, dpm_fps {line.get('dpm_fps')}")
    # two calls (warm-up, timed) of each pipeline, one image encode (one K1
    # D=512) a call; DPM at 20 steps
    want = _expect(K1=16 * (3 + 20) + 2 * 800, K1w=3 * 2,
                   K3=2 * 800 + 2 * 320, K4=2 * 800 + 2 * 320)
    check(counts == want, f"the bench run launched {counts}, expected "
          f"{want}")
    for kind, kids in (("bf16", {"K1": 800, "K1 D=512": 1}),
                       ("int8", {"K3": 800, "K4": 800, "K1 D=512": 1}),
                       ("dpm", {"K3": 320, "K4": 320, "K1 D=512": 1})):
        per = line[kind]["launches_per_call"]
        check(all(per[k] == n for k, n in kids.items()),
              f"bench {kind}: launches per call {per}")
    print(f"phase 35 entry(): [1, 8, 32, 64] bf16 forward on K1 vs the "
          f"plain attention, max rel err {errs} (tol 2e-2); bench at batch "
          f"2: forward {line['unet_forward_ms']:.3f} ms, bf16 "
          f"{line['bf16']['s_per_call']:.3f} s/call "
          f"({line['bf16']['frames_per_s']:.3f} frames/s), int8 "
          f"{line['int8']['s_per_call']:.3f} s/call "
          f"({line['int8']['frames_per_s']:.3f} frames/s), DPM 20 steps "
          f"{line['dpm']['s_per_call']:.3f} s/call "
          f"({line['dpm_fps']:.3f} frames/s) [{smi_line}]",
          flush=True)
    print(json.dumps(line), flush=True)
    return {"entry_max_rel_err": errs, "bench": line, "counts": counts}


# ---------------------------------------------------------------------------
# the run around the UNet (phase 36): main_ldm, save, resume, predict
# ---------------------------------------------------------------------------
LIFECYCLE_STEPS = 2       # optimizer steps of main_ldm (batch 8)
LIFECYCLE_PQ_STEPS = 4    # DDIM steps of its evals and of predict
# the UNet at SD-1.4's widths with one resnet a block (the default's depth
# is 2: 12.2 GiB a checkpoint, 8.2 GiB at this depth)
LIFECYCLE_UNET = ["model_kwargs.block_out_channels=[320,640,1280,1280]",
                  "model_kwargs.layers_per_block=1"]
# free space the phase needs in TMPDIR: main_ldm writes step_N and
# best_model (fp32 masters, AdamW moments, EMA; 12.2 GiB each at the
# default depth), before best_model is removed and the export is written
LIFECYCLE_DISK_BYTES = 28 * 2**30


def _opt_state(trainer) -> dict:
    return {(i, k): v for i, st in trainer.state.optimizer.torch_opt
            .state_dict()["state"].items() for k, v in st.items()}


def phase_lifecycle(smi_line: str):
    """``main_ldm`` at full width and one resnet a block
    (``LIFECYCLE_UNET``: the default configuration otherwise, bf16 on fp32
    masters, self-conditioning, ``ema_on``; synthetic 192x640 frames at
    batch 8) in a temporary directory: ``LIFECYCLE_STEPS`` steps through
    the threaded loader and the H2D prefetch, the final save, and PQ on
    the val frames with the best-PQ snapshot; its K1 and K2 launches
    checked (two K1 and one K2 a transformer block a step, one K1 a block
    a DDIM step of the two eval calls). A fresh trainer resumes from the
    checkpoint: masters, AdamW state and EMA bit-equal on the card to the
    run's. ``export_checkpoint
    --ema`` writes the reference's save dict from the run directory, which
    ``load_reference_ldm`` reads back equal to the run's masters and EMA.
    ``predict`` writes the PNG pairs of 2 frames from the checkpoint.
    Prints the checkpoint's bytes and the seconds of each save and of the
    resume."""
    import json as _json
    import os
    import shutil
    import tempfile
    import numpy as np
    import torch
    from PIL import Image
    from ldmseg_torch.models.torch_import import load_reference_ldm
    from ldmseg_torch.tools import export_checkpoint, main_ldm, predict
    from ldmseg_torch.train.trainer_ldm import TrainerDiffusion

    with tempfile.TemporaryDirectory() as root:
        free = shutil.disk_usage(root).free
        check(free >= LIFECYCLE_DISK_BYTES,
              f"phase 36 needs {LIFECYCLE_DISK_BYTES / 2**30:.0f} GiB free "
              f"in the temporary directory {root} (TMPDIR) for two "
              f"checkpoints; it has {free / 2**30:.1f} GiB")
        saves = []
        save = TrainerDiffusion.save

        def timed_save(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = save(self, *a, **kw)
            saves.append((os.path.basename(path),
                          time.perf_counter() - t0))
            return path
        overrides = ["train_kwargs.self_condition=True",
                     "train_kwargs.weight_dtype=bfloat16", "ema_on=True",
                     f"train_kwargs.train_num_steps={LIFECYCLE_STEPS}",
                     f"sampling_kwargs.num_inference_steps="
                     f"{LIFECYCLE_PQ_STEPS}"] + LIFECYCLE_UNET
        TrainerDiffusion.save = timed_save
        _zero_counts()
        try:
            t0 = time.perf_counter()
            live = main_ldm.main(overrides + [
                f"output_dir={root}", "run_idx=0", "eval_first=False"])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        finally:
            TrainerDiffusion.save = save
        counts = _counts()
        calls = -(-len(live.ds_val) // live.batch_size)
        sites = _attention_sites(live.unet)
        want = _expect(K1=2 * sites * LIFECYCLE_STEPS + sites
                       * LIFECYCLE_PQ_STEPS * min(calls, 4),
                       K2=sites * LIFECYCLE_STEPS)
        check(counts == want, f"main_ldm launched {counts}, expected {want}")
        check(live.state.step == LIFECYCLE_STEPS,
              f"main_ldm stopped at step {live.state.step}")
        run_dir = os.path.join(root, "run_0")
        ckpts = os.path.join(run_dir, "checkpoints")
        names = sorted(os.listdir(ckpts))
        check(names == ["best_model", "metrics.jsonl",
                        f"step_{LIFECYCLE_STEPS}"],
              f"main_ldm wrote {names}")
        path = os.path.join(ckpts, f"step_{LIFECYCLE_STEPS}")
        nbytes = os.path.getsize(path)
        # resume and predict read step_N: the snapshot's disk goes back
        os.remove(os.path.join(ckpts, "best_model"))
        losses = [r["loss"] for r in map(_json.loads, open(
            os.path.join(ckpts, "metrics.jsonl"))) if "loss" in r]
        check(len(losses) == 1 and math.isfinite(losses[0]),
              f"metrics.jsonl losses {losses}")

        cfg = _json.load(open(os.path.join(run_dir, "config.json")))
        fresh = TrainerDiffusion(
            cfg, unet_config=main_ldm.build_unet_config(cfg),
            results_folder=ckpts)
        main_ldm.load_weights(fresh, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh.resume(path)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        for (n, p), q in zip(live.unet.named_parameters(),
                             fresh.unet.parameters()):
            check(torch.equal(p, q), f"resumed master {n} differs")
        for e, f in zip(live.state.ema_params, fresh.state.ema_params):
            check(torch.equal(e, f), "a resumed EMA tensor differs")
        ours, theirs = _opt_state(live), _opt_state(fresh)
        check(ours.keys() == theirs.keys() and all(
            torch.equal(v, theirs[k]) for k, v in ours.items()),
            "the resumed AdamW state differs")
        check(not all(torch.equal(p, e) for p, e in zip(
            live.unet.parameters(), live.state.ema_params)),
            "the EMA never moved off the masters")
        # step_N was written before the eval that set best_pq
        check(fresh.state.step == LIFECYCLE_STEPS and fresh.best_pq == -1.0
              and live.best_pq > -1.0, "resumed step or best_pq")
        del fresh, ours, theirs
        torch.cuda.empty_cache()

        # the reference's save dict from the run directory, read back
        exported = os.path.join(root, "model.pt")
        t0 = time.perf_counter()
        export_checkpoint.main(["--run_dir", run_dir, "--out", exported,
                                "--ema"])
        export_s = time.perf_counter() - t0
        vk = cfg["vae_model_kwargs"]
        back = load_reference_ldm(
            exported, live.unet_config, tuple(vk["block_out_channels"]),
            vk.get("num_upscalers", 1))
        for (n, p), e in zip(live.unet.named_parameters(),
                             live.state.ema_params):
            check(torch.equal(back["unet"][n], p.cpu())
                  and torch.equal(back["ema"][n], e.cpu()),
                  f"the exported {n} differs from the run's")
        check(back["step"] == LIFECYCLE_STEPS, f"exported step "
              f"{back['step']}")
        export_bytes = os.path.getsize(exported)
        del live, back
        os.remove(exported)
        torch.cuda.empty_cache()

        out = os.path.join(root, "predictions")
        t0 = time.perf_counter()
        written = predict.main(overrides + [
            f"out_dir={out}", f"checkpoint={path}", "max_batches=1",
            "eval_kwargs.batch_size=2"])
        torch.cuda.synchronize()
        predict_s = time.perf_counter() - t0
        pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
        check(written == 2 and len(pngs) == 4, f"predict wrote {pngs}")
        for f in pngs:
            a = np.asarray(Image.open(os.path.join(out, f)))
            check(a.shape == (192, 640) and a.dtype == np.uint8,
                  f"{f}: {a.shape} {a.dtype}")
    result = {"steps": LIFECYCLE_STEPS, "pq_steps": LIFECYCLE_PQ_STEPS,
              "unet": LIFECYCLE_UNET, "transformer_blocks": sites,
              "main_ldm_seconds": run_s, "checkpoint_bytes": nbytes,
              "saves_seconds": saves, "resume_seconds": resume_s,
              "predict_seconds": predict_s, "free_bytes_before": free,
              "export_seconds": export_s, "export_bytes": export_bytes,
              "counts": counts}
    print(f"phase 36 main_ldm (SD-1.4 widths, one resnet a block: "
          f"{sites} transformer blocks), {LIFECYCLE_STEPS} steps at batch 8 "
          f"of 192x640, ema_on, then compute_pq ({LIFECYCLE_PQ_STEPS} DDIM "
          f"steps, {min(calls, 4)} calls): {run_s:.1f} s, launches {counts};"
          f" checkpoint {nbytes} bytes ({nbytes / 2**30:.2f} GiB), saves "
          f"{[(n, round(t, 2)) for n, t in saves]} s, resume "
          f"{resume_s:.2f} s, masters, AdamW state and EMA bit-equal; "
          f"export_checkpoint --ema {export_bytes} bytes in {export_s:.1f} "
          f"s, read back bit-equal; predict {written} frames in "
          f"{predict_s:.1f} s [{smi_line}]",
          flush=True)
    return result


# ---------------------------------------------------------------------------
# training, both stages (phases 37-40)
# ---------------------------------------------------------------------------
AE_BATCH, AE_WARMUP, AE_TIMED = 8, 2, 5
AE_CPU_BATCH = 2       # the CPU comparison's images (the same weights, draws)
REMAT_WARMUP, REMAT_TIMED = 1, 2
# K1 a training step with self-conditioning: 16 in the no-gradient pass, 16
# in the forward, and again in the backward at each site of a
# rematerialised block: the down and up blocks' 15 (the mid block's one is
# not rematerialised, as in JAX)
REMAT_K1 = 16 + 16 + 15


def _ae_config(**over):
    from ldmseg_torch.tools.main_ae import DATASET_PRESETS
    from ldmseg_torch.utils.config import DEFAULT_CONFIG, merge_dicts
    # the default SegVAE (blocks 32-256, int_channels 256, 128 logits) on
    # the KITTI preset's 10 bit channels; 12,544 points, AdamW, bf16 compute
    return merge_dicts(merge_dicts(DEFAULT_CONFIG, DATASET_PRESETS["kitti"]),
                       merge_dicts({"train_kwargs": {
                           "batch_size": AE_BATCH,
                           "weight_dtype": "bfloat16"},
                           "ignore_label": 0}, over))


def _ae_draws(trainer, b: int, hw, gen):
    """The posterior noise and the point coordinates of one stage-1 step,
    drawn on the CPU (the card and the CPU step take the same numbers)."""
    import torch
    cfg = trainer.loss_cfg
    f = trainer.vae.downsample_factor
    n = int(cfg.num_points * cfg.oversample_ratio)
    k = cfg.num_points - int(cfg.importance_sample_ratio * cfg.num_points)
    pts = {name: (torch.rand((m, n, 2), generator=gen),
                  torch.rand((m, k, 2), generator=gen))
           for name, m in (("ce", b), ("mask", b * cfg.max_masks))}
    return {"noise": torch.randn((b, 4, hw[0] // f, hw[1] // f),
                                 generator=gen), "points": pts}


def phase_ae_train(smi_line: str, seed: int = 0):
    """Stage 1 at full width (phase 37): ``TrainerAE.train_loop`` on
    ``SyntheticDVPS`` (5 bits, 192x640) at batch 8, bf16 on fp32 masters,
    AdamW: warm-up steps, then timed steps (s/step, peak memory, no kernel
    launched: the seg VAE runs convs, GroupNorm and LayerNorm); one step's
    loss on the card against the same step on the CPU from the same
    weights, batch and draws (``AE_CPU_BATCH`` images, 1e-2 relative);
    ``compute_miou`` and ``compute_pq`` over 2 val batches."""
    import torch
    from ldmseg_torch.data.collate import collate
    from ldmseg_torch.data.synthetic import SyntheticDVPS
    from ldmseg_torch.train.trainer_ae import TrainerAE

    ds = SyntheticDVPS(length=2 * AE_BATCH, size=TRAIN_HW, num_bits=5)
    trainer = TrainerAE(_ae_config(), dataset=ds, val_dataset=ds)
    trainer.init_params(seed=seed)
    masters = {n: p.detach().clone() for n, p in
               trainer.vae.named_parameters()}
    warm = trainer.train_loop(max_steps=AE_WARMUP, log_every=AE_WARMUP,
                              seed=seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    timed = trainer.train_loop(max_steps=AE_TIMED, log_every=AE_TIMED,
                               seed=seed + 1)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / AE_TIMED
    peak = torch.cuda.max_memory_allocated()
    counts = _counts()
    losses = warm + timed
    check(all(math.isfinite(x) for x in losses),
          f"stage-1 losses not finite: {losses}")
    check(counts == _expect(), f"the stage-1 steps launched {counts}")
    moved = [not torch.equal(p, masters[n])
             for n, p in trainer.vae.named_parameters()]
    check(all(moved), f"{moved.count(False)} seg-VAE parameters unchanged")
    del masters

    # one step on a loaded batch, traced: its kernels, host and families
    from ldmseg_torch.tools.profile_sampling import _profile
    loaded = collate([ds[i] for i in range(AE_BATCH)])
    prof = _profile(lambda: trainer.train_step(loaded), 2, "stage-1 step")
    prof["families_ms"] = dict(list(prof.get("families_ms", {}).items())[:6])
    prof.pop("top_kernels_ms", None)
    print(f"phase 37 one stage-1 train_step on a loaded batch, traced: "
          f"wall {_ms(prof['wall_ms'])} ms, kernels "
          f"{_ms(prof.get('device_ms'))} ms, busy "
          f"{_ms(prof.get('busy_share'))}, {prof.get('kernel_launches')} "
          f"launches; families {prof['families_ms']}", flush=True)
    del loaded

    # one step's loss on the card and on the CPU: same weights and draws
    batch = collate([ds[i] for i in range(AE_CPU_BATCH)])
    draws = _ae_draws(trainer, AE_CPU_BATCH, TRAIN_HW,
                      torch.Generator().manual_seed(seed + 2))
    cpu = TrainerAE(_ae_config(), device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in
                         trainer.vae.state_dict().items()})

    def to(d, dev):
        if isinstance(d, dict):
            return {k: to(v, dev) for k, v in d.items()}
        if isinstance(d, tuple):
            return tuple(to(v, dev) for v in d)
        return d.to(dev)
    with torch.no_grad():
        card_loss, card_parts = trainer.forward_loss(
            batch, draws=to(draws, trainer.device))
        cpu_loss, cpu_parts = cpu.forward_loss(batch, draws=draws)
    card_loss, cpu_loss = card_loss.item(), cpu_loss.item()
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    check(math.isfinite(card_loss) and rel <= 1e-2,
          f"stage-1 loss on the card {card_loss} vs the CPU {cpu_loss}: "
          f"rel {rel}")
    del cpu
    t0 = time.perf_counter()
    metrics = trainer.compute_metrics(max_batches=2)
    eval_s = time.perf_counter() - t0
    miou, pq = metrics["miou"]["mIoU"], metrics["pq"]["pq"]
    check(math.isfinite(miou) and math.isfinite(pq),
          f"stage-1 eval mIoU {miou} PQ {pq}")
    print(f"phase 37 stage-1 train_loop: {AE_TIMED} steps, batch {AE_BATCH}"
          f" x {TRAIN_HW[0]}x{TRAIN_HW[1]}, 12,544 points, bf16 on fp32 "
          f"masters: {secs:.4f} s/step, {AE_BATCH / secs:.2f} samples/s, "
          f"peak memory {peak / 2**30:.2f} GiB, no kernel launched, losses "
          f"{[round(x, 4) for x in losses]}; one step's loss on the card "
          f"{card_loss:.6f} vs the CPU {cpu_loss:.6f} (rel {rel:.2e}, tol "
          f"1e-2, batch {AE_CPU_BATCH}); compute_miou + compute_pq over 2 "
          f"batches: mIoU {miou:.3f}, PQ {pq:.3f} in {eval_s:.2f} s "
          f"[{smi_line}]", flush=True)
    result = {"seconds_per_step": secs, "samples_per_s": AE_BATCH / secs,
              "peak_bytes": peak, "losses": losses,
              "card_loss": card_loss, "cpu_loss": cpu_loss,
              "loss_rel": rel, "miou": miou, "pq": pq,
              "eval_seconds": eval_s, "counts": counts,
              "loaded_step_profile": prof}
    del trainer
    torch.cuda.empty_cache()
    return result


def phase_stage1_to_stage2(smi_line: str):
    """Phase 38: ``main_ae`` (the synthetic preset, 3 steps at batch 8 of
    192x640, its two evaluations), ``export_checkpoint --stage ae``, then
    ``main_ldm`` reading that file through
    ``vae_model_kwargs.pretrained_path`` (its seg VAE equal to the stage-1
    weights) and taking 2 steps (no eval first; 2 DDIM steps in its final
    PQ); the launches of the stage-2 run checked."""
    import os
    import tempfile
    import torch
    from ldmseg_torch.tools import export_checkpoint, main_ae, main_ldm

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        _zero_counts()
        ae = main_ae.main(["train_kwargs.train_num_steps=3",
                           f"output_dir={root}/ae", "run_idx=0"])
        torch.cuda.synchronize()
        ae_s = time.perf_counter() - t0
        check(ae.state.step == 3 and _counts() == _expect(),
              f"main_ae: step {ae.state.step}, launches {_counts()}")
        ckpts = os.path.join(root, "ae", "run_0", "checkpoints")
        check(sorted(os.listdir(ckpts)) == ["metrics.jsonl", "step_3"],
              f"main_ae wrote {sorted(os.listdir(ckpts))}")
        out = os.path.join(root, "vae.pt")
        export_checkpoint.main(["--run_dir", os.path.join(root, "ae",
                                                          "run_0"),
                                "--out", out, "--stage", "ae"])
        stage1 = {k: v.detach().clone()
                  for k, v in ae.vae.state_dict().items()}
        del ae
        torch.cuda.empty_cache()
        _zero_counts()
        t0 = time.perf_counter()
        # a narrow UNet (4 attention sites) keeps the run's two checkpoints
        # small; the seg VAE is the stage-1 one
        ldm = main_ldm.main([
            "train_kwargs.self_condition=True",
            "train_kwargs.weight_dtype=bfloat16",
            "train_kwargs.train_num_steps=2",
            "model_kwargs.block_out_channels=[64,128]",
            "model_kwargs.layers_per_block=1",
            "model_kwargs.attn_down=[True,False]",
            "sampling_kwargs.num_inference_steps=2", "eval_first=False",
            f"vae_model_kwargs.pretrained_path={out}",
            f"output_dir={root}/ldm", "run_idx=0"])
        torch.cuda.synchronize()
        ldm_s = time.perf_counter() - t0
        counts = _counts()
        calls = min(-(-len(ldm.ds_val) // ldm.batch_size), 4)
        sites = 4
        want = _expect(K1=2 * sites * 2 + sites * 2 * calls, K2=sites * 2)
        check(counts == want, f"main_ldm launched {counts}, expected {want}")
        check(ldm.state.step == 2, f"main_ldm stopped at {ldm.state.step}")
        for k, v in ldm.vae_seg.state_dict().items():
            check(torch.equal(v, stage1[k].to(v.dtype)),
                  f"main_ldm's seg VAE {k} is not the stage-1 export's")
        del ldm, stage1
        torch.cuda.empty_cache()
    print(f"phase 38 main_ae (3 steps, synthetic preset, batch 8 of "
          f"192x640): {ae_s:.1f} s; export_checkpoint --stage ae; main_ldm "
          f"on that seg VAE (2 steps, PQ at 2 DDIM steps, {calls} calls): "
          f"{ldm_s:.1f} s, launches {counts}, its seg VAE bit-equal to the "
          f"stage-1 weights [{smi_line}]", flush=True)
    return {"main_ae_seconds": ae_s, "main_ldm_seconds": ldm_s,
            "counts": counts}


def phase_remat_train(smi_line: str, seed: int = 0):
    """Phase 39: phase 6's training (batch 8 of 192x640, K1/K2, bf16 on
    fp32 masters, self-conditioning) with ``gradient_checkpointing``:
    warm-up, then timed steps with the exact launch counts (K1 16 + 16 +
    15 a step: the recompute of the down and up blocks' sites in the
    backward; K2 16); one step's gradients against the same step without
    remat from the same state (cosine >= 0.999); both steps' peak
    memory."""
    import dataclasses
    import torch
    from ldmseg_torch.data.collate import collate
    from ldmseg_torch.data.synthetic import SyntheticDVPS
    from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
    from ldmseg_torch.utils.config import merge_dicts

    ds = SyntheticDVPS(length=2 * TRAIN_BATCH, size=TRAIN_HW, num_bits=8)
    trainer = TrainerDiffusion(merge_dicts(_train_config(), {
        "train_kwargs": {"gradient_checkpointing": True}}), dataset=ds)
    check(trainer.unet_config.gradient_checkpointing,
          "train_kwargs.gradient_checkpointing did not reach the UNet")
    trainer.init_params(seed=seed)
    trainer.train_loop(max_steps=REMAT_WARMUP, log_every=REMAT_WARMUP,
                       seed=seed)
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    losses = trainer.train_loop(max_steps=REMAT_TIMED,
                                log_every=REMAT_TIMED, seed=seed + 1)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / REMAT_TIMED
    counts = _counts()
    want = _expect(K1=REMAT_K1 * REMAT_TIMED, K2=16 * REMAT_TIMED)
    check(counts == want, f"remat train steps launched {counts}, expected "
          f"{want}")
    check(all(math.isfinite(x) for x in losses), f"remat losses {losses}")

    batch = collate([ds[i] for i in range(TRAIN_BATCH)])
    dev = trainer.device
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    lh, lw = TRAIN_HW[0] // 8, TRAIN_HW[1] // 8
    noise = torch.randn((TRAIN_BATCH, lh, lw, 4), generator=gen, device=dev)
    steps = torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen, device=dev)
    cfg = trainer.unet.config
    out = {}
    for remat in (True, False):
        trainer.unet.config = dataclasses.replace(
            cfg, gradient_checkpointing=remat)
        trainer.state.zero_grad()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, _, _ = trainer.forward_backward(batch, noise=noise,
                                              timesteps=steps)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        # to the host: the other step's peak must not hold this copy
        out[remat] = (loss.item(), _flat_grads(trainer.unet).cpu(), peak)
    # each step on the loaded batch, traced: kernels and launches
    from ldmseg_torch.tools.profile_sampling import _profile
    profs = {}
    for remat in (True, False):
        trainer.unet.config = dataclasses.replace(
            cfg, gradient_checkpointing=remat)
        p = _profile(lambda: trainer.train_step(batch), 1, "remat step")
        profs[remat] = {k: p.get(k) for k in ("wall_ms", "device_ms",
                                              "busy_share",
                                              "kernel_launches")}
    trainer.unet.config = cfg
    trainer.state.zero_grad()
    (loss_r, g_r, peak_r), (loss_p, g_p, peak_p) = out[True], out[False]
    # the host copies' cosine, summed in float64 on the card in chunks
    sums = torch.zeros(3, dtype=torch.float64, device=dev)
    for i in range(0, g_r.numel(), 1 << 26):
        a, b = (g[i:i + (1 << 26)].to(dev, torch.float64) for g in (g_r, g_p))
        sums += torch.stack([(a * b).sum(), (a * a).sum(), (b * b).sum()])
    cos = (sums[0] / (sums[1].sqrt() * sums[2].sqrt())).item()
    del out, g_r, g_p
    check(cos >= 0.999, f"remat gradient cosine {cos}")
    print(f"phase 39 train_loop with gradient_checkpointing: {REMAT_TIMED} "
          f"steps, batch {TRAIN_BATCH} x {TRAIN_HW[0]}x{TRAIN_HW[1]}: "
          f"{secs:.4f} s/step, launches {counts} ({REMAT_K1} K1 and 16 K2 a"
          f" step); one step with remat vs without from the same state: "
          f"loss {loss_r:.6f} vs {loss_p:.6f}, gradient cosine {cos:.6f} "
          f"(>= 0.999), peak memory {peak_r / 2**30:.2f} GiB vs "
          f"{peak_p / 2**30:.2f} GiB; train_step on the loaded batch, "
          f"traced, remat vs not: {profs[True]} vs {profs[False]} "
          f"[{smi_line}]", flush=True)
    del trainer
    torch.cuda.empty_cache()
    return {"seconds_per_step": secs, "counts": counts,
            "loss_remat": loss_r, "loss_plain": loss_p,
            "grad_cosine": cos, "peak_bytes_remat": peak_r,
            "peak_bytes_plain": peak_p, "step_profile_remat": profs[True],
            "step_profile_plain": profs[False]}


def phase_train_options(smi_line: str, seed: int = 0):
    """Phase 40: one full-width training step (batch 2 of 192x640, bf16 on
    fp32 masters, self-conditioning) with each option this slice ported:
    Adafactor, dropout 0.1 in each mode, ``sample_posterior_rgb``, and the
    int8 UNet (``use_int8_conv`` and ``use_int8_ff``) trained through the
    straight-through path; and the JAX bench's image VAE (int8, fused
    attention) encoding the batch; each a finite loss and a changed
    parameter, one K1 D=512 launch in the last step and none in the
    others."""
    import torch
    from ldmseg_torch.data.collate import collate
    from ldmseg_torch.data.synthetic import SyntheticDVPS
    from ldmseg_torch.models.unet import UNetConfig
    from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
    from ldmseg_torch.utils.config import merge_dicts

    ds = SyntheticDVPS(length=2, size=TRAIN_HW, num_bits=8)
    batch = collate([ds[0], ds[1]])
    base = {"train_kwargs": {"batch_size": 2}}
    options = {
        "adafactor": ({"optimizer_name": "adafactor"}, {}),
        "dropout 0.1 standard": ({"train_kwargs": {"dropout": 0.1}}, {}),
        "dropout 0.1 gaussian": ({}, {"dropout": 0.1,
                                      "dropout_mode": "gaussian"}),
        "sample_posterior_rgb": ({"train_kwargs": {
            "sample_posterior_rgb": True}}, {}),
        "int8 straight-through": ({}, {"use_int8_conv": True,
                                       "use_int8_ff": True,
                                       "int8_act_scale": 0.05}),
        # the JAX bench's image VAE encodes the batch: one K1 D=512 a step
        "int8 image VAE, fused attention": ({"image_vae_kwargs": {
            "use_int8": True, "int8_act_scale": 0.05,
            "use_fused_attention": True}}, {}),
    }
    results = {}
    for name, (over, ucfg) in options.items():
        cfg = merge_dicts(_train_config(), merge_dicts(base, over))
        unet_config = (UNetConfig(in_channels=12, use_fused_attention=True,
                                  **ucfg) if ucfg else None)
        trainer = TrainerDiffusion(cfg, unet_config=unet_config)
        trainer.init_params(seed=seed)
        named = list(trainer.unet.named_parameters())
        probe = [(n, p.detach().clone()) for n, p in named
                 if n.endswith("conv1.weight")][:1]
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        loss, _, _ = trainer.train_step(batch)
        loss = loss.item()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        wide = _counts()["K1w"]
        n, before = probe[0]
        changed = not torch.equal(dict(named)[n], before)
        check(math.isfinite(loss) and changed
              and wide == (1 if "image VAE" in name else 0),
              f"{name}: loss {loss}, {n} changed {changed}, {wide} K1 "
              f"D=512 launches")
        results[name] = {"loss": loss, "seconds": secs,
                         "k1_d512_launches": wide}
        del trainer, named, probe
        torch.cuda.empty_cache()
    print(f"phase 40 one training step each (batch 2 of 192x640): "
          + "; ".join(f"{k} loss {v['loss']:.4f} ({v['seconds']:.2f} s)"
                      for k, v in results.items())
          + f"; each moved its parameters [{smi_line}]", flush=True)
    return results



# ---------------------------------------------------------------------------
# the JAX bench's serving configuration (phases 41-45): K1's wide class, the
# int8 VAEs, the image-VAE decoder, DPM-Solver++(2M), the native codec
# ---------------------------------------------------------------------------
# (B, T, H, D) of K1's wide class: the image encode at 256x512 (its 32x64
# mid block) at batch 2, the bench's batch 16, KITTI's 192x640 at batch 8
K1W_SHAPES = [(2, 2048, 1, 512), (16, 2048, 1, 512), (8, 1920, 1, 512)]
K1W_KERNEL = r"attention_fwd_kernel_sm90_wide"
K1W_P_FLIPS = 2e-4
VAE_CORR = 0.99  # JAX's own gate (tests/test_int8_inference.py:128-143)


def hand_written_kernels() -> list:
    """The ``__global__`` functions of ``ldmseg_torch/csrc``: the names a
    trace shows for the port's own kernels."""
    import re
    from ldmseg_torch.ops import _build
    names = set()
    for path in _build.CSRC.glob("*.cu*"):
        src = path.read_text()
        for m in re.finditer(r"__global__", src):
            for ident in re.findall(r"([A-Za-z_]\w*)\s*\(",
                                    src[m.end():m.end() + 400]):
                if ident != "__launch_bounds__":
                    if "kernel" in ident:
                        names.add(ident)
                    break
    return sorted(names)


# SDPA at D = 512 traced in a fresh process: late in a long process
# ``torch.profiler`` drops device events (it showed none for SDPA here)
_SDPA_CHILD = r"""
import json, sys
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile
out = []
for b, t, h, d in json.loads(sys.argv[1]):
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((b, t, h, d), generator=gen, device="cuda").to(
        torch.bfloat16).transpose(1, 2) for _ in range(3))
    fn = lambda: F.scaled_dot_product_attention(q, k, v, scale=d ** -0.5)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    out.append({"names": sorted({e.name for e in ev}),
                "device_ms": sum(e.time_range.elapsed_us() for e in ev)
                / 10 / 1e3 if ev else None})
print(json.dumps(out))
"""


def sdpa_traced(shapes) -> list:
    """SDPA on [B, T, H, D] bf16 inputs (viewed [B, H, T, D], as phase 41
    calls it) at each of ``shapes``, traced in a fresh process: the backend
    it takes, from its kernels' names, and its device ms per call."""
    proc = subprocess.run([sys.executable, "-c", _SDPA_CHILD,
                           json.dumps([list(s) for s in shapes])],
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0,
          f"the SDPA trace process failed: {proc.stderr[-2000:]}")
    rows = json.loads(proc.stdout.strip().splitlines()[-1])
    for r in rows:
        names = " ".join(r["names"]).lower()
        r["backend"] = "unknown (the trace held no device events)"
        if names:
            r["backend"] = "math (matrix products and a softmax): " + \
                " ".join(r["names"])[:200]
        for key, backend in (("flash", "flash attention"),
                             ("cudnn", "cuDNN attention"),
                             ("fmha", "memory-efficient attention"),
                             ("mem_eff", "memory-efficient attention")):
            if names and key in names:
                r["backend"] = backend
                break
    return rows


def phase_k1_wide(smi_line: str, seed: int = 23):
    """Phase 41: K1's wide class (``attention_fwd_kernel_sm90_wide``, head
    dim 512) against its plain version at ``K1W_SHAPES``: O within
    ``BF16_ATOL`` of max|O|, two calls bit-equal, one launch a call on its
    own counter and none on K1's; P (V = I at T = D = 512) one bf16 ulp
    off at no more than ``K1W_P_FLIPS`` of its entries; event and device
    ms, the plain version's, SDPA's (its device ms and the backend it takes
    at D = 512 from a trace in a fresh process) and the bound."""
    import torch
    import torch.nn.functional as F
    from ldmseg_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    sdpa_rows = sdpa_traced(K1W_SHAPES)
    for shape, sdpa_row in zip(K1W_SHAPES, sdpa_rows):
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(3))
        scale = shape[3] ** -0.5
        _zero_counts()
        out = A.fused_self_attention(q, k, v, scale)
        again = A.fused_self_attention(q, k, v, scale)
        torch.cuda.synchronize()
        counts = _counts()
        check(counts == _expect(K1w=2), f"K1 {shape}: two calls launched "
              f"{counts}, expected 2 of the wide class")
        check(torch.equal(out, again), f"K1 {shape}: repeats differ")
        ref = A.attention_reference(q, k, v, scale)
        err = (out.float() - ref.float()).abs().max().item()
        peak = ref.float().abs().max().item()
        check(math.isfinite(err) and err <= BF16_ATOL * peak,
              f"K1 {shape}: max abs err {err} > {BF16_ATOL} x max|O| {peak}")
        ms = time_ms(lambda: A.fused_self_attention(q, k, v, scale))
        dev = device_ms(lambda: A.fused_self_attention(q, k, v, scale),
                        K1W_KERNEL)
        plain_ms = time_ms(lambda: A.attention_reference(q, k, v, scale),
                           iters=3, warmup=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, scale=scale)
        lib_ms = time_ms(sdpa)
        lib_dev, backend = sdpa_row["device_ms"], sdpa_row["backend"]
        bound, by, flops, nbytes = attention_bound_ms(shape, "bfloat16")
        rows.append({"shape_btHd": list(shape), "dtype": "bfloat16",
                     "max_abs_err": err, "max_abs_ref": peak, "ms": ms,
                     "device_ms": dev, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "library_device_ms": lib_dev,
                     "library_backend": backend, "bound_ms": bound,
                     "bound_by": by, "flops": flops, "bytes": nbytes})
        print(f"phase 41 K1 D=512 {shape}: err {err:.3e} (max|O| "
              f"{peak:.3e}), kernel {ms:.4f} ms (device {_ms(dev)}), plain "
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (device "
              f"{_ms(lib_dev)}; {backend}), bound {bound:.4f} ms ({by}), "
              f"{flops / ((dev or ms) * 1e9):.1f} TFLOP/s [{smi_line}]",
              flush=True)
    # P at the rounding point: V = I turns O into the rounded P
    t = 512
    q, k = (torch.randn((1, t, 1, 512), generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    eye = torch.eye(t, device="cuda", dtype=torch.bfloat16)[None, :, None]
    p = A.fused_self_attention(q, k, eye, 512 ** -0.5).float()
    p_ref = A.attention_reference(q, k, eye, 512 ** -0.5).float()
    differ = p != p_ref
    ulp = torch.exp2(torch.floor(torch.log2(p_ref.clamp_min(1e-38))) - 7)
    flips = int(differ.sum())
    check(bool(((p - p_ref).abs()[differ] <= ulp[differ] * 1.0001).all())
          and flips <= K1W_P_FLIPS * t * t,
          f"K1 D=512: P differs from the plain version's at {flips} of "
          f"{t * t} entries, or by more than one bf16 ulp")
    print(f"phase 41 K1 D=512 P at T = D = 512: {flips} of {t * t} entries "
          f"one bf16 ulp off (tol {K1W_P_FLIPS})", flush=True)
    return rows, flips


def k1_wide_entry(rows, launches, by_path, p_flips):
    """The kernels-line entry for K1's wide class: its row at the serving
    shape (batch 2), the other shapes beside it."""
    main = rows[0]
    return {
        "name": "attention_fwd_sm90_wide",
        "id": "K1 D=512",
        "route": "cuda",
        "source": "ldmseg_torch/csrc/attention_fwd.cu",
        "replaces": "ldmseg_tpu/ops/pallas/attention.py:28",
        "tpu_kernel": "ldmseg_tpu/ops/pallas/attention.py:_attn_kernel "
                      "(block_q=512, the image VAE's AttentionBlock2D)",
        "launches": launches,
        "launches_by_path": by_path,
        "checked": True,
        "p_flips": p_flips,
        **{key: main[key] for key in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms",
                                      "device_ms", "library_device_ms",
                                      "library_backend")},
        "unit": "one call at [2, 2048, 1, 512] (one image encode at batch 2"
                " of 256x512)",
        "shapes": rows,
    }


def _image_vae(seed: int, **kw):
    """The SD image VAE at full width in bf16 on seeded random weights;
    an int8 one prepared from them."""
    import torch
    from ldmseg_torch.models.image_vae import ImageVAE
    from ldmseg_torch.models.layers import init_random_
    from ldmseg_torch.ops.quant import prepare_int8_vae
    vae = ImageVAE(**kw).cuda()
    init_random_(vae, torch.Generator(device="cuda").manual_seed(seed))
    vae = vae.to(torch.bfloat16).eval().requires_grad_(False)
    return prepare_int8_vae(vae)


def _corr(a, b) -> float:
    import numpy as np
    return float(np.corrcoef(a.float().cpu().numpy().ravel(),
                             b.float().cpu().numpy().ravel())[0, 1])


def phase_int8_vaes(smi_line: str, seed: int = 29):
    """Phase 42: the JAX bench's image VAE (int8, ``int8_act_scale`` 0.05,
    fused attention, its codes prepared from the bf16 weights) against the
    bf16 encoder on the same weights at batch 2 of 256x512: the modes'
    correlation >= ``VAE_CORR``, exactly one K1 D=512 launch counted and
    one traced with no other hand-written kernel in the trace, each ms and
    peak memory; the int8 seg-VAE decode (the default seg VAE) against the
    bf16 one; an image-VAE round trip (``ImageVAE.forward``, the decoder
    on) finite, with its ms."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ldmseg_torch.models.layers import init_random_
    from ldmseg_torch.models.seg_vae import SegVAE
    from ldmseg_torch.ops.quant import prepare_int8_vae
    from ldmseg_torch.utils.config import DEFAULT_CONFIG

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.rand((2, 3, 256, 512), generator=gen, device="cuda") * 2
         - 1).to(torch.bfloat16)
    vae8 = _image_vae(seed, use_int8=True, int8_act_scale=0.05,
                      use_fused_attention=True)
    vae16 = _image_vae(seed, use_fused_attention=True)
    out = {}
    with torch.inference_mode():
        _zero_counts()
        m8 = vae8.encode(x).mode()
        torch.cuda.synchronize()
        counts = _counts()
        m16 = vae16.encode(x).mode()
        corr = _corr(m8, m16)
        check(counts == _expect(K1w=1), f"int8 encode launched {counts}, "
              f"expected one K1 D=512")
        check(tuple(m8.shape) == (2, 4, 32, 64)
              and bool(torch.isfinite(m8).all()) and corr >= VAE_CORR,
              f"int8 encode {tuple(m8.shape)}: correlation with bf16 "
              f"{corr}")
        ours = "|".join(re.escape(n) for n in hand_written_kernels())
        for _ in range(3):  # a trace may drop events, never add them
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                vae8.encode(x)
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and re.search(ours, e.name)]
            if names:
                break
        wide = sum(1 for n in names if re.search(K1W_KERNEL, n))
        check(wide == 1 and len(names) == 1, f"the traced int8 encode ran "
              f"the port's kernels {names}, expected one {K1W_KERNEL}")
        torch.cuda.reset_peak_memory_stats()
        ms8 = time_ms(lambda: vae8.encode(x), iters=5, warmup=1)
        peak8 = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms16 = time_ms(lambda: vae16.encode(x), iters=5, warmup=1)
        peak16 = torch.cuda.max_memory_allocated()
        out["image_encode"] = {
            "counts": counts,
            "correlation_int8_bf16": corr, "int8_ms": ms8, "bf16_ms": ms16,
            "int8_peak_bytes": peak8, "bf16_peak_bytes": peak16,
            "traced_hand_written_kernels": names}
        print(f"phase 42 image encode, batch 2 of 256x512: int8 "
              f"{ms8:.3f} ms (peak {peak8 / 2**30:.2f} GiB), bf16 "
              f"{ms16:.3f} ms (peak {peak16 / 2**30:.2f} GiB), correlation "
              f"{corr:.5f} (gate {VAE_CORR}); launches {counts}; traced: "
              f"{names} [{smi_line}]", flush=True)
        del vae8, vae16
        torch.cuda.empty_cache()
        # the int8 seg-VAE decode against the bf16 one
        vk = {k: v for k, v in DEFAULT_CONFIG["vae_model_kwargs"].items()
              if k != "pretrained_path"}
        vk["block_out_channels"] = tuple(vk["block_out_channels"])
        seg16 = SegVAE(**vk).cuda()
        init_random_(seg16, gen)
        seg16 = seg16.to(torch.bfloat16).eval()
        seg8 = SegVAE(**vk, use_int8=True).cuda().to(torch.bfloat16).eval()
        seg8.load_state_dict(seg16.state_dict(), strict=True)
        prepare_int8_vae(seg8)
        z = torch.randn((2, 4, 32, 64), generator=gen, device="cuda").to(
            torch.bfloat16)
        d8, d16 = seg8.decode(z, True), seg16.decode(z, True)
        dcorr = _corr(d8, d16)
        check(bool(torch.isfinite(d8).all()) and dcorr >= VAE_CORR
              and d8.shape == d16.shape,
              f"int8 seg decode: correlation with bf16 {dcorr}")
        dms8 = time_ms(lambda: seg8.decode(z, True), iters=5, warmup=1)
        dms16 = time_ms(lambda: seg16.decode(z, True), iters=5, warmup=1)
        out["seg_decode"] = {"correlation_int8_bf16": dcorr,
                             "int8_ms": dms8, "bf16_ms": dms16,
                             "shape": list(d8.shape)}
        print(f"phase 42 seg-VAE decode [2, 4, 32, 64] -> "
              f"{tuple(d8.shape)}: int8 {dms8:.3f} ms, bf16 {dms16:.3f} ms,"
              f" correlation {dcorr:.5f} (gate {VAE_CORR}) [{smi_line}]",
              flush=True)
        del seg8, seg16
        torch.cuda.empty_cache()
        # the round trip through the decoder
        full = _image_vae(seed, decoder_enabled=True,
                          use_fused_attention=True)
        rec, post = full(x)
        torch.cuda.synchronize()
        check(tuple(rec.shape) == (2, 3, 256, 512)
              and bool(torch.isfinite(rec).all()),
              f"image VAE round trip: {tuple(rec.shape)}, finite "
              f"{bool(torch.isfinite(rec).all())}")
        rms = time_ms(lambda: full(x), iters=3, warmup=1)
        out["round_trip"] = {"ms": rms, "shape": list(rec.shape)}
        print(f"phase 42 image VAE round trip (ImageVAE.forward, bf16, "
              f"batch 2 of 256x512): {rms:.3f} ms, finite [{smi_line}]",
              flush=True)
        del full
        torch.cuda.empty_cache()
    return out


def phase_serving(smi_line: str, bf16_result: dict):
    """Phases 43-44: ``sample_panoptic`` in the JAX bench's serving
    configuration (``tools/bench.py:bench_config``: the int8 image VAE with
    fused attention, the default int8 UNet, bf16) at batch 2 of 256x512,
    with 50-step DDIM (phase 43) and 20-step DPM-Solver++(2M) (phase 44):
    each as phase 9 (a warm-up and a timed call, every launch checked: 16
    K3 and 16 K4 a step and one K1 D=512 a call), the graph held bit for
    bit to the eager loop with the same launches and one traced graph
    call's kernels by name against the counters."""
    import torch
    from ldmseg_torch.tools.bench import bench_config
    from ldmseg_torch.train.trainer_ldm import TrainerDiffusion

    out = {}
    for phase, sampler, steps in ((43, "ddim", SAMPLE_STEPS),
                                  (44, "dpmpp_2m", DPM_STEPS)):
        cfg = bench_config(True, sampler)
        cfg["sampling_kwargs"]["num_inference_steps"] = steps
        trainer = TrainerDiffusion(cfg)
        trainer.init_params(seed=0)
        out[sampler] = phase_int8_sample(
            trainer, f"serving ({sampler})", {"K3": 16, "K4": 16}, smi_line,
            bf16_result, calibrate=False, phase=phase,
            eager_check=True, per_call={"K1w": 1})
        del trainer
        torch.cuda.empty_cache()
    return out


def phase_codec(smi_line: str, seed: int = 31):
    """Phase 45: the native host codec (``ldmseg_torch/data/native``, built
    with g++ at first use) on a KITTI-size 375x1242 frame: its bits equal
    to the numpy codec's, decode and remap too, and its ms against
    numpy's (host clock, warm)."""
    import numpy as np
    from ldmseg_torch.data import native
    from ldmseg_torch.ops.bits import decode_bits_np, encode_bits_np

    t0 = time.perf_counter()
    path = native.build()
    build_s = time.perf_counter() - t0
    x = np.random.RandomState(seed).randint(0, 300, (375, 1242)).astype(
        np.int32)
    ours = native.encode_bits_native(x, 8)
    ref, _ = encode_bits_np(x, 8)
    analog = 2.0 * ref - 1.0
    check(np.array_equal(ours, ref)
          and np.array_equal(native.decode_bits_native(analog),
                             decode_bits_np(analog)),
          "the native codec differs from the numpy codec")

    def host_ms(fn, n=20):
        fn()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t) / n * 1e3
    nat = host_ms(lambda: native.encode_bits_native(x, 8))
    num = host_ms(lambda: encode_bits_np(x, 8))
    print(f"phase 45 native codec ({path.name}, built in {build_s:.2f} s): "
          f"375x1242 ids -> 8 bits equal to numpy's; encode {nat:.3f} ms "
          f"native, {num:.3f} ms numpy (host) [{smi_line}]", flush=True)
    return {"native_ms": nat, "numpy_ms": num, "build_seconds": build_s}


# ---------------------------------------------------------------------------
# video and pose (phases 46-51)
# ---------------------------------------------------------------------------
CLIP_T = 3                  # frames a clip (nb_ref_imgs = 2)
CLIP_HW = (256, 512)        # the sampling frames
CLIP_STRENGTH = 0.3         # sample_panoptic_clip's default refine strength
CLIP_TRAIN_CLIPS = 2        # clip training: 2 clips of 3 frames of 192x640
POSE_BATCH, POSE_STEPS = 4, 3


def _refine_steps(steps: int, strength: float = CLIP_STRENGTH) -> int:
    """k of ``ddim_refine``: the DDIM tail's steps after an S-step pass."""
    return max(1, min(steps, int(round(strength * steps))))


def _attach_random_pose(trainer, seed: int = 7):
    """A full-size ``PoseExpNet(nb_ref_imgs=2)`` with seeded random weights
    (LeCun-normal), attached without its decoder as ``main_ldm`` does."""
    import torch
    from ldmseg_torch.models.layers import init_random_
    from ldmseg_torch.models.posenet import PoseExpNet
    pose = PoseExpNet(nb_ref_imgs=CLIP_T - 1).to("cuda")
    init_random_(pose, torch.Generator(device="cuda").manual_seed(seed))
    trainer.attach_pose(pose)


def _static_clip(hw, num_bits: int = 8):
    """One clip of ``SyntheticDVPS``'s first frame repeated 3 times (image,
    depth, ground truth), as the JAX test makes its clip static
    (``tests/test_pose_ldm_integration.py:97-101``): a batch of 1 clip."""
    import numpy as np
    from ldmseg_torch.data.synthetic import SyntheticDVPS
    from ldmseg_torch.data.video import ClipDataset
    clip = ClipDataset(SyntheticDVPS(length=CLIP_T, size=hw,
                                     num_bits=num_bits,
                                     frames_per_scene=CLIP_T),
                       clip_len=CLIP_T)[0]
    out = {k: np.repeat(clip[k][:1], CLIP_T, axis=0)[None]
           for k in ("image", "depth", "semseg", "instance")}
    out["meta"] = [clip["meta"]]
    return out


def _clip_call(trainer, batch, label: str, want: dict, smi_line: str,
               profile: bool = True):
    """A warm-up and a counted ``sample_panoptic_clip`` call (both passes
    CUDA graphs) with ``panoptic_post_process``: s a call, peak memory, the
    launches against ``want``; then the eager loop at the same noise (x0
    bit-equal, the same launches) and one traced graph call
    (:func:`graph_vs_eager`, with ``profile``)."""
    import torch
    from ldmseg_torch.ops.panoptic import panoptic_post_process
    trainer.sample_panoptic_clip(batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    logits, x0 = trainer.sample_panoptic_clip(batch)
    cleaned, _ = panoptic_post_process(
        logits, mask_th=trainer.mask_th, count_th=trainer.count_th,
        overlap_th=trainer.overlap_th, ignore_label=trainer.ignore_label)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    h, w = CLIP_HW
    check(tuple(logits.shape) == (CLIP_T, h, w, trainer.num_classes)
          and bool(torch.isfinite(logits).all())
          and tuple(x0.shape) == (CLIP_T, h // 8, w // 8, 4)
          and tuple(cleaned.shape) == (CLIP_T, h, w),
          f"{label}: logits, x0 or post-process of the wrong shape or not "
          f"finite")
    check(counts == want, f"{label}: launched {counts}, expected {want}")
    eager = graph_vs_eager(
        label, lambda g: trainer.sample_panoptic_clip(batch, graph=g), x0,
        counts, smi_line, profile=profile)
    return {"seconds": secs, "frames_per_s": CLIP_T / secs,
            "peak_bytes": peak, "counts": counts, "eager": eager}, x0, \
        cleaned


def phase_clip_sample(smi_line: str, seed: int = 0):
    """Phase 46: ``sample_panoptic_clip`` in the default deployment at full
    width (the SD-1.4 UNet and image VAE, bf16, self-conditioning; seeded
    random weights) on one static clip of 3 frames of 256x512 with a
    full-size ``PoseExpNet`` attached: DDIM (``SAMPLE_STEPS``), then the
    pose warp and a DDIM tail of 0.3 of those steps (``refine_strength``),
    both passes CUDA graphs: 16 K1 a step of either pass on the counters
    and in one traced graph call,
    the graph bit-equal to the eager loop (the whole call, and the first
    pass alone with ``pose_warp=False``); then, at the same per-frame noise
    (``repeat_noise=False``), the warped call's frames disagree less than
    the unwarped call's."""
    import numpy as np
    import torch
    from ldmseg_torch.train.trainer_ldm import TrainerDiffusion

    trainer = TrainerDiffusion(_config())
    trainer.init_params(seed=seed)
    _attach_random_pose(trainer)
    batch = _static_clip(CLIP_HW)
    steps = trainer.num_inference_steps
    k = _refine_steps(steps)
    res, x0, cleaned = _clip_call(
        trainer, batch, "phase 46 bf16 clip", _expect(K1=16 * (steps + k)),
        smi_line)
    # frame consistency at the same per-frame noise, warped or not; the
    # unwarped call (the first pass alone) against its eager loop too
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    lh, lw = CLIP_HW[0] // 8, CLIP_HW[1] // 8
    init = torch.randn((1, CLIP_T, lh, lw, 4), generator=gen, device="cuda")
    refine = torch.randn((1, 1, lh, lw, 4), generator=gen, device="cuda")

    def clip_x0(pose_warp, graph=None):
        return trainer.sample_panoptic_clip(
            batch, init_noise=init, refine_noise=refine, repeat_noise=False,
            pose_warp=pose_warp, graph=graph)[1]

    def disagreement(x):
        return float((x[1:] - x[:-1]).abs().mean())
    unwarped = clip_x0(False)
    _zero_counts()
    first_eager = clip_x0(False, graph=False)
    torch.cuda.synchronize()
    check(torch.equal(first_eager, unwarped)
          and _counts() == _expect(K1=16 * steps),
          f"phase 46: the first pass's graph differs from its eager loop "
          f"(launches {_counts()})")
    warped, plain = disagreement(clip_x0(True)), disagreement(unwarped)
    check(warped < plain, f"phase 46: the warped clip's frames disagree "
          f"{warped} >= the unwarped clip's {plain}")
    prof = res["eager"]["graph_profile"]
    print(f"phase 46 sample_panoptic_clip (bf16, DDIM {steps} + a {k}-step "
          f"DDIM tail, both CUDA graphs, 1 clip x {CLIP_T} x "
          f"{CLIP_HW[0]}x{CLIP_HW[1]}, PoseExpNet attached): "
          f"{res['seconds']:.3f} s a call, {res['frames_per_s']:.3f} "
          f"frames/s, kernels {_ms(prof.get('device_ms'))} ms, busy "
          f"{_ms(prof.get('busy_share'))}, peak memory "
          f"{res['peak_bytes'] / 2**30:.2f} GiB, K1 {res['counts']['K1']}; "
          f"the first pass alone bit-equal to its eager loop; frame "
          f"disagreement warped {warped:.5f} vs unwarped {plain:.5f}"
          f" [{smi_line}]", flush=True)
    res.update({"x0": x0.float().cpu().numpy(),
                "disagreement_warped": warped,
                "disagreement_unwarped": plain})
    gt = {"semseg": batch["semseg"][0], "instance": batch["instance"][0],
          "cleaned": cleaned.cpu().numpy()}
    del trainer
    torch.cuda.empty_cache()
    return res, gt


def phase_clip_serving(smi_line: str, seed: int = 0):
    """Phase 47: ``sample_panoptic_clip`` in the JAX bench's serving
    configuration (``tools/bench.py:bench_config``: the int8 image VAE with
    fused attention, the int8 UNet, bf16) on phase 46's clip, with DDIM
    ``SAMPLE_STEPS`` and DPM-Solver++(2M) ``DPM_STEPS``, each with a DDIM
    tail of 0.3 of its steps: 16 K3 and 16 K4 a step of either pass and one K1
    D=512 a call (the 3 frames encode in one batch), the graphs bit-equal
    to the eager loop; DDIM's: one traced graph call, and the x0 correlated
    >= 0.9 with the same trainer's bf16 UNet on the same noise."""
    import numpy as np
    import torch
    from ldmseg_torch.tools.bench import bench_config
    from ldmseg_torch.train.trainer_ldm import TrainerDiffusion

    batch = _static_clip(CLIP_HW)
    out = {}
    for sampler, steps in (("ddim", SAMPLE_STEPS), ("dpmpp_2m", DPM_STEPS)):
        cfg = bench_config(True, sampler)
        cfg["sampling_kwargs"]["num_inference_steps"] = steps
        trainer = TrainerDiffusion(cfg)
        trainer.init_params(seed=seed)
        _attach_random_pose(trainer)
        n = 16 * (steps + _refine_steps(steps))
        label = f"phase 47 serving clip ({sampler} {steps})"
        ddim = sampler == "ddim"
        res, x0, _ = _clip_call(trainer, batch, label,
                                _expect(K3=n, K4=n, K1w=1), smi_line,
                                profile=ddim)
        corr = None
        if ddim:
            trainer.int8_inference = False  # the same weights, bf16 UNet
            try:
                _, x0_bf16 = trainer.sample_panoptic_clip(batch)
            finally:
                trainer.int8_inference = True
            corr = float(np.corrcoef(
                x0.float().cpu().numpy().ravel(),
                x0_bf16.float().cpu().numpy().ravel())[0, 1])
            check(corr >= 0.9, f"{label}: x0 correlation with bf16 {corr}")
        prof = res["eager"]["graph_profile"] or {}
        print(f"{label}: {res['seconds']:.3f} s a call, "
              f"{res['frames_per_s']:.3f} frames/s, kernels "
              f"{_ms(prof.get('device_ms'))} ms, busy "
              f"{_ms(prof.get('busy_share'))}, peak memory "
              f"{res['peak_bytes'] / 2**30:.2f} GiB, launches "
              f"{res['counts']}; x0 correlation with the bf16 UNet's "
              f"{_ms(corr)} [{smi_line}]", flush=True)
        res["x0_correlation_with_bf16"] = corr
        out[sampler] = res
        del trainer
        torch.cuda.empty_cache()
    return out


def phase_clip_train(smi_line: str, seed: int = 0, timed: int = 2):
    """Phase 48: clip training at full width: ``train_loop`` on 2 clips x 3
    frames of 192x640 (``ClipDataset`` of ``SyntheticDVPS``) with
    ``temporal_consistency_weight`` 0.1 and a full-size pose net attached
    (bf16 on fp32 masters, self-conditioning, AdamW): 1 warm-up and
    ``timed`` timed steps, 32 K1 and 16 K2 a step; a finite consistency
    term > 0, every trained parameter changed; one step's loss and
    gradients on K1/K2 against the same step on the plain attention (loss
    1e-2, cosine >= 0.99), as phase 6."""
    import torch
    from ldmseg_torch.data import collate
    from ldmseg_torch.data.synthetic import SyntheticDVPS
    from ldmseg_torch.data.video import ClipDataset
    from ldmseg_torch.models.unet import CrossAttention
    from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
    from ldmseg_torch.utils.config import merge_dicts

    clips = ClipDataset(SyntheticDVPS(length=2 * CLIP_TRAIN_CLIPS * CLIP_T,
                                      size=TRAIN_HW, num_bits=8,
                                      frames_per_scene=CLIP_T),
                        clip_len=CLIP_T)
    cfg = merge_dicts(_train_config(), {"train_kwargs": {
        "batch_size": CLIP_TRAIN_CLIPS, "video_clips": CLIP_T,
        "temporal_consistency_weight": 0.1}})
    trainer = TrainerDiffusion(cfg, dataset=clips)
    trainer.init_params(seed=seed)
    _attach_random_pose(trainer)
    unet = trainer.unet
    masters = {n: p.detach().clone() for n, p in unet.named_parameters()}
    warm = trainer.train_loop(max_steps=1, log_every=1, seed=seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _zero_counts()
    t0 = time.perf_counter()
    losses = trainer.train_loop(max_steps=timed, log_every=timed,
                                seed=seed + 1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    check(counts == _expect(K1=32 * timed, K2=16 * timed),
          f"clip train steps launched {counts}, expected {32 * timed} K1 "
          f"and {16 * timed} K2")
    check(all(math.isfinite(x) for x in warm + losses),
          f"clip train losses {warm + losses}")
    moved = [not torch.equal(p.detach(), masters[n])
             for n, p in unet.named_parameters()
             if not n.startswith("time_embedding")]
    check(all(moved), f"{moved.count(False)} trained parameters unchanged")
    del masters
    batch = collate([clips[0], clips[1]])
    frames = CLIP_TRAIN_CLIPS * CLIP_T
    dev = trainer.device
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    lh, lw = TRAIN_HW[0] // 8, TRAIN_HW[1] // 8
    noise = torch.randn((frames, lh, lw, 4), generator=gen, device=dev)
    steps = torch.randint(0, 1000, (CLIP_TRAIN_CLIPS,), generator=gen,
                          device=dev).repeat_interleave(CLIP_T)
    attn = [m for m in unet.modules() if isinstance(m, CrossAttention)]
    results = {}
    for fused in (True, False):
        for m in attn:
            m.use_fused = fused
        trainer.state.zero_grad()
        loss, metrics, _ = trainer.forward_backward(batch, noise=noise,
                                                    timesteps=steps)
        results[fused] = (loss.item(), float(metrics["consistency"]),
                          _flat_grads(unet))
    for m in attn:
        m.use_fused = True
    trainer.state.zero_grad()
    (loss_f, cons_f, g_f), (loss_p, cons_p, g_p) = results[True], \
        results[False]
    cos = (torch.dot(g_f, g_p) / (g_f.norm() * g_p.norm())).item()
    loss_rel = abs(loss_f - loss_p) / abs(loss_p)
    del results, g_f, g_p
    check(math.isfinite(cons_f) and cons_f > 0,
          f"the consistency term is {cons_f}")
    check(loss_rel <= 1e-2, f"clip train loss on K1/K2 vs plain: rel "
          f"{loss_rel}")
    check(cos >= 0.99, f"clip gradient cosine on K1/K2 vs plain: {cos}")
    print(f"phase 48 clip train_loop: {timed} steps of {CLIP_TRAIN_CLIPS} "
          f"clips x {CLIP_T} x {TRAIN_HW[0]}x{TRAIN_HW[1]} with the pose "
          f"net and temporal_consistency_weight 0.1: "
          f"{secs / timed:.4f} s/step, {frames * timed / secs:.3f} frames/s,"
          f" peak memory {peak / 2**30:.2f} GiB ({held / 2**30:.2f} held "
          f"before the window), launches K1 {counts['K1']}"
          f" / K2 {counts['K2']}; consistency {cons_f:.5f} (plain "
          f"{cons_p:.5f}), loss {loss_f:.6f} vs plain {loss_p:.6f} (rel "
          f"{loss_rel:.2e}), gradient cosine {cos:.6f} [{smi_line}]",
          flush=True)
    del trainer
    torch.cuda.empty_cache()
    return {"seconds_per_step": secs / timed, "peak_bytes": peak,
            "held_bytes": held, "counts": counts, "consistency": cons_f,
            "loss_rel": loss_rel, "grad_cosine": cos, "losses": warm + losses}


def phase_pose_train(smi_line: str, seed: int = 0):
    """Phase 49: ``TrainerPose`` at full size (``PoseExpNet(nb_ref_imgs=2,
    output_exp=True)``, fp32, AdamW) on batches of 4 clips of 3 frames of
    192x640: 1 warm-up and 3 timed steps; the photometric and mask terms
    finite, every parameter that a loss term reaches changed. No
    hand-written kernel runs here (0 launches)."""
    import os
    import tempfile
    import torch
    from ldmseg_torch.data.synthetic import SyntheticDVPS
    from ldmseg_torch.data.video import ClipDataset
    from ldmseg_torch.train.trainer_pose import TrainerPose
    from ldmseg_torch.utils.config import DEFAULT_CONFIG, merge_dicts

    clips = ClipDataset(SyntheticDVPS(length=POSE_BATCH * CLIP_T,
                                      size=TRAIN_HW, num_bits=8,
                                      frames_per_scene=CLIP_T),
                        clip_len=CLIP_T)
    cfg = merge_dicts(DEFAULT_CONFIG, {"train_kwargs": {
        "batch_size": POSE_BATCH, "train_num_steps": 1 + POSE_STEPS}})
    with tempfile.TemporaryDirectory() as root:
        trainer = TrainerPose(cfg, dataset=clips, results_folder=root,
                              nb_ref_imgs=CLIP_T - 1, output_exp=True)
        trainer.init_params(seed=seed)
        before = {n: p.detach().clone()
                  for n, p in trainer.model.named_parameters()}
        trainer.train_loop(seed=seed, max_steps=1, log_every=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        losses = trainer.train_loop(seed=seed + 1, max_steps=POSE_STEPS,
                                    log_every=POSE_STEPS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _counts()
        peak = torch.cuda.max_memory_allocated()
        from ldmseg_torch.data import collate
        batch = collate([clips[i] for i in range(POSE_BATCH)])
        with torch.no_grad():
            _, parts = trainer.forward_loss(batch)
        photo, mask = float(parts["photo"]), float(parts["mask_reg"])
        path = trainer.save(step=1 + POSE_STEPS)
        ckpt_bytes = os.path.getsize(path)
    check(counts == _expect(), f"TrainerPose launched {counts}")
    check(all(math.isfinite(x) for x in losses + [photo, mask])
          and photo > 0 and mask > 0,
          f"TrainerPose losses {losses}, photo {photo}, mask {mask}")
    # the coarser masks (predict_mask2-4) feed no loss term
    unused = ("predict_mask2", "predict_mask3", "predict_mask4")
    moved = [not torch.equal(p.detach(), before[n])
             for n, p in trainer.model.named_parameters()
             if not n.startswith(unused)]
    check(all(moved), f"{moved.count(False)} pose parameters unchanged")
    print(f"phase 49 TrainerPose: {POSE_STEPS} steps of {POSE_BATCH} clips "
          f"x {CLIP_T} x {TRAIN_HW[0]}x{TRAIN_HW[1]}, PoseExpNet with the "
          f"explainability decoder, fp32: {secs / POSE_STEPS:.4f} s/step, "
          f"peak memory {peak / 2**30:.2f} GiB; photo {photo:.5f}, mask_reg"
          f" {mask:.5f}; checkpoint {ckpt_bytes} bytes; no hand-written "
          f"kernel runs here (launches {counts}) [{smi_line}]", flush=True)
    del trainer
    torch.cuda.empty_cache()
    return {"seconds_per_step": secs / POSE_STEPS, "peak_bytes": peak,
            "losses": losses, "photo": photo, "mask_reg": mask,
            "checkpoint_bytes": ckpt_bytes}


def _crowded_pair(hw=(256, 512), block: int = 8, seed: int = 7):
    """A prediction and a ground truth of about 400 distinct ids each (8
    thing classes x 50 instances on a grid of blocks), the prediction a
    fifth resampled: a window past 256 segments."""
    import numpy as np
    from ldmseg_torch.evals.vpq import MAX_INS
    rng = np.random.RandomState(seed)
    hs, ws = hw[0] // block, hw[1] // block

    def ids():
        return rng.randint(0, 8, (hs, ws)) * MAX_INS + rng.randint(
            0, 50, (hs, ws))
    up = np.ones((block, block), dtype=np.int64)
    gt = np.kron(ids(), up)
    pred = gt.copy()
    m = np.kron(rng.rand(hs, ws) < 0.2, up).astype(bool)
    pred[m] = np.kron(ids(), up)[m]
    return pred // MAX_INS, pred % MAX_INS, gt // MAX_INS, gt % MAX_INS


def phase_vpq(smi_line: str, clip_gt: dict):
    """Phase 50: VPQ statistics on the card (``evals/vpq.py:
    vpq_eval_device``) for each 2-frame window of phase 46's post-processed
    maps (class-agnostic: ``cat`` 0, ``ins`` the panoptic id, as
    ``predict`` writes them) against the clip's ground truth, and for a
    crowded pair of frames (over 256 segments a map, so that
    ``evaluate_dvpq``'s exact count grows ``max_seg``): tp, fn and fp equal
    to the numpy oracle's, iou within 1e-5, ``evaluate_dvpq`` on the card
    equal to the oracle's scores; device and host ms a window."""
    import numpy as np
    import torch
    from ldmseg_torch.evals import (count_segments_device, dvpq_windows,
                                    evaluate_dvpq, grown_max_seg,
                                    vpq_eval_device, vpq_eval_np)

    cleaned = clip_gt["cleaned"]
    ins = [np.maximum(c, 0) for c in cleaned]
    cat = [np.zeros_like(i) for i in ins]
    gt_cat = list(clip_gt["semseg"])
    gt_ins = list(clip_gt["instance"])
    pc, pi, gc, gi = _crowded_pair()
    sets = {"phase 46 clip": (cat, ins, gt_cat, gt_ins),
            "crowded": ([pc, pc], [pi, pi], [gc, gc], [gi, gi])}
    out = {}
    for name, frames in sets.items():
        dev_ms, host_ms, segs = [], [], []
        for pred, gt in dvpq_windows(*frames, eval_frames=2):
            p, g = torch.from_numpy(pred).cuda(), torch.from_numpy(gt).cuda()
            n_gt, n_pred = (int(x) for x in count_segments_device(p, g))
            check((n_gt, n_pred) == (len(np.unique(gt)),
                                     len(np.unique(pred))),
                  f"phase 50 {name}: segment counts {(n_gt, n_pred)}")
            seg = grown_max_seg(max(n_gt, n_pred))
            segs.append((n_gt, n_pred, seg))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ours = [x.cpu().numpy() for x in vpq_eval_device(p, g,
                                                              max_seg=seg)]
            dev_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            ref = vpq_eval_np(pred, gt)
            host_ms.append((time.perf_counter() - t0) * 1e3)
            for a, b, what in zip(ours, ref, ("iou", "tp", "fn", "fp")):
                ok = (np.allclose(a, b, rtol=0, atol=1e-5) if what == "iou"
                      else np.array_equal(a, b))
                check(ok, f"phase 50 {name}: {what} {a} vs the oracle's {b}")
        scores = evaluate_dvpq(*frames, eval_frames=2)
        host = evaluate_dvpq(*frames, eval_frames=2, device="host")
        check(all(abs(scores[k] - host[k]) <= 1e-6 * max(1.0, abs(host[k]))
                  for k in ("pq", "tpq", "spq")),
              f"phase 50 {name}: evaluate_dvpq {scores} vs the oracle's "
              f"{host}")
        out[name] = {"segments": segs, "device_ms": dev_ms,
                     "host_ms": host_ms, "pq": scores["pq"]}
        print(f"phase 50 VPQ on the card, {name}: {len(dev_ms)} windows of "
              f"2 frames, segments (gt, pred, max_seg) {segs}: counts equal "
              f"to the numpy oracle's, iou within 1e-5, PQ {scores['pq']:.3f}"
              f" equal to the oracle's; device {_ms(min(dev_ms))} ms a "
              f"window (host clock, the read-back included), numpy "
              f"{_ms(min(host_ms))} ms [{smi_line}]", flush=True)
    check(max(s[2] for s in out["crowded"]["segments"]) > 256,
          "phase 50: the crowded window did not grow max_seg")
    return out


def phase_video_cli(smi_line: str):
    """Phase 51: the video command lines chained on the card in a temporary
    directory, each reading the file the one before wrote: ``main_pose``
    (synthetic preset, 2 steps at batch 4 of 3-frame clips) -> ``main_ldm
    video_clips=3 pose_model_kwargs.pretrained_path=...`` (a narrow UNet,
    as phase 38; 2 steps at batch 2 clips with
    ``temporal_consistency_weight`` 0.1; 32 K1 and 16 K2 a step on its 4
    attention sites, then its ``compute_pq``) -> ``predict clips=3`` (that
    run's checkpoint and the pose net: 2 clips, 2 DDIM steps and a 1-step
    tail) -> ``eval_dvpq`` on the written PNGs against the ground truth
    of those frames, on the card and with the numpy oracle: equal
    scores."""
    import os
    import tempfile
    import numpy as np
    import torch
    from PIL import Image
    from ldmseg_torch.data.synthetic import SyntheticDVPS
    from ldmseg_torch.data.video import ClipDataset
    from ldmseg_torch.tools import eval_dvpq, main_ldm, main_pose, predict

    narrow = ["train_kwargs.self_condition=True",
              "train_kwargs.weight_dtype=bfloat16",
              "model_kwargs.block_out_channels=[64,128]",
              "model_kwargs.layers_per_block=1",
              "model_kwargs.attn_down=[True,False]",
              "sampling_kwargs.num_inference_steps=2"]
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        _zero_counts()
        pose = main_pose.main(["train_kwargs.train_num_steps=2",
                               "train_kwargs.batch_size=4", "clip_len=3",
                               f"output_dir={root}/pose", "run_idx=0"])
        torch.cuda.synchronize()
        pose_s = time.perf_counter() - t0
        ckpt = os.path.join(root, "pose", "run_0", "checkpoints", "step_2")
        check(pose.state.step == 2 and os.path.exists(ckpt)
              and _counts() == _expect(),
              f"main_pose: step {pose.state.step}, launches {_counts()}")
        del pose
        _zero_counts()
        t0 = time.perf_counter()
        ldm = main_ldm.main(narrow + [
            "train_kwargs.train_num_steps=2", "train_kwargs.batch_size=2",
            "train_kwargs.video_clips=3",
            "train_kwargs.temporal_consistency_weight=0.1",
            f"pose_model_kwargs.pretrained_path={ckpt}",
            "eval_first=False", f"output_dir={root}/ldm", "run_idx=0"])
        torch.cuda.synchronize()
        ldm_s = time.perf_counter() - t0
        counts = _counts()
        calls = min(-(-len(ldm.ds_val) // ldm.batch_size), 4)
        sites = 4
        want = _expect(K1=2 * sites * 2 + sites * 2 * calls, K2=sites * 2)
        check(counts == want, f"main_ldm on clips launched {counts}, "
              f"expected {want}")
        check(ldm.state.step == 2 and ldm.pose_model is not None
              and ldm.ds.clip_len == 3,
              f"main_ldm on clips stopped at {ldm.state.step}")
        del ldm
        torch.cuda.empty_cache()
        preds = os.path.join(root, "preds")
        _zero_counts()
        t0 = time.perf_counter()
        written = predict.main(narrow + [
            "clips=3", "max_batches=1", "eval_kwargs.batch_size=2",
            f"pose_model_kwargs.pretrained_path={ckpt}",
            f"checkpoint={root}/ldm/run_0/checkpoints/step_2",
            f"out_dir={preds}"])
        torch.cuda.synchronize()
        predict_s = time.perf_counter() - t0
        pcounts = _counts()
        check(written == 6 and pcounts == _expect(K1=sites * (2 + 1) * 1),
              f"predict clips=3 wrote {written} pairs, launched {pcounts}")
        # the ground truth of the frames predict wrote (its val clips)
        val = ClipDataset(SyntheticDVPS(length=16, size=TRAIN_HW,
                                        num_classes=20, num_bits=5),
                          clip_len=3, stride=3)
        gt_dir = os.path.join(root, "gt")
        os.makedirs(gt_dir)
        for clip in val.clips[:2]:
            for i in clip:
                f = val.base[i]
                stem = f"{f['meta']['image_id']:012d}"
                Image.fromarray(f["semseg"].astype(np.uint8)).save(
                    os.path.join(gt_dir, f"{stem}_gtFine_class.png"))
                Image.fromarray(f["instance"].astype(np.uint8)).save(
                    os.path.join(gt_dir, f"{stem}_gtFine_instance.png"))
        args = ["--pan_dir", preds, "--gt_dir", gt_dir, "--eval_frames", "2"]
        t0 = time.perf_counter()
        scores = eval_dvpq.main(args)
        eval_s = time.perf_counter() - t0
        host = eval_dvpq.main(args + ["--host"])
        check(all(abs(scores[k] - host[k]) <= 1e-6 * max(1.0, abs(host[k]))
                  for k in ("pq", "tpq", "spq")),
              f"eval_dvpq on the card {scores} vs the oracle's {host}")
    print(f"phase 51 video CLIs: main_pose (2 steps, batch 4 clips of "
          f"192x640) {pose_s:.1f} s; main_ldm video_clips=3 with its pose "
          f"net (2 steps, batch 2 clips, PQ at 2 DDIM steps, {calls} calls)"
          f" {ldm_s:.1f} s, launches {counts}; predict clips=3 ({written} "
          f"frames, launches {pcounts}) {predict_s:.1f} s; eval_dvpq on the"
          f" card {eval_s:.2f} s, PQ {scores['pq']:.3f} equal to the "
          f"oracle's [{smi_line}]", flush=True)
    return {"main_pose_seconds": pose_s, "main_ldm_seconds": ldm_s,
            "predict_seconds": predict_s, "eval_dvpq_seconds": eval_s,
            "counts": counts, "predict_counts": pcounts}


# the trained-model gate at reduced steps (its defaults: 300 / 500 / 100)
GATE_STEPS = {"ae": 20, "ldm": 30, "pose": 5}


def _attention_sites(unet) -> int:
    from ldmseg_torch.models.unet import Transformer2D
    return sum(isinstance(m, Transformer2D) for m in unet.modules())


def _gate_counts(stages: dict) -> dict:
    """The gate's launches and fallbacks summed over its stages, keyed as
    :func:`_counts` (each stage set the counters to 0 when it started)."""
    ids = {f.__name__: k for k, f in _wrappers().items()}
    out = _expect()
    for stage in stages.values():
        if not isinstance(stage, dict) or "launches" not in stage:
            continue
        for name, n in stage["launches"].items():
            kid = "K1w" if name == "K1 D=512" else ids.get(name, name)
            out[kid] = out.get(kid, 0) + n
        out["fallbacks"] += sum(stage["fallbacks"].values())
    return out


def phase_trained_gate(smi_line: str):
    """Phase 52: ``tools/trained_gate.py`` at reduced steps (stage 1 20,
    stage 2 30, pose 5; 1 validation batch of 8 frames of 96x320, 10 DDIM
    steps) in its temporary directory. The ground truth scored against itself
    reads 100 in every category it holds; every number is finite; each
    stage launches the kernels JAX's rules send its sites to and no other
    (12x40 latent: T = 480 and 120, head dims 16 and 32, all kernel
    shapes): K2 once a site a step and K1 in stage-2 training, K1 once a
    site a step in bf16 sampling (the pose-warped clip call's 4-step tail
    too), K3 and K4 once a site a step in int8 sampling (K1 once a site in
    its calibration's fp32 forward), nothing in stage 1 and the pose net,
    no fallback anywhere; stage 2's sampling graph bit-equal to
    its eager loop on one batch. The three gates are printed, not
    asserted: they need the default steps."""
    import math
    import torch
    from ldmseg_torch.data.loader import Loader
    from ldmseg_torch.tools import trained_gate

    t0 = time.perf_counter()
    line, stages, tr = trained_gate.run(
        GATE_STEPS["ae"], GATE_STEPS["ldm"], GATE_STEPS["pose"],
        val_batches=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _gate_counts(stages)
    sanity = stages["sanity DVPQ(gt, gt)"]
    check(sanity["present_pq_min"] > 100 - 1e-6
          and sanity["present_pq_max"] < 100 + 1e-6,
          f"DVPQ(gt, gt) per held category {sanity}, expected 100")
    numbers = [line[k] for k in line if k.startswith(("dvpq", "recon"))]
    check(all(math.isfinite(v) for v in numbers),
          f"the gate's line has a non-finite number: {line}")
    sites = _attention_sites(tr["ldm"].unet)
    steps = 10
    want = {
        "stage 2 sample, step 0": {"K1": sites * steps},
        "stage 2 sample": {"K1": sites * steps},
        # the calibration's forward on the fp32 masters runs K1 (fp32)
        "int8 sample": {"K1": sites, "K3": sites * steps,
                        "K4": sites * steps},
        "clip sample, per frame": {"K1": sites * steps},
    }
    check(math.isfinite(stages["stage 1 reconstruction DVPQ"]),
          f"stage 1 reconstruction DVPQ {stages}")
    for name, stage in stages.items():
        if not isinstance(stage, dict) or "launches" not in stage:
            continue
        got = {k: v for k, v in stage["launches"].items() if v}
        check(not any(stage["fallbacks"].values()),
              f"{name}: fallbacks {stage['fallbacks']} at shapes JAX's "
              f"rules send to the kernels")
        if name == "stage 2 train":
            check(set(got) == {"K1", "K2"}
                  and got["K2"] == sites * GATE_STEPS["ldm"]
                  and got["K1"] >= sites * GATE_STEPS["ldm"],
                  f"{name} launched {got} ({sites} attention sites)")
        elif name in want:
            check(got == want[name], f"{name} launched {got}, expected "
                  f"{want[name]}")
        elif name == "clip sample, pose-warped":
            tail = _refine_steps(steps, 0.4)
            check(got == {"K1": sites * (steps + tail)},
                  f"{name} launched {got}, expected K1 "
                  f"{sites * (steps + tail)}")
        else:
            check(not got, f"{name} launched {got}, expected none")
    # stage 2's sampling: the graph bit-equal to the eager loop
    ldm = tr["ldm"]
    batch = next(iter(Loader(tr["val"], 8, shuffle=False)))
    b, h, w = batch["semseg"].shape
    noise = torch.randn((b, h // 8, w // 8, 4),
                        generator=torch.Generator().manual_seed(0))
    _, x0_graph = ldm.sample_panoptic(batch, init_noise=noise)
    _, x0_eager = ldm.sample_panoptic(batch, init_noise=noise,
                                      graph=False)
    check(torch.equal(x0_graph, x0_eager),
          "stage 2: the sampling graph's x0 differs from the eager "
          f"loop's by {(x0_graph - x0_eager).abs().max().item():.3e}")
    del tr, ldm
    torch.cuda.empty_cache()
    s_per_step = {name: round(stage["step_timer"]["mean_s"], 4)
                  for name, stage in stages.items()
                  if isinstance(stage, dict) and stage.get("step_timer")}
    print(f"phase 52 trained gate at {GATE_STEPS} steps: {seconds:.1f} s; "
          f"DVPQ(gt, gt) {sanity['dvpq']:.3f} over 32 categories, "
          f"{sanity['present']} held at 100; reconstruction DVPQ "
          f"{stages['stage 1 reconstruction DVPQ']:.2f}; line "
          f"{json.dumps(line)}; s/step {json.dumps(s_per_step)}; gates "
          f"(not asserted at these steps) {line['gates']}; graph bit-equal "
          f"to eager [{smi_line}]", flush=True)
    return {"seconds": seconds, "line": line, "stages": stages,
            "counts": counts}


def phase_loader_bench(smi_line: str):
    """Phase 53: ``tools/loader_bench.py`` at 32 frames of 375x1242 (4
    scenes, batch 16, 8 threads): samples/s of the port's ``Loader``
    on the host's cores, and the single-thread decode ms a sample."""
    from ldmseg_torch.tools import loader_bench
    t0 = time.perf_counter()
    line = loader_bench.main(["--frames", "32"])
    seconds = time.perf_counter() - t0
    check(line["frames"] == 32 and line["value"] > 0,
          f"loader_bench: {line}")
    print(f"phase 53 loader bench: {line['value']} samples/s over "
          f"{line['frames']} frames on {line['host_cores_usable']} of "
          f"{line['host_cores']} host cores, {line['threads']} threads; "
          f"{line['per_sample_decode_ms_1thread']} ms a sample on one "
          f"thread; {seconds:.1f} s [{smi_line}]", flush=True)
    return line | {"seconds": seconds}


def phase_perf_tools(smi_line: str):
    """Phase 54: ``tools/profile_training.py --remat-sweep`` and
    ``tools/bench.py --breakdown`` at batch 2, one timed step or call each:
    every remat setting runs (no out-of-memory at this batch) with finite
    samples/s and its peak memory; the breakdown's encode, 50-step loop and
    decode ms finite and positive."""
    import math
    import torch
    from ldmseg_torch.tools import bench, profile_training
    t0 = time.perf_counter()
    sweep = profile_training.remat_sweep(batch=2, iters=1)
    torch.cuda.empty_cache()
    check(all("error" not in r and math.isfinite(r["samples_per_s"])
              and r["samples_per_s"] > 0 for r in sweep.values())
          and len(sweep) == len(profile_training.REMAT_SETTINGS),
          f"remat sweep at batch 2: {sweep}")
    parts = bench.breakdown(batch=2, iters=1, loop_iters=1)
    torch.cuda.empty_cache()
    check(all(math.isfinite(parts[k]) and parts[k] > 0
              for k in ("encode_ms", "loop_ms", "decode_ms")),
          f"breakdown at batch 2: {parts}")
    seconds = time.perf_counter() - t0
    print(f"phase 54 remat sweep at batch 2: " + "; ".join(
        f"{k} {v['samples_per_s']:.2f} samples/s, peak "
        f"{v['peak_bytes'] / 2**30:.2f} GiB" for k, v in sweep.items())
        + f"; breakdown at batch 2: encode {parts['encode_ms']:.1f} ms, "
        f"loop {parts['loop_ms']:.1f} ms, decode {parts['decode_ms']:.1f} "
        f"ms, {parts['frames_per_s']:.2f} frames/s; {seconds:.1f} s "
        f"[{smi_line}]", flush=True)
    return {"remat_sweep": sweep, "breakdown": parts, "seconds": seconds}


COND_SEED = 41                    # the conditioning phases' draws
COND_CONTEXT = (2, 77, 768)       # a CLIP-text-sized context, batch 2


def _cond_config(**over):
    """The default deployment (``_config``) with the ``none`` descriptor:
    cross-attention on a caller's context, guidance 7.5 (the default
    config's)."""
    from ldmseg_torch.utils.config import merge_dicts
    return merge_dicts(_config(), {"train_kwargs": {
        "image_descriptors": "none"}, **over})


def _cond_batch(seed: int = COND_SEED, scale: float = 1.0):
    import numpy as np
    import torch
    image = np.random.RandomState(seed).randn(2, 256, 512, 3).astype(
        np.float32)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ctx = torch.randn(COND_CONTEXT, generator=gen, device="cuda") * scale
    return {"image": image, "context": ctx}


def _cond_call(trainer, batch, label: str, want: dict, **kw):
    """One counted ``sample_panoptic`` (a CUDA graph): s a call, peak
    memory, the launches against ``want``; returns (result, x0)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    logits, x0 = trainer.sample_panoptic(batch, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts()
    check(tuple(logits.shape) == (2, 256, 512, trainer.num_classes)
          and bool(torch.isfinite(logits).all())
          and tuple(x0.shape) == (2, 32, 64, 4)
          and bool(torch.isfinite(x0).all()),
          f"{label}: logits or x0 of the wrong shape or not finite")
    check(counts == want, f"{label}: launched {counts}, expected {want}")
    return {"seconds": secs, "frames_per_s": 2 / secs, "counts": counts,
            "peak_bytes": torch.cuda.max_memory_allocated()}, x0


def phase_cond_sample(smi_line: str, seed: int = 0):
    """Phase 55: conditioning and classifier-free guidance at full width
    (:func:`_cond_config`; seeded random weights, ``SAMPLE_STEPS`` DDIM
    steps, batch 2 of 256x512, a context of :data:`COND_CONTEXT`). Each
    UNet call runs 16 K1 (self-attention; ``attn2`` is the plain einsum, as
    in JAX); CFG makes two calls a step: 32 K1 a step at guidance 7.5, the
    graph bit-equal to the eager loop with the same launches, one graph
    call traced (its kernels by name against the counters; the kernel
    time over the traced wall, and over the untraced call's wall: the
    profiler slows the host); 16 a step at guidance 1.0, whose x0
    differs; another context another x0; then a clip of 3 frames with its
    context per clip and a pose net: 32 K1 a step of either pass. Prints
    the seconds of each part."""
    import torch
    from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
    t0 = time.perf_counter()
    trainer = TrainerDiffusion(_cond_config())
    trainer.init_params(seed=seed)
    check(trainer.guidance_scale == 7.5
          and trainer.unet_config.use_cross_attention
          and trainer.unet_config.cross_attention_dim == COND_CONTEXT[2],
          f"phase 55: the trainer's conditioning {trainer.unet_config}")
    steps = trainer.num_inference_steps
    batch = _cond_batch()
    parts = {"build": time.perf_counter() - t0}
    tp = time.perf_counter()
    trainer.sample_panoptic(batch)  # warm-up
    res, x0 = _cond_call(trainer, batch, "phase 55 bf16 CFG 7.5",
                         _expect(K1=16 * steps * 2))
    parts["warm-up and the call"] = time.perf_counter() - tp
    tp = time.perf_counter()
    res["eager"] = graph_vs_eager(
        "phase 55 bf16 CFG 7.5", lambda g: trainer.sample_panoptic(
            batch, graph=g), x0, res["counts"], smi_line, profile=False)
    parts["eager"] = time.perf_counter() - tp
    tp = time.perf_counter()
    want = {k: res["counts"][k] for k in TRACE_NAMES}
    for _ in range(2):  # a trace can drop events, never add them
        prof = host_profile(lambda: trainer.sample_panoptic(batch))
        if prof["trace_launches"] == want:
            break
    check(prof["trace_launches"] == want,
          f"phase 55: the traced guided call ran {prof['trace_launches']} "
          f"kernels by name, its counters say {want}")
    busy_untraced = (prof["device_ms"] / (1e3 * res["seconds"])
                     if isinstance(prof.get("device_ms"), float) else None)
    parts["trace"] = time.perf_counter() - tp
    tp = time.perf_counter()
    one, x0_one = _cond_call(trainer, batch, "phase 55 bf16 guidance 1.0",
                             _expect(K1=16 * steps), guidance_scale=1.0)
    other = dict(batch, context=_cond_batch(COND_SEED + 1)["context"])
    _, x0_other = _cond_call(trainer, other, "phase 55 another context",
                             _expect(K1=16 * steps * 2))
    diff_one = (x0_one - x0).abs().max().item()
    diff_ctx = (x0_other - x0).abs().max().item()
    check(diff_one > 1e-3 and diff_ctx > 1e-3,
          f"phase 55: guidance 1.0 or another context left x0 unchanged "
          f"(max diffs {diff_one}, {diff_ctx})")
    parts["guidance 1.0, another context"] = time.perf_counter() - tp
    tp = time.perf_counter()
    _attach_random_pose(trainer)
    clip = _static_clip(CLIP_HW)
    clip["context"] = batch["context"][:1]  # one clip: repeated per frame
    k = _refine_steps(steps)
    torch.cuda.synchronize()
    _zero_counts()
    tc = time.perf_counter()
    logits, x0_clip = trainer.sample_panoptic_clip(clip)
    torch.cuda.synchronize()
    clip_s = time.perf_counter() - tc
    clip_counts = _counts()
    check(clip_counts == _expect(K1=16 * (steps + k) * 2)
          and bool(torch.isfinite(x0_clip).all())
          and tuple(x0_clip.shape) == (CLIP_T, 32, 64, 4),
          f"phase 55 clip with CFG: launched {clip_counts}, expected K1 "
          f"{16 * (steps + k) * 2}")
    parts["clip"] = time.perf_counter() - tp
    seconds = time.perf_counter() - t0
    print(f"phase 55 conditioning ('none' descriptor, context "
          f"{list(COND_CONTEXT)}, bf16, DDIM {steps}, batch 2 x 256x512): "
          f"guidance 7.5 {res['seconds']:.3f} s a call, K1 "
          f"{res['counts']['K1']}, peak memory "
          f"{res['peak_bytes'] / 2**30:.2f} GiB, graph bit-equal to eager "
          f"(eager {res['eager']['eager_seconds']:.3f} s); the call "
          f"traced: wall {_ms(prof.get('wall_ms'))} ms, kernels "
          f"{_ms(prof.get('device_ms'))} ms, busy "
          f"{_ms(prof.get('busy_share'))} (kernels over the untraced "
          f"wall {_ms(busy_untraced)}), K1 by name "
          f"{prof['trace_launches']['K1']}; "
          f"guidance 1.0 {one['seconds']:.3f} s a call, K1 "
          f"{one['counts']['K1']}, x0 max diff {diff_one:.4f}; another "
          f"context: x0 max diff {diff_ctx:.4f}; a 3-frame clip with CFG "
          f"(DDIM {steps} + a {k}-step tail): {clip_s:.3f} s a call, K1 "
          f"{clip_counts['K1']}; {seconds:.1f} s ("
          + ", ".join(f"{k_} {v:.1f}" for k_, v in parts.items())
          + f") [{smi_line}]", flush=True)
    del trainer
    torch.cuda.empty_cache()
    res.update({"guidance_1": one, "clip_seconds": clip_s,
                "traced_call": prof, "parts_seconds": parts,
                "busy_untraced": busy_untraced,
                "clip_counts": clip_counts, "x0": x0, "seconds": seconds,
                "x0_diff_guidance_1": diff_one,
                "x0_diff_other_context": diff_ctx})
    return res


def phase_cond_int8(smi_line: str, bf16_result: dict, seed: int = 0):
    """Phase 56: phase 55's call in int8 with fused norms (the same
    weights and noise; the int8 UNet's blocks K3 -> ``attn2`` in bf16 ->
    K4): 640 K3 and 640 K4 a call at guidance 7.5, no fallback, no K1;
    x0 correlated >= 0.9 with phase 55's; ``calibrate_int8`` refuses the
    descriptor (JAX's calibration runs without a context and fails)."""
    import torch
    from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
    t0 = time.perf_counter()
    trainer = TrainerDiffusion(_cond_config(sampling_kwargs={
        "int8_inference": True}))
    trainer.init_params(seed=seed)
    steps = trainer.num_inference_steps
    batch = _cond_batch()
    trainer.sample_panoptic(batch)  # warm-up
    res, x0 = _cond_call(trainer, batch, "phase 56 int8 CFG 7.5",
                         _expect(K3=16 * steps * 2, K4=16 * steps * 2))
    corr = _corr(x0, bf16_result["x0"])
    check(corr >= 0.9, f"phase 56: int8 x0 correlates {corr} with bf16's")
    try:
        trainer.calibrate_int8(batch)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    check(refused is not None and "without a context" in refused,
          f"phase 56: calibrate_int8 with a context descriptor: {refused}")
    seconds = time.perf_counter() - t0
    print(f"phase 56 conditioning in int8 (fused norms, guidance 7.5): "
          f"{res['seconds']:.3f} s a call, peak memory "
          f"{res['peak_bytes'] / 2**30:.2f} GiB, K3 {res['counts']['K3']},"
          f" K4 {res['counts']['K4']}, no fallback; x0 correlation with "
          f"bf16 {corr:.4f} (>= 0.9); calibrate_int8 refused the 'none' "
          f"descriptor; {seconds:.1f} s [{smi_line}]", flush=True)
    del trainer
    torch.cuda.empty_cache()
    return res | {"x0_corr_bf16": corr, "seconds": seconds}


COND_TIMED = 3


def phase_cond_train(smi_line: str, seed: int = 0):
    """Phase 57: training with ``learnable`` queries (77 x 768),
    ``separate_encoder`` and ``add_adaptor`` at full width (phase 6's
    deployment: batch 8 of 192x640, bf16 on fp32 masters,
    self-conditioning: the 12 channels split 6/6): 22 attention sites (16
    and the image path's 6), so a step runs 44 K1 (the self-condition pass
    and the forward) and 22 K2; 1 warm-up and :data:`COND_TIMED` timed
    steps (s/step, peak memory); then one step's loss (1e-2) and gradient
    cosine (>= 0.99) on K1/K2 against the plain attention."""
    import torch
    from ldmseg_torch.data.loader import Loader
    from ldmseg_torch.data.synthetic import SyntheticDVPS
    from ldmseg_torch.models.unet import CrossAttention
    from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
    from ldmseg_torch.utils.config import merge_dicts
    t0 = time.perf_counter()
    cfg = merge_dicts(_train_config(), {
        "train_kwargs": {"image_descriptors": "learnable"},
        "model_kwargs": {"separate_encoder": True, "add_adaptor": True}})
    ds = SyntheticDVPS(length=2 * TRAIN_BATCH, size=TRAIN_HW, num_bits=8)
    trainer = TrainerDiffusion(cfg, dataset=ds)
    trainer.init_params(seed=seed)
    unet = trainer.unet
    sites = _attention_sites(unet)
    check(sites == 22 and tuple(unet.object_queries.weight.shape) ==
          (77, 768), f"phase 57: {sites} attention sites, queries "
          f"{tuple(unet.object_queries.weight.shape)}")
    trainer.train_loop(max_steps=1, log_every=1, seed=seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    tt = time.perf_counter()
    losses = trainer.train_loop(max_steps=COND_TIMED, log_every=COND_TIMED,
                                seed=seed + 1)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - tt) / COND_TIMED
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses),
          f"phase 57: losses {losses}")
    want = _expect(K1=2 * sites * COND_TIMED, K2=sites * COND_TIMED)
    check(counts == want, f"phase 57: launched {counts}, expected {want}")
    batch = next(iter(Loader(ds, TRAIN_BATCH, seed=seed + 2)))
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    lh, lw = TRAIN_HW[0] // 8, TRAIN_HW[1] // 8
    noise = torch.randn((TRAIN_BATCH, lh, lw, 4), generator=gen,
                        device="cuda")
    steps = torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen,
                          device="cuda")
    attn = [m for m in unet.modules() if isinstance(m, CrossAttention)]
    results = {}
    for fused in (True, False):
        for m in attn:
            m.use_fused = fused
        trainer.state.zero_grad()
        loss, _, _ = trainer.forward_backward(batch, noise=noise,
                                              timesteps=steps)
        results[fused] = (loss.item(), _flat_grads(unet))
    for m in attn:
        m.use_fused = True
    (loss_f, g_f), (loss_p, g_p) = results[True], results[False]
    check(unet.object_queries.weight.grad.abs().max().item() > 0,
          "phase 57: no gradient reached the object queries")
    trainer.state.zero_grad()
    cos = (torch.dot(g_f, g_p) / (g_f.norm() * g_p.norm())).item()
    loss_rel = abs(loss_f - loss_p) / abs(loss_p)
    del results, g_f, g_p
    check(loss_rel <= 1e-2 and cos >= 0.99,
          f"phase 57: loss rel {loss_rel} (tol 1e-2), gradient cosine {cos}"
          f" (>= 0.99) on K1/K2 against the plain attention")
    seconds = time.perf_counter() - t0
    print(f"phase 57 training with learnable queries (77 x 768), "
          f"separate_encoder and add_adaptor ({sites} attention sites), "
          f"batch {TRAIN_BATCH} x {TRAIN_HW[0]}x{TRAIN_HW[1]}, bf16: "
          f"{secs:.4f} s/step over {COND_TIMED} steps, peak memory "
          f"{peak / 2**30:.2f} GiB, K1 {counts['K1']}, K2 {counts['K2']}; "
          f"one step vs plain attention: loss {loss_f:.6f} vs {loss_p:.6f} "
          f"(rel {loss_rel:.2e}), gradient cosine {cos:.6f}; "
          f"{seconds:.1f} s [{smi_line}]", flush=True)
    del trainer, unet
    torch.cuda.empty_cache()
    return {"seconds_per_step": secs, "peak_bytes": peak, "counts": counts,
            "losses": losses, "loss_rel": loss_rel, "grad_cosine": cos,
            "seconds": seconds}


def phase_cond_surgery(smi_line: str, seed: int = 0):
    """Phase 58: one bf16 forward each, at full width with cross-attention
    and a context, batch 2 at a 32x64 latent: ``separate_conv`` (12
    channels 6/6) and the upscaler head (128 classes, dim 256: logits at
    64x128), each on K1 (16 launches) within 2e-2 of the plain attention
    at the trunk's output (``conv_out``'s; the head's input, the head
    itself has no kernel: its output's error, which its two norms scale
    up on random weights, is printed); and ``Upscaler`` (the seg-VAE
    decoder alone, 128 logits, resized x4 to 256x512): finite, of the
    right shape."""
    import torch
    from ldmseg_torch.models.layers import init_random_
    from ldmseg_torch.models.unet import (CrossAttention, UNet2DCondition,
                                          UNetConfig)
    from ldmseg_torch.models.upscaler import Upscaler
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((2, 12, 32, 64), generator=gen, device="cuda").to(
        torch.bfloat16)
    ctx = torch.randn(COND_CONTEXT, generator=gen, device="cuda").to(
        torch.bfloat16)
    t = torch.tensor([999, 19], device="cuda")
    out = {}
    for name, kw, shape in (
            ("separate_conv", {"separate_conv": True}, (2, 4, 32, 64)),
            ("upscaler head", {"upscaler_classes": 128},
             (2, 128, 64, 128))):
        with torch.device("cuda"):
            unet = UNet2DCondition(UNetConfig(
                in_channels=12, use_cross_attention=True,
                use_fused_attention=True, **kw))
        init_random_(unet, gen)
        unet = unet.to(torch.bfloat16).eval()
        attn = [m for m in unet.modules() if isinstance(m, CrossAttention)]
        trunk = []
        if "upscaler" in name:
            unet.upscaler.register_forward_hook(
                lambda m, inputs, o: trunk.append(inputs[0].float()))
        with torch.inference_mode():
            _zero_counts()
            fused = unet(x, t, ctx).float()
            torch.cuda.synchronize()
            n = _counts()["K1"]
            for m in attn:
                m.use_fused = False
            plain = unet(x, t, ctx).float()

        def rel_err(a, b):
            return ((a - b).abs().max() / b.abs().max()).item()
        rel = rel_err(fused, plain)
        rel_trunk = rel_err(*trunk) if trunk else rel
        check(tuple(fused.shape) == shape
              and bool(torch.isfinite(fused).all()) and n == 16
              and rel_trunk <= 2e-2,
              f"phase 58 {name}: shape {tuple(fused.shape)} (want {shape}),"
              f" {n} K1 (want 16), rel err {rel_trunk} at the trunk's "
              f"output vs plain (tol 2e-2)")
        out[name] = {"k1": n, "max_rel_err": rel,
                     "max_rel_err_trunk": rel_trunk}
        del unet, attn, trunk
    with torch.device("cuda"):
        up = Upscaler()
    init_random_(up, gen)
    up = up.to(torch.bfloat16).eval()
    z = torch.randn((2, 4, 32, 64), generator=gen, device="cuda").to(
        torch.bfloat16)
    with torch.inference_mode():
        logits = up(z, interpolate=True)
    check(tuple(logits.shape) == (2, 128, 256, 512)
          and bool(torch.isfinite(logits).all()),
          f"phase 58 Upscaler: {tuple(logits.shape)} or not finite")
    del up
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    print(f"phase 58 surgery forwards (bf16, context {list(COND_CONTEXT)}):"
          + "; ".join(f" {k}: {v['k1']} K1, max rel err vs plain "
                      f"{v['max_rel_err_trunk']:.3e} at the trunk, "
                      f"{v['max_rel_err']:.3e} out" for k, v in out.items())
          + f"; Upscaler -> {tuple(logits.shape)} finite; {seconds:.1f} s "
          f"[{smi_line}]", flush=True)
    return out | {"seconds": seconds}


# ---------------------------------------------------------------------------
# data parallelism: one NCCL rank, two gloo ranks sharing the card, the
# multi-rank dry run (phases 59-61)
# ---------------------------------------------------------------------------
DP_ROWS = 4            # a rank's rows of phase 6's global batch of 8
DP_PQ_FRAMES = 4       # phase 60's compute_pq val set, 2 frames a rank
DP_PQ_STEPS = 4        # its DDIM steps
DP_TIMEOUT_S = 300     # each distributed run's deadline


def _dp_config():
    from ldmseg_torch.utils.config import merge_dicts
    # phase 6's training configuration with ZeRO-1
    return merge_dicts(_train_config(), {"optimizer_zero_redundancy": True})


# phases 59, 60 and 62 (the data and model axes' steps) run phase 6's UNet
# at SD-1.4's widths with one resnet a block (the default's depth is 2:
# 10 transformer blocks, not 16), so that the script keeps inside its
# limit with phase 63 beside them
SHALLOW_SITES = 10


def _shallow_unet():
    from ldmseg_torch.models.unet import UNetConfig
    return UNetConfig(in_channels=12, layers_per_block=1,
                      use_fused_attention=True)


def _dp_batch(rows):
    """``rows`` of phase 6's global batch (``SyntheticDVPS``, 8 bits,
    192x640), each rank rendering only its own."""
    from ldmseg_torch.data.collate import collate
    from ldmseg_torch.data.synthetic import SyntheticDVPS
    ds = SyntheticDVPS(length=TRAIN_BATCH, size=TRAIN_HW, num_bits=8)
    return collate([ds[i] for i in range(TRAIN_BATCH)[rows]])


def _dp_draws(seed: int, rows=slice(None)):
    """``rows`` of a global step's draws (NHWC noise, timesteps) from a CPU
    generator, the same in every process."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    noise = torch.randn((TRAIN_BATCH, TRAIN_HW[0] // 8, TRAIN_HW[1] // 8, 4),
                        generator=gen)
    steps = torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen)
    return noise[rows], steps[rows]


def phase59_child(out_path: str) -> None:
    """Phase 59's process, started with torchrun's variables for one rank:
    the stage-2 step with ZeRO-1 without a process group, then
    ``initialize_from_env`` (NCCL) and the same step on a trainer whose mesh
    spans the group; their losses, masters and launches to ``out_path``."""
    import torch
    import torch.distributed as dist
    from ldmseg_torch.parallel.multihost import initialize_from_env
    from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
    # no TF32: each trainer turns it off when it is built
    torch.backends.cudnn.deterministic = True
    batch = _dp_batch(slice(None))
    noise, steps = _dp_draws(5)

    def step():
        trainer = TrainerDiffusion(_dp_config(), unet_config=_shallow_unet())
        trainer.init_params(seed=0)
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, _ = trainer.train_step(batch, noise=noise, timesteps=steps)
        torch.cuda.synchronize()
        out = {"loss": loss.item(), "seconds": time.perf_counter() - t0,
               "counts": _counts(), "mesh": trainer.mesh.shape,
               "grouped": trainer.mesh.data_group is not None,
               "steps": trainer.state.step}
        masters = [p.detach().clone() for p in trainer.unet.parameters()]
        del trainer
        torch.cuda.empty_cache()
        return out, masters

    plain, before = step()
    info = initialize_from_env(device="cuda")
    backend = dist.get_backend()
    grouped, after = step()
    same = all(torch.equal(a, b) for a, b in zip(before, after))
    dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump({"plain": plain, "grouped": grouped, "info": info,
                   "backend": backend, "masters_equal": same,
                   "tensors": len(after)}, f)


def _start_phase59() -> dict:
    """Start phase 59's process (:func:`phase59_child`) with torchrun's
    variables for one rank (``RANK`` 0, ``WORLD_SIZE`` 1, a free local
    port); :func:`_finish_phase59` waits for it."""
    import os
    import socket
    import tempfile
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="localhost", MASTER_PORT=str(port))
    tmp = tempfile.TemporaryDirectory()
    out = os.path.join(tmp.name, "phase59.json")
    log = open(os.path.join(tmp.name, "phase59.log"), "w+")
    proc = subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke; chip_smoke.phase59_child({out!r})"],
        env=env, cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=log, stderr=subprocess.STDOUT)
    return {"proc": proc, "tmp": tmp, "out": out, "log": log,
            "t0": time.perf_counter()}


def _stop_phase59(run: dict) -> None:
    if run["proc"].poll() is None:
        run["proc"].kill()
        run["proc"].wait()
    run["log"].close()
    run["tmp"].cleanup()


def _finish_phase59(run: dict, smi_line: str) -> dict:
    """Phase 59: one rank over NCCL on the card. Its process runs phase 6's
    stage-2 step with ZeRO-1 without a group and again after
    ``initialize_from_env``: the loss and the masters bit-equal (K1 and K2
    repeat bit for bit; cuDNN deterministic), the launches equal."""
    proc = run["proc"]
    try:
        proc.wait(timeout=max(1.0, DP_TIMEOUT_S - (time.perf_counter()
                                                   - run["t0"])))
    except subprocess.TimeoutExpired:
        raise CheckFailed(f"phase 59's process outlived {DP_TIMEOUT_S} s")
    run["log"].seek(0)
    check(proc.returncode == 0, f"phase 59's process exited "
          f"{proc.returncode}: {run['log'].read()[-4000:]}")
    with open(run["out"]) as f:
        res = json.load(f)
    plain, grouped = res["plain"], res["grouped"]
    check(res["backend"] == "nccl" and res["info"]["process_count"] == 1
          and grouped["grouped"] and not plain["grouped"],
          f"phase 59: backend {res['backend']}, {res['info']}")
    check(grouped["steps"] == plain["steps"] == 1, "phase 59: no step taken")
    check(grouped["loss"] == plain["loss"], f"phase 59: loss "
          f"{grouped['loss']!r} in the group, {plain['loss']!r} without")
    check(res["masters_equal"], "phase 59: the masters after the step in "
          "the NCCL group differ from the step without a group")
    check(grouped["counts"] == plain["counts"]
          and grouped["counts"]["K1"] == 2 * SHALLOW_SITES
          and grouped["counts"]["K2"] == SHALLOW_SITES,
          f"phase 59: launches {grouped['counts']} in the group, "
          f"{plain['counts']} without")
    seconds = time.perf_counter() - run["t0"]
    print(f"phase 59 one NCCL rank (torchrun variables, world size 1): the "
          f"stage-2 step with ZeRO-1 at batch {TRAIN_BATCH} of "
          f"{TRAIN_HW[0]}x{TRAIN_HW[1]}: loss {grouped['loss']:.6f} and "
          f"{res['tensors']} masters bit-equal to the step without a group, "
          f"K1 {grouped['counts']['K1']} / K2 {grouped['counts']['K2']} "
          f"launches in both; step {grouped['seconds']:.3f} s in the group, "
          f"{plain['seconds']:.3f} s without (first steps; contended: "
          f"beside phase 60's one-rank steps); its process {seconds:.1f} s "
          f"(contended) [{smi_line}]", flush=True)
    return {"loss": grouped["loss"], "counts": grouped["counts"],
            "contended_step_seconds": grouped["seconds"],
            "contended_plain_step_seconds": plain["seconds"],
            "contended_seconds": seconds}


def _nccl_probe_rank(rank: int) -> None:
    import torch
    import torch.distributed as dist
    x = torch.ones(1, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()


def _flat_cos(tensors, ref) -> float:
    """The cosine of ``tensors`` (on the card, flattened in order) and the
    flat CPU ``ref``, in float64, a tensor at a time."""
    import torch
    dot = n1 = n2 = torch.zeros((), dtype=torch.float64, device="cuda")
    off = 0
    for t in tensors:
        a = t.reshape(-1).double()
        b = ref[off:off + a.numel()].to("cuda").double()
        off += a.numel()
        dot, n1, n2 = dot + a @ b, n1 + a @ a, n2 + b @ b
    assert off == ref.numel()
    return float(dot / (n1.sqrt() * n2.sqrt()))


def _dp_rank(rank: int, spec: dict) -> dict:
    """Phase 60 on one of two gloo ranks sharing the card: its 4 rows of
    the stage-2 step (ZeRO-1, self-conditioning) timed and held against
    the one-rank steps' gradients and update, ``compute_pq`` on its 2
    frames, and its 4 rows of the stage-1 step."""
    import os
    import numpy as np
    import torch
    import ldmseg_torch.train.state as state_mod
    from ldmseg_torch.data.collate import collate
    from ldmseg_torch.data.synthetic import SyntheticDVPS
    from ldmseg_torch.evals import PanopticEvaluator
    from ldmseg_torch.parallel.mesh import (broadcast_tensors, group_mean,
                                            make_mesh)
    from ldmseg_torch.train.trainer_ae import TrainerAE
    from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
    # no TF32: each trainer turns it off when it is built
    torch.backends.cudnn.deterministic = True
    mesh = make_mesh()
    rows = slice(rank * DP_ROWS, (rank + 1) * DP_ROWS)
    out, t = {"seconds": {}}, time.perf_counter()

    def lap_(name):
        nonlocal t
        torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - t
        t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    trainer = TrainerDiffusion(_dp_config(), unet_config=_shallow_unet(),
                               mesh=mesh)
    trainer.init_params(seed=0)
    params = list(trainer.unet.parameters())
    before = torch.cat([p.detach().reshape(-1) for p in params]).cpu()
    batch = _dp_batch(rows)
    noise, steps = _dp_draws(5, rows)
    lap_("build (replicate included)")
    # the one-rank references: the parent writes them while the ranks
    # start, and renames the file when it is whole
    while not os.path.exists(spec["ref"]):
        if time.perf_counter() - t > DP_TIMEOUT_S:
            raise TimeoutError(f"no {spec['ref']}")
        time.sleep(0.2)
    ref = torch.load(spec["ref"], weights_only=True)
    lap_("load the references")
    reduce_events = []
    reduce = state_mod.reduce_gradients

    def timed_reduce(ps, group):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        reduce(ps, group)
        b.record()
        reduce_events.append((a, b))
    state_mod.reduce_gradients = timed_reduce
    opt = trainer.state.optimizer
    opt_step = opt.step

    def read_then_step():
        t_cos = time.perf_counter()
        out["grad_cos"] = _flat_cos([p.grad for p in opt.params],
                                    ref["grads"])
        out["cos_seconds"] = time.perf_counter() - t_cos
        opt_step()
    opt.step = read_then_step
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _, _ = trainer.train_step(batch, noise=noise, timesteps=steps)
    torch.cuda.synchronize()
    # the step without the check read inside it
    out["step_seconds"] = time.perf_counter() - t0 - out["cos_seconds"]
    opt.step = opt_step
    state_mod.reduce_gradients = reduce
    out["reduce_ms"] = reduce_events[0][0].elapsed_time(reduce_events[0][1])
    out["loss"] = float(group_mean(loss, mesh))
    lap_("the step")
    offsets = np.cumsum([0] + [p.numel() for p in params])[:-1]
    out["update_split_cos"] = _flat_cos(
        (p.detach().reshape(-1) - before[o:o + p.numel()].to("cuda")
         for p, o in zip(params, offsets)), ref["update_split"])
    del before, ref
    copies = [p.detach().clone() for p in params]
    broadcast_tensors(copies, 0, mesh.data_group)  # rank 0's masters
    out["masters_equal"] = all(torch.equal(c, p)
                               for c, p in zip(copies, params))
    del copies
    out["state_bytes"] = opt.state_bytes()
    lap_("update and masters checked")
    # compute_pq on this rank's 2 of the 4 frames, the evaluator's images
    # kept for the parent's one-process evaluator
    images = []

    class Recording(PanopticEvaluator):
        def add_image(self, pred, gt, inst=None):
            images.append((np.array(pred), np.array(gt)))
            super().add_image(pred, gt, inst)
    trainer.ds_val = SyntheticDVPS(length=DP_PQ_FRAMES, size=TRAIN_HW,
                                   num_bits=8, seed=3)
    pq = trainer.compute_pq(num_inference_steps=DP_PQ_STEPS,
                            evaluator=Recording(
                                thing_ids=set(), class_agnostic=True,
                                ignore_label=trainer.ignore_label))
    out["pq"] = {k: pq[k] for k in ("pq", "sq", "rq", "tp", "fp", "fn",
                                    "iou_sum")}
    out["pq_images"] = images
    out["counts"] = _counts()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    del trainer, params, opt
    torch.cuda.empty_cache()
    lap_("compute_pq")
    # stage 1: this rank's rows of the one-rank step's batch and draws
    ae = TrainerAE(_ae_config(), mesh=mesh)
    ae.init_params(seed=0)
    k = ae.loss_cfg.max_masks
    d = spec["ae_draws"]
    draws = {"noise": d["noise"][rows].cuda(), "points": {
        "ce": tuple(u[rows].cuda() for u in d["points"]["ce"]),
        "mask": tuple(u[rank * DP_ROWS * k:(rank + 1) * DP_ROWS * k].cuda()
                      for u in d["points"]["mask"])}}
    ds = SyntheticDVPS(length=AE_BATCH, size=TRAIN_HW, num_bits=5)
    ae_loss, _ = ae.train_step(collate([ds[i] for i in
                                        range(AE_BATCH)[rows]]),
                               draws=draws)
    out["ae_loss"] = float(group_mean(ae_loss, mesh))
    lap_("stage-1 step")
    return out


def _one_rank_step(micro, accumulate: int = 1):
    """The one-rank stage-2 step of phase 60 from the ranks' first masters,
    in this process: ``micro`` the (rows, draws seed) of each micro-batch.
    Returns the loss of the last, the gradients the optimizer read and the
    update, both bf16 on the CPU, and the optimizer state's bytes."""
    import torch
    from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
    from ldmseg_torch.utils.config import merge_dicts
    trainer = TrainerDiffusion(merge_dicts(_dp_config(), {
        "train_kwargs": {"accumulate": accumulate}}),
        unet_config=_shallow_unet())
    trainer.init_params(seed=0)
    params = list(trainer.unet.parameters())
    before = [p.detach().clone() for p in params]
    opt, seen = trainer.state.optimizer, {}
    opt_step = opt.step

    def read_then_step():
        seen["grads"] = torch.cat([p.grad.reshape(-1).bfloat16()
                                   for p in opt.params]).cpu()
        opt_step()
    opt.step = read_then_step
    for rows in micro:
        noise, steps = _dp_draws(5, rows)
        loss, _, _ = trainer.train_step(_dp_batch(rows), noise=noise,
                                        timesteps=steps)
    check(trainer.state.step == 1, "phase 60: the one-rank step took no "
          "optimizer step")
    update = torch.cat([(p.detach() - b).reshape(-1).bfloat16()
                        for p, b in zip(params, before)]).cpu()
    out = (loss.item(), seen["grads"], update, opt.state_bytes())
    del trainer, params, before, opt
    torch.cuda.empty_cache()
    return out


def _dp_references() -> dict:
    """Phase 60's first part, in this process: NCCL's answer to two ranks
    on one device (probed in a thread meanwhile), the one-rank stage-2
    steps (the global batch, and the same rows in the ranks' two
    micro-batches; the cosine of their updates) and the one-rank stage-1
    step."""
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from ldmseg_torch.data.collate import collate
    from ldmseg_torch.data.synthetic import SyntheticDVPS
    from ldmseg_torch.parallel.launch import run_ranks
    from ldmseg_torch.train.trainer_ae import TrainerAE
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    try:
        with ThreadPoolExecutor(1) as pool:
            probe = pool.submit(run_ranks, _nccl_probe_rank, 2,
                                device="cuda", local_rank=0, timeout_s=120)
            one_loss, grads, update, one_bytes = _one_rank_step(
                [slice(None)])
            _, _, update_split, _ = _one_rank_step(
                [slice(0, DP_ROWS), slice(DP_ROWS, 2 * DP_ROWS)],
                accumulate=2)
            floor = _flat_cos([update_split.cuda().float()], update)
            ae = TrainerAE(_ae_config())
            ae.init_params(seed=0)
            ae_draws = _ae_draws(ae, AE_BATCH, TRAIN_HW,
                                 torch.Generator().manual_seed(9))
            ds = SyntheticDVPS(length=AE_BATCH, size=TRAIN_HW, num_bits=5)
            ae_one, _ = ae.train_step(
                collate([ds[i] for i in range(AE_BATCH)]),
                draws={"noise": ae_draws["noise"].cuda(), "points": {
                    n: tuple(u.cuda() for u in v)
                    for n, v in ae_draws["points"].items()}})
            ae_one = ae_one.item()
            del ae
            torch.cuda.empty_cache()
            try:
                probe.result()
                nccl = "NCCL took two ranks on one device"
            except RuntimeError as e:
                lines = [ln.strip() for ln in str(e).splitlines()
                         if ln.strip()]
                hit = [ln for ln in lines if "uplicate" in ln]
                nccl = "NCCL refused: " + (hit[0] if hit
                                           else lines[-1])[:300]
    finally:
        torch.backends.cudnn.deterministic = False
    return {"nccl": nccl, "one_loss": one_loss, "grads": grads,
            "update_split": update_split,
            "one_bytes": one_bytes, "floor": floor, "ae_one": ae_one,
            "ae_draws": ae_draws, "seconds": time.perf_counter() - t0}


def phase_dp_two_ranks(smi_line: str, refs: dict) -> dict:
    """Phase 60: two ranks sharing the one H100. NCCL refuses two ranks on
    one device (its error printed), so the ranks use gloo over CUDA
    tensors, whose collectives here are all-reduce and broadcast. The
    one-rank steps (:func:`_dp_references`) hand their results over in a
    temporary file; then 2 ranks of 4 rows each: the stage-2 step with
    ZeRO-1 and self-conditioning (loss within 1e-3 and the reduced
    gradients' cosine >= 0.999 against the one-rank step on the global
    batch, the update's cosine >= 0.999 against the one-rank step on the
    same rows in the ranks' two micro-batches, which the ranks' split
    computes; the ranks' masters bit-equal; each rank's optimizer state
    45-55% of one rank's; its seconds and the reduction's device ms),
    ``compute_pq`` on 4 frames (2 a rank) against a one-process evaluator
    fed the same images, and the stage-1 step (loss within 1e-3). AdamW's
    first step moves each element by about lr times the sign of its
    gradient, so elements whose gradient is within bf16's difference
    between a batch of 8 and two of 4 flip: the one-rank micro-batch
    step's update against the global-batch step's is printed. Two ranks on
    one card measure no scaling."""
    import os
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from ldmseg_torch.evals import PanopticEvaluator
    from ldmseg_torch.parallel.launch import run_ranks
    t0 = time.perf_counter()
    print(f"phase 60 NCCL with two ranks on one device: {refs['nccl']}",
          flush=True)
    one_loss, one_bytes = refs["one_loss"], refs["one_bytes"]
    ae_one, floor, ref_s = refs["ae_one"], refs["floor"], refs["seconds"]
    with tempfile.TemporaryDirectory() as tmp, \
            ThreadPoolExecutor(1) as pool:
        path = os.path.join(tmp, "one_rank.pt")
        spawned = pool.submit(
            run_ranks, _dp_rank, 2, args=({"ref": path,
                                           "ae_draws": refs["ae_draws"]},),
            device="cuda", backend="gloo", local_rank=0,
            timeout_s=DP_TIMEOUT_S)
        # written while the ranks start; they wait for the name
        torch.save({k: refs.pop(k) for k in ("grads", "update_split")},
                   path + ".part")
        os.replace(path + ".part", path)
        ranks = spawned.result()
    ranks_s = time.perf_counter() - t0
    r0, r1 = ranks
    one = PanopticEvaluator(thing_ids=set(), class_agnostic=True,
                            ignore_label=0)
    for r in ranks:
        for pred, gt in r["pq_images"]:
            one.add_image(pred, gt)
    want = one.evaluate(synchronize=False)
    rel = abs(r0["loss"] - one_loss) / abs(one_loss)
    ae_rel = abs(r0["ae_loss"] - ae_one) / abs(ae_one)
    shares = [r["state_bytes"] / one_bytes for r in ranks]
    grad_cos = min(r["grad_cos"] for r in ranks)
    split_cos = min(r["update_split_cos"] for r in ranks)
    reduce_ms = r0["reduce_ms"]
    print(f"phase 60 two gloo ranks sharing the card, global batch "
          f"{TRAIN_BATCH} of {TRAIN_HW[0]}x{TRAIN_HW[1]} ({DP_ROWS} a rank), "
          f"ZeRO-1, self-conditioning: loss {r0['loss']:.6f} vs one rank "
          f"{one_loss:.6f} (rel {rel:.2e}, tol 1e-3); reduced gradients' "
          f"cosine {grad_cos:.6f} (>= 0.999); update cosine {split_cos:.6f} "
          f"with the one-rank step in the ranks' two micro-batches (>= "
          f"0.999; that step's own with the global-batch step, AdamW's "
          f"first step on bf16 gradients: {floor:.6f}); masters bit-equal "
          f"across "
          f"ranks: {r0['masters_equal'] and r1['masters_equal']}; "
          f"optimizer state a rank {[round(s, 4) for s in shares]} of one "
          f"rank's ({one_bytes / 2**30:.2f} GiB); stage-1 loss "
          f"{r0['ae_loss']:.6f} vs {ae_one:.6f} (rel {ae_rel:.2e}); "
          f"compute_pq on {DP_PQ_FRAMES} frames ({DP_PQ_STEPS} DDIM steps, "
          f"2 a rank) summed: PQ {r0['pq']['pq']:.3f}, tp {r0['pq']['tp']}, "
          f"fp {r0['pq']['fp']}, fn {r0['pq']['fn']} (one process: PQ "
          f"{want['pq']:.3f}, tp {want['tp']}, fp {want['fp']}, fn "
          f"{want['fn']})", flush=True)
    print(f"phase 60 timings (two ranks on ONE card: not a scaling figure): "
          f"the stage-2 step {r0['step_seconds']:.3f} / "
          f"{r1['step_seconds']:.3f} s/step (the first on its trainer); "
          f"gradient reduction (gloo, the fp32 gradients) {reduce_ms:.1f} ms "
          f"of device time (CUDA events); peak memory a rank "
          f"{[round(r['peak_bytes'] / 2**30, 2) for r in ranks]} GiB; K1 "
          f"{r0['counts']['K1']} / K2 {r0['counts']['K2']} launches a rank "
          f"(the step + compute_pq); one-rank references and the NCCL "
          f"probe {ref_s:.1f} s (contended: beside phase 59's process), "
          f"the ranks alone "
          f"{ranks_s:.1f} s (rank 0: "
          f"{ {k: round(v, 1) for k, v in r0['seconds'].items()} }) "
          f"[{smi_line}]", flush=True)
    check(r0["loss"] == r1["loss"] and rel <= 1e-3,
          f"phase 60: two-rank loss {r0['loss']} vs one rank {one_loss}")
    check(grad_cos >= 0.999, f"phase 60: reduced gradients' cosine "
          f"{[r['grad_cos'] for r in ranks]}")
    check(split_cos >= 0.999, f"phase 60: update cosine "
          f"{[r['update_split_cos'] for r in ranks]}")
    check(r0["masters_equal"] and r1["masters_equal"],
          "phase 60: the two ranks' masters differ")
    check(all(0.45 <= s <= 0.55 for s in shares),
          f"phase 60: optimizer state shares {shares}")
    check(ae_rel <= 1e-3, f"phase 60: stage-1 loss {r0['ae_loss']} on two "
          f"ranks vs {ae_one}")
    for r in ranks:
        got = r["pq"]
        check(len(r["pq_images"]) == DP_PQ_FRAMES // 2
              and (got["tp"], got["fp"], got["fn"]) == (want["tp"],
                                                        want["fp"],
                                                        want["fn"])
              and all(abs(got[k] - want[k]) <= 1e-12 * max(1.0, abs(want[k]))
                      for k in ("pq", "sq", "rq", "iou_sum")),
              f"phase 60: summed PQ {got} vs one process "
              f"{ {k: want[k] for k in got} }")
        check(r["counts"] == r0["counts"] and r["counts"]["K1"] > 0
              and r["counts"]["K2"] == SHALLOW_SITES,
              f"phase 60: launches {[x['counts'] for x in ranks]}")
    return {"nccl_two_ranks": refs["nccl"], "loss": r0["loss"],
            "one_rank_loss": one_loss, "loss_rel": rel,
            "grad_cosine": grad_cos, "update_cosine_split": split_cos,
            "one_rank_split_vs_global_update_cosine": floor,
            "state_shares": shares, "ae_loss_rel": ae_rel,
            "pq": want["pq"], "step_seconds": [r["step_seconds"]
                                               for r in ranks],
            "reduce_device_ms": reduce_ms,
            "peak_bytes": [r["peak_bytes"] for r in ranks],
            "counts": r0["counts"], "rank0_seconds": r0["seconds"],
            "contended_references_seconds": ref_s, "ranks_seconds": ranks_s}


DRY_RANKS = 4  # phase 61's ranks: stages B and C need a (2, 2) mesh


def phase_dp_dryrun(smi_line: str) -> dict:
    """Phase 61: ``entry.dryrun_multichip(4, "cuda")``, stages A-D on four
    ranks sharing the card (gloo), nothing else on it: each stage's
    seconds; B's TP forward and gradient errors against the replicated
    UNet (JAX's bound, 1e-2) and a rank's share of the UNet's parameters;
    C's ZeRO-1 state a rank (about a quarter of the ranks' sum); K1 and K2
    launched on each rank, no other kernel."""
    from ldmseg_torch.entry import dryrun_multichip
    t0 = time.perf_counter()
    ranks = dryrun_multichip(DRY_RANKS, "cuda", timeout_s=DP_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    for r in ranks:
        n = r["launches"]
        check(n["K1"] > 0 and n["K2"] > 0 and n["other"] == 0,
              f"phase 61: launches {[x['launches'] for x in ranks]}")
    a, b, c, d = (ranks[0][k] for k in "ABCD")
    total = sum(r["C"]["state_bytes"] for r in ranks)
    shares = [r["C"]["state_bytes"] / total for r in ranks]
    check(max(b["fwd_err"], b["grad_err"]) < 1e-2
          and 0.5 < b["param_share"] < 0.55,
          f"phase 61 stage B: {b}")
    check(all(0.2 < x < 0.3 for x in shares) and c["sp_stages"] > 0,
          f"phase 61 stage C: state shares {shares}, {c}")
    print(f"phase 61 dryrun_multichip({DRY_RANKS}, cuda): stage A "
          f"{a['seconds']:.1f} s, B {b['seconds']:.1f} s (TP fwd err "
          f"{b['fwd_err']:.2e}, grad err {b['grad_err']:.2e}, tol 1e-2; a "
          f"rank's UNet {b['param_share']:.4f} of the parameters), C "
          f"{c['seconds']:.1f} s (TP + ZeRO-1 + SP step, loss "
          f"{c['loss']:.4f}, {c['sp_stages']} spatial stages, ZeRO-1 state "
          f"a rank {[round(x, 4) for x in shares]} of the ranks' sum), D "
          f"{d['seconds']:.1f} s (rank 0); K1 "
          f"{ranks[0]['launches']['K1']} / K2 {ranks[0]['launches']['K2']} "
          f"launches a rank, {seconds:.1f} s in all (alone on the card) "
          f"[{smi_line}]",
          flush=True)
    return {"A_seconds": a["seconds"], "B_seconds": b["seconds"],
            "C_seconds": c["seconds"], "D_seconds": d["seconds"],
            "B": b, "C_loss": c["loss"], "C_state_shares": shares,
            "launches": ranks[0]["launches"], "seconds": seconds}


def phase_dp(smi_line: str):
    """Phases 59-61. Phase 61 runs first with nothing else on the card, so
    its stage seconds are its own; then phase 59's process runs while
    phase 60's one-rank steps run here (both checks of values: their
    seconds are contended and printed so); phase 60's two ranks, whose
    step and reduction are timed, then run alone. Returns the three
    phases' results and their seconds together."""
    t0 = time.perf_counter()
    dry = phase_dp_dryrun(smi_line)
    run = _start_phase59()
    try:
        refs = _dp_references()
        one = _finish_phase59(run, smi_line)
    finally:
        _stop_phase59(run)
    two = phase_dp_two_ranks(smi_line, refs)
    seconds = time.perf_counter() - t0
    print(f"phases 59-61 data parallelism: {seconds:.1f} s in all (phase 61 "
          f"{dry['seconds']:.1f} s alone; phase 59's process "
          f"{one['contended_seconds']:.1f} s beside phase 60's one-rank "
          f"steps {two['contended_references_seconds']:.1f} s; phase 60's "
          f"ranks {two['ranks_seconds']:.1f} s alone) [{smi_line}]",
          flush=True)
    return one, two, dry, seconds


# ---------------------------------------------------------------------------
# the model axis: tensor and spatial parallelism on two gloo ranks sharing
# the card (phase 62)
# ---------------------------------------------------------------------------
MA_BATCH = 2           # phase 62's batch of 192x640 frames
MA_STEPS = 4           # its sample's DDIM steps
MA_TIMEOUT_S = 600     # the ranks' deadline (phases 62 and 63)


def _ma_config(parallel: bool):
    """Phase 6's training configuration at batch 2 with ZeRO-1, the image
    VAE's attention on K1's wide class; ``parallel``: with
    ``tensor_parallel`` and ``spatial_parallel``."""
    from ldmseg_torch.utils.config import merge_dicts
    cfg = merge_dicts(_train_config(), {
        "train_kwargs": {"batch_size": MA_BATCH},
        "image_vae_kwargs": {"use_fused_attention": True},
        "optimizer_zero_redundancy": True})
    if parallel:
        cfg = merge_dicts(cfg, {"tensor_parallel": True,
                                "spatial_parallel": True})
    return cfg


def _ma_inputs():
    """Phase 62's batch (phase 6's first 2 frames), the step's noise and
    timesteps, and the sample's initial noise, NHWC, from a CPU
    generator."""
    import torch
    gen = torch.Generator().manual_seed(62)
    lat = (MA_BATCH, TRAIN_HW[0] // 8, TRAIN_HW[1] // 8, 4)
    return (_dp_batch(slice(0, MA_BATCH)), torch.randn(lat, generator=gen),
            torch.randint(0, 1000, (MA_BATCH,), generator=gen),
            torch.randn(lat, generator=gen))


def _ma_step(trainer, keep_before: bool = False):
    """One train step and the 4-step bf16 sample on phase 62's inputs:
    the gradients the optimizer read (before the clip) and the update (and
    with ``keep_before`` the masters before the step), by parameter name,
    the loss, x0, each part's seconds and the launches."""
    import torch
    batch, noise, steps, init = _ma_inputs()
    opt, seen = trainer.state.optimizer, {}
    named = list(trainer.unet.named_parameters())
    before = {n: p.detach().clone() for n, p in named}
    opt_step = opt.step

    def read_then_step():
        seen.update({n: p.grad.detach().clone() for n, p in named})
        opt_step()
    opt.step = read_then_step
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _, _ = trainer.train_step(batch, noise=noise, timesteps=steps)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    opt.step = opt_step
    update = {n: p.detach() - before[n] for n, p in named}
    if not keep_before:
        before = None
    _, x0 = trainer.sample_panoptic({"image": batch["image"]},
                                    init_noise=init,
                                    num_inference_steps=MA_STEPS, graph=False)
    torch.cuda.synchronize()
    return {"loss": float(loss), "grads": seen, "update": update,
            "before": before, "x0": x0.float().cpu(), "step_seconds": t1 - t0,
            "sample_seconds": time.perf_counter() - t1, "counts": _counts()}


def _ma_reference(path: str) -> dict:
    """Phase 62's one-rank step and sample in this process; the gradients
    and the update (bf16, flat in parameter order) go to ``path`` for the
    ranks."""
    import torch
    from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
    t0 = time.perf_counter()
    trainer = TrainerDiffusion(_ma_config(False), unet_config=_shallow_unet())
    trainer.init_params(seed=0)
    out = _ma_step(trainer)
    named = list(trainer.unet.named_parameters())
    torch.save({"names": [n for n, _ in named],
                "shapes": [tuple(p.shape) for _, p in named],
                "grads": torch.cat([out["grads"][n].reshape(-1).bfloat16()
                                    for n, _ in named]).cpu(),
                "update": torch.cat([out["update"][n].reshape(-1).bfloat16()
                                     for n, _ in named]).cpu()},
               path + ".part")
    import os
    os.replace(path + ".part", path)
    unet_bytes = sum(p.numel() * p.element_size() for _, p in named)
    del trainer, named, out["grads"], out["update"]
    torch.cuda.empty_cache()
    return out | {"unet_bytes": unet_bytes,
                  "seconds": time.perf_counter() - t0}


def _ma_rank(rank: int, spec: dict) -> dict:
    """Phase 62 on one of two gloo ranks sharing the card, a ``(1, 2)``
    mesh: the trainer with ``tensor_parallel`` and ``spatial_parallel``,
    the step and the sample of :func:`_ma_step`; the cosines of the
    gathered gradients and update with the one-rank ones (each rank's
    shards against their slices, a replicated tensor counted on model rank
    0, the sums all-reduced over the model group). AdamW's first step
    moves each element by about lr times the sign of its gradient, so an
    element whose gradient is within the two steps' bf16 rounding of zero
    may move either way: the update's cosine is read, not held. What is
    held: the one-rank optimizer fed the gathered TP gradients, from the
    gathered masters before the step, ends at the gathered TP masters
    (the sharded clip, AdamW and ZeRO-1 against the unsharded ones, apart
    from the rounding), on model rank 0."""
    import torch
    import torch.distributed as dist
    from ldmseg_torch.parallel import sp, tp
    from ldmseg_torch.parallel.mesh import make_mesh
    from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh(1, 2)
    trainer = TrainerDiffusion(_ma_config(True), unet_config=_shallow_unet(),
                               mesh=mesh)
    trainer.init_params(seed=0)
    build_s = time.perf_counter() - t0
    replicated = sp.run_stage.replicated
    out = _ma_step(trainer, keep_before=True)
    lay, ax = tp.layout(trainer.unet), sp.model_axis(mesh)
    ref = torch.load(spec["ref"], mmap=True, weights_only=True)
    offsets, off = {}, 0
    for n, s in zip(ref["names"], ref["shapes"]):
        offsets[n] = (off, s)
        off += math.prod(s)
    # dot, |a|^2, |b|^2 of the gradients, of the update
    sums = torch.zeros(6, dtype=torch.float64, device="cuda")

    def add(i, a, b):
        a, b = a.reshape(-1).double(), b.reshape(-1).double()
        sums[i:i + 3] += torch.stack([a @ b, a @ a, b @ b])
    for n, g in out["grads"].items():
        if n not in lay and mesh.model_rank != 0:
            continue
        o, s = offsets[n]
        rg, ru = (ref[k][o:o + math.prod(s)].view(s).to("cuda")
                  for k in ("grads", "update"))
        if n in lay:
            rg, ru = (tp.local_tensor(r, lay[n][0], ax, lay[n][1])
                      for r in (rg, ru))
        u = out["update"][n]
        add(0, g, rg)
        add(3, u, ru)
    dist.all_reduce(sums, group=mesh.model_group)
    sums = sums.tolist()
    del ref, out["update"]
    peak = torch.cuda.max_memory_allocated()  # before the reference below
    t_opt = time.perf_counter()
    named = list(trainer.unet.named_parameters())
    keep = mesh.model_rank == 0
    whole = [tp.full_tensors(mesh, [(n, t[n]) for n, _ in named], lay, keep)
             for t in (out.pop("before"), out.pop("grads"), dict(named))]
    opt, opt_err = trainer.state.optimizer, None
    if keep:
        params = [torch.nn.Parameter(b.cuda()) for b in whole[0]]
        for q, g in zip(params, whole[1]):
            q.grad = g.cuda()
        trainer.make_optimizer([(n, q) for (n, _), q in zip(named, params)]
                               ).step()
        # within 1e-3 x lr, plus one rounding of the fp32 master (lr is
        # 5e-7 on the warm-up's first step: below an ulp of a master near 1)
        lr, eps = float(opt.schedule(0)), torch.finfo(torch.float32).eps
        err, over, unequal, total = 0.0, 0, 0, 0
        for q, a in zip(params, whole[2]):
            d = (q.detach() - a.cuda()).abs()
            err = max(err, float(d.max()))
            over += int((d > 1e-3 * lr + eps * q.detach().abs()).sum())
            unequal += int((d > 0).sum())
            total += d.numel()
        opt_err = {"lr": lr, "max_lr": err / lr, "over": over,
                   "unequal": unequal / total}
        del params
    del whole
    torch.cuda.empty_cache()
    unet_bytes = sum(p.numel() * p.element_size()
                     for p in trainer.unet.parameters())
    return out | {
        "grad_cos": sums[0] / math.sqrt(sums[1] * sums[2]),
        "update_cos": sums[3] / math.sqrt(sums[4] * sums[5]),
        "optimizer_err": opt_err,
        "optimizer_seconds": time.perf_counter() - t_opt,
        "unet_bytes": unet_bytes, "sharded": len(lay),
        "replicated_stages": sp.run_stage.replicated - replicated,
        "sp_stages": sp.run_stage.sharded,
        "peak_bytes": peak,
        "build_seconds": build_s, "seconds": time.perf_counter() - t0}


def phase_model_axis(smi_line: str) -> tuple:
    """Phase 62: the model axis at full width. The one-rank step and
    sample run here first (phase 6's configuration at batch 2 with ZeRO-1
    and the image VAE on K1's wide class), then two gloo ranks sharing the
    card on a ``(data=1, model=2)`` mesh with ``tensor_parallel`` and
    ``spatial_parallel`` run the same step and sample: loss within 1e-3,
    the gathered gradients' cosine >= 0.9999 against the one-rank step,
    the one-rank optimizer fed the gathered TP gradients within 1e-3 x lr
    (plus an ulp of the fp32 master) of the gathered TP masters
    (:func:`_ma_rank`; the update's cosine against the one-rank step is
    printed), x0 within 2e-2 of max|x0|;
    each rank holds 50-55% of the UNet's bytes, and launched K1, K2 and
    K1's wide class. Two ranks on one card through gloo measure no
    scaling: every collective crosses the host.

    Phase 63 runs on the same ranks after it (:func:`_serve`, its one-rank
    references here first): the bench's int8 serving pipeline with tensor
    and spatial parallelism (:func:`serve_report`); then the emulated
    modules against :func:`module_emulation` (:func:`emulation_report`);
    then phase 64 (:func:`_axis_rank` and :func:`_option_runs`, their
    one-rank references here first, :func:`axis_report` and
    :func:`option_report`). Returns the three phases' results."""
    import os
    import tempfile
    import torch
    from ldmseg_torch.parallel.launch import run_ranks
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "one_rank.pt")
        one = _ma_reference(path)
        ref_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        serve_one = _serve()
        serve_one_s = time.perf_counter() - t0 - ref_s
        print(f"phase 63 one rank: {serve_one_s:.1f} s", flush=True)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        emulated = module_emulation()
        axis_path = os.path.join(tmp, "axis_")
        axis_one = _axis_reference(axis_path)
        options_one = _option_runs(None, nudge=True)
        axis_one_s = time.perf_counter() - t1
        print(f"phase 64 one rank: {axis_one_s:.1f} s", flush=True)
        torch.cuda.empty_cache()
        both = run_ranks(_ma_and_serve_rank, 2,
                         args=({"ref": path, "axis_ref": axis_path,
                                "axis_scales": {
                                    flag: res["int8"]["scales"]
                                    for flag, res in axis_one.items()},
                                "option_scales": options_one["scales"]},),
                         device="cuda", backend="gloo", local_rank=0,
                         timeout_s=MA_TIMEOUT_S)
    ranks_s = (time.perf_counter() - t0 - ref_s - serve_one_s
               - axis_one_s)
    ranks = [r["ma"] for r in both]
    r0 = ranks[0]
    rel = abs(r0["loss"] - one["loss"]) / abs(one["loss"])
    xerr = max(float((r["x0"] - one["x0"]).abs().max()) for r in ranks)
    xmax = float(one["x0"].abs().max())
    shares = [r["unet_bytes"] / one["unet_bytes"] for r in ranks]
    grad_cos = min(r["grad_cos"] for r in ranks)
    update_cos = min(r["update_cos"] for r in ranks)
    opt = r0["optimizer_err"]
    counts = [{k: r["counts"][k] for k in ("K1", "K2", "K1w")}
              for r in ranks]
    print(f"phase 62 model axis (data=1, model=2), two gloo ranks sharing "
          f"the card, tensor_parallel + spatial_parallel + ZeRO-1, batch "
          f"{MA_BATCH} of {TRAIN_HW[0]}x{TRAIN_HW[1]}, bf16 on fp32 masters, "
          f"clip_grad 3.0: loss {r0['loss']:.6f} vs one rank "
          f"{one['loss']:.6f} (rel {rel:.2e}, tol 1e-3); gathered "
          f"gradients' cosine {grad_cos:.6f} (>= 0.9999); the one-rank "
          f"optimizer fed the gathered TP gradients: max |masters - TP "
          f"masters| {opt['max_lr']:.3e} x lr ({opt['lr']:.3e}), "
          f"{opt['over']} elements "
          f"over 1e-3 x lr + an ulp of the master (none allowed), "
          f"{opt['unequal']:.3e} of them not bit-equal "
          f"({r0['optimizer_seconds']:.1f} s); "
          f"update cosine against the one-rank step {update_cos:.6f} (read, "
          f"not held: AdamW's first step is lr x the sign of each "
          f"gradient); {MA_STEPS}-step bf16 sample "
          f"(eager) x0 max err {xerr:.3e} of max|x0| {xmax:.3e} (tol 2e-2 "
          f"of it)", flush=True)
    for i, r in enumerate(ranks):
        print(f"phase 62 rank {i}: UNet bytes {shares[i]:.4f} of one rank's "
              f"({r['sharded']} sharded tensors), peak memory "
              f"{r['peak_bytes'] / 2**30:.2f} GiB, launches {counts[i]}, "
              f"spatial stages sharded {r['sp_stages']} / replicated "
              f"{r['replicated_stages']}, train step {r['step_seconds']:.3f} "
              f"s, sample {r['sample_seconds']:.3f} s, trainer built in "
              f"{r['build_seconds']:.1f} s, {r['seconds']:.1f} s in all "
              f"[{smi_line}]", flush=True)
    print(f"phase 62 one rank: step {one['step_seconds']:.3f} s, sample "
          f"{one['sample_seconds']:.3f} s (eager), launches "
          f"{ {k: one['counts'][k] for k in ('K1', 'K2', 'K1w')} }; the "
          f"reference {ref_s:.1f} s, the ranks {ranks_s:.1f} s (two ranks on "
          f"ONE card over gloo: not a scaling figure) [{smi_line}]",
          flush=True)
    check(rel <= 1e-3, f"phase 62: loss {r0['loss']} vs one rank "
          f"{one['loss']}")
    check(all(r["loss"] == r0["loss"] for r in ranks),
          f"phase 62: the ranks' losses {[r['loss'] for r in ranks]}")
    check(grad_cos >= 0.9999, f"phase 62: gradient cosine "
          f"{[r['grad_cos'] for r in ranks]}")
    check(opt["over"] == 0, f"phase 62: the one-rank optimizer on the "
          f"gathered TP gradients against the TP masters: {opt}")
    check(xerr <= 2e-2 * xmax, f"phase 62: x0 err {xerr} of {xmax}")
    check(all(0.50 <= s <= 0.55 for s in shares),
          f"phase 62: UNet byte shares {shares}")
    for c in counts:
        check(c["K1"] > 0 and c["K2"] > 0 and c["K1w"] > 0,
              f"phase 62: launches {counts}")
    check(all(r["replicated_stages"] == 0 for r in ranks),
          "phase 62: a spatial stage ran whole")
    return {"loss": r0["loss"], "one_rank_loss": one["loss"],
            "loss_rel": rel, "grad_cosine": grad_cos,
            "update_cosine": update_cos, "optimizer_err": opt,
            "x0_err": xerr, "x0_max": xmax,
            "unet_byte_shares": shares,
            "peak_bytes": [r["peak_bytes"] for r in ranks],
            "counts": counts, "one_rank_counts": one["counts"],
            "replicated_stages": [r["replicated_stages"] for r in ranks],
            "step_seconds": [r["step_seconds"] for r in ranks],
            "sample_seconds": [r["sample_seconds"] for r in ranks],
            "one_rank_step_seconds": one["step_seconds"],
            "one_rank_sample_seconds": one["sample_seconds"],
            "reference_seconds": ref_s, "ranks_seconds": ranks_s,
            "seconds": time.perf_counter() - t0}, serve_report(
                smi_line, serve_one, [r["serve"] for r in both],
                serve_one_s) | {"emulation": emulation_report(
                    emulated, [r["modules"] for r in both])}, {
                **axis_report(smi_line, axis_one, [r["axis"] for r in both]),
                "int8_options": option_report(
                    smi_line, options_one, [r["options"] for r in both]),
                "one_rank_seconds": axis_one_s,
                "rank_seconds": [r["axis_seconds"] for r in both]}


# ---------------------------------------------------------------------------
# serving on the model axis (phase 63): K3, K4, K12 and K13 on a rank's
# heads and GEGLU columns, and the bench's int8 pipeline on two gloo ranks
# ---------------------------------------------------------------------------
SERVE_STEPS = 4           # phase 63's DDIM steps a sample
SERVE_HW = (256, 512)     # the bench's frames
SERVE_CONTEXT = (2, 77, 768)
SERVE_GUIDANCE = 7.5
# the calibrated scales on the mesh against one rank's (``calibrate_int8``,
# and ``calibrate_act_scale_tree`` on the cut masters at one fixed input):
# the TP forward's fp32 activations differ from one rank's by the reordered
# sums of its row-parallel layers, which the amaxes carry
SERVE_SCALE_RTOL = 1e-5


def _rank_pack(pack, r: int, n: int = 2):
    """Rank ``r``'s slice of a whole K3, K4, K8, K9, K11 or K17 pack on a
    model axis of ``n``: K3 and K8 its heads (``w_qkv``'s and ``m_qkv``'s
    rows of each of q, k, v; ``wo``'s columns; the per-head scales), K4 and
    K9 its GEGLU columns (``w1``'s paired h and gate rows, ``w2``'s
    columns), K11 its heads (as K3's, with ``wo_q``'s columns and
    ``ratio``; ``out_scale`` the group's), K17 its heads (``w_qkv``'s rows
    of each of q, k, v; ``wo_q``'s and ``wo_p``'s columns; the per-head
    scales); the rest whole (K8's ``proj_in`` and K9's ``proj_out`` too).
    These are the codes ``apply_tp`` + ``prepare_int8_unet`` give a rank
    (held bit for bit in ``tests/test_torch_port_model_axis_serving.py``,
    ``tests/test_torch_port_model_axis_attention_int8.py`` and
    ``tests/test_torch_port_model_axis_int8_options.py``)."""
    import dataclasses
    from ldmseg_torch.parallel import tp
    from ldmseg_torch.parallel.sp import Axis
    ax = Axis(n, r)

    def cut(t, dim, pairs=1):
        return tp.local_tensor(t, dim, ax, pairs)
    if hasattr(pack, "ratio"):
        return dataclasses.replace(
            pack, heads=pack.heads // n, w_qkv=cut(pack.w_qkv, 0, 3),
            m_qkv=cut(pack.m_qkv, 0, 3), wo_q=cut(pack.wo_q, 1),
            ratio=cut(pack.ratio, 0), w_scale=cut(pack.w_scale, 1))
    if hasattr(pack, "wo_p"):
        return dataclasses.replace(
            pack, heads=pack.heads // n, w_qkv=cut(pack.w_qkv, 0, 3),
            wo_q=cut(pack.wo_q, 1), w_scale=cut(pack.w_scale, 1),
            wo_p=cut(pack.wo_p, 1))
    if hasattr(pack, "w_qkv"):
        return dataclasses.replace(
            pack, heads=pack.heads // n, w_qkv=cut(pack.w_qkv, 0, 3),
            m_qkv=cut(pack.m_qkv, 0, 3), wo=cut(pack.wo, 1),
            wo_q=cut(pack.wo_q, 1), w_scale=cut(pack.w_scale, 1))
    return dataclasses.replace(
        pack, w1=cut(pack.w1, 0, 2), s1=cut(pack.s1, 0, 2),
        b1=cut(pack.b1, 0, 2), w2=cut(pack.w2, 1))


class _AmaxGroup:
    """A model group of two ranks in one process, for the partial modes'
    kernel checks: ``max`` returns ``both`` (the two ranks' maximum, read
    in an earlier call), or, where ``both`` is None, records the amax it is
    given and returns it."""

    def __init__(self, both=None):
        self.both, self.amaxes = both, []

    def max(self, amax):
        if self.both is not None:
            return self.both
        self.amaxes.append(amax.clone())
        return amax

    def of_both(self) -> "_AmaxGroup":
        """The group whose ``max`` gives the maximum of the amaxes recorded
        here (one call on each rank's shard)."""
        import torch
        return _AmaxGroup(torch.maximum(*self.amaxes) if self.amaxes
                          else None)


def _two_rank_check(name, shape, mode, parts, plains, summed, one_rank,
                    phase: int = 63):
    """The partial-mode row: each rank's fp32 partial against its plain
    version's, the two summed (and finished) against the one-rank kernel;
    both within phase 7's tolerances."""
    def errs(out, ref):
        err = (out.float() - ref.float()).abs()
        return (err.max().item(), ref.float().abs().max().item(),
                err.mean().item(), ref.float().abs().mean().item())
    row = {"shape": list(shape), "mode": mode, "ranks": []}
    for r, (out, ref) in enumerate(zip(parts, plains)):
        emax, rmax, emean, rmean = errs(out, ref)
        check(emax <= INT8_MAX_TOL * rmax and emean <= INT8_MEAN_TOL * rmean,
              f"phase {phase} {name} {shape} {mode} rank {r}: partial err "
              f"{emax} (max|ref| {rmax}), mean {emean} ({rmean})")
        row["ranks"].append({"max_abs_err": emax, "max_abs_ref": rmax,
                             "mean_abs_err": emean, "mean_abs_ref": rmean})
    emax, rmax, emean, rmean = errs(summed, one_rank)
    check(emax <= INT8_MAX_TOL * rmax and emean <= INT8_MEAN_TOL * rmean,
          f"phase {phase} {name} {shape} {mode}: the two ranks' sum against "
          f"the one-rank kernel, err {emax} (max|ref| {rmax}), mean "
          f"{emean}")
    row.update(sum_max_abs_err=emax, sum_max_abs_ref=rmax,
               sum_mean_abs_err=emean, sum_mean_abs_ref=rmean,
               max_abs_err=max([emax] + [x["max_abs_err"]
                                         for x in row["ranks"]]))
    return row


def phase_partial_kernels():
    """Phase 63's kernel checks: K3, K4, K12 and K13 in their partial modes
    on the card at the local shapes of a model axis of 2 (4 of 8 heads;
    half of the 4C GEGLU columns), each rank's fp32 partial held against
    its plain version's, and the two ranks' partials summed (K3, K4: plus
    the residual and bias; K4 and K12's dynamic scale: the two ranks' amax
    slots' maximum between the halves) against the one-rank kernel."""
    import torch
    from ldmseg_torch.ops import attention_s8 as A
    from ldmseg_torch.ops import geglu as G

    gen = torch.Generator(device="cuda").manual_seed(63)
    rows = {"K3": [], "K4": [], "K12": [], "K13": []}
    for shape, _ in INT8_SHAPES:
        b, t, c = shape
        norm1, attn, norm3, ff = _block_modules(c, t + c + 63)
        x = torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        with torch.inference_mode():
            whole = A.pack_ln_attention(norm1, attn, 8, 0.1)
            packs = [_rank_pack(whole, r) for r in range(2)]
            parts = [A._launch(x, q, partial=True) for q in packs]
            plains = [A.ln_attention_s8_reference(x, q, partial=True)
                      for q in packs]
            summed = A.ln_attention_s8_finish(x, parts[0] + parts[1], whole,
                                              fallback=False)
            row = _two_rank_check("K3", shape, "4 of 8 heads", parts,
                                  plains, summed,
                                  _launched(A.ln_attention_s8, x, whole))
            row["ms"] = time_ms(lambda: A._launch(x, packs[0],
                                                  partial=True))
            rows["K3"].append(row)
            for kid, block in (("K4", True), ("K12", False)):
                for mode, gs in (("dynamic", None), ("static", 0.02)):
                    fw = G.pack_geglu(norm3, ff.net[0].proj, ff.net[2],
                                      0.05, gs)
                    fq = [_rank_pack(fw, r) for r in range(2)]
                    ref = (G.geglu_ln_s8_reference if block
                           else G.geglu_s8_reference)
                    # the kernel's and the plain version's amax slots take
                    # the two ranks' maximum, each rank's read in a first
                    # call
                    runs = {"kernel": lambda q, grp: G._launch(
                                x, q, block, group=grp),
                            "plain": lambda q, grp: ref(
                                x, q, partial=True, group=grp)}
                    out, both = {}, {}
                    for key, run in runs.items():
                        seen = _AmaxGroup()
                        for q in fq:
                            run(q, seen)
                        both[key] = seen.of_both()
                        out[key] = [run(q, both[key]) for q in fq]
                    parts, plains = out["kernel"], out["plain"]
                    summed = G.geglu_finish(x, parts[0] + parts[1], fw,
                                            block, fallback=False)
                    wrapper = G.geglu_ln_s8 if block else G.fused_geglu_s8
                    row = _two_rank_check(kid, shape, mode, parts, plains,
                                          summed, _launched(wrapper, x, fw))
                    row["ms"] = time_ms(lambda: G._launch(
                        x, fq[0], block, group=both["kernel"]))
                    rows[kid].append(row)
        del norm1, attn, norm3, ff
    for shape, _ in K13_SHAPES:
        b, t, h, d = shape
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        scale = d ** -0.5
        with torch.inference_mode():
            for mode, act in (("static 0.1", 0.1), ("dynamic", None)):
                local = [tuple(z[:, :, r * h // 2:(r + 1) * h // 2]
                               for z in (q, k, v)) for r in range(2)]
                amax = _AmaxGroup(torch.maximum(*[torch.stack(
                    [z.abs().amax() for z in qkv]) for qkv in local]))
                parts = [A.fused_self_attention_s8(*qkv, scale, act, amax)
                         for qkv in local]
                plains = [A.fused_self_attention_s8_reference(
                    *qkv, scale, act, amax) for qkv in local]
                row = _two_rank_check(
                    "K13", shape, mode, parts, plains,
                    torch.cat(parts, dim=2),
                    _launched(A.fused_self_attention_s8, q, k, v, scale,
                              act))
                row["ms"] = time_ms(lambda: A.fused_self_attention_s8(
                    *local[0], scale, act, amax))
                rows["K13"].append(row)
    for kid, rs in rows.items():
        print(f"phase 63 {kid} partial mode (a rank of 2): "
              + "; ".join(f"{r['shape']} {r['mode']}: rank err "
                          f"{max(x['max_abs_err'] for x in r['ranks']):.3e},"
                          f" sum vs one rank {r['sum_max_abs_err']:.3e} of "
                          f"{r['sum_max_abs_ref']:.3e}, {r['ms']:.4f} ms"
                          for r in rs), flush=True)
    return rows


def _serve_config(parallel: bool, **over):
    """Phase 63's configurations: the JAX bench's serving pipeline
    (``tools/bench.py:bench_config(int8=True)``: the int8 UNet, the int8
    image VAE on K1's wide class) with the int8 seg decoder; ``over``
    merged in; ``parallel``: with ``tensor_parallel`` and
    ``spatial_parallel``."""
    from ldmseg_torch.tools.bench import bench_config
    from ldmseg_torch.utils.config import merge_dicts
    cfg = merge_dicts(bench_config(int8=True), {
        "vae_model_kwargs": {"use_int8": True},
        "train_kwargs": {"batch_size": 2}})
    cfg = merge_dicts(cfg, over)
    if parallel:
        cfg = merge_dicts(cfg, {"tensor_parallel": True,
                                "spatial_parallel": True})
    return cfg


# phase 63's samples: (label, config overrides, guided, int8 on)
SERVE_RUNS = (
    ("int8 fused norms", {}, False),
    ("int8 fused_norms False", {"sampling_kwargs": {"fused_norms": False}},
     False),
    ("guided int8", {"train_kwargs": {"image_descriptors": "none"}}, True),
)


def _serve_inputs():
    """Phase 63's frames, calibration noise, initial noise and context,
    from a CPU generator."""
    import torch
    gen = torch.Generator().manual_seed(630)
    lat = (2, SERVE_HW[0] // 8, SERVE_HW[1] // 8, 4)
    return (torch.randn((2,) + SERVE_HW + (3,), generator=gen),
            torch.randn(lat, generator=gen), torch.randn(lat, generator=gen),
            torch.randn(SERVE_CONTEXT, generator=gen))


def _int8_unet_bytes(unet) -> int:
    """An int8 UNet's bytes: its parameters and buffers, and the K3 and K4
    packs' tensors."""
    import torch
    total = sum(t.numel() * t.element_size()
                for t in list(unet.parameters()) + list(unet.buffers()))
    for m in unet.modules():
        pack = getattr(m, "pack", None)
        if pack is not None:
            total += sum(v.numel() * v.element_size()
                         for v in vars(pack).values()
                         if isinstance(v, torch.Tensor))
    return total


def _serve(mesh=None) -> dict:
    """Phase 63's calls on one rank (``mesh`` None) or on this rank of the
    mesh: for each of ``SERVE_RUNS`` a trainer from seed 0, the first
    calibrated (``calibrate_int8``), one UNet forward on a fixed input
    (:func:`_serve_forward`) and a ``SERVE_STEPS``-step sample (eager) with
    each run's launches; the guided trainer in int8 and then in bf16
    (``int8_inference`` off on the same masters). One rank also samples
    from the initial noise moved by ``SERVE_NUDGE`` (:func:`_serve_nudge`):
    how far the sample itself moves for less than a bf16 ulp."""
    import torch
    from ldmseg_torch.parallel import sp
    from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
    # the calibration forwards run on the fp32 masters without TF32: each
    # trainer turns it off when it is built (utils/precision.py), in a
    # spawned rank too
    image, calib, init, context = _serve_inputs()
    out = {}
    for label, over, guided in SERVE_RUNS:
        t0 = time.perf_counter()
        trainer = TrainerDiffusion(_serve_config(mesh is not None, **over),
                                   mesh=mesh)
        trainer.init_params(seed=0)
        build_s = time.perf_counter() - t0
        if label == "int8 fused norms":
            from ldmseg_torch.ops.quant import calibrate_act_scale_tree
            _zero_counts()
            out["scales"] = trainer.calibrate_int8({"image": image},
                                                   noise=calib)
            out["calibrate_counts"] = _counts()
            gen = torch.Generator().manual_seed(631)
            x = torch.randn((2, trainer.unet_config.in_channels)
                            + tuple(n // 8 for n in SERVE_HW), generator=gen)
            with torch.no_grad():
                out["direct_scales"] = calibrate_act_scale_tree(
                    trainer._eval_unet,
                    x.to(torch.bfloat16).float().cuda(),
                    torch.full((2,), 500, device="cuda"))
        batch = {"image": image, "context": context} if guided else \
            {"image": image}
        modes = ("int8", "bf16") if guided else ("int8",)
        for mode in modes:
            trainer.int8_inference = mode == "int8"
            replicated = sp.run_stage.replicated
            _zero_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, x0 = trainer.sample_panoptic(
                batch, init_noise=init, num_inference_steps=SERVE_STEPS,
                guidance_scale=SERVE_GUIDANCE if guided else None,
                graph=False)
            torch.cuda.synchronize()
            key = label if mode == "int8" else "guided bf16"
            out[key] = {"x0": x0.float().cpu(), "counts": _counts(),
                        "seconds": time.perf_counter() - t1,
                        "build_seconds": build_s,
                        "replicated": sp.run_stage.replicated - replicated,
                        "forward": _serve_forward(
                            trainer, context if guided else None)}
            if mesh is None:
                _, nudged = trainer.sample_panoptic(
                    batch, init_noise=_serve_nudge(init),
                    num_inference_steps=SERVE_STEPS,
                    guidance_scale=SERVE_GUIDANCE if guided else None,
                    graph=False)
                out[key]["nudged_x0"] = nudged.float().cpu()
                out[key]["nudged_forward"] = _serve_forward(
                    trainer, context if guided else None, nudged=True)
        if label == "int8 fused norms":
            out["int8_unet_bytes"] = _int8_unet_bytes(trainer._unet_int8)
        if label == "int8 fused_norms False" and mesh is not None:
            out["controls"] = _serve_controls(trainer)
        del trainer
        torch.cuda.empty_cache()
    return out


# the input's relative nudge of phase 63's sensitivity runs: below a bf16
# ulp (2^-8), as the UNet reads its input in bf16. A rank's forward and x0
# are held within the larger of 2e-2 of max|ref| (2e-3 on the mean) and
# SERVE_FLOOR_FACTOR times one rank's own move for the nudge, max and mean
# (one draw of that move estimates it; the mesh's reordered sums act at
# every layer, the nudge at the input)
SERVE_NUDGE = 2.0 ** -9
SERVE_FLOOR_FACTOR = 2.0


def _serve_nudge(init):
    """``init`` times ``1 +- SERVE_NUDGE`` (a seeded sign an element)."""
    import torch
    gen = torch.Generator().manual_seed(632)
    sign = torch.randint(0, 2, init.shape, generator=gen) * 2 - 1
    return init * (1 + SERVE_NUDGE * sign)


def _serve_forward(trainer, context, nudged: bool = False):
    """One UNet forward of the trainer's sampling UNet (int8 or bf16):
    :func:`_unet_forward`."""
    unet = (trainer.int8_unet() if trainer.int8_inference
            else trainer.inference_unet())
    return _unet_forward(unet, context, nudged)


def _unet_forward(unet, context=None, nudged: bool = False):
    """One forward of ``unet`` on a fixed input (bf16, [2, C, 32, 64], t =
    999 and 499, the context when guided; ``nudged``: the input moved by
    ``SERVE_NUDGE``): the output on the CPU in fp32."""
    import torch
    gen = torch.Generator().manual_seed(633)
    x = torch.randn((2, unet.config.in_channels)
                    + tuple(n // 8 for n in SERVE_HW), generator=gen)
    if nudged:
        x = _serve_nudge(x)
    ctx = None if context is None else context.cuda().to(torch.bfloat16)
    with torch.inference_mode():
        y = unet(x.cuda().to(torch.bfloat16),
                 torch.tensor([999, 499], device="cuda"), ctx)
    return y.float().cpu()


# phase 63's planted faults (:func:`_serve_controls`): the model group's
# reduction each one replaces with this rank's own value
SERVE_FAULTS = ("rank-local amax", "dropped partials")


def _serve_controls(trainer) -> dict:
    """Phase 63's controls on this rank of the mesh, on the unfused int8
    UNet (K12's interior on its dynamic scale, one amax per (image, token
    block) over all 4C columns): one UNet forward (:func:`_serve_forward`)
    as it runs, and one with each of ``SERVE_FAULTS`` planted in its model
    group: ``max`` returning the rank's own amax, ``sum`` the rank's own
    partial (the other rank's dropped). Each returns the forward's output
    and the amaxes that the group's ``max`` returned, in order."""
    from ldmseg_torch.parallel.tp import ModelGroup
    group = next(m.__dict__["tp_group"] for m in trainer._unet_int8.modules()
                 if isinstance(m.__dict__.get("tp_group"), ModelGroup))
    out = {}
    for fault in ("none",) + SERVE_FAULTS:
        seen = []

        def amax(a, fault=fault):
            y = a if fault == "rank-local amax" else ModelGroup.max(group, a)
            seen.append(y.detach().cpu())
            return y
        group.max = amax
        if fault == "dropped partials":
            group.sum = lambda x: x.float()
        try:
            y = _serve_forward(trainer, None)
        finally:
            vars(group).pop("max")
            vars(group).pop("sum", None)
        out[fault] = {"forward": y, "amaxes": seen}
    return out


def _ma_and_serve_rank(rank: int, spec: dict) -> dict:
    """Phase 62 (:func:`_ma_rank`), then phase 63's serving calls
    (:func:`_serve`), the emulated modules (:func:`_module_outputs`) and
    phase 64's calls (:func:`_axis_rank`, :func:`_option_runs` on one
    rank's scales) on the same rank and ``(1, 2)`` mesh."""
    from ldmseg_torch.parallel.mesh import make_mesh
    ma = _ma_rank(rank, spec)
    mesh = make_mesh(1, 2)
    t0 = time.perf_counter()
    serve = _serve(mesh)
    serve["seconds"] = time.perf_counter() - t0
    print(f"phase 63 rank {rank}: serving {serve['seconds']:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    modules = _module_outputs(mesh)
    axis = _axis_rank(mesh, spec)
    t1 = time.perf_counter()
    options = _option_runs(mesh, scales=spec["option_scales"])
    options["seconds"] = time.perf_counter() - t1
    axis_s = time.perf_counter() - t0
    print(f"phase 64 rank {rank}: {axis_s:.1f} s (the int8 options "
          f"{options['seconds']:.1f})", flush=True)
    return {"ma": ma, "serve": serve, "modules": modules, "axis": axis,
            "options": options, "axis_seconds": axis_s}


def serve_report(smi_line: str, one: dict, ranks: list,
                 one_seconds: float) -> dict:
    """Phase 63's checks and lines: each rank's UNet forward and x0 against
    one rank's, within the larger of 2e-2 of max|ref| (2e-3 on the mean)
    and ``SERVE_FLOOR_FACTOR`` times one rank's own move when its input
    moves by ``SERVE_NUDGE`` (below a bf16 ulp; int8 codes flip near .5 and
    a dynamic per-tensor amax moves every code),
    its calibrated scales against one rank's, the launches (K3 and K4 64
    a sample, 128 with CFG; K13 and K12 64; K1's wide class once an
    encode; no fallback), 50-55% of the int8 UNet's bytes, no spatial
    stage run whole."""
    steps = SERVE_STEPS
    want = {"int8 fused norms": {"K3": 16 * steps, "K4": 16 * steps,
                                  "K1w": 1},
            "int8 fused_norms False": {"K13": 16 * steps, "K12": 16 * steps,
                                        "K1w": 1},
            "guided int8": {"K3": 32 * steps, "K4": 32 * steps, "K1w": 1},
            "guided bf16": {"K1": 32 * steps, "K1w": 1}}
    result = {"one_rank_seconds": one_seconds, "runs": {},
              "rank_seconds": [r["seconds"] for r in ranks]}
    for i, r in enumerate(ranks):
        for key, expect in want.items():
            got, ref = r[key], one[key]
            fe = _errs(got, ref, "forward", "nudged_forward")
            xe = _errs(got, ref, "x0", "nudged_x0")
            result["runs"].setdefault(key, []).append(
                {"forward_err": fe, "x0_err": xe,
                 "counts": got["counts"], "seconds": got["seconds"]})
            print(f"phase 63 rank {i} {key}: a UNet forward's err max "
                  f"{fe[0]:.3e} mean {fe[1]:.3e} of max|out| {fe[4]:.3e} "
                  f"(one rank's own move for a {SERVE_NUDGE} nudge of its "
                  f"input: max {fe[2]:.3e} mean {fe[3]:.3e}); "
                  f"{steps}-step sample (eager, batch 2 of "
                  f"{SERVE_HW[0]}x{SERVE_HW[1]}) x0 err max {xe[0]:.3e} "
                  f"mean {xe[1]:.3e} of max|x0| {xe[4]:.3e} (its own move "
                  f"for the nudge of its initial noise: max {xe[2]:.3e} "
                  f"mean {xe[3]:.3e}); each within the larger of 2e-2 of "
                  f"max|ref| (2e-3 on the mean) and {SERVE_FLOOR_FACTOR:g} "
                  f"times that move; "
                  f"launches {({k: v for k, v in got['counts'].items() if v})}"
                  f"; {got['seconds']:.3f} s a sample on the rank (two gloo "
                  f"ranks on ONE card: not a speed), one rank "
                  f"{ref['seconds']:.3f} s [{smi_line}]", flush=True)
            for name, e in (("forward", fe), ("x0", xe)):
                emax, emean, nmax, nmean, rmax = e
                check(_serve_within(e),
                      f"phase 63 rank {i} {key}: {name} err max {emax} "
                      f"mean {emean} of max|ref| {rmax}; one rank's own "
                      f"move for a {SERVE_NUDGE} nudge max {nmax} mean "
                      f"{nmean}")
            check(got["counts"] == _expect(**expect),
                  f"phase 63 rank {i} {key}: launched {got['counts']}, "
                  f"expected {_expect(**expect)}")
            check(got["replicated"] == 0, f"phase 63 rank {i} {key}: a "
                  "spatial stage ran whole")
        result.setdefault("controls", []).append(
            _control_report(i, r["controls"], ranks[1 - i]["controls"],
                            one["int8 fused_norms False"], smi_line))
        worst = {}
        for key in ("direct_scales", "scales"):
            check(r[key].keys() == one[key].keys(),
                  f"phase 63 rank {i}: calibrated sites differ")
            worst[key] = max(abs(v - one[key][k]) / abs(one[key][k])
                             for k, v in r[key].items())
        share = r["int8_unet_bytes"] / one["int8_unet_bytes"]
        print(f"phase 63 rank {i}: calibrate_act_scale_tree on the cut "
              f"masters within {worst['direct_scales']:.2e} of one rank's "
              f"and calibrate_int8 within {worst['scales']:.2e} (rtol "
              f"{SERVE_SCALE_RTOL}), {len(r['scales'])} sites; int8 "
              f"UNet bytes {share:.4f} of one rank's; {r['seconds']:.1f} s "
              f"in all", flush=True)
        for key, err in worst.items():
            check(err <= SERVE_SCALE_RTOL, f"phase 63 rank {i}: {key} "
                  f"{err} from one rank's (rtol {SERVE_SCALE_RTOL})")
        check(0.50 <= share <= 0.55, f"phase 63 rank {i}: int8 UNet byte "
              f"share {share}")
        result.setdefault("scale_rel_err", []).append(worst)
        result.setdefault("int8_unet_byte_shares", []).append(share)
    return result


def _serve_within(e) -> bool:
    """Phases 63-64's bound on an error tuple of :func:`_errs` (max,
    mean, the nudge's max and mean, max|ref|): within the
    larger of 2e-2 of max|ref| (2e-3 on the mean) and
    ``SERVE_FLOOR_FACTOR`` times one rank's own move for the nudge."""
    emax, emean, nmax, nmean, rmax = e
    return (emax <= max(2e-2 * rmax, SERVE_FLOOR_FACTOR * nmax)
            and emean <= max(2e-3 * rmax, SERVE_FLOOR_FACTOR * nmean))


def _control_report(i: int, ctl: dict, other: dict, ref: dict,
                    smi_line: str) -> dict:
    """Phase 63's controls on rank ``i`` (:func:`_serve_controls`; ``other``
    the other rank's): the forward as it runs is within the phase's bound
    of one rank's and reads 16 amaxes from its group (K12's, one a block),
    the same on both ranks; with the rank-local amax planted, the ranks'
    amaxes differ; with the other rank's partials dropped, the forward
    fails the bound. The rank-local amax's forward error is
    printed beside the bound, not checked: a finer scale on a rank's
    columns is a quantization of the same size, which no bound on the
    output can tell from the reordered sums."""
    import torch
    row = {}
    for fault in ("none",) + SERVE_FAULTS:
        c = ctl[fault]
        d = (c["forward"] - ref["forward"]).abs()
        n = (ref["nudged_forward"] - ref["forward"]).abs()
        e = (float(d.max()), float(d.mean()), float(n.max()),
             float(n.mean()), float(ref["forward"].abs().max()))
        differ = sum(not torch.equal(a, b) for a, b in
                     zip(c["amaxes"], other[fault]["amaxes"]))
        row[fault] = {"forward_err": e, "within_bound": _serve_within(e),
                      "amaxes": len(c["amaxes"]), "amaxes_differ": differ}
        print(f"phase 63 rank {i} control, {fault} planted: forward err "
              f"max {e[0]:.3e} mean {e[1]:.3e} of max|out| {e[4]:.3e} "
              f"(within the bound: {_serve_within(e)}); {differ} of "
              f"{len(c['amaxes'])} amaxes differ between the ranks "
              f"[{smi_line}]", flush=True)
    true = row["none"]
    check(true["within_bound"] and true["amaxes"] == 16
          and true["amaxes_differ"] == 0,
          f"phase 63 rank {i} control: the forward as it runs, "
          f"{true['forward_err']} (within the bound: "
          f"{true['within_bound']}), {true['amaxes']} amaxes from the "
          f"group, {true['amaxes_differ']} differing between the ranks "
          f"(16 and 0 expected)")
    check(row["rank-local amax"]["amaxes_differ"] > 0,
          f"phase 63 rank {i} control: a rank-local amax left the ranks' "
          f"amaxes equal")
    check(not row["dropped partials"]["within_bound"],
          f"phase 63 rank {i} control: dropping the other rank's partials "
          f"stayed within the bound")
    return row


# ---------------------------------------------------------------------------
# packed and absorbed attention on the model axis (phase 64): K14-K17 on a
# rank's heads, and the one-process emulation of every partial mode
# ---------------------------------------------------------------------------
AXIS_FLAGS = {"packed": ("use_packed_attention", "K14", "K15"),
              "absorbed": ("use_absorbed_attention", "K16", "K17")}
# the shape of the modules whose mesh outputs the emulation holds bit for
# bit (phase 63's K3, K4, K12 and K13, phase 64's K15, K16 and K17): the
# second level of a 32x64 latent, 8 heads of 80
EMULATED_SHAPE = (2, 512, 640)


def axis_entry(rows: dict, axis: dict, kid: str) -> dict:
    """The kernels-line fields of ``kid``'s mode on a model axis of 2
    (phase 64): its rows, the times of one rank's launches summed over one
    UNet forward (16 sites), the largest error against the plain version,
    the ranks' outputs together against the one-rank kernel in bf16 ulps,
    and its launches on rank 0's phase 64 paths."""
    main = rows[kid]

    def total(key):
        return sum(r[key] * r["per_unet_forward"] for r in main)
    flag = next((f for f, ids in AXIS_FLAGS.items() if kid in ids), None)
    if flag is None:   # the int8 options (option_report)
        rank0 = axis["int8_options"]["ranks"][0]
        counts = {k: rank0[k]["counts"] for k in ("int8", "k11")}
    else:
        counts = axis[flag]["ranks"][0]["counts"]
    return {"model_axis": {
        "mode": {"K14": "a rank's [B, T, C/2] column shard, 4 of 8 heads",
                 "K15": "a rank's heads, the group's amax between its two "
                        "stages (ldmseg_attention_packed_s8, stages 1-2)",
                 "K16": "fp32 to_out partial of a rank's heads "
                        "(ldmseg_attention_absorbed, partial 1)",
                 "K17": "fp32 to_out partial of a rank's heads "
                        "(ldmseg_attention_absorbed_s8, partial 1)",
                 "K6": "whole on the replicated activation, its codes into "
                       "a rank's column s8 conv (ColumnQuantConv2d)",
                 "K8": "the proj_in prologue over all C, then the fp32 "
                       "to_out partial of a rank's heads "
                       "(ldmseg_attention_ln_s8_pin, partial 1)",
                 "K9": "K4's two launches on a rank's GEGLU columns, the "
                       "group's sum rounded into r, then proj_out alone "
                       "(ldmseg_geglu_ln_s8_pout, proj_out_only 1); ulps "
                       "are r's against the one-rank K4's, out_ulps the "
                       "output's",
                 "K11": "int32 to_out partial of a rank's heads on the "
                        "group's max(wos), summed exactly "
                        "(ldmseg_attention_padded_s8, partial 1)"}[kid],
        "max_abs_err": max(r["max_abs_err"] for r in main),
        "ulps_vs_one_rank": max(r["ulps"] for r in main),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "one_rank_ms": total("one_rank_ms"), "bound_ms": total("bound_ms"),
        "launches": {k: v[kid] for k, v in counts.items()},
        "unit": ("one launch at each of the resnet norms' four shape "
                 "classes (batch 2, 32x64 latent)" if kid == "K6" else
                 "one rank's launches in one UNet forward (16, batch 2, "
                 "32x64 latent)"), "shapes": main}}


def _bf16_ulps(a, b) -> int:
    """The largest distance of ``a`` from ``b`` in bf16 ulps (both rounded
    to bf16; their bit patterns mapped to an order-preserving integer)."""
    import torch

    def order(x):
        i = x.to(torch.bfloat16).contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((order(a) - order(b)).abs().max())


def _flagged_unet(cfg, flag=None, **flags):
    """The UNet the trainer builds from ``cfg`` (its input channels, K1)
    with ``flag``'s attention (``use_packed_attention`` or
    ``use_absorbed_attention``) and the ``UNetConfig`` fields ``flags``."""
    from ldmseg_torch.models.unet import UNetConfig
    mk, tk = cfg["model_kwargs"], cfg["train_kwargs"]
    cond = mk.get("cond_channels", 0) or (4 if tk.get("self_condition")
                                          else 0)
    if flag is not None:
        flags[AXIS_FLAGS[flag][0]] = True
    return UNetConfig(in_channels=mk.get("in_channels", 8) + cond,
                      use_fused_attention=tk.get("fused_attention", True),
                      **flags)


def _within_ulp(summed, one_rank, summed_parts: bool = False) -> bool:
    """``summed`` within one bf16 ulp of ``one_rank`` elementwise; where the
    ranks' fp32 partials were added (``summed_parts``), within 2^-16 of
    max|one_rank| where that is more: the two products sum ``to_out``'s
    terms in another order (the one-rank kernel's k-tiles cross the ranks'
    boundary), and where the terms cancel to near zero that reordering is
    more than a bf16 ulp of the result (about sqrt(C) fp32 ulps of the
    terms, 1e-6 of max|out| at C = 320)."""
    import torch
    ref = one_rank.float()
    _, e = torch.frexp(ref)
    bound = torch.ldexp(torch.ones_like(ref), e - 8)
    if summed_parts:
        bound = bound.clamp_min(2.0 ** -16 * float(ref.abs().max()))
    return bool(((summed.float() - ref).abs() <= bound).all())


def _ulp_row(name, shape, parts, plains, summed, one_rank, tol,
             summed_parts: bool = False, mode: str = "4 of 8 heads"):
    """Phase 64's row: each rank's output against its plain version's,
    within ``tol`` x max|plain| (``"int8"``: phase 7's max and mean
    bounds), and the ranks' outputs put together (gathered, or with
    ``summed_parts`` the fp32 partials summed and rounded once) within one
    bf16 ulp of the one-rank kernel's (:func:`_within_ulp`); the largest
    distance in bf16 ulps is recorded."""
    if tol == "int8":
        row = _two_rank_check(name, shape, mode, parts, plains, summed,
                              one_rank, phase=64)
    else:
        row = {"shape": list(shape), "mode": mode, "ranks": []}
        for r, (out, ref) in enumerate(zip(parts, plains)):
            err = (out.float() - ref.float()).abs().max().item()
            rmax = ref.float().abs().max().item()
            check(math.isfinite(err) and err <= tol * rmax,
                  f"phase 64 {name} {shape} rank {r}: err {err} > {tol} x "
                  f"max|plain| {rmax}")
            row["ranks"].append({"max_abs_err": err, "max_abs_ref": rmax})
        row["max_abs_err"] = max(x["max_abs_err"] for x in row["ranks"])
    row["ulps"] = _bf16_ulps(summed, one_rank)
    row["max_abs_diff_vs_one_rank"] = float(
        (summed.float() - one_rank.float()).abs().max())
    check(_within_ulp(summed, one_rank, summed_parts),
          f"phase 64 {name} {shape}: the ranks' outputs together are "
          f"{row['ulps']} bf16 ulps (max |diff| "
          f"{row['max_abs_diff_vs_one_rank']}) from the one-rank kernel's, "
          f"beyond one bf16 ulp (or 2^-16 of max|out| near zero)")
    return row


def phase_axis_kernels(seed: int = 64) -> dict:
    """Phase 64's kernel checks at the sampling shapes of a rank of 2 (4
    of 8 heads): K14 on a column shard of q, k and v (strided views of the
    whole tensors), K15 with the two ranks' amax bits' maximum between its
    stages, K16's and K17's fp32 partials on a rank's weights and pack,
    each against its plain version (K15's and K17's at phase 7's bounds,
    their scales the same); then the two ranks' outputs put together
    against the one-rank kernel, within one bf16 ulp; and K8, K9, K11 and
    K6 (:func:`_option_kernel_rows`). Each row has the rank's call's time,
    the one-rank kernel's, its plain version's and its bound."""
    import torch
    from ldmseg_torch.ops import attention as A
    from ldmseg_torch.ops import attention_s8 as S8

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = {kid: [] for kid in ("K14", "K15", "K16", "K17")}

    def rand(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    def timed(row, fn, plain, bound, one_rank):
        row["ms"] = time_ms(fn)
        row["plain_ms"] = time_ms(plain, iters=5, warmup=1)
        row["one_rank_ms"] = time_ms(one_rank)
        row["bound_ms"], row["bound_by"] = bound[:2]
        return row

    with torch.inference_mode():
        for shape, per in K14_SHAPES:
            b, t, c = shape
            half, scale = c // 2, (c // 8) ** -0.5
            q, k, v = (rand(shape) for _ in range(3))
            # K14 on the column shards as views of the whole tensors
            local = [tuple(z[:, :, r * half:(r + 1) * half] for z in (q, k, v))
                     for r in range(2)]
            outs = [_launched(A.fused_self_attention_packed, *z, 4, scale)
                    for z in local]
            plains = [A.packed_attention_reference(*z, 4, scale)
                      for z in local]
            one = _launched(A.fused_self_attention_packed, q, k, v, 8, scale)
            row = _ulp_row("K14", shape, outs, plains, torch.cat(outs, 2),
                           one, BF16_ATOL)
            rows["K14"].append(timed(
                row, lambda: A.fused_self_attention_packed(*local[0], 4,
                                                           scale),
                lambda: A.packed_attention_reference(*local[0], 4, scale),
                attention_bound_ms((b, t, 4, c // 8), "bfloat16"),
                lambda: A.fused_self_attention_packed(q, k, v, 8, scale)))
            # K15 on a rank's [B, T, C/2] with the group's amax
            local = [tuple(z.contiguous() for z in zs) for zs in local]
            both = {}
            for key, fn in (("kernel", S8.fused_self_attention_packed_s8),
                            ("plain",
                             S8.fused_self_attention_packed_s8_reference)):
                seen = _AmaxGroup()
                for z in local:
                    fn(*z, 4, scale, seen)
                both[key] = seen.of_both()
            check(torch.equal(both["kernel"].both.view(torch.float32),
                              both["plain"].both.float()),
                  f"phase 64 K15 {shape}: the kernel's amaxes "
                  f"{both['kernel'].both.view(torch.float32).tolist()} are "
                  f"not the plain version's "
                  f"{both['plain'].both.float().tolist()}")
            n = S8.fused_self_attention_packed_s8.launches
            outs = [S8.fused_self_attention_packed_s8(*z, 4, scale,
                                                      both["kernel"])
                    for z in local]
            check(S8.fused_self_attention_packed_s8.launches == n + 2,
                  f"phase 64 K15 {shape}: not launched")
            plains = [S8.fused_self_attention_packed_s8_reference(
                *z, 4, scale, both["plain"]) for z in local]
            one = _launched(S8.fused_self_attention_packed_s8, q, k, v, 8,
                            scale)
            row = _ulp_row("K15", shape, outs, plains, torch.cat(outs, 2),
                           one, "int8")
            rows["K15"].append(timed(
                row, lambda: S8.fused_self_attention_packed_s8(
                    *local[0], 4, scale, both["kernel"]),
                lambda: S8.fused_self_attention_packed_s8_reference(
                    *local[0], 4, scale, both["plain"]),
                k15_bound_ms(b, t, half, 4),
                lambda: S8.fused_self_attention_packed_s8(q, k, v, 8,
                                                          scale)))
            del local, outs, plains, one
            # K16's partial on a rank's rows of wq, wk, wv, columns of wo
            x = rand(shape)
            ws = _absorbed_weights(gen, c, torch.bfloat16)
            wl = [[w[r * half:(r + 1) * half].contiguous() for w in ws[:3]]
                  + [ws[3][:, r * half:(r + 1) * half].contiguous()]
                  for r in range(2)]
            parts = [_launched(A.absorbed_self_attention, x, *w, 4, scale,
                               True) for w in wl]
            plains = [A.absorbed_attention_reference(x, *w, 4, scale,
                                                     partial=True)
                      for w in wl]
            one = _launched(A.absorbed_self_attention, x, *ws, 8, scale)
            row = _ulp_row("K16", shape, parts, plains,
                           (parts[0] + parts[1]).to(torch.bfloat16), one,
                           BF16_ATOL, summed_parts=True)
            rows["K16"].append(timed(
                row, lambda: A.absorbed_self_attention(x, *wl[0], 4, scale,
                                                       True),
                lambda: A.absorbed_attention_reference(x, *wl[0], 4, scale,
                                                       partial=True),
                absorbed_partial_bound_ms(b, t, c, half, "bfloat16"),
                lambda: A.absorbed_self_attention(x, *ws, 8, scale)))
            # K17's partial on the pack of a rank's heads
            _, attn, _, _ = _block_modules(c, seed=t + c + 3)
            whole = S8.pack_absorbed_attention(attn, 8, 0.1)
            packs = [_rank_pack(whole, r) for r in range(2)]

            def k17(p, fn=S8.absorbed_self_attention_s8):
                return fn(x, p.w_qkv, p.wo_q, p.w_scale, p.heads, scale,
                          p.xs, p.wo_p, True)
            n = S8.absorbed_self_attention_s8.launches
            parts = [k17(p) for p in packs]
            check(S8.absorbed_self_attention_s8.launches == n + 2,
                  f"phase 64 K17 {shape}: not launched")
            plains = [S8.absorbed_attention_s8_reference(
                x, p.w_qkv, p.wo_q, p.w_scale, p.heads, scale, p.xs,
                partial=True) for p in packs]
            one = _launched(S8.absorbed_self_attention_s8, x, whole.w_qkv,
                            whole.wo_q, whole.w_scale, 8, scale, whole.xs,
                            whole.wo_p)
            row = _ulp_row("K17", shape, parts, plains,
                           (parts[0] + parts[1]).to(torch.bfloat16), one,
                           "int8", summed_parts=True)
            rows["K17"].append(timed(
                row, lambda: k17(packs[0]),
                lambda: S8.absorbed_attention_s8_reference(
                    x, packs[0].w_qkv, packs[0].wo_q, packs[0].w_scale, 4,
                    scale, packs[0].xs, partial=True),
                absorbed_s8_partial_bound_ms(b, t, c, half),
                lambda: S8.absorbed_self_attention_s8(
                    x, whole.w_qkv, whole.wo_q, whole.w_scale, 8, scale,
                    whole.xs, whole.wo_p)))
            for kid in rows:
                r = rows[kid][-1]
                r["per_unet_forward"] = per
            del q, k, v, x, ws, wl, parts, plains, one, attn, whole, packs
            torch.cuda.empty_cache()
        rows.update(_option_kernel_rows(gen, seed, timed))
    for kid, rs in rows.items():
        print(f"phase 64 {kid} on a rank's share ({rs[0]['mode']}): "
              + "; ".join(f"{r['shape']}: err {r['max_abs_err']:.3e}, the "
                          f"ranks together {r['ulps']} bf16 ulps (max "
                          f"|diff| {r['max_abs_diff_vs_one_rank']:.3e}) from "
                          f"one rank, {r['ms']:.4f} ms (one rank's kernel "
                          f"{r['one_rank_ms']:.4f}, plain "
                          f"{r['plain_ms']:.3f}, bound {r['bound_ms']:.4f} "
                          f"{r['bound_by']})" for r in rs), flush=True)
    return rows


# the resnet norms' shapes ([B, C, H, W], one of each class of a UNet
# forward on a 32x64 latent at batch 2) at which phase 64 feeds K6's codes
# to a rank's column s8 conv
K6_AXIS_SHAPES = [(2, 320, 32, 64), (2, 640, 16, 32), (2, 1280, 8, 16),
                  (2, 1280, 4, 8)]


def _conv1x1(c: int, gen):
    """A 1x1 conv (Transformer2D's ``proj_in`` or ``proj_out``) on the card
    with seeded fp32 weights and bias."""
    import torch
    conv = torch.nn.Conv2d(c, c, 1).to("cuda")
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen,
                                      device="cuda") * c ** -0.5)
        conv.bias.copy_(0.1 * torch.randn(c, generator=gen, device="cuda"))
    return conv


def _option_kernel_rows(gen, seed: int, timed) -> dict:
    """Phase 64's rows of the last int8 options' model-axis modes at the
    int8 UNet's forward shapes (a rank of 2): K8's partial mode (the whole
    prologue, then K3's partial on 4 of 8 heads: ``ldmseg_attention_ln_
    s8_pin`` with ``partial`` 1), K9's (K4's two launches on half the
    GEGLU columns, the two ranks' amax slots' maximum between them, the
    partials summed and rounded into r, then the ``proj_out`` stage alone,
    ``ldmseg_geglu_ln_s8_pout`` with ``proj_out_only`` 1) and K11's (the
    int32 ``to_out`` of 4 of 8 heads, ``partial`` 1 of
    ``ldmseg_attention_padded_s8``, on the pack with the group's
    ``max(wos)``): each rank's partial against its plain version at phase
    7's bounds, the ranks together against the one-rank kernel (K11 bit
    for bit, K8 and K9's r, against the one-rank K4's, within a bf16 ulp
    or 2^-16 of max|out|; K9's output within that plus r's flipped ulps
    carried through Wpo); and K6 at
    the resnet norms' shape classes, its codes fed to each rank's column s8
    conv, the two ranks' channels together bit-equal to the one-rank
    conv's. ``timed`` adds the times (``phase_axis_kernels``)."""
    import torch
    from ldmseg_torch.ops import attention_s8 as S8
    from ldmseg_torch.ops import geglu as G
    from ldmseg_torch.ops import groupnorm_silu as GN
    from ldmseg_torch.ops.quant import QuantConv2d
    rows = {kid: [] for kid in ("K8", "K9", "K11", "K6")}

    def rand(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    with torch.inference_mode():
        for shape, per in INT8_SHAPES:
            b, t, c = shape
            half = c // 2
            norm1, attn, norm3, ff = _block_modules(c, seed=t + c + 27)
            xg = rand((b, c, t)).transpose(1, 2)  # the GN's tokens view
            xs = rand(shape)
            # K8: the prologue over all C, K3's partial on a rank's heads
            whole = S8.with_proj_in(S8.pack_ln_attention(norm1, attn, 8,
                                                         0.1),
                                    _conv1x1(c, gen))
            packs = [_rank_pack(whole, r) for r in range(2)]
            outs = [S8._launch(xg, p, "K8", partial=True) for p in packs]
            check(torch.equal(outs[0][0], outs[1][0]),
                  f"phase 64 K8 {shape}: the ranks' prologues differ")
            parts = [o[1] for o in outs]
            plains = [S8.ln_attention_s8_pin_reference(xg, p, partial=True)
                      for p in packs]
            summed = S8.ln_attention_s8_finish(
                outs[0][0].view(b, t, c), parts[0] + parts[1], whole,
                fallback=False)
            one = _launched(S8.ln_attention_s8_pin, xg, whole)
            row = _ulp_row("K8", shape, parts, plains, summed, one, "int8",
                           summed_parts=True)
            rows["K8"].append(timed(
                row, lambda: S8._launch(xg, packs[0], "K8", partial=True),
                lambda: S8.ln_attention_s8_pin_reference(xg, packs[0],
                                                         partial=True),
                pin_partial_bound_ms(b, t, c, half),
                lambda: S8.ln_attention_s8_pin(xg, whole)))
            # K9: K4's partial on half the columns (dynamic interior: the
            # two ranks' amaxes' maximum between its launches), the sum
            # rounded into r, then proj_out alone with the whole weight
            whole = G.with_proj_out(G.pack_geglu(
                norm3, ff.net[0].proj, ff.net[2], 0.05, None),
                _conv1x1(c, gen))
            fq = [_rank_pack(whole, r) for r in range(2)]
            runs = {"kernel": lambda q, grp: G._launch(xs, q, True,
                                                       group=grp),
                    "plain": lambda q, grp: G.geglu_ln_s8_reference(
                        xs, q, partial=True, group=grp)}
            out, both = {}, {}
            for key, run in runs.items():
                seen = _AmaxGroup()
                for q in fq:
                    run(q, seen)
                both[key] = seen.of_both()
                out[key] = [run(q, both[key]) for q in fq]
            parts, plains = out["kernel"], out["plain"]
            # the block output r: the partials summed and rounded against
            # the one-rank K4's (the r K9's own kernels write)
            r = G.geglu_finish(xs, parts[0] + parts[1], whole, True,
                               fallback=False)
            r_one = _launched(G.geglu_ln_s8, xs, whole)
            row = _ulp_row("K9", shape, parts, plains, r, r_one, "int8",
                           summed_parts=True,
                           mode="half the GEGLU columns")
            summed = G._proj_out_launch(r, whole)
            stage = G.proj_out_reference(r, whole).float()
            err = (summed.float() - stage).abs().max().item()
            check(err <= INT8_MAX_TOL * stage.abs().max().item(),
                  f"phase 64 K9 {shape}: the proj_out stage alone against "
                  f"its plain version, err {err}")
            one = _launched(G.geglu_ln_s8_pout, xs, whole)
            check(torch.equal(G._proj_out_launch(r_one, whole), one),
                  f"phase 64 K9 {shape}: the one-rank kernel is not K4's r "
                  f"through the proj_out stage")
            # the output: within a bf16 ulp of the one-rank kernel's
            # (2^-16 of max|out| near zero) plus r's flipped ulps carried
            # through Wpo: proj_out reads every channel of r, which rounds
            # the reordered partials to bf16 first
            moved = ((r.float() - r_one.float()).abs().reshape(b * t, c)
                     @ whole.wpo.float().abs().t()).view(b, t, c)
            ref = one.float()
            _, e = torch.frexp(ref)
            bound = torch.ldexp(torch.ones_like(ref), e - 8).clamp_min(
                2.0 ** -16 * float(ref.abs().max())) + moved
            row.update(out_ulps=_bf16_ulps(summed, one),
                       out_max_abs_diff=float((summed.float() - ref).abs()
                                              .max()),
                       proj_out_stage_max_abs_err=err)
            check(bool(((summed.float() - ref).abs() <= bound).all()),
                  f"phase 64 K9 {shape}: the output is {row['out_ulps']} "
                  f"bf16 ulps (max |diff| {row['out_max_abs_diff']}) from "
                  f"the one-rank kernel's, beyond an ulp plus r's flips "
                  f"carried through Wpo")
            rows["K9"].append(timed(
                row, lambda: (G._launch(xs, fq[0], True,
                                        group=both["kernel"]),
                              G._proj_out_launch(r, whole)),
                lambda: G.geglu_ln_s8_reference(xs, fq[0], partial=True,
                                                group=both["plain"]),
                pout_partial_bound_ms(b, t, c, 2 * c),
                lambda: G.geglu_ln_s8_pout(xs, whole)))
            # K11: the int32 to_out partials of a rank's heads, summed
            # exactly, on the group's max(wos)
            whole = S8.pack_padded_attention(attn, 8, 0.1)
            p11 = [_rank_pack(whole, r) for r in range(2)]
            parts = [S8._padded_launch(xs, p, partial=True) for p in p11]
            plains = [S8.padded_attention_s8_reference(xs, p, partial=True)
                      for p in p11]
            summed = S8.padded_attention_s8_finish(parts[0] + parts[1],
                                                   whole)
            one = _launched(S8.padded_attention_s8, xs, whole)
            row = _ulp_row("K11", shape, [z.float() for z in parts],
                           [z.float() for z in plains], summed, one, "int8")
            row["bit_equal"] = bool(torch.equal(summed, one))
            check(row["bit_equal"], f"phase 64 K11 {shape}: the ranks' "
                  f"int32 partials summed are {row['ulps']} bf16 ulps from "
                  f"the one-rank kernel, not bit-equal")
            rows["K11"].append(timed(
                row, lambda: S8._padded_launch(xs, p11[0], partial=True),
                lambda: S8.padded_attention_s8_reference(xs, p11[0],
                                                         partial=True),
                padded_partial_bound_ms(b, t, c, half),
                lambda: S8.padded_attention_s8(xs, whole)))
            for kid in ("K8", "K9", "K11"):
                rows[kid][-1]["per_unet_forward"] = per
            del norm1, attn, norm3, ff, xg, xs, whole, packs, fq, p11
            del outs, parts, plains, summed, one, r, r_one, out, both
            torch.cuda.empty_cache()
        for shape in K6_AXIS_SHAPES:
            b, c, h, w = shape
            x = rand(shape)
            sc = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
            bi = 0.1 * torch.randn(c, generator=gen, device="cuda")
            q, s = _launched(GN.group_norm_silu_quant, x, sc, bi, 32, 1e-5)
            rq, rs = GN.group_norm_silu_quant_reference(x, sc, bi, 32, 1e-5)
            srel = ((s - rs).abs() / rs).max().item()
            diff = (q.int() - rq.int()).abs()
            flips = int((diff > 0).sum().item())
            check(srel <= 1e-5 and int(diff.max().item()) <= 1
                  and flips <= GN_CODE_FLIPS * q.numel(),
                  f"phase 64 K6 {shape}: scale rel err {srel}, codes off "
                  f"by up to {int(diff.max().item())} at {flips}")
            err, rmax = _max_err(q.float() * s[:, None, None, None],
                                 rq.float() * rs[:, None, None, None])
            # the s8 conv on K6's codes: whole, and each rank's output
            # channels (ColumnQuantConv2d's codes), put together
            conv = QuantConv2d(c, c).to("cuda")
            init_gen = torch.Generator(device="cuda").manual_seed(c + h)
            with torch.no_grad():
                conv.weight.copy_(torch.randn(conv.weight.shape,
                                              generator=init_gen,
                                              device="cuda") * 0.03)
                conv.bias.copy_(0.1 * torch.randn(c, generator=init_gen,
                                                  device="cuda"))
            conv.prepare(conv)
            one = conv((q, s))
            half = c // 2
            ranks = []
            for rk in range(2):
                cut = slice(rk * half, (rk + 1) * half)
                rc = QuantConv2d(c, half).to("cuda")
                rc.w_q, rc.w_scale = conv.w_q[cut], conv.w_scale[cut]
                with torch.no_grad():
                    rc.bias.copy_(conv.bias[cut])
                ranks.append(rc((q, s)))
            together = torch.cat(ranks, 1)
            row = {"shape": list(shape),
                   "mode": "whole on the replicated input, into a rank's "
                           "column s8 conv", "max_abs_err": err,
                   "max_abs_ref": rmax, "scale_max_rel_err": srel,
                   "code_flips": flips, "per_unet_forward": 1,
                   "ulps": _bf16_ulps(together, one),
                   "max_abs_diff_vs_one_rank": float(
                       (together.float() - one.float()).abs().max()),
                   "bit_equal": bool(torch.equal(together, one))}
            check(row["bit_equal"], f"phase 64 K6 {shape}: the ranks' "
                  f"column s8 convs on K6's codes are {row['ulps']} bf16 "
                  f"ulps from the one-rank conv, not bit-equal")
            rows["K6"].append(timed(
                row, lambda: GN.group_norm_silu_quant(x, sc, bi, 32, 1e-5),
                lambda: GN.group_norm_silu_quant_reference(x, sc, bi, 32,
                                                           1e-5),
                _gn_bound(shape, 2, 1, GN_QUANT_OPS),
                lambda: GN.group_norm_silu_quant(x, sc, bi, 32, 1e-5)))
            del x, q, s, rq, rs, conv, one, ranks, together
    return rows


def pin_partial_bound_ms(b, t, c, ci, heads: int = 4):
    """K8's partial mode's bound for one call: the prologue's 2·B·T·C²
    bf16 operations over all C, K3's projections (3 · 2·B·T·C·ci int8) and
    to_out (2·B·T·ci·C bf16) over the rank's inner width and its attention
    over the rank's heads, against bf16 x in, the whole bf16 Wpi and its
    bias, the rank's int8 q/k/v rows and bf16 to_out columns, the LN rows,
    the fp32 xf and partial out."""
    d = ci // heads
    ops8 = 3 * 2.0 * b * t * c * ci + 2.0 * b * heads * t * t * d
    ops16 = (2.0 * b * t * c * c + 2.0 * b * heads * t * t * d
             + 2.0 * b * t * ci * c)
    nbytes = (2.0 * b * t * c + 2 * c * c + 4 * c + 3 * ci * c + 2 * c * ci
              + 4 * (3 * ci + 2 * c) + 2 * 4.0 * b * t * c)
    t_ops = (ops8 / PEAK_FLOPS["int8"] + ops16 / PEAK_FLOPS["bfloat16"]) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes")


def pout_partial_bound_ms(b, t, c, m):
    """K9's on a rank's ``m`` of the 4C GEGLU columns: K4's int8
    operations over them and the ``proj_out`` stage's 2·B·T·C² bf16,
    against x in, the rank's W1 rows and W2 columns with their float rows,
    the whole bf16 Wpo and its bias, the fp32 partial out, r in and the
    bf16 output."""
    ops8 = 2.0 * b * t * c * 2 * m + 2.0 * b * t * m * c
    ops16 = 2.0 * b * t * c * c
    nbytes = (2.0 * b * t * c + 3 * m * c + 4 * (4 * m + 3 * c)
              + 2 * c * c + 4 * c + 4.0 * b * t * c + 2 * 2.0 * b * t * c)
    t_ops = (ops8 / PEAK_FLOPS["int8"] + ops16 / PEAK_FLOPS["bfloat16"]) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes")


def padded_partial_bound_ms(b, t, c, ci, heads: int = 4):
    """K11's partial mode's bound: four int8 products over the rank's
    inner width (q, k, v, to_out: 2·B·T·C·ci each) and its attention
    (2 · 2·B·h·T²·d), against bf16 x in, the rank's int8 weights and
    scales and the int32 partial out."""
    d = ci // heads
    ops8 = 4 * 2.0 * b * t * c * ci + 2 * 2.0 * b * heads * t * t * d
    nbytes = (2.0 * b * t * c + 4 * c * ci + 4 * (3 * ci + heads)
              + 4.0 * b * t * c)
    t_ops = ops8 / PEAK_FLOPS["int8"] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes")


def absorbed_partial_bound_ms(b, t, c, ci, dtype_name):
    """K16's partial mode's bound for one call: the Q/K/V product's
    2·B·T·C·3ci, the attention's 2·2·B·T²·ci and to_out's 2·B·T·ci·C
    operations, against x in, the four [ci, C] weights and the fp32
    partial out."""
    esize = 2 if dtype_name == "bfloat16" else 4
    flops = 4 * 2.0 * b * t * c * ci + 2 * 2.0 * b * t * t * ci
    nbytes = float(esize) * (b * t * c + 4 * c * ci) + 4.0 * b * t * c
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes")


def absorbed_s8_partial_bound_ms(b, t, c, ci, heads: int = 4):
    """K17's partial mode's bound: K16's partial operations on int8 at the
    int8 peak, against bf16 x in, the int8 weights of a rank's heads with
    their scales and the fp32 partial out."""
    ops8 = 4 * 2.0 * b * t * c * ci + 2 * 2.0 * b * t * t * ci
    nbytes = 2.0 * b * t * c + 4 * c * ci + 4 * 4 * heads + 4.0 * b * t * c
    t_ops = ops8 / PEAK_FLOPS["int8"] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes")


def _module_inputs():
    """The emulated modules' inputs, the same in every process on the card
    (seeded CUDA generators): a transformer block's float modules at
    ``EMULATED_SHAPE``'s width, x, K13's q, k, v and K16's weights."""
    import torch
    b, t, c = EMULATED_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(640)
    norm1, attn, norm3, ff = _block_modules(c, seed=641)

    def rand(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    return {"norm1": norm1, "attn": attn, "norm3": norm3, "ff": ff,
            "x": rand((b, t, c)),
            "qkv": tuple(rand((b, t, 8, c // 8)) for _ in range(3)),
            "ws": _absorbed_weights(gen, c, torch.bfloat16),
            "scale": (c // 8) ** -0.5,
            # K8's input, the GN's tokens view, and the two 1x1 convs
            "xg": rand((b, c, t)).transpose(1, 2),
            "proj_in": _conv1x1(c, gen), "proj_out": _conv1x1(c, gen)}


def _module_packs(inp):
    """The whole packs of the emulated modules: K3's, K4's (and K12's) with
    a dynamic and a static interior scale, K17's, K8's (K3's with
    ``proj_in``), K9's (K4's dynamic one with ``proj_out``) and K11's."""
    from ldmseg_torch.ops import attention_s8 as S8
    from ldmseg_torch.ops import geglu as G
    packs = {"K3": S8.pack_ln_attention(inp["norm1"], inp["attn"], 8, 0.1),
             "dynamic": G.pack_geglu(inp["norm3"], inp["ff"].net[0].proj,
                                     inp["ff"].net[2], 0.05, None),
             "static": G.pack_geglu(inp["norm3"], inp["ff"].net[0].proj,
                                    inp["ff"].net[2], 0.05, 0.02),
             "K17": S8.pack_absorbed_attention(inp["attn"], 8, 0.1),
             "K11": S8.pack_padded_attention(inp["attn"], 8, 0.1)}
    packs["K8"] = S8.with_proj_in(packs["K3"], inp["proj_in"])
    packs["K9"] = G.with_proj_out(packs["dynamic"], inp["proj_out"])
    return packs


# the emulated modules, K4 and K12 in both interior scale modes (the mesh
# also runs PR 25's planted control, "K12 rank-local amax": each rank
# quantizing K12's interior on its own amax)
EMULATED = ("K3", "K4 dynamic", "K4 static", "K12 dynamic", "K12 static",
            "K13", "K15", "K16", "K17", "K8", "K9", "K11")
# the mesh's planted controls (:func:`_module_outputs`), each with the
# emulated module whose output it must not reproduce
PLANTED = {"K12 rank-local amax": "K12 dynamic",
           "K11 rank-local max(wos)": "K11"}


def _module_run(name, inp, packs, r, group, heads=4):
    """Rank ``r``'s output of the emulated module ``name`` with ``group``
    (the model group's reductions, or a one-process stand-in)."""
    import torch
    from ldmseg_torch.ops import attention as A
    from ldmseg_torch.ops import attention_s8 as S8
    from ldmseg_torch.ops import geglu as G
    x, scale = inp["x"], inp["scale"]
    half = x.shape[-1] // 2
    if name == "K3":
        return S8.ln_attention_s8(x, _rank_pack(packs["K3"], r), group)
    if name == "K8":
        return S8.ln_attention_s8_pin(inp["xg"], _rank_pack(packs["K8"], r),
                                      group)
    if name == "K9":
        return G.geglu_ln_s8_pout(x, _rank_pack(packs["K9"], r), group)
    if name == "K11":
        return S8.padded_attention_s8(x, _rank_pack(packs["K11"], r), group)
    if name.startswith(("K4", "K12")):
        kid, mode = name.split(" ", 1)
        p = _rank_pack(packs["static" if mode == "static" else "dynamic"], r)
        fn = G.geglu_ln_s8 if kid == "K4" else G.fused_geglu_s8
        return fn(x, p, group)
    if name == "K13":
        q, k, v = (z[:, :, r * heads:(r + 1) * heads] for z in inp["qkv"])
        return S8.fused_self_attention_s8(q, k, v, scale, None, group)
    if name == "K15":
        q, k, v = (z.flatten(2)[:, :, r * half:(r + 1) * half].contiguous()
                   for z in inp["qkv"])
        return S8.fused_self_attention_packed_s8(q, k, v, heads, scale,
                                                 group)
    if name == "K16":
        ws = inp["ws"]
        wl = ([w[r * half:(r + 1) * half].contiguous() for w in ws[:3]]
              + [ws[3][:, r * half:(r + 1) * half].contiguous()])
        part = A.absorbed_self_attention(x, *wl, heads, scale, True)
        return group.sum(part).to(torch.bfloat16)
    p = _rank_pack(packs["K17"], r)
    part = S8.absorbed_self_attention_s8(x, p.w_qkv, p.wo_q, p.w_scale,
                                         heads, scale, p.xs, p.wo_p, True)
    return group.sum(part).to(torch.bfloat16)


class _SumGroup(_AmaxGroup):
    """A model group of two ranks in one process for the emulation:
    ``max`` as :class:`_AmaxGroup`'s; ``sum`` of a rank's fp32 partial
    returns ``total`` (both ranks' partials added in rank order), or,
    where ``total`` is None, records the partial and returns it."""

    def __init__(self, both=None, total=None):
        super().__init__(both)
        self.total, self.parts = total, []

    def sum(self, x):
        if self.total is not None:
            return self.total
        self.parts.append(x.float().clone())
        return x.float()

    def sum_exact(self, x):
        """:meth:`sum` of integer partials (K11's), in their dtype."""
        if self.total is not None:
            return self.total
        self.parts.append(x.clone())
        return x


def module_emulation() -> dict:
    """Each emulated module's output on each rank of a model axis of 2,
    computed in this one process from the sliced packs, in three passes
    over the two ranks: the first records their amaxes, the second their
    fp32 partials with the amaxes' maximum, the third gives each rank's
    output from that maximum and the partials added in rank order,
    rounded where a rank rounds."""
    import torch
    inp = _module_inputs()
    packs = _module_packs(inp)
    out = {}
    with torch.inference_mode():
        for name in EMULATED:
            first = _SumGroup()
            for r in range(2):
                _module_run(name, inp, packs, r, first)
            amax = (torch.maximum(*first.amaxes) if first.amaxes
                    else None)
            second = _SumGroup(amax)
            for r in range(2):
                _module_run(name, inp, packs, r, second)
            total = (second.parts[0] + second.parts[1] if second.parts
                     else None)
            third = _SumGroup(amax, total)
            out[name] = [_module_run(name, inp, packs, r, third).cpu()
                         for r in range(2)]
    return out


def _rank_attention(attn, r: int, n: int = 2):
    """Rank ``r``'s heads of an attention's four projections, as ``apply_tp``
    cuts them (``to_q/k/v``'s rows, ``to_out``'s columns)."""
    from types import SimpleNamespace
    ci = attn.to_q.weight.shape[0] // n
    rows = slice(r * ci, (r + 1) * ci)
    return SimpleNamespace(
        to_q=SimpleNamespace(weight=attn.to_q.weight[rows]),
        to_k=SimpleNamespace(weight=attn.to_k.weight[rows]),
        to_v=SimpleNamespace(weight=attn.to_v.weight[rows]),
        to_out=[SimpleNamespace(weight=attn.to_out[0].weight[:, rows])])


def _module_outputs(mesh) -> dict:
    """The emulated modules on this rank of the mesh, with the model group
    (gloo's collectives), and the planted controls (:data:`PLANTED`): PR
    25's K12 on its dynamic interior scale with the group's ``max``
    returning this rank's own amax; K11 on a pack of this rank's heads made
    with the rank's own ``max(wos)`` (``pack_padded_attention`` without the
    group)."""
    import torch
    from ldmseg_torch.ops import attention_s8 as S8
    from ldmseg_torch.parallel import sp, tp
    ax = sp.model_axis(mesh)
    group = tp.ModelGroup(ax)
    inp = _module_inputs()
    packs = _module_packs(inp)
    out = {}
    with torch.inference_mode():
        for name in EMULATED:
            out[name] = _module_run(name, inp, packs, ax.rank, group).cpu()
        planted = tp.ModelGroup(ax)
        planted.max = lambda a: a
        out["K12 rank-local amax"] = _module_run(
            "K12 dynamic", inp, packs, ax.rank, planted).cpu()
        local = S8.pack_padded_attention(_rank_attention(inp["attn"],
                                                         ax.rank), 8, 0.1)
        out["K11 rank-local max(wos)"] = S8.padded_attention_s8(
            inp["x"], local, group).cpu()
        out["K11 out_scales"] = (local.out_scale, packs["K11"].out_scale)
    return out


def emulation_report(emulated: dict, ranks: list) -> dict:
    """Each rank's module outputs from the mesh against the one-process
    emulation: bit-equal for every module, the planted controls not (their
    distance in bf16 ulps printed; K11's rank-local and group ``out_scale``
    beside it)."""
    import torch
    result = {}
    for name in EMULATED + tuple(PLANTED):
        want = emulated[PLANTED.get(name, name)]
        row = []
        for r, got in enumerate(ranks):
            g, w = got[name], want[r]
            row.append({"bit_equal": g.dtype == w.dtype and torch.equal(g, w),
                        "ulps": _bf16_ulps(g, w),
                        "max_abs_diff": float((g.float() - w.float()).abs()
                                              .max())})
        result[name] = row
        if name == "K11 rank-local max(wos)":
            result["K11 out_scales"] = [got["K11 out_scales"]
                                        for got in ranks]
            print(f"phase 64 emulation K11: out_scale (rank-local, the "
                  f"group's) by rank {result['K11 out_scales']}",
                  flush=True)
        print(f"phase 64 emulation {name}: "
              + ", ".join(f"rank {r} "
                          f"{'bit-equal' if x['bit_equal'] else 'differs'}"
                          f" ({x['ulps']} bf16 ulps, max |diff| "
                          f"{x['max_abs_diff']:.3e})"
                          for r, x in enumerate(row)), flush=True)
        if name in PLANTED:
            check(not all(x["bit_equal"] for x in row),
                  f"phase 64 emulation: the planted {name} left the mesh's "
                  f"output bit-equal to the emulation")
        else:
            check(all(x["bit_equal"] for x in row),
                  f"phase 64 emulation {name}: the mesh's output differs "
                  f"from the one-process emulation: {row}")
    return result


def _axis_inputs():
    """Phase 64's training batch (``SyntheticDVPS`` at the bench's 256x512,
    batch 2), the step's noise and timesteps, from a CPU generator."""
    import torch
    from ldmseg_torch.data.collate import collate
    from ldmseg_torch.data.synthetic import SyntheticDVPS
    ds = SyntheticDVPS(length=MA_BATCH, size=SERVE_HW, num_bits=8)
    batch = collate([ds[i] for i in range(MA_BATCH)])
    gen = torch.Generator().manual_seed(64)
    lat = (MA_BATCH, SERVE_HW[0] // 8, SERVE_HW[1] // 8, 4)
    return (batch, torch.randn(lat, generator=gen),
            torch.randint(0, 1000, (MA_BATCH,), generator=gen))


def _axis_runs(flag: str, mesh=None, nudge: bool = False,
               scales=None) -> dict:
    """Phase 64's calls for ``flag`` on one rank (``mesh`` None) or on this
    rank of the mesh: the bf16 training configuration's trainer (phase 62's,
    the full-depth UNet with the flag) takes one step on
    :func:`_axis_inputs` (the gradients the optimizer read, the loss) and a
    ``MA_STEPS``-step bf16 sample on the phase 63 frames and noise; then
    the unfused int8 serving trainer (phase 63's configuration with
    ``fused_norms: False`` and the flag) calibrates (its scales kept) and
    samples, on ``scales`` where given (one rank's: the mesh's own are
    ulps apart, which flips codes next to a .5). Each with one UNet forward
    on phase 63's fixed input, its launches and seconds; ``nudge``: also
    the sample and forward from the inputs moved by ``SERVE_NUDGE``."""
    import torch
    from ldmseg_torch.parallel import tp
    from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
    parallel = mesh is not None
    batch, noise, steps = _axis_inputs()
    image, calib, init, _ = _serve_inputs()
    out = {}
    cfg = _ma_config(parallel)
    trainer = TrainerDiffusion(cfg, unet_config=_flagged_unet(cfg, flag),
                               mesh=mesh)
    trainer.init_params(seed=0)
    named = list(trainer.unet.named_parameters())
    opt, seen = trainer.state.optimizer, {}
    opt_step = opt.step

    def read_then_step():
        seen.update({n: p.grad.detach().clone() for n, p in named})
        opt_step()
    opt.step = read_then_step
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _, _ = trainer.train_step(batch, noise=noise, timesteps=steps)
    torch.cuda.synchronize()
    out["step"] = {"loss": float(loss), "grads": seen,
                   "layout": tp.layout(trainer.unet),
                   "seconds": time.perf_counter() - t0, "counts": _counts()}
    opt.step = opt_step
    out["bf16"] = _axis_sample(trainer, image, init, nudge)
    del trainer, named, opt, seen
    torch.cuda.empty_cache()
    cfg8 = _serve_config(parallel, sampling_kwargs={"fused_norms": False})
    trainer = TrainerDiffusion(cfg8, unet_config=_flagged_unet(cfg8, flag),
                               mesh=mesh)
    trainer.init_params(seed=0)
    calibrated = trainer.calibrate_int8({"image": image}, noise=calib)
    if scales is not None:
        trainer._int8_act_scales = dict(scales)
    out["int8"] = _axis_sample(trainer, image, init, nudge)
    out["int8"]["scales"] = calibrated
    del trainer
    torch.cuda.empty_cache()
    return out


def _axis_sample(trainer, image, init, nudge: bool) -> dict:
    """A ``MA_STEPS``-step eager sample and one UNet forward
    (:func:`_serve_forward`) of ``trainer``, with launches and seconds;
    ``nudge``: from the nudged inputs too."""
    import torch
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, x0 = trainer.sample_panoptic({"image": image}, init_noise=init,
                                    num_inference_steps=MA_STEPS,
                                    graph=False)
    torch.cuda.synchronize()
    res = {"x0": x0.float().cpu(), "counts": _counts(),
           "seconds": time.perf_counter() - t0,
           "forward": _serve_forward(trainer, None)}
    if nudge:
        _, nudged = trainer.sample_panoptic(
            {"image": image}, init_noise=_serve_nudge(init),
            num_inference_steps=MA_STEPS, graph=False)
        res["nudged_x0"] = nudged.float().cpu()
        res["nudged_forward"] = _serve_forward(trainer, None, nudged=True)
    return res


def _axis_reference(path: str) -> dict:
    """Phase 64's one-rank calls for both flags (:func:`_axis_runs`, with
    the nudged sample and forward); each step's gradients (bf16, flat in
    parameter order, with their names and shapes) go to ``path`` + flag for
    the ranks."""
    import os
    import torch
    out = {}
    for flag in AXIS_FLAGS:
        t0 = time.perf_counter()
        res = out[flag] = _axis_runs(flag, nudge=True)
        grads = res["step"].pop("grads")
        res["step"].pop("layout")
        torch.save({"names": list(grads),
                    "shapes": [tuple(g.shape) for g in grads.values()],
                    "grads": torch.cat([g.reshape(-1).bfloat16()
                                        for g in grads.values()]).cpu()},
                   path + flag + ".part")
        os.replace(path + flag + ".part", path + flag)
        del grads
        res["seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    return out


def _grad_cosine(grads: dict, lay: dict, mesh, ref_path: str) -> float:
    """The cosine of this rank's gradient shards (``lay``: the TP layout),
    put together over the model group, with the one-rank step's
    (``ref_path``): each rank's shards against their slices, a replicated
    tensor counted on model rank 0, the sums all-reduced over the model
    group."""
    import torch
    import torch.distributed as dist
    from ldmseg_torch.parallel import sp, tp
    ref = torch.load(ref_path, mmap=True, weights_only=True)
    ax = sp.model_axis(mesh)
    offsets, off = {}, 0
    for n, s in zip(ref["names"], ref["shapes"]):
        offsets[n] = (off, s)
        off += math.prod(s)
    sums = torch.zeros(3, dtype=torch.float64, device="cuda")
    for n, g in grads.items():
        if n not in lay and mesh.model_rank != 0:
            continue
        o, s = offsets[n]
        rg = ref["grads"][o:o + math.prod(s)].view(s).to("cuda")
        if n in lay:
            rg = tp.local_tensor(rg, lay[n][0], ax, lay[n][1])
        a, b = g.reshape(-1).double(), rg.reshape(-1).double()
        sums += torch.stack([a @ b, a @ a, b @ b])
    dist.all_reduce(sums, group=mesh.model_group)
    s = sums.tolist()
    return s[0] / math.sqrt(s[1] * s[2])


def _axis_rank(mesh, spec: dict) -> dict:
    """Phase 64's calls for both flags on this rank of the mesh
    (:func:`_axis_runs`; the int8 sample on one rank's scales,
    ``spec["axis_scales"]``), the step's gradient cosine with the one-rank
    step's (``spec["axis_ref"]`` + flag)."""
    import torch
    out = {}
    for flag in AXIS_FLAGS:
        t0 = time.perf_counter()
        res = out[flag] = _axis_runs(flag, mesh,
                                     scales=spec["axis_scales"][flag])
        grads = res["step"].pop("grads")
        lay = res["step"].pop("layout")
        res["step"]["grad_cos"] = _grad_cosine(grads, lay, mesh,
                                               spec["axis_ref"] + flag)
        res["step"]["sharded"] = len(lay)
        del grads
        torch.cuda.empty_cache()
        res["seconds"] = time.perf_counter() - t0
    return out


def _errs(got: dict, ref: dict, out: str, nudged: str) -> tuple:
    """Phases 63-64's error tuple of ``got[out]`` against one rank's
    ``ref[out]``: max and mean error, one rank's own move when its input
    moves by ``SERVE_NUDGE`` (``ref[nudged]``; max and mean), max|ref|."""
    d = (got[out] - ref[out]).abs()
    n = (ref[nudged] - ref[out]).abs()
    return (float(d.max()), float(d.mean()), float(n.max()), float(n.mean()),
            float(ref[out].abs().max()))


def axis_report(smi_line: str, one: dict, ranks: list) -> dict:
    """Phase 64's checks and lines for each flag: the TP + SP step's loss
    within 1e-3 of one rank's and its gradient cosine >= 0.9999 (phase
    62's bounds), K14 or K16 32 and K2 16 launches a step; the bf16 and the
    unfused int8 samples' forward and x0 within phase 63's bound of one
    rank's, K14 or K16 64 (bf16), K15 or K17 and K12 64 (int8) and K1's
    wide class once a sample; no fallback; the seconds of a rank's and of
    one rank's calls."""
    def err(row, mode, what):
        e = row[mode][f"{what}_err"]
        return f"{e[0]:.3e} of {e[4]:.3e} (nudge {e[2]:.3e})"
    calls = ("step", "bf16", "int8")
    result = {}
    for flag, (_, kid, kid8) in AXIS_FLAGS.items():
        ref = one[flag]
        want = {"bf16": _expect(**{kid: 16 * MA_STEPS, "K1w": 1}),
                "int8": _expect(**{kid8: 16 * MA_STEPS,
                                   "K12": 16 * MA_STEPS, "K1w": 1})}
        res = result[flag] = {"one_rank": {
            "loss": ref["step"]["loss"],
            "step_seconds": ref["step"]["seconds"],
            "bf16_sample_seconds": ref["bf16"]["seconds"],
            "int8_sample_seconds": ref["int8"]["seconds"],
            "counts": {k: ref[k]["counts"] for k in calls},
            "seconds": ref["seconds"]}, "ranks": []}
        for i, r in enumerate(ranks):
            got = r[flag]
            st = got["step"]
            rel = abs(st["loss"] - ref["step"]["loss"]) / abs(
                ref["step"]["loss"])
            row = {"loss": st["loss"], "loss_rel": rel,
                   "grad_cos": st["grad_cos"], "sharded": st["sharded"],
                   "step_seconds": st["seconds"],
                   "counts": {k: got[k]["counts"] for k in calls},
                   "seconds": got["seconds"]}
            check(rel <= 1e-3, f"phase 64 {flag} rank {i}: loss "
                  f"{st['loss']} vs one rank {ref['step']['loss']}")
            check(st["grad_cos"] >= 0.9999, f"phase 64 {flag} rank {i}: "
                  f"gradient cosine {st['grad_cos']}")
            mine, theirs = got["int8"]["scales"], ref["int8"]["scales"]
            check(mine.keys() == theirs.keys(),
                  f"phase 64 {flag} rank {i}: calibrated sites differ")
            row["scales_err"] = max(abs(v - theirs[k]) / abs(theirs[k])
                                    for k, v in mine.items())
            check(row["scales_err"] <= SERVE_SCALE_RTOL,
                  f"phase 64 {flag} rank {i}: calibrate_int8 "
                  f"{row['scales_err']} from one rank's (rtol "
                  f"{SERVE_SCALE_RTOL})")
            for mode in ("bf16", "int8"):
                fe = _errs(got[mode], ref[mode], "forward", "nudged_forward")
                xe = _errs(got[mode], ref[mode], "x0", "nudged_x0")
                row[mode] = {"forward_err": fe, "x0_err": xe,
                             "seconds": got[mode]["seconds"]}
                for name, e in (("forward", fe), ("x0", xe)):
                    check(_serve_within(e),
                          f"phase 64 {flag} rank {i} {mode}: {name} err max "
                          f"{e[0]} mean {e[1]} of max|ref| {e[4]}; one "
                          f"rank's own move for a {SERVE_NUDGE} nudge max "
                          f"{e[2]} mean {e[3]}")
            res["ranks"].append(row)
            print(f"phase 64 {flag} rank {i} (data=1, model=2, TP + SP + "
                  f"ZeRO-1, {kid} on 4 of 8 heads): step loss "
                  f"{st['loss']:.6f} vs one rank {ref['step']['loss']:.6f} "
                  f"(rel {rel:.2e}, tol 1e-3), gradient cosine "
                  f"{st['grad_cos']:.6f} (>= 0.9999), {st['sharded']} "
                  f"sharded tensors; {MA_STEPS}-step bf16 sample x0 err max "
                  f"{err(row, 'bf16', 'x0')}, forward "
                  f"{err(row, 'bf16', 'forward')}; int8 fused_norms False "
                  f"({kid8}; calibrate_int8 within {row['scales_err']:.2e} "
                  f"of one rank's, sampling on one rank's scales) x0 "
                  f"{err(row, 'int8', 'x0')}, forward "
                  f"{err(row, 'int8', 'forward')}; "
                  f"seconds: step {st['seconds']:.3f} (one rank "
                  f"{ref['step']['seconds']:.3f}), bf16 sample "
                  f"{got['bf16']['seconds']:.3f} "
                  f"({ref['bf16']['seconds']:.3f}), int8 sample "
                  f"{got['int8']['seconds']:.3f} "
                  f"({ref['int8']['seconds']:.3f}); two gloo ranks on ONE "
                  f"card: not a speed [{smi_line}]", flush=True)
        for who, got in [("one rank", ref)] + [
                (f"rank {i}", r[flag]) for i, r in enumerate(ranks)]:
            c = got["step"]["counts"]
            print(f"phase 64 {flag} {who} launches: step "
                  f"{ {k: v for k, v in c.items() if v} }, bf16 sample "
                  f"{ {k: v for k, v in got['bf16']['counts'].items() if v} }"
                  f", int8 sample "
                  f"{ {k: v for k, v in got['int8']['counts'].items() if v} }",
                  flush=True)
            check(c[kid] == 32 and c["K2"] == 16 and c["K1"] == 0
                  and c["fallbacks"] == 0,
                  f"phase 64 {flag} {who}: a step launched {c} (32 {kid}, "
                  f"16 K2, no K1, no fallback expected)")
            for mode in want:
                check(got[mode]["counts"] == want[mode],
                      f"phase 64 {flag} {who} {mode} sample: launched "
                      f"{got[mode]['counts']}, expected {want[mode]}")
    return result


# phase 64's int8 options at full width: the serving trainer's UNet with
# both, and the K11 UNet (use_padded_attention without fused norms; no K6)
OPTION_FLAGS = {"use_fused_projs": True, "int8_fuse_gn": True}
K11_UNET_FLAGS = {"use_fused_projs": False, "int8_fuse_gn": False}


def _option_runs(mesh=None, nudge: bool = False, scales=None) -> dict:
    """Phase 64's calls with the last int8 options on one rank (``mesh``
    None) or this rank of the mesh: phase 63's serving trainer (the bench's
    int8 pipeline, fused norms) with ``use_fused_projs`` (K8, K9) and
    ``int8_fuse_gn`` (K6) calibrates (its scales kept), then on ``scales``
    (one rank's) where given takes a ``MA_STEPS``-step int8 sample and one
    UNet forward (:func:`_axis_sample`); then the K11 UNet
    (``use_padded_attention`` without fused norms: K11 and K12, filled by
    ``int8_unet_from`` from the same cut masters on the same scales, cut
    first on the mesh) takes a ``MA_STEPS``-step eager ``ddim_sample`` on
    seeded RGB latents from phase 63's initial noise and the same forward.
    Each with its launches and seconds; ``nudge``: also from the inputs
    moved by ``SERVE_NUDGE``."""
    import torch
    from ldmseg_torch.tools.profile_sampling import (PADDED_FLAGS,
                                                     int8_unet_from,
                                                     padded_sample)
    from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
    image, calib, init, _ = _serve_inputs()
    cfg = _serve_config(mesh is not None)
    trainer = TrainerDiffusion(cfg, unet_config=_flagged_unet(
        cfg, **OPTION_FLAGS), mesh=mesh)
    trainer.init_params(seed=0)
    out = {"scales": trainer.calibrate_int8({"image": image}, noise=calib)}
    if scales is not None:
        trainer._int8_act_scales = dict(scales)
    out["int8"] = _axis_sample(trainer, image, init, nudge)
    unet = int8_unet_from(trainer._eval_unet,
                          dict(PADDED_FLAGS, **K11_UNET_FLAGS),
                          scales=trainer._int8_act_scales, mesh=mesh)
    del trainer
    gen = torch.Generator().manual_seed(634)
    rgb = torch.randn((2, 4) + tuple(n // 8 for n in SERVE_HW),
                      generator=gen).cuda().to(torch.bfloat16)

    self_condition = bool(cfg["train_kwargs"].get("self_condition"))

    def sample(noise):
        return padded_sample(unet, rgb, noise.permute(0, 3, 1, 2).cuda().to(
            torch.bfloat16), steps=MA_STEPS, graph=False,
            self_condition=self_condition).float().cpu()
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x0 = sample(init)
    torch.cuda.synchronize()
    out["k11"] = {"x0": x0, "counts": _counts(),
                  "seconds": time.perf_counter() - t0,
                  "forward": _unet_forward(unet)}
    if nudge:
        out["k11"]["nudged_x0"] = sample(_serve_nudge(init))
        out["k11"]["nudged_forward"] = _unet_forward(unet, nudged=True)
    del unet
    torch.cuda.empty_cache()
    return out


def option_report(smi_line: str, one: dict, ranks: list) -> dict:
    """Phase 64's checks and lines of the last int8 options: each rank's
    calibrated scales within ``SERVE_SCALE_RTOL`` of one rank's; the
    forward and x0 of the sample with ``use_fused_projs`` and
    ``int8_fuse_gn`` and of the K11 UNet within phase 63's bound
    (:func:`_serve_within`) of one rank's; the launches: K8 and K9 16 and
    K6 44 a UNet pass, K11 and K12 16 (and K1's wide class once an image
    encode), no fallback."""
    steps = MA_STEPS
    want = {"int8": _expect(K8=16 * steps, K9=16 * steps, K6=44 * steps,
                            K1w=1),
            "k11": _expect(K11=16 * steps, K12=16 * steps)}
    result = {"one_rank": {k: {"counts": one[k]["counts"],
                               "seconds": one[k]["seconds"]} for k in want},
              "ranks": []}
    for who, got in [("one rank", one)] + [(f"rank {i}", r)
                                           for i, r in enumerate(ranks)]:
        for key, expect in want.items():
            check(got[key]["counts"] == expect,
                  f"phase 64 int8 options {who} {key}: launched "
                  f"{got[key]['counts']}, expected {expect}")
    for i, r in enumerate(ranks):
        err = max(abs(v - one["scales"][k]) / abs(one["scales"][k])
                  for k, v in r["scales"].items())
        check(r["scales"].keys() == one["scales"].keys()
              and err <= SERVE_SCALE_RTOL,
              f"phase 64 int8 options rank {i}: calibrate_int8 {err} from "
              f"one rank's (rtol {SERVE_SCALE_RTOL})")
        row = {"scales_err": err, "seconds": r["seconds"]}
        for key in want:
            fe = _errs(r[key], one[key], "forward", "nudged_forward")
            xe = _errs(r[key], one[key], "x0", "nudged_x0")
            row[key] = {"forward_err": fe, "x0_err": xe,
                        "counts": r[key]["counts"],
                        "seconds": r[key]["seconds"]}
            for name, e in (("forward", fe), ("x0", xe)):
                check(_serve_within(e),
                      f"phase 64 int8 options rank {i} {key}: {name} err max "
                      f"{e[0]} mean {e[1]} of max|ref| {e[4]}; one rank's "
                      f"own move for a {SERVE_NUDGE} nudge max {e[2]} mean "
                      f"{e[3]}")
        result["ranks"].append(row)
        print(f"phase 64 int8 options rank {i} (data=1, model=2): "
              + "; ".join(
                  f"{label}: {steps}-step x0 err max "
                  f"{row[key]['x0_err'][0]:.3e}"
                  f" of {row[key]['x0_err'][4]:.3e} (nudge "
                  f"{row[key]['x0_err'][2]:.3e}), forward "
                  f"{row[key]['forward_err'][0]:.3e} of "
                  f"{row[key]['forward_err'][4]:.3e} (nudge "
                  f"{row[key]['forward_err'][2]:.3e}), launches "
                  f"{ {k: v for k, v in row[key]['counts'].items() if v} }, "
                  f"{row[key]['seconds']:.3f} s (one rank "
                  f"{one[key]['seconds']:.3f})"
                  for key, label in (("int8", "use_fused_projs + "
                                              "int8_fuse_gn"),
                                     ("k11", "K11 UNet")))
              + f"; calibrate_int8 within {err:.2e} of one rank's; two gloo "
              f"ranks on ONE card: not a speed [{smi_line}]", flush=True)
    return result


_T0 = time.perf_counter()


def lap(done: str) -> None:
    """The script's wall-clock seconds so far, after ``done``."""
    print(f"[chip_smoke {time.perf_counter() - _T0:.1f} s] {done} done",
          flush=True)


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch missing: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    try:
        import ldmseg_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the ldmseg_torch package is missing: {e}",
              file=sys.stderr)
        return 1
    from ldmseg_torch.utils.precision import strict_fp32
    strict_fp32()

    try:
        name, count, smi_line = phase_device()
        phase_build()
        rows = phase_attention()
        from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
        trainer = TrainerDiffusion(_config())
        trainer.init_params(seed=0)
        unet_result = phase_unet(trainer)
        bf16_counts, sample_result = phase_sample(trainer, smi_line,
                                                  eager_check=True)
        del trainer
        torch.cuda.empty_cache()
        bwd_rows = phase_attention_backward()
        train_counts, train_result = phase_train(smi_line)
        torch.cuda.empty_cache()
        lap("phases 1-6")
        k3_rows, k4_rows, gemm_rows = phase_int8_kernels()
        trainer = TrainerDiffusion(_int8_config())
        trainer.init_params(seed=0)
        int8_unet_result = phase_int8_unet(trainer)
        int8_results = phase_int8_sample(
            trainer, "int8", {"K3": 16, "K4": 16}, smi_line, sample_result,
            calibrate=True, phase=9, calls=2, eager_check=True)
        del trainer
        torch.cuda.empty_cache()
        k13_rows, k12_rows = phase_unfused_kernels()
        variant = {}
        for key, sk, expect, phase in (
                ("a", {"fused_norms": False}, {"K13": 16, "K12": 16}, 12),
                ("b", {"fused_norms": False, "fused_ff": False},
                 {"K13": 16}, 12),
                ("c", {"fused_ff": False}, {"K3": 16}, 13)):
            trainer = TrainerDiffusion(_int8_config(**sk))
            trainer.init_params(seed=0)
            if key == "a":
                unfused_unet_result = phase_unfused_unet(trainer)
            variant[key] = phase_int8_sample(
                trainer, f"int8 ({key}) {sk}", expect, smi_line,
                sample_result, calibrate=key != "c", phase=phase)
            del trainer
            torch.cuda.empty_cache()
        lap("phases 7-13")
        # the GroupNorm + SiLU family: K5, K6, K7
        trainer = _gn_trainer(_config())
        k5_rows, k6_rows, k7_rows, k7_launched = phase_gn_kernels(
            trainer, smi_line)
        k7_repaired = phase_k7_repaired(smi_line)
        gn_unet_result = phase_gn_unet(trainer)
        gn_counts, gn_sample = phase_sample(
            trainer, smi_line, phase=16, expect={"K1": 16, "K5": 44})
        del trainer
        torch.cuda.empty_cache()
        gn_train_counts, gn_train_result = phase_gn_train(smi_line)
        torch.cuda.empty_cache()
        trainer = _gn_trainer(_int8_config())
        gn_int8_unet_result = phase_gn_int8_unet(trainer)
        gn_int8 = phase_int8_sample(
            trainer, "int8 with int8_fuse_gn", {"K3": 16, "K4": 16, "K6": 44},
            smi_line, gn_sample, calibrate=True, phase=18)
        del trainer
        torch.cuda.empty_cache()
        lap("phases 14-18")
        # the padded-attention flags: K8, K9, K11 and the F1 repair
        from ldmseg_torch.tools.profile_sampling import (PADDED_FLAGS,
                                                         int8_unet_from)
        trainer = _projs_trainer()
        padded_rows = phase_padded_kernels(trainer)
        bf16 = trainer.inference_unet()
        projs_unet = _unet_vs_bf16(
            "int8 UNet with fused projs (K8 + K9)", 20, trainer.int8_unet(),
            bf16, {"K8": 16, "K9": 16},
            reference_ms=int8_unet_result["int8_ms"])
        projs = phase_int8_sample(
            trainer, "int8 with fused projs", {"K8": 16, "K9": 16},
            smi_line, sample_result, calibrate=True, phase=21)
        variant_b_unet = _unet_vs_bf16(
            "variant B UNet (fused norms without padded attention: K13 + "
            "K4)", 22, int8_unet_from(trainer.unet, VARIANT_B_FLAGS), bf16,
            {"K13": 16, "K4": 16})
        k11_unet = int8_unet_from(trainer.unet, PADDED_FLAGS)
        k11_unet_result = _unet_vs_bf16(
            "K11 UNet (K11 + K12)", 23, k11_unet, bf16,
            {"K11": 16, "K12": 16})
        k11_counts, k11_sample = phase_padded_sample(k11_unet)
        del trainer, k11_unet, bf16
        torch.cuda.empty_cache()
        lap("phases 19-24")
        # use_packed_attention: K14 (with K2 as its backward), K15; K10
        packed_rows, k10_checked = phase_packed_kernels()
        torch.cuda.empty_cache()
        trainer = _packed_trainer(_config())
        packed_unet = phase_packed_unet(trainer)
        packed_counts, packed_sample = phase_sample(
            trainer, smi_line, phase=26, expect={"K14": 16})
        del trainer
        torch.cuda.empty_cache()
        packed_train_counts, packed_train = phase_packed_train(smi_line)
        torch.cuda.empty_cache()
        trainer = _packed_trainer(_int8_config(fused_norms=False))
        packed_int8_unet = _unet_vs_bf16(
            "int8 UNet (a) with packed attention (K15 + K12)", 28,
            trainer.int8_unet(), trainer.inference_unet(),
            {"K15": 16, "K12": 16})
        packed_int8 = phase_int8_sample(
            trainer, "int8 (a) with packed attention", {"K15": 16, "K12": 16},
            smi_line, packed_sample, calibrate=True, phase=28)
        del trainer
        torch.cuda.empty_cache()
        lap("phases 25-28")
        # use_absorbed_attention: K16 (with K2 in its backward), K17; K18
        absorbed_rows = phase_absorbed_kernels()
        k18_checked = sum(1 for r in absorbed_rows["K18"]
                          if not r.get("fallback"))
        torch.cuda.empty_cache()
        trainer = _absorbed_trainer(_config())
        absorbed_unet = phase_absorbed_unet(trainer)
        absorbed_counts, absorbed_sample = phase_sample(
            trainer, smi_line, phase=31, expect={"K16": 16})
        del trainer
        torch.cuda.empty_cache()
        absorbed_train_counts, absorbed_train = phase_absorbed_train(
            smi_line)
        torch.cuda.empty_cache()
        trainer = _absorbed_trainer(_int8_config(fused_norms=False))
        absorbed_int8_unet, absorbed_int8, absorbed_storage = (
            phase_absorbed_int8(trainer, smi_line, absorbed_sample))
        del trainer
        torch.cuda.empty_cache()
        lap("phases 29-33")
        # the serving path's metric, the entry and the bench line
        pq_result = phase_compute_pq(smi_line)
        lap("phase 34")
        entry_result = phase_entry_bench(smi_line)
        lap("phase 35")
        torch.cuda.empty_cache()
        lifecycle = phase_lifecycle(smi_line)
        lap("phase 36")
        torch.cuda.empty_cache()
        # training, both stages
        ae_train = phase_ae_train(smi_line)
        stage1_to_2 = phase_stage1_to_stage2(smi_line)
        lap("phases 37-38")
        remat_train = phase_remat_train(smi_line)
        train_options = phase_train_options(smi_line)
        lap("phases 39-40")
        torch.cuda.empty_cache()
        # the JAX bench's serving configuration
        k1w_rows, k1w_flips = phase_k1_wide(smi_line)
        lap("phase 41")
        vaes = phase_int8_vaes(smi_line)
        lap("phase 42")
        serving = phase_serving(smi_line, sample_result)
        lap("phases 43-44")
        codec = phase_codec(smi_line)
        lap("phase 45")
        # video and pose
        clip_sample, clip_gt = phase_clip_sample(smi_line)
        lap("phase 46")
        clip_serving = phase_clip_serving(smi_line)
        lap("phase 47")
        clip_train = phase_clip_train(smi_line)
        pose_train = phase_pose_train(smi_line)
        lap("phases 48-49")
        vpq = phase_vpq(smi_line, clip_gt)
        video_cli = phase_video_cli(smi_line)
        lap("phases 50-51")
        # the trained-model gate and the run's tools
        gate = phase_trained_gate(smi_line)
        lap("phase 52")
        loader = phase_loader_bench(smi_line)
        perf_tools = phase_perf_tools(smi_line)
        lap("phases 53-54")
        # conditioning and the UNet surgery
        cond_sample = phase_cond_sample(smi_line)
        cond_int8 = phase_cond_int8(smi_line, cond_sample)
        cond_sample.pop("x0")
        lap("phases 55-56")
        cond_train = phase_cond_train(smi_line)
        cond_surgery = phase_cond_surgery(smi_line)
        lap("phases 57-58")
        # data parallelism: each run in processes of its own
        torch.cuda.empty_cache()
        dp_one, dp_two, dp_dry, dp_seconds = phase_dp(smi_line)
        lap("phases 59-61")
        # the model axis: tensor and spatial parallelism at full width, then
        # serving on it (phase 63: the partial kernels here, the pipeline on
        # phase 62's ranks)
        torch.cuda.empty_cache()
        t63 = time.perf_counter()
        partial_rows = phase_partial_kernels()
        partial_s = time.perf_counter() - t63
        torch.cuda.empty_cache()
        t64 = time.perf_counter()
        axis_rows = phase_axis_kernels()
        axis_kernels_s = time.perf_counter() - t64
        torch.cuda.empty_cache()
        model_axis, serving_axis, attention_axis = phase_model_axis(smi_line)
        attention_axis["seconds"] = (
            axis_kernels_s + attention_axis["one_rank_seconds"]
            + max(attention_axis["rank_seconds"]))
        print(f"phase 64 seconds: {attention_axis['seconds']:.1f} (the "
              f"kernels {axis_kernels_s:.1f}, one rank "
              f"{attention_axis['one_rank_seconds']:.1f}, the ranks "
              f"{max(attention_axis['rank_seconds']):.1f})", flush=True)
        serving_axis["seconds"] = (
            partial_s + serving_axis["one_rank_seconds"]
            + max(serving_axis["rank_seconds"]))
        print(f"phase 63 seconds: {serving_axis['seconds']:.1f} (the "
              f"partial kernels {partial_s:.1f}, one rank "
              f"{serving_axis['one_rank_seconds']:.1f}, the ranks' serving "
              f"{max(serving_axis['rank_seconds']):.1f}"
              f")", flush=True)
        lap("phases 62-64")
        clip_sample.pop("x0")
        sample_result.pop("x0")
        gn_sample.pop("x0")
        packed_sample.pop("x0")
        absorbed_sample.pop("x0")
        print(json.dumps({"results": {
            "device": smi_line, "unet_forward": unet_result,
            "sample_panoptic": sample_result, "train": train_result,
            "int8_unet_forward": int8_unet_result,
            "int8_sample_panoptic": int8_results,
            "unfused_int8_unet_forward": unfused_unet_result,
            "unfused_int8_sample_panoptic": variant,
            "gn_unet_forward": gn_unet_result,
            "gn_sample_panoptic": gn_sample, "gn_train": gn_train_result,
            "gn_int8_unet_forward": gn_int8_unet_result,
            "gn_int8_sample_panoptic": gn_int8,
            "projs_int8_unet_forward": projs_unet,
            "projs_int8_sample_panoptic": projs,
            "variant_b_unet_forward": variant_b_unet,
            "k11_unet_forward": k11_unet_result,
            "k11_ddim_sample": k11_sample,
            "packed_unet_forward": packed_unet,
            "packed_sample_panoptic": packed_sample,
            "packed_train": packed_train,
            "packed_int8_unet_forward": packed_int8_unet,
            "packed_int8_sample_panoptic": packed_int8,
            "absorbed_unet_forward": absorbed_unet,
            "absorbed_sample_panoptic": absorbed_sample,
            "absorbed_train": absorbed_train,
            "absorbed_int8_unet_forward": absorbed_int8_unet,
            "absorbed_int8_sample_panoptic": absorbed_int8,
            "absorbed_storage_unet_forward": absorbed_storage,
            "compute_pq": pq_result, "entry_and_bench": entry_result,
            "lifecycle": lifecycle, "stage1_train": ae_train,
            "stage1_to_stage2": stage1_to_2, "remat_train": remat_train,
            "train_options": train_options, "k1_wide": k1w_rows,
            "int8_vaes": vaes, "serving": serving, "codec": codec,
            "clip_sample": clip_sample, "clip_serving": clip_serving,
            "clip_train": clip_train, "pose_train": pose_train,
            "vpq": vpq, "video_cli": video_cli, "trained_gate": gate,
            "loader_bench": loader, "perf_tools": perf_tools,
            "cond_sample": cond_sample, "cond_int8": cond_int8,
            "cond_train": cond_train, "cond_surgery": cond_surgery,
            "data_parallel": {"one_nccl_rank": dp_one,
                              "two_gloo_ranks": dp_two,
                              "dryrun_multichip": dp_dry,
                              "seconds": dp_seconds},
            "model_axis": model_axis,
            "model_axis_serving": serving_axis,
            "model_axis_partial_kernels": partial_rows,
            "model_axis_attention": attention_axis,
            "model_axis_attention_kernels": axis_rows}}),
            flush=True)
        dyn, cal = (int8_results[k]["counts"]
                    for k in ("default scales", "calibrated"))
        paths = {"sample_panoptic": bf16_counts,
                 f"train_loop, {TIMED_STEPS} steps": train_counts,
                 "sample_panoptic int8, default scales": dyn,
                 "sample_panoptic int8, calibrated scales": cal}
        for key, what in (("a", "fused_norms False"),
                          ("b", "fused_norms and fused_ff False"),
                          ("c", "fused_ff False")):
            for mode, res in variant[key].items():
                paths[f"sample_panoptic int8 {what}, {mode}"] = res["counts"]
        paths["sample_panoptic, use_pallas_gn"] = gn_counts
        paths["train_loop, use_pallas_gn, 3 steps"] = gn_train_counts
        for mode, res in gn_int8.items():
            paths[f"sample_panoptic int8, int8_fuse_gn, {mode}"] = res[
                "counts"]
        for mode, res in projs.items():
            paths[f"sample_panoptic int8, use_fused_projs, {mode}"] = res[
                "counts"]
        paths["UNet forward, variant B flags"] = variant_b_unet["counts"]
        paths["UNet forward, K11 UNet"] = k11_unet_result["counts"]
        paths[f"ddim_sample, K11 UNet, {SAMPLE_STEPS} steps"] = k11_counts
        paths["UNet forward, use_packed_attention"] = packed_unet["counts"]
        paths["sample_panoptic, use_packed_attention"] = packed_counts
        paths[f"train_loop, use_packed_attention, {PACKED_TIMED_STEPS} "
              f"steps"] = packed_train_counts
        paths["UNet forward, int8 (a) with use_packed_attention"] = (
            packed_int8_unet["counts"])
        for mode, res in packed_int8.items():
            paths[f"sample_panoptic int8 fused_norms False, "
                  f"use_packed_attention, {mode}"] = res["counts"]
        paths["UNet forward, use_absorbed_attention"] = (
            absorbed_unet["counts"])
        paths["sample_panoptic, use_absorbed_attention"] = absorbed_counts
        paths[f"train_loop, use_absorbed_attention, {ABSORBED_TIMED_STEPS} "
              f"steps"] = absorbed_train_counts
        paths["UNet forward, int8 (a) with use_absorbed_attention"] = (
            absorbed_int8_unet["counts"])
        for mode, res in absorbed_int8.items():
            paths[f"sample_panoptic int8 fused_norms False, "
                  f"use_absorbed_attention, {mode}"] = res["counts"]
        paths["UNet forward, int8 (a), absorbed storage"] = (
            absorbed_storage["counts"])
        for branch, res in pq_result.items():
            if isinstance(res, dict):
                paths[f"compute_pq, {branch}, {res['calls']} calls"] = (
                    res["counts"])
        paths["tools/bench.py at batch 2: 23 entry forwards, 2 bf16, 2 "
              "int8 and 2 DPM sample_panoptic calls"] = entry_result["counts"]
        paths[f"main_ldm: {LIFECYCLE_STEPS} train steps, compute_pq "
              f"({LIFECYCLE_PQ_STEPS} DDIM steps)"] = lifecycle["counts"]
        paths[f"TrainerAE.train_loop, {AE_TIMED} steps"] = ae_train[
            "counts"]
        paths["main_ldm on main_ae's export: 2 train steps, compute_pq (2 "
              "DDIM steps)"] = stage1_to_2["counts"]
        paths[f"train_loop with gradient_checkpointing, {REMAT_TIMED} "
              f"steps"] = remat_train["counts"]
        paths["ImageVAE.encode, int8 with fused attention, batch 2"] = (
            vaes["image_encode"]["counts"])
        tail, dpm_tail = _refine_steps(SAMPLE_STEPS), _refine_steps(DPM_STEPS)
        for sampler, what in (("ddim", f"{SAMPLE_STEPS} DDIM steps"),
                              ("dpmpp_2m", f"{DPM_STEPS} DPM-Solver++(2M) "
                                           f"steps")):
            paths[f"sample_panoptic, the JAX bench's serving configuration, "
                  f"{what}"] = serving[sampler]["default scales"]["counts"]
        paths[f"sample_panoptic_clip, bf16, 1 clip of 3 frames: DDIM "
              f"{SAMPLE_STEPS} + a {tail}-step DDIM tail"] = clip_sample[
                  "counts"]
        for sampler, what in (("ddim", f"DDIM {SAMPLE_STEPS} + a {tail}-step "
                                       f"DDIM tail"),
                              ("dpmpp_2m", f"DPM-Solver++(2M) {DPM_STEPS} + a "
                                           f"{dpm_tail}-step DDIM tail")):
            paths[f"sample_panoptic_clip, the JAX bench's serving "
                  f"configuration, {what}"] = clip_serving[sampler]["counts"]
        paths["train_loop on 2 clips of 3 frames with the consistency "
              "term, 2 steps"] = clip_train["counts"]
        paths["main_ldm video_clips=3: 2 train steps, compute_pq (2 DDIM "
              "steps)"] = video_cli["counts"]
        paths["predict clips=3: 2 clips, 2 DDIM steps + a 1-step tail"] = (
            video_cli["predict_counts"])
        paths[f"trained_gate at {GATE_STEPS} steps, 1 val batch"] = gate[
            "counts"]
        paths[f"sample_panoptic with a context, bf16, CFG 7.5 (2 UNet calls "
              f"a step), {SAMPLE_STEPS} DDIM steps"] = cond_sample["counts"]
        paths["sample_panoptic with a context, bf16, guidance 1.0"] = (
            cond_sample["guidance_1"]["counts"])
        paths[f"sample_panoptic_clip with a context, bf16, CFG 7.5, DDIM "
              f"{SAMPLE_STEPS} + a {tail}-step tail"] = cond_sample[
                  "clip_counts"]
        paths["sample_panoptic with a context, int8 fused norms, CFG 7.5"] = (
            cond_int8["counts"])
        paths[f"train_loop, learnable queries + separate_encoder + "
              f"add_adaptor, {COND_TIMED} steps"] = cond_train["counts"]
        paths["one NCCL rank (torchrun variables): a stage-2 step with "
              "ZeRO-1"] = dp_one["counts"]
        paths[f"two gloo ranks sharing the card, rank 0: a stage-2 step "
              f"with ZeRO-1 ({DP_ROWS} rows), compute_pq ({DP_PQ_STEPS} DDIM "
              f"steps, 2 frames)"] = dp_two["counts"]
        paths[f"dryrun_multichip({DRY_RANKS}, cuda), rank 0: stages "
              f"A-D"] = _expect(K1=dp_dry["launches"]["K1"],
                                K2=dp_dry["launches"]["K2"])
        for rank, counts in enumerate(model_axis["counts"]):
            paths[f"model axis (data=1, model=2), rank {rank}: a TP + SP "
                  f"+ ZeRO-1 step (batch {MA_BATCH}), a {MA_STEPS}-step bf16 "
                  f"sample_panoptic"] = _expect(**counts)
        for key, runs in serving_axis["runs"].items():
            for rank, run in enumerate(runs):
                paths[f"model axis (data=1, model=2), rank {rank}: the "
                      f"bench's serving pipeline, {key}, a {SERVE_STEPS}-step"
                      f" sample_panoptic"] = run["counts"]
        for rank, row in enumerate(attention_axis["int8_options"]["ranks"]):
            for what, label in (("int8", "use_fused_projs + int8_fuse_gn, a "
                                         f"{MA_STEPS}-step int8 "
                                         "sample_panoptic"),
                                ("k11", f"the K11 UNet, a {MA_STEPS}-step "
                                        "ddim_sample")):
                paths[f"model axis (data=1, model=2), rank {rank}, "
                      f"{label}"] = row[what]["counts"]
        for flag, res in attention_axis.items():
            if flag not in AXIS_FLAGS:
                continue
            for rank, row in enumerate(res["ranks"]):
                for what, counts in row["counts"].items():
                    paths[f"model axis (data=1, model=2), rank {rank}, "
                          f"{AXIS_FLAGS[flag][0]}: "
                          + {"step": f"a TP + SP + ZeRO-1 step (batch "
                                     f"{MA_BATCH} of {SERVE_HW[0]}x"
                                     f"{SERVE_HW[1]})",
                             "bf16": f"a {MA_STEPS}-step bf16 "
                                     f"sample_panoptic",
                             "int8": f"a {MA_STEPS}-step int8 "
                                     f"sample_panoptic, fused_norms False"}[
                                what]] = counts

        def by_path(kid):
            return {path: counts[kid] for path, counts in paths.items()}
        unfused = variant["a"]["default scales"]["counts"]
        print(f"chip_smoke: {time.perf_counter() - _T0:.1f} s in all",
              flush=True)
        print(json.dumps({"kernels": [
            k1_entry(rows, bf16_counts["K1"], by_path("K1")),
            k1_wide_entry(
                k1w_rows,
                serving["ddim"]["default scales"]["counts"]["K1w"],
                by_path("K1w"), k1w_flips),
            k2_entry(bwd_rows, train_counts["K2"], by_path("K2")),
            int8_entry("attention_ln_s8", "K3",
                       "ldmseg_torch/csrc/attention_ln_s8.cu",
                       "ldmseg_tpu/ops/pallas/attention.py:845",
                       "ldmseg_tpu/ops/pallas/attention.py:"
                       "_attn_kernel_abs_padded_ln_s8_vt",
                       k3_rows, dyn["K3"], by_path("K3"))
            | products_entry(gemm_rows, "K3")
            | {"model_axis_partial": partial_rows["K3"]},
            int8_entry("geglu_ln_s8", "K4",
                       "ldmseg_torch/csrc/geglu_ln_s8.cu",
                       "ldmseg_tpu/ops/pallas/geglu.py:164",
                       "ldmseg_tpu/ops/pallas/geglu.py:_geglu_ln_kernel",
                       k4_rows, dyn["K4"], by_path("K4"))
            | products_entry(gemm_rows, "K4")
            | {"model_axis_partial": partial_rows["K4"]},
            int8_entry("attention_ln_s8_pin", "K8",
                       "ldmseg_torch/csrc/attention_ln_s8.cu",
                       "ldmseg_tpu/ops/pallas/attention.py:875",
                       "ldmseg_tpu/ops/pallas/attention.py:"
                       "_attn_kernel_abs_padded_ln_s8_vt_pin",
                       padded_rows["K8"],
                       projs["default scales"]["counts"]["K8"],
                       by_path("K8"))
            | axis_entry(axis_rows, attention_axis, "K8"),
            int8_entry("geglu_ln_s8_pout", "K9",
                       "ldmseg_torch/csrc/geglu_ln_s8.cu",
                       "ldmseg_tpu/ops/pallas/geglu.py:186",
                       "ldmseg_tpu/ops/pallas/geglu.py:_geglu_ln_pout_kernel",
                       padded_rows["K9"],
                       projs["default scales"]["counts"]["K9"],
                       by_path("K9"))
            | {"redesigned": "proj_out on csrc/gemm_sm90.cuh (bf16, "
                             "operands swapped: Wpo r^T, stored "
                             "channel-major)",
               "proj_out_linear_device_ms": _per_forward(
                   padded_rows["K9"], "proj_out_linear_device_ms")}
            | axis_entry(axis_rows, attention_axis, "K9"),
            int8_entry("attention_padded_s8", "K11",
                       "ldmseg_torch/csrc/attention_s8.cu",
                       "ldmseg_tpu/ops/pallas/attention.py:646",
                       "ldmseg_tpu/ops/pallas/attention.py:"
                       "_attn_kernel_abs_padded_s8",
                       padded_rows["K11"], k11_counts["K11"],
                       by_path("K11"))
            | S8PV_REDESIGN | axis_entry(axis_rows, attention_axis, "K11"),
            int8_entry("geglu_s8", "K12",
                       "ldmseg_torch/csrc/geglu_ln_s8.cu",
                       "ldmseg_tpu/ops/pallas/geglu.py:123",
                       "ldmseg_tpu/ops/pallas/geglu.py:_geglu_kernel",
                       k12_rows, unfused["K12"], by_path("K12"))
            | {"model_axis_partial": partial_rows["K12"]},
            int8_entry("attention_s8", "K13",
                       "ldmseg_torch/csrc/attention_s8.cu",
                       "ldmseg_tpu/ops/pallas/attention.py:47",
                       "ldmseg_tpu/ops/pallas/attention.py:_attn_kernel_s8",
                       k13_rows, unfused["K13"], by_path("K13"))
            | {"model_axis_partial": partial_rows["K13"]}
            | S8PV_REDESIGN,
            gn_entry("group_norm_silu", "K5",
                     "ldmseg_torch/csrc/groupnorm_silu.cu",
                     "ldmseg_tpu/ops/pallas/groupnorm_silu.py:52",
                     "ldmseg_tpu/ops/pallas/groupnorm_silu.py:"
                     "_gn_silu_kernel",
                     [r for r in k5_rows if r["path"] == "sampling"],
                     gn_counts["K5"], by_path("K5"),
                     "one UNet forward (44 launches, bf16, batch 2, 32x64 "
                     "latent); the training shapes' rows in training_shapes")
            | {"training_shapes": [r for r in k5_rows
                                   if r["path"] == "training"]},
            gn_entry("group_norm_silu_quant", "K6",
                     "ldmseg_torch/csrc/groupnorm_silu.cu",
                     "ldmseg_tpu/ops/pallas/groupnorm_silu.py:151",
                     "ldmseg_tpu/ops/pallas/groupnorm_silu.py:"
                     "_gn_silu_quant_kernel", k6_rows,
                     gn_int8["default scales"]["counts"]["K6"],
                     by_path("K6"),
                     "one int8 UNet forward (44 launches, bf16 in, batch 2, "
                     "32x64 latent)")
            | axis_entry(axis_rows, attention_axis, "K6"),
            gn_entry("gn_silu_conv", "K7",
                     "ldmseg_torch/csrc/gn_silu_conv.cu",
                     "ldmseg_tpu/ops/pallas/gn_silu_conv.py:30",
                     "ldmseg_tpu/ops/pallas/gn_silu_conv.py:_kernel",
                     [r for r in k7_rows if not r["fallback"]], 0,
                     by_path("K7"),
                     "the 43 resnet halves of one UNet forward that it takes"
                     " (bf16, batch 2, 32x64 latent; one falls back by the "
                     "6 MiB rule); no module routes to it, so 0 launches on "
                     "every path and 47 checked in phase 14 (the 43 "
                     "halves, 2 at each repaired shape)")
            | {"redesigned": "GN + SiLU into a padded channel-last scratch "
                             "(a cluster per (image, group)), the 3x3 conv "
                             "as one product on csrc/gemm_sm90.cuh over nine"
                             " shifted taps, split-K at the deep levels",
               "levels": k7_levels([r for r in k7_rows
                                    if not r["fallback"]]),
               "repaired_shapes": k7_repaired,
               "launches_in_its_phase": k7_launched + sum(
                   r["launches"] for r in k7_repaired)},
            k14_entry(packed_rows, packed_counts["K14"], by_path("K14"))
            | axis_entry(axis_rows, attention_axis, "K14"),
            int8_entry("attention_packed_s8", "K15",
                       "ldmseg_torch/csrc/attention_s8.cu",
                       "ldmseg_tpu/ops/pallas/attention.py:142",
                       "ldmseg_tpu/ops/pallas/attention.py:"
                       "_attn_kernel_btc_s8", packed_rows["K15"],
                       packed_int8["default scales"]["counts"]["K15"],
                       by_path("K15"))
            | S8PV_REDESIGN | axis_entry(axis_rows, attention_axis, "K15"),
            int8_entry("attention_ln_s8_rowmajor (v_bf16=True)", "K10",
                       "ldmseg_torch/csrc/attention_ln_s8.cu",
                       "ldmseg_tpu/ops/pallas/attention.py:716",
                       "ldmseg_tpu/ops/pallas/attention.py:"
                       "_attn_kernel_abs_padded_ln_s8",
                       packed_rows["K10 v_bf16"], 0, by_path("K10"))
            | {"variant": "v_bf16=True",
               "launches_in_its_phase": k10_checked // 2,
               "launches_note": "an op: no module routes to it, so 0 "
                                "launches on every path"},
            int8_entry("attention_ln_padded_s8 (v_bf16=False)", "K10",
                       "ldmseg_torch/csrc/attention_s8.cu",
                       "ldmseg_tpu/ops/pallas/attention.py:716",
                       "ldmseg_tpu/ops/pallas/attention.py:"
                       "_attn_kernel_abs_padded_ln_s8",
                       packed_rows["K10 s8"], 0, by_path("K10"))
            | S8PV_REDESIGN
            | {"variant": "v_bf16=False",
               "launches_in_its_phase": k10_checked // 2,
               "launches_note": "an op: no module routes to it, so 0 "
                                "launches on every path"},
            k16_entry(absorbed_rows, absorbed_counts["K16"], by_path("K16"))
            | axis_entry(axis_rows, attention_axis, "K16"),
            int8_entry("attention_absorbed_s8", "K17",
                       "ldmseg_torch/csrc/attention_s8.cu",
                       "ldmseg_tpu/ops/pallas/attention.py:360",
                       "ldmseg_tpu/ops/pallas/attention.py:"
                       "_attn_kernel_absorbed_s8", absorbed_rows["K17"],
                       absorbed_int8["default scales"]["counts"]["K17"],
                       by_path("K17"))
            | S8PV_REDESIGN | axis_entry(axis_rows, attention_axis, "K17"),
            int8_entry("attention_absorbed_fullc_s8", "K18",
                       "ldmseg_torch/csrc/attention_s8.cu",
                       "ldmseg_tpu/ops/pallas/attention.py:500",
                       "ldmseg_tpu/ops/pallas/attention.py:"
                       "_attn_kernel_absorbed_fullc_s8",
                       absorbed_rows["K18"], 0, by_path("K18"))
            | S8PV_REDESIGN
            | {"launches_in_its_phase": k18_checked,
               "launches_note": "an op: no module routes to it, so 0 "
                                "launches on every path"},
        ]}), flush=True)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
