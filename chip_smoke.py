#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bio_image_unet_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each announced by a ``[phase] <name>`` line before it starts and
printing its own lines; any failure raises and the script exits non-zero
without printing a result:

1. device — the card's name and power limit (``nvidia-smi``);
2. build  — every kernel of ``bio_image_unet_tpu_torch/csrc`` compiled by nvcc
   for sm_90a (one nvcc per source, all started together), with the ptxas
   register / shared-memory summary (a ``qconv`` instance that spills to
   local memory fails the run); then ``[sass]``: ``cuobjdump -sass`` of the
   int8 library, each ``qconv`` instance's tensor-core (IMMA / GMMA),
   ``ldmatrix`` (LDSM), ``cp.async`` (LDGSTS) and store counts logged, and
   the run failed where an instance has no tensor-core MMA or any ``__dp4a``
   (IDP); and of K9 (``requant``), K10 (``maxpool_i8``), K11
   (``upsample2x_i8``) and K11v (``upsample2x_i8_3d``, the resample
   library), K6 (``xcorr``, the depthwise_xcorr library) and K6b
   (``xcorr_grad_input``, ``xcorr_grad_kernel`` and their plane forms), K3
   (``sigmoid_stitch``), K5 / K5v / K5s (``margin_stitch``,
   ``blend_stitch_3d``, ``tile_sum``), K1 (``clip_pass``) and K2 / K2h / K2v
   (``normalize_tile``), each instance's
   int↔float conversions (I2F, F2I,
   FRND), MUFU, FFMA / FMUL / FADD and 128-bit global loads and stores and
   shared loads logged, the run failed where one uses local memory (LDL /
   STL), a K6 or K6b instance holds an FFMA or a K11v instance converts
   between int and float;
3. kernels — each kernel held against its plain PyTorch version on the card
   at the shapes the main path gives it (K1 / K1f bit-equal, K2 equal, K3
   within one uint8 level; K3 also on the float32 logits of 512² tiles that
   ``Predict`` makes at its defaults; K1 and K2 also on frames of microscopy
   statistics, most pixels on a few background levels, in uint8 and its
   uint16 and float32 twins), and timed with CUDA events (L2 flushed before
   every launch) beside its least possible time and, where one PyTorch call
   computes the same function, that call's time;
4. main path — ``Predict`` on a random-weight ``Unet(n_filter=32)`` checkpoint
   (seeded ``torch.Generator``, non-trivial BatchNorm statistics): the
   64×1024² uint8 bf16 movie of ``bench.py``, an overlapping uint16 case, a
   float32 case and a ``'first'`` case.  The kernels' launch counts are set
   to 0 just before and read just after; every kernel must have launched.
   Each result is held against the port's host-staged path
   (``device_pipeline=False``), and a small float32 ``Predict`` on the card
   against the same on the CPU (``Unet(8)``, and ``Unet(8, dilation=2)``).
   Prints the end-to-end and device-resident MP/s (the definitions of
   ``bench.py``);
5. kernels (training) — K4, the gather and augmentation of a training batch,
   held against its plain version at the training shapes (12 tiles of 256²
   gathered from a 120-tile resident set: mask bit-equal, image within one
   float32 ulp) and timed beside its byte bound;
6. train — the second main path, through the ``unet`` facade a user calls:
   ``DataProcess`` on 150 blob frames of 256² (``utils.synth``), then
   ``Trainer`` at the full width of ``benchmarks/train_bench.py``
   (``Unet(n_filter=32)``, batch 12, lr 1e-4, BCEDice, bf16,
   ``device_cache=True``, ``device_augment=True``) for 3 epochs of 10 steps.
   The launch counts are set to 0 just before and read just after: K4 must
   have launched once per step.  Prints the per-epoch losses, patches/s
   (``train_bench.py``'s definition: steps·batch over the best training
   epoch's wall time), step time, peak device memory and the implied share
   of the card's bf16 peak; the last epoch's train loss must be below the
   first's.  Then one profiled epoch (device time by stage, idle share), the
   trained ``.pt`` through ``Predict`` on a 16-frame blob movie (mask IoU
   against the blob truth), and a small float32 training run on the card
   against the same on the CPU (``metrics.csv`` rows within rtol 1e-3);
6b. checkpoints — ``[train]``'s trained ``Unet(32)`` ``.pt`` through
   ``checkpoint.load`` → ``checkpoint.save_native`` (the JAX package's
   ``BIUTPU01`` format, with the Adam state) → ``load``: every tensor
   bit-equal, the Adam moments and step too, ``peek`` equal to the header;
   then ``Predict`` on
   the main movie (64×1024² uint8, 256², bf16, fused) from the ``.ckpt`` and
   from the ``.pt``: masks byte-equal, launches exact around each call (K1,
   K2 and K3 4 each, nothing else); prints the end-to-end MP/s, the engine
   set-up seconds (the checkpoint's decode is in it), the decode alone and
   the file sizes of both;
6c. train resume — ``[train]``'s configuration (``Unet(32)``, batch 12, bf16,
   K4) for 2 epochs with ``save_name="model.ckpt"``, then one epoch resumed
   from that ``model.ckpt`` and one from the same state written as ``.pt``:
   the two resumed optimizers hold bit-equal Adam moments, their
   ``metrics.csv`` rows agree within rtol 1e-3, each resumed epoch's loss is
   below the first run's first epoch's; K4 exactly once a step;
6d. train options — one epoch of that configuration with ``remat=True`` and
   one with ``remat=False`` from the same seed (``metrics.csv`` rows within
   rtol 1e-3; peak memory and step time of both, a second training pass of
   each timed alone and a profiled remat epoch by stage, no gate), then one with
   ``profile_dir=`` outside every other profiler: one Chrome trace JSON,
   which parses and holds K4's kernel once a step and a convolution kernel
   (each step's ``augment`` range logged with the launches it holds and the
   K4 kernel they reached); K4 exactly once a step in each run;
7. kernels (heads) — K2h (float tiles), K5 (safe-margin stitch, float16
   and float32 out) and K5s (the tile sum of the fill) against their plain
   versions at the multi-head path's shapes (a 16-frame chunk of 1024² uint8
   frames in 512² tiles, heads of 1 and 2 channels): K2h equal, K5
   bit-equal, K5s's sum equal and its fill within one float16 ulp; timed
   beside their byte bounds and, for K5, ``F.fold`` of the weighted tiles;
8. heads — the third main path, ``PredictMultiOutput`` at the full width of
   ``benchmarks/family_bench.py``'s multi-output configuration:
   ``MultiOutputNestedUNet(n_filter=32)`` with its two heads (``mask``: 1
   channel, sigmoid; ``orientation``: 2 channels, none), 512² patches,
   bf16, ``safe_margin=20``, on a 40-frame 1024² uint8 movie (two 16-frame
   chunks and a tail of 8).  Around each call on that movie, fused and
   host-staged, the launch counts are set to 0 just before and read just
   after, and must be exactly what the path launches (fused, per chunk: K1's
   uint8 launches, K2h once, K5 and K5s once per head; host-staged: K5
   and K5s).
   Prints end-to-end MP/s (best of two after a warm-up), device-resident
   MP/s, peak device memory, the implied share of the bf16 dense peak and a
   profiled pass by stage; holds the fused path against the host-staged one
   at the same forward batch within atol 2e-3 on every pixel, fill included,
   in bf16 on the whole movie and in float32 on 16 frames; holds the
   device-resident program equal to its ``PredictMultiOutput`` call; covers
   ``MultiOutputUnet(n_filter=32)`` on an overlapping uint16 1000² movie and
   a float32 ``'first'`` movie with a reflect-padded axis; and holds a small
   float32 ``PredictMultiOutput`` (``n_filter=4``) on the card against the
   CPU (``|card − CPU| ≤ 1e-3 + 1e-3·|CPU|``);
9. kernels (heads training) — K4h, the multi-head gather and augmentation,
   held against its plain version at the shapes of the multi-output
   training path (4 of 64 resident 256² tiles, image 1 channel, targets
   1 + 2 channels, every (k, flip_h, flip_v) case forced once): targets
   bit-equal (zeros by value), image within one float32 ulp; timed beside
   its byte bound;
10. train heads — the fourth main path, through the ``multi_output_unet``
   facade a user calls: ``DataProcess`` on 40 blob frames of 256² with a
   mask and an orientation-angle target (NaN where the angle is undefined),
   ``aug_factor=2`` (80 tiles: 16 steps of 4 per epoch), then ``Trainer`` at
   ``benchmarks/family_bench.py``'s training configuration
   (``MultiOutputNestedUNet(n_filter=32)``, its two heads with their
   losses, batch 4, lr 1e-4, bf16, ``device_cache=True``,
   ``device_augment=True``, the facade's ``grad_clip=1.0``) for 3 epochs.
   The launch counts are set to 0 just before and read just after: K4h
   must have launched once per step and nothing else at all.  Prints the
   per-epoch losses (the last epoch's train loss must be below the
   first's), patches/s (``family_bench.py``'s definition), step time, peak
   device memory, the implied share of the bf16 dense peak and one profiled
   epoch by stage; then one epoch of ``MultiOutputNestedUNet_3Levels`` with
   deep supervision through ``PredictMultiOutput``, the trained ``.pt``
   through ``PredictMultiOutput`` on a 16-frame blob movie (mask IoU against
   the truth), and a small float32 training run on the card against the
   same on the CPU (``metrics.csv`` rows within rtol 1e-3);
11. kernels (3d) — K2v (a volume's normalize and 3-axis tiles, uint8 and
   bf16 modes), K3v (sigmoid·255 and the volume's mean stitch) and K5v (the
   multi-head linear-blend stitch, float16 and float32 out) against their
   plain versions at the 3D paths' shapes (K2v equal, K3v within one uint8
   level, K5v bit-equal), timed beside their byte bounds; and K1 on one
   whole volume (a 16.7 M-voxel uint8 row and a 67 M-voxel uint16 row)
   bit-equal to its plain version;
12. 3d — the fifth main path, ``Predict3D`` at
   ``benchmarks/family_bench.py``'s 3D configuration: ``UNet3D(n_filter=32)``
   (seeded, with BatchNorm statistics) on a 64×512² uint8 volume, tiles
   (32, 128, 128), bf16, ``batch_size=4`` (forward batch 16).  Around each
   call the launch counts are set to 0 just before and read just after, and
   must be exactly K1's uint8 launches, K2v once, K3v once.  Prints the
   end-to-end and device-resident Mvox/s, peak device memory, the implied
   share of the bf16 dense peak (``unet3d_forward_flops``) and a profiled
   pass by stage; holds fused against host-staged at the same forward batch
   and a small float32 ``Predict3D`` on the card against the CPU within the
   uint8 contract; covers the trilinear decoder and uint16 with
   ``add_patch=1``;
13. 3d heads — the sixth main path, ``PredictMultiOutput3D`` on
   ``MultiOutputUnet3D(n_filter=32)`` (nearest decoder, heads ``mask``: 1
   channel, sigmoid; ``vec``: 2 channels, none) over 2 uint8 volumes of
   64×512², the class defaults (tiles (64, 256, 256), ``overlap_factor=0.1``,
   ``blend_margin=16``, ``batch_size=2``), bf16.  Launch counts exact around
   each call (K1 2, K2v 1, K5v once per head); the same prints; fused
   against host-staged at the same forward batch within 2e-3 + 1e-3·|host|;
   a small float32 case on the card against the CPU;
14. kernels (3d training) — K4v, the gather and augmentation of a batch of
   volumes, at the 3D training path's shapes (4 of 40 resident
   (1, 16, 64, 64) volumes) and K4hv, its multi-head form, at the coverage
   path's (2 of 16 resident volumes of (32, 128, 128), targets mask +
   orientation), against their plain versions with every (k, flip_h,
   flip_v) case forced once and a sample gated off: targets bit-equal,
   image within one float32 ulp; timed beside their byte bounds;
15. train 3d — the seventh main path, ``benchmarks/family_bench.py``'s 3D
   training through the ``unet3d`` facade: ``UNet3D(n_filter=32)``
   (transposed-conv decoder, the facade's ``time_loss_weight=0.1``) on 40
   resident volumes of (16, 64, 64), batch 4, bf16, ``val_split=0``,
   ``device_augment=True``, a warm-up epoch and 3 timed ones.  The launch
   counts are set to 0 just before ``Trainer.start()`` and read just after:
   K4v exactly once per step, nothing else.  Prints volumes/s (the best
   timed epoch, ``family_bench.py``'s definition), step time, peak device
   memory, the share of the bf16 dense peak and a profiled epoch (device
   busy time by stage, idle share).  Then the coverage path: the
   ``multi_output_unet3d`` facade on ``MultiOutputUnet3D(n_filter=32)``
   (its ``use_interpolation=False``), mask and orientation heads with the
   3D head losses, 16 resident volumes of (32, 128, 128), batch 2, bf16,
   3 epochs, K4hv exactly once per step; each trained ``.pt`` through
   ``Predict3D`` / ``PredictMultiOutput3D`` on the card with K1, K2v and
   K3v / K5v launched exactly as those paths launch them; and a small
   float32 ``UNet3D`` training run on the card against the CPU
   (``metrics.csv`` rows within rtol 1e-3);
16. kernels (siam) — K1 per frame on the main path's uint8 (9, 1024²) chunk
   block and its pair-row form (the block read in place as 8 rows of
   2·1024²): bit-equal; K2p (the pair normalize and both tile sets: that
   block in 256² tiles, and a zero-padded 200×300 block with invert: equal);
   K3 on the main path's 128 bf16 logit tiles → 8 frames (within one level);
   K6 (the depthwise cross-correlation of the ``corr`` join at (128, 256,
   16, 16) bf16 channels_last, at ``PredictSiam``'s float32 defaults (32,
   256, 32, 32) and at (16, 1024, 32, 32) float32, a timing shape no path
   runs (its row reports 0 launches): bit-equal, and within 1e-5 of Σ|a·b|
   in float32, one bf16 ulp in bf16; its plane form, for planes above 112²,
   bit-equal at (2, 4, 128, 128)).  Each against its plain version, timed
   beside its bound (operations at the card's rate for the operand type:
   bf16 on the tensor cores, float32 on the CUDA cores) and, for K6, the
   grouped ``F.conv2d``;
17. siam — the eighth main path, the ``siam_unet`` facade's streaming
   ``Predict`` at ``benchmarks/family_bench.py``'s Siam configuration:
   ``Siam_UNet(n_filter=32, mode="max")`` (seeded, with BatchNorm
   statistics), 256² tiles, bf16, ``'single'``, a 32-frame uint8 1024² TIFF
   in and a TIFF out.  Launch counts exact around each call (per 8-frame
   chunk: K1 2, K2p 1, K3 1; K6 once a forward batch under ``corr``; K1's
   pair form under ``'all'``).  Prints end-to-end MP/s (best of two after a
   warm-up), device-resident MP/s (``_Engine.pairs_runner`` on a 17-frame
   block on the card, equal to the call's first two chunks), peak memory,
   the share of the bf16 dense peak, a profile by stage with the idle share,
   and the host time by stage (page decode, upload, dispatch, wait, TIFF
   write).  Holds fused against host-staged at the same forward batch on the
   main movie and on each coverage case (the ``corr``, ``concat`` and
   ``control`` joins, ``corr`` in float32 at ``PredictSiam``'s default 512²
   tiles (``Siam_UNet(32, "corr")``, 16 frames: K6 on (32, 256, 32, 32)
   float32 NCHW, its launches exact), ``'first'``, ``'all'``, uint16 with
   ``add_tile=1``, a 37-frame 200×300 movie, a 1-frame movie,
   ``frames_per_chunk=1``, float32 with ``device_pipeline=True``), and a
   small float32 run on the card against the CPU;
18. kernels (siam training) — K6 at the Siam trainer's forward shape and
   K6b, K6's backward (grad input: g correlated with the flipped kernel, the
   padding swapped; grad kernel: a reduction over the plane for each tap;
   both on K6's tiles, their staging logged), at config 3's training batch
   ((12, 256, 16, 16) bf16 channels_last), the ``siam_unet`` facade's
   float32 batch 4, an odd kernel (15²) and a plane
   larger than its kernel (32² with 16²): each bit-equal to its plain
   version (so within 1e-5 of the sum of |a·b| in float32, one ulp in bf16),
   timed beside its bound and beside the autograd backward of one grouped
   ``F.conv2d`` on the same operands;
19. train siam — the ninth main path, config 3's training leg
   (``benchmarks/family_bench.py:262-290``) through the ``siam_unet``
   facade: ``DataProcess`` on 120 W-doubled blob pairs of 256², then
   ``Trainer`` (``Siam_UNet(32)``, batch 12, lr 1e-4, ``val_split=0``, bf16,
   ``device_cache=True``, ``device_augment=True``) for 3 epochs of 10 steps,
   in the ``max`` join (the config's own) and in ``corr``.  Launch counts
   exact around each run: K4's pair form once a step, and under ``corr`` K6,
   K6b grad input and K6b grad kernel once a step each (``max``: none).
   Prints the losses (the last epoch's below the first's), patches/s (best
   epoch after the first), step time, peak memory, a profiled epoch (device
   busy, idle share, K6/K6b's device time); the trained ``model.ckpt``
   through ``PredictSiam`` on the card (mask IoU on blob frames), and a
   small float32 ``corr`` run on the card against the CPU (``metrics.csv``
   rows within rtol 1e-3);
20. kernels (int8) — K7 (the int8 3×3 conv with its dequant, bias,
   LeakyReLU and requant epilogue) at the main path's first and widest
   layers (``encode2`` (256, 256², 32) → 32 and ``middle_conv2`` (256, 16²,
   512) → 512) and at ``decode7`` (256, 256², 64) → 32, whose input is the
   concat buffer, K8 (the 2×2 stride-2 int8 transposed conv into the concat
   buffer's first half) at every decoder level, K9 in its three forms (the
   first conv's bf16 output → int8, a skip into the concat buffer's second
   half, the same on a skip holding all 256 int8 values at scales that make
   exact .5 ties, the dequant to bf16 before the head) and in the two that
   ``AttentionUnet``'s gated decoder adds (the dequant of the up path from
   channels [32, 64) of the concat buffer, a strided read, and the float32
   attended skip → int8 into channels [0, 32)) and K10 (the int8 max pool) at
   every encoder level, on a forward batch of 256 tiles: each bit-equal to
   its plain version, timed beside its bound (int8 operations at the
   tensor cores' 1979 TOP/s, or bytes) and, for K10, ``amax`` over each 2×2
   window of a view (held equal to the kernel's output), for K7 / K8, ``torch._int_mm``
   on the same operands (an ``F.unfold`` im2col for K7; the bf16 cuDNN conv
   of the layer logged beside it), with each K7 / K8 row's TOP/s, its share
   of the int8 dense peak and of its bound and its time over
   ``torch._int_mm``'s;
21. int8 — ``Predict(quantized=True)`` on the main movie (``Unet(32)``,
   64×1024² uint8, 256², bf16): launches exact around the call (per
   16-frame chunk, one forward batch: K7 17, K8 4, K9 6, K10 4, beside K1's
   two, K2 and K3, and the calibration's K1 and K2h on its two sampled
   frames: the calibration cuts its tiles on the card); the host split of
   the best int8 and bf16 calls (calibration seconds against the rest, by
   stage); end-to-end and device-resident MP/s of int8 and bf16 back
   to back and their ratio, the int8 trunk's TOP/s and share of the int8
   dense peak, the peak device memory of the device-resident passes (the
   counter reset first) and of one int8 and one bf16 ``Predict`` call, a
   profile by stage and by ``qconv`` instance; a BN-warmed
   ``Unet(32)`` within the JAX package's int8 contract of bf16 (at most 4 levels, a mean under 0.5,
   under 1% of pixels beyond one level); the trained ``.pt`` of ``[train]``:
   mask IoU within 0.01 of bf16's, and a calibration broken on purpose must
   miss that gate; ``PredictMultiOutput(quantized=True)`` on a BN-warmed
   ``MultiOutputUnet(32)`` (K5 and K5s once a head; heads within 6% of
   their range, mean 1%) and
   ``siam_unet.Predict(quantized=True)`` on BN-warmed ``Siam_UNet(32)`` in
   the ``max``, ``control`` and ``concat`` joins over 8 frames of 1024²,
   each with exact launches (one more K7 under ``concat``) and within the
   int8 contract; a BN-warmed ``Unet(8)`` int8 on the card against the CPU
   within the int8 contract;
22. kernels (int8 3d) — K7v (the int8 3×3×3 conv with K7's epilogue, the
   activation scales folded into the weights) at ``encode2`` (16, 32×128²,
   16) → 32, ``decode1`` (16, 8×32², 384) → 128, ``middle_conv2`` (16,
   4×16², 128) → 256 and ``decode6`` (16, 32×128², 32) → 16, K8v (the
   2×2×2 stride-2 int8 transposed conv into the concat buffer's first
   channels) at up1–up3, K10v (the 2×2×2 int8 max pool)
   at its three levels and K9's three 3D uses (e1 → int8, the raw skip into
   the concat buffer, the dequant of d6), at config 5's forward batch of 16
   tiles of (32, 128, 128), ``UNet3D(32)``: each bit-equal to its plain
   version on the whole batch, timed beside its bound (int8 operations at
   1979 TOP/s, or bytes), ``amax`` over each 2×2×2 window (K10v),
   ``torch._int_mm`` on an im2col (K7v) or on the up-conv's product (K8v),
   and the bf16 cuDNN ``conv3d`` /
   ``conv_transpose3d`` of the layer; K7v / K8v rows with their rates as
   in 20; and K11v (the trilinear decoder's int8 ×2 into its concat buffer)
   at its three levels, up1 (16, 4×16², 256) into channels [0, 256) of a
   384-channel buffer, up2 128 of 192 and up3 (16, 16×64², 64) into [0, 64)
   of 96, the extremes -128 and 127 on the first and last voxels, bit-equal to
   its plain version (the torch calls it replaced), timed beside its byte
   bound and those calls;
23. int8 3d — ``Predict3D(quantized=True)`` at config 5 (a BN-warmed
   ``UNet3D(32)``, a 64×512² uint8 blob volume, tiles (32, 128, 128), bf16
   outside the int8 trunk, two forward batches of 16): launches exact
   around the call (K7v 26, K8v 6, K10v 6, K9 10, beside K1's two, K2v and
   K3v); end-to-end (best of two after a warm-up; the first call's
   calibration timed apart) and device-resident Mvox/s of int8 and bf16 back
   to back and their ratio, the int8 trunk's TOP/s and share of the int8
   dense peak, peak memory, a profile by stage and by ``qconv`` instance;
   int8 within the JAX
   package's 3D bounds of bf16 (at most 35 levels, a mean under 3, beyond 10
   levels on under 5% of voxels); under ``BIU_INT8_EXPERIMENTAL=1`` the
   trilinear ``UNet3D(32)`` (same bounds; its device-resident Mvox/s in int8
   and bf16 and a profile by stage of its int8 pass, K11v's share among them)
   and ``MultiOutputUnet3D(32)`` over
   the ``[3d heads]`` cell's two volumes (heads within 15% / 3% of their
   range), each with exact launches; the trained ``.pt`` of ``[train 3d]``:
   mask IoU within 0.01 of bf16's; a BN-warmed ``UNet3D(8)`` int8 on the card
   against the CPU within the int8 contract; K11v launches 3 a forward batch
   of the trilinear decoder (its JSON entry counts that call);
24. kernels (nested int8) — on the UNet++ int8 grid's row buffers at config
   4's forward batch (16 tiles of 512²): K7 reading ``x_{0,1}``'s input in
   place (channels [0, 96) of row 0) and writing its slot, K10 pooling slot
   0, K9 quantizing ``g0_0``'s bf16 output and dequantizing the last cell
   from slot 4 of row 0 (16, 512², 32 of 192; a strided read), and K11 (the int8 ×2 ``align_corners=True`` bilinear) from slot 0 of
   row 1 (16, 256², 64) into channels [32, 96) of row 0, and at two odd
   shapes: bit-equal to their plain versions, timed beside their bounds and,
   for K10, ``amax`` over the 2×2 windows of the channel range, for K7,
   ``torch._int_mm`` on an ``F.unfold`` im2col of the same channels,
   for K11, the torch calls it replaces (``F.interpolate``, round, clip,
   int8, the slice copy);
25. nested int8 — ``PredictMultiOutput(quantized=True)`` under
   ``BIU_INT8_EXPERIMENTAL=1`` at config 4 (a BN-warmed
   ``MultiOutputNestedUNet(32)``, 40 uint8 1024² frames, 512² patches,
   ``safe_margin=20``, bf16 outside the grid): launches exact around the call
   (per forward batch of 16 tiles K7 29, K11 10, K10 4, K9 2: e1 and the
   last cell's dequant, the partners read in place from the grid's row
   buffers; beside K1, K2h, K5 and K5s); end-to-end and device-resident MP/s of int8
   and bf16 back to back and their ratio, the grid's int8 TOP/s, peak
   memory (reset first), a profile by stage; every head within JAX's UNet++
   int8 bounds of bf16 (max under 25%, mean under 3% of its range floored at
   0.5); BN-warmed UNet++(8) at both depths (deep supervision on the 3-level
   one) on the card against the CPU within the same bounds;
26. attention — ``Predict`` on a BN-warmed ``AttentionUnet(32)`` at config 1
   (64×1024² uint8, 256², bf16), float and then ``quantized=True`` (int8 by
   default): launches exact (float: K1 2, K2 1, K3 1 a chunk; int8 adds per
   forward batch K7 17, K8 4, K10 4, K9 14: the gated decoder's dequants and
   requant); fused vs host-staged within JAX's contract; int8 vs bf16 within
   the 2D int8 contract; end-to-end and device-resident MP/s and their
   ratio, peak memory, profiles; ``AttentionUnet(8)`` on the card against
   the CPU, float32 (one level on ≤ 0.1% of pixels) and int8 (the int8
   contract);
27. ``[int8 e2e]``: the int8 / bf16 end-to-end ratio of each family its phase
   measured (the ship set's ``Unet`` and ``AttentionUnet``, and UNet++ and
   ``UNet3D``);
28. legacy — ``Predict(network="Unet_v0")`` on an old-style ``.pt`` (no
   ``model_name``) of a seeded ``Unet_v0(32)`` over 16 uint8 1024² frames in
   256² tiles, fused: K1 → K2 → the BN-folded float32 legacy forward (cuDNN,
   TF32 as torch's defaults allow) → K3 on float32 logits, launches exact (K1
   2, K2 1, K3 1); ``half_precision=True`` gives the same masks; fused
   against host-staged; end-to-end and device-resident MP/s, TFLOP/s, peak
   memory and a profile; ``Unet_v0(8)`` and ``BabyUnet(4)`` on 2 × 512² on the
   card against the CPU (float32, TF32 off) within one level on ≤ 0.1%;
29. kernels (multichannel) — K3c, K3 over C channels: c = 2 on the exact
   bf16 grid (256 tiles of 256² → 16 × 1024²), the overlapping grid (1000²,
   ``add_tile=1``) and float32 512² tiles, and c = 3 on the exact grid, each
   within one level of its plain version, timed beside its byte bound;
30. multichannel — ``Predict`` of a seeded ``Unet(32, out_channels=2)`` on
   16 uint8 1024² frames, 256² tiles, bf16, host-staged as JAX runs it: K3c
   a chunk, one launch a channel, and nothing else (its launches are K3c's
   in the JSON line);
   (16, 2, 1024, 1024) masks; MP/s and the host's chunk stages; a
   ``Unet(8, out_channels=2)`` on the card against the CPU within one level;
31. train attention — ``[train]``'s leg with ``network="AttentionUnet"``
   (its gates in float32, the rest bf16): K4 once a step and nothing else,
   the loss falls, patches/s over the best epoch after the first, a profiled
   epoch, the trained ``.pt`` through ``Predict`` (mask IoU), and
   ``AttentionUnet(4)`` on 64² tiles, float32, TF32 off, one epoch on the
   card against the CPU (``metrics.csv`` within rtol 1e-3);
32. train legacy — ``Unet_v0(32)`` on the same frames for 2 epochs, float32
   whatever ``half_precision`` says: K4 once a step, the loss falls,
   patches/s, the share of the TF32 peak, a profiled epoch and the trained
   ``.pt`` through ``Predict``;
33. cli — the command line a user calls, in-process: ``main(["train",
   ...])`` at ``[train]``'s width (``Unet(32)``, 256² tiles, batch 12, bf16,
   ``--device-cache``, ``--device-augment``, 2 epochs) on 60 blob frames: K4
   exactly once a step and nothing else, the checkpoint it prints
   (``<workdir>/model/model.ckpt``) present; then ``main(["predict", ...])``
   with the family read from that checkpoint on ``[main]``'s 64×1024² uint8
   movie (a TIFF), 256², bf16: K1, K2 and K3 exactly as ``[checkpoints]``
   counts them, the mask byte-equal to the ``unet`` facade's ``Predict``
   with the same arguments; the wall times of CLI train and predict beside
   the facade's.  Then two subprocesses (``sys.executable -m
   bio_image_unet_tpu_torch``, the checkout on ``PYTHONPATH``): ``devices``
   (exit 0, the card's name printed) and a 16-frame ``predict`` whose mask
   equals the in-process CLI's;
34. recipes — the five ``utils.test`` recipes on the card at their defaults
   (4 epochs, n_filter 8, 64² images): each finishes and its
   ``out/model.ckpt`` predicts; their seconds; ``utils.png_to_grayscale_tiff``
   where PIL imports;
35. histogram oracle — B3, the 256-bin histogram bounds
   (``ops.histogram.u8_clip_bounds``, plain PyTorch) on the card, bit-equal
   to K1 on ``[kernels]``'s uint8 chunk and on skewed frames, its time
   beside K1's;
36. mesh — multi-device on ``torch.distributed``, as one card allows: a
   world of one rank through NCCL (``parallel.initialize_distributed``,
   in-process, its set-up time printed; the group destroyed in a
   ``finally``).  ``unet.Predict(mesh=get_mesh())`` at ``[main]``'s width
   (the 64×1024² uint8 movie, 256² tiles, ``Unet(32)``, bf16, fused): the
   mask byte-equal to ``mesh=None``'s, K1, K2 and K3 4 launches each and
   nothing else, both wall times; the same with ``quantized=True``
   (byte-equal); config 2's ``Trainer`` (``Unet(32)``, 256², batch 12,
   ``device_augment``, 2 epochs) with ``mesh=get_mesh()`` and
   ``device_cache=True`` and ``"sharded"`` against ``mesh=None``:
   ``metrics.csv`` within rtol 1e-3 (the largest difference printed), the
   warm step's time of each, and the cross-rank BatchNorm against cuDNN's
   within 1e-5 of each output's largest value at config 2's first
   BatchNorm;
   ``predict_frames_spatial_sharded`` on 16 of the 1024² frames (halo 128,
   bf16 ``Unet(32)``) and ``predict_volume_spatial_sharded`` on a
   (32, 512, 512) volume (``UNet3D(32)``, halo 64): rows farther than the
   halo from the border against the unsharded folded forward on the same
   input (bf16: JAX's fused-vs-host contract, cuDNN choosing its algorithms
   by shape; the same in float32 with TF32 off, 4 frames: within one level
   on ≤ 0.1%), their times; and ``PredictMultiOutput``, ``siam_unet.Predict``,
   ``Predict3D`` and ``PredictMultiOutput3D`` at smaller depths of their
   phases' shapes, each equal to ``mesh=None``'s; then the kernels' JSON
   line, and the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Without CUDA, or outside a checkout of the repository, it exits with code 2.

    python3 chip_smoke.py --probe-trace

runs only the device phase and then ``[train options]``'s ``profile_dir``
Trainer sixteen times in one process, reading each trace as that phase does:
four runs before any other profiler, eight after a profiled epoch, four with
a device synchronize after the profiler's start.
"""

from __future__ import annotations

import csv
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 bandwidth,
# float32 rate outside the tensor cores (the kernels here do scalar work) and
# the dense bf16 tensor-core rate (the training convolutions)
PEAK_BYTES_PER_S = 3.35e12
PEAK_SCALAR_OPS_PER_S = 67e12
PEAK_BF16_FLOPS = 989e12
# the dense int8 tensor-core rate (operations: two a multiply-add)
PEAK_INT8_OPS = 1979e12
# the dense TF32 tensor-core rate (the float32 convolutions under torch's defaults)
PEAK_TF32_FLOPS = 495e12

FRAMES, H, W, TILE, N_FILTER = 64, 1024, 1024, 256, 32
CHUNK = 16
L2_FLUSH_BYTES = 128 << 20
HOST_LEAD_CYCLES = 1_000_000  # ~0.5 ms of device spin at the H100's clocks
# the training path: train_bench.py's width and batch, 150 frames → 120
# training tiles (10 steps of 12) + 30 validation tiles
TRAIN_FRAMES, TRAIN_BATCH, TRAIN_EPOCHS, TRAIN_LR = 150, 12, 3, 1e-4


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(2)


def log(msg: str) -> None:
    print(msg, flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's kernels run on an NVIDIA GPU only")
    if not (REPO / "bio_image_unet_tpu_torch" / "csrc").is_dir():
        fail(f"{REPO} is not a checkout of the repository (bio_image_unet_tpu_torch/ missing)")
    sys.path.insert(0, str(REPO))

    from bio_image_unet_tpu_torch.ops import _cuda

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    seconds = {}

    def run(name, fn, *args):
        """``fn(*args)``, announced by ``[phase] <name>`` and its wall time
        kept under ``name``; an exception propagates and ends the run."""
        log(f"[phase] {name}")
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    card = run("device", phase_device)
    if sys.argv[1:] == ["--probe-trace"]:
        probe_trainer_traces(torch)
        return 0
    run("build", phase_build, _cuda)
    run("sass", phase_sass, _cuda)
    kernels = run("kernels", phase_kernels, torch, dev)
    k4 = run("kernels training", phase_kernel_augment, torch, dev)
    run("main", phase_main_path, torch, dev, kernels)
    kernels.append(k4)
    trained = run("train", phase_train, torch, dev, kernels)
    run("checkpoints", phase_checkpoints, torch, dev, kernels, trained)
    run("train resume", phase_train_resume, torch, dev, kernels)
    run("train options", phase_train_options, torch, dev, kernels)
    heads = run("kernels heads", phase_kernels_heads, torch, dev)
    run("heads", phase_heads, torch, dev, kernels, heads)
    kernels.extend(heads)
    k4h = run("kernels heads training", phase_kernel_augment_heads, torch, dev)
    kernels.append(k4h)
    run("train heads", phase_train_heads, torch, dev, kernels)
    k3d = run("kernels 3d", phase_kernels_3d, torch, dev)
    run("3d", phase_3d, torch, dev, kernels, k3d)
    run("3d heads", phase_3d_heads, torch, dev, kernels, k3d)
    kernels.extend(k3d)
    kernels.extend(run("kernels 3d training", phase_kernels_3d_training, torch, dev))
    trained3d = run("train 3d", phase_train_3d, torch, dev, kernels)
    ksiam = run("kernels siam", phase_kernels_siam, torch, dev)
    run("siam", phase_siam, torch, dev, kernels, ksiam)
    kernels.extend(ksiam)
    ksiam_train = run("kernels siam training", phase_kernels_siam_training, torch, dev)
    run("train siam", phase_train_siam, torch, dev, kernels, ksiam_train)
    kernels.extend(ksiam_train)
    kint8 = run("kernels int8", phase_kernels_int8, torch, dev)
    # each int8 phase returns its family's int8 / bf16 end-to-end ratio
    ratios = {"Unet (the ship set)": run("int8", phase_int8, torch, dev, kernels, kint8,
                                         trained)}
    kernels.extend(kint8)
    kint8_3d = run("kernels int8 3d", phase_kernels_int8_3d, torch, dev)
    ratios["UNet3D (outside the ship set)"] = run("int8 3d", phase_int8_3d, torch, dev,
                                                  kernels, kint8_3d, trained3d)
    kernels.extend(kint8_3d)
    knested = run("kernels nested int8", phase_kernels_nested_int8, torch, dev)
    ratios["UNet++ (outside the ship set)"] = run("nested int8", phase_nested_int8, torch, dev,
                                                  kernels, knested)
    kernels.extend(knested)
    ratios["AttentionUnet (the ship set)"] = run("attention", phase_attention, torch, dev,
                                                 kernels)
    log("[int8 e2e] int8 / bf16 end to end, each family as its phase measured it: "
        + ", ".join(f"{k} {v:.3f}" for k, v in ratios.items()))
    run("legacy", phase_legacy, torch, dev, kernels)
    kmc = run("kernels multichannel", phase_kernels_multichannel, torch, dev)
    run("multichannel", phase_multichannel, torch, dev, kernels, kmc)
    kernels.extend(kmc)
    run("train attention", phase_train_attention, torch, dev, kernels, k4)
    run("train legacy", phase_train_legacy, torch, dev, kernels, k4)
    run("cli", phase_cli, torch, dev, kernels, k4, kind)
    run("recipes", phase_recipes, torch)
    run("histogram oracle", phase_histogram_oracle, torch, dev)
    run("mesh", phase_mesh, torch, dev, kernels)
    for k in kernels:
        # a timing-only row (a shape no path runs) reports 0 launches; its
        # kernel must be launched on a path all the same
        launched = k["launches"] > 0 or (k.get("_timing_only") and any(
            o["_counter"] is k["_counter"] and o["launches"] > 0 for o in kernels))
        if not launched:
            raise AssertionError(f"{k['name']}: never launched on its main path")
    log("[time] " + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))
    for k in kernels:
        k.pop("_counter")
        k.pop("_timing_only", None)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


# --- 1. device ----------------------------------------------------------------

def phase_device() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi reported no card")
    log(f"[device] {out[0]}")
    return out[0]


# --- 2. build -------------------------------------------------------------------

def phase_build(_cuda) -> None:
    # build from the sources, never from libraries an earlier run left behind
    shutil.rmtree(_cuda.BUILD, ignore_errors=True)
    t0 = time.perf_counter()
    logs = _cuda.build()
    dt = time.perf_counter() - t0
    spilled = []
    for name in _cuda.SOURCES:
        if name not in logs:
            raise RuntimeError(f"kernel {name} was not built")
        entry = ""
        for line in logs[name].splitlines():
            line = line.strip()
            if "Compiling entry" in line:
                entry = line
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log(f"[build] {name}: {line}")
            stores = re.search(r"(\d+) bytes spill stores", line)
            if stores and int(stores.group(1)) and "qconv" in entry:
                spilled.append(f"{entry}: {line}")
    log(f"[build] {len(logs)} sources built by nvcc for sm_90a in {dt:.1f} s")
    if spilled:
        raise RuntimeError("qconv spills to local memory:\n" + "\n".join(spilled))


def qconv_instance(name: str) -> str:
    """``qconv<TCONV, VOL, BM, BN, ...>`` (the template's arguments) from a
    mangled or a demangled kernel name (the name itself where it is
    neither)."""
    m = re.search(r"qconvI((?:L[bi]\d+E)+)E", name)
    if m:
        args = re.findall(r"L([bi])(\d+)E", m.group(1))
        return "qconv<" + ", ".join(("false", "true")[int(v)] if t == "b" else v
                                    for t, v in args) + ">"
    m = re.search(r"qconv<[^>]*>", name)
    return m.group(0) if m else name


def sass_functions(lib: Path) -> dict:
    """``cuobjdump -sass`` of a built library: each function's opcode counts
    (opcodes with their modifiers, e.g. ``LDG.E.128``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    funcs, current = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            current = funcs.setdefault(head.group(1), {})
            continue
        op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if op and current is not None:
            current[op.group(1)] = current.get(op.group(1), 0) + 1
    return funcs


MANGLED_TYPES = {"a": "int8", "h": "uint8", "t": "uint16", "13__nv_bfloat16": "bf16",
                 "6__half": "float16", "f": "float32"}


def template_instance(kernel: str, name: str) -> str:
    """``kernel<arguments>`` from a mangled name of one of its instances
    (type, bool and int arguments), the name itself where it is not one."""
    m = re.search(rf"{len(kernel)}{kernel}I", name)
    if not m:
        return name
    shown, rest = [], name[m.end():]
    while rest and not rest.startswith("E"):
        arg = re.match(r"L([bi])(\d+)E|13__nv_bfloat16|6__half|[afht]", rest)
        if not arg:
            return name
        if arg.group(1) == "b":
            shown.append(("false", "true")[int(arg.group(2))])
        elif arg.group(1) == "i":
            shown.append(arg.group(2))
        else:
            shown.append(MANGLED_TYPES[arg.group(0)])
        rest = rest[arg.end():]
    return f"{kernel}<{', '.join(shown)}>"


def phase_sass(_cuda) -> None:
    """The machine code of the int8 libraries: every ``qconv`` instance must
    run its products on the tensor cores (an IMMA or GMMA instruction) and
    hold no ``__dp4a`` (IDP); K9's, K10's, K11's, K11v's, K6's, K6b's, K3's,
    K5's, K5v's, K5s's, K1's and K2's (with K2h's and K2v's) instances must
    not touch local memory, K6's and K6b's must hold no fused
    multiply-add (FFMA: the plain version rounds each product), K11v's no
    int<->float conversion (I2F, F2I, FRND: its blends are integer), and
    their conversions and wide accesses are logged."""
    funcs = sass_functions(_cuda._lib_path("int8_trunk"))
    qconvs = {k: v for k, v in funcs.items() if "qconv" in k}
    if not qconvs:
        raise RuntimeError("cuobjdump found no qconv function in the int8 library")
    bad = []
    for name, ops in sorted(qconvs.items(), key=lambda kv: qconv_instance(kv[0])):
        mma = {k: v for k, v in ops.items() if k.startswith(("IMMA", "IGMMA", "GMMA"))}
        idp = {k: v for k, v in ops.items() if k.startswith("IDP")}
        shown = {k: v for k, v in ops.items() if k.startswith(("IMMA", "IGMMA", "GMMA", "IDP",
                                                               "LDSM", "LDGSTS", "LDGDEPBAR",
                                                               "DEPBAR", "STG", "STS"))}
        log(f"[sass] {qconv_instance(name)}: {sum(ops.values())} instructions; "
            + ", ".join(f"{k} {v}" for k, v in sorted(shown.items())))
        if not mma or idp:
            bad.append(qconv_instance(name))
    log(f"[sass] {len(qconvs)} qconv instances, each with tensor-core MMAs and no IDP: "
        f"{'no' if bad else 'yes'}")
    if bad:
        raise RuntimeError(f"qconv instances without tensor-core MMAs or with IDP: {bad}")

    # K9, K10, K11, K11v, K6, K6b, K3, K5, K5v, K5s, K1 and K2 (K2h, K2v): what the
    # redesigns removed (int<->float conversions at a quarter of the FMA rate,
    # per-byte work, the division's slow-path call) and what they rely on
    # (16-byte accesses, no FMA in K6 and K6b, integer blends in K11v)
    local, fused, converted = [], [], []
    libs = {"int8_trunk": funcs}
    for lib, kernel, want in (("int8_trunk", "requant", 30), ("int8_trunk", "maxpool_i8", 5),
                              ("int8_resample", "upsample2x_i8", 5),
                              ("int8_resample", "upsample2x_i8_3d", 5),
                              ("depthwise_xcorr", "xcorr", 2),
                              ("depthwise_xcorr", "xcorr_plane", 2),
                              ("depthwise_xcorr", "xcorr_grad_input", 2),
                              ("depthwise_xcorr", "xcorr_grad_kernel", 2),
                              ("depthwise_xcorr", "xcorr_grad_input_plane", 2),
                              ("depthwise_xcorr", "xcorr_grad_kernel_plane", 2),
                              ("sigmoid_stitch", "sigmoid_stitch", 2),
                              ("margin_stitch", "margin_stitch", 2),
                              ("margin_stitch", "blend_stitch_3d", 2),
                              ("margin_stitch", "tile_sum", 1),
                              ("clip_bounds", "clip_pass", 12),
                              ("normalize_tile", "normalize_tile", 36)):
        if lib not in libs:
            libs[lib] = sass_functions(_cuda._lib_path(lib))
        found = libs[lib]
        found = {template_instance(kernel, k): v for k, v in found.items()
                 if re.search(rf"{len(kernel)}{kernel}I", k)}
        if len(found) != want:
            raise RuntimeError(f"cuobjdump found {len(found)} {kernel} instances in {lib}, "
                               f"expected {want}")
        for inst, ops in sorted(found.items()):
            def count(*prefixes, wide=False):
                return sum(v for k, v in ops.items()
                           if k.startswith(prefixes) and (not wide or ".128" in k))
            n_local = count("LDL", "STL")
            log(f"[sass] {inst}: {sum(ops.values())} instructions; I2F {count('I2F')}, "
                f"F2I {count('F2I')}, FRND {count('FRND')}, MUFU {count('MUFU')}, FFMA "
                f"{count('FFMA')}, FMUL {count('FMUL')}, FADD {count('FADD')}; 128-bit "
                f"global loads {count('LDG', 'LDGSTS', wide=True)}, stores "
                f"{count('STG', wide=True)}, shared loads {count('LDS', wide=True)}; local "
                f"memory {n_local}")
            if n_local:
                local.append(inst)
            if kernel.startswith("xcorr") and count("FFMA"):
                fused.append(inst)
            if kernel == "upsample2x_i8_3d" and count("I2F", "F2I", "FRND"):
                converted.append(inst)
    if local:
        raise RuntimeError(f"K9 / K10 / K11 / K11v / K6 / K6b / K3 / K5 / K5v / K5s / K1 / K2 / "
                           f"K2v instances use local memory: {local}")
    if fused:
        raise RuntimeError(f"K6 / K6b instances fuse a multiply and an add (FFMA): {fused}")
    if converted:
        raise RuntimeError(f"K11v instances convert between int and float: {converted}")
    log("[sass] K9, K10, K11, K11v, K6, K6b, K3, K5, K5v, K5s, K1, K2 and K2v instances without "
        "local memory, K6 and K6b without FFMA, K11v without I2F / F2I / FRND: yes")


# --- 3. kernels -----------------------------------------------------------------

class Timer:
    """Mean device time of ``fn`` over ``iters`` launches, each after a write
    of 128 MB that evicts the 50 MB L2 (the main path finds its inputs cold:
    they were just uploaded or written by the previous stage).  A spin of
    ``HOST_LEAD_CYCLES`` on the device between the flush and the start event
    lets the host enqueue ``fn``'s launches before the device reaches them, so
    the time is the device's alone, not the wrapper's host work."""

    def __init__(self, torch, dev):
        self.torch = torch
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def __call__(self, fn, iters: int = 10) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            self.flush.fill_(1)
            torch.cuda._sleep(HOST_LEAD_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters


def kernel_row(tag, name, source, replaces, counter, err, ms, plain_ms, bound,
               library_ms) -> dict:
    """One kernel's entry of the JSON line (its launches are filled in from
    the main path), logged as it is made."""
    b, by = bound
    log(f"[{tag}] {name}: max_abs_err {err} | kernel {ms:.4f} ms | plain {plain_ms:.4f} ms"
        f" | bound {b:.4f} ms ({by}) | library "
        + ("none" if library_ms is None else f"{library_ms:.4f} ms"))
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": library_ms, "_counter": counter}


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float = PEAK_SCALAR_OPS_PER_S):
    """The least time of a kernel's work: its bytes at the memory rate or
    its operations at ``peak_ops``, the card's rate for the operand type,
    whichever is longer."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def amax_pool_ms(torch, timer, x, want) -> float:
    """K10's / K10v's library yardstick: one ``amax`` over each 2×2 (2×2×2)
    window of a view of ``x`` (even extents; a channel range too), held equal
    to the kernel's output ``want``, then timed."""
    def pool():
        v = x
        for axis in range(1, x.dim() - 1):
            v = v.unflatten(2 * axis - 1, (v.shape[2 * axis - 1] // 2, 2))
        return v.amax(tuple(range(2, v.dim() - 1, 2)))

    if not torch.equal(pool(), want):
        raise AssertionError(f"amax over the 2x2 windows of {tuple(x.shape)} differs from the "
                             "kernel's max pool")
    return timer(pool, 5)


def phase_kernels(torch, dev) -> list:
    from bio_image_unet_tpu_torch.ops import histogram as hist
    from bio_image_unet_tpu_torch.ops.stitch import sigmoid_stitch, sigmoid_stitch_plain
    from bio_image_unet_tpu_torch.predict.normalize import normalize_tile, normalize_tile_plain
    from bio_image_unet_tpu_torch.predict.tiling import TilePlan, grid_starts
    from bio_image_unet_tpu_torch.utils.kernel_ab_times import microscopy_frames

    timer = Timer(torch, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    qs = (0.0, 99.8)
    rows = []

    def row(*args):
        rows.append(kernel_row("kernels", *args))

    def library_sort(x):
        """One torch.sort gives every order statistic of every frame."""
        flat = x.reshape(x.shape[0], -1)
        try:
            torch.sort(flat, dim=1)
        except (RuntimeError, NotImplementedError) as err:
            log(f"[kernels] torch.sort takes no {x.dtype} on the card ({err.__class__.__name__})")
            return None
        return timer(lambda: torch.sort(flat, dim=1), iters=5)

    # K1 / K1f: 16-frame chunks of 1024² frames, the main path's shapes, of
    # uniform random values and of microscopy statistics (most pixels on a
    # few background levels: kernel_ab_times.microscopy_frames, in uint8 and
    # its uint16 and float32 twins)
    movies = {
        "uint8": torch.randint(0, 256, (CHUNK, H, W), generator=g, device=dev,
                               dtype=torch.int32).to(torch.uint8),
        "uint16": torch.randint(0, 65536, (CHUNK, H, W), generator=g, device=dev,
                                dtype=torch.int32).to(torch.uint16),
        "float32": torch.randn((CHUNK, H, W), generator=g, device=dev) * 40 + 5,
    }
    skewed = {dt_name: torch.from_numpy(m).to(dev) for dt_name, m in
              zip(movies, microscopy_frames(301, CHUNK, H))}
    for kind, group in (("", movies), ("skewed ", skewed)):
        for dt_name, x in group.items():
            is_f = dt_name == "float32"
            wrapper = hist.float_clip_bounds if is_f else hist.int_clip_bounds
            ours = wrapper(x, *qs)
            torch.cuda.synchronize()
            ref = hist.clip_bounds_plain(x, *qs)
            if not torch.equal(ours.view(torch.int32), ref.view(torch.int32)):
                raise AssertionError(f"K1 {kind}{dt_name}: kernel {ours.tolist()} != plain "
                                     f"{ref.tolist()}")
            n_pix = x.numel()
            row(("k1f_float_clip_bounds" if is_f else "k1_int_clip_bounds")
                + f"[{kind}{dt_name}]",
                "bio_image_unet_tpu_torch/csrc/clip_bounds.cu",
                "bio_image_unet_tpu/ops/histogram.py:" + ("142" if is_f else "110"),
                wrapper, (ours - ref).abs().max().item(),
                timer(lambda: wrapper(x, *qs)), timer(lambda: hist.clip_bounds_plain(x, *qs), 3),
                # least work: read every pixel once, one compare each; write 4 bounds
                bound_ms(n_pix * x.element_size() + 4 * CHUNK * 4, n_pix),
                library_sort(x))

    def k2(grid, x, h, w, add):
        """K2 held equal to plain on one grid and timed; its plan and padded
        batch for K3."""
        plan = TilePlan(h, w, TILE, TILE, grid_starts(h, TILE, add), grid_starts(w, TILE, add), dev)
        n = CHUNK * plan.per_frame
        bs = max(8, min(n, (1 << 24) // (TILE * TILE)))
        n_pad = -(-n // bs) * bs
        bounds = hist.clip_bounds(x, *qs)
        ours = normalize_tile(x, bounds, plan, n_pad, False)
        torch.cuda.synchronize()
        ref = normalize_tile_plain(x, bounds, plan, n_pad, False)
        err = (ours.int() - ref.int()).abs().max().item()
        if err != 0:
            raise AssertionError(f"K2 {grid}: kernel differs from plain by {err} levels")
        out_bytes = n_pad * TILE * TILE
        row(f"k2_normalize_tile[{grid}]", "bio_image_unet_tpu_torch/csrc/normalize_tile.cu",
            "bio_image_unet_tpu/predict/predictor.py:742", normalize_tile, err,
            timer(lambda: normalize_tile(x, bounds, plan, n_pad, False)),
            timer(lambda: normalize_tile_plain(x, bounds, plan, n_pad, False), 3),
            # read each source pixel once, write each tile pixel once; about
            # five float operations per tile pixel (clip, subtract, divide, scale)
            bound_ms(x.numel() * x.element_size() + bounds.numel() * 4 + out_bytes,
                     5 * out_bytes),
            None)
        return plan, n, n_pad

    # K2 on the skewed frames: a uint8 frame's level table read mostly at a
    # few entries, the uint16 twin on the gather grid
    k2("skewed exact", skewed["uint8"], H, W, 0)
    k2("skewed gather", skewed["uint16"][:, :1000, :1000].contiguous(), 1000, 1000, 1)
    del skewed

    # K2 and K3 on the exact grid (uint8, 1024² in 256² tiles) and the
    # overlapping grid (uint16, 1000² in 256² tiles, add_tile=1)
    grids = {
        "exact": (movies["uint8"], H, W, 0),
        "gather": (movies["uint16"][:, :1000, :1000].contiguous(), 1000, 1000, 1),
    }
    for grid, (x, h, w, add) in grids.items():
        plan, n, n_pad = k2(grid, x, h, w, add)

        logits = (torch.randn((n_pad, 1, TILE, TILE), generator=g, device=dev) * 4
                  ).to(torch.bfloat16)
        ours = sigmoid_stitch(logits, CHUNK, plan)
        torch.cuda.synchronize()
        ref = sigmoid_stitch_plain(logits, CHUNK, plan)
        err = (ours.int() - ref.int()).abs().max().item()
        if err > 1:
            raise AssertionError(f"K3 {grid}: kernel differs from plain by {err} levels")
        n_logit = n * TILE * TILE
        row(f"k3_sigmoid_stitch[{grid}]", "bio_image_unet_tpu_torch/csrc/sigmoid_stitch.cu",
            "bio_image_unet_tpu/predict/predictor.py:450", sigmoid_stitch, err,
            timer(lambda: sigmoid_stitch(logits, CHUNK, plan)),
            timer(lambda: sigmoid_stitch_plain(logits, CHUNK, plan), 3),
            # read each real tile's logits once (bf16), write each pixel once;
            # about four operations per logit (exp, add, divide, scale) + the sum
            bound_ms(n_logit * 2 + CHUNK * h * w, 5 * n_logit),
            None)
        del logits, ours, ref
    del movies

    # K3 at Predict's defaults (half_precision=False, resize_dim=(512, 512)):
    # float32 logits of 64 tiles of 512^2 -> 16 frames of 1024^2, exact grid
    big = 2 * TILE
    plan = TilePlan(H, W, big, big, grid_starts(H, big), grid_starts(W, big), dev)
    n = CHUNK * plan.per_frame
    logits = torch.randn((n, 1, big, big), generator=g, device=dev) * 4
    ours = sigmoid_stitch(logits, CHUNK, plan)
    torch.cuda.synchronize()
    ref = sigmoid_stitch_plain(logits, CHUNK, plan)
    err = (ours.int() - ref.int()).abs().max().item()
    if err > 1:
        raise AssertionError(f"K3 float32 512^2 tiles: kernel differs from plain by {err} levels")
    row(f"k3_sigmoid_stitch[exact float32 ({n}, {big}^2) -> {CHUNK}x{H}^2, Predict's defaults]",
        "bio_image_unet_tpu_torch/csrc/sigmoid_stitch.cu",
        "bio_image_unet_tpu/predict/predictor.py:450", sigmoid_stitch, err,
        timer(lambda: sigmoid_stitch(logits, CHUNK, plan)),
        timer(lambda: sigmoid_stitch_plain(logits, CHUNK, plan), 3),
        # read each logit once (float32), write each pixel once
        bound_ms(n * big * big * 4 + CHUNK * H * W, 5 * n * big * big), None)
    del logits, ours, ref
    torch.cuda.empty_cache()
    return rows


# --- 4. main path ---------------------------------------------------------------

def write_checkpoint(torch, path: str, name: str, n_filter: int, seed: int = 0,
                     **hyper) -> None:
    """A reference-schema ``.pt`` of registry model ``name`` with seeded random
    weights and random BatchNorm statistics (so the BN fold has something to
    fold); ``hyper`` are further hyperparams (``output_heads``, …)."""
    from bio_image_unet_tpu_torch.models import get_model
    from bio_image_unet_tpu_torch.ops.blocks import init_weights_

    hyper = {"model_name": name, "n_filter": n_filter, "in_channels": 1, **hyper}
    net = init_weights_(get_model(name, **hyper), torch.Generator().manual_seed(seed),
                        random_bn_stats=True)
    torch.save({"state_dict": net.state_dict(), "epoch": 0, "best_loss": None, **hyper}, path)


def check_fused_vs_host(name: str, fused: np.ndarray, host: np.ndarray, shape,
                        tag: str = "main") -> None:
    """The contract the JAX package holds between its fused and host paths
    (``tests/test_predict.py``): host percentiles are float64, so a clip bound
    may move by a code point."""
    if fused.shape != tuple(shape) or fused.dtype != np.uint8:
        raise AssertionError(f"{name}: result {fused.shape} {fused.dtype}, want {shape} uint8")
    diff = np.abs(fused.astype(np.int16) - host.astype(np.int16))
    frac = float(np.mean(diff > 1))
    log(f"[{tag}] {name}: fused vs host max {int(diff.max())} levels, "
        f"{frac:.6f} of pixels beyond 1 level; mask mean {fused.mean():.2f}, "
        f"std {fused.std():.2f}")
    if not (frac < 0.01 and diff.max() <= 16):
        raise AssertionError(f"{name}: fused and host paths disagree (max {diff.max()}, "
                             f"{frac:.4%} beyond one level)")


def phase_main_path(torch, dev, kernels) -> None:
    from bio_image_unet_tpu_torch.predict import Predict
    from bio_image_unet_tpu_torch.predict.predictor import _Engine
    from bio_image_unet_tpu_torch.predict.tiling import grid_starts

    counters = {id(k["_counter"]): k["_counter"] for k in kernels}
    rng = np.random.default_rng(0)
    movie = rng.integers(0, 255, (FRAMES, H, W), dtype=np.uint8)
    movie_u16 = rng.integers(0, 65535, (CHUNK, 1000, 1000), dtype=np.uint16)
    movie_f32 = (rng.standard_normal((CHUNK, H, W)) * 40 + 5).astype(np.float32)
    movie_first = movie[:CHUNK]
    kw = dict(resize_dim=(TILE, TILE), show_progress=False, batch_size=8, half_precision=True)
    cases = [
        ("uint8 64x1024^2 exact (bench.py)", movie, {}),
        ("uint16 16x1000^2 add_tile=1", movie_u16, {"add_tile": 1}),
        ("float32 16x1024^2", movie_f32, {}),
        ("uint8 16x1024^2 'first'", movie_first, {"normalization_mode": "first"}),
    ]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "unet_nf32.pt")
        write_checkpoint(torch, ckpt, "Unet", N_FILTER, out_channels=1)

        # the main path: every launch count is 0 just before, read just after
        for c in counters.values():
            c.launches = 0
        results, times = {}, {}
        for name, imgs, extra in cases:
            reps = 3 if imgs is movie else 1  # warm-up + two timed passes of the bench movie
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                res = Predict(imgs, None, ckpt, **kw, **extra).result
                best = min(best, time.perf_counter() - t0)
            results[name], times[name] = res, best
        launches = {id(c): c.launches for c in counters.values()}
        for k in kernels:
            k["launches"] = launches[id(k["_counter"])]
            if k["launches"] <= 0:
                raise AssertionError(f"{k['name']}: never launched on the main path")
        log("[main] launches: " + ", ".join(f"{k['name']} {k['launches']}" for k in kernels))

        for name, imgs, extra in cases:
            log(f"[main] {name}: {times[name]:.3f} s end to end "
                f"({imgs.shape[0] * imgs.shape[1] * imgs.shape[2] / 1e6 / times[name]:.2f} MP/s)")
            host = Predict(imgs, None, ckpt, device_pipeline=False, **kw, **extra).result
            check_fused_vs_host(name, results[name], host, imgs.shape)
        e2e = FRAMES * H * W / 1e6 / times[cases[0][0]]

        # device-resident: the same chunk program on a movie already on the card
        t0 = time.perf_counter()
        engine = _Engine(ckpt, None, batch_size=8, half_precision=True, device=dev)
        t_engine = time.perf_counter() - t0
        xs, ys = grid_starts(H, TILE, 0), grid_starts(W, TILE, 0)
        device_mps = {}
        for dt_name, m in (("uint8", movie), ("uint16", movie.astype(np.uint16) * 257)):
            fn, n_chunk = engine.fused_runner(H, W, xs, ys, (TILE, TILE), (0.0, 99.8),
                                              n_frames=FRAMES)
            movie_dev = torch.from_numpy(m).to(dev)
            fn(movie_dev[:n_chunk])
            torch.cuda.synchronize()
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                outs = [fn(movie_dev[i:i + n_chunk]) for i in range(0, FRAMES, n_chunk)]
                torch.cuda.synchronize()
                best = min(best, time.perf_counter() - t0)
            device_mps[dt_name] = FRAMES * H * W / 1e6 / best
            if dt_name == "uint8":
                same = np.abs(torch.cat(outs).cpu().numpy().astype(np.int16)
                              - results[cases[0][0]]).max()
                log(f"[main] device-resident uint8 run vs its Predict run: max {same} levels")
                profile_device_resident(torch, fn, movie_dev, n_chunk)
            del movie_dev, outs
        log(f"[main] end-to-end {e2e:.2f} MP/s; device-resident {device_mps['uint8']:.2f} MP/s "
            f"uint8, {device_mps['uint16']:.2f} MP/s uint16; engine set-up (load, fold, "
            f"upload) {t_engine:.3f} s; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

        # a small float32 reference: the card's Predict against the CPU's
        # (plain versions of the kernels, CPU convolutions), TF32 off
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        small = str(Path(tmp) / "unet_nf8.pt")
        write_checkpoint(torch, small, "Unet", 8, seed=1, out_channels=1)
        dilated = str(Path(tmp) / "unet_d2_nf8.pt")
        write_checkpoint(torch, dilated, "Unet", 8, seed=2, out_channels=1, dilation=2)
        for ck, add, m in ((small, 0, rng.integers(0, 255, (3, 128, 128), dtype=np.uint8)),
                           (small, 1, rng.integers(0, 65535, (3, 100, 90), dtype=np.uint16)),
                           (dilated, 0, rng.integers(0, 255, (3, 128, 128), dtype=np.uint8))):
            skw = dict(resize_dim=(64, 64), add_tile=add, show_progress=False, batch_size=4)
            on_card = Predict(m, None, ck, **skw).result
            on_cpu = Predict(m, None, ck, device="cpu", **skw).result
            diff = np.abs(on_card.astype(int) - on_cpu.astype(int))
            log(f"[main] small float32 {'Unet(8, dilation=2)' if ck == dilated else 'Unet(8)'} "
                f"{m.dtype} add_tile={add}: card vs CPU max {diff.max()} "
                f"levels on {np.mean(diff > 0):.6f} of pixels")
            if diff.max() > 1 or np.mean(diff > 0) > 1e-3:
                raise AssertionError("the card's Predict disagrees with the CPU's")


# kernel-name fragments of each stage of the chunk programs (first match wins)
STAGES = (("k7/k8 int8 conv, up-conv", ("qconv",)),
          ("k9 requant", ("requant",)),
          ("k10 int8 max pool", ("maxpool_i8",)),
          ("k11/k11v int8 upsample", ("upsample2x_i8",)),
          ("k1 clip bounds", ("clip_pass",)),
          ("k2/k2h/k2v/k2p normalize+tile", ("normalize_tile",)),
          ("k6 depthwise xcorr", ("xcorr",)),
          ("copies host to device", ("memcpy htod",)),
          ("copies device to host", ("memcpy dtoh",)),
          ("k3/k3v sigmoid+stitch", ("sigmoid_stitch",)),
          ("k5/k5v weighted stitch", ("margin_stitch", "blend_stitch")),
          ("k5s tile sum", ("tile_sum",)),
          ("upsample (bilinear, trilinear, nearest)", ("upsample",)),
          ("concat", ("catarray",)),
          ("copies (layout, dtype)", ("direct_copy",)),
          ("convolutions", ("conv", "cudnn", "xmma", "gemm", "sm90", "implicit", "cutlass",
                            "fprop", "dgrad")),
          ("max pool", ("max_pool",)))


def profile_device_resident(torch, fn, movie_dev, n_chunk) -> None:
    """One profiled device-resident pass over the bench movie."""
    def run():
        for i in range(0, FRAMES, n_chunk):
            fn(movie_dev[i:i + n_chunk])

    profile_pass(torch, run, "main", f"{FRAMES} frames")


def profile_pass(torch, run, tag: str, what: str, shares=()) -> None:
    """Profile ``run()``: device time by stage (kernel names) and the
    device's idle share of the pass's wall time; ``shares``: (label, kernel
    name) pairs whose launches and share of the device time are logged.  The
    profiler's own overhead lengthens the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_stage = {name: 0.0 for name, _ in STAGES}
    by_stage["other (elementwise, cat, memset)"] = 0.0
    by_name = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        dur = ev.time_range.elapsed_us()
        low = ev.name.lower()
        stage = next((name for name, keys in STAGES if any(k in low for k in keys)),
                     "other (elementwise, cat, memset)")
        by_stage[stage] += dur
        total, count = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (total + dur, count + 1)
    busy = sum(by_stage.values())
    if busy == 0:
        log(f"[{tag}] profiler saw no device time: breakdown not measured")
        return
    log(f"[{tag}] device-resident profile ({what}, profiler on): wall {wall_us / 1e3:.2f} ms, "
        f"device busy {busy / 1e3:.2f} ms, idle share {1 - busy / wall_us:.4f}; "
        + ", ".join(f"{k} {v / 1e3:.2f} ms ({v / busy:.1%})" for k, v in by_stage.items() if v))
    qconvs = {}
    for name, (total, count) in by_name.items():
        if "qconv" in name:
            inst = qconv_instance(name)
            t, c = qconvs.get(inst, (0.0, 0))
            qconvs[inst] = (t + total, c + count)
    if qconvs:
        log(f"[{tag}] qconv by instance: " + ", ".join(
            f"{k} {t / 1e3:.2f} ms {c}x ({t / busy:.1%})"
            for k, (t, c) in sorted(qconvs.items(), key=lambda kv: -kv[1][0])))
    for label, kernel in shares:
        hit = [(t, c) for name, (t, c) in by_name.items()
               if re.search(rf"\b(?:{kernel})\b", name)]
        total, count = sum(t for t, _ in hit), sum(c for _, c in hit)
        log(f"[{tag}] {label} ({kernel}): {count} launches, {total / 1e3:.4f} ms, "
            f"{total / busy:.2%} of the device-resident pass's device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (total, count) in top:
        log(f"[{tag}]   {total / 1e3:8.2f} ms {count:5d}x  {name[:110]}")


# --- 5. kernels of the training path ---------------------------------------------

def phase_kernel_augment(torch, dev) -> dict:
    """K4 at the training shapes: 12 of 120 resident 256² tiles, the draws
    the Trainer makes (no Gaussian stage); the pair form with the Gaussian
    stage is checked at the same shapes."""
    from bio_image_unet_tpu_torch.data.augment_device import (augment_apply,
                                                              augment_apply_plain, draw)

    timer = Timer(torch, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    n, b, s = 120, TRAIN_BATCH, TILE
    image = torch.rand((n, 1, s, s), generator=g, device=dev)
    mask = (torch.rand((n, 1, s, s), generator=g, device=dev) > 0.5).float()
    prev = torch.rand((n, 1, s, s), generator=g, device=dev)
    index = torch.randperm(n, generator=g, device=dev)[:b]

    def ulps(a, ref):
        return (a.view(torch.int32).long() - ref.view(torch.int32).long()).abs().max().item()

    d = draw(g, b, (b, 1, s, s))
    ours = augment_apply(image, mask, d, index=index)
    torch.cuda.synchronize()
    ref = augment_apply_plain(image, mask, d, index=index)
    if not torch.equal(ours[1], ref[1]) or ulps(ours[0], ref[0]) > 1:
        raise AssertionError(f"K4: mask equal {torch.equal(ours[1], ref[1])}, image "
                             f"{ulps(ours[0], ref[0])} ulps from the plain version")
    err = (ours[0] - ref[0]).abs().max().item()
    dp = draw(g, b, (b, 1, s, s), prev=True, gauss_sigma=0.04)
    pair = augment_apply(image, mask, dp, index=index, prev=prev)
    torch.cuda.synchronize()
    pref = augment_apply_plain(image, mask, dp, index=index, prev=prev)
    if not torch.equal(pair[1], pref[1]) or max(ulps(pair[0], pref[0]),
                                                ulps(pair[2], pref[2])) > 1:
        raise AssertionError("K4 pair form with Gaussian noise differs from its plain version")

    ms = timer(lambda: augment_apply(image, mask, d, index=index))
    plain_ms = timer(lambda: augment_apply_plain(image, mask, d, index=index), 3)
    flags = d.flags.cpu()
    n_mult = int(((flags[:, 0] != 0) & (flags[:, 5] != 0)).sum())
    plane = s * s * 4
    # least work for this draw: index, flags and coefficients; each gathered
    # image and mask pixel read once; the multiplier field read for the samples
    # whose gate and noise flag are on; each output pixel written once; about
    # six float operations per augmented image pixel
    n_bytes = b * (8 + 7 * 4 + 2 * 4) + 2 * b * plane + n_mult * plane + 2 * b * plane
    bound, by = bound_ms(n_bytes, 6 * b * s * s)
    log(f"[kernels] k4_augment_batch: mask bit-equal, image max_abs_err {err} (<= 1 ulp); "
        f"pair form + Gaussian checked | kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
        f"bound {bound:.4f} ms ({by}, {n_bytes / 1e6:.2f} MB) | library none")
    return {"name": "k4_augment_batch", "route": "cuda",
            "source": "bio_image_unet_tpu_torch/csrc/augment_batch.cu",
            "replaces": "bio_image_unet_tpu/data/augment_jax.py:132", "launches": 0,
            "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None, "_counter": augment_apply}


# --- 6. the training path ----------------------------------------------------------

def unet_forward_flops(nf: int, s: int) -> float:
    """Multiply-add FLOPs of one s² tile through ``Unet(n_filter=nf)``: the
    3×3 convs of each level, the 2×2 stride-2 transposed convs and the final
    1×1 conv."""
    def conv(ci, co, hw, k=3):
        return 2 * ci * co * k * k * hw

    f, hw = 0.0, s * s
    widths = [(1, nf), (nf, 2 * nf), (2 * nf, 4 * nf), (4 * nf, 8 * nf), (8 * nf, 16 * nf)]
    for level, (ci, co) in enumerate(widths):
        f += conv(ci, co, hw / 4 ** level) + conv(co, co, hw / 4 ** level)
    for level in range(4, 0, -1):
        ci, co = widths[level][1], widths[level - 1][1]
        f += 2 * ci * co * 4 * hw / 4 ** level  # transposed conv, per input pixel
        f += conv(2 * co, co, hw / 4 ** (level - 1)) + conv(co, co, hw / 4 ** (level - 1))
    return f + 2 * nf * hw


def write_blob_frames(root: Path, n: int, size: int, seed: int) -> tuple:
    """``n`` blob frames and their masks as TIFFs under ``root``/image and
    ``root``/label (the layout ``DataProcess`` reads)."""
    from bio_image_unet_tpu_torch.data import tiff
    from bio_image_unet_tpu_torch.utils.synth import blob_sample

    rng = np.random.default_rng(seed)
    for sub in ("image", "label"):
        (root / sub).mkdir(parents=True)
    for i in range(n):
        img, mask = blob_sample(rng, (size, size), n_blobs=10, margin=16, radius=(8, 20))
        tiff.imwrite(str(root / "image" / f"{i:04d}.tif"), img)
        tiff.imwrite(str(root / "label" / f"{i:04d}.tif"), mask)
    return (str(root / "image") + "/", str(root / "label") + "/")


def config2_data(tmp: Path):
    """``[train]``'s 150 blob frames of 256² through ``unet.DataProcess``."""
    from bio_image_unet_tpu_torch import unet

    source = write_blob_frames(tmp / "frames", TRAIN_FRAMES, TILE, seed=0)
    return unet.DataProcess(source, dim_out=(TILE, TILE), aug_factor=None,
                            data_path=str(tmp / "data"), seed=0)


def config2_trainer(data, out: Path, epochs: int, **kw):
    """``[train]``'s Trainer: ``Unet(32)``, batch 12, lr 1e-4, bf16, resident
    and augmented tiles (K4), writing ``model.pt`` unless ``save_name`` says
    otherwise."""
    from bio_image_unet_tpu_torch import unet

    kw.setdefault("save_name", "model.pt")
    kw.setdefault("device_cache", True)
    return unet.Trainer(data, epochs, n_filter=N_FILTER, batch_size=TRAIN_BATCH, lr=TRAIN_LR,
                        save_dir=str(out), seed=0, half_precision=True, device_augment=True,
                        **kw)


def metrics_rows(out: Path) -> np.ndarray:
    """``metrics.csv``'s (epoch, train loss, val loss, lr) rows."""
    with open(out / "metrics.csv") as fh:
        return np.array([[float(v) for v in r[:4]] for r in list(csv.reader(fh))[1:]])


def phase_train(torch, dev, kernels) -> bytes:
    """... and returns the trained ``.pt`` (its bytes), for ``[int8]``."""
    k4 = kernels[-1]
    trained, k4["launches"] = train_leg(torch, kernels, k4, "train")
    train_card_vs_cpu(torch)
    return trained


def train_leg(torch, kernels, k4, tag: str, network: str = "Unet",
              epochs: int = TRAIN_EPOCHS, timed_from: int = 0,
              flops_per_tile: float = None, peak: float = PEAK_BF16_FLOPS) -> tuple:
    """``[train]``'s leg for ``network``: ``DataProcess`` on the blob frames,
    the ``unet`` facade's ``Trainer`` at ``train_bench.py``'s width (bf16,
    resident and augmented tiles) for ``epochs``, launch counts exact (K4
    once a step, nothing else); the losses must fall.  Prints patches/s over
    the best epoch from ``timed_from`` on, the implied share of ``peak``, a
    profiled epoch and the trained ``.pt`` through ``Predict`` (mask IoU).
    Returns the trained ``.pt``'s bytes and K4's launches."""
    counters = {id(k["_counter"]): k["_counter"] for k in kernels}
    # the user's defaults: cuDNN may use TF32 for float32 convolutions
    torch.backends.cudnn.allow_tf32 = True
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        data = config2_data(tmp)
        trainer = config2_trainer(data, tmp / "run", epochs, network=network)
        steps = trainer._n_train // TRAIN_BATCH
        log(f"[{tag}] {network}(n_filter={N_FILTER}): set-up (frames, DataProcess, Trainer, "
            f"tiles to the card) {time.perf_counter() - t0:.2f} s: {len(data)} tiles, "
            f"{trainer._n_train} training, {steps} steps of {TRAIN_BATCH} per epoch; "
            f"parameters {next(trainer.model.parameters()).dtype}")

        # the main path: every launch count is 0 just before, read just after
        for c in counters.values():
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        trainer.start()
        torch.cuda.synchronize()
        launches = {id(c): c.launches for c in counters.values()}
        peak_mem = torch.cuda.max_memory_allocated()
        log(f"[{tag}] launches: " + ", ".join(f"{k['name']} {launches[id(k['_counter'])]}"
                                              for k in kernels))
        for c in counters.values():
            want = steps * epochs if c is k4["_counter"] else 0
            if launches[id(c)] != want:
                raise AssertionError(f"[{tag}] {c.__name__} launched {launches[id(c)]} times in "
                                     f"{steps * epochs} steps, want {want}")
        hist = trainer.history
        for h in hist:
            log(f"[{tag}] epoch {h['epoch']}: train loss {h['train_loss']:.6f}, val loss "
                f"{h['val_loss']:.6f}, lr {h['lr']:g}, training pass {h['train_seconds']:.3f} s, "
                f"epoch {h['seconds']:.3f} s")
        if not hist[-1]["train_loss"] < hist[0]["train_loss"]:
            raise AssertionError(f"[{tag}] the training loss did not fall")
        best = min(h["train_seconds"] for h in hist[timed_from:])
        patches = steps * TRAIN_BATCH / best
        flops = 3 * (flops_per_tile or unet_forward_flops(N_FILTER, TILE))
        log(f"[{tag}] {patches:.1f} patches/s (best epoch from epoch {timed_from}), step "
            f"{best / steps * 1e3:.2f} ms; peak device memory {peak_mem / 2**30:.2f} GiB; "
            f"{flops / 1e9:.1f} GFLOP per tile forward+backward → "
            f"{flops * patches / 1e12:.1f} TFLOP/s, {flops * patches / peak:.4f} of the "
            f"{'bf16' if peak == PEAK_BF16_FLOPS else 'TF32'} dense peak")

        profile_train_epoch(torch, trainer, epochs, best, tag=tag)
        predict_trained(torch, str(tmp / "run" / "model.pt"), counters, tag)
        return (tmp / "run" / "model.pt").read_bytes(), launches[id(k4["_counter"])]


def _stage(kernel: str, ancestors) -> str:
    """The training stage a device kernel belongs to, from its name and the
    names of the CPU ranges that launched it."""
    low = kernel.lower()
    for key, stage in (("augment_heads_volume", "K4hv augment heads (volumes)"),
                       ("augment_volume", "K4v augment (volumes)"),
                       ("augment_batch", "K4 augment"), ("augment_heads", "K4h augment heads")):
        if key in low:
            return stage
    if "xcorr" in low:
        return "K6 / K6b corr join (forward, backward)"
    if "augment" in ancestors:
        return "augment draws (torch.rand, uniform_, flags)"
    if "upsample" in low:
        return ("upsample backward" if "backward" in low else "upsample forward")
    if "catarray" in low:
        return "concat"
    if any("Optimizer.step" in a for a in ancestors):
        return "Adam"
    if "batch_norm" in low or "batchnorm" in low or "bn_fw" in low or "bn_bw" in low:
        backward = any(k in low for k in ("backward", "bwtr", "bn_bw"))
        return "BatchNorm backward" if backward else "BatchNorm forward"
    for key, stage in (("wgrad", "conv wgrad"), ("dgrad", "conv dgrad"), ("fprop", "conv fprop")):
        if key in low:
            return stage
    if any(k in low for k in ("conv", "cudnn", "xmma", "gemm", "implicit", "cutlass")):
        return "conv (other cuDNN kernels)"
    if "max_pool" in low:
        return "max pool"
    prefix = "autograd::engine::evaluate_function:"
    nodes = [a[len(prefix):].strip() for a in ancestors if a.startswith(prefix)]
    model_nodes = ("Convolution", "BatchNorm", "LeakyRelu", "Cat", "ToCopy", "MaxPool",
                   "AccumulateGrad", "Upsample")
    if "loss" in ancestors or any(not any(m in n for m in model_nodes) for n in nodes):
        return "loss (BCEDice, forward+backward)"
    if "reduce_kernel" in low and any("Convolution" in n for n in nodes):
        return "conv bias gradients (reductions)"
    if "copy" in low:
        return "casts and copies (bf16/float32, layout)"
    return "glue (bias add, LeakyReLU, concat, other elementwise)"


def profile_train_epoch(torch, trainer, epoch: int, unprofiled_s: float,
                        tag: str = "train") -> None:
    """One profiled training epoch (after the timed ones): device time by
    stage and the device's idle share, of the profiled pass's wall time (the
    profiler's own overhead lengthens it) and of ``unprofiled_s``, the best
    unprofiled epoch's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.model.train()
        trainer._iterate_train(epoch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    # device time per kernel name, from the device events; the device copies
    # of record_function ranges ('loss', 'augment', the optimizer step) are
    # spans over other kernels, not work
    by_name = {}
    for ev in events:
        if (ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False)
                or ev.name in ("loss", "augment")
                or ev.name.startswith(("Optimizer.", "ProfilerStep"))):
            continue
        total, count = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (total + ev.time_range.elapsed_us(), count + 1)
    # stages: each CPU op's kernels with the op's ancestors; what no op
    # launched (K4, through ctypes) is classified by its name alone
    by_stage, attributed = {}, {}
    for ev in events:
        if ev.device_type != DeviceType.CPU or not ev.kernels:
            continue
        ancestors, p = [], ev
        while p is not None:
            ancestors.append(p.name)
            p = p.cpu_parent
        for k in ev.kernels:
            stage = _stage(k.name, ancestors)
            by_stage[stage] = by_stage.get(stage, 0.0) + k.duration
            attributed[k.name] = attributed.get(k.name, 0.0) + k.duration
    for name, (total, _) in by_name.items():
        rest = total - attributed.get(name, 0.0)
        if rest > 0.5:
            stage = _stage(name, [])
            by_stage[stage] = by_stage.get(stage, 0.0) + rest
    busy = sum(by_stage.values())
    if busy == 0:
        log(f"[{tag}] profiler saw no device time: breakdown not measured")
        return
    n_kernels = sum(count for _, count in by_name.values())
    steps = (trainer._n_train if trainer._device_data is not None
             else len(trainer.train_loader.dataset)) // trainer.batch_size
    log(f"[{tag}] profiled epoch ({epoch}, profiler on): wall {wall_us / 1e3:.2f} ms, device "
        f"busy {busy / 1e3:.2f} ms ({busy / 1e3 / max(steps, 1):.3f} ms a step of {steps}), "
        f"idle share {1 - busy / wall_us:.4f}; against the best "
        f"unprofiled epoch ({unprofiled_s * 1e3:.2f} ms) {1 - busy / (unprofiled_s * 1e6):.4f}; "
        f"{sum(attributed.values()) / 1e3:.2f} ms of it attributed through CPU ops; "
        f"{n_kernels} device kernels")
    for stage, us in sorted(by_stage.items(), key=lambda kv: -kv[1]):
        log(f"[{tag}]   {us / 1e3:9.3f} ms ({us / busy:6.1%})  {stage}")
    for name, (total, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        log(f"[{tag}]   {total / 1e3:9.3f} ms {count:5d}x  {name[:110]}")
    for label, key in (("K4", "augment_batch<"), ("K4h", "augment_heads<"),
                       ("K4v", "augment_volume<"), ("K4hv", "augment_heads_volume<"),
                       ("K6", "xcorr<"), ("K6b-in", "xcorr_grad_input<"),
                       ("K6b-k", "xcorr_grad_kernel<")):
        hits = [(t, c) for name, (t, c) in by_name.items() if key in name]
        if hits:
            total, count = map(sum, zip(*hits))
            log(f"[{tag}] {label} in the step: {count} launches, {total / count / 1e3:.4f} ms "
                f"device time each (warm L2, profiler on)")


def predict_trained(torch, ckpt: str, counters, tag: str = "train") -> None:
    """The trained checkpoint through the port's ``Predict`` on a 16-frame
    blob movie of 512²: the mask IoU against the blob truth."""
    from bio_image_unet_tpu_torch.predict import Predict
    from bio_image_unet_tpu_torch.utils.synth import blob_sample

    rng = np.random.default_rng(7)
    frames = [blob_sample(rng, (512, 512), n_blobs=40, margin=16, radius=(8, 20))
              for _ in range(CHUNK)]
    movie = np.stack([f[0] for f in frames])
    truth = np.stack([f[1] for f in frames]) > 0
    before = {id(c): c.launches for c in counters.values()}
    res = Predict(movie, None, ckpt, resize_dim=(TILE, TILE), show_progress=False,
                  half_precision=True).result
    torch.cuda.synchronize()
    if res.shape != movie.shape or res.dtype != np.uint8:
        raise AssertionError(f"Predict on the trained model: {res.shape} {res.dtype}")
    pred = res > 127
    iou = float((pred & truth).sum() / max((pred | truth).sum(), 1))
    ran = [c.__name__ for c in counters.values() if c.launches > before[id(c)]]
    log(f"[{tag}→predict] trained .pt through Predict on 16×512² blobs: mask IoU {iou:.4f} "
        f"(foreground {truth.mean():.4f} of pixels, predicted {pred.mean():.4f}); "
        f"kernels launched: {', '.join(ran)}")


def train_card_vs_cpu(torch, network: str = "Unet", n_filter: int = 8,
                      tag: str = "train") -> None:
    """``network`` (``Unet(n_filter=8)``) on 15 blob tiles of 64² (12
    training: 3 steps of 4), float32 with TF32 off, no augmentation, one
    epoch: the card's ``metrics.csv`` rows against the CPU's, rtol 1e-3."""
    from bio_image_unet_tpu_torch.train import Trainer
    from bio_image_unet_tpu_torch.utils.synth import blob_sample

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(3)
    items = []
    for _ in range(15):
        img, mask = blob_sample(rng, (64, 64))
        items.append({"image": (img / 255.0).astype(np.float32)[None],
                      "mask": (mask / 255.0).astype(np.float32)[None]})
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dev in ("cuda", "cpu"):
            t = Trainer(items, 1, network=network, n_filter=n_filter, batch_size=4,
                        lr=TRAIN_LR, save_dir=str(Path(tmp) / dev), seed=0, device=dev)
            t.start()
            rows[dev] = metrics_rows(Path(tmp) / dev)[:, 1:]
    rel = np.abs(rows["cuda"] - rows["cpu"]) / np.abs(rows["cpu"])
    log(f"[{tag}] card vs CPU ({network}(n_filter={n_filter}), 64², float32, TF32 off, "
        f"1 epoch): card "
        f"{rows['cuda'].tolist()}, CPU {rows['cpu'].tolist()}, max relative difference "
        f"{rel.max():.2e}")
    if not rel.max() <= 1e-3:
        raise AssertionError("the card's training run disagrees with the CPU's")


# --- 6b–6d. checkpoints in the JAX package's format, resume, remat, profile ----------

def phase_checkpoints(torch, dev, kernels, trained: bytes) -> None:
    from bio_image_unet_tpu_torch import checkpoint
    from bio_image_unet_tpu_torch.interop.opt_state import param_names
    from bio_image_unet_tpu_torch.ops import histogram as hist
    from bio_image_unet_tpu_torch.ops.stitch import sigmoid_stitch
    from bio_image_unet_tpu_torch.predict import Predict
    from bio_image_unet_tpu_torch.predict.normalize import normalize_tile
    from bio_image_unet_tpu_torch.predict.predictor import _Engine

    counters = list({id(k["_counter"]): k["_counter"] for k in kernels}.values())
    with tempfile.TemporaryDirectory() as tmp:
        pt, ck = Path(tmp) / "model.pt", Path(tmp) / "model.ckpt"
        pt.write_bytes(trained)
        state = checkpoint.load(str(pt))
        if state["optimizer_state_dict"] is None:
            raise AssertionError("[train]'s checkpoint holds no Adam state")
        checkpoint.save_native(str(ck), state["state_dict"], state["hyperparams"],
                               epoch=state["epoch"], best_loss=state["best_loss"],
                               optimizer_state=state["optimizer_state_dict"])
        back = checkpoint.load(str(ck))
        for key, v in state["state_dict"].items():
            w = back["state_dict"][key]
            if v.dtype != w.dtype or not torch.equal(v, w):
                raise AssertionError(f"[checkpoints] {key} differs after the BIUTPU01 round trip")
        ours, theirs = state["optimizer_state_dict"], back["optimizer_state_dict"]
        by_name = [dict(zip(param_names(st["state_dict"]), (o["state"][i] for i in
                                                             range(len(o["state"])))))
                   for st, o in ((state, ours), (back, theirs))]
        if sorted(by_name[0]) != sorted(by_name[1]):
            raise AssertionError("[checkpoints] the Adam states cover other parameters")
        for name, moments in by_name[0].items():
            for key in ("exp_avg", "exp_avg_sq", "step"):
                if not torch.equal(moments[key], by_name[1][name][key]):
                    raise AssertionError(f"[checkpoints] Adam {key} of {name} differs")
        lr = theirs["param_groups"][0]["lr"]
        if lr != float(np.float32(ours["param_groups"][0]["lr"])):
            raise AssertionError(f"[checkpoints] Adam's lr {lr} after the round trip")
        header = {"format": 1, "hyperparams": json.loads(json.dumps(state["hyperparams"])),
                  "epoch": state["epoch"], "best_loss": state["best_loss"],
                  "has_opt_state": True}
        if checkpoint.peek(str(ck)) != header:
            raise AssertionError(f"[checkpoints] peek {checkpoint.peek(str(ck))} is not the "
                                 f"header {header}")
        log(f"[checkpoints] trained Unet({N_FILTER}) .pt → BIUTPU01 → load: "
            f"{len(state['state_dict'])} tensors bit-equal, "
            f"Adam's moments and step of {len(ours['state'])} parameters bit-equal, "
            f"peek equal to the header")

        movie = np.random.default_rng(0).integers(0, 255, (FRAMES, H, W), dtype=np.uint8)
        kw = dict(resize_dim=(TILE, TILE), show_progress=False, batch_size=8,
                  half_precision=True)
        chunks = FRAMES // CHUNK
        expect = {hist.int_clip_bounds: hist.LAUNCHES[torch.uint8] * chunks,
                  normalize_tile: chunks, sigmoid_stitch: chunks}
        paths = {"ckpt": ck, "pt": pt}
        results, best = {}, {name: float("inf") for name in paths}
        for _ in range(2):
            for name, path in paths.items():
                t0 = time.perf_counter()
                res, _ = counted(torch, "checkpoints", counters, f"Predict from the .{name}",
                                 lambda: Predict(movie, None, str(path), **kw).result, expect)
                best[name] = min(best[name], time.perf_counter() - t0)
                results[name] = res
        if results["ckpt"].shape != movie.shape or results["ckpt"].dtype != np.uint8:
            raise AssertionError(f"[checkpoints] Predict gave {results['ckpt'].shape} "
                                 f"{results['ckpt'].dtype}")
        if not np.array_equal(results["ckpt"], results["pt"]):
            diff = np.abs(results["ckpt"].astype(int) - results["pt"].astype(int))
            raise AssertionError(f"[checkpoints] the masks from the .ckpt and the .pt differ "
                                 f"(max {diff.max()} levels on {np.mean(diff > 0):.6f})")
        setup, decode = {}, {}
        for name, path in paths.items():
            setup[name] = decode[name] = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                checkpoint.load(str(path))
                decode[name] = min(decode[name], time.perf_counter() - t0)
                t0 = time.perf_counter()
                _Engine(str(path), None, batch_size=8, half_precision=True, device=dev)
                torch.cuda.synchronize()
                setup[name] = min(setup[name], time.perf_counter() - t0)
        for name, path in paths.items():
            log(f"[checkpoints] .{name}: Predict {FRAMES}×{H}×{W} uint8 "
                f"{FRAMES * H * W / 1e6 / best[name]:.2f} MP/s end to end (best of 2, "
                f"{best[name]:.3f} s); engine set-up (load, fold, upload) {setup[name]:.4f} s, "
                f"checkpoint.load alone {decode[name]:.4f} s (best of 3); file "
                f"{path.stat().st_size} bytes")
        log("[checkpoints] masks from the .ckpt and the .pt byte-equal")


def phase_train_resume(torch, dev, kernels) -> None:
    from bio_image_unet_tpu_torch import checkpoint
    from bio_image_unet_tpu_torch.data.augment_device import augment_apply

    counters = list({id(k["_counter"]): k["_counter"] for k in kernels}.values())
    torch.backends.cudnn.allow_tf32 = True  # the user's default
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data = config2_data(tmp)
        first = config2_trainer(data, tmp / "first", 2, save_name="model.ckpt")
        steps = first._n_train // TRAIN_BATCH
        counted(torch, "train resume", counters, f"Unet({N_FILTER}) 2 epochs of {steps} steps",
                first.start, {augment_apply: 2 * steps})
        ck = tmp / "first" / "model.ckpt"
        head = checkpoint.peek(str(ck))
        state = checkpoint.load(str(ck))
        pt = tmp / "state.pt"
        checkpoint.save(str(pt), state["state_dict"], state["hyperparams"],
                        epoch=state["epoch"], best_loss=state["best_loss"],
                        optimizer_state=state["optimizer_state_dict"])
        log(f"[train resume] model.ckpt: epoch {head['epoch']}, best loss "
            f"{head['best_loss']:.6f}, Adam state {head['has_opt_state']}, scheduler "
            f"{head['hyperparams']['scheduler_state']}; {ck.stat().st_size} bytes "
            f"(the .pt {pt.stat().st_size})")
        rows, trainers = {}, {}
        for name, path in (("ckpt", ck), ("pt", pt)):
            out = tmp / f"resumed_{name}"
            t = config2_trainer(data, out, 1, load_weights=str(path), save_name=f"model.{name}")
            if t.epoch_start != state["epoch"]:
                raise AssertionError(f"[train resume] .{name}: resumed at epoch "
                                     f"{t.epoch_start}, the file says {state['epoch']}")
            trainers[name] = t
            counted(torch, "train resume", counters, f"1 epoch resumed from the .{name}",
                    t.start, {augment_apply: steps})
            rows[name] = metrics_rows(out)
        a, b = (trainers[n].optimizer.state_dict() for n in ("ckpt", "pt"))
        log(f"[train resume] resumed rows (epoch, train loss, val loss, lr): .ckpt "
            f"{rows['ckpt'].tolist()}, .pt {rows['pt'].tolist()}; first run "
            f"{metrics_rows(tmp / 'first').tolist()}")
        rel = np.abs(rows["ckpt"][:, 1:] - rows["pt"][:, 1:]) / np.abs(rows["pt"][:, 1:])
        log(f"[train resume] .ckpt vs .pt resumed rows: max relative difference "
            f"{rel.max():.2e}; Adam steps after the resume {a['state'][0]['step'].item():g} "
            f"and {b['state'][0]['step'].item():g}")
        if not rel.max() <= 1e-3:
            raise AssertionError("[train resume] the runs resumed from the .ckpt and the .pt "
                                 "disagree")
        first_loss = first.history[0]["train_loss"]
        for name, t in trainers.items():
            if not t.history[0]["train_loss"] < first_loss:
                raise AssertionError(f"[train resume] .{name}: resumed loss "
                                     f"{t.history[0]['train_loss']} not below the first "
                                     f"epoch's {first_loss}")


TRACE_CONV = ("conv", "cudnn", "xmma", "gemm", "sm90", "implicit", "cutlass", "fprop", "dgrad",
              "wgrad")


def phase_train_options(torch, dev, kernels) -> None:
    from bio_image_unet_tpu_torch.data.augment_device import augment_apply

    counters = list({id(k["_counter"]): k["_counter"] for k in kernels}.values())
    torch.backends.cudnn.allow_tf32 = True  # the user's default
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data = config2_data(tmp)
        rows, peak, step, warm = {}, {}, {}, {}
        for remat in (False, True):
            out = tmp / f"remat{int(remat)}"
            t = config2_trainer(data, out, 1, remat=remat)
            steps = t._n_train // TRAIN_BATCH
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            counted(torch, "train options", counters, f"1 epoch, remat={remat}", t.start,
                    {augment_apply: steps})
            peak[remat] = torch.cuda.max_memory_allocated()
            step[remat] = t.history[0]["train_seconds"] / steps
            rows[remat] = metrics_rows(out)
            # a second training pass, timed alone: the step once warm
            t0 = time.perf_counter()
            t.model.train()
            t._iterate_train(1)
            torch.cuda.synchronize()
            warm[remat] = (time.perf_counter() - t0) / steps
            if remat:
                profile_train_epoch(torch, t, 2, warm[remat] * steps, tag="train options remat")
            del t
        rel = np.abs(rows[True][:, 1:] - rows[False][:, 1:]) / np.abs(rows[False][:, 1:])
        log(f"[train options] remat=True rows {rows[True].tolist()}, remat=False "
            f"{rows[False].tolist()}: max relative difference {rel.max():.2e}")
        log(f"[train options] peak device memory (reset before each run): remat "
            f"{peak[True] / 2**30:.3f} GiB, plain {peak[False] / 2**30:.3f} GiB; step over "
            f"the {steps} steps of the run's epoch: remat {step[True] * 1e3:.2f} ms, plain "
            f"{step[False] * 1e3:.2f} ms; of a second pass: remat {warm[True] * 1e3:.2f} ms, "
            f"plain {warm[False] * 1e3:.2f} ms ({warm[True] / warm[False]:.3f}x)")
        if not rel.max() <= 1e-3:
            raise AssertionError("[train options] remat=True and remat=False disagree")

        t = config2_trainer(data, tmp / "profiled", 1, profile_dir=str(tmp / "trace"))
        counted(torch, "train options", counters, "1 epoch with profile_dir", t.start,
                {augment_apply: steps})
        files = sorted((tmp / "trace").iterdir())
        if len(files) != 1 or [str(f) for f in files] != t.trace_paths:
            raise AssertionError(f"[train options] profile_dir holds {files}, want the one "
                                 f"trace {t.trace_paths}")
        k4, conv = read_trainer_trace(files[0], "train options")
        if len(k4) != steps or not conv:
            raise AssertionError(f"[train options] the trace holds K4 {len(k4)} times (want "
                                 f"{steps}) and {len(conv)} convolution kernels")


def read_trainer_trace(path: Path, tag: str) -> tuple:
    """The K4 and convolution kernels of a Trainer's ``profile_dir`` trace,
    logged with, for each ``augment`` range on the host (K4's wrapper runs
    in one a step), the kernel launches the range holds and the K4 kernels
    they reached: where a trace lacks a K4, whether the launch or only its
    kernel went missing."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = [e.get("name", "") for e in kernels]
    k4 = [n for n in names if "augment_batch" in n]
    conv = [n for n in names if any(c in n.lower() for c in TRACE_CONV)]
    log(f"[{tag}] profile_dir trace {path.name}: {path.stat().st_size} bytes, "
        f"{len(events)} events, {len(names)} kernels, K4 {len(k4)}, convolution kernels "
        f"{len(conv)}")
    by_corr = {e.get("args", {}).get("correlation"): e for e in kernels}
    launches = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "LaunchKernel" in e.get("name", "")]
    ranges = sorted((e for e in events if e.get("cat") == "user_annotation"
                     and e.get("name") == "augment"), key=lambda e: e["ts"])
    t0 = min((e["ts"] for e in events if "ts" in e and e.get("ph") == "X"), default=0)
    steps = []
    for r in ranges:
        inside = [e for e in launches if r["ts"] <= e["ts"] <= r["ts"] + r.get("dur", 0)]
        reached = [by_corr[c] for c in (e.get("args", {}).get("correlation") for e in inside)
                   if c in by_corr and "augment_batch" in by_corr[c].get("name", "")]
        steps.append(f"{r['ts'] - t0:.0f} us: {len(inside)} launches, K4 "
                     + (f"at {reached[0]['ts'] - t0:.0f} us" if reached else "none"))
    first = min((e["ts"] for e in kernels), default=t0)
    log(f"[{tag}] trace's augment ranges ({len(ranges)}; first device kernel at "
        f"{first - t0:.0f} us): " + "; ".join(steps))
    return k4, conv


def probe_trainer_traces(torch) -> None:
    """``chip_smoke.py --probe-trace``: the ``[train options]`` trainer's
    ``profile_dir`` trace, read as ``[train options]`` reads it, in one
    process: four runs with no profiler before them, one profiled epoch,
    eight runs after it, and four runs whose profiler is followed by a
    device synchronize before the epoch starts."""
    from bio_image_unet_tpu_torch.data.augment_device import augment_apply
    from bio_image_unet_tpu_torch.train.trainer import Trainer

    torch.backends.cudnn.allow_tf32 = True
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data = config2_data(tmp)

        def traced(i, tag):
            t = config2_trainer(data, tmp / f"run{i}", 1, profile_dir=str(tmp / f"trace{i}"))
            steps = t._n_train // TRAIN_BATCH
            augment_apply.launches = 0
            t.start()
            torch.cuda.synchronize()
            k4, _ = read_trainer_trace(Path(t.trace_paths[0]), tag)
            log(f"[{tag}] K4 launched {augment_apply.launches} times for {steps} steps, "
                f"the trace holds {len(k4)}")

        for i in range(4):
            traced(i, f"probe {i} before any profiler")
        t = config2_trainer(data, tmp / "epoch", 1)
        t.start()
        t0 = time.perf_counter()
        t.model.train()
        t._iterate_train(1)
        torch.cuda.synchronize()
        profile_train_epoch(torch, t, 2, time.perf_counter() - t0, tag="probe epoch")
        del t
        for i in range(4, 12):
            traced(i, f"probe {i} after a profiled epoch")
        start = Trainer._start_profiler

        def start_and_sync(self):
            prof = start(self)
            torch.cuda.synchronize(self.device)
            return prof

        Trainer._start_profiler = start_and_sync
        try:
            for i in range(12, 16):
                traced(i, f"probe {i} synchronized after the profiler's start")
        finally:
            Trainer._start_profiler = start


# --- 7. kernels of the multi-head path ---------------------------------------------

# benchmarks/family_bench.py's multi-output configuration (MO_HEADS, :43-48)
MO_HEADS = {"mask": {"channels": 1, "activation": "sigmoid"},
            "orientation": {"channels": 2, "activation": None}}
HEADS_FRAMES, HEADS_PATCH, HEADS_MARGIN, HEADS_FILTER = 40, 512, 20, 32
HEADS_CLIP = (0.0, 99.98)  # PredictMultiOutput's default clip_threshold


def phase_kernels_heads(torch, dev) -> list:
    """K2h, K5 and K5s at the shapes of the multi-head path: a 16-frame chunk
    of 1024² uint8 frames in 512² tiles (64 tiles, UNet++'s forward batch of
    16 divides it), bf16 tiles, heads of 1 and 2 channels, margin 20."""
    import torch.nn.functional as F
    from bio_image_unet_tpu_torch.ops import histogram as hist
    from bio_image_unet_tpu_torch.ops.stitch import (margin_stitch, margin_stitch_plain,
                                                      tile_sum, tile_sum_plain)
    from bio_image_unet_tpu_torch.predict.normalize import (normalize_tile_float,
                                                            normalize_tile_plain)
    from bio_image_unet_tpu_torch.predict.tiling import TilePlan, _margin_factors, grid_starts
    from bio_image_unet_tpu_torch.utils.kernel_ab_times import offset_view

    timer = Timer(torch, dev)
    g = torch.Generator(device=dev).manual_seed(1)
    P = HEADS_PATCH
    xs, ys = grid_starts(H, P), grid_starts(W, P)
    plan = TilePlan(H, W, P, P, xs, ys, dev,
                    _margin_factors((len(xs), len(ys)), (P, P), HEADS_MARGIN))
    n = CHUNK * plan.per_frame
    rows = []

    def row(*args):
        rows.append(kernel_row("kernels heads", *args))

    x = torch.randint(0, 256, (CHUNK, H, W), generator=g, device=dev,
                      dtype=torch.int32).to(torch.uint8)
    bounds = hist.clip_bounds(x, *HEADS_CLIP)
    ours = normalize_tile_float(x, bounds, plan, n, torch.bfloat16)
    torch.cuda.synchronize()
    ref = normalize_tile_plain(x, bounds, plan, n, False, torch.bfloat16)
    if not torch.equal(ours.view(torch.int16), ref.view(torch.int16)):
        raise AssertionError("K2h: kernel differs from its plain version")
    row("k2h_normalize_tile_float[uint8->bf16]",
        "bio_image_unet_tpu_torch/csrc/normalize_tile.cu",
        "bio_image_unet_tpu/predict/predictor.py:1101", normalize_tile_float,
        (ours.float() - ref.float()).abs().max().item(),
        timer(lambda: normalize_tile_float(x, bounds, plan, n, torch.bfloat16)),
        timer(lambda: normalize_tile_plain(x, bounds, plan, n, False, torch.bfloat16), 3),
        # read each source pixel once, write each bf16 tile pixel once; about
        # five float operations per tile pixel (clip, subtract, divide, scale)
        bound_ms(x.numel() + bounds.numel() * 4 + n * P * P * 2, 5 * n * P * P), None)
    del x, ours, ref

    for c in (1, 2):
        tiles = (torch.rand((n, c, P, P), generator=g, device=dev) * 4 - 2).half()
        for out_dtype, view in ((torch.float16, torch.int16), (torch.float32, torch.int32)):
            ours = margin_stitch(tiles, CHUNK, plan, out_dtype)
            torch.cuda.synchronize()
            ref = margin_stitch_plain(tiles, CHUNK, plan, out_dtype)
            if not torch.equal(ours.view(view), ref.view(view)):
                raise AssertionError(f"K5 c={c} {out_dtype}: kernel differs from plain")
        # the library call: F.fold of the weighted tiles, the weighted sum of
        # this regular (stride = tile) grid; the division and the float16
        # rounding are not in it
        fx, fy = plan.fx_t, plan.fy_t
        wt = torch.stack([torch.minimum(fx[i][:, None], fy[j][None, :])
                          for i in range(plan.nx) for j in range(plan.ny)])
        cols = ((tiles.float().reshape(CHUNK, plan.per_frame, c, P, P) * wt[None, :, None])
                .permute(0, 2, 3, 4, 1).reshape(CHUNK, c * P * P, plan.per_frame).contiguous())
        out_px = CHUNK * c * H * W
        row(f"k5_margin_stitch[c={c}]", "bio_image_unet_tpu_torch/csrc/margin_stitch.cu",
            "bio_image_unet_tpu/ops/stitch.py:163", margin_stitch, 0.0,
            timer(lambda: margin_stitch(tiles, CHUNK, plan, torch.float16)),
            timer(lambda: margin_stitch_plain(tiles, CHUNK, plan, torch.float16), 3),
            # read each real tile value once (float16) and write each output
            # pixel once (float16); per tile value a min, a multiply and two
            # adds, per output pixel a divide
            bound_ms(n * c * P * P * 2 + out_px * 2, 4 * n * c * P * P + out_px),
            timer(lambda: F.fold(cols, (H, W), (P, P), stride=(P, P)), 5))
        del cols, wt
        total = tile_sum(tiles, n)
        torch.cuda.synchronize()
        want = tile_sum_plain(tiles, n)
        count = n * c * P * P
        fill, want_fill = (np.float16(np.float32(v.item() / count)) for v in (total, want))
        ulps = abs(int(fill.view(np.int16)) - int(want_fill.view(np.int16)))
        if ulps > 1:
            raise AssertionError(f"K5s c={c}: fill {fill} vs plain {want_fill} ({ulps} ulps)")
        log(f"[kernels heads] k5s_tile_sum[c={c}]: sum {total.item()!r} vs plain "
            f"{want.item()!r}; fill {fill} vs {want_fill} ({ulps} float16 ulps)")
        row(f"k5s_tile_sum[c={c}]", "bio_image_unet_tpu_torch/csrc/margin_stitch.cu",
            "bio_image_unet_tpu/predict/predictor.py:1133", tile_sum,
            abs(total.item() - want.item()),
            timer(lambda: tile_sum(tiles, n)), timer(lambda: tile_sum_plain(tiles, n), 3),
            # read each real tile value once, one add each
            bound_ms(count * 2, count),
            timer(lambda: torch.sum(tiles, dtype=torch.float64), 5))
        del tiles, ours, ref

    # K5 where its 16-byte reads and stores cannot all be aligned: 1000x1003
    # frames (column starts 0 and 491, rows of 1003 values) and the main
    # grid's tiles viewed at an odd float16 offset, in both out types
    xs2, ys2 = grid_starts(1000, P), grid_starts(1003, P)
    oplan = TilePlan(1000, 1003, P, P, xs2, ys2, dev,
                     _margin_factors((len(xs2), len(ys2)), (P, P), HEADS_MARGIN))
    for what, tiles, pl in (
            ("starts 0, 491 on 1000x1003 frames",
             (torch.rand((CHUNK * oplan.per_frame, 2, P, P), generator=g, device=dev) * 4 - 2
              ).half(), oplan),
            ("tiles at an odd float16 offset",
             offset_view(torch, (torch.rand((n, 2, P, P), generator=g, device=dev) * 4 - 2
                                 ).half(), 1), plan)):
        for out_dtype, view in ((torch.float16, torch.int16), (torch.float32, torch.int32)):
            ours = margin_stitch(tiles, CHUNK, pl, out_dtype)
            torch.cuda.synchronize()
            ref = margin_stitch_plain(tiles, CHUNK, pl, out_dtype)
            if not torch.equal(ours.view(view), ref.view(view)):
                raise AssertionError(f"K5 {what} {out_dtype}: kernel differs from plain")
        log(f"[kernels heads] k5_margin_stitch, c=2, {what}: bit-equal to plain in float16 and "
            f"float32 | kernel {timer(lambda: margin_stitch(tiles, CHUNK, pl)):.4f} ms")
        del tiles, ours, ref
    torch.cuda.empty_cache()
    return rows


# --- 8. the multi-head path ------------------------------------------------------

def nested_unet_forward_flops(nf: int, s: int, levels: int = 4, out_channels: int = 3) -> float:
    """Multiply-add FLOPs of one s² tile through ``MultiOutputNestedUNet``:
    the two 3×3 convs of every VGG block of the dense grid (column x_{i,0}
    takes nb[i-1] channels, x_{i,j} takes nb[i]·j + nb[i+1]) and the 1×1
    heads; the bilinear upsampling is not counted."""
    nb = [nf * 2 ** i for i in range(levels + 1)]

    def vgg(ci, co, hw):
        return 2 * 9 * (ci * co + co * co) * hw

    f = 0.0
    for i in range(levels + 1):
        hw = s * s / 4 ** i
        f += vgg(1 if i == 0 else nb[i - 1], nb[i], hw)
        for j in range(1, levels + 1 - i):
            f += vgg(nb[i] * j + nb[i + 1], nb[i], hw)
    return f + 2 * nf * out_channels * s * s


def counted(torch, tag: str, counters, what: str, call, expect: dict):
    """``call()`` with every launch count 0 just before and read just after;
    each kernel must have launched exactly as ``expect`` says (kernels it
    does not name: never)."""
    for c in counters:
        c.launches = 0
    out = call()
    torch.cuda.synchronize()
    got = {c: c.launches for c in counters}
    log(f"[{tag}] launches, {what}: " + ", ".join(f"{c.__name__} {n}" for c, n in got.items()))
    for c, n in got.items():
        if n != expect.get(c, 0):
            raise AssertionError(f"{what}: {c.__name__} launched {n} times, "
                                 f"want {expect.get(c, 0)}")
    return out, got


def plus(expect: dict, extra: dict) -> dict:
    """``expect`` with ``extra``'s launches added (a quantized call's
    calibration: K1 and K2h, or K2v, on its sampled frames or volumes)."""
    out = dict(expect)
    for c, n in extra.items():
        out[c] = out.get(c, 0) + n
    return out



def check_heads(name: str, res: dict, shape) -> None:
    for head, cfg in MO_HEADS.items():
        want = shape if cfg["channels"] == 1 else (shape[0], cfg["channels"]) + shape[1:]
        r = res[head]
        if r.shape != tuple(want) or r.dtype != np.float32 or not np.isfinite(r).all():
            raise AssertionError(f"{name} {head}: {r.shape} {r.dtype}, want {want} float32 "
                                 "and finite")


def phase_heads(torch, dev, kernels, heads) -> None:
    from bio_image_unet_tpu_torch.ops import histogram as hist
    from bio_image_unet_tpu_torch.ops.stitch import margin_stitch, tile_sum
    from bio_image_unet_tpu_torch.predict import PredictMultiOutput
    from bio_image_unet_tpu_torch.predict.normalize import normalize_tile_float
    from bio_image_unet_tpu_torch.predict.predictor import _Engine
    from bio_image_unet_tpu_torch.predict.tiling import _margin_factors, grid_starts

    torch.backends.cudnn.allow_tf32 = True  # the user's default
    counters = list({id(k["_counter"]): k["_counter"] for k in kernels + heads}.values())
    P = HEADS_PATCH
    rng = np.random.default_rng(2)
    movie = rng.integers(0, 255, (HEADS_FRAMES, H, W), dtype=np.uint8)
    movie_u16 = rng.integers(0, 65535, (CHUNK, 1000, 1000), dtype=np.uint16)
    movie_f32 = (rng.standard_normal((CHUNK, 1000, 500)) * 40 + 5).astype(np.float32)
    kw = dict(max_patch_size=(P, P), half_precision=True, safe_margin=HEADS_MARGIN,
              show_progress=False)
    main = "UNet++ uint8 40x1024^2 exact (family_bench)"
    # the main movie runs in 3 chunks (16 + 16 + a tail of 8); per chunk K1
    # launches one radix pass per key byte (hist.LAUNCHES: 1 for uint8),
    # K2h once, K5 and K5s once per head (the exact grid leaves pixels
    # uncovered, so K5s runs); the host-staged path launches K5 and K5s only
    # (it normalizes and tiles on the host)
    n_chunks, n_heads = -(-HEADS_FRAMES // CHUNK), len(MO_HEADS)
    fused_expect = {hist.int_clip_bounds: hist.LAUNCHES[torch.uint8] * n_chunks,
                    normalize_tile_float: n_chunks, margin_stitch: n_chunks * n_heads,
                    tile_sum: n_chunks * n_heads}
    host_expect = {margin_stitch: n_chunks * n_heads, tile_sum: n_chunks * n_heads}

    def max_diff(a, b) -> dict:
        return {h: float(np.abs(a[h] - b[h]).max()) for h in MO_HEADS}

    def fmt(d: dict) -> str:
        return ", ".join(f"{h} {v:.3e}" for h, v in d.items())

    with tempfile.TemporaryDirectory() as tmp:
        nested = str(Path(tmp) / "nested_nf32.pt")
        write_checkpoint(torch, nested, "MultiOutputNestedUNet", HEADS_FILTER,
                         output_heads=MO_HEADS)
        mo = str(Path(tmp) / "mo_unet_nf32.pt")
        write_checkpoint(torch, mo, "MultiOutputUnet", HEADS_FILTER, seed=1,
                         output_heads=MO_HEADS)

        # the main path, fused: a warm-up call and two timed calls, each
        # counted on its own
        torch.cuda.reset_peak_memory_stats()
        best = float("inf")
        for rep in ("warm-up", "timed 1", "timed 2"):
            t0 = time.perf_counter()
            res, got = counted(torch, "heads", counters, f"{main}, {rep}",
                               lambda: PredictMultiOutput(movie, nested, **kw).result,
                               fused_expect)
            if rep != "warm-up":
                best = min(best, time.perf_counter() - t0)
        results = {main: res}
        peak = torch.cuda.max_memory_allocated()
        check_heads(main, res, movie.shape)
        for k in heads:
            k["launches"] = got[k["_counter"]]
        log(f"[heads] K1 on the multi-head path: {got[hist.int_clip_bounds]} launches "
            "(its JSON entry counts the Predict path)")

        # the main path, host-staged, at the fused path's forward batch (16):
        # the JAX package's fused-vs-host contract, atol 2e-3 on every head
        # and pixel, fill included (at the default batch of 8 cuDNN picks
        # other bf16 algorithms and the heads move by up to 6e-2)
        t0 = time.perf_counter()
        engine = _Engine(nested, None, batch_size=8, half_precision=True, device=dev)
        t_engine = time.perf_counter() - t0
        bs = engine.heads_batch(CHUNK * (H // P) * (W // P), P, P)
        host, _ = counted(torch, "heads", counters, f"{main}, host-staged at batch {bs}",
                          lambda: PredictMultiOutput(movie, nested, device_pipeline=False,
                                                     batch_size=bs, **kw).result,
                          host_expect)
        check_heads(main + " host", host, movie.shape)
        diff = max_diff(res, host)
        log(f"[heads] {main}: {best:.3f} s end to end "
            f"({HEADS_FRAMES * H * W / 1e6 / best:.2f} MP/s); bf16 fused vs host-staged at "
            f"batch {bs}, every pixel: max {fmt(diff)}; "
            + ", ".join(f"{h} mean {res[h].mean():.4f} std {res[h].std():.4f}"
                        for h in MO_HEADS))
        if max(diff.values()) > 2e-3:
            raise AssertionError(f"{main}: fused and host-staged paths differ beyond "
                                 "atol 2e-3")
        del host

        # coverage: the plain trunk on an overlapping grid, a reflect-padded
        # float32 movie with fixed bounds; fused against host-staged logged
        for name, ckpt, imgs, extra in (
                ("MultiOutputUnet uint16 16x1000^2 add_tile=1", mo, movie_u16, {"add_tile": 1}),
                ("UNet++ float32 16x1000x500 'first' (reflect pad)", nested, movie_f32,
                 {"normalization_mode": "first"})):
            t0 = time.perf_counter()
            fused = PredictMultiOutput(imgs, ckpt, **kw, **extra).result
            dt = time.perf_counter() - t0
            check_heads(name, fused, imgs.shape)
            host = PredictMultiOutput(imgs, ckpt, device_pipeline=False, **kw, **extra).result
            check_heads(name + " host", host, imgs.shape)
            log(f"[heads] {name}: {dt:.3f} s end to end "
                f"({imgs.shape[0] * imgs.shape[1] * imgs.shape[2] / 1e6 / dt:.2f} MP/s, one "
                f"call, set-up included); bf16 fused vs host at the default batch max "
                f"{fmt(max_diff(fused, host))}")

        # the fused-vs-host contract in float32 (TF32 off), the precision the
        # JAX package holds it in: the full-width UNet++ on 16 frames
        torch.backends.cudnn.allow_tf32 = False
        f32 = dict(kw, half_precision=False)
        fused = PredictMultiOutput(movie[:CHUNK], nested, **f32).result
        host = PredictMultiOutput(movie[:CHUNK], nested, device_pipeline=False, **f32).result
        diff = max_diff(fused, host)
        log(f"[heads] float32 (TF32 off) UNet++ 16x1024^2: fused vs host max {fmt(diff)}")
        if max(diff.values()) > 2e-3:
            raise AssertionError("float32 fused and host paths differ beyond atol 2e-3")
        torch.backends.cudnn.allow_tf32 = True
        del fused, host

        # device-resident: the same chunk program on a movie already on the card
        xs, ys = grid_starts(H, P), grid_starts(W, P)
        factors = _margin_factors((len(xs), len(ys)), (P, P), HEADS_MARGIN)
        fn, n_chunk, plan = engine.heads_runner(H, W, xs, ys, (P, P), HEADS_CLIP, factors,
                                                n_frames=HEADS_FRAMES)
        movie_dev = torch.from_numpy(movie).to(dev)
        real = [min(n_chunk, HEADS_FRAMES - i) for i in range(0, HEADS_FRAMES, n_chunk)]

        def run():
            outs = []
            for i, k in zip(range(0, HEADS_FRAMES, n_chunk), real):
                chunk = movie_dev[i:i + n_chunk]
                if k < n_chunk:  # the tail chunk repeats its last frame
                    chunk = torch.cat([chunk, chunk[-1:].expand(n_chunk - k, H, W)])
                outs.append(fn(chunk, k))
            return outs

        run()
        torch.cuda.synchronize()
        best_dev = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            outs = run()
            torch.cuda.synchronize()
            best_dev = min(best_dev, time.perf_counter() - t0)
        # the same program as PredictMultiOutput's: the covered pixels of all
        # 40 frames must be equal, and so must the fill made from K5s's sums
        covered = torch.from_numpy(~plan.uncovered).to(dev)
        for h, cfg in MO_HEADS.items():
            c = cfg["channels"]
            ours = torch.cat([o[h][:k] for (o, _), k in zip(outs, real)]).float()
            ref = torch.from_numpy(res[h].reshape(HEADS_FRAMES, c, H, W)).to(dev)
            same = (ours - ref).abs()[..., covered].max().item()
            total = sum(float(sums[h]) for _, sums in outs)
            fill = np.float32(total / (HEADS_FRAMES * plan.per_frame * c * P * P))
            fill = np.float32(fill.astype(np.float16))
            fill_ok = bool((res[h].reshape(HEADS_FRAMES, c, H, W)[:, :, plan.uncovered]
                            == fill).all())
            log(f"[heads] device-resident run vs its PredictMultiOutput run, {h}: covered "
                f"pixels max {same:.3e}; fill {fill!r} {'equal' if fill_ok else 'differs'}")
            if same != 0.0 or not fill_ok:
                raise AssertionError(f"{h}: the device-resident chunk program disagrees with "
                                     "PredictMultiOutput")
            del ours, ref
        profile_pass(torch, run, "heads", f"{HEADS_FRAMES} frames",
                     (("K5", "margin_stitch"), ("K5s", "tile_sum")))
        del movie_dev, outs

        mp = HEADS_FRAMES * H * W / 1e6
        e2e, resident = mp / best, mp / best_dev
        tiles_per_mp = len(xs) * len(ys) / (H * W / 1e6)
        flops = nested_unet_forward_flops(HEADS_FILTER, P)
        log(f"[heads] end-to-end {e2e:.2f} MP/s; device-resident {resident:.2f} MP/s; engine "
            f"set-up {t_engine:.3f} s; peak device memory {peak / 2**30:.2f} GiB; "
            f"{flops / 1e9:.1f} GFLOP per {P}² tile → {flops * tiles_per_mp * e2e / 1e12:.1f} "
            f"TFLOP/s end to end ({flops * tiles_per_mp * e2e / PEAK_BF16_FLOPS:.4f} of the "
            f"bf16 dense peak), {flops * tiles_per_mp * resident / 1e12:.1f} TFLOP/s "
            f"device-resident ({flops * tiles_per_mp * resident / PEAK_BF16_FLOPS:.4f})")

        # a small float32 reference: the card's PredictMultiOutput against the
        # CPU's (plain versions of the kernels, CPU convolutions), TF32 off
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        for name, seed, mode, add, m in (
                ("MultiOutputNestedUNet", 3, "single", 0,
                 rng.integers(0, 255, (18, 80, 72), dtype=np.uint8)),
                ("MultiOutputUnet", 4, "all", 1,
                 (rng.standard_normal((3, 100, 90)) * 30).astype(np.float32))):
            small = str(Path(tmp) / f"{name}_nf4.pt")
            write_checkpoint(torch, small, name, 4, seed=seed, output_heads=MO_HEADS)
            skw = dict(max_patch_size=(32, 32), add_tile=add, normalization_mode=mode,
                       safe_margin=4, show_progress=False, batch_size=4)
            on_card = PredictMultiOutput(m, small, **skw).result
            on_cpu = PredictMultiOutput(m, small, device="cpu", **skw).result
            worst = max(float((np.abs(on_card[h] - on_cpu[h])
                               / (1e-3 + 1e-3 * np.abs(on_cpu[h]))).max()) for h in MO_HEADS)
            log(f"[heads] small float32 {name} {m.dtype} '{mode}' add_tile={add}: card vs CPU "
                f"{worst:.3f} of the tolerance 1e-3 + 1e-3·|CPU|")
            if worst > 1.0:
                raise AssertionError("the card's PredictMultiOutput disagrees with the CPU's")



# --- 9. the kernel of the multi-head training path ----------------------------------

# family_bench.py's training heads (MO_HEADS with their losses, :43-48)
MO_TRAIN_HEADS = {"mask": {"channels": 1, "activation": "sigmoid", "loss": "BCEDiceLoss",
                           "weight": 1.0},
                  "orientation": {"channels": 2, "activation": None, "loss": "MSELoss",
                                  "weight": 1.0}}
# 40 frames of 256² at aug_factor 2: 80 tiles, 64 training (16 steps of 4)
MO_FRAMES, MO_BATCH, MO_EPOCHS, MO_LR = 40, 4, 3, 1e-4


def phase_kernel_augment_heads(torch, dev) -> dict:
    """K4h at the multi-output training shapes: 4 of 64 resident 256² tiles,
    image 1 channel, targets mask (1) + orientation (2), the draws the
    Trainer makes; four launches force the 16 (k, flip_h, flip_v) cases
    once each, one of them with a sample gated off."""
    import itertools

    from bio_image_unet_tpu_torch.data.augment_device import (HeadLayout, augment_heads_apply,
                                                              augment_heads_apply_plain, draw)

    timer = Timer(torch, dev)
    g = torch.Generator(device=dev).manual_seed(3)
    n, b, s = 64, MO_BATCH, TILE
    layout = HeadLayout.of({"mask": 1, "orientation": 2}, ("orientation",), dev)
    image = torch.rand((n, 1, s, s), generator=g, device=dev)
    theta = torch.rand((n, 1, s, s), generator=g, device=dev) * 6.2832
    target = torch.cat([(torch.rand((n, 1, s, s), generator=g, device=dev) > 0.5).float(),
                        theta.cos(), theta.sin()], 1).contiguous()
    index = torch.randperm(n, generator=g, device=dev)[:b]

    def ulps(a, ref):
        return (a.view(torch.int32).long() - ref.view(torch.int32).long()).abs().max().item()

    cases = list(itertools.product(range(4), (0, 1), (0, 1)))
    err = 0.0
    for i in range(0, len(cases), b):
        d = draw(g, b, (b, 1, s, s))
        d.flags[:, :4] = torch.tensor([[1, *c] for c in cases[i:i + b]], dtype=torch.int32,
                                      device=dev)
        if i == 0:
            d.flags[0, 0] = 0  # the gate off: the tile passes through
        ours = augment_heads_apply(image, target, layout.codes, d, index=index)
        torch.cuda.synchronize()
        ref = augment_heads_apply_plain(image, target, layout.codes, d, index=index)
        if not torch.equal(ours[1], ref[1]) or ulps(ours[0], ref[0]) > 1:
            raise AssertionError(f"K4h cases {cases[i:i + b]}: targets equal "
                                 f"{torch.equal(ours[1], ref[1])}, image "
                                 f"{ulps(ours[0], ref[0])} ulps from the plain version")
        err = max(err, (ours[0] - ref[0]).abs().max().item())

    d = draw(g, b, (b, 1, s, s))
    ms = timer(lambda: augment_heads_apply(image, target, layout.codes, d, index=index))
    # what the event-timed call above is made of when the host is slower
    # than the kernel: the wrapper's host time (checks, allocation, ctypes
    # call) and the kernel's own device time (profiler, L2 flushed)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        augment_heads_apply(image, target, layout.codes, d, index=index)
    host_ms = (time.perf_counter() - t0) / 200 * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            timer.flush.fill_(1)
            augment_heads_apply(image, target, layout.codes, d, index=index)
        torch.cuda.synchronize()
    dev_us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and "augment_heads" in e.name]
    log(f"[kernels heads training] k4h wrapper host time {host_ms:.4f} ms a call; kernel "
        + (f"device time {np.mean(dev_us) / 1e3:.4f} ms ({len(dev_us)} launches, L2 flushed)"
           if dev_us else "device time not measured (the profiler saw no kernel)"))
    plain_ms = timer(lambda: augment_heads_apply_plain(image, target, layout.codes, d,
                                                       index=index), 3)
    flags = d.flags.cpu()
    n_mult = int(((flags[:, 0] != 0) & (flags[:, 5] != 0)).sum())
    n_on = int((flags[:, 0] != 0).sum())
    plane = s * s * 4
    # least work for this draw: index, flags, coefficients and the code
    # table; each gathered image and target pixel read once (1 + 3 planes per
    # sample); the multiplier field for the samples whose gate and noise flag
    # are on; each output pixel written once; about six float operations per
    # augmented image pixel and three per augmented orientation component
    n_bytes = b * (8 + 7 * 4 + 2 * 4) + 3 * 4 + 4 * b * plane + n_mult * plane + 4 * b * plane
    bound, by = bound_ms(n_bytes, (6 + 2 * 3) * n_on * s * s)
    log(f"[kernels heads training] k4h_augment_heads: 16 (k, flip) cases, targets bit-equal, "
        f"image max_abs_err {err} (<= 1 ulp) | kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
        f"bound {bound:.4f} ms ({by}, {n_bytes / 1e6:.2f} MB) | library none")
    return {"name": "k4h_augment_heads", "route": "cuda",
            "source": "bio_image_unet_tpu_torch/csrc/augment_batch.cu",
            "replaces": "bio_image_unet_tpu/data/augment_jax.py:192", "launches": 0,
            "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None, "_counter": augment_heads_apply}


# --- 10. the multi-output training path -------------------------------------------

def write_head_frames(root: Path, n: int, size: int, seed: int) -> tuple:
    """``n`` blob frames with their mask and an orientation-angle target
    (the direction of the smoothed mask's gradient, NaN where it is below 1%
    of its largest value) as TIFFs under ``root``/image, /mask,
    /orientation."""
    from scipy import ndimage

    from bio_image_unet_tpu_torch.data import tiff
    from bio_image_unet_tpu_torch.utils.synth import blob_sample

    rng = np.random.default_rng(seed)
    dirs = {k: root / k for k in ("image", "mask", "orientation")}
    for d in dirs.values():
        d.mkdir(parents=True)
    for i in range(n):
        img, mask = blob_sample(rng, (size, size), n_blobs=10, margin=16, radius=(8, 20))
        gy, gx = np.gradient(ndimage.gaussian_filter(mask / 255.0, 8.0))
        angle = (np.arctan2(gy, gx) % (2 * np.pi)).astype(np.float32)
        mag = np.hypot(gy, gx)
        angle[mag < 0.01 * mag.max()] = np.nan
        tiff.imwrite(str(dirs["image"] / f"{i:04d}.tif"), img)
        tiff.imwrite(str(dirs["mask"] / f"{i:04d}.tif"), (mask / 255.0).astype(np.float32))
        tiff.imwrite(str(dirs["orientation"] / f"{i:04d}.tif"), angle)
    return str(dirs["image"]), [str(dirs["mask"]), str(dirs["orientation"])]


def phase_train_heads(torch, dev, kernels) -> None:
    from bio_image_unet_tpu_torch import multi_output_unet

    counters = {id(k["_counter"]): k["_counter"] for k in kernels}
    k4h = kernels[-1]
    torch.backends.cudnn.allow_tf32 = True  # the user's default
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        image_dir, target_dirs = write_head_frames(tmp / "frames", MO_FRAMES, TILE, seed=4)
        data = multi_output_unet.DataProcess(
            image_dir, target_dirs, {"mask": "mask", "orientation": "mask"},
            data_dir=str(tmp / "data"), dim_out=(TILE, TILE), aug_factor=2, seed=0)
        t_data = time.perf_counter() - t0
        trainer = multi_output_unet.Trainer(
            data, MO_EPOCHS, n_filter=HEADS_FILTER, output_heads=MO_TRAIN_HEADS,
            batch_size=MO_BATCH, lr=MO_LR, save_dir=str(tmp / "run"), seed=0,
            half_precision=True, device_cache=True, device_augment=True, save_name="model.pt")
        steps = trainer._n_train // MO_BATCH
        nan_filled = sum(int((data[i]["orientation"] == 0).all(0).sum()) for i in range(len(data)))
        log(f"[train heads] set-up {time.perf_counter() - t0:.2f} s (frames and DataProcess "
            f"{t_data:.2f} s): {len(data)} tiles, {trainer._n_train} training, {steps} steps "
            f"of {MO_BATCH} per epoch; {nan_filled} orientation pixels NaN-filled")

        # the main path: every launch count is 0 just before, read just after
        for c in counters.values():
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        trainer.start()
        torch.cuda.synchronize()
        launches = {id(c): c.launches for c in counters.values()}
        peak = torch.cuda.max_memory_allocated()
        k4h["launches"] = launches[id(k4h["_counter"])]
        log("[train heads] launches: " + ", ".join(
            f"{c.__name__} {launches[id(c)]}" for c in counters.values()))
        for c in counters.values():
            want = steps * MO_EPOCHS if c is k4h["_counter"] else 0
            if launches[id(c)] != want:
                raise AssertionError(f"{c.__name__} launched {launches[id(c)]} times in "
                                     f"{steps * MO_EPOCHS} steps, want {want}")
        hist = trainer.history
        for h in hist:
            log(f"[train heads] epoch {h['epoch']}: train loss {h['train_loss']:.6f}, val loss "
                f"{h['val_loss']:.6f}, lr {h['lr']:g}, training pass {h['train_seconds']:.3f} s, "
                f"epoch {h['seconds']:.3f} s")
        if not hist[-1]["train_loss"] < hist[0]["train_loss"]:
            raise AssertionError("the multi-output training loss did not fall")
        best = min(h["train_seconds"] for h in hist)
        patches = steps * MO_BATCH / best
        flops = 3 * nested_unet_forward_flops(HEADS_FILTER, TILE)
        log(f"[train heads] {patches:.1f} patches/s (best epoch), step {best / steps * 1e3:.2f} "
            f"ms; peak device memory {peak / 2**30:.2f} GiB; {flops / 1e9:.1f} GFLOP per tile "
            f"forward+backward → {flops * patches / 1e12:.1f} TFLOP/s, "
            f"{flops * patches / PEAK_BF16_FLOPS:.4f} of the bf16 dense peak")
        profile_train_epoch(torch, trainer, MO_EPOCHS, best, tag="train heads")

        # deep supervision: one epoch of the 3-level UNet++, then its .pt
        # through PredictMultiOutput
        deep = multi_output_unet.Trainer(
            data, 1, network="MultiOutputNestedUNet_3Levels", n_filter=HEADS_FILTER,
            output_heads=MO_TRAIN_HEADS, deep_supervision=True, batch_size=MO_BATCH, lr=MO_LR,
            save_dir=str(tmp / "deep"), seed=0, half_precision=True, device_cache=True,
            device_augment=True, save_name="model.pt")
        deep.start()
        loss = deep.history[0]["train_loss"]
        if not np.isfinite(loss):
            raise AssertionError(f"deep supervision: training loss {loss}")
        res = predict_heads_trained(torch, str(tmp / "deep" / "model.pt"), frames=2)
        log(f"[train heads] MultiOutputNestedUNet_3Levels, deep supervision, 1 epoch: train "
            f"loss {loss:.6f}, val loss {deep.history[0]['val_loss']:.6f}; its .pt through "
            f"PredictMultiOutput: " + ", ".join(f"{h} {v.shape}" for h, v in res.items()))
        predict_heads_trained(torch, str(tmp / "run" / "model.pt"), frames=CHUNK, iou=True)
    train_heads_card_vs_cpu(torch)


def predict_heads_trained(torch, ckpt: str, frames: int, iou: bool = False) -> dict:
    """A trained multi-output ``.pt`` through ``PredictMultiOutput`` on blob
    frames of 512²: finite heads, the mask in [0, 1]; with ``iou`` the mask
    IoU against the blob truth is printed."""
    from bio_image_unet_tpu_torch.predict import PredictMultiOutput
    from bio_image_unet_tpu_torch.utils.synth import blob_sample

    rng = np.random.default_rng(9)
    pairs = [blob_sample(rng, (512, 512), n_blobs=40, margin=16, radius=(8, 20))
             for _ in range(frames)]
    movie = np.stack([p[0] for p in pairs])
    truth = np.stack([p[1] for p in pairs]) > 0
    t0 = time.perf_counter()
    res = PredictMultiOutput(movie, ckpt, max_patch_size=(TILE, TILE), half_precision=True,
                             show_progress=False).result
    dt = time.perf_counter() - t0
    for head, cfg in MO_TRAIN_HEADS.items():
        r = res[head]
        want = movie.shape if cfg["channels"] == 1 else (frames, cfg["channels"]) + movie.shape[1:]
        if r.shape != want or not np.isfinite(r).all():
            raise AssertionError(f"PredictMultiOutput on the trained model, {head}: {r.shape}, "
                                 f"finite {np.isfinite(r).all()}")
    if not (res["mask"].min() >= 0.0 and res["mask"].max() <= 1.0):
        raise AssertionError("the trained model's mask head leaves [0, 1]")
    if iou:
        pred = res["mask"] > 0.5
        score = float((pred & truth).sum() / max((pred | truth).sum(), 1))
        norm = np.sqrt((res["orientation"] ** 2).sum(1))
        log(f"[train heads→predict] trained .pt through PredictMultiOutput on {frames}×512² "
            f"blobs ({dt:.3f} s): mask IoU {score:.4f} (foreground {truth.mean():.4f} of "
            f"pixels, predicted {pred.mean():.4f}); orientation |(cos, sin)| on the mask "
            f"{norm[truth].mean():.4f}, off it {norm[~truth].mean():.4f}")
    return res


def train_heads_card_vs_cpu(torch) -> None:
    """``MultiOutputNestedUNet(n_filter=4)`` with both heads on 15 tiles of 64²
    (12 training: 3 steps of 4), float32 with TF32 off, resident tiles, no
    augmentation, one epoch: the card's ``metrics.csv`` rows against the
    CPU's, rtol 1e-3 (the bilinear upsample's backward accumulates with
    atomics on the card)."""
    from bio_image_unet_tpu_torch.train import Trainer
    from bio_image_unet_tpu_torch.utils.synth import blob_sample

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[:64, :64]
    items = []
    for _ in range(15):
        img, mask = blob_sample(rng, (64, 64))
        theta = np.arctan2(yy - rng.uniform(0, 64), xx - rng.uniform(0, 64))
        items.append({"image": (img / 255.0).astype(np.float32)[None],
                      "mask": (mask / 255.0).astype(np.float32)[None],
                      "orientation": np.stack([np.cos(theta), np.sin(theta)]).astype(np.float32)})
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dev in ("cuda", "cpu"):
            t = Trainer(items, 1, network="MultiOutputNestedUNet", n_filter=4,
                        output_heads=MO_TRAIN_HEADS, batch_size=4, lr=MO_LR, grad_clip=1.0,
                        save_dir=str(Path(tmp) / dev), seed=0, device=dev, device_cache=True)
            t.start()
            rows[dev] = metrics_rows(Path(tmp) / dev)[:, 1:]
    rel = np.abs(rows["cuda"] - rows["cpu"]) / np.abs(rows["cpu"])
    log(f"[train heads] card vs CPU (UNet++ n_filter=4, 64², float32, TF32 off, 1 epoch): card "
        f"{rows['cuda'].tolist()}, CPU {rows['cpu'].tolist()}, max relative difference "
        f"{rel.max():.2e}")
    if not rel.max() <= 1e-3:
        raise AssertionError("the card's multi-output training run disagrees with the CPU's")


# --- 11. kernels of the 3D paths ---------------------------------------------------

# benchmarks/family_bench.py's 3D configuration (ours_unet3d, :368-406)
VOL_D, VOL_H, VOL_W, VOL_TILE, VOL_FILTER, VOL_BATCH = 64, 512, 512, (32, 128, 128), 32, 4
VOL_CLIP = (0.0, 99.8)  # Predict3D's default clip_threshold
# PredictMultiOutput3D's defaults (predictor.py:2164-2168) on 2 volumes, with
# the heads of tests/test_quant_families.py:26-27
MO3_HEADS = {"mask": {"channels": 1, "activation": "sigmoid"},
             "vec": {"channels": 2, "activation": None}}
MO3_VOLS, MO3_PATCH, MO3_OVERLAP, MO3_MARGIN, MO3_BATCH = 2, (64, 256, 256), 0.1, 16, 2
MO3_CLIP = (0.0, 99.98)  # PredictMultiOutput3D's default clip_threshold


def vol_grid(tile, add: int = 0) -> list:
    from bio_image_unet_tpu_torch.predict.tiling import grid_starts

    return [grid_starts(e, t, add) for e, t in zip((VOL_D, VOL_H, VOL_W), tile)]


def heads3d_grid() -> tuple:
    """The starts and blend factors of ``PredictMultiOutput3D``'s grid."""
    from bio_image_unet_tpu_torch.predict.tiling import _blend_factors, overlap_starts

    starts = [overlap_starts(e, t, MO3_OVERLAP) for e, t in zip((VOL_D, VOL_H, VOL_W), MO3_PATCH)]
    return starts, _blend_factors([len(s) for s in starts], MO3_PATCH, MO3_MARGIN)


def phase_kernels_3d(torch, dev) -> list:
    """K1 on whole volumes, K2v, K3v and K5v at the 3D paths' shapes."""
    from bio_image_unet_tpu_torch.ops import histogram as hist
    from bio_image_unet_tpu_torch.ops.stitch import (blend_stitch_3d, blend_stitch_3d_plain,
                                                      sigmoid_stitch_3d, sigmoid_stitch_3d_plain)
    from bio_image_unet_tpu_torch.predict.normalize import (normalize_tile_3d,
                                                            normalize_tile_3d_plain)
    from bio_image_unet_tpu_torch.predict.tiling import TilePlan3D
    from bio_image_unet_tpu_torch.utils.kernel_ab_times import offset_view

    timer = Timer(torch, dev)
    g = torch.Generator(device=dev).manual_seed(4)
    n_vox = VOL_D * VOL_H * VOL_W
    rows = []

    def row(*args):
        rows.append(kernel_row("kernels 3d", *args))

    # K1 on one whole volume: N = 1 row (the ranks reach 16.7 M, 67 M for uint16)
    for dt, top, n in ((torch.uint8, 256, n_vox), (torch.uint16, 65536, 4 * n_vox)):
        x = torch.randint(0, top, (1, n), generator=g, device=dev, dtype=torch.int32).to(dt)
        ours = hist.int_clip_bounds(x, *VOL_CLIP)
        torch.cuda.synchronize()
        ref = hist.clip_bounds_plain(x, *VOL_CLIP)
        if not torch.equal(ours.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(f"K1 on a {dt} volume row: {ours.tolist()} != {ref.tolist()}")
        log(f"[kernels 3d] k1_int_clip_bounds, one {dt} row of {n} voxels: bit-equal to plain "
            f"{ours[:, 0].tolist()} | kernel {timer(lambda: hist.int_clip_bounds(x, *VOL_CLIP)):.4f}"
            f" ms | bound {bound_ms(x.numel() * x.element_size(), n)[0]:.4f} ms")
        del x

    # K2v (uint8 mode) and K3v on the Predict3D grid: 32 tiles of (32, 128, 128)
    vol = torch.randint(0, 256, (1, VOL_D, VOL_H, VOL_W), generator=g, device=dev,
                        dtype=torch.int32).to(torch.uint8)
    plan = TilePlan3D(VOL_D, VOL_H, VOL_W, VOL_TILE, *vol_grid(VOL_TILE), dev)
    n = plan.per_volume
    tvox = int(np.prod(VOL_TILE))
    bounds = hist.clip_bounds(vol, *VOL_CLIP)
    ours = normalize_tile_3d(vol, bounds, plan, n)
    torch.cuda.synchronize()
    ref = normalize_tile_3d_plain(vol, bounds, plan, n)
    err = (ours.int() - ref.int()).abs().max().item()
    if err != 0:
        raise AssertionError(f"K2v uint8: kernel differs from plain by {err} levels")
    row("k2v_normalize_tile_3d[uint8]", "bio_image_unet_tpu_torch/csrc/normalize_tile.cu",
        "bio_image_unet_tpu/predict/predictor.py:1222", normalize_tile_3d, err,
        timer(lambda: normalize_tile_3d(vol, bounds, plan, n)),
        timer(lambda: normalize_tile_3d_plain(vol, bounds, plan, n), 3),
        # read each voxel once, write each tile voxel once; about five float
        # operations per tile voxel (clip, subtract, divide, scale)
        bound_ms(vol.numel() + 16 + n * tvox, 5 * n * tvox), None)

    logits = (torch.randn((n, 1) + VOL_TILE, generator=g, device=dev) * 4).to(torch.bfloat16)
    ours = sigmoid_stitch_3d(logits, plan)
    torch.cuda.synchronize()
    ref = sigmoid_stitch_3d_plain(logits, plan)
    err = (ours.int() - ref.int()).abs().max().item()
    if err > 1:
        raise AssertionError(f"K3v: kernel differs from plain by {err} levels")
    row("k3v_sigmoid_stitch_3d", "bio_image_unet_tpu_torch/csrc/sigmoid_stitch.cu",
        "bio_image_unet_tpu/ops/stitch.py:95", sigmoid_stitch_3d, err,
        timer(lambda: sigmoid_stitch_3d(logits, plan)),
        timer(lambda: sigmoid_stitch_3d_plain(logits, plan), 3),
        # read each real logit once (bf16), write each voxel once; about four
        # operations per logit (exp, add, divide, scale) and the sum
        bound_ms(n * tvox * 2 + n_vox, 5 * n * tvox), None)
    # the overlapping grid of add_patch=1 (3 × 5 × 5 tiles): averages
    over = TilePlan3D(VOL_D, VOL_H, VOL_W, VOL_TILE, *vol_grid(VOL_TILE, 1), dev)
    logits = (torch.randn((over.per_volume, 1) + VOL_TILE, generator=g, device=dev) * 4
              ).to(torch.bfloat16)
    ours = sigmoid_stitch_3d(logits, over)
    torch.cuda.synchronize()
    diff = (ours.int() - sigmoid_stitch_3d_plain(logits, over).int()).abs()
    log(f"[kernels 3d] k3v on the add_patch=1 grid ({over.per_volume} tiles): max "
        f"{diff.max().item()} levels on {diff.gt(0).float().mean().item():.2e} of voxels | kernel "
        f"{timer(lambda: sigmoid_stitch_3d(logits, over)):.4f} ms")
    if diff.max().item() > 1:
        raise AssertionError("K3v on the overlapping grid differs from plain by > 1 level")
    del vol, logits, ours, ref, diff

    # K2v (float mode) and K5v on PredictMultiOutput3D's grid: 2 volumes, 18
    # tiles of (64, 256, 256), bf16 tiles, heads of 1 and 2 channels
    starts, factors = heads3d_grid()
    hplan = TilePlan3D(VOL_D, VOL_H, VOL_W, MO3_PATCH, *starts, dev, factors)
    nh = MO3_VOLS * hplan.per_volume
    hvox = int(np.prod(MO3_PATCH))
    vols = torch.randint(0, 256, (MO3_VOLS, VOL_D, VOL_H, VOL_W), generator=g, device=dev,
                         dtype=torch.int32).to(torch.uint8)
    bounds = hist.clip_bounds(vols, *MO3_CLIP)
    ours = normalize_tile_3d(vols, bounds, hplan, nh, False, torch.bfloat16)
    torch.cuda.synchronize()
    ref = normalize_tile_3d_plain(vols, bounds, hplan, nh, False, torch.bfloat16)
    if not torch.equal(ours.view(torch.int16), ref.view(torch.int16)):
        raise AssertionError("K2v bf16: kernel differs from its plain version")
    row("k2v_normalize_tile_3d[uint8->bf16 heads]",
        "bio_image_unet_tpu_torch/csrc/normalize_tile.cu",
        "bio_image_unet_tpu/predict/predictor.py:1324", normalize_tile_3d,
        (ours.float() - ref.float()).abs().max().item(),
        timer(lambda: normalize_tile_3d(vols, bounds, hplan, nh, False, torch.bfloat16)),
        timer(lambda: normalize_tile_3d_plain(vols, bounds, hplan, nh, False, torch.bfloat16), 3),
        bound_ms(vols.numel() + 32 + nh * hvox * 2, 5 * nh * hvox), None)
    del vols, ours, ref

    for c in (1, 2):
        tiles = (torch.rand((nh, c) + MO3_PATCH, generator=g, device=dev) * 4 - 2).half()
        for out_dtype, view in ((torch.float16, torch.int16), (torch.float32, torch.int32)):
            ours = blend_stitch_3d(tiles, MO3_VOLS, hplan, out_dtype)
            torch.cuda.synchronize()
            ref = blend_stitch_3d_plain(tiles, MO3_VOLS, hplan, out_dtype)
            if not torch.equal(ours.view(view), ref.view(view)):
                bad = (ours.view(view) != ref.view(view)).sum().item()
                raise AssertionError(f"K5v c={c} {out_dtype}: {bad} values differ from plain")
            del ours, ref
        out_vox = MO3_VOLS * c * n_vox
        row(f"k5v_blend_stitch_3d[c={c}]", "bio_image_unet_tpu_torch/csrc/margin_stitch.cu",
            "bio_image_unet_tpu/ops/stitch.py:163", blend_stitch_3d, 0.0,
            timer(lambda: blend_stitch_3d(tiles, MO3_VOLS, hplan, torch.float16)),
            timer(lambda: blend_stitch_3d_plain(tiles, MO3_VOLS, hplan, torch.float16), 3),
            # read each real tile value once (float16), write each voxel once
            # (float16); per tile value two mins, a multiply-add and an add,
            # per voxel a divide
            bound_ms(nh * c * hvox * 2 + out_vox * 2, 4 * nh * c * hvox + out_vox), None)
        del tiles

    # K5v on the main grid's tiles viewed at an odd float16 offset, and on 150
    # one-tile volumes of (880, 8, 8) x 2 channels: 66000 groups of 4 planes
    # of one z, more than one launch's 65535; both out types
    stack = TilePlan3D(880, 8, 8, (880, 8, 8), [0], [0], [0], dev,
                       [np.ones((1, t), np.float32) for t in (880, 8, 8)])
    for what, tiles, pl, nv in (
            ("tiles at an odd float16 offset",
             offset_view(torch, (torch.rand((nh, 1) + MO3_PATCH, generator=g, device=dev) * 4
                                 - 2).half(), 1), hplan, MO3_VOLS),
            ("150 one-tile volumes, 66000 plane groups",
             (torch.rand((150, 2, 880, 8, 8), generator=g, device=dev) * 4 - 2).half(), stack,
             150)):
        for out_dtype, view in ((torch.float16, torch.int16), (torch.float32, torch.int32)):
            ours = blend_stitch_3d(tiles, nv, pl, out_dtype)
            torch.cuda.synchronize()
            ref = blend_stitch_3d_plain(tiles, nv, pl, out_dtype)
            if not torch.equal(ours.view(view), ref.view(view)):
                raise AssertionError(f"K5v {what} {out_dtype}: kernel differs from plain")
        log(f"[kernels 3d] k5v_blend_stitch_3d, {what}: bit-equal to plain in float16 and "
            f"float32 | kernel {timer(lambda: blend_stitch_3d(tiles, nv, pl)):.4f} ms")
        del tiles, ours, ref
    torch.cuda.empty_cache()
    return rows


# --- 12. the 3D path --------------------------------------------------------------

def unet3d_forward_flops(nf: int, nearest_decoder: bool = False, out_channels: int = 1) -> float:
    """Multiply-add FLOPs per tile voxel through ``UNet3D(n_filter=nf)`` —
    or, with ``nearest_decoder``, ``MultiOutputUnet3D``'s nearest ×2 + conv
    block decoder: the 3×3×3 convs of each level, the decoder's 2×2×2
    stride-2 transposed convs (per input voxel) or ``up<i>_conv`` blocks (at
    the upsampled resolution), the 1×1×1 output convs.  Pools, resampling
    and concats are not counted."""
    def conv(ci, co, frac, taps=27):
        return 2 * ci * co * taps * frac

    h = nf // 2
    f = conv(1, h, 1) + conv(h, nf, 1) + conv(nf, nf, 1 / 8) + conv(nf, 2 * nf, 1 / 8)
    f += conv(2 * nf, 2 * nf, 1 / 64) + conv(2 * nf, 4 * nf, 1 / 64)
    f += conv(4 * nf, 4 * nf, 1 / 512) + conv(4 * nf, 8 * nf, 1 / 512)
    for width, frac in ((8 * nf, 1 / 512), (4 * nf, 1 / 64), (2 * nf, 1 / 8)):
        f += conv(width, width, 8 * frac) if nearest_decoder else conv(width, width, frac, 8)
    f += conv(12 * nf, 4 * nf, 1 / 64) + conv(4 * nf, 4 * nf, 1 / 64)
    f += conv(6 * nf, 2 * nf, 1 / 8) + conv(2 * nf, 2 * nf, 1 / 8)
    f += conv(3 * nf, nf, 1) + conv(nf, h, 1)
    return f + 2 * h * out_channels


def check_u8_volume(tag: str, what: str, ours: np.ndarray, ref: np.ndarray, shape) -> None:
    """The uint8 contract: within one level on at most 0.1% of voxels."""
    if ours.shape != tuple(shape) or ours.dtype != np.uint8 or ref.shape != ours.shape:
        raise AssertionError(f"{what}: {ours.shape} {ours.dtype} vs {ref.shape}, want {shape}")
    diff = np.abs(ours.astype(np.int16) - ref.astype(np.int16))
    frac = float(np.mean(diff > 0))
    log(f"[{tag}] {what}: max {int(diff.max())} levels on {frac:.6f} of the values; mean "
        f"{ours.mean():.2f}, std {ours.std():.2f}")
    if diff.max() > 1 or frac > 1e-3:
        raise AssertionError(f"{what}: beyond the uint8 contract")


def phase_3d(torch, dev, kernels, k3d) -> None:
    from bio_image_unet_tpu_torch.ops import histogram as hist
    from bio_image_unet_tpu_torch.ops.stitch import sigmoid_stitch_3d
    from bio_image_unet_tpu_torch.predict import Predict3D
    from bio_image_unet_tpu_torch.predict.normalize import normalize_tile_3d
    from bio_image_unet_tpu_torch.predict.predictor import _Engine

    torch.backends.cudnn.allow_tf32 = True  # the user's default
    counters = list({id(k["_counter"]): k["_counter"] for k in kernels + k3d}.values())
    rows = {k["name"]: k for k in k3d}
    shape = (VOL_D, VOL_H, VOL_W)
    rng = np.random.default_rng(10)
    vol = rng.integers(0, 255, shape, dtype=np.uint8)
    vol_u16 = rng.integers(0, 65535, shape, dtype=np.uint16)
    kw = dict(resize_dim=VOL_TILE, show_progress=False, batch_size=VOL_BATCH, half_precision=True)
    main = "UNet3D uint8 64x512^2 (family_bench)"
    # per call: K1's uint8 launches over the whole volume, K2v once, K3v once
    fused_expect = {hist.int_clip_bounds: hist.LAUNCHES[torch.uint8], normalize_tile_3d: 1,
                    sigmoid_stitch_3d: 1}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "unet3d_nf32.pt")
        write_checkpoint(torch, ckpt, "UNet3D", VOL_FILTER, seed=5)
        torch.cuda.reset_peak_memory_stats()
        best = float("inf")
        for rep in ("warm-up", "timed 1", "timed 2"):
            t0 = time.perf_counter()
            res, got = counted(torch, "3d", counters, f"{main}, {rep}",
                               lambda: Predict3D(vol, None, ckpt, **kw).result, fused_expect)
            if rep != "warm-up":
                best = min(best, time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        rows["k2v_normalize_tile_3d[uint8]"]["launches"] = got[normalize_tile_3d]
        rows["k3v_sigmoid_stitch_3d"]["launches"] = got[sigmoid_stitch_3d]

        # host-staged at the fused path's forward batch: the same uint8 tiles
        # up to the host's float64 percentiles, into the same batches
        t0 = time.perf_counter()
        engine = _Engine(ckpt, "UNet3D", batch_size=VOL_BATCH, half_precision=True, device=dev)
        t_engine = time.perf_counter() - t0
        fn, plan, bs = engine.volume_runner(*shape, *vol_grid(VOL_TILE), VOL_TILE, VOL_CLIP)
        host, _ = counted(torch, "3d", counters, f"{main}, host-staged at batch {bs}",
                          lambda: Predict3D(vol, None, ckpt, device_pipeline=False,
                                            **dict(kw, batch_size=bs)).result,
                          {sigmoid_stitch_3d: 1})
        check_u8_volume("3d", f"{main}: fused vs host-staged", res, host, shape)

        # device-resident: the same program on a volume already on the card
        vol_dev = torch.from_numpy(vol).to(dev)
        fn(vol_dev)
        torch.cuda.synchronize()
        best_dev = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn(vol_dev)
            torch.cuda.synchronize()
            best_dev = min(best_dev, time.perf_counter() - t0)
        same = int(np.abs(out.cpu().numpy().astype(np.int16) - res).max())
        log(f"[3d] device-resident run vs its Predict3D run: max {same} levels")
        if same != 0:
            raise AssertionError("the device-resident program disagrees with Predict3D")
        # two passes: the profiler misses the first launches of its window
        profile_pass(torch, lambda: [fn(vol_dev) for _ in range(2)], "3d",
                     "two passes over one volume")
        del vol_dev, out
        mvox = VOL_D * VOL_H * VOL_W / 1e6
        e2e, resident = mvox / best, mvox / best_dev
        flops = unet3d_forward_flops(VOL_FILTER)
        tile_vox_per_vox = plan.per_volume * np.prod(VOL_TILE) / (mvox * 1e6)
        log(f"[3d] {main}: end-to-end {e2e:.2f} Mvox/s ({best:.3f} s); device-resident "
            f"{resident:.2f} Mvox/s ({best_dev * 1e3:.2f} ms); forward batch {bs}; engine set-up "
            f"{t_engine:.3f} s; peak device memory {peak / 2**30:.2f} GiB; {flops / 1e6:.4f} MFLOP "
            f"per tile voxel ({flops * np.prod(VOL_TILE) / 1e9:.1f} GFLOP per tile) → "
            f"{flops * tile_vox_per_vox * e2e / 1e6:.1f} TFLOP/s end to end "
            f"({flops * tile_vox_per_vox * e2e * 1e6 / PEAK_BF16_FLOPS:.4f} of the bf16 dense "
            f"peak), {flops * tile_vox_per_vox * resident / 1e6:.1f} TFLOP/s device-resident "
            f"({flops * tile_vox_per_vox * resident * 1e6 / PEAK_BF16_FLOPS:.4f})")

        # coverage: the trilinear decoder; uint16 on the add_patch=1 grid
        tri = str(Path(tmp) / "unet3d_trilinear_nf32.pt")
        write_checkpoint(torch, tri, "UNet3D", VOL_FILTER, seed=6, use_interpolation=True)
        for name, path, v, extra in (
                ("UNet3D trilinear uint8 64x512^2", tri, vol, {}),
                ("UNet3D uint16 64x512^2 add_patch=1", ckpt, vol_u16, {"add_patch": 1})):
            t0 = time.perf_counter()
            fused = Predict3D(v, None, path, **kw, **extra).result
            dt = time.perf_counter() - t0
            host = Predict3D(v, None, path, device_pipeline=False, **dict(kw, batch_size=16),
                             **extra).result
            log(f"[3d] {name}: {dt:.3f} s end to end ({mvox / dt:.2f} Mvox/s, one call, set-up "
                "included)")
            check_u8_volume("3d", f"{name}: fused vs host-staged at batch 16", fused, host, shape)

        # a small float32 reference: the card against the CPU, TF32 off
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        small = str(Path(tmp) / "unet3d_nf8.pt")
        for interp, add, v in ((False, 0, rng.integers(0, 255, (16, 64, 64), dtype=np.uint8)),
                               (True, 1, rng.integers(0, 65535, (12, 40, 36), dtype=np.uint16))):
            write_checkpoint(torch, small, "UNet3D", 8, seed=7, use_interpolation=interp)
            skw = dict(resize_dim=(8, 32, 32), add_patch=add, show_progress=False)
            check_u8_volume("3d", f"small float32 {v.dtype} add_patch={add} interp={interp}: "
                            "card vs CPU", Predict3D(v, None, small, **skw).result,
                            Predict3D(v, None, small, device="cpu", **skw).result, v.shape)
        torch.backends.cudnn.allow_tf32 = True


# --- 13. the multi-head 3D path ------------------------------------------------------

def check_heads3d(name: str, res: dict, shape) -> None:
    for head, cfg in MO3_HEADS.items():
        want = shape if cfg["channels"] == 1 else (shape[0], cfg["channels"]) + shape[1:]
        r = res[head]
        if r.shape != tuple(want) or r.dtype != np.float32 or not np.isfinite(r).all():
            raise AssertionError(f"{name} {head}: {r.shape} {r.dtype}, want {want} float32 "
                                 "and finite")


def heads_within(tag: str, what: str, ours: dict, ref: dict) -> None:
    """Every head and voxel within 2e-3 + 1e-3·|ref| (float16 heads)."""
    worst = {h: float((np.abs(ours[h] - ref[h]) / (2e-3 + 1e-3 * np.abs(ref[h]))).max())
             for h in MO3_HEADS}
    log(f"[{tag}] {what}: " + ", ".join(
        f"{h} max {float(np.abs(ours[h] - ref[h]).max()):.3e} (|ref| up to "
        f"{float(np.abs(ref[h]).max()):.3f}; {worst[h]:.3f} of the tolerance)" for h in MO3_HEADS))
    if max(worst.values()) > 1.0:
        raise AssertionError(f"{what}: beyond 2e-3 + 1e-3·|ref|")


def phase_3d_heads(torch, dev, kernels, k3d) -> None:
    from bio_image_unet_tpu_torch.ops import histogram as hist
    from bio_image_unet_tpu_torch.ops.stitch import blend_stitch_3d
    from bio_image_unet_tpu_torch.predict import PredictMultiOutput3D
    from bio_image_unet_tpu_torch.predict.normalize import normalize_tile_3d
    from bio_image_unet_tpu_torch.predict.predictor import _Engine

    torch.backends.cudnn.allow_tf32 = True  # the user's default
    counters = list({id(k["_counter"]): k["_counter"] for k in kernels + k3d}.values())
    rows = {k["name"]: k for k in k3d}
    shape = (MO3_VOLS, VOL_D, VOL_H, VOL_W)
    rng = np.random.default_rng(11)
    vols = rng.integers(0, 255, shape, dtype=np.uint8)
    kw = dict(max_patch_size=MO3_PATCH, overlap_factor=MO3_OVERLAP, blend_margin=MO3_MARGIN,
              batch_size=MO3_BATCH, half_precision=True, show_progress=False)
    main = "MultiOutputUnet3D uint8 2x64x512^2 (class defaults)"
    # per call: K1's uint8 launches (one row per volume), K2v once, K5v once per head
    expect = {hist.int_clip_bounds: hist.LAUNCHES[torch.uint8], normalize_tile_3d: 1,
              blend_stitch_3d: len(MO3_HEADS)}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "mo_unet3d_nf32.pt")
        write_checkpoint(torch, ckpt, "MultiOutputUnet3D", VOL_FILTER, seed=8,
                            output_heads=MO3_HEADS)
        torch.cuda.reset_peak_memory_stats()
        best = float("inf")
        for rep in ("warm-up", "timed 1", "timed 2"):
            t0 = time.perf_counter()
            res, got = counted(torch, "3d heads", counters, f"{main}, {rep}",
                               lambda: PredictMultiOutput3D(vols, ckpt, **kw).result, expect)
            if rep != "warm-up":
                best = min(best, time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        check_heads3d(main, res, shape)
        rows["k2v_normalize_tile_3d[uint8->bf16 heads]"]["launches"] = got[normalize_tile_3d]
        for c in (1, 2):
            rows[f"k5v_blend_stitch_3d[c={c}]"]["launches"] = got[blend_stitch_3d]

        t0 = time.perf_counter()
        engine = _Engine(ckpt, None, batch_size=MO3_BATCH, half_precision=True, device=dev)
        t_engine = time.perf_counter() - t0
        starts, factors = heads3d_grid()
        fn, plan, bs = engine.heads_3d_runner(*shape, *starts, MO3_PATCH, MO3_CLIP, factors)
        host, _ = counted(torch, "3d heads", counters, f"{main}, host-staged at batch {bs}",
                          lambda: PredictMultiOutput3D(vols, ckpt, device_pipeline=False,
                                                       **dict(kw, batch_size=bs)).result,
                          {blend_stitch_3d: len(MO3_HEADS)})
        check_heads3d(main + " host", host, shape)
        heads_within("3d heads", f"{main}: bf16 fused vs host-staged at batch {bs}", res, host)
        del host

        vols_dev = torch.from_numpy(vols).to(dev)
        fn(vols_dev)
        torch.cuda.synchronize()
        best_dev = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn(vols_dev)
            torch.cuda.synchronize()
            best_dev = min(best_dev, time.perf_counter() - t0)
        for h, cfg in MO3_HEADS.items():
            ours = out[h].float().cpu().numpy()
            ref = res[h].reshape(ours.shape)
            same = float(np.abs(ours - ref).max())
            log(f"[3d heads] device-resident run vs its PredictMultiOutput3D run, {h}: max {same}")
            if same != 0.0:
                raise AssertionError(f"{h}: the device-resident program disagrees")
        profile_pass(torch, lambda: [fn(vols_dev) for _ in range(2)], "3d heads",
                     f"two passes over {MO3_VOLS} volumes", (("K5v", "blend_stitch_3d"),))
        del vols_dev, out
        mvox = MO3_VOLS * VOL_D * VOL_H * VOL_W / 1e6
        e2e, resident = mvox / best, mvox / best_dev
        flops = unet3d_forward_flops(VOL_FILTER, nearest_decoder=True, out_channels=3)
        tile_vox_per_vox = MO3_VOLS * plan.per_volume * np.prod(MO3_PATCH) / (mvox * 1e6)
        log(f"[3d heads] {main}: end-to-end {e2e:.2f} Mvox/s ({best:.3f} s); device-resident "
            f"{resident:.2f} Mvox/s ({best_dev * 1e3:.2f} ms); {plan.per_volume} tiles a volume, "
            f"forward batch {bs}; engine set-up {t_engine:.3f} s; peak device memory "
            f"{peak / 2**30:.2f} GiB; {flops / 1e6:.4f} MFLOP per tile voxel, "
            f"{tile_vox_per_vox:.3f} tile voxels per voxel → "
            f"{flops * tile_vox_per_vox * e2e / 1e6:.1f} TFLOP/s end to end "
            f"({flops * tile_vox_per_vox * e2e * 1e6 / PEAK_BF16_FLOPS:.4f} of the bf16 dense "
            f"peak), {flops * tile_vox_per_vox * resident / 1e6:.1f} TFLOP/s device-resident "
            f"({flops * tile_vox_per_vox * resident * 1e6 / PEAK_BF16_FLOPS:.4f})")

        # a small float32 reference: the card against the CPU, TF32 off
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        small = str(Path(tmp) / "mo_unet3d_nf4.pt")
        for interp, mode, v in (
                (True, "single", rng.integers(0, 255, (2, 12, 40, 36), dtype=np.uint8)),
                (False, "all", (rng.standard_normal((2, 10, 36, 40)) * 30).astype(np.float32))):
            write_checkpoint(torch, small, "MultiOutputUnet3D", 4, seed=9,
                                output_heads=MO3_HEADS, use_interpolation=interp)
            skw = dict(max_patch_size=(8, 32, 32), normalization_mode=mode, blend_margin=4,
                       show_progress=False)
            heads_within("3d heads", f"small float32 {v.dtype} '{mode}' interp={interp}: card vs "
                         "CPU", PredictMultiOutput3D(v, small, **skw).result,
                         PredictMultiOutput3D(v, small, device="cpu", **skw).result)
        torch.backends.cudnn.allow_tf32 = True


# --- 14. kernels of the 3D training paths ------------------------------------------

# benchmarks/family_bench.py's 3D training (ours_unet3d, :408-432): UNet3D(32)
# through the unet3d facade, 40 resident volumes of (16, 64, 64), batch 4, bf16,
# val_split 0, a warm-up epoch and 3 timed ones; K4v on (device_augment)
T3_VOLS, T3_SHAPE, T3_BATCH, T3_EPOCHS = 40, (16, 64, 64), 4, 4
# the multi-output 3D coverage path: MultiOutputUnet3D(32) through its facade,
# 16 resident volumes of (32, 128, 128), batch 2, the heads of [train heads]
T3H_VOLS, T3H_SHAPE, T3H_BATCH, T3H_EPOCHS = 16, (32, 128, 128), 2, 3


def _k4v_bound(flags, b: int, planes_in: int, planes_out: int, vol_bytes: int, n_ops: float):
    """Least work of one K4v / K4hv call on these draws: index, flags and
    coefficients (and the code table); each gathered input channel read
    once; the multiplier field for the samples whose gate and noise flag are
    on; each output channel written once."""
    n_mult = int(((flags[:, 0] != 0) & (flags[:, 5] != 0)).sum())
    n_bytes = (b * (8 + 7 * 4 + 2 * 4) + 3 * 4 + planes_in * b * vol_bytes
               + n_mult * vol_bytes + planes_out * b * vol_bytes)
    return n_bytes, bound_ms(n_bytes, n_ops)


def phase_kernels_3d_training(torch, dev) -> list:
    """K4v at the main path's shapes (4 of 40 resident (1, 16, 64, 64)
    volumes) and K4hv at the coverage path's (2 of 16 resident volumes of
    (32, 128, 128), targets mask + orientation), each against its plain
    version on the same draws with every (k, flip_h, flip_v) case forced
    once and a sample gated off: targets bit-equal, image within one float32
    ulp; timed beside its byte bound."""
    import itertools

    from bio_image_unet_tpu_torch.data.augment_device import (HeadLayout, augment_apply_plain,
                                                              augment_heads_apply_plain,
                                                              augment_heads_volume_apply,
                                                              augment_volume_apply, draw)

    timer = Timer(torch, dev)
    g = torch.Generator(device=dev).manual_seed(12)
    cases = list(itertools.product(range(4), (0, 1), (0, 1)))

    def ulps(a, ref):
        return (a.view(torch.int32).long() - ref.view(torch.int32).long()).abs().max().item()

    def check(name, apply, plain, shape, b, src, tgt, extra):
        err = 0.0
        for i in range(0, len(cases), b):
            d = draw(g, b, (b,) + shape)
            d.flags[:, :4] = torch.tensor([[1, *c] for c in cases[i:i + b]], dtype=torch.int32,
                                          device=dev)
            if i == 0:
                d.flags[0, 0] = 0  # the gate off: the volume passes through
            index = torch.randperm(src.shape[0], generator=g, device=dev)[:b]
            ours = apply(src, tgt, *extra, d, index=index)
            torch.cuda.synchronize()
            ref = plain(src, tgt, *extra, d, index=index)
            if not torch.equal(ours[1], ref[1]) or ulps(ours[0], ref[0]) > 1:
                raise AssertionError(f"{name} cases {cases[i:i + b]}: targets equal "
                                     f"{torch.equal(ours[1], ref[1])}, image "
                                     f"{ulps(ours[0], ref[0])} ulps from the plain version")
            err = max(err, (ours[0] - ref[0]).abs().max().item())
        return err

    rows = []
    # K4v: the main path
    b, shape = T3_BATCH, (1,) + T3_SHAPE
    image = torch.rand((T3_VOLS,) + shape, generator=g, device=dev)
    mask = (torch.rand((T3_VOLS,) + shape, generator=g, device=dev) > 0.5).float()
    err = check("K4v", augment_volume_apply, augment_apply_plain, shape, b, image, mask, ())
    d = draw(g, b, (b,) + shape)
    index = torch.randperm(T3_VOLS, generator=g, device=dev)[:b]
    ms = timer(lambda: augment_volume_apply(image, mask, d, index=index))
    plain_ms = timer(lambda: augment_apply_plain(image, mask, d, index=index), 3)
    vox = int(np.prod(T3_SHAPE))
    n_on = int((d.flags[:, 0] != 0).sum())
    n_bytes, (bound, by) = _k4v_bound(d.flags.cpu(), b, 2, 2, vox * 4, 6 * n_on * vox)
    log(f"[kernels 3d training] k4v_augment_volume: 16 (k, flip) cases, mask bit-equal, image "
        f"max_abs_err {err} (<= 1 ulp) | kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | bound "
        f"{bound:.4f} ms ({by}, {n_bytes / 1e6:.2f} MB) | library none")
    rows.append({"name": "k4v_augment_volume", "route": "cuda",
                 "source": "bio_image_unet_tpu_torch/csrc/augment_batch.cu",
                 "replaces": "bio_image_unet_tpu/data/augment_jax.py:132", "launches": 0,
                 "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                 "bound_by": by, "library_ms": None, "_counter": augment_volume_apply})
    del image, mask

    # K4hv: the multi-output coverage path
    b, shape = T3H_BATCH, (1,) + T3H_SHAPE
    layout = HeadLayout.of({"mask": 1, "orientation": 2}, ("orientation",), dev)
    image = torch.rand((T3H_VOLS,) + shape, generator=g, device=dev)
    theta = torch.rand((T3H_VOLS,) + shape, generator=g, device=dev) * 6.2832
    target = torch.cat([(torch.rand((T3H_VOLS,) + shape, generator=g, device=dev) > 0.5).float(),
                        theta.cos(), theta.sin()], 1).contiguous()
    del theta
    err = check("K4hv", augment_heads_volume_apply, augment_heads_apply_plain, shape, b, image,
                target, (layout.codes,))
    d = draw(g, b, (b,) + shape)
    index = torch.randperm(T3H_VOLS, generator=g, device=dev)[:b]
    ms = timer(lambda: augment_heads_volume_apply(image, target, layout.codes, d, index=index))
    plain_ms = timer(lambda: augment_heads_apply_plain(image, target, layout.codes, d,
                                                       index=index), 3)
    vox = int(np.prod(T3H_SHAPE))
    n_on = int((d.flags[:, 0] != 0).sum())
    n_bytes, (bound, by) = _k4v_bound(d.flags.cpu(), b, 4, 4, vox * 4,
                                      (6 + 2 * 3) * n_on * vox)
    log(f"[kernels 3d training] k4hv_augment_heads_volume: 16 (k, flip) cases, targets "
        f"bit-equal, image max_abs_err {err} (<= 1 ulp) | kernel {ms:.4f} ms | plain "
        f"{plain_ms:.4f} ms | bound {bound:.4f} ms ({by}, {n_bytes / 1e6:.2f} MB) | library none")
    rows.append({"name": "k4hv_augment_heads_volume", "route": "cuda",
                 "source": "bio_image_unet_tpu_torch/csrc/augment_batch.cu",
                 "replaces": "bio_image_unet_tpu/data/augment_jax.py:192", "launches": 0,
                 "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                 "bound_by": by, "library_ms": None, "_counter": augment_heads_volume_apply})
    del image, target
    torch.cuda.empty_cache()
    return rows


# --- 15. the 3D training paths --------------------------------------------------------

class _Items:
    """In-memory training items, dicts of channels-first float32 arrays (the
    form of ``family_bench.py``'s ``Synth3D`` and ``SynthMO``: uniform random
    volumes; here the mask is the volume above 0.5, so the loss has something
    to learn)."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _report_epochs(torch, tag: str, trainer, steps: int, batch: int, flops_per_volume: float,
                   timed) -> float:
    """The per-epoch losses; volumes/s over the best of the ``timed`` epochs
    (``family_bench.py``'s definition, steps·batch over the best training
    pass); the loss must fall.  Returns the best epoch's seconds."""
    hist = trainer.history
    for h in hist:
        log(f"[{tag}] epoch {h['epoch']}: train loss {h['train_loss']:.6f}, val loss "
            f"{h['val_loss']:.6f}, lr {h['lr']:g}, training pass {h['train_seconds']:.3f} s, "
            f"epoch {h['seconds']:.3f} s")
    if not hist[-1]["train_loss"] < hist[0]["train_loss"]:
        raise AssertionError(f"[{tag}] the training loss did not fall")
    best = min(hist[e]["train_seconds"] for e in timed)
    vps = steps * batch / best
    peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] {vps:.2f} volumes/s (best of epochs {list(timed)}), step "
        f"{best / steps * 1e3:.2f} ms; peak device memory {peak / 2**30:.2f} GiB; "
        f"{flops_per_volume / 1e9:.1f} GFLOP per volume forward+backward → "
        f"{flops_per_volume * vps / 1e12:.1f} TFLOP/s, "
        f"{flops_per_volume * vps / PEAK_BF16_FLOPS:.4f} of the bf16 dense peak")
    return best


def phase_train_3d(torch, dev, kernels) -> bytes:
    from bio_image_unet_tpu_torch import multi_output_unet3d, unet3d
    from bio_image_unet_tpu_torch.data.augment_device import (augment_heads_volume_apply,
                                                              augment_volume_apply)
    from bio_image_unet_tpu_torch.ops import histogram as hist
    from bio_image_unet_tpu_torch.ops.stitch import blend_stitch_3d, sigmoid_stitch_3d
    from bio_image_unet_tpu_torch.predict import Predict3D, PredictMultiOutput3D
    from bio_image_unet_tpu_torch.predict.normalize import normalize_tile_3d

    counters = list({id(k["_counter"]): k["_counter"] for k in kernels}.values())
    rows = {k["name"]: k for k in kernels}
    torch.backends.cudnn.allow_tf32 = True  # the user's default
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # the main path: family_bench's Synth3D through the unet3d facade
        t0 = time.perf_counter()
        vols = [rng.random((1,) + T3_SHAPE).astype(np.float32) for _ in range(T3_VOLS)]
        data = _Items([{"image": v, "mask": (v > 0.5).astype(np.float32)} for v in vols])
        trainer = unet3d.Trainer(data, T3_EPOCHS, batch_size=T3_BATCH, n_filter=VOL_FILTER,
                                 val_split=0.0, device_cache=True, half_precision=True,
                                 device_augment=True, save_dir=str(tmp / "u3d"), seed=0,
                                 save_name="model.pt")
        steps = trainer._n_train // T3_BATCH
        log(f"[train 3d] set-up {time.perf_counter() - t0:.2f} s: UNet3D(n_filter="
            f"{VOL_FILTER}), {trainer._n_train} resident volumes of {T3_SHAPE}, {steps} steps "
            f"of {T3_BATCH} per epoch, time_loss_weight {trainer.time_loss_weight}")
        torch.cuda.reset_peak_memory_stats()
        _, got = counted(torch, "train 3d", counters, f"{T3_EPOCHS} epochs", trainer.start,
                         {augment_volume_apply: steps * T3_EPOCHS})
        rows["k4v_augment_volume"]["launches"] = got[augment_volume_apply]
        flops = 3 * unet3d_forward_flops(VOL_FILTER) * np.prod(T3_SHAPE)
        best = _report_epochs(torch, "train 3d", trainer, steps, T3_BATCH, flops,
                              range(1, T3_EPOCHS))
        profile_train_epoch(torch, trainer, T3_EPOCHS, best, tag="train 3d")
        u3d_ckpt = str(tmp / "u3d" / "model.pt")

        # the coverage path: MultiOutputUnet3D with heads through its facade
        t0 = time.perf_counter()
        yy, xx = np.mgrid[:T3H_SHAPE[1], :T3H_SHAPE[2]]
        items = []
        for _ in range(T3H_VOLS):
            theta = np.broadcast_to(np.arctan2(yy - rng.uniform(0, T3H_SHAPE[1]),
                                               xx - rng.uniform(0, T3H_SHAPE[2])), T3H_SHAPE)
            v = rng.random((1,) + T3H_SHAPE).astype(np.float32)
            items.append({"image": v, "mask": (v > 0.5).astype(np.float32),
                          "orientation": np.stack([np.cos(theta), np.sin(theta)])
                          .astype(np.float32)})
        heads = multi_output_unet3d.Trainer(
            _Items(items), MO_TRAIN_HEADS, T3H_EPOCHS, batch_size=T3H_BATCH, n_filter=VOL_FILTER,
            val_split=0.0, device_cache=True, half_precision=True, device_augment=True,
            save_dir=str(tmp / "mo3d"), seed=0, save_name="model.pt")
        h_steps = heads._n_train // T3H_BATCH
        log(f"[train 3d heads] set-up {time.perf_counter() - t0:.2f} s: MultiOutputUnet3D("
            f"n_filter={VOL_FILTER}, use_interpolation={heads.model.use_interpolation}), heads "
            f"{list(MO_TRAIN_HEADS)} "
            f"({', '.join(type(v).__name__ for v in heads.head_losses.values())}), "
            f"{heads._n_train} resident volumes of {T3H_SHAPE}, {h_steps} steps of {T3H_BATCH}")
        torch.cuda.reset_peak_memory_stats()
        _, got = counted(torch, "train 3d heads", counters, f"{T3H_EPOCHS} epochs", heads.start,
                         {augment_heads_volume_apply: h_steps * T3H_EPOCHS})
        rows["k4hv_augment_heads_volume"]["launches"] = got[augment_heads_volume_apply]
        flops = 3 * unet3d_forward_flops(VOL_FILTER, out_channels=3) * np.prod(T3H_SHAPE)
        best = _report_epochs(torch, "train 3d heads", heads, h_steps, T3H_BATCH, flops,
                              range(T3H_EPOCHS))
        profile_train_epoch(torch, heads, T3H_EPOCHS, best, tag="train 3d heads")
        mo3d_ckpt = str(tmp / "mo3d" / "model.pt")
        del trainer, heads, data, vols, items
        torch.cuda.empty_cache()

        # each trained .pt through the port's 3D Predict classes on the card
        vol = rng.integers(0, 255, (32, 128, 128), dtype=np.uint8)
        res, _ = counted(torch, "train 3d→predict", counters, "UNet3D .pt through Predict3D",
                         lambda: Predict3D(vol, None, u3d_ckpt, resize_dim=T3_SHAPE,
                                           show_progress=False, half_precision=True).result,
                         {hist.int_clip_bounds: hist.LAUNCHES[torch.uint8], normalize_tile_3d: 1,
                          sigmoid_stitch_3d: 1})
        if res.shape != vol.shape or res.dtype != np.uint8:
            raise AssertionError(f"Predict3D on the trained UNet3D: {res.shape} {res.dtype}")
        log(f"[train 3d→predict] Predict3D: {res.shape} uint8, mean {res.mean():.2f}")
        res, _ = counted(torch, "train 3d→predict", counters,
                         "MultiOutputUnet3D .pt through PredictMultiOutput3D",
                         lambda: PredictMultiOutput3D(vol, mo3d_ckpt, max_patch_size=T3H_SHAPE,
                                                      show_progress=False,
                                                      half_precision=True).result,
                         {hist.int_clip_bounds: hist.LAUNCHES[torch.uint8], normalize_tile_3d: 1,
                          blend_stitch_3d: len(MO_TRAIN_HEADS)})
        for head, cfg in MO_TRAIN_HEADS.items():
            want = vol.shape if cfg["channels"] == 1 else (cfg["channels"],) + vol.shape
            if res[head].shape != want or not np.isfinite(res[head]).all():
                raise AssertionError(f"PredictMultiOutput3D on the trained model, {head}: "
                                     f"{res[head].shape}")
        log("[train 3d→predict] PredictMultiOutput3D: " + ", ".join(
            f"{h} {v.shape} in [{v.min():.3f}, {v.max():.3f}]" for h, v in res.items()))
        trained = Path(u3d_ckpt).read_bytes()
    train_3d_card_vs_cpu(torch)
    return trained


def train_3d_card_vs_cpu(torch) -> None:
    """``UNet3D(n_filter=4)`` with the facade's temporal loss on 10 volumes of
    (8, 32, 32) (8 training: 2 steps of 4), float32 with TF32 off, resident
    volumes, no augmentation, one epoch: the card's ``metrics.csv`` rows
    against the CPU's, rtol 1e-3."""
    from bio_image_unet_tpu_torch import unet3d

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(6)
    items = _Items([{"volume": rng.random((1, 8, 32, 32)).astype(np.float32),
                     "mask": (rng.random((1, 8, 32, 32)) > 0.6).astype(np.float32)}
                    for _ in range(10)])
    rows, weights = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for dev in ("cuda", "cpu"):
            t = unet3d.Trainer(items, 1, n_filter=4, batch_size=4, lr=1e-4,
                               save_dir=str(Path(tmp) / dev), seed=0, device=dev,
                               device_cache=True)
            if next(t.model.parameters()).device.type != dev:
                raise AssertionError(f"the {dev} run's model is not on {dev}")
            t.start()
            weights[dev] = {k: v.float().cpu() for k, v in t.model.state_dict().items()}
            rows[dev] = metrics_rows(Path(tmp) / dev)[:, 1:]
    rel = np.abs(rows["cuda"] - rows["cpu"]) / np.abs(rows["cpu"])
    dw = max(float((weights["cuda"][k] - v).abs().max()) for k, v in weights["cpu"].items())
    log(f"[train 3d] card vs CPU (UNet3D n_filter=4, (8, 32, 32), float32, TF32 off, 1 epoch): "
        f"card {rows['cuda'].tolist()}, CPU {rows['cpu'].tolist()}, max relative difference "
        f"{rel.max():.2e}; final weights max |card − CPU| {dw:.2e}")
    if not rel.max() <= 1e-3:
        raise AssertionError("the card's 3D training run disagrees with the CPU's")
    torch.backends.cudnn.allow_tf32 = True


# --- 16. kernels of the Siam path --------------------------------------------------------

# benchmarks/family_bench.py:210-258: Siam_UNet(n_filter=32, mode="max"), 256²
# tiles, bf16, 'single', a 32-frame uint8 1024² movie; PredictSiam's default
# chunk of 8 pairs and clip_threshold
SIAM_FRAMES, SIAM_FILTER, SIAM_CHUNK = 32, 32, 8
SIAM_CLIP = (0.0, 99.98)
# K6's shapes: the main path's forward batch (128 pair tiles of 256²: (128,
# 8·32, 16, 16) bf16 channels_last), PredictSiam's defaults (float32 NCHW,
# 512² tiles, 32 pairs a forward batch: the [siam] float32 corr case) and a
# wider float32 timing shape that no path runs (16 pairs of 512² tiles at a
# width of 1024; its row reports 0 launches); the last field: whether a path
# runs the shape
SIAM_XCORR = (((128, 8 * SIAM_FILTER, 16, 16), "bfloat16", True, True),
              ((32, 8 * SIAM_FILTER, 32, 32), "float32", False, True),
              ((16, 1024, 32, 32), "float32", False, False))
# K6's plane form (planes above the tiled staging's 112²: a corr call at tiles
# of ~1800-2720 pixels), held bit-equal to the plain version once
SIAM_XCORR_PLANE = (2, 4, 128, 128)
# the float32 corr case: PredictSiam's default tiles and precision
SIAM_DEFAULTS = {"resize_dim": (512, 512), "half_precision": False}


def xcorr_macs(h: int, w: int, kh: int, kw: int) -> int:
    """Multiply-adds of K6 on one (h, w) plane with a (kh, kw) kernel, the
    taps on the zero pad not counted."""
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    rows = sum(min(kh, h + ph - i) - max(0, ph - i) for i in range(h))
    cols = sum(min(kw, w + pw - j) - max(0, pw - j) for j in range(w))
    return rows * cols


def phase_kernels_siam(torch, dev) -> list:
    """K1 (per frame and its pair rows), K2p, K3 and K6 at the Siam path's
    shapes."""
    import torch.nn.functional as F

    from bio_image_unet_tpu_torch.ops import histogram as hist
    from bio_image_unet_tpu_torch.ops.functional import depthwise_xcorr, depthwise_xcorr_plain
    from bio_image_unet_tpu_torch.ops.stitch import sigmoid_stitch, sigmoid_stitch_plain
    from bio_image_unet_tpu_torch.predict.normalize import (normalize_tile_pairs,
                                                            normalize_tile_pairs_plain)
    from bio_image_unet_tpu_torch.predict.tiling import TilePlan, grid_starts

    timer = Timer(torch, dev)
    g = torch.Generator(device=dev).manual_seed(7)
    k = SIAM_CHUNK
    rows = []

    def row(*args):
        rows.append(kernel_row("kernels siam", *args))

    # K1 per frame, as 'single' runs it: the (9, 1024²) uint8 block of a chunk
    block = torch.randint(0, 256, (k + 1, H, W), generator=g, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    ours = hist.int_clip_bounds(block, *SIAM_CLIP)
    torch.cuda.synchronize()
    ref = hist.clip_bounds_plain(block, *SIAM_CLIP)
    if not torch.equal(ours.view(torch.int32), ref.view(torch.int32)):
        raise AssertionError(f"K1 (9, 1024^2): kernel {ours.tolist()} != plain {ref.tolist()}")
    row("k1_int_clip_bounds[uint8 (9, 1024^2) siam chunk]",
        "bio_image_unet_tpu_torch/csrc/clip_bounds.cu", "bio_image_unet_tpu/ops/histogram.py:110",
        hist.int_clip_bounds, (ours - ref).abs().max().item(),
        timer(lambda: hist.int_clip_bounds(block, *SIAM_CLIP)),
        timer(lambda: hist.clip_bounds_plain(block, *SIAM_CLIP), 3),
        # read every pixel once, one compare each; write 4 bounds a frame
        bound_ms(block.numel() + 16 * (k + 1), block.numel()),
        timer(lambda: torch.sort(block.reshape(k + 1, -1), dim=1), 5))

    # K1's pair-row form: 8 rows of 2·1024² uint8 values, read in place
    flat = block.reshape(k + 1, -1)
    pairs = torch.cat([flat[:-1], flat[1:]], dim=1)
    ours = hist.pair_clip_bounds(block, *SIAM_CLIP)
    torch.cuda.synchronize()
    ref = hist.clip_bounds_plain(pairs, *SIAM_CLIP)
    if not torch.equal(ours.view(torch.int32), ref.view(torch.int32)):
        raise AssertionError(f"K1 pair rows: kernel {ours.tolist()} != plain {ref.tolist()}")
    row("k1_pair_clip_bounds[uint8 (9, 1024^2) -> 8 pair rows]",
        "bio_image_unet_tpu_torch/csrc/clip_bounds.cu", "bio_image_unet_tpu/predict/predictor.py:987",
        hist.pair_clip_bounds, (ours - ref).abs().max().item(),
        timer(lambda: hist.pair_clip_bounds(block, *SIAM_CLIP)),
        timer(lambda: hist.clip_bounds_plain(
            torch.cat([flat[:-1], flat[1:]], dim=1), *SIAM_CLIP), 3),
        # read the block once, one compare per row value; write 4 bounds a row
        bound_ms(block.numel() + 16 * k, pairs.numel()),
        timer(lambda: torch.sort(pairs, dim=1), 5))
    del pairs

    # K2p at the main path's shapes: per-frame bounds, the exact grid, the
    # forward batch of 128 pair tiles
    plan = TilePlan(H, W, TILE, TILE, grid_starts(H, TILE), grid_starts(W, TILE), dev)
    n_pad = k * plan.per_frame
    bounds = hist.clip_bounds(block, *SIAM_CLIP)
    ours = normalize_tile_pairs(block, bounds, plan, n_pad, False)
    torch.cuda.synchronize()
    ref = normalize_tile_pairs_plain(block, bounds, plan, n_pad, False)
    err = (ours.int() - ref.int()).abs().max().item()
    if err != 0:
        raise AssertionError(f"K2p exact: kernel differs from plain by {err} levels")
    out_bytes = ours.numel()
    row("k2p_normalize_tile_pairs[uint8 (9, 1024^2) -> 2x(128, 256^2)]",
        "bio_image_unet_tpu_torch/csrc/normalize_tile.cu",
        "bio_image_unet_tpu/predict/predictor.py:995", normalize_tile_pairs, err,
        timer(lambda: normalize_tile_pairs(block, bounds, plan, n_pad, False)),
        timer(lambda: normalize_tile_pairs_plain(block, bounds, plan, n_pad, False), 3),
        # read each source pixel once, write each tile pixel of both sets once;
        # about five float operations per tile pixel
        bound_ms(block.numel() + bounds.numel() * 4 + out_bytes, 5 * out_bytes), None)
    # the zero pad with invert: 200×300 frames in 256² tiles (2 a frame)
    small = torch.randint(0, 256, (k + 1, 200, 300), generator=g, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    splan = TilePlan(200, 300, TILE, TILE, grid_starts(200, TILE), grid_starts(300, TILE), dev)
    sb = hist.clip_bounds(small, *SIAM_CLIP)
    ours = normalize_tile_pairs(small, sb, splan, k * splan.per_frame, True)
    torch.cuda.synchronize()
    ref = normalize_tile_pairs_plain(small, sb, splan, k * splan.per_frame, True)
    if not torch.equal(ours, ref) or ours[:, :, 200:].any():
        raise AssertionError("K2p zero pad + invert: kernel differs from plain")
    log(f"[kernels siam] k2p zero pad + invert, 9x200x300 in 256^2 tiles -> 2x{ours.shape[1]} "
        f"tiles: equal to plain, the pad 0 | kernel "
        f"{timer(lambda: normalize_tile_pairs(small, sb, splan, k * splan.per_frame, True)):.4f} ms")
    del block, small, ours, ref

    # K3 at the main path's forward batch: 128 bf16 logit tiles → 8 frames
    logits = (torch.randn((n_pad, 1, TILE, TILE), generator=g, device=dev) * 4
              ).to(torch.bfloat16)
    ours = sigmoid_stitch(logits, k, plan)
    torch.cuda.synchronize()
    ref = sigmoid_stitch_plain(logits, k, plan)
    err = (ours.int() - ref.int()).abs().max().item()
    if err > 1:
        raise AssertionError(f"K3 (128 tiles -> 8 frames): kernel differs from plain by {err} levels")
    row("k3_sigmoid_stitch[bf16 (128, 1, 256^2) -> 8x1024^2 siam chunk]",
        "bio_image_unet_tpu_torch/csrc/sigmoid_stitch.cu",
        "bio_image_unet_tpu/predict/predictor.py:450", sigmoid_stitch, err,
        timer(lambda: sigmoid_stitch(logits, k, plan)),
        timer(lambda: sigmoid_stitch_plain(logits, k, plan), 3),
        # read each logit once (bf16), write each pixel once; about five
        # operations per logit (exp, add, divide, scale, the sum)
        bound_ms(logits.numel() * 2 + k * H * W, 5 * logits.numel()), None)
    del logits, ours, ref

    # K6, the corr join
    for shape, dtype_name, cl, on_path in SIAM_XCORR:
        dtype = getattr(torch, dtype_name)
        cur = torch.randn(shape, generator=g, device=dev).to(dtype)
        prev = torch.randn(shape, generator=g, device=dev).to(dtype)
        if cl:
            cur = cur.contiguous(memory_format=torch.channels_last)
            prev = prev.contiguous(memory_format=torch.channels_last)
        ours = depthwise_xcorr(cur, prev)
        torch.cuda.synchronize()
        ref = depthwise_xcorr_plain(cur, prev)
        diff = (ours.float() - ref.float()).abs()
        if dtype == torch.float32:
            limit = 1e-5 * depthwise_xcorr_plain(cur.abs(), prev.abs())
            what = "1e-5 of the sum of |a*b|"
        else:
            limit = torch.finfo(torch.bfloat16).eps * ref.float().abs()
            what = "one bf16 ulp"
        if not (diff <= limit).all():
            raise AssertionError(f"K6 {tuple(shape)} {dtype}: beyond {what} of the plain version "
                                 f"(max {diff.max().item()})")
        if not torch.equal(ours, ref):  # the plain version's order and rounding
            raise AssertionError(f"K6 {tuple(shape)} {dtype}: not bit-equal to the plain version")
        b, c, h, w = shape
        x_lib = cur.contiguous().reshape(1, b * c, h, w)
        w_lib = prev.contiguous().reshape(b * c, 1, h, w)
        try:
            lib = timer(lambda: F.conv2d(x_lib, w_lib, groups=b * c, padding="same"), 5)
        except RuntimeError as err:
            log(f"[kernels siam] grouped F.conv2d refused {tuple(shape)} {dtype}: {err}")
            lib = None
        name = ("bf16 channels_last" if cl else "float32") + ("" if on_path else " timing only")
        n_flops = 2 * b * c * xcorr_macs(h, w, h, w)
        n_bytes = 3 * cur.numel() * cur.element_size()
        # the card's rate for the operand type: bf16 operands could run on the
        # tensor cores (a Toeplitz product), float32 ones on the CUDA cores
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_SCALAR_OPS_PER_S
        row(f"k6_depthwise_xcorr[{name} {b}x{c}x{h}x{w}]",
            "bio_image_unet_tpu_torch/csrc/depthwise_xcorr.cu",
            "bio_image_unet_tpu/ops/functional.py:95", depthwise_xcorr, diff.max().item(),
            timer(lambda: depthwise_xcorr(cur, prev)),
            timer(lambda: depthwise_xcorr_plain(cur, prev), 3),
            # two inputs read once, the output written once; a multiply and an
            # add per product on a real pixel (the zero pad's are not needed)
            bound_ms(n_bytes, n_flops, peak), lib)
        rows[-1]["_timing_only"] = not on_path
        if dtype == torch.bfloat16:
            ceiling, by = bound_ms(n_bytes, n_flops)
            log(f"[kernels siam]   k6 {tuple(shape)}: this design's ceiling (float32 on the "
                f"CUDA cores at 67 TFLOP/s) {ceiling:.4f} ms ({by})")
        log(f"[kernels siam]   k6 {tuple(shape)}: {b * c * xcorr_macs(h, w, h, w) / 1e9:.3f} G "
            f"multiply-adds on real pixels, {b * c * h * w * h * w / 1e9:.3f} G with the zero pad; "
            f"within {what}")
        del cur, prev, ours, ref, diff, limit
    # the plane form, once, NCHW and channels_last
    cur = torch.randn(SIAM_XCORR_PLANE, generator=g, device=dev)
    prev = torch.randn(SIAM_XCORR_PLANE, generator=g, device=dev)
    for fmt in (torch.contiguous_format, torch.channels_last):
        cur, prev = cur.contiguous(memory_format=fmt), prev.contiguous(memory_format=fmt)
        ours = depthwise_xcorr(cur, prev)
        torch.cuda.synchronize()
        if not torch.equal(ours, depthwise_xcorr_plain(cur, prev)):
            raise AssertionError(f"K6's plane form {SIAM_XCORR_PLANE} {fmt}: not bit-equal to "
                                 "the plain version")
    log(f"[kernels siam] k6 plane form {SIAM_XCORR_PLANE} float32, NCHW and channels_last: "
        f"bit-equal to plain | kernel {timer(lambda: depthwise_xcorr(cur, prev)):.4f} ms")
    del cur, prev, ours
    torch.cuda.empty_cache()
    return rows


# --- 17. the Siam path --------------------------------------------------------------------

def siam_forward_flops(nf: int, s: int, join: str) -> float:
    """Multiply-add FLOPs of one s² pair tile through ``Siam_UNet(n_filter=
    nf)``: the ``Unet`` count, the prev frame's encoder (levels 1–4) and,
    for ``concat``, the 3×3 join conv; the pools, the join's elementwise
    work and K6 are not counted."""
    def conv(ci, co, hw):
        return 2 * ci * co * 9 * hw

    hw = s * s
    widths = [(1, nf), (nf, 2 * nf), (2 * nf, 4 * nf), (4 * nf, 8 * nf)]
    f = unet_forward_flops(nf, s) + sum(conv(ci, co, hw / 4 ** lv) + conv(co, co, hw / 4 ** lv)
                                        for lv, (ci, co) in enumerate(widths))
    return f + (conv(16 * nf, 8 * nf, hw / 256) if join == "concat" else 0.0)


def phase_siam(torch, dev, kernels, ksiam) -> None:
    from bio_image_unet_tpu_torch import siam_unet
    from bio_image_unet_tpu_torch.data import tiff
    from bio_image_unet_tpu_torch.ops import histogram as hist
    from bio_image_unet_tpu_torch.ops.functional import depthwise_xcorr
    from bio_image_unet_tpu_torch.ops.stitch import sigmoid_stitch
    from bio_image_unet_tpu_torch.predict.normalize import normalize_tile_pairs
    from bio_image_unet_tpu_torch.predict.predictor import _Engine
    from bio_image_unet_tpu_torch.predict.tiling import grid_starts

    torch.backends.cudnn.allow_tf32 = True  # the user's default
    counters = list({id(k["_counter"]): k["_counter"] for k in kernels + ksiam}.values())
    rows = {k["name"]: k for k in ksiam}
    k1_launches = {np.dtype(np.uint8): hist.LAUNCHES[torch.uint8],
                   np.dtype(np.uint16): hist.LAUNCHES[torch.uint16],
                   np.dtype(np.float32): hist.LAUNCHES[torch.float32]}

    def forward_batch(n_frames, fpc, tile, h, w, add=0, batch_size=8):
        per = len(grid_starts(h, tile, add)) * len(grid_starts(w, tile, add))
        n = min(fpc, n_frames) * per
        return max(batch_size, min(n, _Engine.PAIR_STEP_PX // (tile * tile))), n

    def expect(movie, fpc=SIAM_CHUNK, norm="single", join="max", add=0, tile=TILE):
        """Per chunk: K1 (its pair form for 'all'; K1f for float32), K2p, K3,
        and K6 once a forward batch under corr."""
        n_frames, h, w = movie.shape
        chunks = -(-n_frames // fpc)
        k1 = (hist.pair_clip_bounds if norm == "all" else
              hist.float_clip_bounds if movie.dtype == np.float32 else hist.int_clip_bounds)
        e = {k1: k1_launches[movie.dtype] * chunks, normalize_tile_pairs: chunks,
             sigmoid_stitch: chunks}
        if join == "corr":
            bs, n = forward_batch(n_frames, fpc, tile, h, w, add)
            e[depthwise_xcorr] = chunks * (-(-n // bs))
        return e

    codec = {"decode": 0.0, "write": 0.0}
    read_page, write_page = tiff.TiffReader.read_page, tiff.TiffWriter.write

    def timed_read(self, index):
        t0 = time.perf_counter()
        page = read_page(self, index)
        codec["decode"] += time.perf_counter() - t0
        return page

    def timed_write(self, page):
        t0 = time.perf_counter()
        write_page(self, page)
        codec["write"] += time.perf_counter() - t0

    rng = np.random.default_rng(11)
    movie = rng.integers(0, 255, (SIAM_FRAMES, H, W), dtype=np.uint8)
    kw = dict(resize_dim=(TILE, TILE), half_precision=True, show_progress=False)
    main = "Siam_UNet max uint8 32x1024^2 (family_bench)"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ckpts = {}
        for seed, join in enumerate(("max", "corr", "concat", "control")):
            ckpts[join] = str(tmp / f"siam_{join}_nf32.pt")
            write_checkpoint(torch, ckpts[join], "Siam_UNet", SIAM_FILTER, seed=20 + seed,
                             mode=join)

        def src_of(name, m):
            path = str(tmp / f"{name}.tif")
            tiff.imwrite(path, m)
            return path

        src = src_of("movie", movie)
        out = str(tmp / "out_main.tif")
        tiff.TiffReader.read_page, tiff.TiffWriter.write = timed_read, timed_write
        try:
            torch.cuda.reset_peak_memory_stats()
            best, split = float("inf"), None
            for rep in ("warm-up", "timed 1", "timed 2"):
                codec.update(decode=0.0, write=0.0)
                t0 = time.perf_counter()
                pred, got = counted(torch, "siam", counters, f"{main}, {rep}",
                                    lambda: siam_unet.Predict(src, out, ckpts["max"], **kw),
                                    expect(movie))
                dt = time.perf_counter() - t0
                if rep != "warm-up" and dt < best:
                    best, split = dt, dict(pred.engine.chunk_seconds, **codec)
        finally:
            tiff.TiffReader.read_page, tiff.TiffWriter.write = read_page, write_page
        peak = torch.cuda.max_memory_allocated()
        fused = tiff.imread(out)
        rows["k2p_normalize_tile_pairs[uint8 (9, 1024^2) -> 2x(128, 256^2)]"]["launches"] = \
            got[normalize_tile_pairs]
        rows["k1_int_clip_bounds[uint8 (9, 1024^2) siam chunk]"]["launches"] = \
            got[hist.int_clip_bounds]
        rows["k3_sigmoid_stitch[bf16 (128, 1, 256^2) -> 8x1024^2 siam chunk]"]["launches"] = \
            got[sigmoid_stitch]

        # host-staged at the fused path's forward batch
        bs, _ = forward_batch(SIAM_FRAMES, SIAM_CHUNK, TILE, H, W)
        host_out = str(tmp / "out_host.tif")
        counted(torch, "siam", counters, f"{main}, host-staged at batch {bs}",
                lambda: siam_unet.Predict(src, host_out, ckpts["max"], device_pipeline=False,
                                          **dict(kw, batch_size=bs)),
                {sigmoid_stitch: SIAM_FRAMES // SIAM_CHUNK})
        check_fused_vs_host(main, fused, tiff.imread(host_out), movie.shape, "siam")

        # device-resident: the chunk program on a 17-frame block on the card,
        # the call's first two chunks (frame 0's prev is frame 1)
        block = torch.from_numpy(np.concatenate([movie[1:2], movie[:2 * SIAM_CHUNK]])).to(dev)

        def device_resident(engine):
            """(run, best seconds of three, its masks, forward batch, plan) of
            ``engine``'s chunk program over the block's two chunks."""
            fn, plan, bs_dev = engine.pairs_runner(H, W, grid_starts(H, TILE),
                                                   grid_starts(W, TILE), (TILE, TILE),
                                                   SIAM_CLIP, False, "single", SIAM_CHUNK)

            def run():
                return [fn(block[i:i + SIAM_CHUNK + 1]) for i in (0, SIAM_CHUNK)]

            run()
            torch.cuda.synchronize()
            best_dev = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                outs = run()
                torch.cuda.synchronize()
                best_dev = min(best_dev, time.perf_counter() - t0)
            return run, best_dev, outs, bs_dev, plan

        resident, best_dev, outs, bs_dev, plan = device_resident(pred.engine)
        same = int(np.abs(torch.cat(outs).cpu().numpy().astype(np.int16)
                          - fused[:2 * SIAM_CHUNK]).max())
        log(f"[siam] device-resident run vs its Predict run: max {same} levels")
        if same != 0:
            raise AssertionError("the device-resident pair program disagrees with Predict")
        profile_pass(torch, lambda: [resident() for _ in range(2)], "siam",
                     "two passes over a 17-frame block")
        del outs
        e2e = SIAM_FRAMES * H * W / 1e6 / best
        resident_mps = 2 * SIAM_CHUNK * H * W / 1e6 / best_dev
        flops = siam_forward_flops(SIAM_FILTER, TILE, "max")
        tiles_per_mp = plan.per_frame / (H * W / 1e6)
        log(f"[siam] {main}: end-to-end {e2e:.2f} MP/s ({best:.3f} s); device-resident "
            f"{resident_mps:.2f} MP/s ({best_dev * 1e3:.2f} ms for 16 pairs); forward batch "
            f"{bs_dev}; peak device memory {peak / 2**30:.2f} GiB; {flops / 1e9:.2f} GFLOP per pair "
            f"tile → {flops * tiles_per_mp * e2e / 1e12:.1f} TFLOP/s end to end "
            f"({flops * tiles_per_mp * e2e / PEAK_BF16_FLOPS:.4f} of the bf16 dense peak), "
            f"{flops * tiles_per_mp * resident_mps / 1e12:.1f} TFLOP/s device-resident "
            f"({flops * tiles_per_mp * resident_mps / PEAK_BF16_FLOPS:.4f})")
        log(f"[siam] host time of the best call ({best:.3f} s): "
            + ", ".join(f"{k} {v:.3f} s" for k, v in split.items())
            + " (host clock, the download's excepted: produce includes the page decode, "
              "sink the TIFF write; wait = blocked on the ring's oldest chunk; download = "
              "a chunk's compute done to its mask in host memory, device clock, overlapped)")

        # coverage: each case fused (launches exact) against host-staged at
        # the same forward batch
        small = rng.integers(0, 255, (37, 200, 300), dtype=np.uint8)
        cases = [
            ("corr join", "corr", movie[:16], {}, {"join": "corr"}),
            ("corr join float32 at PredictSiam's defaults (512^2 tiles)", "corr", movie[:16],
             SIAM_DEFAULTS, {"join": "corr", "tile": SIAM_DEFAULTS["resize_dim"][0]}),
            ("concat join", "concat", movie[:16], {}, {}),
            ("control join", "control", movie[:16], {}, {}),
            ("'first'", "max", movie[:16], {"normalization_mode": "first"}, {}),
            ("'all'", "max", movie[:16], {"normalization_mode": "all"}, {"norm": "all"}),
            ("uint16 16x1000^2 add_tile=1", "max",
             rng.integers(0, 65535, (16, 1000, 1000), dtype=np.uint16), {"add_tile": 1},
             {"add": 1}),
            ("37x200x300 zero pad + tail chunk", "max", small, {}, {}),
            ("1 frame", "max", movie[:1], {}, {}),
            ("frames_per_chunk=1", "max", movie[:4], {"frames_per_chunk": 1}, {"fpc": 1}),
            ("float32 device_pipeline=True", "max",
             (rng.standard_normal((16, H, W)) * 40 + 5).astype(np.float32),
             {"device_pipeline": True}, {}),
        ]
        for name, join, m, extra, exp in cases:
            path = src_of("case", m)
            fused_out, host_out = str(tmp / "case_fused.tif"), str(tmp / "case_host.tif")
            t0 = time.perf_counter()
            case_pred, got = counted(torch, "siam", counters, name,
                                     lambda: siam_unet.Predict(path, fused_out, ckpts[join],
                                                               **dict(kw, **extra)),
                                     expect(m, **exp))
            dt = time.perf_counter() - t0
            tile = extra.get("resize_dim", (TILE,))[0]
            if join != "max" and tile == TILE:
                # the join's device-resident time on the main movie's block
                _, join_dev, _, _, _ = device_resident(case_pred.engine)
                log(f"[siam] {name}: device-resident {2 * SIAM_CHUNK * H * W / 1e6 / join_dev:.2f} "
                    f"MP/s ({join_dev * 1e3:.2f} ms for 16 pairs; max: {best_dev * 1e3:.2f} ms)")
            fpc = extra.get("frames_per_chunk", SIAM_CHUNK)
            bs, _ = forward_batch(m.shape[0], fpc, tile, m.shape[1], m.shape[2],
                                  extra.get("add_tile", 0))
            if join == "corr":
                # the K6 row at this call's forward batch and dtype takes its launches
                dtype_name = "float32" if extra.get("half_precision") is False else "bf16"
                shape = f" {bs}x{8 * SIAM_FILTER}x{tile // 16}x{tile // 16}]"
                hit = [r for r in rows.values() if r["_counter"] is depthwise_xcorr
                       and r["name"].endswith(shape) and dtype_name in r["name"]]
                if len(hit) != 1:
                    raise AssertionError(f"[siam] {name}: {len(hit)} K6 rows at{shape[:-1]}")
                hit[0]["launches"] = got[depthwise_xcorr]
            if exp.get("norm") == "all":
                rows["k1_pair_clip_bounds[uint8 (9, 1024^2) -> 8 pair rows]"]["launches"] = \
                    got[hist.pair_clip_bounds]
            host_kw = dict(kw, batch_size=bs, **{k: v for k, v in extra.items()
                                                 if k != "device_pipeline"})
            siam_unet.Predict(path, host_out, ckpts[join], device_pipeline=False, **host_kw)
            log(f"[siam] {name}: {dt:.3f} s end to end (one call, set-up included)")
            want = m.shape if m.shape[0] > 1 else m.shape[1:]
            check_fused_vs_host(name, tiff.imread(fused_out), tiff.imread(host_out), want, "siam")

        del block
        # a small float32 reference: the card against the CPU, TF32 off
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        small_src = src_of("small", rng.integers(0, 255, (5, 100, 90), dtype=np.uint8))
        for join in ("max", "corr"):
            ckpt = str(tmp / f"siam_{join}_nf8.pt")
            write_checkpoint(torch, ckpt, "Siam_UNet", 8, seed=30, mode=join)
            skw = dict(resize_dim=(64, 64), frames_per_chunk=2, show_progress=False)
            card, cpu = str(tmp / "card.tif"), str(tmp / "cpu.tif")
            siam_unet.Predict(small_src, card, ckpt, **skw)
            siam_unet.Predict(small_src, cpu, ckpt, device="cpu", **skw)
            check_u8_volume("siam", f"small float32 {join} 5x100x90: card vs CPU",
                            tiff.imread(card), tiff.imread(cpu), (5, 100, 90))
        torch.backends.cudnn.allow_tf32 = True


# --- 18. kernels of Siam training ------------------------------------------------------

# config 3's training leg (benchmarks/family_bench.py:262-290): 120 tiles of
# 256², batch 12, Siam_UNet(32), lr 1e-4, bf16, resident and augmented tiles
SIAM_TRAIN_TILES, SIAM_TRAIN_BATCH, SIAM_TRAIN_EPOCHS, SIAM_TRAIN_LR = 120, 12, 3, 1e-4
# K6b's shapes, cur (B, C, H, W) and the kernel (kh, kw): config 3's training
# batch ((12, 8·32, 16, 16) bf16 channels_last, the [train siam] path), the
# siam_unet facade's defaults (float32, batch 4), an odd kernel (240² tiles)
# and a plane larger than its kernel; the last field: whether a path runs it
XCORR_GRAD_SHAPES = (
    ((SIAM_TRAIN_BATCH, 8 * SIAM_FILTER, 16, 16), (16, 16), "bfloat16", True, True),
    ((4, 8 * SIAM_FILTER, 16, 16), (16, 16), "float32", False, False),
    ((SIAM_TRAIN_BATCH, 8 * SIAM_FILTER, 15, 15), (15, 15), "bfloat16", True, False),
    ((SIAM_TRAIN_BATCH, 8 * SIAM_FILTER, 32, 32), (16, 16), "bfloat16", True, False),
)


def xcorr_grad_input_macs(h: int, w: int, kh: int, kw: int) -> int:
    """Multiply-adds of K6b's grad input on one (h, w) plane: the taps whose
    ``g[y + ph - u, x + pw - v]`` lies in the plane (the swapped padding)."""
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    rows = sum(min(kh, i + ph + 1) - max(0, i + ph - h + 1) for i in range(h))
    cols = sum(min(kw, j + pw + 1) - max(0, j + pw - w + 1) for j in range(w))
    return rows * cols


def phase_kernels_siam_training(torch, dev) -> list:
    """K6 at the Siam trainer's forward shape and K6b's two forms (grad input,
    grad kernel) at ``XCORR_GRAD_SHAPES``: each bit-equal to its plain version
    (and so within 1e-5 of the sum of |a·b| in float32, one ulp in bf16),
    timed beside its bound and beside the autograd backward of one grouped
    ``F.conv2d`` (the reference's formulation) on the same operands."""
    import torch.nn.functional as F

    from bio_image_unet_tpu_torch.ops.functional import (depthwise_xcorr,
                                                         depthwise_xcorr_grad_input,
                                                         depthwise_xcorr_grad_input_plain,
                                                         depthwise_xcorr_grad_kernel,
                                                         depthwise_xcorr_grad_kernel_plain,
                                                         depthwise_xcorr_plain,
                                                         xcorr_grad_geometry)

    timer = Timer(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(17)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    source = "bio_image_unet_tpu_torch/csrc/depthwise_xcorr.cu"
    replaces = "bio_image_unet_tpu/ops/functional.py:95"

    def row(*args, timing_only=False):
        rows.append(kernel_row("kernels siam training", *args))
        rows[-1]["_timing_only"] = timing_only

    def held(name, ours, ref, bound):
        """``ours`` bit-equal to the plain version ``ref``, and within its
        tolerance of it (1e-5 of ``bound``, the sum of |a·b|, in float32;
        one ulp in bf16)."""
        diff = (ours.float() - ref.float()).abs()
        limit = (1e-5 * bound.float() if ours.dtype == torch.float32
                 else torch.finfo(torch.bfloat16).eps * ref.float().abs())
        if not (diff <= limit).all() or not torch.equal(ours, ref):
            raise AssertionError(f"{name}: not bit-equal to the plain version "
                                 f"(max {diff.max().item()})")
        return diff.max().item()

    def library(fn):
        try:
            return timer(fn, 5)
        except RuntimeError as err:
            log(f"[kernels siam training] grouped F.conv2d refused: {err}")
            return None

    for shape, kernel, dtype_name, cl, on_path in XCORR_GRAD_SHAPES:
        dtype = getattr(torch, dtype_name)
        b, c, h, w = shape
        kh, kw = kernel
        cur, g = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(2))
        prev = torch.randn(shape[:2] + kernel, generator=gen, device=dev).to(dtype)
        if cl:
            cur, g, prev = (t.contiguous(memory_format=torch.channels_last)
                            for t in (cur, g, prev))
        name = (f"{'bf16 channels_last' if cl else 'float32'} {b}x{c}x{h}x{w} k{kh}x{kw}"
                + ("" if on_path else " timing only"))
        for form, kernel_grad in (("grad input", False), ("grad kernel", True)):
            geo = xcorr_grad_geometry(b * c, h, w, kh, kw, kernel_grad, cur.element_size(), sms)
            log(f"[kernels siam training] K6b {form} {name}: "
                + ("the plane form" if geo is None else
                   f"{geo.cg} planes a block, {geo.n} tiles a warp, {-(-b * c // geo.cg)} blocks "
                   f"of {geo.threads} threads, {geo.smem} B of shared memory; {sms} SMs"))
        # the reference's grouped conv and its autograd backward
        x_lib = cur.contiguous().reshape(1, b * c, h, w).requires_grad_()
        w_lib = prev.contiguous().reshape(b * c, 1, kh, kw).requires_grad_()
        g_lib = g.contiguous().reshape(1, b * c, h, w)
        try:
            with torch.enable_grad():
                out_lib = F.conv2d(x_lib, w_lib, groups=b * c, padding="same")
        except RuntimeError as err:
            log(f"[kernels siam training] grouped F.conv2d refused {tuple(shape)}: {err}")
            out_lib = None
        # the bf16 operands could run on the tensor cores (a Toeplitz
        # product), float32 ones on the CUDA cores
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_SCALAR_OPS_PER_S
        e = cur.element_size()
        plane, ker = b * c * h * w * e, b * c * kh * kw * e
        if on_path:
            # K6, the forward the trainer launches at this shape
            ours = depthwise_xcorr(cur, prev)
            torch.cuda.synchronize()
            err = held("K6 " + name, ours, depthwise_xcorr_plain(cur, prev),
                       depthwise_xcorr_plain(cur.abs(), prev.abs()))
            row(f"k6_depthwise_xcorr[{name} siam training forward]", source, replaces,
                depthwise_xcorr, err, timer(lambda: depthwise_xcorr(cur, prev)),
                timer(lambda: depthwise_xcorr_plain(cur, prev), 3),
                bound_ms(2 * plane + ker, 2 * b * c * xcorr_macs(h, w, kh, kw), peak),
                None if out_lib is None else library(
                    lambda: F.conv2d(x_lib.detach(), w_lib.detach(), groups=b * c,
                                     padding="same")))
        # K6b grad input: g and the kernel read once, dcur written once
        ours = depthwise_xcorr_grad_input(g, prev)
        torch.cuda.synchronize()
        err = held("K6b-in " + name, ours, depthwise_xcorr_grad_input_plain(g, prev),
                   depthwise_xcorr_grad_input_plain(g.abs(), prev.abs()))
        row(f"k6b_xcorr_grad_input[{name}]", source, replaces, depthwise_xcorr_grad_input, err,
            timer(lambda: depthwise_xcorr_grad_input(g, prev)),
            timer(lambda: depthwise_xcorr_grad_input_plain(g, prev), 3),
            bound_ms(2 * plane + ker, 2 * b * c * xcorr_grad_input_macs(h, w, kh, kw), peak),
            None if out_lib is None else library(
                lambda: torch.autograd.grad(out_lib, x_lib, g_lib, retain_graph=True)),
            timing_only=not on_path)
        # K6b grad kernel: g and cur read once, dprev written once
        ours = depthwise_xcorr_grad_kernel(g, cur, kernel)
        torch.cuda.synchronize()
        err = held("K6b-k " + name, ours, depthwise_xcorr_grad_kernel_plain(g, cur, kernel),
                   depthwise_xcorr_grad_kernel_plain(g.abs(), cur.abs(), kernel))
        row(f"k6b_xcorr_grad_kernel[{name}]", source, replaces, depthwise_xcorr_grad_kernel,
            err, timer(lambda: depthwise_xcorr_grad_kernel(g, cur, kernel)),
            timer(lambda: depthwise_xcorr_grad_kernel_plain(g, cur, kernel), 3),
            bound_ms(2 * plane + ker, 2 * b * c * xcorr_macs(h, w, kh, kw), peak),
            None if out_lib is None else library(
                lambda: torch.autograd.grad(out_lib, w_lib, g_lib, retain_graph=True)),
            timing_only=not on_path)
        if on_path:
            # whether a launch holds the host: 50 calls enqueued behind a
            # 20 ms device spin take ~the spin more on the host clock if so
            for label, call in (("k6", lambda: depthwise_xcorr(cur, prev)),
                                ("k6b grad input", lambda: depthwise_xcorr_grad_input(g, prev)),
                                ("k6b grad kernel",
                                 lambda: depthwise_xcorr_grad_kernel(g, cur, kernel)),
                                ("torch.add (control)", lambda: torch.add(cur, cur))):
                call()
                torch.cuda.synchronize()
                torch.cuda._sleep(40 * HOST_LEAD_CYCLES)
                t0 = time.perf_counter()
                for _ in range(50):
                    call()
                host = time.perf_counter() - t0
                torch.cuda.synchronize()
                log(f"[kernels siam training] {label} {name}: 50 calls enqueued behind a ~20 ms "
                    f"device spin in {host * 1e3:.3f} ms on the host clock "
                    f"({host / 50 * 1e6:.1f} us a call)")
        del cur, g, prev, ours, x_lib, w_lib, g_lib, out_lib
    torch.cuda.empty_cache()
    return rows


# --- 19. Siam training ------------------------------------------------------------------

def write_pair_frames(root: Path, n: int, size: int, seed: int) -> tuple:
    """``n`` W-doubled blob pairs (the left half the previous frame: the
    current one shifted by up to 3 pixels, with noise) and the current
    frames' masks as TIFFs under ``root``/image and ``root``/label (the
    layout ``siam_unet.DataProcess`` reads)."""
    from bio_image_unet_tpu_torch.data import tiff
    from bio_image_unet_tpu_torch.utils.synth import blob_sample

    rng = np.random.default_rng(seed)
    for sub in ("image", "label"):
        (root / sub).mkdir(parents=True)
    for i in range(n):
        img, mask = blob_sample(rng, (size, size), n_blobs=10, margin=16, radius=(8, 20))
        prev = np.roll(img, tuple(rng.integers(-3, 4, 2)), (0, 1)).astype(np.float32)
        prev = np.clip(prev + rng.normal(0, 8, prev.shape), 0, 255).astype(np.uint8)
        tiff.imwrite(str(root / "image" / f"{i:04d}.tif"), np.concatenate([prev, img], 1))
        tiff.imwrite(str(root / "label" / f"{i:04d}.tif"), mask)
    return (str(root / "image") + "/", str(root / "label") + "/")


def phase_train_siam(torch, dev, kernels, ksiam_train) -> None:
    from bio_image_unet_tpu_torch import siam_unet
    from bio_image_unet_tpu_torch.data import tiff
    from bio_image_unet_tpu_torch.data.augment_device import augment_apply
    from bio_image_unet_tpu_torch.ops.functional import (depthwise_xcorr,
                                                         depthwise_xcorr_grad_input,
                                                         depthwise_xcorr_grad_kernel)
    from bio_image_unet_tpu_torch.utils.synth import blob_sample

    counters = list({id(k["_counter"]): k["_counter"] for k in kernels + ksiam_train}.values())
    on_path = [k for k in ksiam_train if not k["_timing_only"]]
    torch.backends.cudnn.allow_tf32 = True  # the user's default
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        source = write_pair_frames(tmp / "frames", SIAM_TRAIN_TILES, TILE, seed=5)
        data = siam_unet.DataProcess(source, dim_out=(TILE, TILE), aug_factor=None,
                                     data_path=str(tmp / "data"), seed=0)
        log(f"[train siam] set-up (pair frames, DataProcess) {time.perf_counter() - t0:.2f} s: "
            f"{len(data)} pair tiles of {TILE}^2")
        for join in ("max", "corr"):
            out = tmp / f"run_{join}"
            trainer = siam_unet.Trainer(data, SIAM_TRAIN_EPOCHS, batch_size=SIAM_TRAIN_BATCH,
                                        n_filter=SIAM_FILTER, lr=SIAM_TRAIN_LR, mode=join,
                                        val_split=0.0, save_dir=str(out), seed=0,
                                        device_cache=True, half_precision=True,
                                        device_augment=True)
            steps = trainer._n_train // SIAM_TRAIN_BATCH
            n = steps * SIAM_TRAIN_EPOCHS
            # each step: K4's pair form once; under corr K6 and both K6b once
            expect = {augment_apply: n}
            if join == "corr":
                expect.update({depthwise_xcorr: n, depthwise_xcorr_grad_input: n,
                               depthwise_xcorr_grad_kernel: n})
            torch.cuda.reset_peak_memory_stats()
            _, got = counted(torch, "train siam", counters,
                             f"Siam_UNet(32, {join}) {SIAM_TRAIN_EPOCHS} epochs of {steps} steps",
                             trainer.start, expect)
            peak = torch.cuda.max_memory_allocated()
            if join == "corr":
                for k in on_path:
                    k["launches"] = got[k["_counter"]]
            hist = trainer.history
            for h in hist:
                log(f"[train siam] {join}: epoch {h['epoch']}: train loss {h['train_loss']:.6f}, "
                    f"lr {h['lr']:g}, training pass {h['train_seconds']:.3f} s")
            if not hist[-1]["train_loss"] < hist[0]["train_loss"]:
                raise AssertionError(f"[train siam] {join}: the training loss did not fall")
            best = min(h["train_seconds"] for h in hist[1:])
            pps = steps * SIAM_TRAIN_BATCH / best
            flops = 3 * siam_forward_flops(SIAM_FILTER, TILE, join)
            log(f"[train siam] Siam_UNet(32, {join}): {pps:.1f} patches/s (best epoch after the "
                f"first), step {best / steps * 1e3:.2f} ms; peak device memory "
                f"{peak / 2**30:.2f} GiB; {flops / 1e9:.1f} GFLOP per pair tile forward+backward "
                f"→ {flops * pps / 1e12:.1f} TFLOP/s, {flops * pps / PEAK_BF16_FLOPS:.4f} of the "
                f"bf16 dense peak")
            profile_train_epoch(torch, trainer, SIAM_TRAIN_EPOCHS, best, tag=f"train siam {join}")

            # the trained checkpoint (the facade's model.ckpt, BIUTPU01) through
            # PredictSiam on the card: an 8-frame blob movie, mask IoU
            rng = np.random.default_rng(8)
            frames = [blob_sample(rng, (512, 512), n_blobs=40, margin=16, radius=(8, 20))
                      for _ in range(8)]
            movie = np.stack([f[0] for f in frames])
            truth = np.stack([f[1] for f in frames]) > 0
            src, res = str(tmp / "movie.tif"), str(tmp / "pred.tif")
            tiff.imwrite(src, movie)
            siam_unet.Predict(src, res, str(out / "model.ckpt"), resize_dim=(TILE, TILE),
                              show_progress=False, half_precision=True)
            pred = tiff.imread(res)
            if pred.shape != movie.shape or pred.dtype != np.uint8:
                raise AssertionError(f"PredictSiam on the trained model: {pred.shape} "
                                     f"{pred.dtype}")
            iou = float(((pred > 127) & truth).sum() / max(((pred > 127) | truth).sum(), 1))
            log(f"[train siam→predict] {join}: the trained model.ckpt through PredictSiam on "
                f"8×512² blob frames: mask IoU {iou:.4f} (foreground {truth.mean():.4f}, "
                f"predicted {(pred > 127).mean():.4f})")
    train_siam_card_vs_cpu(torch)


def train_siam_card_vs_cpu(torch) -> None:
    """``Siam_UNet(8, corr)`` on 15 pair tiles of 64² (12 training: 3 steps of
    4), float32 with TF32 off, one epoch: the card's ``metrics.csv`` rows
    against the CPU's, rtol 1e-3."""
    from bio_image_unet_tpu_torch import siam_unet
    from bio_image_unet_tpu_torch.utils.synth import blob_sample

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(3)
    items = []
    for _ in range(15):
        img, mask = blob_sample(rng, (64, 64))
        prev = np.roll(img, 2, 1)
        items.append({k: (v / 255.0).astype(np.float32)[None]
                      for k, v in (("image", img), ("mask", mask), ("prev_image", prev))})
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dev in ("cuda", "cpu"):
            t = siam_unet.Trainer(items, 1, n_filter=8, batch_size=4, lr=SIAM_TRAIN_LR,
                                  mode="corr", save_dir=str(Path(tmp) / dev), seed=0, device=dev)
            t.start()
            rows[dev] = metrics_rows(Path(tmp) / dev)[:, 1:]
    rel = np.abs(rows["cuda"] - rows["cpu"]) / np.abs(rows["cpu"])
    log(f"[train siam] card vs CPU (Siam_UNet(8, corr), 64², float32, TF32 off, 1 epoch): card "
        f"{rows['cuda'].tolist()}, CPU {rows['cpu'].tolist()}, max relative difference "
        f"{rel.max():.2e}")
    if not rel.max() <= 1e-3:
        raise AssertionError("the card's Siam training run disagrees with the CPU's")
    torch.backends.cudnn.allow_tf32 = True


# --- 20. kernels (int8) --------------------------------------------------------

INT8_SOURCE = "bio_image_unet_tpu_torch/csrc/int8_trunk.cu"
RESAMPLE_SOURCE = "bio_image_unet_tpu_torch/csrc/int8_resample.cu"
INT8_BATCH = (1 << 24) // (TILE * TILE)  # the main path's forward batch: 256 tiles


def int8_trunk_ops(nf: int, s: int) -> float:
    """int8 operations (two a multiply-add) of one s² tile through the int8
    trunk of ``Unet(n_filter=nf)``: every conv but ``encode1`` and the 1×1
    head, which run in bf16."""
    return unet_forward_flops(nf, s) - 2 * 9 * nf * s * s - 2 * nf * s * s


class Int8Yardsticks:
    """What the int8 kernel phases share: seeded int8 operands on the card,
    packed weights, the bit-equality check, output scales and the time of
    ``torch._int_mm`` (the library yardstick of K7 / K8's products)."""

    def __init__(self, torch, dev, seed: int, tag: str):
        self.torch, self.dev, self.tag = torch, dev, tag
        self.timer = Timer(torch, dev)
        self.g = torch.Generator(device=dev).manual_seed(seed)

    def i8(self, shape):
        return self.torch.randint(-127, 128, shape, generator=self.g, device=self.dev,
                                  dtype=self.torch.int8)

    def packed(self, lead, cin):
        w = self.torch.zeros(lead + (32 * -(-cin // 32),), dtype=self.torch.int8,
                             device=self.dev)
        w[..., :cin] = self.i8(lead + (cin,))
        return w

    def int_mm(self, a, b):
        """``torch._int_mm`` (cuBLASLt int8 → int32) of (M, K) ``a`` and (K, N)
        ``b``, with ``b`` row- or else column-major; None where it refuses
        both."""
        torch = self.torch
        for mat in (b.contiguous(), b.t().contiguous().t()):
            try:
                torch._int_mm(a, mat)
            except (RuntimeError, NotImplementedError) as err:
                log(f"[{self.tag}] torch._int_mm refused {tuple(a.shape)} x "
                    f"{tuple(mat.shape)} strides {mat.stride()}: {str(err)[:120]}")
                continue
            return self.timer(lambda: torch._int_mm(a, mat), 5)
        return None

    def check(self, name, ours, ref):
        """Bit-equal (bf16 compared as its bits), else raise."""
        torch = self.torch
        if ours.dtype == torch.bfloat16:
            ours, ref = ours.view(torch.int16), ref.view(torch.int16)
        if not torch.equal(ours, ref):
            bad = (ours.float() - ref.float()).abs().max().item()
            raise AssertionError(f"{name}: kernel differs from plain (max {bad})")
        return 0.0

    def rate(self, row: dict, n_ops: float) -> None:
        """Log a K7 / K8 row's int8 rate, its share of the dense peak and of
        its bound, and its time against ``torch._int_mm``'s."""
        lib = row["library_ms"]
        log(f"[{self.tag}] {row['name']}: {n_ops / row['ms'] / 1e9:.1f} TOP/s "
            f"({n_ops / row['ms'] / 1e9 / (PEAK_INT8_OPS / 1e12):.4f} of the int8 dense peak), "
            f"bound share {row['bound_ms'] / row['ms']:.4f}, time / torch._int_mm's "
            + ("none" if lib is None else f"{row['ms'] / lib:.3f}"))

    @staticmethod
    def scales(cin, taps):
        # s_out spreads the outputs over the int8 range: random operands sum
        # to about sqrt(taps·cin)·73² a channel
        s_in, sw = 0.02, 1e-3
        return s_in, sw, 3 * (taps * cin) ** 0.5 * 73 ** 2 * s_in * sw / 127


def phase_kernels_int8(torch, dev) -> list:
    import torch.nn.functional as F

    from bio_image_unet_tpu_torch.ops import int8 as k8

    y = Int8Yardsticks(torch, dev, 8, "kernels int8")
    timer, i8, packed, int_mm, check, scales = (y.timer, y.i8, y.packed, y.int_mm, y.check,
                                                y.scales)
    n, nf = INT8_BATCH, N_FILTER
    rows = []

    # K7 at the first and the widest layer of the main path's forward batch,
    # and at the last full-resolution decoder conv but one, whose input is the
    # concat buffer (2C -> C)
    for layer, hw, cin, cout in (("encode2", TILE, nf, nf),
                                 ("middle_conv2", TILE // 16, 16 * nf, 16 * nf),
                                 ("decode7", TILE, 2 * nf, nf)):
        x = i8((n, hw, hw, cin))
        w = packed((cout, 3, 3), cin)
        s_in, sw_v, s_out = scales(cin, 9)
        sw = torch.full((cout,), sw_v, device=dev)
        bias = torch.randn((cout,), generator=y.g, device=dev)
        ours = k8.qconv3x3(x, w, sw, bias, s_in, s_out)
        torch.cuda.synchronize()
        err = check(f"K7 {layer}", ours, k8.qconv3x3_plain(x, w, sw, bias, s_in, s_out))
        macs = n * hw * hw * cout * 9 * cin
        # the yardsticks: cuBLASLt int8 on an im2col (F.unfold of the int8
        # values carried in bf16, exact) and the bf16 cuDNN conv of the layer
        xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)
        cols = F.unfold(xb, 3, padding=1).transpose(1, 2).reshape(-1, 9 * cin)
        a = cols.to(torch.int8).contiguous()
        del cols
        # unfold's columns are channel-major: (c, ky, kx)
        lib = int_mm(a, w[..., :cin].permute(0, 3, 1, 2).reshape(cout, 9 * cin).t())
        del a
        xb = xb.contiguous(memory_format=torch.channels_last)
        wb = w[..., :cin].permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        conv_ms = timer(lambda: F.conv2d(xb, wb, padding=1), 5)
        log(f"[kernels int8] k7 {layer} ({n}, {hw}^2, {cin}) -> {cout}: {2 * macs / 1e9:.1f} "
            f"GOP; bf16 cuDNN conv of the layer {conv_ms:.4f} ms")
        rows.append(kernel_row(
            "kernels int8", f"k7_qconv3x3[{layer} ({n}, {hw}^2, {cin}) -> {cout}]", INT8_SOURCE,
            "bio_image_unet_tpu/predict/quant.py:417", k8.qconv3x3, err,
            timer(lambda: k8.qconv3x3(x, w, sw, bias, s_in, s_out)),
            timer(lambda: k8.qconv3x3_plain(x, w, sw, bias, s_in, s_out), 1),
            bound_ms(x.numel() + ours.numel() + w.numel() + 8 * cout, 2 * macs, PEAK_INT8_OPS),
            lib))
        y.rate(rows[-1], 2 * macs)
        del x, w, xb, wb, ours
        torch.cuda.empty_cache()

    # K8 at every decoder level, into the first half of the concat buffer
    for level in range(1, 5):
        hw = TILE >> (5 - level)
        cin, cout = 16 * nf >> (level - 1), 8 * nf >> (level - 1)
        x = i8((n, hw, hw, cin))
        w = packed((2, 2, cout), cin)
        s_in, sw_v, s_out = scales(cin, 1)
        sw = torch.full((cout,), sw_v, device=dev)
        bias = torch.randn((cout,), generator=y.g, device=dev)
        bufs = [torch.zeros((n, 2 * hw, 2 * hw, 2 * cout), dtype=torch.int8, device=dev)
                for _ in range(2)]
        k8.qconvt2x2(x, w, sw, bias, s_in, s_out, out=bufs[0])
        torch.cuda.synchronize()
        k8.qconvt2x2_plain(x, w, sw, bias, s_in, s_out, out=bufs[1])
        err = check(f"K8 up{level}", bufs[0], bufs[1])
        del bufs[1]
        macs = n * hw * hw * cin * 4 * cout
        # the transposed 2x2 stride-2 conv is one product (n·h·w, I) x (I, 4·O)
        b = w[..., :cin].permute(3, 0, 1, 2).reshape(cin, 4 * cout)
        lib = int_mm(x.reshape(-1, cin), b)
        rows.append(kernel_row(
            "kernels int8", f"k8_qconvt2x2[up{level} ({n}, {hw}^2, {cin}) -> ({2 * hw}^2, {cout})"
            f" of {2 * cout}]", INT8_SOURCE, "bio_image_unet_tpu/predict/quant.py:428",
            k8.qconvt2x2, err,
            timer(lambda: k8.qconvt2x2(x, w, sw, bias, s_in, s_out, out=bufs[0])),
            timer(lambda: k8.qconvt2x2_plain(x, w, sw, bias, s_in, s_out, out=bufs[0]), 1),
            bound_ms(x.numel() + n * 4 * hw * hw * cout + w.numel() + 8 * cout, 2 * macs,
                     PEAK_INT8_OPS),
            lib))
        y.rate(rows[-1], 2 * macs)
        del x, w, bufs
        torch.cuda.empty_cache()

    # K9 in its three forms at full resolution (n, 256², 32), and in the two
    # that AttentionUnet's gated decoder adds at its last level: the dequant of
    # the up path from channels [C, 2C) of the concat buffer (a strided read)
    # and the requant of the float32 attended skip into channels [0, C)
    shape = (n, TILE, TILE, nf)
    e1 = (torch.randn(shape, generator=y.g, device=dev) * 2).to(torch.bfloat16)
    skip = i8(shape)
    # every int8 value, -128 included (the lookup table K9 builds for int8 input)
    every = torch.randint(-128, 128, shape, generator=y.g, device=dev, dtype=torch.int8)
    every.view(-1)[:256] = torch.arange(-128, 128, device=dev).to(torch.int8)
    buf = torch.zeros(shape[:-1] + (2 * nf,), dtype=torch.int8, device=dev)
    cat = i8(shape[:-1] + (2 * nf,))
    attended = torch.randn(shape, generator=y.g, device=dev) * 2
    forms = (
        ("e1 bf16 -> int8", "quant.py:223", lambda f: f(e1, 1.0, 0.05), 3 * e1.numel()),
        ("skip int8 -> concat channels [C, 2C)", "quant.py:223",
         lambda f: f(skip, 0.031, 0.037, out=buf, offset=nf), 2 * skip.numel()),
        ("skip of all 256 int8 values, .5 ties -> concat channels [C, 2C)", "quant.py:223",
         lambda f: f(every, 0.5, 1.0, out=buf, offset=nf), 2 * skip.numel()),
        ("dequant int8 -> bf16", "quant.py:223", lambda f: f(skip, 0.031), 3 * skip.numel()),
        ("attention: dequant concat channels [C, 2C) -> bf16", "quant.py:477",
         lambda f: f(cat[..., nf:], 0.031), 3 * skip.numel()),
        ("attention: attended f32 -> concat channels [0, C)", "quant.py:483",
         lambda f: f(attended, 1.0, 0.037, out=buf, offset=0), 5 * skip.numel()),
    )
    for form, site, call, n_bytes in forms:
        ours = call(k8.requant).clone()
        torch.cuda.synchronize()
        err = check(f"K9 {form}", ours, call(k8.requant_plain))
        rows.append(kernel_row(
            "kernels int8", f"k9_requant[{form} ({n}, {TILE}^2, {nf})]", INT8_SOURCE,
            f"bio_image_unet_tpu/predict/{site}", k8.requant, err,
            timer(lambda: call(k8.requant)), timer(lambda: call(k8.requant_plain), 1),
            # read and write each element once; a multiply, a divide, a
            # rounding and a clip each
            bound_ms(n_bytes, 4 * skip.numel()), None))
        del ours
    del e1, skip, every, buf, cat, attended
    torch.cuda.empty_cache()

    # K10 at every encoder level
    for level in range(4):
        x = i8((n, TILE >> level, TILE >> level, nf << level))
        ours = k8.maxpool_i8(x)
        torch.cuda.synchronize()
        err = check(f"K10 level {level}", ours, k8.maxpool_i8_plain(x))
        rows.append(kernel_row(
            "kernels int8", f"k10_maxpool_i8[({n}, {TILE >> level}^2, {nf << level})]",
            INT8_SOURCE, "bio_image_unet_tpu/predict/quant.py:278", k8.maxpool_i8, err,
            timer(lambda: k8.maxpool_i8(x)), timer(lambda: k8.maxpool_i8_plain(x), 1),
            bound_ms(x.numel() + ours.numel(), 3 * ours.numel()),
            amax_pool_ms(torch, timer, x, ours)))
        del x, ours
    torch.cuda.empty_cache()
    return rows


# --- 21. int8 -------------------------------------------------------------------

def write_warm_checkpoint(torch, path: str, name: str, n_filter: int, seed: int = 0,
                          **hyper) -> None:
    """A ``.pt`` of registry model ``name`` with torch's default
    initialization and BatchNorm statistics from five train-mode forwards on
    seeded 64² inputs ((16, 64, 64) volumes for the 3D nets) on the CPU (the
    BN-warmed models of the JAX package's int8 tests): activations a
    calibration scales as a trained model's."""
    from bio_image_unet_tpu_torch.models import get_model

    hyper = {"model_name": name, "n_filter": n_filter, "in_channels": 1, **hyper}
    shape = (2, 1, 16, 64, 64) if "3D" in name else (2, 1, 64, 64)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = get_model(name, **hyper).train()
        with torch.no_grad():
            for _ in range(5):
                x = torch.rand(shape)
                net(x, torch.rand(shape)) if hyper.get("mode") else net(x)
    torch.save({"state_dict": net.state_dict(), "epoch": 0, "best_loss": None, **hyper}, path)


def int8_contract(tag: str, what: str, q: np.ndarray, ref: np.ndarray) -> None:
    """The JAX package's int8 contract against bf16 (``tests/test_quant.py``):
    at most 4 uint8 levels, a mean under 0.5, more than one level on under
    1% of pixels."""
    if q.shape != ref.shape or q.dtype != np.uint8:
        raise AssertionError(f"{what}: {q.shape} {q.dtype}, want {ref.shape} uint8")
    d = np.abs(q.astype(np.int16) - ref.astype(np.int16))
    log(f"[{tag}] {what}: max {int(d.max())} levels, mean {d.mean():.4f}, "
        f"{np.mean(d > 1):.6f} of pixels beyond one level")
    if not (d.max() <= 4 and d.mean() < 0.5 and np.mean(d > 1) < 0.01):
        raise AssertionError(f"{what}: outside the int8 contract")


def phase_int8(torch, dev, kernels, kint8, trained: bytes) -> float:
    from bio_image_unet_tpu_torch import siam_unet
    from bio_image_unet_tpu_torch.data import tiff
    from bio_image_unet_tpu_torch.ops import histogram as hist
    from bio_image_unet_tpu_torch.ops import int8 as k8
    from bio_image_unet_tpu_torch.ops.stitch import margin_stitch, sigmoid_stitch, tile_sum
    from bio_image_unet_tpu_torch.predict import Predict, PredictMultiOutput
    from bio_image_unet_tpu_torch.predict.normalize import (normalize_tile, normalize_tile_float,
                                                            normalize_tile_pairs)
    from bio_image_unet_tpu_torch.predict.predictor import _Engine
    from bio_image_unet_tpu_torch.predict.tiling import grid_starts
    from bio_image_unet_tpu_torch.utils.synth import blob_sample

    torch.backends.cudnn.allow_tf32 = True  # the user's default
    counters = list({id(k["_counter"]): k["_counter"] for k in kernels + kint8}.values())

    def trunk(batches, concat=False):
        """The int8 kernels' launches of ``batches`` forward batches."""
        return {k8.qconv3x3: (17 + concat) * batches, k8.qconvt2x2: 4 * batches,
                k8.requant: 6 * batches, k8.maxpool_i8: 4 * batches}

    rng = np.random.default_rng(12)
    movie = rng.integers(0, 255, (FRAMES, H, W), dtype=np.uint8)
    kw = dict(resize_dim=(TILE, TILE), show_progress=False, batch_size=8, half_precision=True)
    chunks = FRAMES // CHUNK  # one forward batch of 256 tiles a chunk
    main = f"Unet(32) int8 uint8 {FRAMES}x1024^2 (bench.py)"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ckpt = str(tmp / "unet_nf32.pt")
        write_checkpoint(torch, ckpt, "Unet", N_FILTER, out_channels=1)

        # the main path of this phase: launches exact around the call
        t0 = time.perf_counter()
        # the calibration: K1 (its uint8 launches) and K2h on its two frames
        cal = {hist.int_clip_bounds: hist.LAUNCHES[torch.uint8], normalize_tile_float: 1}
        pred, got = counted(torch, "int8", counters, main,
                            lambda: Predict(movie, None, ckpt, quantized=True, **kw),
                            plus({hist.int_clip_bounds: hist.LAUNCHES[torch.uint8] * chunks,
                                  normalize_tile: chunks, sigmoid_stitch: chunks,
                                  **trunk(chunks)}, cal))
        first = time.perf_counter() - t0
        if not pred.engine._quant_ready:
            raise AssertionError("the quantized Predict did not calibrate")
        for k in kint8:
            k["launches"] = got[k["_counter"]]
        q_res = pred.result

        # end to end, int8 and bf16 back to back (best of two after the call
        # above); each call's own peak device memory, the counter reset first
        times = {"int8": float("inf"), "bf16": float("inf")}
        call_peak = {"int8": 0, "bf16": 0}
        results, split = {}, {}
        for mode in ("bf16", "int8", "int8", "bf16", "bf16"):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            call = Predict(movie, None, ckpt, quantized=mode == "int8", **kw)
            dt = time.perf_counter() - t0
            results[mode] = call.result
            if dt < times[mode]:
                times[mode] = dt
                split[mode] = dict(call.engine.chunk_seconds,
                                   calibration=call.engine.calibration_seconds)
            call_peak[mode] = max(call_peak[mode], torch.cuda.max_memory_allocated())
        if not np.array_equal(results["int8"], q_res):
            raise AssertionError("two quantized calls on one movie disagree")
        d = np.abs(q_res.astype(np.int16) - results["bf16"].astype(np.int16))
        log(f"[int8] {main}: int8 vs bf16 on random weights (BatchNorm statistics drawn, "
            f"not warmed): max {int(d.max())} levels, mean {d.mean():.4f} (not gated: see the "
            f"trained model below)")
        e2e = {m: FRAMES * H * W / 1e6 / t for m, t in times.items()}
        ratio = e2e["int8"] / e2e["bf16"]

        # device-resident: both chunk programs on the movie on the card, in turns
        xs, ys = grid_starts(H, TILE, 0), grid_starts(W, TILE, 0)
        engines = {"int8": _Engine(ckpt, None, 8, True, dev, quantized=True),
                   "bf16": _Engine(ckpt, None, 8, True, dev)}
        fns = {m: e.fused_runner(H, W, xs, ys, (TILE, TILE), (0.0, 99.8), n_frames=FRAMES,
                                 sample=movie)[0] for m, e in engines.items()}
        movie_dev = torch.from_numpy(movie).to(dev)

        def resident(mode):
            return [fns[mode](movie_dev[i:i + CHUNK]) for i in range(0, FRAMES, CHUNK)]

        device = {"int8": float("inf"), "bf16": float("inf")}
        torch.cuda.reset_peak_memory_stats()
        for mode in ("int8", "bf16", "bf16", "int8", "int8", "bf16"):
            resident(mode)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = resident(mode)
            torch.cuda.synchronize()
            device[mode] = min(device[mode], time.perf_counter() - t0)
            if mode == "int8":
                same = int(np.abs(torch.cat(outs).cpu().numpy().astype(np.int16) - q_res).max())
                if same:
                    raise AssertionError(f"device-resident int8 run vs Predict: {same} levels")
        del outs
        resident_peak = torch.cuda.max_memory_allocated()
        resident_mps = {m: FRAMES * H * W / 1e6 / t for m, t in device.items()}
        ops = int8_trunk_ops(N_FILTER, TILE) * FRAMES * (H // TILE) * (W // TILE)
        for mode in ("int8", "bf16"):
            cal_s = split[mode].pop("calibration")
            log(f"[int8] {main}: host split of the best {mode} call ({times[mode]:.3f} s): "
                f"calibration {cal_s:.4f} s, the rest {times[mode] - cal_s:.4f} s ("
                + ", ".join(f"{k} {v:.4f} s" for k, v in split[mode].items())
                + "; host clock, download on the device clock, overlapped)")
        log(f"[int8] {main}: the first int8 call's calibration "
            f"{pred.engine.calibration_seconds:.4f} s (K1, K2h and the instrumented forward on "
            f"the card, their first launches included)")
        log(f"[int8] {main}: end to end int8 {e2e['int8']:.2f} MP/s, bf16 {e2e['bf16']:.2f} MP/s "
            f"(ratio {e2e['int8'] / e2e['bf16']:.3f}; first call {first:.3f} s with the "
            f"calibration); device-resident int8 {resident_mps['int8']:.2f} MP/s, bf16 "
            f"{resident_mps['bf16']:.2f} MP/s (ratio "
            f"{resident_mps['int8'] / resident_mps['bf16']:.3f}); int8 trunk "
            f"{ops / FRAMES / 16 / 1e9:.2f} GOP a tile → {ops / device['int8'] / 1e12:.1f} TOP/s "
            f"device-resident, {ops / device['int8'] / PEAK_INT8_OPS:.4f} of the int8 dense peak; "
            f"peak device memory of the device-resident passes (both engines, the movie on "
            f"the card) {resident_peak / 2**30:.2f} GiB; of one Predict call int8 "
            f"{call_peak['int8'] / 2**30:.2f} GiB, bf16 {call_peak['bf16'] / 2**30:.2f} GiB")
        profile_pass(torch, lambda: resident("int8"), "int8", f"{FRAMES} frames, int8")
        del movie_dev, engines, fns

        # a BN-warmed Unet(32) (the JAX package's int8 test model): int8
        # against bf16 within JAX's int8 contract
        warm = str(tmp / "unet_warm_nf32.pt")
        write_warm_checkpoint(torch, warm, "Unet", N_FILTER, seed=2)
        int8_contract("int8", "BN-warmed Unet(32) int8 vs bf16, 16x1024^2",
                      Predict(movie[:CHUNK], None, warm, quantized=True, **kw).result,
                      Predict(movie[:CHUNK], None, warm, **kw).result)

        # the trained model of [train]: the mask IoU against the blob truth
        # within 0.01 of bf16's, and a calibration broken on purpose (scales
        # 55x too small) must fail that gate
        tr = tmp / "trained.pt"
        tr.write_bytes(trained)
        brng = np.random.default_rng(7)
        frames = [blob_sample(brng, (512, 512), n_blobs=40, margin=16, radius=(8, 20))
                  for _ in range(CHUNK)]
        blobs = np.stack([f[0] for f in frames])
        truth = np.stack([f[1] for f in frames]) > 0
        tkw = dict(resize_dim=(TILE, TILE), show_progress=False, half_precision=True)
        t_q, _ = counted(torch, "int8", counters, "trained Unet(32), 16x512^2 blobs",
                         lambda: Predict(blobs, None, str(tr), quantized=True, **tkw).result,
                         plus({hist.int_clip_bounds: hist.LAUNCHES[torch.uint8], normalize_tile: 1,
                               sigmoid_stitch: 1, **trunk(1)}, cal))
        t_b = Predict(blobs, None, str(tr), **tkw).result
        margin = _Engine._QUANT_CAL_MARGIN
        _Engine._QUANT_CAL_MARGIN = 0.02
        try:
            t_broken = Predict(blobs, None, str(tr), quantized=True, **tkw).result
        finally:
            _Engine._QUANT_CAL_MARGIN = margin
        ious = {m: float(((r > 127) & truth).sum() / max(((r > 127) | truth).sum(), 1))
                for m, r in (("int8", t_q), ("bf16", t_b), ("broken", t_broken))}
        d = np.abs(t_q.astype(np.int16) - t_b.astype(np.int16))
        log(f"[int8] trained Unet(32), 16x512^2 blobs: mask IoU int8 {ious['int8']:.4f}, bf16 "
            f"{ious['bf16']:.4f}, broken calibration {ious['broken']:.4f}; int8 vs bf16 max "
            f"{int(d.max())} levels, mean {d.mean():.4f}, {np.mean(d > 1):.6f} of pixels beyond "
            f"one level (not gated: a trained model's soft probabilities move with the int8 "
            f"noise in the JAX package as here)")
        if abs(ious["int8"] - ious["bf16"]) > 0.01:
            raise AssertionError("the int8 mask IoU is more than 0.01 from bf16's")
        if not ious["broken"] < ious["bf16"] - 0.01:
            raise AssertionError("a broken calibration passed the IoU gate")

        # PredictMultiOutput on MultiOutputUnet(32): a 16-frame chunk, 512² patches
        mo = str(tmp / "mo_nf32.pt")
        write_warm_checkpoint(torch, mo, "MultiOutputUnet", N_FILTER, seed=3,
                              output_heads=MO_HEADS)
        mkw = dict(max_patch_size=(512, 512), show_progress=False, half_precision=True)
        m16 = movie[:CHUNK]
        res, _ = counted(torch, "int8", counters, "MultiOutputUnet(32) int8, 16x1024^2",
                         lambda: PredictMultiOutput(m16, mo, quantized=True, **mkw).result,
                         plus({hist.int_clip_bounds: hist.LAUNCHES[torch.uint8],
                               normalize_tile_float: 1,
                               margin_stitch: len(MO_HEADS), tile_sum: len(MO_HEADS),
                               **trunk(1)}, cal))
        ref = PredictMultiOutput(m16, mo, **mkw).result
        check_heads("MultiOutputUnet(32) int8", res, m16.shape)
        for head in MO_HEADS:
            dd = np.abs(res[head] - ref[head])
            rng_h = float(ref[head].max() - ref[head].min()) + 1e-9
            log(f"[int8] MultiOutputUnet(32) {head}: int8 vs bf16 max {dd.max() / rng_h:.5f}, "
                f"mean {dd.mean() / rng_h:.6f} of the head's range")
            if not (dd.max() / rng_h < 0.06 and dd.mean() / rng_h < 0.01):
                raise AssertionError(f"MultiOutputUnet {head}: int8 too far from bf16")

        # PredictSiam in each int8 join, 8 frames of 1024² (one chunk)
        src = str(tmp / "siam.tif")
        tiff.imwrite(src, movie[:8])
        skw = dict(resize_dim=(TILE, TILE), show_progress=False, half_precision=True)
        for seed, join in enumerate(("max", "control", "concat")):
            sp = str(tmp / f"siam_{join}.pt")
            write_warm_checkpoint(torch, sp, "Siam_UNet", N_FILTER, seed=40 + seed, mode=join)
            q_out, b_out = str(tmp / "sq.tif"), str(tmp / "sb.tif")
            t0 = time.perf_counter()
            # the calibration: K1 over the sampled pairs' four planes, K2h on
            # each plane set
            sq, _ = counted(torch, "int8", counters, f"Siam_UNet(32, {join}) int8, 8x1024^2",
                            lambda: siam_unet.Predict(src, q_out, sp, quantized=True, **skw),
                            {hist.int_clip_bounds: 2 * hist.LAUNCHES[torch.uint8],
                             normalize_tile_float: 2,
                             normalize_tile_pairs: 1, sigmoid_stitch: 1,
                             **trunk(1, join == "concat")})
            dt = time.perf_counter() - t0
            siam_unet.Predict(src, b_out, sp, **skw)
            log(f"[int8] Siam_UNet(32, {join}): {8 * H * W / 1e6 / dt:.2f} MP/s end to end "
                f"(one call, calibration included: {sq.engine.calibration_seconds:.4f} s)")
            int8_contract("int8", f"Siam_UNet(32, {join}) int8 vs bf16",
                          tiff.imread(q_out), tiff.imread(b_out))

        # card vs CPU: a BN-warmed Unet(8), the CPU through the plain versions
        small = str(tmp / "unet_nf8.pt")
        write_warm_checkpoint(torch, small, "Unet", 8, seed=9)
        m = rng.integers(0, 255, (3, 128, 128), dtype=np.uint8)
        ckw = dict(resize_dim=(64, 64), show_progress=False, quantized=True)
        int8_contract("int8", "Unet(8) int8: card vs CPU",
                      Predict(m, None, small, **ckw).result,
                      Predict(m, None, small, device="cpu", **ckw).result)
    return ratio


# --- 22. kernels (int8 3d) -------------------------------------------------------

# Predict3D's forward batch at config 5: 2^23 tile voxels of (32, 128, 128)
INT8_3D_BATCH = (1 << 23) // int(np.prod(VOL_TILE))


def int8_3d_trunk_ops(nf: int, nearest_decoder: bool = False, out_channels: int = 1) -> float:
    """int8 operations (two a multiply-add) per tile voxel of the 3D int8
    trunk: every conv but ``encode1`` and the 1×1×1 heads, which run in bf16."""
    h = nf // 2
    return (unet3d_forward_flops(nf, nearest_decoder, out_channels) - 2 * 27 * h
            - 2 * h * out_channels)


def phase_kernels_int8_3d(torch, dev) -> list:
    """K7v at ``encode2``, ``decode1`` and ``middle_conv2``, K8v at up1–up3,
    K10v at its three levels and K9's three 3D uses, at config 5's forward
    batch of 16 tiles of (32, 128, 128), ``UNet3D(32)``: each bit-equal to
    its plain version on the whole batch."""
    import torch.nn.functional as F

    from bio_image_unet_tpu_torch.ops import int8 as k8

    y = Int8Yardsticks(torch, dev, 9, "kernels int8 3d")
    timer = y.timer
    n, nf = INT8_3D_BATCH, VOL_FILTER
    td, th, tw = VOL_TILE
    cl3d = torch.channels_last_3d
    rows = []

    def row(*args):
        rows.append(kernel_row("kernels int8 3d", *args))

    def level(k):
        return (td >> k, th >> k, tw >> k)

    def im2col(x):
        """(n, d, h, w, c) int8 → (n·d·h·w, 27·c): the SAME 3×3×3 windows,
        taps (z, y, x) major and channels minor, as the packed weights."""
        d, h, w = x.shape[1:4]
        xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
        return torch.cat([xp[:, a:a + d, b:b + h, c:c + w] for a in range(3) for b in range(3)
                          for c in range(3)], dim=-1).reshape(-1, 27 * x.shape[-1])

    # K7v at the first, the widest and the deepest layers (the scales folded
    # into the weights: sw is s_in·sw)
    for layer, k, cin, cout in (("encode2", 0, nf // 2, nf), ("decode1", 2, 12 * nf, 4 * nf),
                                ("middle_conv2", 3, 4 * nf, 8 * nf), ("decode6", 0, nf, nf // 2)):
        x = y.i8((n,) + level(k) + (cin,))
        w = y.packed((cout, 3, 3, 3), cin)
        s_in, sw_v, s_out = y.scales(cin, 27)
        sw = torch.full((cout,), s_in * sw_v, device=dev)
        bias = torch.randn((cout,), generator=y.g, device=dev)
        ours = k8.qconv3x3x3(x, w, sw, bias, s_out)
        torch.cuda.synchronize()
        err = y.check(f"K7v {layer}", ours, k8.qconv3x3x3_plain(x, w, sw, bias, s_out))
        macs = ours.numel() * 27 * cin
        # the yardsticks: cuBLASLt int8 on an im2col and the bf16 cuDNN conv
        a = im2col(x)
        lib = y.int_mm(a, w[..., :cin].reshape(cout, 27 * cin).t())
        del a
        xb = x.permute(0, 4, 1, 2, 3).to(torch.bfloat16).contiguous(memory_format=cl3d)
        wb = w[..., :cin].permute(0, 4, 1, 2, 3).to(torch.bfloat16).contiguous(memory_format=cl3d)
        conv_ms = timer(lambda: F.conv3d(xb, wb, padding=1), 5)
        log(f"[kernels int8 3d] k7v {layer} ({n}, {'x'.join(map(str, level(k)))}, {cin}) -> "
            f"{cout}: {2 * macs / 1e9:.1f} GOP; bf16 cuDNN conv3d of the layer {conv_ms:.4f} ms")
        row(f"k7v_qconv3x3x3[{layer} ({n}, {'x'.join(map(str, level(k)))}, {cin}) -> {cout}]",
            INT8_SOURCE, "bio_image_unet_tpu/predict/quant3d.py:269", k8.qconv3x3x3, err,
            timer(lambda: k8.qconv3x3x3(x, w, sw, bias, s_out)),
            timer(lambda: k8.qconv3x3x3_plain(x, w, sw, bias, s_out), 1),
            bound_ms(x.numel() + ours.numel() + w.numel() + 8 * cout, 2 * macs, PEAK_INT8_OPS),
            lib)
        y.rate(rows[-1], 2 * macs)
        del x, w, xb, wb, ours
        torch.cuda.empty_cache()

    # K8v at every decoder level, into the first channels of the concat buffer
    for i in (1, 2, 3):
        cin = cout = (16 * nf) >> i
        lv = level(4 - i)
        x = y.i8((n,) + lv + (cin,))
        w = y.packed((2, 2, 2, cout), cin)
        s_in, sw_v, s_out = y.scales(cin, 1)
        sw = torch.full((cout,), s_in * sw_v, device=dev)
        bias = torch.randn((cout,), generator=y.g, device=dev)
        out_shape = (n,) + tuple(2 * e for e in lv)
        bufs = [torch.zeros(out_shape + (cout + cout // 2,), dtype=torch.int8, device=dev)
                for _ in range(2)]
        k8.qconvt2x2x2(x, w, sw, bias, s_out, out=bufs[0])
        torch.cuda.synchronize()
        k8.qconvt2x2x2_plain(x, w, sw, bias, s_out, out=bufs[1])
        err = y.check(f"K8v up{i}", bufs[0], bufs[1])
        del bufs[1]
        macs = x[..., 0].numel() * cin * 8 * cout
        lib = y.int_mm(x.reshape(-1, cin), w[..., :cin].permute(4, 0, 1, 2, 3).reshape(cin, -1))
        xb = x.permute(0, 4, 1, 2, 3).to(torch.bfloat16).contiguous(memory_format=cl3d)
        wb = w[..., :cin].permute(4, 3, 0, 1, 2).to(torch.bfloat16).contiguous()
        convt_ms = timer(lambda: F.conv_transpose3d(xb, wb, stride=2), 5)
        log(f"[kernels int8 3d] k8v up{i}: bf16 cuDNN conv_transpose3d {convt_ms:.4f} ms")
        out_name = "x".join(map(str, out_shape[1:]))
        row(f"k8v_qconvt2x2x2[up{i} ({n}, {'x'.join(map(str, lv))}, {cin}) -> ({out_name}, "
            f"{cout}) of {cout + cout // 2}]", INT8_SOURCE,
            "bio_image_unet_tpu/predict/quant3d.py:277", k8.qconvt2x2x2, err,
            timer(lambda: k8.qconvt2x2x2(x, w, sw, bias, s_out, out=bufs[0])),
            timer(lambda: k8.qconvt2x2x2_plain(x, w, sw, bias, s_out, out=bufs[0]), 1),
            bound_ms(x.numel() + 8 * x[..., 0].numel() * cout + w.numel() + 8 * cout, 2 * macs,
                     PEAK_INT8_OPS), lib)
        y.rate(rows[-1], 2 * macs)
        del x, w, xb, wb, bufs
        torch.cuda.empty_cache()

    # K10v at every encoder level
    for k, c in ((0, nf), (1, 2 * nf), (2, 4 * nf)):
        x = y.i8((n,) + level(k) + (c,))
        ours = k8.maxpool_i8_3d(x)
        torch.cuda.synchronize()
        err = y.check(f"K10v level {k}", ours, k8.maxpool_i8_3d_plain(x))
        row(f"k10v_maxpool_i8_3d[({n}, {'x'.join(map(str, level(k)))}, {c})]", INT8_SOURCE,
            "bio_image_unet_tpu/predict/quant3d.py:75", k8.maxpool_i8_3d, err,
            timer(lambda: k8.maxpool_i8_3d(x)), timer(lambda: k8.maxpool_i8_3d_plain(x), 1),
            bound_ms(x.numel() + ours.numel(), 7 * ours.numel()),
            amax_pool_ms(torch, timer, x, ours))
        del x, ours
    torch.cuda.empty_cache()

    # K9's three uses in the 3D graph, at full resolution
    full = (n,) + VOL_TILE
    e1 = (torch.randn(full + (nf // 2,), generator=y.g, device=dev) * 2).to(torch.bfloat16)
    skip = y.i8(full + (nf,))
    buf = torch.zeros(full + (3 * nf,), dtype=torch.int8, device=dev)
    d6 = y.i8(full + (nf // 2,))
    forms = (
        (f"e1 bf16 -> int8 ({n}, 32x128x128, {nf // 2})", lambda f: f(e1, 1.0, 0.05),
         3 * e1.numel(), e1.numel()),
        (f"raw skip -> concat channels [{2 * nf}, {3 * nf}) ({n}, 32x128x128, {nf})",
         lambda f: f(skip, 1.0, 1.0, out=buf, offset=2 * nf), 2 * skip.numel(), skip.numel()),
        (f"d6 dequant int8 -> bf16 ({n}, 32x128x128, {nf // 2})", lambda f: f(d6, 0.031),
         3 * d6.numel(), d6.numel()),
    )
    for form, call, n_bytes, n_el in forms:
        ours = call(k8.requant).clone()
        torch.cuda.synchronize()
        err = y.check(f"K9 3d {form}", ours, call(k8.requant_plain))
        row(f"k9_requant[3d {form}]", INT8_SOURCE, "bio_image_unet_tpu/predict/quant3d.py:291",
            k8.requant, err, timer(lambda: call(k8.requant)),
            timer(lambda: call(k8.requant_plain), 1), bound_ms(n_bytes, 4 * n_el), None)
        del ours
    del e1, skip, buf, d6
    torch.cuda.empty_cache()

    # K11v at the trilinear decoder's three levels, up1 (16, 4x16^2, 256) -> the
    # first 256 of 384 channels, up2 128 -> 128 of 192, up3 (16, 16x64^2, 64)
    # -> 64 of 96; the extremes -128 and 127 on the first and last voxels
    for name, k, c in (("up1", 3, 8 * nf), ("up2", 2, 4 * nf), ("up3", 1, 2 * nf)):
        x = y.i8((n,) + level(k) + (c,))
        x[:, 0, 0, 0], x[:, -1, -1, -1] = -128, 127
        out_shape = (n,) + level(k - 1)
        bufs = [torch.zeros(out_shape + (3 * c // 2,), dtype=torch.int8, device=dev)
                for _ in range(2)]
        k8.upsample2x_i8_3d(x, out=bufs[0])
        torch.cuda.synchronize()
        k8.upsample2x_i8_3d_plain(x, out=bufs[1])
        err = y.check(f"K11v {name}", bufs[0], bufs[1])
        del bufs[1]
        n_out = x.numel() * 8

        def library():
            # F.interpolate's trilinear on the values in float32, round, clip,
            # int8 and the copy into the buffer's channel range
            u = F.interpolate(x.permute(0, 4, 1, 2, 3).float(), scale_factor=2,
                              mode="trilinear", align_corners=False)
            bufs[0][..., :c] = torch.clamp(torch.round(u), -127, 127).to(
                torch.int8).permute(0, 2, 3, 4, 1)

        row(f"k11v_upsample2x_i8_3d[{name} ({n}, {'x'.join(map(str, level(k)))}, {c}) -> "
            f"({'x'.join(map(str, out_shape[1:]))}, {c}) of {3 * c // 2}]", RESAMPLE_SOURCE,
            "bio_image_unet_tpu/predict/quant3d.py:305", k8.upsample2x_i8_3d, err,
            timer(lambda: k8.upsample2x_i8_3d(x, out=bufs[0])),
            timer(lambda: k8.upsample2x_i8_3d_plain(x, out=bufs[0]), 1),
            # each input byte read once, each output byte written once; some 20
            # operations an output (7 blends, the rounding, the clip)
            bound_ms(x.numel() + n_out, 20 * n_out), timer(library, 5))
        del x, bufs
        torch.cuda.empty_cache()
    return rows


# --- 23. int8 3d ------------------------------------------------------------------

def blob_volume(rng, shape, n_blobs: int = 12) -> np.ndarray:
    """A uint8 volume of bright Gaussian blobs on a noisy background (the
    test volume of ``tests/test_quant_families.py``, tiled): each blob an
    outer product of three 1-D profiles."""
    d, h, w = shape
    vol = np.zeros(shape, np.float32)
    for _ in range(n_blobs):
        cz, cy, cx = rng.uniform(0, d), rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(6, 24)
        pz = np.exp(-((np.arange(d) - cz) * 2) ** 2 / (2 * r * r)).astype(np.float32)
        py = np.exp(-(np.arange(h) - cy) ** 2 / (2 * r * r)).astype(np.float32)
        px = np.exp(-(np.arange(w) - cx) ** 2 / (2 * r * r)).astype(np.float32)
        vol = np.maximum(vol, pz[:, None, None] * py[None, :, None] * px[None, None, :])
    vol = 30 + 180 * vol + 10 * rng.random(shape, dtype=np.float32)
    return np.clip(vol, 0, 255).astype(np.uint8)


def int8_3d_bounds(tag: str, what: str, q: np.ndarray, ref: np.ndarray) -> None:
    """The JAX package's 3D int8 bounds against bf16
    (``tests/test_quant_families.py:193-198``): at most 35 uint8 levels, a
    mean under 3, more than 10 levels on under 5% of voxels."""
    if q.shape != ref.shape or q.dtype != np.uint8:
        raise AssertionError(f"{what}: {q.shape} {q.dtype}, want {ref.shape} uint8")
    d = np.abs(q.astype(np.int16) - ref.astype(np.int16))
    log(f"[{tag}] {what}: max {int(d.max())} levels, mean {d.mean():.4f}, "
        f"{np.mean(d > 10):.6f} of voxels beyond 10 levels, {np.mean(d > 1):.6f} beyond one")
    if not (d.max() <= 35 and d.mean() < 3 and np.mean(d > 10) < 0.05):
        raise AssertionError(f"{what}: outside the JAX package's 3D int8 bounds")


def resident_volume_passes(torch, dev, ckpt: str, vol: np.ndarray, vol_dev, q_res):
    """The int8 and bf16 volume programs of ``ckpt`` (config 5's tiles and
    batch) on ``vol_dev``, in turns after a warm-up each: the programs and
    each one's best pass in seconds; every int8 pass must equal ``q_res``,
    the quantized ``Predict3D`` call's result."""
    from bio_image_unet_tpu_torch.predict.predictor import _Engine

    grid = vol_grid(VOL_TILE)
    engines = {"int8": _Engine(ckpt, "UNet3D", VOL_BATCH, True, dev, quantized=True),
               "bf16": _Engine(ckpt, "UNet3D", VOL_BATCH, True, dev)}
    fns = {m: e.volume_runner(*vol.shape, *grid, VOL_TILE, VOL_CLIP, sample=vol)[0]
           for m, e in engines.items()}
    device = {"int8": float("inf"), "bf16": float("inf")}
    for mode in ("int8", "bf16", "bf16", "int8", "int8", "bf16"):
        fns[mode](vol_dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fns[mode](vol_dev)
        torch.cuda.synchronize()
        device[mode] = min(device[mode], time.perf_counter() - t0)
        if mode == "int8":
            same = int(np.abs(out.cpu().numpy().astype(np.int16) - q_res).max())
            if same:
                raise AssertionError(f"device-resident int8 run vs Predict3D: {same} levels")
    return fns, device


def phase_int8_3d(torch, dev, kernels, kint8_3d, trained3d: bytes) -> float:
    import os

    from bio_image_unet_tpu_torch.ops import histogram as hist
    from bio_image_unet_tpu_torch.ops import int8 as k8
    from bio_image_unet_tpu_torch.ops.stitch import blend_stitch_3d, sigmoid_stitch_3d
    from bio_image_unet_tpu_torch.predict import Predict3D, PredictMultiOutput3D
    from bio_image_unet_tpu_torch.predict.normalize import normalize_tile_3d
    from bio_image_unet_tpu_torch.predict.predictor import _Engine

    torch.backends.cudnn.allow_tf32 = True  # the user's default
    counters = list({id(k["_counter"]): k["_counter"] for k in kernels + kint8_3d}.values())
    shape = (VOL_D, VOL_H, VOL_W)
    mvox = VOL_D * VOL_H * VOL_W / 1e6
    grid = vol_grid(VOL_TILE)
    n_tiles = int(np.prod([len(g) for g in grid]))
    batches = -(-n_tiles // INT8_3D_BATCH)

    def trunk(b, tconv=True, nearest=False):
        """The int8 kernels' launches of ``b`` forward batches: K9 quantizes
        e1, copies the three skips and dequantizes d6; the trilinear decoder
        (no transposed conv, not nearest) upsamples by K11v."""
        return {k8.qconv3x3x3: (16 if nearest else 13) * b, k8.qconvt2x2x2: 3 * b * tconv,
                k8.maxpool_i8_3d: 3 * b * (not nearest), k8.requant: 5 * b,
                k8.upsample2x_i8_3d: 3 * b * (not tconv and not nearest)}

    volume_expect = {hist.int_clip_bounds: hist.LAUNCHES[torch.uint8], normalize_tile_3d: 1,
                     sigmoid_stitch_3d: 1}
    # a quantized call's calibration: K1 (its uint8 launches) and K2v in float
    # mode on its sampled volumes
    cal = {hist.int_clip_bounds: hist.LAUNCHES[torch.uint8], normalize_tile_3d: 1}
    rng = np.random.default_rng(14)
    t0 = time.perf_counter()
    vol = blob_volume(rng, shape)
    log(f"[int8 3d] blob volume {shape} uint8 made in {time.perf_counter() - t0:.2f} s "
        f"(mean {vol.mean():.1f})")
    kw = dict(resize_dim=VOL_TILE, show_progress=False, batch_size=VOL_BATCH,
              half_precision=True)
    main = f"UNet3D(32) BN-warmed int8 uint8 {VOL_D}x{VOL_H}^2 (config 5)"
    calibration = []
    calibrate = _Engine._calibrate_int8_3d

    def timed_calibration(self, *args, **kwargs):
        t = time.perf_counter()
        calibrate(self, *args, **kwargs)
        torch.cuda.synchronize()
        calibration.append(time.perf_counter() - t)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ckpt = str(tmp / "unet3d_warm_nf32.pt")
        write_warm_checkpoint(torch, ckpt, "UNet3D", VOL_FILTER, seed=21)

        # the main path of this phase: launches exact around the call
        _Engine._calibrate_int8_3d = timed_calibration
        try:
            t0 = time.perf_counter()
            pred, got = counted(torch, "int8 3d", counters, main,
                                lambda: Predict3D(vol, None, ckpt, quantized=True, **kw),
                                plus({**volume_expect, **trunk(batches)}, cal))
            first = time.perf_counter() - t0
        finally:
            _Engine._calibrate_int8_3d = calibrate
        if not pred.engine._quant_ready or len(calibration) != 1:
            raise AssertionError("the quantized Predict3D did not calibrate once")
        for k in kint8_3d:
            k["launches"] = got[k["_counter"]]
        q_res = pred.result

        # end to end, int8 and bf16 back to back (best of two after the call above)
        times = {"int8": float("inf"), "bf16": float("inf")}
        results, best_cal = {}, 0.0
        for mode in ("bf16", "int8", "int8", "bf16", "bf16"):
            t0 = time.perf_counter()
            call = Predict3D(vol, None, ckpt, quantized=mode == "int8", **kw)
            dt = time.perf_counter() - t0
            results[mode] = call.result
            if dt < times[mode]:
                times[mode] = dt
                best_cal = call.engine.calibration_seconds if mode == "int8" else best_cal
        if not np.array_equal(results["int8"], q_res):
            raise AssertionError("two quantized Predict3D calls on one volume disagree")
        int8_3d_bounds("int8 3d", f"{main}: int8 vs bf16", q_res, results["bf16"])
        e2e = {m: mvox / t for m, t in times.items()}
        ratio = e2e["int8"] / e2e["bf16"]

        # device-resident: both volume programs on the volume on the card, in turns
        vol_dev = torch.from_numpy(vol).to(dev)
        torch.cuda.reset_peak_memory_stats()
        fns, device = resident_volume_passes(torch, dev, ckpt, vol, vol_dev, q_res)
        peak = torch.cuda.max_memory_allocated()
        resident = {m: mvox / t for m, t in device.items()}
        ops = int8_3d_trunk_ops(VOL_FILTER) * n_tiles * np.prod(VOL_TILE)
        log(f"[int8 3d] {main}: end to end int8 {e2e['int8']:.2f} Mvox/s, bf16 "
            f"{e2e['bf16']:.2f} Mvox/s (ratio {e2e['int8'] / e2e['bf16']:.3f}; first call "
            f"{first:.3f} s, its calibration {calibration[0]:.3f} s; the best int8 call "
            f"{times['int8']:.3f} s, its calibration {best_cal:.4f} s); device-resident int8 "
            f"{resident['int8']:.2f} Mvox/s ({device['int8'] * 1e3:.2f} ms), bf16 "
            f"{resident['bf16']:.2f} Mvox/s ({device['bf16'] * 1e3:.2f} ms) (ratio "
            f"{resident['int8'] / resident['bf16']:.3f}); int8 trunk "
            f"{int8_3d_trunk_ops(VOL_FILTER) / 1e6:.4f} MOP a tile voxel → "
            f"{ops / device['int8'] / 1e12:.1f} TOP/s device-resident, "
            f"{ops / device['int8'] / PEAK_INT8_OPS:.4f} of the int8 dense peak; peak device "
            f"memory of the device-resident passes {peak / 2**30:.2f} GiB")
        profile_pass(torch, lambda: [fns["int8"](vol_dev) for _ in range(2)], "int8 3d",
                     "two passes over one volume, int8")
        del fns

        # the experimental legs, BIU_INT8_EXPERIMENTAL=1
        env = os.environ.get("BIU_INT8_EXPERIMENTAL")
        os.environ["BIU_INT8_EXPERIMENTAL"] = "1"
        try:
            tri = str(tmp / "unet3d_trilinear_warm_nf32.pt")
            write_warm_checkpoint(torch, tri, "UNet3D", VOL_FILTER, seed=22,
                                  use_interpolation=True)
            t0 = time.perf_counter()
            q, got_tri = counted(torch, "int8 3d", counters, "trilinear UNet3D(32) int8",
                                 lambda: Predict3D(vol, None, tri, quantized=True, **kw).result,
                                 plus({**volume_expect, **trunk(batches, tconv=False)}, cal))
            dt = time.perf_counter() - t0
            # K11v's path is this decoder's: its JSON entry counts this call
            for k in kint8_3d:
                if k["_counter"] is k8.upsample2x_i8_3d:
                    k["launches"] = got_tri[k8.upsample2x_i8_3d]
            log(f"[int8 3d] trilinear UNet3D(32): {mvox / dt:.2f} Mvox/s end to end (one call, "
                "calibration included)")
            int8_3d_bounds("int8 3d", "trilinear UNet3D(32) int8 vs bf16", q,
                           Predict3D(vol, None, tri, **kw).result)
            # its device-resident passes, int8 and its bf16 twin, and where the
            # int8 pass spends its time (K11v's share: the k11v stage)
            fns, device = resident_volume_passes(torch, dev, tri, vol, vol_dev, q)
            log(f"[int8 3d] trilinear UNet3D(32): device-resident int8 "
                f"{mvox / device['int8']:.2f} Mvox/s ({device['int8'] * 1e3:.2f} ms), bf16 "
                f"{mvox / device['bf16']:.2f} Mvox/s ({device['bf16'] * 1e3:.2f} ms) (ratio "
                f"{device['bf16'] / device['int8']:.3f})")
            profile_pass(torch, lambda: [fns["int8"](vol_dev) for _ in range(2)], "int8 3d",
                         "trilinear UNet3D(32), two passes over one volume, int8")
            del fns

            mo = str(tmp / "mo3d_warm_nf32.pt")
            write_warm_checkpoint(torch, mo, "MultiOutputUnet3D", VOL_FILTER, seed=23,
                                  output_heads=MO3_HEADS)
            vols = np.stack([vol, blob_volume(rng, shape)])
            starts, _ = heads3d_grid()
            n_heads_tiles = MO3_VOLS * int(np.prod([len(g) for g in starts]))
            bs = max(1, min(n_heads_tiles, (1 << 23) // int(np.prod(MO3_PATCH))))
            mkw = dict(show_progress=False, half_precision=True)
            t0 = time.perf_counter()
            res, _ = counted(torch, "int8 3d", counters,
                             f"MultiOutputUnet3D(32) int8, {MO3_VOLS} volumes ([3d heads])",
                             lambda: PredictMultiOutput3D(vols, mo, quantized=True, **mkw).result,
                             plus({hist.int_clip_bounds: hist.LAUNCHES[torch.uint8],
                                   normalize_tile_3d: 1, blend_stitch_3d: len(MO3_HEADS),
                                   **trunk(-(-n_heads_tiles // bs), tconv=False, nearest=True)},
                                  cal))
            dt = time.perf_counter() - t0
            ref = PredictMultiOutput3D(vols, mo, **mkw).result
            check_heads3d("MultiOutputUnet3D(32) int8", res, (MO3_VOLS,) + shape)
            log(f"[int8 3d] MultiOutputUnet3D(32): {MO3_VOLS * mvox / dt:.2f} Mvox/s end to end "
                f"(one call, calibration included; forward batch {bs})")
            for head in MO3_HEADS:
                dd = np.abs(res[head] - ref[head])
                rg = max(float(ref[head].max() - ref[head].min()), 0.5)
                log(f"[int8 3d] MultiOutputUnet3D(32) {head}: int8 vs bf16 max "
                    f"{dd.max() / rg:.5f}, mean {dd.mean() / rg:.6f} of the head's range")
                # tests/test_quant_families.py:231-247
                if not (dd.max() / rg < 0.15 and dd.mean() / rg < 0.03):
                    raise AssertionError(f"MultiOutputUnet3D {head}: int8 too far from bf16")
            del vols, res, ref
        finally:
            if env is None:
                os.environ.pop("BIU_INT8_EXPERIMENTAL", None)
            else:
                os.environ["BIU_INT8_EXPERIMENTAL"] = env

        del vol_dev
        torch.cuda.empty_cache()

        # the trained .pt of [train 3d]: the mask IoU against the truth of
        # its task (the volume above half its range) within 0.01 of bf16's
        tr = tmp / "trained3d.pt"
        tr.write_bytes(trained3d)
        tvol = (rng.random((32, 128, 128)) * 255).astype(np.uint8)
        truth = tvol > 127
        tkw = dict(resize_dim=T3_SHAPE, show_progress=False, half_precision=True)
        n_t = int(np.prod([32 // T3_SHAPE[0], 128 // T3_SHAPE[1], 128 // T3_SHAPE[2]]))
        t_q, _ = counted(torch, "int8 3d", counters, "trained UNet3D(32), 32x128^2",
                         lambda: Predict3D(tvol, None, str(tr), quantized=True, **tkw).result,
                         plus({**volume_expect, **trunk(-(-n_t // max(
                             VOL_BATCH, min(n_t, (1 << 23) // int(np.prod(T3_SHAPE))))))}, cal))
        t_b = Predict3D(tvol, None, str(tr), **tkw).result
        ious = {m: float(((r > 127) & truth).sum() / max(((r > 127) | truth).sum(), 1))
                for m, r in (("int8", t_q), ("bf16", t_b))}
        d = np.abs(t_q.astype(np.int16) - t_b.astype(np.int16))
        log(f"[int8 3d] trained UNet3D(32), 32x128^2: mask IoU int8 {ious['int8']:.4f}, bf16 "
            f"{ious['bf16']:.4f}; int8 vs bf16 max {int(d.max())} levels, mean {d.mean():.4f}")
        if abs(ious["int8"] - ious["bf16"]) > 0.01:
            raise AssertionError("the 3D int8 mask IoU is more than 0.01 from bf16's")

        # card vs CPU: a BN-warmed UNet3D(8), the CPU through the plain versions
        small = str(tmp / "unet3d_nf8.pt")
        write_warm_checkpoint(torch, small, "UNet3D", 8, seed=24)
        sv = blob_volume(rng, (24, 96, 80), n_blobs=4)
        ckw = dict(resize_dim=(16, 64, 64), show_progress=False, quantized=True)
        card, cpu = Predict3D(sv, None, small, **ckw), Predict3D(sv, None, small, device="cpu",
                                                                  **ckw)
        if not (card.engine._quant_ready and cpu.engine._quant_ready):
            raise AssertionError("card vs CPU: a quantized Predict3D did not calibrate")
        int8_contract("int8 3d", "UNet3D(8) int8: card vs CPU", card.result, cpu.result)
    return ratio


# --- 24. kernels (nested int8) -------------------------------------------------------

def phase_kernels_nested_int8(torch, dev) -> list:
    """The UNet++ int8 grid's kernels on its row buffers, at config 4's
    forward batch of 16 tiles of 512² (4 levels, n_filter 32: row 0 holds 6
    slots of 32 channels, row 1 5 of 64): K7 reading a cell's input in place
    (``x_{0,1}``'s stage 1, channels [0, 96) of row 0) and writing a slot
    (its stage 2 into channels [32, 64)), K10 pooling slot 0 of row 0, and
    K11, the int8 ×2 bilinear (``align_corners=True``), from slot 0 of row 1
    into slots 1–2 of row 0, and at two odd shapes (1- and 8-byte vectors,
    strided input); each bit-equal to its plain version, timed beside its
    bound and, for K7, ``torch._int_mm`` on an im2col, for K11, the torch
    calls it replaces."""
    import torch.nn.functional as F

    from bio_image_unet_tpu_torch.ops import int8 as k8

    y = Int8Yardsticks(torch, dev, 10, "kernels nested int8")
    timer = y.timer
    n = (1 << 22) // (HEADS_PATCH * HEADS_PATCH)  # config 4's forward batch: 16 tiles
    nf, P = HEADS_FILTER, HEADS_PATCH
    rows = []

    # K7 on row 0 (16, 512², 6·32): stage 1 of x_{0,1} reads channels [0, 96)
    # in place, stage 2 writes slot 1
    row0 = y.i8((n, P, P, 6 * nf))
    for layer, x, cout, off in (
            (f"g0_1s1 from row 0 channels [0, {3 * nf})", row0[..., :3 * nf], nf, None),
            ("g0_1s2 into row 0 slot 1", y.i8((n, P, P, nf)), nf, nf)):
        cin = x.shape[-1]
        w = y.packed((cout, 3, 3), cin)
        sw = torch.full((cout,), 1e-3, device=dev)
        bias = torch.randn((cout,), generator=y.g, device=dev)
        s_out = y.scales(cin, 9)[2] / 0.02  # s_in = 1: the scales are in the weights
        if off is None:
            outs = [None, None]
        else:
            outs = [torch.zeros((n, P, P, 6 * nf), dtype=torch.int8, device=dev)
                    for _ in range(2)]
        got = k8.qconv3x3(x, w, sw, bias, 1.0, s_out, out=outs[0], offset=off or 0)
        torch.cuda.synchronize()
        want = k8.qconv3x3_plain(x, w, sw, bias, 1.0, s_out, out=outs[1], offset=off or 0)
        err = y.check(f"K7 {layer}", got, want)
        del want
        macs = n * P * P * cout * 9 * cin
        # the library yardstick: cuBLASLt int8 on an im2col of the same
        # channels (F.unfold of the int8 values carried in bf16, exact)
        cols = F.unfold(x.permute(0, 3, 1, 2).to(torch.bfloat16), 3, padding=1)
        a = cols.transpose(1, 2).reshape(-1, 9 * cin).to(torch.int8)
        del cols
        lib = y.int_mm(a, w[..., :cin].permute(0, 3, 1, 2).reshape(cout, 9 * cin).t())
        del a
        torch.cuda.empty_cache()
        rows.append(kernel_row(
            "kernels nested int8", f"k7_qconv3x3[{layer} ({n}, {P}^2, {cin}) -> {cout}]",
            INT8_SOURCE, "bio_image_unet_tpu/predict/quant_nested.py:222", k8.qconv3x3, err,
            timer(lambda: k8.qconv3x3(x, w, sw, bias, 1.0, s_out, out=outs[0],
                                      offset=off or 0)),
            timer(lambda: k8.qconv3x3_plain(x, w, sw, bias, 1.0, s_out, out=outs[1],
                                            offset=off or 0), 1),
            bound_ms(x.numel() + n * P * P * cout + w.numel() + 8 * cout, 2 * macs,
                     PEAK_INT8_OPS), lib))
        y.rate(rows[-1], 2 * macs)
        del x, w, outs, got
    # K10 on slot 0 of row 0
    x = row0[..., :nf]
    got = k8.maxpool_i8(x)
    torch.cuda.synchronize()
    err = y.check("K10 row0 slot 0", got, k8.maxpool_i8_plain(x))
    rows.append(kernel_row(
        "kernels nested int8", f"k10_maxpool_i8[row0 slot 0 ({n}, {P}^2, {nf} of {6 * nf})]",
        INT8_SOURCE, "bio_image_unet_tpu/predict/quant_nested.py:242", k8.maxpool_i8, err,
        timer(lambda: k8.maxpool_i8(x)), timer(lambda: k8.maxpool_i8_plain(x), 1),
        bound_ms(x.numel() + got.numel(), 3 * got.numel()), amax_pool_ms(torch, timer, x, got)))
    del x, got
    # K9: g0_0's bf16 output quantized into a new tensor, and the dequant of
    # the last cell x_{0,4} from slot 4 of row 0 (a strided read)
    e = (torch.randn((n, P, P, nf), generator=y.g, device=dev) * 2).to(torch.bfloat16)
    for form, site, call, n_bytes in (
            (f"g0_0 bf16 -> int8 ({n}, {P}^2, {nf})", "quant_nested.py:238",
             lambda f: f(e, 1.0, 0.05), 3 * e.numel()),
            (f"dequant row0 slot 4 ({n}, {P}^2, {nf} of {6 * nf}) -> bf16", "quant_nested.py:257",
             lambda f: f(row0[..., 4 * nf:5 * nf], 0.031), 3 * e.numel())):
        got = call(k8.requant).clone()
        torch.cuda.synchronize()
        err = y.check(f"K9 {form}", got, call(k8.requant_plain))
        rows.append(kernel_row(
            "kernels nested int8", f"k9_requant[{form}]", INT8_SOURCE,
            f"bio_image_unet_tpu/predict/{site}", k8.requant, err,
            timer(lambda: call(k8.requant)), timer(lambda: call(k8.requant_plain), 1),
            bound_ms(n_bytes, 4 * e.numel()), None))
        del got
    del row0, e
    torch.cuda.empty_cache()

    # K11 from slot j-1 of row 1 (5 slots of 64) into slots j, j+1 of row 0
    row1 = y.i8((n, P // 2, P // 2, 5 * 2 * nf))
    for name, x, ctot, off in (
            (f"row1 slot 0 ({n}, {P // 2}^2, {2 * nf} of {10 * nf}) -> row0 [{nf}, {3 * nf})",
             row1[..., :2 * nf], 6 * nf, nf),
            ("odd (3, 37, 29, 24 of 30) -> of 40 at 8", y.i8((3, 37, 29, 30))[..., 3:27], 40, 8),
            ("odd (2, 33, 65, 7) -> of 12 at 5", y.i8((2, 33, 65, 7)), 12, 5)):
        b, h, w, c = x.shape
        bufs = [torch.zeros((b, 2 * h, 2 * w, ctot), dtype=torch.int8, device=dev)
                for _ in range(2)]
        k8.upsample2x_i8(x, out=bufs[0], offset=off)
        torch.cuda.synchronize()
        k8.upsample2x_i8_plain(x, out=bufs[1], offset=off)
        err = y.check(f"K11 {name}", bufs[0], bufs[1])
        del bufs[1]
        n_out = 4 * x.numel()

        def library():
            # F.interpolate's bilinear (align_corners=True) on the values in
            # float32, round, clip, int8 and the copy into the channel range
            u = F.interpolate(x.permute(0, 3, 1, 2).float(), scale_factor=2, mode="bilinear",
                              align_corners=True)
            bufs[0][..., off:off + c] = torch.clamp(torch.round(u), -127, 127).to(
                torch.int8).permute(0, 2, 3, 1)

        rows.append(kernel_row(
            "kernels nested int8", f"k11_upsample2x_i8[{name}]", RESAMPLE_SOURCE,
            "bio_image_unet_tpu/predict/quant_nested.py:249", k8.upsample2x_i8, err,
            timer(lambda: k8.upsample2x_i8(x, out=bufs[0], offset=off)),
            timer(lambda: k8.upsample2x_i8_plain(x, out=bufs[0], offset=off), 1),
            # each input byte read once, each output byte written once; some
            # 10 float operations an output (4 gathers' blends, round, clip)
            bound_ms(x.numel() + n_out, 10 * n_out), timer(library, 5)))
        del x, bufs
        torch.cuda.empty_cache()
    del row1
    return rows


# --- 25. nested int8 ----------------------------------------------------------------

def nested_int8_ops(nf: int, s: int) -> float:
    """int8 operations of one s² tile through the UNet++ int8 grid: every
    conv but ``g0_0``'s first and the three 1×1 head channels, which run in
    bf16."""
    return nested_unet_forward_flops(nf, s) - 2 * 9 * nf * s * s - 2 * nf * 3 * s * s


def nested_int8_bounds(tag: str, what: str, q: dict, ref: dict) -> None:
    """The JAX package's UNet++ int8 bounds against bf16
    (``tests/test_quant_families.py:203-227``): on every head, max under 25%
    and mean under 3% of its output range (floored at 0.5)."""
    for head in MO_HEADS:
        rg = max(float(ref[head].max() - ref[head].min()), 0.5)
        d = np.abs(q[head].astype(np.float32) - ref[head].astype(np.float32))
        log(f"[{tag}] {what} {head}: max {d.max() / rg:.5f}, mean {d.mean() / rg:.6f} of the "
            f"head's range ({rg:.4f})")
        if not (d.max() / rg < 0.25 and d.mean() / rg < 0.03):
            raise AssertionError(f"{what} {head}: outside JAX's UNet++ int8 bounds")


def phase_nested_int8(torch, dev, kernels, knested) -> float:
    """``PredictMultiOutput(quantized=True)`` under ``BIU_INT8_EXPERIMENTAL=1``
    at config 4 (``family_bench.py:293-333``): a BN-warmed
    ``MultiOutputNestedUNet(32)``, 40 uint8 1024² frames, 512² patches,
    ``safe_margin=20``, bf16 outside the int8 grid."""
    import os

    from bio_image_unet_tpu_torch.ops import histogram as hist
    from bio_image_unet_tpu_torch.ops import int8 as k8
    from bio_image_unet_tpu_torch.ops.stitch import margin_stitch, tile_sum
    from bio_image_unet_tpu_torch.predict import PredictMultiOutput
    from bio_image_unet_tpu_torch.predict.normalize import normalize_tile_float
    from bio_image_unet_tpu_torch.predict.predictor import _Engine
    from bio_image_unet_tpu_torch.predict.quant_nested import Int8NestedUNet
    from bio_image_unet_tpu_torch.predict.tiling import _margin_factors, grid_starts

    torch.backends.cudnn.allow_tf32 = True  # the user's default
    counters = list({id(k["_counter"]): k["_counter"] for k in kernels + knested}.values())
    P = HEADS_PATCH
    n_chunks, n_heads = -(-HEADS_FRAMES // CHUNK), len(MO_HEADS)
    per_chunk = CHUNK * (H // P) * (W // P)
    bs = min(per_chunk, (1 << 22) // (P * P))  # _Engine.heads_batch: 16 tiles
    batches = n_chunks * -(-per_chunk // bs)

    def grid(b, levels=4):
        """The int8 kernels' launches of ``b`` forward batches of an L-level
        grid: every conv but the first by K7, K11 for every cell x_{k,j>0},
        K10 down column 0, K9 for the first conv's output and the last
        cell's dequant (the partners are read in place: no copy)."""
        cells = levels * (levels + 1) // 2
        return {k8.qconv3x3: ((levels + 1) * (levels + 2) - 1) * b, k8.upsample2x_i8: cells * b,
                k8.maxpool_i8: levels * b, k8.requant: 2 * b}

    # beside the calibration: K1 (its uint8 launches) and K2h on its two frames
    expect = plus({hist.int_clip_bounds: hist.LAUNCHES[torch.uint8] * n_chunks,
                   normalize_tile_float: n_chunks, margin_stitch: n_chunks * n_heads,
                   tile_sum: n_chunks * n_heads, **grid(batches)},
                  {hist.int_clip_bounds: hist.LAUNCHES[torch.uint8], normalize_tile_float: 1})
    rng = np.random.default_rng(16)
    movie = rng.integers(0, 255, (HEADS_FRAMES, H, W), dtype=np.uint8)
    kw = dict(max_patch_size=(P, P), half_precision=True, safe_margin=HEADS_MARGIN,
              show_progress=False)
    main = f"UNet++(32) BN-warmed int8 uint8 {HEADS_FRAMES}x1024^2 (config 4)"
    env = os.environ.get("BIU_INT8_EXPERIMENTAL")
    os.environ["BIU_INT8_EXPERIMENTAL"] = "1"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            ckpt = str(tmp / "nested_warm_nf32.pt")
            write_warm_checkpoint(torch, ckpt, "MultiOutputNestedUNet", HEADS_FILTER, seed=31,
                                  output_heads=MO_HEADS)

            # the main path of this phase: launches exact around the call
            t0 = time.perf_counter()
            pred, got = counted(torch, "nested int8", counters, main,
                                lambda: PredictMultiOutput(movie, ckpt, quantized=True, **kw),
                                expect)
            first = time.perf_counter() - t0
            if not (pred.engine._quant_ready
                    and isinstance(pred.engine.forward, Int8NestedUNet)):
                raise AssertionError("the quantized PredictMultiOutput did not run the int8 grid")
            for k in knested:
                k["launches"] = got[k["_counter"]]
            q_res = pred.result
            check_heads(main, q_res, movie.shape)

            # end to end, int8 and bf16 back to back (best of two after the
            # call above), each call's peak device memory
            times = {"int8": float("inf"), "bf16": float("inf")}
            call_peak = {"int8": 0, "bf16": 0}
            results = {}
            for mode in ("bf16", "int8", "int8", "bf16", "bf16"):
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                results[mode] = PredictMultiOutput(movie, ckpt, quantized=mode == "int8",
                                                   **kw).result
                times[mode] = min(times[mode], time.perf_counter() - t0)
                call_peak[mode] = max(call_peak[mode], torch.cuda.max_memory_allocated())
            if any(not np.array_equal(results["int8"][h], q_res[h]) for h in MO_HEADS):
                raise AssertionError("two quantized calls on one movie disagree")
            nested_int8_bounds("nested int8", f"{main}: int8 vs bf16", q_res, results["bf16"])
            mp = HEADS_FRAMES * H * W / 1e6
            e2e = {m: mp / t for m, t in times.items()}
            ratio = e2e["int8"] / e2e["bf16"]

            # device-resident: both chunk programs on the movie on the card, in turns
            xs, ys = grid_starts(H, P), grid_starts(W, P)
            factors = _margin_factors((len(xs), len(ys)), (P, P), HEADS_MARGIN)
            engines = {"int8": _Engine(ckpt, None, 8, True, dev, quantized=True),
                       "bf16": _Engine(ckpt, None, 8, True, dev)}
            fns = {m: e.heads_runner(H, W, xs, ys, (P, P), HEADS_CLIP, factors,
                                     n_frames=HEADS_FRAMES, sample=movie)[0]
                   for m, e in engines.items()}
            movie_dev = torch.from_numpy(movie).to(dev)
            real = [min(CHUNK, HEADS_FRAMES - i) for i in range(0, HEADS_FRAMES, CHUNK)]

            def resident(mode):
                outs = []
                for i, k in zip(range(0, HEADS_FRAMES, CHUNK), real):
                    chunk = movie_dev[i:i + CHUNK]
                    if k < CHUNK:  # the tail chunk repeats its last frame
                        chunk = torch.cat([chunk, chunk[-1:].expand(CHUNK - k, H, W)])
                    outs.append(fns[mode](chunk, k))
                return outs

            device = {"int8": float("inf"), "bf16": float("inf")}
            torch.cuda.reset_peak_memory_stats()
            for mode in ("int8", "bf16", "bf16", "int8", "int8", "bf16"):
                resident(mode)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs = resident(mode)
                torch.cuda.synchronize()
                device[mode] = min(device[mode], time.perf_counter() - t0)
            resident_peak = torch.cuda.max_memory_allocated()
            del outs
            resident_mps = {m: mp / t for m, t in device.items()}
            ops = nested_int8_ops(HEADS_FILTER, P) * batches * bs
            log(f"[nested int8] {main}: end to end int8 {e2e['int8']:.2f} MP/s, bf16 "
                f"{e2e['bf16']:.2f} MP/s (ratio {e2e['int8'] / e2e['bf16']:.3f}; first call "
                f"{first:.3f} s with the calibration); device-resident int8 "
                f"{resident_mps['int8']:.2f} MP/s ({device['int8'] * 1e3:.2f} ms), bf16 "
                f"{resident_mps['bf16']:.2f} MP/s ({device['bf16'] * 1e3:.2f} ms) (ratio "
                f"{resident_mps['int8'] / resident_mps['bf16']:.3f}); int8 grid "
                f"{nested_int8_ops(HEADS_FILTER, P) / 1e9:.1f} GOP a {P}² tile, {batches * bs} "
                f"tiles a pass (the tail chunk padded) → {ops / device['int8'] / 1e12:.1f} "
                f"TOP/s device-resident, {ops / device['int8'] / PEAK_INT8_OPS:.4f} of the int8 "
                f"dense peak; peak device memory of the device-resident passes (both engines, "
                f"the movie on the card) {resident_peak / 2**30:.2f} GiB; of one call int8 "
                f"{call_peak['int8'] / 2**30:.2f} GiB, bf16 {call_peak['bf16'] / 2**30:.2f} GiB")
            profile_pass(torch, lambda: resident("int8"), "nested int8",
                         f"{HEADS_FRAMES} frames, int8")
            del movie_dev, engines, fns

            # card vs CPU: a BN-warmed UNet++(8) at both depths, the CPU
            # through the plain versions
            for name, deep in (("MultiOutputNestedUNet", False),
                               ("MultiOutputNestedUNet_3Levels", True)):
                small = str(tmp / f"{name}_nf8.pt")
                write_warm_checkpoint(torch, small, name, 8, seed=32, output_heads=MO_HEADS,
                                      deep_supervision=deep)
                m = rng.integers(0, 255, (3, 96, 96), dtype=np.uint8)
                ckw = dict(max_patch_size=(48, 48), safe_margin=4, show_progress=False,
                           quantized=True)
                card = PredictMultiOutput(m, small, **ckw)
                cpu = PredictMultiOutput(m, small, device="cpu", **ckw)
                if not (card.engine._quant_ready and cpu.engine._quant_ready):
                    raise AssertionError("card vs CPU: a quantized UNet++ did not calibrate")
                nested_int8_bounds("nested int8", f"{name}(8) deep_supervision={deep} int8: "
                                   "card vs CPU", card.result, cpu.result)
    finally:
        if env is None:
            os.environ.pop("BIU_INT8_EXPERIMENTAL", None)
        else:
            os.environ["BIU_INT8_EXPERIMENTAL"] = env
    return ratio


# --- 26. attention --------------------------------------------------------------------

def phase_attention(torch, dev, kernels) -> float:
    """``Predict`` on a BN-warmed ``AttentionUnet(32)`` at config 1
    (``benchmarks/probe_trunk_int8.py``: the 64×1024² uint8 movie, 256²
    tiles, bf16, fused): float, then ``quantized=True`` (int8 by default:
    ``attention2d`` is in the ship set)."""
    from bio_image_unet_tpu_torch.ops import histogram as hist
    from bio_image_unet_tpu_torch.ops import int8 as k8
    from bio_image_unet_tpu_torch.ops.stitch import sigmoid_stitch
    from bio_image_unet_tpu_torch.predict import Predict
    from bio_image_unet_tpu_torch.predict.normalize import normalize_tile, normalize_tile_float
    from bio_image_unet_tpu_torch.predict.predictor import _Engine
    from bio_image_unet_tpu_torch.predict.quant import Int8Unet2D
    from bio_image_unet_tpu_torch.predict.tiling import grid_starts

    torch.backends.cudnn.allow_tf32 = True  # the user's default
    counters = list({id(k["_counter"]): k["_counter"] for k in kernels}.values())
    chunks = FRAMES // CHUNK  # one forward batch of 256 tiles a chunk
    frame = {hist.int_clip_bounds: hist.LAUNCHES[torch.uint8] * chunks, normalize_tile: chunks,
             sigmoid_stitch: chunks}
    # the gated decoder: K9 dequantizes the up path and the skip and requantizes
    # the attended skip at each of the 4 levels, beside e1's quantize and the
    # last dequant
    gated = {k8.qconv3x3: 17 * chunks, k8.qconvt2x2: 4 * chunks, k8.requant: 14 * chunks,
             k8.maxpool_i8: 4 * chunks}
    rng = np.random.default_rng(17)
    movie = rng.integers(0, 255, (FRAMES, H, W), dtype=np.uint8)
    kw = dict(resize_dim=(TILE, TILE), show_progress=False, batch_size=8, half_precision=True)
    main = f"AttentionUnet(32) BN-warmed uint8 {FRAMES}x1024^2 (config 1)"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ckpt = str(tmp / "attention_warm_nf32.pt")
        write_warm_checkpoint(torch, ckpt, "AttentionUnet", N_FILTER, seed=33)

        # the main path of this phase, float then int8: launches exact
        res = {}
        # int8 adds the gated trunk and the calibration (K1, K2h on two frames)
        cal = {hist.int_clip_bounds: hist.LAUNCHES[torch.uint8], normalize_tile_float: 1}
        for mode, expect in (("bf16", frame), ("int8", plus({**frame, **gated}, cal))):
            pred, _ = counted(torch, "attention", counters, f"{main}, {mode}",
                              lambda: Predict(movie, None, ckpt, quantized=mode == "int8",
                                              **kw), expect)
            if pred.engine._quant_ready != (mode == "int8") or (
                    mode == "int8" and not isinstance(pred.engine.forward, Int8Unet2D)):
                raise AssertionError(f"{main}: quantized=True did not run int8 by default")
            res[mode] = pred.result
        host = Predict(movie, None, ckpt, device_pipeline=False, **kw).result
        check_fused_vs_host(f"{main}, bf16", res["bf16"], host, movie.shape, tag="attention")
        int8_contract("attention", f"{main}: int8 vs bf16", res["int8"], res["bf16"])

        # end to end, back to back (best of two), each call's peak memory
        times = {"int8": float("inf"), "bf16": float("inf")}
        call_peak = {"int8": 0, "bf16": 0}
        for mode in ("bf16", "int8", "int8", "bf16", "bf16", "int8"):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = Predict(movie, None, ckpt, quantized=mode == "int8", **kw).result
            times[mode] = min(times[mode], time.perf_counter() - t0)
            call_peak[mode] = max(call_peak[mode], torch.cuda.max_memory_allocated())
            if not np.array_equal(out, res[mode]):
                raise AssertionError(f"two {mode} calls on one movie disagree")
        e2e = {m: FRAMES * H * W / 1e6 / t for m, t in times.items()}
        ratio = e2e["int8"] / e2e["bf16"]

        # device-resident: both chunk programs on the movie on the card, in turns
        xs, ys = grid_starts(H, TILE, 0), grid_starts(W, TILE, 0)
        engines = {"int8": _Engine(ckpt, None, 8, True, dev, quantized=True),
                   "bf16": _Engine(ckpt, None, 8, True, dev)}
        fns = {m: e.fused_runner(H, W, xs, ys, (TILE, TILE), (0.0, 99.8), n_frames=FRAMES,
                                 sample=movie)[0] for m, e in engines.items()}
        movie_dev = torch.from_numpy(movie).to(dev)

        def resident(mode):
            return [fns[mode](movie_dev[i:i + CHUNK]) for i in range(0, FRAMES, CHUNK)]

        device = {"int8": float("inf"), "bf16": float("inf")}
        torch.cuda.reset_peak_memory_stats()
        for mode in ("int8", "bf16", "bf16", "int8", "int8", "bf16"):
            resident(mode)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = resident(mode)
            torch.cuda.synchronize()
            device[mode] = min(device[mode], time.perf_counter() - t0)
            same = int(np.abs(torch.cat(outs).cpu().numpy().astype(np.int16) - res[mode]).max())
            if same:
                raise AssertionError(f"device-resident {mode} run vs Predict: {same} levels")
        resident_peak = torch.cuda.max_memory_allocated()
        del outs
        resident_mps = {m: FRAMES * H * W / 1e6 / t for m, t in device.items()}
        ops = int8_trunk_ops(N_FILTER, TILE) * FRAMES * (H // TILE) * (W // TILE)
        log(f"[attention] {main}: end to end int8 {e2e['int8']:.2f} MP/s, bf16 "
            f"{e2e['bf16']:.2f} MP/s (ratio {e2e['int8'] / e2e['bf16']:.3f}); device-resident "
            f"int8 {resident_mps['int8']:.2f} MP/s ({device['int8'] * 1e3:.2f} ms), bf16 "
            f"{resident_mps['bf16']:.2f} MP/s ({device['bf16'] * 1e3:.2f} ms) (ratio "
            f"{resident_mps['int8'] / resident_mps['bf16']:.3f}); int8 trunk (the gates in "
            f"bf16, not counted) {ops / device['int8'] / 1e12:.1f} TOP/s device-resident; peak "
            f"device memory of the device-resident passes {resident_peak / 2**30:.2f} GiB; of "
            f"one call int8 {call_peak['int8'] / 2**30:.2f} GiB, bf16 "
            f"{call_peak['bf16'] / 2**30:.2f} GiB")
        profile_pass(torch, lambda: resident("int8"), "attention", f"{FRAMES} frames, int8")
        profile_pass(torch, lambda: resident("bf16"), "attention", f"{FRAMES} frames, bf16")
        del movie_dev, engines, fns

        # card vs CPU: AttentionUnet(8) in float32 (TF32 off) and BN-warmed in int8
        small = str(tmp / "attention_nf8.pt")
        write_warm_checkpoint(torch, small, "AttentionUnet", 8, seed=34)
        m = rng.integers(0, 255, (3, 128, 128), dtype=np.uint8)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        skw = dict(resize_dim=(64, 64), show_progress=False, batch_size=4)
        on_card = Predict(m, None, small, **skw).result
        on_cpu = Predict(m, None, small, device="cpu", **skw).result
        diff = np.abs(on_card.astype(int) - on_cpu.astype(int))
        log(f"[attention] small float32 AttentionUnet(8): card vs CPU max {diff.max()} levels "
            f"on {np.mean(diff > 0):.6f} of pixels")
        if diff.max() > 1 or np.mean(diff > 0) > 1e-3:
            raise AssertionError("the card's AttentionUnet Predict disagrees with the CPU's")
        torch.backends.cudnn.allow_tf32 = True
        int8_contract("attention", "AttentionUnet(8) int8: card vs CPU",
                      Predict(m, None, small, quantized=True, **skw).result,
                      Predict(m, None, small, quantized=True, device="cpu", **skw).result)
    return ratio


# --- 28-32. the rest of the 2D models: legacy, multi-channel, training ----------

def legacy_forward_flops(nf: int, s: int) -> float:
    """Multiply-add FLOPs of one s² tile through ``Unet_v0(n_filter=nf)``: the
    widths of ``Unet``'s (the skips come from the first conv of a level, of
    the same width), then the extra 1-channel 3×3 block and a 1×1 final conv
    on 1 channel in place of ``Unet``'s nf-channel one."""
    hw = s * s
    return unet_forward_flops(nf, s) - 2 * nf * hw + 2 * nf * 9 * hw + 2 * hw


def phase_legacy(torch, dev, kernels) -> None:
    """``Predict(network="Unet_v0")`` on an old-style ``.pt`` of a seeded
    ``Unet_v0(32)`` (no ``model_name``, as the reference's early checkpoints)
    over 16 uint8 1024² frames in 256² tiles, fused: K1 → K2 → the folded
    float32 legacy forward (B4, cuDNN) → K3 on float32 logits."""
    from bio_image_unet_tpu_torch.models import get_model
    from bio_image_unet_tpu_torch.ops import histogram as hist
    from bio_image_unet_tpu_torch.ops.blocks import init_weights_
    from bio_image_unet_tpu_torch.ops.stitch import sigmoid_stitch
    from bio_image_unet_tpu_torch.predict import Predict
    from bio_image_unet_tpu_torch.predict.fastpath import FoldedLegacyUnet2D
    from bio_image_unet_tpu_torch.predict.normalize import normalize_tile
    from bio_image_unet_tpu_torch.predict.predictor import _Engine
    from bio_image_unet_tpu_torch.predict.tiling import grid_starts

    torch.backends.cudnn.allow_tf32 = True  # the user's default
    counters = list({id(k["_counter"]): k["_counter"] for k in kernels}.values())
    rng = np.random.default_rng(23)
    movie = rng.integers(0, 255, (CHUNK, H, W), dtype=np.uint8)
    kw = dict(resize_dim=(TILE, TILE), show_progress=False, batch_size=8)
    main = f"Unet_v0(32) uint8 {CHUNK}x1024^2, 256^2 tiles, fused"

    def write_legacy(path, name, nf, seed):
        net = init_weights_(get_model(name, n_filter=nf), torch.Generator().manual_seed(seed),
                            random_bn_stats=True)
        torch.save({"state_dict": net.state_dict(), "epoch": 0, "best_loss": None,
                    "n_filter": nf}, path)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ckpt = str(tmp / "unet_v0_nf32.pt")
        write_legacy(ckpt, "Unet_v0", N_FILTER, 51)
        expect = {hist.int_clip_bounds: hist.LAUNCHES[torch.uint8], normalize_tile: 1,
                  sigmoid_stitch: 1}
        torch.cuda.reset_peak_memory_stats()
        pred, _ = counted(torch, "legacy", counters, main,
                          lambda: Predict(movie, None, ckpt, network="Unet_v0", **kw), expect)
        call_peak = torch.cuda.max_memory_allocated()
        engine = pred.engine
        if engine.dtype != torch.float32 or not isinstance(engine.forward, FoldedLegacyUnet2D):
            raise AssertionError(f"{main}: engine {engine.dtype} {type(engine.forward).__name__}")
        res = pred.result
        if res.shape != movie.shape or res.dtype != np.uint8:
            raise AssertionError(f"{main}: result {res.shape} {res.dtype}")
        best = float("inf")
        for half in (False, True):
            t0 = time.perf_counter()
            out = Predict(movie, None, ckpt, network="Unet_v0", half_precision=half, **kw).result
            best = min(best, time.perf_counter() - t0)
            if not np.array_equal(out, res):
                raise AssertionError(f"{main}: half_precision={half} gives other masks")
        log(f"[legacy] {main}: half_precision=True gives the same masks as False (float32)")
        host = Predict(movie, None, ckpt, network="Unet_v0", device_pipeline=False, **kw).result
        check_fused_vs_host(main, res, host, movie.shape, tag="legacy")

        # device-resident: the chunk program on the movie already on the card
        xs, ys = grid_starts(H, TILE, 0), grid_starts(W, TILE, 0)
        resident = _Engine(ckpt, "Unet_v0", 8, False, dev)
        fn, n_chunk = resident.fused_runner(H, W, xs, ys, (TILE, TILE), (0.0, 99.8),
                                            n_frames=CHUNK)
        movie_dev = torch.from_numpy(movie).to(dev)
        if not np.array_equal(fn(movie_dev).cpu().numpy(), res):
            raise AssertionError(f"{main}: the device-resident program differs from Predict")
        device = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(movie_dev)
            torch.cuda.synchronize()
            device = min(device, time.perf_counter() - t0)
        mp = CHUNK * H * W / 1e6
        flops = legacy_forward_flops(N_FILTER, TILE) * CHUNK * (H // TILE) * (W // TILE)
        log(f"[legacy] {main}: end to end {mp / best:.2f} MP/s ({best:.3f} s, best of two "
            f"after the counted call), device-resident {mp / device:.2f} MP/s "
            f"({device * 1e3:.2f} ms; {flops / device / 1e12:.1f} TFLOP/s in float32 with "
            f"TF32, {flops / 1e12:.2f} TFLOP a call); peak device memory of one call "
            f"{call_peak / 2**30:.2f} GiB")
        profile_pass(torch, lambda: fn(movie_dev), "legacy", f"{CHUNK} frames, float32")
        del movie_dev, resident, fn

        # card vs CPU: Unet_v0(8) and BabyUnet(4) on 2 x 512^2, float32, TF32 off
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        small = rng.integers(0, 255, (2, 512, 512), dtype=np.uint8)
        for name, nf, seed in (("Unet_v0", 8, 52), ("BabyUnet", 4, 53)):
            path = str(tmp / f"{name}_nf{nf}.pt")
            write_legacy(path, name, nf, seed)
            on_card = Predict(small, None, path, network=name, **kw).result
            on_cpu = Predict(small, None, path, network=name, device="cpu", **kw).result
            diff = np.abs(on_card.astype(int) - on_cpu.astype(int))
            log(f"[legacy] {name}({nf}) 2x512^2: card vs CPU max {diff.max()} levels on "
                f"{np.mean(diff > 0):.6f} of pixels")
            if diff.max() > 1 or np.mean(diff > 0) > 1e-3:
                raise AssertionError(f"the card's {name} Predict disagrees with the CPU's")
        torch.backends.cudnn.allow_tf32 = True


MC_CHANNELS = 2


def phase_kernels_multichannel(torch, dev) -> list:
    """K3c, K3 over C channels, at the multi-channel path's shapes: 16 frames
    of 1024² from 256 bf16 logit tiles of 256² (c = 2 and 3), the overlapping
    grid (1000² frames, ``add_tile=1``) and float32 512² tiles (c = 2); each
    within one level of its plain version, timed beside its byte bound.  The
    first form is ``[multichannel]``'s; the others report 0 launches."""
    from bio_image_unet_tpu_torch.ops.stitch import sigmoid_stitch, sigmoid_stitch_plain
    from bio_image_unet_tpu_torch.predict.tiling import TilePlan, grid_starts

    timer = Timer(torch, dev)
    g = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for c, side, tile, add, dtype, what in (
            (2, H, TILE, 0, torch.bfloat16, "exact bf16"),
            (2, 1000, TILE, 1, torch.bfloat16, "overlap bf16, add_tile=1"),
            (2, H, 2 * TILE, 0, torch.float32, "exact float32 512^2 tiles"),
            (3, H, TILE, 0, torch.bfloat16, "exact bf16")):
        starts = grid_starts(side, tile, add)
        plan = TilePlan(side, side, tile, tile, starts, starts, dev)
        n = CHUNK * plan.per_frame
        logits = (torch.randn((n, c, tile, tile), generator=g, device=dev) * 4).to(dtype)
        ours = sigmoid_stitch(logits, CHUNK, plan)
        torch.cuda.synchronize()
        ref = sigmoid_stitch_plain(logits, CHUNK, plan)
        if ours.shape != (CHUNK, c, side, side):
            raise AssertionError(f"K3c c={c} {what}: result {tuple(ours.shape)}")
        err = (ours.int() - ref.int()).abs().max().item()
        if err > 1:
            raise AssertionError(f"K3c c={c} {what}: kernel differs from plain by {err} levels")
        n_logit = n * c * tile * tile
        rows.append(kernel_row(
            "kernels multichannel",
            f"k3c_sigmoid_stitch[c={c} {what} ({n}, {c}, {tile}^2) -> {CHUNK}x{c}x{side}^2]",
            "bio_image_unet_tpu_torch/csrc/sigmoid_stitch.cu",
            "bio_image_unet_tpu/ops/stitch.py:80", sigmoid_stitch, err,
            timer(lambda: sigmoid_stitch(logits, CHUNK, plan)),
            timer(lambda: sigmoid_stitch_plain(logits, CHUNK, plan), 3),
            # read each real tile's logits once, write each pixel of each
            # channel once; about five operations per logit
            bound_ms(n_logit * logits.element_size() + CHUNK * c * side * side, 5 * n_logit),
            None))
        # [multichannel] runs the first form; the others are timing rows
        rows[-1]["_timing_only"] = len(rows) > 1
        del logits, ours, ref
    torch.cuda.empty_cache()
    return rows


def phase_multichannel(torch, dev, kernels, kmc) -> None:
    """``Predict`` of a seeded ``Unet(32, out_channels=2)`` on 16 uint8 1024²
    frames in 256² tiles, bf16: host-staged, as JAX runs it (the fused
    program stitches one channel): host normalize and uint8 tiles, the
    forward, K3c a 16-frame chunk (one launch a channel)."""
    from bio_image_unet_tpu_torch.ops.stitch import sigmoid_stitch
    from bio_image_unet_tpu_torch.predict import Predict

    torch.backends.cudnn.allow_tf32 = True
    counters = list({id(k["_counter"]): k["_counter"] for k in kernels + kmc}.values())
    rng = np.random.default_rng(29)
    movie = rng.integers(0, 255, (CHUNK, H, W), dtype=np.uint8)
    kw = dict(resize_dim=(TILE, TILE), show_progress=False, batch_size=8, half_precision=True)
    main = f"Unet(32, out_channels={MC_CHANNELS}) uint8 {CHUNK}x1024^2, 256^2 tiles, bf16"
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "unet_c2_nf32.pt")
        write_checkpoint(torch, ckpt, "Unet", N_FILTER, seed=41, out_channels=MC_CHANNELS)
        torch.cuda.reset_peak_memory_stats()
        pred, got = counted(torch, "multichannel", counters, main,
                            lambda: Predict(movie, None, ckpt, **kw),
                            {sigmoid_stitch: MC_CHANNELS})
        call_peak = torch.cuda.max_memory_allocated()
        kmc[0]["launches"] = got[sigmoid_stitch]
        res = pred.result
        want = (CHUNK, MC_CHANNELS, H, W)
        if res.shape != want or res.dtype != np.uint8:
            raise AssertionError(f"{main}: result {res.shape} {res.dtype}, want {want} uint8")
        best, split = float("inf"), None
        for _ in range(2):
            t0 = time.perf_counter()
            p = Predict(movie, None, ckpt, **kw)
            dt = time.perf_counter() - t0
            if dt < best:
                best, split = dt, dict(p.engine.chunk_seconds)
            if not np.array_equal(p.result, res):
                raise AssertionError(f"{main}: two calls disagree")
        log(f"[multichannel] {main}: end to end {CHUNK * H * W / 1e6 / best:.2f} MP/s "
            f"({best:.3f} s, best of two after the counted call); chunk stages of the best "
            "call: " + ", ".join(f"{k} {v:.4f} s" for k, v in split.items())
            + f" (the rest: host normalization before the chunks); peak device memory of one "
            f"call {call_peak / 2**30:.2f} GiB; mask means by channel "
            + ", ".join(f"{res[:, c].mean():.2f}" for c in range(MC_CHANNELS)))

        # card vs CPU: n_filter 8, float32 with TF32 off
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        small = str(Path(tmp) / "unet_c2_nf8.pt")
        write_checkpoint(torch, small, "Unet", 8, seed=42, out_channels=MC_CHANNELS)
        m = rng.integers(0, 65535, (3, 300, 260), dtype=np.uint16)
        skw = dict(resize_dim=(128, 128), add_tile=1, show_progress=False, batch_size=4)
        on_card = Predict(m, None, small, **skw).result
        on_cpu = Predict(m, None, small, device="cpu", **skw).result
        diff = np.abs(on_card.astype(int) - on_cpu.astype(int))
        log(f"[multichannel] Unet(8, out_channels={MC_CHANNELS}) uint16 3x300x260 add_tile=1: "
            f"result {on_card.shape}; card vs CPU max {diff.max()} levels on "
            f"{np.mean(diff > 0):.6f} of pixels")
        if on_card.shape != (3, MC_CHANNELS, 300, 260) or diff.max() > 1 or \
                np.mean(diff > 0) > 1e-3:
            raise AssertionError("the card's multi-channel Predict disagrees with the CPU's")
        torch.backends.cudnn.allow_tf32 = True


def phase_train_attention(torch, dev, kernels, k4) -> None:
    """``[train]``'s leg (config 2) with ``network="AttentionUnet"``: the
    gates in float32 (as flax promotes them), the rest in bf16; 3 epochs,
    patches/s over the best after the first; then card vs CPU at n_filter 4."""
    # the gates' 1×1 convs and their products are not counted
    train_leg(torch, kernels, k4, "train attention", network="AttentionUnet", timed_from=1)
    train_card_vs_cpu(torch, "AttentionUnet", 4, tag="train attention")


def phase_train_legacy(torch, dev, kernels, k4) -> None:
    """``Unet_v0(32)`` on the same frames, 2 epochs: float32 whatever
    ``half_precision`` says (TF32 convolutions, as torch's defaults allow),
    the bottleneck's channel dropout drawn from the Trainer's generator."""
    train_leg(torch, kernels, k4, "train legacy", network="Unet_v0", epochs=2, timed_from=1,
              flops_per_tile=legacy_forward_flops(N_FILTER, TILE), peak=PEAK_TF32_FLOPS)


# --- 33–35. the command line, the recipes, the histogram oracle -----------------------

CLI_FRAMES, CLI_EPOCHS = 60, 2


def run_module(tag: str, args: list, timeout: float) -> str:
    """``python -m bio_image_unet_tpu_torch <args>`` from the checkout (on
    ``PYTHONPATH``); its stdout.  On a non-zero exit the tail of its stderr
    is printed before the run fails."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "bio_image_unet_tpu_torch", *args],
                          cwd=str(REPO), env=env, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        log(f"[{tag}] stderr of `-m bio_image_unet_tpu_torch {args[0]}` (tail):\n"
            + proc.stderr[-4000:])
        raise AssertionError(f"`python -m bio_image_unet_tpu_torch {args[0]}` exited with "
                             f"{proc.returncode}")
    log(f"[{tag}] `python -m bio_image_unet_tpu_torch {args[0]}`: exit 0 in "
        f"{time.perf_counter() - t0:.2f} s")
    return proc.stdout


def phase_cli(torch, dev, kernels, k4, kind: str) -> None:
    from bio_image_unet_tpu_torch import unet
    from bio_image_unet_tpu_torch.__main__ import main as cli
    from bio_image_unet_tpu_torch.data import tiff
    from bio_image_unet_tpu_torch.ops import histogram as hist
    from bio_image_unet_tpu_torch.ops.stitch import sigmoid_stitch
    from bio_image_unet_tpu_torch.predict.normalize import normalize_tile
    from bio_image_unet_tpu_torch.train import trainer as trainer_mod

    counters = list({id(k["_counter"]): k["_counter"] for k in kernels}.values())
    torch.backends.cudnn.allow_tf32 = True  # the user's default
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        source = write_blob_frames(tmp / "frames", CLI_FRAMES, TILE, seed=0)
        argv = ["train", "--family", "unet", "--image-dir", source[0], "--label-dir", source[1],
                "--workdir", str(tmp / "run"), "--n-filter", str(N_FILTER),
                "--dim", str(TILE), str(TILE), "--batch-size", str(TRAIN_BATCH),
                "--lr", str(TRAIN_LR), "--aug-factor", "1", "--half-precision",
                "--device-cache", "--device-augment", "--epochs", str(CLI_EPOCHS)]

        # the facade's training with the CLI's arguments first, for its wall time
        t0 = time.perf_counter()
        data = unet.DataProcess(source, dim_out=(TILE, TILE), aug_factor=1,
                                data_path=str(tmp / "facade" / "data"))
        unet.Trainer(data, CLI_EPOCHS, batch_size=TRAIN_BATCH, lr=TRAIN_LR, n_filter=N_FILTER,
                     save_dir=str(tmp / "facade" / "model"), loss_function="BCEDice",
                     load_weights=False, device_cache=True, half_precision=True,
                     device_augment=True).start()
        torch.cuda.synchronize()
        t_facade_train = time.perf_counter() - t0

        # the Trainer the CLI builds, kept to read its steps an epoch
        trainers, start = [], trainer_mod.Trainer.start

        def keep(self, *args, **kw):
            trainers.append(self)
            return start(self, *args, **kw)

        trainer_mod.Trainer.start = keep
        try:
            for c in counters:
                c.launches = 0
            t0 = time.perf_counter()
            if cli(argv) != 0:
                raise AssertionError("[cli] train exited non-zero")
            torch.cuda.synchronize()
            t_cli_train = time.perf_counter() - t0
        finally:
            trainer_mod.Trainer.start = start
        got = {c: c.launches for c in counters}
        steps = trainers[0]._n_train // TRAIN_BATCH * CLI_EPOCHS
        log("[cli] launches, CLI train: " + ", ".join(f"{c.__name__} {n}" for c, n in got.items()))
        for c, n in got.items():
            want = steps if c is k4["_counter"] else 0
            if n != want:
                raise AssertionError(f"[cli] train: {c.__name__} launched {n} times in {steps} "
                                     f"steps, want {want}")
        ckpt = tmp / "run" / "model" / "model.ckpt"
        if not ckpt.is_file():
            raise AssertionError(f"[cli] train left no {ckpt}")
        log(f"[cli] train {CLI_EPOCHS} epochs of {steps // CLI_EPOCHS} steps of {TRAIN_BATCH} "
            f"(Unet({N_FILTER}), {TILE}², bf16, resident, K4): CLI {t_cli_train:.2f} s, "
            f"facade (run first) {t_facade_train:.2f} s (DataProcess included in both)")

        # predict: the family read from the checkpoint; [main]'s movie as a TIFF
        movie = np.random.default_rng(0).integers(0, 255, (FRAMES, H, W), dtype=np.uint8)
        src = tmp / "movie.tif"
        tiff.imwrite(str(src), movie)
        chunks = FRAMES // CHUNK
        expect = {hist.int_clip_bounds: hist.LAUNCHES[torch.uint8] * chunks,
                  normalize_tile: chunks, sigmoid_stitch: chunks}
        args = ["--resize-dim", str(TILE), str(TILE), "--half-precision"]

        def cli_predict(out):
            if cli(["predict", "--input", str(src), "--output", str(out), "--checkpoint",
                    str(ckpt)] + args) != 0:
                raise AssertionError("[cli] predict exited non-zero")

        def facade_predict(out):
            unet.Predict(str(src), str(out), str(ckpt), resize_dim=(TILE, TILE),
                         show_progress=True, batch_size=8, half_precision=True)

        times = {"CLI": float("inf"), "facade": float("inf")}
        for _ in range(2):
            for who, fn in (("CLI", cli_predict), ("facade", facade_predict)):
                t0 = time.perf_counter()
                counted(torch, "cli", counters, f"{who} predict", lambda: fn(tmp / f"{who}.tif"),
                        expect)
                times[who] = min(times[who], time.perf_counter() - t0)
        ours, ref = tiff.imread(str(tmp / "CLI.tif")), tiff.imread(str(tmp / "facade.tif"))
        if ours.shape != movie.shape or not np.isfinite(ours.astype(np.float32)).all():
            raise AssertionError(f"[cli] predict wrote {ours.shape} {ours.dtype}")
        if ours.dtype != ref.dtype or not np.array_equal(ours, ref):
            diff = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
            raise AssertionError(f"[cli] the CLI's mask differs from the facade's (max "
                                 f"{diff.max()} levels on {np.mean(diff > 0):.6f})")
        log(f"[cli] predict {FRAMES}×{H}×{W} uint8 TIFF → {ours.dtype} TIFF, {TILE}², bf16 "
            f"(best of 2, file read and write included): CLI {times['CLI']:.3f} s, facade "
            f"{times['facade']:.3f} s, CLI / facade {times['CLI'] / times['facade']:.3f}; "
            f"masks byte-equal")

        # the -m entry in processes of their own
        out = run_module("cli", ["devices"], timeout=180)
        if kind not in out:
            raise AssertionError(f"[cli] `devices` does not name the card {kind!r}: {out!r}")
        log("[cli] `devices`: " + " | ".join(out.strip().splitlines()))
        small = tmp / "movie16.tif"
        tiff.imwrite(str(small), movie[:CHUNK])
        in_process, spawned = tmp / "in_process16.tif", tmp / "spawned16.tif"
        if cli(["predict", "--input", str(small), "--output", str(in_process), "--checkpoint",
                str(ckpt)] + args) != 0:
            raise AssertionError("[cli] predict exited non-zero")
        run_module("cli", ["predict", "--input", str(small), "--output", str(spawned),
                           "--checkpoint", str(ckpt)] + args, timeout=600)
        a, b = tiff.imread(str(in_process)), tiff.imread(str(spawned))
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError("[cli] the subprocess's 16-frame mask differs from the "
                                 "in-process CLI's")
        log(f"[cli] subprocess predict of {CHUNK} frames: mask equal to the in-process CLI's")


def phase_recipes(torch) -> None:
    from bio_image_unet_tpu_torch.data import tiff
    from bio_image_unet_tpu_torch.utils import test as recipes

    with tempfile.TemporaryDirectory() as tmp:
        seconds = {}
        for family in ("unet", "siam_unet", "unet3d", "multi_output_unet",
                       "multi_output_unet3d"):
            t0 = time.perf_counter()
            base = recipes.__dict__[f"test_{family}"](base_dir=str(Path(tmp) / family))
            torch.cuda.synchronize()
            seconds[family] = time.perf_counter() - t0
            if not (Path(base) / "out" / "model.ckpt").is_file():
                raise AssertionError(f"[recipes] {family} left no out/model.ckpt")
            preds = [p for p in (Path(base) / "pred.tif", Path(base) / "results") if p.exists()]
            files = [f for p in preds for f in ([p] if p.is_file() else sorted(p.iterdir()))]
            if not files:
                raise AssertionError(f"[recipes] {family}: its model.ckpt predicted nothing")
            for f in files:
                if not np.isfinite(tiff.imread(str(f)).astype(np.float32)).all():
                    raise AssertionError(f"[recipes] {family}: {f.name} is not finite")
            recipes.delete_folder_with_retry(base)
        log("[recipes] the five recipes at their defaults (4 epochs, n_filter 8, 64²) on the "
            "card, each out/model.ckpt predicted: "
            + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items())
            + f"; total {sum(seconds.values()):.2f} s")

        try:
            from PIL import Image
        except ImportError:
            log("[recipes] PIL is absent: png_to_grayscale_tiff not run")
            return
        from bio_image_unet_tpu_torch.utils import png_to_grayscale_tiff

        rgb = np.random.default_rng(4).integers(0, 200, (20, 30, 3), dtype=np.uint8)
        Image.fromarray(rgb).save(Path(tmp) / "c.png")
        png_to_grayscale_tiff(str(Path(tmp) / "c.png"), str(Path(tmp) / "c.tif"))
        gray = tiff.imread(str(Path(tmp) / "c.tif"))
        if gray.shape != (20, 30) or gray.dtype != np.uint8 or gray.max() != 255:
            raise AssertionError(f"[recipes] png_to_grayscale_tiff gave {gray.shape} {gray.dtype}")
        log("[recipes] png_to_grayscale_tiff: (20, 30) uint8, max 255")


def phase_histogram_oracle(torch, dev) -> None:
    """B3 on the card against K1, bit for bit, each timed by ``Timer``."""
    from bio_image_unet_tpu_torch.ops import histogram as hist
    from bio_image_unet_tpu_torch.utils.kernel_ab_times import microscopy_frames

    timer = Timer(torch, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    qs = (0.0, 99.8)
    frames = {
        # [kernels]'s uint8 chunk: the same generator, seed and first draw
        "uniform": torch.randint(0, 256, (CHUNK, H, W), generator=g, device=dev,
                                 dtype=torch.int32).to(torch.uint8),
        "skewed": torch.from_numpy(microscopy_frames(301, CHUNK, H)[0]).to(dev),
    }
    for name, x in frames.items():
        oracle = torch.stack(hist.u8_clip_bounds(x, *qs))
        k1 = hist.int_clip_bounds(x, *qs)
        torch.cuda.synchronize()
        if not torch.equal(oracle.view(torch.int32), k1.view(torch.int32)):
            raise AssertionError(f"[histogram oracle] {name}: u8_clip_bounds "
                                 f"{oracle.tolist()} != K1 {k1.tolist()}")
        log(f"[histogram oracle] {name} uint8 {CHUNK}×{H}×{W}: u8_clip_bounds bit-equal to K1; "
            f"oracle {timer(lambda: hist.u8_clip_bounds(x, *qs), 5):.4f} ms, K1 "
            f"{timer(lambda: hist.int_clip_bounds(x, *qs)):.4f} ms")



# --- 36. mesh -------------------------------------------------------------------

# the whole volume of [mesh]'s predict_volume_spatial_sharded
SHARDED_VOLUME = (32, 512, 512)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def best_of(n: int, call) -> tuple:
    """``call()`` ``n`` times: (its last result, the best wall time)."""
    best, out = float("inf"), None
    for _ in range(n):
        t0 = time.perf_counter()
        out = call()
        best = min(best, time.perf_counter() - t0)
    return out, best


def phase_mesh(torch, dev, kernels) -> None:
    """Multi-device on one card: NCCL at a world of one, every mesh path
    against ``mesh=None``."""
    import torch.distributed as dist

    from bio_image_unet_tpu_torch import siam_unet, unet
    from bio_image_unet_tpu_torch.data import tiff
    from bio_image_unet_tpu_torch.ops import histogram as hist
    from bio_image_unet_tpu_torch.ops.stitch import sigmoid_stitch
    from bio_image_unet_tpu_torch.parallel import get_mesh, initialize_distributed
    from bio_image_unet_tpu_torch.predict import (Predict3D, PredictMultiOutput,
                                                  PredictMultiOutput3D,
                                                  predict_frames_spatial_sharded,
                                                  predict_volume_spatial_sharded)
    from bio_image_unet_tpu_torch.predict.normalize import _normalize_stack, normalize_tile
    from bio_image_unet_tpu_torch.predict.sharded import _quantize, _resolve_forward

    counters = list({id(k["_counter"]): k["_counter"] for k in kernels}.values())
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # the Trainer's mesh=None takes the default mesh of a process group
        # once there is one: its plain run comes first
        data = config2_data(tmp / "train")
        plain = _mesh_train_run(torch, data, tmp / "train_plain", {})
        t0 = time.perf_counter()
        initialize_distributed(backend="nccl", rank=0, world_size=1,
                               init_method=f"tcp://127.0.0.1:{_free_port()}")
        try:
            mesh = get_mesh()
            log(f"[mesh] NCCL world of 1 and its mesh {mesh.shape} in "
                f"{time.perf_counter() - t0:.3f} s (init_process_group, new_group × 2)")
            _mesh_predict(torch, tmp, mesh, counters, unet, hist, normalize_tile, sigmoid_stitch)
            _mesh_train(torch, data, tmp, mesh, plain)
            _mesh_sharded(torch, dev, tmp, mesh, predict_frames_spatial_sharded,
                          predict_volume_spatial_sharded, _normalize_stack, _quantize,
                          _resolve_forward)
            _mesh_classes(torch, tmp, mesh, PredictMultiOutput, siam_unet, tiff, Predict3D,
                          PredictMultiOutput3D)
        finally:
            dist.destroy_process_group()


def _mesh_predict(torch, tmp, mesh, counters, unet, hist, normalize_tile, sigmoid_stitch):
    """``[main]``'s call with and without the mesh, float and int8."""
    movie = np.random.default_rng(0).integers(0, 255, (FRAMES, H, W), dtype=np.uint8)
    ckpt = str(tmp / "unet_nf32.pt")
    write_checkpoint(torch, ckpt, "Unet", N_FILTER, out_channels=1)
    kw = dict(resize_dim=(TILE, TILE), show_progress=False, batch_size=8, half_precision=True)
    chunks = FRAMES // CHUNK
    expect = {hist.int_clip_bounds: hist.LAUNCHES[torch.uint8] * chunks,
              normalize_tile: chunks, sigmoid_stitch: chunks}
    plain, t_plain = best_of(3, lambda: unet.Predict(movie, None, ckpt, **kw).result)
    meshed, _ = counted(torch, "mesh", counters, "unet.Predict(mesh=get_mesh())",
                        lambda: unet.Predict(movie, None, ckpt, mesh=mesh, **kw).result, expect)
    meshed, t_mesh = best_of(2, lambda: unet.Predict(movie, None, ckpt, mesh=mesh, **kw).result)
    if not np.array_equal(meshed, plain):
        raise AssertionError("[mesh] Predict(mesh=get_mesh()) differs from mesh=None")
    log(f"[mesh] unet.Predict {FRAMES}×{H}×{W} uint8, {TILE}², bf16: mesh=get_mesh() "
        f"byte-equal to mesh=None; {t_mesh:.3f} s against {t_plain:.3f} s "
        f"({t_mesh / t_plain:.3f}×; {FRAMES * H * W / 1e6 / t_mesh:.2f} against "
        f"{FRAMES * H * W / 1e6 / t_plain:.2f} MP/s end to end)")
    q_plain, tq_plain = best_of(2, lambda: unet.Predict(movie, None, ckpt, quantized=True,
                                                        **kw).result)
    q_mesh, tq_mesh = best_of(2, lambda: unet.Predict(movie, None, ckpt, quantized=True,
                                                      mesh=mesh, **kw).result)
    if not np.array_equal(q_mesh, q_plain):
        raise AssertionError("[mesh] int8 Predict(mesh=get_mesh()) differs from mesh=None")
    log(f"[mesh] unet.Predict(quantized=True): mesh=get_mesh() byte-equal to mesh=None; "
        f"{tq_mesh:.3f} s against {tq_plain:.3f} s")


def _mesh_train_run(torch, data, out: Path, kw: dict) -> tuple:
    """Config 2's Trainer for 2 epochs: its rows and its warm step's ms."""
    steps = (len(data) - int(np.ceil(len(data) * 0.2))) // TRAIN_BATCH
    t = config2_trainer(data, out, 2, **kw)
    t.start()
    torch.cuda.synchronize()
    return metrics_rows(out), t.history[-1]["train_seconds"] / steps * 1e3


def _mesh_batchnorm(torch, mesh):
    """``CrossRankBatchNorm`` on the card at the world of one against
    ``nn.BatchNorm2d`` (cuDNN) on config 2's first BatchNorm input: forward,
    input and affine gradients and running statistics within float32
    rounding (1e-5 of each one's largest value)."""
    from bio_image_unet_tpu_torch.parallel.batchnorm import CrossRankBatchNorm

    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (TRAIN_BATCH, N_FILTER, TILE, TILE)
    x, dy = (torch.randn(shape, generator=gen, device="cuda").contiguous(
        memory_format=torch.channels_last) for _ in range(2))
    x = x * 2 + 0.5
    w = torch.rand(N_FILTER, generator=gen, device="cuda") + 0.5
    b = torch.randn(N_FILTER, generator=gen, device="cuda")
    outs = []
    for cross in (False, True):
        bn = torch.nn.BatchNorm2d(N_FILTER).cuda().train()
        with torch.no_grad():
            bn.weight.copy_(w)
            bn.bias.copy_(b)
        if cross:
            bn = CrossRankBatchNorm(bn, mesh.group("data"))
        xi = x.clone().requires_grad_()
        y = bn(xi)
        y.backward(dy)
        outs.append({"y": y, "dx": xi.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
                     "running_mean": bn.running_mean, "running_var": bn.running_var})
    worst = {}
    for k, ref in outs[0].items():
        # normwise: the largest difference over the largest value (a sum of
        # 786k float32 terms moves its own last bits with the order)
        worst[k] = float((outs[1][k] - ref).abs().max() / ref.abs().max())
        if worst[k] > 1e-5:
            raise AssertionError(f"[mesh] CrossRankBatchNorm {k} beyond 1e-5 of "
                                 f"nn.BatchNorm2d's largest value: {worst[k]:.2e}")
    log(f"[mesh] CrossRankBatchNorm (NCCL, world of one) against nn.BatchNorm2d (cuDNN) on "
        f"{shape} float32 channels_last: largest difference over the largest value "
        + ", ".join(f"{k} {v:.1e}" for k, v in worst.items()) + " (≤ 1e-5)")


def _mesh_train(torch, data, tmp, mesh, plain):
    """Config 2's Trainer with the mesh (both cache modes) against its plain
    run (``plain``: made before the process group).  The rows are held to
    rtol 1e-3, the contract of a bf16 run computed another way (``[train
    options]``' remat, card against CPU): at the world of one the
    replicated layout runs the cross-rank BatchNorm in place of cuDNN's,
    and a last-bit change of a statistic moves bf16 roundings downstream."""
    _mesh_batchnorm(torch, mesh)
    runs = {"mesh=None": plain}
    for name, kw in (("mesh=get_mesh(), device_cache=True", {"mesh": mesh}),
                     ("mesh=get_mesh(), device_cache='sharded'",
                      {"mesh": mesh, "device_cache": "sharded"})):
        runs[name] = _mesh_train_run(torch, data, tmp / f"train_{len(runs)}", kw)
    ref, ref_ms = plain
    for name, (rows, ms) in runs.items():
        rel = np.abs(rows[:, 1:3] - ref[:, 1:3]) / np.abs(ref[:, 1:3])
        log(f"[mesh] Trainer {name}: losses {rows[:, 1:3].round(6).tolist()}, max relative "
            f"difference from mesh=None {rel.max():.2e}; warm step {ms:.2f} ms "
            f"({ms / ref_ms:.3f}× mesh=None's)")
        if rel.max() > 1e-3:
            raise AssertionError(f"[mesh] Trainer {name}: metrics.csv beyond rtol 1e-3 of "
                                 "mesh=None")


def _mesh_sharded(torch, dev, tmp, mesh, frames_fn, volume_fn, normalize, quantize, resolve):
    """The whole-frame sharded predictors against the unsharded folded
    forward on the same input, rows past the halo: in bf16 (the main path's
    ``Unet(32)`` and ``UNet3D(32)``; cuDNN picks its algorithms by shape, and
    the halo-padded input is taller, so bf16 roundings move: JAX's bf16
    fused-vs-host contract, < 1% beyond one level, at most 16) and in float32
    with TF32 off (within one level on ≤ 0.1%)."""
    def interior(tag, got, ref, halo, bf16):
        diff = np.abs(got[:, halo:-halo].astype(np.int16) - ref[:, halo:-halo].astype(np.int16))
        beyond = float(np.mean(diff > 1))
        log(f"[mesh] {tag}: rows past the halo against the unsharded folded forward: "
            f"{np.count_nonzero(diff) / diff.size:.6f} of the values differ, "
            f"{beyond:.6f} by more than one level, max {int(diff.max())}")
        ok = (beyond < 0.01 and diff.max() <= 16) if bf16 else \
            (diff.max() <= 1 and np.mean(diff > 0) <= 1e-3)
        if not ok:
            raise AssertionError(f"[mesh] {tag}: beyond the contract of the unsharded forward")

    def check(tag, fn, ckpt, x, halo, frames, bf16):
        got, dt = best_of(2, lambda: fn(x, ckpt, mesh, halo=halo, half_precision=bf16))
        _, fwd = resolve(ckpt, None, bf16, dev)
        if frames:
            norm = normalize(x, "single", (0.0, 99.8)).astype(np.uint8)[:, None]
        else:
            norm = normalize(x[None], "all", (0.0, 99.8))[0].astype(np.uint8)[None, None]
        ref = quantize(fwd(torch.from_numpy(norm.astype(np.float32) / 255.0).to(dev)))
        ref = ref[:, 0] if frames else ref[0, 0]
        interior(f"{tag}, halo {halo}, {'bf16' if bf16 else 'float32'}, {dt:.3f} s", got, ref,
                 halo, bf16)

    rng = np.random.default_rng(1)
    frames = rng.integers(0, 255, (CHUNK, H, W), dtype=np.uint8)
    vol = rng.integers(0, 255, SHARDED_VOLUME, dtype=np.uint8)
    ckpt, ck3 = str(tmp / "unet_nf32_sharded.pt"), str(tmp / "unet3d_nf32.pt")
    write_checkpoint(torch, ckpt, "Unet", N_FILTER, out_channels=1)
    write_checkpoint(torch, ck3, "UNet3D", VOL_FILTER, seed=5)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for bf16 in (True, False):
            n = CHUNK if bf16 else 4
            check(f"predict_frames_spatial_sharded {n}×{H}×{W} Unet({N_FILTER})", frames_fn,
                  ckpt, frames[:n], 128, True, bf16)
            check(f"predict_volume_spatial_sharded {SHARDED_VOLUME} UNet3D({VOL_FILTER})",
                  volume_fn, ck3, vol, 64, False, bf16)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _mesh_classes(torch, tmp, mesh, PredictMultiOutput, siam_unet, tiff, Predict3D,
                  PredictMultiOutput3D):
    """The other four Predict classes at smaller depths of their phases'
    shapes, each with the mesh equal to without."""
    rng = np.random.default_rng(2)

    def same(tag, a, b):
        for key in (a if isinstance(a, dict) else [None]):
            x, y = (a, b) if key is None else (a[key], b[key])
            if not np.array_equal(x, y):
                raise AssertionError(f"[mesh] {tag}{'' if key is None else ' ' + key}: "
                                     "mesh=get_mesh() differs from mesh=None")
        log(f"[mesh] {tag}: mesh=get_mesh() equal to mesh=None")

    nested = str(tmp / "nested.pt")
    write_checkpoint(torch, nested, "MultiOutputNestedUNet", HEADS_FILTER, output_heads=MO_HEADS)
    movie = rng.integers(0, 255, (CHUNK, H, W), dtype=np.uint8)
    kw = dict(max_patch_size=(HEADS_PATCH, HEADS_PATCH), safe_margin=HEADS_MARGIN,
              half_precision=True, show_progress=False)
    same(f"PredictMultiOutput UNet++({HEADS_FILTER}) {CHUNK}×{H}×{W}",
         PredictMultiOutput(movie, nested, mesh=mesh, **kw).result,
         PredictMultiOutput(movie, nested, **kw).result)

    siam = str(tmp / "siam.pt")
    write_checkpoint(torch, siam, "Siam_UNet", SIAM_FILTER, seed=20, mode="max")
    src = str(tmp / "siam.tif")
    tiff.imwrite(src, rng.integers(0, 255, (SIAM_CHUNK, H, W), dtype=np.uint8))
    skw = dict(resize_dim=(TILE, TILE), half_precision=True, show_progress=False,
               frames_per_chunk=SIAM_CHUNK)
    siam_unet.Predict(src, str(tmp / "siam_mesh.tif"), siam, mesh=mesh, **skw)
    siam_unet.Predict(src, str(tmp / "siam_plain.tif"), siam, **skw)
    same(f"siam_unet.Predict Siam_UNet({SIAM_FILTER}, max) {SIAM_CHUNK}×{H}×{W}",
         tiff.imread(str(tmp / "siam_mesh.tif")), tiff.imread(str(tmp / "siam_plain.tif")))

    ck3 = str(tmp / "unet3d_classes.pt")
    write_checkpoint(torch, ck3, "UNet3D", VOL_FILTER, seed=5)
    vol = rng.integers(0, 255, (VOL_D, VOL_H, VOL_W), dtype=np.uint8)
    vkw = dict(resize_dim=VOL_TILE, batch_size=VOL_BATCH, half_precision=True,
               show_progress=False)
    same(f"Predict3D UNet3D({VOL_FILTER}) {VOL_D}×{VOL_H}×{VOL_W}",
         Predict3D(vol, None, ck3, mesh=mesh, **vkw).result,
         Predict3D(vol, None, ck3, **vkw).result)

    mo3 = str(tmp / "mo3d.pt")
    write_checkpoint(torch, mo3, "MultiOutputUnet3D", VOL_FILTER, seed=8, output_heads=MO_HEADS)
    vols = rng.integers(0, 255, (2, VOL_D, VOL_H, VOL_W), dtype=np.uint8)
    hkw = dict(half_precision=True, show_progress=False)
    same(f"PredictMultiOutput3D MultiOutputUnet3D({VOL_FILTER}) 2×{VOL_D}×{VOL_H}×{VOL_W}",
         PredictMultiOutput3D(vols, mo3, mesh=mesh, **hkw).result,
         PredictMultiOutput3D(vols, mo3, **hkw).result)


if __name__ == "__main__":
    sys.exit(main())
