#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (acn_tpu_torch) on one CUDA card.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --profile DIR   # also profile one dense, routed
                                          # and baked frame, and one budget,
                                          # stratified and strided step each,
                                          # tables in DIR

Phases, each printing one JSON line and each fatal on failure:

1. device: the card (``nvidia-smi`` name and power limit) and the build of
   the CUDA kernel libraries from the sources in ``acn_tpu_torch/csrc``
   (``segscan.cu``, ``composite.cu``, ``hashgrid.cu``, ``ngp_net.cu``: one
   ``nvcc`` a library, started together); phases 2, 17 and 14, which need
   only the scan's, the composite's and the hash encode's libraries, run in
   that order as soon as theirs is built, while the network's compiles,
   and the rest after it (the phases keep their numbers);
2. kernel: each kernel against its plain PyTorch version on the card, on
   edge cases and at the serving shape, forward, backward through autograd
   and the reverse kernel directly, on an unaligned view, on two streams at
   once and across the wrap of its launch epoch, with times (CUDA events)
   beside the least time the card could take, and a sweep of sizes; and
   the scan's second derivative (second-order MAML) at B = 32,768: forward
   kernel, reverse kernel as its backward, forward kernel as the reverse
   one's backward, 2 + 1 launches, against the plain versions;
3. main path: full 1080×1920 frames of the ``configs/train_occ.json`` model
   (random weights from a seed) through ``Renderer.render_image``, with the
   composite kernel's launch count held to chunks × frames (neither scan
   kernel runs: the composite scans the transmittance itself) and the
   host's waits for the card in one frame (PyTorch's sync debug mode) held
   below one per chunk;
4. main path vs CPU: ``render_rays`` on the card (kernels) against
   ``render_rays`` on the CPU (plain versions) on 2,048 rays of that frame, at
   the config's alpha threshold and at alpha threshold 0 with the σ-head
   bias raised to +2 (so the scan sees opaque samples);
5. train step: four FoMAML meta-training steps (one warm, three timed) of
   that model through ``make_meta_train_step`` in the packed-budget regime,
   bf16 compute, 3 tasks of 1,024 support and 512 query rays per expert,
   draws from a seeded generator on the card; every metric finite, every parameter
   moved, the optimizer's count at 4, and the composite's forward and
   backward kernels each launched K·T·(inner_iter + 1) = 108 times per step
   and the scan's never (every loss composites in the kernels); the
   host's waits for the card in one step; the scan's kernels against their
   plain versions, and timed, on the segments of a real support and query
   march (B = 32,768 and 16,384); one episode's loss and gradient on the
   card (kernels) against the CPU (plain versions) in float32, at the
   tolerances of ``check_card_vs_cpu_f32``; and that episode in
   bf16, as the step runs it, on the card against the CPU and against
   float32 on the card (loss, and each parameter group's gradient as one
   vector, in length and direction);
6. the regime schedule of a run of ``configs/train_occ.json``, at full
   width (K 4, T 3, S 1,024, Q 512, 8 inner steps, bf16, 256 bins, 64 kept
   samples, 128³ grids), on a fresh model (seed 1): (a) two stratified
   steps (96 samples per ray); (b) two passes of the all-expert occupancy
   update built from that model, each checked against its own EMA and
   threshold, and one expert's update at 32³ (hash features scaled so
   that σ varies over the grid) on the card against the CPU with the same
   injected jitter, for each of four jitter draws; (c) five strided steps on 10 % random grids
   (``bench.py``'s "auto" regime) with ``report_budget`` 32, 2, 32, 32, 32,
   whose would-be overflows feed ``AutoRegime``: the overflowing reading
   at budget 2 restarts its count and it must fire on the fifth; one
   strided step on the updated grids, the budget step after the switch,
   and one float32 strided episode on the card against the CPU; (d) the
   budget-0 renderer (strided march, ``render_rays_occ``): ``render_rays``
   on the card against the CPU, a warm 1080p frame and a timed one. The
   stratified and strided steps and the budget-0 renderer must launch no
   scan or composite kernel; the budget step after the switch the
   composite's kernels 108 times each way and no scan;
7. the training loop, ``meta_trainer``, at full width on a synthetic
   dataset: per expert 8 cameras of 192 × 256 pixels over its quadrant
   (``toy.camera_ray_stores``, 393,216 rays; 32 cameras before, cut for
   the smoke's time), routed to 5 × 5 micro-cells,
   sampled on the card (``make_device_batch_fn`` over the pools of
   ``build_device_pools``), grids premarked from the same cameras; a model
   whose density varies over the grid (``LOOP_*``); the schedule cut to 12
   steps (warm-up 3, update every 2, the switch after 2 readings, eval every
   4 on one test task, a step save every 6), then a resume from ``step6``
   for two steps. It fails unless the steps run stratified, strided, then
   budget after the switch, with no scan or composite launch in the first
   two and 108 + 108 composite launches and no scan in each budget step
   (the eval renders stratified); the card's sampler gives the CPU's ids on the
   same draws and never a padded ray, support and query apart; ``best``,
   ``step6``, ``step12`` and ``last`` are written, and ``best``, ``step6``
   and ``last`` reload bit for bit (``last`` equal to the run's end); the
   resumed run
   starts from step 6's state (best, optimizer count, grids, regime), and
   its non-log step waits for the card no more often than phase 5's bare
   step; every metric finite;
8. the runner on a dataset on disk, at ``configs/train_occ.json``'s width:
   (a) ``toy.write_dataset_dir`` writes 16 train (32 before; cut for the
   smoke's time) and 8 val views of
   192 × 256 over the 4 quadrants (PNGs, zipped masks) into
   ``logs/chip_smoke_runner/``; (b) ``runner.main`` runs ``--op train`` with
   ``configs/train_occ.json`` cut to 6 steps (8 before; cut for the smoke's
   time; its ray stores built in-process, ``--num_workers 1``: a process
   pool spawned for each expert's images cost ≈ 50 s) (warm-up 2, the switch after 1
   reading, eval and save every 4, the grids rebuilt every 2 steps: the
   runner's update interval is patched, it has no flag), building the ray
   stores and routes afresh; it fails unless the run trains stratified,
   then packed-budget after the switch, every budget step launching 108 +
   108 composites and no scan and no other step either, and ``last`` and
   ``step4`` carry grids
   and optimizer; (c) ``--op eval --configPath configs/eval.json --prefix
   last --tto 0,2,0 --test_batch_size 4`` on that run: the composite kernel
   launched once per chunk of every frame (chunks × 8 views × 3 settings)
   and the scan never, PSNR and SSIM finite with SSIM in [-1, 1], the
   TTO losses finite, and the two ``tto=0`` legs' scores bit-equal (the base
   weights are restored between settings); (d) card against CPU: one
   float32 TTO step of ``last`` on 1,024 rays with injected draws (loss,
   gradient, parameters), SSIM and LPIPS (fallback weights) of one
   rendered view, and SSIM of a nearly constant image against itself;
9. serving beyond the dense frame, at ``configs/train_occ.json``'s width on
   phase 3's model and grids (σ-head bias +2, as phase 4 leaves it) and
   phase 8's run (its directory removed at the end): (a) 1080p routed frames (``render_image_routed``, the 4
   quadrant experts' rects): one warm, two timed, one downloaded, the
   composite kernel launched once per dispatched chunk and the scan never;
   with every expert set to expert 0's weights, box and grid, the routed
   frame equals the dense ``render_image`` one within 0.02 in rgb and acc
   (the tolerances of ``tests/test_renderer_routed.py:50-68``); a 64 × 96
   routed frame on the card against the CPU (u8 rgb within 1/255, f16
   depth/acc rtol 1e-3); (b) ``render_image(active_module=k)`` per expert
   at budget 32 (a composite launch per chunk), budget 0 (none) and with
   ``occ_render_s_coarse`` 32, and the range pre-pass's mean kept share of
   each ray; (c) ``--op bake`` of phase 8's ``last`` at ``--bake_resolution
   256`` (the flag's default 512 cut for time), timed; ``load_baked`` gives
   back the table and grid bit for bit; ``bake_field`` at 24³ (chunk 24³)
   with SH 0 and SH 1 on the card against the CPU, f32 atol 1e-5 / rtol
   1e-5; (d) 1080p ``BakedRenderer`` frames at budget 24, with the range
   pre-pass of 32 bins, and at budget 0 (a composite launch per chunk, none
   at 0, no scan); a
   64 × 96 baked frame on the card against the CPU; (e) ``--op eval
   --baked_asset --tto 0,2``: finite PSNR and SSIM, the ``tto=2`` leg
   rendered without adaptation (``acn_tpu``'s log line) and scored as
   ``tto=0`` within 1e-3 dB and 1e-4 SSIM per view, the difference printed
   (expected 0: the composite kernel sums in one fixed order, where the
   ``index_add_`` before it added with atomics), composite launches as the
   merged ``occ_budget_per_ray`` says; (f) ``--op
   video --video_frames 4`` (8 before, cut for the smoke's time), live and
   baked: a file of 4 frames, the
   encoder named, a composite launch per chunk per frame on budget paths;
10. M9 at ``configs/train_occ.json``'s width (K 4, T 3, S 1,024, Q 512, 8
   inner steps, bf16, budget 32) on phase 3's model and grids, draws from a
   seeded generator: (a) second-order MAML, a warm and a timed step (two
   timed before; cut for the smoke's time),
   each launching the composite's forward and backward kernels K·T·(inner_iter
   + 1) = 108 times each (each inner step's ``create_graph`` backward
   differentiates the plain composition again; the outer gradient reaches
   every loss's output through its cotangent), and the scan 2·K·T·inner_iter
   = 192 times forward and 192 reverse (none would mean the double backward
   never ran), every group moved, the peak
   memory; one float32 episode (inner 2, 256 rays) on the
   card against the CPU, and its gradient farther from FoMAML's than from
   the CPU's; (b) Reptile: no scan, 108 composite forward launches and 96
   backward (its K·T = 12 query losses are not differentiated), the
   optimizer untouched,
   expert 0 moved by P.lr·mean(fast − θ) against a recomputation with the
   same salts, within a limit that two planted faults (Σ not divided by T,
   the last task alone) exceed; (c) FoMAML with ``--fim``: 108 + 108
   composites and no scan, the Fisher state of an episode finite; (d)
   ``train_chunk_rays`` 256 on the budget config: no scan or composite
   (each chunk marches strided, as in ``acn_tpu``); (e) AdamW and SGD,
   a step each, the checkpoint reloaded bit for bit; (f) the vanilla expert
   at the runner's width (hidden 256, depth 8): a budget step,
   ``render_rays`` on the card against the CPU, one occupancy update pass;
   (g) the corner layout at L16 F2: a budget step, the encode and its
   table gradient on the card against the CPU;
11. the (expert × data) mesh (``acn_tpu_torch.parallel``) at
   ``configs/train_occ.json``'s width on phase 5's step and phase 3's model
   and frame: (a) one rank over NCCL through a one-rank ``Mesh``: two plain
   budget steps from one state (their distance is what the card's atomic
   sums give), then a warm and a timed sharded step (two timed before; cut
   for the smoke's time), 108 + 108 composites and no scan each; the first lies no farther from the first plain step than
   ``MESH_FACTOR`` × the two plain steps' distance (floors ``MESH_FLOOR``,
   ``MESH_LOSS_FLOOR``), per parameter group, in loss and in gradient
   norm, and two planted faults (draws keyed one expert off, the task
   mean's 1/T lost) must fail that bound; a 1080p frame through the
   fan-out (a composite launch a chunk) against the plain frame within one
   u8 step, both timed in
   turns; (b) two spawned ranks sharing the card over gloo, E = 2: a warm
   and a timed sharded step (two timed before), each rank launching 54 +
   54 composites and no scan a step (summed over the ranks: 108 + 108); the first step against (a)'s first
   within the same bound around it, and two planted faults (the world's
   all-reduces skipped; rank 1's draws keyed by its local expert) must fail
   it; a 1080p frame by row blocks against (a)'s plain frame within one u8
   step, and a 64 × 96 baked frame against one rank's; two ranks on one
   card show correctness, not a scaling number; (c) ``python -m
   acn_tpu_torch --op train --mesh_experts 2 --num_processes 2`` as two
   processes (a TCP rendezvous on localhost) on a small dataset from
   ``toy.write_dataset_dir``, 3 steps through the regime switch (4 before,
   cut for the smoke's time): step lines
   from rank 0 only, one ``last``, which the single-process port restores
   with every key and shape; ms per step and per frame, collectives and
   their bytes per step, and the card's name and power limit, printed;
12. live runtime adaptation (``acn_tpu_torch.viewer``) at
   ``configs/train_occ.json``'s width (K 4, budget 32) from phase 8's
   ``last`` and phase 9's baked table: (a) ``build_context(P, "view")`` of
   ``configs/view.json`` and a ``Controller``; 480 × 853 previews (the size
   the viewer renders) through ``render_frame`` at preview and at full
   samples in rgb, depth and opacity, each launching the composite kernel
   once per chunk and no scan, and one from the baked table; (b) a continual batch of 8 views
   of 192 × 256 (``toy.write_continual_batch``, PNG, ``update_dataset.py``'s
   layout) that ``verify_continual_batch_dir`` accepts; (c)
   ``set_mode("runtime_adapt")`` and ``start(target_steps=16)``, previews
   rendered from the main thread while the loop thread steps (at least 4:
   the loop pauses itself 4 steps ahead of the frames, each frame resumes
   it),
   each frame's leased snapshot checksummed before and after it (bit-equal:
   no torn frame), more than one snapshot seen; the 16 losses finite, PSNR
   over 8,192 of the batch's rays higher after the 16 steps than before; a
   second, sequential run of 16 steps from the same seed with no frames
   within ``LIVE_PSNR_ATOL`` dB per step, its steps launching no scan; (d)
   ``reset_fast`` gives back the checkpoint's bits, and a runtime checkpoint
   saved and loaded gives back the saved bits; (e) ``MetaTrainRunner`` on
   a train context's sampler, 2 steps, stratified as ``acn_tpu``'s runner
   builds its step (no scan); (f) preview ms idle and during training, TTO
   step ms alone and during frames, snapshot publish ms, the phase's
   seconds, with the card's name and power limit;
13. the host tooling (``acn_tpu_torch/scripts``, ``acn_tpu_torch/ops``) at
   the reference scene's width (the drz set: 2048 × 1536 views, 4 experts in a
   2 × 2 grid, boundary margin 1.1): (a) ``create_clusters`` (256 samples
   per ray, ``--center_pixels --scene_scale 1.1``) routes 4 + 2 views of
   2048 × 1536 (16 + 4 before; cut for the smoke's time) over the 4 quadrants (``toy.write_dataset_dir``'s cameras,
   metadata at that size beside 64 × 48 PNGs) on the card: every image has a
   mask per expert, every expert a sample and a box inside the global box;
   ms per image, its host share (ray generation, zipping) and the time
   projected for drz's 249 images; the router with those centroids on 2 of
   the views at downscale 0.125, card against CPU: a differing ray only
   where a sample lies within 1e-5 (relative) of a boundary, counts apart by
   no more than such samples, boxes within 4 ulps of 2; (b) the same run as
   two processes sharing the card (``--rank 1`` and ``--rank 0`` of
   ``--world_size 2``), run beside (c)-(e) and read before (f): masks byte
   for byte and ``scene_boxes.pt`` equal to (a)'s; (c) ``log_mask_info`` (overlap above 0), ``log_dataset_info``
   (4 + 2 views) and ``visualize_clustering``'s arrays (the region map's 4
   cells and overlap band, one overlay), no figure drawn; (d) a ``toy`` set
   of 8 + 2 views of 96 × 128 whose masks ``create_clusters`` rewrites, then
   ``runner.main`` ``--op train`` of ``configs/train_occ.json`` for 3 steps
   (4 before, cut for the smoke's time)
   through the regime switch (K·T·(inner_iter + 1) = 108 + 108 composites
   and no scan per budget step, neither otherwise) and ``summarize_run --json`` on its
   ``log.txt``: every step and eval line parsed; (e) ``convert_reference_ckpt``
   on a reference-style state dict of a full-width corner-layout model (4
   experts, L16 F2, 2^20 rows per level): every converted leaf equal to the
   source's, and ``render_rays`` of 512 rays (2,048 before, cut for the
   smoke's time) of both on the card within
   one u8 step in rgb and 1e-5 in acc; (f) ``bench_gather_scatter`` (every
   figure with the card's name and power limit), ``bench_step_breakdown
   --iters 1 --profile`` (``bench.py``'s scale, strided: no scan) and
   ``analyze_trace`` on its trace: the categories sum to the device's busy
   time within 1 %. Its directory ``logs/chip_smoke_tools/`` is removed at
   the end;
14. the hash encode kernels (``ops/hashgrid.py``, ``csrc/hashgrid.cu``) at
   the model's width (8 levels, F = 4, 2^17 rows, dense levels: 833,403 rows
   of 32 per expert) on two point sets of ``ops/hashgrid_bench.py``:
   random points from a seed, the first on cell faces of every level and at
   1 − 1e-6, at P = 983,040 (one expert of a serving chunk), 32,768 and
   16,384 (a support and a query march), a quarter of the cotangents zero;
   and ray-ordered points, the packed samples of a budget march of the
   smoke's camera over its 10 % grids in expert 0's box (a serving chunk,
   983,040 slots, and 1,024 rays drawn from the frame, 32,768), cotangents
   zero on the pad slots. Float32 and bfloat16 each: the forward against
   its plain version (float32 within 2e-6 of the output's largest
   magnitude; bfloat16 every element within one bf16 ulp, the bit-equal
   share printed) and the table cotangent against its plain version
   (float32 within 1e-5 of the sum of its terms' magnitudes; bfloat16 per
   level no farther, in L2, from a float32-accumulated sum than 1.5× the
   plain bf16 ``index_add_``); each kernel's card time per call as a run
   of calls between one pair of CUDA events (a spin kernel first, so the
   calls run back to back; the calls cycle over copies of their inputs
   that together span 4 × the L2, so each finds its rows in device
   memory), the same for its plain version and for
   ``F.embedding_bag(mode="sum", per_sample_weights=w)`` on 8·h + c (the
   yardstick, timed only), the wrapper's host time per call (enqueue only)
   apart, beside the byte bound (each distinct byte once: x01, the distinct
   rows the points gather and the output; for the cotangent x01, g and one
   write of the tables); Nearest on a table whose row r holds 8·r + c in
   corner c, kernel equal to plain (h and the corner exact); a pad case (a
   cell of many zero-cotangent points, real points at most two to a row)
   bit-equal to plain in both types; MAML's second derivative at 32,768
   (forward, cotangent under ``create_graph``, forward on the cotangent's
   cotangent: 2 + 1 launches) against the plain
   versions. Every main path above counts the two kernels' launches from 0
   (with the scan's) and fails unless it launched the forward, and the
   cotangent exactly when it trains: the dense, routed, single-expert,
   budget-0 and mesh frames, ``--op video`` live, the occupancy update, the
   viewer's frames (forward only); the one- and two-rank mesh steps, the budget,
   stratified and strided steps, the loop, the runner's train and eval, a
   TTO step, MAML and the other cell-layout M9 steps, the viewer's TTO and
   meta-train steps, the tools' ``--op train``; and with ``--profile`` the
   frame's and the step's profiles list them;
15. the NGP network kernel (``ops/ngp_net.py``, ``csrc/ngp_net.cu``) at the
   model's width (4 experts, hash features 32, σ trunk 64 × 2, colour 64 × 2,
   SH of 4 levels; ``ops/ngp_net_bench.py``'s weights from seed 15 and
   features N(0, 1)) in all four modes (``single``, ``sigma_blend``,
   ``linear_blend``, ``density``) on random points and on the ray-ordered
   packed samples of the dense frame's budget march, at P = 983,040 (a
   dense serving chunk) and 32,768 (a support march), and ``single`` at
   4,000,000 (a routed chunk): the kernel against its plain version within
   rtol 1e-5 / atol 1e-6 of float32, every output finite; the card time
   per call of the kernel, the plain network and the chain of cuBLAS ``mm``
   calls the plain network issues in f32 and with TF32 allowed (the
   yardstick, timed only), beside the operation bound of the kernel's
   3xTF32 work (3 TF32 products for each of the multiply-adds of the (point,
   expert) pairs whose routing weight is not 0, at 495 TFLOP/s), the same
   flops on the f32 FMA pipes (67 TFLOP/s) and the byte
   bound. Every
   main path above also counts the network kernel's launches from 0 and
   fails unless a serving path (the dense, budget-0, routed,
   single-expert and mesh frames, the occupancy update, ``--op eval``,
   ``--op bake``, ``--op video`` live, the viewer's frames) launched it and
   a training step (the budget, stratified and strided steps, MAML and the
   other M9 steps, the mesh steps, a TTO step, the viewer's TTO and
   meta-train steps) did not (its network runs under autograd, or in bf16);
   the loop, the runner's and the tools' ``--op train`` (steps and
   occupancy updates) are recorded; with ``--profile`` the dense and
   routed frames' profiles give the kernel's mean time and share of busy.
   The wide path (networks above 128 wide: ``wgmma`` on 64-point tiles)
   is held in every mode within rtol 3e-4 at point counts about a tile
   and a pass (63, 64, 65, 129, 449), with an expert whose list is empty
   or one point, and at width 264 (activations spilled to the block's
   scratch), one split launch a network launch; its split kernel
   (``ngp_net.wide_split_kernel``) bit-equal to ``wide_split_plain`` and
   timed beside its byte bound; every main path counts the split
   launches (``SPLIT_BY_PATH``: one before each wide network launch, 14 a
   ``wide`` frame);
16. every expert configuration ``acn_tpu`` accepts that the kernels' first
   versions refused (``toy.FLAG_SETS``: flags over
   ``configs/train_occ.json``, random weights from seed 16): ``k25``
   (``--num_submodules 25``, ``toy.expert_layout``'s 5 × 5 grid), ``l16f8``
   (L·F 128), ``l40f3`` (40 levels of F = 3: the general hash kernels, a
   ragged level group), ``f1`` (F = 1) and ``wide`` (σ trunk 256 × 8,
   colour 128 × 5: the network kernel's wide path). Each: a warm, a timed
   and a downloaded ``Renderer.render_image`` frame at 1080 × 1920
   (``wide`` at the viewer's 480 × 853; ``k25`` at 270 × 1920, a quarter
   of the rows, cut for the smoke's time) and, for ``k25``, routed ones, the
   timed frame launching the composite kernel and the network kernel once
   and the hash forward K times (routed: once) per chunk and no scan, the
   host waiting below once
   per chunk in the third (dense: downloaded; routed: on the card, then
   one more downloaded), each downloaded frame finite; ``render_rays``
   on the card against the CPU as phase 4 holds it (on 512 rays, 2,048
   before; cut for the smoke's time); for ``l40f3`` and
   ``f1`` a warm and a timed FoMAML budget step (bf16: the hash forward
   and cotangent in training, 108 + 108 composites, no scan); ms per frame and step with
   the card's name and power limit. Phases 14 and 15 hold each kernel
   against its plain version at these configurations (the hash grids at a
   serving chunk in float32 and a support march in bfloat16, every network
   mode at a dense chunk of random points, the ``wide`` one within rtol 3e-4
   (``NET_WIDE_RTOL``)), with times, under ``flag_shapes``;
17. the packed composite kernels (``ops/composite.py``, ``csrc/composite.cu``):
   the forward against its plain version all in PyTorch (the scan's plain version, on
   the card) within rtol and atol 1e-5 on every output, every output finite
   and a second launch bit-equal, on the hand-made layouts of
   ``ops/composite_bench.py`` (rays with no samples, rays of 256 and 600
   samples, the ray overflow cuts at B and the rays dropped whole, a pad
   tail, one continuing ray 0's id, N = 1, a ragged B, unaligned strided
   views, 300 rays of 0 to 3 samples, rays of 0, 1, 31, 32, 33, 64 and 65
   samples beside empty ones, overflow cutting a ray on a step edge) at alpha threshold 0 and 0.05, with and without a background and
   the stats, and on two real chunks (a background and the stats): the
   dense frame's budget march (N = 30,720, B = 983,040) and a routed chunk
   (125,000 rays of the frame, B = 4,000,000); NaN in the dense chunk's
   pad slots changes no bit of the output; a NaN σ in a real slot of every
   1,000th ray of it makes those rays' outputs NaN (wmax too) and no
   other's, equal to the plain version on the CPU; at both chunks the card time
   per call of the kernel, the plain version, the parent's composition (the
   scan kernel and ``index_add_``) and the library chain (the scan kernel
   and ``torch.segment_reduce``, timed only), beside the byte bound of
   their real samples. The backward kernel
   against its plain version in float64 (rtol 1e-5 and an atol of 1e-5 of
   each gradient's largest magnitude, ``composite_bench.GRAD_TOL``), a
   second launch bit-equal, on every hand-made layout at alpha threshold 0
   and 0.05, with and without a background, on rgb's cotangent alone and
   on rgb's, depth's and acc's; at a training episode's support and query
   march (``configs/train_occ.json``'s 1,024 and 512 rays, B = 32,768 and
   16,384, and the reference scale's 4,000 and 2,000, B = 128,000 and
   64,000; σ and rgb the columns of one (B, 4) buffer) and at the dense
   chunk, where NaN in the pad slots changes no
   bit; ``composite_packed`` under autograd at the support march: one
   forward and one backward launch, no scan, its gradient within the same
   tolerance; the card time per call of the backward kernel, its plain
   version, the parent's differentiated composition (forward and backward)
   and the kernels' forward and backward through autograd, beside the byte
   bound and a one-element add by the same clock (``floor_ms``: what a
   launch costs at a support march, where the byte bound lies far below
   it). Every main path above counts the composite kernels' launches from
   0 and holds them: the forward once a packed chunk and no scan on every
   serving path (the dense, routed, single-expert, baked, budget-0 (0) and
   mesh frames, ``--op eval``, ``--op video``, the viewer's frames), and
   the backward never there; forward and backward once a differentiated
   loss on every budget training path (phases 5-8, 10, 11, 13, 16: the
   FoMAML, Reptile and MAML counts stated there);
18. a timing line (each phase's seconds), the kernels line, then the card's
   ``nvidia-smi`` line, then the result line ``{"ok": true, "device":
   {...}}``.

Exits non-zero, printing no result, when no CUDA device is present.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
import types
import warnings
from pathlib import Path

import numpy as np

H, W = 1080, 1920
SERVING_B = 983_040  # packed samples per 1080p chunk (30,720 rays × 32)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
EPS32 = float(np.finfo(np.float32).eps)
# the bf16 episode against a second computation of it: the loss within this
# relative error; a parameter group's gradient, as one vector, within this
# factor in length and this cosine in direction
BF16_LOSS_RTOL = 2e-3
BF16_NORM_FACTOR = 1.05
BF16_MIN_COS = 0.99


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 2


def scan_cases(torch, segscan):
    """(name, x f32, starts bool, offset) on the CPU. Boundaries are placed
    on the kernel's own edges: tiles of ``segscan.TILE`` elements, warps of
    ``segscan.WARP``, threads of ``segscan.ITEMS``. ``offset`` > 0 asks for
    the buffers as views that many elements into larger ones."""
    T, Wp, I = segscan.TILE, segscan.WARP, segscan.ITEMS
    g = np.random.default_rng(0)

    def segs(n, mean):
        s = g.random(n) < 1.0 / mean
        s[0] = True
        return s

    def only(n, *slices):
        s = np.zeros(n, bool)
        for sl in slices:
            s[sl] = True
        s[0] = True
        return s

    cases = []
    for n in (1, 31):  # less than a warp of one tile
        cases.append((f"tiny_{n}", g.normal(size=n), segs(n, 7), 0))
    n = 3 * T + 357  # the tail tile takes the scalar path
    cases.append(("ragged_length", g.normal(size=n), segs(n, 7), 0))
    n = 7 * T + 4 * 11 + 3  # n % 4 == 3, n % 16 == 15
    cases.append(("length_not_multiple_of_4", g.normal(size=n), segs(n, 50), 0))
    # contiguous but 4 bytes (1 byte for the flags) off 16-byte alignment:
    # the wrapper takes it and every tile runs the scalar path
    n = 6 * T + 2
    cases.append(("offset_view", g.normal(size=n), segs(n, 9), 1))
    n = 5 * T + 11  # the look-back runs the whole chain of tiles
    cases.append(("one_segment", g.normal(size=n), only(n), 0))
    n = 100 * T + 11  # ... over more than one window of 32 states
    cases.append(("one_segment_long", g.normal(size=n), only(n), 0))
    n = 2 * T + 5
    cases.append(("single_samples", g.normal(size=n), np.ones(n, bool), 0))
    n = 8 * T
    cases.append(("tile_warp_thread_edges", g.normal(size=n),
                  only(n, slice(None, None, T), slice(Wp, None, 2 * Wp),
                       slice(I, None, Wp + I), slice(T - 1, None, T)), 0))
    # one boundary per tile, at its last / its first element: every
    # aggregate is closed by a boundary and the carry is a whole tile's sum
    n = 40 * T
    cases.append(("boundary_at_tile_last", g.normal(size=n),
                  only(n, slice(T - 1, None, T)), 0))
    cases.append(("boundary_at_tile_first", g.normal(size=n),
                  only(n, slice(None, None, T)), 0))
    # opaque scale: ≈ −23 per sample, segments of 1..256 samples
    n = SERVING_B
    s = only(n, np.cumsum(g.integers(1, 257, n // 64)).clip(max=n - 1))
    cases.append(("opaque_scale", -23.0 + g.normal(size=n), s, 0))
    # a grid of more blocks than the card holds at once: rays, and one
    # segment whose chain of tiles runs from wave to wave
    n = 3_000_000
    cases.append(("multi_pass_aggregates", g.normal(size=n), segs(n, 40), 0))
    cases.append(("one_segment_many_waves", g.normal(size=n + 5), only(n + 5), 0))
    # the serving shape as composite_packed makes it: per-ray segments of
    # log(1 − α) over the real slots, then a tail of pad slots (ray 0)
    n = SERVING_B
    n_real = int(0.8 * n)
    lens = g.integers(1, 64, n)
    s = only(n, np.cumsum(lens)[np.cumsum(lens) < n_real], n_real)
    alpha = np.where(np.arange(n) < n_real, g.random(n) ** 3, 0.0)
    cases.append(("serving", np.log(1.0 - alpha * 0.999 + 1e-10), s, 0))
    return [(name, torch.from_numpy(x.astype(np.float32)),
             torch.from_numpy(s), off) for name, x, s, off in cases]


def compare(got, want, x, starts) -> dict:
    """|got − want| against a tolerance per element: 32 ulp of the |x| sum
    of the element's own segment (the kernel and the plain version add in
    different orders) plus 1e-6 of |want|. A fault in short segments cannot
    hide under the tolerance of a long one."""
    got, want = got.detach().cpu().numpy(), want.detach().cpu().numpy()
    x, starts = x.detach().cpu().numpy(), starts.cpu().numpy()
    seg = np.cumsum(starts) - 1
    tol = 32 * EPS32 * np.bincount(seg, np.abs(x))[seg] + 1e-6 * np.abs(want)
    err = np.abs(got - want)
    i = int(np.argmax(err - tol))  # the element closest to failing
    return {"err": float(err.max()), "ok": bool(np.all(err <= tol)),
            "worst_err": float(err[i]), "worst_tol": float(tol[i])}


def on_card(torch, t, offset: int):
    """``t`` on the card; with ``offset``, as a view that many elements into
    a larger buffer: contiguous, but not 16-byte aligned."""
    if not offset:
        return t.cuda()
    view = torch.cat([t.new_ones(offset), t]).cuda()[offset:]
    check(view.data_ptr() % 16 != 0, "the offset view is 16-byte aligned")
    return view


def check_two_streams(torch, segscan, a, b) -> dict:
    """Forward and reverse scans of two buffers queued on two streams at
    once (both streams held back first, so that the kernels overlap), each
    against its plain version. The streams' scratch buffers differ."""
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    want = [(segscan.seg_excl_sum_plain(x, s), segscan.seg_excl_rsum_plain(x, s))
            for x, s in (a, b)]
    torch.cuda.synchronize()
    got, scratch = [], []
    for st, (x, s) in zip(streams, (a, b)):
        with torch.cuda.stream(st):
            torch.cuda._sleep(100_000_000)
            got.append([(segscan.seg_excl_sum_kernel(x, s),
                         segscan.seg_excl_rsum_kernel(x, s)) for _ in range(4)])
            scratch.append(segscan.scan_scratch(x.device).data_ptr())
    torch.cuda.synchronize()
    check(scratch[0] != scratch[1], "two streams share one scratch buffer")
    ok = all(compare(f, w[0], x, s)["ok"] and compare(r, w[1], x, s)["ok"]
             for runs, w, (x, s) in zip(got, want, (a, b)) for f, r in runs)
    check(ok, "scans queued on two streams at once disagree with the plain version")
    return {"streams": 2, "scans_per_stream": 8, "ok": ok}


def check_epoch_wrap(torch, segscan, short, long) -> dict:
    """Scans across the wrap of the launch epoch kept in the scratch buffer:
    two launches of few tiles at the last two epochs, then launches of many
    tiles at epochs 0, 1, ... A state planted beyond the short launches'
    tiles, valid-looking for epoch 0, must have been zeroed by the wrap."""
    x, s = long
    scratch = segscan.scan_scratch(x.device)
    torch.cuda.synchronize()
    scratch[0] = (segscan.EPOCH_MAX - 1) << 32
    planted = 2 + 50  # the state of tile 50: epoch 0, prefix, value 1e9
    scratch[planted] = (2 << 32) | int(np.float32(1e9).view(np.uint32))
    epochs, ok = [], True
    for i, (xi, si) in enumerate((short, short, long, long, long)):
        kernel, plain = ((segscan.seg_excl_sum_kernel, segscan.seg_excl_sum_plain)
                         if i % 2 == 0 else
                         (segscan.seg_excl_rsum_kernel, segscan.seg_excl_rsum_plain))
        ok &= compare(kernel(xi, si), plain(xi, si), xi, si)["ok"]
        word = int(scratch[0])
        epochs.append(word >> 32)
        ok &= word & 0xffffffff == 0  # the ticket is back at 0
        if i == 1:  # the launch at the last epoch zeroed every state
            ok &= int(scratch[planted]) == 0
    want = [segscan.EPOCH_MAX, 0, 1, 2, 3]
    check(ok and epochs == want, f"scans across the epoch's wrap: results ok "
          f"{ok}, epochs after each launch {epochs}, want {want}")
    return {"epochs_after_each_launch": epochs, "ok": ok}


DOUBLE_B = 32_768  # packed samples of one support episode (1,024 rays × 32)


def double_backward_on_card(torch, segscan, bench) -> dict:
    """The scan's second derivative, as second-order MAML takes it, at
    B = ``DOUBLE_B``: y = seg_excl_sum(x), g_x = ∂⟨y, g⟩/∂x (the reverse
    kernel, ``SegExclRSum``) with its graph, then ∂⟨g_x, v⟩/∂g (the forward
    kernel again, ``SegExclRSum``'s backward): one forward, one reverse and
    one more forward launch, each result held against the plain version on
    the card; timed against the same chain through the plain versions."""
    x, s = bench.random_case(DOUBLE_B, 32, seed=5)
    gen = torch.Generator(device="cuda").manual_seed(6)
    gy = torch.randn(DOUBLE_B, generator=gen, device="cuda")
    v = torch.randn(DOUBLE_B, generator=gen, device="cuda")

    def chain(fwd):
        xx, gg = x.clone().requires_grad_(True), gy.clone().requires_grad_(True)
        (gx,) = torch.autograd.grad(fwd(xx, s), xx, gg, create_graph=True)
        (hv,) = torch.autograd.grad(gx, gg, v)
        return gx.detach(), hv

    before = _scan_counts(segscan)
    gx, hv = chain(segscan.seg_excl_sum)
    after = _scan_counts(segscan)
    counts = (after[0] - before[0], after[1] - before[1])
    check(counts == (2, 1), f"the scan's second derivative launched (forward, "
          f"reverse) {counts}, want (2, 1)")
    res = {"gx": compare(gx, segscan.seg_excl_rsum_plain(gy, s), gy, s),
           "hv": compare(hv, segscan.seg_excl_sum_plain(v, s), v, s)}
    pgx, phv = chain(segscan.seg_excl_sum_plain)
    res["gx_vs_plain_autograd"] = compare(gx, pgx, gy, s)
    res["hv_vs_plain_autograd"] = compare(hv, phv, v, s)
    check(all(r["ok"] for r in res.values()),
          f"the scan's second derivative disagrees with the plain version: {res}")
    return {"B": DOUBLE_B, "launches_fwd_rev": counts, **res,
            "max_abs_err": max(r["err"] for r in res.values()),
            "ms": bench.time_ms(lambda: chain(segscan.seg_excl_sum), 50),
            "plain_ms": bench.time_ms(lambda: chain(segscan.seg_excl_sum_plain), 20),
            "bound_ms": 1e3 * 3 * 9 * DOUBLE_B / HBM_BYTES_PER_S}


def phase_kernel(torch, segscan, bench):
    time_ms = bench.time_ms
    errs, worst = {}, 0.0
    cases = scan_cases(torch, segscan)
    on = {name: (on_card(torch, x, off), on_card(torch, s, off))
          for name, x, s, off in cases}
    for name, x, s, off in cases:
        xc = on_card(torch, x, off).requires_grad_(True)
        sc = on[name][1]
        gr = on_card(torch, torch.randn(
            x.shape, generator=torch.Generator().manual_seed(1)), off)
        counts = (segscan.seg_excl_sum_kernel.launches,
                  segscan.seg_excl_rsum_kernel.launches)
        got = segscan.seg_excl_sum(xc, sc)  # kernel, forward
        (got * gr).sum().backward()  # reverse kernel, through autograd
        rev = segscan.seg_excl_rsum_kernel(gr, sc)  # reverse kernel, directly
        check((segscan.seg_excl_sum_kernel.launches,
               segscan.seg_excl_rsum_kernel.launches)
              == (counts[0] + 1, counts[1] + 2),
              f"{name}: want one forward and two reverse launches")
        xp = on_card(torch, x, off).requires_grad_(True)
        want = segscan.seg_excl_sum_plain(xp, sc)  # plain, on the card
        (want * gr).sum().backward()
        want_rev = segscan.seg_excl_rsum_plain(gr, sc)
        torch.cuda.synchronize()
        # the reverse scan runs over the same segments
        res = {"fwd": compare(got, want, x, s),
               "bwd": compare(xc.grad, xp.grad, gr, s),
               "rev": compare(rev, want_rev, gr, s)}
        errs[name] = {"n": int(x.numel()), "offset": off, **res}
        check(all(r["ok"] and math.isfinite(r["err"]) for r in res.values()),
              f"kernel disagrees with the plain version on {name}: {errs[name]}")
        worst = max(worst, *(r["err"] for r in res.values()))

    two = check_two_streams(torch, segscan, on["multi_pass_aggregates"], on["serving"])
    wrap = check_epoch_wrap(torch, segscan, on["one_segment"], on["one_segment_long"])

    x, s = on["serving"]
    g = torch.randn(SERVING_B, generator=torch.Generator().manual_seed(2)).cuda()

    def via_flips():  # the backward as it was: three copies and a forward scan
        end = torch.cat([s[1:], s.new_ones(1)])
        return segscan.seg_excl_sum_kernel(g.flip(0), end.flip(0)).flip(0)

    def in_a_row():
        for _ in range(10):
            segscan.seg_excl_sum_kernel(x, s)

    one = torch.zeros(1, device="cuda")
    zero, y = torch.zeros((), device="cuda"), torch.empty_like(x)
    ms = time_ms(lambda: segscan.seg_excl_sum_kernel(x, s), 100)
    reverse_ms = time_ms(lambda: segscan.seg_excl_rsum_kernel(g, s), 100)
    flips_ms = time_ms(via_flips, 100)
    plain_ms = time_ms(lambda: segscan.seg_excl_sum_plain(x, s), 20)
    reverse_plain_ms = time_ms(lambda: segscan.seg_excl_rsum_plain(g, s), 20)
    bytes_moved = SERVING_B * (4 + 1 + 4)  # read x and flag, write out
    bound_ms = 1e3 * max(bytes_moved / HBM_BYTES_PER_S,
                         SERVING_B / F32_OPS_PER_S)
    emit({"phase": "kernel", "name": "seg_excl_sum", "cases": errs,
          "two_streams": two, "epoch_wrap": wrap,
          "max_abs_err": worst, "B": SERVING_B, "ms": ms,
          "reverse_ms": reverse_ms, "reverse_via_flips_ms": flips_ms,
          "plain_ms": plain_ms, "reverse_plain_ms": reverse_plain_ms,
          "bound_ms": bound_ms, "bound_by": "bytes",
          "bytes_per_launch": bytes_moved,
          # what the clock costs: per launch when ten scans run between one
          # pair of events; a one-element PyTorch kernel between a pair; and
          # a PyTorch kernel without dependencies that moves the same bytes
          "ms_in_a_row": time_ms(in_a_row, 30) / 10,
          "one_element_add_ms": time_ms(lambda: one.add_(1.0), 100),
          "where_same_bytes_ms": time_ms(
              lambda: torch.where(s, x, zero, out=y), 100)})

    sweep = []
    for mult in (1, 4, 16):
        n = mult * SERVING_B
        xs, ss = bench.random_case(n, 32, seed=mult)
        check(bench.agrees(segscan.seg_excl_sum_kernel(xs, ss),
                           segscan.seg_excl_sum_plain(xs, ss), xs, ss)
              and bench.agrees(segscan.seg_excl_rsum_kernel(xs, ss),
                               segscan.seg_excl_rsum_plain(xs, ss), xs, ss),
              f"kernel disagrees with the plain version at B = {n}")
        t = time_ms(lambda: segscan.seg_excl_sum_kernel(xs, ss), 100)
        ys = torch.empty_like(xs)
        sweep.append({"B": n, "ms": t, "bound_ms": 1e3 * 9 * n / HBM_BYTES_PER_S,
                      "gb_per_s": 9 * n / (1e-3 * t) / 1e9,
                      "where_same_bytes_ms": time_ms(
                          lambda: torch.where(ss, xs, zero, out=ys), 100)})
        del xs, ss, ys
    emit({"sweep": sweep, "bytes_per_element": 9,
          "one_element_scan_ms": time_ms(
              lambda: segscan.seg_excl_sum_kernel(x[:1], s[:1]), 100)})
    dbl = double_backward_on_card(torch, segscan, bench)
    emit({"phase": "kernel_double_backward", **dbl})
    rev_worst = max(c["rev"]["err"] for c in errs.values())
    return {"double_backward": dbl, "max_abs_err": worst, "reverse_max_abs_err": rev_worst,
            "ms": ms,
            "reverse_ms": reverse_ms, "plain_ms": plain_ms,
            "reverse_plain_ms": reverse_plain_ms, "bound_ms": bound_ms}


# ---------------------------------------------------------------- phase 3


def phase_main_path(torch, segscan, toy, Renderer, profile_dir):
    cfg, P, occ_cfg = toy.train_occ_config()
    # the frames start from an empty allocator, whatever the kernel phase
    # before them left cached
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = toy.serving_model(cfg, seed=0, device="cuda")
    boxes, _ = toy.quadrant_layout(cfg.num_submodules)
    occ = toy.random_occ_states(boxes, occ_cfg, fill=0.10, seed=0, device="cuda")
    renderer = Renderer(cfg, P, occ_cfg)  # the card by default
    cam = toy.overhead_camera(H, W)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rows = renderer.chunk_rays // W
    chunks = -(-H // rows)
    n_table = sum(int(p.numel()) for p in model.experts["hash_table"])

    torch.cuda.reset_peak_memory_stats()
    _zero_scan_counts(segscan)
    t0 = time.perf_counter()
    renderer.render_image(model, occ, H=H, W=W, download=False, **cam)  # warm
    warm_ms = 1e3 * (time.perf_counter() - t0)
    frame_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        renderer.render_image(model, occ, H=H, W=W, download=False, **cam)
        frame_ms.append(1e3 * (time.perf_counter() - t0))
    # every wait of the host for the card in one frame: the frame's inputs
    # and its end may wait, a chunk may not
    _, syncs, sites = host_syncs(torch, lambda: renderer.render_image(
        model, occ, H=H, W=W, download=False, **cam))
    check(syncs < chunks, f"{syncs} host syncs in a frame of {chunks} chunks "
          f"at {sites}")
    t0 = time.perf_counter()
    rgb, depth, acc = renderer.render_image(model, occ, H=H, W=W, **cam)
    e2e_ms = 1e3 * (time.perf_counter() - t0)
    launches = segscan.seg_excl_sum_kernel.launches
    rev_launches = segscan.seg_excl_rsum_kernel.launches
    comp_launches = _comp_fwd()
    frames = 6
    hash_fwd, _ = note_hash("render_image", trains=False)
    # one composite launch a chunk, which scans the transmittance itself:
    # neither scan kernel runs in serving
    check_packed("render_image", (launches, rev_launches), chunks * frames)
    check(rgb.shape == (H, W, 3) and np.isfinite(rgb).all()
          and np.isfinite(depth).all() and np.isfinite(acc).all(),
          "the frame is not finite or has the wrong shape")
    emit({"phase": "main_path", "H": H, "W": W, "rays_per_chunk": rows * W,
          "packed_samples_per_chunk": rows * W * int(P.occ_budget_per_ray),
          "chunks_per_frame": chunks, "frames": frames,
          "composite_launches": comp_launches,
          "seg_excl_sum_launches": launches,
          "seg_excl_rsum_launches": rev_launches,
          "hash_fwd_launches_per_frame": hash_fwd / frames,
          "host_syncs_per_frame": syncs,
          "host_sync_sites": sites,
          "setup_s": setup_s, "warm_frame_ms": warm_ms, "frame_ms": frame_ms,
          "mean_frame_ms": statistics.mean(frame_ms),
          "frame_ms_with_download": e2e_ms,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "hash_table_mb": 4 * n_table / 1e6,
          "mean_rgb": [float(v) for v in rgb.reshape(-1, 3).mean(0)],
          "mean_acc": float(acc.mean())})

    if profile_dir:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        Path(profile_dir).mkdir(parents=True, exist_ok=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            renderer.render_image(model, occ, H=H, W=W, download=False, **cam)
            wall_ms = 1e3 * (time.perf_counter() - t0)
        # busy time of the card: kernels, copies and fills of this frame
        busy_ms = 1e-3 * sum(e.time_range.elapsed_us() for e in prof.events()
                             if e.device_type == DeviceType.CUDA)
        table = prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=40)
        (Path(profile_dir) / "frame_kernels.txt").write_text(table)
        print(table, flush=True)
        # the composite kernel in place, between the ops that make its input
        # and read its output (the table above may cut it off)
        ck = [e for e in prof.key_averages() if "composite_fwd_kernel" in e.key]
        ck_us = sum(getattr(e, "device_time_total", 0)
                    or getattr(e, "cuda_time_total", 0) for e in ck)
        ck_n = sum(e.count for e in ck)
        emit({"phase": "profile", "frame_wall_ms": wall_ms,
              "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
              "kernel_launches": sum(e.count for e in prof.key_averages()
                                     if e.key == "cudaLaunchKernel"),
              "composite_kernel_launches": ck_n,
              "composite_kernel_mean_us": ck_us / max(ck_n, 1),
              "hash_kernels": hash_kernel_times(prof, busy_ms),
              "ngp_net_kernel": net_kernel_times(prof, busy_ms)})
    return model, occ, cam, (launches, rev_launches), frame_ms


# ---------------------------------------------------------------- phase 4


def phase_vs_cpu(torch, toy, Renderer, model, occ, cam, P=None, phase="main_path_vs_cpu"):
    """``render_rays`` on the card against the CPU for the render params
    ``P`` (the config's: the packed-budget path)."""
    from acn_tpu_torch.pipelines.renderer import _pinhole_block_rays

    cfg, P_cfg, occ_cfg = toy.train_occ_config()
    P = P or P_cfg
    args = [torch.from_numpy(np.asarray(a, np.float32)) for a in
            (cam["c2w"], cam["intrinsics"], cam["aabb"])]
    rays = _pinhole_block_rays(H, W, *args, torch.tensor([-np.inf, np.inf]),
                               0.0, 0.0).numpy()
    rays = rays[np.random.default_rng(0).choice(len(rays), 2048, replace=False)]
    model_cpu = toy.serving_model(cfg, seed=0, device="cpu")
    occ_cpu = {k: v.cpu() for k, v in occ.items()}
    out = {}
    # tolerance: f32 MLP products sum in another order in cuBLAS than on the
    # CPU (~1e-6 relative per layer), exp/log differ by an ulp, and the
    # composite kernel sums each ray in another order than the plain
    # composition on the CPU
    atol, rtol = 1e-4, 1e-4
    for name, thre, bias in (("alpha_thre_cfg", occ_cfg.alpha_thre, None),
                             ("alpha_thre_0_bias_2", 0.0, 2.0)):
        if bias is not None:
            with torch.no_grad():
                model.experts["sigma_head"]["b"].fill_(bias)
                model_cpu.experts["sigma_head"]["b"].fill_(bias)
        oc = dataclasses.replace(occ_cfg, alpha_thre=thre)
        gpu = Renderer(cfg, P, oc, chunk_rays=2048).render_rays(
            model, occ, rays, with_stats=True)
        cpu = Renderer(cfg, P, oc, chunk_rays=2048, device="cpu").render_rays(
            model_cpu, occ_cpu, rays, with_stats=True)
        errs = {k: float(np.abs(g - c).max()) for k, g, c in
                zip(("rgb", "depth", "acc", "wmax", "went"), gpu, cpu)}
        ok = all(np.allclose(g, c, atol=atol, rtol=rtol) for g, c in
                 zip(gpu[:4], cpu[:4]))
        out[name] = {"max_abs_err": errs, "max_acc": float(cpu[2].max()),
                     "mean_acc": float(cpu[2].mean())}
        check(ok, f"card vs CPU render_rays disagree at {name}: {errs}")
    check(out["alpha_thre_0_bias_2"]["max_acc"] > 0.5,
          "the opaque case composited nothing opaque")
    emit({"phase": phase, "rays": 2048, "atol": atol, "rtol": rtol, **out})
    return occ_cpu


# ---------------------------------------------------------------- phase 5


def host_syncs(torch, fn):
    """Run ``fn`` with PyTorch's sync debug mode on; (its result, the count
    of host waits for the card, their sites)."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(f"{Path(w.filename).name}:{w.lineno}"
                                for w in caught if "synchroniz" in str(w.message))
    return out, sum(sites.values()), dict(sites)


def scan_on_training_segments(torch, segscan, bench, samples) -> dict:
    """Both kernels against their plain versions, and timed, on the segment
    boundaries of one real training march (its packed ray ids), with the
    log-transmittance of random opacities as values."""
    rid, real = samples["ray_id"], samples["slot_real"]
    B = int(rid.numel())
    starts = torch.cat([torch.ones(1, dtype=torch.bool, device=rid.device),
                        rid[1:] != rid[:-1]])
    gen = torch.Generator(device="cuda").manual_seed(B)
    alpha = torch.where(real, torch.rand(B, generator=gen, device="cuda") ** 3, 0.0)
    x = torch.log(1.0 - 0.999 * alpha + 1e-10)
    g = torch.randn(B, generator=gen, device="cuda")
    fwd, rev = compare(segscan.seg_excl_sum_kernel(x, starts),
                       segscan.seg_excl_sum_plain(x, starts), x, starts), \
        compare(segscan.seg_excl_rsum_kernel(g, starts),
                segscan.seg_excl_rsum_plain(g, starts), g, starts)
    check(fwd["ok"] and rev["ok"], f"kernel disagrees with the plain version "
          f"on a training march of B = {B}: {fwd} {rev}")
    return {"B": B, "segments": int(starts.sum()), "real": int(real.sum()),
            "max_abs_err": fwd["err"], "reverse_max_abs_err": rev["err"],
            "ms": bench.time_ms(lambda: segscan.seg_excl_sum_kernel(x, starts), 100),
            "reverse_ms": bench.time_ms(
                lambda: segscan.seg_excl_rsum_kernel(g, starts), 100),
            "plain_ms": bench.time_ms(
                lambda: segscan.seg_excl_sum_plain(x, starts), 20),
            "reverse_plain_ms": bench.time_ms(
                lambda: segscan.seg_excl_rsum_plain(g, starts), 20),
            "bound_ms": 1e3 * 9 * B / HBM_BYTES_PER_S}


def episode_loss_grads(torch, ts, nn, cfg, P, occ_cfg, model_cpu, occ_cpu, rays,
                       rgbs, dev, rand):
    """Expert 0's episode loss on ``rays`` and its gradient (float32 leaves,
    as float64 on the CPU), with the σ-head bias at +2 so that the
    transmittance carries weight, on ``dev``; ``rand`` is the march's
    draws."""
    loss_fn, prep = ts.make_episode_loss(cfg, P, occ_cfg)
    params = model_cpu.params()
    expert = nn.tree_map(
        lambda a: a[0].detach().clone().to(dev).requires_grad_(True),
        params["experts"])
    with torch.no_grad():
        expert["sigma_head"]["b"].fill_(2.0)
    bg = nn.tree_map(lambda a: a.detach().to(dev), params["bg_mlp"])
    r = torch.from_numpy(rays).to(dev)
    if isinstance(rand, tuple):
        rand = tuple(x.to(dev) for x in rand)
    smp = prep({k: v[0].to(dev) for k, v in occ_cpu.items()}, r, rand)
    loss = loss_fn(expert, bg, model_cpu.expert_aabbs[0].to(dev), r,
                   torch.from_numpy(rgbs).to(dev), smp)
    grads = torch.autograd.grad(loss, nn.tree_leaves(expert))
    check(all(g.dtype == torch.float32 for g in grads),
          f"{dev}: a gradient of a float32 leaf is not float32")
    return float(loss.detach()), [g.double().cpu() for g in grads]


def check_card_vs_cpu_f32(torch, got, want, n_tables, what) -> dict:
    """A float32 episode's loss and gradient on the card against the CPU:
    loss rtol 1e-5, gradients atol 1e-6 with rtol 1e-3 on the tables and
    1e-4 on the MLPs (cuBLAS sums f32 products in another order than the
    CPU; the table gradient is a scatter-add with atomics, whose order is
    free)."""
    (lg, gg), (lc, gc) = got, want
    check(abs(lg - lc) <= 1e-5 * abs(lc), f"{what} loss: card {lg}, CPU {lc}")
    err = {"table": 0.0, "mlp": 0.0}
    for i, (a, b) in enumerate(zip(gg, gc)):
        kind = "table" if i < n_tables else "mlp"
        rtol = 1e-3 if kind == "table" else 1e-4
        err[kind] = max(err[kind], float((a - b).abs().max()))
        check(torch.allclose(a, b, atol=1e-6, rtol=rtol),
              f"{what} gradient leaf {i} ({kind}): card vs CPU max |diff| "
              f"{float((a - b).abs().max())}")
    check(any(float(g.abs().max()) > 0 for g in gc[:n_tables]),
          f"{what}: the table gradient is all zero")
    return {"loss_card": lg, "loss_cpu": lc, "max_abs_err_table_grad": err["table"],
            "max_abs_err_mlp_grad": err["mlp"]}


def episode_card_vs_cpu(torch, toy, ts, nn, model_cpu, occ_cpu, batch_np) -> dict:
    """One episode's loss and gradient, 256 rays, one salt, the σ-head bias at
    +2 so that the transmittance (and with it the composite's backward)
    carries weight: float32 on the card (the composite kernels) against
    float32 on the CPU (plain versions); the bf16 episode (``use_amp``, the path the step runs) on the card
    against the same on the CPU, and against the float32 one on the card."""
    cfg, P, occ_cfg = toy.train_occ_config()
    rays, rgbs = batch_np["support_rays"][0, 0, :256], batch_np["support_rgbs"][0, 0, :256]
    n_tables = len(model_cpu.params()["experts"]["hash_table"])
    out = {}
    for label, dev, amp in (("card", "cuda", False), ("cpu", "cpu", False),
                            ("card_bf16", "cuda", True), ("cpu_bf16", "cpu", True)):
        P_run = types.SimpleNamespace(**{**vars(P), "use_amp": amp})
        out[label] = episode_loss_grads(torch, ts, nn, cfg, P_run, occ_cfg, model_cpu,
                                        occ_cpu, rays, rgbs, dev, 12345)
    lg, gg = out["card"]
    (lb, gb), (lbc, gbc) = out["card_bf16"], out["cpu_bf16"]
    f32 = check_card_vs_cpu_f32(torch, out["card"], out["cpu"], n_tables, "episode")

    def against(ga, gb_, sl):
        """Two gradients' leaves ``sl`` as one vector each: (ratio of their
        lengths, cosine of their angle)."""
        a = torch.cat([g.reshape(-1) for g in ga[sl]])
        b = torch.cat([g.reshape(-1) for g in gb_[sl]])
        return (float(a.norm() / b.norm()),
                float((a * b).sum() / (a.norm() * b.norm())))

    groups = (("table", slice(0, n_tables)), ("mlp", slice(n_tables, None)))
    # The bf16 episode (the path the step runs) on the card against the same
    # episode on the CPU: one arithmetic, so the same cells; the matmuls
    # round to bf16 from sums taken in another order, and the table
    # gradient's bf16 scatter-add depends on its order (atomics on the card).
    # So no entry is compared: the loss, and each group's gradient as one
    # vector, in length and in direction.
    check(all(bool(torch.isfinite(g).all()) for g in gb),
          "the bf16 episode's gradient on the card is not finite")
    same = {"loss_card": lb, "loss_cpu": lbc, "loss_rel_err": abs(lb - lbc) / abs(lbc)}
    for kind, sl in groups:
        ratio, cos = against(gb, gbc, sl)
        same[kind] = {"norm_ratio": ratio, "cos": cos}
    same["table_cos_by_level"] = [against(gb, gbc, slice(i, i + 1))[1]
                                  for i in range(n_tables)]
    check(same["loss_rel_err"] <= BF16_LOSS_RTOL and all(
        1.0 / BF16_NORM_FACTOR <= same[k]["norm_ratio"] <= BF16_NORM_FACTOR
        and same[k]["cos"] >= BF16_MIN_COS for k, _ in groups),
        f"bf16 episode, card against CPU: {same}")
    # bf16 against float32, both on the card: the loss and the MLP gradient
    # are held. The table gradient is reported level by level and not held,
    # because the two land on different entries, as in the reference: the
    # grids span the scene and an expert's box is a quadrant of it, so most
    # samples are clamped to x01 = 1 − ε, which bf16 rounds to 1.0 (cell
    # `res`, fraction 0, where float32 has cell `res − 1`, fraction ≈ 1); and
    # x·resolution in bf16 keeps 8 bits, so from a resolution of about a
    # hundred on the bf16 cell is another cell than the float32 one.
    vs32 = {"loss_rel_err": abs(lb - lg) / abs(lg)}
    ratio, cos = against(gb, gg, groups[1][1])
    vs32["mlp"] = {"norm_ratio": ratio, "cos": cos}
    vs32["table_norm_ratio"] = against(gb, gg, groups[0][1])[0]
    vs32["table_cos_by_level"] = [against(gb, gg, slice(i, i + 1))[1]
                                  for i in range(n_tables)]
    check(vs32["loss_rel_err"] <= BF16_LOSS_RTOL
          and 1.0 / BF16_NORM_FACTOR <= ratio <= BF16_NORM_FACTOR
          and cos >= BF16_MIN_COS,
          f"bf16 episode against float32, both on the card: {vs32}")
    return {"rays": 256, **f32, "bf16_card_vs_cpu": same, "bf16_vs_f32_on_card": vs32}


def profile_window(torch, fn, profile_dir, name):
    """``fn`` once under ``torch.profiler``, between two synchronizations:
    (the profile, wall ms, the card's busy ms, kernel launches). Writes the
    ops by device time and by host time to DIR/<name>_kernels.txt and
    DIR/<name>_host.txt and prints the first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    Path(profile_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy_ms = 1e-3 * sum(e.time_range.elapsed_us() for e in prof.events()
                         if e.device_type == DeviceType.CUDA)
    avgs = prof.key_averages()
    table = avgs.table(sort_by="cuda_time_total", row_limit=45)
    (Path(profile_dir) / f"{name}_kernels.txt").write_text(table)
    print(table, flush=True)
    # a step waits on the host: the same events by the host's own time
    (Path(profile_dir) / f"{name}_host.txt").write_text(
        avgs.table(sort_by="self_cpu_time_total", row_limit=30))
    launches = sum(e.count for e in avgs if e.key == "cudaLaunchKernel")
    return prof, wall_ms, busy_ms, launches


def phase_train_step(torch, segscan, bench, toy, model_cpu, occ_cpu, profile_dir):
    from acn_tpu_torch.models import nn
    from acn_tpu_torch.pipelines.offline_stage import train_step as ts

    cfg, P, occ_cfg = toy.train_occ_config()
    K, T = cfg.num_submodules, int(P.batch_size)
    S, Q = int(P.support_rays), int(P.query_rays)
    per_step = K * T * (int(P.inner_iter) + 1)
    torch.cuda.empty_cache()
    model = toy.serving_model(cfg, seed=0, device="cuda")
    occ = {k: v.cuda() for k, v in occ_cpu.items()}
    batch_np = toy.training_batch(K, T, S, Q, seed=0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    opt, state = toy.init_train_state(model, P)
    step = ts.make_meta_train_step(cfg, P, opt, occ_cfg)  # the card by default
    gen = torch.Generator(device="cuda").manual_seed(0)
    start = nn.tree_map(lambda p: p.detach().clone(), model.params())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    step_ms, launches, metrics, syncs, sites = [], [], None, 0, {}
    hash_counts = []
    for i in range(4):  # one warm step, three timed
        _zero_scan_counts(segscan)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 3:  # the last timed step also counts the host's waits
            (state, metrics), syncs, sites = host_syncs(
                torch, lambda: step(state, batch, occ, gen))
        else:
            state, metrics = step(state, batch, occ, gen)
        torch.cuda.synchronize()
        if i:
            step_ms.append(1e3 * (time.perf_counter() - t0))
        launches.append(_train_counts(segscan))
        hash_counts.append(_kernel_counts())
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    note_hash("train_step", True, tuple(sum(c[i] for c in hash_counts) for i in range(5)))
    check(all(l == budget_want(per_step) for l in launches),
          f"launches per step (scan forward, reverse, composite forward, backward) "
          f"{launches}, want {budget_want(per_step)}")
    check(syncs < per_step, f"{syncs} host syncs in a step of {per_step} "
          f"episode losses at {sites}")
    m = {k: v.detach().cpu().numpy() for k, v in metrics.items()}
    check(set(m) == {"loss_out", "loss_in", "psnr_out", "psnr_in", "loss_total",
                     "grad_norm", "occ_overflow"}
          and all(np.isfinite(v).all() for v in m.values()),
          f"a metric is missing or not finite: {m}")
    check(0.0 <= float(m["occ_overflow"]) <= 1.0 and float(m["grad_norm"]) > 0.0,
          f"occ_overflow {m['occ_overflow']}, grad_norm {m['grad_norm']}")
    check(int(state["opt_state"]["count"]) == 4 and state["step"] == 4
          and int(state["opt_state"]["total_notfinite"]) == 0,
          f"optimizer count {int(state['opt_state']['count'])}, step "
          f"{state['step']}, want 4; skipped updates "
          f"{int(state['opt_state']['total_notfinite'])}, want 0")
    moved = {}

    def note(a, b, label):
        changed = bool((a != b).any()) and bool(torch.isfinite(b).all())
        moved[label] = moved.get(label, True) and changed

    nn.tree_map(note, start, model.params(), opt.labels)
    check(set(moved) == {"encoding", "sigma", "color", "background"}
          and all(moved.values()), f"parameter groups that moved: {moved}")
    del start

    # the kernels on the segments of a real support and a real query march
    prep = ts.make_episode_loss(cfg, P, occ_cfg)[1]
    occ0 = {k: v[0] for k, v in occ.items()}
    shapes = [scan_on_training_segments(
        torch, segscan, bench, prep(occ0, batch[name][0, 0], 12345))
        for name in ("support_rays", "query_rays")]
    check([s["B"] for s in shapes] == [S * int(P.occ_budget_per_ray),
                                       Q * int(P.occ_budget_per_ray)],
          f"packed samples per episode {[s['B'] for s in shapes]}")
    vs_cpu = episode_card_vs_cpu(torch, toy, ts, nn, model_cpu, occ_cpu, batch_np)

    rays_per_step = K * T * (int(P.inner_iter) * S + Q)  # ray renders per step
    emit({"phase": "train_step", "K": K, "T": T, "support_rays": S,
          "query_rays": Q, "inner_iter": int(P.inner_iter), "use_amp": bool(P.use_amp),
          "step_ms": step_ms, "mean_step_ms": statistics.mean(step_ms),
          "rays_per_s": rays_per_step / (1e-3 * statistics.mean(step_ms)),
          "fwd_launches_per_step": launches[-1][0],
          "rev_launches_per_step": launches[-1][1],
          "composite_launches_per_step": launches[-1][2:],
          "hash_launches_per_step": hash_counts[-1],
          "syncs_per_step": syncs, "sync_sites": sites, "peak_mem_mb": peak_mb,
          "metrics": {k: v.tolist() for k, v in m.items()},
          "scan_on_training_segments": shapes,
          "one_element_add_ms": bench.time_ms(
              lambda: torch.zeros(1, device="cuda").add_(1.0), 100),
          "episode_card_vs_cpu": vs_cpu})

    if profile_dir:
        prof, wall_ms, busy_ms, n_launch = profile_window(
            torch, lambda: step(state, batch, occ, gen), profile_dir, "train_step")
        scan = {}
        for e in prof.key_averages():
            if "seg_scan_kernel" in e.key or "composite_" in e.key:
                us = (getattr(e, "device_time_total", 0)
                      or getattr(e, "cuda_time_total", 0))
                scan[e.key[:120]] = {"launches": e.count,
                                     "mean_us": us / max(e.count, 1)}
        emit({"phase": "train_step_profile", "step_wall_ms": wall_ms,
              "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
              "kernel_launches": n_launch, "scan_and_composite_kernels": scan,
              "hash_kernels": hash_kernel_times(prof, busy_ms),
              "scan_and_composite_share_of_busy": 1e-3 * sum(
                  v["launches"] * v["mean_us"] for v in scan.values()) / busy_ms})
    return {"launches": (sum(l[0] for l in launches), sum(l[1] for l in launches)),
            "steps": len(launches), "shapes": shapes, "syncs": syncs,
            "mean_step_ms": statistics.mean(step_ms)}


# ---------------------------------------------------------------- phase 6


# the 32³ update check scales expert 0's hash features by this: from the
# random init (U(±1e-4)) σ is all but constant over the grid, and about a
# fifth of the cells would sit in the threshold band where a cell may flip.
# Not by more: the σ MLP's sums grow with the features, and cuBLAS sums them
# in another order than the CPU (on an H100 at ×5,000 occs differ by 1.3e-6)
UPDATE_TABLE_SCALE = 1000.0
UPDATE_BAND = 1e-5  # relative distance from the threshold
# the jitter draws of the 32³ update check, each held: the headroom under
# rtol 1e-6 over several sets of sample points, not one
UPDATE_JITTER_SEEDS = (3, 4, 5, 6)


def _scan_counts(segscan):
    return (segscan.seg_excl_sum_kernel.launches, segscan.seg_excl_rsum_kernel.launches)


def _train_counts(segscan) -> tuple:
    """(scan forward, scan reverse, composite forward, composite backward)
    launches since the counters were last set to 0."""
    return (*_scan_counts(segscan), *_composite().launch_counts())


def budget_want(per_step: int) -> tuple:
    """A first-order budget step's ``_train_counts``: every differentiated
    loss composites in the forward and backward kernels, and no scan runs."""
    return (0, 0, per_step, per_step)


def _comp_fwd() -> int:
    """The composite forward kernel's launches since the counter was set to 0."""
    return _composite().launch_counts()[0]


def _zero_scan_counts(segscan) -> None:
    """Every kernel's count to 0: the scan's, the hash encode's, the
    network's and the composite's."""
    segscan.seg_excl_sum_kernel.launches = 0
    segscan.seg_excl_rsum_kernel.launches = 0
    _zero_hash_and_net()


def _zero_hash_and_net() -> None:
    """The counts of every kernel but the scan to 0."""
    _hashgrid().zero_launch_counts()
    _ngp_net().zero_launch_counts()
    _composite().zero_launch_counts()


def _hashgrid():
    from acn_tpu_torch.ops import hashgrid

    return hashgrid


def _ngp_net():
    from acn_tpu_torch.ops import ngp_net

    return ngp_net


def _composite():
    from acn_tpu_torch.ops import composite

    return composite


def _kernel_counts() -> tuple:
    """(hash forward, hash cotangent, network, composite forward, composite
    backward) launches since the counters were last set to 0."""
    return (*_hashgrid().launch_counts(), _ngp_net().launch_counts(),
            *_composite().launch_counts())


# the hash encode kernels' launches on each main path: (forward, table
# cotangent), the network kernel's and the composite kernels' (forward,
# backward), read just after the path ran, counted from 0 just before it
HASH_BY_PATH: dict = {}
NET_BY_PATH: dict = {}
SPLIT_BY_PATH: dict = {}  # the wide path's split launches (one before each wide network launch)
COMP_BY_PATH: dict = {}
COMP_BWD_BY_PATH: dict = {}


def note_hash(path: str, trains: bool, counts=None, net=None, comp=None) -> tuple:
    """Record a main path's hash-kernel, network-kernel and composite-kernel
    launches (the counters now, or ``counts``: (hash forward, hash
    cotangent, network, composite)) and fail unless the path launched the
    hash forward kernel, the cotangent kernel exactly when it trains, the
    network kernel as ``net`` says: "serves" (> 0; the default of a path
    that does not train), "none" (0; the default of one that trains: the
    kernel has no backward, and a training step's network runs under
    autograd or in bf16) or "any" (a path that trains and serves, such as a
    loop with its occupancy updates: recorded, not held), and the composite
    kernel as ``comp`` says, in the same words ("any" by default: a serving
    path holds its count to its chunks with ``check_packed``, a training
    step to its losses with ``budget_want``), and the composite backward
    kernel only where it trains; the wide path's split kernel at most once
    a network launch. ``counts``: (hash forward, hash cotangent, network,
    composite forward, composite backward), from a process whose network
    is never wide."""
    fwd, bwd, nl, cl, cbl = _kernel_counts() if counts is None else counts
    split = _ngp_net().split_launch_counts() if counts is None else 0
    check(split <= nl, f"{path}: {split} split launches for {nl} network launches")
    check(fwd > 0 and (bwd > 0) == trains,
          f"{path}: the hash encode kernels launched {fwd} forward and {bwd} "
          f"cotangent, want forward > 0 and cotangent {'> 0' if trains else '0'}")
    net = net or ("none" if trains else "serves")
    check(net == "any" or (nl > 0) == (net == "serves"),
          f"{path}: the network kernel launched {nl} times, want "
          f"{'> 0' if net == 'serves' else '0'}")
    comp = comp or "any"
    check(comp == "any" or (cl > 0) == (comp == "serves"),
          f"{path}: the composite kernel launched {cl} times, want "
          f"{'> 0' if comp == 'serves' else '0'}")
    check(trains or cbl == 0, f"{path}: the composite backward kernel launched {cbl} "
          f"times on a path that does not train")
    old = HASH_BY_PATH.get(path, (0, 0))
    HASH_BY_PATH[path] = (old[0] + fwd, old[1] + bwd)
    NET_BY_PATH[path] = NET_BY_PATH.get(path, 0) + nl
    SPLIT_BY_PATH[path] = SPLIT_BY_PATH.get(path, 0) + split
    note_comp(path, cl)
    COMP_BWD_BY_PATH[path] = COMP_BWD_BY_PATH.get(path, 0) + cbl
    return fwd, bwd


def note_comp(path: str, n=None) -> int:
    """Record a main path's composite launches (the counter now, or ``n``);
    ``note_hash`` does it for every path that encodes, this for the baked
    paths, which never reach the encode."""
    n = _comp_fwd() if n is None else n
    COMP_BY_PATH[path] = COMP_BY_PATH.get(path, 0) + n
    return n


def check_packed(path: str, scans, want: int, n=None) -> None:
    """Fail unless a serving path launched the composite kernel ``want``
    times (once a packed chunk; the counter now, or ``n``) and the scan not
    at all: the composite kernel does the transmittance scan itself."""
    n = _comp_fwd() if n is None else n
    check(n == want and tuple(scans) == (0, 0),
          f"{path}: the composite kernel launched {n} times and the scan "
          f"{tuple(scans)}, want {want} and (0, 0)")


def update_card_vs_cpu(torch, occ_grid, nn, cfg, occ_cfg, model) -> dict:
    """Expert 0's occupancy update at 32³, its hash features scaled by
    ``UPDATE_TABLE_SCALE``, on the card and on the CPU with the same
    injected jitter, once for each of ``UPDATE_JITTER_SEEDS``: occs within
    rtol 1e-6, binaries equal for every cell farther than ``UPDATE_BAND``
    (relative) from the threshold, that band under 1 % of the cells, and the
    cut between 5 % and 95 % occupied, in every draw."""
    occ32 = dataclasses.replace(occ_cfg, resolution=32)
    aabb_cpu = model.expert_aabbs[0].detach().cpu()
    state = occ_grid.init_occ_state(aabb_cpu, occ32)
    params = nn.tree_map(lambda a: a.detach(), model.expert(0))
    params["hash_table"] = [t * UPDATE_TABLE_SCALE for t in params["hash_table"]]

    def update(params, aabb, on, jitter):
        return occ_grid.update_occ_grid(
            {k: v.to(on) for k, v in state.items()},
            lambda x: cfg.expert_density(params, cfg.expert, aabb, x)[..., 0],
            occ32, occ32.step_size_for_traced(aabb), jitter=jitter.to(on))

    draws = []
    for seed in UPDATE_JITTER_SEEDS:
        jitter = torch.rand((occ32.levels, 32 ** 3, 3),
                            generator=torch.Generator().manual_seed(seed)) - 0.5
        got = update(params, model.expert_aabbs[0], "cuda", jitter)
        want = update(nn.tree_map(lambda a: a.cpu(), params), aabb_cpu, "cpu", jitter)
        occ_g, occ_w = got["occs"].cpu().double(), want["occs"].double()
        rel = float(((occ_g - occ_w).abs() / occ_w.abs().clamp(min=1e-30)).max())
        thre = max(min(occ32.occ_thre, float(occ_w.mean())), 1e-6)
        band = (occ_w - thre).abs() <= UPDATE_BAND * thre
        differ = got["binaries"].cpu() != want["binaries"]
        out = {"jitter_seed": seed, "max_rel_err_occs": rel, "cells_in_band": int(band.sum()),
               "binaries_differ_in_band": int((differ & band).sum()),
               "binaries_differ_outside_band": int((differ & ~band).sum()),
               "occupied_share": float(want["binaries"].float().mean())}
        check(rel <= 1e-6 and out["binaries_differ_outside_band"] == 0
              and out["cells_in_band"] < 0.01 * 32 ** 3
              and 0.05 < out["occupied_share"] < 0.95,
              f"occupancy update, card against CPU: {out}")
        draws.append(out)
    return {"cells": 32 ** 3, "hash_table_scale": UPDATE_TABLE_SCALE,
            "max_rel_err_occs": max(d["max_rel_err_occs"] for d in draws), "draws": draws}


def check_update_pass(torch, occ_cfg, before, after) -> list:
    """What one full-width pass must satisfy whatever the densities: the EMA
    never falls below occs · decay, and binaries is occs above the threshold
    recomputed from occs (a mean over the visible cells, floored at 1e-6).
    Returns the occupied share per expert."""
    occs = after["occs"]
    check(bool(torch.isfinite(occs).all()), "the occupancy update is not finite")
    check(bool((occs >= before["occs"] * occ_cfg.ema_decay).all()),
          "an updated cell fell below its decayed value")
    for k in range(occs.shape[0]):  # the update's own reduction, expert by expert
        flat = occs[k].reshape(occs.shape[1], -1)
        visible = flat >= 0.0
        mean = torch.sum(torch.where(visible, flat, 0.0)) / torch.clamp(
            torch.sum(visible), min=1)
        thre = torch.clamp(torch.clamp(mean, max=occ_cfg.occ_thre), min=1e-6)
        check(torch.equal(after["binaries"][k].reshape(flat.shape), flat > thre),
              f"expert {k}: binaries is not occs above the threshold")
    share = after["binaries"].float().mean(dim=(1, 2, 3, 4)).tolist()
    check(all(0.0 < x < 1.0 for x in share), f"occupied share per expert {share}")
    return share


def phase_regimes(torch, segscan, toy, Renderer, model_cpu, occ_cpu, profile_dir) -> dict:
    """The regime schedule of a run (module docstring, phase 6). Returns the
    scan's launch counts summed over the phase's steps and its frames."""
    from acn_tpu_torch.models import nn
    from acn_tpu_torch.occupancy import grid as occ_grid
    from acn_tpu_torch.pipelines.offline_stage import train_step as ts
    from acn_tpu_torch.pipelines.offline_stage import trainer as tr

    cfg, P, occ_cfg = toy.train_occ_config()
    K, T = cfg.num_submodules, int(P.batch_size)
    S, Q, I = int(P.support_rays), int(P.query_rays), int(P.inner_iter)
    rays_per_step = K * T * (I * S + Q)
    per_step = K * T * (I + 1)
    torch.cuda.empty_cache()
    model = toy.serving_model(cfg, seed=1, device="cuda")
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in toy.training_batch(K, T, S, Q, seed=1).items()}
    opt, state = toy.init_train_state(model, P)
    gen = torch.Generator(device="cuda").manual_seed(0)
    boxes, _ = toy.quadrant_layout(K)
    occ10 = toy.random_occ_states(boxes, occ_cfg, fill=0.10, seed=0, device="cuda")
    counted = {"fwd": 0, "rev": 0}
    hashed = [0, 0, 0, 0, 0]

    def steps(step, occ, n):
        """``n`` steps of ``step`` from the running state: (ms per step,
        ``_train_counts`` per step, the last metrics as numpy)."""
        nonlocal state
        ms, launches, metrics = [], [], None
        for _ in range(n):
            _zero_scan_counts(segscan)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch, occ, gen)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            launches.append(_train_counts(segscan))
            counted["fwd"] += launches[-1][0]
            counted["rev"] += launches[-1][1]
            hashed[:] = [a + b for a, b in zip(hashed, _kernel_counts())]
        m = {k: v.detach().cpu().numpy() for k, v in metrics.items()}
        check(all(np.isfinite(v).all() for v in m.values()), f"a metric is not finite: {m}")
        return ms, launches, m

    def summary(ms, launches, m, peak):
        return {"step_ms": ms, "rays_per_s": [rays_per_step / (1e-3 * t) for t in ms],
                "scan_and_composite_launches_per_step": launches, "peak_mem_mb": peak,
                "loss_total": float(m["loss_total"]), "occ_overflow": float(m["occ_overflow"])}

    # (a) the warm-up: stratified, no occupancy
    torch.cuda.reset_peak_memory_stats()
    step_strat = ts.make_meta_train_step(cfg, P, opt, None)
    ms, launches, m = steps(step_strat, tr.dummy_occ_states(K, "cuda"), 2)
    check(all(l == (0, 0, 0, 0) for l in launches),
          f"the stratified step launched scan or composite kernels {launches}, want none")
    strat = summary(ms, launches, m, torch.cuda.max_memory_allocated() / 1e6)
    emit({"phase": "regimes_stratified", "ray_samples": int(P.ray_samples), **strat})

    # (b) the occupancy update from the model after (a), twice (the second
    # is the EMA over the first)
    update = tr.make_occ_update_fn(cfg, occ_cfg)
    occ_upd = tr.init_occ_states(model.expert_aabbs, occ_cfg)
    torch.cuda.reset_peak_memory_stats()
    update_ms = []
    _zero_scan_counts(segscan)
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        before, occ_upd = occ_upd, update(model, occ_upd, generator=gen)
        torch.cuda.synchronize()
        update_ms.append(1e3 * (time.perf_counter() - t0))
        share = check_update_pass(torch, occ_cfg, before, occ_upd)
    upd_hash = note_hash("occ_update", trains=False)
    del before
    upd = {"update_ms": update_ms, "hash_launches": upd_hash,
           "cells_per_expert": int(occ_upd["occs"][0].numel()),
           "density_queries": int(occ_upd["occs"].numel()),
           "occupied_share_per_expert": share,
           "peak_mem_mb": torch.cuda.max_memory_allocated() / 1e6,
           "expert0_32cubed_card_vs_cpu": update_card_vs_cpu(
               torch, occ_grid, nn, cfg, occ_cfg, model)}
    emit({"phase": "regimes_occ_update", **upd})

    # (c) strided with the would-be overflow measured on bench.py's 10 %
    # grids and read by the auto switch: report budget 32 (the config's),
    # then 2 (which overflows, and so restarts the switch's count), then 32
    # three times, after which the switch must fire; a strided step on the
    # updated grids; the budget step after the switch
    budget = int(P.occ_budget_per_ray)
    ctl = tr.AutoRegime(float(P.occ_auto_thresh), int(P.occ_auto_patience))
    torch.cuda.reset_peak_memory_stats()
    step_auto = {b: ts.make_meta_train_step(cfg, P, opt, occ_cfg, budget_override=0,
                                            report_budget=b)
                 for b in (budget, 2)}
    schedule = [budget, 2, budget, budget, budget]
    readings, fired = [], []
    auto_ms, auto_launches = [], []
    for b in schedule:
        ms, launches, m = steps(step_auto[b], occ10, 1)
        auto_ms += ms
        auto_launches += launches
        readings.append(float(m["occ_overflow"]))
        fired.append(ctl.observe(readings[-1]))
    auto = summary(auto_ms, auto_launches, m, torch.cuda.max_memory_allocated() / 1e6)
    check(all(l == (0, 0, 0, 0) for l in auto_launches),
          f"the strided step launched scan or composite kernels {auto_launches}, want none")
    check([r > ctl.thresh for r in readings] == [b != budget for b in schedule],
          f"would-be overflow readings {readings} at report budgets {schedule}: want "
          f"above {ctl.thresh} at budget 2 only")
    check(fired == [False, False, False, False, True] and ctl.switched,
          f"AutoRegime fired {fired} on readings {readings}")
    ms, launches, m = steps(ts.make_meta_train_step(cfg, P, opt, occ_cfg, budget_override=0),
                            occ_upd, 1)
    check(launches == [(0, 0, 0, 0)],
          f"the strided step launched scan or composite kernels {launches}")
    on_updated = summary(ms, launches, m, None)
    ms, launches, m = steps(ts.make_meta_train_step(cfg, P, opt, occ_cfg), occ10, 1)
    check(launches == [budget_want(per_step)],
          f"the budget step after the switch launched {launches}, want "
          f"{budget_want(per_step)} (scans, composites)")
    after_switch = summary(ms, launches, m, None)
    check(state["step"] == 2 + len(schedule) + 2, f"the schedule took {state['step']} steps")
    note_hash("regime_schedule", True, tuple(hashed))
    # one float32 strided episode on the card against the CPU
    P32 = types.SimpleNamespace(**{**vars(P), "use_amp": False, "occ_budget_per_ray": 0})
    bnp = toy.training_batch(K, T, S, Q, seed=0)
    rays, rgbs = bnp["support_rays"][0, 0, :256], bnp["support_rgbs"][0, 0, :256]
    rand = occ_grid.draw_march(rays.shape[0], int(P.occ_s_max),
                               torch.Generator().manual_seed(7))
    n_tables = len(model_cpu.params()["experts"]["hash_table"])
    episode = check_card_vs_cpu_f32(
        torch, *(episode_loss_grads(torch, ts, nn, cfg, P32, occ_cfg, model_cpu, occ_cpu,
                                    rays, rgbs, on, rand) for on in ("cuda", "cpu")),
        n_tables, "strided episode")
    emit({"phase": "regimes_strided", "s_max": int(P.occ_s_max), "s_kept": int(P.occ_s_kept),
          "report_budgets": schedule, "auto": auto, "would_overflow_readings": readings,
          "auto_regime_fired": fired, "strided_on_updated_grids": on_updated,
          "budget_step_after_switch": after_switch,
          "strided_episode_card_vs_cpu": {"rays": int(rays.shape[0]), **episode}})

    if profile_dir:
        step_plain = ts.make_meta_train_step(cfg, P, opt, occ_cfg, budget_override=0)
        for name, step, occ in (("stratified_step", step_strat,
                                 tr.dummy_occ_states(K, "cuda")),
                                ("strided_step", step_plain, occ10)):
            prof, wall_ms, busy_ms, n_launch = profile_window(
                torch, lambda: step(state, batch, occ, gen), profile_dir, name)
            top = sorted(prof.key_averages(), key=lambda e: -(
                getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)))[:10]
            emit({"phase": f"{name}_profile", "step_wall_ms": wall_ms,
                  "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
                  "kernel_launches": n_launch,
                  "hash_kernels": hash_kernel_times(prof, busy_ms),
                  "top_ops_device_ms": {e.key[:60]: 1e-3 * (
                      getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0))
                      for e in top}})
    del state, opt, model, step_auto, step_strat

    # (d) the budget-0 renderer: the strided march, render_rays_occ; a warm
    # frame (downloaded and checked), then a timed frame left on the device,
    # as in phase 3
    P0 = types.SimpleNamespace(**{**vars(P), "occ_budget_per_ray": 0})
    model = toy.serving_model(cfg, seed=0, device="cuda")
    occ = toy.random_occ_states(boxes, occ_cfg, fill=0.10, seed=0, device="cuda")
    cam = toy.overhead_camera(H, W)
    _zero_scan_counts(segscan)
    phase_vs_cpu(torch, toy, Renderer, model, occ, cam, P=P0,
                 phase="budget0_render_rays_vs_cpu")
    renderer = Renderer(cfg, P0, occ_cfg)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _zero_hash_and_net()
    t0 = time.perf_counter()
    rgb, depth, acc = renderer.render_image(model, occ, H=H, W=W, **cam)
    warm_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    renderer.render_image(model, occ, H=H, W=W, download=False, **cam)
    frame_ms = 1e3 * (time.perf_counter() - t0)
    note_hash("budget0_frames", trains=False)
    check_packed("budget0_frames", _scan_counts(segscan), 0)
    check(rgb.shape == (H, W, 3) and np.isfinite(rgb).all() and np.isfinite(depth).all()
          and np.isfinite(acc).all(), "the budget-0 frame is not finite or misshapen")
    rows = renderer.chunk_rays // W
    emit({"phase": "budget0_frame", "H": H, "W": W, "rays_per_chunk": rows * W,
          "kept_samples_per_ray": renderer.s_kept, "chunks": -(-H // rows),
          "warm_frame_ms_with_download": warm_ms, "frame_ms": frame_ms,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "mean_acc": float(acc.mean()), "sigma_head_bias": 2.0})
    return counted


# ---------------------------------------------------------------- phase 7


# the phase-7 model's density, made to vary over the grid as a trained
# field's does: hash features ×3·10⁴ (from U(±1e-4)), the σ head's weights
# ×4 and its bias −4. At the init's scale σ is all but constant, half the
# cells sit above the grid's mean and every ray keeps ≈ 120 of 256 bins, so
# the would-be overflow at 32 per ray never clears 2 % and the switch never
# fires; with these (measured on the CPU at 64³ and a smaller table) about
# 7 % of the cells stay occupied, ≈ 17 bins per ray
LOOP_HASH_SCALE = 3e4
LOOP_SIGMA_GAIN = 4.0
LOOP_SIGMA_SHIFT = -4.0
LOOP_DIR = Path(__file__).resolve().parent / "logs" / "chip_smoke_loop"
LOOP_CAMERAS, LOOP_IMAGE = 8, (192, 256)  # per expert (32 before; cut for time); (H, W)
DEV = "cuda"


class _LoopProbe:
    """The loop's draws (``trainer.LoopDraws``, one generator on the card)
    with a mark at each point where the loop asks for them (a step, an
    update, an eval) and at the end: the time (after a synchronization when
    ``sync``), the scan counters and the host waits recorded so far."""

    def __init__(self, torch, tr, segscan, seed, sync, caught=None):
        self.torch, self.segscan, self.sync = torch, segscan, sync
        self.draws = tr.LoopDraws(seed, DEV)
        self.caught = caught if caught is not None else []
        self.marks = []

    def mark(self, what):
        if self.sync:
            self.torch.cuda.synchronize()
        self.marks.append((what, time.perf_counter(), _train_counts(self.segscan),
                           sum("synchroniz" in str(w.message) for w in self.caught)))

    def step(self):
        self.mark("step")
        return self.draws.step()

    def occ_update(self):
        self.mark("occ_update")
        return self.draws.occ_update()

    def occ_refresh(self):
        self.mark("occ_refresh")
        return self.draws.occ_refresh()

    def eval(self, n):
        self.mark("eval")
        return self.draws.eval(n)

    def per_step(self):
        """Per step: (ms from its mark to the next mark, ``_train_counts``
        and host waits from its mark to the next step's)."""
        steps = [i for i, m in enumerate(self.marks) if m[0] == "step"]
        bounds = steps[1:] + [len(self.marks) - 1]
        out = []
        for i, j in zip(steps, bounds):
            (_, t0, c0, s0), (_, t1, _, _) = self.marks[i], self.marks[i + 1]
            _, _, c1, s1 = self.marks[j]
            out.append({"ms": 1e3 * (t1 - t0),
                        "launches": tuple(b - a for a, b in zip(c0, c1)), "syncs": s1 - s0})
        return out

    def spans(self, what):
        """ms from each ``what`` mark to the next mark."""
        return [1e3 * (self.marks[i + 1][1] - m[1]) for i, m in enumerate(self.marks[:-1])
                if m[0] == what]


def loop_model(torch, toy, cfg, seed):
    model = toy.serving_model(cfg, seed=seed, device=DEV)
    experts = model.params()["experts"]
    with torch.no_grad():
        for t in experts["hash_table"]:
            t.mul_(LOOP_HASH_SCALE)
        experts["sigma_head"]["w"].mul_(LOOP_SIGMA_GAIN)
        experts["sigma_head"]["b"].add_(LOOP_SIGMA_SHIFT)
    return model


def check_sampler(torch, ts, pools, T, S, Q) -> dict:
    """The card's episode ids against the CPU's with the same draws (drawn
    on the CPU, then moved), and on generator draws: every ray real (far >
    near), support and query disjoint in every task; the sampler's time."""
    cpu_pools = {k: v.cpu() for k, v in pools.items()}
    draws = ts.draw_episodes(cpu_pools, T, torch.Generator().manual_seed(5))
    want = ts.episode_ray_ids(cpu_pools, draws, S, Q)
    got = ts.episode_ray_ids(pools, {k: v.to(DEV) for k, v in draws.items()}, S, Q)
    check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
          "the card's episode ids differ from the CPU's on the same draws")
    del cpu_pools
    sample = ts.make_device_batch_fn(T, S, Q)
    gen = torch.Generator(device=DEV).manual_seed(6)
    for _ in range(4):
        s_ids, q_ids = ts.episode_ray_ids(pools, ts.draw_episodes(pools, T, gen), S, Q)
        K = s_ids.shape[0]
        rays = pools["rays"][torch.arange(K, device=DEV)[:, None, None],
                             torch.cat([s_ids, q_ids], -1)]
        check(bool((rays[..., 7] > rays[..., 6]).all()), "a sampled ray is padding")
        inter = (s_ids[..., :, None] == q_ids[..., None, :]).any(-1).any(-1)
        check(not bool(inter.any()), "a task's support and query rays overlap")
    from acn_tpu_torch.scripts import bench_segscan
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if DEV == "cuda" else [])
    with profile(activities=activities) as prof:
        sample(pools, gen)
        torch.cuda.synchronize()
    # sample_ms: elapsed between events on the stream (a spin kernel queued
    # first); sample_busy_ms: the kernels' own device time in the profile
    return {"ids_card_vs_cpu": "equal",
            "sample_ms": bench_segscan.time_ms(lambda: sample(pools, gen), 20),
            "sample_busy_ms": 1e-3 * sum(e.time_range.elapsed_us() for e in prof.events()
                                         if e.device_type == DeviceType.CUDA),
            "sample_launches": sum(e.count for e in prof.key_averages()
                                   if e.key == "cudaLaunchKernel")}


def reload_exact(tck, run, tag, cfg, opt) -> None:
    """Load ``tag`` into the port and write it again: every file's bytes
    come back the same."""
    import tempfile

    payload = tck.load_checkpoint(run, tag)
    model, occ = tck.restore_model(payload, cfg, "cpu")
    optim = None
    if (run / f"{tag}.optim").exists():
        optim = tck.load_opt_state(run, tag, opt.init(model.params()), opt)
    with tempfile.TemporaryDirectory(dir=LOOP_DIR) as d:
        tck.save_checkpoint(d, tag, model, opt_state=optim, occ_states=occ,
                            step=payload["step"], best=payload["best"], optimizer=opt)
        for suffix in (".model", ".optim"):
            if (run / f"{tag}{suffix}").exists():
                check((Path(d) / f"{tag}{suffix}").read_bytes()
                      == (run / f"{tag}{suffix}").read_bytes(),
                      f"{tag}{suffix} does not reload bit for bit")


def phase_training_run(torch, segscan, toy, step_syncs) -> dict:
    """The training loop at full width (module docstring, phase 7). Returns
    the scan's launch counts over both runs."""
    import shutil

    from acn_tpu_torch.data import tasks
    from acn_tpu_torch.data.ram_rays import RamRaysDataset
    from acn_tpu_torch.models import nn
    from acn_tpu_torch.pipelines.offline_stage import train_step as ts
    from acn_tpu_torch.pipelines.offline_stage import trainer as tr
    from acn_tpu_torch.runner import premark_occ_states
    from acn_tpu_torch.utils import checkpoint as tck
    from acn_tpu_torch.utils.config import load_checkpoint_cfg
    from acn_tpu_torch.utils.logging import Logger

    cfg, P, occ_cfg = toy.train_occ_config()
    occ_cfg = dataclasses.replace(occ_cfg, warmup_steps=3, update_interval=2)
    P.occ_warmup, P.occ_auto_patience, P.print_step = 3, 2, 1
    P.eval_step, P.max_test_tasks, P.save_step, P.outer_steps = 4, 1, 6, 12
    K, T = cfg.num_submodules, int(P.batch_size)
    S, Q, I = int(P.support_rays), int(P.query_rays), int(P.inner_iter)
    per_step = K * T * (I + 1)
    rays_per_step = K * T * (I * S + Q)
    torch.cuda.empty_cache()
    shutil.rmtree(LOOP_DIR, ignore_errors=True)
    LOOP_DIR.mkdir(parents=True)

    t0 = time.perf_counter()
    H_img, W_img = LOOP_IMAGE
    data = toy.camera_ray_stores(K, cams=LOOP_CAMERAS, H=H_img, W=W_img, seed=0, device=DEV)
    boxes, _ = toy.quadrant_layout(K)
    stores = [RamRaysDataset.from_arrays(*st) for st in data["stores"]]
    train = [tasks.TaskSampler(ds, boxes[k], int(P.cell_dim), S, Q, seed=int(P.seed) + k,
                               route_cache=None) for k, ds in enumerate(stores)]
    test = tasks.MultiTaskSampler([
        tasks.TaskSampler(ds, boxes[k], int(P.cell_dim), S, Q, seed=int(P.seed) + 1000 + k,
                          route_cache=None) for k, ds in enumerate(stores)])
    pools_np = tasks.build_device_pools(train, seed=int(P.seed))
    pools = ts.pools_to_device(pools_np, DEV)
    del pools_np
    occ0 = premark_occ_states(occ_cfg, boxes, data["intrinsics"], data["c2w"], data["W"],
                              data["H"], float(P.near), device=DEV)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    n_rays = [len(ds) for ds in stores]
    check(n_rays == [LOOP_CAMERAS * H_img * W_img] * K, f"rays per expert {n_rays}")
    check(all(bool((ds.rays[:, 7] > ds.rays[:, 6]).all()) for ds in stores),
          "a camera ray misses its expert's box")
    premarked = float((occ0["occs"] < 0).float().mean())
    sampler = check_sampler(torch, ts, pools, T, S, Q)
    del data, stores

    # the run: 12 steps from step 0
    model = loop_model(torch, toy, cfg, seed=2)
    opt, state = toy.init_train_state(model, P)
    logger = Logger("run", logs_root=str(LOOP_DIR))
    probe = _LoopProbe(torch, tr, segscan, int(P.seed), sync=True)
    _zero_scan_counts(segscan)
    torch.cuda.reset_peak_memory_stats()
    out = tr.meta_trainer(P, cfg, state, opt, None, test, logger, occ_cfg=occ_cfg,
                          occ_states=occ0, device_pools=pools, draws=probe, device=DEV)
    probe.mark("end")
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    logger.close()
    launches = _scan_counts(segscan)
    note_hash("meta_trainer", True, net="any")
    rec = out["loop"]
    steps = probe.per_step()
    regimes = [s["regime"] for s in rec["steps"]]
    check(len(steps) == len(regimes) == 12, f"{len(steps)} steps, want 12")
    first = {r: regimes.index(r) for r in ("stratified", "strided", "budget") if r in regimes}
    check(regimes[:3] == ["stratified"] * 3 and "strided" in first and "budget" in first
          and first["strided"] < first["budget"] == rec["switched_at"]
          and regimes[first["budget"]:] == ["budget"] * (12 - first["budget"]),
          f"regimes {regimes}, switched after step {rec['switched_at']}")
    for r, s in zip(regimes, steps):
        want = budget_want(per_step) if r == "budget" else (0, 0, 0, 0)
        check(s["launches"] == want, f"a {r} step launched scan and composite kernels "
              f"{s['launches']}, want {want}")
    overflow = [float(x["metrics"]["occ_overflow"]) for x in rec["steps"]]
    for x in rec["steps"]:
        check(all(np.isfinite(v).all() for v in x["metrics"].values()),
              f"a metric of step {x['step']} is not finite")
    run = logger.logdir
    for tag in ("best", "step6", "step12", "last"):
        check((run / f"{tag}.model").exists(), f"{tag}.model was not written")
    # each save of the port read back and written again gives its bytes
    for tag in ("best", "step6", "last"):
        reload_exact(tck, run, tag, cfg, opt)
    got, occ_last = tck.restore_model(tck.load_checkpoint(run, "last"), cfg, "cpu")
    nn.tree_map(lambda a, b: check(torch.equal(a, b.cpu()), "last.model differs from the run"),
                got.params(), model.params())
    check(all(torch.equal(occ_last[k], out["occ_states"][k].cpu()) for k in occ_last),
          "last.model's grids differ from the run's")
    share = out["occ_states"]["binaries"].float().mean(dim=(1, 2, 3, 4)).tolist()
    by_regime = {}
    for r, s in zip(regimes, steps):
        by_regime.setdefault(r, []).append(s["ms"])
    emit({"phase": "training_run", "K": K, "T": T, "support_rays": S, "query_rays": Q,
          "inner_iter": I, "rays_per_expert": n_rays[0], "cameras_per_expert": LOOP_CAMERAS,
          "pool_shape": list(pools["pool_idx"].shape), "premarked_invisible": premarked,
          "data_s": data_s, **sampler, "regimes": regimes,
          "switched_after_step": rec["switched_at"], "occ_overflow": overflow,
          "step_ms": by_regime,
          "rays_per_s": {r: [rays_per_step / (1e-3 * t) for t in v] for r, v in by_regime.items()},
          "update_ms": probe.spans("occ_update"), "eval_ms": probe.spans("eval"),
          "eval_psnr": rec["eval_psnr"], "save_hold_ms": rec["save_ms"],
          "peak_mem_mb": peak_mb, "occupied_share": share,
          "scan_launches": {"forward": launches[0], "reverse": launches[1]},
          "loss_total": [float(x["metrics"]["loss_total"]) for x in rec["steps"]]})
    del out, state, model, probe

    # the resume from step6: the saved state exactly, then two steps; every
    # second step logs, so step 7 reads nothing back and waits for the card
    # no more than a bare budget step does (phase 5)
    payload = tck.load_checkpoint(run, "step6")
    model, occ = tck.restore_model(payload, cfg, DEV)
    P2 = types.SimpleNamespace(**load_checkpoint_cfg(str(run / "step6.P.json")))
    P2.outer_steps, P2.print_step = 8, 2
    opt2, state2 = toy.init_train_state(model, P2)
    state2["opt_state"] = tck.load_opt_state(run, "step6", state2["opt_state"], opt2)
    state2["step"] = payload["step"]
    switched = rec["switched_at"] is not None and rec["switched_at"] <= 6
    check(payload["step"] == 6 and payload["best"] == rec["eval_psnr"][0][1]
          and int(state2["opt_state"]["count"]) == 6
          and (P2.occ_regime == "budget") == switched,
          f"the resume state: step {payload['step']}, best {payload['best']}, count "
          f"{int(state2['opt_state']['count'])}, occ_regime {P2.occ_regime}")
    logger = Logger("run", logs_root=str(LOOP_DIR))
    _zero_scan_counts(segscan)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            probe = _LoopProbe(torch, tr, segscan, 1, sync=False, caught=caught)
            out = tr.meta_trainer(P2, cfg, state2, opt2, None, test, logger, occ_cfg=occ_cfg,
                                  occ_states=occ, start_step=payload["step"],
                                  best=payload["best"], device_pools=pools, draws=probe,
                                  device=DEV)
            probe.mark("end")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    logger.close()
    resumed = probe.per_step()
    rec2 = out["loop"]
    check([x["step"] for x in rec2["steps"]] == [7, 8]
          and all(x["regime"] == ("budget" if switched else x["regime"]) for x in rec2["steps"]),
          f"the resumed run's steps {rec2['steps']}")
    if switched:
        check(all(s["launches"] == budget_want(per_step) for s in resumed),
              f"resumed budget steps launched {[s['launches'] for s in resumed]}")
    check(resumed[0]["syncs"] <= step_syncs,
          f"the non-log step 7 waited for the card {resumed[0]['syncs']} times, a bare "
          f"step {step_syncs}")
    check((logger.logdir / "last.model").exists(), "the resumed run wrote no last.model")
    emit({"phase": "training_resume", "from": "step6", "start_step": payload["step"],
          "best": payload["best"], "opt_count": 6, "occ_regime": P2.occ_regime,
          "steps": [x["step"] for x in rec2["steps"]],
          "step_ms_no_sync": [s["ms"] for s in resumed],
          "host_syncs_non_log_step": resumed[0]["syncs"], "host_syncs_bare_step": step_syncs,
          "scan_and_composite_launches_per_step": [s["launches"] for s in resumed]})
    total = _scan_counts(segscan)
    note_hash("meta_trainer", True, net="any")
    del out, state2, model, pools
    shutil.rmtree(LOOP_DIR, ignore_errors=True)
    return {"fwd": launches[0] + total[0], "rev": launches[1] + total[1]}


# ---------------------------------------------------------------- phase 8


RUNNER_DIR = Path(__file__).resolve().parent / "logs" / "chip_smoke_runner"
RUNNER_CAMERAS, RUNNER_IMAGE = (16, 8), (192, 256)  # (train, val) cameras (32 train before); (H, W)
RUNNER_STEPS = 6  # 8 before, cut for the smoke's time: the switch, step4 and last remain
RUNNER_TTO = "0,2,0"
TTO_CHECK_RAYS = 1024


def _run_flags(config, *flags):
    return ["--configPath", str(Path(__file__).resolve().parent / "configs" / config),
            "--data_path", str(RUNNER_DIR / "data"), *flags]


def tto_step_card_vs_cpu(torch, trt, tck, nn, toptim, tcont, cfg, occ_cfg, P, run, md,
                         gaabb) -> dict:
    """One float32 TTO step of the run's ``last`` state on 1,024 rays of a
    validation view, with one set of injected draws, on the card against
    the CPU: the loss rtol 1e-5; the clipped gradient (the optimizer's first
    moment over 1 − β1) atol 1e-6 with rtol 1e-3 on the tables and 1e-4 on
    the MLPs (cuBLAS sums in another order; the table gradient is a
    scatter-add with atomics); the parameters after the step atol 1e-6 /
    rtol 1e-4 where the gradient is at least 1e-6 (the first Adam step is
    lr·g/(|g| + 1e-8), so below that the gradient's rounding is most of
    the update, and the gradient alone is held there)."""
    from acn_tpu_torch.data.ram_rays import RamRaysDataset

    store = RamRaysDataset([md], aabb=gaabb, near_far_override=(P.near, P.far), num_workers=1)
    rays, rgbs, _ = store.sample(np.random.default_rng(0), TTO_CHECK_RAYS)
    gen = torch.Generator().manual_seed(9)
    rand = (torch.rand((TTO_CHECK_RAYS, int(P.occ_s_max)), generator=gen),
            torch.randint(0, 1 << 30, (TTO_CHECK_RAYS,), generator=gen))
    out = {}
    for dev in ("cuda", "cpu"):
        model, occ = tck.restore_model(tck.load_checkpoint(run, "last"), cfg, dev)
        opt = toptim.build_optimizer(P, tcont.param_group_labels(model.params()), grad_clip=1.0)
        step = trt.make_tto_step(cfg, P, opt, occ_cfg, use_occ=True)
        _zero_hash_and_net()
        t0 = time.perf_counter()
        state, loss = step(model, opt.init(model.params()), occ,
                           torch.from_numpy(rays).to(dev), torch.from_numpy(rgbs).to(dev),
                           tuple(x.to(dev) for x in rand))
        loss = float(loss)
        if dev == "cuda":
            note_hash("tto_step", True)
        out[dev] = (loss, nn.tree_leaves(model.params()), nn.tree_leaves(state["mu"]),
                    1e3 * (time.perf_counter() - t0))
        del model, occ, state
    (lg, pg, mg, ms), (lc, pc, mc, cpu_ms) = out["cuda"], out["cpu"]
    check(np.isfinite(lg) and abs(lg - lc) <= 1e-5 * abs(lc),
          f"TTO step loss: card {lg}, CPU {lc}")
    n_tables = cfg.expert.hash.levels
    err = {"grad_table": 0.0, "grad_mlp": 0.0, "param": 0.0}
    for i, (a, b, ma, mb) in enumerate(zip(pg, pc, mg, mc)):
        kind = "table" if i < n_tables else "mlp"
        ga, gb = ma.cpu() / 0.1, mb / 0.1
        err[f"grad_{kind}"] = max(err[f"grad_{kind}"], float((ga - gb).abs().max()))
        check(torch.allclose(ga, gb, atol=1e-6, rtol=1e-3 if kind == "table" else 1e-4),
              f"TTO step gradient leaf {i} ({kind}): card vs CPU max |diff| "
              f"{float((ga - gb).abs().max())}")
        big = gb.abs() >= 1e-6
        if not bool(big.any()):
            continue
        a, b = a.detach().cpu()[big], b.detach()[big]
        err["param"] = max(err["param"], float((a - b).abs().max()))
        check(torch.allclose(a, b, atol=1e-6, rtol=1e-4),
              f"TTO step parameter leaf {i}: card vs CPU max |diff| {float((a - b).abs().max())}")
    return {"rays": TTO_CHECK_RAYS, "loss_card": lg, "loss_cpu": lc, "step_ms_card": ms,
            "step_ms_cpu": cpu_ms, **{f"max_abs_err_{k}": v for k, v in err.items()}}


def metrics_card_vs_cpu(torch, tlosses, LPIPS, pred, gt) -> dict:
    """SSIM and LPIPS (fallback weights) of one rendered view and its gt, on
    the card against the CPU: SSIM atol 1e-4 and inside [-1, 1] to a float32
    ulp, LPIPS rtol 1e-4. cuDNN sums its convolutions in another order (TF32
    is off), and SSIM's variances E[x²] − μ² cancel terms of ≈ 0.1–0.3 down
    to ≈ 1e-3, so a float32 rounding of the blurred terms shows at ≈ 1e-5
    in SSIM. Also SSIM on the card of a nearly constant image against
    itself, the case that leaves [-1, 1] where the blur's sums lose their
    precision: 1 to a float32 ulp (a mean of window ratios that are all 1
    may round an ulp past it)."""
    out = {}
    for dev in ("cuda", "cpu"):
        p, g = torch.from_numpy(pred).to(dev), torch.from_numpy(gt).to(dev)
        out[dev] = (float(tlosses.ssim(p, g)), LPIPS(device=dev)(pred, gt))
    (sg, lg), (sc, lc) = out["cuda"], out["cpu"]
    check(abs(sg) <= 1.0 + 1e-6 and abs(sg - sc) <= 1e-4, f"SSIM: card {sg}, CPU {sc}")
    check(np.isfinite(lg) and abs(lg - lc) <= 1e-4 * abs(lc), f"LPIPS: card {lg}, CPU {lc}")
    flat = torch.from_numpy(
        (0.5 + 1e-4 * np.random.default_rng(0).random(pred.shape)).astype(np.float32)).cuda()
    sf = float(tlosses.ssim(flat, flat))
    check(abs(sf - 1.0) <= 1e-6, f"SSIM of a nearly constant image against itself: {sf}")
    return {"ssim_card": sg, "ssim_cpu": sc, "ssim_flat_self_card": sf,
            "lpips_fallback_card": lg, "lpips_fallback_cpu": lc}


def phase_runner(torch, segscan, toy) -> dict:
    """The runner at full width on a dataset on disk (module docstring,
    phase 8). Returns the scan's launch counts of the train and eval runs,
    and the train run's directory, which phases 9 and 12 read; phase 12
    removes it."""
    import shutil

    from acn_tpu_torch import runner
    from acn_tpu_torch.data import dataset, tasks
    from acn_tpu_torch.models import container as tcont
    from acn_tpu_torch.models import nn
    from acn_tpu_torch.models.lpips import LPIPS
    from acn_tpu_torch.nerfs import losses as tlosses
    from acn_tpu_torch.pipelines.offline_stage import trainer as tr
    from acn_tpu_torch.pipelines.online_stage import runtime_adapt as trt
    from acn_tpu_torch.pipelines.renderer import Renderer
    from acn_tpu_torch.utils import checkpoint as tck
    from acn_tpu_torch.utils import optim as toptim
    from acn_tpu_torch.utils.config import parse_args

    torch.cuda.empty_cache()
    shutil.rmtree(RUNNER_DIR, ignore_errors=True)
    # (a) the dataset; the run builds its ray stores and routes afresh
    t0 = time.perf_counter()
    n_train, n_val = RUNNER_CAMERAS
    toy.write_dataset_dir(RUNNER_DIR / "data", K=4, train_cams=n_train, val_cams=n_val,
                          H=RUNNER_IMAGE[0], W=RUNNER_IMAGE[1])
    write_s = time.perf_counter() - t0
    saved = (dataset.RAY_CACHE, tasks.ROUTE_CACHE, runner.build_occ_config, tr.LoopDraws)
    dataset.RAY_CACHE, tasks.ROUTE_CACHE = RUNNER_DIR / "rays", RUNNER_DIR / "routes"
    # the grids rebuilt every 2 steps (a constant of the runner, no flag)
    runner.build_occ_config = lambda P, psf: dataclasses.replace(
        saved[2](P, psf), update_interval=2)
    probes = []

    def probe(seed, device):
        probes.append(_LoopProbe(torch, types.SimpleNamespace(LoopDraws=saved[3]), segscan,
                                 seed, sync=True))
        return probes[-1]

    tr.LoopDraws = probe
    run = RUNNER_DIR / "train"
    try:
        # (b) --op train: configs/train_occ.json cut to 8 steps
        _zero_scan_counts(segscan)
        t0 = time.perf_counter()
        out = runner.main(_run_flags(
            "train_occ.json", "--fname", str(run),
            "--outer_steps", str(RUNNER_STEPS), "--occ_warmup", "2", "--occ_auto_patience", "1",
            "--eval_step", "4", "--save_step", "4", "--print_step", "1",
            "--num_workers", "1"))
        probes[-1].mark("end")
        train_s = time.perf_counter() - t0
        train_launches = _scan_counts(segscan)
        note_hash("runner_train", True, net="any")
        # (c) --op eval on its last save, TTO 0, 2, 0
        _zero_scan_counts(segscan)
        t0 = time.perf_counter()
        res = runner.main(_run_flags(
            "eval.json", "--checkpoint_path", str(run), "--prefix", "last", "--tto",
            RUNNER_TTO, "--test_batch_size", "4", "--fname", str(RUNNER_DIR / "eval")))
        eval_s = time.perf_counter() - t0
        eval_launches, eval_comp = _scan_counts(segscan), _comp_fwd()
        note_hash("runner_eval", True, net="serves")
    finally:
        dataset.RAY_CACHE, tasks.ROUTE_CACHE, runner.build_occ_config, tr.LoopDraws = saved
    steps = probes[-1].per_step()
    rec = out["loop"]
    regimes = [x["regime"] for x in rec["steps"]]
    K, T, I = 4, 3, 8
    per_step = K * T * (I + 1)
    check(len(steps) == len(regimes) == RUNNER_STEPS,
          f"the runner's probe saw {len(steps)} steps and the loop logged {len(regimes)}, "
          f"want {RUNNER_STEPS}")
    check(regimes[:2] == ["stratified"] * 2 and "budget" in regimes
          and regimes[regimes.index("budget"):] == ["budget"] * (
              RUNNER_STEPS - regimes.index("budget")),
          f"runner regimes {regimes}, switched after step {rec['switched_at']}")
    for r, st in zip(regimes, steps):
        want = budget_want(per_step) if r == "budget" else (0, 0, 0, 0)
        check(st["launches"] == want, f"a {r} step of the runner launched {st['launches']}, "
              f"want {want}")
    for x in rec["steps"]:
        check(all(np.isfinite(v).all() for v in x.get("metrics", {}).values()),
              f"a metric of runner step {x['step']} is not finite")
    for tag in ("last", "step4"):
        payload = tck.load_checkpoint(run, tag)
        check(payload["occ_states"] is not None and (run / f"{tag}.optim").exists(),
              f"{tag} was saved without its grids or optimizer")
    by_regime = {}
    for r, st in zip(regimes, steps):
        by_regime.setdefault(r, []).append(st["ms"])
    emit({"phase": "runner_train", "images": {"train": n_train, "val": n_val},
          "image_hw": list(RUNNER_IMAGE), "write_dataset_s": write_s,
          "rays_s": out["setup_s"]["rays"], "route_s": out["setup_s"]["route"],
          "train_rays_per_expert": out["setup_s"]["train_rays"],
          "main_s": train_s, "regimes": regimes, "switched_after_step": rec["switched_at"],
          "step_ms": by_regime, "update_ms": probes[-1].spans("occ_update"),
          "eval_psnr": rec["eval_psnr"],
          "scan_and_composite_launches_per_step": [st["launches"] for st in steps],
          "scan_launches": {"forward": train_launches[0], "reverse": train_launches[1]}})

    # the eval: scan launches, scores, the reset between settings
    # the eval's config; near and far need no normalizing (pose scale 1)
    P = parse_args(_run_flags("eval.json", "--checkpoint_path", str(run),
                              "--prefix", "last"))
    masks = RUNNER_DIR / "data" / "out" / "example" / "masks" / P.mask_dirname
    cfg = runner.build_model_configs(P, dataset.load_clustering_meta(masks))
    occ_cfg = runner.build_occ_config(P, 1.0)
    gaabb = dataset.load_scene_boxes(masks)[0]
    rows = max(Renderer(cfg, P, occ_cfg, device="cuda").chunk_rays // RUNNER_IMAGE[1], 1)
    chunks = -(-RUNNER_IMAGE[0] // rows)
    ttos = [int(t) for t in RUNNER_TTO.split(",")]
    # the composite kernel once a chunk of every frame: chunks × views ×
    # settings; its TTO steps composite no packed samples
    check_packed("runner_eval", eval_launches, chunks * n_val * len(ttos), eval_comp)
    for r in res:
        for v in r["views"]:
            check(np.isfinite(v["psnr"]) and abs(v["ssim"]) <= 1.0 + 1e-6,
                  f"tto={r['tto']}: PSNR {v['psnr']}, SSIM {v['ssim']}")
        check(np.isfinite(r["tto_losses"]).all(), f"tto={r['tto']}: losses {r['tto_losses']}")
    scores = lambda r: [(v["psnr"], v["ssim"]) for v in r["views"]]
    check(scores(res[0]) == scores(res[2]), "the two tto=0 legs differ: the base weights "
          "were not restored")
    batches = -(-n_val // 4)
    tto_steps = sum(t * batches for t in ttos)
    emit({"phase": "runner_eval", "tto": ttos, "views": n_val, "chunks_per_frame": chunks,
          "main_s": eval_s, "psnr": [r["psnr"] for r in res], "ssim": [r["ssim"] for r in res],
          "tto_losses": [r["tto_losses"] for r in res],
          "frame_ms": [v["frame_ms"] for r in res for v in r["views"]],
          "ssim_ms": [v["ssim_ms"] for r in res for v in r["views"]],
          "tto_step_ms": 1e3 * sum(r["adapt_s"] for r in res) / max(tto_steps, 1),
          "composite_launches": eval_comp,
          "scan_launches": {"forward": eval_launches[0], "reverse": eval_launches[1]},
          "tto0_legs_equal": True})

    # (d) card against CPU: a TTO step, and SSIM and LPIPS of one view
    md = dataset.get_image_metadata(RUNNER_DIR / "data" / "out" / "example", P.downscale)[1][0]
    tto = tto_step_card_vs_cpu(torch, trt, tck, nn, toptim, tcont, cfg, occ_cfg, P, run, md,
                               gaabb)
    model, occ = tck.restore_model(tck.load_checkpoint(run, "last"), cfg, "cuda")
    rgb, _, _ = Renderer(cfg, P, occ_cfg, device="cuda").render_image(
        model, occ, H=md.H, W=md.W, intrinsics=md.intrinsics, c2w=md.c2w, aabb=gaabb,
        near_far_override=(P.near, P.far))
    met = metrics_card_vs_cpu(torch, tlosses, LPIPS, rgb, md.load_image().astype(np.float32)
                              / 255.0)
    del model, occ
    emit({"phase": "runner_vs_cpu", "tto_step": tto, **met})
    return {"train": train_launches, "eval": eval_launches, "run": run}


# ---------------------------------------------------------------- phase 9


SERVE_SMALL = (64, 96)  # the card-against-CPU frames
BAKE_RES = 256  # --bake_resolution's default of 512, cut for the smoke's time
BAKE_CHECK_RES = 24
VIDEO_FRAMES = 4  # 8 before, cut for the smoke's time
ROUTED_ATOL = 0.02  # tests/test_renderer_routed.py:50-68, rgb and acc


def _frames_vs_cpu(got, want, what) -> dict:
    """u8 rgb within one step, f16 depth and acc within rtol 1e-3 (atol
    1e-3): card against CPU."""
    errs = {k: float(np.abs(np.asarray(g) - np.asarray(w)).max())
            for k, g, w in zip(("rgb", "depth", "acc"), got, want)}
    check(np.isfinite(got[0]).all() and errs["rgb"] <= 1.0 / 255 + 1e-6
          and all(np.allclose(g, w, rtol=1e-3, atol=1e-3) for g, w in zip(got[1:], want[1:])),
          f"{what}: card vs CPU frames disagree {errs}")
    return errs


def _timed(torch, fn, n: int) -> list:
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def _gif_or_mp4_frames(path: str, fps: int = 30) -> int:
    """Frames in a written video: a GIF's total duration over one frame's
    (Pillow merges identical neighbours), an MP4's frames through imageio."""
    if path.endswith(".gif"):
        from PIL import Image

        # a merged frame lasts k frames' time, stored in whole centiseconds
        d = max(int(1000 / fps), 20)
        with Image.open(path) as im:
            n = 0
            for i in range(im.n_frames):
                im.seek(i)
                n += round(im.info["duration"] / d)
        return n
    import imageio.v3 as iio

    return int(iio.imread(path).shape[0])


def _profile_frame(torch, fn, profile_dir, name) -> None:
    """One frame under the profiler: its busy and idle share and the ops
    that took most of the card's time."""
    prof, wall_ms, busy_ms, launches = profile_window(torch, fn, profile_dir, name)
    top = sorted(prof.key_averages(), key=lambda e: -(
        getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)))[:12]
    emit({"phase": f"{name}_profile", "frame_wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "idle_share": 1.0 - busy_ms / wall_ms, "kernel_launches": launches,
          "hash_kernels": hash_kernel_times(prof, busy_ms),
          "ngp_net_kernel": net_kernel_times(prof, busy_ms),
          "top_ops_device_ms": {e.key[:60]: 1e-3 * (
              getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0))
              for e in top}})


def phase_serving(torch, segscan, toy, model, occ, dense_ms, run, profile_dir) -> dict:
    """Routed, single-expert and baked serving, the bake, and the runner's
    baked eval and video (module docstring, phase 9), on phase 3's model and
    grids (with phase 4's σ-head bias of +2) and phase 8's run. Returns the
    scan's launch counts of each path. With ``profile_dir``, a routed and a
    baked frame are profiled too."""
    import shutil

    from acn_tpu_torch import runner
    from acn_tpu_torch.occupancy import grid as occ_grid
    from acn_tpu_torch.pipelines import baking
    from acn_tpu_torch.pipelines.renderer import Renderer, _pinhole_block_rays

    t_phase = time.perf_counter()
    cfg, P, occ_cfg = toy.train_occ_config()
    boxes, _ = toy.quadrant_layout(cfg.num_submodules)
    cam = toy.overhead_camera(H, W)
    renderer = Renderer(cfg, P, occ_cfg)
    counted = {}
    torch.cuda.empty_cache()

    # (a) routed frames: one warm, two timed, one downloaded
    rects = renderer.routed_rects(boxes, cam["c2w"], cam["intrinsics"], H, W, 32)
    plan = renderer.routed_dispatch(rects, W, True)
    routed = lambda **kw: renderer.render_image_routed(model, occ, H=H, W=W, **cam, **kw)
    _zero_scan_counts(segscan)
    torch.cuda.synchronize()
    warm = _timed(torch, lambda: routed(download=False), 1)
    frame_ms = _timed(torch, lambda: routed(download=False), 2)
    t0 = time.perf_counter()
    rgb, depth, acc = routed()
    e2e_ms = 1e3 * (time.perf_counter() - t0)
    counted["routed_frames"] = _scan_counts(segscan)
    routed_comp = _comp_fwd()
    note_hash("routed_frames", trains=False)
    check_packed("routed_frames (4 frames)", counted["routed_frames"], 4 * len(plan))
    check(rgb.shape == (H, W, 3) and np.isfinite(rgb).all() and np.isfinite(depth).all()
          and np.isfinite(acc).all(), "the routed frame is not finite or misshapen")
    if profile_dir:
        _profile_frame(torch, lambda: routed(download=False), profile_dir, "serving_routed")
    # identical experts: the routed frame reproduces the dense one
    tied, tied_occ = toy.identical_experts(model), toy.identical_occ(occ)
    dense = renderer.render_image(tied, tied_occ, H=H, W=W, **cam)
    rt = renderer.render_image_routed(tied, tied_occ, H=H, W=W, expert_aabbs=boxes, **cam)
    tie_err = {k: float(np.abs(a - b).max()) for k, a, b in
               zip(("rgb", "depth", "acc"), rt, dense)}
    check(tie_err["rgb"] <= ROUTED_ATOL and tie_err["acc"] <= ROUTED_ATOL,
          f"routed vs dense with identical experts: {tie_err}")
    del tied, tied_occ, dense, rt
    h, w = SERVE_SMALL
    cam_s = toy.overhead_camera(h, w)
    # the CPU twin of the model as phase 4 left it (σ-head bias +2)
    model_cpu = toy.serving_model(cfg, seed=0, device="cpu")
    model_cpu.load_state_dict(model.state_dict())
    occ_cpu = {k: v.cpu() for k, v in occ.items()}
    small = _frames_vs_cpu(
        renderer.render_image_routed(model, occ, H=h, W=w, **cam_s),
        Renderer(cfg, P, occ_cfg, device="cpu").render_image_routed(
            model_cpu, occ_cpu, H=h, W=w, **cam_s), "routed 64×96")
    emit({"phase": "serving_routed", "H": H, "W": W,
          "rects": [[int(v) for v in r] for r in rects],
          "chunks_per_frame": len(plan),
          "rays_per_chunk": [p[4] * p[5] for p in plan[:1]][0],
          "warm_frame_ms": warm[0], "frame_ms": frame_ms,
          "mean_frame_ms": statistics.mean(frame_ms), "frame_ms_with_download": e2e_ms,
          "dense_frame_ms_phase3": dense_ms,
          "routed_over_dense": statistics.mean(frame_ms) / statistics.mean(dense_ms),
          "composite_launches": routed_comp,
          "scan_launches": {"forward": counted["routed_frames"][0],
                            "reverse": counted["routed_frames"][1]},
          "identical_experts_vs_dense_max_err": tie_err, "atol": ROUTED_ATOL,
          "card_vs_cpu_64x96_max_err": small, "mean_acc": float(acc.mean())})

    # (b) single-expert frames: budget 32, budget 0, and the range pre-pass
    rows = max(renderer.chunk_rays // W, 1)
    P0 = types.SimpleNamespace(**{**vars(P), "occ_budget_per_ray": 0})
    Pc = types.SimpleNamespace(**{**vars(P), "occ_render_s_coarse": 32})
    single = {}
    for name, Pk in (("budget", P), ("budget0", P0), ("coarse32", Pc)):
        r = Renderer(cfg, Pk, occ_cfg)
        chunks = -(-H // max(r.chunk_rays // W, 1))
        _zero_scan_counts(segscan)
        ms = [_timed(torch, lambda k=k: r.render_image(model, occ, H=H, W=W, active_module=k,
                                                      download=False, **cam), 1)[0]
              for k in range(cfg.num_submodules)]
        counted[f"single_expert_{name}"] = got = _scan_counts(segscan)
        note_hash(f"single_expert_{name}", trains=False)
        want = 0 if name == "budget0" else chunks * cfg.num_submodules
        check_packed(f"single_expert_{name}", got, want)
        single[name] = {"frame_ms_by_expert": ms, "chunks_per_frame": chunks,
                        "composite_launches": want,
                        "scan_launches": {"forward": got[0], "reverse": got[1]}}
    rays = _pinhole_block_rays(H, W, *(torch.as_tensor(np.asarray(cam[k], np.float32),
                                                       device="cuda")
                                       for k in ("c2w", "intrinsics", "aabb")),
                               torch.tensor([-np.inf, np.inf], device="cuda"), 0.0, 0.0)
    near, far = occ_grid.clamped_near_far(rays, occ_cfg)
    ok = far > near
    tight = []
    for k in range(cfg.num_submodules):
        n2, f2 = occ_grid.coarse_ray_range({n: v[k] for n, v in occ.items()}, rays[:, :3],
                                           rays[:, 3:6], near, far, 32)
        tight.append(float(((f2 - n2)[ok] / (far - near)[ok]).mean()))
    emit({"phase": "serving_single_expert", **single,
          "coarse_range_mean_kept_fraction_by_expert": tight})

    # (c) the bake of phase 8's last through the runner, timed
    saved, save_s = [], []
    save_baked = baking.save_baked

    def recording_save(path, baked):
        saved.append(baked)
        t0 = time.perf_counter()
        save_baked(path, baked)
        save_s.append(time.perf_counter() - t0)

    baking.save_baked = recording_save
    try:
        _zero_scan_counts(segscan)
        t0 = time.perf_counter()
        path = runner.main(_run_flags(
            "eval.json", "--op", "bake", "--checkpoint_path", str(run), "--prefix", "last",
            "--bake_resolution", str(BAKE_RES), "--fname", str(RUNNER_DIR / "bake")))
        bake_s = time.perf_counter() - t0
    finally:
        baking.save_baked = save_baked
    note_hash("runner_bake", trains=False)
    asset = baking.load_baked(path)
    for name in ("table", "aabb"):
        check(torch.equal(asset[name], saved[0][name]), f"load_baked's {name} differs")
    check(torch.equal(asset["occ_state"]["binaries"], saved[0]["occ_state"]["binaries"]),
          "load_baked's grid differs")
    occupied = float(asset["occ_state"]["binaries"].float().mean())
    del saved
    from acn_tpu_torch.utils import checkpoint as tck

    bake_err = {}
    models = {dev: tck.restore_model(tck.load_checkpoint(run, "last"),
                                     runner.build_model_configs(
                                         *_runner_cfg_args(runner)), dev)[0]
              for dev in ("cuda", "cpu")}
    for sh in (0, 1):
        a, b = (baking.bake_container(models[dev], resolution=BAKE_CHECK_RES,
                                      chunk=BAKE_CHECK_RES ** 3, sh_degree=sh)["table"].cpu()
                for dev in ("cuda", "cpu"))
        bake_err[f"sh{sh}"] = float((a - b).abs().max())
        check(torch.allclose(a, b, atol=1e-5, rtol=1e-5),
              f"bake_field SH {sh} at {BAKE_CHECK_RES}³: card vs CPU max |diff| "
              f"{bake_err[f'sh{sh}']}")
    del models
    emit({"phase": "serving_bake", "resolution": BAKE_RES,
          "cut": f"--bake_resolution 512 (the flag's default) cut to {BAKE_RES} for the "
                 "smoke's time",
          "bake_s": bake_s, "save_baked_s": save_s[0],
          "table_mb": asset["table"].numel() * 4 / 2**20,
          "occupied": occupied, "occ_resolution": asset["occ_cfg"].resolution,
          "load_baked_bit_equal": True,
          f"card_vs_cpu_{BAKE_CHECK_RES}^3_max_abs_err": bake_err, "atol": 1e-5, "rtol": 1e-5})

    # (d) baked 1080p frames: budget 24 (the video's), with the pre-pass, budget 0
    baked = {}
    for name, kw in (("budget24", dict(budget_per_ray=24)),
                     ("budget24_coarse32", dict(budget_per_ray=24, s_coarse=32)),
                     ("budget0", dict(budget_per_ray=0))):
        br = baking.BakedRenderer(asset, chunk_points=int(P.chunk_points), **kw)
        chunks = -(-H // br.rows(W))
        frame = lambda br=br, **k: br.render_image(H=H, W=W, intrinsics=cam["intrinsics"],
                                                   c2w=cam["c2w"], **k)
        _zero_scan_counts(segscan)
        warm = _timed(torch, lambda: frame(download=False), 1)
        ms = _timed(torch, lambda: frame(download=False), 1 if name == "budget0" else 2)
        counted[f"baked_{name}"] = got = _scan_counts(segscan)
        n = 1 + len(ms)
        want = 0 if name == "budget0" else chunks * n
        check_packed(f"baked_{name}", got, want, note_comp(f"baked_{name}"))
        rgb, _, acc = frame()
        check(np.isfinite(rgb).all() and np.isfinite(acc).all(), f"baked {name} frame")
        baked[name] = {"warm_frame_ms": warm[0], "frame_ms": ms, "chunks_per_frame": chunks,
                       "rays_per_chunk": br.rows(W) * W,
                       "composite_launches": want,
                       "scan_launches": {"forward": got[0], "reverse": got[1]},
                       "mean_acc": float(acc.mean())}
    if profile_dir:
        br = baking.BakedRenderer(asset, chunk_points=int(P.chunk_points), budget_per_ray=24)
        _profile_frame(torch, lambda: br.render_image(
            H=H, W=W, intrinsics=cam["intrinsics"], c2w=cam["c2w"], download=False),
            profile_dir, "serving_baked")
    asset_cpu = baking.load_baked(path, device="cpu")
    view = dict(H=h, W=w, intrinsics=cam_s["intrinsics"], c2w=cam_s["c2w"])
    baked["card_vs_cpu_64x96_max_err"] = _frames_vs_cpu(
        baking.BakedRenderer(asset, budget_per_ray=24).render_image(**view),
        baking.BakedRenderer(asset_cpu, budget_per_ray=24).render_image(**view), "baked 64×96")
    del asset_cpu
    emit({"phase": "serving_baked_frames", "H": H, "W": W, **baked,
          "dense_frame_ms_phase3": dense_ms})

    # (e) --op eval --baked_asset, TTO 0 and 2
    _zero_scan_counts(segscan)
    res = runner.main(_run_flags("eval.json", "--checkpoint_path", str(run), "--prefix", "last",
                                 "--baked_asset", path, "--tto", "0,2",
                                 "--fname", str(RUNNER_DIR / "eval_baked")))
    counted["runner_eval_baked"] = got = _scan_counts(segscan)
    eval_comp = note_comp("runner_eval_baked")
    Pe = runner.parse_args(_run_flags("eval.json", "--checkpoint_path", str(run),
                                      "--prefix", "last"))
    budget = int(getattr(Pe, "occ_budget_per_ray", 0) or 0)
    br = baking.BakedRenderer(asset, budget_per_ray=budget, chunk_points=int(Pe.chunk_points))
    n_val = RUNNER_CAMERAS[1]
    chunks = -(-RUNNER_IMAGE[0] // br.rows(RUNNER_IMAGE[1]))
    check_packed(f"runner_eval_baked (budget {budget})", got,
                 chunks * n_val * 2 if budget else 0, eval_comp)
    for r in res:
        check(np.isfinite(r["psnr"]) and np.isfinite(r["ssim"]), f"baked eval tto={r['tto']}")
    # the tto=2 leg is the tto=0 leg rendered again. The composite kernel
    # sums every ray in one fixed order (the index_add_ it replaced added
    # with atomics, and two renders differed in their last bits), so the two
    # are expected to be equal; the check keeps the old bounds and the line
    # reports the difference
    d_psnr, d_ssim = (max(abs(a[key] - b[key]) for a, b in zip(res[0]["views"], res[1]["views"]))
                      for key in ("psnr", "ssim"))
    check(res[1]["tto_losses"] == [] and d_psnr <= 1e-3 and d_ssim <= 1e-4,
          f"the baked tto=2 leg adapted, or scored other than tto=0 (PSNR by {d_psnr} dB, "
          f"SSIM by {d_ssim})")
    log = (RUNNER_DIR / "eval_baked" / "log.txt").read_text()
    line = "TTO does not apply to a baked table; rendering tto=2 leg without adaptation"
    check(line in log, "the baked eval did not log that TTO does not apply")
    emit({"phase": "serving_eval_baked", "tto": [0, 2], "views": n_val,
          "occ_budget_per_ray": budget,
          "march": "packed budget" if budget else "strided (budget 0)",
          "psnr": [r["psnr"] for r in res], "ssim": [r["ssim"] for r in res],
          "frame_ms": [v["frame_ms"] for r in res for v in r["views"]],
          "composite_launches": eval_comp,
          "scan_launches": {"forward": got[0], "reverse": got[1]},
          "tto2_minus_tto0_max_abs": {"psnr": d_psnr, "ssim": d_ssim},
          "tto2_equals_tto0": d_psnr == 0.0 and d_ssim == 0.0,
          "tto2_adapted": False, "logged": line})

    # (f) --op video, live and baked
    video = {}
    for name, extra in (("live", []), ("baked", ["--baked_asset", path])):
        _zero_scan_counts(segscan)
        t0 = time.perf_counter()
        out = runner.main(_run_flags("eval.json", "--op", "video", "--checkpoint_path",
                                     str(run), "--prefix", "last", "--video_frames",
                                     str(VIDEO_FRAMES), *extra,
                                     "--fname", str(RUNNER_DIR / f"video_{name}")))
        wall = time.perf_counter() - t0
        counted[f"runner_video_{name}"] = got = _scan_counts(segscan)
        if name == "live":
            note_hash("runner_video_live", trains=False)
        else:
            note_comp("runner_video_baked")
        video_comp = _comp_fwd()
        n = _gif_or_mp4_frames(out)
        check(Path(out).exists() and n == VIDEO_FRAMES,
              f"--op video ({name}) wrote {out} with {n} frames, want {VIDEO_FRAMES}")
        hw = RUNNER_IMAGE[0] * RUNNER_IMAGE[1]
        if name == "live":
            chunks = -(-hw // Renderer(runner.build_model_configs(*_runner_cfg_args(runner)),
                                       Pe, runner.build_occ_config(Pe, 1.0)).chunk_rays)
        else:
            chunks = -(-RUNNER_IMAGE[0] // baking.BakedRenderer(
                asset, budget_per_ray=budget or 24,
                chunk_points=int(Pe.chunk_points)).rows(RUNNER_IMAGE[1]))
        check_packed(f"runner_video_{name}", got,
                     chunks * VIDEO_FRAMES if budget or name == "baked" else 0, video_comp)
        video[name] = {"path": Path(out).name, "frames": n, "wall_s": wall,
                       "encoder": "imageio libx264 (MP4)" if out.endswith(".mp4")
                       else "Pillow (GIF)", "chunks_per_frame": chunks,
                       "composite_launches": video_comp,
                       "scan_launches": {"forward": got[0], "reverse": got[1]}}
    emit({"phase": "serving_video", **video, "phase9_s": time.perf_counter() - t_phase})
    del asset
    return counted, path


def _runner_cfg_args(runner):
    """(P, clustering meta) of phase 8's run for ``build_model_configs``."""
    from acn_tpu_torch.data import dataset

    P = runner.parse_args(_run_flags("eval.json", "--checkpoint_path",
                                     str(RUNNER_DIR / "train"), "--prefix", "last"))
    masks = RUNNER_DIR / "data" / "out" / "example" / "masks" / P.mask_dirname
    return P, dataset.load_clustering_meta(masks)


# ---------------------------------------------------------------- phase 10


M9_EPISODE_RAYS = 256  # the float32 episodes of (a): support rays, query half
M9_EPISODE_INNER = 2
M9_CHUNK = 256  # train_chunk_rays of (d): a support episode is 4 chunks
M9_DIR = Path("logs") / "chip_smoke_m9"
# the Reptile step against its recomputation: the distance of the step's
# parameters from the recomputed ones, against the step's own move (the
# bf16 table gradient's scatter-add adds in another order on every run).
# The phase also computes what a step with a planted fault would read (the
# sum over tasks not divided by T, 2/3; the last task's move alone) and
# fails unless both lie above the limit. PERF.md §6 gives the readings the
# limit was set between.
REPTILE_RECOMPUTE_RTOL = 1e-3
# Reptile's outer step (P.lr) in (b): θ moves all the way to the tasks' mean
# fast weights. At the config's lr of 1e-4 the move (≈ 1.6e-8 over expert
# 0) sits at float32's resolution of θ, and rounding, not the step's
# arithmetic, decides what the check reads.
REPTILE_OUTER_LR = 1.0


def replay_salts(what, k, t, j, shape):
    """Draws that a recomputation can replay: the budget march's salt of
    episode (k, t), march j (with the background MLP the budget regime
    draws nothing else)."""
    check(what == "salt", f"the budget step asked for a {what!r} draw")
    return 7919 * (97 * k + t) + j + 1


def m9_episode(torch, ts, nn, meta_core, cfg, P, occ_cfg, model_cpu, occ_cpu, batch_np,
               dev, algo):
    """One float32 episode of expert 0, task 0 on ``dev``: ``M9_EPISODE_RAYS``
    support and half as many query rays, ``M9_EPISODE_INNER`` inner steps,
    the σ-head bias at +2, one salt per march, through ``algo``'s outer
    loss (``maml``: second order, the scan's double backward on the card).
    Returns (query loss, the gradient's leaves as float64 on the CPU: the
    expert's, then the background head's)."""
    P_e = types.SimpleNamespace(**{**vars(P), "use_amp": False,
                                   "inner_iter": M9_EPISODE_INNER, "algo": algo})
    loss_fn, prep = ts.make_episode_loss(cfg, P_e, occ_cfg)
    params = model_cpu.params()
    expert = nn.tree_map(lambda a: a[0].detach().clone().to(dev).requires_grad_(True),
                         params["experts"])
    with torch.no_grad():
        expert["sigma_head"]["b"].fill_(2.0)
    bg = nn.tree_map(lambda a: a.detach().clone().to(dev).requires_grad_(True),
                     params["bg_mlp"])
    aabb = model_cpu.expert_aabbs[0].to(dev)
    occ0 = {k: v[0].to(dev) for k, v in occ_cpu.items()}
    n = M9_EPISODE_RAYS
    sr, sg = (torch.from_numpy(batch_np[k][0, 0, :n]).to(dev)
              for k in ("support_rays", "support_rgbs"))
    qr, qg = (torch.from_numpy(batch_np[k][0, 0, :n // 2]).to(dev)
              for k in ("query_rays", "query_rgbs"))
    smp_s, smp_q = prep(occ0, sr, 12345), prep(occ0, qr, 54321)
    q_loss, _ = meta_core.outer_loss_fn_for(algo)(
        lambda p, b, i: loss_fn(p, bg, aabb, b[0], b[1], smp_s),
        lambda p, b, i: loss_fn(p, bg, aabb, b[0], b[1], smp_q),
        expert, (sr, sg), (qr, qg), float(P.inner_lr), M9_EPISODE_INNER)
    grads = torch.autograd.grad(q_loss, nn.tree_leaves(expert) + nn.tree_leaves(bg))
    return float(q_loss.detach()), [g.double().cpu() for g in grads]


def _vec(leaves):
    return np.concatenate([np.asarray(g).reshape(-1) for g in leaves])


def phase_m9(torch, segscan, toy, occ_cpu, fomaml_ms) -> dict:
    """M9 at full width (module docstring, phase 10): MAML, Reptile, FIM,
    the chunked loss, AdamW and SGD with their checkpoints, the vanilla
    expert and the corner layout. Returns the scan's launch counts by
    sub-phase, summed over its steps."""
    import shutil

    from acn_tpu_torch import runner as trunner
    from acn_tpu_torch.models import encodings as enc
    from acn_tpu_torch.models import fim as fim_mod
    from acn_tpu_torch.models import nn
    from acn_tpu_torch.pipelines.offline_stage import meta_core
    from acn_tpu_torch.pipelines.offline_stage import train_step as ts
    from acn_tpu_torch.pipelines.offline_stage import trainer as tr
    from acn_tpu_torch.pipelines.renderer import Renderer
    from acn_tpu_torch.utils import checkpoint as tck
    from acn_tpu_torch.utils.config import parse_args

    cfg, P, occ_cfg = toy.train_occ_config()
    K, T, I = cfg.num_submodules, int(P.batch_size), int(P.inner_iter)
    S, Q = int(P.support_rays), int(P.query_rays)
    first_order = K * T * (I + 1)
    t_phase = time.perf_counter()
    batch_np = toy.training_batch(K, T, S, Q, seed=0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    occ = {k: v.cuda() for k, v in occ_cpu.items()}
    launches, comp_launches = {}, {}

    def with_(**over):
        return types.SimpleNamespace(**{**vars(P), **over})

    def run_steps(cfg_, P_, n, draws=None, name=None):
        """A fresh model (seed 0) and ``n`` steps of ``P_``'s training step:
        (model, optimizer, state, ms per step, launches per step, the last
        metrics as numpy, the parameters before the first step, the peak
        memory in MB)."""
        torch.cuda.empty_cache()
        model = toy.serving_model(cfg_, seed=0, device="cuda")
        opt, state = toy.init_train_state(model, P_)
        step = ts.make_meta_train_step(cfg_, P_, opt, occ_cfg)
        gen = torch.Generator(device="cuda").manual_seed(0)
        start = nn.tree_map(lambda p: p.detach().clone(), model.params())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, counts, metrics, hash_counts = [], [], None, []
        for _ in range(n):
            _zero_scan_counts(segscan)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch, occ, draws if draws is not None else gen)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            counts.append(_train_counts(segscan))
            hash_counts.append(_kernel_counts())
        peak = torch.cuda.max_memory_allocated() / 1e6
        launches[name] = tuple(sum(c[i] for c in counts) for i in (0, 1))
        comp_launches[name] = [c[3] for c in hash_counts]
        if name and getattr(getattr(cfg_.expert, "hash", None), "layout", "") == "cell":
            # Reptile's query losses are not differentiated (no_grad): their
            # composite is the kernel's
            note_hash(f"m9_{name}", True, tuple(sum(c[i] for c in hash_counts)
                                                for i in range(5)),
                      comp="serves" if getattr(P_, "algo", "") == "reptile" else None)
        m = {k: v.detach().cpu().numpy() for k, v in metrics.items()}
        check(all(np.isfinite(v).all() for v in m.values()),
              f"{name}: a metric is not finite: {m}")
        return model, opt, state, ms, counts, m, start, peak

    def moved_groups(start, model, labels):
        moved = {}

        def note(a, b, label):
            changed = bool((a != b).any()) and bool(torch.isfinite(b).all())
            moved[label] = moved.get(label, False) or changed

        nn.tree_map(note, start, model.params(), labels)
        return moved

    # (a) second-order MAML, budget regime: each loss's forward is the
    # composite kernel; each inner step's create_graph backward runs the plain
    # composition again and differentiates it (a scan forward and reverse),
    # and the outer backward runs the scan's double backward through it (one
    # more of each) and, for every loss, the backward kernel: an inner
    # loss's cotangent depends on its own rgb (the loss's curvature), so the
    # outer gradient reaches its forward's output too
    want = (2 * K * T * I, 2 * K * T * I, first_order, first_order)
    P_m = with_(algo="maml")
    model, opt, state, ms, counts, m, start, peak = run_steps(cfg, P_m, 2, name="maml")
    check(all(c == want for c in counts),
          f"MAML launches per step (scan forward, reverse, composite forward, backward) "
          f"{counts}, want {want}; no scan would mean the double backward never ran")
    moved = moved_groups(start, model, opt.labels)
    check(set(moved) == {"encoding", "sigma", "color", "background"} and all(moved.values()),
          f"MAML: parameter groups that moved: {moved}")
    # one full-width episode's own memory (the step's peak is the optimizer's
    # update): expert 0, task 0, bf16, through each algorithm's outer loss
    loss_fn, prep = ts.make_episode_loss(cfg, P, occ_cfg)
    occ0 = {k: v[0] for k, v in occ.items()}
    smp = [prep(occ0, batch[n][0, 0], 12345) for n in ("support_rays", "query_rays")]
    bg = model.params()["bg_mlp"]
    episode_mb = {}
    for algo in ("fomaml", "maml"):
        expert0 = nn.tree_map(lambda a: a[0], model.params()["experts"])
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        q_loss, _ = meta_core.outer_loss_fn_for(algo)(
            lambda p, b, i: loss_fn(p, bg, model.expert_aabbs[0], b[0], b[1], smp[0]),
            lambda p, b, i: loss_fn(p, bg, model.expert_aabbs[0], b[0], b[1], smp[1]),
            expert0, (batch["support_rays"][0, 0], batch["support_rgbs"][0, 0]),
            (batch["query_rays"][0, 0], batch["query_rgbs"][0, 0]), float(P.inner_lr), I)
        torch.autograd.grad(q_loss, nn.tree_leaves(expert0))
        torch.cuda.synchronize()
        episode_mb[algo] = (torch.cuda.max_memory_allocated() - base) / 1e6
        del q_loss, expert0
    del model, opt, state, start, smp, bg
    model_cpu = toy.serving_model(cfg, seed=0, device="cpu")
    n_tables = len(model_cpu.params()["experts"]["hash_table"])
    ep = {}
    for label, dev, algo in (("card", "cuda", "maml"), ("cpu", "cpu", "maml"),
                             ("card_fomaml", "cuda", "fomaml")):
        ep[label] = m9_episode(torch, ts, nn, meta_core, cfg, P, occ_cfg, model_cpu,
                               occ_cpu, batch_np, dev, algo)
    vs_cpu = check_card_vs_cpu_f32(torch, ep["card"], ep["cpu"], n_tables, "MAML episode")
    g_m, g_c, g_f = (_vec(ep[k][1]) for k in ("card", "cpu", "card_fomaml"))
    second = float(np.linalg.norm(g_m - g_f) / np.linalg.norm(g_f))
    noise = float(np.linalg.norm(g_m - g_c) / np.linalg.norm(g_c))
    check(second > 10.0 * noise,
          f"MAML's gradient is FoMAML's within the card/CPU noise: relative "
          f"distance {second}, card against CPU {noise}")
    emit({"phase": "m9_maml", "K": K, "T": T, "inner_iter": I, "support_rays": S,
          "query_rays": Q, "use_amp": bool(P.use_amp), "step_ms": ms[1:],
          "warm_step_ms": ms[0], "mean_step_ms": statistics.mean(ms[1:]),
          "fomaml_step_ms_phase5": fomaml_ms,
          "vs_fomaml": statistics.mean(ms[1:]) / fomaml_ms,
          "fwd_launches_per_step": counts[-1][0], "rev_launches_per_step": counts[-1][1],
          "composite_launches_per_step": counts[-1][2:],
          "first_order_launches_per_step": first_order, "peak_mem_mb": peak,
          "episode_peak_above_start_mb": episode_mb,
          "loss_total": float(m["loss_total"]), "grad_norm": float(m["grad_norm"]),
          "episode_card_vs_cpu": {"rays": M9_EPISODE_RAYS, "inner_iter": M9_EPISODE_INNER,
                                  **vs_cpu, "second_order_rel": second,
                                  "card_vs_cpu_rel": noise}})

    # (b) Reptile, budget regime: θ ← θ + P.lr · mean_t(fast_t − θ)
    P_r = with_(algo="reptile", lr=REPTILE_OUTER_LR)
    model, opt, state, ms, counts, m, start, _ = run_steps(cfg, P_r, 1, draws=replay_salts,
                                                           name="reptile")
    # the K·T·I support losses composite forward and backward in the kernels,
    # the K·T query losses (under no_grad) forward only
    want = (0, 0, first_order, K * T * I)
    check(counts == [want], f"Reptile launches (scans, composites) {counts}, want {want}")
    check(int(state["opt_state"]["count"]) == 0 and float(m["grad_norm"]) == 0.0,
          f"Reptile moved the optimizer: count {int(state['opt_state']['count'])}")
    loss_fn, prep = ts.make_episode_loss(cfg, P_r, occ_cfg)
    theta = nn.tree_map(lambda a: a[0].clone(), start["experts"])
    bg = start["bg_mlp"]
    d = nn.tree_map(torch.zeros_like, theta)
    occ0 = {k: v[0] for k, v in occ.items()}
    for t in range(T):
        sr, sg = batch["support_rays"][0, t], batch["support_rgbs"][0, t]
        smp = prep(occ0, sr, replay_salts("salt", 0, t, 0, ()))
        fast, _ = meta_core.reptile_adapt(
            lambda p, b, i: loss_fn(p, bg, model.expert_aabbs[0], b[0], b[1], smp),
            theta, (sr, sg), float(P_r.inner_lr), I)
        last = nn.tree_map(lambda f, w: f.detach() - w, fast, theta)
        nn.tree_map(lambda a, dd: a.add_(dd), d, last)
    lr = float(P_r.lr)
    finite = lambda dd: torch.where(torch.isfinite(dd), dd, 0.0)
    expect = nn.tree_map(lambda w, dd: w + lr * (finite(dd) / T), theta, d)
    got = nn.tree_map(lambda a: a[0].detach(), model.params()["experts"])

    def dist(a, b):
        return math.sqrt(sum(float(((x - y).double() ** 2).sum()) for x, y in
                             zip(nn.tree_leaves(a), nn.tree_leaves(b))))

    move = dist(got, theta)
    ratio = dist(got, expect) / move if move > 0.0 else math.inf
    # what the check reads for a step with a planted fault: its distance from
    # the recomputation over its own move
    planted = {}
    for fault, delta in (("sum_not_mean", d), ("last_task_only", last)):
        wrong = nn.tree_map(lambda w, dd: w + lr * finite(dd), theta, delta)
        planted[fault] = dist(wrong, expect) / dist(wrong, theta)
    check(move > 0.0 and ratio <= REPTILE_RECOMPUTE_RTOL,
          f"Reptile: expert 0 lies {ratio} of its move {move} from θ + lr·mean(fast − θ)")
    check(min(planted.values()) > REPTILE_RECOMPUTE_RTOL,
          f"Reptile: a planted fault reads {planted}, within the limit")
    bg_same = all(torch.equal(a, b) for a, b in zip(nn.tree_leaves(model.params()["bg_mlp"]),
                                                     nn.tree_leaves(bg)))
    check(bg_same, "Reptile moved the background head")
    del model, opt, state, start, theta, d, last, fast, expect, got
    _, _, _, ms_r, counts_r, m_r, _, _ = run_steps(cfg, P_r, 2, name="reptile_timed")
    launches["reptile"] = tuple(a + b for a, b in zip(launches["reptile"],
                                                       launches.pop("reptile_timed")))
    emit({"phase": "m9_reptile", "step_ms": ms_r[1:], "warm_step_ms": ms_r[0],
          "vs_fomaml": ms_r[1] / fomaml_ms, "launches_per_step": counts_r[-1],
          "composite_launches_per_step": comp_launches["reptile_timed"][-1],
          "outer_lr": REPTILE_OUTER_LR, "expert0_move": move,
          "expert0_distance_over_move": ratio,
          "planted_fault_distance_over_move": planted, "rtol": REPTILE_RECOMPUTE_RTOL,
          "loss_total": float(m_r["loss_total"])})

    # (c) FoMAML with the Fisher-preconditioned inner loop
    P_f = with_(fim=True)
    model, opt, state, ms, counts, m, start, _ = run_steps(cfg, P_f, 2, name="fim")
    check(all(c == budget_want(first_order) for c in counts),
          f"FIM launches per step (scans, composites) {counts}, want "
          f"{budget_want(first_order)}")
    fim_cfg = ts._fim_cfg_from(P_f)
    loss_fn, prep = ts.make_episode_loss(cfg, P_f, occ_cfg)
    expert0 = nn.tree_map(lambda a: a[0], model.params()["experts"])
    sr, sg = batch["support_rays"][0, 0], batch["support_rgbs"][0, 0]
    smp = prep(occ0, sr, 12345)
    bg = nn.tree_map(lambda a: a.detach(), model.params()["bg_mlp"])
    _, fisher, inner = fim_mod.fim_task_adapt(
        lambda p, b, i: loss_fn(p, bg, model.expert_aabbs[0], b[0], b[1], smp),
        expert0, fim_mod.fisher_init(expert0), (sr, sg), float(P.inner_lr), I, **fim_cfg)
    fisher_ok = all(bool(torch.isfinite(f).all()) for f in nn.tree_leaves(fisher))
    check(fisher_ok and bool(torch.isfinite(inner).all()),
          "FIM: the Fisher state or the inner losses are not finite")
    emit({"phase": "m9_fim", **fim_cfg, "step_ms": ms[1:], "warm_step_ms": ms[0],
          "vs_fomaml": ms[1] / fomaml_ms, "launches_per_step": counts[-1],
          "fisher_max": max(float(f.max()) for f in nn.tree_leaves(fisher)),
          "inner_losses": inner.cpu().tolist(), "loss_total": float(m["loss_total"])})
    del model, opt, state, start, expert0, fisher

    # (d) the chunked loss on the budget config: every chunk marches strided
    P_c = with_(train_chunk_rays=M9_CHUNK)
    model, opt, state, ms, counts, m, start, _ = run_steps(cfg, P_c, 1, name="chunked")
    check(counts == [(0, 0, 0, 0)],
          f"the chunked budget step launched scans or composites {counts}")
    emit({"phase": "m9_chunked", "train_chunk_rays": M9_CHUNK, "step_ms": ms,
          "launches_per_step": counts[-1], "loss_total": float(m["loss_total"])})
    del model, opt, state, start

    # (e) AdamW and SGD: a step each, a checkpoint, reloaded bit for bit
    opt_out = {}
    for name in ("adamw", "sgd"):
        P_o = with_(optimizer=name)
        model, opt, state, ms, counts, m, start, _ = run_steps(cfg, P_o, 1, name=name)
        check(counts == [budget_want(first_order)], f"{name}: launches {counts}")
        run = M9_DIR / name
        t0 = time.perf_counter()
        tck.save_checkpoint(run, "last", model, opt_state=state["opt_state"],
                            occ_states=occ, P=P_o, step=1, optimizer=opt)
        save_s = time.perf_counter() - t0
        model2, occ2 = tck.restore_model(tck.load_checkpoint(run, "last"), cfg)
        opt2 = tck.load_opt_state(run, "last", opt.init(model2.params()), opt)
        # trees paired by key: a restored tree lists its keys sorted
        equal = lambda a, b: all(nn.tree_leaves(nn.tree_map(
            lambda x, y: x.dtype == y.dtype and torch.equal(x, y), a, b)))
        same = (equal(model2.params(), model.params())
                and set(opt2) == set(state["opt_state"])
                and equal(opt2, state["opt_state"]) and equal(occ2, occ))
        check(same, f"{name}: the checkpoint does not reload bit for bit")
        check(("mu" in state["opt_state"]) == (name == "adamw"),
              f"{name}: optimizer state keys {sorted(state['opt_state'])}")
        opt_out[name] = {"step_ms": ms[0], "save_s": save_s,
                         "optim_bytes": (run / "last.optim").stat().st_size,
                         "count": int(state["opt_state"]["count"]),
                         "loss_total": float(m["loss_total"])}
        del model, model2, opt, opt2, state, start, occ2
    shutil.rmtree(M9_DIR, ignore_errors=True)
    emit({"phase": "m9_optimizers", **opt_out})

    # (f) the vanilla expert at the runner's width
    meta = {"boundary_margin": cfg.boundary_margin, "cluster_2d": cfg.cluster_2d}
    args = ["--op", "train", "--configPath", "configs/train_occ.json"]
    built = trunner.build_model_configs(parse_args(args + ["--nerf_variant", "vanilla"]), meta)
    cfg_v = dataclasses.replace(cfg, nerf_variant="vanilla", expert=built.expert)
    check(cfg_v.expert.hidden == 256 and cfg_v.expert.sigma_depth == 8,
          f"the runner's vanilla expert: {cfg_v.expert}")
    model, opt, state, ms, counts, m, start, _ = run_steps(cfg_v, P, 1, name="vanilla")
    check(counts == [budget_want(first_order)], f"vanilla: launches {counts}")
    cam = toy.overhead_camera(H, W)
    from acn_tpu_torch.pipelines.renderer import _pinhole_block_rays
    rays = _pinhole_block_rays(H, W, *[torch.from_numpy(np.asarray(a, np.float32)) for a in
                                       (cam["c2w"], cam["intrinsics"], cam["aabb"])],
                               torch.tensor([-np.inf, np.inf]), 0.0, 0.0).numpy()
    rays = rays[np.random.default_rng(1).choice(len(rays), 512, replace=False)]
    model_cpu_v = toy.serving_model(cfg_v, seed=0, device="cpu")
    model_v = toy.serving_model(cfg_v, seed=0, device="cuda")
    before = {k: v.clone() for k, v in occ.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    after = tr.make_occ_update_fn(cfg_v, occ_cfg)(
        model_v, before, generator=torch.Generator(device="cuda").manual_seed(5))
    torch.cuda.synchronize()
    update_ms = 1e3 * (time.perf_counter() - t0)
    share = check_update_pass(torch, occ_cfg, before, after)
    # at random init σ ≈ 1 and a sample's α ≈ σ·δ stays under the alpha
    # threshold: the σ-head bias at +4 and threshold 0 (as phase 4's second
    # case) make the rays composite something
    for mdl in (model_cpu_v, model_v):
        with torch.no_grad():
            mdl.experts["sigma_head"]["b"].fill_(4.0)
    oc0 = dataclasses.replace(occ_cfg, alpha_thre=0.0)
    gpu = Renderer(cfg_v, P, oc0, chunk_rays=512).render_rays(model_v, occ, rays)
    cpu = Renderer(cfg_v, P, oc0, chunk_rays=512, device="cpu").render_rays(
        model_cpu_v, occ_cpu, rays)
    errs = {k: float(np.abs(g - c).max()) for k, g, c in zip(("rgb", "depth", "acc"), gpu, cpu)}
    check(all(np.allclose(g, c, atol=1e-4, rtol=1e-4) for g, c in zip(gpu, cpu))
          and float(cpu[2].mean()) > 0.1,
          f"vanilla render_rays, card against CPU: {errs}, mean acc {float(cpu[2].mean())}")
    emit({"phase": "m9_vanilla", "hidden": cfg_v.expert.hidden,
          "sigma_depth": cfg_v.expert.sigma_depth, "step_ms": ms[0],
          "launches_per_step": counts[-1], "loss_total": float(m["loss_total"]),
          "render_rays_vs_cpu": {"rays": 512, "sigma_bias": 4.0, "alpha_thre": 0.0,
                                 "max_abs_err": errs, "atol": 1e-4, "rtol": 1e-4,
                                 "mean_acc": float(cpu[2].mean())},
          "occ_update_ms": update_ms, "occupied_share": share})
    del model, model_v, model_cpu_v, opt, state, start, before, after

    # (g) the corner layout at the oracle's L16 F2
    built = trunner.build_model_configs(parse_args(
        args + ["--hash_layout", "corner", "--hash_levels", "16", "--hash_features", "2"]), meta)
    cfg_c = dataclasses.replace(cfg, expert=built.expert)
    hcfg = cfg_c.expert.hash
    check(hcfg.layout == "corner" and hcfg.levels == 16 and hcfg.features_per_level == 2,
          f"the runner's corner grid: {hcfg}")
    model, opt, state, ms, counts, m, start, _ = run_steps(cfg_c, P, 1, name="corner")
    check(counts == [budget_want(first_order)], f"corner: launches {counts}")
    table = model.params()["experts"]["hash_table"][0].detach()
    x = torch.rand((4096, 3), generator=torch.Generator().manual_seed(6))
    gout = torch.randn((4096, hcfg.out_dim), generator=torch.Generator().manual_seed(7))
    res = {}
    for dev in ("cuda", "cpu"):
        tab = table.to(dev).clone().requires_grad_(True)
        out = enc.hash_encode(tab, x.to(dev), hcfg)
        (g,) = torch.autograd.grad(out, tab, gout.to(dev))
        res[dev] = (out.detach().cpu(), g.cpu())
    fwd_err = float((res["cuda"][0] - res["cpu"][0]).abs().max())
    grad_err = float((res["cuda"][1] - res["cpu"][1]).abs().max())
    # the forward is the same gathers and products in the same order; the
    # table gradient is a float32 scatter-add with atomics on the card, so
    # a row that many points hit sums in another order
    check(torch.allclose(res["cuda"][0], res["cpu"][0], rtol=1e-6, atol=1e-9)
          and torch.allclose(res["cuda"][1], res["cpu"][1], rtol=1e-5, atol=1e-6),
          f"corner encode, card against CPU: forward {fwd_err}, gradient {grad_err}")
    emit({"phase": "m9_corner", "levels": hcfg.levels, "features": hcfg.features_per_level,
          "log2_hashmap_size": hcfg.log2_hashmap_size,
          "table_rows": int(table.shape[0]), "step_ms": ms[0],
          "launches_per_step": counts[-1], "loss_total": float(m["loss_total"]),
          "encode_vs_cpu": {"points": 4096, "max_abs_err": fwd_err,
                            "grad_max_abs_err": grad_err,
                            "grad_max_abs": float(res["cpu"][1].abs().max())}})
    del model, opt, state, start, table
    torch.cuda.empty_cache()
    emit({"phase": "m9_done", "phase10_s": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------- main


# ---------------------------------------------------------------- phase 11


MESH_DIR = Path(__file__).resolve().parent / "logs" / "chip_smoke_mesh"
MESH_BAKED_HW = (64, 96)
MESH_STEPS = 2  # one warm, one timed (3 before, cut for the smoke's time)
MESH_RUN_STEPS = 3  # (c)'s --op train through the switch (4 before, cut for time)
# a mesh step against its reference step (the plain one for (a), (a)'s for
# (b)): each parameter group's update, the loss and the gradient norm lie no
# farther from the reference's than MESH_FACTOR × two plain steps' distance
# (the table scatter's atomic order), above a floor of relative distance.
# Two plain steps' σ and color updates have differed by 1.7e-7–1.0e-5 (one
# sample of that spread can sit far below another), the encoding's by
# 2.0e-3–2.2e-3; the loss has agreed to the bit. The planted faults (a draw
# keyed by the wrong expert, a gradient mean that loses its 1/T, an
# all-reduce skipped) are read beside the floor and must fail it; the
# gradient norm reads a lost 1/T whatever the optimizer makes of it.
MESH_FACTOR, MESH_FLOOR, MESH_LOSS_FLOOR = 2.0, 1e-4, 1e-6
U8_STEP = 1.0 / 255 + 1e-6


def _step_setup(torch, toy, device):
    """Phase 5's step: the config, a fresh model (seed 0), phase 3's grids,
    phase 5's batch, all on ``device``."""
    cfg, P, occ_cfg = toy.train_occ_config()
    K, T = cfg.num_submodules, int(P.batch_size)
    batch = {k: torch.from_numpy(v).to(device) for k, v in toy.training_batch(
        K, T, int(P.support_rays), int(P.query_rays), seed=0).items()}
    boxes, _ = toy.quadrant_layout(K)
    occ = toy.random_occ_states(boxes, occ_cfg, fill=0.10, seed=0, device=device)
    return cfg, P, occ_cfg, batch, occ


def _group_vectors(torch, nn, params, labels) -> dict:
    """Each parameter group's leaves as one float32 vector."""
    parts = collections.defaultdict(list)
    nn.tree_map(lambda p, g: parts[g].append(p.detach().reshape(-1).float()), params, labels)
    return {g: torch.cat(v) for g, v in parts.items()}


def _update_cmp(torch, got: dict, want: dict) -> dict:
    """Per group: relative distance, cosine and length ratio of two
    updates."""
    out = {}
    for g in want:
        a, b = got[g].to(want[g].device), want[g]
        nb = float(torch.linalg.vector_norm(b))
        out[g] = {"rel_dist": float(torch.linalg.vector_norm(a - b)) / max(nb, 1e-30),
                  "cos": float(torch.dot(a, b)) / max(float(torch.linalg.vector_norm(a)) * nb,
                                                     1e-30),
                  "len_ratio": float(torch.linalg.vector_norm(a)) / max(nb, 1e-30)}
    return out


def _mesh_misses(got: dict, ref: dict, pair: dict) -> list:
    """What of a step (``got``: "cmp", each group's ``_update_cmp`` against
    the reference's update; "loss"; "grad_norm") lies outside the mesh bound
    around the reference (``ref``: "loss", "grad_norm"), given two plain
    steps' distances (``pair``: "groups", their ``_update_cmp``; "loss" and
    "grad_norm", |Δ|)."""
    out = []
    for g, c in got["cmp"].items():
        lim = max(MESH_FACTOR * pair["groups"][g]["rel_dist"], MESH_FLOOR)
        if not c["rel_dist"] <= lim:
            out.append(f"group {g}: {c['rel_dist']:.3g} from the reference (limit {lim:.3g})")
    for key, floor in (("loss", MESH_LOSS_FLOOR), ("grad_norm", MESH_FLOOR)):
        lim = max(MESH_FACTOR * pair[key], floor * abs(ref[key]))
        d = abs(got[key] - ref[key])
        if not d <= lim:
            out.append(f"{key} {got[key]!r} against {ref[key]!r} (|Δ| {d:.3g}, limit {lim:.3g})")
    return out


class _draws_keyed:
    """A planted fault for a ``with`` block: the step's draws keyed from
    expert ``first(k0)`` where the rank's first expert is k0
    (``train_step.EpisodeDraws``' offset)."""

    def __init__(self, ts, first):
        self.ts, self.first, self.cls = ts, first, ts.EpisodeDraws

    def __enter__(self):
        cls, first = self.cls, self.first

        class Faulty(cls):
            def __init__(self, *a, offset=(0, 0), **kw):
                super().__init__(*a, offset=(first(offset[0]), offset[1]), **kw)

        self.ts.EpisodeDraws = Faulty

    def __exit__(self, *exc):
        self.ts.EpisodeDraws = self.cls


def _lose_the_mean(mesh, T: int) -> None:
    """A planted fault: the expert gradients' sum over the data group comes
    back T× (the 1/T of the task mean lost)."""
    reduce = mesh.all_reduce

    def faulty(ts_, group, op=None):
        reduce(ts_, group, op)
        if group is mesh.data_group:
            for t in ts_:
                t.mul_(T)

    mesh.all_reduce = faulty


def frame_bg_draws(torch, rows: int, device):
    """``RenderDraws``' function form for the frame's ``random`` sky with a
    color per pixel (seed 0): dispatch c's block (slot s of n) covers rows
    (c·n + s)·rows onwards, so a frame over any number of ranks gets the
    single rank's sky."""
    n_max = 2
    rows_all = -(-H // (rows * n_max)) * rows * n_max
    sky = torch.rand((rows_all * W, 3), device=device,
                     generator=torch.Generator(device=device).manual_seed(0))

    def fn(what, c, shape):
        assert what == "bg", what
        c, s, n = (*c, n_max) if isinstance(c, tuple) else (c, 0, 1)
        blk = c * n + s
        return sky[blk * rows * W:(blk + 1) * rows * W]

    return fn


def _baked_to(torch, nn, baked: dict, device) -> dict:
    return {k: (v.to(device) if isinstance(v, torch.Tensor) else
                nn.tree_map(lambda t: t.to(device), v) if isinstance(v, dict) else v)
            for k, v in baked.items()}


def mesh_rank_11b(rank: int, n: int, a: dict) -> dict:
    """Phase 11 (b), on each of the ranks that share the card over gloo:
    the sharded budget step (E = 2) from the fresh model, MESH_STEPS times,
    the update of the first gathered on rank 0; the same first step with a
    planted fault: the world's all-reduces skipped ("world"), or rank 1's
    draws keyed by its local expert, not the global one ("draws"); a 1080p
    dense frame and a baked frame by row blocks over the ranks."""
    import torch
    import torch.distributed as dist

    from acn_tpu_torch import toy
    from acn_tpu_torch.models import nn
    from acn_tpu_torch.ops import segscan
    from acn_tpu_torch.parallel import mesh as pmesh
    from acn_tpu_torch.pipelines.baking import BakedRenderer
    from acn_tpu_torch.pipelines.offline_stage import train_step as ts
    from acn_tpu_torch.pipelines.renderer import Renderer

    dev = pmesh.rank_device()
    cfg, P, occ_cfg, batch, occ = _step_setup(torch, toy, dev)
    K = cfg.num_submodules
    out = {"device": str(dev), "backend": pmesh.backend()}

    def run(fault=None):
        mesh = pmesh.Mesh.build(K, 2, 1)
        if fault == "world":
            reduce = mesh.all_reduce
            mesh.all_reduce = lambda ts_, group, op=None: (
                None if group is mesh.world_group else reduce(ts_, group, op))
        model = toy.serving_model(cfg, seed=0, device=dev)
        opt, state = toy.init_train_state(model, P)
        start = _group_vectors(torch, nn, model.params(), opt.labels) if rank == 0 else None
        sh = pmesh.shard_by_expert_axis({"model": model, "opt_state": state["opt_state"],
                                         "occ_states": occ, "batch": batch}, mesh, K)
        del model
        state = {**state, "model": sh["model"], "opt_state": sh["opt_state"]}
        step = ts.make_meta_train_step(cfg, P, opt, occ_cfg, device=dev, mesh=mesh)
        gen = torch.Generator(device=dev).manual_seed(0)
        ms, launches, update, metrics = [], [], None, None
        for i in range(1 if fault else MESH_STEPS):
            _zero_scan_counts(segscan)
            c0 = dict(mesh.stats)
            torch.cuda.synchronize()
            pmesh.host_barrier()
            t0 = time.perf_counter()
            if fault == "draws" and rank == 1:
                with _draws_keyed(ts, lambda k0: 0):
                    state, m = step(state, sh["batch"], sh["occ_states"], gen)
            else:
                state, m = step(state, sh["batch"], sh["occ_states"], gen)
            torch.cuda.synchronize()
            pmesh.host_barrier()
            ms.append(1e3 * (time.perf_counter() - t0))
            counts = torch.tensor(_train_counts(segscan))
            dist.all_reduce(counts, group=pmesh.host_group())  # summed over the ranks
            launches.append({"this_rank": list(_train_counts(segscan)),
                             "summed": counts.tolist(),
                             "hash": list(_kernel_counts()),
                             "collectives": mesh.stats["collectives"] - c0["collectives"],
                             "bytes": mesh.stats["bytes"] - c0["bytes"]})
            if i == 0:
                metrics = {k: v.detach().cpu().numpy() for k, v in m.items()}
                w = pmesh.gather_tree({"model": state["model"]}, mesh, K)["model"]
                if rank == 0:
                    after = _group_vectors(torch, nn, w["params"], opt.labels)
                    update = {g: (after[g] - start[g]).cpu() for g in after}
                del w
        del state, step
        torch.cuda.empty_cache()
        return {"ms": ms, "launches": launches, "update": update, "metrics": metrics}

    out["step"] = run()
    out["faults"] = {f: run(f) for f in ("world", "draws")}

    # the frames: phase 3's model (σ-head bias +2, as phase 4 leaves it)
    model = toy.serving_model(cfg, seed=0, device=dev)
    with torch.no_grad():
        model.experts["sigma_head"]["b"].fill_(2.0)
    rmesh = pmesh.make_render_mesh()
    renderer = Renderer(cfg, P, occ_cfg, device=dev)
    cam = toy.overhead_camera(H, W)
    sky = frame_bg_draws(torch, renderer.chunk_rays // W, dev)
    frame = lambda **kw: renderer.render_image(model, occ, H=H, W=W, mesh=rmesh, draws=sky,
                                               **cam, **kw)
    frame(download=False)
    pmesh.host_barrier()
    _zero_scan_counts(segscan)
    ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        pmesh.host_barrier()
        t0 = time.perf_counter()
        rgb, depth, acc = frame()
        ms.append(1e3 * (time.perf_counter() - t0))
    out["frame"] = {"ms": ms, "rgb": rgb if rank == 0 else None,
                    "launches": list(_scan_counts(segscan)),
                    "hash": list(_kernel_counts())}
    baked = _baked_to(torch, nn, a["baked"], dev)
    bh, bw = MESH_BAKED_HW
    bcam = toy.overhead_camera(bh, bw)
    got = BakedRenderer(baked, **a["baked_kw"]).render_image(
        H=bh, W=bw, intrinsics=bcam["intrinsics"], c2w=bcam["c2w"], mesh=rmesh)
    out["baked"] = got if rank == 0 else None
    out["host_stats"] = dict(rmesh.stats)
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_mesh(torch, segscan, toy, model, occ) -> dict:
    """The (expert × data) mesh at full width (module docstring, phase 11):
    (a) one rank over NCCL, (b) two ranks sharing the card over gloo, (c)
    ``--op train`` as two processes. Returns the scan's launch counts."""
    import shutil

    from acn_tpu_torch import runner
    from acn_tpu_torch.models import nn
    from acn_tpu_torch.parallel import launch
    from acn_tpu_torch.parallel import mesh as pmesh
    from acn_tpu_torch.pipelines.baking import BakedRenderer, pack_baked
    from acn_tpu_torch.pipelines.offline_stage import train_step as ts
    from acn_tpu_torch.pipelines.renderer import Renderer
    from acn_tpu_torch.utils.config import parse_args

    smi = nvidia_smi()
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    cfg, P, occ_cfg, batch, occ_t = _step_setup(torch, toy, dev)
    K, T, I = cfg.num_submodules, int(P.batch_size), int(P.inner_iter)
    per_step = K * T * (I + 1)
    launches = {}
    torch.cuda.empty_cache()

    # (a) one rank over NCCL
    backend = pmesh.init_one_rank("cuda")
    check(backend == "nccl", f"one rank with a card of its own runs {backend}, want nccl")
    try:
        def fresh():
            m = toy.serving_model(cfg, seed=0, device=dev)
            return (m, *toy.init_train_state(m, P))

        def timed_step(step, state, b, o, gen):
            _zero_scan_counts(segscan)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b, o, gen)
            torch.cuda.synchronize()
            return state, m, 1e3 * (time.perf_counter() - t0), _train_counts(segscan)

        start = None
        plain = []  # two plain steps from one state, one generator seed
        for i in range(2):
            model_p, opt, state = fresh()
            if start is None:
                start = _group_vectors(torch, nn, model_p.params(), opt.labels)
            step = ts.make_meta_train_step(cfg, P, opt, occ_cfg)
            state, m, ms, c = timed_step(step, state, batch, occ_t,
                                         torch.Generator(device=dev).manual_seed(0))
            check(c == budget_want(per_step), f"plain step launches {c}")
            after = _group_vectors(torch, nn, model_p.params(), opt.labels)
            plain.append({"ms": ms, "loss": float(m["loss_total"]),
                          "grad_norm": float(m["grad_norm"]),
                          "update": {g: after[g] - start[g] for g in after}})
            del model_p, state, step, after
        pair = {"groups": _update_cmp(torch, plain[1]["update"], plain[0]["update"]),
                **{k: abs(plain[1][k] - plain[0][k]) for k in ("loss", "grad_norm")}}

        def mesh_run(n_steps, fault=None):
            """The one-rank mesh step from the fresh model, n_steps times:
            (ms, launches, (collectives, bytes)) of each, and the first
            step's update, loss and gradient norm."""
            mesh = pmesh.Mesh.build(K, 1, 1)
            if fault == "mean":
                _lose_the_mean(mesh, T)
            model_m, opt, state = fresh()
            sh = pmesh.shard_by_expert_axis({"model": model_m, "opt_state": state["opt_state"],
                                             "occ_states": occ_t, "batch": batch}, mesh, K)
            del model_m
            state = {**state, "model": sh["model"], "opt_state": sh["opt_state"]}
            step = ts.make_meta_train_step(cfg, P, opt, occ_cfg, mesh=mesh)
            gen = torch.Generator(device=dev).manual_seed(0)
            out = {"ms": [], "launches": [], "hash": [], "collectives": []}
            for i in range(n_steps):
                c0 = dict(mesh.stats)
                if fault == "draws":  # keyed one expert off
                    with _draws_keyed(ts, lambda k0: k0 + 1):
                        state, m, ms, c = timed_step(step, state, sh["batch"],
                                                     sh["occ_states"], gen)
                else:
                    state, m, ms, c = timed_step(step, state, sh["batch"], sh["occ_states"],
                                                 gen)
                out["ms"].append(ms)
                out["launches"].append(c)
                out["hash"].append(_kernel_counts())
                out["collectives"].append((mesh.stats["collectives"] - c0["collectives"],
                                           mesh.stats["bytes"] - c0["bytes"]))
                if i == 0:
                    after = _group_vectors(torch, nn, state["model"].params(), opt.labels)
                    out.update(loss=float(m["loss_total"]), grad_norm=float(m["grad_norm"]),
                               update={g: after[g] - start[g] for g in after})
                    del after
            del state, step, sh
            torch.cuda.empty_cache()
            return out

        run_a = mesh_run(MESH_STEPS)
        note_hash("mesh_one_rank_step", True,
                  tuple(sum(c[i] for c in run_a["hash"]) for i in range(5)))
        check(all(c == budget_want(per_step) for c in run_a["launches"]),
              f"one-rank mesh step launches {run_a['launches']}, want "
              f"{budget_want(per_step)}")
        launches["mesh_one_rank_step"] = tuple(sum(c[i] for c in run_a["launches"])
                                               for i in (0, 1))
        ref_a = {k: plain[0][k] for k in ("loss", "grad_norm")}
        got_a = {**run_a, "cmp": _update_cmp(torch, run_a["update"], plain[0]["update"])}
        misses = _mesh_misses(got_a, ref_a, pair)
        check(not misses, f"(a) the one-rank step against the plain step: {misses}")
        faults_a = {}
        for fault in ("draws", "mean"):
            f = mesh_run(1, fault)
            f["cmp"] = _update_cmp(torch, f["update"], plain[0]["update"])
            faults_a[fault] = {"misses": _mesh_misses(f, ref_a, pair), "loss": f["loss"],
                               "grad_norm": f["grad_norm"], "update_vs_plain": f["cmp"]}
            check(faults_a[fault]["misses"],
                  f"(a) planted fault {fault!r} passed the bound: {faults_a[fault]}")
        plain_ms = [{k: x[k] for k in ("ms", "loss", "grad_norm")} for x in plain]
        del plain
        torch.cuda.empty_cache()

        # (a) the 1080p frame through the fan-out against the plain frame
        renderer = Renderer(cfg, P, occ_cfg)
        cam = toy.overhead_camera(H, W)
        rmesh = pmesh.Mesh(num_experts=0, shape=(1,), rank=0, axis_names=("px",))
        sky = frame_bg_draws(torch, renderer.chunk_rays // W, dev)
        frame = lambda mesh=None: renderer.render_image(model, occ, H=H, W=W, mesh=mesh,
                                                        draws=sky, **cam)
        frame(), frame(rmesh)  # warm
        frame_ms = {"plain": [], "mesh": []}
        mesh_counts_f, mesh_comp = [0, 0], 0
        for name in ("plain", "mesh", "mesh", "plain"):
            _zero_scan_counts(segscan)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = frame(rmesh if name == "mesh" else None)
            frame_ms[name].append(1e3 * (time.perf_counter() - t0))
            if name == "plain":
                plain_frame = out
            else:
                mesh_frame = out
                mesh_counts_f = [a + b for a, b in zip(mesh_counts_f, _scan_counts(segscan))]
                mesh_comp += _comp_fwd()
                note_hash("mesh_one_rank_frame", trains=False)
        chunks = -(-H // (renderer.chunk_rays // W))
        check_packed("(a) two fan-out frames", mesh_counts_f, 2 * chunks, mesh_comp)
        launches["mesh_one_rank_frame"] = tuple(mesh_counts_f)
        err = float(np.abs(mesh_frame[0] - plain_frame[0]).max())
        check(err <= U8_STEP, f"(a) fan-out frame vs plain frame: max |Δrgb| {err}")
        emit({"phase": "mesh_one_rank", "backend": backend, "mesh": [1, 1],
              "step_ms": run_a["ms"], "plain_step_ms": [x["ms"] for x in plain_ms],
              "loss": run_a["loss"], "plain_loss": [x["loss"] for x in plain_ms],
              "grad_norm": run_a["grad_norm"],
              "plain_grad_norm": [x["grad_norm"] for x in plain_ms],
              "launches_per_step": run_a["launches"],
              "collectives_per_step": run_a["collectives"][-1][0],
              "collective_bytes_per_step": run_a["collectives"][-1][1],
              "update_vs_plain": got_a["cmp"], "plain_vs_plain": pair["groups"],
              "planted_faults": faults_a, "frame_ms": frame_ms["mesh"],
              "plain_frame_ms": frame_ms["plain"], "frame_max_abs_rgb": err,
              "frame_host_gathers": rmesh.stats.get("host_collectives"),
              "frame_host_bytes": rmesh.stats.get("host_bytes"), "nvidia_smi": smi})
    finally:
        pmesh.shutdown()
    # (b) is held against (a)'s first step: the one-rank step of its draws
    ref_update = run_a.pop("update")
    ref_b = {k: run_a[k] for k in ("loss", "grad_norm")}
    del start

    # (b) two ranks sharing the card over gloo
    bh, bw = MESH_BAKED_HW
    rng = np.random.default_rng(0)
    table = rng.random((33 ** 3, 4)).astype(np.float32)
    table[:, -1] = np.where(rng.random(33 ** 3) < 0.4, 4.0 * rng.random(33 ** 3), 0.0)
    baked = pack_baked(table, toy.SCENE_AABB, 33, occ_resolution=33, device="cpu")
    baked_kw = dict(s_max=64, budget_per_ray=16, chunk_points=16 * bw * 8)
    bcam = toy.overhead_camera(bh, bw)
    baked_1 = BakedRenderer(_baked_to(torch, nn, baked, dev), **baked_kw).render_image(
        H=bh, W=bw, intrinsics=bcam["intrinsics"], c2w=bcam["c2w"])
    t0 = time.perf_counter()
    ranks = launch.spawn("chip_smoke:mesh_rank_11b", 2, {"baked": baked,
                                                          "baked_kw": baked_kw},
                         MESH_DIR / "ranks", device_type="cuda", timeout_s=300,
                         init_timeout_s=120)
    spawn_s = time.perf_counter() - t0
    r0 = ranks[0]
    check(all(r["backend"] == "gloo" for r in ranks), "two ranks on one card must run gloo")
    for r in ranks:
        for l in r["step"]["launches"]:
            check(l["this_rank"] == list(budget_want(per_step // 2))
                  and l["summed"] == list(budget_want(per_step)),
                  f"(b) launches per step {l}, want {budget_want(per_step // 2)} a rank")
    launches["mesh_two_rank_step"] = tuple(
        sum(l["summed"][i] for l in r0["step"]["launches"]) for i in (0, 1))
    note_hash("mesh_two_rank_step", True, tuple(
        sum(l["hash"][i] for r in ranks for l in r["step"]["launches"]) for i in range(5)))
    def got_b(run):
        m = run["metrics"]
        return {"cmp": _update_cmp(torch, run["update"], ref_update),
                "loss": float(m["loss_total"]), "grad_norm": float(m["grad_norm"])}

    sound = got_b(r0["step"])
    misses = _mesh_misses(sound, ref_b, pair)
    check(not misses, f"(b) the two-rank step against the one-rank step: {misses}")
    faults_b = {}
    for fault, run in r0["faults"].items():
        f = got_b(run)
        faults_b[fault] = {"misses": _mesh_misses(f, ref_b, pair), "loss": f["loss"],
                           "grad_norm": f["grad_norm"], "update_vs_one_rank": f["cmp"]}
        check(faults_b[fault]["misses"],
              f"(b) planted fault {fault!r} passed the bound: {faults_b[fault]}")
    err_frame = float(np.abs(r0["frame"]["rgb"] - plain_frame[0]).max())
    check(err_frame <= U8_STEP, f"(b) row-block frame vs plain: max |Δrgb| {err_frame}")
    err_baked = float(np.abs(r0["baked"][0] - baked_1[0]).max())
    check(err_baked <= U8_STEP and float(baked_1[2].max()) > 0.5,
          f"(b) baked frame over 2 ranks vs one: max |Δrgb| {err_baked}")
    launches["mesh_two_rank_frame"] = tuple(
        sum(r["frame"]["launches"][i] for r in ranks) for i in (0, 1))
    note_hash("mesh_two_rank_frame", False,
              tuple(sum(r["frame"]["hash"][i] for r in ranks) for i in range(5)))
    n_disp = -(-H // (2 * (renderer.chunk_rays // W)))  # dispatches of 2 × rows
    check_packed("(b) two timed frames over 2 ranks", launches["mesh_two_rank_frame"],
                 2 * 2 * n_disp, sum(r["frame"]["hash"][3] for r in ranks))
    emit({"phase": "mesh_two_ranks", "backend": "gloo", "mesh": [2, 1],
          "note": "two ranks share one card: correctness, not a scaling number",
          "step_ms": [r["step"]["ms"] for r in ranks], "loss": sound["loss"],
          "one_rank_loss": ref_b["loss"], "grad_norm": sound["grad_norm"],
          "one_rank_grad_norm": ref_b["grad_norm"],
          "launches_per_step": r0["step"]["launches"], "update_vs_one_rank": sound["cmp"],
          "planted_faults": faults_b,
          "frame_ms": [r["frame"]["ms"] for r in ranks], "frame_max_abs_rgb": err_frame,
          "baked_max_abs_rgb": err_baked, "frame_host": r0["host_stats"],
          "spawn_wall_s": spawn_s, "nvidia_smi": smi})
    del ref_update, ranks
    torch.cuda.empty_cache()

    # (c) --op train as two processes
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    toy.write_dataset_dir(MESH_DIR / "data", K=4, train_cams=8, val_cams=2, H=96, W=128)
    run = MESH_DIR / "train"
    port = _free_port()
    argv = lambda i: [sys.executable, "-m", "acn_tpu_torch", "--op", "train",
                      "--configPath", str(Path(__file__).resolve().parent / "configs" /
                                          "train_occ.json"),
                      "--data_path", str(MESH_DIR / "data"), "--fname", str(run),
                      "--outer_steps", str(MESH_RUN_STEPS), "--occ_warmup", "2",
                      "--occ_auto_patience", "1",
                      "--eval_step", "4", "--save_step", "4", "--print_step", "1",
                      "--mesh_experts", "2", "--num_processes", "2", "--process_id", str(i),
                      "--coordinator_address", f"127.0.0.1:{port}"]
    logs = [open(MESH_DIR / f"runner{i}.log", "w") for i in range(2)]
    procs = [subprocess.Popen(argv(i), cwd=str(Path(__file__).resolve().parent),
                              stdout=logs[i], stderr=subprocess.STDOUT) for i in range(2)]
    t0 = time.perf_counter()
    try:
        codes = [p.wait(timeout=400) for p in procs]
    except subprocess.TimeoutExpired:
        codes = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    runner_s = time.perf_counter() - t0
    out = [(MESH_DIR / f"runner{i}.log").read_text() for i in range(2)]
    check(codes == [0, 0], f"(c) two-process --op train exited {codes}:\n"
          + "\n".join(o[-3000:] for o in out))
    step_lines = [len(re.findall(r"\] step \d+/\d+ ", o)) for o in out]
    check(step_lines[0] == MESH_RUN_STEPS and step_lines[1] == 0,
          f"(c) step lines per rank {step_lines}, want {MESH_RUN_STEPS} from rank 0 and "
          f"none from rank 1")
    check("backend gloo" in out[0] and "switching to the global-budget marcher" in out[0],
          "(c) the run did not name its gloo backend or did not switch regime")
    check(sorted(p.name for p in MESH_DIR.iterdir() if p.name.startswith("train")) == ["train"]
          and (run / "last.model").exists(), "(c) `last` was not written once")
    ctx = runner.build_context(parse_args([
        "--op", "eval", "--configPath", str(Path(__file__).resolve().parent / "configs" /
                                             "eval.json"),
        "--data_path", str(MESH_DIR / "data"), "--checkpoint_path", str(run), "--prefix",
        "last", "--fname", str(MESH_DIR / "reload")]), "bench")
    n_keys = len(ctx["model"].state_dict())
    check(ctx["step"] == MESH_RUN_STEPS and ctx["occ_states"] is not None,
          f"(c) `last` reloads at step {ctx['step']}")
    del ctx
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    emit({"phase": "mesh_runner", "processes": 2, "mesh": [2, 1], "steps": MESH_RUN_STEPS,
          "step_lines_per_rank": step_lines, "wall_s": runner_s,
          "last_reloaded_keys": n_keys, "phase_wall_s": time.perf_counter() - t_phase,
          "nvidia_smi": smi})
    return launches


# ---------------------------------------------------------------- phase 12

LIVE_STEPS = 16
LIVE_MIN_FRAMES = 4
# the loop pauses itself once it is this many steps ahead of the frames
# (each frame resumes it), so 16 steps span at least 4 frames whatever the
# relative speed of steps and frames on the shared stream
LIVE_STEPS_PER_FRAME = 4
LIVE_BATCH_VIEWS = 8
LIVE_EVAL_RAYS = 8192
# the live run against the sequential one, per step, in PSNR: the card's
# atomic sums (``index_add_``) leave their last bits free, as phase 9 holds
# its two renders of one table to 1e-3 dB
LIVE_PSNR_ATOL = 1e-3


def _checksum(torch, model):
    """Each state tensor's bits summed as integers (int64, exact): equal
    sums before and after a frame show that nothing wrote the snapshot."""
    ints = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}
    return torch.stack([v.detach().contiguous().view(-1).view(ints[v.element_size()]).sum()
                        for v in model.state_dict().values()]).cpu()


def _state_equal(torch, a, b) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def phase_live(torch, segscan, toy, run, baked_path) -> dict:
    """Live runtime adaptation at full width (module docstring, phase 12),
    on phase 8's run and phase 9's baked table; removes phase 8's directory
    at its end. Returns the scan's launch counts by path."""
    import shutil

    from acn_tpu_torch import runner
    from acn_tpu_torch.data import dataset, tasks
    from acn_tpu_torch.pipelines.baking import BakedRenderer, load_baked
    from acn_tpu_torch.pipelines.renderer import Renderer
    from acn_tpu_torch.utils.config import parse_args
    from acn_tpu_torch.viewer import viewer as tviewer
    from acn_tpu_torch.viewer.engine.controller import Controller
    from acn_tpu_torch.viewer.engine.runners.meta_train import MetaTrainRunner
    from acn_tpu_torch.viewer.engine.runners.runtime_adapt import RuntimeAdaptRunner
    from acn_tpu_torch.viewer.utils import RUB_TO_DRB, verify_continual_batch_dir

    t_phase = time.perf_counter()
    smi = nvidia_smi()
    torch.cuda.empty_cache()
    counted = {}
    saved = (dataset.RAY_CACHE, tasks.ROUTE_CACHE)
    dataset.RAY_CACHE, tasks.ROUTE_CACHE = RUNNER_DIR / "rays", RUNNER_DIR / "routes"
    try:
        # (a) the view context and previews at the viewer's size
        ctx = runner.build_context(parse_args(_run_flags(
            "view.json", "--checkpoint_path", str(run), "--prefix", "last",
            "--fname", str(RUNNER_DIR / "view"))), "view")
        P = ctx["P"]
        check(ctx["occ_states"] is not None and int(P.occ_budget_per_ray) == 32,
              "the view context must restore the grids and the packed budget 32")
        ckpt = {k: v.detach().clone() for k, v in ctx["model"].state_dict().items()}
        controller = Controller(ctx)
        renderer = Renderer(ctx["cfg"], P, ctx["occ_cfg"], device=ctx["device"])
        state = tviewer.ViewerState(P)
        # turbo needs matplotlib, which the viewer imports only for it
        import importlib.util

        if importlib.util.find_spec("matplotlib") is None:
            state.depth_colormap = "gray"
        H, W = toy.LIVE_PREVIEW
        md = dataset.get_image_metadata(ctx["data_path"], P.downscale)[1][0]
        c2w = np.asarray(md.c2w, np.float32)  # origin 0, pose scale 1: the viewer's world
        cam = dict(c2w_rub_world=np.concatenate(
            [RUB_TO_DRB.T @ c2w[:, :3], (RUB_TO_DRB.T @ c2w[:, 3])[:, None]], 1),
            H=H, W=W, fx=float(md.intrinsics[1]) * H / md.H,
            fy=float(md.intrinsics[1]) * H / md.H, cx=W / 2, cy=H / 2)
        chunks = -(-H // max(renderer.chunk_rays // W, 1))

        def frame(preview=True):
            return tviewer.render_frame(ctx, controller, renderer, state, preview=preview, **cam)

        frame()  # warm
        view_counts, view_ms, frame_std = [0, 0], {}, {}
        for preview in (True, False):
            for display in ("rgb", "depth", "opacity"):
                state.display = display
                _zero_scan_counts(segscan)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                img = frame(preview)
                name = f"{'preview' if preview else 'full'}_{display}"
                view_ms[name] = 1e3 * (time.perf_counter() - t0)
                got = _scan_counts(segscan)
                note_hash("viewer_frames", trains=False)
                check_packed(f"(a) a {name} frame", got, chunks)
                view_counts = [view_counts[0] + got[0], view_counts[1] + got[1]]
                # depth and opacity may be flat where the field is faint
                check(img.dtype == np.uint8 and img.shape == (H, W, 3)
                      and (display != "rgb" or img.std() > 0),
                      f"(a) the {name} frame is {img.dtype} {img.shape}, std {img.std()}")
                frame_std[name] = float(img.std())
        state.display = "rgb"
        idle_ms = [view_ms["preview_rgb"]]
        for _ in range(2):
            idle_ms.append(_timed(torch, frame, 1)[0])
        counted["view_frames"] = tuple(view_counts)
        ctx["baked_renderer"] = BakedRenderer(
            load_baked(baked_path, device=ctx["device"]),
            budget_per_ray=int(P.occ_budget_per_ray or 24), chunk_points=int(P.chunk_points),
            bg_color=P.bg_color_default)
        state.use_baked = True
        frame()  # warm
        baked_ms = _timed(torch, frame, 2)
        baked_img = frame()
        check(baked_img.shape == (H, W, 3) and baked_img.std() > 0, "(a) the baked preview")
        del ctx["baked_renderer"]
        state.use_baked = False
        emit({"phase": "live_view", "H": H, "W": W, "chunks_per_frame": chunks,
              "composite_launches_per_frame": chunks, "frame_ms": view_ms,
              "frame_std": frame_std,
              "preview_idle_ms": idle_ms, "baked_preview_ms": baked_ms,
              "depth_colormap": state.depth_colormap, "nvidia_smi": smi})

        # (b) a continual batch in update_dataset.py's layout
        t0 = time.perf_counter()
        batch = toy.write_continual_batch(ctx["data_path"], "b000", views=LIVE_BATCH_VIEWS,
                                          K=4, H=RUNNER_IMAGE[0], W=RUNNER_IMAGE[1])
        ok, msgs = verify_continual_batch_dir(batch)
        check(ok, f"(b) verify_continual_batch_dir refused the batch: {msgs}")
        ingest_s = time.perf_counter() - t0

        # (c) adapt live: the loop thread steps, the main thread renders
        controller.set_mode("runtime_adapt")
        live = controller.runner
        check(live.advance_batch(), "(c) the continual batch gave no rays")
        eval_idx = np.random.default_rng(0).choice(len(live.support), LIVE_EVAL_RAYS,
                                                   replace=False)
        eval_rays, eval_rgbs = live.support.rays[eval_idx], live.support.rgbs[eval_idx]

        def batch_psnr(model):
            rgb = renderer.render_rays(model, ctx["occ_states"], eval_rays)[0]
            return float(-10.0 * np.log10(np.mean((rgb - eval_rgbs) ** 2)))

        psnr_before = batch_psnr(ctx["model"])
        metrics, step_live_ms, frames_started = [], [], [0]

        def on_update(m):  # on the loop thread, after each step
            metrics.append(m)
            if (len(metrics) >= LIVE_STEPS_PER_FRAME * frames_started[0]
                    and len(metrics) < LIVE_STEPS):
                controller.pause()

        def timed_step(step=live.step):
            t0 = time.perf_counter()
            m = step()  # ends with the loss on the host
            step_live_ms.append(1e3 * (time.perf_counter() - t0))
            return m

        controller.on_update = on_update
        live.step = timed_step
        reads = []
        real_render = renderer.render_image

        def render_checked(model, occ_states, **kw):
            before = _checksum(torch, model)
            out = real_render(model, occ_states, **kw)
            reads.append((before, _checksum(torch, model)))
            return out

        renderer.render_image = render_checked
        _zero_scan_counts(segscan)
        live_ms = []
        t_start = time.perf_counter()
        controller.start(target_steps=LIVE_STEPS)
        while controller.is_running:
            frames_started[0] += 1
            controller.resume()
            t0 = time.perf_counter()
            frame()
            torch.cuda.synchronize()
            live_ms.append(1e3 * (time.perf_counter() - t0))
            check(time.perf_counter() - t_start < 300, "(c) the live run took over 300 s")
        controller._thread.join(timeout=60)
        check(not controller._thread.is_alive(), "(c) the loop thread did not end")
        renderer.render_image = real_render
        live_counts, live_comp = _scan_counts(segscan), _comp_fwd()
        note_hash("viewer_live_frames_and_tto", True, net="serves")
        check(controller.last_error is None, f"(c) the loop failed:\n{controller.last_error}")
        check(live.steps == LIVE_STEPS and len(metrics) == LIVE_STEPS,
              f"(c) {live.steps} steps, {len(metrics)} metrics, want {LIVE_STEPS}")
        losses = [m["loss"] for m in metrics]
        check(np.isfinite(losses).all(), f"(c) losses {losses}")
        check(len(live_ms) >= LIVE_MIN_FRAMES,
              f"(c) {len(live_ms)} frames during the run, want {LIVE_MIN_FRAMES}")
        check(len(step_live_ms) == LIVE_STEPS, f"(c) {len(step_live_ms)} timed steps")
        torn = [i for i, (a, b) in enumerate(reads) if not torch.equal(a, b)]
        check(not torn, f"(c) frames {torn} of {len(reads)} read a snapshot that changed")
        seen = len({tuple(a.tolist()) for a, _ in reads})
        check(seen >= 2, f"(c) every frame read the same snapshot ({seen})")
        # a composite launch per chunk of every frame, none for the TTO steps
        check_packed(f"(c) the live run ({len(reads)} frames, {LIVE_STEPS} TTO steps)",
                     live_counts, chunks * len(reads), live_comp)
        counted["live_frames"] = live_counts
        with live.get_render_params() as (published, _):
            check(_state_equal(torch, published, live.model),
                  "(c) the last snapshot is not the trained model")
            psnr_after = batch_psnr(published)
        check(psnr_after > psnr_before, f"(c) PSNR over {LIVE_EVAL_RAYS} rays of the batch "
              f"went from {psnr_before} to {psnr_after} dB")

        # the same 16 steps in sequence, no frames: the same draws and rays
        seq = RuntimeAdaptRunner(ctx)
        seq.advance_batch()  # the support store, as the live run's, before the timed steps
        _zero_scan_counts(segscan)
        seq_metrics, step_alone_ms = [], []
        for _ in range(LIVE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            seq_metrics.append(seq.step())
            torch.cuda.synchronize()
            step_alone_ms.append(1e3 * (time.perf_counter() - t0))
        seq_counts = _scan_counts(segscan)
        note_hash("viewer_tto_steps", True)
        check(seq_counts == (0, 0), f"(c) 16 TTO steps launched {seq_counts}, want none")
        counted["tto_steps"] = seq_counts
        psnr_diff = [abs(a["psnr"] - b["psnr"]) for a, b in zip(metrics, seq_metrics)]
        check(max(psnr_diff) <= LIVE_PSNR_ATOL,
              f"(c) live against sequential steps: PSNR apart by {max(psnr_diff)} dB")
        param_diff = max(float((a - b).abs().max()) for a, b in zip(
            live.model.state_dict().values(), seq.model.state_dict().values()))
        publish_ms = []
        for _ in range(10):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            seq._publish()
            end.record()
            torch.cuda.synchronize()
            publish_ms.append(start.elapsed_time(end))
        state_mb = sum(v.numel() * v.element_size() for v in seq.model.state_dict().values()) / 1e6
        emit({"phase": "live_adapt", "steps": LIVE_STEPS, "batch_views": LIVE_BATCH_VIEWS,
              "ingest_s": ingest_s, "losses": losses,
              "psnr_batch_before_after": [psnr_before, psnr_after],
              "frames_during_run": len(live_ms), "frames_checked": len(reads),
              "snapshots_seen": seen, "torn_frames": len(torn),
              "preview_during_training_ms": live_ms, "tto_step_during_frames_ms": step_live_ms,
              "tto_step_alone_ms": step_alone_ms, "snapshot_publish_ms": publish_ms,
              "snapshot_mb": state_mb, "live_vs_sequential_psnr_max_abs": max(psnr_diff),
              "live_vs_sequential_param_max_abs": param_diff,
              "scan_launches_live": live_counts, "scan_launches_16_tto_steps": seq_counts,
              "nvidia_smi": smi})

        # (d) reset, and the runtime checkpoint's round trip
        live.reset_fast()
        check(live.steps == 0 and all(torch.equal(v, ckpt[k])
                                      for k, v in live.model.state_dict().items()),
              "(d) reset_fast did not give back the checkpoint's bits")
        with live.get_render_params() as (published, _):
            check(_state_equal(torch, published, live.model), "(d) the reset was not published")
        rt = RUNNER_DIR / "runtime_ckpt"
        t0 = time.perf_counter()
        seq.save_runtime_checkpoint(rt)
        save_s = time.perf_counter() - t0
        del controller, live
        back = RuntimeAdaptRunner(ctx)
        t0 = time.perf_counter()
        back.load_runtime_checkpoint(rt)
        load_s = time.perf_counter() - t0
        check(back.steps == LIVE_STEPS and _state_equal(torch, back.model, seq.model),
              "(d) the runtime checkpoint did not give back the saved bits")
        check(all(torch.equal(ctx["model"].state_dict()[k], v) for k, v in ckpt.items()),
              "(d) the context's model was written")
        emit({"phase": "live_reset_checkpoint", "reset_bit_equal": True,
              "runtime_checkpoint_bit_equal": True, "save_s": save_s, "load_s": load_s})
        del back, seq, ctx, ckpt
        torch.cuda.empty_cache()

        # (e) the meta-train mode on a train context's sampler
        tctx = runner.build_context(parse_args(_run_flags(
            "train_occ.json", "--checkpoint_path", str(run), "--prefix", "last",
            "--fname", str(RUNNER_DIR / "meta_view"))), "train")
        meta = MetaTrainRunner(tctx)
        meta_ms, meta_counts, meta_m = [], [0, 0], []
        for _ in range(2):
            _zero_scan_counts(segscan)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            meta_m.append(meta.step())
            torch.cuda.synchronize()
            meta_ms.append(1e3 * (time.perf_counter() - t0))
            got = _scan_counts(segscan)
            note_hash("viewer_meta_train", True)
            check(got == (0, 0), f"(e) a meta-train runner step launched {got}, want none: "
                  "acn_tpu's runner builds its step without the occupancy config")
            meta_counts = [meta_counts[0] + got[0], meta_counts[1] + got[1]]
        check(all(np.isfinite([m["loss"], m["psnr"]]).all() for m in meta_m),
              f"(e) meta-train metrics {meta_m}")
        counted["meta_train_runner"] = tuple(meta_counts)
        emit({"phase": "live_meta_train", "steps": 2, "regime": "stratified",
              "step_ms": meta_ms, "metrics": meta_m, "scan_launches": meta_counts,
              "phase12_s": time.perf_counter() - t_phase, "nvidia_smi": smi})
        del meta, tctx
    finally:
        dataset.RAY_CACHE, tasks.ROUTE_CACHE = saved
        shutil.rmtree(RUNNER_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return counted


# ---------------------------------------------------------------- phase 13

TOOLS_DIR = Path(__file__).resolve().parent / "logs" / "chip_smoke_tools"
DRZ_VIEWS, DRZ_IMAGE, DRZ_IMAGES = (4, 2), (1536, 2048), 187 + 62  # (16, 4) before
CLUSTER_SAMPLES = 256
CLUSTER_FLAGS = ["--grid_dim", "2", "2", "--cluster_2d", "--boundary_margin", "1.1",
                 "--ray_samples", str(CLUSTER_SAMPLES), "--center_pixels", "--scene_scale",
                 "1.1", "--altitude_range", "-1", "1"]  # toy data: X (Down) in [-1, 1]
ROUTE_CHECK = (2, 0.125)  # images and downscale of the card-against-CPU routing
TIE_RTOL = 1e-5  # tests/test_torch_create_clusters.py: a sample this near a boundary
BOX_ATOL = 4 * float(np.spacing(np.float32(2.0)))  # 4 ulps of the operands' scale
TOOLS_STEPS = 3  # 4 before, cut for the smoke's time
CONVERT_RAYS = 512  # 2,048 before, cut for the smoke's time
# the reference's pinned architecture (its {tag}.P): 4 experts, 64-wide MLPs,
# the corner grid's 2^20 rows per level (L16 F2 by the parser's defaults)
CONVERT_REF = {"num_submodules": 4, "sigma_depth": 2, "color_depth": 2, "dim_hidden": 64,
               "color_hidden": 64, "log2_hashmap_size": 20}


def route_ties(rays, cents, margin: float, S: int, block: int = 8192) -> np.ndarray:
    """Per ray (cluster_2d, valid rays), the number of its (sample, cell)
    pairs within ``TIE_RTOL`` of the cell's boundary at ``margin``: where
    the card's and the CPU's roundings may decide otherwise (float64)."""
    out = []
    for s in range(0, len(rays), block):
        r = rays[s:s + block].astype(np.float64)
        z = np.linspace(0.0, 1.0, S)
        t = r[:, 6:7] * (1 - z) + r[:, 7:8] * z
        x = r[:, None, 1:3] + r[:, None, 4:6] * t[..., None]
        d2 = ((x[..., None, :] - cents[:, 1:].astype(np.float64)) ** 2).sum(-1)
        d2min = d2.min(-1, keepdims=True)
        gap = np.abs(d2 - margin ** 2 * d2min) / np.maximum(d2min, 1e-30)
        if margin == 1.0:  # the nearest cell itself is no tie
            np.put_along_axis(gap, d2.argmin(-1)[..., None], np.inf, -1)
        valid = np.isfinite(r[:, 6]) & np.isfinite(r[:, 7]) & (r[:, 7] > r[:, 6])
        out.append(np.where(valid, (gap < TIE_RTOL).sum(axis=(1, 2)), 0))
    return np.concatenate(out)


def _mask_files(d: Path) -> list:
    return sorted(p.relative_to(d) for p in d.rglob("*.pt") if p.parent.name.isdigit())


def phase_tools(torch, segscan, toy, profile_dir) -> tuple:
    """The host tooling at the reference scene's width (module docstring,
    phase 13). Returns the scan's launch counts of (d) and (f)."""
    import contextlib
    import io
    import shutil

    from acn_tpu_torch import runner
    from acn_tpu_torch.data import dataset, tasks
    from acn_tpu_torch.data.ray_prep import get_ray_directions_np, get_rays_np
    from acn_tpu_torch.ops import analyze_trace, bench_gather_scatter, bench_step_breakdown
    from acn_tpu_torch.pipelines.renderer import Renderer
    from acn_tpu_torch.scripts import convert_reference_ckpt as conv
    from acn_tpu_torch.scripts import create_clusters as cc
    from acn_tpu_torch.scripts import log_dataset_info, log_mask_info, summarize_run
    from acn_tpu_torch.scripts import visualize_clustering as viz
    from acn_tpu_torch.utils import checkpoint as tck
    from acn_tpu_torch.utils.config import parse_args

    smi = nvidia_smi()
    t_phase = time.perf_counter()
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    saved = (dataset.RAY_CACHE, tasks.ROUTE_CACHE)
    dataset.RAY_CACHE, tasks.ROUTE_CACHE = TOOLS_DIR / "rays", TOOLS_DIR / "routes"
    counted = [0, 0]
    procs, logs = [], []

    def quiet(fn, *a):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = fn(*a)
        return res, out.getvalue()

    try:
        # (a) create_clusters on the card over DRZ_VIEWS metadata views of
        # 2048 × 1536 (toy PNGs of 64 × 48 beside them; the tool reads none)
        _zero_scan_counts(segscan)
        n_tr, n_va = DRZ_VIEWS
        scale = 48 / DRZ_IMAGE[0]
        data = toy.write_dataset_dir(TOOLS_DIR / "drz", K=4, train_cams=n_tr, val_cams=n_va,
                                     H=48, W=64, downscale=scale)
        argv = ["--data_path", str(data), *CLUSTER_FLAGS]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timing, _ = quiet(cc.main, cc.build_parser().parse_args(
            argv + ["--output", "g22", "--device", DEV]))
        wall_s = time.perf_counter() - t0
        out_a = data / "masks" / "g22"
        files = _mask_files(out_a)
        check(timing["images"] == n_tr + n_va and len(files) == 4 * (n_tr + n_va),
              f"(a) {timing['images']} images routed, {len(files)} mask files")
        boxes = torch.load(out_a / "scene_boxes.pt", weights_only=False)
        params = torch.load(out_a / "params.pt", weights_only=False)
        g = boxes["aabb_global"].numpy()
        mins, maxs, counts = boxes["mins"].numpy(), boxes["maxs"].numpy(), boxes["counts"]
        check(counts.dtype == torch.int64 and bool((counts > 0).all()),
              f"(a) per-expert sample counts {counts.tolist()}")
        check(bool((mins >= g[0]).all() and (maxs <= g[1]).all() and (mins < maxs).all()),
              f"(a) expert boxes {mins.tolist()} .. {maxs.tolist()} outside {g.tolist()}")
        per_image = (timing["host_rays"] + timing["route"] + timing["write"]) / timing["images"]
        host_share = (timing["host_rays"] + timing["write"]) / (
            timing["host_rays"] + timing["route"] + timing["write"])
        # the router on the card against the CPU, on 2 images at downscale 0.125
        cents = params["centroids"].numpy()
        metas = sorted((data / "train" / "metadata").glob("*.pt"))[:ROUTE_CHECK[0]]
        check_stats = []
        for mp in metas:
            md = torch.load(mp, weights_only=False)
            ds = ROUTE_CHECK[1]
            fx, fy, cx, cy = [float(v) * ds for v in md["intrinsics"][:4]]
            dirs = get_ray_directions_np(int(round(int(md["H"]) * ds)),
                                         int(round(int(md["W"]) * ds)), fx, fy, cx, cy, True)
            rays = get_rays_np(dirs, np.asarray(md["c2w"], np.float32), aabb=g).reshape(-1, 8)
            got = cc.make_voronoi_kernel(cents, True, 1.1, CLUSTER_SAMPLES, device=DEV)(rays)
            want = cc.make_voronoi_kernel(cents, True, 1.1, CLUSTER_SAMPLES,
                                          device="cpu")(rays)
            ties = route_ties(rays, cents, 1.1, CLUSTER_SAMPLES)
            differ = (got[0] != want[0]).any(1)
            check(not (differ & (ties == 0)).any(), "(a) card against CPU: "
                  f"{int((differ & (ties == 0)).sum())} differing rays are no tie")
            box_err = max(float(np.abs(got[i].astype(np.float64) - want[i]).max())
                          for i in (1, 2))
            check(box_err <= BOX_ATOL, f"(a) card against CPU boxes differ by {box_err}")
            count_diff = int(np.abs(got[3] - want[3]).sum())
            check(count_diff <= int(ties.sum()), f"(a) card against CPU counts "
                  f"{got[3].tolist()} / {want[3].tolist()}, {int(ties.sum())} tie samples")
            check_stats.append({"rays": len(rays), "differing_rays": int(differ.sum()),
                                "tie_samples": int(ties.sum()), "box_max_abs_err": box_err,
                                "counts_abs_diff": count_diff})
        emit({"phase": "tools_create_clusters", "images": timing["images"],
              "image_hw": list(DRZ_IMAGE), "rays_per_image": DRZ_IMAGE[0] * DRZ_IMAGE[1],
              "ray_samples": CLUSTER_SAMPLES, "wall_s": wall_s, "ms_per_image": 1e3 * per_image,
              "host_share": host_share, "host_rays_s": timing["host_rays"],
              "route_s": timing["route"], "write_s": timing["write"],
              "projected_drz_s": DRZ_IMAGES * per_image, "counts": counts.tolist(),
              "card_vs_cpu": check_stats, "nvidia_smi": smi})

        # (b) two processes sharing the card, rank 1 started first; they run
        # while (c)-(e) do, and are read before (f) measures
        repo = Path(__file__).resolve().parent
        base = [sys.executable, "-m", "acn_tpu_torch.scripts.create_clusters", *argv,
                "--output", "g22_mp", "--world_size", "2", "--merge_timeout", "300",
                "--device", DEV]
        logs = [open(TOOLS_DIR / f"rank{r}.log", "w") for r in (1, 0)]
        t_ranks = time.perf_counter()
        procs = [subprocess.Popen(base + ["--rank", str(r)], cwd=str(repo), stdout=f,
                                  stderr=subprocess.STDOUT) for r, f in zip((1, 0), logs)]

        # (c) the audits on (a)'s outputs, and the clustering figures' arrays
        _, text = quiet(log_mask_info.main, log_mask_info.build_parser().parse_args(
            ["--mask_dir", str(out_a)]))
        overlap = float(re.search(r"overlap ([\d.]+)% of assigned", text)[1])
        assigned = float(re.search(r"assigned ([\d.]+)% of pixels", text)[1])
        check(overlap > 0 and assigned > 0, f"(c) log_mask_info:\n{text}")
        info = log_dataset_info.dataset_info(data)
        check(f"split train: {n_tr} images" in info and f"split val: {n_va} images" in info,
              f"(c) log_dataset_info:\n{info}")
        img, owner, _, _ = viz.region_image(cents, g, 1.1)
        plain = (img.reshape(-1, 1, 3) == viz.CELL_COLORS[None]).all(-1).any(-1)
        check(set(np.unique(owner)) == {0, 1, 2, 3} and not plain.all(),
              "(c) region map: not 4 cells, or no overlap band")
        md = dataset.get_image_metadata(data, scale)[1][0]
        masks = viz.image_masks(out_a, md, 4)
        over = viz.color_overlay(md.load_image().astype(np.float32) / 255.0, masks)
        check(over.shape == (48, 64, 3) and 0.0 <= over.min() and over.max() <= 1.0
              and masks.any(0).mean() > 0.5, "(c) the overlay")
        emit({"phase": "tools_audits", "overlap_pct": overlap, "assigned_pct": assigned,
              "info_lines": len(info.splitlines()), "region_cells": 4,
              "band_share": float(1 - plain.mean()), "overlay_hw": list(over.shape[:2]),
              "launches": _scan_counts(segscan)})
        check(_scan_counts(segscan) == (0, 0), "(a)-(c) launched the scan")

        # (d) create_clusters rewrites a toy set's masks, then --op train and
        # summarize_run on its log
        toy_root = TOOLS_DIR / "toy"
        tdata = toy.write_dataset_dir(toy_root, K=4, train_cams=8, val_cams=2, H=96, W=128)
        quiet(cc.main, cc.build_parser().parse_args(
            ["--data_path", str(tdata), *CLUSTER_FLAGS, "--downscale", "0.25",
             "--output", "g22_grid_bm110_ss11", "--device", DEV]))
        run = TOOLS_DIR / "train"
        train_argv = [
            "--op", "train", "--configPath", str(repo / "configs" / "train_occ.json"),
            "--data_path", str(toy_root), "--fname", str(run),
            "--outer_steps", str(TOOLS_STEPS), "--occ_warmup", "2", "--occ_auto_patience", "1",
            "--eval_step", "2", "--save_step", str(TOOLS_STEPS), "--print_step", "1"]
        _zero_scan_counts(segscan)
        t0 = time.perf_counter()
        out = runner.main(train_argv, device=DEV)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        got = _train_counts(segscan)
        fwd, rev = got[:2]
        note_hash("host_tools_train", True, net="any")
        P = parse_args(train_argv)
        per_step = P.num_submodules * P.batch_size * (P.inner_iter + 1)  # 108
        regimes = [s["regime"] for s in out["loop"]["steps"]]
        n_budget = regimes.count("budget")
        check(n_budget >= 1 and got == budget_want(per_step * n_budget),
              f"(d) regimes {regimes}, scan and composite launches {got}, "
              f"{budget_want(per_step)} per budget step")
        counted = [fwd, rev]
        del out
        code, text = quiet(summarize_run.main, ["--json", str(run)])
        s = json.loads(text)[str(run)]
        lines = (run / "log.txt").read_text().splitlines()
        n_steps = sum(" loss: " in ln and "s/it" in ln for ln in lines)
        n_evals = sum("[eval] step" in ln for ln in lines)
        check(code == 0 and [x["step"] for x in s["steps"]] == list(
            range(1, TOOLS_STEPS + 1)) and len(s["steps"]) == n_steps
              and len(s["evals"]) == n_evals >= 1,
              f"(d) summarize_run parsed {len(s['steps'])} of {n_steps} step lines and "
              f"{len(s['evals'])} of {n_evals} eval lines")
        emit({"phase": "tools_train_summary", "steps": TOOLS_STEPS, "regimes": regimes,
              "train_s": train_s, "beside": "(b)'s ranks", "scan_launches": [fwd, rev], "step_lines": n_steps,
              "eval_lines": n_evals, "last_eval": s.get("last_eval"),
              "median_s_per_it": s.get("median_s_per_it"), "nvidia_smi": smi})
        torch.cuda.empty_cache()

        # (e) the converter on a reference-style state dict of a full-width
        # corner-layout model (L16 F2, 2^20 rows per level), over (a)'s boxes
        _zero_scan_counts(segscan)
        t0 = time.perf_counter()
        ref = dict(CONVERT_REF)
        ours = conv.ours_from_reference_P(types.SimpleNamespace(**ref), TOOLS_DIR / "drz",
                                          "example", "g22")
        cfg, source = conv.template_model(ours, seed=1)
        hcfg = cfg.expert.hash
        check(hcfg.layout == "corner" and hcfg.levels == 16 and hcfg.features_per_level == 2
              and hcfg.log2_hashmap_size == ref["log2_hashmap_size"],
              f"(e) the converter's grid {hcfg}")
        src = TOOLS_DIR / "reference"
        src.mkdir()
        torch.save(conv.to_reference_state_dict(source), src / "best.model")
        torch.save(ref, src / "best.P")
        quiet(conv.main, ["--src", str(src), "--dst", str(TOOLS_DIR / "converted"),
                          "--data_path", str(TOOLS_DIR / "drz"), "--mask_dirname", "g22"])
        convert_s = time.perf_counter() - t0
        model, _ = tck.restore_model(tck.load_checkpoint(TOOLS_DIR / "converted", "best"),
                                     cfg, device=DEV)
        got_sd, want_sd = model.state_dict(), source.state_dict()
        check(sorted(got_sd) == sorted(want_sd) and all(
            torch.equal(got_sd[k].cpu(), v) for k, v in want_sd.items()),
            "(e) a converted leaf differs from the source model's")
        md = dataset.get_image_metadata(data, scale)[0][0]
        fx, fy, cx, cy = [float(v) for v in md.intrinsics[:4]]
        rays = get_rays_np(get_ray_directions_np(md.H, md.W, fx, fy, cx, cy, True),
                           np.asarray(md.c2w, np.float32), aabb=g).reshape(-1, 8)
        rays = rays[:CONVERT_RAYS]
        rend = Renderer(cfg, ours, None, device=DEV)
        a = rend.render_rays(model, None, rays)
        b = rend.render_rays(source.to(DEV), None, rays)
        rgb_err = float(np.abs(a[0] - b[0]).max())
        acc_err = float(np.abs(a[2] - b[2]).max())
        check(rgb_err <= 1 / 255 and acc_err <= 1e-5 and np.isfinite(a[0]).all(),
              f"(e) converted against source render: rgb {rgb_err}, acc {acc_err}")
        check(_scan_counts(segscan) == (0, 0), "(e) launched the scan")
        emit({"phase": "tools_converter", "experts": 4, "levels": hcfg.levels,
              "features": hcfg.features_per_level, "log2_hashmap_size": hcfg.log2_hashmap_size,
              "leaves": len(want_sd), "convert_s": convert_s, "rays": len(rays),
              "rgb_max_abs_err": rgb_err, "acc_max_abs_err": acc_err,
              "mean_acc": float(b[2].mean()), "nvidia_smi": smi})
        del model, source, rend
        torch.cuda.empty_cache()

        # (b), read: the ranks' masks and boxes against (a)'s
        try:
            codes = [p.wait(timeout=400) for p in procs]
        except subprocess.TimeoutExpired:
            codes = None
        ranks_s = time.perf_counter() - t_ranks
        check(codes == [0, 0], f"(b) ranks exited {codes}:\n" + "\n".join(
            (TOOLS_DIR / f"rank{r}.log").read_text()[-2000:] for r in (1, 0)))
        out_b = data / "masks" / "g22_mp"
        check(_mask_files(out_b) == files, "(b) the ranks wrote other mask files")
        same = sum((out_a / f).read_bytes() == (out_b / f).read_bytes() for f in files)
        check(same == len(files), f"(b) {len(files) - same} masks differ from (a)'s")
        boxes_b = torch.load(out_b / "scene_boxes.pt", weights_only=False)
        check(sorted(boxes_b) == sorted(boxes) and all(
            torch.equal(boxes_b[k], v) if isinstance(v, torch.Tensor) else boxes_b[k] == v
            for k, v in boxes.items()), "(b) scene_boxes.pt differs from (a)'s")
        emit({"phase": "tools_two_ranks", "ranks": 2, "wall_s": ranks_s,
              "beside": "(c)-(e)", "masks_byte_equal": same, "nvidia_smi": smi})

        # (f) the profiling tools
        _zero_scan_counts(segscan)
        rows = bench_gather_scatter.run(device=DEV)
        check(_scan_counts(segscan) == (0, 0), "(f) the gather/scatter bench launched the scan")
        check(all(np.isfinite(r["Mrows_per_s"]) and r["Mrows_per_s"] > 0 for r in rows),
              f"(f) gather/scatter figures {rows}")
        emit({"phase": "tools_gather_scatter", "figures": rows, "nvidia_smi": smi})
        torch.cuda.empty_cache()
        prof = Path(profile_dir or TOOLS_DIR) / "step_breakdown"
        _zero_scan_counts(segscan)
        t0 = time.perf_counter()
        _, text = quiet(bench_step_breakdown.main, ["--iters", "1", "--profile", str(prof),
                                                    "--device", DEV])
        breakdown_s = time.perf_counter() - t0
        brk = json.loads(text.strip().splitlines()[-1])
        launches = _scan_counts(segscan)
        check(launches == (0, 0), f"(f) the breakdown's strided step launched {launches}")
        check(all(np.isfinite(v) and v > 0 for v in brk["ms"].values()),
              f"(f) breakdown {brk['ms']}")
        summary, text = quiet(analyze_trace.main, [str(prof), "--top", "10"])
        cats = sum(summary["by_category"].values())
        check(abs(cats - summary["busy_s"]) <= 0.01 * summary["busy_s"],
              f"(f) trace categories sum to {cats} s, busy {summary['busy_s']} s")
        emit({"phase": "tools_step_breakdown", **{k: brk[k] for k in (
            "ms", "units", "predicted_step_ms", "measured_step_ms", "slack",
            "hash_fwd_Mrows_per_s", "hash_grad_Mrows_per_s", "timing", "scale", "iters")},
            "wall_s": breakdown_s, "trace_events": summary["events"],
            "trace_busy_s": summary["busy_s"], "trace_categories_s": cats,
            "by_category_s": summary["by_category"], "scan_launches": list(launches),
            "nvidia_smi": smi})
        counted = [counted[0] + launches[0], counted[1] + launches[1]]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
        dataset.RAY_CACHE, tasks.ROUTE_CACHE = saved
        shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    emit({"phase": "tools_done", "phase13_s": time.perf_counter() - t_phase})
    return tuple(counted)

# ---------------------------------------------------------------- phase 14


def hash_kernel_entries(hk: dict, smi: str) -> list:
    """The kernels line's entries of the hash encode kernels: launches summed
    over the main paths (``HASH_BY_PATH``); times at the serving chunk in
    float32 for the forward and at a support march in bfloat16 (what
    training runs) for the cotangent, both on random points; every shape of
    both point sets under ``shapes``."""
    at = lambda P, dt: next(r for r in hk["shapes"]
                            if r["set"] == "random" and r["P"] == P and r["dtype"] == dt)
    fwd, bwd = at(HASH_P[0], "float32"), at(HASH_P[1], "bfloat16")
    common = {"route": "cuda", "source": "acn_tpu_torch/csrc/hashgrid.cu", "bound_by": "bytes",
              "library_note": "F.embedding_bag(mode='sum', per_sample_weights=w) on 8·h + c, "
                              "timed only", "timing": "card ms per call over a run of calls "
                              "between one pair of CUDA events, cycling over copies of the "
                              "inputs that exceed the L2; host µs per call apart",
              "nvidia_smi": smi}
    keys = lambda pre: ["set", "P", "dtype", f"{pre}_ms", f"{pre}_host_us", f"{pre}_plain_ms",
                        f"{pre}_bound_ms", f"{pre}_library_ms", f"{pre}_copies"]
    return [
        {"name": "hash_cell_fwd", "replaces": "acn_tpu/models/encodings.py:413 (no TPU "
         "kernel: _cell_saved_fwd_impl, plain XLA)",
         "launches": sum(c[0] for c in HASH_BY_PATH.values()),
         "launches_by_path": {k: c[0] for k, c in HASH_BY_PATH.items()},
         "at": {"set": "random", "P": fwd["P"], "dtype": fwd["dtype"]},
         "max_abs_err": fwd["fwd_max_abs_err"], "ms": fwd["fwd_ms"], "host_us": fwd["fwd_host_us"],
         "plain_ms": fwd["fwd_plain_ms"], "bound_ms": fwd["fwd_bound_ms"],
         "library_ms": fwd["fwd_library_ms"],
         "shapes": [{k: r[k] for k in keys("fwd")} for r in hk["shapes"]],
         "flag_shapes": [{k: r[k] for k in ["config", "levels", "F"] + keys("fwd")}
                         for r in hk["flag_shapes"]], **common},
        {"name": "hash_cell_bwd_tables", "replaces": "acn_tpu/models/encodings.py:444 (no TPU "
         "kernel: _saved_bwd's table half, plain XLA)",
         "launches": sum(c[1] for c in HASH_BY_PATH.values()),
         "launches_by_path": {k: c[1] for k, c in HASH_BY_PATH.items()},
         "at": {"set": "random", "P": bwd["P"], "dtype": bwd["dtype"]},
         "max_abs_err": at(HASH_P[1], "float32")["bwd_max_abs_err"],
         "ms": bwd["bwd_ms"], "host_us": bwd["bwd_host_us"], "plain_ms": bwd["bwd_plain_ms"],
         "bound_ms": bwd["bwd_bound_ms"], "library_ms": bwd["bwd_library_ms"],
         "double_backward": hk["double_backward"],
         "shapes": [{k: r[k] for k in keys("bwd")} for r in hk["shapes"]],
         "flag_shapes": [{k: r[k] for k in ["config", "levels", "F"] + keys("bwd")}
                         for r in hk["flag_shapes"]], **common},
    ]


HASH_P = (983_040, 32_768, 16_384)  # one expert of a serving chunk; a support
# and a query march of a training step (1,024 and 512 rays × 32 samples)
HASH_F32_RTOL = 2e-6  # of the output's largest magnitude (sum order)
HASH_BF16_L2_FACTOR = 1.5  # bf16 cotangent: distance from an f32 sum, × plain's
HASH_PAD_REAL = 256  # the pad-collision case's real points


def hash_kernel_times(prof, busy_ms) -> dict:
    """The hash encode kernels in a profile: launches, mean µs and their
    share of the card's busy time."""
    out = {}
    for e in prof.key_averages():
        if "hash_cell_" in e.key:
            us = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
            out[e.key[:100]] = {"launches": e.count, "mean_us": us / max(e.count, 1),
                                "share_of_busy": 1e-3 * us / max(busy_ms, 1e-9)}
    return out


def net_kernel_times(prof, busy_ms) -> dict:
    """The network kernel in a profile: launches, mean µs and share of the
    card's busy time."""
    evs = [e for e in prof.key_averages() if "ngp_net_kernel" in e.key]
    us = sum(getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
             for e in evs)
    n = sum(e.count for e in evs)
    return {"launches": n, "mean_us": us / max(n, 1),
            "share_of_busy": 1e-3 * us / max(busy_ms, 1e-9)}


def _ulps_bf16(torch, a, b):
    """|a − b| in bf16 ulps of b, elementwise."""
    a, b = a.float(), b.float()
    ulp = torch.where(b == 0, torch.full_like(b, 2.0**-133),
                      torch.exp2(torch.floor(torch.log2(b.abs())) - 7))
    return (a - b).abs() / ulp


def check_hash_kernels(torch, hg, tables, x, g, hcfg, rows, what: str) -> dict:
    """Both kernels against their plain versions on one input (phase 14's
    limits); returns the errors."""
    L = hcfg.levels
    dt = tables[0].dtype
    got = hg.hash_cell_fwd_kernel(tables, x, hcfg)
    want = hg.hash_cell_fwd_plain(tables, x, hcfg)
    got_t = hg.hash_cell_bwd_tables_kernel(x, g, hcfg, rows, [dt] * L)
    want_t = hg.hash_cell_bwd_tables_plain(x, g, hcfg, rows, [dt] * L)
    torch.cuda.synchronize()
    fwd_err = float((got.float() - want.float()).abs().max())
    if dt == torch.float32:
        top = float(want.abs().max())
        check(fwd_err <= HASH_F32_RTOL * top,
              f"hash forward {what}: max |kernel − plain| {fwd_err}, largest |out| {top}")
        mag = hg.hash_cell_bwd_tables_plain(x, g.abs(), hcfg, rows, [dt] * L)
        ratio = max(float(((a - b).abs() / (m + 1e-30)).max())
                    for a, b, m in zip(got_t, want_t, mag))
        check(ratio <= 1e-5, f"hash cotangent {what}: |kernel − plain| up to {ratio} of "
              "the terms' magnitudes, want ≤ 1e-5")
        return dict(fwd_max_abs_err=fwd_err, fwd_max_abs=top, bwd_err_of_magnitude=ratio,
                    bwd_max_abs_err=max(float((a - b).abs().max())
                                        for a, b in zip(got_t, want_t)))
    ulps = _ulps_bf16(torch, got, want)
    check(float(ulps.max()) <= 1.0, f"hash forward {what}: {float(ulps.max())} ulps from plain")
    ref = hg.hash_cell_bwd_tables_plain(x, g.float(), hcfg, rows, [torch.float32] * L)
    dk = [float((a.float() - r).norm()) for a, r in zip(got_t, ref)]
    dp = [float((b.float() - r).norm()) for b, r in zip(want_t, ref)]
    check(all(a <= HASH_BF16_L2_FACTOR * b for a, b in zip(dk, dp)),
          f"hash cotangent {what}: distance from the f32 sum per level {dk}, plain's {dp}")
    unequal = int((got != want).sum())
    return dict(fwd_max_abs_err=fwd_err, fwd_max_ulps=float(ulps.max()),
                fwd_unequal_elements=unequal, fwd_bit_equal_share=1.0 - unequal / got.numel(),
                bwd_l2_from_f32_sum=dk, plain_bwd_l2_from_f32_sum=dp,
                bwd_max_abs_from_f32_sum=max(float((a.float() - r).abs().max())
                                             for a, r in zip(got_t, ref)),
                plain_bwd_max_abs_from_f32_sum=max(float((b.float() - r).abs().max())
                                                   for b, r in zip(want_t, ref)))


def phase_hash(torch, toy) -> dict:
    """The hash encode kernels (module docstring, phase 14)."""
    from acn_tpu_torch.models import encodings as enc
    from acn_tpu_torch.ops import hashgrid_bench as hb

    hg = _hashgrid()
    hcfg = hb.hash_config()
    L, F = hcfg.levels, hcfg.features_per_level
    rows = [hcfg.level_rows(l) for l in range(L)]
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(14)
    tables32 = [(torch.rand((r, 8 * F), generator=gen, device="cuda") * 2 - 1) * 1e-3
                for r in rows]
    shapes, t_start = [], time.perf_counter()
    check(hb.RANDOM_P == HASH_P, f"hashgrid_bench's sizes {hb.RANDOM_P}, want {HASH_P}")
    for name, P, x32, g32 in hb.point_sets(hcfg, ("random", "rays"), gen):
        for dt in (torch.float32, torch.bfloat16):
            x, g = x32.to(dt), g32.to(dt)
            tables = [t.to(dt) for t in tables32]
            row = {"set": name, "P": P, "dtype": str(dt).split(".")[-1],
                   "zero_cotangent_rows": int((g32 == 0).all(dim=1).sum()),
                   **check_hash_kernels(torch, hg, tables, x, g, hcfg, rows,
                                        f"{name} P {P} {row_dtype(dt)}"),
                   **hb.time_kernels(tables, x, g, hcfg, rows)}
            shapes.append(row)
            emit({"phase": "hash_kernels", **row})
            del tables
            torch.cuda.empty_cache()

    # the hash grids of phase 16's configurations (L·F 128, 40 levels of
    # F = 3, F = 1): random points at a serving chunk in float32 and a
    # support march in bfloat16, each kernel against its plain version, timed
    flag_shapes = []
    for cname in HASH_FLAG_CONFIGS:
        fcfg = hb.hash_config(cname)
        frows = [fcfg.level_rows(l) for l in range(fcfg.levels)]
        ftabs = [(torch.rand((r, 8 * fcfg.features_per_level), generator=gen, device="cuda")
                  * 2 - 1) * 1e-3 for r in frows]
        for name, P, x32, g32 in hb.point_sets(fcfg, ("random",), gen):
            if P not in HASH_P[:2]:
                continue
            dt = torch.float32 if P == HASH_P[0] else torch.bfloat16
            x, g = x32.to(dt), g32.to(dt)
            tables = [t.to(dt) for t in ftabs]
            row = {"config": cname, "levels": fcfg.levels, "F": fcfg.features_per_level,
                   "set": name, "P": P, "dtype": row_dtype(dt),
                   **check_hash_kernels(torch, hg, tables, x, g, fcfg, frows,
                                        f"{cname} {name} P {P} {row_dtype(dt)}"),
                   **hb.time_kernels(tables, x, g, fcfg, frows)}
            flag_shapes.append(row)
            emit({"phase": "hash_kernels", **row})
            del tables, x, g, x32, g32
            torch.cuda.empty_cache()
        del ftabs
        torch.cuda.empty_cache()

    # h and the corner, exactly: Nearest picks one corner with weight 1 from
    # a table whose row r holds 8·r + c in corner c
    near = dataclasses.replace(hcfg, interpolation="Nearest")
    ramp = [(8 * torch.arange(r, device="cuda", dtype=torch.float32)[:, None, None]
             + torch.arange(8, device="cuda", dtype=torch.float32)[None, :, None])
            .expand(r, 8, F).reshape(r, 8 * F).contiguous() for r in rows]
    x = hb.random_points(hcfg, HASH_P[0], gen)
    check(torch.equal(hg.hash_cell_fwd_kernel(ramp, x, near),
                      hg.hash_cell_fwd_plain(ramp, x, near)),
          "Nearest: the kernel's row or corner differs from the plain version's")
    del ramp

    # pads: many zero-cotangent points in one cell, real points in distinct
    # level-0 cells (at most two in a row of any level: two adds commute)
    P = HASH_P[1]
    r0 = int(hcfg.level_resolutions()[0])
    cells = torch.randperm(r0**3, generator=gen, device="cuda")[:HASH_PAD_REAL]
    ijk = torch.stack([cells // (r0 * r0), (cells // r0) % r0, cells % r0], -1).float()
    real = (ijk + 0.05 + 0.9 * torch.rand((HASH_PAD_REAL, 3), generator=gen,
                                           device="cuda")) / r0
    x = torch.cat([real, real[:1].expand(P - HASH_PAD_REAL, 3)]).contiguous()
    g = torch.randn((P, L * F), generator=gen, device="cuda")
    g[HASH_PAD_REAL:] = 0.0
    pad_equal = {}
    for dt in (torch.float32, torch.bfloat16):
        most = max(int(torch.bincount(hg._cell_index(real.to(dt), hcfg, l)[0]).max())
                   for l in range(L))
        check(most <= 2, f"the pad case put {most} real points in one row ({dt})")
        got = hg.hash_cell_bwd_tables_kernel(x.to(dt), g.to(dt), hcfg, rows, [dt] * L)
        want = hg.hash_cell_bwd_tables_plain(x.to(dt), g.to(dt), hcfg, rows, [dt] * L)
        pad_equal[row_dtype(dt)] = all(torch.equal(a, b) for a, b in zip(got, want))
    check(all(pad_equal.values()), f"pad-collision case bit-equal to plain: {pad_equal}")

    # MAML's second derivative at a support march: forward kernel, cotangent
    # kernel under create_graph, forward kernel on the cotangent's cotangent
    P = HASH_P[1]
    x = hb.random_points(hcfg, P, gen)
    tabs = [t.clone().requires_grad_(True) for t in tables32]
    g = torch.randn((P, L * F), generator=gen, device="cuda", requires_grad=True)
    v = [torch.randn(t.shape, generator=gen, device="cuda") for t in tables32]
    before = hg.launch_counts()
    out = enc.hash_encode(tabs, x, hcfg)
    grads = torch.autograd.grad(out, tabs, g, create_graph=True)
    (dg,) = torch.autograd.grad(grads, g, v)
    torch.cuda.synchronize()
    launched = tuple(b - a for a, b in zip(before, hg.launch_counts()))
    check(launched == (2, 1), f"the double backward launched {launched}, want "
          "(2 forward, 1 cotangent)")
    want_t = hg.hash_cell_bwd_tables_plain(x, g.detach(), hcfg, rows, [torch.float32] * L)
    mag = hg.hash_cell_bwd_tables_plain(x, g.detach().abs(), hcfg, rows, [torch.float32] * L)
    want_dg = hg.hash_cell_fwd_plain(v, x, hcfg)
    t_ratio = max(float(((a.detach() - b).abs() / (m + 1e-30)).max())
                  for a, b, m in zip(grads, want_t, mag))
    dg_err = float((dg - want_dg).abs().max())
    check(t_ratio <= 1e-5 and dg_err <= HASH_F32_RTOL * float(want_dg.abs().max()),
          f"double backward: cotangent {t_ratio} of the magnitudes, dg max err {dg_err}")
    double = {"P": P, "launches": launched, "cotangent_err_of_magnitude": t_ratio,
              "dg_max_abs_err": dg_err}
    emit({"phase": "hash_checks", "nearest_exact": True, "pad_case_bit_equal": pad_equal,
          "pad_case": {"P": HASH_P[1], "real": HASH_PAD_REAL},
          "double_backward": double, "phase_s": time.perf_counter() - t_start})
    del tabs, grads, dg, out
    torch.cuda.empty_cache()
    return {"shapes": shapes, "flag_shapes": flag_shapes, "double_backward": double}


NET_RTOL, NET_ATOL = 1e-5, 1e-6  # kernel against plain f32: the products' sum order
# the wide expert (σ trunk 256 × 8): float32 itself drifts from float64 over
# its depth, tests/test_torch_ngp_net.py's WIDE_RTOL and its derivation
NET_WIDE_RTOL = 3e-4
HASH_FLAG_CONFIGS = ("l16f8", "l40f3", "f1")  # phase 16's hash grids other than the smoke's


# ---------------------------------------------------------------- phase 16

CONFIG_STEPS = ("l40f3", "f1")  # a budget step each: the bf16 hash kernels at F = 3 and 1
CONFIG_CPU_RAYS = 512  # card against CPU, as phase 4 (2,048 before; cut for time)


def config_vs_cpu(torch, Renderer, cfg, P, occ_cfg, model, model_cpu, occ, cam, Hf,
                  Wf) -> dict:
    """Phase 4 at ``cfg``: ``render_rays`` on the card against the CPU on
    ``CONFIG_CPU_RAYS`` of the frame's rays, at the config's alpha
    threshold and at 0 with the σ-head bias at +2 (in place, on both
    models), within phase 4's tolerances."""
    from acn_tpu_torch.pipelines.renderer import _pinhole_block_rays

    args = [torch.from_numpy(np.asarray(a, np.float32)) for a in
            (cam["c2w"], cam["intrinsics"], cam["aabb"])]
    rays = _pinhole_block_rays(Hf, Wf, *args, torch.tensor([-np.inf, np.inf]),
                               0.0, 0.0).numpy()
    rays = rays[np.random.default_rng(0).choice(len(rays), CONFIG_CPU_RAYS, replace=False)]
    occ_cpu = {k: v.cpu() for k, v in occ.items()}
    atol, rtol = 1e-4, 1e-4  # phase 4's
    out = {}
    for case, thre, bias in (("alpha_thre_cfg", occ_cfg.alpha_thre, None),
                             ("alpha_thre_0_bias_2", 0.0, 2.0)):
        if bias is not None:
            with torch.no_grad():
                model.experts["sigma_head"]["b"].fill_(bias)
                model_cpu.experts["sigma_head"]["b"].fill_(bias)
        oc = dataclasses.replace(occ_cfg, alpha_thre=thre)
        gpu = Renderer(cfg, P, oc, chunk_rays=CONFIG_CPU_RAYS).render_rays(
            model, occ, rays, with_stats=True)
        cpu = Renderer(cfg, P, oc, chunk_rays=CONFIG_CPU_RAYS, device="cpu").render_rays(
            model_cpu, occ_cpu, rays, with_stats=True)
        errs = {k: float(np.abs(g - c).max()) for k, g, c in
                zip(("rgb", "depth", "acc", "wmax", "went"), gpu, cpu)}
        check(all(np.allclose(g, c, atol=atol, rtol=rtol) for g, c in zip(gpu[:4], cpu[:4])),
              f"card vs CPU render_rays disagree at {case}: {errs}")
        out[case] = {"max_abs_err": errs, "max_acc": float(cpu[2].max())}
    check(out["alpha_thre_0_bias_2"]["max_acc"] > 0.5, "the opaque case composited nothing")
    return {"rays": CONFIG_CPU_RAYS, "atol": atol, "rtol": rtol, **out}


def phase_configs(torch, segscan, toy, Renderer) -> dict:
    """Every expert configuration (module docstring, phase 16). Returns the
    scan's (forward, reverse) launches of each path."""
    import copy

    from acn_tpu_torch.pipelines.offline_stage import train_step as ts

    net = _ngp_net()
    cfg0, P, occ_cfg = toy.train_occ_config()
    smi = nvidia_smi()
    t_phase = time.perf_counter()
    counted = {}
    for name, flags in toy.FLAG_SETS.items():
        t_cfg = time.perf_counter()
        cfg = toy.flag_config(cfg0, **flags)
        K = cfg.num_submodules
        torch.cuda.empty_cache()
        model_cpu = toy.serving_model(cfg, seed=16, device="cpu")  # the twin of phase 4's check
        model = copy.deepcopy(model_cpu).to("cuda")
        boxes, _ = toy.expert_layout(K)
        occ = toy.random_occ_states(boxes, occ_cfg, fill=0.10, seed=0, device="cuda")
        renderer = Renderer(cfg, P, occ_cfg)
        Hf, Wf = toy.FLAG_FRAMES.get(name, (H, W))
        cam = toy.overhead_camera(Hf, Wf)
        chunks = -(-Hf // (renderer.chunk_rays // Wf))
        row = {"phase": "configs", "config": name, "flags": flags, "K": K, "H": Hf, "W": Wf,
               "wide_path": net.wide(cfg.expert, "sigma_blend"),
               "hash_table_mb": 4e-6 * sum(int(p.numel()) for p in model.experts["hash_table"])}
        frames = [("dense", chunks, K,
                   lambda **kw: renderer.render_image(model, occ, H=Hf, W=Wf, **cam, **kw))]
        if name == "k25":
            rects = renderer.routed_rects(boxes, cam["c2w"], cam["intrinsics"], Hf, Wf, 32)
            frames.append(("routed", len(renderer.routed_dispatch(rects, Wf, True)), 1,
                           lambda **kw: renderer.render_image_routed(model, occ, H=Hf, W=Wf,
                                                                     **cam, **kw)))
        for kind, dispatched, per_chunk, frame in frames:
            frame(download=False)  # warm
            _zero_scan_counts(segscan)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame(download=False)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            scans, (fwd, bwd, nl, cl, _) = _scan_counts(segscan), _kernel_counts()
            split = net.split_launch_counts()
            path = f"{name}_{kind}_frame"
            note_hash(path, trains=False)
            counted[path] = scans
            check_packed(path, scans, dispatched, cl)
            check(nl == dispatched and fwd == per_chunk * nl
                  and split == (nl if row["wide_path"] else 0),
                  f"{path}: network {nl}, hash forward {fwd}, split {split} launches; want "
                  f"{dispatched}, {per_chunk} × {dispatched} and "
                  f"{dispatched if row['wide_path'] else 0}")
            # the host's waits in a third frame: the dense one downloaded (its
            # download waits once, at the end); a routed frame stitches its
            # chunks on the host, so it is counted on the card and downloaded
            # after
            dense = kind == "dense"
            out, syncs, sites = host_syncs(torch, lambda: frame(download=dense))
            check(syncs < dispatched, f"{path}: {syncs} host syncs in a frame of {dispatched} "
                  f"chunks at {sites}")
            rgb, depth, acc = out if dense else frame()
            check(rgb.shape == (Hf, Wf, 3) and np.isfinite(rgb).all()
                  and np.isfinite(depth).all() and np.isfinite(acc).all(),
                  f"{path}: the frame is not finite or has the wrong shape")
            row[f"{kind}_frame"] = {"chunks": dispatched, "ms": ms, "net_launches": nl,
                                    "split_launches": split,
                                    "hash_fwd_launches": fwd, "composite_launches": cl,
                                    "scan_launches": scans[0],
                                    "host_syncs": syncs, "host_sync_sites": sites}
        row["vs_cpu"] = config_vs_cpu(torch, Renderer, cfg, P, occ_cfg, model, model_cpu, occ,
                                      cam, Hf, Wf)
        del model_cpu
        if name in CONFIG_STEPS:
            T, S, Q = int(P.batch_size), int(P.support_rays), int(P.query_rays)
            per_step = K * T * (int(P.inner_iter) + 1)
            batch = {k: torch.from_numpy(v).cuda()
                     for k, v in toy.training_batch(K, T, S, Q, seed=0).items()}
            opt, state = toy.init_train_state(model, P)
            step = ts.make_meta_train_step(cfg, P, opt, occ_cfg)
            gen = torch.Generator(device="cuda").manual_seed(0)
            state, _ = step(state, batch, occ, gen)  # warm
            _zero_scan_counts(segscan)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch, occ, gen)
            torch.cuda.synchronize()
            step_ms = 1e3 * (time.perf_counter() - t0)
            got, counts = _train_counts(segscan), _kernel_counts()
            scans = got[:2]
            path = f"{name}_budget_step"
            note_hash(path, trains=True)
            counted[path] = scans
            m = {k: float(v.detach().float().mean()) for k, v in metrics.items()}
            check(got == budget_want(per_step) and all(np.isfinite(v) for v in m.values()),
                  f"{path}: scan and composite launches {got}, want {budget_want(per_step)}; "
                  f"metrics {m}")
            row["budget_step"] = {"ms": step_ms, "scan_launches": scans,
                                  "hash_launches": counts[:2], "net_launches": counts[2],
                                  "composite_launches": counts[3:],
                                  "use_amp": bool(P.use_amp), "loss_out": m["loss_out"]}
            del batch, opt, state, step
        row.update(config_s=time.perf_counter() - t_cfg, nvidia_smi=smi)
        emit(row)
        del model, occ, renderer
        torch.cuda.empty_cache()
    emit({"phase": "configs_done", "configs": list(toy.FLAG_SETS),
          "phase_s": time.perf_counter() - t_phase, "nvidia_smi": smi})
    return counted


def net_case(torch, net, nb, mode, set_name, P, gen, experts, ins, name, rtol) -> dict:
    """One (mode, point set, P) of config ``name``: the kernel against its
    plain version within rtol / ``NET_ATOL``, every output finite; the
    times and bounds of ``ngp_net_bench.time_case``."""
    args = nb.call_args(mode, *ins, experts)
    ecfg = nb.config(name)[1]
    got = net.ngp_net_kernel(mode, *args, ecfg)
    want = net.ngp_net_plain(mode, *args, ecfg)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    # the largest excess over atol + rtol·|plain| (≤ 0 passes)
    excess = max(float(((g - w).abs() - NET_ATOL - rtol * w.abs()).max())
                 for g, w in zip(got, want))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    check(finite and excess <= 0.0,
          f"ngp_net {name} {mode} {set_name} P {P}: max |kernel − plain| {err}, over the "
          f"tolerance by {excess}, finite {finite}")
    del got, want
    return {"max_abs_err": err, "tolerance_excess": excess, "rtol": rtol,
            **nb.time_case(mode, set_name, P, gen, experts, kernel=net.ngp_net_kernel,
                           ins=ins, name=name)}


def phase_net(torch) -> dict:
    """The network kernel (module docstring, phase 15)."""
    from acn_tpu_torch import toy
    from acn_tpu_torch.ops import ngp_net_bench as nb

    net = _ngp_net()
    _, ecfg = nb.config()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(15)
    experts = nb.net_params(ecfg, 4, seed=15)
    shapes, t_start = [], time.perf_counter()
    cases = [(s, P) for s in nb.SETS for P in nb.SIZES] + [("random", nb.ROUTED_P)]
    for set_name, P in cases:
        ins = nb.inputs(set_name, P, 4, gen)
        for mode in (nb.MODES if P != nb.ROUTED_P else ("single",)):
            row = net_case(torch, net, nb, mode, set_name, P, gen, experts, ins, "smoke",
                           NET_RTOL)
            shapes.append(row)
            emit({"phase": "net_kernel", **row})
        del ins
        torch.cuda.empty_cache()
    # phase 16's configurations: every mode on the random points of a dense
    # serving chunk against the plain network, all timed
    flag_shapes = []
    for name in toy.FLAG_SETS:
        cfg, fcfg = nb.config(name)
        fexperts = nb.net_params(fcfg, cfg.num_submodules, seed=15)
        ins = nb.inputs("random", nb.SIZES[0], cfg.num_submodules, gen, name)
        for mode in nb.MODES:
            row = net_case(torch, net, nb, mode, "random", nb.SIZES[0], gen, fexperts, ins, name,
                           NET_WIDE_RTOL if name == "wide" else NET_RTOL)
            flag_shapes.append(row)
            emit({"phase": "net_kernel", **row})
        del ins, fexperts
        torch.cuda.empty_cache()
    edges = wide_edge_cases(torch, net, nb, gen)
    split = split_case(torch, net, nb)
    emit({"phase": "net_checks", "cases": len(shapes) + len(flag_shapes) + len(edges),
          "rtol": NET_RTOL, "wide_rtol": NET_WIDE_RTOL, "atol": NET_ATOL,
          "max_abs_err": max(r["max_abs_err"] for r in shapes + flag_shapes + edges),
          "phase_s": time.perf_counter() - t_start})
    return {"shapes": shapes, "flag_shapes": flag_shapes, "wide_edges": edges, "split": split}


# the wide path's edges: point counts about a 64-point tile and a pass of
# two, an expert with no point and one with one, and a width whose
# activations spill (264: five blocks of 64)
WIDE_EDGE_P = (63, 64, 65, 129, 64 * 7 + 1)


def wide_edge_cases(torch, net, nb, gen) -> list:
    """The wide path against its plain version in every mode at
    ``WIDE_EDGE_P`` (the ``wide`` expert), with expert 2's list empty or of
    one point, and at width 264 (two rounds of columns, activations in the
    block's scratch), within ``NET_WIDE_RTOL``; one split launch a network
    launch."""
    import dataclasses

    rows = []
    cfg, ecfg = nb.config("wide")
    K = cfg.num_submodules
    experts = nb.net_params(ecfg, K, seed=19)
    cases = [(f"P{P}", ecfg, experts, nb.inputs("random", P, K, gen, "wide"))
             for P in WIDE_EDGE_P]
    h, xd, w = nb.inputs("random", 3_000, K, gen, "wide")
    for listed in (0, 1):
        w2 = w.clone()
        w2[:, 2] = 0.0
        if listed:
            w2[1_234, 2] = 0.5
        cases.append((f"expert2_lists_{listed}", ecfg, experts, (h, xd, w2)))
    wide264 = dataclasses.replace(ecfg, hidden=264, color_hidden=264, sigma_depth=2,
                                  color_depth=2)
    cases.append(("width264", wide264, nb.net_params(wide264, K, seed=19), (h, xd, w)))
    for name, ec, ex, ins in cases:
        err = 0.0
        for mode in nb.MODES:
            args = nb.call_args(mode, *ins, ex)
            before = (net.launch_counts(), net.split_launch_counts())
            got = net.ngp_net_kernel(mode, *args, ec)
            want = net.ngp_net_plain(mode, *args, ec)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            e = max(float((g - x).abs().max()) for g, x in zip(got, want))
            excess = max(float(((g - x).abs() - NET_ATOL - NET_WIDE_RTOL * x.abs()).max())
                         for g, x in zip(got, want))
            launched = (net.launch_counts() - before[0], net.split_launch_counts() - before[1])
            check(excess <= 0.0 and launched == (1, 1)
                  and all(bool(torch.isfinite(g).all()) for g in got),
                  f"ngp_net wide path {name} {mode}: max |kernel − plain| {e}, over the "
                  f"tolerance by {excess}; launches (network, split) {launched}")
            err = max(err, e)
        rows.append({"case": name, "P": int(ins[0].shape[1]), "max_abs_err": err,
                     "rtol": NET_WIDE_RTOL})
    emit({"phase": "net_wide_edges", "cases": rows})
    return rows


def split_case(torch, net, nb) -> dict:
    """The wide path's split kernel at the ``wide`` expert's 4 experts:
    bit-equal to ``wide_split_plain`` (its bits are cvt.rna.tf32's), timed
    by ``hashgrid_bench``'s clock (warm: a call splits weights it reads
    from L2 at these sizes) beside its plain version and its byte bound
    (the f32 weights read once, the split image written once)."""
    from acn_tpu_torch.ops import hashgrid_bench as hb

    cfg, ecfg = nb.config("wide")
    K = cfg.num_submodules
    experts = nb.net_params(ecfg, K, seed=15)
    row = {"config": "wide", "K": K}
    for mode in ("sigma_blend", "density"):
        got = net.wide_split_kernel(mode, experts, ecfg)
        want = net.wide_split_plain(mode, experts, ecfg)
        torch.cuda.synchronize()
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        check(same, f"ngp_net split kernel ({mode}) differs from wide_split_plain's bits")
        weights = sum(int(t.numel()) for e in experts
                      for layer in net._layers(e) for t in (layer["w"], layer["b"]))
        row[mode] = {
            "image_floats": int(got.shape[1]), "bit_equal": same, "max_abs_err": 0.0,
            "ms": hb.device_ms([lambda: net.wide_split_kernel(mode, experts, ecfg)]),
            "plain_ms": hb.device_ms([lambda: net.wide_split_plain(mode, experts, ecfg)], 3),
            "bytes": 4 * weights + 4 * got.numel(),
            "bound_ms": 1e3 * (4 * weights + 4 * got.numel()) / HBM_BYTES_PER_S}
        del got, want
    emit({"phase": "net_split", **row})
    return row


def net_split_entry(nk: dict, smi: str) -> dict:
    """The kernels line's entry of the wide path's split kernel: launches
    summed over the main paths (``SPLIT_BY_PATH``, one before each wide
    network launch); times at the ``wide`` expert's 4 experts
    (``sigma_blend``'s image, ``density``'s beside it)."""
    sp = nk["split"]
    at = sp["sigma_blend"]
    return {"name": "ngp_net_wide_split", "route": "cuda",
            "source": "acn_tpu_torch/csrc/ngp_net.cu",
            "replaces": "none: the wide path's weights split once a call into TF32 parts in "
                        "wgmma's layout (acn_tpu/models/ngp.py:112-156 has no TPU kernel)",
            "launches": sum(SPLIT_BY_PATH.values()),
            "launches_by_path": {k: v for k, v in SPLIT_BY_PATH.items() if v},
            "max_abs_err": 0.0, "bit_equal_to_plain": at["bit_equal"],
            "ms": at["ms"], "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "library_note": "no PyTorch call splits f32 into TF32 parts",
            "bound_note": "the experts' f32 weights read once and the split image written "
                          "once, over 3.35 TB/s",
            "timing": "card ms per call over a run of calls between one pair of CUDA events, "
                      "warm",
            "density": sp["density"], "nvidia_smi": smi}


def net_kernel_entry(nk: dict, smi: str) -> dict:
    """The kernels line's entry of the network kernel: launches summed over
    the main paths (``NET_BY_PATH``); times at what a dense frame's chunk
    gives it (``sigma_blend``, the ray-ordered 983,040 slots of 4 experts);
    every (mode, set, P) under ``shapes``."""
    at = next(r for r in nk["shapes"]
              if r["mode"] == "sigma_blend" and r["set"] == "rays" and r["P"] == SERVING_B)
    keys = ("mode", "set", "P", "K", "pairs", "ms", "host_us", "plain_ms", "library_ms",
            "library_tf32_ms", "bound_ms", "bound_by", "ops_bound_ms", "f32_fma_bound_ms",
            "bytes_bound_ms", "max_abs_err")
    return {"name": "ngp_net_fwd", "route": "cuda", "source": "acn_tpu_torch/csrc/ngp_net.cu",
            "replaces": "acn_tpu/models/ngp.py:112-156, acn_tpu/nerfs/render_occ.py:147, "
                        "acn_tpu/models/container.py:181,221 (no TPU kernel: plain XLA)",
            "launches": sum(NET_BY_PATH.values()), "launches_by_path": dict(NET_BY_PATH),
            "at": {k: at[k] for k in ("mode", "set", "P", "K", "pairs")},
            "max_abs_err": max(r["max_abs_err"] for r in nk["shapes"]),
            "ms": at["ms"], "host_us": at["host_us"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at["library_ms"],
            "library_tf32_ms": at["library_tf32_ms"],
            "f32_fma_bound_ms": at["f32_fma_bound_ms"],
            "library_note": "the chain of cuBLAS mm calls of the plain version alone, timed "
                            "only, in f32 (library_ms) and with TF32 allowed "
                            "(library_tf32_ms); no single PyTorch call computes the network",
            "bound_note": "bound_ms: the kernel's 3xTF32 work (3 TF32 products a "
                          "multiply-add) at 495 TFLOP/s or its bytes at 3.35 TB/s, the "
                          "larger; f32_fma_bound_ms: the same flops at 67 TFLOP/s f32",
            "timing": "card ms per call over a run of calls between one pair of CUDA events, "
                      "cycling over copies of the inputs that exceed the L2; host µs apart",
            "shapes": [{k: r[k] for k in keys} for r in nk["shapes"]],
            "flag_shapes": [{k: r[k] for k in ("config", "rtol") + keys}
                            for r in nk["flag_shapes"]],
            "wide_edges": nk["wide_edges"], "nvidia_smi": smi}


# ---------------------------------------------------------------- phase 17

COMPOSITE_CHUNKS = {"dense_chunk": (30_720, 983_040), "routed_chunk": (125_000, 4_000_000)}


def composite_cases(torch, device="cuda", chunks: bool = True) -> dict:
    """name → (σ, rgb, samples, N, bg): every hand-made layout of
    ``ops/composite_bench.py`` (seed 0), and with ``chunks`` the real dense
    and routed chunks (``composite_bench.chunk``), each checked to have its
    (N, B)."""
    from acn_tpu_torch.ops import composite_bench as cb

    out = {name: cb.tensors(c, device) for name, c in cb.cases().items()}
    if chunks:
        for name, kind in (("dense_chunk", "dense"), ("routed_chunk", "routed")):
            out[name] = cb.chunk(kind, device=device)
            got = (out[name][3], int(out[name][0].shape[0]))
            check(got == COMPOSITE_CHUNKS[name], f"{name}: (N, B) {got}, want "
                  f"{COMPOSITE_CHUNKS[name]}")
    return out


def phase_composite(torch, smi) -> dict:
    """The composite kernel (module docstring, phase 17): against its plain
    version on every case, two launches bit-equal, NaN in the dense chunk's
    pad slots never read, a NaN σ in its real slots kept; times at the two
    chunks."""
    from acn_tpu_torch import toy
    from acn_tpu_torch.ops import composite_bench as cb
    from acn_tpu_torch.ops import segscan

    comp = _composite()
    t_start = time.perf_counter()
    torch.cuda.empty_cache()
    thre_cfg = float(toy.train_occ_config()[2].alpha_thre)
    cases = composite_cases(torch)
    results, worst = {}, 0.0
    for name, (sig, rgb, smp, N, bg) in cases.items():
        res = {"N": N, "B": int(sig.shape[0]), "real": cb.n_real(smp), "max_abs_err": 0.0,
               "calls": 0}
        for thre in (0.0, 0.05):
            for with_bg in (True, False):
                for stats in (True, False):
                    if name in COMPOSITE_CHUNKS and not (with_bg and stats):
                        continue  # a chunk as serving calls it: a background and the stats
                    b = bg if with_bg else None
                    got = comp.composite_kernel(sig, rgb, smp, N, b, thre, stats)
                    again = comp.composite_kernel(sig, rgb, smp, N, b, thre, stats)
                    want = comp.composite_plain(sig, rgb, smp, N, b, thre, stats,
                                                scan=segscan.seg_excl_sum_plain)
                    torch.cuda.synchronize()
                    err = cb.max_abs_err(got, want)
                    same = all(torch.equal(x, y)
                               for x, y in zip(cb.outputs(got), cb.outputs(again)))
                    check(cb.within_tol(got, want) and same,
                          f"composite {name} alpha_thre {thre} bg {with_bg} stats {stats}: "
                          f"max |kernel − plain| {err} (rtol, atol 1e-5), two launches "
                          f"bit-equal {same}")
                    res["max_abs_err"] = max(res["max_abs_err"], err)
                    res["calls"] += 1
        worst = max(worst, res["max_abs_err"])
        results[name] = res
    # the dense chunk's pad slots (43 % of it) hold NaN: the kernel never
    # reads them, so its output keeps every bit
    sig, rgb, smp, N, bg = cases["dense_chunk"]
    real = smp["slot_real"]
    clean = comp.composite_kernel(sig, rgb, smp, N, bg, thre_cfg)
    nan = float("nan")
    dirty = {**smp, "t0_b": smp["t0_b"].masked_fill(~real, nan),
             "t1_b": smp["t1_b"].masked_fill(~real, nan)}
    got = comp.composite_kernel(sig.masked_fill(~real, nan),
                                rgb.masked_fill(~real[:, None], nan), dirty, N, bg, thre_cfg)
    torch.cuda.synchronize()
    pads_unread = all(torch.equal(x, y) for x, y in zip(cb.outputs(got), cb.outputs(clean)))
    check(pads_unread, "composite: NaN in the dense chunk's pad slots changed the output")
    del clean, dirty, got
    # a NaN σ in a real slot (a diverged field) at the middle sample of
    # every 1,000th ray that has samples: those rays' outputs are NaN, wmax
    # too, as in the plain version (run on the CPU, whose "amax" keeps a
    # NaN), and no other ray's
    starts = smp["ray_start"]
    ends = torch.cat([starts[1:], torch.full((1,), cb.n_real(smp), device=starts.device)])
    ends = torch.minimum(ends, torch.tensor(int(sig.shape[0]), device=starts.device))
    hit = torch.nonzero(ends > starts).flatten()[::1000]
    sig_nan = sig.clone()
    sig_nan[(starts[hit] + ends[hit]) // 2] = nan
    got = comp.composite_kernel(sig_nan, rgb, smp, N, bg)  # α threshold 0 keeps a NaN α
    want = comp.composite_plain(sig_nan.cpu(), rgb.cpu(), {k: v.cpu() for k, v in smp.items()},
                                N, bg.cpu())
    torch.cuda.synchronize()
    bad = torch.zeros(N, dtype=torch.bool)
    bad[hit.cpu()] = True
    nan_rays_only = all(
        torch.equal(torch.isnan(a.cpu()) if a.dim() == 1 else torch.isnan(a.cpu()).all(1), bad)
        for a in cb.outputs(got))
    nan_matches = all(torch.allclose(a.cpu(), b, equal_nan=True, **cb.TOL)
                      for a, b in zip(cb.outputs(got), cb.outputs(want)))
    check(nan_rays_only and nan_matches and len(hit) > 0,
          f"composite: a NaN σ in {len(hit)} real slots of the dense chunk: NaN in those rays "
          f"only {nan_rays_only}, equal to the plain version {nan_matches}")
    del sig_nan, got, want
    shapes = []
    for name in COMPOSITE_CHUNKS:
        sig, rgb, smp, N, bg = cases[name]
        row = {"chunk": name, "alpha_thre": thre_cfg,
               **cb.time_case(sig, rgb, smp, N, bg, alpha_thre=thre_cfg),
               "max_abs_err": results[name]["max_abs_err"]}
        shapes.append(row)
        torch.cuda.empty_cache()
    bwd = composite_backward_checks(torch, cases, thre_cfg)
    del cases
    torch.cuda.empty_cache()
    out = {"phase": "composite", "cases": results, "max_abs_err": worst,
           "tolerance": cb.TOL, "two_launches_bit_equal": True,
           "pad_slots_unread": pads_unread, "nan_density_rays": len(hit),
           "nan_density_matches_plain": nan_matches and nan_rays_only, "shapes": shapes,
           "backward": bwd,
           "phase_s": time.perf_counter() - t_start, "nvidia_smi": smi}
    emit(out)
    return out


def composite_backward_checks(torch, cases: dict, thre_cfg: float) -> dict:
    """The composite backward kernel (phase 17): against its plain version
    in float64 on every hand-made layout, alpha threshold 0 and 0.05, with
    and without a background, on rgb's cotangent alone and on all three;
    at a training episode's support and query march (σ and rgb the columns
    of one (B, 4) buffer, as the network gives them, threshold 0, as the
    loss calls it) and at the dense chunk; two launches bit-equal; NaN in
    the dense chunk's pad slots unread; the autograd Function through
    ``composite_packed`` at the support march, one launch each way and no
    scan; times beside the byte bound."""
    from acn_tpu_torch.nerfs import render as trender
    from acn_tpu_torch.ops import composite_bench as cb
    from acn_tpu_torch.ops import segscan

    comp = _composite()

    def held(what, got, again, want):
        same = all(x is None or torch.equal(x, y) for x, y in zip(got, again))
        err = cb.grad_err(got, want)
        check(cb.grads_within_tol(got, want) and same,
              f"composite backward {what}: largest |kernel − plain float64| {err} of the "
              f"largest gradient ({cb.GRAD_TOL}), two launches bit-equal {same}")
        return err

    layouts, worst = {}, 0.0
    for name, (sig, rgb, smp, N, bg) in cases.items():
        if name in COMPOSITE_CHUNKS:
            continue
        res = {"calls": 0, "grad_err": 0.0, "plain_f32_grad_err": 0.0}
        for thre in (0.0, 0.05):
            for with_bg in (True, False):
                b = bg if with_bg else None
                acc = comp.composite_kernel(sig, rgb, smp, N, b, thre, False)[2]
                for which in ("rgb", "all"):
                    g = cb.cotangents(N, seed=res["calls"], device="cuda")
                    g = (g[0], None, None) if which == "rgb" else g
                    args = (sig, rgb, smp, N, b, thre, acc, *g)
                    got = comp.composite_backward_kernel(*args)
                    again = comp.composite_backward_kernel(*args)
                    want = cb.backward_f64(*args[:7], g)
                    err = held(f"{name} alpha_thre {thre} bg {with_bg} {which}", got, again,
                               want)
                    plain = comp.composite_backward_plain(*args)
                    res["grad_err"] = max(res["grad_err"], err)
                    res["plain_f32_grad_err"] = max(res["plain_f32_grad_err"],
                                                    cb.grad_err(plain, want))
                    res["calls"] += 1
        worst = max(worst, res["grad_err"])
        layouts[name] = res
    shapes = []
    for kind in (*cb.TRAIN_CHUNKS, "dense"):
        if kind == "dense":
            sig, rgb, smp, N, bg = cases["dense_chunk"]
            thre = thre_cfg
        else:
            sig, rgb, smp, N, bg = cb.chunk(kind)
            buf = torch.cat([rgb, sig[:, None]], dim=1)  # the network's (B, 4)
            sig, rgb, thre = buf[:, 3], buf[:, :3], 0.0
        check((N, int(sig.shape[0])) == {**cb.TRAIN_CHUNKS, "dense": cb.CHUNKS["dense"]}[kind],
              f"backward {kind}: (N, B) {(N, int(sig.shape[0]))}")
        acc = comp.composite_kernel(sig, rgb, smp, N, bg, thre, False)[2]
        g = cb.cotangents(N)
        args = (sig, rgb, smp, N, bg, thre, acc, *g)
        got = comp.composite_backward_kernel(*args)
        want = cb.backward_f64(*args[:7], g)
        err = held(kind, got, comp.composite_backward_kernel(*args), want)
        row = {"shape": kind, "alpha_thre": thre, "grad_err": err,
               "plain_f32_grad_err": cb.grad_err(comp.composite_backward_plain(*args), want)}
        if kind == "dense":  # NaN in every pad slot's inputs: never read
            real = smp["slot_real"]
            nan = float("nan")
            dirty = {**smp, "t0_b": smp["t0_b"].masked_fill(~real, nan),
                     "t1_b": smp["t1_b"].masked_fill(~real, nan)}
            got_nan = comp.composite_backward_kernel(
                sig.masked_fill(~real, nan), rgb.masked_fill(~real[:, None], nan), dirty, N, bg,
                thre, acc, *g)
            row["pad_slots_unread"] = all(torch.equal(x, y) for x, y in zip(got, got_nan))
            check(row["pad_slots_unread"],
                  "composite backward: NaN in the dense chunk's pad slots changed a gradient")
            del dirty, got_nan
        if kind == "support":  # the Function, as the training loss calls it
            x = buf.detach().clone().requires_grad_()
            xb = bg.detach().clone().requires_grad_()
            _zero_scan_counts(segscan)
            out = trender.composite_packed(x[:, 3], x[:, :3], smp, N, bg_rgb=xb,
                                           with_stats=False)
            dx, db = torch.autograd.grad(sum((o * gi).sum() for o, gi in zip(out[:3], g)),
                                         (x, xb))
            torch.cuda.synchronize()
            launched = _train_counts(segscan)
            fn_err = cb.grad_err((dx[:, 3], dx[:, :3], db), want)
            check(launched == (0, 0, 1, 1)
                  and cb.grads_within_tol((dx[:, 3], dx[:, :3], db), want),
                  f"composite_packed under autograd: launches (scans, composites) {launched}, "
                  f"want (0, 0, 1, 1); gradient {fn_err} of the largest off")
            row.update(autograd_launches=launched, autograd_grad_err=fn_err)
            del x, xb, out, dx, db
        worst = max(worst, err)
        row.update(cb.time_backward_case(sig, rgb, smp, N, bg, alpha_thre=thre))
        shapes.append(row)
        del got, want, acc
        torch.cuda.empty_cache()
    return {"layouts": layouts, "grad_err": worst, "tolerance": cb.GRAD_TOL,
            "two_launches_bit_equal": True, "shapes": shapes}


def composite_kernel_entries(ck: dict, smi: str) -> list:
    """The kernels line's entries of the composite kernels: the forward's and
    the backward's."""
    return [composite_kernel_entry(ck, smi), composite_backward_entry(ck, smi)]


def composite_backward_entry(ck: dict, smi: str) -> dict:
    """The backward kernel's entry: launches summed over the main paths
    (``COMP_BWD_BY_PATH``); times at a training episode's support march,
    the query march's and the dense chunk's under ``shapes``."""
    b = ck["backward"]
    at = next(r for r in b["shapes"] if r["shape"] == "support")
    keys = ("shape", "N", "B", "n_real", "alpha_thre", "ms", "host_us", "plain_ms",
            "parent_fwd_bwd_ms", "kernels_fwd_bwd_ms", "library_ms", "bound_ms", "bound_by",
            "floor_ms", "grad_err", "plain_f32_grad_err")
    return {"name": "composite_packed_backward", "route": "cuda",
            "source": "acn_tpu_torch/csrc/composite.cu",
            "replaces": "acn_tpu/ops/segscan.py:251 (the Pallas scan's backward _bwd, the "
                        "same kernel on the reversed cotangent) plus XLA's transposed segment "
                        "sums, through acn_tpu/nerfs/render.py:143",
            "launches": sum(COMP_BWD_BY_PATH.values()),
            "launches_by_path": dict(COMP_BWD_BY_PATH),
            "max_abs_err": b["grad_err"], "ms": at["ms"], "host_us": at["host_us"],
            "plain_ms": at["plain_ms"], "parent_fwd_bwd_ms": at["parent_fwd_bwd_ms"],
            "kernels_fwd_bwd_ms": at["kernels_fwd_bwd_ms"],
            "bound_ms": at["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "floor_ms": at["floor_ms"],
            "floor_note": "a one-element add by the same clock: at a support march the byte "
                          "bound lies far below a launch's own cost",
            "library_note": "no single PyTorch call computes the composite's gradient",
            "max_abs_err_note": "the largest |kernel − plain float64| of each gradient over "
                                "its largest magnitude, over every case",
            "plain_note": "plain_ms: the backward's formulas in PyTorch (the scans' plain "
                          "versions); parent_fwd_bwd_ms: the differentiated composition the "
                          "port ran before the kernel (the scan kernel, index_add_, "
                          "autograd), forward and backward; kernels_fwd_bwd_ms: the forward "
                          "and backward kernels through autograd",
            "bound_note": "bound_ms: 24 B read and 16 written a real sample, 17 B a pad slot, "
                          "32 B a ray and 24 more with a background, over 3.35 TB/s",
            "timing": "card ms per call over a run of calls between one pair of CUDA events, "
                      "cycling over copies of the inputs that exceed the L2; host µs apart",
            "shapes": [{k: r[k] for k in keys} for r in b["shapes"]], "nvidia_smi": smi}


def composite_kernel_entry(ck: dict, smi: str) -> dict:
    """The kernels line's entry of the composite forward kernel: launches
    summed over the main paths (``COMP_BY_PATH``); times at a dense chunk,
    the routed chunk's under ``shapes``."""
    at = next(r for r in ck["shapes"] if r["chunk"] == "dense_chunk")
    keys = ("chunk", "N", "B", "n_real", "ms", "host_us", "plain_ms", "parent_ms",
            "library_ms", "bound_ms", "bound_every_slot_ms", "bound_by", "max_abs_err")
    return {"name": "composite_packed", "route": "cuda",
            "source": "acn_tpu_torch/csrc/composite.cu",
            "replaces": "acn_tpu/nerfs/render.py:143 (no TPU kernel: the Pallas scan at "
                        "acn_tpu/ops/segscan.py:180 plus XLA segment sums)",
            "launches": sum(COMP_BY_PATH.values()), "launches_by_path": dict(COMP_BY_PATH),
            "max_abs_err": ck["max_abs_err"], "ms": at["ms"], "host_us": at["host_us"],
            "plain_ms": at["plain_ms"], "parent_ms": at["parent_ms"],
            "bound_ms": at["bound_ms"], "bound_by": "bytes",
            "bound_every_slot_ms": at["bound_every_slot_ms"],
            "library_ms": at["library_ms"],
            "library_note": "a chain, not the same function: the elementwise ops, the scan "
                            "kernel and torch.segment_reduce sum and max over the ray "
                            "lengths; no single PyTorch call computes the composite",
            "plain_note": "plain_ms: the plain version all in PyTorch (the scan's plain "
                          "version); parent_ms: the composition the port ran before the "
                          "kernel (the scan kernel and index_add_)",
            "bound_note": "bound_ms: 24 B a real sample, 8 + 12 B a ray read, 28 B a ray "
                          "written, over 3.35 TB/s; bound_every_slot_ms: the same over "
                          "every slot of B",
            "timing": "card ms per call over a run of calls between one pair of CUDA events, "
                      "cycling over copies of the inputs that exceed the L2; host µs apart",
            "shapes": [{k: r[k] for k in keys} for r in ck["shapes"]], "nvidia_smi": smi}


def row_dtype(dt) -> str:
    return str(dt).split(".")[-1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default="", metavar="DIR")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    # the reference's f32 products are full f32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from acn_tpu_torch import toy
    from acn_tpu_torch.ops import cuda_lib, segscan
    from acn_tpu_torch.scripts import bench_segscan
    from acn_tpu_torch.pipelines.renderer import Renderer

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    cuda_lib.start_all()  # one nvcc per source, started together
    phase_s, build_s = {}, {}
    clock = [t0]  # phase 1 from the build's start

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = phase_s.get(name, 0.0) + now - clock[0]
        clock[0] = now

    # the kernel checks that need only the libraries built first run while
    # the network's (the longest build) compiles: phase 2 on the scan's,
    # 17 on the composite's, 14 on the hash encode's; "1_device" is the
    # time spent waiting for builds
    build_s["segscan"] = cuda_lib.finish("segscan")
    lap("1_device")
    k = phase_kernel(torch, segscan, bench_segscan)
    lap("2_kernel")
    build_s["composite"] = cuda_lib.finish("composite")
    lap("1_device")
    ck = phase_composite(torch, smi)
    lap("17_composite")
    build_s["hashgrid"] = cuda_lib.finish("hashgrid")
    lap("1_device")
    hk = phase_hash(torch, toy)
    lap("14_hash")
    build_s["ngp_net"] = cuda_lib.finish("ngp_net")
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s,
          "build_wall_s": time.perf_counter() - t0,
          "ptxas": {name: cuda_lib.build_log(source=name) for name in cuda_lib.SOURCES}})
    lap("1_device")
    model, occ, cam, (fwd_render, rev_render), dense_ms = phase_main_path(
        torch, segscan, toy, Renderer, args.profile)
    lap("3_main_path")
    occ_cpu = phase_vs_cpu(torch, toy, Renderer, model, occ, cam)
    lap("4_vs_cpu")
    cfg = toy.train_occ_config()[0]
    model_cpu = toy.serving_model(cfg, seed=0, device="cpu")
    train = phase_train_step(torch, segscan, bench_segscan, toy, model_cpu,
                             occ_cpu, args.profile)
    lap("5_train_step")
    regimes = phase_regimes(torch, segscan, toy, Renderer, model_cpu, occ_cpu,
                            args.profile)
    lap("6_regimes")
    del model_cpu
    loop = phase_training_run(torch, segscan, toy, train["syncs"])
    lap("7_loop")
    run8 = phase_runner(torch, segscan, toy)
    lap("8_runner")
    serve, baked_path = phase_serving(torch, segscan, toy, model, occ, dense_ms, run8["run"],
                                      args.profile)
    lap("9_serving")
    m9 = phase_m9(torch, segscan, toy, occ_cpu, train["mean_step_ms"])
    lap("10_m9")
    del occ_cpu
    mesh = phase_mesh(torch, segscan, toy, model, occ)
    lap("11_mesh")
    del model, occ
    live = phase_live(torch, segscan, toy, run8["run"], baked_path)
    lap("12_live")
    fwd_tools, rev_tools = phase_tools(torch, segscan, toy, args.profile)
    lap("13_tools")
    nk = phase_net(torch)
    lap("15_net")
    configs = phase_configs(torch, segscan, toy, Renderer)
    lap("16_configs")
    emit({"phase": "timing", "phase_s": phase_s, "total_s": sum(phase_s.values()),
          "nvidia_smi": smi})

    # launches: the counters as read after the main paths' runs (6 frames;
    # the sum over the 4 training steps; the sum over phase 6's steps and
    # frames, where only the budget step after the switch launches; the sum
    # over phase 7's two loop runs, where the budget steps launch; phase 8's
    # --op train and --op eval; phase 9's routed, single-expert and baked
    # frames, baked eval and videos; phase 10's steps, summed by
    # sub-phase; phase 11's sharded steps and fan-out frames, summed over the
    # ranks; phase 12's viewer frames, live frames, TTO steps and meta-train
    # runner steps; phase 13's --op train and step breakdown), each counted
    # from 0 just before its path was driven; since the composite kernel
    # (phase 17) every serving path launches it once a packed chunk and the
    # scan's forward not at all. ms,
    # plain_ms and bound_ms at the serving chunk (B = 983,040);
    # "train_shapes" holds the same at the training step's B = 32,768 and
    # 16,384, "double_backward" phase 2's second derivative at 32,768.
    fwd_train, rev_train = train["launches"]
    fwd_reg, rev_reg = regimes["fwd"], regimes["rev"]
    fwd_loop, rev_loop = loop["fwd"], loop["rev"]
    (fwd_rtrain, rev_rtrain), (fwd_reval, rev_reval) = run8["train"], run8["eval"]
    by_path = lambda i: {**{name: c[i] for name, c in serve.items()},
                         **{f"m9_{name}": c[i] for name, c in m9.items()},
                         **{name: c[i] for name, c in mesh.items()},
                         **{f"viewer_{name}": c[i] for name, c in live.items()},
                         **{name: c[i] for name, c in configs.items()}}
    common = {"route": "cuda", "source": "acn_tpu_torch/csrc/segscan.cu",
              "bound_ms": k["bound_ms"], "bound_by": "bytes", "library_ms": None,
              "library_note": "no single PyTorch call computes a segmented scan"}
    emit({"kernels": [
        {"name": "seg_excl_sum", "replaces": "acn_tpu/ops/segscan.py:180",
         "launches": (fwd_render + fwd_train + fwd_reg + fwd_loop + fwd_rtrain + fwd_reval
                      + sum(c[0] for c in serve.values())
                      + sum(c[0] for c in m9.values()) + sum(c[0] for c in mesh.values())
                      + sum(c[0] for c in live.values()) + fwd_tools
                      + sum(c[0] for c in configs.values())),
         "launches_by_path": {"render_image": fwd_render, "train_step": fwd_train,
                              "regime_schedule": fwd_reg, "meta_trainer": fwd_loop,
                              "runner_train": fwd_rtrain, "runner_eval": fwd_reval,
                              **by_path(0), "host_tools": fwd_tools},
         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "reverse_ms": k["reverse_ms"], "plain_ms": k["plain_ms"],
         "double_backward": {key: k["double_backward"][key] for key in (
             "B", "launches_fwd_rev", "ms", "plain_ms", "bound_ms", "max_abs_err")},
         "train_shapes": [{key: sh[key] for key in (
             "B", "ms", "plain_ms", "bound_ms", "max_abs_err")}
             for sh in train["shapes"]], **common},
        {"name": "seg_excl_rsum", "replaces": "acn_tpu/ops/segscan.py:251",
         "launches": (rev_render + rev_train + rev_reg + rev_loop + rev_rtrain + rev_reval
                      + sum(c[1] for c in serve.values())
                      + sum(c[1] for c in m9.values()) + sum(c[1] for c in mesh.values())
                      + sum(c[1] for c in live.values()) + rev_tools
                      + sum(c[1] for c in configs.values())),
         "launches_by_path": {"render_image": rev_render, "train_step": rev_train,
                              "regime_schedule": rev_reg, "meta_trainer": rev_loop,
                              "runner_train": rev_rtrain, "runner_eval": rev_reval,
                              **by_path(1), "host_tools": rev_tools},
         "max_abs_err": k["reverse_max_abs_err"], "ms": k["reverse_ms"],
         "plain_ms": k["reverse_plain_ms"],
         "train_shapes": [{"B": sh["B"], "ms": sh["reverse_ms"],
                           "plain_ms": sh["reverse_plain_ms"],
                           "bound_ms": sh["bound_ms"],
                           "max_abs_err": sh["reverse_max_abs_err"]}
                          for sh in train["shapes"]], **common},
        *hash_kernel_entries(hk, smi),
        net_kernel_entry(nk, smi),
        net_split_entry(nk, smi),
        *composite_kernel_entries(ck, smi),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
