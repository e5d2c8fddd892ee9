#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: kernels, parity, the predict, train, CLI and op paths.

    python3 chip_smoke.py [--out FILE]

Phases, each of which raises on a failed check (the script then exits
non-zero and prints no result):

1. Device: the card's name and power limit (``nvidia-smi``), then the
   kernels are built from ``pointnet2_tpu_torch/csrc`` with ``nvcc`` for
   ``sm_90a``, one ``nvcc`` per source, all at once.
2. Kernels: at every shape the two driven paths give them at
   ``semantic.json`` width (B=8, one ``infer_chunk`` of the eval forward, and
   B=16, the train step's batch), each kernel runs beside its plain PyTorch
   version on the same seeded input. FPS, ball query and
   kNN must be equal; three_interpolate within rtol=1e-6, atol=1e-6. Both are
   timed with CUDA events (2 warm-ups, then the median of 10 runs of 5 calls
   in a row), with the bound of the work beside them: the larger of the
   bytes it must move over 3.35 TB/s and its operations over 67 TFLOP/s
   (float32 without tensor cores), the H100 SXM's published peaks at 700 W.
   ``library_ms`` is one PyTorch call computing the same function, where
   there is one (``embedding_bag`` for three_interpolate); the port never
   calls it. ``three_interpolate_grad``, the backward kernel of the train
   step, runs at the four shapes a batch gives it (B=16, the train step's,
   and B=8), on real 3-NN indices and weights and on seeded cotangents laid
   out as the train step hands them over: the first C channels of the skip
   concat's wider cotangent, read in place through its strides
   (``contiguous_g_ms`` is the same call on a contiguous copy). It sums each
   element in its plain version's order (slot j, then the queries
   ascending), so it must equal the plain version bit for bit: run on the
   CPU, where ``index_add_`` sums serially, and on the card under PyTorch's
   deterministic algorithms, which keep that order for rows of more than 32
   floats (all four shapes); and it must give the same bits on a second run
   and on the contiguous copy. Its library call is the
   backward of ``embedding_bag`` with respect to the rows, which sums in its
   own order: held to the plain version within rtol=1e-5, atol=1e-5 (a row
   sums 12 to 24 addends of magnitude below 1 on average). The
   differentiable ``ops.three_interpolate`` as a whole (both kernels) equals
   the plain Function bit for bit, and autograd through the plain forward
   (which sums query by query) within the same tolerance. Rows 4 and 5's
   bfloat16 instances (the bf16 modes: ``three_interpolate_bf16``,
   ``three_interpolate_grad_bf16``) run at the same shapes on bfloat16
   features, under both precisions, with a bfloat16 skip and with a float32
   one (a selective stage's float32 concat), the backward on bfloat16 and on
   float32 cotangents into bfloat16 ``dpoints``: each equal to its plain
   version bit for bit (the same float32 arithmetic and one rounding). The
   rows, at the modes' own setting, carry their bfloat16 byte bound and the
   float32 kernel's ``f32_ms``, ``f32_device_ms`` and ``f32_bound_ms`` on the
   same values widened. Then the MSG model's new shapes at both batches,
   with the same checks: row 2 at each MSG level's first scale (half the
   radius, nsample 16), rows 4 and 5 (float32 and bfloat16) at FP2 and FP3,
   whose skips are SA2's and SA1's two scales concatenated (192 and 96
   channels; the backward reading 448- and 352-wide cotangents), and rows
   7-9 (phase 5's checks) at SA1's first scale: row 9 on rows of 16 floats.
2b. Probes: the 14 kernels of the TPU design probes: the
   FPS and kNN ones (``ops.cuda.probes``: ``fps_remask`` and ``fps_packed`` in
   ``csrc/fps_probes.cu``, ``knn_argmin`` and ``knn_tracked`` in
   ``csrc/knn_probes.cu``), each equal bit for bit to its plain version (the
   probe tool's), the FPS ones also to row 6's
   indices and, on two clouds, the oracle's, at the probes' own shapes (FPS
   64 x 8192 -> 1024, remask True and False, G = 2, 4, 8; kNN 64 clouds,
   8192 queries, 1024 references, k = 3) and at edge shapes: npoint = N =
   1000 with B = 12 (padding warps, the C = 1 route, a cluster of G = 8 with
   four empty groups), N = 8191 (no multiple of C; G = 8 has no route
   there), npoint = 1 and 2, integer coordinates (ties), kNN k = 1, 16 and
   32 at SA1's grouping (B = 16, 1024 queries, 8192 references). Bounds:
   row 6's (10 operations a point and step; at the probe shape the device
   ms of each kernel, of row 6, of ``pn2_fps_barrier_chain`` at each
   kernel's route and of the probes' own exchange alone,
   ``pn2_fps_probe_chain``) and row 3's (9
   operations a pair, ``pn2_knn`` at the same shape beside it). Then the
   four ball-query probe kernels (``ops.cuda.bq_probes``, all in
   ``csrc/bq_probes.cu``), each equal bit for bit to its plain version, at
   the probes' own shapes (B = 8, N = 8192, M = 1024, nsample 32, r = 0.1)
   at an edge shape (integer-grid coordinates, ties; an odd N, whose clouds
   the blocks stage by their own loads; nsample 40, past a warp's lanes)
   and at ``PROBE_BQ_RING`` (B = 2, N = 20000: the cloud through the ring
   of chunks): ``bq_keys`` with int32 and int16 keys and ``bq_fat`` at tm =
   128 and 256 (each row's ``plan``: warps, kq and v, or blocks a tile,
   chunk columns and route), also equal to row 2 and, on the first two
   clouds, to ``ops.reference.ball_query_np``; the pre-cut kernel at the
   cond probe's 3072-column windows (``bq_precut_cond``: they fit, so it
   equals row 2 and the oracle), behind its device-read guard there (equal)
   and at 1024 columns (they do not fit: zeros), and at the decomposition
   probe's 2048-column windows (``bq_precut_decomp``: most tiles do not fit;
   equal to row 7 reading the same windows in place). Bounds: row 2's (9
   operations a scanned pair) and row 7's (9 a pair of each query's x-span
   in its window), with row 2, row 7 in place, the cut and the sorts timed
   beside. Then the four gather probe kernels (``ops.cuda.gather_probes``,
   all in ``csrc/gather_probes.cu``), each equal bit for bit to its plain
   version, to ``group_points`` (the port's grouping gather, which is their
   ``library_ms``) and to row 9 (``window_gather``), at the probes' own
   shapes: ``gather_rows`` at 64 clouds of 8192 x 64 floats, 32768 rows a
   cloud; ``gather_rows_staged`` and ``gather_window_staged`` (unroll 4, 8,
   16; row 9 at window starts kblk * W) in the ``sp_gather_probe`` regimes
   (eval32, eval, train); ``gather_fused_idx`` at 8 x 8192 x 32, its emitted
   indices equal to its input; and at edge shapes: 5 clouds (no multiple of
   8), 3 channels (no 16-byte vectors), and a window kernel whose last tile's
   second block is clamped; then both window kernels (one routine, each
   tile's span staged by bulk copies over several blocks) at their span edges
   (``PROBE_SPAN_EDGES``: clamped tiles read past W, C = 3, 64 and 1024, K
   = 16 and 64, spans of one row, an unaligned array, 12 and 160 tiles,
   shapes at which the plan's parts do not divide the span and its ring of
   chunks wraps), each at its plan, equal to its plain version,
   ``group_points`` and row 9 at the rows named; their rows give the plan,
   the shared and the staged bytes. Bounds: bytes (the output written, each distinct
   source row read, the indices read once; and written once more by the
   fused kernel). Then the two kernels of the 4-D window grouping probe
   (``wingather_out4d_probe``): ``bq_precut_pos`` (``csrc/bq_probes.cu``,
   the pre-cut kernel with window columns) equal bit for bit to its plain
   version and to row 8 reading the same windows in place (idx, pos, cnt),
   and ``gather_window_out4d`` (``csrc/gather_probes.cu``) equal bit for bit
   to its plain version and to row 9 at the same rows (``lo + pos``), at the
   probe's shape (8 clouds of 8192 points in 8 x 8 x 4.9 m boxes, 1024 FPS
   centroids, K = 32, C = 32, r = 0.5, W = 3072, wblk 4096) and at edges:
   queries apart from the cloud (empty balls and balls short of K), a last
   tile whose second block is clamped, K = 16 and 64, C = 3 (no 16-byte
   vectors) and 64. Bounds: row 8's (9 operations a pair of each query's
   x-span; its idx, pos and cnt written) and row 9's (bytes of the rows
   picked). Then the ``probes`` path: the eleven tools' ``main`` on the
   card at their own shapes (``python -m pointnet2_tpu_torch.tools.fps_mask_probe``,
   ``.fps_packed_probe``, ``.knn_variant_probe``, ``.bq_i16_probe``,
   ``.bq_fat_probe``, ``.bq_cond_probe``, ``.bq_sliced_decomp_probe``,
   ``.gather_probe``, ``.sp_gather_probe``, ``.fused_gather_probe``,
   ``.wingather_out4d_probe``), whose launches must include all 14 probe
   kernels.
3. Predict: a ``Predictor`` at full ``semantic.json`` width with seeded
   weights (``convert.init_variables``) answers 3 requests of 16 clouds of
   8192 points (after one warm-up request). The launch counts, reset just before,
   must show each kernel 4 times a chunk. The labels must match the same
   Predictor run with the plain versions (``impl="torch"``) on the card.
4. Train: a ``Trainer`` at full ``semantic.json`` width (Adam, seeded
   weights, dropout on) takes one warm-up step and then 5 steps on seeded
   batches of 16 clouds with labels in 0..8 and weights of which a fifth are
   zero. Every loss must be finite, the moving statistics must have moved,
   and the launch counts, reset after the warm-up, must show each of the five
   kernels exactly 4 times a step. From the same weights and the same batch,
   with dropout off, one step of the kernel path is held against one step of
   the plain path (``ops_impl="torch"``) on the card, both under PyTorch's
   deterministic algorithms: a second kernel-path step must give the same
   gradients bit for bit, and against the plain path the loss within 1e-5
   relative, every parameter gradient within 1e-3 of that gradient's max abs
   (the forward and the backward's scatters sum in the same order on both
   paths; cuBLAS's products need not, at the paths' own shapes; the worst
   error is recorded, and whether the paths were equal bit for bit in this
   run). Then an ``accum_steps=4`` Trainer with hoisted geometry takes 2
   steps: FPS, ball query and 3-NN 4 times a step, the two interpolate
   kernels 16 times.
5. Calibrated windows (``bq_window=3072``, ``fp_window=512``, the production
   widths; they engage at SA1 and FP4): the four windowed kernels (the
   windowed ball query, the same with window columns, the window gather, the
   windowed kNN) equal their plain versions on the sorted inputs the
   calibrated ops make, at the B=8 chunk and the B=16 batch, on the route
   their plan picks (the windowed ball query's ``(split, warps)`` is in its
   record; the windowed kNN's blocks, one a tile, and device time in its),
   timed beside their bounds (9 operations a pair the data
   needs: for the ball query the columns of each query's x-span,
   ``ops.core.ball_query_tile_spans``, for the kNN those of each query's
   span at its k-th distance, ``ops.core.knn_tile_spans``; the gather's bytes,
   each distinct source row its picks name read once, with ``index_select``
   of the same rows as its library call and its planned ``(vec, lanes)``
   route and device time in its record, then one line for each forced
   route, 16-byte vectors or floats, and one for a source 4 bytes off
   16-byte alignment, which must plan the float route; each bit for bit
   against the plain version and ``index_select``) and beside the whole
   calibrated op and the exact op it stands in for (``op_ms``,
   ``exact_op_ms``). The whole ops equal on the kernel and the plain path,
   ``ok`` included, with a window that fits and one too small (256 at SA1
   must give ``ok`` False). Then a windowed ``Predictor`` answers the 3
   requests through ``predict_step_checked`` (every ``ok`` True; per chunk
   the fused grouping's two kernels and the windowed kNN once, ball query and
   3-NN 3 times, FPS and three_interpolate 4 times; labels equal to the
   no-window path's on >= 99.99 % of points, logits within 1e-4; a
   ``bq_window=256`` request gives ``ok`` False), and a windowed ``Trainer``
   takes 1 + 3 Adam steps (``window_ok`` every step; per step the windowed
   ball query and kNN once, the exact ones 3 times), with the no-window
   Trainer timed in turns on the same batches; one dropout-free windowed step
   against the no-window step under deterministic algorithms (loss within
   1e-5 relative, gradients within 1e-3 of their max abs; the worst error and
   bit equality recorded); and the windows ``auto`` would pick
   (``calibrate_model_windows``) on the smoke clouds.
5b. bf16 modes (``Predictor(dtype="bfloat16")``, ``Trainer(train_dtype=
   "bfloat16", bf16_min_width=128)``): the predict phase's requests through
   four Predictors, uniform and selective (``bf16_min_width=128``), exact and
   with the windows, each held against its plain path in the same mode (labels
   >= 99.99 %, logits within 1e-3; the windows' certificates True; rows 4's
   bfloat16 instance 4 times a chunk, the float32 one never), with ms a request
   on the host's clock and on the device's (the profiler's kernel time of one
   request, by category) beside the float32 Predictor's, and each mode's
   labels' agreement with the float32 path; then the mixed-precision Trainer:
   1 + 5 Adam steps on the train phase's batches (finite losses, float32
   master weights and gradients, rows 4 and 5's bfloat16 instances 4 times a
   step), two dropout-free kernel-path steps equal and held to the plain
   path's with the train phase's gates, ms a step and peak memory beside the
   train phase's.
5c. MSG (``arch="msg"``, ``convert.init_variables(arch="msg",
   bn_stats="random")``, full ``semantic.json`` width): phases 3, 4 and 5's
   predict and train paths again, with the same gates and requests or
   steps, launch counts each: FPS 4 a chunk or step (one a level, shared by
   its scales), row 2 6 (4 with the windows, rows 7 or 8 and 9 twice), rows
   3 and 4 4, row 5 4 a step; then the selective bf16 Predictor and one
   mixed-precision train step with phase 5b's gates. The predict lines of
   both arches carry the device ms of a request and SA1's share of one
   chunk's forward (CUDA events, ``sa1_share``); the train lines the device
   ms of a step.
5d. SA tails (``sa_tails``): the last modules of the port. (a) The
   reference's plain SA layout, ``PointNet2SemSeg(pre_project=False)``, on
   the seeded weights carried into it through the reference's TF names
   (``flax_to_tf_vars``, ``tf_vars_to_flax(pre_project=False)``): one eval
   chunk of 8 clouds (rows 1-4 as ``chunk_launches``) held to its plain path
   and to the pre-projected model on the same weights (labels >= 99.99 %,
   logits within 1e-3); a windowed chunk (3072 / 512: the calibrated ball
   query at SA1, the windowed 3-NN at FP4) whose eight certificates hold and
   whose logits are the exact chunk's within 1e-4; a dropout-free train step
   at B=16 held to its plain path with the train phase's gates; 3 timed
   steps (rows 1-5 as ``step_launches``), then ms a 16-cloud request and a
   step beside the pre-projected model's, in turns. (b) kNN grouping
   (``SetAbstraction(use_knn=True)``) at SA1-SA4's shapes, B=16, k = 32, the
   list route of row 3: centroids and indices equal to the plain path's bit
   for bit, features within 1e-4 of their max abs, row 3 timed at each shape
   beside its bound; then a train step of the model with every level so
   grouped (FPS 4, row 3 8, rows 4 and 5 4 each, no ball query) held to its
   plain path. (c) The other SA options at SA1's shape in both layouts (the
   pooling modes avg, weighted_avg, max_and_avg; mlp2; use_xyz=False;
   use_bn=False) and group_all at SA4's input (64 points), each against its
   plain path within 1e-4 of the output's max abs. (d) The calibration tool
   ``tools.bq_window_calibrate.main`` on the ``cli`` phase's fabricated
   scenes (one batch of 8 clouds: FPS 4 times): its windows and spans those
   of its plain version on the same batches. (e) ``cli.colorize`` and
   ``write_html_viewer`` on this host: the ``_colored.pcd`` byte for byte the
   plain path's (``write_pcd`` of ``colorize_point_cloud``), the page the
   same twice and holding the cloud and its colours.
6. Op surface: the index-only FPS (``farthest_point_sample``) at the four SA
   shapes of both batches, equal to its plain version and to the fused
   kernel's indices; the round-1 windowed ball query (``ops.ball_query(
   impl="windowed")``, default window ``max(2 * nsample, N // 4)``) at
   SA1-SA3 of both batches, on a clustered cloud whose band's tiles fall back,
   on 2 clouds of 65536 points (a 16384-column window, past shared memory)
   and with nsample = 64: the kernel equal to its plain version on the op's
   sorted inputs, the whole op equal to the plain windowed op and to the
   exact kernel, run under ``torch.cuda.set_sync_debug_mode("error")`` (no
   host read decides the fallback), the tiles that fit counted on the host
   from the plan, its ``(split, warps)``, blocks and device time recorded,
   its bound 9 operations a pair of each query's x-span over its tile's
   range (the window, or the whole sorted cloud for a tile that falls back);
   both kernels timed beside their bounds, their plain
   versions timed with 3 single calls (the plain FPS takes some 200 ms a
   call). Then ``tools.parity`` on the card (48 checks of every kernel
   against the NumPy oracles; zero failures), and the op-level path: one run
   of ``tools.stage_bench``'s composites (the SA sample-and-group through
   ``ops.farthest_point_sample`` with either ball query, the gather, the FP
   interpolation), which must launch its five kernels.
7. CLI: the entry points a user runs. Fabricated Semantic3D scenes (a
   ``.pcd`` and ``.labels`` for every train and validation prefix,
   ``tools.scenes.fabricate``) in a temporary directory; a copy of
   ``semantic.json`` with only ``data_path``, ``logdir`` and ``max_epoch = 1``
   changed; then ``cli.train.main`` with ``--seed 0``, once exact and once
   with ``--bq_window 3072 --fp_window 512`` (``python -m
   pointnet2_tpu_torch.tools.scenes`` prints the widest windows those
   batches need): sampler thread, pinned prefetch
   through a side stream, 4 Adam steps and the eval of the 2 validation
   batches, each run's launch counts those its steps and eval chunks imply
   (rows 1-5; rows 7-10 in the windowed run), and every checkpoint it wrote
   restored into a fresh Trainer, all with the same weights. Then
   ``cli.predict.main`` on the exact run's ``model.pt`` (``--set validation
   --num_samples 16 --batch_size 8``): 4 launches of each forward kernel a
   batch, every ``.pcd`` equal bit for bit to the samples a fresh
   ``SemanticDataset(seed=0)`` draws, and the ``.labels`` equal to a plain
   ``Predictor(impl="torch")``'s on those samples on >= 99.99 % of points.
   Then the bf16 modes through the same entry points: one ``cli.train``
   epoch with ``--train_dtype bfloat16 --bf16_min_width 128`` (its steps
   launch rows 4 and 5's bfloat16 instances, its eval chunks the float32 one;
   every checkpoint restored, float32), and ``cli.predict --dtype bfloat16``
   on its ``model.pt``, held to a plain bf16 Predictor the same way; and the
   MSG model: one ``cli.train --arch msg`` epoch and ``cli.predict --arch
   msg`` on its ``model.pt``, held to a plain MSG Predictor. Its
   line gives each train run's host ms a step and ms waited on the prefetch
   (medians over the steps after the first), beside the train phase's median
   (``Trainer.train_step`` fed by hand) and the host ms one train batch takes
   to sample with no other thread running, and predict's samples/s.
7b. Prep: the front of the program. Raw scenes (``tools.scenes.
   fabricate_raw``: ``.txt`` rows ``x y z intensity r g b`` at the CLI
   phase's size, with ``.labels`` of which a fiftieth are 0 for the train
   and validation prefixes, none for the test prefixes) through
   ``cli.preprocess.main`` and ``cli.downsample.main`` (0.05 m voxels); a
   second run of each must skip every scene, every labelled scene lose at
   least its label-0 points and get a ``.labels`` of one label a voxel, a
   test scene a ``.pcd`` only. Then one ``cli.train`` epoch from the
   downsampled scenes and ``cli.predict`` on its ``model.pt``, held as in
   phase 7 (launch counts, ``.pcd`` bit for bit, ``.labels`` >= 99.99 % of
   the plain path's). Then the chain's last steps on the test split:
   ``cli.predict --set test`` (launch counts as phase 7's),
   ``cli.interpolate --set test`` onto the raw clouds and ``cli.renamer``:
   every test scene's dense labels under its submission name
   (``marketsquarefeldkirch4.labels`` ...), one label a raw point. Then one
   raw scan of 2 000 000 points
   (``tools.scenes.dense_scene``) added beside the finished scenes (linked
   in, so skipped): its host seconds and Mpoints/s through each entry point.
7c. Convert: a seeded SSG tree (``convert.init_variables``, random moving
   statistics) written as a reference TF ``.npz`` (``convert.
   flax_to_tf_vars``, 134 variables), converted by
   ``tools.convert_checkpoint.main`` on the card (its shape check one eval
   chunk: rows 1-4 as ``chunk_launches``); the ``.pt`` must hold
   ``from_flax_variables`` of the tree bit for bit, at step 0 with an empty
   optimizer state. ``cli.predict --ckpt`` on it, held as in phase 7, and
   one ``cli.train --resume`` epoch from it, which must resume at step 0.
8. Densify: ``cli.interpolate`` on fabricated validation scenes
   (``tools.scenes.fabricate_dense``), the first a Semantic3D-like scan of
   2 000 000 points with 250 000 labelled sparse points drawn from it, the
   other five of 20 000 and 2 500: ``--engine device`` on the card (row 3
   once a scene, then the vote on the device) and ``--engine native`` on the
   host. The device engine equals its plain version (``ops.core.knn`` in
   query chunks) bit for bit on a fixed subset of 65 536 points of the first
   scene, and the native engine on >= 99.99 % of all points (float64 against
   float32 distances: only near-ties of the 3rd and 4th neighbour may
   differ; each mismatch's two distances are printed, up to 10). Row 3 is
   held and timed at the subset's shape; the whole scene's kernel time and
   the device engine's beside its bound, and both engines' seconds and
   Mpoints/s from the CLI runs.
8b. Dist, the multi-process and sharded paths (``pointnet2_tpu_torch.parallel``);
   each process a subprocess started by ``parallel.launch.run_ranks`` within
   ``DIST_TIMEOUT_S`` (a rank that fails or hangs fails the phase):
   (a) ``tools.dist_step`` on 2 processes of this card (gloo), 8 rows each of
   a seeded 16 x 8192 x 6 batch, dropout on, one Adam step, against the
   one-process step on the 16 rows in this process: on the kernels in
   float32 on 3 batches (loss within 1e-5 relative, moving statistics within
   atol + rtol 1e-5, the gradients' relative L2 within 5e-2, each process's
   launches ``step_launches()``, both processes' states equal bit for bit),
   once more with each process's BatchNorm on its own rows, a control that
   the gradient gate must refuse, and on the plain versions in float64
   (loss 1e-6, every gradient within 1e-6 of its max abs, statistics a
   tenth of the float32 limit); (b) a group of one over
   NCCL, under deterministic algorithms, bit for bit the plain ``Trainer``
   step taken after it in the same process; (c) ``cli.train`` on 2 processes
   (``--dist_sampling replicated --seed 0``) on the ``cli`` phase's scenes,
   against the one-process run: one ``log_train.txt`` and one set of
   checkpoints (process 0's), ``[proc 1]`` lines, each process's launches
   its steps' and eval chunks', every step's loss within 1e-4 relative at a
   learning rate of 1e-5, and the same pair at semantic.json's rate
   measured; (d) ``cli.predict --sharded`` (every visible card) against the
   one-process predict CLI, every ``.labels`` file equal byte for byte; and
   ``cli.predict`` on 2 processes, process r walking the scenes ``r::2`` on
   its own fresh stream as the JAX script's processes do, against a
   one-process run of rank r's scenes (``multihost``'s process index and
   count stood in, no group): each ``.pcd`` bit for bit, the ``.labels`` on
   >= 99.99 % of points, the gathered confusion matrix the sum of the rank
   runs', process 0 alone printing it, process 1's first scene not the
   one-process run's, and the samples a second over each run's scene loop,
   sampling included, beside the one-process run's in this (warm) process
   and in a fresh process of its own (its files this process's run's byte
   for byte); (e) ``parallel.knn_sharded`` over
   ``[cuda:0]`` and ``[cuda:0, cuda:0]`` on the densify phase's first scene,
   bit for bit ``ops.knn`` with row 3 once a shard, and ``cli.interpolate
   --engine sharded`` on the densify phase's scenes, the ``--engine
   device`` run's files byte for byte, row 3 once a shard and chunk.
9. KITTI: ``cli.kitti_predict --save`` on a fabricated drive of 3 sweeps of
   120 000 points (``tools.scenes.write_drive``; the 60 x 20 m crop keeps
   tens of thousands a frame) with a ``.pt`` of random weights at
   ``semantic_no_color.json`` widths, exact and with ``--bq_window auto
   --fp_window auto``: each frame's sample labelled by the Predictor and
   densified on the card, the launch counts those of one chunk and one
   densify a frame (and the calibration's FPS), the dense labels equal to
   the plain path's (a plain Predictor on the sample the CLI drew, then the
   plain densify) on >= 99.99 % of points; the per-stage timers of every
   frame. Row 3 is held and timed at the first frame's densify shape.

10. Export: the entry point ``tools.export_model.main`` with its default
   device (CUDA) on a checkpoint (``save_checkpoint``) of seeded weights at
   ``semantic.json`` width: SSG float32 at a fixed batch of 16 (the chunked
   forward), SSG float32 at a symbolic batch, SSG with the windows (3072 /
   512) at 16, and MSG in selective bf16 (``bf16_min_width=128``) at a
   symbolic batch; the first again with ``--output logits``. One fresh ``python -c`` process loads
   the four artifacts with ``export.load_exported`` (no module of
   ``pointnet2_tpu_torch.models`` or ``.nn`` may be imported there) and runs
   them on 16 clouds, the symbolic ones also on 1 and 3. In this process
   each artifact runs the same clouds: its labels equal the subprocess's and
   a ``Predictor``'s of the same weights and mode on >= 99.99 % of points
   (the windowed one's certificate True), the logits artifact within 1e-3 of
   the Predictor's logits, and the launch counts, reset before each, are
   ``chunk_launches`` times the forwards run. Export seconds, artifact MB,
   load seconds and ms a 16-cloud call beside the Predictor's; and the host
   µs of a call of ``ops.fps_centroids`` through its ``pn2`` operator beside
   the raw wrapper's at SA4's shape (B=8, 64 points, 16 centroids).
11. Serve: the entry point's ``cli.serve.build_server`` on the fixed-16 SSG
   artifact on a loopback port (port 0, the daemon's default device, the
   artifact's): 24 client threads send 4 ``.npy`` requests each, of 1 to
   4 clouds, then one JSON request; every answer's labels are the
   Predictor's on >= 99.99 % of points, ``/stats`` shows batched clouds and
   the device batches the launch counts imply (two chunks a call). Then on
   the windowed artifact one request of a cloud with half its points in a
   2 cm band of x (its certificate fails) and one box cloud, coalesced into
   one round: 503 for the first, 200 with the Predictor's labels for the
   second. Requests, clouds/s, p50/p95 latency and the mean device batch.
12. Soak: the last entry points. (a) ``cli.benchmark`` on ``semantic.json``,
   exact and with ``--bq_window 3072 --fp_window 512``: the certificates
   hold on its B = 64 batch, its Chrome trace and ``gpu-profile.txt`` are
   written and the table names rows 1-4's ``pn2_*`` kernels (and rows 8-10's
   with the windows), every batch time of the sweep is finite and positive,
   and the labels of its B = 1, 2 and 4 forwards (run whole: the chunk of 8
   does not divide them) equal a plain ``Predictor``'s on the same clouds on
   >= 99.99 % of points, the kernel path's logits within 1e-3 of the plain
   path's; rows 1-4 at B = 1, 2 and 4 x 8192 are held as in phase 2 (their
   plain versions timed with 3 single calls). (c) ``tools.train_soak
   --epochs 6 --accum_steps 4 --bq_window auto --fp_window auto
   --train_dtype bfloat16 --bf16_min_width 128``: 126 steps and two
   evaluations; every loss finite, epoch 5's train loss <= 1.0, the step-126
   evaluation's accuracy >= 0.90, ``model.pt`` restored (the CLI aborts
   when a certificate fails). (d) ``tools.bf16_train_soak --steps 60
   --eval_batches 4 --min_width 128``: three modes, every loss, accuracy
   and mIoU finite; its CONVERGENCE lines printed, not gated. The soaks
   together must launch rows 1-5 in both precisions, and rows 7-9 where
   (c)'s ball-query window engaged, row 10 where its FP window did. (b) On
   a batch of (c)'s scenes, rows 1-5 (float32 and bfloat16) at the soak's
   shapes, a micro-batch of 4 and the batch of 16 clouds of 2048 points (SA
   512/128/32/8), and rows 7-9 at (c)'s ball-query window, row 10 at its FP
   window where that engaged: each as phases 2 and 5 hold it.

Output: one JSON line a kernel and shape, one for each driven path (probes,
predict, train, predict_windows, train_windows, predict_bf16, train_bf16, their MSG
counterparts predict_msg, train_msg, predict_windows_msg,
train_windows_msg, predict_msg_bf16, train_msg_bf16, sa_tails, then cli, prep,
convert, op_surface, densify, dist, kitti, export, serve, soak; the
parity sweep's lines and the stage bench's lines inside op_surface), the
``nvidia-smi`` line, one ``{"kernels": [...]}`` line, and last ``{"ok":
true, "device": {...}}``. Each path's launch counts are reset just before it
and read just after (the CLI phase's runs, the prep and convert phases'
and the KITTI phase's two each apart; the dist phase's processes count their own and report them);
the ``kernels`` line sums them.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import copy
import dataclasses
import importlib
import io
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from pointnet2_tpu_torch import convert, native, ops, predict_profile
from pointnet2_tpu_torch.cli import benchmark as cli_benchmark
from pointnet2_tpu_torch.cli import cli_mesh
from pointnet2_tpu_torch.cli import colorize as cli_colorize
from pointnet2_tpu_torch.cli import downsample as cli_downsample
from pointnet2_tpu_torch.cli import interpolate as cli_interpolate
from pointnet2_tpu_torch.cli import kitti_predict as cli_kitti
from pointnet2_tpu_torch.cli import predict as cli_predict
from pointnet2_tpu_torch.cli import preprocess as cli_preprocess
from pointnet2_tpu_torch.cli import renamer as cli_renamer
from pointnet2_tpu_torch.cli import serve as cli_serve
from pointnet2_tpu_torch.cli import train as cli_train
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.data.io import load_labels, read_pcd, write_labels, write_pcd
from pointnet2_tpu_torch.data.semantic3d import (
    SemanticDataset,
    all_file_prefixes,
    test_file_prefixes,
    train_file_prefixes,
    validation_file_prefixes,
)
from pointnet2_tpu_torch.export import load_exported
from pointnet2_tpu_torch.infer import Predictor, full_float32
from pointnet2_tpu_torch.models.pointnet2_seg import SA_MLPS, msg_scales
from pointnet2_tpu_torch.nn.pointnet import SetAbstraction
from pointnet2_tpu_torch.ops.calibrate import calibrate_model_windows
from pointnet2_tpu_torch.ops import core, cuda, densify, reference
from pointnet2_tpu_torch.ops.cuda import ballquery as cuda_ballquery
from pointnet2_tpu_torch.ops.cuda import bq_probes as cuda_bq_probes
from pointnet2_tpu_torch.ops.cuda import build
from pointnet2_tpu_torch.ops.cuda import fps as cuda_fps
from pointnet2_tpu_torch.ops.cuda import gather_probes as cuda_gather_probes
from pointnet2_tpu_torch.ops.cuda import interpolate as cuda_interp
from pointnet2_tpu_torch.ops.cuda import probes as cuda_probes
from pointnet2_tpu_torch.ops.cuda import wingather as cuda_gather
from pointnet2_tpu_torch.parallel import knn_sharded, multihost
from pointnet2_tpu_torch.parallel.launch import run_ranks
from pointnet2_tpu_torch.tools import bq_window_calibrate as calibrate_cli
from pointnet2_tpu_torch.tools import convert_checkpoint as convert_cli
from pointnet2_tpu_torch.tools import export_model as export_cli
from pointnet2_tpu_torch.tools import bf16_train_soak, dist_step, op_bench, parity, scenes, stage_bench, train_soak
from pointnet2_tpu_torch.tools import bq_cond_probe, bq_fat_probe, bq_i16_probe, bq_sliced_decomp_probe
from pointnet2_tpu_torch.tools import fused_gather_probe, gather_probe, sp_gather_probe, wingather_out4d_probe
from pointnet2_tpu_torch.tools import fps_mask_probe, fps_packed_probe, knn_variant_probe
from pointnet2_tpu_torch.train import Trainer, load_model_state, restore_checkpoint, save_checkpoint
from pointnet2_tpu_torch.train_profile import train_batch
from pointnet2_tpu_torch.utils.bench import bound, card_line, cuda_ms, deterministic_algorithms, device_ms
from pointnet2_tpu_torch.utils.colors import colorize_point_cloud
from pointnet2_tpu_torch.utils.html_viewer import write_html_viewer

# The package's ``knn`` is the wrapper function; the module is reached by name.
cuda_knn = importlib.import_module("pointnet2_tpu_torch.ops.cuda.knn")

ROOT = pathlib.Path(__file__).resolve().parent
CHUNK = 8  # Trainer.infer_chunk / Predictor default: the batch a kernel sees
REQUESTS = 3
BATCH = 16  # semantic.json's batch_size
SEED = 0
DEVICE = "cuda"  # every phase runs here; there is no other choice from the command line
FP_CHANNELS = (512, 256, 256, 128)  # features interpolated by FP1..FP4
FP_SKIP_CHANNELS = (256, 128, 64, 3)  # the skip features each is concatenated with (SA3, SA2, SA1, colour)
# The MSG model's: SA2's and SA1's two scales concatenated (64 + 128, 32 + 64);
# FP2 and FP3 are the levels whose shapes differ from SSG's.
MSG_FP_SKIP_CHANNELS = (256, 192, 96, 3)
MSG_FP = (1, 2)
TRAIN_STEPS = 5
ACCUM = 4
ACCUM_STEPS = 2
# three_interpolate_grad's plain version against sums in another order: the
# library call's, and autograd's through the plain forward (query by query).
ORDER_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_GRAD_TOL = 1e-3  # kernel-path against plain-path parameter gradients, of each one's max abs

KERNELS = {
    "fps_centroids": ("pointnet2_tpu_torch/csrc/fps.cu", "pointnet2_tpu/ops/pallas/fps.py:89"),
    "ball_query": ("pointnet2_tpu_torch/csrc/ballquery.cu", "pointnet2_tpu/ops/pallas/ballquery.py:42"),
    "knn": ("pointnet2_tpu_torch/csrc/knn.cu", "pointnet2_tpu/ops/pallas/knn.py:39"),
    "three_interpolate": (
        "pointnet2_tpu_torch/csrc/interpolate.cu", "pointnet2_tpu/ops/pallas/interpolate.py:48",
    ),
    "three_interpolate_grad": (
        "pointnet2_tpu_torch/csrc/interpolate.cu", "pointnet2_tpu/ops/pallas/interpolate.py:112",
    ),
    # Rows 4 and 5's bfloat16 instances (the bf16 precision modes), counted apart.
    "three_interpolate_bf16": (
        "pointnet2_tpu_torch/csrc/interpolate.cu", "pointnet2_tpu/ops/pallas/interpolate.py:48",
    ),
    "three_interpolate_grad_bf16": (
        "pointnet2_tpu_torch/csrc/interpolate.cu", "pointnet2_tpu/ops/pallas/interpolate.py:112",
    ),
    "ball_query_sliced": ("pointnet2_tpu_torch/csrc/ballquery.cu", "pointnet2_tpu/ops/pallas/ballquery.py:247"),
    "ball_query_sliced_pos": ("pointnet2_tpu_torch/csrc/wingather.cu", "pointnet2_tpu/ops/pallas/wingather.py:54"),
    "window_gather": ("pointnet2_tpu_torch/csrc/wingather.cu", "pointnet2_tpu/ops/pallas/wingather.py:98"),
    "knn_sliced": ("pointnet2_tpu_torch/csrc/knn.cu", "pointnet2_tpu/ops/pallas/knn.py:133"),
    "farthest_point_sample": ("pointnet2_tpu_torch/csrc/fps.cu", "pointnet2_tpu/ops/pallas/fps.py:40"),
    "ball_query_windowed": (
        "pointnet2_tpu_torch/csrc/window_bq.cuh", "pointnet2_tpu/ops/pallas/ballquery.py:80",
    ),
    # The TPU design probes' kernels, by the probe's pallas_call site (the probes path).
    "fps_remask": ("pointnet2_tpu_torch/csrc/fps_probes.cu", "tools/fps_mask_probe.py:79"),
    "fps_packed": ("pointnet2_tpu_torch/csrc/fps_probes.cu", "tools/fps_packed_probe.py:112"),
    "knn_argmin": ("pointnet2_tpu_torch/csrc/knn_probes.cu", "tools/knn_variant_probe.py:76"),
    "knn_tracked": ("pointnet2_tpu_torch/csrc/knn_probes.cu", "tools/knn_variant_probe.py:153"),
    "bq_keys": ("pointnet2_tpu_torch/csrc/bq_probes.cu", "tools/bq_i16_probe.py:88"),
    "bq_fat": ("pointnet2_tpu_torch/csrc/bq_probes.cu", "tools/bq_fat_probe.py:110"),
    # One kernel (pn2_ball_query_precut) at the two probe sites that launch it.
    "bq_precut_cond": ("pointnet2_tpu_torch/csrc/bq_probes.cu", "tools/bq_cond_probe.py:62"),
    "bq_precut_decomp": ("pointnet2_tpu_torch/csrc/bq_probes.cu", "tools/bq_sliced_decomp_probe.py:69"),
    "gather_rows": ("pointnet2_tpu_torch/csrc/gather_probes.cu", "tools/gather_probe.py:40"),
    "gather_rows_staged": ("pointnet2_tpu_torch/csrc/gather_probes.cu", "tools/sp_gather_probe.py:75"),
    "gather_window_staged": ("pointnet2_tpu_torch/csrc/gather_probes.cu", "tools/sp_gather_probe.py:137"),
    "gather_fused_idx": ("pointnet2_tpu_torch/csrc/gather_probes.cu", "tools/fused_gather_probe.py:46"),
    "bq_precut_pos": ("pointnet2_tpu_torch/csrc/bq_probes.cu", "tools/wingather_out4d_probe.py:125"),
    "gather_window_out4d": ("pointnet2_tpu_torch/csrc/gather_probes.cu", "tools/wingather_out4d_probe.py:186"),
}
INTERPOLATE_KERNELS = ("three_interpolate", "three_interpolate_grad")
# The production windows (bench.py's Trainer(bq_window=3072) and its fp_window=512
# opt-in): at semantic.json's widths they engage at SA1 (8192 points) and FP4
# (1024 coarse points) and fall back to the exact kernels at the other levels.
BQ_WINDOW = 3072
FP_WINDOW = 512
SMALL_BQ_WINDOW = 256  # too small for SA1: ok must be False
SMALL_FP_WINDOW = 128
WINDOW_TRAIN_STEPS = 3
WINDOW_LOGIT_TOL = 1e-4
# The plain versions of the op-surface rows run a few times only: the plain FPS
# takes some 200 ms a call at SA1.
FEW = dict(reps=3, inner=1, warmup=1)
# Past a block's shared memory: N // 4 = 16384 columns > the 14528 that fit.
WIDE_N, WIDE_M, WIDE_B = 65536, 1024, 2
CLI_SAMPLES, CLI_PREDICT_BATCH = 16, 8
# The densify phase: the first validation scene at the size of a Semantic3D
# scan's crop, with a sparse cloud of predict's samples' size; the other five smaller.
DENSE_POINTS, SPARSE_POINTS = 2_000_000, 250_000
SMALL_DENSE, SMALL_SPARSE = 20_000, 2_500
PREP_POINTS = DENSE_POINTS  # the prep phase's raw scan, at the densify phase's scene size
DENSIFY_SUBSET = 65_536  # dense points held bit for bit against the plain version
NATIVE_AGREEMENT = 0.9999
# The KITTI phase: a drive of HDL-64E-sized sweeps.
KITTI_FRAMES, KITTI_SWEEP_POINTS = 3, 120_000
# The bf16 modes at semantic.json's widths: every FP stage computes in
# bfloat16 (uniform, and selective at 128, whose narrowest FP width is 128),
# so each interpolation and its backward take the bfloat16 instances.
BF16_MIN_WIDTH = 128
BF16_CLI_TRAIN = ("--train_dtype", "bfloat16", "--bf16_min_width", str(BF16_MIN_WIDTH))
# The bf16 predict modes: (name, Predictor keywords).
BF16_MODES = (
    ("uniform", dict(dtype="bfloat16")),
    ("selective", dict(dtype="bfloat16", bf16_min_width=BF16_MIN_WIDTH)),
    ("uniform_windows", dict(dtype="bfloat16", bq_window=BQ_WINDOW, fp_window=FP_WINDOW)),
    ("selective_windows", dict(dtype="bfloat16", bf16_min_width=BF16_MIN_WIDTH, bq_window=BQ_WINDOW,
                               fp_window=FP_WINDOW)),
)
# The MSG model's bf16 modes: the selective predict mode, and one mixed-precision train step.
MSG_BF16_MODES = (BF16_MODES[1],)
MSG_BF16_STEPS = 1
# The export phase's artifacts: (name, Trainer keywords, batch; None is symbolic).
# ``EXPORT_FLAGS`` names each keyword's ``tools.export_model`` flag.
EXPORTS = (
    ("ssg_f32_b16", {}, BATCH),
    ("ssg_f32_symbolic", {}, None),
    ("ssg_windows_b16", dict(bq_window=BQ_WINDOW, fp_window=FP_WINDOW), BATCH),
    ("msg_selective_bf16_symbolic", dict(arch="msg", infer_dtype="bfloat16", bf16_min_width=BF16_MIN_WIDTH), None),
)
EXPORT_FLAGS = {"arch": "--arch", "infer_dtype": "--dtype", "bf16_min_width": "--bf16_min_width",
                "bq_window": "--bq_window", "fp_window": "--fp_window"}
SYMBOLIC_BATCHES = (BATCH, 1, 3)  # what a symbolic artifact answers
DISPATCH_CALLS = 500  # below the card's queue of pending launches: the host's time, not the device's
# The serve phase: client threads x requests each, of 1..4 clouds.
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_MAX_CLOUDS = 24, 4, 4
SERVE_DELAY_MS = 5.0  # the daemon's default coalescing window
SPLIT_DELAY_MS = 500.0  # long enough that the two requests of the certificate split share a round


def chunk_launches(arch: str = "ssg", windows: bool = False, bf16: bool = False) -> dict:
    """The kernels' launches an eval chunk of CHUNK clouds at semantic.json's
    widths. FPS runs once a level (MSG's scales share it); an MSG level
    queries each of its two scales. With the windows SA1 (8192 points) and
    FP4 (1024 coarse points) engage: the fused grouping's two kernels once a
    scale of SA1, the windowed kNN once; the other levels take the exact
    kernels. In the bf16 modes every FP stage interpolates in bfloat16."""
    scales = 2 if arch == "msg" else 1
    out = {"fps_centroids": 4, "three_interpolate_bf16" if bf16 else "three_interpolate": 4}
    if windows:
        return {**out, "ball_query_sliced_pos": scales, "window_gather": scales, "ball_query": scales + 2,
                "knn_sliced": 1, "knn": 3}
    return {**out, "ball_query": 2 * scales + 2, "knn": 4}


def step_launches(arch: str = "ssg", windows: bool = False, bf16: bool = False) -> dict:
    """The kernels' launches a train step: ``chunk_launches``' geometry, the
    windowed ball query in place of the fused grouping (train mode), and the
    interpolation's forward and backward at each FP level."""
    scales = 2 if arch == "msg" else 1
    suffix = "_bf16" if bf16 else ""
    out = {"fps_centroids": 4, f"three_interpolate{suffix}": 4, f"three_interpolate_grad{suffix}": 4}
    if windows:
        return {**out, "ball_query_sliced": scales, "ball_query": scales + 2, "knn_sliced": 1, "knn": 3}
    return {**out, "ball_query": 2 * scales + 2, "knn": 4}


def scaled(launches: dict, n: int) -> dict:
    """Each count of ``launches`` times ``n``."""
    return {name: n * count for name, count in launches.items()}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def clouds(batch: int, cfg: Config, seed: int) -> np.ndarray:
    """bench.py's clouds: xyz uniform in 8 x 8 x 4.9 m, colours in [0, 1)."""
    rng = np.random.RandomState(seed)
    x = np.zeros((batch, cfg.num_point, cfg.point_dim), np.float32)
    x[..., :3] = rng.rand(batch, cfg.num_point, 3) * [8.0, 8.0, 4.9]
    x[..., 3:] = rng.rand(batch, cfg.num_point, cfg.point_dim - 3)
    return x


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


class Report:
    """Per (kernel, shape) records, and their sums over the four levels."""

    def __init__(self, card: str):
        self.card = card
        self.rows: list[dict] = []
        # ``cuda_ms`` arguments for every plain version a row does not time
        # otherwise (None: ``cuda_ms``'s defaults).
        self.plain_timing: Optional[dict] = None

    def add(self, kernel, batch, shape, run, plain, nbytes, nops, err, match, library=None, extra=None,
            info=None, plain_timing=None):
        """``extra``: further calls to time beside the kernel, by the key each gets in the row;
        ``info``: further fields of the row; ``plain_timing``: ``cuda_ms`` arguments for the plain version."""
        if not match:
            raise AssertionError(f"{kernel} at {shape} disagrees with its plain version (max abs err {err})")
        bound_ms, bound_by = bound(nbytes, nops)
        before = cuda.LAUNCHES[kernel]
        kernel_ms = cuda_ms(run)
        row = {
            "kernel": kernel,
            "batch": batch,
            "shape": f"B={batch} {shape}",
            "kernel_ms": kernel_ms,
            "launches": cuda.LAUNCHES[kernel] - before,  # the timed calls really ran the kernel
            "plain_ms": cuda_ms(plain, **(plain_timing or self.plain_timing or {})),
            "library_ms": None if library is None else cuda_ms(library),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "bytes": nbytes,
            "ops": nops,
            "max_abs_err": err,
            "match": match,
            "card": self.card,
            **{key: cuda_ms(fn) for key, fn in (extra or {}).items()},
            **(info or {}),
        }
        self.rows.append(row)
        emit(row)

    def kernels_line(self, paths: dict) -> dict:
        """``launches`` is the sum over the driven paths (``paths``: path name ->
        launch counts, each path's counts reset just before it and read just
        after), each also given apart. The times are sums over every shape the
        kernel was held at; ``ms_by_batch`` and the others give the batches apart."""
        out = []
        for name, (source, replaces) in KERNELS.items():
            rows = [r for r in self.rows if r["kernel"] == name]
            libs = [r["library_ms"] for r in rows]
            worst = max(rows, key=lambda r: r["bound_ms"])
            out.append({
                "name": name,
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": sum(launches.get(name, 0) for launches in paths.values()),
                "launches_by_path": {path: launches.get(name, 0) for path, launches in paths.items()},
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": sum(r["kernel_ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                "bound_ms": sum(r["bound_ms"] for r in rows),
                "bound_by": worst["bound_by"],
                "library_ms": None if None in libs else sum(libs),
                **{
                    f"{key}_by_batch": {
                        str(b): sum(r[column] for r in rows if r["batch"] == b)
                        for b in sorted({r["batch"] for r in rows})
                    }
                    for key, column in (("ms", "kernel_ms"), ("plain_ms", "plain_ms"), ("bound_ms", "bound_ms"))
                },
            })
        return {"kernels": out}


def kernel_phase(cfg: Config, seed: int, report: Report, b: int, x: Optional[np.ndarray] = None) -> list:
    """Every forward kernel at every shape a batch of ``b`` clouds gives it
    (``x``, or the smoke clouds of ``seed``), against its plain version.
    Returns the five levels' coordinates."""
    dev = torch.device(DEVICE)
    x = torch.from_numpy(clouds(b, cfg, seed) if x is None else x).to(dev)
    levels = [x[..., :3].contiguous()]
    for spec in cfg.sa_layers:
        src = levels[-1]
        n = src.shape[1]
        idx, cent = ops.fps_centroids(src, spec.npoint, impl="cuda")
        p_idx, p_cent = ops.fps_centroids(src, spec.npoint, impl="torch")
        report.add(
            "fps_centroids", b, f"N={n} npoint={spec.npoint}",
            lambda: ops.fps_centroids(src, spec.npoint, impl="cuda"),
            lambda: ops.fps_centroids(src, spec.npoint, impl="torch"),
            nbytes=b * n * 12 + b * spec.npoint * 16,
            nops=10 * b * (spec.npoint - 1) * n,
            err=max_abs(cent, p_cent),
            match=torch.equal(idx, p_idx) and torch.equal(cent, p_cent),
            info={"plan": cuda_fps.planned_route(src, spec.npoint)},
        )
        ball_query_row(report, src, cent, spec.radius, spec.nsample)
        levels.append(cent)

    gen = torch.Generator(device=dev).manual_seed(seed)
    for i, (c, c1) in enumerate(zip(FP_CHANNELS, FP_SKIP_CHANNELS)):
        lvl = 3 - i
        dense, coarse = levels[lvl], levels[lvl + 1]
        nq, m = dense.shape[1], coarse.shape[1]
        d2, nn_idx = ops.three_nn(dense, coarse, impl="cuda")
        p_d2, p_idx = ops.three_nn(dense, coarse, impl="torch")
        route = cuda_knn.plan(b, nq, m, 3, cuda_ballquery.num_sms(dense.device.index))
        report.add(
            "knn", b, f"Nq={nq} M={m} k=3",
            lambda: ops.three_nn(dense, coarse, impl="cuda"),
            lambda: ops.three_nn(dense, coarse, impl="torch"),
            *op_bench.work_knn(b, nq, m, 3),
            err=max_abs(d2, p_d2),
            match=torch.equal(nn_idx, p_idx) and torch.equal(d2, p_d2),
            info={"plan": route, "device_ms": device_ms(lambda: ops.three_nn(dense, coarse, impl="cuda"), "knn")},
        )
        # The FP concat as the model writes it: FP4's skip is the input cloud's
        # colours (a view of row stride 6), the others the SA level's features.
        skip = x[..., 3:6] if c1 == 3 else torch.randn((b, nq, c1), generator=gen, device=dev)
        interpolate_row(report, nn_idx, ops.interpolation_weights(d2), m, c, skip, gen)
    return levels


def ball_query_row(report: Report, src: torch.Tensor, cent: torch.Tensor, r: float, ns: int) -> None:
    """Row 2 at one level's shape against its plain version, its bound the
    pairs this data needs (up to each query's nsample-th hit, or all N)."""
    b, n = src.shape[:2]
    m = cent.shape[1]
    bq, cnt = ops.ball_query(src, cent, r, ns, impl="cuda")
    p_bq, p_cnt = ops.ball_query(src, cent, r, ns, impl="torch")
    scanned = torch.where(cnt == ns, bq[..., -1].long() + 1, n).sum().item()
    report.add(
        "ball_query", b, f"N={n} M={m} r={r} nsample={ns}",
        lambda: ops.ball_query(src, cent, r, ns, impl="cuda"),
        lambda: ops.ball_query(src, cent, r, ns, impl="torch"),
        nbytes=b * n * 12 + b * m * 12 + b * m * (ns + 1) * 4,
        nops=9 * scanned,
        err=0.0,
        match=torch.equal(bq, p_bq) and torch.equal(cnt, p_cnt),
        info={"plan": cuda_ballquery.plan(b, n, m, cuda_ballquery.num_sms(src.device.index))},
    )


def interpolate_row(report: Report, nn_idx: torch.Tensor, weight: torch.Tensor, m: int, c: int, skip: torch.Tensor,
                    gen: torch.Generator) -> None:
    """Row 4 with the FP skip written into its rows, on seeded features of C
    channels, against its plain version, beside the bare kernel, the
    ``torch.cat`` it replaced and ``embedding_bag`` (its library call)."""
    dev = nn_idx.device
    b, nq = nn_idx.shape[:2]
    c1 = skip.shape[2]
    points = torch.randn((b, m, c), generator=gen, device=dev)
    out = ops.three_interpolate(points, nn_idx, weight, impl="cuda", skip=skip)
    ref = ops.three_interpolate(points, nn_idx, weight, impl="torch", skip=skip)
    bare = ops.three_interpolate(points, nn_idx, weight, impl="cuda")
    flat_idx = (nn_idx.long() + torch.arange(b, device=dev)[:, None, None] * m).reshape(-1, 3)
    flat_points, flat_w = points.reshape(b * m, c), weight.reshape(-1, 3)
    vec, skip_vec = cuda_interp.planned_route(points, skip)
    report.add(
        "three_interpolate", b, f"M={m} C={c} N={nq} skip={c1}",
        lambda: ops.three_interpolate(points, nn_idx, weight, impl="cuda", skip=skip),
        lambda: ops.three_interpolate(points, nn_idx, weight, impl="torch", skip=skip),
        # points, idx/weight and the skip read once, the concatenated rows written once
        nbytes=b * m * c * 4 + b * nq * 3 * 8 + b * nq * c1 * 4 + b * nq * (c + c1) * 4,
        nops=5 * b * nq * c,
        err=max(max_abs(out, ref), max_abs(bare, ref[..., :c])),
        match=torch.allclose(out, ref, rtol=1e-6, atol=1e-6) and torch.equal(out[..., c:], ref[..., c:])
        and torch.allclose(bare, ref[..., :c], rtol=1e-6, atol=1e-6),
        library=lambda: torch.cat([F.embedding_bag(
            flat_idx, flat_points, mode="sum", per_sample_weights=flat_w
        ).view(b, nq, c), skip], -1),
        extra={
            # The path before the fused kernel: the kernel without the skip, then torch.cat.
            "no_skip_ms": lambda: ops.three_interpolate(points, nn_idx, weight, impl="cuda"),
            "concat_ms": lambda: torch.cat([bare, skip], -1),
        },
        info={"plan": {"vec": vec, "skip_vec": skip_vec},
              "device_ms": device_ms(
                  lambda: ops.three_interpolate(points, nn_idx, weight, impl="cuda", skip=skip), "three_interpolate")},
    )


def msg_kernel_phase(cfg: Config, levels: list, seed: int, report: Report) -> None:
    """The MSG model's new shapes of rows 2, 4 and 5 at the levels' batch (the
    levels ``kernel_phase`` made): the ball query of each MSG level's first
    scale (half the radius, nsample 16), and the interpolation with its skip
    and its backward, float32 and bfloat16, at FP2 and FP3, whose skips are
    SA2's and SA1's concatenated scales."""
    dev = torch.device(DEVICE)
    for i in (0, 1):
        r, ns = msg_scales(cfg.sa_layers[i])[0]
        ball_query_row(report, levels[i], levels[i + 1], r, ns)
    gen = torch.Generator(device=dev).manual_seed(seed + 50)
    for i in MSG_FP:
        dense, coarse = levels[3 - i], levels[4 - i]
        d2, nn_idx = ops.three_nn(dense, coarse, impl="cuda")
        skip = torch.randn((*dense.shape[:2], MSG_FP_SKIP_CHANNELS[i]), generator=gen, device=dev)
        interpolate_row(report, nn_idx, ops.interpolation_weights(d2), coarse.shape[1], FP_CHANNELS[i], skip, gen)
    grad_kernel_phase(levels, seed, report, MSG_FP_SKIP_CHANNELS, MSG_FP)
    bf16_kernel_phase(levels, seed, report, MSG_FP_SKIP_CHANNELS, MSG_FP)


def grad_kernel_phase(levels: list, seed: int, report: Report, skips=FP_SKIP_CHANNELS, fp=range(4)) -> None:
    """three_interpolate_grad at the shapes a train step of the levels'
    batch gives it at the FP levels ``fp`` (indices into FP1..FP4) with the
    skip widths ``skips``, on the levels ``kernel_phase`` made (whose 3-NN
    it held against the plain version), and the whole Function."""
    dev = torch.device(DEVICE)
    b = levels[0].shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed + 100)
    for i in fp:
        c, skip = FP_CHANNELS[i], skips[i]
        lvl = 3 - i
        dense, coarse = levels[lvl], levels[lvl + 1]
        n, m = dense.shape[1], coarse.shape[1]
        d2, idx = ops.three_nn(dense, coarse, impl="cuda")
        weight = ops.interpolation_weights(d2)
        # The cotangent as the train step's backward hands it over: the first c
        # channels of the cotangent of cat([interpolated, skip features]).
        g = torch.randn((b, n, c + skip), generator=gen, device=dev)[..., :c]
        if g.is_contiguous():
            raise AssertionError("the cotangent slice should not be contiguous")
        g_copy = g.contiguous()
        out = ops.three_interpolate_grad(g, idx, weight, m, impl="cuda")
        for again in (ops.three_interpolate_grad(g, idx, weight, m, impl="cuda"),
                      ops.three_interpolate_grad(g_copy, idx, weight, m, impl="cuda")):
            if not torch.equal(out, again):
                raise AssertionError(f"three_interpolate_grad at N={n}: a second run or the contiguous cotangent "
                                     f"gave other bits (max abs {max_abs(out, again)})")
        # The plain version in its fixed order: on the CPU (serial sums), and on
        # the card under deterministic algorithms (the same order for these
        # rows of more than 32 floats), which the train-step comparison uses.
        ref = ops.three_interpolate_grad(g.cpu(), idx.cpu(), weight.cpu(), m, impl="torch").to(dev)
        with deterministic_algorithms():
            if not torch.equal(ops.three_interpolate_grad(g, idx, weight, m, impl="torch"), ref):
                raise AssertionError(f"three_interpolate_grad's plain version at N={n}: the card's "
                                     "deterministic sums and the CPU's differ")
        torch.cuda.synchronize()
        if out.shape != (b, m, c) or not torch.isfinite(out).all():
            raise AssertionError(f"three_interpolate_grad: bad output {tuple(out.shape)}")

        # The library call: embedding_bag's own backward with respect to the rows.
        flat_idx = (idx.long() + torch.arange(b, device=dev)[:, None, None] * m).reshape(-1, 3)
        flat_points = torch.zeros((b * m, c), device=dev, requires_grad=True)
        bag = F.embedding_bag(flat_idx, flat_points, mode="sum", per_sample_weights=weight.reshape(-1, 3))
        flat_g = g.reshape(-1, c)
        lib = torch.autograd.grad(bag, flat_points, flat_g, retain_graph=True)[0].view(b, m, c)
        if not torch.allclose(lib, ref, **ORDER_TOL):
            raise AssertionError("embedding_bag's backward disagrees with the plain three_interpolate_grad")
        report.add(
            "three_interpolate_grad", b, f"N={n} C={c} M={m} g_row_stride={c + skip}",
            lambda: ops.three_interpolate_grad(g, idx, weight, m, impl="cuda"),
            lambda: ops.three_interpolate_grad(g, idx, weight, m, impl="torch"),
            # g and idx/weight read once, dpoints written once: the op's least traffic.
            nbytes=b * n * c * 4 + b * n * 3 * 8 + b * m * c * 4,
            nops=6 * b * n * c,
            err=max_abs(out, ref),
            match=torch.equal(out, ref),
            library=lambda: torch.autograd.grad(bag, flat_points, flat_g, retain_graph=True),
            extra={"contiguous_g_ms": lambda: ops.three_interpolate_grad(g_copy, idx, weight, m, impl="cuda")},
        )

        # Both kernels behind autograd, on a cotangent that is a slice of a wider
        # tensor, against the plain Function and autograd through the plain forward.
        points = torch.randn((b, m, c), generator=gen, device=dev, requires_grad=True)
        w = weight.clone().requires_grad_()
        got = torch.autograd.grad(ops.three_interpolate(points, idx, w, impl="cuda"), (points, w), g)
        with deterministic_algorithms():
            plain = torch.autograd.grad(ops.three_interpolate(points, idx, w, impl="torch"), (points, w), g)
        want = torch.autograd.grad(core.three_interpolate(points, idx, w), (points, w), g)
        if not (torch.equal(got[0], plain[0]) and torch.allclose(got[0], want[0], **ORDER_TOL)
                and torch.allclose(got[1], want[1], rtol=1e-5, atol=1e-4)):
            raise AssertionError(
                f"three_interpolate Function at N={n}: d points off the plain Function by "
                f"{max_abs(got[0], plain[0])}, off autograd by {max_abs(got[0], want[0])}, "
                f"d weight by {max_abs(got[1], want[1])}"
            )


def bf16_kernel_phase(levels: list, seed: int, report: Report, skips=FP_SKIP_CHANNELS, fp=range(4)) -> None:
    """Rows 4 and 5's bfloat16 instances at the FP levels ``fp`` of the levels'
    batch (skip widths ``skips``), as the bf16 modes run them, each held bit for bit against its
    plain version on the same inputs (the same float32 arithmetic by
    construction), under both precisions and with a float32 skip beside
    bfloat16 points (a selective stage's concat: a float32 row). The rows are
    timed at the modes' own setting ("default", a bfloat16 skip; FP4's skip the
    colours cast to bfloat16) beside the float32 kernel on the same values
    widened (``f32_ms``, ``f32_device_ms``, ``f32_bound_ms``)."""
    dev = torch.device(DEVICE)
    b = levels[0].shape[0]
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed + 200)
    for i in fp:
        c, c1 = FP_CHANNELS[i], skips[i]
        lvl = 3 - i
        dense, coarse = levels[lvl], levels[lvl + 1]
        n, m = dense.shape[1], coarse.shape[1]
        d2, idx = ops.three_nn(dense, coarse, impl="cuda")
        weight = ops.interpolation_weights(d2)
        points = torch.randn((b, m, c), generator=gen, device=dev).to(bf16)
        if c1 == 3:  # the input cloud's colours, a view of row stride 6
            skip32 = torch.rand((b, n, 6), generator=gen, device=dev)[..., 3:]
        else:
            skip32 = torch.randn((b, n, c1), generator=gen, device=dev)
        skip = skip32.to(bf16)
        for precision, s in (("default", skip), ("highest", skip), ("default", skip32), ("highest", skip32), ("default", None)):
            got = ops.three_interpolate(points, idx, weight, impl="cuda", precision=precision, skip=s)
            want = ops.three_interpolate(points, idx, weight, impl="torch", precision=precision, skip=s)
            if got.dtype != want.dtype or not torch.equal(got, want):
                raise AssertionError(
                    f"three_interpolate bf16 at N={n} C={c} precision={precision} skip "
                    f"{None if s is None else s.dtype}: {got.dtype} vs {want.dtype}, max abs {max_abs(got, want)}"
                )
        out = ops.three_interpolate(points, idx, weight, impl="cuda", precision="default", skip=skip)
        ref = ops.three_interpolate(points, idx, weight, impl="torch", precision="default", skip=skip)
        flat_idx = (idx.long() + torch.arange(b, device=dev)[:, None, None] * m).reshape(-1, 3)
        flat_points, flat_w = points.reshape(b * m, c), weight.to(bf16).reshape(-1, 3)
        points32 = points.float()
        vec, skip_vec = cuda_interp.planned_route(points, skip)
        f32_bound = bound(*op_bench.work_fp_interpolate(b, n, m, c, c1))[0]
        report.add(
            "three_interpolate_bf16", b, f"M={m} C={c} N={n} skip={c1} precision=default",
            lambda: ops.three_interpolate(points, idx, weight, impl="cuda", precision="default", skip=skip),
            lambda: ops.three_interpolate(points, idx, weight, impl="torch", precision="default", skip=skip),
            *op_bench.work_fp_interpolate(b, n, m, c, c1, elem=2),
            err=max_abs(out, ref),
            match=out.dtype == bf16 and torch.equal(out, ref),
            library=lambda: torch.cat([F.embedding_bag(
                flat_idx, flat_points, mode="sum", per_sample_weights=flat_w
            ).view(b, n, c), skip], -1),
            extra={"f32_ms": lambda: ops.three_interpolate(points32, idx, weight, impl="cuda", skip=skip32)},
            info={"plan": {"vec": vec, "skip_vec": skip_vec},
                  "device_ms": device_ms(lambda: ops.three_interpolate(
                      points, idx, weight, impl="cuda", precision="default", skip=skip), "three_interpolate"),
                  "f32_device_ms": device_ms(
                      lambda: ops.three_interpolate(points32, idx, weight, impl="cuda", skip=skip32), "three_interpolate"),
                  "f32_bound_ms": f32_bound},
        )

        # The backward: a bfloat16 cotangent slice of the bfloat16 concat's
        # (a bfloat16 stage), and a float32 one (a selective stage's float32
        # concat), each into bfloat16 dpoints.
        g = torch.randn((b, n, c + c1), generator=gen, device=dev).to(bf16)[..., :c]
        g32 = torch.randn((b, n, c + c1), generator=gen, device=dev)[..., :c]
        for precision, gg in (("default", g), ("highest", g), ("highest", g32), ("default", g32)):
            got = ops.three_interpolate_grad(gg, idx, weight, m, impl="cuda", precision=precision, dtype=bf16)
            want = ops.three_interpolate_grad(
                gg.cpu(), idx.cpu(), weight.cpu(), m, impl="torch", precision=precision, dtype=bf16
            ).to(dev)
            again = ops.three_interpolate_grad(gg, idx, weight, m, impl="cuda", precision=precision, dtype=bf16)
            if got.dtype != bf16 or not torch.equal(got, want) or not torch.equal(got, again):
                raise AssertionError(
                    f"three_interpolate_grad bf16 at N={n} C={c} precision={precision} g {gg.dtype}: "
                    f"max abs {max_abs(got, want)} against the plain version, {max_abs(got, again)} run to run"
                )
        with deterministic_algorithms():
            card_plain = ops.three_interpolate_grad(g, idx, weight, m, impl="torch", precision="default", dtype=bf16)
        out = ops.three_interpolate_grad(g, idx, weight, m, impl="cuda", precision="default", dtype=bf16)
        flat_rows = torch.zeros((b * m, c), device=dev, dtype=bf16, requires_grad=True)
        bag = F.embedding_bag(flat_idx, flat_rows, mode="sum", per_sample_weights=flat_w)
        flat_g = g.reshape(-1, c)
        g32_copy = g.float()
        report.add(
            "three_interpolate_grad_bf16", b, f"N={n} C={c} M={m} g_row_stride={c + c1} precision=default",
            lambda: ops.three_interpolate_grad(g, idx, weight, m, impl="cuda", precision="default", dtype=bf16),
            lambda: ops.three_interpolate_grad(g, idx, weight, m, impl="torch", precision="default", dtype=bf16),
            *op_bench.work_three_interpolate_grad(b, n, m, c, elem=2),
            err=max_abs(out, card_plain),
            match=torch.equal(out, card_plain),
            library=lambda: torch.autograd.grad(bag, flat_rows, flat_g, retain_graph=True),
            extra={"f32_ms": lambda: ops.three_interpolate_grad(g32_copy, idx, weight, m, impl="cuda")},
            info={"device_ms": device_ms(lambda: ops.three_interpolate_grad(
                      g, idx, weight, m, impl="cuda", precision="default", dtype=bf16), "three_interpolate_grad"),
                  "f32_device_ms": device_ms(
                      lambda: ops.three_interpolate_grad(g32_copy, idx, weight, m, impl="cuda"),
                      "three_interpolate_grad"),
                  "f32_bound_ms": bound(*op_bench.work_three_interpolate_grad(b, n, m, c))[0]},
        )


def window_kernel_phase(cfg: Config, seed: int, report: Report, b: int, arch: str = "ssg",
                        x: Optional[np.ndarray] = None, bq_window: int = BQ_WINDOW,
                        fp_window: Optional[int] = FP_WINDOW) -> None:
    """The four calibrated-window kernels at the shapes a batch of ``b`` gives
    them (``x``, or the smoke clouds of ``seed``) at the windows ``bq_window``
    and ``fp_window`` (None: row 10 not held), each against its plain version
    on the same sorted inputs, and the whole calibrated ops (sorts, window
    starts, certificate) on the kernel path against the plain path, with a
    window that fits and one too small.

    Every row runs at both batches: row 7 (the windowed ball query of the
    train forward), rows 8 and 9 (the fused eval grouping), row 10 (FP4's
    windowed 3-NN). With ``arch="msg"``, rows 7-9 at MSG's SA1 first scale
    (half the radius and the samples, rows of 16 projected channels); row 10
    has no MSG shape of its own.
    """
    dev = torch.device(DEVICE)
    x = torch.from_numpy(clouds(b, cfg, seed) if x is None else x).to(dev)
    xyz = x[..., :3].contiguous()
    sa1, n = cfg.sa_layers[0], cfg.num_point
    m, ns, r, f0 = sa1.npoint, sa1.nsample, sa1.radius, SA_MLPS[0][0]
    if arch == "msg":
        (r, ns), f0 = msg_scales(sa1)[0], f0 // 2
    _, cent = ops.fps_centroids(xyz, m, impl="cuda")
    w = core.round_up(bq_window, core.LANES)
    perm, xs, _, qs, lo, ok = core.ball_query_window_plan(xyz, cent, r, w)
    if not bool(ok):
        raise AssertionError(f"bq_window={bq_window} does not certify SA1 on the smoke clouds")
    tiles = lo.shape[1]
    first, last = core.ball_query_tile_spans(xs, qs, lo, r, w)
    pairs = int((last - first).sum())  # the columns of each query's x-span: all that can hit
    bq_bytes = b * n * 16 + b * m * 12 + b * tiles * 4  # sorted cloud and indices, sorted queries, starts
    route = list(cuda_ballquery.tiles_route(xs, m, m // tiles, w))
    bq_info = {"route": route, "pairs": pairs, "window_pairs": b * m * w}

    def check_op(name, run, plain, windows, want_ok):
        """The whole calibrated op on both paths: equal outputs and ok."""
        for window in windows:
            got, want = run(window), plain(window)
            if not all((g is None and h is None) or torch.equal(g, h) for g, h in zip(got, want)):
                raise AssertionError(f"{name} at window {window}: the kernel path and the plain path disagree")
            if want_ok.get(window) is not None and bool(got[-1]) != want_ok[window]:
                raise AssertionError(f"{name} at window {window}: ok {bool(got[-1])}, want {want_ok[window]}")

    got = cuda.ball_query_tiles(xs, perm, qs, lo, r, ns, w)
    want = core.ball_query_tiles(xs, perm, qs, lo, r, ns, w)
    report.add(
        "ball_query_sliced", b, f"N={n} M={m} r={r} nsample={ns} w={w}",
        lambda: cuda.ball_query_tiles(xs, perm, qs, lo, r, ns, w),
        lambda: core.ball_query_tiles(xs, perm, qs, lo, r, ns, w),
        nbytes=bq_bytes + b * m * (ns + 1) * 4,
        nops=9 * pairs,
        err=0.0,
        match=all(torch.equal(g, h) for g, h in zip(got, want)),
        extra={
            "op_ms": lambda: ops.ball_query_calibrated(xyz, cent, r, ns, bq_window, impl="cuda"),
            "exact_op_ms": lambda: ops.ball_query(xyz, cent, r, ns, impl="cuda"),
        },
        info=bq_info,
    )
    check_op(
        "ball_query_calibrated",
        lambda win: ops.ball_query_calibrated(xyz, cent, r, ns, win, impl="cuda"),
        lambda win: ops.ball_query_calibrated(xyz, cent, r, ns, win, impl="torch"),
        (bq_window, SMALL_BQ_WINDOW), {bq_window: True, SMALL_BQ_WINDOW: False},
    )

    got = cuda.ball_query_tiles_pos(xs, perm, qs, lo, r, ns, w)
    want = core.ball_query_tiles_pos(xs, perm, qs, lo, r, ns, w)
    gen = torch.Generator(device=dev).manual_seed(seed)
    w0 = torch.randn((cfg.point_dim, f0), generator=gen, device=dev) * 0.5
    b0 = torch.randn((f0,), generator=gen, device=dev) * 0.1
    report.add(
        "ball_query_sliced_pos", b, f"N={n} M={m} r={r} nsample={ns} w={w}",
        lambda: cuda.ball_query_tiles_pos(xs, perm, qs, lo, r, ns, w),
        lambda: core.ball_query_tiles_pos(xs, perm, qs, lo, r, ns, w),
        nbytes=bq_bytes + b * m * (2 * ns + 1) * 4,
        nops=9 * pairs,
        err=0.0,
        match=all(torch.equal(g, h) for g, h in zip(got, want)),
        extra={
            "op_ms": lambda: ops.project_group_calibrated(x, w0, b0, xyz, cent, r, ns, bq_window, impl="cuda"),
            "exact_op_ms": lambda: ops.project_group_leaf(
                x, w0, b0, ops.ball_query(xyz, cent, r, ns, impl="cuda")[0]
            ),
        },
        info=bq_info,
    )
    check_op(
        "project_group_calibrated",
        lambda win: ops.project_group_calibrated(x, w0, b0, xyz, cent, r, ns, win, impl="cuda"),
        lambda win: ops.project_group_calibrated(x, w0, b0, xyz, cent, r, ns, win, impl="torch"),
        (bq_window, SMALL_BQ_WINDOW), {bq_window: True, SMALL_BQ_WINDOW: False},
    )

    pos = got[1]
    zp_s = ops.gather_points(x, perm) @ w0 + b0  # the projected sorted cloud, as the fused op makes it
    gather_rows(report, b, n, zp_s, lo, pos)
    if arch != "ssg" or fp_window is None:
        return

    # FP4: the dense cloud's 3-NN among SA1's centroids.
    wf = core.round_up(fp_window, core.LANES)
    fperm, fxs, _, fqs, flo = core.knn_window_plan(cent, xyz, wf)
    got = cuda.knn_tiles(fxs, fperm, fqs, flo, 3, wf)
    want = core.knn_tiles(fxs, fperm, fqs, flo, 3, wf)
    nq = fqs.shape[1]
    pairs = op_bench.knn_tiles_pairs(fxs, fqs, flo, want[0], wf)
    report.add(
        "knn_sliced", b, f"Nq={n} M={m} k=3 w={wf}",
        lambda: cuda.knn_tiles(fxs, fperm, fqs, flo, 3, wf),
        lambda: core.knn_tiles(fxs, fperm, fqs, flo, 3, wf),
        *op_bench.work_knn_tiles(b, m, nq, flo.shape[1], 3, pairs),
        err=max_abs(got[0], want[0]),
        match=torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
        extra={
            "op_ms": lambda: ops.three_nn_calibrated(xyz, cent, fp_window, impl="cuda"),
            "exact_op_ms": lambda: ops.three_nn(xyz, cent, impl="cuda"),
        },
        info={"blocks": flo.numel(), "pairs": pairs, "window_pairs": b * nq * wf,
              "device_ms": device_ms(lambda: cuda.knn_tiles(fxs, fperm, fqs, flo, 3, wf), "knn_sliced")},
    )
    check_op(
        "three_nn_calibrated",
        lambda win: ops.three_nn_calibrated(xyz, cent, win, impl="cuda"),
        lambda win: ops.three_nn_calibrated(xyz, cent, win, impl="torch"),
        (fp_window, SMALL_FP_WINDOW), {fp_window: True},
    )


def gather_rows(report: Report, b: int, n: int, zp_s: torch.Tensor, lo: torch.Tensor, pos: torch.Tensor) -> None:
    """Row 9 at the fused grouping's shapes: the planned route against its
    plain version and ``index_select`` of the same rows, timed beside its
    bound; then one line for each forced route (16-byte vectors or floats)
    and one for a source 4 bytes off 16-byte alignment, which must plan the
    float route. Every line bit for bit."""
    m, ns = pos.shape[1:]
    c = zp_s.shape[-1]
    rows = op_bench.gather_source_rows(lo, pos, n)
    flat = zp_s.reshape(b * n, c)
    want = core.window_gather(zp_s, lo, pos)

    def equal(out):
        return torch.equal(out, want) and torch.equal(out.reshape(-1, c), torch.index_select(flat, 0, rows))

    out = cuda.window_gather(zp_s, lo, pos)
    shape = f"N={n} M={m} K={ns} C={c}"
    report.add(
        "window_gather", b, shape,
        lambda: cuda.window_gather(zp_s, lo, pos),
        lambda: core.window_gather(zp_s, lo, pos),
        *op_bench.work_window_gather(lo, rows, c),
        err=max_abs(out, want),
        match=equal(out),
        library=lambda: torch.index_select(flat, 0, rows),
        info={"route": list(cuda_gather.planned_route(zp_s)),
              "device_ms": device_ms(lambda: cuda.window_gather(zp_s, lo, pos), "window_gather")},
    )
    offset = torch.empty(zp_s.numel() + 1, device=zp_s.device)[1:].view_as(zp_s)
    offset.copy_(zp_s)
    if cuda_gather.planned_route(offset)[0]:
        raise AssertionError("window_gather planned 16-byte vectors on a source 4 bytes off alignment")
    routes = [(vec, cuda_gather.plan(c, vec)[1]) for vec in (True, False)]
    for forced, src in [(route, zp_s) for route in routes] + [(None, offset)]:
        out = cuda.window_gather(src, lo, pos, route=forced)
        if not equal(out):
            raise AssertionError(f"window_gather on route {forced} at {shape} disagrees with its plain version")
        emit({"kernel": "window_gather", "batch": b, "shape": f"B={b} {shape}",
              "forced_route": None if forced is None else list(forced),
              "route": list(cuda_gather.planned_route(src, forced)),
              "source_offset_bytes": src.data_ptr() % 16,
              "kernel_ms": cuda_ms(lambda: cuda.window_gather(src, lo, pos, route=forced)),
              "device_ms": device_ms(lambda: cuda.window_gather(src, lo, pos, route=forced),
                                     "window_gather"),
              "max_abs_err": max_abs(out, want), "match": True, "card": report.card})


def repaired_phase(cfg: Config, seed: int, report: Report) -> None:
    """The limits this port once refused, each kernel against its plain version
    on the card, bit for bit: kNN past k = 16 (the list route) on the
    roadmap's input (64 references, 8 queries) and at FP4's shape; the two
    calibrated windowed ball-query kernels with nsample = 64 (the sorted list
    in the output row) on the roadmap's input (1024 / 128 points, radius 0.2,
    window 512) and at SA1's shape, and with a window past a block's shared
    memory (16384 columns at N = 32768, read from device memory); the
    windowed kNN with k = 32 at FP4's shape and with the wide window. The
    whole calibrated ops are held on both paths too. These rows carry the
    batches 1 and 2, apart from the model's 8 and 16."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed + 600)
    sms = cuda_ballquery.num_sms(dev.index or 0)

    def knn_row(label, refs, queries, k):
        b, m, nq = refs.shape[0], refs.shape[1], queries.shape[1]
        got, want = cuda.knn(refs, queries, k), core.knn(refs, queries, k)
        report.add(
            "knn", b, f"{label} Nq={nq} M={m} k={k}",
            lambda: cuda.knn(refs, queries, k), lambda: core.knn(refs, queries, k),
            *op_bench.work_knn(b, nq, m, k), err=max_abs(got[0], want[0]),
            match=torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            info={"plan": cuda_knn.plan(b, nq, m, k, sms), "case": "repaired"},
        )

    def bq_rows(label, xyz, cent, r, ns, w):
        b, n, m = xyz.shape[0], xyz.shape[1], cent.shape[1]
        perm, xs, _, qs, lo, _ = core.ball_query_window_plan(xyz, cent, r, w)
        first, last = core.ball_query_tile_spans(xs, qs, lo, r, w)
        pairs, base = int((last - first).sum()), b * n * 16 + b * m * 12 + b * lo.shape[1] * 4
        route = list(cuda_ballquery.tiles_route(xs, m, m // lo.shape[1], w))
        for name, fn, plain, out_ints in (
            ("ball_query_sliced", cuda.ball_query_tiles, core.ball_query_tiles, ns + 1),
            ("ball_query_sliced_pos", cuda.ball_query_tiles_pos, core.ball_query_tiles_pos, 2 * ns + 1),
        ):
            got, want = fn(xs, perm, qs, lo, r, ns, w), plain(xs, perm, qs, lo, r, ns, w)
            report.add(
                name, b, f"{label} N={n} M={m} r={r} nsample={ns} w={w}",
                lambda fn=fn: fn(xs, perm, qs, lo, r, ns, w), lambda plain=plain: plain(xs, perm, qs, lo, r, ns, w),
                nbytes=base + b * m * out_ints * 4, nops=9 * pairs, err=0.0,
                match=all(torch.equal(g, h) for g, h in zip(got, want)),
                info={"case": "repaired", "max_count": int(got[-1].max()), "staged": w <= 232448 // 16,
                      "route": route},
            )
        got = ops.ball_query_calibrated(xyz, cent, r, ns, w, impl="cuda")
        want = ops.ball_query_calibrated(xyz, cent, r, ns, w, impl="torch")
        if not all(torch.equal(g, h) for g, h in zip(got, want)):
            raise AssertionError(f"ball_query_calibrated {label}: the kernel path and the plain path disagree")

    def knn_tiles_row(label, refs, queries, k, w):
        b, m = refs.shape[:2]
        fperm, fxs, _, fqs, flo = core.knn_window_plan(refs, queries, w)
        got, want = cuda.knn_tiles(fxs, fperm, fqs, flo, k, w), core.knn_tiles(fxs, fperm, fqs, flo, k, w)
        nq = fqs.shape[1]
        report.add(
            "knn_sliced", b, f"{label} Nq={nq} M={m} k={k} w={w}",
            lambda: cuda.knn_tiles(fxs, fperm, fqs, flo, k, w), lambda: core.knn_tiles(fxs, fperm, fqs, flo, k, w),
            # the list route (k > 16) scans the whole window; the register route each query's span
            *op_bench.work_knn_tiles(b, m, nq, flo.shape[1], k, b * nq * w if k > cuda_knn.MAX_REGISTER_K
                                     else op_bench.knn_tiles_pairs(fxs, fqs, flo, want[0], w)),
            err=max_abs(got[0], want[0]), match=torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            info={"case": "repaired", "blocks": flo.numel()},
        )
        got = ops.knn_calibrated(refs, queries, k, w, impl="cuda")
        want = ops.knn_calibrated(refs, queries, k, w, impl="torch")
        if not all(torch.equal(g, h) for g, h in zip(got, want)):
            raise AssertionError(f"knn_calibrated {label}: the kernel path and the plain path disagree")

    small1 = torch.rand((1, 64, 3), generator=gen, device=dev)
    small2 = torch.rand((1, 8, 3), generator=gen, device=dev)
    knn_row("roadmap input", small1, small2, 32)
    x = torch.from_numpy(clouds(2, cfg, seed + 600)).to(dev)
    xyz = x[..., :3].contiguous()
    sa1 = cfg.sa_layers[0]
    cent = ops.fps_centroids(xyz, sa1.npoint, impl="cuda")[1].contiguous()
    knn_row("FP4 shape", cent, xyz, 32)
    bq1 = torch.rand((1, 1024, 3), generator=gen, device=dev)
    bq2 = torch.rand((1, 128, 3), generator=gen, device=dev)
    bq_rows("roadmap input", bq1, bq2, 0.2, 64, 512)
    bq_rows("SA1 shape", xyz, cent, sa1.radius, 64, core.round_up(BQ_WINDOW, core.LANES))
    wide = torch.rand((1, 32768, 3), generator=gen, device=dev) * torch.tensor([8.0, 1.0, 1.0], device=dev)
    wide_q = wide[:, ::32].contiguous()
    for ns in (32, 64):
        bq_rows("window past shared memory", wide, wide_q, 0.2, ns, 16384)
    knn_tiles_row("FP4 shape", cent, xyz, 32, core.round_up(FP_WINDOW, core.LANES))
    knn_tiles_row("window past shared memory", wide, wide_q, 3, 16384)


# The probes phase (2b): the TPU design probes' four kernels and their tools.
PROBE_FPS = (  # (label, B, N, npoint, integer coordinates); the first is timed
    ("probe shape", 64, 8192, 1024, False),
    ("npoint = N, B not a multiple of 8", 12, 1000, 1000, False),
    ("N not a multiple of C", 12, 8191, 256, False),
    ("npoint = 1", 12, 1000, 1, False),
    ("npoint = 2", 12, 1000, 2, False),
    ("integer coordinates (ties)", 16, 8192, 1024, True),
)
PROBE_KNN = (  # (label, B, queries, references, k, integer coordinates)
    ("probe shape (FP4 3-NN)", 64, 8192, 1024, 3, False),
    ("SA1 grouping", 16, 1024, 8192, 1, False),
    ("SA1 grouping", 16, 1024, 8192, 16, False),
    ("SA1 grouping", 16, 1024, 8192, 32, False),
    ("integer coordinates (ties)", 8, 1000, 1000, 16, True),
)
PROBE_BQ_EDGE = dict(b=4, n=1001, m=300, nsample=40, radius=0.15)  # integer-grid coordinates (ties)
PROBE_BQ_RING = dict(b=2, n=20000, m=1024)  # the sweep kernels' ring: 20 chunks of 1024 points, 4 slots
PROBE_BQ_NOT_FITTING = 1024  # the cond probe's shape with windows its tiles do not fit
PROBE_GATHER_EDGE = dict(b=5, n=2048, c=3, m=256, k=16)  # no multiple of 8 clouds, no 16-byte vectors
# The window kernel's edge: 5 clouds of 3 channels, two tiles of 128 queries;
# the second tile's base 2048 - 384 lies in the last block, whose neighbour is clamped.
PROBE_WINDOW_EDGE = dict(n=2048, m=256, k=16, span=384, w=512, tm=128)
# The 4-D grouping's edges: 3 clouds of 2048 points, 1024 queries drawn apart
# from the cloud (empty balls, balls short of K), W = 512 (wblk 512): the last
# of the 8 tiles starts in the last block, whose neighbour is clamped.
PROBE_OUT4D_EDGE = dict(b=3, n=2048, m=1024, window=512, radius=0.3)
# Both window gathers' span edges: clouds of N = 2048 in blocks of W = 512,
# tiles of 128 queries, positions drawn over [0, 2W). Cases (label, B, C, K,
# first blocks of the tiles, one row a tile, the array 4 bytes off 16-byte
# alignment), each reaching an edge through the plan on 132 SMs: 12 tiles
# take 22 parts a tile, which do not divide a span of about 1024 rows; 160
# tiles one part (t * b past the SMs). Clamped tiles whose positions pass W
# on the cooperative route (C = 3) and the bulk one (C = 64, K = 64); C =
# 1024, chunks of 4 rows, so each part's ring wraps; spans of one row; 160
# tiles of 128-row chunks, the ring wrapping through a span, on the bulk
# route and, unaligned, the cooperative one.
PROBE_SPAN_SHAPE = (2048, 512, 128)  # N, W, tm
PROBE_SPAN_EDGES = (
    ("edge, clamped past W", 3, 3, 16, (0, 2, 3, 3), False, False),
    ("edge, clamped past W", 3, 64, 64, (0, 2, 3, 3), False, False),
    ("edge, 4-row chunks", 3, 1024, 16, (0, 2, 3, 3), False, False),
    ("edge, one-row spans", 3, 32, 16, (0, 1, 2, 3), True, False),
    ("edge, 160 tiles", 40, 32, 16, (0, 1, 2, 3), False, False),
    ("edge, 160 tiles unaligned", 40, 32, 64, (0, 1, 2, 3), False, True),
)
PROBE_KERNELS = ("fps_remask", "fps_packed", "knn_argmin", "knn_tracked",
                 "bq_keys", "bq_fat", "bq_precut_cond", "bq_precut_decomp",
                 "gather_rows", "gather_rows_staged", "gather_window_staged", "gather_fused_idx",
                 "bq_precut_pos", "gather_window_out4d")


def bq_exact_rows(report: Report, label: str, x1: np.ndarray, x2: np.ndarray, r: float, ns: int) -> None:
    """``bq_keys`` (int32, int16 keys) and ``bq_fat`` (tm 128, 256) on one cloud
    batch, each equal to its plain version, to row 2 and to the oracle on the
    first two clouds; row 2's bound (9 operations a scanned pair)."""
    dev = torch.device(DEVICE)
    xyz1, xyz2 = torch.from_numpy(x1).to(dev), torch.from_numpy(x2).to(dev)
    b, n, _ = x1.shape
    m = x2.shape[1]
    row2 = cuda.ball_query(xyz1, xyz2, r, ns)
    oracle = reference.ball_query_np(x1[:2], x2[:2], r, ns)
    work = op_bench.work_ball_query(b, n, m, ns, int(op_bench.scanned_pairs(*row2, n, ns).sum()))
    staged = "whole" if cuda_bq_probes.staged_whole(n) else "ring"
    variants = []
    kq, v = cuda_bq_probes.SWEEP_KQ, cuda_bq_probes.SWEEP_V
    for i16 in (False, True):
        warps, how = cuda_bq_probes.key_route(xyz1, m, i16)
        variants.append(("bq_keys", f"keys=int{16 if i16 else 32}", lambda i16=i16: cuda.bq_keys(xyz1, xyz2, r, ns, i16),
                         lambda i16=i16: bq_i16_probe.bq_keys_plain(xyz1, xyz2, r, ns, i16),
                         {"plan": {"warps": warps, "kq": kq, "v": v}, "staging": how, "staged": staged}))
    for tm in (128, 256):
        cluster, route = cuda_bq_probes.fat_route(xyz1, m, tm)
        variants.append(("bq_fat", f"tm={tm}", lambda tm=tm: cuda.bq_fat(xyz1, xyz2, r, ns, tm),
                         lambda tm=tm: bq_fat_probe.bq_fat_plain(xyz1, xyz2, r, ns, tm),
                         {"tm": tm, "plan": {"blocks_a_tile": cluster, "chunk_columns": cuda_bq_probes.CHUNK_POINTS,
                                             "route": route},
                          "warps": tm // (cluster * kq), "staged": staged}))
    for name, variant, run, plain, info in variants:
        got, want = run(), plain()
        exact = bq_i16_probe.same(got, row2) and bq_i16_probe.oracle_exact(got, oracle, 2)
        report.add(
            name, b, f"{label} N={n} M={m} nsample={ns} r={r} {variant}", run, plain, *work, err=0.0,
            match=bq_i16_probe.same(got, want) and exact, plain_timing=FEW,
            extra={"row2_ms": lambda: cuda.ball_query(xyz1, xyz2, r, ns)},
            info={**info, "device_ms": device_ms(run, name),
                  "row2_device_ms": device_ms(lambda: cuda.ball_query(xyz1, xyz2, r, ns), "ball_query"),
                  "case": "probes"},
        )


def precut_row(report: Report, name: str, label: str, xyz1, xyz2, r: float, ns: int, w: int, guard: bool,
               fits_expected: bool) -> None:
    """The pre-cut kernel at ``name``'s site on ``bq_cond_probe.precut_plan``'s
    windows (``guard``: behind the device-read predicate), equal to its plain
    version and to row 7 reading the same windows in place; where the windows
    fit, its outputs in query order equal row 2's and the oracle's on the
    first two clouds, and where they do not the guarded outputs are zeros.
    Row 7's bound (9 operations a pair of each query's x-span in its window;
    a failed guard writes the outputs only)."""
    b, n, _ = xyz1.shape
    plan = bq_cond_probe.precut_plan(xyz1, xyz2, r, w)
    fits = bq_cond_probe.fits_of(plan, w)
    if bool(fits) != fits_expected:
        raise AssertionError(f"{name} at W={w}: the windows fit={bool(fits)}, expected {fits_expected}")
    t, tm = plan["q_tiles"].shape[1:3]
    m = t * tm
    qs = plan["q_tiles"].reshape(b, m, 3)
    kernel = cuda.bq_precut_cond if name == "bq_precut_cond" else cuda.bq_precut_decomp
    args = (plan["win"], plan["permw"], plan["q_tiles"], n, r, ns)
    extra_args = {"fits": fits} if guard else {}
    got = kernel(*args, **extra_args)
    match = bq_i16_probe.same(got, bq_cond_probe.precut_plain(*args, **extra_args))
    row7 = lambda: cuda.ball_query_tiles(plan["xs"], plan["perm"], qs, plan["lo"], r, ns, w)
    if guard and not fits_expected:
        match = match and not any(bool(g.any()) for g in got)
        work = (b * t * tm * (ns + 1) * 4 + 4, 0)
    else:
        idx7, cnt7 = row7()
        match = match and torch.equal(got[0].reshape(b, m, ns), idx7) and torch.equal(got[1].reshape(b, m), cnt7)
        if fits_expected:
            ordered = bq_cond_probe.in_query_order(plan, *got)
            oracle = reference.ball_query_np(xyz1[:2].cpu().numpy(), xyz2[:2].cpu().numpy(), r, ns)
            match = (match and bq_i16_probe.same(ordered, cuda.ball_query(xyz1, xyz2, r, ns))
                     and bq_i16_probe.oracle_exact(ordered, oracle, 2))
        first, last = core.ball_query_tile_spans(plan["xs"], qs, plan["lo"], r, w)
        work = op_bench.work_ball_query_precut(b, t, tm, w, ns, int((last - first).sum()))
    xs_t = plan["xs"].transpose(1, 2).contiguous()
    report.add(
        name, b, f"{label} N={n} M={m} nsample={ns} r={r} W={w}{' guard' if guard else ''}",
        lambda: kernel(*args, **extra_args), lambda: bq_cond_probe.precut_plain(*args, **extra_args), *work,
        err=0.0, match=match, plain_timing=FEW,
        extra={"row7_in_place_ms": row7, "row2_ms": lambda: cuda.ball_query(xyz1, xyz2, r, ns),
               "cut_ms": lambda: bq_cond_probe.cut(xs_t, plan["lo"], w),
               "sorts_ms": lambda: bq_sliced_decomp_probe.sorts_only(xyz1, xyz2, r, w)},
        info={"fits": bool(fits), "tiles_fit": int(((plan["hi"] - plan["lo"]) <= w).sum()), "tiles": b * t,
              "route": cuda_bq_probes.precut_route(b, t, tm, w, xyz1.device.index),
              "device_ms": device_ms(lambda: kernel(*args, **extra_args), name),
              "row7_in_place_device_ms": device_ms(row7, "ball_query_sliced"), "case": "probes"},
    )


def bq_probe_rows(report: Report) -> None:
    """The four ball-query probe kernels at the probes' own shapes and at
    ``PROBE_BQ_EDGE``: ``bq_keys``, ``bq_fat`` (also at ``PROBE_BQ_RING``),
    and the pre-cut kernel at both of its sites."""
    dev = torch.device(DEVICE)
    s = bq_i16_probe.SHAPES
    x1, x2, _, _ = bq_i16_probe.probe_clouds(s, torch.device("cpu"))
    bq_exact_rows(report, "probe shape", x1, x2, s["radius"], s["nsample"])
    e = PROBE_BQ_EDGE
    rng = np.random.RandomState(SEED + 720)
    grid = lambda b, n: (np.round(rng.rand(b, n, 3) * 16) / 16).astype(np.float32)
    bq_exact_rows(report, "integer grid (ties)", grid(e["b"], e["n"]), grid(e["b"], e["m"]), e["radius"], e["nsample"])
    x1, x2, _, _ = bq_i16_probe.probe_clouds({**s, **PROBE_BQ_RING}, torch.device("cpu"))
    bq_exact_rows(report, "ring (the cloud past a block)", x1, x2, s["radius"], s["nsample"])

    c = bq_cond_probe.SHAPES
    b, n, m, ns, r = (c[k] for k in ("b", "n", "m", "nsample", "radius"))
    cloud = np.random.RandomState(0).rand(b, n, 3).astype(np.float32)
    xyz1 = torch.from_numpy(cloud).to(dev)
    xyz2 = torch.from_numpy(np.ascontiguousarray(cloud[:, :: n // m][:, :m])).to(dev)
    precut_row(report, "bq_precut_cond", "probe shape", xyz1, xyz2, r, ns, c["window"], False, True)
    precut_row(report, "bq_precut_cond", "probe shape", xyz1, xyz2, r, ns, c["window"], True, True)
    precut_row(report, "bq_precut_cond", "not fitting", xyz1, xyz2, r, ns, PROBE_BQ_NOT_FITTING, True, False)
    precut_row(report, "bq_precut_decomp", "probe shape", xyz1, xyz2, r, ns,
               bq_sliced_decomp_probe.SHAPES["window"], False, False)
    ties = torch.from_numpy(grid(2, 4096)).to(dev)
    ties_q = ties[:, ::4].contiguous()
    precut_row(report, "bq_precut_cond", "integer grid (ties)", ties, ties_q, 0.05, 40, 1536, True, True)
    precut_row(report, "bq_precut_decomp", "integer grid (ties)", ties, ties_q, 0.05, 40, 512, False, False)


def gather_work(idx: torch.Tensor, n: int, c: int) -> tuple[float, float]:
    """(bytes, operations) of a gather of (B, R) rows of (B, N, C) points by
    ``op_bench.work_window_gather``'s count with no window starts: each
    distinct source row read once, the indices read once, the output
    written once."""
    b = idx.shape[0]
    rows = (idx.long() + torch.arange(b, device=idx.device)[:, None] * n).reshape(-1)
    return op_bench.work_window_gather(idx.new_empty(0), rows, c)


def gather_rows_row(report: Report, name: str, label: str, pts: torch.Tensor, idx: torch.Tensor, m: int, k: int,
                    timed: bool = True) -> None:
    """``gather_rows``, ``gather_rows_staged`` or ``gather_fused_idx`` on one
    input: equal to its plain version, ``group_points`` and row 9 (one window
    a cloud at 0) bit for bit; the fused kernel's emitted indices equal to
    its input. ``timed``: the profiler's device ms beside."""
    kernel, plain = {
        "gather_rows": (cuda.gather_rows, gather_probe.gather_rows_plain),
        "gather_rows_staged": (cuda.gather_rows_staged, sp_gather_probe.sp_row_plain),
        "gather_fused_idx": (cuda.gather_fused_idx, fused_gather_probe.fused_idx_plain),
    }[name]
    b, n, c = pts.shape
    got, want = kernel(pts, idx), plain(pts, idx)
    fused = name == "gather_fused_idx"
    rows = got[0] if fused else got
    library = gather_probe.group_points(pts, idx, m, k)
    match = (all(torch.equal(g, w) for g, w in zip(got, want)) if fused else torch.equal(got, want))
    match = match and torch.equal(rows, library) and torch.equal(rows, gather_probe.row9_at_zero(pts, idx, m, k))
    if fused:
        match = match and torch.equal(got[1], idx[:, None, :])
    nbytes, nops = gather_work(idx, n, c)
    del got, want, rows, library
    row9 = lambda: gather_probe.row9_at_zero(pts, idx, m, k)
    report.add(
        name, b, f"{label} N={n} C={c} R={m * k}", lambda: kernel(pts, idx), lambda: plain(pts, idx),
        nbytes + (idx.numel() * 4 if fused else 0), nops, err=0.0, match=match, plain_timing=FEW,
        library=lambda: gather_probe.group_points(pts, idx, m, k), extra={"row9_ms": row9},
        info={"route": cuda_gather.planned_route(pts), "case": "probes",
              **({"device_ms": device_ms(lambda: kernel(pts, idx), name),
                  "row9_device_ms": device_ms(row9, "window_gather")} if timed else {})},
    )


def window_staged_rows(report: Report, label: str, b: int, c: int, shapes: dict, timed: bool = True) -> None:
    """``gather_window_staged`` at each unroll on ``sp_gather_probe``'s
    inputs of one regime: equal to its plain version, ``group_points`` and
    row 9 at window starts kblk * W bit for bit."""
    n, m, k, w, tm = (shapes[key] for key in ("n", "m", "k", "w", "tm"))
    dev = torch.device(DEVICE)
    pts_np, idx_np, kblk_np = sp_gather_probe.regime_inputs(b, c, shapes)
    sp_gather_probe.check_window(idx_np, kblk_np, w, tm)
    pts, idx3, kblk = (torch.from_numpy(a).to(dev) for a in (pts_np, idx_np, kblk_np))
    lo = kblk * w
    rel3 = cuda_gather_probes.relative_indices(idx3, kblk, w, tm).view(b, m, k)
    library = core.group_points(pts, idx3).view(b, m * k, c)
    want = sp_gather_probe.sp_win_plain(pts, idx3, kblk, w, tm)
    row9 = lambda: cuda.window_gather(pts, lo, rel3)
    same9 = torch.equal(row9().view(b, m * k, c), library) and torch.equal(want, library)
    nbytes, nops = op_bench.work_window_gather(lo, op_bench.gather_source_rows(lo, rel3, n), c)
    row9_device = device_ms(row9, "window_gather") if timed else None
    clamped = int((kblk == n // w - 1).sum())
    for unroll in cuda_gather_probes.WINDOW_UNROLLS:
        run = lambda u=unroll: cuda.gather_window_staged(pts, idx3, kblk, w, tm, u)
        got = run()
        report.add(
            "gather_window_staged", b, f"{label} N={n} C={c} M={m} K={k} W={w} unroll={unroll}", run,
            lambda: sp_gather_probe.sp_win_plain(pts, idx3, kblk, w, tm), nbytes, nops, err=0.0,
            match=same9 and torch.equal(got, want), plain_timing=FEW,
            library=lambda: core.group_points(pts, idx3), extra={"row9_ms": row9},
            info={"unroll": unroll, "tiles_clamped": clamped,
                  **sp_gather_probe.span_info("gather_window_staged", pts, rel3, kblk, w, tm * k), "case": "probes",
                  **({"device_ms": device_ms(run, "gather_window_staged"), "row9_device_ms": row9_device}
                     if timed else {})},
        )
        del got


def gather_probe_rows(report: Report) -> None:
    """The four gather probe kernels at the probes' own shapes and regimes,
    then at the edges (``PROBE_GATHER_EDGE``, ``PROBE_WINDOW_EDGE``)."""
    dev = torch.device(DEVICE)
    s = gather_probe.SHAPES
    pts, idx = gather_probe.probe_inputs(s, dev)
    gather_rows_row(report, "gather_rows", "probe shape", pts, idx, s["m"], s["k"])
    del pts, idx
    torch.cuda.empty_cache()
    sp = sp_gather_probe.SHAPES
    for name, regime in sp["regimes"].items():
        b, c = regime["b"], regime["c"]
        pts_np, idx_np, _ = sp_gather_probe.regime_inputs(b, c, sp)
        pts, idx = torch.from_numpy(pts_np).to(dev), torch.from_numpy(idx_np.reshape(b, -1)).to(dev)
        if name == "eval":  # the indices read from memory beside staged, at the same shape
            gather_rows_row(report, "gather_rows", f"{name} regime", pts, idx, sp["m"], sp["k"])
        gather_rows_row(report, "gather_rows_staged", f"{name} regime", pts, idx, sp["m"], sp["k"])
        window_staged_rows(report, f"{name} regime", b, c, sp)
    f = fused_gather_probe.SHAPES
    pts, idx = fused_gather_probe.probe_inputs(f, dev)
    gather_rows_row(report, "gather_fused_idx", "probe shape", pts, idx, f["r"], 1)
    e = PROBE_GATHER_EDGE
    rng = np.random.RandomState(SEED + 740)
    for c in (e["c"], 64):
        pts = torch.from_numpy(rng.rand(e["b"], e["n"], c).astype(np.float32)).to(dev)
        idx = torch.from_numpy(rng.randint(0, e["n"], (e["b"], e["m"] * e["k"])).astype(np.int32)).to(dev)
        for name in ("gather_rows", "gather_rows_staged", "gather_fused_idx"):
            gather_rows_row(report, name, "edge", pts, idx, e["m"], e["k"], timed=False)
    window_staged_rows(report, "edge, last block clamped", e["b"], e["c"], PROBE_WINDOW_EDGE, timed=False)
    for case in PROBE_SPAN_EDGES:
        window_edge_rows(report, *case)


def window_edge_rows(report: Report, label: str, b: int, c: int, k: int, kblk_of: tuple, one_row: bool,
                     unaligned: bool) -> None:
    """Both window gathers on one edge of their span plan (``PROBE_SPAN_EDGES``):
    window positions drawn in [0, 2W) over tiles whose first blocks are
    ``kblk_of`` (a clamped tile's positions past W read its block again),
    each tile's a single row where ``one_row``, the points 4 bytes past a
    16-byte boundary where ``unaligned``. Each kernel, at every unroll (P11),
    equals its plain version, ``group_points`` and row 9 at the rows the
    positions name, bit for bit; one row a kernel, timed."""
    n, w, tm = PROBE_SPAN_SHAPE
    dev = torch.device(DEVICE)
    t = len(kblk_of)
    rng = np.random.RandomState(SEED + 780 + c + b + k)
    values = torch.from_numpy(rng.rand(b * n * c + 1).astype(np.float32)).to(dev)
    pts = (values[1:] if unaligned else values[:-1]).view(b, n, c)
    kblk = torch.tensor([kblk_of] * b, dtype=torch.int32, device=dev)
    rel_np = rng.randint(0, 2 * w, (b, t, 1 if one_row else tm * k))
    rel = torch.from_numpy(np.broadcast_to(rel_np, (b, t, tm * k)).astype(np.int32).copy()).to(dev)
    rows = sp_gather_probe.window_rows(rel, kblk, n, w).reshape(b, t * tm, k)
    want = core.group_points(pts, rows)
    row9 = cuda.window_gather(pts, torch.zeros((b, t), dtype=torch.int32, device=dev), rows.to(torch.int32))
    nbytes, nops = gather_work(rows.reshape(b, -1), n, c)
    idx3 = (kblk.long()[:, :, None] * w + rel.long()).to(torch.int32).reshape(b, t * tm, k)
    staged = {
        "gather_window_staged": (
            lambda u=4: cuda.gather_window_staged(pts, idx3, kblk, w, tm, u).view(want.shape),
            lambda: sp_gather_probe.sp_win_plain(pts, idx3, kblk, w, tm).view(want.shape),
            cuda_gather_probes.WINDOW_UNROLLS),
        "gather_window_out4d": (
            lambda u=4: cuda.gather_window_out4d(pts, rel[:, :, None], kblk, w, tm, k),
            lambda: wingather_out4d_probe.window_out4d_plain(pts, rel[:, :, None], kblk, w, tm, k), (4,)),
    }
    for name, (run, plain, unrolls) in staged.items():
        match = torch.equal(plain(), want) and torch.equal(row9, want)
        match = match and all(torch.equal(run(u), want) for u in unrolls)
        report.add(
            name, b, f"{label} N={n} C={c} M={t * tm} K={k} W={w}", run, plain, nbytes, nops, err=0.0,
            match=match, plain_timing=FEW, library=lambda: core.group_points(pts, rows),
            extra={"row9_ms": lambda: cuda.window_gather(pts, torch.zeros_like(kblk), rows.to(torch.int32))},
            info={"tiles_clamped": int((kblk == n // w - 1).sum()), "unaligned": unaligned,
                  **sp_gather_probe.span_info(name, pts, rel, kblk, w, tm * k), "case": "probes"},
        )


def out4d_rows(report: Report, label: str, inputs, xyz, new_xyz, projections, r: float, k: int,
               window: int, timed: bool = False) -> dict:
    """The 4-D grouping's two kernels on one input, through
    ``wingather_out4d_probe.window_plan``: ``bq_precut_pos`` on the cut
    windows against its plain version and row 8 reading them in place (idx,
    pos, cnt), then ``gather_window_out4d`` on each sorted projection
    (``projections``: ``(w0, b0)`` pairs) against its plain version, row 9 at
    the same rows (``lo + pos``) and ``group_points``, all bit for bit.
    ``timed``: the gather's and row 9's device ms beside (the other kernels'
    at the probe's shape are the tool's, the ``probes`` path). Returns the
    rows' common fields (clamped tiles, empty and short balls)."""
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    plan = wingather_out4d_probe.window_plan(inputs, xyz, new_xyz, r, window)
    t, tm, w, wblk, lo = plan["t"], plan["tm"], plan["w"], plan["wblk"], plan["lo"]
    win_args = (plan["win"], plan["permw"], plan["q_tiles"], n, r, k)
    run13 = lambda: cuda.bq_precut_pos(*win_args)
    plain13 = lambda: wingather_out4d_probe.precut_pos_plain(*win_args)
    row8 = lambda: cuda.ball_query_tiles_pos(plan["xs"], plan["perm"], plan["qs"], lo, r, k, w)
    got, want, in_place = run13(), plain13(), row8()
    match13 = all(torch.equal(g, h) for g, h in zip(got, want)) and all(
        torch.equal(g.reshape(e.shape), e) for g, e in zip(got, in_place))
    idx_s, pos_s, cnt_s = got
    pos = pos_s.reshape(b, m, k)
    kblk, rel = wingather_out4d_probe.relative_rows(pos_s, lo, wblk)
    info = {"tiles_clamped": int((kblk == n // wblk - 1).sum()), "empty_balls": int((cnt_s == 0).sum()),
            "short_balls": int(((cnt_s > 0) & (cnt_s < k)).sum()), "ok": bool(plan["ok"]), "wblk": wblk,
            "case": "probes"}
    first, last = core.ball_query_tile_spans(plan["xs"], plan["qs"], lo, r, w)
    report.add(
        "bq_precut_pos", b, f"{label} N={n} M={m} K={k} r={r} W={w}", run13, plain13,
        *op_bench.work_ball_query_precut(b, t, tm, w, k, int((last - first).sum()), outs=2), err=0.0,
        match=match13, plain_timing=FEW, extra={"row8_in_place_ms": row8},
        info={**info, "route": cuda_bq_probes.precut_route(b, t, tm, w, xyz.device.index)},
    )
    del got, want, in_place
    rows = lo.long().repeat_interleave(tm, dim=1)[:, :, None] + pos.long()
    source_rows = op_bench.gather_source_rows(lo, pos, n)
    for w0, b0 in projections:
        zp_s = plan["sorted_inputs"] @ w0 + b0
        c = zp_s.shape[-1]
        run14 = lambda: cuda.gather_window_out4d(zp_s, rel, kblk, wblk, tm, k)
        plain14 = lambda: wingather_out4d_probe.window_out4d_plain(zp_s, rel, kblk, wblk, tm, k)
        row9 = lambda: cuda.window_gather(zp_s, lo, pos)
        got = run14()
        match14 = all(torch.equal(got, other) for other in (plain14(), row9(), core.group_points(zp_s, rows)))
        del got
        report.add(
            "gather_window_out4d", b, f"{label} N={n} M={m} K={k} C={c} wblk={wblk}", run14, plain14,
            *op_bench.work_window_gather(lo, source_rows, c), err=0.0, match=match14, plain_timing=FEW,
            library=lambda: core.group_points(zp_s, rows), extra={"row9_ms": row9},
            info={**info, **sp_gather_probe.span_info("gather_window_out4d", zp_s, rel, kblk, wblk, tm * k),
                  **({"device_ms": device_ms(run14, "gather_window_out4d"),
                      "row9_device_ms": device_ms(row9, "window_gather")} if timed else {})},
        )
    return info


def out4d_probe_rows(report: Report) -> None:
    """``bq_precut_pos`` and ``gather_window_out4d`` at the probe's own shape
    (``wingather_out4d_probe.SHAPES``), then at ``PROBE_OUT4D_EDGE`` with K
    = 16 and 64 and C = 3 and 64, each edge holding an empty ball and a
    clamped block."""
    dev = torch.device(DEVICE)
    s = wingather_out4d_probe.SHAPES
    inputs, w0, b0, xyz = wingather_out4d_probe.probe_inputs(s, dev)
    new_xyz = ops.fps_centroids(xyz, s["m"])[1]
    out4d_rows(report, "probe shape", inputs, xyz, new_xyz, [(w0, b0)], s["radius"], s["k"], s["window"], timed=True)
    e = PROBE_OUT4D_EDGE
    rng = np.random.RandomState(SEED + 760)
    box = np.array(wingather_out4d_probe.BOX, np.float32)
    xyz = (rng.rand(e["b"], e["n"], 3) * box).astype(np.float32)
    inputs = torch.from_numpy(np.concatenate([xyz, rng.rand(e["b"], e["n"], 3).astype(np.float32)], -1)).to(dev)
    new_xyz = torch.from_numpy((rng.rand(e["b"], e["m"], 3) * box).astype(np.float32)).to(dev)
    xyz = torch.from_numpy(xyz).to(dev)
    projections = [tuple(torch.from_numpy(a.astype(np.float32) * 0.1).to(dev) for a in (rng.randn(6, c), rng.randn(c)))
                   for c in (3, 64)]
    for k in (16, 64):
        edge = out4d_rows(report, "edge, queries apart", inputs, xyz, new_xyz, projections, e["radius"], k,
                          e["window"])
        if not (edge["tiles_clamped"] and edge["empty_balls"] and edge["short_balls"]):
            raise AssertionError(f"the 4-D grouping's edge misses a clamped block or a short or empty ball: {edge}")


def fps_probe_rows(report: Report, cloud) -> None:
    """``fps_remask`` (both flags) and ``fps_packed`` (each G) at
    ``PROBE_FPS``' shapes (``cloud(b, n, integer, scale)`` makes them), each
    equal bit for bit to its plain version, to row 6 and, on the first two
    clouds, to the oracle (N = 1000 takes the C = 1 route at every G; B =
    12, G = 8 leaves 4 groups empty). At the probe shape each row also gives
    the device ms (``device_ms``) beside row 6's, the chain of its route with
    row 6's exchange (``chain_ms``) and with the probes' own
    (``probe_chain_ms``)."""
    for label, b, n, npoint, integer in PROBE_FPS:
        xyz = cloud(b, n, integer, 8.0 if integer else 10.0)
        want6 = cuda.farthest_point_sample(xyz, npoint)
        oracle = reference.farthest_point_sample_np(xyz[:2].cpu().numpy(), npoint)
        work = op_bench.work_fps(b, n, npoint, rows=False)
        route6 = cuda_fps.planned_route(xyz, npoint, rows=False)
        timed = label == PROBE_FPS[0][0]
        row6 = lambda: cuda.farthest_point_sample(xyz, npoint)
        row6_device = device_ms(row6, "farthest_point_sample") if timed else None
        cases = [("fps_remask", f"remask={r}", 1, route6, lambda r=r: cuda.fps_remask(xyz, npoint, r),
                  lambda r=r: fps_mask_probe.fps_remask_plain(xyz, npoint, r)) for r in (True, False)]
        for g in fps_packed_probe.SHAPES["groups"]:
            if not cuda_probes.packed_candidates(n, g):
                continue  # G = 8 at N = 8191: no route keeps 1024 points of a cloud a block (the wrapper raises)
            plain = lambda g=g: fps_packed_probe.fps_packed_plain(xyz, npoint, g)
            route = cuda_probes.packed_route(xyz, npoint, g)
            cases.append(("fps_packed", f"G={g}", g, route, lambda g=g: cuda.fps_packed(xyz, npoint, g), plain))
        for name, variant, g, route, run, plain in cases:
            got = run()
            match = (torch.equal(got, plain()) and torch.equal(got, want6)
                     and bool((got[:2].cpu().numpy() == oracle).all()))
            info = {"plan": route, "row6_plan": route6, "case": "probes"}
            if timed:
                clusters = -(-b // g)
                info.update(
                    device_ms=device_ms(run, name), row6_device_ms=row6_device,
                    chain_ms=device_ms(lambda: cuda_fps.barrier_chain(clusters, npoint, route), "fps_barrier_chain",
                                       launches=1),
                    probe_chain_ms=device_ms(lambda: cuda_probes.probe_chain(clusters, npoint, g, route),
                                             "fps_probe_chain", launches=1),
                )
            report.add(
                name, b, f"{label} N={n} npoint={npoint} {variant}", run, plain, *work, err=0.0, match=match,
                plain_timing=FEW, extra={"row6_ms": row6}, info=info,
            )


def probes_phase(seed: int, report: Report) -> dict:
    """Phase 2b: the 14 probe kernels (``ops.cuda.probes``,
    ``ops.cuda.bq_probes``, ``ops.cuda.gather_probes``), each against its
    plain version (the probe tool's) on the card, bit for bit, at
    ``PROBE_FPS``, ``PROBE_KNN``, ``bq_probe_rows``', ``gather_probe_rows``'
    and ``out4d_probe_rows``' shapes; then the path: the eleven probe tools'
    ``main`` on the card at their own shapes. Returns the path's
    launch counts, reset just before the tools and read just after."""
    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    rng = np.random.RandomState(seed + 700)

    def cloud(b, n, integer, scale=10.0):
        x = rng.rand(b, n, 3) * scale
        return torch.from_numpy((np.round(x) if integer else x).astype(np.float32)).to(dev)

    fps_probe_rows(report, cloud)

    for label, b, nq, m, k, integer in PROBE_KNN:
        refs, queries = cloud(b, m, integer, 8.0), cloud(b, nq, integer, 8.0)
        for name, plain in (("knn_argmin", knn_variant_probe.knn_argmin_plain),
                            ("knn_tracked", knn_variant_probe.knn_tracked_plain)):
            fn = getattr(cuda, name)
            got, want = fn(refs, queries, k), plain(refs, queries, k)
            report.add(
                name, b, f"{label} Nq={nq} M={m} k={k}",
                lambda fn=fn: fn(refs, queries, k), lambda plain=plain: plain(refs, queries, k),
                *op_bench.work_knn(b, nq, m, k), err=max_abs(got[0], want[0]),
                match=torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), plain_timing=FEW,
                extra={"pn2_knn_ms": lambda: cuda.knn(refs, queries, k)},
                info={"warps": cuda_probes.knn_warps(m), "case": "probes"},
            )
    bq_probe_rows(report)
    torch.cuda.empty_cache()
    gather_probe_rows(report)
    torch.cuda.empty_cache()
    out4d_probe_rows(report)
    torch.cuda.empty_cache()

    cuda.reset_launches()
    tools = {"fps_mask_probe": fps_mask_probe.main([]), "fps_packed_probe": fps_packed_probe.main([]),
             "knn_variant_probe": knn_variant_probe.main([]), "bq_i16_probe": bq_i16_probe.main([]),
             "bq_fat_probe": bq_fat_probe.main([]), "bq_cond_probe": bq_cond_probe.main([]),
             "bq_sliced_decomp_probe": bq_sliced_decomp_probe.main([])}
    torch.cuda.empty_cache()
    tools.update(gather_probe=gather_probe.main([]), sp_gather_probe=sp_gather_probe.main([]),
                 fused_gather_probe=fused_gather_probe.main([]), wingather_out4d_probe=wingather_out4d_probe.main([]))
    launches = dict(cuda.LAUNCHES)
    missing = [name for name in PROBE_KERNELS if launches.get(name, 0) == 0]
    if missing:
        raise AssertionError(f"the probe tools launched no {missing}: {launches}")
    emit({"phase": "probes", "tools": tools, "launches": launches, "phase_seconds": time.perf_counter() - t0,
          "card": report.card})
    return launches


def no_host_read(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``: any
    synchronising PyTorch call in it (``.item()``, ``.cpu()``, ``bool()`` of a
    device tensor, ...) raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def clustered(b: int, cfg: Config, seed: int) -> torch.Tensor:
    """Smoke clouds with half their points in a 2 cm band of x: the query tiles
    over the band hold far more candidates than the window."""
    xyz = torch.from_numpy(np.ascontiguousarray(clouds(b, cfg, seed)[..., :3])).to(DEVICE)
    half = cfg.num_point // 2
    xyz[:, :half, 0] = 4.0 + 0.02 * xyz[:, :half, 0] / 8.0
    return xyz.contiguous()


def windowed_rows(report: Report, label: str, xyz, cent, radius: float, nsample: int) -> None:
    """The round-1 windowed ball query with its default window on one input:
    the kernel against its plain version on the op's sorted inputs, the whole
    op (run without a host read) against the plain windowed op and the exact
    kernel, all bit for bit; the tiles that fit, counted on the host from the
    plan's ``lo``/``hi``."""
    b, n = xyz.shape[:2]
    m = cent.shape[1]
    plan, w, fits, pairs = op_bench.windowed_plan(xyz, cent, radius, nsample)
    split, warps = cuda_ballquery.windowed_plan(b, n, m, m // fits.shape[1], w, cuda_ballquery.num_sms(xyz.device.index))
    got = cuda.ball_query_window_tiles(xyz, *plan, radius, nsample, w)
    want = core.ball_query_window_tiles(xyz, *plan, radius, nsample, w)
    op = no_host_read(lambda: ops.ball_query(xyz, cent, radius, nsample, impl="windowed"))
    plain_op = core.ball_query_windowed(xyz, cent, radius, nsample)
    exact = ops.ball_query(xyz, cent, radius, nsample, impl="cuda")
    match = all(torch.equal(g, h) for g, h in zip(got, want)) and all(
        torch.equal(g, h) and torch.equal(g, e) for g, h, e in zip(op, plain_op, exact)
    )
    report.add(
        "ball_query_windowed", b, f"{label} N={n} M={m} r={radius} nsample={nsample} w={w}",
        lambda: cuda.ball_query_window_tiles(xyz, *plan, radius, nsample, w),
        lambda: core.ball_query_window_tiles(xyz, *plan, radius, nsample, w),
        *op_bench.work_ball_query_windowed(b, n, m, fits.shape[1], nsample, pairs),
        err=0.0, match=match, plain_timing=FEW,
        extra={
            "op_ms": lambda: ops.ball_query(xyz, cent, radius, nsample, impl="windowed"),
            "exact_op_ms": lambda: ops.ball_query(xyz, cent, radius, nsample, impl="cuda"),
        },
        info={"cloud": label, "tiles_fit": int(fits.sum()), "tiles": fits.numel(), "no_host_read": True,
              "route": [split, warps], "blocks": fits.numel() * split, "pairs": pairs,
              "device_ms": device_ms(lambda: cuda.ball_query_window_tiles(xyz, *plan, radius, nsample, w),
                                     "ball_query_windowed")},
    )


def op_surface_kernel_phase(cfg: Config, levels: list, report: Report) -> None:
    """The two kernels of the op surface on the levels ``kernel_phase`` made
    for a batch: the index-only FPS at the four SA shapes, equal to its plain
    version and to the fused kernel's indices; the round-1 windowed ball query
    at SA1-SA3 (SA4's 64 points take the exact kernel statically)."""
    b = levels[0].shape[0]
    for spec, src in zip(cfg.sa_layers, levels):
        n, npoint = src.shape[1], spec.npoint
        idx = ops.farthest_point_sample(src, npoint, impl="cuda")
        match = torch.equal(idx, ops.farthest_point_sample(src, npoint, impl="torch")) and torch.equal(
            idx, ops.fps_centroids(src, npoint, impl="cuda")[0]
        )
        report.add(
            "farthest_point_sample", b, f"N={n} npoint={npoint}",
            lambda: ops.farthest_point_sample(src, npoint, impl="cuda"),
            lambda: ops.farthest_point_sample(src, npoint, impl="torch"),
            *op_bench.work_fps(b, n, npoint, rows=False), err=0.0, match=match, plain_timing=FEW,
            info={"plan": cuda_fps.planned_route(src, npoint, rows=False)},
        )
    for spec, src, cent in zip(cfg.sa_layers[:3], levels, levels[1:]):
        windowed_rows(report, "smoke clouds", src, cent, spec.radius, spec.nsample)


def windowed_stress_phase(cfg: Config, seed: int, report: Report) -> None:
    """The round-1 windowed ball query where the smoke clouds do not take it:
    a clustered cloud (tiles over the band fall back), a cloud of 65536
    points (its default window, 16384 columns, is read from device memory),
    and nsample = 64 (the sorted list in the output row)."""
    sa1 = cfg.sa_layers[0]
    xyz = clustered(BATCH, cfg, seed + 500)
    cent = ops.fps_centroids(xyz, sa1.npoint, impl="cuda")[1].contiguous()
    windowed_rows(report, "clustered", xyz, cent, sa1.radius, sa1.nsample)
    rng = np.random.RandomState(seed + 501)
    wide = torch.from_numpy((rng.rand(WIDE_B, WIDE_N, 3) * [8.0, 8.0, 4.9]).astype(np.float32)).to(DEVICE)
    queries = wide[:, rng.choice(WIDE_N, WIDE_M, replace=False)].contiguous()
    windowed_rows(report, "past shared memory", wide, queries, sa1.radius, sa1.nsample)
    xyz = torch.from_numpy(np.ascontiguousarray(clouds(CHUNK, cfg, seed)[..., :3])).to(DEVICE)
    cent = ops.fps_centroids(xyz, sa1.npoint, impl="cuda")[1].contiguous()
    windowed_rows(report, "nsample=64", xyz, cent, sa1.radius, 64)


def op_surface_phase(card: str) -> dict:
    """The port's op-level path. First ``tools.parity`` on the card: every
    kernel, the two FPS entries and the round-1 windowed ball query among
    them, against the NumPy oracles, with zero failures (its launches are
    comparisons and count nowhere). Then, launch counts reset just before
    and read just after, one run of ``tools.stage_bench``: the SA composite
    through ``ops.farthest_point_sample`` with the exact and the windowed
    ball query, the gather, the FP composite; the five kernels it drives
    must have run, and no other."""
    t0 = time.perf_counter()
    if parity.main([]) != 0:
        raise AssertionError("the parity sweep reported failures")
    parity_s = time.perf_counter() - t0
    cuda.reset_launches()
    stages = stage_bench.run(torch.device(DEVICE), small=False)
    launches = dict(cuda.LAUNCHES)
    driven = ("farthest_point_sample", "ball_query", "ball_query_windowed", "knn", "three_interpolate")
    if not all(launches.get(name) for name in driven) or set(launches) - set(driven):
        raise AssertionError(f"the op surface launched {launches}, want each of {driven} and no other")
    emit({
        "phase": "op_surface",
        "parity_seconds": parity_s,
        "stage_ms": {row["shape"]: row["ms"] for row in stages},
        "launches": launches,
        "card": card,
    })
    return launches


def _expect_launches(launches: dict, want: dict, what: str) -> None:
    """Every kernel launched exactly as often as ``want`` says (0 where it has no entry)."""
    got = {name: launches.get(name, 0) for name in KERNELS}
    want = {name: want.get(name, 0) for name in KERNELS}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, want {want}")


def _one_step(cfg: Config, impl, batch: dict, seed: int, prepare=None, **options):
    """Loss and parameter gradients of one dropout-free step from seeded
    weights, under PyTorch's deterministic algorithms (for the comparisons
    of two paths; the timed steps run without them). ``options``: the
    Trainer's windows, precision mode or layout; ``prepare``, called on the
    model before the step."""
    with deterministic_algorithms():
        trainer = Trainer(cfg, ops_impl=impl, dropout_rate=0.0, device=DEVICE, **options)
        trainer.init_state(seed, bn_stats="random")
        if prepare is not None:
            prepare(trainer.model)
        loss = trainer.train_step(batch)["loss"]
        grads = {name: p.grad.clone() for name, p in trainer.model.named_parameters()}
        torch.cuda.synchronize()
    return float(loss), grads


def _compare_steps(what: str, step: tuple, ref_step: tuple) -> dict:
    """One step's loss and gradients against another's: within 1e-5 of the
    loss and ``STEP_GRAD_TOL`` of each gradient's max abs, or raise. Returns
    the worst error and whether every gradient was equal bit for bit."""
    (loss, grads), (ref_loss, ref_grads) = step, ref_step
    worst = max(
        max_abs(grads[name], ref) / max(float(ref.abs().max()), 1e-30)
        for name, ref in ref_grads.items() if float(ref.abs().max()) > 1e-6
    )
    if abs(loss - ref_loss) > 1e-5 * abs(ref_loss) or worst > STEP_GRAD_TOL:
        raise AssertionError(f"{what}: loss {loss} vs {ref_loss}, worst gradient error {worst} of max abs")
    equal = all(torch.equal(grads[name], ref) for name, ref in ref_grads.items())
    return {"loss": loss, "ref_loss": ref_loss, "worst_grad_err_of_max_abs": worst, "bit_equal": equal}


def train_phase(cfg: Config, seed: int, card: str, arch: str = "ssg") -> dict:
    """The port's second main path: Trainer.train_step on full-width batches,
    of the ``arch`` model."""
    batches = [train_batch(cfg, BATCH, seed + 200 + i) for i in range(1 + TRAIN_STEPS)]
    trainer = Trainer(cfg, device=DEVICE, arch=arch)
    trainer.init_state(seed, bn_stats="random")
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    stats_before = {k: v.clone() for k, v in trainer.model.named_buffers()}
    trainer.train_step(batches[0], generator=gen)  # warm-up: first launches, allocator, cuBLAS
    torch.cuda.synchronize()

    cuda.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for batch in batches[1:]:
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch, generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    launches = dict(cuda.LAUNCHES)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    _expect_launches(launches, scaled(step_launches(arch), TRAIN_STEPS), f"{TRAIN_STEPS} {arch} train steps")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train losses not finite: {losses}")
    if metrics["confusion"].shape != (9, 9) or int(metrics["confusion"].sum()) != BATCH * cfg.num_point:
        raise AssertionError("bad confusion matrix")
    unmoved = [k for k, v in trainer.model.named_buffers() if torch.equal(v, stats_before[k])]
    if unmoved or trainer.step != 1 + TRAIN_STEPS:
        raise AssertionError(f"moving statistics that did not move: {unmoved}; step {trainer.step}")
    device = profiled_device_ms(lambda: trainer.train_step(batches[1], generator=gen))
    del trainer

    step = _one_step(cfg, None, batches[0], seed, arch=arch)
    again = _one_step(cfg, None, batches[0], seed, arch=arch)
    if again[0] != step[0] or not all(torch.equal(g, step[1][k]) for k, g in again[1].items()):
        raise AssertionError(f"two {arch} kernel-path steps from the same weights and batch gave other gradients")
    kernel_vs_plain = _compare_steps(
        f"{arch} kernel path vs plain path", step, _one_step(cfg, "torch", batches[0], seed, arch=arch)
    )
    del step, again

    accum = Trainer(cfg, accum_steps=ACCUM, device=DEVICE, arch=arch)
    accum.init_state(seed, bn_stats="random")
    accum.train_step(batches[0], generator=gen)
    torch.cuda.synchronize()
    cuda.reset_launches()
    accum_losses, accum_times = [], []
    for batch in batches[1 : 1 + ACCUM_STEPS]:
        t0 = time.perf_counter()
        metrics = accum.train_step(batch, generator=gen)
        torch.cuda.synchronize()
        accum_times.append((time.perf_counter() - t0) * 1e3)
        accum_losses.append(float(metrics["loss"]))
    accum_launches = dict(cuda.LAUNCHES)
    # The hoisted geometry once a step; the interpolation once a microbatch.
    _expect_launches(
        accum_launches,
        {name: ACCUM_STEPS * n * (ACCUM if name in INTERPOLATE_KERNELS else 1)
         for name, n in step_launches(arch).items()},
        f"{ACCUM_STEPS} {arch} accum-{ACCUM} steps",
    )
    if not all(np.isfinite(accum_losses)):
        raise AssertionError(f"accum losses not finite: {accum_losses}")

    median = statistics.median(times)
    row = {
        "phase": "train" if arch == "ssg" else f"train_{arch}",
        "arch": arch,
        "steps": TRAIN_STEPS,
        "batch": BATCH,
        "points": cfg.num_point,
        "optimizer": cfg.optimizer,
        "ms_per_step": times,
        "median_ms": median,
        "points_per_s": BATCH * cfg.num_point / (median / 1e3),
        "losses": losses,
        "launches": launches,
        "peak_memory_mb": peak_mb,
        "device": device,
        "kernel_vs_plain": kernel_vs_plain,
        "accum": {"accum_steps": ACCUM, "steps": ACCUM_STEPS, "ms_per_step": accum_times,
                  "losses": accum_losses, "launches": accum_launches},
        "card": card,
    }
    emit(row)
    return launches, row


def seeded_state(cfg: Config, seed: int, arch: str) -> dict:
    """Seeded weights of the ``arch`` model with moving statistics that do real work."""
    return convert.from_flax_variables(
        convert.init_variables(cfg, num_classes=9, seed=seed, bn_stats="random", arch=arch)
    )


def sa1_share(model, x: torch.Tensor) -> dict:
    """CUDA-event ms of the eval forward of one chunk ``x`` and of its SA1 level
    alone (the input cloud to SA1's features), and their ratio."""
    xyz, feats = x[..., :3].contiguous(), x[..., 3:6]
    with torch.no_grad():
        forward_ms = cuda_ms(lambda: model(x), **FEW)
        sa1_ms = cuda_ms(lambda: model.sa1(xyz, feats), **FEW)
    return {"forward_ms": forward_ms, "sa1_ms": sa1_ms, "sa1_share": sa1_ms / forward_ms}


def predict_phase(cfg: Config, requests: int, batch: int, seed: int, card: str, arch: str = "ssg") -> dict:
    """The port's main path: Predictor.predict_step on full-width requests,
    of the ``arch`` model; with the device ms of one request and SA1's share
    of a chunk's forward."""
    sd = seeded_state(cfg, seed, arch)
    predictor = Predictor(cfg, sd, num_classes=9, infer_chunk=CHUNK, device=DEVICE, arch=arch)
    inputs = [clouds(batch, cfg, seed + 1 + i) for i in range(requests)]
    predictor.predict_step(inputs[0])  # warm-up: first launches, allocator
    torch.cuda.synchronize()

    cuda.reset_launches()
    labels, times = [], []
    for x in inputs:
        t0 = time.perf_counter()
        labels.append(predictor.predict_step(x))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(cuda.LAUNCHES)

    chunks = requests * (batch // CHUNK)
    _expect_launches(launches, scaled(chunk_launches(arch), chunks), f"{chunks} {arch} predict chunks")

    plain = Predictor(cfg, sd, num_classes=9, infer_chunk=CHUNK, device=DEVICE, impl="torch", arch=arch)
    logits = predictor.infer_logits(inputs[0])
    ref_logits = plain.infer_logits(inputs[0])
    if logits.shape != (batch, cfg.num_point, 9) or not torch.isfinite(logits).all():
        raise AssertionError(f"bad logits: shape {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    logit_err = max_abs(logits, ref_logits)
    agree = []
    for x, got in zip(inputs, labels):
        want = plain.predict_step(x)
        agree.append(float((got == want).float().mean()))
    if min(agree) < 0.9999 or logit_err > 1e-3:
        raise AssertionError(f"{arch} kernel path vs plain path: label agreement {agree}, "
                             f"max abs logit diff {logit_err}")

    median = statistics.median(times)
    row = {
        "phase": "predict" if arch == "ssg" else f"predict_{arch}",
        "arch": arch,
        "requests": requests,
        "batch": batch,
        "points": cfg.num_point,
        "infer_chunk": CHUNK,
        "ms_per_request": times,
        "median_ms": median,
        "points_per_s": batch * cfg.num_point / (median / 1e3),
        "launches": launches,
        "label_agreement": agree,
        "max_abs_logit_diff": logit_err,
        "device": profiled_device_ms(lambda: predictor.predict_step(inputs[0])),
        "chunk": sa1_share(predictor.model, torch.from_numpy(inputs[0][:CHUNK]).to(DEVICE)),
        "card": card,
    }
    emit(row)
    return launches


def predict_windows_phase(cfg: Config, requests: int, batch: int, seed: int, card: str, arch: str = "ssg") -> dict:
    """The calibrated-window predict path: ``Predictor(bq_window, fp_window)``
    through ``predict_step_checked``, against the no-window kernel path on the
    same requests, timed in turns; and a too-small window that must say so."""
    sd = seeded_state(cfg, seed, arch)
    windowed = Predictor(cfg, sd, infer_chunk=CHUNK, device=DEVICE, bq_window=BQ_WINDOW, fp_window=FP_WINDOW,
                         arch=arch)
    exact = Predictor(cfg, sd, infer_chunk=CHUNK, device=DEVICE, arch=arch)
    inputs = [clouds(batch, cfg, seed + 1 + i) for i in range(requests)]
    windowed.predict_step_checked(inputs[0])  # warm-up
    exact.predict_step(inputs[0])
    torch.cuda.synchronize()

    cuda.reset_launches()
    labels, oks, times = [], [], []
    for x in inputs:
        t0 = time.perf_counter()
        got, ok = windowed.predict_step_checked(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        labels.append(got)
        oks.append(ok)
    launches = dict(cuda.LAUNCHES)
    chunks = requests * (batch // CHUNK)
    _expect_launches(
        launches, scaled(chunk_launches(arch, windows=True), chunks), f"{chunks} windowed {arch} predict chunks"
    )
    if not all(oks):
        raise AssertionError(f"window certificates of the smoke requests: {oks}")

    exact_times = []
    agree = []
    for x, got in zip(inputs, labels):
        t0 = time.perf_counter()
        want = exact.predict_step(x)
        torch.cuda.synchronize()
        exact_times.append((time.perf_counter() - t0) * 1e3)
        agree.append(float((got == want).float().mean()))
    logits = windowed.infer_logits(inputs[0])
    logit_err = max_abs(logits, exact.infer_logits(inputs[0]))
    if not torch.isfinite(logits).all() or min(agree) < 0.9999 or logit_err > WINDOW_LOGIT_TOL:
        raise AssertionError(f"windowed vs exact {arch} path: label agreement {agree}, "
                             f"max abs logit diff {logit_err}")
    small = Predictor(cfg, sd, infer_chunk=CHUNK, device=DEVICE, bq_window=SMALL_BQ_WINDOW, arch=arch)
    if small.predict_step_checked(inputs[0])[1]:
        raise AssertionError(f"bq_window={SMALL_BQ_WINDOW} certified SA1 on the smoke clouds")

    median, exact_median = statistics.median(times), statistics.median(exact_times)
    emit({
        "phase": "predict_windows" if arch == "ssg" else f"predict_windows_{arch}",
        "arch": arch,
        "bq_window": BQ_WINDOW,
        "fp_window": FP_WINDOW,
        "requests": requests,
        "batch": batch,
        "ms_per_request": times,
        "median_ms": median,
        "points_per_s": batch * cfg.num_point / (median / 1e3),
        "exact_ms_per_request": exact_times,
        "exact_median_ms": exact_median,
        "window_ok": oks,
        "launches": launches,
        "label_agreement": agree,
        "max_abs_logit_diff": logit_err,
        "card": card,
    })
    return launches


def train_windows_phase(cfg: Config, seed: int, card: str, arch: str = "ssg") -> dict:
    """The calibrated-window train path: ``Trainer(bq_window, fp_window)``, one
    warm-up and 3 Adam steps beside the no-window Trainer on the same batches,
    then one dropout-free step against the no-window step, and the windows
    that ``auto`` would pick on these clouds."""
    batches = [train_batch(cfg, BATCH, seed + 300 + i) for i in range(1 + WINDOW_TRAIN_STEPS)]
    windowed = Trainer(cfg, device=DEVICE, bq_window=BQ_WINDOW, fp_window=FP_WINDOW, arch=arch)
    exact = Trainer(cfg, device=DEVICE, arch=arch)
    for trainer in (windowed, exact):
        trainer.init_state(seed, bn_stats="random")
        trainer.train_step(batches[0], generator=torch.Generator(device=DEVICE).manual_seed(seed))
    torch.cuda.synchronize()

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    times, exact_times, oks, per_step = [], [], [], []
    for batch in batches[1:]:
        cuda.reset_launches()
        t0 = time.perf_counter()
        metrics = windowed.train_step(batch, generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append(dict(cuda.LAUNCHES))
        oks.append(bool(metrics["window_ok"]))
        if not np.isfinite(float(metrics["loss"])):
            raise AssertionError("windowed train loss not finite")
        t0 = time.perf_counter()
        exact.train_step(batch, generator=gen)
        torch.cuda.synchronize()
        exact_times.append((time.perf_counter() - t0) * 1e3)
    # Train mode groups through the windowed ball query (row 7) and the raw
    # gather: SA1 engages the window, SA2-4 (clouds of 1024 and fewer) take the
    # exact kernel; FP4 engages the 3-NN window, FP1-3 take the exact kernel.
    for launches in per_step:
        _expect_launches(launches, step_launches(arch, windows=True), f"one windowed {arch} train step")
    if not all(oks):
        raise AssertionError(f"window_ok of the windowed train steps: {oks}")
    launches = {name: sum(step.get(name, 0) for step in per_step) for name in KERNELS}
    del windowed, exact

    windowed_vs_exact = _compare_steps(
        f"windowed vs exact {arch} step",
        _one_step(cfg, None, batches[0], seed, bq_window=BQ_WINDOW, fp_window=FP_WINDOW, arch=arch),
        _one_step(cfg, None, batches[0], seed, arch=arch),
    )

    sample = iter(clouds(BATCH, cfg, seed + 400 + i) for i in range(2))
    auto = calibrate_model_windows(
        [(spec.npoint, spec.radius) for spec in cfg.sa_layers], cfg.num_point, lambda: next(sample),
        num_batches=2, device=DEVICE,
    )
    median, exact_median = statistics.median(times), statistics.median(exact_times)
    emit({
        "phase": "train_windows" if arch == "ssg" else f"train_windows_{arch}",
        "arch": arch,
        "bq_window": BQ_WINDOW,
        "fp_window": FP_WINDOW,
        "steps": WINDOW_TRAIN_STEPS,
        "batch": BATCH,
        "ms_per_step": times,
        "median_ms": median,
        "points_per_s": BATCH * cfg.num_point / (median / 1e3),
        "exact_ms_per_step": exact_times,
        "exact_median_ms": exact_median,
        "window_ok": oks,
        "launches": launches,
        "windowed_vs_exact": windowed_vs_exact,
        "auto_windows": {"bq_window": auto[0], "fp_window": auto[1]},
        "card": card,
    })
    return launches


def profiled_device_ms(fn, tries: int = 3):
    """Device ms of one call of ``fn``: the profiler's kernel durations summed
    (``predict_profile.summarise``). A session that records no kernel (the
    card's tracer drops one now and then) is run again; None if all do."""
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        summary = predict_profile.summarise(prof, wall_ms)
        if summary["device_ms"] > 0:
            return {key: summary[key] for key in ("device_ms", "device_busy_share", "device_ms_by_category")}
    return None


def predict_bf16_phase(
    cfg: Config, requests: int, batch: int, seed: int, card: str, arch: str = "ssg", modes=BF16_MODES
) -> dict:
    """The bf16 inference mode of the ``arch`` model: ``Predictor(dtype=
    "bfloat16")`` in each of ``modes`` (uniform and selective
    (``bf16_min_width=128``), exact and with the windows), on the predict
    phase's requests. Each mode's kernel path is held against its
    plain path (``impl="torch"``, the same mode) with the float32 gates, its
    launches counted exactly; its labels' agreement with the float32 kernel
    path, and ms a request on the host's clock and on the device's, beside
    the float32 path's. Returns each mode's launch counts."""
    sd = seeded_state(cfg, seed, arch)
    inputs = [clouds(batch, cfg, seed + 1 + i) for i in range(requests)]
    chunks = requests * (batch // CHUNK)

    def timed(step):
        step(inputs[0])  # warm-up: first launches, allocator, cuBLAS's bfloat16 kernels
        torch.cuda.synchronize()
        cuda.reset_launches()
        out, times = [], []
        for x in inputs:
            t0 = time.perf_counter()
            out.append(step(x))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return out, times, dict(cuda.LAUNCHES)

    f32 = Predictor(cfg, sd, infer_chunk=CHUNK, device=DEVICE, arch=arch)
    f32_labels, f32_times, _ = timed(f32.predict_step)
    rows = {"f32": {"ms_per_request": f32_times, "median_ms": statistics.median(f32_times),
                    "device": profiled_device_ms(lambda: f32.predict_step(inputs[0]))}}
    paths = {}
    prefix = "predict_bf16" if arch == "ssg" else f"predict_{arch}_bf16"
    for name, mode in modes:
        predictor = Predictor(cfg, sd, infer_chunk=CHUNK, device=DEVICE, arch=arch, **mode)
        windows = "bq_window" in mode
        step = predictor.predict_step_checked if windows else predictor.predict_step
        got, times, launches = timed(step)
        labels = [g[0] for g in got] if windows else got
        if windows and not all(ok for _, ok in got):
            raise AssertionError(f"bf16 {name}: window certificates {[ok for _, ok in got]}")
        _expect_launches(
            launches, scaled(chunk_launches(arch, windows, bf16=True), chunks), f"{arch} bf16 {name}: {chunks} predict chunks"
        )
        plain = Predictor(cfg, sd, infer_chunk=CHUNK, device=DEVICE, impl="torch", arch=arch, **mode)
        agree, logit_err = [], 0.0
        for x, got_labels in zip(inputs, labels):
            logits, ref = predictor.infer_logits(x), plain.infer_logits(x)
            if logits.shape != (batch, cfg.num_point, 9) or logits.dtype != torch.float32 or not torch.isfinite(logits).all():
                raise AssertionError(f"bf16 {name}: bad logits {tuple(logits.shape)} {logits.dtype}")
            logit_err = max(logit_err, max_abs(logits, ref))
            agree.append(float((got_labels == ref.argmax(-1).to(torch.int32)).float().mean()))
        if min(agree) < 0.9999 or logit_err > 1e-3:
            raise AssertionError(f"{arch} bf16 {name} kernel path vs plain path: label agreement {agree}, "
                                 f"max abs logit diff {logit_err}")
        rows[name] = {
            **{k: v for k, v in mode.items() if k != "dtype"},
            "ms_per_request": times,
            "median_ms": statistics.median(times),
            "points_per_s": batch * cfg.num_point / (statistics.median(times) / 1e3),
            "device": profiled_device_ms(lambda: step(inputs[0])),
            "label_agreement_with_plain": agree,
            "max_abs_logit_diff": logit_err,
            "label_agreement_with_f32": [float((a == b).float().mean()) for a, b in zip(labels, f32_labels)],
            "launches": launches,
        }
        paths[f"{prefix}_{name}"] = launches
        del predictor, plain
        torch.cuda.empty_cache()
    emit({"phase": prefix, "arch": arch, "requests": requests, "batch": batch, "infer_chunk": CHUNK, **rows,
          "card": card})
    return paths


def train_bf16_phase(
    cfg: Config, seed: int, card: str, f32_row: dict, arch: str = "ssg", steps: int = TRAIN_STEPS
) -> dict:
    """The mixed-precision train mode of the ``arch`` model,
    ``Trainer(train_dtype="bfloat16", bf16_min_width=128)``: one warm-up and
    ``steps`` Adam steps (dropout on) on the train phase's batches, finite
    losses, float32 master weights and gradients, exact launch counts; then
    two dropout-free kernel-path steps equal to each other and to the plain
    path's within the train phase's gates, under deterministic algorithms. ms
    a step and peak memory beside the float32 train phase's (``f32_row``)."""
    mode = dict(train_dtype="bfloat16", bf16_min_width=BF16_MIN_WIDTH, arch=arch)
    batches = [train_batch(cfg, BATCH, seed + 200 + i) for i in range(1 + steps)]
    trainer = Trainer(cfg, device=DEVICE, **mode)
    trainer.init_state(seed, bn_stats="random")
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    trainer.train_step(batches[0], generator=gen)
    torch.cuda.synchronize()
    cuda.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for batch in batches[1:]:
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch, generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    launches = dict(cuda.LAUNCHES)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    _expect_launches(launches, scaled(step_launches(arch, bf16=True), steps), f"{steps} {arch} bf16 train steps")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"bf16 train losses not finite: {losses}")
    if any(p.dtype != torch.float32 or p.grad is None or p.grad.dtype != torch.float32
           for p in trainer.model.parameters()):
        raise AssertionError("bf16 training: a master weight or its gradient is not float32")
    del trainer
    step = _one_step(cfg, None, batches[0], seed, **mode)
    again = _one_step(cfg, None, batches[0], seed, **mode)
    if again[0] != step[0] or not all(torch.equal(g, step[1][k]) for k, g in again[1].items()):
        raise AssertionError(f"two {arch} bf16 kernel-path steps from the same weights and batch gave other gradients")
    kernel_vs_plain = _compare_steps(
        f"{arch} bf16 kernel path vs plain path", step, _one_step(cfg, "torch", batches[0], seed, **mode)
    )
    median = statistics.median(times)
    emit({
        "phase": "train_bf16" if arch == "ssg" else f"train_{arch}_bf16",
        **mode,
        "steps": steps,
        "batch": BATCH,
        "ms_per_step": times,
        "median_ms": median,
        "points_per_s": BATCH * cfg.num_point / (median / 1e3),
        "f32_median_ms": f32_row["median_ms"],
        "losses": losses,
        "f32_losses": f32_row["losses"],
        "launches": launches,
        "peak_memory_mb": peak_mb,
        "f32_peak_memory_mb": f32_row["peak_memory_mb"],
        "kernel_vs_plain": kernel_vs_plain,
        "card": card,
    })
    return launches


# -- phase 5d: the SA tails ----------------------------------------------------

SA_TAILS_STEPS = 3  # timed train steps of each layout, in turns
SA_TAILS_REQUESTS = 2  # timed 16-cloud requests of each layout, in turns
MODE_TOL = 1e-4  # an SA option's kernel path against its plain path, of the plain output's max abs
CALIBRATE_BATCHES = 1  # of CHUNK clouds: the FP oracle takes some 0.4 s a cloud on the host
# The SA options held at SA1's shape, each in both layouts: (name, SetAbstraction keywords).
SA_MODES = (
    ("avg", dict(pooling="avg")),
    ("weighted_avg", dict(pooling="weighted_avg")),
    ("max_and_avg", dict(pooling="max_and_avg")),
    ("mlp2", dict(mlp2=[64, 32])),
    ("no_xyz", dict(use_xyz=False)),
    ("no_bn", dict(use_bn=False)),
)


def plain_layout_state(cfg: Config, seed: int) -> tuple[dict, dict]:
    """The seeded weights of ``seeded_state`` in the plain SA layout (carried
    through the reference's TF names, ``flax_to_tf_vars`` then
    ``tf_vars_to_flax(pre_project=False)``) and in the pre-projected one."""
    tree = convert.init_variables(cfg, num_classes=9, seed=seed, bn_stats="random")
    plain = convert.tf_vars_to_flax(convert.flax_to_tf_vars(tree), pre_project=False)
    return convert.from_flax_variables(plain), convert.from_flax_variables(tree)


def _seeded_module(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """``module`` on the card in eval mode, with seeded parameters (kernels
    N(0, 1/fan_in)) and moving statistics that do real work."""
    rng = np.random.RandomState(seed)
    state = {}
    for name, t in module.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "var":
            value = rng.uniform(0.5, 2.0, t.shape)
        elif leaf == "scale":
            value = rng.uniform(0.5, 1.5, t.shape)
        elif t.dim() == 1:  # biases and means
            value = rng.normal(0.0, 0.1, t.shape)
        else:  # nn.Linear's weight is (out, in), w0 (in, out)
            value = rng.normal(0.0, 1.0 / np.sqrt(t.shape[1] if leaf == "weight" else t.shape[0]), t.shape)
        state[name] = torch.tensor(value, dtype=torch.float32)
    module.load_state_dict(state)
    return module.to(DEVICE).eval()


def _kernel_vs_plain(what: str, module: SetAbstraction, xyz: torch.Tensor, points: Optional[torch.Tensor],
                     seed: int) -> dict:
    """``module``'s eval forward on the kernels against the same module on the
    plain versions: centroids and indices equal, features within ``MODE_TOL``
    of the plain output's max abs, or raise."""
    kernel = _seeded_module(module, seed)
    plain = copy.deepcopy(kernel)
    plain.ops_impl = "torch"
    with torch.no_grad():
        got, want = kernel(xyz, points), plain(xyz, points)
    err = max_abs(got[1], want[1]) / max(float(want[1].abs().max()), 1e-30)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])) or not err <= MODE_TOL:
        raise AssertionError(f"{what}: the kernel path and the plain path disagree (feature error {err} of max abs)")
    if not torch.isfinite(got[1]).all() or got[1].shape[-1] != module.out_features:
        raise AssertionError(f"{what}: features of shape {tuple(got[1].shape)}, finite {bool(torch.isfinite(got[1]).all())}")
    return {"err_of_max_abs": err, "shape": list(got[1].shape)}


def _knn_grouping(model: torch.nn.Module) -> None:
    """Every SA level of ``model`` groups the nsample nearest points in place of its ball."""
    for i in range(4):
        getattr(model, f"sa{i + 1}").use_knn = True


def _in_turns(fns: dict, rounds: int) -> dict:
    """Host ms of each call of ``fns`` (name -> call ending in a synchronise),
    ``rounds`` times in the turns a, b, b, a."""
    times = {name: [] for name in fns}
    order = list(fns)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            fns[name]()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return times


def _html_payload(html: str, kind: str) -> bytes:
    """The base64 array the viewer's page decodes as ``kind`` (Float32Array or Uint8Array)."""
    end = html.index(f'", {kind})')
    return base64.b64decode(html[html.rindex('decode("', 0, end) + len('decode("'):end])


def sa_tails_phase(cfg: Config, seed: int, card: str, report: Report) -> dict:
    """The last modules of the port on the card: (a) ``PointNet2SemSeg(
    pre_project=False)``, the reference's plain SA layout, at full width; (b)
    kNN grouping at SA1-SA4's shapes (row 3's list route, k = 32) and a train
    step of a model that groups so; (c) the other SA options at SA1's shape;
    (d) the window-calibration tool; (e) the colorize CLI and the HTML
    viewer. Returns the launch counts of (a)'s eval chunk, timed train steps
    and windowed chunk, (b)'s train step and (d)'s run."""
    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    plain_sd, pre_sd = plain_layout_state(cfg, seed)
    paths, row = {}, {"phase": "sa_tails"}

    # (a) The plain layout: one eval chunk against its plain path and against
    # the pre-projected model on the same weights.
    x = clouds(CHUNK, cfg, seed + 1)
    layouts = {
        "plain": Predictor(cfg, plain_sd, infer_chunk=CHUNK, device=DEVICE, pre_project=False),
        "plain_torch": Predictor(cfg, plain_sd, infer_chunk=CHUNK, device=DEVICE, impl="torch", pre_project=False),
        "pre_projected": Predictor(cfg, pre_sd, infer_chunk=CHUNK, device=DEVICE),
    }
    layouts["plain"].infer_logits(x)  # warm-up
    torch.cuda.synchronize()
    cuda.reset_launches()
    logits = layouts["plain"].infer_logits(x)
    torch.cuda.synchronize()
    paths["sa_tails_eval"] = dict(cuda.LAUNCHES)
    _expect_launches(paths["sa_tails_eval"], chunk_launches(), "plain-layout eval chunk")
    if logits.shape != (CHUNK, cfg.num_point, 9) or not torch.isfinite(logits).all():
        raise AssertionError(f"plain layout: bad logits, shape {tuple(logits.shape)}")
    eval_gates = {}
    for ref in ("plain_torch", "pre_projected"):
        ref_logits = layouts[ref].infer_logits(x)
        agree = float((logits.argmax(-1) == ref_logits.argmax(-1)).float().mean())
        err = max_abs(logits, ref_logits)
        if agree < 0.9999 or err > 1e-3:
            raise AssertionError(f"plain layout vs {ref}: label agreement {agree}, max abs logit diff {err}")
        eval_gates[ref] = {"label_agreement": agree, "max_abs_logit_diff": err}
    requests = [clouds(BATCH, cfg, seed + 2 + i) for i in range(SA_TAILS_REQUESTS)]
    request_ms = _in_turns(
        {name: (lambda p=layouts[name]: [p.predict_step(r) for r in requests]) for name in ("plain", "pre_projected")},
        2,
    )
    row["eval"] = {**eval_gates, "ms_per_request": {
        name: [ms / SA_TAILS_REQUESTS for ms in times] for name, times in request_ms.items()
    }}

    # The plain layout's windowed chunk: certificates and the exact path's logits.
    windowed = Predictor(cfg, plain_sd, infer_chunk=CHUNK, device=DEVICE, bq_window=BQ_WINDOW, fp_window=FP_WINDOW,
                         pre_project=False)
    windowed.infer_logits(x)  # warm-up
    torch.cuda.synchronize()
    cuda.reset_launches()
    certificates: list = []
    win_logits = windowed.infer_logits(x, certificates)
    torch.cuda.synchronize()
    paths["sa_tails_windows"] = dict(cuda.LAUNCHES)
    _expect_launches(
        paths["sa_tails_windows"],
        {name: n for name, n in step_launches(windows=True).items() if name != "three_interpolate_grad"},
        "plain-layout windowed eval chunk",
    )
    names = [name for name, _ in certificates]
    held = [bool(ok) for _, ok in certificates]
    win_err = max_abs(win_logits, logits)
    if names != ["bq_window_ok"] * 4 + ["fp_window_ok"] * 4 or not all(held) or win_err > WINDOW_LOGIT_TOL:
        raise AssertionError(f"plain-layout windows: certificates {list(zip(names, held))}, logit diff {win_err}")
    row["windows"] = {"bq_window": BQ_WINDOW, "fp_window": FP_WINDOW, "certificates": held,
                      "max_abs_logit_diff_vs_exact": win_err}
    del layouts, windowed

    # The plain layout's train step: kernel path against plain path, then
    # timed steps beside the pre-projected model's, in turns.
    batches = [train_batch(cfg, BATCH, seed + 200 + i) for i in range(1 + SA_TAILS_STEPS)]
    step = _one_step(cfg, None, batches[0], seed, pre_project=False)
    if not np.isfinite(step[0]):
        raise AssertionError(f"plain-layout train loss not finite: {step[0]}")
    train_gates = _compare_steps("plain layout kernel path vs plain path", step,
                                 _one_step(cfg, "torch", batches[0], seed, pre_project=False))
    del step
    trainers = {name: Trainer(cfg, device=DEVICE, pre_project=name == "pre_projected")
                for name in ("plain", "pre_projected")}
    for trainer in trainers.values():
        trainer.init_state(seed, bn_stats="random")
        trainer.train_step(batches[0])  # warm-up
    torch.cuda.synchronize()
    cuda.reset_launches()
    plain_losses = [float(trainers["plain"].train_step(b)["loss"]) for b in batches[1:]]
    torch.cuda.synchronize()
    paths["sa_tails_train"] = dict(cuda.LAUNCHES)
    _expect_launches(paths["sa_tails_train"], scaled(step_launches(), SA_TAILS_STEPS),
                     f"{SA_TAILS_STEPS} plain-layout train steps")
    if not all(np.isfinite(plain_losses)):
        raise AssertionError(f"plain-layout train losses not finite: {plain_losses}")
    step_ms = _in_turns(
        {name: (lambda t=trainer: t.train_step(batches[1])) for name, trainer in trainers.items()}, SA_TAILS_STEPS + 1
    )
    row["train"] = {**train_gates, "losses": plain_losses, "ms_per_step": step_ms}
    del trainers
    torch.cuda.empty_cache()

    # (b) kNN grouping at SA1-SA4's shapes (B=16, k = nsample = 32: the list route).
    xb = torch.from_numpy(clouds(BATCH, cfg, seed + 700)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 700)
    xyzs, feats = [xb[..., :3].contiguous()], [xb[..., 3:6]]
    widths = [3] + [mlp[-1] for mlp in SA_MLPS]
    sms = cuda_ballquery.num_sms(dev.index or 0)
    knn_levels = []
    for i, (spec, mlp) in enumerate(zip(cfg.sa_layers, SA_MLPS)):
        src, k = xyzs[-1], spec.nsample
        module = SetAbstraction(spec.npoint, spec.radius, k, mlp, widths[i], use_knn=True, leaf_inputs=i == 0)
        level = _kernel_vs_plain(f"SA{i + 1} kNN grouping", module, src, feats[-1], seed + 710 + i)
        cent = ops.fps_centroids(src, spec.npoint, impl="cuda")[1].contiguous()
        got, want = cuda.knn(src, cent, k), core.knn(src, cent, k)
        b, n, m = src.shape[0], src.shape[1], cent.shape[1]
        report.add(
            "knn", b, f"SA{i + 1} kNN grouping Nq={m} M={n} k={k}",
            lambda src=src, cent=cent, k=k: cuda.knn(src, cent, k),
            lambda src=src, cent=cent, k=k: core.knn(src, cent, k),
            *op_bench.work_knn(b, m, n, k), err=max_abs(got[0], want[0]),
            match=torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            info={"plan": cuda_knn.plan(b, m, n, k, sms), "case": "sa_knn"}, plain_timing=FEW,
        )
        knn_levels.append({**level, "kernel_ms": report.rows[-1]["kernel_ms"], "plan": report.rows[-1]["plan"]})
        xyzs.append(cent)
        feats.append(torch.rand((b, m, mlp[-1]), generator=gen, device=dev))
    # The hoisted geometry is the ball query's: the kNN-grouped model groups on its own.
    knn_options = dict(prepare=_knn_grouping, hoist_geometry=False)
    cuda.reset_launches()
    knn_step = _one_step(cfg, None, batches[0], seed, **knn_options)
    paths["sa_tails_knn_train"] = dict(cuda.LAUNCHES)
    if not np.isfinite(knn_step[0]):
        raise AssertionError(f"kNN-grouping train loss not finite: {knn_step[0]}")
    _expect_launches(paths["sa_tails_knn_train"], {**step_launches(), "ball_query": 0, "knn": 8},
                     "kNN-grouping train step")
    knn_gates = _compare_steps("kNN grouping kernel path vs plain path", knn_step,
                               _one_step(cfg, "torch", batches[0], seed, **knn_options))
    row["knn"] = {"levels": knn_levels, "sa1_list_route_ms": knn_levels[0]["kernel_ms"], "train_step": knn_gates}
    del knn_step

    # (c) The other options at SA1's shape, each in both layouts, and group_all at SA4's input.
    spec, mlp = cfg.sa_layers[0], SA_MLPS[0]
    modes = {}
    for name, options in SA_MODES:
        for pre_project in (True, False):
            module = SetAbstraction(spec.npoint, spec.radius, spec.nsample, mlp, 3, pre_project=pre_project, **options)
            layout = "pre_projected" if pre_project else "plain"
            modes[f"{name}_{layout}"] = _kernel_vs_plain(f"SA1 {name} ({layout})", module, xyzs[0], feats[0],
                                                         seed + 720)
    modes["group_all"] = _kernel_vs_plain(
        "group_all at SA4's input", SetAbstraction(1, 0.0, xyzs[3].shape[1], SA_MLPS[3], widths[3], group_all=True),
        xyzs[3], feats[3], seed + 730,
    )
    row["modes"] = modes
    del xb, xyzs, feats
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_sa_tails_") as tmp:
        tmp = pathlib.Path(tmp)
        (tmp / "scenes").mkdir()
        scenes.fabricate(tmp / "scenes", seed)
        # (d) The calibration tool through its entry point, against its plain version.
        cfg_path = _cli_config(tmp, "calibrate", tmp / "scenes")
        argv = ["--data_path", str(tmp / "scenes"), "--config_file", str(cfg_path),
                "--num_batches", str(CALIBRATE_BATCHES), "--batch_size", str(CHUNK)]
        cuda.reset_launches()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            tool = calibrate_cli.main(argv)
        paths["sa_tails_calibrate"] = dict(cuda.LAUNCHES)
        _expect_launches(paths["sa_tails_calibrate"], {"fps_centroids": 4 * CALIBRATE_BATCHES}, "calibration tool")
        flags = calibrate_cli.build_parser().parse_args(argv)
        tool_cfg = Config.from_json(cfg_path)
        spans, fp_spans = calibrate_cli.level_spans(flags, tool_cfg, dev, impl="torch")
        want = calibrate_cli.windows(spans, fp_spans, tool_cfg, flags.margin)
        if (tool["bq_window"], tool["fp_window"]) != want or (tool["spans"], tool["fp_spans"]) != (spans, fp_spans):
            raise AssertionError(f"calibration tool: windows {tool['bq_window'], tool['fp_window']} and spans "
                                 f"{tool['spans'], tool['fp_spans']}, its plain version {want}, {spans, fp_spans}")
        row["calibrate"] = {"bq_window": tool["bq_window"], "fp_window": tool["fp_window"],
                            "table": printed.getvalue().splitlines()}

        # (e) The file tools on this host: colorize's files and the viewer's page.
        prefix = validation_file_prefixes[0]
        cloud = read_pcd(tmp / "scenes" / f"{prefix}.pcd")
        labels = load_labels(tmp / "scenes" / f"{prefix}.labels")
        (tmp / "sparse").mkdir()
        write_pcd(tmp / "sparse" / f"{prefix}.pcd", cloud.points)
        write_labels(tmp / "sparse" / f"{prefix}.labels", labels)
        with contextlib.redirect_stdout(io.StringIO()):
            colored = cli_colorize.main(["--input_dir", str(tmp / "sparse"), "--output_dir", str(tmp / "colored")])
        colors = colorize_point_cloud(cloud.points, labels)
        write_pcd(tmp / "plain_colored.pcd", cloud.points, colors)
        if [pathlib.Path(p).name for p in colored] != [f"{prefix}_colored.pcd"] or (
            pathlib.Path(colored[0]).read_bytes() != (tmp / "plain_colored.pcd").read_bytes()
        ):
            raise AssertionError(f"cli.colorize wrote {colored}, not the plain path's file")
        html = [pathlib.Path(write_html_viewer(cloud.points, colors, tmp / f"{i}.html", title=prefix)).read_text()
                for i in range(2)]
        shown = (np.frombuffer(_html_payload(html[0], "Float32Array"), np.float32),
                 np.frombuffer(_html_payload(html[0], "Uint8Array"), np.uint8))
        if html[0] != html[1] or not np.array_equal(shown[0], cloud.points.astype(np.float32).ravel()) or (
            not np.array_equal(shown[1], np.clip(np.round(colors * 255.0), 0, 255).astype(np.uint8).ravel())
        ):
            raise AssertionError("write_html_viewer: the page does not hold the cloud and its colours")
        row["files"] = {"colorize": pathlib.Path(colored[0]).name, "points": len(cloud.points),
                        "html_bytes": len(html[0])}

    row.update({"launches": paths, "phase_seconds": time.perf_counter() - t0, "card": card})
    emit(row)
    return paths


def _cli_train(cfg_path: pathlib.Path, seed: int, windows: list, precision: tuple = (), arch: str = "ssg",
               resume: Optional[pathlib.Path] = None) -> dict:
    """One run of the train CLI on the card (``--arch arch``), its launch counts
    reset just before it and read just after, held to the counts its steps and
    eval chunks imply; then every checkpoint it wrote restored into a fresh
    Trainer of that arch. ``precision``: ``--train_dtype bfloat16`` and its
    ``--bf16_min_width``, whose steps launch rows 4 and 5's bfloat16 instances
    (the eval chunks stay float32). ``resume``: a checkpoint at step 0 that
    the run continues from (``--resume``)."""
    torch.cuda.synchronize()
    cuda.reset_launches()
    t0 = time.perf_counter()
    summary = cli_train.main(
        ["--config_file", str(cfg_path), "--seed", str(seed), "--arch", arch, *windows, *precision,
         *(["--resume", str(resume)] if resume else [])]
    )
    seconds = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    (epoch,) = summary["epochs"]
    steps, chunks = epoch["train_batches"], epoch["val_batches"] * (BATCH // CHUNK)
    if steps < 1 or chunks < 1 or summary["step"] != steps:
        raise AssertionError(f"the train CLI ran {steps} steps and {chunks} eval chunks (step {summary['step']})")
    if resume and f"resumed from {resume} at step 0" not in (pathlib.Path(Config.from_json(cfg_path).logdir)
                                                               / "log_train.txt").read_text():
        raise AssertionError(f"the train CLI did not resume from {resume} at step 0")
    # A bf16 run's eval chunks stay float32.
    step, chunk = step_launches(arch, bool(windows), bool(precision)), chunk_launches(arch, bool(windows))
    _expect_launches(
        launches, {name: steps * step.get(name, 0) + chunks * chunk.get(name, 0) for name in KERNELS},
        f"the {arch} train CLI{' with windows' if windows else ''}: {steps} steps, {chunks} eval chunks",
    )
    cfg = Config.from_json(cfg_path)
    names = sorted({pathlib.Path(path).name for path in summary["checkpoints"]})
    if not {"model.pt", "model_autosave.pt"} <= set(names):
        raise AssertionError(f"the train CLI wrote {names}")
    states = []
    for name in names:
        trainer = Trainer(cfg, device=DEVICE, bq_window=summary["bq_window"], fp_window=summary["fp_window"], arch=arch)
        restore_checkpoint(pathlib.Path(cfg.logdir) / name, trainer)
        if trainer.step != steps or not trainer.optimizer.state:
            raise AssertionError(f"{name} restored at step {trainer.step} without its optimizer state")
        if any(v.dtype != torch.float32 for v in trainer.model.state_dict().values()):
            raise AssertionError(f"{name} holds weights that are not float32")
        states.append(trainer.model.state_dict())
        del trainer
    if not all(torch.equal(state[k], v) for state in states[1:] for k, v in states[0].items()):
        raise AssertionError(f"the checkpoints of one epoch hold different weights: {names}")
    return {
        "steps": steps,
        "eval_chunks": chunks,
        "step_ms": epoch["step_ms"],
        "median_step_ms": statistics.median(epoch["step_ms"][1:]),
        "prefetch_wait_ms": epoch["prefetch_wait_ms"],
        "median_prefetch_wait_ms": statistics.median(epoch["prefetch_wait_ms"][1:]),
        "seconds": seconds,
        "checkpoints_restored": names,
        "launches": launches,
    }


def _plain_labels(cfg: Config, ckpt: pathlib.Path, out_dir: pathlib.Path, **mode) -> dict:
    """The predict CLI's files against the plain path on the card: a
    ``Predictor(impl="torch")`` in the CLI's precision ``mode`` fed the samples
    the CLI drew, drawn again from a fresh ``SemanticDataset(seed=0)`` after
    ``np.random.seed(0)``. The ``.pcd`` points must equal the samples bit for
    bit, and the labels agree on >= 99.99 % of points."""
    plain = Predictor(cfg, load_model_state(ckpt), infer_chunk=CHUNK, device=DEVICE, impl="torch", **mode)
    np.random.seed(0)
    dataset = SemanticDataset(cfg.num_point, "validation", bool(cfg.use_color), cfg.box_size_x, cfg.box_size_y,
                              cfg.data_path, seed=0)
    agree = total = 0
    for fd in dataset.list_file_data:
        prefix = pathlib.Path(fd.file_path_without_ext).name
        raws, labels = [], []
        for start in range(0, CLI_SAMPLES, CLI_PREDICT_BATCH):
            centered, raw, _, colors = fd.sample_batch(min(CLI_PREDICT_BATCH, CLI_SAMPLES - start), cfg.num_point)
            raws.append(raw.reshape(-1, 3))
            x = np.concatenate((centered, colors), -1) if cfg.use_color else centered
            labels.append(plain.predict_step(x.astype(np.float32)).cpu().numpy().reshape(-1))
        if not np.array_equal(read_pcd(out_dir / f"{prefix}.pcd").points,
                              np.concatenate(raws).astype(np.float32).astype(np.float64)):
            raise AssertionError(f"{prefix}.pcd: the points are not the samples the CLI drew")
        written = load_labels(out_dir / f"{prefix}.labels")
        want = np.concatenate(labels)
        if written.shape != want.shape:
            raise AssertionError(f"{prefix}.labels: {written.shape} labels, want {want.shape}")
        agree += int((written == want).sum())
        total += want.size
    if agree < 0.9999 * total:
        raise AssertionError(f"the predict CLI's labels agree with the plain path on {agree} of {total} points")
    return {"label_agreement": agree / total, "points": total}


def _cli_predict(cfg_path: pathlib.Path, ckpt: pathlib.Path, out_dir: pathlib.Path, arch: str = "ssg",
                 bf16: bool = False) -> dict:
    """One run of the predict CLI on the card over the validation split
    (``CLI_SAMPLES`` a scene in batches of ``CLI_PREDICT_BATCH``, ``--arch
    arch``, ``--dtype bfloat16`` with ``bf16``), its launch counts reset just
    before it and read just after, held to ``chunk_launches`` a batch, and its
    files held to the plain path in the same mode (``_plain_labels``)."""
    mode = {**({"arch": arch} if arch != "ssg" else {}), **({"dtype": "bfloat16"} if bf16 else {})}
    torch.cuda.synchronize()
    cuda.reset_launches()
    summary = cli_predict.main([
        "--ckpt", str(ckpt), "--set", "validation", "--config_file", str(cfg_path),
        "--num_samples", str(CLI_SAMPLES), "--batch_size", str(CLI_PREDICT_BATCH), "--output_dir", str(out_dir),
        *(f"--{flag}={value}" for flag, value in mode.items()),
    ])
    launches = dict(cuda.LAUNCHES)
    batches = len(summary["batch_seconds"])
    _expect_launches(launches, scaled(chunk_launches(arch, bf16=bf16), batches),
                     f"the predict CLI {mode}: {batches} batches of {CLI_PREDICT_BATCH}")
    seconds = summary["batch_seconds"]
    return {
        **mode,
        "samples": summary["samples"],
        "batches": batches,
        "batch_seconds": seconds,
        "samples_per_s": summary["samples"] / sum(seconds),
        "samples_per_s_after_first": (summary["samples"] - CLI_PREDICT_BATCH) / sum(seconds[1:]),
        **_plain_labels(Config.from_json(cfg_path), ckpt, out_dir, **mode),
        "launches": launches,
    }


def _cli_config(tmp: pathlib.Path, name: str, data_path: pathlib.Path) -> pathlib.Path:
    """A copy of ``semantic.json`` with only ``data_path``, ``logdir`` (``tmp/name``) and ``max_epoch = 1`` changed."""
    path = tmp / f"{name}.json"
    raw_cfg = json.loads((ROOT / "semantic.json").read_text())
    path.write_text(json.dumps({**raw_cfg, "data_path": str(data_path), "logdir": str(tmp / name), "max_epoch": 1}))
    return path


def cli_phase(seed: int, card: str, train_median_ms: float) -> dict:
    """The port's entry points as a user runs them: the train CLI on
    fabricated scenes from a copy of ``semantic.json`` with only
    ``data_path``, ``logdir`` and ``max_epoch = 1`` changed, once exact and
    once with the windows, each with ``--seed``; then the predict CLI on the
    exact run's ``model.pt`` over the validation split, held against the
    plain path; the same pair in the bf16 modes and with ``--arch msg``.
    Returns each run's launch counts."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        tmp = pathlib.Path(tmp)
        (tmp / "scenes").mkdir()
        scenes.fabricate(tmp / "scenes", seed)
        runs, cfg_paths = {}, {}
        for name, windows in (("cli_train", []),
                              ("cli_train_windows", ["--bq_window", str(BQ_WINDOW), "--fp_window", str(FP_WINDOW)])):
            cfg_paths[name] = _cli_config(tmp, name, tmp / "scenes")
            runs[name] = _cli_train(cfg_paths[name], seed, windows)
            torch.cuda.empty_cache()
        predict = _cli_predict(cfg_paths["cli_train"], tmp / "cli_train" / "model.pt", tmp / "sparse")
        # The bf16 modes through the same entry points: one mixed-precision
        # train epoch, then the bf16 predict CLI on its float32 checkpoint.
        name = "cli_train_bf16"
        cfg_paths[name] = _cli_config(tmp, name, tmp / "scenes")
        runs[name] = _cli_train(cfg_paths[name], seed, [], BF16_CLI_TRAIN)
        torch.cuda.empty_cache()
        predict_bf16 = _cli_predict(cfg_paths[name], tmp / name / "model.pt", tmp / "sparse_bf16", bf16=True)
        # The MSG model through the same entry points: one exact train epoch
        # with --arch msg, then the predict CLI with --arch msg on its model.pt.
        name = "cli_train_msg"
        cfg_paths[name] = _cli_config(tmp, name, tmp / "scenes")
        runs[name] = _cli_train(cfg_paths[name], seed, [], arch="msg")
        torch.cuda.empty_cache()
        predict_msg = _cli_predict(cfg_paths[name], tmp / name / "model.pt", tmp / "sparse_msg", arch="msg")

        # The sampler alone, on this thread with no other running: what one
        # batch of the train split costs the host.
        cfg = Config.from_json(cfg_paths["cli_train"])
        train_ds = SemanticDataset(cfg.num_point, "train", bool(cfg.use_color), cfg.box_size_x, cfg.box_size_y,
                                   cfg.data_path, seed=seed)
        sampler_ms = []
        for _ in range(3):
            s = time.perf_counter()
            train_ds.sample_batch_in_all_files(cfg.batch_size, True)
            sampler_ms.append((time.perf_counter() - s) * 1e3)
    emit({
        "phase": "cli",
        "train": runs["cli_train"],
        "train_windows": {"bq_window": BQ_WINDOW, "fp_window": FP_WINDOW, **runs["cli_train_windows"]},
        "predict": predict,
        "train_bf16": {"flags": list(BF16_CLI_TRAIN), **runs["cli_train_bf16"]},
        "predict_bf16": predict_bf16,
        "train_msg": {"arch": "msg", **runs["cli_train_msg"]},
        "predict_msg": predict_msg,
        "train_phase_median_ms": train_median_ms,
        "sampler_ms_per_batch": sampler_ms,
        "phase_seconds": time.perf_counter() - t0,
        "card": card,
    })
    return {**{name: run["launches"] for name, run in runs.items()}, "cli_predict": predict["launches"],
            "cli_predict_bf16": predict_bf16["launches"], "cli_predict_msg": predict_msg["launches"]}


def _host_rate(points: int, seconds: float) -> dict:
    return {"points": points, "seconds": seconds, "mpoints_per_s": points / seconds / 1e6}


def prep_phase(seed: int, card: str, tmp: pathlib.Path) -> tuple[dict, pathlib.Path]:
    """The front of the program, as a user runs it: raw scenes
    (``tools.scenes.fabricate_raw``: the train and validation prefixes with
    labels, the test prefixes without) through ``cli.preprocess`` and
    ``cli.downsample``, each run twice (the second skips every scene); one
    train CLI epoch from the downsampled scenes and the predict CLI on its
    ``model.pt``, held as the ``cli`` phase holds them. Then one raw scene of
    ``PREP_POINTS`` (``tools.scenes.dense_scene``) through both entry points
    beside the finished others (linked in, so they are skipped): their host
    seconds and Mpoints/s. Returns the train and predict runs' launches and
    the config of the downsampled scenes."""
    t0 = time.perf_counter()
    raw, down = tmp / "raw", tmp / "downsampled"
    raw.mkdir()
    scenes.fabricate_raw(raw, seed, train_file_prefixes + validation_file_prefixes)
    scenes.fabricate_raw(raw, seed + 1, test_file_prefixes, with_labels=False)
    dirs = ["--raw_dir", str(raw), "--downsampled_dir", str(down)]
    pre = cli_preprocess.main(dirs[:2])
    ds = cli_downsample.main(dirs)
    if pre["converted"] != all_file_prefixes or ds["downsampled"] != all_file_prefixes:
        raise AssertionError(f"preprocess converted {pre['converted']}, downsample did {ds['downsampled']}")
    again = [cli_preprocess.main(dirs[:2]), cli_downsample.main(dirs)]
    if any(run["skipped"] != all_file_prefixes for run in again):
        raise AssertionError("a second run of preprocess or downsample did not skip every scene")
    for prefix, points, sparse in zip(all_file_prefixes, ds["points"], ds["sparse_points"]):
        labelled = prefix not in test_file_prefixes
        unlabelled = int((load_labels(raw / f"{prefix}.labels") == 0).sum()) if labelled else 0
        if sparse > points - unlabelled or not 0 < sparse or (down / f"{prefix}.labels").is_file() != labelled:
            raise AssertionError(f"{prefix}: {points} raw points ({unlabelled} unlabelled) downsampled to {sparse}")
        if labelled and len(load_labels(down / f"{prefix}.labels")) != sparse:
            raise AssertionError(f"{prefix}: the downsampled labels are not one a point")
    prep_seconds = time.perf_counter() - t0

    cfg_path = _cli_config(tmp, "prep_train", down)
    train = _cli_train(cfg_path, seed, [])
    torch.cuda.empty_cache()
    predict = _cli_predict(cfg_path, tmp / "prep_train" / "model.pt", tmp / "prep_sparse")
    submission, test_launches = _submission_chain(cfg_path, tmp / "prep_train" / "model.pt", raw, tmp)

    # One scan-sized scene added to the finished set: only it is converted and downsampled.
    big_raw, big_down = tmp / "big_raw", tmp / "big_downsampled"
    big_raw.mkdir()
    big_down.mkdir()
    big = validation_file_prefixes[0]
    for prefix in all_file_prefixes:
        if prefix != big:
            (big_raw / f"{prefix}.pcd").symlink_to(raw / f"{prefix}.pcd")
            (big_down / f"{prefix}.pcd").symlink_to(down / f"{prefix}.pcd")
    rng = np.random.RandomState(seed + 2)
    pts, labels = scenes.dense_scene(rng, PREP_POINTS)
    scenes.write_raw_scene(big_raw, big, pts, labels, rng)
    big_pre = cli_preprocess.main(["--raw_dir", str(big_raw)])
    big_ds = cli_downsample.main(["--raw_dir", str(big_raw), "--downsampled_dir", str(big_down)])
    if big_pre["converted"] != [big] or big_ds["downsampled"] != [big] or big_pre["points"] != [PREP_POINTS]:
        raise AssertionError(f"the added scene: preprocess {big_pre}, downsample {big_ds}")
    emit({
        "phase": "prep",
        "scenes": len(all_file_prefixes),
        "preprocess": _host_rate(sum(pre["points"]), sum(pre["seconds"])),
        "downsample": {**_host_rate(sum(ds["points"]), sum(ds["seconds"])), "sparse_points": sum(ds["sparse_points"])},
        "second_runs_skipped": [len(run["skipped"]) for run in again],
        "train": train,
        "predict": predict,
        "submission": submission,
        "scan_scene": {
            "preprocess": _host_rate(PREP_POINTS, big_pre["seconds"][0]),
            "downsample": {**_host_rate(PREP_POINTS, big_ds["seconds"][0]), "sparse_points": big_ds["sparse_points"][0],
                           "voxel_size": 0.05},
        },
        "prep_seconds": prep_seconds,
        "phase_seconds": time.perf_counter() - t0,
        "card": card,
    })
    return {"prep_train": train["launches"], "prep_predict": predict["launches"],
            "prep_predict_test": test_launches}, cfg_path


def _submission_chain(cfg_path: pathlib.Path, ckpt: pathlib.Path, raw: pathlib.Path,
                      tmp: pathlib.Path) -> tuple[dict, dict]:
    """The chain's last steps on the test split: ``cli.predict --set test``
    (its launches reset just before it and held to ``chunk_launches`` a
    batch), ``cli.interpolate --set test`` onto the raw clouds, then
    ``cli.renamer``: every test scene's dense labels must carry its
    submission name, one label a raw point, and no other file be renamed."""
    sparse, dense = tmp / "prep_sparse_test", tmp / "prep_dense_test"
    torch.cuda.synchronize()
    cuda.reset_launches()
    summary = cli_predict.main([
        "--ckpt", str(ckpt), "--set", "test", "--config_file", str(cfg_path), "--num_samples", str(CLI_SAMPLES),
        "--batch_size", str(CLI_PREDICT_BATCH), "--output_dir", str(sparse),
    ])
    launches = dict(cuda.LAUNCHES)
    batches = len(summary["batch_seconds"])
    _expect_launches(launches, scaled(chunk_launches(), batches), f"the predict CLI on the test split: {batches} batches")
    t0 = time.perf_counter()
    cli_interpolate.main(["--set", "test", "--sparse_dir", str(sparse), "--gt_dir", str(raw), "--dense_dir", str(dense)])
    interpolate_s = time.perf_counter() - t0
    renamed = cli_renamer.main(["--dense_dir", str(dense)])
    if len(renamed["moved"]) != len(test_file_prefixes):
        raise AssertionError(f"the renamer moved {len(renamed['moved'])} files of {len(test_file_prefixes)} test scenes")
    for prefix in test_file_prefixes:
        name = cli_renamer.conversion_dict[f"{prefix}.labels"]
        if (dense / f"{prefix}.labels").exists() or not (dense / name).is_file():
            raise AssertionError(f"{prefix}: its dense labels are not named {name}")
        if len(load_labels(dense / name)) != len(read_pcd(raw / f"{prefix}.pcd").points):
            raise AssertionError(f"{name}: not one label a raw point")
    return {"test_scenes": len(test_file_prefixes), "predict_batches": batches, "interpolate_seconds": interpolate_s,
            "renamed": len(renamed["moved"]), "left": len(renamed["unknown"]),
            "submission_files": sorted(pathlib.Path(dst).name for _, dst in renamed["moved"])}, launches


def convert_phase(seed: int, card: str, tmp: pathlib.Path, cfg_path: pathlib.Path) -> dict:
    """A reference TF checkpoint through the port: a seeded SSG tree
    (``convert.init_variables``, random moving statistics) written as a
    TF-named ``.npz`` (``convert.flax_to_tf_vars``), converted by
    ``tools.convert_checkpoint`` on the card (one eval chunk: rows 1-4 once
    each), its ``.pt`` holding ``from_flax_variables`` of the tree bit for
    bit at step 0 with an empty optimizer state; then the predict CLI on it,
    held to the plain path, and one train CLI epoch ``--resume``d from it at
    step 0. Returns the three runs' launches."""
    t0 = time.perf_counter()
    variables = convert.init_variables(Config.from_json(cfg_path), seed=seed + 5, bn_stats="random")
    npz, pt = tmp / "reference.npz", tmp / "converted.pt"
    tf_vars = convert.flax_to_tf_vars(variables)
    np.savez(npz, **tf_vars)
    torch.cuda.synchronize()
    cuda.reset_launches()
    converted = convert_cli.main(["--tf_ckpt", str(npz), "--out", str(pt), "--config_file", str(cfg_path)])
    launches = dict(cuda.LAUNCHES)
    seconds = time.perf_counter() - t0
    _expect_launches(launches, chunk_launches(), "tools.convert_checkpoint's shape check: one eval chunk")
    ckpt = torch.load(pt, map_location="cpu", weights_only=True)
    want = convert.from_flax_variables(variables)
    if ckpt["step"] != 0 or ckpt["optimizer"]["state"] or set(ckpt["model"]) != set(want) or not all(
            torch.equal(ckpt["model"][k], v) for k, v in want.items()):
        raise AssertionError("the converted checkpoint is not the tree's state_dict at step 0")
    predict = _cli_predict(cfg_path, pt, tmp / "convert_sparse")
    torch.cuda.empty_cache()
    resume = _cli_train(_cli_config(tmp, "convert_resume", Config.from_json(cfg_path).data_path), seed, [],
                        resume=pt)
    emit({
        "phase": "convert",
        "tf_variables": len(tf_vars),
        "tensors": converted["tensors"],
        "state_bit_equal": True,
        "convert_seconds": converted["convert_seconds"],
        "forward_seconds": converted["forward_seconds"],
        "seconds": seconds,
        "launches": launches,
        "predict": predict,
        "resume": resume,
        "phase_seconds": time.perf_counter() - t0,
        "card": card,
    })
    return {"convert": launches, "convert_predict": predict["launches"], "convert_resume": resume["launches"]}


def chunked_plain_knn(xyz1: torch.Tensor, xyz2: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``ops.core.knn`` over the queries in chunks, as the densify engine's plain
    version takes them: the plain kNN at shapes whose (Nq, M) matrix would not fit."""
    step = densify.device_chunk(k, xyz1.shape[1], kernel=False)
    parts = [core.knn(xyz1, xyz2[:, s : s + step], k) for s in range(0, xyz2.shape[1], step)]
    return torch.cat([d for d, _ in parts], 1), torch.cat([i for _, i in parts], 1)


def densify_knn_row(report: Report, label: str, sparse: torch.Tensor, queries: torch.Tensor) -> None:
    """Row 3 at a densify shape (one cloud, k = 3) against its chunked plain
    version, with the planned route and the device time; the plain version
    timed with 3 single calls."""
    sparse, queries = sparse[None].contiguous(), queries[None].contiguous()
    (m, nq), k = (sparse.shape[1], queries.shape[1]), 3
    d2, idx = ops.knn(sparse, queries, k, impl="cuda")
    p_d2, p_idx = chunked_plain_knn(sparse, queries, k)
    report.add(
        "knn", 1, f"{label} Nq={nq} M={m} k={k}",
        lambda: ops.knn(sparse, queries, k, impl="cuda"),
        lambda: chunked_plain_knn(sparse, queries, k),
        *op_bench.work_knn(1, nq, m, k),
        err=max_abs(d2, p_d2),
        match=torch.equal(idx, p_idx) and torch.equal(d2, p_d2),
        plain_timing=FEW,
        info={"plan": cuda_knn.plan(1, nq, m, k, cuda_ballquery.num_sms(sparse.device.index)),
              "device_ms": device_ms(lambda: ops.knn(sparse, queries, k, impl="cuda"), "knn", calls=3)},
    )


def _host_seconds(fn, runs: int = 2) -> list[float]:
    """Host seconds of each of ``runs`` calls of ``fn``, the device synchronised after each."""
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def densify_phase(seed: int, card: str, report: Report) -> dict:
    """``cli.interpolate`` as a user runs it, on fabricated validation scenes
    (``tools.scenes.fabricate_dense``): the first of ``DENSE_POINTS`` raw points
    with ``SPARSE_POINTS`` labelled sparse ones, the other five smaller.
    ``--engine device`` on the card (launch counts reset just before it and
    read just after: row 3 once a scene), then ``--engine native`` on the
    host. The device engine's labels equal its plain version's bit for bit on
    a fixed subset of ``DENSIFY_SUBSET`` points of the first scene, on the
    card, and agree with the native engine's on >= 99.99 % of all points (the
    native engine computes distances in float64, the kernel in float32, so
    only near-ties of the 3rd and 4th neighbour may differ: each mismatch's
    two distances are printed, up to 10). Row 3 is held and timed at the
    first scene's shapes, the whole scene's kernel time beside its bound, and
    both engines are run again on the first scene by the host clock."""
    if native.get_lib() is None:
        logs = {p.name: p.read_text()[-400:] for p in native.BUILD_DIR.glob("libpn2native_*.log")}
        raise AssertionError(f"the native densify engine could not be built: {logs}")
    dense_sizes = (DENSE_POINTS,) + (SMALL_DENSE,) * 5
    sparse_sizes = (SPARSE_POINTS,) + (SMALL_SPARSE,) * 5
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_densify_") as tmp:
        tmp = pathlib.Path(tmp)
        for name in ("gt", "sparse"):
            (tmp / name).mkdir()
        scenes.fabricate_dense(tmp / "gt", tmp / "sparse", seed, "validation", dense_sizes, sparse_sizes)
        common = ["--set", "validation", "--sparse_dir", str(tmp / "sparse"), "--gt_dir", str(tmp / "gt")]
        torch.cuda.synchronize()
        cuda.reset_launches()
        on_card = cli_interpolate.main(common + ["--engine", "device", "--dense_dir", str(tmp / "device")])
        launches = dict(cuda.LAUNCHES)
        chunk = densify.device_chunk(3, SPARSE_POINTS, kernel=True)
        _expect_launches(launches, {"knn": sum(-(-n // chunk) for n in dense_sizes)},
                         f"cli.interpolate --engine device on {len(dense_sizes)} scenes")
        on_host = cli_interpolate.main(common + ["--engine", "native", "--dense_dir", str(tmp / "native")])
        if on_card["points"] != list(dense_sizes) or on_host["points"] != list(dense_sizes):
            raise AssertionError(f"densified {on_card['points']} and {on_host['points']} points")

        mismatches, total, first = [], 0, None
        for prefix, (device_labels, _), (native_labels, _) in zip(on_card["scenes"], on_card["outputs"],
                                                                   on_host["outputs"]):
            got, want = load_labels(device_labels), load_labels(native_labels)
            total += len(got)
            sparse_cloud = read_pcd(tmp / "sparse" / f"{prefix}.pcd").points
            dense_cloud = read_pcd(tmp / "gt" / f"{prefix}.pcd").points
            sparse = torch.from_numpy(sparse_cloud.astype(np.float32)).to(DEVICE)
            for i in np.flatnonzero(got != want):
                if len(mismatches) < 10:
                    q = torch.from_numpy(dense_cloud[i : i + 1].astype(np.float32)).to(DEVICE)
                    d2 = core.knn(sparse[None], q[None], 4)[0][0, 0].cpu().numpy()
                    mismatches.append({"scene": prefix, "point": int(i), "third_d2": float(d2[2]),
                                       "fourth_d2": float(d2[3])})
                else:
                    mismatches.append({"scene": prefix, "point": int(i)})
            if first is None:
                first = (sparse, load_labels(tmp / "sparse" / f"{prefix}.labels"), dense_cloud, sparse_cloud)
        if len(mismatches) > (1 - NATIVE_AGREEMENT) * total:
            raise AssertionError(f"device and native engines disagree on {len(mismatches)} of {total} points: "
                                 f"{mismatches[:10]}")

        sparse, sparse_labels, dense_cloud, sparse_cloud_first = first
        labels_dev = torch.from_numpy(sparse_labels).to(DEVICE)
        dense = torch.from_numpy(dense_cloud.astype(np.float32)).to(DEVICE)
        pick = torch.from_numpy(np.sort(np.random.RandomState(seed).choice(len(dense_cloud), DENSIFY_SUBSET,
                                                                           replace=False))).to(DEVICE)
        subset = dense[pick].contiguous()
        got, got_colors = densify.densify_labels_device(sparse, labels_dev, subset, 3, device=DEVICE)
        want, want_colors = densify.densify_labels_device(sparse, labels_dev, subset, 3, device=DEVICE, impl="torch")
        if not (torch.equal(got, want) and torch.equal(got_colors, want_colors)):
            raise AssertionError(f"the device engine differs from its plain version on "
                                 f"{int((got != want).sum())} of {DENSIFY_SUBSET} points")
        engine_ms = cuda_ms(lambda: densify.densify_labels_device(sparse, labels_dev, dense, 3, device=DEVICE),
                            **FEW)
        # The CLI's call of each engine on the first scene was the process's first at
        # that size; the same calls again, from the host arrays, by the host clock.
        host_args = (sparse_cloud_first, sparse_labels, dense_cloud)
        warm_seconds = {engine: _host_seconds(lambda: densify.densify_labels(*host_args, 3, engine, device=DEVICE))
                        for engine in ("device", "native")}
        scene_kernel_ms = cuda_ms(lambda: ops.knn(sparse[None], dense[None], 3, impl="cuda"), **FEW)
        densify_knn_row(report, "densify subset", sparse, subset)
    scene_bound_ms, scene_bound_by = bound(*op_bench.work_knn(1, DENSE_POINTS, SPARSE_POINTS, 3))
    emit({
        "phase": "densify",
        "scenes": len(dense_sizes),
        "dense_points": list(dense_sizes),
        "sparse_points": list(sparse_sizes),
        "device_seconds": on_card["seconds"],
        "native_seconds": on_host["seconds"],
        "device_mpoints_per_s": DENSE_POINTS / on_card["seconds"][0] / 1e6,
        "native_mpoints_per_s": DENSE_POINTS / on_host["seconds"][0] / 1e6,
        "warm_seconds": warm_seconds,
        "engine_on_device_ms": engine_ms,
        "scene_kernel_ms": scene_kernel_ms,
        "scene_bound_ms": scene_bound_ms,
        "scene_bound_by": scene_bound_by,
        "scene_pairs": DENSE_POINTS * SPARSE_POINTS,
        "native_mismatches": len(mismatches),
        "native_agreement": 1 - len(mismatches) / total,
        "mismatch_distances": mismatches[:10],
        "subset_bit_equal": True,
        "launches": launches,
        "phase_seconds": time.perf_counter() - t0,
        "card": card,
    })
    return launches


# The dist phase: the ranks run as subprocesses (``parallel.launch.run_ranks``),
# each within ``DIST_TIMEOUT_S``; a rank that fails or hangs fails the phase.
DIST_RANKS = 2
DIST_TIMEOUT_S = 300
DIST_GROUP_TIMEOUT_S = 240
DIST_STATS_TOL = 1e-5  # moving statistics: atol and rtol
# The 2-process step's gates against the one-process step: the loss's
# relative error, a gradient measure and its limit, the statistics' error
# as a share of the DIST_STATS_TOL limit (float64: of a 1e-6 one).
# In float32 the processes' BatchNorm sums round otherwise than one process's
# and ReLU flips follow, so a gradient element may move by 7e-2 of its max
# abs (PERF.md, PR 15): the gate there is the relative L2 of every
# gradient together, its limit set between the sound steps' readings on
# DIST_F32_BATCHES batches and the DIST_CONTROL step's (each rank's
# BatchNorm on its own rows), which must exceed it; float64 holds every
# gradient to 1e-6.
DIST_F32_TOL = {"loss": 1e-5, "grads": ("grad_rel_l2", 5e-2), "stats": 1.0}
DIST_F64_TOL = {"loss": 1e-6, "grads": ("worst_grad_err_of_max_abs", 1e-6), "stats": 0.1}
DIST_F32_BATCHES = 3
DIST_CONTROL = "rank_batch_norm"
# The train CLI over processes is held to the one-process run at a learning
# rate of 1e-5: at semantic.json's 1e-3 training amplifies the float32
# rounding of the split sums by some 30 times a step (PERF.md, PR 15), and
# that pair is measured, not gated.
DIST_CLI_LOSS_RTOL = 1e-4
DIST_CLI_LR = 1e-5
DIST_SOLO_BACKEND = "nccl"  # the group of one: the only NCCL group one card can form


def _dist_ranks(argv_of, world: int = DIST_RANKS) -> list[str]:
    return run_ranks(argv_of, world, timeout=DIST_TIMEOUT_S, group_timeout=DIST_GROUP_TIMEOUT_S, cwd=ROOT)


def _cli_ranks(module: str, out: pathlib.Path, argv: list, world: int = DIST_RANKS) -> tuple[list, list]:
    """``world`` processes of the CLI ``module`` (on this card, gloo; one
    process forms no group): their summaries and outputs."""
    return dist_step.run_cli_ranks(module, out, argv, world, timeout=DIST_TIMEOUT_S,
                                   group_timeout=DIST_GROUP_TIMEOUT_S, cwd=ROOT)


@contextlib.contextmanager
def _as_rank(rank: int, world: int):
    """``multihost``'s process index and count stand in for rank ``rank`` of
    ``world``, with no group: a one-process CLI run then walks that rank's
    scenes, and its confusion matrix is that rank's alone."""
    saved = multihost.process_index, multihost.process_count
    multihost.process_index, multihost.process_count = (lambda: rank), (lambda: world)
    try:
        yield
    finally:
        multihost.process_index, multihost.process_count = saved


def _sum_launches(*counts: dict) -> dict:
    total: dict = {}
    for launches in counts:
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    return total


def _two_process_steps(cfg: Config, cases: list, tmp: pathlib.Path) -> list[tuple[dict, list, dict]]:
    """``cases`` (``tools.dist_step``) on ``DIST_RANKS`` processes of this
    card (gloo), each on its rows of the 16-cloud batch, and in this process
    on all of them. For each case: the gaps between the two (loss, gradients
    of their max abs and relative L2, moving statistics of the
    ``DIST_STATS_TOL`` limit), the ranks' records and the one-process record."""
    spec = tmp / "step.json"
    spec.write_text(json.dumps({"config": dataclasses.asdict(cfg), "device": DEVICE, "cases": cases}))
    t0 = time.perf_counter()
    _dist_ranks(dist_step.rank_argv(spec, tmp / "step", DIST_RANKS))
    ranks_seconds = time.perf_counter() - t0
    outs = [torch.load(tmp / f"step.rank{r}.pt")["cases"] for r in range(DIST_RANKS)]
    results = []
    for i, case in enumerate(cases):
        ranks = [out[i] for out in outs]
        ref = dist_step.run_case(cfg, case, torch.device(DEVICE))
        for rank in ranks:
            if rank["backend"] != "gloo" or rank["world"] != DIST_RANKS:
                raise AssertionError(f"rank {rank['rank']} ran {rank['backend']} in a group of {rank['world']}")
            if case.get("control") is None and not all(
                    torch.equal(v, ranks[0]["state"][k]) for k, v in rank["state"].items()):
                raise AssertionError(f"rank {rank['rank']} holds another state than rank 0 after the step")
        got = ranks[0]
        stats = {k: v for k, v in ref["state"].items() if k.endswith(".mean") or k.endswith(".var")}
        num = sum(float(((got["grads"][k].double() - v.double()) ** 2).sum()) for k, v in ref["grads"].items())
        den = sum(float((v.double() ** 2).sum()) for v in ref["grads"].values())
        gaps = {
            "case": {k: v for k, v in case.items() if k != "steps"},
            "processes": DIST_RANKS, "backend": got["backend"], "batch": cfg.batch_size,
            "rows_a_process": cfg.batch_size // DIST_RANKS, "loss": got["losses"][0], "ref_loss": ref["losses"][0],
            "loss_rel_err": abs(got["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
            # A bias in front of a BatchNorm has a gradient of rounding noise: those are left out.
            "worst_grad_err_of_max_abs": max(
                max_abs(got["grads"][k], v) / float(v.abs().max())
                for k, v in ref["grads"].items() if float(v.abs().max()) > 1e-6
            ),
            "grad_rel_l2": (num / den) ** 0.5,
            "stats_err_of_limit": max(
                float(((got["state"][k] - v).abs() / (DIST_STATS_TOL + DIST_STATS_TOL * v.abs())).max())
                for k, v in stats.items()
            ),
            "rank_first_step_ms": [r["step_ms"][0] for r in ranks], "one_process_first_step_ms": ref["step_ms"][0],
            "ranks_seconds": ranks_seconds,
        }
        print(f"dist: {DIST_RANKS} processes against one: {json.dumps(gaps)}", flush=True)
        results.append((gaps, ranks, ref))
    return results


def _dist_step_phase(cfg: Config, seed: int, tmp: pathlib.Path) -> tuple[dict, dict]:
    """(a) One Adam step of 2 processes on this card (gloo), 8 rows of a 16-cloud
    batch each, dropout on, held to the one-process step on the 16 rows here:
    on the kernels in float32 on ``DIST_F32_BATCHES`` batches, then the
    ``DIST_CONTROL`` step, which the float32 gradient gate must refuse, and on
    the plain versions in float64; (b) one step of a group of one over NCCL,
    bit for bit the plain Trainer step."""
    case = dict(arch="ssg", accum_steps=1, dropout_rate=0.5, weights_seed=seed, batch_seed=seed + 300, steps=1)
    sound = [{**case, "batch_seed": case["batch_seed"] + i} for i in range(DIST_F32_BATCHES)]
    *steps, control, (float64, _, _) = _two_process_steps(
        cfg, [*sound, {**case, "control": DIST_CONTROL}, {**case, "dtype": "float64", "ops_impl": "torch"}], tmp
    )
    for _, ranks, ref in [*steps, control]:
        for rank in ranks:
            _expect_launches(rank["launches"], step_launches(), f"rank {rank['rank']}'s train step")
        _expect_launches(ref["launches"], step_launches(), "the one-process train step")
    steps[0][0]["launches_a_rank"] = steps[0][1][0]["launches"]
    for what, gaps, tol in [("float32", gaps, DIST_F32_TOL) for gaps, _, _ in steps] + [
            ("float64", float64, DIST_F64_TOL)]:
        if gaps["loss_rel_err"] > tol["loss"] or gaps[tol["grads"][0]] > tol["grads"][1] \
                or gaps["stats_err_of_limit"] > tol["stats"]:
            raise AssertionError(f"the {what} 2-process step is beyond its gates {tol}: {gaps}")
    measure, limit = DIST_F32_TOL["grads"]
    if control[0][measure] <= limit:
        raise AssertionError(f"the float32 gradient gate ({measure} <= {limit}) passes the {DIST_CONTROL} "
                             f"control: {control[0]}")
    launches = _sum_launches(*(r["launches"] for _, ranks, _ in [*steps, control] for r in ranks))

    spec = tmp / "nccl.json"
    spec.write_text(json.dumps({"config": dataclasses.asdict(cfg), "device": DEVICE, "backend": DIST_SOLO_BACKEND,
                                "deterministic": True, "plain_after": True, "cases": [case]}))
    _dist_ranks(dist_step.rank_argv(spec, tmp / "nccl", 1), world=1)
    out = torch.load(tmp / "nccl.rank0.pt")
    (dist_run,), (plain,) = out["cases"], out["plain"]
    if dist_run["backend"] != DIST_SOLO_BACKEND or dist_run["world"] != 1 or plain["backend"] is not None:
        raise AssertionError(f"the NCCL run ran {dist_run['backend']}, the plain one {plain['backend']}")
    _expect_launches(dist_run["launches"], step_launches(), "the NCCL group of one's train step")
    unequal = [f"{part}.{k}" for part in ("grads", "state") for k, v in plain[part].items()
               if not torch.equal(dist_run[part][k], v)]
    if dist_run["losses"] != plain["losses"] or not torch.equal(dist_run["confusion"], plain["confusion"]) or unequal:
        raise AssertionError(f"the NCCL group of one differs from the plain step: losses {dist_run['losses']} vs "
                             f"{plain['losses']}, {unequal[:5]}")
    nccl = {"backend": DIST_SOLO_BACKEND, "world": 1, "bit_equal": True, "loss": dist_run["losses"][0],
            "step_ms": dist_run["step_ms"][0], "plain_step_ms": plain["step_ms"][0]}
    record = {"steps": [gaps for gaps, _, _ in steps], "step_control": control[0], "step_float64": float64,
              "nccl_world_1": nccl}
    return record, _sum_launches(launches, dist_run["launches"])


def _train_pair(seed: int, tmp: pathlib.Path, name: str,
                learning_rate: Optional[float]) -> tuple[dict, dict, pathlib.Path]:
    """``cli.train --seed`` in this process and on ``DIST_RANKS`` processes
    (replicated sampling) on the scenes of ``tmp``, from a copy of
    semantic.json with ``data_path``, ``logdir``, ``max_epoch = 1`` and,
    where given, ``learning_rate`` changed. Checks process 0's artifacts and
    each process's launches; returns the record (the largest relative gap of
    a step's loss among it), the processes' launches and the one-process
    run's config path."""
    raw_cfg = json.loads((ROOT / "semantic.json").read_text())
    cfg_paths = {}
    for run in ("one", "two"):
        cfg_paths[run] = tmp / f"{name}_{run}.json"
        cfg_paths[run].write_text(json.dumps(
            {**raw_cfg, "data_path": str(tmp / "scenes"), "logdir": str(tmp / f"{name}_log_{run}"), "max_epoch": 1,
             **({} if learning_rate is None else {"learning_rate": learning_rate})}
        ))
    one = cli_train.main(["--config_file", str(cfg_paths["one"]), "--seed", str(seed), "--device", DEVICE])
    t0 = time.perf_counter()
    summaries, outputs = _cli_ranks("train", tmp / name, [
        "--config_file", str(cfg_paths["two"]), "--seed", str(seed), "--dist_sampling", "replicated",
        "--device", DEVICE,
    ])
    ranks_seconds = time.perf_counter() - t0
    (epoch,) = one["epochs"]
    want = np.asarray(epoch["losses"])
    steps, val_batches = epoch["train_batches"], epoch["val_batches"]
    local_chunks = val_batches * max(1, BATCH // DIST_RANKS // CHUNK)
    log = pathlib.Path(Config.from_json(cfg_paths["two"]).logdir)
    text = (log / "log_train.txt").read_text()
    if text.count("**** EPOCH 000") != 1 or "[proc" in text or "[proc 1] mean loss" not in outputs[1]:
        raise AssertionError("the 2-process train CLI did not keep its log to process 0")
    written = sorted(p.name for p in log.glob("*.pt"))
    if summaries[1]["checkpoints"] or sorted(pathlib.Path(p).name for p in summaries[0]["checkpoints"]) != written \
            or "model_autosave.pt" not in written:
        raise AssertionError(f"the 2-process train CLI wrote {written}; process 1 {summaries[1]['checkpoints']}")
    gaps = []
    for summary in summaries:
        (rank_epoch,) = summary["epochs"]
        got = np.asarray(rank_epoch["losses"])
        if summary["processes"] != DIST_RANKS or summary["step"] != steps or got.shape != want.shape:
            raise AssertionError(f"a rank ran {summary['step']} steps in {summary['processes']} processes")
        _expect_launches(summary["launches"], _sum_launches(scaled(step_launches(), steps),
                                                            scaled(chunk_launches(), local_chunks)),
                         f"a rank of the 2-process train CLI: {steps} steps, {local_chunks} eval chunks")
        gaps.append(float(np.max(np.abs(got - want) / np.abs(want))))
    record = {
        "backend": summaries[0]["backend"], "processes": DIST_RANKS, "steps": steps,
        "learning_rate": learning_rate or raw_cfg["learning_rate"], "losses": want.tolist(),
        "dist_losses": summaries[0]["epochs"][0]["losses"], "largest_loss_gap": max(gaps),
        "median_step_ms": statistics.median(epoch["step_ms"][1:]),
        "dist_median_step_ms": [statistics.median(s["epochs"][0]["step_ms"][1:]) for s in summaries],
        "ranks_seconds": ranks_seconds, "checkpoints": written,
    }
    print(f"dist: {name}, the 2-process train CLI's losses against one process's: {json.dumps(record)}", flush=True)
    return record, _sum_launches(*(s["launches"] for s in summaries)), cfg_paths["one"]


def _dist_cli_phase(seed: int, tmp: pathlib.Path) -> tuple[dict, dict]:
    """(c) ``cli.train`` on 2 processes (replicated sampling, ``--seed``)
    against the one-process run, at ``DIST_CLI_LR`` (every step's loss within
    ``DIST_CLI_LOSS_RTOL``) and at semantic.json's learning rate (measured);
    (d) ``cli.predict --sharded`` against the one-process predict CLI, and
    ``cli.predict`` on 2 processes against a one-process run of each rank's
    scenes (``_as_rank``)."""
    (tmp / "scenes").mkdir()
    scenes.fabricate(tmp / "scenes", seed)
    train, train_launches, cfg_path = _train_pair(seed, tmp, "train", DIST_CLI_LR)
    if train["largest_loss_gap"] > DIST_CLI_LOSS_RTOL:
        raise AssertionError(f"the 2-process train CLI's losses {train['dist_losses']} part from the one-process "
                             f"run's {train['losses']} by {train['largest_loss_gap']} relative")
    measured, measured_launches, _ = _train_pair(seed, tmp, "train_semantic_lr", None)
    train_launches = _sum_launches(train_launches, measured_launches)

    ckpt = pathlib.Path(Config.from_json(cfg_path).logdir) / "model.pt"
    common = ["--ckpt", str(ckpt), "--set", "validation", "--config_file", str(cfg_path),
              "--num_samples", str(CLI_SAMPLES), "--batch_size", str(CLI_PREDICT_BATCH), "--device", DEVICE]
    plain = cli_predict.main(common + ["--output_dir", str(tmp / "plain")])
    torch.cuda.synchronize()
    cuda.reset_launches()
    sharded = cli_predict.main(common + ["--output_dir", str(tmp / "sharded"), "--sharded"])
    sharded_launches = dict(cuda.LAUNCHES)
    batches = len(sharded["batch_seconds"])
    _expect_launches(sharded_launches, scaled(chunk_launches(), batches), f"predict --sharded: {batches} batches")
    ranks, rank_outputs = _cli_ranks("predict", tmp / "predict", common + ["--output_dir", str(tmp / "two")])
    # The one-process run again in a fresh process of its own, as each rank
    # runs: the wall rates compare processes that pay the same first calls.
    (fresh,), _ = _cli_ranks("predict", tmp / "fresh", common + ["--output_dir", str(tmp / "fresh")], world=1)
    prefixes = [pathlib.Path(labels).stem for _, labels in plain["outputs"]]
    for prefix in prefixes:
        if (tmp / "sharded" / f"{prefix}.labels").read_bytes() != (tmp / "plain" / f"{prefix}.labels").read_bytes():
            raise AssertionError(f"predict --sharded labelled {prefix} otherwise than the plain predict CLI")
        for suffix in (".pcd", ".labels"):
            if (tmp / "fresh" / f"{prefix}{suffix}").read_bytes() != (tmp / "plain" / f"{prefix}{suffix}").read_bytes():
                raise AssertionError(f"the one-process predict CLI wrote another {prefix}{suffix} in a fresh process")
    _expect_launches(fresh["launches"], scaled(chunk_launches(), len(fresh["batch_seconds"])),
                     "the one-process predict CLI in a fresh process")
    # Each rank held to a one-process run that draws that rank's scenes on a fresh stream.
    alone = []
    for r in range(DIST_RANKS):
        with _as_rank(r, DIST_RANKS):
            alone.append(cli_predict.main(common + ["--output_dir", str(tmp / f"rank{r}")]))
    agree = total = 0
    for r, (rank, solo) in enumerate(zip(ranks, alone)):
        mine = [pathlib.Path(labels).stem for _, labels in rank["outputs"]]
        if mine != prefixes[r::DIST_RANKS] or mine != [pathlib.Path(labels).stem for _, labels in solo["outputs"]]:
            raise AssertionError(f"predict process {r} wrote {mine}, its one-process stand-in {solo['outputs']}")
        for prefix in mine:
            if (tmp / "two" / f"{prefix}.pcd").read_bytes() != (tmp / f"rank{r}" / f"{prefix}.pcd").read_bytes():
                raise AssertionError(f"predict process {r} drew {prefix}'s samples otherwise than rank {r} alone")
            got, want = load_labels(tmp / "two" / f"{prefix}.labels"), load_labels(tmp / f"rank{r}" / f"{prefix}.labels")
            if got.shape != want.shape:
                raise AssertionError(f"{prefix}.labels: {got.shape} labels, want {want.shape}")
            agree += int((got == want).sum())
            total += want.size
        _expect_launches(rank["launches"], scaled(chunk_launches(), len(rank["batch_seconds"])),
                         f"predict process {r}")
    if agree < 0.9999 * total:
        raise AssertionError(f"the 2-process predict CLI's labels agree with its ranks alone on {agree} of {total}")
    summed = sum(np.asarray(solo["confusion"]) for solo in alone)
    if not all(np.array_equal(rank["confusion"], summed) for rank in ranks):
        raise AssertionError("the gathered confusion matrix is not the sum of the ranks' matrices")
    if "Confusion matrix" not in rank_outputs[0] or "Confusion matrix" in rank_outputs[1]:
        raise AssertionError("the gathered metrics are not printed by process 0 alone")
    # Process 1 starts its first scene on a fresh stream, not after scene 0's samples.
    first = prefixes[1]
    if (tmp / "two" / f"{first}.pcd").read_bytes() == (tmp / "plain" / f"{first}.pcd").read_bytes():
        raise AssertionError(f"predict process 1 drew {first} as the one-process run does, after scene 0")
    predict = {
        "sharded_devices": len(cli_mesh(DEVICE)), "sharded_labels_bit_equal": True,
        "rank_pcd_bit_equal": True, "rank_label_agreement": agree / total, "confusion_is_rank_sum": True,
        "samples_per_s": plain["samples"] / sum(plain["batch_seconds"]),
        "sharded_samples_per_s": sharded["samples"] / sum(sharded["batch_seconds"]),
        "process_samples": [rank["samples"] for rank in ranks],
        # Over the whole scene loop, sampling included: each process draws its own scenes' samples.
        # This process is warm from the earlier phases; the fresh one and the ranks are not.
        "wall_samples_per_s": plain["samples"] / plain["seconds"],
        "fresh_wall_samples_per_s": fresh["samples"] / fresh["seconds"],
        "two_process_wall_samples_per_s": sum(r["samples"] for r in ranks) / max(r["seconds"] for r in ranks),
        "sample_seconds": plain["sample_seconds"], "fresh_sample_seconds": fresh["sample_seconds"],
        "process_sample_seconds": [r["sample_seconds"] for r in ranks],
        "seconds": plain["seconds"], "fresh_seconds": fresh["seconds"], "process_seconds": [r["seconds"] for r in ranks],
        "batch_seconds": plain["batch_seconds"], "fresh_batch_seconds": fresh["batch_seconds"],
        "process_batch_seconds": [r["batch_seconds"] for r in ranks],
    }
    return ({"train_cli": train, "train_cli_semantic_lr": measured, "predict_cli": predict},
            _sum_launches(train_launches, sharded_launches, fresh["launches"], *(r["launches"] for r in ranks)))


def _dist_densify_phase(seed: int, tmp: pathlib.Path) -> tuple[dict, dict]:
    """(e) ``knn_sharded`` over one and two shards of this card at the densify
    phase's shapes, and ``cli.interpolate --engine sharded`` on its scenes."""
    dense_sizes = (DENSE_POINTS,) + (SMALL_DENSE,) * 5
    sparse_sizes = (SPARSE_POINTS,) + (SMALL_SPARSE,) * 5
    for name in ("gt", "sparse"):
        (tmp / name).mkdir()
    scenes.fabricate_dense(tmp / "gt", tmp / "sparse", seed, "validation", dense_sizes, sparse_sizes)
    prefix = validation_file_prefixes[0]
    sparse = read_pcd(tmp / "sparse" / f"{prefix}.pcd").points.astype(np.float32)
    dense = read_pcd(tmp / "gt" / f"{prefix}.pcd").points.astype(np.float32)
    dev = torch.device(DEVICE)
    want_d2, want_idx = ops.knn(torch.from_numpy(sparse).to(dev)[None], torch.from_numpy(dense).to(dev)[None], 3)
    want_d2, want_idx = want_d2[0].cpu(), want_idx[0].cpu()
    knn_rows, launches = {}, {}
    for shards in (1, 2):
        torch.cuda.synchronize()
        cuda.reset_launches()
        t0 = time.perf_counter()
        d2, idx = knn_sharded(sparse, dense, 3, [dev] * shards)
        seconds = time.perf_counter() - t0
        counted = dict(cuda.LAUNCHES)
        _expect_launches(counted, {"knn": shards}, f"knn_sharded over {shards} shards")
        if not (torch.equal(d2, want_d2) and torch.equal(idx, want_idx)):
            raise AssertionError(f"knn_sharded over {shards} shards differs from ops.knn")
        knn_rows[str(shards)] = {"bit_equal": True, "seconds": seconds}
        launches = _sum_launches(launches, counted)
    common = ["--set", "validation", "--sparse_dir", str(tmp / "sparse"), "--gt_dir", str(tmp / "gt"),
              "--device", DEVICE]
    device_run = cli_interpolate.main(common + ["--engine", "device", "--dense_dir", str(tmp / "device")])
    torch.cuda.synchronize()
    cuda.reset_launches()
    sharded_run = cli_interpolate.main(common + ["--engine", "sharded", "--dense_dir", str(tmp / "sharded")])
    counted = dict(cuda.LAUNCHES)
    mesh = len(cli_mesh(DEVICE))
    chunk = densify.device_chunk(3, SPARSE_POINTS, kernel=True)
    shard_points = [-(-n // (mesh * 128)) * 128 for n in dense_sizes]  # each scene padded to mesh x 128
    want_launches = sum(mesh * -(-points // chunk) for points in shard_points)
    _expect_launches(counted, {"knn": want_launches}, f"cli.interpolate --engine sharded on {len(dense_sizes)} scenes")
    for name in sharded_run["scenes"]:
        if (tmp / "sharded" / f"{name}.labels").read_bytes() != (tmp / "device" / f"{name}.labels").read_bytes():
            raise AssertionError(f"--engine sharded labelled {name} otherwise than --engine device")
    interpolate = {"devices": mesh, "labels_bit_equal": True, "seconds": sharded_run["seconds"],
                   "device_seconds": device_run["seconds"]}
    return ({"knn_sharded": {"queries": DENSE_POINTS, "refs": SPARSE_POINTS, "k": 3, "shards": knn_rows},
             "interpolate_sharded": interpolate}, _sum_launches(launches, counted))


def dist_phase(cfg: Config, seed: int, card: str) -> dict:
    """The multi-process and sharded paths (``parallel``): (a)-(b) the train
    step over processes, (c)-(d) the train and predict CLIs over processes and
    ``--sharded``, (e) the sharded kNN and densify. Returns the launches of the
    distributed and sharded runs (the ranks' own counts among them), not those
    of the one-process runs they are held to."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        tmp = pathlib.Path(tmp)
        parts = []
        for sub, run in (("step", lambda d: _dist_step_phase(cfg, seed, d)),
                         ("cli", lambda d: _dist_cli_phase(seed, d)),
                         ("densify", lambda d: _dist_densify_phase(seed, d))):
            (tmp / sub).mkdir()
            parts.append(run(tmp / sub))
            torch.cuda.empty_cache()
    launches = _sum_launches(*(counted for _, counted in parts))
    emit({
        "phase": "dist",
        **{key: value for record, _ in parts for key, value in record.items()},
        "launches": launches,
        "phase_seconds": time.perf_counter() - t0,
        "card": card,
    })
    return launches


def _kitti_expected(frames: int, windows: bool, launches: dict) -> None:
    """Each frame: one chunk of one cloud (FPS and three_interpolate 4 times,
    the four ball queries exact or through the fused window, the four FP 3-NN
    exact or windowed), then the densify's one launch of row 3; with ``auto``
    windows also the calibration's FPS, 4 levels of min(8, frames) samples."""
    got = {name: launches.get(name, 0) for name in KERNELS}
    calibration = 4 * min(8, frames) if windows else 0
    totals = {"fps_centroids": got["fps_centroids"] - calibration, "three_interpolate": got["three_interpolate"],
              "ball": got["ball_query"] + got["ball_query_sliced_pos"], "three_nn": got["knn"] + got["knn_sliced"]}
    want_total = {"fps_centroids": 4, "three_interpolate": 4, "ball": 4, "three_nn": 5}
    extra = {name for name, n in got.items() if n and name not in (
        "fps_centroids", "three_interpolate", "ball_query", "ball_query_sliced_pos", "window_gather", "knn",
        "knn_sliced")}
    if (totals != {k: frames * v for k, v in want_total.items()} or extra
            or got["window_gather"] != got["ball_query_sliced_pos"]
            or (not windows and (got["ball_query_sliced_pos"] or got["knn_sliced"]))):
        raise AssertionError(f"cli.kitti_predict over {frames} frames{' with windows' if windows else ''} "
                             f"launched {launches}")


def kitti_phase(seed: int, card: str, report: Report) -> dict:
    """``cli.kitti_predict --save`` as a user runs it, on a fabricated drive
    (``tools.scenes.write_drive``: ``KITTI_FRAMES`` sweeps of
    ``KITTI_SWEEP_POINTS`` points) with a ``.pt`` of random weights at
    ``semantic_no_color.json`` widths (``bn_stats="random"``), once exact and
    once with ``--bq_window auto --fp_window auto``, each with its launch
    counts reset just before it and read just after. Every frame's dense
    labels, written by the CLI, agree on >= 99.99 % of points with the plain
    path on the card: a plain ``Predictor`` (no windows) on the sample the CLI
    drew, then the densify engine's plain version. Row 3 is held and timed at
    the first frame's densify shape."""
    cfg_path = ROOT / "semantic_no_color.json"
    cfg = Config.from_json(cfg_path)
    t0 = time.perf_counter()
    cwd = pathlib.Path.cwd()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kitti_") as tmp:
        tmp = pathlib.Path(tmp)
        root = scenes.write_drive(tmp / "drive", seed, KITTI_FRAMES, KITTI_SWEEP_POINTS)
        trainer = Trainer(cfg, device=DEVICE)
        trainer.init_state(seed, bn_stats="random")
        save_checkpoint(tmp / "model.pt", trainer)
        del trainer
        plain = Predictor(cfg, load_model_state(tmp / "model.pt"), device=DEVICE, impl="torch")
        runs, paths = {}, {}
        for name, windows in (("kitti", []), ("kitti_windows", ["--bq_window", "auto", "--fp_window", "auto"])):
            (tmp / name).mkdir()
            os.chdir(tmp / name)
            try:
                torch.cuda.synchronize()
                cuda.reset_launches()
                s = time.perf_counter()
                summary = cli_kitti.main(["--ckpt", str(tmp / "model.pt"), "--kitti_root", str(root),
                                          "--config_file", str(cfg_path), "--save"] + windows)
                seconds = time.perf_counter() - s
                launches = dict(cuda.LAUNCHES)
            finally:
                os.chdir(cwd)
            _kitti_expected(KITTI_FRAMES, bool(windows), launches)
            agree, frames = [], summary["frames"]
            for frame in frames:
                stem = tmp / name / "result" / "dense" / frame["name"][-4:]
                dense = read_pcd(stem.with_suffix(".pcd")).points.astype(np.float32)
                written = load_labels(stem.with_suffix(".labels"))
                sparse = plain.predict_step(frame["centered"][None].astype(np.float32)).reshape(-1)
                want, _ = densify.densify_labels_device(frame["raw"].astype(np.float32), sparse, dense, 3,
                                                        device=DEVICE, impl="torch")
                if written.shape != (frame["dense_points"],):
                    raise AssertionError(f"{stem}.labels: {written.shape} labels for {frame['dense_points']} points")
                agree.append(float((written == want.cpu().numpy()).mean()))
            if min(agree) < 0.9999:
                raise AssertionError(f"{name}: dense labels agree with the plain path on {agree} of each frame")
            runs[name] = {
                "bq_window": summary["bq_window"], "fp_window": summary["fp_window"], "seconds": seconds,
                "frames": [{"name": f["name"], "dense_points": f["dense_points"], "timer": f["timer"]}
                           for f in frames],
                "label_agreement": agree, "launches": launches,
            }
            paths[name] = launches
        first = summary["frames"][0]
        dense = torch.from_numpy(
            read_pcd(tmp / "kitti_windows" / "result" / "dense" / f"{first['name'][-4:]}.pcd").points
        ).to(DEVICE, torch.float32)
        densify_knn_row(report, "kitti densify", torch.from_numpy(first["raw"]).to(DEVICE, torch.float32), dense)
    emit({"phase": "kitti", "frames": KITTI_FRAMES, "sweep_points": KITTI_SWEEP_POINTS, **runs,
          "phase_seconds": time.perf_counter() - t0, "card": card})
    return paths


# The fresh process that loads the export phase's artifacts: argv[1] is a JSON
# list of (name, directory, batches), argv[2] the clouds (.npz, one array a
# batch). It writes each artifact's labels beside it and prints the seconds
# each load took and the model modules it found imported.
LOAD_CHECK = """
import json, sys, time
import numpy as np, torch
from pointnet2_tpu_torch.export import load_exported
clouds = np.load(sys.argv[2])
seconds = {}
for name, path, batches in json.loads(sys.argv[1]):
    t0 = time.perf_counter()
    fn, manifest = load_exported(path)
    seconds[name] = time.perf_counter() - t0
    for b in batches:
        out = fn(torch.from_numpy(clouds[str(b)]).to(manifest["device"]))
        labels = out[0] if manifest["window_certificate"] else out
        np.save(f"{path}/labels_{b}.npy", labels.cpu().numpy())
model_code = sorted(n for n in sys.modules if n.startswith(("pointnet2_tpu_torch.models", "pointnet2_tpu_torch.nn")))
print(json.dumps({"load_seconds": seconds, "model_modules": model_code}))
"""


def _artifact_predictor(cfg: Config, trainer: Trainer, chunk: int = CHUNK) -> Predictor:
    """The eager Predictor of a Trainer's weights and mode, as ``export_model``
    builds it; ``chunk`` 0 runs a batch whole, as a symbolic-batch artifact
    does (in bfloat16 a GEMM's result depends on its batch: cuBLAS picks
    another kernel, and on the H100 2 in 10**4 labels of a 16-cloud MSG
    selective-bf16 batch flipped between one call and two chunks of 8)."""
    return Predictor(
        cfg, trainer.model.state_dict(), infer_chunk=chunk, device=DEVICE, arch=trainer.arch,
        dtype=trainer.infer_dtype, bf16_min_width=trainer.bf16_min_width, bq_window=trainer.bq_window,
        fp_window=trainer.fp_window,
    )


def _host_ms(fn, runs: int = 3) -> list[float]:
    """Host ms of ``fn()`` to a synchronize, ``runs`` times."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def dispatch_us(cfg: Config, seed: int) -> dict:
    """Host µs a call of ``ops.fps_centroids`` (through ``pn2::fps_centroids``)
    and of the raw wrapper ``ops.cuda.fps_centroids``, at SA4's shape (B=8 of
    the 64 SA3 centroids, 16 out), in turns raw, op, op, raw: the calls are
    queued without a synchronize, so the host's clock reads their dispatch."""
    xyz = torch.from_numpy(np.ascontiguousarray(clouds(CHUNK, cfg, seed)[:, : cfg.l3_npoint, :3])).to(DEVICE)
    calls = {"raw": lambda: cuda.fps_centroids(xyz, cfg.l4_npoint), "pn2": lambda: ops.fps_centroids(xyz, cfg.l4_npoint)}
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    out = {"raw": [], "pn2": []}
    for name in ("raw", "pn2", "pn2", "raw"):
        t0 = time.perf_counter()
        for _ in range(DISPATCH_CALLS):
            calls[name]()
        out[name].append((time.perf_counter() - t0) * 1e6 / DISPATCH_CALLS)
        torch.cuda.synchronize()
    raw, pn2 = statistics.mean(out["raw"]), statistics.mean(out["pn2"])
    return {"shape": f"B={CHUNK} N={cfg.l3_npoint} npoint={cfg.l4_npoint}", "raw_us": out["raw"],
            "pn2_us": out["pn2"], "pn2_minus_raw_us": pn2 - raw}


def export_cli_main(ckpt: pathlib.Path, out: pathlib.Path, kw: dict, batch, *extra: str) -> dict:
    """``tools.export_model.main`` of checkpoint ``ckpt`` into ``out``, with no
    ``--device`` (the default, CUDA): the manifest."""
    flags = ["--batch", str(batch or 0)]
    for key, value in kw.items():
        flags += [EXPORT_FLAGS[key], str(value)]
    return export_cli.main(["--ckpt", str(ckpt), "--config_file", str(ROOT / "semantic.json"), "--out", str(out),
                            *flags, *extra])


def export_phase(cfg: Config, seed: int, card: str, root: pathlib.Path) -> tuple[dict, dict]:
    """Phase 10: the four artifacts (``EXPORTS``) and a logits export of the
    first, exported by the entry point from checkpoints under ``root``,
    loaded in a fresh process and here, each held against the Predictor of
    the weights the checkpoint was written from. Returns the phase's launch
    counts and the weights of the SSG float32 artifacts (for the serve phase)."""
    inputs = {b: clouds(b, cfg, seed + 900 + b) for b in SYMBOLIC_BATCHES}
    np.savez(root / "clouds.npz", **{str(b): x for b, x in inputs.items()})
    trainers, records, launches = {}, {}, {}
    for name, kw, batch in EXPORTS:
        trainer = Trainer(cfg, device=DEVICE, **kw)
        trainer.init_state(seed, bn_stats="random")
        trainers[name] = trainer
        save_checkpoint(root / f"{name}.pt", trainer)
        t0 = time.perf_counter()
        manifest = export_cli_main(root / f"{name}.pt", root / name, kw, batch)
        records[name] = {"export_seconds": time.perf_counter() - t0, "artifact_mb": manifest["artifact_bytes"] / 1e6,
                         "input_shape": manifest["input_shape"], "device": manifest["device"]}
        if manifest["device"] != torch.device(DEVICE).type:
            raise AssertionError(f"artifact {name} exported on {manifest['device']}, not on {DEVICE}")
    spec = [(name, str(root / name), [batch] if batch else list(SYMBOLIC_BATCHES)) for name, _, batch in EXPORTS]
    run = subprocess.run([sys.executable, "-c", LOAD_CHECK, json.dumps(spec), str(root / "clouds.npz")],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    if run.returncode != 0:
        raise AssertionError(f"loading the artifacts in a fresh process failed:\n{run.stdout}\n{run.stderr}")
    fresh = json.loads(run.stdout.strip().splitlines()[-1])
    if fresh["model_modules"]:
        raise AssertionError(f"loading the artifacts imported model code: {fresh['model_modules']}")

    for name, kw, batch in EXPORTS:
        fn, manifest = load_exported(str(root / name))
        predictor = _artifact_predictor(cfg, trainers[name], CHUNK if batch else 0)
        batches = [batch] if batch else list(SYMBOLIC_BATCHES)
        xs = {b: torch.from_numpy(inputs[b]).to(DEVICE) for b in batches}
        fn(xs[batches[0]])  # first launches and plans, as the Predictor's warm-up
        torch.cuda.synchronize()
        cuda.reset_launches()
        outs = {b: fn(xs[b]) for b in batches}
        torch.cuda.synchronize()
        counted = dict(cuda.LAUNCHES)
        forwards = BATCH // CHUNK if batch else len(batches)
        want = scaled(chunk_launches(kw.get("arch", "ssg"), "bq_window" in kw, "infer_dtype" in kw), forwards)
        _expect_launches(counted, want, f"artifact {name}")
        for kernel, count in counted.items():
            launches[kernel] = launches.get(kernel, 0) + count
        agree, oks = {}, {}
        for b in batches:
            labels, ok = outs[b] if manifest["window_certificate"] else (outs[b], None)
            want_labels, want_ok = predictor.predict_step_checked(inputs[b])
            sub = torch.from_numpy(np.load(root / name / f"labels_{b}.npy")).to(DEVICE)
            agree[b] = {"predictor": float((labels == want_labels).float().mean()),
                        "fresh_process": float((sub == labels).float().mean())}
            oks[b] = None if ok is None else bool(ok)
            if ok is not None and not (bool(ok) and want_ok):
                raise AssertionError(f"artifact {name}: window certificate {bool(ok)} (Predictor {want_ok}) at B={b}")
        if min(min(a.values()) for a in agree.values()) < 0.9999:
            raise AssertionError(f"artifact {name}: label agreement with the Predictor and the fresh process {agree}")
        x16 = inputs[BATCH]
        records[name].update({
            "load_seconds_fresh_process": fresh["load_seconds"][name],
            "batches": batches, "label_agreement": agree, "window_ok": oks, "launches": counted,
            "ms_per_16": _host_ms(lambda: fn(xs[BATCH])), "predictor_ms_per_16": _host_ms(lambda: predictor.predict_step(x16)),
        })

    trainer = trainers["ssg_f32_b16"]
    t0 = time.perf_counter()
    export_cli_main(root / "ssg_f32_b16.pt", root / "ssg_f32_b16_logits", {}, BATCH, "--output", "logits")
    logits_export_s = time.perf_counter() - t0
    fn, _ = load_exported(str(root / "ssg_f32_b16_logits"))
    x16 = torch.from_numpy(inputs[BATCH]).to(DEVICE)
    cuda.reset_launches()
    logits = fn(x16)
    torch.cuda.synchronize()
    counted = dict(cuda.LAUNCHES)
    _expect_launches(counted, scaled(chunk_launches(), BATCH // CHUNK), "the logits artifact")
    for kernel, count in counted.items():
        launches[kernel] = launches.get(kernel, 0) + count
    ref = _artifact_predictor(cfg, trainer).infer_logits(inputs[BATCH])
    logit_err = max_abs(logits, ref)
    if logits.shape != (BATCH, cfg.num_point, 9) or not torch.isfinite(logits).all() or logit_err > 1e-3:
        raise AssertionError(f"logits artifact: shape {tuple(logits.shape)}, max abs diff {logit_err} to the Predictor")
    emit({
        "phase": "export", "artifacts": records, "logits_export_seconds": logits_export_s,
        "max_abs_logit_diff": logit_err, "launches": launches, "dispatch": dispatch_us(cfg, seed), "card": card,
    })
    return launches, trainer.model.state_dict()


def _npy(a: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def _post(port: int, body: bytes, ctype: str = "application/x-npy") -> tuple[int, bytes, float]:
    """POST ``body`` to the daemon's predict path: (status, body, ms)."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/predict", data=body, method="POST")
    req.add_header("Content-Type", ctype)
    req.add_header("Accept", "application/x-npy")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            status, out = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, out = e.code, e.read()
    return status, out, (time.perf_counter() - t0) * 1e3


def _band(cloud: np.ndarray) -> np.ndarray:
    """``clustered``'s cloud as a request: half the points in a 2 cm band of x."""
    out = cloud.copy()
    half = out.shape[1] // 2
    out[:, :half, 0] = 4.0 + 0.02 * out[:, :half, 0] / 8.0
    return out


def serve_phase(cfg: Config, seed: int, card: str, root: pathlib.Path, state: dict) -> dict:
    """Phase 11: the daemon on the fixed-16 SSG artifact under 24 clients,
    then the certificate split on the windowed artifact."""
    rng = np.random.RandomState(seed + 1000)
    sizes = rng.randint(1, SERVE_MAX_CLOUDS + 1, size=(SERVE_CLIENTS, SERVE_REQUESTS))
    starts = np.concatenate([[0], np.cumsum(sizes)])[:-1].reshape(sizes.shape)
    pts = clouds(int(sizes.sum()) + 1, cfg, seed + 1000)  # the last cloud is the JSON request's
    predictor = Predictor(cfg, state, infer_chunk=CHUNK, device=DEVICE)
    want = torch.cat([predictor.predict_step(pts[i : i + BATCH]) for i in range(0, len(pts), BATCH)]).cpu().numpy()

    server = cli_serve.build_server(["--artifact", str(root / "ssg_f32_b16"), "--port", "0", "--batch", str(BATCH),
                                     "--max_delay_ms", str(SERVE_DELAY_MS)])
    server.start_background()
    try:
        def client(c: int) -> list:
            out = []
            for r in range(SERVE_REQUESTS):
                s, n = int(starts[c, r]), int(sizes[c, r])
                status, body, ms = _post(server.port, _npy(pts[s : s + n]))
                labels = np.load(io.BytesIO(body)) if status == 200 else None
                out.append((status, ms, None if labels is None else float((labels == want[s : s + n]).mean())))
            return out

        torch.cuda.synchronize()
        cuda.reset_launches()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=SERVE_CLIENTS) as ex:
            results = [res for per_client in ex.map(client, range(SERVE_CLIENTS)) for res in per_client]
        wall = time.perf_counter() - t0
        status, body, json_ms = _post(server.port, json.dumps({"points": pts[-1].tolist()}).encode(), "application/json")
        torch.cuda.synchronize()
        launches = dict(cuda.LAUNCHES)
        stats = server.stats.snapshot()
    finally:
        server.shutdown()
    json_agree = float((np.load(io.BytesIO(body))[0] == want[-1]).mean()) if status == 200 else None
    statuses = sorted({r[0] for r in results} | {status})
    agree = [r[2] for r in results] + [json_agree]
    if statuses != [200] or min(agree) < 0.9999:
        raise AssertionError(f"serve: statuses {statuses}, worst label agreement {min(a or 0 for a in agree)}")
    _expect_launches(launches, scaled(chunk_launches(), (BATCH // CHUNK) * stats["device_batches"]),
                     f"{stats['device_batches']} served device batches")
    if stats["batched_clouds"] <= 0 or stats["requests"] != len(results) + 1:
        raise AssertionError(f"serve: no micro-batching seen in /stats {stats}")
    latencies = sorted(r[1] for r in results)

    # The certificate split: a band cloud and a box cloud in one round.
    box, band = clouds(1, cfg, seed + 1100), _band(clouds(1, cfg, seed + 1101))
    windowed = cli_serve.build_server(["--artifact", str(root / "ssg_windows_b16"), "--port", "0",
                                       "--batch", str(BATCH), "--max_delay_ms", str(SPLIT_DELAY_MS)])
    windowed.start_background()
    go = threading.Barrier(2)
    try:
        def send(x: np.ndarray):
            go.wait(timeout=60)
            return _post(windowed.port, _npy(x))

        with ThreadPoolExecutor(max_workers=2) as ex:
            (band_status, _, _), (box_status, box_body, _) = ex.map(send, (band, box))
        split_stats = windowed.stats.snapshot()
    finally:
        windowed.shutdown()
    win_predictor = Predictor(cfg, state, infer_chunk=CHUNK, device=DEVICE, bq_window=BQ_WINDOW, fp_window=FP_WINDOW)
    box_want, box_ok = win_predictor.predict_step_checked(box)
    band_ok = win_predictor.predict_step_checked(band)[1]
    box_agree = float((np.load(io.BytesIO(box_body)) == box_want.cpu().numpy()).mean()) if box_status == 200 else 0.0
    if (band_status, box_status) != (503, 200) or split_stats["batched_clouds"] != 2 or band_ok or not box_ok \
            or box_agree < 0.9999:
        raise AssertionError(f"certificate split: band {band_status} (Predictor ok {band_ok}), box {box_status} "
                             f"(ok {box_ok}, agreement {box_agree}), stats {split_stats}")

    clouds_served = int(sizes.sum()) + 1
    emit({
        "phase": "serve", "requests": len(results) + 1, "clouds": clouds_served, "wall_seconds": wall,
        "clouds_per_s": int(sizes.sum()) / wall, "p50_ms": latencies[len(latencies) // 2],
        "p95_ms": latencies[int(0.95 * (len(latencies) - 1))], "json_request_ms": json_ms,
        "mean_device_batch": stats["clouds"] / stats["device_batches"], "stats": stats,
        "label_agreement_min": min(agree), "launches": launches,
        "certificate_split": {"band": band_status, "box": box_status, "box_label_agreement": box_agree,
                              "stats": split_stats},
        "card": card,
    })
    return launches


# Phase 12, soak: the benchmark entry point and the two training soaks.
BENCH_WHOLE = (1, 2, 4)  # the sweep's batches the Predictor runs whole (infer_chunk 8 does not divide them)
BENCH_KERNEL_NAMES = ("pn2_fps_centroids", "pn2_ball_query", "pn2_knn", "pn2_three_interpolate")
BENCH_WINDOW_KERNEL_NAMES = ("pn2_ball_query_tiles_pos", "pn2_window_gather", "pn2_knn_tiles")
SOAK_EPOCHS = 6  # 126 steps and two evaluations
SOAK_FLAGS = ("--accum_steps", "4", "--bq_window", "auto", "--fp_window", "auto", "--train_dtype", "bfloat16",
              "--bf16_min_width", "128")
SOAK_MICRO = 4  # clouds a micro-batch under --accum_steps 4
SOAK_LOSS_BY_EPOCH_5 = 1.0  # the JAX soaks read 0.47-0.69 there
SOAK_EVAL_ACCURACY = 0.90  # the JAX soaks read 0.952-0.966 at step 126
PRECISION_STEPS, PRECISION_EVAL_BATCHES, PRECISION_MIN_WIDTH = 60, 4, 128


def _bench_run(cfg: Config, trace_dir: pathlib.Path, windows: tuple) -> tuple[dict, dict]:
    """``cli.benchmark`` on ``semantic.json`` (``windows``: its window flags),
    its launches reset just before it and read just after; the files, the
    report's kernels and every time held; then the labels of the B = 1, 2
    and 4 forwards against the plain path on the same clouds (labels >=
    99.99 %, the kernel path's logits within 1e-3 of the plain path's), and
    rows 1-4 at those batches against their plain versions."""
    torch.cuda.synchronize()
    cuda.reset_launches()
    t0 = time.perf_counter()
    summary = cli_benchmark.main(["--config_file", str(ROOT / "semantic.json"), "--trace_dir", str(trace_dir),
                                  *windows])
    seconds = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    windowed = bool(windows)
    if windowed and summary["certified"] is not True:
        raise AssertionError("the windowed benchmark profiled without its certificates")
    for path in (summary["trace"], summary["report"]):
        if not pathlib.Path(path).is_file() or pathlib.Path(path).stat().st_size == 0:
            raise AssertionError(f"the benchmark wrote no {path}")
    names = {row.name for row in summary["rows"] if row.line == "device"}
    want = BENCH_KERNEL_NAMES + (BENCH_WINDOW_KERNEL_NAMES if windowed else ())
    if not set(want) <= names:
        raise AssertionError(f"the benchmark's report lacks {sorted(set(want) - names)}")
    times = [summary["profiled"]["batch_time"]] + [rec["batch_time"] for rec in summary["sweep"]]
    if not all(np.isfinite(t) and t > 0 for t in times):
        raise AssertionError(f"the benchmark's batch times {times}")

    sd = convert.from_flax_variables(convert.init_variables(cfg, 9, seed=0))
    mode = {"bq_window": BQ_WINDOW, "fp_window": FP_WINDOW} if windowed else {}
    kernel = Predictor(cfg, sd, device=DEVICE, **mode)
    plain = Predictor(cfg, sd, device=DEVICE, impl="torch", **mode)
    data = cli_benchmark.data_stream(cfg, windowed)
    data(cli_benchmark.PROFILE_BATCH)  # the stream's first draw, the profiled batch
    held = []
    for rec in summary["sweep"]:
        if rec["batch"] not in BENCH_WHOLE:
            break
        x = data(rec["batch"])
        logits, ref = kernel.infer_logits(x), plain.infer_logits(x)
        ref_labels = ref.argmax(-1).int().cpu().numpy()
        agree = float((rec["labels"] == ref_labels).mean())
        if agree < 0.9999 or max_abs(logits, ref) > 1e-3 or not np.array_equal(
                rec["labels"], logits.argmax(-1).int().cpu().numpy()):
            raise AssertionError(f"the benchmark's B={rec['batch']} labels agree with the plain path on {agree}, "
                                 f"logits {max_abs(logits, ref)} off")
        held.append({"batch": rec["batch"], "label_agreement": agree, "max_abs_logit_err": max_abs(logits, ref)})
    if [h["batch"] for h in held] != list(BENCH_WHOLE):
        raise AssertionError(f"the sweep ran {[rec['batch'] for rec in summary['sweep']]}")
    return {
        "windows": list(windows),
        "seconds": seconds,
        "report_ops": len(summary["rows"]),
        "top": [{"name": r.name[:80], "count": r.count, "total_ms": r.total_ms} for r in summary["rows"][:8]],
        "profiled": summary["profiled"],
        "sweep": [{k: v for k, v in rec.items() if k != "labels"} for rec in summary["sweep"]],
        "held": held,
    }, launches


def _soak_batch(cfg: Config, tmp: pathlib.Path) -> np.ndarray:
    """One train batch of the soak's scenes (``tools.train_soak``'s, seed 0):
    the shapes and geometry its steps give the kernels."""
    data_dir = tmp / "soak_scenes"
    data_dir.mkdir()
    train_soak.fabricate(str(data_dir), 80_000)
    ds = SemanticDataset(cfg.num_point, "train", bool(cfg.use_color), cfg.box_size_x, cfg.box_size_y, str(data_dir),
                         seed=0)
    return ds.sample_batch_in_all_files(cfg.batch_size, True)[0].astype(np.float32)


def soak_phase(cfg: Config, seed: int, card: str, report: Report) -> dict:
    """Phase 12: (a) ``cli.benchmark`` on ``semantic.json``, exact and with
    the windows (3072 / 512): ``_bench_run``'s gates, and rows 1-4 at B = 1,
    2 and 4 x 8192 against their plain versions; (c) ``tools.train_soak``
    for ``SOAK_EPOCHS`` epochs in ``SOAK_FLAGS``: finite losses, epoch 5's
    train loss <= 1.0, the step-126 evaluation's accuracy >= 0.90, its
    ``model.pt`` restored; (d) ``tools.bf16_train_soak`` for
    ``PRECISION_STEPS`` steps and ``PRECISION_EVAL_BATCHES`` evaluation
    batches, with ``--min_width 128``: all three modes' losses, accuracies and
    mIoUs finite (its CONVERGENCE lines printed, not gated); (b) rows 1-5 (float32 and
    bfloat16) at the soak's shapes (a micro-batch of 4 and the batch of 16
    clouds of 2048 points, SA 512/128/32/8) and rows 7-10 at the windows (c)
    calibrated (row 10 only where its FP window engaged), on a batch of the
    soak's scenes, against their plain versions. Returns the ``benchmark`` and ``soak`` paths' launches (the
    soaks' together)."""
    t0 = time.perf_counter()
    report.plain_timing = FEW  # the plain FPS at SA1 takes some 200 ms a call
    with tempfile.TemporaryDirectory(prefix="chip_smoke_soak_") as tmp:
        tmp = pathlib.Path(tmp)
        bench, bench_launches = {}, []
        for name, windows in (("exact", ()), ("windowed", ("--bq_window", str(BQ_WINDOW),
                                                           "--fp_window", str(FP_WINDOW)))):
            bench[name], launches = _bench_run(cfg, tmp / f"trace_{name}", windows)
            bench_launches.append(launches)
            torch.cuda.empty_cache()
        for b in BENCH_WHOLE:
            kernel_phase(cfg, seed, report, b)
        torch.cuda.empty_cache()

        # (c) The soak through the train CLI.
        torch.cuda.synchronize()
        cuda.reset_launches()
        t1 = time.perf_counter()
        soak = train_soak.main(["--epochs", str(SOAK_EPOCHS), "--out", str(tmp / "soak"), *SOAK_FLAGS])
        soak_s = time.perf_counter() - t1
        soak_launches = dict(cuda.LAUNCHES)
        summary = soak["train_summary"]
        losses = [loss for epoch in summary["epochs"] for loss in epoch["losses"]]
        train, val = soak["train"], soak["validation"]
        if len(train) != SOAK_EPOCHS or not all(np.isfinite(losses)) or not np.isfinite(
                [r["loss"] for r in train]).all():
            raise AssertionError(f"the soak logged {len(train)} epochs; losses {losses}")
        if train[5]["loss"] > SOAK_LOSS_BY_EPOCH_5:
            raise AssertionError(f"the soak's epoch-5 train loss is {train[5]['loss']}")
        steps = summary["step"]
        if not val or val[-1]["step"] != steps or val[-1]["accuracy"] < SOAK_EVAL_ACCURACY:
            raise AssertionError(f"the soak's evaluations: {[(v['step'], v['accuracy']) for v in val]}")
        soak_cfg = train_soak.soak_config("")
        bq, fp = summary["bq_window"], summary["fp_window"]
        restored = Trainer(soak_cfg, device=DEVICE, bq_window=bq, fp_window=fp)
        restore_checkpoint(tmp / "soak" / "model.pt", restored)  # written at epoch 0 (every 10 epochs)
        if restored.step != summary["epochs"][0]["train_batches"] or not restored.optimizer.state:
            raise AssertionError(f"the soak's model.pt restored at step {restored.step}")
        del restored
        torch.cuda.empty_cache()

        # (d) The precision soak.
        cuda.reset_launches()
        t1 = time.perf_counter()
        precision_flags = ["--steps", str(PRECISION_STEPS), "--eval_batches", str(PRECISION_EVAL_BATCHES),
                           "--min_width", str(PRECISION_MIN_WIDTH)]
        precision = bf16_train_soak.main(precision_flags)
        precision_s = time.perf_counter() - t1
        precision_launches = dict(cuda.LAUNCHES)
        modes = [name for name in precision if name != "convergence"]
        if len(modes) != 3 or not all(
                len(precision[m]["losses"]) == PRECISION_STEPS and np.isfinite(precision[m]["losses"]).all()
                and np.isfinite([precision[m]["accuracy"], precision[m]["miou"]]).all() for m in modes):
            raise AssertionError(f"the precision soak ran {modes}")
        soak_path = _sum_launches(soak_launches, precision_launches)
        want = ["fps_centroids", "ball_query", "knn", "three_interpolate", "three_interpolate_grad",
                "three_interpolate_bf16", "three_interpolate_grad_bf16"]
        want += ["ball_query_sliced", "ball_query_sliced_pos", "window_gather"] if bq is not None else []
        want += ["knn_sliced"] if fp is not None else []
        if any(soak_path.get(name, 0) == 0 for name in want):
            raise AssertionError(f"the soaks launched {soak_path}, want every one of {want}")
        torch.cuda.empty_cache()

        # (b) The kernels at the soak's shapes, on a batch of its scenes.
        x16 = _soak_batch(soak_cfg, tmp)
        for b, x in ((SOAK_MICRO, np.ascontiguousarray(x16[::16 // SOAK_MICRO])), (soak_cfg.batch_size, x16)):
            levels = kernel_phase(soak_cfg, seed, report, b, x=x)
            grad_kernel_phase(levels, seed, report)
            bf16_kernel_phase(levels, seed, report)
            if bq is not None:
                window_kernel_phase(soak_cfg, seed, report, b, x=x, bq_window=bq, fp_window=fp)
            del levels
        torch.cuda.empty_cache()
    report.plain_timing = None
    emit({
        "phase": "soak",
        "benchmark": bench,
        "train_soak": {
            "flags": ["--epochs", str(SOAK_EPOCHS), *SOAK_FLAGS],
            "seconds": soak_s,
            "steps": steps,
            "bq_window": bq,
            "fp_window": fp,
            "train": [{k: r[k] for k in ("step", "loss", "accuracy", "learning_rate", "bn_decay")} for r in train],
            "validation": [{k: r[k] for k in ("step", "accuracy", "miou")} for r in val],
            "checkpoints": soak["checkpoints"],
            "median_step_ms": [statistics.median(e["step_ms"][1:]) for e in summary["epochs"]],
            "launches": soak_launches,
        },
        "precision_soak": {
            "flags": precision_flags,
            "seconds": precision_s,
            **{m: {"final_loss": precision[m]["losses"][-1], "accuracy": precision[m]["accuracy"],
                   "miou": precision[m]["miou"]} for m in modes},
            "convergence": precision["convergence"],
            "launches": precision_launches,
        },
        "phase_seconds": time.perf_counter() - t0,
        "card": card,
    })
    return {"benchmark": _sum_launches(*bench_launches), "soak": soak_path}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=None, help="also write every record here as JSON")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    full_float32()
    card = card_line()
    cfg = Config.from_json(ROOT / "semantic.json")

    t0 = time.perf_counter()
    paths = build.build()
    build_s = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in path.with_suffix(".log").read_text().splitlines() if "Used" in ln or "spill" in ln]
        for name, path in paths.items()
    }
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas, "torch": torch.__version__, "cuda": torch.version.cuda})

    report = Report(card)
    chunk_levels = kernel_phase(cfg, SEED, report, CHUNK)
    train_levels = kernel_phase(cfg, SEED + 100, report, BATCH)
    grad_kernel_phase(chunk_levels, SEED, report)
    grad_kernel_phase(train_levels, SEED, report)
    bf16_kernel_phase(chunk_levels, SEED, report)
    bf16_kernel_phase(train_levels, SEED, report)
    window_kernel_phase(cfg, SEED, report, CHUNK)
    window_kernel_phase(cfg, SEED + 100, report, BATCH)
    msg_kernel_phase(cfg, chunk_levels, SEED, report)
    msg_kernel_phase(cfg, train_levels, SEED, report)
    window_kernel_phase(cfg, SEED, report, CHUNK, arch="msg")
    window_kernel_phase(cfg, SEED + 100, report, BATCH, arch="msg")
    op_surface_kernel_phase(cfg, chunk_levels, report)
    op_surface_kernel_phase(cfg, train_levels, report)
    windowed_stress_phase(cfg, SEED, report)
    repaired_phase(cfg, SEED, report)
    probes_launches = probes_phase(SEED, report)
    del chunk_levels, train_levels
    torch.cuda.empty_cache()
    paths = {"probes": probes_launches, "predict": predict_phase(cfg, REQUESTS, BATCH, SEED, card)}
    torch.cuda.empty_cache()
    paths["train"], train_row = train_phase(cfg, SEED, card)
    torch.cuda.empty_cache()
    paths["predict_windows"] = predict_windows_phase(cfg, REQUESTS, BATCH, SEED, card)
    torch.cuda.empty_cache()
    paths["train_windows"] = train_windows_phase(cfg, SEED, card)
    torch.cuda.empty_cache()
    paths.update(predict_bf16_phase(cfg, REQUESTS, BATCH, SEED, card))
    torch.cuda.empty_cache()
    paths["train_bf16"] = train_bf16_phase(cfg, SEED, card, train_row)
    torch.cuda.empty_cache()
    paths["predict_msg"] = predict_phase(cfg, REQUESTS, BATCH, SEED, card, arch="msg")
    torch.cuda.empty_cache()
    paths["train_msg"], msg_train_row = train_phase(cfg, SEED, card, arch="msg")
    torch.cuda.empty_cache()
    paths["predict_windows_msg"] = predict_windows_phase(cfg, REQUESTS, BATCH, SEED, card, arch="msg")
    torch.cuda.empty_cache()
    paths["train_windows_msg"] = train_windows_phase(cfg, SEED, card, arch="msg")
    torch.cuda.empty_cache()
    paths.update(predict_bf16_phase(cfg, REQUESTS, BATCH, SEED, card, arch="msg", modes=MSG_BF16_MODES))
    torch.cuda.empty_cache()
    paths["train_msg_bf16"] = train_bf16_phase(cfg, SEED, card, msg_train_row, arch="msg", steps=MSG_BF16_STEPS)
    torch.cuda.empty_cache()
    paths.update(sa_tails_phase(cfg, SEED, card, report))
    torch.cuda.empty_cache()
    paths.update(cli_phase(SEED, card, train_row["median_ms"]))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_prep_") as tmp:
        prep_launches, prep_cfg = prep_phase(SEED, card, pathlib.Path(tmp))
        paths.update(prep_launches)
        torch.cuda.empty_cache()
        paths.update(convert_phase(SEED, card, pathlib.Path(tmp), prep_cfg))
    torch.cuda.empty_cache()
    paths["op_surface"] = op_surface_phase(card)
    torch.cuda.empty_cache()
    paths["densify"] = densify_phase(SEED, card, report)
    torch.cuda.empty_cache()
    paths["dist"] = dist_phase(cfg, SEED, card)
    torch.cuda.empty_cache()
    paths.update(kitti_phase(SEED, card, report))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="pn2_export_") as export_root:
        paths["export"], served_state = export_phase(cfg, SEED, card, pathlib.Path(export_root))
        torch.cuda.empty_cache()
        paths["serve"] = serve_phase(cfg, SEED, card, pathlib.Path(export_root), served_state)
    torch.cuda.empty_cache()
    paths.update(soak_phase(cfg, SEED, card, report))
    kernels = report.kernels_line(paths)

    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "rows": report.rows, **kernels}, indent=1))
    print(card, flush=True)
    emit(kernels)
    emit({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
