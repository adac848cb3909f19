#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``sparknet_tpu_torch``).

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper
card, ``nvcc`` and PyTorch built for CUDA. Phases, each printed on its
own lines:

1. card: the device name and the ``nvidia-smi`` name / power-limit line;
2. build: every kernel of ``sparknet_tpu_torch/ops/csrc`` compiled from
   source (one ``nvcc`` per file, all started together), with timings
   and the compiler's register/shared-memory report; then the SASS
   (``cuobjdump -sass``) of the flash forward, dq and dk/dv must hold
   ``HGMMA``, the tensor cores' warpgroup product, in every tensor-core
   instantiation (dq at f32 D 256 and dk/dv at D 256, f32 and bf16, are
   the SIMT kernels, which must not), and each of their instantiations'
   shared memory, registers and blocks per SM are printed; the LRN quad
   kernels must access global memory only in 16- or 8-byte vectors, the
   staged ones in none;
3. kernels: each of the three LRN kernels (inference forward, training
   forward with its f32 residual d, backward) held against its plain
   PyTorch version on the card (tolerances below), odd and even window
   sizes, ragged M, f32 and bf16, AlexNet's shapes at batches 1, 8, 32
   and 128 (one alexnet-local worker's rows), on both of its routes: the quad route (C a multiple of 4 up to
   1024, operands 16-byte aligned) and the staged route (C 97 and 1500,
   x and g or d 4 bytes past a 16-byte boundary); each case prints the
   route each kernel took and must take the one it names. Then, at the
   shapes the train path gives it (the TEST batch of 50 for the
   inference kernel, AlexNet's batch of 256 for the training kernels)
   and at serving bucket 32, held again against the plain version on
   the same inputs and timed by single calls, back to back and by
   ``torch.profiler``, beside its memory/compute bound (its share by
   single calls and by device time), the plain version and a one-call
   PyTorch yardstick; and all three at GoogLeNet's shapes (norm1 56x56
   x 64, norm2 56x56 x 192, its train batch of 32 and test batch of 50,
   f32 and bf16), held against their plain versions on the quad route
   (in the cases above) and timed by single calls and by the profiler's
   device time beside their byte bounds;
4. flash-kernels: each of the three flash-attention kernels (forward:
   o and lse; dq; dk/dv) held against its plain PyTorch version on the
   card over 17 cases, f32 and bf16 (one at the BertApp run's shapes,
   32 x 12 heads x 128 x 64, and two at one bert-processes rank's, 16 x
   12 x 128 x 64 from strided QKV views, dropout 0 and 0.1): causal or not, offsets, a kv mask with a
   fully padded row (whose o, dq, dk and dv must be exactly 0), ragged
   (100, 77) lengths, head dims 16, 32, 64 and 256, dropout 0.1 and
   0.5, and q, k, v as BERT's strided views of one (b, s, 3, h, d) QKV
   product. Then dropout's statistics: the keep rate (v = 1, the mean
   output within 0.05 of 1) and the forward/backward mask identity (v =
   I with S = D: dv equals the forward's dropped probabilities
   transposed times dO; at D 128 the tensor-core dk/dv kernel runs it).
   Then each kernel at BERT-base's shapes (H 12, D 64, f32, attention
   dropout 0.1; B 32 x S 128, and B 8 x S 512),
   held against its plain version and timed with CUDA events beside its
   bound, the plain version and one call of
   ``F.scaled_dot_product_attention`` (its autograd backward asked for
   dq alone, or for dk and dv, as the yardsticks of the two backward
   kernels). Each kernel, and SDPA beside it, is also timed by CUDA
   events around calls made back to back and by ``torch.profiler``
   (the card's busy time alone, without the wrapper's host time); each
   stands beside the f32 CUDA-core bound, the function's own products at
   the TF32 rate and its design's tensor-core bound (3 + 3, 3 + 3 + 3
   and 3 + 3 + 3 + 3 TF32 terms); and all three are held against their
   plain versions and timed in bf16 at B 32 x S 128 as well;
5. serving: full-width ``bvlc_alexnet`` (random weights from seed 0)
   served on the card through InferenceEngine -> MicroBatcher -> HTTP
   InferenceServer; /healthz, /classify (1, 3, 8 rows), /metrics, then
   32- and 40-row calls through the batcher (40 rows exercise chunking).
   Every answer's top-5 is held against the same weights run by the port
   on the CPU, and the LRN kernel must have launched twice per bucket
   call;
6. profile: a bucket-32 forward split into upload, forward and download
   (CUDA events), then ``torch.profiler`` over bucket-32 forwards: device
   time by kernel, the LRN kernel's share, and the device's idle share;
7. load: 200 requests from 4 closed-loop clients through the batcher
   (the ``tools/serve --bench`` path): requests/s and latency;
7a. serving-tier: one serving process's tier features. Full-width
   ``bvlc_alexnet`` (seed 0) in f32, bf16 and int8, each engine on the
   card against the same engine on the CPU: the resident weights (int8:
   the int8 weights and scales) equal bit for bit; bucket calls of 1, 5
   (padded to 8) and 32 rows, the 5 padded rows bit-identical to the
   same rows beside 3 real ones; f32 top-5 as the serving phase holds
   it, int8 top-5 sets equal on >= 99% of 32 rows; on one shared batch
   of 8 rows each int8 layer's int32 accumulator, on the CPU's own layer
   input, card = CPU exactly, and the fc8 logits within half the CPU's
   own int8 error against f32 (int8; TIER_INT8_SHARE) or 1e-2 relative
   L2 (bf16); two LRN inference launches a bucket call; the resident
   bytes and the median ms a bucket call printed, and the int8 against
   f32 top-1 agreement on 256 rows printed, not held. Then 4 closed-loop
   clients on ``/classify`` (one seeded row a request, a process of this
   script, ``--tier-client``) while ``/reload`` swaps to a solverstate
   the phase wrote, is refused a torn one (409, the generation stays),
   rolls back, and is refused a second rollback (409); then the server's
   ``--snapshot-watch`` skips a torn newer file and serves an intact one
   (seconds from its rename printed): 0 failed requests, each client's
   generations never decreasing, each answer's top-5 the CPU engine's
   on its generation's weights, two LRN launches a bucket call. The
   int8 engine's ``/reload`` of the written state captures every scale
   anew, = the CPU's quantization of the file bit for bit. Last,
   ``char_rnn_deploy`` (seed 0) through ``/generate``: its rows across
   widths 1-32 against width 4's, bit for bit or not (printed); a hit
   bit for bit the cold replay; the CPU engine's answer within 1e-4
   relative L2; a prefix mismatch rebuilt; a hot swap makes the session
   ``stale_gen``; the session load generator (8 sessions, Zipf 1.1, 4
   steps, 64 requests) with 0 failed requests;
7b. router-tier: the serving tier across processes, full-width
   ``bvlc_alexnet`` from a seed-0 solverstate the phase writes.
   ``python -m sparknet_tpu_torch.tools.serve --replicas 2 --quant int8
   --quant-ab 0.5`` as a process of its own session (beside the tier
   below coming up, and ended before its traffic starts): its port file once
   both replicas answer healthy (seconds, each replica's ``warmup_s`` and
   compile-cache library counts printed; the kernels come from the build
   phase's directory), replica 0 f32 and replica 1 int8, an answer of
   each precision held against the CPU engine of that precision, then
   SIGTERM: exit 0 and no replica process left. The same tier built
   by the tool's ``build_tier`` in this process (its router has no HTTP
   route for ``roll_back``), under 4 closed-loop clients (a
   ``--tier-client`` process; one seeded row a request, each with its
   own 60 s timeout and no client retry, the answering replica read from
   ``X-Sparknet-Replica``): (1) SIGKILL replica 1 through the pid of its
   port file while it holds a request: the retry hops equal the
   ``retry:`` lines (at least one), the pool respawns it and it rejoins
   as int8, and ``/traces`` holds a retried request's failed hop, its
   retry hop and the replica's ``server.request`` span (``reqtrace``'s
   coverage printed); (2) two rolling ``/reload`` calls of written
   solverstates, replica 0's generation moving before replica 1's, the
   least healthy width (sampled every 20 ms) at least 1, each roll's ms
   printed; (3) a torn solverstate stops the roll at replica 0 (502),
   generations unchanged; (4) ``roll_back``, then SIGKILL replica 0: its
   respawn boots on the boot weights and is re-synced onto the rolled
   back ones before it rejoins. ``/dash`` carries the serving-tier
   section. 0 failed requests; every answer's top-5 held against the CPU
   engine of its precision on the weights its replica could have served
   between its send and its receive (both sides of a roll in flight,
   only the new after it): f32 as the serving phase holds it, int8 top-5
   sets on at least 99% of the int8 answers; ``router_quant_answers``
   within 1 of Bresenham's count plus the answers made while a replica
   was down (the A/B's fallbacks); no replica process left alive. The
   phase's seconds are printed against a 150 s budget (not a gate);
8. grads: one training step of full-width ``bvlc_alexnet`` (the
   train_val net with ``dropout_ratio: 0``, random weights from seed 0)
   at batch 8 on the card against the same step on the CPU: the loss
   and every gradient tensor, held with cuDNN off on a batch where both
   take the same max-pool and ReLU branches everywhere (tolerances
   below). The card runs the two training kernels inside autograd;
8a. googlenet-grads, resnet50-grads: one training step of full-width
   GoogLeNet and ResNet-50 (the port's fillers from seed 0, ResNet-50's
   residual branches' last Scale at 0.2; no Dropout) at batch 8 on the
   card (cuDNN on, the path the app trains on) against the same step on
   the CPU: every blob, the loss, the new BatchNorm state and every
   gradient (tolerances below); the ReLU units and max-pool windows that
   took another branch are counted; GoogLeNet's card step launches each
   training LRN kernel twice;
9. train: ``ImageNetApp`` through ``main([...])``: ``--arch alexnet
   --synthetic`` at the prototxt's batch of 256, 227 crop, 1000 classes,
   f32, 20 iterations (test_iter 2 at test_interval 20, display 5; the
   app's default feed: the C++ loader, ``--prefetch 2``), then
   the final solverstate reloaded. Each training kernel must launch
   exactly twice per iteration, the inference kernel twice per test
   batch;
10. train-profile: ``Solver.step`` on one device-resident batch of 256,
   f32 and ``--bf16``, each both ways: eager (the same step function
   without a graph, ``SPARKNET_FUSED_STEP=0``) and one captured CUDA
   graph an iteration (the default): ms per step by CUDA events,
   images/s, peak device memory allocated and the memory held (the
   graph's private pool included), then ``torch.profiler`` over 3 steps
   after one it traces and drops (a window's first step loses trace
   records): device time by kernel, the LRN kernels' share, the
   device's idle share (against the profiled window and against the
   unprofiled step), the device operations a step, the host's launches
   a step by kind (kernels, graph replays, copies, fills), and the LRN
   and flash kernels the profiler saw against the launch counters'
   increase (through the graph replay by replay, grouped by the
   ``cudaGraphLaunch`` each belongs to; eager summed over the 3 steps;
   equal, or the phase fails: a replay adds its capture's count to the
   counters, and this shows that the graph ran those kernels);
10a. googlenet, resnet50, vgg16: ``ImageNetApp`` through ``main([...])``
   with ``--arch`` each at its prototxt's batch (32, 32, 64; test 50,
   25, 50), f32, 20 iterations of its zoo solver (cut from 2.4 M, 450 k
   and 370 k; test_iter 2, display 5, a snapshot at the end) on the
   512-image synthetic set through the app's default feed. The test
   outputs' loss heads must be finite (the display line reads a top
   named ``loss``, as the JAX app's does, and these nets have none);
   images/s from the last ``speed:`` line; GoogLeNet launches each
   training LRN kernel twice an iteration and the inference kernel twice
   a test batch, the others none; the solverstate reloads with finite
   params and, for ResNet-50, 53 finite BatchNorm states with var >= 0.
   Then the resident step, f32 and ``--bf16``, eager and through the
   graph, as train-profile;
11. bert-grads: one training step of full-width BERT-base (random
   weights from seed 0, no hidden dropout, attention dropout 0.1 with
   the same seeds on both devices) at batch 2 x 128 on the card against
   the same step on the CPU: the loss and every gradient tensor; the
   card step must launch each flash kernel 12 times;
12. bert-train: ``BertApp`` through ``main([...])``: ``--config base``
   at batch 32 x 128 on the synthetic corpus, 20 iterations in f32
   (display 5, snapshot 20), then 10 with ``--bf16``; each flash kernel
   must launch exactly 12 times per iteration. The final solverstate is
   reloaded and ``Solver.test`` runs 2 batches: 12 forward launches
   each, no backward;
13. bert-profile: ``Solver.step`` of BERT-base on one device-resident
   batch of 32 x 128, f32 and ``--bf16``, eager and through the graph,
   as train-profile (the flash kernels' share);
13a. fused-step: the train step as one captured CUDA graph against the
   eager step, on cifar10_quick (batch 100), AlexNet (256, the LRN
   kernels, Dropout, device augmentation: the raw uint8 batch and its
   plan are the graph's inputs), ResNet-50 (32, BatchNorm state through
   the graph) and BERT-base (32 x 128: the three flash kernels, hidden
   and attention dropout, AdamW, poly with warmup), each built as its app
   builds it, f32, with cuDNN's and PyTorch's deterministic algorithms.
   From one snapshot of the fresh solver and 8 host batches of its
   app's feed: 8 eager iterations twice (their spread: 0 when they
   agree bit for bit), 8 through the graph with a save at iteration 4.
   Params,
   net state, optimizer slots and the generator's state: the graph's
   against the eager run's bit for bit (within the spread, and 1e-2
   relative L2, where two eager runs differ); each iteration's rate the
   eager run's bit for bit and ``learning_rate`` on the host within 1e-6;
   each step's metrics the eager run's and unchanged after the next
   step; the kernel launches equal, and the graph run's replays after
   its capture traced by ``torch.profiler``, the first dropped: the LRN
   and flash kernels of each replay equal to the counters' increase a
   replay. The save restored into a fresh solver
   and 4 more iterations through a new graph: the straight run's.
   ``scan_steps`` of the first batch against 8 eager steps on it;
14. cifar-app: ``CifarApp`` through ``main([...])``: the port's
   cifar10_quick solver at its full net and batch of 100, the 5,000-image
   synthetic set (mean file absent: the full set's mean), 300
   iterations (test_iter 10 before the loop and at the end, display
   50). The test loss must fall below half its first value, the last
   display loss below the first test loss, and the last test accuracy
   reach chance (0.1) plus 0.5; the last ``speed:`` line's steps/s and
   images/s are printed; then the app's resident step eager and through
   the graph, as train-profile;
15. local-sgd: ``ParallelSolver(mode="local", tau=10)`` on cifar10_quick
   at batch 100 over 4 workers on cuda:0, once for each wire format
   (``--grad-compress`` none, bf16, int8): one round on the card held
   against the same round on the CPU from the same weights and batches
   (each worker's weights, then the average within what the wire
   format's flipped roundings can move it);
   9 more rounds, ms per round and the average's share (host clock,
   synchronized), the round loss must fall below half its first value
   and the weights stay finite. With none, one round under
   ``torch.profiler`` (the card's busy time against the round's wall
   time, and the launches), then one more round's worker weights must
   all differ, and their average under a bucketed config must be
   bit-equal to the leaf-by-leaf one on the card. Then
   ``mode="sync"`` over the same 4 workers, 10 steps, against one
   worker (``Solver``) on the same global batches. Last, three faults
   planted on the card (a row split shifted by one row, twice the
   learning rate, a sum in place of the mean) in the first local round
   and in the 10 sync steps: each must read above the 10-step limit
   that the sound runs read below;
16. alexnet-local: ``ImageNetApp``'s ``build`` with ``--parallel local
   --tau 2`` over 2 workers on cuda:0 (``workers=``), full-width
   ``bvlc_alexnet`` at batch 256 (128 a worker), 4 iterations through
   ``train_loop`` (test_iter 2 before and after): the display losses
   finite, each LRN training kernel launched twice per worker step (16
   each), the inference kernel twice per test batch, and the final
   solverstate's slots carrying the worker axis (2, 11, 11, 3, 96) and
   restoring equal;
16a. multiprocess: SparkNet one worker a process, each rank a process of
   this script (``--rank-job``) started through ``SPARKNET_COORDINATOR``,
   ``SPARKNET_NUM_PROCESSES`` and ``SPARKNET_PROCESS_ID``, with a hard
   timeout (MP_TIMEOUT; a rank that fails or outlives it fails the
   phase, and every rank left is killed). First 2 ranks on cuda:0 with
   their collectives over gloo (``initialize(backend="gloo")``, the
   one-card rehearsal): which collectives gloo runs on card tensors (SUM
   and MAX in f32, SUM in int32, all_gather; each must); ResNet-50
   ``--parallel sync`` built by ImageNetApp's ``build`` at the global
   batch of 32 (16 rows a rank, lossless: each BatchNorm over the global
   batch), 5 steps, held against one ``Solver`` on the whole batch
   (``_zoo_weights``): the step-1 loss and BatchNorm state within 1e-4
   relative L2, the weights after 5 steps within 1e-2, the ranks'
   weights identical by hash; AlexNet ``--parallel local --tau 2`` at
   batch 256 (128 rows a rank), 4 iterations and one test batch on each
   rank's rows, held against alexnet-local's one-process 2-worker
   solver on the same global batches (the same Dropout seeds: the first
   round's loss within 1e-4, the weights within 1e-2 relative L2), each
   rank launching the LRN kernels 2 / 8 / 8 times (counted from 0 in
   each rank, summed into the kernels line), the round's average timed.
   Then one NCCL rank at world size 1 and one all-reduce. With two or
   more cards: ``nvidia-smi topo -m``; the same two runs over NCCL, one
   process a card; cifar10_quick ``--parallel local`` tau 10 at 4 NCCL
   processes (25 rows each), 10 rounds for each wire format: ms a round,
   the average's ms and share, each card's idle share over one profiled
   round, beside the same rounds of the one-process ParallelSolver over
   the same cards; and CifarApp ``main`` launched as 2 NCCL processes:
   only rank 0 prints its ``Iteration`` lines, its snapshot restores a
   one-process solver. ResNet-50 sync over 2 workers in one process
   (each BatchNorm over the global batch: one forward over both
   workers' rows on cuda:0; with two cards, lock-step threads on cuda:0
   and cuda:1) is held against the 2 processes' first step: the loss
   and the BatchNorm state within 1e-4 relative L2. With one card, one
   line says the NCCL part did not run;
16b. bert-processes: BertApp's ``build`` for ``--config base`` at the
   global batch of 32 x 128, f32, as 2 ranks on cuda:0 over gloo (16
   rows a rank, the rows of global batches of BertApp's one-process
   feed): ``--parallel sync`` with dropout off, 3 steps, held against
   one ``Solver`` on each whole batch (the first loss within 1e-4
   relative, the weights after 3 steps within 1e-2 relative L2, the key
   biases, whose gradient is 0 but for rounding, below 1e-6 on both
   sides), then the sync step timed three ways (each 4 MB bucket
   started inside the backward, the default; the same buckets started
   after it; one all-reduce a leaf after it, the reduction before the
   buckets), in the order A B C C B A, and each reduction alone;
   ``--parallel local --tau 2``, 4
   iterations, held the same way against the one-process 2-worker
   ``ParallelSolver`` with the same dropout seeds; the ranks' weights
   identical by hash; the flash kernels counted from 0 in each rank
   (forward, dq and dk/dv, 12 an iteration, 156 each; the sync step
   timed once a reading) and summed
   into the kernels line. Then cifar10_quick ``--parallel local --tau
   auto`` over 2 ranks, 12 rounds: every rank the same τ every round.
   With two or more cards the BERT runs over NCCL (one process a card)
   and ResNet-50 sync at the global batch of 32 timed the same three
   ways;
17. feed: the 2,048-image synthetic set packed by
   ``tools/pack_records.py``; the first 8 batches (256 227x227 f32
   crops) of 4 worker processes, of the pinned side-stream prefetch
   (its side stream slowed so that the staging thread runs a ring ahead
   of the uploads, each batch copied back at once without waiting), of
   device augmentation on the card and of the pack held bit for bit
   against the serial feed's; the prefetch check run again with each of
   its two races planted (the consumer not waiting on the upload's
   event; a pinned buffer refilled before its upload left it), each of
   which it must catch; two constructions of the C++ loader against
   each other; ``nproc`` and ``df /dev/shm``. Then ``ImageNetApp`` through
   ``main([...])`` at batch 256, 6 iterations in chunks of 3 (a test
   batch between), through each train feed path: serial with
   ``--prefetch 0`` and 2, ``--data-workers 4`` and cores - 1,
   ``--native-loader on``, ``--device-augment``, ``--data-format
   packed``, and packed with ``--data-cache`` twice (cold, then warm:
   every batch a hit). Each prints its chunks' images/s beside the
   resident step's, its ``input pipeline:`` / ``data cache:`` lines and
   whether the step waited on the host; each must launch the LRN kernels
   6 / 12 / 12 times, and read 0 pickle fallbacks;
18. caffe-native: Caffe's own data and weights. An LMDB of 1,280 raw
   Datums (256x256x3, ``synthetic_imagenet`` seed 0, ~252 MB) and a TEST
   LMDB of 256 (seed 1) written by the port's ``write_lmdb`` (MB/s
   printed); the seed-0 AlexNet weights exported by
   ``Solver.export_weights`` (~244 MB) and read back by
   ``load_caffemodel``, every blob equal, then loaded by
   ``Solver.load_weights``, every param the exported one (seconds of
   each). Then ``ImageNetApp`` at batch 256 as processes of this script
   (``--app-job``: deterministic algorithms, the graph step, f32): its
   train_val's Data layers name the two LMDBs, ``--weights`` the
   .caffemodel, ``--seed 1``, 12 iterations, a snapshot every 4,
   ``SPARKNET_SNAPSHOT_KEEP=2``, one test batch at 0 and at 12, 3 feed
   workers. Run A runs uninterrupted (its LRN launches 4 / 24 / 24
   asserted, its ``speed:`` images/s and the ms of each
   ``save_or_skip`` printed, its chain pruned to 8 and 12); run B, beside
   it on the card, gets SIGTERM once it displays iteration 5 and must
   print ``SIGTERM: preempted at iteration N; snapshot written ...``,
   keep the snapshots 4 and N and exit 0; its newest solverstate is then
   cut in half, and run C (B relaunched with ``--auto-resume``) must
   warn, fall back to 4 and run to 12: its params, net state, optimizer
   slots, generator and iteration equal run A's bit for bit. Then
   ``InferenceEngine.from_files`` on the AlexNet deploy net from the
   .caffemodel and from the .npz of the same weights, and from run A's
   final solverstate and its .npz twin: each pair's bucket-32 outputs
   equal bit for bit (8 LRN launches). Last, with PIL and h5py made
   unimportable, ImageData, an encoded-Datum LMDB, the ImageNet folder
   and tar layouts and HDF5Data each raise naming the package when the
   dataset is built.
19. chaos: fault injection in one process, gated on correctness only.
   ImageNetApp AlexNet (full width, f32, deterministic) at batch 128 on
   1,024 synthetic images (its TEST set, 1/8 of that, is one batch), 12
   iterations, a snapshot every 4, ``SPARKNET_SNAPSHOT_KEEP=2``, one
   test batch at 0 and at 12, the Python feed in 2 forked workers, as
   three ``--app-job`` processes: run A clean and run B beside it,
   traced (``--trace``), under ``--chaos``
   (``pipeline.worker_crash@batch=3:worker=0``,
   ``pipeline.slow_batch@batch=6:delay_ms=300``,
   ``io.enospc@site=snapshot:index=0``,
   ``snapshot.partial_write@iter=12``; the probe batch 0 is the feed
   owner's, so batch 3 is worker 0's and batch 6 worker 1's). B's
   ``chaos:`` line must fire ``io.enospc`` and
   ``snapshot.partial_write`` once each and recover
   ``pipeline.worker_respawn`` once (the workers' own fires die with
   them, as in the JAX package), its respawn line name worker 0 and
   exit 3, its trace hold batch 6's ``pipeline.produce`` span at 300 ms
   or more (the slow batch's sleep is inside it; the span's time beyond
   the other batches' median is printed), its iteration-4 snapshot be
   skipped and counted in
   ``snapshot_skipped{errno=enospc}`` and ``io_faults``, its
   iteration-8 solverstate equal A's bit for bit and its iteration-12
   file be torn; run C, B relaunched with ``--auto-resume`` and no plan,
   must warn, fall back to 8 (one ``snapshot.fallback_restore``) and
   end at 12 equal to A bit for bit. LRN launches 4/24/24 for A and B,
   2/8/8 for C; each run's seconds and the feed's consumer waits are
   printed. Meanwhile, in a thread of this process (C goes as soon as B
   has ended, beside it), the AlexNet server and batcher
   (seed 0, buckets 8 and 32) are built under
   ``serve.conn_drop@every=5,serve.engine_stall@every=7:delay_ms=100``:
   4 client threads (the port's ``Client``, retries on) send 40 requests
   of 8 integer rows; 0 may fail, each top-5 must equal the CPU
   engine's, the drops must be the POST indices ``every=5`` selects and
   each cost one retried attempt, the stalls the flush indices
   ``every=7`` selects; then one request straight to the batcher at a
   stalled flush with a 50 ms deadline is shed before compute. The plan
   is installed just before the server is built and cleared in
   ``finally``; nothing else in this process writes through ``safeio``
   meanwhile. Then, with no plan, ``SPARKNET_DISK_MIN_FREE_MB`` above
   the free space makes ``safeio.atomic_write`` refuse before staging
   (counted). The phase ends with no plan, no ``SPARKNET_CHAOS`` and no
   storm in this process. The supervised runs of item 20a start at the
   phase's start, beside A and B.
20. catalogue: Caffe's whole layer catalogue, under deterministic
   algorithms. Each of the 36 layer types the port added after the
   image nets' 13 (42 cases with their options) runs forward and
   backward on the card and on the CPU, the same port function on the
   same seeded inputs, params (the fillers' draws; seeded normals for a
   constant fill) and output cotangents: outputs and every
   input and param gradient held by relative L2 (1e-5, or 1e-4 for long
   sums, products and recurrences; each reading printed with its
   tolerance). The shapes: AlexNet's conv5 activations at batch 256
   (256 x 13 x 13 x 256) for the element-wise, routing and MVN layers
   and a registered Python layer; the losses at batch 256 over 1000 or
   4096 features; FCN-32s's head (``upscore``: Deconvolution 21 -> 21,
   kernel 64, stride 32, no bias, on an (8, 16, 16, 21) score map; then
   ``score``: Crop axis 2, offset 19, to 500 x 500); SPP of height 3 and
   Im2col 3 x 3 on (64, 13, 13, 256); Embed, LSTM and RNN at char_rnn's
   widths (vocabulary 96, embedding 16, hidden 32) over T 64 x N 256
   with sequence restarts. Then ``char_rnn_deploy.prototxt`` forward at
   its declared T 16 x N 1 and at N 256, card vs CPU; a char_rnn
   training net (its (T, N, 96) logits reshaped to (T*N, 96) for
   SoftmaxWithLoss) through ``Solver.step`` at T 64 x N 64, 12
   iterations and 20 timed ones, the captured graph against the eager
   step (``_fuse_host`` off) bit for bit (losses, params, slots,
   generator), with ms a step both ways; a step whose Python layer
   reads the card from the host, whose capture fails three times: each
   raise leaves ``Solver._graph`` None and, after ``empty_cache()``, the
   reserved memory at its level before the capture. And LeNet: MNIST
   idx files of 10,000 and 1,000 digits (a class-dependent pattern and
   seeded noise) through ``convert_mnist_data``, then ``python -m
   sparknet_tpu_torch.tools.caffe train --solver=lenet_solver.prototxt
   --max-iter 300`` as a process in their directory (test_iter 10), whose
   last TEST accuracy must reach 0.5 (chance 0.1) and whose last
   ``speed:`` line is printed, and ``caffe test`` of its snapshot, which
   must print the same accuracy. LeNet comes first, with no other work
   of this phase on the card; its ``caffe test`` process runs beside the
   checks above. No kernel of ``ops/csrc`` launches. The supervised runs
   of item 20a run beside the whole phase.
20a. supervise: supervised recovery for training, checked after the
   catalogue (``--phase supervise``: with a run A of its own). Each run
   is ``python -m <app> ... --supervise`` in a session of its own, the
   supervising process, whose children start with a ``sitecustomize``
   module that turns TF32 off and deterministic algorithms on, as the
   app jobs run. S: ImageNetApp on run A's command line under
   ``SPARKNET_CHAOS=supervisor.child_crash@iter=8,supervisor.resume_torn@index=0``:
   generation 0 snapshots at 4 and 8 and hard-exits (9) at the boundary
   at 8 with a ``chaos.child_crash`` record (last completed iteration
   8) whose flight dump holds the snapshot lines; the supervisor tears
   the file for 8 and its walk falls back to 4 (``supervisor:`` line
   exactly ``{"restarts": 1, "torn_snapshots": 1, "verified_resumes":
   1}``); generation 1 (no plan, ``--auto-resume``) warns of the torn
   8, resumes at 4 and runs to 12, where its solverstate must equal run
   A's bit for bit (params, net state, optimizer slots, generator,
   iteration). G: CifarApp's cifar10_quick, ``--parallel local --tau
   10``, as a gang of 2 processes on cuda:0 over gloo
   (``SPARKNET_DIST_BACKEND``), heartbeat timeout 8 s, under
   ``multihost.peer_silence@worker=1:tick=3`` (and a 40 ms slow batch,
   so that the silence ends generation 0, not ``max_iter``),
   ``SPARKNET_SUPERVISE_DEGRADE_AFTER=1``: generation 0's rank 0 exits
   43 with a ``peer_failure`` record and is blamed, rank 1 ends as an
   error or a signal, and generation 1 runs at width 1 with
   ``SPARKNET_ELASTIC_RESUME=1`` to ``max_iter`` (the decisions the JAX
   supervisor takes on those exits, ``tests/test_torch_supervisor.py``).
   Both must exit 0 and leave no process of their session; the
   supervising process must never appear among the card's compute
   processes (``nvidia-smi``) nor hold a ``/dev/nvidia*`` file, while a
   child of it does. The children's LRN launches are their own
   processes', not in the kernels line.
21. telemetry: observability and remat, f32 without TF32 unless bf16 is
   named. ImageNetApp (AlexNet at batch 256, 12 iterations, a test
   every 6) as an ``--app-job`` process with ``--trace`` and
   ``--profile-dir`` and the Python feed in 2 forked workers (the
   merged Chrome trace parses and holds the phases and both workers'
   spans; the timeline's rows are at least 90% of the loop's wall; the
   ``lrn_*`` kernels of the profiler's trace equal the launch counters'
   increase over the run); the two-rank run below and the remat runs go
   beside it (the app's feed, not the card, bounds its speed; the remat
   runs' ms are read with the app and the ranks on the card).
   ``--remat`` through the captured step, under
   deterministic algorithms: AlexNet at 256 and ResNet-50 at 32, 6
   iterations on 6 device-resident batches, remat against plain bit for
   bit (params, net state, every metric), peak memory allocated over the
   6 iterations and ms a step (10 replays) both ways, plain's also with
   the timeline's fence (the fence's cost on a step the card bounds),
   remat's
   ``lrn_rows_train`` launches twice plain's, and 5 remat replays under
   ``torch.profiler`` after one it traces and drops, their LRN and
   flash kernels grouped by replay (the ``cudaGraphLaunch`` each
   belongs to) and held replay by replay to the counters' increase a
   replay; BERT-base at 32 x 128 through BertApp's
   ``build`` with ``--remat``, f32 and bf16, dropout 0.1, 6 iterations:
   the losses bit for bit, the flash forward twice per layer and step
   (dq and dk/dv once), peak memory both ways, held to the profiler.
   Then, once the app and the ranks have ended, ``time_net`` on AlexNet
   at 256, f32 and bf16, with
   ``--per-layer``, and ``caffe time`` on LeNet (TFLOP/s and MFU against
   ``utils/profiling.PEAK_FLOPS``); the AlexNet server's ``/metrics``
   (Prometheus text: every sample line parses; the registry's and the
   serving families), ``/dash`` (HTML with its sections, the storage
   panel among them once this process's writers have observed the
   disk) and
   ``/healthz`` (``anomalies``); and two ranks on cuda:0 over gloo
   (cifar10_quick, ``--parallel local --tau auto``, the heartbeat's
   stats frame every second), rank 1 planted slow: rank 0's aggregate
   holds both ranks' phase shares, the straggler detector fires on rank
   1, and rank 0's τ controller takes the advisory. Each part's seconds
   are logged.

Then one JSON line of per-kernel numbers: for ``lrn_fwd`` "ms",
"plain_ms", "library_ms" and "bound_ms" are per serving bucket-32
forward (norm1 + norm2), for ``lrn_fwd_train`` and ``lrn_bwd`` per
batch-256 training step (norm1 + norm2); for the flash kernels per
launch at B 32 x S 128 (one layer of the bert-train run). "ms" is
the median of single calls, each between CUDA events on an idle card,
so it holds the wrapper's host time and the launch; every kernel adds
"loop_ms" (CUDA events around back-to-back calls, over their number)
and "device_ms" (``torch.profiler``'s device time of the kernel, over
the launches it recorded). Each "bound_ms" counts the operations at the peak rate of the
units that run them: 67 TFLOP/s f32 on the CUDA cores for LRN, 495
TFLOP/s dense TF32 for the own products of the flash forward (two), dq
(three) and dk/dv (four) (their split operands make each f32 product
three TF32 terms: that design's bound is printed beside it); "launches"
counts the main paths' runs in this process (serving, serving-tier's
engines and its traffic (router-tier's replicas run theirs in processes
of their own, which export no launch count), train, alexnet-local, feed,
googlenet, fused-step's AlexNet graph run, every rank of the
multiprocess phase's AlexNet runs, caffe-native's run A and engines,
the chaos phase's runs A, B and C and its served traffic, and
telemetry's app runs, remat runs (a recompute launches again),
time_net runs and server for LRN; bert-train, fused-step's BERT graph
run, every rank of the bert-processes phase and telemetry's BERT remat
runs for flash).
A kernel inside a captured step is counted at each replay (the graph
adds what its capture counted).
Before it, the phases' seconds in all. Last comes the result line
``{"ok": true, "device": {...}}``. Any
failed phase exits non-zero without the result line, as does a machine
without a CUDA card or a directory without the port.

    python3 chip_smoke.py --phase multiprocess bert-processes fused-step caffe-native chaos catalogue telemetry serving-tier router-tier

runs the card and build phases and the phases named (any of the nine)
alone (the NCCL runs on a machine with several cards) and prints no
result line.

    python3 chip_smoke.py --ab OTHER_ROOT

compares this checkout with another checkout of the port (an unpacked
parent commit) on the same card instead: four processes in turn, the
other, this, this, the other, each building its own kernels and printing
one JSON line: the three LRN kernels at AlexNet's batch of 256 and the
inference forward at serving bucket 32 (norm1 + norm2, f32), then the
three flash kernels at B 32 x S 128 and B 8 x S 512 in f32 and at B 32 x
S 128 in bf16 (each by single calls, back-to-back calls, the profiler's
device time and the host's time to make one call; SDPA's forward or
backward beside each flash kernel), then ``Solver.step`` of AlexNet on
one device-resident batch of 256, of GoogLeNet and ResNet-50 on one of
32 (f32 and ``--bf16``), the bucket-32 serving forward
(``engine.infer`` by the host clock, and the net's forward by CUDA
events), and ``Solver.step`` of BERT-base on one device-resident batch
of 32 x 128, f32 and ``--bf16`` (ms per step by CUDA events).

Tolerances. LRN kernels vs plain, f32: rtol 1e-5, atol 1e-6 (the two
sum the window in the same order; rsqrt/exp/log and fused multiply-adds
may differ in the last bits); d, always f32, likewise. bf16 outputs:
within one bf16 ulp of the plain result computed in f32 from the same
bf16 inputs (the kernel rounds an f32 result once). The backward kernel
and its plain version take the same d; its dx = g d^-beta - (window
term) can cancel to far below either term, where the f32 rounding of
the terms exceeds the tiny result's bf16 ulp, so bf16 dx is held to one
ulp plus the f32 tolerance. Training step on the card vs the CPU: loss
within 1e-5 relative, each gradient within 1e-4 relative L2 error (f32
reduced in another order), with cuDNN switched off so that convolutions
run as f32 GEMMs in a fixed order, on a batch where the CPU and the card
take the same argmax in every max-pool window and the same sign at every
ReLU (``phase_grads``); cuDNN's weight gradients sum with atomics, in
an order that changes from run to run. Serving top-5: the card's and the CPU's
indices must be equal, except that two classes whose CPU probabilities
differ by less than 1e-5 relative may trade places (f32 convolutions
sum in another order on the card; TF32 is switched off for both convs
and matmuls, so those differences stay near f32 rounding).

GoogLeNet and ResNet-50 card vs CPU (batch 8, cuDNN on): every blob and
the BatchNorm state within 1e-4 relative L2 and the loss within 1e-5,
AlexNet's limits; a branch that flips leaves forward values as they
were. No batch takes the same branch at every unit of 57-61 full-width
ReLU layers on both devices, so each flip sends a gradient elsewhere,
and the gradients are held per tensor within 1e-2 relative L2
(ZOO_GRAD_TOL; the measured worst on an H100 is in PERF.md).

The parallel phases: f32 convolutions reduce in another order on the
card than on the CPU, and on a batch of 25 than of 100, and cuDNN's
weight gradients sum with atomics; a max-pool or ReLU branch that flips
on that rounding moves a few gradients by their size, and 10 steps of
training carry that to up to 7.9e-4 relative L2 in 10 sync steps
(measured on the CPU: 4 x 25 against 1 x 100 rows of this feed, first
flips after 2-6 steps) and to 1.12e-3 in a local worker's 10 steps of
25 rows, card against CPU. So sync's 4 workers against one worker: the
weights after step 1 and every step's loss within 1e-4 relative, the
weights after 10 steps within 1e-2 relative L2 per tensor; each
worker's weights after one local round (10 steps) on the card against
the CPU's within 1e-2 (wrong rows, rates or averaging move them by 1e-1
or more). The
averaged weights, element by element: within the mean of the workers'
differences, plus 1e-6 of the average's operands (its f32 rounding),
plus what a rounding of the wire format that flips between the two
runs can move them (``_quanta``: where the two runs' deltas straddle a
rounding boundary, bf16 moves a worker's element by up to two ulps of
it and int8 by its bucket's shared scale, each over the 4 workers).

Flash kernels vs plain (the backward pair fed the plain forward's lse
and delta): f32 o and lse rtol = atol = 2e-5, f32 dq, dk, dv rtol = atol
= 1e-4, the JAX flash tests' own (sums of D products per logit and of
S terms per output, in another order); bf16 outputs one bf16 ulp of the
plain result beyond those; with dropout both draw the same hash mask,
so the same tolerances hold. BERT step on the card vs the CPU: loss
within 1e-5 relative, each gradient within 1e-4 relative L2 error (f32
reduced in another order over 12 layers; the tied word embedding's
gradient sums its rows on the card through ``index_put_`` with
accumulate, which PyTorch documents as nondeterministic on CUDA unless
deterministic algorithms are switched on). The key biases'
gradients are 0 in exact arithmetic (the softmax cancels a constant
shift of a query's logits), so their rounding noise has no relative
error to hold: each is held below 1e-4 of its layer's v_b gradient on
both devices instead.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM published peaks (data sheet, dense, at the full 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12  # tensor cores, dense

# LRN shapes of bvlc_alexnet, per row of the batch
ALEXNET_LRN = (("norm1", 55 * 55, 96), ("norm2", 27 * 27, 256))
LRN_GEOM = dict(size=5, alpha=1e-4, beta=0.75, k=1.0)
TRAIN_BATCH, TEST_BATCH = 256, 50  # the train_val prototxt's data layers
TRAIN_ITERS = 20

# ImageNetApp's other three nets, each at its train_val prototxt's batch
# (GoogLeNet 32 / test 50, ResNet-50 32 / 25, VGG-16 64 / 50), ZOO_ITERS
# iterations cut from its solver's 2.4 M, 450 k and 370 k; GoogLeNet's
# LRN layers per row of the batch (pool1/norm1, conv2/norm2)
ZOO_ARCHS = ("googlenet", "resnet50", "vgg16")
ZOO_ITERS = 20
GOOGLENET_LRN = (("norm1", 56 * 56, 64), ("norm2", 56 * 56, 192))
GOOGLENET_BATCHES = (32, 50)  # train, test
# the card-vs-CPU step of full-width GoogLeNet and ResNet-50 (beside
# AlexNet's phase_grads); their limits are in the module docstring
ZOO_GRADS_BATCH = 8
ZOO_LOSS_TOL, ZOO_BLOB_TOL, ZOO_GRAD_TOL = 1e-5, 1e-4, 1e-2

# the parallel phases: CifarApp's run, tau-local SGD on cifar10_quick,
# and AlexNet's local rounds
CIFAR_ITERS = 300
CIFAR_ACC_MARGIN = 0.5  # the last test accuracy must reach chance (0.1) + this
LOCAL_WORKERS, LOCAL_TAU, LOCAL_ROUNDS = 4, 10, 10
SYNC_STEPS = 10
# relative L2 per tensor: one step's weights, and each step's loss, on
# another device or batch split; 10 steps' weights: a max-pool or ReLU
# branch that flips on that rounding moves a few gradients by their
# size, and training carries it (measured: up to 7.9e-4 after 10 sync
# steps on the CPU, 4 x 25 against 1 x 100 rows of this feed; 1.12e-3
# for a local worker's 10 steps of 25 rows, card against CPU). The
# faults phase_local_sgd plants on the card read 1.24e-1 or more (a row
# split shifted by one row, over 10 sync steps; NVIDIA H100 80GB HBM3 at
# 700 W), so the limit sits about 10x from either side
LOCAL_STEP_TOL = 1e-4
LOCAL_CARD_TOL = 1e-2
ALEXNET_LOCAL_ITERS = 4
# the multiprocess phase: ResNet-50 sync at the prototxt's global batch,
# and the seconds a launch of ranks may take
MP_RESNET_BATCH, MP_RESNET_STEPS = 32, 5
MP_TIMEOUT = 300
# the bert-processes phase: BertApp's BERT-base at the global batch of
# 32 x 128 over 2 processes: sync steps and local iterations held, sync
# steps timed with the overlap on and off; --tau auto's rounds
BP_SYNC_STEPS, BP_LOCAL_ITERS, BP_TIMED = 3, 4, 1
BP_ITERS = max(BP_SYNC_STEPS, BP_LOCAL_ITERS)
TAU_AUTO_ROUNDS = 12

# the feed phase: ImageNetApp's AlexNet at its batch of 256 on the
# 2,048-image synthetic set, FEED_ITERS iterations a path in chunks of
# FEED_CHUNK (a test batch between chunks; each chunk's speed: line
# read), and the first FEED_CHECK batches of each Python path held bit
# for bit
FEED_N, FEED_ITERS, FEED_CHUNK, FEED_CHECK = 2048, 6, 3, 8

# BERT-base: 12 layers of 12 heads of 64; the BertApp run's batch and length
BERT_LAYERS, BERT_HEADS, BERT_HEAD_DIM = 12, 12, 64
BERT_BATCH, BERT_SEQ = 32, 128
BERT_ITERS, BERT_BF16_ITERS = 20, 10
FLASH_TIMED = ((BERT_BATCH, BERT_SEQ), (8, 512))  # (batch, seq) timed
FLASH_DROPOUT = 0.1  # BERT's attention dropout
FLASH_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# (label, b, h, sq, sk, d, causal, q_offset, kv_offset, padded, rate)
FLASH_CASES = (
    ("plain", 2, 3, 128, 128, 64, False, 0, 0, False, 0.0),
    ("causal", 2, 3, 128, 128, 64, True, 0, 0, False, 0.0),
    ("offsets", 1, 2, 64, 192, 32, True, 128, 0, False, 0.0),
    ("kv offset", 1, 2, 96, 64, 32, True, 0, 40, False, 0.0),
    ("padded row", 3, 2, 96, 96, 16, False, 0, 0, True, 0.0),
    ("ragged", 1, 2, 100, 77, 16, False, 0, 0, False, 0.0),
    ("ragged causal", 1, 2, 100, 77, 64, True, 0, 0, True, 0.0),
    ("d256", 1, 2, 70, 90, 256, True, 0, 0, False, 0.0),
    ("d256 padded", 2, 2, 128, 128, 256, False, 0, 0, True, 0.0),
    ("dropout 0.1", 2, 3, 128, 128, 64, False, 0, 0, True, 0.1),
    ("dropout 0.5", 1, 2, 100, 77, 64, True, 0, 0, False, 0.5),
    ("dropout 0.1 d16", 2, 2, 64, 80, 16, False, 0, 0, True, 0.1),
    ("dropout 0.5 d256", 1, 2, 64, 80, 256, False, 0, 0, False, 0.5),
    ("BERT-base layer", BERT_BATCH, BERT_HEADS, BERT_SEQ, BERT_SEQ, BERT_HEAD_DIM, False, 0,
     0, True, FLASH_DROPOUT),
    # q, k, v as BERT's strided views of one (b, s, 3, h, d) QKV product
    ("strided QKV", 2, BERT_HEADS, BERT_SEQ, BERT_SEQ, BERT_HEAD_DIM, False, 0, 0, True,
     FLASH_DROPOUT, "qkv"),
    # one rank's layer in the bert-processes phase: 16 rows of the batch of
    # 32, strided QKV views, dropout off (--parallel sync) and on (local)
    ("BERT-base rank sync", BERT_BATCH // 2, BERT_HEADS, BERT_SEQ, BERT_SEQ, BERT_HEAD_DIM,
     False, 0, 0, True, 0.0, "qkv"),
    ("BERT-base rank local", BERT_BATCH // 2, BERT_HEADS, BERT_SEQ, BERT_SEQ, BERT_HEAD_DIM,
     False, 0, 0, True, FLASH_DROPOUT, "qkv"),
)
# the forward's TF32 terms per product (s = q k^T, o += p v): split
# operands, f32 3 + 3, bf16 (exact in TF32) 1 + 2
FLASH_FWD_TERMS = {"float32": (3, 3), "bfloat16": (1, 2)}
# dq's (s = q k^T, dp = dO v^T, dq += ds k): f32 3 + 3 + 3, bf16 1 + 1 + 2
# (ds is f32); tests/test_torch_flash_tc.py shows that none can go
FLASH_DQ_TERMS = {"float32": (3, 3, 3), "bfloat16": (1, 1, 2)}
# dk/dv's (s^T = k q^T, dp^T = v dO^T, dv += p^T dO, dk += ds^T q): f32
# 3 + 3 + 3 + 3, bf16 1 + 1 + 2 + 2 (p and ds are f32)
FLASH_DKV_TERMS = {"float32": (3, 3, 3, 3), "bfloat16": (1, 1, 2, 2)}
# each LRN wrapper's kernels (every route), by a prefix of the names
# torch.profiler gives their device time
LRN_TAGS = {"lrn_fwd": "lrn_fwd_rows", "lrn_fwd_train": "lrn_fwd_rows",
            "lrn_bwd": "lrn_bwd_rows"}
# each wrapper's kernel, by the name torch.profiler gives its device time
FLASH_TAGS = {"flash_fwd": "flash_fwd_kernel", "flash_bwd_dq": "flash_bwd_dq_kernel",
              "flash_bwd_dkv": "flash_bwd_dkv_kernel"}


def log(msg: str = "") -> None:
    print(msg, flush=True)


class Phases:
    """Runs phases in order; a failure is printed and remembered, and
    the script exits non-zero at the end."""

    def __init__(self):
        self.failed = []
        self.seconds = 0.0  # every phase's, summed
        self.by_phase = []  # (name, seconds), in order

    def table(self) -> None:
        """Seconds by phase, slowest first, with each one's share."""
        log(f"seconds by phase ({self.seconds:.1f} s in all):")
        for name, sec in sorted(self.by_phase, key=lambda t: -t[1]):
            log(f"  {name:<16} {sec:8.1f} s  {100 * sec / max(self.seconds, 1e-9):5.1f}%")

    def run(self, name, fn, *args):
        log(f"== phase {name}")
        t0 = time.perf_counter()
        out, ok = None, False
        try:
            out, ok = fn(*args), True
        except Exception:
            traceback.print_exc(file=sys.stdout)
            self.failed.append(name)
        sec = time.perf_counter() - t0
        self.seconds += sec
        self.by_phase.append((name, sec))
        log(f"== phase {name}: " + (f"ok in {sec:.1f} s" if ok else f"FAILED after {sec:.1f} s"))
        return out


# ---------------------------------------------------------------- card
def phase_card():
    import torch

    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name} "
        f"count {torch.cuda.device_count()}")
    smi = _smi()
    log(smi)
    return name, smi


def _smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


# --------------------------------------------------------------- build
def phase_build():
    from sparknet_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"built {len(built)} kernel libraries in {time.perf_counter() - t0:.2f} s")
    for b in built.values():
        log(f"  {b.name}: {b.seconds:.2f} s -> {os.path.relpath(b.path, ROOT)}")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"    {line.strip()}")
    _flash_on_tensor_cores(built["attention"].path)
    _lrn_vector_accesses(built["lrn"].path)
    return built


def _sass(lib_path):
    """{kernel's mangled name: its SASS} of a built library."""
    import re

    from sparknet_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    parts = re.split(r"Function : (\S+)", sass)
    return dict(zip(parts[1::2], parts[2::2]))


def _lrn_vector_accesses(lib_path):
    """Every LRN quad-route instantiation loads and stores global memory
    only in 16- or 8-byte vectors (LDG/STG .128 or .64), and the staged
    ones in none (raises otherwise); prints each kernel's counts."""
    import re

    bad = []
    for name, body in sorted(_sass(lib_path).items()):
        if "lrn_" not in name:
            continue
        wide, narrow = {"LDG": 0, "STG": 0}, {"LDG": 0, "STG": 0}
        for op, suffix in re.findall(r"\b(LDG|STG)((?:\.\w+)*)\s", body):
            (wide if {"128", "64"} & set(suffix.split(".")) else narrow)[op] += 1
        quad = "_quad_kernel" in name
        log(f"  cuobjdump -sass {name[:70]}: 16/8-byte loads {wide['LDG']}, stores "
            f"{wide['STG']}; narrower loads {narrow['LDG']}, stores {narrow['STG']}")
        if quad != all(wide.values()) or (quad and any(narrow.values())):
            bad.append(name)
    if bad:
        raise AssertionError(f"LRN kernels whose global accesses are not as their route "
                             f"says: {bad}")


def _flash_on_tensor_cores(lib_path):
    """Every flash_fwd_kernel, flash_bwd_dq_kernel and flash_bwd_dkv_kernel
    instantiation's SASS holds HGMMA, and no other kernel's does (raises
    otherwise); f32 dq at D 256 is the one flash_bwd_dq_simt_kernel, dk/dv
    at D 256 the two flash_bwd_dkv_simt_kernel. Each instantiation's
    shared memory, registers and blocks per SM."""
    import ctypes

    from sparknet_tpu_torch.ops import _build

    funcs = _sass(lib_path)
    tc = {}
    for kernel, want in (("flash_fwd_kernel", 10), ("flash_bwd_dq_kernel", 9),
                         ("flash_bwd_dkv_kernel", 8)):
        hgmma = {n: body.count("HGMMA") for n, body in funcs.items() if kernel in n}
        log(f"  cuobjdump -sass: {len(hgmma)} {kernel} instantiations, HGMMA "
            f"instructions in each: {sorted(hgmma.values())}")
        if len(hgmma) != want or not all(hgmma.values()):
            raise AssertionError(f"{kernel} without HGMMA: {hgmma}")
        tc.update(hgmma)
    simt_dq = [n for n in funcs if "flash_bwd_dq_simt_kernel" in n]
    simt_dkv = [n for n in funcs if "flash_bwd_dkv_simt_kernel" in n]
    others = sum(b.count("HGMMA") for n, b in funcs.items() if n not in tc)
    log(f"  in the other {len(funcs) - len(tc)} kernels ({len(simt_dq)} SIMT dq, f32 D=256; "
        f"{len(simt_dkv)} SIMT dk/dv, D=256): {others}")
    if len(simt_dq) != 1 or len(simt_dkv) != 2 or others:
        raise AssertionError(f"SIMT dq {simt_dq}, SIMT dk/dv {simt_dkv}, HGMMA outside the "
                             f"tensor-core kernels {others}")
    lib = _build.library("attention")
    fn = lib.sparknet_flash_info
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    for which, kernel in enumerate(FLASH_NAMES):
        for code, dt in enumerate(("float32", "bfloat16")):
            for d in (16, 32, 64, 128, 256):
                out = (ctypes.c_int * 4)()
                err = fn(which, d, code, 0, out)
                if err:
                    raise RuntimeError(f"sparknet_flash_info({which}, {d}, {dt}): cudaError {err}")
                log(f"  {kernel} {dt} D={d}: shared memory {out[0]} bytes "
                    f"({out[0] / 1024:.1f} KiB) per block, {out[1]} registers per thread, "
                    f"{out[2]} blocks per SM, {out[3]} threads per block "
                    f"({'tensor cores' if out[3] == 128 else 'CUDA cores'})")


# ------------------------------------------------------------- kernels
def _bf16_ulp(ref):
    import torch

    _, e = torch.frexp(ref)  # |ref| = m * 2^e, m in [0.5, 1)
    return torch.ldexp(torch.ones_like(ref), e - 8)


def _time_ms(fn, reps: int = 30, warm: int = 5) -> float:
    """Median of ``reps`` single launches, each between CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _time_loop_ms(fn, reps: int = 30, warm: int = 5, runs: int = 5) -> float:
    """CUDA events around ``reps`` calls made back to back, over
    ``reps``; the median of ``runs`` such runs. A call's host time
    overlaps the card's work on the call before, unless it is the longer
    of the two."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def _host_ms(fn, n: int = 200, runs: int = 5) -> float:
    """The host's time to make one call: on the host clock over ``n``
    calls (the card keeps up, so none of them waits on it), the median of
    ``runs`` such runs."""
    import torch

    times = []
    for _ in range(runs):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / n)
        torch.cuda.synchronize()
    return statistics.median(times)


QUAD, STAGED = ("quad",) * 3, ("staged",) * 3


def lrn_cases():
    """(label, m, c, size, alpha, beta, k, dtype name, operands placed 4
    bytes past a 16-byte boundary ("xg": x and g; "d": d), the routes the
    inference forward, training forward and backward must take)."""
    cases = []
    for dt in ("float32", "bfloat16"):
        # serving buckets; 8 is the grads phase's batch, 128 one
        # alexnet-local worker's
        for b in (1, 8, 32, 128):
            for name, hw, c in ALEXNET_LRN:
                cases.append((f"{name} B={b}", b * hw, c, 5, 1e-4, 0.75, 1.0, dt, "", QUAD))
        # GoogLeNet's: its train and test batches
        for b in GOOGLENET_BATCHES:
            for name, hw, c in GOOGLENET_LRN:
                cases.append((f"googlenet {name} B={b}", b * hw, c, 5, 1e-4, 0.75, 1.0, dt,
                              "", QUAD))
        cases += [
            ("ragged M=1003", 1003, 96, 5, 0.5, 0.75, 2.0, dt, "", QUAD),
            ("even size 4", 4096, 96, 4, 0.5, 0.75, 1.0, dt, "", QUAD),
            ("even size 6, ragged", 1001, 256, 6, 0.5, 1.0, 1.0, dt, "", QUAD),
            ("C=1024", 2048, 1024, 5, 0.5, 0.75, 1.0, dt, "", QUAD),
            ("C=97", 1000, 97, 5, 0.5, 0.75, 2.0, dt, "", STAGED),
            ("C=97 even size 4", 999, 97, 4, 0.5, 0.6, 1.0, dt, "", STAGED),
            ("C=1500 (two chunks)", 700, 1500, 7, 0.5, 0.75, 1.0, dt, "", STAGED),
            ("x, g unaligned", 1000, 96, 5, 0.5, 0.75, 1.0, dt, "xg", STAGED),
            ("d unaligned", 1000, 96, 4, 0.5, 0.75, 1.0, dt, "d", ("quad", "quad", "staged")),
        ]
        for beta in (0.5, 1.0, 0.6):
            cases.append((f"beta={beta}", 3001, 256, 5, 0.5, beta, 1.0, dt, "", QUAD))
    return cases


def _unaligned(t):
    """A contiguous copy of ``t`` 4 bytes past a 16-byte boundary."""
    import torch

    off = 4 // t.element_size()
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    view = buf[off:].view(t.shape)
    view.copy_(t)
    return view


def _check(got, ref, dtype, cancels=False):
    """(ok, max_abs_err, tolerance) of a kernel output against its plain
    version (module docstring); ``cancels``: the output is a difference
    of two terms, so bf16 gets the f32 tolerance on top of its ulp."""
    import torch

    f32_tol = 1e-6 + 1e-5 * ref.abs()
    if dtype == torch.float32:
        err = (got - ref).abs()
        return bool(torch.all(err <= f32_tol)), float(err.max()), "rtol 1e-5 atol 1e-6"
    err = (got.float() - ref).abs()
    if cancels:
        return bool(torch.all(err <= _bf16_ulp(ref) + f32_tol)), float(err.max()), \
            "1 bf16 ulp + rtol 1e-5 atol 1e-6"
    return bool(torch.all(err <= _bf16_ulp(ref))), float(err.max()), "1 bf16 ulp"


def phase_kernels():
    """All three LRN kernels against their plain versions, then timed."""
    import torch

    from sparknet_tpu_torch.ops.lrn import (
        lrn_bwd_reference, lrn_fwd_train_reference, lrn_reference, lrn_rows,
        lrn_rows_bwd, lrn_rows_train)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    names = ("lrn_fwd", "lrn_fwd_train", "lrn_bwd")
    worst = {(n, dt): 0.0 for n in names for dt in ("float32", "bfloat16")}
    failures = []
    wrappers = (lrn_rows, lrn_rows_train, lrn_rows_bwd)
    for label, m, c, size, alpha, beta, k, dt, unaligned, want in lrn_cases():
        dtype = getattr(torch, dt)
        x = (2.0 * torch.randn(m, c, generator=gen, device=dev)).to(dtype)
        g = torch.randn(m, c, generator=gen, device=dev).to(dtype)
        if "x" in unaligned:
            x, g = _unaligned(x), _unaligned(g)
        y = lrn_rows(x, size, alpha, beta, k)
        yt, d = lrn_rows_train(x, size, alpha, beta, k)
        if "d" in unaligned:
            d = _unaligned(d)
        dx = lrn_rows_bwd(g, x, d, size, alpha, beta)
        torch.cuda.synchronize()
        routes = tuple(w.last_route for w in wrappers)
        if routes != want:
            failures.append(f"{label} {dt}: routes {routes}, want {want}")
        ref_y, ref_d = lrn_fwd_train_reference(x.float(), size, alpha, beta, k)
        ref_dx = lrn_bwd_reference(g.float(), x.float(), d, size, alpha, beta)
        checks = (
            ("lrn_fwd", "y", y, lrn_reference(x.float(), size, alpha, beta, k), dtype,
             False),
            ("lrn_fwd_train", "y", yt, ref_y, dtype, False),
            ("lrn_fwd_train", "d", d, ref_d, torch.float32, False),
            ("lrn_bwd", "dx", dx, ref_dx, dtype, True),
        )
        line = []
        for name, what, got, ref, cdt, cancels in checks:
            ok, e, tol = _check(got, ref, cdt, cancels)
            worst[(name, dt)] = max(worst[(name, dt)], e)
            line.append(f"{what} {e:.2e}{'' if ok else ' MISMATCH'}")
            if not ok:
                failures.append(f"{name} {what} {label} {dt} ({tol})")
        log(f"  lrn {label:<22} {dt:<8} ({m}, {c}) size={size} beta={beta} routes "
            f"{'/'.join(routes)}: max_abs_err fwd {line[0]}, train {line[1]}, {line[2]}, "
            f"bwd {line[3]}")
    if failures:
        raise AssertionError(f"LRN kernels disagree with their plain versions or took "
                             f"another route: {failures}")
    for n in names:
        log(f"  worst |kernel - plain| {n}: f32 {worst[(n, 'float32')]:.3e}, bf16 "
            f"{worst[(n, 'bfloat16')]:.3e} (each within its tolerance)")

    timing = {"lrn_fwd": _time_inference(gen, 32)}
    test_batch = _time_inference(gen, TEST_BATCH)  # the train path's eval forwards
    timing["lrn_fwd"]["err"] = max(timing["lrn_fwd"]["err"], test_batch["err"])
    timing["lrn_fwd_train"], timing["lrn_bwd"] = _time_training(gen)
    for n in names:
        timing[n]["max_abs_err"] = max(worst[(n, "float32")], timing[n]["err"])
    _time_googlenet_lrn(gen)
    return timing


def _time_googlenet_lrn(gen):
    """The three LRN kernels at GoogLeNet's shapes (norm1 56x56 x 64,
    norm2 56x56 x 192, batches 32 and 50, f32 and bf16), each by single
    calls and by the profiler's device time beside its byte bound; each
    must take the quad route (the plain-version checks are lrn_cases')."""
    import torch

    from sparknet_tpu_torch.ops.lrn import lrn_rows, lrn_rows_bwd, lrn_rows_train

    p = LRN_GEOM
    for dt in (torch.float32, torch.bfloat16):
        e = torch.tensor([], dtype=dt).element_size()
        for n in GOOGLENET_BATCHES:
            for name, hw, c in GOOGLENET_LRN:
                m = n * hw
                x = torch.relu(10 * torch.randn(m, c, generator=gen, device="cuda")).to(dt)
                g = torch.randn(m, c, generator=gen, device="cuda").to(dt)
                _, d = lrn_rows_train(x, p["size"], p["alpha"], p["beta"], p["k"])
                calls = (
                    # (kernel, wrapper, call, bytes: x/g/y/dx in dt, d in f32, ops)
                    ("lrn_fwd", lrn_rows, lambda: lrn_rows(
                        x, p["size"], p["alpha"], p["beta"], p["k"]), 2 * e, 2 * p["size"] + 6),
                    ("lrn_fwd_train", lrn_rows_train, lambda: lrn_rows_train(
                        x, p["size"], p["alpha"], p["beta"], p["k"]), 2 * e + 4,
                     2 * p["size"] + 6),
                    ("lrn_bwd", lrn_rows_bwd, lambda: lrn_rows_bwd(
                        g, x, d, p["size"], p["alpha"], p["beta"]), 3 * e + 4,
                     p["size"] + 10),
                )
                for kname, wrapper, call, per_elem, ops in calls:
                    ms = _time_ms(call)
                    dev = _device_ms(call, LRN_TAGS[kname])
                    b = _bound(per_elem * m * c, ops * m * c)
                    if wrapper.last_route != "quad":
                        raise AssertionError(f"{kname} googlenet {name} B={n} "
                                             f"{str(dt)[6:]}: route {wrapper.last_route}")
                    log(f"  time {kname} googlenet {name} B={n} ({m}, {c}) {str(dt)[6:]}, "
                        f"quad route: single calls {ms:.4f} ms, device time "
                        f"(torch.profiler) {_fmt_ms(dev)}; bound {b['bound_ms']:.4f} ms "
                        f"({'bytes' if b['bytes_ms'] >= b['ops_ms'] else 'operations'}: "
                        f"{per_elem * m * c / 1e6:.1f} MB); share of bound "
                        f"{100 * b['bound_ms'] / ms:.1f}% by single calls"
                        + ("" if dev is None else
                           f", {100 * b['bound_ms'] / dev:.1f}% by device time"))


def _totals(rows):
    """Sum per-shape timings; the bound kind of the summed bound; the
    worst |kernel - plain| over the shapes."""
    keys = ("ms", "loop_ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms", "ops_ms")
    out = {k: sum(r[k] for r in rows) for k in keys}
    dev = [r["device_ms"] for r in rows]
    out["device_ms"] = None if None in dev else sum(dev)
    out["err"] = max(r["err"] for r in rows)
    out["bound_by"] = "bytes" if out["bytes_ms"] >= out["ops_ms"] else "operations"
    return out


def _report(label, m, c, r, nbytes, ops):
    card = r["device_ms"] or r["loop_ms"]
    log(f"  time {label} ({m}, {c}) f32, {r['route']} route: kernel single calls "
        f"{r['ms']:.4f} ms, back to back {r['loop_ms']:.4f} ms, device time "
        f"(torch.profiler) {_fmt_ms(r['device_ms'])}; plain {r['plain_ms']:.4f} ms, "
        f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
        f"({'bytes' if r['bytes_ms'] >= r['ops_ms'] else 'operations'}: "
        f"{nbytes / 1e6:.1f} MB, {ops / 1e6:.1f} Mop); share of bound "
        f"{100 * r['bound_ms'] / r['ms']:.1f}% by single calls, "
        f"{100 * r['bound_ms'] / card:.1f}% by device time "
        f"({nbytes / (card * 1e-3) / 1e9:.0f} GB/s)")


def _lrn_times(fn, tag):
    """An LRN kernel back to back and by the profiler's device time (the
    kernels whose name holds ``tag``, LRN_TAGS)."""
    return dict(loop_ms=_time_loop_ms(fn), device_ms=_device_ms(fn, tag))


def _held(label, pairs, tol=None):
    """Worst |kernel - plain| over (what, kernel, plain) f32 outputs at a
    timed shape; raises if one is outside the f32 tolerance (LRN's, or
    rtol = atol = ``tol``)."""
    import torch

    worst = 0.0
    for what, got, ref in pairs:
        if tol is None:
            ok, e, tol_text = _check(got, ref, torch.float32)
        else:
            ok, e = _flash_within(got, ref, torch.float32, tol)
            tol_text = f"rtol {tol:g} atol {tol:g}"
        log(f"  check {label} {what}: max_abs_err {e:.2e} [{tol_text}]"
            f"{'' if ok else ' MISMATCH'}")
        if not ok:
            raise AssertionError(f"{label} {what} disagrees with its plain version "
                                 f"({tol_text})")
        worst = max(worst, e)
    return worst


def _bound(nbytes, ops):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOPS_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms, ops_ms=ops_ms)


def _time_inference(gen, n):
    """The inference kernel at AlexNet's LRN shapes for a batch of n, f32,
    held against its plain version on the same x, then timed; library:
    F.local_response_norm on the channels_last view."""
    import torch
    import torch.nn.functional as F

    from sparknet_tpu_torch.ops.lrn import lrn_reference, lrn_rows

    g = LRN_GEOM
    rows = []
    for name, hw, c in ALEXNET_LRN:
        m = n * hw
        h = int(round(hw ** 0.5))
        x = torch.relu(torch.randn(m, c, generator=gen, device="cuda"))
        x_nchw = x.view(n, h, h, c).permute(0, 3, 1, 2)  # channels_last view
        err = _held(f"lrn_fwd {name} B={n}", [(
            "y", lrn_rows(x, g["size"], g["alpha"], g["beta"], g["k"]),
            lrn_reference(x, g["size"], g["alpha"], g["beta"], g["k"]))])
        kernel = lambda: lrn_rows(x, g["size"], g["alpha"], g["beta"], g["k"])  # noqa: E731
        r = dict(
            err=err, route=lrn_rows.last_route,
            ms=_time_ms(kernel), **_lrn_times(kernel, LRN_TAGS["lrn_fwd"]),
            plain_ms=_time_ms(lambda: lrn_reference(x, g["size"], g["alpha"], g["beta"],
                                                    g["k"])),
            library_ms=_time_ms(lambda: F.local_response_norm(
                x_nchw, g["size"], g["alpha"], g["beta"], g["k"])),
        )
        nbytes = 2 * m * c * x.element_size()  # read x once, write y once
        ops = m * c * (2 * g["size"] + 6)  # window multiply-adds, d, power, scale
        r.update(_bound(nbytes, ops))
        _report(f"lrn_fwd {name} B={n}", m, c, r, nbytes, ops)
        rows.append(r)
    return _totals(rows)


def _time_training(gen):
    """The training forward and the backward kernel at AlexNet's batch
    of 256, f32, each held against its plain version on the same inputs
    (the backward's plain version takes the kernel's d), then timed.
    Library yardsticks: F.local_response_norm's forward, and
    torch.autograd.grad of it for the same g, timed alone."""
    import torch
    import torch.nn.functional as F

    from sparknet_tpu_torch.ops.lrn import (
        lrn_bwd_reference, lrn_fwd_train_reference, lrn_rows_bwd, lrn_rows_train)

    p = LRN_GEOM
    fwd_rows, bwd_rows = [], []
    for name, hw, c in ALEXNET_LRN:
        n = TRAIN_BATCH
        m = n * hw
        h = int(round(hw ** 0.5))
        x = torch.relu(torch.randn(m, c, generator=gen, device="cuda"))
        g = torch.randn(m, c, generator=gen, device="cuda")
        y, d = lrn_rows_train(x, p["size"], p["alpha"], p["beta"], p["k"])
        ref_y, ref_d = lrn_fwd_train_reference(x, p["size"], p["alpha"], p["beta"], p["k"])
        fwd_err = _held(f"lrn_fwd_train {name} B={n}", [("y", y, ref_y), ("d", d, ref_d)])
        del y, ref_y, ref_d
        bwd_err = _held(f"lrn_bwd {name} B={n}", [(
            "dx", lrn_rows_bwd(g, x, d, p["size"], p["alpha"], p["beta"]),
            lrn_bwd_reference(g, x, d, p["size"], p["alpha"], p["beta"]))])
        x_nchw = x.view(n, h, h, c).permute(0, 3, 1, 2).requires_grad_(True)
        g_nchw = g.view(n, h, h, c).permute(0, 3, 1, 2)
        y_lib = F.local_response_norm(x_nchw, p["size"], p["alpha"], p["beta"], p["k"])
        fwd_kernel = lambda: lrn_rows_train(x, p["size"], p["alpha"], p["beta"], p["k"])  # noqa: E731
        bwd_kernel = lambda: lrn_rows_bwd(g, x, d, p["size"], p["alpha"], p["beta"])  # noqa: E731
        fwd = dict(
            err=fwd_err, route=lrn_rows_train.last_route,
            ms=_time_ms(fwd_kernel), **_lrn_times(fwd_kernel, LRN_TAGS["lrn_fwd_train"]),
            plain_ms=_time_ms(lambda: lrn_fwd_train_reference(
                x, p["size"], p["alpha"], p["beta"], p["k"])),
            library_ms=_time_ms(lambda: F.local_response_norm(
                x_nchw.detach(), p["size"], p["alpha"], p["beta"], p["k"])),
        )
        nbytes = 3 * m * c * 4  # read x, write y and d
        ops = m * c * (2 * p["size"] + 6)
        fwd.update(_bound(nbytes, ops))
        _report(f"lrn_fwd_train {name} B={n}", m, c, fwd, nbytes, ops)
        bwd = dict(
            err=bwd_err, route=lrn_rows_bwd.last_route,
            ms=_time_ms(bwd_kernel), **_lrn_times(bwd_kernel, LRN_TAGS["lrn_bwd"]),
            plain_ms=_time_ms(lambda: lrn_bwd_reference(g, x, d, p["size"], p["alpha"],
                                                        p["beta"])),
            library_ms=_time_ms(lambda: torch.autograd.grad(
                y_lib, x_nchw, g_nchw, retain_graph=True)),
        )
        nbytes = 4 * m * c * 4  # read g, x, d, write dx
        ops = m * c * (p["size"] + 10)  # window adds, power, u, dx
        bwd.update(_bound(nbytes, ops))
        _report(f"lrn_bwd {name} B={n}", m, c, bwd, nbytes, ops)
        fwd_rows.append(fwd)
        bwd_rows.append(bwd)
        del y_lib
    return _totals(fwd_rows), _totals(bwd_rows)


# ------------------------------------------------------------- serving
def _check_topk(label, idx_gpu, idx_cpu, probs_cpu_full):
    """Top-5 equal, except near-ties on the CPU side (module docstring)."""
    import numpy as np

    idx_gpu = np.asarray(idx_gpu)
    for r in range(len(idx_cpu)):
        if np.array_equal(idx_gpu[r], idx_cpu[r]):
            continue
        p = probs_cpu_full[r]
        want = p[idx_cpu[r]]
        got = p[idx_gpu[r]]
        if not np.allclose(got, want, rtol=1e-5, atol=0):
            raise AssertionError(
                f"{label} row {r}: top-5 {idx_gpu[r].tolist()} on the card vs "
                f"{idx_cpu[r].tolist()} on the CPU (CPU probs {got} vs {want})"
            )
        log(f"  {label} row {r}: near-tie reorder within 1e-5, accepted")


def phase_serving():
    import numpy as np
    import torch

    from sparknet_tpu_torch.models import ALEXNET_DEPLOY
    from sparknet_tpu_torch.ops.lrn import lrn_rows
    from sparknet_tpu_torch.serve.engine import InferenceEngine
    from sparknet_tpu_torch.serve.metrics import ServeMetrics
    from sparknet_tpu_torch.serve.server import InferenceServer

    buckets = (1, 8, 32)
    metrics = ServeMetrics(buckets)
    t0 = time.perf_counter()
    eng = InferenceEngine.from_files(ALEXNET_DEPLOY, device="cuda",
                                     buckets=buckets, metrics=metrics)
    ref = InferenceEngine.from_files(ALEXNET_DEPLOY, device="cpu", buckets=buckets)
    n_params = sum(t.numel() for e in eng.params.values() for t in e.values())
    log(f"  bvlc_alexnet: {n_params} parameters, built in "
        f"{time.perf_counter() - t0:.1f} s")
    for layer, e in eng.params.items():
        for pname, t in e.items():
            if not torch.equal(t.cpu(), ref.params[layer][pname]):
                raise AssertionError(f"{layer}.{pname}: card and CPU weights differ")
    eng.warmup()
    log(f"  warmup of buckets {buckets}: {eng.warmup_s} s")

    rng = np.random.default_rng(0)
    row_shape = eng._row_shapes["data"]

    def rows(n):
        # 3 decimals keep the JSON bodies small; the CPU sees the same rows
        return np.round(rng.normal(size=(n,) + row_shape), 3).astype(np.float32)

    server = InferenceServer(eng, metrics=metrics, port=0,
                             model_name="bvlc_alexnet_deploy.prototxt")
    if not server.batcher.wait_ready(300):  # its worker warms the buckets
        raise AssertionError("batcher worker did not finish its warmup")
    answers = []  # (label, rows, top-5 indices from the card)
    lrn_rows.launches = 0  # count the main path only
    server.start()
    try:
        client = server.client(timeout=300)
        code, health = client.healthz()
        if code != 200 or health["status"] != "ok":
            raise AssertionError(f"/healthz: {code} {health}")
        log(f"  /healthz {code}: device {health['device']}, buckets "
            f"{health['buckets']}, gen {health['generation']}")
        for n in (1, 3, 8):
            x = rows(n)
            t1 = time.perf_counter()
            code, body = client.classify(x, top_k=5)
            if code != 200:
                raise AssertionError(f"/classify {n} rows: {code} {body}")
            log(f"  /classify {n} rows: {code} in {time.perf_counter() - t1:.2f} s "
                f"(JSON included), gen {body['gen']}")
            answers.append((f"/classify {n} rows", x, body["indices"]))
        code, text = client.prometheus()
        if code != 200 or "sparknet_serve_requests_total 3" not in text:
            raise AssertionError(f"/metrics: {code} {text[:200]!r}")
        code, snap = client.metrics()
        if code != 200 or snap["requests"] != 3 or snap["errors"] != 0:
            raise AssertionError(f"/metrics.json: {code} {snap}")
        log(f"  /metrics {code}: {snap['requests']} requests, {snap['errors']} errors")
        for n in (32, 40):
            x = rows(n)
            out = server.batcher.submit(x, block=True).result(timeout=300)
            if out.shape != (n, 1000) or not np.all(np.isfinite(out)):
                raise AssertionError(f"batcher {n} rows: output {out.shape}")
            if not np.allclose(out.sum(-1), 1.0, atol=1e-4):
                raise AssertionError(f"batcher {n} rows: probabilities do not sum to 1")
            idx, _ = eng.postprocess(out, 5)
            answers.append((f"batcher {n} rows", x, idx))
    finally:
        server.stop()
    launches = lrn_rows.launches
    snap = metrics.snapshot()
    calls = sum(e["batches"] for e in snap["per_bucket"].values())
    log(f"  LRN kernel launches on the serving path: {launches} over {calls} "
        f"bucket calls ({snap['per_bucket']['1']['batches']} x b1, "
        f"{snap['per_bucket']['8']['batches']} x b8, "
        f"{snap['per_bucket']['32']['batches']} x b32)")
    if calls != 6 or launches != 2 * calls:
        raise AssertionError(f"want 2 LRN launches per bucket call over 6 calls, "
                             f"got {launches} over {calls}")
    for b, e in snap["per_bucket"].items():
        log(f"  metrics bucket {b}: device_latency {e['device_latency']}, "
            f"padding_waste {e['padding_waste']}")

    # every answer against the CPU run of the same weights
    for label, x, idx in answers:
        probs = ref.infer(x)
        idx_cpu, _ = ref.postprocess(probs, 5)
        _check_topk(label, idx, idx_cpu, probs)
        log(f"  {label}: top-5 equal to the CPU run")

    # no relayout: the LRN bottoms are contiguous NHWC straight off the convs
    params, state, _, _ = eng._weights_snapshot()
    x = torch.from_numpy(rows(1)).cuda()
    blobs, _ = eng.net.apply(params, state, {"data": x}, train=False)
    for blob in ("conv1", "conv2"):
        if not blobs[blob].is_contiguous():
            raise AssertionError(f"{blob} is not contiguous NHWC: LRN would copy it")
    log("  conv1/conv2 come out contiguous NHWC: the LRN row view is free")

    # steady-state latency per bucket, engine.infer (host clock, synchronised)
    latency = {}
    for b in buckets:
        x = rows(b)
        times = []
        for _ in range(12):
            t1 = time.perf_counter()
            eng.infer(x)
            times.append((time.perf_counter() - t1) * 1e3)
        latency[b] = statistics.median(times[2:])
        log(f"  engine.infer bucket {b}: median {latency[b]:.3f} ms over 10 calls "
            f"(host clock, upload + forward + download)")
    return {"launches": launches, "latency_ms": latency, "engine": eng,
            "rows": rows}


def phase_profile(serving):
    """Where the device time of one bucket-32 forward goes, by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    eng, reps = serving["engine"], 5
    x = serving["rows"](32)
    eng.infer(x)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            eng.infer(x)  # ends in a copy to the host: synchronised
        wall = (time.perf_counter() - t0) / reps * 1e6  # us per forward
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and not _annotation(e)
    ]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    # the same forward split in three without the profiler, CUDA events:
    # upload of the host batch, the net on the card, download of the output
    params, state, _, _ = eng._weights_snapshot()
    host = torch.from_numpy(x)
    pinned = host.pin_memory()
    xd = host.to("cuda")
    up = _time_ms(lambda: host.to("cuda"), reps=20)
    up_pinned = _time_ms(lambda: pinned.to("cuda", non_blocking=True), reps=20)
    fwd = _time_ms(lambda: eng.net.apply(params, state, {"data": xd}, train=False),
                          reps=20)
    out = eng.net.apply(params, state, {"data": xd}, train=False)[0][eng.output]
    down = _time_ms(lambda: out.cpu(), reps=20)
    log(f"  bucket 32 without the profiler (CUDA events, median of 20): upload "
        f"{up:.3f} ms pageable ({host.numel() * 4 / 1e6:.1f} MB; {up_pinned:.3f} ms "
        f"from pinned memory), forward {fwd:.3f} ms, download {down:.3f} ms")

    total = sum(dev_us(e) for e in kernels) / reps
    if not total:
        log("  device time by kernel: not measured (the profiler saw no device events)")
        return None
    lrn = sum(dev_us(e) for e in kernels if LRN_TAGS["lrn_fwd"] in e.key) / reps
    log(f"  bucket 32: device busy {total / 1e3:.3f} ms per forward of "
        f"{wall / 1e3:.3f} ms wall under the profiler (idle share "
        f"{100 * (1 - total / wall):.1f}%); LRN kernel {lrn / 1e3:.4f} ms = "
        f"{100 * lrn / total:.1f}% of device time")
    for e in sorted(kernels, key=dev_us, reverse=True)[:10]:
        log(f"    {dev_us(e) / reps / 1e3:8.4f} ms  {e.count // reps:3d}x  {e.key[:90]}")
    return total


def phase_load(serving):
    """Closed-loop load through the batcher (tools/serve --bench's path)."""
    from sparknet_tpu_torch.serve.loadgen import run_loadgen
    from sparknet_tpu_torch.serve.metrics import ServeMetrics

    eng = serving["engine"]
    eng.metrics = ServeMetrics(eng.buckets)
    rec = run_loadgen(eng, n_requests=200, sizes=(1, 2, 5, 8, 3), concurrency=4,
                      metrics=eng.metrics)
    if rec["errors"]:
        raise AssertionError(f"load generator errors: {rec['error_samples']}")
    log(f"  closed loop, 4 clients, sizes 1/2/5/8/3: {rec['value']} requests/s, "
        f"{rec['rows_per_sec']} rows/s, p50 {rec['p50_ms']} ms, p99 "
        f"{rec['p99_ms']} ms (log bins), {rec['requests']} requests, 0 errors")
    for b, e in rec["metrics"]["per_bucket"].items():
        log(f"    bucket {b}: {e['batches']} calls, padding_waste "
            f"{e['padding_waste']}, device p50 {e['device_latency']['p50_ms']} ms")
    return rec


# ----------------------------------------------------------- serving tier
TIER_BUCKETS = (1, 8, 32)
# the int8 fc8 logits, card vs CPU, relative L2: within this share of
# what int8 itself moves them (the CPU's int8 against its f32 logits).
# The products are exact on both devices for one input; the f32 layers
# between (LRN's kernel against its plain version) differ in the last
# bits, which moves a few per-row int8 codes by one, and each such step
# moves the next layer's inputs by a code's width. A wrong scale, layout
# or product moves the logits by the quantization error or more.
TIER_INT8_SHARE = 0.5
TIER_BF16_LOGITS = 1e-2  # the same for bf16 (one bf16 rounding moves 2^-8)
TIER_TOP5 = 0.99  # share of rows whose top-5 sets agree, card vs CPU
TIER_AGREE_ROWS = 256  # rows of the int8-against-f32 top-1 agreement (printed)
TIER_WATCH_S = 1.0  # the watcher's poll interval
TIER_WATCH_WAIT = 30.0  # seconds the watch may take to serve a new file
TIER_CLIENTS = 4


def _tier_rows(seed, n, shape=(227, 227, 3)):
    """Seeded N(0, 1) rows, 3 decimals (small JSON bodies; the CPU gets
    the same values)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return np.round(rng.normal(size=(n,) + shape), 3).astype(np.float32)


def _tier_state(path, net, seed):
    """A solverstate of ``net``'s filler weights from ``seed`` (the JAX
    layout the file holds). -> the CPU weights."""
    import torch

    from sparknet_tpu_torch.nets.weights import to_jax_params
    from sparknet_tpu_torch.solver.snapshot import save_state

    params, state = net.init(torch.Generator().manual_seed(seed))
    save_state(path, params=to_jax_params(params, net), state={}, iter=0)
    return params, state


def _tier_torn(src, path):
    """The first half of ``src`` at ``path``, cut before it takes its
    name (as a crash mid-write leaves a file), so no reader sees it
    whole."""
    with open(src, "rb") as f, open(path + ".part", "wb") as out:
        out.write(f.read(os.path.getsize(src) // 2))
    os.replace(path + ".part", path)
    return path


def _tier_precision(quant, x, shared, agree=None):
    """One precision of full-width AlexNet on the card against the same
    engine on the CPU (module docstring, phase serving-tier)."""
    import numpy as np
    import torch

    from sparknet_tpu_torch.models import ALEXNET_DEPLOY
    from sparknet_tpu_torch.ops.lrn import lrn_rows
    from sparknet_tpu_torch.serve import quantize as q
    from sparknet_tpu_torch.serve.engine import InferenceEngine
    from sparknet_tpu_torch.serve.metrics import ServeMetrics

    metrics = ServeMetrics(TIER_BUCKETS)
    card = InferenceEngine.from_files(ALEXNET_DEPLOY, device="cuda", buckets=TIER_BUCKETS,
                                      quant=quant, metrics=metrics)
    cpu = InferenceEngine.from_files(ALEXNET_DEPLOY, device="cpu", buckets=TIER_BUCKETS,
                                     quant=quant)
    for layer, e in card.params.items():
        for name, t in e.items():
            if not torch.equal(t.cpu(), cpu.params[layer][name]):
                raise AssertionError(f"{quant} {layer}.{name}: card and CPU differ")
    card.warmup()
    lrn_rows.launches = 0
    # bucket calls of 1, 5 (padded to 8) and 32 real rows, and 8 rows whose
    # first 5 are the padded call's
    outs = {n: card.infer(x[:n]) for n in (1, 5, 32)}
    full = card.infer(np.concatenate([x[:5], x[32:35]]))
    if not np.array_equal(full[:5], outs[5]):
        raise AssertionError(f"{quant}: the 5 rows padded to bucket 8 differ from the same "
                             "rows beside 3 real ones")
    ms = {}
    for b in TIER_BUCKETS:
        times = []
        for _ in range(8):
            t0 = time.perf_counter()
            card.infer(x[:b])
            times.append((time.perf_counter() - t0) * 1e3)
        ms[b] = statistics.median(times[2:])
    want = cpu.infer(x[:32])
    got = outs[32]
    idx, idx_cpu = card.postprocess(got, 5)[0], cpu.postprocess(want, 5)[0]
    same = float(np.mean([set(a) == set(b) for a, b in zip(idx, idx_cpu)]))
    if quant == "f32":
        _check_topk(f"{quant} bucket 32", idx, idx_cpu, want)
    elif quant == "int8" and same < TIER_TOP5:
        raise AssertionError(f"{quant}: top-5 sets agree on {same:.3f} of 32 rows")
    line = (f"  {quant}: weights card = CPU bit for bit; resident {q.tree_bytes(card.params)} "
            f"bytes; median ms a bucket call (host clock, 6 of 8) "
            + ", ".join(f"b{b} {ms[b]:.3f}" for b in TIER_BUCKETS)
            + f"; top-5 sets equal on {same:.3f} of 32 rows; padded rows = real rows bit for bit")
    # the shared batch: logits, and each int8 layer's accumulator on the
    # CPU's own layer input (a comparison: its 2 LRN launches are not
    # the engine's)
    before = lrn_rows.launches
    xs = torch.from_numpy(shared)
    with torch.inference_mode():
        if quant == "int8":
            cb, _ = q.apply_int8(cpu.net, cpu.params, cpu.state, {"data": xs})
            gb, _ = q.apply_int8(card.net, card.params, card.state, {"data": xs.cuda()})
            accs = 0
            for lp in card.net.layers:
                if q.SCALE_KEY not in card.params.get(lp.name, {}):
                    continue
                fn = q.conv_int8_acc if lp.type == "Convolution" else q.ip_int8_acc
                inp = cb[lp.bottom[0]]
                a_cpu, _ = fn(lp, cpu.params[lp.name], inp)
                a_card, _ = fn(lp, card.params[lp.name], inp.cuda())
                if a_card.dtype != torch.int32 or not torch.equal(a_card.cpu(), a_cpu):
                    raise AssertionError(f"int8 {lp.name}: int32 accumulators differ")
                accs += 1
            line += f"; {accs} int8 layers' int32 accumulators card = CPU exactly"
        else:
            cb, _ = cpu.net.apply(cpu.params, cpu.state, {"data": xs.to(cpu.compute_dtype)},
                                  train=False, compute_dtype=cpu.compute_dtype)
            gb, _ = card.net.apply(card.params, card.state,
                                   {"data": xs.cuda().to(card.compute_dtype)}, train=False,
                                   compute_dtype=card.compute_dtype)
    direct = lrn_rows.launches - before
    rel = _rel(gb["fc8"].float(), cb["fc8"].float())
    tol = {"bf16": TIER_BF16_LOGITS}.get(quant)
    if quant == "int8":
        with torch.inference_mode():
            f32, _ = cpu.net.apply(cpu._ref_params, cpu._ref_state, {"data": xs}, train=False)
        quant_err = _rel(cb["fc8"], f32["fc8"])
        tol = TIER_INT8_SHARE * quant_err
        line += ("; card vs CPU rel L2 by int8 layer output " + ", ".join(
            f"{lp.name} {_rel(gb[lp.top[0]], cb[lp.top[0]]):.1e}" for lp in card.net.layers
            if q.SCALE_KEY in card.params.get(lp.name, {}))
                 + f"; the CPU's int8 fc8 against its f32 {quant_err:.3e}")
    line += f"; fc8 logits rel L2 {rel:.3e}" + (f" (tol {tol:.3e})" if tol else "")
    if tol is not None and rel > tol:
        raise AssertionError(f"{quant}: fc8 logits card vs CPU rel L2 {rel:.3e} > {tol:g}")
    # rows for the int8 against f32 top-1 agreement, printed (not held)
    top1 = None if agree is None else card.postprocess(np.concatenate(
        [card.infer(agree[i:i + 32]) for i in range(0, len(agree), 32)]), 1)[0][:, 0]
    calls = sum(e["batches"] for e in metrics.snapshot()["per_bucket"].values())
    launches = lrn_rows.launches - direct
    line += (f"; LRN kernel launches {launches} over {calls} bucket calls (and {direct} in "
             "the shared batch's comparison)")
    log(line)
    if calls == 0 or launches != 2 * calls or direct != 2:
        raise AssertionError(f"{quant}: {launches} LRN launches over {calls} bucket calls, "
                             f"{direct} in one forward of the shared batch")
    return {"ms": ms, "bytes": q.tree_bytes(card.params), "launches": launches,
            "top1": top1, "engine": card, "cpu": cpu}


def tier_clients(spec_path):
    """``--tier-client SPEC``: TIER_CLIENTS closed-loop clients on the
    server's ``/classify`` (one seeded row a request), in a process of
    their own so that their JSON work does not share the server's
    interpreter, until the spec's stop file appears; then each answer's
    (client, request, generation tag, top-5) and the failures to the
    spec's output file. Against a router (``"router"`` in the spec) each
    request is one POST with its own timeout and no client retry, and an
    answer also records the replica that answered (``X-Sparknet-Replica``),
    its precision and its send and receive times (the wall clock)."""
    import threading

    from sparknet_tpu_torch.serve.server import Client

    spec = json.load(open(spec_path))
    answers, failed = [], []

    def run(i):
        client = Client(spec["host"], spec["port"], timeout=120, retries=4)
        k = 0
        while not os.path.exists(spec["stop"]):
            try:
                row = _tier_rows(1000 * (i + 1) + k, 1)
                if spec.get("router"):
                    t_send = time.time()
                    code, body, replica = _router_call(spec["host"], spec["port"], row,
                                                       spec["timeout"])
                    if code != 200:
                        raise RuntimeError(f"HTTP {code}: {body}")
                    answers.append((i, k, body["gen"], body["indices"][0], int(replica),
                                    body["quant"], t_send, time.time()))
                else:
                    code, body = client.classify(row, top_k=5)
                    if code != 200:
                        raise RuntimeError(f"HTTP {code}: {body}")
                    answers.append((i, k, body["gen"], body["indices"][0]))
            except Exception as e:  # counted: the phase requires none
                failed.append(f"client {i} request {k}: {type(e).__name__}: {e}")
            k += 1

    threads = [threading.Thread(target=run, args=(i,)) for i in range(TIER_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    with open(spec["out"], "w") as f:
        json.dump({"answers": answers, "failed": failed}, f)
    return 0


def _router_call(host, port, row, timeout):
    """One ``/classify`` of ``row`` -> (status, body, X-Sparknet-Replica)."""
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", "/classify", body=json.dumps({"rows": row.tolist(), "top_k": 5}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}"), resp.getheader("X-Sparknet-Replica")
    finally:
        conn.close()


class _Traffic:
    """The ``--tier-client`` process against ``server``, from start to
    :meth:`finish` -> its answers (client, request, generation, top-5,
    and against a router the replica, precision, send and receive times)
    and failures; against one server, raises where a client's
    generations went down (a tier's generations are per replica)."""

    def __init__(self, server, tmp, router=False):
        self.router = router
        self.spec = os.path.join(tmp, "clients.json")
        self.stop, self.out = self.spec + ".stop", self.spec + ".out"
        with open(self.spec, "w") as f:
            json.dump({"host": server.host, "port": server.port, "stop": self.stop,
                       "out": self.out, "router": router, "timeout": ROUTER_CLIENT_TIMEOUT},
                      f)
        self.proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                      "--tier-client", self.spec])

    def finish(self):
        open(self.stop, "w").close()
        try:
            rc = self.proc.wait(180)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        if rc != 0:
            raise AssertionError(f"the client process exited {rc}")
        res = json.load(open(self.out))
        answers = sorted(res["answers"])
        for i in range(0 if self.router else TIER_CLIENTS):
            gens = [a[2] for a in answers if a[0] == i]
            if gens != sorted(gens):
                raise AssertionError(f"client {i}: generations went down: {gens}")
        return answers, res["failed"]


def _tier_hot_swap(tmp, eng, ref, int8):
    """Hot swaps of ``eng`` (f32, on the card) through ``/reload`` under
    closed-loop traffic, then the server's own snapshot watch, each
    answer held against ``ref`` (the same engine on the CPU) on its
    generation's weights; then ``int8``'s swap from a file (module
    docstring)."""
    import numpy as np
    import torch

    from sparknet_tpu_torch.serve import quantize as q
    from sparknet_tpu_torch.serve.server import InferenceServer

    watch = os.path.join(tmp, "watch")
    os.makedirs(watch)
    w = {0: (ref.params, ref.state)}
    s1 = os.path.join(tmp, "alexnet_iter_10.solverstate.npz")
    w[1] = _tier_state(s1, ref.net, 1)
    torn = _tier_torn(s1, os.path.join(tmp, "alexnet_iter_20.solverstate.npz"))
    from sparknet_tpu_torch.ops.lrn import lrn_rows

    def calls():
        return sum(e["batches"] for e in eng.metrics.snapshot()["per_bucket"].values())

    server = InferenceServer(eng, port=0, watch=watch, watch_interval_s=TIER_WATCH_S)
    server.batcher.wait_ready(120)
    calls0, lrn0 = calls(), lrn_rows.launches
    server.start()
    traffic = _Traffic(server, tmp)
    answers = failed = None
    t0 = time.perf_counter()  # the clients' process starts up first
    while server.metrics.requests < TIER_CLIENTS and time.perf_counter() - t0 < 120:
        time.sleep(0.05)
    reloads, gens = [], [eng.generation]
    try:
        client = server.client(timeout=120)

        def reload(body, want):
            time.sleep(0.7)  # traffic on the generation before
            t0 = time.perf_counter()
            code, resp = client._request("POST", "/reload", body)
            reloads.append((json.dumps(body)[:60], code, (time.perf_counter() - t0) * 1e3))
            if code != want:
                raise AssertionError(f"/reload {body}: {code} {resp}, want {want}")
            return resp

        g = reload({"weights": s1}, 200)["generation"]  # 1. the written state
        reload({"weights": torn}, 409)  # 2. torn: refused
        if eng.generation != g:
            raise AssertionError("a torn reload moved the generation")
        g = reload({"rollback": True}, 200)["generation"]  # 3. back to the boot weights
        w[g] = w[0]
        reload({"rollback": True}, 409)  # 4. consumed
        # the watch: a torn newer file first (held until a poll skipped
        # it), then an intact one
        seen0 = server._watcher.torn_seen
        _tier_torn(s1, os.path.join(watch, "alexnet_iter_200.solverstate.npz"))
        t0 = time.perf_counter()
        while server._watcher.torn_seen == seen0 and time.perf_counter() - t0 < TIER_WATCH_WAIT:
            time.sleep(0.05)
        if server._watcher.torn_seen == seen0 or eng.generation != g:
            raise AssertionError(f"the watcher did not skip a torn snapshot (generation "
                                 f"{eng.generation}, was {g})")
        good = os.path.join(watch, "alexnet_iter_100.solverstate.npz")
        w2 = _tier_state(good + ".part", ref.net, 2)
        os.replace(good + ".part", good)
        t0 = time.perf_counter()  # a tick reads and checks the 243.9 MB file, then the
        while eng.generation == g and time.perf_counter() - t0 < TIER_WATCH_WAIT:  # swap
            time.sleep(0.05)
        picked = time.perf_counter() - t0
        if eng.generation != g + 1 or eng.weights_source != good:
            from sparknet_tpu_torch.serve import hotswap

            torn_seen = []
            got = hotswap.newest_verified(watch, on_torn=lambda p, e: torn_seen.append(
                f"{p}: {e!r}"[:300]))
            raise AssertionError(
                f"the watcher did not serve {good} in {picked:.1f} s (generation "
                f"{eng.generation}, source {eng.weights_source}; watcher last_iter "
                f"{server._watcher.last_iter}, torn_seen {server._watcher.torn_seen}, thread "
                f"alive {server._watcher._thread.is_alive()}; newest_verified now {got}, "
                f"torn {torn_seen}; files {sorted(os.listdir(watch))}; a reload now "
                f"{server.reload(good)})")
        w[g + 1] = w2
        time.sleep(0.7)
        code, health = client.healthz()
    finally:
        try:
            answers, failed = traffic.finish()
        finally:
            server.stop()
    if failed:
        raise AssertionError(f"{len(failed)} failed requests: {failed[:3]}")
    n_calls, n_lrn = calls() - calls0, lrn_rows.launches - lrn0
    if n_lrn != 2 * n_calls:
        raise AssertionError(f"under swap: {n_lrn} LRN launches over {n_calls} bucket calls")
    seen = sorted({a[2] for a in answers})
    # each answer against the CPU engine on its generation's weights
    for gen in seen:
        if gen not in w:
            raise AssertionError(f"answers tagged with unknown generation {gen}")
        rows = [a for a in answers if a[2] == gen]
        ref.swap(*w[gen])
        x = np.concatenate([_tier_rows(1000 * (a[0] + 1) + a[1], 1) for a in rows])
        probs = ref.infer(x)
        _check_topk(f"generation {gen}", [a[3] for a in rows], ref.postprocess(probs, 5)[0],
                    probs)
    log(f"  hot swap under {TIER_CLIENTS} closed-loop clients (a process of their own): "
        f"{len(answers)} "
        f"answers, 0 failed, generations {seen} never decreasing per client, each answer's "
        f"top-5 = the CPU engine's on its generation's weights; /reload "
        + "; ".join(f"{b} -> {c} in {ms:.1f} ms" for b, c, ms in reloads)
        + f"; the watch skipped a torn newer file and served iteration 100 {picked:.2f} s "
        f"after it was written (poll {TIER_WATCH_S} s); /healthz {code} gen "
        f"{health['generation']} quant {health['quant']}; LRN kernel launches {n_lrn} over "
        f"{n_calls} bucket calls")
    # 5. the int8 engine from a file: the scales captured anew
    srv8 = InferenceServer(int8, port=0)
    before = {l: e[q.SCALE_KEY].clone() for l, e in int8.params.items() if q.SCALE_KEY in e}
    t0 = time.perf_counter()
    code, resp = srv8.reload(s1)
    ms8 = (time.perf_counter() - t0) * 1e3
    srv8.close()
    want = q.quantize_tree(ref.net, w[1][0])
    for l, s in before.items():
        got = int8.params[l][q.SCALE_KEY].cpu()
        if torch.equal(got, s.cpu()) or not torch.equal(got, want[l][q.SCALE_KEY]):
            raise AssertionError(f"int8 {l}: the swap did not capture the file's scales")
        if not torch.equal(int8.params[l]["weight"].cpu(), want[l]["weight"]):
            raise AssertionError(f"int8 {l}: int8 weights differ from the CPU's of the file")
    log(f"  int8 /reload of the written state: {code} in {ms8:.1f} ms (host load + merge onto "
        f"the f32 tree + quantize on the card), gen {resp.get('generation')}; every scale and "
        f"int8 weight anew, = the CPU's quantization of the file bit for bit")
    return len(answers)


def _tier_sessions(tmp):
    """char_rnn's deploy net through ``/generate`` on the card (module
    docstring); -> the rows-across-widths finding."""
    import numpy as np
    import torch

    from sparknet_tpu_torch.models import CHAR_RNN_DEPLOY
    from sparknet_tpu_torch.serve.engine import InferenceEngine
    from sparknet_tpu_torch.serve.loadgen import run_http_loadgen
    from sparknet_tpu_torch.serve.server import InferenceServer

    eng = InferenceEngine.from_files(CHAR_RNN_DEPLOY, device="cuda")
    cpu = InferenceEngine.from_files(CHAR_RNN_DEPLOY, device="cpu")
    # rows across widths: the same 4 session rows (1 at width 1), 3
    # steps, at each width, against width 4's
    stepper = eng._stepper
    params, state, _, _ = eng._weights_snapshot()
    gen = torch.Generator().manual_seed(0)
    toks = [torch.randint(0, stepper.vocab, (4,), generator=gen) for _ in range(3)]
    rows = {}
    for width in (1, 4, 8, 16, 32):
        n = min(width, 4)
        carry = stepper.init_carry(width)
        for t in toks:
            tok = torch.zeros(width, dtype=torch.int32)
            tok[:n] = t[:n]
            out, carry = stepper.step_fn(params, state, carry, tok.cuda())
        rows[width] = torch.cat([out[:n]] + [a[:n] for tup in carry.values() for a in tup], 1)
    stable = {w: torch.equal(r, rows[4][:len(r)]) for w, r in rows.items()}
    eng.warmup()
    log(f"  char_rnn rows across widths, 3 steps, bitwise equal to width 4's rows: "
        + ", ".join(f"{w}: {s}" for w, s in stable.items())
        + f"; the engine's ladder check: stable {eng.decode_ladder_stable}, decode widths "
        f"{eng.decode_buckets}")
    server = InferenceServer(eng, port=0, model_name="char_rnn_deploy.prototxt")
    server.batcher.wait_ready(120)
    server.start()
    try:
        c = server.client(timeout=120)
        prefix = [int(v) for v in np.random.default_rng(7).integers(0, 96, 12)]
        t0 = time.perf_counter()
        _, cold0 = c.generate(prefix, session="a", steps=4)
        cold_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        _, hit = c.generate(prefix + cold0["tokens"] + [5], session="a", steps=4)
        hit_ms = (time.perf_counter() - t0) * 1e3
        _, cold = c.generate(prefix + cold0["tokens"] + [5], steps=4)
        if (hit["cache_state"], cold["cache_state"]) != ("hit", "cold") or any(
                hit[k] != cold[k] for k in ("probs", "indices", "tokens")):
            raise AssertionError(f"hit {hit} != cold {cold}")
        # the card's answer against the CPU engine's (no greedy step: random
        # weights make near-ties of the argmax)
        _, got = c.generate(prefix, top_k=96)
        want = cpu.generate(prefix, top_k=96)
        order = np.argsort(got["indices"])
        rel = float(np.linalg.norm(np.subtract(np.asarray(got["probs"])[order],
                                               np.asarray(want["probs"])[np.argsort(
                                                   want["indices"])]))
                    / np.linalg.norm(want["probs"]))
        if rel > 1e-4:
            raise AssertionError(f"char_rnn probs card vs CPU rel L2 {rel:.2e} > 1e-4")
        _, reb = c.generate([1, 2, 3], session="a")
        _, reb_cold = c.generate([1, 2, 3])
        if reb["cache_state"] != "rebuilt" or reb["probs"] != reb_cold["probs"]:
            raise AssertionError(f"prefix mismatch: {reb['cache_state']}")
        _, s1 = c.generate(prefix, session="b", steps=2)
        path = os.path.join(tmp, "char_iter_5.solverstate.npz")
        _tier_state(path, cpu.net, 1)
        code, resp = c.reload(path)
        _, stale = c.generate(prefix + s1["tokens"], session="b")
        _, fresh = c.generate(prefix + s1["tokens"])
        if code != 200 or stale["cache_state"] != "stale_gen" or stale["probs"] != \
                fresh["probs"] or stale["gen"] != resp["generation"]:
            raise AssertionError(f"hot swap: {code} {stale['cache_state']}")
        rec = run_http_loadgen(server.host, server.port, (), n_requests=64, concurrency=4,
                               sessions=8, session_zipf=1.1, session_steps=4, seed=0)
        _, health = c.healthz()
    finally:
        server.stop()
    if rec["failed_requests"] or rec["session_failed_requests"]:
        raise AssertionError(f"session loadgen: {rec['error_samples']}")
    log(f"  sessions on the card: hit = cold bit for bit ({len(prefix) + 5}-token prefix, 4 "
        f"steps; the hit stepped {hit['steps_run']} tokens in {hit_ms:.1f} ms, the cold start "
        f"{cold0['steps_run']} in {cold_ms:.1f} ms, HTTP included); the 12-token answer = the "
        f"CPU engine's within {rel:.2e} rel L2 (tol 1e-4); a prefix mismatch rebuilt; a hot swap made the session "
        f"stale_gen and rebuilt it; loadgen 8 sessions, Zipf 1.1, 4 steps: 64 requests, 0 "
        f"failed, states {rec['sessions']['states']}, {rec['sessions']['tokens_per_sec']} "
        f"tokens/s, p50 {rec['p50_ms']} ms; decode {health.get('decode')}")
    return {"stable": stable, "ladder": eng.decode_ladder_stable}


def phase_serving_tier(tmp):
    """The serving tier of one process (module docstring, phase
    serving-tier); -> the LRN launches of its engines."""
    import numpy as np

    t0 = time.perf_counter()
    secs = {}
    x = _tier_rows(0, 40)
    shared = x[:8]
    agree = _tier_rows(1, TIER_AGREE_ROWS)
    res = {quant: _tier_precision(quant, x, shared, None if quant == "bf16" else agree)
           for quant in ("f32", "bf16", "int8")}
    top1 = float(np.mean(res["int8"]["top1"] == res["f32"]["top1"]))
    log(f"  int8 against f32 top-1 agreement on {TIER_AGREE_ROWS} rows, card: {top1:.4f} "
        f"(printed, not held); resident bytes f32 {res['f32']['bytes']}, bf16 "
        f"{res['bf16']['bytes']}, int8 {res['int8']['bytes']}")
    secs["precisions"] = time.perf_counter() - t0
    served = _tier_hot_swap(tmp, res["f32"]["engine"], res["f32"]["cpu"], res["int8"]["engine"])
    secs["swap"] = time.perf_counter() - t0 - sum(secs.values())
    from sparknet_tpu_torch.ops.lrn import lrn_rows

    # the counter was last set to 0 at the int8 engine's start: it holds
    # that engine's launches, 2 of its comparison and the traffic's
    lrn = res["f32"]["launches"] + res["bf16"]["launches"] + lrn_rows.launches - 2
    sessions = _tier_sessions(tmp)
    secs["sessions"] = time.perf_counter() - t0 - sum(secs.values())
    log(f"  serving-tier phase {time.perf_counter() - t0:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()) + f"); {served} answers under swap")
    return {"launches": lrn, "sessions": sessions}


# ------------------------------------------------------------ router tier
ROUTER_CLIENT_TIMEOUT = 60.0  # a request's own client timeout (s); expired = failed
ROUTER_WAIT = 120.0  # seconds a tier may take to come up, a respawn to rejoin
ROUTER_BUDGET_S = 150.0  # the phase's budget, printed against (not a gate)
ROUTER_INT8_TOP5 = TIER_TOP5  # share of int8 answers whose top-5 sets hold


def _router_argv(weights, run_dir, *extra):
    """The tool's argv of the phase's tier: full-width AlexNet from
    ``weights``, 2 replicas, replica 1 int8, half the requests preferring
    it, the kernels loaded from the build phase's directory."""
    from sparknet_tpu_torch.models import ALEXNET_DEPLOY
    from sparknet_tpu_torch.ops import _build

    return ["--model", ALEXNET_DEPLOY, "--weights", weights, "--replicas", "2",
            "--quant", "int8", "--quant-ab", "0.5", "--port", "0", "--run-dir", run_dir,
            "--buckets", ",".join(map(str, TIER_BUCKETS)),
            "--compile-cache", _build.BUILD_DIR, *extra]


def _alive(pid):
    """Is ``pid`` a live process (not gone, not a zombie)?"""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False


def _reap(pids, grace=15.0):
    """SIGKILL whatever of ``pids`` is still alive after ``grace`` s;
    raises when one outlives that."""
    import signal

    deadline = time.perf_counter() + grace
    while any(_alive(p) for p in pids) and time.perf_counter() < deadline:
        time.sleep(0.1)
    left = [p for p in pids if _alive(p)]
    for p in left:
        try:
            os.kill(p, signal.SIGKILL)
        except ProcessLookupError:
            pass
    time.sleep(0.5)
    still = [p for p in left if _alive(p)]
    if left:
        raise AssertionError(f"replica processes {left} outlived their router"
                             + (f"; {still} survive SIGKILL" if still else ""))


def _wait_for(what, pred, limit=ROUTER_WAIT, proc=None, tail=None):
    t0 = time.perf_counter()
    while not pred():
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"{what}: the router exited {proc.returncode}"
                                 + (f":\n{tail()}" if tail else ""))
        if time.perf_counter() - t0 > limit:
            raise AssertionError(f"{what}: not within {limit:.0f} s"
                                 + (f":\n{tail()}" if tail else ""))
        time.sleep(0.05)
    return time.perf_counter() - t0


def _router_cli(tmp, weights, cpu):
    """``python -m sparknet_tpu_torch.tools.serve --replicas 2`` as a
    process of its own session: up, both replicas healthy with their
    precisions, one answer from each held against the CPU engine of its
    precision, then SIGTERM: exit 0 and no replica left alive."""
    import signal

    import numpy as np

    run = os.path.join(tmp, "cli_run")
    pf = os.path.join(tmp, "cli_router.json")
    out = os.path.join(tmp, "cli_router.log")
    cmd = [sys.executable, "-m", "sparknet_tpu_torch.tools.serve",
           *_router_argv(weights, run, "--portfile", pf)]
    t0 = time.perf_counter()
    with open(out, "w") as f:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT,
                                start_new_session=True)
    tail = lambda: open(out).read()[-3000:]
    pids = set()
    try:
        _wait_for("the CLI tier", lambda: os.path.exists(pf), proc=proc, tail=tail)
        up_s = time.perf_counter() - t0
        router = json.load(open(pf))
        files = [json.load(open(os.path.join(run, f"replica-{i}-s0.json"))) for i in range(2)]
        pids |= {d["pid"] for d in files}
        from sparknet_tpu_torch.serve.server import Client

        code, hz = Client(router["host"], router["port"], timeout=60).healthz()
        quants = [r["quant"] for r in hz["replicas"]]
        if code != 200 or hz["replicas_healthy"] != 2 or quants != ["f32", "int8"]:
            raise AssertionError(f"CLI tier /healthz {code}: {hz}")
        x = _tier_rows(7, 6)
        seen = {}
        for k in range(6):
            code, body, replica = _router_call(router["host"], router["port"], x[k:k + 1],
                                               ROUTER_CLIENT_TIMEOUT)
            if code != 200:
                raise AssertionError(f"CLI tier /classify {code}: {body}")
            seen.setdefault(body["quant"], []).append((k, body["indices"][0]))
        if set(seen) != {"f32", "int8"}:
            raise AssertionError(f"the A/B at 0.5 answered from {sorted(seen)} only")
        for quant, got in seen.items():
            probs = cpu[quant].infer(x[[k for k, _ in got]])
            idx = cpu[quant].postprocess(probs, 5)[0]
            if quant == "f32":
                _check_topk("CLI tier f32", [g for _, g in got], idx, probs)
            elif np.mean([set(g) == set(i) for (_, g), i in zip(got, idx)]) < 1:
                raise AssertionError(f"CLI tier int8: top-5 sets {got} vs the CPU's {idx}")
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(60)
        stop_s = time.perf_counter() - t1
        if rc != 0:
            raise AssertionError(f"the CLI router exited {rc} on SIGTERM:\n{tail()}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(30)
        _reap(pids)
    log(f"  tools.serve --replicas 2 --quant int8 --quant-ab 0.5 (a process): healthy in "
        f"{up_s:.1f} s (its port file written); replica warmup_s "
        f"{[d['warmup_s'] for d in files]}, compile_cache entries before/after "
        f"{[(d['compile_cache'] or {}).get('entries') for d in files]}/"
        f"{[(d['compile_cache'] or {}).get('entries_after') for d in files]}; /healthz 2 "
        f"healthy, quant {quants}; 6 answers = the CPU engine's of their precision; SIGTERM: "
        f"exit 0 in {stop_s:.1f} s, replicas {sorted(pids)} gone")
    return up_s


class _Lines:
    """``sys.stdout`` for the phase: passes every write on and keeps the
    router's ``retry:`` lines."""

    def __init__(self, out):
        import threading

        self.out, self.retries = out, []
        self._lock = threading.Lock()  # the router's handler threads print

    def write(self, text):
        # print() writes its message and its newline in two calls, which
        # threads interleave: a retry line is one whole write
        with self._lock:
            if text.startswith("retry: "):
                try:
                    self.retries.append(json.loads(text[len("retry: "):]))
                except ValueError:
                    self.retries.append({"unparsed": text})
            return self.out.write(text)

    def flush(self):
        self.out.flush()


def _widths(router, stop, seen):
    """Sample the router's replicas every 20 ms until ``stop``: (time,
    healthy count, each replica's generation)."""
    while not stop.is_set():
        with router._lock:
            seen.append((time.time(), sum(r.healthy for r in router.replicas),
                         [r.generation for r in router.replicas]))
        time.sleep(0.02)


def _roll(router, how, *arg):
    """``router.roll`` or ``roll_back`` while the widths are sampled ->
    (code, doc, ms, start, end, least healthy width, the order in which
    the replicas' generations moved)."""
    import threading

    seen, stop = [], threading.Event()
    th = threading.Thread(target=_widths, args=(router, stop, seen))
    th.start()
    time.sleep(0.1)
    t_a, p0 = time.time(), time.perf_counter()
    code, doc = getattr(router, how)(*arg)
    ms = (time.perf_counter() - p0) * 1e3
    t_b = time.time()
    time.sleep(0.1)
    stop.set()
    th.join()
    gens0 = seen[0][2]
    moved = []
    for _, _, gens in seen:
        for i, (g, g0) in enumerate(zip(gens, gens0)):
            if g != g0 and i not in moved:
                moved.append(i)
    return code, doc, ms, t_a, t_b, min(w for _, w, _ in seen), moved


def _router_answers(answers, epochs, cpu, w):
    """Each answer's top-5 against the CPU engine of its precision on
    the weights its replica could have served between its send and its
    receive (``epochs``: (start, end, the weights' keys) by wall clock);
    f32 as the serving phase holds it, int8 top-5 sets on at least
    ROUTER_INT8_TOP5 of the answers. -> the answers by precision."""
    import numpy as np

    def allowed(t_send, t_recv):
        return frozenset(k for a, b, keys in epochs if a <= t_recv and b >= t_send
                         for k in keys)

    by = {}
    for a in answers:
        by.setdefault((a[5], allowed(a[6], a[7])), []).append(a)
    groups = sorted(by.items(), key=lambda kv: (kv[0][0], sorted(kv[0][1])))
    xs = [np.concatenate([_tier_rows(1000 * (a[0] + 1) + a[1], 1) for a in group])
          for _, group in groups]
    matches = [np.zeros(len(group), bool) for _, group in groups]
    # each precision's engine loads each weights file once, for every group
    # whose answers it could have served
    for quant, key in sorted({(q, k) for (q, keys), _ in groups for k in keys}):
        eng = cpu[quant]
        eng.swap_from_file(w[key])
        for g, ((q, keys), group) in enumerate(groups):
            if q != quant or key not in keys:
                continue
            x, match = xs[g], matches[g]
            probs = np.concatenate([eng.infer(x[i:i + 32]) for i in range(0, len(x), 32)])
            idx = eng.postprocess(probs, 5)[0]
            for r, a in enumerate(group):
                got = np.asarray(a[3])
                if quant == "int8":
                    match[r] |= set(got.tolist()) == set(idx[r].tolist())
                elif np.array_equal(got, idx[r]) or np.allclose(
                        probs[r][got], probs[r][idx[r]], rtol=1e-5, atol=0):
                    match[r] = True
    ok8 = n8 = 0
    held = {"f32": 0, "int8": 0}
    for ((quant, keys), group), match in zip(groups, matches):
        held[quant] += len(group)
        if quant == "int8":
            ok8 += int(match.sum())
            n8 += len(group)
        elif not match.all():
            bad = [(group[r][:2], group[r][4], sorted(keys)) for r in np.flatnonzero(~match)]
            raise AssertionError(f"f32 answers not from any weights their replica could have "
                                 f"served: {bad[:5]}")
    if n8 and ok8 / n8 < ROUTER_INT8_TOP5:
        raise AssertionError(f"int8 answers: top-5 sets hold on {ok8}/{n8}")
    return held, (ok8, n8)


def phase_router_tier(tmp):
    """The serving tier across processes (module docstring, phase
    router-tier)."""
    import signal
    import threading
    import urllib.request

    from sparknet_tpu_torch.models import ALEXNET_DEPLOY
    from sparknet_tpu_torch.serve.engine import InferenceEngine
    from sparknet_tpu_torch.telemetry import reqtrace
    from sparknet_tpu_torch.telemetry.registry import REGISTRY
    from sparknet_tpu_torch.tools import serve as tool

    t0 = time.perf_counter()
    secs = {}
    os.environ["SPARKNET_REQTRACE"] = "1"  # the tier's children inherit it
    reqtrace.configure_from_env()
    cpu = {q: InferenceEngine.from_files(ALEXNET_DEPLOY, device="cpu", buckets=TIER_BUCKETS,
                                         quant=q) for q in ("f32", "int8")}
    w = {seed: os.path.join(tmp, f"alexnet_iter_{10 * seed}.solverstate.npz")
         for seed in (0, 1, 2)}
    for seed, path in w.items():
        _tier_state(path, cpu["f32"].net, seed)
    torn = _tier_torn(w[1], os.path.join(tmp, "alexnet_iter_30.solverstate.npz"))
    secs["weights"] = time.perf_counter() - t0
    # the CLI tier, a process of its own, comes up and goes beside this
    # process's tier coming up; it has ended before the traffic starts
    cli = {}

    def run_cli():
        try:
            _router_cli(tmp, w[0], cpu)
        except BaseException as e:  # raised again below, after the join
            cli["error"] = e

    cli_thread = threading.Thread(target=run_cli, name="router-cli")
    cli_thread.start()

    run = os.path.join(tmp, "run")
    args = tool.parse_args(_router_argv(w[0], run, "--health-interval-s", "0.25"))
    router, pool, run_dir = tool.build_tier(args)
    lines = _Lines(sys.stdout)
    sys.stdout = lines
    pids, traffic, answers, failed = set(), None, None, None
    hop0 = REGISTRY.counter("router_events", event="retry_hop").snapshot()
    quant0 = {v: REGISTRY.counter("router_quant_answers", variant=v).snapshot()
              for v in ("f32", "int8")}

    def portfile(i, s):
        return json.load(open(tool._portfile(run_dir, i, s)))

    def get(path):
        with urllib.request.urlopen(f"http://{router.host}:{router.port}{path}",
                                    timeout=60) as resp:
            return resp.read()

    def respawned(i, spawn, pid):
        return (os.path.exists(tool._portfile(run_dir, i, spawn))
                and router.replicas[i].healthy and router.replicas[i].pid == pid)

    try:
        t1 = time.perf_counter()
        pool.start()
        router.start()
        if not tool.wait_tier(router, pool, ROUTER_WAIT):
            raise AssertionError(f"the tier did not come up: {pool.snapshot()}")
        up_s = time.perf_counter() - t1
        cli_thread.join(ROUTER_WAIT)
        if cli_thread.is_alive():
            raise AssertionError(f"the CLI tier's check did not end in {ROUTER_WAIT:.0f} s")
        if "error" in cli:
            raise cli["error"]
        boot = [portfile(i, 0) for i in range(2)]
        pids |= {d["pid"] for d in boot}
        hz = router.healthz()
        if [r["quant"] for r in hz["replicas"]] != ["f32", "int8"]:
            raise AssertionError(f"replica precisions {hz['replicas']}")
        log(f"  the tier in this process (the tool's build_tier): healthy in {up_s:.1f} s "
            f"(beside the CLI tier); "
            f"replica warmup_s {[d['warmup_s'] for d in boot]}, compile_cache entries "
            f"{[d['compile_cache']['entries'] for d in boot]} (the build phase's libraries, "
            f"loaded, not built); quant {[r['quant'] for r in hz['replicas']]}")
        secs["cli and up"] = time.perf_counter() - t0 - sum(secs.values())
        traffic = _Traffic(router, tmp, router=True)
        epochs, t_epoch, key = [], time.time(), 0  # (start, end, weights' keys)
        _wait_for("the clients' first answers", lambda: router.metrics.requests >= 2 * TIER_CLIENTS)

        # 1. SIGKILL replica 1 with a request of its in flight
        _wait_for("a request in flight on replica 1", lambda: router.replicas[1].outstanding > 0,
                  limit=30)
        t_kill = time.time()
        os.kill(boot[1]["pid"], signal.SIGKILL)
        _wait_for("replica 1's respawn", lambda: os.path.exists(tool._portfile(run_dir, 1, 1)))
        new1 = portfile(1, 1)
        pids.add(new1["pid"])
        _wait_for("replica 1 rejoining", lambda: respawned(1, 1, new1["pid"]))
        rejoin1 = time.time() - t_kill
        if router.replicas[1].quant != "int8":
            raise AssertionError(f"replica 1 came back as {router.replicas[1].quant}")
        down = [(t_kill, time.time())]
        hops = REGISTRY.counter("router_events", event="retry_hop").snapshot() - hop0
        if hops < 1 or hops != len(lines.retries):
            raise AssertionError(f"{hops} retry hops, {len(lines.retries)} retry: lines")
        # the retried request's stitched waterfall, in /traces
        tid = lines.retries[0]["trace"]
        events = [e for e in json.loads(get("/traces"))["traceEvents"]
                  if e.get("ph") == "X" and e["args"].get("trace") == tid]
        names = [e["name"] for e in events]
        failed_hop = [e for e in events if e["name"] in ("router.dispatch", "router.retry")
                      and e["args"].get("outcome") == "error"]
        served = [e for e in events if e["name"] == "server.request"
                  and e["args"].get("src_pid") in pids]
        if not failed_hop or "router.retry" not in names or not served:
            raise AssertionError(f"/traces of retried request {tid}: {names}")
        rec = [r for r in reqtrace.completed() if r["trace"] == tid]
        cover = reqtrace.coverage(rec[0]) if rec else None
        log(f"  1. SIGKILL replica 1 (pid {boot[1]['pid']}) with a request in flight: "
            f"{hops} retry hop(s) = {len(lines.retries)} retry: line(s) "
            f"({lines.retries[0]['reason']}); respawned as pid {new1['pid']} (warmup_s "
            f"{new1['warmup_s']}, compile_cache entries {new1['compile_cache']['entries']}), "
            f"rejoined int8 {rejoin1:.2f} s after the kill; /traces of retried request "
            f"{tid[:8]}: {names} (failed hop {failed_hop[0]['args'].get('error')!r}), "
            f"coverage {cover}")
        secs["kill1"] = time.perf_counter() - t0 - sum(secs.values())

        # 2. two rolling reloads
        rolls = []
        for new in (1, 2):
            time.sleep(0.5)  # traffic on the generation before
            code, doc, ms, t_a, t_b, width, moved = _roll(router, "roll", w[new])
            gens = [r["generation"] for r in doc.get("rolled", [])]
            if code != 200 or [r["replica"] for r in doc["rolled"]] != [0, 1] or moved != [0, 1]:
                raise AssertionError(f"roll to {w[new]}: {code} {doc}; moved {moved}")
            if width < 1:
                raise AssertionError(f"roll to {w[new]}: healthy width fell to {width}")
            epochs += [(t_epoch, t_a, {key}), (t_a, t_b, {key, new})]
            t_epoch, key = t_b, new
            rolls.append((ms, width, gens))
        log("  2. rolling /reload of two written solverstates, one replica at a time (replica "
            "0's generation moved first): " + "; ".join(
                f"{ms:.1f} ms, least healthy width {wd}, generations {g}"
                for ms, wd, g in rolls))
        # 3. a torn solverstate stops the roll at replica 0
        time.sleep(0.5)
        gens_before = [r.generation for r in router.replicas]
        code, doc = router.roll(torn)
        if code != 502 or doc["rolled"] or not doc["errors"][0].startswith("replica 0") \
                or [r.generation for r in router.replicas] != gens_before \
                or router._serving_weights != w[2]:
            raise AssertionError(f"torn roll: {code} {doc}")
        log(f"  3. torn roll: {code}, {doc['errors'][0][:120]!r}; generations "
            f"{gens_before} unchanged")
        secs["rolls"] = time.perf_counter() - t0 - sum(secs.values())

        # 4. roll_back, then SIGKILL replica 0: its respawn boots on the
        # boot weights and is re-synced before it takes traffic
        time.sleep(1.0)
        code, doc, ms, t_a, t_b, width, moved = _roll(router, "roll_back", "chip_smoke")
        if code != 200 or [r["replica"] for r in doc["rolled_back"]] != [0, 1] \
                or router._serving_weights != w[1]:
            raise AssertionError(f"roll_back: {code} {doc}; serving {router._serving_weights}")
        epochs += [(t_epoch, t_a, {key}), (t_a, t_b, {key, 1})]
        t_epoch, key = t_b, 1
        time.sleep(1.0)
        t_kill = time.time()
        os.kill(boot[0]["pid"], signal.SIGKILL)
        _wait_for("replica 0's respawn", lambda: os.path.exists(tool._portfile(run_dir, 0, 1)))
        new0 = portfile(0, 1)
        pids.add(new0["pid"])
        _wait_for("replica 0 rejoining", lambda: respawned(0, 1, new0["pid"]))
        rejoin0 = time.time() - t_kill
        down.append((t_kill, time.time()))
        r0 = router.replicas[0]
        if (r0.weights_source, r0.quant, new0["generation"], r0.generation) != (w[1], "f32", 0, 1):
            raise AssertionError(f"replica 0's respawn: {r0.snapshot()}, port file {new0}")
        log(f"  4. roll_back: {ms:.1f} ms, least healthy width {width}; SIGKILL replica 0: "
            f"respawned as pid {new0['pid']} on the boot weights (generation 0), re-synced "
            f"onto {os.path.basename(w[1])} (generation 1) before it rejoined, "
            f"{rejoin0:.2f} s after the kill")
        time.sleep(1.0)  # traffic on the re-synced tier
        secs["rollback"] = time.perf_counter() - t0 - sum(secs.values())
        page = get("/dash").decode()
        if "Serving tier" not in page:
            raise AssertionError("/dash has no serving-tier section")
        metrics = get("/metrics").decode()
    finally:
        try:
            if traffic is not None:
                answers, failed = traffic.finish()
        finally:
            sys.stdout = lines.out
            router.stop()
            _reap(pids)
            cli_thread.join(ROUTER_WAIT)
    epochs.append((t_epoch, time.time() + 1, {key}))
    if failed:
        raise AssertionError(f"{len(failed)} failed requests: {failed[:3]}")
    held, (ok8, n8) = _router_answers(answers, epochs, cpu, w)
    # the A/B: the realized split against Bresenham's, the fallbacks while
    # a replica was down included
    n = router.metrics.snapshot()["requests"]
    got = {v: REGISTRY.counter("router_quant_answers", variant=v).snapshot() - quant0[v]
           for v in ("f32", "int8")}
    in_down = sum(1 for a in answers if any(a[6] <= b and a[7] >= t for t, b in down))
    want8 = int(n * 0.5)
    if got["f32"] + got["int8"] != n or abs(got["int8"] - want8) > 1 + in_down:
        raise AssertionError(f"A/B: {got} of {n} requests, Bresenham int8 {want8}, "
                             f"{in_down} answers while a replica was down")
    launches = [l for l in metrics.splitlines() if "lrn" in l and not l.startswith("#")]
    secs["check"] = time.perf_counter() - t0 - sum(secs.values())
    total = time.perf_counter() - t0
    log(f"  {len(answers)} answers from {TIER_CLIENTS} closed-loop clients (own timeout "
        f"{ROUTER_CLIENT_TIMEOUT:.0f} s, no client retry), 0 failed; f32 {held['f32']} each "
        f"= the CPU engine's on weights its replica could have served, int8 {held['int8']}: "
        f"top-5 sets hold on {ok8}/{n8}; A/B {got} of {n} requests (Bresenham int8 "
        f"{want8}, {in_down} answers while a replica was down); replicas' LRN launches in "
        f"/metrics: {launches or 'not exported'}; all replica processes gone")
    log(f"  router-tier phase {total:.1f} s of a {ROUTER_BUDGET_S:.0f} s budget ("
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()) + ")")
    return {"seconds": total, "answers": len(answers)}


# ------------------------------------------------------------- training
def _alexnet_train_val(dropout: bool = True) -> str:
    """The port's train_val prototxt text, with ``dropout_ratio: 0``
    when ``dropout`` is off."""
    from sparknet_tpu_torch.models import ALEXNET_TRAIN_VAL

    text = open(ALEXNET_TRAIN_VAL).read()
    return text if dropout else text.replace("dropout_ratio: 0.5", "dropout_ratio: 0")


def _branch_flips(net, got, want):
    """{layer: count} of the ReLU units and max-pool windows where two runs
    of ``net`` took another branch, from their blobs (NHWC tensors by
    name, on the CPU): a ReLU's top is its own bottom in the zoo nets, so
    its sign tells the branch; a MAX pool's argmax is taken over its
    bottom padded as ``layers.Pooling.apply`` pads it."""
    import torch.nn.functional as F

    from sparknet_tpu_torch.nets import layers as L

    out = {}
    for lp in net.layers:
        if lp.type == "ReLU":
            k = lp.top[0]
            out[lp.name] = int(((got[k] > 0) != (want[k] > 0)).sum())
        elif lp.type == "Pooling" and str(lp.pooling_param.get("pool", "MAX")) == "MAX":
            k, stride, pads, _ = L.Pooling.window(lp, want[lp.bottom[0]].shape)
            idx = [F.max_pool2d(F.pad(blobs[lp.bottom[0]].permute(0, 3, 1, 2), pads,
                                      value=float("-inf")), k, stride,
                                return_indices=True)[1] for blobs in (got, want)]
            out[lp.name] = int((idx[0] != idx[1]).sum())
    return {k: v for k, v in out.items() if v}


def phase_grads():
    """One training step at batch 8: the card's loss and gradients against
    the CPU's, same weights and batch, no Dropout.

    Max pooling and ReLU are piecewise: where two inputs of a pooling
    window are within f32 rounding of each other, or a pre-activation is
    within rounding of 0, the CPU and the card may take different
    branches and send a gradient to other pixels, which moves the weight
    gradients below by ~1e-3 and says nothing about the port. So the
    batch is drawn from seeds 0, 1, ... until the CPU and the card (cuDNN
    off) take the same argmax in every pooling window and the same sign
    at every ReLU; that batch's gradients are held to the tolerance. cuDNN
    stays off: its weight-gradient algorithms accumulate with atomics in
    a run-dependent order."""
    import numpy as np
    import torch

    from sparknet_tpu_torch.nets.torchnet import TorchNet
    from sparknet_tpu_torch.ops.lrn import lrn_rows_bwd, lrn_rows_train
    from sparknet_tpu_torch.proto import caffe_pb

    net_param = caffe_pb.load_net(_alexnet_train_val(dropout=False), is_path=False)
    n = 8
    shapes = {"data": (n, 227, 227, 3), "label": (n,)}
    net = TorchNet(net_param, "TRAIN", shapes, device="cpu")

    def step(dev, batch):
        """(loss, grads, blobs) of one step on ``dev``, on the CPU."""
        net = TorchNet(net_param, "TRAIN", shapes, device=dev)
        params, state = net.init(torch.Generator().manual_seed(0))
        leaves = {l: {k: t.detach().requires_grad_(True) for k, t in e.items()}
                  for l, e in params.items()}
        gen = torch.Generator(device=dev).manual_seed(0)
        blobs, _ = net.apply(leaves, state, {k: v.to(dev) for k, v in batch.items()},
                             train=True, generator=gen)
        loss, _ = net.loss_and_metrics(blobs)
        flat = [(l, k, t) for l, e in leaves.items() for k, t in e.items()]
        grads = torch.autograd.grad(loss, [t for _, _, t in flat])
        return (float(loss.detach()),
                {(l, k): g.cpu() for (l, k, _), g in zip(flat, grads)},
                {k: v.detach().cpu() for k, v in blobs.items()})

    def compare(tag, got, want):
        rel_loss = abs(got[0] - want[0]) / abs(want[0])
        errs = {key: float(torch.linalg.vector_norm(got[1][key] - w) /
                           torch.linalg.vector_norm(w).clamp(min=1e-30))
                for key, w in want[1].items()}
        log(f"  {tag}: loss {got[0]:.7f} vs {want[0]:.7f} (relative error "
            f"{rel_loss:.2e}); gradient relative L2 errors: " + ", ".join(
                f"{l}.{k} {e:.1e}" for (l, k), e in errs.items()))
        return rel_loss, errs

    before = (lrn_rows_train.launches, lrn_rows_bwd.launches)
    card_steps = 0
    for seed in range(30):
        rng = np.random.default_rng(seed)
        batch = {"data": torch.from_numpy(rng.normal(0, 50, shapes["data"]).astype(np.float32)),
                 "label": torch.from_numpy(rng.integers(0, 1000, n).astype(np.int32))}
        cpu = step("cpu", batch)
        with torch.backends.cudnn.flags(enabled=False):
            card_gemm = step("cuda", batch)
        card_steps += 1
        differ = _branch_flips(net, card_gemm[2], cpu[2])
        log(f"  batch seed {seed}: max-pool windows and ReLU units on another branch, "
            f"card (cuDNN off) vs CPU: {differ or 'none'}")
        if not differ:
            break
    else:
        raise AssertionError("no batch of seeds 0-29 takes the CPU's branches on the card")
    launched = (lrn_rows_train.launches - before[0], lrn_rows_bwd.launches - before[1])
    log(f"  training kernels launched by {card_steps} card steps: forward {launched[0]}, "
        f"backward {launched[1]} (want 2 per step each)")
    if launched != (2 * card_steps, 2 * card_steps):
        raise AssertionError(f"training kernel launches {launched}")
    rel_loss, errs = compare(f"seed {seed}, card with cuDNN off (held)", card_gemm, cpu)
    worst = max(errs.values())
    bad = [f"{key}: {e:.2e}" for key, e in errs.items() if e > 1e-4]
    log(f"  held: loss relative error {rel_loss:.2e} [<= 1e-5]; worst gradient relative "
        f"L2 error {worst:.2e} over {len(errs)} tensors [<= 1e-4]")
    if rel_loss > 1e-5 or bad:
        raise AssertionError(f"card vs CPU step: loss rel {rel_loss:.2e}, gradients {bad}")
    return worst


def _solver_file(tmp: str) -> str:
    """A solver for the train phase: the zoo's base_lr 0.01 and schedule,
    a short run, snapshots under ``tmp``."""
    from sparknet_tpu_torch.models import ALEXNET_TRAIN_VAL

    path = os.path.join(tmp, "alexnet_smoke_solver.prototxt")
    with open(path, "w") as f:
        f.write(
            f'net: "{ALEXNET_TRAIN_VAL}"\n'
            "test_iter: 2\ntest_interval: 20\nbase_lr: 0.01\n"
            'lr_policy: "step"\ngamma: 0.1\nstepsize: 100000\ndisplay: 5\n'
            f"max_iter: {TRAIN_ITERS}\nmomentum: 0.9\nweight_decay: 0.0005\n"
            f'snapshot: {TRAIN_ITERS}\nsnapshot_prefix: "{os.path.join(tmp, "alexnet")}"\n'
        )
    return path


def phase_train(tmp):
    """ImageNetApp on the card, counted kernel by kernel."""
    import contextlib
    import io
    import math
    import re

    from sparknet_tpu_torch.apps import imagenet_app
    from sparknet_tpu_torch.ops.lrn import lrn_rows, lrn_rows_bwd, lrn_rows_train
    from sparknet_tpu_torch.solver import snapshot

    argv = ["--arch", "alexnet", "--synthetic", "--synthetic-n", "512", "--solver",
            _solver_file(tmp), "--device", "cuda"]
    log(f"  imagenet_app.main({argv})")
    buf = io.StringIO()
    lrn_rows.launches = lrn_rows_train.launches = lrn_rows_bwd.launches = 0
    with contextlib.redirect_stdout(buf):
        last_test = imagenet_app.main(argv)
    counts = (lrn_rows.launches, lrn_rows_train.launches, lrn_rows_bwd.launches)
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"  | {line}")
    losses = [float(v) for v in re.findall(r"Iteration \d+, loss = (\S+)", out)]
    if len(losses) != TRAIN_ITERS // 5 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"display losses {losses}")
    tests = 2  # before the loop and at iteration 20
    want = (2 * 2 * tests, 2 * TRAIN_ITERS, 2 * TRAIN_ITERS)
    log(f"  LRN launches on the train path: inference {counts[0]} (want {want[0]}: 2 "
        f"per test batch), training forward {counts[1]}, backward {counts[2]} (want "
        f"{want[1]} each: 2 per iteration)")
    if counts != want:
        raise AssertionError(f"LRN launches {counts}, want {want}")
    st = snapshot.load_state(os.path.join(tmp, f"alexnet_iter_{TRAIN_ITERS}.solverstate.npz"))
    if st["it"] != TRAIN_ITERS:
        raise AssertionError(f"solverstate iter {st['it']}")
    log(f"  solverstate reloaded at iter {st['it']}; last test {last_test}")
    return {"launches": counts, "losses": losses}


def _alexnet_resident(tmp, bf16=False):
    """ImageNetApp's AlexNet solver at batch 256 (the train phase's
    solver file under ``tmp``; ``--bf16`` or f32) and a feed that repeats
    one device-resident batch."""
    import itertools

    from sparknet_tpu_torch.apps import imagenet_app

    args = imagenet_app.make_args(synthetic=True, synthetic_n=512,
                                  solver=_solver_file(tmp), device="cuda", bf16=bf16)
    solver, train_feed, _ = imagenet_app.build(args)
    return solver, itertools.repeat(solver._put_batch(next(train_feed)))


def phase_train_profile(tmp):
    """Solver.step on one device-resident batch of 256, f32 then bf16,
    each eager and through the graph."""
    import torch

    out = {}
    for bf16 in (False, True):
        solver, feed = _alexnet_resident(tmp, bf16)
        dt = "bf16" if bf16 else "f32"
        out[dt] = _profile_steps(solver, feed, f"batch {TRAIN_BATCH}, {dt}, resident batch",
                                 TRAIN_BATCH, "images",
                                 (LRN_TAGS["lrn_fwd_train"], LRN_TAGS["lrn_bwd"]))
        del solver, feed
        torch.cuda.empty_cache()
    return out["f32"]


# ---------------------------------------------- the other zoo nets
def _zoo_train_val(arch):
    from sparknet_tpu_torch import models

    return {"googlenet": models.GOOGLENET_TRAIN_VAL, "resnet50": models.RESNET50_TRAIN_VAL,
            "vgg16": models.VGG16_TRAIN_VAL}[arch]


def _zoo_weights(net):
    """The port's filler weights from seed 0, with the last Scale of each
    ResNet-50 residual branch at 0.2 of its filler's 1 (the zero-gamma
    init of Goyal et al. 2017): at 1, a random BatchNorm net amplifies a
    rounding difference ~1.2x a layer, which no tolerance between two
    devices survives (tests/test_torch_zoo_nets.py)."""
    import torch

    params, state = net.init(torch.Generator().manual_seed(0))
    for layer, entry in params.items():
        if layer.startswith("scale_") and layer.endswith("_branch2c"):
            entry["weight"].mul_(0.2)
    return params, state


def _rel(got, want):
    import torch

    got, want = got.detach().double().cpu(), want.detach().double()
    return float(torch.linalg.vector_norm(got - want) /
                 torch.linalg.vector_norm(want).clamp(min=1e-30))


def phase_zoo_grads(arch):
    """One training step of full-width ``arch`` at batch 8, card against
    CPU: the same weights (``_zoo_weights``), batch and initial state, no
    Dropout, cuDNN on (the path the app trains on). Every blob, the
    loss, the new BatchNorm state and every gradient, by relative L2.

    Unlike AlexNet's phase_grads, no batch is sought on which both
    devices take the same branches: with 57-61 ReLU layers at full width,
    some unit lies within rounding of 0 on every batch, so some gradients
    move by a flipped unit's share; the ReLU units and max-pool windows
    on another branch are counted and printed. A flip leaves the forward
    values as they were, so blobs, loss and state are held at AlexNet's
    limits (relative L2 1e-4, loss 1e-5); gradients at ZOO_GRAD_TOL."""
    import numpy as np
    import torch

    from sparknet_tpu_torch.nets.torchnet import TorchNet
    from sparknet_tpu_torch.ops.lrn import lrn_rows_bwd, lrn_rows_train
    from sparknet_tpu_torch.proto import caffe_pb

    text = open(_zoo_train_val(arch)).read()
    net_param = caffe_pb.load_net(re.sub(r"dropout_ratio: [\d.]+", "dropout_ratio: 0", text),
                                  is_path=False)
    n = ZOO_GRADS_BATCH
    shapes = {"data": (n, 224, 224, 3), "label": (n,)}
    params, state = _zoo_weights(TorchNet(net_param, "TRAIN", shapes, device="cpu"))
    rng = np.random.default_rng(0)
    batch = {"data": torch.from_numpy(rng.normal(0, 50, shapes["data"]).astype(np.float32)),
             "label": torch.from_numpy(rng.integers(0, 1000, n).astype(np.int32))}

    def step(dev):
        net = TorchNet(net_param, "TRAIN", shapes, device=dev)
        leaves = {l: {k: t.to(dev).requires_grad_(True) for k, t in e.items()}
                  for l, e in params.items()}
        st = {l: {k: t.to(dev) for k, t in e.items()} for l, e in state.items()}
        blobs, new_state = net.apply(leaves, st, {k: v.to(dev) for k, v in batch.items()},
                                     train=True)
        loss, _ = net.loss_and_metrics(blobs)
        flat = [(l, k, t) for l, e in leaves.items() for k, t in e.items()]
        grads = torch.autograd.grad(loss, [t for *_, t in flat])
        return (net, float(loss.detach()), {k: v.detach().cpu() for k, v in blobs.items()},
                {l: {k: t.cpu() for k, t in e.items()} for l, e in new_state.items()},
                {(l, k): g.cpu() for (l, k, _), g in zip(flat, grads)})

    t0 = time.perf_counter()
    net, loss_cpu, blobs_cpu, state_cpu, grads_cpu = step("cpu")
    t1 = time.perf_counter()
    before = (lrn_rows_train.launches, lrn_rows_bwd.launches)
    _, loss_gpu, blobs_gpu, state_gpu, grads_gpu = step("cuda")
    torch.cuda.synchronize()
    launched = (lrn_rows_train.launches - before[0], lrn_rows_bwd.launches - before[1])
    log(f"  {arch} batch {n}: CPU step {t1 - t0:.1f} s; card step "
        f"{time.perf_counter() - t1:.1f} s (first call)")

    flipped = _branch_flips(net, blobs_gpu, blobs_cpu)
    checked = sum(lp.type in ("ReLU", "Pooling") for lp in net.layers)
    log(f"  ReLU units and max-pool windows on another branch, card vs CPU: "
        f"{sum(flipped.values())} in {len(flipped)} of {checked} ReLU and pooling layers "
        f"{dict(list(flipped.items())[:8])}{' ...' if len(flipped) > 8 else ''}")

    rel_loss = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    blob_errs = {k: _rel(blobs_gpu[k], v) for k, v in blobs_cpu.items() if v.dim()}
    state_errs = {(l, k): _rel(state_gpu[l][k], t) for l, e in state_cpu.items()
                  for k, t in e.items()}
    grad_errs = {key: _rel(grads_gpu[key], g) for key, g in grads_cpu.items()}

    def worst(errs):
        key = max(errs, key=errs.get)
        return errs[key], key

    wb, wg = worst(blob_errs), worst(grad_errs)
    ws = worst(state_errs) if state_errs else (0.0, None)
    grad_sorted = sorted(grad_errs.values())
    log(f"  loss {loss_gpu:.7f} card vs {loss_cpu:.7f} CPU: relative error {rel_loss:.2e} "
        f"[<= {ZOO_LOSS_TOL:g}]")
    log(f"  blobs: worst relative L2 {wb[0]:.2e} ({wb[1]}) over {len(blob_errs)} "
        f"[<= {ZOO_BLOB_TOL:g}]; BatchNorm state: worst {ws[0]:.2e} ({ws[1]}) over "
        f"{len(state_errs)} [<= {ZOO_BLOB_TOL:g}]")
    log(f"  gradients: relative L2 median {grad_sorted[len(grad_sorted) // 2]:.2e}, 90th "
        f"percentile {grad_sorted[int(0.9 * len(grad_sorted))]:.2e}, worst {wg[0]:.2e} "
        f"({wg[1][0]}.{wg[1][1]}) over {len(grad_errs)} tensors [<= {ZOO_GRAD_TOL:g}]")
    for (l, k), e in sorted(grad_errs.items(), key=lambda kv: -kv[1])[:6]:
        log(f"    {l}.{k} {e:.2e}")
    if arch == "googlenet":
        log(f"  training LRN kernels launched by the card step: forward {launched[0]}, "
            f"backward {launched[1]} (want 2 each)")
        if launched != (2, 2):
            raise AssertionError(f"training LRN launches {launched}")
    bad = [f"{k}: {e:.2e}" for k, e in blob_errs.items() if e > ZOO_BLOB_TOL]
    bad += [f"state {k}: {e:.2e}" for k, e in state_errs.items() if e > ZOO_BLOB_TOL]
    bad += [f"grad {k}: {e:.2e}" for k, e in grad_errs.items() if e > ZOO_GRAD_TOL]
    if rel_loss > ZOO_LOSS_TOL or bad:
        raise AssertionError(f"{arch} card vs CPU step: loss rel {rel_loss:.2e}; {bad[:20]}")
    return {"loss": rel_loss, "blob": wb[0], "state": ws[0], "grad": wg[0],
            "flips": sum(flipped.values())}


def _zoo_solver_file(tmp, arch):
    """``arch``'s zoo solver (its rate, policy, momentum and decay) cut to
    ZOO_ITERS iterations, test_iter 2 at the end (and before the loop
    unless the solver says ``test_initialization: false``), display 5, a
    snapshot at the end under ``tmp``; its net the port's train_val."""
    from sparknet_tpu_torch.apps.imagenet_app import ARCH_SOLVERS, ZOO

    text = open(os.path.join(ZOO, ARCH_SOLVERS[arch])).read()
    text = re.sub(r"(?m)^\s*test_iter:.*$", "", text)  # repeated: would accumulate
    path = os.path.join(tmp, f"{arch}_smoke_solver.prototxt")
    with open(path, "w") as f:
        # singular fields: the last one wins
        f.write(text + f'\nnet: "{_zoo_train_val(arch)}"\ntest_iter: 2\n'
                f"test_interval: {ZOO_ITERS}\ndisplay: 5\nmax_iter: {ZOO_ITERS}\n"
                f'snapshot: {ZOO_ITERS}\nsnapshot_prefix: "{os.path.join(tmp, arch)}"\n')
    return path


# the host's CUDA runtime calls that start work on the card, by kind
HOST_LAUNCH_APIS = {
    "kernels": ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx"),
    "graph replays": ("cudaGraphLaunch",),
    "copies": ("cudaMemcpyAsync", "cudaMemcpy"),
    "fills": ("cudaMemsetAsync",),
}


def _profile_steps(solver, feed, label, items, unit, tags=()):
    """The resident step both ways, eager (``_fuse_host`` off: the step
    function without a graph, ``SPARKNET_FUSED_STEP=0``) then the
    captured graph (the default), each by :func:`_profile_way`; the
    graph's numbers, with the eager ones under ``"eager"``."""
    import torch

    ways = {}
    slack0 = _slack_gib(torch)
    for fused in (False, True):
        solver._fuse_host = fused
        ways[fused] = _profile_way(solver, feed, f"{label}, {'graph' if fused else 'eager'}",
                                   items, unit, tags, slack0)
    out = dict(ways[True])
    out["eager"] = ways[False]
    log(f"  {label}: graph {out['ms']:.3f} ms a step against eager {ways[False]['ms']:.3f} "
        f"({ways[False]['ms'] / out['ms']:.2f}x)")
    return out


# each launch counter's kernels, by a part of the names torch.profiler
# gives them: (the wrappers, the part); the inference and the training
# LRN forward are one kernel template
TRACE_KERNELS = ((("lrn_rows", "lrn_rows_train"), "lrn_fwd_rows"),
                 (("lrn_rows_bwd",), "lrn_bwd_rows"),
                 (("flash_fwd",), "flash_fwd_"),
                 (("flash_bwd_dq",), "flash_bwd_dq_"),
                 (("flash_bwd_dkv",), "flash_bwd_dkv_"))


def _counts():
    """Every launch counter now, by wrapper name."""
    from sparknet_tpu_torch.ops import launch_counters

    return {fn.__name__: fn.launches for fn in launch_counters()}


def _slack_gib(torch):
    """GiB reserved by the allocator and not allocated once the cache is
    emptied: what a graph's private pool holds for its intermediates (the
    allocator counts them in no allocation), plus what earlier phases
    left there."""
    gc.collect()
    torch.cuda.empty_cache()
    return (torch.cuda.memory_reserved() - torch.cuda.memory_allocated()) / 2**30


def _profile_way(solver, feed, label, items, unit, tags=(), slack0=0.0):
    """Solver.step on a device-resident batch of ``items`` ``unit`` (images
    or tokens): ms per step by CUDA events (10 steps after 3 to warm:
    library algorithm choice, allocator, and for the graph its warm-up and
    capture), peak device memory allocated over those steps and the pool
    memory beyond it (:func:`_slack_gib` over ``slack0``, its value before
    the solver's first profiled step: the graph's private pool), then 3
    steps under ``torch.profiler``: the card's busy
    time against the wall time (its idle share), the device operations a
    step, the host's launches a step by kind (HOST_LAUNCH_APIS), the
    device time of the kernels whose names hold ``tags``, and the LRN and
    flash kernels it saw held to the launch counters' increase, replay by
    replay through the graph, after one traced step it drops
    (:func:`_traced_per_replay`)."""
    import torch

    solver.step(feed, 3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, wall_ms = _step_ms(solver, feed, 10)
    peak = torch.cuda.max_memory_allocated() / 2**30
    pool = _slack_gib(torch) - slack0
    steps = 3
    run = _traced_per_replay(label, lambda: solver.step(feed, 1), steps,
                             graph=solver._fuse_host)
    metrics, events, traced = run["out"], run["events"], run["kernels"]
    wall = run["wall_us"]
    # the card's work: not its user-annotation spans (each traced step's
    # ProfilerStep among them), which cover that work again
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not _annotation(e)]
    host = {what: sum(e.count for e in events if e.key in names) // steps
            for what, names in HOST_LAUNCH_APIS.items()}

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    busy = sum(dev_us(e) for e in kernels) / steps
    # idle: against the profiled window's wall time (the profiler slows the
    # host, so an eager step reads idler than it runs); idle_step: against
    # the unprofiled step's CUDA-event time
    out = {"ms": ms, "rate": items / ms * 1e3, "peak_gib": peak, "pool_gib": pool,
           "idle": None if not busy else 1 - busy / wall,
           "idle_step": None if not busy else 1 - busy / (ms * 1e3),
           "busy_ms": busy / 1e3,
           "launches": sum(e.count for e in kernels) // steps, "host": host}
    log(f"  {label}: {ms:.3f} ms per step (CUDA events, 10 steps; host clock {wall_ms:.3f} "
        f"ms), {out['rate']:.1f} {unit}/s, peak device memory allocated {peak:.2f} GiB, "
        f"the graph pool beyond it {pool:.2f} GiB; host launches a step: "
        + ", ".join(f"{n} {what}" for what, n in host.items())
        + "; traced kernels a step = the launch counters': "
        + (", ".join(f"{n} {part}" for part, n in traced.items() if n) or "none")
        + ("" if run["margins_us"] is None else
           "; trace margins, µs: launch to first kernel >= {}, window start to the first "
           "record {}, the last record to the window's end {}".format(*run["margins_us"])))
    bad = [k for k, v in metrics.items() if not math.isfinite(float(v))]
    if bad:
        raise AssertionError(f"{label}: non-finite metrics {bad}")
    if not busy:
        log("  device time by kernel: not measured (the profiler saw no device events)")
        return out
    tagged = {t: sum(dev_us(e) for e in kernels if t in e.key) / steps for t in tags}
    log(f"  profiled: device busy {busy / 1e3:.3f} ms per step of {wall / 1e3:.3f} ms wall "
        f"(idle share {100 * out['idle']:.1f}%; of the unprofiled step's {ms:.3f} ms "
        f"{100 * out['idle_step']:.1f}%), {out['launches']} device operations a step"
        + "".join(f"; {t} {v / 1e3:.4f} ms = {100 * v / busy:.2f}%" for t, v in tagged.items()))
    for e in sorted(kernels, key=dev_us, reverse=True)[:15]:
        log(f"    {dev_us(e) / steps / 1e3:8.4f} ms  {e.count // steps:4d}x  {e.key[:90]}")
    ops = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
           and e.key.startswith("aten::")]
    log("  host: " + "; ".join(
        f"{e.key} {e.self_cpu_time_total / steps / 1e3:.3f} ms {e.count // steps}x"
        for e in sorted(ops, key=lambda e: e.self_cpu_time_total, reverse=True)[:6]))
    return out


def phase_zoo_train(arch, tmp):
    """ImageNetApp ``main`` on ``arch`` at its prototxt's batch on the card
    (ZOO_ITERS iterations, the app's default feed), the solverstate
    reloaded; then the resident step, f32 and ``--bf16``."""
    import contextlib
    import io
    import itertools

    import numpy as np
    import torch

    from sparknet_tpu_torch.apps import imagenet_app
    from sparknet_tpu_torch.ops.lrn import lrn_rows, lrn_rows_bwd, lrn_rows_train
    from sparknet_tpu_torch.proto import caffe_pb
    from sparknet_tpu_torch.solver import snapshot

    solver_file = _zoo_solver_file(tmp, arch)
    argv = ["--arch", arch, "--synthetic", "--synthetic-n", "512", "--solver", solver_file,
            "--device", "cuda"]
    log(f"  imagenet_app.main({argv})")
    buf = io.StringIO()
    lrn_rows.launches = lrn_rows_train.launches = lrn_rows_bwd.launches = 0
    with contextlib.redirect_stdout(buf):
        imagenet_app.main(argv)
    counts = (lrn_rows.launches, lrn_rows_train.launches, lrn_rows_bwd.launches)
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"  | {line}")
    # the display line reads a top named "loss", as the JAX app's does;
    # these nets name theirs loss1/loss ... or loss/loss, so it prints nan
    # (ROADMAP C): the loss heads are read from the test outputs
    tests = re.findall(r"Test net output: (\S+) = (\S+)", out)
    heads = 3 if arch == "googlenet" else 1
    sp = caffe_pb.load_solver(solver_file)
    passes = 1 + int(sp.test_initialization)
    losses = [float(v) for k, v in tests if k.endswith("/loss")]
    if len(losses) != heads * passes or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"test losses {losses}, want {heads * passes} finite")
    speed = re.findall(r"speed: steps/s=(\S+) images/s=(\S+)", out)
    log(f"  test loss heads {losses}; last speed: line {speed[-1][1]} images/s "
        f"({speed[-1][0]} steps/s)")
    want = ((2 * 2 * passes, 2 * ZOO_ITERS, 2 * ZOO_ITERS) if arch == "googlenet"
            else (0, 0, 0))
    log(f"  LRN launches: inference {counts[0]}, training forward {counts[1]}, backward "
        f"{counts[2]} (want {want}: 2 a test batch, 2 and 2 an iteration)")
    if counts != want:
        raise AssertionError(f"LRN launches {counts}, want {want}")
    st = snapshot.load_state(os.path.join(tmp, f"{arch}_iter_{ZOO_ITERS}.solverstate.npz"))
    bad = [f"{l}.{k}" for l, e in st["params"].items() for k, a in e.items()
           if not np.all(np.isfinite(a))]
    bad += [f"state {l}.{k}" for l, e in st["state"].items() for k, a in e.items()
            if not np.all(np.isfinite(a)) or (k == "var" and np.any(a < 0))]
    n_bn = 53 if arch == "resnet50" else 0
    if st["it"] != ZOO_ITERS or len(st["state"]) != n_bn or bad:
        raise AssertionError(f"solverstate: iter {st['it']}, {len(st['state'])} states "
                             f"(want {n_bn}), not finite or var < 0: {bad[:10]}")
    log(f"  solverstate reloaded at iter {st['it']}: params finite, {n_bn} BatchNorm states "
        f"finite with var >= 0")
    for name in os.listdir(tmp):
        if name.startswith(f"{arch}_iter_"):
            os.unlink(os.path.join(tmp, name))

    result = {"launches": counts, "app_images_s": float(speed[-1][1])}
    tags = (LRN_TAGS["lrn_fwd_train"], LRN_TAGS["lrn_bwd"]) if arch == "googlenet" else ()
    for bf16 in (False, True):
        torch.cuda.empty_cache()
        args = imagenet_app.make_args(arch=arch, synthetic=True, synthetic_n=512,
                                      solver=solver_file, device="cuda", bf16=bf16)
        solver, train_feed, _ = imagenet_app.build(args)
        feed = itertools.repeat(solver._put_batch(next(train_feed)))
        bs = solver.train_net.blob_shapes["data"][0]
        label = f"{arch} batch {bs}, {'bf16' if bf16 else 'f32'}, resident batch"
        result["bf16" if bf16 else "f32"] = _profile_steps(solver, feed, label, bs, "images",
                                                           tags)
        close = getattr(train_feed, "close", None)
        if close is not None:
            close()
        del solver, feed, train_feed
    return result


# ------------------------------------------------------- flash kernels
def _flash_inputs(case, dtype, gen):
    """Random q, k, v, dO of ``case`` on the card, its int8 kv mask (a
    quarter of row 0's keys and all of the last row's masked when
    ``padded``) and its offsets tensor."""
    import torch

    from sparknet_tpu_torch.ops import attention as TA

    _, b, h, sq, sk, d, causal, q_off, kv_off, padded, rate, *layout = case
    if layout == ["qkv"]:  # BERT's strided views, no copy (sq == sk)
        qkv = torch.randn((b, sq, 3, h, d), generator=gen, device="cuda").to(dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        do = torch.randn((b, h, sq, d), generator=gen, device="cuda").to(dtype)
    else:
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                       for shape in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d),
                                     (b, h, sq, d)))
    mask = torch.ones((b, sk), dtype=torch.int8, device="cuda")
    if padded:
        mask[0, sk - sk // 4:] = 0
        mask[-1] = 0  # a fully padded row
    seed = int(torch.randint(-2**31, 2**31, (1,), generator=gen, device="cuda"))
    return (q, k, v, do, mask, TA.make_offsets(q_off, kv_off, seed, "cuda"), causal,
            1.0 / d ** 0.5, rate)


def _flash_within(got, ref, dtype, tol):
    """(ok, max_abs_err): |kernel - plain| <= tol + tol |plain|, plus one
    bf16 ulp of the plain result for bf16 outputs (module docstring)."""
    import torch

    ref = ref.float()
    err = (got.float() - ref).abs()
    bound = tol + tol * ref.abs()
    if dtype == torch.bfloat16:
        bound = bound + _bf16_ulp(ref)
    return bool(torch.all(err <= bound)), float(err.max())


def _flash_all(inputs):
    """Each kernel and its plain version on the same inputs; the backward
    pair takes the plain forward's lse and delta. Returns {kernel name:
    [(output name, kernel out, plain out, tolerance)]}."""
    from sparknet_tpu_torch.ops import attention as TA

    q, k, v, do, mask, off, causal, scale, rate = inputs
    o, lse = TA.flash_fwd(q, k, v, mask, off, causal, scale, rate)
    ref_o, ref_lse = TA.flash_fwd_reference(q, k, v, mask, off, causal, scale, rate)
    delta = TA.flash_delta(do, ref_o)
    bwd = (q, k, v, mask, off, do, ref_lse, delta, causal, scale, rate)
    dq = TA.flash_bwd_dq(*bwd)
    dk, dv = TA.flash_bwd_dkv(*bwd)
    ref_dk, ref_dv = TA.flash_bwd_dkv_reference(*bwd)
    return {
        "flash_fwd": [("o", o, ref_o, 2e-5), ("lse", lse, ref_lse, 2e-5)],
        "flash_bwd_dq": [("dq", dq, TA.flash_bwd_dq_reference(*bwd), 1e-4)],
        "flash_bwd_dkv": [("dk", dk, ref_dk, 1e-4), ("dv", dv, ref_dv, 1e-4)],
    }


def phase_flash_kernels():
    """The three flash kernels against their plain versions over the
    cases, their dropout statistics, then timed at BERT-base's shapes."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {(n, dt): 0.0 for n in FLASH_NAMES for dt in ("float32", "bfloat16")}
    failures = []
    for case in FLASH_CASES:
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            outs = _flash_all(_flash_inputs(case, dtype, gen))
            torch.cuda.synchronize()
            line = []
            for name, checks in outs.items():
                for what, got, ref, tol in checks:
                    ok, err = _flash_within(got, ref, torch.float32 if what == "lse"
                                            else dtype, tol)
                    worst[(name, dt)] = max(worst[(name, dt)], err)
                    line.append(f"{what} {err:.1e}{'' if ok else ' MISMATCH'}")
                    if not ok:
                        failures.append(f"{name} {what} {case[0]} {dt}")
                    if case[9] and what != "lse" and float(got[-1].abs().max()) != 0.0:
                        failures.append(f"{name} {what} {case[0]} {dt}: padded row not 0")
            log(f"  flash {case[0]:<17} {dt:<8} b{case[1]} h{case[2]} ({case[3]}, "
                f"{case[4]}) d{case[5]} causal={case[6]} off=({case[7]}, {case[8]}) "
                f"rate={case[10]}: max_abs_err " + ", ".join(line))
    if failures:
        raise AssertionError(f"flash kernels disagree with their plain versions: {failures}")
    for n in FLASH_NAMES:
        log(f"  worst |kernel - plain| {n}: f32 {worst[(n, 'float32')]:.3e}, bf16 "
            f"{worst[(n, 'bfloat16')]:.3e} (each within its tolerance; padded rows "
            f"exactly 0)")
    _flash_dropout_statistics(gen)
    timing = _time_flash(gen)
    for n in FLASH_NAMES:
        timing[n]["max_abs_err"] = max(worst[(n, "float32")], timing[n]["err"])
    return timing


def _flash_dropout_statistics(gen):
    """Keep rate (v = 1: the mean output is the kept, rescaled mass, 1 in
    expectation) and the forward/backward mask identity (v = I, S = D:
    the forward's output is the dropped probability matrix, so dv must
    be it transposed times dO)."""
    import torch

    from sparknet_tpu_torch.ops import attention as TA

    q, k = (torch.randn((2, 4, 512, 64), generator=gen, device="cuda") for _ in range(2))
    mask = torch.ones((2, 512), dtype=torch.int8, device="cuda")
    for rate in (0.1, 0.5):
        off = TA.make_offsets(0, 0, 1000 + int(rate * 10), "cuda")
        o, _ = TA.flash_fwd(q, k, torch.ones_like(q), mask, off, False, 0.125, rate)
        mass = float(o.mean())
        kept = float(TA.dropout_keep(off[2], 2, 4, 512, 512, rate).float().mean())
        log(f"  dropout rate {rate}: mean output with v = 1 is {mass:.4f} [within 0.05 "
            f"of 1]; kept share {kept:.4f} of {2 * 4 * 512 * 512} [1 - rate]")
        if abs(mass - 1.0) >= 0.05 or abs(kept - (1 - rate)) >= 0.005:
            raise AssertionError(f"dropout keep rate at {rate}: mass {mass}, kept {kept}")
    s, rate = 128, 0.3
    q, k, g = (torch.randn((1, 2, s, s), generator=gen, device="cuda") for _ in range(3))
    eye = torch.eye(s, device="cuda").expand(1, 2, s, s).contiguous()
    mask = torch.ones((1, s), dtype=torch.int8, device="cuda")
    off = TA.make_offsets(0, 0, 77, "cuda")
    p_dropped, lse = TA.flash_fwd(q, k, eye, mask, off, False, s ** -0.5, rate)
    p_all, _ = TA.flash_fwd(q, k, eye, mask, off, False, s ** -0.5, 0.0)
    _, dv = TA.flash_bwd_dkv(q, k, eye, mask, off, g, lse, TA.flash_delta(g, p_dropped),
                             False, s ** -0.5, rate)
    err_mask = float((dv - p_dropped.transpose(-1, -2) @ g).abs().mean())
    err_all = float((dv - p_all.transpose(-1, -2) @ g).abs().mean())
    log(f"  dropout mask identity (v = I, S = D = {s}, rate {rate}; the tensor-core dk/dv "
        f"kernel): mean |dv - "
        f"p_dropped^T dO| {err_mask:.2e} [< 1e-5], against the keep-all p {err_all:.2e} "
        f"[> 100x]")
    if not (err_mask < 1e-5 and err_all > 100 * err_mask):
        raise AssertionError(f"forward and backward dropout masks differ: {err_mask}, {err_all}")


def _flash_bounds(b, s):
    """{kernel: (bytes, operations)} of one launch at BERT-base's heads,
    f32, no causal mask: each input read once, each output written once;
    2 operations per multiply-add of the products (exp and the rest
    uncounted)."""
    h, d = BERT_HEADS, BERT_HEAD_DIM
    elems = b * h * s * d  # one (B, H, S, D) f32 tensor
    rows = b * h * s       # one (B, H, S) f32 tensor
    pairs = b * h * s * s * d
    mask, offsets = b * s, 12
    return {
        "flash_fwd": (4 * (3 * elems + elems + rows) + mask + offsets, 4 * pairs),
        "flash_bwd_dq": (4 * (4 * elems + 2 * rows + elems) + mask + offsets, 6 * pairs),
        "flash_bwd_dkv": (4 * (4 * elems + 2 * rows + 2 * elems) + mask + offsets,
                          8 * pairs),
    }


def _device_ms(fn, tag=None, n=20):
    """Card time per call by ``torch.profiler``: the device time of the
    kernels whose name holds ``tag``, over the launches of them that the
    profiler recorded (a call launches one; the profiler has been seen to
    record fewer than it was given, which is logged), or of every kernel
    over ``n`` without a tag; None when the profiler saw no device events.
    Unlike CUDA events it leaves out the host's time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and not _annotation(e)
              and (tag is None or tag in e.key)]
    us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
             for e in events)
    if not us:
        return None
    calls = n
    if tag is not None:
        calls = sum(e.count for e in events)
        if calls != n:
            log(f"  (torch.profiler recorded {calls} of {n} launches of {tag}: averaged over "
                f"those)")
    return us / calls / 1e3


def _fmt_ms(x):
    return "not measured" if x is None else f"{x:.4f} ms"


def _tc_bound(nbytes, ops):
    """The larger of ``nbytes`` over 3.35 TB/s and ``ops`` over 495
    TFLOP/s dense TF32, and which of the two it is."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / TF32_FLOPS_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms), nbytes=nbytes, ops=ops,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def _fwd_bounds(b, s, dtype):
    """The forward's least times on the tensor cores at BERT-base's heads
    in ``dtype``: each the larger of its bytes over 3.35 TB/s (q, k, v read
    and o written at the dtype's size, lse in f32, the mask and offsets)
    and its operations over 495 TFLOP/s dense TF32. "design" counts 2 per
    multiply-add of each of the kernel's TF32 terms (FLASH_FWD_TERMS),
    "function" only the function's own two products, 4 B H S^2 D."""
    h, d = BERT_HEADS, BERT_HEAD_DIM
    es = 4 if dtype == "float32" else 2
    elems, rows, pairs = b * h * s * d, b * h * s, b * h * s * s * d
    nbytes = es * 4 * elems + 4 * rows + b * s + 12
    return {"design": _tc_bound(nbytes, 2 * sum(FLASH_FWD_TERMS[dtype]) * pairs),
            "function": _tc_bound(nbytes, 4 * pairs)}


def _bwd_bounds(b, s, dtype):
    """The backward kernels' least times on the tensor cores at
    BERT-base's heads in ``dtype``, as ``_fwd_bounds``: bytes are q, k, v
    and dO read and the gradients written at the dtype's size, lse and
    delta in f32, the mask and offsets. "function" counts the function's
    own products, dq 6 B H S^2 D (s, dp, ds k) and dk/dv 8 B H S^2 D (s,
    dp, p^T dO, ds^T q); "design" their kernels' TF32 terms
    (FLASH_DQ_TERMS, FLASH_DKV_TERMS)."""
    h, d = BERT_HEADS, BERT_HEAD_DIM
    es = 4 if dtype == "float32" else 2
    elems, rows, pairs = b * h * s * d, b * h * s, b * h * s * s * d
    read = es * 4 * elems + 4 * 2 * rows + b * s + 12
    return {
        "flash_bwd_dq": {
            "design": _tc_bound(read + es * elems, 2 * sum(FLASH_DQ_TERMS[dtype]) * pairs),
            "function": _tc_bound(read + es * elems, 6 * pairs)},
        "flash_bwd_dkv": {
            "design": _tc_bound(read + 2 * es * elems, 2 * sum(FLASH_DKV_TERMS[dtype]) * pairs),
            "function": _tc_bound(read + 2 * es * elems, 8 * pairs)},
    }


def _more_times(kernel, library, tag):
    """A kernel and its SDPA yardstick timed back to back
    (``_time_loop_ms``) and by the profiler's device time (the kernels
    whose name holds ``tag``; every kernel of SDPA's call), beside their
    single calls."""
    return dict(loop_ms=_time_loop_ms(kernel), device_ms=_device_ms(kernel, tag),
                library_loop_ms=_time_loop_ms(library), library_device_ms=_device_ms(library))


def _log_tc(name, label, r, bounds):
    """A kernel's three times beside SDPA's, and each tensor-core bound's
    share of the kernel's device time (of its back-to-back time where the
    profiler saw nothing)."""
    card = r["device_ms"] or r["loop_ms"]
    shares = "; ".join(
        f"{kind} bound {x['bound_ms']:.4f} ms ({x['bound_by']}: {x['nbytes'] / 1e6:.1f} MB, "
        f"{x['ops'] / 1e9:.2f} GFLOP TF32) = {100 * x['bound_ms'] / card:.1f}% of it"
        for kind, x in bounds.items())
    log(f"  time {name} {label}: single calls {r['ms']:.4f} ms (SDPA "
        f"{r['library_ms']:.4f}), back to back {r['loop_ms']:.4f} ms (SDPA "
        f"{r['library_loop_ms']:.4f}), device time (torch.profiler) "
        f"{_fmt_ms(r['device_ms'])} (SDPA {_fmt_ms(r['library_device_ms'])}); {shares}")


def _flash_calls(inputs):
    """{kernel name: (kernel call, plain call, SDPA call)} on ``inputs``,
    the backward pair given the kernel forward's lse and delta; SDPA's
    autograd backward is asked for dq alone, or for dk and dv."""
    import functools

    import torch
    import torch.nn.functional as F

    from sparknet_tpu_torch.ops import attention as TA

    q, k, v, do, mask, off, causal, scale, rate = inputs
    o, lse = TA.flash_fwd(q, k, v, mask, off, causal, scale, rate)
    bwd = (q, k, v, mask, off, do, lse, TA.flash_delta(do, o), causal, scale, rate)
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    lib_q = F.scaled_dot_product_attention(qg, k, v, dropout_p=rate)
    lib_kv = F.scaled_dot_product_attention(q, kg, vg, dropout_p=rate)
    part = functools.partial
    return {
        "flash_fwd": (part(TA.flash_fwd, *inputs[:3], *inputs[4:]),
                      part(TA.flash_fwd_reference, *inputs[:3], *inputs[4:]),
                      part(F.scaled_dot_product_attention, q, k, v, dropout_p=rate)),
        "flash_bwd_dq": (part(TA.flash_bwd_dq, *bwd), part(TA.flash_bwd_dq_reference, *bwd),
                         part(torch.autograd.grad, lib_q, qg, do, retain_graph=True)),
        "flash_bwd_dkv": (part(TA.flash_bwd_dkv, *bwd), part(TA.flash_bwd_dkv_reference, *bwd),
                          part(torch.autograd.grad, lib_kv, (kg, vg), do, retain_graph=True)),
    }


def _time_flash_bf16(b, s, gen):
    """The three kernels in bf16 at (b, s): held against their plain
    versions (one bf16 ulp beyond the f32 tolerances; lse f32), then timed
    beside their tensor-core bounds (half the bytes; the forward 1 + 2
    terms, dq 1 + 1 + 2, dk/dv 1 + 1 + 2 + 2), the plain versions and SDPA
    in bf16."""
    import torch

    case = (f"BERT-base B={b} S={s} bf16", b, BERT_HEADS, s, s, BERT_HEAD_DIM, False, 0, 0,
            False, FLASH_DROPOUT)
    inputs = _flash_inputs(case, torch.bfloat16, gen)
    for name, checks in _flash_all(inputs).items():
        for what, got, ref, tol in checks:
            ok, err = _flash_within(got, ref, torch.float32 if what == "lse" else torch.bfloat16,
                                    tol)
            log(f"  check {name} B={b} S={s} bf16 {what}: max_abs_err {err:.2e}"
                f"{'' if ok else ' MISMATCH'}")
            if not ok:
                raise AssertionError(f"{name} bf16 {what} disagrees with its plain version")
    bounds = {"flash_fwd": _fwd_bounds(b, s, "bfloat16"), **_bwd_bounds(b, s, "bfloat16")}
    for name, (kernel, plain, library) in _flash_calls(inputs).items():
        r = dict(ms=_time_ms(kernel), library_ms=_time_ms(library),
                 **_more_times(kernel, library, FLASH_TAGS[name]))
        _log_tc(name, f"B={b} S={s} bf16 (plain {_time_ms(plain, reps=10):.4f} ms)", r,
                bounds[name])


def _time_flash(gen):
    """Each kernel at BERT-base's heads, f32, attention dropout 0.1, held
    against its plain version on the same inputs, then timed with CUDA
    events beside its bound, the plain version and one call of
    F.scaled_dot_product_attention (forward; for dq its autograd backward
    asked for dq alone, for dk/dv asked for dk and dv); and back to back
    and by the profiler, beside its tensor-core bounds (the f32 CUDA-core
    one kept in its first line). Each kernel's bound is then the
    tensor-core one of its function. All three in bf16 at B 32 x S 128
    too."""
    import torch

    out = {}
    for b, s in FLASH_TIMED:
        case = (f"BERT-base B={b} S={s}", b, BERT_HEADS, s, s, BERT_HEAD_DIM, False, 0, 0,
                False, FLASH_DROPOUT)
        inputs = _flash_inputs(case, torch.float32, gen)
        errs = {}
        for name, checks in _flash_all(inputs).items():
            errs[name] = _held(f"{name} B={b} S={s}", [(w, g, r) for w, g, r, _ in checks
                                                      if w != "lse"], tol=checks[0][3])
        bounds = _flash_bounds(b, s)
        tc = {"flash_fwd": _fwd_bounds(b, s, "float32"), **_bwd_bounds(b, s, "float32")}
        for name, (kernel, plain, library) in _flash_calls(inputs).items():
            nbytes, ops = bounds[name]
            r = dict(err=errs[name], ms=_time_ms(kernel), plain_ms=_time_ms(plain, reps=10),
                     library_ms=_time_ms(library))
            r.update(_bound(nbytes, ops))
            r["bound_by"] = "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations"
            log(f"  time {name} B={b} H={BERT_HEADS} S={s} D={BERT_HEAD_DIM} f32 rate "
                f"{FLASH_DROPOUT}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, SDPA "
                f"{r['library_ms']:.4f} ms, f32 CUDA-core bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP), "
                f"{ops / (r['ms'] * 1e-3) / 1e12:.2f} TFLOP/s = "
                f"{100 * r['bound_ms'] / r['ms']:.1f}% of it")
            r.update(_more_times(kernel, library, FLASH_TAGS[name]))
            _log_tc(name, f"B={b} S={s} f32", r, tc[name])
            r.update(bound_ms=tc[name]["function"]["bound_ms"],  # on the tensor cores
                     bound_by=tc[name]["function"]["bound_by"])
            if (b, s) == (BERT_BATCH, BERT_SEQ):
                out[name] = r  # the shape of the main path's launches
        if (b, s) == (BERT_BATCH, BERT_SEQ):
            _time_flash_bf16(b, s, gen)
    return out


def phase_bert_grads():
    """One BERT-base training step at full width, batch 2, seq 128, on
    the card and on the CPU: same weights (seed 0), same batch, the same
    attention-dropout seeds (drawn from one CPU generator for both), no
    hidden dropout (the devices' generators differ)."""
    import dataclasses

    import torch

    from sparknet_tpu_torch.data.text import mlm_dataset, mlm_feed
    from sparknet_tpu_torch.models.bert import BertConfig, BertMLM
    from sparknet_tpu_torch.ops import attention as TA

    b, s = 2, BERT_SEQ
    cfg = dataclasses.replace(BertConfig.bert_base(), hidden_dropout=0.0)
    max_preds = int(s * 0.15) + 1
    shapes = {"input_ids": (b, s), "mlm_positions": (b, max_preds)}
    ds, vocab = mlm_dataset(vocab_size=cfg.vocab_size, n_tokens=4096, seq_len=s, seed=0)
    batch = next(mlm_feed(ds, b, vocab, max_preds, seed=0))
    batch["attention_mask"][1, 100:] = 0  # padded keys in one row

    def step(dev):
        model = BertMLM(cfg, shapes, device=dev)
        params, _ = model.init(torch.Generator().manual_seed(0))
        leaves = {l: {n: t.requires_grad_(True) for n, t in e.items()}
                  for l, e in params.items()}
        blobs, _ = model.apply(leaves, {}, {k: torch.from_numpy(v).to(dev)
                                            for k, v in batch.items()},
                               train=True, generator=torch.Generator().manual_seed(1))
        flat = [(l, n, t) for l, e in leaves.items() for n, t in e.items()]
        grads = torch.autograd.grad(blobs["loss"], [t for _, _, t in flat])
        return (float(blobs["loss"].detach()),
                {(l, n): g.cpu() for (l, n, _), g in zip(flat, grads)})

    t0 = time.perf_counter()
    cpu = step("cpu")
    log(f"  CPU step: {time.perf_counter() - t0:.1f} s")
    for fn in (TA.flash_fwd, TA.flash_bwd_dq, TA.flash_bwd_dkv):
        fn.launches = 0
    card = step("cuda")
    launched = tuple(fn.launches for fn in (TA.flash_fwd, TA.flash_bwd_dq, TA.flash_bwd_dkv))
    log(f"  flash launches of the card step: forward, dq, dk/dv {launched} (want "
        f"{BERT_LAYERS} each)")
    if launched != (BERT_LAYERS,) * 3:
        raise AssertionError(f"flash launches {launched}")
    rel_loss = abs(card[0] - cpu[0]) / abs(cpu[0])
    norm = torch.linalg.vector_norm
    # a key bias shifts a query's logits by one constant, which the
    # softmax cancels: its gradient is 0 but for rounding on either device
    zero = {key for key in cpu[1] if key[1] == "k_b"}
    errs = {key: float(norm(card[1][key] - w) / norm(w).clamp(min=1e-30))
            for key, w in cpu[1].items() if key not in zero}
    noise = {key: max(float(norm(run[1][key]) / norm(run[1][(key[0], "v_b")]))
                      for run in (card, cpu)) for key in zero}
    worst = sorted(errs.items(), key=lambda kv: kv[1], reverse=True)
    log(f"  loss card {card[0]:.7f} vs CPU {cpu[0]:.7f} (relative error {rel_loss:.2e} "
        f"[<= 1e-5]); gradient relative L2 errors over {len(errs)} tensors, worst: " +
        ", ".join(f"{l}.{n} {e:.2e}" for (l, n), e in worst[:6]) + " [<= 1e-4]; "
        f"embeddings.word {errs[('embeddings', 'word')]:.2e}; the {len(zero)} k_b "
        f"gradients at most {max(noise.values()):.2e} of their layer's v_b [<= 1e-4]")
    bad = [f"{l}.{n}: {e:.2e}" for (l, n), e in worst if e > 1e-4]
    bad += [f"{l}.{n} not ~0: {e:.2e}" for (l, n), e in noise.items() if e > 1e-4]
    if rel_loss > 1e-5 or bad:
        raise AssertionError(f"card vs CPU BERT step: loss rel {rel_loss:.2e}, {bad}")
    return worst[0][1]


def _bert_argv(prefix, iters, *extra):
    return ["--config", "base", "--seq-len", str(BERT_SEQ), "--batch-size",
            str(BERT_BATCH), "--max-iter", str(iters), "--display", "5",
            "--snapshot-prefix", prefix, "--device", "cuda", *extra]


def phase_bert_train(tmp):
    """BertApp on the card, f32 then bf16, counted kernel by kernel; the
    final solverstate reloaded and tested."""
    import contextlib
    import io
    import math
    import re

    from sparknet_tpu_torch.apps import bert_app
    from sparknet_tpu_torch.ops import attention as TA

    wrappers = (TA.flash_fwd, TA.flash_bwd_dq, TA.flash_bwd_dkv)
    prefix = os.path.join(tmp, "bert")
    total = [0, 0, 0]

    def run(iters, *extra):
        argv = _bert_argv(prefix, iters, *extra)
        log(f"  bert_app.main({argv})")
        buf = io.StringIO()
        for fn in wrappers:
            fn.launches = 0
        with contextlib.redirect_stdout(buf):
            metrics = bert_app.main(argv)
        counts = tuple(fn.launches for fn in wrappers)
        out = buf.getvalue()
        for line in out.splitlines():
            log(f"  | {line}")
        losses = [float(x) for x in re.findall(r"Iteration \d+, loss = (\S+),", out)]
        if len(losses) != iters // 5 or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"display losses {losses}")
        want = (BERT_LAYERS * iters,) * 3
        log(f"  flash launches: forward {counts[0]}, dq {counts[1]}, dk/dv {counts[2]} "
            f"(want {want[0]} each: {BERT_LAYERS} per iteration)")
        if counts != want:
            raise AssertionError(f"flash launches {counts}, want {want}")
        for i, n in enumerate(counts):
            total[i] += n
        return metrics

    run(BERT_ITERS, "--snapshot", str(BERT_ITERS))
    run(BERT_BF16_ITERS, "--bf16")
    args = bert_app.make_args(config="base", seq_len=BERT_SEQ, batch_size=BERT_BATCH,
                              max_iter=BERT_ITERS, device="cuda")
    solver, feed, _ = bert_app.build(args)
    solver.restore(f"{prefix}_iter_{BERT_ITERS}.solverstate.npz", feed)
    if solver.iter != BERT_ITERS:
        raise AssertionError(f"solverstate iter {solver.iter}")
    for fn in wrappers:
        fn.launches = 0
    metrics = solver.test(feed, test_iter=2)
    counts = tuple(fn.launches for fn in wrappers)
    log(f"  solverstate reloaded at iter {solver.iter}; Solver.test over 2 batches: "
        f"{metrics}; flash launches {counts} (want ({2 * BERT_LAYERS}, 0, 0))")
    if counts != (2 * BERT_LAYERS, 0, 0) or not all(math.isfinite(v) for v in
                                                   metrics.values()):
        raise AssertionError(f"test pass: launches {counts}, metrics {metrics}")
    for i, n in enumerate(counts):
        total[i] += n
    return dict(zip(FLASH_NAMES, total))


def _bert_resident(bf16=False):
    """BertApp's BERT-base solver at 32 x 128 (``--bf16`` or f32) and a
    feed that repeats one device-resident batch."""
    import itertools

    from sparknet_tpu_torch.apps import bert_app

    args = bert_app.make_args(config="base", seq_len=BERT_SEQ, batch_size=BERT_BATCH,
                              max_iter=1000, device="cuda", bf16=bf16)
    solver, feed, _ = bert_app.build(args)
    return solver, itertools.repeat(solver._put_batch(next(feed)))


def _step_ms(solver, feed, reps=10):
    """ms per ``Solver.step`` over ``reps`` steps: by CUDA events, and by
    the host clock."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    solver.step(feed, reps)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps, (time.perf_counter() - t0) * 1e3 / reps


def phase_bert_profile():
    """Solver.step of BERT-base on one device-resident batch of 32 x 128,
    f32 then bf16, each eager and through the graph."""
    import torch

    out = {}
    for bf16 in (False, True):
        solver, feed = _bert_resident(bf16)
        dt = "bf16" if bf16 else "f32"
        out[dt] = _profile_steps(solver, feed, f"BERT-base batch {BERT_BATCH} x {BERT_SEQ}, "
                                 f"{dt}, resident batch", BERT_BATCH * BERT_SEQ, "tokens",
                                 tuple(FLASH_TAGS.values()))
        del solver, feed
        torch.cuda.empty_cache()
    return out


PROFILE_WINDOW_RUNS = 10


def phase_profile_windows(tmp):
    """The profiler windows whose per-replay check failed in whole runs,
    and only those, PROFILE_WINDOW_RUNS times: GoogLeNet bf16's resident
    step, eager then through the graph (the googlenet phase's last
    :func:`_profile_steps`), and the bert-profile phase's four. A miss is
    printed with what the trace held (:func:`_trace_miss_report`) and
    counted; the phase fails after the last run if any window missed."""
    import itertools

    import torch

    from sparknet_tpu_torch.apps import imagenet_app

    solver_file = _zoo_solver_file(tmp, "googlenet")
    misses, windows = [], 0

    def googlenet():
        args = imagenet_app.make_args(arch="googlenet", synthetic=True, synthetic_n=512,
                                      solver=solver_file, device="cuda", bf16=True)
        solver, train_feed, _ = imagenet_app.build(args)
        batch = solver._put_batch(next(train_feed))
        getattr(train_feed, "close", lambda: None)()
        return solver, itertools.repeat(batch), 32, "images"

    def bert(bf16):
        return lambda: (*_bert_resident(bf16), BERT_BATCH * BERT_SEQ, "tokens")

    cases = (("googlenet batch 32, bf16", googlenet), ("BERT-base f32", bert(False)),
             ("BERT-base bf16", bert(True)))
    for run in range(PROFILE_WINDOW_RUNS):
        for name, make in cases:
            torch.cuda.empty_cache()
            solver, feed, items, unit = make()
            slack0 = _slack_gib(torch)
            for fused in (False, True):
                solver._fuse_host = fused
                label = f"run {run}: {name}, {'graph' if fused else 'eager'}"
                windows += 1
                try:
                    _profile_way(solver, feed, label, items, unit, (), slack0)
                except AssertionError as e:
                    log(f"  MISS {e}")
                    misses.append(label)
            del solver, feed
    log(f"  per-replay check: {len(misses)} missed of {windows} windows "
        f"({PROFILE_WINDOW_RUNS} runs): {misses}")
    if misses:
        raise AssertionError(f"{len(misses)} of {windows} profiler windows missed")
    return {"windows": windows, "misses": len(misses)}


# ------------------------------------------------------------- fused step
FUSED_ITERS = 8
FUSED_SAVE_AT = 4
FUSED_NETS = ("cifar10_quick", "alexnet", "resnet50", "bert-base")
FUSED_OUTER = 1e-2  # relative L2, the branch-flip bound (_held_round's)


def _host(batch):
    """A feed's batch as host numpy arrays."""
    import numpy as np
    import torch

    return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in batch.items()}


def _fused_alexnet_solver(tmp):
    """AlexNet's train_val at the zoo's rate, the rate halved every 4
    iterations (the counter matters within the 12)."""
    from sparknet_tpu_torch.models import ALEXNET_TRAIN_VAL

    path = os.path.join(tmp, "alexnet_fused_solver.prototxt")
    with open(path, "w") as f:
        f.write(f'net: "{ALEXNET_TRAIN_VAL}"\ntest_iter: 1\ntest_interval: 1000\n'
                'base_lr: 0.01\nlr_policy: "step"\ngamma: 0.5\nstepsize: 4\n'
                f"max_iter: {FUSED_ITERS}\nmomentum: 0.9\nweight_decay: 0.0005\n")
    return path


def _fused_case(name, tmp):
    """(solver, make, batches): a solver of ``name`` on the card built as
    its app builds it (seed 0), ``make()`` building another, and
    FUSED_ITERS host batches of its app's train feed."""
    from sparknet_tpu_torch.apps import bert_app, imagenet_app

    if name == "cifar10_quick":
        from sparknet_tpu_torch.models import CIFAR_QUICK_SOLVER, CIFAR_QUICK_TRAIN_TEST
        from sparknet_tpu_torch.proto import caffe_pb
        from sparknet_tpu_torch.solver.trainer import Solver

        def make():
            return Solver(caffe_pb.load_solver(CIFAR_QUICK_SOLVER),
                          {"data": (100, 32, 32, 3), "label": (100,)},
                          net_param=caffe_pb.load_net(CIFAR_QUICK_TRAIN_TEST), seed=0,
                          device="cuda")

        feed, solver = _cifar_feed(), make()
    else:
        if name == "bert-base":
            app = bert_app
            args = bert_app.make_args(config="base", seq_len=BERT_SEQ, batch_size=BERT_BATCH,
                                      max_iter=1000, device="cuda", prefetch=0)
        else:
            app = imagenet_app
            kw = (dict(solver=_fused_alexnet_solver(tmp), synthetic_n=TRAIN_BATCH,
                       device_augment=True) if name == "alexnet" else
                  dict(arch="resnet50", solver=_zoo_solver_file(tmp, "resnet50"),
                       synthetic_n=64))
            args = imagenet_app.make_args(synthetic=True, device="cuda", native_loader="off",
                                          data_workers=0, prefetch=0, **kw)

        def make():
            solver, train, test = app.build(args)
            _close(train, test)
            return solver

        solver, feed, test = app.build(args)
        _close(test)
    batches = [_host(next(feed)) for _ in range(FUSED_ITERS * solver.sp.iter_size)]
    _close(feed)
    return solver, make, batches


def _leaf_items(solver):
    """(name, tensor) of every param, net state and optimizer slot."""
    out = []
    for kind, tree in (("param", solver.params), ("state", solver.state),
                       *((f"slot {k}", v) for k, v in solver.opt_state.items())):
        for layer, e in tree.items():
            for n, t in e.items():
                out.append((f"{kind} {layer}.{n}", t))
    return out


def _snapshot(solver):
    return ([(k, t.clone()) for k, t in _leaf_items(solver)], solver.rng.get_state())


def _reset(solver, snap, fused):
    """``solver`` back at iteration 0 from ``snap``: its resident tensors
    assigned anew (which drops any captured step), the generator's state,
    the counter dropped, ``_fuse_host`` set."""
    import torch

    leaves, rng = snap
    clone = {k: t.clone() for k, t in leaves}

    def tree(kind, like):
        return {layer: {n: clone[f"{kind} {layer}.{n}"] for n in e} for layer, e in like.items()}

    solver.params = tree("param", solver.params)
    solver.state = tree("state", solver.state)
    solver.opt_state = {k: tree(f"slot {k}", v) for k, v in solver.opt_state.items()}
    solver.rng.set_state(rng)
    solver.iter = 0
    solver._it_dev = None
    solver._fuse_host = fused
    solver._loss_window.clear()
    torch.cuda.synchronize()


def _fused_run(solver, snap, batches, fused, save=None, scan=False):
    """FUSED_ITERS iterations from ``snap``: eager (``fused`` False: no
    graph) or through the graph, one ``step`` at a time (each step's
    metrics, checked unchanged one step later, and the rate its update
    used), or one ``scan_steps`` on ``batches[0]``; ``save`` writes the
    solverstate at FUSED_SAVE_AT. Through the graph one step at a time,
    the steps after the capture run under ``torch.profiler``, the first
    of them traced and dropped, the others held replay by replay
    (:func:`_traced_per_replay`). The launches counted from 0, the final
    leaves and generator state."""
    import itertools

    import torch

    from sparknet_tpu_torch.ops import launch_counters
    from sparknet_tpu_torch.solver.trainer import WARMUP_STEPS

    _reset(solver, snap, fused)
    for fn in launch_counters():
        fn.launches = 0
    metrics, rates, traced = [], [], None
    if scan:
        m = solver.scan_steps(batches[0], FUSED_ITERS)
        metrics.append({k: v.clone() for k, v in m.items()})
    else:
        feed = iter(batches)
        held = []

        def one(i):
            if save is not None and i == FUSED_SAVE_AT:
                solver.save(save)
            m = solver.step(feed, 1)
            rates.append(solver._train_step.update.rate.clone())
            if held:
                for k, v in held[-1][1].items():
                    if not torch.equal(held[-1][0][k], v):
                        raise AssertionError(f"step {i - 1}'s metric {k} changed at step {i}: "
                                             f"{float(v)} -> {float(held[-1][0][k])}")
            held[:] = [(m, {k: v.clone() for k, v in m.items()})]
            metrics.append(held[-1][1])

        # through the graph, the replays after the capture's are traced
        first = WARMUP_STEPS + 1 if fused else FUSED_ITERS
        for i in range(first):
            one(i)
        if fused:
            nxt = itertools.count(first)
            traced = _traced_per_replay(
                f"graph run, {FUSED_ITERS - first - 1} replays", lambda: one(next(nxt)),
                FUSED_ITERS - first - 1)["kernels"]
    torch.cuda.synchronize()
    if solver.iter != FUSED_ITERS:
        raise AssertionError(f"iter {solver.iter} after {FUSED_ITERS} iterations")
    return {"metrics": metrics, "rates": rates, "traced": traced,
            "launches": [fn.launches for fn in launch_counters()],
            "leaves": [(k, t.clone()) for k, t in _leaf_items(solver)],
            "rng": solver.rng.get_state()}


def _leaf_diffs(a, b):
    """Per leaf: (name, max |a - b|, relative L2 of a against b)."""
    import torch

    out = []
    for (name, x), (name_b, y) in zip(a, b):
        if name != name_b:
            raise AssertionError(f"leaf order {name} / {name_b}")
        d = (x.double() - y.double())
        rel = float(d.norm() / y.double().norm().clamp(min=1e-30))
        out.append((name, float(d.abs().max()) if d.numel() else 0.0, rel))
    return out


def _held_to(label, got, want, spread):
    """``got`` against ``want`` leaf by leaf: bit for bit where ``spread``
    (two eager runs' per-leaf max |difference|) is 0, else within it, and
    within FUSED_OUTER relative L2 everywhere. Returns the worst line."""
    diffs = _leaf_diffs(got["leaves"], want["leaves"])
    bad = [(n, d, r, s) for (n, d, r), (_, s, _) in zip(diffs, spread)
           if d > s or r > FUSED_OUTER]
    worst = max(diffs, key=lambda x: x[1])
    if bad:
        raise AssertionError(f"{label}: {len(bad)} leaves beyond the eager spread, e.g. "
                             + "; ".join(f"{n} max|diff| {d:.3e} rel {r:.3e} (spread {s:.3e})"
                                         for n, d, r, s in bad[:5]))
    return f"{label}: worst max|diff| {worst[1]:.3e} ({worst[0]})"


@contextlib.contextmanager
def _deterministic():
    """cuDNN's deterministic algorithms and PyTorch's deterministic kernels
    (an accumulating ``index_put_`` by sorting, among others; a kernel
    without one warns), so that two eager runs agree bit for bit where
    the libraries allow it."""
    import torch
    import torch.utils.deterministic

    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.utils.deterministic.fill_uninitialized_memory)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[:2]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])
        torch.utils.deterministic.fill_uninitialized_memory = saved[4]


def _fused_net(name, tmp):
    """The fused-step checks of one net (phase_fused_step)."""
    import torch

    from sparknet_tpu_torch.ops import launch_counters
    from sparknet_tpu_torch.solver.caffe_solver import learning_rate
    from sparknet_tpu_torch.solver.trainer import WARMUP_STEPS

    t0 = time.perf_counter()
    solver, make, batches = _fused_case(name, tmp)
    snap = _snapshot(solver)
    e1 = _fused_run(solver, snap, batches, False)
    e2 = _fused_run(solver, snap, batches, False)
    spread = _leaf_diffs(e2["leaves"], e1["leaves"])
    exact = all(d == 0.0 for _, d, _ in spread) and torch.equal(e1["rng"], e2["rng"])
    worst = max(spread, key=lambda x: x[1])
    log(f"  {name}: two eager runs " + ("agree bit for bit" if exact else
        f"differ: worst max|diff| {worst[1]:.3e} rel {worst[2]:.3e} ({worst[0]}); the graph "
        f"is held to that spread"))
    path = os.path.join(tmp, f"{name}_fused_iter_{FUSED_SAVE_AT}.solverstate.npz")
    g = _fused_run(solver, snap, batches, True, save=path)
    lines = [_held_to("graph vs eager", g, e1, spread)]
    if not torch.equal(g["rng"], e1["rng"]):
        raise AssertionError(f"{name}: the generator's state after the graph's run is not "
                             f"the eager run's")
    if g["launches"] != e1["launches"]:
        raise AssertionError(f"{name}: kernel launches graph {g['launches']} != eager "
                             f"{e1['launches']}")
    for i, (mg, me, rg, re_) in enumerate(zip(g["metrics"], e1["metrics"], g["rates"],
                                             e1["rates"])):
        host = learning_rate(solver.sp, i)
        if not torch.equal(rg, re_) or not math.isclose(float(rg), host, rel_tol=1e-6):
            raise AssertionError(f"{name} iteration {i}: the graph's rate {float(rg)!r}, "
                                 f"eager's {float(re_)!r}, the host's {host!r}")
        for k in me:
            if exact and not torch.equal(mg[k], me[k]):
                raise AssertionError(f"{name} iteration {i}: metric {k} graph {float(mg[k])!r}"
                                     f" eager {float(me[k])!r}")
    rates = [float(r) for r in g["rates"]]
    # a save at FUSED_SAVE_AT restored into a fresh solver: the rest of the run
    fresh = make()
    for fn in launch_counters():
        fn.launches = 0
    fresh.restore(path)
    os.unlink(path)
    if fresh._it_dev is not None or fresh.iter != FUSED_SAVE_AT:
        raise AssertionError(f"{name}: restored iter {fresh.iter}, counter {fresh._it_dev}")
    fresh.step(iter(batches[FUSED_SAVE_AT * solver.sp.iter_size:]),
               FUSED_ITERS - FUSED_SAVE_AT)
    torch.cuda.synchronize()
    resumed = {"leaves": [(k, t.clone()) for k, t in _leaf_items(fresh)]}
    lines.append(_held_to("resumed vs straight graph run", resumed, g, spread))
    half = [fn.launches * FUSED_ITERS // (FUSED_ITERS - FUSED_SAVE_AT)
            for fn in launch_counters()]
    if half != g["launches"]:
        raise AssertionError(f"{name}: the resumed run's launches scaled to "
                             f"{FUSED_ITERS} iterations {half} != {g['launches']}")
    del fresh
    # scan_steps against the eager step over its one batch repeated
    one = [batches[0]] * len(batches)
    ref = _fused_run(solver, snap, one, False)
    scan = _fused_run(solver, snap, one, True, scan=True)
    lines.append(_held_to("scan_steps vs eager steps on one batch", scan, ref, spread))
    if scan["launches"] != ref["launches"]:
        raise AssertionError(f"{name}: scan_steps launches {scan['launches']} != eager "
                             f"{ref['launches']}")
    if exact and not all(torch.equal(scan["metrics"][-1][k], ref["metrics"][-1][k])
                         for k in ref["metrics"][-1]):
        raise AssertionError(f"{name}: scan_steps' last metrics differ from the eager step's")
    loss = [float(m["loss"]) for m in g["metrics"] if "loss" in m]
    log(f"  {name}: " + "; ".join(lines) + f"; rates {rates[0]:.6g} .. {rates[-1]:.6g} "
        f"(host's within 1e-6); launches {g['launches']} both ways, the graph's "
        f"{FUSED_ITERS - WARMUP_STEPS - 2} replays after its capture and a dropped one "
        f"traced, each = the counters' a replay: {g['traced']}; losses {loss[:1]} .. "
        f"{loss[-1:]}; {time.perf_counter() - t0:.1f} s")
    launches = g["launches"]
    del solver, snap, e1, e2, g, ref, scan, resumed
    torch.cuda.empty_cache()
    return {"exact": exact, "launches": launches}


def phase_fused_step(tmp):
    """The train step as one captured CUDA graph against the eager step
    (module docstring, phase fused-step); the graph runs' kernel launches
    by wrapper, for the kernels line."""
    from sparknet_tpu_torch.ops import launch_counters

    names = [fn.__name__ for fn in launch_counters()]
    total = dict.fromkeys(names, 0)
    with _deterministic():
        for net in FUSED_NETS:
            for name, n in zip(names, _fused_net(net, tmp)["launches"]):
                total[name] += n
    log(f"  kernel launches of the four graph runs: {total}")
    return total


# ------------------------------------------------- parallel training
def _cifar_solver_file(tmp: str, iters: int, test_iter: int, display: int) -> str:
    """The port's cifar10_quick solver (base_lr 0.001, momentum 0.9,
    decay 4e-3) cut to ``iters`` iterations, tests before the loop and at
    the end, snapshots under ``tmp``."""
    from sparknet_tpu_torch.models import CIFAR_QUICK_SOLVER, CIFAR_QUICK_TRAIN_TEST

    text = open(CIFAR_QUICK_SOLVER).read()
    for key, value in (("net", f'"{CIFAR_QUICK_TRAIN_TEST}"'), ("test_iter", test_iter),
                       ("test_interval", iters), ("display", display),
                       ("snapshot", iters),
                       ("snapshot_prefix", f'"{os.path.join(tmp, "cifar")}"')):
        lines = [ln for ln in text.splitlines() if not ln.startswith(f"{key}:")]
        text = "\n".join(lines + [f"{key}: {value}"]) + "\n"
    path = os.path.join(tmp, "cifar_smoke_solver.prototxt")
    with open(path, "w") as f:
        f.write(text)
    return path


def phase_cifar_app(tmp):
    """CifarApp through ``main([...])`` on the card: cifar10_quick at its
    batch of 100 on the synthetic set."""
    log(f"  card: {_smi()}")
    import contextlib
    import io
    import itertools
    import math
    import re

    from sparknet_tpu_torch.apps import cifar_app

    argv = ["--solver", _cifar_solver_file(tmp, CIFAR_ITERS, 10, 50), "--synthetic",
            "--synthetic-n", "5000", "--max-iter", str(CIFAR_ITERS), "--device", "cuda"]
    log(f"  cifar_app.main({argv})")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        last_test = cifar_app.main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"  | {line}")
    losses = [float(v) for v in re.findall(r"Iteration \d+, loss = (\S+)", out)]
    tests = [float(v) for v in re.findall(r"Test net output: loss = (\S+)", out)]
    accs = [float(v) for v in re.findall(r"Test net output: accuracy = (\S+)", out)]
    speed = re.findall(r"speed: steps/s=(\S+) images/s=(\S+)", out)
    if len(losses) != CIFAR_ITERS // 50 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"display losses {losses}")
    if len(tests) != 2 or not tests[1] < 0.5 * tests[0] or not losses[-1] < tests[0]:
        raise AssertionError(f"the loss did not fall: test losses {tests}, train {losses}")
    if not accs[-1] >= 0.1 + CIFAR_ACC_MARGIN:
        raise AssertionError(f"last test accuracy {accs[-1]}, chance 0.1 + margin "
                             f"{CIFAR_ACC_MARGIN}")
    steps_s, images_s = (float(x) for x in speed[-1])
    loader = (re.findall(r"data loader: (\S+)", out) or ["unknown"])[0]
    log(f"  test loss {tests[0]:.4f} -> {tests[1]:.4f}, accuracy {accs[-1]:.4f} (chance "
        f"0.1, want >= {0.1 + CIFAR_ACC_MARGIN}); speed: {steps_s} steps/s, {images_s} "
        f"images/s at batch 100 through the app's default feed ({loader} loader, "
        f"--prefetch 2)")
    # the app's resident step, eager and through the graph
    args = cifar_app.arg_parser().parse_args(
        ["--solver", _cifar_solver_file(tmp, CIFAR_ITERS, 10, 50), "--synthetic",
         "--synthetic-n", "1000", "--device", "cuda", "--prefetch", "0"])
    solver, train_feed, test_feed = cifar_app.build(args)
    feed = itertools.repeat(solver._put_batch(next(train_feed)))
    _close(train_feed, test_feed)
    step = _profile_steps(solver, feed, "cifar10_quick batch 100, f32, resident batch", 100,
                          "images")
    return {"steps_per_s": steps_s, "images_per_s": images_s, "last_test": last_test,
            "step": step}


def _close(*feeds):
    for feed in feeds:
        close = getattr(feed, "close", None)
        if close is not None:
            close()


def _cifar_parallel(workers, mode, tau=1, compress="none", bucket_mb=4.0):
    """A ParallelSolver on cifar10_quick at batch 100 over ``workers``,
    weights from seed 0 (the same on every device)."""
    from sparknet_tpu_torch.models import CIFAR_QUICK_SOLVER, CIFAR_QUICK_TRAIN_TEST
    from sparknet_tpu_torch.parallel import CommConfig, ParallelSolver
    from sparknet_tpu_torch.proto import caffe_pb

    shapes = {"data": (100, 32, 32, 3), "label": (100,)}
    return ParallelSolver(caffe_pb.load_solver(CIFAR_QUICK_SOLVER), shapes,
                          net_param=caffe_pb.load_net(CIFAR_QUICK_TRAIN_TEST),
                          workers=workers, mode=mode, tau=tau, seed=0,
                          comm_config=CommConfig(compress=compress, bucket_mb=bucket_mb))


def _cifar_feed():
    """CifarApp's serial feed over the 5,000-image synthetic set, the
    full-set mean subtracted."""
    from sparknet_tpu_torch.apps import cifar_app
    from sparknet_tpu_torch.data.cifar import cifar10_dataset
    from sparknet_tpu_torch.data.preprocess import Transformer

    ds, mean = cifar10_dataset(None, synthetic_n=5000)
    return cifar_app.make_feed(ds, Transformer(mean_image=mean), 100, seed=0)


def _rel_errs(got, want):
    """Each tensor's relative L2 error of ``got`` (card) against ``want``."""
    from sparknet_tpu_torch.parallel import comm

    out = []
    for g, w in zip(comm.tree_leaves(got), comm.tree_leaves(want)):
        g = g.detach().cpu().double()
        w = w.detach().cpu().double()
        out.append(float((g - w).norm() / w.norm().clamp_min(1e-30)))
    return out


def _shifted_rows(batch, w, num_workers, axis, device):
    """A planted fault: ``local_sgd.worker_rows`` with every worker but
    the first starting one row early (rows overlap, the last is lost)."""
    out = {}
    for k, x in batch.items():
        per = x.shape[axis] // num_workers
        out[k] = x.narrow(axis, max(w * per - 1, 0), per).to(device)
    return out


def _summed(xs):
    """A planted fault: ``comm._mean`` without its division."""
    acc = xs[0].clone()
    for x in xs[1:]:
        acc += x.to(acc.device)
    return acc


@contextlib.contextmanager
def _planted(fault, solver):
    """Run with one fault planted: ``rows`` (a row split shifted by one
    row), ``rate`` (twice ``solver``'s learning rate) or ``sum`` (a sum
    in place of the workers' mean)."""
    from sparknet_tpu_torch.parallel import comm, data_parallel, local_sgd

    saved = []
    if fault == "rows":
        saved += [(m, "worker_rows", m.worker_rows) for m in (local_sgd, data_parallel)]
        local_sgd.worker_rows = data_parallel.worker_rows = _shifted_rows
    elif fault == "rate":
        saved.append((solver.sp, "base_lr", solver.sp.base_lr))
        solver.sp.base_lr *= 2
    else:
        saved.append((comm, "_mean", comm._mean))
        comm._mean = _summed
    try:
        yield
    finally:
        for obj, attr, value in saved:
            setattr(obj, attr, value)


PLANTED = ("rows", "rate", "sum")


def phase_local_sgd():
    """SparkNet's tau-local SGD on the card: cifar10_quick, batch 100, 4
    workers on cuda:0, tau 10, for each wire format; then sync data
    parallel against one worker."""
    log(f"  card: {_smi()}")
    import itertools
    import math

    import torch

    from sparknet_tpu_torch.parallel import CommConfig, comm, make_round_reduce
    from sparknet_tpu_torch.parallel.local_sgd import RESIDUAL_KEY, stack_round_batches
    from sparknet_tpu_torch.solver.trainer import Solver

    workers = ["cuda:0"] * LOCAL_WORKERS
    feed = _cifar_feed()
    first = [next(feed) for _ in range(LOCAL_TAU)]
    out = {}
    for compress in ("none", "bf16", "int8"):
        card = _cifar_parallel(workers, "local", LOCAL_TAU, compress)
        cpu = _cifar_parallel(["cpu"] * LOCAL_WORKERS, "local", LOCAL_TAU, compress)
        seen = {}
        for name, solver in (("card", card), ("cpu", cpu)):
            seen[name] = _spy_reduce(solver)
        card.step(iter(first), LOCAL_TAU)
        m0 = cpu.step(iter(first), LOCAL_TAU)
        for solver in (card, cpu):
            solver._reduce_fn = solver._reduce_fn.wrapped
        held = _held_round(compress, card, cpu, seen["card"], seen["cpu"])
        if compress == "none":
            reference = cpu, seen["cpu"]
        reduce_ms, round_ms, losses = [], [], []
        reduce_fn = card._reduce_fn

        def timed(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = reduce_fn(*args)
            torch.cuda.synchronize()
            reduce_ms.append((time.perf_counter() - t) * 1e3)
            return res

        card._reduce_fn = timed
        for _ in range(LOCAL_ROUNDS - 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            m = card.step(feed, LOCAL_TAU)
            torch.cuda.synchronize()
            round_ms.append((time.perf_counter() - t) * 1e3)
            losses.append(float(m["loss"]))
        card._reduce_fn = reduce_fn
        finite = all(bool(torch.isfinite(x).all()) for x in comm.tree_leaves(card.params))
        r_ms, d_ms = statistics.median(round_ms), statistics.median(reduce_ms)
        log(f"  {compress}: rounds 2-{LOCAL_ROUNDS}: {r_ms:.2f} ms per round (median, "
            f"host clock, synchronized), of which the average {d_ms:.3f} ms "
            f"({100 * d_ms / r_ms:.1f}%); round loss {float(m0['loss']):.4f} -> "
            f"{losses[-1]:.4f}; comm {json.dumps({k: v for k, v in card.comm_report().items() if k != 'buckets'})}")
        if not finite or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{compress}: non-finite weights or losses {losses}")
        if not losses[-1] < 0.5 * float(m0["loss"]):
            raise AssertionError(f"{compress}: the round loss did not fall: {losses}")
        if compress != "none" and RESIDUAL_KEY not in card.opt_state:
            raise AssertionError(f"{compress}: no error-feedback residual")
        out[compress] = {"round_ms": r_ms, "reduce_ms": d_ms, "card_vs_cpu": held}
        if compress == "none":
            _profile_round(card, feed)
            # one more τ-step body, its workers' weights averaged twice on
            # the card: under a bucketed config and leaf by leaf
            stacked = card._put_batch(stack_round_batches(
                [next(feed) for _ in range(LOCAL_TAU)]))
            p_start, ps, sts, _, _ = card._round_fn(LOCAL_TAU)(
                card.params, card.state, card.opt_state, stacked, card.iter,
                card._worker_generators(card.iter))
            cfg = CommConfig(mode="bucketed", bucket_mb=0.1)
            bucketed, _, _ = make_round_reduce(cfg)(p_start, ps, sts, None)
            mono = comm.reduce_per_leaf(ps)
            same = all(torch.equal(a, b) for a, b in zip(comm.tree_leaves(bucketed),
                                                         comm.tree_leaves(mono)))
            differ = all(not torch.equal(comm.tree_leaves(ps[0])[0],
                                         comm.tree_leaves(p)[0]) for p in ps[1:])
            log(f"  lossless average on the card: bucketed config (bucket_mb "
                f"{cfg.bucket_mb}) bit-equal to leaf by leaf: {same}; every "
                f"worker's end-of-round weights differ from worker 0's: {differ}")
            if not (same and differ):
                raise AssertionError(f"bucketed == per-leaf {same}, workers differ {differ}")
    # sync data parallel against one worker on the same global batches
    sync = _cifar_parallel(workers, "sync")
    single = Solver(sync.sp, {"data": (100, 32, 32, 3), "label": (100,)},
                    net_param=sync.net_param, seed=0, device="cuda")
    errs, losses = [], []
    sync_batches = [next(feed) for _ in range(SYNC_STEPS)]
    for b in sync_batches:
        m, m1 = sync.step(iter([b]), 1), single.step(iter([b]), 1)
        losses.append(abs(float(m["loss"]) - float(m1["loss"])) / abs(float(m1["loss"])))
        errs.append(max(_rel_errs(sync.params, single.params)))
    log(f"  sync, {LOCAL_WORKERS} workers x 25 rows vs 1 worker x 100 rows, "
        f"{SYNC_STEPS} steps: worst relative L2 error of the weights {errs[0]:.2e} after "
        f"step 1 [<= {LOCAL_STEP_TOL:g}], {errs[-1]:.2e} after step {SYNC_STEPS} "
        f"[<= {LOCAL_CARD_TOL:g}]; each step's loss within {max(losses):.2e} relative "
        f"[<= {LOCAL_STEP_TOL:g}]")
    if errs[0] > LOCAL_STEP_TOL or errs[-1] > LOCAL_CARD_TOL or max(losses) > LOCAL_STEP_TOL:
        raise AssertionError(f"sync vs one worker: weights {errs}, losses {losses}")
    out["sync"] = errs
    out["planted"] = _plant_faults(workers, first, reference, sync_batches, single)
    sound = max([out[c]["card_vs_cpu"]["workers"] for c in ("none", "bf16", "int8")]
                + [errs[-1]])
    low = min(out["planted"].values())
    log(f"  limit {LOCAL_CARD_TOL:g}: the sound runs' worst reading {sound:.2e} "
        f"({LOCAL_CARD_TOL / sound:.1f}x below it), the planted faults' least {low:.2e} "
        f"({low / LOCAL_CARD_TOL:.1f}x above it)")
    if low <= LOCAL_CARD_TOL:
        raise AssertionError(f"a planted fault passes the {LOCAL_CARD_TOL:g} limit: "
                             f"{out['planted']}")
    return out


def _plant_faults(workers, first, reference, sync_batches, single):
    """Each planted fault's reading on the card, by the limit that holds
    the sound runs: the first local round's workers' weights and their
    average against the sound CPU round (the worse of the two), and the
    10 sync steps' weights against the one-worker run."""
    cpu, seen_cpu = reference
    readings = {}
    for fault in PLANTED:
        bad = _cifar_parallel(workers, "local", LOCAL_TAU)
        seen = _spy_reduce(bad)
        with _planted(fault, bad):
            bad.step(iter(first), LOCAL_TAU)
        ws = max(max(_rel_errs(a, b)) for a, b in zip(seen["ps"], seen_cpu["ps"]))
        avg = max(_rel_errs(bad.params, cpu.params))
        readings[f"local {fault}"] = max(ws, avg)
        log(f"  planted {fault}, local round: workers' weights {ws:.2e}, average "
            f"{avg:.2e} relative L2 against the sound CPU round [want > "
            f"{LOCAL_CARD_TOL:g}]")
    for fault in PLANTED:
        bad = _cifar_parallel(workers, "sync")
        with _planted(fault, bad):
            for b in sync_batches:
                bad.step(iter([b]), 1)
        readings[f"sync {fault}"] = max(_rel_errs(bad.params, single.params))
        log(f"  planted {fault}, {SYNC_STEPS} sync steps: weights "
            f"{readings[f'sync {fault}']:.2e} relative L2 against one worker [want > "
            f"{LOCAL_CARD_TOL:g}]")
    return readings


def _spy_reduce(solver):
    """Wrap ``solver``'s round average to keep what it was given: the
    round-start weights, the workers' end-of-round weights, the residual."""
    seen = {}
    fn = solver._reduce_fn

    def spy(p_start, ps, sts, res):
        seen.update(p_start=p_start, ps=ps, res=res)
        return fn(p_start, ps, sts, res)

    spy.wrapped = fn
    solver._reduce_fn = spy
    return seen


def _payloads(seen):
    """Each worker's payload of the round, leaf by leaf, f64 on the CPU:
    its weight delta plus its residual row."""
    from sparknet_tpu_torch.parallel import comm

    starts = [x.double().cpu() for x in comm.tree_leaves(seen["p_start"])]
    rows = ([x.double().cpu() for x in comm.tree_leaves(seen["res"])]
            if seen["res"] is not None else None)
    return [[e.double().cpu() - s + (rows[i][w] if rows else 0.0)
             for i, (e, s) in enumerate(zip(comm.tree_leaves(p), starts))]
            for w, p in enumerate(seen["ps"])]


def _quanta(seen_card, seen_cpu, compress, bucket_bytes):
    """Per element of each leaf, how far roundings that flip between the
    card and the CPU can move the average: bf16, the workers' two ulps
    of what each sent (two: a value across a power of two has twice the
    ulp) over the worker count; int8, its bucket's shared scale (absmax /
    127, the larger of the two runs') plus 127 times the two scales'
    difference (every element dequantizes by its own run's scale); 0
    lossless."""
    import torch

    from sparknet_tpu_torch.parallel import comm

    cpu = _payloads(seen_cpu)
    zeros = [torch.zeros_like(x) for x in cpu[0]]
    if compress == "none":
        return zeros
    if compress == "bf16":
        for pw in cpu:
            for i, x in enumerate(pw):
                _, e = torch.frexp(x)  # x = m 2^e, 0.5 <= |m| < 1; bf16's ulp: 2^(e-8)
                zeros[i] += torch.where(x != 0, torch.ldexp(torch.ones_like(x), e - 7),
                                        0.0) / len(cpu)
        return zeros
    card = _payloads(seen_card)
    leaves = comm.tree_leaves(seen_cpu["p_start"])
    for bucket in comm.plan_buckets(leaves, bucket_bytes):
        scales = [max(float(pw[i].abs().max()) for pw in run for i in bucket) / 127.0
                  for run in (card, cpu)]
        for i in bucket:
            zeros[i] += max(scales) + 127.0 * abs(scales[0] - scales[1])
    return zeros


def _held_round(compress, card, cpu, seen_card, seen_cpu):
    """One round on the card held against the CPU's: each worker's
    end-of-round weights within LOCAL_CARD_TOL relative L2 error; the
    averaged weights, element by element, within the mean of the
    workers' differences plus the quanta a flipped rounding can move
    them (``_quanta``) and 1e-6 of the average's operands."""
    import torch

    from sparknet_tpu_torch.parallel import comm

    worker = max(max(_rel_errs(a, b)) for a, b in zip(seen_card["ps"], seen_cpu["ps"]))
    quanta = _quanta(seen_card, seen_cpu, compress, cpu.comm.bucket_bytes)
    ps_card = [[x.double().cpu() for x in comm.tree_leaves(p)] for p in seen_card["ps"]]
    ps_cpu = [[x.double().cpu() for x in comm.tree_leaves(p)] for p in seen_cpu["ps"]]
    starts = [x.double().cpu() for x in comm.tree_leaves(seen_cpu["p_start"])]
    worst = flips = 0.0
    for i, (g, w) in enumerate(zip(comm.tree_leaves(card.params), comm.tree_leaves(cpu.params))):
        g, w = g.double().cpu(), w.double().cpu()
        spread = sum((a[i] - b[i]).abs() for a, b in zip(ps_card, ps_cpu)) / len(ps_card)
        # the f32 rounding of start + mean(deltas), in both runs: 1e-6 of
        # the operands' size (the weight itself may cancel to ~0)
        size = starts[i].abs() + torch.stack([(p[i] - starts[i]).abs() for p in ps_cpu]).amax(0)
        slack = 1e-6 * size + 1e-12
        diff = (g - w).abs()
        worst = max(worst, float((diff / (spread + quanta[i] + slack)).max()))
        flips += int((diff > spread + slack).sum())
    avg = max(_rel_errs(card.params, cpu.params))
    log(f"  {compress}: one round ({LOCAL_WORKERS} workers x {LOCAL_TAU} steps of 25 rows), "
        f"card vs CPU from the same weights and batches: workers' weights worst relative "
        f"L2 error {worker:.2e} [<= {LOCAL_CARD_TOL:g}]; averaged weights {avg:.2e}, "
        f"{flips:.0f} elements past the workers' spread (flipped roundings), worst "
        f"|difference| / (spread + quanta + rounding) {worst:.3f} [<= 1]")
    if worker > LOCAL_CARD_TOL or worst > 1.0:
        raise AssertionError(f"{compress}: card vs CPU round: workers {worker:.2e}, "
                             f"average {worst:.3f}")
    return {"workers": worker, "average": avg, "flips": flips, "worst_ratio": worst}


def _profile_round(solver, feed):
    """One local round under ``torch.profiler``: the card's busy time
    against the round's wall time, and the kernel launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.step(feed, solver.tau)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and not _annotation(e)]
    busy_ms = sum(getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0.0) for e in kernels) / 1e3
    if not busy_ms:
        log("  profiled round: device time not measured (the profiler saw no device "
            "events)")
        return
    launches = sum(e.count for e in kernels)
    log(f"  profiled round: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall (idle "
        f"share {100 * (1 - busy_ms / wall_ms):.1f}%), {launches} kernel launches, "
        f"{launches / (solver.tau * len(solver.workers)):.0f} a worker step")


def _alexnet_local_solver(tmp):
    from sparknet_tpu_torch.models import ALEXNET_TRAIN_VAL

    path = os.path.join(tmp, "alexnet_local_solver.prototxt")
    with open(path, "w") as f:
        f.write(
            f'net: "{ALEXNET_TRAIN_VAL}"\n'
            f"test_iter: 2\ntest_interval: {ALEXNET_LOCAL_ITERS}\nbase_lr: 0.01\n"
            'lr_policy: "step"\ngamma: 0.1\nstepsize: 100000\ndisplay: 2\n'
            f"max_iter: {ALEXNET_LOCAL_ITERS}\nmomentum: 0.9\nweight_decay: 0.0005\n"
            f"snapshot: {ALEXNET_LOCAL_ITERS}\n"
            f'snapshot_prefix: "{os.path.join(tmp, "alexnet_local")}"\n'
        )
    return path


def phase_alexnet_local(tmp):
    """ImageNetApp's solver with ``--parallel local --tau 2`` over 2
    workers on cuda:0: full-width bvlc_alexnet, batch 256 (128 a
    worker), counted kernel by kernel."""
    log(f"  card: {_smi()}")
    import contextlib
    import io
    import math
    import re

    import torch

    from sparknet_tpu_torch.apps import imagenet_app
    from sparknet_tpu_torch.apps.cifar_app import train_loop
    from sparknet_tpu_torch.ops.lrn import lrn_rows, lrn_rows_bwd, lrn_rows_train
    from sparknet_tpu_torch.solver import snapshot

    args = imagenet_app.make_args(synthetic=True, synthetic_n=512,
                                  solver=_alexnet_local_solver(tmp), device="cuda",
                                  parallel="local", tau="2")
    solver, train_feed, test_feed = imagenet_app.build(args, workers=["cuda:0"] * 2)
    log(f"  imagenet_app.build({args}, workers=[cuda:0, cuda:0]): {type(solver).__name__} "
        f"mode {solver.mode}, tau {solver.tau}, workers {[str(d) for d in solver.workers]}")
    buf = io.StringIO()
    lrn_rows.launches = lrn_rows_train.launches = lrn_rows_bwd.launches = 0
    with contextlib.redirect_stdout(buf):
        train_loop(solver, train_feed, test_feed)
    counts = (lrn_rows.launches, lrn_rows_train.launches, lrn_rows_bwd.launches)
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"  | {line}")
    losses = [float(v) for v in re.findall(r"Iteration \d+, loss = (\S+)", out)]
    if len(losses) != ALEXNET_LOCAL_ITERS // 2 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"display losses {losses}")
    tests = 2  # before the loop and at the end
    want = (2 * 2 * tests, 2 * 2 * ALEXNET_LOCAL_ITERS, 2 * 2 * ALEXNET_LOCAL_ITERS)
    log(f"  LRN launches: inference {counts[0]} (want {want[0]}: 2 per test batch), "
        f"training forward {counts[1]}, backward {counts[2]} (want {want[1]} each: 2 "
        f"per worker step, 2 workers a step)")
    if counts != want:
        raise AssertionError(f"LRN launches {counts}, want {want}")
    path = os.path.join(tmp, f"alexnet_local_iter_{ALEXNET_LOCAL_ITERS}.solverstate.npz")
    st = snapshot.load_state(path)
    lead = st["opt_state"]["momentum"]["conv1"]["weight"].shape
    before = {k: t.clone() for k, t in solver.opt_state["momentum"]["conv1"].items()}
    solver.restore(path)
    after = solver.opt_state["momentum"]["conv1"]
    same = all(torch.equal(before[k], after[k].to(before[k].device)) for k in before)
    log(f"  solverstate: momentum conv1 weight {tuple(lead)} in the file (worker, HWIO), "
        f"{tuple(after['weight'].shape)} restored (worker, OIHW), equal: {same}")
    if tuple(lead) != (2, 11, 11, 3, 96) or not same or st["it"] != ALEXNET_LOCAL_ITERS:
        raise AssertionError(f"solverstate: iter {st['it']}, lead {lead}, equal {same}")
    return {"launches": counts}


# -------------------------------------------------------- multiprocess
def _launch_ranks(jobs, world, tmp, backend, timeout=MP_TIMEOUT, cmd=None, env=None):
    """Start ``world`` ranks through the launch variables
    (``SPARKNET_COORDINATOR``, ``SPARKNET_NUM_PROCESSES``,
    ``SPARKNET_PROCESS_ID``): by default ``python3 chip_smoke.py
    --rank-job SPEC``, each rank running ``jobs`` in order over
    ``backend``. Each rank runs in its own session with its output in
    ``tmp``; all must exit 0 within ``timeout`` seconds, else every one
    left is killed and the phase fails with their logs. Returns each
    rank's results (the jobs' JSON) and its log."""
    import signal
    import socket

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    # a name of its own: launches may run side by side
    fd, spec = tempfile.mkstemp(prefix="spec_", suffix=".json", dir=tmp)
    os.close(fd)
    with open(spec, "w") as f:
        # gloo rehearses on one card; NCCL takes one card a rank
        json.dump({"jobs": jobs, "backend": backend, "out": tmp,
                   "device": "cuda:0" if backend == "gloo" else "cuda"}, f)
    env = dict(os.environ, **(env or {}), SPARKNET_COORDINATOR=f"127.0.0.1:{free_port()}",
               SPARKNET_NUM_PROCESSES=str(world), SPARKNET_HEARTBEAT_PORT=str(free_port()),
               PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH"))
                                          if p))
    cmd = cmd or [sys.executable, os.path.abspath(__file__), "--rank-job", spec]
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for r in range(world):
            logs.append(open(os.path.join(tmp, f"rank{r}_{os.path.basename(spec)}.log"),
                             "w+"))
            procs.append(subprocess.Popen(cmd, env=dict(env, SPARKNET_PROCESS_ID=str(r)),
                                          cwd=tmp, stdout=logs[-1],
                                          stderr=subprocess.STDOUT, start_new_session=True))
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                p.wait(max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        texts = []
        for log_file in logs:
            log_file.seek(0)
            texts.append(log_file.read())
            log_file.close()
    codes = [p.returncode for p in procs]
    log(f"  {world} rank(s) over {backend}: exit codes {codes} after "
        f"{time.perf_counter() - t0:.1f} s")
    if any(codes):
        for r, text in enumerate(texts):
            log(f"  --- rank {r} (exit {codes[r]}), last lines:")
            for line in text.splitlines()[-40:]:
                log(f"  | {line}")
        raise AssertionError(f"ranks exited {codes}")
    results = []
    for r in range(world):
        path = f"{spec}.r{r}.json"
        if os.path.exists(path):
            with open(path) as f:
                results.append(json.load(f))
        else:
            results.append(None)  # a command other than --rank-job
    return results, texts


def rank_main(spec_path):
    """One rank of a multiprocess launch (``--rank-job``): join the job
    over the spec's backend on this process's card, run its jobs, write
    their results beside the spec."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from sparknet_tpu_torch.parallel import multihost

    with open(spec_path) as f:
        spec = json.load(f)
    multihost.initialize(backend=spec["backend"], device=spec["device"])
    rank, world = multihost.process_index(), multihost.process_count()
    print(f"rank {rank}/{world} on {multihost.process_device()} over {spec['backend']}",
          flush=True)
    out = {}
    for job in spec["jobs"]:
        t0 = time.perf_counter()
        out[job["name"]] = RANK_JOBS[job["kind"]](job, rank, world, spec["out"])
        print(f"rank {rank}: {job['name']} done in {time.perf_counter() - t0:.1f} s",
              flush=True)
    with open(f"{spec_path}.r{rank}.json", "w") as f:
        json.dump(out, f)
    multihost.shutdown()
    return 0


def _rank_rows(batch, rank, world):
    """Worker ``rank``'s rows of a global batch, as ``local_sgd.worker_rows``
    gives them to worker ``rank`` of a one-process run."""
    per = len(next(iter(batch.values()))) // world
    return {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}


def _mp_batch(tag, i, n, hw, classes):
    """Global batch ``i`` of stream ``tag``: ``n`` f32 rows of ``hw`` x ``hw``
    x 3 at std 50 and their labels, the same in every process."""
    import numpy as np

    rng = np.random.default_rng((tag, i))
    return {"data": rng.standard_normal((n, hw, hw, 3), dtype=np.float32) * 50,
            "label": rng.integers(0, classes, n).astype(np.int32)}


def _params_hash(params):
    import hashlib

    from sparknet_tpu_torch.parallel import comm

    h = hashlib.sha256()
    for x in comm.tree_leaves(params):
        h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _mp_resnet_solver(workers=None, parallel="sync"):
    """ImageNetApp's ``build`` for ``--arch resnet50`` (the zoo solver) at
    the prototxt's train batch of 32, for the test net too (its 25 does
    not divide by 2 processes), its feeds closed; weights
    ``_zoo_weights``'s. Over processes the solver is one worker a
    process."""
    from sparknet_tpu_torch.apps import imagenet_app

    args = imagenet_app.make_args(arch="resnet50", synthetic=True, synthetic_n=64,
                                  batch_size=MP_RESNET_BATCH, parallel=parallel,
                                  device="cuda", native_loader="off", data_workers=0)
    solver, train_feed, test_feed = imagenet_app.build(args, workers=workers)
    for feed in (train_feed, test_feed):
        getattr(feed, "close", lambda: None)()
    solver.params, solver.state = _zoo_weights(solver.train_net)
    return solver


def _rank_probe(job, rank, world, tmp):
    """Which collectives the backend runs on card tensors: SUM and MAX in
    f32, SUM in int32, all_gather."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for name, t, op, want in (
            ("all_reduce SUM f32", torch.full((4,), rank + 1.0, device=dev),
             dist.ReduceOp.SUM, world * (world + 1) / 2),
            ("all_reduce MAX f32", torch.full((4,), rank + 1.0, device=dev),
             dist.ReduceOp.MAX, float(world)),
            ("all_reduce SUM int32", torch.full((4,), rank + 1, dtype=torch.int32,
                                                device=dev),
             dist.ReduceOp.SUM, world * (world + 1) / 2)):
        try:
            dist.all_reduce(t, op=op)
            out[name] = "ok" if bool((t == want).all()) else f"wrong: {t.tolist()}"
        except RuntimeError as e:
            out[name] = f"not run: {str(e).splitlines()[0]}"
    try:
        rows = [torch.empty(2, device=dev) for _ in range(world)]
        dist.all_gather(rows, torch.full((2,), float(rank), device=dev))
        out["all_gather f32"] = ("ok" if all(bool((x == r).all()) for r, x in enumerate(rows))
                                 else "wrong")
    except RuntimeError as e:
        out["all_gather f32"] = f"not run: {str(e).splitlines()[0]}"
    return out


def _rank_resnet_sync(job, rank, world, tmp):
    """ResNet-50 ``--parallel sync``, lossless (each BatchNorm over the
    global batch), MP_RESNET_STEPS steps on this rank's rows."""
    import torch

    solver = _mp_resnet_solver()
    res = {"workers": [str(d) for d in solver.workers], "losses": []}
    for i in range(MP_RESNET_STEPS):
        m = solver.step(iter([_rank_rows(_mp_batch(1, i, MP_RESNET_BATCH, 224, 1000),
                                         rank, world)]), 1)
        res["losses"].append(float(m["loss/loss"]))
        if i == 0:
            torch.save({l: {k: t.cpu() for k, t in e.items()} for l, e in
                        solver.state.items()}, os.path.join(tmp, f"{job['name']}_state1.r{rank}.pt"))
    torch.save({l: {k: t.cpu() for k, t in e.items()} for l, e in solver.params.items()},
               os.path.join(tmp, f"{job['name']}_params.r{rank}.pt"))
    res["hash"] = _params_hash(solver.params)
    del solver
    torch.cuda.empty_cache()
    return res


def _mp_alexnet_solver(solver_path, workers=None):
    """ImageNetApp's ``build`` with alexnet-local's solver file,
    ``--parallel local --tau 2`` at batch 256, its feeds closed."""
    from sparknet_tpu_torch.apps import imagenet_app

    args = imagenet_app.make_args(synthetic=True, synthetic_n=64, device="cuda",
                                  solver=solver_path, parallel="local", tau="2",
                                  native_loader="off", data_workers=0)
    solver, train_feed, test_feed = imagenet_app.build(args, workers=workers)
    for feed in (train_feed, test_feed):
        getattr(feed, "close", lambda: None)()
    return solver


def _timed_reduce(solver, times):
    """Wrap ``solver``'s round average to record its ms (host clock,
    synchronized before and after; over processes after a barrier, so
    that a rank's wait for a later one is not counted as the average)."""
    import torch
    import torch.distributed as dist

    fn = solver._reduce_fn

    def timed(*args):
        if solver.group is not None:
            dist.barrier(group=solver.group)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        return out

    solver._reduce_fn = timed


def _rank_alexnet_local(job, rank, world, tmp):
    """AlexNet ``--parallel local --tau 2``, ALEXNET_LOCAL_ITERS
    iterations on this rank's rows of batch-256 global batches, then one
    test batch of 50 on its rows; the LRN kernels' launches counted from
    0 around the run; the rounds' average timed."""
    import torch

    from sparknet_tpu_torch.ops.lrn import lrn_rows, lrn_rows_bwd, lrn_rows_train

    solver = _mp_alexnet_solver(job["solver"])
    batches = [_rank_rows(_mp_batch(2, i, TRAIN_BATCH, 227, 1000), rank, world)
               for i in range(ALEXNET_LOCAL_ITERS)]
    test = _rank_rows(_mp_batch(3, 0, TEST_BATCH, 227, 1000), rank, world)
    reduce_ms = []
    _timed_reduce(solver, reduce_ms)
    torch.cuda.synchronize()
    lrn_rows.launches = lrn_rows_train.launches = lrn_rows_bwd.launches = 0
    losses = [float(solver.step(iter(batches[i:i + 2]), 2)["loss"])
              for i in range(0, ALEXNET_LOCAL_ITERS, 2)]
    tested = solver.test(iter([test]), 1)
    torch.cuda.synchronize()
    counts = [lrn_rows.launches, lrn_rows_train.launches, lrn_rows_bwd.launches]
    torch.save({l: {k: t.cpu() for k, t in e.items()} for l, e in solver.params.items()},
               os.path.join(tmp, f"{job['name']}_params.r{rank}.pt"))
    res = {"losses": losses, "test": tested, "launches": counts, "reduce_ms": reduce_ms,
           "hash": _params_hash(solver.params),
           "reduce_bytes": sum(x.numel() * x.element_size() for e in solver.params.values()
                               for x in e.values())}
    del solver
    torch.cuda.empty_cache()
    return res


def _rank_nccl1(job, rank, world, tmp):
    import torch
    import torch.distributed as dist

    t = torch.arange(4, dtype=torch.float32, device="cuda") + 1
    dist.all_reduce(t)
    torch.cuda.synchronize()
    return {"backend": dist.get_backend(), "sum": t.tolist()}


def _profile_idle(fn):
    """``fn()`` under ``torch.profiler``: the card's busy ms, the wall ms
    and the kernel launches (busy None when no device time was seen)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and not _annotation(e)]
    busy = sum(getattr(e, "self_device_time_total", None)
               or getattr(e, "self_cuda_time_total", 0.0) for e in kernels) / 1e3
    return {"busy_ms": busy or None, "wall_ms": wall,
            "launches": sum(e.count for e in kernels)}


def _cifar_rounds(solver, feed, rank, world):
    """One warm round, LOCAL_ROUNDS - 1 timed rounds (host clock,
    synchronized; the average timed apart), one profiled round."""
    import torch

    def next_rows():
        return [_rank_rows(next(feed), rank, world) for _ in range(LOCAL_TAU)]

    first = float(solver.step(iter(next_rows()), LOCAL_TAU)["loss"])
    reduce_ms, round_ms = [], []
    _timed_reduce(solver, reduce_ms)
    for _ in range(LOCAL_ROUNDS - 1):
        rows = next_rows()
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = solver.step(iter(rows), LOCAL_TAU)
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t) * 1e3)
    rows = next_rows()
    prof = _profile_idle(lambda: solver.step(iter(rows), LOCAL_TAU))
    return {"first_loss": first, "last_loss": float(m["loss"]),
            "round_ms": statistics.median(round_ms),
            "reduce_ms": statistics.median(reduce_ms[:len(round_ms)]), "profile": prof}


def _rank_cifar_local(job, rank, world, tmp):
    """cifar10_quick ``--parallel local``, tau LOCAL_TAU, LOCAL_ROUNDS
    rounds for each wire format, one worker a process."""
    out = {}
    for compress in ("none", "bf16", "int8"):
        solver = _cifar_parallel(None, "local", LOCAL_TAU, compress)
        out[compress] = _cifar_rounds(solver, _cifar_feed(), rank, world)
    return out


RANK_JOBS = {"probe": _rank_probe, "resnet_sync": _rank_resnet_sync,
             "alexnet_local": _rank_alexnet_local, "nccl1": _rank_nccl1,
             "cifar_local": _rank_cifar_local}


def _load_ranks(tmp, name, what, world):
    import torch

    return [torch.load(os.path.join(tmp, f"{name}_{what}.r{r}.pt")) for r in range(world)]


def _mp_references(tmp):
    """The one-process runs the multiprocess ones are held against, on
    cuda:0: ResNet-50 on one Solver over the whole global batch of 32
    (global BatchNorm statistics are one device's on the whole batch),
    and alexnet-local's 2-worker solver over the same global batches."""
    import torch

    one = _mp_resnet_solver(parallel="none")
    losses = []
    for i in range(MP_RESNET_STEPS):
        losses.append(float(one.step(iter([_mp_batch(1, i, MP_RESNET_BATCH, 224, 1000)]),
                                     1)["loss/loss"]))
        if i == 0:
            state1 = {l: {k: t.cpu() for k, t in e.items()} for l, e in one.state.items()}
    resnet = {"losses": losses, "state1": state1,
              "params": {l: {k: t.cpu() for k, t in e.items()} for l, e in one.params.items()}}
    del one
    alex = _mp_alexnet_solver(_alexnet_local_solver(tmp), workers=["cuda:0"] * 2)
    batches = [_mp_batch(2, i, TRAIN_BATCH, 227, 1000) for i in range(ALEXNET_LOCAL_ITERS)]
    a_losses = [float(alex.step(iter(batches[i:i + 2]), 2)["loss"])
                for i in range(0, ALEXNET_LOCAL_ITERS, 2)]
    tested = alex.test(iter([_mp_batch(3, 0, TEST_BATCH, 227, 1000)]), 1)
    alexnet = {"losses": a_losses, "test": tested,
               "params": {l: {k: t.cpu() for k, t in e.items()}
                          for l, e in alex.params.items()}}
    del alex
    torch.cuda.empty_cache()
    return resnet, alexnet


def _mp_check(label, results, tmp, world, ref_resnet, ref_alexnet):
    """The ResNet-50 sync and AlexNet local runs of ``world`` ranks held
    against their one-process references; returns the LRN launches of
    every rank, summed."""
    from sparknet_tpu_torch.parallel import comm

    rs = [r[f"resnet_{label}"] for r in results]
    al = [r[f"alexnet_{label}"] for r in results]
    if len({r["hash"] for r in rs}) != 1 or len({r["hash"] for r in al}) != 1:
        raise AssertionError(f"{label}: the ranks' weights differ: "
                             f"{[r['hash'][:12] for r in rs + al]}")
    loss1 = abs(rs[0]["losses"][0] - ref_resnet["losses"][0]) / abs(ref_resnet["losses"][0])
    state1 = _load_ranks(tmp, f"resnet_{label}", "state1", world)[0]
    state_err = max(_rel(state1[l][k], t) for l, e in ref_resnet["state1"].items()
                    for k, t in e.items())
    params = _load_ranks(tmp, f"resnet_{label}", "params", world)[0]
    w_err, w_at = _worst_tensor(params, ref_resnet["params"])
    log(f"  {label}: ResNet-50 sync over {world} ranks ({MP_RESNET_BATCH // world} rows "
        f"each; workers {[r['workers'] for r in rs]}) vs one Solver on the batch of "
        f"{MP_RESNET_BATCH}: step-1 loss {loss1:.2e}, step-1 BatchNorm state worst "
        f"{state_err:.2e} relative L2 [<= {LOCAL_STEP_TOL:g}]; weights after "
        f"{MP_RESNET_STEPS} steps worst {w_err:.2e} ({w_at}) [<= {LOCAL_CARD_TOL:g}]; "
        f"losses "
        f"{[round(x, 5) for x in rs[0]['losses']]} vs "
        f"{[round(x, 5) for x in ref_resnet['losses']]}; the ranks' weights identical "
        f"by hash")
    if loss1 > LOCAL_STEP_TOL or state_err > LOCAL_STEP_TOL or w_err > LOCAL_CARD_TOL:
        raise AssertionError(f"{label}: ResNet-50 sync: loss {loss1}, state {state_err}, "
                             f"weights {w_err}")
    params = _load_ranks(tmp, f"alexnet_{label}", "params", world)[0]
    a_err, a_at = _worst_tensor(params, ref_alexnet["params"])
    a_loss = abs(al[0]["losses"][0] - ref_alexnet["losses"][0]) / abs(
        ref_alexnet["losses"][0])
    counts = [sum(r["launches"][i] for r in al) for i in range(3)]
    want = [2, 2 * ALEXNET_LOCAL_ITERS, 2 * ALEXNET_LOCAL_ITERS]
    mb = al[0]["reduce_bytes"] / 1e6
    log(f"  {label}: AlexNet local tau 2 over {world} ranks ({TRAIN_BATCH // world} rows "
        f"each) vs alexnet-local's one-process 2-worker solver on the same batches: "
        f"first round's loss {a_loss:.2e} [<= {LOCAL_STEP_TOL:g}], weights after "
        f"{ALEXNET_LOCAL_ITERS} iterations worst {a_err:.2e} relative L2 ({a_at}) "
        f"[<= {LOCAL_CARD_TOL:g}]; test {al[0]['test']} vs {ref_alexnet['test']}")
    log(f"  {label}: the average of {mb:.1f} MB of f32 weights a round: "
        f"{[[round(x, 3) for x in r['reduce_ms']] for r in al]} ms (each rank's rounds, "
        f"host clock, synchronized, after a barrier)")
    log(f"  {label}: LRN launches per rank (inference, training forward, backward): "
        f"{[r['launches'] for r in al]} (want {want} each: 2 per worker step, 2 per test "
        f"batch)")
    if a_loss > LOCAL_STEP_TOL or a_err > LOCAL_CARD_TOL:
        raise AssertionError(f"{label}: AlexNet local: loss {a_loss}, weights {a_err}")
    if any(r["launches"] != want for r in al):
        raise AssertionError(f"{label}: LRN launches {[r['launches'] for r in al]}")
    return counts


def _mp_one_process_bn(label, results, tmp, workers):
    """ResNet-50 sync over ``workers`` in one process on the monolithic
    path (each BatchNorm over the global batch: one forward over the
    rows of workers that share a card, lock-step threads across cards),
    one step on the global batch, against the same step over the
    processes of ``results``: the loss and the BatchNorm state."""
    import torch

    solver = _mp_resnet_solver(workers=workers)
    loss = float(solver.step(iter([_mp_batch(1, 0, MP_RESNET_BATCH, 224, 1000)]),
                             1)["loss/loss"])
    ranks = _load_ranks(tmp, f"resnet_{label}", "state1", len(results))[0]
    state_err = max(_rel(solver.state[l][k].cpu(), t) for l, e in ranks.items()
                    for k, t in e.items())
    want = results[0][f"resnet_{label}"]["losses"][0]
    loss_err = abs(loss - want) / abs(want)
    log(f"  {label}: ResNet-50 sync over {len(workers)} workers in one process "
        f"({workers}, global BatchNorm) vs the {len(results)} processes' step: loss "
        f"{loss_err:.2e}, BatchNorm state worst {state_err:.2e} relative L2 "
        f"[<= {LOCAL_STEP_TOL:g}]")
    del solver
    torch.cuda.empty_cache()
    if loss_err > LOCAL_STEP_TOL or state_err > LOCAL_STEP_TOL:
        raise AssertionError(f"{label}: one-process global BatchNorm: loss {loss_err}, "
                             f"state {state_err}")


def _worst_tensor(got, want):
    """The largest relative L2 error over the tensors of two param trees,
    and its tensor's name."""
    errs = {f"{l}.{k}": _rel(got[l][k], t) for l, e in want.items() for k, t in e.items()}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def _mp_jobs(label, tmp):
    return [{"kind": "resnet_sync", "name": f"resnet_{label}"},
            {"kind": "alexnet_local", "name": f"alexnet_{label}",
             "solver": _alexnet_local_solver(tmp)}]


def phase_multiprocess(tmp):
    """SparkNet across processes: 2 ranks on cuda:0 over gloo (the
    one-card rehearsal), one NCCL rank; with two or more cards, the same
    runs over NCCL one process a card, cifar10_quick's rounds over 4 (or
    every) cards against the one-process solver over the same cards, and
    CifarApp launched as 2 processes."""
    import torch

    log(f"  card: {_smi()}")
    counts = torch.cuda.device_count()
    ref_resnet, ref_alexnet = _mp_references(tmp)
    # the one NCCL rank's launch goes beside the two gloo ranks'
    nccl = {}

    def run_nccl1():
        try:
            nccl["res"] = _launch_ranks([{"kind": "nccl1", "name": "nccl1"}], 1, tmp, "nccl")[0]
        except BaseException as e:  # raised again below, after the join
            nccl["error"] = e

    import threading

    thread = threading.Thread(target=run_nccl1, name="nccl1")
    thread.start()
    try:
        results, _ = _launch_ranks([{"kind": "probe", "name": "probe"}]
                                   + _mp_jobs("gloo", tmp), 2, tmp, "gloo")
    finally:
        thread.join(MP_TIMEOUT)
    if "error" in nccl:
        raise nccl["error"]
    log(f"  gloo on card tensors (2 ranks on cuda:0): {results[0]['probe']}")
    if any(v != "ok" for v in results[0]["probe"].values()):
        raise AssertionError(f"gloo on card tensors: {results[0]['probe']}")
    launches = _mp_check("gloo", results, tmp, 2, ref_resnet, ref_alexnet)
    _mp_one_process_bn("gloo", results, tmp, ["cuda:0"] * 2)
    nccl1 = nccl["res"]
    log(f"  NCCL at world size 1: {nccl1[0]['nccl1']}")
    if nccl1[0]["nccl1"]["sum"] != [1.0, 2.0, 3.0, 4.0]:
        raise AssertionError(f"NCCL world 1: {nccl1[0]}")
    out = {"launches": launches}
    if counts < 2:
        log(f"  NCCL across cards: not run: {counts} card visible, and NCCL needs one "
            f"card a rank (run on a host with two or more cards)")
        return out
    for label, cmd in (("cards", ["--query-gpu=name,power.limit", "--format=csv,noheader"]),
                       ("topo -m", ["topo", "-m"]), ("nvlink", ["nvlink", "--status"])):
        p = subprocess.run(["nvidia-smi"] + cmd, capture_output=True, text=True, timeout=60)
        for line in (p.stdout + p.stderr).splitlines()[:24]:
            log(f"  {label} | {line}")
    # NCCL names the transport of each of its channels ("via P2P/...",
    # "NVLS"): the link the collectives took
    results, texts = _launch_ranks(_mp_jobs("nccl", tmp), 2, tmp, "nccl",
                                   env={"NCCL_DEBUG": "INFO"})
    links = sorted({m.group(0) for m in re.finditer(r"via \S+|NVLS\b[^\n]{0,40}", texts[0])})
    log(f"  NCCL transports (rank 0's log, NCCL_DEBUG=INFO): {links[:8]}")
    nccl = _mp_check("nccl", results, tmp, 2, ref_resnet, ref_alexnet)
    _mp_one_process_bn("nccl", results, tmp, ["cuda:0", "cuda:1"])
    out["launches"] = [a + b for a, b in zip(launches, nccl)]
    world = min(counts, LOCAL_WORKERS)
    results, _ = _launch_ranks([{"kind": "cifar_local", "name": "cifar"}], world, tmp,
                               "nccl")
    one = {c: _cifar_rounds(_cifar_parallel([torch.device("cuda", i) for i in range(world)],
                                            "local", LOCAL_TAU, c), _cifar_feed(), 0, 1)
           for c in ("none", "bf16", "int8")}
    for c in ("none", "bf16", "int8"):
        ranks = [r["cifar"][c] for r in results]
        idle = [None if r["profile"]["busy_ms"] is None else
                round(100 * (1 - r["profile"]["busy_ms"] / r["profile"]["wall_ms"]), 1)
                for r in ranks]
        r0 = ranks[0]
        log(f"  cifar10_quick local tau {LOCAL_TAU}, {c}: {world} NCCL ranks (25 rows "
            f"each): round {[round(r['round_ms'], 3) for r in ranks]} ms, average "
            f"{[round(r['reduce_ms'], 3) for r in ranks]} ms "
            f"({100 * r0['reduce_ms'] / r0['round_ms']:.1f}% on rank 0), each card idle "
            f"{idle}% over one profiled round; one process over the same {world} cards: "
            f"round {one[c]['round_ms']:.3f} ms, average {one[c]['reduce_ms']:.3f} ms "
            f"({100 * one[c]['reduce_ms'] / one[c]['round_ms']:.1f}%); round loss "
            f"{r0['first_loss']:.4f} -> {r0['last_loss']:.3e} (one process "
            f"{one[c]['first_loss']:.4f} -> {one[c]['last_loss']:.3e})")
        if not all(r["last_loss"] < 0.5 * r["first_loss"] for r in ranks + [one[c]]):
            raise AssertionError(f"cifar local {c}: the round loss did not fall")
        out[f"cifar_{c}"] = {"ranks": ranks, "one_process": one[c]}
    _mp_cifar_app(tmp)
    return out


def _mp_cifar_app(tmp):
    """CifarApp ``--parallel local`` as 2 processes through the launch
    variables over NCCL: one voice, one snapshot, which restores a
    one-process solver."""
    from sparknet_tpu_torch.models import CIFAR_QUICK_TRAIN_TEST
    from sparknet_tpu_torch.parallel import ParallelSolver
    from sparknet_tpu_torch.proto import caffe_pb

    solver = os.path.join(tmp, "mp_cifar_solver.prototxt")
    with open(solver, "w") as f:
        f.write(f'net: "{CIFAR_QUICK_TRAIN_TEST}"\ntest_iter: 2\ntest_interval: 40\n'
                'base_lr: 0.001\nlr_policy: "fixed"\nmomentum: 0.9\nweight_decay: 0.004\n'
                f'display: 10\nmax_iter: 40\nsnapshot: 40\n'
                f'snapshot_prefix: "{os.path.join(tmp, "mp_cifar")}"\n')
    _, texts = _launch_ranks(None, 2, tmp, "nccl", cmd=[
        sys.executable, "-m", "sparknet_tpu_torch.apps.cifar_app", "--solver", solver,
        "--synthetic", "--synthetic-n", "2000", "--parallel", "local", "--tau", "10"])
    lines = [len(re.findall(r"Iteration \d+, loss", t)) for t in texts]
    log(f"  CifarApp --parallel local as 2 NCCL processes: Iteration lines by rank {lines}")
    for line in texts[0].splitlines():
        if re.search(r"Iteration|speed:|comm:|Snapshotting|Optimization", line):
            log(f"  | {line}")
    path = os.path.join(tmp, "mp_cifar_iter_40.solverstate.npz")
    one = ParallelSolver(caffe_pb.load_solver(solver),
                         {"data": (100, 32, 32, 3), "label": (100,)},
                         workers=["cuda:0"] * 2, mode="local", tau=10)
    one.restore(path)
    log(f"  its snapshot restores a one-process 2-worker solver at iteration {one.iter}")
    if lines[0] != 4 or lines[1] != 0 or one.iter != 40:
        raise AssertionError(f"CifarApp over processes: lines {lines}, iter {one.iter}")


# ------------------------------------------------------ bert-processes
def _bp_solver(parallel, dropout=True, workers=None):
    """BertApp's ``build`` for ``--config base`` at 32 x 128 with
    ``--parallel`` (``--tau 2`` for local), f32, its feed dropped (over
    processes its host-sharded feed; the held runs feed
    ``_bp_batches``'s rows instead); dropout off when asked (the model's
    own rates, read at every step)."""
    from sparknet_tpu_torch.apps import bert_app

    args = bert_app.make_args(config="base", seq_len=BERT_SEQ, batch_size=BERT_BATCH,
                              max_iter=1000, device="cuda", parallel=parallel, tau="2")
    solver = bert_app.build(args, workers=workers)[0]
    if not dropout:
        solver.train_net.cfg.hidden_dropout = solver.train_net.cfg.attention_dropout = 0.0
    return solver


def _bp_batches(tmp):
    """BP_ITERS global batches of BertApp's one-process feed (32 x 128 on
    its synthetic corpus), in ``bp_batches.npz`` for the ranks."""
    import numpy as np

    from sparknet_tpu_torch.apps import bert_app

    args = bert_app.make_args(config="base", seq_len=BERT_SEQ, batch_size=BERT_BATCH,
                              device="cuda")
    _, feed, _ = bert_app.build(args)
    batches = [next(feed) for _ in range(BP_ITERS)]
    np.savez(os.path.join(tmp, "bp_batches.npz"),
             **{f"{i}/{k}": v for i, b in enumerate(batches) for k, v in b.items()})
    return batches


def _bp_load(tmp):
    import numpy as np

    with np.load(os.path.join(tmp, "bp_batches.npz")) as z:
        out = [{} for _ in range(BP_ITERS)]
        for key in z.files:
            i, k = key.split("/")
            out[int(i)][k] = z[key]
    return out


def _cpu_params(solver):
    return {l: {k: t.detach().cpu() for k, t in e.items()} for l, e in solver.params.items()}


def _bp_references(tmp):
    """On cuda:0 in this process: one Solver on each whole global batch
    (dropout off) for BP_SYNC_STEPS steps, and the one-process 2-worker
    ``ParallelSolver`` local tau 2 (dropout on: its workers' generators
    are seeded as the ranks') for BP_LOCAL_ITERS iterations."""
    import torch

    batches = _bp_batches(tmp)
    one = _bp_solver("none", dropout=False)
    sync = [float(one.step(iter([b]), 1)["loss"]) for b in batches[:BP_SYNC_STEPS]]
    ref = {"sync": {"losses": sync, "params": _cpu_params(one)}}
    del one
    two = _bp_solver("local", workers=["cuda:0"] * 2)
    local = [float(two.step(iter(batches[i:i + 2]), 2)["loss"])
             for i in range(0, BP_LOCAL_ITERS, 2)]
    ref["local"] = {"losses": local, "params": _cpu_params(two)}
    del two
    torch.cuda.empty_cache()
    return ref


def _timed_ms(fn, solver, n):
    """ms a call of ``fn`` over ``n`` calls, host clock, after a barrier
    of the solver's group, synchronized."""
    import torch
    import torch.distributed as dist

    dist.barrier(group=solver.group)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / n


def _sync_timing(solver, rows):
    """A sync solver over processes stepped on ``rows`` BP_TIMED times a
    run, three ways: each bucket started inside the backward (the
    default), the same buckets started after the backward, and one
    all-reduce a leaf after it; in the order A B C C B A, each way's
    mean over its two runs. Then each reduction alone on a
    gradient-shaped tree. Returns ms each; the bucketed reduction's
    share of the step that starts its buckets after the backward; the
    share of the bucketed reduction the overlap hid (the two steps'
    difference over the reduction alone)."""
    import itertools

    import torch
    import torch.distributed as dist

    from sparknet_tpu_torch.parallel import comm, data_parallel, make_dp_train_step

    feed = itertools.repeat(rows)
    cfg = solver.comm
    data_parallel._REDUCE_IN_BACKWARD = False
    try:
        after = make_dp_train_step(solver._nets, solver.sp, cfg, solver.group)
    finally:
        data_parallel._REDUCE_IN_BACKWARD = True
    steps = {"overlap": solver._train_step,
             "after": (lambda p, s, o, b, it, _rng:
                       after(p, s, o, b, it, solver._worker_generators(it)))}
    steps["leaf"] = steps["after"]
    bucketed = comm.reduce_bucketed

    def per_leaf(trees, config, residual=None, group=None):
        return comm.reduce_per_leaf(trees, group), residual

    runs = {k: [] for k in steps}
    for way in ("overlap", "after", "leaf", "leaf", "after", "overlap"):
        solver._train_step = steps[way]
        comm.reduce_bucketed = per_leaf if way == "leaf" else bucketed
        try:
            runs[way].append(_timed_ms(lambda: solver.step(feed, 1), solver, BP_TIMED))
        finally:
            comm.reduce_bucketed = bucketed
    solver._train_step = steps["overlap"]
    out = {f"{k}_ms": sum(v) / len(v) for k, v in runs.items()}
    out["runs"] = runs
    grads = comm.tree_map(torch.ones_like, solver.params)
    leaves = comm.tree_leaves(grads)
    plan = comm.plan_buckets(leaves, cfg.bucket_bytes)

    def buckets():
        works = [dist.all_reduce(torch.cat([leaves[i].reshape(-1) for i in b]),
                                 group=solver.group, async_op=True) for b in plan]
        for w in works:
            w.wait()

    out["bucketed_reduce_ms"] = _timed_ms(buckets, solver, BP_TIMED)
    out["leaf_reduce_ms"] = _timed_ms(lambda: comm.reduce_per_leaf([grads], solver.group),
                                      solver, BP_TIMED)
    out["buckets"] = len(plan)
    out["reduce_share"] = out["bucketed_reduce_ms"] / out["after_ms"]
    out["hidden"] = (out["after_ms"] - out["overlap_ms"]) / out["bucketed_reduce_ms"]
    return out


def _timing_line(t):
    """``_sync_timing``'s numbers, one line's worth."""
    runs = {k: ", ".join(f"{x:.3f}" for x in v) for k, v in t["runs"].items()}
    return (f"buckets started inside the backward {t['overlap_ms']:.3f} ({runs['overlap']}), "
            f"after it {t['after_ms']:.3f} ({runs['after']}), one all-reduce a leaf after it "
            f"{t['leaf_ms']:.3f} ({runs['leaf']}); the "
            f"reduction alone: {t['buckets']} buckets {t['bucketed_reduce_ms']:.3f}, one a "
            f"leaf {t['leaf_reduce_ms']:.3f} (the buckets {100 * t['reduce_share']:.1f}% of "
            f"the step that starts them after the backward); the overlap hid "
            f"{100 * t['hidden']:.1f}% of the bucketed reduction")


def _rank_bert(job, rank, world, tmp):
    """BERT-base over the processes, f32: ``--parallel sync`` (dropout off)
    BP_SYNC_STEPS steps then its timings with the overlap on and off, and
    ``--parallel local --tau 2`` BP_LOCAL_ITERS iterations, each on this
    rank's rows of ``_bp_batches``'s global batches; the flash kernels'
    launches counted from 0 around all of it."""
    import torch

    from sparknet_tpu_torch.ops import attention as TA

    wrappers = (TA.flash_fwd, TA.flash_bwd_dq, TA.flash_bwd_dkv)
    batches = [_rank_rows(b, rank, world) for b in _bp_load(tmp)]
    for fn in wrappers:
        fn.launches = 0
    res = {}
    solver = _bp_solver("sync", dropout=False)
    res["sync_losses"] = [float(solver.step(iter([b]), 1)["loss"])
                          for b in batches[:BP_SYNC_STEPS]]
    res["sync_hash"] = _params_hash(solver.params)
    torch.save(_cpu_params(solver), os.path.join(tmp, f"{job['name']}_sync.r{rank}.pt"))
    res["comm"] = solver.comm_report()["overlap"]
    res["timing"] = _sync_timing(solver, solver._put_batch(batches[0]))
    del solver
    solver = _bp_solver("local")
    res["local_losses"] = [float(solver.step(iter(batches[i:i + 2]), 2)["loss"])
                           for i in range(0, BP_LOCAL_ITERS, 2)]
    res["local_hash"] = _params_hash(solver.params)
    torch.save(_cpu_params(solver), os.path.join(tmp, f"{job['name']}_local.r{rank}.pt"))
    torch.cuda.synchronize()
    res["launches"] = [fn.launches for fn in wrappers]
    del solver
    torch.cuda.empty_cache()
    return res


def _rank_resnet_timing(job, rank, world, tmp):
    """ResNet-50 ``--parallel sync`` at the global batch of 32: the step
    with the overlap on and off (``_sync_timing``)."""
    import torch

    solver = _mp_resnet_solver()
    rows = solver._put_batch(_rank_rows(_mp_batch(1, 0, MP_RESNET_BATCH, 224, 1000), rank,
                                        world))
    solver.step(iter([rows]), 1)  # warm
    out = _sync_timing(solver, rows)
    del solver
    torch.cuda.empty_cache()
    return out


def _rank_tau_auto(job, rank, world, tmp):
    """cifar10_quick ``--parallel local --tau auto`` at batch 100, one
    worker a process, TAU_AUTO_ROUNDS rounds: the τ of every round."""
    solver = _cifar_parallel(None, "local", "auto")
    feed = _cifar_feed()
    taus = []
    for _ in range(TAU_AUTO_ROUNDS):
        tau = solver.tau
        solver.step(iter([_rank_rows(next(feed), rank, world) for _ in range(tau)]), tau)
        taus.append(tau)
    taus.append(solver.tau)
    print(f"rank {rank}: tau by round {taus}", flush=True)
    return {"taus": taus, "iter": solver.iter,
            "decisions": solver.tau_controller.snapshot()["widened"] if rank == 0 else None}


RANK_JOBS.update(bert=_rank_bert, resnet_timing=_rank_resnet_timing, tau_auto=_rank_tau_auto)


def _bp_check(label, results, tmp, world, ref):
    """Each rank's BERT runs held against the one-process references;
    returns every rank's flash launches, summed."""
    rs = [r["bert"] for r in results]
    for mode in ("sync", "local"):
        if len({r[f"{mode}_hash"] for r in rs}) != 1:
            raise AssertionError(f"{label}: BERT {mode}: the ranks' weights differ")
        got = _load_ranks(tmp, "bert", mode, world)[0]
        want = ref[mode]["params"]
        # the key biases' gradient is 0 but for rounding (the softmax cancels
        # a shift of a query's logits): no relative error to hold; Adam
        # moves them by noise, held below 1e-6 on both sides instead
        k_b = max(float(t[l]["k_b"].abs().max()) for t in (got, want) for l in want
                  if "k_b" in want[l])
        err, at = _worst_tensor(got, {l: {k: t for k, t in e.items() if k != "k_b"}
                                      for l, e in want.items()})
        loss = abs(rs[0][f"{mode}_losses"][0] - ref[mode]["losses"][0]) / abs(
            ref[mode]["losses"][0])
        what = ("one Solver on each batch of 32, dropout off" if mode == "sync" else
                "the one-process 2-worker ParallelSolver, the same dropout seeds")
        log(f"  {label}: BERT-base {mode} over {world} ranks ({BERT_BATCH // world} rows "
            f"each) vs {what}: first loss {loss:.2e} [<= {LOCAL_STEP_TOL:g}]; weights "
            f"after {len(rs[0][f'{mode}_losses']) * (1 if mode == 'sync' else 2)} "
            f"iterations worst {err:.2e} relative L2 ({at}) [<= {LOCAL_CARD_TOL:g}]; "
            f"losses {[round(x, 5) for x in rs[0][f'{mode}_losses']]} vs "
            f"{[round(x, 5) for x in ref[mode]['losses']]}; the key biases at most "
            f"{k_b:.2e} [< 1e-6]; the ranks' weights identical by hash")
        if loss > LOCAL_STEP_TOL or err > LOCAL_CARD_TOL or k_b >= 1e-6:
            raise AssertionError(f"{label}: BERT {mode}: loss {loss}, weights {err}, "
                                 f"key biases {k_b}")
    t = rs[0]["timing"]
    log(f"  {label}: BERT-base sync, ms a step (host clock, synchronized, after a "
        f"barrier; rank 0): {_timing_line(t)}; comm overlap {rs[0]['comm']}")
    want = [BERT_LAYERS * (BP_SYNC_STEPS + 6 * BP_TIMED + BP_LOCAL_ITERS)] * 3
    log(f"  {label}: flash launches per rank (forward, dq, dk/dv): "
        f"{[r['launches'] for r in rs]} (want {want} each: {BERT_LAYERS} per iteration)")
    if any(r["launches"] != want for r in rs) or not rs[0]["comm"]:
        raise AssertionError(f"{label}: flash launches {[r['launches'] for r in rs]}, "
                             f"overlap {rs[0]['comm']}")
    return [sum(r["launches"][i] for r in rs) for i in range(3)]


def phase_bert_processes(tmp):
    """BERT-base over processes: BertApp's solver with ``--parallel sync``
    and ``--parallel local --tau 2`` as 2 ranks on cuda:0 over gloo
    against its one-process references, the flash kernels launched in
    every rank; cifar10_quick ``--tau auto`` over 2 ranks; with two or
    more cards the BERT runs over NCCL, one process a card, and
    ResNet-50's sync step with the overlap on and off."""
    import torch

    log(f"  card: {_smi()}")
    ref = _bp_references(tmp)
    # one launch for both jobs: the ranks start and join once
    results, _ = _launch_ranks([{"kind": "bert", "name": "bert"},
                                {"kind": "tau_auto", "name": "tau"}], 2, tmp, "gloo")
    launches = _bp_check("gloo", results, tmp, 2, ref)
    taus = [r["tau"]["taus"] for r in results]
    log(f"  cifar10_quick --tau auto over 2 ranks (gloo, cuda:0), {TAU_AUTO_ROUNDS} "
        f"rounds: tau by round {taus[0]}; rank 1's the same: {taus[0] == taus[1]}; "
        f"iterations {[r['tau']['iter'] for r in results]}; widened "
        f"{results[0]['tau']['decisions']} times")
    if taus[0] != taus[1] or len(taus[0]) != TAU_AUTO_ROUNDS + 1:
        raise AssertionError(f"tau auto over processes: {taus}")
    counts = torch.cuda.device_count()
    if counts < 2:
        log(f"  NCCL across cards: not run: {counts} card visible, and NCCL needs one "
            f"card a rank (run on a host with two or more cards)")
        return dict(zip(FLASH_NAMES, launches))
    results, _ = _launch_ranks([{"kind": "bert", "name": "bert"},
                                {"kind": "resnet_timing", "name": "resnet"}], 2, tmp, "nccl")
    launches = [a + b for a, b in zip(launches, _bp_check("nccl", results, tmp, 2, ref))]
    t = results[0]["resnet"]
    log(f"  nccl: ResNet-50 sync at the global batch of {MP_RESNET_BATCH} over 2 cards, ms "
        f"a step (rank 0): {_timing_line(t)}")
    return dict(zip(FLASH_NAMES, launches))


# ---------------------------------------------------------------- feed
def _feed_solver_file(tmp: str) -> str:
    """The zoo's rate and schedule; a test batch every FEED_CHUNK
    iterations, which ends a chunk and its ``speed:`` line."""
    from sparknet_tpu_torch.models import ALEXNET_TRAIN_VAL

    path = os.path.join(tmp, "alexnet_feed_solver.prototxt")
    with open(path, "w") as f:
        f.write(
            f'net: "{ALEXNET_TRAIN_VAL}"\n'
            f"test_iter: 1\ntest_interval: {FEED_CHUNK}\nbase_lr: 0.01\n"
            'lr_policy: "step"\ngamma: 0.1\nstepsize: 100000\n'
            f"display: {FEED_CHUNK}\nmax_iter: {FEED_ITERS}\nmomentum: 0.9\n"
            f'weight_decay: 0.0005\nsnapshot: 0\nsnapshot_prefix: "{tmp}/feed"\n'
        )
    return path


def _feed_parts():
    """The app's train set and train transformer (the serial feed's
    pieces), as ``imagenet_app.build`` makes them."""
    from sparknet_tpu_torch.apps.cifar_app import _data_layer, make_transformer
    from sparknet_tpu_torch.data.imagenet import BGR_MEAN, imagenet_dataset
    from sparknet_tpu_torch.models import ALEXNET_TRAIN_VAL
    from sparknet_tpu_torch.proto import caffe_pb

    net = caffe_pb.load_net(ALEXNET_TRAIN_VAL)
    tf = make_transformer(_data_layer(net, "TRAIN"), True,
                          os.path.dirname(ALEXNET_TRAIN_VAL), lambda: BGR_MEAN)
    return imagenet_dataset(None, train=True, synthetic_n=FEED_N), tf


def _df_shm():
    """``df -h /dev/shm``'s lines."""
    return subprocess.run(["df", "-h", "/dev/shm"], capture_output=True,
                          text=True).stdout.splitlines() or ["df: no output"]


# GPU clock cycles the staging check spins the side stream for before
# each upload (~0.5 s on an H100's ~1.98 GHz clock)
STAGE_SLEEP_CYCLES = 1_000_000_000


def _staged_readback(host, fault=None):
    """``host`` (a list of batch dicts) through ``prefetch_to_device(size
    =2)`` on the card, with the side stream slowed: each upload waits
    behind ~0.5 s of spinning on its stream, so the staging thread runs
    ahead of the copies by the whole ring. Each batch is copied back into
    pinned host memory on the consumer's stream at once, without waiting,
    and the copies are returned once the card is idle. A copy read before
    its upload completed, or a pinned buffer refilled before its upload
    left it, gives other bytes than ``host``.

    ``fault`` plants one of those two races to show the check sees it:
    ``"no-wait"`` makes ``Stream.wait_event`` a no-op (the consumer's
    stream does not wait on the upload's event); ``"early-refill"`` makes
    ``Event.synchronize`` a no-op (a ring slot is refilled without waiting
    for its last upload)."""
    import torch

    from sparknet_tpu_torch.data import prefetch

    orig_upload = prefetch.PinnedStager._upload

    def slow_upload(self, bufs):
        with torch.cuda.stream(self.stream):
            torch.cuda._sleep(STAGE_SLEEP_CYCLES)
        return orig_upload(self, bufs)

    patches = [(prefetch.PinnedStager, "_upload", slow_upload)]
    if fault == "no-wait":
        patches.append((torch.cuda.Stream, "wait_event", lambda self, event: None))
    elif fault == "early-refill":
        patches.append((torch.cuda.Event, "synchronize", lambda self: None))
    elif fault is not None:
        raise ValueError(fault)
    outs = [{k: torch.empty(v.shape, dtype=torch.from_numpy(v[:0]).dtype, pin_memory=True)
             for k, v in b.items()} for b in host]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        staged = prefetch.prefetch_to_device(iter(host), size=2, device="cuda")
        for out in outs:
            for k, v in next(staged).items():
                out[k].copy_(v, non_blocking=True)
        staged.close()
        torch.cuda.synchronize()
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    return outs


def _staging_checks(host):
    """The pinned side-stream staging held against ``host``, and each of
    its two races planted, each of which the same check must catch."""
    _held_batches("prefetch 2, pinned and side-stream (slowed), read back from the card",
                  _staged_readback(host), host)
    for fault in ("no-wait", "early-refill"):
        try:
            _held_batches(f"planted fault {fault}", _staged_readback(host, fault), host)
        except AssertionError as e:
            log(f"  planted fault {fault}: caught ({e})")
        else:
            raise AssertionError(f"the staging check missed the planted fault {fault}")


def _held_batches(label, got, want):
    """``got`` and ``want`` (lists of batch dicts) equal, bit for bit."""
    import numpy as np

    for i, (g, w) in enumerate(zip(got, want)):
        for k in w:
            gk = g[k].cpu().numpy() if hasattr(g[k], "cpu") else np.asarray(g[k])
            if gk.dtype != w[k].dtype or not np.array_equal(gk, w[k]):
                raise AssertionError(f"{label}: batch {i} {k} differs from the serial feed's")
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} batches, want {len(want)}")
    log(f"  {label}: the first {len(want)} batches equal the serial feed's, bit for bit")


def _feed_checks(tmp, packed):
    """The bit-for-bit checks of the feed paths against the serial feed
    (batches of 256 227x227 f32 crops), and the native loader's
    determinism."""
    import itertools

    import numpy as np
    import torch

    from sparknet_tpu_torch.apps.cifar_app import make_feed, make_native_feed
    from sparknet_tpu_torch.apps.imagenet_app import make_device_feed
    from sparknet_tpu_torch.data.prefetch import prefetch_to_device
    from sparknet_tpu_torch.data.records import packed_dataset

    ds, tf = _feed_parts()
    n = FEED_CHECK
    serial = list(itertools.islice(make_feed(ds, tf, TRAIN_BATCH, seed=0), n))
    workers = make_feed(ds, tf, TRAIN_BATCH, seed=0, workers=4)
    try:
        got = list(itertools.islice(workers, n))
        if workers.metrics.shm_fallbacks:
            raise AssertionError(f"{workers.metrics.shm_fallbacks} pickle fallbacks")
    finally:
        workers.close()
    _held_batches("4 worker processes", got, serial)
    _staging_checks(serial)
    fn = tf.device_fn()
    staged = prefetch_to_device(make_device_feed(ds, tf, TRAIN_BATCH, seed=0), size=2,
                                device="cuda")
    got = []
    for b in itertools.islice(staged, n):
        b = fn({k: torch.as_tensor(v) for k, v in b.items()})
        got.append({k: v.cpu() for k, v in b.items()})
    staged.close()
    _held_batches("device augmentation on the card (uint8 + plan uploaded)", got, serial)
    pds = packed_dataset(packed, train=True)
    it = make_feed(pds, tf, TRAIN_BATCH, seed=0)
    got = list(itertools.islice(it, n))
    it.close()
    _held_batches("packed records", got, serial)
    del serial, got
    loaders = [make_native_feed(ds, tf, TRAIN_BATCH, seed=0, required=True)
               for _ in range(2)]
    try:
        for i in range(n):
            a, b = next(loaders[0]), next(loaders[1])
            for k in a:
                if not np.array_equal(a[k], b[k]):
                    raise AssertionError(f"native loader: batch {i} {k} differs between "
                                         f"two constructions")
    finally:
        for ld in loaders:
            ld.close()
    log(f"  native loader: the first {n} batches of two constructions are identical "
        f"(its stream is the C++ loader's own, not the serial feed's)")
    torch.cuda.empty_cache()


def phase_feed(tmp, resident_ms):
    """ImageNetApp's AlexNet through each train feed path, images/s beside
    the resident step's; the Python paths' batches held bit for bit."""
    import io
    import math
    import re

    from sparknet_tpu_torch.apps import imagenet_app
    from sparknet_tpu_torch.data.cache import ShmBatchCache
    from sparknet_tpu_torch.ops.lrn import lrn_rows, lrn_rows_bwd, lrn_rows_train
    from sparknet_tpu_torch.tools import pack_records

    smi = _smi()
    cores = os.cpu_count() or 1
    log(f"  card: {smi}; nproc {cores}")
    for line in _df_shm():
        log(f"  df /dev/shm | {line}")
    packed = os.path.join(tmp, "packed")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        pack_records.main(["--source", "synthetic-imagenet", "--n", str(FEED_N), "--out",
                           packed])
    log(f"  packed by tools/pack_records.py in {time.perf_counter() - t0:.1f} s: "
        f"{buf.getvalue().strip()}")
    _feed_checks(tmp, packed)

    ns = f"chip-smoke-{os.getpid()}"
    py = ["--native-loader", "off"]
    paths = [
        ("serial, prefetch 0", py + ["--data-workers", "0", "--prefetch", "0"]),
        ("serial, prefetch 2", py + ["--data-workers", "0"]),
        ("4 workers", py + ["--data-workers", "4"]),
        (f"{cores - 1} workers (cores - 1)", py + ["--data-workers", str(cores - 1)]),
        ("native loader", ["--native-loader", "on"]),
        ("device augment", ["--device-augment", "--data-workers", "0"]),
        ("packed", py + ["--data-format", "packed", "--data-dir", packed,
                         "--data-workers", "0"]),
        ("packed + cache, cold", py + ["--data-format", "packed", "--data-dir", packed,
                                       "--data-workers", "0", "--data-cache", ns]),
        ("packed + cache, warm", py + ["--data-format", "packed", "--data-dir", packed,
                                       "--data-workers", "0", "--data-cache", ns]),
    ]
    resident = TRAIN_BATCH / resident_ms * 1e3 if resident_ms else None
    totals = [0, 0, 0]
    rows = []
    os.environ["SPARKNET_CACHE_MB"] = "4096"  # every batch of the run fits
    try:
        for label, extra in paths:
            argv = ["--arch", "alexnet", "--synthetic", "--synthetic-n", str(FEED_N),
                    "--solver", _feed_solver_file(tmp), "--device", "cuda", *extra]
            log(f"  [{label}] nproc {cores}; df /dev/shm: {_df_shm()[-1]}")
            lrn_rows.launches = lrn_rows_train.launches = lrn_rows_bwd.launches = 0
            with contextlib.redirect_stdout(io.StringIO()) as buf:
                imagenet_app.main(argv)
            counts = (lrn_rows.launches, lrn_rows_train.launches, lrn_rows_bwd.launches)
            out = buf.getvalue()
            chunks = FEED_ITERS // FEED_CHUNK
            want = (2 * (chunks + 1), 2 * FEED_ITERS, 2 * FEED_ITERS)  # a test a chunk
            if counts != want:
                raise AssertionError(f"{label}: LRN launches {counts}, want {want}")
            totals = [a + b for a, b in zip(totals, counts)]
            speeds = re.findall(r"speed: steps/s=\S+ images/s=(\d+)", out)
            losses = [float(v) for v in re.findall(r"Iteration \d+, loss = (\S+)", out)]
            if len(speeds) != chunks or not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"{label}: speed lines {speeds}, losses {losses}")
            pipe = cache = None
            for line in out.splitlines():
                if line.startswith("input pipeline: "):
                    pipe = json.loads(line[len("input pipeline: "):])
                elif line.startswith("data cache: "):
                    cache = json.loads(line[len("data cache: "):])
                elif line.startswith(("data loader:", "data pipeline:", "native loader:")):
                    log(f"  [{label}] {line}")
            if pipe is not None and pipe["shm_fallbacks"]:
                raise AssertionError(f"{label}: {pipe['shm_fallbacks']} pickle fallbacks")
            ips = int(speeds[-1])
            rows.append((label, [int(v) for v in speeds], pipe, cache))
            share = f" = {100 * ips / resident:.1f}% of the resident" if resident else ""
            log(f"  [{label}] {ips} images/s over iterations {FEED_ITERS - FEED_CHUNK}-"
                f"{FEED_ITERS} (speed: lines of the chunks {speeds}; the first chunk "
                f"starts the feed cold){share}; last loss {losses[-1]:.5f}; {smi}")
            if pipe is not None:
                log(f"  [{label}] input pipeline: {json.dumps(pipe)}")
                cw = pipe["consumer_wait"]
                pf = pipe["prefetch"]
                bound = "host-bound" if pf["misses"] > pf["hits"] else "device-bound"
                log(f"  [{label}] the step's wait for a staged batch: mean "
                    f"{pf['wait']['mean_ms']} ms, {pf['hits']} hits, {pf['misses']} misses "
                    f"({bound}); the staging thread's wait on the workers: mean "
                    f"{cw['mean_ms']} ms over {cw['count']} batches; pickle fallbacks "
                    f"{pipe['shm_fallbacks']}")
            if cache is not None:
                log(f"  [{label}] data cache: {json.dumps(cache)}")
    finally:
        os.environ.pop("SPARKNET_CACHE_MB", None)
        ShmBatchCache(ns).clear()
    warm = rows[-1][3]
    if not warm or warm["hits"] < FEED_ITERS:
        raise AssertionError(f"the warm cached run read {warm}: want every batch of its "
                             f"{FEED_ITERS} iterations a hit")
    res = f"{resident:.1f}" if resident else "not measured"
    log(f"  feed table, images/s by chunk of {FEED_CHUNK} iterations (resident step "
        f"{res} images/s, train-profile; {smi}):")
    for label, speeds, _, _ in rows:
        log(f"    {label:32s} {' '.join(f'{v:6d}' for v in speeds)}")
    log(f"  LRN launches in this phase: inference {totals[0]}, training forward "
        f"{totals[1]}, backward {totals[2]} ({len(paths)} runs)")
    return {"launches": tuple(totals), "images_per_s": {r[0]: r[1] for r in rows}}


# ---------------------------------------------------------- caffe-native
CN_TRAIN, CN_TEST = 1280, 256  # the LMDBs' Datums, 256x256x3 uint8
CN_ITERS, CN_SNAPSHOT, CN_KEEP = 12, 4, 2
CN_BUCKET = 32
CN_TIMEOUT = 300  # seconds a run of the app may take


def _cn_lmdb(path, n, seed):
    """An LMDB of ``n`` raw Datums of ``synthetic_imagenet`` (seed);
    -> (MB written, seconds)."""
    from sparknet_tpu_torch.data.caffe_layers import encode_datum
    from sparknet_tpu_torch.data.imagenet import synthetic_imagenet
    from sparknet_tpu_torch.data.lmdb_io import write_lmdb

    images, labels = synthetic_imagenet(n, seed=seed)
    t0 = time.perf_counter()
    write_lmdb(path + os.sep, [(f"{i:08d}".encode(), encode_datum(images[i], int(labels[i])))
                               for i in range(n)])
    dt = time.perf_counter() - t0
    return os.path.getsize(os.path.join(path, "data.mdb")) / 1e6, dt


def _cn_solver(tmp):
    """ImageNetApp's AlexNet train_val with its Data layers naming the two
    LMDBs, and a solver of CN_ITERS iterations, a snapshot every
    CN_SNAPSHOT, a test batch at 0 and at the end, a display each
    iteration; the prefix is relative, so each run's cwd holds its own."""
    from sparknet_tpu_torch.models import ALEXNET_TRAIN_VAL

    with open(ALEXNET_TRAIN_VAL) as f:
        text = f.read()
    for bs, name in ((256, "train_lmdb"), (50, "test_lmdb")):
        old = f"data_param {{ batch_size: {bs} }}"
        if text.count(old) != 1:
            raise AssertionError(f"train_val: {old!r} not found once")
        text = text.replace(old, f'data_param {{ source: "{os.path.join(tmp, name)}" '
                                 f"batch_size: {bs} backend: LMDB }}")
    net = os.path.join(tmp, "alexnet_lmdb_train_val.prototxt")
    with open(net, "w") as f:
        f.write(text)
    path = os.path.join(tmp, "alexnet_lmdb_solver.prototxt")
    with open(path, "w") as f:
        f.write(f'net: "{net}"\ntest_iter: 1\ntest_interval: {CN_ITERS}\nbase_lr: 0.01\n'
                'lr_policy: "step"\ngamma: 0.1\nstepsize: 100000\ndisplay: 1\n'
                f"max_iter: {CN_ITERS}\nmomentum: 0.9\nweight_decay: 0.0005\n"
                f'snapshot: {CN_SNAPSHOT}\nsnapshot_prefix: "snap/alexnet"\n')
    return path


def app_job(spec_path):
    """One run of ImageNetApp for the caffe-native phase (``--app-job``):
    started ahead, it imports and takes the card, then waits for its spec
    (the parent writes it when the run's inputs are ready) and runs
    ``main`` in the spec's directory: f32 without TF32, deterministic
    algorithms, the LRN launch counters from 0; ``Solver.save_or_skip``
    timed. Prints one ``app-job:`` JSON line (launches, save_or_skip ms,
    the chaos counters, the registry's ``snapshot_skipped`` and
    ``io_faults``) after ``main`` returns."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.zeros(1, device="cuda")  # the card's context, before the wait
    from sparknet_tpu_torch.apps import imagenet_app
    from sparknet_tpu_torch.ops.lrn import lrn_rows, lrn_rows_bwd, lrn_rows_train
    from sparknet_tpu_torch.solver.trainer import Solver

    deadline = time.monotonic() + CN_TIMEOUT
    while not os.path.exists(spec_path):
        if time.monotonic() > deadline:
            print(f"app-job: no spec {spec_path} in {CN_TIMEOUT} s", flush=True)
            return 3
        time.sleep(0.02)
    with open(spec_path) as f:
        spec = json.load(f)
    os.makedirs(spec["cwd"], exist_ok=True)
    os.chdir(spec["cwd"])
    saves = []
    save_or_skip = Solver.save_or_skip

    def timed(self, path, prefix=""):
        t0 = time.perf_counter()
        try:
            return save_or_skip(self, path, prefix)
        finally:
            saves.append((time.perf_counter() - t0) * 1e3)

    Solver.save_or_skip = timed
    lrn_rows.launches = lrn_rows_train.launches = lrn_rows_bwd.launches = 0
    with _deterministic():
        imagenet_app.main(spec["argv"])
    from sparknet_tpu_torch import chaos
    from sparknet_tpu_torch.telemetry.registry import REGISTRY

    metrics = REGISTRY.snapshot().get("metrics", {})
    print("app-job: " + json.dumps({
        "launches": [lrn_rows.launches, lrn_rows_train.launches, lrn_rows_bwd.launches],
        "save_or_skip_ms": saves, "chaos": chaos.METRICS.snapshot(),
        "snapshot_skipped": metrics.get("snapshot_skipped", {}),
        "io_faults": metrics.get("io_faults", {})}), flush=True)
    return 0


def _cn_start(tmp, name):
    """``chip_smoke.py --app-job`` (its own session, output to a file),
    waiting for its spec: -> (process, log file, log path, spec path)."""
    spec = os.path.join(tmp, f"{name}.json")
    env = dict(os.environ, PYTHONUNBUFFERED="1", SPARKNET_SNAPSHOT_KEEP=str(CN_KEEP),
               CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH"))
                                          if p))
    path = os.path.join(tmp, f"{name}.log")
    out = open(path, "w")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--app-job", spec],
                            cwd=tmp, env=env, stdout=out, stderr=subprocess.STDOUT,
                            start_new_session=True)
    return proc, out, path, spec


def _cn_go(run, cwd, argv):
    """Hand a started run its spec (written whole, then renamed): it runs
    ``main(argv)`` in ``cwd``. -> the monotonic time it went."""
    spec = run[3]
    with open(spec + ".part", "w") as f:
        json.dump({"argv": argv, "cwd": cwd}, f)
    os.replace(spec + ".part", spec)
    return time.monotonic()


def _cn_wait(runs, deadline):
    """Wait for each run; kill what is left at the deadline. -> {name:
    (exit code, output)}; a run's last lines are printed when it failed."""
    import signal

    res = {}
    for name, (proc, out, path, _) in runs.items():
        try:
            proc.wait(max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        out.close()
        with open(path) as f:
            res[name] = (proc.returncode, f.read())
        if proc.returncode:
            for line in res[name][1].splitlines()[-40:]:
                log(f"  {name} | {line}")
    return res


def _cn_job(name, text):
    lines = [l for l in text.splitlines() if l.startswith("app-job: ")]
    if len(lines) != 1:
        raise AssertionError(f"run {name}: no app-job line")
    return json.loads(lines[0][len("app-job: "):])


def _cn_equal(label, got, want, where=""):
    """Two solverstate trees equal bit for bit (arrays, and Python leaves)."""
    import numpy as np

    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{label}{where}: keys {sorted(got)} != {sorted(want)}")
        for k in want:
            _cn_equal(label, got[k], want[k], f"{where}/{k}")
    elif isinstance(want, np.ndarray):
        if got.dtype != want.dtype or got.shape != want.shape or not np.array_equal(
                got.view(np.uint8), want.view(np.uint8)):
            diff = float(np.max(np.abs(got.astype(np.float64) - want.astype(np.float64))))
            raise AssertionError(f"{label}{where}: not bit for bit (max|diff| {diff!r})")
    elif got != want:
        raise AssertionError(f"{label}{where}: {got!r} != {want!r}")


def _cn_without_packages(tmp):
    """With PIL and h5py made unimportable (whether or not this machine
    has them), each source that needs one raises naming it when its
    dataset is built."""
    import tarfile

    from sparknet_tpu_torch.data import caffe_layers, imagenet
    from sparknet_tpu_torch.data.lmdb_io import write_lmdb
    from sparknet_tpu_torch.proto import wire

    root = os.path.join(tmp, "nopkg")
    os.makedirs(os.path.join(root, "folders", "train", "n01440764"))
    with open(os.path.join(root, "folders", "train", "n01440764", "a.JPEG"), "wb") as f:
        f.write(b"\xff\xd8 not decoded")
    os.makedirs(os.path.join(root, "tars"))
    with tarfile.open(os.path.join(root, "tars", "s.tar"), "w") as tf:
        tf.add(os.path.join(root, "folders", "train", "n01440764", "a.JPEG"),
               "n01440764_0.JPEG")
    with open(os.path.join(root, "list.txt"), "w") as f:
        f.write("a.JPEG 0\n")
    with open(os.path.join(root, "h5.txt"), "w") as f:
        f.write("a.h5\n")
    enc = wire.encode_bytes_field(4, b"\xff\xd8 jpeg") + wire.encode_varint_field(7, 1)
    write_lmdb(os.path.join(root, "enc") + os.sep, [(b"%06d" % i, enc) for i in range(4)])
    have = {}
    for mod in ("PIL", "h5py"):
        try:
            __import__(mod)
            have[mod] = True
        except ImportError:
            have[mod] = False
    cases = (
        ("ImageData", "PIL", lambda: caffe_layers.image_data_dataset(
            os.path.join(root, "list.txt"), root)),
        ("encoded Datum LMDB", "PIL", lambda: caffe_layers.lmdb_dataset(
            os.path.join(root, "enc"))),
        ("ImageNet folders", "PIL", lambda: imagenet.imagenet_dataset(
            os.path.join(root, "folders"))),
        ("ImageNet tar shards", "PIL", lambda: imagenet.imagenet_dataset(
            os.path.join(root, "tars"))),
        ("HDF5Data", "h5py", lambda: caffe_layers.hdf5_dataset(os.path.join(root, "h5.txt"))),
    )
    saved = {m: sys.modules.get(m) for m in ("PIL", "PIL.Image", "h5py")}
    sys.modules.update({m: None for m in saved})
    try:
        for what, pkg, build in cases:
            try:
                build()
            except ImportError as e:
                if pkg not in str(e):
                    raise AssertionError(f"{what}: ImportError without {pkg}: {e}")
                continue
            raise AssertionError(f"{what} was built without {pkg}")
    finally:
        for m, mod in saved.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod
    log(f"  without PIL and h5py (installed here: {have}): ImageData, an encoded-Datum "
        f"LMDB, the ImageNet folders and tar shards raise naming PIL, HDF5Data naming "
        f"h5py, each when its dataset is built")


def phase_caffe_native(tmp):
    """Caffe's own data and weights on the card (module docstring, phase
    caffe-native); -> the LRN launches of run A and of the engines. The
    three app runs start at once and take the card while the parent
    writes their inputs; each goes when its inputs are there."""
    import signal

    runs = {name: _cn_start(tmp, name) for name in ("A", "B", "C")}
    try:
        return _caffe_native(tmp, runs)
    finally:
        for proc, out, _, _ in runs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            out.close()


def _caffe_native(tmp, runs):
    import signal

    import numpy as np
    import torch

    from sparknet_tpu_torch.models import ALEXNET_DEPLOY, ALEXNET_SOLVER
    from sparknet_tpu_torch.nets import weights as W
    from sparknet_tpu_torch.ops.lrn import lrn_rows
    from sparknet_tpu_torch.proto import caffe_pb
    from sparknet_tpu_torch.proto import caffemodel as cm
    from sparknet_tpu_torch.serve.engine import InferenceEngine
    from sparknet_tpu_torch.solver import snapshot
    from sparknet_tpu_torch.solver.trainer import Solver

    smi = _smi()
    t_phase = time.perf_counter()
    # 1. the LMDBs
    mb, dt = _cn_lmdb(os.path.join(tmp, "train_lmdb"), CN_TRAIN, 0)
    mb_t, dt_t = _cn_lmdb(os.path.join(tmp, "test_lmdb"), CN_TEST, 1)
    log(f"  LMDBs: {CN_TRAIN} Datums 256x256x3 in {mb:.1f} MB, {dt:.2f} s: "
        f"{mb / dt:.1f} MB/s; test {CN_TEST} in {mb_t:.1f} MB, {dt_t:.2f} s "
        f"(write_lmdb, host; {smi})")
    # 2. the .caffemodel of the seed-0 AlexNet weights
    shapes = {"data": (TRAIN_BATCH, 227, 227, 3), "label": (TRAIN_BATCH,)}
    src = Solver(caffe_pb.load_solver(ALEXNET_SOLVER), shapes, seed=0, device="cuda",
                 solver_dir=os.path.dirname(ALEXNET_SOLVER))
    cm_path = os.path.join(tmp, "alexnet_seed0.caffemodel")
    t0 = time.perf_counter()
    src.export_weights(cm_path)
    export_s = time.perf_counter() - t0
    # 3-4. run A uninterrupted and run B preempted, side by side on the card
    # (--seed 1: the app's own init is not the loaded seed-0 weights); run C
    # (5.) goes once B has ended, beside the rest of A; the parent checks
    # the .caffemodel meanwhile, and serves (6.) while C runs
    argv = ["--solver", _cn_solver(tmp), "--device", "cuda", "--weights", cm_path,
            "--seed", "1", "--native-loader", "off", "--data-workers", "3"]
    deadline = time.monotonic() + CN_TIMEOUT
    a_dir, b_dir = os.path.join(tmp, "a"), os.path.join(tmp, "b")
    went = {name: _cn_go(runs[name], d, argv) for name, d in (("A", a_dir), ("B", b_dir))}
    t0 = time.perf_counter()
    _, blobs = cm.load_caffemodel(cm_path)
    read_s = time.perf_counter() - t0
    want = {layer: {n: t.cpu() for n, t in e.items()} for layer, e in src.params.items()}
    for layer, entry in want.items():
        w = entry["weight"].numpy()
        if w.ndim == 2:  # InnerProduct (in, out), rows HWC -> Caffe's (out, in) CHW
            bshape = src.train_net.blob_shapes[
                next(l for l in src.train_net.layers if l.name == layer).bottom[0]]
            w = cm._ip_rows_hwc_to_chw(w.T, bshape)
        got = blobs[layer]
        if not (np.array_equal(got[0], w) and np.array_equal(got[1], entry["bias"].numpy())):
            raise AssertionError(f"caffemodel blob {layer} differs from the weights")
    if set(blobs) != set(want):
        raise AssertionError(f"caffemodel layers {sorted(blobs)} != {sorted(want)}")
    src.params = {layer: {n: torch.zeros_like(t) for n, t in e.items()}
                  for layer, e in src.params.items()}
    t0 = time.perf_counter()
    src.load_weights(cm_path)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    for layer, entry in want.items():
        for n, t in entry.items():
            if not torch.equal(src.params[layer][n].cpu(), t):
                raise AssertionError(f"load_weights: {layer}.{n} is not the exported weight")
    npz_path = os.path.join(tmp, "alexnet_seed0.npz")
    W.save_npz(npz_path, src.params, src.train_net)
    n_params = W.num_params(src.params)
    del src, want, blobs
    torch.cuda.empty_cache()
    log(f"  .caffemodel: {n_params} params, {os.path.getsize(cm_path) / 1e6:.1f} MB; "
        f"export {export_s:.2f} s, load_caffemodel {read_s:.2f} s, every blob equal; "
        f"Solver.load_weights {import_s:.2f} s, every param the exported one ({smi})")
    # SIGTERM to B once it displays iteration CN_SNAPSHOT + 1: past its first
    # snapshot, so that the stop lands after it
    proc_b, _, path_b, _ = runs["B"]
    sent = False
    while not sent and proc_b.poll() is None and time.monotonic() < deadline:
        with open(path_b) as f:
            if any(l.startswith(f"Iteration {CN_SNAPSHOT + 1}, loss") for l in f):
                proc_b.send_signal(signal.SIGTERM)
                sent = True
        time.sleep(0.05)
    rc, out_b = _cn_wait({"B": runs["B"]}, deadline)["B"]
    wall = {"B": time.monotonic() - went["B"]}
    if rc != 0 or not sent:
        raise AssertionError(f"run B exited {rc}, SIGTERM sent: {sent}")
    stops = [l for l in out_b.splitlines() if l.startswith("SIGTERM: preempted at iteration")]
    if len(stops) != 1 or "snapshot written" not in stops[0]:
        raise AssertionError(f"run B: preemption lines {stops}")
    n = int(stops[0].split("iteration ")[1].split(";")[0])
    chain_b = snapshot.ordered_solverstates(os.path.join(b_dir, "snap", "alexnet"))
    if not CN_SNAPSHOT < n < CN_ITERS or [it for it, _ in chain_b][:1] != [n] or \
            len(chain_b) != CN_KEEP:
        raise AssertionError(f"run B stopped at {n}, chain {chain_b}")
    log(f"  run B: SIGTERM after iteration {CN_SNAPSHOT + 1}'s display: '{stops[0]}', "
        f"exit 0, chain {[it for it, _ in chain_b]}, {wall['B']:.1f} s")
    # 5. the torn snapshot, and --auto-resume
    newest = chain_b[0][1]
    with open(newest, "r+b") as f:
        f.truncate(os.path.getsize(newest) // 2)
    went["C"] = _cn_go(runs["C"], b_dir, argv + ["--auto-resume"])
    rc, out_a = _cn_wait({"A": runs["A"]}, deadline)["A"]
    wall["A"] = time.monotonic() - went["A"]
    if rc != 0:
        raise AssertionError(f"run A exited {rc}")
    job_a = _cn_job("A", out_a)
    speeds = re.findall(r"images/s=(\d+)", out_a)
    chain_a = [it for it, _ in snapshot.ordered_solverstates(
        os.path.join(a_dir, "snap", "alexnet"))]
    log(f"  run A: {CN_ITERS} iterations of AlexNet at batch {TRAIN_BATCH} from the LMDB, "
        f"--weights the .caffemodel; LRN launches {job_a['launches']}; feed (3 workers) "
        f"speed: images/s by chunk {speeds}; save_or_skip ms "
        f"{[round(x, 1) for x in job_a['save_or_skip_ms']]} (AlexNet solverstate, "
        f"{smi}); chain pruned to {chain_a}; {wall['A']:.1f} s")
    tests = 2  # at 0 and at CN_ITERS, one batch each
    want_launches = [2 * tests, 2 * CN_ITERS, 2 * CN_ITERS]
    if chain_a != [CN_ITERS, CN_ITERS - CN_SNAPSHOT]:
        raise AssertionError(f"run A's chain after pruning to {CN_KEEP}: {chain_a}")
    if job_a["launches"] != want_launches:
        raise AssertionError(f"run A's LRN launches {job_a['launches']}, want {want_launches}")
    # 6. serving the same weights four ways at bucket 32
    final = f"alexnet_iter_{CN_ITERS}.solverstate.npz"
    rows = np.random.default_rng(0).normal(0, 50, (CN_BUCKET, 227, 227, 3)).astype(
        np.float32)
    snap_a = os.path.join(a_dir, "snap", final)
    twin_a = os.path.join(a_dir, "snap", f"alexnet_iter_{CN_ITERS}.npz")
    outs = {}
    lrn_rows.launches = 0
    for name, weights in (("caffemodel", cm_path), ("npz", npz_path),
                          ("solverstate", snap_a), ("solverstate twin npz", twin_a)):
        t0 = time.perf_counter()
        eng = InferenceEngine.from_files(ALEXNET_DEPLOY, weights, device="cuda",
                                         buckets=(CN_BUCKET,))
        outs[name] = eng.infer(rows)
        log(f"  engine from the {name}: built and served {CN_BUCKET} rows in "
            f"{time.perf_counter() - t0:.2f} s")
        del eng
    engine_lrn = lrn_rows.launches
    for a, b in (("caffemodel", "npz"), ("solverstate", "solverstate twin npz")):
        if not np.array_equal(outs[a], outs[b]) or not np.isfinite(outs[a]).all():
            raise AssertionError(f"serving from the {a} and the {b} differ")
    if np.array_equal(outs["caffemodel"], outs["solverstate"]):
        raise AssertionError("12 iterations of training left the served outputs as they were")
    if engine_lrn != 2 * 4:
        raise AssertionError(f"engine LRN launches {engine_lrn}, want 8 (2 a forward)")
    log(f"  serving at bucket {CN_BUCKET}: .caffemodel == its .npz, run A's solverstate "
        f"== its .npz twin, bit for bit; engine LRN launches {engine_lrn}")
    rc, out_c = _cn_wait({"C": runs["C"]}, deadline)["C"]
    wall["C"] = time.monotonic() - went["C"]
    if rc != 0:
        raise AssertionError(f"run C exited {rc}")
    older = chain_b[1][0]
    if "is torn/unreadable" not in out_c or \
            f"Restoring previous solver status from snap/alexnet_iter_{older}." not in out_c:
        raise AssertionError("run C: no torn-file warning and fallback to "
                             f"iteration {older}")
    got = snapshot.load_state(os.path.join(b_dir, "snap", final))
    want_st = snapshot.load_state(snap_a)
    for key in ("params", "state", "opt_state", "rng", "it"):
        _cn_equal(f"resumed run vs run A: {key}", got[key], want_st[key])
    log(f"  run C: torn iteration {n} warned, fell back to {older}, ran to {CN_ITERS}: "
        f"params, net state, optimizer slots, generator and iteration equal run A's "
        f"bit for bit; {wall['C']:.1f} s")
    # 7. without PIL or h5py
    _cn_without_packages(tmp)
    log(f"  caffe-native: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": (job_a["launches"][0] + engine_lrn, job_a["launches"][1],
                         job_a["launches"][2])}


# ---------------------------------------------------------------- chaos
# run B's plan: the probe batch 0 is made by the feed's owner, so worker r
# makes batches 1 + r, 3 + r, ...: batch 3 is worker 0's and batch 6 worker
# 1's (the respawned worker 0 runs with the plan off)
CH_SPEC = ("pipeline.worker_crash@batch=3:worker=0,"
           "pipeline.slow_batch@batch=6:delay_ms=300,"
           "io.enospc@site=snapshot:index=0,snapshot.partial_write@iter=12")
CH_SERVE_SPEC = "serve.conn_drop@every=5,serve.engine_stall@every=7:delay_ms=100"
CH_ITERS, CH_SNAPSHOT, CH_BATCH = 12, 4, 128
CH_SYNTHETIC_N = 1024  # its TEST set is 1/8: one batch of 128
CH_CLIENTS, CH_REQUESTS, CH_ROWS = 4, 40, 8
CH_STALL_S, CH_DEADLINE_S = 0.1, 0.05
CH_SLOW_BATCH, CH_SLOW_S = 6, 0.3  # CH_SPEC's pipeline.slow_batch
CH_TRACE = "trace.json"  # run B's span trace, in its cwd


def _ch_solver(tmp):
    """The zoo AlexNet train_val under a solver of CH_ITERS iterations, a
    snapshot every CH_SNAPSHOT, one test batch at 0 and at the end; the
    prefix is relative, so each run's cwd holds its own chain."""
    from sparknet_tpu_torch.models import ALEXNET_TRAIN_VAL

    path = os.path.join(tmp, "alexnet_chaos_solver.prototxt")
    with open(path, "w") as f:
        f.write(f'net: "{ALEXNET_TRAIN_VAL}"\ntest_iter: 1\ntest_interval: {CH_ITERS}\n'
                'base_lr: 0.01\nlr_policy: "step"\ngamma: 0.1\nstepsize: 100000\n'
                f"display: {CH_SNAPSHOT}\nmax_iter: {CH_ITERS}\nmomentum: 0.9\n"
                f'weight_decay: 0.0005\nsnapshot: {CH_SNAPSHOT}\nsnapshot_prefix: "snap/alexnet"\n')
    return path


def _ch_no_plan_left():
    """No fault plan, ``SPARKNET_CHAOS`` or ENOSPC storm in this process."""
    from sparknet_tpu_torch import chaos
    from sparknet_tpu_torch.utils import safeio

    left = [what for what, bad in (("a plan", chaos.get_plan() is not None),
                                   ("SPARKNET_CHAOS", "SPARKNET_CHAOS" in os.environ),
                                   ("a storm", safeio.storm_active())) if bad]
    if left:
        raise AssertionError(f"chaos: {', '.join(left)} left in chip_smoke's process")


def _ch_serving():
    """The AlexNet server and batcher built under CH_SERVE_SPEC; 4 client
    threads, 40 requests of 8 rows; then one request straight to the
    batcher that a stalled flush sheds. -> its readings."""
    import threading

    import numpy as np

    from sparknet_tpu_torch import chaos
    from sparknet_tpu_torch.models import ALEXNET_DEPLOY
    from sparknet_tpu_torch.ops.lrn import lrn_rows
    from sparknet_tpu_torch.serve.batcher import DeadlineExceeded
    from sparknet_tpu_torch.serve.engine import InferenceEngine
    from sparknet_tpu_torch.serve.metrics import ServeMetrics
    from sparknet_tpu_torch.serve.server import Client, InferenceServer

    buckets = (CH_ROWS, CH_CLIENTS * CH_ROWS)
    metrics = ServeMetrics(buckets)
    eng = InferenceEngine.from_files(ALEXNET_DEPLOY, device="cuda", buckets=buckets,
                                     metrics=metrics)
    eng.warmup()
    rng = np.random.default_rng(22)
    # mean-subtracted pixels: integers keep the JSON bodies small
    reqs = [rng.integers(-128, 128, size=(CH_ROWS,) + eng._row_shapes["data"])
            for _ in range(CH_REQUESTS)]
    answers = [None] * CH_REQUESTS
    attempts = [0] * CH_REQUESTS
    errors = []

    def client(k):
        c = Client(server.host, server.port, timeout=120, retries=5)
        once = c._once
        for i in range(k, CH_REQUESTS, CH_CLIENTS):
            def counted(*a, _i=i, **kw):
                attempts[_i] += 1
                return once(*a, **kw)

            c._once = counted
            try:
                code, body = c.classify(reqs[i], top_k=5)
            except Exception as e:
                errors.append((i, repr(e)))
                continue
            if code != 200:
                errors.append((i, code, body))
                continue
            answers[i] = body["indices"]

    chaos.install(CH_SERVE_SPEC)
    server = None
    try:
        server = InferenceServer(eng, metrics=metrics, port=0,
                                 model_name="bvlc_alexnet_deploy.prototxt")
        batcher = server.batcher
        if not batcher.wait_ready(300):
            raise AssertionError("batcher worker did not finish its warmup")
        server.start()
        lrn_rows.launches = 0  # the served path's launches from here
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,)) for k in range(CH_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        traffic_s = time.perf_counter() - t0
        if any(t.is_alive() for t in threads):
            raise AssertionError("a client thread did not finish in 600 s")
        launches = lrn_rows.launches
        flushes = batcher._flushes
        posts = next(server._post_seq)  # this server's /classify POSTs
        fires = chaos.METRICS.snapshot()["fires"]
        retries = chaos.METRICS.recovery_count("serve.client_retry")
        # one request straight to the batcher, at a flush the plan stalls,
        # with a deadline shorter than the stall: shed before compute
        pad = reqs[0][:1].astype(np.float32)
        while batcher._flushes % 7:
            batcher.submit(pad, block=True).result(timeout=60)
        shed0, before = metrics.snapshot()["shed"], lrn_rows.launches
        fut = batcher.submit(pad, block=True, deadline_s=CH_DEADLINE_S)
        try:
            fut.result(timeout=60)
            shed_err = None
        except DeadlineExceeded as e:
            shed_err = str(e)
        shed = metrics.snapshot()["shed"] - shed0
        stalls = chaos.METRICS.snapshot()["fires"].get("serve.engine_stall", 0)
        if shed_err is None or shed != 1 or lrn_rows.launches != before:
            raise AssertionError(f"the stalled request: error {shed_err!r}, shed {shed}, "
                                 f"LRN launches {before} -> {lrn_rows.launches}")
    finally:
        if server is not None:
            server.stop()
        chaos.clear()
    _ch_no_plan_left()
    if errors or any(a is None for a in answers):
        raise AssertionError(f"{len(errors)} failed requests: {errors[:3]}")
    drops = [k for k in range(posts) if k % 5 == 0]
    retried = [a for a in attempts if a > 1]
    if (sum(attempts) != posts or fires.get("serve.conn_drop") != len(drops)
            or sum(a - 1 for a in attempts) != len(drops) or retries != len(retried)):
        raise AssertionError(
            f"conn_drop: {posts} POSTs ({sum(attempts)} client attempts), fires "
            f"{fires.get('serve.conn_drop')} for {len(drops)} indices every=5 selects, "
            f"{sum(a - 1 for a in attempts)} failed attempts, {retries} client_retry "
            f"recoveries for {len(retried)} retried requests")
    twice = sum(a > 2 for a in attempts)
    if retries + twice < len(drops):
        raise AssertionError(f"{retries} client_retry recoveries for {len(drops)} drops")
    want_stalls = len([k for k in range(flushes) if k % 7 == 0])
    if fires.get("serve.engine_stall") != want_stalls or stalls != want_stalls + 1:
        raise AssertionError(f"engine_stall fires {fires.get('serve.engine_stall')} over "
                             f"{flushes} flushes (every=7: {want_stalls}), then {stalls}")
    # every answer against the CPU engine on the same rows
    ref = InferenceEngine.from_files(ALEXNET_DEPLOY, device="cpu",
                                     buckets=(CH_REQUESTS * CH_ROWS,))
    t1 = time.perf_counter()
    rows = np.concatenate(reqs).astype(np.float32)
    probs = ref.infer(rows)
    idx_cpu, _ = ref.postprocess(probs, 5)
    for i, idx in enumerate(answers):
        s = slice(i * CH_ROWS, (i + 1) * CH_ROWS)
        _check_topk(f"request {i}", idx, idx_cpu[s], probs[s])
    cpu_s = time.perf_counter() - t1
    log(f"  serving under '{CH_SERVE_SPEC}': {CH_REQUESTS} requests of {CH_ROWS} rows from "
        f"{CH_CLIENTS} client threads in {traffic_s:.2f} s, 0 failed; {posts} POSTs, "
        f"conn_drop fired {len(drops)} times (every 5th POST index), {retries} requests "
        f"answered after a retry ({twice} dropped twice); {flushes} flushes, "
        f"engine_stall fired {want_stalls} times; every top-5 equal to the CPU engine's "
        f"({cpu_s:.1f} s on the CPU); LRN launches {launches}")
    log(f"  a request with a {CH_DEADLINE_S * 1e3:.0f} ms deadline at a stalled flush "
        f"({CH_STALL_S * 1e3:.0f} ms): shed before compute ({shed_err}), the batcher's "
        f"shed +1, no LRN launch")
    return launches


def _ch_storage(tmp):
    """With no plan, SPARKNET_DISK_MIN_FREE_MB above the free space of
    ``tmp``: ``safeio.atomic_write`` refuses early and counts the fault."""
    import errno

    from sparknet_tpu_torch.telemetry.registry import REGISTRY
    from sparknet_tpu_torch.utils import safeio

    free = safeio.free_bytes(tmp)
    target = os.path.join(tmp, "preflight.json")
    series = REGISTRY.counter("io_faults", site="records", errno="enospc")
    before = series.snapshot()
    old = os.environ.get("SPARKNET_DISK_MIN_FREE_MB")
    os.environ["SPARKNET_DISK_MIN_FREE_MB"] = str(free // (1 << 20) + 1024)
    try:
        try:
            safeio.atomic_write_json(target, {"written": True}, site="records")
            err = None
        except OSError as e:
            err = e
    finally:
        if old is None:
            del os.environ["SPARKNET_DISK_MIN_FREE_MB"]
        else:
            os.environ["SPARKNET_DISK_MIN_FREE_MB"] = old
    left = [n for n in os.listdir(tmp) if n.startswith("preflight.json")]
    if err is None or err.errno != errno.ENOSPC or left or series.snapshot() != before + 1:
        raise AssertionError(f"preflight: error {err!r}, files {left}, io_faults "
                             f"{before} -> {series.snapshot()}")
    log(f"  storage: {free} bytes free under the phase's directory; with "
        f"SPARKNET_DISK_MIN_FREE_MB={free // (1 << 20) + 1024} atomic_write refused "
        f"before staging ({err}); io_faults{{site=records,errno=enospc}} {before} -> "
        f"{series.snapshot()}")


def _ch_line(name, text, prefix):
    """The JSON object of the one line of ``text`` that starts with
    ``prefix`` and then ``{``."""
    lines = [l for l in text.splitlines() if l.startswith(prefix + "{")]
    if len(lines) != 1:
        raise AssertionError(f"run {name}: {len(lines)} lines starting {prefix!r}")
    return json.loads(lines[0][len(prefix):])


def _ch_slow_batch(path):
    """Run B's trace: the ``pipeline.produce`` span of batch CH_SLOW_BATCH
    (the slow batch's sleep is inside it) must last CH_SLOW_S or more.
    -> what it read, against the median of the other batches' spans."""
    with open(path) as f:
        spans = [e for e in json.load(f)["traceEvents"] if e.get("name") == "pipeline.produce"]
    ms = {}
    for e in spans:
        ms.setdefault(e["args"]["batch"], []).append(e["dur"] / 1e3)
    slow = ms.pop(CH_SLOW_BATCH, [])
    others = sorted(v for vs in ms.values() for v in vs)
    if len(slow) != 1 or slow[0] < CH_SLOW_S * 1e3 or not others:
        raise AssertionError(f"run B's trace: batch {CH_SLOW_BATCH}'s produce spans {slow} ms "
                             f"(want one of {CH_SLOW_S * 1e3:.0f} ms or more), "
                             f"{len(others)} others")
    median = others[len(others) // 2]
    return (f"batch {CH_SLOW_BATCH}'s produce span {slow[0]:.1f} ms in its trace, the other "
            f"{len(others)} traced batches' median {median:.1f} ms: "
            f"{slow[0] - median:.1f} ms added")


def phase_chaos(tmp, sv_dir=None, sv=None):
    """Fault injection in one process (module docstring, phase chaos):
    -> the LRN launches of runs A, B and C and of the served traffic.
    The three app runs start at once and take the card while the parent
    writes the solver; A and B go together, C once B has ended. The
    serving part runs in a thread of this process. Given ``sv_dir`` and
    the dict ``sv``, the supervised runs (:func:`_sv_start`) start in
    ``sv_dir`` beside them, as ``sv["runs"]``, and run A's last
    solverstate is kept there for their check
    (:func:`phase_supervise_check`), which comes after the next phase."""
    runs = {name: _cn_start(tmp, name) for name in ("A", "B", "C")}
    t_phase = time.perf_counter()
    argv = _ch_argv(tmp)
    try:
        if sv is not None:
            sv["runs"] = _sv_start(sv_dir, _ch_argv(sv_dir))
        out = _chaos(tmp, runs, argv, t_phase)
        if sv is not None:
            name = f"alexnet_iter_{CH_ITERS}.solverstate.npz"
            shutil.copy(os.path.join(tmp, "a", "snap", name),
                        os.path.join(sv_dir, f"a_ref_iter_{CH_ITERS}.solverstate.npz"))
        return out
    finally:
        _ch_kill(runs)


def _ch_kill(runs):
    """SIGKILL each run's session that is left, close its log."""
    import signal

    for run in runs.values():
        proc, out = run[0], run[1]
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        out.close()


def _ch_argv(tmp):
    """ImageNetApp's command line of the chaos phase's AlexNet runs."""
    return ["--arch", "alexnet", "--solver", _ch_solver(tmp), "--device", "cuda",
            "--synthetic", "--synthetic-n", str(CH_SYNTHETIC_N), "--batch-size",
            str(CH_BATCH), "--native-loader", "off", "--data-workers", "2"]


def _chaos(tmp, runs, argv, t_phase):
    import threading

    smi = _smi()
    went = {"A": _cn_go(runs["A"], os.path.join(tmp, "a"), argv),
            "B": _cn_go(runs["B"], os.path.join(tmp, "b"),
                        argv + ["--chaos", CH_SPEC, "--trace", CH_TRACE])}
    # serving under its plan in a thread, while this one takes B, then C
    # (once B has ended), then A; nothing here writes through safeio
    served = {}

    def serve():
        t0 = time.perf_counter()
        try:
            served["launches"] = _ch_serving()
        except BaseException as e:  # raised again below, after the join
            served["error"] = e
        served["s"] = time.perf_counter() - t0

    thread = threading.Thread(target=serve, name="chaos-serving")
    thread.start()
    try:
        got_lrn = _ch_runs(tmp, runs, argv, went)
    finally:
        thread.join(CN_TIMEOUT)
    if thread.is_alive():
        raise AssertionError(f"the serving part did not end in {CN_TIMEOUT} s")
    if "error" in served:
        raise served["error"]
    t1 = time.perf_counter()
    _ch_storage(tmp)  # with no plan in this process
    log(f"  serving {served['s']:.1f} s (beside the runs), storage "
        f"{time.perf_counter() - t1:.2f} s")
    _ch_no_plan_left()
    log(f"  chaos: {time.perf_counter() - t_phase:.1f} s ({smi})")
    runs_lrn = [sum(v[i] for v in got_lrn.values()) for i in range(3)]
    return {"launches": (runs_lrn[0] + served["launches"], runs_lrn[1], runs_lrn[2])}


def _ch_runs(tmp, runs, argv, went):
    """Run B's checks, then C (B's ``--auto-resume``), A's, C's; -> each
    run's LRN launches."""
    from sparknet_tpu_torch.solver import snapshot

    deadline = time.monotonic() + CN_TIMEOUT
    a_dir, b_dir = os.path.join(tmp, "a"), os.path.join(tmp, "b")
    wall = {}
    rc, out_b = _cn_wait({"B": runs["B"]}, deadline)["B"]
    wall["B"] = time.monotonic() - went["B"]
    if rc != 0:
        raise AssertionError(f"run B exited {rc}")
    job_b = _cn_job("B", out_b)
    line_b = _ch_line("B", out_b, "chaos: ")
    # the pipeline points fire in the forked workers, whose counts die with
    # them: the owner's line holds their recovery (the JAX package's rule)
    want = {"fires": {"io.enospc": 1, "snapshot.partial_write": 1},
            "recoveries": {"pipeline.worker_respawn": 1}}
    if line_b != want or job_b["chaos"] != want:
        raise AssertionError(f"run B's chaos line {line_b}, want {want}")
    # the respawn resumes at the first batch worker 0 never delivered
    died = [l for l in out_b.splitlines() if l.startswith("input pipeline: worker ")]
    if died != ["input pipeline: worker 0 died (exit 3); respawned at batch 3 "
                "(attempt 1/2)"]:
        raise AssertionError(f"run B's respawn lines {died}")
    if job_b["snapshot_skipped"] != {"errno=enospc": 1} or \
            job_b["io_faults"] != {"errno=enospc,site=snapshot": 1}:
        raise AssertionError(f"run B: snapshot_skipped {job_b['snapshot_skipped']}, "
                             f"io_faults {job_b['io_faults']}")
    prefix_b = os.path.join(b_dir, "snap", "alexnet")
    chain_b = [it for it, _ in snapshot.ordered_solverstates(prefix_b)]
    if chain_b != [CH_ITERS, 2 * CH_SNAPSHOT]:
        raise AssertionError(f"run B's chain {chain_b}: want {CH_SNAPSHOT} skipped")
    torn = f"{prefix_b}_iter_{CH_ITERS}.solverstate.npz"
    try:
        snapshot.load_state(torn)
        raise AssertionError(f"run B's iteration {CH_ITERS} solverstate loads: not torn")
    except snapshot.SnapshotError as e:
        torn_err = type(e.__cause__).__name__
    b8 = snapshot.load_state(f"{prefix_b}_iter_{2 * CH_SNAPSHOT}.solverstate.npz")
    went["C"] = _cn_go(runs["C"], b_dir, argv + ["--auto-resume"])
    slow = _ch_slow_batch(os.path.join(b_dir, CH_TRACE))
    rc, out_a = _cn_wait({"A": runs["A"]}, deadline)["A"]
    wall["A"] = time.monotonic() - went["A"]
    if rc != 0:
        raise AssertionError(f"run A exited {rc}")
    job_a = _cn_job("A", out_a)
    if any(l.startswith("chaos: ") for l in out_a.splitlines()) or \
            job_a["chaos"] != {"fires": {}, "recoveries": {}}:
        raise AssertionError(f"run A, with no plan: chaos {job_a['chaos']}")
    prefix_a = os.path.join(a_dir, "snap", "alexnet")
    chain_a = [it for it, _ in snapshot.ordered_solverstates(prefix_a)]
    if chain_a != [CH_ITERS, 2 * CH_SNAPSHOT]:
        raise AssertionError(f"run A's chain after pruning to {CN_KEEP}: {chain_a}")
    a8 = snapshot.load_state(f"{prefix_a}_iter_{2 * CH_SNAPSHOT}.solverstate.npz")
    for key in ("params", "state", "opt_state", "rng", "it"):
        _cn_equal(f"run B vs run A at iteration {2 * CH_SNAPSHOT}: {key}", b8[key], a8[key])
    waits = {name: _ch_line(name, out, "input pipeline: ")["consumer_wait"]
             for name, out in (("A", out_a), ("B", out_b))}
    log(f"  run B under '{CH_SPEC}': {wall['B']:.1f} s; chaos line {line_b}; '{died[0]}'; "
        f"snapshot_skipped {job_b['snapshot_skipped']}; chain {chain_b}; iteration "
        f"{CH_ITERS} torn ({torn_err}); iteration {2 * CH_SNAPSHOT} equal to run A's bit "
        f"for bit; {slow}; the feed's consumer wait, ms, A {waits['A']} and B "
        f"{waits['B']}")
    log(f"  run A (no plan): {wall['A']:.1f} s; chain {chain_a}; LRN launches "
        f"{job_a['launches']}")
    rc, out_c = _cn_wait({"C": runs["C"]}, deadline)["C"]
    wall["C"] = time.monotonic() - went["C"]
    if rc != 0:
        raise AssertionError(f"run C exited {rc}")
    job_c = _cn_job("C", out_c)
    resumed = f"Restoring previous solver status from snap/alexnet_iter_{2 * CH_SNAPSHOT}."
    if "is torn/unreadable" not in out_c or resumed not in out_c or \
            job_c["chaos"] != {"fires": {}, "recoveries": {"snapshot.fallback_restore": 1}}:
        raise AssertionError(f"run C: no torn-file warning and fallback to "
                             f"{2 * CH_SNAPSHOT}, or chaos {job_c['chaos']}")
    got = snapshot.load_state(torn)
    want_st = snapshot.load_state(f"{prefix_a}_iter_{CH_ITERS}.solverstate.npz")
    for key in ("params", "state", "opt_state", "rng", "it"):
        _cn_equal(f"run C vs run A at iteration {CH_ITERS}: {key}", got[key], want_st[key])
    tests = 2  # one batch at 0 and one at CH_ITERS; C's at CH_ITERS only
    want_lrn = {"A": [2 * tests, 2 * CH_ITERS, 2 * CH_ITERS],
                "B": [2 * tests, 2 * CH_ITERS, 2 * CH_ITERS],
                "C": [2, 2 * (CH_ITERS - 2 * CH_SNAPSHOT), 2 * (CH_ITERS - 2 * CH_SNAPSHOT)]}
    got_lrn = {"A": job_a["launches"], "B": job_b["launches"], "C": job_c["launches"]}
    if got_lrn != want_lrn:
        raise AssertionError(f"LRN launches {got_lrn}, want {want_lrn}")
    log(f"  run C (--auto-resume, no plan): {wall['C']:.1f} s; warned of the torn "
        f"iteration {CH_ITERS}, fell back to {2 * CH_SNAPSHOT} (chaos "
        f"{job_c['chaos']['recoveries']}), ran to {CH_ITERS}: params, net state, optimizer "
        f"slots, generator and iteration equal run A's bit for bit; LRN launches {got_lrn}")
    return got_lrn


# ----------------------------------------------------------- supervise
# the supervised AlexNet run: its child hard-exits at the boundary at 8
# (after the snapshots at 4 and 8), and the supervisor tears the file for
# 8 before the relaunch, which falls back to 4
SV_SPEC = "supervisor.child_crash@iter=8,supervisor.resume_torn@index=0"
# the gang: rank 1 goes silent at its third tick; generation 0's batches
# are held 40 ms each (its rank 0 had 280 iterations done at 20 ms when
# the silence was seen), so the silence, not max_iter, ends it
SV_GANG_SPEC = ("multihost.peer_silence@worker=1:tick=3,"
                "pipeline.slow_batch@every=1:delay_ms=40")
SV_GANG_ITERS, SV_GANG_SNAPSHOT = 500, 100
SV_HEARTBEAT_S = "8"  # the gang's heartbeat timeout (its interval 1.6 s)
SV_KILL_GRACE_S = "3"
SV_TIMEOUT = 300  # seconds a supervised run may take
# the supervised children's start-up (a sitecustomize module on their
# path): f32 without TF32 and deterministic algorithms, as the app jobs
# run, so that the resumed run can equal run A bit for bit
SV_SITE = """import torch
import torch.utils.deterministic
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
torch.use_deterministic_algorithms(True, warn_only=True)
torch.utils.deterministic.fill_uninitialized_memory = False
"""


def _sv_solver(tmp):
    """cifar10_quick under the gang's solver: SV_GANG_ITERS iterations, a
    snapshot every SV_GANG_SNAPSHOT, one test of 2 batches at the end."""
    from sparknet_tpu_torch.models import CIFAR_QUICK_TRAIN_TEST

    path = os.path.join(tmp, "sv_gang_solver.prototxt")
    with open(path, "w") as f:
        f.write(f'net: "{CIFAR_QUICK_TRAIN_TEST}"\ntest_iter: 2\n'
                f"test_interval: {SV_GANG_ITERS}\ntest_initialization: false\n"
                'base_lr: 0.001\nlr_policy: "fixed"\nmomentum: 0.9\nweight_decay: 0.004\n'
                f"display: {SV_GANG_SNAPSHOT}\nmax_iter: {SV_GANG_ITERS}\n"
                f'snapshot: {SV_GANG_SNAPSHOT}\nsnapshot_prefix: "snap/quick"\n')
    return path


def _sv_start(tmp, argv):
    """Start the supervised runs, each ``python -m <app> ... --supervise``
    (the supervising process) in a session of its own with its output in
    ``<tmp>/<name>.log``: S, ImageNetApp on the chaos phase's AlexNet
    under SV_SPEC; G, CifarApp's cifar10_quick as a gang of 2 processes
    on cuda:0 over gloo under SV_GANG_SPEC, degraded after one blamed
    failure. -> their :class:`_SvRuns`, sampling from now on."""
    import socket

    site = os.path.join(tmp, "sv_site")
    os.makedirs(site, exist_ok=True)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(SV_SITE)

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    base = dict(os.environ, PYTHONUNBUFFERED="1", CUBLAS_WORKSPACE_CONFIG=":4096:8",
                SPARKNET_SUPERVISE_BACKOFF="0.1", SPARKNET_SUPERVISE_BACKOFF_CAP="0.2",
                PYTHONPATH=os.pathsep.join(p for p in (site, ROOT,
                                                       os.environ.get("PYTHONPATH")) if p))
    jobs = {
        "S": (["sparknet_tpu_torch.apps.imagenet_app", *argv],
              dict(SPARKNET_CHAOS=SV_SPEC, SPARKNET_SNAPSHOT_KEEP=str(CN_KEEP))),
        "G": (["sparknet_tpu_torch.apps.cifar_app", "--solver", _sv_solver(tmp),
               "--synthetic", "--synthetic-n", "2000", "--parallel", "local", "--tau", "10",
               "--device", "cuda", "--data-workers", "1", "--native-loader", "off"],
              dict(SPARKNET_CHAOS=SV_GANG_SPEC, SPARKNET_NUM_PROCESSES="2",
                   SPARKNET_COORDINATOR=f"127.0.0.1:{free_port()}",
                   SPARKNET_HEARTBEAT_PORT=str(free_port()), SPARKNET_DIST_BACKEND="gloo",
                   SPARKNET_HEARTBEAT_TIMEOUT=SV_HEARTBEAT_S, SPARKNET_INIT_TIMEOUT="120",
                   SPARKNET_SUPERVISE_DEGRADE_AFTER="1",
                   SPARKNET_SUPERVISE_KILL_GRACE=SV_KILL_GRACE_S)),
    }
    started = {}
    for name, (cmd, env) in jobs.items():
        cwd = os.path.join(tmp, name.lower() + "_sv")
        os.makedirs(cwd, exist_ok=True)
        path = os.path.join(tmp, f"{name}_sv.log")
        out = open(path, "w")
        proc = subprocess.Popen([sys.executable, "-m", *cmd, "--supervise"], cwd=cwd,
                                env=dict(base, SPARKNET_RUN_DIR=cwd, **env), stdout=out,
                                stderr=subprocess.STDOUT, start_new_session=True)
        started[name] = (proc, out, path, time.monotonic())
    return _SvRuns(started)


def _sv_session(sid):
    """The pids of the processes in session ``sid`` (from /proc)."""
    pids = set()
    for name in os.listdir("/proc"):
        if name.isdigit():
            try:
                with open(f"/proc/{name}/stat") as f:
                    # the fields after the command's closing parenthesis
                    fields = f.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            if int(fields[3]) == sid:
                pids.add(int(name))
    return pids


def _sv_nvidia(pid):
    """Does process ``pid`` hold one of the card's device files
    (``/dev/nvidia*``: a CUDA context, or CUDA initialized)?"""
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return False
    for fd in fds:
        try:
            if os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia"):
                return True
        except OSError:
            continue
    return False


class _SvRuns:
    """The supervised runs ({name: (process, log file, log path, start
    time)}) and a thread that samples, every 0.5 s from their start to
    their ends, the card's compute processes (``nvidia-smi
    --query-compute-apps=pid``), each run's session, and which of its
    processes hold the card's device files (:func:`_sv_nvidia`)."""

    def __init__(self, runs):
        import threading

        self.runs = runs
        self.seen = {name: {"card": set(), "session": set(), "dev": set()} for name in runs}
        self.ended = {}  # name -> seconds from its start to its end
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, name="supervised-runs",
                                        daemon=True)
        self._thread.start()

    def _sample(self):
        while not self._stop.is_set() and len(self.ended) < len(self.runs):
            q = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                                "--format=csv,noheader"],
                               capture_output=True, text=True, timeout=60)
            card = {int(t) for t in q.stdout.split() if t.strip().isdigit()}
            for name, (proc, _, _, t0) in self.runs.items():
                if name in self.ended:
                    continue
                if proc.poll() is not None:
                    self.ended[name] = time.monotonic() - t0
                    continue
                self.seen[name]["card"] |= card
                pids = _sv_session(proc.pid)
                self.seen[name]["session"] |= pids
                self.seen[name]["dev"] |= {p for p in pids if _sv_nvidia(p)}
            self._stop.wait(0.5)

    def wait(self):
        """Wait for the runs' ends (at most SV_TIMEOUT from their start),
        then up to 10 s for each session to empty. -> {name: (exit code,
        output, seconds, what was seen, pids left)}."""
        t0 = min(run[3] for run in self.runs.values())
        self._thread.join(max(SV_TIMEOUT - (time.monotonic() - t0), 0.1))
        res = {}
        for name, (proc, _, path, _) in self.runs.items():
            if name not in self.ended:
                raise AssertionError(f"supervised run {name} did not end in {SV_TIMEOUT} s")
            left = _sv_session(proc.pid)
            end = time.monotonic() + 10
            while left and time.monotonic() < end:
                time.sleep(0.2)
                left = _sv_session(proc.pid)
            with open(path) as f:
                text = f.read()
            if proc.returncode:
                for line in text.splitlines()[-60:]:
                    log(f"  {name} | {line}")
            res[name] = (proc.returncode, text, self.ended[name], self.seen[name], left)
        return res

    def kill(self):
        """Stop sampling; SIGKILL each run's session that is left."""
        self._stop.set()
        self._thread.join(70)
        _ch_kill(self.runs)


def _sv_line(name, text):
    lines = [l for l in text.splitlines() if l.startswith("supervisor: ")]
    if len(lines) != 1:
        raise AssertionError(f"supervised run {name}: {len(lines)} supervisor: lines")
    return json.loads(lines[0][len("supervisor: "):])


def _sv_check(tmp, sv, prefix_a):
    """The supervised runs' checks (module docstring, item 20a)."""
    from sparknet_tpu_torch.solver import snapshot

    res = sv.wait()
    for name, (proc, *_rest) in sv.runs.items():
        rc, text, secs, seen, left = res[name]
        if rc != 0:
            raise AssertionError(f"supervised run {name} exited {rc}")
        if left:
            raise AssertionError(f"supervised run {name}: processes {sorted(left)} left alive")
        others = seen["session"] - {proc.pid}
        if proc.pid in seen["card"] or proc.pid in seen["dev"] or not seen["dev"]:
            raise AssertionError(
                f"supervised run {name}: the supervising process {proc.pid} on the card "
                f"({sorted(seen['card'])}) or holding the card's device files "
                f"({sorted(seen['dev'])}), or no child seen holding them")
        report = json.load(open(os.path.join(tmp, f"{name.lower()}_sv",
                                             "supervisor_report.json")))
        log(f"  supervised run {name}: {secs:.1f} s, generations "
            f"{[g['duration_s'] for g in report['generations']]} s; the card's compute "
            f"processes seen {sorted(seen['card'])}, the supervisor {proc.pid} never among "
            f"them; of its session's processes {sorted(others)}, {sorted(seen['dev'])} "
            f"held the card's device files (/dev/nvidia*), the supervisor never; no process of "
            f"its session left")

    # S: the supervised AlexNet run
    text = res["S"][1]
    line = _sv_line("S", text)
    if line != {"restarts": 1, "torn_snapshots": 1, "verified_resumes": 1}:
        raise AssertionError(f"run S's supervisor: line {line}")
    s_dir = os.path.join(tmp, "s_sv")
    report = json.load(open(os.path.join(s_dir, "supervisor_report.json")))
    gens = report["generations"]
    if [(g["width"], g["action"], [(e["rank"], e["returncode"], e["class"])
                                   for e in g["exits"]]) for g in gens] != \
            [(1, None, [(0, 9, "error")]), (1, None, [(0, 0, "clean")])] or \
            report["final_status"] != "done" or gens[0]["resume"]["iter"] != CH_SNAPSHOT:
        raise AssertionError(f"run S's report: {json.dumps(report)[:3000]}")
    (rec,) = gens[0]["records"]
    if rec["kind"] != "chaos.child_crash" or rec["last_completed_iteration"] != \
            2 * CH_SNAPSHOT or not rec["flight_recorder"]:
        raise AssertionError(f"run S's record {rec}")
    dump = json.load(open(rec["flight_recorder"]))
    if not any(f"Snapshotting solver state to" in l and f"_iter_{2 * CH_SNAPSHOT}." in l
               for l in dump["logs"]):
        raise AssertionError(f"run S's flight dump logs {dump['logs'][-10:]}")
    resumed = f"Restoring previous solver status from {s_dir}/snap/alexnet_iter_{CH_SNAPSHOT}."
    if resumed not in text or "is torn/unreadable" not in text:
        raise AssertionError("run S's relaunch: no torn-file warning and fallback to "
                             f"{CH_SNAPSHOT}")
    got = snapshot.load_state(f"{s_dir}/snap/alexnet_iter_{CH_ITERS}.solverstate.npz")
    want = snapshot.load_state(f"{prefix_a}_iter_{CH_ITERS}.solverstate.npz")
    for key in ("params", "state", "opt_state", "rng", "it"):
        _cn_equal(f"run S vs run A at iteration {CH_ITERS}: {key}", got[key], want[key])
    log(f"  run S (ImageNetApp --supervise, SPARKNET_CHAOS='{SV_SPEC}'): generation 0 "
        f"died at {rec['last_completed_iteration']} (exit 9, record {rec['kind']}, flight "
        f"dump of {len(dump['logs'])} log lines, {len(dump['events'])} events); the "
        f"supervisor tore {2 * CH_SNAPSHOT}, verified {CH_SNAPSHOT}; generation 1 resumed "
        f"at {CH_SNAPSHOT} with no plan and ran to {CH_ITERS}: params, net state, optimizer "
        f"slots, generator and iteration equal run A's bit for bit; supervisor: {line}")

    # G: the gang
    text = res["G"][1]
    line = _sv_line("G", text)
    g_dir = os.path.join(tmp, "g_sv")
    report = json.load(open(os.path.join(g_dir, "supervisor_report.json")))
    gens = report["generations"]
    shape = [(g["width"], g["action"], g.get("blamed_rank")) for g in gens]
    exits = [[(e["rank"], e["returncode"], e["class"]) for e in g["exits"]] for g in gens]
    # the JAX supervisor's decisions for these exits (tests/test_torch_supervisor.py)
    if shape != [(2, None, 0), (1, "degrade", None)] or exits[0][0] != (0, 43, "peer_failure") \
            or exits[0][1][2] not in ("error", "signal") or exits[1] != [(0, 0, "clean")] \
            or report["final_status"] != "done" or line.get("degraded_relaunches") != 1 \
            or line.get("restarts") != 1:
        raise AssertionError(f"the gang's report {json.dumps(report)[:3000]}; supervisor: "
                             f"{line}")
    rec = gens[0]["records"][0]
    if (rec["process_id"], rec["kind"], rec["exit_code"]) != (0, "peer_failure", 43):
        raise AssertionError(f"the gang's first record {rec}")
    st = snapshot.load_state(f"{g_dir}/snap/quick_iter_{SV_GANG_ITERS}.solverstate.npz")
    if st["it"] != SV_GANG_ITERS:
        raise AssertionError(f"the gang's last solverstate at {st['it']}")
    resume = gens[0].get("resume")
    log(f"  gang G (CifarApp --supervise, 2 processes on cuda:0 over gloo, "
        f"SPARKNET_CHAOS='{SV_GANG_SPEC}'): generation 0 exits {exits[0]}, blamed rank 0 "
        f"(record {rec['kind']}: {rec['reason']}; last completed iteration "
        f"{rec['last_completed_iteration']}); generation 1 degraded to width 1 with "
        f"SPARKNET_ELASTIC_RESUME=1 from {resume and resume['iter']}, done at "
        f"{SV_GANG_ITERS}; supervisor: {line}")


def phase_supervise_check(sv_dir, sv):
    """The supervised runs started by the chaos phase, waited for and
    checked against its run A's kept solverstate."""
    if "runs" not in sv:
        raise AssertionError("the chaos phase started no supervised run")
    try:
        _sv_check(sv_dir, sv["runs"], os.path.join(sv_dir, "a_ref"))
    finally:
        sv["runs"].kill()


def phase_supervise(tmp):
    """The supervised runs alone, and run A, their reference."""
    runs = {"A": _cn_start(tmp, "A")}
    argv = _ch_argv(tmp)
    sv = None
    try:
        sv = _sv_start(tmp, argv)
        went = _cn_go(runs["A"], os.path.join(tmp, "a"), argv)
        rc, _ = _cn_wait({"A": runs["A"]}, time.monotonic() + CN_TIMEOUT)["A"]
        if rc != 0:
            raise AssertionError(f"run A exited {rc}")
        log(f"  run A (no plan): {time.monotonic() - went:.1f} s")
        _sv_check(tmp, sv, os.path.join(tmp, "a", "snap", "alexnet"))
    finally:
        _ch_kill(runs)
        if sv is not None:
            sv.kill()


# ----------------------------------------------------------- catalogue
CAT_TOL = 1e-5  # relative L2, card vs CPU: element-wise, routing, losses
CAT_LONG = 1e-4  # long sums, products and recurrences, reduced in another order
CAT_CONV5 = (256, 13, 13, 256)  # AlexNet's conv5 activations at batch 256
CAT_T, CAT_N = 64, 256  # char_rnn's sequences for the recurrent layers
CHAR_TRAIN = (64, 64)  # T x N of the char_rnn training net
CHAR_ITERS = 12
LENET_TRAIN, LENET_TEST, LENET_ITERS = 10000, 1000, 300
LENET_MIN_ACC = 0.5  # chance is 0.1
CAT_TIMEOUT = 300  # seconds a caffe process may take


def _cat_cases():
    """(label, layer text, bottoms, tolerance): every layer type the
    port added after the image nets', at a realistic shape. A bottom is
    (kind, shape[, arg]): f normal floats, pos in [0.5, 2), lab labels
    below arg, bits 0/1, prob softmax rows, ids below arg, cont sequence
    markers, perm a permutation of the batch, const an array."""
    import numpy as np

    a = CAT_CONV5
    rec = ('weight_filler { type: "uniform" min: -0.08 max: 0.08 } '
           'bias_filler { type: "constant" }')
    h = np.abs(np.random.default_rng(9).normal(size=(1000, 1000))).astype(np.float32)
    return [
        ("Sigmoid", 'type: "Sigmoid"', [("f", a)], CAT_TOL),
        ("TanH", 'type: "TanH"', [("f", a)], CAT_TOL),
        ("AbsVal", 'type: "AbsVal"', [("f", a)], CAT_TOL),
        ("BNLL", 'type: "BNLL"', [("f", a)], CAT_TOL),
        ("ELU", 'type: "ELU" elu_param { alpha: 0.5 }', [("f", a)], CAT_TOL),
        ("Power", 'type: "Power" power_param { power: 2 scale: 0.5 shift: 1 }',
         [("f", a)], CAT_TOL),
        ("Exp", 'type: "Exp" exp_param { base: 2 scale: 0.5 }', [("f", a)], CAT_TOL),
        ("Log", 'type: "Log" log_param { scale: 2 shift: 0.5 }', [("pos", a)], CAT_TOL),
        ("Threshold", 'type: "Threshold" threshold_param { threshold: 0.25 }',
         [("f", a)], CAT_TOL),
        ("PReLU", 'type: "PReLU"', [("f", a)], CAT_TOL),
        ("PReLU shared", 'type: "PReLU" prelu_param { channel_shared: true }',
         [("f", a)], CAT_LONG),
        ("Bias", 'type: "Bias"', [("f", a)], CAT_LONG),
        ("Bias bottom", 'type: "Bias"', [("f", a), ("f", (256,))], CAT_LONG),
        ("Slice", 'type: "Slice" top: "a" top: "b" top: "c" slice_param { '
         'slice_point: 64 slice_point: 192 }', [("f", a)], CAT_TOL),
        ("Split", 'type: "Split" top: "a" top: "b"', [("f", a)], CAT_TOL),
        ("Flatten", 'type: "Flatten"', [("f", a)], CAT_TOL),
        ("Reshape", 'type: "Reshape" reshape_param { shape { dim: 0 dim: 128 dim: 26 '
         'dim: -1 } }', [("f", a)], CAT_TOL),
        ("Tile", 'type: "Tile" tile_param { axis: 1 tiles: 2 }', [("f", a)], CAT_TOL),
        ("Silence", 'type: "Silence"', [("f", a)], CAT_TOL),
        ("Reduction", 'type: "Reduction" reduction_param { operation: SUMSQ axis: 1 '
         'coeff: 0.5 }', [("f", a)], CAT_LONG),
        ("ArgMax", 'type: "ArgMax" argmax_param { top_k: 5 out_max_val: true }',
         [("f", (256, 1000))], CAT_TOL),
        ("ArgMax axis", 'type: "ArgMax" argmax_param { axis: 1 top_k: 3 }', [("f", a)],
         CAT_TOL),
        ("MVN", 'type: "MVN"', [("f", a)], CAT_LONG),
        ("MVN across", 'type: "MVN" mvn_param { across_channels: true }', [("f", a)],
         CAT_LONG),
        # FCN-32s's head: upscore 21 -> 21, kernel 64, stride 32, no bias;
        # then score's Crop to the 500 x 500 image
        ("Deconvolution", 'type: "Deconvolution" convolution_param { num_output: 21 '
         'kernel_size: 64 stride: 32 bias_term: false weight_filler { type: "bilinear" } }',
         [("f", (8, 16, 16, 21))], CAT_LONG),
        ("Crop", 'type: "Crop" crop_param { axis: 2 offset: 19 }',
         [("f", (8, 544, 544, 21)), ("f", (8, 500, 500, 3))], CAT_TOL),
        ("SPP", 'type: "SPP" spp_param { pyramid_height: 3 }', [("f", (64, 13, 13, 256))],
         CAT_LONG),
        ("Im2col", 'type: "Im2col" convolution_param { kernel_size: 3 pad: 1 }',
         [("f", (64, 13, 13, 256))], CAT_LONG),
        ("BatchReindex", 'type: "BatchReindex"', [("f", (256, 4096)), ("perm", (256,))],
         CAT_LONG),
        ("Parameter", 'type: "Parameter" parameter_param { shape { dim: 1000 dim: 4096 } }',
         [], CAT_TOL),
        ("SigmoidCrossEntropyLoss", 'type: "SigmoidCrossEntropyLoss"',
         [("f", (256, 1000)), ("bits", (256, 1000))], CAT_LONG),
        ("EuclideanLoss", 'type: "EuclideanLoss"', [("f", (256, 4096)), ("f", (256, 4096))],
         CAT_LONG),
        ("MultinomialLogisticLoss", 'type: "MultinomialLogisticLoss"',
         [("prob", (256, 1000)), ("lab", (256,), 1000)], CAT_LONG),
        ("InfogainLoss", 'type: "InfogainLoss"',
         [("prob", (256, 1000)), ("lab", (256,), 1000), ("const", h)], CAT_LONG),
        ("HingeLoss", 'type: "HingeLoss"', [("f", (256, 1000)), ("lab", (256,), 1000)],
         CAT_LONG),
        ("HingeLoss L2", 'type: "HingeLoss" hinge_loss_param { norm: L2 }',
         [("f", (256, 4096)), ("lab", (256,), 4096)], CAT_LONG),
        ("ContrastiveLoss", 'type: "ContrastiveLoss" contrastive_loss_param { margin: 40 }',
         [("f", (256, 4096)), ("f", (256, 4096)), ("bits", (256,))], CAT_LONG),
        ("Python", 'type: "Python" python_param { module: "chip_smoke" layer: "Swish" '
         'param_str: "1.5" }', [("f", a)], CAT_TOL),
        ("Embed", 'type: "Embed" embed_param { num_output: 16 input_dim: 96 '
         'weight_filler { type: "uniform" min: -0.08 max: 0.08 } }',
         [("ids", (CAT_T, CAT_N), 96)], CAT_LONG),
        ("LSTM", f'type: "LSTM" recurrent_param {{ num_output: 32 {rec} }}',
         [("f", (CAT_T, CAT_N, 16)), ("cont", (CAT_T, CAT_N))], CAT_LONG),
        ("RNN", f'type: "RNN" recurrent_param {{ num_output: 32 {rec} }}',
         [("f", (CAT_T, CAT_N, 16)), ("cont", (CAT_T, CAT_N))], CAT_LONG),
    ]



def _swish(inputs, param_str):
    import torch

    x = inputs[0]
    return [float(param_str) * x * torch.sigmoid(x)]


def _cat_inputs(bottoms, rng, cache):
    """numpy arrays, and whether each is a float input to differentiate.
    A float bottom's normals are drawn once for each (shape, position)
    and shared by the cases (``cache``)."""
    import numpy as np

    out = []
    for pos, b in enumerate(bottoms):
        kind, shape = b[0], b[1]
        if kind == "f":
            key = (shape, pos)
            if key not in cache:
                cache[key] = rng.standard_normal(shape, dtype=np.float32)
            out.append((cache[key], True))
        elif kind == "pos":
            out.append((rng.uniform(0.5, 2.0, shape).astype(np.float32), True))
        elif kind == "prob":
            z = np.exp(rng.standard_normal(shape))
            out.append(((z / z.sum(-1, keepdims=True)).astype(np.float32), True))
        elif kind in ("lab", "ids"):
            out.append((rng.integers(0, b[2], shape).astype(np.int32), False))
        elif kind == "bits":
            out.append((rng.integers(0, 2, shape).astype(np.float32), False))
        elif kind == "cont":
            c = np.ones(shape, np.float32)
            c[0] = 0.0
            c[shape[0] // 2, ::3] = 0.0  # every third sequence restarts mid-way
            out.append((c, False))
        elif kind == "perm":
            out.append((rng.permutation(shape[0]).astype(np.int32), False))
        else:  # const: the array itself
            out.append((shape, False))
    return out


def _cat_run(impl, lp, params, inputs, cots, device):
    """The layer on ``device``: its outputs, and the gradients of
    sum(output * cotangent) for the float inputs and the params."""
    import torch

    from sparknet_tpu_torch.nets.layers import ApplyCtx

    p = {k: v.to(device).requires_grad_(True) for k, v in params.items()}
    xs = [torch.from_numpy(a).to(device).requires_grad_(g) for a, g in inputs]
    outs = impl.apply(lp, p, xs, ApplyCtx(train=True))
    leaves = list(p.values()) + [x for x, (_, g) in zip(xs, inputs) if g]
    diff = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
    grads = [None] * len(leaves)
    if diff and leaves:
        loss = sum((o * c.to(device)).sum() for o, c in diff)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return ([o.detach().cpu() for o in outs],
            [None if g is None else g.cpu() for g in grads])


def _cat_layers():
    """Each case of :func:`_cat_cases` forward and backward on the card
    against the CPU: -> the worst reading."""
    import numpy as np
    import torch

    from sparknet_tpu_torch.nets import layers as L
    from sparknet_tpu_torch.proto.caffe_pb import LayerParameter
    from sparknet_tpu_torch.proto.textformat import parse

    L.register_python_layer("chip_smoke.Swish", _swish)
    worst = (0.0, "")
    covered = set()
    inputs_cache, cots_cache = {}, {}
    for i, (label, body, bottoms, tol) in enumerate(_cat_cases()):
        t0 = time.perf_counter()
        text = f'name: "{label.replace(" ", "_")}" {body}'
        if " top:" not in body:
            text += ' top: "y"'
        lp = LayerParameter.from_message(parse(text))
        impl = L.impl_for(lp)
        covered.add(lp.type)
        rng = np.random.default_rng(i)
        inputs = _cat_inputs(bottoms, rng, inputs_cache)
        shapes = [tuple(a.shape) for a, _ in inputs]
        out_shapes = impl.infer(lp, shapes)
        # the fillers' draws, and seeded normals in place of a constant
        # fill (Bias's and Parameter's zeros, PReLU's 0.25, the biases)
        params = {k: torch.from_numpy(0.5 * rng.standard_normal(tuple(v.shape),
                                                                dtype=np.float32))
                  if bool((v == v.reshape(-1)[0]).all()) else v
                  for k, v in impl.init(lp, torch.Generator().manual_seed(i), shapes).items()}
        cots = []
        for s_ in out_shapes:
            if tuple(s_) not in cots_cache:
                cots_cache[tuple(s_)] = torch.from_numpy(
                    rng.standard_normal(tuple(s_), dtype=np.float32))
            cots.append(cots_cache[tuple(s_)])
        card = _cat_run(impl, lp, params, inputs, cots, "cuda")
        cpu = _cat_run(impl, lp, params, inputs, cots, "cpu")
        reads = []
        for what, got, want in (
                [(f"out{j}", g, w) for j, (g, w) in enumerate(zip(card[0], cpu[0]))]
                + [(f"d{j}", g, w) for j, (g, w) in enumerate(zip(card[1], cpu[1]))]):
            if got is None and want is None:  # no path from the outputs (Threshold)
                continue
            if got is None or want is None or tuple(got.shape) != tuple(want.shape):
                raise AssertionError(f"{label} {what}: card {got if got is None else tuple(got.shape)}"
                                     f" cpu {want if want is None else tuple(want.shape)}")
            if got.dtype.is_floating_point:
                r = _rel(got, want) if want.abs().max() > 0 else float(got.abs().max())
            else:
                r = float((got != want).sum())
            if r > tol:
                raise AssertionError(f"{label} {what}: card vs CPU {r:.3e} > {tol:g}")
            reads.append(r)
            worst = max(worst, (r, f"{label} {what}"))
        if [tuple(o.shape) for o in card[0]] != [tuple(s) for s in out_shapes]:
            raise AssertionError(f"{label}: outputs {[tuple(o.shape) for o in card[0]]} "
                                 f"against infer's {out_shapes}")
        log(f"  {label} {shapes} -> {[tuple(s) for s in out_shapes]}: card vs CPU rel L2 "
            f"max {max(reads, default=0.0):.3e} over {len(reads)} tensors (tol {tol:g}); "
            f"{time.perf_counter() - t0:.2f} s")
    base = {"Convolution", "Pooling", "InnerProduct", "ReLU", "LRN", "Dropout", "Softmax",
            "SoftmaxWithLoss", "Accuracy", "Concat", "Eltwise", "Scale", "BatchNorm"}
    missing = set(L.LAYER_IMPLS) - base - covered
    if missing or len(L.LAYER_IMPLS) != 49:
        raise AssertionError(f"catalogue: no card case for {sorted(missing)}")
    torch.cuda.empty_cache()
    return worst


def _char_rnn_forward():
    """char_rnn_deploy at its declared T 16 x N 1 and at N 256, card vs CPU."""
    import numpy as np
    import torch

    from sparknet_tpu_torch.models import CHAR_RNN_DEPLOY
    from sparknet_tpu_torch.nets.torchnet import TorchNet
    from sparknet_tpu_torch.proto import caffe_pb

    net_param = caffe_pb.load_net(CHAR_RNN_DEPLOY)
    for n in (None, 256):
        shapes = None if n is None else {"data": (16, n), "cont": (16, n)}
        card = TorchNet(net_param, "TEST", shapes, device="cuda")
        cpu = TorchNet(net_param, "TEST", shapes, device="cpu")
        t, nn = card.blob_shapes["data"]
        params, state = cpu.init(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(nn)
        ids = torch.from_numpy(rng.integers(0, 96, (t, nn)).astype(np.int32))
        cont = torch.ones(t, nn)
        cont[0] = 0.0
        with torch.inference_mode():
            want, _ = cpu.apply(params, state, {"data": ids, "cont": cont})
            got, _ = card.apply({l: {k: v.cuda() for k, v in e.items()}
                                 for l, e in params.items()}, state,
                                {"data": ids.cuda(), "cont": cont.cuda()})
        rels = {b: _rel(got[b], want[b]) for b in ("emb", "hidden", "logits", "prob")}
        if max(rels.values()) > CAT_LONG or tuple(got["prob"].shape) != (t, nn, 96):
            raise AssertionError(f"char_rnn T {t} x N {nn}: card vs CPU {rels}")
        if not torch.isfinite(got["prob"]).all():
            raise AssertionError("char_rnn: non-finite probabilities")
        log(f"  char_rnn_deploy T {t} x N {nn}: prob {tuple(got['prob'].shape)}, card vs CPU "
            f"rel L2 " + ", ".join(f"{b} {r:.2e}" for b, r in rels.items())
            + f" (tol {CAT_LONG:g})")


def _char_rnn_text(host_read=False):
    """The char_rnn deploy net trained on next characters: the (T, N, V)
    logits reshaped to (T*N, V) for SoftmaxWithLoss, which takes Caffe's
    axis 1 whatever ``softmax_param.axis`` says, in both packages.
    ``host_read``: a Python layer that reads the logits back to the host
    first (a step that cannot be captured)."""
    from sparknet_tpu_torch.models import CHAR_RNN_DEPLOY

    text = open(CHAR_RNN_DEPLOY).read()
    text = text[:text.index('layer {\n  name: "prob"')]
    text = re.sub(r'input: "(data|cont)"\ninput_shape \{[^}]*\}\n', "", text)
    top = "logits"
    if host_read:
        text += ('layer { name: "peek" type: "Python" bottom: "logits" top: "peeked" '
                 'python_param { module: "chip_smoke" layer: "HostRead" } }\n')
        top = "peeked"
    return text + (f'layer {{ name: "flat" type: "Reshape" bottom: "{top}" top: "flat" '
                   'reshape_param { shape { dim: -1 dim: 96 } } }\n'
                   'layer { name: "loss" type: "SoftmaxWithLoss" bottom: "flat" '
                   'bottom: "label" top: "loss" }\n')


class _HostRead:
    """A Python layer that reads its bottom back to the host (which no
    capture holds) and passes it on."""

    @staticmethod
    def infer(lp, in_shapes):
        return [in_shapes[0]]

    @staticmethod
    def init(lp, gen, in_shapes):
        return {}

    @staticmethod
    def apply(lp, params, inputs, ctx):
        if float(inputs[0].sum()) == float("inf"):
            raise AssertionError("unreachable")
        return [inputs[0]]


def _char_solver(text, t, n):
    from sparknet_tpu_torch.proto import caffe_pb
    from sparknet_tpu_torch.solver.trainer import Solver

    sp = caffe_pb.load_solver('base_lr: 0.5 lr_policy: "step" gamma: 0.5 stepsize: 4 '
                              'momentum: 0.9 weight_decay: 0.0005 max_iter: 1000',
                              is_path=False)
    return Solver(sp, {"data": (t, n), "cont": (t, n), "label": (t * n,)},
                  net_param=caffe_pb.load_net(text, is_path=False), seed=0, device="cuda")


def _char_batches(t, n, count, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        # each sequence steps through a fixed cycle of the vocabulary from a
        # random start, so the next character can be learned
        ids = (rng.integers(0, 96, (1, n)) + 37 * np.arange(t + 1)[:, None]) % 96
        cont = np.ones((t, n), np.float32)
        cont[0] = 0.0
        out.append({"data": ids[:-1].astype(np.int32), "cont": cont,
                    "label": ids[1:].reshape(-1).astype(np.int32)})
    return out


def _char_rnn_train():
    """The char_rnn training net through ``Solver.step``, the captured
    graph against the eager step: bit for bit; -> ms a step both ways."""
    import itertools

    import torch

    t, n = CHAR_TRAIN
    text = _char_rnn_text()
    batches = _char_batches(t, n, CHAR_ITERS)
    runs = {}
    for fused in (True, False):
        s = _char_solver(text, t, n)
        s._fuse_host = fused
        losses = [float(s.step(iter([b]), 1)["loss"]) for b in batches]
        torch.cuda.synchronize()
        if fused and (s._graph is None or s._graph.graph is None):
            raise AssertionError("char_rnn: the step was not captured")
        ms = _step_ms(s, itertools.repeat(batches[0]), reps=20)
        runs[fused] = (losses, [(k, v.clone()) for k, v in _leaf_items(s)],
                       s.rng.get_state(), ms)
        del s
    (lg, leaves_g, rng_g, ms_g), (le, leaves_e, rng_e, ms_e) = runs[True], runs[False]
    # the leaves after the 12 iterations, before the timed steps, are what
    # the losses came from; the timed steps ran the same batch both ways too
    diff = [k for (k, a), (_, b) in zip(leaves_g, leaves_e) if not torch.equal(a, b)]
    if lg != le or diff or not torch.equal(rng_g, rng_e):
        raise AssertionError(f"char_rnn: graph vs eager not bit for bit: losses {lg} / {le}; "
                             f"leaves {diff[:5]}")
    if not lg[-1] < lg[0]:
        raise AssertionError(f"char_rnn: the loss did not fall: {lg}")
    log(f"  char_rnn train T {t} x N {n}: {CHAR_ITERS} + 20 iterations graph vs eager bit "
        f"for bit (losses {lg[0]:.5f} .. {lg[-1]:.5f}, {len(leaves_g)} leaves); step "
        f"graph {ms_g[0]:.3f} ms (host {ms_g[1]:.3f}), eager {ms_e[0]:.3f} ms "
        f"(host {ms_e[1]:.3f})")
    return ms_g[0], ms_e[0]


def _capture_repair():
    """A step whose Python layer reads the card from the host: its capture
    fails, three times, and after ``empty_cache()`` the card's reserved
    memory is back at its level before the capture each time."""
    import torch

    from sparknet_tpu_torch.nets import layers as L
    from sparknet_tpu_torch.solver.trainer import WARMUP_STEPS

    L.register_python_layer("chip_smoke.HostRead", _HostRead)
    t, n = CAT_T, CAT_N
    s = _char_solver(_char_rnn_text(host_read=True), t, n)
    batches = _char_batches(t, n, WARMUP_STEPS + 1, seed=1)
    s.step(iter(batches[:WARMUP_STEPS]), WARMUP_STEPS)  # eager, on the side stream
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    reads = []
    for i in range(3):
        try:  # the first try captures at once, each later one warms up anew
            s.step(iter(batches[WARMUP_STEPS if i == 0 else 0:]), 1 if i == 0 else
                   WARMUP_STEPS + 1)
        except RuntimeError as e:
            if "SPARKNET_FUSED_STEP=0" not in str(e) or e.__cause__ is None:
                raise
        else:
            raise AssertionError("a step that reads the card was captured")
        if s._graph is not None:
            raise AssertionError("the failed capture's _StepGraph is still set")
        held = torch.cuda.memory_reserved()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reads.append((held, torch.cuda.memory_reserved()))
    if any(after > before for _, after in reads):
        raise AssertionError(f"reserved memory after a failed capture and empty_cache: "
                             f"{[a for _, a in reads]} > {before} before")
    log(f"  capture repair: 3 failed captures (a Python layer reads the card), _graph None "
        f"after each; reserved {before / 2 ** 20:.1f} MiB before, "
        + ", ".join(f"{h / 2 ** 20:.1f} -> {a / 2 ** 20:.1f}" for h, a in reads)
        + " MiB after each failure -> after empty_cache()")
    del s
    return before, reads


def _write_mnist(tmp, name, n, rng):
    """MNIST idx files of ``n`` digits: a bar whose row is the class, a
    column band whose place is the class, and seeded noise."""
    import struct

    import numpy as np

    labels = rng.integers(0, 10, n).astype(np.uint8)
    base = np.zeros((10, 28, 28), np.float32)
    for c in range(10):
        base[c, 3 + 2 * c:5 + 2 * c, 4:24] += 90
        base[c, 4:24, 3 + 2 * c:5 + 2 * c] += 60
    imgs = np.clip(base[labels] + rng.normal(70, 60, (n, 28, 28)), 0, 255).astype(np.uint8)
    paths = (os.path.join(tmp, f"{name}-images-idx3-ubyte"),
             os.path.join(tmp, f"{name}-labels-idx1-ubyte"))
    with open(paths[0], "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with open(paths[1], "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return paths


def _caffe_tool(tmp, argv):
    """``python -m sparknet_tpu_torch.tools.caffe`` started in ``tmp``:
    -> (process, its output file's path, start time)."""
    env = dict(os.environ, PYTHONUNBUFFERED="1",
               PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH"))
                                          if p))
    path = os.path.join(tmp, f"caffe_{argv[0]}.log")
    with open(path, "w") as out:
        proc = subprocess.Popen([sys.executable, "-m", "sparknet_tpu_torch.tools.caffe",
                                 *argv], cwd=tmp, env=env, stdout=out,
                                stderr=subprocess.STDOUT)
    return proc, path, time.perf_counter()


def _caffe_wait(run, what):
    """Wait for a :func:`_caffe_tool` process: -> (its output, seconds)."""
    proc, path, t0 = run
    try:
        proc.wait(CAT_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    with open(path) as f:
        out = f.read()
    if proc.returncode:
        for line in out.splitlines()[-40:]:
            log(f"  caffe {what} | {line}")
        raise AssertionError(f"caffe {what} exited {proc.returncode}")
    return out, time.perf_counter() - t0


def _lenet_train(tmp):
    """LeNet through the port's tools: MNIST idx files, convert_mnist_data,
    then ``caffe train`` as a process. -> (the last TEST accuracy as
    printed, images/s of the last ``speed:`` line)."""
    import numpy as np

    from sparknet_tpu_torch.models import LENET_SOLVER, LENET_TRAIN_TEST
    from sparknet_tpu_torch.tools import convert_mnist_data

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    for split, n, db in (("train", LENET_TRAIN, "mnist_train_lmdb"),
                         ("t10k", LENET_TEST, "mnist_test_lmdb")):
        imgs, labs = _write_mnist(tmp, split, n, rng)
        if convert_mnist_data.convert(imgs, labs, os.path.join(tmp, db)) != n:
            raise AssertionError(f"convert_mnist_data: not {n} records")
    with open(LENET_TRAIN_TEST) as src, open(os.path.join(tmp, "lenet_train_test.prototxt"),
                                              "w") as dst:
        dst.write(src.read())
    solver = re.sub(r"test_iter: \d+", f"test_iter: {LENET_TEST // 100}",
                    open(LENET_SOLVER).read())
    with open(os.path.join(tmp, "lenet_solver.prototxt"), "w") as f:
        f.write(solver)
    t_data = time.perf_counter() - t0
    out, t_train = _caffe_wait(_caffe_tool(tmp, ["train", "--solver=lenet_solver.prototxt",
                                                 "--max-iter", str(LENET_ITERS)]), "train")
    accs = re.findall(r"Test net output: accuracy = (\S+)", out)
    speeds = re.findall(r"speed: .*images/s=(\S+)", out)
    if not accs or not speeds or "Optimization Done" not in out:
        raise AssertionError(f"caffe train printed no test accuracy or speed: {out[-2000:]}")
    if float(accs[-1]) < LENET_MIN_ACC:
        raise AssertionError(f"LeNet's TEST accuracy {accs[-1]} < {LENET_MIN_ACC}")
    log(f"  LeNet: {LENET_TRAIN} + {LENET_TEST} digits written and converted in {t_data:.1f} s;"
        f" caffe train {LENET_ITERS} iterations at batch 64 in {t_train:.1f} s (process), "
        f"TEST accuracy {accs[0]} -> {accs[-1]} (>= {LENET_MIN_ACC}); speed: {speeds[-1]} "
        f"images/s (its last chunk)")
    return accs[-1], float(speeds[-1])


def _lenet_test(tmp):
    """``caffe test`` of the LeNet run's snapshot, started as a process."""
    return _caffe_tool(tmp, ["test", "--model=lenet_train_test.prototxt",
                             f"--weights=lenet_iter_{LENET_ITERS}.solverstate.npz",
                             "--iterations", str(LENET_TEST // 100)])


def _lenet_tested(run, acc):
    """The ``caffe test`` process's accuracy must be the run's last test's."""
    out, seconds = _caffe_wait(run, "test")
    again = re.findall(r"^accuracy = (\S+)", out, re.M)
    if again != [acc]:
        raise AssertionError(f"caffe test of the snapshot: accuracy {again}, caffe train's "
                             f"last test {acc}")
    log(f"  LeNet: caffe test of lenet_iter_{LENET_ITERS}.solverstate.npz: accuracy {again[0]}, "
        f"as caffe train's last test ({seconds:.1f} s, beside the checks above)")


def phase_catalogue(tmp):
    """Caffe's whole layer catalogue on the card (module docstring, phase
    catalogue): -> its readings. LeNet's ``caffe train`` runs alone;
    its ``caffe test`` process runs beside the checks after it."""
    t_phase = time.perf_counter()
    smi = _smi()
    before = _counts()
    acc, speed = _lenet_train(tmp)
    test_run = _lenet_test(tmp)
    try:
        with _deterministic():
            worst = _cat_layers()
            log(f"  catalogue: worst card vs CPU reading {worst[0]:.3e} ({worst[1]})")
            _char_rnn_forward()
            ms_graph, ms_eager = _char_rnn_train()
            _capture_repair()
    finally:
        _lenet_tested(test_run, acc)
    if _counts() != before:
        raise AssertionError(f"catalogue: kernel launches moved {before} -> {_counts()}")
    seconds = time.perf_counter() - t_phase
    log(f"  catalogue on {smi}: LeNet {speed:.0f} images/s, TEST accuracy {acc}; char_rnn "
        f"step {ms_graph:.3f} ms graph, {ms_eager:.3f} ms eager; {seconds:.1f} s")
    return {"lenet_images_per_s": speed, "lenet_acc": float(acc),
            "char_rnn_ms": (ms_graph, ms_eager), "seconds": seconds}


# ------------------------------------------------------------------ ab
AB_FWD = ((BERT_BATCH, BERT_SEQ, "float32"), (8, 512, "float32"),
          (BERT_BATCH, BERT_SEQ, "bfloat16"))


def _ab_lrn(gen):
    """``--ab``'s LRN timings, f32, AlexNet's two LRN layers summed: the
    three kernels at batch 256 and the inference forward at serving
    bucket 32, each by single calls, back to back, the profiler's device
    time (LRN_TAGS) and the host's time per call (per two calls, one per
    layer)."""
    import torch

    from sparknet_tpu_torch.ops import lrn as TL

    p = LRN_GEOM
    out = {}
    for n, kinds in ((TRAIN_BATCH, ("lrn_fwd", "lrn_fwd_train", "lrn_bwd")),
                     (32, ("lrn_fwd",))):
        layers = {kind: [] for kind in kinds}
        for _, hw, c in ALEXNET_LRN:
            x = torch.relu(torch.randn(n * hw, c, generator=gen, device="cuda"))
            g = torch.randn(n * hw, c, generator=gen, device="cuda")
            _, d = TL.lrn_rows_train(x, p["size"], p["alpha"], p["beta"], p["k"])
            calls = {
                "lrn_fwd": lambda: TL.lrn_rows(x, p["size"], p["alpha"], p["beta"], p["k"]),
                "lrn_fwd_train": lambda: TL.lrn_rows_train(x, p["size"], p["alpha"], p["beta"],
                                                           p["k"]),
                "lrn_bwd": lambda: TL.lrn_rows_bwd(g, x, d, p["size"], p["alpha"], p["beta"]),
            }
            for kind in kinds:
                fn = calls[kind]
                layers[kind].append(dict(
                    ms=_time_ms(fn), loop_ms=_time_loop_ms(fn),
                    device_ms=_device_ms(fn, LRN_TAGS[kind]), host_ms=_host_ms(fn, n=50)))
            del x, g, d, calls
        for kind, rows in layers.items():
            out[f"{kind} B{n} f32 (norm1 + norm2)"] = {
                key: None if None in vals else sum(vals)
                for key, vals in ((key, [r[key] for r in rows]) for key in rows[0])}
    return out


def _ab_alexnet():
    """``--ab``'s AlexNet end-to-end numbers: ms per ``Solver.step`` on
    one device-resident batch of 256 (CUDA events, and the host clock),
    and the bucket-32 serving forward: ``engine.infer`` (median of 20,
    host clock, upload + forward + download) and the net's forward alone
    on a resident batch (CUDA events, median of 20)."""
    import numpy as np
    import torch

    from sparknet_tpu_torch.models import ALEXNET_DEPLOY
    from sparknet_tpu_torch.serve.engine import InferenceEngine

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ab_") as tmp:
        solver, feed = _alexnet_resident(tmp)
        solver.step(feed, 3)  # warm: cuDNN algorithm choice, allocator
        out["alexnet step f32 B256"] = dict(zip(("ms", "host_clock_ms"), _step_ms(solver, feed)))
        del solver, feed
        torch.cuda.empty_cache()
        out.update(_ab_zoo_steps(tmp))
    torch.cuda.empty_cache()
    eng = InferenceEngine.from_files(ALEXNET_DEPLOY, device="cuda", buckets=(32,))
    eng.warmup()
    x = np.random.default_rng(0).normal(size=(32,) + eng._row_shapes["data"]).astype(np.float32)
    times = []
    for _ in range(22):
        t0 = time.perf_counter()
        eng.infer(x)
        times.append((time.perf_counter() - t0) * 1e3)
    params, state, _, _ = eng._weights_snapshot()
    xd = torch.from_numpy(x).cuda()
    out["alexnet bucket 32 f32"] = dict(
        infer_ms=statistics.median(times[2:]),
        forward_ms=_time_ms(lambda: eng.net.apply(params, state, {"data": xd}, train=False),
                            reps=20))
    return out


def _ab_zoo_steps(tmp):
    """``--ab``'s GoogLeNet and ResNet-50 steps: ms per ``Solver.step`` on
    one device-resident batch of the prototxt's (32 each), f32 and
    ``--bf16`` (CUDA events, and the host clock), after 3 to warm."""
    import itertools

    import torch

    from sparknet_tpu_torch.apps import imagenet_app

    out = {}
    for arch in ("googlenet", "resnet50"):
        for bf16 in (False, True):
            args = imagenet_app.make_args(arch=arch, synthetic=True, synthetic_n=64,
                                          solver=_zoo_solver_file(tmp, arch), device="cuda",
                                          bf16=bf16)
            solver, train_feed, test_feed = imagenet_app.build(args)
            feed = itertools.repeat(solver._put_batch(next(train_feed)))
            _close(train_feed, test_feed)
            solver.step(feed, 3)
            bs = solver.train_net.blob_shapes["data"][0]
            out[f"{arch} step {'bf16' if bf16 else 'f32'} B{bs}"] = dict(
                zip(("ms", "host_clock_ms"), _step_ms(solver, feed)))
            del solver, feed
            torch.cuda.empty_cache()
    return out


def ab_side(root):
    """One process of ``--ab``: the port under ``root`` measured; one JSON
    line."""
    import torch

    sys.path.insert(0, root)
    from sparknet_tpu_torch.ops import _build
    from sparknet_tpu_torch.ops import attention as TA

    if not os.path.abspath(TA.__file__).startswith(os.path.abspath(root) + os.sep):
        raise RuntimeError(f"imported {TA.__file__}, not the port under {root}")
    _build.build_all(["attention", "lrn"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": root}
    out.update(_ab_lrn(gen))
    torch.cuda.empty_cache()
    for b, s, dt in AB_FWD:
        case = (f"B={b} S={s}", b, BERT_HEADS, s, s, BERT_HEAD_DIM, False, 0, 0, False,
                FLASH_DROPOUT)
        inputs = _flash_inputs(case, getattr(torch, dt), gen)
        for name, (kernel, _, library) in _flash_calls(inputs).items():
            out[f"{name} B{b} S{s} {dt}"] = dict(
                ms=_time_ms(kernel), library_ms=_time_ms(library), host_ms=_host_ms(kernel),
                **_more_times(kernel, library, FLASH_TAGS[name]))
        del inputs
    out.update(_ab_alexnet())
    torch.cuda.empty_cache()
    for bf16 in (False, True):
        solver, feed = _bert_resident(bf16)
        solver.step(feed, 3)  # warm: allocator, library handles
        out[f"bert step {'bf16' if bf16 else 'f32'}"] = dict(
            zip(("ms", "host_clock_ms"), _step_ms(solver, feed)))
        del solver, feed
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def ab(other):
    """``--ab``: the port under ``other`` and this one on one card, in four
    processes in turn (other, this, this, other), each printing one line;
    then each number of the two sides beside each other."""
    other = os.path.abspath(other)
    if not os.path.isdir(os.path.join(other, "sparknet_tpu_torch")):
        print(f"chip_smoke --ab: no sparknet_tpu_torch package under {other}", file=sys.stderr)
        return 2
    phase_card()
    runs = []
    for root in (other, ROOT, ROOT, other):
        log(f"ab: {root}")
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--ab-side", root],
                           capture_output=True, text=True, timeout=900)
        if p.returncode:
            log(p.stdout[-4000:])
            log(p.stderr[-4000:])
            log(f"chip_smoke --ab: the process for {root} exited {p.returncode}")
            return 1
        runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
        log(json.dumps(runs[-1]))
    for key, first in runs[0].items():
        if key == "root":
            continue
        for what in first:
            log(f"ab {key} {what}: other {[runs[i][key][what] for i in (0, 3)]}, "
                f"this {[runs[i][key][what] for i in (1, 2)]}")
    return 0


# ------------------------------------------------------------- telemetry
TEL_ITERS = 12  # ImageNetApp iterations of each traced run
TEL_REMAT_ITERS = 6
TEL_APP_TIMEOUT = 240  # seconds the app run may take
TEL_ATTRIBUTED = 0.90  # the timeline's rows must cover this share of the loop
TEL_RANK_ROUNDS = 20  # local rounds (tau 2-4) of the two-rank straggler run
TEL_TRACED_REPLAYS = 5  # remat replays under torch.profiler, held one by one


def _tel_solver_file(tmp, net, iters, test_interval, base_lr=0.01, tag="app"):
    # a file of its own a user (``tag``): the app's process reads its
    # solver while the remat runs write theirs
    path = os.path.join(tmp, f"tel_{tag}_{os.path.basename(net)}_solver.prototxt")
    with open(path, "w") as f:
        f.write(f'net: "{net}"\ntest_iter: 1\ntest_interval: {test_interval}\n'
                f'base_lr: {base_lr}\nlr_policy: "fixed"\ndisplay: 6\nmax_iter: {iters}\n'
                "momentum: 0.9\nweight_decay: 0.0005\n")
    return path


def _tel_app_start(tmp):
    """ImageNetApp traced and profiled, an ``--app-job`` process set
    going. -> (the run, the monotonic time it went)."""
    from sparknet_tpu_torch.models import ALEXNET_TRAIN_VAL

    solver = _tel_solver_file(tmp, ALEXNET_TRAIN_VAL, TEL_ITERS, 6)
    argv = ["--arch", "alexnet", "--synthetic", "--synthetic-n", "512", "--solver", solver,
            "--device", "cuda", "--native-loader", "off", "--data-workers", "2", "--trace",
            os.path.join(tmp, "trace.json"), "--profile-dir", os.path.join(tmp, "prof")]
    run = _cn_start(tmp, "tel_app")
    return run, _cn_go(run, os.path.join(tmp, "cwd_app"), argv)


def _tel_app_wait(run, t0):
    """-> (its output, its launches, its last speed line)."""
    res = _cn_wait({"app": run}, t0 + TEL_APP_TIMEOUT)["app"]
    if res[0] != 0:
        raise AssertionError(f"ImageNetApp traced + profiled: exit {res[0]}")
    speeds = re.findall(r"speed: (.*)", res[1])
    launches = _cn_job("app", res[1])["launches"]
    log(f"  ImageNetApp traced + profiled: {time.monotonic() - t0:.1f} s, last speed: "
        f"{speeds[-1]}, LRN launches {launches}")
    return res[1], launches, speeds[-1]


def _tel_check_trace(tmp, text, launches):
    """The traced and profiled run: its Chrome trace, its breakdown, and
    its profiler trace's LRN kernels against its launch counters."""
    with open(os.path.join(tmp, "trace.json")) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    names = {e["name"] for e in events}
    want = {"input_wait", "device_put", "compiled_step", "eval", "pipeline.produce"}
    if not want <= names:
        raise AssertionError(f"trace: phases {sorted(want - names)} missing")
    pids = {e["pid"] for e in events if e["name"] == "pipeline.produce"}
    table = text[text.index("telemetry: step-time breakdown"):].splitlines()
    for line in table[:10]:
        log(f"  | {line}")
    m = re.search(r"attributed ([\d.]+)% of ([\d.]+)s loop wall time", text)
    if m is None or float(m.group(1)) / 100 < TEL_ATTRIBUTED:
        raise AssertionError(f"timeline attributed {m and m.group(1)}% < "
                             f"{100 * TEL_ATTRIBUTED:.0f}%")
    prof = os.path.join(tmp, "prof")
    files = [os.path.join(prof, f) for f in os.listdir(prof) if f.endswith(".json")]
    with open(files[0]) as f:
        kernels = [e["name"] for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"]
    seen = (sum("lrn_fwd_rows" in k for k in kernels), sum("lrn_bwd_rows" in k for k in kernels))
    moved = (launches[0] + launches[1], launches[2])
    log(f"  Chrome trace: {len(events)} events, {len(pids)} worker processes merged; "
        f"timeline {m.group(1)}% of {m.group(2)} s; profiler trace ({os.path.getsize(files[0])} "
        f"bytes): {seen[0]} lrn_fwd_rows, {seen[1]} lrn_bwd_rows kernels = counters {moved}")
    if seen != moved or len(pids) != 2:
        raise AssertionError(f"profiler LRN kernels {seen} != counters {moved}, or "
                             f"{len(pids)} worker pids")


# host wait between a profiler window's start and its first traced step,
# and between its last traced step's end and the window's stop
TRACE_LEAD_S = 0.1


def _traced_per_replay(label, step, replays, graph=True):
    """``replays`` calls of ``step`` (one solver step each) under
    ``torch.profiler``, after one it traces and drops (its schedule's
    warm-up: a window's first step has lost records while tracing
    started), the card synchronized only around the traced steps. Through
    the graph (``graph``), the trace's LRN and flash kernels grouped by
    the ``cudaGraphLaunch`` they belong to (the correlation id the trace
    gives both), each replay held to the launch counters' increase a
    replay: a replay runs every node of its graph, so the phase fails if
    any replay's trace holds another count, or if the trace misses a
    replay. Eager, the kernels summed over the traced steps held to the
    counters' increase over those steps. The profiler keeps a device
    record only if its time, mapped onto the host's clock, falls inside
    the window; the window's first traced step starts TRACE_LEAD_S after
    it opens, and it closes TRACE_LEAD_S after the last one has ended on
    the card, so that a record near either edge is not dropped. Through
    the graph, the trace's own margins are returned: how long after its
    ``cudaGraphLaunch`` each replay's first kernel record starts (the
    least, negative if the card's records are mapped before the host's
    call), and the first record's distance from the first traced step's
    start and the last record's from the last step's end. ->
    {"kernels": {TRACE_KERNELS part: a step's}, "events": the traced
    steps' ``key_averages()``, "wall_us": the host's time a traced step,
    "out": the last step's return, "margins_us": those three, or None}."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=replays, repeat=1)) as prof:
        step()
        torch.cuda.synchronize()
        prof.step()
        # device records stamped near the window's start have gone missing
        # (one flash kernel of the first traced BERT replay; every LRN
        # forward of three GoogLeNet replays): the first traced step is
        # launched TRACE_LEAD_S after the start
        time.sleep(TRACE_LEAD_S)
        before = _counts()
        t0 = time.perf_counter()
        for i in range(replays):
            out = step()
            if i == replays - 1:
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) / replays * 1e6
                time.sleep(TRACE_LEAD_S)
            prof.step()
    moved = {k: v - before[k] for k, v in _counts().items()}
    events = prof.key_averages()
    kernels = {}
    launches = []
    margins = None
    if graph:
        with tempfile.NamedTemporaryFile(suffix=".json") as f:
            prof.export_chrome_trace(f.name)
            trace = json.load(open(f.name))["traceEvents"]
        launches = [e["args"]["correlation"] for e in trace
                    if e.get("name") == "cudaGraphLaunch" and "correlation" in e.get("args", {})]
        for e in trace:
            cid = e.get("args", {}).get("correlation")
            if e.get("cat") == "kernel" and cid is not None:
                kernels.setdefault(cid, []).append(e["name"])
        margins = _trace_margins(trace, launches)
    seen = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    out_kernels = {}
    for wrappers, part in TRACE_KERNELS:
        want, rest = divmod(sum(moved[w] for w in wrappers), replays)
        if graph:
            per = [sum(part in k for k in kernels.get(cid, ())) for cid in launches]
            if rest or per != [want] * replays:
                log(_trace_miss_report(trace, part, launches))
                raise AssertionError(f"{label}: {part}* kernels by traced replay {per}, the "
                                     f"launch counters {'+'.join(wrappers)} {want} a replay "
                                     f"({replays} replays, remainder {rest})")
        else:
            total = sum(e.count for e in seen if part in e.key)
            if total != want * replays + rest:
                raise AssertionError(f"{label}: torch.profiler saw {total} {part}* kernels in "
                                     f"{replays} steps, the launch counters "
                                     f"{'+'.join(wrappers)} moved by {want * replays + rest}")
        out_kernels[part] = want
    return {"kernels": out_kernels, "events": events, "wall_us": wall_us, "out": out,
            "margins_us": margins}


def _annotation(e):
    """Is profiler event ``e`` a user annotation (a ``record_function``
    span, ``ProfilerStep#N`` among them), on the host or on the card?"""
    return bool(getattr(e, "is_user_annotation", False)) or e.key.startswith("ProfilerStep#")


def _trace_margins(trace, launches):
    """(least µs from a ``cudaGraphLaunch`` to its replay's first kernel
    record, µs from the first traced ``ProfilerStep`` span's start to the
    first kernel record, µs from the last kernel record's end to the last
    span's end) of a graph window's trace; None without spans or
    records."""
    host = {e["args"]["correlation"]: e["ts"] for e in trace
            if e.get("name") == "cudaGraphLaunch" and "correlation" in e.get("args", {})}
    ks = [e for e in trace if e.get("cat") == "kernel"]
    # the host's spans (the card's own ProfilerStep annotations cover
    # only their kernels)
    steps = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in trace
                   if str(e.get("name", "")).startswith("ProfilerStep#")
                   and e.get("cat") == "user_annotation")
    first = {}
    for k in ks:
        cid = k.get("args", {}).get("correlation")
        if cid in host:
            first[cid] = min(first.get(cid, k["ts"]), k["ts"])
    if not steps or not ks or not first:
        return None
    return (round(min(first[c] - host[c] for c in first), 1),
            round(min(k["ts"] for k in ks) - steps[0][0], 1),
            round(steps[-1][1] - max(k["ts"] + k.get("dur", 0) for k in ks), 1))


def _trace_miss_report(trace, part, launches):
    """What a trace held where a per-replay check missed: each profiler
    step's span, each graph launch (its correlation id, host time, and the
    kernel records of that id: how many, how many named ``part``, the
    first's start and the last's end), the ``part`` records by correlation
    id, and the kernel records of no graph launch; times in µs from the
    first ``ProfilerStep`` span's start."""
    steps = sorted((e["ts"], e.get("dur", 0), e["name"]) for e in trace
                   if str(e.get("name", "")).startswith("ProfilerStep#")
                   and e.get("cat") == "user_annotation")
    t0 = steps[0][0] if steps else min(e["ts"] for e in trace if "ts" in e)
    rel = lambda t: f"{t - t0:.1f}"
    by_cid = {}
    for e in trace:
        cid = e.get("args", {}).get("correlation")
        if e.get("cat") == "kernel" and cid is not None:
            by_cid.setdefault(cid, []).append(e)
    lines = [f"  trace at the miss ({part}*): {len(trace)} events, kernel records "
             f"{sum(len(v) for v in by_cid.values())}; profiler steps "
             + ", ".join(f"{n} [{rel(ts)}, {rel(ts + d)}]" for ts, d, n in steps)]
    host = {e["args"]["correlation"]: e for e in trace
            if e.get("name") == "cudaGraphLaunch" and "correlation" in e.get("args", {})}
    for cid in launches:
        ks = by_cid.get(cid, [])
        lines.append(
            f"    graph launch {cid} at {rel(host[cid]['ts'])}: {len(ks)} kernel records, "
            f"{sum(part in k['name'] for k in ks)} {part}*"
            + (f", from {rel(min(k['ts'] for k in ks))} to "
               f"{rel(max(k['ts'] + k.get('dur', 0) for k in ks))}" if ks else ""))
    held = [(k["args"]["correlation"], rel(k["ts"])) for ks in by_cid.values() for k in ks
            if part in k["name"]]
    lines.append(f"    {part}* records (correlation, start): {sorted(held)}")
    stray = [k for cid, ks in by_cid.items() if cid not in host for k in ks]
    lines.append(f"    kernel records of no graph launch: {len(stray)}"
                 + (f", from {rel(min(k['ts'] for k in stray))} to "
                    f"{rel(max(k['ts'] for k in stray))}, names "
                    f"{sorted({k['name'][:40] for k in stray})[:8]}" if stray else ""))
    return "\n".join(lines)


def _tel_tree(tree):
    return {l: {n: t.detach().cpu().clone() for n, t in e.items()} for l, e in tree.items()}


def _tel_equal(label, a, b):
    import torch

    bad = [f"{l}.{n}" for l, e in a.items() for n, t in e.items()
           if not torch.equal(t, b[l][n])]
    if bad:
        raise AssertionError(f"{label}: remat and plain differ in {bad[:5]} ({len(bad)})")


def _tel_remat_run(make, label, tags):
    """``make(remat)``'s ``(solver, host batches)`` through the captured
    step on those batches (device-resident), plain then remat,
    deterministic: every metric of every iteration, params and net state
    bit for bit; peak memory over the run, ms a step (10 replays; plain's
    also with the timeline's fence), the launch counters' increase;
    TEL_TRACED_REPLAYS remat replays held to the profiler; the seconds
    each way took."""
    import itertools

    import torch

    from sparknet_tpu_torch.telemetry.timeline import NULL, Timeline

    res = {}
    for remat in (False, True):
        t0 = time.perf_counter()
        with _deterministic():
            solver, batches = make(remat)
            feed = [solver._put_batch(b) for b in batches]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            before = _counts()
            losses = [tuple(float(v) for v in solver.step(iter([b]), 1).values())
                      for b in feed]
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            moved = {k: v - before[k] for k, v in _counts().items()}
            params, state = _tel_tree(solver.params), _tel_tree(solver.state)
            ms, _ = _step_ms(solver, itertools.repeat(feed[-1]), 10)
            fence = None
            if not remat:  # the timeline's fence: the same replays, fenced
                solver.timeline = Timeline()
                fence, _ = _step_ms(solver, itertools.repeat(feed[-1]), 10)
                solver.timeline = NULL
            if remat:
                same = itertools.repeat(feed[-1])
                traced = _traced_per_replay(f"{label} remat", lambda: solver.step(same, 1),
                                            TEL_TRACED_REPLAYS)["kernels"]
            res[remat] = dict(losses=losses, params=params, state=state, peak=peak, ms=ms,
                              moved=moved, fence=fence, s=time.perf_counter() - t0)
            del solver, feed
            gc.collect()
            torch.cuda.empty_cache()
    plain, remat = res[False], res[True]
    if plain["losses"] != remat["losses"] or not all(
            math.isfinite(v) for m in remat["losses"] for v in m):
        raise AssertionError(f"{label}: metrics plain {plain['losses']} remat {remat['losses']}")
    _tel_equal(f"{label} params", plain["params"], remat["params"])
    _tel_equal(f"{label} state", plain["state"], remat["state"])
    log(f"  {label}: remat = plain bit for bit over {len(remat['losses'])} iterations "
        f"(metrics {remat['losses'][0]} .. {remat['losses'][-1]}, params, net state); peak "
        f"memory allocated {plain['peak']:.3f} -> {remat['peak']:.3f} GiB, "
        f"{plain['ms']:.3f} -> {remat['ms']:.3f} ms a step (plain with the timeline's "
        f"fence {plain['fence']:.3f}); launches plain "
        + ", ".join(f"{k} {plain['moved'][k]}" for k in tags) + "; remat "
        + ", ".join(f"{k} {remat['moved'][k]}" for k in tags)
        + f"; traced remat replays, kernels a replay {traced}; {plain['s']:.1f} s plain, "
        f"{remat['s']:.1f} s remat")
    return {"plain": plain, "remat": remat, "moved": {
        k: plain["moved"][k] + remat["moved"][k] for k in plain["moved"]}}


def _tel_remat(tmp):
    """--remat through the graph step: AlexNet at 256, ResNet-50 at 32,
    BERT-base at 32 x 128 f32 and bf16 (module docstring)."""
    import numpy as np
    import torch

    from sparknet_tpu_torch.apps import bert_app
    from sparknet_tpu_torch.models import ALEXNET_TRAIN_VAL, RESNET50_TRAIN_VAL
    from sparknet_tpu_torch.proto import caffe_pb
    from sparknet_tpu_torch.solver.trainer import Solver

    out = {}
    for name, net, batch, hw in (("AlexNet", ALEXNET_TRAIN_VAL, 256, 227),
                                 ("ResNet-50", RESNET50_TRAIN_VAL, 32, 224)):
        path = _tel_solver_file(tmp, net, 1000, 1000, tag="remat")
        shapes = {"data": (batch, hw, hw, 3), "label": (batch,)}

        batches = [_mp_batch(7, i, batch, hw, 1000) for i in range(TEL_REMAT_ITERS)]

        def make(remat, path=path, shapes=shapes, batches=batches):
            return Solver(caffe_pb.load_solver(path), shapes, solver_dir=tmp, seed=0,
                          device="cuda", remat=remat), batches

        r = _tel_remat_run(make, f"{name} batch {batch}", ("lrn_rows_train", "lrn_rows_bwd"))
        if name == "AlexNet":
            p, q = r["plain"]["moved"], r["remat"]["moved"]
            if q["lrn_rows_train"] != 2 * p["lrn_rows_train"] or (
                    q["lrn_rows_bwd"] != p["lrn_rows_bwd"]
                    or p["lrn_rows_train"] != 2 * TEL_REMAT_ITERS):
                raise AssertionError(f"AlexNet LRN launches plain {p}, remat {q}")
        out[name] = r
    for bf16 in (False, True):
        dt = "bf16" if bf16 else "f32"

        def make(remat, bf16=bf16):
            # the same seed: the same weights and feed both ways
            args = bert_app.make_args(config="base", seq_len=BERT_SEQ, batch_size=BERT_BATCH,
                                      max_iter=1000, device="cuda", bf16=bf16, remat=remat)
            solver, feed, cfg = bert_app.build(args)
            if cfg.hidden_dropout != 0.1 or cfg.attention_dropout != 0.1:
                raise AssertionError(f"BERT-base dropout {cfg}")
            return solver, [next(feed) for _ in range(TEL_REMAT_ITERS)]

        r = _tel_remat_run(make, f"BERT-base {BERT_BATCH} x {BERT_SEQ} {dt}", FLASH_NAMES)
        p, q = r["plain"]["moved"], r["remat"]["moved"]
        want = 12 * TEL_REMAT_ITERS
        if (p["flash_fwd"], q["flash_fwd"], q["flash_bwd_dq"], q["flash_bwd_dkv"]) != (
                want, 2 * want, want, want):
            raise AssertionError(f"BERT flash launches plain {p}, remat {q}")
        out[f"BERT {dt}"] = r
        torch.cuda.empty_cache()
    return out


def _tel_time_net(tmp):
    """time_net on AlexNet at 256 (f32, bf16, per layer), caffe time on LeNet."""
    import contextlib
    import io

    from sparknet_tpu_torch.models import ALEXNET_SOLVER, LENET_SOLVER
    from sparknet_tpu_torch.tools import caffe as tcaffe
    from sparknet_tpu_torch.tools import time_net

    out = {}
    for argv, label in ((["--solver", ALEXNET_SOLVER, "--iters", "10", "--per-layer"],
                         "AlexNet f32"),
                        (["--solver", ALEXNET_SOLVER, "--iters", "10", "--per-layer", "--bf16"],
                         "AlexNet bf16"),
                        (["time", "--solver=" + LENET_SOLVER, "--iterations=10"],
                         "LeNet caffe time")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = (tcaffe.main(argv) if argv[0] == "time" else time_net.main(argv))
        log(f"  {label}:")
        for line in buf.getvalue().splitlines():
            log(f"  | {line}")
        if res["platform"] != "cuda" or res["train_step_ms"] <= 0:
            raise AssertionError(f"{label}: {res}")
        if label.startswith("AlexNet") and ("mfu" not in res or "train_tflops" not in res):
            raise AssertionError(f"{label}: no TFLOP/s or MFU: {res}")
        out[label] = {k: v for k, v in res.items() if k != "per_layer"}
    return out


_PROM_SAMPLE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
                          r'(,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})? -?[0-9.e+\-Inf]+'
                          r'( # \{trace_id="[^"]*"\} \S+ \S+)?$')


def _tel_server():
    """The AlexNet server's /metrics, /dash and /healthz."""
    import http.client

    import numpy as np

    from sparknet_tpu_torch.models import ALEXNET_DEPLOY
    from sparknet_tpu_torch.serve.engine import InferenceEngine
    from sparknet_tpu_torch.serve.metrics import ServeMetrics
    from sparknet_tpu_torch.serve.server import InferenceServer
    from sparknet_tpu_torch.telemetry import REGISTRY, anomaly, dash

    metrics = ServeMetrics((1, 8))
    eng = InferenceEngine.from_files(ALEXNET_DEPLOY, device="cuda", buckets=(1, 8),
                                     metrics=metrics)
    server = InferenceServer(eng, metrics=metrics, port=0, model_name="bvlc_alexnet")
    if not server.batcher.wait_ready(300):
        raise AssertionError("batcher worker did not finish its warmup")
    server.start()

    def get(path):
        conn = http.client.HTTPConnection(server.host, server.port, timeout=60)
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read().decode()
        conn.close()
        return resp.status, resp.getheader("Content-Type") or "", body

    try:
        client = server.client(timeout=120)
        x = np.random.default_rng(0).normal(size=(3,) + eng._row_shapes["data"])
        code, _ = client.classify(x.astype(np.float32), top_k=5)
        anomaly.fire("loss_spike", value=9.0, emit=lambda line: None)
        st, ctype, text = get("/metrics")
        samples = [l for l in text.splitlines() if l and not l.startswith("#")]
        bad = [l for l in samples if not _PROM_SAMPLE.match(l)]
        families = {l.split()[2] for l in text.splitlines() if l.startswith("# TYPE")}
        want = {"sparknet_anomalies_total", "sparknet_serve_requests_total",
                "sparknet_serve_request_latency_seconds",
                "sparknet_serve_device_latency_seconds"}
        if st != 200 or code != 200 or bad or not want <= families:
            raise AssertionError(f"/metrics {st}: {bad[:3]} unparsed, families missing "
                                 f"{sorted(want - families)}")
        st2, ctype2, page = get("/dash")
        sections = [h.strip() for h in re.findall(r"<section><h2>([^<]*)", page)]
        st3, _, health = get("/healthz")
        health = json.loads(health)
        # the traced classify above puts the slow-request panel first; the
        # storage panel follows once this process's writers have observed
        # the disk (safeio) or counted a fault
        want = ["Slow requests", "Serving", "Latency SLO", "Step-phase share per rank",
                "Anomalies"]
        if dash._storage_section(REGISTRY.snapshot()):
            want.insert(1, "Storage")
        if (st2 != 200 or not ctype2.startswith("text/html") or sections != want
                or st3 != 200 or [a["kind"] for a in health["anomalies"]] != ["loss_spike"]):
            raise AssertionError(f"/dash {st2} {sections}; /healthz {st3} {health}")
        log(f"  /metrics: {len(samples)} samples of {len(families)} families, all parsed; "
            f"/dash: {len(page)} bytes, sections {sections}; /healthz: status "
            f"{health['status']}, anomalies {[a['kind'] for a in health['anomalies']]}")
    finally:
        server.stop()
        anomaly.clear()


def _rank_telemetry(job, rank, world, tmp):
    """cifar10_quick ``--parallel local --tau auto`` on cuda:0 with an
    enabled timeline, rank 1 slowed inside its compiled_step; the
    heartbeat carries each rank's phases to rank 0."""
    from sparknet_tpu_torch.telemetry import aggregate, anomaly, timeline

    solver = _cifar_parallel(None, "local", "auto")
    solver.timeline = timeline.Timeline()
    timeline.set_current(solver.timeline)
    solver.timeline.start()
    if rank == 1:  # the planted straggler: 4x its round's compute
        round_fn = solver._round_fn

        def slow(tau):
            fn = round_fn(tau)

            def run(*a):
                t0 = time.perf_counter()
                res = fn(*a)
                _sync_all()
                time.sleep(3 * (time.perf_counter() - t0) + 0.02 * tau)
                return res
            return run

        solver._round_fn = slow
    feed = _cifar_feed()
    for _ in range(TEL_RANK_ROUNDS):
        tau = solver.tau
        solver.step(iter([_rank_rows(next(feed), rank, world) for _ in range(tau)]), tau)
        print(f"rank {rank}: round of tau {tau} at iteration {solver.iter}", flush=True)
        time.sleep(0.3)  # ~3 rounds a heartbeat tick (interval 1 s)
    solver.timeline.stop()
    out = {"phases": solver.timeline.snapshot()["phases"]}
    if rank == 0:
        time.sleep(1.5)  # the last stats frames
        aggregate.self_ingest()
        agg = aggregate.get_aggregator()
        print(agg.table(), flush=True)
        out.update(cluster=agg.snapshot(), table=agg.table(),
                   advised=[d for d in solver.tau_controller.decisions
                            if d.get("straggler_advisory")],
                   fired=anomaly.fired_total())
    return out


def _sync_all():
    import torch

    torch.cuda.synchronize()


RANK_JOBS["telemetry"] = _rank_telemetry


def _tel_ranks(tmp):
    # a stats frame a second; with 2 ranks the median is their mean, so
    # a straggler is one past 1.5x it (3x the other rank), 2 rounds running
    env = {"SPARKNET_HEARTBEAT_TIMEOUT": "5", "SPARKNET_STRAGGLER_FACTOR": "1.5",
           "SPARKNET_STRAGGLER_ROUNDS": "2", "SPARKNET_TAU_INITIAL": "2",
           "SPARKNET_TAU_MAX": "4"}
    results, texts = _launch_ranks([{"kind": "telemetry", "name": "telemetry"}], 2, tmp,
                                   "gloo", env=env)
    r0 = results[0]["telemetry"]
    shares = r0["cluster"]["ranks"]
    if set(shares) != {"0", "1"} or not all(e["phases"].get("compiled_step")
                                            for e in shares.values()):
        raise AssertionError(f"rank 0's aggregate: {shares}")
    strag = [a for a in r0["cluster"]["stragglers"] if a.get("rank") == 1]
    lines = [l for l in texts[0].splitlines() if l.startswith("anomaly: ")]
    for line in r0["table"].splitlines() + lines[:3]:
        log(f"  | {line}")
    if not strag or not r0["advised"]:
        raise AssertionError(f"straggler advisory {strag}, τ decisions that took it "
                             f"{r0['advised']}")
    log(f"  2 ranks: rank 0's aggregate holds both ranks' phases; the straggler fired on "
        f"rank 1 (ratio {strag[0]['ratio']}), {len(r0['advised'])} τ decision(s) took it: "
        f"{r0['advised'][0]}")
    return r0


def phase_telemetry(tmp):
    """Observability and remat on the card (module docstring, item 20)."""
    import threading

    t0 = time.perf_counter()
    run, went = _tel_app_start(tmp)
    # the remat runs in this process beside the app's process and the two
    # ranks (host-bound, their launches their own); time_net, which reads
    # throughput, once they have ended
    ranks = {}

    def run_ranks():
        try:
            _tel_ranks(tmp)
        except BaseException as e:  # raised again below, after the join
            ranks["error"] = e
        ranks["s"] = time.perf_counter() - t0

    thread = threading.Thread(target=run_ranks, name="telemetry-ranks")
    thread.start()
    start = _counts()
    t1 = time.perf_counter()
    try:
        remat = _tel_remat(tmp)
    finally:
        thread.join(TEL_APP_TIMEOUT)
        app = _tel_app_wait(run, went)
    t2 = time.perf_counter()
    if thread.is_alive():
        raise AssertionError(f"the ranks did not end in {TEL_APP_TIMEOUT} s")
    if "error" in ranks:
        raise ranks["error"]
    text, app_launches, _ = app
    _tel_check_trace(tmp, text, app_launches)
    log(f"  app and ranks: {t2 - t0:.1f} s (the ranks {ranks['s']:.1f} s)")
    times = _tel_time_net(tmp)
    t3 = time.perf_counter()
    _tel_server()
    log(f"  remat and the wait for the app: {t2 - t1:.1f} s; time_net: {t3 - t2:.1f} s; server: "
        f"{time.perf_counter() - t3:.1f} s")
    moved = {k: v - start[k] for k, v in _counts().items()}
    # the phase's launches by wrapper: the app run's and this process's
    # paths (remat runs, time_net, the server)
    for wrapper, n in zip(("lrn_rows", "lrn_rows_train", "lrn_rows_bwd"), app_launches):
        moved[wrapper] += n
    fence = {k: round(100 * (v["plain"]["fence"] / v["plain"]["ms"] - 1), 2)
             for k, v in remat.items()}
    log(f"  the timeline's fence on resident steps, % of a plain step: {fence}")
    return {"launches": moved, "remat": {k: {w: {x: v[w][x] for x in ("peak", "ms", "fence")}
                                             for w in ("plain", "remat")}
                                         for k, v in remat.items()},
            "time_net": times, "fence_pct": fence}


# ---------------------------------------------------------------- main
# the phases ``--phase`` runs alone
ONLY_PHASES = {"multiprocess": phase_multiprocess, "bert-processes": phase_bert_processes,
               "fused-step": phase_fused_step, "caffe-native": phase_caffe_native,
               "chaos": phase_chaos, "catalogue": phase_catalogue, "telemetry": phase_telemetry,
               "serving-tier": phase_serving_tier, "router-tier": phase_router_tier,
               "profile-windows": phase_profile_windows, "supervise": phase_supervise}


def main(argv=None) -> int:
    global TRACE_LEAD_S
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ab", metavar="OTHER_ROOT",
                    help="compare with another checkout of the port on this card")
    ap.add_argument("--ab-side", metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--phase", choices=tuple(ONLY_PHASES), nargs="+",
                    help="run only the card and build phases and these (e.g. the "
                         "NCCL runs on several cards); prints no result line")
    ap.add_argument("--trace-lead", type=float, default=TRACE_LEAD_S, metavar="S",
                    help="seconds between a profiler window's start and its first "
                         "traced step, and between the last one's end and the window's "
                         f"stop (default {TRACE_LEAD_S}; 0: none, the windows as they were first)")
    ap.add_argument("--rank-job", metavar="SPEC", help=argparse.SUPPRESS)
    ap.add_argument("--app-job", metavar="SPEC", help=argparse.SUPPRESS)
    ap.add_argument("--tier-client", metavar="SPEC", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    TRACE_LEAD_S = args.trace_lead
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "sparknet_tpu_torch")):
        print(f"chip_smoke: no sparknet_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    # f32 means f32 on the card too: no TF32 in convolutions or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.ab_side:
        ab_side(args.ab_side)
        return 0
    sys.path.insert(0, ROOT)
    if args.rank_job:
        return rank_main(args.rank_job)
    if args.app_job:
        return app_job(args.app_job)
    if args.tier_client:
        return tier_clients(args.tier_client)
    if args.ab:
        return ab(args.ab)

    phases = Phases()
    card = phases.run("card", phase_card)
    built = phases.run("build", phase_build)
    if args.phase:
        for name in args.phase if built else ():
            with tempfile.TemporaryDirectory(prefix="chip_smoke_mp_") as tmp:
                phases.run(name, ONLY_PHASES[name], tmp)
        phases.table()
        log(f"chip_smoke --phase {' '.join(args.phase)}: "
            + (f"FAILED phases: {phases.failed}" if phases.failed else "ok")
            + f"; {phases.seconds:.1f} s of phases in all")
        return 1 if phases.failed else 0
    timing = phases.run("kernels", phase_kernels) if built else None
    flash = phases.run("flash-kernels", phase_flash_kernels) if built else None
    serving = train = bert = local = feed = resident = zoo = multiprocess = None
    bert_mp = fused = caffe = chaos = telemetry = tier = None
    if built:
        serving = phases.run("serving", phase_serving)
        if serving:
            phases.run("profile", phase_profile, serving)
            phases.run("load", phase_load, serving)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_tier_") as tmp:
            tier = phases.run("serving-tier", phase_serving_tier, tmp)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_router_") as tmp:
            phases.run("router-tier", phase_router_tier, tmp)
        phases.run("grads", phase_grads)
        for arch in ("googlenet", "resnet50"):
            phases.run(f"{arch}-grads", phase_zoo_grads, arch)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            train = phases.run("train", phase_train, tmp)
            resident = phases.run("train-profile", phase_train_profile, tmp)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_zoo_") as tmp:
            zoo = {arch: phases.run(arch, phase_zoo_train, arch, tmp) for arch in ZOO_ARCHS}
        phases.run("bert-grads", phase_bert_grads)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_bert_") as tmp:
            bert = phases.run("bert-train", phase_bert_train, tmp)
        phases.run("bert-profile", phase_bert_profile)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_fused_") as tmp:
            fused = phases.run("fused-step", phase_fused_step, tmp)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_cifar_") as tmp:
            phases.run("cifar-app", phase_cifar_app, tmp)
        phases.run("local-sgd", phase_local_sgd)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_local_") as tmp:
            local = phases.run("alexnet-local", phase_alexnet_local, tmp)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mp_") as tmp:
            multiprocess = phases.run("multiprocess", phase_multiprocess, tmp)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_bp_") as tmp:
            bert_mp = phases.run("bert-processes", phase_bert_processes, tmp)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_feed_") as tmp:
            feed = phases.run("feed", phase_feed, tmp, (resident or {}).get("ms"))
        with tempfile.TemporaryDirectory(prefix="chip_smoke_caffe_") as tmp:
            caffe = phases.run("caffe-native", phase_caffe_native, tmp)
        # the supervised runs start in the chaos phase and are checked
        # after the catalogue, which they run beside
        sv = {}
        with tempfile.TemporaryDirectory(prefix="chip_smoke_sv_") as sv_dir:
            try:
                with tempfile.TemporaryDirectory(prefix="chip_smoke_chaos_") as tmp:
                    chaos = phases.run("chaos", phase_chaos, tmp, sv_dir, sv)
                with tempfile.TemporaryDirectory(prefix="chip_smoke_catalogue_") as tmp:
                    phases.run("catalogue", phase_catalogue, tmp)
                phases.run("supervise", phase_supervise_check, sv_dir, sv)
            finally:
                if "runs" in sv:
                    sv["runs"].kill()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_telemetry_") as tmp:
            telemetry = phases.run("telemetry", phase_telemetry, tmp)
    phases.table()
    log(f"chip_smoke: {phases.seconds:.1f} s of phases in all")
    if phases.failed:
        log(f"chip_smoke: FAILED phases: {phases.failed}")
        return 1
    timing.update(flash)
    paths = (train, local, feed, zoo["googlenet"])
    paths += (multiprocess,)  # every rank's launches
    paths += (caffe,)  # run A's and the engines'
    paths += (chaos,)  # runs A, B and C, and the traffic served under faults
    launches = {
        # serving-tier: its three precisions' engines and the traffic under swap
        "lrn_fwd": serving["launches"] + tier["launches"]
        + sum(p["launches"][0] for p in paths),
        "lrn_fwd_train": sum(p["launches"][1] for p in paths),
        "lrn_bwd": sum(p["launches"][2] for p in paths),
        # bert-train's, and every rank's of the bert-processes phase
        **{name: bert[name] + bert_mp[name] for name in FLASH_NAMES},
    }
    # and the fused-step phase's graph runs and the telemetry phase's
    # (its app runs, the remat runs with their recomputes, time_net, the
    # server), by wrapper name
    for name, wrapper in zip(launches, ("lrn_rows", "lrn_rows_train", "lrn_rows_bwd",
                                        *FLASH_NAMES)):
        launches[name] += fused[wrapper] + telemetry["launches"][wrapper]
    replaces = {
        "lrn_fwd": "sparknet_tpu/ops/lrn.py:85",
        "lrn_fwd_train": "sparknet_tpu/ops/lrn.py:77",
        "lrn_bwd": "sparknet_tpu/ops/lrn.py:93",
        "flash_fwd": "sparknet_tpu/ops/attention.py:151",
        "flash_bwd_dq": "sparknet_tpu/ops/attention.py:262",
        "flash_bwd_dkv": "sparknet_tpu/ops/attention.py:341",
    }
    log(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": "sparknet_tpu_torch/ops/csrc/" + (
            "lrn.cu" if name.startswith("lrn") else "attention.cu"),
        "replaces": replaces[name],
        "launches": launches[name],
        "max_abs_err": timing[name]["max_abs_err"],
        "ms": timing[name]["ms"],
        "plain_ms": timing[name]["plain_ms"],
        "bound_ms": timing[name]["bound_ms"],
        "bound_by": timing[name]["bound_by"],
        "library_ms": timing[name]["library_ms"],
        **{key: timing[name][key] for key in ("loop_ms", "device_ms") if key in timing[name]},
    } for name in replaces]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card[0], "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
