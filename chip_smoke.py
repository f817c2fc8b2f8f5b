#!/usr/bin/env python3
"""Chip smoke for the PyTorch/H100 port (``deeplearning4j_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Twenty phases; any failure exits non-zero and prints no result line.

1. Build and device: compile every CUDA kernel from ``csrc/`` (one
   ``nvcc`` per source, all at once), print ptxas's registers and spill
   bytes for each kernel, and the card's name and power limit from
   ``nvidia-smi``.
2. Kernels against their plain versions on the card: the flash-attention
   forward (f32 and bf16; causal prompts of 1, 5, 16, 17, 37, 63, 512
   and 1000 tokens, windows of 1, 65 and 128 at 1000, non-causal
   tq=300/tkv=700 and tq=5/tkv=130, head_dim 128 at b=2 P=513 and at
   P=1000, the training shape [16, 1024, 8, 64], and every prefill shape
   of the serve phase) against ``flash_attention_fwd_reference`` with
   TF32 off, at f32 2e-5 and bf16 2e-2 on out and lse. The short and
   windowed cases put sequence ends and mask edges inside one 16-row MMA
   tile and one zero-filled ``cp.async`` row. Prints each kernel's
   variant ("mma.sync bf16" or "mma.sync 3xtf32") and time beside the
   plain version's, ``F.scaled_dot_product_attention`` as a yardstick the
   port never calls, and the H100 bound (for f32 also at the CUDA cores'
   rate); asserts, in both dtypes, that two launches at the training
   shape give bitwise identical outputs and that rows 0–899 of a causal
   P=1024 call at the serve model's heads equal a P=900 call's, bitwise
   (a padded prompt's rows are its exact call's). Times are CUDA events
   over 20 launches queued behind a sleep kernel (``cuda_ms``), so small
   shapes show the card's time and not the host's launch rate.
3. Flash backward: the dk/dv kernel (B2) and the dq kernel (B3) against
   their plain versions on the card with TF32 off, on the forward
   phase's cases and the training shape, in f32 (1e-4) and bf16 (2e-2)
   on dq, dk and dv. Prints each kernel's variant ("mma.sync bf16", or
   "mma.sync 3xtf32" for f32) and time, the plain version's, the bound
   (for f32 also at the CUDA cores' rate) and the backward of
   ``F.scaled_dot_product_attention`` (B2 and B3 together), a yardstick
   the port never calls; asserts that two launches of B2 and of B3 at the
   training shape give bitwise identical gradients, in both dtypes.
4. Serve: the d512·L8·H8 ``TransformerLM`` (vocab 8192, d_ff 2048,
   learned positions, max_len 1024, ``mixed_bf16``, ``attn_impl="flash"``,
   random weights from seed 0) first has its logits on a 77-token prompt
   held against the same weights on the CPU (5e-2); then, behind
   ``DecodeServer(slots=8, max_len=1024)``, it answers a seeded Poisson
   stream of ragged greedy requests (prompts 20–900 tokens, 16–64 new)
   at ``fuse_steps`` 1 and 4.
   Asserts that the flash kernel ran ``num_layers`` times per prefill,
   that every stream equals the port's own ``lm.generate`` on the same
   prompt, and that both settings give the same streams.
5. Train: the same model with ``attn_impl="auto"`` (which resolves to
   flash under ``train=True``) takes 2 warm-up and 8 timed ``fit_batch``
   steps on one seeded ``[16, 1024]`` batch under ``mixed_bf16``; the
   first warm-up step runs eagerly, the second captures the step as a
   CUDA graph, and every later step is a replay with B1–B3 inside it.
   Asserts finite, falling losses, B1, B2 and B3 each launched
   ``num_layers`` times per step (counted as the launches that ran:
   ``perf.step_graph.kernel_launches``, replays included; two more
   replayed steps, each under ``torch.profiler``, must show the card
   running as many of each kernel as that count says, see
   ``traced_launches``), and f32 masters and Adam
   moments;
   prints ms/step, host time per step, tokens/s and the share of the
   bf16 peak. Holds the training unembedding (bf16 GEMMs with f32
   output) against the f32 product of its widened operands at the step's
   shape (logits 1e-4, gradients 2e-2 of their largest magnitude) and
   prints its time beside the f64 decode unembedding's. Then, at full
   width and batch 2, holds the flash path against the plain-attention
   path on the same weights: one step's loss and gradients under
   ``float32`` (rtol 2e-3, atol 1e-3) and the loss and params after 3
   steps under ``mixed_bf16`` (2e-2, 1e-2).
6. Networks: LeNet-5 at ``[1024, 28, 28, 1]`` and the MNIST MLP
   (784-256-256-10) at ``[4096, 784]`` through ``MultiLayerNetwork``,
   and ResNet-18 (11,176,970 params, 20 convolutions, 20 BatchNorms, 8
   residual adds) at ``[256, 32, 32, 3]`` through ``ComputationGraph``,
   the sizes of ``bench.py``'s ``bench_lenet``, ``bench_mlp`` and
   ``bench_resnet18``, built by the port's zoo on the config DSL and
   trained under ``bf16`` with Adam on one seeded batch placed on the
   card once: 2 warm-up and 20 timed ``fit`` calls (ResNet-18: 10), then
   ``fit_steps(ds, 10)`` twice (replays of a captured step; the first
   call's time includes the warm-up step and the capture). Asserts
   finite, falling losses; prints
   ms per step, host ms per step and samples/s for ``fit`` and
   ``fit_steps``, the peak of allocated device memory, and for ResNet-18
   the share of the bf16 peak (3 × 1.11 GFLOP a sample, bench.py's
   count). ``evaluate`` with the confusion matrix on the card equals the
   host path, with one readback. At batch 64 (ResNet-18: 8) the card is
   held against the CPU on the same weights: one step's loss, gradients
   and new BatchNorm running statistics under ``float32`` with TF32 off
   (rtol 2e-3, atol 1e-3), the loss and params (1e-2) and each
   BatchNorm's running statistics (1e-2 plus 2e-2 of the layer's largest)
   after 3 steps under ``bf16``
   (ResNet-18 at lr 1e-4: see ``NET_PARITY_LR``). The phase runs cuDNN,
   cuBLAS and eager torch, and asserts that it launched none of B1–B3.
7. Recurrent: the char-LSTM (two GravesLSTM layers of 256 with
   peepholes, ``RnnOutputLayer`` over 128 characters, truncated BPTT in
   windows of 50) at ``bench.py``'s ``bench_char_lstm`` size, batch 128 ×
   t 200 of seeded one-hot characters on the card once, ``bf16``, Adam:
   one warm-up and 5 timed ``fit`` calls (4 windows, so 4 steps, each;
   the full windows replay a captured window step, the warm-up ``fit``
   running the first eagerly and capturing it).
   Asserts finite losses, a falling last-window loss and the iteration
   count; prints ms and host ms per ``fit``, samples/s, tokens/s, the
   share of the bf16 peak (3 × 1.90 MFLOP a token, from the widths) and
   peak allocated memory. Then ``rnn_time_step`` one character at a time
   for 200 steps at batch 128 against the full ``output`` (bf16 2e-2 on
   the softmax outputs), with ms a step. At batch 8 the card is held
   against the CPU: float32 with TF32 off, the first window's loss,
   gradients and carried state, and the loss and params after one whole
   ``fit`` (rtol 2e-3, atol 1e-3); ``bf16`` after one ``fit`` at the
   zoo's lr (loss 2e-2, params 1e-2); float32 stepwise generation at
   1e-4. The phase runs cuBLAS and eager torch and asserts that it
   launched none of B1–B3.
8. Fused: every fused training path as CUDA-graph replays, each against
   the same run eagerly (``perf.step_graph.eager_steps()``: the same steps,
   the same order and generator seed; ``torch.equal`` on params, updater
   state, net state and the loss history), with ms and host ms (the time
   to return), and under ``torch.profiler`` the host's launch calls by
   CUDA API (``cudaGraphLaunch`` being a replay), the card's events, busy
   time and idle share. The epoch and ``fit_steps`` cells print the peak
   allocated memory and what stays resident (live tensors and graph pools,
   cached blocks released) of each run. The epoch cell is ``bench.py``'s
   ``bench_epoch``: the MNIST MLP (hidden 256, ``bf16``), 16 batches of
   2048 x 784 from ``default_rng(0)``, 5 epochs by streaming ``fit`` and
   by ``fit_epochs`` with chunks of 1 and of 5 epochs (samples/s, replays
   and other launches per epoch). The guard cell poisons batch 5 with a
   NaN row: under ``skip`` the sentinel trips once an epoch, at that
   batch's place in each epoch's order, and params stay finite; on clean
   data ``off`` and ``skip`` are bitwise equal; ``raise`` names the batch.
   ``fit_steps`` cells: LeNet-5 at ``[1024, 28, 28, 1]`` and ResNet-18 at
   ``[256, 32, 32, 3]`` (BatchNorm state under replay), ``bf16``, 2 + 10
   steps. The char-LSTM cell: phase 7's ``fit``, 5 timed. The LM cell: the
   train phase's model, ``fit_batch_multi`` with a captured step (k 4, 3
   timed calls); B1–B3 must launch ``num_layers`` times a step under
   replay and eagerly, and two more calls, each under ``torch.profiler``,
   must show the card running what the count says. The programs cell runs six
   fused calls of five keys on one ResNet-18 at ``[256, 32, 32, 3]``, 4
   batches (``fit_epochs`` under ``skip``, ``off``, telemetry and in
   order, ``fit_steps``, then the first key again) against the same calls
   eagerly, bitwise, printing the resident memory after each; its graphs
   share one pool, and dropping the cache frees it while the network keeps
   its programs. Then the card's fused runs against the CPU's at the
   earlier gates: ``fit_epochs`` of the MLP (4 batches of 64, 2 epochs in
   order) under float32 with TF32 off (rtol 2e-3, atol 1e-3) and ``bf16``
   (loss 2e-2, params 1e-2), and ``fit_steps(ds, 3)`` of LeNet-5 and
   ResNet-18 at phase 6's parity batches under ``bf16`` (ResNet-18 at
   ``NET_PARITY_LR``).
9. The front door: the MNIST deep-belief net of the DL4J 0.4 examples
   (RBMs 784-500-250-200 with binary units and CD-1, softmax 10,
   MCXENT; ``pretrain`` and ``backprop``, LBFGS with 5 iterations a
   batch) as a reference-format (Jackson) JSON document, and a 13 MB CSV
   of 8 batches of 1024 rows of 784 binary pixels from
   ``default_rng(0)`` with a linear teacher's labels. In child processes
   that run ``python -m deeplearning4j_tpu_torch.cli`` on the card:
   ``train`` for 2 epochs with ``--checkpoint-dir``, ``train --resume``
   to 3, ``test`` and ``predict``. Asserts that each RBM's
   reconstruction error falls over its batches, the finetune score
   falls over the epochs, ``test`` accuracy is above the majority-class
   share, ``predict``'s labels are the restored network's argmax, the
   zip restored on the CPU gives the card's outputs (rtol 2e-3, atol
   1e-3), and no process launched B1–B3. Prints the ``train`` wall time,
   its CSV parse and peak allocated memory, ms per CD-1 step per layer
   and ms per solver iteration split into the card's score and
   gradient, the line search's probes and the host's float64 algebra,
   with the bytes each iteration moves. At batch 64 the card is held
   against the CPU on the same weights, float32 with TF32 off (rtol
   2e-3, atol 1e-3): one CD-1 step of the first RBM and one AutoEncoder
   step with the same injected draws (zero flipped samples), and 3
   iterations each of LBFGS, conjugate gradient and line gradient
   descent (score history and params).

10. Serving extras, on phase 4's model (``mixed_bf16``) and its float32
   twin from the same seed: ``make_generate(77, 64)`` equals
   ``generate``; ``generate_beam`` at ``[2, 77]`` with 32 new tokens at
   beam 1 equals greedy ``generate``, and at beam 4 under float32 with
   TF32 off the card's best beam equals the CPU's (scores rtol 2e-3,
   atol 1e-3). Phase 4's stream behind ``DecodeServer(slots=8,
   max_len=1024, draft_layers=1, spec_tokens=3)`` at ``fuse_steps`` 1
   and 4, each after the plain server on the same stream (tokens/s,
   TTFT p50, dispatches per token): every greedy stream equals
   ``lm.generate`` (a divergence
   prints its index and the target's top-2 margin there), B1 launches
   ``num_layers + 1`` times per admission (and ``num_layers`` times a
   ``make_generate`` call: both counts held against ``torch.profiler``
   as phase 5's are); prints tokens/s, TTFT p50,
   the accept rate, tokens per slot-dispatch, dispatches per token and
   the pools' bytes, then one dispatch of eight live slots under
   ``torch.profiler`` (launches, busy time, idle share, device time by
   kernel); ``draft_layers=8`` accepts every proposal. Sampled rounds
   (T 0.8, top-k 50, 2 slots, 4 rounds) under float32 with TF32 off:
   the card's ``[K, S, G+2]`` block equals the CPU's with the same
   injected draws (no flipped accept). A split fleet (one prefill-role,
   one decode-role replica): streams equal ``lm.generate``, each
   handoff carries ``kv_per_slot_bytes``; prints the export and install
   ms. ``FleetLoadDriver`` (measured step costs, ``fuse_steps=4``) over
   1 and 2 replicas on 16 requests, then 2 with ``r0`` killed halfway:
   nothing lost or diverged; prints tokens/s, TTFT, balance, scaling and
   the failed-over requests' recovery seconds. Two threaded replicas,
   ``r0`` killed at its third step: nothing lost. Two child processes
   with ``DL4J_COMPILE_CACHE_DIR`` on a temporary directory: the first,
   started beside phase 1's build, builds B1–B3 there (one ``nvcc`` a
   source, all started together), the second runs ``nvcc`` zero times;
   prints each one's seconds to kernels-ready and
   ``compile_cache_stats()``. B2 and B3 must not launch; prints the
   phase's wall time.

11. Data, with every fetcher on its synthetic path (an empty
   ``DL4J_TPU_DATA_DIR``): ``MnistDataSetIterator(1024)`` and the Iris,
   Curves and MovingWindow iterators through
   ``AsyncDataSetIterator(device_prefetch=True)`` yield on the card what
   they yield on the host, bitwise, and so do 6 MultiDataSets of four
   ``[2048, 784]`` arrays each (the staging ring hands each array its own
   buffer); a CSV goes through the native host
   parser (``native_parse_total{path=native}`` must rise). The
   ``bench_infeed`` cell (MNIST MLP, bf16, 16 distinct batches of
   ``[4096, 784]``) fed synchronously and through the CUDA-stream
   prefetch (``queue_size`` 4): both rates, their ratio, bitwise-equal
   params. Phase 8's epoch cell under a 64 MB cache budget: the
   ``fit_epochs`` fallback streams through the prefetch
   (``DL4J_PREFETCH_DEPTH``), its params equal an eager ``fit`` loop's
   bitwise; its ms an epoch and card-idle share from ``torch.profiler``.
   Capture safety: a warmed-up LeNet-5 captures its ``fit_steps`` step
   while a prefetch producer stages 400 batches of shapes new to the
   process; no invalidation, the producer waited for the capture and was
   mid-stream after it, the replays equal the eager steps and every
   batch the host's, bitwise.
   ``EarlyStoppingTrainer`` on LeNet-5 (bf16, 10 batches of
   ``[1024, 28, 28, 1]`` from the 10,000-example synthetic MNIST,
   InvalidScore, the test fetcher's loss) under ScoreImprovement(2) and
   MaxEpochs(5), which MaxEpochs ends, and under ScoreImprovement(1,
   min improvement 0.05), which ends it after epoch 3: fused (each epoch
   a captured graph, its train iterator a prefetching one that the
   device cache drains first) and per batch on the card, and per batch
   on the CPU; the same reason, condition and best epoch, scores within
   2e-2 / 1e-2 of the CPU's and within half of each CPU score.
   ``check_gradients`` in float64 on the card (subset 64,
   batch 4) passes for the MNIST MLP, LeNet-5, a BatchNorm graph and a
   GravesLSTM (largest relative error, wall time).
   ``FaultTolerantTrainer.fit_epochs`` on LeNet-5 (4 batches of 1024, 4
   epochs) preempted at its second chunk boundary (``preempt.chunk``):
   a fresh trainer resumes and finishes bitwise the uninterrupted run,
   and so does one whose newest checkpoint was truncated (it falls back
   to the one before); checkpoint save and resume times. No B1–B3
   launch.

12. Monitor: a ``DL4J_PROFILE`` ``fit_epochs`` on phase 8's epoch cell
   with ``DL4J_TELEMETRY_DIR`` and ``DL4J_FLIGHT`` on a temporary
   directory: the run ledger's goodput and categories cover its window
   within 1 %, ``validate_cache_budget`` holds (tolerance 0.25), one
   ``memory_stats`` watermark a chunk, the JSONL log, the Prometheus
   textfile and the flight recorder's segments parse and hold the run.
   ``capture_program_profile`` on phase 8's LM cell (one eager step under
   the flop counter, B1–B3 added by their bounds' formulas, then its
   warm-up and capture and 10 timed replays of the captured step): FLOPs within 2 % of the
   analytic model (6 per matmul parameter a token, plus 18·b·h·d·Σvisible
   a layer for B1–B3), the measured time and ``classify_boundedness``
   against the H100's peaks; B1–B3 launch ``num_layers`` times a step.
13. Embeddings (no kernel of its own: plain PyTorch steps, the fused
   ones replayed as CUDA graphs). E1, ``bench_word2vec``'s model and
   corpus (2000 seeded Zipf sentences of 40 tokens over 5000 words;
   d128, window 5, 5 negatives): ``Word2Vec.fit`` cold and warm
   (words/s), then ``fit_epochs`` (a warm-up epoch that captures, 3
   timed epochs: one chunk call, a ``[3, N]`` history, N replays an
   epoch, the plan's ms and ``torch.profiler``'s busy time and idle
   share); two epochs replayed against eager and against a second
   replayed run, bitwise; the card against the CPU with TF32 off at
   rtol 2e-3 / atol 1e-3 for a fused epoch fed one plan, a ``fit``
   epoch with the same numpy draws and ``similarity`` on 20 pairs; and
   ``Word2VecDataSetIterator`` batches on the card bitwise the host's.
   E2, text8's scale (``TEXT8_TOKENS`` tokens as sentences of 40 over
   71,290 words, min count 5), fused only: it must not fall back; a
   warm-up and a timed epoch (words/s, host ms for the corpus, vocab
   and cache, the plan's ms, peak memory against the priced budget,
   ms a replay and the idle share over 256 replays). E3, card against
   CPU at the same gate: GloVe (d32, 3 epochs, the same orders; replay
   against eager bitwise), SequenceVectors, ParagraphVectors (200
   documents, 2 epochs; ``infer_vector`` and ``predict``) and DeepWalk
   (2000 vertices, walks of 8, window 4). No B1–B3 launch.
14. Trees, tagging, clustering and t-SNE (no kernel of its own: plain
   PyTorch). T1: the RNTN at the JAX defaults (d25, 5 classes, tensors,
   AdaGrad 0.01, l2 1e-4, batch 32) for one epoch on an SST-scale
   treebank (8,544 / 1,101 seeded trees in SST's format, lengths
   clip(round(normal(19, 9)), 2, 56), ``zipf(1.3) % 21,701`` words,
   random bracketing, labels on every node by a fixed rule), read back
   through ``Tree.parse``: finite losses, the last 20 batches' mean
   below the first 20's, ms a step, trees/s, nodes/s, peak memory; its
   first 64 batches again on a fresh model; 10 pre-planned steps' host
   and card time, launches and idle share under ``torch.profiler``; dev
   ``score`` and ``predict``, node accuracy above the majority label's
   share (root accuracy printed). T2: ``HmmPosTagger`` fitted on a
   seeded 45-tag HMM's 39,832 sentences (44,000 words), ``tag_tokens``
   on 2,416 (ms a sentence), ``decode_batch`` at ``[2416, 64, 45]``,
   ``TreebankParser`` fitted on T1's trees parsing 100 raw dev
   sentences, and T1's ``predict_root`` on the parses. T3:
   ``KMeansClustering(k=100)`` on a mixture of 100 Gaussians at
   ``[69,849, 128]`` (Euclidean) and ``[4,260, 128]`` (cosine,
   Manhattan), twice each (bitwise), with the device step's time
   (CUDA events). T4: ``Tsne()`` at the JAX defaults on a seeded
   ``[4,260, 128]`` table (ms an iteration, ``compute_gaussian_p``'s
   seconds), the KL falling after the exaggeration. Then, beside the
   CPU's whole t-SNE run in a thread, with TF32 off (rtol 2e-3 / atol
   1e-3 unless said): one RNTN step's loss and gradients and the params
   and AdaGrad state after 3 steps card against CPU, two card runs of
   10 steps bitwise; every sentence's Viterbi decode and the padded
   batch's (paths equal, scores 1e-5 relative); k-means' first 5
   iterations from one init (costs 1e-4 relative, assignments equal
   outside near-ties: points whose two nearest centroids are within
   1e-5); t-SNE's first 10 iterations, and the final KL within 5 % of
   the CPU's. No B1–B3 launch.
15. Mesh (training over a device mesh; the card is one H100, so the
   multi-rank worlds share it). An NCCL world of one rank (a
   ``FileStore`` in a temporary directory): the d512·L8 LM's
   ``make_train_step(mesh=, sequence_parallel=True)`` for 3 steps at
   ``[16, 1024]`` bitwise the meshless (captured) step, and
   ``ParallelWrapper`` (``fsdp`` off and on) fitting the MNIST MLP at
   ``[4096, 784]`` bitwise ``net.fit``. A probe world of four gloo ranks
   on the card reports which gloo collectives carry CUDA tensors (each
   rank logs an op's start and outcome; an op that aborts a process ends
   only that world). Then a world of four gloo ranks on the card, each
   ``torch.cuda.set_device(0)``, every world killed past its timeout:
   the flash ring over ``sequence=4`` at ``[16, 1024, 8, 64]`` (causal,
   non-causal, window 128; f32 and bf16) against B1/B2/B3 on the whole
   tensors (f32: out and lse 2e-5, gradients 1e-4; bf16: out 2e-2, and
   the gradients against the f32 oracle within the single-device
   kernels' own error there plus 2e-2, since the ring rounds each hop's
   output to bf16 before its merge, as the reference does); the K/V
   transport's ms per hop (one gloo ``all_to_all_single``: gloo has no
   CUDA point-to-point); Ulysses against the plain path (bf16 2e-2);
   the LM's sequence-parallel step, ring and Ulysses, 3 steps each
   against the single-device step (loss 2e-2, params 1e-2), ms per step
   and B1–B3 launches per step summed over the ranks (the ring: 8 layers
   × 10 hops = 80 each; Ulysses: 0); ``ParallelWrapper`` over
   ``data=4`` (replicated and FSDP) against single-device ``fit`` in
   float32 (rtol 1e-4, atol 1e-6) with the params each rank holds; the
   per-rank peak memory. Then B1/B2/B3 at one hop's shape (full and
   diagonal) beside the single-device kernels over the same whole shape
   (CUDA events), and ``ParameterAveragingTrainer`` with 4 replicas on
   the one card, no process group, against 4 clones averaged (float32
   rtol 1e-4, atol 1e-6). The world of one also holds
   ``shard_params`` over ``model=1`` bitwise the meshless captured step.
16. Model axes (tensor parallelism, GPipe, MoE), in a world of four gloo
   ranks sharing the card, as in phase 15: (a) the train cell's LM
   (``[16, 1024]``, ``mixed_bf16``) under ``shard_params`` over
   ``model=4`` and ``data=2 x model=2``, 3 steps against the
   single-device step (loss 2e-2, params 1e-2), B1–B3 launched 8 times a
   rank a step on the rank's heads (``[16, 1024, 2, 64]`` and ``[8,
   1024, 4, 64]``); (b) the serve cell's 8 greedy requests through
   ``DecodeServer(slots=8, mesh=model=4)``: every stream equal to the
   unsharded ``lm.generate``, the smallest top-1/top-2 logit margin
   seen, a beam-3 call beside the unsharded one, TTFT and tokens/s beside
   a one-device server in the same call, B1 8 launches a prefill a rank
   and no B2/B3; (c) the LM's 8 blocks as 4 stages of 2 over ``pipe=4``,
   8 microbatches of ``[2, 1024]``, outputs and every stage's gradients
   against the blocks in sequence (2e-2 of each tensor's largest), B1–B3
   launched (M + S − 1) × 2 = 22 times a rank; (d) the MoE FFN (d512,
   d_ff 2048, E=8, top-2, capacity 1.25) over ``expert=4`` on ``[4,
   1024, 512]`` f32 against one device (rtol 1e-4, atol 1e-5); (e) the
   MNIST MLP at ``[4096, 784]`` f32 under ``shard_network_params`` over
   ``model=4``, 3 fits against ``fit`` (rtol 1e-4, atol 1e-6); (f) the
   same MLP on SGD at the zoo's lr through ``ParallelWrapper`` over
   ``data=2 x model=2`` under each of the four L2 gradient
   normalizations (threshold 0.5, below the first step's layer norms,
   which it prints), 3 fits against one device (rtol 1e-4, atol 1e-6)
   and a control (normalized against unnormalized, at least 10x the
   gate); (g) ``ParallelWrapper(fsdp=True)`` over ``data=2 x model=2``
   under ``ClipL2PerLayer``: 3 fits, then 2 epochs of ``fit_epochs`` on
   bench_epoch, against one device, with each rank's elements beside
   TP alone and FSDP alone over ``data=4``; (f) and (g) launch no B1–B3;
   (h) the serve cell's 8 greedy requests through a split fleet of three
   replicas over ``model=4`` (prefill ``p0``, decode ``d0`` and ``d1``,
   every rank holding the fleet): ``p0`` prefills (B1 8 launches a
   prefill a rank, on ``[1, P, 2, 64]``) and hands each slab (the ranks'
   heads gathered) to ``d0``, which ``FleetController.drain`` moves onto
   ``d1`` mid-stream (``fallback_failovers`` 0); every stream equal to
   the unsharded ``lm.generate``, every handoff ``kv_per_slot_bytes``
   long, ``d0``/``d1`` launching no kernel; a TP slab decoded on a
   one-device server and a one-device slab on ``d1``, both equal to
   ``lm.generate``; a slot's export and install timed (CUDA events and
   the host clock), TP beside one device.
   Each cell prints its ms, params and peak memory per rank, and one
   ``[16, 1024, 512]`` f32 all-reduce's ms. Then B1/B2/B3 at the two per-rank shapes
   against their bounds, plain versions and SDPA (CUDA events).
17. Cluster (the fused epoch over a mesh and the cluster layer): (a) an
   NCCL world of one: ``ParallelWrapper(build_mesh()).fit_epochs`` on
   phase 8's epoch cell (``bench_epoch``, 5 epochs) bitwise
   ``net.fit_epochs``, 16 replays an epoch, ms an epoch; then a world of
   four gloo ranks sharing the card: (b) ``fit_epochs`` over ``data=4``
   (FSDP off and on) on ``bench_epoch`` in float32 for 2 epochs against
   one device (rtol 1e-4, atol 1e-6), each rank's cache a quarter of one
   device's, and the elastic run ``data=4 → None → data=2 × model=2 →
   data=4`` (one epoch each) against the uninterrupted run (rtol 2e-4,
   atol 1e-5), 3 reshards counted; the width cell at the same gate:
   ``data=4 → ranks [1,2,3] → ranks [0,1] → data=4`` (rank 0 parks, then
   ranks 2 and 3; 3 reshards), and the ``GoodputAutopilot``'s shrink and
   readmit (rank 3's first chunk stalls at its ``epoch.chunk`` site: it
   is evicted, the run reshards onto ranks [0,1,2], then grows back; 2
   reshards), every rank's history the lead's bitwise, with ms an epoch,
   the watchdog's deadline and each parked rank's idle ms at each width
   and the cell's seconds; (c) ``DistributedWord2Vec`` on
   ``bench_word2vec`` over ``data=4`` (``dp``) and row-sharded over
   ``model=4`` (``rows``: 4,260 words tile it) against the one-device
   fused epoch on the same plan (atol 1e-5), words/s beside it; (d)
   ``FaultTolerantTrainer`` with a ``FileStateTracker``: (b)'s wrapper
   preempted after epoch 1 and resumed over ``data=2 × model=2`` to the
   end, against the uninterrupted run (rtol 2e-4, atol 1e-5), every
   rank's heartbeat in the tracker. In this process: (e)
   ``DistributedTrainer`` with ``IterativeReduceWorkRouter`` and 4
   ``NetworkWorkPerformer`` threads on the card, one MNIST-MLP ``[4096,
   784]`` job each, against 4 clones' fits averaged (rtol 1e-4, atol
   1e-6); (f) ``train -runtime multihost`` as 4 processes on
   ``127.0.0.1`` against ``-runtime local`` (rtol 1e-4), wall time. Each
   cell prints its ms, memory and bytes per rank; no B1–B3 launch.
18. The last host-side modules (A15): (a) phase 4's served model on 4
   replicas, each started under a ``GrantLease`` around its warm-up (the
   kernel library loaded, one B1 prefill): r1's first acquisition fails
   at the ``grant.lease`` fault site and is re-acquired, r2's lease is
   exhausted (dead, evicted), r3 is slowed 300 ms a loop step by a fault
   hook and a ``FleetController(autopilot=GoodputAutopilot(...))``
   evicts it after its straggler streak; 16 seeded greedy requests,
   every stream equal to ``lm.generate``, none lost, the flight recorder
   classifying the run ``reacquired`` and the ledger booking
   ``grant_wait``, B1 ``num_layers`` launches a prefill and no B2/B3;
   prints each lease's acquire ms, each autopilot decision with its
   evidence and the fleet's tokens/s; (b) the program contracts over
   phase 8's ``bench_epoch`` program and phase 13's fused skip-gram
   epoch (zero violations) and over a step seeded with ``.item()`` and
   a param replaced out of place (both reported); (c) an in-process
   ``UiServer`` on 127.0.0.1: the three listeners over HTTP on LeNet-5's
   ``fit`` and the histogram listener on phase 8's fused epoch through
   ``chunk_done``, each GET held against the CPU's payload for the same
   params (rtol 1e-5), ms per firing and the epoch's ms with the
   listener and without; (d) ``NeuralNetClassification`` on the MNIST MLP
   conf fitted on the card, its probabilities against a CPU run from the
   same weights (float32, TF32 off, rtol 2e-3 / atol 1e-3).
19. Every head dimension: (a) B1, B2 and B3 against their plain
   versions (TF32 off) at head_dim 16, 32, 72, 80, 96, 100, 112, 192,
   256, 320 and 512, in f32 and bf16: causal at P = 1, 17 and 1000,
   windowed at P = 1000 w = 65, non-causal tq=300/tkv=700, and
   ``[8200, 16, 8, 64]`` causal (b·h 65,600). Gates: f32 out/lse 2e-5,
   gradients 1e-4; bf16 2e-2, or at d >= 192 the kernel's error against
   the f32 oracle within SDPA's plus 2e-2. Prints each launch plan
   (route, variant, tier, slices), the instantiations' spills and the
   cold build time, and B1–B3's times in bf16 at ``[2, 2048, 32, 80]``,
   ``[2, 2048, 16, 256]``, ``[1, 2048, 8, 512]`` and ``[16, 1024, 8,
   64]`` beside their plain versions, bounds and SDPA. (b) The LM at OPT-2.7B's widths (vocab
   50272, d2560, 32 heads of 80, d_ff 10240, learned positions, max_len
   2048, ``mixed_bf16``, ``attn_impl="auto"``) cut to depth 8: three
   ``fit_batch`` steps on ``[2, 2048]`` through B1–B3 (8 each a step),
   then the same from the same seeded weights on plain attention
   (loss 2e-2, params 1e-2); prints ms and tokens/s a step and the share
   of the bf16 peak. (c) The same widths at full depth 32 behind
   ``DecodeServer(slots=8)``, ``attn_impl="flash"``: 8 seeded greedy
   requests (prompts 20–1900 tokens), streams equal ``lm.generate``, B1
   32 a prefill, B2/B3 0; prints TTFT p50, tokens/s and the KV pool's
   bytes. (d) ``bench.py``'s fleet model (vocab 512, d128, 8 heads over
   4 kv heads: head_dim 16, L2, RoPE, ``bf16``) under
   ``attn_impl="flash"`` the same way, B1 2 a prefill. Weights are drawn
   on the card from a seed (``seeded_on_card``).
20. The float32 LM: the train cell's model (``TRAIN_CFG``: vocab 8192,
   d512, 8 heads of 64, L8, ``[16, 1024]``) under ``dtype_policy=
   "float32"`` and ``attn_impl="auto"``, which resolves to flash, so
   B1, B2 and B3 run their f32 kernels ("mma.sync 3xtf32", 3xTF32 on
   the tensor cores). (a) First-step gradients through B1–B3 against
   plain attention, leaf by leaf, TF32 off (1e-4 relative, phase 19's
   float32 gate); (b) ``TRAIN_WARMUP`` + ``TRAIN_STEPS`` ``fit_batch``
   steps: losses finite and falling, B1–B3 8 each a timed step; (c) ms
   and tokens/s a step, and B1's and B2 + B3's shares of a step's device
   time from the profiler.

Output: metric lines, then a ``{"kernels": [...]}`` JSON line (each
kernel's ``variant`` and ``launches`` counted over the train phase's
timed steps, replays included; over phase 8's LM cell as
``launches_fused_lm``; B1's over the serve phase too, as
``launches_serve``; over phase 9 as ``launches_cli``, which must be 0;
over phase 10 as ``launches_serve_extras``; over phase 11 as
``launches_data``, which must be 0; over phase 12's profiled step,
replays included, as ``launches_profile``; over phase 13 as
``launches_embeddings``, which must be 0; over phase 14 as
``launches_trees``, which must be 0; over phase 15's ring steps, summed
over the four ranks, as ``launches_mesh``; over phase 16's TP train
steps and cell (h)'s prefills, and its pipeline step, summed over the
ranks, as ``launches_tp`` and ``launches_pipe``; over phase 17, its ranks' summed with this
process's, as ``launches_cluster``, which must be 0; over phase 18 as
``launches_a15``, B1's the fleet's warm-ups and prefills, B2's and B3's
0; over phase 19's (b)–(d) as ``launches_headdim``, with phase 19's
times under ``headdim_times``; and its train-shape
numbers under
``train``; then B1's, B2's and B3's float32 entries at the train shape
from phases 2 and 3, with both bounds (3xTF32 and the CUDA cores') and
their launches over phase 20's timed steps) and the ``nvidia-smi``
line,
then ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import gc
import hashlib
import json
import math
import os
import re
import contextlib
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

SERVE_CFG = dict(vocab_size=8192, d_model=512, num_heads=8, num_layers=8,
                 d_ff=2048, max_len=1024, seed=0, pos_encoding="learned",
                 dtype_policy="mixed_bf16", attn_impl="flash")
SERVE_SLOTS = 8
SERVE_MAX_LEN = 1024
SERVE_REQUESTS = 8
SERVE_PROMPT_LENS = (20, 75, 160, 333, 512, 700, 900)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# backward: f32 at the reference's gate for its kernels (tests/
# test_pallas.py); bf16: both sides round p and ds to bf16 at the same
# places, but an f32 sum taken in another order can land one of them on
# the other side of a rounding tie, moving a gradient by one bf16 ulp of
# p or ds (<= 2^-9 below 1) times one do/q/k element (|x| < 5 for these
# N(0, 1) draws), so the forward's 2e-2 holds with room
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TRAIN_CFG = {**SERVE_CFG, "attn_impl": "auto"}
TRAIN_BATCH, TRAIN_T = 16, 1024
TRAIN_WARMUP, TRAIN_STEPS = 2, 8
H100_BF16_FLOPS = 989e12


def variant(kernel: str, dtype: str) -> str:
    """The CUDA kernel family a wrapper launches for ``dtype`` inputs, as
    ``launch_plan`` names it (one family a dtype, whatever the kernel and
    route): "mma.sync bf16" (bf16) or "mma.sync 3xtf32" (f32)."""
    import torch
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa

    x = (1, 64, 1, 64)
    return fa.launch_plan(x, x, getattr(torch, dtype)).kernel(kernel).variant


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return out[0] if out else "nvidia-smi printed nothing"


def ptxas_lines(log: str):
    """One line per kernel from ``nvcc -Xptxas=-v`` output: its mangled
    name, registers and spill bytes."""
    name, spill, out = None, "", []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif "spill stores" in line:
            spill = line.strip()
        else:
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                out.append(f"{name}: {m.group(1)} registers, {spill}")
                name, spill = None, ""
    return out


def same_twice(fn) -> bool:
    """Whether two launches of ``fn()`` (a tensor or a tuple of them)
    give bitwise identical outputs."""
    import torch

    a, b = fn(), fn()
    if isinstance(a, torch.Tensor):
        a, b = (a,), (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def cuda_core(bound: dict) -> str:
    """A bound's f32 figure at the CUDA cores' rate, for a metric line
    ("" for bf16)."""
    ms = bound.get("cuda_core_bound_ms")
    return "" if ms is None else f" cuda_core_bound_ms={ms:.6f}"


_SLEEP_CYCLES_PER_MS = []


def sleep_cycles_per_ms() -> float:
    """Cycles of ``torch.cuda._sleep`` per ms on this card (measured once)."""
    import torch

    if not _SLEEP_CYCLES_PER_MS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(10 ** 7)
        end.record()
        torch.cuda.synchronize()
        _SLEEP_CYCLES_PER_MS.append(10 ** 7 / start.elapsed_time(end))
    return _SLEEP_CYCLES_PER_MS[0]


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events).
    The timed launches are queued behind a sleep kernel twice as long as
    the host took to issue as many in the warm-up, so the card runs them
    back to back: at small shapes this is the kernel's time, not the
    host's launch rate."""
    import torch

    t = time.perf_counter()
    for _ in range(iters):  # warm-up, and the host's time to issue
        fn()
    host_ms = (time.perf_counter() - t) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2 * host_ms * sleep_cycles_per_ms()))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: flash-attention forward against its plain version
# ---------------------------------------------------------------------------
def flash_cases():
    """(label, b, tq, tkv, h, d, causal, window). The "main path" entries
    are the prefill shapes the serve phase gives the kernel (one per
    prompt-ladder rung of its prompt lengths); the last is the largest."""
    from deeplearning4j_tpu_torch.perf.bucketing import prompt_bucket

    # P=1, 5, 17, 63, tq=5/tkv=130 and w=1/65 put sequence ends and mask
    # edges inside one 16-row MMA tile and one 16-byte cp.async chunk row
    cases = [(f"causal P={p}", 1, p, p, 8, 64, True, None)
             for p in (1, 5, 16, 17, 37, 63, 512, 1000)]
    cases += [(f"windowed P=1000 w={w}", 1, 1000, 1000, 8, 64, True, w)
              for w in (1, 65, 128)]
    cases += [("non-causal tq=300 tkv=700", 1, 300, 700, 8, 64, False, None),
              ("non-causal tq=5 tkv=130", 1, 5, 130, 8, 64, False, None),
              ("head_dim 128 b=2 P=513", 2, 513, 513, 4, 128, True, None),
              ("head_dim 128 P=1000", 1, 1000, 1000, 8, 128, True, None),
              train_case()]
    rungs = sorted({prompt_bucket(n, max_len=SERVE_MAX_LEN)
                    for n in SERVE_PROMPT_LENS})
    cases += [(f"main path P={p}", 1, p, p, SERVE_CFG["num_heads"],
               SERVE_CFG["d_model"] // SERVE_CFG["num_heads"], True, None)
              for p in rungs]
    return cases


def train_case():
    """The attention shape of the train phase's steps."""
    h = TRAIN_CFG["num_heads"]
    return (f"train b={TRAIN_BATCH} P={TRAIN_T}", TRAIN_BATCH, TRAIN_T,
            TRAIN_T, h, TRAIN_CFG["d_model"] // h, True, None)


def check_flash(card: str) -> tuple:
    """Phase 2. Returns the bf16 kernels-line entry (the serve shape's
    numbers, the train shape's under ``train``) and the f32 entry at the
    train shape."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1234)
    failures, entry, train, f32_entry = [], None, None, None
    for label, b, tq, tkv, h, d, causal, window in flash_cases():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            q, k, v = (torch.randn((b, t, h, d), generator=gen,
                                   device="cuda").to(dtype)
                       for t in (tq, tkv, tkv))
            kw = dict(causal=causal, window=window)
            out, lse = fa.flash_attention_fwd(q, k, v, **kw)
            ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
            torch.cuda.synchronize()
            err = max(float((out.float() - ref_out.float()).abs().max()),
                      float((lse - ref_lse).abs().max()))
            finite = bool(torch.isfinite(out.float()).all())
            ok = finite and err <= TOL[name]
            ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw))
            plain_ms = cuda_ms(
                lambda: fa.flash_attention_fwd_reference(q, k, v, **kw))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            mask = None
            if window is not None:
                i = torch.arange(tq, device="cuda")
                mask = (i[:, None] >= i[None, :]) & \
                    (i[:, None] - i[None, :] < window)
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None))
            bound = fa.flash_bound(b, tq, tkv, h, d, dtype, causal=causal,
                                   window=window)
            print(f"flash_fwd {label} {name} [{variant('fwd', name)}]: "
                  f"max_abs_err={err:.3e} "
                  f"(tol {TOL[name]:.0e}) kernel_ms={ms:.5f} "
                  f"plain_ms={plain_ms:.5f} library_ms={lib_ms:.5f} "
                  f"bound_ms={bound['bound_ms']:.6f} ({bound['bound_by']})"
                  f"{cuda_core(bound)} {'ok' if ok else 'MISMATCH'} "
                  f"[{card}]")
            if not ok:
                failures.append(f"{label} {name}: err {err} finite {finite}")
            if label == train_case()[0]:
                same = same_twice(lambda: fa.flash_attention_fwd(q, k, v,
                                                                 **kw))
                print(f"flash_fwd {label} {name}: two launches bitwise "
                      f"identical: {same} [{card}]")
                if not same:
                    failures.append(f"{label} {name}: two launches differ")
            if label == train_case()[0] and dtype == torch.bfloat16:
                train = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": bound["bound_ms"],
                         "bound_by": bound["bound_by"], "max_abs_err": err,
                         "shape": [b, tq, h, d]}
            if label == train_case()[0] and dtype == torch.float32:
                f32_entry = {
                    "name": "flash_attention_fwd",
                    "route": "cuda",
                    "variant": variant("fwd", name),
                    "source": "deeplearning4j_tpu_torch/kernels/csrc/"
                              "flash_fwd.cu",
                    "replaces": "deeplearning4j_tpu/pallas/"
                                "flash_attention.py:49",
                    "launches": None,
                    "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound["bound_ms"],
                    "bound_by": bound["bound_by"],
                    "cuda_core_bound_ms": bound["cuda_core_bound_ms"],
                    "library_ms": lib_ms,
                    "library_call": "F.scaled_dot_product_attention "
                                    "(float32)",
                    "shape": [b, tq, h, d], "dtype": name,
                }
            if label == flash_cases()[-1][0] and dtype == torch.bfloat16:
                entry = {
                    "name": "flash_attention_fwd",
                    "route": "cuda",
                    "variant": variant("fwd", name),
                    "source": "deeplearning4j_tpu_torch/kernels/csrc/"
                              "flash_fwd.cu",
                    "replaces": "deeplearning4j_tpu/pallas/"
                                "flash_attention.py:49",
                    "launches": None,
                    "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound["bound_ms"],
                    "bound_by": bound["bound_by"],
                    "library_ms": lib_ms,
                    "shape": [b, tq, h, d], "dtype": name,
                }
    failures += check_prefill_padding(gen, card)
    if failures:
        raise AssertionError("flash kernel disagrees with its plain "
                             "version: " + "; ".join(failures))
    entry["train"] = train  # the same kernel at the train step's shape
    return entry, f32_entry


def check_prefill_padding(gen, card: str) -> list:
    """A causal prompt of 900 tokens padded to 1024 (the serve phase's
    bucket) at the serve model's heads: rows 0–899 of out and lse equal
    the exact call's, bitwise, in both dtypes. Returns the failures."""
    import torch
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa

    h = SERVE_CFG["num_heads"]
    d = SERVE_CFG["d_model"] // h
    failures = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        q, k, v = (torch.randn((1, 1024, h, d), generator=gen,
                               device="cuda").to(dtype) for _ in range(3))
        out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        cut = fa.flash_attention_fwd(*(x[:, :900].contiguous()
                                       for x in (q, k, v)), causal=True)
        same = torch.equal(out[:, :900], cut[0]) and \
            torch.equal(lse[..., :900], cut[1])
        print(f"flash_fwd prefill P=900 padded to 1024 {name}: rows 0-899 "
              f"bitwise the exact call's: {same} [{card}]")
        if not same:
            failures.append(f"P=900 padded to 1024 {name}: rows differ")
    return failures


# ---------------------------------------------------------------------------
# phase 3: serve the slice's model
# ---------------------------------------------------------------------------
def check_forward(lm, card: str) -> None:
    """The served model's logits on the card (flash kernel) against the
    same weights on the CPU (the kernel's plain version and PyTorch's CPU
    matmuls) on a small prompt. Both run bf16 compute, which rounds the
    residual stream to 8 mantissa bits at different places on the two
    devices: tolerance 5e-2 on logits of magnitude ~1."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.dtypes import tree_map
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM

    cpu = TransformerLM(**{**SERVE_CFG, "device": "cpu"})
    cpu.params = tree_map(lambda p: p.cpu(), lm.params)
    tok = np.random.default_rng(5).integers(
        0, SERVE_CFG["vocab_size"], (1, 77))
    got = lm.forward(lm.params, tok).cpu()
    want = cpu.forward(cpu.params, tok)
    err = float((got - want).abs().max())
    ok = bool(torch.isfinite(got).all()) and got.shape == want.shape \
        and err <= 5e-2
    print(f"forward [1, 77] card vs cpu: max_abs_err={err:.3e} (tol 5e-2) "
          f"{'ok' if ok else 'MISMATCH'} [{card}]")
    if not ok:
        raise AssertionError(f"served model's logits disagree with the CPU "
                             f"reference: max_abs_err {err}")


def serve(card: str) -> int:
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        flash_attention_fwd)
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    from deeplearning4j_tpu_torch.serving import (
        DecodeServer, poisson_schedule, run_open_loop)

    lm = TransformerLM(**SERVE_CFG).init()
    check_forward(lm, card)
    sched = poisson_schedule(
        SERVE_REQUESTS, 20.0, vocab_size=SERVE_CFG["vocab_size"],
        prompt_lens=SERVE_PROMPT_LENS, max_new_tokens=(16, 32, 64), seed=7)
    # warm the card (allocator, matmul library) outside the measured runs
    warm = DecodeServer(lm, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN)
    warm.submit(sched[0].prompt, 4)
    warm.drain()
    refs = {a.prompt.tobytes(): lm.generate(a.prompt[None],
                                            a.max_new_tokens)[0].cpu().numpy()
            for a in sched}
    torch.cuda.synchronize()

    streams, launches = {}, 0
    for k in (1, 4):
        srv = DecodeServer(lm, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                           fuse_steps=k)
        flash_attention_fwd.launches = 0
        report = run_open_loop(srv, sched)
        torch.cuda.synchronize()
        launches = flash_attention_fwd.launches
        s = report.summary()
        st = srv.stats()
        print(f"serve fuse_steps={k}: finished={s['finished']} "
              f"tokens={s['tokens']} tokens_per_sec={s['tokens_per_sec']} "
              f"ttft_p50_ms={s['ttft_p50_ms']} "
              f"p50_latency_ms={s['p50_latency_ms']} "
              f"kv_pool_bytes={st['kv_pool_bytes']} "
              f"prefill_buckets={st['compiles']['prefill_buckets']} "
              f"flash_launches={launches} [{card}]")
        if s["finished"] != len(sched):
            raise AssertionError(f"fuse_steps={k}: {s['finished']} of "
                                 f"{len(sched)} requests finished")
        want = lm.num_layers * len(sched)
        if launches != want:
            raise AssertionError(
                f"fuse_steps={k}: flash kernel launched {launches} times, "
                f"expected num_layers x prefills = {want}")
        for req in srv.finished:
            key = req.prompt.tobytes()
            if not np.array_equal(req.output, refs[key]):
                diff = int(np.argmax(req.output != refs[key]))
                raise AssertionError(
                    f"fuse_steps={k}: stream of the {req.prompt.shape[0]}"
                    f"-token prompt differs from lm.generate at index "
                    f"{diff}")
            streams.setdefault(key, []).append(req.output)
    for outs in streams.values():
        if not np.array_equal(outs[0], outs[1]):
            raise AssertionError("fuse_steps 1 and 4 streams differ")
    print(f"serve: {len(streams)} greedy streams equal lm.generate at "
          f"fuse_steps 1 and 4 [{card}]")
    return launches


# ---------------------------------------------------------------------------
# phase 4: flash-attention backward against its plain version
# ---------------------------------------------------------------------------
def sdpa_backward_ms(q, k, v, do, causal, window) -> float:
    """Device time of the backward of ``F.scaled_dot_product_attention``
    alone (the graph is kept and only ``autograd.grad`` is timed)."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    mask = None
    if window is not None:
        i = torch.arange(q.shape[1], device=q.device)
        mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                         is_causal=causal and mask is None)
    dot = do.transpose(1, 2)
    return cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                               retain_graph=True))


def check_flash_bwd(card: str) -> list:
    import torch
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4321)
    cases = [c for c in flash_cases() if not c[0].startswith("main path")]
    failures, entries = [], []
    for label, b, tq, tkv, h, d, causal, window in cases:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            q, k, v, do = (torch.randn((b, t, h, d), generator=gen,
                                       device="cuda").to(dtype)
                           for t in (tq, tkv, tkv, tq))
            kw = dict(causal=causal, window=window)
            out, lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
            delta = fa._delta(out, do)
            args = (q, k, v, do, lse, delta)
            dk, dv = fa.flash_attention_bwd_dkdv(*args, **kw)
            dq = fa.flash_attention_bwd_dq(*args, **kw)
            ref_dq, ref_dk, ref_dv = fa.flash_attention_bwd_reference(
                q, k, v, out, lse, do, **kw)
            torch.cuda.synchronize()
            err = {"dkdv": max(float((dk - ref_dk).abs().max()),
                               float((dv - ref_dv).abs().max())),
                   "dq": float((dq - ref_dq).abs().max())}
            finite = all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv))
            ok = finite and max(err.values()) <= BWD_TOL[name]
            ms = {"dkdv": cuda_ms(
                      lambda: fa.flash_attention_bwd_dkdv(*args, **kw)),
                  "dq": cuda_ms(lambda: fa.flash_attention_bwd_dq(*args,
                                                                  **kw))}
            keep = fa._keep(tq, tkv, causal, window, device="cuda")
            scale = fa._scale(q, None)
            plain_ms = {"dkdv": cuda_ms(lambda: fa._dkdv(*args, keep, scale)),
                        "dq": cuda_ms(lambda: fa._dq(*args, keep, scale))}
            lib_ms = sdpa_backward_ms(q, k, v, do, causal, window)
            bound = fa.flash_bwd_bound(b, tq, tkv, h, d, dtype, causal=causal,
                                       window=window)
            for kern in ("dkdv", "dq"):
                print(f"flash_bwd_{kern} {label} {name} "
                      f"[{variant(kern, name)}]: "
                      f"max_abs_err={err[kern]:.3e} "
                      f"(tol {BWD_TOL[name]:.0e}) kernel_ms={ms[kern]:.5f} "
                      f"plain_ms={plain_ms[kern]:.5f} "
                      f"bound_ms={bound[kern]['bound_ms']:.6f} "
                      f"({bound[kern]['bound_by']}){cuda_core(bound[kern])} "
                      f"{'ok' if ok else 'MISMATCH'} [{card}]")
            print(f"flash_bwd {label} {name}: B2+B3 kernel_ms="
                  f"{ms['dkdv'] + ms['dq']:.5f} sdpa_backward_ms={lib_ms:.5f}"
                  f" [{card}]")
            if not ok:
                failures.append(f"{label} {name}: err {err} finite {finite}")
            if label == train_case()[0]:
                for kern, fn in (("dkdv", fa.flash_attention_bwd_dkdv),
                                 ("dq", fa.flash_attention_bwd_dq)):
                    same = same_twice(lambda: fn(*args, **kw))
                    print(f"flash_bwd_{kern} {label} {name}: two launches "
                          f"bitwise identical: {same} [{card}]")
                    if not same:
                        failures.append(f"{label} {name}: two {kern} "
                                        "launches differ")
                for kern, line in (("dkdv", 391), ("dq", 432)):
                    entries.append({
                        "name": f"flash_attention_bwd_{kern}",
                        "route": "cuda",
                        "variant": variant(kern, name),
                        "source": "deeplearning4j_tpu_torch/kernels/csrc/"
                                  "flash_bwd.cu",
                        "replaces": "deeplearning4j_tpu/pallas/"
                                    f"flash_attention.py:{line}",
                        "launches": None,
                        "max_abs_err": err[kern],
                        "ms": ms[kern], "plain_ms": plain_ms[kern],
                        "bound_ms": bound[kern]["bound_ms"],
                        "bound_by": bound[kern]["bound_by"],
                        # one call computes B2 and B3 together
                        "library_ms": lib_ms,
                        "library_call": "F.scaled_dot_product_attention "
                                        "backward (dq, dk, dv)",
                        "shape": [b, tq, h, d], "dtype": name,
                    })
                    if "cuda_core_bound_ms" in bound[kern]:
                        entries[-1]["cuda_core_bound_ms"] = \
                            bound[kern]["cuda_core_bound_ms"]
            del q, k, v, do, out, lse, delta, args, dq, dk, dv, keep
    if failures:
        raise AssertionError("flash backward kernels disagree with their "
                             "plain version: " + "; ".join(failures))
    return entries


# ---------------------------------------------------------------------------
# phase 5: train the slice's model
# ---------------------------------------------------------------------------
def launch_counts() -> dict:
    """B1–B3's launches that ran on the card: the wrappers' counts, less
    the launches a CUDA-graph capture recorded, plus what replays ran
    (``perf.step_graph.kernel_launches``)."""
    from deeplearning4j_tpu_torch.perf import step_graph

    return step_graph.kernel_launches()


def reset_launch_counts() -> None:
    from deeplearning4j_tpu_torch.perf import step_graph

    step_graph.reset_kernel_launches()


def train_tokens(batch: int = TRAIN_BATCH):
    import numpy as np

    return np.random.default_rng(0).integers(
        0, TRAIN_CFG["vocab_size"], (batch, TRAIN_T))


def train(card: str) -> dict:
    """Steps of the headline model; returns the kernels' launches over
    the timed steps."""
    import torch
    from deeplearning4j_tpu_torch.dtypes import tree_leaves
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM

    lm = TransformerLM(**TRAIN_CFG).init()
    impl = lm._attn_impl(TRAIN_T, train=True)
    if impl != "flash":
        raise AssertionError(f"attn_impl='auto' resolved to {impl!r} for "
                             "training, not 'flash'")
    tok = torch.as_tensor(train_tokens(), device="cuda")
    warm = [lm.fit_batch(tok) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, per_step, host = [], [], 0.0
    t0 = time.monotonic()
    for _ in range(TRAIN_STEPS):
        before = launch_counts()
        t = time.monotonic()
        losses.append(lm.fit_batch(tok, block=False))
        host += time.monotonic() - t
        per_step.append({k: n - before[k]
                         for k, n in launch_counts().items()})
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = launch_counts()
    losses = [float(x) for x in losses]
    ms_step = wall / TRAIN_STEPS * 1e3
    tps = TRAIN_BATCH * TRAIN_T * TRAIN_STEPS / wall
    fpt = lm.flops_per_token(TRAIN_T)
    print(f"train [{TRAIN_BATCH}, {TRAIN_T}] mixed_bf16 attn={impl}: "
          f"warmup_losses={warm} losses={losses} ms_per_step={ms_step} "
          f"host_ms_per_step={host / TRAIN_STEPS * 1e3} "
          f"tokens_per_sec={tps} flops_per_token={fpt} "
          f"share_of_bf16_peak={fpt * tps / H100_BF16_FLOPS} "
          f"peak_mem_bytes={torch.cuda.max_memory_allocated()} "
          f"launches={launches} [{card}]")
    if not all(math.isfinite(x) for x in warm + losses):
        raise AssertionError(f"non-finite loss: {warm + losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall on a repeated batch: "
                             f"{losses}")
    for i, counts in enumerate(per_step):
        if any(n != lm.num_layers for n in counts.values()):
            raise AssertionError(f"step {i} launched {counts}, expected "
                                 f"{lm.num_layers} of each kernel")
    for x in tree_leaves((lm.params, lm.opt_state)):
        if x.dtype != torch.float32 or x.requires_grad:
            raise AssertionError(f"a master or moment is {x.dtype} "
                                 f"(requires_grad={x.requires_grad})")
    traced = traced_launches(lambda: lm.fit_batch(tok),
                             "train fit_batch, one replayed step", card)
    if any(n != lm.num_layers for n in traced.values()):
        raise AssertionError(f"the traced step launched {traced}")
    check_train_unembedding(lm, card)
    return launches


def unembed_inputs(lm, rows: int):
    """``(params, h, g)`` for the unembedding at a train step's shape: the
    step's compute-dtype copy of ``embed`` (requiring grad) and ``ln_f``,
    a seeded hidden state of ``rows`` rows in the compute dtype
    (requiring grad) and an f32 upstream gradient, on the card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(99)
    params = lm.policy.compute_copy({"embed": lm.params["embed"],
                                     "ln_f": lm.params["ln_f"]})
    params["embed"] = params["embed"].detach().requires_grad_()
    h = torch.randn((rows, lm.d_model), device="cuda", generator=gen).to(
        lm.policy.compute_dtype).requires_grad_()
    g = torch.randn((rows, lm.vocab_size), device="cuda", generator=gen)
    return params, h, g


def unembed_ms(lm, rows: int, *, train: bool, iters: int = 10) -> float:
    """Forward and backward of the training unembedding
    (``lm._unembed_train``: bf16 products, f32 sums) or, with
    ``train=False``, of the decode one (``lm._unembed``: f64 sums) on
    :func:`unembed_inputs` (CUDA events)."""
    import torch

    params, h, g = unembed_inputs(lm, rows)
    fn = lm._unembed_train if train else lm._unembed
    return cuda_ms(lambda: torch.autograd.grad(
        fn(params, h), (h, params["embed"]), g), iters=iters)


def mm_dtype_differentiates() -> bool:
    """Whether this torch can differentiate ``torch.mm(...,
    out_dtype=torch.float32)`` by itself (the port does not rely on it:
    ``_UnembedBF16`` writes the backward)."""
    import torch

    a = torch.ones((16, 16), device="cuda", dtype=torch.bfloat16,
                   requires_grad=True)
    try:
        torch.mm(a, a, out_dtype=torch.float32).sum().backward()
    except RuntimeError:
        return False
    return True


def check_train_unembedding(lm, card: str) -> None:
    """The training unembedding on the card (bf16 GEMMs with f32 output)
    against its plain version at the train step's shape: the f32 product
    of the same operands widened to f32 with TF32 off, under autograd.
    Logits within 1e-4 (exact products, f32 sums in two orders, logits
    of magnitude < 3 here); gradients within 2e-2 of their largest
    magnitude, the forward's bf16 gate (both sides round each gradient
    to bf16, one ulp apart at most, 2^-8; the card's side also rounds the
    upstream gradient to bf16 before the backward products). Prints its
    time and the decode unembedding's (f64 sums), which training ran
    before."""
    import torch
    from deeplearning4j_tpu_torch.models.transformer import _layernorm

    torch.backends.cuda.matmul.allow_tf32 = False
    n = TRAIN_BATCH * TRAIN_T
    params, h, g = unembed_inputs(lm, n)
    e = params["embed"]
    got = lm._unembed_train(params, h)
    got_grads = torch.autograd.grad(got, (h, e), g)
    hf = _layernorm(h, params["ln_f"]["g"], params["ln_f"]["b"])
    want = hf.float() @ e.float().T
    want_grads = torch.autograd.grad(want, (h, e), g)
    err = float((got - want).detach().abs().max())
    grad_err = max(float((a.float() - b.float()).abs().max())
                   / float(b.float().abs().max())
                   for a, b in zip(got_grads, want_grads))
    ok = got.dtype == torch.float32 and err <= 1e-4 and grad_err <= 2e-2
    train_ms = unembed_ms(lm, n, train=True)
    decode_ms = unembed_ms(lm, n, train=False)
    print(f"train unembedding [{n}, {lm.d_model}] x [{lm.vocab_size}, "
          f"{lm.d_model}] bf16 -> f32 vs widened f32: max_abs_err={err:.3e} "
          f"(tol 1e-4) grad_rel_err={grad_err:.3e} (tol 2e-2) "
          f"fwd_bwd_ms={train_ms:.5f} decode_f64_fwd_bwd_ms={decode_ms:.5f} "
          f"mm_dtype_differentiates={mm_dtype_differentiates()} "
          f"{'ok' if ok else 'MISMATCH'} [{card}]")
    if not ok:
        raise AssertionError("the training unembedding disagrees with its "
                             "plain version")


def check_train_parity(card: str) -> None:
    """Flash against plain attention on the card at full width, batch 2,
    on the same weights."""
    import torch
    from deeplearning4j_tpu_torch.dtypes import tree_leaves, tree_map
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM

    torch.backends.cuda.matmul.allow_tf32 = False
    tok = torch.as_tensor(train_tokens(2), device="cuda")

    def pair(policy):
        flash = TransformerLM(**{**TRAIN_CFG, "dtype_policy": policy,
                                 "attn_impl": "flash"}).init()
        plain = TransformerLM(**{**flash.get_config(), "attn_impl": "xla"},
                              device=flash.device)
        plain.params = tree_map(torch.clone, flash.params)
        plain.opt_state = tree_map(torch.clone, flash.opt_state)
        return flash, plain

    # float32: one step's loss and gradients (tests/test_models.py gate)
    flash, plain = pair("float32")
    got = {}
    for name, lm in (("flash", flash), ("plain", plain)):
        fwd = tree_map(lambda p: p.detach().requires_grad_(), lm.params)
        leaves = tree_leaves(fwd)
        loss = lm.loss(fwd, tok, train=True)
        got[name] = (loss.detach(), torch.autograd.grad(loss, leaves))
    (lf, gf), (lp, gp) = got["flash"], got["plain"]
    err_loss = float((lf - lp).abs())
    excess = max(float(((a - b).abs() - (1e-3 + 2e-3 * b.abs())).max())
                 for a, b in zip(gf, gp))
    err_grad = max(float((a - b).abs().max()) for a, b in zip(gf, gp))
    ok32 = err_loss <= 1e-3 + 2e-3 * abs(float(lp)) and excess <= 0.0
    print(f"train parity float32 [2, {TRAIN_T}] flash vs plain: "
          f"loss {float(lf)} vs {float(lp)} grad_max_abs_err={err_grad:.3e}"
          f" (rtol 2e-3, atol 1e-3) {'ok' if ok32 else 'MISMATCH'} [{card}]")
    del flash, plain, got, gf, gp

    # mixed_bf16: loss and params after 3 steps
    flash, plain = pair("mixed_bf16")
    la = [flash.fit_batch(tok) for _ in range(3)]
    lb = [plain.fit_batch(tok) for _ in range(3)]
    err_l = max(abs(a - b) for a, b in zip(la, lb))
    err_p = max(float((a - b).abs().max()) for a, b in
                zip(tree_leaves(flash.params), tree_leaves(plain.params)))
    okbf = err_l <= 2e-2 and err_p <= 1e-2
    print(f"train parity mixed_bf16 [2, {TRAIN_T}] 3 steps flash vs plain: "
          f"losses {la} vs {lb} loss_err={err_l:.3e} (tol 2e-2) "
          f"param_err={err_p:.3e} (tol 1e-2) "
          f"{'ok' if okbf else 'MISMATCH'} [{card}]")
    if not (ok32 and okbf):
        raise AssertionError("flash training disagrees with the plain "
                             "attention path")


# ---------------------------------------------------------------------------
# phase 6: the DL4J network surface (MultiLayerNetwork on the zoo models)
# ---------------------------------------------------------------------------
# bench.py's sizes for its network benches: bench_lenet (batch 1024),
# bench_mlp (batch 4096, hidden 256) and bench_resnet18 (batch 256), all
# under dtype "bf16"
NETWORKS = {"lenet5": (1024, (28, 28, 1)), "mnist_mlp": (4096, (784,)),
            "resnet18": (256, (32, 32, 3))}
NET_WARMUP, NET_FUSED, NET_FUSED_REPEATS = 2, 10, 2
NET_STEPS = {"lenet5": 20, "mnist_mlp": 20, "resnet18": 10}  # timed fits
# the card against the CPU; the full-width ResNet-18 steps on the CPU too
NET_PARITY_BATCH = {"lenet5": 64, "mnist_mlp": 64, "resnet18": 8}
# Adam's first step moves every weight by about ±lr whatever its
# gradient's size, so a gradient element whose bf16 rounding differs
# between the card and the CPU moves that weight 2·lr apart. Batch 8 of
# ResNet-18 is learnt in one step; at the zoo's lr of 1e-3 its running
# statistics then differ between bf16 and float32 on the CPU alone by
# more than a gate that could tell a fault from rounding allows (the
# phase prints both figures); at 1e-4 they do not.
NET_PARITY_LR = {"resnet18": 1e-4}
# forward FLOPs per sample as bench.py counts them (bench_resnet18's
# analytic CIFAR ResNet-18 figure); a training step is taken as 3x
NET_FWD_FLOPS = {"resnet18": 1.11e9}


def network_data(name: str, batch: int):
    """bench.py's inputs: ``np.random.default_rng(0)`` draws in [0, 1) and
    one-hot labels over 10 classes."""
    import numpy as np

    rng = np.random.default_rng(0)
    x = rng.random((batch,) + NETWORKS[name][1], np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, batch)]
    return x, y


def build_network(name: str, policy: str, device: str, **kw):
    """A zoo network at the bench's widths (a ``MultiLayerNetwork``, or for
    ResNet-18 a ``ComputationGraph``), initialised from seed 12345 (the
    same weights on every device: ``init`` draws on a CPU generator)."""
    from deeplearning4j_tpu_torch.models import zoo

    if name == "mnist_mlp":
        kw["hidden"] = 256
    return getattr(zoo, name)(dtype_policy=policy, device=device, **kw).init()


def flat(tree):
    """A tree of tensors (a network's params or its net state, which holds
    BatchNorm's running statistics) as one float32 numpy vector."""
    import numpy as np
    from deeplearning4j_tpu_torch.dtypes import tree_leaves

    return np.concatenate([np.zeros(0, np.float32)] + [
        t.detach().float().cpu().numpy().ravel() for t in tree_leaves(tree)])


def train_network(name: str, card: str) -> None:
    """Warm-up, timed ``fit`` and ``fit_steps`` calls at the bench's batch
    under ``bf16``, on one batch placed on the card once."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet

    batch = NETWORKS[name][0]
    steps = NET_STEPS[name]
    net = build_network(name, "bf16", "cuda")
    x, y = network_data(name, batch)
    ds = DataSet(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warm = []
    for _ in range(NET_WARMUP):
        net.fit(ds)
        warm.append(net.score_value)
    torch.cuda.synchronize()
    scores, host = [], 0.0
    t0 = time.monotonic()
    for _ in range(steps):
        t = time.monotonic()
        net.fit(ds)
        host += time.monotonic() - t
        scores.append(net._score)  # a device scalar: no sync per step
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    losses = [float(v) for v in scores]
    fused = []
    for _ in range(NET_FUSED_REPEATS):
        t = time.monotonic()
        net.fit_steps(ds, NET_FUSED)
        f_host = time.monotonic() - t
        torch.cuda.synchronize()
        fused.append((time.monotonic() - t, f_host, net.score_value))
    peak_mem = torch.cuda.max_memory_allocated()
    f_wall = sum(f[0] for f in fused)
    f_host = sum(f[1] for f in fused)
    f_steps = NET_FUSED * NET_FUSED_REPEATS
    sps, f_sps = batch * steps / wall, batch * f_steps / f_wall
    peak_share = ""
    if name in NET_FWD_FLOPS:
        step_flops = 3 * NET_FWD_FLOPS[name]
        peak_share = (f"share_of_bf16_peak={step_flops * sps / H100_BF16_FLOPS}"
                      f" (fit_steps {step_flops * f_sps / H100_BF16_FLOPS}) ")
    print(f"networks {name} [{batch}, {', '.join(map(str, NETWORKS[name][1]))}] "
          f"bf16: warmup_losses={warm} losses={losses} "
          f"fit: ms_per_step={wall / steps * 1e3} "
          f"host_ms_per_step={host / steps * 1e3} "
          f"samples_per_sec={sps} "
          f"fit_steps({NET_FUSED}) x{NET_FUSED_REPEATS}: "
          f"ms_per_step={f_wall / f_steps * 1e3} "
          f"host_ms_per_step={f_host / f_steps * 1e3} "
          f"samples_per_sec={f_sps} {peak_share}"
          f"peak_mem_bytes={peak_mem} "
          f"fused_losses={[f[2] for f in fused]} "
          f"iterations={net.iteration_count} [{card}]")
    every = warm + losses + [f[2] for f in fused]
    if not all(math.isfinite(v) for v in every):
        raise AssertionError(f"{name}: non-finite loss: {every}")
    if not (losses[-1] < losses[0] and fused[-1][2] < losses[-1]):
        raise AssertionError(f"{name}: loss did not fall on a repeated "
                             f"batch: {every}")
    if net.iteration_count != NET_WARMUP + steps + f_steps:
        raise AssertionError(f"{name}: {net.iteration_count} iterations")
    check_network_evaluate(name, net, ds, card)


def check_network_evaluate(name: str, net, ds, card: str) -> None:
    """``evaluate`` with the confusion matrix on the card equals the host
    path (every batch's outputs read back), over ragged batches of 1000."""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator

    it = ListDataSetIterator(ds, batch_size=1000)
    before = net._eval_readbacks
    dev = net.evaluate(it, device_accumulation=True).confusion.to_array()
    host = net.evaluate(it, device_accumulation=False).confusion.to_array()
    same = (dev == host).all() and int(dev.sum()) == ds.num_examples()
    print(f"networks evaluate {name}: device "
          f"confusion == host confusion: {bool(same)} "
          f"(readbacks {net._eval_readbacks - before}) [{card}]")
    if not same or net._eval_readbacks - before != 1:
        raise AssertionError("device evaluate disagrees with the host path")


def check_network_parity(name: str, card: str) -> None:
    """The card against the CPU on the same weights (batch 64; ResNet-18
    8): one step's loss and gradients under float32 with TF32 off (rtol
    2e-3, atol 1e-3), and the loss, params and BatchNorm running
    statistics after 3 ``fit`` steps under ``bf16`` (2e-2, 1e-2), the
    train phase's gates."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.dtypes import tree_leaves
    from deeplearning4j_tpu_torch.nn import ComputationGraph

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pbatch = NET_PARITY_BATCH[name]
    x, y = network_data(name, pbatch)

    def on(device, policy, **kw):
        net = build_network(name, policy, device, **kw)
        return (net, torch.from_numpy(x).to(device),
                torch.from_numpy(y).to(device))

    got = {}
    for device in ("cuda", "cpu"):
        net, xd, yd = on(device, "float32")
        if isinstance(net, ComputationGraph):
            xd, yd = [xd], [yd]
        loss, (state, _), grads = net._loss_grads(net.params, net.net_state,
                                                  xd, yd)
        got[device] = (loss.cpu(), [g.cpu() for g in tree_leaves(grads)]
                       + [s.cpu() for s in tree_leaves(state)],
                       flat(net.params))
    (lc, gc, pc), (lh, gh, ph) = got["cuda"], got["cpu"]
    if not (pc == ph).all():
        raise AssertionError(f"{name}: the card and the CPU drew other "
                             "weights from one seed")
    excess = max(float(((a - b).abs() - (1e-3 + 2e-3 * b.abs())).max())
                 for a, b in zip(gc + [lc], gh + [lh]))
    err_grad = max(float((a - b).abs().max()) for a, b in zip(gc, gh))
    ok32 = excess <= 0.0
    print(f"networks parity {name} float32 [{pbatch}] card vs cpu: "
          f"loss {float(lc)} vs {float(lh)} grad_and_new_stats_max_abs_err="
          f"{err_grad:.3e} (rtol 2e-3, atol 1e-3) "
          f"{'ok' if ok32 else 'MISMATCH'} [{card}]")

    def three_steps(device, policy, **kw):
        net, xd, yd = on(device, policy, **kw)
        losses = []
        for _ in range(3):
            net.fit(DataSet(xd, yd))
            losses.append(net.score_value)
        return (losses, flat(net.params),
                [flat(st) for st in net.net_state.values() if st])

    def stats_err(a, b):
        return max((float(abs(x - y).max()) for x, y in zip(a[2], b[2])),
                   default=0.0)

    lr = NET_PARITY_LR.get(name)
    kw = {} if lr is None else {"lr": lr}
    (la, pa, sa), (lb, pb, sb) = (three_steps(d, "bf16", **kw)
                                  for d in ("cuda", "cpu"))
    err_l = max(abs(a - b) for a, b in zip(la, lb))
    err_p = float(abs(pa - pb).max())
    # a BatchNorm's running statistics are sums of bf16-rounded conv
    # outputs: their rounding scales with the largest of the layer's
    # statistics (running variances reach a few units), so each layer's
    # are held at atol 1e-2 plus rtol 2e-2 of that largest value
    err_s = stats_err((la, pa, sa), (lb, pb, sb))
    excess_s = max((float(abs(a - b).max() - 1e-2 - 2e-2 * abs(b).max())
                    for a, b in zip(sa, sb)), default=0.0)
    okbf = err_l <= 2e-2 and err_p <= 1e-2 and excess_s <= 0.0
    print(f"networks parity {name} bf16 [{pbatch}] 3 steps card vs "
          f"cpu{'' if lr is None else f' (lr {lr})'}: losses {la} vs {lb} "
          f"loss_err={err_l:.3e} (tol 2e-2) "
          f"param_err={err_p:.3e} (tol 1e-2) "
          f"running_stats_max_abs_err={err_s:.3e} of largest "
          f"{max((float(abs(b).max()) for b in sb), default=0.0):.3e} "
          f"(atol 1e-2 + 2e-2 x a layer's largest) "
          f"{'ok' if okbf else 'MISMATCH'} [{card}]")
    if lr is not None:
        # why the gate runs at that lr: at the zoo's, rounding alone
        # moves the running statistics past it (NET_PARITY_LR)
        card_bf, cpu_bf, cpu_32 = (three_steps(d, p) for d, p in (
            ("cuda", "bf16"), ("cpu", "bf16"), ("cpu", "float32")))
        print(f"networks parity {name} [{pbatch}] 3 steps at the zoo's lr, "
              f"not gated: running_stats_max_abs_err bf16 card vs cpu "
              f"{stats_err(card_bf, cpu_bf):.3e}, bf16 vs float32 on the "
              f"cpu {stats_err(cpu_bf, cpu_32):.3e}, of largest "
              f"{max(float(abs(b).max()) for b in cpu_32[2]):.3e}; "
              f"param_max_abs_err {float(abs(card_bf[1] - cpu_bf[1]).max()):.3e}"
              f" and {float(abs(cpu_bf[1] - cpu_32[1]).max()):.3e} [{card}]")
    if not (ok32 and okbf):
        raise AssertionError(f"{name} on the card disagrees with the CPU")


def networks(card: str) -> None:
    """Phase 6: LeNet-5 and the MNIST MLP through ``MultiLayerNetwork``,
    ResNet-18 through ``ComputationGraph``. The path is cuDNN, cuBLAS and
    eager torch: it must launch none of the flash kernels."""
    reset_launch_counts()
    for name in NETWORKS:
        train_network(name, card)
        check_network_parity(name, card)
    if any(launch_counts().values()):
        raise AssertionError(f"the networks phase launched a flash kernel: "
                             f"{launch_counts()}")


# ---------------------------------------------------------------------------
# phase 7: the recurrent path (the char-LSTM with truncated BPTT)
# ---------------------------------------------------------------------------
# bench.py's bench_char_lstm (bench.py:320-341), nothing cut: vocab 128,
# two GravesLSTM layers of 256, TBPTT windows of 50, batch 128 x t 200,
# under "bf16" with Adam at the zoo's lr 3e-3; 4 windows, so 4 steps a fit
RNN_CFG = dict(vocab_size=128, hidden=256, layers=2, tbptt_length=50,
               seed=12345)
RNN_BATCH, RNN_T = 128, 200
RNN_WARMUP, RNN_FITS = 1, 5
RNN_PARITY_BATCH = 8
# generation: stepwise against the full forward. bf16 rounds the second
# layer's input GEMM over [128, 256] rows per step and over [25600, 256]
# in one go; cuBLAS may sum each in another order, so bf16's gate holds
# the softmax outputs; float32 with TF32 off holds them at 1e-4
RNN_GEN_TOL = {"bf16": 2e-2, "float32": 1e-4}


def char_lstm_data(batch: int):
    """bench.py's draw: ``np.random.default_rng(0)`` character ids, one-hot
    ``x`` and ``y`` = ``x`` one step ahead (rolled)."""
    import numpy as np

    vocab = RNN_CFG["vocab_size"]
    idx = np.random.default_rng(0).integers(0, vocab, (batch, RNN_T))
    eye = np.eye(vocab, dtype=np.float32)
    return eye[idx], eye[np.roll(idx, -1, axis=1)]


def char_lstm_flops_per_token() -> int:
    """Forward FLOPs a token from the widths: each GravesLSTM layer's input
    and recurrent GEMMs, 2·(n_in + h)·4h, and the output layer's 2·h·vocab
    (1.90 MFLOP at the bench's widths; a training step is taken as 3x)."""
    v, h = RNN_CFG["vocab_size"], RNN_CFG["hidden"]
    n_in, flops = v, 2 * h * v
    for _ in range(RNN_CFG["layers"]):
        flops += 2 * (n_in + h) * 4 * h
        n_in = h
    return flops


def build_char_lstm(policy: str, device: str, **kw):
    """``zoo.char_lstm`` at the bench's widths, from seed 12345 (the same
    weights on every device)."""
    from deeplearning4j_tpu_torch.models import zoo

    return zoo.char_lstm(dtype_policy=policy, device=device,
                         **{**RNN_CFG, **kw}).init()


def train_char_lstm(card: str):
    """Warm-up and timed ``fit`` calls at the bench's size; returns the
    network and its batch on the card."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet

    net = build_char_lstm("bf16", "cuda")
    x, y = char_lstm_data(RNN_BATCH)
    ds = DataSet(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warm = []
    for _ in range(RNN_WARMUP):
        net.fit(ds)
        warm.append(net.score_value)
    torch.cuda.synchronize()
    scores, host = [], 0.0
    t0 = time.monotonic()
    for _ in range(RNN_FITS):
        t = time.monotonic()
        net.fit(ds)
        host += time.monotonic() - t
        scores.append(net._score)  # the last window's loss, on the card
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    losses = [float(v) for v in scores]
    windows = -(-RNN_T // RNN_CFG["tbptt_length"])
    sps = RNN_BATCH * RNN_FITS / wall
    train_flops = 3 * char_lstm_flops_per_token()
    print(f"recurrent char_lstm [{RNN_BATCH}, {RNN_T}, "
          f"{RNN_CFG['vocab_size']}] hidden {RNN_CFG['hidden']} x"
          f"{RNN_CFG['layers']} tbptt {RNN_CFG['tbptt_length']} bf16: "
          f"warmup_losses={warm} losses={losses} "
          f"ms_per_fit={wall / RNN_FITS * 1e3} "
          f"host_ms_per_fit={host / RNN_FITS * 1e3} "
          f"steps_per_fit={windows} samples_per_sec={sps} "
          f"tokens_per_sec={sps * RNN_T} "
          f"share_of_bf16_peak={train_flops * sps * RNN_T / H100_BF16_FLOPS} "
          f"(train_flops_per_token={train_flops}) "
          f"peak_mem_bytes={torch.cuda.max_memory_allocated()} "
          f"iterations={net.iteration_count} [{card}]")
    every = warm + losses
    if not all(math.isfinite(v) for v in every):
        raise AssertionError(f"char_lstm: non-finite loss: {every}")
    if not losses[-1] < warm[0]:
        raise AssertionError(f"char_lstm: the last window's loss did not "
                             f"fall on a repeated batch: {every}")
    if net.iteration_count != windows * (RNN_WARMUP + RNN_FITS):
        raise AssertionError(f"char_lstm: {net.iteration_count} iterations")
    return net, ds


def check_char_lstm_parity(card: str) -> None:
    """The card against the CPU on the same weights at batch 8, full width
    and t 200: under float32 with TF32 off, the first window's loss,
    gradients and carried state (rtol 2e-3, atol 1e-3), then one whole
    ``fit`` (4 windows) on loss and params (the same); under ``bf16``, one
    whole ``fit`` at the zoo's lr: loss 2e-2, params 1e-2."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.dtypes import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pbatch, w = RNN_PARITY_BATCH, RNN_CFG["tbptt_length"]
    x, y = char_lstm_data(pbatch)

    def rel_excess(got, want):
        return max(float(((a - b).abs() - (1e-3 + 2e-3 * b.abs())).max())
                   for a, b in zip(got, want))

    window, fits = {}, {}
    for device in ("cuda", "cpu"):
        net = build_char_lstm("float32", device)
        xd, yd = (torch.from_numpy(a[:, :w]).to(device) for a in (x, y))
        loss, (_, carry), grads = net._loss_grads(
            net.params, net.net_state, xd, yd,
            rnn_state=net._zero_rnn_state(pbatch))
        window[device] = ([loss.cpu()] + [g.cpu() for g in tree_leaves(grads)]
                          + [c.detach().cpu() for c in tree_leaves(carry)],
                          flat(net.params))
        for policy in ("float32", "bf16"):
            net = build_char_lstm(policy, device)
            net.fit(DataSet(*(torch.from_numpy(a).to(device) for a in (x, y))))
            fits[policy, device] = (torch.tensor(net.score_value),
                                    torch.from_numpy(flat(net.params)))
    if not (window["cuda"][1] == window["cpu"][1]).all():
        raise AssertionError("char_lstm: the card and the CPU drew other "
                             "weights from one seed")
    err_w = max(float((a - b).abs().max())
                for a, b in zip(window["cuda"][0], window["cpu"][0]))
    ok_w = rel_excess(window["cuda"][0], window["cpu"][0]) <= 0.0
    (lc, pc), (lh, ph) = fits["float32", "cuda"], fits["float32", "cpu"]
    ok_f = rel_excess([lc, pc], [lh, ph]) <= 0.0
    (bc, bpc), (bh, bph) = fits["bf16", "cuda"], fits["bf16", "cpu"]
    err_bl, err_bp = abs(float(bc - bh)), float((bpc - bph).abs().max())
    ok_b = err_bl <= 2e-2 and err_bp <= 1e-2
    print(f"recurrent parity float32 [{pbatch}, {RNN_T}] card vs cpu: "
          f"window 0 loss {float(window['cuda'][0][0])} vs "
          f"{float(window['cpu'][0][0])}, loss_grads_and_carry_max_abs_err="
          f"{err_w:.3e} (rtol 2e-3, atol 1e-3) {'ok' if ok_w else 'MISMATCH'}"
          f"; one fit (4 windows) loss {float(lc)} vs {float(lh)} "
          f"param_max_abs_err={float((pc - ph).abs().max()):.3e} "
          f"(rtol 2e-3, atol 1e-3) {'ok' if ok_f else 'MISMATCH'} [{card}]")
    print(f"recurrent parity bf16 [{pbatch}, {RNN_T}] one fit (4 windows) "
          f"card vs cpu at lr {3e-3}: loss {float(bc)} vs {float(bh)} "
          f"loss_err={err_bl:.3e} (tol 2e-2) param_err={err_bp:.3e} "
          f"(tol 1e-2) {'ok' if ok_b else 'MISMATCH'} [{card}]")
    if not (ok_w and ok_f and ok_b):
        raise AssertionError("char_lstm on the card disagrees with the CPU")


def check_generation(net, x, policy: str, card: str) -> None:
    """``rnn_time_step`` one character at a time equals the full-sequence
    ``output`` on the same weights (``RNN_GEN_TOL``); prints ms a step."""
    import torch

    with torch.no_grad():
        full = net.output(x)
    net.rnn_clear_previous_state()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    steps = [net.rnn_time_step(x[:, s]) for s in range(x.shape[1])]
    torch.cuda.synchronize()
    ms = (time.monotonic() - t0) / x.shape[1] * 1e3
    err = float((torch.stack(steps, dim=1) - full).abs().max())
    ok = err <= RNN_GEN_TOL[policy] and steps[0].shape == (x.shape[0],
                                                           x.shape[2])
    print(f"recurrent generation {policy} [{x.shape[0]}] {x.shape[1]} "
          f"rnn_time_step calls vs full output: max_abs_err={err:.3e} "
          f"(tol {RNN_GEN_TOL[policy]}) ms_per_step={ms} "
          f"{'ok' if ok else 'MISMATCH'} [{card}]")
    if not ok:
        raise AssertionError(f"{policy} stepwise generation disagrees with "
                             "the full forward")


def recurrent(card: str) -> None:
    """Phase 7: the char-LSTM through ``MultiLayerNetwork``'s truncated
    BPTT, the card against the CPU, and stepwise generation. The path is
    cuBLAS and eager torch: it must launch none of the flash kernels."""
    import torch

    reset_launch_counts()
    net, ds = train_char_lstm(card)
    check_generation(net, ds.features, "bf16", card)
    del net, ds
    check_char_lstm_parity(card)
    x, _ = char_lstm_data(RNN_PARITY_BATCH)
    check_generation(build_char_lstm("float32", "cuda"),
                     torch.from_numpy(x).cuda(), "float32", card)
    if any(launch_counts().values()):
        raise AssertionError(f"the recurrent phase launched a flash kernel: "
                             f"{launch_counts()}")


# ---------------------------------------------------------------------------
# phase 8: the fused training paths, each a CUDA-graph replay per step
# ---------------------------------------------------------------------------
# bench.py's bench_epoch (bench.py:527-590), nothing cut: the MNIST MLP
# (hidden 256) under bf16, 16 batches of 2048 x 784 float32 from
# default_rng(0), 5 epochs
EPOCH_BATCH, EPOCH_BATCHES, EPOCH_EPOCHS = 2048, 16, 5
EPOCH_POISON = 5  # the guard cell's poisoned batch (one NaN feature row)
EPOCH_PARITY = (64, 4, 2)  # card against CPU: batch, batches, epochs
FUSED_NETS = ("lenet5", "resnet18")  # fit_steps cells, the bench's sizes
FUSED_WARMUP, FUSED_STEPS = 2, 10
LM_FUSED_K, LM_FUSED_CALLS = 4, 3  # fit_batch_multi: k steps, calls timed
# the programs cell: ResNet-18 at the bench's batch, 4 batches a epoch
PROGRAMS_NET, PROGRAMS_BATCHES = "resnet18", 4
# the CUDA runtime calls that put work on the card, counted under the
# profiler as the host's launches
HOST_LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                    "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                    "cudaMemcpyAsync", "cudaMemsetAsync")
# the hand-written kernels by the names the card's trace gives them (every
# variant of each: flash_fwd_mma_kernel, flash_fwd_tf32_kernel, ...)
KERNEL_TRACE_NAMES = {"flash_attention_fwd": "flash_fwd_",
                      "flash_attention_bwd_dkdv": "flash_bwd_dkdv_",
                      "flash_attention_bwd_dq": "flash_bwd_dq_"}


def busy_union_s(intervals) -> float:
    """Seconds covered by the union of ``(start_us, end_us)`` intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e6


def profiled(fn, units: int) -> dict:
    """``fn()`` under ``torch.profiler`` (CPU and CUDA activity), per one
    of ``units``: the host's launch calls by API (``cudaGraphLaunch`` is
    one replay), the device's events (kernels, copies, memsets), its
    busy time (their union) and the hand-written kernels it ran
    (``kernels``, by wrapper name) with their device time
    (``kernel_ms``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    host = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in HOST_LAUNCH_APIS:
            host[e.name] = host.get(e.name, 0) + 1
    kernels = {k: sum(tag in e.name for e in device) / units
               for k, tag in KERNEL_TRACE_NAMES.items()}
    kernel_ms = {k: sum(e.time_range.end - e.time_range.start
                        for e in device if tag in e.name) / 1e3 / units
                 for k, tag in KERNEL_TRACE_NAMES.items()}
    return {"host_launches": {k: v / units for k, v in sorted(host.items())},
            "replays": host.get("cudaGraphLaunch", 0) / units,
            "other_host_launches": sum(v for k, v in host.items()
                                       if k != "cudaGraphLaunch") / units,
            "device_events": len(device) / units,
            "device_busy_ms": busy_union_s(
                [(e.time_range.start, e.time_range.end)
                 for e in device]) * 1e3 / units,
            "kernels": kernels, "kernel_ms": kernel_ms}


def traced_launches(fn, what: str, card: str, calls: int = 2) -> dict:
    """Run ``fn()`` ``calls`` times, each under the profiler, and hold
    B1–B3's launches as ``perf.step_graph.kernel_launches`` counts them
    (the wrappers' counts corrected for captures and replays) against the
    kernels the card's trace shows; returns one call's count.

    ``fn()`` must do the same work each time. A trace can lose an
    activity record (once on the H100, one B1 of a 4-step replay's 5,208
    device events), so a call whose trace shows fewer of a kernel than
    counted passes only when its trace also holds fewer device events
    than a call whose trace agrees, by at least as many. A trace showing
    more than counted, calls counting differently, or no call whose trace
    agrees fails. Counts are taken as differences, so the caller's own
    count runs on through the calls."""
    runs = []
    for _ in range(calls):
        before = launch_counts()
        prof = profiled(fn, 1)
        after = launch_counts()
        counted = {k: after[k] - before[k] for k in after}
        traced = {k: int(v) for k, v in prof["kernels"].items()}
        runs.append((counted, traced, int(prof["device_events"])))
        print(f"{what}: B1-B3 launches counted={counted} traced={traced} "
              f"device_events={runs[-1][2]} [{card}]")
    counted = runs[0][0]
    full = [n for c, t, n in runs if t == c]
    if any(c != counted for c, _, _ in runs) or not full:
        raise AssertionError(f"{what}: the launch counts "
                             f"{[c for c, _, _ in runs]} differ from each "
                             f"other or from the card's traces "
                             f"{[t for _, t, _ in runs]}")
    for c, t, n in runs:
        lost = sum(c[k] - t[k] for k in c)
        if any(t[k] > c[k] for k in c) or (lost and n > min(full) - lost):
            raise AssertionError(f"{what}: the launch count {c} differs "
                                 f"from the card's trace {t} ({n} device "
                                 f"events, {min(full)} in a full trace)")
        if lost:
            print(f"{what}: a trace lost {min(full) - n} device event(s), "
                  f"{lost} of them B1-B3 launches [{card}]")
    return counted


def idle_share(prof: dict, wall_ms: float) -> float:
    """The card's idle share of an unprofiled run whose device work the
    profiled run measured."""
    return 1.0 - prof["device_busy_ms"] / wall_ms


def same_state(a, b) -> bool:
    """Bitwise equality of two networks' params, updater and net state."""
    import torch
    from deeplearning4j_tpu_torch.dtypes import tree_leaves

    la = tree_leaves((a.params, a.updater_state, a.net_state))
    lb = tree_leaves((b.params, b.updater_state, b.net_state))
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def max_state_err(a, b) -> float:
    return float(abs(flat((a.params, a.updater_state, a.net_state))
                     - flat((b.params, b.updater_state, b.net_state))).max())


def epoch_data(batch=None, n_batches=None, poison=None):
    """bench_epoch's draw: ``default_rng(0)`` features in [0, 1) and
    one-hot labels over 10 classes; ``poison`` sets one row of that
    batch to NaN."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import DataSet

    batch = batch or EPOCH_BATCH
    n = batch * (n_batches or EPOCH_BATCHES)
    rng = np.random.default_rng(0)
    x = rng.random((n, 784), np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    if poison is not None:
        x[poison * batch + 7] = np.nan
    return DataSet(x, y)


def timed(fn, sync=True):
    """``(wall s, host s)`` of ``fn()``: host is the time to return."""
    import torch

    torch.cuda.synchronize()
    t0 = time.monotonic()
    fn()
    host = time.monotonic() - t0
    if sync:
        torch.cuda.synchronize()
    return time.monotonic() - t0, host


@contextlib.contextmanager
def captured(graphs: bool):
    """Inside the block the fused paths replay CUDA graphs (True) or run
    the same steps eagerly (False): the comparison's switch."""
    from deeplearning4j_tpu_torch.perf import step_graph

    with (contextlib.nullcontext() if graphs
          else step_graph.eager_steps()):
        yield


def memory_mark():
    """Start a memory reading: cached blocks released, the peak reset."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()


def memory_since(mark) -> dict:
    """Device memory since ``mark``: the peak allocated, and what stays
    reserved once cached blocks are released (live tensors and the
    graphs' pools, which cannot be released)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    allocated, reserved = mark
    return {"peak_mem_bytes": torch.cuda.max_memory_allocated() - allocated,
            "resident_bytes": torch.cuda.memory_reserved() - reserved}


def fused_epochs(card: str) -> None:
    """The epoch cell: streaming ``fit`` against ``fit_epochs`` with chunks
    of 1 and of 5 epochs, replayed against the same run eagerly."""
    import torch
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator

    ds = epoch_data()
    total = EPOCH_BATCH * EPOCH_BATCHES * EPOCH_EPOCHS
    it = ListDataSetIterator(ds, EPOCH_BATCH)

    net = build_network("mnist_mlp", "bf16", "cuda")
    net.fit(it)  # warm-up: the first epoch of the streaming loop
    d0 = net._train_dispatches
    wall, host = timed(lambda: net.fit(it, num_epochs=EPOCH_EPOCHS))
    stream = {"samples_per_sec": total / wall,
              "ms_per_epoch": wall / EPOCH_EPOCHS * 1e3,
              "host_ms_per_epoch": host / EPOCH_EPOCHS * 1e3,
              "dispatches_per_epoch": (net._train_dispatches - d0)
              / EPOCH_EPOCHS}
    prof = profiled(lambda: net.fit(it), 1)
    stream.update(prof, device_idle_share=idle_share(
        prof, stream["ms_per_epoch"]))
    del net

    runs = {}
    for chunk in (1, EPOCH_EPOCHS):
        for graphs in (True, False):
            with captured(graphs):
                mark = memory_mark()
                net = build_network("mnist_mlp", "bf16", "cuda")
                cache = net.build_epoch_cache(it)
                net.fit_epochs(cache, chunk, chunk_epochs=chunk)  # warm-up
                d0 = net._train_dispatches
                out = {}
                wall, host = timed(lambda: out.setdefault(
                    "hist", net.fit_epochs(cache, EPOCH_EPOCHS,
                                           chunk_epochs=chunk)))
                r = {"samples_per_sec": total / wall,
                     "ms_per_epoch": wall / EPOCH_EPOCHS * 1e3,
                     "host_ms_per_epoch": host / EPOCH_EPOCHS * 1e3,
                     "dispatches_per_epoch": (net._train_dispatches - d0)
                     / EPOCH_EPOCHS, **memory_since(mark)}
                prog = next(iter(net._programs.values()))
                r.update(captures=prog.graph.captures,
                         replays=prog.graph.replays)
                prof = profiled(lambda: net.fit_epochs(
                    cache, EPOCH_EPOCHS, chunk_epochs=chunk), EPOCH_EPOCHS)
                r.update(prof, device_idle_share=idle_share(
                    prof, r["ms_per_epoch"]))
                runs[(chunk, graphs)] = (net, out["hist"], r)
    for chunk in (1, EPOCH_EPOCHS):
        (g, hg, rg), (e, he, re_) = runs[(chunk, True)], runs[(chunk, False)]
        bitwise = torch.equal(hg, he) and same_state(g, e)
        print(f"fused epoch mnist_mlp [{EPOCH_BATCHES} x {EPOCH_BATCH}, 784] "
              f"bf16 x{EPOCH_EPOCHS} epochs, chunk {chunk}: "
              f"replayed={json.dumps(rg)} eager={json.dumps(re_)} "
              f"replay_equals_eager={bitwise} "
              f"(max_abs_err {max_state_err(g, e):.3e}) [{card}]")
        if not bitwise:
            raise AssertionError(f"fit_epochs chunk {chunk}: the replayed "
                                 "run differs from the eager one")
        if not bool(torch.isfinite(hg).all()):
            raise AssertionError(f"fit_epochs: losses {hg.tolist()}")
    print(f"fused epoch mnist_mlp streaming fit: {json.dumps(stream)} "
          f"[{card}]")


def fused_guard(card: str) -> None:
    """The guard cell: a NaN batch under ``skip`` trips once an epoch, at
    that batch's place in the epoch's order, and params stay finite;
    ``off`` and ``skip`` are bitwise equal on clean data; ``raise``
    names the batch."""
    import torch
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.dtypes import tree_leaves
    from deeplearning4j_tpu_torch.perf.epoch_cache import (
        clone_generator, epoch_schedule)
    from deeplearning4j_tpu_torch.resilience import TrainingDivergedError

    it = ListDataSetIterator(epoch_data(poison=EPOCH_POISON), EPOCH_BATCH)
    net = build_network("mnist_mlp", "bf16", "cuda")
    cache = net.build_epoch_cache(it)
    gen = clone_generator(net._rng)
    net.fit_epochs(cache, EPOCH_EPOCHS, guard="skip")
    trips = net._last_sentinel
    where = [epoch_schedule(gen, EPOCH_BATCHES, True).tolist().index(
        EPOCH_POISON) for _ in range(EPOCH_EPOCHS)]
    want = [[j == w for j in range(EPOCH_BATCHES)] for w in where]
    finite = all(bool(torch.isfinite(t).all())
                 for t in tree_leaves((net.params, net.updater_state)))
    clean = ListDataSetIterator(epoch_data(), EPOCH_BATCH)
    off, skip = (build_network("mnist_mlp", "bf16", "cuda")
                 for _ in range(2))
    h_off = off.fit_epochs(clean, 2, guard="off")
    h_skip = skip.fit_epochs(clean, 2, guard="skip")
    off_eq_skip = torch.equal(h_off, h_skip) and same_state(off, skip)
    raising = build_network("mnist_mlp", "bf16", "cuda")
    named = None
    try:
        raising.fit_epochs(cache, 1, guard="raise")
    except TrainingDivergedError as e:
        named = (e.epoch, e.step, e.batch_index)
    print(f"fused guard mnist_mlp bf16, batch {EPOCH_POISON} poisoned: "
          f"skip trips per epoch {trips.sum(axis=1).tolist()} at "
          f"{[row.nonzero()[0].tolist() for row in trips]} (its places in "
          f"the orders: {where}) params_finite={finite}; clean data: "
          f"off_equals_skip={off_eq_skip}; raise names (epoch, step, "
          f"batch)={named} [{card}]")
    if trips.tolist() != want or not finite or not off_eq_skip \
            or named is None or named[2] != EPOCH_POISON:
        raise AssertionError("the guard cell failed")


def fused_steps(name: str, card: str) -> None:
    """A ``fit_steps`` cell: replayed against eager at the bench's size."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet

    batch = NETWORKS[name][0]
    x, y = network_data(name, batch)
    ds = DataSet(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
    nets, rows = {}, {}
    for graphs in (True, False):
        with captured(graphs):
            mark = memory_mark()
            net = build_network(name, "bf16", "cuda")
            net.fit_steps(ds, FUSED_WARMUP)
            wall, host = timed(lambda: net.fit_steps(ds, FUSED_STEPS))
            r = {"ms_per_step": wall / FUSED_STEPS * 1e3,
                 "host_ms_per_step": host / FUSED_STEPS * 1e3,
                 "samples_per_sec": batch * FUSED_STEPS / wall,
                 "loss": net.score_value, **memory_since(mark)}
            prof = profiled(lambda: net.fit_steps(ds, FUSED_STEPS),
                            FUSED_STEPS)
            r.update(prof, device_idle_share=idle_share(prof,
                                                        r["ms_per_step"]))
            nets[graphs], rows[graphs] = net, r
    bitwise = same_state(nets[True], nets[False])
    print(f"fused fit_steps {name} [{batch}, "
          f"{', '.join(map(str, NETWORKS[name][1]))}] bf16: "
          f"replayed={json.dumps(rows[True])} eager={json.dumps(rows[False])} "
          f"replay_equals_eager={bitwise} (max_abs_err "
          f"{max_state_err(nets[True], nets[False]):.3e}) [{card}]")
    if not bitwise:
        raise AssertionError(f"{name}: fit_steps replayed differs from "
                             "eager")
    if not math.isfinite(rows[True]["loss"]):
        raise AssertionError(f"{name}: non-finite loss")


def fused_char_lstm(card: str) -> None:
    """The char-LSTM cell: ``fit`` with its full TBPTT windows replayed
    against the same windows eagerly."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet

    x, y = char_lstm_data(RNN_BATCH)
    ds = DataSet(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
    nets, rows = {}, {}
    for graphs in (True, False):
        with captured(graphs):
            net = build_char_lstm("bf16", "cuda")
            net.fit(ds)  # warm-up: the first window runs eagerly, then capture
            ms, hosts = [], []
            for _ in range(RNN_FITS):
                wall, host = timed(lambda: net.fit(ds))
                ms.append(wall * 1e3)
                hosts.append(host * 1e3)
            r = {"ms_per_fit": sum(ms) / RNN_FITS,
                 "ms_per_fit_each": ms,
                 "host_ms_per_fit": sum(hosts) / RNN_FITS,
                 "loss": net.score_value}
            prof = profiled(lambda: net.fit(ds), 1)
            r.update(prof, device_idle_share=idle_share(prof,
                                                        r["ms_per_fit"]))
            nets[graphs], rows[graphs] = net, r
    bitwise = same_state(nets[True], nets[False])
    print(f"fused char_lstm [{RNN_BATCH}, {RNN_T}, {RNN_CFG['vocab_size']}] "
          f"tbptt {RNN_CFG['tbptt_length']} bf16, a fit = 4 windows: "
          f"replayed={json.dumps(rows[True])} eager={json.dumps(rows[False])} "
          f"replay_equals_eager={bitwise} (max_abs_err "
          f"{max_state_err(nets[True], nets[False]):.3e}) [{card}]")
    if not bitwise:
        raise AssertionError("char_lstm: replayed windows differ from eager")


def fused_lm(card: str) -> dict:
    """The LM cell: ``fit_batch_multi`` with a captured step against the
    same steps eagerly; returns B1–B3's launches in the replayed run."""
    import torch
    from deeplearning4j_tpu_torch.dtypes import tree_leaves
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    from deeplearning4j_tpu_torch.perf import step_graph

    tok = torch.as_tensor(train_tokens(), device="cuda")
    rows, models, launches, traced = {}, {}, {}, {}
    for graphs in (True, False):
        with captured(graphs):
            lm = TransformerLM(**TRAIN_CFG).init()
            multi = lm.make_multi_train_step(LM_FUSED_K)
            warm = lm.fit_batch_multi(tok, multi_step=multi, k=LM_FUSED_K)
            step_graph.reset_kernel_launches()
            losses = []
            wall, host = timed(lambda: losses.extend(
                lm.fit_batch_multi(tok, multi_step=multi, k=LM_FUSED_K,
                                   block=False)
                for _ in range(LM_FUSED_CALLS)))
            steps = LM_FUSED_K * LM_FUSED_CALLS
            launches[graphs] = step_graph.kernel_launches()
            prog = next(iter(multi.programs.values()))
            rows[graphs] = {"ms_per_step": wall / steps * 1e3,
                            "host_ms_per_step": host / steps * 1e3,
                            "tokens_per_sec": TRAIN_BATCH * TRAIN_T * steps
                            / wall,
                            "warmup_loss": warm,
                            "losses": [float(v) for v in losses],
                            "captures": prog.graph.captures,
                            "replays": prog.graph.replays,
                            "launches": launches[graphs]}
            # two more calls (k steps each) under the profiler, in both
            # runs
            traced[graphs] = traced_launches(
                lambda: lm.fit_batch_multi(tok, multi_step=multi,
                                           k=LM_FUSED_K),
                f"fused lm fit_batch_multi k={LM_FUSED_K} "
                f"{'replayed' if graphs else 'eager'}", card)
            models[graphs] = lm
    a, b = models[True], models[False]
    la, lb = (tree_leaves((m.params, m.opt_state)) for m in (a, b))
    bitwise = all(torch.equal(x, y) for x, y in zip(la, lb))
    err = max(float((x - y).abs().max()) for x, y in zip(la, lb))
    steps = LM_FUSED_K * LM_FUSED_CALLS
    want = {k: a.num_layers * steps for k in launches[True]}
    print(f"fused lm d{TRAIN_CFG['d_model']} L{TRAIN_CFG['num_layers']} "
          f"[{TRAIN_BATCH}, {TRAIN_T}] mixed_bf16 fit_batch_multi k="
          f"{LM_FUSED_K} x{LM_FUSED_CALLS}: replayed={json.dumps(rows[True])} "
          f"eager={json.dumps(rows[False])} replay_equals_eager={bitwise} "
          f"(max_abs_err {err:.3e}) [{card}]")
    if launches[True] != want or launches[False] != want:
        raise AssertionError(f"B1-B3 launches {launches}, expected {want}")
    want_one = {k: a.num_layers * LM_FUSED_K for k in launches[True]}
    if traced[True] != want_one or traced[False] != want_one:
        raise AssertionError(f"traced B1-B3 launches {traced}, expected "
                             f"{want_one}")
    if not bitwise:
        raise AssertionError("the LM's replayed steps differ from eager")
    return launches[True]


def fused_programs(card: str) -> None:
    """The programs cell: one ResNet-18 keeps a program per key, and its
    graphs share one memory pool. Six fused calls of five keys
    (``fit_epochs`` under ``skip``, ``off``, telemetry and in order,
    ``fit_steps``, then the first key again, so that a graph replays
    after others were captured into the pool) against the same calls
    eagerly, bitwise; the resident memory after each call; then the
    cache is dropped, and its memory must come back while the network
    keeps its programs."""
    import gc

    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator

    batch = NETWORKS[PROGRAMS_NET][0]
    x, y = network_data(PROGRAMS_NET, batch * PROGRAMS_BATCHES)
    it = ListDataSetIterator(DataSet(x, y), batch)
    step_ds = DataSet(torch.from_numpy(x[:batch]).cuda(),
                      torch.from_numpy(y[:batch]).cuda())
    calls = (
        ("fit_epochs skip", lambda n, c: n.fit_epochs(c, 1, guard="skip")),
        ("fit_epochs off", lambda n, c: n.fit_epochs(c, 1, guard="off")),
        ("fit_epochs telemetry", lambda n, c: n.fit_epochs(
            c, 1, guard="off", telemetry=True)),
        ("fit_epochs in order", lambda n, c: n.fit_epochs(
            c, 1, guard="off", shuffle=False)),
        ("fit_steps", lambda n, c: n.fit_steps(step_ds, 3)),
        ("fit_epochs skip again", lambda n, c: n.fit_epochs(
            c, 1, guard="skip")))
    nets, hists, rows = {}, {}, {}
    for graphs in (True, False):
        with captured(graphs):
            mark = memory_mark()
            net = build_network(PROGRAMS_NET, "bf16", "cuda")
            cache = net.build_epoch_cache(it)
            row = {"resident_bytes_with_cache":
                   memory_since(mark)["resident_bytes"]}
            hists[graphs], resident = [], []
            for _, call in calls:
                out = call(net, cache)
                hists[graphs].append(out.clone() if isinstance(
                    out, torch.Tensor) else None)  # fit_steps: no history
                resident.append(memory_since(mark)["resident_bytes"])
            row.update(resident_bytes_after_each=resident,
                       peak_mem_bytes=memory_since(mark)["peak_mem_bytes"],
                       programs=len(net._programs),
                       captures=sum(p.graph.captures
                                    for p in net._programs.values()))
            cache_bytes = cache.nbytes
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            del cache
            gc.collect()
            row.update(cache_bytes=cache_bytes,
                       freed_bytes_on_cache_drop=before
                       - torch.cuda.memory_allocated())
            nets[graphs], rows[graphs] = net, row
    bitwise = same_state(nets[True], nets[False]) and all(
        (a is None and b is None) or torch.equal(a, b)
        for a, b in zip(hists[True], hists[False]))
    print(f"fused programs {PROGRAMS_NET} [{batch}, "
          f"{', '.join(map(str, NETWORKS[PROGRAMS_NET][1]))}] bf16, "
          f"{PROGRAMS_BATCHES} batches, calls "
          f"{[name for name, _ in calls]}: replayed={json.dumps(rows[True])} "
          f"eager={json.dumps(rows[False])} replay_equals_eager={bitwise} "
          f"(max_abs_err {max_state_err(nets[True], nets[False]):.3e}) "
          f"[{card}]")
    if not bitwise:
        raise AssertionError("programs cell: the replayed calls differ from "
                             "the eager ones")
    if rows[True]["programs"] != 5 or rows[True]["captures"] != 5:
        raise AssertionError(f"programs cell: {rows[True]['programs']} "
                             f"programs, {rows[True]['captures']} captures; "
                             "expected 5 of each")
    for graphs in (True, False):
        if rows[graphs]["freed_bytes_on_cache_drop"] < \
                rows[graphs]["cache_bytes"]:
            raise AssertionError("programs cell: dropping the cache did not "
                                 "free it; a program keeps it alive")


def fused_parity(card: str) -> None:
    """The card's fused runs against the CPU's, at the earlier phases'
    gates: ``fit_epochs`` of the MLP (4 batches of 64, 2 epochs, in order)
    under float32 with TF32 off (rtol 2e-3, atol 1e-3) and ``bf16`` (loss
    2e-2, params 1e-2); ``fit_steps(ds, 3)`` of LeNet-5 and ResNet-18 at
    the networks phase's parity batches under ``bf16`` (ResNet-18 at
    ``NET_PARITY_LR``)."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch, n_batches, epochs = EPOCH_PARITY
    it = ListDataSetIterator(epoch_data(batch, n_batches), batch)
    failures = []
    for policy, tol in (("float32", (2e-3, 1e-3)), ("bf16", None)):
        got = {}
        for device in ("cuda", "cpu"):
            net = build_network("mnist_mlp", policy, device)
            hist = net.fit_epochs(it, epochs, shuffle=False)
            got[device] = (hist.float().cpu(), flat(net.params))
        (hc, pc), (hh, ph) = got["cuda"], got["cpu"]
        if tol is None:
            ok = (float((hc - hh).abs().max()) <= 2e-2
                  and float(abs(pc - ph).max()) <= 1e-2)
        else:
            rtol, atol = tol
            ok = (bool(((hc - hh).abs() <= atol + rtol * hh.abs()).all())
                  and bool((abs(pc - ph) <= atol + rtol * abs(ph)).all()))
        print(f"fused parity mnist_mlp fit_epochs {policy} [{n_batches} x "
              f"{batch}] x{epochs} card vs cpu: loss_err="
              f"{float((hc - hh).abs().max()):.3e} param_err="
              f"{float(abs(pc - ph).max()):.3e} "
              f"({'rtol 2e-3, atol 1e-3' if tol else 'loss 2e-2, params 1e-2'})"
              f" {'ok' if ok else 'MISMATCH'} [{card}]")
        if not ok:
            failures.append(f"mnist_mlp {policy}")
    for name in FUSED_NETS:
        pbatch = NET_PARITY_BATCH[name]
        x, y = network_data(name, pbatch)
        lr = NET_PARITY_LR.get(name)
        got = {}
        for device in ("cuda", "cpu"):
            net = build_network(name, "bf16", device,
                                **({} if lr is None else {"lr": lr}))
            net.fit_steps(DataSet(torch.from_numpy(x).to(device),
                                  torch.from_numpy(y).to(device)), 3)
            got[device] = (net.score_value, flat(net.params),
                           [flat(s) for s in net.net_state.values() if s])
        (lc, pc, sc), (lh, ph, sh) = got["cuda"], got["cpu"]
        excess_s = max((float(abs(a - b).max() - 1e-2 - 2e-2 * abs(b).max())
                        for a, b in zip(sc, sh)), default=0.0)
        ok = (abs(lc - lh) <= 2e-2 and float(abs(pc - ph).max()) <= 1e-2
              and excess_s <= 0.0)
        print(f"fused parity {name} fit_steps(3) bf16 [{pbatch}]"
              f"{'' if lr is None else f' (lr {lr})'} card vs cpu: loss "
              f"{lc} vs {lh} param_err={float(abs(pc - ph).max()):.3e} "
              f"(loss 2e-2, params 1e-2; running statistics atol 1e-2 + "
              f"2e-2 x a layer's largest) {'ok' if ok else 'MISMATCH'} "
              f"[{card}]")
        if not ok:
            failures.append(name)
    if failures:
        raise AssertionError(f"the card's fused runs disagree with the "
                             f"CPU's: {failures}")


def fused(card: str) -> dict:
    """Phase 8: every fused path by graph replay, against its eager run
    and against the CPU. Returns B1–B3's launches in the LM cell."""
    import torch

    fused_epochs(card)
    fused_guard(card)
    for name in FUSED_NETS:
        fused_steps(name, card)
        torch.cuda.empty_cache()
    fused_programs(card)
    torch.cuda.empty_cache()
    fused_char_lstm(card)
    torch.cuda.empty_cache()
    launches = fused_lm(card)
    torch.cuda.empty_cache()
    fused_parity(card)
    return launches


# ---------------------------------------------------------------------------
# phase 9: the DL4J front door — the CLI over a reference-format document
# ---------------------------------------------------------------------------
# The MNIST deep-belief net of the DL4J 0.4 examples: RBMs 784-500-250-200
# (binary visible and hidden units, CD-1) under a softmax output of 10,
# MCXENT; pretrained layer by layer, then finetuned by LBFGS, 5 iterations
# a batch; nothing cut. The data: 8 batches of 1024 rows of 784 binary
# pixels, each pixel on with its own probability (u^3, u uniform: most
# pixels are mostly off, as in MNIST), labels from a fixed linear teacher.
DBN_WIDTHS = (784, 500, 250, 200, 10)
DBN_ITERATIONS = 5
DBN_LR = 0.1
DBN_STYLES = 30
DBN_SEED = 123
DBN_BATCH, DBN_BATCHES = 1024, 8
DBN_EPOCHS = 2  # then --resume to one more
DBN_PARITY_BATCH = 64
SOLVER_PARITY_ITERATIONS = 3
CLI_TIMEOUT_S = 300
CLI_DEVICE = "cuda"  # the CLI's default; "cpu" only to rehearse the phase
# runs the CLI module as ``python -m`` does, then reports what the process
# ran on the card: B1-B3's launches and the peak of allocated memory, and
# the seconds of its start-up (torch's import and, on the card, the CUDA
# context) and of the whole CLI command, start-up included
CLI_RUNNER = """
import json, runpy, sys, time
t0 = time.perf_counter()
import torch
if "--device" not in sys.argv:  # the CLI's default device, the card
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
startup_s = time.perf_counter() - t0
code = 0
try:
    runpy.run_module("deeplearning4j_tpu_torch.cli", run_name="__main__",
                     alter_sys=True)
except SystemExit as e:
    code = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
from deeplearning4j_tpu_torch.perf import step_graph
print("CLI_RUN " + json.dumps({
    "startup_s": startup_s,
    "wall_s": time.perf_counter() - t0,
    "launches": step_graph.kernel_launches(),
    "peak_mem_bytes": (torch.cuda.max_memory_allocated()
                       if torch.cuda.is_initialized() else 0)}))
sys.exit(code)
"""


def dbn_document(algo: str = "LBFGS") -> str:
    """The DBN as the reference's Jackson ``toJson()`` writes it."""
    conf = {"seed": DBN_SEED, "numIterations": DBN_ITERATIONS,
            "optimizationAlgo": algo}
    confs = [{"layer": {"RBM": {
        "nIn": a, "nOut": b, "k": 1, "hiddenUnit": "BINARY",
        "visibleUnit": "BINARY", "weightInit": "XAVIER",
        "activationFunction": "sigmoid", "learningRate": DBN_LR}}, **conf}
        for a, b in zip(DBN_WIDTHS[:-2], DBN_WIDTHS[1:-1])]
    confs.append({"layer": {"output": {
        "nIn": DBN_WIDTHS[-2], "nOut": DBN_WIDTHS[-1],
        "activationFunction": "softmax", "lossFunction": "MCXENT",
        "weightInit": "XAVIER", "learningRate": DBN_LR}}, **conf})
    return json.dumps({"backprop": True, "pretrain": True, "confs": confs},
                      indent=2)


def dbn_data(rows: int, seed: int = 0):
    """``rows`` binary pixel rows and their teacher's labels. Each row
    draws its pixels from one of ``DBN_STYLES`` stroke patterns (per-pixel
    on-probabilities, mostly off as in MNIST), so pixels are correlated as
    a digit's are; the labels are a fixed linear teacher's argmax."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_in, n_out = DBN_WIDTHS[0], DBN_WIDTHS[-1]
    styles = rng.random((DBN_STYLES, n_in)) ** 3
    teacher = rng.normal(size=(n_in, n_out))
    ink = styles[rng.integers(0, DBN_STYLES, rows)]
    x = (rng.random((rows, n_in)) < ink).astype(np.float32)
    return x, ((x - styles.mean(0)) @ teacher).argmax(1)


def write_csv(path: str, x, labels) -> None:
    with open(path, "w") as f:
        for row, label in zip(x.astype("int8").tolist(), labels.tolist()):
            f.write(",".join(map(str, row)) + f",{label}\n")


def run_cli(argv, label: str) -> tuple:
    """``python -m deeplearning4j_tpu_torch.cli <argv>`` in a child process
    from this checkout: (its standard output, its ``CLI_RUN`` report)."""
    if CLI_DEVICE != "cuda":
        argv = [*argv, "--device", CLI_DEVICE]
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-c", CLI_RUNNER, *argv], cwd=HERE,
        capture_output=True, text=True, timeout=CLI_TIMEOUT_S,
        env={**os.environ, "PYTHONPATH": HERE})
    process_s = time.monotonic() - t0
    report = None
    for line in proc.stdout.splitlines():
        if line.startswith("CLI_RUN "):
            report = {**json.loads(line[len("CLI_RUN "):]),
                      "process_s": process_s}
    if proc.returncode != 0 or report is None:
        raise AssertionError(f"cli {label} exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    if any(report["launches"].values()):
        raise AssertionError(f"cli {label} launched a flash kernel: "
                             f"{report['launches']}")
    return proc.stdout, report


def epoch_lines(out: str) -> tuple:
    """The per-epoch lines of ``train``: {epoch: {layer: scores}} and
    {epoch: finetune score}."""
    pre, score = {}, {}
    for line in out.splitlines():
        m = re.match(r"epoch (\d+)/\d+ pretrain layer (\d+) scores: (.*)",
                     line)
        if m:
            pre.setdefault(int(m.group(1)), {})[int(m.group(2))] = [
                float(v) for v in m.group(3).split()]
        m = re.match(r"epoch (\d+)/\d+ score: (\S+)", line)
        if m:
            score[int(m.group(1))] = float(m.group(2))
    return pre, score


def cli_cycle(card: str, tmp: str) -> None:
    """train (2 epochs, checkpoints), --resume to 3, test and predict, each
    a child process on the card; then the zip restored here on the card
    and on the CPU."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.cli import driver
    from deeplearning4j_tpu_torch.utils import ModelSerializer

    x, labels = dbn_data(DBN_BATCH * DBN_BATCHES)
    csv_path, doc_path = os.path.join(tmp, "train.csv"), os.path.join(
        tmp, "dbn.json")
    model, ckpt = os.path.join(tmp, "dbn.zip"), os.path.join(tmp, "ckpt")
    write_csv(csv_path, x, labels)
    with open(doc_path, "w") as f:
        f.write(dbn_document())
    data = ["-input", csv_path, "--num-classes", str(DBN_WIDTHS[-1]),
            "--batch-size", str(DBN_BATCH)]
    t0 = time.monotonic()
    it = driver._build_iterator(driver.build_parser().parse_args(
        ["test", "-model", model, *data]), {})
    n_batches = sum(1 for _ in it)
    parse_s = time.monotonic() - t0
    train = ["train", "-model", doc_path, "-output", model,
             "--checkpoint-dir", ckpt, *data]
    out, rep = run_cli(train + ["--epochs", str(DBN_EPOCHS)], "train")
    out2, rep2 = run_cli(train + ["--epochs", str(DBN_EPOCHS + 1),
                                  "--resume"], "train --resume")
    if f"resumed from checkpoint epoch {DBN_EPOCHS}" not in out2:
        raise AssertionError(f"train --resume did not resume:\n{out2}")
    pre, score = epoch_lines(out + out2)
    print(f"cli train {'-'.join(map(str, DBN_WIDTHS))} [{DBN_BATCH} x "
          f"{n_batches} batches, {DBN_EPOCHS} epochs + 1 resumed]: process "
          f"{rep['process_s']:.3f} s + {rep2['process_s']:.3f} s, of which "
          f"the command {rep['wall_s']:.3f} s + {rep2['wall_s']:.3f} s, of "
          f"which start-up (torch import, CUDA context) "
          f"{rep['startup_s']:.3f} s + {rep2['startup_s']:.3f} s; CSV parse "
          f"{parse_s:.3f} s of {os.path.getsize(csv_path)} bytes (here, "
          f"once), peak_mem_bytes={rep['peak_mem_bytes']} [{card}]")
    failures = []
    for epoch in sorted(pre):
        for layer, scores in sorted(pre[epoch].items()):
            print(f"cli pretrain epoch {epoch} layer {layer} recon error "
                  f"per batch: {' '.join(f'{v:.4f}' for v in scores)}")
            if epoch == 1 and not scores[-1] < scores[0]:
                failures.append(f"layer {layer}'s recon error did not fall")
    if sorted(pre.get(1, {})) != list(range(len(DBN_WIDTHS) - 2)):
        failures.append(f"not every RBM pretrained: {pre}")
    scores = [score[e] for e in sorted(score)]
    print(f"cli finetune LBFGS score per epoch (last batch): {scores}")
    if len(scores) != DBN_EPOCHS + 1 or not scores[-1] < scores[0]:
        failures.append(f"the finetune score did not fall: {scores}")

    out3, rep3 = run_cli(["test", "-model", model, *data], "test")
    acc = float(re.search(r"Accuracy:\s+(\S+)", out3).group(1))
    chance = float(np.bincount(labels).max()) / len(labels)
    print(f"cli test accuracy={acc} (chance {chance:.4f}): process "
          f"{rep3['process_s']:.3f} s, of which start-up "
          f"{rep3['startup_s']:.3f} s [{card}]")
    if not acc > chance:
        failures.append(f"test accuracy {acc} is not above chance {chance}")
    preds_path = os.path.join(tmp, "preds.txt")
    run_cli(["predict", "-model", model, "-output", preds_path, *data],
            "predict")
    preds = np.loadtxt(preds_path, dtype=np.int64)

    card_net = ModelSerializer.restore(
        model, device=None if CLI_DEVICE == "cuda" else CLI_DEVICE)
    cpu_net = ModelSerializer.restore(model, device="cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    on_card = card_net.output(torch.from_numpy(x).to(CLI_DEVICE))
    same = bool((on_card.argmax(-1).cpu().numpy() == preds).all())
    on_cpu = cpu_net.output(torch.from_numpy(x))
    err = float((on_card.cpu() - on_cpu).abs().max())
    excess = float(((on_card.cpu() - on_cpu).abs()
                    - (1e-3 + 2e-3 * on_cpu.abs())).max())
    print(f"cli predict: {len(preds)} labels equal the restored network's "
          f"argmax on the card: {same}; the zip on the CPU against the card: "
          f"output max_abs_err={err:.3e} (rtol 2e-3, atol 1e-3) "
          f"{'ok' if excess <= 0 else 'MISMATCH'} [{card}]")
    if not same:
        failures.append("predict's labels are not the output's argmax")
    if excess > 0:
        failures.append("the zip restored on the CPU disagrees")
    if failures:
        raise AssertionError("; ".join(failures))
    time_dbn(card, card_net, x)


def time_dbn(card: str, net, x) -> None:
    """ms per CD-1 step of each RBM at the CLI's batch, and ms per solver
    iteration split into the card's score and gradient, the line search's
    probes and the host's float64 algebra, with the bytes each iteration
    moves each way."""
    import torch
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.layers.pretrain import RBMImpl
    from deeplearning4j_tpu_torch.nn.updater import _sub_tree, apply_updater
    from deeplearning4j_tpu_torch.optimize import Solver
    from deeplearning4j_tpu_torch.optimize.solver import new_solver_stats

    dev = CLI_DEVICE
    xb = torch.from_numpy(x[:DBN_BATCH]).to(dev)
    one = torch.ones((), device=dev)
    first = torch.ones((), dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        for i, impl in enumerate(net.layers):
            if not isinstance(impl, RBMImpl):
                continue
            xi, p = net._activate_to_layer(xb, i), net.params[str(i)]
            s, spec = net.updater_state[str(i)], net.updater_specs[i]

            def step():
                grads, _ = impl.pretrain_grads(p, xi, gen)
                steps, _ = apply_updater(spec, grads, s, one, first)
                return _sub_tree(p, steps)
            print(f"cli cd1 layer {i} [{DBN_BATCH}, {impl.conf.n_in}->"
                  f"{impl.conf.n_out}]: {cuda_ms(step):.4f} ms per CD-1 step "
                  f"[{card}]")
    _, labels = dbn_data(DBN_BATCH * DBN_BATCHES)
    y = torch.nn.functional.one_hot(torch.from_numpy(labels),
                                    DBN_WIDTHS[-1]).float()
    net.solver_stats = new_solver_stats()
    for b in range(DBN_BATCHES):
        rows = slice(b * DBN_BATCH, (b + 1) * DBN_BATCH)
        Solver(net).optimize(DataSet(torch.from_numpy(x[rows]).to(dev),
                                     y[rows].to(dev)))
    st = net.solver_stats
    n = st["iterations"]
    vg, probe = st["value_and_grad_s"] / n, st["score_s"] / n
    host = (st["total_s"] - st["value_and_grad_s"] - st["score_s"]) / n
    print(f"cli solver LBFGS [{DBN_BATCH}] {n} iterations over "
          f"{DBN_BATCHES} batches: {1e3 * st['total_s'] / n:.4f} ms per "
          f"iteration = score+grad {1e3 * vg:.4f} ms + line-search probes "
          f"{1e3 * probe:.4f} ms ({st['score_calls'] / n:.2f} per iteration)"
          f" + host f64 algebra {1e3 * host:.4f} ms; bytes per iteration "
          f"to the card {st['bytes_to_device'] / n:.0f}, from the card "
          f"{st['bytes_from_device'] / n:.0f} ({net.num_params()} params) "
          f"[{card}]")


def check_dbn_parity(card: str) -> None:
    """The card against the CPU at batch 64 on the same weights, float32
    with TF32 off (rtol 2e-3, atol 1e-3): one CD-1 step of the first RBM
    and one AutoEncoder step with the same injected draws (zero flipped
    samples), and 3 iterations each of LBFGS, conjugate gradient and line
    gradient descent from the same params (score history and params)."""
    import torch
    from deeplearning4j_tpu_torch.cli import driver
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.dtypes import tree_leaves
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.layers import get_layer_impl
    from deeplearning4j_tpu_torch.optimize import Solver
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresIterationListener)

    torch.backends.cuda.matmul.allow_tf32 = False
    x, labels = dbn_data(DBN_PARITY_BATCH, seed=1)
    y = torch.nn.functional.one_hot(torch.from_numpy(labels),
                                    DBN_WIDTHS[-1]).float()
    failures = []

    def close(a, b):
        a, b = a.cpu(), b.cpu()
        return (float((a - b).abs().max()),
                float(((a - b).abs() - (1e-3 + 2e-3 * b.abs())).max()) <= 0)

    # one CD-1 step of the first RBM, and one AutoEncoder step
    gen = torch.Generator().manual_seed(7)
    rbm = get_layer_impl(L.RBM(n_in=DBN_WIDTHS[0], n_out=DBN_WIDTHS[1]))
    ae = get_layer_impl(L.AutoEncoder(
        n_in=DBN_WIDTHS[0], n_out=DBN_WIDTHS[1], corruption_level=0.3,
        activation="sigmoid", loss_function="RMSE_XENT"))
    for name, impl in (("cd1", rbm), ("autoencoder", ae)):
        params = impl.init_params(torch.Generator().manual_seed(3))
        shapes = (impl.draw_shapes(DBN_PARITY_BATCH) if name == "cd1"
                  else [("uniform", x.shape)])
        draws = [torch.rand(s, generator=gen) for _, s in shapes]
        got = {}
        for dev in (CLI_DEVICE, "cpu"):
            p = {k: v.to(dev) for k, v in params.items()}
            v0, d = torch.from_numpy(x).to(dev), [t.to(dev) for t in draws]
            if name == "cd1":
                grads, score = impl.pretrain_grads(p, v0, draws=d)
                h0, steps = impl.gibbs_chain(p, v0, draws=d)
                samples = [h0, steps[0][1], steps[0][3]]
            else:
                pg = {k: t.requires_grad_() for k, t in p.items()}
                score = impl.pretrain_loss(pg, v0, draws=d)
                grads = dict(zip(pg, torch.autograd.grad(
                    score, list(pg.values()))))
                samples = []
            got[dev] = ([score.detach()] + tree_leaves(grads), samples)
        (card_out, card_samples), (cpu_out, cpu_samples) = (
            got[CLI_DEVICE], got["cpu"])
        flipped = sum(int((a.cpu() != b).sum())
                      for a, b in zip(card_samples, cpu_samples))
        errs = [close(a, b) for a, b in zip(card_out, cpu_out)]
        ok = all(e[1] for e in errs) and flipped == 0
        print(f"cli parity {name} float32 [{DBN_PARITY_BATCH}, "
              f"{DBN_WIDTHS[0]}->{DBN_WIDTHS[1]}] card vs cpu, same draws: "
              f"score {float(card_out[0])} vs {float(cpu_out[0])} grad "
              f"max_abs_err={max(e[0] for e in errs):.3e} (rtol 2e-3, "
              f"atol 1e-3), flipped samples {flipped} of "
              f"{sum(t.numel() for t in cpu_samples)} "
              f"{'ok' if ok else 'MISMATCH'} [{card}]")
        if not ok:
            failures.append(name)

    # 3 solver iterations from the same params
    for algo in ("LBFGS", "CONJUGATE_GRADIENT", "LINE_GRADIENT_DESCENT"):
        got = {}
        for dev in (CLI_DEVICE, "cpu"):
            net = driver._net_from_document(dbn_document(algo), dev)
            scores = CollectScoresIterationListener()
            net.set_listeners(scores)
            Solver(net).optimize(DataSet(torch.from_numpy(x).to(dev),
                                         y.to(dev)),
                                 iterations=SOLVER_PARITY_ITERATIONS)
            got[dev] = (torch.tensor([s for _, s in scores.scores]),
                        torch.from_numpy(net.get_flat_params()))
        (sc, pc), (sh, ph) = got[CLI_DEVICE], got["cpu"]
        e_s, ok_s = close(sc, sh)
        e_p, ok_p = close(pc, ph)
        ok = ok_s and ok_p and len(sc) == len(sh) == SOLVER_PARITY_ITERATIONS
        print(f"cli parity {algo} float32 [{DBN_PARITY_BATCH}] "
              f"{SOLVER_PARITY_ITERATIONS} iterations card vs cpu: scores "
              f"{sc.tolist()} vs {sh.tolist()} score_err={e_s:.3e} "
              f"param_max_abs_err={e_p:.3e} (rtol 2e-3, atol 1e-3) "
              f"{'ok' if ok else 'MISMATCH'} [{card}]")
        if not ok:
            failures.append(algo)
    if failures:
        raise AssertionError(f"the card disagrees with the CPU: {failures}")


def front_door(card: str) -> dict:
    """Phase 9: the CLI trains, checkpoints, resumes, tests and predicts
    with the DBN of a reference-format document; the card is held against
    the CPU. Returns B1–B3's launches in this process (none expected; the
    children check their own)."""
    import tempfile

    reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        cli_cycle(card, tmp)
    check_dbn_parity(card)
    launches = launch_counts()
    if any(launches.values()):
        raise AssertionError(f"the cli phase launched a flash kernel: "
                             f"{launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 10: the serving extras
# ---------------------------------------------------------------------------
EXTRAS_DEVICE = "cuda"  # "cpu" only to rehearse the phase
GEN_PROMPT, GEN_NEW = 77, 64          # make_generate against generate
TRACE_NEW = 4                         # new tokens of the traced call
BEAM_BATCH, BEAM_NEW, BEAM_K = 2, 32, 4
SPEC_DRAFT, SPEC_TOKENS = 1, 3
SPEC_SAMPLED = dict(temperature=0.8, top_k=50, slots=2, rounds=4,
                    max_len=256, prompt_lens=(20, 75))
FLEET_REQUESTS, FLEET_RATE, FLEET_FUSE = 16, 200.0, 4
HANDOFF_REPS = 10
BEAM_TOL = dict(rtol=2e-3, atol=1e-3)


def _sync() -> None:
    import torch

    if EXTRAS_DEVICE != "cpu":
        torch.cuda.synchronize()


def _b1_launches() -> int:
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        flash_attention_fwd)

    return flash_attention_fwd.launches


def serve_schedule(n=SERVE_REQUESTS, rate=20.0, seed=7):
    """Phase 4's seeded Poisson stream (or a longer one of the same
    prompts)."""
    from deeplearning4j_tpu_torch.serving import poisson_schedule

    return poisson_schedule(
        n, rate, vocab_size=SERVE_CFG["vocab_size"],
        prompt_lens=SERVE_PROMPT_LENS, max_new_tokens=(16, 32, 64),
        seed=seed)


def first_divergence(got, want, lm, prompt) -> str:
    """Where a stream leaves ``lm.generate`` and the target's top-2 logit
    margin there (how close to a tie the flipped token was)."""
    import numpy as np
    import torch

    i = int(np.argmax(got != want))
    logits = lm.forward(lm.params, want[None, :i])[0, -1].float()
    top = torch.topk(logits, 2).values
    return (f"index {i} (new token {i - prompt.shape[0]}): got {got[i]}, "
            f"generate {want[i]}, top-2 margin {float(top[0] - top[1]):.3e}")


def check_streams(what: str, finished, refs, lm) -> None:
    import numpy as np

    for req in finished:
        want = refs[req.prompt.tobytes()]
        if not np.array_equal(req.output, want):
            raise AssertionError(f"{what}: a {req.prompt.shape[0]}-token "
                                 f"stream differs from lm.generate at "
                                 + first_divergence(req.output, want, lm,
                                                    req.prompt))


def f32_pair():
    """The served model's widths under float32 on the card and its copy
    on the CPU (same seeded weights)."""
    from deeplearning4j_tpu_torch.dtypes import tree_map
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM

    cfg = {**SERVE_CFG, "dtype_policy": "float32"}
    card = TransformerLM(**cfg, device=EXTRAS_DEVICE).init()
    cpu = TransformerLM(**cfg, device="cpu")
    cpu.params = tree_map(lambda p: p.cpu(), card.params)
    return card, cpu


def extras_generate(lm, pair, card: str) -> None:
    """make_generate against generate; beam 1 against greedy generate
    under mixed_bf16; beam 4 under float32 on the card against the CPU."""
    import numpy as np
    import torch

    rng = np.random.default_rng(21)
    prompt = rng.integers(0, SERVE_CFG["vocab_size"], (1, GEN_PROMPT))
    b0 = _b1_launches()
    got = lm.make_generate(GEN_PROMPT, GEN_NEW)(lm.params, prompt)
    if _b1_launches() - b0 != lm.num_layers:
        raise AssertionError("make_generate's prefill did not launch B1 "
                             "num_layers times")
    want = lm.generate(prompt, GEN_NEW)
    if not torch.equal(got, want):
        raise AssertionError("make_generate differs from generate")
    prompts = rng.integers(0, SERVE_CFG["vocab_size"],
                           (BEAM_BATCH, GEN_PROMPT))
    _sync()
    t0 = time.monotonic()
    seqs, scores = lm.generate_beam(prompts, BEAM_NEW, beam_size=1)
    _sync()
    beam1_ms = (time.monotonic() - t0) * 1e3
    greedy = lm.generate(prompts, BEAM_NEW)
    if not torch.equal(seqs[:, 0], greedy):
        raise AssertionError("beam 1 differs from greedy generate")
    print(f"extras make_generate [1, {GEN_PROMPT}] +{GEN_NEW} equals "
          f"generate; generate_beam [{BEAM_BATCH}, {GEN_PROMPT}] "
          f"+{BEAM_NEW} beam 1 equals greedy generate ({beam1_ms:.1f} ms) "
          f"[{card}]")
    f32, cpu = pair
    torch.backends.cuda.matmul.allow_tf32 = False
    _sync()
    t0 = time.monotonic()
    cs, csc = f32.generate_beam(prompts, BEAM_NEW, beam_size=BEAM_K)
    _sync()
    beam_ms = (time.monotonic() - t0) * 1e3
    ws, wsc = cpu.generate_beam(prompts, BEAM_NEW, beam_size=BEAM_K)
    cs, csc = cs.cpu(), csc.cpu()
    best_same = torch.equal(cs[:, 0], ws[:, 0])
    beams_same = int((cs == ws).all(dim=2).sum())
    err = float((csc - wsc).abs().max())
    ok = best_same and torch.allclose(csc, wsc, **BEAM_TOL)
    print(f"extras generate_beam float32 beam {BEAM_K} card vs cpu: best "
          f"beam {'identical' if best_same else 'DIFFERS'}, {beams_same} of "
          f"{BEAM_BATCH * BEAM_K} beams identical, scores max_abs_err="
          f"{err:.3e} (rtol {BEAM_TOL['rtol']}, atol {BEAM_TOL['atol']}), "
          f"{beam_ms:.1f} ms [{card}]")
    if not ok:
        raise AssertionError("float32 beam search: the card disagrees with "
                             "the CPU")


def spec_dispatch_profile(srv, card: str) -> None:
    """One speculative dispatch of a full batch: its wall time, then the
    same step under torch.profiler: launches, busy time, idle share and
    device time by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync()
    t0 = time.monotonic()
    srv.step()
    _sync()
    wall_ms = (time.monotonic() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        srv.step()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = busy_union_s([(e.time_range.start, e.time_range.end)
                            for e in device]) * 1e3
    by_name = {}
    for e in device:
        key = e.name[:48]
        by_name[key] = by_name.get(key, 0.0) + (e.time_range.end
                                                - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"extras spec dispatch [{srv.engine.slots} live, "
          f"{srv.fuse_steps} round(s), G={srv.engine.spec_tokens}]: "
          f"wall_ms={wall_ms:.2f} device_events={len(device)} "
          f"device_busy_ms={busy_ms:.2f} idle_share="
          f"{1.0 - busy_ms / wall_ms:.3f} [{card}]")
    print("extras spec dispatch by kernel (ms): "
          + "; ".join(f"{k} {v:.3f}" for k, v in top))


def extras_spec(lm, refs, card: str) -> None:
    """The speculative server on phase 4's stream at fuse_steps 1 and 4,
    its dispatch under the profiler, the full-depth self-draft."""
    from deeplearning4j_tpu_torch.serving import DecodeServer, run_open_loop

    sched = serve_schedule()
    for k in (1, 4):
        # the plain server on the same stream, the speculative one's
        # yardstick in this call
        plain = DecodeServer(lm, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                             fuse_steps=k, device=EXTRAS_DEVICE)
        s = run_open_loop(plain, sched).summary()
        print(f"extras plain fuse_steps={k}: tokens_per_sec="
              f"{s['tokens_per_sec']} ttft_p50_ms={s['ttft_p50_ms']} "
              f"dispatches_per_token="
              f"{plain.stats()['dispatches_per_token']} [{card}]")
        check_streams(f"plain fuse_steps={k}", plain.finished, refs, lm)
        srv = DecodeServer(lm, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                           draft_layers=SPEC_DRAFT, spec_tokens=SPEC_TOKENS,
                           fuse_steps=k, device=EXTRAS_DEVICE)
        b0 = _b1_launches()
        report = run_open_loop(srv, sched)
        _sync()
        launches = _b1_launches() - b0
        s, st = report.summary(), srv.stats()
        print(f"extras spec fuse_steps={k} draft_layers={SPEC_DRAFT} "
              f"spec_tokens={SPEC_TOKENS}: finished={s['finished']} "
              f"tokens={s['tokens']} tokens_per_sec={s['tokens_per_sec']} "
              f"ttft_p50_ms={s['ttft_p50_ms']} "
              f"spec_accept_rate={st['spec_accept_rate']} "
              f"tokens_per_slot_dispatch={st['tokens_per_slot_dispatch']} "
              f"dispatches_per_token={st['dispatches_per_token']} "
              f"kv_pool_bytes={st['kv_pool_bytes']} "
              f"flash_launches={launches} [{card}]")
        if s["finished"] != len(sched):
            raise AssertionError(f"spec fuse_steps={k}: {s['finished']} of "
                                 f"{len(sched)} requests finished")
        want = (lm.num_layers + SPEC_DRAFT) * len(sched)
        if launches != want:
            raise AssertionError(
                f"spec fuse_steps={k}: B1 launched {launches} times, "
                f"expected (num_layers + draft_layers) x admissions = "
                f"{want}")
        check_streams(f"spec fuse_steps={k}", srv.finished, refs, lm)
    # one dispatch of a full batch, measured
    srv = DecodeServer(lm, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                       draft_layers=SPEC_DRAFT, spec_tokens=SPEC_TOKENS,
                       device=EXTRAS_DEVICE)
    for a in sched:
        srv.submit(a.prompt, 64)
    srv.step()                                # admits all eight
    if EXTRAS_DEVICE != "cpu":
        spec_dispatch_profile(srv, card)
    srv.drain()
    # a full-depth self-draft is the target: every proposal verifies
    full = DecodeServer(lm, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                        draft_layers=lm.num_layers, spec_tokens=SPEC_TOKENS,
                        device=EXTRAS_DEVICE)
    s = run_open_loop(full, sched).summary()
    st = full.stats()
    print(f"extras spec draft_layers={lm.num_layers}: spec_accept_rate="
          f"{st['spec_accept_rate']} tokens_per_slot_dispatch="
          f"{st['tokens_per_slot_dispatch']} tokens_per_sec="
          f"{s['tokens_per_sec']} ttft_p50_ms={s['ttft_p50_ms']} [{card}]")
    if st["spec_accept_rate"] != 1.0:
        raise AssertionError("the full-depth self-draft was rejected")
    check_streams("spec full-depth draft", full.finished, refs, lm)
    print(f"extras spec: {len(refs)} greedy streams equal lm.generate at "
          f"fuse_steps 1 and 4 and under the full-depth draft [{card}]")


def spec_draws(rounds: int, slots: int, gamma: int, vocab: int, seed=3):
    """Explicit draws for ``decode_spec``'s seam: Gumbel noise and
    uniforms from a seeded numpy generator."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def gumbel(*shape):
        u = np.maximum(rng.random(shape, np.float32),
                       np.finfo(np.float32).tiny)
        return torch.from_numpy(-np.log(-np.log(u)))

    return {"draft": gumbel(rounds, gamma + 1, slots, vocab),
            "uniform": torch.from_numpy(rng.random((rounds, slots, gamma),
                                                   np.float32)),
            "correction": gumbel(rounds, slots, vocab)}


def extras_traced(lm, card: str) -> None:
    """B1's launches on the phase's new paths held against the card's
    trace, as phase 5 holds the train step's: a ``make_generate`` call
    (``num_layers``) and a speculative admission on a fresh server
    (``num_layers + draft_layers``); B2 and B3 launch 0 times."""
    import numpy as np
    from deeplearning4j_tpu_torch.serving import DecodeServer

    prompt = np.random.default_rng(23).integers(
        0, SERVE_CFG["vocab_size"], (1, GEN_PROMPT))
    gen = lm.make_generate(GEN_PROMPT, TRACE_NEW)

    def generate():
        gen(lm.params, prompt)

    def admit():
        srv = DecodeServer(lm, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                           draft_layers=SPEC_DRAFT, spec_tokens=SPEC_TOKENS,
                           device=EXTRAS_DEVICE)
        srv.submit(prompt[0], GEN_NEW)
        srv.step()

    # an untraced first call of each, so that every traced call is alike
    generate()
    admit()
    for what, fn, b1 in (
            ("make_generate", generate, lm.num_layers),
            ("speculative admission", admit, lm.num_layers + SPEC_DRAFT)):
        got = traced_launches(fn, f"extras {what}", card)
        want = {"flash_attention_fwd": b1, "flash_attention_bwd_dkdv": 0,
                "flash_attention_bwd_dq": 0}
        if got != want:
            raise AssertionError(f"extras {what}: B1-B3 launched {got}, "
                                 f"expected {want}")


def extras_spec_sampled(pair, card: str) -> None:
    """Sampled speculative rounds under float32 with TF32 off: the card
    against the CPU with the same injected draws."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.serving import DecodeEngine

    cfg = SPEC_SAMPLED
    f32, cpu = pair
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(max_len=cfg["max_len"], temperature=cfg["temperature"],
              top_k=cfg["top_k"], draft_layers=SPEC_DRAFT,
              spec_tokens=SPEC_TOKENS)
    engines = [DecodeEngine(f32, cfg["slots"], device=EXTRAS_DEVICE, **kw),
               DecodeEngine(cpu, cfg["slots"], device="cpu", **kw)]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, SERVE_CFG["vocab_size"], n)
               for n in cfg["prompt_lens"]]
    toks = [int(engines[1].prefill(p, s)) for s, p in enumerate(prompts)]
    for s, p in enumerate(prompts):
        engines[0].prefill(p, s)
    draws = spec_draws(cfg["rounds"], cfg["slots"], SPEC_TOKENS,
                       SERVE_CFG["vocab_size"])
    remaining = np.full(cfg["slots"], cfg["rounds"] * (SPEC_TOKENS + 1))
    blocks = []
    for eng in engines:
        d = {k: v.to(eng.device) for k, v in draws.items()}
        blocks.append(eng.decode_spec(np.asarray(toks), remaining,
                                      [None] * cfg["slots"],
                                      [None] * cfg["slots"], cfg["rounds"],
                                      _draws=d).cpu())
    got, want = blocks
    counts = want[:, :, 0]
    flipped = int((got[:, :, 0] != counts).sum())
    same = torch.equal(got, want)
    print(f"extras spec sampled float32 T={cfg['temperature']} "
          f"top_k={cfg['top_k']} [{cfg['slots']} slots x {cfg['rounds']} "
          f"rounds] card vs cpu, same draws: blocks "
          f"{'identical' if same else 'DIFFER'}, accepted "
          f"{int((counts - 1).sum())} of "
          f"{cfg['slots'] * cfg['rounds'] * SPEC_TOKENS} proposals, "
          f"flipped accept counts={flipped} [{card}]")
    if not same:
        raise AssertionError(f"sampled speculative rounds differ between "
                             f"the card and the CPU:\n{got}\n{want}")


def extras_split(lm, refs, card: str) -> None:
    """A prefill-role and a decode-role replica: greedy streams equal
    lm.generate, each handoff carries kv_per_slot_bytes, and the export
    and install timed."""
    import numpy as np
    from deeplearning4j_tpu_torch.serving.fleet import (
        FleetRouter, ServeReplica, export_slot, install_slot)
    from deeplearning4j_tpu_torch.serving.fleet.handoff import SlotHandoff

    kw = dict(slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, device=EXTRAS_DEVICE)
    pre = ServeReplica("p0", lm, role="prefill", **kw)
    dec = ServeReplica("d0", lm, role="decode", fuse_steps=4, **kw)
    router = FleetRouter([pre, dec])
    sizes = {}                          # bytes of each request's slab
    place = router.place_handoff

    def recording(freq, handoff):
        sizes[freq.id] = handoff.nbytes
        return place(freq, handoff)

    router.place_handoff = recording
    sched = serve_schedule()
    b0 = _b1_launches()
    frs = [router.submit(a.prompt, a.max_new_tokens) for a in sched]
    while router.unfinished():
        pre.step_once()
        dec.step_once()
        router.retry_pending()          # parked slabs (the tick's job)
    _sync()
    per_slot = dec.server.stats()["kv_per_slot_bytes"]
    if sorted(sizes.values()) != [per_slot] * len(sched):
        raise AssertionError(f"handoff sizes {sorted(sizes.values())} != "
                             f"kv_per_slot_bytes {per_slot}")
    for fr in frs:
        want = refs[fr.prompt.tobytes()]
        if not np.array_equal(fr.output, want):
            raise AssertionError(
                "split fleet: stream differs from lm.generate at "
                + first_divergence(fr.output, want, lm, fr.prompt))
    if _b1_launches() - b0 != lm.num_layers * len(sched):
        raise AssertionError("split fleet: B1 did not run num_layers "
                             "times per prefill")
    eng_p, eng_d = pre.server.engine, dec.server.engine
    export_ms = install_ms = 0.0
    for _ in range(HANDOFF_REPS):
        _sync()
        t0 = time.monotonic()
        slabs = export_slot(eng_p, 0)
        t1 = time.monotonic()
        install_slot(eng_d, 1, SlotHandoff(
            slabs=slabs, cursor=1, key=None, first_token=0,
            kv_dtype=eng_d.kv_dtype, max_len=eng_d.max_len,
            device=eng_d.device.type))
        _sync()
        t2 = time.monotonic()
        export_ms += (t1 - t0) * 1e3 / HANDOFF_REPS
        install_ms += (t2 - t1) * 1e3 / HANDOFF_REPS
    print(f"extras split fleet (1 prefill + 1 decode replica): "
          f"{len(frs)} greedy streams equal lm.generate; handoff_bytes="
          f"{per_slot} (= kv_per_slot_bytes) export_ms={export_ms:.3f} "
          f"install_ms={install_ms:.3f} [{card}]")


def extras_fleet(lm, card: str) -> None:
    """FleetLoadDriver over 1 and 2 replicas and a kill of r0, then two
    threaded replicas with one killed."""
    import numpy as np
    from deeplearning4j_tpu_torch.resilience import faults
    from deeplearning4j_tpu_torch.serving.fleet import (
        FleetController, FleetLoadDriver, FleetRouter, ServeReplica)

    sched = serve_schedule(FLEET_REQUESTS, FLEET_RATE, seed=8)
    refs = {a.prompt.tobytes(): lm.generate(
        a.prompt[None], a.max_new_tokens)[0].cpu().numpy() for a in sched}

    def fleet(n):
        reps = [ServeReplica(f"r{i}", lm, slots=SERVE_SLOTS,
                             max_len=SERVE_MAX_LEN, fuse_steps=FLEET_FUSE,
                             device=EXTRAS_DEVICE) for i in range(n)]
        router = FleetRouter(reps)
        controller = FleetController(router, None, evict_timeout_s=5.0)
        return router, controller, FleetLoadDriver(router, controller)

    def zero_lost(what, router, report):
        if report.finished != len(sched):
            raise AssertionError(f"{what}: {report.finished} of "
                                 f"{len(sched)} finished")
        for fr in router.requests:
            if not np.array_equal(fr.output, refs[fr.prompt.tobytes()]):
                raise AssertionError(
                    f"{what}: a stream diverged from lm.generate at "
                    + first_divergence(fr.output, refs[fr.prompt.tobytes()],
                                       lm, fr.prompt))

    out = {}
    for n in (1, 2):
        router, _, driver = fleet(n)
        report = driver.run(sched)
        zero_lost(f"fleet of {n}", router, report)
        busy = driver.busy_seconds()
        out[n] = report.summary()
        print(f"extras fleet driver replicas={n} fuse_steps={FLEET_FUSE}: "
              f"tokens_per_sec={out[n]['tokens_per_sec']} "
              f"ttft_p50_ms={out[n]['ttft_p50_ms']} "
              f"p50_latency_ms={out[n]['p50_latency_ms']} busy_s="
              f"{ {k: round(v, 3) for k, v in busy.items()} } "
              f"balance={min(busy.values()) / max(busy.values()):.3f} "
              f"[{card}]")
    router, controller, driver = fleet(2)
    kill_at = sched[len(sched) // 2].arrival_s
    report = driver.run(sched, kill_at_s=kill_at, kill_replica="r0")
    zero_lost("fleet with r0 killed", router, report)
    recovery = (None if driver.failover_done_s is None
                else driver.failover_done_s - driver.kill_time_s)
    print(f"extras fleet driver replicas=2 kill r0 at {kill_at:.3f} s: "
          f"finished={report.finished} lost=0 diverged=0 evicted="
          f"{controller.evicted} failover_victims_recovery_s="
          f"{recovery if recovery is None else round(recovery, 4)} "
          f"tokens_per_sec={report.summary()['tokens_per_sec']} "
          f"scaling_2_over_1="
          f"{out[2]['tokens_per_sec'] / out[1]['tokens_per_sec']:.3f} "
          f"[{card}]")
    # two threaded replicas, r0 killed at its third loop iteration
    router, controller, _ = fleet(2)
    frs = [router.submit(a.prompt, a.max_new_tokens) for a in sched]
    t0 = time.monotonic()
    try:
        faults.install("serve.replica.step.r0", faults.fail_nth(3))
        for r in router.replicas:
            r.start()
        controller.start(interval_s=0.05)
        while time.monotonic() - t0 < 120 and router.unfinished():
            time.sleep(0.05)
    finally:
        faults.uninstall("serve.replica.step.r0")
        controller.stop()
        for r in router.replicas:
            r.stop()
    lost = sum(1 for fr in frs if not fr.finished)
    diverged = sum(1 for fr in frs if fr.finished and not np.array_equal(
        fr.output, refs[fr.prompt.tobytes()]))
    print(f"extras fleet threaded replicas=2, r0 killed: finished="
          f"{len(frs) - lost} lost={lost} diverged={diverged} evicted="
          f"{controller.evicted} wall_s={time.monotonic() - t0:.2f} "
          f"[{card}]")
    if lost or diverged or controller.evicted != ["r0"]:
        raise AssertionError("threaded fleet lost or diverged a request")


COMPILE_CHILD = """
import json, os, sys, time
t0 = time.monotonic()
sys.path.insert(0, os.getcwd())
import torch
from deeplearning4j_tpu_torch.models.transformer import TransformerLM
from deeplearning4j_tpu_torch.serving import (
    DecodeEngine, compile_cache_stats)
from deeplearning4j_tpu_torch.kernels import KERNEL_SOURCES, _build
lm = TransformerLM(vocab_size=64, d_model=128, num_heads=2, num_layers=1,
                   max_len=64)
DecodeEngine(lm, 1)                       # points the build at the cache
_build.build_all(KERNEL_SOURCES)          # one nvcc a source, all at once
for name in KERNEL_SOURCES:
    _build.load(name)
torch.cuda.synchronize()
print(json.dumps({"ready_s": round(time.monotonic() - t0, 3),
                  "nvcc_runs": len(_build.LOGS),
                  "build_dir": _build.BUILD_DIR,
                  "stats": compile_cache_stats()}))
"""


COLD_CHILD = {}  # the cold compile-cache child and its cache directory


def start_cold_compile_child() -> None:
    """Start phase 10's cold compile-cache child (``COMPILE_CHILD`` over a
    fresh ``DL4J_COMPILE_CACHE_DIR``): ``main`` starts it beside phase
    1's build, so that its ``nvcc`` runs while the card's first phases do
    (it held phase 10 for 88–124 s on its own)."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="dl4j_compile_cache_")
    COLD_CHILD.update(dir=tmp, proc=subprocess.Popen(
        [sys.executable, "-c", COMPILE_CHILD], cwd=HERE,
        env={**os.environ, "DL4J_COMPILE_CACHE_DIR": tmp},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))


def stop_cold_compile_child() -> None:
    """Kill the cold child if it still runs and remove its cache
    directory (on every way out of the smoke)."""
    import shutil

    proc = COLD_CHILD.pop("proc", None)
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait()
    if "dir" in COLD_CHILD:
        shutil.rmtree(COLD_CHILD.pop("dir"), ignore_errors=True)


def extras_compile_cache(card: str) -> None:
    """The cold child (started beside phase 1's build, or now) built B1-B3
    into DL4J_COMPILE_CACHE_DIR; a second, warm child loads them from
    there and runs nvcc zero times."""
    if "proc" not in COLD_CHILD:  # phase 10 without main's start
        start_cold_compile_child()
    try:
        tmp = COLD_CHILD["dir"]
        env = {**os.environ, "DL4J_COMPILE_CACHE_DIR": tmp}
        runs = []
        for label in ("cold", "warm"):
            if label == "cold":
                proc = COLD_CHILD["proc"]
                stdout, stderr = proc.communicate(timeout=CLI_TIMEOUT_S)
            else:
                proc = subprocess.run(
                    [sys.executable, "-c", COMPILE_CHILD], cwd=HERE,
                    env=env, capture_output=True, text=True,
                    timeout=CLI_TIMEOUT_S)
                stdout, stderr = proc.stdout, proc.stderr
            if proc.returncode != 0:
                raise AssertionError(f"{label} compile-cache child failed:"
                                     f"\n{stderr[-3000:]}")
            run = json.loads(stdout.strip().splitlines()[-1])
            runs.append(run)
            print(f"extras compile cache {label} child: ready_s="
                  f"{run['ready_s']} nvcc_runs={run['nvcc_runs']} "
                  f"stats={run['stats']} [{card}]")
        cold, warm = runs
        from deeplearning4j_tpu_torch.kernels import KERNEL_SOURCES

        if cold["nvcc_runs"] != len(KERNEL_SOURCES) or warm["nvcc_runs"]:
            raise AssertionError("the warm child ran nvcc, or the cold one "
                                 "did not build every kernel")
        if cold["build_dir"] != os.path.abspath(tmp) or \
                not warm["stats"]["configured"]:
            raise AssertionError("the children did not build into "
                                 "DL4J_COMPILE_CACHE_DIR")
    finally:
        stop_cold_compile_child()


def serve_extras(card: str) -> int:
    """Phase 10: beam search and make_generate, speculative decoding, the
    prefill/decode split, the fleet and the compile cache on the served
    model. Returns B1's launches over the phase; B2 and B3 must not
    launch."""
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM

    t0 = time.monotonic()
    reset_launch_counts()
    lm = TransformerLM(**SERVE_CFG, device=EXTRAS_DEVICE).init()
    sched = serve_schedule()
    refs = {a.prompt.tobytes(): lm.generate(
        a.prompt[None], a.max_new_tokens)[0].cpu().numpy() for a in sched}
    pair = f32_pair()
    extras_generate(lm, pair, card)
    extras_spec(lm, refs, card)
    if EXTRAS_DEVICE != "cpu":
        extras_traced(lm, card)
    extras_spec_sampled(pair, card)
    del pair
    extras_split(lm, refs, card)
    extras_fleet(lm, card)
    if EXTRAS_DEVICE != "cpu":
        extras_compile_cache(card)
    launches = launch_counts()
    if launches["flash_attention_bwd_dkdv"] or \
            launches["flash_attention_bwd_dq"]:
        raise AssertionError(f"the serving extras launched a backward "
                             f"kernel: {launches}")
    print(f"extras: phase wall {time.monotonic() - t0:.1f} s, B1 launches "
          f"{launches['flash_attention_fwd']} [{card}]")
    return launches["flash_attention_fwd"]


# ---------------------------------------------------------------------------
# phase 11: data — iterators and fetchers, the CUDA-stream prefetch, the
# streaming fallback, fused early stopping over a prefetching iterator,
# float64 gradient checks and preemption-safe training
# ---------------------------------------------------------------------------
DATA_DEVICE = "cuda"  # "cpu" only to rehearse the phase
# bench.py's bench_infeed (bench.py:488-522), nothing cut: the MNIST MLP
# (hidden 256) under bf16, 16 distinct batches of [4096, 784]
INFEED_BATCH, INFEED_BATCHES, INFEED_QUEUE = 4096, 16, 4
STREAM_CACHE_MB = 64  # below phase 8's 102 MB epoch cell: fit_epochs streams
# early stopping on LeNet-5 (bf16) at the reference bench's batch over the
# synthetic MNIST fetcher's 10,000 examples (fetchers.py's cap): 10 batches
ES_BATCH, ES_EXAMPLES, ES_MAX_EPOCHS, ES_PATIENCE = 1024, 10000, 5, 2
ES_TOL = dict(rtol=2e-2, atol=1e-2)  # the bf16 gate
# The late epochs' test losses (1e-4 to 4e-3) sit under ES_TOL's atol, so
# each score is also held within ES_REL of the CPU's: the bf16 runs part
# from it by up to 0.29 of it there (epochs 3 and 4, fused).
ES_REL = 0.5
# A second configuration whose ScoreImprovement condition ends the run:
# the test loss falls by 0.86 and 0.08 over epochs 1 and 2, then by less
# than ES_MIN_IMPROVEMENT, so with patience 1 it stops after epoch 3.
ES_MIN_IMPROVEMENT = 0.05
# four arrays of one shape and dtype a batch (two inputs, two outputs):
# the prefetch's staging ring must hand each its own buffer
MULTI_BATCH, MULTI_BATCHES = 2048, 6
# capture safety: a producer mid-stream over batches of shapes new to the
# process (96 + 2i rows of 333 features) while a LeNet-5 step captures
CAPTURE_BATCHES, CAPTURE_DELAY_S = 400, 0.001
GC_BATCH, GC_SUBSET = 4, 64  # gradient checks: small batch, 64 probes
FT_BATCH, FT_BATCHES, FT_EPOCHS = 1024, 4, 4  # the preemption cell


def _data_sync() -> None:
    import torch

    if DATA_DEVICE != "cpu":
        torch.cuda.synchronize()


def _data_dir_scope():
    """An empty data directory: every fetcher takes its synthetic path
    and nothing is read from outside the run."""
    import tempfile

    d = tempfile.mkdtemp(prefix="dl4j_data_")
    os.environ["DL4J_TPU_DATA_DIR"] = d
    os.environ.pop("DL4J_TPU_ALLOW_DOWNLOAD", None)
    return d


def _as_host(a):
    import numpy as np

    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def _arrays_of(batch) -> list:
    """Every array of a DataSet or MultiDataSet, masks included."""
    from deeplearning4j_tpu_torch.datasets import MultiDataSet

    if isinstance(batch, MultiDataSet):
        return [a for group in (batch.features, batch.labels,
                                batch.features_masks, batch.labels_masks)
                for a in (group or [])]
    return [batch.features, batch.labels, batch.features_mask,
            batch.labels_mask]


def _batches_equal(card_batches, host_batches) -> bool:
    import numpy as np

    def same(a, b):
        return (a is None) == (b is None) and (
            a is None or np.array_equal(_as_host(a), _as_host(b)))

    return len(card_batches) == len(host_batches) and all(
        len(_arrays_of(c)) == len(_arrays_of(h))
        and all(same(a, b) for a, b in zip(_arrays_of(c), _arrays_of(h)))
        for c, h in zip(card_batches, host_batches))


def _host_batches(batches, delay_s: float = 0.0):
    """An iterator over ``batches`` as they are (DataSets or
    MultiDataSets), each ``next`` after ``delay_s`` of host work."""
    from deeplearning4j_tpu_torch.datasets import DataSetIterator

    class HostBatches(DataSetIterator):
        def __init__(self):
            self.pos = 0

        def has_next(self):
            return self.pos < len(batches)

        def next(self, num=None):
            if delay_s:
                time.sleep(delay_s)
            self.pos += 1
            return batches[self.pos - 1]

        def reset(self):
            self.pos = 0

    return HostBatches()


def data_iterators(card: str) -> None:
    """The fetchers' iterators through the device prefetch yield on the
    card what they yield on the host, bitwise; a CSV parses natively."""
    import tempfile

    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import native
    from deeplearning4j_tpu_torch.datasets import (
        AsyncDataSetIterator, CurvesDataSetIterator, DataSet,
        IrisDataSetIterator, MnistDataSetIterator,
        MovingWindowDataSetIterator, MultiDataSet)
    from deeplearning4j_tpu_torch.datasets.records import (
        CSVRecordReader, RecordReaderDataSetIterator)
    from deeplearning4j_tpu_torch.monitor import metrics

    rng = np.random.default_rng(0)
    window_src = DataSet(rng.random((64, 784), np.float32),
                         np.eye(10, dtype=np.float32)[rng.integers(0, 10,
                                                                   64)])
    makers = {
        "MnistDataSetIterator(1024)": lambda: MnistDataSetIterator(1024),
        "IrisDataSetIterator(50)": lambda: IrisDataSetIterator(50),
        "CurvesDataSetIterator(500)": lambda: CurvesDataSetIterator(500),
        "MovingWindowDataSetIterator(1024, 14x14)":
            lambda: MovingWindowDataSetIterator(1024, window_src, 14, 14),
    }
    for name, make in makers.items():
        host = list(make())
        t0 = time.monotonic()
        card_batches = list(AsyncDataSetIterator(
            make(), queue_size=INFEED_QUEUE, device_prefetch=True,
            device=DATA_DEVICE))
        ms = (time.monotonic() - t0) * 1e3
        same = _batches_equal(card_batches, host)
        dev = {str(getattr(b.features, "device", "cpu"))
               for b in card_batches}
        print(f"data iterator {name}: batches={len(host)} "
              f"shape={list(host[0].features.shape)} device={sorted(dev)} "
              f"prefetched_ms={ms:.3f} card_equals_host={same} [{card}]")
        if not same or {torch.device(d).type for d in dev} != {DATA_DEVICE}:
            raise AssertionError(f"{name}: the prefetched batches differ "
                                 "from the host's")
    multi = [MultiDataSet([rng.random((MULTI_BATCH, 784), np.float32)
                           for _ in range(2)],
                          [rng.random((MULTI_BATCH, 784), np.float32)
                           for _ in range(2)])
             for _ in range(MULTI_BATCHES)]
    card_batches = list(AsyncDataSetIterator(
        _host_batches(multi), queue_size=INFEED_QUEUE, device_prefetch=True,
        device=DATA_DEVICE))
    same = _batches_equal(card_batches, multi)
    print(f"data iterator MultiDataSet 4 x [{MULTI_BATCH}, 784] a batch: "
          f"batches={len(multi)} card_equals_host={same} [{card}]")
    if not same:
        raise AssertionError("a MultiDataSet whose arrays share a shape "
                             "reached the card altered")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "iris.csv")
        iris = IrisDataSetIterator(150).fetcher
        rows = np.concatenate([iris.features,
                               iris.labels[:, None].astype(np.float32)], 1)
        np.savetxt(path, rows, delimiter=",", fmt="%.7g")
        before = metrics().counter("native_parse_total").value(
            path="native", fmt="csv")
        t0 = time.monotonic()
        batches = list(RecordReaderDataSetIterator(
            CSVRecordReader(path), 50, num_classes=3))
        ms = (time.monotonic() - t0) * 1e3
        parsed = metrics().counter("native_parse_total").value(
            path="native", fmt="csv") - before
        print(f"data csv iris {rows.shape}: native_available="
              f"{native.is_available()} native_parses={parsed} "
              f"batches={len(batches)} parse_ms={ms:.3f} [{card}]")
        if parsed <= 0:
            raise AssertionError("the CSV reader did not take the native "
                                 "parser")


def data_infeed(card: str) -> None:
    """bench_infeed: the same 16 distinct batches fed synchronously and
    through the CUDA-stream prefetch; both runs end on the same params."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets import (
        AsyncDataSetIterator, DataSet, ListDataSetIterator)

    rng = np.random.default_rng(0)
    batches = [DataSet(rng.random((INFEED_BATCH, 784), np.float32),
                       np.eye(10, dtype=np.float32)[
                           rng.integers(0, 10, INFEED_BATCH)])
               for _ in range(INFEED_BATCHES)]
    total = INFEED_BATCH * INFEED_BATCHES
    rates, nets = {}, {}
    for mode in ("sync", "prefetch"):
        net = build_network("mnist_mlp", "bf16", DATA_DEVICE)
        net.fit(batches[0])  # warm-up
        _data_sync()
        if mode == "sync":
            it = ListDataSetIterator(batches, INFEED_BATCH)
        else:
            it = AsyncDataSetIterator(
                ListDataSetIterator(batches, INFEED_BATCH),
                queue_size=INFEED_QUEUE, device_prefetch=True,
                device=DATA_DEVICE)
        t0 = time.monotonic()
        net.fit(it)
        _data_sync()
        rates[mode] = total / (time.monotonic() - t0)
        nets[mode] = net
    same = same_state(nets["sync"], nets["prefetch"])
    print(f"data infeed mnist_mlp bf16 {INFEED_BATCHES} x [{INFEED_BATCH}, "
          f"784]: sync_samples_per_sec={rates['sync']} "
          f"prefetch_samples_per_sec={rates['prefetch']} "
          f"ratio={rates['prefetch'] / rates['sync']} queue_size="
          f"{INFEED_QUEUE} params_bitwise={same} [{card}]")
    if not same:
        raise AssertionError("the prefetched fit differs from the "
                             "synchronous one")


def data_streaming(card: str) -> None:
    """Phase 8's epoch cell over a cache budget below the dataset: the
    fit_epochs fallback streams through the prefetch and lands where an
    eager fit loop lands, bitwise; prints its idle share."""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.perf.epoch_cache import prefetch_depth

    ds = epoch_data()
    it = ListDataSetIterator(ds, EPOCH_BATCH)
    streamed = build_network("mnist_mlp", "bf16", DATA_DEVICE)
    eager = build_network("mnist_mlp", "bf16", DATA_DEVICE)
    if streamed.fit_epochs(it, EPOCH_EPOCHS, cache_mb=STREAM_CACHE_MB) \
            is not None:
        raise AssertionError("fit_epochs cached a dataset over its budget")
    for _ in range(EPOCH_EPOCHS):
        eager.fit(it)
    same = same_state(streamed, eager)
    wall, host = timed(lambda: streamed.fit_epochs(
        it, EPOCH_EPOCHS, cache_mb=STREAM_CACHE_MB))
    row = {"ms_per_epoch": wall / EPOCH_EPOCHS * 1e3,
           "host_ms_per_epoch": host / EPOCH_EPOCHS * 1e3,
           "samples_per_sec": EPOCH_BATCH * EPOCH_BATCHES * EPOCH_EPOCHS
           / wall, "prefetch_depth": prefetch_depth()}
    # the eager streaming fit of phase 8 (pageable copies on the compute
    # stream), in this call for comparison
    wall_e, host_e = timed(lambda: [eager.fit(it)
                                    for _ in range(EPOCH_EPOCHS)])
    plain = {"ms_per_epoch": wall_e / EPOCH_EPOCHS * 1e3,
             "host_ms_per_epoch": host_e / EPOCH_EPOCHS * 1e3}
    if DATA_DEVICE == "cuda":
        for r, fn in ((row, lambda: streamed.fit_epochs(
                it, 1, cache_mb=STREAM_CACHE_MB)),
                      (plain, lambda: eager.fit(it))):
            prof = profiled(fn, 1)
            r.update(device_busy_ms=prof["device_busy_ms"],
                     device_idle_share=idle_share(prof, r["ms_per_epoch"]),
                     host_launches=prof["host_launches"])
    print(f"data streaming fit_epochs mnist_mlp [{EPOCH_BATCHES} x "
          f"{EPOCH_BATCH}, 784] bf16 cache_mb={STREAM_CACHE_MB}: "
          f"prefetched={json.dumps(row)} eager_fit={json.dumps(plain)} "
          f"(PERF.md, an earlier call: eager fit 70.827 ms an epoch, idle "
          f"0.692) params_equal_eager_fit={same} [{card}]")
    if not same:
        raise AssertionError("the streamed fit_epochs differs from fit")


def data_capture_safety(card: str) -> None:
    """A CUDA-graph capture that begins while a prefetch producer is
    mid-stream. The producer stages batches of shapes new to the process,
    so it pins staging buffers and allocates device blocks as it goes; a
    new LeNet-5, warmed up, then captures its ``fit_steps`` step. The
    capture must not be invalidated, the producer must have waited for it
    (``capture_waits``) and still be mid-stream after it, the replayed
    steps must equal the same steps run eagerly, and every batch must
    reach the card bitwise as the host holds it."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import (
        AsyncDataSetIterator, DataSet)

    rng = np.random.default_rng(3)
    host = [DataSet(rng.random((96 + 2 * i, 333), np.float32),
                    rng.random((96 + 2 * i, 7), np.float32))
            for i in range(CAPTURE_BATCHES)]
    x, y = network_data("lenet5", ES_BATCH)
    ds = DataSet(x, y)
    net = build_network("lenet5", "bf16", DATA_DEVICE)
    net.fit_steps(ds, 1)  # the warm-up step: the next call captures
    _data_sync()
    source = _host_batches(host, CAPTURE_DELAY_S)
    it = AsyncDataSetIterator(source, queue_size=CAPTURE_BATCHES,
                              device_prefetch=True, device=DATA_DEVICE)
    got = [it.next()]
    started = source.pos
    net.fit_steps(ds, 2)  # capture, then two replays
    _data_sync()
    during = source.pos
    while it.has_next():
        got.append(it.next())
    copier = it._copier
    waits = copier.capture_waits if copier is not None else 0
    graphs = [p.graph for p in net._programs.values()
              if getattr(p, "graph", None) is not None]
    twin = build_network("lenet5", "bf16", DATA_DEVICE)
    with captured(False):
        twin.fit_steps(ds, 3)
    same_steps = same_state(net, twin)
    same = _batches_equal(got, host)
    print(f"data capture_safety lenet5 bf16 [{ES_BATCH}, 28, 28, 1] "
          f"fit_steps capture over a producer of {CAPTURE_BATCHES} new "
          f"shapes: captures={sum(g.captures for g in graphs)} "
          f"replays={sum(g.replays for g in graphs)} producer_batches_at_"
          f"capture={started}..{during} capture_waits={waits} "
          f"replayed_equals_eager={same_steps} card_equals_host={same} "
          f"[{card}]")
    if not same:
        raise AssertionError("batches prefetched across a capture differ "
                             "from the host's")
    if not same_steps:
        raise AssertionError("the steps captured beside a producer differ "
                             "from the same steps run eagerly")
    if DATA_DEVICE == "cuda":
        if sum(g.captures for g in graphs) != 1:
            raise AssertionError("fit_steps did not capture its step")
        if not (waits >= 1 and during < CAPTURE_BATCHES):
            raise AssertionError("the producer was not mid-stream while "
                                 "the step captured")


def _es_config(es, test_iter, patience, min_improvement=0.0):
    return (es.EarlyStoppingConfiguration.Builder()
            .epoch_termination_conditions(
                es.ScoreImprovementEpochTerminationCondition(
                    patience, min_improvement),
                es.MaxEpochsTerminationCondition(ES_MAX_EPOCHS))
            .iteration_termination_conditions(
                es.InvalidScoreIterationTerminationCondition())
            .score_calculator(es.DataSetLossCalculator(test_iter))
            .build())


def _es_run(device: str, fuse: bool, patience, min_improvement):
    from deeplearning4j_tpu_torch import earlystopping as es
    from deeplearning4j_tpu_torch.datasets import (
        AsyncDataSetIterator, MnistDataSetIterator)

    net = build_network("lenet5", "bf16", device)
    train = MnistDataSetIterator(ES_BATCH, ES_EXAMPLES, flatten=False)
    if device != "cpu":
        train = AsyncDataSetIterator(train, queue_size=INFEED_QUEUE,
                                     device_prefetch=True, device=device)
    test = MnistDataSetIterator(ES_BATCH, ES_EXAMPLES, train=False,
                                flatten=False)
    t0 = time.monotonic()
    result = es.EarlyStoppingTrainer(
        _es_config(es, test, patience, min_improvement), net, train,
        fuse_epochs=fuse).fit()
    return net, result, time.monotonic() - t0


def data_early_stopping(card: str) -> None:
    """Fused early stopping on LeNet-5 (bf16) fed by a prefetching
    iterator, then the per-batch loop; both against the CPU's per-batch
    run, under two configurations: the one MaxEpochs ends, and one whose
    ScoreImprovement condition ends it. (The fused trainer drains the
    iterator into its device cache before it captures, so its capture
    runs after the producer ended: ``data_capture_safety`` overlaps
    them.)"""
    import math

    configs = {"max_epochs": (ES_PATIENCE, 0.0, "MaxEpochs"),
               "score_improvement": (1, ES_MIN_IMPROVEMENT,
                                     "ScoreImprovement")}
    for config, (patience, min_imp, ender) in configs.items():
        runs = {}
        for label, device, fuse in (("fused", DATA_DEVICE, True),
                                    ("per_batch", DATA_DEVICE, False),
                                    ("cpu_per_batch", "cpu", False)):
            net, result, wall = _es_run(device, fuse, patience, min_imp)
            progs = [p.graph for p in net._programs.values()
                     if getattr(p, "graph", None) is not None]
            runs[label] = result
            print(f"data early_stopping {config} lenet5 bf16 [{ES_BATCH}, "
                  f"28, 28, 1] x {ES_EXAMPLES // ES_BATCH + 1} batches "
                  f"{label}: reason={result.termination_reason.value} "
                  f"details={result.termination_details!r} best_epoch="
                  f"{result.best_model_epoch} epochs={result.total_epochs} "
                  f"score_vs_epoch={json.dumps(result.score_vs_epoch)} "
                  f"captures={sum(g.captures for g in progs)} "
                  f"replays={sum(g.replays for g in progs)} wall_s={wall} "
                  f"[{card}]")
            if label == "fused" and DATA_DEVICE == "cuda" and not any(
                    g.captures for g in progs):
                raise AssertionError("the fused early-stopping run "
                                     "captured no graph")
        base = runs["cpu_per_batch"]
        if not str(base.termination_details).startswith(ender):
            raise AssertionError(f"early stopping {config}: the CPU run "
                                 f"ended on {base.termination_details}, "
                                 f"not {ender}")
        for label in ("fused", "per_batch"):
            r = runs[label]
            if (r.termination_reason != base.termination_reason
                    or r.termination_details != base.termination_details
                    or r.best_model_epoch != base.best_model_epoch
                    or sorted(r.score_vs_epoch)
                    != sorted(base.score_vs_epoch)):
                raise AssertionError(f"early stopping {config} {label}: "
                                     f"{r} differs from the CPU's {base}")
            for e, sc in base.score_vs_epoch.items():
                got = r.score_vs_epoch[e]
                gap = abs(got - sc)
                if not (math.isfinite(got)
                        and gap <= ES_TOL["atol"] + ES_TOL["rtol"] * abs(sc)
                        and gap <= ES_REL * abs(sc)):
                    raise AssertionError(
                        f"early stopping {config} {label} epoch {e}: "
                        f"score {got} vs the CPU's {sc}")


def _gc_cases(device: str):
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn import (
        ComputationGraph, MultiLayerNetwork, NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf import InputType
    from deeplearning4j_tpu_torch.nn.conf import layers as L

    rng = np.random.default_rng(0)

    def onehot(shape, c):
        return np.eye(c)[rng.integers(0, c, shape)]

    bn = (NeuralNetConfiguration.Builder().seed(3).dtype_policy("bf16")
          .graph_builder().add_inputs("in")
          .add_layer("d", L.DenseLayer(n_in=32, n_out=16,
                                       activation="tanh"), "in")
          .add_layer("bn", L.BatchNormalization(n_out=16), "d")
          .add_layer("out", L.OutputLayer(n_in=16, n_out=5), "bn")
          .set_outputs("out").build())
    lstm = (NeuralNetConfiguration.Builder().seed(3).dtype_policy("bf16")
            .list().layer(0, L.GravesLSTM(n_in=8, n_out=16))
            .layer(1, L.RnnOutputLayer(n_in=16, n_out=4)).build())
    return {
        "mnist_mlp": (build_network("mnist_mlp", "bf16", device),
                      DataSet(rng.random((GC_BATCH, 784)),
                              onehot(GC_BATCH, 10))),
        "lenet5": (build_network("lenet5", "bf16", device),
                   DataSet(rng.random((GC_BATCH, 28, 28, 1)),
                           onehot(GC_BATCH, 10))),
        "batchnorm_graph": (ComputationGraph(bn, device=device).init(),
                            DataSet(rng.normal(size=(GC_BATCH, 32)),
                                    onehot(GC_BATCH, 5))),
        "graves_lstm": (MultiLayerNetwork(lstm, device=device).init(),
                        DataSet(rng.normal(size=(GC_BATCH, 7, 8)),
                                onehot((GC_BATCH, 7), 4))),
    }


def data_gradient_checks(card: str) -> None:
    """float64 central differences on the card, 64 probes each."""
    from deeplearning4j_tpu_torch.gradientcheck import check_gradients

    for name, (net, ds) in _gc_cases(DATA_DEVICE).items():
        report = {}
        t0 = time.monotonic()
        ok = check_gradients(net, ds, subset=GC_SUBSET, report=report)
        wall = time.monotonic() - t0
        print(f"data gradient_check {name} float64 batch {GC_BATCH}: "
              f"passed={ok} probes={report['n_probed']} max_rel_error="
              f"{report['max_rel_error']:.3e} max_abs_error="
              f"{report['max_abs_error']:.3e} wall_s={wall} [{card}]")
        if not ok:
            raise AssertionError(f"gradient check {name}: "
                                 f"{report['failures'][:4]}")


def data_fault_tolerance(card: str) -> None:
    """FaultTolerantTrainer.fit_epochs on LeNet-5 with an injected
    preemption at the second chunk boundary; a fresh trainer resumes and
    finishes, bitwise the uninterrupted run; a truncated newest checkpoint
    falls back to the one before it, and that run finishes bitwise too."""
    import shutil
    import tempfile

    import numpy as np
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel import FaultTolerantTrainer
    from deeplearning4j_tpu_torch.resilience import faults

    rng = np.random.default_rng(0)
    n = FT_BATCH * FT_BATCHES
    ds = DataSet(rng.random((n, 28, 28, 1), np.float32),
                 np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)])

    def it():
        return ListDataSetIterator(ds, FT_BATCH)

    def lenet():
        return build_network("lenet5", "bf16", DATA_DEVICE)

    root = tempfile.mkdtemp(prefix="dl4j_ckpt_")
    try:
        base = lenet()
        FaultTolerantTrainer(base, os.path.join(root, "base")).fit_epochs(
            it(), FT_EPOCHS)
        run = os.path.join(root, "run")
        net = lenet()
        ft = FaultTolerantTrainer(net, run)
        faults.install("preempt.chunk", faults.fail_nth(2))
        try:
            ft.fit_epochs(it(), FT_EPOCHS)
        finally:
            faults.clear()
        if not ft.preempted:
            raise AssertionError("the injected preemption did not stop "
                                 "the run")
        wall_save, _ = timed(ft.save)
        cut = os.path.join(root, "cut")
        shutil.copytree(run, cut)
        results = {}
        for label, d in (("resumed", run), ("fell_back", cut)):
            if label == "fell_back":
                newest = FaultTolerantTrainer(lenet(), d).latest_checkpoint()
                with open(newest, "r+b") as f:
                    f.truncate(os.path.getsize(newest) // 2)
            fresh = lenet()
            ft2 = FaultTolerantTrainer(fresh, d)
            wall_resume, _ = timed(ft2.resume)
            cursor = fresh._epoch_cursor
            ft2.fit_epochs(it(), FT_EPOCHS)
            results[label] = (same_state(fresh, base), cursor, wall_resume)
        print(f"data fault_tolerance lenet5 bf16 {FT_BATCHES} x "
              f"[{FT_BATCH}, 28, 28, 1] x{FT_EPOCHS} epochs, preempted at "
              f"epoch {net._epoch_cursor}: checkpoint_save_ms="
              f"{wall_save * 1e3} resume_ms={results['resumed'][2] * 1e3} "
              f"resumed_bitwise={results['resumed'][0]} (from epoch "
              f"{results['resumed'][1]}) fallback_bitwise="
              f"{results['fell_back'][0]} (from epoch "
              f"{results['fell_back'][1]}) [{card}]")
        if not (results["resumed"][0] and results["fell_back"][0]):
            raise AssertionError(f"resumed runs differ from the "
                                 f"uninterrupted one: {results}")
        if results["fell_back"][1] >= results["resumed"][1]:
            raise AssertionError("the truncated checkpoint was not skipped")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def data(card: str) -> dict:
    """Phase 11; returns B1–B3's launches over it (all must be 0)."""
    import shutil

    import torch
    from deeplearning4j_tpu_torch.perf import step_graph

    data_dir = _data_dir_scope()
    step_graph.reset_kernel_launches()
    try:
        for part in (data_iterators, data_infeed, data_streaming,
                     data_capture_safety, data_early_stopping,
                     data_gradient_checks, data_fault_tolerance):
            t0 = time.monotonic()
            part(card)
            print(f"data {part.__name__}: {time.monotonic() - t0:.1f} s")
            if DATA_DEVICE == "cuda":
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    launches = step_graph.kernel_launches()
    if any(launches.values()):
        raise AssertionError(f"the data phase launched a flash kernel: "
                             f"{launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 12: monitor — ledger, memory, exporters, flight recorder, profiles
# ---------------------------------------------------------------------------
PROFILE_REPLAYS = 10  # timed replays of the profiled LM step


def monitor_run(card: str) -> None:
    """A DL4J_PROFILE fit_epochs on phase 8's epoch cell with the file
    exporters and the flight recorder on, under a temporary telemetry
    directory."""
    import importlib
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.monitor import memory

    flight = importlib.import_module("deeplearning4j_tpu_torch.monitor.flight")
    tele = tempfile.mkdtemp(prefix="dl4j_tele_")
    env = {"DL4J_PROFILE": "on", "DL4J_TELEMETRY_DIR": tele,
           "DL4J_FLIGHT": "on"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    monitor.set_tracer(None)  # re-derived: the JSONL span sink
    flight.set_flight(None)
    monitor.set_run_ledger(None)
    try:
        net = build_network("mnist_mlp", "bf16", DATA_DEVICE)
        cache = net.build_epoch_cache(
            ListDataSetIterator(epoch_data(), EPOCH_BATCH))
        wall, _ = timed(lambda: net.fit_epochs(cache, EPOCH_EPOCHS,
                                               chunk_epochs=1))
        run = monitor.run_ledger().report()["runs"][-1]
        # no idle inside a run's window: compute + badput cover it
        states = {"compute": run["goodput_pct"] / 100 * run["wall_s"],
                  **run["badput"]}
        window = run["wall_s"]
        summed = sum(states.values())
        budget = memory.validate_cache_budget(cache)
        marks = net._hbm_watermarks
        prom = monitor.write_prometheus_textfile()
        jsonl = monitor.export_metrics_jsonl()
        rec = monitor.flight()
        rec.flush()
        records = monitor.load_flight_records(os.path.join(tele, "flight"))
        kinds = [r["kind"] for r in records]
        with open(jsonl) as f:
            lines = [json.loads(l) for l in f]
        with open(prom) as f:
            prom_text = f.read()
        profs = monitor.profiles().find(name="MultiLayerNetwork.fit_epochs")
        print(f"monitor ledger mnist_mlp [{EPOCH_BATCHES} x {EPOCH_BATCH}] "
              f"bf16 x{EPOCH_EPOCHS} DL4J_PROFILE=on: goodput_pct="
              f"{run['goodput_pct']} states={json.dumps(states)} "
              f"window_s={window} states_sum_s={summed} "
              f"fit_epochs_wall_s={wall} chunks={run['chunks']} [{card}]")
        print(f"monitor memory: cache_budget={json.dumps(budget)} "
              f"watermarks={len(marks)} last={json.dumps(marks[-1])} "
              f"[{card}]")
        print(f"monitor exporters: jsonl_lines={len(lines)} "
              f"prometheus_bytes={len(prom_text)} flight_records="
              f"{len(records)} flight_kinds={sorted(set(kinds))} "
              f"epoch_program_profiles={len(profs)} [{card}]")
        if abs(summed - window) > 0.01 * window:
            raise AssertionError(f"the ledger's states {states} do not "
                                 f"sum to its window {window}")
        if not budget["within_tolerance"]:
            raise AssertionError(f"cache budget drift: {budget}")
        if len(marks) != EPOCH_EPOCHS or any(
                m["devices"][0]["source"] != "memory_stats"
                for m in marks) and DATA_DEVICE == "cuda":
            raise AssertionError(f"watermarks {marks}")
        if not (lines and "dl4j_train_chunk_dispatches_total" in prom_text
                and kinds.count("chunk.done") == EPOCH_EPOCHS
                and "run.end" in kinds and profs):
            raise AssertionError("an exporter or the flight recorder "
                                 "missed the run")
    finally:
        rec = flight.flight()
        if rec is not None:
            rec.close()
        flight.set_flight(None)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        monitor.set_tracer(None)
        shutil.rmtree(tele, ignore_errors=True)


def monitor_profile(card: str) -> dict:
    """capture_program_profile on phase 8's LM cell: one eager step
    counted (B1–B3 by their bounds' formulas), then timed replays of the
    captured step; returns B1–B3's launches over it."""
    import torch
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    from deeplearning4j_tpu_torch.monitor import (
        capture_program_profile, classify_boundedness,
        flops_divergence_pct)
    from deeplearning4j_tpu_torch.perf import step_graph

    lm = TransformerLM(**TRAIN_CFG).init()
    tok = torch.as_tensor(train_tokens(), device=lm.device)
    cfg = TRAIN_CFG
    head = cfg["d_model"] // cfg["num_heads"]
    vis = fa.visible_keys(TRAIN_T, TRAIN_T, causal=True)
    attn = cfg["num_layers"] * (4 + 8 + 6) * TRAIN_BATCH * \
        cfg["num_heads"] * head * vis
    matmul_per_token = lm.flops_per_token(TRAIN_T) - \
        12 * cfg["num_layers"] * cfg["d_model"] * (TRAIN_T / 2)
    analytic = TRAIN_BATCH * TRAIN_T * matmul_per_token + attn
    step_graph.reset_kernel_launches()
    prof, _ = capture_program_profile(
        lambda t: lm.fit_batch(t, block=False), (tok,),
        name="TransformerLM.fit_batch", key=("d512", "L8"),
        replays=PROFILE_REPLAYS)
    torch.cuda.synchronize()
    launches = step_graph.kernel_launches()
    split = classify_boundedness(prof.flops, prof.bytes_accessed,
                                 prof.measured_s, fa.H100_FLOPS[
                                     torch.bfloat16], fa.H100_BYTES_PER_S)
    div = flops_divergence_pct(analytic, prof.flops)
    print(f"monitor profile lm d{cfg['d_model']} L{cfg['num_layers']} "
          f"[{TRAIN_BATCH}, {TRAIN_T}] mixed_bf16 fit_batch: flops="
          f"{prof.flops} analytic_flops={analytic} divergence_pct={div} "
          f"kernel_flops={json.dumps(prof.kernel_flops)} bytes_accessed="
          f"{prof.bytes_accessed} measured_ms={prof.measured_s * 1e3} "
          f"peak_bytes={prof.peak_bytes} classify={json.dumps(split)} "
          f"launches={launches} [{card}]")
    if div is None or abs(div) > 2.0:
        raise AssertionError(f"profiled FLOPs {prof.flops} are {div}% off "
                             f"the analytic {analytic}")
    # the counted step, the warm-up and capture calls, the timed replays
    want = {k: lm.num_layers * (3 + PROFILE_REPLAYS) for k in launches}
    if launches != want:
        raise AssertionError(f"profiled step launched {launches}, "
                             f"expected {want}")
    return launches


def monitor_phase(card: str) -> dict:
    """Phase 12; returns B1–B3's launches over the profiled step."""
    import torch

    monitor_run(card)
    torch.cuda.empty_cache()
    return monitor_profile(card)


# ---------------------------------------------------------------------------
# phase 13: embeddings — word2vec (host loop and fused epoch), GloVe,
# SequenceVectors, ParagraphVectors, DeepWalk
# ---------------------------------------------------------------------------
EMBED_DEVICE = "cuda"  # "cpu" only to rehearse the phase
# E1, bench.py's bench_word2vec (bench.py:344-392), nothing cut: 2000
# sentences of 40 tokens drawn as zipf(1.3) % 5000 from default_rng(0)
W2V_VOCAB, W2V_SENTENCES, W2V_LEN = 5000, 2000, 40
W2V_CFG = dict(layer_size=128, window_size=5, min_word_frequency=1,
               negative=5, iterations=1, epochs=1)
W2V_TIMED_EPOCHS = 3
# E2, text8's scale: its 17,005,207 tokens as sentences of 40, drawn as
# zipf(1.3) % 71,290 (text8's vocabulary at min_count 5)
TEXT8_TOKENS, TEXT8_VOCAB, TEXT8_MIN_COUNT = 17_005_207, 71_290, 5
TEXT8_BUDGET_MB = 16384  # the plan prices at ~8.7 GiB, over the default
TEXT8_REPLAY_WINDOW = 256  # replays profiled for the idle share
# E3, small cells held against the CPU
GLOVE_CFG = dict(layer_size=32, window_size=5, min_word_frequency=1,
                 epochs=3, seed=5)
PV_DOCS, PV_EPOCHS = 200, 2
DEEPWALK_VERTICES, DEEPWALK_WALK, DEEPWALK_WINDOW = 2000, 8, 4
SIMILARITY_PAIRS = 20
EMBED_TOL = dict(rtol=2e-3, atol=1e-3)  # the train phase's float32 gate


def _embed_sync() -> None:
    import torch

    if EMBED_DEVICE != "cpu":
        torch.cuda.synchronize()


def zipf_corpus(n_sentences: int, vocab: int, length: int = W2V_LEN):
    """bench_word2vec's draw: ``zipf(1.3, (S, L)) % vocab`` from
    ``default_rng(0)``, tokens ``w<t>``; returns the sentences and the
    index array."""
    import numpy as np

    rng = np.random.default_rng(0)
    ids = rng.zipf(1.3, size=(n_sentences, length)) % vocab
    names = [f"w{i}" for i in range(vocab)]
    return [" ".join(map(names.__getitem__, row)) for row in ids.tolist()], ids


def make_w2v(sentences, seed: int, device: str, **kw):
    from deeplearning4j_tpu_torch.nlp import (
        CollectionSentenceIterator, Word2Vec)

    return Word2Vec(CollectionSentenceIterator(sentences), seed=seed,
                    device=device, **{**W2V_CFG, **kw})


def _w2v_state(m):
    return (m.syn0, m.syn1neg)


def _tables_equal(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def _tables_err(card, host) -> float:
    return max(float((c.cpu() - h).abs().max()) for c, h in zip(card, host))


def _check_close(what: str, card, host, card_line_: str) -> None:
    import torch

    ok = all(torch.allclose(c.cpu(), h, **EMBED_TOL)
             for c, h in zip(card, host))
    print(f"embeddings parity {what}: max_abs_err {_tables_err(card, host):.3e}"
          f" gate rtol {EMBED_TOL['rtol']} atol {EMBED_TOL['atol']} "
          f"ok={ok} [{card_line_}]")
    if not ok:
        raise AssertionError(f"{what}: the card differs from the CPU")


def e1_word2vec(card: str, sentences) -> dict:
    """E1: the host loop cold and warm, the fused path (warm-up, then 3
    timed epochs and a profiled one), replay against eager bitwise."""
    import torch
    from deeplearning4j_tpu_torch.nlp import epoch_kernels as ek

    words = W2V_SENTENCES * W2V_LEN
    out = {}
    for name, seed in (("host_cold", 42), ("host_warm", 43)):
        m = make_w2v(sentences, seed, EMBED_DEVICE)
        _embed_sync()
        t0 = time.perf_counter()
        m.fit()
        _embed_sync()
        out[f"{name}_words_per_sec"] = words / (time.perf_counter() - t0)
        if not bool(torch.isfinite(m.syn0).all()):
            raise AssertionError(f"{name}: non-finite tables")
    fused = make_w2v(sentences, 44, EMBED_DEVICE)
    fused.build_vocab()
    fused.reset_weights()
    t0 = time.perf_counter()
    cache = fused.build_corpus_cache()
    out["cache_build_ms"] = (time.perf_counter() - t0) * 1e3
    fused.fit_epochs(1)  # warm-up: the first epoch warms up and captures
    prog = fused._skipgram_program(cache)
    base, r0 = fused._train_dispatches, prog.graph.replays
    res = {}
    wall, host = _embed_timed(lambda: res.setdefault(
        "hist", fused.fit_epochs(W2V_TIMED_EPOCHS)))
    hist = res["hist"]
    if hist is None or tuple(hist.shape) != (W2V_TIMED_EPOCHS,
                                             cache.n_batches):
        raise AssertionError(f"fit_epochs returned {hist}: the fused path "
                             "did not run")
    if fused._train_dispatches - base != 1:
        raise AssertionError(f"{fused._train_dispatches - base} chunk calls "
                             f"for one fit_epochs({W2V_TIMED_EPOCHS})")
    if not bool(torch.isfinite(hist).all()):
        raise AssertionError("non-finite fused losses")
    out.update(fused_words_per_sec=W2V_TIMED_EPOCHS * cache.n_words / wall,
               fused_ms_per_epoch=wall / W2V_TIMED_EPOCHS * 1e3,
               fused_host_ms_per_epoch=host / W2V_TIMED_EPOCHS * 1e3,
               chunk_calls=fused._train_dispatches - base,
               batches_per_epoch=cache.n_batches, batch=cache.batch,
               replays=prog.graph.replays - r0,
               captures=prog.graph.captures,
               loss_first_last=[float(hist[0, 0]), float(hist[-1, -1])],
               table_bytes=sum(t.numel() * t.element_size()
                               for t in _w2v_state(fused)),
               cache=cache.describe())
    if EMBED_DEVICE != "cpu":
        plan_ms = cuda_ms(lambda: cache.plan(ek.epoch_generator(1, "cuda"),
                                             out=prog.plan), iters=3)
        prof = profiled(lambda: fused.fit_epochs(1), 1)
        out.update(plan_ms=plan_ms, device_busy_ms=prof["device_busy_ms"],
                   device_idle_share=idle_share(prof,
                                                out["fused_ms_per_epoch"]),
                   host_launches=prof["host_launches"])
    print(f"embeddings e1 word2vec [{W2V_SENTENCES} x {W2V_LEN}] "
          f"zipf(1.3)%{W2V_VOCAB} d{W2V_CFG['layer_size']} w"
          f"{W2V_CFG['window_size']} neg{W2V_CFG['negative']}: "
          f"{json.dumps(out)} [{card}]")

    # replay against eager: the same seed's epoch, graphed and eager, and
    # a second graphed run (two card runs must agree bitwise too)
    runs = []
    for graphs in (True, False, True):
        with captured(graphs):
            m = make_w2v(sentences, 44, EMBED_DEVICE)
            m.build_vocab()
            m.reset_weights()
            m.build_corpus_cache()
            h = m.fit_epochs(2)
            runs.append((h, _w2v_state(m)))
    (hg, sg), (he, se), (hg2, sg2) = runs
    bitwise = torch.equal(hg, he) and _tables_equal(sg, se)
    again = torch.equal(hg, hg2) and _tables_equal(sg, sg2)
    print(f"embeddings e1 fused replay_equals_eager={bitwise} "
          f"two_replayed_runs_equal={again} (2 epochs, max_abs_err "
          f"{max(float((a - b).abs().max()) for a, b in zip(sg, se)):.3e})"
          f" [{card}]")
    if not (bitwise and again):
        raise AssertionError("the fused skip-gram's replays differ from "
                             "its eager steps or from each other")
    return out


def _embed_timed(fn):
    """``timed`` on the card; the host clock when rehearsing on the CPU."""
    if EMBED_DEVICE != "cpu":
        return timed(fn)
    t0 = time.monotonic()
    fn()
    s = time.monotonic() - t0
    return s, s


def e1_parity(card: str, sentences) -> None:
    """E1 card against CPU, TF32 off: one fused epoch fed the same plan,
    one host-loop epoch with the same numpy draws, and ``similarity`` on
    20 fixed pairs."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.nlp import epoch_kernels as ek

    torch.backends.cuda.matmul.allow_tf32 = False
    card_m = make_w2v(sentences, 45, EMBED_DEVICE)
    host_m = make_w2v(sentences, 45, "cpu")
    for m in (card_m, host_m):
        m.build_vocab()
        m.reset_weights()
    cache = card_m.build_corpus_cache()
    plan = [tuple(p.cpu() for p in cache.plan(
        ek.epoch_generator(ek.epoch_keys_for(45, 0, 1)[0], cache.device)))]
    host_m.build_corpus_cache()
    hc = card_m.fit_epochs(1, _plan=plan)
    hh = host_m.fit_epochs(1, _plan=plan)
    _check_close("e1 fused epoch (same plan)", (*_w2v_state(card_m), hc),
                 (*_w2v_state(host_m), hh), card)

    card_h = make_w2v(sentences, 46, EMBED_DEVICE)
    host_h = make_w2v(sentences, 46, "cpu")
    card_h.fit()
    host_h.fit()
    _check_close("e1 host loop (same draws)", _w2v_state(card_h),
                 _w2v_state(host_h), card)
    rng = np.random.default_rng(1)
    words = card_h.vocab.words()
    pairs = [tuple(words[i] for i in rng.integers(0, len(words), 2))
             for _ in range(SIMILARITY_PAIRS)]
    sims = np.asarray([[card_h.similarity(a, b), host_h.similarity(a, b)]
                       for a, b in pairs])
    _check_close(f"e1 similarity ({SIMILARITY_PAIRS} pairs)",
                 (torch.from_numpy(sims[:, 0]),),
                 (torch.from_numpy(sims[:, 1]),), card)
    e1_dataset_iterator(card, card_h, host_h, sentences)


def e1_dataset_iterator(card: str, card_m, host_m, sentences) -> None:
    """``Word2VecDataSetIterator`` over the card model's table against the
    same table on the CPU: bitwise (a gather)."""
    import torch
    from deeplearning4j_tpu_torch.nlp import Word2VecDataSetIterator

    host_m.syn0 = card_m.syn0.cpu()
    labeled = [(s.split(), "ab"[i % 2]) for i, s in enumerate(
        sentences[:200])]
    ic = Word2VecDataSetIterator(card_m, labeled, ["a", "b"], 5, batch=512)
    ih = Word2VecDataSetIterator(host_m, labeled, ["a", "b"], 5, batch=512)
    n, same = 0, True
    while ih.has_next():
        a, b = ic.next(), ih.next()
        same &= (a.features.device.type == EMBED_DEVICE
                 and torch.equal(a.features.cpu(), b.features)
                 and torch.equal(a.labels.cpu(), b.labels))
        n += 1
    print(f"embeddings e1 word2vec_iterator: {n} batches of 512, features "
          f"{ic.input_columns()}, card_equals_host={same} [{card}]")
    if not same or ic.has_next():
        raise AssertionError("Word2VecDataSetIterator: the card's batches "
                             "differ from the host's")


def e2_text8(card: str) -> dict:
    """E2: text8's scale, fused only: a warm-up and a timed epoch."""
    import torch
    from deeplearning4j_tpu_torch.nlp import epoch_kernels as ek

    t_phase = time.monotonic()
    n_sent = -(-TEXT8_TOKENS // W2V_LEN)
    t0 = time.perf_counter()
    sentences, _ = zipf_corpus(n_sent, TEXT8_VOCAB)
    corpus_ms = (time.perf_counter() - t0) * 1e3
    m = make_w2v(sentences, 47, EMBED_DEVICE,
                 min_word_frequency=TEXT8_MIN_COUNT, epochs=2)
    t0 = time.perf_counter()
    m.build_vocab()
    vocab_ms = (time.perf_counter() - t0) * 1e3
    m.reset_weights()
    if EMBED_DEVICE != "cpu":
        mark = memory_mark()
    t0 = time.perf_counter()
    cache = m.build_corpus_cache(budget_mb=TEXT8_BUDGET_MB)
    _embed_sync()
    cache_ms = (time.perf_counter() - t0) * 1e3
    del sentences
    if cache is None:
        raise AssertionError("E2: the corpus cache fell back to the host "
                             "loop")
    h = m.fit_epochs(1)  # warm-up epoch (warm-up step and capture)
    if h is None:
        raise AssertionError("E2: fit_epochs fell back to the host loop")
    res = {}
    wall, host = _embed_timed(lambda: res.setdefault("hist",
                                                     m.fit_epochs(1)))
    hist = res["hist"]
    if hist is None or not bool(torch.isfinite(hist).all()):
        raise AssertionError(f"E2: fused epoch gave {hist}")
    prog = m._skipgram_program(cache)
    out = dict(sentences=n_sent, tokens=n_sent * W2V_LEN,
               vocab=m.vocab.num_words(), words=cache.n_words,
               batches_per_epoch=cache.n_batches, batch=cache.batch,
               words_per_sec=cache.n_words / wall,
               epoch_ms=wall * 1e3, epoch_host_ms=host * 1e3,
               corpus_text_ms=corpus_ms, vocab_ms=vocab_ms,
               cache_build_ms=cache_ms, priced_bytes=cache.nbytes,
               replays=prog.graph.replays, captures=prog.graph.captures,
               loss_first_last=[float(hist[0, 0]), float(hist[0, -1])],
               cache=cache.describe())
    if EMBED_DEVICE != "cpu":
        out.update(memory_since(mark))
        gen = ek.epoch_generator(ek.epoch_keys_for(47, 5, 1)[0], "cuda")
        plan_s, _ = timed(lambda: cache.plan(gen, out=prog.plan))
        window = min(TEXT8_REPLAY_WINDOW, cache.n_batches)
        w_s, _ = timed(lambda: [prog.graph() for _ in range(window)])
        prof = profiled(lambda: [prog.graph() for _ in range(window)],
                        window)
        out.update(plan_ms=plan_s * 1e3,
                   epoch_less_plan_ms=(wall - plan_s) * 1e3,
                   ms_per_replay=w_s / window * 1e3,
                   device_busy_ms_per_replay=prof["device_busy_ms"],
                   device_idle_share=idle_share(prof, w_s / window * 1e3),
                   peak_over_priced=out["peak_mem_bytes"] / cache.nbytes)
    out["phase_s"] = time.monotonic() - t_phase
    print(f"embeddings e2 text8-scale word2vec d{W2V_CFG['layer_size']} "
          f"min_count {TEXT8_MIN_COUNT}: {json.dumps(out)} [{card}]")
    return out


def e3_glove(card: str, sentences) -> None:
    """GloVe on E1's corpus, the same per-epoch orders on both sides:
    replay against eager bitwise, card against CPU."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.nlp import CollectionSentenceIterator, Glove
    from deeplearning4j_tpu_torch.nlp.vocab import build_vocab

    def make(device):
        return Glove(CollectionSentenceIterator(sentences), device=device,
                     **GLOVE_CFG)

    probe = make("cpu")
    probe.vocab = build_vocab(probe._sentences_tokens(),
                              probe.min_word_frequency)
    n = len(probe.count_cooccurrences()[0])
    batch = min(probe.batch_size, max(32, n // 8))
    total = -(-n // batch) * batch
    rng = np.random.default_rng(3)
    orders = [rng.permutation(total) for _ in range(GLOVE_CFG["epochs"])]
    runs = {}
    for name, device, graphs in (("replayed", EMBED_DEVICE, True),
                                 ("eager", EMBED_DEVICE, False),
                                 ("cpu", "cpu", False)):
        with captured(graphs):
            g = make(device)
            _embed_sync()
            t0 = time.perf_counter()
            g.fit(_orders=orders)
            _embed_sync()
            runs[name] = (g, time.perf_counter() - t0)
    (g, tg), (e, te), (c, _) = runs["replayed"], runs["eager"], runs["cpu"]
    run = next(iter(g._runs.values()))
    bitwise = torch.equal(g.syn0, e.syn0) and torch.equal(g._history,
                                                          e._history)
    print(f"embeddings e3 glove [{n} triples, {run.n_batches} x {batch}] "
          f"d{GLOVE_CFG['layer_size']} x{GLOVE_CFG['epochs']}: fit_s "
          f"replayed {tg:.3f} eager {te:.3f}, replays {run.graph.replays}, "
          f"loss {g._loss:.6f}, replay_equals_eager={bitwise} [{card}]")
    if not bitwise:
        raise AssertionError("GloVe: the replayed fit differs from eager")
    _check_close("e3 glove (same orders)", (g.syn0, g._history),
                 (c.syn0, c._history), card)


def e3_sequences(card: str, ids) -> None:
    """SequenceVectors on E1's corpus as sequences, one epoch."""
    from deeplearning4j_tpu_torch.nlp import SequenceVectors

    seqs = [[f"e{t}" for t in row] for row in ids.tolist()]
    kw = dict(layer_size=W2V_CFG["layer_size"], window_size=5, negative=5,
              epochs=1, seed=8)
    ms = []
    for device in (EMBED_DEVICE, "cpu"):
        m = SequenceVectors(seqs, device=device, **kw)
        m.fit()
        ms.append(m)
    _check_close("e3 sequence_vectors", _w2v_state(ms[0]),
                 _w2v_state(ms[1]), card)


def e3_paragraphs(card: str, ids) -> None:
    """ParagraphVectors (PV-DBOW) on 200 labelled documents, 2 epochs;
    ``infer_vector`` and ``predict`` on the host from each side's tables."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.nlp import ParagraphVectors
    from deeplearning4j_tpu_torch.nlp.sentence_iterator import (
        LabelAwareSentenceIterator)

    docs = [" ".join(f"w{t % 500}" for t in row)
            for row in ids[:PV_DOCS].tolist()]
    labels = [f"L{i % 10}_{i}" for i in range(PV_DOCS)]
    kw = dict(min_word_frequency=1, layer_size=64, epochs=PV_EPOCHS,
              seed=9, learning_rate=0.05)
    ms = []
    for device in (EMBED_DEVICE, "cpu"):
        m = ParagraphVectors(sentence_iterator=LabelAwareSentenceIterator(
            docs, labels), device=device, **kw)
        m.fit()
        ms.append(m)
    _check_close("e3 paragraph_vectors", _w2v_state(ms[0]),
                 _w2v_state(ms[1]), card)
    text = docs[3]
    inferred = [torch.from_numpy(m.infer_vector(text)) for m in ms]
    _check_close("e3 paragraph_vectors infer_vector", inferred[:1],
                 inferred[1:], card)
    sims = [np.asarray([m.similarity_to_label(text, l) for l in labels])
            for m in ms]
    preds = [m.predict(text) for m in ms]
    top2 = np.sort(sims[1])[-2:]
    tie = top2[1] - top2[0] < EMBED_TOL["atol"]
    print(f"embeddings e3 paragraph_vectors predict card={preds[0]} "
          f"cpu={preds[1]} (top-2 gap {top2[1] - top2[0]:.3e}) [{card}]")
    if preds[0] != preds[1] and not tie:
        raise AssertionError(f"predict: card {preds[0]}, CPU {preds[1]}")


def e3_deepwalk(card: str) -> None:
    """DeepWalk (vector size 32) on a seeded 2000-vertex graph, walks of
    8, window 4, one epoch."""
    import numpy as np
    from deeplearning4j_tpu_torch.graph import (
        DeepWalk, Graph, RandomWalkIterator)

    rng = np.random.default_rng(10)
    g = Graph(DEEPWALK_VERTICES)
    for a in range(DEEPWALK_VERTICES):
        g.add_edge(a, (a + 1) % DEEPWALK_VERTICES)
        for b in rng.integers(0, DEEPWALK_VERTICES, 3):
            if int(b) != a:
                g.add_edge(a, int(b))
    ms = []
    for device in (EMBED_DEVICE, "cpu"):
        dw = (DeepWalk.Builder().vector_size(32)
              .window_size(DEEPWALK_WINDOW).seed(11).device(device).build())
        dw.initialize(g)
        dw.fit(RandomWalkIterator(g, DEEPWALK_WALK, seed=12))
        ms.append(dw)
    _check_close("e3 deepwalk", (ms[0].syn0, ms[0].syn1),
                 (ms[1].syn0, ms[1].syn1), card)


def embeddings(card: str) -> dict:
    """Phase 13; returns B1–B3's launches over it (all must be 0)."""
    import torch
    from deeplearning4j_tpu_torch.perf import step_graph

    step_graph.reset_kernel_launches()
    sentences, ids = zipf_corpus(W2V_SENTENCES, W2V_VOCAB)
    for part, args in ((e1_word2vec, (sentences,)),
                       (e1_parity, (sentences,)), (e2_text8, ()),
                       (e3_glove, (sentences,)), (e3_sequences, (ids,)),
                       (e3_paragraphs, (ids,)), (e3_deepwalk, ())):
        t0 = time.monotonic()
        part(card, *args)
        print(f"embeddings {part.__name__}: {time.monotonic() - t0:.1f} s")
        if EMBED_DEVICE != "cpu":
            torch.cuda.empty_cache()
    launches = step_graph.kernel_launches()
    if any(launches.values()):
        raise AssertionError(f"the embeddings phase launched a flash kernel:"
                             f" {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 14: trees, tagging, clustering and t-SNE
# ---------------------------------------------------------------------------
TREES_DEVICE = "cuda"  # "cpu" only to rehearse the phase
# T1, an SST-scale treebank: SST's split sizes (8,544 / 1,101 trees) and
# vocabulary (21,701 words); lengths clip(round(normal(19, 9)), 2, 56),
# tokens zipf(1.3) % vocabulary, random binary bracketing
SST_TRAIN, SST_DEV, SST_VOCAB = 8544, 1101, 21_701
SST_LEN = (19.0, 9.0, 2, 56)  # mean, sd, shortest, longest
RNTN_CFG = dict(num_hidden=25, num_classes=5, use_tensors=True,
                learning_rate=0.01, l2=1e-4, seed=123)  # the JAX defaults
RNTN_BATCH = 32
RNTN_PARITY_STEPS, RNTN_DET_STEPS, RNTN_PROFILE_STEPS = 3, 10, 10
RNTN_WARM_STEPS = 64
# T2, WSJ's scale: sections 02-21 (39,832 sentences, mean length 24) to fit
# and section 23 (2,416) to tag, drawn from a seeded 45-tag HMM over a
# 44,000-word zipf(1.3) vocabulary
WSJ_TRAIN, WSJ_TEST, WSJ_TAGS, WSJ_VOCAB = 39_832, 2_416, 45, 44_000
WSJ_LEN = (24.0, 11.0, 1, 120)
DECODE_T = 64  # decode_batch's padded length
PARSE_SENTENCES = 100
VITERBI_RTOL = 1e-5
# T3, k-means over a mixture of 100 Gaussians at phase 13's table shapes
KMEANS_K, KMEANS_ITERATIONS, KMEANS_DIM = 100, 100, 128
KMEANS_CELLS = (("euclidean", 69_849), ("cosine", 4_260),
                ("manhattan", 4_260))
KMEANS_PARITY_ITERATIONS, KMEANS_COST_RTOL, KMEANS_TIE = 5, 1e-4, 1e-5
# T4, exact t-SNE at the JAX defaults over bench_word2vec's vocabulary
TSNE_N, TSNE_DIM, TSNE_PERPLEXITY = 4_260, 128, 30.0
TSNE_PARITY_ITERATIONS, TSNE_KL_RTOL = 10, 0.05
TREES_TOL = dict(rtol=2e-3, atol=1e-3)  # the train phase's float32 gate


def _trees_sync() -> None:
    import torch

    if TREES_DEVICE != "cpu":
        torch.cuda.synchronize()


def _trees_timed(fn):
    """``(result, seconds)`` of ``fn()`` with the card synchronised on
    both sides."""
    _trees_sync()
    t0 = time.perf_counter()
    out = fn()
    _trees_sync()
    return out, time.perf_counter() - t0


def _lengths(rng, n: int, spec) -> list:
    import numpy as np

    mean, sd, lo, hi = spec
    return np.clip(np.rint(rng.normal(mean, sd, n)), lo, hi).astype(
        int).tolist()


def sst_strings(n: int, rng) -> list:
    """SST-format trees with a label on every node: a leaf takes its word
    id mod 5, an inner node the mean of its children's labels rounded
    half up, so the loss can fall."""

    def rec(ids, lo, hi):
        if hi - lo == 1:
            return f"({ids[lo] % 5} w{ids[lo]})", ids[lo] % 5
        split = int(rng.integers(lo + 1, hi))
        left, a = rec(ids, lo, split)
        right, b = rec(ids, split, hi)
        label = (a + b + 1) // 2
        return f"({label} {left} {right})", label

    return [rec((rng.zipf(1.3, n_words) % SST_VOCAB).tolist(), 0,
                n_words)[0] for n_words in _lengths(rng, n, SST_LEN)]


def _node_labels(tree) -> list:
    return [n.label for n in tree.binarize().post_order()]


def t1_rntn(card: str) -> dict:
    """T1: one epoch of ``fit`` at the JAX defaults on the SST-scale
    treebank, the step's launches and idle share, dev ``score`` and
    ``predict``."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models import RNTN
    from deeplearning4j_tpu_torch.nlp import Tree

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    train = Tree.parse_many("\n".join(sst_strings(SST_TRAIN, rng)))
    dev = Tree.parse_many("\n".join(sst_strings(SST_DEV, rng)))
    nodes = sum(t.num_nodes() for t in train)
    print(f"trees t1 treebank: {len(train)} train and {len(dev)} dev trees,"
          f" {nodes} train nodes, made and parsed in "
          f"{time.perf_counter() - t0:.2f} s")
    model = RNTN(**RNTN_CFG, device=TREES_DEVICE).init(train)
    steps = -(-len(train) // RNTN_BATCH)
    base = 0
    if TREES_DEVICE != "cpu":  # the peak above what earlier phases hold
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    _, wall = _trees_timed(lambda: model.fit(train, batch_size=RNTN_BATCH))
    peak = (torch.cuda.max_memory_allocated() - base
            if TREES_DEVICE != "cpu" else 0)
    losses = model.loss_history
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"rntn: {len(losses)} losses for {steps} steps"
                             f", finite={np.isfinite(losses).all()}")
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    print(f"trees t1 rntn fit: {steps} steps, {wall * 1e3 / steps:.3f} ms a "
          f"step, {len(train) / wall:.1f} trees/s, {nodes / wall:.0f} "
          f"nodes/s, loss first 20 {first:.4f} last 20 {last:.4f}, "
          f"peak_mem_bytes {peak} [{card}]")
    if not last < first:
        raise AssertionError(f"rntn: the loss did not fall ({first} -> "
                             f"{last})")
    # the epoch's first batches again, on a fresh model: the same shapes
    # a second time in the process
    again = RNTN(**RNTN_CFG, device=TREES_DEVICE).init(train)
    warm = train[:RNTN_WARM_STEPS * RNTN_BATCH]
    _, warm_s = _trees_timed(lambda: again.fit(warm, batch_size=RNTN_BATCH))
    print(f"trees t1 rntn fit again: the first {RNTN_WARM_STEPS} batches "
          f"{warm_s * 1e3 / RNTN_WARM_STEPS:.3f} ms a step, "
          f"{len(warm) / warm_s:.1f} trees/s [{card}]")
    # one step's parts over pre-planned batches: planning (host), the
    # step's time to return and to finish, launches and busy time
    batches = [train[i:i + RNTN_BATCH] for i in
               range(0, RNTN_PROFILE_STEPS * RNTN_BATCH, RNTN_BATCH)]
    plans, plan_s = _trees_timed(lambda: [model._plan(b) for b in batches])

    def run():
        for plan in plans:
            model._step(plan)

    _trees_sync()
    t0 = time.perf_counter()
    run()
    host = time.perf_counter() - t0
    _trees_sync()
    step_wall = time.perf_counter() - t0
    line = (f"trees t1 rntn step: plan {plan_s * 1e3 / len(plans):.3f} ms, "
            f"step {step_wall * 1e3 / len(plans):.3f} ms (host "
            f"{host * 1e3 / len(plans):.3f})")
    if TREES_DEVICE != "cpu":
        prof = profiled(run, len(plans))
        launches = sum(v for k, v in prof["host_launches"].items()
                       if "Launch" in k)
        line += (f", {launches:.1f} launches a step "
                 f"{prof['host_launches']}, busy "
                 f"{prof['device_busy_ms']:.3f} ms, idle share "
                 f"{idle_share(prof, step_wall * 1e3 / len(plans)):.3f}")
    print(f"{line} [{card}]")
    # dev: score, and predict over every node
    score, score_s = _trees_timed(lambda: model.score(dev))
    preds, pred_s = _trees_timed(lambda: [model.predict(t) for t in dev])
    gold = [_node_labels(t) for t in dev]
    flat_gold = np.concatenate(gold)
    hits = np.concatenate([p == np.asarray(g) for p, g in zip(preds, gold)])
    node_major = np.bincount(flat_gold).max() / flat_gold.size
    roots = np.asarray([g[-1] for g in gold])
    root_acc = float(np.mean([p[-1] == r for p, r in zip(preds, roots)]))
    root_major = np.bincount(roots).max() / roots.size
    print(f"trees t1 rntn dev: score {score:.4f} ({score_s * 1e3:.1f} ms), "
          f"node accuracy {hits.mean():.4f} (majority {node_major:.4f}), "
          f"root accuracy {root_acc:.4f} (majority {root_major:.4f}), "
          f"predict {pred_s * 1e3 / len(dev):.3f} ms a tree [{card}]")
    if not np.isfinite(score) or not hits.mean() > node_major:
        raise AssertionError(f"rntn: dev node accuracy {hits.mean()} not "
                             f"above the majority share {node_major}")
    return {"model": model, "train": train, "dev": dev}


def _rntn_grads(model, trees):
    import torch

    plan = model._plan(trees)
    leaves = {k: p.detach().requires_grad_(True)
              for k, p in model.params.items()}
    loss = model._loss(leaves, plan)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return [loss] + [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves.values(), grads)]


def _close(what: str, card_ts, host_ts, card: str, **tol) -> None:
    import torch

    tol = tol or TREES_TOL
    err = max(float((c.detach().cpu() - h.detach()).abs().max())
              for c, h in zip(card_ts, host_ts))
    ok = all(torch.allclose(c.detach().cpu(), h.detach(), **tol)
             for c, h in zip(card_ts, host_ts))
    print(f"trees parity {what}: max_abs_err {err:.3e} gate rtol "
          f"{tol['rtol']} atol {tol['atol']} ok={ok} [{card}]")
    if not ok:
        raise AssertionError(f"{what}: the card differs from the CPU")


def t1_parity(card: str, t1: dict) -> None:
    """The card against the CPU: one step's loss and gradients on the first
    batch, then params and AdaGrad state after 3 steps; two card runs of
    10 steps bitwise."""
    import torch
    from deeplearning4j_tpu_torch.models import RNTN

    train = t1["train"]
    pair = [RNTN(**RNTN_CFG, device=d).init(train)
            for d in (TREES_DEVICE, "cpu")]
    _close("t1 rntn step", *(_rntn_grads(m, train[:RNTN_BATCH])
                             for m in pair), card)
    for m in pair:
        m.fit(train[:RNTN_PARITY_STEPS * RNTN_BATCH], batch_size=RNTN_BATCH)
    names = list(pair[0].params)
    _close(f"t1 rntn {RNTN_PARITY_STEPS} steps",
           *([m.params[k] for k in names] + [m.updater_state[k]
                                             for k in names]
             for m in pair), card)
    runs = [RNTN(**RNTN_CFG, device=TREES_DEVICE).init(train)
            for _ in range(2)]
    for m in runs:
        m.fit(train[:RNTN_DET_STEPS * RNTN_BATCH], batch_size=RNTN_BATCH)
    same = all(torch.equal(runs[0].params[k], runs[1].params[k])
               and torch.equal(runs[0].updater_state[k],
                               runs[1].updater_state[k]) for k in names)
    print(f"trees t1 rntn determinism: two card runs of {RNTN_DET_STEPS} "
          f"steps bitwise equal={same} [{card}]")
    if not same:
        raise AssertionError("rntn: two card runs differ")


def wsj_hmm(rng):
    """A seeded 45-tag HMM: transitions from a sparse Dirichlet, and each
    tag's emissions Zipf(1.1)-ranked over its own words, 20 to 20,000 of
    the 44,000 (closed and open classes), so words are shared between
    tags. Returns the cdfs of the start, the transitions and the
    emissions, and each tag's words by rank."""
    import numpy as np

    trans = rng.dirichlet(np.full(WSJ_TAGS, 0.3), WSJ_TAGS)
    sizes = np.exp(rng.uniform(np.log(20), np.log(20_000), WSJ_TAGS))
    ranks = np.arange(1, WSJ_VOCAB + 1, dtype=np.float64)
    emit = np.where(ranks[None] <= sizes[:, None], ranks[None] ** -1.1, 0.0)
    return (np.cumsum(rng.dirichlet(np.ones(WSJ_TAGS))),
            np.cumsum(trans, axis=1),
            np.cumsum(emit / emit.sum(axis=1, keepdims=True), axis=1),
            np.stack([rng.permutation(WSJ_VOCAB) for _ in range(WSJ_TAGS)]))


def wsj_corpus(n: int, rng, hmm) -> list:
    """``n`` (word, tag) sentences drawn from the HMM ``hmm``."""
    import numpy as np

    init_cdf, trans_cdf, emit_cdf, perm = hmm
    lengths = _lengths(rng, n, WSJ_LEN)
    width = max(lengths)
    tags = np.empty((n, width), np.int64)
    last = WSJ_TAGS - 1  # a cdf's last entry may round below 1
    tags[:, 0] = np.minimum(np.searchsorted(init_cdf, rng.random(n),
                                            side="right"), last)
    for t in range(1, width):
        u = rng.random(n)
        tags[:, t] = np.minimum(np.sum(trans_cdf[tags[:, t - 1]]
                                       <= u[:, None], axis=1), last)
    u = rng.random((n, width))
    rank = np.empty((n, width), np.int64)
    for k in range(WSJ_TAGS):
        at = tags == k
        rank[at] = np.searchsorted(emit_cdf[k], u[at], side="right")
    words = perm[tags, np.minimum(rank, WSJ_VOCAB - 1)]
    # letters, not digits: the tagger files every unknown word with a
    # digit under one shape (*NUM*)
    names = ["".join(chr(97 + i // 26 ** k % 26) for k in range(4))
             for i in range(WSJ_VOCAB)]
    tag_names = [f"T{i}" for i in range(WSJ_TAGS)]
    return [[(names[w], tag_names[t]) for w, t in zip(ws[:k], ts[:k])]
            for ws, ts, k in zip(words.tolist(), tags.tolist(), lengths)]


def t2_tagging(card: str, t1: dict) -> dict:
    """T2: the tagger fitted at WSJ's scale tags section 23's sentences
    (one Viterbi decode each on the card), ``decode_batch`` once, the
    treebank parser over 100 raw dev sentences and T1's ``predict_root``
    on the parses."""
    import numpy as np
    from deeplearning4j_tpu_torch.nlp import HmmPosTagger, TreebankParser

    rng = np.random.default_rng(1)
    hmm = wsj_hmm(rng)
    t0 = time.perf_counter()
    fit_sents = wsj_corpus(WSJ_TRAIN, rng, hmm)
    test_sents = wsj_corpus(WSJ_TEST, rng, hmm)
    made = time.perf_counter() - t0
    tagger, fit_s = _trees_timed(
        lambda: HmmPosTagger(device=TREES_DEVICE).fit(fit_sents))
    tokens = [[w for w, _ in s] for s in test_sents]
    tagged, tag_s = _trees_timed(lambda: [tagger.tag_tokens(t)
                                          for t in tokens])
    gold = np.concatenate([[t for _, t in s] for s in test_sents])
    acc = float(np.mean(np.concatenate([[t for _, t in s] for s in tagged])
                        == gold))
    print(f"trees t2 tagger: corpus {sum(map(len, fit_sents))} tokens made in"
          f" {made:.2f} s, fit {fit_s:.2f} s, tag_tokens "
          f"{tag_s * 1e3 / len(tokens):.3f} ms a sentence over "
          f"{len(tokens)} ({gold.size} tokens), accuracy {acc:.4f} "
          f"[{card}]")
    padded = np.zeros((len(tokens), DECODE_T, WSJ_TAGS), np.float32)
    for i, sent in enumerate(tokens):
        e = tagger.emissions(sent[:DECODE_T])
        padded[i, :len(e)] = e
    batch, batch_s = _trees_timed(lambda: tagger._viterbi.decode_batch(
        padded))
    print(f"trees t2 decode_batch {list(padded.shape)}: "
          f"{batch_s * 1e3:.2f} ms [{card}]")
    parser, parse_fit_s = _trees_timed(
        lambda: TreebankParser().fit(t1["train"]))
    raw = [t.words() for t in t1["dev"][:PARSE_SENTENCES]]
    parses, parse_s = _trees_timed(lambda: [parser.parse_tokens(s)
                                            for s in raw])
    if any(p.words() != s for p, s in zip(parses, raw)):
        raise AssertionError("parser: a parse lost or reordered words")
    roots, root_s = _trees_timed(lambda: [t1["model"].predict_root(p)
                                          for p in parses])
    if not all(0 <= r < RNTN_CFG["num_classes"] for r in roots):
        raise AssertionError(f"predict_root gave {roots}")
    agree = np.mean([r == t.label for r, t in
                     zip(roots, t1["dev"][:PARSE_SENTENCES])])
    print(f"trees t2 parser: fit {parse_fit_s:.2f} s on {len(t1['train'])} "
          f"trees, {parse_s:.2f} s for {len(raw)} parses (CKY on the host), "
          f"predict_root on the parses {root_s * 1e3:.1f} ms, roots "
          f"{np.bincount(roots, minlength=5).tolist()}, agreeing with the "
          f"gold roots {agree:.3f} [{card}]")
    return {"tagger": tagger, "tokens": tokens, "tagged": tagged,
            "padded": padded, "batch": batch}


def t2_parity(card: str, t2: dict) -> None:
    """Viterbi on the card against the CPU: every sentence's decode and
    the padded ``decode_batch``."""
    import numpy as np
    from deeplearning4j_tpu_torch.nlp import HmmPosTagger

    tagger = t2["tagger"]
    cpu = HmmPosTagger.from_dict(tagger.to_dict(), device="cpu")
    differ, worst = 0, 0.0
    for sent, tagged in zip(t2["tokens"], t2["tagged"]):
        e = tagger.emissions(sent)
        path, score = tagger._viterbi.decode(e)
        want, want_score = cpu._viterbi.decode(e)
        differ += (not np.array_equal(path, want)
                   or [t for _, t in tagged] != [tagger.tags[s]
                                                for s in want])
        worst = max(worst, abs(score - want_score) / abs(want_score))
    paths, scores = t2["batch"]
    want_paths, want_scores = cpu._viterbi.decode_batch(t2["padded"])
    batch_differ = int(np.sum(np.any(paths != want_paths, axis=1)))
    batch_worst = float(np.max(np.abs(scores - want_scores)
                               / np.abs(want_scores)))
    print(f"trees parity t2 viterbi: {differ} of {len(t2['tokens'])} paths "
          f"differ, score rel err {worst:.3e}; decode_batch {batch_differ} "
          f"paths differ, score rel err {batch_worst:.3e} (gate "
          f"{VITERBI_RTOL}) [{card}]")
    if differ or batch_differ or max(worst, batch_worst) > VITERBI_RTOL:
        raise AssertionError("viterbi: the card differs from the CPU")


def kmeans_points(n: int, seed: int):
    """A seeded mixture of ``KMEANS_K`` Gaussians in ``KMEANS_DIM``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 3.0, (KMEANS_K, KMEANS_DIM))
    return (centers[rng.integers(KMEANS_K, size=n)]
            + rng.normal(0.0, 1.0, (n, KMEANS_DIM))).astype(np.float32)


def t3_kmeans(card: str) -> list:
    """T3: ``apply_to`` on the card for each distance's cell, twice
    (bitwise); ms an iteration and the iterations to converge."""
    import numpy as np
    from deeplearning4j_tpu_torch.clustering import KMeansClustering

    import torch
    from deeplearning4j_tpu_torch.clustering import kmeans

    cells = []
    for seed, (distance, n) in enumerate(KMEANS_CELLS):
        pts = kmeans_points(n, seed)
        km = KMeansClustering(KMEANS_K, KMEANS_ITERATIONS, distance,
                              device=TREES_DEVICE)
        init, init_s = _trees_timed(lambda: km._init_centroids(pts))
        runs = []
        for _ in range(2):
            cs, wall = _trees_timed(lambda: km.apply_to(pts))
            runs.append((cs, wall, km.iterations))
        (a, cold, iters), (b, wall, _) = runs
        same = (np.array_equal(a.assignments, b.assignments)
                and a.cost == b.cost
                and all(np.array_equal(x.center, y.center)
                        for x, y in zip(a.clusters, b.clusters)))
        # an iteration of apply_to's loop (the step, the assignments'
        # and the cost's readback) on the host clock, and the step alone
        # on the device (CUDA events)
        args = (torch.from_numpy(pts).to(TREES_DEVICE),
                torch.from_numpy(init).to(TREES_DEVICE), distance)

        def iteration():
            _, assign, cost = kmeans._kmeans_step(*args)
            return assign.cpu().numpy(), float(cost)

        iteration()
        _, iter_s = _trees_timed(lambda: [iteration() for _ in range(iters)])
        if TREES_DEVICE != "cpu":
            step_ms = cuda_ms(lambda: kmeans._kmeans_step(*args))
        else:
            step_ms = _trees_timed(lambda: kmeans._kmeans_step(*args))[1] * 1e3
        print(f"trees t3 kmeans {distance} [{n}, {KMEANS_DIM}] k "
              f"{KMEANS_K}: {iters} iterations, apply_to {wall:.3f} s "
              f"({cold:.3f} s cold), its k-means++ init {init_s:.2f} s "
              f"alone (host), {iter_s * 1e3 / iters:.3f} ms an iteration, "
              f"the step {step_ms:.3f} ms on the device, cost "
              f"{a.cost:.6g}, two card runs bitwise equal={same} [{card}]")
        if not same or not np.isfinite(a.cost):
            raise AssertionError(f"kmeans {distance}: two card runs differ")
        cells.append((distance, pts, init))
    return cells


def t3_parity(card: str, cells: list) -> None:
    """The card's first iterations against the CPU's from the same
    init: costs within 1e-4 relative, assignments equal except at points
    whose two nearest centroids are within 1e-5 relative."""
    import torch
    from deeplearning4j_tpu_torch.clustering import kmeans

    for distance, pts, init in cells:
        host_pts = torch.from_numpy(pts)
        card_pts = host_pts.to(TREES_DEVICE)
        c_card = torch.from_numpy(init).to(TREES_DEVICE)
        c_host = torch.from_numpy(init)
        for it in range(KMEANS_PARITY_ITERATIONS):
            near = torch.topk(kmeans._distances(host_pts, c_host, distance),
                              2, dim=1, largest=False).values
            ties = (near[:, 1] - near[:, 0]).abs() <= \
                KMEANS_TIE * near.abs().max(dim=1).values
            c_card, a_card, cost_card = kmeans._kmeans_step(
                card_pts, c_card, distance)
            c_host, a_host, cost_host = kmeans._kmeans_step(
                host_pts, c_host, distance)
            flipped = a_card.cpu() != a_host
            rel = abs(float(cost_card) - float(cost_host)) / abs(
                float(cost_host))
            outside = int((flipped & ~ties).sum())
            print(f"trees parity t3 kmeans {distance} iteration {it + 1}: "
                  f"cost rel err {rel:.3e} (gate {KMEANS_COST_RTOL}), "
                  f"{int(flipped.sum())} assignments differ, {outside} "
                  f"outside the {int(ties.sum())} near-ties [{card}]")
            if rel > KMEANS_COST_RTOL or outside:
                raise AssertionError(f"kmeans {distance}: the card differs "
                                     f"from the CPU")


def tsne_points():
    """bench_word2vec's vocabulary as a seeded table: 20 clusters."""
    import numpy as np

    rng = np.random.default_rng(2)
    centers = rng.normal(0.0, 1.0, (20, TSNE_DIM))
    return (centers[rng.integers(20, size=TSNE_N)]
            + rng.normal(0.0, 0.5, (TSNE_N, TSNE_DIM)))


def t4_tsne(card: str) -> dict:
    """T4: ``Tsne().fit_transform`` on the card at the JAX defaults, and
    the affinities alone on the host (the CPU run's input later)."""
    import numpy as np
    from deeplearning4j_tpu_torch.plot import Tsne
    from deeplearning4j_tpu_torch.plot.tsne import compute_gaussian_p

    x = tsne_points()
    tsne = Tsne(perplexity=TSNE_PERPLEXITY, device=TREES_DEVICE)
    y, wall = _trees_timed(lambda: tsne.fit_transform(x))
    kl = tsne.kl_history
    # readings every 50 iterations: [1] at 100, the exaggeration's last
    falls = kl[-1] < kl[2] < kl[1]
    # its two parts apart: the affinities (host) and the descent
    p, p_s = _trees_timed(lambda: compute_gaussian_p(x, TSNE_PERPLEXITY))
    again = Tsne(perplexity=TSNE_PERPLEXITY, device=TREES_DEVICE)
    _, descent_s = _trees_timed(lambda: again._descend(p))
    print(f"trees t4 tsne [{TSNE_N}, {TSNE_DIM}]: fit_transform {wall:.2f} "
          f"s, compute_gaussian_p {p_s:.2f} s (host), the descent "
          f"{descent_s * 1e3 / tsne.max_iter:.3f} ms an iteration over "
          f"{tsne.max_iter}, kl {[round(v, 4) for v in kl]} [{card}]")
    if y.shape != (TSNE_N, 2) or not np.isfinite(y).all() or not falls:
        raise AssertionError("tsne: the layout is not finite or the KL did "
                             "not fall after the exaggeration")
    return {"x": x, "p": p, "kl": kl}


def t4_parity_start(t4: dict):
    """Start the CPU's whole run (the KL gate's reference) in a thread;
    returns the thread and the dict it fills with ``kl`` or ``error``."""
    import threading
    from deeplearning4j_tpu_torch.plot import Tsne

    out = {}

    def run():
        try:
            cpu = Tsne(perplexity=TSNE_PERPLEXITY, device="cpu")
            cpu._descend(t4["p"])
            out["kl"] = cpu.kl_history
        except Exception as e:  # re-raised by t4_parity
            out["error"] = e

    thread = threading.Thread(target=run, name="cpu-tsne")
    thread.start()
    return thread, out


def t4_parity(card: str, t4: dict, thread, out) -> None:
    """The first iterations card against CPU, then the card's final KL
    against the CPU's whole run."""
    import torch
    from deeplearning4j_tpu_torch.plot import Tsne
    from deeplearning4j_tpu_torch.plot import tsne as tsne_mod

    pair = [Tsne(perplexity=TSNE_PERPLEXITY, device=d)
            for d in (TREES_DEVICE, "cpu")]
    states = [list(m._start(t4["p"])) for m in pair]
    for it in range(TSNE_PARITY_ITERATIONS):
        momentum, lying = pair[0]._hyper(it)
        for s in states:
            y, p, lied, gains, vel = s
            s[0], s[3], s[4], _ = tsne_mod._tsne_step(
                y, lied if lying else p, p, gains, vel, momentum,
                pair[0].learning_rate, with_kl=False)
    _close(f"t4 tsne first {TSNE_PARITY_ITERATIONS} iterations (y, gains, "
           f"velocity)", [states[0][i] for i in (0, 3, 4)],
           [states[1][i] for i in (0, 3, 4)], card)
    thread.join()
    if "error" in out:
        raise out["error"]
    card_kl, cpu_kl = t4["kl"][-1], out["kl"][-1]
    rel = abs(card_kl - cpu_kl) / abs(cpu_kl)
    print(f"trees parity t4 tsne final kl: card {card_kl:.5f} cpu "
          f"{cpu_kl:.5f} rel {rel:.4f} (gate {TSNE_KL_RTOL}) [{card}]")
    if rel > TSNE_KL_RTOL:
        raise AssertionError("tsne: the card's final KL is off the CPU's")


def trees(card: str) -> dict:
    """Phase 14; returns B1–B3's launches over it (all must be 0). The
    timed cells run first, alone; the parity checks then run beside the
    CPU's whole t-SNE run, which they wait for at the end."""
    import torch
    from deeplearning4j_tpu_torch.perf import step_graph

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    step_graph.reset_kernel_launches()
    t_phase = time.monotonic()
    state = {}
    for name, part in (("t1", t1_rntn), ("t2", t2_tagging),
                       ("t3", t3_kmeans), ("t4", t4_tsne)):
        t0 = time.monotonic()
        state[name] = (part(card, state["t1"]) if name == "t2"
                       else part(card))
        print(f"trees {part.__name__}: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    thread, out = t4_parity_start(state["t4"])
    try:
        t1_parity(card, state["t1"])
        t2_parity(card, state["t2"])
        t3_parity(card, state["t3"])
    finally:
        thread.join()
    t4_parity(card, state["t4"], thread, out)
    print(f"trees parity: {time.monotonic() - t0:.1f} s")
    launches = step_graph.kernel_launches()
    print(f"trees phase: {time.monotonic() - t_phase:.1f} s, B1-B3 launches "
          f"{launches} [{card}]")
    if any(launches.values()):
        raise AssertionError(f"the trees phase launched a flash kernel: "
                             f"{launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 15: training over a device mesh
# ---------------------------------------------------------------------------
MESH_RANKS = 4
MESH_STEPS = 3
MESH_JOIN_TIMEOUT_S = 180  # a collective that waits longer raises
MESH_WORLD_TIMEOUT_S = 480  # the 4-rank world; every rank killed past it
MESH_MLP_BATCH = 4096
MESH_SHAPE = (TRAIN_BATCH, TRAIN_T, 8, 64)  # the ring checks' whole q/k/v
MESH_WINDOW = 128
MESH_LM_TOL = {"loss": 2e-2, "params": 1e-2}  # mixed_bf16, the train gate
MESH_F32_TOL = dict(rtol=1e-4, atol=1e-6)
MESH_HOP_ITERS = 10
MESH_RUNNER = ("import sys; sys.path.insert(0, sys.argv[1]); "
               "import chip_smoke; chip_smoke.%s(int(sys.argv[2]), "
               "int(sys.argv[3]), sys.argv[4])")


def mesh_batches(n: int = MESH_STEPS, batch: int = MESH_MLP_BATCH):
    """``n`` seeded MNIST-shaped batches (features in [0, 1), one-hot
    labels over 10 classes) as host DataSets."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import DataSet

    rng = np.random.default_rng(0)
    return [DataSet(rng.random((batch, 784), np.float32),
                    np.eye(10, dtype=np.float32)[rng.integers(0, 10, batch)])
            for _ in range(n)]


def tree_err(a, b) -> float:
    """Largest |a − b| over two trees of one structure."""
    from deeplearning4j_tpu_torch.dtypes import tree_leaves

    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def tree_close(a, b, rtol: float, atol: float) -> bool:
    import torch
    from deeplearning4j_tpu_torch.dtypes import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.allclose(x.float(), y.float(), rtol=rtol, atol=atol)
        for x, y in zip(la, lb))


def tree_equal(a, b) -> bool:
    import torch
    from deeplearning4j_tpu_torch.dtypes import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def mesh_world_one(card: str, tmp: str) -> None:
    """An NCCL world of one rank: the LM's mesh step and ParallelWrapper
    (replicated and FSDP) against the meshless runs, bitwise."""
    import torch
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    from deeplearning4j_tpu_torch.parallel import (
        ParallelWrapper, build_mesh, join_world, leave_world)

    join_world(os.path.join(tmp, "nccl1"), 0, 1, backend="nccl",
               timeout_s=MESH_JOIN_TIMEOUT_S)
    try:
        mesh = build_mesh(device="cuda")
        backend = dist.get_backend()
        tok = torch.as_tensor(train_tokens(), device="cuda")
        runs = []
        for m, tp in ((None, False), (mesh, False), (mesh, True)):
            lm = TransformerLM(**TRAIN_CFG).init()
            if tp:   # a model axis of 1: nothing is split
                lm.shard_params(mesh)
            step = lm.make_train_step(mesh=m, sequence_parallel=m is not None
                                      and not tp)
            losses = torch.stack([lm.fit_batch(tok, train_step=step,
                                               block=False)
                                  for _ in range(MESH_STEPS)])
            runs.append((losses, lm.params, lm.opt_state, step.captured))
            del lm, step
        for i, what in ((1, "make_train_step(mesh, sequence_parallel=True)"),
                        (2, "shard_params(model=1) then "
                            "make_train_step(mesh)")):
            same = (torch.equal(runs[0][0], runs[i][0])
                    and tree_equal(runs[0][1:3], runs[i][1:3]))
            print(f"mesh world1 {backend} lm [{TRAIN_BATCH}, {TRAIN_T}] "
                  f"mixed_bf16 {what} {MESH_STEPS} steps: losses "
                  f"{[float(x) for x in runs[i][0]]}, captured "
                  f"{runs[i][3]}, bitwise the meshless step: {same} "
                  f"[{card}]")
            if not same or not runs[i][3]:
                raise AssertionError(f"the world-1 {what} differs from the "
                                     "meshless captured step")
        del runs
        torch.cuda.empty_cache()
        batches = mesh_batches()
        for fsdp in (False, True):
            a = build_network("mnist_mlp", "bf16", "cuda")
            b = build_network("mnist_mlp", "bf16", "cuda")
            ParallelWrapper(a, mesh=mesh, fsdp=fsdp).fit(batches)
            b.fit(batches)
            same = same_state(a, b)
            print(f"mesh world1 {backend} ParallelWrapper(fsdp={fsdp}) "
                  f"mnist_mlp bf16 [{MESH_MLP_BATCH}, 784] {MESH_STEPS} "
                  f"fits: bitwise net.fit: {same} [{card}]")
            if not same:
                raise AssertionError(f"ParallelWrapper(fsdp={fsdp}) on a "
                                     "world of one differs from net.fit")
    finally:
        leave_world()


MESH_PROBE_OPS = ("all_reduce", "broadcast", "all_gather",
                  "all_to_all_single", "all_to_all_single uneven",
                  "isend/irecv")


def mesh_probe_rank(rank: int, n: int, tmp: str) -> None:
    """One rank of the probe world: each gloo collective of CUDA tensors
    in turn, its start and outcome appended to ``probe<r>.jsonl``. gloo
    may abort the process on a CUDA pointer it treats as host memory;
    the last started op then has no outcome, and the parent reports it."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    sys.path.insert(0, HERE)
    from deeplearning4j_tpu_torch.parallel import join_world, leave_world

    join_world(os.path.join(tmp, "probe_store"), rank, n, backend="gloo",
               timeout_s=60)
    me = dist.get_rank()
    x = torch.full((4,), float(me + 1), device="cuda")

    def uneven():
        send = [0] * n
        recv = [0] * n
        send[(me - 1) % n], recv[(me + 1) % n] = 4, 4
        out = torch.empty(4, device="cuda")
        dist.all_to_all_single(out, x.clone(), recv, send)
        return float(out[0]) == float((me + 1) % n + 1)

    def p2p():
        out = torch.empty(4, device="cuda")
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x.clone(), (me - 1) % n),
            dist.P2POp(dist.irecv, out, (me + 1) % n)])
        for r in reqs:
            r.wait()
        return float(out[0]) == float((me + 1) % n + 1)

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return float(y[0]) == n * (n + 1) / 2

    def broadcast():
        y = x.clone()
        dist.broadcast(y, src=0)
        return float(y[0]) == 1.0

    def all_gather():
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x)
        return [float(p[0]) for p in parts] == [float(i + 1)
                                                for i in range(n)]

    def even():
        y = torch.arange(n, dtype=torch.float32, device="cuda") + 10 * me
        out = torch.empty_like(y)
        dist.all_to_all_single(out, y)
        return [float(v) for v in out] == [10.0 * i + me for i in range(n)]

    fns = dict(zip(MESH_PROBE_OPS, (all_reduce, broadcast, all_gather, even,
                                    uneven, p2p)))
    with open(os.path.join(tmp, f"probe{rank}.jsonl"), "a") as log:
        for name in MESH_PROBE_OPS:
            log.write(json.dumps({"op": name, "state": "start"}) + "\n")
            log.flush()
            try:
                state = "carries" if fns[name]() else "wrong values"
                torch.cuda.synchronize()
            except Exception as e:  # the probe reports what gloo refuses
                state = f"refused ({type(e).__name__}: {str(e)[:60]})"
            log.write(json.dumps({"op": name, "state": state}) + "\n")
            log.flush()
            dist.barrier()
    leave_world()


def mesh_probe(tmp: str) -> dict:
    """Which gloo collectives carry CUDA tensors on this machine, from a
    world of its own (an op that aborts the process ends only that
    world)."""
    spawn_world("mesh_probe_rank", tmp, 120)
    found = {}
    path = os.path.join(tmp, "probe0.jsonl")
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                entry = json.loads(line)
                found[entry["op"]] = entry["state"]
    for name in MESH_PROBE_OPS:
        if found.get(name) == "start":
            found[name] = "aborted the process (gloo read device memory " \
                          "as host memory)"
        elif name not in found:
            found[name] = "not probed (an earlier op ended the world)"
    return found


def spawn_world(fn: str, tmp: str, timeout_s: float) -> list:
    """Run ``chip_smoke.<fn>(rank, MESH_RANKS, tmp)`` in MESH_RANKS
    processes; every one is killed past ``timeout_s`` or as soon as one
    fails. Returns the exit codes."""
    procs, logs = [], []
    for r in range(MESH_RANKS):
        log = open(os.path.join(tmp, f"{fn}{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", MESH_RUNNER % fn, HERE, str(r),
             str(MESH_RANKS), tmp], stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    return [p.returncode for p in procs]


def mesh_local(x, rank: int, n: int):
    t = x.shape[1] // n
    return x[:, rank * t:(rank + 1) * t].contiguous()


def mesh_ring_checks(rank: int, n: int, seq) -> list:
    """The flash ring (B1 per hop forward, B2 + B3 per hop backward) on
    this rank's shard against B1/B2/B3 on the whole tensors."""
    import torch
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.parallel.ring_attention import (
        ring_attention, ring_flash_forward)

    out = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for causal, window in ((True, None), (False, None),
                               (True, MESH_WINDOW)):
            gen = torch.Generator(device="cuda").manual_seed(
                len(out) + 100)
            q, k, v, do = (torch.randn(MESH_SHAPE, generator=gen,
                                       device="cuda").to(dtype)
                           for _ in range(4))
            kw = dict(causal=causal, window=window)
            ref_out, ref_lse = fa.flash_attention_fwd(q, k, v, **kw)
            ref_dq, ref_dk, ref_dv = fa.flash_attention_bwd(
                q, k, v, ref_out, ref_lse, do, **kw)
            ql, kl, vl, dol = (mesh_local(x, rank, n) for x in (q, k, v, do))
            o, lse = ring_flash_forward(ql, kl, vl, seq, **kw)
            t = MESH_SHAPE[1] // n
            sl = slice(rank * t, (rank + 1) * t)
            fwd_err = max(
                float((o.float() - ref_out[:, sl].float()).abs().max()),
                float((lse - ref_lse[:, :, sl]).abs().max()))
            qg, kg, vg = (x.clone().requires_grad_() for x in (ql, kl, vl))
            ring_attention(qg, kg, vg, seq, impl="flash", **kw).backward(dol)
            bwd_err = max(float((g.grad.float() - r[:, sl].float()).abs()
                                .max()) for g, r in ((qg, ref_dq),
                                                     (kg, ref_dk),
                                                     (vg, ref_dv)))
            fwd_tol = TOL[name]
            bwd_tol = BWD_TOL[name]
            entry = {"dtype": name, "causal": causal, "window": window,
                     "fwd_err": fwd_err, "bwd_err": bwd_err,
                     "ok": fwd_err <= fwd_tol and bwd_err <= bwd_tol}
            if dtype == torch.bfloat16:
                # the ring rounds each hop's output to bf16 before the f32
                # merge (the reference's design), so its out and delta
                # carry one rounding more than the single-device kernel's:
                # bf16 gradients are held against the f32 oracle, allowed
                # the single-device kernels' own error there plus 2e-2
                # both against the f32 oracle on the same bf16 inputs
                f32 = [x.float() for x in (q, k, v, do)]
                o32, l32 = fa.flash_attention_fwd_reference(*f32[:3], **kw)
                oracle = fa.flash_backward(f32[0], f32[1], f32[2], o32, l32,
                                           f32[3], precise=True, **kw)
                entry["ring_vs_oracle"] = max(
                    float((g.grad.float() - r[:, sl]).abs().max())
                    for g, r in ((qg, oracle[0]), (kg, oracle[1]),
                                 (vg, oracle[2])))
                entry["kernel_vs_oracle"] = max(
                    float((a[:, sl].float() - r[:, sl]).abs().max())
                    for a, r in ((ref_dq, oracle[0]), (ref_dk, oracle[1]),
                                 (ref_dv, oracle[2])))
                entry["grad_scale"] = max(float(r.abs().max())
                                          for r in oracle)
                entry["ok"] = fwd_err <= fwd_tol and (
                    entry["ring_vs_oracle"]
                    <= entry["kernel_vs_oracle"] + bwd_tol)
                del oracle, o32, l32, f32
            out.append(entry)
    return out


def mesh_hop_transport(seq) -> dict:
    """Host-clock ms of one K/V rotation (the forward's hop: k and v in
    bf16) and of the backward's (k, v and the f32 dk, dv), at the ring
    shape's local block."""
    import torch
    from deeplearning4j_tpu_torch.parallel.collectives import rotate
    from deeplearning4j_tpu_torch.parallel.mesh import axis_group

    b, t, h, d = MESH_SHAPE
    local = (b, t // MESH_RANKS, h, d)
    g = axis_group(seq, "sequence")
    kv = [torch.randn(local, device="cuda").to(torch.bfloat16)
          for _ in range(2)]
    grads = [torch.randn(local, device="cuda") for _ in range(2)]
    res = {}
    for name, ts in (("fwd", kv), ("bwd", kv + grads)):
        rotate(ts, g, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MESH_HOP_ITERS):
            rotate(ts, g, 1)
        torch.cuda.synchronize()
        res[name] = {"ms": (time.perf_counter() - t0) * 1e3 / MESH_HOP_ITERS,
                     "bytes": sum(x.numel() * x.element_size() for x in ts)}
    return res


def mesh_ulysses(rank: int, n: int, seq) -> dict:
    """Ulysses (two all-to-alls around plain attention) against the plain
    path on the whole tensors, bf16."""
    import torch
    from deeplearning4j_tpu_torch.ops.attention import dot_product_attention
    from deeplearning4j_tpu_torch.parallel.ulysses import ulysses_attention

    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn(MESH_SHAPE, generator=gen,
                           device="cuda").to(torch.bfloat16)
               for _ in range(3))
    with torch.no_grad():
        ref = dot_product_attention(q, k, v, causal=True)
        got = ulysses_attention(*(mesh_local(x, rank, n) for x in (q, k, v)),
                                seq, causal=True)
    err = float((got.float() - mesh_local(ref, rank, n).float()).abs().max())
    return {"err": err, "ok": err <= TOL["bfloat16"]}


def mesh_lm(rank: int, n: int, seq) -> dict:
    """The d512·L8 LM's sequence-parallel step over ``sequence=n``, ring
    (B1–B3 per hop) and Ulysses, 3 steps each from the same init; rank 0
    holds both against the single-device step."""
    import torch
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    from deeplearning4j_tpu_torch.perf import step_graph

    tok = torch.as_tensor(train_tokens(), device="cuda")
    res, states = {}, {}
    for impl in ("ring", "ulysses"):
        lm = TransformerLM(**TRAIN_CFG, sp_impl=impl).init()
        step = lm.make_train_step(mesh=seq, sequence_parallel=True)
        losses, per_step, ms = [], [], []
        for _ in range(MESH_STEPS):
            dist.barrier()
            torch.cuda.synchronize()
            before = step_graph.kernel_launches()
            t0 = time.perf_counter()
            losses.append(lm.fit_batch(tok, train_step=step))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            per_step.append({k: v - before[k] for k, v in
                             step_graph.kernel_launches().items()})
        res[impl] = {"losses": losses, "ms": ms, "launches": per_step,
                     "captured": step.captured}
        states[impl] = lm.params
        del lm, step
    if rank == 0:
        ref = TransformerLM(**TRAIN_CFG).init()
        ref_losses = [ref.fit_batch(tok) for _ in range(MESH_STEPS)]
        for impl in ("ring", "ulysses"):
            loss_err = max(abs(a - b) for a, b in
                           zip(res[impl]["losses"], ref_losses))
            param_err = tree_err(states[impl], ref.params)
            res[impl].update(ref_losses=ref_losses, loss_err=loss_err,
                             param_err=param_err,
                             ok=loss_err <= MESH_LM_TOL["loss"]
                             and param_err <= MESH_LM_TOL["params"])
    return res


def mesh_dp(rank: int, n: int, data) -> dict:
    """ParallelWrapper over ``data=n`` (replicated and FSDP) fitting the
    MNIST MLP in float32 against single-device ``fit`` on the global
    batches (rank 0 holds the gate)."""
    import torch
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.dtypes import tree_leaves
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    batches = mesh_batches()
    res = {}
    ref = None
    if rank == 0:
        ref = build_network("mnist_mlp", "float32", "cuda")
        ref.fit(batches)
    for fsdp in (False, True):
        net = build_network("mnist_mlp", "float32", "cuda")
        w = ParallelWrapper(net, mesh=data, fsdp=fsdp)
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w.fit(batches)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / len(batches)
        params, upd = w.gather()
        entry = {"ms_per_fit": ms,
                 "param_numel_this_rank": sum(
                     x.numel() for x in tree_leaves(net.params))}
        if ref is not None:
            entry["err"] = max(tree_err(params, ref.params),
                               tree_err(upd, ref.updater_state))
            entry["ok"] = tree_close((params, upd),
                                     (ref.params, ref.updater_state),
                                     **MESH_F32_TOL)
        res["fsdp" if fsdp else "replicated"] = entry
    return res


def mesh_rank(rank: int, n: int, tmp: str) -> None:
    """One rank of the 4-process gloo world that shares the card; writes
    its results to ``rank<r>.json`` in ``tmp``."""
    import torch

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, HERE)
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel import (
        MeshSpec, build_mesh, join_world, leave_world)
    from deeplearning4j_tpu_torch.parallel.mesh import axis_group

    out = {"rank": rank}
    t0 = time.monotonic()
    join_world(os.path.join(tmp, "store"), rank, n, backend="gloo",
               timeout_s=MESH_JOIN_TIMEOUT_S)
    out["join_s"] = time.monotonic() - t0
    try:
        seq = build_mesh(MeshSpec(data=1, sequence=n), device="cuda")
        data = build_mesh(MeshSpec(data=n), device="cuda")
        out["backend"] = dist.get_backend(axis_group(seq, "sequence"))
        for name, fn in (("ring", lambda: mesh_ring_checks(rank, n, seq)),
                         ("hop", lambda: mesh_hop_transport(seq)),
                         ("ulysses", lambda: mesh_ulysses(rank, n, seq)),
                         ("lm", lambda: mesh_lm(rank, n, seq)),
                         ("dp", lambda: mesh_dp(rank, n, data))):
            t = time.monotonic()
            out[name] = fn()
            out[f"{name}_s"] = time.monotonic() - t
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    except Exception:
        out["error"] = traceback.format_exc()
    finally:
        leave_world()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    if "error" in out:
        sys.exit(1)


def mesh_world(card: str, tmp: str) -> list:
    """Spawn the 4-rank gloo world on the card and wait for it (every
    rank killed past ``MESH_WORLD_TIMEOUT_S``); returns the ranks'
    results."""
    codes = spawn_world("mesh_rank", tmp, MESH_WORLD_TIMEOUT_S)
    bad = [r for r, c in enumerate(codes) if c != 0]
    if bad:
        for r in bad:
            with open(os.path.join(tmp, f"mesh_rank{r}.log")) as f:
                print(f"mesh rank {r} exited {codes[r]}:\n"
                      f"{f.read()[-3000:]}", file=sys.stderr)
        raise AssertionError(f"mesh world: rank(s) {bad} failed or timed "
                             f"out ({MESH_WORLD_TIMEOUT_S} s)")
    out = []
    for r in range(MESH_RANKS):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def mesh_hop_kernels(card: str) -> None:
    """B1/B2/B3 at one ring hop's shape (full and diagonal) beside the
    single-device kernel at the same whole shape, CUDA events."""
    import torch
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa

    b, t, h, d = MESH_SHAPE
    tl = t // MESH_RANKS
    gen = torch.Generator(device="cuda").manual_seed(3)
    times = {}
    for label, tq, causal in (("hop full", tl, False), ("hop diag", tl, True),
                              ("single device", t, True)):
        q, k, v, do = (torch.randn((b, tq, h, d), generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        delta = fa._delta(out, do)
        row = {
            "fwd": cuda_ms(lambda: fa.flash_attention_fwd(q, k, v,
                                                          causal=causal)),
            "dkdv": cuda_ms(lambda: fa.flash_attention_bwd_dkdv(
                q, k, v, do, lse, delta, causal=causal)),
            "dq": cuda_ms(lambda: fa.flash_attention_bwd_dq(
                q, k, v, do, lse, delta, causal=causal))}
        bound = fa.flash_bound(b, tq, tq, h, d, torch.bfloat16,
                               causal=causal)
        bwd = fa.flash_bwd_bound(b, tq, tq, h, d, torch.bfloat16,
                                 causal=causal)
        times[label] = row
        print(f"mesh kernels {label} bf16 [{b}, {tq}, {h}, {d}] "
              f"causal={causal}: B1 {row['fwd']:.5f} ms (bound "
              f"{bound['bound_ms']:.5f}), B2 {row['dkdv']:.5f} ms (bound "
              f"{bwd['dkdv']['bound_ms']:.5f}), B3 {row['dq']:.5f} ms "
              f"(bound {bwd['dq']['bound_ms']:.5f}) [{card}]")
    for k in ("fwd", "dkdv", "dq"):
        busiest = 3 * times["hop full"][k] + times["hop diag"][k]
        total = 6 * times["hop full"][k] + 4 * times["hop diag"][k]
        print(f"mesh kernels {k}: the ring's hops at {MESH_RANKS} ranks sum "
              f"to {total:.5f} ms (busiest rank {busiest:.5f} ms) against "
              f"the single-device kernel's {times['single device'][k]:.5f} "
              f"ms over the same whole shape [{card}]")


def mean_trees(trees):
    """The leafwise mean of trees of one structure."""
    from deeplearning4j_tpu_torch.dtypes import tree_leaves
    from deeplearning4j_tpu_torch.parallel.sharding_registry import _rebuild

    leaves = [tree_leaves(t) for t in trees]
    return _rebuild(trees[0], [sum(xs) / len(xs) for xs in zip(*leaves)])


def mesh_averaging(card: str) -> None:
    """ParameterAveragingTrainer with 4 replicas on the one card (no
    process group) against its plain version: 4 clones stepped on their
    quarters and averaged, every step."""
    import torch
    from deeplearning4j_tpu_torch.parallel import ParameterAveragingTrainer

    batches = mesh_batches()
    net = build_network("mnist_mlp", "float32", "cuda")
    plain = build_network("mnist_mlp", "float32", "cuda")
    # the first vmap of the step pays torch.func's one-time set-up
    ParameterAveragingTrainer(net.clone(), num_replicas=MESH_RANKS).fit(
        batches[:1])
    trainer = ParameterAveragingTrainer(net, num_replicas=MESH_RANKS,
                                        averaging_frequency=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.fit(batches)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    q = MESH_MLP_BATCH // MESH_RANKS
    from deeplearning4j_tpu_torch.datasets import DataSet

    for ds in batches:
        reps = []
        for r in range(MESH_RANKS):
            c = plain.clone()
            c.fit(DataSet(ds.features[r * q:(r + 1) * q],
                          ds.labels[r * q:(r + 1) * q]))
            reps.append(c)
        plain.params = mean_trees([c.params for c in reps])
        plain.updater_state = mean_trees([c.updater_state for c in reps])
        plain.iteration_count += 1
    err = max(tree_err(net.params, plain.params),
              tree_err(net.updater_state, plain.updater_state))
    ok = tree_close((net.params, net.updater_state),
                    (plain.params, plain.updater_state), **MESH_F32_TOL)
    print(f"mesh averaging ParameterAveragingTrainer({MESH_RANKS} replicas, "
          f"one card, no process group) mnist_mlp float32 "
          f"[{MESH_MLP_BATCH}, 784]: {ms:.3f} ms per fit, against 4 clones "
          f"averaged max_abs_err={err:.3e} (rtol 1e-4, atol 1e-6) "
          f"{'ok' if ok else 'MISMATCH'} [{card}]")
    if not ok:
        raise AssertionError("ParameterAveragingTrainer disagrees with its "
                             "plain version")


def mesh_phase(card: str) -> dict:
    """Phase 15; returns B1–B3's launches over the 4-rank world's ring
    steps, summed over the ranks."""
    import tempfile

    import torch
    from deeplearning4j_tpu_torch.parallel.ring_attention import hop_schedule

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="dl4j_mesh_") as tmp:
        t0 = time.monotonic()
        mesh_world_one(card, tmp)
        print(f"mesh world1: {time.monotonic() - t0:.1f} s")
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        probe = mesh_probe(tmp)
        print(f"mesh probe world: {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        ranks = mesh_world(card, tmp)
        print(f"mesh world{MESH_RANKS} (gloo, one card): "
              f"{time.monotonic() - t0:.1f} s; per rank join "
              + ", ".join(f"{r['join_s']:.1f}" for r in ranks) + " s, ring "
              + ", ".join(f"{r['ring_s']:.1f}" for r in ranks) + " s, lm "
              + ", ".join(f"{r['lm_s']:.1f}" for r in ranks) + " s, dp "
              + ", ".join(f"{r['dp_s']:.1f}" for r in ranks) + " s")
    r0 = ranks[0]
    print(f"mesh probe: gloo with CUDA tensors: {probe}; the K/V "
          f"rotation over the sequence group: {r0['backend']} "
          f"all_to_all_single of CUDA tensors, one non-empty split each "
          f"way [{card}]")
    needed = ("all_reduce", "all_gather", "all_to_all_single uneven")
    if any(probe[op] != "carries" for op in needed):
        raise AssertionError(f"gloo does not carry the collectives the "
                             f"mesh uses on CUDA tensors: {probe}")
    failures = []
    for i, case in enumerate(r0["ring"]):
        fwd = max(r["ring"][i]["fwd_err"] for r in ranks)
        bwd = max(r["ring"][i]["bwd_err"] for r in ranks)
        ok = all(r["ring"][i]["ok"] for r in ranks)
        print(f"mesh ring flash {case['dtype']} causal={case['causal']} "
              f"window={case['window']} {list(MESH_SHAPE)} over "
              f"sequence={MESH_RANKS}: out/lse max_abs_err={fwd:.3e} (tol "
              f"{TOL[case['dtype']]:.0e}), dq/dk/dv max_abs_err={bwd:.3e} "
              f"(f32 tol {BWD_TOL['float32']:.0e}; bf16 gated below) "
              f"against B1/B2/B3 on the whole tensors "
              f"{'ok' if ok else 'MISMATCH'} [{card}]")
        if "ring_vs_oracle" in case:
            print(f"mesh ring flash bf16 causal={case['causal']} window="
                  f"{case['window']} gradients against the f32 oracle on the "
                  f"same bf16 inputs: ring "
                  f"{max(r['ring'][i]['ring_vs_oracle'] for r in ranks):.3e}"
                  f", single-device B2/B3 "
                  f"{max(r['ring'][i]['kernel_vs_oracle'] for r in ranks):.3e}"
                  f" (gate: the ring within the single-device error + "
                  f"{BWD_TOL['bfloat16']:.0e}), largest gradient "
                  f"{max(r['ring'][i]['grad_scale'] for r in ranks):.3f} "
                  f"{'ok' if ok else 'MISMATCH'} [{card}]")
        if not ok:
            failures.append(f"ring {case}")
    for name in ("fwd", "bwd"):
        per = [r["hop"][name]["ms"] for r in ranks]
        print(f"mesh transport {name} hop ({r0['hop'][name]['bytes']} bytes "
              f"a rank, gloo all_to_all_single): "
              f"{', '.join(f'{x:.3f}' for x in per)} ms per rank [{card}]")
    uly = max(r["ulysses"]["err"] for r in ranks)
    print(f"mesh ulysses bf16 causal {list(MESH_SHAPE)} over "
          f"sequence={MESH_RANKS}: max_abs_err={uly:.3e} against the plain "
          f"path (tol {TOL['bfloat16']:.0e}) [{card}]")
    if not all(r["ulysses"]["ok"] for r in ranks):
        failures.append("ulysses")
    layers = TRAIN_CFG["num_layers"]
    hops = hop_schedule(MESH_RANKS, causal=True)
    launches = {}
    for impl in ("ring", "ulysses"):
        lm = r0["lm"][impl]
        per_step = [{k: sum(r["lm"][impl]["launches"][s][k] for r in ranks)
                     for k in lm["launches"][0]} for s in range(MESH_STEPS)]
        ms = [max(r["lm"][impl]["ms"][s] for r in ranks)
              for s in range(MESH_STEPS)]
        print(f"mesh lm {impl} [{TRAIN_BATCH}, {TRAIN_T}] mixed_bf16 over "
              f"sequence={MESH_RANKS} (t_local {TRAIN_T // MESH_RANKS}): "
              f"losses {lm['losses']} vs single device "
              f"{lm['ref_losses']}: loss_err={lm['loss_err']:.3e} (tol "
              f"{MESH_LM_TOL['loss']}), param_err={lm['param_err']:.3e} "
              f"(tol {MESH_LM_TOL['params']}); ms per step "
              f"{[round(x, 1) for x in ms]}; captured {lm['captured']}; "
              f"B1-B3 launches per step over the ranks {per_step} [{card}]")
        if not lm["ok"] or lm["captured"]:
            failures.append(f"lm {impl}")
        want = layers * hops if impl == "ring" else 0
        if any(n != want for s in per_step for n in s.values()):
            failures.append(f"lm {impl} launched {per_step}, expected "
                            f"{want} of each a step")
        if impl == "ring":
            launches = {k: sum(s[k] for s in per_step)
                        for k in per_step[0]}
    for kind in ("replicated", "fsdp"):
        dp = r0["dp"][kind]
        numel = [r["dp"][kind]["param_numel_this_rank"] for r in ranks]
        ms = max(r["dp"][kind]["ms_per_fit"] for r in ranks)
        print(f"mesh dp ParallelWrapper({kind}) mnist_mlp float32 "
              f"[{MESH_MLP_BATCH}, 784] over data={MESH_RANKS}: "
              f"{MESH_STEPS} fits against single-device fit "
              f"max_abs_err={dp['err']:.3e} (rtol 1e-4, atol 1e-6) "
              f"{'ok' if dp['ok'] else 'MISMATCH'}; {ms:.2f} ms per fit; "
              f"params held per rank {numel} [{card}]")
        if not dp["ok"]:
            failures.append(f"dp {kind}")
    print("mesh peak_mem_bytes per rank "
          f"{[r['peak_mem_bytes'] for r in ranks]} [{card}]")
    if failures:
        raise AssertionError("mesh: " + "; ".join(failures))
    mesh_hop_kernels(card)
    mesh_averaging(card)
    print(f"mesh phase: {time.monotonic() - t_phase:.1f} s, B1-B3 launches "
          f"over the ring steps {launches} [{card}]")
    return launches


# ---------------------------------------------------------------------------
# phase 16: the model, pipe and expert axes
# ---------------------------------------------------------------------------
MODEL_WORLD_TIMEOUT_S = 420  # the 4-rank world; every rank killed past it
MODEL_STEPS = 3
MODEL_BEAM_NEW = 16
PIPE_STAGES, PIPE_MICRO, PIPE_ROWS = 4, 8, 2  # 4 stages of 2 blocks
MOE_CFG = dict(d_model=512, d_ff=2048, n_experts=8, top_k=2,
               capacity_factor=1.25)
MOE_SHAPE = (4, 1024, 512)
MOE_TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_BF16_TOL = 2e-2  # outputs and gradients, of each tensor's largest
MODEL_KERNEL_SHAPES = ((16, 1024, 2, 64), (8, 1024, 4, 64))  # per rank
# cells (f) and (g): the MNIST MLP (the zoo's widths, seed and lr) on
# SGD: Adam's step hardly moves when its gradient is scaled, so it would
# hide a wrong norm. At the zoo's lr a split run sits well inside the
# float32 gate while a norm left unreduced over model lands far outside
# it; at lr 0.1 every data or model layout (FSDP alone too) crosses the
# gate with no normalization at all: its sums round in another order
# and SGD steps of 0.1 carry that past atol 1e-6
# (scripts/torch_split_norm_witness.py). The threshold lies below the
# first step's layer norms (1.6-2.4) and its weights' and above its
# biases' (0.17-0.20): the per-layer clips engage everywhere, the
# per-leaf ones on the weights only
MODEL_L2_MODES = ("RenormalizeL2PerLayer", "ClipL2PerLayer",
                  "RenormalizeL2PerParamType", "ClipL2PerParamType")
MODEL_L2_LR = 1e-3
MODEL_L2_THRESHOLD = 0.5
MODEL_FSDP_EPOCHS = 2  # (g): bench_epoch's epochs after its 3 fits
# cell (h): the serve cell's requests through a split fleet of TP
# replicas; d0 decodes this many steps before it drains onto d1
FLEET_DRAIN_AFTER = 4
FLEET_HANDOFF_REPS = 5  # timed exports and installs of one slot


def _launch_delta(before) -> dict:
    from deeplearning4j_tpu_torch.perf import step_graph

    return {k: v - before[k] for k, v in
            step_graph.kernel_launches().items()}


def _timed_barrier(fn):
    """``fn()`` after a barrier, its wall ms and the B1–B3 launches it
    made in this rank."""
    import torch
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.perf import step_graph

    dist.barrier()
    torch.cuda.synchronize()
    before = step_graph.kernel_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, _launch_delta(before)


def _local_numel(tree) -> int:
    from deeplearning4j_tpu_torch.dtypes import tree_leaves

    return sum(x.numel() for x in tree_leaves(tree))


def model_tp_train(rank: int, meshes: dict) -> dict:
    """Cell (a): the Train cell's LM over ``model=4`` and ``data=2 x
    model=2``, 3 steps from the same init; rank 0 holds both against the
    single-device step."""
    import torch
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM

    tok = torch.as_tensor(train_tokens(), device="cuda")
    res, states = {}, {}
    for name in ("model=4", "data=2 x model=2"):
        mesh = meshes[name]
        lm = TransformerLM(**TRAIN_CFG).init()
        lm.shard_params(mesh)
        step = lm.make_train_step(mesh=mesh)
        losses, ms, launches = [], [], []
        for _ in range(MODEL_STEPS):
            loss, t, n = _timed_barrier(
                lambda: lm.fit_batch(tok, train_step=step))
            losses.append(loss)
            ms.append(t)
            launches.append(n)
        res[name] = {"losses": losses, "ms": ms, "launches": launches,
                     "captured": step.captured,
                     "params_this_rank": _local_numel(lm.params)}
        states[name] = lm.gather_params()[0]
        del lm, step
    if rank == 0:
        ref = TransformerLM(**TRAIN_CFG).init()
        ref_losses = [ref.fit_batch(tok) for _ in range(MODEL_STEPS)]
        for name in res:
            loss_err = max(abs(a - b) for a, b in
                           zip(res[name]["losses"], ref_losses))
            param_err = tree_err(states[name], ref.params)
            res[name].update(ref_losses=ref_losses, loss_err=loss_err,
                             param_err=param_err,
                             ok=loss_err <= MESH_LM_TOL["loss"]
                             and param_err <= MESH_LM_TOL["params"])
        res["params_whole"] = _local_numel(ref.params)
    return res


def model_allreduce_ms(meshes: dict) -> float:
    """One all-reduce of a ``[16, 1024, 512]`` f32 tensor over the
    ``model=4`` group (the training g's), mean of 5."""
    import torch
    from deeplearning4j_tpu_torch.parallel.collectives import all_reduce_
    from deeplearning4j_tpu_torch.parallel.mesh import MODEL_AXIS, axis_group

    group = axis_group(meshes["model=4"], MODEL_AXIS)
    x = torch.ones((TRAIN_BATCH, TRAIN_T, SERVE_CFG["d_model"]),
                   device="cuda")
    all_reduce_(x, group)
    _, ms, _ = _timed_barrier(lambda: [all_reduce_(x, group)
                                       for _ in range(5)])
    return ms / 5


def _margin_recorder(srv, margins: list):
    """Wrap the engine's sampler to keep the smallest top-1/top-2 logit
    margin of the live rows it samples."""
    import torch

    sample = srv.engine._sample_row

    def recorded(logits, gens):
        live = srv._live_slots() if logits.shape[0] == srv.slots else [0]
        if live:
            top = torch.topk(logits[live].float(), 2, dim=-1).values
            margins.append(float((top[:, 0] - top[:, 1]).min()))
        return sample(logits, gens)

    srv.engine._sample_row = recorded


def model_tp_serve(rank: int, meshes: dict) -> dict:
    """Cell (b): the Serve cell's 8 greedy requests through
    ``DecodeServer(slots=8, mesh=model=4)``; rank 0 also serves them on
    one device and holds every stream against ``lm.generate``."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    from deeplearning4j_tpu_torch.serving import DecodeServer, run_open_loop

    sched = serve_schedule()
    lm = TransformerLM(**SERVE_CFG).init()
    srv = DecodeServer(lm, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                       mesh=meshes["model=4"])
    margins = []
    _margin_recorder(srv, margins)
    report, ms, launches = _timed_barrier(lambda: run_open_loop(srv, sched))
    s = report.summary()
    res = {"summary": s, "launches": launches, "ms": ms,
           "min_margin": min(margins),
           "kv_shards": srv.stats()["kv_shards"],
           "pool_bytes_this_rank": srv.engine.cache.nbytes
           // srv.engine.cache.n_shard,
           "params_this_rank": _local_numel(lm.params)}
    prompt = sched[0].prompt[None]
    beam, _ = lm.generate_beam(prompt, MODEL_BEAM_NEW, beam_size=3)
    if rank == 0:
        ref = TransformerLM(**SERVE_CFG).init()
        single = DecodeServer(ref, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN)
        rep1 = run_open_loop(single, sched)
        torch.cuda.synchronize()
        res["single"] = rep1.summary()
        bad = []
        for req in srv.finished:
            want = ref.generate(req.prompt[None],
                                req.max_new_tokens)[0].cpu().numpy()
            if not np.array_equal(req.output, want):
                bad.append(first_divergence(req.output, want, ref,
                                            req.prompt))
        res["streams_equal"] = not bad and len(srv.finished) == len(sched)
        res["divergence"] = bad
        rbeam, _ = ref.generate_beam(prompt, MODEL_BEAM_NEW, beam_size=3)
        res["beam_equal"] = bool(torch.equal(beam.cpu(), rbeam.cpu()))
    return res


def _stage_fn(lm):
    def fn(p, h):
        for blk in p["blocks"]:
            h = lm._block(blk, h, train=True)[0]
        return h
    return fn


def model_pipe(rank: int, meshes: dict) -> dict:
    """Cell (c): the LM's 8 blocks as 4 stages of 2 over ``pipe=4``, M =
    8 microbatches of ``[2, 1024]`` (the blocks' bf16 compute copy on
    seeded activations), forward and backward of ``Σ out·g``; rank 0
    holds the outputs and every stage's gradients against the same
    blocks run in sequence."""
    import torch
    from deeplearning4j_tpu_torch.dtypes import tree_leaves, tree_map
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    from deeplearning4j_tpu_torch.parallel import (
        shard_stage_params, split_microbatches, spmd_pipeline,
        stack_stage_params)
    from deeplearning4j_tpu_torch.parallel.collectives import all_gather
    from deeplearning4j_tpu_torch.parallel.mesh import PIPE_AXIS, axis_group

    mesh = meshes["pipe=4"]
    lm = TransformerLM(**TRAIN_CFG).init()
    blocks = lm.policy.compute_copy(lm.params)["blocks"]
    per = len(blocks) // PIPE_STAGES
    stacked = stack_stage_params([{"blocks": blocks[s * per:(s + 1) * per]}
                                  for s in range(PIPE_STAGES)])
    local = tree_map(lambda p: p.detach().requires_grad_(),
                     shard_stage_params(stacked, mesh))
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = PIPE_MICRO * PIPE_ROWS
    x = torch.randn((rows, TRAIN_T, SERVE_CFG["d_model"]), generator=gen,
                    device="cuda").to(torch.bfloat16)
    g = torch.randn(x.shape, generator=gen, device="cuda")
    fn = _stage_fn(lm)

    def run():
        out = spmd_pipeline(fn, local, split_microbatches(x, PIPE_MICRO),
                            mesh).reshape(x.shape)
        loss = (out.float() * g).sum() / g.numel()
        return out.detach(), torch.autograd.grad(loss, tree_leaves(local))

    run()  # the first call pays the collectives' and allocator's set-up
    (out, grads), ms, launches = _timed_barrier(run)
    group = axis_group(mesh, PIPE_AXIS)
    whole = [all_gather(gr.float(), group, 0) for gr in grads]
    res = {"ms": ms, "launches": launches,
           "params_this_rank": _local_numel(local)}
    if rank == 0:
        seq = tree_map(lambda p: p.detach().requires_grad_(), stacked)
        h = x
        for s in range(PIPE_STAGES):
            h = fn(tree_map(lambda a, s=s: a[s], seq), h)
        ref_loss = (h.float() * g).sum() / g.numel()
        ref_grads = torch.autograd.grad(ref_loss, tree_leaves(seq))

        def rel(a, b):
            return float((a.float() - b.float()).abs().max()) / max(
                1.0, float(b.float().abs().max()))

        res["out_err"] = rel(out, h.detach())
        res["grad_err"] = max(rel(a, b) for a, b in zip(whole, ref_grads))
        res["ok"] = (res["out_err"] <= MODEL_BF16_TOL
                     and res["grad_err"] <= MODEL_BF16_TOL)
    return res


def model_moe(rank: int, meshes: dict) -> dict:
    """Cell (d): the MoE FFN (d512, d_ff 2048, E=8, top-2, capacity
    1.25) over ``expert=4`` on ``[4, 1024, 512]`` f32; rank 0 holds y
    and aux against one device."""
    import torch
    from deeplearning4j_tpu_torch.parallel import (
        MoEConfig, init_moe_params, moe_ffn, shard_moe_params)

    mesh = meshes["expert=4"]
    cfg = MoEConfig(**MOE_CFG)
    params = init_moe_params(cfg, torch.Generator().manual_seed(0),
                             device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn(MOE_SHAPE, generator=gen, device="cuda")
    local = shard_moe_params(params, mesh)
    with torch.no_grad():
        moe_ffn(local, x, cfg, mesh)
        (y, aux), ms, _ = _timed_barrier(lambda: moe_ffn(local, x, cfg,
                                                         mesh))
    res = {"ms": ms, "params_this_rank": _local_numel(local)}
    if rank == 0:
        with torch.no_grad():
            ry, raux = moe_ffn(params, x, cfg)
        res["y_err"] = float((y - ry).abs().max())
        res["aux_err"] = abs(float(aux) - float(raux))
        res["ok"] = (bool(torch.allclose(y, ry, **MOE_TOL))
                     and res["aux_err"] <= MOE_TOL["rtol"] * abs(float(raux)))
    return res


def model_mlp(rank: int, meshes: dict) -> dict:
    """Cell (e): the MNIST MLP at ``[4096, 784]`` f32 under
    ``shard_network_params`` over ``model=4``: 3 fits against ``fit``."""
    import torch
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
        shard_network_params)

    batches = mesh_batches()
    net = build_network("mnist_mlp", "float32", "cuda")
    shard_network_params(net, meshes["model=4"])
    _, ms, launches = _timed_barrier(lambda: net.fit(batches))
    reg = net._sharding_registry
    params = reg.gather(net.params)
    upd = reg.gather_state(net.updater_state)
    res = {"ms_per_fit": ms / len(batches), "launches": launches,
           "kinds": [type(l).__name__ for l in net.layers],
           "params_this_rank": _local_numel(net.params)}
    if rank == 0:
        ref = build_network("mnist_mlp", "float32", "cuda")
        ref.fit(batches)
        res["err"] = max(tree_err(params, ref.params),
                         tree_err(upd, ref.updater_state))
        res["ok"] = tree_close((params, upd), (ref.params, ref.updater_state),
                               **MESH_F32_TOL)
    return res


def l2_mlp(mode: str, device: str):
    """The MNIST MLP (784-256-256-10, the zoo's seed and init) on SGD at
    ``MODEL_L2_LR`` under the gradient normalization ``mode`` at
    ``MODEL_L2_THRESHOLD``."""
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf.neural_net import (
        MultiLayerConfiguration)

    conf = json.loads(zoo.mnist_mlp(hidden=256, device=device).conf
                      .to_json())
    for layer in conf["layers"]:
        layer.update(updater="SGD", learning_rate=MODEL_L2_LR,
                     gradient_normalization=mode,
                     gradient_normalization_threshold=MODEL_L2_THRESHOLD)
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(
        json.dumps(conf)), device=device).init()


def gate_ratio(a, b, rtol: float = MESH_F32_TOL["rtol"],
               atol: float = MESH_F32_TOL["atol"]) -> float:
    """The largest ``|a - b| / (atol + rtol·|b|)`` over two trees: under
    1 where ``tree_close`` holds."""
    from deeplearning4j_tpu_torch.dtypes import tree_leaves

    return max(float(((x.double() - y.double()).abs()
                      / (atol + rtol * y.double().abs())).max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def first_grad_norms(net, ds) -> dict:
    """The L2 norms of ``net``'s gradient on ``ds`` before any
    normalization, by layer and by leaf."""
    import torch

    x = torch.as_tensor(ds.features, device=net.device)
    y = torch.as_tensor(ds.labels, device=net.device)
    grads = net._loss_grads(net.params, net.net_state, x, y)[2]
    return {k: {"layer": float(torch.sqrt(sum(
        (g.double() ** 2).sum() for g in layer.values()))),
        **{name: float(g.double().norm()) for name, g in layer.items()}}
        for k, layer in grads.items()}


def model_l2(rank: int, meshes: dict) -> dict:
    """Cell (f): the MNIST MLP's widths at ``[4096, 784]`` f32 over
    ``data=2 x model=2`` (``ParallelWrapper``: rows over data, layers
    split by ``shard_network_params``) under each L2 normalization: 3
    fits against ``fit`` on one device (rank 0), which also takes the
    first step's norms before the clip."""
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    batches = mesh_batches()
    res = {}
    if rank == 0:   # the norms before the clip; the run with none
        plain = l2_mlp("None", "cuda")
        res["pre_clip"] = first_grad_norms(plain, batches[0])
        plain.fit(batches)
    for mode in MODEL_L2_MODES:
        w = ParallelWrapper(l2_mlp(mode, "cuda"),
                            mesh=meshes["data=2 x model=2"])
        _, ms, launches = _timed_barrier(lambda: w.fit(batches))
        params = w.gather()[0]
        res[mode] = {"ms_per_fit": ms / len(batches), "launches": launches,
                     "kinds": [type(l).__name__ for l in w.network.layers],
                     "params_this_rank": _local_numel(w.network.params)}
        if rank == 0:
            ref = l2_mlp(mode, "cuda")
            ref.fit(batches)
            res[mode].update(err=tree_err(params, ref.params),
                             ok=tree_close(params, ref.params,
                                           **MESH_F32_TOL),
                             gate_share=gate_ratio(params, ref.params),
                             moved=gate_ratio(ref.params, plain.params))
        del w
    return res


def model_fsdp(rank: int, meshes: dict) -> dict:
    """Cell (g): ``ParallelWrapper(fsdp=True)`` over ``data=2 x
    model=2`` on cell (f)'s net under ``ClipL2PerLayer``: 3 fits, then
    ``fit_epochs`` on bench_epoch, each against one device (rank 0); each
    rank's params + updater elements beside TP alone (the same mesh) and
    FSDP alone over ``data=4``."""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    mode = "ClipL2PerLayer"
    m22 = meshes["data=2 x model=2"]
    held = {}
    for name, mesh, fsdp in (("tp", m22, False),
                             ("fsdp data=4", meshes["data=4"], True),
                             ("tp+fsdp", m22, True)):
        w = ParallelWrapper(l2_mlp(mode, "cuda"), mesh=mesh,
                            fsdp=fsdp)
        held[name] = (_local_numel(w.network.params)
                      + _local_numel(w.network.updater_state))
    batches = mesh_batches()
    _, ms_fit, n_fit = _timed_barrier(lambda: w.fit(batches))
    fit_params = w.gather()[0]
    it = ListDataSetIterator(epoch_data(), EPOCH_BATCH)
    hist, ms_epochs, n_epochs = _timed_barrier(
        lambda: w.fit_epochs(it, MODEL_FSDP_EPOCHS))
    res = {"held": held, "ms_per_fit": ms_fit / len(batches),
           "ms_per_epoch": ms_epochs / MODEL_FSDP_EPOCHS,
           "launches": {k: n_fit[k] + n_epochs[k] for k in n_fit},
           "kinds": [type(l).__name__ for l in w.network.layers],
           "local_shapes": {f"{k}/{leaf}": list(v.shape)
                            for k, layer in w.network.params.items()
                            for leaf, v in layer.items()}}
    epoch_params = w.gather()[0]
    if rank == 0:
        ref = l2_mlp(mode, "cuda")
        ref.fit(batches)
        res["fit_err"] = tree_err(fit_params, ref.params)
        res["fit_share"] = gate_ratio(fit_params, ref.params)
        res["fit_ok"] = tree_close(fit_params, ref.params, **MESH_F32_TOL)
        ref_hist = ref.fit_epochs(it, MODEL_FSDP_EPOCHS)
        res["epoch_err"] = max(tree_err(epoch_params, ref.params),
                               float((hist - ref_hist).abs().max()))
        res["epoch_share"] = max(gate_ratio(epoch_params, ref.params),
                                 gate_ratio(hist, ref_hist))
        res["epoch_ok"] = (
            tree_close(epoch_params, ref.params, **MESH_F32_TOL)
            and tree_close(hist, ref_hist, **MESH_F32_TOL))
    return res


def _handoff_ms(fn, reps: int = FLEET_HANDOFF_REPS):
    """Mean ms of ``fn()`` by CUDA events and by the host clock (the
    export's gather over gloo and its copy to the host run on the host),
    after one untimed call; and the last call's result."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    dev = host = 0.0
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        host += (time.perf_counter() - t0) * 1e3
        dev += a.elapsed_time(b)
    return dev / reps, host / reps, out


def model_fleet(rank: int, meshes: dict) -> dict:
    """Cell (h): the Serve cell's 8 greedy requests through a split fleet
    of three replicas over ``model=4`` (prefill ``p0``, decode ``d0`` and
    ``d1``, every rank holding the fleet and making the same calls):
    ``d1`` stands by while ``p0`` prefills into ``d0``, then ``d0``
    drains onto it mid-stream. Then a slab of the TP prefill installs on
    a one-device server (rank 0) and a one-device slab on ``d1``; the
    exports and installs are timed beside a one-device server's."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    from deeplearning4j_tpu_torch.perf import step_graph
    from deeplearning4j_tpu_torch.serving import DecodeServer
    from deeplearning4j_tpu_torch.serving.fleet import (
        FleetController, FleetRouter, ServeReplica, SlotHandoff,
        export_slot, install_slot, make_install)
    from deeplearning4j_tpu_torch.serving.scheduler import ServeRequest

    mesh = meshes["model=4"]
    device = mesh.device_type
    lm = TransformerLM(**SERVE_CFG, device=device).init()
    kw = dict(max_len=SERVE_MAX_LEN, mesh=mesh, device=device)
    reps = [ServeReplica("p0", lm, role="prefill", slots=1, **kw),
            ServeReplica("d0", lm, role="decode", slots=SERVE_SLOTS, **kw),
            ServeReplica("d1", lm, role="decode", slots=SERVE_SLOTS, **kw)]
    p0, d0, d1 = reps
    router = FleetRouter(reps)
    handoffs = []
    place = router.place_handoff

    def recorded(freq, handoff):
        handoffs.append(handoff)
        return place(freq, handoff)

    router.place_handoff = recorded
    launches = {r.replica_id: {} for r in reps}

    def step(r):
        before = step_graph.kernel_launches()
        r.step_once()
        for k, v in _launch_delta(before).items():
            launches[r.replica_id][k] = launches[r.replica_id].get(k, 0) + v

    sched = serve_schedule()
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    router.quiesce("d1")            # in reserve until d0 drains
    frs = [router.submit(a.prompt, a.max_new_tokens) for a in sched]
    while router.agree(p0.busy()):
        step(p0)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    for _ in range(FLEET_DRAIN_AFTER):
        step(d0)
    placed = [fr.replica_id for fr in frs]
    emitted = [len(fr.tokens) for fr in frs]
    router.unquiesce("d1")  # the survivor takes new work again
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    decision = FleetController(router, None, evict_timeout_s=60.0).drain(
        "d0")
    torch.cuda.synchronize()
    drain_ms = (time.perf_counter() - t1) * 1e3
    while router.agree(bool(router.unfinished())):
        step(d1)
        router.retry_pending()
    torch.cuda.synchronize()
    fleet_ms = (time.perf_counter() - t0) * 1e3
    stats = {r.replica_id: r.server.stats() for r in reps}
    res = {"placed": placed, "emitted": emitted, "decision": decision,
           "launches": launches, "fleet_ms": fleet_ms,
           "prefill_ms": prefill_ms, "drain_ms": drain_ms,
           "finished": sum(fr.finished for fr in frs),
           "nbytes": sorted({h.nbytes for h in handoffs}),
           "handoffs": len(handoffs),
           "kv_per_slot_bytes": stats["d1"]["kv_per_slot_bytes"],
           "kv_shards": {rid: st["kv_shards"] for rid, st in stats.items()},
           "pool_bytes_this_rank": {
               r.replica_id: r.server.engine.cache.nbytes
               // r.server.engine.cache.n_shard for r in reps},
           "local_heads": list(lm._local_heads()),
           "prefill_buckets": stats["p0"]["compiles"]["prefill_buckets"]}
    # slabs across layouts: a one-device server beside the TP replicas
    one = TransformerLM(**SERVE_CFG, device=device).init()
    single = DecodeServer(one, slots=2, max_len=SERVE_MAX_LEN,
                          device=device)

    def admitted(server, prompt, handoff, new):
        req = ServeRequest(prompt=prompt, max_new_tokens=new)
        req.tokens.append(handoff.first_token)
        server.admit_external(req, make_install(handoff))
        server.drain()
        return req
    streams = {}
    if rank == 0:   # a slab the TP prefill exported, on one device
        streams["tp_to_one"] = (admitted(single, sched[0].prompt,
                                         handoffs[0],
                                         sched[0].max_new_tokens), sched[0])
    a = sched[1]
    tok = int(single.engine.prefill(a.prompt, 1))
    one_slab = SlotHandoff(
        slabs=export_slot(single.engine, 1), cursor=len(a.prompt), key=None,
        first_token=tok, kv_dtype=single.engine.kv_dtype,
        max_len=single.max_len, device=device)
    streams["one_to_tp"] = (admitted(d1.server, a.prompt, one_slab,
                                     a.max_new_tokens), a)
    res["cross_nbytes"] = [one_slab.nbytes,
                           single.stats()["kv_per_slot_bytes"]]
    # one slot's export and install, TP (gather over model=4) and one
    # device; d1 and single are idle, so their slots may be overwritten
    times = {}
    for name, eng in (("tp", d1.server.engine),
                      ("one_device", single.engine)):
        dev, host, slabs = _handoff_ms(lambda: export_slot(eng, 0))
        times[f"{name}_export"] = (dev, host)
        h = SlotHandoff(slabs=slabs, cursor=1, key=None, first_token=0,
                        kv_dtype=eng.kv_dtype, max_len=eng.max_len,
                        device=device)
        dev, host, _ = _handoff_ms(lambda: install_slot(eng, 1, h))
        times[f"{name}_install"] = (dev, host)
    res["handoff_times"] = times
    if rank == 0:
        bad = []
        outs = [(fr.output, fr.prompt, fr.max_new_tokens) for fr in frs]
        outs += [(req.output, a.prompt, a.max_new_tokens)
                 for req, a in streams.values()]
        for got, prompt, new in outs:
            want = one.generate(prompt[None], new)[0].cpu().numpy()
            if not np.array_equal(got, want):
                bad.append(first_divergence(got, want, one, prompt))
        res["streams_equal"] = not bad and res["finished"] == len(sched)
        res["divergence"] = bad
    return res


def model_rank(rank: int, n: int, tmp: str) -> None:
    """One rank of the 4-process gloo world of phase 16; writes its
    results to ``model<r>.json`` in ``tmp``."""
    import torch

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, HERE)
    from deeplearning4j_tpu_torch.parallel import (
        MeshSpec, build_mesh, join_world, leave_world)

    out = {"rank": rank}
    t0 = time.monotonic()
    join_world(os.path.join(tmp, "model_store"), rank, n, backend="gloo",
               timeout_s=MESH_JOIN_TIMEOUT_S)
    out["join_s"] = time.monotonic() - t0
    try:
        meshes = {
            "model=4": build_mesh(MeshSpec(data=1, model=n), device="cuda"),
            "data=2 x model=2": build_mesh(MeshSpec(data=2, model=n // 2),
                                           device="cuda"),
            "pipe=4": build_mesh(MeshSpec(data=1, pipe=n), device="cuda"),
            "expert=4": build_mesh(MeshSpec(data=1, expert=n),
                                   device="cuda"),
            "data=4": build_mesh(MeshSpec(data=n), device="cuda")}
        for name, fn in (("allreduce", lambda: model_allreduce_ms(meshes)),
                         ("train", lambda: model_tp_train(rank, meshes)),
                         ("serve", lambda: model_tp_serve(rank, meshes)),
                         ("pipe", lambda: model_pipe(rank, meshes)),
                         ("moe", lambda: model_moe(rank, meshes)),
                         ("mlp", lambda: model_mlp(rank, meshes)),
                         ("l2", lambda: model_l2(rank, meshes)),
                         ("fsdp", lambda: model_fsdp(rank, meshes)),
                         ("fleet", lambda: model_fleet(rank, meshes))):
            torch.cuda.reset_peak_memory_stats()
            t = time.monotonic()
            out[name] = fn()
            out[f"{name}_s"] = time.monotonic() - t
            out[f"{name}_peak_mem_bytes"] = torch.cuda.max_memory_allocated()
            torch.cuda.empty_cache()
    except Exception:
        out["error"] = traceback.format_exc()
    finally:
        leave_world()
    with open(os.path.join(tmp, f"model{rank}.json"), "w") as f:
        json.dump(out, f)
    if "error" in out:
        sys.exit(1)


def model_kernels(card: str) -> dict:
    """B1/B2/B3 at the per-rank attention shapes of the TP steps (2 of 8
    heads at ``model=4``, 4 of 8 rows' heads at ``data=2 x model=2``)
    against their bounds, their plain versions and SDPA, CUDA events."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {}
    for b, t, h, d in MODEL_KERNEL_SHAPES:
        q, k, v, do = (torch.randn((b, t, h, d), generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        delta = fa._delta(out, do)
        args = (q, k, v, do, lse, delta)
        keep = fa._keep(t, t, True, None, device="cuda")
        scale = fa._scale(q, None)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        row = {
            "fwd": cuda_ms(lambda: fa.flash_attention_fwd(q, k, v,
                                                          causal=True)),
            "fwd_plain": cuda_ms(lambda: fa.flash_attention_fwd_reference(
                q, k, v, causal=True)),
            "fwd_sdpa": cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)),
            "dkdv": cuda_ms(lambda: fa.flash_attention_bwd_dkdv(
                *args, causal=True)),
            "dkdv_plain": cuda_ms(lambda: fa._dkdv(*args, keep, scale)),
            "dq": cuda_ms(lambda: fa.flash_attention_bwd_dq(*args,
                                                            causal=True)),
            "dq_plain": cuda_ms(lambda: fa._dq(*args, keep, scale)),
            "bwd_sdpa": sdpa_backward_ms(q, k, v, do, True, None),
            "fwd_bound": fa.flash_bound(b, t, t, h, d, torch.bfloat16,
                                        causal=True)["bound_ms"]}
        bwd = fa.flash_bwd_bound(b, t, t, h, d, torch.bfloat16, causal=True)
        row["dkdv_bound"] = bwd["dkdv"]["bound_ms"]
        row["dq_bound"] = bwd["dq"]["bound_ms"]
        rows[(b, t, h, d)] = row
        print(f"model kernels bf16 [{b}, {t}, {h}, {d}] causal: B1 "
              f"{row['fwd']:.5f} ms (bound {row['fwd_bound']:.5f}, plain "
              f"{row['fwd_plain']:.5f}, SDPA {row['fwd_sdpa']:.5f}), B2 "
              f"{row['dkdv']:.5f} ms (bound {row['dkdv_bound']:.5f}, plain "
              f"{row['dkdv_plain']:.5f}), B3 {row['dq']:.5f} ms (bound "
              f"{row['dq_bound']:.5f}, plain {row['dq_plain']:.5f}), SDPA "
              f"backward {row['bwd_sdpa']:.5f} ms [{card}]")
    return rows


def _summed(counts: list) -> dict:
    """Launch counts by kernel, summed over the ranks' dicts."""
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def model_l2_lines(ranks: list, card: str) -> list:
    """Cells (f) and (g)'s lines; their failures."""
    failures = []
    r0 = ranks[0]
    pre = r0["l2"]["pre_clip"]
    print(f"model (f) mnist_mlp float32 [{MESH_MLP_BATCH}, 784] SGD "
          f"lr {MODEL_L2_LR} over data=2 x model=2 "
          f"({r0['l2'][MODEL_L2_MODES[0]]['kinds']}): first-step norms "
          "before normalization, by layer "
          + ", ".join(f"{k} {v['layer']:.5f} (W {v['W']:.5f}, b "
                      f"{v['b']:.5f})" for k, v in pre.items())
          + f"; threshold {MODEL_L2_THRESHOLD}; "
          f"{max(r['l2_s'] for r in ranks):.1f} s; peak_mem_bytes per rank "
          f"{[r['l2_peak_mem_bytes'] for r in ranks]} [{card}]")
    if not all(v["layer"] > MODEL_L2_THRESHOLD for v in pre.values()):
        failures.append("a layer's norm lies under the clip threshold")
    for mode in MODEL_L2_MODES:
        c = r0["l2"][mode]
        launches = _summed([r["l2"][mode]["launches"] for r in ranks])
        print(f"model (f) {mode}: {MESH_STEPS} fits against fit on one "
              f"device max_abs_err={c['err']:.3e} (rtol 1e-4, atol 1e-6; "
              f"{c['gate_share']:.4f} of the gate) "
              f"{'ok' if c['ok'] else 'MISMATCH'}; the control: this "
              f"mode's one-device run and the run without normalization "
              f"part by {c['moved']:.1f}x the gate (at least 10); "
              f"{max(r['l2'][mode]['ms_per_fit'] for r in ranks):.2f} ms "
              f"per fit; params per rank "
              f"{[r['l2'][mode]['params_this_rank'] for r in ranks]}; "
              f"B1-B3 launches over the ranks {launches} [{card}]")
        if not c["ok"]:
            failures.append(f"l2 {mode}")
        if c["moved"] < 10.0:
            failures.append(f"l2 {mode}: normalization moves the result "
                            "by less than 10x the gate")
        if any(launches.values()):
            failures.append(f"l2 {mode} launched a flash kernel")
    g = r0["fsdp"]
    launches = _summed([r["fsdp"]["launches"] for r in ranks])
    print(f"model (g) ParallelWrapper(fsdp=True) over data=2 x model=2, "
          f"ClipL2PerLayer ({g['kinds']}; rank 0 holds "
          f"{g['local_shapes']}): {MESH_STEPS} fits against one device "
          f"max_abs_err={g['fit_err']:.3e} ({g['fit_share']:.4f} of the "
          f"gate), then fit_epochs ({MODEL_FSDP_EPOCHS} epochs of "
          f"bench_epoch, {EPOCH_BATCHES} x [{EPOCH_BATCH}, 784]) history "
          f"and params max_abs_err={g['epoch_err']:.3e} "
          f"({g['epoch_share']:.4f} of the gate; rtol 1e-4, atol 1e-6) "
          f"{'ok' if g['fit_ok'] and g['epoch_ok'] else 'MISMATCH'}; "
          f"{max(r['fsdp']['ms_per_fit'] for r in ranks):.2f} ms per fit, "
          f"{max(r['fsdp']['ms_per_epoch'] for r in ranks):.1f} ms per "
          f"epoch; {max(r['fsdp_s'] for r in ranks):.1f} s; params + "
          "updater elements per rank: " + "; ".join(
              f"{name} {[r['fsdp']['held'][name] for r in ranks]}"
              for name in g["held"])
          + f"; peak_mem_bytes per rank "
          f"{[r['fsdp_peak_mem_bytes'] for r in ranks]}; B1-B3 launches "
          f"over the ranks {launches} [{card}]")
    if not (g["fit_ok"] and g["epoch_ok"]):
        failures.append("fsdp over data x model")
    if any(launches.values()):
        failures.append("the FSDP x TP cell launched a flash kernel")
    return failures


KERNEL_ORDER = ("flash_attention_fwd", "flash_attention_bwd_dkdv",
                "flash_attention_bwd_dq")


def model_fleet_lines(ranks: list, card: str, tp: dict) -> list:
    """Cell (h)'s lines; its failures. Adds p0's B1 launches to ``tp``."""
    failures = []
    r0 = ranks[0]
    h = r0["fleet"]
    d = h["decision"]
    layers = SERVE_CFG["num_layers"]
    heads = h["local_heads"][0]
    dh = SERVE_CFG["d_model"] // SERVE_CFG["num_heads"]
    print(f"model (h) split fleet over model={MESH_RANKS} (p0 prefill, d0 "
          f"and d1 decode, {SERVE_SLOTS} slots, max_len {SERVE_MAX_LEN}): "
          f"{SERVE_REQUESTS} greedy requests placed on {h['placed']}, "
          f"{h['emitted']} tokens out when d0 drained onto d1: migrated="
          f"{d['migrated']} live={d['live']} handoffs={d['handoffs']} "
          f"queued={d['queued']} fallback_failovers="
          f"{d['fallback_failovers']}; finished {h['finished']}; streams "
          f"(and a TP slab on one device, a one-device slab on d1) equal "
          f"lm.generate: {h['streams_equal']} {h['divergence']}; "
          f"{h['handoffs']} handoffs of {h['nbytes']} bytes, "
          f"kv_per_slot_bytes {h['kv_per_slot_bytes']}, one-device slab "
          f"{h['cross_nbytes']}; kv_shards {h['kv_shards']}; prefill "
          f"{h['prefill_ms']:.1f} ms, drain {h['drain_ms']:.1f} ms, the "
          f"whole run {h['fleet_ms']:.1f} ms; "
          f"{max(r['fleet_s'] for r in ranks):.1f} s [{card}]")
    for name in ("tp", "one_device"):
        ex = [r["fleet"]["handoff_times"][f"{name}_export"] for r in ranks]
        ins = [r["fleet"]["handoff_times"][f"{name}_install"] for r in ranks]
        print(f"model (h) handoff {name} one slot [{layers}, "
              f"{SERVE_MAX_LEN}, {SERVE_CFG['num_heads']}, {dh}] bf16 k+v "
              f"({h['kv_per_slot_bytes']} bytes), mean of "
              f"{FLEET_HANDOFF_REPS}, per rank (CUDA events ms, host ms): "
              f"export {[(round(a, 3), round(b, 3)) for a, b in ex]}, "
              f"install {[(round(a, 3), round(b, 3)) for a, b in ins]} "
              f"[{card}]")
    print("model (h) per rank: pool bytes "
          + "; ".join(str(r["fleet"]["pool_bytes_this_rank"]) for r in ranks)
          + f"; peak_mem_bytes {[r['fleet_peak_mem_bytes'] for r in ranks]};"
          " B1, B2, B3 launches by replica "
          + "; ".join(str({rid: [n.get(k, 0) for k in KERNEL_ORDER]
                           for rid, n in r["fleet"]["launches"].items()})
                      for r in ranks)
          + f"; p0's prefill buckets {h['prefill_buckets']}, B1 on "
          f"[1, P, {heads}, {dh}] a rank [{card}]")
    if not h["streams_equal"]:
        failures.append("fleet streams")
    if (d["fallback_failovers"] or d["live"] < 1
            or d["migrated"] != d["live"] + d["queued"] + d["handoffs"]):
        failures.append(f"fleet drain {d}")
    if h["nbytes"] != [h["kv_per_slot_bytes"]] or len(set(
            h["cross_nbytes"])) != 1:
        failures.append(f"handoff bytes {h['nbytes']} {h['cross_nbytes']}")
    if set(h["kv_shards"].values()) != {MESH_RANKS}:
        failures.append(f"fleet kv_shards {h['kv_shards']}")
    for r in ranks:
        n = r["fleet"]["launches"]
        p = n["p0"]
        if (p.get("flash_attention_fwd") != layers * SERVE_REQUESTS
                or p.get("flash_attention_bwd_dkdv")
                or p.get("flash_attention_bwd_dq")
                or any(n["d0"].values()) or any(n["d1"].values())):
            failures.append(f"fleet launched {n}, expected {layers} B1 a "
                            "prefill in p0 alone")
        tp["flash_attention_fwd"] += p.get("flash_attention_fwd", 0)
    return failures


def model_phase(card: str) -> dict:
    """Phase 16; returns B1–B3's launches over cell (a)'s steps and cell
    (h)'s prefills, and over cell (c)'s step, summed over the ranks."""
    import tempfile

    import torch

    t_phase = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="dl4j_model_") as tmp:
        t0 = time.monotonic()
        codes = spawn_world("model_rank", tmp, MODEL_WORLD_TIMEOUT_S)
        bad = [r for r, c in enumerate(codes) if c != 0]
        if bad:
            for r in bad:
                with open(os.path.join(tmp, f"model_rank{r}.log")) as f:
                    print(f"model rank {r} exited {codes[r]}:\n"
                          f"{f.read()[-3000:]}", file=sys.stderr)
            raise AssertionError(f"model world: rank(s) {bad} failed or "
                                 f"timed out ({MODEL_WORLD_TIMEOUT_S} s)")
        ranks = []
        for r in range(MESH_RANKS):
            with open(os.path.join(tmp, f"model{r}.json")) as f:
                ranks.append(json.load(f))
    print(f"model world{MESH_RANKS} (gloo, one card): "
          f"{time.monotonic() - t0:.1f} s; per rank join "
          + ", ".join(f"{r['join_s']:.1f}" for r in ranks) + " s; cells "
          + ", ".join(f"{c} {max(r[c + '_s'] for r in ranks):.1f} s"
                      for c in ("train", "serve", "pipe", "moe", "mlp",
                                "l2", "fsdp", "fleet")))
    r0 = ranks[0]
    layers = TRAIN_CFG["num_layers"]
    failures = []
    print(f"model allreduce [{TRAIN_BATCH}, {TRAIN_T}, "
          f"{SERVE_CFG['d_model']}] f32 over model={MESH_RANKS} (gloo, CUDA "
          f"tensors): {[round(r['allreduce'], 3) for r in ranks]} ms per "
          f"rank [{card}]")
    tp = {"flash_attention_fwd": 0, "flash_attention_bwd_dkdv": 0,
          "flash_attention_bwd_dq": 0}
    for name in ("model=4", "data=2 x model=2"):
        c = r0["train"][name]
        ms = [max(r["train"][name]["ms"][s] for r in ranks)
              for s in range(MODEL_STEPS)]
        per_rank = [r["train"][name]["launches"] for r in ranks]
        print(f"model (a) tp train [{TRAIN_BATCH}, {TRAIN_T}] mixed_bf16 "
              f"over {name}: losses {c['losses']} vs single device "
              f"{c['ref_losses']}: loss_err={c['loss_err']:.3e} (tol "
              f"{MESH_LM_TOL['loss']}), param_err={c['param_err']:.3e} (tol "
              f"{MESH_LM_TOL['params']}); ms per step "
              f"{[round(x, 1) for x in ms]}; captured {c['captured']}; "
              f"params per rank {[r['train'][name]['params_this_rank'] for r in ranks]} "
              f"of {r0['train']['params_whole']}; peak_mem_bytes per rank "
              f"{[r['train_peak_mem_bytes'] for r in ranks]}; B1-B3 "
              f"launches per rank and step {per_rank[0]} [{card}]")
        if not c["ok"] or c["captured"]:
            failures.append(f"tp train {name}")
        for r in per_rank:
            for step in r:
                if any(v != layers for v in step.values()):
                    failures.append(f"tp train {name} launched {step}, "
                                    f"expected {layers} of each a step")
                for k in tp:
                    tp[k] += step[k]
    sv = r0["serve"]
    s, s1 = sv["summary"], sv["single"]
    print(f"model (b) tp serve {SERVE_REQUESTS} greedy requests (20 req/s, "
          f"seed 7) DecodeServer(slots={SERVE_SLOTS}, mesh=model="
          f"{MESH_RANKS}): finished={s['finished']} "
          f"tokens_per_sec={s['tokens_per_sec']} "
          f"ttft_p50_ms={s['ttft_p50_ms']} vs one device "
          f"tokens_per_sec={s1['tokens_per_sec']} "
          f"ttft_p50_ms={s1['ttft_p50_ms']}; streams equal lm.generate: "
          f"{sv['streams_equal']} {sv['divergence']}; smallest top-1/top-2 "
          f"margin {min(r['serve']['min_margin'] for r in ranks):.5f}; "
          f"beam-3 ({MODEL_BEAM_NEW} new) equal to one device: "
          f"{sv['beam_equal']}; kv_shards {sv['kv_shards']}, pool bytes per "
          f"rank {sv['pool_bytes_this_rank']}; params per rank "
          f"{sv['params_this_rank']}; peak_mem_bytes per rank "
          f"{[r['serve_peak_mem_bytes'] for r in ranks]}; B1-B3 launches "
          f"per rank {[r['serve']['launches'] for r in ranks]} [{card}]")
    if not sv["streams_equal"]:
        failures.append("tp serve streams")
    for r in ranks:
        n = r["serve"]["launches"]
        if (n["flash_attention_fwd"] != layers * SERVE_REQUESTS
                or n["flash_attention_bwd_dkdv"]
                or n["flash_attention_bwd_dq"]):
            failures.append(f"tp serve launched {n}")
    pp = r0["pipe"]
    ticks = PIPE_MICRO + PIPE_STAGES - 1
    per = layers // PIPE_STAGES
    print(f"model (c) gpipe {layers} blocks as {PIPE_STAGES} stages of "
          f"{per} over pipe={MESH_RANKS}, M={PIPE_MICRO} microbatches of "
          f"[{PIPE_ROWS}, {TRAIN_T}] bf16: out_err={pp['out_err']:.3e}, "
          f"grad_err={pp['grad_err']:.3e} of each tensor's largest (tol "
          f"{MODEL_BF16_TOL}) against the blocks in sequence; "
          f"{max(r['pipe']['ms'] for r in ranks):.1f} ms a forward and "
          f"backward; params per rank {pp['params_this_rank']}; "
          f"peak_mem_bytes per rank "
          f"{[r['pipe_peak_mem_bytes'] for r in ranks]}; B1-B3 launches "
          f"per rank {[r['pipe']['launches'] for r in ranks]} [{card}]")
    if not pp["ok"]:
        failures.append("gpipe")
    pipe = {k: 0 for k in tp}
    for r in ranks:
        n = r["pipe"]["launches"]
        if any(v != ticks * per for v in n.values()):
            failures.append(f"gpipe launched {n}, expected {ticks * per} "
                            "of each a rank")
        for k in pipe:
            pipe[k] += n[k]
    me = r0["moe"]
    print(f"model (d) moe d{MOE_CFG['d_model']} d_ff {MOE_CFG['d_ff']} "
          f"E={MOE_CFG['n_experts']} top-{MOE_CFG['top_k']} capacity "
          f"{MOE_CFG['capacity_factor']} over expert={MESH_RANKS} on "
          f"{list(MOE_SHAPE)} f32: y max_abs_err={me['y_err']:.3e} (rtol "
          f"1e-4, atol 1e-5), aux_err={me['aux_err']:.3e}; "
          f"{max(r['moe']['ms'] for r in ranks):.2f} ms a forward; params "
          f"per rank {me['params_this_rank']}; peak_mem_bytes per rank "
          f"{[r['moe_peak_mem_bytes'] for r in ranks]} [{card}]")
    if not me["ok"]:
        failures.append("moe")
    ml = r0["mlp"]
    print(f"model (e) mnist_mlp float32 [{MESH_MLP_BATCH}, 784] under "
          f"shard_network_params over model={MESH_RANKS} ({ml['kinds']}): "
          f"{MESH_STEPS} fits against fit max_abs_err={ml['err']:.3e} "
          f"(rtol 1e-4, atol 1e-6) {'ok' if ml['ok'] else 'MISMATCH'}; "
          f"{max(r['mlp']['ms_per_fit'] for r in ranks):.2f} ms per fit; "
          f"params per rank {ml['params_this_rank']}; peak_mem_bytes per "
          f"rank {[r['mlp_peak_mem_bytes'] for r in ranks]} [{card}]")
    if not ml["ok"]:
        failures.append("tp mlp")
    if any(v for r in ranks for v in r["mlp"]["launches"].values()):
        failures.append("the MLP launched a flash kernel")
    failures += model_l2_lines(ranks, card)
    failures += model_fleet_lines(ranks, card, tp)
    if failures:
        raise AssertionError("model axes: " + "; ".join(failures))
    torch.cuda.empty_cache()
    model_kernels(card)
    print(f"model phase: {time.monotonic() - t_phase:.1f} s, B1-B3 launches "
          f"over the TP steps and (h)'s prefills {tp}, over the pipeline "
          f"step {pipe} [{card}]")
    return {"tp": tp, "pipe": pipe}


# ---------------------------------------------------------------------------
# phase 17: the cluster layer — the fused epoch over a mesh with its
# elastic reshard, DistributedWord2Vec, the tracker, the router, the CLI
# ---------------------------------------------------------------------------
CLUSTER_DEVICE = "cuda"  # "cpu" only to rehearse the phase
CLUSTER_WORLD_TIMEOUT_S = 420  # the 4-rank world; every rank killed past it
CLUSTER_EPOCHS = 2  # bench_epoch's epochs over the mesh, (b) and (d)
CLUSTER_ELASTIC_EPOCHS = 4  # one chunk each: data=4, None, 2x2, data=4
CLUSTER_TOL = dict(rtol=1e-4, atol=1e-6)  # float32 against one device
CLUSTER_ELASTIC_TOL = dict(rtol=2e-4, atol=1e-5)  # the reference's gate
CLUSTER_W2V_ATOL = 1e-5
CLUSTER_W2V_EPOCHS = 1
CLUSTER_JOBS = 4  # (e): one [4096, 784] job a worker thread
# (b)'s width cell: data=4, then ranks [1,2,3], ranks [0,1], data=4 (one
# epoch each); the autopilot's: rank 3's first chunk stalls this long
CLUSTER_WIDTHS = ("data=4", "ranks [1,2,3]", "ranks [0,1]", "data=4")
CLUSTER_SLOW_MS = 1500.0
CLI_MH_ROWS, CLI_MH_FEATURES, CLI_MH_BATCH = 4096, 64, 256
CLI_MH_PROCS = 4


def cluster_world_one(card: str, tmp: str) -> dict:
    """(a) An NCCL world of one: ``ParallelWrapper(build_mesh())
    .fit_epochs`` on phase 8's epoch cell is the network's own captured
    ``fit_epochs``, bitwise, with 16 replays an epoch."""
    import torch
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel import (
        ParallelWrapper, build_mesh, join_world, leave_world)

    join_world(os.path.join(tmp, "nccl1"), 0, 1,
               backend="gloo" if CLUSTER_DEVICE == "cpu" else "nccl",
               timeout_s=MESH_JOIN_TIMEOUT_S)
    try:
        mesh = build_mesh(device=CLUSTER_DEVICE)
        it = ListDataSetIterator(epoch_data(), EPOCH_BATCH)
        runs = []
        for wrapped in (False, True):
            net = build_network("mnist_mlp", "bf16", CLUSTER_DEVICE)
            cache = net.build_epoch_cache(it)
            net.fit_epochs(cache, 1)  # warm-up: capture
            prog = next(iter(net._programs.values()))
            r0 = prog.graph.replays
            w = ParallelWrapper(net, mesh=mesh) if wrapped else net
            out = {}
            wall, _ = timed(lambda: out.setdefault(
                "hist", w.fit_epochs(cache, EPOCH_EPOCHS)))
            runs.append((net, out["hist"], wall / EPOCH_EPOCHS * 1e3,
                         (prog.graph.replays - r0) / EPOCH_EPOCHS))
        (a, ha, ms_a, _), (b, hb, ms_b, replays) = runs
        same = torch.equal(ha, hb) and same_state(a, b)
        print(f"cluster (a) world1 nccl ParallelWrapper.fit_epochs "
              f"mnist_mlp bf16 [{EPOCH_BATCHES} x {EPOCH_BATCH}, 784] "
              f"x{EPOCH_EPOCHS}: bitwise net.fit_epochs: {same}, "
              f"{replays:.1f} replays an epoch, {ms_b:.3f} ms an epoch "
              f"(net.fit_epochs {ms_a:.3f}) [{card}]")
        if not same or (replays != EPOCH_BATCHES
                        and CLUSTER_DEVICE != "cpu"):
            raise AssertionError("the world-1 wrapper's fit_epochs is not "
                                 "the captured net.fit_epochs")
        return {"ms_per_epoch": ms_b, "net_ms_per_epoch": ms_a}
    finally:
        leave_world()


def _cache_bytes(cache) -> int:
    from deeplearning4j_tpu_torch.dtypes import tree_leaves

    return sum(t.numel() * t.element_size()
               for t in tree_leaves([a for a in cache.batch_stacks()
                                     if a is not None]))


def _epoch_ms(fn, epochs: int):
    """``fn()`` after a barrier: its result and ms an epoch."""
    out, ms, launches = _timed_barrier(fn)
    return out, ms / epochs, launches


def _timed_barrier_free(fn):
    """``fn()`` in one process: its result, wall ms and launches."""
    import torch
    from deeplearning4j_tpu_torch.perf import step_graph

    _cluster_sync()
    before = step_graph.kernel_launches()
    t0 = time.perf_counter()
    out = fn()
    _cluster_sync()
    return out, (time.perf_counter() - t0) * 1e3, _launch_delta(before)


def _cluster_sync() -> None:
    import torch

    if CLUSTER_DEVICE != "cpu":
        torch.cuda.synchronize()


def _sum_launches(into: dict, more: dict) -> None:
    for k, v in more.items():
        into[k] = into.get(k, 0) + v


def cluster_epochs(rank: int, meshes: dict, launches: dict) -> dict:
    """(b) ``fit_epochs`` over ``data=4`` (FSDP off and on) on bench_epoch
    in float32, and the elastic run ``data=4 → None → data=2 × model=2 →
    data=4`` and the width cell (``cluster_width``) beside the
    uninterrupted one; rank 0 also runs the one-device ``fit_epochs``."""
    import torch
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.dtypes import tree_map
    from deeplearning4j_tpu_torch.monitor import metrics
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper

    m4, m22 = meshes["data=4"], meshes["data=2 x model=2"]
    ds = epoch_data()
    it = ListDataSetIterator(ds, EPOCH_BATCH)
    out = {}
    # warm-up: the world's first steps set up gloo's pairs and the card
    ParallelWrapper(build_network("mnist_mlp", "float32", CLUSTER_DEVICE),
                    mesh=m4).fit_epochs(it, 1)
    for fsdp in (False, True):
        net = build_network("mnist_mlp", "float32", CLUSTER_DEVICE)
        w = ParallelWrapper(net, mesh=m4, fsdp=fsdp)
        torch.cuda.reset_peak_memory_stats()
        cache = w.build_epoch_cache(it)
        hist, ms, n = _epoch_ms(lambda: w.fit_epochs(cache, CLUSTER_EPOCHS),
                                CLUSTER_EPOCHS)
        _sum_launches(launches, n)
        params = w.gather()[0]
        out[f"fsdp={fsdp}"] = {
            "ms_per_epoch": ms, "hist": hist.tolist(),
            "cache_bytes_this_rank": _cache_bytes(cache),
            "cache_n_shard": cache.n_shard,
            "params_this_rank": _local_numel(net.params),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "plans_equal": None}
        out[f"fsdp={fsdp}"]["_params"] = params
        del cache
    counter = metrics().counter("elastic_reshards_total")
    before = counter.value(model="MultiLayerNetwork")
    runs = {}
    for elastic in (False, True):
        net = build_network("mnist_mlp", "float32", CLUSTER_DEVICE)
        w = ParallelWrapper(net, mesh=m4)
        targets = {1: None, 2: m22, 3: m4} if elastic else {}

        def on_chunk(done, w=w, targets=targets):
            if done in targets:
                w.request_reshard(targets[done])
            return False

        hist, ms, n = _epoch_ms(lambda: w.fit_epochs(
            it, CLUSTER_ELASTIC_EPOCHS, chunk_epochs=1, on_chunk=on_chunk),
            CLUSTER_ELASTIC_EPOCHS)
        _sum_launches(launches, n)
        runs[elastic] = (hist, w.gather()[0], ms)
    (h0, p0, ms0), (h1, p1, ms1) = runs[False], runs[True]
    out["elastic"] = {
        "ok": (torch.allclose(h1, h0, **CLUSTER_ELASTIC_TOL)
               and tree_close(p1, p0, **CLUSTER_ELASTIC_TOL)),
        "hist_err": float((h1 - h0).abs().max()), "param_err": tree_err(p1,
                                                                       p0),
        "reshards": counter.value(model="MultiLayerNetwork") - before,
        "ms_per_epoch": ms1, "uninterrupted_ms_per_epoch": ms0}
    t = time.monotonic()
    out["width"] = cluster_width(rank, meshes, it, h0, p0)
    out["width"]["s"] = time.monotonic() - t
    if rank == 0:  # the one-device reference, in this rank alone
        one = build_network("mnist_mlp", "float32", CLUSTER_DEVICE)
        h1d = one.fit_epochs(it, CLUSTER_EPOCHS)
        params_1d = tree_map(torch.clone, one.params)
        one_cache = one.build_epoch_cache(it)
        out["one_cache_bytes"] = _cache_bytes(one_cache)
        _, ms, _ = _timed_barrier_free(  # replays, once captured
            lambda: one.fit_epochs(one_cache, CLUSTER_EPOCHS))
        out["one_ms_per_epoch"] = ms / CLUSTER_EPOCHS
        del one_cache
        for fsdp in (False, True):
            c = out[f"fsdp={fsdp}"]
            h = torch.tensor(c["hist"], device=h1d.device)
            c["ok"] = (torch.allclose(h, h1d.float(), **CLUSTER_TOL)
                       and tree_close(c["_params"], params_1d,
                                      **CLUSTER_TOL))
            c["param_err"] = tree_err(c["_params"], params_1d)
    for fsdp in (False, True):
        del out[f"fsdp={fsdp}"]["_params"]
    return out


def _width_fit(rank: int, w, it, on_boundary, slow_first: bool = False):
    """``w.fit_epochs`` one epoch a chunk, ``on_boundary(done, stall_s,
    wall_s)`` deciding at each boundary, in every rank alike, the next
    mesh (``False``: none); per chunk, this rank's wall ms from the
    chunk's ``epoch.chunk`` site to its boundary (a parked rank's is idle
    time), whether it sat the chunk out, its stall at the site and the
    watchdog's deadline; rank 3's first chunk stalls at the site when
    ``slow_first``."""
    from deeplearning4j_tpu_torch.resilience import faults

    clock = {"chunks": 0}
    chunks = []
    slow = faults.delay(CLUSTER_SLOW_MS)

    def site(name):
        clock["enter"] = time.perf_counter()
        if slow_first and rank == 3 and clock["chunks"] == 0:
            slow(name)
        clock["chunks"] += 1
        clock["stall"] = time.perf_counter() - clock["enter"]

    def on_chunk(done):
        _cluster_sync()
        chunks.append({
            "ms": (time.perf_counter() - clock["enter"]) * 1e3,
            "parked": w._parked, "stall_s": clock["stall"],
            "deadline_s": w.network._chunk_watchdog.deadline_s})
        mesh = on_boundary(done, clock["stall"],
                           (time.perf_counter() - clock["enter"]))
        if mesh is not False:
            w.request_reshard(mesh)
        return False

    faults.install("epoch.chunk", site)
    try:
        hist = w.fit_epochs(it, len(CLUSTER_WIDTHS), chunk_epochs=1,
                            on_chunk=on_chunk)
    finally:
        faults.clear()
    params = w.gather()[0]
    digest = hashlib.sha256(hist.detach().cpu().numpy().tobytes())
    return hist, params, chunks, digest.hexdigest()


def cluster_width(rank: int, meshes: dict, it, h0, p0) -> dict:
    """(b)'s width cell: the run over ``data=4 → ranks [1,2,3] → ranks
    [0,1] → data=4`` (one epoch each; rank 0 parks for the second, ranks
    2 and 3 for the third), and the autopilot's shrink and readmit (rank
    3's first chunk stalls at its ``epoch.chunk`` site; rank 0's
    ``GoodputAutopilot`` evicts it and reshards onto ranks [0,1,2], then
    readmits it), each against the uninterrupted ``data=4`` run ``(h0,
    p0)`` at the elastic gate; every rank's history must be the lead's,
    bitwise."""
    import statistics

    import torch
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.monitor import metrics
    from deeplearning4j_tpu_torch.parallel import (
        MeshSpec, ParallelWrapper, build_mesh)
    from deeplearning4j_tpu_torch.resilience import GoodputAutopilot

    counter = metrics().counter("elastic_reshards_total")
    sub = {"ranks [1,2,3]": build_mesh(MeshSpec(data=3), ranks=[1, 2, 3],
                                       device=CLUSTER_DEVICE),
           "ranks [0,1]": build_mesh(MeshSpec(data=2), ranks=[0, 1],
                                     device=CLUSTER_DEVICE),
           "data=4": meshes["data=4"]}
    out = {}

    def gate(name, hist, params, chunks, digest, reshards, **extra):
        out[name] = {
            "ok": (torch.allclose(hist, h0, **CLUSTER_ELASTIC_TOL)
                   and tree_close(params, p0, **CLUSTER_ELASTIC_TOL)),
            "hist_err": float((hist - h0).abs().max()),
            "param_err": tree_err(params, p0), "chunks": chunks,
            "digest": digest, "reshards": reshards, **extra}

    before = counter.value(model="MultiLayerNetwork")
    w = ParallelWrapper(build_network("mnist_mlp", "float32",
                                      CLUSTER_DEVICE), mesh=sub["data=4"])
    res = _width_fit(rank, w, it, lambda done, stall, wall: sub[
        CLUSTER_WIDTHS[done]] if done < len(CLUSTER_WIDTHS) else False)
    gate("widths", *res,
         counter.value(model="MultiLayerNetwork") - before)

    before = counter.value(model="MultiLayerNetwork")
    w = ParallelWrapper(build_network("mnist_mlp", "float32",
                                      CLUSTER_DEVICE), mesh=sub["data=4"])
    n = dist.get_world_size()
    wanted, decisions, widths = [], [], {}
    ap = GoodputAutopilot(
        floor=50.0, silence_s=1e9, straggler_ticks=1, cooldown_s=1e9,
        evict=lambda member, d: None,
        reshard=lambda healthy, d: wanted.append(
            [int(h.split("-")[1]) for h in healthy]),
        readmit=lambda member, d: wanted.append(list(range(n))))

    def decide(done, stall, wall):
        stalls = [None] * n
        dist.all_gather_object(stalls, stall)
        box = [None]
        if rank == 0:
            mid = statistics.median(stalls)
            fleet = {f"rank-{r}": {"step_s": wall, "stall_s": v}
                     for r, v in enumerate(stalls)}
            asked = len(wanted)
            decisions.extend(d.action for d in ap.observe(
                fleet, stragglers=[f"rank-{r}" for r, v in enumerate(stalls)
                                   if v > mid + CLUSTER_SLOW_MS / 2e3],
                last_beat={m: float(done) for m in fleet},
                goodput_pct=100.0 * max(0.0, 1.0 - max(stalls) / wall),
                now=float(done)))
            box = [wanted[-1] if len(wanted) > asked else None]
        dist.broadcast_object_list(box, src=0)
        if box[0] is None:
            return False
        widths[str(done)] = box[0]  # JSON keys
        return sub["data=4"] if len(box[0]) == n else build_mesh(
            MeshSpec(data=len(box[0])), ranks=box[0], device=CLUSTER_DEVICE)

    res = _width_fit(rank, w, it, decide, slow_first=True)
    gate("autopilot", *res,
         counter.value(model="MultiLayerNetwork") - before,
         decisions=decisions, widths=widths)
    return out


def cluster_w2v(rank: int, meshes: dict, launches: dict) -> dict:
    """(c) ``DistributedWord2Vec`` on bench_word2vec over ``data=4``
    (``dp``) and row-sharded over ``model=4`` (``rows``); rank 0 also
    runs the one-device fused ``fit_epochs`` (the same plan: every run
    draws it from the same seeds)."""
    import torch
    from deeplearning4j_tpu_torch.nlp import CollectionSentenceIterator
    from deeplearning4j_tpu_torch.nlp.distributed import DistributedWord2Vec

    sentences, _ = zipf_corpus(W2V_SENTENCES, W2V_VOCAB)
    out = {}
    for name in ("data=4", "model=4"):
        mesh = meshes[name]
        dw = DistributedWord2Vec(CollectionSentenceIterator(sentences),
                                 mesh=mesh, seed=44, device=CLUSTER_DEVICE,
                                 **W2V_CFG)
        dw.build_vocab()
        dw.reset_weights()
        mode = dw._fused_mode(mesh)
        cache = dw.build_corpus_cache(mesh=mesh)
        torch.cuda.reset_peak_memory_stats()
        hist, ms, n = _epoch_ms(lambda: dw.fit_epochs(CLUSTER_W2V_EPOCHS),
                                CLUSTER_W2V_EPOCHS)
        _sum_launches(launches, n)
        syn0, syn1neg = dw.gather_tables()
        out[name] = {"mode": mode, "vocab": dw.vocab.num_words(),
                     "rows_this_rank": int(dw.syn0.shape[0]),
                     "batch": cache.batch, "batches": cache.n_batches,
                     "words_per_sec": cache.n_words / (ms / 1e3),
                     "ms_per_epoch": ms, "hist": hist.tolist(),
                     "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                     "_tables": (syn0, syn1neg)}
    if rank == 0:
        from deeplearning4j_tpu_torch.nlp import Word2Vec

        one = Word2Vec(CollectionSentenceIterator(sentences), seed=44,
                       device=CLUSTER_DEVICE, **W2V_CFG)
        one.build_vocab()
        one.reset_weights()
        cache = one.build_corpus_cache()
        one.fit_epochs(1)  # warm-up: capture
        one = Word2Vec(CollectionSentenceIterator(sentences), seed=44,
                       device=CLUSTER_DEVICE, **W2V_CFG)
        one.build_vocab()
        one.reset_weights()
        one.build_corpus_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h1d = one.fit_epochs(CLUSTER_W2V_EPOCHS)
        torch.cuda.synchronize()
        out["one_words_per_sec"] = (cache.n_words * CLUSTER_W2V_EPOCHS
                                    / (time.perf_counter() - t0))
        for name in ("data=4", "model=4"):
            c = out[name]
            s0, s1 = c["_tables"]
            h = torch.tensor(c["hist"], device=h1d.device)
            c["err"] = max(float((h - h1d).abs().max()),
                           float((s0 - one.syn0).abs().max()),
                           float((s1 - one.syn1neg).abs().max()))
            c["ok"] = c["err"] <= CLUSTER_W2V_ATOL
    for name in ("data=4", "model=4"):
        del out[name]["_tables"]
    return out


def cluster_resume(rank: int, meshes: dict, launches: dict,
                   tmp: str) -> dict:
    """(d) ``FaultTolerantTrainer`` with a ``FileStateTracker``: (b)'s
    wrapper preempted after epoch 1 and resumed over ``data=2 × model=2``
    to the end, beside the uninterrupted run; the ranks' heartbeats."""
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel import (
        FaultTolerantTrainer, FileStateTracker, ParallelWrapper)
    from deeplearning4j_tpu_torch.resilience import faults
    from deeplearning4j_tpu_torch.resilience.preemption import (
        PreemptionGuard)

    m4, m22 = meshes["data=4"], meshes["data=2 x model=2"]
    it = ListDataSetIterator(epoch_data(), EPOCH_BATCH)
    tracker = FileStateTracker(os.path.join(tmp, "tracker"))
    ck = os.path.join(tmp, "ck")

    def trainer(w):
        return FaultTolerantTrainer(w, ck, tracker=tracker,
                                    worker_id=f"rank-{rank}",
                                    heartbeat_interval_s=0.1)

    base = ParallelWrapper(build_network("mnist_mlp", "float32", CLUSTER_DEVICE),
                           mesh=m4)
    base.fit_epochs(it, CLUSTER_EPOCHS, chunk_epochs=1)
    first = trainer(ParallelWrapper(
        build_network("mnist_mlp", "float32", CLUSTER_DEVICE), mesh=m4))
    faults.install("preempt.chunk", faults.fail_nth(1))
    try:
        (_, ms_pre, n) = _epoch_ms(lambda: first.fit_epochs(
            it, CLUSTER_EPOCHS, preemption=PreemptionGuard(signals=())), 1)
    finally:
        faults.clear()
    _sum_launches(launches, n)
    again = trainer(ParallelWrapper(
        build_network("mnist_mlp", "float32", CLUSTER_DEVICE), mesh=m4))
    t0 = time.perf_counter()
    resumed = again.resume(mesh=m22)
    resume_ms = (time.perf_counter() - t0) * 1e3
    (_, ms_post, n) = _epoch_ms(lambda: again.fit_epochs(it, CLUSTER_EPOCHS),
                                1)
    _sum_launches(launches, n)
    got, want = again.network.gather()[0], base.gather()[0]
    dist.barrier()
    return {"preempted": first.preempted, "resumed": resumed,
            "ok": tree_close(got, want, **CLUSTER_ELASTIC_TOL),
            "param_err": tree_err(got, want), "resume_ms": resume_ms,
            "preempted_run_ms": ms_pre, "resumed_run_ms": ms_post,
            "w_this_rank": list(again.model.params["0"]["W"].shape),
            "workers": sorted(tracker.workers()),
            "pointer": os.path.basename(
                str(tracker.get_meta("latest_checkpoint")))}


def cluster_rank(rank: int, n: int, tmp: str) -> None:
    """One rank of phase 17's 4-process gloo world; writes its results
    to ``cluster<r>.json`` in ``tmp``."""
    import torch

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, HERE)
    from deeplearning4j_tpu_torch.parallel import (
        MeshSpec, build_mesh, join_world, leave_world)

    out = {"rank": rank}
    launches = {}
    t0 = time.monotonic()
    join_world(os.path.join(tmp, "cluster_store"), rank, n, backend="gloo",
               timeout_s=MESH_JOIN_TIMEOUT_S)
    out["join_s"] = time.monotonic() - t0
    try:
        meshes = {
            "data=4": build_mesh(MeshSpec(data=n), device=CLUSTER_DEVICE),
            "data=2 x model=2": build_mesh(MeshSpec(data=2, model=n // 2),
                                           device=CLUSTER_DEVICE),
            "model=4": build_mesh(MeshSpec(data=1, model=n),
                                  device=CLUSTER_DEVICE)}
        for name, fn in (
                ("epochs", lambda: cluster_epochs(rank, meshes, launches)),
                ("w2v", lambda: cluster_w2v(rank, meshes, launches)),
                ("resume", lambda: cluster_resume(rank, meshes, launches,
                                                  tmp))):
            t = time.monotonic()
            out[name] = fn()
            out[f"{name}_s"] = time.monotonic() - t
            torch.cuda.empty_cache()
    except Exception:
        out["error"] = traceback.format_exc()
    finally:
        leave_world()
    out["launches"] = launches
    with open(os.path.join(tmp, f"cluster{rank}.json"), "w") as f:
        json.dump(out, f)
    if "error" in out:
        sys.exit(1)


def cluster_router(card: str) -> dict:
    """(e) ``DistributedTrainer`` with ``IterativeReduceWorkRouter`` and 4
    ``NetworkWorkPerformer`` threads on the card, no process group: one
    ``[4096, 784]`` job each from the published start, against 4 clones'
    fits averaged."""
    import threading

    import numpy as np
    from deeplearning4j_tpu_torch.parallel import (
        DistributedTrainer, InMemoryStateTracker, IterativeReduceWorkRouter,
        NetworkWorkPerformer)

    proto = build_network("mnist_mlp", "float32", CLUSTER_DEVICE)
    conf_json = proto.conf.to_json()
    start = proto.get_flat_params()
    jobs = [{"features": b.features, "labels": b.labels}
            for b in mesh_batches(CLUSTER_JOBS)]
    tracker = InMemoryStateTracker()
    router = IterativeReduceWorkRouter(tracker)
    tracker.put_array("global_params", start)
    barrier = threading.Barrier(CLUSTER_JOBS)

    class OneJobEach(NetworkWorkPerformer):
        def perform(self, payload):
            barrier.wait(timeout=120)  # each thread takes one job
            return super().perform(payload)

    trainer = DistributedTrainer(
        tracker, router,
        lambda: OneJobEach(conf_json, device=CLUSTER_DEVICE),
        num_workers=CLUSTER_JOBS, heartbeat_interval_s=0.2)
    for job in jobs:
        tracker.add_job(job)
    t0 = time.perf_counter()
    got = np.asarray(trainer.train(timeout_s=300), np.float32)
    wall = time.perf_counter() - t0
    fits = []
    for job in jobs:
        clone = build_network("mnist_mlp", "float32", CLUSTER_DEVICE)
        clone.set_flat_params(start)
        from deeplearning4j_tpu_torch.datasets import DataSet

        clone.fit(DataSet(job["features"], job["labels"]))
        fits.append(clone.get_flat_params())
    want = np.mean(np.stack(fits), axis=0)
    ok = bool(np.allclose(got, want, **CLUSTER_TOL))
    err = float(np.abs(got - want).max())
    print(f"cluster (e) DistributedTrainer IterativeReduceWorkRouter "
          f"{CLUSTER_JOBS} NetworkWorkPerformer threads, mnist_mlp float32 "
          f"[{MESH_MLP_BATCH}, 784] jobs: rounds {router.rounds}, averaged "
          f"params against {CLUSTER_JOBS} clones' fits averaged "
          f"max_abs_err={err:.3e} (rtol 1e-4, atol 1e-6) "
          f"{'ok' if ok else 'MISMATCH'}; {wall:.2f} s [{card}]")
    if not ok or router.rounds != 1:
        raise AssertionError("the work router's average differs from the "
                             "clones' fits averaged")
    return {"wall_s": wall, "err": err}


def cluster_cli(card: str, tmp: str) -> dict:
    """(f) ``train -runtime multihost`` as 4 processes meeting on
    ``127.0.0.1`` (gloo, sharing the card), the model zip against
    ``-runtime local``'s at rtol 1e-4."""
    import socket

    import io

    import numpy as np
    from deeplearning4j_tpu_torch.cli import main as cli_main
    from deeplearning4j_tpu_torch.utils import ModelSerializer

    rng = np.random.default_rng(3)
    x = rng.normal(size=(CLI_MH_ROWS, CLI_MH_FEATURES)).astype(np.float32)
    y = (x[:, :8].sum(1) > 0).astype(np.int64)
    data = os.path.join(tmp, "mh.csv")
    np.savetxt(data, np.concatenate([x, y[:, None]], axis=1),
               fmt=["%.5f"] * CLI_MH_FEATURES + ["%d"], delimiter=",")
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf import layers as L

    conf = (NeuralNetConfiguration.Builder().seed(7).learning_rate(0.1)
            .list()
            .layer(0, L.DenseLayer(n_in=CLI_MH_FEATURES, n_out=128,
                                   activation="tanh"))
            .layer(1, L.OutputLayer(n_in=128, n_out=2,
                                    activation="softmax")).build())
    model = os.path.join(tmp, "mh.json")
    with open(model, "w") as f:
        f.write(conf.to_json())
    common = [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "train",
              "-input", data, "-model", model, "--num-classes", "2",
              "--batch-size", str(CLI_MH_BATCH), "--epochs", "2"]
    env = {**os.environ, "PYTHONPATH": HERE}
    if CLUSTER_DEVICE == "cpu":
        common += ["--device", "cpu"]
    local = os.path.join(tmp, "local.zip")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # in this process
        cli_main(common[3:] + ["-output", local])
    local_s = time.perf_counter() - t0
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = os.path.join(tmp, "multihost.zip")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        common + ["-output", out, "-runtime", "multihost", "--coordinator",
                  f"127.0.0.1:{port}", "--num-processes", str(CLI_MH_PROCS),
                  "--process-id", str(r)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(CLI_MH_PROCS)]
    try:
        logs = [p.communicate(timeout=CLI_TIMEOUT_S)[0].decode()
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    wall = time.perf_counter() - t0
    if any(p.returncode for p in procs):
        raise AssertionError("multihost CLI: " + " | ".join(
            log[-1500:] for log in logs))
    a = ModelSerializer.restore(local, device=CLUSTER_DEVICE)
    b = ModelSerializer.restore(out, device=CLUSTER_DEVICE)
    ok = tree_close(b.params, a.params, rtol=1e-4, atol=1e-6)
    err = tree_err(b.params, a.params)
    print(f"cluster (f) cli train -runtime multihost {CLI_MH_PROCS} "
          f"processes on 127.0.0.1 (gloo, one card), [{CLI_MH_ROWS}, "
          f"{CLI_MH_FEATURES}] CSV, batch {CLI_MH_BATCH}, 2 epochs: zip "
          f"against -runtime local max_abs_err={err:.3e} (rtol 1e-4) "
          f"{'ok' if ok else 'MISMATCH'}; wall {wall:.1f} s (-runtime "
          f"local in this process {local_s:.1f} s) [{card}]")
    if not ok:
        raise AssertionError("the multihost CLI's model differs from the "
                             "local one")
    return {"wall_s": wall, "local_s": local_s}


def cluster_width_lines(ranks: list, card: str) -> list:
    """Print (b)'s width cell from every rank's results; its failures."""
    failures = []
    wd = ranks[0]["epochs"]["width"]
    for name, want in (("widths", 3), ("autopilot", 2)):
        c = wd[name]
        per = [r["epochs"]["width"][name]["chunks"] for r in ranks]
        labels = list(CLUSTER_WIDTHS)
        if name == "autopilot":  # the mesh each chunk ran on
            labels, cur = [], "data=4"
            for d in range(len(CLUSTER_WIDTHS)):
                got = c["widths"].get(str(d))
                if got is not None:
                    cur = ("data=4" if len(got) == len(ranks)
                           else f"ranks {got}")
                labels.append(cur)
        steps = []
        for e, label in enumerate(labels):
            members = [p[e]["ms"] for p in per if not p[e]["parked"]]
            idle = {r: round(p[e]["ms"], 1) for r, p in enumerate(per)
                    if p[e]["parked"]}
            steps.append(f"{label}: {max(members):.1f} ms an epoch, "
                         f"deadline {per[0][e]['deadline_s']:.0f} s"
                         + (f", parked ranks idle {idle} ms" if idle else ""))
        same = len({r["epochs"]["width"][name]["digest"] for r in ranks}) == 1
        extra = (f"; decisions {c['decisions']}, shrink/readmit at "
                 f"boundaries {c['widths']}" if name == "autopilot" else "")
        print(f"cluster (b) width {name} mnist_mlp float32 [{EPOCH_BATCHES} x "
              f"{EPOCH_BATCH}, 784] against the uninterrupted data="
              f"{MESH_RANKS} run: hist_err {c['hist_err']:.3e}, param_err "
              f"{c['param_err']:.3e} (rtol 2e-4, atol 1e-5) "
              f"{'ok' if c['ok'] else 'MISMATCH'}; reshards {c['reshards']}; "
              f"every rank's history the lead's bitwise: {same}; "
              + "; ".join(steps) + extra + f"; cell {wd['s']:.1f} s [{card}]")
        if not c["ok"] or c["reshards"] != want or not same:
            failures.append(f"width {name}")
    if wd["autopilot"]["decisions"] != ["evict", "reshard", "readmit"]:
        failures.append("width autopilot decisions")
    return failures


def cluster_phase(card: str) -> dict:
    """Phase 17; returns B1–B3's launches over it, the parent's and the
    ranks' summed (0 each: nothing on its path runs attention)."""
    import tempfile

    from deeplearning4j_tpu_torch.perf import step_graph

    t_phase = time.monotonic()
    before = step_graph.kernel_launches()
    with tempfile.TemporaryDirectory(prefix="dl4j_cluster_") as tmp:
        cluster_world_one(card, tmp)
        t0 = time.monotonic()
        codes = spawn_world("cluster_rank", tmp, CLUSTER_WORLD_TIMEOUT_S)
        bad = [r for r, c in enumerate(codes) if c != 0]
        if bad:
            for r in bad:
                with open(os.path.join(tmp, f"cluster_rank{r}.log")) as f:
                    log = f.read()[-3000:]
                res = os.path.join(tmp, f"cluster{r}.json")
                if os.path.exists(res):
                    with open(res) as f:
                        log += json.load(f).get("error", "")[-3000:]
                print(f"cluster rank {r} exited {codes[r]}:\n{log}",
                      file=sys.stderr)
            raise AssertionError(f"cluster world: rank(s) {bad} failed or "
                                 f"timed out ({CLUSTER_WORLD_TIMEOUT_S} s)")
        ranks = []
        for r in range(MESH_RANKS):
            with open(os.path.join(tmp, f"cluster{r}.json")) as f:
                ranks.append(json.load(f))
        world_s = time.monotonic() - t0
        router = cluster_router(card)
        cli = cluster_cli(card, tmp)
    print(f"cluster world{MESH_RANKS} (gloo, one card): {world_s:.1f} s; "
          f"per rank join " + ", ".join(f"{r['join_s']:.1f}" for r in ranks)
          + " s; cells " + ", ".join(
              f"{c} {max(r[c + '_s'] for r in ranks):.1f} s"
              for c in ("epochs", "w2v", "resume")))
    r0 = ranks[0]
    failures = []
    ep = r0["epochs"]
    for fsdp in (False, True):
        c = ep[f"fsdp={fsdp}"]
        per_rank = [r["epochs"][f"fsdp={fsdp}"] for r in ranks]
        print(f"cluster (b) ParallelWrapper(fsdp={fsdp}).fit_epochs over "
              f"data={MESH_RANKS} mnist_mlp float32 [{EPOCH_BATCHES} x "
              f"{EPOCH_BATCH}, 784] x{CLUSTER_EPOCHS}: against one device "
              f"param_err={c['param_err']:.3e} (rtol 1e-4, atol 1e-6) "
              f"{'ok' if c['ok'] else 'MISMATCH'}; ms an epoch "
              f"{[round(p['ms_per_epoch'], 1) for p in per_rank]} (one "
              f"device {ep['one_ms_per_epoch']:.1f}); cache bytes per rank "
              f"{[p['cache_bytes_this_rank'] for p in per_rank]} (one "
              f"device {ep['one_cache_bytes']}); params per rank "
              f"{[p['params_this_rank'] for p in per_rank]}; peak_mem_bytes "
              f"per rank {[p['peak_mem_bytes'] for p in per_rank]} [{card}]")
        if not c["ok"]:
            failures.append(f"fit_epochs fsdp={fsdp}")
        if any(4 * p["cache_bytes_this_rank"] != ep["one_cache_bytes"]
               for p in per_rank):
            failures.append(f"fsdp={fsdp}: a rank's cache is not a quarter "
                            "of one device's")
    el = ep["elastic"]
    print(f"cluster (b) elastic fit_epochs data={MESH_RANKS} -> None -> "
          f"data=2 x model=2 -> data={MESH_RANKS} (1 epoch each) against "
          f"the uninterrupted data={MESH_RANKS} run: hist_err "
          f"{el['hist_err']:.3e}, param_err {el['param_err']:.3e} (rtol "
          f"2e-4, atol 1e-5) {'ok' if el['ok'] else 'MISMATCH'}; reshards "
          f"{el['reshards']}; ms an epoch "
          f"{max(r['epochs']['elastic']['ms_per_epoch'] for r in ranks):.1f}"
          f" (uninterrupted "
          f"{max(r['epochs']['elastic']['uninterrupted_ms_per_epoch'] for r in ranks):.1f}) "
          f"[{card}]")
    if not el["ok"] or el["reshards"] != 3:
        failures.append("elastic reshard")
    failures += cluster_width_lines(ranks, card)
    w2 = r0["w2v"]
    for name, mode in (("data=4", "dp"), ("model=4", "rows")):
        c = w2[name]
        print(f"cluster (c) DistributedWord2Vec [{W2V_SENTENCES} x "
              f"{W2V_LEN}] vocab {c['vocab']} d{W2V_CFG['layer_size']} over "
              f"{name}: mode {c['mode']}, rows per rank "
              f"{[r['w2v'][name]['rows_this_rank'] for r in ranks]}, batch "
              f"{c['batch']} x {c['batches']}; against the one-device fused "
              f"epoch max_abs_err={c['err']:.3e} (atol {CLUSTER_W2V_ATOL}) "
              f"{'ok' if c['ok'] else 'MISMATCH'}; words/s "
              f"{min(r['w2v'][name]['words_per_sec'] for r in ranks):.0f} "
              f"(one device {w2['one_words_per_sec']:.0f}); peak_mem_bytes "
              f"per rank {[r['w2v'][name]['peak_mem_bytes'] for r in ranks]}"
              f" [{card}]")
        if c["mode"] != mode or not c["ok"]:
            failures.append(f"w2v {name}")
    rs = r0["resume"]
    print(f"cluster (d) FaultTolerantTrainer(FileStateTracker) preempted "
          f"after epoch 1 over data={MESH_RANKS}, resume(mesh=data=2 x "
          f"model=2) to epoch {CLUSTER_EPOCHS}: preempted "
          f"{rs['preempted']}, resumed {rs['resumed']}, param_err "
          f"{rs['param_err']:.3e} against the uninterrupted run (rtol 2e-4, "
          f"atol 1e-5) {'ok' if rs['ok'] else 'MISMATCH'}; W per rank "
          f"{rs['w_this_rank']}; resume {rs['resume_ms']:.1f} ms; "
          f"heartbeats {rs['workers']}; pointer {rs['pointer']} [{card}]")
    if not (rs["preempted"] and rs["resumed"] and rs["ok"]) or rs[
            "workers"] != [f"rank-{r}" for r in range(MESH_RANKS)]:
        failures.append("resume over a mesh")
    launches = _launch_delta(before)
    for r in ranks:
        _sum_launches(launches, r["launches"])
    if any(launches.values()):
        failures.append(f"B1-B3 launched on the cluster path: {launches}")
    if failures:
        raise AssertionError("cluster: " + "; ".join(failures))
    print(f"cluster phase: {time.monotonic() - t_phase:.1f} s, B1-B3 "
          f"launches {launches} (router {router['wall_s']:.1f} s, cli "
          f"{cli['wall_s']:.1f} s) [{card}]")
    return launches


# ---------------------------------------------------------------------------
# phase 18: the last host-side modules (A15) — the served model's fleet
# under grant leases and the goodput autopilot, the program contracts on
# the captured programs, the training UI and the ml pipeline
# ---------------------------------------------------------------------------
A15_DEVICE = "cuda"  # "cpu" only to rehearse the phase
# r0 starts clean, r1's first acquisition fails at the grant.lease fault
# site and is re-acquired, r2's lease is exhausted (it dies and is
# evicted), r3 is slowed and the autopilot evicts it. The straggler rule
# needs three replicas reporting (workrouter.update_straggler_flags), so
# the fleet has a fourth beside the three the cases name.
A15_REPLICAS = 4
A15_LEASE_FAULTS = {"r1": 1, "r2": 3}  # grant.lease failures at start
A15_REACQUIRES = 2
A15_BACKOFF_S = 0.05
A15_REQUESTS, A15_RATE = 16, 200.0
A15_SLOW_MS = 300.0  # r3's fault hook: a delay before each loop step
A15_TICK_S = 0.05  # the controller's tick
A15_UI_BATCH, A15_UI_FITS = 64, 3  # LeNet-5 fit under the three listeners
A15_UI_RTOL = 1e-5
A15_ML_ROWS, A15_ML_EPOCHS, A15_ML_BATCH = 2048, 1, 256
A15_ML_TOL = dict(rtol=2e-3, atol=1e-3)  # the train phase's float32 gate
A15_SEEDED = (64, 4)  # the seeded-violation network's batch and batches


def _a15_sync() -> None:
    import torch

    if A15_DEVICE != "cpu":
        torch.cuda.synchronize()


def a15_fleet(card: str) -> dict:
    """(a): the d512·L8 serve model (``mixed_bf16``) on A15_REPLICAS
    replicas, each started under a ``GrantLease`` around its warm-up (the
    kernel library loaded and one B1 prefill), served threaded under a
    ``FleetController`` with a ``GoodputAutopilot``. Every stream must
    equal ``lm.generate``; r2 is evicted as crashed (its lease wedged),
    r3 by the autopilot's straggler streak; the flight recorder must
    classify the run ``reacquired`` and the ledger book the re-acquire as
    ``grant_wait``; B1 launches num_layers times per prefill."""
    import tempfile

    import numpy as np
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    from deeplearning4j_tpu_torch.monitor import tracer
    from deeplearning4j_tpu_torch.monitor.flight import (
        FlightRecorder, classify_end_state, load_flight_records, set_flight)
    from deeplearning4j_tpu_torch.monitor.ledger import (
        RunLedger, ledger_chunk_done, ledger_chunk_start, ledger_run_end,
        ledger_run_start, set_run_ledger)
    from deeplearning4j_tpu_torch.resilience import (
        GoodputAutopilot, GrantLease, faults)
    from deeplearning4j_tpu_torch.serving.fleet import (
        FleetController, FleetRouter, ServeReplica)

    layers = SERVE_CFG["num_layers"]
    lm = TransformerLM(**SERVE_CFG, device=A15_DEVICE).init()
    sched = serve_schedule(A15_REQUESTS, A15_RATE, seed=9)
    refs = {a.prompt.tobytes(): lm.generate(
        a.prompt[None], a.max_new_tokens)[0].cpu().numpy() for a in sched}
    reps = [ServeReplica(f"r{i}", lm, slots=SERVE_SLOTS,
                         max_len=SERVE_MAX_LEN, device=A15_DEVICE)
            for i in range(A15_REPLICAS)]
    prefills = {"n": 0}
    for r in reps:  # count every prefill (admissions and replays)
        def counted(*a, _inner=r.server.engine.prefill, **kw):
            prefills["n"] += 1
            return _inner(*a, **kw)

        r.server.engine.prefill = counted
    flight_dir = tempfile.mkdtemp(prefix="a15_flight_")
    rec = FlightRecorder(flight_dir, heartbeat_s_=60.0)
    ledger = RunLedger(span_source=lambda: tracer().spans())
    set_flight(rec)
    set_run_ledger(ledger)
    router = FleetRouter(reps)
    ap = GoodputAutopilot(floor=0.0, silence_s=1e9, straggler_ticks=2)
    controller = FleetController(router, None, evict_timeout_s=60.0,
                                 autopilot=ap)
    acquire_ms, warm = {}, {}
    try:
        ledger_run_start(model="a15_fleet", replicas=A15_REPLICAS)
        for r in reps:
            n_faults = A15_LEASE_FAULTS.get(r.replica_id)
            r.lease = GrantLease(r.replica_id, r.warm_up,
                                 max_reacquires=A15_REACQUIRES,
                                 base_backoff_s=A15_BACKOFF_S)
            b0 = launch_counts()["flash_attention_fwd"]
            if n_faults:
                faults.install("grant.lease", faults.fail_times(n_faults))
            t = time.perf_counter()
            try:
                r.start()
            finally:
                if n_faults:
                    faults.uninstall("grant.lease")
            acquire_ms[r.replica_id] = (time.perf_counter() - t) * 1e3
            warm[r.replica_id] = launch_counts()["flash_attention_fwd"] - b0
        states = {r.replica_id: (r.lease.state, r.lease.reacquires)
                  for r in reps}
        print(f"a15 fleet leases: acquire_ms (kernel load and first B1 "
              f"prefill included) "
              f"{ {k: round(v, 3) for k, v in acquire_ms.items()} } "
              f"state,reacquires={states} warm-up B1 launches={warm} "
              f"dead={[r.replica_id for r in reps if r.dead]} [{card}]")
        if states != {"r0": ("held", 0), "r1": ("held", 1),
                      "r2": ("wedged", 0), "r3": ("held", 0)}:
            raise AssertionError(f"lease states {states}")
        if not reps[2].dead or reps[0].dead or reps[1].dead or reps[3].dead:
            raise AssertionError("only r2 must die at start")
        if any(warm[k] != layers for k in ("r0", "r1", "r3")) or warm["r2"]:
            raise AssertionError(f"warm-up B1 launches {warm}")
        before = launch_counts()
        prefills["n"] = 0
        ledger_chunk_start()
        faults.install("serve.replica.step.r3", faults.delay(A15_SLOW_MS))
        frs = [router.submit(a.prompt, a.max_new_tokens) for a in sched]
        t0 = time.monotonic()
        controller.start(interval_s=A15_TICK_S)
        while time.monotonic() - t0 < 300 and router.unfinished():
            time.sleep(0.02)
        wall = time.monotonic() - t0
        ledger_chunk_done()
        ledger_run_end(status="clean")
    finally:
        faults.uninstall("serve.replica.step.r3")
        controller.stop()
        for r in reps:
            r.stop()
        set_flight(None)
        set_run_ledger(None)
        rec.close()
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    lost = sum(1 for fr in frs if not fr.finished)
    diverged = [fr for fr in frs if fr.finished and not np.array_equal(
        fr.output, refs[fr.prompt.tobytes()])]
    tokens = sum(int(fr.output.shape[0] - fr.prompt.shape[0])
                 for fr in frs if fr.finished)
    verdict = classify_end_state(load_flight_records(flight_dir))
    grant_wait = ledger.report()["states"].get("grant_wait", 0.0)
    for d in ap.decisions:
        print(f"a15 fleet autopilot decision: {json.dumps(d.to_json())} "
              f"[{card}]")
    print(f"a15 fleet served: requests={len(frs)} finished="
          f"{len(frs) - lost} lost={lost} diverged={len(diverged)} "
          f"evicted={controller.evicted} reasons="
          f"{[e['reason'][:60] for e in controller.eviction_log]} "
          f"wall_s={wall:.3f} tokens={tokens} tokens_per_sec="
          f"{tokens / wall:.1f} prefills={prefills['n']} B1={launches['flash_attention_fwd']} "
          f"B2={launches['flash_attention_bwd_dkdv']} "
          f"B3={launches['flash_attention_bwd_dq']} flight_end_state="
          f"{verdict['end_state']} ledger_grant_wait_s={grant_wait:.4f} "
          f"[{card}]")
    if lost or diverged:
        raise AssertionError(
            f"{lost} request(s) lost, {len(diverged)} diverged"
            + ("" if not diverged else ": " + first_divergence(
                diverged[0].output, refs[diverged[0].prompt.tobytes()], lm,
                diverged[0].prompt)))
    if controller.evicted != ["r2", "r3"]:
        raise AssertionError(f"evicted {controller.evicted}")
    reasons = [e["reason"] for e in controller.eviction_log]
    if not (reasons[0].startswith("crashed: grant wedged")
            and reasons[1] == "autopilot:straggler_streak"):
        raise AssertionError(f"eviction reasons {reasons}")
    if [(d.action, d.target) for d in ap.decisions] != [("evict", "r3")]:
        raise AssertionError("the autopilot must decide one eviction, r3")
    if launches["flash_attention_fwd"] != layers * prefills["n"] or \
            launches["flash_attention_bwd_dkdv"] or \
            launches["flash_attention_bwd_dq"]:
        raise AssertionError(f"launches {launches} for {prefills['n']} "
                             f"prefills of {layers} layers")
    if verdict["end_state"] != "reacquired" or not grant_wait > 0:
        raise AssertionError(f"flight {verdict}, grant_wait {grant_wait}")
    return {"tokens_per_sec": tokens / wall, "acquire_ms": acquire_ms,
            "prefills": prefills["n"]}


def a15_contracts(card: str) -> None:
    """(b): the program contracts over phase 8's bench_epoch program and
    phase 13's fused skip-gram epoch (zero violations), and over a step
    seeded with a ``.item()`` and a param replaced out of place (both
    reported)."""
    from deeplearning4j_tpu_torch.analysis.contracts import (
        check_embedding_contracts, check_network_contracts)
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator

    net = build_network("mnist_mlp", "bf16", A15_DEVICE)
    cache = net.build_epoch_cache(ListDataSetIterator(epoch_data(),
                                                      EPOCH_BATCH))
    net.fit_epochs(cache, 1)
    t = time.perf_counter()
    res = check_network_contracts(net, cache, epochs=1)
    ms = (time.perf_counter() - t) * 1e3
    prog = next(iter(net._programs.values()))
    print(f"a15 contracts bench_epoch mnist_mlp [{EPOCH_BATCHES} x "
          f"{EPOCH_BATCH}, 784] bf16: programs={sorted(res)} violations="
          f"{sum(map(len, res.values()))} captures={prog.graph.captures} "
          f"replays={prog.graph.replays} eager_calls="
          f"{prog.graph.eager_calls} check_ms={ms:.1f} [{card}]")
    sentences, _ = zipf_corpus(W2V_SENTENCES, W2V_VOCAB)
    m = make_w2v(sentences, 44, A15_DEVICE)
    m.build_vocab()
    m.reset_weights()
    wcache = m.build_corpus_cache()
    m.fit_epochs(1)
    t = time.perf_counter()
    emb = check_embedding_contracts(m, wcache, epochs=1)
    ms = (time.perf_counter() - t) * 1e3
    print(f"a15 contracts fused skip-gram [{W2V_SENTENCES} x {W2V_LEN}, "
          f"d{W2V_CFG['layer_size']}]: programs={len(emb)} violations="
          f"{sum(map(len, emb.values()))} check_ms={ms:.1f} [{card}]")
    del net, cache, m, wcache
    batch, n_batches = A15_SEEDED
    bad = build_network("mnist_mlp", "bf16", A15_DEVICE)
    bcache = bad.build_epoch_cache(ListDataSetIterator(
        epoch_data(batch, n_batches), batch))
    bad.fit_epochs(bcache, 1)
    prog = next(iter(bad._programs.values()))
    body, st = prog.graph.fn, bad._static
    kept = []  # the captured graph still writes the replaced tensor

    def seeded():
        body()
        prog.row[0, 0].item()
        kept.append(st.params["0"]["W"])
        st.params["0"]["W"] = st.params["0"]["W"] * 1.0

    prog.graph.fn = seeded
    found = [v for vs in check_network_contracts(
        bad, bcache, epochs=1, raise_on_violation=False).values()
        for v in vs]
    reads = [v for v in found if "host readback" in v]
    moved = [v for v in found if "lost their storage" in v]
    print(f"a15 contracts seeded step (.item() and a param replaced out of "
          f"place): reported={len(found)} host_readback={bool(reads)} "
          f"out_of_place={bool(moved)} first={found[:2]} [{card}]")
    if not reads or not moved:
        raise AssertionError(f"the seeded violations were not both "
                             f"reported: {found}")


def _a15_json(url: str):
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read())


def _a15_close(got, want, path="$"):
    """Equal JSON trees, floats within A15_UI_RTOL of the larger one."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise AssertionError(f"{path}: keys differ")
        for k in want:
            _a15_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            raise AssertionError(f"{path}: lengths differ")
        for i, (g, w) in enumerate(zip(got, want)):
            _a15_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        if abs(got - want) > A15_UI_RTOL * max(1.0, abs(want)):
            raise AssertionError(f"{path}: {got} != {want}")
    elif got != want:
        raise AssertionError(f"{path}: {got} != {want}")


def _a15_host_copy(net, name: str, policy: str):
    """The network ``net`` on the CPU: same conf, its tensors copied."""
    from deeplearning4j_tpu_torch.dtypes import tree_map

    host = build_network(name, policy, "cpu")
    host.params = tree_map(lambda t: t.detach().cpu().clone(), net.params)
    host.net_state = tree_map(lambda t: t.detach().cpu().clone(),
                              net.net_state)
    host.iteration_count = net.iteration_count
    return host


def _a15_timed(listener, times: list):
    inner = listener.iteration_done

    def timed(model, iteration):
        t = time.perf_counter()
        inner(model, iteration)
        times.append((time.perf_counter() - t) * 1e3)

    listener.iteration_done = timed
    return listener


def a15_ui(card: str) -> None:
    """(c): an in-process ``UiServer`` on 127.0.0.1, port 0: the three
    listeners over HTTP on LeNet-5's ``fit`` and the histogram listener on
    phase 8's fused epoch through ``chunk_done``. Each GET returns what
    was posted; the histogram payload equals the CPU's for the same
    params (float32 rtol 1e-5)."""
    import json as _json

    import numpy as np
    from deeplearning4j_tpu_torch import ui
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator

    srv = ui.UiServer(port=0, host="127.0.0.1")
    try:
        net = build_network("lenet5", "bf16", A15_DEVICE)
        times = {"histogram": [], "flow": [], "conv": []}
        listeners = [
            _a15_timed(ui.HistogramIterationListener(
                url=srv.url, session_id="lenet"), times["histogram"]),
            _a15_timed(ui.FlowIterationListener(
                url=srv.url, session_id="lenet", frequency=1),
                times["flow"]),
            _a15_timed(ui.ConvolutionalIterationListener(
                url=srv.url, session_id="lenet", frequency=1, max_rows=2),
                times["conv"])]
        net.set_listeners(*listeners)
        x, y = network_data("lenet5", A15_UI_BATCH)
        for _ in range(A15_UI_FITS):
            net.fit(DataSet(x, y))
        _a15_sync()
        host = _a15_host_copy(net, "lenet5", "bf16")
        host.score_value = net.score_value
        got = _a15_json(f"{srv.url}/weights/data?sid=lenet")
        want = _json.loads(_json.dumps(ui.HistogramIterationListener(
            server=object())._payload(host, net.iteration_count)))
        grads = got.pop("gradients", None)
        _a15_close(got, want)
        flow = _a15_json(f"{srv.url}/flow/data?sid=lenet")
        _a15_close(flow["nodes"], _json.loads(_json.dumps(
            ui.FlowIterationListener.describe(host)))["nodes"])
        act = _a15_json(f"{srv.url}/activations/data?sid=lenet")
        sink = []

        class Sink:
            def post_update(self, kind, payload, sid="default"):
                sink.append(payload)

        host._last_input = x
        ui.ConvolutionalIterationListener(
            server=Sink(), frequency=1, max_rows=2).iteration_done(
            host, net.iteration_count)
        if act["shape"] != sink[0]["shape"] or act["iteration"] != \
                net.iteration_count:
            raise AssertionError("the activation tile differs")
        print(f"a15 ui lenet5 fit x{A15_UI_FITS} [{A15_UI_BATCH}, 28, 28, "
              f"1] bf16: weights GET equals the CPU payload (rtol "
              f"{A15_UI_RTOL}), gradients panel "
              f"{'present' if grads else 'missing'}, flow nodes "
              f"{len(flow['nodes'])}, activation shape {act['shape']}; ms "
              f"per firing histogram="
              f"{np.mean(times['histogram']):.3f} flow="
              f"{np.mean(times['flow']):.3f} conv="
              f"{np.mean(times['conv']):.3f} [{card}]")
        if not grads:
            raise AssertionError("no gradients panel after three fits")
        # phase 8's fused epoch, the histogram listener through chunk_done
        epoch = build_network("mnist_mlp", "bf16", A15_DEVICE)
        cache = epoch.build_epoch_cache(ListDataSetIterator(epoch_data(),
                                                            EPOCH_BATCH))
        epoch.fit_epochs(cache, 1, chunk_epochs=1)  # warm-up and capture
        wall_off, _ = timed(lambda: epoch.fit_epochs(
            cache, EPOCH_EPOCHS, chunk_epochs=1))
        fired = []
        epoch.set_listeners(_a15_timed(ui.HistogramIterationListener(
            server=srv, session_id="epoch", frequency=EPOCH_BATCHES),
            fired))
        chunks = []
        inner = epoch.listeners[0].chunk_done

        def chunk_done(model, iteration0, losses, metrics=None):
            t = time.perf_counter()
            inner(model, iteration0, losses, metrics)
            chunks.append((time.perf_counter() - t) * 1e3)

        epoch.listeners[0].chunk_done = chunk_done
        out = {}
        wall_on, _ = timed(lambda: out.setdefault("hist", epoch.fit_epochs(
            cache, EPOCH_EPOCHS, chunk_epochs=1)))
        hist = out["hist"]
        posted = _a15_json(f"{srv.url}/weights/data?sid=epoch")
        host = _a15_host_copy(epoch, "mnist_mlp", "bf16")
        want = _json.loads(_json.dumps(ui.HistogramIterationListener(
            server=object())._payload(host, epoch.iteration_count)))
        _a15_close(posted["parameters"], want["parameters"])
        curve = posted["loss_history"]["losses"]
        last = hist[-1].float().cpu().numpy()
        if not np.allclose(curve, last, rtol=A15_UI_RTOL, atol=0):
            raise AssertionError("the posted loss curve is not the chunk's")
        if len(chunks) != EPOCH_EPOCHS:
            raise AssertionError(f"chunk_done fired {len(chunks)} times")
        print(f"a15 ui fused epoch mnist_mlp [{EPOCH_BATCHES} x "
              f"{EPOCH_BATCH}, 784] bf16 x{EPOCH_EPOCHS}, chunks of 1: "
              f"chunk_done posts={len(chunks)} ms per firing="
              f"{np.mean(chunks):.3f}; epoch ms with the listener "
              f"{wall_on / EPOCH_EPOCHS * 1e3:.3f} without "
              f"{wall_off / EPOCH_EPOCHS * 1e3:.3f}; parameters and loss "
              f"curve equal the CPU's [{card}]")
    finally:
        srv.stop()


def a15_ml(card: str) -> None:
    """(d): ``NeuralNetClassification`` on the MNIST MLP conf fitted on
    the card; its predictions against a CPU run from the same carried
    weights (float32, TF32 off, the train phase's gate)."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import ml
    from deeplearning4j_tpu_torch.models import zoo

    rng = np.random.default_rng(0)
    data = {"features": rng.random((A15_ML_ROWS, 784), np.float32),
            "label": rng.integers(0, 10, A15_ML_ROWS)}
    conf = zoo.mnist_mlp(hidden=256, device="cpu").conf
    est = ml.NeuralNetClassification(conf, num_classes=10,
                                     epochs=A15_ML_EPOCHS,
                                     batch_size=A15_ML_BATCH,
                                     device=A15_DEVICE)
    t = time.perf_counter()
    model = est.fit(data)
    _a15_sync()
    fit_ms = (time.perf_counter() - t) * 1e3
    host = _a15_host_copy(model.network, "mnist_mlp", "float32")
    host_model = ml.NeuralNetClassificationModel(
        host, features_col="features", prediction_col="prediction",
        probability_col="probability")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = model.transform(data)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    want = host_model.transform(data)
    err = float(np.abs(got["probability"] - want["probability"]).max())
    ok = np.allclose(got["probability"], want["probability"], **A15_ML_TOL)
    top2 = np.sort(want["probability"], axis=1)[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) <= 2 * A15_ML_TOL["atol"]
    differ = got["prediction"] != want["prediction"]
    print(f"a15 ml NeuralNetClassification mnist_mlp [{A15_ML_ROWS}, 784] "
          f"float32 x{A15_ML_EPOCHS} epoch(s) batch {A15_ML_BATCH}: fit_ms="
          f"{fit_ms:.1f} probability max_abs_err {err:.3e} gate rtol "
          f"{A15_ML_TOL['rtol']} atol {A15_ML_TOL['atol']} ok={ok} "
          f"predictions differ on {int(differ.sum())} row(s), all near a "
          f"tie={bool(near_tie[differ].all())} [{card}]")
    if not ok or not near_tie[differ].all():
        raise AssertionError("the card's predictions differ from the CPU's")


def a15_phase(card: str) -> dict:
    """Phase 18; returns B1–B3's launches over the phase (B1 only in the
    fleet's warm-ups and prefills)."""
    t0 = time.monotonic()
    reset_launch_counts()
    fleet = a15_fleet(card)
    a15_contracts(card)
    a15_ui(card)
    a15_ml(card)
    total = launch_counts()
    if total["flash_attention_bwd_dkdv"] or total["flash_attention_bwd_dq"]:
        raise AssertionError(f"phase 18 launched a backward kernel: {total}")
    print(f"a15: phase wall {time.monotonic() - t0:.1f} s, launches {total} "
          f"(fleet prefills {fleet['prefills']}) [{card}]")
    return total


# ---------------------------------------------------------------------------
# phase 19: B1–B3 at every head dimension, and the LM at OPT-2.7B's widths
# ---------------------------------------------------------------------------
HEADDIM_DEVICE = "cuda"  # "cpu" only to rehearse the phase
# head dims from 16 to 512: at least one in each padded tier, and 300
# (wide, rows not 16-byte aligned, a partial chunk and slice)
HEADDIM_DIMS = (16, 32, 40, 60, 72, 80, 96, 100, 112, 120, 144, 192, 208,
                256, 300, 320, 512)
HEADDIM_BATCH, HEADDIM_HEADS = 2, 4
HEADDIM_SDPA_FROM = 192  # bf16 above this may be held to SDPA's error + 2e-2
HEADDIM_BIG_BATCH = (8200, 16, 8, 64)  # b·h 65,600: past the old 65,535
# inputs one element past a 16-byte boundary: the exact head dims take the
# padded tier kernels with element copies (both dtypes), 320 the wide ones
HEADDIM_UNALIGNED = (64, 128, 320)
# facebook/opt-2.7b config.json: vocab 50272, hidden 2560, 32 heads, ffn
# 10240, 32 layers, 2048 positions (learned)
OPT_CFG = dict(vocab_size=50272, d_model=2560, num_heads=32, num_layers=8,
               d_ff=10240, max_len=2048, seed=0, pos_encoding="learned",
               dtype_policy="mixed_bf16", attn_impl="auto")
OPT_BATCH, OPT_T, OPT_STEPS = 2, 2048, 3
OPT_SERVE_LAYERS = 32
OPT_SERVE_PROMPTS = (20, 150, 480, 900, 1300, 1900)
OPT_SERVE_NEW = (8, 16)
OPT_TOL = {"loss": 2e-2}  # mixed_bf16, the train gate on 3 steps' losses
# first-step gradients, ||a - b|| / ||b|| a leaf: mixed_bf16 flash against
# plain attention (2x the worst leaf of a sound run, 2.064e-2), flash's
# error against the f32 oracle within twice plain bf16's (the control; a
# sound run's worst ratio 1.58, at the attention projections: the kernels
# round ds to bf16 as the reference's do), and the float32 LM's flash
# (the f32 kernels) against its plain attention
OPT_GRAD_TOL = {"bf16": 4e-2, "control": 2.0, "floor": 1e-3, "f32": 1e-4}
# bench.py's fleet model (_bench_serve_run): head_dim 16, GQA, RoPE
GQA_CFG = dict(vocab_size=512, d_model=128, num_heads=8, num_kv_heads=4,
               num_layers=2, max_len=512, seed=7, dtype_policy="bf16",
               pos_encoding="rope", attn_impl="flash")
HEADDIM_TIMED = (("opt-2.7b train", 2, 2048, 32, 80, "bfloat16"),
                 ("opt-2.7b train f32", 2, 2048, 32, 80, "float32"),
                 ("d256", 2, 2048, 16, 256, "bfloat16"),
                 ("d512 wide", 1, 2048, 8, 512, "bfloat16"),
                 ("main path", 16, 1024, 8, 64, "bfloat16"))
BUILD_S = []  # the kernels' cold build time (main), for phase 19's line
KERNEL_KEY = {"flash_attention_fwd": "fwd",
              "flash_attention_bwd_dkdv": "dkdv",
              "flash_attention_bwd_dq": "dq"}


def headdim_cases():
    """(label, b, tq, tkv, h, d, causal, window, offset) of phase 19's
    sweep; ``offset`` elements put every input off a 16-byte boundary."""
    b, h = HEADDIM_BATCH, HEADDIM_HEADS
    cases = []
    for d in HEADDIM_DIMS:
        cases += [(f"d={d} causal P={p}", b, p, p, h, d, True, None, 0)
                  for p in (1, 17, 1000)]
        cases += [(f"d={d} windowed P=1000 w=65", b, 1000, 1000, h, d, True,
                   65, 0),
                  (f"d={d} non-causal tq=300 tkv=700", b, 300, 700, h, d,
                   False, None, 0)]
    cases += [(f"d={d} unaligned causal P=1000", b, 1000, 1000, h, d, True,
               None, 1) for d in HEADDIM_UNALIGNED]
    bb, t, hh, d = HEADDIM_BIG_BATCH
    cases.append((f"b·h={bb * hh} causal P={t}", bb, t, t, hh, d, True, None,
                  0))
    return cases


def _sdpa_grads(q, k, v, do, causal, window, dtype):
    """``F.scaled_dot_product_attention``'s out and (dq, dk, dv) with its
    inputs in ``dtype``, as f32 BTHD: the yardstick of the bf16 rule."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.detach().to(dtype).transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    mask = None
    if window is not None:
        i = torch.arange(q.shape[1], device=q.device)
        mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                         is_causal=causal and mask is None)
    grads = torch.autograd.grad(out, (qt, kt, vt),
                                do.to(dtype).transpose(1, 2))
    return (out.detach().transpose(1, 2).float(),
            *(g.transpose(1, 2).float() for g in grads))


def _oracle_and_sdpa(q, k, v, do, kw):
    """Each kernel's outputs from the f32 oracle (the plain versions on
    the inputs widened to f32) and from SDPA in the inputs' dtype."""
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa

    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    o32, l32 = fa.flash_attention_fwd_reference(qf, kf, vf, **kw)
    g32 = fa.flash_attention_bwd_reference(qf, kf, vf, o32, l32, dof, **kw)
    sd = _sdpa_grads(q, k, v, do, kw["causal"], kw["window"], q.dtype)
    return ({"fwd": (o32,), "dkdv": g32[1:], "dq": g32[:1]},
            {"fwd": sd[:1], "dkdv": sd[2:], "dq": sd[1:2]})


def _hold(kern, got, want, dtype, d, oracle) -> tuple:
    """One kernel's outputs against its plain version's on the same
    inputs, at phases 2 and 3's gates; a bf16 miss at d >= 192 passes
    only if the kernel's error against the f32 oracle is within SDPA's
    plus 2e-2 (``oracle()`` gives both). Returns (ok, err, rule)."""
    import torch

    name = str(dtype).replace("torch.", "")
    tol = (TOL if kern == "fwd" else BWD_TOL)[name]
    err = max(float((a - w).abs().max()) for a, w in zip(got, want))
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    ok = finite and err <= tol
    rule = f"tol {tol:.0e}"
    if not finite:
        rule += ", NOT FINITE"
    elif not ok and dtype == torch.bfloat16 and d >= HEADDIM_SDPA_FROM:
        ref, sdpa = (x[kern] for x in oracle())
        k_err = max(float((a - w).abs().max())
                    for a, w in zip(got[:len(ref)], ref))
        s_err = max(float((a - w).abs().max()) for a, w in zip(sdpa, ref))
        ok = k_err <= s_err + 2e-2
        rule = (f"oracle_err={k_err:.3e} sdpa_err={s_err:.3e} (kernel "
                f"within SDPA + 2e-2)")
    return ok, err, rule


def headdim_case(case, dtype, gen, card: str) -> list:
    """One sweep case: B1, B2 and B3 against their plain versions on the
    same inputs; returns the failures."""
    import torch
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa

    label, b, tq, tkv, h, d, causal, window, offset = case
    name = str(dtype).replace("torch.", "")

    def draw(t):
        x = torch.randn((b, t, h, d), generator=gen, device=HEADDIM_DEVICE)
        if not offset:
            return x.to(dtype)
        buf = torch.empty(x.numel() + offset, dtype=dtype,
                          device=HEADDIM_DEVICE)
        view = buf[offset:].view(x.shape)
        view.copy_(x)
        return view

    q, k, v, do = (draw(t) for t in (tq, tkv, tkv, tq))
    kw = dict(causal=causal, window=window)
    plan = fa.launch_plan(q.shape, k.shape, dtype, **kw,
                          aligned=fa._aligned(q, k, v, do))
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
    delta = fa._delta(ref_out, do)
    args = (q, k, v, do, ref_lse, delta)
    dk, dv = fa.flash_attention_bwd_dkdv(*args, **kw)
    dq = fa.flash_attention_bwd_dq(*args, **kw)
    ref = fa.flash_attention_bwd_reference(q, k, v, ref_out, ref_lse, do,
                                           **kw)
    torch.cuda.synchronize()
    got = {"fwd": (out.float(), lse), "dkdv": (dk, dv), "dq": (dq,)}
    want = {"fwd": (ref_out.float(), ref_lse), "dkdv": ref[1:],
            "dq": ref[:1]}
    cache = []

    def oracle():
        if not cache:
            cache.append(_oracle_and_sdpa(q, k, v, do, kw))
        return cache[0]

    failures = []
    for kern in ("fwd", "dkdv", "dq"):
        ok, err, rule = _hold(kern, got[kern], want[kern], dtype, d, oracle)
        kp = plan.kernel(kern)
        print(f"headdim {kern} {label} {name} [{kp.route} {kp.variant}"
              f" tier {kp.tier} vec {int(kp.vec)}]: "
              f"max_abs_err={err:.3e} ({rule}) "
              f"{'ok' if ok else 'MISMATCH'} [{card}]")
        if not ok:
            failures.append(f"{kern} {label} {name}: err {err} ({rule})")
    return failures


def headdim_timed(card: str) -> tuple:
    """B1–B3 at OPT-2.7B's training shape (bf16 and f32), at d 256 and 512
    and at the main path's shape: each kernel's output against its plain
    version's on the same inputs (the sweep's gates), and its time beside
    the plain version's, the bound and SDPA's (forward; the backward of
    B2 and B3 together). Returns (timings, failures)."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=HEADDIM_DEVICE).manual_seed(19)
    out, failures = {}, []
    for label, b, t, h, d, dname in HEADDIM_TIMED:
        dt = getattr(torch, dname)
        q, k, v, do = (torch.randn((b, t, h, d), generator=gen,
                                   device=HEADDIM_DEVICE).to(dt)
                       for _ in range(4))
        kw = dict(causal=True, window=None)
        o, lse = fa.flash_attention_fwd(q, k, v, **kw)
        delta = fa._delta(o, do)
        args = (q, k, v, do, lse, delta)
        keep = fa._keep(t, t, True, None, device=HEADDIM_DEVICE)
        scale = fa._scale(q, None)
        dk, dv = fa.flash_attention_bwd_dkdv(*args, **kw)
        dq = fa.flash_attention_bwd_dq(*args, **kw)
        ref_o, ref_lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
        got = {"fwd": (o.float(), lse), "dkdv": (dk, dv), "dq": (dq,)}
        want = {"fwd": (ref_o.float(), ref_lse),
                "dkdv": fa._dkdv(*args, keep, scale),
                "dq": (fa._dq(*args, keep, scale),)}
        torch.cuda.synchronize()
        plan = fa.launch_plan(q.shape, k.shape, dt, causal=True)
        held = {kern: _hold(kern, got[kern], want[kern], dt, d,
                            lambda: _oracle_and_sdpa(q, k, v, do, kw))
                for kern in got}
        del got, want, ref_o, ref_lse, dk, dv, dq
        torch.cuda.empty_cache()
        ms = {"fwd": cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw)),
              "dkdv": cuda_ms(lambda: fa.flash_attention_bwd_dkdv(*args,
                                                                  **kw)),
              "dq": cuda_ms(lambda: fa.flash_attention_bwd_dq(*args, **kw))}
        plain = {"fwd": cuda_ms(lambda: fa.flash_attention_fwd_reference(
                     q, k, v, **kw), iters=3),
                 "dkdv": cuda_ms(lambda: fa._dkdv(*args, keep, scale),
                                 iters=3),
                 "dq": cuda_ms(lambda: fa._dq(*args, keep, scale), iters=3)}
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = {"fwd": cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))}
        lib["dkdv"] = lib["dq"] = sdpa_backward_ms(q, k, v, do, True, None)
        bound = {"fwd": fa.flash_bound(b, t, t, h, d, dt, causal=True)}
        bound.update(fa.flash_bwd_bound(b, t, t, h, d, dt, causal=True))
        for kern in ("fwd", "dkdv", "dq"):
            ok, err, rule = held[kern]
            kp = plan.kernel(kern)
            print(f"headdim time {kern} {label} [{b}, {t}, {h}, {d}] "
                  f"{dname} causal [{kp.route} {kp.variant} tier "
                  f"{kp.tier}]: kernel_ms={ms[kern]:.5f} "
                  f"plain_ms={plain[kern]:.5f} library_ms={lib[kern]:.5f} "
                  f"bound_ms={bound[kern]['bound_ms']:.6f} "
                  f"({bound[kern]['bound_by']}){cuda_core(bound[kern])} "
                  f"max_abs_err={err:.3e} ({rule}) "
                  f"{'ok' if ok else 'MISMATCH'} [{card}]")
            if not ok:
                failures.append(f"timed {kern} {label}: err {err} ({rule})")
        out[label] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                      "bound": {k_: bound[k_]["bound_ms"] for k_ in ms},
                      "bound_by": {k_: bound[k_]["bound_by"] for k_ in ms},
                      "max_abs_err": {k_: held[k_][1] for k_ in ms},
                      "shape": [b, t, h, d], "dtype": dname}
        del q, k, v, do, o, lse, delta, args, keep
        torch.cuda.empty_cache()
    return out, failures


def seeded_on_card(lm, seed: int, adam: bool = True):
    """``init()``'s layout and scales with the weights drawn on the card
    from ``seed`` (``init`` draws them on the host, one tensor at a time:
    tens of seconds at 2.7 B weights); the same seed gives the same
    weights. ``adam=False`` leaves out the Adam moments (a server needs
    none)."""
    import torch
    from deeplearning4j_tpu_torch.dtypes import tree_map

    gen = torch.Generator(device=HEADDIM_DEVICE).manual_seed(seed)
    D, F_, V, L = lm.d_model, lm.d_ff, lm.vocab_size, lm.max_len
    kv = lm.num_kv_heads * (D // lm.num_heads)
    dt = lm.policy.param_dtype

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=HEADDIM_DEVICE,
                           dtype=dt)

    def dense(fan_in, fan_out):
        return normal(fan_in, fan_out) * math.sqrt(2.0 / (fan_in + fan_out))

    def norm():
        return {"g": torch.ones(D, dtype=dt, device=HEADDIM_DEVICE),
                "b": torch.zeros(D, dtype=dt, device=HEADDIM_DEVICE)}

    params = {"embed": normal(V, D) * 0.02, "ln_f": norm(), "blocks": []}
    if lm.pos_encoding == "learned":
        params["pos"] = normal(L, D) * 0.02
    for _ in range(lm.num_layers):
        params["blocks"].append({
            "ln1": norm(),
            "attn": {"wq": dense(D, D), "wk": dense(D, kv),
                     "wv": dense(D, kv), "wo": dense(D, D)},
            "ln2": norm(),
            "mlp": {"w1": dense(D, F_),
                    "b1": torch.zeros(F_, dtype=dt,
                                      device=HEADDIM_DEVICE),
                    "w2": dense(F_, D),
                    "b2": torch.zeros(D, dtype=dt, device=HEADDIM_DEVICE)}})
    lm.params = params
    lm.opt_state = tree_map(
        lambda p: {"m": torch.zeros_like(p), "v": torch.zeros_like(p)},
        params) if adam else None
    return lm


def _named_leaves(tree, prefix: str = ""):
    """(name, tensor) of every leaf of a nested dict/list, in
    ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _named_leaves(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _named_leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def first_step_grads(lm, tok, impl: str) -> dict:
    """The loss's gradient at ``lm``'s weights, by leaf name, with the
    attention path ``impl`` (the first step's gradients: no optimizer)."""
    import torch
    from deeplearning4j_tpu_torch.dtypes import tree_map

    saved, lm.attn_impl = lm.attn_impl, impl
    try:
        params = tree_map(lambda p: p.detach().requires_grad_(), lm.params)
        named = _named_leaves(params)
        loss = lm.loss(params, tok, train=True)
        grads = torch.autograd.grad(loss, [x for _, x in named])
    finally:
        lm.attn_impl = saved
    return {name: g for (name, _), g in zip(named, grads)}


def _rel(a, b) -> float:
    """||a − b|| / ||b|| (Frobenius, in f64)."""
    return float((a.double() - b.double()).norm() / b.double().norm())


def opt_train(card: str) -> dict:
    """(b): the LM at OPT-2.7B's widths (depth 8). First its first-step
    gradients, leaf by leaf (``OPT_GRAD_TOL``): through B1–B3 and through
    plain attention under ``mixed_bf16``, both against plain attention in
    float32 (the oracle; the plain bf16 path's own error there is the
    control), and the float32 LM through the f32 kernels. Then
    three ``fit_batch`` steps through B1–B3, and the same from the same
    seeded weights on the plain-attention path (built after the flash
    model is freed: both models and their captured steps do not fit the
    card together). Returns the fit steps' launches."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM

    torch.backends.cuda.matmul.allow_tf32 = False
    flash = seeded_on_card(TransformerLM(**OPT_CFG, device=HEADDIM_DEVICE),
                           OPT_CFG["seed"])
    impl = flash._attn_impl(OPT_T, train=True)
    if impl != "flash":
        raise AssertionError(f"attn_impl='auto' resolved to {impl!r} at "
                             "head_dim 80, not 'flash'")
    fpt = flash.flops_per_token(OPT_T)
    tok = torch.as_tensor(np.random.default_rng(19).integers(
        0, OPT_CFG["vocab_size"], (OPT_BATCH, OPT_T)),
        device=HEADDIM_DEVICE)
    before = launch_counts()
    g_flash = first_step_grads(flash, tok, "flash")
    grad_launches = {k: n - before[k] for k, n in launch_counts().items()}
    g_plain = first_step_grads(flash, tok, "xla")
    f32 = TransformerLM(**{**OPT_CFG, "dtype_policy": "float32"},
                        device=HEADDIM_DEVICE)
    f32.params = flash.params
    g_f32 = first_step_grads(f32, tok, "xla")
    g_f32_flash = first_step_grads(f32, tok, "flash")  # the f32 kernels
    del f32
    rows = [(name, _rel(g_flash[name], g_plain[name]),
             _rel(g_flash[name], g_f32[name]),
             _rel(g_plain[name], g_f32[name]),
             _rel(g_f32_flash[name], g_f32[name])) for name in g_flash]
    del g_flash, g_plain, g_f32, g_f32_flash
    gc.collect()
    torch.cuda.empty_cache()
    for name, fp, f, p, f32_err in sorted(rows, key=lambda r: -r[1])[:4]:
        print(f"opt-2.7b grad {name}: flash_vs_plain={fp:.3e} "
              f"flash_vs_f32={f:.3e} plain_vs_f32={p:.3e} "
              f"f32_flash_vs_f32={f32_err:.3e} [{card}]")
    worst = {i: max(rows, key=lambda r: r[i]) for i in (1, 4)}
    ratio = max(rows, key=lambda r: r[2] / r[3])
    print(f"opt-2.7b first-step grads over {len(rows)} leaves: "
          f"flash_vs_plain {worst[1][1]:.3e} ({worst[1][0]}; tol "
          f"{OPT_GRAD_TOL['bf16']:.0e}); flash_vs_f32 / plain_vs_f32 "
          f"{ratio[2] / ratio[3]:.3f} ({ratio[0]}; tol "
          f"{OPT_GRAD_TOL['control']} x + {OPT_GRAD_TOL['floor']:.0e}); "
          f"float32 flash_vs_plain {worst[4][4]:.3e} ({worst[4][0]}; tol "
          f"{OPT_GRAD_TOL['f32']:.0e}); launches {grad_launches} [{card}]")
    bad = [r[0] for r in rows
           if r[1] > OPT_GRAD_TOL["bf16"] or r[4] > OPT_GRAD_TOL["f32"]
           or r[2] > OPT_GRAD_TOL["control"] * r[3] + OPT_GRAD_TOL["floor"]]
    if bad:
        raise AssertionError(f"first-step gradients through B1–B3 miss "
                             f"their gates at {bad}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, per_step, step_ms = [], [], []
    for _ in range(OPT_STEPS):
        before = launch_counts()
        t = time.monotonic()
        losses.append(float(flash.fit_batch(tok)))
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t) * 1e3)
        per_step.append({k: n - before[k]
                         for k, n in launch_counts().items()})
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_layers = flash.num_layers
    # a captured step and its closure form a reference cycle: collect it,
    # or its graph pool outlives the model
    del flash
    gc.collect()
    torch.cuda.empty_cache()
    plain = seeded_on_card(
        TransformerLM(**{**OPT_CFG, "attn_impl": "xla"},
                      device=HEADDIM_DEVICE), OPT_CFG["seed"])
    plain_losses = [float(plain.fit_batch(tok)) for _ in range(OPT_STEPS)]
    torch.cuda.synchronize()
    err_l = max(abs(a - b) for a, b in zip(losses, plain_losses))
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    tps = OPT_BATCH * OPT_T / (step_ms[-1] / 1e3)
    print(f"opt-2.7b train L{OPT_CFG['num_layers']} [{OPT_BATCH}, {OPT_T}]"
          f" head_dim 80 mixed_bf16 attn={impl}: losses={losses} "
          f"plain_losses={plain_losses} loss_err={err_l:.3e} (tol "
          f"{OPT_TOL['loss']:.0e}) ms_per_step={step_ms} "
          f"tokens_per_sec={tps} flops_per_token={fpt} "
          f"share_of_bf16_peak={fpt * tps / H100_BF16_FLOPS} "
          f"peak_mem_bytes={peak} launches={per_step} [{card}]")
    if not all(math.isfinite(x) for x in losses + plain_losses):
        raise AssertionError(f"non-finite loss: {losses} {plain_losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    for i, counts in enumerate(per_step):
        if any(n != n_layers for n in counts.values()):
            raise AssertionError(f"step {i} launched {counts}, expected "
                                 f"{n_layers} of each kernel")
    if err_l > OPT_TOL["loss"]:
        raise AssertionError(f"flash training at head_dim 80 disagrees "
                             f"with plain attention: loss {err_l}")
    return launches


def headdim_serve(cfg: dict, label: str, prompts, new, max_len: int,
                  card: str, seed: int) -> None:
    """A ``DecodeServer(slots=8)`` answering 8 seeded greedy requests;
    every stream must equal ``lm.generate`` and B1 must launch
    ``num_layers`` times an admission prefill (B2, B3 never)."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.kernels.flash_attention import (
        launch_counts as wrapper_counts)
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    from deeplearning4j_tpu_torch.serving import (
        DecodeServer, poisson_schedule, run_open_loop)

    t0 = time.monotonic()
    lm = seeded_on_card(TransformerLM(**cfg, device=HEADDIM_DEVICE),
                        cfg["seed"], adam=False)
    sched = poisson_schedule(8, 20.0, vocab_size=cfg["vocab_size"],
                             prompt_lens=prompts, max_new_tokens=new,
                             seed=seed)
    refs = {a.prompt.tobytes(): lm.generate(a.prompt[None],
                                            a.max_new_tokens)[0].cpu().numpy()
            for a in sched}
    srv = DecodeServer(lm, slots=8, max_len=max_len, device=HEADDIM_DEVICE)
    torch.cuda.synchronize()
    before = wrapper_counts()
    report = run_open_loop(srv, sched)
    torch.cuda.synchronize()
    counts = {k: n - before[k] for k, n in wrapper_counts().items()}
    s, st = report.summary(), srv.stats()
    print(f"{label} serve L{lm.num_layers} head_dim "
          f"{lm.d_model // lm.num_heads}: finished={s['finished']} "
          f"tokens={s['tokens']} tokens_per_sec={s['tokens_per_sec']} "
          f"ttft_p50_ms={s['ttft_p50_ms']} "
          f"kv_pool_bytes={st['kv_pool_bytes']} launches={counts} "
          f"wall_s={time.monotonic() - t0:.1f} [{card}]")
    if s["finished"] != len(sched):
        raise AssertionError(f"{label}: {s['finished']} of {len(sched)} "
                             "requests finished")
    if counts["flash_attention_fwd"] != lm.num_layers * len(sched) or \
            counts["flash_attention_bwd_dkdv"] or \
            counts["flash_attention_bwd_dq"]:
        raise AssertionError(f"{label}: launches {counts}, expected B1 "
                             f"{lm.num_layers} a prefill and no B2/B3")
    for req in srv.finished:
        want = refs[req.prompt.tobytes()]
        if not np.array_equal(req.output, want):
            raise AssertionError(
                f"{label}: the {req.prompt.shape[0]}-token prompt's stream "
                f"differs from lm.generate at index "
                f"{int(np.argmax(req.output != want))}")
    print(f"{label}: {len(srv.finished)} greedy streams equal lm.generate "
          f"[{card}]")


def headdim_phase(card: str) -> dict:
    """Phase 19; returns B1–B3's launches over (b)–(d)."""
    import torch
    from deeplearning4j_tpu_torch.kernels import KERNEL_SOURCES, _build

    t0 = time.monotonic()
    ptx = [line for name in KERNEL_SOURCES
           for line in ptxas_lines(_build.LOGS.get(name, ""))]
    spills = [line for line in ptx if not re.search(
        r"0 bytes spill stores, 0 bytes spill loads", line)]
    print(f"headdim: {len(ptx)} kernel instantiations, cold build "
          f"{BUILD_S[0] if BUILD_S else float('nan'):.1f} s, spilling: "
          f"{spills or 'none'} [{card}]")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gc.collect()  # earlier phases' captured steps (reference cycles)
    torch.cuda.empty_cache()
    failures = []
    gen = torch.Generator(device=HEADDIM_DEVICE).manual_seed(1919)
    for case in headdim_cases():
        for dtype in (torch.float32, torch.bfloat16):
            failures += headdim_case(case, dtype, gen, card)
            torch.cuda.empty_cache()
    print(f"headdim: sweep {time.monotonic() - t0:.1f} s [{card}]")
    if failures:
        raise AssertionError("head-dim sweep: " + "; ".join(failures))
    timings, timed_failures = headdim_timed(card)
    if timed_failures:
        raise AssertionError("head-dim timings: " + "; ".join(timed_failures))
    t1 = time.monotonic()
    reset_launch_counts()
    opt_train(card)
    torch.cuda.empty_cache()
    print(f"headdim: (b) {time.monotonic() - t1:.1f} s [{card}]")
    headdim_serve({**OPT_CFG, "num_layers": OPT_SERVE_LAYERS,
                   "attn_impl": "flash"}, "opt-2.7b", OPT_SERVE_PROMPTS,
                  OPT_SERVE_NEW, OPT_CFG["max_len"], card, seed=19)
    torch.cuda.empty_cache()
    headdim_serve(GQA_CFG, "gqa head_dim 16", (8, 16, 24, 48), (8, 16),
                  256, card, seed=1)
    launches = launch_counts()
    print(f"headdim: phase wall {time.monotonic() - t0:.1f} s, launches "
          f"{launches} [{card}]")
    return {"launches": launches, "timed": timings}


# ---------------------------------------------------------------------------
# phase 20: the float32 LM, B2 and B3 on the tensor cores (3xTF32)
# ---------------------------------------------------------------------------
F32_TRAIN_CFG = {**TRAIN_CFG, "dtype_policy": "float32"}


def f32_train(card: str) -> dict:
    """Phase 20: the train cell's model under the reference's default
    ``float32`` policy. (a) first-step gradients through B1–B3 against
    plain attention (TF32 off on both sides), leaf by leaf, at
    ``OPT_GRAD_TOL["f32"]``; (b) ``TRAIN_WARMUP`` + ``TRAIN_STEPS``
    ``fit_batch`` steps, losses finite and falling, B1–B3
    ``num_layers`` each a timed step; (c) the step's ms and tokens/s and
    B1's and B2 + B3's shares of its device time from the profiler.
    Returns B1–B3's launches over the timed steps."""
    import torch
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM

    t0 = time.monotonic()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lm = TransformerLM(**F32_TRAIN_CFG).init()
    impl = lm._attn_impl(TRAIN_T, train=True)
    if impl != "flash":
        raise AssertionError(f"attn_impl='auto' resolved to {impl!r} for "
                             "float32 training, not 'flash'")
    tok = torch.as_tensor(train_tokens(), device="cuda")
    before = launch_counts()
    g_flash = first_step_grads(lm, tok, "flash")
    grad_launches = {k: n - before[k] for k, n in launch_counts().items()}
    g_plain = first_step_grads(lm, tok, "xla")
    rows = sorted(((_rel(g_flash[n], g_plain[n]), n) for n in g_flash),
                  reverse=True)
    del g_flash, g_plain
    print(f"f32 lm first-step grads over {len(rows)} leaves: flash_vs_plain "
          f"worst {rows[0][0]:.3e} ({rows[0][1]}), then "
          f"{', '.join(f'{e:.3e} ({n})' for e, n in rows[1:4])} (tol "
          f"{OPT_GRAD_TOL['f32']:.0e}); launches {grad_launches} [{card}]")
    bad = [n for e, n in rows if not e <= OPT_GRAD_TOL["f32"]]
    if bad:
        raise AssertionError(f"float32 first-step gradients through B1–B3 "
                             f"miss {OPT_GRAD_TOL['f32']} at {bad}")
    if any(n != lm.num_layers for n in grad_launches.values()):
        raise AssertionError(f"the flash gradient launched {grad_launches}")

    warm = [lm.fit_batch(tok) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    reset_launch_counts()
    losses, per_step = [], []
    t1 = time.monotonic()
    for _ in range(TRAIN_STEPS):
        before = launch_counts()
        losses.append(lm.fit_batch(tok, block=False))
        per_step.append({k: n - before[k]
                         for k, n in launch_counts().items()})
    torch.cuda.synchronize()
    wall = time.monotonic() - t1
    launches = launch_counts()
    losses = [float(x) for x in losses]
    ms_step = wall / TRAIN_STEPS * 1e3
    prof = profiled(lambda: lm.fit_batch(tok), 1)
    fwd_ms = prof["kernel_ms"]["flash_attention_fwd"]
    bwd_ms = (prof["kernel_ms"]["flash_attention_bwd_dkdv"] +
              prof["kernel_ms"]["flash_attention_bwd_dq"])
    print(f"f32 lm train [{TRAIN_BATCH}, {TRAIN_T}] float32 attn={impl} "
          f"B1–B3 [{variant('fwd', 'float32')}]: warmup_losses={warm} "
          f"losses={losses} ms_per_step={ms_step} tokens_per_sec="
          f"{TRAIN_BATCH * TRAIN_T * TRAIN_STEPS / wall} "
          f"profiled_device_busy_ms={prof['device_busy_ms']:.3f} "
          f"kernel_ms={json.dumps(prof['kernel_ms'])} "
          f"b1_share_of_busy={fwd_ms / prof['device_busy_ms']:.4f} "
          f"b2_b3_share_of_busy={bwd_ms / prof['device_busy_ms']:.4f} "
          f"launches={launches} phase_s={time.monotonic() - t0:.1f} "
          f"[{card}]")
    if not all(math.isfinite(x) for x in warm + losses):
        raise AssertionError(f"non-finite loss: {warm + losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall on a repeated batch: "
                             f"{losses}")
    for i, counts in enumerate(per_step):
        if any(n != lm.num_layers for n in counts.values()):
            raise AssertionError(f"step {i} launched {counts}, expected "
                                 f"{lm.num_layers} of each kernel")
    del lm
    gc.collect()
    return launches


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    sys.path.insert(0, HERE)
    try:
        import deeplearning4j_tpu_torch.kernels  # noqa: F401
    except ImportError as e:
        fail(f"the port package is not beside this script: {e}")

    start_cold_compile_child()  # phase 10's, beside phase 1's build
    try:
        run_phases()
    finally:
        stop_cold_compile_child()


def run_phases() -> None:
    """Phase 1's build, the phases, and the result lines (``main``)."""
    import torch
    from deeplearning4j_tpu_torch.kernels import KERNEL_SOURCES, _build

    failed = []
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    t0 = time.monotonic()
    try:
        _build.build_all(KERNEL_SOURCES)
        BUILD_S.append(time.monotonic() - t0)
        print(f"build: {len(KERNEL_SOURCES)} kernel(s) in "
              f"{BUILD_S[0]:.1f} s [{card}]")
        for name in KERNEL_SOURCES:
            for line in ptxas_lines(_build.LOGS.get(name, "")):
                print(f"ptxas {name}.cu {line}")
    except Exception:
        traceback.print_exc()
        fail("kernel build failed")

    entries = {}
    serve_launches = train_launches = fused_launches = cli_launches = None
    extras_launches = data_launches = profile_launches = None
    embed_launches = trees_launches = mesh_launches = None
    model_launches = cluster_launches = a15_launches = None
    headdim = f32_launches = None
    f32_entries = []  # B1–B3's float32 entries (phases 2, 3; phase 20)
    for phase in ("flash", "flash_bwd", "serve", "train", "networks",
                  "recurrent", "fused", "cli", "serve_extras", "data",
                  "monitor", "embeddings", "trees", "mesh", "model",
                  "cluster", "a15", "headdim", "f32_train"):
        t_phase = time.monotonic()
        try:
            if phase == "flash":
                entries["flash_attention_fwd"], f32_fwd = check_flash(card)
                f32_entries.append(f32_fwd)
            elif phase == "flash_bwd":
                for e in check_flash_bwd(card):
                    if e["dtype"] == "bfloat16":
                        entries[e["name"]] = e
                    else:
                        f32_entries.append(e)
            elif phase == "serve":
                reset_launch_counts()
                serve_launches = serve(card)
                if launch_counts()["flash_attention_bwd_dkdv"] or \
                        launch_counts()["flash_attention_bwd_dq"]:
                    raise AssertionError("serving launched a backward "
                                         "kernel")
            elif phase == "train":
                train_launches = train(card)
                check_train_parity(card)
            elif phase == "networks":
                networks(card)
            elif phase == "recurrent":
                recurrent(card)
            elif phase == "fused":
                fused_launches = fused(card)
            elif phase == "cli":
                cli_launches = front_door(card)
            elif phase == "serve_extras":
                extras_launches = serve_extras(card)
            elif phase == "data":
                data_launches = data(card)
            elif phase == "monitor":
                profile_launches = monitor_phase(card)
            elif phase == "embeddings":
                embed_launches = embeddings(card)
            elif phase == "trees":
                trees_launches = trees(card)
            elif phase == "mesh":
                mesh_launches = mesh_phase(card)
            elif phase == "model":
                model_launches = model_phase(card)
            elif phase == "cluster":
                cluster_launches = cluster_phase(card)
            elif phase == "a15":
                a15_launches = a15_phase(card)
            elif phase == "headdim":
                headdim = headdim_phase(card)
            else:
                f32_launches = f32_train(card)
        except Exception:
            traceback.print_exc()
            failed.append(phase)
        torch.cuda.empty_cache()
        print(f"phase {phase}: {time.monotonic() - t_phase:.1f} s [{card}]",
              flush=True)
    if failed:
        fail(f"phase(s) failed: {', '.join(failed)}")
    for name, e in entries.items():
        e["launches"] = train_launches[name]
        if not e["launches"]:
            fail(f"{name} was not launched on the train path")
    for name, e in entries.items():
        e["launches_fused_lm"] = fused_launches[name]
        e["launches_cli"] = cli_launches[name]
        e["launches_serve_extras"] = 0
        e["launches_data"] = data_launches[name]
        e["launches_profile"] = profile_launches[name]
        e["launches_embeddings"] = embed_launches[name]
        e["launches_trees"] = trees_launches[name]
        e["launches_mesh"] = mesh_launches[name]
        if not e["launches_mesh"]:
            fail(f"{name} was not launched on the mesh path")
        e["launches_tp"] = model_launches["tp"][name]
        e["launches_pipe"] = model_launches["pipe"][name]
        if not e["launches_tp"] or not e["launches_pipe"]:
            fail(f"{name} was not launched on the TP or pipeline path")
        e["launches_cluster"] = cluster_launches[name]
        e["launches_a15"] = a15_launches[name]
        e["launches_headdim"] = headdim["launches"][name]
        if not e["launches_headdim"]:
            fail(f"{name} was not launched at OPT-2.7B's head_dim 80")
        e["headdim_times"] = {
            label: {key: t[key][KERNEL_KEY[name]]
                    for key in ("ms", "plain_ms", "library_ms", "bound",
                                "bound_by", "max_abs_err")}
            | {"shape": t["shape"], "dtype": t["dtype"]}
            for label, t in headdim["timed"].items()}
    if not entries["flash_attention_fwd"]["launches_a15"]:
        fail("flash_attention_fwd was not launched on the A15 fleet")
    entries["flash_attention_fwd"]["launches_serve"] = serve_launches
    entries["flash_attention_fwd"]["launches_serve_extras"] = extras_launches
    for e in f32_entries:
        e["launches"] = f32_launches[e["name"]]
        if not e["launches"]:
            fail(f"{e['name']} (float32) was not launched on phase 20's "
                 "float32 train path")
    print(json.dumps({"kernels": list(entries.values()) + f32_entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
