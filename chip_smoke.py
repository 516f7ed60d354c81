#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``deeplearning4j_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --kernels-only   # build + kernel checks only
    python3 chip_smoke.py --profile        # also print phase 4's top
                                           # kernels of a decode sweep
    python3 chip_smoke.py --profile-train  # also print the top kernels of a
                                           # replayed step of the 120M LM
                                           # and the D 256 LM
    python3 chip_smoke.py --profile-resnet # also profile one eager ResNet-50
                                           # step (K3 by kernel)
    python3 chip_smoke.py --profile-charnn # also profile one eager char-RNN
                                           # step
    python3 chip_smoke.py --k3-times ROOT  # only time the K3 reductions of
                                           # the port checked out at ROOT
    python3 chip_smoke.py --obs-only       # build + phase 14 only
    python3 chip_smoke.py --quant-only     # build + phase 15 only
    python3 chip_smoke.py --bert-only      # build + phase 16 only
    python3 chip_smoke.py --workflow2-only # build + phases 7, 9 and 17
    python3 chip_smoke.py --samediff-only  # build + phase 18 only
    python3 chip_smoke.py --zoo-only       # build + phase 19 only
    python3 chip_smoke.py --import-only    # build + phase 20 only
    python3 chip_smoke.py --parallel-only  # build + phases 7 and 21 only
    python3 chip_smoke.py --fleet-only     # build + phase 22 only
    python3 chip_smoke.py --prefetch-times ROOT  # only time LeNet's fit
                                             # over host and device
                                             # iterators and a host list
                                             # with the port at ROOT
    python3 chip_smoke.py --sweep-times ROOT  # only time phase 4's steady
                                             # sweeps of the port at ROOT
                                             # (with its observability
                                             # plane, where it has one)
    python3 chip_smoke.py --flash-times ROOT  # only time K1, dQ and dK/dV at
                                             # D 256, 320 and 512 (bf16 and
                                             # f32), profile the D 256 and
                                             # D 320 LM steps and digest
                                             # K1's, the backward's and K2's
                                             # outputs of the port at ROOT

Phases, each fatal on failure:

1. print the card's name and power limit; build every kernel from
   ``deeplearning4j_tpu_torch/csrc`` (one nvcc per source, in parallel);
2. K2 (paged decode, split-K in two passes) against its plain version at
   the 120M decode shapes, bf16 and f32 pools, over mapped, sentinel,
   partial-tail, CoW-shared and empty slots (the empty slot against
   zeros), then at head dim 320 (2 heads, past the old limit of 256); a
   second launch bit for bit equal; device time of both passes
   (``torch.profiler``) with a call timed by CUDA events beside it;
3. K1 (causal flash forward; bf16 on the tensor-core kernel up to D 256
   and on its two-warpgroup wide kernel at 264-512, f32 in split TF32 on
   the tensor cores: the narrow kernel (a warp owns 16 whole rows) up to
   128, the padded-256 one at 129-256 and the wide one (warp pairs that
   split O's columns) at 257-512, every other head dim on the general
   CUDA-core kernel)
   against ``mha_reference``, O and lse, at T 1024/2048, at head dim 80
   (padded to 128 inside the kernel) in both dtypes, at the train path's
   B32 T1024 bf16, at D 160 and 256 in bf16 (padded to 256 on the tensor
   cores), at D 130, 160, 200 and 256 in f32 (split TF32), at D 264, 320,
   328, 384, 392 and 512 in both dtypes (wide, padded to 384 and 512, f32
   also 320), D 12
   bf16 and 520 in both dtypes (general), and at the D 256 and D 320 LMs'
   B8 H2 T1024 in both dtypes, plus the strided (B, T, H, D) layout the
   transformer uses; the kernel family ``route`` names must run; a second
   launch bit for bit equal; ``F.scaled_dot_product_attention`` timed as
   a yardstick only;
3b. the flash backward kernels (dQ, dK/dV; on the tensor cores in bf16 up
   to D 256, past 128 on two warpgroups; past 256, up to 512, their wide
   kernels: bf16 dQ on two warpgroups, bf16 dK/dV on a cluster of two
   CTAs, f32 both in split TF32 on a cluster of two CTAs) against
   ``flash_attention_bwd_reference`` on the same inputs, through strided
   (B, T, H, D) views of one qkv buffer, at B1 H8 D64 T 1024/2048/4096
   bf16, T 2048 f32, T 200 causal and T 256 non-causal, head dim 80 in
   both dtypes, the train path's B32 T1024 bf16, causal and non-causal,
   phase 3's head dims past 128 (D 320 and 512 on the wide kernels; D 12
   and 520 on the general ones), causal, the wide kernels at D 264, 320,
   328, 384, 392 and 512, T 200, causal and not, in both dtypes, the
   two-warpgroup
   dQ at bf16 D 136, 160, 200 and 256, T 200, causal and not, and D 256
   T 1024 non-causal, the split-TF32 dQ and dK/dV at f32 D 130, 160, 200
   and 256, T 200, causal and not, and the D 256 and D 320 LM shapes (B8
   H2 T1024, bf16 and f32);
   a second launch of each bit for bit equal; the autograd Function's
   grads against autograd through ``mha_reference``; dQ's and dK/dV's
   device times against their bounds (the split-TF32 kernels' at the TF32
   rate, their f32 FFMA bound beside it) and SDPA's whole backward (timed
   as a yardstick only);
4. the main path at full width: the 120M Transformer-LM with seeded
   random weights served by a dense and a paged
   ``ContinuousBatchingScheduler``, two ways, each on its own engine:
   replayed (the engine's entry points replay CUDA graphs — the main
   path) and eager (``disable_graphs()``). Per way a warm wave of each
   path with the timed wave's prompt lengths (it reaches every signature
   of the timed wave: dense buckets 1024 and 2048, chunk buckets 32 and
   128), ``engine.mark_warm()``, then each path's timed wave; every
   request must resolve with its token count and its tokens must be
   identical replayed and eager; the compile report must show 0 retraces
   after warm; the launch counts are set to 0 just before each timed wave
   and read just after it, counted from the captures (a replay counts the
   launches its capture recorded): the tensor-core K1 must have launched
   once a layer in every dense prefill (every bucket >= 1024 tokens) and
   K2 in the paged run; decode tokens/s, TTFT and peak memory of each
   wave; then steady decode sweeps (every slot decoding, ctx 600): wall
   and device ms, busy share and the host split (scheduler bookkeeping,
   ``PageTable.sync``, ``decode_step``'s dispatch, the sampler and the
   read of its tokens), and one 128-token ``prefill_chunk`` (dispatch,
   wall and device ms), replayed beside eager; one K1 prefill and one K2
   decode step must match the plain path (kernels off) with KL <= 1e-3
   per row;
4b. an LM of head dim 320 (d_model 640, 2 heads, 2 layers, max_seq 2048,
   seeded random weights) served the same two ways: a dense wave (4
   slots) and a paged wave (4 slots, page_len 16), prompts of 1024-1500
   tokens, 32 new tokens; tokens identical replayed and eager, 0
   retraces after warm, every dense prefill launching K1 on the bf16 wide
   kernel once a layer (counted from the captures), K2 at Dh 320 in the
   paged decode, one K1 prefill against the plain arm with KL <= 1e-3;
6. the training path at full width: the 120M LM of ``bench.py``'s
   ``transformer`` row (T 1024, bf16, fused loss, remat "save_attn"),
   batch 32 of seeded random ids, trained by ``make_train_step`` with
   AdamW (optax's defaults, ``capturable=True``, fused: ``LM_ADAMW``)
   from identical params three ways: the kernel path (flash forward and
   backward kernels) with its steps replayed from a CUDA graph — the main
   path: step 1 eager, step 2 captured and replayed, steps 3-5 replayed —,
   the kernel path eager (``disable_graphs()``), and the plain path
   (plain attention, f32 scores; eager); and once more replayed with the
   ``foreach`` form of AdamW beside the fused one: step-1 grads within
   relative L2 2e-2 per leaf, every kernel way's loss within 2e-2 nats
   of the plain path's at each of 5 steps and falling; whether the
   replayed and the eager trajectories are bit-identical (the first
   differing leaf if not); wall ms a step (the median over the replays,
   or over steps 2-5 eager), device ms of one profiled step, busy share,
   tokens/s and peak memory of each way; the launch counts are set to 0
   just before the main path, and every step must launch K1 16 times and
   dQ and dK/dV 8 times each, every launch on the tensor-core kernels (a
   replay counts the launches its capture recorded: the wrappers do not
   run in a replay); then the same LM at head dim 256 (2 heads, 2
   layers, batch 8) for three steps (eager, capture, replay), K1 (4
   launches), dQ (2) and dK/dV (2) on the tensor cores padded to 256,
   and once more in f32, K1, dQ and dK/dV in split TF32 on the tensor
   cores; then the LM of head dim 320 (d_model 640, 2 heads, 2 layers,
   batch 8) in bf16 and in f32, K1 (4 launches a step), dQ and dK/dV (2
   each) on their wide kernels, the replayed steps bit for bit equal to
   the eager ones, each profiled for its device ms a step and the flash
   kernels' share; each held to the same bars (each its own path: counts
   set to 0 just before it);
7. the fused BatchNorm+activation kernels (K3: normalize+act, stats,
   backward reduce, backward dx) against their plain versions at all
   nine (N, C) shapes a ResNet-50 BN gives them at batch 128, relu and
   identity, bf16 and f32; every activation at one shape; C = 3, 5, 24
   at N = 1000; the reductions' sums within 1e-4 of their largest entry,
   the stats kernel's fused mean, var and inv (and scale, shift; and the
   backward reduce's sums over N) within 1e-6 relative of the plain
   versions on the same sums; a second launch bit for bit equal; kernel
   device time (``torch.profiler``), plain and ``F.batch_norm`` (the
   library yardstick, identity activation) timed beside each kernel's
   bound;
8. the ResNet-50 path at full width: ``ResNet50(num_classes=1000,
   compute_dtype=bf16, updater=Momentum(0.1, 0.9))`` (``bench.py``'s
   ``resnet50`` row) trained through ``ComputationGraph.fit`` for 5 steps
   on one seeded batch of 128 224x224x3 inputs, every BN ``fused=True``
   (the kernel path, its steps replayed from a CUDA graph; and eager) and
   ``fused=False`` (the plain path, eager) from identical params: step-1
   loss and running stats held to the plain path, the loss falling, each
   K3 kernel launched 53 times a step (a replay at its capture's count),
   replayed against eager bit for bit (printed), wall and device ms,
   busy share, samples/s, peak memory of both kernel ways; one f32 step
   of each path for the step-1 grads; then ``output()`` with the zoo's
   ``fused="auto"``: 33 normalize launches and per-row KL <= 1e-3 against
   the plain BNs; then ``fit_scanned`` (``bench.py``'s
   ``resnet50_fitscan`` row) from the same init over 4 copies of the
   batch, 2 epochs (the second timed: 4 replays) and a profiled third:
   step 1 within 2e-2 nats of ``fit``'s, the loss falling; every (dtype,
   N, C, activation) K3 ran at must be one that phase 7 held;
   ``--profile-resnet`` profiles one eager step: K3's device time and
   launches by kernel (one a stats and a reduce call) and the
   device-busy share;
9. the fused whole-sequence LSTM kernel (K4) against its plain version,
   on both routes (``fused_lstm.lstm_route`` picks by shape, and in f32
   by T against the waves of clusters the card holds): the cluster route
   (rw resident across a thread-block cluster) and the block route.
   The char-RNN's shape (B 256, T 60, H 256) in bf16 and f32 on both, with
   peepholes, with zero peepholes and with nonzero h0/c0; a ragged B 3,
   T 7, H 40, a T 1, a B 1, a ragged last cluster (B 133) and the route
   boundary (the largest H the cluster route takes, bf16 384 and f32 256,
   and the next, which takes the block route), and f32's T boundary (B 33
   at T 3 and 4, B 256 at T 31 and 32, B 512 at T 60); a second launch bit for
   bit equal; the autograd Function's grads against autograd through the
   plain version; each case's route and plan logged, with the clusters
   the card keeps resident; both routes', plain and ``torch.nn.LSTM``
   (cuDNN, the library yardstick: it includes the input projection, timed
   beside it) times at the path shape;
10. the char-RNN path at full width: ``TextGenerationLSTM(num_classes=77,
   input_shape=(60, 77), units=256, compute_dtype=bf16)`` (``bench.py``'s
   ``charnn`` row, batch 256 of seeded one-hot inputs and labels) trained
   through ``MultiLayerNetwork.fit`` for 5 steps with both GravesLSTMs
   ``fused=True`` (the kernel path, replayed from a CUDA graph and eager)
   and ``fused=False`` (the scan, eager) from identical params: K4
   launched 2 times in every step (a replay at its capture's count) and
   2 times in ``output()`` (counts set to 0 just before the kernel path),
   step-1 loss within 2e-2 nats of the plain path, one f32 step of each
   for the grads (relative L2 per leaf <= 1e-3), the loss falling,
   ``output()`` logits KL <= 1e-3 per row against the scan; replayed
   against eager bit for bit (printed), wall and device ms, K4's device
   share, busy share, samples/s and peak memory of both kernel ways and of
   a replayed ``output()``; every (dtype, B, H, route) K4 ran at must be
   one that phase 9 held, and the path runs the cluster route. Then the
   route A/B: the replayed train step, ``output()`` and ``evaluate`` with
   K4 forced onto the block route and onto the cluster route, in the
   order block, cluster, cluster, block (wall and device ms, K4's share);
11. LeNet at batch 512 bf16 (``bench.py``'s ``lenet`` row) through
   ``MultiLayerNetwork.fit``, 5 steps on seeded 28x28x1 inputs, replayed
   from a CUDA graph and eager from one init: the loss falls, the steps
   replay, ``output()`` rows are finite and sum to 1; then
   ``fit_scanned`` (``bench.py``'s ``lenet_scan`` row) over 8 copies of
   the batch, 2 epochs and a profiled third, step 1 within 2e-2 nats of
   ``fit``'s;
12. the DL4J workflow around ``fit``, each part's kernel counts set to
   0 just before it: ResNet-50 B128 bf16 (Momentum under a
   ``StepSchedule``) fit 12 steps, replayed, with a deferred
   ``ScoreIterationListener`` and a ``MetricsListener`` (the last 5
   timed; the listener's own cost < 2% of their wall, every step and
   step interval counted, its census's params bytes = the params' numel
   x element size, ``dl4j_device_memory_bytes{stat="bytes_in_use"}`` =
   ``torch.cuda.memory_allocated()`` at its poll, the 7 steps equal bit
   for bit to the same 7 eager on a clone with the listener) and then a
   synchronous ``CheckpointListener`` (5 more timed, its save left out),
   the schedule's device count 12, K3 53 launches a step; ``evaluate`` over 4
   seeded batches (``fused="auto"``: 33 normalize launches a batch),
   replayed and eager, its confusion matrix equal to one counted from
   ``output()``, samples/s and the forward's device ms and busy share;
   ``save(save_updater=True)`` → ``load`` → 2 more steps bit-identical to
   the original's 2 (seconds of each, zip size); ``clone``, trained,
   the source bit-identical (memory the clone adds). The char-RNN B256
   T60 under RmsProp with input dropout 0.2 on both LSTMs (K4): 5
   replayed steps equal to 5 eager ones bit for bit, the generator's
   state new after every step and equal to eager's; ``evaluate`` equal
   to ``output()``'s counts; every K4 (shape, route) held in phase 9.
   LeNet B512:
   the eight new updaters under a ``StepSchedule``, 3 steps replayed
   equal to eager; a ``MaxNormConstraint`` holding after every replay;
   a detector with a NaN batch at a replayed step (a no-op, raised one
   step late); wall ms a replayed step and peak memory without and with
   a detector;
13. the serving planes on the paged scheduler, the 120M engine at
   max_seq 1152, 8 slots, page_len 16, 576 pages (``bench.py``'s
   prefix-shared row): K2 first, over a table in which all 8 slots map
   one 1024-token prefix's pages (its plain version, a second launch
   bit for bit, device ms); then, replayed and eager on their own
   engines (each part's schedulers warmed twice on other prompts of the
   same lengths, ``mark_warm()``, each part's counts set to 0 just
   before it), values identical both ways and 0 retraces: (a) prefix
   sharing — a cold leader, 8 followers one at a time, a wave of 8 (9
   prompts of 1024 + 8-64 tokens, 16 new): prefix hits >= 8, the
   slots' pages < their mappings in the wave, greedy tokens equal a
   scheduler's without the cache; (b) a 3-turn session resumed
   append-only: first-token KL against a whole-context prefill <= 1e-3,
   greedy match reported; (c) SCORE of 8 x 512 tokens: 511 finite
   logprobs each, a verify chunk's last row against ``prefill_chunk``'s
   logits, KL <= 1e-3; (d) EMBED mean and last of 4 prompts against the
   plain forward's post-``ln_f`` rows, relative L2 <= 2e-2; (e) BEAM
   width 4, 256 + 16 tokens: best logprob >= greedy's (scored by SCORE)
   - 1e-3 nats, shared pages > 0; (f) CONSTRAINED: an all-true mask
   gives greedy's tokens, a 100-id allowlist keeps every token; K2
   launched in every part that decodes, never the gather path; TTFT
   cold and warm, tokens resident per user shared and dense, SCORE
   tokens/s, BEAM lane tokens/s and gain;
14. the observability plane on phase 4's 120M engine (max_seq 2048),
   replayed and eager on their own engines: the paged scheduler (8
   slots, page_len 16) with ``slo=SLOConfig(...)``, span trees, a sampler
   observation every 32 events and a crash-dump path, beside one at the
   plane's minimum (``trace_spans=False``, ``sample_obs_every=0``, no
   SLO), and phase 4's dense scheduler both ways (its prefills of >= 1024
   tokens run K1: a paged prefill's chunks of 128 never do); all warmed
   twice on other prompts of the same lengths, ``mark_warm()``. One wave:
   16 GENERATE requests of 17-1500 tokens, 32 new, a SCORE of 512 and a
   BEAM of 256 (width 4). Held: values identical full vs minimum and
   replayed vs eager, 0 retraces; the registry's deltas equal the run's
   own counts (requests, tokens, prefills, decode steps, completions by
   reason, kinds), one TTFT a request, the ITL count = the traces' ITL
   samples, one ``serving.decode`` span a decode step; the SLO report =
   one recomputed from the flight recorder's traces; a dump loads back;
   one sampler observation every 32 events, its entropy (reduced on the
   card) = the host formula on the same logits within 1e-4; the census's
   params bytes and ``dl4j_kv_allocated_bytes`` = ``kv_report()``'s; K2
   on the paged wave, K1 once a layer a dense prefill; replayed, the
   self-timed plane cost (``trace_overhead_seconds`` + the sentinels')
   under 2% of the wave's wall, best of 5 waves interleaved full /
   minimum. Printed: the cost split (registry, trace, spans, sampler,
   SLO, sentinels), wave walls and steady sweep walls full vs minimum;
15. the quantization and speculation plane on phase 4's 120M engine at
   its paged geometry (8 slots, page_len 16, 1024 pages), in a fresh
   temporary autotune store: (a) the paged promotion race
   (``decide(mode="race")``): kl_max <= 1e-3 and identical greedy tokens
   of K2 against the gather path, not ``fallback_fidelity``, K2 launched,
   both arms' times and the verdict; a second engine's ``decide`` serves
   the record with no new race; (b) int8 KV: the scheduler with
   ``quant_kv="on"`` beside a bf16 one on the same engine, each warmed on
   other prompts of the same lengths, ``mark_warm()``, a replayed wave of
   8 requests of 40-420 tokens, 64 new, each: 0 retraces, the page
   invariants, K2 launched 0 times on the int8 wave and on the bf16 one;
   on a fresh engine run eagerly, the int8 rows and scales a prefill and
   4 decode steps wrote equal to ``quantize_rows`` of the bf16 rows the
   engine wrote, code for code, every layer; ``race_kv`` (its bf16 arm
   K2): verdict, kl_max, both arms' times, bytes a token (8704 vs
   16384); (c) int8 weights: ``race_weights`` (verdict, kl_max, both
   arms' times), then a wave of the same shape with ``quant_weights=
   "on"``, 0 retraces; (d) ``race_spec`` with ``EngineDraft`` of a 2-layer
   draft (``draft_params``) and ``NgramDraft``, k 4, 64 tokens:
   accepted tokens a step, speedup, identity, verdicts; then the same
   race of the LM in f32, where every arm must be token-identical to
   ``plain_generate``; (e) ``sweep_serving_knobs`` over short candidate
   lists, read back by ``recommended_serving_knobs``;
16. BERT-base (d 768, 12 heads, 12 layers, d_ff 3072, vocab 30522, T 128,
   seeded random weights) and ResNet-50, each part its own path (counts
   set to 0 just before it): (a) the fine-tune of ``bench.py``'s bert row
   (B128, remat "full", bf16 scores, ``bert_classifier_loss`` and AdamW
   2e-5 with optax's defaults, capturable) for 10 steps on one batch,
   compiled (eager, capture, 8 replays; steps 4-10 timed) and eager
   (``disable_graphs()``) from identical params: losses and params bit
   for bit equal, finite and falling; (b) MLM pretraining with
   ``make_bert_mlm_train_step`` on ``BertIterator`` batches (B128 T128,
   special ids, token types and the attention mask) of an in-script
   corpus and WordPiece vocabulary padded to 30522 rows, 2 epochs of 4
   batches, compiled and eager from identical params and generator
   state: bit for bit equal, and two replays on one batch drew
   different masks (recomputed from the generator states), never at a
   special id; (c) BERT-base (bf16, no mask) served through
   ``FunctionalInferenceModel`` + ``ParallelInference(max_batch=64)``:
   batch-1 p50 and p99 of ``output()`` and the read of its result, the
   sweep at 1, 8 and 16, the batch-1 dispatch, device ms and busy share,
   the served logits equal to an eager forward's and within KL 1e-3 of
   the f32 forward's, a burst of 8 one-row ``submit``s resolved by one
   deadline flush that replays a captured graph; (d) ResNet-50 bf16
   served the same way at 1, 8 and 32: rows equal to ``net.output()``'s,
   K3's normalize launched 33 times a batch (a replay at its capture's),
   every (dtype, N, C, activation) K3 ran at held against the plain
   version (phase 7's set, else here), K3 timed at the batch-1 stem
   shape; one capture a batch signature and 0 retraces after warm on
   both served nets; BERT's paths launch no hand-written kernel;
17. the rest of the DL4J workflow, each part its own path: (a)
   ResNet-50 B128 bf16 (Momentum, fused K3) trained with
   ``remat_segments`` None, 3 and 5, each replayed (eager, capture, 3
   replays) and eager: K3 launches a step by kernel (stats and normalize
   twice the monolithic count under remat, the backward reduce and dx
   once), step-1 loss equal and grads (the momentum trace) against the
   monolithic step, replayed = eager bit for bit, 0 retraces after warm,
   wall and device ms, busy share, peak GiB; (b) LeNet B512 through
   ``MnistDataSetIterator`` (synthetic digits) and ``fit``'s async
   prefetch, which must run on the native ring (built from ``native/``),
   against ``fit`` over the same host batches in a list, bit for bit,
   samples/s beside phase 11's; a device-resident ``ListDataSetIterator``
   whose batches pass by reference (never packed through the host) while
   its step is captured with the producer running; (c) the char-RNN
   under ``EarlyStoppingTrainer`` (MaxEpochs + ScoreImprovementEpoch, a
   held-out ``DataSetLossCalculator``): the best model's held-out score
   and params against the record and the best epoch's snapshot, K4
   launches (cluster route) in fit and in the calculator; the same net
   as a ComputationGraph: ``output()`` equal to the MLN's,
   ``rnn_time_step`` over 60 single steps and over 20 + 40 against the
   full output (K4) within 2e-2, a cleared stream restarting; (d) a
   LeNet checkpoint with its updater, saved after 3 steps, loaded and
   trained 3 more, equal to 6 uninterrupted steps bit for bit; (e)
   ``nd.jit_in_workspace`` replayed equal to eager;
18. SameDiff and the TF GraphDef importer at BERT-base width (f32, B32
   T128, TF32 off): (a) ``bert_graphdef`` (the script's own protobuf
   encoder; the card has no TensorFlow) writes BERT-base with seeded
   weights as ``Const`` nodes, ``import_frozen_graph`` reads it, and
   ``sd.eval`` of the logits and hidden states is held to
   ``bert_forward`` (1e-3), replayed = eager bit for bit, 0 retraces after
   warm, import seconds, wall and device ms and launches a forward;
   (b) a classifier head of ``sd.var``s on the imported pooled output
   (the encoder stays constants) fine-tuned by ``SameDiff.fit`` with
   Adam for 5 steps, replayed and eager bit for bit; (c) BERT-base built
   through the SameDiff API (every weight an ``sd.var``): step 1 held to
   autograd of ``bert_classifier_loss`` (loss 1e-4 relative, grads 1e-3
   rel-L2), then 5 ``fit`` steps replayed = eager bit for bit, beside the
   zoo's f32 fine-tune step for reading; (d) a ``while_loop``/``cond``
   graph, eager by structure, equal to its CPU value, a ``save`` →
   ``load`` round trip equal, and every hand-written kernel's launch
   count 0 over the phase;
19. the layer and zoo breadth and the ONNX importer (TF32 off): (a)
   YOLO2 at its defaults (608×608, 80 classes, 5 anchors, the
   passthrough) trained at B8 f32 with the zoo's Adam, replayed (eager,
   capture, 3 replays) and eager under cuDNN's deterministic algorithms,
   bit for bit, 0 retraces after warm; a fresh net from the zoo's seed
   served by ``output()`` at B1 and B8 with its BNs' ``fused=True`` (K3's
   ``bn_act`` once per BN, 22 a forward; every K3 shape it ran held
   against the plain version, one timed; the output equal to the plain
   BN path's), its B8 raw volume decoded by ``get_predicted_objects`` and
   ``nms``; (b) a MultiLayerNetwork with ``SelfAttentionLayer(n_out=512,
   n_heads=8, impl="pallas")``, causal, B8 T2048, trained in f32 (K1, dQ,
   dK/dV on the narrow split-TF32 kernels) and in bf16 (the tensor-core
   ones), replayed = eager, each kernel held against its plain version at
   the path's shape (f32 timed); (c) a ResNet-50 of plain ``torch.nn``
   modules exported to ONNX at B1 (opset 13, the TorchScript exporter
   with an empty ``onnx`` stub), read by ``import_onnx`` and served on the
   card at B1 and B32, held to the module's own output; wall and device
   ms, samples/s, peak GiB and launches by kernel for each path;
20. a DL4J user's import path (TF32 off): (a) the script's own HDF5
   writer (superblock 0, symbol-table groups, version-1 headers,
   contiguous data, variable-length string attributes in a global heap;
   the card has no h5py); (b) the Keras ResNet50 (``tests/
   torch_keras_resnet50.json``: the config Keras 3.13.1 writes, 224×224×3,
   1000 classes, 53 BNs) written with seeded weights, read by
   ``import_keras_model`` onto the card, its BNs ``fused=True``, served at
   B32 f32 by ``output()`` (eager, capture, replay: 53 ``bn_act`` a
   forward) against the eager call and the plain BN path, fine-tuned 3
   steps with ``fit`` (its Dense head an OutputLayer through
   ``TransferLearning``, SGD) replayed and eager bit for bit, 53 launches
   of each K3 kernel a step; host seconds of the write and the import,
   device ms of a forward and a step beside the zoo ResNet-50's; (c) the
   zoo's char-RNN (T60, vocab 77, 2×GravesLSTM 256, Adam, f32) fitted 2
   steps, written as an upstream DL4J zip with its Adam state, restored by
   ``load_model``'s auto-detection: ``output()`` and step 3 equal to the
   writer's bit for bit, K4 on the cluster route (2 a forward, 2 a step);
   (d) a SameDiffLayer MLN fitted 5 steps, replayed = eager; every K3 and
   K4 shape these paths ran held against the plain version;
21. the collective half of ``parallel/`` (TF32 off): (a) ResNet-50 B128
   bf16 through ``ParallelWrapper(net, make_mesh(dp=1))`` on the NCCL
   world of one that ``make_mesh`` starts (no launcher), 5 steps replayed
   — K3's four kernels 53 times each a step from the capture, the BN
   sums' all-reduce inside the graph — and eager, bit for bit; step 1
   (bf16, and f32 with its grads) against the plain path within phase
   8's bars; wall and device ms a step beside plain ``fit``'s; (b) dp 2
   over gloo on the one card: two spawned ranks of this script
   (``--dp-rank``; the port only) on ``cuda:0`` each train B64 of the
   B128 batch one f32 step, K3's sums reduced across them, held to the
   monolithic step (loss, grads, running stats); (c) the 120M LM with 8
   experts a block (top-2, capacity 1.25) trained B32 T1024 bf16 through
   ``make_train_step`` (``AdamW(capturable=True, fused=True)``), replayed
   = eager bit for bit, step 1 against the plain path, K1, dQ and dK/dV
   counted from the capture, the tokens the capacity dropped, device ms
   and peak beside phase 6's dense LM; (d) ``make_ring_train_step`` on
   the NCCL world of one against ``make_train_step`` on the same batch,
   and ``ring_hop`` over 4 chunks of a B8 H8 T4096 D64 bf16 causal
   sequence against one K1 (output, and the q/k/v grads through the
   merges), K1 and its backward counted;
22. the socket half of ``parallel/`` and the serving fleet (TF32 off):
   (a) the 120M LM of bench.py's fleet row (bf16, max_seq 256) behind a
   ``FleetRouter``, 4 slots a replica, a paged pool with the prefix
   cache: R (requests a second of one warm replica in a closed loop of
   prompts of 8/16/32 tokens and 6-8 new), t0 (warm single-request TTFT)
   and s0 (steady sweep) measured first; then one ``run_episode`` (base
   0.3 R, a burst of 4 R from 1 to 2 s, 30 s, 8 sessions, seed 1, SLO 5
   t0 / 5 s0 times the 3 replicas one host thread steps, in 2 s windows,
   the bench's autoscaler, the busiest replica killed at 3 s; if the
   trace saw no scale-down, the idle router is stepped on for at most
   10 s): every future resolved, a scale-up and a scale-down, the killed
   replica the only one dead, a re-prefill and no ghost, every lease
   done, every live page table whole, K2 counted from the captures, no
   compile after warm on the warm replica; goodput and p99 TTFT/ITL from the port's own replay of
   the dump, decode tok/s, the replica range, compiles a replica, each
   replica's first TTFT apart, peak GiB; the same LM in f32 on 2
   replicas, the busiest killed mid-decode: it alone dead, tokens equal
   to ``engine.generate``'s; (b) ``SparkComputationGraph`` of ResNet-50
   224² bf16 on 2 worker threads (each its own clone's compiled step),
   4 shards of B32 × 2 epochs, averaging every step: a worker killed
   after 1 step and respawned (rejoins, leases all done, K3's four
   kernels 53 times a non-replayed worker step, every applied mean the
   hub's bit for bit, a finite loss), then the master killed after
   round 2 and resumed by a second ``fit`` (only the unfinished items
   re-run, the rounds continue); host seconds a round by part and the
   bytes moved, the checkpoint's seconds, a solo step's device ms; (c)
   the threshold codec: a ``GradientExchangeServer`` on TCP loopback and
   2 spawned ranks (``--codec-rank``) on the card, each the char-RNN
   (B128 of the B256 batch, T60, H256, bf16, K4) through
   ``gradient_and_score`` and ``DistributedGradientWorker.step(lr·grad)``
   for 20 steps: the ranks' params bit-identical after every step, K4
   counted, the loss falling; host ms a step by part beside the device
   ms of ``gradient_and_score``, the encoded share, the threshold's
   path;
5. a ``kernels`` JSON line (every hand-written kernel: its route,
   launches on each main path, largest error, times and bound at its
   path shape), then the result line (printed last).

Without a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12                # H100 SXM, NVIDIA data sheet
BWD_F32_ATOL = 1e-4                      # flash backward, f32 grads
BWD_BF16_REL_L2 = 1e-2                   # flash backward, bf16 grads
TRAIN_GRAD_REL_L2 = 2e-2                 # kernel vs plain path, per leaf
TRAIN_LOSS_ATOL = 2e-2                   # nats, at every step
# ResNet-50 at init is chaotic (see resnet_path): it is held to the plain
# path after one step, the bf16 run's forward quantities and the f32
# run's grads (1e-7 of input noise moved those 3.5%, max per leaf)
RESNET_GRAD_REL_L2 = 0.1                 # f32 step-1 grads, per leaf
RESNET_LOSS_ATOL = 2e-2                  # bf16 step-1 loss, nats
RESNET_F32_LOSS_ATOL = 1e-4              # f32 step-1 loss, nats
RESNET_STATE_REL_L2 = 2e-2               # bf16 running mean/var, per tensor
RESNET_F32_STATE_REL_L2 = 1e-4           # f32 running mean/var, per tensor
K3_SUM_RTOL = 1e-4                       # f32 per-channel sums, reordered
K3_EPILOGUE_RTOL = 1e-6                  # mean/var/inv from the same sums
# (dtype, B, T, D) past the fast kernels' D 128 and a bf16 D that is not
# a multiple of 8 (H 8): bf16 D 160 and 256 run K1, dQ and dK/dV padded to
# 256 on the tensor cores; f32 D 130-256 run all three in split TF32 (D
# 130: rows of whole elements, not 16-byte chunks); D 320 and 512 run K1,
# dQ and dK/dV on their wide kernels (bf16 padded to 384 and 512, f32 to
# 320 and 512); bf16 D 12 and D 520 (past the wide kernels) run all three
# general (64, 32, 16 and 8 tile rows), so that the general kernels stay
# held
WIDE_SHAPES = ((torch.bfloat16, 2, 1024, 12),
               (torch.bfloat16, 1, 1024, 160), (torch.float32, 1, 1024, 130),
               (torch.float32, 1, 1024, 160), (torch.float32, 1, 1024, 200),
               (torch.bfloat16, 1, 1024, 256), (torch.float32, 1, 1024, 256),
               (torch.bfloat16, 1, 1024, 320), (torch.float32, 1, 1024, 320),
               (torch.bfloat16, 1, 1024, 512), (torch.float32, 1, 1024, 512),
               (torch.bfloat16, 1, 1024, 520), (torch.float32, 1, 1024, 520))
# K1's wide kernels at every padded width's edges, K1 only (dtype, B, T,
# D): D 264, 328 and 384 (bf16 padded to 384; f32 264 to 320, 328 and 384
# to 384) and 392 (to 512), T 200 (a ragged last tile); with WIDE_SHAPES
# and the D 320 LM every held D in 264-512
WIDE_K1_SHAPES = tuple((dt, 2, 200, d) for d in (264, 328, 384, 392)
                       for dt in (torch.bfloat16, torch.float32))
# the two-warpgroup dQ's own holds (bf16, B, T, causal, D): T 200 (a ragged
# last tile) at every padded-256 width, causal and not, and B1 T1024 D256
# non-causal (the causal one is in WIDE_SHAPES)
DQ_SPLIT_SHAPES = tuple((torch.bfloat16, 2, 200, c, d)
                        for d in (136, 160, 200, 256) for c in (True, False)) \
    + ((torch.bfloat16, 1, 1024, False, 256),)
# the split-TF32 dQ's and dK/dV's own holds (f32, B, T, causal, D): T 200
# (a ragged last tile) at D 130, 160, 200 and 256, causal and not
TF32_BWD_SHAPES = tuple((torch.float32, 2, 200, c, d)
                        for d in (130, 160, 200, 256) for c in (True, False))
# the narrow split-TF32 dQ's and dK/dV's own holds beyond the D 64 and 80
# shapes (dtype, B, T, causal, D): padded 64's smallest and 128's widest
NARROW_BWD_SHAPES = ((torch.float32, 2, 200, True, 16),
                     (torch.float32, 2, 200, False, 128),
                     (torch.float32, 2, 1024, True, 128))
# the narrow split-TF32 K1's own holds beyond the D 64 and 80 shapes
# (dtype, B, T, D): padded 64's smallest and 128's widest, T 200 (a ragged
# last tile)
NARROW_K1_SHAPES = ((torch.float32, 2, 200, 16),
                    (torch.float32, 2, 200, 128))
# the wide dQ's and dK/dV's own holds (dtype, B, T, causal, D): every
# padded width's edges (bf16 264-384 to 384, 392-512 to 512; f32 264-320
# to 320, 328-384 to 384, 392-512 to 512), T 200, causal and not
WIDE_BWD_SHAPES = tuple((dt, 2, 200, c, d)
                        for d in (264, 320, 328, 384, 392, 512)
                        for c in (True, False)
                        for dt in (torch.bfloat16, torch.float32))
# the D 256 LM's attention (B8 H2 T1024 D256): phase 6's train_d256 path
# hands K1, dQ and dK/dV this shape in bf16, train_d256_f32 in f32
D256_LM = (torch.bfloat16, 8, 1024, 256)
D256_LM_F32 = (torch.float32, 8, 1024, 256)
D256_LM_HEADS = 2
# the LM of head dim 320 (d_model 640, 2 heads; phase 4b serves it, phase
# 6's train_d320 and train_d320_f32 train it): K1, dQ and dK/dV at B8 H2
# T1024 D320 on their wide kernels
D320_LM = (torch.bfloat16, 8, 1024, 320)
D320_LM_F32 = (torch.float32, 8, 1024, 320)
D320_D_MODEL = 640
# the phase 3/3b shapes whose times the kernels line and PERF.md's kernel
# table report (every other shape is held, not timed): a dense prefill's
# and the train path's, padded 256 and split TF32 at B1 H8 T1024 D256,
# the f32 narrow split-TF32 kernels at T2048 D64, the wide kernels at D
# 320 and 512, the general kernels at D 520 (the D 256 and D 320 LMs' B8
# H2 shapes are always timed)
TIMED_K1 = {(torch.bfloat16, 1, 2048, 64), (torch.bfloat16, 32, 1024, 64),
            (torch.bfloat16, 1, 1024, 256), (torch.float32, 1, 1024, 256),
            (torch.float32, 1, 2048, 64), (torch.float32, 1, 1024, 320),
            (torch.bfloat16, 1, 1024, 320), (torch.float32, 1, 1024, 512),
            (torch.bfloat16, 1, 1024, 512), (torch.float32, 1, 1024, 520)}
TIMED_BWD = {(dt, b, t, True, d) for dt, b, t, d in TIMED_K1 - {
    (torch.bfloat16, 1, 2048, 64)}}
RESNET_BATCH = 128
RESNET_HW = 224
# every (H = W, C) a BN of ResNet-50 at 224x224 hands K3 (N = batch*H*W):
# the stem's relu BN; per stage the a/b relu BNs at f1 channels (the
# stride sits on the 1x1 a-conv) and the c/shortcut identity BNs at f3
K3_PATH_SHAPES = ((112, 64), (56, 64), (56, 256), (28, 128), (28, 512),
                  (14, 256), (14, 1024), (7, 512), (7, 2048))
# the BN layers of a ResNet-50 train step at each of those shapes (53)
K3_PATH_LAYERS = (1, 6, 4, 8, 5, 12, 7, 6, 4)
# f32 operations per element (relu where an activation applies): the
# normalize a multiply, an add and a max; the stats a subtract and two
# adds and a multiply; the backward passes recompute z, act'(z), dz and
# x-hat and then sum (reduce) or combine (dx) them
K3_OPS = {"bn_act": 3, "bn_stats": 4, "bn_bwd_reduce": 9, "bn_bwd_dx": 11}
# (N, C) tensors each K3 kernel reads and writes, and its (C,) f32 vectors
K3_ROWS = {"bn_act": 2, "bn_stats": 1, "bn_bwd_reduce": 2, "bn_bwd_dx": 3}
# (the reductions read their inputs' vectors and write their fused outputs:
# stats center, gamma, beta in and 7 rows out; backward reduce scale,
# shift, mean, inv in and 4 rows out)
K3_VECS = {"bn_act": 2, "bn_stats": 10, "bn_bwd_reduce": 8, "bn_bwd_dx": 6}
K3_LINES = {"bn_act": 76, "bn_stats": 170, "bn_bwd_reduce": 182,
            "bn_bwd_dx": 202}
PEAK_FLOPS = {torch.bfloat16: 989e12,    # dense tensor-core bf16
              torch.float32: 67e12,      # f32 outside the tensor cores
              "tf32": 495e12}            # dense tensor-core TF32
# the split-TF32 kernels issue three TF32 products per f32 product
TF32X3_PASSES = 3
MAX_KL = 1e-3                            # the reference's PROMOTION_MAX_KL
ATOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
LSE_ATOL = 1e-3
# K4: bf16 outputs part from the plain version, which rounds h and c to
# bf16 at every step while the kernel keeps them in f32 (5.9e-3 measured
# at T 60); f32 only by the order of the recurrent sums
LSTM_ATOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
# K4's kernels by name (the profiles sum their device time): the block
# route's and the cluster route's (bf16 mma, f32 ffma)
K4_KERNEL_NAMES = ("lstm_seq_kernel", "lstm_seq_cluster_")
# the largest H the cluster route takes (then the next, on the block
# route), at B 33 T 6
K4_ROUTE_EDGE = {torch.bfloat16: 384, torch.float32: 256}
CHARNN_BATCH, CHARNN_T, CHARNN_H, CHARNN_VOCAB = 256, 60, 256, 77
CHARNN_LOSS_ATOL = 2e-2                  # bf16 step-1 loss, nats
CHARNN_F32_LOSS_ATOL = 1e-4              # f32 step-1 loss, nats
CHARNN_GRAD_REL_L2 = 1e-3                # f32 step-1 grads, per leaf
LENET_BATCH = 512
# the LM's optimizer: AdamW with optax's defaults, capturable (its step
# count on the card) for the graph; fused=True, one multi-tensor kernel:
# on the 120M step 98.67 against 100.02 ms of device time for the
# foreach form, both inside every bar (phase 6, PR 11's first run)
LM_ADAMW = {"fused": True}
LENET_LOSS_ATOL = 2e-2                   # bf16 step-1 loss, fit_scanned


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, warmup=3):
    """Mean device time of one ``fn`` call: the summed durations of the
    kernels and copies it launches, from a ``torch.profiler`` trace of
    ``iters`` calls. Unlike :func:`cuda_ms` it leaves out the host's
    time between launches, which back-to-back event timing measures
    instead wherever a call's host path outlasts its kernels. The
    profiler now and then loses some of a trace's device events (a
    trace of 20 calls that recorded 19 launches), so each kernel or copy is
    counted at its mean recorded duration times its launches a call (its
    recorded count over ``iters``, rounded, at least 1). A trace with no
    device time at all is taken again, twice at most; after three such
    traces (late in a long run the profiler has recorded none) the call
    is timed by CUDA events instead (:func:`cuda_ms`), and the log says
    so."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(_self_device_us(ev) / ev.count
                 * max(1, round(ev.count / iters))
                 for ev in prof.key_averages()
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and ev.count)
        if us > 0:
            return us / 1e3
        log(f"torch.profiler recorded no device time (trace {attempt + 1} "
            "of 3)")
    log("torch.profiler recorded no device time in 3 traces: this call is "
        "timed by CUDA events")
    return cuda_ms(fn, iters=iters, warmup=0)


def _self_device_us(ev):
    return getattr(ev, "self_device_time_total",
                   getattr(ev, "self_cuda_time_total", 0.0))


def kl_rows(ref_logits, cand_logits):
    """Per-row KL(ref || cand) in nats, f32."""
    lp = torch.log_softmax(ref_logits.float(), dim=-1)
    lq = torch.log_softmax(cand_logits.float(), dim=-1)
    return (lp.exp() * (lp - lq)).sum(dim=-1)


# ---------------------------------------------------------------- phase 2

# K2's slots in phase 2 and ``--flash-times``: (cursor, case)
PAGED_CASES = [(1023, "mapped"), (700, "partial-tail"), (5, "single-page"),
               (900, "cow-shared"), (0, "empty"), (511, "page-boundary"),
               (512, "page-start"), (333, "sentinel-after-cursor")]


def paged_inputs(gen, dtype, h, dh, n_layers=4):
    """q (8, h, dh) and ``n_layers`` pools of 1024 pages of 16 rows, and
    the table and cursors of :data:`PAGED_CASES` (128 entries a slot)."""
    dev = "cuda"
    b, plen, per_slot = len(PAGED_CASES), 16, 128
    npg = b * per_slot
    k = torch.randn((n_layers, npg, plen, h, dh), generator=gen,
                    device=dev).to(dtype)
    v = torch.randn((n_layers, npg, plen, h, dh), generator=gen,
                    device=dev).to(dtype)
    q = torch.randn((b, h, dh), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(npg, generator=torch.Generator().manual_seed(1))
    table = torch.full((b, per_slot), npg, dtype=torch.int32)
    pos = torch.zeros((b,), dtype=torch.int32)
    nxt = 0
    for s, (p, case) in enumerate(PAGED_CASES):
        pos[s] = p
        if case == "empty":
            continue                       # every entry stays the sentinel
        need = p // plen + 1               # pages up to the cursor only
        if case == "cow-shared":
            share = 20                     # first 20 pages shared w/ slot 0
            table[s, :share] = table[0, :share]
            table[s, share:need] = perm[nxt:nxt + need - share].int()
            nxt += need - share
        else:
            table[s, :need] = perm[nxt:nxt + need].int()
            nxt += need
    return q, k, v, table, pos


def check_paged(pa, dtype, gen, h=8, dh=64):
    """K2 vs its plain version at the 120M decode shapes (8 slots,
    page_len 16, H 8, Dh 64, max_len 2048: 128 table entries, contexts up
    to 1024), or at another (h, dh). Timed over 4 layers' pools in turn,
    so each launch reads its pages from device memory rather than from
    L2."""
    dev = "cuda"
    n_layers, b, plen, per_slot = 4, len(PAGED_CASES), 16, 128
    q, k, v, table, pos = paged_inputs(gen, dtype, h, dh, n_layers)
    cases = PAGED_CASES
    live = [s for s, (_, c) in enumerate(cases) if c != "empty"]
    # operations are per (slot, row); bytes per DISTINCT (page, row): the
    # CoW slot's shared pages need reading from device memory only once
    rows = sum(cases[s][0] + 1 for s in live)
    distinct_rows = len({(int(table[s, i // plen]), i % plen)
                         for s in live for i in range(cases[s][0] + 1)})
    table, pos = table.to(dev), pos.to(dev)
    empty = [s for s, (_, c) in enumerate(cases) if c == "empty"]
    out = pa.paged_attention(q, k[0], v[0], table, pos)
    again = pa.paged_attention(q, k[0], v[0], table, pos)
    ref = pa.paged_attention_reference(q, k[0], v[0], table, pos)
    torch.cuda.synchronize()
    repeats = bool(torch.equal(out, again))
    err = (out[live].float() - ref[live].float()).abs().max().item()
    err_empty = out[empty].float().abs().max().item()
    ok = err <= ATOL[dtype] and err_empty == 0.0 and repeats
    plan = pa.split_plan(b, h, dh, q.element_size(), plen, per_slot,
                         torch.cuda.get_device_properties(0)
                         .multi_processor_count)
    layer = [0]

    def run_kernel():
        layer[0] = (layer[0] + 1) % n_layers
        pa.paged_attention(q, k[layer[0]], v[layer[0]], table, pos)

    def run_plain():
        layer[0] = (layer[0] + 1) % n_layers
        pa.paged_attention_reference(q, k[layer[0]], v[layer[0]], table,
                                     pos)

    # device time of both passes (the profiler's), and a call timed by
    # events, the host's path included
    ms = device_ms(run_kernel, iters=50)
    call_ms = cuda_ms(run_kernel, iters=50)
    plain_ms = device_ms(run_plain, iters=10)
    item = torch.finfo(dtype).bits // 8
    nbytes = (2 * distinct_rows * h * dh * item + 2 * b * h * dh * item
              + table.numel() * 4 + pos.numel() * 4)
    flops = 4 * rows * h * dh
    bms, by = bound_ms(nbytes, flops, dtype)
    log(f"K2 paged_attention {str(dtype)[6:]} H{h} Dh{dh}: max_abs_err "
        f"{err:.3e} "
        f"(atol {ATOL[dtype]}), empty slot max |out| {err_empty:.1e}, "
        f"second launch {'identical' if repeats else 'DIFFERS'}; split "
        f"plan {dataclasses.asdict(plan)}; device ms: kernel (both "
        f"passes) {ms:.4f} (a call with the host's path {call_ms:.4f}), "
        f"plain {plain_ms:.4f}, bound {bms:.5f} ({by}; kernel "
        f"{ms / bms:.1f}x), live rows {rows} ({distinct_rows} distinct) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"K2 {dtype} Dh {dh} disagrees with its plain "
                         "version or does not repeat")
    return {"max_abs_err": err, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "rows": rows, "distinct_rows": distinct_rows}


# ---------------------------------------------------------------- phase 3

def route_counts(fa, part=""):
    """Each kernel family's launch counter of K1 (part "") or of the
    backward's "dq" or "dkv" kernel: family → count."""
    kernel = part or "fwd"
    return {f: getattr(fa, fa.launch_counter(kernel, f), 0)
            for f in fa.FAMILY_SUFFIX}


def route_state(fa, before, part, d, dtype):
    """(ok, text): the kernel family ``fa.route`` names for (d, dtype) in
    K1 (part "") or the "dq" or "dkv" kernel launched once since
    ``before`` = :func:`route_counts`, and no other family did."""
    kind = fa.route(d, dtype, part or "fwd")
    now = route_counts(fa, part)
    ok = all(now[f] - before[f] == int(f == kind) for f in now)
    return ok, f"{kind} kernel {'ran' if ok else 'MISSED'}"


def check_flash(fa, dtype, b, t, gen, h=8, d=64, time_it=True):
    """K1 vs mha_reference (O and lse), causal, (B, H, T, D); the same
    inputs through the strided (B, T, H, D) entry point; a second launch
    bit for bit equal to the first; the kernel family of ``fa.route``
    (bf16 tensor cores up to D 256, the general kernel past it) must run.
    With ``time_it``: kernel, plain and SDPA timed."""
    dev = "cuda"
    q, k, v = (torch.randn((b, h, t, d), generator=gen, device=dev)
               .to(dtype) for _ in range(3))
    before = route_counts(fa)
    out, lse = fa.flash_attention_lse(q, k, v, causal=True)
    tc_ok, route = route_state(fa, before, "", d, dtype)
    again, lse_again = fa.flash_attention_lse(q, k, v, causal=True)
    repeats = bool(torch.equal(out, again) and torch.equal(lse, lse_again))
    del again, lse_again
    ref, ref_lse = fa.mha_reference_lse(q, k, v, causal=True)
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    # the transformer's layout: q/k/v as strided views of one qkv buffer
    qkv = torch.cat([x.transpose(1, 2).reshape(b, t, h * d)
                     for x in (q, k, v)], dim=-1)
    qn, kn, vn = (x.reshape(b, t, h, d) for x in qkv.chunk(3, dim=-1))
    out_ntc = fa.flash_attention_ntc(qn, kn, vn, causal=True)
    ntc_err = (out_ntc.transpose(1, 2).float() - ref.float()).abs().max() \
        .item()
    del ref, ref_lse, out_ntc, qkv, qn, kn, vn
    torch.cuda.synchronize()
    ok = (err <= ATOL[dtype] and ntc_err <= ATOL[dtype]
          and lse_err <= LSE_ATOL and repeats and tc_ok)
    held = (f"K1 flash_attention_fwd {str(dtype)[6:]} B{b} H{h} T{t} D{d}: "
            f"O err {err:.3e}, ntc err {ntc_err:.3e} (atol {ATOL[dtype]}), "
            f"lse err {lse_err:.3e} (atol {LSE_ATOL}), second launch "
            f"{'identical' if repeats else 'DIFFERS'}, {route}")
    if not ok:
        log(f"{held} -> FAIL")
        raise SystemExit(f"K1 {dtype} B{b} T{t} disagrees with "
                         "mha_reference, does not repeat or missed its "
                         "kernel")
    if not time_it:
        log(f"{held} (not timed) -> ok")
        return {"max_abs_err": max(err, ntc_err), "lse_err": lse_err}
    # device times (the profiler's); call_ms also counts the host's path
    # (autograd Function, ctypes), which outlasts a short kernel
    ms = device_ms(lambda: fa.flash_attention_lse(q, k, v, causal=True))
    call_ms = cuda_ms(lambda: fa.flash_attention_lse(q, k, v, causal=True))
    plain_ms = device_ms(lambda: fa.mha_reference_lse(q, k, v, causal=True),
                         iters=5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = device_ms(lambda: sdpa(q, k, v, is_causal=True))
    library_call_ms = cuda_ms(lambda: sdpa(q, k, v, is_causal=True))
    item = torch.finfo(dtype).bits // 8
    nbytes = 4 * b * h * t * d * item + b * h * t * 4
    flops = 4 * b * h * d * t * (t + 1) // 2
    bms, by = bound_ms(nbytes, flops, dtype)
    extra = {}
    if fa.route(d, dtype, "fwd") in ("tf32x3", "tf32x3-wide"):
        # the operations it issues: three TF32 products per f32 product;
        # the f32 CUDA-core bound stays beside it
        extra["ffma_bound_ms"] = bms
        bms, by = bound_ms(nbytes, TF32X3_PASSES * flops, "tf32")
    log(f"{held}; device ms: kernel {ms:.4f} (a "
        f"call with the host's path {call_ms:.4f}), plain {plain_ms:.4f}, "
        f"sdpa {library_ms:.4f} (a call {library_call_ms:.4f}), bound "
        f"{bms:.5f} ({by}){''.join(f', {k} {v:.5f}' for k, v in extra.items())}"
        " -> ok")
    return {"max_abs_err": max(err, ntc_err), "lse_err": lse_err, "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bms, "bound_by": by,
            **extra}


# --------------------------------------------------------------- phase 3b

def rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def grad_ok(got, ref, dtype):
    """f32: max |err| <= 1e-4; bf16: relative L2 <= 1e-2."""
    if dtype == torch.float32:
        return (got - ref).abs().max().item() <= BWD_F32_ATOL
    return rel_l2(got, ref) <= BWD_BF16_REL_L2


def bwd_bounds(dtype, b, h, t, d, causal, peak=None):
    """(dq, dkv) bounds: operations 6 (dQ) and 8 (dK/dV) · D per live
    (query, key) pair at ``dtype``'s peak, or three times that at the TF32
    rate (``peak`` "tf32": the split-TF32 kernels' products); bytes each
    operand read once (q, k, v, dO, lse, delta) and each output written
    once."""
    passes = TF32X3_PASSES if peak == "tf32" else 1
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    item = torch.finfo(dtype).bits // 8
    rows = b * h * t
    dq = bound_ms(5 * rows * d * item + 2 * rows * 4,
                  passes * 6 * d * pairs, peak or dtype)
    dkv = bound_ms(6 * rows * d * item + 2 * rows * 4,
                   passes * 8 * d * pairs, peak or dtype)
    return dq, dkv


def check_flash_bwd(fa, dtype, b, t, causal, gen, h=8, d=64, time_it=True):
    """The dQ and dK/dV kernels vs ``flash_attention_bwd_reference`` on
    the same inputs, q/k/v strided (B, T, H, D) views of one qkv buffer
    as in the transformer; the Function (K1 + both kernels) vs autograd
    through ``mha_reference``; with ``time_it``, kernel, plain and
    SDPA-backward times."""
    dev = "cuda"
    scale = d ** -0.5
    qkv = torch.randn((b, t, 3 * h * d), generator=gen, device=dev).to(dtype)
    q, k, v = (x.reshape(b, t, h, d) for x in qkv.chunk(3, dim=-1))
    do = torch.randn((b, t, h, d), generator=gen, device=dev).to(dtype)
    qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))
    o, lse = fa.mha_reference_lse(qh, kh, vh, causal=causal)
    delta = (doh.float() * o.float()).sum(-1).contiguous()
    del o
    ref = fa.flash_attention_bwd_reference(qh, kh, vh, doh, lse, delta,
                                           scale, causal)
    before = route_counts(fa, "dq"), route_counts(fa, "dkv")
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, causal,
                                   "bthd")
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale,
                                        causal, "bthd")
    dq_ok, dq_route = route_state(fa, before[0], "dq", d, dtype)
    dkv_ok, dkv_route = route_state(fa, before[1], "dkv", d, dtype)
    tc_ok = dq_ok and dkv_ok
    route = (dq_route if dq_route == dkv_route
             else f"dQ {dq_route}, dK/dV {dkv_route}")
    dq2 = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, causal,
                                    "bthd")
    dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale,
                                          causal, "bthd")
    repeats = bool(torch.equal(dq, dq2) and torch.equal(dk, dk2)
                   and torch.equal(dv, dv2))
    del dq2, dk2, dv2
    torch.cuda.synchronize()
    got = [x.transpose(1, 2) for x in (dq, dk, dv)]
    ok = all(grad_ok(g, r, dtype) for g, r in zip(got, ref)) and repeats \
        and tc_ok
    err = [(g.float() - r.float()).abs().max().item()
           for g, r in zip(got, ref)]
    rel = [rel_l2(g, r) for g, r in zip(got, ref)]
    del ref, got, dq, dk, dv

    # the autograd Function against autograd through the plain forward
    x = qkv.detach().requires_grad_(True)
    views = [c.reshape(b, t, h, d) for c in x.chunk(3, dim=-1)]
    (g_fn,) = torch.autograd.grad(
        fa.flash_attention_ntc(*views, causal=causal), x, do)
    ref_out = fa.mha_reference(*(c.transpose(1, 2) for c in views),
                               causal=causal)
    (g_ref,) = torch.autograd.grad(ref_out, x, doh)
    del ref_out
    fn_ok = grad_ok(g_fn, g_ref, dtype)
    fn_rel = rel_l2(g_fn, g_ref)
    del g_fn, g_ref, x, views
    held = (f"flash bwd {str(dtype)[6:]} B{b} H{h} T{t} D{d} "
            f"{'causal' if causal else 'non-causal'}: max_abs_err dq/dk/dv "
            f"{err[0]:.3e}/{err[1]:.3e}/{err[2]:.3e}, rel L2 {rel[0]:.2e}/"
            f"{rel[1]:.2e}/{rel[2]:.2e}, Function vs autograd rel L2 "
            f"{fn_rel:.2e}, second launch "
            f"{'identical' if repeats else 'DIFFERS'}, dQ and dK/dV: {route}"
            f"{'' if tc_ok else ' (one MISSED)'}")
    if not (ok and fn_ok):
        log(f"{held} -> FAIL")
        raise SystemExit(f"flash backward {dtype} B{b} T{t} causal={causal} "
                         "disagrees with the plain backward, does not "
                         "repeat or missed its kernel")
    if not time_it:
        log(f"{held} (not timed) -> ok")
        return {"dq": {"max_abs_err": err[0]},
                "dkv": {"max_abs_err": max(err[1:])}}

    ms_dq = device_ms(lambda: fa.flash_attention_bwd_dq(
        q, k, v, do, lse, delta, scale, causal, "bthd"), iters=5, warmup=1)
    call_ms_dq = cuda_ms(lambda: fa.flash_attention_bwd_dq(
        q, k, v, do, lse, delta, scale, causal, "bthd"), iters=5, warmup=1)
    ms_dkv = device_ms(lambda: fa.flash_attention_bwd_dkv(
        q, k, v, do, lse, delta, scale, causal, "bthd"), iters=5, warmup=1)
    # a call timed by events, host path included
    call_ms_dkv = cuda_ms(lambda: fa.flash_attention_bwd_dkv(
        q, k, v, do, lse, delta, scale, causal, "bthd"), iters=5, warmup=1)
    plain_ms = device_ms(lambda: fa.flash_attention_bwd_reference(
        qh, kh, vh, doh, lse, delta, scale, causal), iters=3, warmup=1)
    qs, ks, vs = (y.contiguous().requires_grad_(True) for y in (qh, kh, vh))
    out = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=causal)
    doc = doh.contiguous()
    library_ms = device_ms(lambda: torch.autograd.grad(
        out, (qs, ks, vs), doc, retain_graph=True), iters=10)
    del out
    (bq, byq), (bkv, bykv) = bwd_bounds(dtype, b, h, t, d, causal)
    extra = {"dq": {}, "dkv": {}}
    if fa.route(d, dtype, "dq") in ("tf32x3", "tf32x3-wide"):
        # the operations they issue: three TF32 products per f32 product;
        # the f32 CUDA-core bound stays beside it
        extra = {"dq": {"ffma_bound_ms": bq}, "dkv": {"ffma_bound_ms": bkv}}
        (bq, byq), (bkv, bykv) = bwd_bounds(dtype, b, h, t, d, causal,
                                            peak="tf32")
    ffma = (f", f32 FFMA bounds dq {extra['dq']['ffma_bound_ms']:.5f}, dkv "
            f"{extra['dkv']['ffma_bound_ms']:.5f}" if extra["dq"] else "")
    log(f"{held}; device ms: dq {ms_dq:.4f} ms (a "
        f"call {call_ms_dq:.4f}; bound {bq:.5f}, {byq}: {ms_dq / bq:.1f}x; "
        f"{ms_dq / library_ms:.3f}x sdpa's whole backward), dkv "
        f"{ms_dkv:.4f} ms (a call {call_ms_dkv:.4f}; bound {bkv:.5f}, "
        f"{bykv}){ffma}, dq + dkv {ms_dq + ms_dkv:.4f} ms, plain backward "
        f"{plain_ms:.4f} ms, sdpa backward {library_ms:.4f} ms -> ok")
    return {"dq": {"max_abs_err": err[0], "ms": ms_dq, "call_ms": call_ms_dq,
                   "bound_ms": bq, "bound_by": byq, **extra["dq"]},
            "dkv": {"max_abs_err": max(err[1:]), "ms": ms_dkv,
                    "bound_ms": bkv, "bound_by": bykv, **extra["dkv"]},
            "plain_ms": plain_ms, "library_ms": library_ms}


# ---------------------------------------------------------------- phase 4

def serve(sched, prompts, n_new):
    """One wave: submit every prompt, run the scheduler until idle. Returns
    the wave's readings and every request's tokens."""
    futs = [sched.submit(p, max_new_tokens=n_new) for p in prompts]
    t0 = time.perf_counter()
    st0 = dict(sched.stats)
    sched.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    results = [f.result(timeout=0) for f in futs]
    for p, r in zip(prompts, results):
        if len(r.tokens) != n_new or r.finish_reason != "length":
            raise SystemExit(f"request of {len(p)} tokens resolved with "
                             f"{len(r.tokens)} tokens ({r.finish_reason})")
        if not ((r.tokens >= 0) & (r.tokens < 32000)).all():
            raise SystemExit("generated ids outside the vocabulary")
    sched.check_pages()
    st = {k: v - st0[k] for k, v in sched.stats.items()}
    ttft = [r.ttft_s for r in results]
    return {"requests": len(results), "wall_s": wall,
            "decode_tok_per_s": st["decode_tokens"] / st["decode_s"],
            "decode_steps": st["decode_steps"],
            "ttft_mean_s": float(np.mean(ttft)),
            "ttft_max_s": float(np.max(ttft)),
            "preemptions": st["preemptions"]}, [r.tokens for r in results]


def serving_counts(fa, pa):
    return {"flash_attention_fwd": fa.LAUNCHES,
            "flash_attention_fwd_tc": fa.LAUNCHES_TC,
            "flash_attention_fwd_tc_wide": fa.LAUNCHES_TC_WIDE,
            "paged_attention": pa.LAUNCHES}


class StepLaunches:
    """Kernel launches of the calls through compiled steps (``steps``:
    name → ``CompiledStep``; an engine's are its sentinels' ``_fn``),
    counted from their captures: a direct, eager or capture call counts
    what its wrappers launched while its body ran (a capture replays
    once), a replay what its signature's capture recorded (its wrappers
    do not run). ``read()`` returns the counts as a dict; :meth:`reset`
    sets them to 0."""

    def __init__(self, steps, read):
        self.read, self.total, self._captured, self._last = read, {}, {}, {}
        for name, step in steps.items():
            step.step = self._counted(step.step)
            step.hooks.append(
                lambda kind, key, name=name: self._on(name, kind, key))

    def _counted(self, body):
        def run(*a, **k):
            before = self.read()
            out = body(*a, **k)
            self._last = {n: c - before[n] for n, c in self.read().items()}
            return out
        return run

    def _on(self, name, kind, key):
        if kind == "capture":
            self._captured[(name, key)] = self._last
        got = self._captured[(name, key)] if kind == "replay" else self._last
        for n, c in got.items():
            self.total[n] = self.total.get(n, 0) + c

    def reset(self):
        self.total = {}


def compile_summary(engine):
    """{entry point: [compiles, signatures, retraces after warm]} of the
    entry points that compiled."""
    return {n: [r["compiles"], r["signatures"], r["retraces_after_warm"]]
            for n, r in engine.compile_report().items() if r["compiles"]}


def serve_ways(fa, pa, cfg, params, waves, n_new, profile=False,
               sweeps=True):
    """Phase 4's two ways over every path in ``waves`` (path → scheduler
    keywords, prompts): ``replayed`` (graphs) and ``eager``
    (``disable_graphs()``), each on its own engine. Per way: one
    scheduler a path; a warm wave of each path with the timed wave's
    prompt lengths (every signature the timed wave reaches); then
    ``mark_warm()``; then each path's timed wave, its launch counts set
    to 0 just before it and read just after (from the captures); then,
    with ``sweeps``, each path's steady sweeps (:func:`steady_sweeps`)
    and, on a fresh engine, one chunk (:func:`chunk_split`)."""
    from deeplearning4j_tpu_torch import disable_graphs
    from deeplearning4j_tpu_torch.serving import (
        ContinuousBatchingScheduler, GenerationEngine)
    out = {}
    for way in ("replayed", "eager"):
        engine = GenerationEngine(cfg, params)
        counts = StepLaunches({n: st._fn for n, st in
                               engine.sentinels.items()},
                              lambda: serving_counts(fa, pa))
        scheds = {path: ContinuousBatchingScheduler(engine, **kw)
                  for path, (kw, _) in waves.items()}
        rec = out[way] = {}
        with contextlib.nullcontext() if way == "replayed" \
                else disable_graphs():
            for path, (_, prompts) in waves.items():
                serve(scheds[path], prompts, n_new)
            engine.mark_warm()
            for path, (_, prompts) in waves.items():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                fa.reset_launches()
                pa.reset_launches()
                counts.reset()
                res, tokens = serve(scheds[path], prompts, n_new)
                res["peak_alloc_gib"] = torch.cuda.max_memory_allocated() \
                    / 2**30
                rec[path] = {"wave": res, "tokens": tokens,
                             "launches": dict(counts.total),
                             "wrapper_launches": serving_counts(fa, pa)}
                if sweeps:
                    rec[path]["sweep"] = steady_sweeps(scheds[path], 600,
                                                       profile=profile)
            rec["compiles"] = compile_summary(engine)
            if sweeps:
                rec["chunk"] = chunk_split(GenerationEngine(cfg, params))
        del engine, scheds, counts
        gc.collect()                  # the graphs go with their engine
        torch.cuda.empty_cache()
    return out


def serve_checked(fa, pa, cfg, params, waves, n_new, tag, k1_key,
                  profile=False, sweeps=True):
    """:func:`serve_ways` over ``waves`` and phase 4's holds: every
    request's tokens identical replayed and eager, 0 retraces after warm,
    K1 launched once a layer in every dense prefill whose bucket reaches
    ``flash_min_seq``, each launch on the family whose count is
    ``k1_key`` (a :func:`serving_counts` key), and K2 in the paged path.
    Returns path → the replayed timed wave's launch counts."""
    from deeplearning4j_tpu_torch.serving import GenerationEngine
    ways = serve_ways(fa, pa, cfg, params, waves, n_new, profile=profile,
                      sweeps=sweeps)
    rep, eag = ways["replayed"], ways["eager"]
    buckets = GenerationEngine(cfg, params).prefill_buckets
    failed = []
    by_path = {}
    for path, (_, prompts) in waves.items():
        r, e = rep[path], eag[path]
        by_path[path] = r["launches"]
        # every dense prefill whose bucket reaches flash_min_seq runs K1
        # once a layer, on the tensor cores (bf16); paged prefills in
        # chunks of 128 never do
        flash_prefills = sum(
            next(bk for bk in buckets if bk >= len(p)) >= cfg.flash_min_seq
            for p in prompts) if path == "dense" else 0
        want = cfg.n_layers * flash_prefills
        same = [bool(np.array_equal(a, b))
                for a, b in zip(r["tokens"], e["tokens"])]
        for way, w in (("replayed", r), ("eager", e)):
            got = w["launches"]
            log(f"{tag} {path} {way} ({waves[path][0]}, prompts "
                f"{min(map(len, prompts))}-{max(map(len, prompts))}, "
                f"{n_new} new, D{cfg.head_dim}): {json.dumps(w['wave'])}; "
                f"launches (captures' counts) {json.dumps(got)}, wrappers' "
                f"own {json.dumps(w['wrapper_launches'])}"
                + (f"; steady sweeps {json.dumps(w['sweep'])}"
                   if sweeps else ""))
            if got.get(k1_key, 0) != want \
                    or got.get("flash_attention_fwd", 0) != want:
                failed.append(f"{path} {way}: {got} K1 launches, want "
                              f"{cfg.n_layers} ({k1_key}) in each of "
                              f"{flash_prefills} prefills >= "
                              f"{cfg.flash_min_seq} tokens")
        log(f"{tag} {path}: tokens identical replayed and eager for "
            f"{sum(same)} of {len(same)} requests")
        if not all(same):
            failed.append(f"{path}: replayed tokens differ from eager")
    for way, w in ways.items():
        retr = sum(c[2] for c in w["compiles"].values())
        log(f"{tag} serving {way}: compile report [compiles, signatures, "
            f"retraces after warm] {json.dumps(w['compiles'])}"
            + (f"; one 128-token chunk {json.dumps(w['chunk'])}"
               if sweeps else ""))
        if retr:
            failed.append(f"{way}: {retr} retraces after warm")
    # K1 runs in the dense path's prefills (buckets >= 1024), K2 in the
    # paged path's decode sweeps
    for path, name in (("dense", "flash_attention_fwd"),
                       ("paged", "paged_attention")):
        if by_path[path].get(name, 0) <= 0:
            failed.append(f"kernel {name} was not launched on the {path} "
                          "main path")
    if failed:
        raise SystemExit(f"{tag} serving: {failed}")
    return by_path


def prefill_kl(cfg, params, prompt):
    """One dense prefill (``prefill_slot``) of ``prompt`` through K1 and
    through the plain attention arm (kernel off, f32 scores): per-row
    KL(plain || kernel) and both logits."""
    from deeplearning4j_tpu_torch.serving import GenerationEngine
    engine = GenerationEngine(cfg, params)
    plain_cfg = dataclasses.replace(cfg, use_flash_attention=False,
                                    attn_scores_bf16=False)
    plain_eng = GenerationEngine(plain_cfg, params)
    lk, _ = engine.prefill_slot(engine.init_cache(1), prompt, 0)
    lp, _ = plain_eng.prefill_slot(plain_eng.init_cache(1), prompt, 0)
    return kl_rows(lp[None], lk[None]), lk, lp


# phase 4's two schedulers: path → keywords
MAIN_PATHS = {"dense": {"n_slots": 4}, "paged": {"n_slots": 8, "page_len": 16}}


def main_config(tfm):
    """The flagship 120M engine (bench.py's serving engine) at max_seq
    2048, and its seeded weights."""
    cfg = tfm.TransformerConfig(vocab_size=32000, d_model=512, n_heads=8,
                                n_layers=8, d_ff=2048, max_seq=2048,
                                dtype=torch.bfloat16, remat=False)
    return cfg, tfm.init_params(cfg, torch.Generator().manual_seed(0))


def main_path(fa, pa, profile=False):
    from deeplearning4j_tpu_torch.serving import GenerationEngine, PageTable
    from deeplearning4j_tpu_torch.serving import kvcache
    from deeplearning4j_tpu_torch.zoo import transformer as tfm

    cfg, params = main_config(tfm)
    rng = np.random.default_rng(0)
    dense_prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                     for n in (600, 900, 1200, 1500)]
    paged_prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                     for n in (17, 140, 260, 385, 512, 640, 777, 900)]
    n_new = 32
    waves = {"dense": (MAIN_PATHS["dense"], dense_prompts),
             "paged": (MAIN_PATHS["paged"], paged_prompts)}
    by_path = serve_checked(fa, pa, cfg, params, waves, n_new, "main path",
                            "flash_attention_fwd_tc", profile=profile)

    # K1 prefill vs the plain attention arm (kernel off, f32 scores)
    kl1, lk, lp = prefill_kl(cfg, params, dense_prompts[-1])  # → 2048
    # K2 decode step vs the gather path on identical paged caches
    on = GenerationEngine(cfg, params, paged_kernel="on")
    off = GenerationEngine(cfg, params, paged_kernel="off")
    cache = off.init_paged_cache(8, 8 * 128, 16)
    table = PageTable.for_cache(cache)
    for s, p in enumerate(paged_prompts):
        table.map(s, len(p) + 1)
        table.sync(cache)
        for c0 in range(0, len(p), off.chunk_len):
            _, cache = off.prefill_chunk(cache, p[c0:c0 + off.chunk_len], s,
                                         start=c0)
    twin = {name: t.clone() for name, t in cache.items()}
    toks = np.array([int(p[-1]) for p in paged_prompts], np.int32)
    l_on, _ = on.decode_step(twin, toks)
    l_off, _ = off.decode_step(cache, toks)
    kl2 = kl_rows(l_off, l_on)
    if not kvcache.is_paged(twin) or pa.decide(on, twin) != "kernel":
        raise SystemExit("the kernel-on engine did not pick the kernel")
    finite = bool(torch.isfinite(lk).all() and torch.isfinite(l_on).all())
    log(f"KL(plain || kernel): K1 prefill {kl1.max().item():.3e}, K2 decode "
        f"max over 8 rows {kl2.max().item():.3e} (limit {MAX_KL}); "
        f"argmax agree K1 {bool(lk.argmax() == lp.argmax())}, K2 "
        f"{(l_on.argmax(-1) == l_off.argmax(-1)).float().mean().item():.3f}")
    if not finite or kl1.max().item() > MAX_KL or kl2.max().item() > MAX_KL:
        raise SystemExit("full-width logits disagree with the plain path")
    del on, off, cache, twin
    torch.cuda.empty_cache()
    return by_path


def serve_d320(fa, pa):
    """Phase 4b: the LM of head dim 320 (d_model 640, 2 heads, 2 layers,
    d_ff 2560, max_seq 2048; seeded random weights) served through the
    scheduler as phase 4 serves the 120M LM, replayed and eager: a dense
    wave of 4 slots and a paged wave of 4 slots (page_len 16), prompts of
    1024-1500 tokens, 32 new tokens. Every dense prefill launches K1 on
    the bf16 wide kernel once a layer; the paged decode runs K2 at Dh
    320; one K1 prefill against the plain arm, per-row KL <= 1e-3.
    Returns the replayed waves' launch counts by path."""
    from deeplearning4j_tpu_torch.zoo import transformer as tfm
    cfg = tfm.TransformerConfig(vocab_size=32000, d_model=D320_D_MODEL,
                                n_heads=2, n_layers=2,
                                d_ff=4 * D320_D_MODEL, max_seq=2048,
                                dtype=torch.bfloat16, remat=False)
    assert cfg.head_dim == D320_LM[3]
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    # two prompts in each prefill bucket (1024 and 2048), so that the
    # warm wave reaches every signature's capture, as phase 4's does
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (1024, 1024, 1350, 1500)]
    waves = {"dense": ({"n_slots": 4}, prompts),
             "paged": ({"n_slots": 4, "page_len": 16}, prompts)}
    by_path = serve_checked(fa, pa, cfg, params, waves, 32, "serve D320",
                            "flash_attention_fwd_tc_wide", sweeps=False)
    kl, lk, lp = prefill_kl(cfg, params, prompts[-1])
    finite = bool(torch.isfinite(lk).all())
    log(f"serve D320: KL(plain || kernel) of a K1 prefill (1500 tokens) "
        f"{kl.max().item():.3e} (limit {MAX_KL}); argmax agree "
        f"{bool(lk.argmax() == lp.argmax())}")
    if not finite or not kl.max().item() <= MAX_KL:
        raise SystemExit("serve D320: K1 prefill disagrees with the plain "
                         "path")
    torch.cuda.empty_cache()
    return {f"serve_d320_{p}": c for p, c in by_path.items()}


# ---------------------------------------------------------------- phase 6

def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [nl for k, v in tree.items()
                for nl in _named_leaves(v, f"{prefix}/{k}")]
    return [(prefix, tree)]


def lm_setup(tfm, batch, n_heads, n_layers, dtype, d_model=512,
             n_experts=0, capacity_factor=1.25):
    """The LM of ``bench.py``'s transformer row (bench.py:594-598; T 1024,
    d_model 512) at the given heads, depth, compute dtype and width
    (``d_model`` 640 at 2 heads: the LM of head dim 320), with
    ``n_experts`` MoE experts a block (top-2, at ``capacity_factor``: the
    reference's default 1.25) where given: its config, params from seed 0
    and one batch of seeded ids and targets."""
    cfg = tfm.TransformerConfig(vocab_size=32000, d_model=d_model,
                                n_heads=n_heads, n_layers=n_layers,
                                d_ff=2048, max_seq=1024,
                                n_experts=n_experts,
                                capacity_factor=capacity_factor,
                                dtype=dtype, fused_loss=True,
                                remat=True, remat_policy="save_attn",
                                attn_scores_bf16=dtype == torch.bfloat16)
    init = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (batch, cfg.max_seq))
    tgt = rng.integers(0, cfg.vocab_size, (batch, cfg.max_seq))
    ids, tgt = (torch.as_tensor(a, device="cuda") for a in (ids, tgt))
    return cfg, init, ids, tgt


# the flash kernels' wrappers, and the key suffix of each kernel family's
# launches in a path's counts
FLASH_NAMES = {"fwd": "flash_attention_fwd", "dq": "flash_attention_bwd_dq",
               "dkv": "flash_attention_bwd_dkv"}
FAMILY_KEYS = {"wgmma": "tc", "tf32x3": "tf32x3", "general": "general",
               "wgmma-wide": "tc_wide", "tf32x3-wide": "tf32x3_wide"}
# the TPU kernel each replaces: deeplearning4j_tpu/kernels/flash_attention.py
FLASH_LINES = {"fwd": 51, "dq": 146, "dkv": 186}


def flash_counts(fa):
    """Every flash launch counter, keyed as a path's counts are:
    ``flash_attention_fwd`` (any family), ``flash_attention_fwd_tc``, ...,
    and ``flash_attention_bwd_dq_tf32x3_narrow`` (the narrow kernels)
    """
    out = {}
    for kernel, name in FLASH_NAMES.items():
        out[name] = getattr(fa, fa.launch_counter(kernel))
        for fam, key in FAMILY_KEYS.items():
            out[f"{name}_{key}"] = getattr(fa, fa.launch_counter(kernel, fam),
                                           0)
        out[f"{name}_tf32x3_narrow"] = getattr(
            fa, fa.launch_counter(kernel, "tf32x3", narrow=True))
    return out


# each train_path run's kernel-path record, by tag (phase 21 reads phase
# 6's dense LM beside the MoE LM)
TRAIN_RECORDS = {}


class PinnedRouting:
    """Wraps the transformer's ``_moe_mlp`` while a check runs: in
    ``"record"`` mode each MoE block takes the router's top-k and keeps
    it (the block keyed by its router's offset in the stacked params),
    in ``"pin"`` mode it takes the choices recorded, and with no mode it
    routes as always."""

    def __init__(self, tfm):
        self.tfm, self.mlp, self.mode, self.choices = tfm, tfm._moe_mlp, \
            None, {}

    def __enter__(self):
        self.tfm._moe_mlp = self
        return self

    def __exit__(self, *exc):
        self.tfm._moe_mlp = self.mlp

    def __call__(self, cfg, x, router, we_in, we_out):
        key, topi = router.storage_offset(), None
        if self.mode == "record":
            gates = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                                  @ router.float(), dim=-1)
            topi = self.choices.setdefault(
                key, self.tfm._top_k(gates, cfg.expert_top_k)[1])
        elif self.mode == "pin":
            topi = self.choices[key]
        return self.mlp(cfg, x, router, we_in, we_out, topi=topi)


def train_path(fa, pa, steps=5, batch=32, profile=False, n_heads=8,
               n_layers=8, tag="train", dtype=torch.bfloat16,
               foreach_adamw=False, d_model=512, n_experts=0,
               capacity_factor=1.25):
    """The LM of ``bench.py``'s transformer row trained at full width (T
    1024, d_model 512; ``n_heads``, ``n_layers``, the compute dtype and
    ``d_model`` as given) from identical params on one batch, three ways:
    the kernel
    path with its step replayed from a CUDA graph (the main path), the
    kernel path eager (``disable_graphs()``), and the plain path (eager),
    each with ``LM_ADAMW``. ``foreach_adamw`` adds a fourth: the kernel
    path replayed with the capturable AdamW of the ``foreach`` form.
    The eager way's losses and params must equal the replayed way's bit
    for bit.

    With ``n_experts`` the blocks are MoE (see ``lm_setup``). Routing is
    discrete: a rounding that flips a near tie moves every later token's
    slot in its expert's buffer and so which ones the capacity drops.
    So the plain path's step 1 takes the kernel path's step-1 choices
    (:class:`PinnedRouting`; the gates, the capacity and the drops
    follow from them on each path), its loss and grads are held, and
    the losses after step 1, routed freely, are printed, not held."""
    from deeplearning4j_tpu_torch import disable_graphs
    from deeplearning4j_tpu_torch.zoo import transformer as tfm

    cfg, init, ids, tgt = lm_setup(tfm, batch, n_heads, n_layers, dtype,
                                   d_model, n_experts, capacity_factor)
    plain_cfg = dataclasses.replace(cfg, use_flash_attention=False,
                                    attn_scores_bf16=False)
    tokens = batch * cfg.max_seq
    ways = [("kernel", cfg, True, LM_ADAMW), ("eager", cfg, False, LM_ADAMW),
            ("plain", plain_cfg, False, LM_ADAMW)]
    if foreach_adamw:
        ways.insert(1, ("kernel_foreach_adamw", cfg, True, {}))
    runs = {}
    pin = PinnedRouting(tfm) if n_experts else contextlib.nullcontext()
    for path, c, graphs, opt_kw in ways:
        params = {k: (v.clone() if torch.is_tensor(v)
                      else {n: w.clone() for n, w in v.items()})
                  for k, v in init.items()}
        opt = torch.optim.AdamW(tfm.param_leaves(params), lr=3e-4,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4, capturable=True, **opt_kw)
        step = tfm.make_train_step(c, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if path == "kernel":           # the main path's own counts
            fa.reset_launches()
            pa.reset_launches()
        losses, secs, per_step, kinds = [], [], [], []
        with contextlib.nullcontext() if graphs else disable_graphs(), \
                pin:
            for i in range(steps):
                before = flash_counts(fa)
                if n_experts:
                    pin.mode = {"kernel": "record", "plain": "pin"}.get(
                        path) if i == 0 else None
                t0 = time.perf_counter()
                loss = step(params, ids, tgt)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                losses.append(loss.item())
                per_step.append({n: c - before[n]
                                 for n, c in flash_counts(fa).items()
                                 if c - before[n]})
                kinds.append(step.compiled.last)
                if i == 0:             # an eager step: p.grad is its own
                    grads = {n: p.grad.detach().clone()
                             for n, p in _named_leaves(params)}
            peak = torch.cuda.max_memory_allocated() / 2**30
            paged = pa.LAUNCHES
            final = [(n, p.detach().clone()) for n, p in
                     _named_leaves(params)] if path != "plain" else None
            launches = replay_counts(per_step, kinds)
            prof = None if path == "plain" else profile_step(
                lambda: step(params, ids, tgt),
                expect=expected_flash(launches[-1]))
        run = {"losses": losses, "step_s": secs,
               "launches_per_step": launches,
               "paged_launches": paged,
               **way_summary(kinds, secs, tokens, "tok", peak)}
        if prof is not None:
            add_profile(run, prof)
        log(f"{tag} {path} path (B{batch} T{cfg.max_seq} D{cfg.head_dim} "
            f"{str(dtype)[6:]}, "
            f"{'flash kernels' if c is cfg else 'plain attention'}, "
            f"{'graph replays' if graphs else 'eager'}"
            f"{', fused AdamW' if opt_kw else ', foreach AdamW'}): "
            f"{json.dumps(run)}")
        if profile and path == "kernel":
            log(f"profile ({tag} step, B{batch} T{cfg.max_seq} "
                f"D{cfg.head_dim}, graph replay): {json.dumps(prof)}")
        runs[path] = (run, grads, final)
        del params, opt, step
        torch.cuda.empty_cache()

    (kr, kg, kf), (pr, pg, _) = runs["kernel"], runs["plain"]
    rels = {n: rel_l2(kg[n], pg[n]) for n in pg}
    finite = all(bool(torch.isfinite(g).all()) for g in kg.values())
    worst = max(rels, key=rels.get)
    # K1 runs twice a layer (forward and the save_attn recompute), dQ and
    # dK/dV once; every launch on the family fa.route names for its kernel
    # (bf16: the tensor cores up to D 256; f32: the CUDA cores up to 128,
    # split TF32 up to 256; the general kernels past them)
    per = {"fwd": 2 * cfg.n_layers, "dq": cfg.n_layers, "dkv": cfg.n_layers}
    want = {}
    for kn, name in FLASH_NAMES.items():
        kind = fa.route(cfg.head_dim, cfg.dtype, kn)
        want[name] = want[f"{name}_{FAMILY_KEYS[kind]}"] = per[kn]
        if kind == "tf32x3" and cfg.head_dim <= 128:
            want[f"{name}_tf32x3_narrow"] = per[kn]
    failed = []
    if not finite or not rels[worst] <= TRAIN_GRAD_REL_L2:
        failed.append("step-1 grads disagree with the plain path")
    for path in runs:
        if path == "plain":
            continue
        r = runs[path][0]
        dloss = [abs(a - b) for a, b in zip(r["losses"], pr["losses"])]
        held = dloss[:1] if n_experts else dloss
        falls = steps == 1 or (r["losses"][-1] < r["losses"][0]
                               and pr["losses"][-1] < pr["losses"][0])
        counts_ok = all(c == want for c in r["launches_per_step"])
        graph_ok = path == "eager" or r["step_kinds"] == [
            "eager", "capture", *["replay"] * (steps - 2)][:steps]
        diff = None if path == "kernel" else first_diff(runs[path][2], kf)
        log(f"{tag} {path} vs plain: |loss delta| per step "
            f"{[f'{x:.2e}' for x in dloss]} (limit {TRAIN_LOSS_ATOL}); loss "
            f"falls {falls}; launches per step (a replay at its capture's) "
            f"{r['launches_per_step']} (want {want}); steps "
            f"{r['step_kinds']}"
            + ("" if path == "kernel" else
               f"; vs the replayed kernel path: losses equal "
               f"{r['losses'] == kr['losses']}, params bit-identical "
               f"{diff is None}"
               + ("" if diff is None else f" (first differing leaf {diff})")))
        if not max(held) <= TRAIN_LOSS_ATOL or not falls:
            failed.append(f"{path}: losses disagree with the plain path or "
                          "do not fall")
        if not counts_ok:
            failed.append(f"{path}: a flash kernel was not launched as "
                          "often as wanted in every step")
        if not graph_ok:
            failed.append(f"{path}: the steps did not replay a graph")
        if path == "eager" and (
                diff is not None or r["losses"] != kr["losses"]):
            failed.append("eager: losses or params differ from the replayed "
                          "kernel path's")
    log(f"{tag} kernel vs plain: step-1 grad rel L2 max {rels[worst]:.3e} "
        f"({worst}; limit {TRAIN_GRAD_REL_L2}), all finite {finite}"
        + (f"; step 1 on the kernel path's routing ({len(pin.choices)} "
           "blocks pinned), losses held at step 1 only" if n_experts
           else ""))
    if n_experts and len(pin.choices) != cfg.n_layers:
        failed.append("the plain path's step 1 was not pinned to every "
                      "block's routing")
    if failed:
        raise SystemExit(f"{tag} path: {failed}")
    TRAIN_RECORDS[tag] = kr
    total = {n: sum(c.get(n, 0) for c in kr["launches_per_step"])
             for n in flash_counts(fa)}
    return {**total, "paged_attention": kr["paged_launches"]}


def device_rows(prof, wall, steps):
    """Wall and device time per step, the device-busy share and the top
    CUDA kernels by device time, from a ``torch.profiler`` run."""
    rows = []
    for ev in prof.key_averages():
        # device rows only (kernels, copies): an operator's row carries
        # its kernels' time again as its own "self device time"
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = _self_device_us(ev)
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    return {"steps": steps, "wall_ms_per_step": wall * 1e3 / steps,
            "device_ms_per_step": busy_us / 1e3 / steps,
            "device_busy_share": busy_us / (wall * 1e6),
            "top_kernels": [{"name": k[:80], "ms_per_step": us / 1e3 / steps,
                             "calls_per_step": n / steps}
                            for us, k, n in rows[:12]]}


# ------------------------------------------ eager and replayed steps

def replay_counts(per_step, kinds):
    """Launches a step of a compiled run made: an eager step and a
    capture count what their wrappers launched (a capture replays once);
    a replay runs what its capture recorded and its wrappers do not run,
    so it counts its capture's launches."""
    out, captured = [], {}
    for counts, kind in zip(per_step, kinds):
        if kind == "capture":
            captured = counts
        out.append(captured if kind == "replay" else counts)
    return out


def first_diff(a, b):
    """The name of the first leaf of two (name, tensor) lists that is not
    bit for bit equal, or None."""
    for (n, x), (_, y) in zip(a, b):
        if not torch.equal(x, y):
            return n
    return None


def timed_steps(kinds):
    """The steps a run's wall time and throughput are taken over: a
    graph run's replays (its eager first step and its capture are left
    out), an eager run's steps after the first."""
    if "replay" in kinds:
        return [i for i, k in enumerate(kinds) if k == "replay"]
    return list(range(1, len(kinds))) or [0]


def way_summary(kinds, step_s, items, unit, peak_gib):
    """How each step ran, wall ms a step (the median over
    :func:`timed_steps`: one step in a few now and then takes twice its
    time on the card's shared host) and ``unit``s/s at it, and peak device
    memory."""
    idx = timed_steps(kinds)
    wall = float(np.median([step_s[i] for i in idx]))
    return {"step_kinds": kinds, "timed_steps": [i + 1 for i in idx],
            "wall_ms_per_step": wall * 1e3, f"{unit}_per_s": items / wall,
            "peak_alloc_gib": peak_gib}


def add_profile(rec, prof):
    """Put a profiled step's device ms (and K4's, where counted; and the
    flash kernels', where they ran) beside a run's wall ms a step (busy
    share = device ms / wall ms)."""
    rec["device_ms_per_step"] = prof["device_ms_per_step"]
    rec["busy_share"] = prof["device_ms_per_step"] / rec["wall_ms_per_step"]
    for key in ("k4_device_ms", "k4_share_of_device", "flash_device_ms",
                "flash_share_of_device", "flash_kernels_ms",
                "profile_tries", "device_ms_from"):
        if key in prof:
            rec[key] = prof[key]


def k4_device_ms(prof):
    """K4's device ms in a ``torch.profiler`` run, both routes' kernels."""
    return sum(_self_device_us(ev) for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and any(n in ev.key for n in K4_KERNEL_NAMES)) / 1e3


def flash_kernel_ms(prof, steps=1):
    """Device ms a step of each flash kernel (every kernel named
    ``flash_*_kernel``, by name and template arguments) and their
    launches a step, in a ``torch.profiler`` run of ``steps`` steps."""
    flash = {}
    for ev in prof.key_averages():
        name = re.search(r"flash_\w+_kernel(<[^>]*>)?", ev.key)
        if ev.device_type == torch.autograd.DeviceType.CUDA and name:
            us, n = flash.get(name[0], (0.0, 0))
            flash[name[0]] = (us + _self_device_us(ev), n + ev.count)
    return {k: {"ms_per_step": us / 1e3 / steps, "calls_per_step": n / steps}
            for k, (us, n) in flash.items()}


# each flash kernel's name in a trace starts with its kind's prefix
FLASH_TRACE_PREFIX = {"fwd": "flash_fwd_", "dq": "flash_bwd_dq_",
                      "dkv": "flash_bwd_dkv_"}
# traces profile_step takes before it falls back to CUDA events: the
# first trace of a replayed step has lacked its first kernels (K1 among
# them) in some processes, and a second trace held them all
PROFILE_TRIES = 3


def _flash_launches():
    """The flash launch counters of the port on ``sys.path``, by kind."""
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    return {k: getattr(fa, c) for k, c in (
        ("fwd", "LAUNCHES"), ("dq", "LAUNCHES_BWD_DQ"),
        ("dkv", "LAUNCHES_BWD_DKV"))}


def expected_flash(counts):
    """The flash launches by kind in a path's counts (``FLASH_NAMES``
    keys), as :func:`profile_step` takes them."""
    return {k: counts.get(name, 0) for k, name in FLASH_NAMES.items()}


def profile_step(fn, k4=False, expect=None):
    """One call of ``fn`` under ``torch.profiler``: wall and device ms
    (kernels and copies, graph replays' included), busy share, top
    kernels, the flash kernels' device ms by kernel and their share of
    the device time where any ran; with ``k4`` also K4's device ms and
    share of the device time. The trace is held against the launch
    counters: it must hold each flash kind (K1, dQ, dK/dV) as many times
    as the wrappers launched it during the call or, for a replay (which
    moves no counter), as ``expect`` says (launches by kind, its
    capture's); it must hold some device time, and with ``k4`` some of
    K4's (every call profiled with ``k4`` launches it; late in a long run
    the profiler has recorded a trace with no device event at all). A
    trace that holds less is taken again (the call runs again),
    ``PROFILE_TRIES`` times in all; ``profile_tries`` says how many it
    took. After that many short traces no trace is reported: the call is
    timed once more by CUDA events (its span on the device, idle gaps
    included; K4's own ms and share are then None), ``device_ms_from``
    says so, and the log too."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, PROFILE_TRIES + 1):
        before = _flash_launches()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        flash = flash_kernel_ms(prof)
        want = expect or {k: n - before[k]
                          for k, n in _flash_launches().items()}
        traced = {k: sum(v["calls_per_step"] for name, v in flash.items()
                         if name.startswith(pre))
                  for k, pre in FLASH_TRACE_PREFIX.items()}
        short = {k: (traced[k], n) for k, n in want.items() if traced[k] < n}
        out = device_rows(prof, wall, 1)
        if not out["device_ms_per_step"]:
            short["device time"] = 0
        if k4:
            out["k4_device_ms"] = k4_device_ms(prof)
            if not out["k4_device_ms"]:
                short["k4 device time"] = 0
        if not short:
            break
        log(f"profile_step: trace {attempt} of {PROFILE_TRIES} is short "
            f"(flash kinds as (traced, launched)): {short}")
    else:
        log(f"profile_step: {PROFILE_TRIES} traces were short: this call "
            "is timed by CUDA events")
        t0 = time.perf_counter()
        span = cuda_ms(fn, iters=1, warmup=0)
        wall = time.perf_counter() - t0
        return {"steps": 1, "wall_ms_per_step": wall * 1e3,
                "device_ms_per_step": span,
                "device_busy_share": span / (wall * 1e3),
                "top_kernels": [], "profile_tries": PROFILE_TRIES,
                **({"k4_device_ms": None, "k4_share_of_device": None}
                   if k4 else {}),
                "device_ms_from": "CUDA events: the call's span on the "
                                  "device, the traces having lost kernels"}
    out["profile_tries"] = attempt
    if flash:
        out["flash_kernels_ms"] = {k: v["ms_per_step"]
                                   for k, v in flash.items()}
        out["flash_device_ms"] = sum(out["flash_kernels_ms"].values())
        out["flash_share_of_device"] = (out["flash_device_ms"]
                                        / out["device_ms_per_step"])
    if k4:
        out["k4_share_of_device"] = (out["k4_device_ms"]
                                     / out["device_ms_per_step"])
    return out


# ---------------------------------------------------------------- phase 7

def k3_bound(kernel, n, c, dtype):
    item = torch.finfo(dtype).bits // 8
    nbytes = K3_ROWS[kernel] * n * c * item + K3_VECS[kernel] * c * 4
    return bound_ms(nbytes, K3_OPS[kernel] * n * c, torch.float32)


def _k3_inputs(gen, n, c, dtype, copies=1):
    """``copies`` sets of (x, g) — enough that the timed launches cycle
    through more than the 50 MB L2 — and per-channel vectors."""
    def rows(scale, offset):
        return [(torch.randn((n, c), generator=gen, device="cuda") * scale
                 + offset).to(dtype) for _ in range(copies)]
    xs, gs = rows(2.0, 1.5), rows(1.0, 0.0)
    gamma = torch.rand((c,), generator=gen, device="cuda") * 1.5 + 0.5
    beta = torch.randn((c,), generator=gen, device="cuda")
    center = torch.randn((c,), generator=gen, device="cuda") * 0.1
    return xs, gs, gamma, beta, center


def _k3_args(fo, x, gamma, beta, center):
    """mean, inv, scale, shift as the training Function derives them."""
    mean, var = fo.train_stats_reference(x, center)
    inv = torch.rsqrt(var + 1e-5)
    return (mean, inv, *fo._scale_shift(gamma, beta, mean, inv))


def _epilogue_rel(fo, s, gamma, beta, center, n):
    """The stats kernel's fused epilogue against the plain versions on
    the kernel's own sums: max relative error of mean, var and inv
    (elementwise), and of scale and shift (over their largest entry)."""
    mean, var = fo._finish_moments(s[0], s[1], center, n)
    inv = torch.rsqrt(var + 1e-5)
    scale, shift = fo._scale_shift(gamma, beta, mean, inv)
    rel = [((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
           for got, want in zip(s[2:5], (mean, var, inv))]
    rel += [(got - want).abs().max().item() / want.abs().max().item()
            for got, want in zip(s[5:], (scale, shift))]
    return max(rel)


def check_k3(fo, dtype, n, c, gen, acts=("relu",), hw=None, time_it=True):
    """The four K3 kernels against their plain versions on one (N, C):
    outputs within tolerance (the reductions' sums, the stats kernel's
    fused mean/var/inv/scale/shift, the backward reduce's sums over N), a
    second launch bitwise equal; kernel device time (``torch.profiler``),
    plain and library (``F.batch_norm`` on the channels_last NCHW view,
    identity activation) times at ``hw`` (None: no 4-D view, no library
    time)."""
    F = torch.nn.functional
    item = torch.finfo(dtype).bits // 8
    copies = max(1, -(-200 * 2**20 // (n * c * item))) if time_it else 1
    xs, gs, gamma, beta, center = _k3_inputs(gen, n, c, dtype, copies)
    x, g = xs[0], gs[0]
    mean, inv, scale, shift = _k3_args(fo, x, gamma, beta, center)
    errs, rel, ok = {}, {}, True
    for act in acts:
        y = fo.bn_act(x, scale, shift, act)
        ref = fo.bn_act_reference(x, scale, shift, act).to(dtype)
        errs[f"bn_act/{act}"] = (y.float() - ref.float()).abs().max().item()
        ok &= errs[f"bn_act/{act}"] <= ATOL[dtype]
        ok &= torch.equal(y, fo.bn_act(x, scale, shift, act))
    s = fo.bn_stats(x, center, gamma, beta, 1e-5)
    d = x.float() - center
    ref = torch.stack([d.sum(0), (d * d).sum(0)])
    del d
    # the per-channel sums are held relative to their largest entry
    errs["bn_stats"] = (s[:2] - ref).abs().max().item()
    rel["bn_stats"] = errs["bn_stats"] / ref.abs().max().item()
    rel["bn_stats/epilogue"] = _epilogue_rel(fo, s, gamma, beta, center, n)
    ok &= rel["bn_stats"] <= K3_SUM_RTOL
    ok &= rel["bn_stats/epilogue"] <= K3_EPILOGUE_RTOL
    ok &= torch.equal(s, fo.bn_stats(x, center, gamma, beta, 1e-5))
    for act in acts:
        if not fo.supported_train_activation(act):
            continue
        r = fo.bn_bwd_reduce(x, g, scale, shift, mean, inv, act)
        dx = fo.bn_bwd_dx(x, g, scale, shift, mean, inv, r[2:], act)
        dx_ref, dgamma, dbeta = fo.bn_bwd_reference(x, g, gamma, beta, mean,
                                                    inv, act)
        ref = torch.stack([dbeta, dgamma])
        errs[f"bn_bwd_reduce/{act}"] = (r[:2] - ref).abs().max().item()
        rel[f"bn_bwd_reduce/{act}"] = \
            errs[f"bn_bwd_reduce/{act}"] / ref.abs().max().item()
        errs[f"bn_bwd_dx/{act}"] = (dx.float() - dx_ref.float()).abs() \
            .max().item()
        ok &= rel[f"bn_bwd_reduce/{act}"] <= K3_SUM_RTOL
        # torch divides by a scalar as a product with its f32 reciprocal;
        # the kernel divides exactly: an ulp apart at most
        rel[f"bn_bwd_reduce/{act}/over_n"] = \
            (r[2:] - r[:2] / n).abs().max().item() \
            / (r[:2] / n).abs().max().item()
        ok &= rel[f"bn_bwd_reduce/{act}/over_n"] <= K3_EPILOGUE_RTOL
        ok &= grad_ok(dx, dx_ref, dtype)
        ok &= torch.equal(r, fo.bn_bwd_reduce(x, g, scale, shift, mean, inv,
                                              act))
        del dx, dx_ref
    torch.cuda.synchronize()
    name = f"K3 {str(dtype)[6:]} N{n} C{c}"
    errors = (f"max abs errors {json.dumps(errs)}, sums relative "
              f"{json.dumps(rel)}")
    if not ok:
        log(f"{name}: {errors} -> FAIL")
        raise SystemExit(f"K3 {dtype} ({n}, {c}) disagrees with its plain "
                         "version or does not repeat")
    out = {"max_abs_err": errs}
    if not time_it:
        log(f"{name}: {errors} -> ok")
        return out
    corr = fo.bn_bwd_reduce(x, g, scale, shift, mean, inv, "relu")[2:]
    turn = [0]

    def nxt():
        turn[0] = (turn[0] + 1) % copies
        return xs[turn[0]], gs[turn[0]]

    kernels = {
        "bn_act": lambda: fo.bn_act(nxt()[0], scale, shift, "relu"),
        "bn_stats": lambda: fo.bn_stats(nxt()[0], center, gamma, beta,
                                        1e-5),
        "bn_bwd_reduce": lambda: fo.bn_bwd_reduce(*nxt(), scale, shift, mean,
                                                  inv, "relu"),
        "bn_bwd_dx": lambda: fo.bn_bwd_dx(*nxt(), scale, shift, mean, inv,
                                          corr, "relu")}
    plain = {
        "bn_act": lambda: fo.bn_act_reference(nxt()[0], scale, shift,
                                              "relu").to(dtype),
        # the stats kernel's whole output: moments, inv, scale and shift
        "bn_stats": lambda: _k3_args(fo, nxt()[0], gamma, beta, center),
        "bn_bwd_reduce": lambda: _plain_reduce(fo, *nxt(), scale, shift,
                                               mean, inv),
        "bn_bwd_dx": lambda: fo.bn_bwd_reference(*nxt(), gamma, beta, mean,
                                                 inv, "relu")}
    lib = {}
    if hw is not None:
        b = n // (hw * hw)
        x4 = [t.view(b, hw, hw, c).permute(0, 3, 1, 2) for t in xs]

        def nxt4():
            turn[0] = (turn[0] + 1) % copies
            return x4[turn[0]]

        rm, rv = mean.clone(), 1.0 / inv.square() - 1e-5
        lib["bn_act"] = cuda_ms(lambda: F.batch_norm(
            nxt4(), rm, rv, gamma, beta, False, 0.1, 1e-5))
        lib["bn_stats"] = cuda_ms(lambda: F.batch_norm(
            nxt4(), None, None, gamma, beta, True, 0.1, 1e-5))
        xr = x4[0].detach().requires_grad_(True)
        gr, br = (t.detach().requires_grad_(True) for t in (gamma, beta))
        yb = F.batch_norm(xr, None, None, gr, br, True, 0.1, 1e-5)
        g4 = gs[0].view(b, hw, hw, c).permute(0, 3, 1, 2)
        lib["bn_bwd_reduce"] = lib["bn_bwd_dx"] = cuda_ms(
            lambda: torch.autograd.grad(yb, (xr, gr, br), g4,
                                        retain_graph=True), iters=10)
        del yb, xr
    res = {}
    for k in kernels:
        bms, by = k3_bound(k, n, c, dtype)
        # device time (the profiler's); call_ms by events counts the
        # host's path too, which outlasts a kernel of a few microseconds
        res[k] = {"ms": device_ms(kernels[k]), "call_ms": cuda_ms(kernels[k]),
                  "plain_ms": cuda_ms(plain[k], iters=5),
                  "library_ms": lib.get(k), "bound_ms": bms, "bound_by": by,
                  "max_abs_err": max(v for e, v in errs.items()
                                     if e.startswith(k))}

    def fmt(v, digits):
        return "-" if v is None else f"{v:.{digits}f}"

    log(f"{name}: {errors}; ms (kernel device / a call by events / plain "
        f"/ library / bound) "
        + ", ".join(
            f"{k} {fmt(r['ms'], 4)} / {fmt(r['call_ms'], 4)} / "
            f"{fmt(r['plain_ms'], 4)} / {fmt(r['library_ms'], 4)} / "
            f"{fmt(r['bound_ms'], 5)}"
            for k, r in res.items()) + " -> ok")
    out.update(res)
    return out


def _plain_reduce(fo, x, g, scale, shift, mean, inv):
    """The plain version of the backward reduce alone: Σdz, Σdz·x̂."""
    xf = x.float()
    dz = g.float() * fo._ACT_GRADS["relu"](xf * scale + shift)
    xhat = (xf - mean) * inv
    return torch.stack([dz.sum(0), (dz * xhat).sum(0)])


def k3_times(root):
    """``--k3-times ROOT``: the device time (``torch.profiler``) and a
    call's time by events of the two K3 reductions, stats and backward
    reduce (relu), at the nine ResNet-50 path shapes in bf16 and f32, for
    the port checked out at ROOT; its kernels build under ROOT. Takes the
    stats wrapper of either API, ``bn_stats(x, center)`` (before the
    one-launch redesign) or ``bn_stats(x, center, gamma, beta, eps)``, so
    that two versions are timed in one run. Prints one JSON line."""
    import importlib
    import inspect
    sys.path.insert(0, str(root))
    fo = importlib.import_module("deeplearning4j_tpu_torch.kernels.fused_ops")
    log(f"k3-times: fused_ops from {fo.__file__}")
    fused_stats = "gamma" in inspect.signature(fo.bn_stats).parameters
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for hw, c in K3_PATH_SHAPES:
            n = RESNET_BATCH * hw * hw
            item = torch.finfo(dtype).bits // 8
            copies = max(1, -(-200 * 2**20 // (n * c * item)))
            xs, gs, gamma, beta, center = _k3_inputs(gen, n, c, dtype,
                                                     copies)
            mean, inv, scale, shift = _k3_args(fo, xs[0], gamma, beta,
                                               center)
            turn = [0]

            def nxt():
                turn[0] = (turn[0] + 1) % copies
                return xs[turn[0]], gs[turn[0]]

            stats_args = (center, gamma, beta) if fused_stats else (center,)
            fns = {"bn_stats": lambda: fo.bn_stats(nxt()[0], *stats_args),
                   "bn_bwd_reduce": lambda: fo.bn_bwd_reduce(
                       *nxt(), scale, shift, mean, inv, "relu")}
            row = {"dtype": str(dtype)[6:], "n": n, "c": c}
            for k, fn in fns.items():
                row[k] = {"ms": device_ms(fn), "call_ms": cuda_ms(fn),
                          "bound_ms": k3_bound(k, n, c, dtype)[0]}
            log(f"k3-times {json.dumps(row)}")
            rows.append(row)
            del xs, gs
            torch.cuda.empty_cache()
    # per ResNet-50 train step: each shape's time times its BN layers
    step = {}
    for dt in ("bfloat16", "float32"):
        mine = [r for r in rows if r["dtype"] == dt]
        step[dt] = {k: {m: sum(r[k][m] * w
                               for r, w in zip(mine, K3_PATH_LAYERS))
                        for m in ("ms", "call_ms", "bound_ms")}
                    for k in ("bn_stats", "bn_bwd_reduce")}
    log(json.dumps({"k3_times": rows, "per_resnet_step": step,
                    "root": str(root)}))
    return 0


def sweep_times(root, repeats=3):
    """``--sweep-times ROOT``: phase 4's steady decode sweeps
    (:func:`steady_sweeps`: every slot decoding at ctx 600, 20 timed
    sweeps with their host split, 20 profiled) on the dense and the paged
    scheduler, replayed, of the port checked out at ROOT (its kernels
    build under ROOT), ``repeats`` times each after one warm round; a
    tree with the observability plane serves with it full. Two versions
    are compared in one run: parent, change, change, parent. Prints one
    JSON line."""
    import importlib
    sys.path.insert(0, str(root))
    serving = importlib.import_module("deeplearning4j_tpu_torch.serving")
    tfm = importlib.import_module("deeplearning4j_tpu_torch.zoo.transformer")
    log(f"sweep-times: serving from {serving.__file__}")
    cfg, params = main_config(tfm)
    engine = serving.GenerationEngine(cfg, params)
    rows = {}
    for path, kw in MAIN_PATHS.items():
        try:
            # a tree with the observability plane runs it full: SLO
            # tracking beside its defaults (span trees, a sampler
            # observation every 32 events)
            sched = serving.ContinuousBatchingScheduler(
                engine, slo=serving.SLOConfig(**OBS_SLO), **kw)
            plane = True
        except (AttributeError, NotImplementedError):
            sched = serving.ContinuousBatchingScheduler(engine, **kw)
            plane = False
        log(f"sweep-times {path}: observability plane {plane}")
        steady_sweeps(sched, 600)
        rows[path] = [steady_sweeps(sched, 600) for _ in range(repeats)]
        for r in rows[path]:
            log(f"sweep-times {path} {json.dumps(r)}")
    log(json.dumps({"sweep_times": rows, "root": str(root)}))
    return 0


def flash_times(root):
    """``--flash-times ROOT``: the device time (``torch.profiler``) and a
    call's time by events of K1, dQ and dK/dV, causal at B1 H8 T1024 D256
    and the D 256 LM's B8 H2 T1024 D256, at B1 H8 T1024 D320 and D512 and
    the D 320 LM's B8 H2 T1024 D320, in bf16 and in f32, for the port
    checked out at ROOT (its kernels build under ROOT), on the kernel
    family its route picks there (a tree before the wide backward runs
    the general dQ and dK/dV past 256); f32 causal at head dim <= 128, at
    B1 H8 T2048 D64, B8 H8 T2048 D64 (the attention layer's path), B1
    H8 T1024 D128 and B1 H8 T2048 D16 and D32 (the narrowest, padded to
    64), with SDPA's forward and whole backward beside them;
    the D 256 and D 320 LMs' train steps (phase 6's ``train_d256``,
    ``train_d320`` and their f32 twins) profiled on ROOT's port in each
    dtype: device time a step and its flash kernels' share; phase 19's
    attention net in f32 (B8 T2048 C512 H8, D 64), three replayed steps
    each profiled (each trace held against the capture's launches):
    device ms a step and its flash kernels'; then digests
    of K1's outputs (O, lse) on every route and of the backward's (dQ,
    dK, dV) from K1's and from the plain forward's O and lse, keyed by
    the route each ran, at B1 H2 T256 on seeded inputs, and of K2's
    outputs at Dh 64, 128 and 256 in bf16 and f32, so that two trees'
    kernels are held bit for bit where their routes agree.
    Two versions are compared in one run: parent, change, change, parent.
    Prints one JSON line."""
    import hashlib
    import importlib
    sys.path.insert(0, str(root))
    fa = importlib.import_module(
        "deeplearning4j_tpu_torch.kernels.flash_attention")
    pa = importlib.import_module(
        "deeplearning4j_tpu_torch.kernels.paged_attention")
    tfm = importlib.import_module("deeplearning4j_tpu_torch.zoo.transformer")
    log(f"flash-times: kernels from {fa.__file__}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for b, h, d in ((1, 8, 256), (D256_LM[1], D256_LM_HEADS, 256),
                        (1, 8, 320), (1, 8, 512), (D320_LM[1], 2, 320)):
            t = 1024
            q, k, v, do = (torch.randn((b, h, t, d), generator=gen,
                                       device="cuda").to(dtype)
                           for _ in range(4))
            scale = d ** -0.5
            o, lse = fa.flash_attention_lse(q, k, v, causal=True)
            delta = (do.float() * o.float()).sum(-1).contiguous()
            fns = {"fwd": lambda: fa.flash_attention_lse(q, k, v,
                                                         causal=True),
                   "dq": lambda: fa.flash_attention_bwd_dq(
                       q, k, v, do, lse, delta, scale, True),
                   "dkv": lambda: fa.flash_attention_bwd_dkv(
                       q, k, v, do, lse, delta, scale, True)}
            row = {"shape": f"B{b} H{h} T{t} D{d} {str(dtype)[6:]} causal"}
            for name, fn in fns.items():
                row[name] = {"route": fa.route(d, dtype, name),
                             "ms": device_ms(fn), "call_ms": cuda_ms(fn)}
            log(f"flash-times {json.dumps(row)}")
            rows.append(row)
            del q, k, v, do, o, lse, delta
            torch.cuda.empty_cache()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for b, h, t, d in ((1, 8, 2048, 64), (ATTN_B, ATTN_H, ATTN_T, 64),
                       (1, 8, 1024, 128), (1, 8, 2048, 16),
                       (1, 8, 2048, 32)):
        q, k, v, do = (torch.randn((b, h, t, d), generator=gen,
                                   device="cuda") for _ in range(4))
        scale = d ** -0.5
        o, lse = fa.flash_attention_lse(q, k, v, causal=True)
        delta = (do * o).sum(-1).contiguous()
        fns = {"fwd": lambda: fa.flash_attention_lse(q, k, v, causal=True),
               "dq": lambda: fa.flash_attention_bwd_dq(
                   q, k, v, do, lse, delta, scale, True),
               "dkv": lambda: fa.flash_attention_bwd_dkv(
                   q, k, v, do, lse, delta, scale, True)}
        row = {"shape": f"B{b} H{h} T{t} D{d} float32 causal"}
        for name, fn in fns.items():
            row[name] = {"route": fa.route(d, torch.float32, name),
                         "ms": device_ms(fn), "call_ms": cuda_ms(fn)}
        row["sdpa_fwd_ms"] = device_ms(lambda: sdpa(q, k, v,
                                                    is_causal=True))
        qs, ks, vs = (x.clone().requires_grad_(True) for x in (q, k, v))
        out = sdpa(qs, ks, vs, is_causal=True)
        row["sdpa_bwd_ms"] = device_ms(lambda: torch.autograd.grad(
            out, (qs, ks, vs), do, retain_graph=True), iters=10)
        log(f"flash-times {json.dumps(row)}")
        rows.append(row)
        del q, k, v, do, o, lse, delta, qs, ks, vs, out
        torch.cuda.empty_cache()
    steps = {}
    for dtype in (torch.bfloat16, torch.float32):
        for d_model, heads, lm in ((512, D256_LM_HEADS, "d256"),
                                   (D320_D_MODEL, 2, "d320")):
            key = f"{lm} {str(dtype)[6:]}"
            steps[key] = lm_step_times(tfm, D256_LM[1], heads, 2, dtype,
                                       d_model=d_model)
            log(f"flash-times {lm} LM step {json.dumps(steps[key])}")
            torch.cuda.empty_cache()
    steps["attention f32"] = attention_step_times(torch.float32)
    log(f"flash-times attention net step "
        f"{json.dumps(steps['attention f32'])}")
    torch.cuda.empty_cache()

    def digest(*ts):
        h = hashlib.sha256()
        for x in ts:
            h.update(x.float().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    digests = {}
    for dtype, d in ((torch.bfloat16, 64), (torch.bfloat16, 256),
                     (torch.bfloat16, 12), (torch.bfloat16, 320),
                     (torch.float32, 64), (torch.float32, 128),
                     (torch.float32, 130),
                     (torch.float32, 256), (torch.float32, 320)):
        g2 = torch.Generator(device="cuda").manual_seed(d)
        q, k, v, do = (torch.randn((1, 2, 256, d), generator=g2,
                                   device="cuda").to(dtype)
                       for _ in range(4))
        o, lse = fa.flash_attention_lse(q, k, v, causal=True)
        delta = (do.float() * o.float()).sum(-1).contiguous()
        tag = f"{str(dtype)[6:]} D{d}"
        digests[f"k1 {tag} {fa.route(d, dtype, 'fwd')}"] = digest(o, lse)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, d ** -0.5,
                                       True)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                            d ** -0.5, True)
        # the backward reads K1's O (through delta) and lse: keyed by the
        # forward's route too
        digests[f"bwd {tag} {fa.route(d, dtype, 'dq')} (k1 "
                f"{fa.route(d, dtype, 'fwd')})"] = digest(dq, dk, dv)
        # and from the plain forward's O and lse: the backward alone, held
        # whatever K1's route
        o, lse = fa.mha_reference_lse(q, k, v, causal=True)
        delta = (do.float() * o.float()).sum(-1).contiguous()
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, d ** -0.5,
                                       True)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                            d ** -0.5, True)
        digests[f"bwd {tag} {fa.route(d, dtype, 'dq')} (plain forward)"] = \
            digest(dq, dk, dv)
    for dtype in (torch.bfloat16, torch.float32):
        for dh in (64, 128, 256):
            g2 = torch.Generator(device="cuda").manual_seed(dh)
            q, k, v, table, pos = paged_inputs(g2, dtype, 4, dh, n_layers=1)
            out = pa.paged_attention(q, k[0], v[0], table.cuda(), pos.cuda())
            digests[f"k2 {str(dtype)[6:]} Dh{dh}"] = digest(out)
    log(json.dumps({"flash_times": rows, "lm_steps": steps,
                    "digests": digests, "root": str(root)}))
    return 0


def attention_step_times(dtype, replays=3):
    """Phase 19's attention net (``SelfAttentionLayer(impl="pallas")``,
    B8 T2048 C512 H8, causal) in ``dtype``, on the port on ``sys.path``:
    three fit steps (eager, capture, replay), then ``replays`` replayed
    steps, each profiled alone and its trace held against the capture's
    launches: device ms a step and its flash kernels' device ms, by
    kernel."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    rng = np.random.default_rng(19)
    x = torch.as_tensor(rng.standard_normal((ATTN_B, ATTN_T, ATTN_C))
                        .astype(np.float32), device="cuda")
    y = torch.nn.functional.one_hot(torch.as_tensor(rng.integers(
        0, ATTN_CLASSES, (ATTN_B, ATTN_T)), device="cuda"),
        ATTN_CLASSES).float()
    ds = DataSet(x, y)
    net = MultiLayerNetwork(_attn_conf(dtype)).init((ATTN_T, ATTN_C))
    net.fit([ds])
    # a replay launches what its capture launched
    before = _flash_launches()
    net.fit([ds])
    captured = {k: n - before[k] for k, n in _flash_launches().items()}
    net.fit([ds])
    profs = [profile_step(lambda: net.fit([ds]), expect=captured)
             for _ in range(replays)]
    out = {"shape": f"B{ATTN_B} T{ATTN_T} C{ATTN_C} H{ATTN_H} causal "
                    f"{str(dtype)[6:]}", "way": net._step_fn.last,
           "device_ms_per_step": [p["device_ms_per_step"] for p in profs],
           "flash_device_ms": [p.get("flash_device_ms") for p in profs],
           "profile_tries": [p["profile_tries"] for p in profs],
           "device_ms_from": [p.get("device_ms_from", "trace")
                              for p in profs],
           "flash_kernels_ms": profs[-1].get("flash_kernels_ms")}
    del net, ds, x, y
    gc.collect()
    return out


def lm_step_times(tfm, batch, n_heads, n_layers, dtype, steps=5,
                  d_model=512):
    """Device time a step of the LM's kernel-path train step in ``dtype``
    (AdamW as phase 6 builds it) under ``torch.profiler`` over ``steps``
    steps after two warm-up steps: all kernels and copies, and the flash
    kernels (every kernel named ``flash_*_kernel``) with their launches;
    the host's wall time a step beside them. The step runs eagerly (under
    the port's ``disable_graphs()`` where it has one), so that a tree
    before the compiled step and one after it are timed alike."""
    import importlib
    from torch.profiler import ProfilerActivity, profile
    pkg = importlib.import_module("deeplearning4j_tpu_torch")
    eager = getattr(pkg, "disable_graphs", contextlib.nullcontext)
    cfg, params, ids, tgt = lm_setup(tfm, batch, n_heads, n_layers, dtype,
                                     d_model)
    opt = torch.optim.AdamW(tfm.param_leaves(params), lr=3e-4,
                            weight_decay=1e-4, capturable=True, **LM_ADAMW)
    step = tfm.make_train_step(cfg, opt)
    with eager():
        for _ in range(2):
            step(params, ids, tgt)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step(params, ids, tgt)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    rows = device_rows(prof, wall, steps)
    flash = flash_kernel_ms(prof, steps)
    return {"shape": f"B{batch} T{cfg.max_seq} H{n_heads} D{cfg.head_dim} "
                     f"{n_layers} layers {str(dtype)[6:]}",
            "steps": steps,
            "wall_ms_per_step": rows["wall_ms_per_step"],
            "device_ms_per_step": rows["device_ms_per_step"],
            "flash_ms_per_step": sum(v["ms_per_step"]
                                     for v in flash.values()),
            "flash_kernels": flash}


def k3_phase(fo, gen):
    """Phase 7: the path's shapes in bf16 and f32, every activation at one
    shape, odd shapes. Returns the results at each path shape and the
    (dtype, N, C, activation) cases checked."""
    out, checked = {}, set()
    for dtype in (torch.bfloat16, torch.float32):
        for hw, c in K3_PATH_SHAPES:
            n = RESNET_BATCH * hw * hw
            out[(dtype, n, c)] = check_k3(fo, dtype, n, c, gen,
                                          acts=("relu", "identity"), hw=hw)
            checked |= {(dtype, n, c, a) for a in ("relu", "identity")}
            torch.cuda.empty_cache()
        check_k3(fo, dtype, RESNET_BATCH * 14 * 14, 1024, gen,
                 acts=tuple(fo._ACTS), time_it=False)
        for c in (3, 5, 24):
            check_k3(fo, dtype, 1000, c, gen, acts=("relu", "tanh"),
                     time_it=False)
    return out, checked


# ---------------------------------------------------------------- phase 8

def k3_counts(fo):
    return {"bn_act": fo.LAUNCHES, "bn_stats": fo.LAUNCHES_STATS,
            "bn_bwd_reduce": fo.LAUNCHES_BWD_REDUCE,
            "bn_bwd_dx": fo.LAUNCHES_BWD_DX}


class _StepLog:
    """A fit listener: loss, host time, K3 launch counts and how the
    compiled step ran ("eager", "capture", "replay"; "direct" under
    ``disable_graphs()``) at the end of each step (``fit`` reads the loss
    to the host first, which waits for the step's kernels). It reads the
    net at the reported step, so it takes no deferred scores."""
    deferred_score_ok = False

    def __init__(self, fo, step_of=lambda net: net._step_fn):
        self.fo, self.rows, self.step_of = fo, [], step_of
        self.base = k3_counts(fo)

    def iteration_done(self, net, it, epoch, loss):
        self.rows.append((loss, time.perf_counter(), k3_counts(self.fo),
                          self.step_of(net).last))

    def kinds(self):
        return [r[3] for r in self.rows]

    def step_s(self, t0, t1=None):
        """Host seconds of each step: from ``t0`` to the first step's end,
        from ``t1`` (default: that end) to the second's, then end to
        end."""
        ends = [r[1] for r in self.rows]
        starts = [t0, ends[0] if t1 is None else t1, *ends[1:-1]]
        return [b - a for a, b in zip(starts, ends)]

    def launches_per_step(self):
        """K3 launches a step, a replay at its capture's."""
        before = [self.base] + [r[2] for r in self.rows[:-1]]
        return replay_counts([{k: r[2][k] - b[k] for k in r[2]}
                              for r, b in zip(self.rows, before)],
                             self.kinds())


def _set_fused(net, fused):
    from deeplearning4j_tpu_torch.nn.layers.norm import BatchNormalization
    for node in net.conf.nodes.values():
        if isinstance(node.op, BatchNormalization):
            node.op.fused = fused


@contextlib.contextmanager
def _k3_cases(fo):
    """Record the (dtype, N, C, activation) of every K3 call the BN layers
    make (``fused_bn_act_train`` and ``fused_bn_act``); the calls
    themselves run unchanged."""
    cases = []
    train_bn, infer_bn = fo.fused_bn_act_train, fo.fused_bn_act

    def train(x2d, gamma, beta, center, eps=1e-5, activation="identity",
              group=None):
        cases.append((x2d.dtype, *x2d.shape, activation))
        return train_bn(x2d, gamma, beta, center, eps, activation, group)

    def infer(x2d, scale, shift, activation="identity"):
        cases.append((x2d.dtype, *x2d.shape, activation))
        return infer_bn(x2d, scale, shift, activation)

    fo.fused_bn_act_train, fo.fused_bn_act = train, infer
    try:
        yield cases
    finally:
        fo.fused_bn_act_train, fo.fused_bn_act = train_bn, infer_bn


def _resnet_run(model, fused, x, y, steps, fo, graphs=True, mesh=None,
                profile=False):
    """Train a fresh ResNet-50 (identical params: the same seed) for
    ``steps`` steps on one batch, every BN's ``fused`` set as given, its
    steps replayed from a CUDA graph or (``graphs`` False) eager; with a
    ``mesh``, through ``ParallelWrapper(net, mesh)``; with ``profile``,
    one more step under the profiler for its device ms. Returns the net,
    its record (losses, K3 launches per step, how each step ran, wall ms
    a step and samples/s over the timed steps, peak device memory), the
    step-1 grads (Momentum's trace after one step from v0 = 0), the
    running stats after step 1 and the final params, states and trace
    (for the bit-for-bit comparison of two runs)."""
    from deeplearning4j_tpu_torch import disable_graphs
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.nn._compiled import tensors

    net = ComputationGraph(model.conf())
    _set_fused(net, fused)
    net.init()
    trainer = net
    steplog = _StepLog(fo)
    if mesh is not None:
        from deeplearning4j_tpu_torch.parallel import ParallelWrapper
        trainer = ParallelWrapper(net, mesh)
        steplog = _StepLog(fo, step_of=lambda _: trainer._step)
    net.set_listeners(steplog)
    ds = DataSet(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.nullcontext() if graphs else disable_graphs():
        t0 = time.perf_counter()
        trainer.fit([ds])
        grads = {f"{n}/{k}": t.clone() for n, p in
                 net._opt_state[1][0]["trace"].items() for k, t in p.items()}
        states1 = {f"{n}/{k}": t.clone() for n, p in net.states.items()
                   for k, t in p.items()}
        t1 = time.perf_counter()
        if steps > 1:
            trainer.fit([ds] * (steps - 1))
    secs = steplog.step_s(t0, t1)       # step 1's clones left out
    rec = {"losses": [r[0] for r in steplog.rows],
           "k3_launches_per_step": steplog.launches_per_step(),
           **way_summary(steplog.kinds(), secs, x.shape[0], "samples",
                         torch.cuda.max_memory_allocated() / 2**30)}
    final = [(f"{i}", t.detach().clone()) for i, t in enumerate(
        tensors((net.params, net.states, net._opt_state)))]
    if profile:
        with contextlib.nullcontext() if graphs else disable_graphs():
            add_profile(rec, profile_step(lambda: trainer.fit([ds])))
    return net, rec, grads, states1, final


def _worst(a, b):
    """(max, median, worst key) of the per-entry relative L2 of a vs b."""
    rels = {k: rel_l2(a[k], b[k]) for k in b}
    worst = max(rels, key=rels.get)
    return rels[worst], sorted(rels.values())[len(rels) // 2], worst


def _step1(runs, a, b):
    """Run a against run b after step 1: |loss delta|, and (max, median,
    worst key) of the per-tensor relative L2 of the running stats and of
    the grads."""
    (ra, ga, sa, _), (rb, gb, sb, _) = runs[a], runs[b]
    return (abs(ra["losses"][0] - rb["losses"][0]), _worst(sa, sb),
            _worst(ga, gb))


class _Scores:
    """Scores of the steps, replayed by ``fit_scanned`` after an epoch."""
    deferred_score_ok = True

    def __init__(self):
        self.scores = []

    def iteration_done(self, net, it, epoch, loss):
        self.scores.append(loss)


def scan_path(tag, net, ds, k, counts, per_step, fit_losses, loss_atol):
    """``fit_scanned`` of ``net`` (fresh, the init of the ``fit`` run whose
    losses are ``fit_losses``) over ``k`` copies of ``ds``: a first epoch
    (eager step, capture, replays), then a timed one (``k`` replays; the
    first epoch's eager step and capture are left out of the time), and a
    third under the profiler for the device ms a step. Holds
    step 1 to ``fit``'s within ``loss_atol``, the losses finite and
    falling, every step after the first replayed, and each kernel counted
    by ``counts()`` launched ``per_step`` times in the eager step and in
    the capture; prints whether the losses equal ``fit``'s bit for bit.
    Returns the launches of the first ``2k`` steps (each replay at its
    capture's count)."""
    scores = _Scores()
    net.set_listeners(scores)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = counts()
    net.fit_scanned([ds] * k)
    mid = counts()
    t0 = time.perf_counter()
    last = net.fit_scanned([ds] * k)
    wall = time.perf_counter() - t0
    first = {n: mid[n] - before[n] for n in mid}
    second = {n: counts()[n] - mid[n] for n in mid}
    n = min(len(fit_losses), k)
    rec = {"losses": list(scores.scores), "last": last,
           "equal_to_fit": scores.scores[:n] == fit_losses[:n],
           "step_calls": dict(net._step_fn.calls),
           "wall_ms_per_step": wall / k * 1e3,
           "samples_per_s": k * ds.features.shape[0] / wall,
           "timed": f"epoch 2: {k} replays (epoch 1's eager step and "
                    "capture left out; the epoch's stack of its batches "
                    "included)",
           "peak_alloc_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches_epoch_1": first, "launches_epoch_2": second}
    losses = list(scores.scores)
    # a third epoch under the profiler: device ms a step beside the wall
    prof = profile_step(lambda: net.fit_scanned([ds] * k))
    rec["device_ms_per_step"] = prof["device_ms_per_step"] / k
    rec["busy_share"] = rec["device_ms_per_step"] / rec["wall_ms_per_step"]
    log(f"{tag} fit_scanned ({k} batches an epoch, 2 epochs and a profiled "
        f"one): {json.dumps(rec)}")
    failed = []
    if not abs(losses[0] - fit_losses[0]) <= loss_atol:
        failed.append("step-1 loss disagrees with fit's")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        failed.append("losses not finite or not falling")
    if rec["step_calls"] != {"direct": 0, "eager": 1, "capture": 1,
                             "replay": 2 * k - 2}:
        failed.append("the steps did not replay a graph")
    if first != {n: 2 * per_step for n in first} or any(second.values()):
        failed.append("kernel launches")
    if failed:
        raise SystemExit(f"{tag} fit_scanned: {failed}")
    return {n: per_step * 2 * k for n in first}


def resnet_path(fa, pa, fo, checked, steps=5, profile=False):
    """ResNet-50 at full width trained on the kernel path and the plain
    path from identical params and one batch, then inference.

    The net at its random init is chaotic: on the card half a bf16
    rounding of input noise moved the plain path's own step-1 grads by
    more than 100% (rel L2), 1e-7 of f32 noise by ~3%, and the
    trajectories part further with each step. So the kernel path is held
    to the plain path where nothing has diverged yet: the step-1 loss and
    running stats in bf16 and f32, the step-1 grads in f32, and
    ``output()``. Later-step losses and the bf16 grads are printed, not
    held. A second plain run on the identical input (one step) shows how
    much of the spread is the plain path's own, cuDNN's order of
    summation. The kernels themselves are held to their plain versions
    in phase 7 (``checked``) at every (dtype, N, C, activation) this run
    hands them, which is asserted here."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.train import Momentum
    from deeplearning4j_tpu_torch.zoo.resnet import ResNet50

    rng = np.random.default_rng(0)
    x = torch.as_tensor(
        rng.random((RESNET_BATCH, RESNET_HW, RESNET_HW, 3), np.float32),
        device="cuda")
    y = torch.as_tensor(np.eye(1000, dtype=np.float32)[
        rng.integers(0, 1000, RESNET_BATCH)], device="cuda")
    failed, seen, knet, train_counts = [], set(), None, None
    from deeplearning4j_tpu_torch import disable_graphs
    # bench.py's resnet50 row (bench.py:786-788, batch 128) is bf16; the
    # f32 net trains one step, for its grads. The kernel path's steps are
    # replayed from a CUDA graph (bf16: also run eager, to compare); the
    # plain path, the yardstick, runs eager
    for dtype, n_steps, loss_atol, state_atol, grad_limit in (
            (torch.bfloat16, steps, RESNET_LOSS_ATOL, RESNET_STATE_REL_L2,
             None),
            (torch.float32, 1, RESNET_F32_LOSS_ATOL,
             RESNET_F32_STATE_REL_L2, RESNET_GRAD_REL_L2)):
        model = ResNet50(num_classes=1000, updater=Momentum(0.1, 0.9),
                         compute_dtype=torch.bfloat16
                         if dtype == torch.bfloat16 else None,
                         input_shape=(RESNET_HW, RESNET_HW, 3))
        runs = {}
        for path, fused, path_steps, graphs in (
                ("kernel", True, n_steps, True),
                *((("kernel_eager", True, n_steps, False),)
                  if n_steps > 1 else ()),
                ("plain", False, n_steps, False),
                ("plain_again", False, 1, False)):
            main = dtype == torch.bfloat16 and path == "kernel"
            if main:                   # the main path's own counts
                fa.reset_launches()
                pa.reset_launches()
                fo.reset_launches()
            with _k3_cases(fo) as cases:
                net, rec, g, s1, final = _resnet_run(
                    model, fused, x, y, path_steps, fo, graphs)
            seen |= set(cases)
            if main:
                knet = net
                train_counts = {
                    **{k: sum(per[k] for per in rec["k3_launches_per_step"])
                       for k in k3_counts(fo)},
                    "flash_attention_fwd": fa.LAUNCHES,
                    "flash_attention_bwd_dq": fa.LAUNCHES_BWD_DQ,
                    "flash_attention_bwd_dkv": fa.LAUNCHES_BWD_DKV,
                    "paged_attention": pa.LAUNCHES}
                if not all(n == 53 for per in rec["k3_launches_per_step"]
                           for n in per.values()):
                    failed.append("K3 launch counts")
                if rec["step_kinds"] != ["eager", "capture",
                                         *["replay"] * (n_steps - 2)]:
                    failed.append("the kernel path did not replay a graph")
            if path.startswith("kernel") and n_steps > 1:
                with contextlib.nullcontext() if graphs else \
                        disable_graphs():
                    prof = profile_step(lambda: net.fit(DataSet(x, y)))
                add_profile(rec, prof)
                if profile and path == "kernel_eager":
                    with disable_graphs():
                        profile_resnet_step(net, DataSet(x, y), fo)
            log(f"resnet50 train {path} path (B{RESNET_BATCH} {RESNET_HW}x"
                f"{RESNET_HW}, {str(dtype)[6:]}, BN fused={fused}, "
                f"{'graph replays' if graphs else 'eager'}): "
                f"{json.dumps(rec)}")
            runs[path] = (rec, g, s1, final)
            if not main:
                del net
            torch.cuda.empty_cache()
        if "kernel_eager" in runs:
            (kr, *_, kf), (er, *_, ef) = runs["kernel"], runs["kernel_eager"]
            diff = first_diff(ef, kf)
            log(f"resnet50 kernel path, graph replays vs eager: losses "
                f"equal {kr['losses'] == er['losses']}, params, running "
                f"stats and trace bit-identical {diff is None}"
                + ("" if diff is None else
                   f" (first differing leaf: #{diff} of params, states, "
                   "trace)")
                + f"; wall ms a step {kr['wall_ms_per_step']:.2f} vs "
                f"{er['wall_ms_per_step']:.2f}")
            if not er["k3_launches_per_step"] == kr["k3_launches_per_step"]:
                failed.append("K3 launch counts, eager vs graph")
            if not er["losses"][-1] < er["losses"][0]:
                failed.append("eager kernel path: the loss does not fall")
        tag = str(dtype)[6:]
        kp = _step1(runs, "kernel", "plain")
        pp = _step1(runs, "plain_again", "plain")
        later = [abs(a - b) for a, b in zip(runs["kernel"][0]["losses"],
                                            runs["plain"][0]["losses"])][1:]
        finite = all(bool(torch.isfinite(t).all())
                     for t in runs["kernel"][1].values())
        log(f"resnet50 step 1, kernel vs plain ({tag}) [plain vs plain on "
            f"the identical input]: |loss delta| {kp[0]:.3e} [{pp[0]:.3e}] "
            f"(limit {loss_atol}); running stats rel L2 max {kp[1][0]:.3e} "
            f"({kp[1][2]}) [{pp[1][0]:.3e}] (limit {state_atol}); grads rel "
            f"L2 median {kp[2][1]:.3e} max {kp[2][0]:.3e} ({kp[2][2]}) "
            f"[{pp[2][1]:.3e} / {pp[2][0]:.3e}] (limit "
            f"{grad_limit or 'none: not held'}); all finite {finite}"
            + (f"; |loss delta| at steps 2-{n_steps}, not held: "
               f"{[f'{v:.2e}' for v in later]}" if later else ""))
        # written as "not (x <= limit)" so that a NaN fails
        if not finite:
            failed.append(f"{tag} non-finite grads")
        if not kp[0] <= loss_atol:
            failed.append(f"{tag} step-1 loss")
        if not kp[1][0] <= state_atol:
            failed.append(f"{tag} running stats")
        if grad_limit is not None and not kp[2][0] <= grad_limit:
            failed.append(f"{tag} step-1 grads")
        if n_steps > 1 and not all(
                runs[p][0]["losses"][-1] < runs[p][0]["losses"][0]
                for p in ("kernel", "plain")):
            failed.append(f"{tag} loss does not fall")
        del runs
    log(f"resnet50 K3 launches on the main path, {steps} steps: "
        f"{json.dumps(train_counts)}")
    if failed:
        raise SystemExit(f"resnet50 train path: {failed} disagree with the "
                         "plain path")

    # inference with the zoo's default fused="auto": the 33 relu BNs run
    # the normalize kernel, the 20 identity BNs the plain path
    _set_fused(knet, "auto")
    fa.reset_launches()
    pa.reset_launches()
    fo.reset_launches()
    with _k3_cases(fo) as cases:
        out_k = knet.output(x)
    torch.cuda.synchronize()
    seen |= set(cases)
    out_counts = {**k3_counts(fo), "flash_attention_fwd": fa.LAUNCHES,
                  "flash_attention_bwd_dq": fa.LAUNCHES_BWD_DQ,
                  "flash_attention_bwd_dkv": fa.LAUNCHES_BWD_DKV,
                  "paged_attention": pa.LAUNCHES}
    # the KL is taken on the logits of the same inference forward (bf16
    # softmax probabilities underflow to 0 once the net has trained)
    logits = {}
    with torch.no_grad():
        for fused in ("auto", False):
            _set_fused(knet, fused)
            _, pre, _ = knet._forward(knet.params, knet.states, {"in": x},
                                      train=False, rng=None,
                                      stop_at_output_preact=True)
            logits[fused] = knet.conf.nodes["out"].op.pre_activation(
                knet.params["out"], pre["out"])
    kl = kl_rows(logits[False], logits["auto"]).max().item()
    finite = bool(torch.isfinite(out_k.float()).all())
    sums = out_k.float().sum(-1)
    rows_ok = bool(torch.allclose(sums, torch.ones_like(sums), atol=2e-2))
    agree = (logits["auto"].argmax(-1) == logits[False].argmax(-1)) \
        .float().mean().item()
    log(f"resnet50 output() fused=auto vs plain BNs: shape "
        f"{tuple(out_k.shape)}, finite {finite}, rows sum to 1 {rows_ok}, "
        f"per-row KL of the logits max {kl:.3e} (limit {MAX_KL}), argmax "
        f"agree {agree:.3f}, launches {json.dumps(out_counts)} (want "
        "bn_act 33, K3 others 0)")
    if out_k.shape != (RESNET_BATCH, 1000) or not finite or not rows_ok \
            or not kl <= MAX_KL:
        raise SystemExit("resnet50 output(): logits disagree with the plain "
                         "path")
    want = {"bn_act": 33, "bn_stats": 0, "bn_bwd_reduce": 0, "bn_bwd_dx": 0}
    if {k: out_counts[k] for k in want} != want:
        raise SystemExit("resnet50 output(): K3 launch counts "
                         f"{out_counts}, want {want}")
    # bench.py's resnet50_fitscan row (bench.py:819): the same bf16 net
    # through fit_scanned from the same init on the same batch
    kernel_losses = knet.listeners[0].rows
    del knet
    torch.cuda.empty_cache()
    scan_net = ComputationGraph(ResNet50(
        num_classes=1000, updater=Momentum(0.1, 0.9),
        compute_dtype=torch.bfloat16,
        input_shape=(RESNET_HW, RESNET_HW, 3)).conf())
    _set_fused(scan_net, True)
    scan_net.init()
    fa.reset_launches()
    pa.reset_launches()
    fo.reset_launches()
    with _k3_cases(fo) as cases:
        scan_counts = scan_path("resnet50", scan_net, DataSet(x, y), 4,
                                lambda: k3_counts(fo), 53,
                                [r[0] for r in kernel_losses],
                                RESNET_LOSS_ATOL)
    seen |= set(cases)
    del scan_net
    torch.cuda.empty_cache()
    unchecked = sorted(f"{str(dt)[6:]} N{n} C{c} {act}"
                       for dt, n, c, act in seen - checked)
    log(f"resnet50 K3 cases (dtype, N, C, activation): {len(seen)} on the "
        f"path, {len(seen) - len(unchecked)} of them held in phase 7")
    if unchecked:
        raise SystemExit(f"resnet50: K3 ran at {unchecked}, which phase 7 "
                         "did not hold to the plain version")
    return {"resnet_train": train_counts, "resnet_output": out_counts,
            "resnet_fitscan": {**scan_counts, "paged_attention": 0}}


K3_KERNELS = ("bn_act_kernel", "bn_reduce_kernel", "bn_dx_kernel")


def profile_resnet_step(net, ds, fo):
    """One kernel-path train step under ``torch.profiler``: device-busy
    share, K3's device time and the conv/GEMM share, the top kernels, the
    device launches of each K3 kernel beside the wrappers' counts (each
    reduction wrapper must make exactly one launch), and K3's bound for
    the step (the four kernels' bounds summed over the (N, C) rows each
    BN layer of the step hands them)."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, PROFILE_TRIES + 1):
        before = k3_counts(fo)
        with _k3_cases(fo) as rows, profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            net.fit(ds)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        calls = {k: v - before[k] for k, v in k3_counts(fo).items()}
        out, launches, shares = _resnet_trace(prof, wall)
        want = {"bn_act_kernel": calls["bn_act"],
                "bn_reduce_kernel": calls["bn_stats"]
                + calls["bn_bwd_reduce"],
                "bn_dx_kernel": calls["bn_bwd_dx"]}
        # the profiler loses events now and then: fewer launches in the
        # trace than the wrappers made is a short trace, taken again
        if all(launches[k] >= n for k, n in want.items()):
            break
        log(f"resnet50 profile: trace {attempt} of {PROFILE_TRIES} is "
            f"short: K3 device launches {launches}, wrappers {want}")
    else:
        log(f"resnet50 profile: {PROFILE_TRIES} traces were short; the "
            "step is not traced (the wrappers' counts are held elsewhere)")
        return
    busy = sum(shares.values())
    out["device_ms_by_class"] = {k: v / 1e3 for k, v in shares.items()}
    out["share_of_device"] = {k: v / busy for k, v in shares.items()}
    out["k3_bn_layers"] = len(rows)
    out["k3_bound_ms"] = sum(k3_bound(k, n, c, dt)[0]
                             for dt, n, c, _ in rows for k in K3_OPS)
    out["k3_ms_over_bound"] = shares["k3"] / 1e3 / out["k3_bound_ms"]
    out["k3_device_launches"] = launches
    out["k3_wrapper_calls"] = calls
    out["profile_tries"] = attempt
    log(f"profile (resnet50 train step, B{RESNET_BATCH}, kernel path): "
        + json.dumps(out))
    if launches != want or not calls["bn_stats"]:
        raise SystemExit(f"resnet50 profile: K3 device launches {launches}, "
                         f"want one a wrapper call {want}")


def _resnet_trace(prof, wall):
    """A ResNet-50 step's trace: its device rows, K3's device launches by
    kernel, and the device µs of K3, the convolutions and GEMMs, and the
    rest."""
    out = device_rows(prof, wall, 1)
    shares = {"k3": 0.0, "conv_gemm": 0.0, "other": 0.0}
    launches = dict.fromkeys(K3_KERNELS, 0)
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        key = ev.key.lower()
        k3 = [k for k in K3_KERNELS if k in key]
        if k3:
            shares["k3"] += us
            launches[k3[0]] += ev.count
        elif any(t in key for t in ("conv", "gemm", "xmma", "cudnn", "nvjet",
                                    "cutlass", "implicit", "wgrad", "dgrad",
                                    "sm90")):
            shares["conv_gemm"] += us
        else:
            shares["other"] += us
    return out, launches, shares


# ---------------------------------------------------------------- phase 9

def lstm_bound(b, t, h, dtype):
    """xproj and rw read once, hs written once, h0/c0 read once (the
    inputs' dtype), peepholes f32; the recurrent products 2·B·H·4H·T. The
    chain of T dependent steps is not in it."""
    item = torch.finfo(dtype).bits // 8
    nbytes = (b * t * 4 * h + b * t * h + h * 4 * h + 2 * b * h) * item \
        + 3 * h * 4
    return bound_ms(nbytes, 2 * b * h * 4 * h * t, dtype)


def check_lstm(fl, dtype, b, t, h, gen, peep=True, state=False,
               grads=False, time_it=False, route=None):
    """K4 against ``lstm_seq_reference`` on one shape, on ``route`` ("block"
    or "cluster"; None: the route ``lstm_seq`` picks by shape): within
    ``LSTM_ATOL``, a second launch bitwise equal, the launches counted on
    that route; optionally the Function's grads against autograd through
    the plain version, and the kernel, plain, cuDNN and input-projection
    times."""
    dev = "cuda"
    x = torch.randn((b, t, 4 * h), generator=gen, device=dev).to(dtype)
    rw = (torch.randn((h, 4 * h), generator=gen, device=dev)
          * h ** -0.5).to(dtype)
    p = (torch.randn((3, h), generator=gen, device=dev) * 0.1 if peep
         else torch.zeros((3, h), device=dev))
    z = torch.zeros((b, h), device=dev)
    h0 = (torch.randn((b, h), generator=gen, device=dev) * 0.5 if state
          else z).to(dtype)
    c0 = (torch.randn((b, h), generator=gen, device=dev) if state
          else z).to(dtype)
    ins = (x, rw, p, h0, c0)
    shape_route = fl.lstm_route(b, t, h, dtype)
    route = route or shape_route
    kernel = {"block": fl.lstm_seq_block,
              "cluster": fl.lstm_seq_cluster}[route]
    before = dict(fl.LAUNCHES_BY_ROUTE)
    out = kernel(*ins)
    again = kernel(*ins)
    ref = fl.lstm_seq_reference(*ins)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    repeat = torch.equal(out, again)
    counted = fl.LAUNCHES_BY_ROUTE[route] - before[route] == 2
    ok = err <= LSTM_ATOL[dtype] and repeat and counted
    plan = (fl.lstm_cluster_plan(b, h, dtype) if route == "cluster"
            else fl.lstm_plan(b, h))
    res = {"max_abs_err": err, "route": route, "plan": plan}
    name = (f"K4 fused_lstm {str(dtype)[6:]} B{b} T{t} H{h}"
            f"{'' if peep else ' no peepholes'}"
            f"{' h0/c0 nonzero' if state else ''} {route} route"
            f"{'' if route == shape_route else ' (forced; by shape ' + str(shape_route) + ')'}")
    msg = (f"max_abs_err {err:.3e} (atol {LSTM_ATOL[dtype]}), repeat "
           f"{repeat}, launches counted on the route {counted}, plan {plan}")
    if grads:
        w = torch.randn((b, t, h), generator=gen, device=dev)

        def grad_of(fn):
            leaves = [v.detach().clone().requires_grad_(True) for v in ins]
            return torch.autograd.grad((fn(*leaves).float() * w).sum(),
                                       leaves)

        got, want = grad_of(fl.fused_lstm_seq), grad_of(fl.lstm_seq_reference)
        res["grad_max_abs_err"] = max((a.float() - b_.float()).abs().max()
                                      .item() for a, b_ in zip(got, want))
        ok &= all(grad_ok(a, b_, dtype) for a, b_ in zip(got, want))
        msg += (f", Function grads vs autograd max abs err "
                f"{res['grad_max_abs_err']:.3e}")
        del got, want
    if time_it:
        res["ms"] = cuda_ms(lambda: kernel(*ins))
        res["plain_ms"] = cuda_ms(lambda: fl.lstm_seq_reference(*ins),
                                  iters=3, warmup=1)
        # the library yardstick: cuDNN's LSTM at input width H, zero
        # peepholes, its input projection included; the port never calls it
        lstm = torch.nn.LSTM(h, h, batch_first=True).to(dev, dtype)
        lstm.flatten_parameters()
        xin = torch.randn((b, t, h), generator=gen, device=dev).to(dtype)
        w_in = torch.randn((h, 4 * h), generator=gen, device=dev).to(dtype)
        b_in = torch.randn((4 * h,), generator=gen, device=dev).to(dtype)
        with torch.no_grad():
            res["library_ms"] = cuda_ms(lambda: lstm(xin))
        res["proj_ms"] = cuda_ms(
            lambda: torch.addmm(b_in, xin.view(b * t, h), w_in))
        res["bound_ms"], res["bound_by"] = lstm_bound(b, t, h, dtype)
        msg += (f"; kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} "
                f"ms, cuDNN LSTM (incl. input projection) "
                f"{res['library_ms']:.4f} ms, x@W+b {res['proj_ms']:.4f} ms,"
                f" bound {res['bound_ms']:.5f} ms ({res['bound_by']}; the T "
                f"dependent steps not counted)")
    log(f"{name}: {msg} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"K4 {dtype} B{b} T{t} H{h} ({route} route) "
                         "disagrees with its plain version, does not repeat "
                         "or was not counted on its route")
    return res


def k4_phase(fl, gen):
    """Phase 9. Returns the results at the path shape (by dtype, then
    route) and the (dtype, B, H, route) cases held."""
    b, t, h = CHARNN_BATCH, CHARNN_T, CHARNN_H
    out, checked = {}, set()

    def held(dtype, bb, tt, hh, route=None, **kw):
        r = check_lstm(fl, dtype, bb, tt, hh, gen, route=route, **kw)
        checked.add((dtype, bb, hh, r["route"]))
        return r

    for dtype in (torch.bfloat16, torch.float32):
        out[dtype] = {
            "cluster": held(dtype, b, t, h, "cluster", grads=True,
                            time_it=True),
            "block": held(dtype, b, t, h, "block", time_it=True)}
        held(dtype, b, t, h, peep=False)
        held(dtype, b, t, h, state=True)
        held(dtype, b, t, h, "block", state=True)
        held(dtype, 3, 7, 40, state=True, grads=True)
        held(dtype, 5, 1, 16, state=True)
        held(dtype, 1, 5, h, state=True)
        held(dtype, 133, 4, 64, state=True)
        edge = K4_ROUTE_EDGE[dtype]
        for hh in (edge, edge + 8):
            r = held(dtype, 33, 6, hh, state=True)
            want = "cluster" if hh == edge else "block"
            if r["route"] != want:
                raise SystemExit(f"K4 {dtype} H{hh} took the {r['route']} "
                                 f"route, want {want}")
        if dtype == torch.float32:
            # the f32 route's T boundary at one wave (B 33: 3 clusters),
            # two (B 256: 16 clusters; the card holds 15) and three (B 512)
            one, two = fl.F32_CLUSTER_MIN_T
            for bb, tt in ((33, one - 1), (33, one), (b, two - 1), (b, two),
                           (2 * b, t)):
                r = held(dtype, bb, tt, h, state=True)
                log(f"K4 f32 B{bb} T{tt} H{h}: {r['route']} route (the card "
                    f"holds {fl.cluster_max_active(bb, h, dtype)} clusters, "
                    f"the grid has {-(-bb // fl.CLUSTER_ROWS)})")
        active = fl.cluster_max_active(b, h, dtype)
        out[dtype]["cluster"]["max_active_clusters"] = active
        log(f"K4 cluster route {str(dtype)[6:]} B{b} H{h}: plan "
            f"{fl.lstm_cluster_plan(b, h, dtype)}, the card keeps {active} "
            f"clusters resident (the grid has {-(-b // fl.CLUSTER_ROWS)})")
        torch.cuda.empty_cache()
    return out, checked


# --------------------------------------------------------------- phase 10

def all_counts(fa, pa, fo, fl):
    return {"fused_lstm": fl.LAUNCHES,
            **{f"fused_lstm_{r}": n for r, n in fl.LAUNCHES_BY_ROUTE.items()},
            **k3_counts(fo),
            "flash_attention_fwd": fa.LAUNCHES,
            "flash_attention_bwd_dq": fa.LAUNCHES_BWD_DQ,
            "flash_attention_bwd_dkv": fa.LAUNCHES_BWD_DKV,
            "paged_attention": pa.LAUNCHES}


def reset_all(*mods):
    for m in mods:
        m.reset_launches()


class _FitLog:
    """A fit listener: loss, host time, K4 launches (all and by route) and
    how the compiled step ran at the end of each step (``fit`` reads the
    loss to the host first)."""

    def __init__(self, fl):
        self.fl, self.rows, self.base = fl, [], fl.LAUNCHES
        self.routes = [dict(fl.LAUNCHES_BY_ROUTE)]
        self.t0 = time.perf_counter()

    def iteration_done(self, net, it, epoch, loss):
        self.rows.append((loss, time.perf_counter(), self.fl.LAUNCHES,
                          net._step_fn.last))
        self.routes.append(dict(self.fl.LAUNCHES_BY_ROUTE))

    def record(self, batch):
        """Losses, K4 launches a step, all and by route (a replay at its
        capture's), and :func:`way_summary` over the timed steps."""
        counts = [r[2] for r in self.rows]
        kinds = [r[3] for r in self.rows]
        ends = [r[1] for r in self.rows]
        return {"losses": [r[0] for r in self.rows],
                "k4_launches_per_step": replay_counts(
                    [a - b for a, b in zip(counts, [self.base] + counts)],
                    kinds),
                "k4_launches_by_route_per_step": replay_counts(
                    [{r: a[r] - b[r] for r in a}
                     for b, a in zip(self.routes, self.routes[1:])], kinds),
                **way_summary(kinds, [b - a for a, b in
                                      zip([self.t0] + ends, ends)],
                              batch, "samples",
                              torch.cuda.max_memory_allocated() / 2**30)}


def _set_lstm_fused(net, fused):
    from deeplearning4j_tpu_torch.nn import LSTM
    for layer in net.layers:
        if isinstance(layer, LSTM):
            layer.fused = fused


@contextlib.contextmanager
def _k4_cases(fl):
    """Record the (dtype, B, H, route) of every ``fused_lstm_seq`` call the
    LSTM layers make, the route the one whose launch count the call moved
    (``"none"`` if it launched nothing, several joined by ``+``); the
    calls themselves run unchanged."""
    cases = []
    real = fl.fused_lstm_seq

    def spy(xproj, rw, peep, h0, c0):
        before = dict(fl.LAUNCHES_BY_ROUTE)
        out = real(xproj, rw, peep, h0, c0)
        ran = [r for r, n in fl.LAUNCHES_BY_ROUTE.items() if n != before[r]]
        cases.append((xproj.dtype, xproj.shape[0], rw.shape[0],
                      "+".join(ran) or "none"))
        return out

    fl.fused_lstm_seq = spy
    try:
        yield cases
    finally:
        fl.fused_lstm_seq = real


def _charnn_logits(net, x):
    """The RnnOutputLayer's logits of an inference forward, (B·T, V) f32."""
    with torch.no_grad():
        h, _ = net._forward(net.params, net.states, x, train=False, rng=None,
                            stop_before_output=True)
        out = net.layers[-1]
        logits = out.pre_activation(net.params[f"layer_{len(net.layers) - 1}"],
                                    h)
    return logits.float().reshape(-1, logits.shape[-1])


def charnn_path(fa, pa, fo, fl, checked, steps=5, profile=False):
    """The char-RNN at full width, the kernel path against the scan."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    b, t, v = CHARNN_BATCH, CHARNN_T, CHARNN_VOCAB
    rng = np.random.default_rng(0)
    eye = np.eye(v, dtype=np.float32)
    x = torch.as_tensor(eye[rng.integers(0, v, (b, t))], device="cuda")
    y = torch.as_tensor(eye[rng.integers(0, v, (b, t))], device="cuda")
    ds = DataSet(x, y)
    failed, seen, runs, nets = [], set(), {}, {}
    from deeplearning4j_tpu_torch import disable_graphs
    from deeplearning4j_tpu_torch.nn._compiled import tensors
    # the kernel path replayed from a CUDA graph and eager; the plain
    # path (the scan), the yardstick, eager
    for path, fused, graphs in (("kernel", True, True),
                                ("kernel_eager", True, False),
                                ("plain", False, False)):
        net = TextGenerationLSTM(num_classes=v, input_shape=(t, v),
                                 units=CHARNN_H,
                                 compute_dtype=torch.bfloat16).init()
        _set_lstm_fused(net, fused)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if path == "kernel":                 # the main path's own counts
            reset_all(fa, pa, fo, fl)
        steplog = _FitLog(fl)
        net.set_listeners(steplog)
        with contextlib.nullcontext() if graphs else disable_graphs():
            with _k4_cases(fl) as cases:
                net.fit([ds] * steps)
            rec = steplog.record(b)
            final = [(f"{i}", p.detach().clone()) for i, p in enumerate(
                tensors((net.params, net.states, net._opt_state)))]
            if path != "plain":
                add_profile(rec, profile_step(lambda: net.fit(ds), k4=True))
        seen |= set(cases)
        if path == "kernel":
            train_counts = {**all_counts(fa, pa, fo, fl), "fused_lstm": sum(
                rec["k4_launches_per_step"]), **{
                f"fused_lstm_{r}": sum(s[r] for s in
                                       rec["k4_launches_by_route_per_step"])
                for r in fl.LAUNCHES_BY_ROUTE}}
            if rec["step_kinds"][:steps] != ["eager", "capture",
                                             *["replay"] * (steps - 2)]:
                failed.append("the kernel path did not replay a graph")
        if path != "plain" and rec["k4_launches_per_step"] != [2] * steps:
            failed.append(f"{path}: K4 launches per step")
        if profile and path == "kernel_eager":
            with disable_graphs():
                profile_charnn_step(net, ds, fl)
        log(f"charnn train {path} path (B{b} T{t} H{CHARNN_H} V{v}, bf16, "
            f"GravesLSTM fused={fused}, "
            f"{'graph replays' if graphs else 'eager'}): {json.dumps(rec)}")
        runs[path], nets[path] = (rec, final), net
    diff = first_diff(runs["kernel_eager"][1], runs["kernel"][1])
    log(f"charnn kernel path, graph replays vs eager: losses equal "
        f"{runs['kernel'][0]['losses'] == runs['kernel_eager'][0]['losses']}"
        f", params and updater state bit-identical {diff is None}"
        + ("" if diff is None else f" (first differing leaf: #{diff})"))
    runs = {p: r for p, (r, _) in runs.items()}
    del nets["kernel_eager"]
    knet = nets["kernel"]
    reset_all(fa, pa, fo, fl)
    with _k4_cases(fl) as cases:
        out_k = knet.output(x)
    torch.cuda.synchronize()
    seen |= set(cases)
    out_counts = all_counts(fa, pa, fo, fl)
    # a replayed output() (after its eager call and its capture)
    knet.output(x)
    out_prof = profile_step(lambda: knet.output(x), k4=True)
    log(f"charnn output() replayed (B{b} T{t}, kernel path): "
        + json.dumps({k: out_prof[k] for k in (
            "wall_ms_per_step", "device_ms_per_step", "device_busy_share",
            "k4_device_ms", "k4_share_of_device")}))
    logits = {}
    for fused in (True, False):
        _set_lstm_fused(knet, fused)
        logits[fused] = _charnn_logits(knet, x)
    kl = kl_rows(logits[False], logits[True]).max().item()
    finite = bool(torch.isfinite(out_k.float()).all())
    sums = out_k.float().sum(-1)
    rows_ok = bool(torch.allclose(sums, torch.ones_like(sums), atol=2e-2))
    dloss = abs(runs["kernel"]["losses"][0] - runs["plain"]["losses"][0])
    falls = all(r["losses"][-1] < r["losses"][0] for r in runs.values())
    del nets, knet

    # one f32 step of each path: the step-1 loss and grads
    f32 = {}
    for path, fused in (("kernel", True), ("plain", False)):
        net = TextGenerationLSTM(num_classes=v, input_shape=(t, v),
                                 units=CHARNN_H).init()
        _set_lstm_fused(net, fused)
        with _k4_cases(fl) as cases:
            grads, score = net.gradient_and_score(ds)
        seen |= set(cases)
        f32[path] = (score, {f"{k}/{n}": g for k, p in grads.items()
                             for n, g in p.items()})
        del net
    rels = {n: rel_l2(f32["kernel"][1][n], f32["plain"][1][n])
            for n in f32["plain"][1]}
    worst = max(rels, key=rels.get)
    f32_dloss = abs(f32["kernel"][0] - f32["plain"][0])
    log(f"charnn kernel vs plain: bf16 step-1 |loss delta| {dloss:.3e} "
        f"(limit {CHARNN_LOSS_ATOL}), later steps not held "
        f"{[f'{abs(a - b_):.2e}' for a, b_ in zip(runs['kernel']['losses'], runs['plain']['losses'])][1:]}; "
        f"f32 step-1 |loss delta| {f32_dloss:.3e} (limit "
        f"{CHARNN_F32_LOSS_ATOL}), grads rel L2 max {rels[worst]:.3e} "
        f"({worst}; limit {CHARNN_GRAD_REL_L2}); loss falls {falls}; "
        f"output() shape {tuple(out_k.shape)}, finite {finite}, rows sum to "
        f"1 {rows_ok}, per-row KL of the logits max {kl:.3e} (limit "
        f"{MAX_KL}); launches {json.dumps(out_counts)} (want fused_lstm 2)")
    if not dloss <= CHARNN_LOSS_ATOL:
        failed.append("bf16 step-1 loss")
    if not f32_dloss <= CHARNN_F32_LOSS_ATOL:
        failed.append("f32 step-1 loss")
    if not rels[worst] <= CHARNN_GRAD_REL_L2:
        failed.append("f32 step-1 grads")
    if not falls:
        failed.append("loss does not fall")
    if out_k.shape != (b, t, v) or not finite or not rows_ok \
            or not kl <= MAX_KL:
        failed.append("output()")
    if out_counts["fused_lstm"] != 2:
        failed.append("K4 launches in output()")
    unchecked = sorted(f"{str(dt)[6:]} B{bb} H{hh} {r}"
                       for dt, bb, hh, r in seen - checked)
    log(f"charnn K4 cases (dtype, B, H, route): {len(seen)} on the path, "
        f"{len(seen) - len(unchecked)} of them held in phase 9")
    if unchecked:
        failed.append(f"K4 ran at {unchecked}, which phase 9 did not hold")
    routes = {r for *_, r in seen}
    if routes != {"cluster"}:
        failed.append(f"K4 ran on the routes {routes}, want the cluster "
                      "route only")
    for path, c in (("train", train_counts), ("output()", out_counts)):
        if c["fused_lstm_block"] or c["fused_lstm_cluster"] \
                != c["fused_lstm"]:
            failed.append(f"{path}: K4 launches by route {c}, want all "
                          "on the cluster route")
    if failed:
        raise SystemExit(f"charnn path: {failed}")
    return {"charnn_train": train_counts, "charnn_output": out_counts}


def profile_charnn_step(net, ds, fl):
    """One kernel-path char-RNN train step under ``torch.profiler``: wall
    and device time, the device-busy share, K4's share, the top kernels."""
    out = profile_step(lambda: net.fit(ds), k4=True)
    log(f"profile (charnn train step, B{CHARNN_BATCH} T{CHARNN_T}, kernel "
        "path): " + json.dumps(out))


@contextlib.contextmanager
def _k4_route(fl, route):
    """Send every K4 launch through one route's wrapper (``lstm_seq``
    picks by shape otherwise)."""
    real = fl.lstm_seq
    fl.lstm_seq = {"block": fl.lstm_seq_block,
                   "cluster": fl.lstm_seq_cluster}[route]
    try:
        yield
    finally:
        fl.lstm_seq = real


def charnn_k4_ab(fl, steps=5):
    """The char-RNN's replayed train step, ``output()`` and ``evaluate``
    (4 batches) with K4 on the block route and on the cluster route, in
    the order block, cluster, cluster, block, each on a fresh net from the
    same seed: wall ms (the median over ``steps`` replays), device ms and
    K4's share (one profiled replay). Returns the runs."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    b, t, v = CHARNN_BATCH, CHARNN_T, CHARNN_VOCAB
    rng = np.random.default_rng(10)
    eye = np.eye(v, dtype=np.float32)

    def data():
        return DataSet(
            torch.as_tensor(eye[rng.integers(0, v, (b, t))], device="cuda"),
            torch.as_tensor(eye[rng.integers(0, v, (b, t))], device="cuda"))
    ds, held = data(), [data() for _ in range(WORKFLOW_EVAL_BATCHES)]

    def walls(fn, n):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out))

    def entry(wall, prof):
        return {"wall_ms": wall, "device_ms": prof["device_ms_per_step"],
                "k4_device_ms": prof["k4_device_ms"],
                "k4_share_of_device": prof["k4_share_of_device"]}

    runs = []
    for route in ("block", "cluster", "cluster", "block"):
        with _k4_route(fl, route):
            fl.reset_launches()
            torch.manual_seed(0)
            net = TextGenerationLSTM(num_classes=v, input_shape=(t, v),
                                     units=CHARNN_H,
                                     compute_dtype=torch.bfloat16).init()
            _set_lstm_fused(net, True)
            net.fit([ds] * 3)                   # eager, capture, replay
            rec = {"route": route, "train_step": entry(
                walls(lambda: net.fit(ds), steps),
                profile_step(lambda: net.fit(ds), k4=True))}
            for _ in range(2):                  # eager, capture
                net.output(ds.features)
            rec["output"] = entry(
                walls(lambda: net.output(ds.features), steps),
                profile_step(lambda: net.output(ds.features), k4=True))
            net.evaluate(held)
            rec["evaluate"] = entry(
                walls(lambda: net.evaluate(held).confusion, 2),
                profile_step(lambda: net.evaluate(held).confusion, k4=True))
            if net._step_fn.last != "replay" or net._infer_fn.last != "replay":
                raise SystemExit(f"charnn K4 A/B ({route}): the steps did "
                                 "not replay")
            rec["k4_launches_by_route"] = dict(fl.LAUNCHES_BY_ROUTE)
            if sum(rec["k4_launches_by_route"].values()) \
                    != rec["k4_launches_by_route"][route] or not \
                    rec["k4_launches_by_route"][route]:
                raise SystemExit(f"charnn K4 A/B ({route}): K4 launches by "
                                 f"route {rec['k4_launches_by_route']}")
        log(f"charnn K4 route A/B (B{b} T{t} H{CHARNN_H} bf16, replayed; "
            f"evaluate over {WORKFLOW_EVAL_BATCHES} batches): "
            + json.dumps(rec))
        runs.append(rec)
        del net
        gc.collect()
        torch.cuda.empty_cache()
    return runs


# --------------------------------------------------------------- phase 11

def lenet_path(fa, pa, fo, fl, steps=5):
    """LeNet at batch 512 bf16 through MultiLayerNetwork.fit, replayed
    from a CUDA graph and eager (``disable_graphs()``) from the same
    init, then through ``fit_scanned`` (``bench.py``'s ``lenet_scan``
    row, bench.py:435)."""
    from deeplearning4j_tpu_torch import disable_graphs
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn._compiled import tensors
    from deeplearning4j_tpu_torch.zoo import LeNet

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.random((LENET_BATCH, 28, 28, 1), np.float32),
                        device="cuda")
    y = torch.as_tensor(np.eye(10, dtype=np.float32)[
        rng.integers(0, 10, LENET_BATCH)], device="cuda")
    ds = DataSet(x, y)
    recs, finals = {}, {}
    for way, graphs in (("graph", True), ("eager", False)):
        net = LeNet(num_classes=10, compute_dtype=torch.bfloat16).init()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all(fa, pa, fo, fl)
        steplog = _FitLog(fl)
        net.set_listeners(steplog)
        with contextlib.nullcontext() if graphs else disable_graphs():
            net.fit([ds] * steps)
            rec = recs[way] = steplog.record(LENET_BATCH)
            finals[way] = [(f"{i}", p.detach().clone()) for i, p in
                           enumerate(tensors((net.params, net.states,
                                              net._opt_state)))]
            add_profile(rec, profile_step(lambda: net.fit(ds)))
            counts = all_counts(fa, pa, fo, fl)
        log(f"lenet (B{LENET_BATCH} 28x28x1, bf16, "
            f"{'graph replays' if graphs else 'eager'}): {json.dumps(rec)}")
        if way == "graph":
            gnet = net
    net = gnet
    out = net.output(x)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(out.float()).all())
    sums = out.float().sum(-1)
    rows_ok = bool(torch.allclose(sums, torch.ones_like(sums), atol=2e-2))
    falls = all(r["losses"][-1] < r["losses"][0] for r in recs.values())
    diff = first_diff(finals["eager"], finals["graph"])
    pre = {i: type(p).__name__ for i, p in net._preprocessors.items()}
    replayed = recs["graph"]["step_kinds"][:steps] == [
        "eager", "capture", *["replay"] * (steps - 2)]
    log(f"lenet: loss falls {falls}; graph replays vs eager: losses equal "
        f"{recs['graph']['losses'][:steps] == recs['eager']['losses'][:steps]}"
        f", params and updater state bit-identical {diff is None}"
        + ("" if diff is None else f" (first differing leaf: #{diff})")
        + f"; output() shape {tuple(out.shape)}, finite {finite}, rows sum "
        f"to 1 {rows_ok}; preprocessors {pre}; launches "
        f"{json.dumps(counts)} (no TPU kernel on this path)")
    if not (falls and finite and rows_ok and replayed
            and out.shape == (LENET_BATCH, 10)
            and pre == {4: "CnnToFeedForwardPreProcessor"}):
        raise SystemExit("lenet path: the loss does not fall, the steps did "
                         "not replay a graph or output() is wrong")
    del net, gnet
    scan_net = LeNet(num_classes=10, compute_dtype=torch.bfloat16).init()
    scan_path("lenet", scan_net, ds, 8, lambda: {}, 0,
              recs["graph"]["losses"], LENET_LOSS_ATOL)
    return recs


# --------------------------------------------------------------- phase 12

WORKFLOW_EVAL_BATCHES = 4
WORKFLOW_MEM_EVERY = 5                   # MetricsListener's memory polls
OBS_BUDGET = 0.02                        # the plane's share of a wall
# the eight updaters ported in the workflow slice, each run under a
# StepSchedule halving its lr every step from this initial value
NEW_UPDATERS = {"AMSGrad": 1e-3, "Nadam": 1e-3, "AdaMax": 2e-3,
                "AdaDelta": 1.0, "AdaGrad": 1e-2, "RmsProp": 1e-3,
                "Lion": 1e-4, "Lamb": 1e-3}
LENET_MAX_NORM = 0.5                     # MaxNormConstraint on its dense W


def _ms_per_step(net, batches):
    """Wall ms a step of one ``fit`` over ``batches`` (ends on the card)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(batches)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / len(batches)


def _all_tensors(net):
    from deeplearning4j_tpu_torch.nn._compiled import tensors
    return [(f"{i}", t.detach().clone()) for i, t in enumerate(
        tensors((net.params, net.states, net._opt_state)))]


def _confusion(outs, labels, n):
    """The confusion matrix of ``output()`` results, counted on the host."""
    m = np.zeros((n, n), np.int64)
    for o, y in zip(outs, labels):
        o = o.float().reshape(-1, o.shape[-1]).argmax(-1).cpu().numpy()
        y = y.reshape(-1, y.shape[-1]).argmax(-1).cpu().numpy()
        np.add.at(m, (y, o), 1)
    return m


def _eval_pass(net, batches):
    """Samples/s of one ``evaluate`` over ``batches``, and the result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = net.evaluate(batches)
    ev.confusion                         # the one read to the host
    wall = time.perf_counter() - t0
    return ev, sum(len(b.features) for b in batches) / wall


def workflow_resnet(fo, checked):
    """ResNet-50 B128 through the DL4J workflow: Momentum under a
    StepSchedule, ``fit`` replayed with a deferred ScoreIterationListener
    and a MetricsListener (its cost, counts, census and device memory
    held; the same 7 steps eager on a clone with the listener, bit for
    bit), then with a CheckpointListener, ``evaluate`` replayed and eager,
    save/load and resume, clone."""
    import tempfile

    from deeplearning4j_tpu_torch import disable_graphs
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn import (CheckpointListener,
                                             ComputationGraph,
                                             ScoreIterationListener)
    from deeplearning4j_tpu_torch.nn._compiled import tensors
    from deeplearning4j_tpu_torch.nn.listeners import MetricsListener
    from deeplearning4j_tpu_torch.obs import MetricsRegistry
    from deeplearning4j_tpu_torch.train import Momentum, StepSchedule
    from deeplearning4j_tpu_torch.zoo.resnet import ResNet50

    rng = np.random.default_rng(12)

    def batch():
        x = rng.random((RESNET_BATCH, RESNET_HW, RESNET_HW, 3), np.float32)
        y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000,
                                                         RESNET_BATCH)]
        return DataSet(torch.as_tensor(x, device="cuda"),
                       torch.as_tensor(y, device="cuda"))

    ds, more = batch(), [batch() for _ in range(2)]
    evb = [batch() for _ in range(WORKFLOW_EVAL_BATCHES)]
    sched = StepSchedule(initial_value=0.1, decay_rate=0.5, step=4)
    model = ResNet50(num_classes=1000, updater=Momentum(sched, 0.9),
                     compute_dtype=torch.bfloat16,
                     input_shape=(RESNET_HW, RESNET_HW, 3))
    net = ComputationGraph(model.conf())
    _set_fused(net, True)
    net.init()
    # before any step: the same params and states, no updater state yet
    twin = net.clone()
    _set_fused(twin, True)
    fit_n = StepLaunches({"fit": net._compiled_step()},
                         lambda: k3_counts(fo))
    out_n = StepLaunches({"output": net._infer_step()},
                         lambda: k3_counts(fo))
    scores, failed, rec = [], [], {}
    sil = ScoreIterationListener(1, log_fn=scores.append)
    polls = []

    class PolledMetrics(MetricsListener):
        """Notes the allocator's count right after each memory poll."""

        def _poll_memory(self, model=None):
            super()._poll_memory(model)
            polls.append(torch.cuda.memory_allocated())
    reg = MetricsRegistry()
    ml = PolledMetrics(registry=reg, memory_frequency=WORKFLOW_MEM_EVERY)
    net.set_listeners(sil, ml)
    with _k3_cases(fo) as cases, tempfile.TemporaryDirectory() as tmp:
        fo.reset_launches()
        net.fit([ds, ds])                       # eager step, capture
        ov0 = ml.overhead_seconds
        rec["fit_ms_deferred_listener"] = _ms_per_step(net, [ds] * 5)
        ml_cost = ml.overhead_seconds - ov0
        after7 = _all_tensors(net)
        with disable_graphs():
            twin.set_listeners(MetricsListener(registry=MetricsRegistry(),
                                               memory_frequency=5))
            twin.fit([ds, ds])
            twin.fit([ds] * 5)
        torch.cuda.synchronize()
        twin_diff = first_diff(after7, _all_tensors(twin))
        del twin, after7
        saves = []

        class TimedCheckpoint(CheckpointListener):
            def _save(self, model, tag):
                t = time.perf_counter()
                super()._save(model, tag)
                saves.append(time.perf_counter() - t)

        ck = TimedCheckpoint(tmp, save_every_n_epochs=3)
        net.set_listeners(sil, ck, ml)
        ms = _ms_per_step(net, [ds] * 5)
        rec["fit_ms_sync_checkpoint_listener"] = ms - sum(saves) * 1e3 / 5
        rec["checkpoint_save_s"] = saves
        ck_ok = [p.name for p in Path(tmp).iterdir()] == \
            ["checkpoint_epoch_3.zip"]
        count = int(net._opt_state[1][1]["count"])
        kinds = dict(net._step_fn.calls)
        its = [int(m.split()[3]) for m in scores]
        vals = [float(m.split()[-1]) for m in scores]
        rec.update(step_calls=kinds, schedule_count=count,
                   lr_now=sched.value_at(count, 0), losses=vals)
        if its != list(range(1, 13)) or not np.isfinite(vals).all() \
                or not vals[-1] < vals[0]:
            failed.append("listener scores (order, finite, falling)")
        if kinds != {"direct": 0, "eager": 1, "capture": 1, "replay": 10}:
            failed.append("fit did not replay")
        if count != 12 or not ck_ok:
            failed.append("schedule count or checkpoint")
        # MetricsListener: its own cost under 2% of the replayed fit's
        # wall, every step and step interval counted (an epoch's first
        # step has no interval: 3 epochs), the census against the
        # params, the allocator's bytes against torch's at the poll, and
        # the replayed steps equal to the eager twin's bit for bit
        wall = rec["fit_ms_deferred_listener"] * 5 / 1e3
        params_bytes = sum(t.numel() * t.element_size()
                           for t in tensors(net.params))
        mem = reg.get("dl4j_device_memory_bytes")
        census = reg.get("dl4j_mem_component_bytes")
        rec["metrics_listener"] = {
            "overhead_s": ml_cost, "fit_wall_s": wall,
            "share": ml_cost / wall,
            "iterations": reg.get("dl4j_train_iterations_total").value(),
            "step_intervals": reg.get("dl4j_train_step_seconds").count(),
            "examples": reg.get("dl4j_train_examples_total").value(),
            "census_params_bytes": census.value(component="params",
                                                replica="0"),
            "params_bytes": params_bytes,
            "bytes_in_use": mem.value(stat="bytes_in_use"),
            "memory_allocated_at_poll": polls[-1] if polls else None,
            "polls": len(polls),
            "replayed_equals_eager": twin_diff is None}
        m = rec["metrics_listener"]
        if not m["share"] < OBS_BUDGET:
            failed.append(f"MetricsListener costs {m['share']:.4f} of the "
                          f"fit wall (limit {OBS_BUDGET})")
        if (m["iterations"], m["step_intervals"], m["examples"],
                m["polls"]) != (12, 9, 12 * RESNET_BATCH, 2):
            failed.append(f"MetricsListener counts {m}")
        if m["census_params_bytes"] != params_bytes or \
                m["bytes_in_use"] != m["memory_allocated_at_poll"]:
            failed.append(f"MetricsListener census or device memory {m}")
        if twin_diff is not None:
            failed.append(f"with MetricsListener, replayed != eager (first "
                          f"differing leaf #{twin_diff})")
        fit_launches = dict(fit_n.total)

        # evaluate: the zoo's fused="auto" at inference (33 normalize
        # launches a batch), replayed and eager
        _set_fused(net, "auto")
        ev, sps_first = _eval_pass(net, evb)
        eval_launches = dict(out_n.total)
        ev, sps = _eval_pass(net, evb)
        with disable_graphs():
            ev_eager, sps_eager = _eval_pass(net, evb)
            prof_eager = profile_step(lambda: net.output(evb[0].features))
        prof = profile_step(lambda: net.output(evb[0].features))
        outs = [net.output(b.features) for b in evb]
        want = _confusion(outs, [b.labels for b in evb], 1000)
        rec["evaluate"] = {
            "samples_per_s_replayed": sps, "samples_per_s_eager": sps_eager,
            "samples_per_s_first_pass": sps_first,
            "forward_device_ms_replayed": prof["device_ms_per_step"],
            "forward_busy_share_replayed": prof["device_busy_share"],
            "forward_device_ms_eager": prof_eager["device_ms_per_step"],
            "forward_busy_share_eager": prof_eager["device_busy_share"],
            "output_calls": dict(net._infer_fn.calls),
            "accuracy": ev.accuracy()}
        if not (np.array_equal(ev.confusion, want)
                and np.array_equal(ev_eager.confusion, want)
                and ev._conf.device.type == "cuda"
                and want.sum() == RESNET_BATCH * WORKFLOW_EVAL_BATCHES):
            failed.append("evaluate's counts disagree with output()'s")
        if eval_launches.get("bn_act") != 33 * WORKFLOW_EVAL_BATCHES or \
                any(eval_launches.get(k) for k in ("bn_stats",
                                                   "bn_bwd_reduce",
                                                   "bn_bwd_dx")):
            failed.append(f"evaluate's K3 launches {eval_launches}")
        _set_fused(net, True)

        # save with the updater, load, two more steps each: bit-identical
        net.set_listeners()
        path = Path(tmp) / "resnet.zip"
        t = time.perf_counter()
        net.save(path, save_updater=True)
        rec["save_s"] = time.perf_counter() - t
        rec["zip_mib"] = path.stat().st_size / 2**20
        t = time.perf_counter()
        twin = ComputationGraph.load(path)
        torch.cuda.synchronize()
        rec["load_s"] = time.perf_counter() - t
    cont = [net.fit(d) for d in more]
    resumed = [twin.fit(d) for d in more]
    diff = first_diff(_all_tensors(net), _all_tensors(twin))
    rec["resume"] = {"losses": cont, "loaded_losses": resumed,
                     "bit_identical": diff is None and cont == resumed}
    if not rec["resume"]["bit_identical"]:
        failed.append(f"resume after load (first differing leaf {diff})")
    del twin
    gc.collect()
    torch.cuda.empty_cache()

    # clone: real copies; training the clone leaves the source as it was
    before = _all_tensors(net)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    clone = net.clone()
    torch.cuda.synchronize()
    rec["clone_adds_gib"] = (torch.cuda.memory_allocated() - mem0) / 2**30
    clone.fit([ds, ds])
    rec["peak_alloc_gib_with_clone_training"] = \
        torch.cuda.max_memory_allocated() / 2**30
    untouched = first_diff(before, _all_tensors(net)) is None
    moved = first_diff(before, _all_tensors(clone)) is not None
    rec["clone"] = {"source_bit_identical": untouched,
                    "clone_moved": moved}
    if not (untouched and moved):
        failed.append("clone is not independent of its source")
    del clone, net
    gc.collect()
    torch.cuda.empty_cache()
    unchecked = set(cases) - checked
    rec["k3_launches"] = {"fit": fit_launches, "evaluate": eval_launches}
    log(f"workflow resnet50 (B{RESNET_BATCH}, bf16, Momentum under "
        f"StepSchedule(0.1, 0.5, 4), BN fused): {json.dumps(rec)}")
    if fit_launches != {k: 53 * 12 for k in k3_counts(fo)}:
        failed.append(f"fit's K3 launches {fit_launches}")
    if unchecked:
        failed.append(f"K3 ran at {unchecked}, which phase 7 did not hold")
    if failed:
        raise SystemExit(f"workflow resnet50: {failed}")
    return {"workflow_resnet_fit": fit_launches,
            "workflow_resnet_evaluate": {**{k: 0 for k in k3_counts(fo)},
                                         **eval_launches}}


class _RngLog(_FitLog):
    """``_FitLog`` that also records the train generator's state (its seed
    and Philox offset) after each step: a replay must advance it, so that
    each step draws new masks."""

    def iteration_done(self, net, it, epoch, loss):
        super().iteration_done(net, it, epoch, loss)
        self.rows[-1] = (*self.rows[-1],
                         tuple(net._gen.get_state().tolist()))


def workflow_charnn(fl, checked):
    """The char-RNN B256 T60 under RmsProp with input dropout 0.2 on both
    LSTMs (K4 fused): 5 replayed steps against 5 eager ones, bit for bit,
    the generator advancing each step; then ``evaluate``."""
    from deeplearning4j_tpu_torch import disable_graphs
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn import LSTM
    from deeplearning4j_tpu_torch.train import RmsProp
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    b, t, v = CHARNN_BATCH, CHARNN_T, CHARNN_VOCAB
    rng = np.random.default_rng(13)
    eye = np.eye(v, dtype=np.float32)

    def data():
        return DataSet(
            torch.as_tensor(eye[rng.integers(0, v, (b, t))], device="cuda"),
            torch.as_tensor(eye[rng.integers(0, v, (b, t))], device="cuda"))
    ds, held = data(), data()
    runs, nets, failed = {}, {}, []
    with _k4_cases(fl) as cases:
        for way, graphs in (("graph", True), ("eager", False)):
            net = TextGenerationLSTM(
                num_classes=v, input_shape=(t, v), units=CHARNN_H,
                compute_dtype=torch.bfloat16,
                updater=RmsProp(1e-3)).init()
            for layer in net.layers:
                if isinstance(layer, LSTM):
                    layer.fused, layer.dropout = True, 0.2
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fl.reset_launches()
            steplog = _RngLog(fl)
            net.set_listeners(steplog)
            with contextlib.nullcontext() if graphs else disable_graphs():
                net.fit([ds] * 5)
                rec = steplog.record(b)
                states = [r[4] for r in steplog.rows]
                final = _all_tensors(net)
                add_profile(rec, profile_step(lambda: net.fit(ds)))
            runs[way], nets[way] = (rec, final, states), net
            log(f"workflow charnn {way} (B{b} T{t} H{CHARNN_H}, bf16, "
                f"RmsProp(1e-3), LSTM input dropout 0.2, K4 fused): "
                f"{json.dumps(rec)}")
        (gr, gf, gs), (er, ef, es) = runs["graph"], runs["eager"]
        diff = first_diff(ef, gf)
        steps_ok = gr["step_kinds"][:5] == ["eager", "capture", "replay",
                                            "replay", "replay"]
        log(f"workflow charnn: replayed vs eager under dropout: losses "
            f"equal {gr['losses'] == er['losses']}, params and updater "
            f"state bit-identical {diff is None}; the generator's state "
            f"new after every step {len(set(gs)) == len(gs)}, equal to "
            f"eager's {gs == es}")
        if not (steps_ok and diff is None and gr["losses"] == er["losses"]
                and gs == es and len(set(gs)) == len(gs)):
            failed.append("replayed dropout steps differ from eager or "
                          "draw the same masks")
        if gr["k4_launches_per_step"] != [2] * 5:
            failed.append(f"K4 launches a step {gr['k4_launches_per_step']}")
        del nets["eager"]
        net = nets["graph"]
        fl.reset_launches()
        ev = net.evaluate([held])
        outs = [net.output(held.features)]
        torch.cuda.synchronize()
        eval_launches = fl.LAUNCHES
        eval_routes = dict(fl.LAUNCHES_BY_ROUTE)
        want = _confusion(outs, [held.labels], v)
        log(f"workflow charnn evaluate: accuracy {ev.accuracy():.4f}, "
            f"confusion equal to output()'s {np.array_equal(ev.confusion, want)}"
            f", K4 launches {eval_launches} (an eager output() and its "
            "capture)")
        if not np.array_equal(ev.confusion, want) or want.sum() != b * t \
                or eval_launches != 4:
            failed.append("evaluate")
    unchecked = set(cases) - checked
    if unchecked:
        failed.append(f"K4 ran at {unchecked}, which phase 9 did not hold")
    if {r for *_, r in cases} != {"cluster"}:
        failed.append("K4 left the cluster route")
    counts = {"fused_lstm": sum(gr["k4_launches_per_step"]) + eval_launches,
              **{f"fused_lstm_{r}": eval_routes[r] + sum(
                  s[r] for s in gr["k4_launches_by_route_per_step"])
                 for r in eval_routes}}
    log(f"workflow charnn K4 launches (fit and evaluate): {counts}")
    if counts["fused_lstm_block"] or counts["fused_lstm_cluster"] \
            != counts["fused_lstm"]:
        failed.append("K4 launches by route: not all on the cluster route")
    del net, nets
    gc.collect()
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"workflow charnn: {failed}")
    return {"workflow_charnn": counts}


class _Snapshots:
    """A synchronous listener: every tensor of the net after each step,
    and the largest column norm of each constrained W."""

    def __init__(self, keys=()):
        self.keys, self.snaps, self.norms = keys, [], []

    def iteration_done(self, net, it, epoch, loss):
        self.snaps.append(_all_tensors(net))
        self.norms.append(max(
            float(net.params[k]["W"].detach().float().norm(dim=0).max())
            for k in self.keys) if self.keys else 0.0)


def workflow_lenet():
    """LeNet B512: each new updater under a StepSchedule, 3 replayed steps
    against 3 eager; a MaxNormConstraint after every replay; a detector
    with one NaN batch; step time and peak memory with and without it."""
    from deeplearning4j_tpu_torch import disable_graphs, train
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn import DenseLayer, MultiLayerNetwork
    from deeplearning4j_tpu_torch.zoo import LeNet

    rng = np.random.default_rng(14)

    def data(bad=False):
        x = rng.random((LENET_BATCH, 28, 28, 1), np.float32)
        if bad:
            x[0, 0, 0, 0] = np.nan
        y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, LENET_BATCH)]
        return DataSet(torch.as_tensor(x, device="cuda"),
                       torch.as_tensor(y, device="cuda"))

    def lenet(updater, max_norm=None):
        conf = LeNet(num_classes=10, compute_dtype=torch.bfloat16,
                     updater=updater).conf()
        keys = []
        for i, layer in enumerate(conf.layers):
            if max_norm is not None and isinstance(layer, DenseLayer):
                layer.constraints = [train.MaxNormConstraint(max_norm)]
                keys.append(f"layer_{i}")
        return MultiLayerNetwork(conf).init(), keys

    good = [data() for _ in range(4)]
    failed, upd = [], {}
    for name, lr in NEW_UPDATERS.items():
        res = []
        for graphs in (True, False):
            net, _ = lenet(getattr(train, name)(train.StepSchedule(
                initial_value=lr, decay_rate=0.5, step=1)))
            with contextlib.nullcontext() if graphs else disable_graphs():
                losses = [net.fit(d) for d in good[:3]]
            res.append((losses, _all_tensors(net), dict(net._step_fn.calls)))
        (lg, tg, cg), (le, te, _) = res
        ok = lg == le and first_diff(te, tg) is None and \
            cg == {"direct": 0, "eager": 1, "capture": 1, "replay": 1}
        upd[name] = {"losses": lg, "replay_equals_eager": ok}
        if not (ok and np.isfinite(lg).all()):
            failed.append(name)
    log(f"workflow lenet (B{LENET_BATCH}, bf16): the eight new updaters, "
        f"lr a StepSchedule halving each step, 3 steps (eager, capture, "
        f"replay) against eager: {json.dumps(upd)}")

    net, keys = lenet(train.Adam(1e-2), LENET_MAX_NORM)
    snaps = _Snapshots(keys)
    net.set_listeners(snaps)
    net.fit(good + [good[0]])
    kinds = dict(net._step_fn.calls)
    log(f"workflow lenet MaxNormConstraint({LENET_MAX_NORM}) on {keys}: "
        f"largest column norm after each step {snaps.norms}, steps {kinds}")
    if not all(n <= LENET_MAX_NORM * (1 + 1e-5) for n in snaps.norms) or \
            kinds["replay"] != 3:
        failed.append("MaxNormConstraint")

    net, _ = lenet(train.Adam(1e-3))
    net.enable_gradient_anomaly_detection()
    snaps = _Snapshots()
    net.set_listeners(snaps)
    raised = False
    try:
        net.fit(good[:3] + [data(bad=True), good[3]])
    except FloatingPointError:
        raised = True
    noop = first_diff(snaps.snaps[2], snaps.snaps[3]) is None
    log(f"workflow lenet detector: NaN batch at step 4 (a {net._step_fn.last}"
        f" at step {net._step_count}): a no-op {noop}, raised one step late "
        f"{raised and net._step_count == 5}")
    if not (noop and raised and net._step_count == 5
            and net._step_fn.calls["replay"] == 3):
        failed.append("anomaly gate")

    timing = {}
    for tag, detect in (("without_detector", False),
                        ("with_detector", True)):
        del net
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        net, _ = lenet(train.Adam(1e-3))
        if detect:
            net.enable_gradient_anomaly_detection(
                train.GradientAnomalyDetector(strict=False))
        net.fit(good[:2])
        timing[tag] = {
            "wall_ms_per_step": _ms_per_step(net, good * 5),
            "peak_alloc_gib_over_held": (torch.cuda.max_memory_allocated()
                                         - held) / 2**30,
            "held_before_gib": held / 2**30}
    log(f"workflow lenet replayed steps (20 a fit): {json.dumps(timing)}")
    del net
    gc.collect()
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"workflow lenet: {failed}")


def workflow_path(fa, pa, fo, fl, k3_checked, k4_checked):
    """Phase 12: the DL4J workflow around ``fit`` at full width (the
    counts of each part's kernels set to 0 just before it, read after)."""
    counts = {}
    reset_all(fa, pa, fo, fl)
    counts.update(workflow_resnet(fo, k3_checked))
    reset_all(fa, pa, fo, fl)
    counts.update(workflow_charnn(fl, k4_checked))
    reset_all(fa, pa, fo, fl)
    workflow_lenet()
    return counts


class HostClock:
    """Host seconds spent in named calls of live objects: :meth:`wrap`
    shadows a bound method with a timed one (an instance attribute),
    :meth:`restore` takes every wrapper away again."""

    def __init__(self):
        self.s, self.n, self._undo = {}, {}, []

    def wrap(self, obj, attr, name):
        fn = getattr(obj, attr)

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.s[name] = self.s.get(name, 0.0) \
                    + time.perf_counter() - t0
                self.n[name] = self.n.get(name, 0) + 1
        setattr(obj, attr, timed)
        self._undo.append((obj, attr))

    def restore(self):
        for obj, attr in reversed(self._undo):
            delattr(obj, attr)
        self._undo = []


def steady_sweeps(sched, prompt_len, steps=20, seed=1, profile=False):
    """Where a decode sweep's time goes once every slot decodes: fill
    the scheduler's slots with prompts of ``prompt_len`` tokens, step
    until none prefills, then time ``steps`` sweeps with the host split
    of each: (a) the scheduler's own bookkeeping in ``_decode_sweep``,
    (b) ``PageTable.sync`` (paged), (c) ``engine.decode_step`` from
    entry until its last launch returns, (d) the sampler and the read of
    its tokens; and the loop's time outside the sweep. Then ``steps``
    more under ``torch.profiler``: device ms a sweep and the busy share
    (device ms over the unprofiled wall ms). Milliseconds a sweep."""
    from torch.profiler import ProfilerActivity, profile
    eng = sched.engine
    rng = np.random.default_rng(seed)
    for _ in range(sched.n_slots):
        sched.submit(rng.integers(0, eng.cfg.vocab_size, prompt_len)
                     .astype(np.int32), max_new_tokens=2 * steps + 8)
    while any(r is None or r.pending is not None for r in sched.slots):
        sched.step()
    for _ in range(3):
        sched.step()
    torch.cuda.synchronize()
    clock = HostClock()
    clock.wrap(sched, "_decode_sweep", "sweep")
    if sched.paged:
        clock.wrap(sched._pages, "sync", "sync")
    clock.wrap(eng, "decode_step", "dispatch")
    clock.wrap(eng, "sample", "sample")
    clock.wrap(sched, "_read_tokens", "read")
    plane0 = dict(getattr(sched, "_plane_s", {}))
    t0 = time.perf_counter()
    for _ in range(steps):
        sched.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    plane = {k: (v - plane0[k]) * 1e3 / steps
             for k, v in getattr(sched, "_plane_s", {}).items()}
    clock.restore()
    ms = {k: v * 1e3 / steps for k, v in clock.s.items()}
    parts = {"sync": ms.get("sync", 0.0), "dispatch": ms["dispatch"],
             "sample": ms["sample"], "read": ms.get("read", 0.0)}
    split = {"bookkeeping": ms["sweep"] - sum(parts.values()), **parts,
             "outside_sweep": wall * 1e3 / steps - ms["sweep"]}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(steps):
            sched.step()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t1
    rows = device_rows(prof, pwall, steps)
    sched.run_until_idle()
    out = {"slots": sched.n_slots, "ctx": prompt_len, "sweeps": steps,
           "wall_ms": wall * 1e3 / steps, "host_split_ms": split,
           # a tree with the observability plane: its self-timed parts
           # a sweep (they overlap the split above)
           **({"plane_ms": plane} if plane else {}),
           "device_ms": rows["device_ms_per_step"],
           "busy_share": rows["device_ms_per_step"] / (wall * 1e3 / steps)}
    if profile:
        out["profiled_wall_ms"] = rows["wall_ms_per_step"]
        out["top_kernels"] = rows["top_kernels"]
    return out


def chunk_split(engine, n=10):
    """One ``prefill_chunk`` of 128 tokens (slot 0, start 0) into a
    paged cache of the phase-4 geometry: host ms from entry until its
    last launch returns, wall ms with a synchronise, device ms."""
    from deeplearning4j_tpu_torch.serving import PageTable
    cache = engine.init_paged_cache(8, 8 * 128, 16)
    table = PageTable.for_cache(cache)
    table.map(0, 128)
    table.sync(cache)
    toks = np.random.default_rng(2).integers(
        0, engine.cfg.vocab_size, 128).astype(np.int32)

    def call():
        engine.prefill_chunk(cache, toks, 0, start=0)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    host, wall = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        call()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host.append(t1 - t0)
        wall.append(time.perf_counter() - t0)
    return {"dispatch_ms": float(np.median(host)) * 1e3,
            "wall_ms": float(np.median(wall)) * 1e3,
            "device_ms": device_ms(call, iters=n)}


# --------------------------------------------------------------- phase 13

# the serving planes run on the 120M engine of bench.py:927-940 at the
# max_seq of bench.py's prefix-shared row (1024 + 128), with that row's
# dense-equivalent page budget (bench.py:1514): 8 slots x 72 pages of 16
PLANES_MAX_SEQ = 1152
PLANES_SLOTS = 8
PLANES_PAGE_LEN = 16
PLANES_PREFIX = 1024
PLANES_NEW = 16
EMBED_REL_L2 = 2e-2                      # bf16 pooled rows, relative L2
# SCORE's bf16 log-probabilities against the plain forward's, per token:
# EMBED_REL_L2 on the rows the head reads, through logits of about unit
# spread (this model's), as a difference of two logits, at four standard
# deviations (the extreme of 8 x 511 tokens): 4 sqrt(2) 2e-2 ~ 0.11
SCORE_LP_ATOL = 0.1                      # nats
BEAM_GAIN_TOL = 1e-3                     # nats


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def planes_config(tfm):
    return tfm.TransformerConfig(vocab_size=32000, d_model=512, n_heads=8,
                                 n_layers=8, d_ff=2048,
                                 max_seq=PLANES_MAX_SEQ,
                                 dtype=torch.bfloat16, remat=False)


class LastLogits:
    """Keeps the logits of an engine's latest ``prefill_chunk`` call (a
    request's first-token logits, once its final chunk ran)."""

    def __init__(self, engine):
        self.engine, self.last = engine, None
        fn = engine.prefill_chunk

        def rec(*a, **k):
            out = fn(*a, **k)
            self.last = out[0]
            return out
        engine.prefill_chunk = rec

    def restore(self):
        del self.engine.prefill_chunk


def planes_inputs(vocab, seed):
    """Every part's prompts, from ``default_rng(seed)``: (a) 9 prompts of
    a common 1024-token prefix and tails of 8-64 tokens (bench.py:1525);
    (b) a session's first turn (300 tokens) and its users' next two
    messages (45, 37 tokens); (c) 8 prompts of 512 (bench.py:1629); (d) 4
    prompts of 96-480; (e) a 256-token prompt (bench.py:1684); (f) a
    200-token prompt and an allowlist of 100 ids."""
    rng = np.random.default_rng(seed)

    def ids(n):
        return rng.integers(0, vocab, n).astype(np.int32)
    prefix = ids(PLANES_PREFIX)
    return {
        "prefix": [np.concatenate([prefix, ids(int(rng.integers(8, 65)))])
                   for _ in range(9)],
        "session": [ids(300), ids(45), ids(37)],
        "score": [ids(512) for _ in range(8)],
        "embed": [ids(n) for n in (96, 200, 333, 480)],
        "beam": ids(256),
        "constrained": (ids(200), np.sort(rng.choice(vocab, 100,
                                                     replace=False))),
    }


def planes_prefix(sched, prompts):
    """(a) A cold leader, the followers one at a time (each maps the
    cached prefix and prefills only its tail), then a wave of 8 sampled
    for the page census while it decodes."""
    hits0 = sched.kv_report()["prefix"]["prefix_hits"]
    leader = sched.submit(prompts[0], PLANES_NEW)
    sched.run_until_idle()
    first = leader.result(timeout=0)
    seq, warm = [first.tokens], []
    for p in prompts[1:]:
        f = sched.submit(p, PLANES_NEW)
        sched.run_until_idle()
        r = f.result(timeout=0)
        seq.append(r.tokens)
        warm.append(r.ttft_s)
    wave = [sched.submit(p, PLANES_NEW) for p in prompts[:PLANES_SLOTS]]
    # (active, pages the slots hold, mapped, shared): pages only the
    # cache holds (the warm-up's and earlier requests') left out
    best = (0, 0, 0, 0)
    t0 = time.perf_counter()
    while sched.step():
        with sched._lock:
            active = sum(1 for s in sched.slots if s is not None)
            if active >= best[0]:
                best = (active, sched._pages.used_pages
                        - sched._prefix.cached_pages,
                        sched._pages.mapped_pages,
                        sched._pages.shared_pages)
    _sync()
    wall = time.perf_counter() - t0
    wave_tokens = [f.result(timeout=0).tokens for f in wave]
    active, used, mapped, shared = best
    rep = sched.kv_report()["prefix"]
    return {"ttft_cold_s": first.ttft_s,
            "ttft_warm_median_s": float(np.median(warm)),
            "ttft_warm_max_s": float(np.max(warm)),
            "prefix_hits": rep["prefix_hits"] - hits0,
            "wave_wall_s": wall, "wave_active": active,
            "wave_used_pages": used, "wave_mapped_pages": mapped,
            "wave_shared_pages": shared,
            "tokens_resident_per_user_shared":
                used * PLANES_PAGE_LEN / max(active, 1),
            "tokens_resident_per_user_dense":
                mapped * PLANES_PAGE_LEN / max(active, 1),
            "check_pages": bool(sched.check_pages())}, \
        [t.tolist() for t in seq + wave_tokens]


def planes_session(sched, turns, sid):
    """(b) A session of 3 turns: each turn's prompt is the conversation so
    far plus the user's next message, and resumes append-only from the
    retained context (at an offset no chunk boundary aligns with). The
    turns' contexts, tokens and first-token logits."""
    rec = LastLogits(sched.engine)
    try:
        ctx, out = turns[0], []
        hit0 = sched.kv_report()["prefix"]["prefix_hit_tokens"]
        for turn in range(3):
            f = sched.submit(ctx, PLANES_NEW, session_id=sid)
            sched.run_until_idle()
            r = f.result(timeout=0)
            out.append({"ctx": ctx, "tokens": r.tokens,
                        "logits": rec.last.float().clone(),
                        "ttft_s": r.ttft_s})
            if turn < 2:
                ctx = np.concatenate([ctx, r.tokens, turns[turn + 1]])
        rep = sched.kv_report()["prefix"]
    finally:
        rec.restore()
    sched.drop_session(sid)
    return out, rep["prefix_hit_tokens"] - hit0


def _split(clock, wall):
    """Host seconds by wrapped call, and the rest of ``wall``."""
    got = dict(clock.s)
    got["rest"] = wall - sum(got.values())
    return got


def planes_score(sched, inp):
    """(c) SCORE: 8 prompts of 512 in one wave. The wall comes with host
    seconds by call (the chunk dispatch, the host's log-softmax tally;
    "rest" holds the reads of logits to the host and the bookkeeping)."""
    eng = sched.engine
    futs = [sched.submit(p, kind="score") for p in inp["score"]]
    clock = HostClock()
    clock.wrap(eng, "verify_chunk", "verify_chunk")
    clock.wrap(sched, "_score_rows", "score_rows")
    t0 = time.perf_counter()
    sched.run_until_idle()
    _sync()
    wall = time.perf_counter() - t0
    clock.restore()
    res = [f.result(timeout=0) for f in futs]
    return ({"wall_s": wall,
             "tokens_per_s": sum(len(p) for p in inp["score"]) / wall,
             "host_split_s": _split(clock, wall),
             "logprobs": [len(r.logprobs) for r in res],
             "finite": all(bool(np.isfinite(r.logprobs).all())
                           for r in res),
             "perplexity_head": [r.perplexity for r in res[:4]]},
            [r.logprobs.tolist() for r in res])


def planes_embed(sched, inp):
    """(d) EMBED: mean and last pooling of 4 prompts."""
    futs = [sched.submit(p, kind="embed", pooling=pool)
            for pool in ("mean", "last") for p in inp["embed"]]
    sched.run_until_idle()
    res = [f.result(timeout=0) for f in futs]
    return ({"dims": [int(r.embedding.shape[0]) for r in res]},
            [r.embedding for r in res])


def planes_beam(sched, inp):
    """(e) BEAM: width 4, 16 new tokens, the census sampled as it
    decodes. The wall comes with host seconds by call (the chunk and
    sweep dispatch, the sampler, the host's joint beam step; "rest"
    holds the reads of logits to the host and the bookkeeping)."""
    eng = sched.engine
    fb = sched.submit(inp["beam"], PLANES_NEW, kind="beam", beam_width=4)
    shared = 0
    clock = HostClock()
    clock.wrap(eng, "prefill_chunk", "prefill_chunk")
    clock.wrap(eng, "decode_step", "decode_step")
    clock.wrap(eng, "sample", "sample")
    clock.wrap(sched, "_advance_beam", "advance_beam")
    t0 = time.perf_counter()
    while sched.step():
        with sched._lock:
            shared = max(shared, sched._pages.shared_pages)
    _sync()
    wall = time.perf_counter() - t0
    clock.restore()
    beam = fb.result(timeout=0)
    return ({"wall_s": wall,
             "lane_tokens_per_s": len(beam.tokens) * 4 / wall,
             "host_split_s": _split(clock, wall),
             "best_logprob": beam.best_logprob,
             "max_shared_pages": shared,
             "check_pages": bool(sched.check_pages())},
            [[s.tolist() for s in beam.sequences], beam.scores,
             beam.tokens.tolist()])


def planes_beam_greedy(sched, inp):
    """BEAM's reference: greedy over the same horizon, its log-probability
    scored through SCORE. Its tokens and that log-probability."""
    p = inp["beam"]
    fg = sched.submit(p, PLANES_NEW)
    sched.run_until_idle()
    greedy = fg.result(timeout=0).tokens
    fs = sched.submit(np.concatenate([p, greedy]), kind="score")
    sched.run_until_idle()
    return greedy.tolist(), float(
        np.sum(fs.result(timeout=0).logprobs[len(p) - 1:]))


def planes_constrained(sched, inp):
    """(f) CONSTRAINED: an all-true mask beside a plain greedy request,
    and an allowlist."""
    from deeplearning4j_tpu_torch.serving import vocab_mask
    vocab = int(sched.engine.cfg.vocab_size)
    prompt, allow = inp["constrained"]
    futs = [sched.submit(prompt, PLANES_NEW, kind="constrained",
                         token_mask=np.ones(vocab, bool)),
            sched.submit(prompt, PLANES_NEW),
            sched.submit(prompt, PLANES_NEW, kind="constrained",
                         token_mask=vocab_mask(allow, vocab))]
    sched.run_until_idle()
    res = [f.result(timeout=0).tokens for f in futs]
    return ({"all_true_is_greedy": res[0].tolist() == res[1].tolist(),
             "allowlist_kept": bool(np.isin(res[2], allow).all())},
            [r.tolist() for r in res])


PLANES_KINDS = {"score": planes_score, "embed": planes_embed,
                "beam": planes_beam, "constrained": planes_constrained}


def planes_kinds(sched, inp, timed):
    """(c)-(f) on one scheduler, each kind through ``timed`` (which sets
    the launch counts to 0 just before it and reads them just after),
    then BEAM's greedy reference outside BEAM's window. kind →
    (readings, values, launches)."""
    out = {}
    for name, fn in PLANES_KINDS.items():
        (rd, vals), n = timed(lambda: fn(sched, inp))
        out[name] = (rd, vals, n)
    rd, vals, _ = out["beam"]
    greedy, greedy_lp = planes_beam_greedy(sched, inp)
    rd.update(greedy_logprob=greedy_lp, gain=rd["best_logprob"] - greedy_lp,
              best_is_greedy=vals[2] == greedy)
    vals.append(greedy)
    return out


def check_paged_shared(pa, dtype):
    """K2 at phase 13's decode shape (8 slots, H 8, Dh 64, page_len 16,
    72 table entries): all 8 slots map the same 64 prefix pages, each its
    own tail, at cursors 1032-1103 — its plain version's output (atol),
    a second launch bit for bit, device times, and the bound by the
    DISTINCT rows read."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    b, h, dh, plen, per_slot = PLANES_SLOTS, 8, 64, PLANES_PAGE_LEN, 72
    npg = PLANES_SLOTS * per_slot
    k, v = (torch.randn((npg, plen, h, dh), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    q = torch.randn((b, h, dh), generator=gen, device="cuda").to(dtype)
    rng = np.random.default_rng(13)
    perm = rng.permutation(npg)
    shared = perm[:PLANES_PREFIX // plen].tolist()
    table = torch.full((b, per_slot), npg, dtype=torch.int32)
    pos = torch.tensor(rng.integers(PLANES_PREFIX + 8,
                                    PLANES_PREFIX + 80, b), dtype=torch.int32)
    nxt = len(shared)
    for s in range(b):
        need = int(pos[s]) // plen + 1
        own = perm[nxt:nxt + need - len(shared)].tolist()
        nxt += len(own)
        table[s, :need] = torch.tensor(shared + own, dtype=torch.int32)
    rows = int((pos + 1).sum())
    distinct = PLANES_PREFIX + sum(int(pos[s]) + 1 - PLANES_PREFIX
                                   for s in range(b))
    table, pos = table.cuda(), pos.cuda()
    out = pa.paged_attention(q, k, v, table, pos)
    again = pa.paged_attention(q, k, v, table, pos)
    ref = pa.paged_attention_reference(q, k, v, table, pos)
    _sync()
    err = (out.float() - ref.float()).abs().max().item()
    repeats = bool(torch.equal(out, again))
    ms = device_ms(lambda: pa.paged_attention(q, k, v, table, pos), 50)
    plain_ms = device_ms(
        lambda: pa.paged_attention_reference(q, k, v, table, pos), 10)
    item = torch.finfo(dtype).bits // 8
    nbytes = (2 * distinct * h * dh * item + 2 * b * h * dh * item
              + table.numel() * 4 + pos.numel() * 4)
    bms, by = bound_ms(nbytes, 4 * rows * h * dh, dtype)
    ok = err <= ATOL[dtype] and repeats
    log(f"K2 over shared pages ({str(dtype)[6:]}, 8 slots on one "
        f"{PLANES_PREFIX}-token prefix, {rows} rows, {distinct} distinct): "
        f"max_abs_err {err:.3e} (atol {ATOL[dtype]}), second launch "
        f"{'identical' if repeats else 'DIFFERS'}; device ms kernel "
        f"{ms:.4f}, plain {plain_ms:.4f}, bound {bms:.5f} ({by}; kernel "
        f"{ms / bms:.1f}x) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("K2 over shared pages disagrees with its plain "
                         "version or does not repeat")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "rows": rows,
            "distinct_rows": distinct}


def planes_way(fa, pa, cfg, params, inp, warm_inputs, graphs):
    """One way (``graphs``: replayed, else eager under
    ``disable_graphs()``) of phase 13 on its own engine: the schedulers
    of every part warmed twice (other prompts of the same lengths, so
    every signature's capture happens in the warm-up), ``mark_warm()``,
    then each part with its launch counts set to 0 just before it and
    read just after. Returns part → (readings, values, launches) and the
    compile report."""
    from deeplearning4j_tpu_torch import disable_graphs
    from deeplearning4j_tpu_torch.serving import (
        ContinuousBatchingScheduler, GenerationEngine)
    engine = GenerationEngine(cfg, params)
    counts = StepLaunches({n: st._fn for n, st in engine.sentinels.items()},
                          lambda: serving_counts(fa, pa))
    kw = dict(n_slots=PLANES_SLOTS, page_len=PLANES_PAGE_LEN,
              n_pages=PLANES_SLOTS * -(-PLANES_MAX_SEQ // PLANES_PAGE_LEN))
    out = {}
    with contextlib.nullcontext() if graphs else disable_graphs():
        s_prefix = ContinuousBatchingScheduler(engine, prefix_cache=True,
                                               **kw)
        s_session = ContinuousBatchingScheduler(engine, prefix_cache=True,
                                                **kw)
        s_kinds = ContinuousBatchingScheduler(engine, **kw)
        for i, w in enumerate(warm_inputs):
            planes_prefix(s_prefix, w["prefix"])
            planes_session(s_session, w["session"], f"warm{i}")
            planes_kinds(s_kinds, w, lambda fn: (fn(), None))
        engine.mark_warm()

        def timed(fn):
            _sync()
            fa.reset_launches()
            pa.reset_launches()
            counts.reset()
            got = fn()
            _sync()
            return got, dict(counts.total)

        (rd, vals), n = timed(lambda: planes_prefix(s_prefix,
                                                     inp["prefix"]))
        out["prefix"] = (rd, vals, n)
        (turns, hit_tokens), n = timed(lambda: planes_session(
            s_session, inp["session"], "timed"))
        out["session"] = ({"prefix_hit_tokens": hit_tokens,
                           "ttft_s": [t["ttft_s"] for t in turns]},
                          [t["tokens"].tolist() for t in turns], n, turns)
        out.update(planes_kinds(s_kinds, inp, timed))
        out["compiles"] = compile_summary(engine)
        out["gather_calls"] = sum(
            engine.sentinels["decode_paged"].calls.values())
        out["kernel_choice"] = engine._paged_kernel_choice(s_kinds.cache)
    del engine, s_prefix, s_session, s_kinds, counts
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serving_planes(fa, pa, smi):
    """Phase 13: prefix sharing, sessions and the typed request kinds on
    the paged scheduler, the 120M engine (``planes_config``; seeded
    weights), replayed and eager (tokens and values identical), against a
    third engine's plain references. Returns path → the replayed ways'
    launch counts, and K2's check over shared pages."""
    from deeplearning4j_tpu_torch.serving import (
        ContinuousBatchingScheduler, GenerationEngine, PageTable)
    from deeplearning4j_tpu_torch.zoo import transformer as tfm
    cfg = planes_config(tfm)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    inp = planes_inputs(cfg.vocab_size, 0)
    warm = [planes_inputs(cfg.vocab_size, s) for s in (100, 101)]
    k2_shared = check_paged_shared(pa, torch.bfloat16)
    ways = {"replayed": planes_way(fa, pa, cfg, params, inp, warm, True),
            "eager": planes_way(fa, pa, cfg, params, inp, warm, False)}
    rep, eag = ways["replayed"], ways["eager"]
    failed = []
    parts = ("prefix", "session", "score", "embed", "beam", "constrained")
    for part in parts:
        same = _values_equal(rep[part][1], eag[part][1])
        log(f"planes {part}: replayed {json.dumps(rep[part][0])}; eager "
            f"{json.dumps(eag[part][0])}; launches (captures' counts) "
            f"replayed {json.dumps(rep[part][2])}, eager "
            f"{json.dumps(eag[part][2])}; replayed = eager: {same}")
        if not same:
            failed.append(f"{part}: replayed values differ from eager")
    for way, w in ways.items():
        retr = sum(c[2] for c in w["compiles"].values())
        log(f"planes {way}: compile report [compiles, signatures, retraces "
            f"after warm] {json.dumps(w['compiles'])}; gather decode calls "
            f"{w['gather_calls']}, paged route {w['kernel_choice']}")
        if retr:
            failed.append(f"{way}: {retr} retraces after warm")
        if w["gather_calls"] or w["kernel_choice"] != "kernel":
            failed.append(f"{way}: a paged decode left the kernel route")
        for part in ("prefix", "session", "beam", "constrained"):
            if w[part][2].get("paged_attention", 0) <= 0:
                failed.append(f"{way} {part}: K2 was not launched")
    a = rep["prefix"][0]
    if a["prefix_hits"] < 8 or not a["check_pages"] \
            or not a["wave_used_pages"] < a["wave_mapped_pages"]:
        failed.append(f"prefix: hits {a['prefix_hits']} (want >= 8), used "
                      f"{a['wave_used_pages']} vs mapped "
                      f"{a['wave_mapped_pages']}, check {a['check_pages']}")
    # the plain references, on a third engine: no prefix cache
    ref_eng = GenerationEngine(cfg, params)
    kw = dict(n_slots=PLANES_SLOTS, page_len=PLANES_PAGE_LEN,
              n_pages=PLANES_SLOTS * -(-PLANES_MAX_SEQ // PLANES_PAGE_LEN))
    off = ContinuousBatchingScheduler(ref_eng, **kw)
    seq_off, ttft_off = [], []
    for p in inp["prefix"]:
        f = off.submit(p, PLANES_NEW)
        off.run_until_idle()
        r = f.result(timeout=0)
        seq_off.append(r.tokens.tolist())
        ttft_off.append(r.ttft_s)
    seq_on = rep["prefix"][1][:len(inp["prefix"])]
    if seq_on != seq_off:
        failed.append("prefix: greedy tokens with the prefix cache differ "
                      "from a scheduler without it")
    rec = LastLogits(ref_eng)
    kls, match = [], []
    for turn in rep["session"][3]:
        f = off.submit(turn["ctx"], PLANES_NEW)
        off.run_until_idle()
        toks = f.result(timeout=0).tokens
        kls.append(kl_rows(rec.last[None], turn["logits"][None].to(
            rec.last.device)).item())
        match.append(float(np.mean(toks == turn["tokens"])))
    rec.restore()
    if not max(kls) <= MAX_KL:
        failed.append(f"session: first-token KL {kls} over {MAX_KL}")
    # SCORE: the final row of each verify chunk against prefill_chunk's
    # logits of the same chunk (the head's product runs at another row
    # count: KL, not bits)
    cache = ref_eng.init_paged_cache(1, 40, PLANES_PAGE_LEN)
    table = PageTable.for_cache(cache)
    prompt = inp["score"][0]
    table.map(0, len(prompt))
    table.sync(cache)
    vkl = []
    for c0 in range(0, len(prompt), ref_eng.chunk_len):
        chunk = prompt[c0:c0 + ref_eng.chunk_len]
        rows, _ = ref_eng.verify_chunk(cache, chunk, 0, start=c0)
        last, _ = ref_eng.prefill_chunk(cache, chunk, 0, start=c0)
        vkl.append(kl_rows(last[None], rows[len(chunk) - 1][None]).item())
    sc = rep["score"][0]
    if not (sc["finite"] and set(sc["logprobs"]) == {511}
            and max(vkl) <= MAX_KL):
        failed.append(f"score: {sc['logprobs']} logprobs, finite "
                      f"{sc['finite']}, verify-vs-prefill KL {vkl}")
    # SCORE's log-probabilities and EMBED's vectors against the plain
    # full forward (kernel off, f32 scores) at the same weights
    plain_cfg = dataclasses.replace(cfg, use_flash_attention=False,
                                    attn_scores_bf16=False)

    def plain_rows(p):
        ids = torch.as_tensor(p, dtype=torch.long,
                              device=params["embed"].device)[None]
        x = tfm.embed(params, plain_cfg, ids)
        x, _ = tfm.apply_blocks(params["blocks"], plain_cfg, x)
        return ids[0], x[0]
    lp_err = []
    with torch.no_grad():
        for p, got in zip(inp["score"], rep["score"][1]):
            ids, x = plain_rows(p)
            lp = torch.log_softmax(
                tfm.head_logits_rows(params, plain_cfg, x), dim=-1)
            want = lp[:-1].gather(-1, ids[1:, None])[:, 0].cpu().numpy()
            lp_err.append(float(np.abs(np.asarray(got) - want).max()))
        rel = []
        for i, pool in enumerate(("mean", "last")):
            for j, p in enumerate(inp["embed"]):
                hid = tfm.hidden_rows(params, plain_cfg,
                                      plain_rows(p)[1]).cpu().numpy()
                want = hid.mean(axis=0) if pool == "mean" else hid[-1]
                got = rep["embed"][1][i * len(inp["embed"]) + j]
                rel.append(float(np.linalg.norm(got - want)
                                 / np.linalg.norm(want)))
    if not max(lp_err) <= SCORE_LP_ATOL:
        failed.append(f"score: logprobs off the plain forward's by "
                      f"{lp_err} nats, over {SCORE_LP_ATOL}")
    if not max(rel) <= EMBED_REL_L2:
        failed.append(f"embed: relative L2 {rel} over {EMBED_REL_L2}")
    bm = rep["beam"][0]
    if not (bm["gain"] >= -BEAM_GAIN_TOL and bm["max_shared_pages"] > 0
            and bm["check_pages"]):
        failed.append(f"beam: {bm}")
    cn = rep["constrained"][0]
    if not (cn["all_true_is_greedy"] and cn["allowlist_kept"]):
        failed.append(f"constrained: {cn}")
    del ref_eng, off, cache
    gc.collect()
    torch.cuda.empty_cache()
    log(f"planes summary ({smi}): TTFT cold {a['ttft_cold_s']:.4f} s, "
        f"warm median {a['ttft_warm_median_s']:.4f} s (no sharing, same "
        f"prompts: median {float(np.median(ttft_off[1:])):.4f} s); tokens "
        f"resident per user shared "
        f"{a['tokens_resident_per_user_shared']:.1f} vs dense "
        f"{a['tokens_resident_per_user_dense']:.1f} ({a['wave_active']} "
        f"users); prefix hits {a['prefix_hits']}; greedy with the prefix "
        f"cache = without: {seq_on == seq_off}; session first-token KL "
        f"{[f'{k:.3e}' for k in kls]} (limit {MAX_KL}), greedy match "
        f"{match}, hit tokens {rep['session'][0]['prefix_hit_tokens']}; "
        f"SCORE {sc['tokens_per_s']:.1f} tokens/s, logprobs vs the plain "
        f"forward max abs {max(lp_err):.3e} nats (limit {SCORE_LP_ATOL}), "
        f"verify-vs-prefill KL max {max(vkl):.3e}; EMBED relative L2 max {max(rel):.3e} (limit "
        f"{EMBED_REL_L2}); BEAM lane {bm['lane_tokens_per_s']:.1f} tokens/s, "
        f"gain {bm['gain']:.4f} nats (best {bm['best_logprob']:.4f}, greedy "
        f"{bm['greedy_logprob']:.4f}), shared pages {bm['max_shared_pages']}"
        f"; CONSTRAINED all-true = greedy {cn['all_true_is_greedy']}, "
        f"allowlist kept {cn['allowlist_kept']}")
    if failed:
        raise SystemExit(f"serving planes: {failed}")
    return ({f"planes_{p}": rep[p][2] for p in parts}, k2_shared)


# --------------------------------------------------------------- phase 14

# the wave: 16 GENERATE prompts of 17-1500 tokens (4 of them >= 1024), 32
# new tokens each, a SCORE of 512 tokens and a BEAM of 256 (width 4), on
# phase 4's paged scheduler; the dense scheduler of phase 4 serves the
# four longest with the plane on too (its prefills run K1: a paged
# prefill runs in chunks of 128 tokens, which never reach flash_min_seq)
OBS_LENS = (17, 90, 140, 260, 385, 512, 640, 700, 777, 900, 960, 1000,
            1024, 1200, 1350, 1500)
OBS_NEW = 32
OBS_WAVES = 5                            # best of 5, as the reference
OBS_SLO = {"ttft_s": 2.0, "itl_s": 0.25}
OBS_SAMPLE_ATOL = 1e-4                   # entropy, card vs host formula


def obs_inputs(vocab, seed):
    rng = np.random.default_rng(seed)

    def ids(n):
        return rng.integers(0, vocab, n).astype(np.int32)
    gen = [ids(n) for n in OBS_LENS]
    return {"generate": gen, "score": ids(512), "beam": ids(256),
            "dense": gen[-4:]}


def obs_wave(sched, inp):
    """One wave on the paged scheduler: every request submitted, then run
    until idle. Returns the results and the wall seconds of the run."""
    futs = [sched.submit(p, OBS_NEW) for p in inp["generate"]]
    futs.append(sched.submit(inp["score"], kind="score"))
    futs.append(sched.submit(inp["beam"], OBS_NEW, kind="beam",
                             beam_width=4))
    _sync()
    t0 = time.perf_counter()
    sched.run_until_idle()
    _sync()
    wall = time.perf_counter() - t0
    res = [f.result(timeout=0) for f in futs]
    if not sched.check_pages():
        raise SystemExit("obs plane: page census broken after a wave")
    return res, wall


def obs_values(res):
    return [r.tokens.tolist() if not hasattr(r, "logprobs")
            else r.logprobs.tolist() for r in res] + \
        [[s.tolist() for s in r.sequences] for r in res
         if hasattr(r, "sequences")]


def obs_dense(sched, prompts):
    futs = [sched.submit(p, OBS_NEW) for p in prompts]
    sched.run_until_idle()
    return [f.result(timeout=0).tokens.tolist() for f in futs]


def plane_cost(sched):
    """The scheduler's self-timed plane seconds by part, and its engine's
    sentinels'."""
    return {"trace_overhead": sched.trace_overhead_seconds,
            "sentinels": sum(s.overhead_seconds
                             for s in sched.engine.sentinels.values()),
            **sched._plane_s}


def _reg_delta(s0, s1, name):
    """Counter values or histogram counts gained between two registry
    snapshots, by label key."""
    out = {}
    for key, v in s1.get(name, {}).items():
        before = s0.get(name, {}).get(key)
        if isinstance(v, dict):
            out[key] = v["count"] - (before or {}).get("count", 0)
        else:
            out[key] = v - (before or 0.0)
    return out


def host_entropy(rows):
    """The reference's host formula for a sampler observation's mean
    next-token entropy, in f32 numpy (phase 14 holds no top-k mass: its
    requests are greedy)."""
    lg = np.array(rows, np.float32, copy=True)
    lg = lg[None] if lg.ndim == 1 else lg
    lg -= lg.max(axis=-1, keepdims=True)
    np.exp(lg, out=lg)
    lg /= lg.sum(axis=-1, keepdims=True)
    return float((-(lg * np.log(lg + 1e-30)).sum(axis=-1)).mean())


def obs_counted(fa, pa, sched, counts, inp):
    """The counted wave on the fully instrumented scheduler: registry
    deltas against the scheduler's own counts, spans, the SLO report
    against one recomputed from the flight recorder's traces, a dump
    loaded back, the sampler against the host formula, the census.
    Returns (readings, failures, launches, values)."""
    from deeplearning4j_tpu_torch.nn._compiled import tensors
    from deeplearning4j_tpu_torch.obs import (SLOConfig, SLOTracker,
                                              get_registry, get_tracer,
                                              load_flight_records)
    from deeplearning4j_tpu_torch.obs import memory as obs_memory
    from deeplearning4j_tpu_torch.serving import kvcache
    reg, tracer = get_registry(), get_tracer()
    sched.slo = SLOTracker(SLOConfig(**OBS_SLO), replica=sched.replica)
    tracer.clear()
    n_req0 = len(sched.flight_recorder.requests())
    st0, ev0 = dict(sched.stats), sched._obs_events
    seen = []
    observe = sched._sample_obs

    def capture(m, rows, topks):
        h = m["sample_entropy"]
        before = h.sum()
        observe(m, rows, topks)
        seen.append((rows.float().cpu().numpy(), h.sum() - before))
    sched._sample_obs = capture
    s0 = reg.snapshot()
    _sync()
    fa.reset_launches()
    pa.reset_launches()
    counts.reset()
    res, wall = obs_wave(sched, inp)
    launches = dict(counts.total)
    s1 = reg.snapshot()
    del sched._sample_obs
    st = {k: sched.stats[k] - st0[k] for k in st0}
    traces = sched.flight_recorder.requests()[n_req0:]

    def d(name, key=""):
        return _reg_delta(s0, s1, name).get(key, 0)
    failed = []
    reasons = {}
    for r in res:
        reasons[r.finish_reason] = reasons.get(r.finish_reason, 0) + 1
    got = {"requests": d("dl4j_serving_requests_total"),
           "tokens": d("dl4j_serving_tokens_total"),
           "prefills": d("dl4j_serving_prefills_total"),
           "decode_steps": d("dl4j_serving_decode_steps_total"),
           "completions": {k: v for k, v in _reg_delta(
               s0, s1, "dl4j_serving_completions_total").items() if v},
           "ttft_count": d("dl4j_serving_ttft_seconds"),
           "itl_count": d("dl4j_serving_itl_seconds"),
           "decode_spans": sum(sp.name == "serving.decode"
                               for sp in tracer.spans()),
           "kinds": {k: v for k, v in _reg_delta(
               s0, s1, "dl4j_workload_requests_total").items() if v}}
    want = {"requests": len(res), "tokens": st["tokens"],
            "prefills": st["prefills"], "decode_steps": st["decode_steps"],
            "completions": reasons, "ttft_count": len(res),
            "itl_count": sum(len(tr.itl_samples()) for tr in traces),
            "decode_spans": st["decode_steps"],
            "kinds": {"generate": len(OBS_LENS), "score": 1, "beam": 1}}
    for k in want:
        if got[k] != want[k]:
            failed.append(f"{k}: registry {got[k]} vs the run's {want[k]}")
    # SLO: the live report against one from the recorder's traces
    redo = SLOTracker(SLOConfig(**OBS_SLO), replica=sched.replica,
                      registry=False)
    for tr in traces:
        redo.observe(tr)
    live, again = sched.slo.report(), redo.report()
    for rep in (live, again):
        rep["window"].pop("span_s", None)
    if live != again or live["window"]["requests"] != len(res):
        failed.append(f"SLO report {live} vs recomputed {again}")
    # the flight recorder's dump loads back
    path = sched.flight_recorder.dump(reason="phase 14")
    recs = load_flight_records(path)
    kinds = [r["kind"] for r in recs]
    dump_ok = (kinds.count("reqtrace")
               == len(sched.flight_recorder.requests())
               and kinds.count("snapshot")
               == len(sched.flight_recorder.snapshots())
               and "flightrec" in kinds and "memcensus" in kinds)
    if not dump_ok:
        failed.append(f"flight-recorder dump: {sorted(set(kinds))}")
    # the sampler: one observation every 32 events, each equal to the
    # host formula on the same logits
    n_obs = d("dl4j_serving_sample_entropy")
    every = sched.sample_obs_every
    want_obs = sched._obs_events // every - ev0 // every
    errs = [abs(v - host_entropy(rows)) for rows, v in seen]
    if not (n_obs == want_obs == len(seen) > 0
            and max(errs) <= OBS_SAMPLE_ATOL):
        failed.append(f"sampler: {n_obs} observations ({want_obs} "
                      f"expected, {len(seen)} seen), entropy errors {errs}")
    # the census, and the KV gauge against kv_report()
    census = next(c for c in obs_memory.latest_censuses()
                  if (c["source"], c["replica"])
                  == ("serving", sched.replica))
    params_bytes = sum(t.numel() * t.element_size()
                       for t in tensors(sched.engine.params))
    alloc = reg.get("dl4j_kv_allocated_bytes").value(replica=sched.replica)
    kv = sched.kv_report()
    if census["component_bytes"]["params"] != params_bytes or \
            census["component_bytes"]["kv_cache"] != \
            kvcache.cache_nbytes(sched.cache) or \
            alloc != kv["allocated_bytes"]:
        failed.append(f"census {census['component_bytes']} vs params "
                      f"{params_bytes}; kv gauge {alloc} vs "
                      f"{kv['allocated_bytes']}")
    readings = {"wall_s": wall, **{k: got[k] for k in got},
                "sampler_observations": n_obs,
                "sampler_entropy_max_err": max(errs) if errs else None,
                "slo": {k: live[k] for k in ("goodput", "burn_rate",
                                             "met")},
                "ttft_p50_s": live["ttft"]["p50_s"],
                "itl_p99_s": live["itl"]["p99_s"],
                "dump_records": len(recs),
                "census_params_bytes": params_bytes,
                "kv_allocated_bytes": alloc}
    return readings, failed, launches, obs_values(res)


def obs_way(fa, pa, cfg, params, inp, warm, graphs, tmp):
    """Phase 14 one way (``graphs``: replayed, else eager) on its own
    engine: the paged scheduler with the plane full and at its minimum
    and the dense one likewise, each warmed on two waves of other prompts
    of the same lengths, ``mark_warm()``; the counted wave; the dense
    wave with the plane on (K1); then, replayed, the budget waves (full
    and minimum interleaved, best of 5) and steady sweeps of both."""
    from deeplearning4j_tpu_torch import disable_graphs
    from deeplearning4j_tpu_torch.obs import SLOConfig
    from deeplearning4j_tpu_torch.serving import (
        ContinuousBatchingScheduler, GenerationEngine)
    engine = GenerationEngine(cfg, params)
    counts = StepLaunches({n: st._fn for n, st in engine.sentinels.items()},
                          lambda: serving_counts(fa, pa))
    way = "replayed" if graphs else "eager"
    out = {}
    with contextlib.nullcontext() if graphs else disable_graphs():
        full = ContinuousBatchingScheduler(
            engine, replica=f"obs-{way}", slo=SLOConfig(**OBS_SLO),
            trace_spans=True, crash_dump_path=str(tmp / f"{way}.jsonl"),
            **MAIN_PATHS["paged"])
        bare = ContinuousBatchingScheduler(
            engine, replica=f"obs-{way}-min", trace_spans=False,
            sample_obs_every=0, **MAIN_PATHS["paged"])
        dfull = ContinuousBatchingScheduler(
            engine, replica=f"obs-{way}-dense", slo=SLOConfig(**OBS_SLO),
            trace_spans=True, **MAIN_PATHS["dense"])
        dbare = ContinuousBatchingScheduler(
            engine, replica=f"obs-{way}-dense-min", trace_spans=False,
            sample_obs_every=0, **MAIN_PATHS["dense"])
        for w in warm:
            for s in (full, bare):
                obs_wave(s, w)
            for s in (dfull, dbare):
                obs_dense(s, w["dense"])
        engine.mark_warm()
        out["counted"], out["failed"], out["launches"], out["values"] = \
            obs_counted(fa, pa, full, counts, inp)
        res, _ = obs_wave(bare, inp)
        out["values_min"] = obs_values(res)
        _sync()
        fa.reset_launches()
        pa.reset_launches()
        counts.reset()
        out["dense_tokens"] = obs_dense(dfull, inp["dense"])
        out["dense_launches"] = dict(counts.total)
        out["dense_tokens_min"] = obs_dense(dbare, inp["dense"])
        if graphs:
            waves = []
            for i in range(OBS_WAVES):
                row = {}
                for kind, s in ((("full", full), ("min", bare)) if i % 2 == 0
                                else (("min", bare), ("full", full))):
                    # a full collection before each timed wave, so that
                    # one lands in no wave's self-timed parts (the waves
                    # make a few thousand long-lived objects: spans,
                    # traces, snapshots)
                    gc.collect()
                    c0 = plane_cost(s)
                    _, wall = obs_wave(s, inp)
                    c1 = plane_cost(s)
                    row[kind] = {"wall_s": wall, "cost_s": {
                        k: c1[k] - c0[k] for k in c0}}
                waves.append(row)
            out["waves"] = waves
            sweeps = {"full": [], "min": []}
            for _ in range(3):
                for kind, s in (("full", full), ("min", bare)):
                    sweeps[kind].append(steady_sweeps(s, 600))
            out["sweeps"] = sweeps
        out["compiles"] = compile_summary(engine)
        out["kernel_choice"] = engine._paged_kernel_choice(full.cache)
    del engine, full, bare, dfull, dbare, counts
    gc.collect()
    torch.cuda.empty_cache()
    return out


def obs_plane(fa, pa, smi):
    """Phase 14: the observability plane on phase 4's 120M engine (max_seq
    2048; paged 8 slots, page_len 16; dense 4 slots), replayed and eager,
    every check of the plane held (see the module docstring). Returns the
    replayed way's launch counts by path."""
    import tempfile

    from deeplearning4j_tpu_torch.zoo import transformer as tfm
    cfg, params = main_config(tfm)
    inp = obs_inputs(cfg.vocab_size, 14)
    warm = [obs_inputs(cfg.vocab_size, s) for s in (114, 115)]
    with tempfile.TemporaryDirectory() as tmp:
        ways = {"replayed": obs_way(fa, pa, cfg, params, inp, warm, True,
                                    Path(tmp)),
                "eager": obs_way(fa, pa, cfg, params, inp, warm, False,
                                 Path(tmp))}
    rep, eag = ways["replayed"], ways["eager"]
    failed = []
    for way, w in ways.items():
        failed += [f"{way}: {f}" for f in w["failed"]]
        retr = sum(c[2] for c in w["compiles"].values())
        log(f"obs {way}: counted wave {json.dumps(w['counted'])}; "
            f"launches (captures' counts) paged {json.dumps(w['launches'])}"
            f", dense {json.dumps(w['dense_launches'])}; compile report "
            f"{json.dumps(w['compiles'])}; paged route {w['kernel_choice']}")
        if retr:
            failed.append(f"{way}: {retr} retraces after warm")
        if w["values"] != w["values_min"] or \
                w["dense_tokens"] != w["dense_tokens_min"]:
            failed.append(f"{way}: the plane changed the tokens")
        if w["launches"].get("paged_attention", 0) <= 0 or \
                w["kernel_choice"] != "kernel":
            failed.append(f"{way}: K2 was not launched")
        want_k1 = cfg.n_layers * len(inp["dense"])
        if w["dense_launches"].get("flash_attention_fwd_tc", 0) != want_k1:
            failed.append(f"{way}: dense K1 launches "
                          f"{w['dense_launches']}, want {want_k1}")
    if rep["values"] != eag["values"] or \
            rep["dense_tokens"] != eag["dense_tokens"]:
        failed.append("replayed values differ from eager")
    # the budget: self-timed plane cost over the wave's wall, best of 5
    narrow, wide = [], []
    for row in rep["waves"]:
        c, wall = row["full"]["cost_s"], row["full"]["wall_s"]
        narrow.append((c["trace_overhead"] + c["sentinels"]) / wall)
        wide.append((c["sentinels"] + sum(c[k] for k in (
            "registry", "trace", "spans", "sampler", "slo"))) / wall)
    best = min(range(OBS_WAVES), key=lambda i: narrow[i])
    split = {k: v / rep["waves"][best]["full"]["wall_s"]
             for k, v in rep["waves"][best]["full"]["cost_s"].items()}
    walls = {k: [row[k]["wall_s"] for row in rep["waves"]]
             for k in ("full", "min")}
    sw = {k: [r["wall_ms"] for r in v] for k, v in rep["sweeps"].items()}
    dev = {k: [r["device_ms"] for r in v] for k, v in rep["sweeps"].items()}
    log(f"obs summary ({smi}): plane cost / wave wall (trace_overhead + "
        f"sentinels) by wave {[f'{x:.5f}' for x in narrow]}, best "
        f"{narrow[best]:.5f} (limit {OBS_BUDGET}); with the registry and "
        f"dispatch spans {[f'{x:.5f}' for x in wide]}; best wave's split "
        f"{json.dumps(split)}; wave walls s full {walls['full']} vs "
        f"minimum {walls['min']}; steady sweep wall ms full {sw['full']} "
        f"vs minimum {sw['min']} (device ms {dev['full']} vs "
        f"{dev['min']}); host splits full "
        f"{json.dumps([r['host_split_ms'] for r in rep['sweeps']['full']])}"
        f" vs minimum "
        f"{json.dumps([r['host_split_ms'] for r in rep['sweeps']['min']])}")
    if not narrow[best] < OBS_BUDGET:
        failed.append(f"plane cost {narrow[best]:.5f} of the wave wall")
    if failed:
        raise SystemExit(f"obs plane: {failed}")
    return {"obs_paged": rep["launches"], "obs_dense": rep["dense_launches"]}


# --------------------------------------------------------------- phase 15

# the int8 waves: 8 GENERATE prompts of 40-420 tokens (chunk buckets 32
# and 128), 64 new tokens each, on phase 4's paged geometry
QUANT_LENS = (40, 90, 130, 180, 250, 300, 370, 420)
QUANT_NEW = 64
QUANT_PAGES = 8 * 128                    # phase 4's paged pool (max_seq 2048)
SPEC_NEW = 64
SPEC_K = 4
SPEC_PROMPT = 96


def quant_prompts(vocab, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in QUANT_LENS]


def promotions(kernel):
    """The races counted for ``kernel`` in the process registry."""
    from deeplearning4j_tpu_torch.obs import get_registry
    c = get_registry().get("dl4j_autotune_promotions_total")
    return 0 if c is None else sum(
        c.value(kernel=kernel, verdict=v)
        for v in ("promoted", "fallback_slower", "fallback_fidelity"))


def quant_race_paged(pa, cfg, params):
    """(a) The paged promotion race at phase 4's geometry, then a second
    engine's ``decide`` of the same geometry."""
    from deeplearning4j_tpu_torch.kernels import autotune
    from deeplearning4j_tpu_torch.serving import GenerationEngine
    engine = GenerationEngine(cfg, params)
    cache = engine.init_paged_cache(8, QUANT_PAGES, 16)
    races0 = promotions("paged_decode")
    pa.reset_launches()
    t0 = time.perf_counter()
    choice = pa.decide(engine, cache, mode="race")
    race_s = time.perf_counter() - t0
    k2 = pa.LAUNCHES
    rec = autotune.lookup(pa.bucket_key(cfg, cache), sha=pa.kernel_sha())
    races1 = promotions("paged_decode")
    del engine
    again = pa.decide(GenerationEngine(cfg, params), cache, mode="race")
    out = {"choice": choice, "again": again, "race_s": race_s,
           "k2_launches": k2, "races": races1 - races0,
           "races_after_second": promotions("paged_decode") - races1,
           "record": rec}
    failed = []
    meta = (rec or {}).get("meta") or {}
    fid = meta.get("fidelity", {})
    if rec is None or meta.get("verdict") == "fallback_fidelity":
        failed.append(f"paged race verdict {meta.get('verdict')}")
    if not fid.get("kl_max", 1.0) <= MAX_KL or \
            fid.get("greedy_match_frac") != 1.0:
        failed.append(f"paged race fidelity {fid}")
    if k2 <= 0:
        failed.append("the paged race launched no K2")
    if out["races"] != 1 or out["races_after_second"] != 0 \
            or again != choice:
        failed.append(f"races {out['races']} then "
                      f"{out['races_after_second']}, choices {choice} / "
                      f"{again}")
    return out, failed


def check_int8_writes(cfg, params):
    """(b) The int8 rows and scales an eager prefill (200 tokens, two
    chunks) and 4 decode steps write into a fresh engine's int8 pool,
    read back at their (page, offset), against ``quantize_rows`` of the
    bf16 rows the engine quantized (recorded at the call), recomputed on
    the card: equal code for code, every layer, k and v."""
    from deeplearning4j_tpu_torch import disable_graphs
    from deeplearning4j_tpu_torch.serving import (GenerationEngine,
                                                  PageTable, quant)
    engine = GenerationEngine(cfg, params, quant_kv="on")
    plen, n = 16, 200
    cache = engine.init_paged_cache(1, 32, plen)
    table = PageTable.for_cache(cache)
    table.map(0, n + 4)
    table.sync(cache)
    prompt = np.random.default_rng(15).integers(
        0, cfg.vocab_size, n).astype(np.int32)
    seen, orig = [], quant.quantize_rows

    def recording(rows):
        q, sc = orig(rows)
        seen.append((rows.clone(), q.clone(), sc.clone()))
        return q, sc

    positions = []
    quant.quantize_rows = recording
    try:
        with disable_graphs():
            for start in range(0, n, engine.chunk_len):
                m = min(engine.chunk_len, n - start)
                engine.prefill_chunk(cache, prompt[start:start + m], 0,
                                     start)
                positions.append(list(range(start, start + m)))
            tok = [int(prompt[-1])]
            for i in range(4):
                engine.decode_step(cache, tok)
                positions.append([n + i])
    finally:
        quant.quantize_rows = orig
    _sync()
    layers = cfg.n_layers
    if len(seen) != 2 * layers * len(positions):
        raise SystemExit(f"int8 writes: {len(seen)} quantizations, want "
                         f"{2 * layers * len(positions)}")
    codes = bad = 0
    row = table.table[0]
    for d, pos in enumerate(positions):
        dev = cache["k"].device
        pages = torch.tensor([int(row[p // plen]) for p in pos], device=dev)
        offs = torch.tensor([p % plen for p in pos], device=dev)
        for layer in range(layers):
            for j, name in enumerate(("k", "v")):
                rows, q, sc = seen[(d * layers + layer) * 2 + j]
                q2, s2 = orig(rows)
                m = len(pos)
                got_q = cache[name][layer][pages, offs]
                got_s = cache[name + "_scale"][layer][pages, offs]
                ok = (torch.equal(q2, q) and torch.equal(s2, sc)
                      and torch.equal(got_q, q2[:m])
                      and torch.equal(got_s, s2[:m]))
                codes += got_q.numel()
                bad += 0 if ok else 1
    return {"codes": codes, "bad_writes": bad,
            "rows_dtype": str(seen[0][0].dtype)[6:]}


def quant_waves(fa, pa, cfg, params):
    """(b) int8 KV: one engine, the int8 scheduler and a bf16 one, each
    warmed on other prompts of the same lengths, ``mark_warm()``, then a
    counted replayed wave of each; ``race_kv`` first, on the same
    engine."""
    from deeplearning4j_tpu_torch.serving import (ContinuousBatchingScheduler,
                                                  GenerationEngine, kvcache,
                                                  quant)
    engine = GenerationEngine(cfg, params)
    counts = StepLaunches({n: st._fn for n, st in engine.sentinels.items()},
                          lambda: serving_counts(fa, pa))
    pa.reset_launches()
    race = quant.race_kv(engine, 8, QUANT_PAGES, 16)
    race["k2_launches"] = pa.LAUNCHES
    scheds = {mode: ContinuousBatchingScheduler(
        engine, n_slots=8, page_len=16, quant_kv=mode)
        for mode in ("on", "off")}
    for seed in (151, 152):
        for sched in scheds.values():
            serve(sched, quant_prompts(cfg.vocab_size, seed), QUANT_NEW)
    engine.mark_warm()
    prompts = quant_prompts(cfg.vocab_size, 15)
    out = {"race_kv": race}
    for mode, sched in scheds.items():
        _sync()
        fa.reset_launches()
        pa.reset_launches()
        counts.reset()
        res, tokens = serve(sched, prompts, QUANT_NEW)
        out[mode] = {"wave": res, "launches": dict(counts.total),
                     "dtype": sched.kv_report()["kv_dtype"],
                     "token_bytes": kvcache.token_nbytes(sched.cache),
                     "tokens": tokens}
    out["compiles"] = compile_summary(engine)
    del engine, scheds, counts
    gc.collect()
    torch.cuda.empty_cache()
    return out


def quant_weights_wave(fa, pa, cfg, params):
    """(c) int8 weights: ``race_weights``, then the wave of (b) on a bf16
    pool with ``quant_weights="on"``, warmed the same way."""
    from deeplearning4j_tpu_torch.serving import (ContinuousBatchingScheduler,
                                                  GenerationEngine, quant)
    engine = GenerationEngine(cfg, params, quant_weights="on")
    counts = StepLaunches({n: st._fn for n, st in engine.sentinels.items()},
                          lambda: serving_counts(fa, pa))
    race = quant.race_weights(engine)
    sched = ContinuousBatchingScheduler(engine, n_slots=8, page_len=16)
    for seed in (151, 152):
        serve(sched, quant_prompts(cfg.vocab_size, seed), QUANT_NEW)
    engine.mark_warm()
    _sync()
    fa.reset_launches()
    pa.reset_launches()
    counts.reset()
    res, _ = serve(sched, quant_prompts(cfg.vocab_size, 15), QUANT_NEW)
    out = {"race": race, "wave": res, "launches": dict(counts.total),
           "weights": engine._decode_params(),
           "compiles": compile_summary(engine)}
    del engine, sched, counts
    gc.collect()
    torch.cuda.empty_cache()
    return out


def spec_races(tfm, cfg, params):
    """(d) ``race_spec`` of the bf16 LM and of the same LM in f32, each
    with a 2-layer ``EngineDraft`` and an ``NgramDraft``."""
    from deeplearning4j_tpu_torch.serving import (EngineDraft,
                                                  GenerationEngine,
                                                  NgramDraft, spec)
    prompt = np.random.default_rng(16).integers(
        0, cfg.vocab_size, SPEC_PROMPT).astype(np.int32)
    out = {}
    for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        c = dataclasses.replace(cfg, dtype=dt)
        engine = GenerationEngine(c, params)
        dcfg, dparams = tfm.draft_params(params, c, n_layers=2)
        drafts = {"engine": EngineDraft(GenerationEngine(dcfg, dparams)),
                  "ngram": NgramDraft(3)}
        t0 = time.perf_counter()
        res = spec.race_spec(engine, drafts, prompt, SPEC_NEW, k=SPEC_K)
        res["host_s"] = time.perf_counter() - t0
        out[tag] = res
        del engine, drafts
        gc.collect()
        torch.cuda.empty_cache()
    return out


def knob_sweep(cfg, params):
    """(e) The serving-knob sweep over short candidate lists, read
    back."""
    from deeplearning4j_tpu_torch.serving import GenerationEngine, tune
    engine = GenerationEngine(cfg, params)
    t0 = time.perf_counter()
    knobs = tune.sweep_serving_knobs(engine, prompt_len=256,
                                     page_lens=(16, 32),
                                     prefill_chunks=(64, 128),
                                     decode_slots=(4, 8))
    host_s = time.perf_counter() - t0
    recs = tune.recommended_serving_knobs(cfg)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return knobs, recs, host_s


def quant_spec_plane(fa, pa, smi):
    """Phase 15: the quantization and speculation plane on phase 4's 120M
    engine (see the module docstring), in a fresh temporary autotune
    store. Returns the counted waves' launch counts by path."""
    import tempfile

    from deeplearning4j_tpu_torch.kernels import autotune
    from deeplearning4j_tpu_torch.zoo import transformer as tfm
    cfg, params = main_config(tfm)
    saved = autotune._CACHE_PATH
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        autotune._CACHE_PATH = Path(tmp) / "autotune.json"
        autotune._memory_cache.clear()
        try:
            t0 = time.perf_counter()
            paged, f = quant_race_paged(pa, cfg, params)
            failed += f
            t_a = time.perf_counter()
            writes = check_int8_writes(cfg, params)
            waves = quant_waves(fa, pa, cfg, params)
            t_b = time.perf_counter()
            wq = quant_weights_wave(fa, pa, cfg, params)
            t_c = time.perf_counter()
            races = spec_races(tfm, cfg, params)
            t_d = time.perf_counter()
            knobs, recs, sweep_s = knob_sweep(cfg, params)
            t_e = time.perf_counter()
        finally:
            autotune._CACHE_PATH = saved
            autotune._memory_cache.clear()
    meta = paged["record"]["meta"]
    log(f"quant (a) paged race ({smi}): verdict {meta['verdict']}, choice "
        f"{paged['choice']}, gather {meta['gather_s'] * 1e3:.4f} ms vs K2 "
        f"{meta['kernel_s'] * 1e3:.4f} ms a decode step (speedup "
        f"{meta['speedup']}), fidelity {json.dumps(meta['fidelity'])}; K2 "
        f"launches {paged['k2_launches']}; races {paged['races']}, then "
        f"{paged['races_after_second']} for a second engine (its choice "
        f"{paged['again']}); {paged['race_s']:.2f} s")
    rk = waves["race_kv"]
    log(f"quant (b) race_kv: verdict {rk['verdict']}, arms {rk['arms']}: "
        f"bf16 {rk['bf16_s'] * 1e3:.4f} ms vs int8 {rk['int8_s'] * 1e3:.4f}"
        f" ms a decode step (speedup {rk['speedup']}), kl_max "
        f"{rk['fidelity']['kl_max']:.3e}, greedy "
        f"{rk['fidelity']['greedy_match_frac']}, bytes a token "
        f"{json.dumps(rk['bytes_per_token'])}; K2 launches "
        f"{rk['k2_launches']}; int8 writes {json.dumps(writes)}")
    for mode in ("on", "off"):
        w = waves[mode]
        log(f"quant (b) wave quant_kv={mode} ({w['dtype']}, "
            f"{w['token_bytes']} B a token): {json.dumps(w['wave'])}; "
            f"launches {json.dumps(w['launches'])}")
    log(f"quant (b) compile report {json.dumps(waves['compiles'])}")
    rw = wq["race"]
    log(f"quant (c) race_weights: verdict {rw['verdict']}: bf16 "
        f"{rw['bf16_s'] * 1e3:.4f} ms vs int8 {rw['int8_s'] * 1e3:.4f} ms "
        f"a dense decode step (speedup {rw['speedup']}), kl_max "
        f"{rw['fidelity']['kl_max']:.3e}; wave with int8 weights "
        f"({wq['weights']}): {json.dumps(wq['wave'])}; launches "
        f"{json.dumps(wq['launches'])}; compile report "
        f"{json.dumps(wq['compiles'])}")
    for tag, res in races.items():
        log(f"quant (d) race_spec {tag}: choice {res['choice']}, plain "
            f"{res['base_s']:.4f} s for {res['tokens']} tokens; " + "; ".join(
                f"{name} {a['verdict']} {a['spec_s']:.4f} s (speedup "
                f"{a['speedup']}, accepted a step {a['accepted_per_step']}"
                f", identical {a['bit_identical']}, {json.dumps(a['stats'])})"
                for name, a in res["arms"].items())
            + f"; {res['host_s']:.1f} s")
    log(f"quant (e) serving knobs {json.dumps(knobs)} in {sweep_s:.1f} s; "
        f"records read back " + json.dumps(
            {k: {"choice": r["choice"], "best_s": r["meta"]["best_s"],
                 "measurements": r["meta"]["measurements"]}
             for k, r in recs.items()}))
    log(f"quant host seconds: (a) {t_a - t0:.1f}, (b) {t_b - t_a:.1f}, "
        f"(c) {t_c - t_b:.1f}, (d) {t_d - t_c:.1f}, (e) {t_e - t_d:.1f}")
    # the holds of (b)-(e)
    if writes["bad_writes"] or writes["codes"] <= 0:
        failed.append(f"int8 writes {writes}")
    for name, comp in (("int8 KV", waves["compiles"]),
                       ("int8 weights", wq["compiles"])):
        retr = sum(c[2] for c in comp.values())
        if retr:
            failed.append(f"{name}: {retr} retraces after warm")
    if waves["on"]["dtype"] != "int8" or waves["off"]["dtype"] == "int8":
        failed.append("the pools' dtypes")
    if waves["on"]["launches"].get("paged_attention", 0) != 0:
        failed.append(f"K2 launched on the int8 wave: "
                      f"{waves['on']['launches']}")
    if waves["off"]["launches"].get("paged_attention", 0) <= 0 or \
            rk["k2_launches"] <= 0:
        failed.append("K2 not launched on the bf16 arm")
    if (waves["on"]["token_bytes"], waves["off"]["token_bytes"]) != \
            (8704, 16384):
        failed.append("bytes a token")
    if wq["weights"] != "int8" or \
            wq["launches"].get("paged_attention", 0) <= 0:
        failed.append(f"int8-weights wave: {wq['weights']}, "
                      f"{wq['launches']}")
    if not all(a["bit_identical"] for a in races["f32"]["arms"].values()):
        failed.append("f32 speculation differs from plain_generate")
    kinds = {k.split(":")[0]: r["choice"] for k, r in recs.items()}
    if kinds != {"serving_page_len": [knobs["page_len"]],
                 "serving_prefill_chunk": [knobs["prefill_chunk"]],
                 "serving_decode_slots": [knobs["decode_slots"]]}:
        failed.append(f"knob records {kinds} vs {knobs}")
    if failed:
        raise SystemExit(f"quant/spec plane: {failed}")
    return {"quant_int8_kv": waves["on"]["launches"],
            "quant_bf16_kv": waves["off"]["launches"],
            "quant_int8_weights": wq["launches"]}


# --------------------------------------------------------------- phase 16

# BERT-base at bench.py's bert row (bench.py:519-531, batch 128 at :2152):
# T 128, remat "full", bf16 scores; fine-tuned with AdamW(2e-5) mapped from
# optax as make_train_step's docstring says (LM_ADAMW, capturable)
BERT_BATCH = 128
BERT_T = 128
BERT_FT_STEPS = 10                       # eager, capture, 8 replays
BERT_FT_WARM = 3                         # not timed: eager, capture, replay
BERT_MLM_EPOCHS = 2                      # 4 BertIterator batches each
BERT_MLM_SENTENCES = 512
# bench.py's serving rows (bench.py:2015, :2049, :2074): batch-1 latency
# then a batch sweep, through ParallelInference(max_batch=64)
SERVE_LAT_ITERS = 200
SERVE_SWEEP_ITERS = 5
BERT_SERVE_BATCHES = (1, 8, 16)
RESNET_SERVE_BATCHES = (1, 8, 32)
SERVE_BURST = 8                          # one-row requests, one deadline
SERVE_BURST_WAIT_MS = 20.0
# the corpus BertIterator reads and the words of its WordPiece vocabulary
BERT_WORDS = ("the quick brown fox jump over lazy dog a cat sat on mat "
              "river bank money water tree light dark day night sun moon "
              "star sky sea ship sail wind rain snow cold warm city road "
              "car train walk run read write book page word line story "
              "old new big small red blue green house door window").split()
BERT_SUFFIXES = ("##s", "##ing", "##ed")


def bert_vocab():
    """BERT's five special tokens, the corpus words and their suffixes,
    padded with unused entries to BERT-base's 30522 rows."""
    toks = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *BERT_WORDS,
            *BERT_SUFFIXES, ",", "."]
    return toks + [f"[unused{i}]" for i in range(30522 - len(toks))]


def bert_corpus(n, seed=0):
    """``n`` sentences of 8-120 words drawn from ``BERT_WORDS`` (some
    with a suffix, some past T 128, so that BertIterator pads and
    truncates)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        words = [BERT_WORDS[i] + ("" if rng.random() < 0.8 else
                                  rng.choice(["s", "ing", "ed"]))
                 for i in rng.integers(0, len(BERT_WORDS),
                                       rng.integers(8, 121))]
        out.append(" ".join(words) + ".")
    return out


def bert_setup(tfm, seed=0, **kw):
    """BERT-base (bench.py's row unless ``kw`` says otherwise) with seeded
    random weights on the card; the zero classification head gets small
    seeded values, so that the logits it serves carry the encoder."""
    cfg = tfm.BertConfig(max_seq=BERT_T, **kw)
    gen = torch.Generator().manual_seed(seed)
    params = tfm.bert_init(cfg, gen, device="cuda")
    with torch.no_grad():
        params["cls"].copy_(0.02 * torch.randn(params["cls"].shape,
                                               generator=gen))
    return cfg, params


def _clone_params(params):
    return {k: (_clone_params(v) if isinstance(v, dict)
                else v.detach().clone()) for k, v in params.items()}


def _adamw(tfm, params, lr):
    return torch.optim.AdamW(tfm.param_leaves(params), lr=lr,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4, capturable=True, **LM_ADAMW)


def bert_finetune_step(tfm, cfg, params, opt):
    """bench.py's build_bert step on the port: ``bert_classifier_loss``,
    its backward and AdamW, compiled as the port's steps are (a CUDA
    graph per signature after an eager first call)."""
    from deeplearning4j_tpu_torch.nn._compiled import CompiledStep, tensors

    def static_step(ids, labels):
        opt.zero_grad(set_to_none=True)
        loss = tfm.bert_classifier_loss(params, cfg, ids, labels)
        loss.backward()
        opt.step()
        return loss.detach()

    def bindings():
        groups = opt.param_groups
        return [*tensors(params), *(p for g in groups for p in g["params"]),
                *tensors(list(opt.state.values())),
                *(g[k] for g in groups for k in sorted(g) if k != "params")]

    return CompiledStep(static_step, bindings, "bert_finetune_step")


def _launched(counts):
    """The kernels of ``counts`` that launched, with their counts."""
    return {k: v for k, v in counts.items() if v}


def bert_finetune(mods):
    """Phase 16 (a): the fine-tune, replayed (the main path) and eager
    from identical params on one fixed batch; bit for bit equal, finite,
    falling, no hand-written kernel launched."""
    from deeplearning4j_tpu_torch import disable_graphs
    from deeplearning4j_tpu_torch.zoo import transformer as tfm

    cfg, init = bert_setup(tfm, remat=True, attn_scores_bf16=True)
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                       (BERT_BATCH, BERT_T)), device="cuda")
    labels = torch.as_tensor(rng.integers(0, cfg.num_labels, BERT_BATCH),
                             device="cuda")
    runs, counts = {}, None
    for way, graphs in (("replayed", True), ("eager", False)):
        params = _clone_params(init)
        step = bert_finetune_step(tfm, cfg, params,
                                  _adamw(tfm, params, 2e-5))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if graphs:
            reset_all(*mods)
        losses, secs, kinds = [], [], []
        with contextlib.nullcontext() if graphs else disable_graphs():
            for _ in range(BERT_FT_STEPS):
                t0 = time.perf_counter()
                loss = step(ids, labels)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                losses.append(loss.item())
                kinds.append(step.last)
            if graphs:
                counts = all_counts(*mods)
            peak = torch.cuda.max_memory_allocated() / 2**30
            final = [(n, p.detach().clone())
                     for n, p in _named_leaves(params)]
            prof = profile_step(lambda: step(ids, labels))
        timed = list(range(BERT_FT_WARM, BERT_FT_STEPS))
        wall = float(np.median([secs[i] for i in timed]))
        rec = {"losses": losses, "step_kinds": kinds,
               "timed_steps": [i + 1 for i in timed],
               "wall_ms_per_step": wall * 1e3, "steps_per_s": 1 / wall,
               "seq_per_s": BERT_BATCH / wall,
               "tok_per_s": BERT_BATCH * BERT_T / wall,
               "peak_alloc_gib": peak}
        add_profile(rec, prof)
        rec["top_kernels"] = prof["top_kernels"][:6]
        log(f"bert fine-tune {way} (BERT-base B{BERT_BATCH} T{BERT_T} bf16, "
            f"remat full, bf16 scores, AdamW 2e-5, "
            f"{'graph replays' if graphs else 'eager'}): {json.dumps(rec)}")
        runs[way] = (rec, final)
        del params, step
        torch.cuda.empty_cache()
    (rr, rf), (er, ef) = runs["replayed"], runs["eager"]
    diff = first_diff(ef, rf)
    failed = []
    if rr["step_kinds"] != ["eager", "capture",
                            *["replay"] * (BERT_FT_STEPS - 2)]:
        failed.append(f"steps {rr['step_kinds']} did not replay a graph")
    if rr["losses"] != er["losses"] or diff is not None:
        failed.append(f"replayed differ from eager (losses equal "
                      f"{rr['losses'] == er['losses']}, first differing "
                      f"leaf {diff})")
    for way, (r, _) in runs.items():
        if not (all(np.isfinite(r["losses"]))
                and r["losses"][-1] < r["losses"][0]):
            failed.append(f"{way}: loss not finite or not falling")
    if _launched(counts):
        failed.append(f"hand-written kernels launched: {counts}")
    log(f"bert fine-tune replayed vs eager: losses equal "
        f"{rr['losses'] == er['losses']}, params and AdamW state "
        f"bit-identical {diff is None}; wall ms a step {rr['wall_ms_per_step']:.2f} "
        f"vs {er['wall_ms_per_step']:.2f}; launches {json.dumps(counts)}")
    if failed:
        raise SystemExit(f"bert fine-tune: {failed}")
    return counts


def bert_mlm(mods):
    """Phase 16 (b): MLM pretraining from ``BertIterator`` batches of an
    in-script corpus (special ids and the attention mask fed), replayed
    (the main path) and eager from identical params and generator
    state: bit for bit equal; two replays on the same batch drew
    different masks."""
    from deeplearning4j_tpu_torch import disable_graphs
    from deeplearning4j_tpu_torch.nlp import BertIterator, \
        BertWordPieceTokenizer
    from deeplearning4j_tpu_torch.zoo import transformer as tfm

    tok = BertWordPieceTokenizer(bert_vocab())
    it = BertIterator(tok, bert_corpus(BERT_MLM_SENTENCES),
                      task=BertIterator.UNSUPERVISED, max_length=BERT_T,
                      batch_size=BERT_BATCH, drop_last=True)
    batches = [b for b in it]
    cfg, init = bert_setup(tfm, seed=1, remat=True, attn_scores_bf16=True)
    feed = [tuple(torch.as_tensor(a, device="cuda") for a in
                  (b.features[0], b.features[1], b.features_masks[0]))
            for b in batches] * BERT_MLM_EPOCHS
    runs, counts = {}, None
    for way, graphs in (("replayed", True), ("eager", False)):
        params = _clone_params(init)
        gen = torch.Generator(device="cuda").manual_seed(7)
        step = tfm.make_bert_mlm_train_step(
            cfg, _adamw(tfm, params, 1e-4), it.mask_id,
            special_ids=it.special_ids, generator=gen)
        if graphs:
            reset_all(*mods)
        losses, secs, kinds, states = [], [], [], []
        with contextlib.nullcontext() if graphs else disable_graphs():
            for ids, type_ids, mask in feed:
                states.append(gen.get_state())
                t0 = time.perf_counter()
                loss = step(params, ids, type_ids, mask)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                losses.append(loss.item())
                kinds.append(step.compiled.last)
            if graphs:
                counts = all_counts(*mods)
            final = [(n, p.detach().clone())
                     for n, p in _named_leaves(params)]
            end_state = gen.get_state()
            prof = profile_step(lambda: step(params, *feed[0]))
        timed = [i for i, k in enumerate(kinds) if k == "replay"] or \
            list(range(1, len(kinds)))
        wall = float(np.median([secs[i] for i in timed]))
        rec = {"losses": losses, "step_kinds": kinds,
               "wall_ms_per_step": wall * 1e3, "steps_per_s": 1 / wall,
               "seq_per_s": BERT_BATCH / wall,
               "live_tokens_per_batch": [int(b.features_masks[0].sum())
                                         for b in batches]}
        add_profile(rec, prof)
        rec["top_kernels"] = prof["top_kernels"][:6]
        log(f"bert MLM pretrain {way} (BERT-base, {len(batches)} "
            f"BertIterator batches of B{BERT_BATCH} T{BERT_T} x "
            f"{BERT_MLM_EPOCHS} epochs, AdamW 1e-4, "
            f"{'graph replays' if graphs else 'eager'}): {json.dumps(rec)}")
        runs[way] = (rec, final, states, end_state)
        del params, step
        torch.cuda.empty_cache()
    (rr, rf, _, rgen), (er, ef, states, egen) = runs["replayed"], \
        runs["eager"]
    diff = first_diff(ef, rf)
    # the masks the replays at steps i and i + n_batches drew on the same
    # batch, from the generator states the eager run recorded there (the
    # same states, as the trajectories are equal)
    n = len(batches)
    i = next(k for k, kind in enumerate(rr["step_kinds"])
             if kind == "replay" and k + n < len(feed))
    specials = torch.tensor(it.special_ids, device="cuda")
    weights = []
    for k in (i, i + n):
        g = torch.Generator(device="cuda")
        g.set_state(states[k])
        ids = feed[k][0]
        _, _, w = tfm.bert_mask_tokens(g, ids, cfg, it.mask_id,
                                       special_mask=torch.isin(ids, specials))
        weights.append(w)
    masks_differ = not torch.equal(weights[0], weights[1])
    specials_kept = all(float((w * torch.isin(feed[i][0], specials)).sum())
                        == 0.0 for w in weights)
    failed = []
    if rr["losses"] != er["losses"] or diff is not None:
        failed.append(f"replayed differ from eager (losses equal "
                      f"{rr['losses'] == er['losses']}, first differing "
                      f"leaf {diff})")
    if rr["step_kinds"][:3] != ["eager", "capture", "replay"]:
        failed.append(f"steps {rr['step_kinds']} did not replay a graph")
    if not all(np.isfinite(rr["losses"])):
        failed.append("non-finite loss")
    if not masks_differ or not specials_kept:
        failed.append(f"replays {i + 1} and {i + n + 1} on one batch: masks "
                      f"differ {masks_differ}, specials never selected "
                      f"{specials_kept}")
    if _launched(counts):
        failed.append(f"hand-written kernels launched: {counts}")
    log(f"bert MLM replayed vs eager: losses equal "
        f"{rr['losses'] == er['losses']}, params bit-identical "
        f"{diff is None}, generator state equal "
        f"{torch.equal(rgen, egen)} (read, not held); replays {i + 1} and "
        f"{i + n + 1} on batch {i % n}: masks differ {masks_differ} "
        f"({int(weights[0].sum())} and {int(weights[1].sum())} selected), "
        f"specials never selected {specials_kept}; launches "
        f"{json.dumps(counts)}")
    if failed:
        raise SystemExit(f"bert MLM: {failed}")
    return counts


class _Served:
    """The calls of one ``ParallelInference``: each call's kind and its
    hand-written kernels' launches (a replay at its signature's
    capture's), and the K3 cases it handed the wrappers."""

    def __init__(self, pi, counts):
        self.pi, self.counts = pi, counts
        self.captured, self.per_call = {}, []

    def __call__(self, x):
        before = self.counts()
        out = self.pi.output(x)
        kind = self.pi._infer.last
        sig = (tuple(x.shape), str(x.dtype))
        d = {k: v - before[k] for k, v in self.counts().items()}
        if kind == "capture":
            self.captured[sig] = d
        self.per_call.append(self.captured[sig] if kind == "replay" else d)
        return out

    def total(self):
        return {k: sum(c[k] for c in self.per_call) for k in self.counts()}


def served_kernels(fn, iters=10):
    """The device launches of one ``fn`` call (kernels and copies, from a
    ``torch.profiler`` trace of ``iters`` calls), their mean device µs,
    and the five kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = sorted(((_self_device_us(ev), ev.count, ev.key)
                       for ev in prof.key_averages()
                       if ev.device_type == torch.autograd.DeviceType.CUDA
                       and ev.count), reverse=True)
        if rows:
            break
        log(f"served_kernels: trace {attempt} of {PROFILE_TRIES} holds no "
            "device event")
    else:
        return {"launches_per_call": None, "mean_us_per_launch": None,
                "top": [], "not_traced": f"{PROFILE_TRIES} traces held no "
                                         "device event"}
    n = sum(r[1] for r in rows) / iters
    return {"launches_per_call": n,
            "mean_us_per_launch": sum(r[0] for r in rows) / iters / n,
            "top": [{"name": k[:60], "us_per_call": us / iters,
                     "calls_per_call": c / iters}
                    for us, c, k in rows[:5]]}


def serve_sweep(served, make_batch, batches, tag):
    """bench.py's ``_latency_sweep`` on the port: every batch size warmed
    (eager, capture, replay) and ``mark_warm()``; batch-1 p50 and p99 over
    ``SERVE_LAT_ITERS`` calls, each the wall of ``output()`` and the read
    of its result to the host; per batch size the samples/s of the best
    of ``SERVE_SWEEP_ITERS``; the batch-1 split: dispatch (``output()``
    returning), device ms (``torch.profiler``), busy share; retraces after
    warm."""
    from deeplearning4j_tpu_torch.obs import CompileSentinel

    pi = served.pi
    sentinel = CompileSentinel(f"serve_{tag}", pi._infer or pi._build())
    xs = {b: make_batch(b) for b in batches}
    for b in batches:
        for _ in range(3):
            served(xs[b]).cpu()
    sentinel.mark_warm()
    lat, disp = [], []
    for _ in range(SERVE_LAT_ITERS):
        t0 = time.perf_counter()
        out = served(xs[1])
        t1 = time.perf_counter()
        out.cpu()
        lat.append(time.perf_counter() - t1 + (t1 - t0))
        disp.append(t1 - t0)
    lat.sort()
    p50 = lat[len(lat) // 2]
    p99 = lat[min(len(lat) - 1, int(round(0.99 * (len(lat) - 1))))]
    sweep = {}
    for b in batches:
        times = []
        for _ in range(SERVE_SWEEP_ITERS):
            t0 = time.perf_counter()
            served(xs[b]).cpu()
            times.append(time.perf_counter() - t0)
        sweep[str(b)] = b / min(times)
    dev = device_ms(lambda: served(xs[1]), iters=20)
    kernels = served_kernels(lambda: served(xs[1]))
    return {"p50_ms": p50 * 1e3, "p99_ms": p99 * 1e3,
            "iters": SERVE_LAT_ITERS,
            "batch_sweep_samples_per_s": sweep,
            "b1_dispatch_ms_p50": float(np.median(disp)) * 1e3,
            "b1_device_ms": dev, "b1_busy_share": dev / (p50 * 1e3),
            "b1_kernels": kernels,
            "captures": pi._infer.calls["capture"],
            "calls": dict(pi._infer.calls),
            "retraces_after_warm": sentinel.retraces_after_warm}, xs


def bert_serve(mods):
    """Phase 16 (c): BERT-base served through ``FunctionalInferenceModel``
    + ``ParallelInference`` (bench.py:2074-2101: the default bf16 config,
    no mask): latency and the batch sweep, the served logits equal to an
    eager forward's and within MAX_KL of the f32 forward's, then a burst
    of one-row submits that one deadline flush resolves."""
    from deeplearning4j_tpu_torch.obs import get_registry
    from deeplearning4j_tpu_torch.parallel import ParallelInference
    from deeplearning4j_tpu_torch.serving import FunctionalInferenceModel
    from deeplearning4j_tpu_torch.zoo import transformer as tfm

    cfg, params = bert_setup(tfm, seed=2)
    model = FunctionalInferenceModel(
        params, lambda p, ids: tfm.bert_forward(p, cfg, ids)[0])
    rng = np.random.default_rng(0)

    def make_batch(b):
        return rng.integers(0, cfg.vocab_size, (b, BERT_T)).astype(np.int32)

    reset_all(*mods)
    pi = ParallelInference(model, max_batch=64)
    served = _Served(pi, lambda: all_counts(*mods))
    rec, xs = serve_sweep(served, make_batch, BERT_SERVE_BATCHES, "bert")
    # the deadline flush: one-row requests of a warmed signature
    pi2 = ParallelInference(model, max_batch=64,
                            max_wait_ms=SERVE_BURST_WAIT_MS)
    burst = make_batch(SERVE_BURST)
    for _ in range(3):
        pi2.output(burst).cpu()
    captures = pi2._infer.calls["capture"]
    reg = get_registry()
    before = {n: (reg.get(n).value() if reg.get(n) else 0.0) for n in (
        "dl4j_inference_deadline_flushes_total",
        "dl4j_inference_batches_total")}
    t0 = time.perf_counter()
    futs = [pi2.submit(burst[i:i + 1]) for i in range(SERVE_BURST)]
    parts = [f.result(timeout=60).cpu() for f in futs]
    burst_s = time.perf_counter() - t0
    flushes = {n: reg.get(n).value() - v for n, v in before.items()}
    burst_ok = (torch.equal(torch.cat(parts), pi2.output(burst).cpu())
                and pi2._infer.calls["capture"] == captures
                and all(v == 1 for v in flushes.values()))
    counts = served.total()
    x8 = torch.as_tensor(xs[8], device="cuda")
    served_out = pi.output(xs[8])
    eager = tfm.bert_forward(params, cfg, x8)[0]
    f32 = tfm.bert_forward(params, dataclasses.replace(
        cfg, dtype=torch.float32), x8)[0]
    kl = kl_rows(f32, served_out).max().item()
    equal = torch.equal(served_out, eager)
    rec.update({"burst": {"requests": SERVE_BURST,
                          "max_wait_ms": SERVE_BURST_WAIT_MS,
                          "resolved_s": burst_s, "flushes": flushes,
                          "ok": burst_ok},
                "served_equals_eager_forward": equal,
                "kl_vs_f32_forward_max": kl, "launches": counts})
    log(f"bert served (BERT-base T{BERT_T} bf16 through "
        f"FunctionalInferenceModel + ParallelInference(max_batch=64)): "
        f"{json.dumps(rec)}")
    failed = []
    if not equal or not kl <= MAX_KL:
        failed.append(f"served logits: equal to the eager forward {equal}, "
                      f"KL vs f32 {kl:.3e} (limit {MAX_KL})")
    if not burst_ok:
        failed.append("the burst was not resolved by one deadline flush "
                      "of its captured signature")
    if rec["retraces_after_warm"] or rec["captures"] != len(
            BERT_SERVE_BATCHES):
        failed.append(f"captures {rec['captures']}, retraces after warm "
                      f"{rec['retraces_after_warm']}")
    if _launched(counts):
        failed.append(f"hand-written kernels launched: {counts}")
    if failed:
        raise SystemExit(f"bert serving: {failed}")
    return counts, rec


def resnet_serve(mods, fo, checked, gen):
    """Phase 16 (d): ResNet-50 bf16 served through ``ParallelInference``
    (bench.py:2049-2071): latency and the sweep at batch 1, 8 and 32, the
    served rows equal to ``net.output()``'s, K3's normalize launched 33
    times a batch, every K3 shape it ran held against the plain version
    (here, where phase 7 did not hold it)."""
    from deeplearning4j_tpu_torch.parallel import ParallelInference
    from deeplearning4j_tpu_torch.zoo.resnet import ResNet50

    net = ResNet50(num_classes=1000, compute_dtype=torch.bfloat16).init()
    rng = np.random.default_rng(0)

    def make_batch(b):
        return rng.random((b, RESNET_HW, RESNET_HW, 3), np.float32)

    reset_all(*mods)
    pi = ParallelInference(net, max_batch=64)
    served = _Served(pi, lambda: all_counts(*mods))
    with _k3_cases(fo) as cases:
        rec, xs = serve_sweep(served, make_batch, RESNET_SERVE_BATCHES,
                              "resnet50")
    counts = served.total()
    per_call = {"bn_act": 33, "bn_stats": 0, "bn_bwd_reduce": 0,
                "bn_bwd_dx": 0}
    calls_ok = all(_launched(c) == {"bn_act": 33}
                   for c in served.per_call)
    equal = {}
    for b in RESNET_SERVE_BATCHES:
        out = pi.output(xs[b])
        want = net.output(xs[b])
        equal[b] = bool(torch.equal(out, want))
    finite = bool(torch.isfinite(out.float()).all())
    sums = out.float().sum(-1)
    rows_ok = bool(torch.allclose(sums, torch.ones_like(sums), atol=2e-2))
    seen = sorted(set(cases), key=str)
    new = {}
    for dt, n, c, act in seen:
        if (dt, n, c, act) not in checked:
            new.setdefault((dt, n, c), []).append(act)
    held = {}
    for (dt, n, c), acts in new.items():
        held[f"{str(dt)[6:]} N{n} C{c}"] = check_k3(
            fo, dt, n, c, gen, acts=tuple(acts), time_it=False)[
            "max_abs_err"]
    # K3's normalize at the batch-1 stem shape, timed (row 5 at serving's
    # smallest N)
    b1 = check_k3(fo, torch.bfloat16, 112 * 112, 64, gen, hw=112)["bn_act"]
    rec.update({"launches": counts, "launches_per_call_ok": calls_ok,
                "served_equals_net_output": equal, "finite": finite,
                "rows_sum_to_1": rows_ok,
                "k3_cases": [f"{str(dt)[6:]} N{n} C{c} {a}"
                             for dt, n, c, a in seen],
                "k3_held_here": held,
                "k3_b1_stem": {k: b1[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "max_abs_err")}})
    log(f"resnet50 served (bf16, ParallelInference(max_batch=64), "
        f"fused=auto): {json.dumps(rec)}")
    failed = []
    if not all(equal.values()) or not finite or not rows_ok:
        failed.append(f"served rows: equal to net.output() {equal}, finite "
                      f"{finite}, rows sum to 1 {rows_ok}")
    if not calls_ok:
        failed.append(f"K3 launches a call, want {per_call}")
    if rec["retraces_after_warm"] or rec["captures"] != len(
            RESNET_SERVE_BATCHES):
        failed.append(f"captures {rec['captures']}, retraces after warm "
                      f"{rec['retraces_after_warm']}")
    if failed:
        raise SystemExit(f"resnet50 serving: {failed}")
    return counts, rec


def bert_phase(fa, pa, fo, fl, k3_checked, gen):
    """Phase 16: BERT fine-tuned, MLM-pretrained and served, and ResNet-50
    served, each part its own path (counts set to 0 just before it).
    Returns the launch counts by path."""
    mods = (fa, pa, fo, fl)
    t0 = time.perf_counter()
    out = {"bert_finetune": bert_finetune(mods)}
    t1 = time.perf_counter()
    out["bert_mlm"] = bert_mlm(mods)
    t2 = time.perf_counter()
    out["bert_serve"], _ = bert_serve(mods)
    t3 = time.perf_counter()
    out["resnet_serve"], _ = resnet_serve(mods, fo, k3_checked, gen)
    t4 = time.perf_counter()
    log(f"phase 16 host seconds: fine-tune {t1 - t0:.1f}, MLM "
        f"{t2 - t1:.1f}, BERT serving {t3 - t2:.1f}, ResNet-50 serving "
        f"{t4 - t3:.1f}")
    return out


# --------------------------------------------------------------- phase 17

# ResNet-50's remat sweep: the settings, and the fit steps of each (eager,
# capture, replays)
REMAT_SETTINGS = (None, 3, 5)
REMAT_STEPS = 5
# LeNet through MnistDataSetIterator: batches an epoch (synthetic digits
# from the iterator's seed)
PREFETCH_BATCHES = 16
PREFETCH_READINGS, PREFETCH_EPOCHS = 5, 4    # timed fits, epochs a fit
# the char-RNN under early stopping: train and held-out batches, epochs
ES_TRAIN_BATCHES, ES_HELDOUT_BATCHES, ES_MAX_EPOCHS = 4, 2, 4
RNN_STREAM_ATOL = 2e-2                   # bf16 stream against K4's output
# step-1 grads under remat against the monolithic step (the momentum
# trace after one step), per leaf; predicted bit for bit, the bound
# leaves room for a cuDNN algorithm that differs between the two
REMAT_GRAD_REL_L2 = 1e-3
CKPT_STEPS = 3                           # k steps, saved, k more


def _remat_resnet(fo, remat, graphs, x, y, steps, checked):
    """ResNet-50 B128 bf16, Momentum, ``remat_segments=remat``: step 1
    alone (its loss, and the momentum trace = its grads), then ``steps``
    - 1 more; K3 launches a step (a replay at its capture's), wall and
    peak memory, the step kinds, retraces after warm."""
    from deeplearning4j_tpu_torch import disable_graphs
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.train import Momentum
    from deeplearning4j_tpu_torch.nn._compiled import tensors
    from deeplearning4j_tpu_torch.zoo.resnet import ResNet50

    model = ResNet50(num_classes=1000, updater=Momentum(0.1, 0.9),
                     compute_dtype=torch.bfloat16,
                     input_shape=(RESNET_HW, RESNET_HW, 3))
    net = ComputationGraph(model.conf())
    _set_fused(net, True)
    net.init()
    net.remat_segments = remat
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ds = DataSet(x, y)
    steplog = _StepLog(fo)
    net.set_listeners(steplog)
    sentinel = net._train_sentinel()
    t0 = time.perf_counter()
    with contextlib.nullcontext() if graphs else disable_graphs():
        with _k3_cases(fo) as cases:
            loss1 = net.fit([ds])
            trace1 = [t.detach().clone() for t in tensors(
                [s["trace"] for s in _traces(net._opt_state)])]
            t1 = time.perf_counter()
            net.fit([ds])
            sentinel.mark_warm()
            net.fit([ds] * (steps - 2))
        torch.cuda.synchronize()
        rec = way_summary(steplog.kinds(), steplog.step_s(t0, t1),
                          RESNET_BATCH, "samples",
                          torch.cuda.max_memory_allocated() / 2**30)
        rec["losses"] = [r[0] for r in steplog.rows]
        rec["k3_launches_per_step"] = steplog.launches_per_step()
        final = _all_tensors(net)
        if graphs:                       # one more replay, profiled
            net.set_listeners()
            add_profile(rec, profile_step(lambda: net.fit([ds])))
    rec["retraces_after_warm"] = sentinel.retraces_after_warm
    unchecked = set(cases) - checked
    del net
    gc.collect()
    torch.cuda.empty_cache()
    return rec, loss1, trace1, final, unchecked


def _traces(opt_state):
    """Momentum's trace states in an updater state tree (a chain)."""
    if isinstance(opt_state, dict):
        if "trace" in opt_state:
            return [opt_state]
        return [s for v in opt_state.values() for s in _traces(v)]
    if isinstance(opt_state, (tuple, list)):
        return [s for v in opt_state for s in _traces(v)]
    return []


def workflow2_resnet(fo, checked):
    """ResNet-50 B128 bf16 trained replayed with remat_segments None, 3
    and 5 (and each eager, for replayed = eager): step-1 loss and grads
    against the monolithic step, K3 launches by kernel (stats and
    normalize twice the monolithic count under remat, forward plus
    recompute; the backward reduce and dx once), wall and device ms,
    busy share, peak GiB."""
    rng = np.random.default_rng(17)
    x = torch.as_tensor(rng.random((RESNET_BATCH, RESNET_HW, RESNET_HW, 3),
                                   np.float32), device="cuda")
    y = torch.as_tensor(np.eye(1000, dtype=np.float32)[
        rng.integers(0, 1000, RESNET_BATCH)], device="cuda")
    runs, failed, counts = {}, [], {}
    for remat in REMAT_SETTINGS:
        rec, loss1, trace1, final, unch = _remat_resnet(
            fo, remat, True, x, y, REMAT_STEPS, checked)
        erec, eloss1, _, efinal, eunch = _remat_resnet(
            fo, remat, False, x, y, REMAT_STEPS, checked)
        diff = first_diff(efinal, final)
        rec["replay_equals_eager"] = diff is None and \
            rec["losses"] == erec["losses"]
        rec["eager_wall_ms_per_step"] = erec["wall_ms_per_step"]
        if unch | eunch:
            failed.append(f"remat {remat}: K3 ran at {unch | eunch}, which "
                          "phase 7 did not hold")
        runs[remat] = (rec, loss1, trace1)
        counts[remat] = rec["k3_launches_per_step"][1]      # the capture's
        kinds = rec["step_kinds"]
        if kinds != ["eager", "capture"] + ["replay"] * (REMAT_STEPS - 2):
            failed.append(f"remat {remat}: steps ran {kinds}")
        if not rec["replay_equals_eager"]:
            failed.append(f"remat {remat}: replayed != eager (leaf {diff})")
        if rec["retraces_after_warm"]:
            failed.append(f"remat {remat}: retraces after warm")
    mono = counts[None]
    _, mloss, mtrace = runs[None]
    report = {}
    for remat in REMAT_SETTINGS:
        rec, loss1, trace1 = runs[remat]
        want = mono if remat is None else {
            k: (2 * n if k in ("bn_stats", "bn_act") else n)
            for k, n in mono.items()}
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(trace1, mtrace))
        rel = max(rel_l2(a, b) for a, b in zip(trace1, mtrace))
        rec["k3_launches_expected"] = want
        rec["step1_loss_equal"] = loss1 == mloss
        rec["step1_grads_bit_equal"] = all(torch.equal(a, b) for a, b in
                                           zip(trace1, mtrace))
        rec["step1_grads_max_abs_err"] = err
        rec["step1_grads_max_rel_l2"] = rel
        if counts[remat] != want:
            failed.append(f"remat {remat}: K3 launches a step "
                          f"{counts[remat]}, expected {want}")
        if any(n == 0 for n in counts[remat].values()):
            failed.append(f"remat {remat}: a K3 kernel never launched")
        if remat is not None and not (loss1 == mloss
                                      and rel <= REMAT_GRAD_REL_L2):
            failed.append(f"remat {remat}: step 1 differs from the "
                          f"monolithic step (loss {loss1} vs {mloss}, "
                          f"grads max rel L2 {rel})")
        report[str(remat)] = {k: rec[k] for k in (
            "step_kinds", "wall_ms_per_step", "eager_wall_ms_per_step",
            "samples_per_s", "device_ms_per_step", "busy_share",
            "peak_alloc_gib", "k3_launches_per_step", "k3_launches_expected",
            "step1_loss_equal", "step1_grads_bit_equal",
            "step1_grads_max_abs_err", "step1_grads_max_rel_l2",
            "replay_equals_eager",
            "retraces_after_warm", "losses")}
    log(f"phase 17 resnet50 remat sweep (B{RESNET_BATCH} {RESNET_HW}x"
        f"{RESNET_HW} bf16, Momentum, fused K3): {json.dumps(report)}")
    if failed:
        raise SystemExit(f"phase 17 resnet50 remat: {failed}")
    # the path's counts: the replayed run's, steps x a step's launches
    return {f"workflow2_resnet_remat{remat}": {
        k: sum(s[k] for s in runs[remat][0]["k3_launches_per_step"])
        for k in mono} for remat in REMAT_SETTINGS}


def _fit_rates(net, data, readings=PREFETCH_READINGS,
               epochs=PREFETCH_EPOCHS):
    """LeNet samples/s of ``net.fit(data, epochs=epochs)``, ``readings``
    times (each fit timed whole: the prefetch's start and close
    included)."""
    rates = []
    for _ in range(readings):
        torch.cuda.synchronize()
        t = time.perf_counter()
        net.fit(data, epochs=epochs)
        torch.cuda.synchronize()
        rates.append(LENET_BATCH * PREFETCH_BATCHES * epochs
                     / (time.perf_counter() - t))
    return rates


def workflow2_prefetch(lenet_direct):
    """LeNet B512 through ``MnistDataSetIterator`` (synthetic, from its
    seed), wrapped by ``fit``'s async prefetch on the native ring (its
    step captured while the producer runs), against ``fit`` over the same
    host batches in a list (direct); a device-resident
    ``ListDataSetIterator``, which ``fit`` must iterate directly, never
    packing a batch."""
    from deeplearning4j_tpu_torch.data import (DataSet, ListDataSetIterator,
                                               MnistDataSetIterator)
    from deeplearning4j_tpu_torch.data import async_iter
    from deeplearning4j_tpu_torch.utils import native
    from deeplearning4j_tpu_torch.zoo import LeNet

    failed = []
    t0 = time.perf_counter()
    it = MnistDataSetIterator(LENET_BATCH, num_examples=LENET_BATCH
                              * PREFETCH_BATCHES, seed=17)
    gen_s = time.perf_counter() - t0
    host = list(it)
    it.reset()
    out = {"native_lib": str(native.lib_path()), "has_native":
           native.has_native(), "digits_generated_s": gen_s}
    nets = {}
    for way, data in (("prefetch", it), ("direct", host)):
        net = LeNet(num_classes=10, compute_dtype=torch.bfloat16).init()
        net.fit(data)                        # eager, capture, replays
        out[f"{way}_samples_per_s"] = _fit_rates(net, data)
        out[f"{way}_steps"] = dict(net._step_fn.calls)
        nets[way] = net
    pf = nets["prefetch"]._prefetch
    out["prefetch_buffer"], out["prefetch_counts"] = pf.buffer, pf.counts
    out["prefetch_equals_direct"] = first_diff(
        _all_tensors(nets["prefetch"]), _all_tensors(nets["direct"])) is None
    per_fit = PREFETCH_BATCHES * PREFETCH_EPOCHS
    if pf.buffer != "ring" or pf.counts != {"ring": per_fit, "queue": 0}:
        failed.append(f"prefetch ran on {pf.buffer} {pf.counts}, not the "
                      "native ring")
    if nets["prefetch"]._step_fn.calls["capture"] != 1:
        failed.append("the prefetched step was not captured once "
                      f"({out['prefetch_steps']})")
    if not out["prefetch_equals_direct"]:
        failed.append("prefetched fit != direct fit")
    if pf._thread.is_alive():
        failed.append("the producer outlived fit")
    out["phase11_direct_device_batch_samples_per_s"] = lenet_direct
    # a device-resident iterator: iterated directly, never packed
    x = torch.as_tensor(np.concatenate([d.features for d in host]),
                        device="cuda")
    y = torch.as_tensor(np.concatenate([d.labels for d in host]),
                        device="cuda")
    packed, real_pack = [], async_iter._pack

    def spy(ds, *a):
        packed.append(async_iter.on_device(ds))
        return real_pack(ds, *a)
    async_iter._pack = spy
    try:
        net = LeNet(num_classes=10, compute_dtype=torch.bfloat16).init()
        dev_it = ListDataSetIterator(DataSet(x, y), LENET_BATCH)
        net.fit(dev_it, epochs=2)
        torch.cuda.synchronize()
        rates = _fit_rates(net, dev_it)
    finally:
        async_iter._pack = real_pack
    out["device_iterator"] = {"prefetch": repr(net._prefetch),
                              "packed_device_batches": sum(packed),
                              "steps": dict(net._step_fn.calls),
                              "samples_per_s": rates}
    if net._prefetch is not None or sum(packed) or \
            net._step_fn.calls["capture"] != 1:
        failed.append(f"device batches: {out['device_iterator']}")
    log(f"phase 17 lenet prefetch (B{LENET_BATCH} bf16, "
        f"{PREFETCH_BATCHES} batches an epoch, {PREFETCH_EPOCHS} epochs a "
        f"reading): {json.dumps(out)}")
    del nets, net
    gc.collect()
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"phase 17 prefetch: {failed}")
    return out


def prefetch_times(root):
    """``--prefetch-times ROOT``: LeNet B512 bf16 samples/s of ``fit`` in
    the port checked out at ROOT over the same 16 synthetic batches, held
    three ways: a ``ListDataSetIterator`` over host numpy (prefetched where
    ROOT's ``fit`` prefetches), a ``ListDataSetIterator`` over tensors on
    the card, and a plain list of host batches; each warmed by one fit
    (eager, capture, replays), then ``PREFETCH_READINGS`` fits of
    ``PREFETCH_EPOCHS`` epochs, with the host's milliseconds a batch in
    the prefetch's ``__next__`` (where ROOT has one) and in moving the
    batch to the card (``_to_device``: it waits for the previous step).
    Two versions are compared in one run: parent, change, change, parent.
    Prints one JSON line."""
    import importlib
    sys.path.insert(0, str(root))
    data = importlib.import_module("deeplearning4j_tpu_torch.data")
    zoo = importlib.import_module("deeplearning4j_tpu_torch.zoo")
    log(f"prefetch-times: the port from {data.__file__}")
    rng = np.random.default_rng(0)
    n = LENET_BATCH * PREFETCH_BATCHES
    x = rng.random((n, 28, 28, 1), np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    sources = {
        "host_iterator": lambda: data.ListDataSetIterator(
            data.DataSet(x, y), LENET_BATCH),
        "device_iterator": lambda: data.ListDataSetIterator(data.DataSet(
            torch.as_tensor(x, device="cuda"),
            torch.as_tensor(y, device="cuda")), LENET_BATCH),
        "host_list": lambda: [data.DataSet(x[i:i + LENET_BATCH],
                                           y[i:i + LENET_BATCH])
                              for i in range(0, n, LENET_BATCH)]}
    spent = {"next": 0.0, "to_device": 0.0}
    wrapper = getattr(importlib.import_module(
        "deeplearning4j_tpu_torch.data.async_iter"), "AsyncDataSetIterator",
        None) if hasattr(data, "AsyncDataSetIterator") else None
    if wrapper is not None:                  # the consumer's time a batch
        real_next = wrapper.__next__

        def timed_next(self):
            t = time.perf_counter()
            try:
                return real_next(self)
            finally:
                spent["next"] += time.perf_counter() - t
        wrapper.__next__ = timed_next
    rows = {}
    for name, make in sources.items():
        net = zoo.LeNet(num_classes=10, compute_dtype=torch.bfloat16).init()
        src = make()
        net.fit(src)
        real_to = net._to_device

        def timed_to(a, real_to=real_to):
            t = time.perf_counter()
            try:
                return real_to(a)
            finally:
                spent["to_device"] += time.perf_counter() - t
        net._to_device = timed_to
        spent.update(next=0.0, to_device=0.0)
        t = time.perf_counter()
        rates = _fit_rates(net, src)
        steps = PREFETCH_READINGS * PREFETCH_EPOCHS * PREFETCH_BATCHES
        rows[name] = {
            "samples_per_s": rates,
            "host_ms_a_batch": {
                "step": 1e3 * (time.perf_counter() - t) / steps,
                "prefetch_next": 1e3 * spent["next"] / steps,
                "to_device": 1e3 * spent["to_device"] / steps},
            "prefetch": repr(getattr(net, "_prefetch", None)),
            "steps": dict(net._step_fn.calls)}
        del net
        torch.cuda.empty_cache()
    log(json.dumps({"prefetch_times": rows, "root": str(root),
                    "readings": PREFETCH_READINGS,
                    "epochs_a_reading": PREFETCH_EPOCHS}))
    return 0


def _charnn_iter(rng, n):
    """``n`` batches of random one-hot sequences on the card, iterated by
    a ListDataSetIterator (which slices them there)."""
    from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
    eye = np.eye(CHARNN_VOCAB, dtype=np.float32)
    shape = (n * CHARNN_BATCH, CHARNN_T)
    return ListDataSetIterator(DataSet(
        torch.as_tensor(eye[rng.integers(0, CHARNN_VOCAB, shape)],
                        device="cuda"),
        torch.as_tensor(eye[rng.integers(0, CHARNN_VOCAB, shape)],
                        device="cuda")), CHARNN_BATCH)


def workflow2_charnn(fl, checked):
    """The char-RNN (B256 T60 H256 bf16, K4's cluster route) under
    EarlyStoppingTrainer: MaxEpochs + ScoreImprovementEpoch on a held-out
    DataSetLossCalculator; the restored best model's held-out score and
    params against the record and the best epoch's snapshot; K4 launches
    in fit and in the calculator. Then the same net as a
    ComputationGraph: output() equal to the MLN's, rnn_time_step (60
    single steps, then 20 + 40) against the full output (K4)."""
    from deeplearning4j_tpu_torch.nn import (ComputationGraph, GravesLSTM,
                                             RnnOutputLayer)
    from deeplearning4j_tpu_torch.nn import early_stopping as es
    from deeplearning4j_tpu_torch.nn._compiled import tensors
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.train import Adam
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    rng = np.random.default_rng(18)
    train_it = _charnn_iter(rng, ES_TRAIN_BATCHES)
    held = _charnn_iter(rng, ES_HELDOUT_BATCHES)
    zoo = TextGenerationLSTM(num_classes=CHARNN_VOCAB,
                             input_shape=(CHARNN_T, CHARNN_VOCAB),
                             units=CHARNN_H, compute_dtype=torch.bfloat16,
                             updater=Adam(2e-3))
    net = zoo.init()
    _set_lstm_fused(net, True)
    failed, snaps, calc_launches = [], {}, []

    class Calc(es.DataSetLossCalculator):
        """The held-out loss, with a snapshot of the params it scored and
        the K4 launches it made (``score`` is eager: its wrappers count)."""

        def calculate_score(self, model):
            snaps[len(snaps)] = [t.detach().clone()
                                 for t in tensors(model.params)]
            before = dict(fl.LAUNCHES_BY_ROUTE)
            s = super().calculate_score(model)
            calc_launches.append({r: n - before[r] for r, n in
                                  fl.LAUNCHES_BY_ROUTE.items()})
            return s

    fit_n = StepLaunches({"fit": net._compiled_step()},
                         lambda: dict(fl.LAUNCHES_BY_ROUTE))
    with _k4_cases(fl) as cases:
        t0 = time.perf_counter()
        res = es.EarlyStoppingTrainer(es.EarlyStoppingConfiguration(
            epoch_termination_conditions=[
                es.MaxEpochsTerminationCondition(ES_MAX_EPOCHS),
                es.ScoreImprovementEpochTerminationCondition(1, 0.0)],
            score_calculator=Calc(held)), net, train_it).fit()
        es_s = time.perf_counter() - t0
        best = res.best_model
        rescore = es.DataSetLossCalculator(held).calculate_score(best)
    best_equal = all(torch.equal(a, b) for a, b in zip(
        tensors(best.params), snaps[res.best_model_epoch]))
    calc_total = {r: sum(c[r] for c in calc_launches)
                  for r in fl.LAUNCHES_BY_ROUTE}
    es_rec = {"termination": res.termination_reason,
              "total_epochs": res.total_epochs,
              "best_epoch": res.best_model_epoch,
              "best_score": res.best_model_score,
              "score_vs_epoch": res.score_vs_epoch,
              "best_model_rescored": rescore,
              "best_params_equal_snapshot": best_equal,
              "fit_k4_launches_by_route": fit_n.total,
              "calculator_k4_launches_by_route": calc_total,
              "fit_steps": dict(net._step_fn.calls),
              "prefetch": repr(net._prefetch), "host_s": es_s}
    log(f"phase 17 char-RNN early stopping (B{CHARNN_BATCH} T{CHARNN_T} "
        f"H{CHARNN_H} bf16, K4 fused): {json.dumps(es_rec)}")
    if rescore != res.best_model_score or not best_equal:
        failed.append("the restored best model is not the best epoch's")
    if not fit_n.total.get("cluster") or not calc_total["cluster"] or \
            fit_n.total.get("block") or calc_total["block"]:
        failed.append("K4 did not run on the cluster route in fit and in "
                      "the calculator")
    if net._step_fn.calls["replay"] < 1:
        failed.append("the early-stopping fit never replayed a graph")

    # the same net as a ComputationGraph, the MLN's weights copied in
    b = NeuralNetConfiguration.builder().seed(zoo.seed).updater(Adam(2e-3))
    b.data_type(torch.float32, torch.bfloat16)
    g = b.graph_builder().add_inputs("in")
    g.add_layer("l0", GravesLSTM(n_in=CHARNN_VOCAB, n_out=CHARNN_H,
                                 fused=True), "in")
    g.add_layer("l1", GravesLSTM(n_in=CHARNN_H, n_out=CHARNN_H,
                                 fused=True), "l0")
    g.add_layer("out", RnnOutputLayer(n_in=CHARNN_H, n_out=CHARNN_VOCAB,
                                      activation="softmax", loss="mcxent"),
                "l1")
    g.set_outputs("out")
    cg = ComputationGraph(g.build()).init([(CHARNN_T, CHARNN_VOCAB)])
    with torch.no_grad():
        for name, key in (("l0", "layer_0"), ("l1", "layer_1"),
                          ("out", "layer_2")):
            for k, t in cg.params[name].items():
                t.copy_(best.params[key][k])
    x = held._full.features[:CHARNN_BATCH]
    reset_all(fl)
    with _k4_cases(fl) as more:
        full = cg.output(x)
        torch.cuda.synchronize()
        cg_k4 = dict(fl.LAUNCHES_BY_ROUTE)
        mln_out = best.output(x)
    torch.cuda.synchronize()
    cases.extend(more)
    cg.rnn_clear_previous_state()
    t0 = time.perf_counter()
    steps = [cg.rnn_time_step(x[:, t]) for t in range(CHARNN_T)]
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    stepped = torch.stack(steps, dim=1)
    cg.rnn_clear_previous_state()
    chunked = torch.cat([cg.rnn_time_step(x[:, :20]),
                         cg.rnn_time_step(x[:, 20:])], dim=1)
    cg.rnn_clear_previous_state()
    again = cg.rnn_time_step(x[:, 0])
    torch.cuda.synchronize()
    err_step = float((stepped.float() - full.float()).abs().max())
    err_chunk = float((chunked.float() - full.float()).abs().max())
    rec = {"output_equals_mln": bool(torch.equal(full, mln_out)),
           "output_k4_launches_by_route": cg_k4,
           "stream_max_abs_err_single_steps": err_step,
           "stream_max_abs_err_chunks_20_40": err_chunk,
           "restart_equals_first_step": bool(torch.equal(again, steps[0])),
           "stream_calls": dict(cg._rnn_stream_fn.calls),
           "single_steps_host_s": stream_s, "atol": RNN_STREAM_ATOL}
    log(f"phase 17 char-RNN as a ComputationGraph: {json.dumps(rec)}")
    if not (rec["output_equals_mln"] and rec["restart_equals_first_step"]
            and err_step <= RNN_STREAM_ATOL and err_chunk <= RNN_STREAM_ATOL
            and cg_k4.get("cluster") and cg._rnn_stream_fn.calls["replay"]):
        failed.append(f"CG rnn_time_step / output: {rec}")
    unchecked = set(cases) - checked
    if unchecked:
        failed.append(f"K4 ran at {unchecked}, which phase 9 did not hold")
    del net, best, cg
    gc.collect()
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"phase 17 char-RNN: {failed}")
    k4 = lambda c: {"fused_lstm": sum(c.values()),  # noqa: E731
                    **{f"fused_lstm_{r}": n for r, n in c.items()}}
    return {"workflow2_charnn_es_fit": k4(fit_n.total),
            "workflow2_charnn_es_calculator": k4(calc_total),
            "workflow2_charnn_cg_output": k4(cg_k4)}


def workflow2_checkpoint():
    """A port checkpoint with its updater: LeNet B512 bf16, Adam, k steps,
    saved, loaded into a fresh net, k more; against 2k uninterrupted
    steps, bit for bit (params, states, updater, losses)."""
    import tempfile

    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.train import Adam
    from deeplearning4j_tpu_torch.zoo import LeNet

    rng = np.random.default_rng(19)
    data = [DataSet(torch.as_tensor(rng.random((LENET_BATCH, 28, 28, 1),
                                               np.float32), device="cuda"),
                    torch.as_tensor(np.eye(10, dtype=np.float32)[
                        rng.integers(0, 10, LENET_BATCH)], device="cuda"))
            for _ in range(2 * CKPT_STEPS)]

    def lenet():
        return LeNet(num_classes=10, compute_dtype=torch.bfloat16,
                     updater=Adam(1e-3)).init()
    whole = lenet()
    losses = [whole.fit(d) for d in data]
    part = lenet()
    first = [part.fit(d) for d in data[:CKPT_STEPS]]
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "lenet.zip"
        part.save(path, save_updater=True)
        back = MultiLayerNetwork.load(path)
    rest = [back.fit(d) for d in data[CKPT_STEPS:]]
    diff = first_diff(_all_tensors(whole), _all_tensors(back))
    rec = {"losses_equal": first + rest == losses, "first_diff": diff,
           "resumed_steps": dict(back._step_fn.calls), "losses": losses}
    log(f"phase 17 checkpoint resume (LeNet B{LENET_BATCH} bf16, Adam, "
        f"{CKPT_STEPS} + {CKPT_STEPS} steps): {json.dumps(rec)}")
    if not rec["losses_equal"] or diff is not None:
        raise SystemExit("phase 17 checkpoint: the resumed net is not the "
                         "uninterrupted one")


def workflow2_nd():
    """``nd.jit_in_workspace`` replayed against eager, and the workspace
    readings (a few host seconds)."""
    from deeplearning4j_tpu_torch import disable_graphs, nd

    def step(acc, x, w):
        acc.add_(torch.tanh(nd.mmul(x, w)).sum(0))
        return acc.norm()
    fn = nd.workspace.jit_in_workspace(step, donate_argnums=(0,))
    gen = torch.Generator(device="cuda").manual_seed(17)
    w = torch.randn(256, 256, device="cuda", generator=gen)
    xs = [torch.randn(64, 256, device="cuda", generator=gen)
          for _ in range(4)]
    acc, acc_e = nd.zeros(256), nd.zeros(256)
    outs = [fn(acc, x, w) for x in xs]
    with disable_graphs():
        outs_e = [step(acc_e, x, w) for x in xs]
    rec = {"calls": dict(fn.compiled.calls),
           "equal": all(torch.equal(a, b) for a, b in zip(outs, outs_e))
           and bool(torch.equal(acc, acc_e)),
           "live_buffer_gib": nd.workspace.live_buffer_bytes() / 2**30,
           "stats_devices": sorted(nd.workspace.device_memory_stats())}
    log(f"phase 17 nd.jit_in_workspace: {json.dumps(rec)}")
    if not rec["equal"] or rec["calls"]["replay"] != 2:
        raise SystemExit(f"phase 17 nd: {rec}")


def workflow2_path(fa, pa, fo, fl, k3_checked, k4_checked,
                   lenet_direct=None):
    """Phase 17: the rest of the DL4J workflow at full width (each part's
    kernel counts set to 0 just before it, read after); host seconds by
    part."""
    counts, secs = {}, {}
    for name, run in (
            ("resnet_remat", lambda: workflow2_resnet(fo, k3_checked)),
            ("prefetch", lambda: workflow2_prefetch(lenet_direct)),
            ("charnn", lambda: workflow2_charnn(fl, k4_checked)),
            ("checkpoint", workflow2_checkpoint), ("nd", workflow2_nd)):
        reset_all(fa, pa, fo, fl)
        t0 = time.perf_counter()
        got = run()
        secs[name] = round(time.perf_counter() - t0, 1)
        if name in ("resnet_remat", "charnn"):
            counts.update(got)
    log(f"phase 17 host seconds: {json.dumps(secs)}")
    return counts


# --------------------------------------------------------------- phase 18
# SameDiff and the TF GraphDef importer at BERT-base width (f32): the
# graph is written by a protobuf encoder of the script's own (the card
# has no TensorFlow), imported, served and fine-tuned.
SD_BATCH, SD_T = 32, 128
SD_STEPS = 5                              # eager, capture, 3 replays
SD_FWD_ATOL = 1e-3                        # imported forward vs bert_forward
SD_LOSS_REL = 1e-4                        # SameDiff-built step 1 vs autograd
SD_GRAD_REL_L2 = 1e-3
_TF_FLOAT, _TF_INT32 = 1, 3               # DataType enum values


def _pb_varint(v):
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _pb_len(field, data):
    return _pb_varint(field << 3 | 2) + _pb_varint(len(data)) + data


def _pb_int(field, v):
    return _pb_varint(field << 3) + _pb_varint(int(v))


def _pb_shape(dims):
    """TensorShapeProto: one ``dim`` (field 2) a dimension, its size in
    field 1."""
    return b"".join(_pb_len(2, _pb_int(1, d)) for d in dims)


def _pb_attr(key, value):
    """A NodeDef ``attr`` map entry (field 5): key 1, AttrValue 2."""
    return _pb_len(5, _pb_len(1, key.encode()) + _pb_len(2, value))


def _av_type(t):
    return _pb_int(6, t)


def _av_bool(b):
    return _pb_int(5, 1 if b else 0)


def _av_int(i):
    return _pb_int(3, i)


def _av_tensor(arr):
    """AttrValue.tensor (8): TensorProto dtype 1, tensor_shape 2,
    tensor_content 4."""
    arr = np.asarray(arr, order="C")     # 0-d stays 0-d
    dt = {np.dtype(np.float32): _TF_FLOAT,
          np.dtype(np.int32): _TF_INT32}[arr.dtype]
    proto = (_pb_int(1, dt) + _pb_len(2, _pb_shape(arr.shape))
             + _pb_len(4, arr.tobytes()))
    return _pb_len(8, proto)


def _pb_node(name, op, inputs=(), attrs=()):
    """A GraphDef ``node`` (field 1): NodeDef name 1, op 2, input 3,
    attr 5."""
    body = _pb_len(1, name.encode()) + _pb_len(2, op.encode())
    body += b"".join(_pb_len(3, i.encode()) for i in inputs)
    body += b"".join(_pb_attr(k, v) for k, v in attrs)
    return _pb_len(1, body)


class _GraphWriter:
    """The nodes of a frozen GraphDef, f32 and int32 only."""

    def __init__(self):
        self.parts, self.n = [], 0

    def fresh(self, base):
        self.n += 1
        return f"{base}_{self.n}"

    def node(self, op, inputs, attrs=(), name=None, t=_TF_FLOAT):
        name = name or self.fresh(op)
        self.parts.append(_pb_node(name, op, inputs,
                                   [("T", _av_type(t)), *attrs]))
        return name

    def const(self, arr, name=None):
        arr = np.asarray(arr)
        arr = arr.astype(np.int32 if arr.dtype.kind in "iu"
                         else np.float32)
        name = name or self.fresh("Const")
        dt = _TF_INT32 if arr.dtype == np.int32 else _TF_FLOAT
        self.parts.append(_pb_node(name, "Const", (), [
            ("dtype", _av_type(dt)), ("value", _av_tensor(arr))]))
        return name

    def placeholder(self, name, shape, t):
        self.parts.append(_pb_node(name, "Placeholder", (), [
            ("dtype", _av_type(t)),
            ("shape", _pb_len(7, _pb_shape(shape)))]))
        return name

    def bytes(self):
        return b"".join(self.parts)


def bert_graphdef(params, cfg, b, t):
    """BERT's forward (``zoo/transformer.py`` ``bert_forward``, no token
    types, no mask) as a frozen TF GraphDef of (B, T) int32 ``ids``, its
    weights ``Const`` nodes: GatherV2 for the embedding, Mean/Square/
    Rsqrt for the RMS norm, BatchMatMulV2 for the projections and the
    attention, Softmax, and Tanh/Pow for the tanh GELU. Outputs
    ``logits`` (B, num_labels) and ``hidden`` (B, T, D), and ``pooled``."""
    def host(x):
        return x.detach().float().cpu().numpy()

    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    g = _GraphWriter()
    ids = g.placeholder("ids", (b, t), _TF_INT32)
    embed = g.const(host(params["embed"]), "embed")
    x = g.node("GatherV2", [embed, ids, g.const(np.int32(0))],
               [("Tparams", _av_type(_TF_FLOAT)),
                ("Tindices", _av_type(_TF_INT32)),
                ("Taxis", _av_type(_TF_INT32)), ("batch_dims", _av_int(0))])
    x = g.node("AddV2", [x, g.const(host(params["pos_embed"][:t]), "pos")])
    eps = g.const(np.float32(1e-6))
    last = g.const(np.asarray([-1], np.int32))

    def rmsnorm(v, scale):
        sq = g.node("Square", [v])
        ms = g.node("Mean", [sq, last], [("Tidx", _av_type(_TF_INT32)),
                                         ("keep_dims", _av_bool(True))])
        r = g.node("Rsqrt", [g.node("AddV2", [ms, eps])])
        return g.node("Mul", [g.node("Mul", [v, r]), g.const(scale)])

    def bmm(a, w, adj_y=False):
        return g.node("BatchMatMulV2", [a, w], [
            ("adj_x", _av_bool(False)), ("adj_y", _av_bool(adj_y))])

    def reshape(v, shape):
        return g.node("Reshape", [v, g.const(np.asarray(shape, np.int32))],
                      [("Tshape", _av_type(_TF_INT32))])

    def transpose(v, perm):
        return g.node("Transpose", [v, g.const(np.asarray(perm, np.int32))],
                      [("Tperm", _av_type(_TF_INT32))])

    scale = g.const(np.float32(1.0 / math.sqrt(hd)))
    half, one = g.const(np.float32(0.5)), g.const(np.float32(1.0))
    c3, k1 = g.const(np.float32(3.0)), g.const(np.float32(0.044715))
    k2 = g.const(np.float32(math.sqrt(2.0 / math.pi)))
    axis2 = g.const(np.int32(2))
    blocks = params["blocks"]
    for layer in range(cfg.n_layers):
        w = {k: host(v[layer]) for k, v in blocks.items()}
        hn = rmsnorm(x, w["ln1"])
        qkv = bmm(hn, g.const(w["wqkv"]))
        split = g.node("Split", [axis2, qkv], [("num_split", _av_int(3))])
        q, k, v = (transpose(reshape(f"{split}:{j}" if j else split,
                                     (b, t, h, hd)), (0, 2, 1, 3))
                   for j in range(3))
        s = g.node("Mul", [bmm(q, k, adj_y=True), scale])
        p = g.node("Softmax", [s])
        ctx = reshape(transpose(bmm(p, v), (0, 2, 1, 3)), (b, t, d))
        x = g.node("AddV2", [x, bmm(ctx, g.const(w["wo"]))])
        h2 = rmsnorm(x, w["ln2"])
        u = bmm(h2, g.const(w["w_in"]))
        cube = g.node("Pow", [u, c3])
        inner = g.node("Mul", [k2, g.node("AddV2", [
            u, g.node("Mul", [k1, cube])])])
        gl = g.node("Mul", [g.node("Mul", [half, u]), g.node(
            "AddV2", [one, g.node("Tanh", [inner])])])
        x = g.node("AddV2", [x, bmm(gl, g.const(w["w_out"]))])
    hidden = g.node("Identity", [x], name="hidden")
    x0 = g.node("StridedSlice", [
        hidden, g.const(np.asarray([0, 0, 0], np.int32)),
        g.const(np.asarray([0, 1, 0], np.int32)),
        g.const(np.asarray([1, 1, 1], np.int32))], [
        ("Index", _av_type(_TF_INT32)), ("begin_mask", _av_int(5)),
        ("end_mask", _av_int(5)), ("ellipsis_mask", _av_int(0)),
        ("new_axis_mask", _av_int(0)), ("shrink_axis_mask", _av_int(2))])
    mm = [("transpose_a", _av_bool(False)), ("transpose_b", _av_bool(False))]
    pooled = g.node("Tanh", [g.node("MatMul", [
        x0, g.const(host(params["pooler"]), "pooler")], mm)], name="pooled")
    g.node("MatMul", [pooled, g.const(host(params["cls"]), "cls")], mm,
           name="logits")
    return g.bytes()


def _sd_timing(call, warm_check=None, iters=10):
    """Median wall ms of ``call`` (synchronized each time) and one
    profiled call's device ms and kernel launches."""
    secs = []
    for _ in range(iters):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof, wall, 1)
    launches = sum(ev.count for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA)
    return {"wall_ms": float(np.median(secs)) * 1e3,
            "device_ms": rows["device_ms_per_step"],
            "launches": launches,
            "top_kernels": rows["top_kernels"][:4]}


def _sd_bert_graph(sd, params, cfg, b, t):
    """BERT's classifier loss built through the SameDiff API, every
    weight an ``sd.var`` holding ``params``' value: the same function as
    ``bert_classifier_loss`` (one-hot labels, no token types, no mask).
    Returns the names of the vars by leaf of ``params``."""
    d, nh = cfg.d_model, cfg.n_heads
    hd = d // nh
    names = {}

    def var(key, value):
        names[key] = key
        return sd.var(key, value=value.detach())

    ids = sd.placeholder("ids", (b, t), torch.int32)
    labels = sd.placeholder("labels", (b, cfg.num_labels))
    x = sd.nn.embedding_lookup(var("embed", params["embed"]), ids)
    x = x + sd.base.slice(var("pos_embed", params["pos_embed"]), (0, 0),
                          (t, d))
    for layer in range(cfg.n_layers):
        w = {k: var(f"blocks/{k}/{layer}", v[layer])
             for k, v in params["blocks"].items()}
        h = sd.nn.rms_norm(x, w["ln1"])
        qkv = h @ w["wqkv"]
        q, k, v = (sd.base.slice(qkv, (0, 0, j * d), (b, t, d)).reshape(
            b, t, nh, hd) for j in range(3))
        a = sd.nn.dot_product_attention(q, k, v).reshape(b, t, d)
        x = x + a @ w["wo"]
        h2 = sd.nn.rms_norm(x, w["ln2"])
        x = x + sd.nn.gelu(h2 @ w["w_in"]) @ w["w_out"]
    x0 = sd.base.squeeze(sd.base.slice(x, (0, 0, 0), (b, 1, d)), 1)
    pooled = sd.math.tanh(x0 @ var("pooler", params["pooler"]))
    logits = (pooled @ var("cls", params["cls"])).rename("logits")
    sd.loss.softmax_cross_entropy(labels, logits).rename("loss")
    sd.set_loss_variables("loss")
    return names


class _SDStepLog:
    """A fit listener: each step's loss, host time and how its compiled
    step ran."""

    def __init__(self, sd):
        self.sd, self.rows = sd, []
        self.t0 = time.perf_counter()

    def iteration_done(self, model, it, epoch, loss):
        self.rows.append((loss, time.perf_counter(),
                          self.sd.fit_step().last))


def _sd_fit_ways(sd, batches, train_vars, tag, rec_extra=None):
    """``sd.fit`` over ``batches`` twice from the same start: replayed (the
    main path) and eager; returns the two records and whether the
    trajectories (losses and trained values) are bit for bit equal."""
    from deeplearning4j_tpu_torch import disable_graphs
    from deeplearning4j_tpu_torch.data import DataSet
    init = {n: sd._values[n].detach().clone() for n in train_vars}
    runs = {}
    for way, graphs in (("replayed", True), ("eager", False)):
        with torch.no_grad():
            for n in train_vars:
                sd._values[n].copy_(init[n])
        sd._optimizer = None            # a fresh Adam state each way
        log_ = _SDStepLog(sd)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with contextlib.nullcontext() if graphs else disable_graphs():
            hist = sd.fit(iterator=[DataSet(*bt) for bt in batches],
                          epochs=1, listeners=[log_])
            peak = torch.cuda.max_memory_allocated() / 2**30
            step = sd.fit_step()
            prof = profile_step(lambda: step(*batches[0]))
        ends = [r[1] for r in log_.rows]
        kinds = [r[2] for r in log_.rows]
        rec = {"losses": hist.loss_curve,
               **way_summary(kinds, [b_ - a_ for a_, b_ in zip(
                   [log_.t0] + ends, ends)], batches[0][0].shape[0], "seq",
                   peak)}
        add_profile(rec, prof)
        rec["top_kernels"] = prof["top_kernels"][:5]
        runs[way] = (rec, [(n, sd._values[n].detach().clone())
                           for n in train_vars])
        log(f"samediff {tag} {way}: {json.dumps(rec)}")
    (rr, rf), (er, ef) = runs["replayed"], runs["eager"]
    same = rr["losses"] == er["losses"] and first_diff(rf, ef) is None
    return rr, er, same


def samediff_phase(fa, pa, fo, fl, smi):
    """Phase 18: SameDiff and the TF importer at BERT-base width (f32, B32
    T128): (a) a frozen GraphDef of BERT-base imported and served, held
    to ``bert_forward``; (b) a classifier head fine-tuned through the
    import; (c) BERT-base built through the SameDiff API and fine-tuned
    whole, step 1 held to autograd of ``bert_classifier_loss``; (d) small
    graphs on the card. No hand-written kernel runs. Returns the launch
    counts of the phase (all 0)."""
    from deeplearning4j_tpu_torch import disable_graphs
    from deeplearning4j_tpu_torch.autodiff import (SameDiff, TrainingConfig,
                                                   import_frozen_graph)
    from deeplearning4j_tpu_torch.train.updaters import Adam
    from deeplearning4j_tpu_torch.zoo import transformer as tfm
    mods = (fa, pa, fo, fl)
    reset_all(*mods)
    failed = []
    t_phase = time.perf_counter()
    log(f"phase 18 on {smi}: TF32 matmuls "
        f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN TF32 "
        f"{torch.backends.cudnn.allow_tf32}")
    cfg = tfm.BertConfig(dtype=torch.float32, max_seq=SD_T)
    gen = torch.Generator().manual_seed(18)
    params = tfm.bert_init(cfg, gen, device="cuda")
    with torch.no_grad():
        params["cls"].copy_(0.02 * torch.randn(params["cls"].shape,
                                               generator=gen))
    rng = np.random.default_rng(18)
    ids_np = rng.integers(0, cfg.vocab_size, (SD_BATCH, SD_T),
                          dtype=np.int32)
    ids = torch.as_tensor(ids_np, device="cuda")
    onehot = torch.nn.functional.one_hot(torch.as_tensor(
        rng.integers(0, cfg.num_labels, SD_BATCH)), cfg.num_labels).to(
        device="cuda", dtype=torch.float32)

    # (a) imported and served
    t0 = time.perf_counter()
    raw = bert_graphdef(params, cfg, SD_BATCH, SD_T)
    t1 = time.perf_counter()
    sd, _ = import_frozen_graph(raw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    graph_mb = len(raw) / 1e6
    del raw
    ref_logits, ref_hidden = tfm.bert_forward(params, cfg, ids)
    outs = ["logits", "hidden"]
    torch.cuda.reset_peak_memory_stats()
    runner = sd.runner(outs, {"ids": ids})
    got = [sd.eval(outs, {"ids": ids}) for _ in range(3)]
    warm = dict(runner.compiled.calls)
    with disable_graphs():
        eager = sd.eval(outs, {"ids": ids})
    err = max(float((got[-1][0] - ref_logits).abs().max()),
              float((got[-1][1] - ref_hidden).abs().max()))
    replayed_eq = all(torch.equal(a, b) for a, b in zip(got[-1], eager))
    t_rep = _sd_timing(lambda: sd.eval(outs, {"ids": ids}))
    with disable_graphs():
        t_eag = _sd_timing(lambda: sd.eval(outs, {"ids": ids}), iters=5)
    calls = dict(runner.compiled.calls)
    retraces = (calls["eager"] - warm["eager"]) + (calls["capture"]
                                                   - warm["capture"])
    rec_a = {"graph_mb": graph_mb, "encode_s": t1 - t0, "import_s": t2 - t1,
             "nodes": len(sd._vars), "host_nodes": sd.needs_host(outs),
             "max_abs_err_vs_bert_forward": err, "calls": calls,
             "retraces_after_warm": retraces,
             "replayed_equals_eager": replayed_eq,
             "replayed": t_rep, "eager": t_eag,
             "peak_alloc_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"samediff (a) imported BERT-base B{SD_BATCH} T{SD_T} f32 served: "
        f"{json.dumps(rec_a)}")
    if not (err <= SD_FWD_ATOL and np.isfinite(err)):
        failed.append(f"(a) imported forward off bert_forward by {err}")
    if retraces or not replayed_eq or calls["replay"] < 1:
        failed.append(f"(a) retraces {retraces}, replayed = eager "
                      f"{replayed_eq}, calls {calls}")

    # (b) fine-tuned through the import: the encoder stays constants, a
    # classifier head of sd.vars on the pooled output
    d = cfg.d_model
    lab = sd.placeholder("labels", (SD_BATCH, cfg.num_labels))
    head_w = sd.var("head_w", (d, cfg.num_labels), seed=18)
    head_b = sd.var("head_b", value=np.zeros(cfg.num_labels, np.float32))
    head = sd.nn.linear(sd.get_variable("pooled"), head_w, head_b)
    sd.loss.softmax_cross_entropy(lab, head).rename("head_loss")
    sd.set_loss_variables("head_loss")
    sd.set_training_config(TrainingConfig(
        updater=Adam(1e-3), data_set_feature_mapping=["ids"],
        data_set_label_mapping=["labels"]))
    batches = [(torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (SD_BATCH, SD_T), dtype=np.int32),
        device="cuda"), onehot) for _ in range(SD_STEPS)]
    rb, eb, same_b = _sd_fit_ways(sd, batches, ["head_w", "head_b"],
                                  "(b) head fine-tune through the import")
    log(f"samediff (b) replayed = eager bit for bit {same_b}; wall ms a "
        f"step {rb['wall_ms_per_step']:.2f} vs {eb['wall_ms_per_step']:.2f}")
    if not (all(np.isfinite(rb["losses"])) and same_b):
        failed.append(f"(b) losses {rb['losses']} / {eb['losses']}, "
                      f"bit-identical {same_b}")
    if rb["step_kinds"] != ["eager", "capture",
                            *["replay"] * (SD_STEPS - 2)]:
        failed.append(f"(b) steps {rb['step_kinds']} did not replay")
    del sd, runner, got, eager
    torch.cuda.empty_cache()

    # (c) BERT-base built through the SameDiff API, fine-tuned whole
    sdc = SameDiff.create()
    names = _sd_bert_graph(sdc, params, cfg, SD_BATCH, SD_T)
    feeds = {"ids": ids, "labels": onehot}
    loss_sd = float(sdc.eval("loss", feeds))
    grads_sd = sdc.grad("loss", feeds=feeds)
    leaves = {"embed": params["embed"], "pos_embed": params["pos_embed"],
              "pooler": params["pooler"], "cls": params["cls"],
              "blocks": params["blocks"]}
    flat = [(k, v) for k, v in _named_leaves(leaves)]
    ps = [v.detach().clone().requires_grad_(True) for _, v in flat]
    rebuilt = {}
    for (k, _), p in zip(flat, ps):
        parts = k.strip("/").split("/")
        node = rebuilt
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = p
    full = dict(params, **rebuilt)
    loss_ref = tfm.bert_classifier_loss(full, cfg, ids, onehot)
    g_ref = torch.autograd.grad(loss_ref, ps)
    loss_ref = loss_ref.item()
    loss_rel = abs(loss_sd - loss_ref) / abs(loss_ref)
    worst = (None, 0.0)
    for (k, _), g in zip(flat, g_ref):
        parts = k.strip("/").split("/")
        if parts[0] == "blocks":
            gs = torch.stack([grads_sd[f"blocks/{parts[1]}/{i}"]
                              for i in range(cfg.n_layers)])
        else:
            gs = grads_sd[parts[0]]
        r = rel_l2(gs, g)
        if worst[0] is None or r > worst[1]:
            worst = (k, r)
    log(f"samediff (c) SameDiff-built BERT-base step 1 vs autograd of "
        f"bert_classifier_loss: loss {loss_sd:.6f} vs {loss_ref:.6f} "
        f"(rel {loss_rel:.2e}), {len(g_ref)} grad leaves, worst rel-L2 "
        f"{worst[1]:.2e} ({worst[0]})")
    if not loss_rel <= SD_LOSS_REL or not worst[1] <= SD_GRAD_REL_L2:
        failed.append(f"(c) step 1 loss rel {loss_rel}, grad {worst}")
    del g_ref, grads_sd, ps, full, loss_ref
    torch.cuda.empty_cache()
    sdc.set_training_config(TrainingConfig(
        updater=Adam(1e-5), data_set_feature_mapping=["ids"],
        data_set_label_mapping=["labels"]))
    train_vars = sorted(names)
    rc, ec, same_c = _sd_fit_ways(sdc, batches, train_vars,
                                  "(c) SameDiff-built BERT-base fine-tune")
    if not (all(np.isfinite(rc["losses"])) and same_c):
        failed.append(f"(c) losses {rc['losses']} / {ec['losses']}, "
                      f"bit-identical {same_c}")
    if rc["step_kinds"] != ["eager", "capture",
                            *["replay"] * (SD_STEPS - 2)]:
        failed.append(f"(c) steps {rc['step_kinds']} did not replay")
    del sdc
    torch.cuda.empty_cache()
    # for reading only: the zoo's f32 fine-tune step at this shape
    zp = _clone_params(params)
    zstep = bert_finetune_step(tfm, cfg, zp, _adamw(tfm, zp, 1e-5))
    zlab = onehot.argmax(-1)
    torch.cuda.reset_peak_memory_stats()
    zsecs, zkinds = [], []
    for _ in range(SD_STEPS):
        t0 = time.perf_counter()
        zstep(ids, zlab)
        torch.cuda.synchronize()
        zsecs.append(time.perf_counter() - t0)
        zkinds.append(zstep.last)
    zrec = way_summary(zkinds, zsecs, SD_BATCH, "seq",
                       torch.cuda.max_memory_allocated() / 2**30)
    add_profile(zrec, profile_step(lambda: zstep(ids, zlab)))
    log(f"samediff (c) for reading: the zoo's f32 BERT-base fine-tune step "
        f"(AdamW, capturable) at B{SD_BATCH} T{SD_T}: {json.dumps(zrec)}")
    del zp, zstep
    torch.cuda.empty_cache()

    # (d) small graphs on the card
    sdd = SameDiff.create()
    x = sdd.var("x", value=np.asarray(1.0, np.float32))
    w = sdd.while_loop(lambda v: v < 100.0, lambda v: v * 2.0, x)
    c = sdd.cond(sdd.constant("p", True), lambda v: v + 1, lambda v: v - 1,
                 sdd.constant("o", 10.0))
    wl, cv = float(sdd.eval(w)), float(sdd.eval(c))
    eager_by_structure = sdd.runner(w).compiled is None and \
        sdd.runner(c).compiled is None
    cpu = SameDiff.create(device="cpu")
    xc = cpu.var("x", value=np.asarray(1.0, np.float32))
    wl_cpu = float(cpu.eval(cpu.while_loop(lambda v: v < 100.0,
                                           lambda v: v * 2.0, xc)))
    sm = SameDiff.create()
    xin = sm.placeholder("x", (4, 8))
    sm.nn.softmax(sm.nn.linear(xin, sm.var("w", (8, 3), seed=1),
                               sm.var("b", value=np.ones(3, np.float32))))\
        .rename("out")
    xv = rng.standard_normal((4, 8)).astype(np.float32)
    path = Path("build") / "samediff_roundtrip.zip"
    sm.save(path)
    back = SameDiff.load(path)
    rt_equal = torch.equal(sm.eval("out", {"x": xv}),
                           back.eval("out", {"x": xv}))
    counts = all_counts(*mods)
    rec_d = {"while_loop": wl, "while_loop_cpu": wl_cpu, "cond": cv,
             "eager_by_structure": eager_by_structure,
             "save_load_eval_equal": rt_equal,
             "kernel_launches": counts,
             "phase_s": time.perf_counter() - t_phase}
    log(f"samediff (d) small graphs: {json.dumps(rec_d)}")
    if wl != wl_cpu or cv != 11.0 or not eager_by_structure:
        failed.append(f"(d) control flow {rec_d}")
    if not rt_equal:
        failed.append("(d) save -> load changed eval")
    if _launched(counts):
        failed.append(f"hand-written kernels launched: {counts}")
    if failed:
        raise SystemExit(f"samediff phase: {failed}")
    return counts


# ---------------------------------------------------------------- phase 19

ZOO_BATCH = 8                           # YOLO2's train and output batch
YOLO_HW = 608                           # the zoo default (yolov2.cfg)
YOLO_OBJECTS = 6                        # boxes drawn per image
ATTN_B, ATTN_T, ATTN_C, ATTN_H = 8, 2048, 512, 8   # D 64
ATTN_CLASSES = 64
ZOO_STEPS = 5                           # eager, capture, 3 replays
ONNX_BATCHES = (1, 32)
ONNX_HW = 224


def path_counts(fa, pa, fo):
    """Every hand-written kernel's counter, keyed as a path's counts are
    (the flash kernels by family, K2, the four K3 kernels, K4 by
    route)."""
    from deeplearning4j_tpu_torch.kernels import fused_lstm as fl
    return {**flash_counts(fa), "paged_attention": pa.LAUNCHES,
            **k3_counts(fo), "fused_lstm": fl.LAUNCHES,
            **{f"fused_lstm_{r}": n
               for r, n in fl.LAUNCHES_BY_ROUTE.items()}}


class _CountLog:
    """A fit listener: loss, host time, every kernel counter and how the
    compiled step ran at the end of each step (``fit`` reads the loss to
    the host first, which waits for the step's kernels)."""
    deferred_score_ok = False

    def __init__(self, counts):
        self.counts, self.rows = counts, []
        self.base = counts()
        self.t0 = time.perf_counter()

    def iteration_done(self, net, it, epoch, loss):
        self.rows.append((loss, time.perf_counter(), self.counts(),
                          net._step_fn.last))

    def per_step(self):
        """Launches a step by counter, a replay at its capture's."""
        before = [self.base] + [r[2] for r in self.rows[:-1]]
        return replay_counts([{k: r[2][k] - b[k] for k in r[2]}
                              for r, b in zip(self.rows, before)],
                             [r[3] for r in self.rows])

    def record(self, batch):
        kinds = [r[3] for r in self.rows]
        ends = [r[1] for r in self.rows]
        return {"losses": [r[0] for r in self.rows],
                **way_summary(kinds, [b - a for a, b in
                                      zip([self.t0] + ends, ends)],
                              batch, "samples",
                              torch.cuda.max_memory_allocated() / 2**30)}


def _zoo_fit_way(make_net, ds, graphs, counts, steps=ZOO_STEPS):
    """Train a fresh net ``steps`` steps on one batch, replayed from a
    CUDA graph (eager, capture, replays) or eager: losses, wall ms a step
    and samples/s over the timed steps, peak GiB, the launches of every
    hand-written kernel a step and over the run (a replay at its
    capture's), retraces after warm, the final params, states and updater
    state; the replayed way also profiles one more replay (device ms,
    busy share)."""
    from deeplearning4j_tpu_torch import disable_graphs
    net = make_net()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steplog = _CountLog(counts)
    net.set_listeners(steplog)
    sentinel = net._train_sentinel()
    with contextlib.nullcontext() if graphs else disable_graphs():
        net.fit([ds])
        net.fit([ds])
        sentinel.mark_warm()
        net.fit([ds] * (steps - 2))
        torch.cuda.synchronize()
        rec = steplog.record(int(ds.features.shape[0]))
        final = _all_tensors(net)
    per = steplog.per_step()
    if graphs:
        net.set_listeners()
        add_profile(rec, profile_step(lambda: net.fit([ds]),
                                      expect=expected_flash(per[-1])))
    rec["retraces_after_warm"] = sentinel.retraces_after_warm
    rec["launches_per_step"] = {k: v for k, v in per[-1].items() if v}
    total = {k: sum(p[k] for p in per) for k in per[0]}
    return net, rec, total, final


def _zoo_ways(tag, make_net, ds, counts, failed, steps=ZOO_STEPS):
    """:func:`_zoo_fit_way` replayed and eager; replayed = eager bit for
    bit (losses and every final tensor), step kinds, 0 retraces after
    warm. Returns (the replayed net, its record, its launches)."""
    net, rec, total, final = _zoo_fit_way(make_net, ds, True, counts, steps)
    enet, erec, etotal, efinal = _zoo_fit_way(make_net, ds, False, counts,
                                              steps)
    del enet
    diff = first_diff(efinal, final)
    rec["replay_equals_eager"] = diff is None and \
        rec["losses"] == erec["losses"]
    rec["eager_wall_ms_per_step"] = erec["wall_ms_per_step"]
    rec["eager_samples_per_s"] = erec["samples_per_s"]
    rec["eager_launches_per_step"] = erec["launches_per_step"]
    kinds = rec["step_kinds"]
    if kinds != ["eager", "capture"] + ["replay"] * (steps - 2):
        failed.append(f"{tag}: steps ran {kinds}")
    if not rec["replay_equals_eager"]:
        failed.append(f"{tag}: replayed != eager (leaf {diff}, losses "
                      f"{rec['losses']} vs {erec['losses']})")
    if rec["retraces_after_warm"] or erec["retraces_after_warm"]:
        failed.append(f"{tag}: retraces after warm")
    if not all(math.isfinite(v) for v in rec["losses"]):
        failed.append(f"{tag}: losses {rec['losses']}")
    log(f"{tag}: {json.dumps(rec)}")
    del final, efinal
    return net, rec, total


def yolo_labels(rng, b, grid, classes, n_objects):
    """(B, grid, grid, 4 + classes) YOLO labels: ``n_objects`` boxes an
    image in random cells, each centred in its cell, (w, h) 0.5-6 grid
    units, a random class (one box a cell)."""
    lab = np.zeros((b, grid, grid, 4 + classes), np.float32)
    for bi in range(b):
        cells = rng.choice(grid * grid, n_objects, replace=False)
        for cell in cells:
            cy, cx = divmod(int(cell), grid)
            x, y = cx + rng.random(), cy + rng.random()
            w, h = rng.uniform(0.5, 6.0, 2)
            lab[bi, cy, cx, :4] = [x - w / 2, y - h / 2, x + w / 2,
                                   y + h / 2]
            lab[bi, cy, cx, 4 + rng.integers(0, classes)] = 1.0
    return lab


def zoo_yolo2(fa, pa, fo, gen, k3_checked, failed):
    """Phase 19 (a): YOLO2 at 608×608, 80 classes, 5 anchors, the
    passthrough: ``fit`` at B8 f32 with the zoo's Adam(1e-3) and its BNs
    as configured (``fused="auto"``: plain BN in training), replayed and
    eager (cuDNN deterministic, so that the two ways pick the same
    algorithms); ``output()`` at B1 and B8 with the BNs' ``fused=True``
    (``"auto"`` fuses only a BN that carries an activation, and YOLO2's
    leaky ReLU is a layer of its own, as in the reference) on a fresh net
    from the zoo's seed: K3's bn_act once per BN, 22 a forward, every K3
    shape held against its plain version, replayed = eager, against the
    plain BN path; ``get_predicted_objects`` + ``nms`` on its B8 raw
    volume."""
    from deeplearning4j_tpu_torch import disable_graphs
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn.layers.objdetect import (
        get_predicted_objects, nms)
    from deeplearning4j_tpu_torch.zoo import YOLO2
    counts = lambda: path_counts(fa, pa, fo)    # noqa: E731
    model = YOLO2()
    grid = YOLO_HW // 32
    rng = np.random.default_rng(19)
    x = torch.as_tensor(rng.random((ZOO_BATCH, YOLO_HW, YOLO_HW, 3),
                                   np.float32), device="cuda")
    lab = torch.as_tensor(yolo_labels(rng, ZOO_BATCH, grid,
                                      model.num_classes, YOLO_OBJECTS),
                          device="cuda")
    ds = DataSet(x, lab)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        net, rec, train_total = _zoo_ways(
            f"yolo2 fit {YOLO_HW}x{YOLO_HW} B{ZOO_BATCH} f32", model.init,
            ds, counts, failed)
    finally:
        torch.cuda.synchronize()
    # the trained net's losses ran away (the zoo's Adam(1e-3) on random
    # weights and boxes; the reference's net does the same) and it learns
    # to call no box: the served net is a fresh one from the zoo's seed
    del net
    gc.collect()
    torch.cuda.empty_cache()
    net = model.init()
    # output() at B1 and B8: eager, capture, replay each; launches a call
    _set_fused(net, True)
    out_rec, outs, per_call = {}, {}, []
    torch.cuda.reset_peak_memory_stats()
    with _k3_cases(fo) as cases:
        for b in (1, ZOO_BATCH):
            xb = x[:b]
            times = []
            for _ in range(3):
                before = counts()
                t0 = time.perf_counter()
                out = net.output(xb)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                kind = net._infer_fn.last
                d = {k: v - before[k] for k, v in counts().items()}
                per_call.append((b, kind, d))
            outs[b] = out
            with disable_graphs():
                eager = net.output(xb)
            out_rec[f"B{b}"] = {
                "replay_equals_eager": bool(torch.equal(out, eager)),
                "wall_ms_replayed": times[-1] * 1e3,
                "samples_per_s": b / times[-1],
                "device_ms": device_ms(lambda: net.output(xb), iters=5),
                "finite": bool(torch.isfinite(out).all())}
    out_total = {}
    for b, kind, d in per_call:
        for k, v in d.items():
            out_total[k] = out_total.get(k, 0) + v
        if kind in ("eager", "capture") and (
                d["bn_act"] != 22 or d["bn_stats"] or d["bn_bwd_dx"]):
            failed.append(f"yolo2 output B{b} {kind}: K3 launches {d}")
    # a replay runs its capture's kernels: count each at the capture's
    captured = {b: d for b, kind, d in per_call if kind == "capture"}
    for b, kind, d in per_call:
        if kind == "replay":
            for k, v in captured[b].items():
                out_total[k] += v
    # against the plain BN path (fused off), the same params
    _set_fused(net, False)
    net._infer_fn = None
    with torch.no_grad():
        plain = {b: net.output(x[:b]) for b in (1, ZOO_BATCH)}
    _set_fused(net, "auto")
    net._infer_fn = None
    plain_err = max((outs[b] - plain[b]).abs().max().item() for b in plain)
    # K3 at every shape output() handed it, held here
    seen = sorted(set(cases), key=str)
    held = {}
    for dt, n, c, act in seen:
        if (dt, n, c, act) in k3_checked:
            continue
        held[f"{str(dt)[6:]} N{n} C{c} {act}"] = check_k3(
            fo, dt, n, c, gen, acts=(act,), time_it=False)["max_abs_err"]
    big = max(seen, key=lambda s: s[1] * s[2])
    timed = check_k3(fo, big[0], big[1], big[2], gen, acts=(big[3],),
                     hw=int(round(math.sqrt(big[1] // ZOO_BATCH))))
    timed = {"shape": f"{str(big[0])[6:]} N{big[1]} C{big[2]} {big[3]}",
             **{k: timed["bn_act"][k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "max_abs_err")}}
    # detections on the B8 raw volume (the head's pre-activation)
    layer = net.conf.nodes["out"].op
    t0 = time.perf_counter()
    with torch.no_grad():
        _, pre, _ = net._forward(net.params, net.states, {"in": x},
                                 train=False, rng=None,
                                 stop_at_output_preact=True)
        dets = get_predicted_objects(layer, pre["out"], threshold=0.5)
    kept = [nms(d, 0.45) for d in dets]
    det_s = time.perf_counter() - t0
    torch.backends.cudnn.deterministic = det
    out_rec.update({
        "k3_launches_by_call": [f"B{b} {kind}: {d['bn_act']}"
                                for b, kind, d in per_call],
        "launches": {k: v for k, v in out_total.items() if v},
        "max_abs_err_vs_plain_bn": plain_err,
        "k3_cases": [f"{str(dt)[6:]} N{n} C{c} {a}" for dt, n, c, a in seen],
        "k3_held_here": held, "k3_timed": timed,
        "peak_alloc_gib": torch.cuda.max_memory_allocated() / 2**30,
        "detections_before_nms": [len(d) for d in dets],
        "detections_after_nms": [len(k) for k in kept],
        "decode_nms_s": det_s})
    log(f"yolo2 output (seeded weights, the BNs fused=True: K3 bn_act): "
        f"{json.dumps(out_rec)}")
    if not all(r["replay_equals_eager"] and r["finite"]
               for k, r in out_rec.items() if k.startswith("B")):
        failed.append("yolo2 output: replayed != eager or not finite")
    if not plain_err <= ATOL[torch.float32]:
        failed.append(f"yolo2 output vs plain BN: {plain_err}")
    if not sum(len(k) for k in kept):
        failed.append("yolo2: no detection after nms")
    del net
    gc.collect()
    torch.cuda.empty_cache()
    return ({"zoo_yolo2_fit": train_total, "zoo_yolo2_output": out_total},
            {"fit": rec, "output": out_rec})


def _attn_conf(dtype):
    from deeplearning4j_tpu_torch import nn
    from deeplearning4j_tpu_torch.train import Adam
    b = nn.NeuralNetConfiguration.builder().seed(19).updater(Adam(1e-3))
    if dtype == torch.bfloat16:
        b.data_type(torch.float32, torch.bfloat16)
    return (b.list()
            .layer(nn.SelfAttentionLayer(n_out=ATTN_C, n_heads=ATTN_H,
                                         is_causal=True, impl="pallas"))
            .layer(nn.RnnOutputLayer(n_out=ATTN_CLASSES,
                                     activation="softmax", loss="mcxent"))
            .build())


def zoo_attention(fa, pa, fo, gen, failed):
    """Phase 19 (b): a MultiLayerNetwork with ``SelfAttentionLayer(n_out
    512, n_heads 8, impl="pallas")``, causal, T 2048 B8, trained
    replayed and eager in f32 (K1, dQ and dK/dV on the narrow split-TF32
    kernels) and under ``compute_dtype=torch.bfloat16`` (the
    tensor-core ones); each kernel launched once a step on its own route's
    family and on no other; each held against its plain version at the
    path's shape (f32 timed)."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    counts = lambda: path_counts(fa, pa, fo)    # noqa: E731
    rng = np.random.default_rng(19)
    x = torch.as_tensor(rng.standard_normal((ATTN_B, ATTN_T, ATTN_C))
                        .astype(np.float32), device="cuda")
    y = torch.nn.functional.one_hot(torch.as_tensor(rng.integers(
        0, ATTN_CLASSES, (ATTN_B, ATTN_T)), device="cuda"),
        ATTN_CLASSES).float()
    ds = DataSet(x, y)
    d = ATTN_C // ATTN_H
    paths, recs, held = {}, {}, {}
    for dtype, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        net, rec, total = _zoo_ways(
            f"attention net {key} B{ATTN_B} T{ATTN_T} C{ATTN_C} "
            f"H{ATTN_H} (D {d}) causal", lambda dt=dtype: MultiLayerNetwork(
                _attn_conf(dt)).init((ATTN_T, ATTN_C)), ds, counts, failed)
        del net
        per = rec["launches_per_step"]
        for kernel, name in FLASH_NAMES.items():
            fam = FAMILY_KEYS[fa.route(d, dtype, kernel)]
            others = {f"{name}_{f}" for f in FAMILY_KEYS.values()} \
                - {f"{name}_{fam}"}
            if fam == "tf32x3":
                fam = "tf32x3_narrow"  # the narrow kernel's own count
            if per.get(name) != 1 or per.get(f"{name}_{fam}") != 1 \
                    or any(per.get(o) for o in others):
                failed.append(f"attention {key}: {name} not launched once "
                              f"a step on {fam} alone ({per})")
        paths[f"zoo_attention_{key}"] = total
        recs[key] = rec
        time_it = dtype == torch.float32
        held[key] = {"fwd": check_flash(fa, dtype, ATTN_B, ATTN_T, gen,
                                        h=ATTN_H, d=d, time_it=time_it),
                     "bwd": check_flash_bwd(fa, dtype, ATTN_B, ATTN_T, True,
                                            gen, h=ATTN_H, d=d,
                                            time_it=time_it)}
        gc.collect()
        torch.cuda.empty_cache()
    return paths, recs, held


class _Bottleneck(torch.nn.Module):
    """torchvision's ResNet-50 bottleneck, written out (no torchvision on
    the card's machine)."""

    def __init__(self, cin, mid, cout, stride):
        super().__init__()
        nn = torch.nn
        self.conv1 = nn.Conv2d(cin, mid, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(mid)
        self.conv2 = nn.Conv2d(mid, mid, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(mid)
        self.conv3 = nn.Conv2d(mid, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.down = None
        if stride != 1 or cin != cout:
            self.down = nn.Sequential(nn.Conv2d(cin, cout, 1, stride,
                                                bias=False),
                                      nn.BatchNorm2d(cout))

    def forward(self, x):
        r = torch.relu
        out = r(self.bn1(self.conv1(x)))
        out = r(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return r(out + (x if self.down is None else self.down(x)))


class ResNet50Module(torch.nn.Module):
    """ResNet-50 (ImageNet, 1000 classes) as plain ``torch.nn`` modules."""

    def __init__(self):
        super().__init__()
        nn = torch.nn
        self.stem = nn.Sequential(nn.Conv2d(3, 64, 7, 2, 3, bias=False),
                                  nn.BatchNorm2d(64), nn.ReLU(),
                                  nn.MaxPool2d(3, 2, 1))
        blocks, cin = [], 64
        for n, mid, cout, stride in ((3, 64, 256, 1), (4, 128, 512, 2),
                                     (6, 256, 1024, 2), (3, 512, 2048, 2)):
            for i in range(n):
                blocks.append(_Bottleneck(cin, mid, cout,
                                          stride if i == 0 else 1))
                cin = cout
        self.blocks = nn.Sequential(*blocks)
        self.fc = nn.Linear(2048, 1000)

    def forward(self, x):
        h = self.blocks(self.stem(x))
        return self.fc(torch.flatten(torch.mean(h, dim=(2, 3),
                                                keepdim=True), 1))


@contextlib.contextmanager
def _onnx_stub():
    """The TorchScript exporter imports ``onnx`` only to splice in
    custom-function protos, which this model has none of; the card's
    machine has no onnx package, so an empty stub stands in while the
    model is exported (the importer reads the wire format itself)."""
    import types
    had = sys.modules.get("onnx")
    if had is None:
        stub = types.ModuleType("onnx")
        stub.load_model_from_string = lambda b: types.SimpleNamespace(
            graph=types.SimpleNamespace(node=()))
        sys.modules["onnx"] = stub
    try:
        yield
    finally:
        if had is None:
            sys.modules.pop("onnx", None)


def zoo_onnx(fa, pa, fo, failed):
    """Phase 19 (c): ResNet-50 (plain torch modules, seeded weights and BN
    statistics) exported to ONNX at B1 3×224×224 (opset 13, the
    TorchScript exporter), imported with ``import_onnx`` into the port's
    SameDiff on the card and served at B1 and B32: held to the module's
    own output on the card (f32, TF32 off), replayed = eager, import
    seconds, wall and device ms a call, no hand-written kernel."""
    import io
    from deeplearning4j_tpu_torch import disable_graphs
    from deeplearning4j_tpu_torch.autodiff import import_onnx
    torch.manual_seed(19)
    model = ResNet50Module().eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0.0, 0.1)
                m.running_mean.normal_(0.0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    t0 = time.perf_counter()
    buf = io.BytesIO()
    with _onnx_stub(), torch.no_grad():
        try:
            torch.onnx.export(model, torch.zeros(1, 3, ONNX_HW, ONNX_HW),
                              buf, opset_version=13, dynamo=False,
                              input_names=["input"], output_names=["logits"])
        except Exception as e:
            raise SystemExit(f"onnx export failed on this torch "
                             f"({torch.__version__}): {e!r}") from e
    export_s = time.perf_counter() - t0
    data = buf.getvalue()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sd, outs = import_onnx(data)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    model = model.cuda()
    rng = np.random.default_rng(19)
    before = path_counts(fa, pa, fo)
    rec = {"onnx_bytes": len(data), "export_s": export_s,
           "import_s": import_s, "nodes": len(sd._vars)}
    for b in ONNX_BATCHES:
        xb = rng.random((b, 3, ONNX_HW, ONNX_HW), np.float32)
        feeds = {"input": torch.as_tensor(xb, device="cuda")}
        got = [sd.eval(outs[0], feeds) for _ in range(3)]
        with disable_graphs():
            eager = sd.eval(outs[0], feeds)
        with torch.no_grad():
            want = model(feeds["input"])
        run = sd.runner(outs[0], feeds)
        err = (got[-1] - want).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        t0 = time.perf_counter()
        for _ in range(5):
            sd.eval(outs[0], feeds)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 5
        rec[f"B{b}"] = {
            "max_abs_err_vs_module": err, "module_logit_scale": scale,
            "replay_equals_eager": bool(torch.equal(got[-1], eager)),
            "calls": dict(run.compiled.calls) if run.compiled else None,
            "wall_ms": wall * 1e3, "samples_per_s": b / wall,
            "device_ms": device_ms(lambda: sd.eval(outs[0], feeds),
                                   iters=5),
            "module_device_ms": device_ms(lambda: model(feeds["input"]),
                                          iters=5)}
        if not err <= 1e-4 * scale:
            failed.append(f"onnx resnet50 B{b}: error {err} vs the module "
                          f"(scale {scale})")
        if not rec[f"B{b}"]["replay_equals_eager"]:
            failed.append(f"onnx resnet50 B{b}: replayed != eager")
    after = path_counts(fa, pa, fo)
    launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    rec["launches"] = launched
    if launched:
        failed.append(f"onnx resnet50 launched {launched}")
    log(f"onnx resnet50 (import_onnx, SameDiff on the card, f32): "
        f"{json.dumps(rec)}")
    del sd, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"zoo_onnx_resnet50": {k: after[k] - before[k]
                                  for k in after}}, rec


def zoo_phase(fa, pa, fo, fl, smi, gen, k3_checked=frozenset()):
    """Phase 19: the layer and zoo breadth and the ONNX importer on the
    card — YOLO2 trained and served (K3 in ``output()``), the DL4J
    attention layer trained through the flash kernels in f32 and bf16,
    ResNet-50 imported from ONNX and served. Returns (launch counts by
    path, records, the flash checks at the attention path's shape)."""
    reset_all(fa, pa, fo, fl)
    failed = []
    t_phase = time.perf_counter()
    log(f"phase 19 on {smi}: TF32 matmuls "
        f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN TF32 "
        f"{torch.backends.cudnn.allow_tf32}")
    paths, recs = {}, {}
    t0 = time.perf_counter()
    p, recs["yolo2"] = zoo_yolo2(fa, pa, fo, gen, k3_checked, failed)
    paths.update(p)
    recs["yolo2_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    p, recs["attention"], held = zoo_attention(fa, pa, fo, gen, failed)
    paths.update(p)
    recs["attention_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    p, recs["onnx"] = zoo_onnx(fa, pa, fo, failed)
    paths.update(p)
    recs["onnx_s"] = time.perf_counter() - t0
    log(f"phase 19 host seconds: yolo2 {recs['yolo2_s']:.1f}, attention "
        f"{recs['attention_s']:.1f}, onnx {recs['onnx_s']:.1f}, all "
        f"{time.perf_counter() - t_phase:.1f}")
    log(f"phase 19 launches by path: "
        f"{json.dumps({k: {n: v for n, v in c.items() if v} for k, c in paths.items()})}")
    if failed:
        raise SystemExit(f"phase 19: {failed}")
    return paths, recs, held


# ---------------------------------------------------------------- phase 20

IMPORT_BATCH = 32                       # the Keras ResNet50's batch
IMPORT_HW = 224                         # its published input (224x224x3)
IMPORT_BNS = 53                         # its BatchNormalization layers
IMPORT_STEPS = 3                        # eager, capture, replay
IMPORT_LR = 1e-2                        # Keras SGD's default
CHARNN_ZIP_STEPS = 2                    # fitted before the zip is written
SDL_BATCH, SDL_STEPS = 64, 5            # the SameDiffLayer MLN's fit
KERAS_RESNET50 = (Path(__file__).resolve().parent / "tests"
                  / "torch_keras_resnet50.json")

# The layout Keras's legacy .h5 save writes (through h5py, libver
# "earliest"): superblock version 0, groups as symbol tables (a version-1
# B-tree over symbol table nodes, names in a local heap), version-1 object
# headers, contiguous little-endian datasets, and string attributes as
# variable-length UTF-8 strings in one global heap collection. The card
# has no h5py: phase 20 writes its Keras file with this.
_H5_UNDEF = b"\xff" * 8
_H5_LEAF_K = 4                          # a symbol table node: 2K entries
_H5_GCOL_MIN = 4096                     # HDF5's least heap collection


class H5Group:
    """A group to write: ``attrs`` (name → str, list of str, or a numeric
    numpy array or scalar) and ``members`` (name → H5Group or numpy
    array)."""

    def __init__(self, attrs=None, members=None):
        self.attrs = dict(attrs or {})
        self.members = dict(members or {})


def _h5_pad(b, n=8):
    return b + b"\0" * (-len(b) % n)


def _h5_dtype_msg(dt):
    """A datatype message for a little-endian numeric numpy dtype."""
    import struct
    dt = np.dtype(dt)
    if dt.kind == "f":
        sign, mant, exp, bias = {2: (15, 10, 5, 15), 4: (31, 23, 8, 127),
                                 8: (63, 52, 11, 1023)}[dt.itemsize]
        return (bytes([0x11, 0x20, sign, 0]) + struct.pack("<I", dt.itemsize)
                + struct.pack("<HHBBBBI", 0, 8 * dt.itemsize, mant, exp, 0,
                              mant, bias))
    if dt.kind in "iu":
        return (bytes([0x10, 0x08 if dt.kind == "i" else 0, 0, 0])
                + struct.pack("<IHH", dt.itemsize, 0, 8 * dt.itemsize))
    raise ValueError(f"the HDF5 writer has no datatype for {dt}")


def _h5_vlen_str_msg():
    """Variable-length UTF-8 string, over a 1-byte unsigned base."""
    import struct
    base = bytes([0x10, 0, 0, 0]) + struct.pack("<IHH", 1, 0, 8)
    return bytes([0x19, 0x01, 0x01, 0]) + struct.pack("<I", 16) + base


def _h5_space_msg(shape):
    import struct
    return (bytes([1, len(shape), 0, 0]) + b"\0" * 4
            + b"".join(struct.pack("<Q", d) for d in shape))


class _H5Out:
    def __init__(self):
        self.buf = bytearray(96)        # the superblock, written last
        self.heap = {}                  # string → global heap index
        self.gcol = None

    def alloc(self, b):
        self.buf += b"\0" * (-len(self.buf) % 8)
        at = len(self.buf)
        self.buf += b
        return at

    def header(self, msgs):
        """A version-1 object header of (type, data) messages."""
        import struct
        body = b"".join(struct.pack("<HHB3x", t, len(_h5_pad(d)), 0)
                        + _h5_pad(d) for t, d in msgs)
        return self.alloc(struct.pack("<BBHII", 1, 0, len(msgs), 1,
                                      len(body)) + b"\0" * 4 + body)

    def attr_msg(self, name, value):
        import struct
        if isinstance(value, str) or (isinstance(value, (list, tuple))
                                      and all(isinstance(s, str)
                                              for s in value)):
            items = [value] if isinstance(value, str) else list(value)
            shape = () if isinstance(value, str) else (len(items),)
            dtype = _h5_vlen_str_msg()
            data = b"".join(struct.pack("<IQI", len(s.encode("utf-8")),
                                        self.gcol, self.heap[s])
                            for s in items)
        else:
            arr = np.array(value, order="C")
            arr = arr.astype(arr.dtype.newbyteorder("<"))
            shape, dtype = arr.shape, _h5_dtype_msg(arr.dtype)
            data = arr.tobytes()
        nm = name.encode("utf-8") + b"\0"
        space = _h5_space_msg(shape)
        return (0x0C, struct.pack("<BBHHH", 1, 0, len(nm), len(dtype),
                                  len(space))
                + _h5_pad(nm) + _h5_pad(dtype) + _h5_pad(space) + data)

    def dataset(self, arr):
        import struct
        arr = np.array(arr, order="C")
        arr = arr.astype(arr.dtype.newbyteorder("<"))
        at = self.alloc(arr.tobytes()) if arr.size else None
        layout = (bytes([3, 1]) + (_H5_UNDEF if at is None
                                   else struct.pack("<Q", at))
                  + struct.pack("<Q", arr.nbytes))
        return self.header([(0x01, _h5_space_msg(arr.shape)),
                            (0x03, _h5_dtype_msg(arr.dtype)),
                            (0x05, bytes([2, 1, 2, 0])),    # fill: none
                            (0x08, layout)])

    def group(self, g, internal_k):
        """Write ``g`` and everything under it; returns (header, B-tree,
        local heap) addresses."""
        import struct
        names = sorted(g.members, key=lambda s: s.encode("utf-8"))
        addrs = [self.group(g.members[n], internal_k)[0]
                 if isinstance(g.members[n], H5Group)
                 else self.dataset(g.members[n]) for n in names]
        heap = bytearray(8)             # offset 0: the empty name
        offs = []
        for n in names:
            offs.append(len(heap))
            heap += _h5_pad(n.encode("utf-8") + b"\0")
        free = len(heap)
        heap += struct.pack("<QQ", 1, 16)   # one free block, the list's end
        data = self.alloc(bytes(heap))
        lheap = self.alloc(b"HEAP\0\0\0\0" + struct.pack(
            "<QQQ", len(heap), free, data))
        entry = 2 * 8 + 24
        snods, keys = [], [0]
        for i in range(0, len(names), 2 * _H5_LEAF_K):
            chunk = range(i, min(i + 2 * _H5_LEAF_K, len(names)))
            body = b"".join(struct.pack("<QQII16x", offs[j], addrs[j], 0, 0)
                            for j in chunk)
            body += b"\0" * (2 * _H5_LEAF_K * entry - len(body))
            snods.append(self.alloc(b"SNOD\x01\x00" + struct.pack(
                "<H", len(chunk)) + body))
            keys.append(offs[chunk[-1]])
        tree = b"TREE\x00\x00" + struct.pack("<H", len(snods)) + \
            _H5_UNDEF + _H5_UNDEF
        for i, s in enumerate(snods):
            tree += struct.pack("<QQ", keys[i], s)
        tree += struct.pack("<Q", keys[len(snods)])
        tree += b"\0" * (8 + 16 + (2 * internal_k + 1) * 8
                         + 2 * internal_k * 8 - len(tree))
        btree = self.alloc(tree)
        msgs = [(0x11, struct.pack("<QQ", btree, lheap))]
        msgs += [self.attr_msg(k, v) for k, v in g.attrs.items()]
        return self.header(msgs), btree, lheap


def write_h5(path, root: H5Group):
    """Write the tree under ``root`` as an HDF5 file at ``path``: every
    group is one B-tree node over full symbol table nodes (the superblock's
    internal K is raised to hold the widest group)."""
    import struct

    def widest(g):
        n = -(-len(g.members) // (2 * _H5_LEAF_K))
        return max([n] + [widest(m) for m in g.members.values()
                          if isinstance(m, H5Group)])

    def strings(g):
        for v in g.attrs.values():
            for s in [v] if isinstance(v, str) else (
                    v if isinstance(v, (list, tuple)) else []):
                out.heap.setdefault(s, len(out.heap) + 1)
        for m in g.members.values():
            if isinstance(m, H5Group):
                strings(m)

    internal_k = max(16, -(-widest(root) // 2))
    out = _H5Out()
    strings(root)
    # the global heap first: every string attribute value, then free space
    body = b""
    for i, s in enumerate(out.heap, start=1):
        raw = s.encode("utf-8")
        body += struct.pack("<HH4xQ", i, 1, len(raw)) + _h5_pad(raw)
    size = max(_H5_GCOL_MIN, 16 + len(body) + 16)
    body += struct.pack("<HH4xQ", 0, 0, size - 16 - len(body))
    out.gcol = out.alloc(b"GCOL\x01\0\0\0" + struct.pack("<Q", size) + body
                         + b"\0" * (size - 16 - len(body)))
    hdr, btree, lheap = out.group(root, internal_k)
    buf = out.buf
    buf[:96] = (b"\x89HDF\r\n\x1a\n" + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                + struct.pack("<HHI", _H5_LEAF_K, internal_k, 0)
                + struct.pack("<Q", 0) + _H5_UNDEF
                + struct.pack("<Q", len(buf)) + _H5_UNDEF
                + struct.pack("<QQII", 0, hdr, 1, 0)
                + struct.pack("<QQ", btree, lheap))
    with open(path, "wb") as fh:
        fh.write(buf)


def _keras_inbound(kc):
    """The inbound layer names of a Keras 3 functional layer config."""
    out = []

    def walk(o):
        if isinstance(o, dict):
            if o.get("class_name") == "__keras_tensor__":
                out.append(o["config"]["keras_history"][0])
                return
            for v in o.values():
                walk(v)
        elif isinstance(o, list):
            for v in o:
                walk(v)
    walk(kc.get("inbound_nodes", []))
    return out


_KERAS_WEIGHTLESS = {"ZeroPadding2D", "Activation", "MaxPooling2D", "Add",
                     "GlobalAveragePooling2D"}


def keras_resnet50_weights(layers, seed):
    """{layer name: [(variable, array)]} in Keras's variable order for the
    ResNet50 config's layers, drawn from ``seed``: He-normal conv kernels,
    small biases, BN gamma about 1, beta and moving mean about 0, moving
    variance in [0.5, 1.5] (positive), a Glorot-scaled Dense."""
    rng = np.random.default_rng(seed)
    chans, out = {}, {}

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    for kc in layers:
        cls, c = kc["class_name"], kc["config"]
        name = c["name"]
        ins = [chans[n] for n in _keras_inbound(kc)]
        ws = []
        if cls == "InputLayer":
            chans[name] = c["batch_shape"][-1]
        elif cls == "Conv2D":
            kh, kw = c["kernel_size"]
            cin, cout = ins[0], c["filters"]
            ws.append(("kernel", normal((kh, kw, cin, cout),
                                        math.sqrt(2.0 / (kh * kw * cin)))))
            if c.get("use_bias", True):
                ws.append(("bias", normal((cout,), 0.01)))
            chans[name] = cout
        elif cls == "BatchNormalization":
            n = ins[0]
            ws += [("gamma", (1.0 + normal((n,), 0.1))),
                   ("beta", normal((n,), 0.1)),
                   ("moving_mean", normal((n,), 0.1)),
                   ("moving_variance",
                    rng.uniform(0.5, 1.5, n).astype(np.float32))]
            chans[name] = n
        elif cls == "Dense":
            cin, cout = ins[0], c["units"]
            ws += [("kernel", normal((cin, cout),
                                     math.sqrt(2.0 / (cin + cout)))),
                   ("bias", normal((cout,), 0.01))]
            chans[name] = cout
        elif cls in _KERAS_WEIGHTLESS:
            chans[name] = ins[0]
        else:
            raise ValueError(f"Keras ResNet50 writer: no weights rule for "
                             f"{cls} ({name})")
        out[name] = ws
    return out


def write_keras_resnet50(path, hw=IMPORT_HW, seed=20):
    """The Keras ResNet50 as a legacy .h5 at ``path``: the committed
    ``model_config`` and ``training_config`` that Keras 3.13.1 writes for
    ``ResNet50(weights=None)`` compiled with SGD and categorical
    cross-entropy (its input set to ``hw``×``hw``×3), the weights drawn
    from ``seed`` in Keras's groups (``model_weights/<layer>/<layer>/
    <variable>``, ``layer_names`` and ``weight_names`` as Keras writes
    them). Returns the model config."""
    spec = json.loads(KERAS_RESNET50.read_text())
    cfg = spec["model_config"]
    layers = cfg["config"]["layers"]
    for kc in layers:
        if kc["class_name"] == "InputLayer":
            kc["config"]["batch_shape"] = [None, hw, hw, 3]
    weights = keras_resnet50_weights(layers, seed)
    meta = {"backend": spec["backend"], "keras_version": spec["keras_version"]}
    groups = {}
    for name, ws in weights.items():
        groups[name] = H5Group(
            {"weight_names": [f"{name}/{v}" for v, _ in ws]},
            {name: H5Group(members=dict(ws))} if ws else {})
    write_h5(path, H5Group(
        {**meta, "model_config": json.dumps(cfg),
         "training_config": json.dumps(spec["training_config"])},
        {"model_weights": H5Group(
            {**meta, "layer_names": [kc["config"]["name"] for kc in layers]},
            groups)}))
    return cfg


def keras_finetune_net(src, lr=IMPORT_LR):
    """The imported graph made trainable as a DL4J user does it: its
    ``predictions`` Dense becomes an OutputLayer (softmax, MCXENT) with
    the imported weights, through ``TransferLearning.GraphBuilder`` with
    SGD (Keras's own default rate)."""
    from deeplearning4j_tpu_torch import nn
    from deeplearning4j_tpu_torch.train import Sgd
    head = src.conf.nodes["predictions"]
    w = src.params["predictions"]["W"]
    net = (nn.TransferLearning.GraphBuilder(src)
           .fine_tune_configuration(nn.FineTuneConfiguration(
               updater=Sgd(lr)))
           .remove_vertex_and_connections("predictions")
           .add_layer("predictions", nn.OutputLayer(
               n_in=w.shape[0], n_out=w.shape[1], activation="softmax",
               loss="mcxent"), *head.inputs)
           .set_outputs("predictions").build())
    with torch.no_grad():
        for k in ("W", "b"):
            net.params["predictions"][k].copy_(src.params["predictions"][k])
    return net


def _k3_held(fo, gen, seen, k3_checked):
    """Every K3 (dtype, N, C, activation) of ``seen`` not held yet, held
    against the plain versions here: the largest error by shape."""
    held = {}
    for dt, n, c, act in seen:
        if (dt, n, c, act) not in k3_checked:
            held[f"{str(dt)[6:]} N{n} C{c} {act}"] = check_k3(
                fo, dt, n, c, gen, acts=(act,), time_it=False)["max_abs_err"]
    return held


def import_resnet50(fa, pa, fo, gen, k3_checked, failed, tmp):
    """Phase 20 (b): the Keras ResNet50 written (seeded weights) and
    imported onto the card, its 53 BNs ``fused=True``; ``output()`` at B32
    f32 (eager, capture, replay: 53 ``bn_act`` a forward) against the eager
    call and the plain BN path; fine-tuned 3 steps through ``fit``,
    replayed and eager, bit for bit (53 launches a step of each K3
    kernel); the zoo's ResNet-50 at the same batch beside it."""
    from deeplearning4j_tpu_torch import disable_graphs
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.import_ import import_keras_model
    from deeplearning4j_tpu_torch.nn.layers.norm import BatchNormalization
    from deeplearning4j_tpu_torch.zoo.resnet import ResNet50
    counts = lambda: path_counts(fa, pa, fo)     # noqa: E731
    b = IMPORT_BATCH
    path = tmp / "resnet50.h5"
    rec = {}
    t0 = time.perf_counter()
    write_keras_resnet50(path)
    rec["write_h5_s"] = time.perf_counter() - t0
    rec["h5_bytes"] = path.stat().st_size
    t0 = time.perf_counter()
    net = import_keras_model(path)
    torch.cuda.synchronize()
    rec["import_s"] = time.perf_counter() - t0
    bns = [n for n, d in net.conf.nodes.items()
           if isinstance(d.op, BatchNormalization)]
    rec["batch_norms"] = len(bns)
    if len(bns) != IMPORT_BNS:
        failed.append(f"keras resnet50: {len(bns)} BNs imported")
    _set_fused(net, True)
    rng = np.random.default_rng(20)
    x = torch.as_tensor(rng.random((b, IMPORT_HW, IMPORT_HW, 3), np.float32),
                        device="cuda")
    y = torch.as_tensor(np.eye(1000, dtype=np.float32)[
        rng.integers(0, 1000, b)], device="cuda")
    torch.cuda.reset_peak_memory_stats()
    per_call = []
    with _k3_cases(fo) as cases:
        for _ in range(3):
            before = counts()
            out = net.output(x)
            torch.cuda.synchronize()
            per_call.append((net._infer_fn.last,
                             {k: v - before[k] for k, v in counts().items()}))
        with disable_graphs():
            eager = net.output(x)
    out_total = dict.fromkeys(per_call[0][1], 0)
    captured = {}
    for kind, d in per_call:
        if kind == "capture":
            captured = d
        for k in out_total:
            out_total[k] += captured[k] if kind == "replay" else d[k]
        if kind in ("eager", "capture") and (
                d["bn_act"] != IMPORT_BNS or d["bn_stats"]
                or d["bn_bwd_reduce"] or d["bn_bwd_dx"]):
            failed.append(f"keras resnet50 output {kind}: K3 launches {d}")
    if [k for k, _ in per_call] != ["eager", "capture", "replay"]:
        failed.append(f"keras resnet50 output ran "
                      f"{[k for k, _ in per_call]}")
    serve = {"replay_equals_eager": bool(torch.equal(out, eager)),
             "finite": bool(torch.isfinite(out).all()),
             "rows_sum_to_1": bool(torch.allclose(
                 out.sum(-1), torch.ones(b, device="cuda"), atol=1e-4)),
             "device_ms": device_ms(lambda: net.output(x), iters=5),
             "k3_launches_by_call": [f"{kind}: {d['bn_act']}"
                                     for kind, d in per_call],
             "peak_alloc_gib": torch.cuda.max_memory_allocated() / 2**30}
    _set_fused(net, False)
    net._infer_fn = None
    plain = net.output(x)
    serve["max_abs_err_vs_plain_bn"] = (out - plain).abs().max().item()
    if not (serve["replay_equals_eager"] and serve["finite"]
            and serve["rows_sum_to_1"]):
        failed.append(f"keras resnet50 output: {serve}")
    if not serve["max_abs_err_vs_plain_bn"] <= ATOL[torch.float32]:
        failed.append(f"keras resnet50 output vs plain BN: "
                      f"{serve['max_abs_err_vs_plain_bn']}")
    del net, out, eager, plain
    gc.collect()
    torch.cuda.empty_cache()

    def make_net():
        src = import_keras_model(path)
        _set_fused(src, True)
        return keras_finetune_net(src)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with _k3_cases(fo) as tcases:
            fnet, fit, fit_total = _zoo_ways(
                f"keras resnet50 fine-tune {IMPORT_HW}x{IMPORT_HW} B{b} f32",
                make_net, DataSet(x, y), counts, failed, steps=IMPORT_STEPS)
    finally:
        torch.backends.cudnn.deterministic = det
    step = fit["launches_per_step"]
    if any(step.get(k) != IMPORT_BNS for k in K3_LINES):
        failed.append(f"keras resnet50 fit: K3 launches a step {step}")
    del fnet
    gc.collect()
    torch.cuda.empty_cache()
    # the zoo's ResNet-50 (conv without bias, BN + ReLU fused in one
    # launch) at the same batch, f32, BNs fused=True
    znet = ResNet50(num_classes=1000).init()
    _set_fused(znet, True)
    zoo = {"output_device_ms": device_ms(lambda: znet.output(x), iters=5)}
    znet.fit([DataSet(x, y)] * IMPORT_STEPS)
    zoo["step_device_ms"] = profile_step(
        lambda: znet.fit([DataSet(x, y)]))["device_ms_per_step"]
    del znet
    gc.collect()
    torch.cuda.empty_cache()
    held = _k3_held(fo, gen, sorted(set(cases) | set(tcases), key=str),
                    k3_checked)
    rec.update({"output": serve, "fit": fit, "zoo_resnet50": zoo,
                "k3_held_here": held,
                "k3_cases": sorted({f"{str(dt)[6:]} N{n} C{c} {a}"
                                    for dt, n, c, a in set(cases)
                                    | set(tcases)})})
    log(f"keras resnet50 (seeded weights, B{b} f32, the BNs fused=True): "
        f"write {rec['write_h5_s']:.2f} s ({rec['h5_bytes']} bytes), import "
        f"{rec['import_s']:.2f} s, forward {serve['device_ms']:.3f} device ms"
        f" (zoo ResNet-50 {zoo['output_device_ms']:.3f}), step "
        f"{fit.get('device_ms_per_step', float('nan')):.3f} device ms (zoo "
        f"{zoo['step_device_ms']:.3f}); {json.dumps(rec)}")
    return {"import_resnet50_output": out_total,
            "import_resnet50_fit": fit_total}, rec


def import_charnn(fa, pa, fo, fl, gen, k4_checked, failed, tmp):
    """Phase 20 (c): the zoo's char-RNN (T60, vocab 77, 2×GravesLSTM 256,
    Adam, f32, ``fused=True``) fitted 2 steps, written as an upstream DL4J
    zip with its Adam state, restored through ``load_model``'s
    auto-detection: its ``output()`` equal to the writer's bit for bit,
    its step 3 equal to the writer's step 3 (params, states and updater
    state); K4 on the cluster route, 2 launches a forward and a step."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.serde import (load_model,
                                                write_model_upstream_format)
    from deeplearning4j_tpu_torch.train import Adam
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    counts = lambda: path_counts(fa, pa, fo)     # noqa: E731
    b, t, v = CHARNN_BATCH, CHARNN_T, CHARNN_VOCAB
    rng = np.random.default_rng(20)
    eye = np.eye(v, dtype=np.float32)
    x = torch.as_tensor(eye[rng.integers(0, v, (b, t))], device="cuda")
    y = torch.as_tensor(eye[rng.integers(0, v, (b, t))], device="cuda")
    ds = DataSet(x, y)
    net = TextGenerationLSTM(num_classes=v, input_shape=(t, v),
                             units=CHARNN_H, updater=Adam(1e-3)).init()
    _set_lstm_fused(net, True)
    total = dict.fromkeys(counts(), 0)
    calls = []

    def run(tag, fn, kind_of):
        before = counts()
        got = fn()
        torch.cuda.synchronize()
        d = {k: n - before[k] for k, n in counts().items()}
        kind = kind_of()
        calls.append((tag, kind, d))
        return got, kind, d

    rec = {}
    with _k4_cases(fl) as cases:
        for i in range(CHARNN_ZIP_STEPS):
            run(f"fit {i + 1}", lambda: net.fit([ds]),
                lambda: net._step_fn.last)
        path = tmp / "charnn_upstream.zip"
        t0 = time.perf_counter()
        write_model_upstream_format(net, path, save_updater=True)
        rec["write_zip_s"] = time.perf_counter() - t0
        rec["zip_bytes"] = path.stat().st_size
        t0 = time.perf_counter()
        restored = load_model(path)
        rec["restore_s"] = time.perf_counter() - t0
        _set_lstm_fused(restored, True)
        out_r, _, _ = run("restored output", lambda: restored.output(x),
                          lambda: restored._infer_fn.last)
        out_w, _, _ = run("writer output", lambda: net.output(x),
                          lambda: net._infer_fn.last)
        loss_w, _, _ = run("writer fit 3", lambda: net.fit([ds]),
                           lambda: net._step_fn.last)
        loss_r, _, _ = run("restored fit 3", lambda: restored.fit([ds]),
                           lambda: restored._step_fn.last)
        torch.cuda.synchronize()
    captured = {}
    for tag, kind, d in calls:
        if kind == "capture":
            captured[tag.split()[0]] = d
        src = captured["fit"] if kind == "replay" else d
        for k in total:
            total[k] += src[k]
        if kind != "replay" and (d["fused_lstm"] != 2
                                 or d["fused_lstm_cluster"] != 2):
            failed.append(f"charnn upstream {tag} ({kind}): K4 {d}")
    diff = first_diff(_all_tensors(net), _all_tensors(restored))
    rec.update({
        "restored_type": type(restored).__name__,
        "restored_step_count": restored._step_count,
        "output_equal": bool(torch.equal(out_r, out_w)),
        "step3_losses": [loss_w, loss_r],
        "step3_equal": diff is None and loss_w == loss_r,
        "calls": [f"{tag} ({kind}): K4 {d['fused_lstm']} "
                  f"cluster {d['fused_lstm_cluster']}"
                  for tag, kind, d in calls],
        "k4_cases": sorted({f"{str(dt)[6:]} B{bb} H{h} {r}"
                            for dt, bb, h, r in cases})})
    if not rec["output_equal"]:
        failed.append("charnn upstream: restored output != the writer's")
    if not rec["step3_equal"]:
        failed.append(f"charnn upstream: step 3 differs (leaf {diff}, "
                      f"losses {loss_w} vs {loss_r})")
    held = {}
    for dt, bb, h, route in sorted(set(cases), key=str):
        if (dt, bb, h, route) not in k4_checked:
            held[f"{str(dt)[6:]} B{bb} H{h} {route}"] = check_lstm(
                fl, dt, bb, t, h, gen, route=route, grads=True)[
                    "max_abs_err"]
    rec["k4_held_here"] = held
    log(f"charnn upstream zip (B{b} T{t} H{CHARNN_H} V{v}, f32, Adam): "
        f"{json.dumps(rec)}")
    del net, restored
    gc.collect()
    torch.cuda.empty_cache()
    return {"import_charnn": total}, rec


def import_samediff_layer(failed):
    """Phase 20 (d): an MLN of a SameDiffLayer (dense + ReLU as a user
    graph) and an OutputLayer, fitted 5 steps replayed and eager: equal
    bit for bit, no retrace after warm."""
    from deeplearning4j_tpu_torch import disable_graphs, nn
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.train import Adam

    @dataclasses.dataclass
    class SDDense(nn.SameDiffLayer):
        n_in: int = 784
        n_out: int = 256

        def define_parameters(self, p):
            p.add_weight_param("W", self.n_in, self.n_out)
            p.add_bias_param("b", self.n_out)

        def define_layer(self, sd, x, params, mask=None):
            return sd.nn.relu(sd.nn.linear(x, params["W"], params["b"]))

    rng = np.random.default_rng(20)
    x = torch.as_tensor(rng.standard_normal((SDL_BATCH, 784), np.float32),
                        device="cuda")
    y = torch.as_tensor(np.eye(10, dtype=np.float32)[
        rng.integers(0, 10, SDL_BATCH)], device="cuda")
    runs = {}
    for graphs in (True, False):
        conf = (nn.NeuralNetConfiguration.builder().seed(20)
                .updater(Adam(1e-3)).list()
                .layer(SDDense())
                .layer(nn.OutputLayer(n_in=256, n_out=10,
                                      activation="softmax", loss="mcxent"))
                .build())
        net = nn.MultiLayerNetwork(conf).init((784,))
        sentinel = net._train_sentinel()
        kinds, losses = [], []
        with contextlib.nullcontext() if graphs else disable_graphs():
            for i in range(SDL_STEPS):
                losses.append(net.fit(DataSet(x, y)))
                kinds.append(net._step_fn.last)
                if i == 1:
                    sentinel.mark_warm()
            out = net.output(x)
        runs[graphs] = (losses, kinds, _all_tensors(net), out,
                        sentinel.retraces_after_warm)
    diff = first_diff(runs[False][2], runs[True][2])
    rec = {"losses": runs[True][0], "step_kinds": runs[True][1],
           "replay_equals_eager": diff is None
           and runs[True][0] == runs[False][0]
           and bool(torch.equal(runs[True][3], runs[False][3])),
           "retraces_after_warm": runs[True][4]}
    log(f"SameDiffLayer MLN (B{SDL_BATCH} 784-256-10, Adam): "
        f"{json.dumps(rec)}")
    if rec["step_kinds"] != ["eager", "capture"] + ["replay"] * (
            SDL_STEPS - 2) or not rec["replay_equals_eager"] \
            or rec["retraces_after_warm"]:
        failed.append(f"SameDiffLayer MLN: {rec}")
    return rec


def import_phase(fa, pa, fo, fl, smi, gen, k3_checked=frozenset(),
                 k4_checked=frozenset()):
    """Phase 20: a DL4J user's import path on the card — the Keras
    ResNet50 written at its published shape, imported, served and
    fine-tuned (K3), the zoo's char-RNN through an upstream DL4J zip and
    back (K4), a SameDiffLayer MLN fitted. Returns (launch counts by path,
    records)."""
    import tempfile
    reset_all(fa, pa, fo, fl)
    failed, paths, recs = [], {}, {}
    t_phase = time.perf_counter()
    log(f"phase 20 on {smi}: TF32 matmuls "
        f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN TF32 "
        f"{torch.backends.cudnn.allow_tf32}")
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        t0 = time.perf_counter()
        p, recs["resnet50"] = import_resnet50(fa, pa, fo, gen, k3_checked,
                                              failed, tmp)
        paths.update(p)
        recs["resnet50_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        p, recs["charnn"] = import_charnn(fa, pa, fo, fl, gen, k4_checked,
                                          failed, tmp)
        paths.update(p)
        recs["charnn_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    recs["samediff_layer"] = import_samediff_layer(failed)
    recs["samediff_layer_s"] = time.perf_counter() - t0
    log(f"phase 20 host seconds: keras resnet50 {recs['resnet50_s']:.1f}, "
        f"charnn {recs['charnn_s']:.1f}, SameDiffLayer "
        f"{recs['samediff_layer_s']:.1f}, all "
        f"{time.perf_counter() - t_phase:.1f}")
    log(f"phase 20 launches by path: "
        f"{json.dumps({k: {n: v for n, v in c.items() if v} for k, c in paths.items()})}")
    if failed:
        raise SystemExit(f"phase 20: {failed}")
    return paths, recs


def _values_equal(a, b):
    """Nested lists / numbers / arrays equal exactly."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return bool(np.array_equal(np.asarray(a), np.asarray(b)))
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            _values_equal(x, y) for x, y in zip(a, b))
    return a == b


# ---------------------------------------------------------------- phase 21

PARALLEL_STEPS = 5
MOE_EXPERTS = 8
RING_SHAPE = (8, 4096, 8, 64)           # B, T, H, D of the chunked ring
RING_CHUNKS = 4
RING_LM_BATCH = 8
RING_LOSS_ATOL = 1e-5                    # the reference's dry-run case K
DP_RANKS = 2
DP_RANK_TIMEOUT_S = 600
# (N, C, activation) of the two-rank K3 check: the global batch's rows of
# ResNet-50's first stage (B128 56×56, C 64) and of its last (B128 7×7).
# Smooth activations: a rounding of the statistics flips relu's mask on
# a pre-activation next to 0, which moves that element's dx by O(1)
# (1-3 elements of 12.8M at N401408 C64); the cross-rank sums do not
# depend on the activation
DP_BN_CASES = ((RESNET_BATCH * 56 * 56, 64, "identity"),
               (RESNET_BATCH * 7 * 7, 2048, "sigmoid"))
DP_BN_REL = 1e-5            # two ranks vs one K3 call, over the largest entry


def parallel_resnet(fa, pa, fo, checked):
    """(a) ResNet-50 B128 through ``ParallelWrapper(net, make_mesh(dp=1))``
    on an NCCL world of one that ``make_mesh`` starts itself: bf16,
    ``PARALLEL_STEPS`` steps replayed (the main path: K3's four kernels 53
    times each a step, counted from the capture; its BN sums all-reduced
    over the dp group, the all-reduce inside the graph) and eager (bit for
    bit equal); step 1 held to the plain path (BN ``fused=False``, eager,
    plain ``fit``) within phase 8's bars, the f32 grads too; wall and
    device ms a step beside plain ``fit``'s replayed kernel path (the dp
    machinery's cost at one rank). Returns the path's counts."""
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.parallel import make_mesh
    from deeplearning4j_tpu_torch.train import Momentum
    from deeplearning4j_tpu_torch.zoo.resnet import ResNet50

    mesh = make_mesh(dp=1)
    log(f"parallel: make_mesh(dp=1) started a world of "
        f"{dist.get_world_size()} over {dist.get_backend()} on "
        f"{mesh.device}")
    if dist.get_backend() != "nccl":
        raise SystemExit("parallel: the card's world of one is not NCCL")
    rng = np.random.default_rng(0)
    x = torch.as_tensor(
        rng.random((RESNET_BATCH, RESNET_HW, RESNET_HW, 3), np.float32),
        device="cuda")
    y = torch.as_tensor(np.eye(1000, dtype=np.float32)[
        rng.integers(0, 1000, RESNET_BATCH)], device="cuda")
    failed, seen, counts, records = [], set(), None, {}
    for dtype, n_steps, loss_atol, state_atol, grad_limit in (
            (torch.bfloat16, PARALLEL_STEPS, RESNET_LOSS_ATOL,
             RESNET_STATE_REL_L2, None),
            (torch.float32, 1, RESNET_F32_LOSS_ATOL,
             RESNET_F32_STATE_REL_L2, RESNET_GRAD_REL_L2)):
        model = ResNet50(num_classes=1000, updater=Momentum(0.1, 0.9),
                         compute_dtype=torch.bfloat16
                         if dtype == torch.bfloat16 else None,
                         input_shape=(RESNET_HW, RESNET_HW, 3))
        runs = {}
        ways = [("dp1", True, n_steps, True, mesh),
                ("plain", False, 1, False, None)]
        if n_steps > 1:
            ways[1:1] = [("dp1_eager", True, n_steps, False, mesh),
                         ("fit", True, n_steps, True, None)]
        for path, fused, path_steps, graphs, m in ways:
            main = dtype == torch.bfloat16 and path == "dp1"
            if main:
                reset_all(fa, pa, fo)
            with _k3_cases(fo) as cases:
                net, rec, g, s1, final = _resnet_run(
                    model, fused, x, y, path_steps, fo, graphs, mesh=m,
                    profile=path in ("dp1", "fit") and n_steps > 1)
            seen |= set(cases)
            if main:
                counts = {**path_counts(fa, pa, fo), **{
                    k: sum(per[k] for per in rec["k3_launches_per_step"])
                    for k in k3_counts(fo)}}
                if not all(n == 53 for per in rec["k3_launches_per_step"]
                           for n in per.values()):
                    failed.append("K3 launch counts")
                if rec["step_kinds"] != ["eager", "capture",
                                         *["replay"] * (n_steps - 2)]:
                    failed.append("the dp step did not replay a graph")
            log(f"parallel resnet50 {path} (B{RESNET_BATCH} "
                f"{str(dtype)[6:]}, BN fused={fused}, "
                f"{'graph replays' if graphs else 'eager'}"
                f"{', ParallelWrapper dp=1' if m is not None else ''}): "
                f"{json.dumps(rec)}")
            runs[path] = (rec, g, s1, final)
            del net
            torch.cuda.empty_cache()
        tag = str(dtype)[6:]
        if "dp1_eager" in runs:
            (kr, *_, kf), (er, *_, ef) = runs["dp1"], runs["dp1_eager"]
            diff = first_diff(ef, kf)
            log(f"parallel resnet50 dp1 replays vs eager: losses equal "
                f"{kr['losses'] == er['losses']}, params, stats and trace "
                f"bit-identical {diff is None}; wall ms a step "
                f"{kr['wall_ms_per_step']:.2f} (plain fit, replayed "
                f"{runs['fit'][0]['wall_ms_per_step']:.2f}), device ms "
                f"{kr.get('device_ms_per_step')} (plain fit "
                f"{runs['fit'][0].get('device_ms_per_step')})")
            if diff is not None or kr["losses"] != er["losses"]:
                failed.append("replayed != eager")
            records.update(dp1=kr, fit=runs["fit"][0])
        kp = _step1(runs, "dp1", "plain")
        log(f"parallel resnet50 step 1, dp1 vs plain ({tag}): |loss delta| "
            f"{kp[0]:.3e} (limit {loss_atol}); running stats rel L2 max "
            f"{kp[1][0]:.3e} ({kp[1][2]}) (limit {state_atol}); grads rel "
            f"L2 median {kp[2][1]:.3e} max {kp[2][0]:.3e} ({kp[2][2]}) "
            f"(limit {grad_limit or 'none: not held'})")
        if not kp[0] <= loss_atol:
            failed.append(f"{tag} step-1 loss")
        if not kp[1][0] <= state_atol:
            failed.append(f"{tag} running stats")
        if grad_limit is not None and not kp[2][0] <= grad_limit:
            failed.append(f"{tag} step-1 grads")
        del runs
    unchecked = sorted(f"{str(dt)[6:]} N{n} C{c} {act}"
                       for dt, n, c, act in seen - checked)
    if unchecked:
        failed.append(f"K3 ran at {unchecked}, not held in phase 7")
    if failed:
        raise SystemExit(f"parallel resnet50 dp1: {failed}")
    return counts, records


def _dp_inputs():
    """Phase 8's batch: B128 224×224×3 from seed 0, and its labels."""
    rng = np.random.default_rng(0)
    x = rng.random((RESNET_BATCH, RESNET_HW, RESNET_HW, 3), np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, RESNET_BATCH)]
    return x, y


def _f32_resnet(fo):
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.train import Momentum
    from deeplearning4j_tpu_torch.zoo.resnet import ResNet50
    net = ComputationGraph(ResNet50(
        num_classes=1000, updater=Momentum(0.1, 0.9),
        input_shape=(RESNET_HW, RESNET_HW, 3)).conf())
    _set_fused(net, True)
    return net.init()


def _step1_of(net):
    """(grads: Momentum's trace after one step from v0 = 0, running
    stats), as name → CPU tensor."""
    grads = {f"{n}/{k}": t.detach().cpu() for n, p in
             net._opt_state[1][0]["trace"].items() for k, t in p.items()}
    states = {f"{n}/{k}": t.detach().cpu() for n, p in net.states.items()
              for k, t in p.items()}
    return grads, states


def dp_rank_bn_check(fo, group):
    """K3's global-batch path over the gloo ranks, one f32 BN at a time:
    this rank's half of the rows (the halves drawn apart, so that a
    rank's own statistics differ from the batch's) through
    ``fused_bn_act_train`` with the dp group, against one K3 call on all
    the rows in this process: y and dx on the rank's rows, mean and var,
    dgamma and dbeta summed over the ranks; each as its max abs error
    over the reference's largest entry. ``dx_local_corr`` is dx with the
    backward's sums left this rank's own, which ``DP_BN_REL`` must
    reject."""
    out = {}
    for n, c, act in DP_BN_CASES:
        gen = torch.Generator(device="cuda").manual_seed(n + c)
        x = torch.randn((n, c), generator=gen, device="cuda") * 2 + 1.5
        x[n // 2:] = x[n // 2:] * 1.5 + 0.5
        gy = torch.randn((n, c), generator=gen, device="cuda")
        gamma = torch.rand((c,), generator=gen, device="cuda") * 1.5 + 0.5
        beta = torch.randn((c,), generator=gen, device="cuda")
        center = torch.randn((c,), generator=gen, device="cuda") * 0.1
        lo, hi = group.slice_of(n)

        def run(rows, grp):
            xs, gs, bs = (t.clone().requires_grad_()
                          for t in (x[rows], gamma, beta))
            y, mean, var = fo.fused_bn_act_train(xs, gs, bs, center, 1e-5,
                                                 act, grp)
            return (y, mean, var,
                    *torch.autograd.grad(y, (xs, gs, bs), gy[rows]))

        full = run(slice(None), None)
        y, mean, var, dx, dgamma, dbeta = run(slice(lo, hi), group)
        dgamma, dbeta = group.all_reduce_(torch.stack([dgamma, dbeta]))
        inv = torch.rsqrt(var + 1e-5)
        scale, shift = fo._scale_shift(gamma, beta, mean, inv)
        xh, gh = x[lo:hi].contiguous(), gy[lo:hi].contiguous()
        r = fo.bn_bwd_reduce(xh, gh, scale, shift, mean, inv, act)
        dx_local = fo.bn_bwd_dx(xh, gh, scale, shift, mean, inv, r[2:], act)
        pairs = {"y": (y, full[0][lo:hi]), "mean": (mean, full[1]),
                 "var": (var, full[2]), "dx": (dx, full[3][lo:hi]),
                 "dgamma": (dgamma, full[4]), "dbeta": (dbeta, full[5]),
                 "dx_local_corr": (dx_local, full[3][lo:hi])}
        out[f"N{n} C{c} {act}"] = {
            k: ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()
            for k, (a, b) in pairs.items()}
        del x, gy, full
        torch.cuda.empty_cache()
    return out


def dp_rank_main(rank, workdir):
    """One rank of phase 21(b): joins a gloo world of ``DP_RANKS`` on
    ``cuda:0`` (every rank on the one card), trains the f32 ResNet-50 one
    eager step through ``ParallelWrapper`` over ``make_mesh(dp=2)`` on
    its half of phase 8's B128 batch and writes its loss, step-1 grads,
    running stats, K3 launches and how the step ran. Imports the port
    only."""
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.kernels import fused_ops as fo
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, make_mesh
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "store"),
        rank=rank, world_size=DP_RANKS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(dp=DP_RANKS)
    bn = dp_rank_bn_check(fo, mesh.group("dp"))
    net = _f32_resnet(fo)
    pw = ParallelWrapper(net, mesh)
    x, y = _dp_inputs()
    fo.reset_launches()
    loss = pw.fit([DataSet(x, y)])
    torch.cuda.synchronize()
    grads, states = _step1_of(net)
    torch.save({"bn": bn, "loss": loss, "grads": grads, "states": states,
                "k3": k3_counts(fo), "graphs": pw.graphs,
                "last": pw._step.last, "audit": pw.audit_drift()},
               os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def parallel_dp2_gloo(fo):
    """(b) dp 2 on the one card over gloo: two spawned ranks (this script,
    ``--dp-rank``; they import the port only), both on ``cuda:0``, each
    training its B64 of the B128 batch one eager f32 step through
    ``ParallelWrapper`` — K3's stats and backward sums summed over the two
    ranks — held against the monolithic B128 step (K3 in one process):
    loss, step-1 grads and the new running stats within the f32 bars, the
    two ranks equal to each other."""
    import tempfile
    from deeplearning4j_tpu_torch import disable_graphs
    from deeplearning4j_tpu_torch.data import DataSet
    x, y = _dp_inputs()
    net = _f32_resnet(fo)
    with disable_graphs():
        mono_loss = net.fit(DataSet(torch.as_tensor(x, device="cuda"),
                                    torch.as_tensor(y, device="cuda")))
    mono_g, mono_s = _step1_of(net)
    del net
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="dl4j_dp2_")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
         "--dp-dir", work], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(DP_RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DP_RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.perf_counter() - t0
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise SystemExit(f"parallel dp2 over gloo: rank(s) {bad} failed:\n"
                         + "\n".join(outs[r][-4000:] for r in bad))
    res = [torch.load(os.path.join(work, f"rank{r}.pt"))
           for r in range(DP_RANKS)]
    shutil.rmtree(work, ignore_errors=True)
    failed = []
    for r, got in enumerate(res):
        dl = abs(got["loss"] - mono_loss)
        g = _worst(got["grads"], mono_g)
        st = _worst(got["states"], mono_s)
        log(f"parallel dp2 over gloo, rank {r} vs the monolithic B128 step "
            f"(f32): |loss delta| {dl:.3e} (limit {RESNET_F32_LOSS_ATOL}); "
            f"running stats rel L2 max {st[0]:.3e} ({st[2]}) (limit "
            f"{RESNET_F32_STATE_REL_L2}); grads rel L2 median {g[1]:.3e} "
            f"max {g[0]:.3e} ({g[2]}) (limit {RESNET_GRAD_REL_L2}); K3 "
            f"{json.dumps(got['k3'])}; step {got['last']} "
            f"({got['graphs']}); drift audit {json.dumps(got['audit'])}")
        if not dl <= RESNET_F32_LOSS_ATOL:
            failed.append(f"rank {r} loss")
        if not st[0] <= RESNET_F32_STATE_REL_L2:
            failed.append(f"rank {r} running stats")
        if not g[0] <= RESNET_GRAD_REL_L2:
            failed.append(f"rank {r} grads")
        if any(n != 53 for n in got["k3"].values()):
            failed.append(f"rank {r} K3 launch counts")
        if not got["audit"]["bit_identical"]:
            failed.append(f"rank {r}: the replicas drifted")
        log(f"parallel dp2 over gloo, rank {r}: K3 over the two ranks vs "
            f"one K3 call on all the rows (f32), max abs error over the "
            f"largest entry (limit {DP_BN_REL}; dx_local_corr, the "
            f"backward's sums left local, must exceed it): "
            f"{json.dumps(got['bn'])}")
        for case, errs in got["bn"].items():
            bad_keys = [k for k, e in errs.items()
                        if k != "dx_local_corr" and not e <= DP_BN_REL]
            if bad_keys:
                failed.append(f"rank {r} K3 {case} {bad_keys}")
            if not errs["dx_local_corr"] > DP_BN_REL:
                failed.append(f"rank {r} K3 {case}: the bar does not see "
                              "a local corr")
    log(f"parallel dp2 over gloo: two ranks on {torch.cuda.get_device_name(0)}"
        f" in {secs:.1f} host s (spawn, build, one step)")
    if failed:
        raise SystemExit(f"parallel dp2 over gloo: {failed}")
    return {k: sum(got["k3"][k] for got in res) for k in res[0]["k3"]}


def moe_routing(tfm, cfg, params, ids):
    """Each MoE block's routing on one forward of ``ids``: the (N, K)
    expert choices and whether the capacity keeps each (an expert keeps
    at most C = capacity_factor · N · K / E rows, in token-major
    order)."""
    out = []
    with torch.no_grad():
        x = tfm.embed(params, cfg, ids)
        for w in tfm._layers(params["blocks"], cfg.n_layers):
            a = tfm._attn_half(cfg, x, w["ln1"], w["wqkv"])[0]
            h = tfm._rmsnorm(x + a @ w["wo"].to(x.dtype), w["ln2"])
            n = h.shape[0] * h.shape[1]
            gates = torch.softmax(h.reshape(n, -1).float()
                                  @ w["router"].float(), -1)
            _, topi = tfm._top_k(gates, cfg.expert_top_k)
            onehot = torch.nn.functional.one_hot(topi, cfg.n_experts)
            pos = torch.cumsum(onehot.reshape(-1, cfg.n_experts), 0) \
                .reshape(onehot.shape).gather(-1, topi[..., None])[..., 0]
            cap = max(1, int(cfg.capacity_factor * n * cfg.expert_top_k
                             / cfg.n_experts))
            out.append((topi, pos <= cap))
            x, _ = tfm._mlp_half(cfg, x, a, w["wo"], w["ln2"],
                                 *tfm._mlp_weights(w))
    return out


def parallel_moe(fa, pa):
    """(c) the 120M LM of phase 6 with ``MOE_EXPERTS`` experts a block
    (top-2, capacity 1.25) trained B32 T1024 bf16 through
    ``make_train_step`` (``train_path``: replayed = eager bit for bit, step
    1 against the plain path at phase 6's bars, K1, dQ and dK/dV counted
    from the capture); the tokens the capacity dropped on step 1's batch
    and the device ms a step beside phase 6's dense LM."""
    from deeplearning4j_tpu_torch.zoo import transformer as tfm
    counts = train_path(fa, pa, steps=PARALLEL_STEPS, batch=32,
                        tag="train MoE", n_experts=MOE_EXPERTS,
                        profile=True)
    # f32 too, at the same capacity (its drops taken), one step each way
    train_path(fa, pa, steps=1, batch=32, tag="train MoE f32",
               dtype=torch.float32, n_experts=MOE_EXPERTS)
    cfg, init, ids, _ = lm_setup(tfm, 32, 8, 8, torch.bfloat16,
                                 n_experts=MOE_EXPERTS)
    route = moe_routing(tfm, cfg, init, ids)
    plain = moe_routing(tfm, dataclasses.replace(
        cfg, use_flash_attention=False, attn_scores_bf16=False), init, ids)
    drops = [(k.numel(), int((~k).sum())) for _, k in route]
    flips = [(int((a != b).any(-1).sum()), int((ka != kb).sum()))
             for (a, ka), (b, kb) in zip(route, plain)]
    moe, dense = TRAIN_RECORDS["train MoE"], TRAIN_RECORDS.get("train")
    keys = ("wall_ms_per_step", "device_ms_per_step", "tok_per_s",
            "peak_alloc_gib")
    log(f"parallel MoE LM (E{MOE_EXPERTS} top-2 capacity 1.25, B32 T1024 "
        f"bf16): {json.dumps({k: moe.get(k) for k in keys})}; dense LM "
        f"(phase 6): "
        + (json.dumps({k: dense.get(k) for k in keys}) if dense else
           "not run in this call")
        + f"; (routed, dropped) rows by block on step 1's batch {drops} "
        f"({sum(d for _, d in drops) / sum(r for r, _ in drops):.4f} "
        f"dropped); against the plain path's forward, (tokens whose "
        f"choices differ, rows whose keep differs) by block {flips}")
    del init
    torch.cuda.empty_cache()
    return counts


def parallel_ring(fa, pa):
    """(d) the ring: ``make_ring_train_step`` on the NCCL world of one
    (dp 1, sp 1: one hop, K1 through its lse) against ``make_train_step``
    on the same batch (the reference's dry-run case K), both replayed;
    then ``ring_hop`` over ``RING_CHUNKS`` chunks of a B8 H8 T4096 D64
    bf16 causal sequence on one device against one monolithic K1: the
    output at bf16's atol, and the q/k/v grads through the merges (each
    partial weighted by exp(lse_i − lse): a nonzero lse cotangent into
    dQ and dK/dV). Returns the two paths' counts."""
    from deeplearning4j_tpu_torch.parallel import make_mesh
    from deeplearning4j_tpu_torch.parallel.ring_attention import ring_hop
    from deeplearning4j_tpu_torch.zoo import transformer as tfm
    mesh = make_mesh(dp=1, sp=1)
    cfg, init, ids, tgt = lm_setup(tfm, RING_LM_BATCH, 8, 8, torch.bfloat16)
    ring_cfg = dataclasses.replace(cfg, use_ring_attention=True)
    runs, failed = {}, []
    for name, make in (
            ("ring", lambda o: tfm.make_ring_train_step(ring_cfg, o, mesh)),
            ("mono", lambda o: tfm.make_train_step(cfg, o))):
        params = {k: (v.clone() if torch.is_tensor(v)
                      else {n: w.clone() for n, w in v.items()})
                  for k, v in init.items()}
        opt = torch.optim.AdamW(tfm.param_leaves(params), lr=3e-4,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4, capturable=True,
                                **LM_ADAMW)
        step = make(opt)
        fa.reset_launches()
        losses, per_step, kinds = [], [], []
        for _ in range(3):
            before = flash_counts(fa)
            losses.append(step(params, ids, tgt).item())
            per_step.append({n: c - before[n] for n, c in
                             flash_counts(fa).items() if c - before[n]})
            kinds.append(step.compiled.last)
        runs[name] = {"losses": losses, "steps": kinds,
                      "launches_per_step": replay_counts(per_step, kinds),
                      "final": [(n, p.detach().clone())
                                for n, p in _named_leaves(params)]}
        del params, opt, step
        torch.cuda.empty_cache()
    dl = [abs(a - b) for a, b in zip(runs["ring"]["losses"],
                                     runs["mono"]["losses"])]
    diff = first_diff(runs["ring"]["final"], runs["mono"]["final"])
    per = {"flash_attention_fwd": 2 * cfg.n_layers,
           "flash_attention_bwd_dq": cfg.n_layers,
           "flash_attention_bwd_dkv": cfg.n_layers}
    ring_launch = runs["ring"]["launches_per_step"]
    log(f"parallel ring step (dp1 sp1, NCCL) vs make_train_step (B"
        f"{RING_LM_BATCH} T1024 bf16): losses {runs['ring']['losses']} vs "
        f"{runs['mono']['losses']}, |delta| {dl} (limit {RING_LOSS_ATOL}), "
        f"params bit-identical {diff is None}; steps "
        f"{runs['ring']['steps']}; launches a step {ring_launch}")
    if not max(dl) <= RING_LOSS_ATOL:
        failed.append("ring step losses")
    if runs["ring"]["steps"] != ["eager", "capture", "replay"]:
        failed.append("the ring step did not replay a graph")
    if any({k: c.get(k, 0) for k in per} != per for c in ring_launch):
        failed.append("ring step flash launches")
    ring_counts = {n: sum(c.get(n, 0) for c in ring_launch)
                   for n in flash_counts(fa)}
    del runs, init
    torch.cuda.empty_cache()

    # the per-hop function over the chunks of one sequence
    b, t, h, d = RING_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(21)
    q, k, v, g = (torch.randn((b, t, h, d), generator=gen, device="cuda",
                              dtype=torch.bfloat16) for _ in range(4))
    q, k, v = (a.requires_grad_() for a in (q, k, v))
    c = t // RING_CHUNKS
    fa.reset_launches()
    outs = []
    for i in range(RING_CHUNKS):
        acc = None
        for j in range(i, -1, -1):         # the ring's order of blocks
            acc = ring_hop(acc, q[:, i * c:(i + 1) * c],
                           k[:, j * c:(j + 1) * c], v[:, j * c:(j + 1) * c],
                           "diag" if j == i else "full", use_flash=True)
        outs.append(acc[0].to(q.dtype))
    out = torch.cat(outs, 1)
    grads = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    hop_counts = flash_counts(fa)
    ref = fa.flash_attention_ntc(q, k, v, causal=True)
    ref_grads = torch.autograd.grad(ref, (q, k, v), g)
    err = (out.float() - ref.float()).abs().max().item()
    g_ok = [grad_ok(a, r, torch.bfloat16) for a, r in zip(grads, ref_grads)]
    g_rel = [f"{rel_l2(a, r):.3e}" for a, r in zip(grads, ref_grads)]
    n_hops = RING_CHUNKS * (RING_CHUNKS + 1) // 2
    log(f"parallel ring_hop over {RING_CHUNKS} chunks (B{b} H{h} T{t} D{d} "
        f"bf16 causal) vs one K1: out max abs err {err:.3e} (atol "
        f"{ATOL[torch.bfloat16]}); q/k/v grads rel L2 {g_rel} (limit "
        f"{BWD_BF16_REL_L2}); K1 / dQ / dK-dV "
        f"launches {hop_counts['flash_attention_fwd']} / "
        f"{hop_counts['flash_attention_bwd_dq']} / "
        f"{hop_counts['flash_attention_bwd_dkv']} (want {n_hops} each)")
    if not err <= ATOL[torch.bfloat16]:
        failed.append("ring hops' output")
    if not all(g_ok):
        failed.append("ring hops' grads")
    if any(hop_counts[n] != n_hops for n in FLASH_NAMES.values()):
        failed.append("ring hops' flash launches")
    if failed:
        raise SystemExit(f"parallel ring: {failed}")
    return ring_counts, hop_counts


def parallel_phase(fa, pa, fo, k3_checked):
    """Phase 21: (a)-(d). Returns the paths' counts."""
    counts, _ = parallel_resnet(fa, pa, fo, k3_checked)
    zero = dict.fromkeys(path_counts(fa, pa, fo), 0)
    paths = {"parallel_resnet_dp1": counts,
             "parallel_resnet_dp2_gloo": {**zero,
                                          **parallel_dp2_gloo(fo)}}
    paths["parallel_moe_lm"] = {**zero, **parallel_moe(fa, pa)}
    ring, hops = parallel_ring(fa, pa)
    paths["parallel_ring_step"] = {**zero, **ring}
    paths["parallel_ring_hops"] = {**zero, **hops}
    log(f"parallel: launches by path {json.dumps(paths)}")
    return paths


# ---------------------------------------------------------------- phase 22

# (a) the fleet: bench.py:927-940's 120M LM at max_seq 256 (its fleet row
# serves it so), 4 slots a replica (bench.py:2170 "inference_fleet": (4,
# 6)), a paged pool with the prefix cache, the row's prompt lengths
FLEET_LM = dict(vocab_size=32000, d_model=512, n_heads=8, n_layers=8,
                d_ff=2048, max_seq=256)
FLEET_SLOTS = 4
FLEET_SCHED = {"page_len": 16, "prefix_cache": True}
FLEET_PROMPT_LENS = (8, 16, 32)
FLEET_NEW = (6, 8)
# the warm waves also reach the chunk bucket past 32 tokens, which a
# re-prefilled context (prompt + generated) takes
FLEET_WARM_LENS = (8, 16, 32, 40)
# requests timed for the service rate R: about 1-2 s of one replica's
# work, through the planes the episode's replicas run (the SLO tracker,
# the sessions' retention); a 48-request loop (0.2-0.4 s) read R 110
# and 239 requests/s in two runs of one tree on the H100
FLEET_CLOSED_LOOP = 192
FLEET_TTFT_RUNS = 5             # single requests for t0, the median
# the episode: base 0.3 R, a burst of 4 R from 1.0 to 2.0 s, 30 s, 8
# sessions, seed 1, the busiest replica killed at 3.0 s; SLO 5 t0 / 5 s0
# times the replicas one host thread may step (its latency floor: a
# token waits for every live replica's step, an admission for a whole
# round of them; at 5 t0 / 5 s0 alone the calm tail with 3 replicas kept
# burning at 1-20 in one H100 run of two, and never scaled down).
# One host thread steps every replica, and the sessions pin traffic to
# the replicas that saw them first, so the fleet sustains about 0.7 R
# however many replicas live (H100 runs: R 209-239, the episode's fleet
# 150-170 requests/s): a 3 s burst leaves ~10 R·s of backlog, which
# drains at ~0.4 R past a 20 s trace and leaves no calm for a
# scale-down; a 1 s burst drains by ~10 s, and 30 s leave ~20 s of calm
# under the base rate. Should the trace still end with no scale-down,
# the idle router is stepped on (``FLEET_TAIL_S`` at most) until the
# autoscaler retires a replica or the fleet is at its minimum: a burn
# goes stale after one quiet window
FLEET_BASE, FLEET_BURST = 0.3, 4.0
FLEET_BURST_S = (1.0, 2.0)
FLEET_DURATION_S = 30.0
FLEET_TAIL_S = 10.0
FLEET_SESSIONS = 8
FLEET_KILL_S = 3.0
FLEET_SLO_X = 5.0
FLEET_SLO_WINDOW_S = 2.0
FLEET_AUTOSCALER = dict(min_replicas=1, max_replicas=3, high_burn=1.0,
                        low_burn=0.5, high_queue=3.0, patience=2,
                        cooldown=3)
FLEET_MAX_WALL_S = 120.0
FLEET_F32_REQUESTS = 8
FLEET_F32_NEW = 8
FLEET_BF16_ORACLE = 8           # re-prefilled bf16 requests compared
# (b) the scale-out job: ResNet-50 at phase 8's 224² in bf16, 2 worker
# threads, 4 shards of B32, averaging every step
SCALEOUT_SHARDS, SCALEOUT_BATCH, SCALEOUT_EPOCHS = 4, 32, 2
SCALEOUT_WORKERS = 2
SCALEOUT_TIMEOUT_S = 120.0
SCALEOUT_BACKOFF_S = 0.1        # the workers' first retry after the master
# dies after round 2: a lease's DONE reaches the hub after its round's
# mean, so round 1's stamp holds no finished item and round 2's holds
# round 1's — the resume then skips them
SCALEOUT_MASTER_DIES = 2
# (c) the codec: 2 subprocess ranks on the card, each the char-RNN of
# phase 10 on its B128 half of the B256 batch, 20 steps of lr·grad
CODEC_RANKS, CODEC_STEPS, CODEC_LR = 2, 20, 1.0
CODEC_RANK_TIMEOUT_S = 300


def fleet_engine(dtype, device=None):
    """The fleet's LM (``FLEET_LM``) from seed 0, in ``dtype``, served by
    one engine."""
    from deeplearning4j_tpu_torch.serving import GenerationEngine
    from deeplearning4j_tpu_torch.zoo import transformer as tfm
    cfg = tfm.TransformerConfig(**FLEET_LM, dtype=dtype, remat=False)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             device=device)
    return GenerationEngine(cfg, params, device=device)


def fleet_prompts(vocab, lens, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, int(lens[i % len(lens)])).astype(np.int32)
            for i in range(n)]


class ReplicaCompiles:
    """The compiles (a new signature's eager call and its capture; a
    direct call's new signature on the host) of an engine's entry points,
    by the replica whose pool or generator the signature binds
    (``by_rid``: rid → {kind: n}); ``after_warm`` counts those after
    :meth:`mark`. Read through the sentinels' ``hooks``; :meth:`close`
    takes the hook off."""

    def __init__(self, engine):
        self.router, self.by_rid, self.after_warm = None, {}, {}
        self._warm = False
        self._seen = set()
        self._fns = [s._fn for s in engine.sentinels.values()]
        for fn in self._fns:
            fn.hooks.append(self._on)

    def close(self):
        for fn in self._fns:
            fn.hooks.remove(self._on)

    def mark(self):
        self._warm = True

    def _on(self, kind, key):
        if kind == "replay" or self.router is None:
            return
        if kind == "direct":
            if key in self._seen:
                return
            self._seen.add(key)
        ids = {leaf[0] for part in key if isinstance(part, tuple) and part
               and part[0] == "bound" for leaf in part[1:]}
        if not ids:
            return
        # a scheduler warms its page copy and samplers while it is made,
        # before the router lists its replica: rids run 0, 1, ... and a
        # replica stays listed dead or retired, so it is the next rid
        owner = len(self.router.replicas)
        for rid, rep in list(self.router.replicas.items()):
            s = rep.scheduler
            if s.cache is not None and ids & (
                    {id(t) for t in s.cache.values()
                     if isinstance(t, torch.Tensor)} | {id(s._gen)}):
                owner = rid
                break
        for d in (self.by_rid, *((self.after_warm,) if self._warm
                                 else ())):
            c = d.setdefault(owner, {})
            c[kind] = c.get(kind, 0) + 1


def fleet_warm(router, rid, vocab, seed, waves=2):
    """``waves`` waves of the warm mix (every prompt length, the session
    path) straight through replica ``rid``'s scheduler: on the card the
    first wave runs each signature eagerly, the second captures it."""
    sched = router.replicas[rid].scheduler
    for w in range(waves):
        prompts = fleet_prompts(vocab, FLEET_WARM_LENS,
                                len(FLEET_WARM_LENS), seed + w)
        futs = [sched.submit(p, max(FLEET_NEW), session_id=f"warm{i}")
                for i, p in enumerate(prompts)]
        sched.run_until_idle()
        for f in futs:
            f.result(timeout=60)
    for i in range(len(FLEET_WARM_LENS)):
        sched.drop_session(f"warm{i}")


def fleet_service(engine):
    """The warm service of one replica: R, the requests a second it
    completes in a closed loop of the episode's mix (``FLEET_SLOTS`` in
    flight, the episode's sessions, an SLO tracker as the episode's
    replicas keep); s0, the host seconds of its steady decode sweep; t0,
    the median TTFT of a single request on the idle replica."""
    from deeplearning4j_tpu_torch.serving import FleetRouter, SLOConfig
    vocab = engine.cfg.vocab_size
    router = FleetRouter(engine, n_replicas=1, n_slots=FLEET_SLOTS,
                         slo=SLOConfig(window_s=FLEET_SLO_WINDOW_S),
                         scheduler_kwargs=FLEET_SCHED)
    fleet_warm(router, 0, vocab, 100)
    sched = router.replicas[0].scheduler
    rng = np.random.default_rng(101)
    prompts = fleet_prompts(vocab, FLEET_PROMPT_LENS, FLEET_CLOSED_LOOP,
                            102)
    st0 = dict(sched.stats)
    inflight, done, nxt = [], 0, 0
    t0 = time.perf_counter()
    while done < FLEET_CLOSED_LOOP:
        while len(inflight) < FLEET_SLOTS and nxt < len(prompts):
            inflight.append(router.submit(
                prompts[nxt], int(rng.choice(FLEET_NEW)),
                session_id=f"s{nxt % FLEET_SESSIONS}"))
            nxt += 1
        router.step()
        for f in [f for f in inflight if f.done()]:
            f.result(timeout=60)
            inflight.remove(f)
            done += 1
        if time.perf_counter() - t0 > 60:
            raise SystemExit("fleet: the closed loop did not finish")
    wall = time.perf_counter() - t0
    st = {k: sched.stats[k] - st0[k] for k in ("decode_s", "decode_steps",
                                                "decode_tokens")}
    ttfts = []
    for p in fleet_prompts(vocab, (16,), FLEET_TTFT_RUNS, 103):
        f = router.submit(p, 2)
        router.run_until_idle()
        ttfts.append(f.result(timeout=60).ttft_s)
    router.replicas[0].release()
    return {"R_rps": FLEET_CLOSED_LOOP / wall,
            "s0_s": st["decode_s"] / st["decode_steps"],
            "t0_s": float(np.median(ttfts)),
            "closed_loop_decode_tok_per_s": st["decode_tokens"]
            / st["decode_s"], "closed_loop_wall_s": wall}


def fleet_replay(path, slo):
    """The dump replayed through the port's own SLO tracker (window: the
    whole dump), as ``scripts/slo_report.py --fleet`` replays it: the
    FLEET row's report, by replica too, and the replica range."""
    from deeplearning4j_tpu_torch.obs import (SLOConfig, SLOTracker,
                                              load_flight_records)
    recs = load_flight_records(path)
    offline = SLOConfig(ttft_s=slo.ttft_s, itl_s=slo.itl_s,
                        quantile=slo.quantile, window_s=math.inf,
                        window_max=1 << 20)
    latest = {}
    for rec in recs:
        if rec.get("kind") == "reqtrace":
            latest[(str(rec.get("replica")), rec.get("request_id"),
                    rec.get("t0_epoch"))] = rec
    fleet = SLOTracker(offline, replica="FLEET", registry=False)
    per = {}
    for (replica, _, _), rec in sorted(latest.items(),
                                       key=lambda kv: kv[0][1] or 0):
        tr = per.setdefault(replica, SLOTracker(offline, replica=replica,
                                                registry=False))
        for t in (tr, fleet):
            t.observe_summary(rec.get("summary") or {},
                              ts=rec.get("t0_epoch"))
    live = [r["replicas_live"] for r in recs if r.get("kind") == "snapshot"
            and r.get("replica") == "fleet"
            and r.get("replicas_live") is not None]
    return fleet.report(), {k: t.report() for k, t in per.items()}, \
        (min(live), max(live)) if live else None


def fleet_first_ttft(router):
    """Each replica's first request's TTFT and the rest's median, from
    its flight recorder (dead and retired replicas keep theirs)."""
    out = {}
    for rid, rep in sorted(router.replicas.items()):
        traces = sorted(rep.scheduler.flight_recorder.requests(),
                        key=lambda t: t.t0_perf)
        ttft = [t.ttft_s() for t in traces if t.ttft_s() is not None]
        out[rep.replica] = {
            "status": rep.status, "requests": len(ttft),
            "first_ttft_s": ttft[0] if ttft else None,
            "rest_ttft_median_s": float(np.median(ttft[1:]))
            if len(ttft) > 1 else None}
    return out


def fleet_bf16_episode(fa, pa, engine, launches, compiles, svc, tmp):
    """Phase 22(a), the bf16 episode (see the module docstring)."""
    from deeplearning4j_tpu_torch.serving import (AutoscalerConfig,
                                                  FleetRouter, SLOConfig,
                                                  TrafficConfig,
                                                  poisson_arrivals,
                                                  run_episode)
    vocab = engine.cfg.vocab_size
    rate, t0, s0 = svc["R_rps"], svc["t0_s"], svc["s0_s"]
    x = FLEET_SLO_X * FLEET_AUTOSCALER["max_replicas"]
    slo = SLOConfig(ttft_s=x * t0, itl_s=x * s0, window_s=FLEET_SLO_WINDOW_S)
    router = FleetRouter(engine, n_replicas=1, n_slots=FLEET_SLOTS, slo=slo,
                         autoscaler=AutoscalerConfig(**FLEET_AUTOSCALER),
                         autoscale_every=4, scheduler_kwargs=FLEET_SCHED)
    compiles.router = router
    fleet_warm(router, 0, vocab, 200)
    engine.mark_warm()
    compiles.mark()
    tc = TrafficConfig(rate_rps=FLEET_BASE * rate,
                       duration_s=FLEET_DURATION_S,
                       prompt_lens=FLEET_PROMPT_LENS,
                       max_new_tokens=FLEET_NEW, vocab=vocab,
                       burst_start_s=FLEET_BURST_S[0],
                       burst_end_s=FLEET_BURST_S[1],
                       burst_mult=FLEET_BURST / FLEET_BASE,
                       sessions=FLEET_SESSIONS, seed=1)
    dump = os.path.join(tmp, "fleet_episode.jsonl")
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    launches.reset()
    with warnings.catch_warnings():
        # a replica spawned under traffic compiles its own signatures
        # (the engine counts them as retraces after mark_warm)
        warnings.simplefilter("ignore", RuntimeWarning)
        rep = run_episode(router, tc, kill_at_s=FLEET_KILL_S,
                          max_wall_s=FLEET_MAX_WALL_S)
        downs_in_trace = router.scale_downs
        tail = fleet_calm_tail(router)
    compiles.router = None
    counts = dict(launches.total)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if engine.device.type == "cuda" else None
    router.dump(dump)
    fleet_rep, per_rep, rng_ = fleet_replay(dump, slo)
    dead = sorted(r.rid for r in router.replicas.values()
                  if r.status == "dead")
    rs = [f.result(timeout=60) for f in rep.futures
          if f.done() and f.exception() is None]
    dec_tok = sum(r.scheduler.stats["decode_tokens"]
                  for r in router.replicas.values())
    dec_s = sum(r.scheduler.stats["decode_s"]
                for r in router.replicas.values())
    moved = [(f, a) for f, a in zip(rs, poisson_arrivals(tc))
             if f.reprefills]
    match, total = 0, 0
    for res, a in moved[:FLEET_BF16_ORACLE]:
        want = np.asarray(engine.generate(a.prompt, a.max_new_tokens)
                          ).reshape(-1)
        n = min(len(want), len(res.tokens))
        match += int((want[:n] == res.tokens[:n]).sum())
        total += len(want)
    live = [r for r in router.replicas.values() if r.status == "live"]
    out = {
        "submitted": rep.submitted, "completed": rep.completed,
        "failed": rep.failed, "wall_s": rep.wall_s,
        "killed": rep.killed_rid, "dead": dead,
        "scale_ups": router.scale_ups,
        "scale_downs": router.scale_downs,
        "scale_downs_in_trace": downs_in_trace, "calm_tail_s": tail,
        "reprefills": router.reprefills,
        "ghost_results": router.ghost_results,
        "leases": router.leases.counts(),
        "replica_range": rng_, "replicas": len(router.replicas),
        "fleet_goodput": fleet_rep["goodput"],
        "ttft_p99_s": fleet_rep["ttft"]["p99_s"],
        "itl_p99_s": fleet_rep["itl"]["p99_s"],
        "slo": {"ttft_s": slo.ttft_s, "itl_s": slo.itl_s,
                "window_s": slo.window_s},
        "decode_tok_per_s": dec_tok / dec_s if dec_s else None,
        "peak_gib": peak,
        "compiles_by_replica": compiles.by_rid,
        "compiles_after_warm": compiles.after_warm,
        "engine_retraces_after_warm": sum(
            r["retraces_after_warm"]
            for r in engine.compile_report().values()),
        "first_ttft_by_replica": fleet_first_ttft(router),
        "bf16_reprefilled_token_match": (match / total) if total else None,
        "bf16_reprefilled_compared": len(moved[:FLEET_BF16_ORACLE]),
        "launches": counts,
        "per_replica_goodput": {k: v["goodput"] for k, v in
                                per_rep.items()},
        "timeline": fleet_timeline(router)}
    failed = []
    if rep.failed or rep.completed != rep.submitted:
        failed.append("a future failed or never resolved")
    if router.scale_ups < 1 or router.scale_downs < 1:
        failed.append("no scale-up or no scale-down")
    # a replica whose step raised is killed by the router and its
    # requests re-prefilled: only the injected kill may be a death
    if rep.killed_rid is None or dead != [rep.killed_rid]:
        failed.append(f"replicas dead {dead}, not only the killed "
                      f"{rep.killed_rid}")
    if router.reprefills < 1 or router.ghost_results:
        failed.append("no re-prefill, or a ghost result")
    if not router.leases.all_done():
        failed.append("a lease is not done")
    if not all(r.scheduler.check_pages() for r in live):
        failed.append("a live replica's page table is broken")
    if counts.get("paged_attention", 0) < 1 and \
            engine.device.type == "cuda":
        failed.append("K2 was not launched")
    if compiles.after_warm.get(0):
        failed.append(f"the warm replica compiled after warm: "
                      f"{compiles.after_warm[0]}")
    compiles.close()
    for r in live:
        r.release()
    return out, failed


def fleet_calm_tail(router):
    """Steps the idle router after the trace, if the trace saw no
    scale-down, until the autoscaler retires a replica or the fleet is at
    its minimum (``FLEET_TAIL_S`` at most). Returns the tail's seconds."""
    t0 = time.perf_counter()
    low = router.autoscaler.config.min_replicas
    while router.scale_downs < 1 and router.n_live() > low and \
            time.perf_counter() - t0 < FLEET_TAIL_S:
        if not router.step():
            time.sleep(0.001)
    return time.perf_counter() - t0


def fleet_timeline(router, every_s=1.0):
    """(s since the first snapshot, live replicas, max burn, queue a
    replica) from the fleet recorder's periodic snapshots, about one a
    second, and every scale event."""
    snaps = [s for s in router.recorder.snapshots() if "ts" in s]
    if not snaps:
        return []
    t0, last, out = snaps[0]["ts"], -every_s, []
    for s in snaps:
        t = s["ts"] - t0
        if s.get("scale_event") or (s.get("step") is not None
                                    and t - last >= every_s):
            out.append([round(t, 2), s.get("replicas_live"), s.get("burn"),
                        s.get("queue_per_replica"),
                        s.get("scale_event") or ""])
            if not s.get("scale_event"):
                last = t
    return out


def fleet_f32_kill(device=None):
    """Phase 22(a), f32: two replicas of the f32 LM; the busiest killed
    mid-decode; every request's tokens equal ``engine.generate``'s."""
    from deeplearning4j_tpu_torch.serving import FleetRouter
    engine = fleet_engine(torch.float32, device=device)
    vocab = engine.cfg.vocab_size
    router = FleetRouter(engine, n_replicas=2, n_slots=FLEET_SLOTS,
                         scheduler_kwargs=FLEET_SCHED)
    prompts = fleet_prompts(vocab, FLEET_PROMPT_LENS, FLEET_F32_REQUESTS, 300)
    futs = [router.submit(p, FLEET_F32_NEW) for p in prompts]
    for _ in range(4):
        router.step()
    held = {}
    for rec in router.outstanding.values():
        held[rec.rid] = held.get(rec.rid, 0) + 1
    killed = max(held, key=lambda r: held[r]) if held else None
    moved = router.kill_replica(killed) if held else []
    router.run_until_idle()
    dead = sorted(r.rid for r in router.replicas.values()
                  if r.status == "dead")
    same = [np.array_equal(f.result(timeout=60).tokens, np.asarray(
        engine.generate(p, FLEET_F32_NEW)).reshape(-1))
        for p, f in zip(prompts, futs)]
    for r in router.replicas.values():
        if r.status == "live":
            r.release()
    failed = [] if moved and all(same) else [
        "f32 kill: no request moved, or a token differs from generate"]
    if dead != [killed]:
        # a replica whose step raised is killed by the router too
        failed.append(f"f32 kill: replicas dead {dead}, not only the "
                      f"killed {killed}")
    return {"requests": len(prompts), "moved": len(moved),
            "killed": killed, "dead": dead, "identical": sum(same)}, failed


def fleet_phase(fa, pa, smi, tmp):
    """Phase 22(a). Returns the episode's launch counts."""
    engine = fleet_engine(torch.bfloat16)
    launches = StepLaunches({n: s._fn for n, s in engine.sentinels.items()},
                            lambda: serving_counts(fa, pa))
    compiles = ReplicaCompiles(engine)
    t0 = time.perf_counter()
    svc = fleet_service(engine)
    log(f"fleet (120M bf16, {FLEET_SLOTS} slots, page_len "
        f"{FLEET_SCHED['page_len']}, prefix cache): one warm replica in a "
        f"closed loop of prompts {FLEET_PROMPT_LENS} x {FLEET_NEW} new: "
        f"{json.dumps(svc)} ({smi})")
    out, failed = fleet_bf16_episode(fa, pa, engine, launches, compiles, svc,
                                     tmp)
    log(f"fleet episode (base {FLEET_BASE} R, burst {FLEET_BURST} R "
        f"{FLEET_BURST_S[0]}-{FLEET_BURST_S[1]} s, {FLEET_DURATION_S} s, "
        f"{FLEET_SESSIONS} sessions, kill at {FLEET_KILL_S} s): "
        f"{json.dumps(out)}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    f32, f32_failed = fleet_f32_kill()
    log(f"fleet f32 (2 replicas, the busiest killed mid-decode): "
        f"{json.dumps(f32)}; phase 22(a) {time.perf_counter() - t0:.1f} "
        "host s")
    failed += f32_failed
    gc.collect()
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"fleet: {failed}")
    return out["launches"]


class ScaleoutProbe:
    """Measures a ``SparkDl4jMultiLayer`` job from outside. The job's own
    ``scaleout_round`` and ``scaleout_worker_fit`` spans give the round
    and fit seconds, and the hub's ``on_round`` callback (wrapped where
    the job makes its checkpointer) gives each round's mean and the
    checkpoint's seconds. The parts with no seam of their own are timed
    by wrappers that ``__exit__`` restores: the workers' card-to-host
    reads (``host_params``), their socket round trips
    (``WorkerClient.average``, which waits for the slowest worker), the
    hub's mean (``ParamAveragingHub._close_round_locked``), the
    host-to-card writes (each clone's ``set_params_flat``) and the
    workers' failures (``worker_main``). :meth:`applied_ok` holds every
    mean a worker applied against the hub's mean of that round."""

    def __init__(self, spark):
        import threading
        from deeplearning4j_tpu_torch.obs import get_tracer
        from deeplearning4j_tpu_torch.parallel import scaleout
        self.spark, self.mod, self.tracer = spark, scaleout, get_tracer()
        self.t = {k: [] for k in ("d2h", "socket", "mean", "h2d", "ckpt")}
        self.hub_means, self.applied, self.clones = {}, [], []
        self.errors, self.spans = [], []
        self._tl = threading.local()
        self._saved = []

    def _patch(self, owner, name, new):
        self._saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, new)

    def _timed(self, key, fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.t[key].append(time.perf_counter() - t)
        return run

    def __enter__(self):
        mod, spark, probe = self.mod, self.spark, self
        self.read = mod.host_params         # the check's own, untimed
        self._patch(mod, "host_params", self._timed("d2h", mod.host_params))
        work = mod.worker_main

        def worker_main(*a, **k):
            try:
                return work(*a, **k)
            except BaseException as e:
                if "injected" not in str(e):
                    import traceback
                    probe.errors.append(traceback.format_exc()[-2000:])
                raise
        self._patch(mod, "worker_main", worker_main)
        avg = mod.WorkerClient.average

        def average(client, flat):
            t = time.perf_counter()
            out = avg(client, flat)
            probe.t["socket"].append(time.perf_counter() - t)
            probe._tl.round = client.last_round
            return out
        self._patch(mod.WorkerClient, "average", average)
        self._patch(mod.ParamAveragingHub, "_close_round_locked",
                    self._timed("mean",
                                mod.ParamAveragingHub._close_round_locked))
        ckpt = spark._checkpoint

        def checkpoint(template, table):
            save = ckpt(template, table)

            def on_round(mean, rnd):
                probe.hub_means[rnd] = mean
                if save is not None:
                    probe._timed("ckpt", save)(mean, rnd)
            return on_round
        self._patch(spark, "_checkpoint", checkpoint)
        clone = spark.net.clone

        def cloned():
            c = clone()
            probe.clones.append(c)
            set_flat = c.set_params_flat

            def set_params_flat(flat):
                rnd = getattr(probe._tl, "round", None)
                probe._tl.round = None
                if rnd is None:         # a rejoin's, or the checkpoint's
                    return set_flat(flat)
                t = time.perf_counter()
                set_flat(flat)
                if c.device.type == "cuda":
                    # this stream only: a whole-device synchronize would
                    # invalidate another worker's capture
                    torch.cuda.current_stream(c.device).synchronize()
                probe.t["h2d"].append(time.perf_counter() - t)
                probe.applied.append((rnd, np.array_equal(probe.read(c),
                                                          flat), flat))
            c.set_params_flat = set_params_flat
            return c
        self._patch(spark.net, "clone", cloned)
        return self

    def __exit__(self, *exc):
        for owner, name, old in reversed(self._saved):
            if owner is self.spark or owner is self.spark.net:
                delattr(owner, name)
            else:
                setattr(owner, name, old)
        # the job's spans share its root span's trace id; the newest
        # root is this job's (it closes as ``fit`` returns or raises)
        spans = self.tracer.spans()
        jobs = [sp for sp in spans if sp.name == "scaleout_job"]
        self.spans = [sp for sp in spans
                      if jobs and sp.trace_id == jobs[-1].trace_id]
        return False

    def span_s(self, name):
        """The seconds of this job's spans called ``name``."""
        return [sp.time_s for sp in self.spans if sp.name == name]

    def applied_ok(self):
        """Every applied mean read back as written, and equal to the
        hub's mean of its round."""
        return bool(self.applied) and all(
            ok and rnd in self.hub_means and
            np.array_equal(self.hub_means[rnd], flat)
            for rnd, ok, flat in self.applied)

    def worker_calls(self):
        """How the workers' compiled steps ran, summed over the clones."""
        out = {}
        for c in self.clones:
            if c._step_fn is not None:
                for k, n in c._step_fn.calls.items():
                    out[k] = out.get(k, 0) + n
        return out


def scaleout_resnet(make_net, shards, tm_kw, fo, tmp, device="cuda"):
    """Phase 22(b) on ``make_net()`` (ResNet-50 on the card): run 1, a
    worker killed after one step and respawned; run 2, the master killed
    after round 1, then resumed by a second ``fit``. Returns the record,
    the K3 launches of run 1 and the failures."""
    from deeplearning4j_tpu_torch.parallel import (
        MasterDiedError, ParameterAveragingTrainingMaster,
        SparkComputationGraph, read_resume_state)
    failed, rec = [], {}
    net = make_net()
    tm = ParameterAveragingTrainingMaster(
        **tm_kw, checkpoint_dir=os.path.join(tmp, "run1"))
    spark = SparkComputationGraph(net, tm)
    k3_0 = k3_counts(fo)
    t0 = time.perf_counter()
    with ScaleoutProbe(spark) as probe, warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the injected death warns
        spark.fit(shards, fail_worker=1, fail_after_steps=1,
                  respawn_failed=True)
    wall = time.perf_counter() - t0
    k3 = {k: v - k3_0[k] for k, v in k3_counts(fo).items()}
    calls = probe.worker_calls()
    # a replay launches nothing through the wrappers: every other worker
    # step (eager, capture) must have launched each K3 kernel 53 times
    fresh = sum(n for k, n in calls.items() if k != "replay")
    steps = sum(calls.values())
    per_step = {k: v / fresh if fresh else None for k, v in k3.items()}
    loss = float(net.score(shards[0]))
    n_params = int(net.params_flat().numel())
    fits = probe.span_s("scaleout_worker_fit")
    rec["run1"] = {
        "rounds": spark.rounds, "rejoins": spark.rejoins,
        "dropped": spark.dropped_workers,
        "leases": spark.lease_table.counts(), "wall_s": wall,
        "worker_steps": steps, "step_kinds": calls,
        "k3_launches": k3, "k3_per_fresh_step": per_step,
        "applied_means": len(probe.applied),
        "applied_bit_identical": probe.applied_ok(),
        "final_loss": loss, "params": n_params,
        "bytes_a_round": 2 * SCALEOUT_WORKERS * 4 * n_params + 8,
        "host_s_a_round": wall / max(spark.rounds, 1),
        **{f"{k}_s_median": float(np.median(v)) if v else None
           for k, v in probe.t.items()},
        "round_span_s_median": float(np.median(
            probe.span_s("scaleout_round")))
        if probe.span_s("scaleout_round") else None,
        "fit_s_median": float(np.median(fits)) if fits else None,
        "fit_s_max": max(fits) if fits else None,
        "worker_errors": probe.errors}
    if probe.errors:
        failed.append("run 1: a worker failed (worker_errors)")
    if not spark.lease_table.all_done():
        failed.append("run 1: a lease is not done")
    if spark.rejoins < 1:
        failed.append("run 1: the killed worker did not rejoin")
    if device == "cuda" and (not fresh or any(
            v != 53 * fresh for v in k3.values())):
        failed.append(f"run 1: K3 launches {k3} over {fresh} non-replayed "
                      "worker steps, not 53 each")
    if device == "cuda" and not calls.get("replay"):
        failed.append("run 1: no worker step replayed a graph")
    if not rec["run1"]["applied_bit_identical"]:
        failed.append("run 1: a worker's applied mean is not the hub's")
    if not math.isfinite(loss):
        failed.append("run 1: the final loss is not finite")
    # run 2: the master dies after round SCALEOUT_MASTER_DIES; a second
    # fit resumes
    ck = os.path.join(tmp, "run2")
    tm2 = ParameterAveragingTrainingMaster(**tm_kw, checkpoint_dir=ck)
    spark = SparkComputationGraph(make_net(), tm2)
    t0 = time.perf_counter()
    died = False
    with ScaleoutProbe(spark) as probe1, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            spark.fit(shards, fail_master_after_rounds=SCALEOUT_MASTER_DIES)
        except MasterDiedError:
            died = True
    stamp = read_resume_state(ck)
    before = set(json.loads(stamp[1])["completed"]) if stamp else set()
    spark2 = SparkComputationGraph(make_net(), tm2)
    with ScaleoutProbe(spark2) as probe2, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        spark2.fit(shards)
    n_items = SCALEOUT_SHARDS * tm_kw["epochs_per_fit"]
    # a leased item is one worker fit: the resumed job's fit spans count
    # the items it ran
    rerun = len(probe2.span_s("scaleout_worker_fit"))
    rec["run2"] = {
        "died": died, "stamp_round": stamp[0] if stamp else None,
        "completed_before": sorted(before), "rerun": rerun,
        "resumed": spark2.resumed, "rounds_before": spark.rounds,
        "rounds_after": spark2.rounds,
        "leases": spark2.lease_table.counts(),
        "wall_s": time.perf_counter() - t0,
        "ckpt_s_median": float(np.median(probe1.t["ckpt"] + probe2.t[
            "ckpt"])) if probe1.t["ckpt"] + probe2.t["ckpt"] else None,
        "final_loss": float(spark2.net.score(shards[0])),
        # the first fit's workers lose their hub when it dies: only the
        # resumed fit's must not fail
        "worker_errors": probe2.errors}
    if probe2.errors:
        failed.append("run 2: a worker of the resumed fit failed")
    if not died or stamp is None or not before:
        failed.append("run 2: the master did not die, or its stamp holds "
                      "no finished item")
    if not spark2.resumed or spark2.rounds <= spark.rounds:
        failed.append("run 2: no resume, or the rounds did not continue")
    if rerun != n_items - len(before) or \
            set(spark2.lease_table.completed) != set(range(n_items)):
        failed.append(f"run 2: {rerun} items re-run against "
                      f"{sorted(before)} of {n_items} done")
    if not spark2.lease_table.all_done():
        failed.append("run 2: a lease is not done")
    return rec, k3, failed


def scaleout_phase(fo, gen, k3_checked, smi):
    """Phase 22(b). Returns its K3 launches."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.train import Momentum
    from deeplearning4j_tpu_torch.zoo.resnet import ResNet50
    import tempfile
    model = ResNet50(num_classes=1000, updater=Momentum(0.1, 0.9),
                     compute_dtype=torch.bfloat16,
                     input_shape=(RESNET_HW, RESNET_HW, 3))

    def make():
        net = ComputationGraph(model.conf())
        _set_fused(net, True)
        return net.init()

    rng = np.random.default_rng(0)
    shards = [DataSet(
        torch.as_tensor(rng.random((SCALEOUT_BATCH, RESNET_HW, RESNET_HW,
                                    3), np.float32), device="cuda"),
        torch.as_tensor(np.eye(1000, dtype=np.float32)[
            rng.integers(0, 1000, SCALEOUT_BATCH)], device="cuda"))
        for _ in range(SCALEOUT_SHARDS)]
    tm_kw = dict(n_workers=SCALEOUT_WORKERS, averaging_frequency=1,
                 epochs_per_fit=SCALEOUT_EPOCHS,
                 worker_timeout=SCALEOUT_TIMEOUT_S, worker_retries=3,
                 worker_backoff=SCALEOUT_BACKOFF_S)
    tmp = tempfile.mkdtemp(prefix="dl4j_scaleout_")
    t0 = time.perf_counter()
    try:
        with _k3_cases(fo) as cases:
            rec, k3, failed = scaleout_resnet(make, shards, tm_kw, fo, tmp)
        # a worker step alone: a clone's replayed fit, device ms
        solo = make()
        rec["solo_step_device_ms"] = device_ms(
            lambda: solo.fit(shards[0]), iters=5)
        del solo
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # every K3 shape the job ran, held against the plain version here
    # (check_k3 fails the run on a disagreement)
    rec["k3_held_here"] = _k3_held(fo, gen, sorted(set(cases), key=str),
                                   k3_checked)
    log(f"scale-out job (SparkComputationGraph, ResNet-50 {RESNET_HW}² bf16,"
        f" {SCALEOUT_WORKERS} worker threads, {SCALEOUT_SHARDS} shards of "
        f"B{SCALEOUT_BATCH} x {SCALEOUT_EPOCHS} epochs, averaging every "
        f"step; {smi}): {json.dumps(rec)}; phase 22(b) "
        f"{time.perf_counter() - t0:.1f} host s")
    gc.collect()
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"scale-out: {failed}")
    return k3


def _flat_grads(grads):
    from deeplearning4j_tpu_torch.train.updaters import tree_leaves
    return torch.cat([g.detach().reshape(-1).float()
                      for g in tree_leaves(grads)])


def codec_rank_run(rank, port, device):
    """One rank of phase 22(c): the char-RNN (K4 on ``fused=True``) on
    this rank's half of the batch, ``CODEC_STEPS`` steps of ``gradient_
    and_score`` → ``DistributedGradientWorker.step(lr·grad)`` over the
    socket hub at ``port``, the mean update subtracted from the params.
    Returns
    the per-step losses, params digests, host seconds by part, device ms
    of ``gradient_and_score``, the encoded share and the threshold's
    path."""
    import hashlib
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.kernels import fused_lstm as fl
    from deeplearning4j_tpu_torch.parallel import transport as tr
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    b, t, v = CHARNN_BATCH, CHARNN_T, CHARNN_VOCAB
    net = TextGenerationLSTM(num_classes=v, input_shape=(t, v),
                             units=CHARNN_H,
                             compute_dtype=torch.bfloat16).init(
        device=device)
    _set_lstm_fused(net, True)
    rng = np.random.default_rng(0)
    eye = np.eye(v, dtype=np.float32)
    x = eye[rng.integers(0, v, (b, t))]
    y = eye[rng.integers(0, v, (b, t))]
    half = slice(rank * b // CODEC_RANKS, (rank + 1) * b // CODEC_RANKS)
    ds = DataSet(torch.as_tensor(x[half], device=device),
                 torch.as_tensor(y[half], device=device))
    n = int(net.params_flat().numel())
    parts = {k: [] for k in ("d2h", "encode", "exchange", "decode", "h2d")}

    def timed(key, fn):
        def run(*a, **k):
            s = time.perf_counter()
            out = fn(*a, **k)
            parts[key].append(time.perf_counter() - s)
            return out
        return run
    enc, dec = tr.threshold_encode, tr.threshold_decode
    tr.threshold_encode = timed("encode", enc)
    tr.threshold_decode = timed("decode", dec)
    transport = tr.SocketGradientTransport(("127.0.0.1", port), timeout=120)
    transport.exchange = timed("exchange", transport.exchange)
    worker = tr.DistributedGradientWorker(n, transport, threshold=1e-3)
    cuda = device == "cuda"
    digest = lambda: hashlib.sha1(                       # noqa: E731
        net.params_flat().detach().cpu().numpy().tobytes()).hexdigest()
    out = {"losses": [], "digests": [digest()], "event_ms": [],
           "encoded": [], "threshold": [worker.threshold], "params": n}
    k4_0 = (fl.LAUNCHES, dict(fl.LAUNCHES_BY_ROUTE))
    try:
        for _ in range(CODEC_STEPS):
            if cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
            grads, score = net.gradient_and_score(ds)
            if cuda:
                e1.record()
            s = time.perf_counter()
            upd = (_flat_grads(grads) * CODEC_LR).cpu().numpy()
            parts["d2h"].append(time.perf_counter() - s)
            if cuda:
                out["event_ms"].append(e0.elapsed_time(e1))
            mean = worker.step(upd)
            s = time.perf_counter()
            net.set_params_flat(net.params_flat() - torch.from_numpy(
                mean).to(net.params_flat().device))
            if cuda:
                torch.cuda.synchronize()
            parts["h2d"].append(time.perf_counter() - s)
            out["losses"].append(score)
            out["digests"].append(digest())
            out["encoded"].append(worker.last_encoded)
            out["threshold"].append(worker.threshold)
    finally:
        transport.close()
        tr.threshold_encode, tr.threshold_decode = enc, dec
    parts["decode"] = [sum(parts["decode"][i:i + CODEC_RANKS]) for i in
                       range(0, len(parts["decode"]), CODEC_RANKS)]
    out["parts_ms_median"] = {k: 1e3 * float(np.median(v))
                              for k, v in parts.items() if v}
    out["k4"] = fl.LAUNCHES - k4_0[0]
    out["k4_by_route"] = {r: c - k4_0[1][r]
                          for r, c in fl.LAUNCHES_BY_ROUTE.items()}
    if cuda:        # device time alone, without the host's gaps
        out["device_ms"] = device_ms(lambda: net.gradient_and_score(ds),
                                     iters=3, warmup=1)
    return out


def codec_rank_main(rank, workdir, port):
    """A phase 22(c) rank (``--codec-rank``): on ``cuda:0``, imports the
    port only, writes its record to ``workdir``."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = codec_rank_run(rank, port, "cuda")
    with open(os.path.join(workdir, f"codec{rank}.json"), "w") as f:
        json.dump(rec, f)
    return 0


def codec_phase(fl, gen, k4_checked, smi):
    """Phase 22(c). Returns the ranks' K4 launches by route."""
    import tempfile
    from deeplearning4j_tpu_torch.parallel import GradientExchangeServer
    b = CHARNN_BATCH // CODEC_RANKS
    failed = []
    if (torch.bfloat16, b, CHARNN_H, "cluster") not in k4_checked:
        r = check_lstm(fl, torch.bfloat16, b, CHARNN_T, CHARNN_H, gen)
        log(f"codec: K4 at a rank's shape B{b} T{CHARNN_T} H{CHARNN_H} bf16 "
            f"({r['route']} route) against its plain version: max abs err "
            f"{r['max_abs_err']:.3e}")
    work = tempfile.mkdtemp(prefix="dl4j_codec_")
    server = GradientExchangeServer(n_workers=CODEC_RANKS).start()
    t0 = time.perf_counter()
    procs = []
    try:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--codec-rank",
             str(r), "--codec-dir", work, "--codec-port",
             str(server.address[1])], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(CODEC_RANKS)]
        outs = [p.communicate(timeout=CODEC_RANK_TIMEOUT_S)[0]
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        server.stop()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        shutil.rmtree(work, ignore_errors=True)
        raise SystemExit(f"codec: rank(s) {bad} failed:\n"
                         + "\n".join(outs[r][-4000:] for r in bad))
    recs = []
    for r in range(CODEC_RANKS):
        with open(os.path.join(work, f"codec{r}.json")) as f:
            recs.append(json.load(f))
    shutil.rmtree(work, ignore_errors=True)
    secs = time.perf_counter() - t0
    same = all(a == b_ for a, b_ in zip(recs[0]["digests"],
                                        recs[1]["digests"]))
    r0 = recs[0]
    summary = {
        "steps": CODEC_STEPS, "rounds": server.rounds,
        "params": r0["params"], "bit_identical_every_step": same,
        "losses": [rec["losses"] for rec in recs],
        "k4": [rec["k4"] for rec in recs],
        "k4_by_route": [rec["k4_by_route"] for rec in recs],
        "host_ms_a_step": [rec["parts_ms_median"] for rec in recs],
        "grad_and_score_device_ms": [rec["device_ms"] for rec in recs],
        "grad_and_score_event_ms_median": [
            float(np.median(rec["event_ms"])) for rec in recs],
        "encoded_share": [float(np.mean(rec["encoded"])) / r0["params"]
                          for rec in recs],
        "threshold_path": r0["threshold"], "wall_s": secs}
    log(f"codec (GradientExchangeServer on TCP loopback, {CODEC_RANKS} "
        f"ranks on the card, char-RNN B{b} T{CHARNN_T} H{CHARNN_H} bf16 a "
        f"rank, lr {CODEC_LR}; {smi}): {json.dumps(summary)}")
    if not same:
        failed.append("the ranks' params parted")
    if any(rec["k4"] < 1 for rec in recs):
        failed.append("K4 was not launched")
    if any(not rec["losses"][-1] < rec["losses"][0] for rec in recs):
        failed.append("the loss did not fall")
    if server.rounds != CODEC_STEPS:
        failed.append(f"the hub served {server.rounds} rounds")
    if failed:
        raise SystemExit(f"codec: {failed}")
    return {k: sum(rec["k4_by_route"][k] for rec in recs)
            for k in recs[0]["k4_by_route"]}


def fleet_scaleout_phase(fa, pa, fo, fl, smi, gen, k3_checked=frozenset(),
                         k4_checked=frozenset()):
    """Phase 22: (a) the fleet, (b) the scale-out job, (c) the codec.
    Returns the paths' counts: by_path entries and the K4 path."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="dl4j_fleet_")
    try:
        fleet = fleet_phase(fa, pa, smi, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    k3 = scaleout_phase(fo, gen, k3_checked, smi)
    k4 = codec_phase(fl, gen, k4_checked, smi)
    zero = dict.fromkeys(path_counts(fa, pa, fo), 0)
    paths = {"fleet_episode": {**zero, **fleet},
             "scaleout_resnet": {**zero, **k3}}
    lstm = {"codec_charnn": {f"fused_lstm_{r}": n for r, n in k4.items()}}
    log(f"fleet and scale-out: launches by path {json.dumps(paths)}, "
        f"{json.dumps(lstm)}")
    return paths, lstm


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel build and checks")
    ap.add_argument("--profile", action="store_true",
                    help="also print the top kernels of the steady decode "
                         "sweeps of phase 4, replayed and eager")
    ap.add_argument("--profile-train", action="store_true",
                    help="also profile one kernel-path train step")
    ap.add_argument("--profile-resnet", action="store_true",
                    help="also profile one kernel-path ResNet-50 step")
    ap.add_argument("--profile-charnn", action="store_true",
                    help="also profile one kernel-path char-RNN step")
    ap.add_argument("--k3-times", metavar="ROOT",
                    help="only time the K3 reductions of the port checked "
                         "out at ROOT (prints no result line)")
    ap.add_argument("--flash-times", metavar="ROOT",
                    help="only time K1, dQ and dK/dV at head dims 256, 320 "
                         "and 512 in bf16 and f32 and at 64 and 128 in "
                         "f32, profile the D 256 and D 320 LMs' train "
                         "steps and the attention net's replayed f32 step "
                         "and digest K1's, the backward's and K2's "
                         "outputs, for the port checked out at ROOT "
                         "(prints no result line)")
    ap.add_argument("--obs-only", action="store_true",
                    help="build the kernels and run phase 14 (the "
                         "observability plane) only (prints no result "
                         "line)")
    ap.add_argument("--quant-only", action="store_true",
                    help="build the kernels and run phase 15 (the "
                         "quantization and speculation plane) only (prints "
                         "no result line)")
    ap.add_argument("--bert-only", action="store_true",
                    help="build the kernels and run phase 16 (BERT trained "
                         "and served, ResNet-50 served) only, holding every "
                         "K3 shape it runs itself (prints no result line)")
    ap.add_argument("--workflow2-only", action="store_true",
                    help="build the kernels, hold K3 and K4 against their "
                         "plain versions (phases 7, 9) and run phase 17 "
                         "(the rest of the DL4J workflow) only (prints no "
                         "result line)")
    ap.add_argument("--samediff-only", action="store_true",
                    help="build the kernels and run phase 18 (SameDiff and "
                         "the TF importer at BERT-base width) only (prints "
                         "no result line)")
    ap.add_argument("--zoo-only", action="store_true",
                    help="build the kernels and run phase 19 (YOLO2, the "
                         "DL4J attention layers and the ONNX importer) "
                         "only, holding every K3 shape it runs itself "
                         "(prints no result line)")
    ap.add_argument("--import-only", action="store_true",
                    help="build + phase 20 (the Keras importer, upstream "
                         "DL4J zips and SameDiff layers) only, holding "
                         "every K3 and K4 shape it runs itself (prints no "
                         "result line)")
    ap.add_argument("--parallel-only", action="store_true",
                    help="build + phases 7 and 21 (ParallelWrapper on the "
                         "NCCL world of one and over two gloo ranks on the "
                         "card, the MoE LM, the ring) only (prints no "
                         "result line)")
    ap.add_argument("--fleet-only", action="store_true",
                    help="build + phase 22 (the serving fleet with its "
                         "traffic episode, the scale-out job, the "
                         "threshold codec over sockets) only (prints no "
                         "result line)")
    ap.add_argument("--codec-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--codec-dir", help=argparse.SUPPRESS)
    ap.add_argument("--codec-port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dp-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dp-dir", help=argparse.SUPPRESS)
    ap.add_argument("--prefetch-times", metavar="ROOT",
                    help="only time LeNet's fit over host and device "
                         "iterators and a host list, for the port checked "
                         "out at ROOT (prints no result line)")
    ap.add_argument("--sweep-times", metavar="ROOT",
                    help="only time phase 4's steady decode sweeps, dense "
                         "and paged, with their host split, for the port "
                         "checked out at ROOT (prints no result line)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if args.dp_rank is not None:
        return dp_rank_main(args.dp_rank, args.dp_dir)
    if args.codec_rank is not None:
        return codec_rank_main(args.codec_rank, args.codec_dir,
                               args.codec_port)
    if args.k3_times:
        return k3_times(args.k3_times)
    if args.flash_times:
        return flash_times(args.flash_times)
    if args.sweep_times:
        return sweep_times(args.sweep_times)
    if args.prefetch_times:
        return prefetch_times(args.prefetch_times)
    from deeplearning4j_tpu_torch.kernels import KERNEL_SOURCES, _build
    from deeplearning4j_tpu_torch.kernels import flash_attention as fa
    from deeplearning4j_tpu_torch.kernels import fused_lstm as fl
    from deeplearning4j_tpu_torch.kernels import fused_ops as fo
    from deeplearning4j_tpu_torch.kernels import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build(KERNEL_SOURCES, verbose=True)
    log(f"built {len(KERNEL_SOURCES)} kernels in "
        f"{time.perf_counter() - t0:.1f} s")
    seconds, last = {}, [time.perf_counter()]

    def mark(name):
        """Host seconds of the phases since the last mark."""
        now = time.perf_counter()
        seconds[name] = round(now - last[0], 1)
        last[0] = now

    if args.obs_only:
        obs_plane(fa, pa, smi)
        return 0
    if args.quant_only:
        quant_spec_plane(fa, pa, smi)
        return 0
    if args.samediff_only:
        samediff_phase(fa, pa, fo, fl, smi)
        mark("18 SameDiff and the TF importer")
        log(f"host seconds by phase (after the build): "
            f"{json.dumps(seconds)}")
        return 0
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.zoo_only:
        zoo_phase(fa, pa, fo, fl, smi, gen)
        mark("19 layer and zoo breadth, ONNX")
        log(f"host seconds by phase (after the build): "
            f"{json.dumps(seconds)}")
        return 0
    if args.import_only:
        import_phase(fa, pa, fo, fl, smi, gen)
        mark("20 Keras importer, upstream zips, SameDiff layers")
        log(f"host seconds by phase (after the build): "
            f"{json.dumps(seconds)}")
        return 0
    if args.bert_only:
        bert_phase(fa, pa, fo, fl, set(), gen)
        return 0
    if args.fleet_only:
        fleet_scaleout_phase(fa, pa, fo, fl, smi, gen)
        mark("22 fleet, scale-out, codec")
        log(f"host seconds by phase (after the build): "
            f"{json.dumps(seconds)}")
        return 0
    if args.parallel_only:
        _, k3_checked = k3_phase(fo, gen)
        mark("7 K3")
        parallel_phase(fa, pa, fo, k3_checked)
        mark("21 parallel")
        log(f"host seconds by phase (after the build): "
            f"{json.dumps(seconds)}")
        return 0
    if args.workflow2_only:
        _, k3_checked = k3_phase(fo, gen)
        _, k4_checked = k4_phase(fl, gen)
        mark("7, 9 K3 and K4")
        workflow2_path(fa, pa, fo, fl, k3_checked, k4_checked)
        mark("17 DL4J workflow, the rest")
        log(f"host seconds by phase (after the build): "
            f"{json.dumps(seconds)}")
        return 0
    k2 = {dt: check_paged(pa, dt, gen)
          for dt in (torch.bfloat16, torch.float32)}
    # an LM of head dim 320 (d_model 640, 2 heads): past 256
    k2_320 = {dt: check_paged(pa, dt, gen, h=2, dh=320)
              for dt in (torch.bfloat16, torch.float32)}
    # (dtype, B, T, D); D 80 runs padded to 128 inside the kernels
    k1 = {}
    for dt, b, t, d in (
            (torch.bfloat16, 1, 1024, 64), (torch.bfloat16, 1, 2048, 64),
            (torch.bfloat16, 2, 2048, 64), (torch.float32, 1, 1024, 64),
            (torch.float32, 1, 2048, 64), (torch.float32, 2, 2048, 64),
            (torch.bfloat16, 2, 1024, 80), (torch.float32, 2, 1024, 80),
            (torch.bfloat16, 32, 1024, 64),      # the train path's
            *NARROW_K1_SHAPES, *WIDE_SHAPES, *WIDE_K1_SHAPES):
        k1[(dt, b, t, d)] = check_flash(
            fa, dt, b, t, gen, d=d, time_it=(dt, b, t, d) in TIMED_K1)
        torch.cuda.empty_cache()
    for lm in (D256_LM, D256_LM_F32, D320_LM, D320_LM_F32):
        k1[lm] = check_flash(fa, *lm[:3], gen, h=D256_LM_HEADS, d=lm[3])
        torch.cuda.empty_cache()
    bwd = {}
    for dt, b, t, causal, d in (
            (torch.bfloat16, 1, 1024, True, 64),
            (torch.bfloat16, 1, 2048, True, 64),
            (torch.bfloat16, 1, 4096, True, 64),
            (torch.float32, 1, 2048, True, 64),
            (torch.bfloat16, 2, 200, True, 64),
            (torch.float32, 2, 200, True, 64),
            (torch.bfloat16, 2, 256, False, 64),
            (torch.float32, 2, 256, False, 64),
            (torch.bfloat16, 2, 1024, True, 80),
            (torch.float32, 2, 1024, True, 80),
            (torch.bfloat16, 32, 1024, False, 64),
            (torch.bfloat16, 32, 1024, True, 64),    # the train path's
            *((dt, b, t, True, d) for dt, b, t, d in WIDE_SHAPES),
            *DQ_SPLIT_SHAPES, *TF32_BWD_SHAPES, *NARROW_BWD_SHAPES,
            *WIDE_BWD_SHAPES):
        bwd[(dt, b, t, causal, d)] = check_flash_bwd(
            fa, dt, b, t, causal, gen, d=d,
            time_it=(dt, b, t, causal, d) in TIMED_BWD)
        torch.cuda.empty_cache()
    lm_bwd = (*D256_LM[:3], True, D256_LM[3])
    lm_bwd_f32 = (*D256_LM_F32[:3], True, D256_LM_F32[3])
    lm320_bwd = (*D320_LM[:3], True, D320_LM[3])
    lm320_bwd_f32 = (*D320_LM_F32[:3], True, D320_LM_F32[3])
    for key in (lm_bwd, lm_bwd_f32, lm320_bwd, lm320_bwd_f32):
        bwd[key] = check_flash_bwd(fa, *key[:4], gen, h=D256_LM_HEADS,
                                   d=key[4])
        torch.cuda.empty_cache()
    mark("2-3b flash and paged kernels")
    k3, k3_checked = k3_phase(fo, gen)
    k4, k4_checked = k4_phase(fl, gen)
    mark("7, 9 K3 and K4")
    if args.kernels_only:
        return 0

    by_path = main_path(fa, pa, profile=args.profile)
    mark("4 serving")
    by_path.update(serve_d320(fa, pa))
    mark("4b D320 serving")
    by_path["train"] = train_path(fa, pa, profile=args.profile_train,
                                  foreach_adamw=True)
    # an LM of head dim 256 (2 heads): three steps (eager, capture,
    # replay), bf16 K1, dQ and dK/dV on the tensor cores; then in f32, all
    # three in split TF32
    by_path["train_d256"] = train_path(fa, pa, steps=3, batch=8, n_heads=2,
                                       n_layers=2, tag="train D256",
                                       profile=args.profile_train)
    by_path["train_d256_f32"] = train_path(fa, pa, steps=3, batch=8,
                                           n_heads=2, n_layers=2,
                                           tag="train D256 f32",
                                           dtype=torch.float32)
    # the LM of head dim 320 (d_model 640, 2 heads): K1, dQ and dK/dV on
    # their wide kernels; each its own path
    for dt, key, tag in ((torch.bfloat16, "train_d320", "train D320"),
                         (torch.float32, "train_d320_f32",
                          "train D320 f32")):
        by_path[key] = train_path(fa, pa, steps=3, batch=D320_LM[1],
                                  n_heads=2, n_layers=2, tag=tag, dtype=dt,
                                  d_model=D320_D_MODEL, profile=True)
    mark("6 LM training")
    by_path.update(resnet_path(fa, pa, fo, k3_checked,
                               profile=args.profile_resnet))
    mark("8 ResNet-50")
    lstm_paths = charnn_path(fa, pa, fo, fl, k4_checked,
                             profile=args.profile_charnn)
    charnn_k4_ab(fl)
    mark("10 char-RNN")
    lenet_direct = lenet_path(fa, pa, fo, fl)["graph"]["samples_per_s"]
    mark("11 LeNet")
    workflow = workflow_path(fa, pa, fo, fl, k3_checked, k4_checked)
    # the workflow's ResNet-50 paths run K3 only: every other counter 0
    zero = dict.fromkeys(by_path["resnet_train"], 0)
    by_path.update({p: {**zero, **c} for p, c in workflow.items()
                    if p.startswith("workflow_resnet")})
    lstm_paths["workflow_charnn"] = workflow["workflow_charnn"]
    mark("12 DL4J workflow")
    planes, k2_shared = serving_planes(fa, pa, smi)
    by_path.update(planes)
    mark("13 serving planes")
    serving_zero = dict.fromkeys(serving_counts(fa, pa), 0)
    by_path.update({p: {**serving_zero, **c}
                    for p, c in obs_plane(fa, pa, smi).items()})
    mark("14 obs plane")
    by_path.update({p: {**serving_zero, **c}
                    for p, c in quant_spec_plane(fa, pa, smi).items()})
    mark("15 quant/spec plane")
    by_path.update(bert_phase(fa, pa, fo, fl, k3_checked, gen))
    mark("16 BERT and serving")
    workflow2 = workflow2_path(fa, pa, fo, fl, k3_checked, k4_checked,
                               lenet_direct)
    by_path.update({p: {**zero, **c} for p, c in workflow2.items()
                    if p.startswith("workflow2_resnet")})
    lstm_paths.update({p: c for p, c in workflow2.items()
                       if p.startswith("workflow2_charnn")})
    mark("17 DL4J workflow, the rest")
    sd_counts = samediff_phase(fa, pa, fo, fl, smi)
    by_path["samediff"] = sd_counts
    lstm_paths["samediff"] = sd_counts
    mark("18 SameDiff and the TF importer")
    zoo_paths, _, zoo_held = zoo_phase(fa, pa, fo, fl, smi, gen, k3_checked)
    by_path.update(zoo_paths)
    lstm_paths.update(zoo_paths)
    for key, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        k1[(dt, ATTN_B, ATTN_T, ATTN_C // ATTN_H)] = zoo_held[key]["fwd"]
        bwd[(dt, ATTN_B, ATTN_T, True, ATTN_C // ATTN_H)] = \
            zoo_held[key]["bwd"]
    mark("19 layer and zoo breadth, ONNX")
    import_paths, _ = import_phase(fa, pa, fo, fl, smi, gen, k3_checked,
                                   k4_checked)
    by_path.update(import_paths)
    lstm_paths["import_charnn"] = import_paths["import_charnn"]
    mark("20 Keras importer, upstream zips, SameDiff layers")
    by_path.update(parallel_phase(fa, pa, fo, k3_checked))
    mark("21 parallel")
    fleet_paths, fleet_lstm = fleet_scaleout_phase(
        fa, pa, fo, fl, smi, gen, k3_checked, k4_checked)
    by_path.update(fleet_paths)
    lstm_paths.update(fleet_lstm)
    mark("22 fleet, scale-out, codec")
    log(f"host seconds by phase (after the build): {json.dumps(seconds)}")
    # the stage-0 BN's shape (N = 128*56*56, C = 256) stands for K3
    main_k3 = k3[(torch.bfloat16, RESNET_BATCH * 56 * 56, 256)]
    resnet_paths = ("resnet_train", "resnet_output", "resnet_fitscan",
                    "workflow_resnet_fit", "workflow_resnet_evaluate",
                    "resnet_serve", *(f"workflow2_resnet_remat{r}"
                                      for r in REMAT_SETTINGS),
                    "zoo_yolo2_fit", "zoo_yolo2_output",
                    "import_resnet50_output", "import_resnet50_fit",
                    "parallel_resnet_dp1", "parallel_resnet_dp2_gloo",
                    "scaleout_resnet")
    main_k1 = k1[(torch.bfloat16, 1, 2048, 64)]    # a dense prefill's shape
    train_k1 = k1[(torch.bfloat16, 32, 1024, 64)]  # the train path's shape
    main_k2 = k2[torch.bfloat16]
    main_bwd = bwd[(torch.bfloat16, 32, 1024, True, 64)]  # the train path's
    # K4 at the char-RNN's shape, by route, each with the launches the
    # paths counted on it (charnn_path and workflow_charnn require them
    # all on the cluster route)
    k4_kernels = {"cluster": "lstm_seq_cluster_mma_kernel (bf16, tensor "
                             "cores; f32 lstm_seq_cluster_ffma_kernel)",
                  "block": "lstm_seq_kernel (CUDA cores, rw re-read from "
                           "L2 every step)"}

    def k4_entry(route):
        r = k4[torch.bfloat16][route]
        launches = {p: c[f"fused_lstm_{route}"]
                    for p, c in lstm_paths.items()}
        return {"name": "fused_lstm" + ("" if route == "cluster"
                                        else "_block"),
                "route": "cuda",
                "source": "deeplearning4j_tpu_torch/csrc/fused_lstm.cu",
                "replaces": "deeplearning4j_tpu/kernels/fused_lstm.py:90",
                "kernel": k4_kernels[route], "k4_route": route,
                "shape": f"B{CHARNN_BATCH} T{CHARNN_T} H{CHARNN_H} bf16",
                "launches": sum(launches.values()),
                "launches_by_path": launches,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "other_route_ms": k4[torch.bfloat16][
                    "block" if route == "cluster" else "cluster"]["ms"],
                "plan": list(r["plan"]),
                "f32": {k: k4[torch.float32][route][k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms")},
                **({"max_active_clusters": r["max_active_clusters"]}
                   if route == "cluster" else {})}
    # the padded-256 kernels at B1 H8 T1024 D256 and the D 256 LM's, in
    # bf16 (tensor cores) and f32 (split TF32); the wide kernels at B1 H8
    # T1024 D320 and the D 320 LM's (D 512 beside them); the narrow
    # split-TF32 K1, dQ and dK/dV at B1 H8 T2048 D64; the general kernels
    # at a D they still serve (f32 D 520)
    d256 = (torch.bfloat16, 1, 1024, 256)
    wide_k1 = {"wgmma": k1[d256],
               "tf32x3": k1[(torch.float32, 1, 1024, 256)]}
    wide_k1_lm = {"wgmma": k1[D256_LM], "tf32x3": k1[D256_LM_F32]}
    f32_k1 = k1[(torch.float32, 1, 2048, 64)]
    f32_bwd = bwd[(torch.float32, 1, 2048, True, 64)]
    gen_k1 = k1[(torch.float32, 1, 1024, 520)]
    gen_bwd = bwd[(torch.float32, 1, 1024, True, 520)]
    tf32_bwd = bwd[(torch.float32, 1, 1024, True, 256)]

    def family(key, kernel, kind, wide=None):
        """Phase 3/3b keys (dtype, B, T, D) that ``kernel`` runs on
        ``kind``, past D 128 only (wide True) or up to it (False)."""
        return fa.route(key[-1], key[0], kernel) == kind and (
            wide is None or (key[-1] > 128) == wide)

    def launches_of(name, kind, wide=None):
        """Launches of ``name`` (a FLASH_NAMES value) on ``kind`` by path;
        with ``wide``, of the padded-256 kernel (True) or of the kernel at
        D <= 128 of the same family (False): the split-TF32 kernels'
        from the narrow kernels' own count, bf16's by the D 256 LMs'
        paths."""
        key = f"{name}_{FAMILY_KEYS[kind]}"
        if kind == "tf32x3" and wide is not None:
            narrow = f"{key}_narrow"
            return {p: c.get(narrow, 0) if not wide
                    else c.get(key, 0) - c.get(narrow, 0)
                    for p, c in by_path.items()}
        return {p: c.get(key, 0) for p, c in by_path.items()
                if wide is None or p.startswith("train_d256") == wide}

    def timed(r, part=None):
        r = r if part is None else {**r[part], "plain_ms": r["plain_ms"],
                                    "library_ms": r["library_ms"]}
        return {key: r[key] for key in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms",
                                        "ffma_bound_ms") if key in r}

    def entry(kernel, kind, suffix, what, dtype, results, shape, main,
              wide=None, lm=None, more=None):
        """One flash kernel's line: launches by path, the largest error
        over every phase 3/3b shape it ran in ``dtype``, its times at
        ``shape`` (``main``) and, where given, at a second path shape
        (``lm``) and at more shapes (``more``: label → result)."""
        name = FLASH_NAMES[kernel]
        part = None if kernel == "fwd" else kernel
        launches = launches_of(name, kind, wide)
        e = {"name": name + suffix, "route": "cuda",
             "source": "deeplearning4j_tpu_torch/csrc/flash_attention_"
                       + ("fwd.cu" if kernel == "fwd" else "bwd.cu"),
             "replaces": "deeplearning4j_tpu/kernels/flash_attention.py:"
                         f"{FLASH_LINES[kernel]}",
             "kernel": what, "dtype": str(dtype)[6:],
             "launches": sum(launches.values()), "launches_by_path": launches,
             "max_abs_err": max((r if part is None else r[part])["max_abs_err"]
                                for key, r in results.items()
                                if key[0] == dtype
                                and family(key, kernel, kind, wide)),
             "shape": shape, **timed(main, part)}
        if lm is not None:
            e["lm_shape"] = {"shape": lm[0], **timed(lm[1], part)}
        for label, r in (more or {}).items():
            e[label] = timed(r, part)
        return e

    kernels = [
        entry("fwd", "wgmma", "", "flash_fwd_wgmma_kernel (bf16, tensor "
              "cores)", torch.bfloat16, k1, "B1 H8 T2048 D64", main_k1,
              wide=False, lm=("B32 H8 T1024 D64 (the train path's)",
                              train_k1)),
        entry("fwd", "wgmma", "_d256", "flash_fwd_wgmma_kernel<256, 64> "
              "(bf16, tensor cores, padded D 256)", torch.bfloat16, k1,
              "B1 H8 T1024 D256 bf16", wide_k1["wgmma"], wide=True,
              lm=("B8 H2 T1024 D256 bf16", wide_k1_lm["wgmma"])),
        entry("fwd", "tf32x3", "_tf32x3_f32", "flash_fwd_tf32x3_kernel (f32 "
              "D 129-256, split-TF32 tensor-core products, padded D 256)",
              torch.float32, k1, "B1 H8 T1024 D256 f32", wide_k1["tf32x3"],
              wide=True, lm=("B8 H2 T1024 D256 f32", wide_k1_lm["tf32x3"])),
        entry("fwd", "wgmma-wide", "_wide", "flash_fwd_wgmma_kernel<384|512, "
              "32> (bf16 D 264-512, two warpgroups that split O's "
              "columns)", torch.bfloat16, k1, "B1 H8 T1024 D320 bf16",
              k1[(torch.bfloat16, 1, 1024, 320)],
              lm=("B8 H2 T1024 D320 bf16", k1[D320_LM]),
              more={"d512": k1[(torch.bfloat16, 1, 1024, 512)]}),
        entry("fwd", "tf32x3-wide", "_tf32x3_wide_f32",
              "flash_fwd_tf32x3_wide_kernel<320|384, 64|512, 32> (f32 D "
              "257-512, split-TF32 products on warp pairs that split O's "
              "columns)", torch.float32, k1, "B1 H8 T1024 D320 f32",
              k1[(torch.float32, 1, 1024, 320)],
              lm=("B8 H2 T1024 D320 f32", k1[D320_LM_F32]),
              more={"d512": k1[(torch.float32, 1, 1024, 512)]}),
        entry("fwd", "tf32x3", "_tf32x3_narrow_f32", "flash_fwd_tf32x3_"
              "narrow_kernel (f32 D <= 128, split-TF32 tensor-core "
              "products, padded D 64 or 128, a warp owns 16 whole rows)",
              torch.float32, k1, "B1 H8 T2048 D64 f32 causal", f32_k1,
              wide=False,
              more={"attention_layer_path": zoo_held["f32"]["fwd"]}),
        entry("fwd", "general", "_general_f32", "flash_fwd_general_kernel "
              "(D past 512, bf16 D % 8 != 0; CUDA cores)", torch.float32, k1,
              "B1 H8 T1024 D520 f32", gen_k1),
    ]
    for part in ("dq", "dkv"):
        kernels += [
            entry(part, "wgmma", "", f"flash_bwd_{part}_wgmma_kernel (bf16, "
                  "tensor cores)", torch.bfloat16, bwd,
                  "B32 H8 T1024 D64 causal (the train path's)", main_bwd,
                  wide=False),
            entry(part, "wgmma", "_d256", f"flash_bwd_{part}_wgmma_split_"
                  "kernel (bf16, two warpgroups, padded D 256)",
                  torch.bfloat16, bwd, "B1 H8 T1024 D256 bf16 causal",
                  bwd[(*d256[:3], True, 256)], wide=True,
                  lm=("B8 H2 T1024 D256 bf16 causal", bwd[lm_bwd])),
            entry(part, "tf32x3", "_tf32x3_f32", f"flash_bwd_{part}_tf32x3_"
                  "kernel (f32 D 129-256, split-TF32 tensor-core products, "
                  "padded D 256)", torch.float32, bwd,
                  "B1 H8 T1024 D256 f32 causal", tf32_bwd, wide=True,
                  lm=("B8 H2 T1024 D256 f32 causal", bwd[lm_bwd_f32])),
            entry(part, "tf32x3", "_tf32x3_narrow_f32", f"flash_bwd_{part}_"
                  "tf32x3_narrow_kernel (f32 D <= 128, split-TF32 "
                  "tensor-core products, padded D 64 or 128, a warp owns "
                  "16 whole rows)", torch.float32, bwd,
                  "B1 H8 T2048 D64 f32 causal", f32_bwd, wide=False,
                  more={"attention_layer_path": zoo_held["f32"]["bwd"]}),
            entry(part, "wgmma-wide", "_wide", {
                "dq": "flash_bwd_dq_wgmma_split_kernel<DqSplitCfg<384, 32>|"
                      "<512, 16>> (bf16 D 264-512, two warpgroups that split "
                      "dQ's columns)",
                "dkv": "flash_bwd_dkv_wgmma_cluster_kernel<96|128> (bf16 D "
                       "264-512, a cluster of two CTAs, four warpgroups "
                       "that each own a quarter of the columns)"}[part],
                  torch.bfloat16, bwd, "B1 H8 T1024 D320 bf16 causal",
                  bwd[(torch.bfloat16, 1, 1024, True, 320)],
                  lm=("B8 H2 T1024 D320 bf16 causal", bwd[lm320_bwd]),
                  more={"d512": bwd[(torch.bfloat16, 1, 1024, True, 512)]}),
            entry(part, "tf32x3-wide", "_tf32x3_wide_f32",
                  f"flash_bwd_{part}_tf32x3_kernel<Tf32{part.capitalize()}"
                  "Cfg<320|384|512, 2>> (f32 D 257-512, split-TF32 "
                  "products on a cluster of two CTAs that split the "
                  "columns)", torch.float32, bwd,
                  "B1 H8 T1024 D320 f32 causal",
                  bwd[(torch.float32, 1, 1024, True, 320)],
                  lm=("B8 H2 T1024 D320 f32 causal", bwd[lm320_bwd_f32]),
                  more={"d512": bwd[(torch.float32, 1, 1024, True, 512)]}),
            entry(part, "general", "_general_f32", f"flash_bwd_{part}_"
                  "general_kernel (D past 512, bf16 D % 8 != 0; CUDA "
                  "cores)", torch.float32, bwd,
                  "B1 H8 T1024 D520 f32 causal", gen_bwd),
        ]
    kernels += [
        {"name": "paged_attention", "route": "cuda",
         "source": "deeplearning4j_tpu_torch/csrc/paged_attention.cu",
         "replaces": "deeplearning4j_tpu/kernels/paged_attention.py:72",
         "kernel": "paged_partial_kernel + paged_combine_kernel (split-K)",
         "launches": sum(c["paged_attention"] for c in by_path.values()),
         "launches_by_path": {p: c["paged_attention"]
                              for p, c in by_path.items()},
         "max_abs_err": main_k2["max_abs_err"],
         "ms": main_k2["ms"], "call_ms": main_k2["call_ms"],
         "plain_ms": main_k2["plain_ms"],
         "bound_ms": main_k2["bound_ms"], "bound_by": main_k2["bound_by"],
         "library_ms": None,
         "dh320": {str(dt)[6:]: {key: r[key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
             for dt, r in k2_320.items()},
         "shared_pages": {"shape": "phase 13's: 8 slots on one 1024-token "
                                   "prefix, H8 Dh64 bf16, 72 entries",
                          **k2_shared}},
        *({"name": name, "route": "cuda",
           "source": "deeplearning4j_tpu_torch/csrc/fused_bn_act.cu",
           "replaces": f"deeplearning4j_tpu/kernels/fused_ops.py:{line}",
           "launches": sum(by_path[p][name] for p in resnet_paths),
           "launches_by_path": {p: by_path[p][name] for p in resnet_paths},
           "max_abs_err": max(r[name]["max_abs_err"]
                              for (dt, _, _), r in k3.items()
                              if dt == torch.bfloat16),
           "ms": main_k3[name]["ms"], "plain_ms": main_k3[name]["plain_ms"],
           "bound_ms": main_k3[name]["bound_ms"],
           "bound_by": main_k3[name]["bound_by"],
           "library_ms": main_k3[name]["library_ms"]}
          for name, line in K3_LINES.items()),
        *(k4_entry(route) for route in ("cluster", "block")),
    ]
    log(json.dumps({"kernels": kernels, "launches_counted": (
        "the serving and train paths replay CUDA graphs: an eager call and "
        "a capture count their wrappers' launches, each replay its "
        "capture's (launches per replay x replays)")}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
