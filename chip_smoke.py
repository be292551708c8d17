"""On-card check of the PyTorch/CUDA port: build, hold, serve, train, evaluate.

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the numbers to mean what PERF.md says)
and the CUDA toolkit; run from the root of the repository. It

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the hand-written kernels from ``deeplearning4j_torch/csrc``
   (one ``nvcc`` per source, started together);
3. holds each kernel against its plain PyTorch version on the card, timing
   both and printing the card's least possible time for the same work: K1
   and K3 at serving shapes (b=32, T=200, H=512, bf16 recurrent weights,
   peepholes; K1 with a fractional mask and without), and at the training
   shape (b=64, T=50) K1 and K3 writing the BPTT reserve, K2 and K4 (each
   backward fed the same dy, reserve and state as its plain version; K1
   to K4 launched twice and required bitwise equal, their bodies logged:
   tensor cores for bf16 weights, named by the exports
   ``dl4j_lstm_fwd_tc``, ``dl4j_lstm2_fwd_tc``, ``dl4j_lstm_bwd_tc`` and
   ``dl4j_lstm2_bwd_tc``); then K3 (both instantiations) over 132 small
   cases on both of its bodies (bf16 weights at b 1/8/17/32/64/65, f32 at
   b 1/8/17/32/64, H 64/512, T 1/2/50, peepholes on and off; the f32
   shapes with no grid must raise; the reserve's gradients through the
   plain backward), K4 over 96 small cases on both of its bodies (bf16 and
   f32 weights, b 1/8/17/64, H 64/512, T 1/2/50, peepholes on and off), and
   K1 (both instantiations) and K2 over 264 small cases on both of their
   bodies (bf16 and f32 weights, b 1/8/17/32/64 and 65 in bf16, H 64/512,
   T 1/2/50, peepholes on and off, no mask and a fractional one);
4. builds the full-width char-RNN of bench.py:230 (vocab 80, 2 x
   GravesLSTM(512), RnnOutputLayer softmax, Adam, bf16 compute, TBPTT 50)
   on the card from a seed, serves it over HTTP twice — ``charrnn`` with
   time buckets (masked requests, K1) and ``charrnn_fixed`` at T=200
   (unmasked requests, K3) — sends concurrent requests to both and some
   ``rnn_time_step`` calls, and checks every answer against
   ``model.output`` and the CPU reference;
5. trains it with ``fit`` on b=64, T=200 batches of periodic text:
   unmasked fits (each TBPTT segment one K3-with-reserve and one K4
   launch) and masked fits with variable lengths (each segment two K1-
   with-reserve and two K2 launches), checks that the loss is finite and
   falls, prints a fit's time through the input pipeline and
   synchronously (alternating turns), what a single-DataSet fit's
   pipeline costs outside its steps, the host copy into pinned memory by
   torch and by numpy, and a profile of one unmasked fit (with
   K3's and K4's shares of its device time) and of one masked fit (with K1's and
   K2's), and holds the card's gradients against the CPU reference's
   (unmasked and masked);
6. saves the trained char-RNN and a TextGenerationLSTM at the reference's
   widths (47 characters, 2 x GravesLSTM(256), f32; from ``ModelSelector``)
   with ``write_model``, loads each back with ``ModelGuesser`` on the card
   (parameters, Adam state and ``output`` bit-equal) and samples 200
   characters at b=4 from a 100-character prompt with ``generate_tokens``:
   exactly one K3 launch a call (two K1 where K3 has no grid), the prompt's
   launch and the first one-step launches held against the plain version,
   the same seed the same characters; times K3 and K1 at T=1, b=4 beside
   their plain versions and bounds; and serves an un-built
   TextGenerationLSTM (a ``ZooModel``) over HTTP, answers checked against
   its ``output``;
7. holds the flash-attention kernels K5 (forward), K6 (dq) and K7 (dk/dv)
   against their plain versions at small shapes over their options (f32
   and bf16, head dims 16, 64, 80 and 128, so that both routes of each
   kernel's static choice are held, Tq != Tk, lengths that are odd
   multiples of 64, masks, dropout) and at the TransformerLM's shape (b=4,
   h=8, T=8192, d=64, bf16): causal (timed, beside the card's bound, K5
   and ``scaled_dot_product_attention``'s forward in alternating turns;
   K5, K6 and K7 launched twice and required bitwise equal), non-causal,
   with a key mask that pads one example whole (its rows and gradients
   must be exactly 0), and with dropout at a seed and nonzero offsets; and
   checks the kernel's dropout keep bits against ``dropout_keep_mask``;
8. builds the 8-block TransformerLM of bench.py:1730 (vocab 4096, embed
   512, 8 heads, FFN 4x, bf16 compute, Adam) on the card from a seed, runs
   ``output`` on one b=4, T=8192 batch (one K5 launch per block) and
   trains it with ``fit`` on period-23 token text (per step one K5, one K6
   and one K7 launch per block), checks that the loss is finite and falls,
   prints a step's time through the pipeline and synchronously
   (alternating turns) and a profile of one step, and holds the card's
   score and gradients against the CPU reference's at reduced width and
   depth on the flash route (T=4096);
9. runs the TransformerLM's fit through the input pipeline
   (``datasets/prefetch.py``) three ways, each one ``fit`` of 3 distinct
   batches cycled to 6 steps: synchronously (``DL4J_TPU_PREFETCH_WORKERS=0``),
   with put-ahead (pinned staging, a side CUDA stream) and with
   ``CacheMode.DEVICE``; fresh nets from one seed must give the same
   losses; times the three in alternating turns; and traces a cached step
   (no H2D copy of a batch) and a put-ahead fit (each batch's copy pinned,
   off the compute stream, and how much of it kernels overlap). The
   char-RNN fits of step 5 run through the pipeline too, timed beside the
   synchronous path in alternating turns;
10. saves the TransformerLM trained in step 8 with its Adam state, loads it
   back with ``ModelGuesser`` on the card (``output`` at b=4, T=8192 and
   the moments bit-equal) and samples 256 tokens at b=4 from a 384-token
   prompt through the layers' 512-slot KV cache, so the window rolls at
   the 129th token (no kernel of the repo launches: the cached attention
   is the dense body); each sampled distribution sums to 1 within 2^-8;
   the same seed the same tokens; prefill ms, ms a token, tokens/s, peak
   memory and a profiled decode step; then streams 512 tokens one at a
   time against ``output`` on them, in bf16 and in an f32 twin;
11. runs an f32-weight 2 x GravesLSTM(512) net at b=32, where K3 has no
   grid, per layer through ``output``, ``rnn_time_step`` and ``fit``
   against the CPU, and an f32 d=256 attention at T=4096, past what the
   flash kernels take in f32, through ``mha``'s dense body against the
   flash plain versions;
12. trains ResNet50 at bench.py:187's shape (b=256, 3x224x224, 1000
   classes, bf16, Adam) through ``ComputationGraph.fit`` under
   ``CacheMode.DEVICE``: 3 warm-up and 25 timed steps, ms a step, images/s
   and peak memory; finite losses, every BN layer's running mean and var
   moved; ``output`` on the batch (finite rows summing to 1); one profiled
   step (device busy share; device time and launches of cuDNN
   convolutions, BN, other elementwise work, pooling and the updater; no
   NCHW/NHWC transposition kernel);
13. trains LeNet at bench.py:202's shape (b=1024, bf16, iterations(10),
   ``CacheMode.DEVICE``) through ``MultiLayerNetwork.fit``: ms a step and
   images/s over ten fits, a falling loss, ``output``;
14. holds ResNet50 at 3x64x64, b=8 on the card in f64, f32 with TF32 off,
   and bf16 against the CPU in f64 (output, score, gradients), the CPU
   replaying the card's ReLU signs and max-pool picks, at fixed limits;
15. (``moe_lm``) builds the TransformerLM of step 8 with every block's FFN
   up-projection a MoEDenseLayer (8 experts, top 2, capacity factor 1.25,
   aux loss weight 1e-2) under ``CacheMode.DEVICE``: ``output`` (8 K5
   launches; rows summing to 1), 4 ``fit`` steps (each 8 K5, 8 K6 and 8
   K7; the loss finite and falling), the aux loss, each expert's share of
   the assignments and the share dropped over capacity, the MoE step
   beside the dense model's in alternating turns (ms, tokens/s, peak
   memory), a profiled step grouped into the MoE products, K5-K7, the
   dense products, the updater and elementwise work; capacity dispatch
   against the dense combine at the model's shape where nothing drops;
   the trained net saved, guessed back and sampling 32 tokens at b=4 (the
   dense combine, no K5-K7); and a 2-block, 4-expert f32 copy against the
   CPU on the flash route (T=4096);
16. (``graph_tbptt``) builds the char-RNN of step 4 as a ComputationGraph
   from the MultiLayerNetwork's weights: one segment's gradients against
   the MLN's (K1/K2 a layer against the fused K3/K4), a TBPTT fit of b=64,
   T=200 (each of the 4 segments 2 K1 with the reserve and 2 K2; the loss
   and parameters against the MLN's fit), both fits timed in alternating
   turns; and a small two-input, two-output graph (Merge, LastTimeStep,
   DuplicateToTimeSeries, Subset and L2Normalize vertices, two f32 LSTMs)
   fitting a MultiDataSet and taking external errors, card against CPU;
17. (``regularized_char_rnn``) fits the char-RNN of step 4 once each with
   dropout 0.8 on layer 0 (the pair stays on K3/K4: 4 launches each),
   dropout 0.8 on layer 1 and DropConnect 0.9 on layer 0 (the pair splits:
   8 K1 and 8 K2), MaxNorm 1.0 on both LSTMs (every column norm of W and
   RW at most 1 after) and the retain probability 1.0 everywhere (loss and
   parameters bit-equal to the plain fit's); holds the dropout and
   DropConnect losses and gradients on the card against a CPU copy that
   replays the card's draws; times each fit, and a fit with two listeners,
   beside the plain fit in alternating turns; stops a fit over three
   minibatches, the second NaN, with ``TrainingHealthListener(action=
   "halt")`` after that minibatch; and restores the last
   ``CheckpointListener`` zip bit for bit. (``lm_dropout``) fits the
   TransformerLM of step 8 with attention dropout 0.1 under
   ``CacheMode.DEVICE`` (8 K5, 8 K6 and 8 K7 a step, every call with a
   seed; the loss falls by 20% over 4 steps), times its step beside the
   dropout-free step, checks K5's keep bits in a full-shape call against
   ``dropout_keep_mask`` and times K5-K7 with dropout beside
   ``scaled_dot_product_attention(dropout_p=0.1)``. (``solvers``) runs
   LBFGS on a 4096 x 784 -> 512 -> 10 f32 net: card against CPU at the
   card's iterates and along an independent CPU run, then 30 iterations
   against 30 SGD steps;
18. (``evaluation``) trains the char-RNN of step 4 with
   ``EarlyStoppingTrainer`` (two b=64, T=200 batches of one text cycle,
   ``DataSetLossCalculator`` over two more, ``MaxEpochsTerminationCondition(3)``
   and ``ScoreImprovementEpochTerminationCondition(1)``) once with
   ``InMemoryModelSaver`` and once with ``LocalFileModelSaver``: the same
   scores and epochs, each training batch 4 K3 with the reserve and 4 K4,
   the best model restored from its zip onto the card answering bit for bit
   as the in-memory best; ``evaluate`` of the best model on a masked batch
   (2 K1) and an unmasked one (1 K3); ``ComputationGraph.evaluate`` of the
   TransformerLM of step 8 over two b=4, T=8192 batches (8 K5 each), per
   batch the forward, the on-card reduction, the labels' host argmax and
   the bytes copied to the host (the [b*T] index vector only), then the
   graph kept by ``InMemoryModelSaver`` (a deep copy) answering bit for
   bit; every on-card ``Evaluation`` held count for count against the same
   class fed the predictions copied to the host; SimpleCNN (3x48x48, b=256) on the
   LFW fetcher's synthetic stand-in and LeNet on ``MnistDataSetIterator``'s
   (b=1024) fit and evaluated, the fetchers reading an empty data directory
   under ``build/``;
19. (``recurrent_family``) at the char-RNN's widths (vocab 80, H=512,
   b=64, T=200, bf16, Adam 1e-3): ``bidir_char_rnn``, 2 x
   GravesBidirectionalLSTM(512) + RnnOutputLayer, 3 unmasked and 3 masked
   fits (each step 4 K1 with the reserve and 4 K2, no K3/K4; the loss
   falls), ``output`` (4 K1), a profile of one masked fit (K1's and K2's
   shares); ``bidir_classifier``, LastTimeStep(Bidirectional(LSTM(512),
   concat)) + OutputLayer over 128 CSV sequences of lengths 50-200 that
   it writes to a temporary directory and reads back through
   SequenceRecordReaderDataSetIterator (each step 2 K1 with the reserve
   and 2 K2), then ``evaluate`` (2 K1 a batch); ``simple_rnn``, 2 x
   SimpleRnn(512) by TBPTT and ``rnn_time_step`` over 200 characters one
   at a time against ``output`` (no K1-K4 launch); ``lstm_step_loop``, a
   softsign GravesLSTM(512) and a tanh GravesLSTM(500), which the kernels
   decline, through the step loop (no K1-K4 launch) beside a tanh
   GravesLSTM(512) on K1/K2; every net's gradients, score and output held
   against the CPU masked and unmasked, each step timed by CUDA events in
   alternating turns;
20. (``cnn_family``) trains VGG16 at bench.py:195's shape (b=256,
   3x224x224, 1000 classes, bf16, Adam; ``ModelSelector``) through
   ``MultiLayerNetwork.fit`` under ``CacheMode.DEVICE``: 2 warm-up and 8
   timed steps, ms a step, images/s, peak memory, finite losses, ``output``
   rows summing to 1, one profiled step grouped into cuDNN conv, pooling,
   the dense GEMMs, the updater and elementwise work (no NCHW/NHWC
   transposition kernel); fits VGG19, AlexNet, GoogLeNet,
   InceptionResNetV1 (5/10/5 blocks) and FaceNetNN4Small2 a few steps
   each, ``ModelSelector.select(name).init()`` at their zoo input shapes and
   full width (f32), checks their ``output`` and that FaceNet's centres
   moved for exactly the classes in its batch; holds each new layer
   (Deconvolution2D in both modes at strides 1-3 and dilations 1-2,
   depthwise and separable at multipliers 1 and 2, SpaceToDepth, LRN at n
   5 and 4, the 1-D layers, padding, cropping, upsampling) on the card in
   f64 and bf16 against the CPU in f64 (output, input and parameter
   gradients) at fixed limits; and profiles the grouped, transposed and
   1-D convolutions at b=32, 56x56x64 for transposition kernels; no
   K1-K7 launch in the phase;
21. (``transfer_pretrain``) fine-tunes VGG16 at step 20's shape through
   ``TransferLearning.Builder``: layers 0-19 (through fc2) frozen, a 5-way
   head (``n_out_replace(20, 5, "xavier")``); its fit steps timed against
   the full VGG16 step in alternating turns, one step profiled (no
   backward convolution, no max-pool backward, the updater given layer 20
   only), layers 0-19 bit-equal after every step, peak memory against the
   full step's; ``TransferLearningHelper`` at fc2 (``featurize``,
   ``output_from_featurized`` against the transferred net's output within
   bf16 rounding, ``fit_featurized``); ResNet50 at step 12's shape frozen
   at "gap" with a 10-way head (``GraphBuilder``): fit steps, frozen
   parameters bit-equal, every frozen BN layer's running statistics moved;
   the char-RNN of step 4 with layer 0 frozen, fitted (per TBPTT segment
   one K1 without the reserve for the frozen layer, one K1 with it and one
   K2 for layer 1, no K3/K4; layer 0 bit-equal); pretraining at the
   dl4j-examples' MNIST widths (b=128): stacked RBMs 784-1000-500-250-100-30
   (binary, CD-1), an AutoEncoder 784-250 (corruption 0.3) and the VAE of
   VaeMNISTAnomaly (encoder and decoder 256-256, latent 32, Bernoulli;
   ``reconstruction_log_probability``), ms a pretrain iteration, one step's
   loss and gradients held against the CPU in f64 on the card's draws; and
   Yolo2OutputLayer at TinyYOLO's head (13x13, 5 VOC anchors, 20 classes,
   b=32): loss and input gradient against the CPU in f64, and fit steps of
   a small convolutional trunk ending in it;
22. (``keras_embeddings``) imports Keras models through the HDF5 entry
   points' core (the parsed model_config and weight arrays): Keras
   applications.VGG16 with its top as a Functional config (224x224x3, 1000
   classes, weights from a seed) as a ComputationGraph, its f32 output at
   b=8 against a plain NHWC forward written from the Keras arrays (the
   Flatten -> Dense kernel permutation at 25088 rows), then bf16 Adam fits
   at b=256 in alternating turns with the zoo VGG16 (ms a step, peak
   memory); a Keras LSTM(512) -> LSTM(512) -> TimeDistributed(Dense(80,
   softmax)) at b=64, T=200: its f32 output (two K1 launches) against a
   numpy Keras LSTM in Keras's gate order, its bf16 twin's output (one K3)
   and fits (each one K3 with the reserve and one K4, peepholes off), the
   first launch of each kernel held against its plain version and timed,
   card vs CPU gradients; then Word2Vec (HS, negative sampling, CBOW) at
   bench.py:1645-1661's corpus (20,000 x 40 zipf words, vector 128, window
   5, batch 8192): words/s, a profiled refit's busy share, one batch's
   step against the CPU in f64, and the HS fit of 1,000 sentences against
   the CPU's; ParagraphVectors (DBOW, 100 labels, batch 512) with
   ``predict``; GloVe
   on 5,000 sentences; DeepWalk on a BlogCatalog-sized graph with 39
   planted communities (nearest neighbours in the own community); no K1-K7
   launch outside the char-LSTM;
23. (``remat_clustering``) runs VGG16 and ResNet50 at steps 20's and 12's
   shapes and the TransformerLM of step 9, without and with attention
   dropout 0.1, with remat off and on in alternating turns (median ms a
   step with the spread, peak memory, the loss after 3 steps, the largest
   parameter difference; the TransformerLM step launches 16 K5, 8 K6 and
   8 K7 under remat, 8 of each without, and its losses agree); the
   char-RNN of step 4 under remat "on" (K3 with the reserve twice a TBPTT
   segment, K4 once; masked K1 with the reserve four times, K2 twice) and
   "auto" (the counts of step 5), bit-equal; k-means on 1,000,000 x 128
   points with k=256 (init s, ms a Lloyd iteration, inertia, peak; one
   Lloyd step against the CPU's on 100,000 points); exact t-SNE on 6,000 x
   784 points at perplexity 30 and 500 iterations (host P s, ms a step,
   kl; one step against the CPU's); Barnes-Hut t-SNE on 1,000 points (s an
   iteration, no launch); the nearest-neighbours server over 100,000 x 128
   points (build s, ms a /knnnew query over HTTP, answers against a
   ``torch.cdist`` top-k); and ``utils/profiling.py``: a ``trace`` of a
   TransformerLM step that names K5's kernel, ``step_cost`` of VGG16 beside
   the smoke's count of its convolutions' FLOPs and of the TransformerLM
   beside K5-K7's FLOPs, which the dispatcher cannot see, and
   ``StepTimerListener`` over 6 VGG16 fits;
24. (``parallel``) ParallelWrapper and ParallelInference over the char-RNN
   on 2 slots of the card, ring and Ulysses attention at the
   TransformerLM's shape over 4 slots, and the sequence- and
   expert-parallel steps against the unsharded steps;
25. (``pipeline_paramserver``) GPipe over slots of the card's ``pipe``
   axis: TextGenerationLSTM(80, 512, 3) in bf16 on 2 slots (b=64, T=200,
   4 microbatches: K1 with the reserve and K2 once a layer a microbatch,
   no bubble launch) and the TransformerLM of step 8 on 4 slots (4
   microbatches of one: 32 K5, K6 and K7 a step), each held against the
   unpipelined step (loss; SGD(1) gradients, with a control dropping
   microbatch 0) and timed beside it, the LM's attention dropout
   deterministic for a seed; K1/K2 timed at the microbatch's shape beside
   cuDNN's 1-layer LSTM, K5-K7 at bh=8 beside SDPA;
   ParameterServerTrainingMaster over the char-RNN of step 4 against an
   in-process server (one lossless worker against a plain net's steps, in
   sync and overlap mode with the phases and the hidden share; two worker
   threads at threshold 1e-3: pushes, versions, a falling loss), K3/K4 at
   the worker's full sequence beside cuDNN's 2-layer LSTM; the char-RNN
   fitted from a stream and from Kafka (a stub broker) against a listed
   fit; the native host codec built and held bit for bit against numpy on
   the char-RNN's gradient;
26. (``monitor_sharded_fleet``) the sharded parameter-server fleet over the
   char-RNN of step 4: a lossless worker over 3 shard servers on loopback
   (4 K3 with the reserve and 4 K4; its parameters against a plain net's
   steps and the control, bytes a push a shard, ms a step against a single
   server's in alternating turns), two delta-push workers at
   threshold 1e-3 (8 + 8 launches, a falling held-out loss), a shard killed
   after a worker's first step and restarted from its snapshot (the fit
   degrades, re-injects the dead shard's mass, the next one heals),
   ``scale_to(4)`` with ``remap``; what the monitor planes recorded (the
   registry's series, each server ``ps/apply_push`` span a child of a
   client ``ps/push``, the merged fleet trace with a pid row a worker, the
   flight recorder's JSONL dump in order); and the monitor on against
   ``set_enabled(False)`` on a TransformerLM step and a char-RNN fit in
   alternating turns (equal launches), a profiled LM fit's K5-K7 inside the
   ``step`` range, and the tracer's cost a span;
27. (``serving_plane``) the char-RNN of step 4 served over HTTP from three
   registrations, each on its own copy of the net: precision f32 with time
   buckets (K1's CUDA-core body: f32 has no K3 grid at b <= 32, H=512),
   bf16 with time buckets (K1's tensor-core body) and bf16 at T=200 with a
   response cache (K3); per registration the launches (no training
   kernel), the bodies, the answers (bf16 within 1e-3 of the f32 plain
   forward on the CPU; f32 rows bit for bit their bucket's forward), H2D
   and D2H bytes a flush, and under request-size churn the signatures of
   ``mln/output`` inside ``compile_signatures`` with no first call and no
   retrace storm; a cache hit launching nothing; an ``X-DL4J-Trace`` id
   found on ``/trace`` under ``serving/flush``; the ``serving_*`` series on
   ``/metrics`` and ``/profile``'s p50/p99; HTTP p50/p99 at 8 clients for
   f32, bf16 and cache hits; a warmup artifact exported and two child
   replicas started at once (one from the artifact with an empty
   ``DL4J_TPU_COMPILE_CACHE_DIR``: seconds to its first answer beside the
   kernels' build, no ``nvcc``, bit-equal to the warm replica; one from a
   corrupted copy: ``compile_cache_miss`` and an answer); K1 in f32 timed
   at b=32, T=200; jitwatch's signature check timed a call;
28. (``alerts_probes``) the alert engine, the probe plane and the scrape
   collector over the same three registrations on fresh nets: golden sets
   captured on the card, 8 healthy ticks of the process ``Prober`` (every
   outcome ``ok``, one K1 launch a layer or one K3 launch for every probe
   flush, no response-cache hit); a gray failure (the f32 net's output
   layer times 8 on the card, no version bump) that ``probe_mismatch``
   fires on once, naming the target, with a trace id ``/trace`` resolves,
   and that resolves when undone; a latency burn (a sleep around the bf16
   net) that ``serving_p99_breach`` fires on with an exemplar on
   ``/trace`` and resolves; a ``TelemetryCollector`` over this server and
   a child replica from step 27's artifact (no replay of the child's
   earlier flight events, both on ``/fleet``), the child killed until
   ``fleet_target_down`` and ``fleet_worker_stale`` fire; the training
   rules on a TBPTT fit (K3 with the reserve, K4) whose batch holds a NaN;
   ``/alerts``, ``/probes``, ``/telemetry?since_seq=`` and
   ``alerts_firing`` on ``/metrics``;
29. (``control_incidents``) the control plane and the incident recorder on
   the char-RNN served in bf16 with time buckets (K1, admission cap 64)
   and trained by a delta-push worker over a ``ShardedParameterServerGroup(2)``
   (K3 with the reserve, K4): a sleep around the served net fires a
   latency burn and ``serving_pressure_policy`` steps the cap to 32 once;
   shard 1 is killed during the worker's fit and ``shard_restart_policy``
   restarts it from its snapshot once (the fits launch K3 and K4 once a
   step, finite parameters, the dead shard's mass re-injected,
   ``shard_server_restored``); the sleep removed, the cap comes back;
   ``/events`` in seq order; a stale worker scaled out to 3 servers by
   ``fleet_scale_policy`` (two steps on the new layout), then ``at_max``;
   the f32 registration's output layer times 8 restarted from its zip by
   ``probe_failure_policy`` (every later probe ``ok`` through K1); a child
   replica from step 27's artifact killed and respawned by
   ``fleet_replica_policy``, answering as the server here does; the
   overlapping edges merged into one persisted incident holding both
   rules and both actions, its exemplar spans kept after the tracer is
   cleared, loaded and rendered; a halt (a NaN fit) flushing an open
   incident as ``aborted``; ``/control``, ``/incidents[/<id>]``,
   ``/profile``'s control block and ``/metrics``;
30. (``ui_cli``) the training UI and the operational CLI on the char-RNN
   of step 4 written as a zip: ``python -m deeplearning4j_torch train``'s
   ``main`` fits it (a data factory's 4 batches of b=64, T=200; K3 with
   the reserve and K4, 16 launches each) under a StatsListener writing a
   JSON-lines file, and the trained zip must be bit-equal to a direct
   ``ParallelWrapper`` fit of the same zip and data; the file holds a
   report a batch with the card's memory, and the last report's
   statistics equal numpy's of the trained parameters (rtol 1e-9, counts
   exact); one listener call under ``torch.profiler`` copies at most two
   vectors of at most 64 kB to the host; the fit with and without the
   listener in alternating turns (a step's cost); ``serve-ui`` over the
   file (the train routes and the monitor routes), a second ``train``
   posting through ``--ui-url``; ``monitor --url`` with ``--alerts``,
   ``--control``, ``--incidents`` and ``--profile``; ``incident show`` on
   step 29's aborted bundle; ``cache --stats``/``--gc`` on step 27's
   artifact directory; ``cache --export`` of the trained zip (bf16,
   T=200) and a replica warmed from that artifact answering one request
   through K3, bit-equal to the trained net's forward at its bucket;
31. prints a ``{"cnn": ...}`` line with those numbers, a ``{"generate":
   ...}`` line with steps 6 and 10's, a ``{"moe_lm": ..., "graph_tbptt":
   ...}`` line with steps 15 and 16's, a ``{"regularized_char_rnn": ...,
   "lm_dropout": ..., "solvers": ...}`` line with step 17's, an
   ``{"evaluation": ...}`` line with step 18's and a
   ``{"recurrent_family": ...}`` line with step 19's, a ``{"cnn_family":
   ...}`` line with step 20's, a ``{"transfer_pretrain": ...}`` line
   with step 21's, a ``{"keras_embeddings": ...}`` line with step 22's
   a ``{"remat_clustering": ...}`` line with step 23's, a ``{"parallel":
   ...}`` line with step 24's, a ``{"pipeline_paramserver": ...}`` line
   with step 25's and a ``{"monitor_sharded_fleet": ...}`` line with step
   26's, a ``{"serving_plane": ...}`` line with step 27's, an
   ``{"alerts_probes": ...}`` line with step 28's and a
   ``{"control_incidents": ...}`` line with step 29's and a ``{"ui_cli":
   ...}`` line with step 30's (the card's name and power limit in those), a
   ``{"kernels": [...]}`` line (K1's and K3's entries with their decode
   rows; K1/K2's launches in step 16's fit, K5-K7's in step 15's steps;
   K1-K4's in each regularised fit, K5-K7's in the dropout LM's steps and
   their times with dropout; K1, K3, K4 and K5's in step 18; K1-K4's in
   each path of step 19, in step 21's frozen char-RNN, on step 22's
   imported char-LSTM and under step 23's remat; K5-K7's in step 23's
   TransformerLM steps; every kernel's on each path of steps 24, 25, 26 and
   27, and K1's f32 body at step 27's shape; K1, K3 and K4's in steps 28
   and 29; K3 and K4's in each path of step 30)
   and, last, the
   ``{"ok": true, "device": ...}`` line.

Any failure raises, and the script exits nonzero without the last line.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense): memory, bf16 tensor
# cores, f32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
# Elementwise work per hidden unit per step of one LSTM cell: 3 sigmoids,
# 2 tanh (counted as 4 operations each) plus peepholes, cell and output
# products and sums.
CELL_OPS = 30

# Elementwise work per hidden unit per step of one cell's gradient.
CELL_BWD_OPS = 40

B, T, H, VOCAB = 32, 200, 512, 80
TIME_BUCKETS = (64, 128, 200)
# Training shape: bench.py:230's minibatch and one TBPTT segment of it.
TRAIN_B, TRAIN_T, TRAIN_SEQ = 64, 50, 200
TRAIN_FITS, MASKED_FITS, TIMED_FITS = 10, 3, 3
# Alternating turns in which the char-RNN fits are timed through the
# input pipeline and synchronously; the medians are compared.
FIT_TURNS = 6
# The kernel and its plain version take the same f32 sums in another
# order; h is rounded to bf16 before each product, so a last-bit f32
# difference can move one bf16 operand by one unit (2^-8 relative) and
# that propagates through the recurrence. h and c stay O(1); on an H100
# the largest |kernel - plain| over h and c measured 5e-4 to 8e-4, so the
# limit is about six times that.
KERNEL_ATOL = 5e-3
# Probabilities over 80 characters from a random net sit near 1/80 =
# 0.0125, so a loose limit on them would pass a wrong kernel. Served
# answers vs model.output (the same path up to batch composition and the
# masked K1 route vs the unmasked K3 route) measured 1.2e-4, and the card
# vs the CPU reference (plain loops, CPU bf16 matmuls) 6e-5: 1e-3 leaves
# about ten times that. The CPU reference also compares layer 2's h,
# before the softmax evens it out, at the kernel limit.
SERVE_ATOL = 1e-3
REF_ATOL = 1e-3
# Backward kernels vs their plain versions (dz, dh0, dc0, dpeep at b=64,
# T=50 with dy ~ 0.1): the same f32 sums in another order, and dz rounded
# to bf16 before each product, so one flipped bf16 unit carries back
# through the steps. On an H100 the largest |kernel - plain| measured
# 1.1e-4 (K2) and 1.8e-4 (K4); the limit is about six times that.
BWD_ATOL = 1e-3
# Training on the card vs the CPU reference (compute_gradient_and_score at
# b=4, T=30, full width): cuBLAS and the CPU round the bf16 products and
# the bf16 logits at other places. Measured on an H100: scores 6.0e-4
# relative, gradients 7.4e-3 of their largest entry; the limits are about
# eight and four times that (the CPU tests hold the port to the JAX
# package at 3e-2 on the same quantity).
TRAIN_SCORE_RTOL = 5e-3
TRAIN_GRAD_RTOL = 3e-2
# The loss must fall: the full-batch score of the training batch (its 200
# steps, ``score(ds)``) after each unmasked fit, the mean of the last three
# fits against the first, at least 10% lower. A fit's own score is its last
# TBPTT segment's loss, which the check read until the Adam bias
# corrections became f32 scalars (ROADMAP C 6): that one-ulp change of a
# divisor moved the tenth fit's last segment from 160.7 to 233.4 on an
# H100 (700 W) and the three-fit mean from 20.8% to 6.5% below the first,
# while the full-batch score fell 43.9% (40.2% with the Python-float
# corrections) from the untrained net's; the segment losses are logged.
LOSS_DROP = 0.10

# TransformerLM of bench.py:1730: b=4, T=8192, vocab 4096, embed 512, 8
# heads (d=64), 8 blocks, FFN 4x, bf16 compute, Adam 1e-3.
LM_B, LM_T, LM_VOCAB, LM_E, LM_HEADS, LM_BLOCKS = 4, 8192, 4096, 512, 8, 8
LM_D = LM_E // LM_HEADS
LM_STEPS, LM_TIMED_STEPS = 6, 3
# Flash kernels vs their plain versions, as max |kernel - plain| over max
# |plain| per output (o, dq, dk, dv in bf16): the same f32 sums in another
# order, and p, ds rounded to bf16 against the running max in the kernel
# but the row's final max in the plain version, so an output may differ
# by about one bf16 unit of the largest entry (2^-8 = 3.9e-3). On an H100
# the worst reading was 5.3e-3 at full width and 4.3e-3 at the small
# shapes; the limit is about four times that. lse is f32 and compared
# absolutely (measured 1.9e-6).
FLASH_RTOL = 2e-2
LSE_ATOL = 1e-4
# Alternating turns in which K5 and scaled_dot_product_attention's forward
# are timed at the TransformerLM's shape; the medians are compared.
FWD_TURNS = 5
# f32 operands: the kernels' CUDA-core products sum in another order than
# the plain version's matmul (measured 3.7e-6 on an H100).
FLASH_F32_RTOL = 3e-5
# Fraction by which the TransformerLM's loss must fall from the first to
# the last of LM_STEPS Adam steps on period-23 text: on an H100 it fell
# 61.0% (68400 at the first step, 26676 at the sixth); at least 30%.
LM_LOSS_DROP = 0.30
# Card vs CPU reference for the TransformerLM at reduced width and depth
# (E=128, 2 heads, 2 blocks, b=1, T=4096, flash route on both): cuBLAS and
# the CPU round bf16 activations and logits at other places. Measured on
# an H100: score 1.0e-4 relative, gradients 5.3e-3 of their largest entry;
# the limits are about ten and four times that.
LM_REF_SCORE_RTOL = 1e-3
LM_REF_GRAD_RTOL = 2e-2
# The TransformerLM through the input pipeline: LM_PIPE_BATCHES distinct
# batches cycled to LM_PIPE_STEPS steps in one fit, timed in LM_PIPE_TURNS
# alternating turns synchronously, with put-ahead and with
# CacheMode.DEVICE. The pipeline moves the same bits to the card, so the
# losses of fresh nets from one seed agree within rounding at most (the
# check allows 1e-6 relative and reports whether they are bit-equal).
LM_PIPE_BATCHES, LM_PIPE_STEPS, LM_PIPE_TURNS = 3, 6, 3
PIPE_LOSS_RTOL = 1e-6
# An H2D copy in a profile that counts as a batch's (the labels are 537 MB,
# the ids 128 KB; the step's own scalar copies are bytes).
BATCH_COPY_BYTES = 1 << 20
# The f32 char-RNN pair at b=32 (no K3 grid) per layer on the card against
# the CPU (plain loops): the same f32 arithmetic in another order, with
# TF32 off; f32 rounds at 2^-24 and the errors grow over 50 steps and
# 512-term sums. Limits set before the first measurement: probabilities
# 1e-4 absolute (about 1% of the smallest, ~1/80), score 1e-5 relative,
# gradients 1e-4 of their largest entry.
F32_PAIR_ATOL = 1e-4
F32_PAIR_SCORE_RTOL = 1e-5
F32_PAIR_GRAD_RTOL = 1e-4

# Generation. The TransformerLM the smoke trained, saved and restored,
# samples GEN_TOKENS tokens for GEN_B prompts of GEN_PROMPT tokens through
# its layers' 512-slot KV cache, so the window rolls past 512 at the 129th
# sampled token; then it streams GEN_STREAM_T tokens one at a time against
# its output on the same tokens. The stream and output round k, v and the
# logits to bf16 at other places (a one-token product vs the sequence's,
# the dense body over a cache vs over the sequence), so the limit is the
# CPU tests' bf16 one (tests/test_torch_generation.py): 2e-2 of the
# largest probability. On an H100 (700 W) the net after the smoke's 13
# steps reads 1.366e-2, the same in two calls (the net and the data come
# from seeds); a near-uniform net reads more (2.07e-2 after 2 steps: three
# bf16 units of a largest probability of 0.009). Against an f32 twin of the net (the same weights)
# the bf16 stream and the bf16 output each read 1.0e-2 to 1.7e-2: the
# error is bf16's rounding of the net, not the cache's. The twin holds the
# contract itself, stream against output, at the CPU tests' f32 limits.
GEN_B, GEN_PROMPT, GEN_TOKENS, GEN_STREAM_T = 4, 384, 256, 512
GEN_STREAM_RTOL = 2e-2
GEN_SEED = 5
# The char-RNNs (the trained bf16 2 x GravesLSTM(512) and a
# TextGenerationLSTM at the reference's widths: 47 characters, 256 units,
# f32) sample CHAR_TOKENS characters for GEN_B prompts of CHAR_PROMPT: one
# K3 launch for the prompt and one a character (2 K1 a call where K3 has
# no grid). The first DECODE_CHECKS one-step launches of each are also
# computed by the kernel's plain version on the same inputs, at KERNEL_ATOL
# over the larger of 1 and the output's largest entry (kernel_err): a
# trained net's cell state c grows far past 1 (90 after three fits). The
# prompt's 100-step launch is compared too and its error reported, not
# held: over 100 steps of the trained bf16 net a bf16 unit that h rounds
# to differently grows to 9.2e-3 in h (an H100's reading; 2.4e-7 on the
# single steps after it), which says how the recurrence amplifies
# rounding, not whether the kernel computes the step.
CHAR_PROMPT, CHAR_TOKENS, DECODE_CHECKS = 100, 200, 4
TEXTGEN_VOCAB, TEXTGEN_H = 47, 256

# ResNet50 of bench.py:187 (bench_resnet50 through _cnn_throughput): b=256,
# 3x224x224, 1000 classes, bf16 compute, Adam 1e-3, N(0, 1) NCHW features
# and one-hot labels from default_rng(0); the bench's 3 warm-up and 25
# timed steps, here through ComputationGraph.fit under CacheMode.DEVICE.
R50_B, R50_IMG, R50_CLASSES = 256, (3, 224, 224), 1000
R50_WARM, R50_STEPS = 3, 25
# LeNet of bench.py:202 (bench_lenet): b=1024, 1x28x28, 10 classes, bf16,
# iterations(10) a fit and CacheMode.DEVICE; one warm-up fit, ten timed.
LENET_B, LENET_ITERS, LENET_FITS = 1024, 10, 10
# A bf16 softmax row sums to 1 within bf16's rounding of its terms, at
# most 2^-8 of their sum. Once a net has fitted its batch one term is near
# 1 and rounds by up to 2^-9 alone: ResNet50 after its 28 steps on one
# batch read 2.29e-3 on an H100 (a limit of 1e-3, set before, failed), and
# LeNet 2.0e-3 on the CPU.
PROB_SUM_ATOL = 2.0 ** -8
# Card vs CPU for ResNet50 at 3x64x64, 10 classes, b=8: the card in f64,
# f32 (TF32 off) and bf16 against the CPU in f64, from the card's weights,
# each with running statistics of its own from 64 other images. Output is
# inference (running statistics); score and gradients are training (batch
# statistics). The net is put in a well-conditioned state: the last BN of
# every residual branch has gamma R50_REF_BRANCH_GAMMA (the shrunk or
# zero-initialised residual of common ResNet recipes); at gamma 1 the
# random net's backward explodes and rounding alone moves its gradients by
# percents. The CPU replays the card's ReLU signs and max-pool picks
# (deeplearning4j_torch/utils/kink_pins.py): a unit that rounding moves
# across 0 would otherwise move the gradient far beyond the limits in a
# correct run. Limits (output max abs, score relative, gradients: the
# worst parameter's max abs error over its largest entry, and the whole
# gradient's norm-wise error) were set before the first measurement for
# f64 and f32; bf16's are about four times the first card reading (an
# H100 80GB HBM3 at 700 W: 8.57e-3, 2.33e-3, 9.42e-2, 3.35e-2).
# tests/test_torch_cnn_reference.py holds the port's CPU runs to these
# limits and breaks them with deliberately wrong layers: a mirrored SAME
# pad, a flipped kernel or a BN gradient that skips the statistics in f32
# and bf16; an unbiased variance in the normalisation or in the running
# statistics, or an eps of 1e-3, in f32 (in bf16 they are below its
# rounding).
R50_REF_B, R50_REF_IMG, R50_REF_CLASSES, R50_REF_STATS_B = 8, (3, 64, 64), 10, 64
R50_REF_BRANCH_GAMMA = 0.2
R50_REF_LIMITS = {"float64": (1e-5, 1e-5, 1e-4, 1e-4), "float32": (1e-5, 1e-5, 1e-4, 1e-4),
                  "bfloat16": (3.5e-2, 1e-2, 0.4, 0.14)}

# The CNN family (cnn_family). VGG16 of bench.py:195 (bench_vgg16 through
# _cnn_throughput): b=256, 3x224x224, 1000 classes, bf16 compute, the zoo's
# Adam 1e-3, N(0, 1) NCHW features; through MultiLayerNetwork.fit under
# CacheMode.DEVICE, VGG_WARM warm-up steps then VGG_STEPS timed in one fit.
VGG_B, VGG_IMG, VGG_CLASSES, VGG_WARM, VGG_STEPS = 256, (3, 224, 224), 1000, 2, 8
# The other five zoo models of the family, each built by
# ModelSelector.select(name).init() (f32, as the zoo builds them; TF32 is
# off in this script) at its zoo input shape, 1000 classes and full width,
# at the batch here: FAMILY_WARM then FAMILY_STEPS fit steps on one batch,
# then ``output``, whose f32 rows sum to 1 within FAMILY_PROB_ATOL.
FAMILY_BATCH = {"vgg19": 64, "alexnet": 128, "googlenet": 64, "inceptionresnetv1": 32,
                "facenetnn4small2": 64}
FAMILY_WARM, FAMILY_STEPS, FAMILY_PROB_ATOL = 1, 3, 1e-5
# Each new layer on the card against the port on the CPU in f64, from the
# same parameters and inputs (the card's bf16 input as the CPU's f64):
# output, input and parameter gradients, max |card - cpu| over max |cpu|,
# set before the first card run: f64 1e-10; bf16 3e-2 (a bf16 unit is
# 2^-8 of a value; the tests hold the port's bf16 against JAX's at 3e-2).
# Layers at b=SWEEP_B on SWEEP_HW x SWEEP_C images or SWEEP_T steps.
SWEEP_LIMITS = {"float64": 1e-10, "bfloat16": 3e-2}
SWEEP_B, SWEEP_HW, SWEEP_C, SWEEP_T = 4, 12, 8, 24
# The grouped, transposed and 1-D convolutions at a main-path size
# (b=32, 56x56x64, bf16): one forward and backward profiled each, to find
# any NCHW/NHWC transposition kernel cuDNN adds around them.
LAYOUT_B, LAYOUT_HW, LAYOUT_C = 32, 56, 64
# The MoE TransformerLM: bench.py:1730's model (LM_*) with every block's
# FFN up-projection a MoEDenseLayer of 8 experts, top 2, capacity factor
# 1.25 in training (groups of 1024 tokens, 320 slots an expert), aux loss
# weight 1e-2: the JAX package's defaults. MOE_STEPS Adam steps on one
# cached batch; each must launch 8 K5, 8 K6 and 8 K7. The loss must fall
# by MOE_LOSS_DROP from the first step to the last (set before the first
# run; the dense model fell 61% over 6 steps). Then the MoE step and the
# dense model's step, both under CacheMode.DEVICE, in MOE_TURNS
# alternating turns.
MOE_EXPERTS, MOE_TOP_K, MOE_CF, MOE_AUX = 8, 2, 1.25, 1e-2
MOE_STEPS, MOE_TURNS, MOE_LOSS_DROP = 4, 3, 0.10
# Capacity dispatch against the dense combine on the card, one MoE layer at
# the model's shape (32768 tokens, 512 -> 2048, bf16) at capacity factor
# E/k, where no assignment can drop: the same bf16 products (one nonzero a
# dispatch sum, the expert products tiled another way), so an output may
# move by a bf16 unit or two of its largest entry (2^-8 = 3.9e-3); the
# limit, set before the first run, is 1e-2 of the largest entry.
MOE_SPARSE_RTOL = 1e-2
# The trained MoE net saved, guessed back and sampling MOE_GEN_TOKENS
# tokens at b=GEN_B from a MOE_GEN_PROMPT-token prompt (the dense combine,
# no K5-K7).
MOE_GEN_PROMPT, MOE_GEN_TOKENS = 64, 32
# The char-RNN built as a ComputationGraph (vertices l0, l1, out) fits one
# b=64, T=200 DataSet by TBPTT 50 from the MultiLayerNetwork char-RNN's
# weights: each segment K1 with the reserve and K2 a layer, the MLN the
# fused K3/K4. The two hold each other at the CPU reference's limits for
# one segment's gradients (TRAIN_SCORE_RTOL, TRAIN_GRAD_RTOL), the fits'
# last-segment losses at TRAIN_SCORE_RTOL, and the parameters after the 4
# Adam updates at 2 x lr x 4 absolute (Adam moves an entry whose gradient
# is at rounding level by lr in either direction a step).
GRAPH_PARAM_ATOL = 2 * 1e-3 * 4
# A small two-input, two-output graph (Merge, LastTimeStep,
# DuplicateToTimeSeries, Subset and L2Normalize vertices; two f32 LSTMs on
# K1/K2) fitting one MultiDataSet with SGD and taking external errors once,
# on the card and on the CPU from the same weights (TF32 off): the same
# f32 arithmetic in another order; limits set before the first run: score
# 1e-5 relative, parameters 1e-5 absolute.
SMALL_GRAPH_SCORE_RTOL, SMALL_GRAPH_PARAM_ATOL = 1e-5, 1e-5
# Regularised char-RNN fits (regularized_char_rnn): the char-RNN of
# char_rnn_conf with one regularisation each, one fit of one b=64, T=200
# batch (4 TBPTT segments): dropout 0.8 on layer 0 (the pair stays on
# K3/K4, its dropout before the hoisted projection), dropout 0.8 on layer 1
# and DropConnect 0.9 on layer 0 (the pair splits onto K1/K2, as in the JAX
# package), MaxNorm 1.0 on both LSTMs, and the retain probability 1.0 on
# every layer (nothing drawn; the plain fit's routes and bits). Each timed
# beside the plain fit in REG_TURNS alternating turns of REG_FITS fits,
# synchronously (DL4J_TPU_PREFETCH_WORKERS=0), medians compared; so is a
# fit with two listeners (one float(loss) a fit) against one without.
REG_VARIANTS = ("dropout_layer0", "dropout_layer1", "dropconnect_layer0", "maxnorm",
                "retain_all")
REG_TURNS, REG_FITS = 4, 3
# MaxNorm 1.0: every column norm of W and RW after the fit, f32 rounding
# of the projection (w * max_norm / norm) allowed.
MAXNORM_ATOL = 1e-6
# The TransformerLM of lm_conf with attention dropout 0.1 under
# CacheMode.DEVICE: LM_DROPOUT_STEPS steps, each 8 K5, 8 K6 and 8 K7 with a
# nonzero seed; the loss must fall by LM_DROPOUT_LOSS_DROP over them (set
# before the first run: the dense model fell 61% over 6 steps, the MoE
# model 43% over 4); the step timed beside the dropout-free step in
# LM_DROPOUT_TURNS alternating turns.
LM_DROPOUT_RATE, LM_DROPOUT_STEPS, LM_DROPOUT_TURNS = 0.1, 4, 3
LM_DROPOUT_LOSS_DROP = 0.20
# LBFGS on a full-batch dense net of f32 (SOLVER_N examples, 784 -> 512 ->
# 10, tanh, softmax, random labels), TF32 off, then SOLVER_ITERS
# iterations on the card against as many SGD steps. Card against CPU: the
# loss and gradient at each of the card's first SOLVER_CHECK_ITERS
# iterates, evaluated again on a CPU copy (the same f32 arithmetic in
# another order: loss SOLVER_LOSS_RTOL relative, set before the first run;
# gradient SOLVER_GRAD_RTOL of its largest entry, set before its first
# reading), and an independent LBFGS run on the CPU whose losses are held
# at SOLVER_LOSS_RTOL for its first SOLVER_SAME_PATH_ITERS iterations and
# reported after: in f32 two summation orders part LBFGS's paths within
# a few iterations (an H100 at 700 W read 9e-8, 2.1e-6 and 1.5e-6 over
# the first three, then 2.1e-5 and 7.3e-5 as the loss fell from 2.67 to
# 0.15; the CPU tests see JAX and the port part the same way in f32 and
# agree to 1e-10 in f64).
SOLVER_N, SOLVER_IN, SOLVER_HIDDEN, SOLVER_OUT = 4096, 784, 512, 10
SOLVER_CHECK_ITERS, SOLVER_SAME_PATH_ITERS, SOLVER_ITERS = 5, 3, 30
SOLVER_LOSS_RTOL, SOLVER_GRAD_RTOL = 1e-5, 1e-4
# Evaluation and early stopping (``evaluation``). The char-RNN of
# char_rnn_conf trained by EarlyStoppingTrainer on ES_TRAIN batches of
# b=TRAIN_B, T=TRAIN_SEQ periodic text (4 TBPTT segments each), scored by
# DataSetLossCalculator over ES_VAL validation batches, stopped by
# MaxEpochsTerminationCondition(ES_MAX_EPOCHS) or
# ScoreImprovementEpochTerminationCondition(ES_PATIENCE), once with each
# saver; then evaluate on one masked and one unmasked validation batch.
# The TransformerLM of lm_conf evaluated over LM_EVAL_BATCHES batches.
# SimpleCNN at its 3x48x48 input (SCNN_CLASSES classes, b=SCNN_B) on the
# LFW fetcher's stand-in resized to 48 (SCNN_EXAMPLES examples), and LeNet
# on MnistDataSetIterator (b=LENET_B), each fit for ZOO_EPOCHS epochs and
# evaluated. No file of data is in the repository, so the fetchers serve
# their synthetic stand-in from a data directory under build/.
ES_TRAIN, ES_VAL, ES_MAX_EPOCHS, ES_PATIENCE = 2, 2, 3, 1
LM_EVAL_BATCHES = 2
SCNN_B, SCNN_CLASSES, SCNN_EXAMPLES, ZOO_EPOCHS = 256, 10, 512, 2
# The rest of the recurrent family (recurrent_family), at the char-RNN's
# widths (VOCAB, H, b=TRAIN_B, T=TRAIN_SEQ, bf16, Adam 1e-3), standard
# backprop (a bidirectional layer reads the whole sequence): RF_FITS fits
# unmasked and RF_FITS masked (lengths RF_LENGTHS) of each net, timed in
# RF_TURNS alternating turns of one fit each. The classifier reads
# RF_CLS_BATCHES minibatches of TRAIN_B CSV sequences (lengths RF_LENGTHS)
# through SequenceRecordReaderDataSetIterator. SimpleRnn streams
# RF_STREAM_T characters one at a time at b=GEN_B against its output on
# them (the same bf16 limit as the generation stream's). The step loop
# runs a softsign GravesLSTM(H) and a tanh GravesLSTM(RF_ODD_H); the
# card-vs-CPU checks run at b=RF_REF_B, T=RF_REF_T at TRAIN_SCORE_RTOL
# and TRAIN_GRAD_RTOL, the char-RNN's limits (the same bf16 products
# rounded at other places).
RF_FITS, RF_TURNS, RF_CLS_BATCHES, RF_STREAM_T = 3, 4, 2, 200
RF_LENGTHS = (50, 200)
RF_ODD_H = 500
RF_REF_B, RF_REF_T = 4, 30
# The card-vs-CPU outputs are those of nets the phase has trained, whose
# bf16 softmax puts probabilities near 1, where one rounding step of bf16
# is 2^-9 below 1 and 2^-8 across it: the random net's REF_ATOL (1e-3)
# failed at 1.46e-3 on the trained bidirectional char-RNN on an H100
# (700 W), and the trained SimpleRnn read 3.91e-3 (one step across 1), so
# these are held at two bf16 steps at 1 (PROB_SUM_ATOL's reasoning).
RF_OUT_ATOL = 2.0 ** -7

# Transfer learning and pretraining (transfer_pretrain). VGG16 at VGG_B,
# VGG_IMG frozen through layer TL_FROZEN (fc2) with a TL_CLASSES-way head:
# TL_TURNS alternating turns of TL_STEPS fit steps against the full
# network's; ResNet50 at R50_B, R50_IMG frozen at "gap" with an
# R50_TL_CLASSES-way head, TL_STEPS steps; the char-RNN frozen at layer 0,
# TL_CHAR_FITS fits of TRAIN_B x TRAIN_SEQ. Pretraining at the MNIST widths
# of the dl4j-examples (DeepAutoEncoderExample's RBM stack PRE_RBM, an
# AutoEncoder PRE_AE, VaeMNISTAnomaly's VAE) at b=PRE_B: one warm-up and
# PRE_ITERS timed iterations a layer, and one step's loss and gradients on
# the card (f32, TF32 off) against the CPU in f64 on the card's draws at
# PRE_REF_RTOL (f32 rounding of sums over 784 inputs and 128 examples).
# Yolo2OutputLayer at TinyYOLO's head (YOLO_GRID^2 cells, the 5 VOC
# anchors of DL4J's TinyYOLO, YOLO_CLASSES classes, b=YOLO_B): loss and
# input gradient against the CPU in f64 at YOLO_REF_RTOL, then YOLO_STEPS
# fit steps of a 3 x (4 YOLO_GRID)^2 convolutional trunk.
TL_FROZEN, TL_CLASSES, TL_TURNS, TL_STEPS, TL_CHAR_FITS = 19, 5, 3, 4, 3
R50_TL_CLASSES = 10
PRE_B, PRE_ITERS = 128, 10
PRE_RBM = (784, 1000, 500, 250, 100, 30)
PRE_AE = (784, 250)
PRE_VAE_HIDDEN, PRE_VAE_LATENT, PRE_VAE_SAMPLES = (256, 256), 32, 5
PRE_REF_RTOL = 1e-4
YOLO_B, YOLO_GRID, YOLO_CLASSES, YOLO_STEPS = 32, 13, 20, 5
YOLO_ANCHORS = [[1.08, 1.19], [3.42, 4.41], [6.63, 11.38], [9.42, 5.11], [16.62, 10.52]]
YOLO_REF_RTOL = 1e-4

# Keras import and the embeddings (keras_embeddings). Keras applications.
# VGG16 with its top as a Functional model_config (KV_BLOCKS, KV_IMG HWC,
# KV_CLASSES), weights from KV_SEED, imported on the card: its f32 output at
# b=KV_B held against a plain NHWC forward from the Keras arrays at
# KV_OUT_RTOL of the largest entry (both f32 with TF32 off, but cuDNN may
# take another algorithm, a Winograd one among them, for each side's
# convolutions; a wrong Flatten -> Dense permutation moves the output by
# O(1)); then bf16 Adam fits at VGG_B against the zoo VGG16 in KV_TURNS
# alternating turns of KV_STEPS steps. A Keras char-LSTM (2 x LSTM(KL_H) +
# TimeDistributed(Dense(KL_VOCAB, softmax)), weights from KL_SEED) at b=KL_B,
# T=KL_T: its f32 output against a numpy f64 Keras LSTM on KL_ORACLE_ROWS
# rows at KL_F32_ATOL (probabilities near 1/80; accurate expf/tanhf in
# K1), its bf16 twin against the f32 output at REF_ATOL, KL_FITS bf16 fits.
# The embeddings at bench.py:1645-1661's shape (EMB_SENTENCES x EMB_LEN
# words of zipf(1.3) % EMB_VOCAB from seed 0, vector EMB_DIM, window
# EMB_WINDOW, batch EMB_BATCH, one epoch): one batch's step on the card in
# f32 against the CPU in f64 from one random state at EMB_STEP_RTOL of the
# CPU step's largest update (f32 sums of up to thousands of duplicates in
# another order: about 1e-6 of it; a dropped duplicate moves it by O(1)).
# At these settings the fitted vectors go to NaN within a few dozen
# batches, in the JAX package too (batch 8192 sums every duplicate's
# update, and w1 is a quarter of the corpus), so the NaN share is reported;
# the HS fit of the first EMB_CPU_SENTENCES sentences at batch EMB_CPU_BATCH
# (the JAX package's default, which stays finite) on the card against the
# CPU (a CPU fit of the whole corpus takes about a minute) at a least cosine
# of EMB_FIT_COS; a profiled refit of EMB_PROFILE_SENTENCES sentences.
# ParagraphVectors with PV_GROUPS labels at batch PV_BATCH (finite vectors),
# predict on PV_HELD_OUT sentences;
# GloVe on GLOVE_SENTENCES sentences (vector GLOVE_DIM, batch GLOVE_BATCH);
# DeepWalk on a graph of BlogCatalog's size (DW_VERTICES, DW_EDGES,
# DW_COMMUNITIES planted communities with DW_WITHIN of the edges inside),
# d=DW_DIM, window DW_WINDOW, walk length DW_WALK, DW_WALKS walks a vertex
# (the paper's 80, cut to keep the phase in its time): of each vertex's
# DW_NEIGHBOURS nearest neighbours at least DW_MIN_SHARE in its community
# (chance 1/39; a table of random rows reads about that, the fitted one all
# but 1).
KV_BLOCKS = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))
KV_IMG, KV_CLASSES, KV_B, KV_SEED = (224, 224, 3), 1000, 8, 40
KV_OUT_RTOL, KV_TURNS, KV_STEPS = 1e-3, 3, 4
KL_B, KL_T, KL_H, KL_VOCAB, KL_SEED = 64, 200, 512, 80, 41
KL_ORACLE_ROWS, KL_F32_ATOL, KL_FITS = 8, 1e-5, 3
EMB_SENTENCES, EMB_LEN, EMB_VOCAB = 20000, 40, 5000
EMB_DIM, EMB_WINDOW, EMB_BATCH = 128, 5, 8192
EMB_PROFILE_SENTENCES, EMB_CPU_SENTENCES, EMB_CPU_BATCH = 1000, 1000, 512
EMB_STEP_RTOL, EMB_FIT_COS = 1e-3, 0.999
PV_GROUPS, PV_HELD_OUT, PV_SEED, PV_BATCH = 100, 100, 42, 512
GLOVE_SENTENCES, GLOVE_DIM, GLOVE_BATCH, GLOVE_SEED = 5000, 100, 4096, 43
DW_VERTICES, DW_EDGES, DW_COMMUNITIES, DW_WITHIN, DW_SEED = 10312, 333983, 39, 0.8, 44
DW_DIM, DW_WINDOW, DW_WALK, DW_WALKS, DW_NEIGHBOURS, DW_MIN_SHARE = 128, 10, 40, 2, 10, 0.8
# remat_clustering: each model's remat arms take REMAT_LOSS_STEPS steps (the
# loss after them) and REMAT_TURNS timed turns, alternating; the
# TransformerLM's losses on and off within REMAT_LM_LOSS_RTOL (K1-K7 and the
# GEMMs are deterministic), VGG16's and ResNet50's within REMAT_CNN_LOSS_RTOL
# (cuDNN's backward need not be). k-means on KM_N x KM_D f32 points (a large
# vocabulary's word vectors), k=KM_K, KM_ITERS iterations at most; the card's
# Lloyd step against the CPU's on KM_HOLD_N points within KM_RTOL. Exact
# t-SNE at MNIST's size (TS_N x TS_D), the card's step against the CPU's
# within TS_RTOL; Barnes-Hut at BH_N points, BH_ITERS iterations (cut from
# 50: a host iteration takes seconds). The kNN server over KNN_N x KNN_D
# points, KNN_QUERIES /knnnew queries (cut from 100 for the same reason).
REMAT_LOSS_STEPS, REMAT_TURNS, REMAT_RNN_SEED = 3, 4, 50
REMAT_LM_LOSS_RTOL, REMAT_CNN_LOSS_RTOL = 1e-5, 1e-3
KM_N, KM_D, KM_K, KM_ITERS, KM_HOLD_N, KM_RTOL, KM_SEED = 1_000_000, 128, 256, 50, 100_000, 1e-5, 51
TS_N, TS_D, TS_RTOL, TS_SEED = 6000, 784, 1e-5, 52
BH_N, BH_D, BH_ITERS = 1000, 50, 4
KNN_N, KNN_D, KNN_K, KNN_QUERIES, KNN_SEED = 100_000, 128, 10, 20, 53
PROF_FITS = 6
# parallel: ParallelWrapper over the char-RNN on PW_SLOTS slots of the one
# card (global b=TRAIN_B, each slot TRAIN_B / PW_SLOTS = 32). The Adam fits
# (AVERAGING, unmasked and masked) count launches and are timed beside the
# single net's in PW_TURNS alternating turns. Correctness is held on the
# gradients: with SGD at PW_SGD_LR (parameters move by at most about
# 1e-6, so every TBPTT segment's gradients are taken at the same point in
# both runs) each update's reduced gradients are recorded and held against
# one net's fit on the same global batch, segment by segment, within
# PW_GRAD_RTOL of each tensor's largest entry (the slots' two b=32
# gradients are summed where the single net sums b=64 at once, so bf16
# rounding parts them); the losses within PW_LOSS_RTOL. A control run
# applies only slot 0's gradients and must read above PW_GRAD_RTOL. Local
# SGD (frequency PW_LOCAL_FREQ) and SHARED_GRADIENTS take PW_ROUNDS fits
# each: losses finite and falling, launches counted exactly.
# ParallelInference (BATCHED, PW_SLOTS slots) serves PI_REQUESTS requests
# of PI_ROWS rows, masked and unmasked; answers within PI_ATOL of the
# net's own output on the same rows (the same kernels on fewer rows), the
# launches PW_SLOTS (K3) or 2 PW_SLOTS (K1) a batch the requests formed.
# Ring and Ulysses at the TransformerLM's attention shape over SP_SLOTS
# slots against the single kernel on the whole T, o and dq/dk/dv within
# FLASH_RTOL of the largest entry; the causal ring launches
# SP_SLOTS (SP_SLOTS + 1) / 2 of SP_SLOTS^2 blocks. The sp step over the
# full TransformerLM (Ulysses without dropout, the ring with attention
# dropout LM_DROPOUT_RATE) against the unsharded step: losses within
# LM_REF_SCORE_RTOL; with SGD at learning rate 1 a step moves each
# parameter by its gradient, so the parameters after one step are the
# gradients, held within LM_REF_GRAD_RTOL of each tensor's largest entry.
# Expert parallelism over EP_SLOTS slots on the MoE TransformerLM cut to
# EP_BLOCKS blocks runs in f32 and computes what the unsharded step does,
# so it is held at EP_SCORE_RTOL and EP_GRAD_RTOL (the CPU test's 1e-6); a
# control, the same step in bf16, must read above EP_GRAD_RTOL.
PW_SLOTS, PW_LOCAL_FREQ, PW_ROUNDS, PW_TURNS, PW_SEED = 2, 3, 4, 3, 60
PW_SGD_LR, PW_GRAD_RTOL, PW_LOSS_RTOL = 1e-6, 1e-2, 1e-3
PI_REQUESTS, PI_ROWS, PI_ATOL = 8, 8, 1e-3
SP_SLOTS, SP_SEED, SP_TURNS = 4, 61, 3
EP_SLOTS, EP_BLOCKS, EP_SCORE_RTOL, EP_GRAD_RTOL = 4, 2, 1e-6, 1e-6
# pipeline_paramserver: PipelinedNetwork over TextGenerationLSTM(80, 512,
# PP_LAYERS) in bf16 (the bench.py:230 widths) on PP_SLOTS pipe slots of
# the card, b=TRAIN_B T=TRAIN_SEQ in PP_M microbatches: the entry (layer
# 0) and each stage's layer run K1 with the reserve and K2 once a
# microbatch, no bubble tick launches. PipelinedGraph over the
# TransformerLM of step 8 on PP_LM_SLOTS slots (2 blocks each), b=LM_B
# T=LM_T in PP_LM_M microbatches of one: K5, K6 and K7 once a block a
# microbatch. Each is held against the container's unpipelined step on the
# same batch: the losses within LM_REF_SCORE_RTOL, and with SGD at
# learning rate 1 the parameters after one step (the gradients) within
# PP_GRAD_RTOL (char-RNN: K1 on microbatches of 16 against K3 and K1 on
# 64 rows, bf16 rounding) or LM_REF_GRAD_RTOL (TransformerLM) of each
# tensor's largest entry; a control that drops microbatch 0's loss must
# read above the limit. The TransformerLM with attention dropout
# LM_DROPOUT_RATE: two pipelines from one seed step alike, a third with
# another step seed differs. ParameterServerTrainingMaster over the
# char-RNN of step 4 (full-sequence steps: one K3 with the reserve and one
# K4 a step) against a ParameterServer on 127.0.0.1: (a) one worker,
# threshold 0, staleness 0, PS_STEPS steps, parameters within
# PS_PARAM_ATOL of a plain net's PS_STEPS update steps, and a plain net
# of PS_STEPS - 1 steps (the control) above it; (b) PS_WORKERS
# worker threads, threshold PS_THRESHOLD, staleness 1, PS_STEPS steps
# each: pushes and the server's version counted, the loss falls; (c) (a)
# with overlap on: the phases and the hidden share of d2h + encode + push
# (reported, no limit). Streaming and Kafka: STREAM_BATCHES char-RNN
# batches (their character ids on the wire, made one-hot by the
# iterators' ``convert``) fitted from StreamingDataSetIterator and from
# KafkaDataSetIterator over a stub broker; each fit's per-batch losses and
# parameters equal a ListDataSetIterator fit's over the same batches. The
# native codec on the char-RNN's flattened gradient: bit-equal to numpy.
PP_SLOTS, PP_LAYERS, PP_M, PP_TURNS, PP_SEED = 2, 3, 4, 3, 70
PP_GRAD_RTOL = 2e-2
PP_LM_SLOTS, PP_LM_M = 4, 4
PS_STEPS, PS_WORKERS, PS_THRESHOLD, PS_TURNS = 4, 2, 1e-3, 2
PS_PARAM_ATOL = 1e-6
STREAM_BATCHES = 8
# monitor_sharded_fleet: FLEET_SHARDS shard servers on loopback, then
# scale_to(FLEET_SCALE); the lossless worker (threshold 0) must equal a
# plain net's PS_STEPS steps within PS_PARAM_ATOL (the control, PS_STEPS - 1
# steps, above it), as a single server's worker does; two delta-push workers
# at PS_THRESHOLD, PS_STEPS steps each; shard FLEET_KILL killed after the
# first of a worker's PS_STEPS steps and restarted from its snapshot.
# MON_TURNS alternating turns time the monitored fits against
# set_enabled(False) (TransformerLM steps; char-RNN fits, MON_RNN_FITS a
# turn); SPAN_TURNS alternating turns of SPAN_CALLS spans time the
# tracer's cost a span.
FLEET_SHARDS, FLEET_SCALE, FLEET_KILL = 3, 4, 1
MON_TURNS, MON_RNN_FITS, SPAN_TURNS, SPAN_CALLS = 4, 3, 8, 20000
# serving_plane: the char-RNN of step 4 served over HTTP from three
# registrations, each on its own copy of the net: "sp_f32" (precision f32,
# time buckets: K1's CUDA-core body, per layer), "sp_bf16" (bf16, time
# buckets: K1's tensor-core body) and "sp_bf16_fixed" (bf16, T=200
# unmasked, a response cache of SP_CACHE examples: K3). SP_REQUESTS
# requests a registration (1-8 rows, T 50-200; T=200 when fixed), then
# SP_LAT_REQUESTS more a registration and as many cache hits at
# SP_CONCURRENCY clients in a client process of their own (no torch:
# requests encoded before the clock starts) for p50/p99. bf16 answers are held within
# SP_BF16_ATOL of the f32 plain forward on the CPU: set from the readings,
# 8.07e-5-9.22e-5 on an H100 80GB HBM3 at 700 W (PERF.md §6), about ten
# times below it (the serving contract's 5e-2, which golden() keeps, is
# four times a typical probability of 0.0125 and would pass a wrong
# body); f32 answers bit for bit against the same bucket's forward.
SP_REQUESTS, SP_LAT_REQUESTS, SP_CONCURRENCY, SP_CACHE, SP_SEED = 8, 32, 8, 64, 90
SP_BF16_ATOL = 1e-3
# The signature check's cost: SP_COST_CALLS calls of a watched no-op
# against the bare one, SP_COST_TURNS alternating turns.
SP_COST_CALLS, SP_COST_TURNS = 5000, 5
SP_CLIENT = r"""
import json, sys, time, urllib.request
from concurrent.futures import ThreadPoolExecutor
import numpy as np

port, name, mode = sys.argv[1:4]
n, conc, seed, T, V = (int(a) for a in sys.argv[4:9])
rng = np.random.default_rng(seed)


def one_hot(b, t):
    return np.eye(V, dtype=np.float32)[rng.integers(0, V, (b, t))]


xs = ([one_hot(4, T)] * (n + 1) if mode == "hit" else
      [one_hot(int(rng.integers(1, 9)), T if mode == "fixed" else int(rng.integers(T // 4, T + 1)))
       for _ in range(n)])
bodies = [json.dumps({"inputs": x.tolist()}).encode() for x in xs]


def post(body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/models/{name}/predict",
                                 data=body, headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as resp:
        json.loads(resp.read())
    return (time.perf_counter() - t0) * 1e3


if mode == "hit":
    post(bodies.pop())        # the miss that fills the cache, not timed
with ThreadPoolExecutor(conc) as pool:
    ms = list(pool.map(post, bodies))
print(json.dumps({"ms": ms, "request_bytes": sum(map(len, bodies)) / len(bodies)}))
"""
# The cold replica: a child process with an empty
# DL4J_TPU_COMPILE_CACHE_DIR, the warmup artifact and no input_shape; a
# second child gets a corrupted copy (one library byte flipped) and the
# build directory the kernels were built in.
SP_CHILD = r"""
import json, os, sys, time
t0 = time.perf_counter()
sys.path.insert(0, os.getcwd())
import hashlib
import numpy as np
import chip_smoke as cs
from deeplearning4j_torch.compilecache import cache as cc
from deeplearning4j_torch.monitor import get_flight_recorder
from deeplearning4j_torch.serving import ServedModel

artifact, seed = sys.argv[1], int(sys.argv[2])
net = cs.build_net(cs.char_rnn_conf())
t1 = time.perf_counter()
m = ServedModel("sp_replica", net, linger_ms=5.0, precision="bf16", cache_size=cs.SP_CACHE,
                warmup_artifact=artifact)
t2 = time.perf_counter()
y = m.predict(cs.one_hot(np.random.default_rng(seed), 2, cs.T))
t3 = time.perf_counter()
events = [{k: e.get(k) for k in ("event", "reason", "signatures", "libraries", "written")}
          for e in get_flight_recorder().events() if e["event"].startswith("compile_cache")]
print(json.dumps({"process_to_answer_s": t3 - t0, "register_s": t2 - t1,
                  "register_to_answer_s": t3 - t1, "nvcc_runs": cc.persistent_cache_counts()["misses"],
                  "library_hits": cc.persistent_cache_counts()["hits"],
                  "aot_signatures": m.stats()["aot_signatures"],
                  "input_shape": list(m.input_shape) if m.input_shape else None,
                  "answer_sha256": hashlib.sha256(np.ascontiguousarray(y).tobytes()).hexdigest(),
                  "cache_dir": cc.cache_dir(), "events": events}))
m.close()
"""


# alerts_probes: the char-RNN served from three registrations as in
# serving_plane (f32 and bf16 with time buckets: K1; bf16 at T=200 with a
# response cache: K3), probed by the process Prober for AP_TICKS healthy
# ticks, then a gray failure (the f32 net's output-layer W times 8 on the
# card, undone after) and an injected AP_SLOW_S sleep around the bf16 net.
# The probe and fleet packs run on a synthetic clock of AP_BEAT_S a beat with JAX's
# test windows (tests/test_alerts.py, tests/test_probes.py): AP_WINDOWS,
# hold-down AP_FOR_S, the deadman at AP_DEADMAN_S; the latency target
# AP_P99_MS sits between a healthy request (about 10 ms) and a slowed one.
# The scraped child replica must print its port within AP_CHILD_TIMEOUT_S;
# the fleet table's staleness horizon is AP_STALE_S during the phase; the
# training rule's problem window is AP_WITHIN_S.
AP_TICKS, AP_BEAT_S, AP_WINDOWS, AP_FOR_S, AP_DEADMAN_S = 8, 0.5, (1.5, 3.0), 0.2, 2.0
# the latency burn runs on the wall clock (``/alerts`` evaluates at request
# time), one request a beat of AP_SERVE_BEAT_S: a slowed beat takes about
# AP_SLOW_S, so the samples stay dense enough for a window to count as
# covered (MetricsHistory.covers: within a quarter window of its edge)
AP_SERVE_BEAT_S = 0.25
AP_SLOW_S, AP_P99_MS, AP_CHILD_TIMEOUT_S, AP_STALE_S, AP_WITHIN_S = 0.25, 150.0, 120.0, 2.0, 2.0
# The scraped replica: a child process serving the bf16 char-RNN from the
# warmup artifact with an empty compile-cache directory. It records a
# flight event before it serves (which must not replay at the collector),
# prints its port and serves until its stdin closes.
AP_REPLICA = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from deeplearning4j_torch import InferenceServer
from deeplearning4j_torch.monitor import get_flight_recorder

net = cs.build_net(cs.char_rnn_conf())
get_flight_recorder().record("preexisting_incident", origin="replica-b")
srv = InferenceServer()
srv.register("ap_replica", net, linger_ms=5.0, precision="bf16", cache_size=cs.SP_CACHE,
             warmup_artifact=sys.argv[1])
print(json.dumps({"port": srv.start(port=0)}), flush=True)
sys.stdin.read()
srv.stop()
"""


# control_incidents: the char-RNN served as in alerts_probes (bf16 with time
# buckets: K1, capped at CI_CAP queued examples; f32 with time buckets for
# the gray failure; bf16 at T=200 to compare with the respawned child) and
# trained by one delta-push worker over a ShardedParameterServerGroup(2)
# (PS_STEPS steps a fit, K3 with the reserve, then K4). The latency drills
# run on the phase's clock: AP_SERVE_BEAT_S a beat of one request, never
# ahead of the wall clock (a beat also runs inside each of the worker's
# steps, which take longer than a beat: on the wall clock the burn windows
# went uncovered and the alert resolved mid-fit), with AP_SLOW_S injected;
# the probe and scrape drills on synthetic clocks of AP_BEAT_S a beat. The
# plane and the recorders are ticked at each beat's time. The policies'
# cooldown is CI_COOLDOWN_S; the shard rule is a rate over CI_SHARD_WINDOW_S
# of paramserver_shard_unavailable_total; the recorders look back
# CI_LOOKBACK_S; fleet_scale_policy stops at CI_FLEET_MAX servers. The walks
# give up after CI_WALK beats; the phase fails past CI_PHASE_LIMIT_S.
CI_CAP, CI_COOLDOWN_S, CI_SHARD_WINDOW_S, CI_LOOKBACK_S, CI_FLEET_MAX = 64, 1.0, 1.5, 10.0, 3
CI_WALK, CI_PHASE_LIMIT_S = 40, 60.0
# The ui_cli phase: the data factory's UI_BATCHES batches of periodic text
# (TRAIN_B x TRAIN_SEQ, one-hot over VOCAB, from UI_SEED); the listener's
# cost over UI_TURNS alternating turns of the fit with and without it; at
# most UI_COPIES device-to-host copies in one listener call, none over
# UI_COPY_BYTES (the char-RNN's parameters are ~13 MB); its statistics
# against numpy's at UI_STATS_RTOL (both reduce in float64; only the order
# of the sums differs); the replica's request holds UI_ROWS examples. The
# phase fails past UI_PHASE_LIMIT_S.
UI_BATCHES, UI_SEED, UI_TURNS, UI_ROWS = 4, 77, 5, 5
UI_COPIES, UI_COPY_BYTES, UI_STATS_RTOL, UI_PHASE_LIMIT_S = 2, 64 << 10, 1e-9, 120.0
UI_FACTORY = r"""
import numpy as np
from deeplearning4j_torch import DataSet, ListDataSetIterator


def make():
    rng = np.random.default_rng({seed})
    eye = np.eye({vocab}, dtype=np.float32)
    sets = []
    for _ in range({n}):
        cycle = rng.integers(0, {vocab}, 23)
        ids = cycle[(rng.integers(0, 23, {b})[:, None] + np.arange({t} + 1)[None, :]) % 23]
        sets.append(DataSet(eye[ids[:, :-1]], eye[ids[:, 1:]]))
    return ListDataSetIterator(sets)
"""


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds per call of ``fn`` on the card, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved, bf16_flops, f32_ops):
    """Least time for the work in ms: the larger of the bytes over the
    memory rate and each type's operations over its peak rate (tensor and
    CUDA cores can run at once, so the operation times are not added)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = max(bf16_flops / BF16_FLOPS, f32_ops / F32_FLOPS)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def lstm_launch_bound(name, args, reserve):
    """(bound_ms, bound_by) of one launch of K1-K4 from its arguments, the
    one count of every K1-K4 bound in this script: each input read and each
    output written once, the recurrent products in the weights' type (f32
    ones on the CUDA cores), the peephole and mask terms only when given."""
    if name in ("lstm_fwd", "lstm2_fwd"):
        t, b, h4 = args[0].shape
    else:
        t, b, h4 = args[1].shape
    H = h4 // 4
    w = args[1] if name in ("lstm_fwd", "lstm2_fwd") else args[3 if name == "lstm_bwd" else 5]
    peep = args[2] if name == "lstm_fwd" else args[4 if name == "lstm_bwd" else
                                                    5 if name == "lstm2_fwd" else 8]
    mask = args[3] if name == "lstm_fwd" else args[5] if name == "lstm_bwd" else None
    w_bytes, seq, seq4, st = H * h4 * w.element_size(), t * b * H * 4, t * b * h4 * 4, b * H * 4
    mm = 2 * b * H * h4
    mbytes = t * b * 4 if mask is not None else 0
    p = 0 if peep is None else 1
    cell = CELL_OPS - 6 * (1 - p) + (6 if mask is not None else 0)
    if name == "lstm_fwd":
        nbytes = (seq4 + w_bytes + 3 * H * 4 * p + 4 * st + seq + mbytes
                  + (seq4 + seq if reserve else 0))
        flops, ops = t * mm, t * b * H * cell
    elif name == "lstm_bwd":
        nbytes = seq + seq4 + seq + mbytes + w_bytes + 3 * H * 4 * p + 5 * st + seq4 + 3 * H * 4 * p
        flops, ops = t * mm, t * b * H * (CELL_BWD_OPS + 4)
    elif name == "lstm2_fwd":
        nbytes = (seq4 + 3 * w_bytes + 4 * H * 4 + 6 * H * 4 * p + 8 * st + seq
                  + (3 * seq + 2 * seq4 if reserve else 0))
        flops, ops = 3 * t * mm, 2 * t * b * H * cell
    else:
        nbytes = seq + 2 * seq4 + 2 * seq + 3 * w_bytes + 6 * H * 4 * p + 10 * st + 2 * seq4
        nbytes += 6 * H * 4 * p
        flops, ops = 3 * t * mm, 2 * t * b * H * CELL_BWD_OPS
    if w.dtype == torch.bfloat16:
        return bound(nbytes, flops, ops)
    return bound(nbytes, 0, flops + ops)


def check_kernels():
    from deeplearning4j_torch.ops import lstm_cell, lstm_fused

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    xp = rnd(T, B, 4 * H)
    rw1 = rnd(H, 4 * H, scale=H ** -0.5).to(torch.bfloat16)
    w2 = rnd(H, 4 * H, scale=H ** -0.5).to(torch.bfloat16)
    rw2 = rnd(H, 4 * H, scale=H ** -0.5).to(torch.bfloat16)
    b2 = rnd(4 * H, scale=0.1)
    peep3 = rnd(3, H, scale=0.1)
    peep6 = rnd(6, H, scale=0.1)
    h0, c0 = rnd(B, H, scale=0.5), rnd(B, H, scale=0.5)
    h0pack = rnd(4, B, H, scale=0.5)
    # fractional mask: real steps 1, a ramp at each row's end, zero padding
    lengths = torch.randint(T // 4, T + 1, (B,), generator=g)
    steps = torch.arange(T)[:, None].float()
    mask = torch.clamp((lengths[None, :].float() - steps) / 3.0, 0.0, 1.0).to(dev)

    results = {}
    for label, m in (("masked", mask), ("unmasked", None)):
        args = (xp, rw1, peep3, m, h0, c0)
        ys, hT, cT = lstm_cell.lstm_fwd(*args)
        torch.cuda.synchronize()
        ref = lstm_cell.lstm_fwd_plain(*args)
        err = max((a - r).abs().max().item() for a, r in zip((ys, hT, cT), ref))
        bitwise = same_bits((ys, hT, cT), lstm_cell.lstm_fwd(*args))
        ms = cuda_ms(lambda: lstm_cell.lstm_fwd(*args), 20)
        plain_ms = cuda_ms(lambda: lstm_cell.lstm_fwd_plain(*args), 3)
        bms, by = lstm_launch_bound("lstm_fwd", args, reserve=False)
        route = lstm_design("K1", rw1.dtype, B, H)
        results[f"lstm_fwd/{label}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                            bound_ms=bms, bound_by=by, design=route)
        log(f"K1 lstm_fwd {label}: max_abs_err={err:.3e} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.3f} bound_ms={bms:.5f} ({by}; chain of {T} "
            f"dependent steps, {1e3 * ms / T:.2f} us a step); two launches bitwise equal: "
            f"{bitwise}; route: {route}")
        if not bitwise:
            raise AssertionError(f"K1 ({label}) gave different results in two launches")
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"K1 {label} disagrees with its plain version: "
                                 f"{err} > {KERNEL_ATOL}")

    args = (xp, rw1, w2, rw2, b2, peep6, h0pack)
    got = lstm_fused.lstm2_fwd(*args)
    torch.cuda.synchronize()
    ref = lstm_fused.lstm2_fwd_plain(*args)
    err = max((a - r).abs().max().item() for a, r in zip(got, ref))
    bitwise = same_bits(got, lstm_fused.lstm2_fwd(*args))
    ms = cuda_ms(lambda: lstm_fused.lstm2_fwd(*args), 20)
    plain_ms = cuda_ms(lambda: lstm_fused.lstm2_fwd_plain(*args), 3)
    bms, by = lstm_launch_bound("lstm2_fwd", args, reserve=False)
    route = k3_design(rw1.dtype, B, H)
    results["lstm2_fwd"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=bms, bound_by=by, design=route)
    log(f"K3 lstm2_fwd: max_abs_err={err:.3e} kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} "
        f"bound_ms={bms:.5f} ({by}; chain of {T + 1} dependent phases, "
        f"{1e3 * ms / (T + 1):.2f} us a phase); two launches bitwise equal: {bitwise}; "
        f"route: {route}")
    if not bitwise:
        raise AssertionError("K3 gave different results in two launches on the same inputs")
    if not err <= KERNEL_ATOL:
        raise AssertionError(f"K3 disagrees with its plain version: {err} > {KERNEL_ATOL}")

    # Yardstick only: cuDNN's LSTM computes another function (no
    # peepholes, its own gate order, its own input projection), so it is
    # no library_ms. The port never calls it.
    for layers, key in ((1, "lstm_fwd"), (2, "lstm2_fwd")):
        lstm = torch.nn.LSTM(H, H, num_layers=layers).to(dev, torch.bfloat16)
        lstm.flatten_parameters()
        x = torch.randn(T, B, H, device=dev, dtype=torch.bfloat16)
        with torch.inference_mode():
            results[key + "/cudnn"] = cuda_ms(lambda: lstm(x), 20)
        log(f"yardstick cudnn nn.LSTM({H}, {H}, num_layers={layers}) bf16 b={B} T={T}: "
            f"{results[key + '/cudnn']:.4f} ms")
    return results


def check_training_kernels():
    """K1 and K3 writing the reserve, K2 and K4, each against its plain
    version at the training shape (one TBPTT segment). Each backward gets
    the same dy, reserve and state as its plain version, so it is checked
    on its own."""
    from deeplearning4j_torch.ops import lstm_cell, lstm_fused

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(10)
    b, t = TRAIN_B, TRAIN_T

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    xp = rnd(t, b, 4 * H)
    rw1, w2, rw2 = (rnd(H, 4 * H, scale=H ** -0.5).to(torch.bfloat16) for _ in range(3))
    b2 = rnd(4 * H, scale=0.1)
    peep3, peep6 = rnd(3, H, scale=0.1), rnd(6, H, scale=0.1)
    h0, c0 = rnd(b, H, scale=0.5), rnd(b, H, scale=0.5)
    h0pack = rnd(4, b, H, scale=0.5)
    dy = rnd(t, b, H, scale=0.1)
    dhT, dcT = rnd(b, H, scale=0.1), rnd(b, H, scale=0.1)
    dhcT = rnd(4, b, H, scale=0.1)
    lengths = torch.randint(t // 4, t + 1, (b,), generator=g)
    steps = torch.arange(t)[:, None].float()
    mask = torch.clamp((lengths[None, :].float() - steps) / 3.0, 0.0, 1.0).to(dev)

    def err(got, want):
        return max((a - r).abs().max().item() for a, r in zip(got, want) if a is not None)

    results = {}
    for label, m in (("masked", mask), ("unmasked", None)):
        fargs = (xp, rw1, peep3, m, h0, c0)
        got = lstm_cell.lstm_fwd(*fargs, save_reserve=True)
        torch.cuda.synchronize()
        ref = lstm_cell.lstm_fwd_plain(*fargs, save_reserve=True)
        e_f = err(got, ref)
        bitwise_f = same_bits(got, lstm_cell.lstm_fwd(*fargs, save_reserve=True))
        ms = cuda_ms(lambda: lstm_cell.lstm_fwd(*fargs, save_reserve=True), 20)
        plain_ms = cuda_ms(lambda: lstm_cell.lstm_fwd_plain(*fargs, save_reserve=True), 3)
        bms, by = lstm_launch_bound("lstm_fwd", fargs, reserve=True)
        route = lstm_design("K1", rw1.dtype, b, H, reserve=True)
        results[f"lstm_fwd_train/{label}"] = dict(max_abs_err=e_f, ms=ms, plain_ms=plain_ms,
                                                  bound_ms=bms, bound_by=by, design=route)
        log(f"K1 lstm_fwd train {label} b={b} T={t}: max_abs_err={e_f:.3e} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.3f} bound_ms={bms:.5f} ({by}; {1e3 * ms / t:.2f} us a step); "
            f"two launches bitwise equal: {bitwise_f}; route: {route}")

        # K1 without the reserve at this shape: a frozen layer's forward in
        # a fit (transfer_char_rnn)
        got = lstm_cell.lstm_fwd(*fargs)
        torch.cuda.synchronize()
        e_n = err(got, lstm_cell.lstm_fwd_plain(*fargs))
        bitwise_n = same_bits(got, lstm_cell.lstm_fwd(*fargs))
        ms = cuda_ms(lambda: lstm_cell.lstm_fwd(*fargs), 20)
        plain_ms = cuda_ms(lambda: lstm_cell.lstm_fwd_plain(*fargs), 3)
        bms, by = lstm_launch_bound("lstm_fwd", fargs, reserve=False)
        route = lstm_design("K1", rw1.dtype, b, H)
        results[f"lstm_fwd_frozen/{label}"] = dict(max_abs_err=e_n, ms=ms, plain_ms=plain_ms,
                                                   bound_ms=bms, bound_by=by, design=route)
        log(f"K1 lstm_fwd without the reserve {label} b={b} T={t}: max_abs_err={e_n:.3e} "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} bound_ms={bms:.5f} ({by}); two "
            f"launches bitwise equal: {bitwise_n}; route: {route}")
        if not bitwise_n:
            raise AssertionError(f"K1 without the reserve ({label}) at the training shape gave "
                                 f"different results in two launches")
        if not e_n <= KERNEL_ATOL:
            raise AssertionError(f"K1 without the reserve ({label}) at the training shape "
                                 f"disagrees with its plain version: {e_n} > {KERNEL_ATOL}")

        _, _, _, gates, cseq = ref
        bargs = (dy, gates, cseq, rw1, peep3, m, c0, dhT, dcT)
        got = lstm_cell.lstm_bwd(*bargs)
        torch.cuda.synchronize()
        e_b = err(got, lstm_cell.lstm_bwd_plain(*bargs))
        bitwise_b = same_bits(got, lstm_cell.lstm_bwd(*bargs))
        ms = cuda_ms(lambda: lstm_cell.lstm_bwd(*bargs), 20)
        plain_ms = cuda_ms(lambda: lstm_cell.lstm_bwd_plain(*bargs), 3)
        bms, by = lstm_launch_bound("lstm_bwd", bargs, reserve=False)
        route = lstm_design("K2", rw1.dtype, b, H)
        results[f"lstm_bwd/{label}"] = dict(max_abs_err=e_b, ms=ms, plain_ms=plain_ms,
                                            bound_ms=bms, bound_by=by, design=route)
        log(f"K2 lstm_bwd {label} b={b} T={t}: max_abs_err={e_b:.3e} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.3f} bound_ms={bms:.5f} ({by}; {1e3 * ms / t:.2f} us a step); "
            f"two launches bitwise equal: {bitwise_b}; route: {route}")
        if not (bitwise_f and bitwise_b):
            raise AssertionError(f"K1 with reserve or K2 ({label}) gave different results in "
                                 f"two launches: {bitwise_f}, {bitwise_b}")
        if not e_f <= KERNEL_ATOL:
            raise AssertionError(f"K1 with reserve ({label}) disagrees with its plain "
                                 f"version: {e_f} > {KERNEL_ATOL}")
        if not e_b <= BWD_ATOL:
            raise AssertionError(f"K2 ({label}) disagrees with its plain version: "
                                 f"{e_b} > {BWD_ATOL}")

    fargs = (xp, rw1, w2, rw2, b2, peep6, h0pack)
    got = lstm_fused.lstm2_fwd(*fargs, save_reserve=True)
    torch.cuda.synchronize()
    ref = lstm_fused.lstm2_fwd_plain(*fargs, save_reserve=True)
    e_f = err(got, ref)
    bitwise_f = same_bits(got, lstm_fused.lstm2_fwd(*fargs, save_reserve=True))
    ms = cuda_ms(lambda: lstm_fused.lstm2_fwd(*fargs, save_reserve=True), 20)
    plain_ms = cuda_ms(lambda: lstm_fused.lstm2_fwd_plain(*fargs, save_reserve=True), 3)
    bms, by = lstm_launch_bound("lstm2_fwd", fargs, reserve=True)
    route = k3_design(rw1.dtype, b, H, reserve=True)
    results["lstm2_fwd_train"] = dict(max_abs_err=e_f, ms=ms, plain_ms=plain_ms,
                                      bound_ms=bms, bound_by=by, design=route)
    log(f"K3 lstm2_fwd train b={b} T={t}: max_abs_err={e_f:.3e} kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.3f} bound_ms={bms:.5f} ({by}; chain of {t + 1} phases, "
        f"{1e3 * ms / (t + 1):.2f} us a phase); two launches bitwise equal: {bitwise_f}; "
        f"route: {route}")
    if not bitwise_f:
        raise AssertionError("K3 with reserve gave different results in two launches on the "
                             "same inputs")

    _, _, _, g1, c1, g2, c2 = ref
    c0pack = torch.stack([h0pack[1], h0pack[3]])
    bargs = (dy, g1, c1, g2, c2, rw1, w2, rw2, peep6, c0pack, dhcT)
    got = lstm_fused.lstm2_bwd(*bargs)
    torch.cuda.synchronize()
    e_b = err(got, lstm_fused.lstm2_bwd_plain(*bargs))
    ms = cuda_ms(lambda: lstm_fused.lstm2_bwd(*bargs), 20)
    plain_ms = cuda_ms(lambda: lstm_fused.lstm2_bwd_plain(*bargs), 3)
    bms, by = lstm_launch_bound("lstm2_bwd", bargs, reserve=False)
    bitwise = same_bits(got, lstm_fused.lstm2_bwd(*bargs))
    route = k4_design(rw1.dtype, b, H)
    results["lstm2_bwd"] = dict(max_abs_err=e_b, ms=ms, plain_ms=plain_ms,
                                bound_ms=bms, bound_by=by, design=route)
    log(f"K4 lstm2_bwd b={b} T={t}: max_abs_err={e_b:.3e} kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.3f} bound_ms={bms:.5f} ({by}; chain of {t + 1} phases, "
        f"{1e3 * ms / (t + 1):.2f} us a phase); two launches bitwise equal: {bitwise}; "
        f"route: {route}")
    if not bitwise:
        raise AssertionError("K4 gave different results in two launches on the same inputs")
    if not e_f <= KERNEL_ATOL:
        raise AssertionError(f"K3 with reserve disagrees with its plain version: "
                             f"{e_f} > {KERNEL_ATOL}")
    if not e_b <= BWD_ATOL:
        raise AssertionError(f"K4 disagrees with its plain version: {e_b} > {BWD_ATOL}")
    return results


def same_bits(first, again):
    """Whether two launches' outputs (tuples, None where absent) are equal
    bit for bit."""
    torch.cuda.synchronize()
    return all(torch.equal(a, r) for a, r in zip(first, again) if a is not None)


def lstm_design(kernel, w_dtype, b, h, reserve=False):
    """The body K1 (``reserve``: its training instantiation) or K2 takes for
    weights of this type at this shape, and its grid: the C entry's static
    choice, named by the exports ``dl4j_lstm_{fwd,bwd}_tc`` and
    ``dl4j_lstm_{fwd,bwd}_units``."""
    from deeplearning4j_torch.ops import lstm_cell

    tc, units = (lstm_cell.fwd_route(w_dtype, b, h, reserve) if kernel == "K1"
                 else lstm_cell.bwd_route(w_dtype, b, h))
    grid = f"{units} units a block, {h // units} blocks" if units else "no grid fits"
    if not tc:
        return (f"CUDA cores: {grid}, " + ("h read back from ys and converted in every block, "
                                          "dot_col" if kernel == "K1"
                                          else "row_dot over the dz rows through L2"))
    if kernel == "K1":
        return (f"tensor cores: {grid}, bf16 h exchanged once (two slots), mma.sync m16n8k16, "
                f"h rows by cp.async (3 chunks in flight a warp), xp prefetched before the "
                f"barrier")
    return (f"tensor cores: {grid}, each reading all of dz, mma.sync m16n8k16, dz rows by "
            f"cp.async (3 chunks in flight a warp), the reserve prefetched before the barrier")


def k4_design(w_dtype, b, h):
    """The body K4 takes for weights of this type at this shape, and its
    grid: the C entry's static choice, named by its exports
    ``dl4j_lstm2_bwd_tc`` and ``dl4j_lstm2_bwd_units``."""
    from deeplearning4j_torch.ops import lstm_fused

    tc, units = lstm_fused.bwd_route(w_dtype, b, h)
    grid = f"{units} units a block, {h // units} blocks" if units else "no grid fits"
    return (f"tensor cores: {grid} in clusters of 2 that share 8 units and split k (half "
            f"the dz exchange an SM), mma.sync m16n8k16, dz rows by cp.async (3 chunks in "
            f"flight a warp), partial sums through distributed shared memory, the reserve "
            f"prefetched before the barrier" if tc
            else f"CUDA cores: {grid}, row_dot over the dz rows through L2")


def k3_design(w_dtype, b, h, reserve=False):
    """The body K3 (``reserve``: its training instantiation) takes for
    weights of this type at this shape, and its grid: the C entry's static
    choice, named by its exports ``dl4j_lstm2_fwd_tc`` and
    ``dl4j_lstm2_fwd_units``."""
    from deeplearning4j_torch.ops import lstm_fused

    tc, units = lstm_fused.fwd_route(w_dtype, b, h, reserve)
    if tc:
        return (f"tensor cores: {units} units a block, {h // units} blocks a layer "
                f"({2 * h // units} in all), bf16 h1 and h2 exchanged once (two slots each), "
                f"mma.sync m16n8k16 (layer 1 h1 rows by RW1; layer 2 h1 rows by W2 and h2 "
                f"rows by RW2), rows by cp.async (3 chunks in flight a warp), xp prefetched "
                f"before the barrier")
    grid = f"{units} units a block, {h // units} blocks" if units else "no grid fits"
    return (f"CUDA cores: {grid}, each block both layers, h1 and h2 read back through L2 "
            f"and converted in every block, dot_col")


def check_lstm2_fwd_small():
    """K3 (serving and training instantiations) against lstm2_fwd_plain over
    small cases on both of its bodies: bf16 weights at b 1/8/17/32/64 (b not
    a multiple of 16 pads the m-tiles) and 65 (past the tensor-core route),
    f32 weights at b 1/8/17/32/64; H 64/512, T 1/2/50, peepholes on and off.
    Where the CUDA-core body has no grid (f32 at the larger batches and
    H=512), that instantiation's launch must raise. The training
    instantiation's reserve must also give the plain backward's gradients
    of the plain forward's reserve. Each (type, H, b)'s bodies are logged;
    any case over KERNEL_ATOL (forward) or BWD_ATOL (gradients) fails the
    run."""
    from deeplearning4j_torch.ops import lstm_fused

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(14)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    def err(got, want):
        return max((a - r).abs().max().item() for a, r in zip(got, want) if a is not None)

    n, per_route, bad, raised = 0, {}, [], 0
    worst = {"forward": 0.0, "gradients": 0.0}
    for wd in (torch.bfloat16, torch.float32):
        for h in (64, 512):
            for b in (1, 8, 17, 32, 64) + ((65,) if wd == torch.bfloat16 else ()):
                routes = {}
                for label, reserve in (("serving", False), ("with reserve", True)):
                    tc, units = lstm_fused.fwd_route(wd, b, h, reserve)
                    routes[label] = ("tensor cores" if tc else "CUDA cores", units)
                worst_c = {"forward": 0.0, "gradients": 0.0}
                for t in (1, 2, 50):
                    for with_peep in (True, False):
                        xp = rnd(t, b, 4 * h)
                        rw1, w2, rw2 = (rnd(h, 4 * h, scale=h ** -0.5).to(wd) for _ in range(3))
                        b2 = rnd(4 * h, scale=0.1)
                        peep = rnd(6, h, scale=0.1) if with_peep else None
                        h0 = rnd(4, b, h, scale=0.5)
                        fargs = (xp, rw1, w2, rw2, b2, peep, h0)
                        ref = lstm_fused.lstm2_fwd_plain(*fargs, save_reserve=True)
                        e_f = e_g = 0.0
                        for label, reserve in (("serving", False), ("with reserve", True)):
                            if routes[label][1] == 0:   # no grid: the launch must raise
                                try:
                                    lstm_fused.lstm2_fwd(*fargs, save_reserve=reserve)
                                except RuntimeError:
                                    raised += 1
                                    continue
                                raise AssertionError(
                                    f"K3 {label} launched with no grid: {wd} H={h} b={b}")
                            got = lstm_fused.lstm2_fwd(*fargs, save_reserve=reserve)
                            torch.cuda.synchronize()
                            e_f = max(e_f, err(got, ref if reserve else ref[:2]))
                            if reserve:
                                c0 = torch.stack([h0[1], h0[3]])
                                dy, dhcT = rnd(t, b, h, scale=0.1), rnd(4, b, h, scale=0.1)
                                grads = [lstm_fused.lstm2_bwd_plain(dy, *res[3:7], rw1, w2, rw2,
                                                                    peep, c0, dhcT)
                                         for res in (got, ref)]
                                e_g = err(*grads)
                            key = f"{label} {routes[label][0]}"
                            per_route[key] = per_route.get(key, 0) + 1
                        n += 1
                        worst_c["forward"] = max(worst_c["forward"], e_f)
                        worst_c["gradients"] = max(worst_c["gradients"], e_g)
                        if not (e_f <= KERNEL_ATOL and e_g <= BWD_ATOL):
                            bad.append((str(wd)[6:], h, b, t, with_peep, e_f, e_g))
                for k in worst:
                    worst[k] = max(worst[k], worst_c[k])
                log(f"  K3 small cases {str(wd)[6:]} H={h} b={b}: bodies "
                    + ", ".join(f"{k} {body} ({units} units a block)" if units
                                else f"{k} {body} (no grid: the launch raised)"
                                for k, (body, units) in routes.items())
                    + f"; T 1/2/50, peepholes on/off; worst max_abs_err "
                    f"{worst_c['forward']:.3e}, gradients of its reserve "
                    f"{worst_c['gradients']:.3e}")
    log(f"K3 small shapes ({n} cases, launches per body {per_route}, {raised} launches with "
        f"no grid raised): worst max_abs_err {worst['forward']:.3e} (limit {KERNEL_ATOL}), "
        f"gradients of its reserve {worst['gradients']:.3e} (limit {BWD_ATOL})")
    if bad:
        raise AssertionError(f"K3 disagrees with its plain version in {len(bad)} small cases "
                             f"(dtype, H, b, T, peepholes, err, gradients err): {bad}")
    return worst


def check_lstm2_bwd_small():
    """K4 against lstm2_bwd_plain over small cases on both of its bodies:
    bf16 and f32 weights, b 1/8/17/64 (b not a multiple of 16 pads the
    m-tiles), H 64/512, T 1/2/50, peepholes on and off. Each case gets the
    plain forward's reserve and the same dy and state; any case over
    BWD_ATOL fails the run."""
    from deeplearning4j_torch.ops import lstm_fused

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(12)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    n, worst, per_route, bad = 0, 0.0, {}, []
    for wd in (torch.bfloat16, torch.float32):
        for h in (64, 512):
            for b in (1, 8, 17, 64):
                tc, units = lstm_fused.bwd_route(wd, b, h)
                route = "tensor cores" if tc else "CUDA cores"
                worst_c = 0.0
                for t in (1, 2, 50):
                    for with_peep in (True, False):
                        xp = rnd(t, b, 4 * h)
                        rw1, w2, rw2 = (rnd(h, 4 * h, scale=h ** -0.5).to(wd) for _ in range(3))
                        b2 = rnd(4 * h, scale=0.1)
                        peep = rnd(6, h, scale=0.1) if with_peep else None
                        h0 = rnd(4, b, h, scale=0.5)
                        _, _, _, g1, c1, g2, c2 = lstm_fused.lstm2_fwd_plain(
                            xp, rw1, w2, rw2, b2, peep, h0, save_reserve=True)
                        bargs = (rnd(t, b, h, scale=0.1), g1, c1, g2, c2, rw1, w2, rw2, peep,
                                 torch.stack([h0[1], h0[3]]), rnd(4, b, h, scale=0.1))
                        got = lstm_fused.lstm2_bwd(*bargs)
                        torch.cuda.synchronize()
                        want = lstm_fused.lstm2_bwd_plain(*bargs)
                        e = max((a - r).abs().max().item() for a, r in zip(got, want)
                                if a is not None)
                        n += 1
                        per_route[route] = per_route.get(route, 0) + 1
                        worst_c = max(worst_c, e)
                        if not e <= BWD_ATOL:
                            bad.append((str(wd)[6:], h, b, t, with_peep, e))
                worst = max(worst, worst_c)
                log(f"  K4 small cases {str(wd)[6:]} H={h} b={b}: route {route} ({units} units "
                    f"a block); T 1/2/50, peepholes on/off; worst max_abs_err {worst_c:.3e}")
    log(f"K4 small shapes ({n} cases, per route {per_route}): worst max_abs_err {worst:.3e} "
        f"(limit {BWD_ATOL})")
    if bad:
        raise AssertionError(f"K4 disagrees with its plain version in {len(bad)} small cases "
                             f"(dtype, H, b, T, peepholes, err): {bad}")
    return worst


def check_lstm_small():
    """K1 (serving and training instantiations) and K2 against their plain
    versions over small cases on both bodies: bf16 and f32 weights, b
    1/8/17/32/64 (b not a multiple of 16 pads the m-tiles) and 65 in bf16
    (past the tensor-core route), H 64/512, T 1/2/50, peepholes on and off,
    no mask and a fractional one (some rows padded whole). K2 gets the
    plain forward's reserve and the same dy and state. Each (type, H, b)'s
    bodies are logged; any case over KERNEL_ATOL (K1) or BWD_ATOL (K2)
    fails the run."""
    from deeplearning4j_torch.ops import lstm_cell

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(13)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    def err(got, want):
        return max((a - r).abs().max().item() for a, r in zip(got, want) if a is not None)

    n, per_route, bad = 0, {}, []
    worst = {"K1": 0.0, "K2": 0.0}
    for wd in (torch.bfloat16, torch.float32):
        for h in (64, 512):
            for b in (1, 8, 17, 32, 64) + ((65,) if wd == torch.bfloat16 else ()):
                routes = {kernel: ("tensor cores" if tc else "CUDA cores", units)
                          for kernel, (tc, units) in (
                              ("K1", lstm_cell.fwd_route(wd, b, h)),
                              ("K1 with reserve", lstm_cell.fwd_route(wd, b, h, True)),
                              ("K2", lstm_cell.bwd_route(wd, b, h)))}
                worst_c = {"K1": 0.0, "K2": 0.0}
                for t in (1, 2, 50):
                    for with_peep in (True, False):
                        for masked in (False, True):
                            xp = rnd(t, b, 4 * h)
                            rw = rnd(h, 4 * h, scale=h ** -0.5).to(wd)
                            peep = rnd(3, h, scale=0.1) if with_peep else None
                            h0, c0 = rnd(b, h, scale=0.5), rnd(b, h, scale=0.5)
                            m = None
                            if masked:   # real steps 1, a ramp at each row's end, padding 0
                                lengths = torch.randint(0, t + 2, (b,), generator=g)
                                steps = torch.arange(t)[:, None].float()
                                m = torch.clamp((lengths[None, :].float() - steps) / 2.0,
                                                0.0, 1.0).to(dev)
                            fargs = (xp, rw, peep, m, h0, c0)
                            got_s = lstm_cell.lstm_fwd(*fargs)
                            got_r = lstm_cell.lstm_fwd(*fargs, save_reserve=True)
                            torch.cuda.synchronize()
                            ref = lstm_cell.lstm_fwd_plain(*fargs, save_reserve=True)
                            e_f = max(err(got_s, ref[:3]), err(got_r, ref))
                            bargs = (rnd(t, b, h, scale=0.1), ref[3], ref[4], rw, peep, m, c0,
                                     rnd(b, h, scale=0.1), rnd(b, h, scale=0.1))
                            got_b = lstm_cell.lstm_bwd(*bargs)
                            torch.cuda.synchronize()
                            e_b = err(got_b, lstm_cell.lstm_bwd_plain(*bargs))
                            n += 1
                            for kernel, (body, _) in routes.items():
                                key = f"{kernel} {body}"
                                per_route[key] = per_route.get(key, 0) + 1
                            worst_c["K1"] = max(worst_c["K1"], e_f)
                            worst_c["K2"] = max(worst_c["K2"], e_b)
                            if not (e_f <= KERNEL_ATOL and e_b <= BWD_ATOL):
                                bad.append((str(wd)[6:], h, b, t, with_peep, masked, e_f, e_b))
                for k in worst:
                    worst[k] = max(worst[k], worst_c[k])
                log(f"  K1/K2 small cases {str(wd)[6:]} H={h} b={b}: bodies "
                    + ", ".join(f"{k} {body} ({units} units a block)"
                                for k, (body, units) in routes.items())
                    + f"; T 1/2/50, peepholes on/off, mask none/fractional; worst max_abs_err "
                    f"K1 {worst_c['K1']:.3e}, K2 {worst_c['K2']:.3e}")
    log(f"K1/K2 small shapes ({n} cases, cases per body {per_route}): worst max_abs_err "
        f"K1 {worst['K1']:.3e} (limit {KERNEL_ATOL}), K2 {worst['K2']:.3e} (limit {BWD_ATOL})")
    if bad:
        raise AssertionError(f"K1 or K2 disagrees with its plain version in {len(bad)} small "
                             f"cases (dtype, H, b, T, peepholes, mask, K1 err, K2 err): {bad}")
    return worst


def char_rnn_conf():
    """The char-RNN of bench.py:230: vocab 80, 2 x GravesLSTM(512),
    RnnOutputLayer softmax + mcxent, Adam(1e-3), bf16 compute, TBPTT 50."""
    from deeplearning4j_torch import Adam, NeuralNetConfiguration
    from deeplearning4j_torch.nn.conf.layers import GravesLSTM, RnnOutputLayer

    return (NeuralNetConfiguration.builder().seed(1).updater(Adam(learning_rate=1e-3))
            .activation("tanh").compute_dtype("bfloat16").list()
            .layer(GravesLSTM(n_in=VOCAB, n_out=H))
            .layer(GravesLSTM(n_in=H, n_out=H))
            .layer(RnnOutputLayer(n_in=H, n_out=VOCAB, activation="softmax", loss="mcxent"))
            .backprop_type("tbptt").t_bptt_forward_length(TRAIN_T)
            .t_bptt_backward_length(TRAIN_T).build())


def build_net(conf, seed=2):
    """The network on the card from the config's seed, with random
    peepholes on every LSTM layer so that the peephole terms are exercised
    (init draws 0)."""
    from deeplearning4j_torch import MultiLayerNetwork

    net = MultiLayerNetwork(conf).init()          # device defaults to the card
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for impl in [im for im in net.impls if hasattr(im, "pi")]:
            for k in ("pi", "pf", "po"):
                getattr(impl, k).copy_((torch.randn(H, generator=g) * 0.1).to(net.device))
    return net


def one_hot(rng, b, t):
    return one_hot_ids(rng.integers(0, VOCAB, (b, t)), VOCAB)


def one_hot_ids(ids, vocab):
    return np.eye(vocab, dtype=np.float32)[ids]


def post(port, name, x):
    body = json.dumps({"inputs": x.tolist()}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/models/{name}/predict",
                                 data=body, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return np.asarray(json.loads(resp.read())["outputs"], np.float32)


def serve(net):
    from deeplearning4j_torch import InferenceServer

    rng = np.random.default_rng(3)
    # T from 50 to 200 (at T=200), across all three time buckets
    masked = [one_hot(rng, int(rng.integers(1, 9)), int(T * f))
              for f in (0.25, 0.32, 0.485, 0.64, 0.75, 1.0, 0.385, 0.905)]
    fixed = [one_hot(rng, int(rng.integers(1, 9)), T) for _ in range(8)]
    stream = one_hot(rng, 2, 120)

    srv = InferenceServer()
    # precision="bf16": a registration sets the net's compute dtype (an f32
    # one would flip this bf16 net, and its config, to f32)
    srv.register("charrnn", net, time_buckets=TIME_BUCKETS, linger_ms=10.0,
                 input_shape=(T, VOCAB), warmup=True, precision="bf16")
    srv.register("charrnn_fixed", net, linger_ms=10.0, input_shape=(T, VOCAB),
                 warmup=True, precision="bf16")
    port = srv.start(port=0)
    try:
        reset_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=16) as pool:
            futs = ([pool.submit(post, port, "charrnn", x) for x in masked]
                    + [pool.submit(post, port, "charrnn_fixed", x) for x in fixed])
            answers = [f.result() for f in futs]
        serve_s = time.perf_counter() - t0
        launches = read_counts()
    finally:
        srv.stop()
    log(f"served {len(answers)} HTTP requests in {serve_s:.3f} s; serving-path launches "
        f"{launches}")
    if launches["lstm_fwd"] < 1 or launches["lstm2_fwd"] < 1:
        raise AssertionError(f"a kernel of the serving path never launched: {launches}")
    if any(launches[n] for n in launches if n not in ("lstm_fwd", "lstm2_fwd")):
        raise AssertionError(f"serving launched a training kernel: {launches}")

    # streaming, counted on its own: unmasked chunks through the fused pair
    net.rnn_clear_previous_state()
    reset_counts()
    steps = [net.rnn_time_step(stream[:, a:b]) for a, b in ((0, 40), (40, 41), (41, 120))]
    torch.cuda.synchronize()
    stream_launches = read_counts()
    log(f"rnn_time_step launches {stream_launches}")
    if stream_launches != {**{n: 0 for n in stream_launches}, "lstm2_fwd": len(steps)}:
        raise AssertionError(f"each rnn_time_step chunk must be one K3 launch: "
                             f"{stream_launches}")

    worst = 0.0
    for x, y in zip(masked + fixed, answers):
        ref = net.output(x).cpu().numpy()
        if y.shape != ref.shape or not np.isfinite(y).all():
            raise AssertionError(f"bad response shape {y.shape} vs {ref.shape}")
        worst = max(worst, float(np.abs(y - ref).max()))
        if not np.allclose(y.sum(-1), 1.0, atol=1e-2):
            raise AssertionError("a response row does not sum to 1")
    log(f"responses vs model.output: max_abs_err={worst:.3e}")
    if not worst <= SERVE_ATOL:
        raise AssertionError(f"served answers disagree with model.output: {worst}")
    full = net.output(stream).cpu()
    step_err = (torch.cat([s.cpu() for s in steps], 1) - full).abs().max().item()
    log(f"rnn_time_step chunks vs output: max_abs_err={step_err:.3e}")
    if not step_err <= SERVE_ATOL:
        raise AssertionError(f"rnn_time_step disagrees with output: {step_err}")
    return launches, stream_launches


def check_reference(conf, net):
    """The card's forward against the same network on the CPU, where every
    kernel is its plain version, on a small input (masked and unmasked)."""
    from deeplearning4j_torch import MultiLayerNetwork

    cpu = MultiLayerNetwork(conf).init(
        params={k: {n: t.cpu() for n, t in p.items()} for k, p in net.params.items()},
        device="cpu")
    x = one_hot(np.random.default_rng(4), 2, 30)
    m = np.ones((2, 30), np.float32)
    m[1, 20:] = 0.0
    err = 0.0
    for mask in (None, m):
        a = net.output(x, mask=mask).cpu()
        b = cpu.output(x, mask=mask)
        err = max(err, (a - b).abs().max().item())
    with torch.inference_mode():
        h2 = net._fused_lstm_forward(net._to_device(x), {}, 0).float().cpu()
        h2_ref = cpu._fused_lstm_forward(cpu._to_device(x), {}, 0).float()
    h_err = (h2 - h2_ref).abs().max().item()
    log(f"card vs CPU reference: probabilities max_abs_err={err:.3e}, layer 2 h "
        f"max_abs_err={h_err:.3e} (max |h| {h2_ref.abs().max().item():.3f})")
    if not err <= REF_ATOL:
        raise AssertionError(f"card and CPU reference disagree: {err}")
    if not h_err <= KERNEL_ATOL:
        raise AssertionError(f"card and CPU reference disagree on layer 2's h: {h_err}")


def counters():
    """Every kernel's launch counter, by name."""
    from deeplearning4j_torch.ops import flash_attention, lstm_cell, lstm_fused

    return {c.name: c for c in (lstm_cell.COUNTER, lstm_cell.TRAIN_COUNTER,
                                lstm_cell.BWD_COUNTER, lstm_fused.COUNTER,
                                lstm_fused.TRAIN_COUNTER, lstm_fused.BWD_COUNTER,
                                flash_attention.FWD_COUNTER, flash_attention.DQ_COUNTER,
                                flash_attention.DKV_COUNTER)}


def reset_counts():
    for c in counters().values():
        c.reset()


def read_counts():
    return {n: c.launches for n, c in counters().items()}


def periodic_text(rng, b, t, period=23):
    """One-hot next-character data cut from a fixed cycle of ``period``
    characters at random offsets: text with something to learn."""
    cycle = rng.integers(0, VOCAB, period)
    ids = cycle[(rng.integers(0, period, b)[:, None] + np.arange(t + 1)[None, :]) % period]
    eye = np.eye(VOCAB, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def profile_call(label, fn, updater=None, forbid=(), group=None):
    """One call of ``fn`` under torch.profiler: device time and launches by
    kernel, and the card's busy share of the call's wall time (profiler
    on, so slightly slower than an unprofiled call). With ``updater``, its
    ``apply`` is marked by a range, and device time and launches are also
    summed by ``kernel_group``. Raises if the name of a kernel or of a host
    op holds a word of ``forbid`` (any case). None
    when the profiler recorded no device events, unless ``forbid`` is
    given: then that raises, since nothing was checked. ``group`` replaces
    ``kernel_group``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    if updater is not None:
        real = updater.apply

        def tagged(*a, **k):
            with record_function("dl4j::updater"):
                return real(*a, **k)
        updater.apply = tagged
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        if updater is not None:
            del updater.apply
    events = prof.events()
    spans, by_name = [], {}
    for e in events:
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            spans.append((e.time_range.start, e.time_range.end))
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    if not spans:
        if forbid:
            raise AssertionError(f"profile of {label}: the profiler recorded no device events")
        log(f"profile of {label}: the profiler recorded no device events")
        return None
    bad = [n for n in by_name if any(w in n.lower() for w in forbid)]
    bad += sorted({e.name for e in events if e.device_type == DeviceType.CPU
                   and any(w in e.name.lower() for w in forbid)})
    if bad:
        raise AssertionError(f"{label} launched kernels it must not: {bad}")
    spans.sort()
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    log(f"profile of {label}: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), "
        f"{sum(n for n, _ in by_name.values())} device events"
        + (f", no kernel or op named {' or '.join(forbid)}" if forbid else "")
        + "; device time by kernel (launches):")
    for name, (n, us) in top:
        log(f"  {us / 1e3:9.3f} ms ({n:5d})  {name[:100]}")
    res = {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
           "launches": sum(n for n, _ in by_name.values()),
           "top_ms": {name[:100]: us / 1e3 for name, (_, us) in top},
           "top_launches": {name[:100]: n for name, (n, _) in top}}
    if updater is None:
        return res

    def chain(e):
        while e is not None:
            yield e.name
            e = e.cpu_parent

    groups = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.kernels:
            g = (group or kernel_group)(chain(e))
            n, ms = groups.get(g, (0, 0.0))
            groups[g] = (n + len(e.kernels), ms + sum(k.duration for k in e.kernels) / 1e3)
    log("  device time by group (launches):")
    for g, (n, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        log(f"  {ms:9.3f} ms ({n:5d})  {g}")
    res["groups"] = {g: {"launches": n, "ms": ms} for g, (n, ms) in groups.items()}
    return res


def train(conf):
    """The training main path at full width: fit on a b=64, T=200 batch,
    unmasked (the fused pair: one K3-with-reserve and one K4 launch per
    TBPTT segment) and masked with variable lengths (per layer: two K1-
    with-reserve and two K2 launches per segment). Counts are reset just
    before and read just after; each fit's own launches are checked too.
    The full-batch score after each unmasked fit must fall (LOSS_DROP);
    its own launches are left out of the counts."""
    from deeplearning4j_torch import DataSet

    net = build_net(conf, seed=3)
    rng = np.random.default_rng(6)
    f, l = periodic_text(rng, TRAIN_B, TRAIN_SEQ)
    lengths = rng.integers(TRAIN_SEQ // 2, TRAIN_SEQ + 1, TRAIN_B)
    m = (np.arange(TRAIN_SEQ)[None, :] < lengths[:, None]).astype(np.float32)
    ds, mds = DataSet(f, l), DataSet(f, l, m, m)
    segs = -(-TRAIN_SEQ // TRAIN_T)
    routes = (("unmasked", ds, TRAIN_FITS, {"lstm2_fwd_train": segs, "lstm2_bwd": segs}),
              ("masked", mds, MASKED_FITS, {"lstm_fwd_train": 2 * segs, "lstm_bwd": 2 * segs}))
    losses, scores = {}, []
    scoring = dict.fromkeys(counters(), 0)    # the full-batch scores' launches
    reset_counts()
    for label, data, fits, per_fit in routes:
        losses[label] = []
        for _ in range(fits):
            before = read_counts()
            net.fit(data)
            losses[label].append(net.score())
            got = {n: c - before[n] for n, c in read_counts().items()}
            want = {n: per_fit.get(n, 0) for n in got}
            if got != want:
                raise AssertionError(f"a {label} fit of {segs} TBPTT segments launched "
                                     f"{got}, expected {want}")
            if label == "unmasked":
                before = read_counts()
                scores.append(net.score(data))
                for n, c in read_counts().items():
                    scoring[n] += c - before[n]
    launches = {n: c - scoring[n] for n, c in read_counts().items()}
    log(f"training main path: {TRAIN_FITS} unmasked + {MASKED_FITS} masked fits of b={TRAIN_B} "
        f"T={TRAIN_SEQ} ({segs} TBPTT segments each), launches {launches}")
    for label, ls in losses.items():
        log(f"{label} loss per fit: " + " ".join(f"{x:.3f}" for x in ls))
        if not np.isfinite(ls).all():
            raise AssertionError(f"{label} training loss is not finite: {ls}")
    log("unmasked full-batch score after each fit: " + " ".join(f"{x:.3f}" for x in scores))
    first, last3 = scores[0], float(np.mean(scores[-3:]))
    drop = 1.0 - last3 / first
    log(f"unmasked full-batch score: mean of the last three fits {last3:.3f}, "
        f"{100 * drop:.1f}% below the first fit's {first:.3f}")
    if not drop >= LOSS_DROP:
        raise AssertionError(f"the loss fell by {drop:.3f}, less than {LOSS_DROP}")

    times, pipe = {}, {}
    for label, data, fits, per_fit in routes:
        # the fit through the pipeline (2 workers, put-ahead: the default)
        # beside the synchronous path (DL4J_TPU_PREFETCH_WORKERS=0, the
        # parent's behaviour) in alternating turns; each turn is
        # TIMED_FITS fits of one DataSet, so each fit starts its own pool
        turns = {"pipeline": [], "sync": []}
        for turn in range(FIT_TURNS):
            for mode in (("pipeline", "sync") if turn % 2 == 0 else ("sync", "pipeline")):
                with prefetch_workers(2 if mode == "pipeline" else 0):
                    before = read_counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(TIMED_FITS):
                        net.fit(data)
                    net.score()                       # the value: a sync
                    turns[mode].append((time.perf_counter() - t0) * 1e3 / TIMED_FITS)
                    got = {n: c - before[n] for n, c in read_counts().items()}
                    want = {n: TIMED_FITS * per_fit.get(n, 0) for n in got}
                    if got != want:
                        raise AssertionError(f"{TIMED_FITS} {label} fits ({mode}) launched "
                                             f"{got}, expected {want}")
        med = {m: float(np.median(v)) for m, v in turns.items()}
        times[label] = med["pipeline"]
        pipe[label] = {"turns_ms": turns, "median_ms": med}
        log(f"smoke number, not a benchmark: a {label} fit {med['pipeline']:.3f} ms through "
            f"the pipeline, {med['sync']:.3f} ms synchronous (medians of {FIT_TURNS} "
            f"alternating turns of {TIMED_FITS} fits; pipeline "
            f"{' '.join(f'{x:.3f}' for x in turns['pipeline'])}, sync "
            f"{' '.join(f'{x:.3f}' for x in turns['sync'])}); the per-fit worker pool "
            f"costs {med['pipeline'] - med['sync']:+.3f} ms a fit; "
            f"{TRAIN_B * TRAIN_SEQ / med['pipeline'] * 1e3:.0f} characters/s")
    pipe["breakdown_ms"] = pipeline_breakdown(net, mds)
    pipe["host_copy_ms"] = host_copy_rates()
    prof = profile_call("one unmasked fit", lambda: net.fit(ds))
    if prof is not None:
        for kernel, key in (("K3 with reserve", "lstm2_fwd"), ("K4", "lstm2_bwd")):
            k = sum(ms for name, ms in prof["top_ms"].items() if key in name)
            log(f"{kernel} in one unmasked fit: {k:.3f} ms of device time, "
                f"{100 * k / prof['busy_ms']:.1f}% of the fit's {prof['busy_ms']:.3f} ms "
                f"device busy")
    prof_m = profile_call("one masked fit", lambda: net.fit(mds))
    if prof_m is not None:
        for kernel, key in (("K1 with reserve", "lstm_fwd"), ("K2", "lstm_bwd")):
            k = sum(ms for name, ms in prof_m["top_ms"].items() if key in name)
            log(f"{kernel} in one masked fit: {k:.3f} ms of device time, "
                f"{100 * k / prof_m['busy_ms']:.1f}% of the fit's {prof_m['busy_ms']:.3f} ms "
                f"device busy")
    return {"launches": launches, "losses": losses, "scores": scores, "fit_ms": times,
            "pipeline": pipe, "profile": prof, "profile_masked": prof_m, "net": net}


def pipeline_breakdown(net, ds, reps=20):
    """Where a single-DataSet fit's pipeline spends its time, outside any
    step: making the pipeline and receiving the first batch on the card
    (threads started, host arrays copied into pinned buffers, the copy on
    the side stream, the consumer's wait), and shutting it down; beside the
    synchronous path's copy of the same batch. Means of ``reps``."""
    from deeplearning4j_torch import ListDataSetIterator
    from deeplearning4j_torch.datasets.prefetch import wrap_for_training

    first, close, sync = [], [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        it, _ = wrap_for_training(ListDataSetIterator([ds]), net.device)
        next(iter(it))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        it.shutdown()
        t2 = time.perf_counter()
        net._tensors(ds)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        first.append((t1 - t0) * 1e3)
        close.append((t2 - t1) * 1e3)
        sync.append((t3 - t2) * 1e3)
    out = {"start_and_first_batch": float(np.mean(first)), "shutdown": float(np.mean(close)),
           "sync_copy": float(np.mean(sync))}
    log(f"pipeline of one masked DataSet (b={TRAIN_B} T={TRAIN_SEQ}, 4 arrays): start and "
        f"first batch on the card {out['start_and_first_batch']:.3f} ms, shutdown "
        f"{out['shutdown']:.3f} ms; the synchronous copy {out['sync_copy']:.3f} ms (means of "
        f"{reps})")
    return out


def host_copy_rates(reps=5):
    """The put-ahead's host copy into a pinned staging buffer, on a fresh
    thread as a pipeline's worker runs it, by torch's ``copy_`` (intra-op
    threads) and by numpy's ``copyto`` (one thread), at the char-RNN's
    labels (4 MB) and the TransformerLM's (537 MB): the measurement behind
    ``datasets/prefetch.py``'s ``_PARALLEL_COPY_BYTES``. Medians of
    ``reps``."""
    import threading

    out = {}
    for n_bytes in (TRAIN_B * TRAIN_SEQ * VOCAB * 4, LM_B * LM_T * LM_VOCAB * 4):
        a = np.random.default_rng(13).random(n_bytes // 4, dtype=np.float32)
        buf = torch.empty(a.shape, dtype=torch.float32, pin_memory=True)
        for how in ("torch", "numpy"):
            times = []

            def copy():
                t0 = time.perf_counter()
                if how == "torch":
                    buf.copy_(torch.from_numpy(a))
                else:
                    np.copyto(buf.numpy(), a)
                times.append((time.perf_counter() - t0) * 1e3)

            for _ in range(reps):
                t = threading.Thread(target=copy)
                t.start()
                t.join(timeout=60)
            out[f"{n_bytes / 1e6:.1f} MB {how}"] = float(np.median(times))
        del buf
    log("host copy into pinned memory on a fresh thread (medians of "
        f"{reps}): " + ", ".join(f"{k} {v:.3f} ms" for k, v in out.items()))
    return out


def check_train_reference(conf):
    """compute_gradient_and_score on the card against the same network on
    the CPU, where every kernel is its plain version, on a small input at
    full width, unmasked (fused pair) and masked (per layer)."""
    from deeplearning4j_torch import DataSet, MultiLayerNetwork

    net = build_net(conf, seed=4)
    cpu = MultiLayerNetwork(conf).init(
        params={k: {n: t.cpu() for n, t in p.items()} for k, p in net.params.items()},
        device="cpu")
    f, l = periodic_text(np.random.default_rng(7), 4, 30)
    m = np.ones((4, 30), np.float32)
    m[1, 20:] = 0.0
    m[3, 12:] = 0.0
    worst = 0.0
    for label, mask in (("unmasked", None), ("masked", m)):
        ds = DataSet(f, l, mask, mask)
        g_card, s_card = net.compute_gradient_and_score(ds)
        g_cpu, s_cpu = cpu.compute_gradient_and_score(ds)
        s_err = abs(s_card - s_cpu) / abs(s_cpu)
        g_err = {f"{i}/{k}": ((g_card[i][k].cpu() - g).abs().max() / g.abs().max()).item()
                 for i, gs in g_cpu.items() for k, g in gs.items()}
        key = max(g_err, key=g_err.get)
        log(f"card vs CPU reference, training {label}: score {s_card:.4f} vs {s_cpu:.4f} "
            f"(rel {s_err:.2e}); worst gradient {key} rel {g_err[key]:.2e}")
        if not s_err <= TRAIN_SCORE_RTOL:
            raise AssertionError(f"card and CPU scores disagree ({label}): {s_err}")
        if not g_err[key] <= TRAIN_GRAD_RTOL:
            raise AssertionError(f"card and CPU gradients disagree ({label}): {key} "
                                 f"{g_err[key]}")
        worst = max(worst, g_err[key])
    return worst


def check_flash_kernels():
    """K5, K6 and K7 against their plain versions at the TransformerLM's
    shape: causal (timed), non-causal, a key mask that pads example 1
    whole, and dropout at a seed with ring-style offsets. Each backward
    gets the plain forward's o and lse, so it is checked on its own."""
    from deeplearning4j_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(20)
    bh, t, d = LM_B * LM_HEADS, LM_T, LM_D
    q, k, v, do = (torch.randn((bh, t, d), generator=g).to(dev, torch.bfloat16)
                   for _ in range(4))
    scale = d ** -0.5
    km = torch.ones((LM_B, t))
    km[1] = 0.0                                     # example 1: every key padded
    km[2, 3 * t // 4:] = 0.0
    km[3, 3 * t // 8:] = 0.0
    km = km[:, None, :].expand(LM_B, LM_HEADS, t).reshape(bh, t).contiguous().to(dev)
    padded = slice(LM_HEADS, 2 * LM_HEADS)           # the bh rows of example 1
    seed = fa.seed3(1234567, 3 * t, 3 * t)
    cases = (("causal", True, None, 0.0, None), ("non-causal", False, None, 0.0, None),
             ("key mask", True, km, 0.0, None), ("dropout 0.1", True, None, 0.1, seed))

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    errs = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0}
    abs_errs = dict(errs)
    for label, causal, mask, rate, sd in cases:
        o, lse = fa.flash_fwd(q, k, v, mask, causal, scale, rate, sd)
        torch.cuda.synchronize()
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, mask, causal, scale, rate, sd)
        delta = fa.rowwise_delta(do, o_p)
        args = (q, k, v, mask, do, delta, lse_p, causal, scale, sd, rate)
        dq = fa.dq_block(*args)
        dk, dv = fa.dkv_block(*args)
        torch.cuda.synchronize()
        dq_p = fa.flash_dq_plain(*args)
        dk_p, dv_p = fa.flash_dkv_plain(*args)
        e = {"o": rel(o, o_p), "lse": (lse - lse_p).abs().max().item(), "dq": rel(dq, dq_p),
             "dk": rel(dk, dk_p), "dv": rel(dv, dv_p)}
        log(f"K5/K6/K7 {label} b={LM_B} h={LM_HEADS} T={t} d={d} bf16: rel err o {e['o']:.2e} "
            f"lse(abs) {e['lse']:.2e} dq {e['dq']:.2e} dk {e['dk']:.2e} dv {e['dv']:.2e}")
        if not (max(e["o"], e["dq"], e["dk"], e["dv"]) <= FLASH_RTOL and e["lse"] <= LSE_ATOL):
            raise AssertionError(f"flash kernels ({label}) disagree with their plain versions: {e}")
        if mask is not None:
            nz = [torch.count_nonzero(x[padded]).item() for x in (o, dq, dk, dv)]
            if any(nz) or not torch.all(lse[padded] == -1e30):
                raise AssertionError(f"fully padded example: nonzero o/dq/dk/dv counts {nz}")
            log("  fully padded example: o, dq, dk, dv exactly 0, lse -1e30")
        for name, pairs in (("flash_fwd", ((o, o_p), (lse, lse_p))), ("flash_dq", ((dq, dq_p),)),
                            ("flash_dkv", ((dk, dk_p), (dv, dv_p)))):
            errs[name] = max(errs[name], *(rel(a, b) for a, b in pairs if a.dtype != torch.float32))
            abs_errs[name] = max(abs_errs[name], *((a.float() - b.float()).abs().max().item()
                                                   for a, b in pairs))
    check_keep_bits(fa, seed)

    # timing at the main path's case: causal, no mask, no dropout
    o, lse = fa.flash_fwd(q, k, v, None, True, scale)
    delta = fa.rowwise_delta(do, o)
    args = (q, k, v, None, do, delta, lse, True, scale)
    # no atomics: two launches give the same bits
    first = (*fa.flash_fwd(q, k, v, None, True, scale), fa.dq_block(*args), *fa.dkv_block(*args))
    again = (*fa.flash_fwd(q, k, v, None, True, scale), fa.dq_block(*args), *fa.dkv_block(*args))
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(first, again)]
    log(f"K5/K6/K7 causal full width launched twice: o, lse, dq, dk, dv bitwise equal {same}")
    if not all(same):
        raise AssertionError(f"K5/K6/K7 are not deterministic: o, lse, dq, dk, dv equal {same}")
    del first, again
    # yardstick only, never on the port's path: PyTorch's fused attention
    # on the same [b, h, T, d] operands; its backward gives dq, dk, dv in
    # one call, so it stands beside K6 + K7 together. Its forward has read
    # 0.65 and 1.18 ms in two calls with K5 unchanged, so K5 and it are
    # timed in alternating turns and compared by their medians.
    qs, ks, vs, dos = (x.view(LM_B, LM_HEADS, t, d).detach().requires_grad_(x is not do)
                       for x in (q, k, v, do))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    turns = [(cuda_ms(lambda: fa.flash_fwd(q, k, v, None, True, scale), 10),
              cuda_ms(lambda: sdpa(qs, ks, vs, is_causal=True), 10)) for _ in range(FWD_TURNS)]
    k5_turns, sdpa_turns = zip(*turns)
    log("K5 / SDPA forward in alternating turns (ms): "
        + ", ".join(f"{a:.3f} / {b:.3f}" for a, b in turns))
    sdpa_fwd = float(np.median(sdpa_turns))
    ms = {"flash_fwd": float(np.median(k5_turns)),
          "flash_dq": cuda_ms(lambda: fa.dq_block(*args), 10),
          "flash_dkv": cuda_ms(lambda: fa.dkv_block(*args), 10)}
    plain_ms = {"flash_fwd": cuda_ms(lambda: fa.flash_fwd_plain(q, k, v, None, True, scale), 1),
                "flash_dq": cuda_ms(lambda: fa.flash_dq_plain(*args), 1),
                "flash_dkv": cuda_ms(lambda: fa.flash_dkv_plain(*args), 1)}
    out = sdpa(qs, ks, vs, is_causal=True)
    sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), dos, retain_graph=True), 10)
    library = {"flash_fwd": sdpa_fwd, "flash_dq": sdpa_bwd, "flash_dkv": sdpa_bwd}

    cells = bh * t * (t + 1) // 2                   # visible (q, k) pairs, causal
    x = bh * t * d * 2                               # one [bh, T, d] bf16 tensor
    rows = bh * t * 4                                # one [bh, T] f32 vector
    work = {"flash_fwd": (4 * x + rows, 2 * 2 * d * cells),       # q k v -> o lse; 2 products
            "flash_dq": (5 * x + 2 * rows, 3 * 2 * d * cells),    # q k v do delta lse -> dq
            "flash_dkv": (6 * x + 2 * rows, 4 * 2 * d * cells)}   # ... -> dk dv; 4 products
    results = {}
    for name, (nbytes, flops) in work.items():
        bms, by = bound(nbytes, flops, 0)
        tflops = flops / ms[name] / 1e9
        results[name] = dict(max_abs_err=abs_errs[name], max_rel_err=errs[name], ms=ms[name],
                             plain_ms=plain_ms[name], bound_ms=bms, bound_by=by,
                             library_ms=library[name], tflops=tflops)
        log(f"{name} causal b={LM_B} h={LM_HEADS} T={t} d={d}: kernel_ms={ms[name]:.3f} "
            f"({tflops:.0f} TFLOP/s) plain_ms={plain_ms[name]:.1f} bound_ms={bms:.4f} ({by}; "
            f"{flops / 1e9:.0f} GFLOP, {nbytes / 1e6:.0f} MB) library_ms={library[name]:.3f} "
            f"max_rel_err={errs[name]:.2e}")
    log(f"yardstick scaled_dot_product_attention causal: forward {sdpa_fwd:.3f} ms (median of "
        f"{FWD_TURNS} turns; K5 {ms['flash_fwd']:.3f}, {ms['flash_fwd'] / sdpa_fwd:.2f}x), backward "
        f"(dq, dk, dv) {sdpa_bwd:.3f} ms; K6 + K7 {ms['flash_dq'] + ms['flash_dkv']:.3f} ms")
    return results


def check_flash_small():
    """K5, K6 and K7 against their plain versions over the options the main
    path does not take, at small shapes: f32 and bf16 operands, head dims
    16, 64, 80 and 128 (80 is zero-padded to 128 in the kernels; bf16 at 64,
    80 and 128 takes each kernel's wgmma route, 16 and f32 the mma.sync
    bodies), causal or not, Tq = Tk (K5 too) and Tq != Tk (dq_block/
    dkv_block only), lengths that are odd multiples of 64 (a 128-row block
    half past the end), with and without a key mask (one batch x head
    padded whole: its outputs exactly 0) and dropout at offsets near
    2^31; K5 in bf16 also with a negative scale. The routes are logged for
    each type and head dim."""
    from deeplearning4j_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(21)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    routes = {}
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        for d in (16, 64, 80, 128):
            route = design(dtype, d, "flash_attn_dq.cu")
            fwd_route = design(dtype, d, "flash_attn_fwd.cu")
            n_d, worst_d = n, 0.0
            for causal in (True, False):
                for tq, tk in ((256, 256), (192, 192), (320, 320), (128, 256), (256, 128),
                               (192, 320), (320, 192)):
                    for masked in (False, True):
                        for rate in (0.0, 0.2):
                            bh = 3
                            q, do = (torch.randn((bh, tq, d), generator=g).to(dev, dtype)
                                     for _ in range(2))
                            k, v = (torch.randn((bh, tk, d), generator=g).to(dev, dtype)
                                    for _ in range(2))
                            km = None
                            if masked:
                                km = torch.ones((bh, tk), device=dev)
                                km[1] = 0.0
                                km[0, 30:90] = 0.0
                            sd = fa.seed3(-99, 2 ** 31 - 70, 5) if rate else None
                            outs, refs = [], []
                            if tq == tk:
                                o, lse = fa.flash_fwd(q, k, v, km, causal, 0.3, rate, sd)
                                torch.cuda.synchronize()
                                o_p, lse_p = fa.flash_fwd_plain(q, k, v, km, causal, 0.3, rate, sd)
                                outs, refs = [o, lse / 10], [o_p, lse_p / 10]
                                delta = fa.rowwise_delta(do, o_p)
                            else:
                                lse_p = torch.randn((bh, tq), generator=g).to(dev) + 5.0
                                delta = torch.randn((bh, tq), generator=g).to(dev)
                            args = (q, k, v, km, do, delta, lse_p, causal, 0.3, sd, rate)
                            outs += [fa.dq_block(*args), *fa.dkv_block(*args)]
                            torch.cuda.synchronize()
                            refs += [fa.flash_dq_plain(*args), *fa.flash_dkv_plain(*args)]
                            e = max(((a.float() - b.float()).abs().max()
                                     / b.float().abs().max().clamp(min=1e-30)).item()
                                    for a, b in zip(outs, refs))
                            if masked and any(torch.count_nonzero(x[1]).item()
                                              for x in outs if x.dim() == 3):
                                raise AssertionError(f"small flash case d={d} {dtype} Tq={tq} "
                                                     f"Tk={tk}: a fully padded batch x head is "
                                                     f"not exactly 0")
                            lim = FLASH_RTOL if dtype == torch.bfloat16 else FLASH_F32_RTOL
                            if not e <= lim:
                                raise AssertionError(
                                    f"small flash case {dtype} d={d} causal={causal} Tq={tq} "
                                    f"Tk={tk} mask={masked} rate={rate} (K5: {fwd_route}; "
                                    f"K6/K7: {route}): rel err {e} > {lim}")
                            worst[dtype] = max(worst[dtype], e)
                            worst_d = max(worst_d, e)
                            n += 1
                            if tq == tk:
                                routes[f"K5 {fwd_route}"] = routes.get(f"K5 {fwd_route}", 0) + 1
                            routes[f"K6/K7 {route}"] = routes.get(f"K6/K7 {route}", 0) + 1
            if dtype == torch.bfloat16:  # K5 with a negative scale (q . k^T negated)
                for causal in (True, False):
                    q, k, v = (torch.randn((3, 192, d), generator=g).to(dev, dtype)
                               for _ in range(3))
                    o, lse = fa.flash_fwd(q, k, v, None, causal, -0.3)
                    torch.cuda.synchronize()
                    o_p, lse_p = fa.flash_fwd_plain(q, k, v, None, causal, -0.3)
                    e = max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                            for a, b in ((o, o_p), (lse / 10, lse_p / 10)))
                    if not e <= FLASH_RTOL:
                        raise AssertionError(f"K5 with scale -0.3, d={d} causal={causal} "
                                             f"({fwd_route}): rel err {e} > {FLASH_RTOL}")
                    worst[dtype] = max(worst[dtype], e)
                    worst_d = max(worst_d, e)
                    n += 1
                    routes[f"K5 {fwd_route}"] = routes.get(f"K5 {fwd_route}", 0) + 1
            log(f"  small flash cases {str(dtype)[6:]} d={d}: K5 route {fwd_route}, K6/K7 route "
                f"{route}; {n - n_d} cases, worst rel err {worst_d:.2e}")
    log(f"K5/K6/K7 small shapes ({n} cases: f32 and bf16, d 16/64/80/128, causal or not, "
        f"Tq != Tk, odd multiples of 64, key masks, dropout; cases per route {routes}): worst "
        f"rel err bf16 {worst[torch.bfloat16]:.2e}, f32 {worst[torch.float32]:.2e}")


def design(dtype, d, source):
    """The route the flash kernel of ``source`` takes for operands of this
    type and head width: the static choice of its C entry, named by its
    export ``dl4j_flash_fwd_wgmma`` (K5) or ``dl4j_flash_bwd_wgmma`` (K6,
    K7)."""
    from deeplearning4j_torch.ops import cuda_build
    from deeplearning4j_torch.ops import flash_attention as fa

    entry = "dl4j_flash_fwd_wgmma" if source == fa.FWD_SOURCE else "dl4j_flash_bwd_wgmma"
    lib = cuda_build.library(source, entry, fa._ROUTE_ARGTYPES)
    return ("wgmma + TMA, warp-specialised, 128-row blocks"
            if getattr(lib, entry)(int(dtype == torch.bfloat16), d)
            else "mma.sync / CUDA-core, 64-row blocks")


def check_keep_bits(fa, seed):
    """K5's dropout decisions bit for bit against ``dropout_keep_mask`` on
    a 64 x 64 slice of every batch x head at the dropout case's offsets:
    with q = k = 0 every probability is 1/64 and v the identity, so
    o[i, j] is nonzero exactly where cell (i, j) is kept."""
    bh, n = LM_B * LM_HEADS, 64
    dev = torch.device("cuda")
    z = torch.zeros((bh, n, n), device=dev, dtype=torch.bfloat16)
    eye = torch.eye(n, device=dev, dtype=torch.bfloat16).expand(bh, n, n).contiguous()
    s, q_off, k_off = seed
    sl = fa.seed3(s, q_off + 4096, k_off + 1024)
    o, _ = fa.flash_fwd(z, z, eye, None, False, 1.0, 0.1, sl)
    want = fa.dropout_keep_mask(bh, n, n, s, 0.1, sl[1], sl[2], device=dev)
    if not torch.equal(o != 0, want):
        raise AssertionError("K5's dropout keep bits differ from dropout_keep_mask")
    log(f"K5 dropout keep bits equal dropout_keep_mask on {bh} x {n} x {n} cells "
        f"({100 * want.float().mean().item():.1f}% kept at rate 0.1)")


def lm_conf(vocab=LM_VOCAB, embed=LM_E, heads=LM_HEADS, blocks=LM_BLOCKS, experts=0,
            compute="bfloat16"):
    """The TransformerLM of bench.py:1730 (or a cut of it), bf16 compute;
    with ``experts`` its MoE variant (top MOE_TOP_K, capacity factor
    MOE_CF, aux loss weight MOE_AUX)."""
    from deeplearning4j_torch.models import TransformerLM

    conf = TransformerLM(vocab_size=vocab, embed_dim=embed, num_heads=heads,
                         num_blocks=blocks, seed=1, num_experts=experts, top_k=MOE_TOP_K,
                         capacity_factor=MOE_CF, aux_loss_weight=MOE_AUX).conf()
    conf.global_conf.compute_dtype = compute
    return conf


def periodic_tokens(rng, b, t, vocab, period=23):
    """Next-token data cut from a fixed cycle of ``period`` tokens at random
    offsets: float ids [b, t] (the JAX bench's layout) and one-hot labels."""
    cycle = rng.integers(0, vocab, period)
    ids = cycle[(rng.integers(0, period, b)[:, None] + np.arange(t + 1)[None, :]) % period]
    labels = np.zeros((b, t, vocab), np.float32)
    np.put_along_axis(labels, ids[:, 1:, None], 1.0, axis=2)
    return ids[:, :-1].astype(np.float32), labels


def transformer_lm():
    """The TransformerLM main path at full width: ``output`` on one batch
    (8 K5 launches), then ``fit`` steps (each 8 K5, 8 K6 and 8 K7
    launches). Counts are reset just before and read just after each; each
    step's own launches are checked too."""
    from deeplearning4j_torch import DataSet
    from deeplearning4j_torch.nn.graph import ComputationGraph

    net = ComputationGraph(lm_conf()).init()            # device defaults to the card
    n_params = sum(p.numel() for ps in net.params.values() for p in ps.values())
    f, l = periodic_tokens(np.random.default_rng(8), LM_B, LM_T, LM_VOCAB)
    ds = DataSet(f, l)
    reset_counts()
    probs = net.output(f)
    torch.cuda.synchronize()
    out_launches = read_counts()
    want = {n: 0 for n in out_launches}
    want["flash_fwd"] = LM_BLOCKS
    if out_launches != want:
        raise AssertionError(f"output launched {out_launches}, expected {want}")
    # the softmax runs in bf16 and is cast to f32 after (the JAX package's
    # policy), so a row sums to 1 within bf16's rounding (2^-8 relative)
    sums = probs.sum(-1)
    if tuple(probs.shape) != (LM_B, LM_T, LM_VOCAB) or not torch.isfinite(probs).all() \
            or (sums - 1).abs().max().item() > 1e-2:
        raise AssertionError(f"output: shape {tuple(probs.shape)}, or rows that are not "
                             f"finite probabilities summing to 1")
    del probs, sums
    t0 = time.perf_counter()
    net.output(f)
    torch.cuda.synchronize()
    output_ms = (time.perf_counter() - t0) * 1e3
    log(f"TransformerLM ({n_params / 1e6:.1f}M parameters) output b={LM_B} T={LM_T}: "
        f"launches {out_launches}; a second call {output_ms:.1f} ms (the batch's H2D copy "
        f"included)")

    per_step = {n: 0 for n in out_launches}
    per_step.update(flash_fwd=LM_BLOCKS, flash_dq=LM_BLOCKS, flash_dkv=LM_BLOCKS)
    losses = []
    reset_counts()
    for _ in range(LM_STEPS):
        before = read_counts()
        net.fit(ds)
        losses.append(net.score())
        got = {n: c - before[n] for n, c in read_counts().items()}
        if got != per_step:
            raise AssertionError(f"a training step launched {got}, expected {per_step}")
    launches = read_counts()
    log(f"TransformerLM training: {LM_STEPS} Adam steps of b={LM_B} T={LM_T}, launches "
        f"{launches}; loss per step " + " ".join(f"{x:.1f}" for x in losses))
    if not np.isfinite(losses).all():
        raise AssertionError(f"TransformerLM loss is not finite: {losses}")
    drop = 1.0 - losses[-1] / losses[0]
    log(f"TransformerLM loss fell {100 * drop:.2f}% from the first step to the last")
    if not drop >= LM_LOSS_DROP:
        raise AssertionError(f"the TransformerLM loss fell by {drop:.4f}, less than "
                             f"{LM_LOSS_DROP}")

    # one fit(ds) a step, through the pipeline (the default) and
    # synchronously, in alternating turns: a single batch has no earlier
    # step to hide its copy behind
    turns = {"pipeline": [], "sync": []}
    for turn in range(LM_TIMED_STEPS):
        for mode in (("pipeline", "sync") if turn % 2 == 0 else ("sync", "pipeline")):
            with prefetch_workers(2 if mode == "pipeline" else 0):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                net.fit(ds)
                net.score()                           # the value: a sync
                turns[mode].append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.median(turns["pipeline"]))
    log(f"smoke number, not a benchmark: a TransformerLM step {step_ms:.1f} ms through the "
        f"pipeline, {float(np.median(turns['sync'])):.1f} ms synchronous (medians of "
        f"{LM_TIMED_STEPS} alternating turns of one fit(DataSet): "
        f"{' '.join(f'{x:.1f}' for x in turns['pipeline'])} and "
        f"{' '.join(f'{x:.1f}' for x in turns['sync'])}), {LM_B * LM_T / step_ms * 1e3:.0f} "
        f"tokens/s; peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
    prof = profile_call("one TransformerLM step", lambda: net.fit(ds))
    return {"launches": launches, "output_launches": out_launches, "output_ms": output_ms,
            "losses": losses, "step_ms": step_ms, "profile": prof, "net": net}


def check_lm_reference(experts=0, compute="bfloat16"):
    """compute_gradient_and_score of a cut TransformerLM on the card against
    the same network on the CPU, both on the flash route (T=4096): the card
    through K5-K7, the CPU through their plain versions. With ``experts``
    the MoE variant (capacity dispatch in the training forward)."""
    from deeplearning4j_torch import DataSet
    from deeplearning4j_torch.nn.graph import ComputationGraph

    cut = {"vocab": 256, "embed": 128, "heads": 2, "blocks": 2, "experts": experts,
           "compute": compute}
    net = ComputationGraph(lm_conf(**cut)).init()
    cpu = ComputationGraph(lm_conf(**cut)).init(
        params={n: {k: t.cpu() for k, t in p.items()} for n, p in net.params.items()},
        device="cpu")
    f, l = periodic_tokens(np.random.default_rng(9), 1, 4096, 256)
    ds = DataSet(f, l)
    before = read_counts()
    g_card, s_card = net.compute_gradient_and_score(ds)
    got = {n: c - before[n] for n, c in read_counts().items()}
    if (got["flash_fwd"], got["flash_dq"], got["flash_dkv"]) != (2, 2, 2):
        raise AssertionError(f"the reference run did not take the flash kernels: {got}")
    g_cpu, s_cpu = cpu.compute_gradient_and_score(ds)
    s_err = abs(s_card - s_cpu) / abs(s_cpu)
    g_err = {f"{n}/{k}": ((g_card[n][k].cpu() - g).abs().max() / g.abs().max()).item()
             for n, gs in g_cpu.items() for k, g in gs.items()}
    key = max(g_err, key=g_err.get)
    p_err = (net.output(f).cpu() - cpu.output(f)).abs().max().item()
    log(f"card vs CPU reference, TransformerLM E=128 2 blocks T=4096"
        f"{f' {experts} experts' if experts else ''} {compute}: score {s_card:.3f} vs "
        f"{s_cpu:.3f} (rel {s_err:.2e}); worst gradient {key} rel {g_err[key]:.2e}; "
        f"probabilities max_abs_err {p_err:.2e}")
    if not s_err <= LM_REF_SCORE_RTOL:
        raise AssertionError(f"card and CPU TransformerLM scores disagree: {s_err}")
    if not g_err[key] <= LM_REF_GRAD_RTOL:
        raise AssertionError(f"card and CPU TransformerLM gradients disagree: {key} "
                             f"{g_err[key]}")
    return {"score_rel": s_err, "grad_rel": g_err[key], "prob_abs": p_err}


@contextlib.contextmanager
def prefetch_workers(n):
    """``DL4J_TPU_PREFETCH_WORKERS`` set to ``n`` (0: the synchronous fit
    path), restored after."""
    old = os.environ.get("DL4J_TPU_PREFETCH_WORKERS")
    os.environ["DL4J_TPU_PREFETCH_WORKERS"] = str(n)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("DL4J_TPU_PREFETCH_WORKERS", None)
        else:
            os.environ["DL4J_TPU_PREFETCH_WORKERS"] = old


def record_losses(net):
    """A list that collects each training step's loss of ``net`` (as
    tensors, so recording adds no sync)."""
    losses, fit_batch = [], net._fit_batch

    def recorded(ds):
        fit_batch(ds)
        losses.append(net.score_)

    net._fit_batch = recorded
    return losses


def trace_call(label, fn, step_mark=None):
    """One call of ``fn`` under torch.profiler, its Chrome trace written to
    ``build/traces/`` and read back: the device events with their streams,
    the compute stream (the one with the most kernel time), each H2D copy
    (stream, bytes, pinned or pageable), the share of its duration that
    kernels on other streams overlap, and whether it began once the steps
    had (``under_steps``: after the first compute-stream kernel, or, with
    ``step_mark``, after the first kernel launched inside the first
    ``record_function(step_mark)`` range). None when the profiler recorded
    no device events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = Path("build") / "traces"
    out.mkdir(parents=True, exist_ok=True)
    path = out / (label.replace(" ", "_") + ".json")
    prof.export_chrome_trace(str(path))
    return trace_summary(label, json.loads(path.read_text())["traceEvents"], wall_ms,
                         step_mark)


def trace_summary(label, events, wall_ms, step_mark=None):
    """The device side of a Chrome trace (see :func:`trace_call`)."""
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
           and "dur" in e]
    if not dev:
        log(f"trace of {label}: the profiler recorded no device events")
        return None
    kernel_us = {}
    for e in dev:
        if e["cat"] == "kernel":
            st = e.get("args", {}).get("stream")
            kernel_us[st] = kernel_us.get(st, 0.0) + e["dur"]
    compute = max(kernel_us, key=kernel_us.get)
    steps_from = min(e["ts"] for e in dev
                     if e["cat"] == "kernel" and e.get("args", {}).get("stream") == compute)
    marks = sorted((e for e in events if step_mark and e.get("cat") == "user_annotation"
                    and e.get("name") == step_mark and "dur" in e), key=lambda e: e["ts"])
    if marks:
        lo, hi = marks[0]["ts"], marks[0]["ts"] + marks[0]["dur"]
        launched = {e["args"]["correlation"] for e in events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and lo <= e["ts"] <= hi and "correlation" in e.get("args", {})}
        step = [e["ts"] for e in dev if e["cat"] == "kernel"
                and e.get("args", {}).get("stream") == compute
                and e.get("args", {}).get("correlation") in launched]
        steps_from = min(step, default=steps_from)
    marked = bool(marks and step)
    copies = []
    for e in dev:
        if e["cat"] != "gpu_memcpy" or "HtoD" not in e["name"]:
            continue
        st = e.get("args", {}).get("stream")
        lo, hi = e["ts"], e["ts"] + e["dur"]
        spans = sorted((max(lo, k["ts"]), min(hi, k["ts"] + k["dur"])) for k in dev
                       if k["cat"] == "kernel" and k.get("args", {}).get("stream") != st
                       and k["ts"] < hi and k["ts"] + k["dur"] > lo)
        covered, end = 0.0, lo
        for a, b in spans:
            a = max(a, end)
            if b > a:
                covered, end = covered + b - a, b
        copies.append({"name": e["name"], "stream": st, "bytes": e.get("args", {}).get("bytes"),
                       "ms": e["dur"] / 1e3, "overlap": covered / e["dur"] if e["dur"] else 0.0,
                       "under_steps": lo > steps_from})
    big = [c for c in copies if (c["bytes"] or 0) >= BATCH_COPY_BYTES
           or (c["bytes"] is None and c["ms"] >= 1.0)]
    busy_ms = sum(kernel_us.values()) / 1e3
    calls = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                and e.get("name", "").startswith("cudaMemcpy"))
    by_name = {}
    for e in dev:
        n, us = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, us + e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    log(f"trace of {label}: wall {wall_ms:.1f} ms, kernel time {busy_ms:.1f} ms, compute "
        f"stream {compute}, {len(copies)} H2D copies ({len(big)} of a batch's size) beside "
        f"{calls} cudaMemcpy* runtime calls; device time by name (launches):")
    for name, (n, us) in top:
        log(f"  {us / 1e3:9.3f} ms ({n:4d})  {name[:100]}")
    for c in copies:
        log(f"  {c['ms']:8.3f} ms  {c['name']} stream {c['stream']} bytes {c['bytes']} "
            f"overlapped {100 * c['overlap']:.1f}% by kernels on other streams")
    return {"wall_ms": wall_ms, "kernel_ms": busy_ms, "compute_stream": compute,
            "steps_marked": marked, "copies": copies, "batch_copies": big, "memcpy_calls": calls,
            "top_ms": {name[:100]: us / 1e3 for name, (_, us) in top}}


def lm_pipeline():
    """The TransformerLM's fit through the input pipeline, three ways: the
    synchronous path (``DL4J_TPU_PREFETCH_WORKERS=0``), prefetch with
    put-ahead (the default), and ``CacheMode.DEVICE``, each as one ``fit``
    of an iterator of LM_PIPE_BATCHES distinct batches cycled to
    LM_PIPE_STEPS steps, so that batch k+1's copy can run under step k.
    Fresh nets from one seed: their losses must agree. Then the three are
    timed in alternating turns, and two calls traced: a cached step (no
    H2D copy of a batch) and a put-ahead fit of the distinct batches (each
    copy pinned, on a stream other than the compute stream)."""
    from deeplearning4j_torch import CacheMode, DataSet, ListDataSetIterator
    from deeplearning4j_torch.nn.graph import ComputationGraph

    rng = np.random.default_rng(10)
    batches = [DataSet(*periodic_tokens(rng, LM_B, LM_T, LM_VOCAB))
               for _ in range(LM_PIPE_BATCHES)]
    cycle = [batches[i % LM_PIPE_BATCHES] for i in range(LM_PIPE_STEPS)]
    modes = {"sync": (0, CacheMode.NONE), "put_ahead": (2, CacheMode.NONE),
             "cached": (2, CacheMode.DEVICE)}
    per_fit = {n: 0 for n in counters()}
    per_fit.update(flash_fwd=LM_BLOCKS * LM_PIPE_STEPS, flash_dq=LM_BLOCKS * LM_PIPE_STEPS,
                   flash_dkv=LM_BLOCKS * LM_PIPE_STEPS)
    nets, losses = {}, {}
    for mode, (workers, cache) in modes.items():
        conf = lm_conf()
        conf.global_conf.cache_mode = cache
        net = ComputationGraph(conf).init()
        rec = record_losses(net)
        with prefetch_workers(workers):
            before = read_counts()
            net.fit(ListDataSetIterator(cycle))
            got = {n: c - before[n] for n, c in read_counts().items()}
        del net._fit_batch                         # stop recording
        if got != per_fit:
            raise AssertionError(f"a {mode} fit of {LM_PIPE_STEPS} steps launched {got}, "
                                 f"expected {per_fit}")
        losses[mode] = [float(x) for x in rec]
        nets[mode] = net
    log("TransformerLM through the pipeline, losses of fresh nets from one seed over "
        f"{LM_PIPE_STEPS} steps: " + "; ".join(
            f"{m} " + " ".join(f"{x:.3f}" for x in ls) for m, ls in losses.items()))
    bit_equal = {}
    for mode in ("put_ahead", "cached"):
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses[mode], losses["sync"]))
        bit_equal[mode] = losses[mode] == losses["sync"]
        log(f"  {mode} vs sync: max relative difference {rel:.3e}, bit-equal "
            f"{bit_equal[mode]}")
        if not np.isfinite(losses[mode]).all() or not rel <= PIPE_LOSS_RTOL:
            raise AssertionError(f"the {mode} losses disagree with the synchronous path's: "
                                 f"{rel}")

    times = {m: [] for m in modes}
    order = list(modes)
    for turn in range(LM_PIPE_TURNS):
        for mode in (order if turn % 2 == 0 else order[::-1]):
            with prefetch_workers(modes[mode][0]):
                before = read_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                nets[mode].fit(ListDataSetIterator(cycle))
                nets[mode].score()                       # the value: a sync
                times[mode].append((time.perf_counter() - t0) * 1e3 / LM_PIPE_STEPS)
                got = {n: c - before[n] for n, c in read_counts().items()}
            if got != per_fit:
                raise AssertionError(f"a timed {mode} fit launched {got}, expected {per_fit}")
    med = {m: float(np.median(v)) for m, v in times.items()}
    for m in modes:
        log(f"smoke number, not a benchmark: a TransformerLM step {m} {med[m]:.1f} ms (median "
            f"of {LM_PIPE_TURNS} alternating turns of one {LM_PIPE_STEPS}-step fit: "
            f"{' '.join(f'{x:.1f}' for x in times[m])}), {LM_B * LM_T / med[m] * 1e3:.0f} "
            f"tokens/s")

    cached = trace_call("one cached TransformerLM step", lambda: nets["cached"].fit(batches[0]))
    if cached is not None and cached["batch_copies"]:
        raise AssertionError(f"a cached step copied a batch to the card: "
                             f"{cached['batch_copies']}")
    net, fit_batch = nets["put_ahead"], nets["put_ahead"]._fit_batch

    def marked(ds):
        with torch.profiler.record_function("lm_pipeline_step"):
            fit_batch(ds)

    net._fit_batch = marked
    with prefetch_workers(2):
        ahead = trace_call("a put-ahead TransformerLM fit of 3 batches",
                           lambda: net.fit(ListDataSetIterator(batches)),
                           step_mark="lm_pipeline_step")
    net._fit_batch = fit_batch
    if ahead is not None:
        # the profiler records only some of the worker threads' copies (in
        # one run 3 of the 6 cudaMemcpyAsync calls it logged on the two
        # workers had a device record, the first two missing): every one
        # it records must be pinned and off the compute stream, and those
        # made once the first step had begun mostly overlapped by their
        # kernels. The first batch's copy comes before that: the step waits
        # for it, and only the fit's set-up kernels can run beside it. The
        # copies of batches 1 and 2 are held until steps 0 and 1 begin
        # their backward (prefetch.backward_begins): a copy started where
        # a worker happened to finish staging could land in the forward or
        # the update, launched one small kernel at a time, and read as
        # little as 3% (ROADMAP C 7).
        got = ahead["batch_copies"]
        bad = [c for c in got if c["stream"] == ahead["compute_stream"]
               or "Pinned" not in c["name"]
               or (c["under_steps"] and c["overlap"] < 0.5)]
        if not got or bad:
            raise AssertionError(f"the put-ahead copies are not pinned, off the compute "
                                 f"stream {ahead['compute_stream']} and overlapped: {got}")
        log(f"  the profiler recorded {len(got)} of the {LM_PIPE_BATCHES} labels copies, "
            f"{sum(c['under_steps'] for c in got)} of them made under the steps (from "
            f"{'the first marked step' if ahead['steps_marked'] else 'the first kernel'})")
    return {"losses": losses, "bit_equal": bit_equal, "times_ms": times, "median_ms": med,
            "cached_trace": cached, "put_ahead_trace": ahead}


def check_lstm_pair_f32():
    """The f32-weight char-RNN pair at b=32, where K3 has no grid: the
    route runs it per layer (K1, and K1 with the reserve and K2 in
    training) through ``output``, ``rnn_time_step`` and ``fit``, against
    the same network on the CPU (plain loops)."""
    from deeplearning4j_torch import DataSet, MultiLayerNetwork, NeuralNetConfiguration, Adam
    from deeplearning4j_torch.nn.conf.layers import GravesLSTM, RnnOutputLayer

    conf = (NeuralNetConfiguration.builder().seed(1).updater(Adam(learning_rate=1e-3))
            .activation("tanh").list()
            .layer(GravesLSTM(n_in=VOCAB, n_out=H)).layer(GravesLSTM(n_in=H, n_out=H))
            .layer(RnnOutputLayer(n_in=H, n_out=VOCAB, activation="softmax", loss="mcxent"))
            .build())
    net = build_net(conf, seed=5)
    cpu = MultiLayerNetwork(conf).init(
        params={k: {n: t.cpu() for n, t in p.items()} for k, p in net.params.items()},
        device="cpu")
    f, l = periodic_text(np.random.default_rng(11), B, 50)
    x = net._to_device(f)
    if net._lstm_pair_fusable(0, x, None, False) or net._lstm_pair_fusable(0, x, None, True):
        raise AssertionError("the f32 pair at b=32 was admitted to K3/K4")

    def counted(fn, want):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        got = {n: c for n, c in read_counts().items() if c}
        if got != want:
            raise AssertionError(f"the f32 pair launched {got}, expected {want}")
        return out

    ref = cpu.output(f)
    out = counted(lambda: net.output(f), {"lstm_fwd": 2}).cpu()
    net.rnn_clear_previous_state()
    steps = counted(lambda: [net.rnn_time_step(f[:, a:b]) for a, b in ((0, 20), (20, 50))],
                    {"lstm_fwd": 4})
    step_err = (torch.cat([s.cpu() for s in steps], 1) - ref).abs().max().item()
    out_err = (out - ref).abs().max().item()
    ds = DataSet(f, l)
    g_card, s_card = counted(lambda: net.compute_gradient_and_score(ds),
                             {"lstm_fwd_train": 2, "lstm_bwd": 2})
    g_cpu, s_cpu = cpu.compute_gradient_and_score(ds)
    g_err = max(((g_card[i][k].cpu() - g).abs().max() / g.abs().max()).item()
                for i, gs in g_cpu.items() for k, g in gs.items())
    counted(lambda: net.fit(ds), {"lstm_fwd_train": 2, "lstm_bwd": 2})
    cpu.fit(ds)
    fit_err = abs(net.score() - cpu.score()) / abs(cpu.score())
    s_err = abs(s_card - s_cpu) / abs(s_cpu)
    log(f"f32 2 x GravesLSTM({H}) at b={B} T=50, per layer on the card vs the CPU: output "
        f"max_abs_err {out_err:.2e}, rnn_time_step {step_err:.2e}, score rel {s_err:.2e}, "
        f"gradients rel {g_err:.2e}, fit score rel {fit_err:.2e}")
    if not max(out_err, step_err) <= F32_PAIR_ATOL:
        raise AssertionError(f"the f32 pair disagrees with the CPU: {out_err}, {step_err}")
    if not max(s_err, fit_err) <= F32_PAIR_SCORE_RTOL or not g_err <= F32_PAIR_GRAD_RTOL:
        raise AssertionError(f"the f32 pair's training disagrees with the CPU: score "
                             f"{s_err}, fit {fit_err}, gradients {g_err}")
    return {"output_abs": out_err, "step_abs": step_err, "score_rel": s_err,
            "grad_rel": g_err, "fit_score_rel": fit_err}


def check_flash_f32_wide(device="cuda"):
    """f32 attention with d=256 at T=4096, past what K5-K7 take in f32:
    ``mha`` runs the dense body (no flash launch), forward and backward,
    held against the flash kernels' plain versions on the card."""
    from deeplearning4j_torch.nn.layers import attention
    from deeplearning4j_torch.ops import flash_attention as fa

    b, t, h, d = 1, 4096, 2, 256
    g = torch.Generator(device=device).manual_seed(12)
    q, k, v = (torch.randn((b, t, h, d), generator=g, device=device, requires_grad=True)
               for _ in range(3))
    do = torch.randn((b, t, h, d), generator=g, device=device)
    reset_counts()
    o = attention.mha(q, k, v, True, torch.float32)
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    launched = {n: c for n, c in read_counts().items() if c}
    if launched:
        raise AssertionError(f"f32 d=256 attention launched a kernel: {launched}")

    def bh(x):
        return x.detach().permute(0, 2, 1, 3).reshape(b * h, t, d).contiguous()

    scale = 1.0 / d ** 0.5
    with torch.no_grad():
        o_ref, lse = fa.flash_fwd_plain(bh(q), bh(k), bh(v), None, True, scale)
        delta = fa.rowwise_delta(bh(do), o_ref)
        dq_ref = fa.flash_dq_plain(bh(q), bh(k), bh(v), None, bh(do), delta, lse, True, scale)
        dk_ref, dv_ref = fa.flash_dkv_plain(bh(q), bh(k), bh(v), None, bh(do), delta, lse,
                                            True, scale)
    errs = {n: ((bh(a) - r).abs().max() / r.abs().max()).item()
            for n, a, r in (("o", o, o_ref), ("dq", dq, dq_ref), ("dk", dk, dk_ref),
                            ("dv", dv, dv_ref))}
    log(f"f32 attention b={b} h={h} T={t} d={d} causal on the dense route (no flash launch) "
        f"vs the flash plain versions: " + ", ".join(f"{n} {e:.2e}" for n, e in errs.items()))
    if not max(errs.values()) <= FLASH_F32_RTOL:
        raise AssertionError(f"f32 d=256 attention disagrees with the plain version: {errs}")
    return errs


def zoo_data(rng, b, img, classes):
    """N(0, 1) NCHW features and one-hot labels, as bench.py's
    _cnn_throughput makes them."""
    return (rng.normal(size=(b,) + tuple(img)).astype(np.float32),
            np.eye(classes, dtype=np.float32)[rng.integers(0, classes, b)])


def check_probabilities(label, probs, shape, atol):
    sums = probs.float().sum(-1)
    err = (sums - 1).abs().max().item()
    if tuple(probs.shape) != shape or not torch.isfinite(probs).all() or err > atol:
        raise AssertionError(f"{label} output: shape {tuple(probs.shape)}, or rows that are "
                             f"not finite probabilities summing to 1 (worst {err:.2e})")
    return err


def kernel_group(chain):
    """The group of a kernel, from the names of the op that launched it and
    of that op's callers (a forward op, or the autograd node of a backward
    one)."""
    names = " ".join(chain).lower()
    for key, group in (("dl4j::updater", "updater"), ("convolution", "cuDNN conv"),
                       ("pool", "pooling"), ("batch_norm", "BN"), ("batchnorm", "BN")):
        if key in names:
            return group
    return "other elementwise"


def zoo_steps(label, net, f, l, warm, steps, sum_atol, group=None):
    """A zoo model's main path on one batch (``f``, ``l``): ``fit`` of
    ``warm`` warm-up steps, then of ``steps`` timed ones (each fit an
    iterator of DataSet copies, so one pipeline a fit and, under
    CacheMode.DEVICE, one H2D copy of the batch in all), finite losses,
    peak memory; ``output`` on the batch (finite rows summing to 1 within
    ``sum_atol``); with ``group``, one profiled step grouped by it (no
    NCHW/NHWC transposition kernel). No kernel of K1-K7 lies on the path:
    the counts, set to 0 before the first fit, must read 0 after."""
    from deeplearning4j_torch import DataSet, ListDataSetIterator

    ds = DataSet(f, l)
    b, classes = l.shape
    losses = record_losses(net)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    net.fit(ListDataSetIterator([ds] * warm))
    net.score()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    net.fit(ListDataSetIterator([ds] * steps))
    net.score()                                           # the value: a sync
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    peak = torch.cuda.max_memory_allocated()
    del net._fit_batch                                    # stop recording
    losses = [float(x) for x in losses]
    if len(losses) != warm + steps or not np.isfinite(losses).all():
        raise AssertionError(f"{label} losses: {losses}")
    ips = b / step_ms * 1e3
    log(f"{label} ({net.num_params()} parameters) training b={b} {'x'.join(map(str, f.shape[1:]))} "
        f"{net.gc.compute_dtype} {type(net.gc.updater).__name__}: {warm} warm-up steps "
        f"{warm_s:.1f} s, then smoke number, not a benchmark: {step_ms:.2f} ms a step, "
        f"{ips:.1f} images/s over {steps} steps in one fit; peak memory "
        f"{peak / 2 ** 30:.2f} GiB; loss per step " + " ".join(f"{x:.3f}" for x in losses))
    probs = net.output(f)
    sum_err = check_probabilities(label, probs, (b, classes), sum_atol)
    del probs
    log(f"{label} output b={b}: finite, rows sum to 1 within {sum_err:.2e}")
    prof = None
    if group is not None:
        prof = profile_call(f"one {label} step", lambda: net.fit(ds), net.updater,
                            forbid=("nchwtonhwc", "nhwctonchw"), group=group)
    launches = read_counts()
    if any(launches.values()):
        raise AssertionError(f"the {label} path launched LSTM or flash kernels: {launches}")
    return {"batch": b, "num_params": net.num_params(), "step_ms": step_ms,
            "images_per_s": ips, "peak_gib": peak / 2 ** 30, "warmup_s": warm_s,
            "losses": losses, "prob_sum_err": sum_err, "profile": prof}


def resnet50():
    """ResNet50's main path at bench.py:187's shape: ComputationGraph.fit
    under CacheMode.DEVICE, 3 warm-up then 25 timed steps, ``output`` and
    one profiled step (``zoo_steps``); every BN layer's running mean and
    var moved."""
    from deeplearning4j_torch.models import ResNet50
    from deeplearning4j_torch.nn.conf import CacheMode
    from deeplearning4j_torch.nn.graph import ComputationGraph

    conf = ResNet50(num_classes=R50_CLASSES, input_shape=R50_IMG).conf()
    conf.global_conf.compute_dtype = "bfloat16"
    conf.global_conf.cache_mode = CacheMode.DEVICE
    net = ComputationGraph(conf).init()                 # device defaults to the card
    f, l = zoo_data(np.random.default_rng(0), R50_B, R50_IMG, R50_CLASSES)
    before = {n: {k: v.clone() for k, v in s.items()} for n, s in net.states.items() if s}
    res = zoo_steps("ResNet50", net, f, l, R50_WARM, R50_STEPS, PROB_SUM_ATOL, kernel_group)
    still = [f"{n}/{k}" for n, s in net.states.items() if s for k, v in s.items()
             if torch.equal(v, before[n][k])]
    if len(before) != 53 or still:
        raise AssertionError(f"{len(before)} BN layers; running statistics that did not move: "
                             f"{still}")
    log(f"ResNet50: the running statistics of all {len(before)} BN layers moved")
    return res


def lenet():
    """LeNet's main path at bench.py:202's shape: MultiLayerNetwork.fit of
    one b=1024 DataSet under CacheMode.DEVICE with iterations(10), one
    warm-up fit and ten timed; finite losses that fall, and ``output``."""
    from deeplearning4j_torch import DataSet
    from deeplearning4j_torch.models import LeNet
    from deeplearning4j_torch.nn.conf import CacheMode
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork

    conf = LeNet(num_classes=10).conf()
    gc = conf.global_conf
    gc.compute_dtype, gc.cache_mode, gc.iterations = "bfloat16", CacheMode.DEVICE, LENET_ITERS
    net = MultiLayerNetwork(conf).init()
    f, l = zoo_data(np.random.default_rng(0), LENET_B, (1, 28, 28), 10)
    ds = DataSet(f, l)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    net.fit(ds)
    first = net.score()
    t0 = time.perf_counter()
    for _ in range(LENET_FITS):
        net.fit(ds)
    last = net.score()                                    # the value: a sync
    dt = time.perf_counter() - t0
    launches = read_counts()
    if any(launches.values()):
        raise AssertionError(f"the LeNet path launched LSTM or flash kernels: {launches}")
    if not (np.isfinite([first, last]).all() and last < first):
        raise AssertionError(f"LeNet loss {first} -> {last}: not finite or not falling")
    steps = LENET_FITS * LENET_ITERS
    step_ms, ips = dt * 1e3 / steps, LENET_B * steps / dt
    sum_err = check_probabilities("LeNet", net.output(f), (LENET_B, 10), PROB_SUM_ATOL)
    log(f"LeNet ({net.num_params()} parameters) training b={LENET_B} bf16, {LENET_FITS} fits "
        f"of {LENET_ITERS} iterations: smoke number, not a benchmark: {step_ms:.3f} ms a step "
        f"(a fit's pipeline start included), {ips:.0f} images/s; loss {first:.3f} -> "
        f"{last:.3f}; peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
        f"output rows sum to 1 within {sum_err:.2e}")
    return {"step_ms": step_ms, "images_per_s": ips, "loss": [first, last]}


def set_running_statistics(net, f):
    """Every BN layer's running statistics set to its batch statistics on
    ``f``: a training forward with ``decay`` 0, its new state committed."""
    bns = [impl.conf for impl in net.impls.values() if hasattr(impl.conf, "decay")]
    decays = [c.decay for c in bns]
    for c in bns:
        c.decay = 0.0
    new = {}
    with torch.no_grad():
        net._apply_graph([net._to_device(f)], None, True, new_states=new)
    net._commit_states(new)
    for c, d in zip(bns, decays):
        c.decay = d


def r50_reference_errors(dtype, device="cuda", mutate=contextlib.nullcontext):
    """The port's ResNet50 at R50_REF_* in ``dtype`` on ``device``,
    recording its kinks, against the port in f64 on the CPU replaying them,
    from the same weights, each with running statistics of its own from
    the same R50_REF_STATS_B images: {"output": max abs,
    "score": relative, "grads": the worst parameter's max abs error over
    its largest entry, "grads_norm": the whole gradient's norm-wise
    error}. ``mutate()`` is entered around the ``device`` net's calls
    only (a test's deliberately broken layer)."""
    from deeplearning4j_torch import DataSet
    from deeplearning4j_torch.models import ResNet50
    from deeplearning4j_torch.nn.graph import ComputationGraph
    from deeplearning4j_torch.utils.kink_pins import KinkPins

    rng = np.random.default_rng(11)
    f, l = zoo_data(rng, R50_REF_B, R50_REF_IMG, R50_REF_CLASSES)
    f_stats = zoo_data(rng, R50_REF_STATS_B, R50_REF_IMG, R50_REF_CLASSES)[0]

    def conf(dt):
        c = ResNet50(num_classes=R50_REF_CLASSES, input_shape=R50_REF_IMG).conf()
        c.global_conf.compute_dtype = dt
        if dt == "float64":
            c.global_conf.dtype = "float64"
        return c

    net = ComputationGraph(conf(dtype)).init(device=device)
    with torch.no_grad():
        for n, p in net.params.items():
            if n.endswith("-c-bn"):
                p["gamma"].mul_(R50_REF_BRANCH_GAMMA)
    with mutate():
        set_running_statistics(net, f_stats)
    ref = ComputationGraph(conf("float64")).init(
        params={n: {k: t.cpu().double() for k, t in p.items()} for n, p in net.params.items()},
        device="cpu")
    set_running_statistics(ref, f_stats)
    pins = KinkPins()
    pins.attach(net), pins.attach(ref)
    got, want = [], []
    for call in (lambda m: [m.output(f).cpu().double()],
                 lambda m: list(m.compute_gradient_and_score(DataSet(f, l)))[::-1]):
        pins.record = True
        with mutate():
            got += call(net)
        pins.record = False
        want += call(ref)
    grads = [{(n, k): g.cpu().double() for n, gs in gr.items() for k, g in gs.items()}
             for gr in (got[2], want[2])]
    d2 = sum(((grads[0][k] - g) ** 2).sum() for k, g in grads[1].items())
    return {"output": (got[0] - want[0]).abs().max().item(),
            "score": abs(got[1] - want[1]) / abs(want[1]),
            "grads": max(((grads[0][k] - g).abs().max() / g.abs().max()).item()
                         for k, g in grads[1].items()),
            "grads_norm": (d2 / sum((g ** 2).sum() for g in grads[1].values())).sqrt().item()}


def check_cnn_reference():
    """ResNet50 at 3x64x64, 10 classes, b=8: the port on the card in f64,
    f32 (TF32 off) and bf16 against the port on the CPU in f64, on the
    card's kinks, at R50_REF_LIMITS."""
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the f32 card-vs-CPU check needs TF32 off")
    out = {}
    for dtype, lims in R50_REF_LIMITS.items():
        errs = r50_reference_errors(dtype)
        limits = dict(zip(("output", "score", "grads", "grads_norm"), lims))
        log(f"card vs CPU f64, ResNet50 {R50_REF_IMG} b={R50_REF_B} {dtype} on the card's "
            f"kinks: " + ", ".join(f"{q} {errs[q]:.2e} (limit {limits[q]:.0e})" for q in errs))
        bad = [q for q in errs if not errs[q] <= limits[q]]
        if bad:
            raise AssertionError(f"card {dtype} and CPU f64 ResNet50 disagree in {bad}")
        out[dtype] = {"errors": errs, "limits": limits}
    return out


def same_tensors(a, b):
    """Whether two nested trees hold the same keypaths and the same bits."""
    from deeplearning4j_torch.utils.trees import leaves

    fa, fb = dict(leaves(a)), dict(leaves(b))
    return fa.keys() == fb.keys() and all(
        fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]) for k in fa)


def save_and_guess(net, name):
    """``write_model`` (with the updater) into build/generate/, then
    ``ModelGuesser.load_model_guess`` on the card. Returns (the restored
    net, write s, load s, zip bytes)."""
    from deeplearning4j_torch.utils.model_guesser import ModelGuesser
    from deeplearning4j_torch.utils.model_serializer import ModelSerializer

    out = Path("build") / "generate"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    path = ModelSerializer.write_model(net, out / f"{name}.zip")
    t1 = time.perf_counter()
    restored = ModelGuesser.load_model_guess(path)          # device defaults to the card
    t2 = time.perf_counter()
    if type(restored) is not type(net) or restored.device != net.device:
        raise AssertionError(f"{name}: load_model_guess gave a {type(restored).__name__} on "
                             f"{restored.device}")
    if not (same_tensors(net.params, restored.params)
            and same_tensors(net.updater_state, restored.updater_state)
            and restored.iteration_count == net.iteration_count):
        raise AssertionError(f"{name}: the restored parameters, updater state or iteration "
                             f"count differ from the saved net's")
    return restored, t1 - t0, t2 - t1, path.stat().st_size


def kernel_err(out, ref):
    """The worst output's max |kernel - plain| over the larger of 1 and its
    largest |plain| entry (h lies in (-1, 1); c does not)."""
    return max(((a - r).abs().max() / r.abs().max().clamp(min=1.0)).item()
               for a, r in zip(out, ref))


@contextlib.contextmanager
def held_against_plain(n_checked=DECODE_CHECKS):
    """While active, the path's first launch of K1 and of K3 and their
    first ``n_checked`` one-step (T=1) launches are also computed by the
    kernel's plain version on the same inputs (the plain loops count no
    launch), and the last one-step call's arguments of each are kept for
    timing. Yields {"lstm_fwd": {"first", "errors", "step_args"},
    "lstm2_fwd": {...}}: the first launch's error, the one-step launches'
    errors."""
    from deeplearning4j_torch.ops import lstm_cell, lstm_fused

    mods = {"lstm_fwd": (lstm_cell, lstm_cell.lstm_fwd_plain),
            "lstm2_fwd": (lstm_fused, lstm_fused.lstm2_fwd_plain)}
    seen = {n: {"first": None, "errors": [], "step_args": None} for n in mods}
    real = {n: getattr(m, n) for n, (m, _) in mods.items()}

    def tap(name):
        def launched(*args, **kw):
            out = real[name](*args, **kw)
            s = seen[name]
            step = args[0].shape[0] == 1              # xp [T, b, 4H]: one step
            if step:
                s["step_args"] = args
            if s["first"] is None or (step and len(s["errors"]) < n_checked):
                ref = mods[name][1](*args, **kw)
                err = kernel_err(out, ref)
                if s["first"] is None:
                    s["first"] = err
                else:
                    s["errors"].append(err)
                log(f"  {name} T={args[0].shape[0]} b={args[0].shape[1]} vs plain, each "
                    f"output's max_abs_err / max |plain|: " + ", ".join(
                        f"{(a - r).abs().max().item():.2e}/{r.abs().max().item():.2f}"
                        for a, r in zip(out, ref)))
            return out
        return launched

    for n, (m, _) in mods.items():
        setattr(m, n, tap(n))
    try:
        yield seen
    finally:
        for n, (m, _) in mods.items():
            setattr(m, n, real[n])


def decode_rows(seen, launches, model, w_dtype, b, H):
    """K3's and K1's decode-shape rows (T=1, batch b) for the kernel table:
    each kernel held against and timed by CUDA events beside its plain
    version on the arguments of one of the path's steps (K1 on layer 1 of
    a K3 step when the path fused the pair), its bound from the bytes and
    operations of one step, and the path's launches. ``max_abs_err`` is
    the worst of the timed step and the path's checked launches."""
    from deeplearning4j_torch.ops import lstm_cell, lstm_fused

    wb = 2 if w_dtype == torch.bfloat16 else 4
    on_tc = w_dtype == torch.bfloat16
    k3 = seen["lstm2_fwd"]["step_args"]
    k1 = seen["lstm_fwd"]["step_args"]
    if k1 is None and k3 is not None:
        xp, rw1, _, _, _, peep6, h0 = k3
        k1 = (xp, rw1, None if peep6 is None else peep6[0:3].contiguous(), None,
              h0[0].contiguous(), h0[1].contiguous())
    mm = 2 * b * H * 4 * H
    rows = {}
    for name, args, fn, plain, n_mm, layers in (
            ("lstm2_fwd", k3, lstm_fused.lstm2_fwd, lstm_fused.lstm2_fwd_plain, 3, 2),
            ("lstm_fwd", k1, lstm_cell.lstm_fwd, lstm_cell.lstm_fwd_plain, 1, 1)):
        if args is None:
            continue
        with torch.inference_mode():        # the arguments are the path's inference tensors
            err = kernel_err(fn(*args), plain(*args))
            ms = cuda_ms(lambda: fn(*args), 50)
            plain_ms = cuda_ms(lambda: plain(*args), 20)
            # back to back, a launch at T=1 costs the wrapper's host time
            # more than the kernel's: the profiler's device time beside it
            prof = profile_call(f"10 launches of {name} at T=1 b={b} ({model})",
                                lambda: [fn(*args) for _ in range(10)])
        device_ms = (None if prof is None else
                     sum(t for k, t in prof["top_ms"].items() if name in k) / 10)
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"decode {name} ({model}) disagrees with its plain version: "
                                 f"{err}")
        # one step: xp in, the weights, biases and peepholes, each layer's
        # (h, c) in and out, the top layer's h out
        nbytes = (b * 4 * H * 4 + n_mm * H * 4 * H * wb + (layers - 1) * 4 * H * 4
                  + layers * 3 * H * 4 + layers * 4 * b * H * 4 + b * H * 4)
        bms, by = bound(nbytes, n_mm * mm if on_tc else 0,
                        (0 if on_tc else n_mm * mm) + layers * b * H * CELL_OPS)
        errs = seen[name]["errors"]
        rows[name] = {"model": model, "launches": launches[name],
                      "max_abs_err": max([err, *errs]), "ms": ms, "device_ms": device_ms,
                      "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                      "library_ms": None,
                      "shape": {"b": b, "T": 1, "H": H, "w": "bf16" if on_tc else "f32",
                                "peepholes": True}}
        dev = "not measured" if device_ms is None else f"{device_ms * 1e3:.2f} us"
        log(f"decode {name} ({model}) T=1 b={b}: kernel {ms * 1e3:.2f} us (events over 50 "
            f"launches), device {dev} (profiler), plain "
            f"{plain_ms * 1e3:.1f} us, bound {bms * 1e3:.3f} us ({by}; the weights are "
            f"{n_mm * H * 4 * H * wb / 1e6:.2f} MB), {launches[name]} launches on the path; "
            f"max_abs_err {err:.2e} on the timed step, the path's checked launches "
            + (" ".join(f"{e:.2e}" for e in errs) if errs else "none"))
    return rows


def generate_char_rnn(net, model, vocab, H, w_dtype):
    """A char-RNN saved, guessed back and sampling through the card:
    ``generate_tokens`` at b=GEN_B from a CHAR_PROMPT-character prompt for
    CHAR_TOKENS characters, counted (one K3 launch a call, or two K1 where
    ``lstm_fused.fwd_route`` has no grid), its first launches held against
    the plain versions; then the same seed again, timed, for the same
    characters."""
    from deeplearning4j_torch.models import generate_tokens
    from deeplearning4j_torch.ops import lstm_fused

    restored, write_s, load_s, nbytes = save_and_guess(net, model)
    rng = np.random.default_rng(11)
    x = one_hot_ids(rng.integers(0, vocab, (2, 30)), vocab)
    if not torch.equal(net.output(x), restored.output(x)):
        raise AssertionError(f"{model}: the restored net's output differs from the saved one's")
    prompt = rng.integers(0, vocab, (GEN_B, CHAR_PROMPT))
    calls = 1 + CHAR_TOKENS
    fused = lstm_fused.fwd_route(w_dtype, GEN_B, H, device=restored.device)[1] > 0
    want = {n: 0 for n in counters()}
    want.update({"lstm2_fwd": calls} if fused else {"lstm_fwd": 2 * calls})
    reset_counts()
    with held_against_plain() as seen:
        tokens = generate_tokens(restored, prompt, CHAR_TOKENS, seed=GEN_SEED)
    torch.cuda.synchronize()
    launches = read_counts()
    if launches != want:
        raise AssertionError(f"{model}: generate_tokens launched {launches}, expected {want}")
    errs = [e for s in seen.values() for e in s["errors"]]
    if len(errs) < DECODE_CHECKS or not max(errs) <= KERNEL_ATOL:
        raise AssertionError(f"{model}: a one-step launch disagrees with its plain version: "
                             f"{errs} (limit {KERNEL_ATOL})")
    prompt_err = max(s["first"] for s in seen.values() if s["first"] is not None)
    if tokens.shape != (GEN_B, CHAR_TOKENS) or tokens.min() < 0 or tokens.max() >= vocab:
        raise AssertionError(f"{model}: bad tokens {tokens.shape} {tokens.min()} {tokens.max()}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = generate_tokens(restored, prompt, CHAR_TOKENS, seed=GEN_SEED)
    wall_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(tokens, again):
        raise AssertionError(f"{model}: the same seed sampled other characters")
    log(f"{model}: zip {nbytes / 1e6:.1f} MB written in {write_s:.3f} s, guessed back in "
        f"{load_s:.3f} s; generate_tokens b={GEN_B} prompt {CHAR_PROMPT} + {CHAR_TOKENS} "
        f"characters: launches {launches}; {wall_ms:.1f} ms "
        f"({wall_ms / calls:.3f} ms a call, {GEN_B * CHAR_TOKENS / wall_ms * 1e3:.0f} "
        f"characters/s), the same seed the same characters; the prompt's launch vs plain "
        f"{prompt_err:.2e}, the first {len(errs)} one-step launches {max(errs):.2e} "
        f"(limit {KERNEL_ATOL})")
    rows = decode_rows(seen, launches, model, w_dtype, GEN_B, H)
    return {"launches": launches, "write_s": write_s, "load_s": load_s, "zip_bytes": nbytes,
            "generate_ms": wall_ms, "ms_per_call": wall_ms / calls,
            "chars_per_s": GEN_B * CHAR_TOKENS / wall_ms * 1e3, "fused": fused,
            "prompt_launch_err": prompt_err, "step_launch_err": max(errs)}, rows


def serve_zoo_model():
    """An un-built TextGenerationLSTM (ModelSelector) registered with the
    InferenceServer, which builds it on the card; a few concurrent HTTP
    requests, each checked against the served net's ``output``."""
    from deeplearning4j_torch import InferenceServer
    from deeplearning4j_torch.models import ModelSelector

    rng = np.random.default_rng(12)
    xs = [one_hot_ids(rng.integers(0, TEXTGEN_VOCAB, (n, t)), TEXTGEN_VOCAB)
          for n, t in ((1, 40), (3, 40), (4, 40), (2, 40))]
    srv = InferenceServer()
    srv.register("textgen", ModelSelector.select("textgenlstm"), linger_ms=5.0)
    port = srv.start(port=0)
    try:
        model = srv.registry.get("textgen").model
        with ThreadPoolExecutor(max_workers=4) as pool:
            answers = [f.result() for f in [pool.submit(post, port, "textgen", x) for x in xs]]
    finally:
        srv.stop()
    if model.device.type != "cuda":
        raise AssertionError(f"the ZooModel was built on {model.device}")
    err = max(float(np.abs(y - model.output(x).cpu().numpy()).max())
              for x, y in zip(xs, answers))
    log(f"ZooModel TextGenerationLSTM over HTTP: {len(answers)} requests, answers vs output "
        f"max_abs_err={err:.3e}")
    if not err <= SERVE_ATOL:
        raise AssertionError(f"the served ZooModel disagrees with its output: {err}")
    return {"requests": len(answers), "max_abs_err": err}


def generate_char_rnns(trained):
    """The char-RNN generation step: the trained bf16 char-RNN and a
    TextGenerationLSTM at the reference's widths, then the ZooModel over
    HTTP. Returns (the {"generate": ...} numbers, the decode rows by
    kernel)."""
    from deeplearning4j_torch.models import ModelSelector

    out, decode = {}, {"lstm2_fwd": [], "lstm_fwd": []}
    textgen = ModelSelector.select("textgenlstm").init()     # the card
    for model, net, vocab, h, wd in (
            ("char-RNN bf16 H=512", trained, VOCAB, H, torch.bfloat16),
            ("TextGenerationLSTM f32 H=256", textgen, TEXTGEN_VOCAB, TEXTGEN_H,
             torch.float32)):
        out[model], rows = generate_char_rnn(net, model, vocab, h, wd)
        for name, row in rows.items():
            decode[name].append(row)
    out["zoo_http"] = serve_zoo_model()
    return out, decode


def generate_lm(net):
    """The TransformerLM generation phase on the net the smoke trained:
    ``write_model`` with its updater, ``load_model_guess`` on the card
    (``output`` on one batch and the Adam moments bit-equal), then
    ``generate_tokens`` at b=GEN_B from GEN_PROMPT tokens for GEN_TOKENS
    tokens through the 512-slot KV cache (counted: no kernel of the repo
    launches, the cached attention is the dense body), each step's
    probability rows summing to 1; the same seed again, timed per call;
    and the streaming contract: GEN_STREAM_T tokens one at a time against
    ``output`` of the same tokens."""
    from deeplearning4j_torch.models import generate_tokens

    restored, write_s, load_s, nbytes = save_and_guess(net, "transformer_lm")
    f = np.random.default_rng(13).integers(0, LM_VOCAB, (LM_B, LM_T)).astype(np.float32)
    if not torch.equal(net.output(f), restored.output(f)):
        raise AssertionError("the restored TransformerLM's output differs from the trained "
                             "net's")
    log(f"TransformerLM: zip {nbytes / 1e6:.1f} MB written in {write_s:.2f} s, guessed back "
        f"in {load_s:.2f} s; output on b={LM_B} T={LM_T}, parameters and Adam moments "
        f"bit-equal")
    prompt = np.random.default_rng(14).integers(0, LM_VOCAB, (GEN_B, GEN_PROMPT))
    step = restored.rnn_time_step
    record = {"sum_err": [], "ms": []}

    def recorded(*a):
        t0 = time.perf_counter()
        y = step(*a)
        torch.cuda.synchronize()
        record["ms"].append((time.perf_counter() - t0) * 1e3)
        p = y[:, -1] if y.dim() == 3 else y
        record["sum_err"].append((p.float().sum(-1) - 1).abs().max())
        return y

    restored.rnn_time_step = recorded
    try:
        reset_counts()
        tokens = generate_tokens(restored, prompt, GEN_TOKENS, seed=GEN_SEED)
        torch.cuda.synchronize()
        launches = read_counts()
        sum_err = max(e.item() for e in record["sum_err"])
        n_seen = restored._rnn_state["b0-attn"][3]          # the cache's token counter
    finally:
        del restored.rnn_time_step
    # timed without the recording wrapper: prefill alone, then the whole loop
    restored.rnn_clear_previous_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored.rnn_time_step(prompt[:, :, None].astype(np.float32))
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = generate_tokens(restored, prompt, GEN_TOKENS, seed=GEN_SEED)
    wall_ms = (time.perf_counter() - t0) * 1e3
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if any(launches.values()):
        raise AssertionError(f"generation launched a kernel of the repo: {launches} (the "
                             f"cached attention is the dense body)")
    if tokens.shape != (GEN_B, GEN_TOKENS) or tokens.min() < 0 or tokens.max() >= LM_VOCAB:
        raise AssertionError(f"bad tokens {tokens.shape}")
    if not np.array_equal(tokens, again):
        raise AssertionError("the same seed sampled other tokens")
    window = restored.conf.vertices["b0-attn"].stream_max_length
    if n_seen != GEN_PROMPT + GEN_TOKENS or not n_seen > window:
        raise AssertionError(f"the cache saw {n_seen} tokens, its window is {window}")
    if not sum_err <= PROB_SUM_ATOL:
        raise AssertionError(f"a sampled distribution sums to 1 only within {sum_err}")
    step_ms = (wall_ms - prefill_ms) / GEN_TOKENS
    rec_steps = record["ms"][1:]
    log(f"TransformerLM generate_tokens b={GEN_B}, prompt {GEN_PROMPT} + {GEN_TOKENS} tokens "
        f"(the {window}-slot window rolled at sampled token {window - GEN_PROMPT + 1}; the "
        f"cache saw {n_seen}): launches {launches}; rows sum to 1 within {sum_err:.2e}; the "
        f"same seed the same tokens. Timed unwrapped: prefill {prefill_ms:.2f} ms, "
        f"{wall_ms:.1f} ms in all, {step_ms:.3f} ms a sampled token (sampling included), "
        f"{GEN_B * GEN_TOKENS / wall_ms * 1e3:.0f} tokens/s; peak memory {peak_gib:.3f} GiB "
        f"({base_gib:.3f} GiB before). The checked run's rnn_time_step calls (a sync and a "
        f"row sum each): median {float(np.median(rec_steps)):.3f} ms, p90 "
        f"{float(np.percentile(rec_steps, 90)):.3f} ms")

    step_ids = np.asarray(tokens[:, -1:], np.float32)
    prof = profile_call("one TransformerLM decode step (b=4, a 512-slot cache)",
                        lambda: restored.rnn_time_step(step_ids))

    ids = np.random.default_rng(15).integers(0, LM_VOCAB, (GEN_B, GEN_STREAM_T))
    ids = ids.astype(np.float32)
    steps16, full16 = stream_and_output(restored, ids)
    # the same weights computing in f32 (TF32 off): the contract without
    # bf16's rounding at the f32 limits of tests/test_torch_generation.py,
    # and a reference for the bf16 stream's and output's own errors
    conf32 = copy.deepcopy(restored.conf)
    conf32.global_conf.compute_dtype = "float32"
    twin = type(restored)(conf32).init(params=restored.params)
    steps32, full32 = stream_and_output(twin, ids)
    del twin

    def rel(got, want):                                     # per sequence
        return ((got - want).abs().amax(dim=(1, 2)) / want.abs().amax(dim=(1, 2))).tolist()

    stream_rel = ((steps16 - full16).abs().max() / full16.abs().max()).item()
    stream_rows = rel(steps16, full16)
    vs32_stream, vs32_output = rel(steps16, full32), rel(full16, full32)
    stream_f32 = ((steps32 - full32).abs() - 2e-4 * full32.abs()).max().item()
    log(f"TransformerLM streaming contract, {GEN_STREAM_T} tokens one at a time vs output on "
        f"the same tokens, max_abs_err over the largest probability: bf16 {stream_rel:.3e} "
        f"(limit {GEN_STREAM_RTOL}; per sequence {', '.join(f'{e:.3e}' for e in stream_rows)}, "
        f"over each one's largest); against the "
        f"f32 twin's output the bf16 stream reads {', '.join(f'{e:.3e}' for e in vs32_stream)} "
        f"and the bf16 output {', '.join(f'{e:.3e}' for e in vs32_output)}; in f32 max "
        f"|stream - output| - 2e-4 |output| = {stream_f32:.3e} (limit 2e-5)")
    if not stream_rel <= GEN_STREAM_RTOL:
        raise AssertionError(f"the bf16 rnn_time_step disagrees with output: {stream_rel}")
    if not stream_f32 <= 2e-5:
        raise AssertionError(f"rnn_time_step disagrees with output in f32: {stream_f32}")
    return {"launches": launches, "write_s": write_s, "load_s": load_s, "zip_bytes": nbytes,
            "prefill_ms": prefill_ms, "ms_per_token": step_ms,
            "recorded_step_ms_p50": float(np.median(rec_steps)),
            "recorded_step_ms_p90": float(np.percentile(rec_steps, 90)),
            "generate_ms": wall_ms,
            "tokens_per_s": GEN_B * GEN_TOKENS / wall_ms * 1e3, "peak_gib": peak_gib,
            "prob_sum_err": sum_err, "stream_rel_err": stream_rel,
            "stream_rel_err_rows": stream_rows, "stream_vs_f32_rel_err_rows": vs32_stream,
            "output_vs_f32_rel_err_rows": vs32_output,
            "stream_f32_excess": stream_f32, "cache_tokens": n_seen,
            "decode_step_profile": prof}


def stream_and_output(net, ids):
    """``ids`` [b, T] streamed one token at a time through ``net``'s KV
    cache, and ``net``'s ``output`` on the same tokens, both [b, T, V]
    in f32."""
    net.rnn_clear_previous_state()
    steps = torch.stack([net.rnn_time_step(ids[:, t:t + 1]) for t in range(ids.shape[1])],
                        1).float()
    net.rnn_clear_previous_state()
    return steps, net.output(ids).float()


def moe_kernel_group(chain):
    """``kernel_group`` for a TransformerLM step: the MoE layers' batched
    einsums (bmm, forward and backward) and the dense layers' products
    (mm) apart from K5-K7 and the elementwise work."""
    names = " ".join(chain).lower()
    for key, group in (("dl4j::updater", "updater"), ("flash", "K5-K7"),
                       ("bmm", "MoE einsums (bmm)"), ("aten::mm", "dense products (mm)"),
                       ("addmm", "dense products (mm)"), ("mmbackward", "dense products (mm)")):
        if key in names:
            return group
    return "other elementwise"


def moe_routing(net, moes, f):
    """One training forward of the MoE net without gradients: the
    auxiliary loss, each expert's share of the top-k assignments over all
    MoE layers, and the share of assignments over an expert's capacity in
    its group (the ones capacity dispatch drops)."""
    gates = {}

    def recording(name, route):
        def recorded(xr, Wg):
            g, prob = route(xr, Wg)
            gates[name] = g
            return g, prob
        return recorded

    for name, impl in moes.items():
        impl._route = recording(name, impl._route)
    try:
        with torch.no_grad():
            _, _, ctx = net._apply_graph([net._to_device(f)], None, True)
    finally:
        for impl in moes.values():
            del impl._route
    load, dropped, total = 0, 0, 0
    for name, g in gates.items():
        impl = moes[name]
        sel = (g > 0).to(torch.int64)
        n, E = sel.shape
        G = max(8, min(n, int(impl.conf.group_size)))
        groups = -(-n // G)
        sel = torch.cat([sel, sel.new_zeros((groups * G - n, E))])
        per = sel.reshape(groups, G, E).sum(1)                 # [groups, E]
        dropped += (per - impl._capacity(G)).clamp(min=0).sum().item()
        total += per.sum().item()
        load = load + per.sum(0)
    return float(ctx["aux_loss"]), (load / load.sum()).tolist(), dropped / total


def moe_lm():
    """The MoE TransformerLM (bench.py:1730's model, MOE_EXPERTS experts
    top MOE_TOP_K in every block, bf16, CacheMode.DEVICE) on the card:
    ``output`` on one b=4, T=8192 batch (8 K5 launches; rows that sum to
    1), MOE_STEPS ``fit`` steps (each 8 K5, 8 K6 and 8 K7; the loss finite
    and falling), the aux loss, each expert's token share and the dropped
    share, the MoE step beside the dense model's in alternating turns
    (ms, tokens/s, peak memory), a profiled step grouped by
    ``moe_kernel_group``, capacity dispatch against the dense combine at
    the model's shape, and the trained net saved, guessed back and
    sampling MOE_GEN_TOKENS tokens (the dense combine; no K5-K7). Counts
    are reset just before and read just after ``output`` and the steps."""
    from deeplearning4j_torch import DataSet
    from deeplearning4j_torch.models import generate_tokens
    from deeplearning4j_torch.nn.graph import ComputationGraph
    from deeplearning4j_torch.nn.layers.moe import MoEDenseImpl

    conf = lm_conf(experts=MOE_EXPERTS)
    conf.global_conf.cache_mode = "device"
    net = ComputationGraph(conf).init()                 # device defaults to the card
    moes = {n: impl for n, impl in net.impls.items() if isinstance(impl, MoEDenseImpl)}
    if len(moes) != LM_BLOCKS:
        raise AssertionError(f"the MoE TransformerLM has {len(moes)} MoE layers")
    f, l = periodic_tokens(np.random.default_rng(8), LM_B, LM_T, LM_VOCAB)
    ds = DataSet(f, l)
    reset_counts()
    probs = net.output(f)
    torch.cuda.synchronize()
    out_launches = read_counts()
    want = {n: 0 for n in out_launches}
    want["flash_fwd"] = LM_BLOCKS
    if out_launches != want:
        raise AssertionError(f"MoE output launched {out_launches}, expected {want}")
    sums = probs.sum(-1)
    if tuple(probs.shape) != (LM_B, LM_T, LM_VOCAB) or not torch.isfinite(probs).all() \
            or (sums - 1).abs().max().item() > 1e-2:
        raise AssertionError(f"MoE output: shape {tuple(probs.shape)}, or rows that are not "
                             f"finite probabilities summing to 1")
    del probs, sums
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.output(f)
    torch.cuda.synchronize()
    output_ms = (time.perf_counter() - t0) * 1e3
    log(f"MoE TransformerLM ({net.num_params() / 1e6:.1f}M parameters, {MOE_EXPERTS} experts "
        f"top {MOE_TOP_K}) output b={LM_B} T={LM_T}: launches {out_launches}; a second call "
        f"{output_ms:.1f} ms")

    per_step = {n: 0 for n in out_launches}
    per_step.update(flash_fwd=LM_BLOCKS, flash_dq=LM_BLOCKS, flash_dkv=LM_BLOCKS)
    aux0 = moe_routing(net, moes, f)[0]
    losses = []
    reset_counts()
    for _ in range(MOE_STEPS):
        before = read_counts()
        net.fit(ds)
        losses.append(net.score())
        got = {n: c - before[n] for n, c in read_counts().items()}
        if got != per_step:
            raise AssertionError(f"a MoE training step launched {got}, expected {per_step}")
    launches = read_counts()
    aux, share, dropped = moe_routing(net, moes, f)
    drop = 1.0 - losses[-1] / losses[0]
    log(f"MoE TransformerLM training: {MOE_STEPS} Adam steps, launches {launches}; loss per "
        f"step " + " ".join(f"{x:.1f}" for x in losses) + f" (fell {100 * drop:.2f}%); aux "
        f"loss {aux0:.5f} before, {aux:.5f} after; expert shares of the top-{MOE_TOP_K} "
        f"assignments over the {LM_BLOCKS} layers "
        + " ".join(f"{x:.4f}" for x in share)
        + f"; {100 * dropped:.3f}% of the assignments over capacity (dropped)")
    if not np.isfinite(losses).all() or not np.isfinite(aux):
        raise AssertionError(f"MoE TransformerLM loss is not finite: {losses}, aux {aux}")
    if not drop >= MOE_LOSS_DROP:
        raise AssertionError(f"the MoE TransformerLM loss fell by {drop:.4f}, less than "
                             f"{MOE_LOSS_DROP}")

    dconf = lm_conf()
    dconf.global_conf.cache_mode = "device"
    dense = ComputationGraph(dconf).init()
    dense.fit(ds)
    turns, peaks = {"moe": [], "dense": []}, {}
    for turn in range(MOE_TURNS):
        for name in (("moe", "dense") if turn % 2 == 0 else ("dense", "moe")):
            model = net if name == "moe" else dense
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model.fit(ds)
            model.score()                                # the value: a sync
            turns[name].append((time.perf_counter() - t0) * 1e3)
            peaks[name] = torch.cuda.max_memory_allocated() / 2 ** 30
    med = {k: float(np.median(v)) for k, v in turns.items()}
    log(f"smoke number, not a benchmark: a MoE TransformerLM step {med['moe']:.1f} ms, the "
        f"dense model's {med['dense']:.1f} ms (CacheMode.DEVICE, medians of {MOE_TURNS} "
        f"alternating turns: {' '.join(f'{x:.1f}' for x in turns['moe'])} and "
        f"{' '.join(f'{x:.1f}' for x in turns['dense'])}); {LM_B * LM_T / med['moe'] * 1e3:.0f} "
        f"and {LM_B * LM_T / med['dense'] * 1e3:.0f} tokens/s; peak memory in a step "
        f"{peaks['moe']:.2f} and {peaks['dense']:.2f} GiB")
    del dense
    torch.cuda.empty_cache()
    prof = profile_call("one MoE TransformerLM step", lambda: net.fit(ds), updater=net.updater,
                        group=moe_kernel_group)
    sparse = check_moe_sparse(moes["b0-ffn"])

    restored, write_s, load_s, nbytes = save_and_guess(net, "moe_lm")
    prompt = np.random.default_rng(16).integers(0, LM_VOCAB, (GEN_B, MOE_GEN_PROMPT))
    reset_counts()
    tokens = generate_tokens(restored, prompt, MOE_GEN_TOKENS, seed=GEN_SEED)
    torch.cuda.synchronize()
    gen_launches = read_counts()
    if any(gen_launches.values()):
        raise AssertionError(f"MoE generation launched a kernel of the repo: {gen_launches}")
    if tokens.shape != (GEN_B, MOE_GEN_TOKENS) or tokens.min() < 0 or tokens.max() >= LM_VOCAB:
        raise AssertionError(f"bad MoE tokens {tokens.shape}")
    restored.rnn_clear_previous_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored.rnn_time_step(prompt[:, :, None].astype(np.float32))
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    again = generate_tokens(restored, prompt, MOE_GEN_TOKENS, seed=GEN_SEED)
    wall_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(tokens, again):
        raise AssertionError("the same seed sampled other MoE tokens")
    token_ms = (wall_ms - prefill_ms) / MOE_GEN_TOKENS
    log(f"MoE TransformerLM: zip {nbytes / 1e6:.1f} MB written in {write_s:.2f} s, guessed "
        f"back in {load_s:.2f} s; generate_tokens b={GEN_B}, prompt {MOE_GEN_PROMPT} + "
        f"{MOE_GEN_TOKENS} tokens: launches {gen_launches}; prefill {prefill_ms:.2f} ms, "
        f"{token_ms:.3f} ms a sampled token, {GEN_B * MOE_GEN_TOKENS / wall_ms * 1e3:.0f} "
        f"tokens/s; the same seed the same tokens")
    return {"launches": launches, "output_launches": out_launches, "output_ms": output_ms,
            "losses": losses, "aux_loss": [aux0, aux], "expert_share": share,
            "dropped_share": dropped, "step_ms": med["moe"], "dense_step_ms": med["dense"],
            "turns_ms": turns, "peak_gib": peaks,
            "tokens_per_s": LM_B * LM_T / med["moe"] * 1e3, "profile": prof,
            "sparse_vs_dense": sparse, "zip_bytes": nbytes, "prefill_ms": prefill_ms,
            "ms_per_token": token_ms}


def check_moe_sparse(impl):
    """Capacity dispatch against the dense combine on the card, one MoE
    layer at the model's shape (LM_B x LM_T tokens, bf16 input) at
    capacity factor E/k, where nothing drops; each timed once more."""
    dev = impl.W.device
    g = torch.Generator(device=dev).manual_seed(17)
    x = torch.randn(LM_B * LM_T, LM_E, generator=g, device=dev).to(torch.bfloat16)
    cf = impl.conf.capacity_factor
    impl.conf.capacity_factor = MOE_EXPERTS / MOE_TOP_K
    ms = {}
    try:
        with torch.no_grad():
            out = {}
            for name, train in (("sparse", True), ("dense", False)):
                out[name] = impl(x, ctx={"train": train}).float()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                impl(x, ctx={"train": train})
                torch.cuda.synchronize()
                ms[name] = (time.perf_counter() - t0) * 1e3
    finally:
        impl.conf.capacity_factor = cf
    err = ((out["sparse"] - out["dense"]).abs().max() / out["dense"].abs().max()).item()
    log(f"MoE capacity dispatch vs the dense combine, {LM_B * LM_T} tokens {LM_E} -> "
        f"{4 * LM_E} bf16, capacity factor {MOE_EXPERTS / MOE_TOP_K:g} (nothing drops): "
        f"max_abs_err over the largest entry {err:.3e} (limit {MOE_SPARSE_RTOL}); forward "
        f"{ms['sparse']:.2f} ms sparse, {ms['dense']:.2f} ms dense")
    if not err <= MOE_SPARSE_RTOL:
        raise AssertionError(f"capacity dispatch disagrees with the dense combine: {err}")
    return {"rel_err": err, "sparse_ms": ms["sparse"], "dense_ms": ms["dense"]}


def char_rnn_graph_conf():
    """The char-RNN of bench.py:230 as a ComputationGraph: vertices l0,
    l1 (GravesLSTM) and out, the same global configuration."""
    from deeplearning4j_torch import Adam, NeuralNetConfiguration
    from deeplearning4j_torch.nn.conf.layers import GravesLSTM, RnnOutputLayer

    return (NeuralNetConfiguration.builder().seed(1).updater(Adam(learning_rate=1e-3))
            .activation("tanh").compute_dtype("bfloat16").graph_builder()
            .add_inputs("in")
            .add_layer("l0", GravesLSTM(n_in=VOCAB, n_out=H), "in")
            .add_layer("l1", GravesLSTM(n_in=H, n_out=H), "l0")
            .add_layer("out", RnnOutputLayer(n_in=H, n_out=VOCAB, activation="softmax",
                                             loss="mcxent"), "l1")
            .set_outputs("out")
            .backprop_type("tbptt").t_bptt_forward_length(TRAIN_T)
            .t_bptt_backward_length(TRAIN_T).build())


def small_graph_conf():
    """Two inputs (a masked sequence and a side sequence), two outputs (per
    step and per example), through Merge, LastTimeStep,
    DuplicateToTimeSeries, Subset and L2Normalize vertices and two f32
    LSTMs (K1/K2), SGD."""
    from deeplearning4j_torch import NeuralNetConfiguration, Sgd
    from deeplearning4j_torch.nn.conf.graph import (DuplicateToTimeSeriesVertex,
                                                    L2NormalizeVertex, LastTimeStepVertex,
                                                    MergeVertex, SubsetVertex)
    from deeplearning4j_torch.nn.conf.layers import LSTM, GravesLSTM, OutputLayer, RnnOutputLayer

    return (NeuralNetConfiguration.builder().seed(4).updater(Sgd(learning_rate=0.1))
            .activation("tanh").graph_builder()
            .add_inputs("seq", "side")
            .add_layer("enc", GravesLSTM(n_in=16, n_out=64), "seq")
            .add_vertex("last", LastTimeStepVertex(mask_input="seq"), "enc")
            .add_vertex("sub", SubsetVertex(from_idx=0, to_idx=31), "last")
            .add_vertex("norm", L2NormalizeVertex(), "sub")
            .add_vertex("dup", DuplicateToTimeSeriesVertex(reference_input="side"), "norm")
            .add_vertex("cat", MergeVertex(), "dup", "side")
            .add_layer("dec", LSTM(n_in=40, n_out=64), "cat")
            .add_layer("per_step", RnnOutputLayer(n_in=64, n_out=10, activation="softmax",
                                                  loss="mcxent"), "dec")
            .add_layer("summary", OutputLayer(n_in=32, n_out=3, activation="softmax",
                                              loss="mcxent"), "norm")
            .set_outputs("per_step", "summary").build())


def rel_errs(got, want):
    """{vertex/param: max |got - want| over max |want|}."""
    return {f"{n}/{k}": ((got[n][k].float().cpu() - w.float().cpu()).abs().max()
                         / w.float().abs().max().clamp(min=1e-30).cpu()).item()
            for n, ws in want.items() for k, w in ws.items()}


def graph_tbptt():
    """Truncated BPTT over a ComputationGraph on the card: the char-RNN
    as a graph (K1 with the reserve and K2 a layer, each segment) against
    the MultiLayerNetwork char-RNN (the fused K3/K4) from the same weights
    on one b=64, T=200 DataSet: one segment's gradients, then a fit of 4
    segments (launches counted a segment), its loss and parameters. Then
    a small two-input, two-output graph fitting a MultiDataSet and taking
    external errors, card against CPU."""
    from deeplearning4j_torch import DataSet, MultiDataSet
    from deeplearning4j_torch.nn.graph import ComputationGraph

    mln = build_net(char_rnn_conf(), seed=11)
    cg = ComputationGraph(char_rnn_graph_conf()).init(
        params={v: mln.params[str(i)] for i, v in enumerate(("l0", "l1", "out"))})
    f, l = periodic_text(np.random.default_rng(12), TRAIN_B, TRAIN_SEQ)
    seg = DataSet(f[:, :TRAIN_T], l[:, :TRAIN_T])
    reset_counts()
    g_cg, s_cg = cg.compute_gradient_and_score(seg)
    seg_launches = read_counts()
    g_mln, s_mln = mln.compute_gradient_and_score(seg)
    g_err = rel_errs(g_cg, {v: g_mln[str(i)] for i, v in enumerate(("l0", "l1", "out"))})
    worst = max(g_err, key=g_err.get)
    s_err = abs(s_cg - s_mln) / abs(s_mln)
    log(f"graph char-RNN vs the MultiLayerNetwork, one segment b={TRAIN_B} T={TRAIN_T}: score "
        f"{s_cg:.4f} vs {s_mln:.4f} (rel {s_err:.2e}), worst gradient {worst} rel "
        f"{g_err[worst]:.2e}; the graph launched {seg_launches}")
    if seg_launches["lstm_fwd_train"] != 2 or seg_launches["lstm_bwd"] != 2:
        raise AssertionError(f"the graph's segment launched {seg_launches}")
    if not (s_err <= TRAIN_SCORE_RTOL and g_err[worst] <= TRAIN_GRAD_RTOL):
        raise AssertionError(f"the graph and the MLN char-RNN disagree: score {s_err}, "
                             f"{worst} {g_err[worst]}")

    segs = -(-TRAIN_SEQ // TRAIN_T)
    per_segment = []

    def counted_steps(*a, **k):
        before = read_counts()
        out = ComputationGraph._steps(cg, *a, **k)
        per_segment.append({n: c - before[n] for n, c in read_counts().items() if c - before[n]})
        return out

    cg._steps = counted_steps
    ds = DataSet(f, l)
    reset_counts()
    try:
        cg.fit(ds)
        cg_loss = cg.score()
    finally:
        del cg._steps
    launches = read_counts()
    mln.fit(ds)
    mln_loss = mln.score()
    want = {"lstm_fwd_train": 2, "lstm_bwd": 2}
    if per_segment != [want] * segs:
        raise AssertionError(f"the graph's TBPTT segments launched {per_segment}, expected "
                             f"{segs} x {want}")
    p_err = max((cg.params[v][k].float() - mln.params[str(i)][k].float()).abs().max().item()
                for i, v in enumerate(("l0", "l1", "out")) for k in cg.params[v])
    l_err = abs(cg_loss - mln_loss) / abs(mln_loss)
    if not (l_err <= TRAIN_SCORE_RTOL and p_err <= GRAPH_PARAM_ATOL):
        raise AssertionError(f"the graph's TBPTT fit disagrees with the MLN's: loss {l_err}, "
                             f"parameters {p_err}")
    turns = {"graph": [], "mln": []}
    for turn in range(FIT_TURNS):
        for name in (("graph", "mln") if turn % 2 == 0 else ("mln", "graph")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (cg if name == "graph" else mln).fit(ds)
            (cg if name == "graph" else mln).score()        # the value: a sync
            turns[name].append((time.perf_counter() - t0) * 1e3)
    fit_ms = {k: float(np.median(v)) for k, v in turns.items()}
    log(f"graph char-RNN TBPTT fit b={TRAIN_B} T={TRAIN_SEQ} ({segs} segments, each "
        f"{per_segment[0]}): loss {cg_loss:.4f} vs the MLN's {mln_loss:.4f} (rel {l_err:.2e}, "
        f"limit {TRAIN_SCORE_RTOL}); parameters max_abs_err {p_err:.2e} (limit "
        f"{GRAPH_PARAM_ATOL}). Smoke number, not a benchmark: a fit {fit_ms['graph']:.2f} ms "
        f"(graph, per layer: K1 + K2) and {fit_ms['mln']:.2f} ms (MLN, fused pair: K3 + K4), "
        f"medians of {FIT_TURNS} alternating turns")

    conf = small_graph_conf()
    card = ComputationGraph(conf).init()
    cpu = ComputationGraph(small_graph_conf()).init(
        params={n: {k: t.cpu() for k, t in p.items()} for n, p in card.params.items()},
        device="cpu")
    rng = np.random.default_rng(18)
    b, t = 16, 40
    xs = [rng.normal(size=(b, t, 16)).astype(np.float32),
          rng.normal(size=(b, t, 8)).astype(np.float32)]
    m = (np.arange(t)[None, :] < rng.integers(t // 2, t + 1, b)[:, None]).astype(np.float32)
    ys = [np.eye(10, dtype=np.float32)[rng.integers(0, 10, (b, t))],
          np.eye(3, dtype=np.float32)[rng.integers(0, 3, b)]]
    mds = MultiDataSet(xs, ys, [m, None], [m, None])
    eps = [rng.normal(size=(b, t, 10)).astype(np.float32) * 0.1,
           rng.normal(size=(b, 3)).astype(np.float32) * 0.1]
    small = {}
    for label, step in (("MultiDataSet fit", lambda net: net.fit(mds)),
                        ("fit_external_errors", lambda net: net.fit_external_errors(xs, eps))):
        reset_counts()
        step(card)
        torch.cuda.synchronize()
        got = read_counts()
        step(cpu)
        s_card, s_cpu = card.score(mds), cpu.score(mds)
        ss_err = abs(s_card - s_cpu) / abs(s_cpu)
        sp_err = max((card.params[n][k].cpu() - w).abs().max().item()
                     for n, ws in cpu.params.items() for k, w in ws.items())
        log(f"small graph on the card vs the CPU after {label}: score {s_card:.5f} vs "
            f"{s_cpu:.5f} (rel {ss_err:.2e}), parameters max_abs_err {sp_err:.2e}; launches "
            f"{ {n: c for n, c in got.items() if c} }")
        if got["lstm_fwd_train"] != 2 or got["lstm_bwd"] != 2:
            raise AssertionError(f"the small graph's {label} launched {got}")
        if not (ss_err <= SMALL_GRAPH_SCORE_RTOL and sp_err <= SMALL_GRAPH_PARAM_ATOL):
            raise AssertionError(f"the small graph's {label} disagrees with the CPU: "
                                 f"score {ss_err}, parameters {sp_err}")
        small[label] = {"score_rel": ss_err, "param_abs": sp_err}
    return {"launches": launches, "per_segment": per_segment, "loss_rel": l_err,
            "param_abs": p_err, "fit_ms": fit_ms, "small": small}




def regularized_conf(variant):
    """char_rnn_conf with one of REG_VARIANTS."""
    from deeplearning4j_torch.nn.conf.dropout import DropConnect, Dropout, MaxNormConstraint

    conf = char_rnn_conf()
    l0, l1, _ = conf.layers
    if variant == "dropout_layer0":
        l0.dropout = Dropout(0.8)
    elif variant == "dropout_layer1":
        l1.dropout = Dropout(0.8)
    elif variant == "dropconnect_layer0":
        l0.weight_noise = DropConnect(0.9)
    elif variant == "maxnorm":
        l0.constraints = [MaxNormConstraint(1.0)]
        l1.constraints = [MaxNormConstraint(1.0)]
    else:
        # the retain probability 1.0: disabled (a Dropout object on the
        # pair's second layer would split it, whatever its p, as in JAX)
        for layer in conf.layers:
            layer.dropout = 1.0
    return conf


@contextlib.contextmanager
def recorded_draws(draws, replay=False):
    """Every draw of ``nn/conf/dropout.bernoulli``, ``normal`` and
    ``exponential`` (dropout, weight noise, the pretrain layers' draws)
    appended to ``draws``; with ``replay``, taken from ``draws`` in order
    instead (moved to the caller's device, shapes checked)."""
    from deeplearning4j_torch.nn.conf import dropout as pdrop

    real = {n: getattr(pdrop, n) for n in ("bernoulli", "normal", "exponential")}

    def make(name):
        def draw(gen, *args):
            shape, device = args[-2:] if name == "bernoulli" else (args[0], args[-1])
            if replay:
                got = draws.pop(0)
                if tuple(got.shape) != tuple(shape):
                    raise AssertionError(f"replayed {name} draw of shape {tuple(got.shape)} "
                                         f"where {tuple(shape)} is drawn")
                return got.to(device)
            out = real[name](gen, *args)
            draws.append(out.cpu())
            return out
        return draw
    try:
        for n in real:
            setattr(pdrop, n, make(n))
        yield draws
    finally:
        for n, fn in real.items():
            setattr(pdrop, n, fn)


def regularized_reference(variant):
    """One training loss and its gradients of a ``variant`` char-RNN on
    the card (b=4, T=30, as check_train_reference) against a CPU copy
    replaying the card's draws. Returns (score rel err, worst gradient rel
    err, draws)."""
    from deeplearning4j_torch import DataSet, MultiLayerNetwork

    conf = regularized_conf(variant)
    net = build_net(conf, seed=4)
    cpu = MultiLayerNetwork(conf).init(
        params={k: {n: t.cpu() for n, t in p.items()} for k, p in net.params.items()},
        device="cpu")
    ds = DataSet(*periodic_text(np.random.default_rng(7), 4, 30))
    draws = []
    with recorded_draws(draws):
        s_card, _ = net._loss_fn(*net._tensors(ds), True, rng=net._gen)
    g_card = net._grads(s_card)
    n_draws = len(draws)
    with recorded_draws(draws, replay=True):
        s_cpu, _ = cpu._loss_fn(*cpu._tensors(ds), True, rng=cpu._gen)
    if draws:
        raise AssertionError(f"{variant}: {len(draws)} of the card's draws were not replayed")
    g_cpu = cpu._grads(s_cpu)
    s_card, s_cpu = float(s_card.detach()), float(s_cpu.detach())
    s_err = abs(s_card - s_cpu) / abs(s_cpu)
    g_err = {f"{i}/{k}": ((g_card[i][k].cpu() - g).abs().max() / g.abs().max()).item()
             for i, gs in g_cpu.items() for k, g in gs.items()}
    key = max(g_err, key=g_err.get)
    log(f"card vs CPU on the card's {n_draws} draws, {variant}: score {s_card:.4f} vs "
        f"{s_cpu:.4f} (rel {s_err:.2e}); worst gradient {key} rel {g_err[key]:.2e}")
    if not (s_err <= TRAIN_SCORE_RTOL and g_err[key] <= TRAIN_GRAD_RTOL):
        raise AssertionError(f"{variant}: card and CPU disagree on the replayed draws: score "
                             f"{s_err}, {key} {g_err[key]}")
    return s_err, g_err[key], n_draws


def timed_fits(nets, ds, turns, fits):
    """{label: median ms a fit} of the nets (label -> net or (net,
    listeners)) fitted ``fits`` times a turn in alternating order,
    synchronously; and the turns themselves."""
    out = {k: [] for k in nets}
    labels = list(nets)
    with prefetch_workers(0):
        for turn in range(turns):
            for label in (labels if turn % 2 == 0 else labels[::-1]):
                net, listeners = nets[label]
                net.set_listeners(*listeners)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(fits):
                    net.fit(ds)
                net.score()                           # the value: a sync
                out[label].append((time.perf_counter() - t0) * 1e3 / fits)
                net.set_listeners()
    return {k: float(np.median(v)) for k, v in out.items()}, out


def regularized_char_rnn():
    """The char-RNN's training main path with dropout, DropConnect, MaxNorm
    and listeners (see REG_VARIANTS): each variant's fit launches what its
    route says, counts reset just before and read just after; MaxNorm
    holds; the disabled variant's loss and parameters equal the plain
    fit's bit for bit; the dropout and DropConnect losses and gradients on
    the card equal a CPU copy's on the card's draws; the costs against
    the plain fit and of the listeners' sync; a health halt on a NaN batch;
    a checkpoint that restores bit-equal."""
    from deeplearning4j_torch import DataSet, ListDataSetIterator
    from deeplearning4j_torch.monitor.health import TrainingHealthListener
    from deeplearning4j_torch.optimize.listeners import (CheckpointListener,
                                                         CollectScoresIterationListener,
                                                         ScoreIterationListener)

    f, l = periodic_text(np.random.default_rng(6), TRAIN_B, TRAIN_SEQ)
    ds = DataSet(f, l)
    segs = -(-TRAIN_SEQ // TRAIN_T)
    fused = {"lstm2_fwd_train": segs, "lstm2_bwd": segs}
    split = {"lstm_fwd_train": 2 * segs, "lstm_bwd": 2 * segs}
    routes = {"plain": fused, "dropout_layer0": fused, "dropout_layer1": split,
              "dropconnect_layer0": split, "maxnorm": fused, "retain_all": fused}
    nets = {v: build_net(char_rnn_conf() if v == "plain" else regularized_conf(v), seed=3)
            for v in routes}
    launches, losses = {}, {}
    for v, want in routes.items():
        reset_counts()
        nets[v].fit(ds)
        torch.cuda.synchronize()
        got = read_counts()
        launches[v] = got
        losses[v] = nets[v].score_.detach().clone()
        if got != {n: want.get(n, 0) for n in got}:
            raise AssertionError(f"a {v} fit of {segs} TBPTT segments launched {got}, "
                                 f"expected {want}")
    log(f"regularised char-RNN fits (b={TRAIN_B}, T={TRAIN_SEQ}, {segs} segments), launches: "
        + "; ".join(f"{v} {({n: c for n, c in g.items() if c})}" for v, g in launches.items()))
    log("their losses: " + " ".join(f"{v} {float(x):.4f}" for v, x in losses.items()))
    if not all(torch.isfinite(x) for x in losses.values()):
        raise AssertionError(f"a regularised fit's loss is not finite: {losses}")
    norms = {f"{i}/{k}": torch.linalg.vector_norm(nets["maxnorm"].params[i][k], dim=0).max().item()
             for i in ("0", "1") for k in ("W", "RW")}
    log(f"MaxNorm 1.0 after the fit: largest column norm {norms} (plain fit: "
        f"{torch.linalg.vector_norm(nets['plain'].params['1']['RW'], dim=0).max().item():.4f})")
    if max(norms.values()) > 1.0 + MAXNORM_ATOL:
        raise AssertionError(f"MaxNorm 1.0 does not hold after the fit: {norms}")
    same = (torch.equal(losses["retain_all"], losses["plain"])
            and same_tensors(nets["retain_all"].params, nets["plain"].params))
    log(f"retain probability 1.0 everywhere: loss and parameters bit-equal to the plain "
        f"fit's: {same}")
    if not same:
        raise AssertionError("the disabled-dropout fit differs from the plain fit")
    reference = {v: regularized_reference(v)
                 for v in ("dropout_layer0", "dropout_layer1", "dropconnect_layer0")}

    med, turns = timed_fits({v: (nets[v], ()) for v in routes}, ds, REG_TURNS, REG_FITS)
    for v in REG_VARIANTS:
        log(f"smoke number, not a benchmark: a {v} fit {med[v]:.3f} ms against the plain "
            f"fit's {med['plain']:.3f} ({100 * (med[v] / med['plain'] - 1):+.1f}%; medians of "
            f"{REG_TURNS} alternating turns of {REG_FITS} fits: "
            f"{' '.join(f'{x:.3f}' for x in turns[v])})")
    plain = nets["plain"]
    lst_med, lst_turns = timed_fits(
        {"none": (plain, ()),
         "listeners": (plain, (ScoreIterationListener(1), CollectScoresIterationListener()))},
        ds, REG_TURNS, REG_FITS)
    log(f"smoke number, not a benchmark: a fit with ScoreIterationListener + "
        f"CollectScoresIterationListener {lst_med['listeners']:.3f} ms against "
        f"{lst_med['none']:.3f} without ({100 * (lst_med['listeners'] / lst_med['none'] - 1):+.1f}%)")

    # the health halt: the second of three minibatches holds a NaN
    halt_net = build_net(char_rnn_conf(), seed=5)
    bad = f.copy()
    bad[0, 0, :] = np.nan
    health, collect = TrainingHealthListener(action="halt"), CollectScoresIterationListener()
    halt_net.set_listeners(health, collect)
    reset_counts()
    halt_net.fit(ListDataSetIterator([ds, DataSet(bad, l), ds]), epochs=2)
    torch.cuda.synchronize()
    halt_launches = read_counts()
    scores = [s for _, s in collect.scores]
    log(f"TrainingHealthListener(action='halt') over 3 minibatches x 2 epochs, the second "
        f"NaN: stopped after {len(scores)} minibatches (scores {scores}), iteration_count "
        f"{halt_net.iteration_count}, epochs {halt_net.epoch_count}, launches "
        f"{({n: c for n, c in halt_launches.items() if c})}, triggered {health.triggered[:1]}")
    if not (halt_net.halt_requested and len(scores) == 2 and np.isnan(scores[1])
            and halt_net.iteration_count == 2 * segs and halt_net.epoch_count == 1
            and halt_launches["lstm2_fwd_train"] == 2 * segs):
        raise AssertionError("the health halt did not stop the fit after the NaN minibatch")

    # a checkpoint every fit (4 iterations), the last two kept
    ck = Path("build") / "checkpoints"
    shutil.rmtree(ck, ignore_errors=True)
    plain.set_listeners(CheckpointListener(str(ck), save_every_n_iterations=segs,
                                           keep_last=2))
    for _ in range(3):
        plain.fit(ds)
    plain.set_listeners()
    files = CheckpointListener.checkpoints(str(ck))
    restored = CheckpointListener.last_checkpoint(str(ck))      # on the card
    ok = (len(files) == 2 and same_tensors(restored.params, plain.params)
          and same_tensors(restored.updater_state, plain.updater_state)
          and restored.iteration_count == plain.iteration_count)
    log(f"CheckpointListener: kept {[Path(p).name for p in files]}; the last restores "
        f"bit-equal (parameters, Adam state, iteration count): {ok}")
    if not ok:
        raise AssertionError("the last checkpoint does not restore the net bit for bit")
    del nets, halt_net, restored
    return {"launches": {v: {n: c for n, c in g.items() if c} for v, g in launches.items()},
            "losses": {v: float(x) for v, x in losses.items()}, "maxnorm_column_norms": norms,
            "retain_all_bit_equal": same,
            "card_vs_cpu": {v: {"score_rel_err": r[0], "grad_rel_err": r[1], "draws": r[2]}
                            for v, r in reference.items()},
            "fit_ms": med, "fit_turns_ms": turns, "listener_fit_ms": lst_med,
            "listener_turns_ms": lst_turns, "halt_after_minibatches": len(scores),
            "halt_launches": {n: c for n, c in halt_launches.items() if c}}


def lm_dropout():
    """The TransformerLM of lm_conf with attention dropout LM_DROPOUT_RATE
    under CacheMode.DEVICE: LM_DROPOUT_STEPS fit steps, each 8 K5, 8 K6 and
    8 K7 launches (counts reset just before, read just after) with nonzero
    seeds; the loss finite and falling; the step beside the dropout-free
    step in alternating turns; K5's keep bits against dropout_keep_mask on
    the first 64 keys of every row of a full-shape call at a seed the fit
    drew; and K5, K6 and K7 with dropout timed beside
    scaled_dot_product_attention with dropout_p at the same shape."""
    from deeplearning4j_torch import DataSet
    from deeplearning4j_torch.nn.graph import ComputationGraph
    from deeplearning4j_torch.ops import flash_attention as fa

    def conf(rate):
        c = lm_conf()
        c.global_conf.cache_mode = "device"
        for v in c.vertices.values():
            if hasattr(v, "dropout_rate"):
                v.dropout_rate = rate
        return c

    net = ComputationGraph(conf(LM_DROPOUT_RATE)).init()
    f, l = periodic_tokens(np.random.default_rng(8), LM_B, LM_T, LM_VOCAB)
    ds = DataSet(f, l)
    seeds, real = [], fa.flash_attention

    def spy(*a, **k):
        seeds.append((k.get("dropout_rate"), k.get("dropout_seed")))
        return real(*a, **k)

    fa.flash_attention = spy
    losses = []
    try:
        reset_counts()
        for _ in range(LM_DROPOUT_STEPS):
            net.fit(ds)
            losses.append(net.score())
        launches = read_counts()
    finally:
        fa.flash_attention = real
    want = {n: 0 for n in launches}
    want.update(flash_fwd=LM_BLOCKS * LM_DROPOUT_STEPS, flash_dq=LM_BLOCKS * LM_DROPOUT_STEPS,
                flash_dkv=LM_BLOCKS * LM_DROPOUT_STEPS)
    drop = 1.0 - losses[-1] / losses[0]
    log(f"TransformerLM with attention dropout {LM_DROPOUT_RATE}: {LM_DROPOUT_STEPS} steps, "
        f"launches {({n: c for n, c in launches.items() if c})}; {len(seeds)} attention calls, "
        f"rates {sorted({r for r, _ in seeds})}, seeds nonzero {all(s for _, s in seeds)}; "
        f"loss per step " + " ".join(f"{x:.1f}" for x in losses)
        + f", fell {100 * drop:.2f}%")
    if launches != want:
        raise AssertionError(f"the dropout LM's steps launched {launches}, expected {want}")
    if len(seeds) != LM_BLOCKS * LM_DROPOUT_STEPS or not all(
            r == LM_DROPOUT_RATE and s for r, s in seeds):
        raise AssertionError(f"the attention calls did not all drop with a seed: {seeds}")
    if not (np.isfinite(losses).all() and drop >= LM_DROPOUT_LOSS_DROP):
        raise AssertionError(f"the dropout LM's loss did not fall by {LM_DROPOUT_LOSS_DROP}: "
                             f"{losses}")

    plain = ComputationGraph(conf(0.0)).init()
    plain.fit(ds)
    med, turns = timed_fits({"dropout": (net, ()), "plain": (plain, ())}, ds,
                            LM_DROPOUT_TURNS, 1)
    log(f"smoke number, not a benchmark: a TransformerLM step with attention dropout "
        f"{LM_DROPOUT_RATE} {med['dropout']:.1f} ms against {med['plain']:.1f} without "
        f"({100 * (med['dropout'] / med['plain'] - 1):+.1f}%; medians of {LM_DROPOUT_TURNS} "
        f"alternating turns, cached: {turns})")
    dev = net.device
    del net, plain
    torch.cuda.empty_cache()

    # K5's keep bits in a full-shape call: q = k = 0 makes every visible
    # probability of row i 1/(i+1); v = e_j for the first 64 keys and 0
    # after, so o[i, j] != 0 exactly where key j < 64 is visible and kept
    bh, t, d = LM_B * LM_HEADS, LM_T, LM_D
    z = torch.zeros((bh, t, d), device=dev, dtype=torch.bfloat16)
    v = torch.zeros((bh, t, d), device=dev, dtype=torch.bfloat16)
    v[:, :d] = torch.eye(d, device=dev, dtype=torch.bfloat16)
    sd = fa.seed3(seeds[0][1])
    o, _ = fa.flash_fwd(z, z, v, None, True, d ** -0.5, LM_DROPOUT_RATE, sd)
    want_keep = fa.dropout_keep_mask(bh, t, d, sd[0], LM_DROPOUT_RATE, sd[1], sd[2],
                                     device=dev)
    visible = torch.tril(torch.ones((t, d), dtype=torch.bool, device=dev))
    keep_ok = torch.equal(o[:, :, :d] != 0, want_keep & visible)
    log(f"K5 keep bits at full shape (b={LM_B} h={LM_HEADS} T={t} d={d}, the fit's first "
        f"seed) equal dropout_keep_mask on keys 0..{d - 1} of every row: {keep_ok} "
        f"({100 * want_keep.float().mean().item():.2f}% kept)")
    if not keep_ok:
        raise AssertionError("K5's keep bits at full shape differ from dropout_keep_mask")
    del z, v, o, want_keep

    # K5, K6 and K7 with dropout beside SDPA with dropout_p, same shape
    g = torch.Generator().manual_seed(21)
    q, k, vv, do = (torch.randn((bh, t, d), generator=g).to(dev, torch.bfloat16)
                    for _ in range(4))
    scale = d ** -0.5
    o, lse = fa.flash_fwd(q, k, vv, None, True, scale, LM_DROPOUT_RATE, sd)
    delta = fa.rowwise_delta(do, o)
    args = (q, k, vv, None, do, delta, lse, True, scale, sd, LM_DROPOUT_RATE)
    ms = {"flash_fwd": cuda_ms(lambda: fa.flash_fwd(q, k, vv, None, True, scale,
                                                    LM_DROPOUT_RATE, sd), 10),
          "flash_dq": cuda_ms(lambda: fa.dq_block(*args), 10),
          "flash_dkv": cuda_ms(lambda: fa.dkv_block(*args), 10)}
    plain_ms = {"flash_fwd": cuda_ms(lambda: fa.flash_fwd_plain(q, k, vv, None, True, scale,
                                                                LM_DROPOUT_RATE, sd), 1),
                "flash_dq": cuda_ms(lambda: fa.flash_dq_plain(*args), 1),
                "flash_dkv": cuda_ms(lambda: fa.flash_dkv_plain(*args), 1)}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = (x.view(LM_B, LM_HEADS, t, d).detach().requires_grad_(True)
                  for x in (q, k, vv))
    dos = do.view(LM_B, LM_HEADS, t, d)
    lib_fwd = cuda_ms(lambda: sdpa(qs, ks, vs, is_causal=True, dropout_p=LM_DROPOUT_RATE), 10)
    out = sdpa(qs, ks, vs, is_causal=True, dropout_p=LM_DROPOUT_RATE)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), dos, retain_graph=True),
                      10)
    cells = bh * t * (t + 1) // 2
    x = bh * t * d * 2
    rows = bh * t * 4
    work = {"flash_fwd": (4 * x + rows, 2 * 2 * d * cells),
            "flash_dq": (5 * x + 2 * rows, 3 * 2 * d * cells),
            "flash_dkv": (6 * x + 2 * rows, 4 * 2 * d * cells)}
    timing = {}
    for name, (nbytes, flops) in work.items():
        bms, by = bound(nbytes, flops, 0)
        timing[name] = {"ms": ms[name], "plain_ms": plain_ms[name], "bound_ms": bms,
                        "bound_by": by,
                        "library_ms": lib_fwd if name == "flash_fwd" else lib_bwd}
        log(f"{name} causal with dropout {LM_DROPOUT_RATE} b={LM_B} h={LM_HEADS} T={t} d={d}: "
            f"kernel_ms={ms[name]:.3f} plain_ms={plain_ms[name]:.1f} bound_ms={bms:.4f} ({by}) "
            f"library_ms={timing[name]['library_ms']:.3f}")
    log(f"yardstick scaled_dot_product_attention causal dropout_p={LM_DROPOUT_RATE}: forward "
        f"{lib_fwd:.3f} ms (K5 {ms['flash_fwd']:.3f}), backward {lib_bwd:.3f} ms (K6 + K7 "
        f"{ms['flash_dq'] + ms['flash_dkv']:.3f})")
    return {"launches": {n: c for n, c in launches.items() if c}, "losses": losses,
            "step_ms": med, "step_turns_ms": turns, "keep_bits_equal": keep_ok,
            "kernels": timing}


def solvers():
    """LBFGS (``optimize/solvers.py``) on a full-batch dense net on the
    card: its first SOLVER_CHECK_ITERS iterates' losses and gradients
    against a CPU copy's at the same iterates, an independent CPU run's
    losses against the card's (see SOLVER_SAME_PATH_ITERS), then
    SOLVER_ITERS iterations against as many SGD steps of the same net; ms
    an iteration."""
    from deeplearning4j_torch import DataSet, MultiLayerNetwork, NeuralNetConfiguration, Sgd
    from deeplearning4j_torch.nn.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_torch.optimize import solvers as S

    def conf(algo):
        return (NeuralNetConfiguration.builder().seed(3).updater(Sgd(learning_rate=0.1))
                .activation("tanh").optimization_algo(algo).list()
                .layer(DenseLayer(n_in=SOLVER_IN, n_out=SOLVER_HIDDEN))
                .layer(OutputLayer(n_in=SOLVER_HIDDEN, n_out=SOLVER_OUT, activation="softmax",
                                   loss="mcxent")).build())

    rng = np.random.default_rng(31)
    ds = DataSet(rng.normal(size=(SOLVER_N, SOLVER_IN)).astype(np.float32),
                 np.eye(SOLVER_OUT, dtype=np.float32)[rng.integers(0, SOLVER_OUT, SOLVER_N)])
    card = MultiLayerNetwork(conf("lbfgs")).init()
    params = {k: {n: t.cpu().clone() for n, t in p.items()} for k, p in card.params.items()}
    cpu = MultiLayerNetwork(conf("lbfgs")).init(params=params, device="cpu")
    recorded = {"card": [], "cpu": []}
    iterates = []
    real = S.BaseOptimizer.f_g

    def f_g(self, x):
        out = real(self, x)
        on_card = self.net is card
        recorded["card" if on_card else "cpu"].append(out)
        if on_card:
            iterates.append(x.copy())
        return out

    S.BaseOptimizer.f_g = f_g
    try:
        S.LBFGS(cpu, ds, max_iterations=SOLVER_CHECK_ITERS).optimize()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        S.Solver.builder().model(card).max_iterations(SOLVER_ITERS).build().optimize(ds)
        torch.cuda.synchronize()
        lbfgs_ms = (time.perf_counter() - t0) * 1e3
    finally:
        S.BaseOptimizer.f_g = real
    n = min(SOLVER_CHECK_ITERS + 1, len(recorded["cpu"]), len(iterates))
    at_card = S.BaseOptimizer(cpu, ds)
    same_x = []
    for x, (loss, g) in zip(iterates[:n], recorded["card"][:n]):
        c_loss, c_g = at_card.f_g(x)
        same_x.append((abs(loss - c_loss) / abs(c_loss),
                       float(np.abs(g - c_g).max() / np.abs(c_g).max())))
    path = [abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(recorded["card"][:n],
                                                         recorded["cpu"][:n])]
    sgd = MultiLayerNetwork(conf("sgd")).init(params=params)
    for _ in range(SOLVER_ITERS):
        sgd.fit(ds)
    lbfgs_loss, sgd_loss = card.score(ds, training=True), sgd.score(ds, training=True)
    log(f"LBFGS {SOLVER_N} x {SOLVER_IN} -> {SOLVER_HIDDEN} -> {SOLVER_OUT} f32 on the card: "
        f"losses at its first {n} evaluations "
        f"{[f'{x[0]:.6f}' for x in recorded['card'][:n]]}; the CPU at the same iterates: loss "
        f"rel err {[f'{e[0]:.1e}' for e in same_x]}, gradient {[f'{e[1]:.1e}' for e in same_x]}; "
        f"an independent CPU run: loss rel err {[f'{e:.1e}' for e in path]}; {SOLVER_ITERS} "
        f"iterations ({len(recorded['card'])} loss-and-gradient calls) {lbfgs_ms:.1f} ms, "
        f"{lbfgs_ms / SOLVER_ITERS:.2f} ms an iteration; loss {lbfgs_loss:.5f} against "
        f"{sgd_loss:.5f} after {SOLVER_ITERS} SGD steps")
    if not (max(e[0] for e in same_x) <= SOLVER_LOSS_RTOL
            and max(e[1] for e in same_x) <= SOLVER_GRAD_RTOL):
        raise AssertionError(f"the CPU disagrees with the card at the card's iterates: {same_x}")
    if not max(path[:SOLVER_SAME_PATH_ITERS + 1]) <= SOLVER_LOSS_RTOL:
        raise AssertionError(f"LBFGS on the card and the CPU part within "
                             f"{SOLVER_SAME_PATH_ITERS} iterations: {path}")
    if not lbfgs_loss < sgd_loss:
        raise AssertionError(f"LBFGS ({lbfgs_loss}) did not beat {SOLVER_ITERS} SGD steps "
                             f"({sgd_loss})")
    return {"same_iterate_rel_err": same_x, "independent_run_rel_err": path,
            "losses_card": [x[0] for x in recorded["card"][:n]],
            "losses_cpu": [x[0] for x in recorded["cpu"][:n]], "ms": lbfgs_ms,
            "ms_per_iteration": lbfgs_ms / SOLVER_ITERS, "lbfgs_loss": lbfgs_loss,
            "sgd_loss": sgd_loss}


def held_evaluation(label, labels, out, mask=None):
    """``Evaluation.eval`` on the tensor where it lies against the same
    class fed the same predictions copied to the host (exactly equal
    counts): returns the on-card evaluation."""
    from deeplearning4j_torch.eval import Evaluation

    ev, host = Evaluation(), Evaluation()
    ev.eval(labels, out, mask=mask)
    host.eval(labels, out.float().cpu().numpy(), mask=mask)
    if not (np.array_equal(ev.confusion.matrix, host.confusion.matrix)
            and ev.total == host.total):
        raise AssertionError(f"{label}: the card's Evaluation counts differ from the host's "
                             f"on the same predictions")
    return ev


def early_stopping_char_rnn():
    """EarlyStoppingTrainer on the char-RNN, once with InMemoryModelSaver
    and once with LocalFileModelSaver, from the same start on the same
    data: the same epochs, scores and best epoch; the best model restored
    from its zip onto the card answers bit for bit as the in-memory best.
    Launch counts over both runs (each training batch 4 K3 with the
    reserve and 4 K4; each validation score one K3)."""
    from deeplearning4j_torch import DataSet, ListDataSetIterator
    from deeplearning4j_torch import earlystopping as es

    # one cycle of text for training and validation: something to learn
    f, l = periodic_text(np.random.default_rng(21), TRAIN_B * (ES_TRAIN + ES_VAL), TRAIN_SEQ)
    sets = [DataSet(f[i:i + TRAIN_B], l[i:i + TRAIN_B]) for i in range(0, len(f), TRAIN_B)]
    train, val = sets[:ES_TRAIN], sets[ES_TRAIN:]
    out_dir = Path("build") / "earlystopping"
    shutil.rmtree(out_dir, ignore_errors=True)
    results, times = {}, {}
    reset_counts()
    for kind in ("memory", "file"):
        saver = es.InMemoryModelSaver() if kind == "memory" else \
            es.LocalFileModelSaver(str(out_dir))
        conf = (es.EarlyStoppingConfiguration.builder()
                .score_calculator(es.DataSetLossCalculator(ListDataSetIterator(val)))
                .epoch_termination_conditions(
                    es.MaxEpochsTerminationCondition(ES_MAX_EPOCHS),
                    es.ScoreImprovementEpochTerminationCondition(ES_PATIENCE))
                .model_saver(saver).build())
        net = build_net(char_rnn_conf())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[kind] = es.EarlyStoppingTrainer(conf, net, ListDataSetIterator(train)).fit()
        torch.cuda.synchronize()
        times[kind] = time.perf_counter() - t0
    mem, fil = results["memory"], results["file"]
    scores = {int(e): s for e, s in mem.score_vs_epoch.items()}
    if not (mem.score_vs_epoch == fil.score_vs_epoch and mem.total_epochs == fil.total_epochs
            and mem.best_model_epoch == fil.best_model_epoch):
        raise AssertionError(f"the two early-stopping runs differ: {mem.score_vs_epoch} "
                             f"{fil.score_vs_epoch}")
    if not (np.isfinite(list(scores.values())).all() and mem.best_model is not None):
        raise AssertionError(f"early stopping: scores {scores}, best {mem.best_model}")
    best = fil.best_model
    if best.device != net.device or mem.best_model.device != net.device:
        raise AssertionError(f"the best models are on {best.device} and "
                             f"{mem.best_model.device}, the trained net on {net.device}")
    f, _ = periodic_text(np.random.default_rng(22), TRAIN_B, TRAIN_SEQ)
    same = torch.equal(best.output(f), mem.best_model.output(f))
    if not same:
        raise AssertionError("the best model restored from its zip does not answer bit for "
                             "bit as the in-memory best")
    launches = read_counts()
    want = {n: 0 for n in launches}
    steps = -(-TRAIN_SEQ // TRAIN_T) * ES_TRAIN * (mem.total_epochs + fil.total_epochs)
    epochs = mem.total_epochs + fil.total_epochs
    want.update(lstm2_fwd_train=steps, lstm2_bwd=steps,
                lstm2_fwd=ES_VAL * epochs + 2)          # + the two outputs just compared
    if launches != want:
        raise AssertionError(f"early stopping launched {launches}, expected {want}")
    log(f"early stopping (char-RNN b={TRAIN_B} T={TRAIN_SEQ}, {ES_TRAIN} training and {ES_VAL} "
        f"validation batches): {mem.termination_reason} ({mem.termination_details}) after "
        f"{mem.total_epochs} epochs, best epoch {mem.best_model_epoch}, validation scores "
        f"{scores}; both savers the same run; the zip's best model answers bit for bit as the "
        f"in-memory best; {times['memory']:.2f} s in memory, {times['file']:.2f} s with the "
        f"file saver; launches {launches}")
    return mem.best_model, val, {"scores": scores, "total_epochs": mem.total_epochs,
                                 "best_epoch": mem.best_model_epoch,
                                 "reason": mem.termination_reason, "seconds": times,
                                 "restored_bit_equal": same, "launches": launches}


def evaluate_char_rnn(net, val):
    """``MultiLayerNetwork.evaluate`` on one masked validation batch (K1 a
    layer, the masked route) and one unmasked (one K3), counts held against
    the host path on the same predictions."""
    from deeplearning4j_torch import DataSet, ListDataSetIterator

    ds = val[0]
    lengths = np.random.default_rng(23).integers(TRAIN_SEQ // 2, TRAIN_SEQ + 1, TRAIN_B)
    mask = (np.arange(TRAIN_SEQ)[None, :] < lengths[:, None]).astype(np.float32)
    masked = DataSet(ds.features, ds.labels, mask, mask)
    out = {}
    for kind, batch, want in (("masked", masked, {"lstm_fwd": 2}),
                              ("unmasked", val[1], {"lstm2_fwd": 1})):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev = net.evaluate(ListDataSetIterator([batch]))
        ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts()
        t0 = time.perf_counter()
        net.evaluate(ListDataSetIterator([batch]))           # a second call: warm
        warm_ms = (time.perf_counter() - t0) * 1e3
        expect = {n: 0 for n in launches}
        expect.update(want)
        if launches != expect:
            raise AssertionError(f"evaluate ({kind}) launched {launches}, expected {expect}")
        probs = net.output(batch.features, mask=batch.features_mask)
        held = held_evaluation(f"char-RNN {kind}", batch.labels, probs, batch.labels_mask)
        if not np.array_equal(held.confusion.matrix, ev.confusion.matrix):
            raise AssertionError(f"evaluate ({kind}) counts differ from its output's")
        want_total = int(mask.sum()) if kind == "masked" else TRAIN_B * TRAIN_SEQ
        if ev.total != want_total or ev.host_bytes != 8 * TRAIN_B * TRAIN_SEQ:
            raise AssertionError(f"evaluate ({kind}): {ev.total} steps counted, "
                                 f"{ev.host_bytes} bytes copied to the host")
        out[kind] = {"ms": ms, "warm_ms": warm_ms, "accuracy": ev.accuracy(), "f1": ev.f1(),
                     "total": ev.total, "d2h_bytes": ev.host_bytes, "launches": launches}
        log(f"char-RNN evaluate ({kind}, b={TRAIN_B} T={TRAIN_SEQ}): {ms:.2f} ms, a second "
            f"call {warm_ms:.2f} ms, accuracy "
            f"{ev.accuracy():.4f} over {ev.total} steps, {ev.host_bytes} bytes to the host, "
            f"launches {launches}; counts equal to the host path's")
    return out


def evaluate_lm():
    """``ComputationGraph.evaluate`` of the full-width TransformerLM over
    LM_EVAL_BATCHES batches (8 K5 launches each). Per batch: the forward,
    the on-card reduction (argmax, and the copy of its [b*T] indices), the
    labels' host argmax, and the bytes the evaluation copied to the host;
    the counts held against the host path on the same predictions. Then
    ``InMemoryModelSaver`` deep-copies the graph on the card and the copy
    answers bit for bit."""
    from deeplearning4j_torch import DataSet, ListDataSetIterator
    from deeplearning4j_torch import earlystopping as es
    from deeplearning4j_torch.eval import Evaluation
    from deeplearning4j_torch.nn.graph import ComputationGraph

    net = ComputationGraph(lm_conf()).init()
    rng = np.random.default_rng(24)
    batches = [DataSet(*periodic_tokens(rng, LM_B, LM_T, LM_VOCAB))
               for _ in range(LM_EVAL_BATCHES)]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    whole = net.evaluate(ListDataSetIterator(batches))
    whole_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    expect = {n: 0 for n in launches}
    expect["flash_fwd"] = LM_BLOCKS * LM_EVAL_BATCHES
    if launches != expect:
        raise AssertionError(f"the TransformerLM's evaluate launched {launches}, "
                             f"expected {expect}")
    rows = LM_B * LM_T
    per_batch, merged = [], Evaluation()
    for i, ds in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs = net.output(ds.features)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        ev = held_evaluation(f"TransformerLM batch {i}", ds.labels, probs)
        merged.merge(ev)
        pred_bytes = probs.numel() * probs.element_size()
        if ev.host_bytes != 8 * rows:
            raise AssertionError(f"TransformerLM batch {i}: Evaluation.eval copied "
                                 f"{ev.host_bytes} bytes to the host, not the {8 * rows} of "
                                 f"the index vector")
        per_batch.append({"forward_ms": fwd_ms, "reduction_ms": ev.eval_ms["predictions"],
                          "labels_argmax_ms": ev.eval_ms["labels"],
                          "d2h_bytes": ev.host_bytes, "prediction_bytes": pred_bytes})
        log(f"TransformerLM evaluate batch {i} (b={LM_B} T={LM_T} V={LM_VOCAB}): forward "
            f"{fwd_ms:.2f} ms, reduction on the card {ev.eval_ms['predictions']:.2f} ms, "
            f"labels' host argmax {ev.eval_ms['labels']:.2f} ms ({ds.labels.nbytes} bytes of "
            f"one-hot labels), {ev.host_bytes} bytes copied to the host against "
            f"{pred_bytes} of predictions {tuple(probs.shape)} {probs.dtype}")
        del probs
    if not (np.array_equal(merged.confusion.matrix, whole.confusion.matrix)
            and whole.total == rows * LM_EVAL_BATCHES):
        raise AssertionError("the TransformerLM's evaluate differs from its batches' "
                             "evaluations merged")
    log(f"TransformerLM evaluate over {LM_EVAL_BATCHES} batches: {whole_ms:.1f} ms, accuracy "
        f"{whole.accuracy():.5f} (random weights), launches {launches}")
    # InMemoryModelSaver keeps a graph as a deep copy (the graph has no
    # clone): parameters, states, generators on the card
    saver = es.InMemoryModelSaver()
    t0 = time.perf_counter()
    saver.save_best_model(net, 0.0)
    torch.cuda.synchronize()
    copy_ms = (time.perf_counter() - t0) * 1e3
    twin, f = saver.get_best_model(), batches[0].features
    if twin is net or twin.device != net.device or not torch.equal(twin.output(f),
                                                                   net.output(f)):
        raise AssertionError("the in-memory copy of the TransformerLM does not answer bit "
                             "for bit as the graph")
    log(f"InMemoryModelSaver on the TransformerLM graph: a deep copy on the card in "
        f"{copy_ms:.1f} ms, its output bit-equal to the graph's")
    return {"ms": whole_ms, "accuracy": whole.accuracy(), "batches": per_batch,
            "launches": launches, "deepcopy_ms": copy_ms}


def zoo_evaluations():
    """SimpleCNN (``ModelSelector.select("simplecnn")``, 3x48x48) on the
    LFW fetcher's stand-in and LeNet on ``MnistDataSetIterator``: fit, then
    evaluate; neither path launches K1-K7."""
    from deeplearning4j_torch import DataSet
    from deeplearning4j_torch.datasets.dataset import ExistingDataSetIterator
    from deeplearning4j_torch.datasets.impl import LFWDataSetIterator, MnistDataSetIterator
    from deeplearning4j_torch.models import LeNet, ModelSelector

    out = {}
    scnn = ModelSelector.select("simplecnn", num_classes=SCNN_CLASSES).init()
    c, h, w = scnn.conf.input_type.channels, scnn.conf.input_type.height, \
        scnn.conf.input_type.width
    it = LFWDataSetIterator(batch=SCNN_B, image_size=h, num_classes=SCNN_CLASSES,
                            num_synthetic=SCNN_EXAMPLES)
    mnist = MnistDataSetIterator(batch=LENET_B)
    # LeNet's input type is NCHW 1x28x28; the MNIST rows are 784 wide
    lenet_it = ExistingDataSetIterator(
        [DataSet(ds.features.reshape(-1, 1, 28, 28), ds.labels) for ds in mnist])
    lenet_net = LeNet(num_classes=10).init()
    for name, net, data, synthetic in (
            ("SimpleCNN", scnn, it, it.fetcher.is_synthetic),
            ("LeNet", lenet_net, lenet_it, mnist.fetcher.is_synthetic)):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(data, epochs=ZOO_EPOCHS)
        score = net.score()
        fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ev = net.evaluate(data)
        eval_ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts()
        if any(launches.values()) or not np.isfinite(score) or ev.total == 0:
            raise AssertionError(f"{name}: launches {launches}, score {score}, "
                                 f"{ev.total} evaluated")
        shape = next(iter(data)).features.shape
        out[name] = {"synthetic": bool(synthetic), "fit_s": fit_s, "score": score,
                     "evaluate_ms": eval_ms, "accuracy": ev.accuracy(), "total": ev.total,
                     "d2h_bytes": ev.host_bytes}
        source = "the SYNTHETIC stand-in" if synthetic else "local files"
        log(f"{name} ({net.num_params()} parameters) on {source} {tuple(shape)}: "
            f"{ZOO_EPOCHS} epochs in {fit_s:.2f} s, last loss {score:.4f}; "
            f"evaluate {eval_ms:.1f} ms, accuracy {ev.accuracy():.4f} over {ev.total} "
            f"examples, {ev.host_bytes} bytes to the host")
        if not synthetic:
            raise AssertionError(f"{name}: expected the synthetic stand-in, found data files")
    return out


def evaluation(smi):
    """The evaluation phase: early stopping and evaluate on the char-RNN
    (K1 masked, K3 unmasked, K3/K4 in the early-stopping fits), the
    TransformerLM's evaluate (K5), SimpleCNN and LeNet on the fetchers.
    The fetchers read a data directory under build/ that holds no files."""
    data_dir = Path("build") / "data"
    data_dir.mkdir(parents=True, exist_ok=True)
    os.environ["DL4J_TPU_DATA_DIR"] = str(data_dir.resolve())
    best, val, stopping = early_stopping_char_rnn()
    char_rnn = evaluate_char_rnn(best, val)
    del best
    torch.cuda.empty_cache()
    lm = evaluate_lm()
    torch.cuda.empty_cache()
    zoo = zoo_evaluations()
    torch.cuda.empty_cache()
    return {"card": smi, "early_stopping": stopping, "char_rnn": char_rnn,
            "transformer_lm": lm, "zoo": zoo}


def rf_conf(layers, out, tbptt=False):
    """A bf16 Adam(1e-3) net of ``layers`` then ``out``, as the char-RNN's
    config (TBPTT over TRAIN_T with ``tbptt``)."""
    from deeplearning4j_torch import Adam, NeuralNetConfiguration

    lst = (NeuralNetConfiguration.builder().seed(1).updater(Adam(learning_rate=1e-3))
           .activation("tanh").compute_dtype("bfloat16").list())
    for layer in layers + [out]:
        lst = lst.layer(layer)
    if tbptt:
        lst = (lst.backprop_type("tbptt").t_bptt_forward_length(TRAIN_T)
               .t_bptt_backward_length(TRAIN_T))
    return lst.build()


def rnn_out(n_in, last=False):
    from deeplearning4j_torch.nn.conf.layers import OutputLayer, RnnOutputLayer

    return (OutputLayer if last else RnnOutputLayer)(n_in=n_in, n_out=VOCAB,
                                                     activation="softmax", loss="mcxent")


def masked_text(rng, b, t):
    """periodic_text with right-padded lengths from t * RF_LENGTHS[0] /
    RF_LENGTHS[1] to t (RF_LENGTHS at T=TRAIN_SEQ): (f, l, mask)."""
    f, l = periodic_text(rng, b, t)
    lengths = rng.integers(max(1, t * RF_LENGTHS[0] // RF_LENGTHS[1]), t + 1, b)
    m = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    return f, l, m


def event_ms(fn):
    """Milliseconds of one call of ``fn`` between two CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def alternating_ms(fns, turns=RF_TURNS):
    """Each of ``fns`` ({label: fn}) timed by CUDA events in ``turns``
    turns, the order reversed every other turn: (medians, every turn)."""
    times = {k: [] for k in fns}
    for turn in range(turns):
        for k in (list(fns) if turn % 2 == 0 else list(fns)[::-1]):
            times[k].append(event_ms(fns[k]))
    return {k: float(np.median(v)) for k, v in times.items()}, times


def launches_of(fn, want, label):
    """Run ``fn`` with every count set to 0 just before and read just
    after; the counts must equal ``want`` (names left out: 0)."""
    reset_counts()
    fn()
    got = read_counts()
    expect = {n: want.get(n, 0) for n in got}
    if got != expect:
        raise AssertionError(f"{label} launched {got}, expected {expect}")
    log(f"{label}: launches {({n: c for n, c in got.items() if c})}")
    return got


def card_vs_cpu(label, conf, net, f, l, m):
    """compute_gradient_and_score (and output) on the card against the
    same net on the CPU, where every kernel is its plain version and
    every step loop runs on the CPU, unmasked and masked. A gradient that
    is 0 on the CPU (a frozen layer's) must be 0 on the card."""
    from deeplearning4j_torch import DataSet, MultiLayerNetwork
    from deeplearning4j_torch.utils.trees import leaves, tree_map

    cpu = MultiLayerNetwork(conf).init(
        params={k: tree_map(lambda t: t.cpu(), p) for k, p in net.params.items()},
        device="cpu")
    worst = {}
    for tag, mask in (("unmasked", None), ("masked", m)):
        lm = None if l.ndim == 2 else mask
        ds = DataSet(f, l, mask, lm)
        g_card, s_card = net.compute_gradient_and_score(ds)
        g_cpu, s_cpu = cpu.compute_gradient_and_score(ds)
        s_err = abs(s_card - s_cpu) / abs(s_cpu)
        card, g_err = dict(leaves(g_card)), {}
        for k, g in leaves(g_cpu):
            d, top = (card[k].cpu() - g).abs().max().item(), g.abs().max().item()
            # a frozen layer's gradient is 0 on both sides, bit for bit
            g_err[k] = d / top if top else (0.0 if d == 0 else math.inf)
        key = max(g_err, key=g_err.get)
        o_err = (net.output(f, mask=mask).cpu() - cpu.output(f, mask=mask)).abs().max().item()
        log(f"{label} card vs CPU ({tag}): score {s_card:.4f} vs {s_cpu:.4f} (rel "
            f"{s_err:.2e}), worst gradient {key} rel {g_err[key]:.2e}, output max abs "
            f"{o_err:.2e}")
        if not (s_err <= TRAIN_SCORE_RTOL and g_err[key] <= TRAIN_GRAD_RTOL
                and o_err <= RF_OUT_ATOL):
            raise AssertionError(f"{label}: card and CPU disagree ({tag}): score {s_err}, "
                                 f"{key} {g_err[key]}, output {o_err}")
        worst[tag] = {"score_rel": s_err, "grad_rel": g_err[key], "output_abs": o_err}
    return worst


def bidir_char_rnn(rng):
    """2 x GravesBidirectionalLSTM(H) + RnnOutputLayer: fits (each step 4 K1
    with the reserve and 4 K2, never K3/K4), ``output`` (4 K1), a profile
    of one masked fit (K1's and K2's shares), card against CPU."""
    from deeplearning4j_torch import DataSet, MultiLayerNetwork
    from deeplearning4j_torch.nn.conf.layers import GravesBidirectionalLSTM

    conf = rf_conf([GravesBidirectionalLSTM(n_in=VOCAB, n_out=H),
                    GravesBidirectionalLSTM(n_in=H, n_out=H)], rnn_out(H))
    net = MultiLayerNetwork(conf).init()
    f, l, m = masked_text(rng, TRAIN_B, TRAIN_SEQ)
    ds, mds = DataSet(f, l), DataSet(f, l, m, m)
    losses = {"unmasked": [], "masked": []}

    def fits():
        for tag, data in (("unmasked", ds), ("masked", mds)):
            for _ in range(RF_FITS):
                net.fit(data)
                losses[tag].append(net.score())
    per_step = {"lstm_fwd_train": 4, "lstm_bwd": 4}
    train = launches_of(fits, {k: 2 * RF_FITS * v for k, v in per_step.items()},
                        f"bidir_char_rnn: {2 * RF_FITS} fits of b={TRAIN_B} T={TRAIN_SEQ}")
    out = launches_of(lambda: net.output(f, mask=m), {"lstm_fwd": 4}, "bidir_char_rnn output")
    probs = net.output(f, mask=m)
    check_probabilities("bidir_char_rnn output", probs, (TRAIN_B, TRAIN_SEQ, VOCAB),
                        PROB_SUM_ATOL)
    for tag, ls in losses.items():
        log(f"bidir_char_rnn {tag} loss per fit: " + " ".join(f"{x:.3f}" for x in ls))
        if not np.isfinite(ls).all():
            raise AssertionError(f"bidir_char_rnn {tag} loss is not finite: {ls}")
    if not losses["unmasked"][-1] < losses["unmasked"][0]:
        raise AssertionError(f"bidir_char_rnn: the unmasked loss did not fall: "
                             f"{losses['unmasked']}")
    med, turns = alternating_ms({"unmasked": lambda: net.fit(ds), "masked": lambda: net.fit(mds)})
    log(f"smoke number, not a benchmark: a bidir_char_rnn step {med['unmasked']:.3f} ms "
        f"unmasked, {med['masked']:.3f} ms masked (medians of {RF_TURNS} alternating turns)")
    prof = profile_call("one masked bidir_char_rnn fit", lambda: net.fit(mds))
    shares = {}
    if prof is not None:
        for kernel, key in (("K1 with reserve", "lstm_fwd"), ("K2", "lstm_bwd")):
            k = sum(ms for name, ms in prof["top_ms"].items() if key in name)
            shares[kernel] = {"ms": k, "share_of_busy": k / prof["busy_ms"]}
            log(f"{kernel} in one masked bidir_char_rnn fit: {k:.3f} ms of device time, "
                f"{100 * k / prof['busy_ms']:.1f}% of the fit's {prof['busy_ms']:.3f} ms busy")
    ref = card_vs_cpu("bidir_char_rnn", conf, net, *masked_text(rng, RF_REF_B, RF_REF_T))
    return {"launches": {"train": train, "train_per_step": per_step, "output": out},
            "losses": losses, "step_ms": med, "turns_ms": turns, "profile": prof,
            "kernel_shares": shares, "reference": ref}


def write_sequences(root, rng, n):
    """``n`` CSV sequences of periodic text under ``root``, lengths in
    RF_LENGTHS: each row a character's one-hot features, then the next
    character's id. Returns the paths."""
    cycle = rng.integers(0, VOCAB, 23)
    eye = np.eye(VOCAB, dtype=np.int64)
    paths = []
    for i in range(n):
        t = int(rng.integers(RF_LENGTHS[0], RF_LENGTHS[1] + 1))
        ids = cycle[(int(rng.integers(0, 23)) + np.arange(t + 1)) % 23]
        rows = np.concatenate([eye[ids[:-1]], ids[1:, None]], axis=1)
        path = Path(root) / f"seq_{i:04d}.csv"
        np.savetxt(path, rows, fmt="%d", delimiter=",")
        paths.append(str(path))
    return paths


def last_step_sets(iterator):
    """Each sequence DataSet with its labels at the last valid step ([b,
    VOCAB]) and a per-example labels mask of ones: what LastTimeStep's
    output is held to, by the loss and by ``evaluate``."""
    from deeplearning4j_torch import DataSet

    out = []
    for ds in iterator:
        last = ds.features_mask.sum(1).astype(np.int64) - 1
        labels = ds.labels[np.arange(len(last)), last]
        out.append(DataSet(ds.features, labels, ds.features_mask,
                           np.ones(len(last), np.float32)))
    return out


def bidir_classifier(rng):
    """LastTimeStep(Bidirectional(LSTM(H), concat)) + OutputLayer over CSV
    sequences read by SequenceRecordReaderDataSetIterator: fits (each step
    2 K1 with the reserve and 2 K2, masked), ``evaluate`` (2 K1 a batch),
    card against CPU."""
    import tempfile

    from deeplearning4j_torch import MultiLayerNetwork
    from deeplearning4j_torch.datasets.records import (CSVSequenceRecordReader,
                                                       SequenceRecordReaderDataSetIterator)
    from deeplearning4j_torch.nn.conf.layers import LSTM, Bidirectional, LastTimeStep

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        paths = write_sequences(root, rng, RF_CLS_BATCHES * TRAIN_B)
        t1 = time.perf_counter()
        sets = last_step_sets(SequenceRecordReaderDataSetIterator(
            CSVSequenceRecordReader(paths), TRAIN_B, VOCAB, VOCAB))
        t2 = time.perf_counter()
    log(f"bidir_classifier data: {len(paths)} CSV sequences written in {t1 - t0:.2f} s, read "
        f"into {len(sets)} masked minibatches in {t2 - t1:.2f} s "
        f"(T {[int(d.features.shape[1]) for d in sets]})")
    conf = rf_conf([LastTimeStep(inner=Bidirectional(inner=LSTM(n_in=VOCAB, n_out=H),
                                                     mode="concat"))],
                   rnn_out(2 * H, last=True))
    net = MultiLayerNetwork(conf).init()
    losses = []

    def fits():
        for _ in range(RF_FITS):
            for d in sets:
                net.fit(d)
                losses.append(net.score())
    steps = RF_FITS * len(sets)
    per_step = {"lstm_fwd_train": 2, "lstm_bwd": 2}
    train = launches_of(fits, {k: steps * v for k, v in per_step.items()},
                        f"bidir_classifier: {steps} masked fit steps")
    log("bidir_classifier loss per step: " + " ".join(f"{x:.3f}" for x in losses))
    if not np.isfinite(losses).all():
        raise AssertionError(f"bidir_classifier loss is not finite: {losses}")
    ev = {}
    evaluate = launches_of(lambda: ev.setdefault("e", net.evaluate(sets)),
                           {"lstm_fwd": 2 * len(sets)}, "bidir_classifier evaluate")
    e = ev["e"]
    if e.total != sum(d.num_examples() for d in sets):
        raise AssertionError(f"bidir_classifier evaluate counted {e.total} examples")
    log(f"bidir_classifier evaluate: accuracy {e.accuracy():.4f} over {e.total} sequences")
    med, turns = alternating_ms({f"batch{i}": (lambda d=d: net.fit(d))
                                 for i, d in enumerate(sets)})
    log(f"smoke number, not a benchmark: a bidir_classifier step "
        + ", ".join(f"{k} (T={int(d.features.shape[1])}) {v:.3f} ms"
                    for (k, v), d in zip(med.items(), sets))
        + f" (medians of {RF_TURNS} alternating turns)")
    f, l, m = masked_text(rng, RF_REF_B, RF_REF_T)
    last = m.sum(1).astype(np.int64) - 1
    ref = card_vs_cpu("bidir_classifier", conf, net, f, l[np.arange(RF_REF_B), last], m)
    return {"launches": {"train": train, "train_per_step": per_step, "evaluate": evaluate},
            "losses": losses, "accuracy": e.accuracy(), "step_ms": med, "turns_ms": turns,
            "reference": ref}


def simple_rnn(rng):
    """2 x SimpleRnn(H) + RnnOutputLayer: TBPTT fits and ``rnn_time_step``
    over RF_STREAM_T characters one at a time against ``output`` on them;
    no K1-K4 launch; card against CPU."""
    from deeplearning4j_torch import DataSet, MultiLayerNetwork
    from deeplearning4j_torch.nn.conf.layers import SimpleRnn

    conf = rf_conf([SimpleRnn(n_in=VOCAB, n_out=H), SimpleRnn(n_in=H, n_out=H)], rnn_out(H),
                   tbptt=True)
    net = MultiLayerNetwork(conf).init()
    f, l, m = masked_text(rng, TRAIN_B, TRAIN_SEQ)
    ds, mds = DataSet(f, l), DataSet(f, l, m, m)
    losses = []

    def fits():
        for data in [ds] * RF_FITS + [mds] * RF_FITS:
            net.fit(data)
            losses.append(net.score())
    train = launches_of(fits, {}, f"simple_rnn: {2 * RF_FITS} TBPTT fits")
    if not np.isfinite(losses).all():
        raise AssertionError(f"simple_rnn loss is not finite: {losses}")
    x = periodic_text(rng, GEN_B, RF_STREAM_T)[0]

    def stream():
        net.rnn_clear_previous_state()
        return torch.stack([net.rnn_time_step(x[:, t]) for t in range(RF_STREAM_T)], 1)
    got = {}
    streamed = launches_of(lambda: got.setdefault("s", stream()), {},
                           f"simple_rnn rnn_time_step over {RF_STREAM_T} characters")
    whole = net.output(x)
    err = ((got["s"] - whole).abs().max() / whole.abs().max()).item()
    log(f"simple_rnn stream vs output: {err:.3e} of the largest probability")
    if not (torch.isfinite(got["s"]).all() and err <= GEN_STREAM_RTOL):
        raise AssertionError(f"simple_rnn stream and output disagree: {err}")
    med, turns = alternating_ms({"unmasked": lambda: net.fit(ds), "masked": lambda: net.fit(mds),
                                 "stream": stream})
    log(f"smoke number, not a benchmark: a simple_rnn fit ({TRAIN_SEQ // TRAIN_T} TBPTT "
        f"segments) {med['unmasked']:.3f} ms unmasked, {med['masked']:.3f} ms masked; "
        f"{med['stream'] / RF_STREAM_T:.3f} ms a streamed character at b={GEN_B}")
    ref = card_vs_cpu("simple_rnn", conf, net, *masked_text(rng, RF_REF_B, RF_REF_T))
    return {"launches": {"train": train, "stream": streamed}, "losses": losses,
            "stream_rel_err": err, "step_ms": med, "turns_ms": turns, "reference": ref}


def lstm_step_loop(rng):
    """A softsign GravesLSTM(H) and a tanh GravesLSTM(RF_ODD_H), which the
    kernels decline, fit and answer through the step loop (no K1-K4
    launch, nothing raised), held against the CPU; each timed beside the
    kernel route's tanh GravesLSTM(H) at the same shape."""
    from deeplearning4j_torch import DataSet, MultiLayerNetwork
    from deeplearning4j_torch.nn.conf.layers import GravesLSTM

    nets = {"kernel_tanh": GravesLSTM(n_in=VOCAB, n_out=H),
            "softsign": GravesLSTM(n_in=VOCAB, n_out=H, activation="softsign"),
            f"h{RF_ODD_H}": GravesLSTM(n_in=VOCAB, n_out=RF_ODD_H)}
    f, l, m = masked_text(rng, TRAIN_B, TRAIN_SEQ)
    ds = DataSet(f, l, m, m)
    out, fns = {}, {}
    for name, layer in nets.items():
        conf = rf_conf([layer], rnn_out(layer.n_out))
        net = MultiLayerNetwork(conf).init()
        want = {"lstm_fwd_train": RF_FITS, "lstm_bwd": RF_FITS} if name == "kernel_tanh" else {}
        losses = []

        def fits(net=net, losses=losses):
            for _ in range(RF_FITS):
                net.fit(ds)
                losses.append(net.score())
        train = launches_of(fits, want, f"lstm_step_loop {name}: {RF_FITS} masked fits")
        answer = launches_of(lambda net=net: net.output(f, mask=m),
                             {"lstm_fwd": 1} if name == "kernel_tanh" else {},
                             f"lstm_step_loop {name} output")
        if not np.isfinite(losses).all():
            raise AssertionError(f"lstm_step_loop {name} loss is not finite: {losses}")
        out[name] = {"launches": {"train": train, "output": answer}, "losses": losses}
        if name != "kernel_tanh":
            out[name]["reference"] = card_vs_cpu(f"lstm_step_loop {name}", conf, net,
                                                 *masked_text(rng, RF_REF_B, RF_REF_T))
        fns[name] = (lambda net=net: net.fit(ds))
    med, turns = alternating_ms(fns)
    log(f"smoke number, not a benchmark: a masked fit step of b={TRAIN_B} T={TRAIN_SEQ} "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in med.items())
        + f" (medians of {RF_TURNS} alternating turns)")
    return {"nets": out, "step_ms": med, "turns_ms": turns}


def recurrent_family(smi):
    """The rest of the recurrent family on the card: bidir_char_rnn,
    bidir_classifier, simple_rnn and lstm_step_loop, each driven with the
    counts set to 0 just before and read just after."""
    rng = np.random.default_rng(17)
    t0 = time.perf_counter()
    res = {"card": smi}
    for name, fn in (("bidir_char_rnn", bidir_char_rnn), ("bidir_classifier", bidir_classifier),
                     ("simple_rnn", simple_rnn), ("lstm_step_loop", lstm_step_loop)):
        res[name] = fn(rng)
        torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    log(f"recurrent_family took {res['seconds']:.1f} s")
    return res


def vgg_kernel_group(chain):
    """``kernel_group`` with the dense layers' matrix products (forward and
    backward) as a group of their own."""
    names = " ".join(chain).lower()
    if "dl4j::updater" not in names and any(
            k in names for k in ("aten::mm", "aten::addmm", "aten::matmul", "mmbackward")):
        return "dense GEMMs"
    return kernel_group([names])


def vgg16_main():
    """VGG16's main path at bench.py:195's shape: MultiLayerNetwork.fit under
    CacheMode.DEVICE, VGG_WARM warm-up then VGG_STEPS timed steps,
    ``output`` and one profiled step grouped into cuDNN conv, pooling, the
    dense GEMMs, the updater and elementwise work (``zoo_steps``)."""
    from deeplearning4j_torch.models import ModelSelector
    from deeplearning4j_torch.nn.conf import CacheMode
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork

    conf = ModelSelector.select("vgg16", num_classes=VGG_CLASSES, input_shape=VGG_IMG).conf()
    conf.global_conf.compute_dtype = "bfloat16"
    conf.global_conf.cache_mode = CacheMode.DEVICE
    net = MultiLayerNetwork(conf).init()                 # device defaults to the card
    f, l = zoo_data(np.random.default_rng(0), VGG_B, VGG_IMG, VGG_CLASSES)
    return zoo_steps("VGG16", net, f, l, VGG_WARM, VGG_STEPS, PROB_SUM_ATOL, vgg_kernel_group)


def family_models():
    """VGG19, AlexNet, GoogLeNet, InceptionResNetV1 (5/10/5 blocks) and
    FaceNetNN4Small2, each ``ModelSelector.select(name).init()`` on the card
    (f32) at its zoo input and full width: FAMILY_WARM + FAMILY_STEPS fit
    steps on one batch and ``output`` (``zoo_steps``); FaceNet's centres
    moved for exactly the classes in its batch."""
    from deeplearning4j_torch.models import ModelSelector

    out = {}
    rng = np.random.default_rng(18)
    for name, b in FAMILY_BATCH.items():
        model = ModelSelector.select(name)
        torch.cuda.empty_cache()
        net = model.init()                               # the card, f32
        f, l = zoo_data(rng, b, tuple(model.input_shape), model.num_classes)
        res = zoo_steps(name, net, f, l, FAMILY_WARM, FAMILY_STEPS, FAMILY_PROB_ATOL)
        if name == "facenetnn4small2":
            moved = net.states["output"]["centers"].abs().sum(1).cpu() > 0
            present = torch.from_numpy(l.sum(0) > 0)
            if not torch.equal(moved, present):
                raise AssertionError(f"FaceNet centres moved for {int(moved.sum())} classes, "
                                     f"{int(present.sum())} present in the batch, or others")
            res["centres_moved"] = int(moved.sum())
            log(f"{name}: centres moved for exactly the {res['centres_moved']} classes in "
                f"the batch")
        out[name] = res
        del net
    return out


def sweep_cases():
    """(label, layer config, input shape) of the card-vs-CPU layer sweep."""
    from deeplearning4j_torch.nn.conf import layers as L

    same, trunc = L.ConvolutionMode.Same, L.ConvolutionMode.Truncate
    img = (SWEEP_B, SWEEP_HW, SWEEP_HW, SWEEP_C)
    seq = (SWEEP_B, SWEEP_T, SWEEP_C)
    cases = []
    for mode, s, d, p, k in ((trunc, 1, 1, 0, 3), (trunc, 2, 1, 1, 3), (trunc, 3, 2, 2, 3),
                             (same, 1, 1, 0, 3), (same, 2, 1, 0, 3), (same, 3, 1, 0, 3),
                             (same, 2, 2, 0, 3), (same, 3, 2, 0, 2)):
        cases.append((f"deconv {mode} s{s} d{d} k{k}", L.Deconvolution2D(
            n_in=SWEEP_C, n_out=6, kernel_size=(k, k), stride=(s, s), dilation=(d, d),
            padding=(p, p), convolution_mode=mode, activation="tanh"), img))
    for m in (1, 2):
        cases.append((f"depthwise m{m}", L.DepthwiseConvolution2D(
            n_in=SWEEP_C, n_out=SWEEP_C * m, depth_multiplier=m, kernel_size=(3, 3),
            stride=(2, 2), dilation=(2, 2), convolution_mode=same, activation="tanh"), img))
        cases.append((f"separable m{m}", L.SeparableConvolution2D(
            n_in=SWEEP_C, n_out=6, depth_multiplier=m, kernel_size=(3, 2), stride=(2, 1),
            convolution_mode=same, activation="tanh"), img))
    cases += [
        ("spacetodepth 2", L.SpaceToDepthLayer(block_size=2), img),
        ("lrn n5", L.LocalResponseNormalization(n=5), img),
        ("lrn n4", L.LocalResponseNormalization(n=4, alpha=0.1), img),
        ("conv1d same s2", L.Convolution1DLayer(n_in=SWEEP_C, n_out=6, kernel_size=4, stride=2,
                                                convolution_mode=same, activation="tanh"), seq),
        ("conv1d truncate d2", L.Convolution1DLayer(n_in=SWEEP_C, n_out=6, kernel_size=3,
                                                    dilation=2, padding=1,
                                                    activation="tanh"), seq),
        ("subsampling1d avg", L.Subsampling1DLayer(pooling_type="avg", kernel_size=3,
                                                   stride=2, convolution_mode=same), seq),
        ("subsampling1d pnorm", L.Subsampling1DLayer(pooling_type="pnorm", pnorm=2,
                                                     kernel_size=2, stride=2), seq),
        ("subsampling1d max", L.Subsampling1DLayer(pooling_type="max", kernel_size=3,
                                                   stride=2, padding=1), seq),
        ("upsampling1d", L.Upsampling1D(size=3), seq),
        ("upsampling2d", L.Upsampling2D(size=(2, 3)), img),
        ("zeropadding", L.ZeroPaddingLayer(padding=(1, 2, 0, 3)), img),
        ("zeropadding1d", L.ZeroPadding1DLayer(padding=(2, 1)), seq),
        ("cropping2d", L.Cropping2D(cropping=(1, 0, 2, 3)), img),
    ]
    return cases


def sweep_errors(conf, shape, dtype, device="cuda", seed=0):
    """One layer on ``device`` in ``dtype`` (bf16 compute: f32 parameters,
    bf16 input) against the same layer on the CPU in f64 from the same
    parameters and the same input values: {"output", "input_grad",
    <parameter>: max |dev - cpu| over max |cpu|}."""
    from deeplearning4j_torch.nn.conf import GlobalConfig
    from deeplearning4j_torch.nn.layers import impl_for

    gen = torch.Generator().manual_seed(seed)
    ref = impl_for(conf, GlobalConfig(dtype="float64", compute_dtype="float64"))
    params = {k: v + 0.1 * torch.randn(v.shape, generator=gen, dtype=torch.float64)
              for k, v in ref.init_params(gen).items()}
    ref.set_params(params, "cpu")
    pdt = "float64" if dtype == "float64" else "float32"
    dev = impl_for(conf, GlobalConfig(dtype=pdt, compute_dtype=dtype))
    dev.set_params(params, device)
    x = torch.randn(shape, generator=gen, dtype=torch.float64).to(getattr(torch, dtype))
    xr = x.double().clone().requires_grad_()
    xd = x.to(device).clone().requires_grad_()
    yr = ref(xr, ctx={"train": False})
    yd = dev(xd, ctx={"train": False})
    dy = torch.randn(yr.shape, generator=gen, dtype=torch.float64)
    yr.backward(dy)
    yd.backward(dy.to(device, yd.dtype))

    def rel(got, want):
        return ((got.detach().cpu().double() - want).abs().max()
                / want.abs().max().clamp_min(1e-30)).item()
    errs = {"output": rel(yd, yr.detach()), "input_grad": rel(xd.grad, xr.grad)}
    for k, p in ref.param_dict().items():
        errs[k] = rel(dev.param_dict()[k].grad, p.grad)
    return errs


def layer_sweep(device="cuda"):
    """Every case of ``sweep_cases`` on ``device`` in f64 and in bf16 against
    the CPU in f64, at SWEEP_LIMITS (max pooling in f64 only: bf16 input
    rounding can tie a window, whose gradient then goes elsewhere). The
    count of K1-K7 launches must stay 0."""
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the card-vs-CPU sweep needs TF32 off")
    reset_counts()
    worst, bad = {}, []
    for label, conf, shape in sweep_cases():
        for dtype, limit in SWEEP_LIMITS.items():
            if dtype == "bfloat16" and label.endswith("max"):
                continue
            errs = sweep_errors(conf, shape, dtype, device)
            q = max(errs, key=errs.get)
            worst[f"{label} {dtype}"] = {"worst": q, "error": errs[q]}
            if not errs[q] <= limit:
                bad.append((label, dtype, q, errs[q]))
    launches = read_counts()
    for dtype, limit in SWEEP_LIMITS.items():
        e = {k: v for k, v in worst.items() if k.endswith(dtype)}
        k = max(e, key=lambda n: e[n]["error"])
        log(f"card vs CPU f64, {len(e)} CNN-family layer cases in {dtype}: worst {k} "
            f"({e[k]['worst']}) {e[k]['error']:.2e} (limit {limit:.0e})")
    if bad or any(launches.values()):
        raise AssertionError(f"card and CPU disagree: {bad}; launches {launches}")
    return {"cases": worst, "limits": SWEEP_LIMITS, "launches": launches}


def layout_profiles(device="cuda"):
    """One bf16 forward and backward of Deconvolution2D (SAME, stride 2),
    DepthwiseConvolution2D (m 2), SeparableConvolution2D (m 2) and
    Convolution1DLayer at b=LAYOUT_B on LAYOUT_HW^2 x LAYOUT_C, each
    profiled: its device ms and the device ms of any NCHW/NHWC
    transposition kernel (the channels-last views should need none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_torch.nn.conf import GlobalConfig
    from deeplearning4j_torch.nn.conf import layers as L
    from deeplearning4j_torch.nn.layers import impl_for

    c, same = LAYOUT_C, L.ConvolutionMode.Same
    img = (LAYOUT_B, LAYOUT_HW, LAYOUT_HW, c)
    cases = {
        "deconv same s2": (L.Deconvolution2D(n_in=c, n_out=c, kernel_size=(3, 3), stride=(2, 2),
                                             convolution_mode=same), img),
        "depthwise m2": (L.DepthwiseConvolution2D(n_in=c, n_out=2 * c, depth_multiplier=2,
                                                  kernel_size=(3, 3), convolution_mode=same), img),
        "separable m2": (L.SeparableConvolution2D(n_in=c, n_out=c, depth_multiplier=2,
                                                  kernel_size=(3, 3), convolution_mode=same), img),
        "conv1d": (L.Convolution1DLayer(n_in=c, n_out=c, kernel_size=5, convolution_mode=same),
                   (LAYOUT_B, LAYOUT_HW * LAYOUT_HW, c)),
    }
    out = {}
    gc = GlobalConfig(compute_dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    for label, (conf, shape) in cases.items():
        impl = impl_for(conf, gc)
        impl.set_params(impl.init_params(gen), device)
        x = torch.randn(shape, device=device, dtype=torch.bfloat16).requires_grad_()

        def run():
            impl(x).float().square().sum().backward()
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        kernels = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        trans = [(n, us) for n, us in kernels
                 if any(w in n.lower() for w in ("nchwtonhwc", "nhwctonchw"))]
        out[label] = {"device_ms": sum(us for _, us in kernels) / 1e3,
                      "kernels": len(kernels),
                      "transposition_ms": sum(us for _, us in trans) / 1e3,
                      "transposition_kernels": sorted({n[:100] for n, _ in trans})}
        log(f"layout of {label} (b={LAYOUT_B}, {shape[1:]} bf16, forward + backward): "
            f"{out[label]['device_ms']:.3f} device ms in {len(kernels)} kernels, of which "
            f"NCHW/NHWC transpositions {out[label]['transposition_ms']:.3f} ms "
            f"{out[label]['transposition_kernels'] or ''}")
    return out


def cnn_family(smi):
    """The rest of the CNN family on the card: VGG16 at bench.py:195's
    shape, the five other zoo models, the card-vs-CPU layer sweep and the
    layout profiles, each driven with the counts set to 0 just before and
    read just after (they must read 0)."""
    t0 = time.perf_counter()
    res = {"card": smi, "vgg16": vgg16_main()}
    torch.cuda.empty_cache()
    res["models"] = family_models()
    torch.cuda.empty_cache()
    res["sweep"] = layer_sweep()
    reset_counts()
    res["layouts"] = layout_profiles()
    launches = read_counts()
    if any(launches.values()):
        raise AssertionError(f"the layout profiles launched LSTM or flash kernels: {launches}")
    res["seconds"] = time.perf_counter() - t0
    log(f"cnn_family took {res['seconds']:.1f} s")
    return res


def frozen_params(net, keys):
    """Copies of the parameters of the layers ``keys`` (for bit-equality)."""
    return {k: {n: t.clone() for n, t in net.params[k].items()} for k in keys}


def moved_params(net, saved):
    """The saved parameters that are no longer bit-equal."""
    return [f"{k}/{n}" for k, ps in saved.items() for n, t in ps.items()
            if not torch.equal(net.params[k][n], t)]


def fit_steps(net, ds, steps):
    """``steps`` fit steps on ``ds`` in one fit, ended by a sync."""
    from deeplearning4j_torch import ListDataSetIterator

    def run():
        net.fit(ListDataSetIterator([ds] * steps))
        net.score()
    return run


def transfer_vgg16():
    """VGG16 at bench.py:195's shape (bf16, Adam, CacheMode.DEVICE),
    ``TransferLearning.Builder(net).set_feature_extractor(TL_FROZEN)
    .n_out_replace(TL_FROZEN + 1, TL_CLASSES, "xavier")`` (the dl4j-examples'
    EditLastLayerOthersFrozen): its fit steps against the full network's in
    TL_TURNS alternating turns, one profiled step (no backward convolution
    or max-pool backward, the updater given the head only), the frozen
    layers bit-equal after every step, peak memory of each net alone; then
    ``TransferLearningHelper`` at fc2 (FitFromFeaturized)."""
    from deeplearning4j_torch import DataSet, TransferLearning, TransferLearningHelper
    from deeplearning4j_torch.models import ModelSelector
    from deeplearning4j_torch.nn.conf import CacheMode
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork

    conf = ModelSelector.select("vgg16", num_classes=VGG_CLASSES, input_shape=VGG_IMG).conf()
    conf.global_conf.compute_dtype = "bfloat16"
    conf.global_conf.cache_mode = CacheMode.DEVICE
    full = MultiLayerNetwork(conf).init()                # device defaults to the card
    rng = np.random.default_rng(19)
    f, l = zoo_data(rng, VGG_B, VGG_IMG, VGG_CLASSES)
    ds = DataSet(f, l)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fit_steps(full, ds, 2)()
    full_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tl = (TransferLearning.Builder(full).set_feature_extractor(TL_FROZEN)
          .n_out_replace(TL_FROZEN + 1, TL_CLASSES, "xavier").build())
    frozen = [str(i) for i in range(TL_FROZEN + 1)]
    saved = frozen_params(tl, frozen)
    tds = DataSet(f, np.eye(TL_CLASSES, dtype=np.float32)[rng.integers(0, TL_CLASSES, VGG_B)])
    losses = record_losses(tl)
    fit_steps(tl, tds, 2)()
    med, turns = alternating_ms({"full": fit_steps(full, ds, TL_STEPS),
                                 "transfer": fit_steps(tl, tds, TL_STEPS)}, TL_TURNS)
    step_ms = {k: v / TL_STEPS for k, v in med.items()}
    log(f"VGG16 b={VGG_B} frozen through layer {TL_FROZEN} (fc2), {TL_CLASSES}-way head: "
        f"{step_ms['transfer']:.2f} ms a step against the full step's {step_ms['full']:.2f} "
        f"(medians of {TL_TURNS} alternating turns of {TL_STEPS} steps: "
        + ", ".join(f"{k} " + " ".join(f"{t / TL_STEPS:.2f}" for t in v) for k, v in turns.items())
        + ")")
    given = []
    real_apply = tl.updater.apply

    def spy(state, grads, iteration):
        given.append(sorted(k for k, g in grads.items() if g))
        return real_apply(state, grads, iteration)
    tl.updater.apply = spy                # profile_call tags it, then removes both
    prof = profile_call("one transferred VGG16 step", lambda: tl.fit(tds), tl.updater,
                        forbid=("dgrad", "wgrad", "nchwtonhwc", "nhwctonchw",
                                "convolution_backward", "max_pool2d_with_indices_backward"),
                        group=vgg_kernel_group)
    if given != [[str(TL_FROZEN + 1)]]:
        raise AssertionError(f"the updater was given layers {given}, not the head alone")
    moved = moved_params(tl, saved)
    losses = [float(x) for x in losses]
    if moved or not np.isfinite(losses).all():
        raise AssertionError(f"frozen VGG16 parameters moved: {moved}; losses {losses}")
    log(f"transferred VGG16: layers 0-{TL_FROZEN} bit-equal after {len(losses)} steps; "
        f"the profiled step ran no backward convolution or pooling and gave the updater "
        f"layer {TL_FROZEN + 1} only; losses " + " ".join(f"{x:.3f}" for x in losses))
    del full
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fit_steps(tl, tds, 2)()
    tl_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"peak memory: transferred VGG16 {tl_peak:.2f} GiB, the full VGG16 {full_peak:.2f} GiB")
    if not tl_peak < full_peak:
        raise AssertionError(f"the transferred step's peak {tl_peak:.2f} GiB is not below the "
                             f"full step's {full_peak:.2f}")
    helper = TransferLearningHelper(tl, TL_FROZEN)
    t0 = time.perf_counter()
    feat = helper.featurize(tds)
    featurize_s = time.perf_counter() - t0
    want = tl.output(f)
    got = helper.output_from_featurized(feat.features)
    out_err = ((got - want).abs().max() / want.abs().max()).item()
    if feat.features.shape != (VGG_B, 4096) or not out_err <= PROB_SUM_ATOL:
        raise AssertionError(f"featurized {feat.features.shape}; output_from_featurized vs "
                             f"the transferred net's output {out_err:.2e}")
    helper.fit_featurized(feat)                           # warm-up
    feat_ms = event_ms(lambda: [helper.fit_featurized(feat) for _ in range(TL_STEPS)]) / TL_STEPS
    check_probabilities("output_from_featurized", helper.output_from_featurized(feat.features),
                        (VGG_B, TL_CLASSES), PROB_SUM_ATOL)
    log(f"TransferLearningHelper at fc2: featurize {featurize_s:.2f} s ({VGG_B} x 4096), "
        f"output_from_featurized vs the transferred net {out_err:.2e} of the largest "
        f"probability, fit_featurized {feat_ms:.3f} ms a step")
    return {"step_ms": step_ms, "turns_ms": turns, "steps": TL_STEPS, "profile": prof,
            "updater_layers": given, "peak_gib": {"transfer": tl_peak, "full": full_peak},
            "losses": losses, "featurize_s": featurize_s, "fit_featurized_ms": feat_ms,
            "featurized_output_err": out_err}


def transfer_resnet50():
    """ResNet50 at bench.py:187's shape through ``TransferLearning.GraphBuilder
    (net).set_feature_extractor("gap").n_out_replace("output", R50_TL_CLASSES)``:
    one warm-up and TL_STEPS timed steps; every frozen parameter bit-equal,
    every frozen BN layer's running statistics moved (the training forward
    normalises by the batch, as in the JAX package), the head moved; peak
    memory of a step of each net, the full one first."""
    from deeplearning4j_torch import DataSet, TransferLearning
    from deeplearning4j_torch.models import ResNet50
    from deeplearning4j_torch.nn.conf import CacheMode
    from deeplearning4j_torch.nn.graph import ComputationGraph
    from deeplearning4j_torch.nn.layers.wrapper import FrozenImpl

    conf = ResNet50(num_classes=R50_CLASSES, input_shape=R50_IMG).conf()
    conf.global_conf.compute_dtype = "bfloat16"
    conf.global_conf.cache_mode = CacheMode.DEVICE
    net = ComputationGraph(conf).init()
    full_ds = DataSet(*zoo_data(np.random.default_rng(25), R50_B, R50_IMG, R50_CLASSES))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fit_steps(net, full_ds, 1)()
    full_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tl = (TransferLearning.GraphBuilder(net).set_feature_extractor("gap")
          .n_out_replace("output", R50_TL_CLASSES).build())
    del net, full_ds
    torch.cuda.empty_cache()
    frozen = [n for n, impl in tl.impls.items() if isinstance(impl, FrozenImpl)]
    saved = frozen_params(tl, frozen)
    stats = {n: {k: v.clone() for k, v in tl.states[n].items()} for n in frozen if tl.states[n]}
    head = tl.params["output"]["W"].clone()
    f, l = zoo_data(np.random.default_rng(20), R50_B, R50_IMG, R50_TL_CLASSES)
    ds = DataSet(f, l)
    losses = record_losses(tl)
    torch.cuda.reset_peak_memory_stats()
    fit_steps(tl, ds, 1)()
    step_ms = event_ms(fit_steps(tl, ds, TL_STEPS)) / TL_STEPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x) for x in losses]
    still = [n for n, s in stats.items() for k, v in s.items() if torch.equal(tl.states[n][k], v)]
    moved = moved_params(tl, saved)
    if (set(tl.impls) - set(frozen) != {"output"} or len(stats) != 53 or still or moved
            or torch.equal(tl.params["output"]["W"], head) or not np.isfinite(losses).all()):
        raise AssertionError(f"transferred ResNet50: frozen {len(frozen)}, BN layers "
                             f"{len(stats)}, statistics that did not move {still}, frozen "
                             f"parameters that moved {moved}, losses {losses}")
    log(f"ResNet50 b={R50_B} frozen at gap ({len(frozen)} layer vertices), "
        f"{R50_TL_CLASSES}-way head: {step_ms:.2f} ms a step over {TL_STEPS}, peak "
        f"{peak:.2f} GiB against the full step's {full_peak:.2f}; frozen parameters "
        f"bit-equal, the running statistics of all {len(stats)} frozen BN layers moved; "
        f"losses " + " ".join(f"{x:.3f}" for x in losses))
    return {"step_ms": step_ms, "steps": TL_STEPS,
            "peak_gib": {"transfer": peak, "full": full_peak}, "frozen": len(frozen),
            "bn_moved": len(stats), "losses": losses}


def transfer_char_rnn():
    """The char-RNN of bench.py:230 with layer 0 frozen
    (``set_feature_extractor(0)``), TL_CHAR_FITS fits of TRAIN_B x
    TRAIN_SEQ (TBPTT segments of TRAIN_T): per segment one K1 without the
    reserve (the frozen layer: no gradient needs its forward), one K1 with
    it and one K2 for layer 1, no K3 or K4 (a frozen layer is no LSTM pair);
    layer 0 bit-equal; the fit timed against the unfrozen net's (K3 + K4);
    then the frozen net's score, gradients and output on the card against
    the CPU at one segment's shape (``card_vs_cpu``)."""
    from deeplearning4j_torch import DataSet, TransferLearning

    net = build_net(char_rnn_conf())
    tl = TransferLearning.Builder(net).set_feature_extractor(0).build()
    ds = DataSet(*periodic_text(np.random.default_rng(21), TRAIN_B, TRAIN_SEQ))
    saved = frozen_params(tl, ["0"])
    tl.fit(ds)
    net.fit(ds)
    per_fit = -(-TRAIN_SEQ // TRAIN_T)
    segs = per_fit * TL_CHAR_FITS
    launches = launches_of(lambda: [tl.fit(ds) for _ in range(TL_CHAR_FITS)],
                           {"lstm_fwd": segs, "lstm_fwd_train": segs, "lstm_bwd": segs},
                           f"char-RNN frozen at layer 0, {TL_CHAR_FITS} fits")
    med, turns = alternating_ms({"frozen": lambda: tl.fit(ds), "unfrozen": lambda: net.fit(ds)},
                                RF_TURNS)
    moved = moved_params(tl, saved)
    if moved or not np.isfinite(float(tl.score())):
        raise AssertionError(f"the frozen char-RNN layer moved ({moved}) or its loss is not "
                             f"finite")
    log(f"char-RNN frozen at layer 0: {med['frozen']:.2f} ms a fit against the unfrozen "
        f"{med['unfrozen']:.2f} (K3 + K4), medians of {RF_TURNS} alternating turns; the "
        f"frozen layer's K1 writes no reserve; layer 0 bit-equal")
    # one TBPTT segment's shape: the frozen layer's K1 runs without the reserve
    ref = card_vs_cpu("char-RNN frozen at layer 0", tl.conf, tl,
                      *masked_text(np.random.default_rng(24), TRAIN_B, TRAIN_T))
    return {"launches": launches, "fit_ms": med, "turns_ms": turns, "fits": TL_CHAR_FITS,
            "segments_a_fit": per_fit, "reference": ref}


def binary_images(rng, b, n=784):
    """MNIST-like binary rows: strokes of a few random prototypes with
    pixels flipped (data with something to model)."""
    protos = rng.random((10, n)) < 0.2
    rows = protos[rng.integers(0, 10, b)] ^ (rng.random((b, n)) < 0.03)
    return rows.astype(np.float32)


def pretrain_reference(label, impl, x):
    """One pretrain loss and its gradients on the card (``impl``, f32)
    against the same layer on the CPU in f64 from the same parameters and
    input, replaying the card's draws: (loss rel err, worst gradient rel
    err), each at most PRE_REF_RTOL."""
    from deeplearning4j_torch.nn.layers import impl_for

    def loss_and_grads(layer, p, xin, replay):
        p = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
        with recorded_draws(draws, replay=replay):
            loss = layer.pretrain_loss(xin, torch.Generator().manual_seed(5), p=p)
        return loss, dict(zip(p, torch.autograd.grad(loss, list(p.values()))))

    draws = []
    loss, grads = loss_and_grads(impl, impl.param_dict(), x, False)
    gc = copy.deepcopy(impl.gc)
    gc.dtype = gc.compute_dtype = "float64"
    cpu = impl_for(impl.conf, gc)
    ref, rgrads = loss_and_grads(cpu, {k: v.detach().double().cpu()
                                       for k, v in impl.param_dict().items()},
                                 x.double().cpu(), True)
    if draws:
        raise AssertionError(f"{label}: {len(draws)} draws not replayed")
    l_err = abs(loss.item() - ref.item()) / abs(ref.item())
    g_err = {k: ((grads[k].cpu().double() - g).abs().max() / g.abs().max()).item()
             for k, g in rgrads.items()}
    worst = max(g_err, key=g_err.get)
    log(f"{label} pretrain loss card (f32) vs CPU (f64): {loss.item():.6f} vs {ref.item():.6f} "
        f"(rel {l_err:.2e}), worst gradient {worst} rel {g_err[worst]:.2e}")
    if not (l_err <= PRE_REF_RTOL and g_err[worst] <= PRE_REF_RTOL):
        raise AssertionError(f"{label}: card and CPU disagree: loss {l_err}, {worst} "
                             f"{g_err[worst]}")
    return {"loss_rel": l_err, "grad_rel": g_err[worst], "worst": worst}


def pretrain_ms(net, i, ds):
    """ms a ``pretrain_layer(i)`` iteration: one warm-up, then PRE_ITERS."""
    from deeplearning4j_torch import ListDataSetIterator

    net.pretrain_layer(i, ListDataSetIterator([ds]))
    net.score()
    return event_ms(lambda: (net.pretrain_layer(i, ListDataSetIterator([ds] * PRE_ITERS)),
                             net.score())) / PRE_ITERS


def pretrain_mnist():
    """Pretraining at the MNIST widths of the dl4j-examples, b=PRE_B, f32:
    the stacked RBMs of DeepAutoEncoderExample (binary units, CD-1, each
    on the activations of the ones below), an AutoEncoder (corruption 0.3)
    and the VAE of VaeMNISTAnomaly (Bernoulli reconstruction; its
    ``reconstruction_log_probability`` over PRE_VAE_SAMPLES samples): ms an
    iteration of each layer, finite losses, one step of the first RBM, the
    last RBM (on its input), the AutoEncoder and the VAE against the CPU
    in f64."""
    from deeplearning4j_torch import DataSet, NeuralNetConfiguration, Sgd, Adam
    from deeplearning4j_torch.nn.conf import layers as L
    from deeplearning4j_torch.nn.conf.reconstruction import BernoulliReconstructionDistribution
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork

    rng = np.random.default_rng(22)
    x = binary_images(rng, PRE_B)
    ds = DataSet(x, np.eye(10, dtype=np.float32)[rng.integers(0, 10, PRE_B)])
    res = {}
    b = NeuralNetConfiguration.builder().seed(123).updater(Sgd(learning_rate=0.1)).list()
    for n_in, n_out in zip(PRE_RBM[:-1], PRE_RBM[1:]):
        b.layer(L.RBM(n_in=n_in, n_out=n_out, activation="sigmoid"))
    rbms = MultiLayerNetwork(b.layer(L.OutputLayer(n_in=PRE_RBM[-1], n_out=10,
                                                   activation="softmax")).build()).init()
    xd = torch.from_numpy(x).to(rbms.device)
    n = len(PRE_RBM) - 1
    res["rbm_reference"] = {"0": pretrain_reference("RBM 784-1000", rbms.impls[0], xd)}
    res["rbm_ms"] = [pretrain_ms(rbms, i, ds) for i in range(n)]
    last = rbms.feed_forward_to_layer(n - 2, xd)
    res["rbm_reference"][str(n - 1)] = pretrain_reference(f"RBM {PRE_RBM[-2]}-{PRE_RBM[-1]}",
                                                          rbms.impls[n - 1], last)
    res["rbm_score"] = rbms.score()
    ae = MultiLayerNetwork(NeuralNetConfiguration.builder().seed(123)
                           .updater(Adam(learning_rate=1e-3)).activation("sigmoid").list()
                           .layer(L.AutoEncoder(n_in=PRE_AE[0], n_out=PRE_AE[1],
                                                corruption_level=0.3))
                           .layer(L.OutputLayer(n_in=PRE_AE[1], n_out=10, activation="softmax"))
                           .build()).init()
    res["autoencoder_reference"] = pretrain_reference("AutoEncoder", ae.impls[0], xd)
    res["autoencoder_ms"] = pretrain_ms(ae, 0, ds)
    res["autoencoder_score"] = ae.score()
    vae = MultiLayerNetwork(NeuralNetConfiguration.builder().seed(123)
                            .updater(Adam(learning_rate=1e-3)).list()
                            .layer(L.VariationalAutoencoder(
                                n_in=784, n_out=PRE_VAE_LATENT, activation="leakyrelu",
                                encoder_layer_sizes=PRE_VAE_HIDDEN,
                                decoder_layer_sizes=PRE_VAE_HIDDEN, pzx_activation="identity",
                                reconstruction_distribution=BernoulliReconstructionDistribution()))
                            .pretrain(True).backprop(False).build()).init()
    res["vae_reference"] = pretrain_reference("VAE", vae.impls[0], xd)
    res["vae_ms"] = pretrain_ms(vae, 0, ds)
    res["vae_score"] = vae.score()
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        vae.impls[0].reconstruction_log_probability(xd, gen, PRE_VAE_SAMPLES)
        res["vae_log_prob_ms"] = event_ms(lambda: vae.impls[0].reconstruction_log_probability(
            xd, gen, PRE_VAE_SAMPLES))
        lp = vae.impls[0].reconstruction_log_probability(xd, gen, PRE_VAE_SAMPLES)
    scores = [res["rbm_score"], res["autoencoder_score"], res["vae_score"]]
    if tuple(lp.shape) != (PRE_B,) or not torch.isfinite(lp).all() or not np.isfinite(scores).all():
        raise AssertionError(f"pretraining: scores {scores}, log p(x) {tuple(lp.shape)}")
    res["vae_log_prob_mean"] = lp.mean().item()
    log(f"pretraining b={PRE_B} (f32), ms an iteration: RBMs "
        + " ".join(f"{a}-{c} {m:.3f}" for a, c, m in zip(PRE_RBM, PRE_RBM[1:], res["rbm_ms"]))
        + f"; AutoEncoder {res['autoencoder_ms']:.3f}; VAE {res['vae_ms']:.3f}; the VAE's "
        f"reconstruction_log_probability ({PRE_VAE_SAMPLES} samples) "
        f"{res['vae_log_prob_ms']:.3f} ms, mean {res['vae_log_prob_mean']:.2f}")
    return res


def yolo_labels(rng, b, grid, classes, per_image=3):
    """[b, 4 + classes, grid, grid]: ``per_image`` boxes of 0.5-4 cells, each
    in the cell of its centre, with a one-hot class."""
    labels = np.zeros((b, 4 + classes, grid, grid), np.float32)
    for m in range(b):
        for _ in range(per_image):
            i, j = rng.integers(0, grid, 2)
            w, h = rng.uniform(0.5, 4.0, 2)
            cx, cy = j + rng.uniform(0.05, 0.95), i + rng.uniform(0.05, 0.95)
            labels[m, :, i, j] = 0
            labels[m, :4, i, j] = [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]
            labels[m, 4 + rng.integers(0, classes), i, j] = 1.0
    return labels


def yolo2_head():
    """Yolo2OutputLayer at TinyYOLO's head: the loss and its input gradient
    at [YOLO_B, 13, 13, 5B + C] = [YOLO_B, 13, 13, 45] (the JAX layer's
    layout: classes shared by the B anchors, not DL4J's B(5 + C) = 125;
    ROADMAP Queue C) on the card (f32) against the CPU in f64, the
    loss and backward timed; then YOLO_STEPS Adam fit steps of a small
    convolutional trunk ending in it (finite losses, ``output``'s class
    rows summing to 1) and one profiled step."""
    from deeplearning4j_torch import DataSet, NeuralNetConfiguration, Adam
    from deeplearning4j_torch.nn.conf import GlobalConfig
    from deeplearning4j_torch.nn.conf import layers as L
    from deeplearning4j_torch.nn.conf.inputs import InputType
    from deeplearning4j_torch.nn.layers import impl_for
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork

    rng = np.random.default_rng(23)
    n_box, g = len(YOLO_ANCHORS), YOLO_GRID
    width = 5 * n_box + YOLO_CLASSES
    same = L.ConvolutionMode.Same
    trunk = MultiLayerNetwork(
        NeuralNetConfiguration.builder().seed(7).updater(Adam(learning_rate=1e-3))
        .activation("leakyrelu").list()
        .layer(L.ConvolutionLayer(n_out=16, kernel_size=(3, 3), convolution_mode=same))
        .layer(L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        .layer(L.ConvolutionLayer(n_out=32, kernel_size=(3, 3), convolution_mode=same))
        .layer(L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        .layer(L.ConvolutionLayer(n_out=width, kernel_size=(1, 1), activation="identity"))
        .layer(L.Yolo2OutputLayer(boxes=YOLO_ANCHORS))
        .set_input_type(InputType.convolutional(4 * g, 4 * g, 3)).build()).init()
    card = trunk.device
    conf = L.Yolo2OutputLayer(boxes=YOLO_ANCHORS)
    x = rng.normal(scale=0.8, size=(YOLO_B, g, g, width)).astype(np.float32)
    labels = yolo_labels(rng, YOLO_B, g, YOLO_CLASSES)
    out = {}
    for dev, dtype in ((card, "float32"), (torch.device("cpu"), "float64")):
        impl = impl_for(conf, GlobalConfig(dtype=dtype, compute_dtype=dtype))
        xt = torch.from_numpy(x).to(dev, getattr(torch, dtype)).requires_grad_()
        lt = torch.from_numpy(labels).to(dev, getattr(torch, dtype))
        loss = impl.loss_on(xt, lt)
        out[dtype] = (loss, torch.autograd.grad(loss, xt)[0])
    (loss, grad), (ref, rgrad) = out["float32"], out["float64"]
    l_err = abs(loss.item() - ref.item()) / abs(ref.item())
    g_err = ((grad.cpu().double() - rgrad).abs().max() / rgrad.abs().max()).item()
    log(f"Yolo2 loss at [{YOLO_B}, {g}, {g}, {width}] card (f32) vs CPU (f64): "
        f"{loss.item():.5f} vs {ref.item():.5f} (rel {l_err:.2e}), input gradient rel "
        f"{g_err:.2e}")
    if not (l_err <= YOLO_REF_RTOL and g_err <= YOLO_REF_RTOL):
        raise AssertionError(f"Yolo2 card and CPU disagree: loss {l_err}, gradient {g_err}")
    impl = impl_for(conf, GlobalConfig())
    xt = torch.from_numpy(x).to(card).requires_grad_()
    lt = torch.from_numpy(labels).to(card)
    loss_ms = cuda_ms(lambda: torch.autograd.grad(impl.loss_on(xt, lt), xt), 10)
    f = rng.normal(size=(YOLO_B, 3, 4 * g, 4 * g)).astype(np.float32)
    ds = DataSet(f, labels)
    losses = record_losses(trunk)
    fit_steps(trunk, ds, 1)()
    step_ms = event_ms(fit_steps(trunk, ds, YOLO_STEPS)) / YOLO_STEPS
    prof = profile_call("one Yolo2 trunk step", lambda: trunk.fit(ds), trunk.updater)
    losses = [float(v) for v in losses]
    y = trunk.output(f)
    probs = y[..., 5 * n_box:]
    check_probabilities("Yolo2 trunk class", probs.reshape(-1, YOLO_CLASSES),
                        (YOLO_B * g * g, YOLO_CLASSES), 1e-5)
    if tuple(y.shape) != (YOLO_B, g, g, width) or not np.isfinite(losses).all():
        raise AssertionError(f"Yolo2 trunk: output {tuple(y.shape)}, losses {losses}")
    log(f"Yolo2 loss + input gradient {loss_ms:.3f} ms on the card; trunk b={YOLO_B} "
        f"{4 * g}x{4 * g}: {step_ms:.2f} ms a fit step, losses "
        + " ".join(f"{v:.3f}" for v in losses))
    return {"loss_rel": l_err, "grad_rel": g_err, "loss_grad_ms": loss_ms,
            "trunk_step_ms": step_ms, "trunk_losses": losses, "trunk_profile": prof}


def transfer_pretrain(smi):
    """Transfer learning and pretraining on the card (VGG16, ResNet50, the
    char-RNN frozen at layer 0, the MNIST-width pretrain layers, Yolo2),
    each path driven with the counts set to 0 just before and read just
    after: the char-RNN launches K1 and K2 only, the others none."""
    t0 = time.perf_counter()
    res = {"card": smi}
    for name, fn in (("vgg16", transfer_vgg16), ("resnet50", transfer_resnet50),
                     ("pretrain", pretrain_mnist), ("yolo2", yolo2_head)):
        reset_counts()
        res[name] = fn()
        launches = read_counts()
        if any(launches.values()):
            raise AssertionError(f"transfer_pretrain {name} launched LSTM or flash kernels: "
                                 f"{launches}")
        torch.cuda.empty_cache()
    res["char_rnn"] = transfer_char_rnn()
    res["seconds"] = time.perf_counter() - t0
    log(f"transfer_pretrain took {res['seconds']:.1f} s")
    return res


def keras_vgg16_model(rng):
    """Keras ``applications.VGG16`` with its top (include_top: 13 Conv2D 3x3
    SAME relu in five blocks, each ending in MaxPooling2D 2x2, Flatten,
    fc1/fc2 Dense(4096, relu), predictions Dense(1000, softmax)) at a
    224x224x3 input, as a Keras 3 Functional ``model_config`` (the inbound-
    node layout of tests/resources/keras/functional_inception.h5), its
    ``training_config`` and random weights from ``rng`` in Keras's layouts
    (HWIO kernels, He-scaled; dense kernels [in, out] with the Flatten's
    rows in (h, w, c) order)."""
    def inbound(src, shape):
        return [{"args": [{"class_name": "__keras_tensor__",
                           "config": {"shape": [None, *shape], "dtype": "float32",
                                      "keras_history": [src, 0, 0]}}], "kwargs": {}}]

    def normal(shape, scale):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    h, w, c = KV_IMG
    layers = [{"class_name": "InputLayer", "name": "input_layer", "inbound_nodes": [],
               "config": {"batch_shape": [None, h, w, c], "dtype": "float32",
                          "name": "input_layer"}}]
    weights, prev = {}, "input_layer"
    for bi, widths in enumerate(KV_BLOCKS, 1):
        for ci, n in enumerate(widths, 1):
            name = f"block{bi}_conv{ci}"
            layers.append({"class_name": "Conv2D", "name": name,
                           "inbound_nodes": inbound(prev, (h, w, c)),
                           "config": {"name": name, "filters": n, "kernel_size": [3, 3],
                                      "strides": [1, 1], "padding": "same",
                                      "data_format": "channels_last", "dilation_rate": [1, 1],
                                      "groups": 1, "activation": "relu", "use_bias": True}})
            weights[name] = {"kernel": normal((3, 3, c, n), math.sqrt(2 / (9 * c))),
                             "bias": normal((n,), 0.01)}
            prev, c = name, n
        name = f"block{bi}_pool"
        layers.append({"class_name": "MaxPooling2D", "name": name,
                       "inbound_nodes": inbound(prev, (h, w, c)),
                       "config": {"name": name, "pool_size": [2, 2], "padding": "valid",
                                  "strides": [2, 2], "data_format": "channels_last"}})
        prev, h, w = name, h // 2, w // 2
    layers.append({"class_name": "Flatten", "name": "flatten",
                   "inbound_nodes": inbound(prev, (h, w, c)),
                   "config": {"name": "flatten", "data_format": "channels_last"}})
    prev, n_in = "flatten", h * w * c
    for name, units, act in (("fc1", 4096, "relu"), ("fc2", 4096, "relu"),
                             ("predictions", KV_CLASSES, "softmax")):
        layers.append({"class_name": "Dense", "name": name, "inbound_nodes": inbound(prev, (n_in,)),
                       "config": {"name": name, "units": units, "activation": act,
                                  "use_bias": True}})
        scale = math.sqrt((2 if act == "relu" else 1) / n_in)
        weights[name] = {"kernel": normal((n_in, units), scale), "bias": normal((units,), 0.01)}
        prev, n_in = name, units
    model = {"class_name": "Functional",
             "config": {"name": "vgg16", "layers": layers, "input_layers": ["input_layer", 0, 0],
                        "output_layers": ["predictions", 0, 0]}}
    return model, {"loss": "categorical_crossentropy"}, weights


def vgg16_plain_forward(x_nchw, weights):
    """VGG16 written straight from the Keras arrays, none of the importer:
    ``F.conv2d`` on each HWIO kernel permuted to OIHW (SAME 3x3: pad 1),
    relu, ``max_pool2d``, the map flattened in Keras's (h, w, c) order, then
    the dense products; on the card in f32."""
    import torch.nn.functional as F

    from deeplearning4j_torch import resolve_device

    def dev(a):
        return torch.from_numpy(a).to(resolve_device("cuda"))
    a = dev(x_nchw)
    for bi, widths in enumerate(KV_BLOCKS, 1):
        for ci in range(1, len(widths) + 1):
            wk = weights[f"block{bi}_conv{ci}"]
            a = F.relu(F.conv2d(a, dev(wk["kernel"]).permute(3, 2, 0, 1), dev(wk["bias"]),
                                padding=1))
        a = F.max_pool2d(a, 2)
    a = a.permute(0, 2, 3, 1).reshape(a.shape[0], -1)
    for name in ("fc1", "fc2"):
        a = F.relu(a @ dev(weights[name]["kernel"]) + dev(weights[name]["bias"]))
    return torch.softmax(a @ dev(weights["predictions"]["kernel"])
                         + dev(weights["predictions"]["bias"]), -1)


def keras_vgg16():
    """Keras VGG16 imported through the HDF5 entry points' core
    (``_import_functional``: the parsed model_config and the weight map; the
    card's machine has no h5py) as a ComputationGraph on the card: (a) its
    f32 ``output`` at b=KV_B against ``vgg16_plain_forward`` (the
    Flatten -> Dense kernel permutation at 25088 rows); (b) the import made
    bf16 with Adam 1e-3 under CacheMode.DEVICE, fit at bench.py:195's b=256
    in KV_TURNS alternating turns of KV_STEPS steps with the zoo VGG16 of
    ``vgg16_main``, each net's peak memory alone. No K1-K7 launch."""
    from deeplearning4j_torch import Adam, DataSet, resolve_device
    from deeplearning4j_torch.keras import model_import
    from deeplearning4j_torch.models import ModelSelector
    from deeplearning4j_torch.nn.conf import CacheMode
    from deeplearning4j_torch.nn.graph import ComputationGraph
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork

    t0 = time.perf_counter()
    model, training, weights = keras_vgg16_model(np.random.default_rng(KV_SEED))
    made_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    net = model_import._import_functional(model, training, weights,
                                          device=resolve_device("cuda"))
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    n_params = net.num_params()
    pre = net.conf.input_preprocessors.get("fc1")
    if type(pre).__name__ != "CnnToFeedForwardPreProcessor" or net.conf.vertices[
            "predictions"].__class__.__name__ != "OutputLayer":
        raise AssertionError(f"imported VGG16: fc1's preprocessor {pre}, predictions "
                             f"{type(net.conf.vertices['predictions']).__name__}")
    x = np.random.default_rng(KV_SEED + 1).normal(size=(KV_B, 3, *KV_IMG[:2])).astype(np.float32)
    got = net.output(x)
    want = vgg16_plain_forward(x, weights)
    err = ((got - want).abs().max() / want.abs().max()).item()
    log(f"Keras VGG16 ({n_params} parameters) imported in {import_s:.2f} s (weights "
        f"made in {made_s:.2f} s); f32 output b={KV_B} vs the plain NHWC forward from the Keras "
        f"arrays: max |diff| {err:.2e} of the largest entry (limit {KV_OUT_RTOL})")
    if not (torch.isfinite(got).all() and err <= KV_OUT_RTOL):
        raise AssertionError(f"imported VGG16 disagrees with the plain forward: {err}")
    del got, want
    conf = net.conf
    conf.global_conf.compute_dtype = "bfloat16"
    conf.global_conf.updater = Adam(learning_rate=1e-3)
    conf.global_conf.cache_mode = CacheMode.DEVICE
    imp = ComputationGraph(conf).init(params=net.params, states=net.states)
    del net, weights
    torch.cuda.empty_cache()
    f, l = zoo_data(np.random.default_rng(KV_SEED + 2), VGG_B, VGG_IMG, VGG_CLASSES)
    ds = DataSet(f, l)
    torch.cuda.reset_peak_memory_stats()
    fit_steps(imp, ds, 2)()
    imp_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    zconf = ModelSelector.select("vgg16", num_classes=VGG_CLASSES, input_shape=VGG_IMG).conf()
    zconf.global_conf.compute_dtype = "bfloat16"
    zconf.global_conf.cache_mode = CacheMode.DEVICE
    zoo = MultiLayerNetwork(zconf).init()                 # device defaults to the card
    fit_steps(zoo, ds, 2)()
    losses = record_losses(imp)
    med, turns = alternating_ms({"imported": fit_steps(imp, ds, KV_STEPS),
                                 "zoo": fit_steps(zoo, ds, KV_STEPS)}, KV_TURNS)
    step_ms = {k: v / KV_STEPS for k, v in med.items()}
    losses = [float(v) for v in losses]
    probs = imp.output(f[:KV_B])
    sum_err = check_probabilities("imported VGG16 (bf16, trained)", probs, (KV_B, VGG_CLASSES),
                                  PROB_SUM_ATOL)
    if not np.isfinite(losses).all():
        raise AssertionError(f"imported VGG16 losses {losses}")
    del imp, probs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fit_steps(zoo, ds, 2)()
    zoo_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ratio = step_ms["imported"] / step_ms["zoo"]
    log(f"imported VGG16 (ComputationGraph) vs the zoo's (MultiLayerNetwork), b={VGG_B} bf16 "
        f"Adam: {step_ms['imported']:.2f} vs {step_ms['zoo']:.2f} ms a step (ratio {ratio:.3f}; "
        f"medians of {KV_TURNS} alternating turns of {KV_STEPS} steps), peak "
        f"{imp_peak:.2f} vs {zoo_peak:.2f} GiB, each alone; losses "
        + " ".join(f"{v:.3f}" for v in losses))
    del zoo
    torch.cuda.empty_cache()
    return {"num_params": n_params, "import_s": import_s, "weights_made_s": made_s,
            "output_rel_err": err, "output_b": KV_B, "step_ms": step_ms, "turns_ms": turns,
            "steps": KV_STEPS, "ratio": ratio, "peak_gib": {"imported": imp_peak, "zoo": zoo_peak},
            "losses": losses, "prob_sum_err": sum_err}


def keras_char_lstm_model(rng):
    """A Keras Sequential ``LSTM(KL_H, return_sequences) -> LSTM(KL_H,
    return_sequences) -> TimeDistributed(Dense(KL_VOCAB, softmax))`` on
    [b, KL_T, KL_VOCAB] (Keras's default recurrent_activation sigmoid), with
    Keras-initialised weights from ``rng``: glorot-uniform kernels,
    orthogonal recurrent kernels, biases 0 but the forget gate's 1
    (unit_forget_bias), in Keras's gate order (i, f, c, o)."""
    H = KL_H

    def glorot(n_in, n_out):
        lim = math.sqrt(6 / (n_in + n_out))
        return rng.uniform(-lim, lim, (n_in, n_out)).astype(np.float32)

    def lstm(n_in):
        q, _ = np.linalg.qr(rng.standard_normal((4 * H, H)))
        bias = np.zeros(4 * H, np.float32)
        bias[H:2 * H] = 1.0
        return {"kernel": glorot(n_in, 4 * H), "recurrent_kernel": q.T.astype(np.float32),
                "bias": bias}

    def lstm_cfg(name):
        return {"class_name": "LSTM", "config": {
            "name": name, "units": H, "activation": "tanh", "recurrent_activation": "sigmoid",
            "use_bias": True, "unit_forget_bias": True, "return_sequences": True}}
    model = {"class_name": "Sequential", "config": {"name": "char_lstm", "layers": [
        {"class_name": "InputLayer", "config": {"batch_shape": [None, KL_T, KL_VOCAB],
                                                "dtype": "float32", "name": "input_layer"}},
        lstm_cfg("lstm_1"), lstm_cfg("lstm_2"),
        {"class_name": "TimeDistributed", "config": {"name": "td", "layer": {
            "class_name": "Dense", "config": {"name": "dense", "units": KL_VOCAB,
                                              "activation": "softmax", "use_bias": True}}}}]}}
    weights = {"lstm_1": lstm(KL_VOCAB), "lstm_2": lstm(H),
               "td": {"kernel": glorot(H, KL_VOCAB), "bias": np.zeros(KL_VOCAB, np.float32)}}
    return model, {"loss": "categorical_crossentropy"}, weights


def keras_lstm_oracle(x, weights):
    """The model's output in numpy f64 from Keras's LSTM equations in its
    own gate order (i, f, c, o), read from the unreordered Keras arrays."""
    def sig(v):
        return 1.0 / (1.0 + np.exp(-v))
    a = x.astype(np.float64)
    for name in ("lstm_1", "lstm_2"):
        w = {k: v.astype(np.float64) for k, v in weights[name].items()}
        b, T, _ = a.shape
        H = w["recurrent_kernel"].shape[0]
        h, c, out = np.zeros((b, H)), np.zeros((b, H)), np.zeros((b, T, H))
        for t in range(T):
            z = a[:, t] @ w["kernel"] + h @ w["recurrent_kernel"] + w["bias"]
            i, f, g, o = sig(z[:, :H]), sig(z[:, H:2 * H]), np.tanh(z[:, 2 * H:3 * H]), \
                sig(z[:, 3 * H:])
            c = f * c + i * g
            h = o * np.tanh(c)
            out[:, t] = h
        a = out
    z = a @ weights["td"]["kernel"].astype(np.float64) + weights["td"]["bias"]
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


LSTM_KERNELS = {"lstm_fwd": ("lstm_cell", "lstm_fwd_plain"),
                "lstm_bwd": ("lstm_cell", "lstm_bwd_plain"),
                "lstm2_fwd": ("lstm_fused", "lstm2_fwd_plain"),
                "lstm2_bwd": ("lstm_fused", "lstm2_bwd_plain")}


@contextlib.contextmanager
def first_launches_held():
    """While active, the first launch of each LSTM kernel wrapper (K1, K2,
    K3, K4; K1 and K3 with and without the reserve apart) is also computed by
    its plain version on the same inputs (the plain loops count no launch).
    Yields {wrapper, "_train" with the reserve: {"name", "args", "kw",
    "reserve", "max_abs_err"}} (``kernel_err``) for what launched."""
    from deeplearning4j_torch.ops import lstm_cell, lstm_fused

    mods = {"lstm_cell": lstm_cell, "lstm_fused": lstm_fused}
    seen, real = {}, {n: getattr(mods[m], n) for n, (m, _) in LSTM_KERNELS.items()}

    def tap(name):
        def launched(*args, **kw):
            out = real[name](*args, **kw)
            key = name + ("_train" if kw.get("save_reserve") else "")
            if key not in seen:
                m, plain = LSTM_KERNELS[name]
                ref = getattr(mods[m], plain)(*args, **kw)
                seen[key] = {"name": name, "args": args, "kw": kw,
                             "reserve": bool(kw.get("save_reserve")),
                             "max_abs_err": kernel_err([o for o in out if o is not None],
                                                       [r for r in ref if r is not None])}
            return out
        return launched

    for n, (m, _) in LSTM_KERNELS.items():
        setattr(mods[m], n, tap(n))
    try:
        yield seen
    finally:
        for n, (m, _) in LSTM_KERNELS.items():
            setattr(mods[m], n, real[n])


def cudnn_lstm_ms(name, args, reserve):
    """ms of cuDNN's LSTM (``torch.nn.LSTM``: one PyTorch call, no
    peepholes, sigmoid/tanh, the same recurrence up to its gate order) at a
    held launch's T, b, H and weight type: one layer for K1/K2, two for
    K3/K4. A forward without the reserve runs under inference mode, one with
    it in training mode with autograd recording (cuDNN writes its own
    reserve); K2/K4 are timed as the backward of such a forward
    (``retain_graph``). cuDNN also does the input projection and, backward,
    its gradients, which the port runs as GEMMs outside K1-K4."""
    x = args[0] if name in ("lstm_fwd", "lstm2_fwd") else args[1]
    w = args[1] if name in ("lstm_fwd", "lstm2_fwd") else args[3 if name == "lstm_bwd" else 5]
    t, b, h4 = x.shape
    lstm = torch.nn.LSTM(h4 // 4, h4 // 4, num_layers=2 if name.startswith("lstm2") else 1)
    lstm = lstm.to(x.device, w.dtype)
    lstm.flatten_parameters()
    gen = torch.Generator(x.device).manual_seed(0)
    inp = torch.randn(t, b, h4 // 4, device=x.device, dtype=w.dtype, generator=gen)
    if name in ("lstm_fwd", "lstm2_fwd") and not reserve:
        with torch.inference_mode():
            return cuda_ms(lambda: lstm(inp), 5)
    inp.requires_grad_(True)
    if name in ("lstm_fwd", "lstm2_fwd"):
        return cuda_ms(lambda: lstm(inp), 5)
    out, _ = lstm(inp)
    dy = torch.randn(out.shape, device=x.device, dtype=w.dtype, generator=gen)
    return cuda_ms(lambda: out.backward(dy, retain_graph=True), 5)


def timed_launches(seen):
    """Each held launch timed by CUDA events beside its plain version on
    its own arguments (``cuda_ms``: one warm-up call first), with its bound
    and cuDNN's LSTM at its shape (``cudnn_lstm_ms``) as ``library_ms``."""
    from deeplearning4j_torch.ops import lstm_cell, lstm_fused

    mods = {"lstm_cell": lstm_cell, "lstm_fused": lstm_fused}
    rows = {}
    for key, s in seen.items():
        name = s["name"]
        m, plain = LSTM_KERNELS[name]
        fn, ref = getattr(mods[m], name), getattr(mods[m], plain)
        args, kw = s["args"], s["kw"]
        with torch.inference_mode():      # some arguments were made under it
            ms = cuda_ms(lambda: fn(*args, **kw), 5)
            plain_ms = cuda_ms(lambda: ref(*args, **kw), 1)
        bms, by = lstm_launch_bound(name, args, s["reserve"])
        library_ms = cudnn_lstm_ms(name, args, s["reserve"])
        x = args[0] if name in ("lstm_fwd", "lstm2_fwd") else args[1]
        w = args[1] if name in ("lstm_fwd", "lstm2_fwd") else args[3 if name == "lstm_bwd" else 5]
        peep = args[{"lstm_fwd": 2, "lstm_bwd": 4, "lstm2_fwd": 5, "lstm2_bwd": 8}[name]] \
            is not None
        rows[key] = {
            "max_abs_err": s["max_abs_err"], "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": library_ms,
            "library_note": f"cuDNN nn.LSTM, {2 if name.startswith('lstm2') else 1} layer(s), "
                            f"{'backward' if name.endswith('bwd') else 'forward'}",
            "shape": {"T": int(x.shape[0]), "b": int(x.shape[1]), "H": int(x.shape[2]) // 4,
                      "w": str(w.dtype)[6:], "peepholes": peep}}
        log(f"  {name}{' with reserve' if s['reserve'] else ''} T={x.shape[0]} b={x.shape[1]} "
            f"{str(w.dtype)[6:]} {'with' if peep else 'without'} peepholes: max_abs_err "
            f"{s['max_abs_err']:.2e}, "
            f"{ms:.4f} ms (plain {plain_ms:.2f}, bound {bms:.5f}, {by}; cuDNN's LSTM "
            f"{library_ms:.4f})")
    return rows


def keras_char_lstm():
    """The Keras char-LSTM (``keras_char_lstm_model``) imported through the
    Sequential core on the card at b=KL_B, T=KL_T: (a) its f32 ``output``
    (two K1 launches: f32 at H=512 b=64 has no K3 grid) against
    ``keras_lstm_oracle`` on KL_ORACLE_ROWS rows; its bf16 twin's ``output``
    (one K3 launch) against the f32 output; (b) KL_FITS bf16 Adam fits of
    one b x T batch (each one K3 with the reserve and one K4; K1 + K2 where
    ``_lstm_pair_fusable`` declines, with the routes logged), the first
    launch of each kernel held against its plain version and then timed
    beside it; (c) a fit's ms (alternating with itself over RF_TURNS turns)
    and the bf16 net's score, gradients and output on the card against the
    CPU (``card_vs_cpu``) at one TBPTT segment's shape."""
    from deeplearning4j_torch import Adam, DataSet, MultiLayerNetwork, resolve_device
    from deeplearning4j_torch.keras import model_import
    from deeplearning4j_torch.ops import lstm_fused

    model, training, weights = keras_char_lstm_model(np.random.default_rng(KL_SEED))
    net = model_import._import_sequential(model, training, weights,
                                          device=resolve_device("cuda"))
    kinds = [type(lc).__name__ for lc in net.conf.layers]
    if kinds != ["LSTM", "LSTM", "RnnOutputLayer"] or any(im.peepholes for im in
                                                          list(net.impls)[:2]):
        raise AssertionError(f"imported char-LSTM layers {kinds}")
    f, l = periodic_text(np.random.default_rng(KL_SEED + 1), KL_B, KL_T)
    if net._lstm_pair_fusable(0, net._to_device(f), None, False):
        raise AssertionError(f"the f32 pair at b={KL_B} was admitted to K3")
    launches = {}
    with first_launches_held() as seen:
        reset_counts()
        out32 = net.output(f)
        torch.cuda.synchronize()
        launches["f32_output"] = read_counts()
        want = keras_lstm_oracle(f[:KL_ORACLE_ROWS], weights)
        err32 = np.abs(out32[:KL_ORACLE_ROWS].double().cpu().numpy() - want).max()
        log(f"Keras char-LSTM ({net.num_params()} parameters) f32 output b={KL_B} T={KL_T} vs "
            f"the numpy Keras LSTM (rows 0-{KL_ORACLE_ROWS - 1}): max_abs_err {err32:.2e} "
            f"(limit {KL_F32_ATOL}; largest probability {want.max():.3f})")
        if not err32 <= KL_F32_ATOL:
            raise AssertionError(f"imported char-LSTM f32 output vs Keras's equations: {err32}")
        conf = copy.deepcopy(net.conf)
        conf.global_conf.compute_dtype = "bfloat16"
        conf.global_conf.updater = Adam(learning_rate=1e-3)
        twin = MultiLayerNetwork(conf).init(params=net.params)
        del net
        reset_counts()
        out16 = twin.output(f)
        torch.cuda.synchronize()
        launches["bf16_output"] = read_counts()
        err16 = (out16.float() - out32).abs().max().item()
        log(f"its bf16 twin's output vs the f32 output: max_abs_err {err16:.2e} (limit "
            f"{REF_ATOL})")
        if not err16 <= REF_ATOL:
            raise AssertionError(f"bf16 imported char-LSTM vs f32: {err16}")
        x = twin._to_device(f)
        fused = twin._lstm_pair_fusable(0, x, None, True)
        if not fused:
            log(f"the bf16 pair is not fused in training: K3 route "
                f"{lstm_fused.fwd_route(torch.bfloat16, KL_B, KL_H, reserve=True, device=x.device)}"
                f", K4 route {lstm_fused.bwd_route(torch.bfloat16, KL_B, KL_H, device=x.device)}")
        ds = DataSet(f, l)
        losses = record_losses(twin)
        reset_counts()
        for _ in range(KL_FITS):
            twin.fit(ds)
        torch.cuda.synchronize()
        launches["bf16_fits"] = read_counts()
    expect = {"f32_output": {"lstm_fwd": 2}, "bf16_output": {"lstm2_fwd": 1},
              "bf16_fits": ({"lstm2_fwd_train": KL_FITS, "lstm2_bwd": KL_FITS} if fused
                            else {"lstm_fwd_train": 2 * KL_FITS, "lstm_bwd": 2 * KL_FITS})}
    for path, want_counts in expect.items():
        got = {n: c for n, c in launches[path].items() if c}
        if got != want_counts:
            raise AssertionError(f"imported char-LSTM {path} launched {got}, expected "
                                 f"{want_counts}")
    log(f"imported char-LSTM launches: {({p: {n: c for n, c in v.items() if c} for p, v in launches.items()})}")
    losses = [float(v) for v in losses]
    if not np.isfinite(losses).all():
        raise AssertionError(f"imported char-LSTM losses {losses}")
    rows = timed_launches(seen)
    for name, r in rows.items():
        limit = BWD_ATOL if name.endswith("bwd") else KERNEL_ATOL
        if not r["max_abs_err"] <= limit:
            raise AssertionError(f"{name} on the imported char-LSTM disagrees with its plain "
                                 f"version: {r['max_abs_err']} > {limit}")
    del seen
    med, turns = alternating_ms({"fit": lambda: twin.fit(ds)}, RF_TURNS)
    log(f"imported char-LSTM bf16 fit b={KL_B} T={KL_T} (standard backprop): {med['fit']:.2f} "
        f"ms (median of {RF_TURNS}); losses " + " ".join(f"{v:.3f}" for v in losses))
    ref = card_vs_cpu("imported Keras char-LSTM (bf16)", twin.conf, twin,
                      *masked_text(np.random.default_rng(KL_SEED + 2), TRAIN_B, TRAIN_T))
    return {"output_f32_abs_err": float(err32), "output_bf16_vs_f32": err16,
            "launches": {p: {n: c for n, c in v.items() if c} for p, v in launches.items()},
            "fused_in_training": fused, "kernels": rows, "fit_ms": med["fit"],
            "fit_turns_ms": turns["fit"], "losses": losses, "reference": ref}


def timed_calls(obj, name):
    """Wrap ``obj.name`` (an instance's method) so that each call's seconds
    are appended to the returned list."""
    secs, real = [], getattr(obj, name)

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = real(*a, **k)
        secs.append(time.perf_counter() - t0)
        return out
    setattr(obj, name, timed)
    return secs


def emb_sentences(rng, n):
    """bench.py:1645-1661's corpus: n sentences of EMB_LEN words drawn as
    ``rng.zipf(1.3) % EMB_VOCAB``."""
    ids = (rng.zipf(1.3, size=n * EMB_LEN) % EMB_VOCAB).reshape(n, EMB_LEN)
    return [" ".join(f"w{t}" for t in row) for row in ids]


def emb_step_check(label, model, tokens, seed):
    """One full batch of ``model``'s pairs (its own pair draw over
    ``tokens``, EMB_BATCH of them, with the corpus's duplicates) through its
    steps from one random state of its tables' shapes (N(0, 0.1^2) from
    ``seed``), on the card in f32 and on the CPU in f64: the largest |card -
    CPU| over the updated tables over the CPU step's largest update, which
    must be at most EMB_STEP_RTOL. (The fitted tables can hold NaN at
    bench.py's settings, as the JAX package's do, so they are not the
    state.)"""
    from deeplearning4j_torch import resolve_device
    from deeplearning4j_torch.nlp.sequencevectors import _hs_step, _ns_step

    rng = np.random.default_rng(seed)
    cs, ts, n = [], [], 0
    for seq in tokens:
        c, t = model._sequence_pairs_arrays(model._subsampled_indices(seq, rng), rng)
        cs.append(c)
        ts.append(t)
        n += c.size
        if n >= EMB_BATCH:
            break
    rows = torch.from_numpy(np.concatenate(cs)[:EMB_BATCH].astype(np.int64))
    targets = torch.from_numpy(np.concatenate(ts)[:EMB_BATCH].astype(np.int64))
    lt, lr = model.lookup_table, float(np.float32(model.learning_rate))
    names = ["syn0"] + (["syn1"] if model.use_hs else []) + (["syn1neg"] if model.negative else [])
    before = {k: torch.from_numpy(rng.normal(0, 0.1, tuple(getattr(lt, k).shape))
                                  .astype(np.float32)) for k in names}
    card = resolve_device("cuda")
    card_tabs = {k: v.to(card, copy=True) for k, v in before.items()}
    cpu_tabs = {k: v.double() for k, v in before.items()}
    negs = None
    if model.negative:
        negs = torch.from_numpy(model._neg_table[rng.integers(0, len(model._neg_table),
                                                              (EMB_BATCH, model.negative))]
                                .astype(np.int64))
    for tabs, dev in ((card_tabs, card), (cpu_tabs, torch.device("cpu"))):
        r, t = rows.to(dev), targets.to(dev)
        if model.use_hs:
            _hs_step(tabs["syn0"], tabs["syn1"], r, t,
                     *(a.to(dev) for a in model._hs_tables), lr)
        if model.negative:
            _ns_step(tabs["syn0"], tabs["syn1neg"], r,
                     torch.cat([t[:, None], negs.to(dev)], 1), lr)
    upd = max((cpu_tabs[k] - before[k].double()).abs().max().item() for k in names)
    diff = max((card_tabs[k].double().cpu() - cpu_tabs[k]).abs().max().item() for k in names)
    rel = diff / upd
    dup = EMB_BATCH - int(torch.unique(rows).numel())
    log(f"{label}: one batch of {EMB_BATCH} pairs ({dup} repeated rows) card f32 vs CPU f64 "
        f"from one random state: max |diff| {diff:.2e} = {rel:.2e} of the largest update "
        f"{upd:.2e} (limit {EMB_STEP_RTOL})")
    if not (upd > 0 and rel <= EMB_STEP_RTOL):
        raise AssertionError(f"{label}: the card's step disagrees with the CPU's: {rel}")
    return {"rel_err": rel, "max_abs_diff": diff, "largest_update": upd, "repeated_rows": dup}


def word2vec_kind(kind, sentences, tokens):
    """Word2Vec of ``kind`` (``hs``: hierarchical softmax, the default;
    ``ns``: negative sampling, 5 negatives; ``cbow``: CBOW with HS) at
    bench.py:1645-1661's settings, fit on the card: words/s over the
    whole ``fit`` (vocab, host pairs and device steps, as bench.py counts
    it), a profiled refit of EMB_PROFILE_SENTENCES sentences (the card's
    busy share), and one batch's step against the CPU in f64."""
    from deeplearning4j_torch.nlp import CBOW, Word2Vec

    kw = dict(vector_length=EMB_DIM, window=EMB_WINDOW, epochs=1, batch_size=EMB_BATCH,
              min_word_frequency=1)
    if kind == "ns":
        kw["negative"] = 5
    model = (CBOW if kind == "cbow" else Word2Vec)(**kw)   # device defaults to the card
    vocab_s = timed_calls(model, "build_vocab")
    t0 = time.perf_counter()
    model.fit(sentences)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    words = len(sentences) * EMB_LEN
    prof = profile_call(f"Word2Vec {kind}: {EMB_PROFILE_SENTENCES} sentences",
                        lambda: model.fit_tokenized(tokens[:EMB_PROFILE_SENTENCES]))
    step = emb_step_check(f"Word2Vec {kind}", model, tokens, 1)
    nan = torch.isnan(model.lookup_table.syn0).float().mean().item()
    res = {"fit_s": fit_s, "vocab_s": vocab_s[0], "words_per_s": words / fit_s, "words": words,
           "vocab": model.vocab.num_words(), "profile": prof, "step": step, "nan_share": nan}
    log(f"Word2Vec {kind}: {res['words_per_s']:.0f} words/s ({words} words in {fit_s:.2f} s, "
        f"{vocab_s[0]:.2f} s of it the vocab, {res['vocab']} words); profiled refit busy "
        + (f"{100 * prof['busy_ms'] / prof['wall_ms']:.1f}%" if prof else "not measured")
        + f"; NaN share of the vectors {nan:.3f} (batch {EMB_BATCH} at lr "
        f"{model.learning_rate} sums thousands of duplicate updates, as the JAX package does)")
    return model, res


def paragraph_vectors(sentences):
    """ParagraphVectors (DBOW, ``dm=False``) on the corpus labelled in
    PV_GROUPS groups (sentence i labelled ``g{i % PV_GROUPS}``) at Word2Vec's
    settings but batch PV_BATCH, where its vectors stay finite: words/s, one
    batch's step against the CPU in f64, and ``predict`` on PV_HELD_OUT
    held-out sentences (ms a call; every answer one of the labels)."""
    from deeplearning4j_torch.nlp import ParagraphVectors

    docs = [(f"g{i % PV_GROUPS}", s) for i, s in enumerate(sentences)]
    pv = ParagraphVectors(dm=False, vector_length=EMB_DIM, window=EMB_WINDOW, epochs=1,
                          batch_size=PV_BATCH, min_word_frequency=1)
    vocab_s = timed_calls(pv, "build_vocab")
    t0 = time.perf_counter()
    pv.fit_labelled(docs)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    tokens = [[pv._label_token(lbl)] + s.split() for lbl, s in docs[:EMB_PROFILE_SENTENCES]]
    step = emb_step_check("ParagraphVectors (DBOW)", pv, tokens, 2)
    held = emb_sentences(np.random.default_rng(PV_SEED), PV_HELD_OUT)
    t0 = time.perf_counter()
    preds = [pv.predict(s) for s in held]
    predict_ms = (time.perf_counter() - t0) * 1e3 / len(held)
    labels = {f"g{i}" for i in range(PV_GROUPS)}
    if not all(p in labels for p in preds):
        raise AssertionError(f"ParagraphVectors predicted labels outside the groups: "
                             f"{sorted(set(preds) - labels)[:5]}")
    words = len(sentences) * EMB_LEN
    nan = torch.isnan(pv.lookup_table.syn0).float().mean().item()
    if not torch.isfinite(pv.lookup_table.syn0).all():
        raise AssertionError(f"ParagraphVectors at batch {PV_BATCH}: NaN share {nan}")
    log(f"ParagraphVectors DBOW, {PV_GROUPS} labels, batch {PV_BATCH}: {words / fit_s:.0f} words/s "
        f"({fit_s:.2f} s, {vocab_s[0]:.2f} s of it the vocab); predict {predict_ms:.2f} ms a "
        f"sentence over {len(held)} held-out sentences ({len(set(preds))} distinct labels); "
        f"NaN share of the vectors {nan:.3f}")
    return {"fit_s": fit_s, "vocab_s": vocab_s[0], "batch": PV_BATCH,
            "words_per_s": words / fit_s, "step": step, "predict_ms": predict_ms,
            "distinct_predictions": len(set(preds)), "nan_share": nan}


def glove_fit(sentences):
    """GloVe on GLOVE_SENTENCES sentences (vector GLOVE_DIM, batch
    GLOVE_BATCH, its default 5 epochs): s to count the co-occurrences (host
    dict loop), ms an AdaGrad batch (host clock, synced: the five epochs
    less a one-epoch refit, which leaves out the fit's set-up), and one
    batch from a fresh state on the card against the CPU in f64."""
    from deeplearning4j_torch import resolve_device
    from deeplearning4j_torch.nlp import Glove
    from deeplearning4j_torch.nlp.glove import _glove_step

    g = Glove(vector_length=GLOVE_DIM, window=EMB_WINDOW, batch_size=GLOVE_BATCH,
              min_word_frequency=1)
    seen = {}
    fit_cooc = g.fit_cooccurrences

    def timed(cooc):
        seen["cooc"], seen["t"] = cooc, time.perf_counter()
        out = fit_cooc(cooc)
        torch.cuda.synchronize()
        seen["train_s"] = time.perf_counter() - seen["t"]
        return out
    g.fit_cooccurrences = timed
    t0 = time.perf_counter()
    g.fit(sentences)
    count_s = seen["t"] - t0
    n_pairs = len(seen["cooc"])
    batches = g.epochs * -(-n_pairs // GLOVE_BATCH)
    if not np.isfinite(g.syn0).all():
        raise AssertionError("GloVe vectors are not finite")
    # a one-epoch refit from the same counts: the fit's set-up (sorting and
    # packing the pairs, the tables) apart from its batches
    g.epochs, per_epoch = 1, -(-n_pairs // GLOVE_BATCH)
    t0 = time.perf_counter()
    fit_cooc(seen["cooc"])
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    batch_ms = (seen["train_s"] - one_s) * 1e3 / (batches - per_epoch)
    setup_s = one_s - batch_ms * per_epoch / 1e3
    # one batch from a fresh state: card f32 against CPU f64
    rng = np.random.default_rng(GLOVE_SEED)
    n, d = g.vocab.num_words(), GLOVE_DIM
    items = sorted(seen["cooc"].items())[:GLOVE_BATCH]
    pairs = torch.tensor([ij for ij, _ in items])
    counts = np.asarray([v for _, v in items], np.float32)
    logx = torch.from_numpy(np.log(counts))
    fx = torch.from_numpy(np.minimum((counts / g.x_max) ** g.alpha, 1.0).astype(np.float32))
    tabs = [torch.from_numpy(((rng.random(s) - 0.5) / d).astype(np.float32))
            for s in ((n, d), (n, d))] + [torch.zeros(n), torch.zeros(n)]
    tabs += [torch.from_numpy(rng.uniform(1, 2, s).astype(np.float32))
             for s in ((n, d), (n, d), (n,), (n,))]
    out = {}
    for tag, dev, dt in (("card", resolve_device("cuda"), torch.float32),
                         ("cpu", torch.device("cpu"), torch.float64)):
        out[tag] = _glove_step(*(t.to(dev, dt, copy=True) for t in tabs), pairs[:, 0].to(dev),
                               pairs[:, 1].to(dev), logx.to(dev, dt), fx.to(dev, dt),
                               float(np.float32(g.learning_rate)))
    upd = max((c - t.double()).abs().max().item() for c, t in zip(out["cpu"][:8], tabs))
    diff = max((a.double().cpu() - c).abs().max().item()
               for a, c in zip(out["card"][:8], out["cpu"][:8]))
    loss_rel = abs(out["card"][8].item() - out["cpu"][8].item()) / abs(out["cpu"][8].item())
    log(f"GloVe on {len(sentences)} sentences: counted {n_pairs} pairs in {count_s:.2f} s, "
        f"{batch_ms:.3f} ms an AdaGrad batch of {GLOVE_BATCH} ({batches} batches in "
        f"{seen['train_s']:.2f} s, {setup_s:.2f} s of it the set-up); one batch card f32 vs "
        f"CPU f64: {diff:.2e} = "
        f"{diff / upd:.2e} of the largest update, loss rel {loss_rel:.2e}")
    if not (diff / upd <= EMB_STEP_RTOL and loss_rel <= EMB_STEP_RTOL):
        raise AssertionError(f"GloVe's card step disagrees with the CPU's: {diff / upd}, "
                             f"{loss_rel}")
    return {"count_s": count_s, "pairs": n_pairs, "batch_ms": batch_ms, "batches": batches,
            "train_s": seen["train_s"], "setup_s": setup_s,
            "step": {"rel_err": diff / upd, "loss_rel": loss_rel}}


def blogcatalog_graph(rng):
    """A graph of BlogCatalog's size (DeepWalk paper, Perozzi et al., KDD
    2014, section 5.1: DW_VERTICES vertices, DW_EDGES edges, DW_COMMUNITIES
    labels) with DW_COMMUNITIES planted communities: each vertex in one
    community drawn uniformly, DW_WITHIN of the edges inside a community,
    the rest across; no self-loops or repeated edges. (Graph, community of
    each vertex)."""
    from deeplearning4j_torch.graph import Graph

    N = DW_VERTICES
    comm = rng.integers(0, DW_COMMUNITIES, N)
    order = np.argsort(comm, kind="stable")
    starts = np.searchsorted(comm[order], np.arange(DW_COMMUNITIES))
    sizes = np.bincount(comm, minlength=DW_COMMUNITIES)
    keys = np.empty(0, np.int64)
    while keys.size < DW_EDGES:
        m = 2 * (DW_EDGES - keys.size)
        u = rng.integers(0, N, m)
        inside = rng.random(m) < DW_WITHIN
        v = np.where(inside, order[starts[comm[u]] + (rng.random(m) * sizes[comm[u]]).astype(
            np.int64)], rng.integers(0, N, m))
        ok = u != v
        a, b = np.minimum(u, v)[ok], np.maximum(u, v)[ok]
        keys = np.unique(np.concatenate([keys, a * N + b]))
    keys = rng.permutation(keys)[:DW_EDGES]
    g = Graph(N)
    for a, b in zip((keys // N).tolist(), (keys % N).tolist()):
        g.add_edge(a, b)
    return g, comm


def deepwalk_blogcatalog():
    """DeepWalk (d=DW_DIM, window DW_WINDOW, walk length DW_WALK,
    DW_WALKS walks a vertex: the paper's 80 cut to keep the phase in its
    time; batch EMB_BATCH) on ``blogcatalog_graph``: words/s over the fit
    (walks on the host included), one batch's step against the CPU in f64,
    and the share of each vertex's DW_NEIGHBOURS nearest neighbours (cosine,
    on the card) in its own community, beside that share for a table of
    random rows of the same shape (what an untrained table reads)."""
    from deeplearning4j_torch import resolve_device
    from deeplearning4j_torch.graph import DeepWalk, RandomWalkIterator

    t0 = time.perf_counter()
    g, comm = blogcatalog_graph(np.random.default_rng(DW_SEED))
    graph_s = time.perf_counter() - t0
    dw = DeepWalk(walk_length=DW_WALK, walks_per_vertex=DW_WALKS, vector_length=DW_DIM,
                  window=DW_WINDOW, batch_size=EMB_BATCH, seed=DW_SEED)
    vocab_s = timed_calls(dw._sv, "build_vocab")       # a pass over the walks
    t0 = time.perf_counter()
    gv = dw.fit(g)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    sv = gv._sv
    walks = [[str(v) for v in w] for w, _ in zip(
        RandomWalkIterator(g, DW_WALK, seed=DW_SEED + 1), range(EMB_PROFILE_SENTENCES))]
    step = emb_step_check("DeepWalk", sv, walks, 3)
    card = resolve_device("cuda")
    idx = torch.tensor([sv.vocab.index_of(str(i)) for i in range(DW_VERTICES)], device=card)
    if int((idx < 0).sum()):
        raise AssertionError("DeepWalk left vertices out of its vocabulary")
    comm_d = torch.from_numpy(comm).to(card)

    def neighbour_share(table):
        emb = torch.nn.functional.normalize(table, dim=1)
        same = 0
        for s in range(0, DW_VERTICES, 2048):
            sims = emb[s:s + 2048] @ emb.T
            sims[torch.arange(sims.shape[0]), torch.arange(s, s + sims.shape[0])] = -2.0
            nb = sims.topk(DW_NEIGHBOURS, dim=1).indices
            same += (comm_d[nb] == comm_d[s:s + 2048, None]).sum().item()
        return same / (DW_VERTICES * DW_NEIGHBOURS)

    share = neighbour_share(sv.lookup_table.syn0.index_select(0, idx))
    random_share = neighbour_share(torch.randn(
        DW_VERTICES, DW_DIM, device=card, generator=torch.Generator(card).manual_seed(DW_SEED)))
    words = DW_VERTICES * DW_WALKS * DW_WALK
    log(f"DeepWalk on a {DW_VERTICES}-vertex, {DW_EDGES}-edge graph ({DW_COMMUNITIES} planted "
        f"communities, made in {graph_s:.2f} s), {DW_WALKS} walks a vertex: {words / fit_s:.0f} "
        f"words/s ({fit_s:.2f} s, {vocab_s[0]:.2f} s of it the vocab's pass over the walks); "
        f"{100 * share:.1f}% of each vertex's {DW_NEIGHBOURS} nearest "
        f"neighbours share its community (chance {100 / DW_COMMUNITIES:.1f}%, a random table "
        f"{100 * random_share:.1f}%, limit {100 * DW_MIN_SHARE:.0f}%)")
    if not share >= DW_MIN_SHARE:
        raise AssertionError(f"DeepWalk neighbours in the own community: {share}")
    return {"graph_s": graph_s, "fit_s": fit_s, "vocab_s": vocab_s[0],
            "words_per_s": words / fit_s, "words": words,
            "walks_per_vertex": DW_WALKS, "walks_per_vertex_paper": 80,
            "neighbour_share": share, "random_table_share": random_share,
            "min_share": DW_MIN_SHARE, "chance": 1 / DW_COMMUNITIES, "step": step}


def embeddings():
    """Word2Vec HS, NS and CBOW, ParagraphVectors, GloVe and DeepWalk on the
    card (``word2vec_kind``, ``paragraph_vectors``, ``glove_fit``,
    ``deepwalk_blogcatalog``), and the HS fit of the corpus's first
    EMB_CPU_SENTENCES sentences on the card against the same fit on the CPU
    (the same host draws; only the atomics' summing order differs): the
    least cosine over words at least EMB_FIT_COS, and the largest |diff|."""
    from deeplearning4j_torch import resolve_device
    from deeplearning4j_torch.nlp import Word2Vec

    sentences = emb_sentences(np.random.default_rng(0), EMB_SENTENCES)
    tokens = [s.split() for s in sentences]
    res = {}
    for kind in ("hs", "ns", "cbow"):
        _, res[f"word2vec_{kind}"] = word2vec_kind(kind, sentences, tokens)
        torch.cuda.empty_cache()
    prefix = sentences[:EMB_CPU_SENTENCES]
    vecs, secs = {}, {}
    for tag, dev in (("card", resolve_device("cuda")), ("cpu", torch.device("cpu"))):
        m = Word2Vec(vector_length=EMB_DIM, window=EMB_WINDOW, epochs=1,
                     batch_size=EMB_CPU_BATCH, min_word_frequency=1, device=dev)
        t0 = time.perf_counter()
        m.fit(prefix)
        vecs[tag] = m.lookup_table.syn0.double().cpu()
        secs[tag] = time.perf_counter() - t0
    cos = torch.nn.functional.cosine_similarity(vecs["card"], vecs["cpu"], dim=1)
    least, diff = cos.min().item(), (vecs["card"] - vecs["cpu"]).abs().max().item()
    log(f"Word2Vec HS on the first {EMB_CPU_SENTENCES} sentences at batch {EMB_CPU_BATCH}, card "
        f"vs CPU: least cosine over {cos.numel()} words {least:.8f} (limit {EMB_FIT_COS}), max "
        f"|diff| {diff:.2e} (fits {secs['card']:.2f} s and {secs['cpu']:.2f} s)")
    if not least >= EMB_FIT_COS:
        raise AssertionError(f"Word2Vec HS card and CPU fits part: least cosine {least}")
    res["word2vec_hs"]["card_vs_cpu_fit"] = {"sentences": EMB_CPU_SENTENCES,
                                             "batch": EMB_CPU_BATCH, "least_cos": least,
                                             "max_abs_diff": diff, "fit_s": secs}
    res["paragraph_vectors"] = paragraph_vectors(sentences)
    torch.cuda.empty_cache()
    res["glove"] = glove_fit(sentences[:GLOVE_SENTENCES])
    torch.cuda.empty_cache()
    res["deepwalk"] = deepwalk_blogcatalog()
    torch.cuda.empty_cache()
    return res


def keras_embeddings(smi):
    """Keras import and the embeddings on the card: ``keras_vgg16``,
    ``keras_char_lstm`` and ``embeddings``, each driven with the counts set
    to 0 just before and read just after: VGG16 and the embeddings launch
    none of K1-K7, the char-LSTM K1 (f32), K3 (bf16 inference) and K3 + K4
    (bf16 fits), checked inside ``keras_char_lstm``."""
    t0 = time.perf_counter()
    res = {"card": smi, "part_s": {}}
    for name, fn, quiet in (("keras_vgg16", keras_vgg16, True),
                            ("keras_char_lstm", keras_char_lstm, False),
                            ("embeddings", embeddings, True)):
        t1 = time.perf_counter()
        reset_counts()
        res[name] = fn()
        if quiet and any(read_counts().values()):
            raise AssertionError(f"{name} launched LSTM or flash kernels: {read_counts()}")
        torch.cuda.empty_cache()
        res["part_s"][name] = time.perf_counter() - t1
    res["seconds"] = time.perf_counter() - t0
    log(f"keras_embeddings took {res['seconds']:.1f} s")
    return res


def remat_arms(label, make, ds, loss_steps=REMAT_LOSS_STEPS, turns=REMAT_TURNS, per_step=None):
    """Remat off and on for one model (``make(mode)`` builds it from its
    seed): ``loss_steps`` fit steps of each arm in alternating turns (the
    loss after them, the largest parameter difference on against off), then
    ``turns`` more timed steps of each in alternating turns (median ms and
    the spread), the peak memory of each arm's steps
    (``max_memory_allocated``, reset before each arm's step; also above
    what was allocated before it), then one profiled step of each (device
    busy time and launches beside the wall time: the recompute's device
    work and its host work). With ``per_step`` ({mode: launches}) each
    step's launches are checked."""
    from deeplearning4j_torch import ListDataSetIterator

    nets = {mode: make(mode) for mode in ("off", "on")}
    times = {m: [] for m in nets}
    peaks = {m: 0.0 for m in nets}
    above = {m: 0.0 for m in nets}
    for turn in range(loss_steps + turns):
        for mode in (("off", "on") if turn % 2 == 0 else ("on", "off")):
            net = nets[mode]
            torch.cuda.synchronize()
            base_bytes = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            net.fit(ListDataSetIterator([ds]))
            net.score()                                   # the value: a sync
            ms = (time.perf_counter() - t0) * 1e3
            got = read_counts()
            peak = torch.cuda.max_memory_allocated()
            peaks[mode] = max(peaks[mode], peak / 2 ** 30)
            above[mode] = max(above[mode], (peak - base_bytes) / 2 ** 30)
            if per_step is not None:
                want = {n: per_step[mode].get(n, 0) for n in got}
                if got != want:
                    raise AssertionError(f"{label} remat {mode}: a step launched {got}, "
                                         f"expected {want}")
            if turn >= loss_steps:
                times[mode].append(ms)
        if turn == loss_steps - 1:
            losses = {m: float(nets[m].score()) for m in nets}
            pdiff = max((a.float() - b.float()).abs().max().item() for a, b in
                        zip(nets["off"].parameters(), nets["on"].parameters()))
    if not all(np.isfinite(list(losses.values()))):
        raise AssertionError(f"{label} remat: losses {losses}")
    loss_rel = abs(losses["on"] - losses["off"]) / abs(losses["off"])
    res = {"loss_after": losses, "loss_rel_diff": loss_rel, "max_param_diff": pdiff,
           "step_ms": {m: float(np.median(v)) for m, v in times.items()},
           "step_ms_turns": times, "peak_gib": peaks, "peak_above_start_gib": above}
    log(f"{label} remat off / on ({turns} alternating turns, smoke numbers, not a "
        f"benchmark): {res['step_ms']['off']:.2f} / {res['step_ms']['on']:.2f} ms a step "
        f"(spread {min(times['off']):.2f}-{max(times['off']):.2f} / "
        f"{min(times['on']):.2f}-{max(times['on']):.2f}); peak {peaks['off']:.2f} / "
        f"{peaks['on']:.2f} GiB ({above['off']:.2f} / {above['on']:.2f} above the step's "
        f"start); loss after {loss_steps} steps {losses['off']:.6f} / {losses['on']:.6f} "
        f"(relative difference {loss_rel:.2e}), largest parameter difference {pdiff:.3e}")
    res["profile"] = {}
    for mode, net in nets.items():
        prof = profile_call(f"one {label} step, remat {mode}",
                            lambda: (net.fit(ListDataSetIterator([ds])), net.score()))
        res["profile"][mode] = None if prof is None else {
            k: prof[k] for k in ("wall_ms", "busy_ms", "launches")}
    del nets
    torch.cuda.empty_cache()
    return res


def remat_models():
    """VGG16 and ResNet50 at b=256, 224x224, bf16, Adam (``vgg16_main``'s and
    ``resnet50``'s nets), and the TransformerLM of bench.py:1730 with and
    without attention dropout, each with remat off and on
    (``remat_arms``): the TransformerLM's step launches 16 K5, 8 K6 and 8
    K7 under remat (the forward again in each attention region's
    recompute) and 8 of each without; the card's K1-K7 and GEMMs are
    deterministic, so its losses on and off agree within
    REMAT_LM_LOSS_RTOL, with dropout too (K5's keep bits recomputed). The
    convolutions' backward in cuDNN need not be deterministic, so VGG16 and
    ResNet50 agree within REMAT_CNN_LOSS_RTOL."""
    from deeplearning4j_torch import DataSet
    from deeplearning4j_torch.models import ModelSelector, ResNet50
    from deeplearning4j_torch.nn.conf import CacheMode
    from deeplearning4j_torch.nn.graph import ComputationGraph
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork

    def cnn(build, container):
        def make(mode):
            conf = build().conf()
            conf.global_conf.compute_dtype = "bfloat16"
            conf.global_conf.cache_mode = CacheMode.DEVICE
            conf.global_conf.remat = mode
            return container(conf).init()              # device defaults to the card
        return make

    res = {}
    f, l = zoo_data(np.random.default_rng(0), VGG_B, VGG_IMG, VGG_CLASSES)
    res["vgg16"] = remat_arms("VGG16", cnn(lambda: ModelSelector.select(
        "vgg16", num_classes=VGG_CLASSES, input_shape=VGG_IMG), MultiLayerNetwork),
        DataSet(f, l))
    f, l = zoo_data(np.random.default_rng(0), R50_B, R50_IMG, R50_CLASSES)
    res["resnet50"] = remat_arms("ResNet50", cnn(lambda: ResNet50(
        num_classes=R50_CLASSES, input_shape=R50_IMG), ComputationGraph), DataSet(f, l))
    del f, l
    for name in ("vgg16", "resnet50"):
        if res[name]["loss_rel_diff"] > REMAT_CNN_LOSS_RTOL:
            raise AssertionError(f"{name}: remat on and off part by {res[name]['loss_rel_diff']}")

    f, l = periodic_tokens(np.random.default_rng(8), LM_B, LM_T, LM_VOCAB)
    lm_ds = DataSet(f, l)
    per_step = {"off": {"flash_fwd": LM_BLOCKS, "flash_dq": LM_BLOCKS, "flash_dkv": LM_BLOCKS},
                "on": {"flash_fwd": 2 * LM_BLOCKS, "flash_dq": LM_BLOCKS,
                       "flash_dkv": LM_BLOCKS}}
    for name, rate in (("transformer_lm", 0.0), ("transformer_lm_dropout", LM_DROPOUT_RATE)):
        def make(mode, rate=rate):
            from deeplearning4j_torch.models import TransformerLM

            conf = TransformerLM(vocab_size=LM_VOCAB, embed_dim=LM_E, num_heads=LM_HEADS,
                                 num_blocks=LM_BLOCKS, seed=1, dropout_rate=rate).conf()
            conf.global_conf.compute_dtype = "bfloat16"
            conf.global_conf.cache_mode = CacheMode.DEVICE
            conf.global_conf.remat = mode
            return ComputationGraph(conf).init()
        res[name] = remat_arms(f"TransformerLM{' dropout ' + str(rate) if rate else ''}", make,
                               lm_ds, per_step=per_step)
        res[name]["launches_per_step"] = per_step
        if res[name]["loss_rel_diff"] > REMAT_LM_LOSS_RTOL:
            raise AssertionError(f"{name}: remat on and off part by "
                                 f"{res[name]['loss_rel_diff']} (limit {REMAT_LM_LOSS_RTOL})")
    return res


def remat_char_rnn():
    """The char-RNN of step 4 at b=64, T=200 (4 TBPTT segments) under remat
    "on" and "auto", one unmasked and one masked fit each, the counts set
    to 0 just before each fit: "on" launches K3 with the reserve twice a
    segment (once more in each recompute) and K4 once, masked K1 with the
    reserve four times a segment and K2 twice; "auto" (no convolution)
    launches what a fit always has. The card's K1-K4 are deterministic, so
    "on" and "auto" end bit-equal."""
    from deeplearning4j_torch import DataSet

    rng = np.random.default_rng(REMAT_RNN_SEED)
    f, l = periodic_text(rng, TRAIN_B, TRAIN_SEQ)
    mf, ml, m = masked_text(rng, TRAIN_B, TRAIN_SEQ)
    segs = TRAIN_SEQ // TRAIN_T
    want = {("unmasked", "on"): {"lstm2_fwd_train": 2 * segs, "lstm2_bwd": segs},
            ("unmasked", "auto"): {"lstm2_fwd_train": segs, "lstm2_bwd": segs},
            ("masked", "on"): {"lstm_fwd_train": 4 * segs, "lstm_bwd": 2 * segs},
            ("masked", "auto"): {"lstm_fwd_train": 2 * segs, "lstm_bwd": 2 * segs}}
    res = {"launches": {}, "bitwise": {}}
    for kind, ds in (("unmasked", DataSet(f, l)), ("masked", DataSet(mf, ml, m, m))):
        nets = {}
        for mode in ("on", "auto"):
            conf = char_rnn_conf()
            conf.global_conf.remat = mode
            nets[mode] = build_net(conf)
            got = launches_of(lambda: (nets[mode].fit(ds), nets[mode].score()),
                              want[(kind, mode)], f"char-RNN {kind} fit, remat {mode}")
            res["launches"][f"{kind}_{mode}"] = {k: v for k, v in got.items() if v}
        same = float(nets["on"].score()) == float(nets["auto"].score()) and all(
            torch.equal(a, b) for a, b in zip(nets["on"].parameters(), nets["auto"].parameters()))
        res["bitwise"][kind] = same
        log(f"char-RNN {kind} fit: remat on and auto bit-equal: {same}")
        if not same:
            raise AssertionError(f"char-RNN {kind}: remat on and auto are not bit-equal")
        del nets
    return res


def remat_clustering_kmeans():
    """k-means at a word-vector table's size: ``apply_to`` on KM_N points of
    d=KM_D (f32, from a seed), k=KM_K, at most KM_ITERS Lloyd iterations:
    init s, ms a Lloyd iteration, iterations, inertia, peak GiB; then one
    Lloyd step on the card against the CPU route from the fitted centroids
    on a KM_HOLD_N-point slice: assignments equal but for exact ties (the
    CPU's own distances equal at both picks), centroids and inertia within
    KM_RTOL relative."""
    from deeplearning4j_torch.clustering import KMeansClustering
    from deeplearning4j_torch.clustering import kmeans as km

    x = np.random.default_rng(KM_SEED).standard_normal((KM_N, KM_D), dtype=np.float32)
    model = KMeansClustering.setup(KM_K, KM_ITERS, seed=KM_SEED)   # the card
    init_s = {}
    pp = model._kmeans_pp_init

    def timed_init(*a):
        t0 = time.perf_counter()
        c = pp(*a)
        torch.cuda.synchronize()
        init_s["s"] = time.perf_counter() - t0
        return c
    model._kmeans_pp_init = timed_init
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cs = model.apply_to(x)
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    iters = model.iterations_
    lloyd_ms = (total_s - init_s["s"]) * 1e3 / iters
    xt, ct = torch.as_tensor(x).cuda(), torch.as_tensor(cs.centroids).cuda()
    step_ms = cuda_ms(lambda: km._assign_update(xt, ct), 5)
    del xt, ct
    log(f"k-means n={KM_N} d={KM_D} k={KM_K}: init {init_s['s']:.2f} s, {lloyd_ms:.2f} ms a "
        f"Lloyd iteration of apply_to (smoke number: the points' 512 MB H2D copy, each "
        f"iteration's inertia sync and the results' copy back included) over {iters} "
        f"iterations, {step_ms:.3f} ms a Lloyd step by CUDA events on the resident points; "
        f"inertia {cs.inertia:.6e}, peak {peak:.2f} GiB")
    if not (np.isfinite(cs.inertia) and cs.centroids.shape == (KM_K, KM_D)
            and np.isfinite(cs.centroids).all()):
        raise AssertionError("k-means: non-finite centroids or inertia")

    xs = x[:KM_HOLD_N]
    c = torch.as_tensor(cs.centroids)
    a_card, c_card, in_card = (t.cpu() for t in km._assign_update(
        torch.as_tensor(xs).cuda(), c.cuda()))
    a_cpu, c_cpu, in_cpu = km._assign_update(torch.as_tensor(xs), c)
    differ = (a_card != a_cpu).nonzero().flatten()
    xt = torch.as_tensor(xs[differ.numpy()])
    d2 = ((xt ** 2).sum(1)[:, None] - 2.0 * xt @ c.T + (c ** 2).sum(1)[None, :])
    ties = bool(torch.equal(d2.gather(1, a_card[differ, None]), d2.gather(1, a_cpu[differ, None])))
    cen_err = ((c_card - c_cpu).abs().max() / c_cpu.abs().max()).item()
    in_err = abs(float(in_card) - float(in_cpu)) / abs(float(in_cpu))
    log(f"k-means Lloyd step card vs CPU on {KM_HOLD_N} points: {len(differ)} assignments "
        f"differ (all exact ties: {ties}), centroids {cen_err:.2e}, inertia {in_err:.2e} relative")
    if not ties or cen_err > KM_RTOL or in_err > KM_RTOL:
        raise AssertionError("k-means: the card's Lloyd step disagrees with the CPU's")
    return {"n": KM_N, "d": KM_D, "k": KM_K, "init_s": init_s["s"], "lloyd_ms": lloyd_ms,
            "lloyd_step_event_ms": step_ms,
            "iterations": iters, "inertia": cs.inertia, "peak_gib": peak,
            "hold": {"n": KM_HOLD_N, "assign_differ": len(differ), "centroid_rel": cen_err,
                     "inertia_rel": in_err}}


def remat_clustering_tsne():
    """Exact t-SNE at MNIST's size in van der Maaten & Hinton 2008 (TS_N
    points of d=TS_D from a seed, perplexity 30, 500 iterations): host P s,
    card ms a step, ``kl_``; one ``_tsne_step`` on the card against the CPU
    route from the same state within TS_RTOL of each output's largest entry;
    then Barnes-Hut t-SNE at BH_N points (host only: no launch on the card),
    s an iteration."""
    from deeplearning4j_torch.clustering import BarnesHutTsne, Tsne
    from deeplearning4j_torch.clustering import tsne as ts

    x = np.random.default_rng(TS_SEED).standard_normal((TS_N, TS_D))
    t = Tsne(seed=TS_SEED)                                         # the card
    held = {}
    affinities = t._affinities

    def timed_p(xx):
        t0 = time.perf_counter()
        held["P"] = affinities(xx)
        held["s"] = time.perf_counter() - t0
        return held["P"]
    t._affinities = timed_p
    t0 = time.perf_counter()
    y = t.fit_transform(x)
    step_ms = (time.perf_counter() - t0 - held["s"]) * 1e3 / t.n_iter
    log(f"exact t-SNE n={TS_N} d={TS_D} perplexity {t.perplexity} {t.n_iter} iterations: host P "
        f"{held['s']:.2f} s, {step_ms:.3f} ms a step on the card (smoke number, P's H2D copy "
        f"included), kl {t.kl_:.6f}")
    if y.shape != (TS_N, 2) or not np.isfinite(y).all() or not np.isfinite(t.kl_):
        raise AssertionError("exact t-SNE: non-finite embedding or kl")
    rng = np.random.default_rng(TS_SEED + 1)
    state = (y, held["P"].astype(np.float32), rng.uniform(0.5, 2.0, y.shape).astype(np.float32),
             rng.normal(scale=0.1, size=y.shape).astype(np.float32))
    card = [a.cpu() for a in ts._tsne_step(*(torch.as_tensor(a).cuda() for a in state),
                                           t.learning_rate, t.momentum)]
    cpu = ts._tsne_step(*(torch.as_tensor(a) for a in state), t.learning_rate, t.momentum)
    # a gain flips where the sign of a near-zero gradient rounds the other
    # way; such points are counted, the rest of the step is held
    same = (card[1] == cpu[1]).all(1)
    errs = [((a[same] - b[same]).abs().max() / b[same].abs().max()).item()
            for a, b in ((card[0], cpu[0]), (card[2], cpu[2]))]
    errs.append(abs(float(card[3]) - float(cpu[3])) / abs(float(cpu[3])))
    kinks = int((~same).sum())
    log(f"t-SNE step card vs CPU: y, velocity, kl relative errors "
        + ", ".join(f"{e:.2e}" for e in errs) + f"; {kinks} of {TS_N} points with a flipped gain")
    if max(errs) > TS_RTOL or kinks > TS_N // 1000:
        raise AssertionError(f"t-SNE: the card's step disagrees with the CPU's: {errs}, "
                             f"{kinks} flipped gains")
    res = {"n": TS_N, "d": TS_D, "host_p_s": held["s"], "step_ms": step_ms, "kl": t.kl_,
           "step_rel_errs": errs, "flipped_gains": kinks}

    xb = np.random.default_rng(TS_SEED + 2).standard_normal((BH_N, BH_D))
    secs = {}
    reset_counts()
    for iters in (0, BH_ITERS):
        t0 = time.perf_counter()
        emb = BarnesHutTsne(n_iter=iters, seed=TS_SEED).fit_transform(xb)
        secs[iters] = time.perf_counter() - t0
    if any(read_counts().values()) or not np.isfinite(emb).all():
        raise AssertionError("Barnes-Hut t-SNE: launched a kernel or gave non-finite values")
    bh_s = (secs[BH_ITERS] - secs[0]) / BH_ITERS
    log(f"Barnes-Hut t-SNE n={BH_N} d={BH_D}: {bh_s:.3f} s an iteration on the host over "
        f"{BH_ITERS} iterations, {secs[0]:.2f} s of kNN and P first")
    res["barnes_hut"] = {"n": BH_N, "iterations": BH_ITERS, "s_an_iteration": bh_s,
                         "setup_s": secs[0]}
    return res


def remat_clustering_knn():
    """The nearest-neighbours server over KNN_N points of d=KNN_D: build s,
    KNN_QUERIES ``/knnnew`` queries of k=KNN_K over HTTP (ms a query), each
    answer's indices and distances against a brute-force ``torch.cdist``
    top-k on the card."""
    from deeplearning4j_torch.clustering import NearestNeighborsClient, NearestNeighborsServer

    rng = np.random.default_rng(KNN_SEED)
    pts = rng.standard_normal((KNN_N, KNN_D))
    queries = rng.standard_normal((KNN_QUERIES, KNN_D))
    t0 = time.perf_counter()
    server = NearestNeighborsServer(pts)
    build_s = time.perf_counter() - t0
    port = server.start(0)
    try:
        client = NearestNeighborsClient(f"http://127.0.0.1:{port}")
        t0 = time.perf_counter()
        answers = [client.knn_new(q, KNN_K)["results"] for q in queries]
        query_ms = (time.perf_counter() - t0) * 1e3 / KNN_QUERIES
    finally:
        server.stop()
    d = torch.cdist(torch.as_tensor(queries).cuda(), torch.as_tensor(pts).cuda())
    dist, idx = d.topk(KNN_K, largest=False)
    idx, dist = idx.cpu().numpy(), dist.cpu().numpy()
    bad = [i for i, a in enumerate(answers)
           if [r["index"] for r in a] != idx[i].tolist()
           or not np.allclose([r["distance"] for r in a], dist[i], rtol=1e-9, atol=1e-9)]
    log(f"kNN server n={KNN_N} d={KNN_D}: VPTree built in {build_s:.2f} s, {query_ms:.1f} ms a "
        f"/knnnew query (k={KNN_K}, {KNN_QUERIES} over HTTP); answers against torch.cdist "
        f"top-k on the card: {KNN_QUERIES - len(bad)} of {KNN_QUERIES} equal")
    if bad:
        raise AssertionError(f"kNN server: queries {bad[:5]} differ from the brute force")
    return {"n": KNN_N, "d": KNN_D, "k": KNN_K, "queries": KNN_QUERIES, "build_s": build_s,
            "query_ms": query_ms}


def conv_step_flops(net, img):
    """The convolutions' FLOPs of one fit step of ``net`` at batch 1 on
    ``img``: 2 · Ho·Wo·Cout · kh·kw·Cin a convolution forward, as much again
    for its weight gradient and for its input gradient (not for the first
    layer's input), read from one forward's shapes."""
    from deeplearning4j_torch.nn.layers.convolution import Conv2DImpl

    seen = []
    hooks = [m.register_forward_hook(lambda mod, a, out: seen.append(
        (2 * out[0].numel() * mod.W.shape[0] * mod.W.shape[1] * mod.W.shape[2])))
        for m in net.modules() if type(m) is Conv2DImpl]
    try:
        net.output(np.zeros((1, *img), np.float32))
    finally:
        for h in hooks:
            h.remove()
    return 3 * sum(seen) - seen[0]


def remat_clustering_profiler():
    """``utils/profiling.py`` on the card: ``trace`` around one TransformerLM
    step (its Chrome trace must name K5's kernel); ``step_cost`` of VGG16
    at b=256 beside the smoke's own count of its convolutions' FLOPs, and
    of the TransformerLM beside K5-K7's FLOPs by the bound formulas (the
    kernels launch through ctypes, so the dispatcher counts none of it);
    ``StepTimerListener`` over PROF_FITS VGG16 fits (p50/p95)."""
    from deeplearning4j_torch import DataSet
    from deeplearning4j_torch.models import ModelSelector
    from deeplearning4j_torch.nn.conf import CacheMode
    from deeplearning4j_torch.nn.graph import ComputationGraph
    from deeplearning4j_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_torch.utils.profiling import StepTimerListener, step_cost, trace

    res = {}
    lm = ComputationGraph(lm_conf()).init()
    f, l = periodic_tokens(np.random.default_rng(9), LM_B, LM_T, LM_VOCAB)
    ds = DataSet(f, l)
    lm.fit(ds)
    out_dir = Path("build") / "remat_clustering_trace"
    shutil.rmtree(out_dir, ignore_errors=True)
    with trace(str(out_dir)) as prof:
        lm.fit(ds)
        lm.score()
    files = sorted(out_dir.glob("*.json"))
    text = files[-1].read_text() if files else ""
    k5 = "flash_fwd_wgmma" in text
    log(f"trace around one TransformerLM step: {files[-1] if files else None}, "
        f"{len(text) / 1e6:.1f} MB, K5's kernel (flash_fwd_wgmma) named: {k5}")
    if not k5:
        raise AssertionError("the profiler's trace of a TransformerLM step does not name K5")
    del prof
    cost = step_cost(lm, ds)
    bh, t, d = LM_B * LM_HEADS, LM_T, LM_D
    cells = bh * t * (t + 1) // 2
    kernel_flops = LM_BLOCKS * (2 + 3 + 4) * 2 * d * cells
    log(f"step_cost of a TransformerLM step: {cost['flops'] / 1e12:.3f} TFLOP counted by the "
        f"dispatcher, {cost['bytes_accessed'] / 1e9:.1f} GB; K5-K7 add {kernel_flops / 1e12:.3f} "
        f"TFLOP it cannot see (bound formulas: 2, 3 and 4 products of 2·d a visible cell)")
    res["transformer_lm"] = {"flops": cost["flops"], "bytes": cost["bytes_accessed"],
                             "k5_k7_flops_unseen": kernel_flops}
    del lm, ds
    torch.cuda.empty_cache()

    conf = ModelSelector.select("vgg16", num_classes=VGG_CLASSES, input_shape=VGG_IMG).conf()
    conf.global_conf.compute_dtype = "bfloat16"
    conf.global_conf.cache_mode = CacheMode.DEVICE
    net = MultiLayerNetwork(conf).init()
    f, l = zoo_data(np.random.default_rng(0), VGG_B, VGG_IMG, VGG_CLASSES)
    ds = DataSet(f, l)
    cost = step_cost(net, ds)
    conv = conv_step_flops(net, VGG_IMG) * VGG_B
    log(f"step_cost of a VGG16 step b={VGG_B}: {cost['flops'] / 1e12:.3f} TFLOP, "
        f"{cost['bytes_accessed'] / 1e9:.1f} GB; the smoke's count of its convolutions "
        f"{conv / 1e12:.3f} TFLOP (ratio {cost['flops'] / conv:.4f})")
    res["vgg16"] = {"flops": cost["flops"], "bytes": cost["bytes_accessed"], "conv_flops": conv}
    timer = StepTimerListener()
    net.set_listeners(timer)
    for _ in range(PROF_FITS):
        net.fit(ds)
    s = timer.summary()
    log(f"StepTimerListener over {PROF_FITS} VGG16 fits: p50 {s['p50_ms']:.2f} ms, p95 "
        f"{s['p95_ms']:.2f} ms ({int(s['n'])} intervals)")
    res["vgg16"]["step_timer"] = s
    del net, ds
    torch.cuda.empty_cache()
    return res


def remat_clustering(smi):
    """Remat, clustering and the profiler on the card (step 23 of the module
    docstring): ``remat_models``, ``remat_char_rnn``,
    ``remat_clustering_kmeans``, ``remat_clustering_tsne``,
    ``remat_clustering_knn`` and ``remat_clustering_profiler``, the counts
    set to 0 just before each and read just after: only the TransformerLM
    and char-RNN parts launch K1-K7."""
    t0 = time.perf_counter()
    res = {"card": smi, "part_s": {}}
    for name, fn, quiet in (("models", remat_models, False),
                            ("char_rnn", remat_char_rnn, False),
                            ("kmeans", remat_clustering_kmeans, True),
                            ("tsne", remat_clustering_tsne, True),
                            ("knn", remat_clustering_knn, True),
                            ("profiler", remat_clustering_profiler, False)):
        t1 = time.perf_counter()
        reset_counts()
        res[name] = fn()
        if quiet and any(read_counts().values()):
            raise AssertionError(f"{name} launched LSTM or flash kernels: {read_counts()}")
        torch.cuda.empty_cache()
        res["part_s"][name] = time.perf_counter() - t1
        log(f"remat_clustering {name}: {res['part_s'][name]:.1f} s ({smi})")
    res["seconds"] = time.perf_counter() - t0
    log(f"remat_clustering took {res['seconds']:.1f} s")
    return res


def launches_of_run(fn):
    """``fn()``'s kernel launches: counts set to 0 just before, read just
    after (a sync between)."""
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {n: c for n, c in read_counts().items() if c}


def masked_batch(rng, b, t):
    """Periodic text with a features and labels mask of random lengths in
    the last quarter of the sequence (so the last TBPTT segment has steps
    that count)."""
    f, l = periodic_text(rng, b, t)
    lengths = rng.integers(t - t // 4 + 1, t + 1, b)
    m = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    return f, l, m


def param_diff(a, b):
    """Largest |a - b| over every parameter of two networks."""
    return max((pa.float() - pb.float()).abs().max().item()
               for (_, pa), (_, pb) in zip(leaves_of(a.params), leaves_of(b.params)))


def leaves_of(tree):
    from deeplearning4j_torch.utils.trees import leaves
    return list(leaves(tree))


def grad_rel(after, before, ref_after):
    """With SGD at learning rate 1, ``before - after`` is a step's
    gradient: the largest error of one run's against the reference's,
    relative to each tensor's largest entry, over every tensor."""
    worst = 0.0
    for (_, b0), (_, a), (_, r) in zip(before, leaves_of(after.params),
                                       leaves_of(ref_after.params)):
        g, gr = (b0 - a.float()), (b0 - r.float())
        worst = max(worst, ((g - gr).abs().max() / gr.abs().max().clamp_min(1e-30)).item())
    return worst


def recording_updates(net):
    """Record the gradients of every update ``net`` applies (float copies,
    one {path: tensor} a TBPTT segment)."""
    rec = []
    apply = net._apply_update

    def hook(grads, iteration):
        rec.append({p: t.detach().float().clone() for p, t in leaves_of(grads)})
        return apply(grads, iteration)
    net._apply_update = hook
    return rec


def updates_rel(got, ref):
    """The largest error of recorded gradients against the reference's,
    relative to each tensor's largest entry, over every update and tensor."""
    if len(got) != len(ref) or any(g.keys() != r.keys() for g, r in zip(got, ref)):
        raise AssertionError(f"{len(got)} recorded updates against {len(ref)}")
    return max(((g[p] - r[p]).abs().max() / r[p].abs().max().clamp_min(1e-30)).item()
               for g, r in zip(got, ref) for p in r)


def wrapper_gradients(ds, slots, control=False):
    """One AVERAGING fit of the char-RNN at SGD PW_SGD_LR on ``slots``
    against one net's: (gradients' error, loss rel error). ``control``
    reduces only slot 0's gradients."""
    from deeplearning4j_torch import Sgd
    from deeplearning4j_torch.parallel import ParallelWrapper

    conf = char_rnn_conf()
    conf.global_conf.updater = Sgd(learning_rate=PW_SGD_LR)
    single, dp = build_net(conf), build_net(conf)
    ref, got = recording_updates(single), recording_updates(dp)
    pw = ParallelWrapper(dp, devices=slots, prefetch_workers=0)
    if control:
        step = pw._ensure_sync_step()
        reduce = step.reduce
        step.reduce = lambda per_slot: reduce(per_slot[:1])
    pw.fit(ds)
    single.fit(ds)
    err = updates_rel(got, ref)
    loss_err = abs(pw.last_score - single.score()) / abs(single.score())
    del single, dp, pw
    return err, loss_err


def parallel_wrapper_char_rnn():
    """ParallelWrapper over the char-RNN on PW_SLOTS slots of the card:
    AVERAGING (frequency 1) unmasked, K3 + K4 a slot a segment, and
    masked, 2 K1 + 2 K2 a slot a segment, each held on its gradients
    against one net's fit on the same global batch (with a control that
    must fail the check); local SGD and SHARED_GRADIENTS (losses finite
    and falling, launches exact); fits timed beside the single net's."""
    from deeplearning4j_torch import DataSet
    from deeplearning4j_torch.parallel import ParallelWrapper, TrainingMode

    conf = char_rnn_conf()
    rng = np.random.default_rng(PW_SEED)
    slots = ["cuda:0"] * PW_SLOTS
    segs = TRAIN_SEQ // TRAIN_T
    out = {"slots": PW_SLOTS, "global_b": TRAIN_B, "T": TRAIN_SEQ}
    f, l = periodic_text(rng, TRAIN_B, TRAIN_SEQ)
    fm, lm, m = masked_batch(rng, TRAIN_B, TRAIN_SEQ)
    for label, ds, want in (
            ("unmasked", DataSet(f, l), {"lstm2_fwd_train": segs * PW_SLOTS,
                                         "lstm2_bwd": segs * PW_SLOTS}),
            ("masked", DataSet(fm, lm, m, m), {"lstm_fwd_train": 2 * segs * PW_SLOTS,
                                               "lstm_bwd": 2 * segs * PW_SLOTS})):
        g_err, loss_err = wrapper_gradients(ds, slots)
        g_ctl, _ = wrapper_gradients(ds, slots, control=True)
        log(f"ParallelWrapper AVERAGING {label} on {PW_SLOTS} slots of the card (b={TRAIN_B} "
            f"T={TRAIN_SEQ}, {segs} TBPTT segments, SGD {PW_SGD_LR}): each segment's reduced "
            f"gradients within {g_err:.2e} of one net's, relative to each tensor's largest "
            f"entry (limit {PW_GRAD_RTOL}; the control reducing slot 0's alone reads "
            f"{g_ctl:.2e}); loss rel {loss_err:.2e} (limit {PW_LOSS_RTOL})")
        if not (g_err <= PW_GRAD_RTOL and loss_err <= PW_LOSS_RTOL and g_ctl > PW_GRAD_RTOL):
            raise AssertionError(f"ParallelWrapper {label}: gradients rel {g_err}, loss rel "
                                 f"{loss_err}, control {g_ctl}")
        single, dp = build_net(conf), build_net(conf)
        pw = ParallelWrapper(dp, devices=slots, prefetch_workers=0)
        _, got = launches_of_run(lambda: pw.fit(ds))
        if got != want:
            raise AssertionError(f"ParallelWrapper {label} fit launched {got}, expected {want}")
        single.fit(ds)
        turns = {"wrapper": [], "single": []}
        for t in range(PW_TURNS):
            for arm in (("wrapper", "single") if t % 2 == 0 else ("single", "wrapper")):
                fn = (lambda: pw.fit(ds)) if arm == "wrapper" else (lambda: single.fit(ds))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                turns[arm].append((time.perf_counter() - t0) * 1e3)
        ms = {k: float(np.median(v)) for k, v in turns.items()}
        log(f"  Adam fits: launches {got}; a fit: wrapper {ms['wrapper']:.1f} ms, one net "
            f"{ms['single']:.1f} ms (medians of {PW_TURNS} alternating turns: {turns})")
        out[label] = {"launches": got, "grad_rel_err": g_err, "control_grad_rel_err": g_ctl,
                      "loss_rel_err": loss_err, "fit_ms": ms["wrapper"],
                      "single_fit_ms": ms["single"]}
        del single, dp, pw
    # a fit of PW_LOCAL_FREQ batches: local SGD runs each batch on every
    # slot; SHARED_GRADIENTS groups PW_SLOTS batches into one global batch
    # (the last group's TRAIN_B rows divide the slots), one sharded step
    groups = -(-PW_LOCAL_FREQ // PW_SLOTS)
    for label, kw, steps in (
            ("local_sgd", {"averaging_frequency": PW_LOCAL_FREQ}, PW_LOCAL_FREQ),
            ("shared_gradients", {"training_mode": TrainingMode.SHARED_GRADIENTS}, groups)):
        net = build_net(conf)
        pw = ParallelWrapper(net, devices=slots, prefetch_workers=0, **kw)
        sets = [DataSet(*periodic_text(rng, TRAIN_B, TRAIN_SEQ))
                for _ in range(PW_LOCAL_FREQ)]
        losses = []
        reset_counts()
        for _ in range(PW_ROUNDS):
            pw.fit(sets)
            losses.append(pw.last_score)
        torch.cuda.synchronize()
        got = {n: c for n, c in read_counts().items() if c}
        k = segs * PW_SLOTS * steps * PW_ROUNDS
        want = {"lstm2_fwd_train": k, "lstm2_bwd": k}
        log(f"ParallelWrapper {label} on {PW_SLOTS} slots: {PW_ROUNDS} fits of "
            f"{len(sets)} batches, losses {' '.join(f'{x:.4f}' for x in losses)}; "
            f"launches {got} (expected {want})")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"ParallelWrapper {label}: losses {losses}")
        if got != want:
            raise AssertionError(f"ParallelWrapper {label} launched {got}, expected {want}")
        if label == "shared_gradients":
            acc = pw.accumulator
            log(f"  encoded update {acc.encoded_bytes()} bytes a round, threshold "
                f"{acc._handler.threshold:.2e}")
        out[label] = {"launches": got, "losses": losses}
        del net, pw
    torch.cuda.empty_cache()
    return out


def parallel_inference_char_rnn():
    """ParallelInference (BATCHED, PW_SLOTS slots) serving the char-RNN:
    PI_REQUESTS concurrent requests unmasked (K3 a slot a batch) and
    masked (2 K1 a slot a batch), each answer against ``output`` on the
    same rows."""
    from deeplearning4j_torch.parallel import InferenceMode, ParallelInference

    net = build_net(char_rnn_conf())
    rng = np.random.default_rng(PW_SEED + 1)
    pi = ParallelInference(net, mode=InferenceMode.BATCHED, devices=["cuda:0"] * PW_SLOTS,
                           batch_limit=PI_REQUESTS * PI_ROWS, queue_limit=PI_REQUESTS,
                           flush_after_ms=50.0)
    batches = []
    forward = pi._forward
    pi._forward = lambda x, m=None: batches.append(len(x)) or forward(x, m)
    out = {}
    try:
        for label, masked in (("unmasked", False), ("masked", True)):
            batches.clear()
            xs = [one_hot(rng, PI_ROWS, T) for _ in range(PI_REQUESTS)]
            ms = ([(np.arange(T)[None, :] < rng.integers(T // 2, T + 1, (PI_ROWS, 1)))
                   .astype(np.float32) for _ in range(PI_REQUESTS)] if masked
                  else [None] * PI_REQUESTS)
            t0 = time.perf_counter()
            answers, got = launches_of_run(lambda: [f.result(timeout=60) for f in [
                pi.submit(x, mask=m) for x, m in zip(xs, ms)]])
            wall = (time.perf_counter() - t0) * 1e3
            err = 0.0
            for x, m, a in zip(xs, ms, answers):
                ref = net.output(x, mask=m).float().cpu().numpy()
                err = max(err, float(np.abs(a - ref).max()))
            # each batch runs every slot's output: 2 K1 (masked) or one K3
            want = ({"lstm_fwd": 2 * PW_SLOTS * len(batches)} if masked
                    else {"lstm2_fwd": PW_SLOTS * len(batches)})
            log(f"ParallelInference {label}: {PI_REQUESTS} requests of {PI_ROWS} rows (T={T}) "
                f"on {PW_SLOTS} slots in {wall:.1f} ms, as batches of {batches} rows; "
                f"launches {got} (expected {want}); largest difference from output on the "
                f"same rows {err:.2e} (limit {PI_ATOL})")
            if got != want or err > PI_ATOL or any(a.shape != (PI_ROWS, T, VOCAB)
                                                   for a in answers):
                raise AssertionError(f"ParallelInference {label}: launches {got} (want {want}), "
                                     f"err {err}")
            out[label] = {"launches": got, "batches": list(batches), "max_abs_err": err,
                          "ms": wall}
    finally:
        pi.close()
    return out


def sdpa_ms(b, h, tq, d, causal, reps=10):
    """scaled_dot_product_attention at [b, h, tq, d] bf16: (forward ms,
    backward ms)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn((b, h, tq, d), generator=g, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    fwd = cuda_ms(lambda: sdpa(q, k, v, is_causal=causal), reps)
    o = sdpa(q, k, v, is_causal=causal)
    bwd = cuda_ms(lambda: torch.autograd.grad(o, (q, k, v), do, retain_graph=True), reps)
    return fwd, bwd


def flash_shape_row(label, bh, tq, d, causal):
    """K5, K6 and K7 at one shape of the sequence-parallel paths: times,
    largest error against the plain versions, bound, SDPA's times."""
    from deeplearning4j_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(7)
    q, k, v, do = (torch.randn((bh, tq, d), generator=g).to("cuda", torch.bfloat16)
                   for _ in range(4))
    scale = d ** -0.5
    o, lse = fa.flash_fwd(q, k, v, None, causal, scale)
    delta = fa.rowwise_delta(do, o)
    args = (q, k, v, None, do, delta, lse, causal, scale)
    dq = fa.dq_block(*args)
    dk, dv = fa.dkv_block(*args)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, None, causal, scale)
    dq_p = fa.flash_dq_plain(*args)
    dk_p, dv_p = fa.flash_dkv_plain(*args)
    errs = {"flash_fwd": max((o.float() - o_p.float()).abs().max().item(),
                             (lse - lse_p).abs().max().item()),
            "flash_dq": (dq.float() - dq_p.float()).abs().max().item(),
            "flash_dkv": max((dk.float() - dk_p.float()).abs().max().item(),
                             (dv.float() - dv_p.float()).abs().max().item())}
    ms = {"flash_fwd": cuda_ms(lambda: fa.flash_fwd(q, k, v, None, causal, scale), 10),
          "flash_dq": cuda_ms(lambda: fa.dq_block(*args), 10),
          "flash_dkv": cuda_ms(lambda: fa.dkv_block(*args), 10)}
    plain = {"flash_fwd": cuda_ms(lambda: fa.flash_fwd_plain(q, k, v, None, causal, scale), 1),
             "flash_dq": cuda_ms(lambda: fa.flash_dq_plain(*args), 1),
             "flash_dkv": cuda_ms(lambda: fa.flash_dkv_plain(*args), 1)}
    b = bh // LM_HEADS if bh % LM_HEADS == 0 and bh >= LM_HEADS else 1
    sd_fwd, sd_bwd = sdpa_ms(b, bh // b, tq, d, causal)
    cells = bh * (tq * (tq + 1) // 2 if causal else tq * tq)
    x, rows = bh * tq * d * 2, bh * tq * 4
    work = {"flash_fwd": (4 * x + rows, 2 * 2 * d * cells),
            "flash_dq": (5 * x + 2 * rows, 3 * 2 * d * cells),
            "flash_dkv": (6 * x + 2 * rows, 4 * 2 * d * cells)}
    out = {}
    for name, (nbytes, flops) in work.items():
        bms, by = bound(nbytes, flops, 0)
        out[name] = {"ms": ms[name], "plain_ms": plain[name], "bound_ms": bms, "bound_by": by,
                     "library_ms": sd_fwd if name == "flash_fwd" else sd_bwd,
                     "max_abs_err": errs[name],
                     "shape": {"bh": bh, "T": tq, "d": d, "causal": causal}}
    log(f"K5/K6/K7 at the {label} shape bh={bh} T={tq} d={d} causal={causal}: ms "
        f"{ms['flash_fwd']:.3f} / {ms['flash_dq']:.3f} / {ms['flash_dkv']:.3f}, bounds "
        f"{out['flash_fwd']['bound_ms']:.4f} / {out['flash_dq']['bound_ms']:.4f} / "
        f"{out['flash_dkv']['bound_ms']:.4f}, SDPA forward {sd_fwd:.3f} backward {sd_bwd:.3f}; "
        f"errors vs plain {errs}")
    return out


def sp_attention_kernels():
    """ring_flash_attention and ulysses_flash_attention at b=LM_B, h=LM_HEADS,
    T=LM_T, d=LM_D bf16 over SP_SLOTS slots of the card against the port's
    single-kernel flash_attention on the whole T (causal and not; the ring
    also with dropout LM_DROPOUT_RATE at a seed): o and dq/dk/dv, with the
    blocks each route launches; then the kernels timed at the ring's shard
    shapes and Ulysses' shape."""
    from deeplearning4j_torch.ops import flash_attention as fa
    from deeplearning4j_torch.parallel import (make_mesh, ring_flash_attention,
                                               ulysses_flash_attention)

    mesh = make_mesh(["cuda:0"] * SP_SLOTS, axes=("sequence",))
    g = torch.Generator().manual_seed(SP_SEED)
    shape = (LM_B, LM_T, LM_HEADS, LM_D)
    base = [torch.randn(shape, generator=g).to("cuda", torch.bfloat16) for _ in range(4)]
    do = base[3]
    n = SP_SLOTS
    results = {}

    def run(fn):
        q, k, v = (x.clone().requires_grad_() for x in base[:3])
        o = fn(q, k, v)
        grads = torch.autograd.grad(o, (q, k, v), do)
        return o.detach(), grads

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    seed = 987654321
    cases = (("ring causal", True, 0.0, "ring", n * (n + 1) // 2),
             ("ring non-causal", False, 0.0, "ring", n * n),
             ("ring causal dropout", True, LM_DROPOUT_RATE, "ring", n * (n + 1) // 2),
             ("ulysses causal", True, 0.0, "ulysses", n),
             ("ulysses non-causal", False, 0.0, "ulysses", n))
    for label, causal, rate, route, blocks in cases:
        sd = seed if rate else None
        ref_o, ref_g = run(lambda q, k, v: fa.flash_attention(
            q, k, v, causal=causal, dropout_rate=rate, dropout_seed=sd))
        if route == "ring":
            fn = lambda q, k, v: ring_flash_attention(q, k, v, mesh, causal=causal,
                                                      dropout_rate=rate, dropout_seed=sd)
        else:
            fn = lambda q, k, v: ulysses_flash_attention(q, k, v, mesh, causal=causal)
        (o, grads), got = launches_of_run(lambda: run(fn))
        want = {"flash_fwd": blocks, "flash_dq": blocks, "flash_dkv": blocks}
        errs = {"o": rel(o, ref_o), **{w: rel(a, b) for w, a, b in zip(("dq", "dk", "dv"),
                                                                        grads, ref_g)}}
        t_route = cuda_ms(lambda: fn(*base[:3]), 3)
        t_ref = cuda_ms(lambda: fa.flash_attention(*base[:3], causal=causal,
                                                   dropout_rate=rate, dropout_seed=sd), 3)
        log(f"{label} over {n} slots (b={LM_B} h={LM_HEADS} T={LM_T} d={LM_D} bf16): "
            f"launches {got} (expected {blocks} each); rel err o {errs['o']:.2e} dq "
            f"{errs['dq']:.2e} dk {errs['dk']:.2e} dv {errs['dv']:.2e} vs the single kernel "
            f"on the whole T; forward {t_route:.3f} ms vs the single kernel's {t_ref:.3f} ms")
        if got != want or max(errs.values()) > FLASH_RTOL:
            raise AssertionError(f"{label}: launches {got} (want {want}), errors {errs}")
        results[label] = {"launches": got, "rel_err": errs, "fwd_ms": t_route,
                          "single_kernel_fwd_ms": t_ref}
    tl = LM_T // n
    results["rows"] = {
        "ring_diagonal": flash_shape_row("ring diagonal block", LM_B * LM_HEADS, tl, LM_D, True),
        "ring_off_diagonal": flash_shape_row("ring off-diagonal block", LM_B * LM_HEADS, tl,
                                             LM_D, False),
        "ulysses": flash_shape_row("Ulysses", LM_B * LM_HEADS // n, LM_T, LM_D, True)}
    del base
    torch.cuda.empty_cache()
    return results


def sp_lm_conf(rate=0.0, sgd=False, experts=0, blocks=LM_BLOCKS, compute="bfloat16"):
    from deeplearning4j_torch import Sgd

    c = lm_conf(blocks=blocks, experts=experts, compute=compute)
    for v in c.vertices.values():
        if hasattr(v, "dropout_rate"):
            v.dropout_rate = rate
    if sgd:
        c.global_conf.updater = Sgd(learning_rate=1.0)
    return c


def sgd_step_err(par_conf, ref_conf, mesh_step, f, l):
    """One step of ``mesh_step`` on a network of ``par_conf`` and one
    unsharded ``fit`` step of ``ref_conf``, both at SGD(1): the gradients'
    largest error relative to each tensor's largest entry."""
    from deeplearning4j_torch import DataSet
    from deeplearning4j_torch.nn.graph import ComputationGraph

    par, ref = ComputationGraph(par_conf).init(), ComputationGraph(ref_conf).init()
    before = [(k, t.detach().float().clone()) for k, t in leaves_of(par.params)]
    step = mesh_step(par)
    step((f,), (l,))
    ref.fit(DataSet(f, l))
    err = grad_rel(par, before, ref)
    del par, ref, step, before
    torch.cuda.empty_cache()
    return err


def held_step(label, make_conf, mesh_step, per_step, turns=SP_TURNS,
              score_rtol=LM_REF_SCORE_RTOL, grad_rtol=LM_REF_GRAD_RTOL, control_conf=None):
    """``mesh_step`` (a parallel step factory) on a fresh network against
    the unsharded ``fit`` step of an identical one: Adam for the main
    path's launches, losses and times; SGD at learning rate 1 for the
    parameters (the step's gradients). ``control_conf(sgd)``, when given,
    builds the parallel side of a control run that must read above
    ``grad_rtol``."""
    from deeplearning4j_torch import DataSet
    from deeplearning4j_torch.nn.graph import ComputationGraph

    f, l = periodic_tokens(np.random.default_rng(SP_SEED), LM_B, LM_T, LM_VOCAB)
    ds = DataSet(f, l)
    par, ref = (ComputationGraph(make_conf(False)).init() for _ in range(2))
    step = mesh_step(par)
    loss, got = launches_of_run(lambda: float(step((f,), (l,))))
    _, got_ref = launches_of_run(lambda: ref.fit(ds))
    ref_loss = ref.score()
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    if got != per_step:
        raise AssertionError(f"{label} step launched {got}, expected {per_step}")
    times = {"parallel": [], "unsharded": []}
    for t in range(turns):
        for arm in (("parallel", "unsharded") if t % 2 == 0 else ("unsharded", "parallel")):
            fn = (lambda: float(step((f,), (l,)))) if arm == "parallel" else \
                (lambda: (ref.fit(ds), ref.score()))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times[arm].append((time.perf_counter() - t0) * 1e3)
    ms = {k: float(np.median(v)) for k, v in times.items()}
    del par, ref, step
    torch.cuda.empty_cache()
    g_err = sgd_step_err(make_conf(True), make_conf(True), mesh_step, f, l)
    g_ctl = (None if control_conf is None
             else sgd_step_err(control_conf(True), make_conf(True), mesh_step, f, l))
    log(f"{label}: launches a step {got} (the unsharded step's {got_ref}); loss {loss:.4f} vs "
        f"the unsharded step's {ref_loss:.4f} (rel {loss_err:.2e}, limit {score_rtol}); one "
        f"SGD(1) step's parameters (the gradients) within {g_err:.2e} of the largest entry "
        f"(limit {grad_rtol}" + ("" if g_ctl is None else f"; the control reads {g_ctl:.2e}")
        + f"); a step {ms['parallel']:.1f} ms vs {ms['unsharded']:.1f} ms unsharded (medians "
        f"of {turns} alternating turns)")
    if loss_err > score_rtol or g_err > grad_rtol or (g_ctl is not None and g_ctl <= grad_rtol):
        raise AssertionError(f"{label}: loss rel {loss_err}, gradient rel {g_err}, "
                             f"control {g_ctl}")
    return {"launches": got, "unsharded_launches": got_ref, "loss_rel_err": loss_err,
            "grad_rel_err": g_err, "control_grad_rel_err": g_ctl, "step_ms": ms["parallel"],
            "unsharded_step_ms": ms["unsharded"]}


def sp_transformer_lm():
    """sequence_parallel_step over the full-width TransformerLM on SP_SLOTS
    slots: Ulysses without dropout (SP_SLOTS K5 a layer), the ring with
    attention dropout (SP_SLOTS (SP_SLOTS + 1) / 2 blocks a layer), each
    against the unsharded step; then expert_parallel_step over the MoE
    variant cut to EP_BLOCKS blocks on EP_SLOTS slots."""
    from deeplearning4j_torch.parallel import (expert_parallel_step, make_mesh,
                                               sequence_parallel_step)

    mesh = make_mesh(["cuda:0"] * SP_SLOTS, axes=("sequence",))
    n = SP_SLOTS

    def sp(net):
        return sequence_parallel_step(net, mesh)

    def want(k):
        return {"flash_fwd": k, "flash_dq": k, "flash_dkv": k}
    out = {"ulysses": held_step("sp step (Ulysses)", lambda sgd: sp_lm_conf(sgd=sgd), sp,
                                want(LM_BLOCKS * n)),
           "ring_dropout": held_step("sp step (ring, attention dropout)",
                                     lambda sgd: sp_lm_conf(LM_DROPOUT_RATE, sgd), sp,
                                     want(LM_BLOCKS * n * (n + 1) // 2))}
    emesh = make_mesh(["cuda:0"] * EP_SLOTS, axes=("expert",))

    def ep(net):
        step, place = expert_parallel_step(net, emesh)
        place(net)
        return lambda f, l: step(f, l)[0]
    out["expert"] = held_step(f"expert parallel step ({MOE_EXPERTS} experts over {EP_SLOTS} "
                              f"slots, {EP_BLOCKS} blocks, f32; control: the step in bf16)",
                              lambda sgd: sp_lm_conf(sgd=sgd, experts=MOE_EXPERTS,
                                                     blocks=EP_BLOCKS, compute="float32"),
                              ep, want(EP_BLOCKS), score_rtol=EP_SCORE_RTOL,
                              grad_rtol=EP_GRAD_RTOL,
                              control_conf=lambda sgd: sp_lm_conf(
                                  sgd=sgd, experts=MOE_EXPERTS, blocks=EP_BLOCKS))
    return out


def parallel(smi):
    """The parallel phase: ParallelWrapper and ParallelInference over the
    char-RNN, the ring and Ulysses at the TransformerLM's attention shape,
    the sequence- and expert-parallel steps."""
    t0 = time.perf_counter()
    log(f"--- parallel ({smi})")
    res = {"wrapper": parallel_wrapper_char_rnn()}
    res["inference"] = parallel_inference_char_rnn()
    res["attention"] = sp_attention_kernels()
    res["steps"] = sp_transformer_lm()
    res["seconds"] = time.perf_counter() - t0
    log(f"parallel phase took {res['seconds']:.1f} s")
    return res


# --------------------------------------------------- pipeline_paramserver
def pp_char_rnn_conf(sgd=False):
    """TextGenerationLSTM(VOCAB, H, PP_LAYERS) in bf16 (Adam; SGD at
    learning rate 1 for the gradient checks)."""
    from deeplearning4j_torch import Sgd
    from deeplearning4j_torch.models import TextGenerationLSTM

    conf = TextGenerationLSTM(total_unique_characters=VOCAB, lstm_size=H,
                              num_layers=PP_LAYERS, seed=1).conf()
    conf.global_conf.compute_dtype = "bfloat16"
    if sgd:
        conf.global_conf.updater = Sgd(learning_rate=1.0)
    return conf


def unpipelined_step(net, inputs, labels):
    """One standard-backprop step through the container's seam
    (``_train_loss`` -> ``_update``), no TBPTT; the loss."""
    put = net._to_device
    if hasattr(net.conf, "vertices"):
        loss, _, new_states = net._train_loss((put(inputs),), (put(labels),), None, None)
    else:
        loss, _, new_states = net._train_loss(put(inputs), put(labels), None, None)
    net._update(loss, net.iteration_count)
    net._commit_states(new_states)
    net.iteration_count += 1
    return loss.detach()


def drop_first_microbatch(pp):
    """The control: the pipelined step's first microbatch loss counts 0."""
    conf = pp.model.conf
    out = (pp.model.impls[conf.network_outputs[0]] if hasattr(conf, "vertices")
           else pp.model.impls[-1])
    real, calls = out.loss_on, []

    def loss_on(*a, **kw):
        v = real(*a, **kw)
        calls.append(1)
        return v * 0.0 if len(calls) == 1 else v
    out.loss_on = loss_on


def pp_held(label, make_conf, make_net, make_pp, f, l, per_step, grad_rtol):
    """A pipelined step against the unpipelined step of an identical net:
    Adam for launches, loss and times; SGD(1) for the gradients, with the
    control that drops microbatch 0."""
    pipe_net, ref = make_net(make_conf(False)), make_net(make_conf(False))
    pp = make_pp(pipe_net)
    loss, got = launches_of_run(lambda: float(pp.fit_batch(f, l)))
    ref_loss, got_ref = launches_of_run(lambda: float(unpipelined_step(ref, f, l)))
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    if got != per_step:
        raise AssertionError(f"{label}: a step launched {got}, expected {per_step}")
    times = {"pipelined": [], "unpipelined": []}
    for t in range(PP_TURNS):
        for arm in (("pipelined", "unpipelined") if t % 2 == 0
                    else ("unpipelined", "pipelined")):
            fn = ((lambda: float(pp.fit_batch(f, l))) if arm == "pipelined"
                  else (lambda: float(unpipelined_step(ref, f, l))))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times[arm].append((time.perf_counter() - t0) * 1e3)
    ms = {k: float(np.median(v)) for k, v in times.items()}
    del pipe_net, ref, pp
    torch.cuda.empty_cache()

    def sgd_err(control):
        pipe_net, ref = make_net(make_conf(True)), make_net(make_conf(True))
        pp = make_pp(pipe_net)
        if control:
            drop_first_microbatch(pp)
        before = [(k, t.detach().float().clone()) for k, t in leaves_of(pp.model.params)]
        pp.fit_batch(f, l)
        unpipelined_step(ref, f, l)
        err = grad_rel(pp.model, before, ref)
        del pipe_net, ref, pp, before
        torch.cuda.empty_cache()
        return err
    g_err, g_ctl = sgd_err(False), sgd_err(True)
    log(f"{label}: launches a step {got} (the unpipelined step's {got_ref}); loss {loss:.4f} "
        f"vs {ref_loss:.4f} unpipelined (rel {loss_err:.2e}, limit {LM_REF_SCORE_RTOL}); one "
        f"SGD(1) step's gradients within {g_err:.2e} of each tensor's largest entry (limit "
        f"{grad_rtol}; the control dropping microbatch 0 reads {g_ctl:.2e}); a step "
        f"{ms['pipelined']:.1f} ms pipelined vs {ms['unpipelined']:.1f} ms unpipelined "
        f"(medians of {PP_TURNS} alternating turns)")
    if loss_err > LM_REF_SCORE_RTOL or g_err > grad_rtol or g_ctl <= grad_rtol:
        raise AssertionError(f"{label}: loss rel {loss_err}, gradient rel {g_err}, "
                             f"control {g_ctl}")
    return {"launches": got, "unpipelined_launches": got_ref, "loss_rel_err": loss_err,
            "grad_rel_err": g_err, "grad_rtol": grad_rtol, "control_grad_rel_err": g_ctl,
            "step_ms": ms["pipelined"], "unpipelined_step_ms": ms["unpipelined"],
            "turns_ms": times}


def held_lstm_rows(fn, names):
    """The first launches of ``names`` in ``fn()`` held against their plain
    versions (``first_launches_held``), then timed with their bounds and
    cuDNN's LSTM at their shapes (``timed_launches``)."""
    with first_launches_held() as seen:
        fn()
    torch.cuda.synchronize()
    missing = [n for n in names if n not in seen]
    if missing:
        raise AssertionError(f"no launch of {missing} to hold (saw {sorted(seen)})")
    rows = timed_launches({n: seen[n] for n in names})
    for n, r in rows.items():
        limit = BWD_ATOL if n.endswith("bwd") else KERNEL_ATOL
        if not r["max_abs_err"] <= limit:
            raise AssertionError(f"{n} disagrees with its plain version: "
                                 f"{r['max_abs_err']} > {limit}")
    return rows


def pipelined_char_rnn():
    from deeplearning4j_torch.parallel import make_mesh, pipeline_parallel_step

    mesh = make_mesh(["cuda:0"] * PP_SLOTS, axes=("pipe",))
    f, l = periodic_text(np.random.default_rng(PP_SEED), TRAIN_B, TRAIN_SEQ)

    def make_pp(net):
        pp = pipeline_parallel_step(net, mesh, n_microbatches=PP_M)
        if (pp.start, pp.body_len, pp.layers_per_stage) != (1, PP_LAYERS - 1, 1):
            raise AssertionError(f"partition {(pp.start, pp.body_len, pp.layers_per_stage)}")
        return pp
    k = PP_LAYERS * PP_M
    out = pp_held(f"PipelinedNetwork TextGenerationLSTM({VOCAB}, {H}, {PP_LAYERS}) bf16 over "
                  f"{PP_SLOTS} pipe slots, b={TRAIN_B} T={TRAIN_SEQ}, {PP_M} microbatches",
                  pp_char_rnn_conf, build_net, make_pp, f, l,
                  {"lstm_fwd_train": k, "lstm_bwd": k}, PP_GRAD_RTOL)
    pp = make_pp(build_net(pp_char_rnn_conf()))
    out["kernels"] = held_lstm_rows(lambda: pp.fit_batch(f, l), ["lstm_fwd_train", "lstm_bwd"])
    del pp
    torch.cuda.empty_cache()
    return out


def pipelined_lm():
    from deeplearning4j_torch.nn.graph import ComputationGraph
    from deeplearning4j_torch.parallel import make_mesh, pipeline_parallel_step

    mesh = make_mesh(["cuda:0"] * PP_LM_SLOTS, axes=("pipe",))
    f, l = periodic_tokens(np.random.default_rng(PP_SEED + 1), LM_B, LM_T, LM_VOCAB)

    def make_pp(net):
        pp = pipeline_parallel_step(net, mesh, n_microbatches=PP_LM_M)
        if pp.body_tmpl is None or pp.period != 7 or pp.body_len != 7 * LM_BLOCKS:
            raise AssertionError(f"block partition: period {pp.period}, {pp.body_len} vertices")
        return pp
    k = LM_BLOCKS * PP_LM_M
    out = pp_held(f"PipelinedGraph TransformerLM (vocab {LM_VOCAB}, E={LM_E}, {LM_HEADS} heads, "
                  f"{LM_BLOCKS} blocks, bf16) over {PP_LM_SLOTS} pipe slots, b={LM_B} "
                  f"T={LM_T}, {PP_LM_M} microbatches",
                  lambda sgd: sp_lm_conf(sgd=sgd), lambda c: ComputationGraph(c).init(),
                  make_pp, f, l, {"flash_fwd": k, "flash_dq": k, "flash_dkv": k},
                  LM_REF_GRAD_RTOL)
    # attention dropout: one seed steps alike, another step seed differs
    losses, params = [], []
    for reseed in (False, False, True):
        pp = make_pp(ComputationGraph(sp_lm_conf(LM_DROPOUT_RATE)).init())
        if reseed:
            pp.model._gen.manual_seed(12345)
        losses.append(float(pp.fit_batch(f, l)))
        params.append(torch.cat([t.detach().float().flatten()
                                 for _, t in leaves_of(pp.model.params)]).cpu())
        del pp
        torch.cuda.empty_cache()
    # the losses come from the forward alone; the parameters after the
    # step also carry the backward's sums (bit-equality reported)
    same = losses[0] == losses[1]
    same_params = torch.equal(params[0], params[1])
    p_same = (params[0] - params[1]).abs().max().item()
    p_other = (params[0] - params[2]).abs().max().item()
    moved = abs(losses[2] - losses[0]) / abs(losses[0])
    log(f"pipelined TransformerLM with attention dropout {LM_DROPOUT_RATE}: one seed twice "
        f"{losses[0]!r} / {losses[1]!r} (parameters after the step bit-equal: {same_params}, "
        f"largest difference {p_same:.3e}); another step seed {losses[2]!r} (rel "
        f"{moved:.2e}, parameters apart by {p_other:.3e})")
    if not same or moved == 0.0 or not p_other > p_same:
        raise AssertionError(f"pipelined dropout: losses {losses}, parameter differences "
                             f"{p_same} (same seed) {p_other} (other seed)")
    out["dropout"] = {"losses": losses, "same_seed_equal": same,
                      "same_seed_params_bit_equal": same_params,
                      "same_seed_param_diff": p_same, "other_seed_param_diff": p_other,
                      "other_seed_rel": moved}
    out["kernels"] = flash_shape_row("pipelined microbatch", LM_HEADS * LM_B // PP_LM_M,
                                     LM_T, LM_D, True)
    return out


def ids_to_dataset(parts):
    """A streamed message of character ids [b, T+1] as the one-hot
    next-character DataSet (the iterators' ``convert``)."""
    from deeplearning4j_torch import DataSet

    ids = parts[0].astype(np.int64)
    eye = np.eye(VOCAB, dtype=np.float32)
    return DataSet(eye[ids[:, :-1]], eye[ids[:, 1:]])


def streamed_fits():
    """STREAM_BATCHES char-RNN batches fitted from a ListDataSetIterator,
    from StreamingDataSetIterator (a publisher thread on localhost) and
    from KafkaDataSetIterator (a stub broker): equal per-batch losses and
    parameters, K3/K4 launches exact (TBPTT segments of TRAIN_T)."""
    import threading
    from deeplearning4j_torch import ListDataSetIterator
    from deeplearning4j_torch.datasets.kafka import KafkaDataSetIterator, NDArrayKafkaClient
    from deeplearning4j_torch.datasets.streaming import (NDArrayConsumer, NDArrayPublisher,
                                                         StreamingBroker,
                                                         StreamingDataSetIterator)
    # the stub broker and the loss listener are shared with the CPU tests
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_kafka_stub import KafkaStubBroker, LossRecorder

    rng = np.random.default_rng(PP_SEED + 2)
    ids = []
    for _ in range(STREAM_BATCHES):
        cycle = rng.integers(0, VOCAB, 23)
        ids.append(cycle[(rng.integers(0, 23, TRAIN_B)[:, None]
                          + np.arange(TRAIN_SEQ + 1)[None, :]) % 23].astype(np.uint8))
    segs = TRAIN_SEQ // TRAIN_T
    want = {"lstm2_fwd_train": segs * STREAM_BATCHES, "lstm2_bwd": segs * STREAM_BATCHES}

    def fit(it):
        net = build_net(char_rnn_conf())
        rec = LossRecorder()
        net.set_listeners(rec)
        t0 = time.perf_counter()
        _, got = launches_of_run(lambda: net.fit(it))
        ms = (time.perf_counter() - t0) * 1e3
        return net, rec.scores, got, ms

    ref, ref_losses, ref_got, ref_ms = fit(
        ListDataSetIterator([ids_to_dataset([a]) for a in ids]))
    out = {"list": {"launches": ref_got, "fit_ms": ref_ms, "losses": ref_losses}}

    def streaming_iter():
        """(the iterator, its closer): a publisher thread feeds the broker."""
        broker = StreamingBroker()
        consumer = NDArrayConsumer(broker.address, "chars", timeout=60.0)
        t0 = time.monotonic()
        while broker.subscribers("chars") < 1:
            if time.monotonic() - t0 > 10.0:
                raise AssertionError("the subscriber never registered")
            time.sleep(0.005)

        def publish():
            pub = NDArrayPublisher(broker.address, "chars")
            for a in ids:
                pub.publish(a)
            pub.close()
        threading.Thread(target=publish, daemon=True).start()
        return (StreamingDataSetIterator(consumer, num_batches=STREAM_BATCHES,
                                         convert=ids_to_dataset),
                lambda: (consumer.close(), broker.close()))

    def kafka_iter():
        """(the iterator, its closer): the records produced first."""
        broker = KafkaStubBroker()
        prod = NDArrayKafkaClient(broker.address, "chars", timeout=60.0)
        for a in ids:
            prod.publish(a)
        prod.close()
        cons = NDArrayKafkaClient(broker.address, "chars", timeout=60.0)
        return (KafkaDataSetIterator(cons, num_batches=STREAM_BATCHES, convert=ids_to_dataset),
                lambda: (cons.close(), broker.close()))

    for label, make in (("streaming", streaming_iter), ("kafka", kafka_iter)):
        it, close = make()
        try:
            net, losses, got, ms = fit(it)
        finally:
            close()
        diff = param_diff(net, ref)
        log(f"{label} fit of {STREAM_BATCHES} char-RNN batches (b={TRAIN_B} T={TRAIN_SEQ}, "
            f"TBPTT {TRAIN_T}): launches {got} (expected {want}); per-batch losses equal the "
            f"listed fit's: {losses == ref_losses}; largest parameter difference {diff}; "
            f"{ms:.1f} ms vs {ref_ms:.1f} ms listed")
        if got != want or ref_got != want or losses != ref_losses or diff != 0.0:
            raise AssertionError(f"{label} fit: launches {got} / {ref_got}, losses {losses} "
                                 f"vs {ref_losses}, parameter difference {diff}")
        out[label] = {"launches": got, "fit_ms": ms, "losses_equal": True,
                      "param_diff": diff}
        del net
    del ref
    torch.cuda.empty_cache()
    return out


def ps_batches(seed, n):
    """``n`` char-RNN batches cut from one text cycle (``periodic_text``
    draws a new cycle a call), so that every batch teaches the same text."""
    from deeplearning4j_torch import DataSet

    f, l = periodic_text(np.random.default_rng(seed), n * TRAIN_B, TRAIN_SEQ)
    return [DataSet(f[i * TRAIN_B:(i + 1) * TRAIN_B], l[i * TRAIN_B:(i + 1) * TRAIN_B])
            for i in range(n)]


def plain_steps(net, batches):
    """The plain net's full-sequence update steps (the container's
    ``_step``); ms a step."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ds in batches:
        f, l, fm, lm = net._tensors(ds)
        net._step(f, l, fm, lm, net.iteration_count)
        net.iteration_count += 1
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / len(batches)


def paramserver_char_rnn():
    import threading
    from deeplearning4j_torch import ListDataSetIterator
    from deeplearning4j_torch.paramserver import ParameterServer, ParameterServerTrainingMaster

    conf = char_rnn_conf()
    batches = ps_batches(PP_SEED + 3, PS_STEPS)
    want = {"lstm2_fwd_train": PS_STEPS, "lstm2_bwd": PS_STEPS}
    out = {}
    for label, overlap in (("lossless_sync", False), ("lossless_overlap", True)):
        net, ref = build_net(conf), build_net(conf)
        with ParameterServer(port=0) as srv:
            m = (ParameterServerTrainingMaster.Builder(srv.address).staleness(0)
                 .threshold(0.0).overlap(overlap).build())
            _, got = launches_of_run(
                lambda: m.execute_training(net, ListDataSetIterator(batches)))
            plain_steps(ref, batches)
            diff = param_diff(net, ref)
            # the control: a plain net one step short must read above the limit
            short = build_net(conf)
            plain_steps(short, batches[:-1])
            control = param_diff(net, short)
            del short
            stats = m.client.stats()
            snap = m.client.metrics.snapshot()["counters"]
            phases = m.phases.snapshot()
            share = m.phases.hidden_share()
            # ms a step: the master's steps (wall of each) beside the plain
            # net's, PS_TURNS alternating turns of PS_STEPS steps
            turns = {"master": [], "plain": []}
            for t in range(PS_TURNS):
                for arm in (("master", "plain") if t % 2 == 0 else ("plain", "master")):
                    if arm == "master":
                        m.execute_training(net, ListDataSetIterator(batches))
                        turns[arm].append(m.phases.snapshot()["wall"]["mean_ms"])
                    else:
                        turns[arm].append(plain_steps(ref, batches))
            m.close()
        ms = {k: float(np.median(v)) for k, v in turns.items()}
        push_bytes = snap["push_bytes"] / max(snap["pushes"], 1)
        log(f"ParameterServerTrainingMaster {label} (char-RNN b={TRAIN_B} T={TRAIN_SEQ}, "
            f"threshold 0, staleness 0, {PS_STEPS} full-sequence steps): launches {got} "
            f"(expected {want}); parameters within {diff:.3e} of a plain net's {PS_STEPS} "
            f"steps (limit {PS_PARAM_ATOL}; control, {PS_STEPS - 1} plain steps: "
            f"{control:.3e}); server version {stats['version']}, pushes "
            f"{snap['pushes']}, {push_bytes:.0f} bytes a push; phases (mean ms) "
            f"{ {p: round(v.get('mean_ms', 0.0), 3) for p, v in phases['phases'].items()} }, "
            f"hidden share of d2h + encode + push {share:.3f}; a step {ms['master']:.1f} ms vs "
            f"{ms['plain']:.1f} ms plain (medians of {PS_TURNS} alternating turns)")
        if (got != want or not diff <= PS_PARAM_ATOL or not control > PS_PARAM_ATOL
                or stats["version"] != 1 + PS_STEPS):
            raise AssertionError(f"paramserver {label}: launches {got}, parameter difference "
                                 f"{diff} (control {control}), version {stats['version']}")
        out[label] = {"launches": got, "param_diff": diff, "control_param_diff": control,
                      "version": stats["version"],
                      "push_bytes": push_bytes, "phases": phases, "hidden_share": share,
                      "step_ms": ms["master"], "plain_step_ms": ms["plain"], "turns_ms": turns}
        del net, ref
    # PS_WORKERS worker threads, each its own net and client
    with ParameterServer(port=0) as srv:
        nets = [build_net(conf) for _ in range(PS_WORKERS)]
        # every worker's batches and the held-out one from one text cycle
        sets = ps_batches(PP_SEED + 9, PS_WORKERS * PS_STEPS + 1)
        held = sets[-1]
        before = nets[0].score(held)
        masters = [ParameterServerTrainingMaster.Builder(srv.address).staleness(1)
                   .threshold(PS_THRESHOLD).worker_id(f"worker-{i}").build()
                   for i in range(PS_WORKERS)]
        errors = []

        def work(i):
            try:
                masters[i].execute_training(nets[i], ListDataSetIterator(
                    sets[i * PS_STEPS:(i + 1) * PS_STEPS]))
            except BaseException as e:  # re-raised on the main thread
                errors.append(e)

        def run():
            threads = [threading.Thread(target=work, args=(i,)) for i in range(PS_WORKERS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            if errors or any(t.is_alive() for t in threads):
                raise AssertionError(f"paramserver workers failed: {errors}")
        _, got = launches_of_run(run)
        stats = masters[0].client.stats()
        pushes = [mm.client.metrics.snapshot()["counters"]["pushes"] for mm in masters]
        _, vec = masters[0].client.pull()
        from deeplearning4j_torch.paramserver import set_params_from_flat
        set_params_from_flat(nets[0], vec)
        after = nets[0].score(held)
        for mm in masters:
            mm.close()
    k = PS_WORKERS * PS_STEPS
    want2 = {"lstm2_fwd_train": k, "lstm2_bwd": k}
    log(f"ParameterServerTrainingMaster, {PS_WORKERS} worker threads (threshold {PS_THRESHOLD}, "
        f"staleness 1, {PS_STEPS} steps each): launches {got} (expected {want2}); pushes "
        f"{pushes} by the clients, {stats['counters']['pushes']} by the server's count "
        f"({stats['ops']['push']} push requests), version {stats['version']} (expected "
        f"{1 + k}); held-out loss {before:.4f} -> {after:.4f} on the server's state")
    if (got != want2 or pushes != [PS_STEPS] * PS_WORKERS or stats["counters"]["pushes"] != k
            or stats["ops"]["push"] != k or stats["version"] != 1 + k or not after < before):
        raise AssertionError(f"paramserver workers: launches {got}, pushes {pushes}, stats "
                             f"{stats['counters']}, version {stats['version']}, loss "
                             f"{before} -> {after}")
    out["two_workers"] = {"launches": got, "pushes": pushes, "version": stats["version"],
                          "server_pushes": stats["counters"]["pushes"],
                          "loss_before": before, "loss_after": after}
    del nets
    net = build_net(conf)
    with ParameterServer(port=0) as srv:
        m = ParameterServerTrainingMaster.Builder(srv.address).threshold(0.0).build()
        out["kernels"] = held_lstm_rows(
            lambda: m.execute_training(net, ListDataSetIterator(batches[:1])),
            ["lstm2_fwd_train", "lstm2_bwd"])
        m.close()
    del net
    torch.cuda.empty_cache()
    return out


def native_codec():
    """The native host library built on this machine against the numpy
    route on the char-RNN's flattened gradient, bit for bit, both timed."""
    from deeplearning4j_torch.ops import native
    from deeplearning4j_torch.parallel.accumulation import flatten_tree_f32

    native.load()  # a failed build raises with the compiler's output
    # built at its first use in this run (the accumulator's codec)
    build_s = native.build_seconds
    net = build_net(char_rnn_conf())
    f, l = periodic_text(np.random.default_rng(PP_SEED + 4), TRAIN_B, TRAIN_SEQ)
    loss, _, _ = net._train_loss(net._to_device(f), net._to_device(l), None, None)
    g = flatten_tree_f32(net._grads(loss))[0]
    del net, loss
    torch.cuda.empty_cache()
    out = {"n": int(g.size), "build_s": build_s}

    def ms(fn):
        times = []
        for _ in range(3):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times))
    for thr in (1e-3, 1e-4):
        a, b = native.threshold_encode(g, thr), native.threshold_encode_plain(g, thr)
        ok = all(np.array_equal(x, y) for x, y in zip(a, b))
        dec_ok = np.array_equal(native.threshold_decode(a[0], a[1], thr, g.shape),
                                native.threshold_decode_plain(a[0], a[1], thr, g.shape))
        bm, bp = native.bitmap_encode(g, thr), native.bitmap_encode_plain(g, thr)
        bok = (np.array_equal(bm[0], bp[0]) and bm[1] == bp[1]
               and np.array_equal(bm[2], bp[2]))
        bdec = np.array_equal(native.bitmap_decode(bm[0], g.size, thr),
                              native.bitmap_decode_plain(bm[0], g.size, thr))
        row = {"encoded": int(a[0].size), "bit_equal": bool(ok and dec_ok and bok and bdec),
               "threshold_encode_ms": ms(lambda: native.threshold_encode(g, thr)),
               "threshold_encode_plain_ms": ms(lambda: native.threshold_encode_plain(g, thr)),
               "threshold_decode_ms": ms(lambda: native.threshold_decode(a[0], a[1], thr,
                                                                         g.shape)),
               "threshold_decode_plain_ms": ms(lambda: native.threshold_decode_plain(
                   a[0], a[1], thr, g.shape)),
               "bitmap_encode_ms": ms(lambda: native.bitmap_encode(g, thr)),
               "bitmap_encode_plain_ms": ms(lambda: native.bitmap_encode_plain(g, thr)),
               "bitmap_decode_ms": ms(lambda: native.bitmap_decode(bm[0], g.size, thr)),
               "bitmap_decode_plain_ms": ms(lambda: native.bitmap_decode_plain(bm[0], g.size,
                                                                               thr))}
        log(f"native codec (built in {build_s} s at its first use) on the char-RNN's "
            f"gradient ({g.size} entries, threshold {thr}, "
            f"{row['encoded']} encoded): bit-equal to numpy {row['bit_equal']}; ms native / "
            f"numpy: threshold encode {row['threshold_encode_ms']:.2f} / "
            f"{row['threshold_encode_plain_ms']:.2f}, decode {row['threshold_decode_ms']:.2f} / "
            f"{row['threshold_decode_plain_ms']:.2f}, bitmap encode {row['bitmap_encode_ms']:.2f}"
            f" / {row['bitmap_encode_plain_ms']:.2f}, decode {row['bitmap_decode_ms']:.2f} / "
            f"{row['bitmap_decode_plain_ms']:.2f}")
        if not row["bit_equal"]:
            raise AssertionError(f"native codec differs from numpy at threshold {thr}")
        out[str(thr)] = row
    return out


def pipeline_paramserver(smi):
    """GPipe over the pipe slots (the char-RNN, the TransformerLM), the
    parameter server's master (lossless, two workers, overlap), the
    streamed and Kafka-fed fits and the native codec."""
    t0 = time.perf_counter()
    log(f"--- pipeline_paramserver ({smi})")
    res = {"card": smi, "pipelined_char_rnn": pipelined_char_rnn()}
    res["pipelined_lm"] = pipelined_lm()
    torch.cuda.empty_cache()
    res["paramserver"] = paramserver_char_rnn()
    res["streamed"] = streamed_fits()
    res["native_codec"] = native_codec()
    res["seconds"] = time.perf_counter() - t0
    log(f"pipeline_paramserver phase took {res['seconds']:.1f} s")
    return res


def fresh_monitor():
    """Empty the port's process-wide monitor planes (the phase reads what
    its own runs record)."""
    from deeplearning4j_torch import monitor

    for plane in (monitor.get_registry(), monitor.get_tracer(),
                  monitor.get_flight_recorder(), monitor.get_fleet()):
        plane.clear()
    monitor.get_health().reset()


def registry_rows(name, **match):
    """{labels: value} of a registry family's children matching ``match``
    (histograms: their count)."""
    from deeplearning4j_torch.monitor import get_registry

    fam = get_registry().dump().get(name, {"children": []})
    return {tuple(sorted(r["labels"].items())): r.get("value", r.get("count"))
            for r in fam["children"] if all(r["labels"].get(k) == v for k, v in match.items())}


def fleet_master(address, label, threshold, **kw):
    from deeplearning4j_torch.paramserver import ParameterServerTrainingMaster

    b = (ParameterServerTrainingMaster.Builder(address).staleness(kw.pop("staleness", 0))
         .threshold(threshold).worker_id(label).backoff(0.01).max_retries(1)
         .telemetry_interval(0.0))
    if "delta" in kw:
        b = b.delta_push(kw.pop("delta"))
    return b.build()


def sharded_lossless(conf, batches):
    """One lossless worker over FLEET_SHARDS shard servers against a plain
    net's steps (and its control), per-shard bytes a push, and ms a step
    against a single server's in alternating turns."""
    from deeplearning4j_torch import ListDataSetIterator
    from deeplearning4j_torch.paramserver import ParameterServer, ShardedParameterServerGroup

    net, ref = build_net(conf), build_net(conf)
    single_net = build_net(conf)
    with ShardedParameterServerGroup(FLEET_SHARDS) as group, ParameterServer(port=0) as srv:
        m = fleet_master(group.address, "lossless", 0.0)
        _, got = launches_of_run(lambda: m.execute_training(net, ListDataSetIterator(batches)))
        plain_steps(ref, batches)
        diff = param_diff(net, ref)
        short = build_net(conf)
        plain_steps(short, batches[:-1])
        control = param_diff(net, short)
        del short
        pushes = m.client.metrics.snapshot()["counters"]["pushes"]
        push_tx = {j: registry_rows("paramserver_wire_bytes_total", role="client", op="push",
                                    shard=str(j), direction="tx") for j in range(FLEET_SHARDS)}
        bytes_a_push = {j: sum(v.values()) / PS_STEPS for j, v in push_tx.items()}
        versions = [st["version"] for st in m.client.stats()]
        phases = m.phases.snapshot()
        single = fleet_master(srv.address, "single", 0.0)
        turns = {"sharded": [], "single": []}
        for t in range(PS_TURNS):
            for arm in (("sharded", "single") if t % 2 == 0 else ("single", "sharded")):
                mm, nn = (m, net) if arm == "sharded" else (single, single_net)
                mm.execute_training(nn, ListDataSetIterator(batches))
                turns[arm].append(mm.phases.snapshot()["wall"]["mean_ms"])
        m.close()
        single.close()
    ms = {k: float(np.median(v)) for k, v in turns.items()}
    want = {"lstm2_fwd_train": PS_STEPS, "lstm2_bwd": PS_STEPS}
    log(f"sharded lossless worker ({FLEET_SHARDS} shard servers, char-RNN b={TRAIN_B} "
        f"T={TRAIN_SEQ}, threshold 0, staleness 0, {PS_STEPS} steps): launches {got} "
        f"(expected {want}); parameters within {diff:.3e} of a plain net's steps (limit "
        f"{PS_PARAM_ATOL}; control {control:.3e}); shard versions {versions}; pushes "
        f"{pushes} (one a shard a step); bytes a push by shard "
        f"{ {j: round(b) for j, b in bytes_a_push.items()} }; a step {ms['sharded']:.1f} ms "
        f"vs {ms['single']:.1f} ms on one server (medians of {PS_TURNS} alternating turns); "
        f"phases (mean ms) "
        f"{ {p: round(v.get('mean_ms', 0.0), 2) for p, v in phases['phases'].items()} }")
    if (got != want or not diff <= PS_PARAM_ATOL or not control > PS_PARAM_ATOL
            or versions != [1 + PS_STEPS] * FLEET_SHARDS):
        raise AssertionError(f"sharded lossless worker: launches {got}, parameter difference "
                             f"{diff} (control {control}), shard versions {versions}")
    del net, ref, single_net
    return {"launches": got, "param_diff": diff, "control_param_diff": control,
            "shard_versions": versions, "pushes": pushes, "bytes_a_push": bytes_a_push,
            "phases": phases, "step_ms": ms["sharded"], "single_server_step_ms": ms["single"],
            "turns_ms": turns}


def sharded_workers(conf, group):
    """PS_WORKERS delta-push workers at PS_THRESHOLD, PS_STEPS steps each,
    in threads against ``group``: launches, pushes, shard versions and a
    held-out loss on the merged state."""
    import threading
    from deeplearning4j_torch import ListDataSetIterator
    from deeplearning4j_torch.paramserver import set_params_from_flat

    nets = [build_net(conf) for _ in range(PS_WORKERS)]
    sets = ps_batches(PP_SEED + 11, PS_WORKERS * PS_STEPS + 1)
    held = sets[-1]
    before = nets[0].score(held)
    masters = [fleet_master(group.address, f"worker-{i}", PS_THRESHOLD, staleness=1,
                            delta=True) for i in range(PS_WORKERS)]
    errors = []

    def work(i):
        try:
            masters[i].execute_training(nets[i], ListDataSetIterator(
                sets[i * PS_STEPS:(i + 1) * PS_STEPS]))
        except BaseException as e:  # re-raised on the main thread
            errors.append(e)

    def run():
        threads = [threading.Thread(target=work, args=(i,)) for i in range(PS_WORKERS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"sharded workers failed: {errors}")
    _, got = launches_of_run(run)
    pushes = [mm.client.metrics.snapshot()["counters"]["pushes"] for mm in masters]
    versions = [st["version"] for st in masters[0].client.stats()]
    _, vec = masters[0].client.pull()
    set_params_from_flat(nets[0], vec)
    after = nets[0].score(held)
    step_ms = [mm.phases.snapshot()["wall"]["mean_ms"] for mm in masters]
    for mm in masters:
        mm.close()
    k = PS_WORKERS * PS_STEPS
    want = {"lstm2_fwd_train": k, "lstm2_bwd": k}
    log(f"{PS_WORKERS} delta-push workers over {FLEET_SHARDS} shards (threshold "
        f"{PS_THRESHOLD}, staleness 1, {PS_STEPS} steps each): launches {got} (expected "
        f"{want}); shard pushes {pushes} by the clients, shard versions {versions}; a step "
        f"{[round(x, 1) for x in step_ms]} ms; held-out loss {before:.4f} -> {after:.4f}")
    if got != want or not after < before or any(v > 1 + k for v in versions) \
            or not all(p > 0 for p in pushes):
        raise AssertionError(f"sharded workers: launches {got}, pushes {pushes}, versions "
                             f"{versions}, loss {before} -> {after}")
    del nets
    return {"launches": got, "pushes": pushes, "shard_versions": versions,
            "step_ms": step_ms, "loss_before": before, "loss_after": after}


def shard_kill_restart(conf, group):
    """A worker loses shard FLEET_KILL after its first step (killed from a
    listener): it keeps stepping, the dead shard's mass goes back to its
    accumulator; the shard restarts from its snapshot and the next fit
    heals (``shard_server_restored``)."""
    from deeplearning4j_torch import ListDataSetIterator
    from deeplearning4j_torch.monitor import get_flight_recorder
    from deeplearning4j_torch.paramserver import flatten_params

    net = build_net(conf)
    batches = ps_batches(PP_SEED + 13, PS_STEPS)
    m = fleet_master(group.address, "survivor", PS_THRESHOLD, delta=True)
    reinjected = []
    real = m.accumulator.reinject

    def reinject(mass):
        reinjected.append(float(np.abs(mass).sum()))
        real(mass)
    m.accumulator.reinject = reinject
    killed = {}

    class Kill:
        def iteration_done(self, model, iteration, score):
            if not killed:
                killed["port"], killed["snap"] = group.kill(FLEET_KILL)
    net.set_listeners(Kill())
    t0 = time.perf_counter()
    _, got = launches_of_run(lambda: m.execute_training(net, ListDataSetIterator(batches)))
    degraded_s = time.perf_counter() - t0
    net.listeners = []
    finite = bool(np.isfinite(flatten_params(net.params)).all())
    downs = [e for e in get_flight_recorder().events() if e["event"] == "shard_server_down"]
    # the next fit's join reaches every shard past the down window
    group.restart(FLEET_KILL, snapshot=killed["snap"])
    _, healed = launches_of_run(lambda: m.execute_training(net, ListDataSetIterator(batches)))
    restored = [e for e in get_flight_recorder().events() if e["event"] == "shard_server_restored"]
    versions = [st["version"] for st in m.client.stats()]
    want = {"lstm2_fwd_train": PS_STEPS, "lstm2_bwd": PS_STEPS}
    log(f"shard {FLEET_KILL} killed after step 1 of {PS_STEPS}: the fit finished in "
        f"{degraded_s:.2f} s with launches {got}, finite parameters {finite}, "
        f"{len(downs)} shard_server_down event(s), {len(reinjected)} re-injections of "
        f"{sum(reinjected):.3e} total |mass|; restarted from its snapshot: the next fit "
        f"launched {healed}, {len(restored)} shard_server_restored, shard versions {versions}")
    if (got != want or healed != want or not finite or len(downs) != 1
            or not reinjected or not restored):
        raise AssertionError(f"shard kill/restart: launches {got} then {healed}, downs "
                             f"{len(downs)}, re-injections {reinjected}, restored "
                             f"{len(restored)}")
    return {"launches": got, "healed_launches": healed, "degraded_s": degraded_s,
            "downs": len(downs), "reinjections": len(reinjected),
            "reinjected_mass": sum(reinjected), "shard_versions": versions,
            "master": m, "net": net}


def fleet_scale(group, m, net):
    """scale_to(FLEET_SCALE), the master remapped, two steps on the new
    layout."""
    from deeplearning4j_torch import ListDataSetIterator

    addrs = group.scale_to(FLEET_SCALE)
    m.remap(addrs)
    batches = ps_batches(PP_SEED + 17, 2)
    _, got = launches_of_run(lambda: m.execute_training(net, ListDataSetIterator(batches)))
    versions = [st["version"] for st in m.client.stats()]
    log(f"scale_to({FLEET_SCALE}) and remap: {m.client.num_servers} shards, local versions "
        f"{m.local_version}, shard versions {versions}, launches {got}")
    if m.client.num_servers != FLEET_SCALE or len(m.local_version) != FLEET_SCALE \
            or got != {"lstm2_fwd_train": 2, "lstm2_bwd": 2}:
        raise AssertionError(f"scale_to: {m.client.num_servers} shards, launches {got}")
    m.close()
    return {"launches": got, "shard_versions": versions}


def fleet_records():
    """What the monitor planes hold after the fleet's runs: the registry's
    series, the tracer's span nesting (each server ``ps/apply_push`` a child
    of a client ``ps/push`` in its trace), the merged fleet trace (a pid row
    a worker) and the flight recorder's JSONL dump, read back in order."""
    from deeplearning4j_torch.monitor import get_fleet, get_flight_recorder, get_tracer

    fams = ["paramserver_wire_bytes_total", "paramserver_requests_total",
            "paramserver_push_ms", "paramserver_pushes_total", "paramserver_shard_staleness",
            "paramserver_shard_unavailable_total", "train_step_phase_ms",
            "train_step_wall_ms"]
    series = {f: len(registry_rows(f)) for f in fams}
    events = get_tracer().events()
    by_id = {e["args"]["span_id"]: e for e in events}
    applied = [e for e in events if e["name"] == "ps/apply_push"]
    linked = [e for e in applied
              if by_id.get(e["args"].get("parent_span_id"), {}).get("name") == "ps/push"
              and by_id[e["args"]["parent_span_id"]]["args"]["trace_id"]
              == e["args"]["trace_id"]]
    in_phase = [e for e in events if e["name"] == "ps/push" and by_id.get(
        e["args"].get("parent_span_id"), {}).get("name") == "train/push"]
    doc = get_fleet().merged_trace()
    rows = {e["args"]["name"]: e["pid"] for e in doc["traceEvents"] if e.get("ph") == "M"}
    out = Path("build") / "traces"
    out.mkdir(parents=True, exist_ok=True)
    (out / "fleet_merged_trace.json").write_text(json.dumps(doc))
    path = get_flight_recorder().dump(path=str(Path("build") / "flightrec-fleet.jsonl"))
    rows_fr = [json.loads(line) for line in Path(path).read_text().splitlines()]
    kinds = [r["event"] for r in rows_fr]
    seqs = [r["seq"] for r in rows_fr]
    workers = sorted(w for w in get_fleet().liveness()["workers"])
    log(f"monitor planes after the fleet: registry series {series}; {len(applied)} server "
        f"ps/apply_push spans, {len(linked)} children of a client ps/push in its trace, "
        f"{len(in_phase)} ps/push spans inside train/push; merged fleet trace pid rows "
        f"{rows}; flight recorder {len(rows_fr)} events dumped to {path}, kinds in order "
        f"{sorted(set(kinds), key=kinds.index)}")
    need = ["shard_group_start", "worker_join", "worker_leave", "shard_server_leave",
            "shard_server_down", "shard_server_join", "shard_server_restored",
            "shard_group_rebalance", "client_remap"]
    if (not all(series.values()) or not applied or len(linked) != len(applied)
            or not in_phase or sorted(k for k in rows if k.startswith("worker:"))
            != [f"worker:{w}" for w in workers] or len(set(rows.values())) != len(rows)
            or any(k not in kinds for k in need) or seqs != sorted(seqs)):
        raise AssertionError(f"monitor planes: series {series}, apply spans {len(applied)} "
                             f"(linked {len(linked)}), pid rows {rows}, events {kinds}")
    return {"series": series, "apply_push_spans": len(applied), "linked": len(linked),
            "push_spans_in_phase": len(in_phase), "pid_rows": rows,
            "flight_events": len(rows_fr), "flight_kinds": sorted(set(kinds))}


def step_ranges(events):
    """From a Chrome trace: the flash kernels launched inside the first
    ``step`` range (the step span's ``record_function``), and all of
    them."""
    marks = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e.get("name") == "step" and "dur" in e), key=lambda e: e["ts"])
    flash = [e for e in events if e.get("cat") == "kernel" and "flash" in e.get("name", "")]
    if not marks:
        return 0, len(flash)
    lo, hi = marks[0]["ts"], marks[0]["ts"] + marks[0]["dur"]
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and lo <= e["ts"] <= hi and "correlation" in e.get("args", {})}
    return sum(1 for e in flash if e.get("args", {}).get("correlation") in launched), len(flash)


def monitor_cost():
    """The monitor's cost: a TransformerLM step (K5-K7) and a char-RNN fit
    (4 TBPTT segments, K3/K4) with the monitor on (the default) and with
    ``set_enabled(False)``, in MON_TURNS alternating turns, the launches
    of each arm counted (the switch changes no kernel); the step span's
    ``record_function`` range around the LM step's K5-K7 in a profiler
    trace; and the tracer's cost a span with no profiler (the annotation
    check on and bypassed, in turns)."""
    from deeplearning4j_torch import DataSet, monitor
    from deeplearning4j_torch.monitor import tracer as tracer_mod
    from deeplearning4j_torch.nn.graph import ComputationGraph
    from torch.profiler import ProfilerActivity, profile

    out = {}
    lm = ComputationGraph(lm_conf()).init()
    lm_ds = DataSet(*periodic_tokens(np.random.default_rng(21), LM_B, LM_T, LM_VOCAB))
    rnn = build_net(char_rnn_conf())
    f, l = periodic_text(np.random.default_rng(22), TRAIN_B, TRAIN_SEQ)
    rnn_ds = DataSet(f, l)
    arms = {"transformer_lm": (lm, lm_ds, 1), "char_rnn": (rnn, rnn_ds, MON_RNN_FITS)}
    for name, (net, ds, fits) in arms.items():
        net.fit(ds)                                     # warm
        launches = {}
        for on in (True, False):
            monitor.set_enabled(on)
            _, launches["on" if on else "off"] = launches_of_run(lambda: net.fit(ds))
        times = {"on": [], "off": []}
        for t in range(MON_TURNS):
            for arm in (("on", "off") if t % 2 == 0 else ("off", "on")):
                monitor.set_enabled(arm == "on")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(fits):
                    net.fit(ds)
                net.score()                             # the value: a sync
                times[arm].append((time.perf_counter() - t0) * 1e3 / fits)
        monitor.set_enabled(True)
        med = {k: float(np.median(v)) for k, v in times.items()}
        log(f"monitor on / off, {name}: {med['on']:.2f} / {med['off']:.2f} ms a fit "
            f"({100 * (med['on'] / med['off'] - 1):+.1f}%; medians of {MON_TURNS} alternating "
            f"turns: on {' '.join(f'{x:.2f}' for x in times['on'])}, off "
            f"{' '.join(f'{x:.2f}' for x in times['off'])}); launches on {launches['on']}, "
            f"off {launches['off']}")
        if launches["on"] != launches["off"]:
            raise AssertionError(f"the monitor's switch changed the kernels of {name}: "
                                 f"{launches}")
        out[name] = {"on_ms": med["on"], "off_ms": med["off"], "turns_ms": times,
                     "launches": launches["on"]}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        lm.fit(lm_ds)
        torch.cuda.synchronize()
    path = Path("build") / "traces" / "monitored_lm_step.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    inside, total = step_ranges(json.loads(path.read_text())["traceEvents"])
    log(f"a profiled TransformerLM fit: {inside} of {total} flash kernels launched inside "
        f"the step span's record_function range")
    if total and inside != total:
        raise AssertionError(f"{total - inside} flash kernels outside the step range")
    out["profiled_step"] = {"flash_inside_step": inside, "flash_kernels": total}

    def span_us(bypass):
        # the collector off while timing: a turn that meets a generation-2
        # collection of the earlier turns' event dicts reads twice as long
        tr = monitor.Tracer(capacity=SPAN_CALLS)
        real = tracer_mod._annotation
        if bypass:
            tracer_mod._annotation = lambda name: None
        gc.collect()
        gc.disable()
        try:
            t0 = time.perf_counter()
            for _ in range(SPAN_CALLS):
                with tr.span("x"):
                    pass
            return (time.perf_counter() - t0) / SPAN_CALLS * 1e6
        finally:
            gc.enable()
            tracer_mod._annotation = real
    spans = {"checked": [], "bypassed": []}
    for t in range(SPAN_TURNS):
        for arm in (("checked", "bypassed") if t % 2 == 0 else ("bypassed", "checked")):
            spans[arm].append(span_us(arm == "bypassed"))
    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        for _ in range(SPAN_CALLS):
            with torch.profiler.record_function("x"):
                pass
        rf_us = (time.perf_counter() - t0) / SPAN_CALLS * 1e6
    finally:
        gc.enable()
    span = {k: float(np.median(v)) for k, v in spans.items()}
    log(f"a tracer span with no profiler: {span['checked']:.3f} us with the profiler check, "
        f"{span['bypassed']:.3f} us without it (medians of {SPAN_TURNS} alternating turns of "
        f"{SPAN_CALLS} spans, the collector off: "
        f"{' '.join(f'{x:.2f}' for x in spans['checked'])} and "
        f"{' '.join(f'{x:.2f}' for x in spans['bypassed'])}); an unconditional "
        f"record_function range {rf_us:.3f} us")
    out["span_us"] = {**span, "record_function_us": rf_us, "turns": spans}
    del lm, rnn
    torch.cuda.empty_cache()
    return out


def monitor_sharded_fleet(smi):
    """The sharded parameter-server fleet over the full-width char-RNN and
    the monitor core: a lossless worker over FLEET_SHARDS shards against a
    plain net (and a single server's), two delta-push workers, a shard
    killed and restarted, scale_to(FLEET_SCALE) with remap, what the
    monitor planes recorded, and the monitor's cost."""
    from deeplearning4j_torch.paramserver import ShardedParameterServerGroup

    t0 = time.perf_counter()
    log(f"--- monitor_sharded_fleet ({smi})")
    fresh_monitor()
    conf = char_rnn_conf()
    res = {"card": smi,
           "lossless": sharded_lossless(conf, ps_batches(PP_SEED + 3, PS_STEPS))}
    torch.cuda.empty_cache()
    with ShardedParameterServerGroup(FLEET_SHARDS) as group:
        res["workers"] = sharded_workers(conf, group)
        kill = shard_kill_restart(conf, group)
        res["scale"] = fleet_scale(group, kill.pop("master"), kill.pop("net"))
        res["kill_restart"] = kill
    res["records"] = fleet_records()
    torch.cuda.empty_cache()
    res["monitor_cost"] = monitor_cost()
    res["seconds"] = time.perf_counter() - t0
    log(f"monitor_sharded_fleet phase took {res['seconds']:.1f} s")
    return res


def sp_post(port, name, x, headers=None):
    """One predict over HTTP: (outputs, trace id, client milliseconds)."""
    body = json.dumps({"inputs": x.tolist()}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/models/{name}/predict",
                                 data=body, headers={"Content-Type": "application/json",
                                                     **(headers or {})})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as resp:
        doc = json.loads(resp.read())
    return (np.asarray(doc["outputs"], np.float32), doc["trace_id"],
            (time.perf_counter() - t0) * 1e3)


def sp_get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
        raw = resp.read().decode()
    return json.loads(raw) if resp.headers.get_content_type() == "application/json" else raw


def sp_requests(rng, n, fixed):
    return [one_hot(rng, int(rng.integers(1, 9)), T if fixed else int(rng.integers(T // 4, T + 1)))
            for _ in range(n)]


def sp_signature_strings(served):
    """``mln/output``'s variant keys for the batcher's closed set."""
    out = set()
    for shape, dt, masked in served.batcher.compile_signatures((T, VOCAB)):
        key = f"[0][0]={dt}[{','.join(str(d) for d in shape)}]"
        out.add(key + (f";[0][1]=float32[{shape[0]},{shape[1]}]" if masked else ""))
    return out


def sp_k1_f32_body():
    """K1 in f32 at the serving shape (b=32, T=200, masked): the
    CUDA-core body the f32 registration runs, against its plain version."""
    from deeplearning4j_torch.ops import lstm_cell

    g = torch.Generator().manual_seed(1)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).cuda()
    lengths = torch.randint(T // 4, T + 1, (B,), generator=g)
    mask = (torch.arange(T)[:, None] < lengths[None, :]).float().cuda()
    args = (rnd(T, B, 4 * H), rnd(H, 4 * H, scale=H ** -0.5), rnd(3, H, scale=0.1), mask,
            rnd(B, H, scale=0.5), rnd(B, H, scale=0.5))
    got = lstm_cell.lstm_fwd(*args)
    ref = lstm_cell.lstm_fwd_plain(*args)
    err = max((a - r).abs().max().item() for a, r in zip(got, ref))
    ms = cuda_ms(lambda: lstm_cell.lstm_fwd(*args), 10)
    plain_ms = cuda_ms(lambda: lstm_cell.lstm_fwd_plain(*args), 2)
    bms, by = lstm_launch_bound("lstm_fwd", args, reserve=False)
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
               design=lstm_design("K1", torch.float32, B, H),
               shape={"b": B, "T": T, "H": H, "w": "f32", "peepholes": True, "mask": True})
    log(f"K1 f32 (serving_plane's body) b={B} T={T}: max_abs_err={err:.3e} kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.3f} bound_ms={bms:.5f} ({by}); route: {row['design']}")
    if not err <= KERNEL_ATOL:
        raise AssertionError(f"K1 f32 disagrees with its plain version: {err}")
    return row


def sp_watch_cost(dev):
    """jitwatch's per-call cost on the card's host: a watched no-op against
    the bare one, with the served forward's arguments (a [32, 200, 80]
    batch and its mask) and a TBPTT step's (b=64, T=50 segments, an
    iteration number and a two-layer (h, c) carry), median of alternating
    turns, microseconds a call."""
    from deeplearning4j_torch.monitor import monitored_jit

    def z(*shape):
        return torch.zeros(shape, device=dev)
    cases = {"mln/output": (z(32, T, VOCAB), z(32, T)),
             "mln/step": (z(64, 50, VOCAB), z(64, 50, VOCAB), None, None, 7,
                          {0: (z(64, H), z(64, H)), 1: (z(64, H), z(64, H))})}
    out = {}
    for name, args in cases.items():
        def bare(*a):
            return None
        watched = monitored_jit(bare, name=f"serving_plane/cost {name}")
        watched(*args)
        turns = []
        for _ in range(SP_COST_TURNS):
            t0 = time.perf_counter()
            for _ in range(SP_COST_CALLS):
                bare(*args)
            t1 = time.perf_counter()
            for _ in range(SP_COST_CALLS):
                watched(*args)
            t2 = time.perf_counter()
            turns.append(((t2 - t1) - (t1 - t0)) / SP_COST_CALLS * 1e6)
        out[name] = {"us_a_call": float(np.median(turns)), "turns": turns}
        log(f"jitwatch's check a call with {name}'s arguments: {out[name]['us_a_call']:.2f} us "
            f"(median of {SP_COST_TURNS} turns of {SP_COST_CALLS} calls: "
            f"{', '.join(f'{t:.2f}' for t in turns)})")
    return out


def sp_latency(port, name, mode, seed):
    """Client milliseconds at SP_CONCURRENCY clients, p50/p99, from a
    client process: SP_LAT_REQUESTS requests of 1-8 rows (T 50-200, or
    T=200 when ``mode`` is "fixed"), or one 4-row request repeated
    ("hit", its first send filling the cache)."""
    out = subprocess.run([sys.executable, "-c", SP_CLIENT, str(port), name, mode,
                          str(SP_LAT_REQUESTS), str(SP_CONCURRENCY), str(seed), str(T),
                          str(VOCAB)], capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"serving_plane client failed:\n{out.stderr[-2000:]}")
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    ms = doc["ms"]
    return {"p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99)),
            "requests": len(ms), "concurrency": SP_CONCURRENCY,
            "request_bytes": doc["request_bytes"]}


def sp_cold_replicas(artifact, smi, build_s, warm_sha):
    """Two child processes at once: one from the artifact with an empty
    compile-cache directory, one from a corrupted copy with the build
    directory; each answers the same request."""
    out_dir = Path(artifact).parent
    bad = out_dir / "corrupted.dl4jaot"
    import zipfile
    with zipfile.ZipFile(artifact) as zin, zipfile.ZipFile(bad, "w") as zout:
        for name in zin.namelist():
            data = zin.read(name)
            if name.startswith("lib/"):
                data = data[:-1] + bytes([data[-1] ^ 1])
            zout.writestr(name, data)
    cold_dir = out_dir / "cold_cache"
    shutil.rmtree(cold_dir, ignore_errors=True)
    cold_dir.mkdir(parents=True)
    base = {k: v for k, v in os.environ.items() if k != "DL4J_TPU_COMPILE_CACHE_DIR"}
    runs = {"cold": (artifact, {**base, "DL4J_TPU_COMPILE_CACHE_DIR": str(cold_dir)}),
            "corrupted": (str(bad), base)}
    procs = {k: subprocess.Popen([sys.executable, "-c", SP_CHILD, a, str(SP_SEED + 7)],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                 env=env) for k, (a, env) in runs.items()}
    res = {}
    for k, p in procs.items():
        try:
            so, se = p.communicate(timeout=300)
        finally:
            if p.poll() is None:
                p.kill()
        if p.returncode != 0:
            raise AssertionError(f"serving_plane {k} replica failed:\n{se[-3000:]}")
        res[k] = json.loads(so.strip().splitlines()[-1])
    cold, corr = res["cold"], res["corrupted"]
    cold["bit_equal_to_warm"] = cold.pop("answer_sha256") == warm_sha
    corr["bit_equal_to_warm"] = corr.pop("answer_sha256") == warm_sha
    cold["installed"] = sorted(p.name for p in cold_dir.glob("lib*.so"))
    log(f"cold replica from the artifact ({smi}): first answer {cold['process_to_answer_s']:.2f} s "
        f"after process start ({cold['register_to_answer_s']:.2f} s after the net was built, "
        f"registration {cold['register_s']:.2f} s), nvcc runs {cold['nvcc_runs']}, library "
        f"loads from the cache {cold['library_hits']}, installed {cold['installed']}, "
        f"aot_signatures {cold['aot_signatures']}, input_shape {cold['input_shape']}, "
        f"bit-equal to the warm replica: {cold['bit_equal_to_warm']}; the kernels' build "
        f"took {build_s:.1f} s at the start of this run")
    log(f"corrupted artifact: events {[e['event'] for e in corr['events']]} "
        f"({corr['events'][0].get('reason') if corr['events'] else None}); nvcc runs "
        f"{corr['nvcc_runs']}; answered, bit-equal to the warm replica: "
        f"{corr['bit_equal_to_warm']}; first answer {corr['process_to_answer_s']:.2f} s")
    if cold["nvcc_runs"] or not cold["bit_equal_to_warm"] or not cold["installed"] \
            or cold["input_shape"] != [T, VOCAB] \
            or not any(e["event"] == "compile_cache_artifact_loaded" for e in cold["events"]):
        raise AssertionError(f"cold replica: {cold}")
    if corr["nvcc_runs"] or not any(e["event"] == "compile_cache_miss"
                                    for e in corr["events"]):
        raise AssertionError(f"corrupted-artifact replica: {corr}")
    return {"cold": cold, "corrupted": corr, "build_s": build_s}


def serving_plane(smi, build_s):
    """The serving tier's rest and the compile plane on the card: the
    char-RNN served over HTTP at f32 and bf16 (K1's two bodies and K3),
    answers held, bytes a flush, cache hits, a traced request, the
    monitor routes, a closed signature set under churn, p50/p99, and a
    cold replica from a warmup artifact."""
    from deeplearning4j_torch import InferenceServer, MultiLayerNetwork
    from deeplearning4j_torch.datasets.bucketing import bucket_for
    from deeplearning4j_torch.monitor import get_flight_recorder, get_jit_registry
    from deeplearning4j_torch.serving import DEFAULT_BATCH_BUCKETS, TRACE_HEADER
    from deeplearning4j_torch.serving.registry import _flip_compute_dtype

    t_start = time.perf_counter()
    log(f"--- serving_plane ({smi})")
    fresh_monitor()
    get_jit_registry().clear()
    regs = {"sp_f32": dict(precision="f32", time_buckets=TIME_BUCKETS),
            "sp_bf16": dict(precision="bf16", time_buckets=TIME_BUCKETS),
            "sp_bf16_fixed": dict(precision="bf16", cache_size=SP_CACHE)}
    nets = {k: build_net(char_rnn_conf()) for k in regs}
    cpu = MultiLayerNetwork(char_rnn_conf()).init(
        params={k: {n: t.cpu() for n, t in p.items()} for k, p in nets["sp_f32"].params.items()},
        device="cpu")
    _flip_compute_dtype(cpu, "float32")
    srv = InferenceServer()
    res = {"card": smi, "registrations": {}}
    t0 = time.perf_counter()
    for name, kw in regs.items():
        srv.register(name, nets[name], linger_ms=5.0, input_shape=(T, VOCAB), warmup=True, **kw)
    res["warm_s"] = time.perf_counter() - t0
    port = srv.start(port=0)
    rng = np.random.default_rng(SP_SEED)
    try:
        for name in regs:
            served = srv.registry.get(name)
            fixed = served.batcher._tb is None
            wrapper = nets[name]._jit_output[(False, not fixed)]
            compiles0 = wrapper.compiles
            storms0 = len([e for e in get_flight_recorder().events()
                           if e["event"] == "retrace_storm"])
            xs = sp_requests(rng, SP_REQUESTS, fixed)
            reset_counts()
            with ThreadPoolExecutor(max_workers=SP_CONCURRENCY) as pool:
                answers = [r[0] for r in pool.map(lambda x: sp_post(port, name, x), xs)]
            torch.cuda.synchronize()
            launches = read_counts()
            stats = served.batcher.transfer_stats()
            storms = len([e for e in get_flight_recorder().events()
                          if e["event"] == "retrace_storm"]) - storms0
            seen, closed = set(wrapper.signatures), sp_signature_strings(served)
            w_dtype = torch.bfloat16 if served.precision == "bf16" else torch.float32
            designs = sorted({(k3_design(w_dtype, bucket_for(DEFAULT_BATCH_BUCKETS, len(x)), H)
                               if fixed else lstm_design("K1", w_dtype,
                                                         bucket_for(DEFAULT_BATCH_BUCKETS,
                                                                    len(x)), H))
                              for x in xs})
            if served.precision == "f32":
                worst = max(float(np.abs(y - cpu.output(x).numpy()).max())
                            for x, y in zip(xs, answers))
                if not worst <= SERVE_ATOL:
                    raise AssertionError(f"{name}: f32 answers {worst} from the f32 plain "
                                         f"forward (limit {SERVE_ATOL})")
                # one request at a time, so that each flush is its own
                # bucket: the served rows are that bucket's forward
                for x in xs[:4]:
                    y = sp_post(port, name, x)[0]
                    b, t = x.shape[:2]
                    pb, pt = bucket_for(DEFAULT_BATCH_BUCKETS, b), bucket_for(TIME_BUCKETS, t)
                    dev = nets[name].device
                    xp = torch.zeros((pb, pt, VOCAB), device=dev)
                    xp[:b, :t] = torch.from_numpy(x).to(dev)
                    mp = torch.zeros((pb, pt), device=dev)
                    mp[:b, :t] = 1.0
                    ref = nets[name].output(xp, mask=mp)[:b, :t].float().cpu().numpy()
                    if not np.array_equal(y, ref):
                        raise AssertionError(f"{name}: a served row differs from its bucket's "
                                             f"forward by {np.abs(y - ref).max()}")
                check = {"bit_equal_to_bucket_forward": 4, "vs_cpu_plain_f32": worst,
                         "atol": SERVE_ATOL}
            else:
                worst = max(float(np.abs(y - cpu.output(x).numpy()).max())
                            for x, y in zip(xs, answers))
                if not worst <= SP_BF16_ATOL:
                    raise AssertionError(f"{name}: bf16 answers {worst} from the f32 plain "
                                         f"forward (limit {SP_BF16_ATOL})")
                check = {"vs_cpu_plain_f32": worst, "atol": SP_BF16_ATOL}
            want = "lstm2_fwd" if fixed else "lstm_fwd"
            others = {k: v for k, v in launches.items() if k != want and v}
            row = {"launches": {k: v for k, v in launches.items() if v}, "designs": designs,
                   "check": check, "flushes": stats["flushes"],
                   "h2d_bytes_per_flush": stats["h2d_bytes"] / max(stats["flushes"], 1),
                   "d2h_bytes_per_flush": stats["d2h_bytes"] / max(stats["flushes"], 1),
                   "compiles_in_churn": wrapper.compiles - compiles0,
                   "signatures_seen": len(seen), "closed_set": len(closed),
                   "storms_in_churn": storms}
            res["registrations"][name] = row
            log(f"{name} ({served.precision}{', fixed T' if fixed else ', time buckets'}): "
                f"{SP_REQUESTS} HTTP requests, launches {row['launches']}, bodies {designs}; "
                f"{check}; {stats['flushes']} flushes, h2d {row['h2d_bytes_per_flush']:.0f} B "
                f"and d2h {row['d2h_bytes_per_flush']:.0f} B a flush; mln/output first calls "
                f"in the churn {row['compiles_in_churn']}, signatures seen {len(seen)} of the "
                f"closed set's {len(closed)}, retrace storms {storms}")
            if not launches[want] or others:
                raise AssertionError(f"{name}: launches {launches} (want {want} only)")
            if row["compiles_in_churn"] or storms or not seen <= closed:
                raise AssertionError(f"{name}: signatures {sorted(seen - closed)} outside the "
                                     f"closed set, {storms} storms")

        # a cache hit answers bit-equal and launches nothing
        x = sp_requests(rng, 1, True)[0]
        first = sp_post(port, "sp_bf16_fixed", x)[0]
        reset_counts()
        again = sp_post(port, "sp_bf16_fixed", x)[0]
        torch.cuda.synchronize()
        hit_launches = {k: v for k, v in read_counts().items() if v}
        res["cache_hit"] = {"launches": hit_launches, "bit_equal": first.tobytes() ==
                            again.tobytes(), "stats": srv.registry.get("sp_bf16_fixed")
                            .batcher.cache_stats()}
        log(f"cache hit on sp_bf16_fixed: launches {hit_launches}, bit-equal "
            f"{res['cache_hit']['bit_equal']}, cache {res['cache_hit']['stats']}")
        if hit_launches or not res["cache_hit"]["bit_equal"]:
            raise AssertionError(f"a cache hit launched {hit_launches} or differs")

        # a traced request found on /trace, linked to its flush
        tid = f"{int(rng.integers(1, 2 ** 62)):x}"
        got_tid = sp_post(port, "sp_f32", sp_requests(rng, 1, False)[0],
                          {TRACE_HEADER: f"{tid}:1f"})[1]
        evs = sp_get(port, "/trace")["traceEvents"]
        waits = [e for e in evs if e["name"] == "serving/queue_wait"
                 and e["args"]["trace_id"] == tid]
        flushes = {e["args"]["span_id"]: e for e in evs if e["name"] == "serving/flush"}
        linked = [flushes[w["args"]["flush_span_id"]] for w in waits
                  if w["args"]["flush_span_id"] in flushes]
        res["trace"] = {"trace_id": tid, "response_trace_id": got_tid,
                        "queue_wait_spans": len(waits),
                        "flush": linked[0]["args"] if linked else None,
                        "flush_ms": linked[0]["dur"] / 1e3 if linked else None}
        log(f"X-DL4J-Trace {tid}: response trace_id {got_tid}, {len(waits)} queue_wait span(s) "
            f"linked to serving/flush {res['trace']['flush']}")
        if got_tid != tid or not linked:
            raise AssertionError(f"trace {tid} not found under serving/flush on /trace")

        # the monitor routes: the serving series and /profile's p50/p99
        metrics = sp_get(port, "/metrics")
        series = sorted({ln.split("{")[0] for ln in metrics.splitlines()
                         if ln.startswith("serving_")})
        report = sp_get(port, "/profile")
        prof = report["serving"]
        res["profile"] = {m: {k: prof[m]["latency_ms"].get(k) for k in ("p50_ms", "p99_ms")}
                          for m in regs}
        res["jit_output"] = {k: report["jit"]["mln/output"].get(k) for k in (
            "calls", "compiles", "compile_seconds", "storms")}
        log(f"/profile jit row of mln/output ({smi}): {res['jit_output']}")
        log(f"/metrics serving series: {series}")
        log(f"/profile serving p50/p99 ({smi}): {res['profile']}")
        for fam in ("serving_requests_total", "serving_request_latency_ms_bucket",
                    "serving_batch_examples_bucket", "serving_pad_ms_bucket",
                    "serving_transfer_ms_bucket", "serving_cache_hits_total",
                    "serving_cache_misses_total", "serving_qps", "serving_queue_depth"):
            if fam not in series:
                raise AssertionError(f"/metrics lacks {fam}")
        res["metrics_series"] = series
        res["profile_text_ok"] = "# serving (per hosted model)" in sp_get(
            port, "/profile?format=text")

        # HTTP p50/p99 at a fixed concurrency, the same request streams for
        # f32 and bf16
        res["latency"] = {
            "f32": sp_latency(port, "sp_f32", "churn", SP_SEED + 1),
            "bf16": sp_latency(port, "sp_bf16", "churn", SP_SEED + 1),
            "bf16_fixed": sp_latency(port, "sp_bf16_fixed", "fixed", SP_SEED + 2),
            "cache_hit": sp_latency(port, "sp_bf16_fixed", "hit", SP_SEED + 3)}
        for k, v in res["latency"].items():
            log(f"HTTP {k} ({smi}): p50 {v['p50_ms']:.2f} ms, p99 {v['p99_ms']:.2f} ms over "
                f"{v['requests']} requests at {v['concurrency']} clients (a client process; "
                f"{v['request_bytes'] / 1e3:.0f} kB of JSON a request)")

        # a warmup artifact and two cold replicas
        out_dir = Path("build") / "serving_plane"
        shutil.rmtree(out_dir, ignore_errors=True)
        fixed = srv.registry.get("sp_bf16_fixed")
        t0 = time.perf_counter()
        artifact = fixed.export_warmup(str(out_dir) + os.sep)
        res["export_s"] = time.perf_counter() - t0
        from deeplearning4j_torch.compilecache import read_manifest
        man = read_manifest(artifact)
        res["artifact"] = {"path": artifact, "bytes": os.path.getsize(artifact), "libraries": [
            lib["name"] for lib in man["libraries"]], "signatures": len(man["signatures"]),
            "fingerprint": man["fingerprint"]}
        log(f"warmup artifact {artifact}: {res['artifact']}, exported in {res['export_s']:.2f} s")
        import hashlib
        warm = fixed.predict(one_hot(np.random.default_rng(SP_SEED + 7), 2, T))
        res["replicas"] = sp_cold_replicas(artifact, smi, build_s,
                                           hashlib.sha256(warm.tobytes()).hexdigest())
    finally:
        srv.stop()
    res["k1_f32_body"] = sp_k1_f32_body()
    res["watch_cost"] = sp_watch_cost(nets["sp_f32"].device)
    res["seconds"] = time.perf_counter() - t_start
    log(f"serving_plane phase took {res['seconds']:.1f} s")
    return res


def ap_start_replica(artifact):
    """The scraped child replica (AP_REPLICA), started at once: its port is
    read later, bounded by AP_CHILD_TIMEOUT_S."""
    cache = Path("build") / "alerts_probes" / "replica_cache"
    shutil.rmtree(cache, ignore_errors=True)
    cache.mkdir(parents=True)
    env = {**os.environ, "DL4J_TPU_COMPILE_CACHE_DIR": str(cache)}
    return subprocess.Popen([sys.executable, "-c", AP_REPLICA, artifact], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def ap_replica_port(child):
    box = {}
    reader = threading.Thread(target=lambda: box.update(line=child.stdout.readline()),
                              daemon=True)
    reader.start()
    reader.join(AP_CHILD_TIMEOUT_S)
    line = (box.get("line") or "").strip()
    if not line:
        child.kill()
        raise AssertionError(f"alerts_probes: the child replica printed no port within "
                             f"{AP_CHILD_TIMEOUT_S} s:\n{child.stderr.read()[-3000:]}")
    return json.loads(line)["port"]


def ap_walk(step, beat, until, limit, label):
    """Beats until ``until(states)`` holds, at most ``limit``; the states
    after each beat."""
    walk = []
    for _ in range(limit):
        walk.append(beat(step))
        step += 1
        if until(walk[-1]):
            return step, walk
    raise AssertionError(f"alerts_probes: {label} not reached in {limit} beats: {walk[-3:]}")


def alerts_probes(smi, artifact):
    """The alert engine, the probe plane and the scrape collector over the
    char-RNN served on the card: healthy probes (K1/K3 launches a probe
    flush, no cache hit), a gray failure caught by ``probe_mismatch``, a
    latency burn with a resolvable exemplar, a collector over this server
    and a child replica that is then killed, the training rules on a NaN
    fit, and the monitor routes."""
    from deeplearning4j_torch import DataSet, InferenceServer
    from deeplearning4j_torch.monitor import (AlertEngine, MetricsHistory, TelemetryCollector,
                                              TrainingHealthListener,
                                              default_fleet_rules, default_fleet_scope_rules,
                                              default_probe_rules, default_serving_rules,
                                              default_training_rules, get_alert_engine,
                                              get_fleet, get_flight_recorder, get_history,
                                              get_prober)

    t_start = time.perf_counter()
    log(f"--- alerts_probes ({smi})")
    fresh_monitor()
    child = ap_start_replica(artifact)
    regs = {"ap_f32": dict(precision="f32", time_buckets=TIME_BUCKETS),
            "ap_bf16": dict(precision="bf16", time_buckets=TIME_BUCKETS),
            "ap_bf16_fixed": dict(precision="bf16", cache_size=SP_CACHE)}
    nets = {k: build_net(char_rnn_conf()) for k in regs}
    srv = InferenceServer()
    served = {k: srv.register(k, nets[k], linger_ms=5.0, input_shape=(T, VOCAB), **kw)
              for k, kw in regs.items()}
    port = srv.start(port=0)
    rec, fleet = get_flight_recorder(), get_fleet()
    prober, engine, hist = get_prober(), get_alert_engine(), get_history()
    engine.clear()
    hist.clear()
    stale0, fleet.stale_after = fleet.stale_after, AP_STALE_S
    collector = None
    res = {"card": smi}
    try:
        # (a) healthy probes: golden sets captured on the card, then
        # AP_TICKS ticks of three targets with the probe pack attached
        goldens = {k: m.golden(examples=1) for k, m in served.items()}
        res["goldens"] = {k: {"version": g["version"], "atol": g["atol"],
                              "precision": g["precision"]} for k, g in goldens.items()}
        prober.engine.clear()
        for k, g in goldens.items():
            prober.add_target(k, f"127.0.0.1:{port}", g)
        edges = []
        prober.engine.subscribe(lambda ev, pl: edges.append((ev, dict(pl))))
        prober.engine.add(*default_probe_rules(prober, windows=AP_WINDOWS,
                                               deadman_s=AP_DEADMAN_S, for_seconds=AP_FOR_S))
        t0 = time.time()
        ticks = []

        def probe_beat(step):
            r = prober.tick(now=t0 + AP_BEAT_S * step)
            ticks.append(r)
            return {"outcomes": r["outcomes"],
                    **{x.name: x.state for x in prober.engine.rules()}}
        flushes0 = {k: m.batcher.transfer_stats()["flushes"] for k, m in served.items()}
        def cache_now():
            return {**served["ap_bf16_fixed"].batcher.cache_stats(),
                    "hits": sum(registry_rows("serving_cache_hits_total",
                                              model="ap_bf16_fixed").values())}
        cache0 = cache_now()
        reset_counts()
        healthy = [probe_beat(i) for i in range(AP_TICKS)]
        torch.cuda.synchronize()
        launches = {k: v for k, v in read_counts().items() if v}
        flushes = {k: m.batcher.transfer_stats()["flushes"] - flushes0[k]
                   for k, m in served.items()}
        cache1 = cache_now()
        want = {"lstm_fwd": 2 * (flushes["ap_f32"] + flushes["ap_bf16"]),
                "lstm2_fwd": flushes["ap_bf16_fixed"]}
        res["healthy"] = {"outcomes": [h["outcomes"] for h in healthy], "launches": launches,
                          "flushes": flushes, "cache_before": cache0, "cache_after": cache1,
                          "states": healthy[-1]}
        log(f"alerts_probes healthy ({smi}): {AP_TICKS} ticks of {len(goldens)} targets, "
            f"outcomes all ok: {all(set(h['outcomes'].values()) == {'ok'} for h in healthy)}; "
            f"launches {launches} for flushes {flushes} (want {want}); cache {cache0} -> "
            f"{cache1}; rules {healthy[-1]}")
        if not all(set(h["outcomes"].values()) == {"ok"} for h in healthy):
            raise AssertionError(f"alerts_probes: a healthy probe failed: {res['healthy']}")
        if launches != want or any(v != AP_TICKS for v in flushes.values()):
            raise AssertionError(f"alerts_probes: probe launches {launches}, flushes {flushes}, "
                                 f"want {want} and {AP_TICKS} flushes each")
        if (cache1["hits"], cache1["entries"]) != (cache0["hits"], cache0["entries"]):
            raise AssertionError(f"alerts_probes: probes touched the response cache: "
                                 f"{cache0} -> {cache1}")

        # (b) the gray failure: the f32 net answers wrong, fast, no version
        # bump; probe_mismatch fires once, names the target, and carries a
        # trace id the server's /trace resolves; undone, every rule resolves
        w = nets["ap_f32"].params["2"]["W"]
        step = AP_TICKS
        with torch.no_grad():
            w.mul_(8.0)
        try:
            step, wrong = ap_walk(step, probe_beat, lambda st: st["probe_mismatch"] == "FIRING",
                                  6, "probe_mismatch FIRING")
        finally:
            with torch.no_grad():
                w.div_(8.0)
        step, back = ap_walk(step, probe_beat,
                             lambda st: all(v == "OK" for k, v in st.items()
                                            if k != "outcomes"), 16, "probe rules OK")
        fired = [pl for ev, pl in edges if ev == "alert_firing" and pl["rule"] == "probe_mismatch"]
        resolved = [pl for ev, pl in edges
                    if ev == "alert_resolved" and pl["rule"] == "probe_mismatch"]
        traced = {(e.get("args") or {}).get("trace_id")
                  for e in sp_get(port, "/trace")["traceEvents"]}
        mismatch_rule = {r.name: r for r in prober.engine.rules()}["probe_mismatch"]
        res["gray"] = {"outcomes": [x["outcomes"] for x in wrong + back],
                       "walk": [x["probe_mismatch"] for x in healthy + wrong + back],
                       "edges": [(ev, pl["rule"]) for ev, pl in edges],
                       "detail": fired[0]["detail"] if fired else None,
                       "exemplar": fired[0]["exemplar_trace_id"] if fired else None,
                       "exemplar_on_trace": bool(fired) and fired[0]["exemplar_trace_id"] in traced,
                       "fired_count": mismatch_rule.fired_count}
        log(f"alerts_probes gray failure ({smi}): outcomes {res['gray']['outcomes']}; "
            f"probe_mismatch walk {res['gray']['walk']}; edges {res['gray']['edges']}; detail "
            f"{res['gray']['detail']!r}; exemplar {res['gray']['exemplar']} on /trace: "
            f"{res['gray']['exemplar_on_trace']}")
        if len(fired) != 1 or len(resolved) != 1 or mismatch_rule.fired_count != 1 \
                or "ap_f32" not in (fired[0]["detail"] or "") \
                or not res["gray"]["exemplar_on_trace"] \
                or any(o != "ok" for k, o in wrong[0]["outcomes"].items() if k != "ap_f32") \
                or wrong[0]["outcomes"]["ap_f32"] != "mismatch":
            raise AssertionError(f"alerts_probes: the gray failure: {res['gray']}")
        evals = []
        for _ in range(20):
            e0 = time.perf_counter()
            prober.engine.evaluate(now=t0 + AP_BEAT_S * step, strict=False)
            evals.append((time.perf_counter() - e0) * 1e6)
        res["evaluate_us"] = {"median": float(np.median(evals)), "rules": 4, "calls": len(evals)}
        res["tick_ms"] = [r["duration_ms"] for r in ticks]
        log(f"alerts_probes ({smi}): the prober's tick over 3 targets {np.median(res['tick_ms']):.1f} "
            f"ms (median of {len(ticks)}; {min(res['tick_ms']):.1f}-{max(res['tick_ms']):.1f}); "
            f"the probe pack's evaluate {res['evaluate_us']['median']:.1f} us (median of 20)")

        # (c) the latency burn: an injected sleep around the bf16 net;
        # serving_p99_breach fires with an exemplar on /trace and resolves
        rules = default_serving_rules("ap_bf16", windows=AP_WINDOWS, p99_target_ms=AP_P99_MS,
                                      for_seconds=AP_FOR_S)
        engine.add(*rules)
        p99 = rules[1].name
        sedges = []
        engine.subscribe(lambda ev, pl: sedges.append((ev, dict(pl))))
        rng = np.random.default_rng(SP_SEED + 11)
        x = one_hot(rng, 1, T // 2)
        net, real = nets["ap_bf16"], nets["ap_bf16"].output
        t1 = time.time()

        def serve_beat(step):
            # on the wall clock: /alerts evaluates the process engine at
            # request time, so its samples must not lie ahead of it
            time.sleep(max(0.0, t1 + AP_SERVE_BEAT_S * step - time.time()))
            sp_post(port, "ap_bf16", x)
            now = time.time()
            hist.sample(now=now)
            engine.evaluate(now=now, strict=False)
            return {r.name: r.state for r in engine.rules()}
        base = [serve_beat(i) for i in range(int(AP_WINDOWS[-1] / AP_SERVE_BEAT_S) + 1)]
        step = len(base)
        if any(v != "OK" for v in base[-1].values()):
            raise AssertionError(f"alerts_probes: the serving rules before the fault: {base}")

        def slow(*a, **k):
            time.sleep(AP_SLOW_S)
            return real(*a, **k)
        net.output = slow
        try:
            step, slowed = ap_walk(step, serve_beat, lambda st: st[p99] == "FIRING", 12,
                                   f"{p99} FIRING")
        finally:
            del net.output
        step, fast = ap_walk(step, serve_beat, lambda st: st[p99] == "OK", 24, f"{p99} OK")
        fired = [pl for ev, pl in sedges if ev == "alert_firing" and pl["rule"] == p99]
        traced = {(e.get("args") or {}).get("trace_id")
                  for e in sp_get(port, "/trace")["traceEvents"]}
        res["latency"] = {"walk": [st[p99] for st in base + slowed + fast],
                          "edges": [(ev, pl["rule"]) for ev, pl in sedges],
                          "detail": fired[0]["detail"] if fired else None,
                          "exemplar": fired[0]["exemplar_trace_id"] if fired else None,
                          "exemplar_on_trace": bool(fired)
                          and fired[0]["exemplar_trace_id"] in traced}
        log(f"alerts_probes latency burn ({smi}): {p99} walk {res['latency']['walk']}; edges "
            f"{res['latency']['edges']}; detail {res['latency']['detail']!r}; exemplar "
            f"{res['latency']['exemplar']} on /trace: {res['latency']['exemplar_on_trace']}")
        if len(fired) != 1 or not res["latency"]["exemplar_on_trace"] \
                or ("alert_resolved", p99) not in res["latency"]["edges"]:
            raise AssertionError(f"alerts_probes: the latency burn: {res['latency']}")

        # (d) the collector over this server (replica-a) and the child
        # replica (replica-b); the child killed: its target goes down
        bport = ap_replica_port(child)
        collector = TelemetryCollector(timeout_s=10.0)
        collector.engine.add(*default_fleet_scope_rules(fleet=collector.fleet,
                                                        windows=AP_WINDOWS,
                                                        for_seconds=AP_FOR_S),
                             *default_fleet_rules(for_seconds=AP_FOR_S))
        collector.add_target("replica-a", f"127.0.0.1:{port}")
        collector.add_target("replica-b", f"127.0.0.1:{bport}")
        t2 = time.time()

        def scrape_beat(step):
            r = collector.tick(now=t2 + AP_BEAT_S * step)
            return {"scraped": r["scraped"], "errors": sorted(r["errors"]),
                    **{x.name: x.state for x in collector.engine.rules()}}
        step, up = 0, []
        for _ in range(4):
            up.append(scrape_beat(step))
            step += 1
        sp_post(bport, "ap_replica", one_hot(rng, 1, T))
        up.append(scrape_beat(step))
        step += 1
        replayed = [e for e in rec.events() if e["event"] == "preexisting_incident"]
        fleet_text = sp_get(port, "/fleet")
        child.kill()
        child.wait(timeout=30)
        time.sleep(AP_STALE_S + 0.2)
        step, down = ap_walk(step, scrape_beat,
                             lambda st: st["fleet_target_down"] == st["fleet_worker_stale"]
                             == "FIRING", 6, "fleet_target_down and fleet_worker_stale FIRING")
        res["collector"] = {
            "up": up, "down": down, "replayed_preexisting": len(replayed),
            "fleet_lists": {w: f'worker="{w}"' in fleet_text for w in ("replica-a", "replica-b")},
            "down_targets": [t.label for t in collector.down_targets()],
            "target_down_events": [e["target"] for e in rec.events()
                                   if e["event"] == "fleet_target_down" and "origin_seq" not in e],
            "snapshot": collector.snapshot()["targets"]}
        log(f"alerts_probes collector ({smi}): healthy ticks {up}; after the kill {down}; "
            f"pre-existing events replayed {len(replayed)}; /fleet lists "
            f"{res['collector']['fleet_lists']}; down targets {res['collector']['down_targets']}")
        if replayed or not all(res["collector"]["fleet_lists"].values()) \
                or any(u["errors"] for u in up) \
                or res["collector"]["down_targets"] != ["replica-b"]:
            raise AssertionError(f"alerts_probes: the collector: {res['collector']}")
        collector.stop()
        collector.engine.clear()

        # (e) the training rules on a TBPTT fit (K3 with the reserve, K4)
        # whose batch holds a NaN
        tengine = AlertEngine(history=MetricsHistory(capacity=8))
        truls = default_training_rules(stall_after_s=600.0, for_seconds=0.0)
        truls[1].within_s = AP_WITHIN_S
        tengine.add(*truls)
        tnet = build_net(char_rnn_conf())
        tnet.set_listeners(TrainingHealthListener())
        f, l = periodic_text(np.random.default_rng(SP_SEED + 12), TRAIN_B, TRAIN_SEQ)
        f[0, 0, 0] = np.nan
        reset_counts()
        tnet.fit(DataSet(f, l))
        torch.cuda.synchronize()
        tlaunches = {k: v for k, v in read_counts().items() if v}
        nans = [e for e in rec.events() if e["event"] == "health_problem" and e["kind"] == "nan"]
        firing = tengine.evaluate(now=time.time(), strict=False)
        later = tengine.evaluate(now=max(e["t"] for e in nans) + AP_WITHIN_S + 0.5,
                                 strict=False) if nans else []
        state = {r["rule"]: r["state"] for r in firing}
        after = {r["rule"]: r["state"] for r in later}
        res["training"] = {"launches": tlaunches, "nan_problems": len(nans), "firing": state,
                           "after_within_s": after}
        log(f"alerts_probes training rules ({smi}): a TBPTT fit b={TRAIN_B} T={TRAIN_SEQ} with a "
            f"NaN launched {tlaunches}; {len(nans)} nan problems; rules {state}, then {after} "
            f"once they aged past {AP_WITHIN_S} s")
        segs = TRAIN_SEQ // TRAIN_T
        if tlaunches != {"lstm2_fwd_train": segs, "lstm2_bwd": segs} or not nans \
                or state.get("training_divergence") != "FIRING" \
                or after.get("training_divergence") != "OK":
            raise AssertionError(f"alerts_probes: the training rules: {res['training']}")

        # (f) the routes, with JAX's document keys
        prime = sp_get(port, "/telemetry")
        rec.record("alerts_probes_route_check")
        fresh = sp_get(port, f"/telemetry?since_seq={prime['last_seq']}")
        try:
            sp_get(port, "/telemetry?since_seq=x")
            bad = 200
        except urllib.error.HTTPError as e:
            bad = e.code
        alerts = sp_get(port, "/alerts")
        probes = sp_get(port, "/probes")
        metrics = sp_get(port, "/metrics")
        res["routes"] = {
            "alerts_keys": sorted(alerts), "alerts_rules": {r["rule"]: (r["state"], r["fired_count"])
                                                            for r in alerts["alerts"]},
            "probes_keys": sorted(probes), "probes_targets": sorted(probes["targets"]),
            "telemetry_keys": sorted(prime), "telemetry_prime_events": len(prime["flight_events"]),
            "telemetry_fresh": [e["event"] for e in fresh["flight_events"]],
            "telemetry_bad_cursor": bad,
            "metrics_alerts_firing": sorted(ln.split(" ")[0] for ln in metrics.splitlines()
                                            if ln.startswith("alerts_firing{"))}
        log(f"alerts_probes routes ({smi}): {res['routes']}")
        if sorted(alerts) != ["alerts", "evaluated_at", "firing", "pending"] \
                or res["routes"]["alerts_rules"].get(p99) != ("OK", 1) \
                or sorted(probes) != ["fail_threshold", "interval_s", "running", "targets",
                                      "timeout_s"] \
                or res["routes"]["probes_targets"] != sorted(regs) \
                or sorted(prime) != ["exemplars", "flight_events", "health", "last_seq",
                                     "registry", "trace_events"] \
                or prime["flight_events"] or "alerts_probes_route_check" not in \
                res["routes"]["telemetry_fresh"] or bad != 400 \
                or f'alerts_firing{{rule="{p99}"}}' not in res["routes"]["metrics_alerts_firing"] \
                or 'alerts_firing{rule="probe_mismatch"}' not in \
                res["routes"]["metrics_alerts_firing"]:
            raise AssertionError(f"alerts_probes: the routes: {res['routes']}")
        res["launches"] = {"probes": launches, "training_rules_fit": tlaunches}
    finally:
        if collector is not None:
            collector.stop()
            collector.engine.clear()
        for k in regs:
            prober.remove_target(k)
        prober.engine.clear()
        engine.clear()
        hist.clear()
        fleet.stale_after = stale0
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
        srv.stop()
    res["seconds"] = time.perf_counter() - t_start
    log(f"alerts_probes phase took {res['seconds']:.1f} s ({smi})")
    return res


def ci_walk(beat, until, limit, label):
    """Beats until ``until(state)`` holds, at most ``limit``; the states."""
    walk = []
    for _ in range(limit):
        walk.append(beat())
        if until(walk[-1]):
            return walk
    raise AssertionError(f"control_incidents: {label} not reached in {limit} beats: "
                         f"{walk[-3:]}")


def ci_delta(before):
    """Kernel launches since ``before`` (a ``read_counts()``), after a sync."""
    torch.cuda.synchronize()
    return {k: v - before.get(k, 0) for k, v in read_counts().items() if v - before.get(k, 0)}


def control_incidents(smi, artifact):
    """The control plane and the incident recorder over the char-RNN served
    on the card and trained over a sharded fleet: (a) the chaos drill, a
    latency burn and a shard killed mid-fit, both acted on once; (b) a
    stale worker scaled out; (c) a gray failure restarted by
    ``probe_failure_policy``; (d) a killed replica respawned from its
    warmup artifact by ``fleet_replica_policy``; (e) the incidents they
    opened, persisted, loaded and rendered; (f) a halt flushing an open
    incident; (g) the routes."""
    from deeplearning4j_torch import DataSet, InferenceServer, ListDataSetIterator
    from deeplearning4j_torch.control import (fleet_replica_policy, fleet_scale_policy,
                                              get_control_plane, probe_failure_policy,
                                              serving_pressure_policy, shard_restart_policy)
    from deeplearning4j_torch.monitor import (BurnRateRule, IncidentRecorder, Prober,
                                              TelemetryCollector, ThresholdRule,
                                              TrainingHealthListener, default_fleet_rules,
                                              default_fleet_scope_rules, default_probe_rules,
                                              get_alert_engine, get_fleet, get_history,
                                              get_incident_recorder, get_tracer, load_bundle,
                                              render_incident_text)
    from deeplearning4j_torch.paramserver import ShardedParameterServerGroup, flatten_params
    from deeplearning4j_torch.utils.model_serializer import restore_model, write_model

    t_start = time.perf_counter()
    log(f"--- control_incidents ({smi})")
    fresh_monitor()
    child = ap_start_replica(artifact)
    children = [child]
    out_dir = Path("build") / "control_incidents"
    shutil.rmtree(out_dir, ignore_errors=True)
    dirs = {k: out_dir / k for k in ("main", "probe", "fleet")}
    for d in dirs.values():
        d.mkdir(parents=True)
    regs = {"ci_bf16": dict(precision="bf16", time_buckets=TIME_BUCKETS,
                            max_queue_examples=CI_CAP),
            "ci_f32": dict(precision="f32", time_buckets=TIME_BUCKETS),
            "ci_bf16_fixed": dict(precision="bf16", cache_size=SP_CACHE)}
    nets = {k: build_net(char_rnn_conf()) for k in regs}
    srv = InferenceServer()
    served = {k: srv.register(k, nets[k], linger_ms=5.0, input_shape=(T, VOCAB), **kw)
              for k, kw in regs.items()}
    port = srv.start(port=0)
    engine, hist = get_alert_engine(), get_history()
    plane, recorder = get_control_plane(), get_incident_recorder()
    plane.stop()
    plane.clear()
    recorder.stop()
    recorder.clear()
    engine.clear()
    hist.clear()
    recorder_settings = recorder.dump_dir, recorder.lookback_s
    recorder.dump_dir, recorder.lookback_s = str(dirs["main"]), CI_LOOKBACK_S
    group = ShardedParameterServerGroup(2)
    master = prober = collector = None
    side_recorders = []
    tick_us = []
    rng = np.random.default_rng(SP_SEED + 21)
    res = {"card": smi}

    def control_beat(now):
        hist.sample(now=now)
        engine.evaluate(now=now, strict=False)
        t0 = time.perf_counter()
        plane.tick(now=now)
        tick_us.append((time.perf_counter() - t0) * 1e6)
        recorder.tick(now=now)

    def acts(name):
        return [a for a in plane.actions() if a["action"] == name]

    def flushes():
        return sum(m.batcher.transfer_stats()["flushes"] for m in served.values())

    x = one_hot(rng, 1, T // 2)
    bf16_net, real = nets["ci_bf16"], nets["ci_bf16"].output
    clock = [time.time()]

    def advance():
        """The phase's clock: AP_SERVE_BEAT_S a beat, never ahead of the
        wall clock. A slow beat or a worker's step leaves it behind, so the
        burn windows stay covered in its time however long a step takes."""
        clock[0] += AP_SERVE_BEAT_S
        time.sleep(max(0.0, clock[0] - time.time()))
        return clock[0]

    def serve_beat():
        now = advance()
        sp_post(port, "ci_bf16", x)
        control_beat(now)
        return {r.name: r.state for r in engine.rules()}

    def slow(*a, **k):
        time.sleep(AP_SLOW_S)
        return real(*a, **k)

    try:
        # (a) the chaos drill: a latency burn on the served net, then shard
        # 1 killed during the worker's fit while the burn fires
        engine.add(BurnRateRule("ci_p99", kind="latency", target_ms=AP_P99_MS,
                                windows=AP_WINDOWS, latency_labels={"model": "ci_bf16"},
                                for_seconds=AP_FOR_S),
                   ThresholdRule("ci_shard_unavailable", "paramserver_shard_unavailable_total",
                                 threshold=0.0, mode="rate", window_s=CI_SHARD_WINDOW_S,
                                 for_seconds=0.0))
        plane.add(serving_pressure_policy(srv.registry, "ci_bf16", rules=("ci_p99",),
                                          factor=0.5, min_cap=8, cooldown_s=CI_COOLDOWN_S),
                  shard_restart_policy(group, cooldown_s=CI_COOLDOWN_S))
        plane.start(interval_s=3600.0)
        recorder.start(interval_s=3600.0)
        wnet = build_net(char_rnn_conf())
        master = fleet_master(group.address, "ci-worker", PS_THRESHOLD, delta=True)
        reinjected = []
        real_reinject = master.accumulator.reinject

        def reinject(mass):
            reinjected.append(float(np.abs(mass).sum()))
            real_reinject(mass)
        master.accumulator.reinject = reinject
        killed = {}

        class Beat:
            """A serving beat after every step of the worker; with ``kill``,
            shard 1 dies after the first."""

            def __init__(self, kill):
                self.kill = kill

            def iteration_done(self, model, iteration, score):
                if self.kill and not killed:
                    killed["port"], killed["snap"] = group.kill(1)
                serve_beat()

        def worker_fit(kill, seed):
            wnet.set_listeners(Beat(kill))
            before = read_counts()
            master.execute_training(wnet, ListDataSetIterator(ps_batches(seed, PS_STEPS)))
            wnet.listeners = []
            d = ci_delta(before)
            return {k: d.get(k, 0) for k in ("lstm2_fwd_train", "lstm2_bwd")}, d

        reset_counts()
        fl0 = flushes()
        base = [serve_beat() for _ in range(int(AP_WINDOWS[-1] / AP_SERVE_BEAT_S) + 1)]
        if any(v != "OK" for v in base[-1].values()) or plane.actions():
            raise AssertionError(f"control_incidents: before the fault: {base[-1]}, "
                                 f"{plane.actions()}")
        bf16_net.output = slow
        try:
            slowed = ci_walk(serve_beat, lambda st: bool(acts("set_admission")), CI_WALK,
                             "set_admission")
            capped = (served["ci_bf16"].batcher.max_queue_examples,
                      served["ci_bf16"].batcher.linger_ms)
            get_tracer().clear()            # the bundle keeps the exemplar's copy
            degraded, degraded_all = worker_fit(True, PP_SEED + 31)
            restarts = acts("restart")
            healed, healed_all = worker_fit(False, PP_SEED + 37)
        finally:
            del bf16_net.output
        finite = bool(np.isfinite(flatten_params(wnet.params)).all())
        recovered = ci_walk(serve_beat, lambda st: all(v == "OK" for v in st.values())
                            and bool(acts("restore_admission"))
                            and not recorder.snapshot()["open"], CI_WALK, "recovery")
        launches_a = ci_delta({})
        flushes_a = flushes() - fl0
        events = sp_get(port, "/events")["events"]
        downs = [e for e in events if e["event"] == "shard_server_down"]
        restored = [e for e in events if e["event"] == "shard_server_restored"]
        marks = {"fire": ("alert_firing", "rule", "ci_p99"),
                 "step": ("control_action", "action", "set_admission"),
                 "down": ("shard_server_down", None, None),
                 "restart": ("control_action", "action", "restart"),
                 "restored": ("shard_server_restored", None, None),
                 "resolved": ("alert_resolved", "rule", "ci_p99"),
                 "restore": ("control_action", "action", "restore_admission")}
        first = {}
        for mark, (kind, key, value) in marks.items():
            hits = [e for e in events if e["event"] == kind and (key is None or e[key] == value)]
            if not hits:
                raise AssertionError(f"control_incidents: no {mark} event on /events")
            first[mark] = hits[0]
        order = {mark: e["seq"] for mark, e in first.items()}
        fire_ev, step_ev = first["fire"], first["step"]
        want_fit = {"lstm2_fwd_train": PS_STEPS, "lstm2_bwd": PS_STEPS}
        chaos = {"walk": [st["ci_p99"] for st in base + slowed + recovered],
                 "capped": capped,
                 "restored_knobs": (served["ci_bf16"].batcher.max_queue_examples,
                                    served["ci_bf16"].batcher.linger_ms),
                 "actions": [(a["policy"], a["action"], a["outcome"], a["rule"])
                             for a in plane.actions()],
                 "exemplar": step_ev["exemplar_trace_id"],
                 "degraded_fit": degraded_all, "healed_fit": healed_all,
                 "finite": finite, "downs": len(downs), "restored": len(restored),
                 "reinjections": len(reinjected), "reinjected_mass": sum(reinjected),
                 "seq": order, "launches": launches_a, "flushes": flushes_a}
        res["chaos"] = chaos
        log(f"control_incidents chaos drill ({smi}): ci_p99 walk {chaos['walk']}; cap "
            f"{capped} then {chaos['restored_knobs']}; actions {chaos['actions']}; the fit "
            f"that lost shard 1 launched {degraded_all}, the next {healed_all}; finite "
            f"{finite}; {len(downs)} shard_server_down, {len(restored)} restored, "
            f"{len(reinjected)} re-injections of {sum(reinjected):.3e} |mass|; seqs {order}; "
            f"launches {launches_a} for {flushes_a} flushes")
        kinds = [a[1] for a in chaos["actions"]]
        if (len(restarts) != 1 or kinds.count("restart") != 1
                or kinds.count("set_admission") != 1 or kinds.count("restore_admission") != 1
                or capped != (32, 0.0) or chaos["restored_knobs"] != (CI_CAP, 5.0)
                or step_ev["exemplar_trace_id"] != fire_ev["exemplar_trace_id"]
                or not step_ev["exemplar_trace_id"]
                or restarts[0]["outcome"] != "restarted" or degraded != want_fit
                or healed != want_fit or not finite or len(downs) != 1 or not reinjected
                or not restored
                or not order["fire"] < order["step"]
                or not order["down"] < order["restart"] < order["restored"]
                or not order["resolved"] < order["restore"]
                or launches_a != {"lstm_fwd": 2 * flushes_a, **{k: 2 * v
                                                               for k, v in want_fit.items()}}):
            raise AssertionError(f"control_incidents: the chaos drill: {chaos}")

        # (e) the chaos drill's incident: both rules merged, both actions,
        # the exemplar's spans (the tracer was cleared after the fire)
        (inc,) = recorder.incidents()
        bundle = load_bundle(inc.path)
        text = render_incident_text(bundle)
        lines = text.splitlines()

        def line_of(*words):
            return next(i for i, ln in enumerate(lines) if all(w in ln for w in words))
        timeline = [line_of("alert_firing", "rule=ci_p99"),
                    line_of("control_action", "action=set_admission"),
                    line_of("control_action", "action=restart"),
                    line_of("alert_resolved", "rule=ci_p99"),
                    line_of("control_action", "action=restore_admission")]
        incidents = {"chaos": {"id": inc.id, "status": bundle["status"],
                               "rules": sorted(bundle["rules"]),
                               "actions": [a["action"] for a in bundle["control_actions"]],
                               "exemplar_spans": len(bundle["rules"]["ci_p99"]["exemplar_spans"]),
                               "history_samples": len(bundle["history"]),
                               "flight_events": len(bundle["flight_events"]),
                               "bundle_bytes": inc.bundle_bytes, "path": inc.path,
                               "timeline_lines": timeline}}
        log(f"control_incidents incident of the chaos drill ({smi}): {incidents['chaos']}")
        if (bundle["status"] != "resolved"
                or incidents["chaos"]["rules"] != ["ci_p99", "ci_shard_unavailable"]
                or incidents["chaos"]["actions"] != ["set_admission", "restart",
                                                     "restore_admission"]
                or not incidents["chaos"]["exemplar_spans"] or not bundle["history"]
                or timeline != sorted(timeline) or not text.startswith(f"# incident {inc.id}")):
            raise AssertionError(f"control_incidents: the chaos incident: {incidents['chaos']}")

        # (b) the scale-out: the worker's report aged past the staleness
        # horizon fires fleet_worker_stale; scale_to(3) and remap once
        fleet = get_fleet()

        def age_workers():
            with fleet._lock:
                for entry in fleet._workers.values():
                    entry["last_seen"] -= 10 * fleet.stale_after
        engine.add(*default_fleet_rules(for_seconds=0.0))
        plane.add(fleet_scale_policy(group, master, max_servers=CI_FLEET_MAX, cooldown_s=0.0))
        age_workers()
        control_beat(advance())
        scaled = acts("scale_to")
        before = read_counts()
        master.execute_training(wnet, ListDataSetIterator(ps_batches(PP_SEED + 41, 2)))
        launches_b = ci_delta(before)
        control_beat(advance())
        fresh_state = {r.name: r.state for r in engine.rules()}["fleet_worker_stale"]
        age_workers()
        control_beat(advance())
        again = acts("scale_to")
        engine.remove("fleet_worker_stale")
        control_beat(advance())
        res["scale"] = {"actions": [a["outcome"] for a in again], "servers": group.num_servers,
                        "client_servers": master.client.num_servers,
                        "local_versions": len(master.local_version),
                        "after_fresh_reports": fresh_state, "launches": launches_b}
        log(f"control_incidents scale-out ({smi}): {res['scale']}")
        if ([a["outcome"] for a in scaled] != [f"scaled_to_{CI_FLEET_MAX}"]
                or res["scale"]["actions"] != [f"scaled_to_{CI_FLEET_MAX}", "at_max"]
                or group.num_servers != CI_FLEET_MAX
                or master.client.num_servers != CI_FLEET_MAX
                or len(master.local_version) != CI_FLEET_MAX or fresh_state != "OK"
                or launches_b != {"lstm2_fwd_train": 2, "lstm2_bwd": 2}):
            raise AssertionError(f"control_incidents: the scale-out: {res['scale']}")

        # (c) the gray failure: the f32 registration's output layer times 8;
        # probe_failure_policy re-registers it from its zip, once
        zip_path = out_dir / "ci_f32.zip"
        write_model(nets["ci_f32"], str(zip_path))
        prober = Prober(timeout_s=10.0)
        goldens = {k: served[k].golden(examples=1) for k in ("ci_f32", "ci_bf16")}
        for k, g in goldens.items():
            prober.add_target(k, f"127.0.0.1:{port}", g)
        prober.engine.add(*default_probe_rules(prober, windows=AP_WINDOWS,
                                               deadman_s=AP_DEADMAN_S, for_seconds=AP_FOR_S))
        rec_probe = IncidentRecorder(engine=prober.engine, dump_dir=str(dirs["probe"]),
                                     lookback_s=CI_LOOKBACK_S).start(interval_s=3600.0)
        side_recorders.append(rec_probe)
        restarted, gone = [], []

        def restart_replica(label, url):
            """Re-register the model from its zip; probe its fresh golden."""
            restarted.append(label)
            gone.append(served[label].batcher.transfer_stats()["flushes"])
            srv.registry.unregister(label)
            served[label] = srv.register(label, restore_model(str(zip_path)), linger_ms=5.0,
                                         input_shape=(T, VOCAB), **regs[label])
            goldens[label + "/restarted"] = served[label].golden(examples=1)
            prober.add_target(label, url, goldens[label + "/restarted"])
        plane.add(probe_failure_policy(prober, restart_replica, cooldown_s=60.0))
        prober.engine.subscribe(plane._on_edge)
        tp0, pstep = time.time(), [0]

        def probe_beat():
            pstep[0] += 1
            now = tp0 + AP_BEAT_S * pstep[0]
            r = prober.tick(now=now)
            t0 = time.perf_counter()
            plane.tick(now=now)
            tick_us.append((time.perf_counter() - t0) * 1e6)
            rec_probe.tick(now=now)
            return {"outcomes": r["outcomes"], **{x.name: x.state for x in prober.engine.rules()}}
        reset_counts()
        fl0 = flushes()
        hits0 = sum(registry_rows("serving_cache_hits_total", model="ci_f32").values())
        healthy = [probe_beat() for _ in range(AP_TICKS)]
        w = nets["ci_f32"].params["2"]["W"]
        with torch.no_grad():
            w.mul_(8.0)
        wrong = ci_walk(probe_beat, lambda st: bool(restarted), CI_WALK,
                        "probe_failure_policy's restart")
        after = ci_walk(probe_beat, lambda st: all(v == "OK" for k, v in st.items()
                                                   if k != "outcomes"), CI_WALK,
                        "probe rules OK")
        launches_c = ci_delta({})
        flushes_c = flushes() - fl0 + sum(gone)
        hits = sum(registry_rows("serving_cache_hits_total", model="ci_f32").values()) - hits0
        gray_actions = acts("restart_replica")
        (pinc,) = rec_probe.incidents()
        res["gray"] = {"healthy": [h["outcomes"] for h in healthy],
                       "wrong": [h["outcomes"] for h in wrong],
                       "after": [h["outcomes"] for h in after], "restarted": restarted,
                       "actions": [(a["outcome"], a["rule"]) for a in gray_actions],
                       "versions": (goldens["ci_f32"]["version"],
                                    goldens["ci_f32/restarted"]["version"]),
                       "cache_hits": hits, "launches": launches_c, "flushes": flushes_c,
                       "incident": {"id": pinc.id, "status": pinc.status,
                                    "rules": sorted(pinc.rules), "path": pinc.path,
                                    "bundle_bytes": pinc.bundle_bytes}}
        log(f"control_incidents gray failure ({smi}): {res['gray']}")
        every_ok = all(set(o.values()) == {"ok"}
                       for o in res["gray"]["healthy"] + res["gray"]["after"])
        if (restarted != ["ci_f32"] or not every_ok
                or [a[0] for a in res["gray"]["actions"]] != ["restarted_ci_f32"]
                or res["gray"]["wrong"][0]["ci_f32"] != "mismatch"
                or res["gray"]["versions"][0] != res["gray"]["versions"][1] or hits
                or launches_c != {"lstm_fwd": 2 * flushes_c} or pinc.status != "resolved"
                or "probe_mismatch" not in pinc.rules or not pinc.path):
            raise AssertionError(f"control_incidents: the gray failure: {res['gray']}")

        # (d) the replica: the child from the warmup artifact killed;
        # fleet_replica_policy respawns it from the same artifact
        bport = ap_replica_port(child)
        collector = TelemetryCollector(timeout_s=10.0)
        collector.engine.add(*[r for r in default_fleet_scope_rules(
            fleet=collector.fleet, windows=AP_WINDOWS, for_seconds=AP_FOR_S)
            if r.name == "fleet_target_down"])
        collector.add_target("replica-c", f"127.0.0.1:{bport}")
        rec_fleet = IncidentRecorder(engine=collector.engine, dump_dir=str(dirs["fleet"]),
                                     lookback_s=CI_LOOKBACK_S).start(interval_s=3600.0)
        side_recorders.append(rec_fleet)
        xd = one_hot(rng, 1, T)
        respawn = {}

        def respawn_replica(label, url):
            """A new child from the same artifact; its first answer timed."""
            t0 = time.perf_counter()
            fresh = ap_start_replica(artifact)
            children.append(fresh)
            p = ap_replica_port(fresh)
            respawn["ready_s"] = time.perf_counter() - t0
            respawn["outputs"] = sp_post(p, "ap_replica", xd)[0]
            respawn["answer_s"] = time.perf_counter() - t0
            collector.remove_target(label)
            collector.add_target(label, f"127.0.0.1:{p}")
        plane.add(fleet_replica_policy(collector, respawn_replica, cooldown_s=60.0))
        collector.engine.subscribe(plane._on_edge)
        tc0, cstep = time.time(), [0]

        def scrape_beat():
            cstep[0] += 1
            now = tc0 + AP_BEAT_S * cstep[0]
            r = collector.tick(now=now)
            t0 = time.perf_counter()
            plane.tick(now=now)
            tick_us.append((time.perf_counter() - t0) * 1e6)
            rec_fleet.tick(now=now)
            return {"errors": sorted(r["errors"]),
                    **{x.name: x.state for x in collector.engine.rules()}}
        up = [scrape_beat() for _ in range(4)]
        child.kill()
        child.wait(timeout=30)
        down_walk = ci_walk(scrape_beat, lambda st: bool(respawn), CI_WALK,
                            "fleet_replica_policy's respawn")
        up_again = ci_walk(scrape_beat, lambda st: st["fleet_target_down"] == "OK", CI_WALK,
                           "fleet_target_down OK")
        reset_counts()
        here = sp_post(port, "ci_bf16_fixed", xd)[0]
        launches_d = ci_delta({})
        (finc,) = rec_fleet.incidents()
        err = float(np.abs(respawn["outputs"] - here).max())
        res["replica"] = {"up": up, "down": down_walk, "up_again": up_again,
                          "actions": [a["outcome"] for a in acts("restart_replica")
                                      if a["rule"] == "fleet_target_down"],
                          "ready_s": respawn["ready_s"], "answer_s": respawn["answer_s"],
                          "max_abs_err_vs_here": err, "launches": launches_d,
                          "incident": {"id": finc.id, "status": finc.status,
                                       "rules": sorted(finc.rules), "path": finc.path,
                                       "bundle_bytes": finc.bundle_bytes}}
        log(f"control_incidents replica ({smi}): {res['replica']}")
        if (any(u["errors"] for u in up) or res["replica"]["actions"] != ["restarted_replica-c"]
                or not err <= SP_BF16_ATOL or launches_d != {"lstm2_fwd": 1}
                or finc.status != "resolved" or finc.rules.keys() != {"fleet_target_down"}
                or not finc.path):
            raise AssertionError(f"control_incidents: the replica: {res['replica']}")

        # (f) the halt: a latency burn held open, then a NaN fit under
        # TrainingHealthListener(action="halt"); the open incident aborts
        plane.remove("serving_pressure_ci_bf16")
        bf16_net.output = slow
        try:
            ci_walk(serve_beat, lambda st: st["ci_p99"] == "FIRING"
                    and bool(recorder.snapshot()["open"]), CI_WALK, "an open ci_p99 incident")
        finally:
            del bf16_net.output
        open_id = recorder.snapshot()["open"][0]
        tnet = build_net(char_rnn_conf())
        tnet.set_listeners(TrainingHealthListener(action="halt"))
        f, l = periodic_text(np.random.default_rng(SP_SEED + 22), TRAIN_B, TRAIN_SEQ)
        f[0, 0, 0] = np.nan
        before = read_counts()
        tnet.fit(DataSet(f, l))
        launches_f = ci_delta(before)
        aborted = sorted(dirs["main"].glob(f"{open_id}-*.dl4jinc"))
        abundle = load_bundle(str(aborted[0])) if aborted else {}
        res["halt"] = {"incident": open_id, "status": abundle.get("status"),
                       "rules": sorted(abundle.get("rules", {})), "path":
                       str(aborted[0]) if aborted else None,
                       "open_after": recorder.snapshot()["open"], "launches": launches_f}
        log(f"control_incidents halt ({smi}): {res['halt']}")
        segs = TRAIN_SEQ // TRAIN_T
        if (abundle.get("status") != "aborted" or "ci_p99" not in abundle.get("rules", {})
                or res["halt"]["open_after"] or set(launches_f) - {"lstm2_fwd_train", "lstm2_bwd"}
                or not 1 <= launches_f.get("lstm2_bwd", 0) == launches_f.get("lstm2_fwd_train")
                <= segs):
            raise AssertionError(f"control_incidents: the halt: {res['halt']}")

        # (g) the routes
        control = sp_get(port, "/control")
        table = sp_get(port, "/incidents")
        one = sp_get(port, f"/incidents/{inc.id}")
        try:
            sp_get(port, "/incidents/inc-none")
            missing = (200, None)
        except urllib.error.HTTPError as e:
            missing = (e.code, json.loads(e.read()))
        block = sp_get(port, "/profile")["control"]
        metrics = sp_get(port, "/metrics")
        res["routes"] = {"control_keys": sorted(control), "policies": [
            (r["policy"], r["state"], r["fired_count"]) for r in control["policies"]],
            "incidents_keys": sorted(table), "incidents": [
                (r["id"], r["status"], r["rules"]) for r in table["incidents"]],
            "bundle_equal": one == json.loads(json.dumps(recorder.bundle(inc.id),
                                                         default=repr)),
            "missing": missing, "profile_control": block,
            "metrics": sorted({ln.split("{")[0].split(" ")[0] for ln in metrics.splitlines()
                               if ln.startswith(("control_actions_total", "incidents_open",
                                                 "control_cooldown_active",
                                                 "incident_captures_total"))})}
        log(f"control_incidents routes ({smi}): {res['routes']}")
        if (res["routes"]["control_keys"] != ["actions", "cooldowns_active", "evaluated_at",
                                              "policies", "running"]
                or res["routes"]["incidents_keys"] != ["evaluated_at", "evicted", "incidents",
                                                       "lookback_s", "max_incidents", "open",
                                                       "running"]
                or not res["routes"]["bundle_equal"]
                or missing != (404, {"error": "unknown incident 'inc-none'"})
                or set(block) != {"policies", "running", "cooldowns_active", "pending",
                                  "actions_total", "last_action"}
                or not block["policies"] or not block["running"]
                or not {"control_actions_total", "incidents_open"}
                <= set(res["routes"]["metrics"])):
            raise AssertionError(f"control_incidents: the routes: {res['routes']}")

        captures = [c["capture_ms"] for r in (recorder, *side_recorders)
                    for i in r.incidents() for c in i.captures]
        incidents["gray"], incidents["replica"] = res["gray"]["incident"], \
            res["replica"]["incident"]
        incidents["halt"] = {"id": open_id, "status": "aborted", "path": res["halt"]["path"]}
        incidents["all"] = [(r["id"], r["status"], r["rules"], r["bundle_bytes"])
                            for r in table["incidents"]]
        res["incidents"] = incidents
        res["capture_ms"] = {"median": float(np.median(captures)), "max": float(max(captures)),
                             "n": len(captures)}
        res["plane_tick_us"] = {"median": float(np.median(tick_us)), "max": float(max(tick_us)),
                                "n": len(tick_us)}
        res["actions"] = [(a["policy"], a["action"], a["outcome"], a["rule"])
                          for a in plane.actions()]
        res["launches"] = {"chaos": launches_a, "scale": launches_b, "gray": launches_c,
                           "replica": launches_d, "halt": launches_f}
        log(f"control_incidents ({smi}): incident_capture_ms {res['capture_ms']}; the plane's "
            f"tick {res['plane_tick_us']} us; the respawned child answered "
            f"{respawn['answer_s']:.2f} s after its start")
    finally:
        for r in side_recorders:
            r.stop()
        recorder.stop()
        plane.stop()
        plane.clear()
        recorder.clear()
        recorder.dump_dir, recorder.lookback_s = recorder_settings
        if collector is not None:
            collector.stop()
        if prober is not None:
            prober.stop()
        engine.clear()
        hist.clear()
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait(timeout=30)
        if master is not None:
            master.close()
        group.stop()
        srv.stop()
    res["seconds"] = time.perf_counter() - t_start
    log(f"control_incidents phase took {res['seconds']:.1f} s ({smi})")
    if res["seconds"] > CI_PHASE_LIMIT_S:
        raise AssertionError(f"control_incidents took {res['seconds']:.1f} s, over its "
                             f"{CI_PHASE_LIMIT_S} s")
    return res


def np_array_stats(a, bins=20):
    """The JAX package's ``_array_stats`` (``deeplearning4j_tpu/ui/stats.py:30``)
    in numpy on the host: the reference for the listener's statistics,
    which the port reduces on the card."""
    a = np.asarray(a, np.float64).ravel()
    hist, edges = np.histogram(a, bins=bins)
    return {"mean": float(a.mean()), "stdev": float(a.std()), "min": float(a.min()),
            "max": float(a.max()), "norm2": float(np.linalg.norm(a)),
            "mean_magnitude": float(np.abs(a).mean()), "histogram": hist.tolist(),
            "histogram_edges": [float(edges[0]), float(edges[-1])]}


def listener_copies(lst, net, iteration):
    """One ``iteration_done`` of ``lst`` under torch.profiler: the bytes of
    each device-to-host and host-to-device copy (from the Chrome trace),
    the kernels launched and the call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lst.iteration_done(net, iteration, 1.0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = Path("build") / "traces"
    out.mkdir(parents=True, exist_ok=True)
    path = out / "ui_listener_call.json"
    prof.export_chrome_trace(str(path))
    dev = [e for e in json.loads(path.read_text())["traceEvents"]
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        raise AssertionError("ui_cli: the profiler recorded no device event in a listener call")
    copies = {d: [e.get("args", {}).get("bytes") for e in dev
                  if e["cat"] == "gpu_memcpy" and d in e["name"]] for d in ("DtoH", "HtoD")}
    by_name = {}
    for e in dev:
        n, us = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, us + e.get("dur", 0.0))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    return {"d2h_bytes": copies["DtoH"], "h2d_bytes": copies["HtoD"],
            "kernels": sum(e["cat"] == "kernel" for e in dev), "wall_ms": wall_ms,
            "device_ms": sum(e.get("dur", 0.0) for e in dev) / 1e3,
            "top_device_ms": {name[:80]: [n, us / 1e3] for name, (n, us) in top}}


def ui_cli(smi, artifact, bundle):
    """The training UI and the operational CLI on the card (step 30 of the
    module docstring): ``train`` through ``main`` against a direct
    ParallelWrapper fit, the stats file and its statistics, the
    listener's host copies and cost, ``serve-ui``, ``monitor --url``,
    ``incident show`` on ``bundle``, ``cache`` on ``artifact``'s
    directory, and ``cache --export`` with a replica warmed from it."""
    import importlib
    import io

    from deeplearning4j_torch.datasets.bucketing import bucket_for
    from deeplearning4j_torch.main import build_parser, cmd_serve_ui, main as cli
    from deeplearning4j_torch.monitor import get_flight_recorder
    from deeplearning4j_torch.parallel import ParallelWrapper
    from deeplearning4j_torch.serving import DEFAULT_BATCH_BUCKETS, InferenceServer
    from deeplearning4j_torch.ui import (FileStatsStorage, InMemoryStatsStorage, StatsListener,
                                         UIServer)
    from deeplearning4j_torch.utils.model_serializer import restore_model, write_model

    t_start = time.perf_counter()
    log(f"--- ui_cli ({smi})")
    fresh_monitor()
    work = Path("build") / "ui_cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    (work / "ui_factory.py").write_text(UI_FACTORY.format(seed=UI_SEED, vocab=VOCAB,
                                                          n=UI_BATCHES, b=TRAIN_B, t=TRAIN_SEQ))
    sys.path.insert(0, str(work))
    factory = importlib.import_module("ui_factory")
    model, trained, stats = (str(work / n) for n in ("m.zip", "t.zip", "s.jsonl"))
    write_model(build_net(char_rnn_conf()), model)
    segs = UI_BATCHES * (TRAIN_SEQ // TRAIN_T)
    res = {"card": smi, "launches": {}}

    def run_cli(*argv):
        """``main(argv)`` with its standard output captured: (rc, text)."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli(list(argv))
        return rc, buf.getvalue()

    def counted(label, fn):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        res["launches"][label] = {k: v for k, v in read_counts().items() if v}
        return out

    def wrapper(net):
        """The wrapper ``train`` builds for these flags."""
        return (ParallelWrapper.Builder(net).averaging_frequency(1).prefetch_buffer(16)
                .report_score_after_averaging().build())

    def direct_fit():
        net = restore_model(model)
        wrapper(net).fit(factory.make())
        return net.param_table()

    def max_diff(a, b):
        return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)

    srv = None
    try:
        # (a) train through main, against two direct fits
        t0 = time.perf_counter()
        rc, text = counted("cli_train", lambda: run_cli(
            "train", "--model-path", model, "--model-output-path", trained,
            "--data-factory", "ui_factory:make", "--epochs", "1", "--report-score",
            "--stats-file", stats))
        res["cli_train_s"] = time.perf_counter() - t0
        if rc != 0 or "model written to" not in text or res["launches"]["cli_train"] != {
                "lstm2_fwd_train": segs, "lstm2_bwd": segs}:
            raise AssertionError(f"ui_cli: train rc {rc}, launches "
                                 f"{res['launches']['cli_train']} (want {segs} K3 with the "
                                 f"reserve and {segs} K4), output {text[-500:]}")
        got = restore_model(trained).param_table()
        want, again = counted("direct_fits", lambda: [direct_fit() for _ in range(2)])
        start = restore_model(model).param_table()
        res["fit"] = {"direct_fits_bit_equal": all(torch.equal(want[k], again[k]) for k in want),
                      "cli_bit_equal": all(torch.equal(got[k], want[k]) for k in want),
                      "cli_vs_direct_max_abs": max_diff(got, want),
                      "direct_vs_direct_max_abs": max_diff(want, again),
                      "moved_from_start": max_diff(got, start)}
        log(f"ui_cli train ({smi}): {res['cli_train_s']:.2f} s through main, launches "
            f"{res['launches']['cli_train']}; {res['fit']}")
        fit = res["fit"]
        if not fit["moved_from_start"] > 0 or not (
                fit["cli_bit_equal"] if fit["direct_fits_bit_equal"]
                else fit["cli_vs_direct_max_abs"] <= fit["direct_vs_direct_max_abs"]):
            raise AssertionError(f"ui_cli: the CLI's fit against the direct fits: {fit}")

        store = FileStatsStorage(stats)
        (sid,) = store.list_session_ids()
        ups = store.get_all_updates(sid)
        store.close()
        last = ups[-1]
        worst, bad = 0.0, []
        for name, t in got.items():
            ref = np_array_stats(t.detach().cpu().numpy())
            mine = last.param_stats[name]
            if (mine["histogram"], mine["histogram_edges"]) != (ref["histogram"],
                                                                 ref["histogram_edges"]):
                bad.append(name)
            for k in ("mean", "stdev", "min", "max", "norm2", "mean_magnitude"):
                worst = max(worst, abs(mine[k] - ref[k]) / abs(ref[k]) if ref[k] else
                            abs(mine[k]))
        res["stats_file"] = {
            "reports": len(ups), "iterations": [u.iteration for u in ups],
            "scores": [u.score for u in ups],
            "device_bytes_in_use": [u.system.get("device_bytes_in_use") for u in ups],
            "device_bytes_limit": last.system.get("device_bytes_limit"),
            "update_stats_from": [bool(u.update_stats) for u in ups],
            "params": len(last.param_stats), "histogram_mismatches": bad,
            "worst_moment_rel": worst}
        log(f"ui_cli stats file ({smi}): {res['stats_file']}")
        sf = res["stats_file"]
        if (sf["reports"] != UI_BATCHES or not all(math.isfinite(x) for x in sf["scores"])
                or not all((b or 0) > 0 for b in sf["device_bytes_in_use"])
                or sf["update_stats_from"] != [False] + [True] * (UI_BATCHES - 1)
                or set(last.param_stats) != set(got) or bad or not worst <= UI_STATS_RTOL):
            raise AssertionError(f"ui_cli: the stats file: {sf}")

        pnet = restore_model(trained)
        lst = StatsListener(InMemoryStatsStorage(), session_id="probe")
        lst.iteration_done(pnet, 0, 1.0)
        with torch.no_grad():
            for t in pnet.param_table().values():
                t.mul_(1.0 + 2.0 ** -10)
        res["listener_call"] = listener_copies(lst, pnet, 1)
        res["listener_call"]["prev_params_bytes"] = sum(
            t.numel() * t.element_size() for t in lst._prev_params.values())
        log(f"ui_cli listener call ({smi}): {res['listener_call']}")
        d2h = res["listener_call"]["d2h_bytes"]
        if len(d2h) > UI_COPIES or not all(b is not None and b <= UI_COPY_BYTES for b in d2h):
            raise AssertionError(f"ui_cli: a listener call copied {d2h} bytes to the host "
                                 f"(at most {UI_COPIES} copies of {UI_COPY_BYTES} bytes)")
        del pnet, lst

        # (b) the listener's cost a step, in alternating turns
        cnet = restore_model(model)
        pw = wrapper(cnet)
        pw.fit(factory.make())                 # the first fit's allocations, untimed
        cost = StatsListener(InMemoryStatsStorage(), session_id="cost")
        step_ms = {"none": [], "listener": []}

        def turns():
            for _ in range(UI_TURNS):
                for arm in ("none", "listener"):
                    cnet.set_listeners(*([cost] if arm == "listener" else []))
                    it = factory.make()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    pw.fit(it)
                    torch.cuda.synchronize()
                    step_ms[arm].append((time.perf_counter() - t0) * 1e3 / UI_BATCHES)

        counted("listener_cost", turns)
        med = {k: float(np.median(v)) for k, v in step_ms.items()}
        res["listener_cost"] = {
            "step_ms": step_ms, "median_ms": med,
            "spread_ms": {k: [float(min(v)), float(max(v))] for k, v in step_ms.items()},
            "overhead_ms": med["listener"] - med["none"],
            "overhead_pct": 100.0 * (med["listener"] - med["none"]) / med["none"]}
        log(f"ui_cli listener cost ({smi}): a step (one b={TRAIN_B}, T={TRAIN_SEQ} batch, "
            f"{TRAIN_SEQ // TRAIN_T} TBPTT segments) {med['none']:.2f} ms without, "
            f"{med['listener']:.2f} ms with a StatsListener at frequency 1 (medians of "
            f"{UI_TURNS} alternating turns; {step_ms})")
        del cnet, pw

        # (c) serve-ui over the stats file, and a second train posting to it
        port = cmd_serve_ui(build_parser().parse_args(["serve-ui", "--stats-file", stats,
                                                       "--port", "0"]), block=False)
        routes = {p: sp_get(port, p) for p in (
            "/train/sessions", f"/train/overview?sid={sid}", f"/train/model?sid={sid}",
            f"/train/system?sid={sid}", "/fleet?format=json", "/alerts", "/control",
            "/incidents")}
        metrics = sp_get(port, "/metrics")
        rc2, text2 = counted("ui_url_train", lambda: run_cli(
            "train", "--model-path", model, "--model-output-path", str(work / "t2.zip"),
            "--data-factory", "ui_factory:make", "--ui-url", f"127.0.0.1:{port}"))
        sessions = sp_get(port, "/train/sessions")
        system = routes[f"/train/system?sid={sid}"]
        res["serve_ui"] = {
            "sessions": routes["/train/sessions"], "after_ui_url": sessions,
            "overview_scores": len(routes[f"/train/overview?sid={sid}"]["scores"]),
            "model_params": len(routes[f"/train/model?sid={sid}"]["params"]),
            "device_series": system["device_bytes_in_use"],
            "monitor_keys": {p: sorted(routes[p]) for p in ("/fleet?format=json", "/alerts",
                                                             "/control", "/incidents")},
            "metrics_lines": len(metrics.splitlines()), "ui_url_rc": rc2}
        log(f"ui_cli serve-ui ({smi}): {res['serve_ui']}; the --ui-url train's launches "
            f"{res['launches']['ui_url_train']}")
        su = res["serve_ui"]
        if (su["sessions"] != [sid] or su["overview_scores"] != UI_BATCHES
                or su["model_params"] != len(got)
                or not all((b or 0) > 0 for b in su["device_series"])
                or len(su["device_series"]) != UI_BATCHES or rc2 != 0
                or len(sessions) != 2 or sid not in sessions
                or res["launches"]["ui_url_train"] != {"lstm2_fwd_train": segs,
                                                       "lstm2_bwd": segs}
                or "# TYPE" not in metrics):
            raise AssertionError(f"ui_cli: serve-ui: {su}, launches "
                                 f"{res['launches']['ui_url_train']}")

        # (d) monitor --url against that server, and incident show
        mon = {}
        for flag in ("--alerts", "--control", "--incidents", "--profile"):
            rc3, out = run_cli("monitor", "--url", f"127.0.0.1:{port}", flag, "--format", "json")
            mon[flag] = {"rc": rc3, "keys": sorted(json.loads(out))}
        rc4, shown = run_cli("incident", "show", bundle)
        inc_id = "-".join(Path(bundle).name.split("-")[:2])         # inc-NNNN
        res["monitor"] = {**mon, "incident_show": {"rc": rc4, "id": inc_id,
                                                   "lines": len(shown.splitlines()),
                                                   "head": shown.splitlines()[0]}}
        log(f"ui_cli monitor --url and incident show ({smi}): {res['monitor']}")
        if (any(v["rc"] != 0 for v in mon.values()) or rc4 != 0 or inc_id not in shown
                or "aborted" not in shown or "jit" not in mon["--profile"]["keys"]):
            raise AssertionError(f"ui_cli: monitor/incident: {res['monitor']}")

        # (e) cache on step 27's directory, the export, and a replica from it
        rc5, census = run_cli("cache", "--stats", "--dir", str(Path(artifact).parent))
        rc6, gc_doc = run_cli("cache", "--gc", "--dir", str(Path(artifact).parent))
        census, gc_doc = json.loads(census), json.loads(gc_doc)
        out_dir = work / "artifacts"
        out_dir.mkdir()
        rc7, path = counted("cache_export", lambda: run_cli(
            "cache", "--export", "--model-path", trained, "--input-shape", f"{TRAIN_SEQ},{VOCAB}",
            "--precision", "bf16", "--name", "ui_trained", "--out", str(out_dir)))
        path = path.strip()
        rnet = restore_model(trained)
        srv = InferenceServer()
        served = counted("replica_warm", lambda: srv.register(
            "ui_replica", rnet, precision="bf16", input_shape=(TRAIN_SEQ, VOCAB),
            linger_ms=0.0, warmup_artifact=path))
        port2 = srv.start(port=0)
        x = one_hot(np.random.default_rng(UI_SEED + 1), UI_ROWS, TRAIN_SEQ)
        y = counted("replica_request", lambda: sp_post(port2, "ui_replica", x)[0])
        pb = bucket_for(DEFAULT_BATCH_BUCKETS, UI_ROWS)
        xp = torch.zeros((pb, TRAIN_SEQ, VOCAB), dtype=torch.bfloat16, device=rnet.device)
        xp[:UI_ROWS] = torch.from_numpy(x).to(rnet.device)
        ref = rnet.output(xp)[:UI_ROWS].float().cpu().numpy()
        loaded = [e for e in get_flight_recorder().events()
                  if e["event"] in ("compile_cache_artifact_loaded", "compile_cache_miss")
                  and e.get("model") == "ui_replica"]
        res["cache"] = {"stats_rc": rc5, "artifacts": census["artifacts"],
                        "gc_rc": rc6, "gc_dry_run": gc_doc["dry_run"],
                        "gc_kept": gc_doc["kept"],
                        "gc_evicted": [Path(e["path"]).name for e in gc_doc["evicted"]],
                        "export_rc": rc7, "artifact": path,
                        "artifact_bytes": os.path.getsize(path),
                        "aot_signatures": len(served._aot),
                        "install": [e["event"] for e in loaded],
                        "bucket": pb, "bit_equal": bool(np.array_equal(y, ref)),
                        "max_abs_vs_forward": float(np.abs(y - ref).max())}
        log(f"ui_cli cache ({smi}): {res['cache']}; launches {res['launches']}")
        ca = res["cache"]
        if (rc5 or rc6 or rc7 or ca["artifacts"] < 1 or not ca["gc_dry_run"]
                or Path(artifact).name in ca["gc_evicted"] or not ca["aot_signatures"]
                or ca["install"] != ["compile_cache_artifact_loaded"] or not ca["bit_equal"]
                or res["launches"]["replica_request"] != {"lstm2_fwd": 1}
                or set(res["launches"]["cache_export"]) != {"lstm2_fwd"}):
            raise AssertionError(f"ui_cli: cache/replica: {ca}, launches {res['launches']}")
    finally:
        if srv is not None:
            srv.stop()
        UIServer.get_instance().stop()
        sys.path.remove(str(work))
    res["seconds"] = time.perf_counter() - t_start
    log(f"ui_cli phase took {res['seconds']:.1f} s ({smi})")
    if res["seconds"] > UI_PHASE_LIMIT_S:
        raise AssertionError(f"ui_cli took {res['seconds']:.1f} s, over its "
                             f"{UI_PHASE_LIMIT_S} s")
    return res


def build():
    """Compile every kernel of the port, one nvcc per source, all at once,
    and print what ptxas reports of registers, shared memory and spills."""
    from deeplearning4j_torch.ops import cuda_build, flash_attention, lstm_cell, lstm_fused

    t0 = time.perf_counter()
    logs = cuda_build.build_all([lstm_cell.SOURCE, lstm_cell.BWD_SOURCE, lstm_fused.SOURCE,
                                 lstm_fused.BWD_SOURCE, flash_attention.FWD_SOURCE,
                                 flash_attention.DQ_SOURCE, flash_attention.DKV_SOURCE])
    build_s = time.perf_counter() - t0
    log(f"built kernels in {build_s:.1f} s")
    for src, text in logs.items():
        flash = src.startswith("flash")
        # K1-K4 have two bodies each
        named = flash or src in (lstm_cell.SOURCE, lstm_cell.BWD_SOURCE, lstm_fused.SOURCE,
                                 lstm_fused.BWD_SOURCE)
        entry = ""
        for line in text.splitlines():
            # the flash sources instantiate nine head widths and types
            # each (and the backward two wgmma kernels): print the main
            # path's (bf16, d=64), every wgmma kernel's, any spill and any
            # ptxas warning (an ignored setmaxnreg, serialised wgmma)
            if named and "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line
            path = not flash or "13__nv_bfloat16Li64E" in entry or "wgmma" in entry
            spill = "spill" in line and "0 bytes spill stores" not in line
            if ("registers" in line or "spill" in line) and (path or spill) or "arning" in line:
                log(f"  {src}: {entry[:72] + ': ' if named else ''}{line.strip()}")
    return build_s


def kernel_line(serving, training, served, streamed, trained, flash, lm, decode, moe, graph,
                reg, lmd, ev, rf, tp, ke, rc, par, pps, msf, sp, ap, ci, ui):
    """The {"kernels": [...]} entries: for K1-K4 numbers at the char-RNN's
    training shape, the launches of its training main path, and K1/K3's
    serving numbers and their decode rows (T=1, b=GEN_B, one a
    generating char-RNN); for K5-K7 numbers at the TransformerLM's shape
    and the launches of its training main path (its ``output`` apart).
    K1 and K2 also carry their launches in the graph char-RNN's TBPTT fit
    (``graph_tbptt_launches``), K5-K7 theirs in the MoE TransformerLM's
    steps (``moe_lm_launches``); K1-K4 theirs in each regularised char-RNN
    fit (``regularized_launches``), K5-K7 theirs in the dropout
    TransformerLM's steps (``lm_dropout_launches``) and their times with
    dropout beside SDPA's with ``dropout_p`` (``dropout``). K1, K3, K4 and
    K5 carry their launches in the evaluation phase (``evaluate_launches``:
    the early-stopping runs, the char-RNN's masked and unmasked evaluate,
    the TransformerLM's evaluate). K1-K4 carry their launches in each path
    of the recurrent-family phase (``recurrent_family_launches``: the
    bidirectional char-RNN's fits and output, the classifier's fits and
    evaluate, SimpleRnn's fits and stream, and the step-loop nets' fits and
    outputs, which must be 0), and their launches in the fits of the
    char-RNN frozen at layer 0 (``transfer_pretrain_launches``: K1 without
    and with the reserve, K2; K3 and K4 0), with K1's numbers without the
    reserve at the training shape, the frozen layer's (``no_reserve_train_shape``;
    its ``max_abs_err`` counts in the entry's). K1-K4 carry their launches on
    the imported Keras char-LSTM (``keras_char_lstm``: its f32 ``output``, its
    bf16 twin's ``output`` and bf16 fits, peepholes off) with the first launch
    of each held against its plain version and timed (``held``). K1-K4
    carry their launches in the char-RNN's fits under remat "on" and
    "auto" (``remat_launches``), K5-K7 theirs in a TransformerLM step
    with remat off and on, without and with attention dropout. Every entry
    carries its launches on each path of the parallel phase
    (``parallel_launches``: ParallelWrapper's fits, ParallelInference's
    requests, the ring and Ulysses calls, the sp and expert steps), and
    K5-K7 their numbers at the ring's shard shapes and Ulysses' shape
    (``sequence_parallel_shapes``). Every entry carries its launches on each
    path of the pipeline_paramserver phase (``pipeline_paramserver_launches``:
    the pipelined char-RNN and TransformerLM steps, the parameter server's
    runs, the streamed and Kafka-fed fits); K1/K2 their numbers at the
    pipeline's microbatch and K5-K7 at the pipelined LM's (``pipeline_microbatch``),
    K3/K4 theirs at the parameter-server worker's full sequence
    (``paramserver_full_sequence``), each with cuDNN's LSTM or SDPA beside.
    Every entry carries its launches on each path of the
    monitor_sharded_fleet phase (``monitor_sharded_fleet_launches``: the
    sharded lossless worker, the two delta-push workers, the fit that lost
    a shard and the one after its restart, the fit after scale_to, and
    the monitored TransformerLM and char-RNN fits). Every entry carries its
    launches in each registration of the serving_plane phase and in its
    cache hit (``serving_plane_launches``), and K1 its f32 CUDA-core body's
    numbers at the serving shape (``serving_plane_f32_body``). K1, K3 and
    K4 carry their launches in the alerts_probes phase
    (``alerts_probes_launches``: the healthy probes, the training rules'
    NaN fit) and in each drill of the control_incidents phase
    (``control_incidents_launches``: the chaos drill's requests and fits,
    the scale-out's steps, the gray failure's probes, the request answered
    beside the respawned replica, the halted NaN fit). K3 and K4 carry their
    launches in each path of the ui_cli phase (``ui_cli_launches``: the
    CLI's fit, the two direct fits, the listener-cost turns, the
    ``--ui-url`` fit, the artifact export's warmup, the replica's warmup
    and its request)."""
    sp_paths = {k: v["launches"] for k, v in sp["registrations"].items()}
    sp_paths["cache_hit"] = sp["cache_hit"]["launches"]

    def sp_launches(*names):
        return {"serving_plane_launches": {p: sum(c.get(n, 0) for n in names)
                                           for p, c in sp_paths.items()}}

    def ap_launches(*names):
        return {"alerts_probes_launches": {p: sum(c.get(n, 0) for n in names)
                                           for p, c in ap["launches"].items()}}

    def ci_launches(*names):
        return {"control_incidents_launches": {p: sum(c.get(n, 0) for n in names)
                                               for p, c in ci["launches"].items()}}

    def ui_launches(*names):
        return {"ui_cli_launches": {p: sum(c.get(n, 0) for n in names)
                                    for p, c in ui["launches"].items()}}
    pp_paths = {"pipelined_char_rnn": pps["pipelined_char_rnn"]["launches"],
                "pipelined_lm": pps["pipelined_lm"]["launches"],
                **{f"paramserver_{k}": pps["paramserver"][k]["launches"]
                   for k in ("lossless_sync", "lossless_overlap", "two_workers")},
                "streamed_fit": pps["streamed"]["streaming"]["launches"],
                "kafka_fit": pps["streamed"]["kafka"]["launches"]}

    def pp_launches(*names):
        return {"pipeline_paramserver_launches": {p: sum(c.get(n, 0) for n in names)
                                                  for p, c in pp_paths.items()}}
    msf_paths = {"sharded_lossless": msf["lossless"]["launches"],
                 "sharded_workers": msf["workers"]["launches"],
                 "shard_killed": msf["kill_restart"]["launches"],
                 "shard_restarted": msf["kill_restart"]["healed_launches"],
                 "scaled": msf["scale"]["launches"],
                 **{f"monitored_{k}": v["launches"] for k, v in msf["monitor_cost"].items()
                    if k in ("transformer_lm", "char_rnn")}}

    def msf_launches(*names):
        return {"monitor_sharded_fleet_launches": {p: sum(c.get(n, 0) for n in names)
                                                   for p, c in msf_paths.items()}}
    pp_rnn = pps["pipelined_char_rnn"]["kernels"]
    ps_rnn = pps["paramserver"]["kernels"]
    par_paths = {f"wrapper_{k}": par["wrapper"][k]["launches"]
                 for k in ("unmasked", "masked", "local_sgd", "shared_gradients")}
    par_paths.update({f"inference_{k}": v["launches"] for k, v in par["inference"].items()})
    par_paths.update({k.replace(" ", "_"): v["launches"]
                      for k, v in par["attention"].items() if k != "rows"})
    par_paths.update({f"step_{k}": v["launches"] for k, v in par["steps"].items()})

    def parallel_launches(*names):
        return {"parallel_launches": {p: sum(c.get(n, 0) for n in names)
                                      for p, c in par_paths.items()}}
    shape = {"b": TRAIN_B, "T": TRAIN_T, "H": H, "w": "bf16", "peepholes": True}
    phases = {"early_stopping": ev["early_stopping"]["launches"],
              "evaluate_masked": ev["char_rnn"]["masked"]["launches"],
              "evaluate_unmasked": ev["char_rnn"]["unmasked"]["launches"],
              "lm_evaluate": ev["transformer_lm"]["launches"]}

    def evaluate_launches(*names):
        return {"evaluate_launches": {p: sum(c[n] for n in names) for p, c in phases.items()}}

    bidi, cls, srnn, loop = (rf["bidir_char_rnn"]["launches"], rf["bidir_classifier"]["launches"],
                             rf["simple_rnn"]["launches"], rf["lstm_step_loop"])
    family_phases = {
        "bidir_char_rnn_fits": [bidi["train"]], "bidir_char_rnn_output": [bidi["output"]],
        "bidir_classifier_fits": [cls["train"]], "bidir_classifier_evaluate": [cls["evaluate"]],
        "simple_rnn": [srnn["train"], srnn["stream"]],
        "lstm_step_loop": [c for k, v in loop["nets"].items() if k != "kernel_tanh"
                           for c in v["launches"].values()]}

    def family_launches(*names):
        return {p: sum(c[n] for c in cs for n in names) for p, cs in family_phases.items()}
    sshape = {"b": B, "T": T, "H": H, "w": "bf16", "peepholes": True}
    frozen = tp["char_rnn"]["launches"]
    kl = ke["keras_char_lstm"]
    rnn_remat = rc["char_rnn"]["launches"]

    def remat_launches(*names):
        return {"remat_launches": {p: sum(c.get(n, 0) for n in names)
                                   for p, c in rnn_remat.items()}}

    def keras_lstm(*names):
        return {"keras_char_lstm": {
            "launches": {p: sum(c.get(n, 0) for n in names) for p, c in kl["launches"].items()},
            "held": {k: v for k, v in kl["kernels"].items() if k in names}}}

    def entry(name, counter, source, replaces, res, extra=None):
        e = {"name": name, "route": "cuda", "source": f"deeplearning4j_torch/csrc/{source}",
             "replaces": replaces, "launches": trained[counter],
             "max_abs_err": max(r["max_abs_err"] for r in res), "ms": res[0]["ms"],
             "plain_ms": res[0]["plain_ms"], "bound_ms": res[0]["bound_ms"],
             "bound_by": res[0]["bound_by"], "library_ms": None, "shape": shape,
             "regularized_launches": {v: g.get(counter, 0)
                                      for v, g in reg["launches"].items()}}
        if len(res) > 1:
            e.update(ms_unmasked=res[1]["ms"], plain_ms_unmasked=res[1]["plain_ms"])
        e.update(extra or {})
        return e

    def serving_of(name, keys):
        r = [serving[k] for k in keys]
        s = {"launches": served[name], "stream_launches": streamed[name],
             "max_abs_err": max(x["max_abs_err"] for x in r), "ms": r[0]["ms"],
             "plain_ms": r[0]["plain_ms"], "bound_ms": r[0]["bound_ms"],
             "bound_by": r[0]["bound_by"], "cudnn_yardstick_ms": serving[name + "/cudnn"],
             "shape": sshape}
        if len(r) > 1:
            s.update(ms_unmasked=r[1]["ms"], plain_ms_unmasked=r[1]["plain_ms"])
        if "design" in r[0]:
            s["design"] = r[0]["design"]
        return {"serving": s}

    return [
        entry("lstm_fwd", "lstm_fwd_train", "lstm_cell.cu", "deeplearning4j_tpu/ops/lstm_cell.py:99",
              [training["lstm_fwd_train/masked"], training["lstm_fwd_train/unmasked"],
               training["lstm_fwd_frozen/masked"], training["lstm_fwd_frozen/unmasked"]],
              {**serving_of("lstm_fwd", ["lstm_fwd/masked", "lstm_fwd/unmasked"]),
               "no_reserve_train_shape": {k.split("/")[1]: v for k, v in training.items()
                                          if k.startswith("lstm_fwd_frozen/")},
               "decode": decode["lstm_fwd"],
               "design": training["lstm_fwd_train/masked"]["design"],
               "graph_tbptt_launches": graph["launches"]["lstm_fwd_train"],
               **evaluate_launches("lstm_fwd", "lstm_fwd_train"),
               "recurrent_family_launches": family_launches("lstm_fwd", "lstm_fwd_train"),
               "transfer_pretrain_launches": {k: frozen[k] for k in ("lstm_fwd",
                                                                     "lstm_fwd_train")},
               **keras_lstm("lstm_fwd", "lstm_fwd_train"),
               **remat_launches("lstm_fwd", "lstm_fwd_train"),
               **parallel_launches("lstm_fwd", "lstm_fwd_train"),
               **pp_launches("lstm_fwd", "lstm_fwd_train"),
               **msf_launches("lstm_fwd", "lstm_fwd_train"),
               **sp_launches("lstm_fwd", "lstm_fwd_train"),
               **ap_launches("lstm_fwd", "lstm_fwd_train"),
               **ci_launches("lstm_fwd", "lstm_fwd_train"),
               "serving_plane_f32_body": sp["k1_f32_body"],
               "pipeline_microbatch": pp_rnn["lstm_fwd_train"]}),
        entry("lstm_bwd", "lstm_bwd", "lstm_cell_bwd.cu", "deeplearning4j_tpu/ops/lstm_cell.py:235",
              [training["lstm_bwd/masked"], training["lstm_bwd/unmasked"]],
              {"design": training["lstm_bwd/masked"]["design"],
               "graph_tbptt_launches": graph["launches"]["lstm_bwd"],
               "recurrent_family_launches": family_launches("lstm_bwd"),
               "transfer_pretrain_launches": frozen["lstm_bwd"], **keras_lstm("lstm_bwd"),
               **remat_launches("lstm_bwd"), **parallel_launches("lstm_bwd"),
               **pp_launches("lstm_bwd"), **msf_launches("lstm_bwd"),
               **sp_launches("lstm_bwd"),
               "pipeline_microbatch": pp_rnn["lstm_bwd"]}),
        entry("lstm2_fwd", "lstm2_fwd_train", "lstm_fused.cu", "deeplearning4j_tpu/ops/lstm_fused.py:111",
              [training["lstm2_fwd_train"]],
              {**serving_of("lstm2_fwd", ["lstm2_fwd"]), "decode": decode["lstm2_fwd"],
               "design": training["lstm2_fwd_train"]["design"],
               **evaluate_launches("lstm2_fwd", "lstm2_fwd_train"),
               "recurrent_family_launches": family_launches("lstm2_fwd", "lstm2_fwd_train"),
               "transfer_pretrain_launches": frozen["lstm2_fwd"] + frozen["lstm2_fwd_train"],
               **keras_lstm("lstm2_fwd", "lstm2_fwd_train"),
               **remat_launches("lstm2_fwd", "lstm2_fwd_train"),
               **parallel_launches("lstm2_fwd", "lstm2_fwd_train"),
               **pp_launches("lstm2_fwd", "lstm2_fwd_train"),
               **msf_launches("lstm2_fwd", "lstm2_fwd_train"),
               **sp_launches("lstm2_fwd", "lstm2_fwd_train"),
               **ap_launches("lstm2_fwd", "lstm2_fwd_train"),
               **ci_launches("lstm2_fwd", "lstm2_fwd_train"),
               **ui_launches("lstm2_fwd", "lstm2_fwd_train"),
               "paramserver_full_sequence": ps_rnn["lstm2_fwd_train"]}),
        entry("lstm2_bwd", "lstm2_bwd", "lstm_fused_bwd.cu", "deeplearning4j_tpu/ops/lstm_fused.py:249",
              [training["lstm2_bwd"]], {"design": training["lstm2_bwd"]["design"],
                                        **evaluate_launches("lstm2_bwd"),
                                        "recurrent_family_launches":
                                            family_launches("lstm2_bwd"),
                                        "transfer_pretrain_launches": frozen["lstm2_bwd"],
                                        **keras_lstm("lstm2_bwd"),
                                        **remat_launches("lstm2_bwd"),
                                        **parallel_launches("lstm2_bwd"),
                                        **pp_launches("lstm2_bwd"),
                                        **msf_launches("lstm2_bwd"),
                                        **sp_launches("lstm2_bwd"),
                                        **ap_launches("lstm2_bwd"),
                                        **ci_launches("lstm2_bwd"),
                                        **ui_launches("lstm2_bwd"),
                                        "paramserver_full_sequence": ps_rnn["lstm2_bwd"]}),
        *(flash_entry(name, src, line, flash[name], lm, moe, lmd,
                      {**(evaluate_launches(name) if name == "flash_fwd" else {}),
                       **parallel_launches(name), **pp_launches(name),
                       **msf_launches(name), **sp_launches(name),
                       "pipeline_microbatch": pps["pipelined_lm"]["kernels"][name],
                       "sequence_parallel_shapes": {k: r[name] for k, r in
                                                    par["attention"]["rows"].items()},
                       "remat_launches_per_step": {
                           f"{m}{' dropout' if k.endswith('dropout') else ''}":
                           rc["models"][k]["launches_per_step"][m][name]
                           for k in ("transformer_lm", "transformer_lm_dropout")
                           for m in ("off", "on")}})
          for name, src, line in (
            ("flash_fwd", "flash_attn_fwd.cu", 202), ("flash_dq", "flash_attn_dq.cu", 311),
            ("flash_dkv", "flash_attn_dkv.cu", 361))),
    ]


def flash_entry(name, source, line, res, lm, moe, lmd, extra):
    e = {"name": name, "route": "cuda", "source": f"deeplearning4j_torch/csrc/{source}",
         "replaces": f"deeplearning4j_tpu/ops/flash_attention.py:{line}",
         "launches": lm["launches"][name], "launches_per_step": lm["launches"][name] // LM_STEPS,
         **res,
         "shape": {"b": LM_B, "h": LM_HEADS, "T": LM_T, "d": LM_D, "dtype": "bf16",
                   "causal": True},
         "output_launches": lm["output_launches"][name],
         "moe_lm_launches": moe["launches"][name], "moe_lm_output_launches":
         moe["output_launches"][name], "lm_dropout_launches": lmd["launches"][name],
         "dropout": {"rate": LM_DROPOUT_RATE, **lmd["kernels"][name]}, **extra}
    e["design"] = design(torch.bfloat16, LM_D, source)
    if name == "flash_fwd":
        e["library_note"] = (f"scaled_dot_product_attention forward; ms and library_ms are "
                             f"medians of {FWD_TURNS} alternating turns")
    else:
        e["library_note"] = ("scaled_dot_product_attention backward: dq, dk and dv in one "
                             "call, beside K6 + K7 together")
    return e


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    build_s = build()
    serving = check_kernels()
    training = check_training_kernels()
    check_lstm2_fwd_small()
    check_lstm2_bwd_small()
    check_lstm_small()
    conf = char_rnn_conf()
    net = build_net(conf)
    served, streamed = serve(net)
    check_reference(conf, net)
    trained = train(conf)
    check_train_reference(conf)
    generated, decode = generate_char_rnns(trained.pop("net"))
    del net
    torch.cuda.empty_cache()
    check_flash_small()
    flash = check_flash_kernels()
    torch.cuda.empty_cache()
    lm = transformer_lm()
    check_lm_reference()
    lm_pipeline()
    torch.cuda.empty_cache()
    generated["transformer_lm"] = generate_lm(lm.pop("net"))
    torch.cuda.empty_cache()
    check_lstm_pair_f32()
    check_flash_f32_wide()
    torch.cuda.empty_cache()
    cnn = {"resnet50": resnet50()}
    torch.cuda.empty_cache()
    cnn["lenet"] = lenet()
    cnn["reference"] = check_cnn_reference()
    print(json.dumps({"cnn": cnn}))
    torch.cuda.empty_cache()
    moe = moe_lm()
    torch.cuda.empty_cache()
    moe["reference"] = check_lm_reference(experts=4, compute="float32")
    graph = graph_tbptt()
    torch.cuda.empty_cache()
    print(json.dumps({"moe_lm": {k: v for k, v in moe.items() if k != "profile"},
                      "graph_tbptt": graph}))
    reg = regularized_char_rnn()
    torch.cuda.empty_cache()
    lmd = lm_dropout()
    torch.cuda.empty_cache()
    print(json.dumps({"regularized_char_rnn": reg, "lm_dropout": lmd, "solvers": solvers()}))
    ev = evaluation(smi)
    print(json.dumps({"evaluation": ev}))
    rf = recurrent_family(smi)
    torch.cuda.empty_cache()
    print(json.dumps({"recurrent_family": rf}))
    cf = cnn_family(smi)
    torch.cuda.empty_cache()
    print(json.dumps({"cnn_family": cf}))
    tp = transfer_pretrain(smi)
    torch.cuda.empty_cache()
    print(json.dumps({"transfer_pretrain": tp}))
    ke = keras_embeddings(smi)
    torch.cuda.empty_cache()
    print(json.dumps({"keras_embeddings": ke}))
    rc = remat_clustering(smi)
    torch.cuda.empty_cache()
    print(json.dumps({"remat_clustering": rc}))
    par = parallel(smi)
    torch.cuda.empty_cache()
    print(json.dumps({"parallel": par}))
    pps = pipeline_paramserver(smi)
    torch.cuda.empty_cache()
    print(json.dumps({"pipeline_paramserver": pps}))
    msf = monitor_sharded_fleet(smi)
    torch.cuda.empty_cache()
    print(json.dumps({"monitor_sharded_fleet": msf}))
    sp = serving_plane(smi, build_s)
    torch.cuda.empty_cache()
    print(json.dumps({"serving_plane": sp}))
    ap = alerts_probes(smi, sp["artifact"]["path"])
    torch.cuda.empty_cache()
    print(json.dumps({"alerts_probes": ap}))
    ci = control_incidents(smi, sp["artifact"]["path"])
    torch.cuda.empty_cache()
    print(json.dumps({"control_incidents": ci}, default=repr))
    ui = ui_cli(smi, sp["artifact"]["path"], ci["halt"]["path"])
    torch.cuda.empty_cache()
    print(json.dumps({"ui_cli": ui}))

    print(json.dumps({"generate": generated}))
    print(json.dumps({"kernels": kernel_line(serving, training, served, streamed,
                                             trained["launches"], flash, lm, decode, moe,
                                             graph, reg, lmd, ev, rf, tp, ke, rc, par,
                                             pps, msf, sp, ap, ci, ui)}))
    log(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
